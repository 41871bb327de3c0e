"""The `precluster_knn` job: `inverted precluster <db>.ski --skd <db>
--knn <knn> --core-acc -o <out> --quiet` over a `collection` database,
each sample's core/accessory kNN among its index candidates.

Traffic keys: knn, core_acc (must be true: the job judges core/accessory
alone). Checked on the last job's file (reference/precluster.py): on
`check_rows` rows drawn from the seed, wrong_lines (exact: limit 0) and
selection_excess (the 1e-5 within which the port's f32 core/accessory
must agree with the f64 chain, as dist_knn); on every line,
non_candidate_lines (exact: limit 0)."""

from __future__ import annotations

import numpy as np

from portbench.jobs.dist_knn import check_rows
from portbench.reference import precluster as ref
from portbench.reference.count import shared_pair_count
from portbench.reference.samebits import samebits_rows

LIMITS = {"wrong_lines": 0, "selection_excess": 1e-5,
          "non_candidate_lines": 0}


def argv(db, traffic, out) -> list[str]:
    if not traffic.get("core_acc"):
        raise ValueError("the precluster_knn job judges --core-acc only")
    return ["inverted", "precluster", f"{db.prefix}.ski", "--skd",
            str(db.prefix), "--knn", str(traffic["knn"]), "--core-acc", "-o",
            str(out), "--quiet"]


def pairs(db, traffic) -> int:
    return db.n * (db.n - 1) // 2


def shapes(db, traffic) -> dict:
    """The job's shapes, with candidate_pairs: the pairs that share a
    sign (the least work of the masked scan), counted by the reference
    on the GPU where there is one."""
    import torch

    device = "cuda" if torch.cuda.is_available() else "cpu"
    return {"n": db.n, "nk": len(db.kmers), "s64": db.s64,
            "knn": traffic["knn"], "signs": db.signs.shape[1],
            "candidate_pairs": shared_pair_count(db.signs, device)}


def _inputs(db, seed: int, device):
    rows = check_rows(db, seed)
    sb = samebits_rows(db.words, rows, device).cpu().numpy()
    return rows, sb, ref.candidate_mask(db.signs, rows, device), \
        ref.candidate_counts(db.signs, device)


def _judge(db, traffic, out, rows, sb, candidates, degrees, device) -> dict:
    return ref.judge(out, sb, rows, candidates, degrees, db.signs, db.names,
                     db.kmers, db.sketch_size, db.s64, traffic["knn"], device)


def check(db, traffic, record, seed: int, device) -> dict:
    """The compared numbers of the last job's output file."""
    rows, sb, candidates, degrees = _inputs(db, seed, device)
    out = ref.read_output(record.out, db.names, rows)
    return _judge(db, traffic, out, rows, sb, candidates, degrees, device)


def _stand_in(db, traffic, seed, device, signs=None, **kw) -> dict:
    """The compared numbers of the reference's lines, made as kw says, in
    the port's place on the sampled rows (every other row with the count
    it should have). With `signs`, the reference takes its candidates
    from these signs instead of the database's, and every row prints the
    count they give (a fault of the mask)."""
    rows, sb, candidates, degrees = _inputs(db, seed, device)
    picked, printed = candidates, degrees
    if signs is not None:
        picked = ref.candidate_mask(signs, rows, device)
        printed = ref.candidate_counts(signs, device)
    knn = traffic["knn"]
    lines = ref.expected_lines(sb, rows, picked, db.names, db.kmers,
                               db.sketch_size, db.s64, knn, **kw)
    out = ref.as_output(lines, np.minimum(printed, knn), db.names)
    return _judge(db, traffic, out, rows, sb, candidates, degrees, device)


def control(db, traffic, seed: int, device, workdir=None) -> dict:
    """The reference one step of precision down in the port's place: the
    selection and the chain in f32."""
    return _stand_in(db, traffic, seed, device, dtype=np.float32)


def fault(db, traffic, seed: int, device, workdir=None) -> dict:
    """A planted fault: the reference in the port's place with every
    row's knn-th candidate replaced by its (knn + 1)-th, where it has
    one."""
    knn = traffic["knn"]

    def next_one(sb_row, row, candidates, cols):
        if cols.size < knn or candidates.sum() <= knn:
            return cols
        more, _ = ref.select(sb_row, row, candidates, knn + 1, db.kmers,
                             db.sketch_size, db.s64)
        return np.concatenate([more[: knn - 1], more[knn:]])

    return _stand_in(db, traffic, seed, device, pick=next_one)


def mask_fault(db, traffic, seed: int, device, drop_bin=None) -> dict:
    """A planted fault of the mask: the reference in the port's place
    with each row's candidates taken from the signs without the bin
    `drop_bin`, or, where drop_bin is None, with the mask ignored (every
    other sample a candidate). It fails a limit only where the fault
    changes a row's count or its knn nearest candidates: where rows have
    fewer than knn candidates, or near neighbours that share no sign."""
    if drop_bin is None:
        signs = np.zeros((db.n, 1), dtype=db.signs.dtype)
    else:
        signs = np.delete(db.signs, drop_bin, axis=1)
    return _stand_in(db, traffic, seed, device, signs=signs)
