"""The `dist_knn` job: `dist <db> [-k K] --knn <knn> -o <out> --quiet`
over a `sketches` database, the self kNN of every sample. A database of
one k gives Jaccard at -k K; of several, core/accessory over all of them.

Traffic keys: knn. Checked on `check_rows` rows drawn from the seed
(reference/knn.py): wrong_lines (exact: limit 0), and for core/accessory
selection_excess, the most by which a chosen neighbour's f64 core distance
exceeds its row's knn-th (limit: the 1e-5 within which the port's f32
core/accessory must agree with the f64 chain)."""

from __future__ import annotations

import numpy as np

from portbench.reference import knn as ref
from portbench.reference.samebits import samebits_rows

LIMITS = {"wrong_lines": 0, "selection_excess": 1e-5}
CHECK_ROWS = 256


def argv(db, traffic, out) -> list[str]:
    k = ["-k", str(db.kmers[0])] if len(db.kmers) == 1 else []
    return ["dist", str(db.prefix), *k, "--knn", str(traffic["knn"]), "-o",
            str(out), "--quiet"]


def pairs(db, traffic) -> int:
    return db.n * (db.n - 1) // 2


def shapes(db, traffic) -> dict:
    return {"n": db.n, "nk": len(db.kmers), "s64": db.s64,
            "knn": traffic["knn"]}


def check_rows(db, seed: int) -> np.ndarray:
    rng = np.random.default_rng([seed % (1 << 64), 7])
    return np.sort(rng.choice(db.n, min(CHECK_ROWS, db.n), replace=False))


def _expected(db, traffic, rows, sb, dtype=np.float64, ties="ascending"):
    """{row: lines} the reference prints: core/accessory in dtype, Jaccard
    with equal samebits ordered by column `ties` (the controls use f32 or
    the descending order)."""
    knn = traffic["knn"]
    if len(db.kmers) == 1:
        return ref.single_k_lines(sb[..., 0], rows, db.names, knn, db.s64,
                                  ties)
    out = {}
    for i, r in enumerate(rows):
        cols, _ = ref.coreacc_select(sb[i], int(r), knn, db.kmers,
                                     db.sketch_size, db.s64, dtype)
        out[int(r)] = ref.coreacc_lines(sb[i], int(r), cols, db.names,
                                        db.kmers, db.sketch_size, db.s64,
                                        dtype)
    return out


def judge(db, traffic, rows, sb, total: int, got: dict) -> dict:
    knn = traffic["knn"]
    if len(db.kmers) == 1:
        want = ref.single_k_lines(sb[..., 0], rows, db.names, knn, db.s64)
        return ref.judge_single(total, got, want, db.n, knn)
    return ref.judge_coreacc(total, got, sb, rows, db.names, db.kmers,
                             db.sketch_size, db.s64, db.n, knn)


def check(db, traffic, record, seed: int, device) -> dict:
    """The compared numbers of the last job's output file."""
    rows = check_rows(db, seed)
    sb = samebits_rows(db.words, rows, device).cpu().numpy()
    total, got = ref.output_lines(record.out, db.n, traffic["knn"], rows)
    return judge(db, traffic, rows, sb, total, got)


def control(db, traffic, seed: int, device, workdir=None) -> dict:
    """The compared numbers of the reference put in the port's place one
    step down: core/accessory in f32 throughout; Jaccard at one k (whose
    f32 and f16 values are exact at s64 = 16, J = samebits / 1024) with
    equal samebits ordered by column descending, against the reference
    tool's ascending order."""
    rows = check_rows(db, seed)
    sb = samebits_rows(db.words, rows, device).cpu().numpy()
    got = _expected(db, traffic, rows, sb, dtype=np.float32,
                    ties="descending")
    return judge(db, traffic, rows, sb, db.n * traffic["knn"], got)


def fault(db, traffic, seed: int, device, workdir=None) -> dict:
    """The compared numbers of a planted fault, an answer altered where it
    is produced: the reference in the port's place with every row's
    knn-th neighbour replaced by its (knn + 1)-th."""
    rows = check_rows(db, seed)
    sb = samebits_rows(db.words, rows, device).cpu().numpy()
    knn = traffic["knn"]
    if len(db.kmers) == 1:
        more = ref.single_k_lines(sb[..., 0], rows, db.names, knn + 1, db.s64)
        got = {r: lines[: knn - 1] + lines[knn:] for r, lines in more.items()}
    else:
        got = {}
        for i, r in enumerate(rows):
            cols, _ = ref.coreacc_select(sb[i], int(r), knn + 1, db.kmers,
                                         db.sketch_size, db.s64)
            got[int(r)] = ref.coreacc_lines(
                sb[i], int(r), [*cols[: knn - 1], cols[knn]], db.names,
                db.kmers, db.sketch_size, db.s64)
    return judge(db, traffic, rows, sb, db.n * knn, got)
