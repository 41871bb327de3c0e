"""The plain reference of `inverted precluster <ski> --skd <db> --knn
<knn> --core-acc`, and the comparison that judges a job's output file by
it. Plain PyTorch (the signs) and NumPy (the chain, reference/knn.py and
chain.py); nothing of the port.

A row's candidates are the samples that hold the same u16 sign as the row
in at least one of the index's S bins, the row itself excluded
(sketchlib.rust distances/mod.rs:399-553). Among them, the rows are
ranked by core distance as in `dist --knn` (reference/knn.py): the f64
core/accessory chain over every k, the knn smallest core distances,
column ascending among equals. A row with fewer than knn candidates
prints all of them; a row with none prints nothing (no
--retain-unmatched). Lines are the f64 chain's values for the chosen
pairs printed as f32, in (f32 core, column) order. The reference tool
leaves core/accessory precluster unimplemented (distances/mod.rs:548-550);
these are the port's semantics for it, its single-k precluster's
candidates with `dist --knn`'s core/accessory ranking, and no departure
from them is taken here.

The output is keyed by row name, since a row may hold fewer than knn
lines: every line's row and column must name samples, each row must hold
min(knn, its candidates) lines, the sampled rows' lines must be the
reference's text for the columns chosen, and no line may name a pair that
shares no sign."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .knn import coreacc_lines, coreacc_values

_ELEMS = 1 << 26  # elements of one (rows, n) comparison


def _signs(signs: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(signs).astype(np.int32)).to(device)


def _any_shared(a: torch.Tensor, sig: torch.Tensor) -> torch.Tensor:
    """(len(a), n) bool: row i of the signs a and sample j of sig hold the
    same sign in some bin."""
    out = torch.zeros((a.shape[0], sig.shape[0]), dtype=torch.bool,
                      device=sig.device)
    for b in range(sig.shape[1]):
        out |= a[:, b : b + 1] == sig[None, :, b]
    return out


def candidate_mask(signs: np.ndarray, rows, device) -> np.ndarray:
    """(len(rows), n) bool: column j shares a sign with row rows[i] in
    some bin, and is not the row itself."""
    sig = _signs(signs, device)
    rows_t = torch.as_tensor(np.asarray(rows, np.int64), device=device)
    out = _any_shared(sig[rows_t], sig)
    out[torch.arange(rows_t.numel(), device=device), rows_t] = False
    return out.cpu().numpy()


def candidate_counts(signs: np.ndarray, device) -> np.ndarray:
    """(n,) int64: each sample's number of candidates."""
    sig = _signs(signs, device)
    n = sig.shape[0]
    step = max(1, _ELEMS // n)
    counts = [_any_shared(sig[r0 : r0 + step], sig).sum(1) - 1  # itself
              for r0 in range(0, n, step)]
    return torch.cat(counts).cpu().numpy()


def shares_a_sign(signs: np.ndarray, a: np.ndarray, b: np.ndarray,
                  device) -> np.ndarray:
    """(m,) bool: samples a[i] and b[i] are two and share a sign."""
    sig = _signs(signs, device)
    out = np.zeros(len(a), dtype=bool)
    step = max(1, _ELEMS // sig.shape[1])
    for c0 in range(0, len(a), step):
        ai = torch.as_tensor(a[c0 : c0 + step], device=device)
        bi = torch.as_tensor(b[c0 : c0 + step], device=device)
        same = (sig[ai] == sig[bi]).any(1) & (ai != bi)
        out[c0 : c0 + step] = same.cpu().numpy()
    return out


def select(sb_row: np.ndarray, row: int, candidates: np.ndarray, knn: int,
           kmers, sketch_size: int, s64: int, dtype=np.float64):
    """The min(knn, candidates) candidate columns of the smallest core
    distance in dtype (column ascending among equals), and the last one's
    distance (None without a candidate)."""
    cols = np.flatnonzero(candidates)
    core, _ = coreacc_values(sb_row[cols], kmers, sketch_size, s64, dtype)
    core = core.astype(np.float64)
    order = np.lexsort((cols, core))[:knn]
    kth = float(core[order[-1]]) if order.size else None
    return cols[order], kth


@dataclass
class Output:
    """What a job printed: each row's number of lines (n,), the (row,
    column) sample ids of every line, the sampled rows' lines as text, and
    the lines that name no sample or have no four fields."""

    counts: np.ndarray
    pairs_a: np.ndarray
    pairs_b: np.ndarray
    sampled: dict = field(default_factory=dict)
    malformed: int = 0


def read_output(path, names, rows) -> Output:
    """The Output of a job's file, keeping the text of the rows `rows`."""
    index = {name: i for i, name in enumerate(names)}
    keep = {int(r) for r in rows}
    sampled = {r: [] for r in keep}
    a, b, malformed = [], [], 0
    with open(path, encoding="utf-8", errors="replace") as f:
        for line in f:
            line = line.rstrip("\n")
            fields = line.split("\t")
            r = index.get(fields[0], -1)
            c = index.get(fields[1], -1) if len(fields) == 4 else -1
            if r < 0 or c < 0:
                malformed += 1
                continue
            a.append(r)
            b.append(c)
            if r in keep:
                sampled[r].append(line)
    a = np.asarray(a, np.int64)
    return Output(counts=np.bincount(a, minlength=len(names)), pairs_a=a,
                  pairs_b=np.asarray(b, np.int64), sampled=sampled,
                  malformed=malformed)


def expected_lines(sb, rows, candidates, names, kmers, sketch_size: int,
                   s64: int, knn: int, dtype=np.float64,
                   pick=None) -> dict:
    """{row: the lines the reference prints}, the chain in dtype. sb (R,
    n, nk) samebits and candidates (R, n) of the rows; pick(cols) may
    alter each row's chosen columns (a planted fault)."""
    out = {}
    for i, r in enumerate(rows):
        cols, _ = select(sb[i], int(r), candidates[i], knn, kmers,
                         sketch_size, s64, dtype)
        if pick is not None:
            cols = pick(sb[i], int(r), candidates[i], cols)
        out[int(r)] = coreacc_lines(sb[i], int(r), cols, names, kmers,
                                    sketch_size, s64, dtype)
    return out


def as_output(lines: dict, counts: np.ndarray, names) -> Output:
    """An Output holding the given rows' lines and, for every other row,
    the count `counts` gives (the controls stand in for the port on the
    sampled rows alone)."""
    index = {name: i for i, name in enumerate(names)}
    a, b = [], []
    counts = counts.copy()
    for r, rl in lines.items():
        counts[r] = len(rl)
        for line in rl:
            a.append(r)
            b.append(index[line.split("\t")[1]])
    return Output(counts=counts, pairs_a=np.asarray(a, np.int64),
                  pairs_b=np.asarray(b, np.int64), sampled=dict(lines))


def judge(out: Output, sb, rows, candidates, degrees, signs, names, kmers,
          sketch_size: int, s64: int, knn: int, device) -> dict:
    """wrong_lines: every line naming no sample, every line a row holds
    more or fewer than min(knn, its candidates), and on the sampled rows,
    every line not the f64 chain's text for the column chosen in (f32
    core, column) order (all of a row's lines where it names a column
    twice or itself); selection_excess: the most by which a chosen
    column's f64 core distance exceeds its row's knn-th among its
    candidates; non_candidate_lines: lines whose pair shares no sign."""
    index = {name: i for i, name in enumerate(names)}
    want = np.minimum(degrees, knn)
    wrong = out.malformed + int(np.abs(out.counts - want).sum())
    excess = 0.0
    for i, r in enumerate(rows):
        r = int(r)
        have = out.sampled.get(r, [])
        cols = [index[line.split("\t")[1]] for line in have]
        if len(cols) != want[r]:
            continue  # counted above
        if len(set(cols)) != len(cols) or r in cols:
            wrong += len(cols)
            continue
        if not cols:
            continue
        lines = coreacc_lines(sb[i], r, cols, names, kmers, sketch_size, s64)
        wrong += sum(x != y for x, y in zip(have, lines))
        _, kth = select(sb[i], r, candidates[i], knn, kmers, sketch_size, s64)
        core, _ = coreacc_values(sb[i, cols], kmers, sketch_size, s64)
        if kth is not None:
            excess = max(excess, float(np.max(core.astype(np.float64))) - kth)
    shared = shares_a_sign(signs, out.pairs_a, out.pairs_b, device)
    return {"wrong_lines": wrong, "selection_excess": max(excess, 0.0),
            "non_candidate_lines": int((~shared).sum())}
