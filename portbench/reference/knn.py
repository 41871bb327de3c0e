"""The plain reference of `dist --knn`, and the comparison that judges a
job's output file by it.

Rows are sampled from the seed. For each, the reference works out the
samebits against every sample (reference/samebits.py), then in NumPy:
- Jaccard at one k: the knn neighbours by samebits descending, then
  column ascending (the reference tool's order), each printed as the f32
  of 1 - J in f64. The job's lines must equal these, byte for byte.
- Core/accessory: the regression over k in f64 for every column. The
  port selects by K2's f32 core distance, so its neighbours may differ
  from the f64 selection at near-ties; every one it prints must lie
  within `selection_excess` of the row's knn-th f64 core distance, and
  each of its lines must be the one the f64 chain gives for that pair,
  in the order of (f32 core, column).

The output holds knn lines a row, rows in order; a missing or extra line
anywhere counts as a wrong line."""

from __future__ import annotations

import numpy as np

from .chain import core_acc, fmt, jaccard


def output_lines(path, n: int, knn: int, rows) -> tuple[int, dict]:
    """(lines in the file, {row: its knn lines as str}) of a kNN output
    whose row r should hold lines [r * knn, (r + 1) * knn)."""
    data = open(path, "rb").read()
    ends = np.flatnonzero(np.frombuffer(data, dtype=np.uint8) == 10)
    starts = np.concatenate([[0], ends[:-1] + 1])
    got = {}
    for r in rows:
        lo, hi = int(r) * knn, min((int(r) + 1) * knn, ends.size)
        got[int(r)] = [data[starts[i] : ends[i]].decode("utf-8", "replace")
                       for i in range(lo, hi)]
    return int(ends.size) + (1 if data and not data.endswith(b"\n") else 0), got


def single_k_lines(sb: np.ndarray, rows, names, knn: int, s64: int,
                   ties: str = "ascending") -> dict:
    """{row: expected lines} for Jaccard at one k. sb (R, n) samebits of
    the rows. `ties` orders equal samebits by column ("descending" breaks
    the reference tool's order: a control)."""
    out = {}
    n = sb.shape[1]
    cols = np.arange(n)
    for i, r in enumerate(rows):
        key = sb[i].astype(np.int64).copy()
        key[r] = -1  # never its own neighbour
        tie = -cols if ties == "ascending" else cols
        order = np.lexsort((-tie, -key))[:knn]
        d = (1.0 - jaccard(sb[i, order], s64)).astype(np.float32)
        out[int(r)] = [f"{names[r]}\t{names[c]}\t{fmt(v)}"
                       for c, v in zip(order, d)]
    return out


def coreacc_values(sb: np.ndarray, kmers, sketch_size: int, s64: int,
                   dtype=np.float64):
    """(core, acc) in dtype of samebits sb (..., nk)."""
    return core_acc(jaccard(sb, s64, dtype), kmers, sketch_size, dtype)


def coreacc_lines(sb: np.ndarray, row: int, cols, names, kmers,
                  sketch_size: int, s64: int, dtype=np.float64) -> list[str]:
    """The lines of row `row` for the columns cols, ordered by (f32 core,
    column), with the chain's values in dtype printed as f32."""
    cols = np.asarray(cols, np.int64)
    core, acc = coreacc_values(sb[cols], kmers, sketch_size, s64, dtype)
    core, acc = core.astype(np.float32), acc.astype(np.float32)
    order = np.lexsort((cols, core))
    return [f"{names[row]}\t{names[cols[p]]}\t{fmt(core[p])}\t{fmt(acc[p])}"
            for p in order]


def coreacc_select(sb_row: np.ndarray, row: int, knn: int, kmers,
                   sketch_size: int, s64: int, dtype=np.float64):
    """The knn columns of the smallest core distance in dtype (column
    ascending among equals), and the knn-th distance."""
    core, _ = coreacc_values(sb_row, kmers, sketch_size, s64, dtype)
    core = core.astype(np.float64)
    core[row] = np.inf
    order = np.lexsort((np.arange(core.size), core))[:knn]
    return order, float(core[order[-1]])


def judge_single(total: int, got: dict, want: dict, n: int,
                 knn: int) -> dict:
    """Wrong lines: sampled lines that differ from the reference's, and
    every line the file has too many or too few."""
    wrong = abs(total - n * knn)
    for r, lines in want.items():
        have = got.get(r, [])
        wrong += sum(a != b for a, b in zip(have, lines))
        wrong += abs(len(lines) - len(have))
    return {"wrong_lines": wrong}


def judge_coreacc(total: int, got: dict, sb: np.ndarray, rows, names, kmers,
                  sketch_size: int, s64: int, n: int, knn: int) -> dict:
    """Wrong lines (as judge_single, against the f64 chain's lines for the
    columns the job chose, and all knn lines of a row that names a column
    twice, itself, or no sample) and the selection excess: the most by
    which a chosen column's f64 core distance exceeds its row's knn-th."""
    index = {name: i for i, name in enumerate(names)}
    wrong = abs(total - n * knn)
    excess = 0.0
    for i, r in enumerate(rows):
        r = int(r)
        have = got.get(r, [])
        cols = []
        for line in have:
            f = line.split("\t")
            cols.append(index.get(f[1], -1) if len(f) == 4 else -1)
        if (len(cols) != knn or len(set(cols)) != knn or r in cols
                or min(cols, default=-1) < 0):
            wrong += knn
            continue
        want = coreacc_lines(sb[i], r, cols, names, kmers, sketch_size, s64)
        wrong += sum(a != b for a, b in zip(have, want))
        _, kth = coreacc_select(sb[i], r, knn, kmers, sketch_size, s64)
        core, _ = coreacc_values(sb[i, cols], kmers, sketch_size, s64)
        excess = max(excess, float(np.max(core.astype(np.float64))) - kth)
    return {"wrong_lines": wrong, "selection_excess": max(excess, 0.0)}
