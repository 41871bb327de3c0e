"""The distance chain, written plainly in NumPy: samebits to Jaccard, to
distance, and the PopPUNK core/accessory regression over k.

Follows sketchlib.rust src/distances/jaccard.rs (jaccard_index and
core_acc_dist), whose printed f32 values the port must reproduce, in its
order of operations, so that f64 results round to the same f32. `dtype`
runs the whole chain in another precision (the controls)."""

from __future__ import annotations

import numpy as np

BBITS = 14


def jaccard(sb: np.ndarray, s64: int, dtype=np.float64) -> np.ndarray:
    """Jaccard index of samebits counts over s64 chunks of 64 bins: the
    count above the BBITS-bit chance matches, scaled to the bins."""
    maxnbits = s64 * 64
    expected = maxnbits >> BBITS
    diff = np.maximum(np.asarray(sb, np.int64) - expected, 0).astype(dtype)
    inter = diff * dtype(maxnbits) / dtype(maxnbits - expected)
    return inter / dtype(maxnbits)


def core_acc(j: np.ndarray, kmers, sketch_size: int, dtype=np.float64):
    """(core, acc) distances, in dtype, of Jaccard indices j (..., nk) in
    ascending k: the least-squares line of ln J against k over the k up to
    the first whose ln J falls below ln(2 / (64 sketch_size)); core = 1 -
    e^slope (slope < 0), acc = 1 - e^intercept (intercept < 0). Fewer than
    three k, or a Jaccard of 0 at the first k, give (1, 1)."""
    j = np.asarray(j, dtype=dtype)
    tol = np.log(dtype(2.0) / dtype(sketch_size * 64))
    with np.errstate(divide="ignore", invalid="ignore"):
        y = np.log(j)
    keep = np.logical_and.accumulate(y >= tol, axis=-1)
    zero = np.zeros(j.shape[:-1], dtype=dtype)
    xs, ys, xys, xxs, yys, cnt = (zero.copy() for _ in range(6))
    for ki, k in enumerate(kmers):
        m = keep[..., ki]
        kf = dtype(k)
        yk = np.where(m, y[..., ki], dtype(0))
        xs = xs + np.where(m, kf, dtype(0))
        ys = ys + yk
        xys = xys + kf * yk
        xxs = xxs + np.where(m, kf * kf, dtype(0))
        yys = yys + yk * yk
        cnt = cnt + m
    with np.errstate(divide="ignore", invalid="ignore"):
        xbar = xs / cnt
        ybar = ys / cnt
        xd = xxs - xs * xs / cnt
        yd = yys - ys * ys / cnt
        sx = np.sqrt(xd / cnt)
        sy = np.sqrt(yd / cnt)
        r = (xys - xs * ys / cnt) / np.sqrt(xd * yd)
        beta = r * sy / sx
        alpha = -beta * xbar + ybar
        core = np.where(beta < 0, dtype(1) - np.exp(beta),
                        np.where(r > 0, dtype(1), dtype(0)))
        acc = np.where(alpha < 0, dtype(1) - np.exp(alpha), dtype(0))
    bad = np.isnan(ys) | np.isneginf(ys) | (cnt < 3)
    return (np.where(bad, dtype(1), core).astype(dtype),
            np.where(bad, dtype(1), acc).astype(dtype))


def fmt(value) -> str:
    """An f32 as the reference tool prints it (Rust's Display: the shortest
    digits that read back to the same f32, positional, no trailing .0)."""
    v = np.float32(value)
    if np.isnan(v):
        return "NaN"
    if np.isinf(v):
        return "inf" if v > 0 else "-inf"
    return np.format_float_positional(v, unique=True, trim="-")
