"""Distance output formatting.

Matches Rust's `Display` for f32 (shortest decimal string that round-trips,
positional notation, no trailing ".0") and the long-form / sparse layouts of
sketchlib.rust src/distances/distance_matrix.rs:175-209,360-401.

At scale the text itself is the bottleneck (a 100k-genome all-vs-all run is
5e9 lines), so lines are assembled in the host helper
(stpu_format_dist_lines: std::to_chars shortest round-trip + positional
expansion), in tasks that one OutputPipeline (opipe.py) formats in parallel
and writes in order. Every text output of the port goes through it: the
sparse kNN rows, the dense long forms here, and the stream engines'
strips and core/accessory blocks.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import _native, spans
from .opipe import OutputPipeline

# lines per sparse-output task: with WORKERS tasks in flight, the text
# buffers stay near those of one 2^21-line chunk
SPARSE_LINES = max(1 << 17, (1 << 21) // _native.WORKERS)


def _name_table(names) -> tuple[bytes, np.ndarray]:
    enc = [str(n).encode() for n in names]
    off = np.zeros(len(enc) + 1, dtype=np.int64)
    if enc:
        off[1:] = np.cumsum([len(e) for e in enc])
    return b"".join(enc), off


def format_lines_bytes(
    tab_r: tuple[bytes, np.ndarray],
    tab_c: tuple[bytes, np.ndarray],
    rows: np.ndarray,
    cols: np.ndarray,
    v1: np.ndarray,
    v2: np.ndarray | None,
) -> bytes:
    """Assemble "row\\tcol\\tv1[\\tv2]\\n" lines natively and return the
    bytes (the ctypes call releases the GIL, so concurrent calls from an
    OutputPipeline's workers format in parallel)."""
    r = np.ascontiguousarray(rows, dtype=np.int32)
    c = np.ascontiguousarray(cols, dtype=np.int32)
    v1 = np.ascontiguousarray(v1, dtype=np.float32)
    if v2 is not None:
        v2 = np.ascontiguousarray(v2, dtype=np.float32)
    names_r, off_r = tab_r
    names_c, off_c = tab_c
    cap = int(
        (off_r[r + 1] - off_r[r]).sum()
        + (off_c[c + 1] - off_c[c]).sum()
        + (2 * 64 + 4) * r.size
    )
    buf = ctypes.create_string_buffer(cap)
    lib = _native.lib()
    written = lib.stpu_format_dist_lines(
        names_r,
        off_r.ctypes.data_as(ctypes.c_void_p),
        names_c,
        off_c.ctypes.data_as(ctypes.c_void_p),
        r.ctypes.data_as(ctypes.c_void_p),
        c.ctypes.data_as(ctypes.c_void_p),
        v1.ctypes.data_as(ctypes.c_void_p),
        v2.ctypes.data_as(ctypes.c_void_p) if v2 is not None else None,
        r.size,
        buf,
        cap,
    )
    if written < 0:  # cap is sufficient by construction (64B/value)
        raise RuntimeError("native line formatting overflowed its buffer")
    return ctypes.string_at(buf, written)


@spans.spanned("write")
def write_dense_self(out, names, dists, coreacc: bool,
                     row_range: slice | None = None):
    """Upper-triangle long form. dists: (n_pairs,) or (n_pairs, 2).
    With row_range, dists covers only rows [lo, hi) (a multi-process
    shard of the long-form output)."""
    n = len(names)
    lo, hi = (row_range.start, row_range.stop) if row_range else (0, n)
    dists = np.asarray(dists)
    tab = _name_table(names)

    def pairs_before(i: int) -> int:
        """Long-form offset of row i's first pair within rows [lo, hi)."""
        m = i - lo
        return m * (n - 1) - (lo + i - 1) * m // 2

    def task(i0: int, i1: int) -> bytes:
        rows, cols = self_pair_indices(i0, i1, n)
        d = dists[pairs_before(i0) : pairs_before(i0) + rows.size]
        return format_lines_bytes(
            tab, tab, rows, cols,
            d[:, 0] if coreacc else d,
            d[:, 1] if coreacc else None,
        )

    with OutputPipeline(out) as pipe:
        for i0, i1 in row_spans(lo, hi, max(1, n - lo)):
            pipe.submit(task, i0, i1)


@spans.spanned("write")
def write_dense_cross(out, ref_names, query_names, dists, coreacc: bool):
    """Rectangular long form, ref-major."""
    nr, nq = len(ref_names), len(query_names)
    dists = np.asarray(dists)
    tab_r = _name_table(ref_names)
    tab_q = _name_table(query_names)

    def task(i0: int, i1: int) -> bytes:
        rows = np.repeat(np.arange(i0, i1, dtype=np.int32), nq)
        cols = np.tile(np.arange(nq, dtype=np.int32), i1 - i0)
        d = dists[i0 * nq : i1 * nq]
        return format_lines_bytes(
            tab_r, tab_q, rows, cols,
            d[:, 0] if coreacc else d,
            d[:, 1] if coreacc else None,
        )

    with OutputPipeline(out) as pipe:
        for i0, i1 in row_spans(0, nr, max(1, nq)):
            pipe.submit(task, i0, i1)


def _packed(rows, coreacc: bool):
    """The host oracle's rows (a list per row of (ref_idx, dist) or
    (ref_idx, core, acc) items) in the form of SparseKnnRows.as_arrays():
    (n, knn) indices, values and the mask of the entries present."""
    lens = np.array([len(items) for items in rows], dtype=np.int64)
    valid = np.arange(int(lens.max(initial=0))) < lens[:, None]
    items = np.array([it for r in rows for it in r], dtype=np.float64)
    items = items.reshape(-1, 3 if coreacc else 2)
    idx = np.zeros(valid.shape, dtype=np.int32)
    idx[valid] = items[:, 0]
    vals = np.zeros(valid.shape + ((2,) if coreacc else ()), np.float32)
    vals[valid] = items[:, 1:] if coreacc else items[:, 1]
    return idx, vals, valid


@spans.spanned("write")
def write_sparse(out, row_names, ref_names, rows, coreacc: bool):
    """Sparse kNN output; rows is an array-backed container from the
    device engines (knn_torch.SparseKnnRows) or, from the host oracle, a
    list (per row) of item lists, packed into the same arrays.

    Jaccard items: (ref_idx, dist_f32); padding entries (dist not < 1.0
    and col == row) are skipped at print (distance_matrix.rs:377-380).
    CoreAcc items: (ref_idx, core_f32, acc_f32) — never skipped.
    """
    arrays = getattr(rows, "as_arrays", None)
    idx, vals, valid = arrays() if arrays else _packed(rows, coreacc)
    n, knn = idx.shape
    row_idx = np.repeat(np.arange(n, dtype=np.int32), knn)
    col_idx = idx.reshape(-1)
    keep = (
        valid.reshape(-1)
        if valid is not None
        else np.ones(n * knn, dtype=bool)
    )
    # engines mark missing candidates with an out-of-range sentinel
    # index; never let one reach the native name-table lookup
    keep = keep & (col_idx < len(ref_names))
    sel = np.flatnonzero(keep)
    if coreacc:
        flat = vals.reshape(-1, 2)
        v1, v2 = flat[sel, 0], flat[sel, 1]
    else:
        d = vals.reshape(-1)
        # padding skip rule: NOT dist < 1.0 (NaN too, as the reference's
        # comparison reads) AND same name — compare names only for those
        # (typically rare) entries
        hi = np.flatnonzero(~(d[sel] < np.float32(1.0)))
        if hi.size:
            rn = np.asarray(row_names)[row_idx[sel[hi]]]
            cn = np.asarray(ref_names)[col_idx[sel[hi]]]
            sel = np.delete(sel, hi[rn == cn])
        v1, v2 = d[sel], None
    r, c = row_idx[sel], col_idx[sel]
    tab_r, tab_c = _name_table(row_names), _name_table(ref_names)
    with OutputPipeline(out) as pipe:
        for s in range(0, sel.size, SPARSE_LINES):
            e = s + SPARSE_LINES
            pipe.submit(format_lines_bytes, tab_r, tab_c, r[s:e], c[s:e],
                        v1[s:e], None if v2 is None else v2[s:e])


# pairs per parallel-format task: bounds each task's working set
# (~16B/pair inputs + ~30B/pair text) while keeping tasks big enough to
# amortise dispatch
TASK_PAIRS = 1 << 21


def self_pair_indices(i0: int, i1: int, n: int):
    """(rows, cols) int32 arrays for upper-triangle rows [i0, i1) of n."""
    counts = np.arange(n - i0 - 1, n - i1 - 1, -1)
    rows = np.repeat(np.arange(i0, i1, dtype=np.int32), counts)
    cols = (
        np.concatenate(
            [np.arange(i + 1, n, dtype=np.int32) for i in range(i0, i1)]
        )
        if i1 > i0
        else np.zeros(0, np.int32)
    )
    return rows, cols


def row_spans(r0: int, r1: int, pairs_per_row: int, target: int = TASK_PAIRS):
    """Split rows [r0, r1) into spans of ~target total pairs."""
    spans = []
    i0 = r0
    while i0 < r1:
        step = max(1, target // max(1, pairs_per_row))
        i1 = min(i0 + step, r1)
        spans.append((i0, i1))
        i0 = i1
    return spans


def emit_coreacc_cross_block(pipe, tab_r, tab_q, block, r0, r1, nq):
    """Submit one (r1-r0, nq, 2) core/acc block of ref-major rectangular
    output to the OutputPipeline pipe, gather and format in row tasks
    (shared by the single-device and sharded cross engines)."""

    def task(i0: int, i1: int) -> bytes:
        rows = np.repeat(np.arange(i0, i1, dtype=np.int32), nq)
        cols = np.tile(np.arange(nq, dtype=np.int32), i1 - i0)
        flat = block[i0 - r0 : i1 - r0].reshape(-1, 2)
        return format_lines_bytes(
            tab_r, tab_q, rows, cols, flat[:, 0], flat[:, 1]
        )

    for i0, i1 in row_spans(r0, r1, nq):
        pipe.submit(task, i0, i1)


def emit_coreacc_self_block(pipe, tab, block, r0, r1, n):
    """Submit one (r1-r0, n, 2) core/acc block's upper-triangle rows of
    the long-form self output to the OutputPipeline pipe, gather and
    format in row tasks (shared by the single-device and sharded
    engines)."""

    def task(i0: int, i1: int) -> bytes:
        rows, cols = self_pair_indices(i0, i1, n)
        flat = block.reshape(-1, 2)[(rows - r0).astype(np.int64) * n + cols]
        return format_lines_bytes(
            tab, tab, rows, cols, flat[:, 0], flat[:, 1]
        )

    for i0, i1 in row_spans(r0, r1, max(1, n - r0)):
        pipe.submit(task, i0, i1)
