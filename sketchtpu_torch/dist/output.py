"""Distance output formatting.

Matches Rust's `Display` for f32 (shortest decimal string that round-trips,
positional notation, no trailing ".0") and the long-form / sparse layouts of
sketchlib.rust src/distances/distance_matrix.rs:175-209,360-401.

At scale the text itself is the bottleneck (a 100k-genome all-vs-all run is
5e9 lines), so bulk line assembly runs in the native helper library
(stpu_format_dist_lines: std::to_chars shortest round-trip + positional
expansion, byte-identical to fmt_f32 below). Pure-Python paths remain as
fallback.
"""

from __future__ import annotations

import ctypes
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import spans
from .._native import get_lib

# lines per native-formatting chunk (bounds the host buffer)
_CHUNK = 1 << 21
# formatting threads: ctypes CDLL calls release the GIL, so chunks format
# in parallel in the native helper while writes stay in order. One worker
# on a single-core host degenerates to the serial path.
_WORKERS = min(8, os.cpu_count() or 1)
_POOL: ThreadPoolExecutor | None = None


def _pool() -> ThreadPoolExecutor:
    global _POOL
    if _POOL is None:
        _POOL = ThreadPoolExecutor(max_workers=_WORKERS)
    return _POOL


def fmt_f32(value) -> str:
    """Format a float32 like Rust's `{}` (shortest round-trip, positional)."""
    v = np.float32(value)
    if np.isnan(v):
        return "NaN"
    if np.isinf(v):
        return "inf" if v > 0 else "-inf"
    return np.format_float_positional(v, unique=True, trim="-")


def fmt_f32_column(values: np.ndarray) -> list[str]:
    values = np.ascontiguousarray(values, dtype=np.float32)
    lib = get_lib()
    if lib is not None and values.size:
        n = values.size
        buf = ctypes.create_string_buffer(64 * n)
        lens = np.empty(n, dtype=np.int32)
        lib.stpu_format_f32(
            values.ctypes.data, n, buf, lens.ctypes.data_as(ctypes.c_void_p)
        )
        raw = buf.raw
        return [
            raw[64 * i : 64 * i + lens[i]].decode("ascii") for i in range(n)
        ]
    return [fmt_f32(v) for v in values]


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
    OutputPipeline's workers format in parallel). Caller must have checked
    get_lib() is not None."""
    lib = get_lib()
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


def _native_lines(
    out,
    tab_r: tuple[bytes, np.ndarray],
    tab_c: tuple[bytes, np.ndarray],
    rows: np.ndarray,
    cols: np.ndarray,
    v1: np.ndarray,
    v2: np.ndarray | None,
) -> bool:
    """Assemble and write "row\\tcol\\tv1[\\tv2]\\n" lines natively.
    Returns False when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return False
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    v1 = np.ascontiguousarray(v1, dtype=np.float32)
    if v2 is not None:
        v2 = np.ascontiguousarray(v2, dtype=np.float32)
    write = out.buffer.write if hasattr(out, "buffer") else None

    def fmt(s: int, e: int) -> bytes:
        return format_lines_bytes(
            tab_r,
            tab_c,
            rows[s:e],
            cols[s:e],
            v1[s:e],
            v2[s:e] if v2 is not None else None,
        )

    def emit(chunk: bytes) -> None:
        if write is not None:
            write(chunk)
        else:
            out.write(chunk.decode("utf-8"))
        spans.count("bytes", len(chunk))

    # threaded runs shrink the chunk so total in-flight buffer bytes stay
    # at the serial path's level (~64B/value per chunk, _WORKERS+2 live)
    step = _CHUNK if _WORKERS == 1 else max(1 << 17, _CHUNK // _WORKERS)
    chunks = [
        (s, min(s + step, rows.size))
        for s in range(0, rows.size, step)
    ]
    if _WORKERS == 1 or len(chunks) == 1:
        for s, e in chunks:
            emit(fmt(s, e))
    else:
        # the native call releases the GIL: format up to _WORKERS chunks
        # concurrently, write strictly in order; the bounded window caps
        # in-flight buffers
        pool = _pool()
        futures = []
        for s, e in chunks:
            if len(futures) >= _WORKERS + 1:
                emit(futures.pop(0).result())
            futures.append(pool.submit(fmt, s, e))
        for f in futures:
            emit(f.result())
    if write is not None:
        out.buffer.flush()
    return True


@spans.spanned("write")
def write_dense_self(out, names, dists, coreacc: bool,
                     row_range: slice | None = None):
    """Upper-triangle long form. dists: (n_pairs,) or (n_pairs, 2).
    With row_range, dists covers only rows [lo, hi) (a multi-process
    shard of the long-form output)."""
    n = len(names)
    lo, hi = (row_range.start, row_range.stop) if row_range else (0, n)
    dists = np.asarray(dists)
    if get_lib() is not None:
        from .opipe import OutputPipeline

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
        return
    _write_dense_self_py(out, names, dists, coreacc, lo, hi)


def _write_dense_self_py(out, names, dists, coreacc: bool,
                         lo: int = 0, hi: int | None = None):
    n = len(names)
    hi = n if hi is None else hi
    idx = 0
    if coreacc:
        for i in range(lo, hi):
            for j in range(i + 1, n):
                out.write(
                    f"{names[i]}\t{names[j]}\t"
                    f"{fmt_f32(dists[idx, 0])}\t{fmt_f32(dists[idx, 1])}\n"
                )
                idx += 1
    else:
        for i in range(lo, hi):
            for j in range(i + 1, n):
                out.write(f"{names[i]}\t{names[j]}\t{fmt_f32(dists[idx])}\n")
                idx += 1


@spans.spanned("write")
def write_dense_cross(out, ref_names, query_names, dists, coreacc: bool):
    """Rectangular long form, ref-major."""
    nr, nq = len(ref_names), len(query_names)
    dists = np.asarray(dists)
    if get_lib() is not None:
        from .opipe import OutputPipeline

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
        return
    idx = 0
    if coreacc:
        for rn in ref_names:
            for qn in query_names:
                out.write(
                    f"{rn}\t{qn}\t{fmt_f32(dists[idx, 0])}\t"
                    f"{fmt_f32(dists[idx, 1])}\n"
                )
                idx += 1
    else:
        for rn in ref_names:
            for qn in query_names:
                out.write(f"{rn}\t{qn}\t{fmt_f32(dists[idx])}\n")
                idx += 1


@spans.spanned("write")
def write_sparse(out, row_names, ref_names, rows, coreacc: bool):
    """Sparse kNN output; rows is a list (per row) of item lists, or an
    array-backed container from the device engines (knn_torch.SparseKnnRows).

    Jaccard items: (ref_idx, dist_f32); padding entries (dist == 1.0 and
    col == row) are skipped at print (distance_matrix.rs:377-380).
    CoreAcc items: (ref_idx, core_f32, acc_f32) — never skipped.
    """
    arrays = getattr(rows, "as_arrays", None)
    if arrays is not None:
        idx, vals, valid = arrays()
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
        if not coreacc:
            d = vals.reshape(-1)
            sel = np.flatnonzero(keep)
            # padding skip rule: dist >= 1.0 AND same name — compare names
            # only for the (typically rare) dist >= 1.0 entries
            hi = np.flatnonzero(d[sel] >= np.float32(1.0))
            if hi.size:
                rn = np.asarray(row_names)[row_idx[sel[hi]]]
                cn = np.asarray(ref_names)[col_idx[sel[hi]]]
                sel = np.delete(sel, hi[rn == cn])
            if _native_lines(
                out, _name_table(row_names), _name_table(ref_names),
                row_idx[sel], col_idx[sel], d[sel], None,
            ):
                return
        else:
            sel = np.flatnonzero(keep)
            if _native_lines(
                out, _name_table(row_names), _name_table(ref_names),
                row_idx[sel], col_idx[sel],
                vals.reshape(-1, 2)[sel, 0], vals.reshape(-1, 2)[sel, 1],
            ):
                return
    if coreacc:
        for row_name, items in zip(row_names, rows):
            for ref_idx, core, acc in items:
                out.write(
                    f"{row_name}\t{ref_names[ref_idx]}\t"
                    f"{fmt_f32(core)}\t{fmt_f32(acc)}\n"
                )
    else:
        for row_name, items in zip(row_names, rows):
            for ref_idx, dist in items:
                col_name = ref_names[ref_idx]
                if np.float32(dist) < np.float32(1.0) or col_name != row_name:
                    out.write(f"{row_name}\t{col_name}\t{fmt_f32(dist)}\n")


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


def emit_coreacc_cross_block(
    out, ref_names, query_names, tab_r, tab_q, block, r0, r1, nq, pipe=None
):
    """Write one (r1-r0, nq, 2) core/acc block of ref-major rectangular
    output (shared by the single-device and sharded cross engines). With
    an OutputPipeline, gather+format run as ordered parallel tasks."""
    if tab_r is not None and pipe is not None:

        def task(i0: int, i1: int) -> bytes:
            rows = np.repeat(np.arange(i0, i1, dtype=np.int32), nq)
            cols = np.tile(np.arange(nq, dtype=np.int32), i1 - i0)
            flat = block[i0 - r0 : i1 - r0].reshape(-1, 2)
            return format_lines_bytes(
                tab_r, tab_q, rows, cols, flat[:, 0], flat[:, 1]
            )

        for i0, i1 in row_spans(r0, r1, nq):
            pipe.submit(task, i0, i1)
        return
    if tab_r is not None:
        rows = np.repeat(np.arange(r0, r1, dtype=np.int32), nq)
        cols = np.tile(np.arange(nq, dtype=np.int32), r1 - r0)
        flat = block.reshape(-1, 2)
        _native_lines(out, tab_r, tab_q, rows, cols, flat[:, 0], flat[:, 1])
        return
    for i in range(r0, r1):
        cores = fmt_f32_column(block[i - r0, :, 0])
        accs = fmt_f32_column(block[i - r0, :, 1])
        name_i = ref_names[i]
        out.write(
            "".join(
                f"{name_i}\t{query_names[j]}\t{c}\t{a}\n"
                for j, c, a in zip(range(nq), cores, accs)
            )
        )


def emit_coreacc_self_block(out, names, tab, block, r0, r1, n, pipe=None):
    """Write one (r1-r0, n, 2) core/acc block's upper-triangle rows of the
    long-form self output (shared by the single-device and sharded
    engines). With an OutputPipeline, gather+format run as ordered
    parallel tasks."""
    if tab is not None and pipe is not None:

        def task(i0: int, i1: int) -> bytes:
            rows, cols = self_pair_indices(i0, i1, n)
            flat = block.reshape(-1, 2)[
                (rows - r0).astype(np.int64) * n + cols
            ]
            return format_lines_bytes(
                tab, tab, rows, cols, flat[:, 0], flat[:, 1]
            )

        for i0, i1 in row_spans(r0, r1, max(1, n - r0)):
            pipe.submit(task, i0, i1)
        return
    if tab is not None:
        rows, cols = self_pair_indices(r0, r1, n)
        flat = block.reshape(-1, 2)[(rows - r0).astype(np.int64) * n + cols]
        _native_lines(out, tab, tab, rows, cols, flat[:, 0], flat[:, 1])
        return
    for i in range(r0, r1):
        cores = fmt_f32_column(block[i - r0, i + 1 :, 0])
        accs = fmt_f32_column(block[i - r0, i + 1 :, 1])
        name_i = names[i]
        out.write(
            "".join(
                f"{name_i}\t{names[j]}\t{c}\t{a}\n"
                for j, c, a in zip(range(i + 1, n), cores, accs)
            )
        )
