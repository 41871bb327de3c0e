"""Exact samebits engines on the card (K1), single-k distances.

Port of sketchtpu/dist/jaccard_jax.py: DeviceSamebitsEngine is the
`engine` hook of the host distance functions (dist/api.py), and
DeviceDenseStreamEngine streams (row block x all columns) int16 samebits
strips while the host runs the oracle's f64 Jaccard/ANI/completeness chain
and the output pipeline on each strip, so the text is identical to the
host path's. stream_strips() is the strip loop it shares with the
`--exact` core/accessory engine: the next strip is launched before the
current one is formatted.
"""

from __future__ import annotations

import numpy as np
import torch

from .._transfer import HostCopy
from .samebits_kernels import samebits, words_to_device


def strip(mat: torch.Tensor, r0: int, tile: int,
          q: torch.Tensor | None = None) -> HostCopy:
    """Launch the int16 samebits of rows [r0, r0+tile) of mat against all
    of mat (only pairs with column > row filled in) or against q."""
    a = mat[r0 : r0 + tile]
    if q is None:
        return HostCopy(samebits(a, mat, out_dtype=torch.int16, tri=True,
                                 row0=r0))
    return HostCopy(samebits(a, q, out_dtype=torch.int16))


def self_pairs(n: int):
    """pairs(i0, i1): (rows, cols) of the upper-triangle long form."""
    from sketchtpu.dist.output import self_pair_indices

    return lambda i0, i1: self_pair_indices(i0, i1, n)


def cross_pairs(nq: int):
    """pairs(i0, i1): (rows, cols) of the ref-major rectangle."""
    def pairs(i0: int, i1: int):
        rows = np.repeat(np.arange(i0, i1, dtype=np.int32), nq)
        cols = np.tile(np.arange(nq, dtype=np.int32), i1 - i0)
        return rows, cols

    return pairs


def stream_strips(out, ref_names, query_names, n: int,
                  row_range: slice | None, tile: int, dispatch, pairs,
                  pairs_per_row, values) -> None:
    """Write the lines of rows [lo, hi) in row blocks of `tile`.

    dispatch(r0) launches a block's strips (a list of HostCopy of
    (tile, ncols) samebits); pairs(i0, i1) gives the (rows, cols) of rows
    [i0, i1); values(sbs, rows, cols) turns the samebits of those pairs
    (one array per strip) into (v1, v2 or None) f32 columns. With the
    native helper, blocks are cut into tasks of about TASK_PAIRS pairs
    (pairs_per_row(r0) per row) that an OutputPipeline computes in
    parallel and writes in order."""
    from sketchtpu._native import get_lib
    from sketchtpu.dist.output import (
        _name_table,
        fmt_f32,
        format_lines_bytes,
        row_spans,
    )

    lo, hi = (row_range.start, row_range.stop) if row_range else (0, n)
    starts = list(range(lo, hi, tile))
    if not starts:
        return
    tab_r = tab_q = None
    if get_lib() is not None:
        tab_r = _name_table(ref_names)
        tab_q = tab_r if query_names is ref_names else _name_table(query_names)

    def lines(strips, sbase: int, i0: int, i1: int):
        rows, cols = pairs(i0, i1)
        flat_idx = (rows - sbase).astype(np.int64) * strips[0].shape[1] + cols
        v1, v2 = values([s.reshape(-1)[flat_idx] for s in strips], rows, cols)
        return rows, cols, v1, v2

    def chunk_task(strips, sbase: int, i0: int, i1: int) -> bytes:
        return format_lines_bytes(tab_r, tab_q, *lines(strips, sbase, i0, i1))

    pending = [(starts[0], dispatch(starts[0]))]
    pipe = None
    if tab_r is not None:
        from sketchtpu.dist.opipe import OutputPipeline

        pipe = OutputPipeline(out)
    try:
        for nxt in starts[1:] + [None]:
            r0, copies = pending.pop(0)
            if nxt is not None:
                pending.append((nxt, dispatch(nxt)))
            r1 = min(r0 + tile, hi)
            strips = [c.numpy() for c in copies]
            if pipe is not None:
                for i0, i1 in row_spans(r0, r1, pairs_per_row(r0)):
                    pipe.submit(chunk_task, strips, r0, i0, i1)
                continue
            rows, cols, v1, v2 = lines(strips, r0, r0, r1)
            out.write("".join(
                f"{ref_names[i]}\t{query_names[j]}\t{fmt_f32(a)}"
                + ("" if v2 is None else f"\t{fmt_f32(v2[x])}") + "\n"
                for x, (i, j, a) in enumerate(zip(rows, cols, v1))
            ))
    finally:
        if pipe is not None:
            pipe.close()


class DeviceSamebitsEngine:
    """Drop-in `engine` for the dist/api.py distance functions."""

    def __init__(self, sketchsize64: int, device: torch.device):
        self.s64 = sketchsize64
        self.device = torch.device(device)

    def matrix(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """All-pairs samebits: a (na, W) u64, b (nb, W) u64 -> (na, nb)."""
        out = samebits(
            words_to_device(a, self.device), words_to_device(b, self.device),
            out_dtype=torch.int32,
        )
        return out.cpu().numpy()


class DeviceDenseStreamEngine:
    """Streaming dense distances for single-k runs: exact int16 samebits
    strips on the card, the oracle's f64 chain and formatting on the
    host."""

    def __init__(self, ms, k_idx: int, device: torch.device,
                 tile: int = 2048):
        self.device = torch.device(device)
        self.s64 = ms.sketchsize64
        self.tile = tile
        self.k_idx = k_idx
        self.n = ms.number_samples_loaded()
        self._mat = words_to_device(ms.bins_matrix(k_idx), self.device)

    def _distances(self, dist_type, c_rows, c_cols, cutoff: float):
        """values() for stream_strips: the oracle's f64 Jaccard (with
        completeness when both sides have it), ANI or 1 - J, as f32."""
        from sketchtpu.dist.jaccard_np import ani_pois, jaccard_from_samebits

        def values(sbs, rows, cols):
            c1 = c_rows[rows] if c_rows is not None else None
            c2 = c_cols[cols] if c_cols is not None else None
            j = jaccard_from_samebits(sbs[0], self.s64, c1, c2, cutoff)
            d = ani_pois(j, dist_type.k) if dist_type.ani else 1.0 - j
            return d.astype(np.float32), None

        return values

    def stream_self_dense(
        self, out, names, dist_type, comp=None, cutoff: float = 0.64,
        row_range: slice | None = None,
    ) -> None:
        n = self.n
        comp = np.asarray(comp, dtype=np.float64) if comp is not None else None
        stream_strips(
            out, names, names, n, row_range, self.tile,
            lambda r0: [strip(self._mat, r0, self.tile)],
            self_pairs(n), lambda r0: max(1, n - r0),
            self._distances(dist_type, comp, comp, cutoff),
        )

    def stream_cross_dense(
        self,
        out,
        ref_names,
        query_names,
        query_ms,
        dist_type,
        rcomp=None,
        qcomp=None,
        cutoff: float = 0.64,
        row_range: slice | None = None,
    ) -> None:
        """Ref-major rectangular output (cross_dists_all semantics); ref
        row blocks stream against the query matrix on the card. row_range
        restricts to a block of reference rows."""
        nq = query_ms.number_samples_loaded()
        q = words_to_device(query_ms.bins_matrix(self.k_idx), self.device)
        rcomp = np.asarray(rcomp, dtype=np.float64) if rcomp is not None else None
        qcomp = np.asarray(qcomp, dtype=np.float64) if qcomp is not None else None
        stream_strips(
            out, ref_names, query_names, self.n, row_range, self.tile,
            lambda r0: [strip(self._mat, r0, self.tile, q)],
            cross_pairs(nq), lambda r0: nq,
            self._distances(dist_type, rcomp, qcomp, cutoff),
        )
