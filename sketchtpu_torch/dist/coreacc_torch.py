"""Dense core/accessory engines on the card.

Port of sketchtpu/dist/coreacc_jax.py:
- DeviceCoreAccEngine: the fused f32 kernel (K2) over (row block x all
  columns) tiles, within ~1e-5 of the f64 host chain;
- DeviceCoreAccExactStreamEngine (`dist --exact`): per-k exact int16
  samebits strips (K1) and the oracle's f64 chain on the host, so the
  output is byte-identical to the host pipeline.
In both, the next block is launched before the current one is formatted.
"""

from __future__ import annotations

import numpy as np
import torch

from .._transfer import HostCopy
from .coreacc_kernels import coreacc
from .jaccard_torch import cross_pairs, self_pairs, stream_strips, strip
from .samebits_kernels import to_device_words


def _f32(vec, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(vec, dtype=np.float32).copy()).to(device)


class DeviceCoreAccEngine:
    """Tiled f32 core/accessory distances on the card (K2)."""

    def __init__(self, ms, device: torch.device, tile: int = 4096,
                 completeness_vec=None, completeness_cutoff: float = 0.64):
        self.device = torch.device(device)
        self.ms = ms
        self.tile = tile
        self.kmers = tuple(ms.kmer_lengths)
        self._words = to_device_words(ms, self.device)
        self._cutoff = float(completeness_cutoff)
        self._comp = (
            _f32(completeness_vec, self.device)
            if completeness_vec is not None
            else None
        )

    def _block(self, a, b, c1, c2, cutoff, **tri) -> HostCopy:
        core, acc = coreacc(a, b, self.kmers, self.ms.sketch_size, c1, c2,
                            cutoff, **tri)
        return HostCopy(torch.stack([core, acc], dim=-1))

    def _stream(self, out, ref_names, query_names, row_range, launch,
                emit) -> None:
        """Launch (tile x all columns) blocks over rows [lo, hi), each one
        before the previous is written by emit(block, r0, r1, tab_r, tab_q,
        pipe)."""
        from sketchtpu._native import get_lib
        from sketchtpu.dist.output import _name_table

        n = len(ref_names)
        lo, hi = (row_range.start, row_range.stop) if row_range else (0, n)
        starts = list(range(lo, hi, self.tile))
        if not starts:
            return
        tab_r = tab_q = None
        if get_lib() is not None:
            tab_r = _name_table(ref_names)
            tab_q = tab_r if query_names is ref_names else _name_table(query_names)

        def span(r0: int):
            return r0, min(r0 + self.tile, hi)

        blocks = [(span(starts[0]), launch(*span(starts[0])))]
        pipe = None
        if tab_r is not None:
            from sketchtpu.dist.opipe import OutputPipeline

            pipe = OutputPipeline(out)
        try:
            for nxt in starts[1:] + [None]:
                (r0, r1), copy = blocks.pop(0)
                if nxt is not None:
                    blocks.append((span(nxt), launch(*span(nxt))))
                emit(copy.numpy(), r0, r1, tab_r, tab_q, pipe)
        finally:
            if pipe is not None:
                pipe.close()

    def stream_cross_dense(
        self,
        out,
        ref_names: list[str],
        query_names: list[str],
        query_ms,
        rcomp=None,
        qcomp=None,
        cutoff: float = 0.64,
        row_range: slice | None = None,
    ) -> None:
        """Ref-major rectangular core/acc output (cross_dists_all
        semantics); ref row blocks stream against the query words on the
        card. Completeness applies only when both sides have values."""
        from sketchtpu.dist.output import emit_coreacc_cross_block

        nq = query_ms.number_samples_loaded()
        q = to_device_words(query_ms, self.device)
        comp_on = rcomp is not None and qcomp is not None
        rc_v = _f32(rcomp, self.device) if comp_on else None
        qc_v = _f32(qcomp, self.device) if comp_on else None

        def launch(r0: int, r1: int) -> HostCopy:
            c1 = rc_v[r0:r1] if comp_on else None
            return self._block(self._words[r0:r1], q, c1, qc_v, cutoff)

        def emit(block, r0, r1, tab_r, tab_q, pipe):
            emit_coreacc_cross_block(out, ref_names, query_names, tab_r,
                                     tab_q, block, r0, r1, nq, pipe=pipe)

        self._stream(out, ref_names, query_names, row_range, launch, emit)

    def stream_self_dense(
        self, out, names: list[str], row_range: slice | None = None
    ) -> None:
        """Write the upper-triangle long-form core/acc output, launching
        (tile x all-columns) blocks and streaming rows out; only pairs with
        column > row are computed. row_range restricts to a block of
        rows."""
        from sketchtpu.dist.output import emit_coreacc_self_block

        n = len(names)

        def launch(r0: int, r1: int) -> HostCopy:
            c1 = c2 = None
            if self._comp is not None:
                c1, c2 = self._comp[r0:r1], self._comp
            return self._block(self._words[r0:r1], self._words, c1, c2,
                               self._cutoff, tri=True, row0=r0)

        def emit(block, r0, r1, tab_r, tab_q, pipe):
            emit_coreacc_self_block(out, names, tab_r, block, r0, r1, n,
                                    pipe=pipe)

        self._stream(out, names, names, row_range, launch, emit)


class DeviceCoreAccExactStreamEngine:
    """Exact-output dense core/accessory streaming (`dist --exact`): per-k
    exact int16 samebits strips from the card, the oracle's f64 Jaccard +
    completeness + regression chain on the host. Byte-identical to the
    host engine."""

    def __init__(self, ms, device: torch.device, completeness_vec=None,
                 completeness_cutoff: float = 0.64, tile: int = 2048):
        self.device = torch.device(device)
        self.n = ms.number_samples_loaded()
        self.s64 = ms.sketchsize64
        self.kmers = list(ms.kmer_lengths)
        self.sketch_size = ms.sketch_size
        self.tile = tile
        self._comp = (
            np.asarray(completeness_vec, dtype=np.float64)
            if completeness_vec is not None
            else None
        )
        self._cutoff = float(completeness_cutoff)
        self._words = to_device_words(ms, self.device)

    def _core_acc(self, c_rows, c_cols, cutoff: float):
        """values() for stream_strips: the oracle's f64 chain over the
        per-k samebits of each pair."""
        from sketchtpu.dist.jaccard_np import (
            core_acc_from_jaccards,
            jaccard_from_samebits,
        )

        def values(sbs, rows, cols):
            c1 = c_rows[rows] if c_rows is not None else None
            c2 = c_cols[cols] if c_cols is not None else None
            jaccs = np.empty((rows.size, len(self.kmers)), dtype=np.float64)
            for ki, sb in enumerate(sbs):
                jaccs[:, ki] = jaccard_from_samebits(sb, self.s64, c1, c2,
                                                     cutoff)
            return core_acc_from_jaccards(jaccs, self.kmers, self.sketch_size)

        return values

    def stream_self_dense(
        self, out, names: list[str], row_range: slice | None = None
    ) -> None:
        n, w = self.n, self._words
        stream_strips(
            out, names, names, n, row_range, self.tile,
            lambda r0: [strip(w[:, ki], r0, self.tile)
                        for ki in range(len(self.kmers))],
            self_pairs(n), lambda r0: max(1, n - r0),
            self._core_acc(self._comp, self._comp, self._cutoff),
        )

    def stream_cross_dense(
        self,
        out,
        ref_names: list[str],
        query_names: list[str],
        query_ms,
        rcomp=None,
        qcomp=None,
        cutoff: float = 0.64,
        row_range: slice | None = None,
    ) -> None:
        """Cross (ref-vs-query) twin of stream_self_dense, byte-identical
        to api.cross_dists_all + write_dense_cross. Completeness applies
        only when both sides have values."""
        comp_on = rcomp is not None and qcomp is not None
        rc = np.asarray(rcomp, dtype=np.float64) if comp_on else None
        qc = np.asarray(qcomp, dtype=np.float64) if comp_on else None
        w = self._words
        q = to_device_words(query_ms, self.device)
        stream_strips(
            out, ref_names, query_names, self.n, row_range, self.tile,
            lambda r0: [strip(w[:, ki], r0, self.tile, q[:, ki])
                        for ki in range(len(self.kmers))],
            cross_pairs(query_ms.number_samples_loaded()),
            lambda r0: query_ms.number_samples_loaded(),
            self._core_acc(rc, qc, float(cutoff)),
        )
