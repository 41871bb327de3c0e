"""Batched sketching of DNA assemblies on the card.

Port of sketchtpu/sketchcore/sketch_jax.py::DeviceSketchBackend, the
assemblies branch of sketch_dna_streams: genomes are packed into batches
(one byte per base; PCIe carries that easily), each batch is uploaded once
and gets one hash + sign + bin-minimum launch per k, and densification and
the bit-plane transpose run on the host exactly as in the JAX backend.
Sketches are bit-identical to the host oracle (sketchcore/sketch.py).
"""

from __future__ import annotations

import numpy as np
import torch

from sketchtpu.constants import num_bins as num_bins_fn
from sketchtpu.sketchcore.signs import densify, fill_usigs
from sketchtpu.sketchcore.sketch import Sketch

from .._transfer import HostCopy
from ..hash.nthash_torch import nthash_bin, pack_group, tap_tables

# bases and genomes per batch: bounds the device copy of the batch (one
# byte per base) and its (genomes, nbins) minima table
_BATCH_BASES = 1 << 26
_MAX_GROUP = 1024

_U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def _groups(streams):
    start = 0
    while start < len(streams):
        end, total = start, 0
        while end < len(streams) and end - start < _MAX_GROUP and (
            end == start or total + streams[end].seq_len <= _BATCH_BASES
        ):
            total += streams[end].seq_len
            end += 1
        yield start, end
        start = end


class DeviceSketchBackend:
    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._taps: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}

    def _tap_tables(self, k: int):
        if k not in self._taps:
            fwd, rev = tap_tables(k)
            self._taps[k] = (
                torch.from_numpy(fwd).to(self.device),
                torch.from_numpy(rev).to(self.device),
            )
        return self._taps[k]

    def _dispatch(self, group, kmers, rc: bool, nbins: int):
        seq, starts = pack_group(group)
        seq_d = torch.from_numpy(seq).to(self.device)
        starts_d = torch.from_numpy(starts).to(self.device)
        return {
            kk: HostCopy(
                nthash_bin(seq_d, kk, *self._tap_tables(kk), rc, starts_d,
                           nbins)
            )
            for kk in kmers
        }

    def bin_minima_multi_k(self, streams, kmers, rc: bool, nbins: int):
        """{k: (len(streams), nbins) u64} per-bin sign minima (u64::MAX for
        empty bins). Batch i+1 is packed and launched before batch i's
        minima are read back."""
        out = {kk: np.empty((len(streams), nbins), dtype=np.uint64)
               for kk in kmers}
        pending = None
        for start, end in _groups(streams):
            launched = (start, end,
                        self._dispatch(streams[start:end], kmers, rc, nbins))
            if pending is not None:
                self._collect(out, *pending)
            pending = launched
        if pending is not None:
            self._collect(out, *pending)
        return out

    @staticmethod
    def _collect(out, start, end, launched):
        for kk, copy in launched.items():
            out[kk][start:end] = copy.numpy().view(np.uint64)

    def sketch_dna_streams(self, streams, names, kmers, sketch_size: int,
                           rc: bool, min_count: int, threads: int = 1):
        if any(s.reads for s in streams):
            raise NotImplementedError(
                "sketching reads (FASTQ) is not ported yet "
                "(ROADMAP queue 1 item 5)"
            )
        _s64, nbins, _u = num_bins_fn(sketch_size)
        minima = self.bin_minima_multi_k(streams, kmers, rc, nbins)
        out = []
        for i, (stream, name) in enumerate(zip(streams, names)):
            usigs_parts = []
            densified_any = False
            for kk in kmers:
                binned = minima[kk][i].copy()
                if (binned == _U64_MAX).all():
                    raise ValueError("K-mer larger than smallest valid sequence")
                densified_any |= densify(binned)
                usigs_parts.append(fill_usigs(binned))
            out.append(
                Sketch(
                    name=name,
                    rc=rc,
                    reads=stream.reads,
                    seq_length=stream.seq_len,
                    densified=densified_any,
                    acgt=tuple(int(x) for x in stream.acgt),
                    non_acgt=stream.non_acgt,
                    usigs=np.concatenate(usigs_parts),
                )
            )
        return out
