"""Batched sketching of DNA, amino acids and 3Di on the card.

Port of sketchtpu/sketchcore/sketch_jax.py::DeviceSketchBackend and
sketch_aa_jax.py::DeviceAaSketchBackend.
- Assemblies: genomes are packed into batches (one byte per base; PCIe
  carries that easily), each batch is uploaded once and gets one hash +
  sign + bin-minimum launch for all k (nthash_bin_multi).
- Reads (FASTQ): the count filter depends on the order of the k-mers, so
  the card writes the sign of every window in sequence order
  (nthash_signs, all k in one launch) and the host filters them
  (bin_minima_filtered, the native C++ loop) in a --threads pool. A read
  stream is uploaded once and hashed in chunks of window starts, each
  reading its k - 1 bases of overlap and emitting only the starts it owns,
  so device and pinned memory stay bounded for long streams; chunk j + 1
  is launched before chunk j is read back, and the filters run while the
  next launches do. With SKETCHTPU_FASTQ_PREFILTER=1 and --min-count >= 2
  (sign_prefilter.py, off by default as in the JAX package) a segment of
  at least 2^24 window starts, up to the whole stream, is hashed on one
  device, where each k's signs are cut to those the count filter could
  consult (sort, the keep kernel, compaction); only those come back, and
  the host filter gives the same bins from them.
- Amino acids and 3Di (DeviceAaSketchBackend): batches as for assemblies,
  one aahash_bin_multi launch per batch for all k, whose per-(k, sample)
  reachability flags stand in for the host oracle's emission-mask raise.
- Several devices (the JAX backends' round-robin over the local devices):
  batches, and the chunks (prefiltered: segments) of read streams, go to
  the devices in turn, with up to max(8, 2 x devices) batches (2 x devices
  chunks, a segment a device) in flight, and are read back in order.
  Launches are asynchronous, so one host thread keeps every device busy,
  and the sketches are those of one device.
Densification and the bit-plane transpose run on the host exactly as in
the JAX backends. Sketches are bit-identical to the host oracle
(sketchcore/sketch.py).
"""

from __future__ import annotations

import itertools
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .._transfer import HostCopy
from ..constants import SIGN_MOD
from ..constants import num_bins as num_bins_fn
from ..hash.aahash_torch import aahash_bin_multi, pack_aa_group
from ..hash.nthash_torch import nthash_bin_multi, nthash_signs, pack_group
from . import sign_prefilter
from .sign_prefilter import keep_flags, survivors
from .signs import bin_minima_filtered, densify, fill_usigs
from .sketch import Sketch

# bases and genomes per batch: bounds the device copy of the batch (one
# byte per base) and its (genomes, nbins) minima table
_BATCH_BASES = 1 << 26
_MAX_GROUP = 1024
# signs per chunk of a read stream, over all k (8 bytes each on the card
# and in pinned memory), and chunk launches in flight
_READ_CHUNK_SIGNS = 1 << 25
_READ_AHEAD = 2
# window starts a segment of a prefiltered read stream: at least the JAX
# package's segment (2^24 windows, sketch_jax.py:38-64), else as many as
# keep _SEGMENT_SIGNS signs over all k on the card (8 bytes each: 4 GiB)
# and at most _SEGMENT_STARTS (the whole of a 50 Mb sample), so that a
# sign's min_count-th occurrence falls inside its segment as often as can
# be; a row's sort and keep flags take about 48 bytes a start besides
_SEGMENT_MIN_STARTS = 1 << 24
_SEGMENT_STARTS = 1 << 26
_SEGMENT_SIGNS = 1 << 29

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


def _device_list(devices) -> list[torch.device]:
    """A device, or a list of them (slots: one may repeat), as a list."""
    if isinstance(devices, (list, tuple)):
        if not devices:
            raise ValueError("no device given")
        return [torch.device(d) for d in devices]
    return [torch.device(devices)]


def _pipelined_minima(streams, kmers, nbins: int, devices, dispatch,
                      collect):
    """{k: (len(streams), nbins) u64} per-bin sign minima of the batches of
    streams (_groups): dispatch(batch, device) launches one on the device
    and returns its pending copies, collect(out, start, end, *copies)
    reads them into out. Batches go to the devices in turn; up to
    max(8, 2 x devices) are in flight, read back in order."""
    out = {kk: np.empty((len(streams), nbins), dtype=np.uint64)
           for kk in kmers}
    window = max(8, 2 * len(devices))
    pending = deque()
    for i, (start, end) in enumerate(_groups(streams)):
        pending.append((start, end, *dispatch(streams[start:end],
                                              devices[i % len(devices)])))
        if len(pending) >= window:
            collect(out, *pending.popleft())
    while pending:
        collect(out, *pending.popleft())
    return out


def read_chunks(n: int, kmers, chunk: int, n_starts: int | None = None):
    """(first start, owned starts) of the chunks of a stream of n bases: the
    window starts of the smallest k (at most n_starts of them), `chunk` a
    chunk."""
    starts = max(0, n - min(kmers) + 1)
    if n_starts is not None:
        starts = min(starts, n_starts)
    return [(c0, min(chunk, starts - c0)) for c0 in range(0, starts, chunk)]


def _chunk_starts(nk: int) -> int:
    """Window starts a chunk of a read stream at nk k values."""
    return max(1, _READ_CHUNK_SIGNS // nk)


def _segment_starts(nk: int) -> int:
    """Window starts a segment of a prefiltered read stream at nk k
    values."""
    return max(_SEGMENT_MIN_STARTS,
               min(_SEGMENT_STARTS, _SEGMENT_SIGNS // nk))


class DeviceSketchBackend:
    """DNA sketches on a device, or round-robin over a list of them."""

    def __init__(self, devices):
        self.devices = _device_list(devices)

    # --- assemblies ---

    @staticmethod
    def _dispatch(group, kmers, rc: bool, nbins: int, device):
        """One launch for the batch on `device`; the (nk, genomes, nbins)
        minima start their copy to the host."""
        seq, starts = pack_group(group)
        seq_d = torch.from_numpy(seq).to(device)
        starts_d = torch.from_numpy(starts).to(device)
        return (HostCopy(nthash_bin_multi(seq_d, kmers, rc, starts_d,
                                          nbins)),)

    def bin_minima_multi_k(self, streams, kmers, rc: bool, nbins: int):
        """{k: (len(streams), nbins) u64} per-bin sign minima (u64::MAX for
        empty bins)."""
        kmers = list(dict.fromkeys(kmers))  # one plane of minima per k
        return _pipelined_minima(
            streams, kmers, nbins, self.devices,
            lambda group, dev: self._dispatch(group, kmers, rc, nbins, dev),
            self._collect)

    @staticmethod
    def _collect(out, start, end, launched):
        minima = launched.numpy().view(np.uint64)
        for ki, kk in enumerate(out):
            out[kk][start:end] = minima[ki]

    # --- reads: in-order signs ---

    def _launch_signs(self, stream, kmers, rc: bool, turn, chunk: int,
                      n_starts: int | None = None):
        """Launch the chunks of `chunk` window starts of a read stream in
        order, each uploaded (its bases and the k - 1 past them) to the
        device whose turn it is (next(turn)); yields (owned starts, the
        (nk, owned) signs on the device, last chunk) as each chunk's
        launch is made."""
        n = stream.seq_len
        chunks = read_chunks(n, kmers, chunk, n_starts)
        if not chunks:
            return
        seq, _starts = pack_group([stream])
        reach = max(kmers) - 1  # bases a chunk reads past its last start
        for j, (c0, own) in enumerate(chunks):
            part = torch.from_numpy(seq[c0 : min(n, c0 + own + reach)]).to(
                next(turn))
            yield own, nthash_signs(part, kmers, rc, own), j == len(chunks) - 1

    def _stream_rows(self, jobs, kmers, rc: bool, sink, chunk: int,
                     ahead: int, prepare, collect, n_starts: int | None,
                     devices):
        """For each (key, stream) of jobs, in order: sink(key, [signs per
        k]) as soon as the stream's last chunk of `chunk` window starts
        (of [0, n_starts)) is read back. Chunks go to the devices in turn;
        prepare(own, signs) turns a launch's (nk, own) signs into what is
        pending, collect(pending) into its per-k u64 arrays; up to `ahead`
        launches stay in flight while the host reads the oldest."""
        pending = deque()
        turn = itertools.cycle(devices)

        def read():
            key, parts, item, last = pending.popleft()
            for ki, part in enumerate(collect(item)):
                parts[ki].append(part)
            if last:
                sink(key, [np.concatenate(p) if p else np.zeros(0, np.uint64)
                           for p in parts])

        for key, stream in jobs:
            parts = [[] for _ in kmers]
            launched_any = False
            for own, signs, last in self._launch_signs(
                    stream, kmers, rc, turn, chunk, n_starts):
                launched_any = True
                pending.append((key, parts, prepare(own, signs), last))
                while len(pending) > ahead:
                    read()
            if not launched_any:  # no window: every bin stays empty
                sink(key, [np.zeros(0, np.uint64) for _ in kmers])
        while pending:
            read()

    def _signs_streams(self, jobs, kmers, rc: bool, sink,
                       n_starts: int | None = None, devices=None):
        """For each (key, stream) of jobs, in order, the valid signs of every
        k in sequence order, of window starts [0, n_starts) (all by
        default): sink(key, [signs per k]) as soon as the stream's last
        chunk is read back. Up to max(_READ_AHEAD, 2 x devices) chunk
        launches are in flight while the host compacts the oldest."""

        def compact(item):
            own, copy = item
            return [row[row != _U64_MAX]
                    for row in copy.numpy().view(np.uint64)[:, :own]]

        devices = devices or self.devices
        self._stream_rows(
            jobs, kmers, rc, sink, _chunk_starts(len(kmers)),
            max(_READ_AHEAD, 2 * len(devices)),
            lambda own, signs: (own, HostCopy(signs)), compact, n_starts,
            devices)

    def _survivor_streams(self, jobs, kmers, rc: bool, nbins: int,
                          min_count: int, sink, n_starts: int | None = None,
                          devices=None):
        """_signs_streams through the prefilter (sign_prefilter.py): for
        each (key, stream) of jobs, in order, sink(key, [signs per k]) with
        only the signs the count filter could consult, in sequence order.
        A segment (_segment_starts) is hashed in one launch on the device
        whose turn it is, where each k's signs are sorted and flagged
        (nothing synchronised); the kept ones are gathered and copied back
        once the next segment is launched: up to one segment a device and
        one more are in flight."""

        def gather(item):
            signs, flags = item
            return [HostCopy(kept).numpy().view(np.uint64)
                    for kept in survivors(signs, flags)]

        devices = devices or self.devices
        self._stream_rows(
            jobs, kmers, rc, sink, _segment_starts(len(kmers)), len(devices),
            lambda _own, signs: (signs, keep_flags(signs, nbins, min_count)),
            gather, n_starts, devices)

    def read_minima(self, jobs, kmers, rc: bool, nbins: int, min_count: int,
                    pool) -> dict:
        """{(k, key): future of the (nbins,) count-filtered bin minima} of
        each (key, read stream) of jobs: the count filter, order-dependent
        within one (stream, k) sign sequence and independent across them,
        runs in `pool` for finished streams while later chunks launch; on
        the signs the prefilter keeps where it is enabled
        (sign_prefilter.enabled)."""
        futs = {}

        def sink(key, signs_per_k):
            for kk, signs in zip(kmers, signs_per_k):
                futs[kk, key] = pool.submit(bin_minima_filtered, signs, nbins,
                                            min_count)

        if sign_prefilter.enabled(min_count):
            self._survivor_streams(jobs, kmers, rc, nbins, min_count, sink)
        else:
            self._signs_streams(jobs, kmers, rc, sink)
        return futs

    def signs_in_order(self, stream, k: int, rc: bool,
                       n_starts: int | None = None) -> np.ndarray:
        """Valid-window signs of one (stream, k) in sequence order, of
        window starts [0, n_starts) (all by default)."""
        out = []
        self._signs_streams([(0, stream)], [k], rc,
                            lambda _key, signs: out.extend(signs), n_starts)
        return out[0]

    def dispatch_signs_maybe_filtered(self, stream, k: int, rc: bool,
                                      nbins: int, min_count: int, dev=None,
                                      n_starts: int | None = None):
        """The JAX backend's interface for the count filter of one (stream,
        k) (sketch_jax.py:615, called as inverted/index.py:555 does): the
        signs of window starts [0, n_starts) in sequence order, only those
        the prefilter keeps where it is enabled (sign_prefilter.enabled),
        on `dev` or in turn on the backend's devices. The work is done
        here; the handle is the signs, whose filtered bins are the full
        stream's."""
        devices = None if dev is None else [torch.device(dev)]
        out = []
        sink = lambda _key, signs: out.extend(signs)  # noqa: E731
        if sign_prefilter.enabled(min_count):
            self._survivor_streams([(0, stream)], [k], rc, nbins, min_count,
                                   sink, n_starts, devices)
        else:
            self._signs_streams([(0, stream)], [k], rc, sink, n_starts,
                                devices)
        return out[0]

    @staticmethod
    def collect_signs_maybe_filtered(handle) -> np.ndarray:
        """The signs of a dispatch_signs_maybe_filtered handle, in sequence
        order."""
        return handle

    def sketch_dna_streams(self, streams, names, kmers, sketch_size: int,
                           rc: bool, min_count: int, threads: int = 1):
        _s64, nbins, _u = num_bins_fn(sketch_size)
        assembly_idx = [i for i, s in enumerate(streams) if not s.reads]
        read_idx = [i for i, s in enumerate(streams) if s.reads]
        bins: dict[tuple[int, int], np.ndarray] = {}
        if assembly_idx:
            minima = self.bin_minima_multi_k(
                [streams[i] for i in assembly_idx], kmers, rc, nbins)
            for bi, i in enumerate(assembly_idx):
                for kk in kmers:
                    bins[kk, i] = minima[kk][bi]
        if read_idx:
            with ThreadPoolExecutor(max_workers=max(1, threads)) as pool:
                futs = self.read_minima([(i, streams[i]) for i in read_idx],
                                        list(dict.fromkeys(kmers)), rc, nbins,
                                        min_count, pool)
                for key, fut in futs.items():
                    bins[key] = fut.result()
        out = []
        for i, (stream, name) in enumerate(zip(streams, names)):
            usigs_parts = []
            minhash_sum = 0.0
            densified_any = False
            for kk in kmers:
                binned = bins[kk, i].copy()
                if (binned == _U64_MAX).all():
                    raise ValueError("K-mer larger than smallest valid sequence")
                densified_any |= densify(binned)
                minhash_sum += float(binned[0]) / float(SIGN_MOD)
                usigs_parts.append(fill_usigs(binned))
            seq_length = (int(len(kmers) / minhash_sum) if stream.reads
                          else stream.seq_len)
            out.append(
                Sketch(
                    name=name,
                    rc=rc,
                    reads=stream.reads,
                    seq_length=seq_length,
                    densified=densified_any,
                    acgt=tuple(int(x) for x in stream.acgt),
                    non_acgt=stream.non_acgt,
                    usigs=np.concatenate(usigs_parts),
                )
            )
        return out


class DeviceAaSketchBackend:
    """Amino-acid and 3Di sketches: the batches of DeviceSketchBackend's
    assemblies, each uploaded once with one aahash_bin_multi launch for
    all k, on a device or round-robin over a list of them."""

    def __init__(self, devices):
        self.devices = _device_list(devices)

    @staticmethod
    def _dispatch(group, kmers, level: int, nbins: int, device):
        """One launch for the batch on `device`; its minima and
        reachability flags start their copy to the host."""
        codes, starts = pack_aa_group(group)
        codes_d = torch.from_numpy(codes).to(device)
        starts_d = torch.from_numpy(starts).to(device)
        minima, reach = aahash_bin_multi(codes_d, kmers, level, starts_d,
                                         nbins)
        return HostCopy(minima), HostCopy(reach)

    def bin_minima_multi_k(self, streams, kmers, level: int, nbins: int):
        """{k: (len(streams), nbins) u64} per-bin sign minima (u64::MAX for
        empty bins). Raises as the host oracle does where a sample has no
        reachable window at some k."""
        kmers = list(dict.fromkeys(kmers))  # one plane of minima per k
        # m = seq_len - k + 1 <= 0: the host oracle's unconditional raise
        # (aa_window_valid), checked before any launch
        if any(s.seq_len < max(kmers) for s in streams):
            raise ValueError("K-mer larger than smallest valid sequence")
        return _pipelined_minima(
            streams, kmers, nbins, self.devices,
            lambda group, dev: self._dispatch(group, kmers, level, nbins,
                                              dev),
            self._collect)

    @staticmethod
    def _collect(out, start, end, minima, reach):
        if not reach.numpy().all():
            raise ValueError("K-mer larger than smallest valid sequence")
        minima = minima.numpy().view(np.uint64)
        for ki, kk in enumerate(out):
            out[kk][start:end] = minima[ki]

    def sketch_aa_streams(self, streams, names, kmers, sketch_size: int,
                          level: int, rc: bool):
        _s64, nbins, _u = num_bins_fn(sketch_size)
        for s, name in zip(streams, names):
            if s.seq_len == 0:
                raise ValueError(f"{name} has no valid sequence")
        bins = self.bin_minima_multi_k(streams, kmers, level, nbins)
        out = []
        for i, (stream, name) in enumerate(zip(streams, names)):
            usigs_parts = []
            densified_any = False
            for kk in kmers:
                binned = bins[kk][i].copy()
                densified_any |= densify(binned)
                usigs_parts.append(fill_usigs(binned))
            out.append(
                Sketch(
                    name=name,
                    rc=rc,
                    reads=False,
                    seq_length=stream.seq_len,
                    densified=densified_any,
                    acgt=(0, 0, 0, 0),
                    non_acgt=stream.invalid_count,
                    usigs=np.concatenate(usigs_parts),
                )
            )
        return out
