"""In-process multi-device engines: one process uses every GPU it sees.

Port of sketchtpu/shard/mesh.py's ShardedSamebitsEngine,
ShardedCoreAccEngine, ShardedKnnEngine and ShardedInvertedEngine, which
the runtime selects when more than one device is visible. Where the JAX
engines shard rows over a mesh's 'rows' axis and replicate the column
operand (P("rows", ...) / P(None, ...)), each engine here keeps one
single-device engine of the port per device (the column operand whole on
each), gives every device slot a contiguous block of rows, runs the slots
at once (one host thread each, with its device current) and joins the
blocks in row order on the host. Every row sees every column, so nothing
merges across devices, and each result is one device's, bit for bit.

`devices` may name one device more than once: its slots then share that
device's engine and split the rows on one GPU.

The mesh's 'words' axis (samebits partials of a sharded word dimension,
psum-reduced) is not carried: no CLI path reaches it, and the largest
sketch the CLI takes (-s 40000: 35 KB a sample and k) fits every GPU
whole.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..dist.coreacc_torch import (
    DeviceCoreAccEngine,
    _f32,
    stream_blocks,
)
from ..dist.jaccard_torch import DeviceSamebitsEngine
from ..dist.knn_torch import (
    DeviceKnnEngine,
    SparseKnnRows,
    _no_neighbours,
    precluster_signs,
)
from ..dist.output import emit_coreacc_cross_block, emit_coreacc_self_block
from ..dist.samebits_kernels import to_device_words
from ..dist.sign_words import pack_signs
from ..inverted.device import DeviceInvertedEngine
from .distributed import process_slice


def split_rows(lo: int, hi: int, parts: int) -> list[slice]:
    """[lo, hi) as `parts` contiguous blocks in order, the first
    (hi - lo) % parts of them one row longer; empty where the rows are
    fewer than the parts."""
    blocks = []
    for p in range(parts):
        s = process_slice(max(0, hi - lo), p, parts)
        blocks.append(slice(lo + s.start, lo + s.stop))
    return blocks


def split_pairs(lo: int, hi: int, n: int, parts: int) -> list[slice]:
    """[lo, hi) as `parts` contiguous blocks of near-equal upper-triangle
    pair counts (row i pairs with the n - 1 - i columns past it)."""
    cum = np.arange(lo, hi + 1, dtype=np.float64)
    cum = (cum - lo) * n - (cum * (cum + 1) - lo * (lo + 1)) / 2
    cuts = [lo] + [lo + int(np.searchsorted(cum, cum[-1] * p / parts))
                   for p in range(1, parts)] + [hi]
    return [slice(a, max(a, b)) for a, b in zip(cuts, cuts[1:])]


class DeviceSlots:
    """The device slots of an engine: one single-device engine per
    distinct device (made by make(device)), and a thread for each slot
    that runs its work with its device current."""

    def __init__(self, devices, make):
        if devices is None:
            from ..runtime import devices as visible

            devices = visible()
        if not devices:
            raise ValueError("a multi-device engine needs at least one device")
        self.devices = [torch.device(d) for d in devices]
        self._pool = ThreadPoolExecutor(max_workers=len(self.devices),
                                        thread_name_prefix="device-slot")
        # the devices' engines are made (their data uploaded) at once
        distinct = list(dict.fromkeys(self.devices))
        made = [self._pool.submit(_on, d, make, d) for d in distinct]
        self.engines = dict(zip(distinct,
                                [f.result() for f in _wait_all(made)]))

    def __len__(self) -> int:
        return len(self.devices)

    def submit(self, slot: int, fn, *args):
        """A future of fn(engine of the slot, *args), run on the slot's
        thread with its device current."""
        dev = self.devices[slot]
        return self._pool.submit(_on, dev, fn, self.engines[dev], *args)

    def map(self, fn, items) -> list:
        """[fn(engine, item) on slot i for the i-th item], run at once; the
        first failure raises once every slot has stopped."""
        futures = [self.submit(i, fn, item) for i, item in enumerate(items)]
        return [f.result() for f in _wait_all(futures)]


def _on(device: torch.device, fn, *args):
    """fn(*args) with `device` current (a CUDA device; nothing to do for
    the CPU)."""
    if device.type != "cuda":
        return fn(*args)
    with torch.cuda.device(device):
        return fn(*args)


def _wait_all(futures):
    """The futures, once all have finished (a failure does not leave the
    other slots running behind it)."""
    for f in futures:
        f.exception()
    return futures


class _JoinedCopy:
    """The pending copies of one block's row parts (futures of HostCopy):
    numpy() joins them in row order."""

    def __init__(self, futures):
        self._futures = futures

    def numpy(self) -> np.ndarray:
        parts = [f.result().numpy() for f in _wait_all(self._futures)]
        return parts[0] if len(parts) == 1 else np.concatenate(parts)


def _join_rows(parts: list[SparseKnnRows]) -> SparseKnnRows:
    """The row blocks of a kNN result, in order, as one."""
    valid = (None if parts[0].valid is None
             else np.concatenate([p.valid for p in parts]))
    return SparseKnnRows(np.concatenate([p.idx for p in parts]),
                         np.concatenate([p.vals for p in parts]), valid)


class ShardedSamebitsEngine:
    """samebits engine over several devices: the rows of `a` split over
    the slots, `b` whole on each. Drop-in `engine` for dist/api.py."""

    def __init__(self, sketchsize64: int, devices=None):
        self.s64 = sketchsize64
        self.slots = DeviceSlots(
            devices, lambda d: DeviceSamebitsEngine(sketchsize64, d))

    def matrix(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """All-pairs samebits: a (na, W) u64, b (nb, W) u64 -> (na, nb)."""
        blocks = split_rows(0, a.shape[0], len(self.slots))
        return np.concatenate(self.slots.map(
            lambda eng, rows: eng.matrix(a[rows], b), blocks))


class ShardedCoreAccEngine:
    """Dense multi-k core/accessory over several devices: each tile's rows
    (tile rows at a time, as the JAX engine) split over the slots, every
    sample's words on each device; the blocks of a tile are written in
    row order while the next tile runs."""

    def __init__(self, ms, devices=None, tile: int = 4096,
                 completeness_vec=None, completeness_cutoff: float = 0.64):
        self.tile = tile
        self.slots = DeviceSlots(devices, lambda d: DeviceCoreAccEngine(
            ms, d, tile=tile, completeness_vec=completeness_vec,
            completeness_cutoff=completeness_cutoff))

    def _launch(self, r0: int, r1: int, fn) -> _JoinedCopy:
        """fn(engine, a, b) launched on each slot for its block [a, b) of
        the rows [r0, r1)."""
        blocks = split_rows(r0, r1, len(self.slots))
        return _JoinedCopy([self.slots.submit(i, fn, b.start, b.stop)
                            for i, b in enumerate(blocks)])

    def tile_dists(self, rows: slice, cols: slice) -> np.ndarray:
        """(rows, cols, 2) f32 core/accessory, rows split over the
        slots."""
        blocks = split_rows(rows.start, rows.stop, len(self.slots))
        return np.concatenate(self.slots.map(
            lambda eng, r: eng.tile_dists(r, cols), blocks))

    def stream_self_dense(
        self, out, names: list[str], row_range: slice | None = None
    ) -> None:
        """The upper-triangle long-form output (DeviceCoreAccEngine's)."""
        n = len(names)

        def emit(block, r0, r1, tab_r, tab_q, pipe):
            emit_coreacc_self_block(out, names, tab_r, block, r0, r1, n,
                                    pipe=pipe)

        stream_blocks(
            out, names, names, row_range, self.tile,
            lambda r0, r1: self._launch(r0, r1,
                                        DeviceCoreAccEngine.self_block),
            emit)

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
        """Ref-major rectangular output (DeviceCoreAccEngine's): reference
        rows split over the slots, the query words whole on each device.
        Completeness applies only when both sides have values."""
        nq = query_ms.number_samples_loaded()
        comp_on = rcomp is not None and qcomp is not None
        on_device = {}
        for dev in self.slots.engines:
            on_device[dev] = (
                to_device_words(query_ms, dev),
                _f32(rcomp, dev) if comp_on else None,
                _f32(qcomp, dev) if comp_on else None,
            )

        def cross(eng, a, b):
            q, rc_v, qc_v = on_device[eng.device]
            return eng.cross_block(q, a, b, rc_v, qc_v, cutoff)

        def emit(block, r0, r1, tab_r, tab_q, pipe):
            emit_coreacc_cross_block(out, ref_names, query_names, tab_r,
                                     tab_q, block, r0, r1, nq, pipe=pipe)

        stream_blocks(out, ref_names, query_names, row_range, self.tile,
                      lambda r0, r1: self._launch(r0, r1, cross), emit)


class ShardedKnnEngine:
    """Sparse kNN over several devices: the rows (samples, or queries)
    split over the slots, every sample's words on each device; each slot
    runs DeviceKnnEngine on its rows, whose lists join in row order.
    Same self_knn / cross_knn / *_coreacc / precluster_knn interface as
    DeviceKnnEngine (the precluster scan splits its rows too)."""

    def __init__(self, ms, devices=None, row_tile: int = 2048,
                 col_tile: int = 8192):
        self.ms = ms
        self.n = ms.number_samples_loaded()
        self.slots = DeviceSlots(devices, lambda d: DeviceKnnEngine(
            ms, d, row_tile=row_tile, col_tile=col_tile))

    def _rows(self, lo: int, hi: int, fn) -> SparseKnnRows:
        """fn(engine, block) on each slot's block of [lo, hi), joined."""
        return _join_rows(self.slots.map(
            fn, split_rows(lo, hi, len(self.slots))))

    def _span(self, row_range: slice | None, n: int) -> tuple[int, int]:
        return (row_range.start, row_range.stop) if row_range else (0, n)

    def self_knn(self, knn: int, dist_type, row_range: slice | None = None,
                 completeness_vec=None, completeness_cutoff: float = 0.64):
        return self._rows(*self._span(row_range, self.n),
                          lambda eng, rows: eng.self_knn(
                              knn, dist_type, row_range=rows,
                              completeness_vec=completeness_vec,
                              completeness_cutoff=completeness_cutoff))

    def cross_knn(self, query_ms, knn: int, dist_type,
                  ref_completeness_vec=None, query_completeness_vec=None,
                  completeness_cutoff: float = 0.64):
        return self._rows(0, query_ms.number_samples_loaded(),
                          lambda eng, rows: eng.cross_knn(
                              query_ms, knn, dist_type,
                              ref_completeness_vec=ref_completeness_vec,
                              query_completeness_vec=query_completeness_vec,
                              completeness_cutoff=completeness_cutoff,
                              query_rows=rows))

    def self_knn_coreacc(self, knn: int, row_range: slice | None = None,
                         completeness_vec=None,
                         completeness_cutoff: float = 0.64):
        return self._rows(*self._span(row_range, self.n),
                          lambda eng, rows: eng.self_knn_coreacc(
                              knn, row_range=rows,
                              completeness_vec=completeness_vec,
                              completeness_cutoff=completeness_cutoff))

    def cross_knn_coreacc(self, query_ms, knn: int,
                          ref_completeness_vec=None,
                          query_completeness_vec=None,
                          completeness_cutoff: float = 0.64):
        return self._rows(0, query_ms.number_samples_loaded(),
                          lambda eng, rows: eng.cross_knn_coreacc(
                              query_ms, knn,
                              ref_completeness_vec=ref_completeness_vec,
                              query_completeness_vec=query_completeness_vec,
                              completeness_cutoff=completeness_cutoff,
                              query_rows=rows))

    def precluster_knn(self, inverted, skq_bins: np.ndarray, knn: int,
                       dist_type, retain_unmatched: str | None = None,
                       row_range: slice | None = None,
                       completeness_vec=None,
                       completeness_cutoff: float = 0.64) -> SparseKnnRows:
        """DeviceKnnEngine.precluster_knn with the rows split over the
        slots: the signs are gathered once and packed once a device;
        candidates and --retain-unmatched bruteforce rows range over all
        samples on each."""
        lo, hi = self._span(row_range, self.n)
        if knn < 1:
            return _no_neighbours(lo, hi, dist_type, retain_unmatched)
        signs = precluster_signs(self.ms, inverted, skq_bins)
        packed = {dev: pack_signs(signs, dev) for dev in self.slots.engines}
        comp = (np.asarray(completeness_vec, dtype=np.float64)
                if completeness_vec is not None else None)
        return self._rows(lo, hi, lambda eng, rows: eng.precluster_rows(
            packed[eng.device], inverted.sketch_size, knn, dist_type,
            retain_unmatched, rows.start, rows.stop, comp,
            completeness_cutoff))


class ShardedInvertedEngine:
    """Inverted-index queries and the precluster pair count over several
    devices (DeviceInvertedEngine's interface), the packed sign matrix
    whole on each device. The count splits the index rows into blocks of
    near-equal pair counts, one a slot, and sums the exact partials in
    Python ints; a query splits the index rows too, so that each slot
    holds every query in signeq's resident query group, and the column
    blocks join in order."""

    def __init__(self, sign_matrix: np.ndarray, devices=None):
        self.n = int(sign_matrix.shape[0])
        self.slots = DeviceSlots(
            devices, lambda d: DeviceInvertedEngine(sign_matrix, d))

    def any_shared_bin_count(self, row_range: slice | None = None) -> int:
        lo, hi = (row_range.start, row_range.stop) if row_range else (0, self.n)
        return sum(self.slots.map(
            lambda eng, rows: eng.any_shared_bin_count(row_range=rows),
            split_pairs(lo, hi, self.n, len(self.slots))))

    def _query(self, queries: np.ndarray, mode: str) -> np.ndarray:
        return np.concatenate(self.slots.map(
            lambda eng, cols: eng.scan(queries, mode, cols),
            split_rows(0, self.n, len(self.slots))), axis=1)

    def match_counts(self, queries: np.ndarray) -> np.ndarray:
        return self._query(queries, "count").astype(np.int64)

    def any_shared_rows(self, queries: np.ndarray) -> np.ndarray:
        return self._query(queries, "any")

    def all_shared_rows(self, queries: np.ndarray) -> np.ndarray:
        return self._query(queries, "all")
