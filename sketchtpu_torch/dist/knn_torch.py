"""Sparse kNN on the card (`dist --knn`): DeviceKnnEngine.

Port of sketchtpu/dist/knn_jax.py::DeviceKnnEngine (self_knn, cross_knn,
self_knn_coreacc, cross_knn_coreacc) with its PreclusterKnnMixin
(precluster_knn: the inverted index's candidates, the sign mask inside K3
and K2). The database's sketch words live on the card once, as (n, nk, W).
Only (rows, knn) results leave the card.

Selection matches the host path (dist/api.py): a key holds its column,
so keys are unique and the selection orders value descending, then column
ascending, whatever order the keys were found in.
- Single-k: K3 in selection mode (knn_kernels.knn_select) walks the whole
  column plane and keeps each row's knn best keys inside the kernel (at
  most MAX_KNN = 1024 on the card; past it, K3's tile mode and the
  torch.topk merge, _select_tiles, give the same selection). Keys
  are samebits, which order distances exactly; printed values are the
  host's f64 chain on the selected samebits. With completeness the keys
  are the corrected f32 Jaccard, and the selected pairs' samebits are
  gathered exactly.
- Core/accessory: each block of rows walks the column tiles; K2 in key
  mode (coreacc_kernels.coreacc_keys) gives the (-core, column) keys and
  the f32 acc of a tile, which merge with the running per-row selection by
  torch.topk, the lax.top_k of the JAX scans. f32 near-ties may select
  other pairs than the f64 chain, but every printed value is the f64
  chain's for the selected pair (exact_ca_values).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import spans
from ..constants import BBITS
from .coreacc_kernels import KEY_INVALID, coreacc, coreacc_keys
from .coreacc_torch import _f32
from .jaccard_np import ani_pois, core_acc_from_jaccards, jaccard_from_samebits
from .sign_words import pack_signs
from .knn_kernels import (COLMASK64, INVALID, MAX_KNN, Completeness, SignMask,
                          key_layout, knn_keys, knn_select)
from .samebits_kernels import popcount64, to_device_words

_NEG = -0x7FFFFFFF  # samebits of a missing candidate
_NO_COL = 0x7FFFFFFF  # column of a missing candidate
_PAIR_CHUNK = 1 << 16  # selected pairs per gather of their words
# the kernels whose launches a scan span counts: K3 (selection and tile
# keys), K2 (key tiles count in coreacc.launches)
_K3 = (knn_select, knn_keys)
_K2 = (coreacc,)


class SparseKnnRows:
    """Array-backed sparse kNN result from the device engine.

    Iterating yields per-row item lists, identical to the host path's
    output, while dist/output.write_sparse consumes the arrays directly via
    as_arrays(). vals is (n, knn) f32 for Jaccard/ANI or (n, knn, 2) f32
    for core/acc; valid is an optional (n, knn) bool emission mask (invalid
    trailing entries are truncated from the per-row lists, as the host path
    does)."""

    def __init__(self, idx: np.ndarray, vals: np.ndarray,
                 valid: np.ndarray | None):
        self.idx = idx
        self.vals = vals
        self.valid = valid

    def as_arrays(self):
        return self.idx, self.vals, self.valid

    def __len__(self):
        return self.idx.shape[0]

    def _row(self, r: int) -> list:
        knn = self.idx.shape[1]
        cols = range(knn)
        if self.valid is not None:
            cols = [c for c in cols if self.valid[r, c]]
        if self.vals.ndim == 3:
            return [
                (int(self.idx[r, c]), np.float32(self.vals[r, c, 0]),
                 np.float32(self.vals[r, c, 1]))
                for c in cols
            ]
        return [(int(self.idx[r, c]), np.float32(self.vals[r, c])) for c in cols]

    def __getitem__(self, r: int) -> list:
        return self._row(r)

    def __iter__(self):
        for r in range(len(self)):
            yield self._row(r)


def _no_rows(knn: int, n_values: int, n_rows: int = 0) -> SparseKnnRows:
    """A result with no entry, for n_values values per entry: an empty row
    slice (a rank with no rows), or n_rows rows of no neighbour (knn < 1,
    as the host oracle gives). No launch is made for it."""
    knn = max(0, knn)
    vals = np.zeros((n_rows, knn) if n_values == 1
                    else (n_rows, knn, n_values), dtype=np.float32)
    return SparseKnnRows(np.zeros((n_rows, knn), dtype=np.int32), vals,
                         np.zeros((n_rows, knn), dtype=bool))


def _no_neighbours(lo: int, hi: int, dist_type,
                   retain_unmatched) -> SparseKnnRows:
    """precluster_knn's rows [lo, hi) at knn < 1: no row has a neighbour,
    so a singleton row holds only (row, 0.0), or (row, 0.0, 0.0) for
    core/accessory, as the host oracle gives."""
    if retain_unmatched != "singleton":
        return _no_rows(0, 2 if dist_type.coreacc else 1, max(0, hi - lo))
    shape = (hi - lo, 1, 2) if dist_type.coreacc else (hi - lo, 1)
    return SparseKnnRows(np.arange(lo, hi, dtype=np.int32)[:, None],
                         np.zeros(shape, np.float32), None)


def _rows_of(rows: slice | None, n: int) -> slice:
    """rows, or all n rows, as a slice with start and stop."""
    return slice(0, n) if rows is None else slice(rows.start, rows.stop)


def precluster_signs(ms, inverted, skq_bins: np.ndarray) -> np.ndarray:
    """The (n, S) u16 signs of the flat .skq sign stream skq_bins (.ski
    order) in the .skd order of ms."""
    from .api import ski_skd_maps

    ski_of_skd = np.asarray(ski_skd_maps(ms, inverted)[0])
    return skq_bins.reshape(-1, inverted.sketch_size)[ski_of_skd]


@spans.spanned("values")
def rows_from_samebits(sb: np.ndarray, idx: np.ndarray, dist_type, s64: int,
                       c1_rows: np.ndarray | None = None,
                       c2_all: np.ndarray | None = None,
                       cutoff: float = 0.64) -> SparseKnnRows:
    """Exact f64 host post-processing of selected samebits -> sparse rows,
    with the host path's values (api.self_dists_knn): 1 - J as f32, or
    for ANI the similarity 1 - f32(1 - ANI). Entries with sb == _NEG are
    missing candidates and are truncated. c1_rows (na,) / c2_all (n,)
    apply the completeness correction (c2 gathered by the selected
    columns)."""
    na, knn = sb.shape
    spans.count("pairs", sb.size)
    if c1_rows is not None:
        c1 = np.repeat(np.asarray(c1_rows, dtype=np.float64), knn)
        c2 = np.asarray(c2_all, dtype=np.float64)[
            np.clip(idx, 0, len(c2_all) - 1).ravel()
        ]
        j = jaccard_from_samebits(sb.ravel(), s64, c1, c2, cutoff)
    else:
        j = jaccard_from_samebits(sb.ravel(), s64)
    j = j.reshape(na, knn)
    if dist_type.ani:
        d = np.float32(1.0) - (1.0 - ani_pois(j, dist_type.k)).astype(np.float32)
    else:
        d = (1.0 - j).astype(np.float32)
    return SparseKnnRows(idx, d, sb != _NEG)


def pair_samebits(a_words: torch.Tensor, b_words: torch.Tensor,
                  a_idx: torch.Tensor, b_idx: torch.Tensor) -> torch.Tensor:
    """Exact samebits of the pairs (a_words[a_idx[m]], b_words[b_idx[m]])
    at every k: a_words (na, nk, W), b_words (nb, nk, W) int64 sketch
    words, a_idx / b_idx (m,) int64 on their device -> (m, nk) int32.
    Port of knn_jax._gather_pair_samebits (an XLA program, not a kernel)
    as PyTorch ops, in chunks of _PAIR_CHUNK pairs."""
    m, nk, w = a_idx.numel(), a_words.shape[1], a_words.shape[2]
    s64 = w // BBITS
    out = torch.empty((m, nk), dtype=torch.int32, device=a_words.device)
    for c0 in range(0, m, _PAIR_CHUNK):
        ai, bi = a_idx[c0 : c0 + _PAIR_CHUNK], b_idx[c0 : c0 + _PAIR_CHUNK]
        for ki in range(nk):
            x = ~(a_words[ai, ki] ^ b_words[bi, ki]).view(-1, s64, BBITS)
            acc = x[..., 0].clone()
            for p in range(1, BBITS):
                acc &= x[..., p]
            out[c0 : c0 + ai.numel(), ki] = popcount64(acc).sum(-1).to(torch.int32)
    return out


@spans.spanned("values")
def exact_ca_values(kmers, sketch_size: int, s64: int, idx: np.ndarray,
                    core_f32: np.ndarray, acc_f32: np.ndarray,
                    a_words: torch.Tensor, b_words: torch.Tensor,
                    c1_rows=None, c2_all=None, cutoff: float = 0.64):
    """Replace the f32 core/acc values of the selected pairs with the f64
    chain's (api.self_dists_knn's Jaccard + completeness + regression) on
    their exact per-k samebits (pair_samebits), then re-sort each row by
    (f32 core, column), the host path's order; missing entries
    (idx == _NO_COL) sort last. Result row i is row i of a_words. Returns
    (core, acc, idx)."""
    vr, vc = np.nonzero(idx != _NO_COL)
    spans.count("pairs", vr.size)
    if vr.size:
        dev = a_words.device
        b_idx = idx[vr, vc].astype(np.int64)
        sb = pair_samebits(a_words, b_words, torch.from_numpy(vr).to(dev),
                           torch.from_numpy(b_idx).to(dev)).cpu().numpy()
        c1 = c2 = None
        if c1_rows is not None and c2_all is not None:
            c1 = np.asarray(c1_rows, dtype=np.float64)[vr]
            c2 = np.asarray(c2_all, dtype=np.float64)[b_idx]
        jaccs = np.empty((vr.size, len(kmers)), dtype=np.float64)
        for ki in range(len(kmers)):
            jaccs[:, ki] = jaccard_from_samebits(sb[:, ki], s64, c1, c2, cutoff)
        core_x, acc_x = core_acc_from_jaccards(jaccs, list(kmers), sketch_size)
        core_f32 = core_f32.copy()
        acc_f32 = acc_f32.copy()
        core_f32[vr, vc] = core_x
        acc_f32[vr, vc] = acc_x
    # f32 bit patterns of non-negative floats (and +inf) order as the values
    key = (core_f32.astype(np.float32).view(np.int32).astype(np.int64) << 32) \
        | idx.astype(np.int64)
    order = np.argsort(key, axis=1, kind="stable")
    return (np.take_along_axis(core_f32, order, axis=1),
            np.take_along_axis(acc_f32, order, axis=1),
            np.take_along_axis(idx, order, axis=1))


def _merge(carry: torch.Tensor, keys: torch.Tensor, knn: int):
    """(values, positions) of the knn largest of [carry, keys] per row."""
    return torch.topk(torch.cat([carry, keys], dim=1), knn, dim=1, sorted=True)


def _select_tiles(rows, cols, knn, *, row0, nb_real, exclude_self, comp,
                  sig, row_tile: int = 2048, col_tile: int = 8192):
    """knn_select's keys for any knn: per block of row_tile rows, K3's tile
    keys (knn_keys) of each column tile merged into the running selection
    by torch.topk (_merge). Keys are unique, so the selection is
    knn_select's."""
    s64 = rows.shape[1] // BBITS
    dtype = key_layout(s64, nb_real, comp is not None)[0]
    blocks = [torch.full((0, knn), INVALID, dtype=dtype, device=rows.device)]
    for r0 in range(0, rows.shape[0], row_tile):
        part = rows[r0 : r0 + row_tile]
        c = (Completeness(comp.c1[r0 : r0 + row_tile], comp.c2, comp.cutoff,
                          s64) if comp is not None else None)
        sg = sig.block(r0, r0 + row_tile) if sig is not None else None
        carry = torch.full((part.shape[0], knn), INVALID, dtype=dtype,
                           device=rows.device)
        for c0 in range(0, min(cols.shape[0], nb_real), col_tile):
            keys = knn_keys(part, cols[c0 : c0 + col_tile], row0=row0 + r0,
                            col0=c0, nb_real=nb_real,
                            exclude_self=exclude_self, comp=c, sig=sg)
            carry = _merge(carry, keys, knn).values
        blocks.append(carry)
    return torch.cat(blocks)


def select_keys(rows, cols, knn, *, row0=0, nb_real=None,
                exclude_self=False, comp=None, sig=None):
    """The (na, knn) selection keys: one K3 selection launch up to MAX_KNN
    neighbours on the card, K3's tiles and the top-k merge past it; the
    twin on CPU tensors."""
    nb_real = cols.shape[0] if nb_real is None else nb_real
    if rows.device.type == "cuda" and knn > MAX_KNN:
        return _select_tiles(rows, cols, knn, row0=row0, nb_real=nb_real,
                             exclude_self=exclude_self, comp=comp, sig=sig)
    return knn_select(rows, cols, knn, row0=row0, nb_real=nb_real,
                      exclude_self=exclude_self, comp=comp, sig=sig)


@spans.spanned("scan", _K3)
def knn_scan(rows: torch.Tensor, cols: torch.Tensor, knn: int, *,
             exclude_self: bool, comp_rows=None, comp_cols=None,
             cutoff: float = 0.64, row0: int = 0,
             sig: SignMask | None = None):
    """knn_scan_tensors() as (sb, idx) int32 numpy arrays. The span
    "scan" holds the whole selection: in precluster, all the work of
    finding and scoring the candidates runs inside it."""
    return tuple(t.cpu().numpy() for t in knn_scan_tensors(
        rows, cols, knn, exclude_self=exclude_self, comp_rows=comp_rows,
        comp_cols=comp_cols, cutoff=cutoff, row0=row0, sig=sig))


def knn_scan_tensors(rows: torch.Tensor, cols: torch.Tensor, knn: int, *,
                     exclude_self: bool, comp_rows=None, comp_cols=None,
                     cutoff: float = 0.64, row0: int = 0,
                     sig: SignMask | None = None):
    """Single-k selection: knn columns of the (nb, W) plane `cols` for every
    row of the (na, W) plane `rows`, on their device. Row i and column j
    have the ids row0 + i and j (a self scan passes the same plane twice,
    with exclude_self). comp_rows (na,) / comp_cols (nb,) switch to the
    completeness keys; sig restricts the candidates to the pairs that share
    a sign of the inverted index. select_keys covers all rows: one K3
    selection launch up to MAX_KNN neighbours.

    Returns (sb, idx) int32 (na, knn) tensors on the rows' device: the
    selected pairs' exact samebits and columns, value descending then
    column ascending (the JAX scans' (vals, idxs)); _NEG / _NO_COL where a
    row has fewer than knn candidates."""
    nb, dev = cols.shape[0], rows.device
    comp_on = comp_rows is not None
    s64 = rows.shape[1] // BBITS
    _dtype, shift, colmask = key_layout(s64, nb, comp_on)
    comp = (Completeness(_f32(comp_rows, dev), _f32(comp_cols, dev), cutoff,
                         s64) if comp_on else None)
    keys = select_keys(rows, cols, knn, row0=row0, nb_real=nb,
                       exclude_self=exclude_self, comp=comp, sig=sig)
    bad = keys < 0
    idx = torch.where(bad, _NO_COL, colmask - (keys & colmask)).long()
    if comp_on:
        sb = torch.full(keys.shape, _NEG, dtype=torch.int32, device=dev)
        vr, vc = torch.nonzero(~bad, as_tuple=True)
        sb[vr, vc] = pair_samebits(rows[:, None], cols[:, None], vr,
                                   idx[vr, vc])[:, 0]
    else:
        sb = torch.where(bad, _NEG, keys >> shift)
    return sb.to(torch.int32), idx.to(torch.int32)


def scan_coreacc(rows: torch.Tensor, cols: torch.Tensor, kmers,
                 sketch_size: int, knn: int, exclude_self: bool, c1=None,
                 c2=None, cutoff: float = 0.64, row0: int = 0,
                 sig: SignMask | None = None, row_tile: int = 2048,
                 col_tile: int = 8192):
    """Select knn columns of the (n, nk, W) words `cols` by f32 core
    distance for every row of the (na, nk, W) words `rows` (ids row0 + i;
    c1 (na,) / c2 (n,) f32 completeness on their device; sig: the
    precluster mask): K2's key tiles merged by torch.topk. Returns (core,
    acc, idx) tensors (na, knn): f32 values of the selection, core = inf
    and idx = _NO_COL where a row has fewer than knn candidates."""
    na, n, dev = rows.shape[0], cols.shape[0], rows.device
    key_blocks, acc_blocks = [], []
    for r0 in range(0, na, row_tile):
        r1 = min(r0 + row_tile, na)
        keys = torch.full((r1 - r0, knn), KEY_INVALID, dtype=torch.int64,
                          device=dev)
        accs = torch.zeros((r1 - r0, knn), dtype=torch.float32, device=dev)
        for c0 in range(0, n, col_tile):
            c1_ = min(c0 + col_tile, n)
            tile, acc = coreacc_keys(
                rows[r0:r1], cols[c0:c1_], kmers, sketch_size,
                c1[r0:r1] if c1 is not None else None,
                c2[c0:c1_] if c1 is not None else None, cutoff,
                row0=row0 + r0, col0=c0, nb_real=n,
                exclude_self=exclude_self,
                sig=sig.block(r0, r1) if sig is not None else None,
            )
            keys, pos = _merge(keys, tile, knn)
            accs = torch.gather(torch.cat([accs, acc], dim=1), 1, pos)
        key_blocks.append(keys)
        acc_blocks.append(accs)
    if not key_blocks:
        empty = torch.zeros((0, knn), device=dev)
        return empty, empty.clone(), empty.to(torch.int32)
    keys = torch.cat(key_blocks)
    bad = keys == KEY_INVALID
    hi = (keys >> 32).to(torch.int32)
    neg_core = torch.where(hi < 0, hi ^ 0x7FFFFFFF, hi).view(torch.float32)
    core = torch.where(bad, torch.inf, -neg_core)
    idx = torch.where(bad, _NO_COL, COLMASK64 - (keys & COLMASK64))
    return core, torch.cat(acc_blocks), idx.to(torch.int32)


class DeviceKnnEngine:
    """kNN over a reference sketch database held on the card."""

    def __init__(self, ref_ms, device: torch.device, row_tile: int = 2048,
                 col_tile: int = 8192):
        self.ms = ref_ms
        self.device = torch.device(device)
        self.n = ref_ms.number_samples_loaded()
        self.s64 = ref_ms.sketchsize64
        self.kmers = tuple(ref_ms.kmer_lengths)
        self.row_tile = row_tile
        self.col_tile = col_tile
        self._words = to_device_words(ref_ms, self.device)

    # --- single-k (Jaccard / ANI) ---

    def self_knn(self, knn: int, dist_type, row_range: slice | None = None,
                 completeness_vec=None, completeness_cutoff: float = 0.64):
        """Self kNN (Jaccard or ANI). row_range restricts the rows to
        [lo, hi) (a rank's block); neighbours range over all samples. With
        completeness the card selects by the corrected f32 Jaccard and the
        host recomputes exact values."""
        comp = (np.asarray(completeness_vec, dtype=np.float64)
                if completeness_vec is not None else None)
        lo, hi = (row_range.start, row_range.stop) if row_range else (0, self.n)
        if hi <= lo or knn < 1:
            return _no_rows(knn, 1, max(0, hi - lo))
        c1 = comp[lo:hi] if comp is not None else None
        plane = self._words[:, dist_type.k_idx]
        sb, idx = knn_scan(plane[lo:hi], plane, knn, exclude_self=True,
                           comp_rows=c1, comp_cols=comp,
                           cutoff=completeness_cutoff, row0=lo)
        return rows_from_samebits(sb, idx, dist_type, self.s64, c1_rows=c1,
                                  c2_all=comp, cutoff=completeness_cutoff)

    def cross_knn(self, query_ms, knn: int, dist_type,
                  ref_completeness_vec=None, query_completeness_vec=None,
                  completeness_cutoff: float = 0.64,
                  query_rows: slice | None = None):
        """Cross kNN: rows = queries (those of query_rows, all by default),
        neighbours among refs. Correction applies only when BOTH sides have
        values (jaccard.rs:36-42)."""
        qr = _rows_of(query_rows, query_ms.number_samples_loaded())
        if knn < 1:
            return _no_rows(knn, 1, qr.stop - qr.start)
        q = to_device_words(query_ms, self.device, qr)[:, dist_type.k_idx]
        c1 = c2 = None
        if ref_completeness_vec is not None and query_completeness_vec is not None:
            c1 = np.asarray(query_completeness_vec, dtype=np.float64)[qr]
            c2 = np.asarray(ref_completeness_vec, dtype=np.float64)
        sb, idx = knn_scan(q, self._words[:, dist_type.k_idx], knn,
                           exclude_self=False, comp_rows=c1, comp_cols=c2,
                           cutoff=completeness_cutoff)
        return rows_from_samebits(sb, idx, dist_type, self.s64, c1_rows=c1,
                                  c2_all=c2, cutoff=completeness_cutoff)

    # --- multi-k core/accessory ---

    @spans.spanned("scan", _K2)
    def _scan_coreacc(self, rows: torch.Tensor, knn: int, exclude_self: bool,
                      c1=None, c2=None, cutoff: float = 0.64, row0: int = 0,
                      sig: SignMask | None = None):
        """scan_coreacc() of the (na, nk, W) words `rows` against every
        sample, as numpy arrays. The span "scan" holds the whole
        selection: in precluster, all the work of finding and scoring the
        candidates runs inside it."""
        return tuple(t.cpu().numpy() for t in scan_coreacc(
            rows, self._words, self.kmers, self.ms.sketch_size, knn,
            exclude_self, c1, c2, cutoff, row0, sig, self.row_tile,
            self.col_tile))

    def _coreacc_rows(self, rows: torch.Tensor, knn: int, exclude_self: bool,
                      c1_rows=None, c2_all=None, cutoff: float = 0.64,
                      row0: int = 0, sig: SignMask | None = None):
        """Scan in f32 on the card, then the f64 chain's values with the
        completeness values as given (f64), as the host path has them."""
        c1 = c2 = None
        if c1_rows is not None:
            c1, c2 = _f32(c1_rows, self.device), _f32(c2_all, self.device)
        core, acc, idx = self._scan_coreacc(rows, knn, exclude_self, c1, c2,
                                            cutoff, row0, sig)
        core, acc, idx = exact_ca_values(
            self.kmers, self.ms.sketch_size, self.s64, idx, core, acc, rows,
            self._words, c1_rows, c2_all, cutoff,
        )
        return SparseKnnRows(idx, np.stack([core, acc], axis=-1), idx != _NO_COL)

    def self_knn_coreacc(self, knn: int, row_range: slice | None = None,
                         completeness_vec=None,
                         completeness_cutoff: float = 0.64):
        """Self core/accessory kNN of the rows [lo, hi) of row_range (all
        rows by default) against every sample."""
        comp = (np.asarray(completeness_vec, dtype=np.float64)
                if completeness_vec is not None else None)
        lo, hi = (row_range.start, row_range.stop) if row_range else (0, self.n)
        if hi <= lo:
            return _no_rows(knn, 2)
        return self._coreacc_rows(
            self._words[lo:hi], knn, True,
            comp[lo:hi] if comp is not None else None, comp,
            completeness_cutoff, row0=lo)

    def cross_knn_coreacc(self, query_ms, knn: int, ref_completeness_vec=None,
                          query_completeness_vec=None,
                          completeness_cutoff: float = 0.64,
                          query_rows: slice | None = None):
        """Rows are queries (those of query_rows, all by default). Like the
        reference (jaccard.rs:36-42), the correction applies only when BOTH
        sides have completeness values."""
        qr = _rows_of(query_rows, query_ms.number_samples_loaded())
        c1 = c2 = None
        if ref_completeness_vec is not None and query_completeness_vec is not None:
            c1 = np.asarray(query_completeness_vec, dtype=np.float64)[qr]
            c2 = np.asarray(ref_completeness_vec, dtype=np.float64)
        return self._coreacc_rows(to_device_words(query_ms, self.device, qr),
                                  knn, False, c1, c2, completeness_cutoff)

    # --- precluster (the inverted index's candidates) ---

    def precluster_knn(self, inverted, skq_bins: np.ndarray, knn: int,
                       dist_type, retain_unmatched: str | None = None,
                       row_range: slice | None = None,
                       completeness_vec=None,
                       completeness_cutoff: float = 0.64) -> SparseKnnRows:
        """kNN among the candidates of the inverted index: the pairs whose
        rows share a u16 sign (distances/mod.rs:399-553), as the JAX
        package's PreclusterKnnMixin.precluster_knn. skq_bins is the flat
        u16 sign stream in .ski order; rows follow the .skd order.
        row_range restricts the rows; candidates range over all samples.
        Single-k rows hold knn (column, f32 value) entries, padded with
        (row, 1.0); core/accessory rows (an extension: the reference
        leaves it unimplemented) hold their candidates' (column, core,
        acc). Rows with no candidate follow retain_unmatched.

        Spans: "signs" (the .ski -> .skd reorder and the upload), then
        "scan", "values" and "rows" (the rows with no candidate, counted
        as "unmatched", and their fill)."""
        lo, hi = (row_range.start, row_range.stop) if row_range else (0, self.n)
        if knn < 1:
            return _no_neighbours(lo, hi, dist_type, retain_unmatched)
        with spans.span("signs"):
            sig_all = pack_signs(precluster_signs(self.ms, inverted, skq_bins),
                                 self.device)
        comp = (np.asarray(completeness_vec, dtype=np.float64)
                if completeness_vec is not None else None)
        return self.precluster_rows(sig_all, inverted.sketch_size, knn,
                                    dist_type, retain_unmatched, lo, hi, comp,
                                    completeness_cutoff)

    def precluster_rows(self, sig_all: torch.Tensor, nsigns: int, knn: int,
                        dist_type, retain_unmatched, lo: int, hi: int,
                        comp, completeness_cutoff: float) -> SparseKnnRows:
        """precluster_knn of the rows [lo, hi), knn >= 1, given every
        sample's packed signs on this engine's device (sig_all) and the
        completeness values (f64, or None)."""
        n = self.n
        sig = SignMask(sig_all[lo:hi], sig_all, nsigns)
        if dist_type.coreacc:
            return self._pc_coreacc(sig, knn, lo, hi, retain_unmatched, comp,
                                    completeness_cutoff)
        sb, idx = self._pc_scan(dist_type, lo, hi, sig, knn, comp,
                                completeness_cutoff)

        def values(sb_, idx_, c1):
            return rows_from_samebits(sb_, idx_, dist_type, self.s64,
                                      c1_rows=c1, c2_all=comp,
                                      cutoff=completeness_cutoff)

        res = values(sb, idx, comp[lo:hi] if comp is not None else None)
        with spans.span("rows"):
            idx, vals, valid = res.idx.copy(), res.vals.copy(), res.valid.copy()
            # rows with no candidate (valid entries come first in a row)
            empty = np.flatnonzero(~valid[:, 0])
            spans.count("unmatched", empty.size)
            if empty.size and retain_unmatched == "bruteforce":
                sb2, idx2 = self._pc_scan_subset(dist_type, lo + empty,
                                                 min(knn + 1, n), comp,
                                                 completeness_cutoff)
                # self exclusion by hand: the scan's exclude_self keys on
                # the row id, which a gathered subset does not carry
                for bi, r_loc in enumerate(empty):
                    keep = idx2[bi] != lo + r_loc
                    row = values(sb2[bi][keep][:knn][None, :],
                                 idx2[bi][keep][:knn][None, :],
                                 comp[lo + r_loc : lo + r_loc + 1]
                                 if comp is not None else None)
                    m = int(row.valid[0].sum())
                    idx[r_loc, :m] = row.idx[0, :m]
                    vals[r_loc, :m] = row.vals[0, :m]
                    valid[r_loc, :m] = True
            # singleton and padding entries are raw 0.0 / 1.0 whatever the
            # ANI mode (distance_matrix.rs:377-380; the printer skips (row,
            # 1.0) self entries); indices are global
            own = np.broadcast_to((lo + np.arange(hi - lo))[:, None],
                                  idx.shape)
            if retain_unmatched == "singleton" and empty.size:
                idx[empty, 0] = lo + empty
                vals[empty, 0] = 0.0
                valid[empty, 0] = True
            idx = np.where(valid, idx, own).astype(np.int32)
            vals = np.where(valid, vals, np.float32(1.0)).astype(np.float32)
        return SparseKnnRows(idx, vals, None)

    def _pc_scan(self, dist_type, lo, hi, sig, knn, comp, cutoff):
        """The masked single-k scan of rows [lo, hi) against all columns."""
        plane = self._words[:, dist_type.k_idx]
        return knn_scan(plane[lo:hi], plane, knn, exclude_self=True, row0=lo,
                        comp_rows=comp[lo:hi] if comp is not None else None,
                        comp_cols=comp, cutoff=cutoff, sig=sig)

    def _pc_scan_subset(self, dist_type, rows, knn, comp, cutoff):
        """The unmasked single-k scan of the gathered rows (global ids) with
        no self exclusion (the caller's)."""
        plane = self._words[:, dist_type.k_idx]
        sub = plane[torch.from_numpy(np.asarray(rows, np.int64)).to(
            self.device)]
        return knn_scan(sub, plane, knn, exclude_self=False,
                        comp_rows=comp[rows] if comp is not None else None,
                        comp_cols=comp, cutoff=cutoff)

    def _pc_ca(self, lo, hi, sig, knn, comp, cutoff):
        """The masked core/accessory scan of rows [lo, hi)."""
        return self._coreacc_rows(
            self._words[lo:hi], knn, True,
            comp[lo:hi] if comp is not None else None, comp, cutoff,
            row0=lo, sig=sig)

    def _pc_ca_subset(self, rows, knn, comp, cutoff):
        """The unmasked core/accessory scan of the gathered rows."""
        sub = self._words[torch.from_numpy(np.asarray(rows, np.int64)).to(
            self.device)]
        return self._coreacc_rows(
            sub, knn, False, comp[rows] if comp is not None else None, comp,
            cutoff)

    def _pc_coreacc(self, sig, knn, lo, hi, retain_unmatched, comp, cutoff):
        res = self._pc_ca(lo, hi, sig, knn, comp, cutoff)
        with spans.span("rows"):
            idx, vals = res.idx.copy(), res.vals.copy()
            ok = np.isfinite(vals[:, :, 0]) & (idx != _NO_COL)  # a row's prefix
            empty = np.flatnonzero(~ok.any(axis=1))
            spans.count("unmatched", empty.size)
            if empty.size and retain_unmatched == "bruteforce":
                res2 = self._pc_ca_subset(lo + empty, min(knn + 1, self.n),
                                          comp, cutoff)
                for bi, r_loc in enumerate(empty):
                    # self exclusion by hand, as in the single-k path
                    keep = np.flatnonzero((res2.idx[bi] != lo + r_loc)
                                          & np.isfinite(res2.vals[bi, :, 0])
                                          & (res2.idx[bi] != _NO_COL))[:knn]
                    m = keep.size
                    idx[r_loc, :m] = res2.idx[bi, keep]
                    vals[r_loc, :m] = res2.vals[bi, keep]
                    ok[r_loc, :m] = True
            if retain_unmatched == "singleton" and empty.size:
                idx[empty, 0] = lo + empty
                vals[empty, 0] = 0.0
                ok[empty, 0] = True
        return SparseKnnRows(idx, vals, ok)
