"""Inverted-index queries on the card: the sign-equality kernel
csrc/signeq.cu, its plain PyTorch twins, and DeviceInvertedEngine.

Port of sketchtpu/inverted/device.py, whose XLA programs
(_match_matrix_scan, _match_count_strip, _match_count_schedule) become
one hand kernel with four modes:
- count / any / all: (nq, n) equal-bin counts and any-/all-equal masks of
  query rows against the index (inverted.rs:229-268);
- pair_count: the pairs i < j that share at least one bin with i in a row
  range given as data (`precluster --count`, inverted.rs:271-300), summed
  in 64 bits on the card.

The (n, S) u16 sign matrix lives on the card packed two signs to an int32
word (dist/sign_words.py, the Python side of csrc/signeq.cuh). K3 and K2
read the same packed rows for the precluster mask (dist/knn_kernels.py,
dist/coreacc_kernels.py).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..dist.sign_words import (
    any_mask_ref,
    check_signs,
    pack_signs,
    signeq_ref,
)

_TILE = 64  # rows and columns of a signeq.cu count / any / all tile
_PAIR_TILE = 128  # rows and columns of a pair_count tile
_MODES = {"count": 0, "any": 1, "all": 2}
_OUT_ELEMS = 1 << 26  # entries of one (queries, n) result on the card


def signeq(q: torch.Tensor, m: torch.Tensor, nsigns: int,
           mode: str) -> torch.Tensor:
    """(nq, n) sign equality of the query rows q against the index rows m
    (packed words, pack_signs): mode "count" -> int32 equal-bin counts,
    "any" / "all" -> bool masks. CUDA tensors launch the kernel, CPU
    tensors run the twin."""
    if mode not in _MODES:
        raise ValueError(f"mode={mode!r}: expected one of {list(_MODES)}")
    check_signs("q", q, nsigns)
    check_signs("m", m, nsigns)
    if q.device != m.device:
        raise ValueError("q and m must be on one device")
    if q.device.type == "cpu":
        return signeq_ref(q, m, nsigns, mode)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    nq, n = q.shape[0], m.shape[0]
    dtype = torch.int32 if mode == "count" else torch.uint8
    out = torch.empty((nq, n), dtype=dtype, device=q.device)
    if nq == 0 or n == 0:
        return out if mode == "count" else out.bool()
    if -(-nq // _TILE) > 65535:
        raise ValueError(f"signeq: {nq} queries exceed one launch")
    err = _build.lib().stpu_signeq(
        q.data_ptr(), q.stride(0), nq, m.data_ptr(), m.stride(0), n,
        q.shape[1], nsigns, _MODES[mode], out.data_ptr(),
        _build.stream_handle(q.device))
    _build.check(err, "signeq")
    signeq.launches += 1
    signeq.mode_launches[mode] += 1
    return out if mode == "count" else out.view(torch.bool)


signeq.launches = 0
signeq.mode_launches = dict.fromkeys(_MODES, 0)


def pair_count_ref(m: torch.Tensor, nsigns: int, lo: int, hi: int,
                   tile: int = 512) -> int:
    """Plain PyTorch twin of pair_count(): per strip of `tile` rows, the
    any-equal mask of each column block from the strip's first row on,
    masked to i < j, counted in int64."""
    n = m.shape[0]
    total = torch.zeros((), dtype=torch.int64, device=m.device)
    for r0 in range(lo, min(hi, n), tile):
        r1 = min(r0 + tile, hi, n)
        for c0 in range(r0, n, tile):
            c1 = min(c0 + tile, n)
            eq = any_mask_ref(m[r0:r1], m[c0:c1], nsigns)
            ri = torch.arange(r0, r1, device=m.device)[:, None]
            ci = torch.arange(c0, c1, device=m.device)[None, :]
            total += _strip_count(eq & (ci > ri))
    return int(total)


def _strip_count(keep: torch.Tensor) -> torch.Tensor:
    """The pairs of one twin tile, as an int64 0-dim tensor."""
    return keep.sum(dtype=torch.int64)


def default_pair_splits(row_tiles: int, col_tiles: int, slots: int) -> int:
    """Column shares per row tile: one while the row tiles alone fill the
    card `slots` blocks at a time twice, else enough that they do."""
    want = -(-2 * slots // max(1, row_tiles))
    return max(1, min(want, col_tiles, 65535))


def pair_count(m: torch.Tensor, nsigns: int, lo: int = 0,
               hi: int | None = None, splits: int | None = None) -> int:
    """Pairs i < j < n of the rows of m (packed words) with lo <= i < hi
    that share at least one sign. CUDA tensors launch the kernel (a 64-bit
    total on the card), CPU tensors run the twin."""
    n = m.shape[0]
    hi = n if hi is None else hi
    check_signs("m", m, nsigns)
    if not 0 <= lo <= n or not 0 <= hi <= n:
        raise ValueError(f"row range [{lo}, {hi}) outside [0, {n})")
    if m.device.type == "cpu":
        return pair_count_ref(m, nsigns, lo, hi)
    if m.device.type != "cuda":
        raise ValueError(f"unsupported device {m.device}")
    if hi <= lo:
        return 0
    row_tiles = -(-(hi - lo) // _PAIR_TILE)
    if splits is None:
        per_sm = _build.lib().stpu_pair_count_blocks_per_sm(m.shape[1])
        if per_sm < 1:
            raise RuntimeError("pair_count: the kernel does not fit an SM")
        slots = per_sm * torch.cuda.get_device_properties(
            m.device).multi_processor_count
        splits = default_pair_splits(row_tiles,
                                     -(-(n - lo) // _PAIR_TILE), slots)
    total = torch.zeros(1, dtype=torch.int64, device=m.device)
    err = _build.lib().stpu_pair_count(
        m.data_ptr(), m.stride(0), n, m.shape[1], nsigns, lo, hi, int(splits),
        total.data_ptr(), _build.stream_handle(m.device))
    _build.check(err, "pair_count")
    pair_count.launches += 1
    return int(total.item())


pair_count.launches = 0


class DeviceInvertedEngine:
    """Inverted-index queries over the (n, S) u16 sign matrix held on the
    card (or, on a CPU device, run by the twins)."""

    def __init__(self, sign_matrix: np.ndarray, device: torch.device):
        self.device = torch.device(device)
        self.n, self.nsigns = (int(x) for x in sign_matrix.shape)
        self._m = pack_signs(sign_matrix, self.device)

    def any_shared_bin_count(self, row_range: slice | None = None) -> int:
        """Pairs (i < j) sharing >= 1 bin, with i restricted to row_range
        when given (each pair counts at its smaller index, so partials over
        a partition of the rows sum to the total)."""
        lo, hi = (row_range.start, row_range.stop) if row_range else (0, self.n)
        return pair_count(self._m, self.nsigns, lo, hi)

    def _scan(self, queries: np.ndarray, mode: str) -> np.ndarray:
        q = pack_signs(queries, self.device)
        step = max(1, _OUT_ELEMS // max(1, self.n))
        parts = [signeq(q[r0 : r0 + step], self._m, self.nsigns, mode).cpu()
                 for r0 in range(0, q.shape[0], step)]
        if not parts:
            dtype = torch.int32 if mode == "count" else torch.bool
            return torch.empty((0, self.n), dtype=dtype).numpy()
        return torch.cat(parts).numpy()

    def match_counts(self, queries: np.ndarray) -> np.ndarray:
        """(nq, S) u16 query signs -> (nq, n) int64 shared-bin counts."""
        return self._scan(queries, "count").astype(np.int64)

    def any_shared_rows(self, queries: np.ndarray) -> np.ndarray:
        """(nq, S) u16 query signs -> (nq, n) bool any-shared-bin mask."""
        return self._scan(queries, "any")

    def all_shared_rows(self, queries: np.ndarray) -> np.ndarray:
        """(nq, S) u16 query signs -> (nq, n) bool all-bins-shared mask
        (inverted.rs:243-256); only real rows are compared, so a pad row
        never counts as an all-match."""
        return self._scan(queries, "all")
