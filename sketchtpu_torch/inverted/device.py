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

import functools

import numpy as np
import torch

from .. import _build, spans
from ..dist.sign_words import (
    any_mask_ref,
    check_signs,
    pack_signs,
    signeq_ref,
)

_QUERY_GROUPS = (1, 2, 4, 8, 16)  # queries a signeq.cu count / any / all block
_SMEM_MAX = 227 * 1024  # a block's shared memory past the 48 KB opt-in
_MAX_WORDS = 32768  # sign words of one launch; past it the words split
_PAIR_TILE = 128  # rows and columns of a pair_count tile
_MODES = {"count": 0, "any": 1, "all": 2}
_OUT_ELEMS = 1 << 26  # entries of one (queries, n) result on the card


def row_tile(qr: int) -> int:
    """Index rows of a count / any / all tile: one a thread of 256, four
    at 16 queries a block (csrc/signeq.cu rows_a_thread)."""
    return 256 * (4 if qr >= 16 else 1)


def query_group(nq: int, words: int) -> int:
    """Queries a block of the count / any / all kernel holds: the least of
    _QUERY_GROUPS that covers nq (16 past it), halved while they do not
    fit beside the ring."""
    qr = next(g for g in _QUERY_GROUPS if g >= min(nq, _QUERY_GROUPS[-1]))
    qp = -(-words // 4) * 4
    # the queries beside the least ring: two stages of 4 words a row
    while qr > 1 and (qr * qp + 2 * row_tile(qr) * 4) * 4 > _SMEM_MAX:
        qr //= 2
    return qr


def signeq_shape(nq: int, n: int, words: int, slots: int,
                 qr: int | None = None) -> tuple[int, int, int]:
    """(qr, query groups, row blocks) of a launch: the groups' blocks share
    the card's `slots` resident blocks, each group's rows split in equal
    ranges of at least one row tile."""
    qr = query_group(nq, words) if qr is None else qr
    groups = -(-nq // qr)
    row_blocks = max(1, min(slots // groups, -(-n // row_tile(qr)), 65535))
    return qr, groups, row_blocks


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
    nq, n, words = q.shape[0], m.shape[0], q.shape[1]
    dtype = torch.int32 if mode == "count" else torch.uint8
    out = torch.empty((nq, n), dtype=dtype, device=q.device)
    if nq and n:
        # past _MAX_WORDS the queries would not fit a block: the kernel runs
        # on column slices, their counts summed, any ORed, all ANDed
        for w0 in range(0, words, _MAX_WORDS):
            w1 = min(words, w0 + _MAX_WORDS)
            part = out if w0 == 0 else torch.empty_like(out)
            _signeq_launch(q[:, w0:w1], m[:, w0:w1],
                           min(nsigns, 2 * w1) - 2 * w0, mode, part)
            if w0 and mode == "count":
                out += part
            elif w0 and mode == "any":
                out |= part
            elif w0:
                out &= part
    return out if mode == "count" else out.view(torch.bool)


def _signeq_launch(q, m, nsigns, mode, out):
    """One count / any / all launch into out."""
    nq, n, words = q.shape[0], m.shape[0], q.shape[1]
    qr = query_group(nq, words)
    slots = _slots(_MODES[mode], qr, words, q.device)
    qr, _, row_blocks = signeq_shape(nq, n, words, slots, qr)
    _build.launch(
        q.device, "stpu_signeq",
        q.data_ptr(), q.stride(0), nq, m.data_ptr(), m.stride(0), n, words,
        nsigns, _MODES[mode], int(qr), int(row_blocks), out.data_ptr(),
        what="signeq")
    signeq.launches += 1
    signeq.mode_launches[mode] += 1


@functools.lru_cache(maxsize=64)
def _slots(mode: int, qr: int, words: int, device: torch.device) -> int:
    """Resident count / any / all blocks on the card."""
    per_sm = _build.query(device, "stpu_signeq_blocks_per_sm", mode, qr,
                          words)
    if per_sm < 1:
        raise RuntimeError(f"signeq: {qr} queries of {words} words do not "
                           f"fit an SM")
    return per_sm * torch.cuda.get_device_properties(
        device).multi_processor_count


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
        per_sm = _build.query(m.device, "stpu_pair_count_blocks_per_sm",
                              m.shape[1])
        if per_sm < 1:
            raise RuntimeError("pair_count: the kernel does not fit an SM")
        slots = per_sm * torch.cuda.get_device_properties(
            m.device).multi_processor_count
        splits = default_pair_splits(row_tiles,
                                     -(-(n - lo) // _PAIR_TILE), slots)
    total = torch.zeros(1, dtype=torch.int64, device=m.device)
    _build.launch(
        m.device, "stpu_pair_count",
        m.data_ptr(), m.stride(0), n, m.shape[1], nsigns, lo, hi, int(splits),
        total.data_ptr(), what="pair_count")
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

    @spans.spanned("scan", (pair_count,))
    def any_shared_bin_count(self, row_range: slice | None = None) -> int:
        """Pairs (i < j) sharing >= 1 bin, with i restricted to row_range
        when given (each pair counts at its smaller index, so partials over
        a partition of the rows sum to the total)."""
        lo, hi = (row_range.start, row_range.stop) if row_range else (0, self.n)
        return pair_count(self._m, self.nsigns, lo, hi)

    def scan(self, queries: np.ndarray, mode: str,
             cols: slice | None = None) -> np.ndarray:
        """signeq of the (nq, S) u16 query signs against the index rows
        `cols` (all by default): (nq, len(cols)) int32 counts or bool
        masks."""
        m = self._m if cols is None else self._m[cols]
        q = pack_signs(queries, self.device)
        step = max(1, _OUT_ELEMS // max(1, m.shape[0]))
        parts = [signeq(q[r0 : r0 + step], m, self.nsigns, mode).cpu()
                 for r0 in range(0, q.shape[0], step)]
        if not parts:
            dtype = torch.int32 if mode == "count" else torch.bool
            return torch.empty((0, m.shape[0]), dtype=dtype).numpy()
        return torch.cat(parts).numpy()

    def match_counts(self, queries: np.ndarray) -> np.ndarray:
        """(nq, S) u16 query signs -> (nq, n) int64 shared-bin counts."""
        return self.scan(queries, "count").astype(np.int64)

    def any_shared_rows(self, queries: np.ndarray) -> np.ndarray:
        """(nq, S) u16 query signs -> (nq, n) bool any-shared-bin mask."""
        return self.scan(queries, "any")

    def all_shared_rows(self, queries: np.ndarray) -> np.ndarray:
        """(nq, S) u16 query signs -> (nq, n) bool all-bins-shared mask
        (inverted.rs:243-256); only real rows are compared, so a pad row
        never counts as an all-match."""
        return self.scan(queries, "all")
