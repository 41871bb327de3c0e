"""ntHash + sign + per-(k, genome, bin) minimum: the CUDA kernel
csrc/nthash_bin.cu (one rolling-hash launch for up to 128 k of a batch)
and its plain PyTorch twin; and the kernel's signs mode, the in-order sign
of every window for the reads path.

Replaces sketchtpu/hash/nthash_jax.py::hash_bin_kernel together with its
TPU workarounds (2-bit packing, sort-based bin minima): the card has a
64-bit atomicMin; and nthash_jax.hash_signs_kernel (nthash_signs).

Input layout (pack_group): one byte per base of a batch of concatenated
genomes, code | break << 2, where a break at p forbids windows with
s < p < s+k and every genome start carries one; `starts` holds each
genome's offset. Output: (k, genomes, nbins) int64 holding u64 sign bit
patterns, with empty bins at u64::MAX (-1).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from ..constants import (
    NT_HASH_SEEDS,
    NT_RC_HASH_SEEDS,
    SIGN_MOD,
    nt_tap_tables,
    srol,
)

# The kernel's limits: its per-k words and the block's span of bases (256
# runs + the largest k) share 48 KB of shared memory. The rolling hash
# needs no (k, 4) tap table, so k is bounded by the span alone.
MAX_K_CUDA = 16384
MAX_NK_CUDA = 128
_NT = 256  # threads per block of nthash_bin.cu
_KWORDS = 10  # table words per k
_RUN_LG = 6  # log2 of the window starts per thread
_SIGNS_RUN_LG = 4  # the same in the signs kernel (nthash_signs_kernel)
_SIGNS_ROUND = 16  # signs of a run staged at a time, per thread
_SMEM_MAX = 227 * 1024  # a block's shared memory past the 48 KB opt-in
_SMEM_LIMIT = 48 * 1024
_I64_MAX = (1 << 63) - 1
_SIGN_FLIP = -(1 << 63)  # xor with it turns unsigned order into signed order


def bin_size(nbins: int) -> int:
    return (SIGN_MOD + nbins - 1) // nbins


def tap_tables(k: int) -> tuple[np.ndarray, np.ndarray]:
    """(fwd, rev) (k, 4) int64 per-tap tables (u64 bit patterns)."""
    fwd, rev = nt_tap_tables(k)
    return fwd.view(np.int64), rev.view(np.int64)


def pack_group(streams) -> tuple[np.ndarray, np.ndarray]:
    """(seq, starts): the kernel's uint8 input for a batch of DnaStreams
    and the int64 genome start offsets."""
    lens = [s.seq_len for s in streams]
    seq = np.empty(sum(lens), dtype=np.uint8)
    starts = np.zeros(len(streams), dtype=np.int64)
    pos = 0
    for g, (s, n) in enumerate(zip(streams, lens)):
        starts[g] = pos
        seq[pos : pos + n] = s.codes
        br = s.breaks[(s.breaks > 0) & (s.breaks < n)]
        seq[pos + br] |= 4
        if n:
            seq[pos] |= 4  # windows never roll across a genome boundary
        pos += n
    return seq, starts


def nthash_bin_ref(seq: torch.Tensor, k: int, tf: torch.Tensor,
                   tr: torch.Tensor, rc: bool, starts: torch.Tensor,
                   nbins: int) -> torch.Tensor:
    """Plain PyTorch twin of nthash_bin() on int64 u64 bit patterns."""
    total = seq.numel()
    table = torch.full((starts.numel() * nbins,), _I64_MAX, dtype=torch.int64,
                       device=seq.device)
    m = total - k + 1
    if m > 0:
        v = seq.to(torch.int64)
        codes = v & 3
        fh = torch.zeros(m, dtype=torch.int64, device=seq.device)
        rh = torch.zeros_like(fh)
        for j in range(k):
            cj = codes[j : j + m]
            fh ^= tf[j][cj]
            if rc:
                rh ^= tr[j][cj]
        h = torch.where((rh ^ _SIGN_FLIP) < (fh ^ _SIGN_FLIP), rh, fh) if rc else fh
        x = (h & SIGN_MOD) + ((h >> 61) & 7)
        x = torch.where(x >= SIGN_MOD, x - SIGN_MOD, x)
        csum = torch.cumsum((v >> 2) & 1, 0)
        ok = (csum[k - 1 : k - 1 + m] - csum[:m]) == 0
        pos = torch.arange(m, dtype=torch.int64, device=seq.device)
        genome = torch.searchsorted(starts, pos, right=True) - 1
        idx = genome * nbins + torch.div(x, bin_size(nbins), rounding_mode="floor")
        table.scatter_reduce_(0, idx[ok], x[ok], reduce="amin")
    table[table == _I64_MAX] = -1
    return table.view(starts.numel(), nbins)


def _window_signs(seq: torch.Tensor, k: int, rc: bool):
    """(signs, ok) of the twin over the m = total - k + 1 windows of seq:
    int64 signs and whether each window is clear of break flags."""
    m = seq.numel() - k + 1
    tf, tr = (torch.from_numpy(t).to(seq.device) for t in tap_tables(k))
    v = seq.to(torch.int64)
    codes = v & 3
    fh = torch.zeros(m, dtype=torch.int64, device=seq.device)
    rh = torch.zeros_like(fh)
    for j in range(k):
        cj = codes[j : j + m]
        fh ^= tf[j][cj]
        if rc:
            rh ^= tr[j][cj]
    h = torch.where((rh ^ _SIGN_FLIP) < (fh ^ _SIGN_FLIP), rh, fh) if rc else fh
    x = (h & SIGN_MOD) + ((h >> 61) & 7)
    x = torch.where(x >= SIGN_MOD, x - SIGN_MOD, x)
    csum = torch.cumsum((v >> 2) & 1, 0)
    ok = (csum[k - 1 : k - 1 + m] - csum[:m]) == 0
    return x, ok


def nthash_signs_ref(seq: torch.Tensor, kmers, rc: bool,
                     n_out: int) -> torch.Tensor:
    """Plain PyTorch twin of nthash_signs(): per k, the sign of each window
    start below n_out, -1 (u64 max) where the window is not valid."""
    out = torch.full((len(kmers), n_out), -1, dtype=torch.int64,
                     device=seq.device)
    for ki, k in enumerate(kmers):
        m = min(seq.numel() - k + 1, n_out)
        if m > 0:
            x, ok = _window_signs(seq, k, rc)
            out[ki, :m] = torch.where(ok[:m], x[:m], -1)
    return out


def nthash_bin_multi_ref(seq: torch.Tensor, kmers, rc: bool,
                         starts: torch.Tensor, nbins: int) -> torch.Tensor:
    """Plain PyTorch twin of nthash_bin_multi(): the single-k twin per k,
    stacked."""
    planes = []
    for k in kmers:
        tf, tr = (torch.from_numpy(t).to(seq.device) for t in tap_tables(k))
        planes.append(nthash_bin_ref(seq, k, tf, tr, rc, starts, nbins))
    return torch.stack(planes)


def magic_divisor(d: int) -> tuple[int, int]:
    """(magic, shift) with x // d == (x * magic) >> (64 + shift) for every
    0 <= x < 2^61 (proof at stpu_magic_div in csrc/nthash_bin.cu); needs
    d >= 8 so that the shift is not negative."""
    if d < 8:
        raise ValueError(f"divisor {d} is below 8")
    ell = (d - 1).bit_length()
    return -((-1 << (61 + ell)) // d), ell - 3


def magic_div(x: torch.Tensor, d: int) -> torch.Tensor:
    """x // d for int64 x in [0, 2^61): the kernel's multiply-high on CUDA
    tensors (the kernel's own routine, for its tests), floor division on
    CPU tensors."""
    if x.dtype != torch.int64 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError("x must be a contiguous 1-D int64 tensor")
    if x.device.type == "cpu":
        return torch.div(x, d, rounding_mode="floor")
    magic, shift = magic_divisor(d)
    out = torch.empty_like(x)
    _build.launch(x.device, "stpu_magic_div", x.data_ptr(), x.numel(), magic,
                  shift, out.data_ptr(), what="magic_div")
    return out


@functools.lru_cache(maxsize=64)
def _k_table(kmers: tuple[int, ...]) -> np.ndarray:
    """The kernel's table for ascending kmers: per k, srol^k(SEED[0..3]),
    srol^(k-1)(RC[0..3]), k, (k % 33) | (k % 31) << 32; then SEED, RC."""
    words = []
    for k in kmers:
        words += [srol(s, k) for s in NT_HASH_SEEDS]
        words += [srol(s, k - 1) for s in NT_RC_HASH_SEEDS]
        words += [k, (k % 33) | ((k % 31) << 32)]
    words += list(NT_HASH_SEEDS) + list(NT_RC_HASH_SEEDS)
    return np.array(words, dtype=np.uint64).view(np.int64)


def _span_pitch(kmax: int, lg: int = _RUN_LG) -> int:
    """Row pitch of the kernel's transposed span of bases (runs of 2^lg
    starts): at least the 256 runs + the columns the largest window
    reaches past them, in whole words, an odd number of them (consecutive
    rows fall in distinct banks)."""
    words = (_NT + ((kmax - 2) >> lg) + 1 + 3) // 4
    return 4 * (words | 1)


def _smem_bytes(nk: int, kmax: int, nbins: int, smin: bool) -> int:
    return ((nk * _KWORDS + 8) * 8 + (nbins * 8 if smin else 0)
            + (_span_pitch(kmax) << _RUN_LG))


def _signs_smem_bytes(nk: int, kmax: int) -> int:
    """The signs kernel's shared memory: the table, 256 x 16 staged signs
    and the span in runs of 2^_SIGNS_RUN_LG."""
    return ((nk * _KWORDS + 8) * 8 + _NT * _SIGNS_ROUND * 8
            + (_span_pitch(kmax, _SIGNS_RUN_LG) << _SIGNS_RUN_LG))


def signs_blocks(n_out: int) -> int:
    """Blocks of one signs launch over n_out window starts."""
    return -(-n_out // (_NT << _SIGNS_RUN_LG))


def _check_batch(seq: torch.Tensor, starts: torch.Tensor, nbins: int):
    if seq.dtype != torch.uint8 or seq.dim() != 1 or not seq.is_contiguous():
        raise ValueError("seq must be a contiguous 1-D uint8 tensor")
    if (starts.dtype != torch.int64 or starts.dim() != 1 or starts.numel() < 1
            or not starts.is_contiguous() or starts.device != seq.device):
        raise ValueError("starts must be a non-empty contiguous int64 vector")
    if nbins < 1:
        raise ValueError(f"nbins={nbins} must be positive")


def _check_kmers(kmers) -> list[int]:
    kmers = [int(k) for k in kmers]
    if not kmers or min(kmers) < 1:
        raise ValueError(f"kmers={kmers} must be positive and not empty")
    return kmers


def _check_cuda_k(kmers, device):
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if max(kmers) > MAX_K_CUDA:
        raise ValueError(
            f"kmers={kmers}: the kernel's limit is k <= {MAX_K_CUDA}")


def k_groups(kmers) -> list[list[int]]:
    """The launches of a k list: positions of kmers, ascending by k, at
    most MAX_NK_CUDA a launch."""
    order = sorted(range(len(kmers)), key=kmers.__getitem__)
    return [order[i : i + MAX_NK_CUDA]
            for i in range(0, len(order), MAX_NK_CUDA)]


def _in_kmers_order(out: torch.Tensor, groups) -> torch.Tensor:
    """Rows of a result in ascending-k order, put back in kmers order."""
    order = [p for g in groups for p in g]
    if order == sorted(order):
        return out
    back = torch.empty(len(order), dtype=torch.int64)
    back[torch.tensor(order)] = torch.arange(len(order))
    return out[back.to(out.device)]


def nthash_bin_multi(seq: torch.Tensor, kmers, rc: bool, starts: torch.Tensor,
                     nbins: int) -> torch.Tensor:
    """(len(kmers), genomes, nbins) int64 per-bin sign minima of a packed
    batch at every k of kmers: one launch per MAX_NK_CUDA k (k_groups),
    all writing into one output. CUDA tensors launch the kernel, CPU
    tensors run the twin."""
    _check_batch(seq, starts, nbins)
    kmers = _check_kmers(kmers)
    if seq.device.type == "cpu":
        return nthash_bin_multi_ref(seq, kmers, rc, starts, nbins)
    _check_cuda_k(kmers, seq.device)
    groups = k_groups(kmers)
    out = torch.full((len(kmers), starts.numel(), nbins), -1,
                     dtype=torch.int64, device=seq.device)
    g0 = 0
    for g in groups:
        ks = [kmers[p] for p in g]
        if seq.numel() >= ks[0]:  # else no window fits: the rows stay empty
            _launch_nthash_multi(seq, ks, rc, starts, nbins,
                                 out[g0 : g0 + len(g)])
            nthash_bin_multi.launches += 1
        g0 += len(g)
    return _in_kmers_order(out, groups)


nthash_bin_multi.launches = 0


def _launch_nthash_multi(seq, ks, rc, starts, nbins, out):
    """One launch for at most MAX_NK_CUDA ascending ks into the rows out
    (len(ks), genomes, nbins), filled with -1."""
    # a block first reduces its minima in a shared-memory table where that
    # fits the 48 KB beside the span; else they go to device memory directly
    smin = _smem_bytes(len(ks), ks[-1], nbins, True) <= _SMEM_LIMIT
    ktab = torch.from_numpy(_k_table(tuple(ks))).to(seq.device)
    magic, mshift = magic_divisor(bin_size(nbins))
    _build.launch(
        seq.device, "stpu_nthash_multi",
        seq.data_ptr(), seq.numel(), ktab.data_ptr(), len(ks), ks[0],
        int(rc), starts.data_ptr(), starts.numel(), magic, mshift, nbins,
        _span_pitch(ks[-1]), int(smin),
        _smem_bytes(len(ks), ks[-1], nbins, smin), out.data_ptr(),
        what="nthash_bin_multi",
    )


def nthash_signs(seq: torch.Tensor, kmers, rc: bool,
                 n_out: int | None = None) -> torch.Tensor:
    """(len(kmers), n_out) int64: for every k and window start s < n_out
    of the packed stream seq (pack_group's bytes of one stream, or of a
    chunk of one with the k - 1 bases past its last start), the window's
    sign (u64 bits), or -1 (u64 max) where the window crosses a break or
    runs past seq. n_out defaults to the window starts of the smallest k.
    One launch per MAX_NK_CUDA k on CUDA tensors; CPU tensors run the
    twin."""
    if seq.dtype != torch.uint8 or seq.dim() != 1 or not seq.is_contiguous():
        raise ValueError("seq must be a contiguous 1-D uint8 tensor")
    kmers = _check_kmers(kmers)
    if n_out is None:
        n_out = max(0, seq.numel() - min(kmers) + 1)
    if seq.device.type == "cpu":
        return nthash_signs_ref(seq, kmers, rc, n_out)
    _check_cuda_k(kmers, seq.device)
    out = torch.empty((len(kmers), n_out), dtype=torch.int64,
                      device=seq.device)
    if n_out == 0:
        return out
    if seq.numel() == 0:
        return out.fill_(-1)
    groups = k_groups(kmers)
    g0 = 0
    for g in groups:
        _launch_nthash_signs(seq, [kmers[p] for p in g], rc, n_out,
                             out[g0 : g0 + len(g)])
        nthash_signs.launches += 1
        g0 += len(g)
    return _in_kmers_order(out, groups)


def _launch_nthash_signs(seq, ks, rc, n_out, out):
    """One signs-mode launch for at most MAX_NK_CUDA ascending ks into the
    rows out (len(ks), n_out)."""
    ktab = torch.from_numpy(_k_table(tuple(ks))).to(seq.device)
    _build.launch(
        seq.device, "stpu_nthash_signs",
        seq.data_ptr(), seq.numel(), ktab.data_ptr(), len(ks), int(rc),
        _SIGNS_RUN_LG, _span_pitch(ks[-1], _SIGNS_RUN_LG),
        _signs_smem_bytes(len(ks), ks[-1]), n_out, out.data_ptr(),
        what="nthash_signs")


nthash_signs.launches = 0


def nthash_bin(seq: torch.Tensor, k: int, tf: torch.Tensor, tr: torch.Tensor,
               rc: bool, starts: torch.Tensor, nbins: int) -> torch.Tensor:
    """(genomes, nbins) int64 per-bin sign minima at one k of a packed
    batch: the multi-k kernel with one k on CUDA tensors, the twin on the
    (k, 4) tap tables tf / tr (tap_tables) on CPU tensors. Launches count
    on nthash_bin_multi."""
    _check_batch(seq, starts, nbins)
    for name, t in (("tf", tf), ("tr", tr)):
        if (t.dtype != torch.int64 or tuple(t.shape) != (k, 4)
                or not t.is_contiguous() or t.device != seq.device):
            raise ValueError(f"{name} must be a contiguous int64 ({k}, 4) table")
    if k < 1:
        raise ValueError(f"k={k} must be positive")
    if seq.device.type == "cpu":
        return nthash_bin_ref(seq, k, tf, tr, rc, starts, nbins)
    return nthash_bin_multi(seq, [k], rc, starts, nbins)[0]
