"""ntHash + sign + per-(genome, bin) minimum: the CUDA kernel
csrc/nthash_bin.cu and its plain PyTorch twin.

Replaces sketchtpu/hash/nthash_jax.py::hash_bin_kernel together with its
TPU workarounds (2-bit packing, magic-multiply division, sort-based bin
minima): the card has u64 division and a 64-bit atomicMin.

Input layout (pack_group): one byte per base of a batch of concatenated
genomes, code | break << 2, where a break at p forbids windows with
s < p < s+k and every genome start carries one; `starts` holds each
genome's offset. Output: (genomes, nbins) int64 holding u64 sign bit
patterns, with empty bins at u64::MAX (-1).
"""

from __future__ import annotations

import numpy as np
import torch

from sketchtpu.constants import SIGN_MOD, nt_tap_tables

from .. import _build

MAX_K_CUDA = 512  # tap tables + sequence span stay within 48 KB of shared memory
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


def nthash_bin(seq: torch.Tensor, k: int, tf: torch.Tensor, tr: torch.Tensor,
               rc: bool, starts: torch.Tensor, nbins: int) -> torch.Tensor:
    """(genomes, nbins) int64 per-bin sign minima at k of a packed batch.
    CUDA tensors launch the kernel, CPU tensors run the twin."""
    if seq.dtype != torch.uint8 or seq.dim() != 1 or not seq.is_contiguous():
        raise ValueError("seq must be a contiguous 1-D uint8 tensor")
    for name, t in (("tf", tf), ("tr", tr)):
        if (t.dtype != torch.int64 or tuple(t.shape) != (k, 4)
                or not t.is_contiguous() or t.device != seq.device):
            raise ValueError(f"{name} must be a contiguous int64 ({k}, 4) table")
    if (starts.dtype != torch.int64 or starts.dim() != 1 or starts.numel() < 1
            or not starts.is_contiguous() or starts.device != seq.device):
        raise ValueError("starts must be a non-empty contiguous int64 vector")
    if k < 1 or nbins < 1:
        raise ValueError(f"k={k} and nbins={nbins} must be positive")
    if seq.device.type == "cpu":
        return nthash_bin_ref(seq, k, tf, tr, rc, starts, nbins)
    if seq.device.type != "cuda":
        raise ValueError(f"unsupported device {seq.device}")
    if k > MAX_K_CUDA:
        raise ValueError(f"k={k} exceeds the kernel's limit of {MAX_K_CUDA}")
    if seq.numel() - k + 1 <= 0:  # no window fits: every bin stays empty
        return torch.full((starts.numel(), nbins), -1, dtype=torch.int64,
                          device=seq.device)
    out = _launch_nthash_bin(seq, k, tf, tr, rc, starts, nbins)
    nthash_bin.launches += 1
    return out


nthash_bin.launches = 0


def _launch_nthash_bin(seq, k, tf, tr, rc, starts, nbins) -> torch.Tensor:
    out = torch.full((starts.numel(), nbins), -1, dtype=torch.int64,
                     device=seq.device)
    err = _build.lib().stpu_nthash_bin(
        seq.data_ptr(), seq.numel(), k, tf.data_ptr(), tr.data_ptr(),
        int(rc), starts.data_ptr(), starts.numel(), bin_size(nbins), nbins,
        out.data_ptr(), _build.stream_handle(seq.device),
    )
    _build.check(err, "nthash_bin")
    return out
