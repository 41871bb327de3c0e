"""K1, exact samebits: the CUDA kernel csrc/samebits.cu and its plain
PyTorch twin.

Replaces sketchtpu/dist/pallas_kernels.py::samebits_strip_fused. Sketch
words stay in the .skd order ([row][chunk][plane], u64 bit patterns held
in int64 tensors) with no TPU relayout: the kernel reads rows through
their stride, so a k-plane of a (n, nk, W) database tensor is used in
place.
"""

from __future__ import annotations

import numpy as np
import torch

from sketchtpu.constants import BBITS

from .. import _build

_MAX_GRID_Y = 65535
_TI = 64  # rows per block of samebits.cu
INT16_MAX_BINS = 32767
# twin working set: elements of one broadcast (rows, cols, s64) temporary
_REF_ELEMS = 1 << 24

_M1 = 0x5555555555555555
_M2 = 0x3333333333333333
_M4 = 0x0F0F0F0F0F0F0F0F


def words_to_device(words: np.ndarray, device) -> torch.Tensor:
    """u64 sketch words (any shape) as an int64 tensor on `device` holding
    the same bit patterns."""
    words = np.ascontiguousarray(words, dtype=np.uint64).view(np.int64)
    if not words.flags.writeable:
        words = words.copy()
    return torch.from_numpy(words).to(device)


def to_device_words(ms, device) -> torch.Tensor:
    """A loaded MultiSketch's sketch words as an (n, nk, s64*BBITS) int64
    tensor on `device`, in the .skd word order [sample][k][chunk][plane]."""
    n = ms.number_samples_loaded()
    return words_to_device(
        ms.sketch_bins.reshape(n, len(ms.kmer_lengths), ms.kmer_stride), device
    )


def popcount64(x: torch.Tensor) -> torch.Tensor:
    """Bits set in each int64 (as u64), by SWAR: CPU torch has no popcount
    and no unsigned shift, so each arithmetic >> is masked before its bits
    can reach a field that is kept."""
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    x = x + (x >> 8)
    x = x + (x >> 16)
    x = x + (x >> 32)
    return x & 0x7F


def _tri_mask_(out: torch.Tensor, row0: int) -> torch.Tensor:
    rows = row0 + torch.arange(out.shape[0], device=out.device)[:, None]
    cols = torch.arange(out.shape[1], device=out.device)[None, :]
    return out.masked_fill_(cols <= rows, 0)


def samebits_ref(a: torch.Tensor, b: torch.Tensor, *, out_dtype=torch.int32,
                 tri: bool = False, row0: int = 0) -> torch.Tensor:
    """Plain PyTorch twin of samebits(): the same counts on any device.
    With tri, pairs with column <= row0 + row are zero."""
    na, w = a.shape
    nb = b.shape[0]
    s64 = w // BBITS
    ar = a.reshape(na, 1, s64, BBITS)
    out = torch.empty((na, nb), dtype=torch.int32, device=a.device)
    step = max(1, _REF_ELEMS // max(1, na * s64))
    for j0 in range(0, nb, step):
        br = b[j0 : j0 + step].reshape(1, -1, s64, BBITS)
        acc = torch.full(
            (na, br.shape[1], s64), -1, dtype=torch.int64, device=a.device
        )
        for p in range(BBITS):
            acc &= ~(ar[..., p] ^ br[..., p])
        out[:, j0 : j0 + step] = popcount64(acc).sum(-1)
    if tri:
        _tri_mask_(out, row0)
    return out.to(out_dtype)


def _check_words(name: str, t: torch.Tensor, ndim: int) -> None:
    if t.dtype != torch.int64:
        raise TypeError(f"{name}: sketch words must be int64, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if t.shape[-1] % BBITS or t.shape[-1] == 0:
        raise ValueError(
            f"{name}: last dim {t.shape[-1]} is not a multiple of {BBITS}"
        )
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: rows must be contiguous (stride(-1) == 1)")


def samebits(a: torch.Tensor, b: torch.Tensor, *, out_dtype=torch.int32,
             tri: bool = False, row0: int = 0) -> torch.Tensor:
    """(na, nb) samebits of the sketch-word rows a (na, W) and b (nb, W).

    out_dtype int16 writes the dense-stream strips (exact up to 32767
    bins), int32 the all-pairs matrix. tri (rows globally at row0 + i)
    computes only what pairs with column > row need; other entries are
    zero. CUDA tensors launch the kernel, CPU tensors run the twin."""
    _check_words("a", a, 2)
    _check_words("b", b, 2)
    if a.shape[1] != b.shape[1] or a.device != b.device:
        raise ValueError("a and b need the same width and device")
    if out_dtype not in (torch.int16, torch.int32):
        raise TypeError(f"out_dtype must be int16 or int32, got {out_dtype}")
    if out_dtype == torch.int16 and a.shape[1] // BBITS * 64 > INT16_MAX_BINS:
        raise ValueError("int16 samebits needs at most 32767 bins")
    if a.device.type == "cpu":
        return samebits_ref(a, b, out_dtype=out_dtype, tri=tri, row0=row0)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    if a.shape[0] == 0 or b.shape[0] == 0:
        return torch.zeros((a.shape[0], b.shape[0]), dtype=out_dtype,
                           device=a.device)
    out = _launch_samebits(a, b, out_dtype, tri, row0)
    samebits.launches += 1
    return out


samebits.launches = 0


def _launch_samebits(a, b, out_dtype, tri, row0) -> torch.Tensor:
    na, w = a.shape
    nb = b.shape[0]
    if na > _MAX_GRID_Y * _TI:
        raise ValueError(f"samebits: {na} rows exceed one launch")
    out = torch.empty((na, nb), dtype=out_dtype, device=a.device)
    err = _build.lib().stpu_samebits(
        a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0),
        out.data_ptr(), nb, na, nb, w // BBITS, out.element_size(),
        int(tri), int(row0), _build.stream_handle(a.device),
    )
    _build.check(err, "samebits")
    return out
