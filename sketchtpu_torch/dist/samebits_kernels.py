"""K1, exact samebits: the CUDA kernel csrc/samebits.cu and its plain
PyTorch twin; K4 (samebits_full, and samebits_stack: K4 at every k-plane
in one launch); samebits_dist, K4 with an f32 distance epilogue; and
samebits_finish, the finish of a words split (the slots' partial counts
summed, as int32 or as f32 distances).

Replaces sketchtpu/dist/pallas_kernels.py::samebits_strip_fused and
samebits_pallas, and gives sketchtpu/dist/jaccard_jax.py's
jaccard_dist_block and sharded_dist_step's tile after its psum (XLA
programs) their kernels. Sketch words stay in the .skd order
([row][chunk][plane], u64 bit patterns held in int64 tensors) with no TPU
relayout: the kernel reads rows through their stride, so a k-plane of a
(n, nk, W) database tensor, or a range of its chunks, is used in place.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..constants import BBITS

INT16_MAX_BINS = 32767
# partial samebits a words split's finish sums (samebits_finish,
# coreacc_chain): the kernels' MAX_WORDS_SLOTS in csrc/tile.cuh
MAX_WORDS_SLOTS = 8
# twin working set: elements of one broadcast (rows, cols, s64) temporary
_REF_ELEMS = 1 << 24

_M1 = 0x5555555555555555
_M2 = 0x3333333333333333
_M4 = 0x0F0F0F0F0F0F0F0F


def scalar_divisors(device, *values: float) -> tuple[torch.Tensor, ...]:
    """f32 0-dim tensors to divide by. On CUDA, torch divides a tensor by a
    Python scalar as a product with its f32 reciprocal, which is not the
    IEEE quotient the kernels compute unless the divisor is a power of two;
    a tensor divisor is divided exactly on every device."""
    return tuple(torch.tensor(v, dtype=torch.float32, device=device)
                 for v in values)


def words_to_device(words: np.ndarray, device) -> torch.Tensor:
    """u64 sketch words (any shape) as an int64 tensor on `device` holding
    the same bit patterns."""
    words = np.ascontiguousarray(words, dtype=np.uint64).view(np.int64)
    if not words.flags.writeable:
        words = words.copy()
    return torch.from_numpy(words).to(device)


def to_device_words(ms, device, rows: slice | None = None,
                    cols: slice | None = None) -> torch.Tensor:
    """A loaded MultiSketch's sketch words (of the samples `rows`, all by
    default; of the words `cols` of each k, a range of whole chunks, all by
    default) as an (n, nk, W) int64 tensor on `device`, in the .skd word
    order [sample][k][chunk][plane]."""
    n = ms.number_samples_loaded()
    words = ms.sketch_bins.reshape(n, len(ms.kmer_lengths), ms.kmer_stride)
    if rows is not None:
        words = words[rows]
    if cols is not None:
        words = words[..., cols]
    return words_to_device(words, device)


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
    computes only the pairs with column > row; the others are zero. CUDA
    tensors launch the kernel, CPU tensors run the twin."""
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


def samebits_full(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K4: the (na, nb) int32 samebits matrix of a (na, W) and b (nb, W).

    Replaces sketchtpu/dist/pallas_kernels.py::samebits_pallas, which
    computes K1's function with int32 output and no triangle; this is K1's
    kernel at that setting, counted on its own. CUDA tensors launch the
    kernel, CPU tensors run the twin."""
    _check_words("a", a, 2)
    _check_words("b", b, 2)
    if a.shape[1] != b.shape[1] or a.device != b.device:
        raise ValueError("a and b need the same width and device")
    if a.device.type == "cpu":
        return samebits_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    if a.shape[0] == 0 or b.shape[0] == 0:
        return torch.zeros((a.shape[0], b.shape[0]), dtype=torch.int32,
                           device=a.device)
    out = _launch_samebits(a, b, torch.int32, False, 0)
    samebits_full.launches += 1
    return out


samebits_full.launches = 0


def _launch_samebits(a, b, out_dtype, tri, row0) -> torch.Tensor:
    na, w = a.shape
    nb = b.shape[0]
    out = torch.empty((na, nb), dtype=out_dtype, device=a.device)
    _build.launch(
        a.device, "stpu_samebits",
        a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0),
        out.data_ptr(), nb, na, nb, w // BBITS, out.element_size(),
        int(tri), int(row0), what="samebits",
    )
    return out


def samebits_stack_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of samebits_stack(): the int32 (nk, na, nb)
    samebits of each k-plane of a (na, nk, W) and b (nb, nk, W)."""
    return torch.stack([samebits_ref(a[:, ki], b[:, ki])
                        for ki in range(a.shape[1])])


def samebits_stack(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K4 at every k-plane in one launch: the int32 (nk, na, nb) samebits
    of a (na, nk, W) and b (nb, nk, W), each plane written in place in the
    slab (a words slot's partials for coreacc_chain). Rows and k-planes are
    read through their strides (each (row, k) run of W words contiguous),
    so a range of a database tensor's chunks is used as it stands. CUDA
    tensors launch the kernel, CPU tensors run the twin."""
    _check_words("a", a, 3)
    _check_words("b", b, 3)
    if a.shape[1:] != b.shape[1:] or a.device != b.device:
        raise ValueError("a and b need the same (nk, W) and device")
    if a.device.type == "cpu":
        return samebits_stack_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    (na, nk, w), nb = a.shape, b.shape[0]
    if nk > 65535:
        raise ValueError(f"samebits_stack: {nk} k-planes exceed one launch")
    out = torch.empty((nk, na, nb), dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    _build.launch(
        a.device, "stpu_samebits_planes",
        a.data_ptr(), a.stride(0), a.stride(1), b.data_ptr(), b.stride(0),
        b.stride(1), out.data_ptr(), na, nb, w // BBITS, nk,
        what="samebits_stack",
    )
    samebits_stack.launches += 1
    return out


samebits_stack.launches = 0


def dist_constants(s64: int) -> tuple[float, float]:
    """(maxnbits, expected) of the whole sketch's Jaccard bias correction."""
    return float(s64 * 64), float(int(s64 * 64) >> BBITS)


def dist_from_samebits_ref(sb: torch.Tensor, s64: int, k: float = 0.0,
                           ani: bool = False) -> torch.Tensor:
    """The f32 distances of whole-sketch samebits counts sb (int32), op
    for op as the kernels' dist_value (jaccard_jax.jaccard_dist_block's
    chain)."""
    maxnbits, expected = dist_constants(s64)
    denom, mnb = scalar_divisors(sb.device, maxnbits - expected, maxnbits)
    diff = torch.clamp_min(sb.to(torch.float32) - expected, 0.0)
    j = (diff * maxnbits / denom) / mnb
    if not ani:
        return 1.0 - j
    return torch.clamp_min(1.0 + 1.0 / k * torch.log((2.0 * j) / (1.0 + j)),
                           0.0)


def samebits_dist_ref(a: torch.Tensor, b: torch.Tensor, s64: int,
                      k: float = 0.0, ani: bool = False) -> torch.Tensor:
    """Plain PyTorch twin of samebits_dist()."""
    return dist_from_samebits_ref(samebits_ref(a, b), s64, k, ani)


def samebits_dist(a: torch.Tensor, b: torch.Tensor, s64: int,
                  k: float = 0.0, ani: bool = False) -> torch.Tensor:
    """(na, nb) f32 distances from the samebits of a (na, W) and b (nb, W):
    1 - j, or with ani the ANI max(0, 1 + (1/k) ln(2j / (1 + j))), where j
    is the bias-corrected Jaccard of a sketch of s64 chunks (W <= s64 *
    BBITS; the constants come from s64, not from W). CUDA tensors launch
    K4 with its distance epilogue, CPU tensors run the twin."""
    _check_words("a", a, 2)
    _check_words("b", b, 2)
    if a.shape[1] != b.shape[1] or a.device != b.device:
        raise ValueError("a and b need the same width and device")
    if a.shape[1] > s64 * BBITS:
        raise ValueError(f"rows of {a.shape[1] // BBITS} chunks exceed the "
                         f"sketch's s64 = {s64}")
    shape = (a.shape[0], b.shape[0])
    if a.device.type == "cpu":
        return samebits_dist_ref(a, b, s64, k, ani)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    if 0 in shape:
        return torch.zeros(shape, dtype=torch.float32, device=a.device)
    out = torch.empty(shape, dtype=torch.float32, device=a.device)
    maxnbits, expected = dist_constants(s64)
    inv_k = 1.0 / k if ani else 0.0
    _build.launch(
        a.device, "stpu_samebits_dist",
        a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0),
        out.data_ptr(), shape[1], shape[0], shape[1], a.shape[1] // BBITS,
        expected, maxnbits, maxnbits - expected, inv_k, int(ani),
        what="samebits_dist",
    )
    samebits_dist.launches += 1
    return out


samebits_dist.launches = 0


def check_parts(parts, what: str) -> list[torch.Tensor]:
    """The partial samebits of a words split's slots as a list: 1 to
    MAX_WORDS_SLOTS contiguous int32 tensors of one shape on one device."""
    parts = [parts] if isinstance(parts, torch.Tensor) else list(parts)
    if not 1 <= len(parts) <= MAX_WORDS_SLOTS:
        raise ValueError(f"{what}: {len(parts)} partials; a finish sums 1 to "
                         f"{MAX_WORDS_SLOTS} (MAX_WORDS_SLOTS)")
    first = parts[0]
    for p in parts:
        if (p.dtype != torch.int32 or p.shape != first.shape
                or p.device != first.device or not p.is_contiguous()):
            raise ValueError(f"{what}: partials must be contiguous int32 "
                             f"tensors of one shape on one device, got "
                             f"{p.dtype} {tuple(p.shape)} on {p.device}")
    return parts


def sum_parts_ref(parts: list[torch.Tensor]) -> torch.Tensor:
    """The int32 sum of the partials (a new tensor; exact)."""
    sb = parts[0].clone()
    for p in parts[1:]:
        sb += p
    return sb


def samebits_finish_ref(parts, s64: int | None = None, k: float = 0.0,
                        ani: bool = False) -> torch.Tensor:
    """Plain PyTorch twin of samebits_finish()."""
    sb = sum_parts_ref(check_parts(parts, "samebits_finish"))
    return sb if s64 is None else dist_from_samebits_ref(sb, s64, k, ani)


def samebits_finish(parts, s64: int | None = None, k: float = 0.0,
                    ani: bool = False) -> torch.Tensor:
    """The finish of a words split: the sum of `parts`, the slots' partial
    samebits (1 to MAX_WORDS_SLOTS contiguous int32 tensors of one shape
    on one device, the lead's own and the received ones as they stand), as
    int32 (s64 None), or as the f32 distances of a sketch of s64 chunks: 1
    - j, or with ani the ANI at k, samebits_dist's values of the whole
    sketch bit for bit. CUDA tensors launch the finish kernel, CPU tensors
    run the twin."""
    parts = check_parts(parts, "samebits_finish")
    dev = parts[0].device
    if dev.type == "cpu":
        return samebits_finish_ref(parts, s64, k, ani)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    dtype = torch.int32 if s64 is None else torch.float32
    out = torch.empty(parts[0].shape, dtype=dtype, device=dev)
    if out.numel() == 0:
        return out
    maxnbits, expected = dist_constants(s64 or 1)
    ptrs = (ctypes.c_void_p * len(parts))(*[p.data_ptr() for p in parts])
    _build.launch(
        dev, "stpu_samebits_finish", ptrs, len(parts), out.numel(),
        out.data_ptr(), int(s64 is not None), expected, maxnbits,
        maxnbits - expected, 1.0 / k if ani else 0.0, int(ani),
        what="samebits_finish",
    )
    samebits_finish.launches += 1
    return out


samebits_finish.launches = 0
