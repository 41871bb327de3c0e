"""K2, fused multi-k core/accessory distances: the CUDA kernel
csrc/coreacc.cu and its plain PyTorch twin.

Replaces sketchtpu/dist/coreacc_pallas.py::coreacc_pallas. The twin is a
plain copy of sketchtpu/dist/coreacc_jax.py::coreacc_tile except that the
regression sums run over x = k - kc (kc: the middle k), which keeps the
f32 accessory distance within ~1e-6 of the f64 chain where the uncentred
sums lose up to ~2e-5 to cancellation. Both take the (n, nk, W) int64
sketch words of to_device_words(), k ascending.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..constants import BBITS
from .samebits_kernels import _check_words, _tri_mask_, samebits_ref

_MAX_GRID_Y = 65535
_TI = 32  # rows per block of coreacc.cu


def chain_constants(s64: int, sketch_size: int) -> tuple[float, float, float]:
    """(maxnbits, expected, tolerance) of the Jaccard / early-break chain."""
    maxnbits = float(s64 * 64)
    expected = float(int(s64 * 64) >> BBITS)
    tolerance = float(np.log(2.0 / float(sketch_size * 64)))
    return maxnbits, expected, tolerance


def k_centre(kmers) -> float:
    """The middle k: centring x on it keeps every x a small exact integer."""
    return float(kmers[len(kmers) // 2])


def coreacc_ref(a: torch.Tensor, b: torch.Tensor, kmers, sketch_size: int,
                c1=None, c2=None, cutoff: float = 0.64, tri: bool = False,
                row0: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of coreacc(): (core, acc) f32 (na, nb)."""
    s64 = a.shape[2] // BBITS
    maxnbits, expected, tolerance = chain_constants(s64, sketch_size)
    shape = (a.shape[0], b.shape[0])
    dev = a.device
    if c1 is not None:
        prod = c1[:, None] * c2[None, :]
        factor = prod / (c1[:, None] + c2[None, :] - prod)
        comp_apply = prod >= cutoff
    xsum = torch.zeros(shape, dtype=torch.float32, device=dev)
    ysum = torch.zeros_like(xsum)
    xysum = torch.zeros_like(xsum)
    xsq = torch.zeros_like(xsum)
    ysq = torch.zeros_like(xsum)
    n = torch.zeros_like(xsum)
    still = torch.ones(shape, dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    kc = k_centre(kmers)
    for ki, k in enumerate(kmers):
        sb = samebits_ref(a[:, ki], b[:, ki]).to(torch.float32)
        diff = torch.clamp_min(sb - expected, 0.0)
        j = (diff * maxnbits / (maxnbits - expected)) / maxnbits
        if c1 is not None:
            j = torch.where(comp_apply, torch.clamp(j / factor, max=1.0), j)
        y = torch.log(j)
        still = still & (y >= tolerance)
        k_fl = float(k) - kc
        yk = torch.where(still, y, zero)
        xsum = xsum + torch.where(still, k_fl, zero)
        ysum = ysum + yk
        xysum = xysum + k_fl * yk
        xsq = xsq + torch.where(still, k_fl * k_fl, zero)
        ysq = ysq + yk * yk
        n = n + still

    xbar = xsum / n + kc
    ybar = ysum / n
    x_diff = xsq - xsum * xsum / n
    y_diff = ysq - ysum * ysum / n
    beta = (xysum - xsum * ysum / n) / x_diff
    alpha = -beta * xbar + ybar
    one = torch.ones((), dtype=torch.float32, device=dev)
    core = torch.where(
        beta < 0.0, 1.0 - torch.exp(beta), torch.where(beta > 0.0, one, zero)
    )
    acc = torch.where(alpha < 0.0, 1.0 - torch.exp(alpha), zero)
    degenerate = y_diff <= 0.0
    core = torch.where(degenerate, zero, core)
    acc = torch.where(degenerate, zero, acc)
    bad = torch.isnan(ysum) | torch.isneginf(ysum) | (n < 3.0)
    core = torch.where(bad, one, core)
    acc = torch.where(bad, one, acc)
    if tri:
        _tri_mask_(core, row0)
        _tri_mask_(acc, row0)
    return core, acc


def coreacc(a: torch.Tensor, b: torch.Tensor, kmers, sketch_size: int,
            c1=None, c2=None, cutoff: float = 0.64, tri: bool = False,
            row0: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """(core, acc) f32 (na, nb) distances of sketch words a (na, nk, W)
    and b (nb, nk, W); c1 (na,) / c2 (nb,) f32 completeness apply the
    correction where c1*c2 >= cutoff. tri (rows globally at row0 + i)
    computes only what pairs with column > row need; other entries are
    zero. CUDA tensors launch the kernel, CPU tensors run the twin."""
    _check_words("a", a, 3)
    _check_words("b", b, 3)
    nk = len(kmers)
    if a.shape[1:] != b.shape[1:] or a.shape[1] != nk or a.device != b.device:
        raise ValueError("a and b need the same (nk, W) and device")
    if nk < 1 or list(kmers) != sorted(kmers):
        raise ValueError("kmers must be ascending")
    if (c1 is None) != (c2 is None):
        raise ValueError("pass both c1 and c2, or neither")
    if c1 is not None:
        for name, c, m in (("c1", c1, a.shape[0]), ("c2", c2, b.shape[0])):
            if (c.dtype != torch.float32 or c.shape != (m,)
                    or c.device != a.device or not c.is_contiguous()):
                raise ValueError(f"{name} must be contiguous f32 ({m},)")
    if a.device.type == "cpu":
        return coreacc_ref(a, b, kmers, sketch_size, c1, c2, cutoff, tri, row0)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    shape = (a.shape[0], b.shape[0])
    if 0 in shape:
        z = torch.zeros(shape, dtype=torch.float32, device=a.device)
        return z, z.clone()
    out = _launch_coreacc(a, b, kmers, sketch_size, c1, c2, cutoff, tri, row0)
    coreacc.launches += 1
    return out


coreacc.launches = 0


def _launch_coreacc(a, b, kmers, sketch_size, c1, c2, cutoff, tri, row0):
    na, nk, w = a.shape
    nb = b.shape[0]
    if na > _MAX_GRID_Y * _TI:
        raise ValueError(f"coreacc: {na} rows exceed one launch")
    if a.stride(1) != w or b.stride(1) != w:
        raise ValueError("coreacc: each row's k planes must be contiguous")
    s64 = w // BBITS
    maxnbits, expected, tolerance = chain_constants(s64, sketch_size)
    kc = k_centre(kmers)
    kf = torch.tensor([float(k) - kc for k in kmers], dtype=torch.float32,
                      device=a.device)
    core = torch.empty((na, nb), dtype=torch.float32, device=a.device)
    acc = torch.empty_like(core)
    err = _build.lib().stpu_coreacc(
        a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0), w, na, nb, s64,
        nk, kf.data_ptr(), kc,
        c1.data_ptr() if c1 is not None else None,
        c2.data_ptr() if c2 is not None else None,
        cutoff, expected, maxnbits, maxnbits - expected, tolerance,
        core.data_ptr(), acc.data_ptr(), nb, int(tri), int(row0),
        _build.stream_handle(a.device),
    )
    _build.check(err, "coreacc")
    return core, acc
