"""K2, fused multi-k core/accessory distances: the CUDA kernel
csrc/coreacc.cu and its plain PyTorch twins.

Replaces sketchtpu/dist/coreacc_pallas.py::coreacc_pallas. The twin is a
plain copy of sketchtpu/dist/coreacc_jax.py::coreacc_tile except that the
regression sums run over x = k - kc (kc: the middle k), which keeps the
f32 accessory distance within ~1e-6 of the f64 chain where the uncentred
sums lose up to ~2e-5 to cancellation. Both take the (n, nk, W) int64
sketch words of to_device_words(), k ascending.

Two entry points launch the one kernel (one launch count, coreacc.launches):
- coreacc(): the (core, acc) f32 tiles of the dense engines;
- coreacc_keys(): the core/accessory kNN scan tile, int64 selection keys
  (-core, column) beside the f32 acc, which knn_torch merges by top-k;
  with a SignMask (the inverted index's precluster) a pair whose rows
  share no sign of the index is not a candidate.

coreacc_chain() launches the second kernel of csrc/coreacc.cu: K2's chain
on the sum of the words slots' per-k partial samebits, taken as the slabs
stand (coreacc_jax.coreacc_tile after its psum). It shares K2's chain
code, so its (core, acc) are K2's bit for bit; its twin coreacc_chain_ref
is the second half of coreacc_ref.

Both kernels take up to MAX_NK k values. Up to MAX_NK_BY_VALUE the k table
(_k_table) goes to the launch by value; past it the wrapper copies the
table to the card on the launch's stream and the kernels' WIDE
instantiations read it there (csrc/coreacc.cu), with the same floats, so
the bits do not depend on the route.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import _build
from ..constants import BBITS
from .knn_kernels import (_NO_SIG, COLMASK64, SignMask, pack_keys,
                          scalar_divisors)
from .samebits_kernels import (
    _check_words,
    _tri_mask_,
    check_parts,
    samebits_stack_ref,
    sum_parts_ref,
)

MAX_NK = 65535  # k values per launch: K2's 16-bit included-k count
MAX_NK_BY_VALUE = 255  # past it the k table goes through device memory
_MAX_TILES = (1 << 31) - 1  # one-dimensional grid of 64 x 64 pair tiles
_TILE = 64
_CHAIN_NT = 256  # pairs a block of the chain kernel
KEY_INVALID = -(1 << 63)  # key of a pair that is not a candidate


def chain_constants(s64: int, sketch_size: int) -> tuple[float, float, float]:
    """(maxnbits, expected, tolerance) of the Jaccard / early-break chain."""
    maxnbits = float(s64 * 64)
    expected = float(int(s64 * 64) >> BBITS)
    tolerance = float(np.log(2.0 / float(sketch_size * 64)))
    return maxnbits, expected, tolerance


def k_centre(kmers) -> float:
    """The middle k: centring x on it keeps every x a small exact integer."""
    return float(kmers[len(kmers) // 2])


def coreacc_chain_ref(sb, kmers, sketch_size: int, s64: int,
                      c1=None, c2=None, cutoff: float = 0.64
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of coreacc_chain(): (core, acc) f32 (na, nb) of
    the sum of sb, int32 (nk, na, nb) samebits slabs (a tensor, or a
    sequence of them) of a sketch of s64 chunks."""
    sb = sum_parts_ref(_chain_slabs(sb, len(kmers)))
    maxnbits, expected, tolerance = chain_constants(s64, sketch_size)
    shape = tuple(sb.shape[1:])
    dev = sb.device
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
    denom, mnb = scalar_divisors(dev, maxnbits - expected, maxnbits)
    for ki, k in enumerate(kmers):
        diff = torch.clamp_min(sb[ki].to(torch.float32) - expected, 0.0)
        j = (diff * maxnbits / denom) / mnb
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
    return core, acc


def coreacc_ref(a: torch.Tensor, b: torch.Tensor, kmers, sketch_size: int,
                c1=None, c2=None, cutoff: float = 0.64, tri: bool = False,
                row0: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of coreacc(): (core, acc) f32 (na, nb), the
    per-k samebits and then coreacc_chain_ref."""
    core, acc = coreacc_chain_ref(samebits_stack_ref(a, b), kmers,
                                  sketch_size, a.shape[2] // BBITS, c1, c2,
                                  cutoff)
    if tri:
        _tri_mask_(core, row0)
        _tri_mask_(acc, row0)
    return core, acc


def coreacc_keys_ref(a: torch.Tensor, b: torch.Tensor, kmers,
                     sketch_size: int, c1=None, c2=None,
                     cutoff: float = 0.64, *, row0: int = 0, col0: int = 0,
                     nb_real: int | None = None,
                     exclude_self: bool = False,
                     sig: SignMask | None = None):
    """Plain PyTorch twin of coreacc_keys(): coreacc_ref, then pack_keys."""
    tr, tc = a.shape[0], b.shape[0]
    ncols = _real_cols(tc, col0, nb_real)
    core = torch.zeros((tr, tc), dtype=torch.float32, device=a.device)
    acc = torch.zeros_like(core)
    core[:, :ncols], acc[:, :ncols] = coreacc_ref(
        a, b[:ncols], kmers, sketch_size, c1,
        None if c2 is None else c2[:ncols], cutoff)
    cols = col0 + torch.arange(tc, device=a.device)
    valid = (torch.arange(tc, device=a.device) < ncols)[None, :].expand(tr, tc)
    if exclude_self:
        rows = row0 + torch.arange(tr, device=a.device)
        valid = valid & (cols[None, :] != rows[:, None])
    if sig is not None:
        valid = valid & sig.tile_mask(ncols, col0, tc)
    keys = pack_keys(-core, cols, torch.int64, 32, COLMASK64, valid,
                     invalid=KEY_INVALID)
    return keys, acc


def _real_cols(tc: int, col0: int, nb_real: int | None) -> int:
    return tc if nb_real is None else max(0, min(tc, nb_real - col0))


def _check(a, b, kmers, c1, c2) -> None:
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
    if a.device.type == "cuda" and nk > MAX_NK:
        raise ValueError(f"coreacc: {nk} k values exceed the kernel's limit "
                         f"of {MAX_NK} (MAX_NK in csrc/coreacc.cu)")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {a.device}")


def coreacc(a: torch.Tensor, b: torch.Tensor, kmers, sketch_size: int,
            c1=None, c2=None, cutoff: float = 0.64, tri: bool = False,
            row0: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """(core, acc) f32 (na, nb) distances of sketch words a (na, nk, W)
    and b (nb, nk, W); c1 (na,) / c2 (nb,) f32 completeness apply the
    correction where c1*c2 >= cutoff. tri (rows globally at row0 + i)
    computes only what pairs with column > row need; other entries are
    zero. CUDA tensors launch the kernel (at most MAX_NK k values), CPU
    tensors run the twin."""
    _check(a, b, kmers, c1, c2)
    if a.device.type == "cpu":
        return coreacc_ref(a, b, kmers, sketch_size, c1, c2, cutoff, tri, row0)
    shape = (a.shape[0], b.shape[0])
    if 0 in shape:
        z = torch.zeros(shape, dtype=torch.float32, device=a.device)
        return z, z.clone()
    out = _launch_coreacc(a, b, kmers, sketch_size, c1, c2, cutoff, tri, row0,
                          None)
    coreacc.launches += 1
    return out


coreacc.launches = 0
coreacc.masked_launches = 0  # of them, masked key tiles (the precluster)


def coreacc_keys(a: torch.Tensor, b: torch.Tensor, kmers, sketch_size: int,
                 c1=None, c2=None, cutoff: float = 0.64, *, row0: int = 0,
                 col0: int = 0, nb_real: int | None = None,
                 exclude_self: bool = False, sig: SignMask | None = None):
    """The core/accessory kNN scan tile of the rows a (tr, nk, W) against
    the columns b (tc, nk, W): (keys int64 (tr, tc), acc f32 (tr, tc)).

    Row i has the global id row0 + i, column j the global id col0 + j. The
    key of a pair is ordered_bits(-core) << 32 | (COLMASK64 - column), so
    a descending top-k selects core ascending, then column ascending.
    Columns with id >= nb_real (default: all of b is real) are never read
    and get KEY_INVALID and acc 0; so does column == row with exclude_self
    (its acc is computed). c1 (tr,) / c2 (tc,) as in coreacc(). With sig
    (sig.rows (tr,), sig.cols for every column id) a pair that shares no
    sign gets KEY_INVALID (its acc is computed). CUDA tensors launch the
    kernel and count in coreacc.launches; CPU tensors run the twin."""
    _check(a, b, kmers, c1, c2)
    if min(row0, col0) < 0 or (nb_real is not None and nb_real < 0) \
            or col0 + b.shape[0] - 1 > COLMASK64:
        raise ValueError(f"bad ids: row0={row0} col0={col0} nb_real={nb_real}")
    if sig is not None:
        sig.check(a.shape[0], col0 + _real_cols(b.shape[0], col0, nb_real),
                  a.device)
    if a.device.type == "cpu":
        return coreacc_keys_ref(a, b, kmers, sketch_size, c1, c2, cutoff,
                                row0=row0, col0=col0, nb_real=nb_real,
                                exclude_self=exclude_self, sig=sig)
    shape = (a.shape[0], b.shape[0])
    if 0 in shape:
        return (torch.full(shape, KEY_INVALID, dtype=torch.int64,
                           device=a.device),
                torch.zeros(shape, dtype=torch.float32, device=a.device))
    out = _launch_coreacc(a, b, kmers, sketch_size, c1, c2, cutoff, False,
                          row0, (col0, _real_cols(b.shape[0], col0, nb_real),
                                 exclude_self), sig)
    coreacc.launches += 1
    coreacc.masked_launches += sig is not None
    return out


def _chain_slabs(sb, nk: int) -> list[torch.Tensor]:
    """sb (a tensor, or a sequence of them) as the list of its int32 (nk,
    na, nb) slabs."""
    slabs = check_parts(sb, f"coreacc_chain: sb must be int32 ({nk}, na, nb) "
                        f"stacks")
    if slabs[0].dim() != 3 or slabs[0].shape[0] != nk:
        raise ValueError(f"coreacc_chain: sb must be int32 ({nk}, na, nb) "
                         f"stacks, got {tuple(slabs[0].shape)}")
    return slabs


def coreacc_chain(sb, kmers, sketch_size: int, s64: int, c1=None, c2=None,
                  cutoff: float = 0.64) -> tuple[torch.Tensor, torch.Tensor]:
    """(core, acc) f32 (na, nb) from sb, the int32 (nk, na, nb) partial
    samebits slabs of a words split's slots (a tensor, or a sequence of 1
    to MAX_WORDS_SLOTS of them, taken as they stand), whose sum is the
    whole samebits count of a sketch of s64 chunks at each k (ascending):
    K2's chain and fit on the sums, with c1 (na,) / c2 (nb,) f32
    completeness applied after the sum where c1*c2 >= cutoff. No summed
    slab is made. CUDA tensors launch the chain kernel (at most MAX_NK k
    values), CPU tensors run the twin."""
    nk = len(kmers)
    slabs = _chain_slabs(sb, nk)
    if nk < 1 or list(kmers) != sorted(kmers):
        raise ValueError("kmers must be ascending")
    if (c1 is None) != (c2 is None):
        raise ValueError("pass both c1 and c2, or neither")
    dev, (_, na, nb) = slabs[0].device, slabs[0].shape
    if c1 is not None:
        for name, c, m in (("c1", c1, na), ("c2", c2, nb)):
            if (c.dtype != torch.float32 or c.shape != (m,)
                    or c.device != dev or not c.is_contiguous()):
                raise ValueError(f"{name} must be contiguous f32 ({m},)")
    if dev.type == "cpu":
        return coreacc_chain_ref(slabs, kmers, sketch_size, s64, c1, c2,
                                 cutoff)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if nk > MAX_NK:
        raise ValueError(f"coreacc_chain: {nk} k values exceed the kernel's "
                         f"limit of {MAX_NK} (MAX_NK in csrc/coreacc.cu)")
    if -(-na * nb // _CHAIN_NT) > _MAX_TILES:
        raise ValueError(f"coreacc_chain: {na} x {nb} pairs exceed one launch")
    core = torch.empty((na, nb), dtype=torch.float32, device=dev)
    acc = torch.empty_like(core)
    if core.numel() == 0:
        return core, acc
    maxnbits, expected, tolerance = chain_constants(s64, sketch_size)
    ptrs = (ctypes.c_void_p * len(slabs))(*[t.data_ptr() for t in slabs])
    table, on_card = _k_table_args(tuple(kmers), dev)
    _build.launch(
        dev, "stpu_coreacc_chain",
        ptrs, len(slabs), na, nb, nk, table,
        on_card.data_ptr() if on_card is not None else None,
        c1.data_ptr() if c1 is not None else None,
        c2.data_ptr() if c2 is not None else None,
        cutoff, expected, maxnbits, maxnbits - expected, tolerance,
        core.data_ptr(), acc.data_ptr(), what="coreacc_chain",
    )
    coreacc_chain.launches += 1
    return core, acc


coreacc_chain.launches = 0


@functools.lru_cache(maxsize=64)
def _k_table(kmers: tuple) -> np.ndarray:
    """The kernels' k table as f32: w centred k values, the prefix sums of
    x and x*x (w + 1 each: the twin's sums over the included k, which the
    early break makes a prefix, added in the same order) and kc, where w =
    MAX_NK_BY_VALUE (KTable, by value; zeros past the k) or, past it, the
    number of k (the table in device memory). Read only."""
    kc = k_centre(kmers)
    w = max(len(kmers), MAX_NK_BY_VALUE)
    kf = np.zeros(w, dtype=np.float32)
    xs = np.zeros(w + 1, dtype=np.float32)
    xq = np.zeros(w + 1, dtype=np.float32)
    for q, k in enumerate(kmers):
        x = float(k) - kc
        kf[q] = x
        xs[q + 1] = xs[q] + np.float32(x)
        xq[q + 1] = xq[q] + np.float32(x * x)
    flat = np.concatenate([kf, xs, xq, np.float32([kc])])
    flat.flags.writeable = False
    return flat


def _k_table_args(kmers: tuple, device) -> tuple[int, torch.Tensor | None]:
    """The launch's k table arguments: the host table's address, and past
    MAX_NK_BY_VALUE k its copy on `device`, made on the device's current
    stream (the launch's), so its memory is not reused before the kernel
    has read it; else None."""
    table = _k_table(kmers)
    if len(kmers) <= MAX_NK_BY_VALUE:
        return table.ctypes.data, None
    return table.ctypes.data, torch.from_numpy(table.copy()).to(device)


def _launch_coreacc(a, b, kmers, sketch_size, c1, c2, cutoff, tri, row0,
                    keys, sig=None):
    """Launch K2 in plain mode (keys None) or key mode (keys = (col0,
    ncols, exclude_self)), masked by sig when given."""
    na, nk, w = a.shape
    nb = b.shape[0]
    tiles = -(-na // _TILE) * -(-nb // _TILE)
    if tiles > _MAX_TILES:
        raise ValueError(f"coreacc: {na} x {nb} pairs exceed one launch")
    if a.stride(1) != w or b.stride(1) != w:
        raise ValueError("coreacc: each row's k planes must be contiguous")
    s64 = w // BBITS
    maxnbits, expected, tolerance = chain_constants(s64, sketch_size)
    acc = torch.empty((na, nb), dtype=torch.float32, device=a.device)
    if keys is None:
        out = torch.empty_like(acc)
        col0, ncols, exclude_self = 0, nb, False
    else:
        out = torch.empty((na, nb), dtype=torch.int64, device=a.device)
        col0, ncols, exclude_self = keys
    table, on_card = _k_table_args(tuple(kmers), a.device)
    _build.launch(
        a.device, "stpu_coreacc",
        a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0), w, na, nb,
        ncols, s64, nk, table,
        on_card.data_ptr() if on_card is not None else None,
        c1.data_ptr() if c1 is not None else None,
        c2.data_ptr() if c2 is not None else None,
        cutoff, expected, maxnbits, maxnbits - expected, tolerance,
        out.data_ptr(), acc.data_ptr(), nb, int(keys is not None), int(tri),
        int(row0), int(col0), int(exclude_self),
        *(sig.args(col0) if sig is not None else _NO_SIG),
        what="coreacc",
    )
    return out, acc
