"""Sign extraction: hash -> mod 2^61-1 -> per-bin minima -> densify ->
b-bit transpose. Host implementations, NumPy and the host helper's (the CPU
oracle and the exact path for FASTQ count-filtering); the device backend
(sketch_torch.py) calls densify and fill_usigs on its bin minima.

Mirrors sketchlib.rust src/sketch/mod.rs.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import _native
from ..constants import BBITS, SIGN_MOD, universal_hash

_U64 = np.uint64
_FULL = _U64(0xFFFFFFFFFFFFFFFF)
_SIGN_MOD_U64 = _U64(SIGN_MOD)


def signs_from_hashes(hashes: np.ndarray) -> np.ndarray:
    """hash % (2^61 - 1), vectorised via the Mersenne shift-add identity."""
    x = (hashes & _SIGN_MOD_U64) + (hashes >> _U64(61))
    return np.where(x >= _SIGN_MOD_U64, x - _SIGN_MOD_U64, x)


def bin_size(num_bins: int) -> int:
    """ceil(SIGN_MOD / num_bins) — src/sketch/mod.rs:146."""
    return (SIGN_MOD + num_bins - 1) // num_bins


def bin_minima(signs: np.ndarray, num_bins: int) -> np.ndarray:
    """Per-bin minimum of signs; empty bins are u64::MAX."""
    out = np.full(num_bins, _FULL, dtype=_U64)
    if signs.size == 0:
        return out
    signs = np.ascontiguousarray(signs, dtype=_U64)
    lib = _native.lib()
    lib.stpu_bin_signs(
        signs.ctypes.data_as(ctypes.c_void_p),
        signs.size,
        _U64(bin_size(num_bins)),
        out.ctypes.data_as(ctypes.c_void_p),
        num_bins,
    )
    return out


def bin_minima_filtered(
    signs: np.ndarray, num_bins: int, min_count: int
) -> np.ndarray:
    """Per-bin minima with the FASTQ min-count filter.

    The filter is stateful and consulted only for signs that would improve
    their bin at the moment of the observation, so the result depends on
    stream order (src/sketch/mod.rs:198-208 + hashing/bloom_filter.rs); this
    is an inherently sequential loop and runs in the host helper.
    """
    out = np.full(num_bins, _FULL, dtype=_U64)
    if signs.size == 0:
        return out
    signs = np.ascontiguousarray(signs, dtype=_U64)
    lib = _native.lib()
    lib.stpu_filter_bin_signs(
        signs.ctypes.data_as(ctypes.c_void_p),
        signs.size,
        np.uint16(min_count),
        _U64(bin_size(num_bins)),
        out.ctypes.data_as(ctypes.c_void_p),
        num_bins,
    )
    return out


def densify(signs: np.ndarray) -> bool:
    """Optimal-densification probing for empty bins, in place.

    Exact sequential replication of Sketch::densify_bin
    (src/sketch/mod.rs:237-258): bins are filled in index order and probes
    may read earlier, already-densified entries. Returns whether any bin was
    densified.

    Divergence: when EVERY bin is empty (possible when the FASTQ count
    filter rejects all k-mers) the reference's probe loop never terminates
    (mod.rs:250-253 spins — its "K-mer larger than smallest valid sequence"
    panic only guards the zero-hashes case, nthash_iterator.rs:56). We
    raise that same error instead of hanging; the device backends do too.
    """
    if signs.size == 0 or int(signs.max()) != int(_FULL):
        return False
    if int(signs.min()) == int(_FULL):
        raise ValueError("K-mer larger than smallest valid sequence")
    n = signs.shape[0]
    for i in range(n):
        j = i
        attempt = 0
        while int(signs[j]) == int(_FULL):
            j = universal_hash(i, attempt) % n
            attempt += 1
        signs[i] = signs[j]
    return True


def fill_usigs(signs: np.ndarray) -> np.ndarray:
    """Transpose bin minima into BBITS bit-planes per 64-bin chunk.

    Layout (src/sketch/mod.rs:215-223): for chunk c and plane i,
    usigs[c*BBITS + i] packs bit i of the 64 bins of chunk c, bin index
    within chunk giving the bit position.
    """
    num_bins = signs.shape[0]
    s64 = num_bins // 64
    bits = (signs.reshape(s64, 64, 1) >> np.arange(BBITS, dtype=_U64)) & _U64(1)
    weights = (_U64(1) << np.arange(64, dtype=_U64)).reshape(1, 64, 1)
    planes = np.bitwise_or.reduce(bits * weights, axis=1)  # (s64, BBITS)
    return planes.reshape(-1).astype(_U64)
