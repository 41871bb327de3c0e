"""The inverted index's u16 signs as the kernels read them: the Python
side of csrc/signeq.cuh, shared by the sign-equality kernel
(inverted/device.py) and the precluster mask of K3 (knn_kernels.py) and
K2's key mode (coreacc_kernels.py).

An (n, S) u16 sign matrix is held packed two signs to an int32 word: bin
2w in the low half of word w, bin 2w + 1 in the high half, and a zero pad
half when S is odd, which the kernels never let match.
"""

from __future__ import annotations

import numpy as np
import torch

_REF_ELEMS = 1 << 24  # twin working set: elements of one (rows, cols, S) temporary


def pack_signs(signs, device) -> torch.Tensor:
    """(n, S) u16 signs (numpy) as the (n, ceil(S / 2)) int32 words of the
    kernels on `device`."""
    signs = np.asarray(signs, dtype=np.uint16)
    n, s = signs.shape
    if s % 2:
        signs = np.concatenate([signs, np.zeros((n, 1), np.uint16)], axis=1)
    words = np.ascontiguousarray(signs).view("<u4").view(np.int32)
    return torch.from_numpy(words.copy()).to(device)


def unpack_signs(words: torch.Tensor, nsigns: int) -> torch.Tensor:
    """(n, W) packed words -> (n, nsigns) int32 sign values (the twins'
    form)."""
    lo = words & 0xFFFF
    hi = (words >> 16) & 0xFFFF
    return torch.stack([lo, hi], dim=2).reshape(words.shape[0], -1)[:, :nsigns]


def check_signs(name: str, t: torch.Tensor, nsigns: int):
    if (t.dtype != torch.int32 or t.dim() != 2 or t.stride(1) != 1
            or t.shape[1] != (nsigns + 1) // 2):
        raise ValueError(f"{name} must be (rows, {(nsigns + 1) // 2}) int32 "
                         f"packed sign words with contiguous rows")
    if nsigns < 1 or nsigns >= 2 * 65536:
        raise ValueError(f"nsigns={nsigns} out of range")


def signeq_ref(q: torch.Tensor, m: torch.Tensor, nsigns: int,
               mode: str) -> torch.Tensor:
    """(nq, n) sign equality of packed rows q against packed rows m, in
    plain PyTorch: count (int32 equal bins), any or all (bool)."""
    qv, mv = unpack_signs(q, nsigns), unpack_signs(m, nsigns)
    nq, n = qv.shape[0], mv.shape[0]
    dtype = torch.int32 if mode == "count" else torch.bool
    out = torch.empty((nq, n), dtype=dtype, device=q.device)
    step = max(1, _REF_ELEMS // max(1, nq * nsigns))
    for c0 in range(0, n, step):
        eq = qv[:, None, :] == mv[None, c0 : c0 + step, :]
        if mode == "count":
            out[:, c0 : c0 + step] = eq.sum(2, dtype=torch.int32)
        elif mode == "any":
            out[:, c0 : c0 + step] = eq.any(2)
        else:
            out[:, c0 : c0 + step] = eq.all(2)
    return out


def any_mask_ref(a: torch.Tensor, b: torch.Tensor, nsigns: int) -> torch.Tensor:
    """(na, nb) bool: rows of a and b (packed words) share a sign; the
    plain version of the precluster mask inside K3 and K2."""
    return signeq_ref(a, b, nsigns, "any")
