"""Samebits of sampled rows against every sample, in plain PyTorch.

A bin of a 64-bin chunk matches where all BBITS bit-planes of the two
sketches agree; samebits is the number of matching bins over the chunks
(sketchlib.rust jaccard.rs). Runs on whichever device the words are
given on, in blocks of rows so that it fits beside nothing else."""

from __future__ import annotations

import numpy as np
import torch

BBITS = 14
_M1, _M2, _M4 = 0x5555555555555555, 0x3333333333333333, 0x0F0F0F0F0F0F0F0F


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Bits set in each int64 (read as u64). Shifts are arithmetic in
    torch, so each one is masked before a sign bit could count."""
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    x = x + (x >> 8)
    x = x + (x >> 16)
    x = x + (x >> 32)
    return x & 0x7F


def samebits_rows(words: np.ndarray, rows: np.ndarray, device,
                  block: int = 16) -> torch.Tensor:
    """(len(rows), n, nk) int32 samebits on `device` of the sampled rows
    against all n samples; words (n, nk, s64, BBITS) u64."""
    n, nk, s64, _ = words.shape
    w = torch.from_numpy(np.ascontiguousarray(words).view(np.int64)).to(device)
    rows_t = torch.as_tensor(np.asarray(rows, np.int64), device=device)
    out = torch.empty((rows_t.numel(), n, nk), dtype=torch.int32,
                      device=device)
    for ki in range(nk):
        cols = w[:, ki]  # (n, s64, BBITS)
        for r0 in range(0, rows_t.numel(), block):
            a = w[rows_t[r0 : r0 + block], ki]  # (b, s64, BBITS)
            same = None
            for p in range(BBITS):
                eq = ~(a[:, None, :, p] ^ cols[None, :, :, p])
                same = eq if same is None else same & eq
            out[r0 : r0 + block, :, ki] = popcount(same).sum(-1).to(torch.int32)
    return out
