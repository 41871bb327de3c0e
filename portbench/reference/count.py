"""The plain reference of `precluster --count`: the number of sample pairs
that share the sign of at least one bin (sketchlib.rust
inverted.rs:271-300), in plain PyTorch.

Each pair is counted at the first bin where its two samples hold the same
sign. Bin by bin, the samples are sorted by their sign there; every pair
inside a run of equal signs shares this bin, and is counted unless the two
samples also share an earlier bin, which is tested for the pairs still
standing eight earlier bins at a time. The work follows the pairs that
share a bin, not all n(n-1)/2 of them."""

from __future__ import annotations

import numpy as np
import torch

_PAIRS = 1 << 25  # pairs enumerated at once
_EARLIER = 8  # earlier bins tested at once


def _pairs_of_runs(order: torch.Tensor, sorted_signs: torch.Tensor):
    """Yield (a, b) sample ids of every pair inside a run of equal signs,
    in chunks of about _PAIRS pairs."""
    n = order.numel()
    dev = order.device
    new = torch.ones(n, dtype=torch.bool, device=dev)
    new[1:] = sorted_signs[1:] != sorted_signs[:-1]
    starts = torch.nonzero(new).squeeze(1)
    ends = torch.cat([starts[1:], torch.tensor([n], device=dev)])
    run = torch.cumsum(new.to(torch.int64), 0) - 1
    pos = torch.arange(n, device=dev)
    later = ends[run] - pos - 1  # partners after each position in its run
    cum = torch.cumsum(later, 0)
    lo = 0
    while lo < n:
        base = int(cum[lo - 1]) if lo else 0
        hi = int(torch.searchsorted(cum, torch.tensor([base + _PAIRS],
                                                      device=dev), right=True))
        hi = max(hi, lo + 1)
        cnt = later[lo:hi]
        left = torch.repeat_interleave(pos[lo:hi], cnt)
        step = torch.arange(left.numel(), device=dev) - torch.repeat_interleave(
            cum[lo:hi] - cnt - base, cnt)
        yield order[left], order[left + 1 + step]
        lo = hi


def shared_pair_count(signs: np.ndarray, device) -> int:
    """Pairs i < j of the (n, S) u16 signs that share a sign in some bin."""
    sig = torch.from_numpy(np.ascontiguousarray(signs.T).astype(np.int32)).to(device)
    total = 0
    for b in range(sig.shape[0]):
        sorted_signs, order = torch.sort(sig[b], stable=True)
        for a, c in _pairs_of_runs(order, sorted_signs):
            for t0 in range(0, b, _EARLIER):
                if a.numel() == 0:
                    break
                block = sig[t0 : min(b, t0 + _EARLIER)]
                fresh = ~(block[:, a] == block[:, c]).any(0)
                a, c = a[fresh], c[fresh]
            total += a.numel()
    return total
