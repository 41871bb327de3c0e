"""NumPy ntHash: data-parallel canonical rolling hash.

Key reformulation (this is what makes the hash data-parallel): the ntHash
recurrence fh' = srol(fh) ^ SEED[b] unrolls to a *windowed XOR of
statically-rotated table lookups*:

    fh(p)  = XOR_{j<k} srol^{k-1-j}( SEED[ s[p+j] ] )
    rh(p)  = XOR_{j<k} srol^{j}( RC_SEED[ s[p+j] ] )
    hash(p) = min(fh(p), rh(p))            (canonical form)

so every window's hash is independent — no sequential scan is needed, and
the same set of hash values as the reference iterator
(sketchlib.rust src/hashing/nthash_iterator.rs:325-523) is produced. Window
validity (N bases, record boundaries, quality-masked bases) is a prefix-sum
mask over break positions.

This module is the CPU oracle; hash/nthash_torch.py computes the identical
function on the card.
"""

from __future__ import annotations

import numpy as np

from ..constants import nt_tap_tables
from ..ingest.fastx import DnaStream

_U64 = np.uint64


def valid_window_mask(n: int, breaks: np.ndarray, k: int) -> np.ndarray:
    """Boolean mask over window starts 0..n-k: True if window [s, s+k) does
    not cross a break. A break at position p forbids windows with
    s < p < s+k; breaks at p == s or p == s+k are window-aligned and fine.
    """
    m = n - k + 1
    if m <= 0:
        return np.zeros(0, dtype=bool)
    flags = np.zeros(n + 2, dtype=np.int64)
    if breaks.size:
        inner = breaks[(breaks > 0) & (breaks < n)]
        np.add.at(flags, inner, 1)
    csum = np.cumsum(flags)  # csum[p] = number of breaks at positions <= p
    # breaks in [s+1, s+k-1]  ==  csum[s+k-1] - csum[s] == 0
    return (csum[k - 1 : k - 1 + m] - csum[0:m]) == 0


def nthash_all(codes: np.ndarray, k: int, rc: bool) -> np.ndarray:
    """Canonical ntHash for every window start (length n-k+1), valid or not."""
    n = codes.shape[0]
    m = n - k + 1
    if m <= 0:
        return np.zeros(0, dtype=_U64)
    fwd_tab, rev_tab = nt_tap_tables(k)
    fh = np.zeros(m, dtype=_U64)
    for j in range(k):
        fh ^= fwd_tab[j][codes[j : j + m]]
    if not rc:
        return fh
    rh = np.zeros(m, dtype=_U64)
    for j in range(k):
        rh ^= rev_tab[j][codes[j : j + m]]
    return np.minimum(fh, rh)


def nthash_valid(stream: DnaStream, k: int, rc: bool) -> np.ndarray:
    """Canonical hashes of all *valid* windows, in sequence order.

    This is exactly the multiset of hashes the reference iterator emits
    (minus its harmless duplicate final-hash emissions, which cannot change
    bin minima).
    """
    hashes = nthash_all(stream.codes, k, rc)
    mask = valid_window_mask(stream.seq_len, stream.breaks, k)
    return hashes[mask]
