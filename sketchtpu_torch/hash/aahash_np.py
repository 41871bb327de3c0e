"""NumPy aaHash: the host oracle's forward rolling hash over amino acids.

Windowed-XOR form of the reference's recurrence (as ntHash in
nthash_np.py):

    fh(p) = XOR_{j<k} srol^{k-1-j}( SEED_level[ seq[p+j] ] )

aaHash is forward-only (no reverse complement). Window emission matches the
reference iterator (sketchlib.rust src/hashing/aahash_iterator.rs:138-210),
including its final-window quirk: because re-seeding requires start + k <
seq_len (strict), the very last window [L-k, L) is only emitted when it is
reachable by *rolling*, i.e. when the trailing k+1 characters are all valid.
Interior windows are emitted whenever all k characters are valid.
"""

from __future__ import annotations

import numpy as np

from ..constants import aa_tap_table
from ..ingest.fastx import _VALID_AA, AaStream

_U64 = np.uint64


def aa_window_valid(seq: np.ndarray, k: int) -> np.ndarray:
    """(m,) bool emission mask for one sample's raw byte sequence, matching
    the reference iterator exactly (aahash_iterator.rs:138-210) including
    the final-window quirk. Raises when no window is reachable (set_k
    panic semantics)."""
    n = seq.shape[0]
    m = n - k + 1
    if m <= 0:
        raise ValueError("K-mer larger than smallest valid sequence")
    valid = _VALID_AA[seq]
    vcum = np.concatenate([[0], np.cumsum(valid)])
    # window fully valid: k valid chars starting at s
    window_valid = (vcum[k:] - vcum[:-k]) == k  # length m
    # the final window additionally requires char L-k-1 to be valid
    if n - k - 1 >= 0:
        window_valid[m - 1] &= bool(valid[n - k - 1])
    else:
        window_valid[m - 1] = False

    # The reference's seeding requires some window with s + k < L; if only
    # the final window would qualify it is unreachable -> error (set_k panic).
    if not window_valid[: m - 1].any():
        raise ValueError("K-mer larger than smallest valid sequence")
    return window_valid


def aahash_valid(stream: AaStream, k: int, level: int = 1) -> np.ndarray:
    """Hashes of all emitted windows for one sample (order preserved)."""
    seq = stream.seq
    n = seq.shape[0]
    m = n - k + 1
    window_valid = aa_window_valid(seq, k)
    tab = aa_tap_table(k, level)
    fh = np.zeros(m, dtype=_U64)
    for j in range(k):
        fh ^= tab[j][seq[j : j + m]]
    return fh[window_valid]
