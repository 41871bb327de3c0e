"""Algorithm constants of the DNA path.

The published ntHash seeds (Mohamadi et al. 2016,
doi:10.1093/bioinformatics/btw397) and the bindash-style binned
bottom-MinHash parameters of the reference implementation (sketchlib.rust
src/sketch/mod.rs:33-36, src/hashing/nthash_tables.rs:4-15). The per-tap
rotation tables are computed from the seeds with the split-word rotation
`srol`, not transcribed.
"""

from __future__ import annotations

import numpy as np

# --- bindash sketch parameters (src/sketch/mod.rs:33-36) ---
# Number of low bits of each bin minimum kept in the b-bit signature planes.
BBITS = 14
# Signs are taken modulo this Mersenne prime, 2^61 - 1.
SIGN_MOD = (1 << 61) - 1

# Separator byte used in amino-acid sequences for invalid residues / record
# boundaries (src/hashing/mod.rs:14).
SEQSEP = 5

U64 = np.uint64
_MASK64 = (1 << 64) - 1
_MASK33 = (1 << 33) - 1  # low 33 bits  [0..32]


def srol(x: int, n: int) -> int:
    """Split rotate-left applied n times: the 64-bit word is a 33-bit low
    part (bits 0..32) and a 31-bit high part (bits 33..63), each rotated
    left independently (period 33*31 = 1023). The reference's
    swapbits033(rotl(v,1)) (src/hashing/mod.rs:100-103) n times."""
    n = n % 1023
    lo = x & _MASK33
    hi = (x >> 33) & ((1 << 31) - 1)
    r33 = n % 33
    r31 = n % 31
    lo = ((lo << r33) | (lo >> (33 - r33))) & _MASK33 if r33 else lo
    hi = ((hi << r31) | (hi >> (31 - r31))) & ((1 << 31) - 1) if r31 else hi
    return (hi << 33) | lo


# --- ntHash seeds (src/hashing/nthash_tables.rs:4-15) ---
# Indexed by the 2-bit base encoding b = (ascii >> 1) & 3: A=0, C=1, T=2, G=3.
NT_HASH_SEEDS = (
    0x3C8BFBB395C60474,  # A
    0x3193C18562A02B4C,  # C
    0x295549F54BE24456,  # T
    0x20323ED082572324,  # G
)
# Reverse-complement seeds: seed of the complement base (b ^ 2).
NT_RC_HASH_SEEDS = tuple(NT_HASH_SEEDS[b ^ 2] for b in range(4))


def nt_tap_tables(k: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-tap lookup tables for the windowed-XOR formulation of ntHash.

    The forward hash of the k-mer b_0..b_{k-1} is
        fh = XOR_j srol^(k-1-j)( SEED[b_j] )
    and the reverse-complement hash is
        rh = XOR_j srol^j( RC_SEED[b_j] )
    (unrolling the recurrences seeded at src/hashing/nthash_iterator.rs:361-387).

    Returns (fwd, rev), each of shape (k, 4) uint64, where fwd[j, b] is the
    contribution of base b at in-window offset j.
    """
    fwd = np.zeros((k, 4), dtype=U64)
    rev = np.zeros((k, 4), dtype=U64)
    for j in range(k):
        for b in range(4):
            fwd[j, b] = U64(srol(NT_HASH_SEEDS[b], k - 1 - j))
            rev[j, b] = U64(srol(NT_RC_HASH_SEEDS[b], j))
    return fwd, rev


def num_bins(sketch_size: int) -> tuple[int, int, int]:
    """(sketchsize64, signs_size, usigs_size) — src/sketch/mod.rs:49-54.

    sketchsize64 = ceil(sketch_size / 64); the number of bins actually used is
    rounded up to a multiple of 64, and each group of 64 bins is transposed
    into BBITS u64 bit-planes.
    """
    sketchsize64 = (sketch_size + 63) // 64
    return sketchsize64, sketchsize64 * 64, sketchsize64 * BBITS


def universal_hash(s: int, t: int) -> int:
    """Probing hash used by optimal densification (src/sketch/mod.rs:226-231)."""
    x = (s * 1009 + t * 1000003) & _MASK64
    return ((x * 48271 + 11) & _MASK64) % ((1 << 31) - 1)
