"""Algorithm constants of the DNA and amino-acid paths.

The published ntHash seeds (Mohamadi et al. 2016,
doi:10.1093/bioinformatics/btw397) and the bindash-style binned
bottom-MinHash parameters of the reference implementation (sketchlib.rust
src/sketch/mod.rs:33-36, src/hashing/nthash_tables.rs:4-15). The per-tap
rotation tables are computed from the seeds with the split-word rotation
`srol`, not transcribed. The aaHash seeds of the three reduced-alphabet
levels are the reference's (src/hashing/aahash_tables.rs).
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


# --- aaHash seeds (src/hashing/aahash_tables.rs:38-58, 2020-2031, 3562-3571) ---
_AA_SEEDS_L1 = {
    "A": 0xF56D6192468323DF,
    "C": 0x9B0B2FD724E1E1D2,
    "D": 0xE8C583296B03C7AF,
    "E": 0x06D8186850EE2F67,
    "F": 0x921E1DA156B717AD,
    "G": 0xA70DC450015E3FFE,
    "H": 0x2242263A9D5638FF,
    "I": 0x2469CA06D519CDEF,
    "K": 0xD4E7F06AC0593D3B,
    "L": 0xA5E19C0B1B40A97F,
    "M": 0xFAB3D6D4DD74C000,
    "N": 0x4B363F2CF7BC5200,
    "P": 0x21AC8AF2ADB65CE4,
    "Q": 0x1D3BAAE9AB7CD800,
    "R": 0x049015253A9DBEDF,
    "S": 0x5BF1F1D7AE699000,
    "T": 0xDB0C63DD7282CF90,
    "V": 0x7DF64DDF78874000,
    "W": 0xEE9E700CAE6AA279,
    "Y": 0x5852FFB781A97610,
}

# Level 2 groups T,S; D,E; Q,K,R; V,I,L,M; W,F,Y (src/hashing/mod.rs:19-27).
_L2_GROUP_SEEDS = {
    "C": 0x1D07FD644ABE9962,
    "G": 0xF59C50929BDF4360,
    "A": 0x6F735C82FE9C6C03,
    "TS": 0xE7392F0BA1DBC3B0,
    "N": 0x956DDCFCD4B3961F,
    "DE": 0x4EC0EF1BAC4F5EFA,
    "QKR": 0x1CD6CA491872ED78,
    "VILM": 0x547EF17894921035,
    "WFY": 0x419722EDB87BF79F,
    "H": 0xDD5CCE5BFDC32DE1,
    "P": 0x90E0C5E0C07D6598,
}
# Level 3 additionally groups A with T,S and N with D,E.
_L3_GROUP_SEEDS = {
    "C": 0x5713E4C10CEBBFA3,
    "G": 0xBE084B869537379B,
    "ATS": 0x985FD9EFA0FE5B82,
    "NDE": 0x9ACA6C4F4EF69DF0,
    "QKR": 0x917DE473B721DF0E,
    "VILM": 0x37CDD84AA07C5BD7,
    "WFY": 0x51A7955F1A67A896,
    "H": 0x1D2A0BA493708FBF,
    "P": 0xFE4C47DA16611245,
}


def _aa_seed_table(groups: dict[str, int]) -> np.ndarray:
    """Build a 256-entry seed table from per-group seeds; invalid bytes get 0.

    Upper- and lowercase letters share an entry, matching the reference's
    generated AA_SEED_TABLE layout (src/hashing/aahash_tables.rs:60+).
    """
    table = np.zeros(256, dtype=U64)
    for group, seed in groups.items():
        for aa in group:
            table[ord(aa.upper())] = U64(seed)
            table[ord(aa.lower())] = U64(seed)
    return table


AA_SEED_TABLES = {
    1: _aa_seed_table(_AA_SEEDS_L1),
    2: _aa_seed_table(_L2_GROUP_SEEDS),
    3: _aa_seed_table(_L3_GROUP_SEEDS),
}


def aa_tap_table(k: int, level: int) -> np.ndarray:
    """Per-tap lookup table for aaHash: fh = XOR_j srol^(k-1-j)(SEED[aa_j]).

    Shape (k, 256) uint64.
    """
    seeds = AA_SEED_TABLES[level]
    out = np.zeros((k, 256), dtype=U64)
    for j in range(k):
        rot = (k - 1 - j) % 1023
        r33 = np.uint64(rot % 33)
        r31 = np.uint64(rot % 31)
        lo = seeds & U64(_MASK33)
        hi = seeds >> U64(33)
        m33 = U64(_MASK33)
        m31 = U64((1 << 31) - 1)
        lo = ((lo << r33) | (lo >> (U64(33) - r33))) & m33 if rot % 33 else lo
        hi = ((hi << r31) | (hi >> (U64(31) - r31))) & m31 if rot % 31 else hi
        out[j] = (hi << U64(33)) | lo
    return out


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
