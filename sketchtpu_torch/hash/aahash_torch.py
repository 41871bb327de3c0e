"""aaHash + sign + per-(k, sample, bin) minimum: the CUDA kernel
csrc/aahash_bin.cu (one rolling-hash launch for up to 128 k of a batch of
amino-acid or 3Di samples) and its plain PyTorch twin.

Replaces sketchtpu/hash/aahash_jax.py::aa_hash_bin_kernel and
aa_hash_bin_kernel_devmask and aahash_multik.multik_aa_hash_bin_kernel,
with their TPU workarounds (the select trees, the prefix and rotate-select
variants, the host or device mask passes, the sort-based bin minima).

Input layout (pack_aa_group): one byte per residue of a batch of
concatenated samples, code | INVALID | START: code is AA_COMPACT's 5-bit
code (0..19 for the level's letters, 20 for anything else, SEQSEP
included), INVALID marks a residue no window may hold and START the first
residue of every sample; `starts` holds each sample's offset. Output:
(k, samples, nbins) int64 holding u64 sign bit patterns, with empty bins
at u64::MAX (-1), and (k, samples) int32 reachability flags: 1 where the
sample emitted a window other than its final one at that k (the host
oracle raises where no such window exists, aahash_np.aa_window_valid).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from ..constants import AA_SEED_TABLES, aa_tap_table, srol
from .nthash_torch import (
    _check_batch,
    _check_kmers,
    _in_kmers_order,
    bin_size,
    k_groups,
    magic_divisor,
)

AA_LETTERS = b"ACDEFGHIKLMNPQRSTVWY"
INVALID = 0x20
START = 0x40
# 256-entry byte -> compact code (0..19, either case); every other byte,
# SEQSEP included, -> 20, whose seed is 0
AA_COMPACT = np.full(256, 20, dtype=np.uint8)
for _i, _c in enumerate(AA_LETTERS):
    AA_COMPACT[_c] = _i
    AA_COMPACT[_c + 32] = _i  # lowercase
_PACK = np.where(AA_COMPACT == 20, 20 | INVALID, AA_COMPACT).astype(np.uint8)

# The kernel's limit: the block's staged span of residues (256 runs + the
# largest k) and the per-k tables share the block's shared memory
MAX_K_AA_CUDA = 16384
_NT = 256  # threads per block of aahash_bin.cu
_KG = 4  # k rolled together
_RUNS = tuple(range(4, 61, 8))  # run lengths: run / 4 odd (bank-free reads)
_NC = 32  # table words per k, one per 5-bit code
_SMIN_BYTES = 32 * 1024  # the most shared memory of the sign caches
_I64_MAX = (1 << 63) - 1


def pack_aa_group(streams) -> tuple[np.ndarray, np.ndarray]:
    """(codes, starts): the kernel's uint8 input for a batch of AaStreams
    and the int64 sample start offsets."""
    lens = [s.seq_len for s in streams]
    codes = np.empty(sum(lens), dtype=np.uint8)
    starts = np.zeros(len(streams), dtype=np.int64)
    pos = 0
    for g, (s, n) in enumerate(zip(streams, lens)):
        starts[g] = pos
        np.take(_PACK, s.seq, out=codes[pos : pos + n])
        if n:
            codes[pos] |= START  # windows never cross a sample boundary
        pos += n
    return codes, starts


@functools.lru_cache(maxsize=96)
def _tap_rows(k: int, level: int) -> np.ndarray:
    """(k, 32) int64 per-tap tables over the compact codes (u64 bit
    patterns; rows 20..31 zero)."""
    tab = aa_tap_table(k, level)
    out = np.zeros((k, _NC), dtype=np.uint64)
    out[:, :20] = tab[:, np.frombuffer(AA_LETTERS, dtype=np.uint8)]
    return out.view(np.int64)


def _aahash_bin_ref(codes: torch.Tensor, k: int, level: int,
                    starts: torch.Tensor, nbins: int):
    """The twin at one k: ((samples, nbins) int64 minima, (samples,) int32
    reachability)."""
    dev = codes.device
    n, total = starts.numel(), codes.numel()
    table = torch.full((n * nbins,), _I64_MAX, dtype=torch.int64, device=dev)
    reach = torch.zeros(n, dtype=torch.int32, device=dev)
    m = total - k + 1
    if m > 0:
        v = codes.to(torch.int64)
        code, inv, st = v & 31, (v >> 5) & 1, (v >> 6) & 1
        taps = torch.from_numpy(_tap_rows(k, level)).to(dev)
        fh = torch.zeros(m, dtype=torch.int64, device=dev)
        for j in range(k):
            fh ^= taps[j][code[j : j + m]]
        x = (fh & ((1 << 61) - 1)) + ((fh >> 61) & 7)
        x = torch.where(x >= (1 << 61) - 1, x - ((1 << 61) - 1), x)
        zero = torch.zeros(1, dtype=torch.int64, device=dev)
        icum = torch.cat([zero, torch.cumsum(inv, 0)])
        scum = torch.cat([zero, torch.cumsum(st, 0)])
        # all k residues valid, and no sample starts at s + 1 .. s + k - 1
        ok = ((icum[k : k + m] - icum[:m]) == 0) & (
            (scum[k : k + m] - scum[1 : m + 1]) == 0)
        pos = torch.arange(m, dtype=torch.int64, device=dev)
        sample = torch.searchsorted(starts, pos, right=True) - 1
        ends = torch.cat([starts[1:], torch.full_like(zero, total)])
        final = pos + k == ends[sample]
        # the final window also needs residue s - 1 valid, in its sample
        before = torch.zeros(m, dtype=torch.bool, device=dev)
        before[1:] = inv[: m - 1] == 0
        emit = ok & (~final | (before & (st[:m] == 0)))
        idx = sample * nbins + torch.div(x, bin_size(nbins),
                                         rounding_mode="floor")
        table.scatter_reduce_(0, idx[emit], x[emit], reduce="amin")
        nonfinal = sample[ok & ~final]
        reach.scatter_reduce_(0, nonfinal, torch.ones_like(
            nonfinal, dtype=torch.int32), reduce="amax")
    table[table == _I64_MAX] = -1
    return table.view(n, nbins), reach


def aahash_bin_multi_ref(codes: torch.Tensor, kmers, level: int,
                         starts: torch.Tensor, nbins: int):
    """Plain PyTorch twin of aahash_bin_multi(): per k a k-tap gather, the
    emission mask by cumsums, the Mersenne fold and a scatter_reduce amin;
    stacked."""
    planes, reach = zip(*(_aahash_bin_ref(codes, k, level, starts, nbins)
                          for k in kmers))
    return torch.stack(planes), torch.stack(reach)


@functools.lru_cache(maxsize=64)
def _k_table(kmers: tuple[int, ...], level: int) -> np.ndarray:
    """The kernel's table for ascending kmers: per k, srol^k(SEED[c]) for
    the 32 codes, k; then SEED[c]."""
    col = AA_SEED_TABLES[level]
    seeds = [int(col[c]) for c in AA_LETTERS] + [0] * (_NC - 20)
    words = []
    for k in kmers:
        words += [srol(s, k) for s in seeds] + [k]
    words += seeds
    return np.array(words, dtype=np.uint64).view(np.int64)


def _smem_bytes(nk: int, kmax: int, nbins: int, smin: bool,
                run: int) -> int:
    return ((nk * (_NC + 1) + _NC) * 8
            + (min(_KG, nk) * nbins * 4 if smin else 0) + _NT * run + kmax + 1)


def run_shape(windows: int, slots: int, kmax: int, nk: int
              ) -> tuple[int, int]:
    """(run, tiles): window starts a thread and tiles of 256 runs a block,
    for `windows` starts on a card of `slots` resident blocks. Of the run
    lengths with run / 4 odd, the one with the least cost per slot: the
    most tiles any slot walks (whole waves of equal blocks) times the run
    plus the Horner start that each run pays (about 3 + kmax / (3 nk)
    windows)."""
    horner = 3 + kmax / (3 * nk)
    best = None
    for run in _RUNS:
        runs = -(-windows // (_NT * run))  # tiles of the whole batch
        tiles = -(-runs // slots)  # at one block a slot, one wave
        cost = (tiles * (run + horner), run)
        if best is None or cost < best[0]:
            best = (cost, run, tiles)
    return best[1], best[2]


def pow2_shift(nbins: int) -> int:
    """61 - log2(nbins) where nbins is a power of two, else -1: then sign
    >> it is sign // bin_size(nbins) for every sign below 2^61 - 1
    (bin_size is 2^(61 - log2 nbins), or 2^61 - 1 at one bin, where both
    give bin 0)."""
    if nbins & (nbins - 1):
        return -1
    return 61 - (nbins.bit_length() - 1)


def aahash_bin_multi(codes: torch.Tensor, kmers, level: int,
                     starts: torch.Tensor, nbins: int):
    """((len(kmers), samples, nbins) int64 per-bin sign minima,
    (len(kmers), samples) int32 reachability) of a packed batch at every k
    of kmers: one launch per MAX_NK_CUDA k (k_groups), all writing into one
    output. CUDA tensors launch the kernel, CPU tensors run the twin."""
    _check_batch(codes, starts, nbins)
    kmers = _check_kmers(kmers)
    if level not in AA_SEED_TABLES:
        raise ValueError(f"level={level}: expected 1, 2 or 3")
    if codes.device.type == "cpu":
        return aahash_bin_multi_ref(codes, kmers, level, starts, nbins)
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    if max(kmers) > MAX_K_AA_CUDA:
        raise ValueError(
            f"kmers={kmers}: the kernel's limit is k <= {MAX_K_AA_CUDA}")
    groups = k_groups(kmers)
    out = torch.full((len(kmers), starts.numel(), nbins), -1,
                     dtype=torch.int64, device=codes.device)
    reach = torch.zeros((len(kmers), starts.numel()), dtype=torch.int32,
                        device=codes.device)
    g0 = 0
    for g in groups:
        ks = [kmers[p] for p in g]
        if codes.numel() >= ks[0]:  # else no window fits: the rows stay empty
            rows = slice(g0, g0 + len(g))
            _launch(codes, ks, level, starts, nbins, out[rows], reach[rows])
            aahash_bin_multi.launches += 1
        g0 += len(g)
    return _in_kmers_order(out, groups), _in_kmers_order(reach, groups)


aahash_bin_multi.launches = 0


def _launch(codes, ks, level, starts, nbins, out, reach):
    """One launch for at most MAX_NK_CUDA ascending ks into the rows out
    (len(ks), samples, nbins), filled with -1, and reach, filled with 0."""
    # a block filters its first sample's signs through a shared-memory cache
    # per k rolled together (4 bytes a bin) where the caches fit
    # _SMIN_BYTES; else every sign reads its slot in device memory first
    smin = min(_KG, len(ks)) * nbins * 4 <= _SMIN_BYTES
    shift = pow2_shift(nbins)
    slots = _slots(len(ks), ks[-1], nbins, smin, shift >= 0, codes.device)
    run, tiles = run_shape(codes.numel() - ks[0] + 1, slots, ks[-1], len(ks))
    ktab = torch.from_numpy(_k_table(tuple(ks), level)).to(codes.device)
    magic, mshift = magic_divisor(bin_size(nbins)) if shift < 0 else (0, shift)
    _build.launch(
        codes.device, "stpu_aahash_multi",
        codes.data_ptr(), codes.numel(), ktab.data_ptr(), len(ks), ks[0],
        starts.data_ptr(), starts.numel(), magic, mshift, int(shift >= 0),
        nbins, run, tiles, int(smin),
        _smem_bytes(len(ks), ks[-1], nbins, smin, run), out.data_ptr(),
        reach.data_ptr(), what="aahash_bin_multi",
    )


@functools.lru_cache(maxsize=64)
def _slots(nk: int, kmax: int, nbins: int, smin: bool, pow2: bool,
           device: torch.device) -> int:
    """Resident blocks on the card at the longest run's shared memory."""
    per_sm = _build.query(
        device, "stpu_aahash_blocks_per_sm",
        _smem_bytes(nk, kmax, nbins, smin, _RUNS[-1]), int(pow2))
    if per_sm < 1:
        raise RuntimeError("aahash_bin_multi: the kernel does not fit an SM")
    return per_sm * torch.cuda.get_device_properties(
        device).multi_processor_count
