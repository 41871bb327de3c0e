"""The reads path's sign prefilter on the card: one row of signs (one k,
one segment of a read stream) to its keep flags in the hand kernels of
csrc/sign_prefilter.cu, their plain PyTorch twin, and the gather after
them.

Port of sketchtpu/sketchcore/sign_prefilter.py::prefilter_signs_device
(an XLA program), opted into as there with SKETCHTPU_FASTQ_PREFILTER=1
(or "on") for --min-count >= 2.

The host's count filter (signs.bin_minima_filtered, sketch/mod.rs:198-208)
consults an occurrence of sign s in bin b only while s < bins[b], and
bins[b] only falls. Once a sign t < s of bin b has had min_count
occurrences, the filter has either passed t (bins[b] <= t) or skipped one
of them (bins[b] <= t already), so no later occurrence of s is consulted;
an unconsulted occurrence changes neither the bloom filter, the counts nor
the bins. Dropping those occurrences, and the signs of no bin, leaves a
subsequence whose replay through the unchanged filter gives the same bins
bit for bit, bloom false positives included. Within a segment of the
stream a sign reaches its min_count-th occurrence no earlier than in the
whole stream, so the survivors of any segmentation, concatenated in order,
replay to the same bins too.

The rule, for one row of signs as nthash_signs writes them (int64, -1 for
an invalid window): order the binned windows of each bin by (sign,
position), so that runs hold one sign's occurrences in stream order; with
pmc(r) the position of run r's min_count-th occurrence (none if the run is
shorter), keep the occurrence at p of run r in bin b iff
min{pmc(r') : r' < r in b} >= p. The twin states it with a stable
torch.sort (sorted_keys) and scans (sign_prefilter_keep_ref).

On the card (sign_prefilter_flags) one call launches the kernels of
csrc/sign_prefilter.cu: a stable partition of the binned windows into
2^bucket_bits(m) contiguous key ranges of (sign, 32-bit position), in
one or two passes of at most 8 key bits (a count, two scans of the
counts and a scatter staged in shared memory each), the buckets' starts,
then one block per bucket that orders it on chip and applies the rule,
with the min pmc of a bin's earlier buckets passed by a decoupled
look-back. The first count zeroes the flags; the last kernel sets the
kept ones. torch.masked_select then gathers the kept signs in stream
order (survivors); sizing its output is the one sync of a row.
"""

from __future__ import annotations

import os

import torch

from .. import _build
from ..hash.nthash_torch import bin_size

_NONE = torch.iinfo(torch.int64).max  # no sign (sorts last), no position


def enabled(min_count: int) -> bool:
    """Whether the reads path prefilters: SKETCHTPU_FASTQ_PREFILTER in
    ("1", "on") (off by default) and min_count >= 2, as in the JAX
    package."""
    return min_count >= 2 and os.environ.get(
        "SKETCHTPU_FASTQ_PREFILTER", "0") in ("1", "on")


def sorted_keys(signs: torch.Tensor, nbins: int):
    """(keys, pos): the twin's order of one row of signs, the signs of a
    bin sorted stably with the rest (invalid windows, signs past the last
    bin) at INT64_MAX after them, and each one's position in the row."""
    top = nbins * bin_size(nbins)
    keys = torch.where((signs >= 0) & (signs < top), signs, _NONE)
    return torch.sort(keys, stable=True)


def _check(keys: torch.Tensor, pos: torch.Tensor, min_count: int,
           nbins: int) -> None:
    for name, t in (("keys", keys), ("pos", pos)):
        if t.dtype != torch.int64 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int64 tensor")
    if pos.shape != keys.shape or pos.device != keys.device:
        raise ValueError("keys and pos must have one shape and device")
    if min_count < 1 or nbins < 1:
        raise ValueError(f"min_count={min_count} and nbins={nbins} must be "
                         f"positive")


def sign_prefilter_keep_ref(keys: torch.Tensor, pos: torch.Tensor,
                            min_count: int, nbins: int) -> torch.Tensor:
    """The keep flags of one row's sorted_keys (keys, pos): (m,) bool at
    stream positions. With sorted_keys, the twin of the kernels."""
    _check(keys, pos, min_count, nbins)
    m = keys.numel()
    flags = torch.zeros(m, dtype=torch.bool, device=keys.device)
    bs = bin_size(nbins)
    n = int(torch.searchsorted(keys, nbins * bs))
    if n == 0:
        return flags
    k, p = keys[:n], pos[:n]
    new_run = torch.ones(n, dtype=torch.bool, device=k.device)
    new_run[1:] = k[1:] != k[:-1]
    starts = torch.nonzero(new_run).flatten()
    lens = torch.diff(starts, append=starts.new_tensor([n]))
    # m stands for no position: positions are below it
    pmc = torch.where(lens >= min_count,
                      p[torch.clamp(starts + min_count - 1, max=n - 1)], m)
    run_bin = torch.div(k[starts], bs, rounding_mode="floor")
    new_bin = torch.ones(starts.numel(), dtype=torch.bool, device=k.device)
    new_bin[1:] = run_bin[1:] != run_bin[:-1]
    # min over the earlier runs of a bin: a running min over all runs in
    # which a later bin's values all lie below an earlier bin's, then each
    # run reads the value of the run before it in its bin
    seg = torch.cumsum(new_bin, 0) - 1
    lift = (seg[-1] - seg) * (m + 1)
    running = torch.cummin(pmc + lift, 0).values - lift
    before = torch.full_like(running, m)
    before[1:] = torch.where(new_bin[1:], m, running[:-1])
    run_of = torch.cumsum(new_run, 0) - 1
    flags[p[before[run_of] >= p]] = True
    return flags


# the kernels' constants (csrc/sign_prefilter.cu): most bucket bits,
# windows of a bucket ordered in shared memory, windows a partition tile,
# a partition pass's digits, the partition scan's chunk sums
MAX_BITS, CAP, TILE, DIGITS, SCAN_SUMS = 16, 4096, 8192, 256, 8192
# rows of at most this many windows (32-bit positions and offsets)
MAX_WINDOWS = (1 << 30) - 1


def bucket_bits(m: int) -> int:
    """Key bits of the partition's buckets for a row of m windows: 2^bits
    buckets of at most 2048 windows on average (up to MAX_BITS), so that
    a bucket of uniform hashes fits CAP."""
    return min(MAX_BITS, ((m - 1) >> 11).bit_length()) if m > 0 else 0


def workspace_words(m: int, bits: int) -> int:
    """int32 words of the kernels' workspace: a pass's per-tile digit
    counts and its scan's chunk sums, both passes' binned windows, the
    buckets' starts, the ticket."""
    return -(-m // TILE) * DIGITS + SCAN_SUMS + (1 << bits) + 4


def _check_row(row: torch.Tensor, min_count: int, nbins: int) -> None:
    if row.dtype != torch.int64 or row.dim() != 1 or not row.is_contiguous():
        raise ValueError("a row of signs must be a contiguous 1-D int64 "
                         "tensor")
    if row.numel() > MAX_WINDOWS:
        raise ValueError(f"a row of {row.numel()} windows is past the "
                         f"kernels' {MAX_WINDOWS}")
    if min_count < 1 or not 1 <= nbins < (1 << 30) - 1:
        raise ValueError(f"min_count={min_count} and nbins={nbins} must be "
                         f"positive (nbins below 2^30 - 1)")


def sign_prefilter_flags_ref(row: torch.Tensor, nbins: int,
                             min_count: int) -> torch.Tensor:
    """Plain PyTorch twin of sign_prefilter_flags()."""
    _check_row(row, min_count, nbins)
    return sign_prefilter_keep_ref(*sorted_keys(row, nbins), min_count,
                                   nbins)


def sign_prefilter_flags(row: torch.Tensor, nbins: int, min_count: int, *,
                         bits: int | None = None,
                         cap: int = CAP) -> torch.Tensor:
    """(m,) bool flags at stream positions, True where the occurrence is
    kept, of one (m,) int64 row of signs (-1 for an invalid window). CUDA
    tensors launch the kernels (2^bits buckets, bucket_bits(m) by default;
    buckets past `cap` windows sorted in device memory; the partition and
    the scratch take 24 bytes a window), CPU tensors run the twin."""
    _check_row(row, min_count, nbins)
    if row.device.type == "cpu":
        return sign_prefilter_flags_ref(row, nbins, min_count)
    if row.device.type != "cuda":
        raise ValueError(f"unsupported device {row.device}")
    m = row.numel()
    bits = bucket_bits(m) if bits is None else bits
    if not 0 <= bits <= MAX_BITS or not 1 <= cap <= CAP:
        raise ValueError(f"bits={bits} must be in [0, {MAX_BITS}] and "
                         f"cap={cap} in [1, {CAP}]")
    flags = torch.empty(m, dtype=torch.bool, device=row.device)
    if m == 0:
        return flags

    def empty(n, dtype):
        return torch.empty(n, dtype=dtype, device=row.device)

    ws = empty(workspace_words(m, bits), torch.int32)
    status = empty(1 << bits, torch.int64)  # the look-back's words
    part = empty(m, torch.int64), empty(m, torch.int32)
    scratch = empty(m, torch.int64), empty(m, torch.int32)
    _build.launch(row.device, "stpu_sign_prefilter", row.data_ptr(), m,
                  min_count, bin_size(nbins), nbins, bits, cap,
                  ws.data_ptr(), status.data_ptr(), part[0].data_ptr(),
                  part[1].data_ptr(), scratch[0].data_ptr(),
                  scratch[1].data_ptr(), flags.data_ptr(),
                  what="sign_prefilter")
    sign_prefilter_flags.launches += 1
    return flags


sign_prefilter_flags.launches = 0


def keep_flags(signs: torch.Tensor, nbins: int, min_count: int,
               keep=sign_prefilter_flags) -> list[torch.Tensor]:
    """The keep flags of each row of (rows, m) int64 signs; nothing is
    synchronised."""
    return [keep(row, nbins, min_count) for row in signs]


def survivors(signs: torch.Tensor, flags: list[torch.Tensor]):
    """The kept signs of each row of (rows, m) signs, in stream order: one
    sync a row (the first waits for the rows' work, the others do not)."""
    return [torch.masked_select(row, f) for row, f in zip(signs, flags)]


def prefilter_signs(signs: torch.Tensor, nbins: int,
                    min_count: int) -> torch.Tensor:
    """The kept signs of one (m,) int64 row of signs (-1 for an invalid
    window), in stream order: a subsequence whose replay through
    bin_minima_filtered gives the row's bins."""
    rows = signs.view(1, -1)
    return survivors(rows, keep_flags(rows, nbins, min_count))[0]


def prefilter_signs_ref(signs: torch.Tensor, nbins: int,
                        min_count: int) -> torch.Tensor:
    """Plain PyTorch twin of prefilter_signs()."""
    rows = signs.view(1, -1)
    return survivors(rows, keep_flags(rows, nbins, min_count,
                                      sign_prefilter_flags_ref))[0]
