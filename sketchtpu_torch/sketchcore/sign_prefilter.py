"""The reads path's sign prefilter on the card: the hand kernel
csrc/sign_prefilter.cu (its keep mask), its plain PyTorch twin, and the
sort and compaction around it.

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

For one k and one segment, the signs as nthash_signs writes them (int64,
-1 for an invalid window):
1. invalid windows and signs of no bin become INT64_MAX, which sorts last
   (sorted_keys), and a stable torch.sort puts each sign's occurrences in
   one run, in stream order (the sort's indices are their positions);
   bins are contiguous ranges of runs;
2. the kernel, for run r with pmc(r) the position of its min_count-th
   occurrence (none if the run is shorter), keeps the occurrence at p of
   run r in bin b iff min{pmc(r') : r' < r in b} >= p, as a flag at p;
3. torch.masked_select gathers the kept signs in stream order
   (survivors); sizing its output is the one sync of a row.

The XLA program needs two full-length sorts, segmented forward and
backward min-scans and, for the TPU compiler, scans blocked into rows; on
the card one sort stays and the rest is one kernel and one gather.
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
    """(keys, pos): the kernel's input for one row of signs, the signs of a
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
    """Plain PyTorch twin of sign_prefilter_keep()."""
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


def sign_prefilter_keep(keys: torch.Tensor, pos: torch.Tensor,
                        min_count: int, nbins: int) -> torch.Tensor:
    """(m,) bool flags at stream positions, True where the occurrence is
    kept, of one row's sorted_keys (keys, pos). CUDA tensors launch the
    kernel (one block per bin), CPU tensors run the twin."""
    _check(keys, pos, min_count, nbins)
    if keys.device.type == "cpu":
        return sign_prefilter_keep_ref(keys, pos, min_count, nbins)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    flags = torch.zeros(keys.numel(), dtype=torch.bool, device=keys.device)
    if keys.numel():
        _build.launch(keys.device, "stpu_sign_prefilter_keep",
                      keys.data_ptr(), pos.data_ptr(), keys.numel(),
                      min_count, bin_size(nbins), nbins, flags.data_ptr(),
                      what="sign_prefilter_keep")
        sign_prefilter_keep.launches += 1
    return flags


sign_prefilter_keep.launches = 0


def keep_flags(signs: torch.Tensor, nbins: int, min_count: int,
               keep=sign_prefilter_keep) -> list[torch.Tensor]:
    """The keep flags of each row of (rows, m) int64 signs; nothing is
    synchronised."""
    return [keep(*sorted_keys(row, nbins), min_count, nbins) for row in signs]


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
                                      sign_prefilter_keep_ref))[0]
