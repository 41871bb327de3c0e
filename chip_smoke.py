#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sketchtpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

1. Builds the port's CUDA kernels from sketchtpu_torch/csrc.
2. Holds every kernel against its plain PyTorch twin on the card at the
   main path's shapes (sketch size 1000 -> s64 = 16, k = 17..29 step 2,
   k = 6, 9, 12 for amino acids; K1 also on the first strip of a
   100,000-sample dense run, K4 also at 40,000 bins), and times both with CUDA events, beside the least time
   the card could take (bound: operations at the table rate, or bytes at
   3.35 TB/s) and the integer-issue floor of the samebits kernels.
   Before any timing of `pair_count` and the signs mode it prints the
   compare microbenchmark (XOR / IADD / LOP3 against the DPX
   VIADDMNMX.U16x2 a word, at the full grid), pair_count's SASS (the DPX
   opcode required) and both kernels' registers (no spills). The reads
   path's sign prefilter (its five kernels, one row of signs to its keep
   flags, and the compaction) is held against its twins at seeds and on
   a 2^24-window segment of phase 6's first sample at k = 17, --min-count
   5 (timed, kernel by kernel too, beside torch.sort of the same keys),
   and that sample's kept fraction is printed by segment length, every
   segment and the whole row bit-equal. K2 (plain, key and masked key
   mode) and coreacc_chain also run at 300 k (512 x 2048), past the k
   table K2 takes by value, each bit-equal to its twin.
3. Drives the two paths through the port's CLI and checks them against
   `python -m sketchtpu.cli` on its NumPy host oracle (run as a separate
   process): the dense path (`sketch` of 8 synthetic 2 Mb assemblies, then
   dense `dist` self and ref-vs-query: -k 17, --ani, --exact, f32
   core/accessory; .skd/.skm and the exact outputs byte for byte, f32
   core/accessory within 1e-5; the same assemblies sketched at 40,000
   bins, where `dist -k 17` and `--exact` run on K4, byte for byte; 8
   assemblies of 20 kb sketched at `--k-seq 15,314,1`, 300 k, then dense
   and `--knn 3` core/accessory, self and cross) and the kNN path (`dist --knn 3`, self and cross, -k 17, --ani,
   core/accessory, each with and without completeness; byte for byte).
4. Dense path at scale: dense dist on 8192 samples derived from those
   sketches (33.5 M pairs).
   The kNN path also runs `dist -k 17 --knn 1025` on 1100 derived samples
   (past K3's selection limit: its tile keys and the top-k merge), byte
   for byte. The reads + inverted path: `sketch` of synthetic FASTQ (a
   500 kb genome at 10x, single and paired files), alone and mixed with
   the 8 assemblies, at --min-count 1, 2, 3, each also with the sign
   prefilter on (SKETCHTPU_FASTQ_PREFILTER=1, as both inverted builds);
   `inverted build` (-s 100 and
   the default -s 1000 with --species-names and --metadata), `info` on the
   .ski, `inverted query` of every --query-type, `precluster --count`,
   `precluster --skd --knn 3` (-k 17, --ani, completeness, --retain-
   unmatched singleton and bruteforce, --core-acc), every output byte for
   byte against the host oracle, and one `inverted serve` round.
5. kNN path at scale: `dist -k 17 --knn 50` over 100,000 derived samples
   (one K3 selection launch; its profile must hold no top-k, sort or
   concatenation kernel) and core/accessory `dist --knn 50` over the first
   50,000, with the selection and values of 512 random rows checked
   against full rows.
6. Reads and the inverted index at the sizes users run: 2 read samples of
   50 Mb each (a 2 Mb genome at 25x) at 7 k and --min-count 5, with the
   sign prefilter off and on (byte-identical; walls, bytes copied to the
   host, signs into the count filter, the card's busy share); an index
   of 661,000 samples at S = 100, k = 17 (the reference's published
   `precluster --count` size), with `info`, `precluster --count` and the 8
   assemblies queried; `precluster --skd --knn 50` over phase 5's 100,000
   samples and --core-acc over its first 50,000, 512 rows of each against
   the host oracle.
7. The amino-acid path: phase 2 holds the aaHash kernel against its twin
   (16 x 1,200,000 residues, k = 6, 9, 12, levels 1 and 3, bins and
   reachability flags bit for bit); phase 3 runs `sketch --seq-type aa`
   at levels 1-3 with and without --concat-fasta, `--seq-type pdb` on 3Di
   text, `append`, and dense -k 9, core/accessory and `-k 9 --knn 3` on the
   AA database against the host oracle (a final-window-only record refused
   by both); phase 7 sketches 256 synthetic proteomes of 1.2 M residues at
   k = 6, 9, 12 (wall, Maa-k/s, the card's busy share; the first 8 rows
   against the host oracle) and runs dense core/accessory `dist` on them.
8. Multi-process runs: two ranks on the one card, each a spawned process
   under torchrun's variables (one gloo process group), run phases 4-7's
   commands and phase 3's index commands (`dist --knn 50` -k 17 at
   100,000 and core/acc at 50,000, dense core/acc and -k 17 at 8192,
   `precluster --count` at 661,000, `precluster --skd --knn 50`, `sketch
   --seq-type aa` of the 256 proteomes, `sketch` of phase 6's reads with
   the prefilter on, `inverted build` and `query`);
   the parts in rank order, rank 0's merge or its printed total must
   equal the single-process output byte for byte, and each rank must
   launch its path's kernels; each rank's wall and compute window are
   printed beside the single-process wall. Then 5 ranks by
   --process-id/--n-processes on 3 samples: the surplus ranks write empty
   parts and launch nothing.

9. One process on several devices (run before phase 8): the CLI with
   runtime.devices giving every GPU, or on a host with one, slots of the
   card (2 for the multi-device engines of shard/mesh.py, 3 for the
   round-robin sketching), runs phases 3-7's commands at their full sizes
   (`sketch` of the 8 assemblies, of the 2 read samples (prefilter off and
   on) and of the 256 proteomes, dense core/acc at 8192, `dist -k 17` at 40,000 bins (K4),
   `--knn 50` at 100,000 and core/acc at 50,000, `precluster --count` and
   the 8 queries at 661,000, `precluster --skd --knn 50` at 100,000):
   every output byte-identical to the one-device run, each wall printed
   beside the one-device wall, and whether the devices were distinct
   GPUs. Phase 3 also runs `--knn 0` (dist self and cross, precluster
   plain, bruteforce and singleton) against the host oracle.

10. The words axis of shard/mesh.py (library surface): 4096 samples at
   102,400 bins and 7 k on grids 1 x 2, 2 x 2, 1 x 4 and 1 x 16 (past the
   finish's 8 partials: each lead folds them first), each step bit-equal
   to the unsplit kernels, with each lead's timeline; the 2 x 2 dense
   stream; the JAX dry run's 4 x 2 sequence.

Each path's kernel launches are counted from 0 over its phases (in each
rank's process for phase 8); the run fails if a kernel of a path was
never launched there. Any failure exits
non-zero. The second-to-last stdout line is the kernels' JSON record, the
last one {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "chip_smoke_work"
KMERS = (17, 19, 21, 23, 25, 27, 29)
SKETCH_SIZE = 1000
S64 = 16
ATOL = 1e-5
N_SCALE = 8192
N_KNN = 100_000  # phase 5: single-k kNN samples
N_KNN_CA = 50_000  # phase 5: core/accessory kNN samples (the first ones)
KNN = 50
CHECK_ROWS = 512
SEED = 20261016
N_INDEX = 661_000  # phase 6: samples of the derived index
INDEX_SIZE, INDEX_K = 100, 17
N_CLUSTERS = 2_000  # independent clusters of its signs
READS_GENOME, READS_COVERAGE = 2_000_000, 25
READS_ORACLE_KMERS = (17, 29)  # the host oracle's k at 50 Mb of reads
THREADS = "8"
# phase 8 reads these from the phases that ran each command in one
# process: the wall of the run, and for phase 4's outputs (deleted to save
# the disk) their SHA-256
SINGLE_WALL: dict[str, float] = {}
SINGLE_SHA256: dict[str, str] = {}

SOURCES = {
    "samebits": ("sketchtpu_torch/csrc/samebits.cu",
                 "sketchtpu/dist/pallas_kernels.py:136"),
    "coreacc": ("sketchtpu_torch/csrc/coreacc.cu",
                "sketchtpu/dist/coreacc_pallas.py:100"),
    "knn_select": ("sketchtpu_torch/csrc/knn_scan.cu",
                   "sketchtpu/dist/pallas_kernels.py:47"),
    "samebits_full": ("sketchtpu_torch/csrc/samebits.cu",
                      "sketchtpu/dist/pallas_kernels.py:265"),
    "nthash_bin_multi": ("sketchtpu_torch/csrc/nthash_bin.cu",
                         "sketchtpu/hash/nthash_jax.py:227"),
    "knn_keys": ("sketchtpu_torch/csrc/knn_scan.cu",
                 "sketchtpu/dist/pallas_kernels.py:47"),
    "nthash_signs": ("sketchtpu_torch/csrc/nthash_bin.cu",
                     "sketchtpu/hash/nthash_jax.py:336"),
    "signeq_count": ("sketchtpu_torch/csrc/signeq.cu",
                     "sketchtpu/inverted/device.py:134"),
    "signeq_any": ("sketchtpu_torch/csrc/signeq.cu",
                   "sketchtpu/inverted/device.py:134"),
    "signeq_all": ("sketchtpu_torch/csrc/signeq.cu",
                   "sketchtpu/inverted/device.py:134"),
    "pair_count": ("sketchtpu_torch/csrc/signeq.cu",
                   "sketchtpu/inverted/device.py:32"),
    "knn_select_masked": ("sketchtpu_torch/csrc/knn_scan.cu",
                          "sketchtpu/dist/pallas_kernels.py:47"),
    "coreacc_keys_masked": ("sketchtpu_torch/csrc/coreacc.cu",
                            "sketchtpu/dist/coreacc_pallas.py:100"),
    "aahash_bin_multi": ("sketchtpu_torch/csrc/aahash_bin.cu",
                         "sketchtpu/hash/aahash_jax.py:355"),
    "sign_prefilter": ("sketchtpu_torch/csrc/sign_prefilter.cu",
                       "sketchtpu/sketchcore/sign_prefilter.py:118"),
    "samebits_dist": ("sketchtpu_torch/csrc/samebits.cu",
                      "sketchtpu/dist/jaccard_jax.py:435"),
    "coreacc_chain": ("sketchtpu_torch/csrc/coreacc.cu",
                      "sketchtpu/dist/coreacc_jax.py:32"),
    "samebits_stack": ("sketchtpu_torch/csrc/samebits.cu",
                       "sketchtpu/dist/pallas_kernels.py:265"),
    "samebits_finish": ("sketchtpu_torch/csrc/samebits.cu",
                        "sketchtpu/shard/mesh.py:851"),
}
DENSE_PATH = ("samebits", "coreacc", "nthash_bin_multi", "samebits_full")
# knn_keys: K3's tile mode, the route of `dist --knn` past MAX_KNN = 1024
KNN_PATH = ("knn_select", "coreacc", "knn_keys")
INVERTED_PATH = ("nthash_signs", "nthash_bin_multi", "signeq_count",
                 "signeq_any", "signeq_all", "pair_count",
                 "knn_select_masked", "coreacc_keys_masked",
                 "sign_prefilter")
# amino acids and 3Di: sketch, append, then dense -k, core/acc and --knn
AA_PATH = ("aahash_bin_multi", "samebits", "coreacc", "knn_select")
# the words axis of shard/mesh.py (library surface, phase 10): each words
# slot's K4 partial (samebits_stack for every k in one launch), the
# lead's finish (samebits_finish or coreacc_chain over the partials), and
# the unsplit jaccard_dist_block (samebits_dist)
WORDS_PATH = ("samebits_full", "samebits_stack", "samebits_finish",
              "coreacc_chain", "samebits_dist")

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bytes/s, and
# the 32-bit non-tensor rate, which bounds the 32-bit integer logic and
# popcount operations of these kernels from below
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12
# 32-bit operations per pair and 64-bin chunk of a samebits count: the
# JAX kernels' own cost estimate (pallas_kernels.py:128), two u32 words x
# (BBITS xor + BBITS and + popcount + add)
SB_OPS = 2 * (2 * 14 + 2)
# Hopper's integer issue rates (CUDA C++ Programming Guide, arithmetic
# instruction throughput, compute capability 9.0): 64 32-bit bitwise
# operations (one LOP3 folds a plane's XOR and AND) and 16 popcounts per
# clock and SM; 132 SMs at the 1.98 GHz boost clock
SMS, CLOCK_HZ = 132, 1.98e9


def integer_floor_ms(pair_chunks: float) -> float:
    """The least time the samebits work of pair_chunks (pair, 64-bin
    chunk) units takes at the integer issue rates: two LOP3 per plane, two
    popcounts per chunk, the two pipes overlapped."""
    lop3 = pair_chunks * 2 * 14 / (64 * SMS * CLOCK_HZ)
    popc = pair_chunks * 2 / (16 * SMS * CLOCK_HZ)
    return max(lop3, popc) * 1e3


def bound(ops: float, nbytes: float) -> dict:
    """The least time the card could take: operations at PEAK_OPS or bytes
    (each input read once, each output written once) at PEAK_BYTES."""
    t_ops, t_bytes = ops / PEAK_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


class Count:
    """A kernel's launch count, kept by its wrapper: the wrapper's attribute
    `attr`, or one mode's entry `key` of a dict attribute."""

    def __init__(self, fn, attr: str = "launches", key: str | None = None):
        self.fn, self.attr, self.key = fn, attr, key

    @property
    def launches(self) -> int:
        v = getattr(self.fn, self.attr)
        return v[self.key] if self.key is not None else v

    @launches.setter
    def launches(self, value: int) -> None:
        if self.key is None:
            setattr(self.fn, self.attr, value)
        else:
            getattr(self.fn, self.attr)[self.key] = value


def kernel_wrappers() -> dict:
    """Every kernel (and kernel mode) of the port by name, with the launch
    count its wrapper keeps."""
    from sketchtpu_torch.dist.coreacc_kernels import coreacc, coreacc_chain
    from sketchtpu_torch.dist.knn_kernels import knn_keys, knn_select
    from sketchtpu_torch.dist.samebits_kernels import (
        samebits,
        samebits_dist,
        samebits_finish,
        samebits_full,
        samebits_stack,
    )
    from sketchtpu_torch.hash.aahash_torch import aahash_bin_multi
    from sketchtpu_torch.hash.nthash_torch import nthash_bin_multi, nthash_signs
    from sketchtpu_torch.inverted.device import pair_count, signeq
    from sketchtpu_torch.sketchcore.sign_prefilter import sign_prefilter_flags

    return {"samebits": Count(samebits), "coreacc": Count(coreacc),
            "knn_keys": Count(knn_keys), "knn_select": Count(knn_select),
            "samebits_full": Count(samebits_full),
            "nthash_bin_multi": Count(nthash_bin_multi),
            "nthash_signs": Count(nthash_signs),
            "signeq_count": Count(signeq, "mode_launches", "count"),
            "signeq_any": Count(signeq, "mode_launches", "any"),
            "signeq_all": Count(signeq, "mode_launches", "all"),
            "pair_count": Count(pair_count),
            "knn_select_masked": Count(knn_select, "masked_launches"),
            "coreacc_keys_masked": Count(coreacc, "masked_launches"),
            "aahash_bin_multi": Count(aahash_bin_multi),
            "sign_prefilter": Count(sign_prefilter_flags),
            "samebits_dist": Count(samebits_dist),
            "coreacc_chain": Count(coreacc_chain),
            "samebits_stack": Count(samebits_stack),
            "samebits_finish": Count(samebits_finish)}


@contextlib.contextmanager
def uncounted():
    """Launches made inside (a kernel held against its twin, a reference
    number) are taken out of every count again: the counts keep only the
    CLI's own."""
    wrappers = kernel_wrappers()
    before = {k: fn.launches for k, fn in wrappers.items()}
    try:
        yield
    finally:
        for k, fn in wrappers.items():
            fn.launches = before[k]


@contextlib.contextmanager
def prefilter_knob():
    """SKETCHTPU_FASTQ_PREFILTER=1 inside: the reads path's sign prefilter
    (sketchcore/sign_prefilter.py) for --min-count >= 2."""
    saved = os.environ.get("SKETCHTPU_FASTQ_PREFILTER")
    os.environ["SKETCHTPU_FASTQ_PREFILTER"] = "1"
    try:
        yield
    finally:
        if saved is None:
            del os.environ["SKETCHTPU_FASTQ_PREFILTER"]
        else:
            os.environ["SKETCHTPU_FASTQ_PREFILTER"] = saved


@contextlib.contextmanager
def reads_traffic():
    """Counts, inside, the reads path's copies to the host (bytes of every
    HostCopy of a CUDA tensor made by sketch_torch) and the signs that
    reach the host's count filter (bin_minima_filtered's input), the
    prefilter's rows and the device time of their step (CUDA events on
    the stream around each row's launch: nothing is synchronised), and the
    peak device memory allocated and reserved inside, in bytes (and what
    was allocated on entry)."""
    import threading

    import torch

    from sketchtpu_torch.sketchcore import sign_prefilter, sketch_torch

    seen = {"d2h_bytes": 0, "filter_signs": 0}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    seen["base_allocated"] = torch.cuda.memory_allocated()
    lock = threading.Lock()
    real_copy, real_filter = sketch_torch.HostCopy, sketch_torch.bin_minima_filtered
    real_flags = sketch_torch.keep_flags
    events = []

    def timed_step(row, nbins, min_count):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        start.record()
        flags = sign_prefilter.sign_prefilter_flags(row, nbins, min_count)
        end.record()
        events.append((start, end))
        return flags

    def timed_flags(signs, nbins, min_count):
        return real_flags(signs, nbins, min_count, keep=timed_step)

    class Counted(real_copy):
        def __init__(self, t):
            super().__init__(t)
            if t.device.type == "cuda":
                seen["d2h_bytes"] += t.numel() * t.element_size()

    def counted_filter(signs, nbins, min_count):
        with lock:
            seen["filter_signs"] += signs.size
        return real_filter(signs, nbins, min_count)

    sketch_torch.HostCopy = Counted
    sketch_torch.bin_minima_filtered = counted_filter
    sketch_torch.keep_flags = timed_flags
    try:
        yield seen
        seen["peak_allocated"] = torch.cuda.max_memory_allocated()
        seen["peak_reserved"] = torch.cuda.max_memory_reserved()
        torch.cuda.synchronize()
        seen["prefilter_rows"] = len(events)
        seen["prefilter_ms"] = sum(a.elapsed_time(b) for a, b in events)
    finally:
        sketch_torch.HostCopy = real_copy
        sketch_torch.bin_minima_filtered = real_filter
        sketch_torch.keep_flags = real_flags


def timed_cli(cli_main, argv, what: str, stdout: Path | None = None,
              expect=()) -> float:
    """Wall seconds of one CLI run (its stdout in `stdout` when given);
    prints the kernel launches it made and fails if one of `expect` made
    none."""
    before = {k: fn.launches for k, fn in kernel_wrappers().items()}
    with contextlib.ExitStack() as stack:
        if stdout is not None:
            stack.enter_context(contextlib.redirect_stdout(
                stack.enter_context(open(stdout, "w"))))
        t0 = time.time()
        rc = cli_main(argv)
        wall = time.time() - t0
    check(rc == 0, f"{what} failed")
    made = {k: fn.launches - before[k] for k, fn in kernel_wrappers().items()}
    print(f"{what}: launches of this one run "
          f"{ {k: v for k, v in made.items() if v} }")
    for name in expect:
        check(made[name] > 0, f"{what} did not launch {name}")
    return wall


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call of fn() on the card, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def run(cmd, **kw) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, **kw)
    check(proc.returncode == 0,
          f"{' '.join(map(str, cmd))} failed ({proc.returncode}):\n"
          f"{proc.stderr[-3000:]}")
    return proc.stdout


# --- phase 2: kernels against their twins ---------------------------------

def derived_words(n: int, seed: int, kmers=KMERS, s64: int = S64):
    """(n, nk, s64*14) int64 related sketch words on the card."""
    import numpy as np
    import torch

    from sketchtpu_torch.synth import derive_words

    rng = np.random.default_rng(seed)
    parents = rng.integers(0, 2**64, (8, len(kmers), s64, 14), dtype=np.uint64)
    words = derive_words(parents, n, kmers, seed)
    return torch.from_numpy(
        words.reshape(n, len(kmers), s64 * 14).view(np.int64)
    ).cuda()


# the parent design's K1 / K4 times (PERF.md's kernel table, an H100 80GB
# HBM3 at 700 W): a 64 x 64 pair tile, 4 x 4 pairs per thread, staged
# through registers with two barriers per chunk
PREVIOUS_SAMEBITS = {"i": "previous design 1.1221 ms",
                     "iii": "previous design 1.6922 ms"}
S64_K4 = 625  # 40,000 bins: past the int16 strips, K4's only CLI regime


def sass_counts(lib_path: Path, kernel: str) -> dict:
    """Instruction counts of each instantiation of `kernel` in the built
    library's SASS (cuobjdump -sass): {mangled name: Counter of opcodes
    with their first modifier (LOP3.LUT, LDS.64, ...), and of each LOP3's
    truth table as "LUT 0x.."}."""
    import re
    from collections import Counter

    from sketchtpu_torch import _build

    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    text = run([str(cuobjdump), "-sass", str(lib_path)])
    opcode = (r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?"
              r"([A-Z0-9_]+(?:\.[A-Z0-9_]+)?)")
    found = {}
    for body in text.split("Function : ")[1:]:
        name = body.split("\n", 1)[0].strip()
        if kernel in name:
            ops = Counter(re.findall(opcode, body))
            ops.update("LUT " + lut for lut in re.findall(
                r"LOP3\.LUT [^;]*?(0x[0-9a-f]+), !?U?PT", body))
            found[name] = ops
    return found


def print_sass(lib_path: Path, kernel: str, chunks_per_loop: int) -> None:
    """The samebits work in `kernel`'s SASS. Its logic ops are the LOP3s
    with the tables of ~(a ^ b) (0xc3, the first plane) and acc & ~(a ^ b)
    (0x90); per plane of the unrolled loop body, which holds
    chunks_per_loop chunks of 14 planes."""
    for name, ops in sass_counts(lib_path, kernel).items():
        planes = 14 * chunks_per_loop
        logic = ops["LUT 0xc3"] + ops["LUT 0x90"]
        luts = sorted(((v, k) for k, v in ops.items() if k.startswith("LUT")),
                      reverse=True)[:4]
        total = sum(v for k, v in ops.items() if not k.startswith("LUT"))
        print(f"phase2 SASS {name[-60:]}: {ops['LOP3.LUT']} LOP3 (tables "
              f"{', '.join(f'{k[4:]} x{v}' for v, k in luts)}), "
              f"{ops['LDS.64']} LDS.64, {ops['LDS']} LDS, {ops['POPC']} POPC, "
              f"{ops['LDGSTS.E']} LDGSTS, {total} instructions; per plane of "
              f"the loop body: {logic / planes:.1f} samebits LOP3, "
              f"{ops['LDS.64'] / planes:.1f} LDS.64")


def phase2_samebits(words, big, results, lib_path: Path):
    """K1 (int16 strips, triangle skip) and K4 (int32 matrix), every entry
    against the twin: (i) the strip of the record, 2048 x 16384 at row0
    4096; (ii) the first strip of a 100,000-sample dense run, whose column
    plane exceeds L2; (iii) K4 at 2048 x 16384; (iv) K4 at 40,000 bins
    (s64 = 625), 2048 x 8192."""
    import torch

    from sketchtpu_torch.dist.samebits_kernels import (
        samebits,
        samebits_full,
        samebits_ref,
    )

    ptx = ptxas_report(lib_path, "samebits_kernel",
                       {"IsLb0E": "int16", "IiLb0E": "int32",
                        "IfLb1E": "f32 distance"})
    for mode, info in sorted(ptx.items()):
        print(f"phase2 samebits {mode} kernel: {info['registers']} registers, "
              f"{info['spill_store_bytes']} bytes spilled")
        check(info["spill_store_bytes"] == 0, f"samebits {mode}: spills")
    # the loop body: the ring's RING_G = 2 chunks a stage, unrolled
    print_sass(lib_path, "samebits_kernel", 2)

    w16 = words[:, 0]
    w625 = derived_words(8192, SEED + 3, kmers=(17,), s64=S64_K4)[:, 0]
    cases = (
        ("i", "samebits", w16[4096:6144], w16,
         dict(out_dtype=torch.int16, tri=True, row0=4096), 10),
        ("ii", "samebits", big[:2048], big,
         dict(out_dtype=torch.int16, tri=True, row0=0), 3),
        ("iii", "samebits_full", w16[:2048], w16, {}, 10),
        ("iv", "samebits_full", w625[:2048], w625, {}, 3),
    )
    kernels = {"samebits": samebits, "samebits_full": samebits_full}
    for label, name, a, b, kw, reps in cases:
        fn = kernels[name]
        got = fn(a, b, **kw)
        check(torch.equal(got, samebits_ref(a, b, **kw)),
              f"{name} ({label}): kernel != twin")
        del got
        plain = cuda_ms(lambda: samebits_ref(a, b, **kw), reps=1, warmup=0)
        ms = cuda_ms(lambda: fn(a, b, **kw), reps=reps)
        na, nb, s64 = a.shape[0], b.shape[0], a.shape[1] // 14
        # the triangle skip computes only pairs with column > row
        pairs = (sum(max(0, nb - 1 - (kw["row0"] + i)) for i in range(na))
                 if kw.get("tri") else na * nb)
        out_bytes = 2 if kw.get("out_dtype") == torch.int16 else 4
        bd = bound(pairs * s64 * SB_OPS,
                   (na + nb) * a.shape[1] * 8 + na * nb * out_bytes)
        floor = integer_floor_ms(pairs * s64)
        prev = PREVIOUS_SAMEBITS.get(label)
        print(f"phase2 {name} ({label}) ({na}, {nb}) s64={s64} "
              f"{'int16' if out_bytes == 2 else 'int32'}"
              f"{' tri row0=%d' % kw['row0'] if kw.get('tri') else ''}: "
              f"equal to twin on every entry; kernel {ms:.4f} ms"
              f"{' (' + prev + ')' if prev else ''}, twin {plain:.2f} ms, "
              f"bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}): kernel at "
              f"{100 * bd['bound_ms'] / ms:.1f}%; integer-issue floor "
              f"{floor:.4f} ms: kernel at {100 * floor / ms:.1f}%; "
              f"{na * nb / ms / 1e6:.3f} G pair/s")
        if label in ("i", "iii"):
            results[name] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain,
                                 library_ms=None, **bd)
    del w625
    torch.cuda.empty_cache()


# the previous K2 design's times at these shapes (PERF.md's kernel table,
# an H100 80GB HBM3 at 700 W): a 32 x 64 pair tile, one chunk per barrier
PREVIOUS_COREACC = {
    "plain": "previous design 29.7813 ms",
    "completeness": "previous design 30.6824 ms",
    "keys": "previous design 12.23 ms for the f32 tile, before key packing",
}


def ptxas_report(lib_path: Path, kernel: str, modes: dict) -> dict:
    """Registers and spill bytes of each instantiation of `kernel`, from the
    build's -Xptxas -v log: {mode: {registers, spill_store_bytes}}, with
    `modes` mapping a piece of the mangled template arguments to its name."""
    lines = lib_path.with_suffix(".log").read_text().splitlines()
    found = {}
    for i, ln in enumerate(lines):
        if "Compiling entry" in ln and kernel in ln:
            mode = next(name for part, name in modes.items() if part in ln)
            text = " ".join(lines[i + 1 : i + 4])
            regs = text.split("Used ")[1].split(" registers")[0]
            spills = text.split("bytes stack frame, ")[1].split(" bytes spill")[0]
            found[mode] = dict(registers=int(regs), spill_store_bytes=int(spills))
    return found


def timed_once(fn):
    """(result, ms) of one call of fn() on the card, by CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def phase2_coreacc(words, results, lib_path: Path):
    """K2 plain at 2048 x 16384 (with and without completeness) and in key
    mode at the core/accessory kNN tile, 2048 x 8192 across the diagonal:
    every pair against the twin on the same inputs, max error 0 except
    pairs on the beta == 0 discontinuity (counted; expected none)."""
    import torch

    from sketchtpu_torch import _build
    from sketchtpu_torch.dist.coreacc_kernels import (
        coreacc,
        coreacc_keys,
        coreacc_keys_ref,
        coreacc_ref,
    )

    # <KEYS, MASK, WIDE>: WIDE past MAX_NK_BY_VALUE k (the table in device
    # memory, a 16-bit included-k count: one block an SM)
    ptx = ptxas_report(lib_path, "coreacc_kernel", {
        f"ILb{keys}ELb{mask}ELb{wide}E": f"{name}{' wide' if wide else ''}"
        for keys, mask, name in ((0, 0, "plain"), (1, 0, "keys"),
                                 (1, 1, "keys masked"))
        for wide in (0, 1)})
    lib = _build.lib()
    for mode, info in sorted(ptx.items()):
        wide = mode.endswith(" wide")
        info["blocks_per_sm"] = lib.stpu_coreacc_blocks_per_sm(
            {"plain": 0, "keys": 1, "keys masked": 2}[mode.removesuffix(
                " wide")], int(wide))
        print(f"phase2 coreacc {mode} kernel: {info['registers']} registers, "
              f"{info['spill_store_bytes']} bytes spilled, "
              f"{info['blocks_per_sm']} resident 256-thread blocks per SM")
        check(info["spill_store_bytes"] == 0
              and info["blocks_per_sm"] >= (1 if wide else 2),
              f"coreacc {mode}: spills or too few blocks per SM")
    check(len(ptx) == 6, f"coreacc: instantiations {sorted(ptx)}")
    a, b = words[4096:6144], words
    comp = torch.linspace(0.6, 1.0, b.shape[0], device=b.device)
    comp = comp[torch.randperm(b.shape[0], device=b.device)]
    worst, jumps = 0.0, 0
    times = {}
    na, nb, nk = a.shape[0], b.shape[0], len(KMERS)
    for label, c1, c2 in (("plain", None, None),
                          ("completeness", comp[4096:6144], comp)):
        core, acc = coreacc(a, b, KMERS, S64 * 64, c1, c2)
        (wc, wa), plain = timed_once(
            lambda: coreacc_ref(a, b, KMERS, S64 * 64, c1, c2))
        dc = (core - wc).abs()
        # the beta == 0 discontinuity: core jumps between 0 and 1
        jump = (dc > 0) & (torch.minimum(core, wc) < 1e-3) & (
            torch.maximum(core, wc) == 1.0)
        jumps += int(jump.sum())
        err = max(dc[~jump].max().item(), (acc - wa).abs().max().item())
        check(err == 0, f"coreacc {label}: kernel vs twin {err}")
        worst = max(worst, err)
        fitted = int(((wc > 0) & (wc < 1)).sum())
        check(fitted > 0, f"coreacc {label}: no pair reached the fit")
        del core, acc, wc, wa, dc, jump
        ms = cuda_ms(lambda: coreacc(a, b, KMERS, S64 * 64, c1, c2), reps=10)
        times[label] = (ms, plain)
        print(f"phase2 coreacc {label} ({na}, {nb}) nk={nk}: equal to twin "
              f"on every pair ({fitted} fitted); kernel {ms:.4f} ms "
              f"({PREVIOUS_COREACC[label]}), twin {plain:.2f} ms, "
              f"{na * nb / ms / 1e6:.3f} G pair/s")
    print(f"phase2 coreacc beta==0 discontinuity pairs: {jumps}")
    ms, plain = times["plain"]
    bd = bound(na * nb * nk * S64 * SB_OPS,
               (na + nb) * a.shape[1] * a.shape[2] * 8 + na * nb * 8)
    floor = integer_floor_ms(na * nb * nk * S64)
    print(f"phase2 coreacc plain bound {bd['bound_ms']:.4f} ms "
          f"({bd['bound_by']}): kernel at {100 * bd['bound_ms'] / ms:.1f}%; "
          f"integer-issue floor {floor:.4f} ms: kernel at "
          f"{100 * floor / ms:.1f}%")

    # key mode at the kNN tile: rows 4096.. against columns 0..8191
    bk = words[:8192]
    kw = dict(row0=4096, col0=0, nb_real=words.shape[0], exclude_self=True)
    keys, acc = coreacc_keys(a, bk, KMERS, S64 * 64, **kw)
    (want_k, want_a), key_plain = timed_once(
        lambda: coreacc_keys_ref(a, bk, KMERS, S64 * 64, **kw))
    check(torch.equal(keys, want_k) and torch.equal(acc, want_a),
          "coreacc keys: kernel != twin")
    check(int((keys == -(1 << 63)).sum()) == na, "coreacc keys: self pairs")
    del keys, acc, want_k, want_a
    key_ms = cuda_ms(lambda: coreacc_keys(a, bk, KMERS, S64 * 64, **kw),
                     reps=10)
    kbd = bound(na * bk.shape[0] * nk * S64 * SB_OPS,
                (na + bk.shape[0]) * a.shape[1] * a.shape[2] * 8
                + na * bk.shape[0] * 12)
    print(f"phase2 coreacc keys ({na}, {bk.shape[0]}) nk={nk}: bit-equal to "
          f"twin (keys and acc); kernel {key_ms:.4f} ms "
          f"({PREVIOUS_COREACC['keys']}), twin "
          f"{key_plain:.2f} ms, bound {kbd['bound_ms']:.4f} ms "
          f"({kbd['bound_by']}), integer-issue floor "
          f"{integer_floor_ms(na * bk.shape[0] * nk * S64):.4f} ms, "
          f"{na * bk.shape[0] / key_ms / 1e6:.3f} G pair/s")
    results["coreacc"] = dict(max_abs_err=worst, ms=ms, plain_ms=plain,
                              beta0_pairs=jumps, library_ms=None,
                              keys_ms=key_ms, **bd)
    phase2_coreacc_many_k(results)


NK_MANY = 300  # k = 15..314: past K2's by-value k table (MAX_NK_BY_VALUE)


def phase2_coreacc_many_k(results):
    """K2 at NK_MANY k (the WIDE instantiations: the k table in device
    memory, a 16-bit included-k count), 512 x 2048 at s64 = 16: plain
    with and without completeness, key mode, masked key mode (S = 1000)
    and coreacc_chain over 2 slabs, each bit-equal to its twin on every
    pair; times beside the twins' and the bound."""
    import torch

    from sketchtpu_torch.dist.coreacc_kernels import (
        coreacc,
        coreacc_chain,
        coreacc_chain_ref,
        coreacc_keys,
        coreacc_keys_ref,
        coreacc_ref,
    )
    from sketchtpu_torch.dist.knn_kernels import SignMask
    from sketchtpu_torch.dist.samebits_kernels import samebits_stack
    from sketchtpu_torch.shard.mesh import word_ranges

    kmers = tuple(range(15, 15 + NK_MANY))
    na, nb = 512, 2048
    w = device_words(na + nb, S64, SEED + 11, kmers=kmers)
    a, b = w[:na], w[na:]
    comp = torch.linspace(0.6, 1.0, na + nb, device=w.device)
    comp = comp[torch.randperm(na + nb, device=w.device)]
    times = {}
    for label, c1, c2 in (("plain", None, None),
                          ("completeness", comp[:na], comp[na:])):
        got = coreacc(a, b, kmers, S64 * 64, c1, c2)
        want, plain = timed_once(
            lambda: coreacc_ref(a, b, kmers, S64 * 64, c1, c2))
        check(all(torch.equal(g, x) for g, x in zip(got, want)),
              f"coreacc nk={NK_MANY} {label}: kernel != twin")
        fitted = int(((want[0] > 0) & (want[0] < 1)).sum())
        check(fitted > 0, f"coreacc nk={NK_MANY} {label}: no pair reached "
              f"the fit")
        slabs = [samebits_stack(a[..., r], b[..., r])
                 for r in word_ranges(S64, 2)]
        chain = coreacc_chain(slabs, kmers, S64 * 64, S64, c1, c2)
        twin = coreacc_chain_ref(slabs, kmers, S64 * 64, S64, c1, c2)
        check(all(torch.equal(g, x) and torch.equal(g, t)
                  for g, x, t in zip(chain, got, twin)),
              f"coreacc_chain nk={NK_MANY} {label}: != K2 or its twin")
        del got, want, chain, twin
        ms = cuda_ms(lambda: coreacc(a, b, kmers, S64 * 64, c1, c2), reps=5)
        chain_ms = cuda_ms(lambda: coreacc_chain(slabs, kmers, S64 * 64, S64,
                                                 c1, c2), reps=10)
        del slabs
        times[label] = (ms, plain)
        print(f"phase2 coreacc nk={NK_MANY} {label} ({na}, {nb}): equal to "
              f"twin on every pair ({fitted} fitted); kernel {ms:.4f} ms, "
              f"twin {plain:.2f} ms; coreacc_chain over 2 slabs equal to K2 "
              f"and its twin, {chain_ms:.4f} ms")
        results.setdefault("coreacc_many_k", {})[label] = (ms, chain_ms)
    sig_w, _ = masked_signs(na + nb, 1000, SEED + 12)
    kw = dict(row0=0, col0=na, nb_real=na + nb, exclude_self=True)
    for label, sig in (("keys", None),
                       ("keys masked", SignMask(sig_w[:na], sig_w, 1000))):
        got = coreacc_keys(a, b, kmers, S64 * 64, sig=sig, **kw)
        want, plain = timed_once(
            lambda: coreacc_keys_ref(a, b, kmers, S64 * 64, sig=sig, **kw))
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"coreacc nk={NK_MANY} {label}: kernel != twin")
        del got, want
        ms = cuda_ms(lambda: coreacc_keys(a, b, kmers, S64 * 64, sig=sig,
                                          **kw), reps=5)
        print(f"phase2 coreacc nk={NK_MANY} {label} ({na}, {nb}): bit-equal "
              f"to twin (keys and acc); kernel {ms:.4f} ms, twin "
              f"{plain:.2f} ms")
        results["coreacc_many_k"][label] = (ms, None)
    ms, _ = times["plain"]
    bd = bound(na * nb * NK_MANY * S64 * SB_OPS,
               (na + nb) * NK_MANY * S64 * 14 * 8 + na * nb * 8)
    print(f"phase2 coreacc nk={NK_MANY} plain bound {bd['bound_ms']:.4f} ms "
          f"({bd['bound_by']}): kernel at {100 * bd['bound_ms'] / ms:.1f}%; "
          f"integer-issue floor "
          f"{integer_floor_ms(na * nb * NK_MANY * S64):.4f} ms")
    del w, a, b
    torch.cuda.empty_cache()


# --- phase 2, the words axis's kernels -----------------------------------------

S64_WORDS = 1600  # 102,400 bins: the sketch size the words axis exists for
N_WORDS = 4096  # phase 10's samples: 5.1 GB of words at 7 k


def device_words(n: int, s64: int, seed: int, kmers=KMERS,
                 device="cuda") -> "torch.Tensor":
    """(n, nk, s64*14) int64 related sketch words made on `device` (as
    synth.derive_words makes them on the host, too slowly for GBs): 8
    parents; sample i copies parent i % 8 and re-draws each bin at k with
    probability 1 - (1 - d_i)^k, d_i log-spaced in [0.001, 0.05]."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    nk = len(kmers)

    def draw(*shape):
        hi = torch.randint(0, 1 << 32, shape, generator=g, device=device)
        return (hi << 32) | torch.randint(0, 1 << 32, shape, generator=g,
                                          device=device)

    parents = draw(8, nk, s64, 14)
    d = torch.logspace(-3, float(torch.tensor(0.05).log10()), n,
                       device=device)
    d = d[torch.randperm(n, generator=g, device=device)]
    bits = torch.arange(64, device=device)
    out = torch.empty((n, nk, s64 * 14), dtype=torch.int64, device=device)
    for ki, k in enumerate(kmers):
        for r0 in range(0, n, 256):
            rows = torch.arange(r0, min(r0 + 256, n), device=device)
            p = 1.0 - (1.0 - d[rows]) ** k
            redraw = torch.rand((rows.numel(), s64, 64), generator=g,
                                device=device) < p[:, None, None]
            mask = (redraw.long() << bits).sum(-1, keepdim=True)
            fresh = draw(rows.numel(), s64, 14)
            out[rows, ki] = ((parents[rows % 8, ki] & ~mask)
                             | (fresh & mask)).reshape(rows.numel(), -1)
    return out


def dist_bound(na: int, nb: int, chunks: int) -> dict:
    """samebits_dist's least time: the samebits work of its chunks, or its
    bytes (both operands, the f32 output)."""
    return bound(na * nb * chunks * SB_OPS,
                 (na + nb) * chunks * 14 * 8 + na * nb * 4)


def ulps_apart(got, want) -> int:
    """The largest distance in units in the last place between
    non-negative f32 values."""
    import torch

    return int((got.view(torch.int32).long()
                - want.view(torch.int32).long()).abs().max())


def phase2_words(results, lib_path: Path):
    """The words axis's kernels at phase 10's shapes (4096 samples at s64
    = 1600; a 2 x 2 grid's slot: rows 2048, 800 of the 1600 chunks), each
    against its twin: samebits_dist there (its unsplit use; Jaccard
    bit-equal, ANI within 2 ulp); samebits_stack, the slot's 7 per-k
    partials in one launch, bit-equal to 7 samebits_full launches and
    timed beside them and their torch.stack (the previous partial);
    samebits_finish of the lead's two partials (Jaccard bit-equal to the
    twin, ANI within 2 ulp, both bit-equal to jaccard_dist_block of the
    whole chunks; the count mode equal to K4); coreacc_chain over the
    slabs of w = 2 and 4 slots (bit-equal to K2 and to the twin, with and
    without completeness), timed beside the previous path (the slabs
    summed by torch adds, then the chain); then jaccard_dist_block at
    __graft_entry__.entry()'s tile, 128 x 128 at s64 = 16, k = 21."""
    import functools
    import operator

    import torch

    from sketchtpu_torch.dist.coreacc_kernels import (
        coreacc,
        coreacc_chain,
        coreacc_chain_ref,
    )
    from sketchtpu_torch.dist.jaccard_torch import jaccard_dist_block
    from sketchtpu_torch.dist.samebits_kernels import (
        samebits_dist,
        samebits_dist_ref,
        samebits_finish,
        samebits_finish_ref,
        samebits_full,
        samebits_stack,
        samebits_stack_ref,
    )
    from sketchtpu_torch.shard.mesh import word_ranges

    for kernel, modes in (("coreacc_chain_kernel",
                           {"ILb0E": "chain", "ILb1E": "chain wide"}),
                          ("samebits_finish_kernel",
                           {"ILb0E": "count", "ILb1E": "distance"})):
        for mode, info in sorted(ptxas_report(lib_path, kernel,
                                              modes).items()):
            print(f"phase2 {kernel} {mode}: {info['registers']} registers, "
                  f"{info['spill_store_bytes']} bytes spilled")
            check(info["spill_store_bytes"] == 0, f"{kernel} {mode}: spills")
    w = device_words(N_WORDS, S64_WORDS, SEED + 4)
    na, half, nk = N_WORDS // 2, S64_WORDS // 2 * 14, len(KMERS)
    a, b = w[:na, 0, :half], w[:, 0, :half]
    worst, times = 0.0, {}
    for ani in (False, True):
        got = samebits_dist(a, b, S64_WORDS, k=17.0, ani=ani)
        want, plain = timed_once(lambda: samebits_dist_ref(
            a, b, S64_WORDS, k=17.0, ani=ani))
        ulps = ulps_apart(got, want)
        check(ulps <= (2 if ani else 0),
              f"samebits_dist ani={ani}: {ulps} ulp from the twin")
        check(int(((got > 0) & (got < 1)).sum()) > 0,
              "samebits_dist: no pair between 0 and 1")
        worst = max(worst, float((got - want).abs().max()))
        del got, want
        ms = cuda_ms(lambda: samebits_dist(a, b, S64_WORDS, k=17.0, ani=ani),
                     reps=5)
        times[ani] = (ms, plain)
        print(f"phase2 samebits_dist ({'ANI' if ani else 'Jaccard'}) "
              f"({na}, {N_WORDS}) {S64_WORDS // 2} of {S64_WORDS} chunks: "
              f"{'within 2 ulp of' if ani else 'equal to'} the twin ({ulps} "
              f"ulp); kernel {ms:.4f} ms, twin {plain:.2f} ms")
    bd = dist_bound(na, N_WORDS, S64_WORDS // 2)
    ms, plain = times[False]
    print(f"phase2 samebits_dist bound {bd['bound_ms']:.4f} ms "
          f"({bd['bound_by']}): kernel at {100 * bd['bound_ms'] / ms:.1f}%; "
          f"integer-issue floor "
          f"{integer_floor_ms(na * N_WORDS * S64_WORDS // 2):.4f} ms")
    results["samebits_dist"] = dict(max_abs_err=worst, ms=ms, plain_ms=plain,
                                    library_ms=None, **bd)

    sa, sb = w[:na, :, :half], w[:, :, :half]

    def seven():
        return torch.stack([samebits_full(sa[:, ki], sb[:, ki])
                            for ki in range(nk)])

    got = samebits_stack(sa, sb)
    check(torch.equal(got, seven()), "samebits_stack != 7 samebits_full")
    twin, plain = timed_once(lambda: samebits_stack_ref(sa, sb))
    check(torch.equal(got, twin), "samebits_stack != its twin")
    del got, twin
    ms = cuda_ms(lambda: samebits_stack(sa, sb), reps=3)
    prev = cuda_ms(seven, reps=3)
    pair_chunks = nk * na * N_WORDS * (S64_WORDS // 2)
    bd = bound(pair_chunks * SB_OPS,
               (na + N_WORDS) * nk * half * 8 + nk * na * N_WORDS * 4)
    print(f"phase2 samebits_stack ({nk}, {na}, {N_WORDS}) {S64_WORDS // 2} of "
          f"{S64_WORDS} chunks: equal to {nk} samebits_full launches and to "
          f"the twin; one launch {ms:.4f} ms, {nk} launches + torch.stack "
          f"(the previous partial) {prev:.4f} ms, twin {plain:.2f} ms; bound "
          f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}): kernel at "
          f"{100 * bd['bound_ms'] / ms:.1f}%; integer-issue floor "
          f"{integer_floor_ms(pair_chunks):.4f} ms")
    results["samebits_stack"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain,
                                     library_ms=None, **bd)

    parts = [samebits_full(w[:na, 0, :half], w[:, 0, :half]),
             samebits_full(w[:na, 0, half:], w[:, 0, half:])]
    got = samebits_finish(parts)
    check(torch.equal(got, samebits_full(w[:na, 0], w[:, 0])),
          "samebits_finish count mode != K4 over the whole chunks")
    twin, count_plain = timed_once(lambda: samebits_finish_ref(parts))
    check(torch.equal(got, twin), "samebits_finish count mode != its twin")
    check(torch.equal(got, torch.add(*parts)),
          "samebits_finish count mode != torch.add of the partials")
    del got, twin
    count_ms = cuda_ms(lambda: samebits_finish(parts), reps=20)
    # the one library call of the count mode's function over two partials
    add_ms = cuda_ms(lambda: torch.add(*parts), reps=20)
    count_bd = bound(na * N_WORDS, 3 * na * N_WORDS * 4)
    print(f"phase2 samebits_finish (count) 2 partials ({na}, {N_WORDS}): "
          f"equal to K4 over the whole chunks, the twin and torch.add; "
          f"kernel {count_ms:.4f} ms, torch.add {add_ms:.4f} ms, twin "
          f"{count_plain:.2f} ms, bound {count_bd['bound_ms']:.4f} ms "
          f"({count_bd['bound_by']})")
    worst, times = 0.0, {}
    for ani in (False, True):
        got = samebits_finish(parts, S64_WORDS, k=17.0, ani=ani)
        want, plain = timed_once(lambda: samebits_finish_ref(
            parts, S64_WORDS, k=17.0, ani=ani))
        ulps = ulps_apart(got, want)
        check(ulps <= (2 if ani else 0),
              f"samebits_finish ani={ani}: {ulps} ulp from the twin")
        whole = jaccard_dist_block(w[:na, 0], w[:, 0], S64_WORDS, k=17.0,
                                   ani=ani)
        check(torch.equal(got, whole), f"samebits_finish ani={ani}: != the "
              f"unsplit jaccard_dist_block (samebits_dist)")
        fitted = int(((got > 0) & (got < 1)).sum())
        check(fitted > 0, "samebits_finish: no pair between 0 and 1")
        worst = max(worst, float((got - want).abs().max()))
        del got, want, whole
        ms = cuda_ms(lambda: samebits_finish(parts, S64_WORDS, k=17.0,
                                             ani=ani), reps=20)
        times[ani] = (ms, plain)
        agree = "within 2 ulp of" if ani else "equal to"
        print(f"phase2 samebits_finish ({'ANI' if ani else 'Jaccard'}) 2 "
              f"partials ({na}, {N_WORDS}): {agree} the twin ({ulps} ulp, "
              f"{fitted} pairs in (0, 1)), equal to the unsplit "
              f"jaccard_dist_block; kernel {ms:.4f} ms, twin {plain:.2f} ms")
    ms, plain = times[False]
    bd = bound(3 * na * N_WORDS * 8, 3 * na * N_WORDS * 4)
    print(f"phase2 samebits_finish bound {bd['bound_ms']:.4f} ms "
          f"({bd['bound_by']}): kernel at {100 * bd['bound_ms'] / ms:.1f}%")
    # the record's row is the count mode (the words axis's fold, and the
    # mode one library call computes); the distance mode's times print above
    results["samebits_finish"] = dict(max_abs_err=0.0, ms=count_ms,
                                      plain_ms=count_plain,
                                      library_ms=add_ms, dist_ms=ms,
                                      **count_bd)
    del parts

    comp = torch.linspace(0.6, 1.0, N_WORDS, device=w.device)
    comp = comp[torch.randperm(N_WORDS, device=w.device)]
    cases = (("plain", None, None), ("completeness", comp[:na], comp))
    want = {label: coreacc(w[:na], w, KMERS, S64_WORDS * 64, c1, c2)
            for label, c1, c2 in cases}
    chain_bytes = na * N_WORDS * 8  # core and acc written
    for n_slabs in (2, 4):
        slabs = [samebits_stack(w[:na, :, r], w[:, :, r])
                 for r in word_ranges(S64_WORDS, n_slabs)]
        times = {}
        for label, c1, c2 in cases:
            got = coreacc_chain(slabs, KMERS, S64_WORDS * 64, S64_WORDS, c1,
                                c2)
            twin, plain = timed_once(lambda: coreacc_chain_ref(
                slabs, KMERS, S64_WORDS * 64, S64_WORDS, c1, c2))
            for g, x, t in zip(got, want[label], twin):
                check(torch.equal(g, x), f"coreacc_chain {label} w={n_slabs}: "
                      f"!= K2")
                check(torch.equal(g, t), f"coreacc_chain {label} w={n_slabs}: "
                      f"!= its twin")
            fitted = int(((got[0] > 0) & (got[0] < 1)).sum())
            check(fitted > 0, f"coreacc_chain {label}: no pair reached the "
                  f"fit")
            del got, twin
            ms = cuda_ms(lambda: coreacc_chain(slabs, KMERS, S64_WORDS * 64,
                                               S64_WORDS, c1, c2), reps=10)
            prev = cuda_ms(lambda: coreacc_chain(
                functools.reduce(operator.add, slabs), KMERS, S64_WORDS * 64,
                S64_WORDS, c1, c2), reps=10)
            times[label] = (ms, plain)
            print(f"phase2 coreacc_chain {label} over {n_slabs} slabs of ({nk}, "
                  f"{na}, {N_WORDS}): equal to K2 on the whole words and to "
                  f"the twin on every pair ({fitted} fitted); kernel "
                  f"{ms:.4f} ms, the previous path ({n_slabs - 1} torch adds, "
                  f"then the chain) {prev:.4f} ms, twin {plain:.2f} ms")
        ms, plain = times["plain"]
        # bytes: the slabs read, core and acc written; operations: about 30
        # f32 operations a pair and k (the bias correction, logf, the early
        # break and the sums)
        cb = bound(na * N_WORDS * nk * 30,
                   n_slabs * nk * na * N_WORDS * 4 + chain_bytes)
        print(f"phase2 coreacc_chain w={n_slabs} bound {cb['bound_ms']:.4f} "
              f"ms ({cb['bound_by']}): kernel at "
              f"{100 * cb['bound_ms'] / ms:.1f}%")
        if n_slabs == 2:
            results["coreacc_chain"] = dict(max_abs_err=0.0, ms=ms,
                                            plain_ms=plain, library_ms=None,
                                            **cb)
        del slabs
    del want, w, a, b, sa, sb
    torch.cuda.empty_cache()

    # __graft_entry__.entry(): 128 x 128 random words, s64 = 16, k = 21
    import numpy as np

    rng = np.random.default_rng(0)
    ea, eb = (torch.from_numpy(rng.integers(0, 2**32, (128, 16 * 28),
                                            dtype=np.uint32).view(np.int64))
              .cuda() for _ in range(2))
    got = jaccard_dist_block(ea, eb, 16, k=21.0, ani=False)
    check(torch.equal(got, samebits_dist_ref(ea, eb, 16, k=21.0)),
          "jaccard_dist_block at entry()'s tile: != the twin")
    ms = cuda_ms(lambda: jaccard_dist_block(ea, eb, 16, k=21.0), reps=100)
    eb_ = dist_bound(128, 128, 16)
    print(f"phase2 jaccard_dist_block at entry()'s tile (128, 128) s64=16 "
          f"k=21: equal to the twin; {ms:.4f} ms a call (launch-bound; "
          f"bound {eb_['bound_ms']:.6f} ms, {eb_['bound_by']})")


def phase2_knn_keys(words, results):
    """K3's tile mode at 2048 rows x 8192 columns: a self tile across the
    diagonal, both key modes, bit-equal to the twin."""
    import torch

    from sketchtpu_torch.dist.knn_kernels import (
        Completeness,
        knn_keys,
        knn_keys_ref,
    )

    plane = words[:, 0]
    a, b = plane[4096:6144], plane[:8192]
    comp = torch.linspace(0.6, 1.0, plane.shape[0], device=plane.device)
    comp = comp[torch.randperm(plane.shape[0], device=plane.device)]
    modes = {
        "plain": None,
        "completeness": Completeness(comp[4096:6144].contiguous(), comp, 0.64,
                                     S64),
    }
    na, nb = a.shape[0], b.shape[0]
    for label, c in modes.items():
        kw = dict(row0=4096, col0=0, nb_real=plane.shape[0],
                  exclude_self=True, comp=c)
        got = knn_keys(a, b, **kw)
        want = knn_keys_ref(a, b, **kw)
        check(torch.equal(got, want), f"knn_keys {label}: kernel != twin")
        check(int((got == -1).sum()) == 2048, f"knn_keys {label}: self pairs")
        ms = cuda_ms(lambda: knn_keys(a, b, **kw), reps=10)
        plain = cuda_ms(lambda: knn_keys_ref(a, b, **kw), reps=2, warmup=0)
        bd = bound(na * nb * S64 * SB_OPS,
                   (na + nb) * a.shape[1] * 8 + na * nb * got.element_size())
        print(f"phase2 knn_keys {label} ({na}, {nb}) {got.dtype}: equal to "
              f"twin; kernel {ms:.4f} ms, twin {plain:.2f} ms, bound "
              f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}), integer-issue "
              f"floor {integer_floor_ms(na * nb * S64):.4f} ms, "
              f"{na * nb / ms / 1e6:.3f} G pair/s")


# K3's instantiations <key type, completeness, sign mask> by a piece of
# their mangled names
KNN_MODES_MANGLED = {
    "IiLb0ELb0E": "int32", "IxLb0ELb0E": "int64",
    "IxLb1ELb0E": "int64 completeness", "IiLb0ELb1E": "int32 masked",
    "IxLb0ELb1E": "int64 masked", "IxLb1ELb1E": "int64 completeness masked",
}


# the previous K3 design at shape (a) (PERF.md's kernel table, an H100 80GB
# HBM3 at 700 W): every key of the tile written, then torch.cat + torch.topk
PREVIOUS_KNN = "previous design 0.8099 ms for the key tile + 0.28 ms merge"


def phase2_knn_select(words, big, results, lib_path: Path):
    """K3 in selection mode against its twin (the tile twin's keys merged
    by torch.topk), bit-equal: (a) 2048 rows x 8192 columns across the
    diagonal, knn 50, the shape of the previous design's tile; (b) 2048
    rows x 100,000 columns, the main path's sweep; (c) completeness keys at
    (a); (d) 3 rows x 100,000, which splits the columns over blocks; (e)
    16,896 rows x 8192 columns: enough row tiles for one column split, the
    main path's route with no merge kernel."""
    import torch

    from sketchtpu_torch import _build
    from sketchtpu_torch.dist.knn_kernels import (
        Completeness,
        default_splits,
        knn_select,
        knn_select_ref,
    )

    lib = _build.lib()
    ptx = ptxas_report(lib_path, "knn_select_kernel", KNN_MODES_MANGLED)
    for mode, info in sorted(ptx.items()):
        key_bytes = 4 if mode.startswith("int32") else 8
        mask = int("masked" in mode)
        per_sm = lib.stpu_knn_select_blocks_per_sm(
            KNN, key_bytes, int("comp" in mode), mask)
        print(f"phase2 knn_select {mode} kernel: {info['registers']} "
              f"registers, {info['spill_store_bytes']} bytes spilled, "
              f"{lib.stpu_knn_select_rows(KNN, key_bytes, mask)} rows per "
              f"block and {per_sm} resident blocks per SM at knn {KNN}")
        check(info["spill_store_bytes"] == 0, f"knn_select {mode}: spills")
    plane = words[:, 0]
    comp = torch.linspace(0.6, 1.0, plane.shape[0], device=plane.device)
    comp = comp[torch.randperm(plane.shape[0], device=plane.device)]
    w_bytes = plane.shape[1] * 8
    cases = (
        ("a", plane[4096:6144], plane[:8192], 4096, None, 10),
        ("b", big[4096:6144], big, 4096, None, 3),
        ("c", plane[4096:6144], plane[:8192], 4096,
         Completeness(comp[4096:6144].contiguous(), comp[:8192].contiguous(),
                      0.64, S64), 10),
        ("d", big[:3], big, 0, None, 10),
        ("e", big[4096:20992], big[:8192], 4096, None, 3),
    )
    for label, a, b, row0, c, reps in cases:
        kw = dict(row0=row0, exclude_self=True, comp=c)
        got = knn_select(a, b, KNN, **kw)
        (want, plain) = timed_once(lambda: knn_select_ref(a, b, KNN, **kw))
        check(torch.equal(got, want), f"knn_select ({label}): kernel != twin")
        check(bool((got >= 0).all()), f"knn_select ({label}): missing keys")
        ms = cuda_ms(lambda: knn_select(a, b, KNN, **kw), reps=reps)
        na, nb = a.shape[0], b.shape[0]
        bd = bound(na * nb * S64 * SB_OPS,
                   (na + nb) * w_bytes + na * KNN * got.element_size())
        floor = integer_floor_ms(na * nb * S64)
        slots = SMS * lib.stpu_knn_select_blocks_per_sm(
            KNN, got.element_size(), int(c is not None), 0)
        splits = default_splits(
            na, nb, lib.stpu_knn_select_rows(KNN, got.element_size(), 0),
            slots)
        check(splits == 1 or label != "e", f"knn_select (e): {splits} splits")
        print(f"phase2 knn_select ({label}) ({na}, {nb}) knn {KNN} "
              f"{got.dtype}, {splits} column split(s) for {slots} resident "
              f"blocks: bit-equal to twin; kernel {ms:.4f} ms"
              f"{' (' + PREVIOUS_KNN + ')' if label == 'a' else ''}, twin "
              f"{plain:.2f} ms, bound {bd['bound_ms']:.4f} ms "
              f"({bd['bound_by']}): kernel at {100 * bd['bound_ms'] / ms:.1f}%"
              f"; integer-issue floor {floor:.4f} ms: kernel at "
              f"{100 * floor / ms:.1f}%; {na * nb / ms / 1e6:.3f} G pair/s")
        if label == "a":
            results["knn_select"] = dict(max_abs_err=0.0, ms=ms,
                                         plain_ms=plain, library_ms=None, **bd)


# 32-bit operations per window and k of the rolling formulation: two split
# rotations by one (a 64-bit rotate, 4, and the swap of bits 0 and 33, 4)
# = 16; four 64-bit XORs = 8; the unsigned 64-bit minimum 4; the Mersenne
# fold (and, shift, 64-bit add, compare, subtract) 8; the multiply-high
# (four 32 x 32 products and their carries) 8 and its shift 2; the compare
# with the bin's minimum 2
ROLL_OPS = 48


def phase2_nthash(results):
    """The multi-k ntHash launch against the stacked single-k twins on
    8 x 2 Mb + one 20 Mb contig, 7 k."""
    import torch

    from sketchtpu_torch.hash.nthash_torch import (
        nthash_bin_multi,
        nthash_bin_multi_ref,
        pack_group,
    )
    from sketchtpu_torch.synth import random_streams

    streams = random_streams([2_000_000] * 8 + [20_000_000], SEED)
    seq, starts = pack_group(streams)
    seq_d = torch.from_numpy(seq).cuda()
    starts_d = torch.from_numpy(starts).cuda()
    nbins = S64 * 64
    want, plain = timed_once(
        lambda: nthash_bin_multi_ref(seq_d, KMERS, True, starts_d, nbins))
    got = nthash_bin_multi(seq_d, KMERS, True, starts_d, nbins)
    check(torch.equal(got, want), "nthash_bin_multi: kernel != twin")
    check(not (got == -1).all(dim=2).any(), "nthash_bin_multi: empty row")
    ms = cuda_ms(lambda: nthash_bin_multi(seq_d, KMERS, True, starts_d, nbins),
                 reps=10)
    # the function's least work, the rolling formulation: ROLL_OPS per
    # window and k, the batch read once
    bd = bound(seq.size * len(KMERS) * ROLL_OPS,
               seq.size + len(KMERS) * starts.size * nbins * 8)
    # the tap form, for comparison with the previous design's bound: per
    # window and k, k taps of two 64-bit table XORs (4 u32 ops), the batch
    # read once per k
    tap = bound(seq.size * sum(KMERS) * 4,
                len(KMERS) * (seq.size + starts.size * nbins * 8))
    print(f"phase2 nthash_bin_multi 8 x 2 Mb + 20 Mb ({seq.size} bases), 7 k "
          f"in one launch: equal to twin; kernel {ms:.3f} ms (previous "
          f"design, one tap-table launch per k: 8.535 ms), twin {plain:.2f} "
          f"ms, bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}, the rolling "
          f"form): kernel at {100 * bd['bound_ms'] / ms:.1f}%; tap-form bound "
          f"{tap['bound_ms']:.4f} ms ({tap['bound_by']}): kernel at "
          f"{100 * tap['bound_ms'] / ms:.1f}%; "
          f"{seq.size * len(KMERS) / ms / 1e6:.3f} G base-k/s")
    results["nthash_bin_multi"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain,
                                       library_ms=None, **bd)


# --- phase 2, this slice's kernel pieces ------------------------------------

# 32-bit operations per window and k of the signs mode: ROLL_OPS without
# the bin's multiply-high, its shift and the compare with the bin's minimum
SIGN_OPS = ROLL_OPS - 12


def reads_stream(n: int, seed: int, read_len: int = 150):
    """A DnaStream of n bases cut like reads: a break at every read end and
    an N run (a break) about every 400 bases."""
    import numpy as np

    from sketchtpu_torch.ingest.fastx import DnaStream

    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    breaks = np.unique(np.concatenate([
        np.arange(read_len, n + 1, read_len), rng.integers(1, n, n // 400),
        [n]]))
    return DnaStream(codes=codes, breaks=breaks.astype(np.int64), reads=True)


def phase2_nthash_signs(results):
    """The signs mode against its twin, bit for bit: reads (a break at
    every read end, N runs), an assembly, k in {1, 17, 31, 64, 4097} alone,
    7 k at the reads path's chunk (timed), and 129 k split into two
    launches in each mode."""
    import torch

    from sketchtpu_torch import _build
    from sketchtpu_torch.hash import nthash_torch as nt
    from sketchtpu_torch.hash.nthash_torch import (
        nthash_bin_multi,
        nthash_bin_multi_ref,
        nthash_signs,
        nthash_signs_ref,
        pack_group,
    )
    from sketchtpu_torch.sketchcore.sketch_torch import _READ_CHUNK_SIGNS
    from sketchtpu_torch.synth import random_streams

    reads = torch.from_numpy(pack_group([reads_stream(2_000_000, SEED)])[0]).cuda()
    asm = torch.from_numpy(pack_group(random_streams(
        [3_000_000], SEED, breaks_per_mb=20))[0]).cuda()
    for k in (1, 17, 31, 64, 4097):
        for name, seq in (("reads", reads), ("assembly", asm)):
            got = nthash_signs(seq, [k], True)
            check(torch.equal(got, nthash_signs_ref(seq, [k], True,
                                                    got.shape[1])),
                  f"nthash_signs k={k} {name}: kernel != twin")
            valid = int((got != -1).sum())
            check(valid > 0 or (name == "reads" and k > 150),
                  f"nthash_signs k={k} {name}: no valid window")
        print(f"phase2 nthash_signs k={k}: reads and assembly bit-equal to "
              f"twin on every window start")
    kmers = list(range(3, 132))
    starts = torch.zeros(1, dtype=torch.int64, device="cuda")
    part = asm[:200_000]
    before = (nthash_signs.launches, nthash_bin_multi.launches)
    got = nthash_signs(part, kmers[::-1], True)
    check(torch.equal(got, nthash_signs_ref(part, kmers[::-1], True,
                                            got.shape[1])),
          "nthash_signs 129 k: kernel != twin")
    got = nthash_bin_multi(part, kmers, True, starts, 1024)
    check(torch.equal(got, nthash_bin_multi_ref(part, kmers, True, starts,
                                                1024)),
          "nthash_bin_multi 129 k: kernel != twin")
    check((nthash_signs.launches - before[0],
           nthash_bin_multi.launches - before[1]) == (2, 2),
          "129 k: not two launches of each mode")
    print("phase2 129 k (3..131): two launches of each mode, bit-equal to "
          "the twins")
    # an odd n_out (every other k row not 16-byte aligned), not a multiple
    # of a run, past the stream's last window
    got = nthash_signs(reads[:1_000_000], [17, 21, 29], True, 1_000_001)
    check(torch.equal(got, nthash_signs_ref(reads[:1_000_000], [17, 21, 29],
                                            True, 1_000_001)),
          "nthash_signs odd n_out: kernel != twin")
    print("phase2 nthash_signs 3 k, n_out 1,000,001: bit-equal to twin")
    # the reads path's chunk: all 7 k of the main path in one launch
    own = _READ_CHUNK_SIGNS // len(KMERS)
    seq = reads[: own + max(KMERS) - 1]
    got = nthash_signs(seq, KMERS, True, own)
    want, plain = timed_once(lambda: nthash_signs_ref(seq, KMERS, True, own))
    check(torch.equal(got, want), "nthash_signs chunk: kernel != twin")
    del want
    ms = cuda_ms(lambda: nthash_signs(seq, KMERS, True, own), reps=10)
    bd = bound(own * len(KMERS) * SIGN_OPS,
               seq.numel() + own * len(KMERS) * 8)
    smem = nt._signs_smem_bytes(len(KMERS), max(KMERS))
    per_sm = _build.query(seq.device, "stpu_nthash_signs_blocks_per_sm",
                          smem)
    blocks = nt.signs_blocks(own)
    print(f"phase2 nthash_signs chunk ({own} window starts, 7 k, "
          f"{own * len(KMERS) * 8 / 1e6:.0f} MB of signs): bit-equal to twin; "
          f"kernel {ms:.4f} ms ({PREVIOUS_SIGNEQ['nthash_signs']}), twin "
          f"{plain:.2f} ms, bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}):"
          f" kernel at {100 * bd['bound_ms'] / ms:.1f}%; "
          f"{own * len(KMERS) * 8 / ms / 1e6:.1f} GB/s written; {blocks} "
          f"blocks of {256 << nt._SIGNS_RUN_LG} starts, {per_sm} a SM: "
          f"{blocks / (per_sm * SMS):.2f} waves")
    results["nthash_signs"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain,
                                   library_ms=None, **bd)


# --- phase 2, the reads path's sign prefilter ---------------------------------

PF_SEGMENT = 1 << 24  # the record's segment: the JAX package's 2^24 windows
PF_K, PF_MIN_COUNT = 17, 5  # phase 6's first k and --min-count
# bytes of the step's work: each window's sign read once, its flag
# written once
PF_BYTES = 8 + 1
# the step's kernels, by the names they take in a profile
PF_KERNELS = ("pf_count", "pf_scan_chunks", "pf_scan_sums", "pf_scatter",
              "pf_bounds", "pf_keep")


def phase6_reads_files() -> Path:
    """Phase 6's 2 read samples of 50 Mb (a 2 Mb genome at 25x in 150 bp
    reads, FASTQ.gz), written at the first call (set-up): their rfile."""
    from sketchtpu_torch.synth import read_samples

    d = WORK / "p6reads"
    rfile = d / "reads.txt"
    if not rfile.exists():
        t0 = time.time()
        lines = read_samples(d / "fq", 2, READS_GENOME, READS_COVERAGE,
                             SEED + 10)
        rfile.write_text("".join(lines))
        print(f"phase6 wrote 2 x {READS_GENOME * READS_COVERAGE / 1e6:.0f} "
              f"Mb of 150 bp reads (FASTQ.gz) in {time.time() - t0:.1f} s "
              f"(set-up)")
    return rfile


def pf_kernel_ms(fn, reps: int) -> dict:
    """Device milliseconds a call of fn() spends in each of the step's
    kernels (torch.profiler over reps calls); {} where the profiler kept
    no kernel record."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0)
        for name in PF_KERNELS:
            if name in ev.key and us:
                out[name] = out.get(name, 0.0) + us / 1e3 / reps
    return out


def phase2_sign_prefilter(results):
    """The prefilter's kernels (sign_prefilter_flags: the stable partition
    by bucket and the per-bucket order-and-keep) and the gather against
    the twins, bit for bit: heavy-collision rows at seeds (16, 64, 1024 and
    40,000 bins, min_count 2, 3, 5, each also with 2^6 buckets of at most
    256 windows on chip, so that most take the path in device memory),
    then one 2^24-window segment of phase 6's first sample at k = 17,
    --min-count 5 and 1024 bins (timed: the kernels, each of them, the
    parent design's torch.sort of the same keys, the whole prefilter, the
    twin; its scratch's peak memory); and that sample's kept fraction by
    segment length, every segment and the whole row bit-equal too."""
    import numpy as np
    import torch

    from sketchtpu_torch.constants import num_bins
    from sketchtpu_torch.hash.nthash_torch import (
        bin_size,
        nthash_signs,
        pack_group,
    )
    from sketchtpu_torch.ingest.fastx import read_dna_sample
    from sketchtpu_torch.sketchcore import sign_prefilter as sp

    rng = np.random.default_rng(SEED + 20)
    for nbins, m, distinct in ((16, 5000, 400), (64, 100_000, 400),
                               (1024, 1_000_003, 200_000),
                               (40_000, 1_000_003, 300_000)):
        values = rng.integers(0, bin_size(nbins) * nbins, distinct)
        row = rng.choice(values, m)
        row[rng.random(m) < 0.1] = -1
        row = torch.from_numpy(row).cuda()
        for mc in (2, 3, 5):
            want = sp.sign_prefilter_flags_ref(row, nbins, mc)
            for plan in ({}, {"bits": 6, "cap": 256}):
                check(torch.equal(sp.sign_prefilter_flags(row, nbins, mc,
                                                          **plan), want),
                      f"sign_prefilter {nbins} bins, m {m}, min_count {mc} "
                      f"{plan}: kernels != twin")
            check(torch.equal(sp.prefilter_signs(row, nbins, mc),
                              sp.prefilter_signs_ref(row, nbins, mc)),
                  f"prefilter_signs {nbins} bins, m {m}, min_count {mc}: "
                  f"!= twin")
    print("phase2 sign_prefilter: flags and survivors bit-equal to the "
          "twins at 16 / 64 / 1024 / 40,000 bins, m 5000 / 100,000 / "
          "1,000,003, min_count 2, 3, 5, with the default buckets and with "
          "2^6 buckets of at most 256 windows on chip")

    files = phase6_reads_files().read_text().splitlines()[0].split("\t")[1:]
    stream = read_dna_sample(files, 20)
    _s64, nbins, _u = num_bins(SKETCH_SIZE)
    seq = torch.from_numpy(pack_group([stream])[0]).cuda()
    row = nthash_signs(seq, [PF_K], True)[0]  # every window start
    del seq
    mc = PF_MIN_COUNT
    seg = row[:PF_SEGMENT]
    got = sp.sign_prefilter_flags(seg, nbins, mc)
    want, plain = timed_once(
        lambda: sp.sign_prefilter_flags_ref(seg, nbins, mc))
    check(torch.equal(got, want), "sign_prefilter segment: kernels != twin")
    kept = sp.prefilter_signs(seg, nbins, mc)
    check(torch.equal(kept, sp.prefilter_signs_ref(seg, nbins, mc)),
          "prefilter_signs segment: != twin")
    valid = int((seg >= 0).sum())
    check(0 < kept.numel() < valid, "prefilter segment: nothing dropped")
    del want
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = sp.sign_prefilter_flags(seg, nbins, mc)
    torch.cuda.synchronize()
    scratch = torch.cuda.max_memory_allocated() - base
    ms = cuda_ms(lambda: sp.sign_prefilter_flags(seg, nbins, mc), reps=20)
    parts = pf_kernel_ms(lambda: sp.sign_prefilter_flags(seg, nbins, mc), 10)
    top = nbins * bin_size(nbins)
    mapped = torch.where((seg >= 0) & (seg < top), seg,
                         torch.iinfo(torch.int64).max)
    sort_ms = cuda_ms(lambda: torch.sort(mapped, stable=True), reps=10)
    del mapped
    whole_ms = cuda_ms(lambda: sp.prefilter_signs(seg, nbins, mc), reps=5)
    bd = bound(0, PF_BYTES * PF_SEGMENT)
    split = ", ".join(f"{k} {v:.4f}" for k, v in parts.items()) or \
        "not measured (no kernel record)"
    print(f"phase2 sign_prefilter segment ({PF_SEGMENT} windows of phase "
          f"6's first sample, k {PF_K}, --min-count {mc}, {nbins} bins, "
          f"2^{sp.bucket_bits(PF_SEGMENT)} buckets): bit-equal to the twin; "
          f"kernels {ms:.4f} ms (profile, ms a call: {split}); bound "
          f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}: {PF_BYTES} B a "
          f"window, each sign read and each flag written once): at "
          f"{100 * bd['bound_ms'] / ms:.1f}%; torch.sort of the same keys "
          f"{sort_ms:.4f} ms (the parent design's first step); whole "
          f"prefilter (kernels, masked_select) {whole_ms:.4f} ms; twin "
          f"{plain:.2f} ms; peak scratch and flags "
          f"{scratch / 2**20:.1f} MiB; kept {kept.numel()} of {valid} valid "
          f"windows = {100 * kept.numel() / valid:.2f}%")
    results["sign_prefilter"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain,
                                     library_ms=None, sort_ms=sort_ms, **bd)
    del got, kept
    valid = int((row >= 0).sum())
    # every segment length against the twins too: the reads path keeps
    # segments of ~5 M (phase 3) to the whole sample (phase 6)
    for length in (1 << 22, 1 << 23, 1 << 24, 1 << 25, row.numel()):
        n_kept = 0
        for a in range(0, row.numel(), length):
            part = row[a : a + length]
            check(torch.equal(sp.sign_prefilter_flags(part, nbins, mc),
                              sp.sign_prefilter_flags_ref(part, nbins, mc)),
                  f"sign_prefilter, {part.numel()} windows at {a}: kernels "
                  f"!= twin")
            kept = sp.prefilter_signs(part, nbins, mc)
            check(torch.equal(kept, sp.prefilter_signs_ref(part, nbins, mc)),
                  f"prefilter_signs, {part.numel()} windows at {a}: != twin")
            n_kept += kept.numel()
        print(f"phase2 prefilter kept fraction, segments of {length} "
              f"windows (each bit-equal to the twins): {n_kept} of {valid} "
              f"= {100 * n_kept / valid:.2f}%")
    del kept
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sp.sign_prefilter_flags(row, nbins, mc)
    torch.cuda.synchronize()
    scratch = torch.cuda.max_memory_allocated() - base
    row_ms = cuda_ms(lambda: sp.sign_prefilter_flags(row, nbins, mc), reps=5)
    parts = pf_kernel_ms(lambda: sp.sign_prefilter_flags(row, nbins, mc), 3)
    whole_ms = cuda_ms(lambda: sp.prefilter_signs(row, nbins, mc), reps=3)
    split = ", ".join(f"{k} {v:.4f}" for k, v in parts.items()) or \
        "not measured (no kernel record)"
    print(f"phase2 prefilter of the whole sample ({row.numel()} windows, one "
          f"segment as the reads path takes it, 2^"
          f"{sp.bucket_bits(row.numel())} buckets): kernels {row_ms:.4f} ms "
          f"(profile: {split}), bound "
          f"{bound(0, PF_BYTES * row.numel())['bound_ms']:.4f} ms; with "
          f"masked_select {whole_ms:.4f} ms; peak scratch and flags "
          f"{scratch / 2**20:.1f} MiB")


# --- phase 2, the amino-acid kernel ------------------------------------------

# 32-bit operations per window and k of the forward-only rolling aaHash:
# ROLL_OPS less the reverse strand's rotation (8), its two XORs (4) and
# the unsigned minimum of the two strands (4)
AA_ROLL_OPS = ROLL_OPS - 16
AA_KMERS = (6, 9, 12)  # bench/probe_aa.py:53-57's k
AA_SAMPLES, AA_RESIDUES = 16, 1_200_000  # and its proteome size


def aa_streams(n: int, length: int, seed: int, record: int = 300,
               invalid: float = 0.001):
    """n AaStreams of `length` residues as read_aa_sample gives them for a
    proteome: either case, a SEQSEP after each record of about `record`
    residues, and a share `invalid` of invalid residues (SEQSEP)."""
    import numpy as np

    from sketchtpu_torch.ingest.fastx import AaStream

    letters = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWYacdefghiklmnpqrstvwy",
                            dtype=np.uint8)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        seq = letters[rng.integers(0, 40, length)]
        bad = rng.random(length) < invalid
        seq[bad] = 5
        seq[np.cumsum(rng.integers(record // 2, 3 * record // 2,
                                   length // record)) % length] = 5
        out.append(AaStream(seq=seq, invalid_count=int(bad.sum())))
    return out


# the parent design's aaHash time (PERF.md's kernel table, an H100 80GB
# HBM3 at 700 W): k as the outer loop, runs of 64 starts, 1.11 waves, a
# shared-memory compare-and-swap minimum per window
PREVIOUS_AAHASH = "previous design 0.3854 ms"


def phase2_aahash(results, lib_path: Path):
    """aahash_bin_multi against its twin at 16 x 1,200,000 residues x
    k = 6, 9, 12, levels 1 and 3 at 1024 bins (the shift mode) and level 1
    at 1000 bins (the multiply-high mode): bins and reachability flags bit
    for bit; its registers, blocks an SM, waves and SASS; timed at level
    1, 1024 bins."""
    import torch

    from sketchtpu_torch import _build
    from sketchtpu_torch.hash import aahash_torch
    from sketchtpu_torch.hash.aahash_torch import (
        aahash_bin_multi,
        aahash_bin_multi_ref,
        pack_aa_group,
    )

    for mode, info in sorted(ptxas_report(
            lib_path, "aahash_multi_kernel",
            {"ILb0E": "multiply-high", "ILb1E": "shift"}).items()):
        print(f"phase2 aahash_bin_multi {mode} kernel: {info['registers']} "
              f"registers, {info['spill_store_bytes']} bytes spilled")
        check(info["spill_store_bytes"] == 0, f"aahash_bin_multi {mode}: "
              f"spills")
    for name, ops in sass_counts(lib_path, "aahash_multi_kernel").items():
        top = sorted(((v, k) for k, v in ops.items()
                      if not k.startswith("LUT")), reverse=True)[:10]
        cas = sum(v for k, v in ops.items() if k.startswith("ATOMS"))
        red = sum(v for k, v in ops.items() if k.startswith("RED"))
        print(f"phase2 SASS {name[-40:]}: "
              f"{sum(v for k, v in ops.items() if not k.startswith('LUT'))} "
              f"instructions, {red} REDG (device-memory min), {cas} ATOMS "
              f"(shared-memory atomics); top "
              f"{', '.join(f'{k} x{v}' for v, k in top)}")
        check(cas == 0 and red > 0, "aahash_bin_multi SASS: a shared-memory "
              "atomic, or no device-memory min")
    codes, starts = pack_aa_group(aa_streams(AA_SAMPLES, AA_RESIDUES, SEED))
    codes_d = torch.from_numpy(codes).cuda()
    starts_d = torch.from_numpy(starts).cuda()
    nbins = S64 * 64
    nk, kmax = len(AA_KMERS), max(AA_KMERS)
    smin = min(aahash_torch._KG, nk) * nbins * 4 <= aahash_torch._SMIN_BYTES
    slots = aahash_torch._slots(nk, kmax, nbins, smin, True, codes_d.device)
    windows = codes.size - min(AA_KMERS) + 1
    run, tiles = aahash_torch.run_shape(windows, slots, kmax, nk)
    blocks = -(-windows // (tiles * 256 * run))
    print(f"phase2 aahash_bin_multi launch at {AA_SAMPLES} x {AA_RESIDUES} "
          f"aa, {nbins} bins: {slots // SMS} blocks an SM, runs of {run} "
          f"starts, {tiles} tiles a block, {blocks} blocks: "
          f"{blocks / slots:.2f} waves")
    for level, bins in ((1, nbins), (3, nbins), (1, 1000)):
        # the twin's second run is timed: its first builds the tap tables
        ref = (lambda: aahash_bin_multi_ref(codes_d, AA_KMERS, level,
                                            starts_d, bins))
        want, want_reach = ref()
        _, plain = timed_once(ref)
        got, reach = aahash_bin_multi(codes_d, AA_KMERS, level, starts_d,
                                      bins)
        check(torch.equal(got, want) and torch.equal(reach, want_reach),
              f"aahash_bin_multi level {level}, {bins} bins: kernel != twin")
        check(bool(reach.all()) and not (got == -1).all(dim=2).any(),
              f"aahash_bin_multi level {level}: an empty or unreachable row")
        del want
        ms = cuda_ms(lambda: aahash_bin_multi(codes_d, AA_KMERS, level,
                                              starts_d, bins), reps=10)
        work = codes.size * nk
        bd = bound(work * AA_ROLL_OPS,
                   codes.size + nk * AA_SAMPLES * (bins * 8 + 4))
        print(f"phase2 aahash_bin_multi level {level}, {bins} bins, "
              f"{AA_SAMPLES} x {AA_RESIDUES} aa, k {AA_KMERS} in one launch: "
              f"bins and flags bit-equal to twin; kernel {ms:.4f} ms"
              f"{' (' + PREVIOUS_AAHASH + ')' if bins == nbins else ''}, "
              f"twin {plain:.2f} ms, bound {bd['bound_ms']:.4f} ms "
              f"({bd['bound_by']}): kernel at "
              f"{100 * bd['bound_ms'] / ms:.1f}%; "
              f"{work / ms / 1e6:.3f} G aa-k/s")
        if level == 1 and bins == nbins:
            results["aahash_bin_multi"] = dict(max_abs_err=0.0, ms=ms,
                                               plain_ms=plain,
                                               library_ms=None, **bd)


def index_signs(n: int, seed: int):
    """The (n, INDEX_SIZE) u16 signs of a derived index (N_CLUSTERS
    independent clusters)."""
    from sketchtpu_torch.synth import derive_signs

    return derive_signs(n, INDEX_SIZE, max(1, n * N_CLUSTERS // N_INDEX),
                        seed)


def signeq_floor_ms(pair_words: float, ops: int) -> float:
    """The least time of `ops` 32-bit integer operations per pair and sign
    word at Hopper's 64 a clock and SM."""
    return pair_words * ops / (64 * SMS * CLOCK_HZ) * 1e3


# pair_count's previous design and the signs mode's (PERF.md's kernel
# table, an H100 80GB HBM3 at 700 W): a 64 x 64 tile of 4 x 4 pairs a
# thread with the XOR / IADD / LOP3 compare, both operands staged per
# column tile; and runs of 64 starts a thread written one 8-byte word a
# lane at a 512-byte stride. And the count / any / all kernel's previous
# design at 8 queries: the same 64 x 64 pair tile (64 query rows a tile,
# zero pads past nq), 16 words of both operands staged a barrier
PREVIOUS_SIGNEQ = {"pair_count": "previous design 73.2170 ms",
                   "nthash_signs": "previous design 0.8907 ms",
                   "count": " (previous design 0.6563 ms)",
                   "any": " (previous design 0.5458 ms)",
                   "all": " (previous design 0.6607 ms)"}
# 32-bit operations a (query, row) pair and sign word of the count / any /
# all compares: two DPX VIADDMNMX and one IADD3 per two words (count), one
# VIADDMNMX (any), one LOP3 (all)
SIGNEQ_OPS = {"count": 1.5, "any": 1, "all": 1}
COMPARE_ROUNDS = 32768  # rounds of 64 compares a thread in the microbenchmark


def phase2_compare(lib_path: Path) -> float:
    """Before any timing of pair_count and the signs mode: the compare
    microbenchmark (XOR / IADD / LOP3 against one VIADDMNMX.U16x2 a word,
    8 x 8 register accumulators a thread, the full grid), pair_count's
    SASS (the DPX opcode required, no emulated vector compare) and both
    kernels' registers (no spills). Returns the DPX compare's rate, word
    compares per second."""
    import torch

    from sketchtpu_torch import _build

    for kernel, modes in (
            ("pair_count_kernel", {"ILb1E": "pair_count resident",
                                   "ILb0E": "pair_count streamed"}),
            ("nthash_signs_kernel", {"nthash_signs_kernel": "nthash_signs"}),
            ("compare_rate_kernel", {"ILi0E": "compare_rate xor",
                                     "ILi1E": "compare_rate dpx"})):
        for mode, info in sorted(ptxas_report(lib_path, kernel, modes).items()):
            print(f"phase2 {mode} kernel: {info['registers']} registers, "
                  f"{info['spill_store_bytes']} bytes spilled")
            check(info["spill_store_bytes"] == 0, f"{mode}: spills")
    found = sass_counts(lib_path, "pair_count_kernel")
    check(len(found) == 2, f"pair_count: {len(found)} instantiations in SASS")
    for name, ops in found.items():
        dpx = sum(v for k, v in ops.items() if k.startswith("VIADDMNMX"))
        emulated = sum(v for k, v in ops.items()
                       if k.startswith(("VSET", "VABS")))
        top = sorted(((v, k) for k, v in ops.items()
                      if not k.startswith("LUT")), reverse=True)[:8]
        print(f"phase2 SASS {name[-45:]}: {dpx} VIADDMNMX.U16x2 (the DPX "
              f"compare), {emulated} VSETP/VABSDIFF; top "
              f"{', '.join(f'{k} x{v}' for v, k in top)}")
        check(dpx >= 64, f"pair_count SASS: {dpx} VIADDMNMX, expected the "
              f"8 x 8 compares of a word")
        check(emulated == 0, "pair_count SASS: emulated vector compares")
    per_sm = _build.query(torch.device("cuda", 0),
                          "stpu_compare_rate_blocks_per_sm")
    check(per_sm > 0, "compare_rate: does not fit an SM")
    blocks = per_sm * torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(blocks * 256, dtype=torch.int32, device="cuda")
    compares = blocks * 256 * COMPARE_ROUNDS * 64
    rates = {}
    for mode, name in ((0, "XOR / IADD / LOP3"), (1, "VIADDMNMX.U16x2")):
        def launch():
            _build.launch(out.device, "stpu_compare_rate", mode, blocks,
                          COMPARE_ROUNDS, out.data_ptr(),
                          what="compare_rate")
        ms = cuda_ms(launch, reps=3)
        rates[mode] = compares / ms * 1e3
        print(f"phase2 compare microbenchmark, {name}: {blocks} blocks x 256 "
              f"threads x {COMPARE_ROUNDS} rounds x 64 word compares in "
              f"{ms:.4f} ms: {rates[mode] / 1e12:.3f} T compares/s, "
              f"{rates[mode] / (SMS * CLOCK_HZ):.2f} a clock and SM at "
              f"{CLOCK_HZ / 1e9:.2f} GHz")
    print(f"phase2 compare microbenchmark: the DPX compare issues "
          f"{rates[1] / rates[0]:.2f}x as fast as XOR / IADD / LOP3")
    return rates[1]


def phase2_signeq(results, lib_path: Path, dpx_rate: float):
    """signeq.cu in every mode against its twin at S in {1, 99, 100, 250,
    1000} with ragged tile and query-group edges, an index with a row
    stride past its words and unaligned row ranges; then timed at the main
    path's shapes: 1, 8 and 101 queries against 661,000 rows at S = 100
    (count, any, all; 101 is what `inverted query` sends a launch at
    661,000 rows) and pair_count's first 8192 rows of the 661,000 (a strip
    of `precluster --count`)."""
    import numpy as np
    import torch

    from sketchtpu_torch import _build
    from sketchtpu_torch.inverted.device import (
        pack_signs,
        pair_count,
        pair_count_ref,
        query_group,
        signeq,
        signeq_ref,
    )

    modes = {f"ILi{m}ELi{q}EEEv": f"{mode} {q} queries a block"
             for m, mode in enumerate(("count", "any", "all"))
             for q in (1, 2, 4, 8, 16)}
    for mode, info in sorted(ptxas_report(lib_path, "signeq_kernel",
                                          modes).items()):
        print(f"phase2 signeq {mode} kernel: {info['registers']} "
              f"registers, {info['spill_store_bytes']} bytes spilled")
        check(info["spill_store_bytes"] == 0, f"signeq {mode}: spills")
    # the SASS of the query modes: the any and count compares as DPX
    # VIADDMNMX, no emulated vector compare
    for name, ops in sass_counts(lib_path, "signeq_kernel").items():
        top = sorted(((v, k) for k, v in ops.items()
                      if not k.startswith("LUT")), reverse=True)[:8]
        dpx = ops["VIADDMNMX.U16"]  # the u16x2 form; a scalar one has none
        emulated = sum(v for k, v in ops.items()
                       if k.startswith(("VSET", "VABS")))
        print(f"phase2 SASS {name[-40:]}: "
              f"{sum(v for k, v in ops.items() if not k.startswith('LUT'))} "
              f"instructions, {dpx} VIADDMNMX.U16x2; top "
              f"{', '.join(f'{k} x{v}' for v, k in top)}")
        check(emulated == 0, "signeq SASS: emulated vector compares")
        check(("ILi2E" in name) == (dpx == 0), f"signeq SASS {name}: "
              f"{dpx} VIADDMNMX.U16x2 (the count and any compares are DPX, "
              f"all's a LOP3)")
    rng = np.random.default_rng(SEED)
    for s in (1, 99, 100, 250, 1000):
        alphabet = 4 if s < 50 else 60
        m_np = rng.integers(0, alphabet, (1100, s)).astype(np.uint16)
        q_np = rng.integers(0, alphabet, (130, s)).astype(np.uint16)
        q_np[0] = m_np[3]
        m, q = pack_signs(m_np, "cuda"), pack_signs(q_np, "cuda")
        wide = torch.zeros((m.shape[0], m.shape[1] + 3), dtype=torch.int32,
                           device="cuda")
        wide[:, : m.shape[1]] = m
        strided = wide[:, : m.shape[1]]  # a row stride past the words
        shapes = ((65, 700), (64, 63), (1, 1), (63, 129), (17, 1100),
                  (101, 1100), (130, 257))
        for nq, n in shapes:
            for mode in ("count", "any", "all"):
                want = signeq_ref(q[:nq], m[:n], s, mode)
                check(torch.equal(signeq(q[:nq], m[:n], s, mode), want)
                      and torch.equal(signeq(q[:nq], strided[:n], s, mode),
                                      want),
                      f"signeq {mode} S={s} ({nq}, {n}): kernel != twin")
        for lo, hi in ((0, 700), (3, 700), (65, 129), (64, 64), (699, 700),
                       (127, 385), (128, 256)):
            check(pair_count(m[:700], s, lo, hi)
                  == pair_count_ref(m[:700], s, lo, hi),
                  f"pair_count S={s} [{lo}, {hi}): kernel != twin")
        print(f"phase2 signeq S={s}: count, any, all at {len(shapes)} shapes "
              f"(contiguous and strided index) and pair_count at 7 row "
              f"ranges equal to the twin")

    sig = index_signs(N_INDEX, SEED + 6)
    m = pack_signs(sig, "cuda")
    words = m.shape[1]
    for nq in (1, 8, 101):
        q = pack_signs(sig[rng.choice(N_INDEX, nq, replace=False)], "cuda")
        for mode in ("count", "any", "all"):
            got = signeq(q, m, INDEX_SIZE, mode)
            want, plain = timed_once(lambda: signeq_ref(q, m, INDEX_SIZE,
                                                        mode))
            check(torch.equal(got, want),
                  f"signeq {mode} ({nq}, {N_INDEX}): kernel != twin")
            ms = cuda_ms(lambda: signeq(q, m, INDEX_SIZE, mode), reps=10)
            pairs = nq * N_INDEX
            ops = SIGNEQ_OPS[mode]
            bd = bound(pairs * words * ops,
                       (nq + N_INDEX) * words * 4 + pairs * got.element_size())
            print(f"phase2 signeq {mode} ({nq}, {N_INDEX}) S={INDEX_SIZE}, "
                  f"{query_group(nq, words)} queries a block: equal to twin; "
                  f"kernel {ms:.4f} ms"
                  f"{PREVIOUS_SIGNEQ[mode] if nq == 8 else ''}, twin "
                  f"{plain:.2f} ms, bound {bd['bound_ms']:.4f} ms "
                  f"({bd['bound_by']}): kernel at "
                  f"{100 * bd['bound_ms'] / ms:.1f}%; integer-issue floor "
                  f"of {ops} operations a word "
                  f"{signeq_floor_ms(pairs * words, ops):.4f} ms; "
                  f"{(nq + N_INDEX) * words * 4 / ms / 1e6:.1f} GB/s of "
                  f"signs read")
            if nq == 8:
                results[f"signeq_{mode}"] = dict(max_abs_err=0.0, ms=ms,
                                                 plain_ms=plain,
                                                 library_ms=None, **bd)
        del q
    hi = 8192
    got = pair_count(m, INDEX_SIZE, 0, hi)
    want, plain = timed_once(lambda: pair_count_ref(m, INDEX_SIZE, 0, hi,
                                                    tile=2048))
    check(got == want, f"pair_count strip: kernel {got} != twin {want}")
    ms = cuda_ms(lambda: pair_count(m, INDEX_SIZE, 0, hi), reps=3)
    pairs = sum(N_INDEX - 1 - i for i in range(hi))
    bd = bound(pairs * words * 3, N_INDEX * words * 4 + 8)
    print(f"phase2 pair_count rows [0, {hi}) of {N_INDEX} S={INDEX_SIZE}: "
          f"{got} of {pairs} pairs share a sign ({100 * got / pairs:.3f}%), "
          f"equal to twin; kernel {ms:.4f} ms "
          f"({PREVIOUS_SIGNEQ['pair_count']}), twin {plain:.2f} ms, bound "
          f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}, 3 operations a "
          f"word): kernel at {100 * bd['bound_ms'] / ms:.1f}%; 3-operation "
          f"integer-issue floor {signeq_floor_ms(pairs * words, 3):.4f} ms; "
          f"DPX issue floor at the measured rate "
          f"{pairs * words / dpx_rate * 1e3:.4f} ms (kernel at "
          f"{100 * pairs * words / dpx_rate * 1e3 / ms:.1f}%); "
          f"{pairs / ms / 1e6:.2f} G pair/s")
    results["pair_count"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain,
                                 library_ms=None, **bd)
    del m
    torch.cuda.empty_cache()


def masked_signs(n: int, s: int, seed: int, device="cuda"):
    """Packed signs of n samples in clusters of about 64, so that a tile
    holds candidates and non-candidates; sample 7 shares no sign."""
    import numpy as np

    from sketchtpu_torch.inverted.device import pack_signs
    from sketchtpu_torch.synth import derive_signs

    sig = derive_signs(n, s, max(1, n // 64), seed, redraw=0.5)
    sig[7] = np.random.default_rng(seed).integers(0, 1 << 16, s)
    return pack_signs(sig, device), sig


def phase2_knn_masked(words, results, lib_path: Path):
    """K3 with the precluster mask, bit-equal to the masked twins: tile
    mode and selection, plain and completeness keys, at knn 50 (2048 x
    8192 across the diagonal, S = 1000 and S = 100) and at knn 1025 (K3's
    tiles and the top-k merge, 256 x 8192)."""
    import torch

    from sketchtpu_torch.dist.knn_kernels import (
        Completeness,
        SignMask,
        knn_keys,
        knn_keys_ref,
        knn_select,
        knn_select_ref,
    )
    from sketchtpu_torch.dist.knn_torch import select_keys

    ptx = ptxas_report(lib_path, "knn_keys_kernel", KNN_MODES_MANGLED)
    for mode, info in sorted(ptx.items()):
        print(f"phase2 knn_keys {mode} kernel: {info['registers']} registers,"
              f" {info['spill_store_bytes']} bytes spilled")
    plane = words[:8192, 0]
    comp = torch.linspace(0.6, 1.0, 8192, device="cuda")
    a = plane[4096:6144]
    for s in (1000, 100):
        w, _ = masked_signs(8192, s, SEED + s)
        sig = SignMask(w[4096:6144], w, s)
        share = torch.zeros(())
        for label, c in (("plain", None),
                         ("completeness",
                          Completeness(comp[4096:6144].contiguous(), comp,
                                       0.64, S64))):
            kw = dict(row0=4096, exclude_self=True, comp=c, sig=sig)
            got = knn_keys(a, plane, col0=0, **kw)
            check(torch.equal(got, knn_keys_ref(a, plane, col0=0, **kw)),
                  f"knn_keys masked {label} S={s}: kernel != twin")
            share = (got >= 0).float().mean()
            sel = knn_select(a, plane, KNN, **kw)
            want, plain = timed_once(lambda: knn_select_ref(a, plane, KNN,
                                                            **kw))
            check(torch.equal(sel, want),
                  f"knn_select masked {label} S={s}: kernel != twin")
            ms = cuda_ms(lambda: knn_select(a, plane, KNN, **kw), reps=10)
            na, nb = a.shape[0], plane.shape[0]
            sw = (s + 1) // 2
            bd = bound(na * nb * (S64 * SB_OPS + sw * 3),
                       (na + nb) * (a.shape[1] * 8 + sw * 4)
                       + na * KNN * sel.element_size())
            floor = (integer_floor_ms(na * nb * S64)
                     + signeq_floor_ms(na * nb * sw, 3))
            print(f"phase2 knn_select masked {label} ({na}, {nb}) S={s} knn "
                  f"{KNN}: {100 * float(share):.2f}% of pairs are candidates;"
                  f" bit-equal to twin (tile mode too); kernel {ms:.4f} ms, "
                  f"twin {plain:.2f} ms, bound {bd['bound_ms']:.4f} ms "
                  f"({bd['bound_by']}): kernel at "
                  f"{100 * bd['bound_ms'] / ms:.1f}%; integer-issue floor "
                  f"(samebits + mask) {floor:.4f} ms")
            if s == 1000 and c is None:
                results["knn_select_masked"] = dict(
                    max_abs_err=0.0, ms=ms, plain_ms=plain, library_ms=None,
                    **bd)
        for label, c in (("plain", None),
                         ("completeness",
                          Completeness(comp[4096:4352].contiguous(), comp,
                                       0.64, S64))):
            kw = dict(row0=4096, exclude_self=True, comp=c,
                      sig=SignMask(w[4096:4352], w, s))
            before = knn_keys.launches
            got = select_keys(plane[4096:4352], plane, 1025, **kw)
            check(knn_keys.launches > before, "knn 1025: no tile launch")
            check(torch.equal(got, knn_select_ref(plane[4096:4352], plane,
                                                  1025, **kw)),
                  f"knn 1025 masked {label} S={s}: tiles + merge != twin")
        print(f"phase2 knn 1025 masked S={s}: K3 tiles + top-k merge "
              f"bit-equal to the twin, plain and completeness")
    # knn 1025 without the mask (the route of `dist --knn 1025`)
    for label, c in (("plain", None),
                     ("completeness",
                      Completeness(comp[4096:4352].contiguous(), comp, 0.64,
                                   S64))):
        kw = dict(row0=4096, exclude_self=True, comp=c)
        got = select_keys(plane[4096:4352], plane, 1025, **kw)
        check(torch.equal(got, knn_select_ref(plane[4096:4352], plane, 1025,
                                              **kw)),
              f"knn 1025 {label}: tiles + merge != twin")
    a, b = plane[4096:6144], plane
    kw = dict(row0=4096, col0=0, nb_real=8192, exclude_self=True)
    ms = cuda_ms(lambda: knn_keys(a, b, **kw), reps=10)
    plain = cuda_ms(lambda: knn_keys_ref(a, b, **kw), reps=2, warmup=0)
    bd = bound(a.shape[0] * b.shape[0] * S64 * SB_OPS,
               (a.shape[0] + b.shape[0]) * a.shape[1] * 8
               + a.shape[0] * b.shape[0] * 4)
    print(f"phase2 knn 1025: bit-equal to the twin, plain and completeness; "
          f"knn_keys plain (2048, 8192) {ms:.4f} ms, twin {plain:.2f} ms")
    results["knn_keys"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain,
                               library_ms=None, **bd)


def phase2_coreacc_masked(words, results):
    """K2's masked key mode at the core/accessory kNN tile (2048 x 8192
    across the diagonal, S = 1000), keys and acc bit-equal to the twin."""
    import torch

    from sketchtpu_torch.dist.coreacc_kernels import (
        coreacc_keys,
        coreacc_keys_ref,
    )
    from sketchtpu_torch.dist.knn_kernels import SignMask

    w, _ = masked_signs(8192, 1000, SEED + 9)
    a, bk = words[4096:6144], words[:8192]
    kw = dict(row0=4096, col0=0, nb_real=8192, exclude_self=True,
              sig=SignMask(w[4096:6144], w, 1000))
    keys, acc = coreacc_keys(a, bk, KMERS, S64 * 64, **kw)
    (want_k, want_a), plain = timed_once(
        lambda: coreacc_keys_ref(a, bk, KMERS, S64 * 64, **kw))
    check(torch.equal(keys, want_k) and torch.equal(acc, want_a),
          "coreacc keys masked: kernel != twin")
    share = float((keys != -(1 << 63)).float().mean())
    del keys, acc, want_k, want_a
    ms = cuda_ms(lambda: coreacc_keys(a, bk, KMERS, S64 * 64, **kw), reps=10)
    na, nb, nk = a.shape[0], bk.shape[0], len(KMERS)
    bd = bound(na * nb * (nk * S64 * SB_OPS + 500 * 3),
               (na + nb) * (a.shape[1] * a.shape[2] * 8 + 500 * 4)
               + na * nb * 12)
    print(f"phase2 coreacc keys masked ({na}, {nb}) nk={nk} S=1000: "
          f"{100 * share:.2f}% of pairs are candidates; bit-equal to twin "
          f"(keys and acc); kernel {ms:.4f} ms, twin {plain:.2f} ms, bound "
          f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}); integer-issue floor "
          f"(samebits + mask) "
          f"{integer_floor_ms(na * nb * nk * S64) + signeq_floor_ms(na * nb * 500, 3):.4f} ms")
    results["coreacc_keys_masked"] = dict(max_abs_err=0.0, ms=ms,
                                          plain_ms=plain, library_ms=None,
                                          **bd)


# --- phase 3: main path against the host oracle ----------------------------

DIST_MODES = {"k17": ["-k", "17"], "ani": ["-k", "17", "--ani"],
              "exact": ["--exact"], "coreacc": []}
KNN_MODES = {"knn_k17": ["-k", "17", "--knn", "3"],
             "knn_ani": ["-k", "17", "--ani", "--knn", "3"],
             "knn_coreacc": ["--knn", "3"]}


def host_env() -> dict:
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["SKETCHTPU_BACKEND"] = "host"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else [])
    )
    return env


def sketch_commands(prefix: Path, rfile: Path, rfile_q: Path, kmers=KMERS,
                    size: int = SKETCH_SIZE):
    p = str(prefix)
    kmers = ",".join(map(str, kmers))
    return [
        ["sketch", "-f", str(rfile), "-o", f"{p}db", "-k", kmers,
         "-s", str(size), "--quiet"],
        ["sketch", "-f", str(rfile_q), "-o", f"{p}q", "-k", kmers,
         "-s", str(size), "--quiet"],
    ]


def dist_commands(prefix: Path, modes: dict, comp: tuple | None = None):
    """Self and cross `dist` of every mode on the phase 3 databases; with
    comp (ref, query completeness files) a `<mode>_comp` run of each too."""
    p = str(prefix)
    cmds = []
    for name, flags in modes.items():
        runs = [(name, [], [])]
        if comp is not None:
            ref = ["--ref-completeness-file", str(comp[0])]
            runs.append((f"{name}_comp", ref,
                         ref + ["--query-completeness-file", str(comp[1])]))
        for label, self_comp, cross_comp in runs:
            cmds.append(["dist", f"{p}db", *flags, *self_comp, "-o",
                         f"{p}self_{label}.txt", "--quiet"])
            cmds.append(["dist", f"{p}db", f"{p}q", *flags, *cross_comp, "-o",
                         f"{p}cross_{label}.txt", "--quiet"])
    return cmds


HOST_JOBS = 4  # host oracle processes at a time


def host_oracle(*stages) -> list[float]:
    """Run the host oracle's commands, a new process each, HOST_JOBS at a
    time within a stage and the stages in order (a stage reads what the
    one before wrote). A command is its argv, or (argv, the path of its
    stdout). Returns each command's seconds, in order."""
    from concurrent.futures import ThreadPoolExecutor

    def one(cmd):
        argv, out = (cmd, None) if isinstance(cmd[0], str) else cmd
        t0 = time.time()
        text = run([sys.executable, "-m", "sketchtpu.cli", *argv],
                   env=host_env())
        if out is not None:
            Path(out).write_text(text)
        return time.time() - t0

    secs = []
    with ThreadPoolExecutor(HOST_JOBS) as pool:
        for stage in stages:
            secs += list(pool.map(one, stage))
    return secs


def run_port_and_host(cli_main, port_cmds, *host_stages):
    """(port seconds, host seconds) of each command: the port in this
    process, in order, then the host oracle (host_oracle's stages)."""
    port_s = []
    for argv in port_cmds:
        t0 = time.time()
        check(cli_main(argv) == 0, f"port {' '.join(argv)} failed")
        port_s.append(time.time() - t0)
    return port_s, host_oracle(*host_stages)


def same_bytes(a: Path, b: Path) -> bool:
    return a.stat().st_size > 0 and a.read_bytes() == b.read_bytes()


def sha256_of(paths) -> str:
    """The SHA-256 of the files' bytes, concatenated in order."""
    import hashlib

    h = hashlib.sha256()
    for path in paths:
        with open(path, "rb") as f:
            while chunk := f.read(1 << 24):
                h.update(chunk)
    return h.hexdigest()


def knife_edge(got, want):
    """Pairs whose f32 and f64 values differ only because the regression
    sits on a discontinuity of the reference's math, where rounding noise
    in either precision picks the branch: a slope at zero (core jumps
    between ~0 and 1) or a flat Jaccard-vs-k profile (the y variance is 0
    up to rounding, so one side takes the degenerate (0, 0) branch and the
    other reports acc = 1 - J)."""
    import numpy as np

    off = (np.abs(got - want) > ATOL).any(axis=1)
    jump = (np.minimum(got[:, 0], want[:, 0]) < 1e-3) & (
        np.maximum(got[:, 0], want[:, 0]) == 1.0)
    flat = (got == 0).all(axis=1) | (want == 0).all(axis=1)
    return off & (jump | flat)


def compare_coreacc(label: str, got_path: Path, want_path: Path) -> None:
    """f32 core/acc output against the f64 chain: same pairs, every value
    within ATOL except knife-edge pairs, which are counted."""
    import numpy as np

    names, got = coreacc_table(got_path)
    want_names, want = coreacc_table(want_path)
    check(names == want_names and got.shape == want.shape and got.size,
          f"{label}: core/acc pairs differ")
    edge = knife_edge(got, want)
    err = float(np.abs(got[~edge] - want[~edge]).max())
    check(err <= ATOL, f"{label}: core/acc off by {err}")
    print(f"{label}: f32 core/acc max |err| {err:.3g} over {got.shape[0]} "
          f"pairs; knife-edge pairs (slope 0 or flat profile): "
          f"{int(edge.sum())}")


def coreacc_table(path: Path):
    import numpy as np

    rows = [ln.split("\t") for ln in path.read_text().splitlines()]
    return ([r[:2] for r in rows],
            np.array([[float(v) for v in r[2:]] for r in rows]))


def phase3_dense(cli_main):
    """The dense path: sketch, then dense dist, against the host oracle."""
    from sketchtpu_torch.synth import related_assemblies

    d = WORK / "p3"
    rfile = related_assemblies(d / "fa", 8, 2_000_000, SEED)
    lines = rfile.read_text().splitlines()
    rfile_q = d / "rfile_q.txt"
    rfile_q.write_text("\n".join(lines[5:]) + "\n")
    port_s, host_s = run_port_and_host(
        cli_main,
        sketch_commands(d / "port_", rfile, rfile_q)
        + dist_commands(d / "port_", DIST_MODES),
        sketch_commands(d / "host_", rfile, rfile_q),
        dist_commands(d / "host_", DIST_MODES),
    )
    SINGLE_WALL["sketch_dna"] = port_s[0]
    mbk = 8 * 2.0 * len(KMERS)
    print(f"phase3 sketch 8 x 2 Mb x {len(KMERS)} k: port {port_s[0]:.3f} s "
          f"= {mbk / port_s[0]:.1f} Mbase-k/s end to end (parse, upload, "
          f"kernels, densify, .skd), host oracle {host_s[0]:.3f} s (a new "
          f"process each)")
    print(f"phase3 all {len(port_s)} commands: port {sum(port_s):.2f} s, "
          f"host oracle {sum(host_s):.2f} process-s, {HOST_JOBS} "
          f"at a time")
    for db in ("db", "q"):
        for ext in (".skd", ".skm"):
            check(same_bytes(d / f"port_{db}{ext}", d / f"host_{db}{ext}"),
                  f"{db}{ext} differs from the host oracle")
    for side in ("self", "cross"):
        for name in ("k17", "ani", "exact"):
            check(same_bytes(d / f"port_{side}_{name}.txt",
                             d / f"host_{side}_{name}.txt"),
                  f"dist {side} {name} differs from the host oracle")
        print(f"phase3 {side}: .skd/.skm, -k 17, --ani, --exact "
              f"byte-identical")
        compare_coreacc(f"phase3 {side} vs host", d / f"port_{side}_coreacc.txt",
                        d / f"host_{side}_coreacc.txt")
    return d


def phase3_knn(cli_main, d: Path) -> None:
    """The kNN path on phase 3's databases, against the host oracle: every
    output byte for byte (the core/accessory selection is f32 on the card,
    its values the f64 chain's; at 8 samples no f32 near-tie is expected)."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    comp = (d / "comp.txt", d / "comp_q.txt")
    for path, names in ((comp[0], range(8)), (comp[1], range(5, 8))):
        path.write_text("".join(f"sample_{i:02d}\t{c:.3f}\n" for i, c in
                                zip(names, rng.uniform(0.6, 1.0, 8))))
    port_s, host_s = run_port_and_host(
        cli_main, dist_commands(d / "port_", KNN_MODES, comp),
        dist_commands(d / "host_", KNN_MODES, comp))
    print(f"phase3 kNN {len(port_s)} commands: port {sum(port_s):.2f} s, "
          f"host oracle {sum(host_s):.2f} process-s, {HOST_JOBS} "
          f"at a time")
    for side in ("self", "cross"):
        for name in KNN_MODES:
            for label in (name, f"{name}_comp"):
                check(same_bytes(d / f"port_{side}_{label}.txt",
                                 d / f"host_{side}_{label}.txt"),
                      f"dist {side} {label} differs from the host oracle")
        print(f"phase3 {side}: --knn 3 -k 17, --ani, core/acc, each with "
              f"and without completeness, byte-identical")
    port_cmds, host_cmds = [], []
    for who, cmds in (("port", port_cmds), ("host", host_cmds)):
        db, q = str(d / f"{who}_db"), str(d / f"{who}_q")
        for side, dbs in (("self", [db]), ("cross", [db, q])):
            cmds.append(["dist", *dbs, "-k", "17", "--knn", "0", "-o",
                         str(d / f"{who}_{side}_knn0.txt"), "--quiet"])
    run_port_and_host(cli_main, port_cmds, host_cmds)
    for side in ("self", "cross"):
        got = (d / f"port_{side}_knn0.txt").read_bytes()
        check(got == b"" == (d / f"host_{side}_knn0.txt").read_bytes(),
              f"dist {side} -k 17 --knn 0: output where the host oracle "
              f"writes none")
    print("phase3 dist -k 17 --knn 0, self and cross: exit 0 and no output, "
          "as the host oracle")


# 625 chunks: past the int16 strips (32,767 bins), where single-k dist and
# --exact take the samebits engine of dist/api.py, K4
K4_SKETCH_SIZE = 40000
K4_KMERS = (17, 21)
K4_MODES = {"k17": ["-k", "17"], "exact": ["--exact"]}


def phase3_k4(cli_main, p3: Path) -> None:
    """K4 on the CLI: phase 3's assemblies sketched at 40,000 bins, then
    `dist -k 17` and `dist --exact`, self and ref-vs-query; .skd/.skm and
    every output byte for byte against the host oracle."""
    d = WORK / "p3k4"
    d.mkdir(parents=True, exist_ok=True)
    rfile, rfile_q = p3 / "fa" / "rfile.txt", p3 / "rfile_q.txt"
    k4 = kernel_wrappers()["samebits_full"]
    before = k4.launches
    port_s, host_s = run_port_and_host(
        cli_main,
        sketch_commands(d / "port_", rfile, rfile_q, K4_KMERS, K4_SKETCH_SIZE)
        + dist_commands(d / "port_", K4_MODES),
        sketch_commands(d / "host_", rfile, rfile_q, K4_KMERS, K4_SKETCH_SIZE),
        dist_commands(d / "host_", K4_MODES),
    )
    SINGLE_WALL["k4_k17"] = port_s[2]  # self -k 17, after the 2 sketches
    for db in ("db", "q"):
        for ext in (".skd", ".skm"):
            check(same_bytes(d / f"port_{db}{ext}", d / f"host_{db}{ext}"),
                  f"-s {K4_SKETCH_SIZE}: {db}{ext} differs from the host oracle")
    for side in ("self", "cross"):
        for name in K4_MODES:
            check(same_bytes(d / f"port_{side}_{name}.txt",
                             d / f"host_{side}_{name}.txt"),
                  f"-s {K4_SKETCH_SIZE} dist {side} {name} differs from the "
                  f"host oracle")
    print(f"phase3 -s {K4_SKETCH_SIZE} -k {','.join(map(str, K4_KMERS))}: "
          f".skd/.skm, -k 17 and --exact, self and cross, byte-identical; "
          f"{k4.launches - before} K4 launches; {len(port_s)} commands: port "
          f"{sum(port_s):.2f} s, host oracle {sum(host_s):.2f} process-s, {HOST_JOBS} "
          f"at a time")


# past K2's by-value k table (MAX_NK_BY_VALUE): 300 k, on assemblies short
# enough for the host oracle's hashing (~0.7 Mbase-k/s on one core)
MANY_K_SEQ = "15,314,1"
MANY_K_LENGTH = 20_000
MANY_K_MODES = {"coreacc": [], "knn_coreacc": ["--knn", "3"]}


def phase3_many_k(cli_main) -> None:
    """`sketch --k-seq 15,314,1` (300 k) of phase 3's 8 synthetic
    assemblies at 20 kb each (its generator and seed; the last 3 the
    query), then dense core/acc and core/acc `--knn 3` dist, self and
    ref-vs-query, on K2's WIDE instantiations: .skd/.skm and the kNN output
    byte for byte against the host oracle, dense core/acc within 1e-5 of
    its f64 chain."""
    from sketchtpu_torch.synth import related_assemblies

    d = WORK / "p3many"
    rfile = related_assemblies(d / "fa", 8, MANY_K_LENGTH, SEED)
    lines = rfile.read_text().splitlines()
    rfile_q = d / "rfile_q.txt"
    rfile_q.write_text("\n".join(lines[5:]) + "\n")

    def sketches(prefix: Path):
        return [["sketch", "-f", str(f), "-o", f"{prefix}{db}", "--k-seq",
                 MANY_K_SEQ, "-s", str(SKETCH_SIZE), "--quiet"]
                for f, db in ((rfile, "db"), (rfile_q, "q"))]

    k2 = kernel_wrappers()["coreacc"]
    before = k2.launches
    port_s, host_s = run_port_and_host(
        cli_main,
        sketches(d / "port_") + dist_commands(d / "port_", MANY_K_MODES),
        sketches(d / "host_"), dist_commands(d / "host_", MANY_K_MODES))
    launches = k2.launches - before
    check(launches > 0, f"--k-seq {MANY_K_SEQ}: no K2 launch")
    for db in ("db", "q"):
        for ext in (".skd", ".skm"):
            check(same_bytes(d / f"port_{db}{ext}", d / f"host_{db}{ext}"),
                  f"--k-seq {MANY_K_SEQ}: {db}{ext} differs from the host "
                  f"oracle")
    for side in ("self", "cross"):
        check(same_bytes(d / f"port_{side}_knn_coreacc.txt",
                         d / f"host_{side}_knn_coreacc.txt"),
              f"--k-seq {MANY_K_SEQ} dist {side} --knn 3 differs from the "
              f"host oracle")
        compare_coreacc(f"phase3 --k-seq {MANY_K_SEQ} {side} vs host",
                        d / f"port_{side}_coreacc.txt",
                        d / f"host_{side}_coreacc.txt")
    print(f"phase3 --k-seq {MANY_K_SEQ} (300 k) 8 x {MANY_K_LENGTH} b: "
          f".skd/.skm and core/acc --knn 3, self and cross, byte-identical; "
          f"{launches} K2 launches; port {sum(port_s):.2f} s (sketch "
          f"{port_s[0]:.2f} s), host oracle {sum(host_s):.2f} process-s, "
          f"{HOST_JOBS} at a time")


# --- phase 3, reads and the inverted index ---------------------------------

def run_cli_stdout(cli_main, argv, path: Path) -> None:
    """The port's CLI in this process with its stdout in `path`."""
    with open(path, "w") as f, contextlib.redirect_stdout(f):
        check(cli_main(argv) == 0, f"port {' '.join(argv)} failed")


def phase3_reads(cli_main, p3: Path) -> Path:
    """`sketch` of synthetic FASTQ (a 500 kb genome at 10x in 150 bp reads,
    one single-file and one paired sample), alone and mixed with phase 3's
    8 assemblies, at --min-count 1, 2 and 3: .skd/.skm byte for byte
    against the host oracle; then each once more with the sign prefilter
    on (SKETCHTPU_FASTQ_PREFILTER=1), which must launch its kernel at
    --min-count 2 and 3."""
    from sketchtpu_torch.synth import read_samples

    d = WORK / "p3reads"
    lines = (read_samples(d / "fq", 1, 500_000, 10, SEED)
             + read_samples(d / "fq", 1, 500_000, 10, SEED + 1, paired=True))
    (d / "reads.txt").write_text("".join(lines))
    (d / "mixed.txt").write_text((p3 / "fa" / "rfile.txt").read_text()
                                 + "".join(lines))
    kmers = ",".join(map(str, KMERS))
    runs = [(inputs, mc) for inputs in ("reads", "mixed") for mc in (1, 2, 3)]

    def cmds(who):
        return [["sketch", "-f", str(d / f"{inputs}.txt"), "-o",
                 str(d / f"{who}_{inputs}_{mc}"), "-k", kmers, "-s",
                 str(SKETCH_SIZE), "--min-count", str(mc), "--threads",
                 THREADS, "--quiet"] for inputs, mc in runs]

    port_s, host_s = run_port_and_host(cli_main, cmds("port"), cmds("host"))
    pf = kernel_wrappers()["sign_prefilter"]
    t0 = time.time()
    with prefilter_knob():
        for (_, mc), argv in zip(runs, cmds("pf")):
            before = pf.launches
            check(cli_main(argv) == 0, f"port {' '.join(argv)} failed")
            check((pf.launches > before) == (mc >= 2),
                  f"phase3 prefilter on, --min-count {mc}: "
                  f"{pf.launches - before} launches of sign_prefilter")
    pf_s = time.time() - t0
    for inputs, mc in runs:
        for who in ("port", "pf"):
            for ext in (".skd", ".skm"):
                check(same_bytes(d / f"{who}_{inputs}_{mc}{ext}",
                                 d / f"host_{inputs}_{mc}{ext}"),
                      f"sketch {inputs} --min-count {mc} ({who}): {ext} "
                      f"differs from the host oracle")
    print(f"phase3 reads: `sketch` of 2 read samples (5 Mb of 150 bp reads "
          f"each, one paired) alone and with the 8 assemblies, --min-count "
          f"1, 2, 3, {len(KMERS)} k: .skd/.skm byte-identical; port "
          f"{sum(port_s):.2f} s, with the prefilter on {pf_s:.2f} s, host "
          f"oracle {sum(host_s):.2f} process-s, {HOST_JOBS} at a time")
    return d


PRECLUSTER_FORMS = {  # the .ski's k, 17
    "k17": [], "ani": ["--ani"],
    "comp": ["--ref-completeness-file"],
    "singleton": ["--retain-unmatched", "singleton"],
    "bruteforce": ["--retain-unmatched", "bruteforce"],
    "coreacc": ["--core-acc"],
}


# --knn 0: no neighbour; a singleton row still holds its own sample
PRECLUSTER_KNN0 = {
    "knn0": [], "knn0_bruteforce": ["--retain-unmatched", "bruteforce"],
    "knn0_singleton": ["--retain-unmatched", "singleton"],
}


def phase3_inverted(cli_main, reads: Path) -> None:
    """The inverted index on the mixed inputs (8 assemblies + 2 read
    samples), every output byte for byte against the host oracle: build
    at -s 100 -k 17 and at the default -s 1000 with --species-names and
    --metadata (.ski and .skq), info (plain, --sample-info), query of every
    type, precluster --count, precluster --skd --knn 3 in every form; then
    one `inverted serve` round against the in-memory answers."""
    import numpy as np

    d = WORK / "p3inv"
    d.mkdir(parents=True, exist_ok=True)
    mixed = reads / "mixed.txt"
    names = [ln.split("\t")[0] for ln in mixed.read_text().splitlines()]
    (d / "species.txt").write_text("".join(
        f"{nm}\tspecies_{i % 3}\n" for i, nm in enumerate(names)))
    (d / "meta.txt").write_text("".join(
        f"{nm}\tmeta {i}\n" for i, nm in enumerate(names)))
    rng = np.random.default_rng(SEED + 7)
    comp = d / "comp.txt"
    comp.write_text("".join(f"{nm}\t{c:.3f}\n" for nm, c in
                            zip(names, rng.uniform(0.6, 1.0, len(names)))))
    skd_db = reads / "port_mixed_2"  # sketched at all 7 k

    def builds(who):
        p = str(d / who)
        return [
            (["inverted", "build", "-f", str(mixed), "-o", f"{p}_inv", "-s",
              "100", "-k", "17", "--write-skq", "--threads", THREADS,
              "--quiet"], None),
            (["inverted", "build", "-f", str(mixed), "-o", f"{p}_inv_sp",
              "-k", "17", "--write-skq", "--species-names",
              str(d / "species.txt"), "--metadata", str(d / "meta.txt"),
              "--threads", THREADS, "--quiet"], None),
        ]

    def commands(who):  # on the index that builds(who) wrote
        p = str(d / who)
        files = [
            (["info", f"{p}_inv_sp.ski"], f"{p}_info.txt"),
            (["info", f"{p}_inv_sp.ski", "--sample-info"],
             f"{p}_info_samples.txt"),
            (["inverted", "precluster", f"{p}_inv.ski", "--count", "--quiet"],
             f"{p}_count.txt"),
        ]
        for q in ("match-count", "all-bins", "any-bins"):
            files.append((["inverted", "query", f"{p}_inv_sp.ski", "-f",
                           str(mixed), "--query-type", q, "-o",
                           f"{p}_query_{q}.txt", "--threads", THREADS,
                           "--quiet"], None))
        for form, flags in PRECLUSTER_FORMS.items():
            flags = flags + [str(comp)] if form == "comp" else flags
            files.append((["inverted", "precluster", f"{p}_inv.ski", "--skd",
                           str(skd_db), "--knn", "3", *flags, "-o",
                           f"{p}_pc_{form}.txt", "--quiet"], None))
        for form, flags in PRECLUSTER_KNN0.items():
            files.append((["inverted", "precluster", f"{p}_inv.ski", "--skd",
                           str(skd_db), "--knn", "0", *flags, "-o",
                           f"{p}_pc_{form}.txt", "--quiet"], None))
        return files

    pairs = kernel_wrappers()["pair_count"]
    pf = kernel_wrappers()["sign_prefilter"]
    with prefilter_knob():  # the default --min-count, 5
        before = pf.launches
        for argv, _ in builds("pf"):
            check(cli_main(argv) == 0, f"port {' '.join(argv)} failed")
        check(pf.launches > before, "phase3 inverted build with the "
              "prefilter on did not launch sign_prefilter")
    t0 = time.time()
    for argv, out in builds("port") + commands("port"):
        before = pairs.launches
        if out is None:
            check(cli_main(argv) == 0, f"port {' '.join(argv)} failed")
        else:
            run_cli_stdout(cli_main, argv, Path(out))
        check("--count" not in argv or pairs.launches > before,
              "phase3 precluster --count did not launch pair_count")
    port_s = time.time() - t0
    t0 = time.time()
    host_oracle(builds("host"), commands("host"))
    host_s = time.time() - t0
    outputs = (["inv.ski", "inv.skq", "inv_sp.ski", "inv_sp.skq", "info.txt",
                "info_samples.txt", "count.txt"]
               + [f"query_{q}.txt" for q in ("match-count", "all-bins",
                                              "any-bins")]
               + [f"pc_{form}.txt" for form in PRECLUSTER_FORMS])
    for name in outputs:
        check(same_bytes(d / f"port_{name}", d / f"host_{name}"),
              f"inverted {name} differs from the host oracle")
    for name in outputs[:4]:
        check(same_bytes(d / f"pf_{name}", d / f"host_{name}"),
              f"inverted {name} with the prefilter on differs from the host "
              f"oracle")
    for form in PRECLUSTER_KNN0:
        got = (d / f"port_pc_{form}.txt").read_bytes()
        check(got == (d / f"host_pc_{form}.txt").read_bytes()
              and bool(got) == (form == "knn0_singleton"),
              f"precluster --knn 0 {form} differs from the host oracle")
    plain = (d / "port_pc_k17.txt").read_text()
    check(plain != (d / "port_pc_singleton.txt").read_text()
          and plain != (d / "port_pc_bruteforce.txt").read_text(),
          "precluster: no row without candidates (retain-unmatched unused)")
    print(f"phase3 inverted: precluster --knn 0 (plain, bruteforce: no "
          f"output; singleton: each row its own) as the host oracle")
    print(f"phase3 inverted: both builds with the prefilter on "
          f"({', '.join(outputs[:4])}) byte-identical to the host oracle")
    print(f"phase3 inverted: {', '.join(outputs)} byte-identical "
          f"({(d / 'port_count.txt').read_text().strip()}); port "
          f"{port_s:.2f} s, host oracle {host_s:.2f} s")
    serve_round(d / "port_inv_sp", p3_query=(mixed, names))


def serve_round(prefix: Path, p3_query) -> None:
    """`inverted serve` on the port's engines (the card): GET /info and
    POST /match-count of one assembly's FASTA against the in-memory
    answers (the index's own info and its host match counts)."""
    import http.client
    import threading

    from sketchtpu_torch.inverted.index import Inverted
    from sketchtpu_torch.inverted.serve import _info_payload, make_server
    from sketchtpu_torch.runtime import select_backend, select_inverted_engine
    from sketchtpu_torch.sketchcore.sketch import HashType

    mixed, names = p3_query
    fasta = Path(mixed.read_text().splitlines()[0].split("\t")[1])
    inv = Inverted.load(str(prefix))
    srv = make_server(inv, "127.0.0.1", 0,
                      backend=select_backend(HashType("dna"), 1),
                      engine=select_inverted_engine(inv))
    threading.Thread(target=srv.serve_forever, daemon=True).start()

    def ask(method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1],
                                          timeout=120)
        try:
            conn.request(method, path, body=body)
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())
        finally:
            conn.close()

    try:
        status, info = ask("GET", "/info")
        check(status == 200 and info == _info_payload(inv), "serve /info")
        status, got = ask("POST", "/match-count?name=q", fasta.read_bytes())
        queries, _ = inv.sketch_queries([("q", [str(fasta)])], 5, 20)
        want = [int(c) for c in inv.query_match_count(queries[0])]
        check(status == 200 and got["counts"] == want
              and got["samples"] == list(inv.sample_names),
              "serve /match-count differs from the in-memory answer")
        check(max(want) == inv.sketch_size, "serve: the query misses itself")
    finally:
        srv.shutdown()
        srv.server_close()
    print(f"phase3 serve: GET /info and POST /match-count ({fasta.name}) "
          f"equal to the in-memory answers")


def phase3_knn1025(cli_main, p3: Path) -> None:
    """`dist -k 17 --knn 1025` on 1100 samples derived from phase 3's
    sketches: past K3's selection limit, byte for byte against the host
    oracle."""
    from sketchtpu_torch.synth import derive_database

    d = WORK / "p3knn1025"
    d.mkdir(parents=True, exist_ok=True)
    derive_database(str(p3 / "port_db"), str(d / "db"), 1100, SEED + 8)
    argv = ["dist", str(d / "db"), "-k", "17", "--knn", "1025", "--quiet"]
    tiles = kernel_wrappers()["knn_keys"]
    before = tiles.launches
    port_s, host_s = run_port_and_host(
        cli_main, [argv + ["-o", str(d / "port.txt")]],
        [argv + ["-o", str(d / "host.txt")]])
    check(same_bytes(d / "port.txt", d / "host.txt"),
          "dist --knn 1025 differs from the host oracle")
    print(f"phase3 dist -k 17 --knn 1025 on 1100 samples: byte-identical; "
          f"{tiles.launches - before} K3 tile launches; port {port_s[0]:.2f} "
          f"s, host oracle {host_s[0]:.2f} s")


# --- phase 4: a database of the size users run -----------------------------

def scan_dist_file(path: Path, n_values: int) -> int:
    """Line count of a dist output; fails on a line with the wrong number
    of fields or a value that is not finite."""
    lines = 0
    tail = b""
    with open(path, "rb") as f:
        while chunk := f.read(1 << 26):
            chunk = tail + chunk
            cut = chunk.rfind(b"\n") + 1
            body, tail = chunk[:cut], chunk[cut:]
            lines += body.count(b"\n")
            check(b"nan" not in body.lower() and b"inf" not in body,
                  f"{path.name}: non-finite value")
            check(body.count(b"\t") == body.count(b"\n") * (1 + n_values),
                  f"{path.name}: malformed line")
    check(tail == b"", f"{path.name}: unterminated last line")
    return lines


def profiled_run(cli_main, argv, label: str):
    """(wall, {device event name: [us, count]}) of one more CLI run under
    torch.profiler. A trace holding fewer of the port's kernels than its
    wrappers launched lost records: it is taken once more, and if it loses
    them again the run's device time is reported as not measured (None)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in (1, 2):
        before = sum(fn.launches for fn in kernel_wrappers().values())
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            check(cli_main(argv) == 0, f"profiled {label} failed")
            torch.cuda.synchronize()
            wall = time.time() - t0
        launched = sum(fn.launches for fn in kernel_wrappers().values()) - before
        by_name: dict[str, list] = {}
        for e in prof.events():  # device-side activity only: kernels, copies
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and e.name != "Activity Buffer Request"):
                tot = by_name.setdefault(e.name, [0.0, 0])
                tot[0] += e.time_range.elapsed_us()
                tot[1] += 1
        traced = sum(n for name, (_, n) in by_name.items()
                     if "(anonymous namespace)::" in name)
        if traced >= launched:
            return wall, by_name
        print(f"{label} profile (attempt {attempt}): the trace holds {traced} "
              f"of the port's {launched} kernel launches")
    return wall, None


def profile_dist(cli_main, argv, label: str, no_sort: bool = False,
                 forbid: tuple = ()) -> float:
    """One more run of a CLI command under torch.profiler: device time by
    kernel against the host clock. Returns the device's busy share. With
    no_sort the run fails if a top-k, sort or concatenation kernel ran,
    and if a kernel whose name holds one of `forbid` ran. None where the
    profiler lost the run's kernel records."""
    wall, by_name = profiled_run(cli_main, argv, label)
    if by_name is None:
        print(f"{label} profile: device time not measured (the profiler "
              f"lost kernel records twice)")
        check(not no_sort, f"{label}: no trace to check for sorts")
        return None
    banned = [name for name in by_name
              if any(part in name.lower() for part in forbid)]
    check(not banned, f"{label}: kernels named {forbid} ran: {banned[:3]}")
    rows = sorted(((us, n, name) for name, (us, n) in by_name.items()),
                  reverse=True)
    busy_ms = sum(us for us, _, _ in rows) / 1e3
    print(f"{label} profile: wall {wall:.3f} s (profiler on), device "
          f"kernels + copies {busy_ms:.2f} ms = "
          f"{100 * busy_ms / 1e3 / wall:.2f}% of wall")
    for us, count, key in rows[:6]:
        print(f"  {us / 1e3:10.3f} ms  x{count:<5d} {key[:90]}")
    for what, parts in (("aaHash (aahash_multi_kernel)",
                         ("aahash_multi_kernel",)),
                        ("K2 (coreacc_kernel)", ("coreacc_kernel",)),
                        ("K3 selection (knn_select_kernel, knn_merge_kernel)",
                         ("knn_select_kernel", "knn_merge_kernel")),
                        (f"sign prefilter ({', '.join(PF_KERNELS)})",
                         PF_KERNELS),
                        ("PyTorch elementwise kernels", ("elementwise",)),
                        ("top-k, sort and concatenation kernels",
                         ("topk", "sort", "catarray"))):
        sel = [(us, n) for us, n, name in rows
               if any(part in name.lower() for part in parts)]
        print(f"  {what}: {sum(us for us, _ in sel) / 1e3:.3f} ms in "
              f"{sum(n for _, n in sel)} launches")
    if no_sort:
        check(not sel, f"{label}: top-k, sort or concatenation kernels ran: "
              f"{[name for _, _, name in rows if any(p in name.lower() for p in ('topk', 'sort', 'catarray'))][:3]}")
    return busy_ms / 1e3 / wall


def phase4(cli_main, parent_db: Path, gpu: str) -> None:
    import numpy as np

    from sketchtpu_torch.synth import derive_database

    d = WORK / "p4"
    d.mkdir(parents=True, exist_ok=True)
    db = d / "db8k"
    derive_database(str(parent_db), str(db), N_SCALE, SEED)
    pairs = N_SCALE * (N_SCALE - 1) // 2
    for name, flags, n_values in (("coreacc", [], 2), ("k17", ["-k", "17"], 1)):
        out = d / f"{name}.txt"
        wall = timed_cli(cli_main, ["dist", str(db), *flags, "-o", str(out),
                                    "--quiet"], f"phase4 dist {name} n={N_SCALE}")
        lines = scan_dist_file(out, n_values)
        check(lines == pairs, f"{name}: {lines} lines, expected {pairs}")
        SINGLE_WALL[f"dense_{name}"] = wall
        SINGLE_SHA256[f"dense_{name}"] = sha256_of([out])
        print(f"phase4 dist {name} n={N_SCALE}: {pairs} pairs in {wall:.2f} s "
              f"= {pairs / wall / 1e6:.3f} M pairs/s end to end (load, "
              f"kernels, host format, {out.stat().st_size / 1e9:.2f} GB "
              f"written), {gpu}")
        profile_dist(cli_main, ["dist", str(db), *flags, "-o", str(out),
                                "--quiet"], f"phase4 dist {name} n={N_SCALE}")
        out.unlink()
    names = [f"derived_{i:05d}" for i in
             np.random.default_rng(SEED).choice(N_SCALE, 512, replace=False)]
    subset = d / "subset.txt"
    subset.write_text("\n".join(sorted(names)) + "\n")
    for name, flags in (("f32", []), ("exact", ["--exact"])):
        check(cli_main(["dist", str(db), "--subset", str(subset), *flags,
                        "-o", str(d / f"subset_{name}.txt"), "--quiet"]) == 0,
              f"subset dist {name} failed")
    check(scan_dist_file(d / "subset_f32.txt", 2) == 512 * 511 // 2,
          "subset pair count")
    compare_coreacc("phase4 --subset 512 vs --exact", d / "subset_f32.txt",
                    d / "subset_exact.txt")


# --- phase 5: kNN at the size users run ------------------------------------

def phase5_run(cli_main, parent_db: Path, gpu: str) -> Path:
    """`dist -k 17 --knn 50` over N_KNN samples and core/accessory
    `dist --knn 50` over the first N_KNN_CA (by --subset), each timed,
    then once more under torch.profiler."""
    from sketchtpu_torch.synth import derive_database

    d = WORK / "p5"
    d.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    derive_database(str(parent_db), str(d / "db"), N_KNN, SEED + 5)
    print(f"phase5 derived {N_KNN} samples x {len(KMERS)} k in "
          f"{time.time() - t0:.1f} s (set-up)")
    (d / "first.txt").write_text(
        "".join(f"derived_{i:05d}\n" for i in range(N_KNN_CA)))
    runs = (("k17", N_KNN, ["-k", "17"]),
            ("coreacc", N_KNN_CA, ["--subset", str(d / "first.txt")]))
    for name, n, flags in runs:
        argv = ["dist", str(d / "db"), *flags, "--knn", str(KNN), "-o",
                str(d / f"{name}.txt"), "--quiet"]
        wall = timed_cli(cli_main, argv, f"phase5 dist --knn {KNN} {name} n={n}")
        SINGLE_WALL[f"knn_{name}"] = wall
        print(f"phase5 dist --knn {KNN} {name} n={n}: {wall:.2f} s = "
              f"{n * n / wall / 1e6:.1f} M scanned pairs/s end to end (load, "
              f"upload, scan, selection, host f64 values, "
              f"{(d / f'{name}.txt').stat().st_size / 1e6:.0f} MB written), "
              f"{gpu}")
        profile_dist(cli_main, argv, f"phase5 dist --knn {KNN} {name} n={n}",
                     no_sort=name == "k17")
    return d


def knn_lines(path: Path, n: int, rows):
    """Lines of the given rows of a self kNN output over n samples, which
    has KNN lines per row in row order: (len(rows), KNN) neighbour ids and
    (len(rows), KNN, fields) values."""
    import numpy as np

    lines = path.read_bytes().split(b"\n")
    check(lines[-1] == b"" and len(lines) - 1 == n * KNN,
          f"{path.name}: {len(lines) - 1} lines, expected {n * KNN}")
    fields = [ln.split(b"\t") for r in rows
              for ln in lines[r * KNN : (r + 1) * KNN]]
    names = np.array([int(f[0][8:]) for f in fields])
    check((names == np.repeat(rows, KNN)).all(), f"{path.name}: row order")
    cols = np.array([int(f[1][8:]) for f in fields]).reshape(len(rows), KNN)
    vals = np.array([[float(v) for v in f[2:]] for f in fields])
    return cols, vals.reshape(len(rows), KNN, -1)


def phase5_check(d: Path) -> None:
    """CHECK_ROWS seeded random rows of each phase 5 output against full
    rows of samebits (K1) and the f64 chain on the host: single-k
    neighbours in the host path's order (samebits descending, column
    ascending) with its values; core/accessory values exactly, and
    neighbour sets equal to the f64 selection except in rows whose
    knn-th and next f64 core distances lie within 1e-6 (counted)."""
    import numpy as np
    import torch

    from sketchtpu_torch.dist.jaccard_np import (
        core_acc_from_jaccards,
        jaccard_from_samebits,
    )
    from sketchtpu_torch.dist.samebits_kernels import samebits, to_device_words
    from sketchtpu_torch.formats.skm import MultiSketch

    ms = MultiSketch.load_metadata(str(d / "db"))
    ms.read_sketch_data(str(d / "db"))
    words = to_device_words(ms, torch.device("cuda"))
    rng = np.random.default_rng(SEED)

    rows = np.sort(rng.choice(N_KNN, CHECK_ROWS, replace=False))
    cols, vals = knn_lines(d / "k17.txt", N_KNN, rows)
    sb = samebits(words[torch.from_numpy(rows).cuda(), 0], words[:, 0],
                  out_dtype=torch.int32).cpu().numpy().astype(np.int64)
    key = (sb << 32) | (0xFFFFFFFF - np.arange(N_KNN))
    key[np.arange(CHECK_ROWS), rows] = -1
    top = np.argpartition(-key, KNN, axis=1)[:, :KNN]
    top = np.take_along_axis(top, np.argsort(
        -np.take_along_axis(key, top, 1), axis=1), 1)
    check((cols == top).all(), "phase5 k17: neighbours differ")
    j = jaccard_from_samebits(np.take_along_axis(sb, top, 1), ms.sketchsize64)
    want = (1.0 - j).astype(np.float32)
    check((vals[:, :, 0].astype(np.float32) == want).all(),
          "phase5 k17: values differ")
    print(f"phase5 k17: {CHECK_ROWS} rows' neighbours and values equal to "
          f"full rows (K1) with the host's selection")

    n = N_KNN_CA
    rows = np.sort(rng.choice(n, CHECK_ROWS, replace=False))
    cols, vals = knn_lines(d / "coreacc.txt", n, rows)
    near, near_differ = 0, 0
    for c0 in range(0, CHECK_ROWS, 64):
        blk = rows[c0 : c0 + 64]
        blk_t = torch.from_numpy(blk).cuda()
        jaccs = np.empty((blk.size * n, len(KMERS)))
        for ki in range(len(KMERS)):
            sbk = samebits(words[blk_t, ki], words[:n, ki], out_dtype=torch.int32)
            jaccs[:, ki] = jaccard_from_samebits(sbk.cpu().numpy().reshape(-1),
                                                 ms.sketchsize64)
        core, acc = core_acc_from_jaccards(jaccs, KMERS, ms.sketch_size)
        core, acc = core.reshape(blk.size, n), acc.reshape(blk.size, n)
        for i, r in enumerate(blk):
            got_c = cols[c0 + i]
            got_v = vals[c0 + i].astype(np.float32)
            check((got_v[:, 0] == core[i, got_c]).all()
                  and (got_v[:, 1] == acc[i, got_c]).all(),
                  f"phase5 coreacc row {r}: values differ from the f64 chain")
            ranked = core[i].copy()
            ranked[r] = np.inf
            order = np.argsort(ranked, kind="stable")[: KNN + 1]
            tie = ranked[order[KNN]] - ranked[order[KNN - 1]] <= 1e-6
            near += int(tie)
            if set(got_c) != set(order[:KNN]):
                check(tie, f"phase5 coreacc row {r}: neighbours differ")
                near_differ += 1
    print(f"phase5 coreacc: {CHECK_ROWS} rows' values equal to the f64 chain; "
          f"neighbour sets equal to the f64 selection except {near_differ} "
          f"rows, all among the {near} rows whose {KNN}th and next f64 core "
          f"distances lie within 1e-6")


# --- phase 6: reads and the inverted index at the sizes users run ----------

def phase6_reads(cli_main, gpu: str) -> None:
    """2 read samples of 50 Mb (a 2 Mb genome at 25x in 150 bp reads) at
    7 k and --min-count 5, with the sign prefilter off and on: each timed
    (its copies to the host and the signs reaching the host's count
    filter counted) and profiled, the two .skd/.skm byte-identical; the
    host oracle at k 17 and 29 only (its NumPy hash takes ~10 s per k and
    sample), byte for byte against both."""
    d = WORK / "p6reads"
    rfile = phase6_reads_files()

    def argv(prefix, kmers):
        return ["sketch", "-f", str(rfile), "-o", str(prefix),
                "-k", ",".join(map(str, kmers)), "-s", str(SKETCH_SIZE),
                "--min-count", "5", "--threads", THREADS, "--quiet"]

    mbk = 2 * READS_GENOME * READS_COVERAGE / 1e6 * len(KMERS)
    walls, traffic, busy = {"off": [], "on": []}, {}, {}
    for who in ("off", "on", "on", "off"):  # in turns: off, on, on, off
        full = argv(d / ("port7" if who == "off" else "port7_pf"), KMERS)
        with prefilter_knob() if who == "on" else contextlib.nullcontext():
            with reads_traffic() as seen:
                walls[who].append(timed_cli(
                    cli_main, full, f"phase6 sketch reads 7 k, prefilter "
                    f"{who}", expect=("sign_prefilter",) if who == "on"
                    else ()))
            print(f"phase6 sketch 2 x 50 Mb of reads x {len(KMERS)} k "
                  f"--min-count 5, prefilter {who}: {walls[who][-1]:.2f} s "
                  f"= {mbk / walls[who][-1]:.1f} Mbase-k/s end to end (parse,"
                  f" upload, signs, {'prefilter kernels, gather, ' if who == 'on' else ''}"
                  f"copy back, compaction, count filter on {THREADS} "
                  f"threads, .skd); {seen['d2h_bytes'] / 1e6:.1f} MB "
                  f"copied to the host, {seen['filter_signs']} signs into "
                  f"the count filter; the prefilter's step on "
                  f"{seen['prefilter_rows']} rows {seen['prefilter_ms']:.2f} "
                  f"ms of device time (CUDA events); peak device memory "
                  f"{seen['peak_allocated'] / 2**30:.2f} GiB allocated ("
                  f"{seen['base_allocated'] / 2**30:.2f} GiB on entry), "
                  f"{seen['peak_reserved'] / 2**30:.2f} GiB reserved; {gpu}")
            if who not in busy:
                traffic[who] = seen
                # with the prefilter on, no sort runs on the card
                busy[who] = profile_dist(
                    cli_main, full, f"phase6 sketch reads 7 k, prefilter "
                    f"{who}", forbid=("sort",) if who == "on" else ())
    SINGLE_WALL["sketch_reads"] = walls["off"][0]
    SINGLE_WALL["sketch_reads_prefilter"] = walls["on"][0]
    for ext in (".skd", ".skm"):
        check(same_bytes(d / f"port7{ext}", d / f"port7_pf{ext}"),
              f"phase6 reads {ext}: the prefilter on differs from off")
    kept = traffic["on"]["filter_signs"] / traffic["off"]["filter_signs"]
    check(kept < 1, "phase6 reads: the prefilter dropped no sign")
    share = lambda b: "not measured" if b is None else f"{100 * b:.2f}%"  # noqa: E731
    print(f"phase6 reads prefilter off / on: .skd/.skm byte-identical; walls "
          f"in turns (off, on, on, off) {walls['off'][0]:.2f}, "
          f"{walls['on'][0]:.2f}, {walls['on'][1]:.2f}, "
          f"{walls['off'][1]:.2f} s; copied to the host "
          f"{traffic['off']['d2h_bytes'] / 1e6:.1f} / "
          f"{traffic['on']['d2h_bytes'] / 1e6:.1f} MB; into the count filter "
          f"{traffic['off']['filter_signs']} / "
          f"{traffic['on']['filter_signs']} signs: kept {100 * kept:.2f}% "
          f"(one segment a stream); card busy {share(busy['off'])} / "
          f"{share(busy['on'])} (profiled runs); {gpu}")
    port_s, host_s = run_port_and_host(
        cli_main, [argv(d / "port2", READS_ORACLE_KMERS)],
        [argv(d / "host2", READS_ORACLE_KMERS)])
    with prefilter_knob():
        pf_s = timed_cli(cli_main, argv(d / "port2_pf", READS_ORACLE_KMERS),
                         "phase6 sketch reads k 17, 29, prefilter on",
                         expect=("sign_prefilter",))
    for who in ("port2", "port2_pf"):
        for ext in (".skd", ".skm"):
            check(same_bytes(d / f"{who}{ext}", d / f"host2{ext}"),
                  f"phase6 reads {who}{ext} differs from the host oracle")
    print(f"phase6 reads at k {READS_ORACLE_KMERS}, prefilter off and on: "
          f".skd/.skm byte-identical to the host oracle (port {port_s[0]:.2f}"
          f" / {pf_s:.2f} s, host oracle {host_s[0]:.2f} s)")


def phase6_index(cli_main, p3: Path, gpu: str) -> None:
    """A derived index of N_INDEX samples at S = INDEX_SIZE, k = 17: `info`,
    `precluster --count` (its count also held against the twin on sampled
    row strips and against row-range partials on the card) and phase 3's 8
    assemblies as `inverted query` of every type, against the host
    oracle."""
    import numpy as np
    import torch

    from sketchtpu_torch.inverted.device import (
        pack_signs,
        pair_count,
        pair_count_ref,
    )
    from sketchtpu_torch.synth import write_derived_inverted

    d = WORK / "p6inv"
    d.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    sig = index_signs(N_INDEX, SEED + 11)
    names = [f"sample_{i:06d}" for i in range(N_INDEX)]
    write_derived_inverted(str(d / "idx"), names, sig, INDEX_K)
    print(f"phase6 derived an index of {N_INDEX} samples at S={INDEX_SIZE} "
          f"k={INDEX_K} ({N_CLUSTERS} clusters; "
          f"{(d / 'idx.ski').stat().st_size / 1e6:.0f} MB .ski, "
          f"{sig.nbytes / 1e6:.0f} MB of signs) in {time.time() - t0:.1f} s "
          f"(set-up)")
    wall = timed_cli(cli_main, ["info", str(d / "idx.ski")], "phase6 info",
                     d / "info.txt")
    check(f"n_samples={N_INDEX}" in (d / "info.txt").read_text(),
          "phase6 info: wrong sample count")
    print(f"phase6 info on the {N_INDEX}-sample .ski: {wall:.2f} s (load and "
          f"the per-bin statistics on the host), {gpu}")
    argv = ["inverted", "precluster", str(d / "idx.ski"), "--count", "--quiet"]
    wall = timed_cli(cli_main, argv, "phase6 precluster --count",
                     d / "count.txt", expect=("pair_count",))
    SINGLE_WALL["count"] = wall
    line = (d / "count.txt").read_text().strip()
    count, total = int(line.split()[1]), int(line.split()[-1])
    check(total == N_INDEX * (N_INDEX - 1) // 2 and 0 < count < total // 50,
          f"phase6 count: {line}")
    print(f"phase6 precluster --count n={N_INDEX}: {line}; candidate share "
          f"{100 * count / total:.4f}%; {wall:.2f} s = "
          f"{total / wall / 1e9:.2f} G pairs/s end to end (load, upload, "
          f"count), {gpu}")
    profile_dist(cli_main, argv, "phase6 precluster --count")
    m = pack_signs(sig, "cuda")
    rng = np.random.default_rng(SEED + 13)
    cuts = [0, 1, N_INDEX // 7 + 3, N_INDEX * 3 // 5, N_INDEX]
    with uncounted():
        for lo in sorted(rng.choice(N_INDEX - 256, 3, replace=False)):
            got = pair_count(m, INDEX_SIZE, int(lo), int(lo) + 256)
            want = pair_count_ref(m, INDEX_SIZE, int(lo), int(lo) + 256,
                                  tile=2048)
            check(got == want,
                  f"phase6 pair_count strip at {lo}: {got} != {want}")
        parts = sum(pair_count(m, INDEX_SIZE, a, b)
                    for a, b in zip(cuts, cuts[1:]))
    check(parts == count, f"phase6 row-range partials {parts} != {count}")
    print("phase6 count: 3 strips of 256 rows equal to the twin on the card; "
          "the partials over 4 row ranges sum to the CLI's count")
    del m
    torch.cuda.empty_cache()
    rfile = p3 / "fa" / "rfile.txt"
    types = ("match-count", "all-bins", "any-bins")

    def qargv(q, who):
        return ["inverted", "query", str(d / "idx.ski"), "-f", str(rfile),
                "--query-type", q, "--threads", THREADS, "--quiet", "-o",
                str(d / f"{who}_{q}.txt")]

    walls = {q: timed_cli(cli_main, qargv(q, "port"), f"phase6 query {q}")
             for q in types}
    SINGLE_WALL.update({f"query661k_{q}": w for q, w in walls.items()})
    host_s = host_oracle([qargv(q, "host") for q in types])
    for q in types:
        check(same_bytes(d / f"port_{q}.txt", d / f"host_{q}.txt"),
              f"phase6 query {q} differs from the host oracle")
        print(f"phase6 query {q}: 8 x 2 Mb assemblies against {N_INDEX} "
              f"samples, byte-identical to the host oracle; {walls[q]:.2f} s "
              f"= {8 * N_INDEX / walls[q] / 1e6:.2f} M pairs/s end to end "
              f"(load, sketch, query), {gpu}")
    print(f"phase6 queries: host oracle {max(host_s):.2f} s at most a type")
    profile_dist(cli_main, qargv("any-bins", "profiled"),
                 "phase6 query any-bins")


def slice_database(src: Path, dst: Path, n: int) -> None:
    """dst.skd/.skm: the first n samples of src."""
    from sketchtpu_torch.formats.skm import MultiSketch

    ms = MultiSketch.load_metadata(str(src))
    stride = ms.sample_stride * 8
    with open(f"{src}.skd", "rb") as f:
        Path(f"{dst}.skd").write_bytes(f.read(n * stride))
    MultiSketch(ms.sketch_metadata[:n], ms.sketch_size, ms.kmer_lengths,
                ms.hash_type).save_metadata(str(dst))


def phase6_precluster(cli_main, p5: Path, gpu: str) -> None:
    """`precluster --skd --knn 50` over phase 5's N_KNN samples (single-k)
    and --core-acc over its first N_KNN_CA, with a .ski/.skq derived at
    S = INDEX_SIZE for the same names (clusters of samples of one parent):
    timed and profiled; 8 seeded blocks of 64 rows of each (512 rows)
    against the host oracle, api.self_dists_knn_precluster with a
    row_range."""
    import io

    import numpy as np

    from sketchtpu_torch.dist import api
    from sketchtpu_torch.dist import output as dist_output
    from sketchtpu_torch.formats import skd
    from sketchtpu_torch.formats.skm import MultiSketch
    from sketchtpu_torch.inverted.device import pack_signs, pair_count
    from sketchtpu_torch.inverted.index import Inverted
    from sketchtpu_torch.synth import derive_signs, write_derived_inverted

    d = WORK / "p6pc"
    d.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    names = [f"derived_{i:05d}" for i in range(N_KNN)]
    # cluster i % 800 holds samples of parent i % 8 only
    sig = derive_signs(N_KNN, INDEX_SIZE, 800, SEED + 12)
    write_derived_inverted(str(d / "pc"), names, sig, 17)
    slice_database(p5 / "db", d / "db50k", N_KNN_CA)
    print(f"phase6 derived a {N_KNN}-sample .ski/.skq at S={INDEX_SIZE} and "
          f"the first {N_KNN_CA} samples' .skd in {time.time() - t0:.1f} s "
          f"(set-up)")
    inv = Inverted.load(str(d / "pc"))
    skq = skd.read_all_skq(str(d / "pc.skq"))
    rng = np.random.default_rng(SEED + 14)
    for name, db, n, flags in (("k17", p5 / "db", N_KNN, []),
                               ("coreacc", d / "db50k", N_KNN_CA,
                                ["--core-acc"])):
        m = pack_signs(sig[:n], "cuda")
        with uncounted():
            cand = pair_count(m, INDEX_SIZE)
        del m
        out = d / f"{name}.txt"
        argv = ["inverted", "precluster", str(d / "pc.ski"), "--skd", str(db),
                "--knn", str(KNN), *flags, "-o", str(out), "--quiet"]
        wall = timed_cli(cli_main, argv, f"phase6 precluster {name} n={n}")
        SINGLE_WALL[f"precluster_{name}"] = wall
        pairs = n * (n - 1) // 2
        print(f"phase6 precluster --skd --knn {KNN} {name} n={n}: {wall:.2f} "
              f"s; {cand} candidate pairs of {pairs} "
              f"({100 * cand / pairs:.3f}%); {pairs / wall / 1e9:.3f} G "
              f"scanned pairs/s and {cand / wall / 1e6:.2f} M candidate "
              f"pairs/s end to end (load, upload, masked scan, host f64 "
              f"values, {out.stat().st_size / 1e6:.0f} MB written), {gpu}")
        profile_dist(cli_main, argv, f"phase6 precluster {name} n={n}")
        ms = MultiSketch.load_metadata(str(db))
        ms.read_sketch_data(str(db))
        if name == "coreacc":
            api.set_k(ms, 17, False)
            dist_type = api.DistType()
        else:
            dist_type = api.set_k(ms, 17, False)
        lines = {}
        for ln in out.read_text().splitlines():
            lines.setdefault(ln.split("\t", 1)[0], []).append(ln)
        starts = np.sort(rng.choice(n // 64, CHECK_ROWS // 64,
                                    replace=False)) * 64
        near = 0
        for lo in starts:
            rows = api.self_dists_knn_precluster(
                ms, inv, skq, INDEX_SIZE, KNN, dist_type,
                retain_unmatched=None, row_range=slice(int(lo), int(lo) + 64))
            buf = io.StringIO()
            dist_output.write_sparse(buf, names[lo : lo + 64], names[:n],
                                     rows, coreacc=dist_type.coreacc)
            want = {}
            for ln in buf.getvalue().splitlines():
                want.setdefault(ln.split("\t", 1)[0], []).append(ln)
            for r in range(int(lo), int(lo) + 64):
                got_r, want_r = lines.get(names[r], []), want.get(names[r], [])
                if got_r == want_r:
                    continue
                check(name == "coreacc", f"phase6 precluster {name} row {r} "
                      f"differs from the host oracle")
                near += 1
                check(near_tie_row(got_r, want_r, rows[r - int(lo)]),
                      f"phase6 precluster coreacc row {r} differs beyond an "
                      f"f32 near-tie")
        print(f"phase6 precluster {name}: {CHECK_ROWS} rows (8 blocks of 64) "
              f"equal to the host oracle"
              + (f" except {near} rows of f32 near-ties" if near else ""))


def near_tie_row(got, want, host_row) -> bool:
    """A core/accessory row whose f32 selection differs from the f64
    host's only among neighbours whose f64 core distances lie within 1e-6
    of each other: the values of the pairs both select agree, and every
    swapped neighbour is within 1e-6 of the host's last kept distance."""
    g = {ln.split("\t")[1]: ln for ln in got}
    w = {ln.split("\t")[1]: ln for ln in want}
    if len(got) != len(want):
        return False
    for col in g.keys() & w.keys():
        if g[col] != w[col]:
            return False
    last = max(float(c) for _j, c, _a in host_row)
    swapped = [float(ln.split("\t")[2]) for col, ln in g.items()
               if col not in w]
    return all(abs(c - last) <= 1e-6 for c in swapped)


# --- the amino-acid path: phase 3 against the host oracle, phase 7 at scale --

def aa_sketch_commands(prefix: Path, d: Path):
    """`sketch --seq-type aa` at levels 1-3, with and without
    --concat-fasta, `--seq-type pdb` on 3Di text, a query database and an
    `append` (AA_KMERS, -s SKETCH_SIZE)."""
    p = str(prefix)
    common = ["-k", ",".join(map(str, AA_KMERS)), "-s", str(SKETCH_SIZE),
              "--quiet"]
    cmds = []
    for lv in (1, 2, 3):
        cmds.append(["sketch", "-f", str(d / "rfile.txt"), "-o",
                     f"{p}aa_l{lv}", "--seq-type", "aa", "--level",
                     f"level{lv}", *common])
        cmds.append(["sketch", "-f", str(d / "rfile_cat.txt"), "-o",
                     f"{p}cat_l{lv}", "--seq-type", "aa", "--level",
                     f"level{lv}", "--concat-fasta", *common])
    cmds.append(["sketch", "-f", str(d / "rfile_3di.txt"), "-o", f"{p}pdb",
                 "--seq-type", "pdb", *common])
    cmds.append(["sketch", "-f", str(d / "rfile_q.txt"), "-o", f"{p}q",
                 "--seq-type", "aa", *common])
    return cmds


AA_SKETCHES = ("aa_l1", "aa_l2", "aa_l3", "cat_l1", "cat_l2", "cat_l3",
               "pdb", "q", "appended")
AA_DIST_MODES = {"k9": ["-k", "9"], "coreacc": [],
                 "knn_k9": ["-k", "9", "--knn", "3"]}


def aa_dist_commands(prefix: Path):
    p = str(prefix)
    cmds = [["append", f"{p}aa_l1", "-f", str(WORK / "p3aa" / "rfile_x.txt"),
             "-o", f"{p}appended", "--quiet"]]
    for name, flags in AA_DIST_MODES.items():
        cmds.append(["dist", f"{p}aa_l1", *flags, "-o",
                     f"{p}self_{name}.txt", "--quiet"])
        cmds.append(["dist", f"{p}aa_l1", f"{p}q", *flags, "-o",
                     f"{p}cross_{name}.txt", "--quiet"])
    return cmds


def phase3_aa(cli_main) -> None:
    """The amino-acid path on the CLI against the host oracle: 8 synthetic
    proteomes (lower case, 'X' / '*' residues, 200 wrapped records each)
    and a one-record sample of 12 residues (shorter than k + 1 at k = 12);
    aa_sketch_commands, `append`, then dense -k 9, core/acc and
    `-k 9 --knn 3`, self and ref-vs-query. .skd/.skm, -k 9 and --knn byte
    for byte, f32 core/acc within 1e-5. A --concat-fasta record whose only
    valid window is its final one is refused by both."""
    import numpy as np

    from sketchtpu_torch.synth import related_proteomes

    d = WORK / "p3aa"
    rfile = related_proteomes(d / "faa", 8, 200, 300, SEED + 30,
                              invalid=0.002)
    lines = rfile.read_text().splitlines()
    (d / "short.faa").write_bytes(b">short\nMKVLAAGicdE\nW\n")
    (d / "rfile.txt").write_text("\n".join(lines) + f"\nshort\t{d}/short.faa\n")
    (d / "rfile_cat.txt").write_text("\n".join(lines[:4]) + "\n")
    (d / "rfile_q.txt").write_text("\n".join(lines[5:]) + "\n")
    extra = related_proteomes(d / "faa_x", 2, 150, 300, SEED + 31,
                              gzipped=True)
    (d / "rfile_x.txt").write_text("".join(
        f"extra_{i}\t{ln.split(chr(9))[1]}\n"
        for i, ln in enumerate(extra.read_text().splitlines())))
    rng = np.random.default_rng(SEED + 32)
    letters = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)
    di = []
    for i in range(4):
        path = d / f"struct_{i}.3di"
        path.write_bytes(b"".join(b">chain%d\n%s\n" % (
            c, letters[rng.integers(0, 20, 400)].tobytes()) for c in range(3)))
        di.append(f"struct_{i}\t{path}\n")
    (d / "rfile_3di.txt").write_text("".join(di))
    port_s, host_s = run_port_and_host(
        cli_main,
        aa_sketch_commands(d / "port_", d) + aa_dist_commands(d / "port_"),
        aa_sketch_commands(d / "host_", d), aa_dist_commands(d / "host_"))
    for db in AA_SKETCHES:
        for ext in (".skd", ".skm"):
            check(same_bytes(d / f"port_{db}{ext}", d / f"host_{db}{ext}"),
                  f"aa {db}{ext} differs from the host oracle")
    for side in ("self", "cross"):
        for name in ("k9", "knn_k9"):
            check(same_bytes(d / f"port_{side}_{name}.txt",
                             d / f"host_{side}_{name}.txt"),
                  f"aa dist {side} {name} differs from the host oracle")
        compare_coreacc(f"phase3 aa {side} vs host",
                        d / f"port_{side}_coreacc.txt",
                        d / f"host_{side}_coreacc.txt")
    # the final-window quirk: the only valid 12-mer of the record is its
    # final window, and the residue before it is invalid
    bad = d / "final_only.faa"
    bad.write_bytes(b">ok\nMKVLAAGICDEWQRST\n>final_only\nXMKVLAAGICDEW\n")
    argv = ["sketch", str(bad), "-o", str(d / "bad"), "--seq-type", "aa",
            "--concat-fasta", "-k", "12", "-s", "64", "--quiet"]
    refused = "K-mer larger than smallest valid sequence"
    try:
        cli_main([*argv[:3], str(d / "bad_port"), *argv[4:]])
        check(False, "the port sketched a final-window-only record")
    except ValueError as exc:
        check(refused in str(exc), f"the port raised {exc}")
    proc = subprocess.run([sys.executable, "-m", "sketchtpu.cli", *argv],
                          env=host_env(), capture_output=True, text=True)
    check(proc.returncode != 0 and refused in proc.stderr,
          "the host oracle sketched a final-window-only record")
    print(f"phase3 aa: sketch --seq-type aa levels 1-3 with and without "
          f"--concat-fasta, --seq-type pdb, append: .skd/.skm byte-identical "
          f"({len(AA_SKETCHES)} databases); dist -k 9 and -k 9 --knn 3 self "
          f"and cross byte-identical; a final-window-only record refused by "
          f"both; {len(port_s)} commands: port {sum(port_s):.2f} s, host "
          f"oracle {sum(host_s):.2f} process-s, {HOST_JOBS} at a time")


P7_SAMPLES, P7_RECORDS, P7_RECORD_LEN = 256, 4000, 300
P7_ORACLE_SAMPLES = 8


def phase7_aa(cli_main, gpu: str) -> None:
    """256 synthetic proteomes of about 1.2 M residues (4,000 records of
    300) sketched at level 1, k = 6, 9, 12, -s 1000: wall, Maa-k/s and the
    card's busy share from one profiled run; the first 8 samples' .skd rows
    against the host oracle, byte for byte; then dense core/acc `dist`
    over the 256."""
    from sketchtpu_torch.synth import related_proteomes

    d = WORK / "p7"
    t0 = time.time()
    rfile = related_proteomes(d / "faa", P7_SAMPLES, P7_RECORDS,
                              P7_RECORD_LEN, SEED + 40, n_ancestors=8)
    residues = P7_SAMPLES * P7_RECORDS * P7_RECORD_LEN
    print(f"phase7 wrote {P7_SAMPLES} proteomes ({residues / 1e6:.1f} M "
          f"residues) in {time.time() - t0:.1f} s (set-up)")
    kmers = ",".join(map(str, AA_KMERS))
    argv = ["sketch", "-f", str(rfile), "-o", str(d / "db"), "-k", kmers,
            "-s", str(SKETCH_SIZE), "--seq-type", "aa", "--threads", THREADS,
            "--quiet"]
    wall = timed_cli(cli_main, argv, "phase7 sketch aa", expect=(
        "aahash_bin_multi",))
    SINGLE_WALL["sketch_aa"] = wall
    print(f"phase7 sketch {P7_SAMPLES} proteomes x {len(AA_KMERS)} k: "
          f"{wall:.2f} s = {residues * len(AA_KMERS) / wall / 1e6:.1f} "
          f"Maa-k/s end to end (parse, pack, upload, kernel, densify, "
          f".skd), {gpu}")
    busy = profile_dist(cli_main, argv, "phase7 sketch aa")
    if busy is not None:
        print(f"phase7 sketch aa: the card busy {100 * busy:.2f}% of the "
              f"profiled run")
    lines = rfile.read_text().splitlines()
    (d / "rfile8.txt").write_text("\n".join(lines[:P7_ORACLE_SAMPLES])
                                  + "\n")
    t0 = time.time()
    host_oracle([["sketch", "-f", str(d / "rfile8.txt"), "-o",
                  str(d / "host8"), "-k", kmers, "-s", str(SKETCH_SIZE),
                  "--seq-type", "aa", "--threads", THREADS, "--quiet"]])
    want = (d / "host8.skd").read_bytes()
    got = (d / "db.skd").read_bytes()
    check(len(got) == len(want) * P7_SAMPLES // P7_ORACLE_SAMPLES
          and got[: len(want)] == want,
          "phase7: the first .skd rows differ from the host oracle")
    print(f"phase7: the first {P7_ORACLE_SAMPLES} samples' .skd rows "
          f"byte-identical to the host oracle ({time.time() - t0:.1f} s)")
    out = d / "coreacc.txt"
    wall = timed_cli(cli_main, ["dist", str(d / "db"), "-o", str(out),
                                "--quiet"], "phase7 dist core/acc",
                     expect=("coreacc",))
    pairs = P7_SAMPLES * (P7_SAMPLES - 1) // 2
    check(scan_dist_file(out, 2) == pairs, "phase7 dist: pair count")
    print(f"phase7 dist core/acc over the {P7_SAMPLES}: {pairs} pairs in "
          f"{wall:.2f} s, {gpu}")


# --- phase 9: one process on every device ----------------------------------

# the kernels the multi-device commands must launch
MESH_PATH = ("nthash_bin_multi", "nthash_signs", "aahash_bin_multi",
             "coreacc", "knn_select", "samebits_full", "pair_count",
             "signeq_count", "signeq_any", "signeq_all", "knn_select_masked",
             "sign_prefilter")


@contextlib.contextmanager
def visible_devices(devs):
    """runtime.devices() gives devs inside: the selectors pick the
    multi-device engines, sketching goes round-robin over devs."""
    from sketchtpu_torch import runtime

    saved = runtime.devices
    runtime.devices = lambda: list(devs)
    try:
        yield
    finally:
        runtime.devices = saved


def phase9_commands(d: Path) -> list:
    """(name, argv, one-device outputs, output of this run or None for
    stdout, sketch) of the multi-device runs: earlier phases' commands at
    their full sizes."""
    p3, p4, p5, p6i = WORK / "p3", WORK / "p4", WORK / "p5", WORK / "p6inv"
    kmers = ",".join(map(str, KMERS))
    cmds = [
        ("sketch_dna", ["sketch", "-f", p3 / "fa" / "rfile.txt", "-o",
                        d / "db", "-k", kmers, "-s", SKETCH_SIZE],
         [p3 / f"port_db{e}" for e in (".skd", ".skm")],
         [d / f"db{e}" for e in (".skd", ".skm")], True),
        ("sketch_reads", ["sketch", "-f", WORK / "p6reads" / "reads.txt",
                          "-o", d / "reads", "-k", kmers, "-s", SKETCH_SIZE,
                          "--min-count", "5", "--threads", THREADS],
         [WORK / "p6reads" / f"port7{e}" for e in (".skd", ".skm")],
         [d / f"reads{e}" for e in (".skd", ".skm")], True),
        ("sketch_reads_prefilter", ["sketch", "-f",
                                    WORK / "p6reads" / "reads.txt", "-o",
                                    d / "reads_pf", "-k", kmers, "-s",
                                    SKETCH_SIZE, "--min-count", "5",
                                    "--threads", THREADS],
         [WORK / "p6reads" / f"port7{e}" for e in (".skd", ".skm")],
         [d / f"reads_pf{e}" for e in (".skd", ".skm")], True),
        ("sketch_aa", ["sketch", "-f", WORK / "p7" / "faa" / "rfile.txt",
                       "-o", d / "aa", "-k", ",".join(map(str, AA_KMERS)),
                       "-s", SKETCH_SIZE, "--seq-type", "aa", "--threads",
                       THREADS],
         [WORK / "p7" / f"db{e}" for e in (".skd", ".skm")],
         [d / f"aa{e}" for e in (".skd", ".skm")], True),
        ("dense_coreacc", ["dist", p4 / "db8k", "-o", d / "dense.txt"],
         None, [d / "dense.txt"], False),
        ("k4_k17", ["dist", WORK / "p3k4" / "port_db", "-k", "17", "-o",
                    d / "k4_k17.txt"],
         [WORK / "p3k4" / "port_self_k17.txt"], [d / "k4_k17.txt"], False),
        ("knn_k17", ["dist", p5 / "db", "-k", "17", "--knn", KNN, "-o",
                     d / "knn_k17.txt"], [p5 / "k17.txt"],
         [d / "knn_k17.txt"], False),
        ("knn_coreacc", ["dist", p5 / "db", "--subset", p5 / "first.txt",
                         "--knn", KNN, "-o", d / "knn_coreacc.txt"],
         [p5 / "coreacc.txt"], [d / "knn_coreacc.txt"], False),
        ("count", ["inverted", "precluster", p6i / "idx.ski", "--count"],
         [p6i / "count.txt"], None, False),
        ("precluster_k17", ["inverted", "precluster",
                            WORK / "p6pc" / "pc.ski", "--skd", p5 / "db",
                            "--knn", KNN, "-o", d / "pc_k17.txt"],
         [WORK / "p6pc" / "k17.txt"], [d / "pc_k17.txt"], False),
    ]
    for q in ("match-count", "all-bins", "any-bins"):
        cmds.append((f"query661k_{q}", [
            "inverted", "query", p6i / "idx.ski", "-f",
            p3 / "fa" / "rfile.txt", "--query-type", q, "--threads", THREADS,
            "-o", d / f"query_{q}.txt"], [p6i / f"port_{q}.txt"],
            [d / f"query_{q}.txt"], False))
    return [(name, [str(a) for a in argv] + ["--quiet"], want, got, sketch)
            for name, argv, want, got, sketch in cmds]


def phase9(cli_main, gpu: str) -> None:
    """The in-process multi-device engines (sketchtpu_torch/shard/mesh.py)
    and round-robin sketching, through the CLI with runtime.devices giving
    every GPU, or on a host with one, slots of the card (2 for the
    engines, 3 for the sketches): phases 3-7's commands at their full
    sizes, each output byte-identical to the one-device run's (f32
    core/accessory bit for bit: the same kernel on the same rows), each
    wall printed beside the one-device wall."""
    import torch

    d = WORK / "p9"
    d.mkdir(parents=True, exist_ok=True)
    n_gpus = torch.cuda.device_count()
    if n_gpus > 1:
        engines = sketches = [torch.device("cuda", i) for i in range(n_gpus)]
        kind = f"{n_gpus} distinct GPUs"
    else:
        engines = [torch.device("cuda", 0)] * 2
        sketches = [torch.device("cuda", 0)] * 3
        kind = ("slots of one card (2 for the engines, 3 for the "
                "sketches): the split, order and joins, not distinct GPUs")
    print(f"phase9 devices: {kind}; {gpu}")
    for name, argv, want, got, sketch in phase9_commands(d):
        knob = prefilter_knob if name.endswith("_prefilter") else \
            contextlib.nullcontext
        with visible_devices(sketches if sketch else engines), knob():
            out = d / f"{name}.out" if got is None else None
            wall = timed_cli(cli_main, argv, f"phase9 {name}", stdout=out)
        got = got or [out]
        if want is None:  # phase 4 kept only its output's digest
            same = sha256_of(got) == SINGLE_SHA256[name]
        else:
            same = all(same_bytes(g, w) for g, w in zip(got, want))
        check(same, f"phase9 {name}: output differs from the one-device run")
        single = SINGLE_WALL.get(name)
        print(f"phase9 {name}: {wall:.2f} s on "
              f"{len(sketches if sketch else engines)} devices, one device "
              + (f"{single:.2f} s" if single is not None else "not timed")
              + f"; byte-identical; {gpu}")
        if name == "dense_coreacc":
            got[0].unlink()
    print(f"phase9: every multi-device output byte-identical to the "
          f"one-device run ({kind})")


# --- phase 10: the words axis (library surface) -------------------------------

# 1 x 16: past the finish's MAX_WORDS_SLOTS, each lead folds its partials
WORDS_GRIDS = ((1, 2), (2, 2), (1, 4), (1, 16))
N_WORDS_STREAM = 1024  # samples of the 2 x 2 stream_self_dense check


def words_ms(words, kmers=KMERS):
    """A MultiSketch of (n, nk, W) int64 words (a tensor), held on the
    host as a loaded .skd is."""
    import numpy as np

    from sketchtpu_torch.formats.skm import MultiSketch
    from sketchtpu_torch.sketchcore.sketch import HashType, Sketch

    n, s64 = words.shape[0], words.shape[2] // 14
    ms = MultiSketch([Sketch(name=f"w{i}", index=i) for i in range(n)],
                     s64 * 64, list(kmers), HashType("dna"))
    ms.sketch_bins = words.cpu().numpy().view(np.uint64).reshape(-1)
    return ms


def show_timeline(label: str, spans: list[dict]) -> None:
    """One line a slot of a words step (mesh.timeline): each span's start
    and end, ms from the step's start on one time axis for every GPU."""
    by_slot: dict = {}
    for sp in spans:
        by_slot.setdefault((sp["device"], sp["slot"]), []).append(sp)
    for (dev, slot), sps in sorted(by_slot.items()):
        print(f"phase10 timeline {label} {dev} {slot}: " + ", ".join(
            f"{sp['what']} {sp['start_ms']:.2f}-{sp['end_ms']:.2f}"
            for sp in sorted(sps, key=lambda sp: sp["start_ms"])))


def lead_runs_first(label: str, spans: list[dict]) -> None:
    """Print the step's timeline, and fail unless each lead's stream holds
    only its own work, its own partial first, and its finish begins after
    every partial of its row block has ended."""
    show_timeline(label, spans)
    partials = [sp for sp in spans if sp["what"] == "partial"]
    for lead in (sp for sp in partials if sp["slot"].endswith("w0")):
        on_it = [sp for sp in spans if sp["stream"] == lead["stream"]
                 and sp["device"] == lead["device"]]
        check(on_it[0] is lead and {sp["slot"] for sp in on_it}
              == {lead["slot"]}, f"phase10 {label}: {lead['slot']}'s stream "
              f"runs {[(sp['slot'], sp['what']) for sp in on_it]}")
        block = lead["slot"][:-1]  # "r<i>w"
        finish = next(sp for sp in on_it if sp["what"] == "finish")
        # one device's times compare exactly; two GPUs' to within the
        # microseconds between their origins (a transfer takes longer)
        check(all(finish["start_ms"] >= sp["end_ms"] - (
            0 if sp["device"] == lead["device"] else 0.5) for sp in partials
                  if sp["slot"].startswith(block)),
              f"phase10 {label}: {lead['slot']} finished before a partial")


def phase10_slots(device: str, count: int = 8):
    """`count` device slots: on one card all of it; with several GPUs slot
    i on GPU i % count (4 distinct GPUs make the 1 x 4 and 2 x 2 grids'
    slots distinct)."""
    import torch

    if device != "cuda":
        return [torch.device(device)] * count, "CPU slots"
    n = torch.cuda.device_count()
    slots = [torch.device("cuda", i % n) for i in range(count)]
    return slots, (f"{n} distinct GPUs (slot i on GPU i % {n})" if n > 1
                   else "slots of one card: the split, sums and joins, "
                   "not distinct GPUs")


def phase10(gpu: str, n: int = N_WORDS, s64: int = S64_WORDS,
            device: str = "cuda") -> None:
    """The words axis of shard/mesh.py at the width it exists for: 4096
    samples at s = 102,400 bins (s64 = 1600) and 7 k, 5.1 GB of words made
    on the card. Grids 1 x 2, 2 x 2, 1 x 4 and 1 x 16 (phase10_slots; past
    MAX_WORDS_SLOTS the leads fold their partials) run
    ShardedSamebitsEngine.matrix, sharded_dist_step (Jaccard and ANI) and
    sharded_coreacc_step (plain and completeness), each bit-equal to the
    unsplit K4, jaccard_dist_block or K2 (run uncounted); then
    ShardedCoreAccEngine.stream_self_dense on 2 x 2 over the first 1024
    samples, byte-identical to the one-device engine; then
    dryrun_multichip's sequence on a 4 x 2 grid (phase10_dryrun).
    device="cpu" rehearses it at a small n and s64 on the twins."""
    import io

    import numpy as np
    import torch

    from sketchtpu_torch.dist.coreacc_kernels import coreacc
    from sketchtpu_torch.dist.coreacc_torch import DeviceCoreAccEngine
    from sketchtpu_torch.dist.jaccard_torch import jaccard_dist_block
    from sketchtpu_torch.dist.samebits_kernels import samebits_full
    from sketchtpu_torch.shard import mesh

    slots, kind = phase10_slots(device)
    first = slots[0]

    def sync():
        if device == "cuda":
            for i in range(torch.cuda.device_count()):
                torch.cuda.synchronize(i)

    def timed(fn):
        sync()
        t0 = time.time()
        out = fn()
        sync()
        return out, time.time() - t0

    t0 = time.time()
    w = device_words(n, s64, SEED + 10, device=first)
    comp = torch.linspace(0.6, 1.0, n, device=first)
    comp = comp[torch.randperm(n, device=first)]
    plane = w[:, 0]
    host = plane.cpu().numpy().view(np.uint64)
    sync()
    print(f"phase10 made {n} x {len(KMERS)} k x {s64} chunks "
          f"({w.numel() * 8 / 1e9:.2f} GB) in {time.time() - t0:.1f} s; "
          f"{kind}; {gpu}")
    # the unsplit jaccard_dist_block is the axis's library entry point too
    # (samebits_dist's launches on this path); K4 and K2 are references
    want_d = {ani: timed(lambda: jaccard_dist_block(
        plane, plane, s64, k=17.0, ani=ani)) for ani in (False, True)}
    with uncounted():
        (want_sb, t_sb) = timed(lambda: samebits_full(plane, plane))
        want_ca = {}
        for label, c in (("plain", None), ("completeness", comp)):
            ca, wall = timed(lambda: coreacc(w, w, KMERS, s64 * 64, c, c))
            want_ca[label] = (torch.stack(ca, dim=-1), wall)
        want_host = want_sb.cpu().numpy()
    print(f"phase10 unsplit ({n}, {n}): K4 {t_sb:.3f} s, "
          f"jaccard_dist_block {want_d[False][1]:.3f} / ANI "
          f"{want_d[True][1]:.3f} s, K2 {want_ca['plain'][1]:.3f} / "
          f"completeness {want_ca['completeness'][1]:.3f} s")
    for rows, words in WORDS_GRIDS:
        grid = mesh.make_mesh(rows, words, devices=phase10_slots(
            device, max(len(slots), rows * words))[0])
        walls = {}
        got, walls["matrix"] = timed(lambda: mesh.ShardedSamebitsEngine(
            s64, grid).matrix(host, host))
        check(np.array_equal(got, want_host),
              f"phase10 {rows}x{words} matrix != K4")
        for ani in (False, True):
            with mesh.timeline() as tl:
                got, walls[f"dist ani={ani}"] = timed(
                    lambda: mesh.sharded_dist_step(plane, plane, s64, grid,
                                                   17.0, ani))
            if not ani:
                lead_runs_first(f"{rows} x {words} dist", tl.read())
            check(torch.equal(got.to(first), want_d[ani][0]),
                  f"phase10 {rows}x{words} dist ani={ani} != "
                  f"jaccard_dist_block")
        for label, c in (("plain", None), ("completeness", comp)):
            with mesh.timeline() as tl:
                got, walls[f"coreacc {label}"] = timed(
                    lambda: mesh.sharded_coreacc_step(w, w, s64, grid, KMERS,
                                                      s64 * 64, c1=c, c2=c))
            if c is None:
                lead_runs_first(f"{rows} x {words} coreacc", tl.read())
            check(torch.equal(got.to(first), want_ca[label][0]),
                  f"phase10 {rows}x{words} coreacc {label} != K2")
        del got
        print(f"phase10 grid {rows} x {words}: matrix, dist (Jaccard, ANI) "
              f"and coreacc (plain, completeness) bit-equal to the unsplit "
              f"kernels; walls "
              + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items()))
    del want_sb, want_d, want_ca, host

    sub = words_ms(w[:N_WORDS_STREAM])
    names = [f"w{i}" for i in range(sub.number_samples_loaded())]
    texts = {}
    for label in ("one device", "2 x 2"):
        with contextlib.ExitStack() as stack:
            if label == "one device":
                stack.enter_context(uncounted())
                eng = DeviceCoreAccEngine(sub, first, tile=512)
            else:
                eng = mesh.ShardedCoreAccEngine(
                    sub, mesh.make_mesh(2, 2, devices=slots), tile=512)
            out = io.StringIO()
            _, wall = timed(lambda: eng.stream_self_dense(out, names))
            texts[label] = out.getvalue()
        print(f"phase10 stream_self_dense {label} ({len(names)} samples, "
              f"{texts[label].count(chr(10))} lines): {wall:.2f} s")
    check(texts["2 x 2"] and texts["2 x 2"] == texts["one device"],
          "phase10 2 x 2 stream_self_dense != the one-device engine")
    del w, sub, texts
    if device == "cuda":
        torch.cuda.empty_cache()
    phase10_dryrun(slots)


def phase10_dryrun(slots) -> None:
    """__graft_entry__.dryrun_multichip's sequence on a 4 x 2 grid of the
    slots: the distance step (row-sharded, words-sharded with the sum)
    against the host chain within 1e-6, the core/acc step with and without
    completeness bit-equal to K2 unsplit, the kNN step and its masked form
    on the 8 rows-only slots against the host top-k, and the inverted
    engine's count and match counts against the host."""
    import numpy as np
    import torch

    from sketchtpu_torch.dist.coreacc_kernels import coreacc
    from sketchtpu_torch.dist.jaccard_np import samebits_matrix
    from sketchtpu_torch.shard import mesh

    n_words, n_rows = 2, 4
    grid = mesh.make_mesh(n_rows, n_words, devices=slots)
    s64, na, nb = 16 * n_words, 8 * n_rows, 16
    w2 = s64 * 14 * 2
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**32, (na, w2), dtype=np.uint32).view(np.uint64)
    b = rng.integers(0, 2**32, (nb, w2), dtype=np.uint32).view(np.uint64)
    out = mesh.sharded_dist_step(a, b, s64, grid, 21.0, False).cpu().numpy()
    check(out.shape == (na, nb) and np.all((out >= 0) & (out <= 1)),
          "phase10 dryrun: distances out of range")
    sb = samebits_matrix(a, b).astype(np.float64)
    maxnbits, expected = float(s64 * 64), float(int(s64 * 64) >> 14)
    j = (np.maximum(sb - expected, 0.0) * maxnbits
         / (maxnbits - expected)) / maxnbits
    check(np.allclose(out, (1.0 - j).astype(np.float32), atol=1e-6, rtol=0),
          "phase10 dryrun: the distance step != the host chain")
    kmers = (17, 21, 25)
    stack = rng.integers(0, 2**32, (len(kmers), na, w2), dtype=np.uint32)
    x = np.ascontiguousarray(stack.transpose(1, 0, 2)).view(np.uint64)
    xt = torch.from_numpy(x.view(np.int64)).to(slots[0])
    comp = rng.uniform(0.7, 1.0, na).astype(np.float32)
    for c in (None, comp):
        got = mesh.sharded_coreacc_step(x, x, s64, grid, kmers, s64 * 64,
                                        c1=c, c2=c)
        ct = torch.from_numpy(c).to(slots[0]) if c is not None else None
        with uncounted():
            want = torch.stack(coreacc(xt, xt, kmers, s64 * 64, ct, ct), -1)
        check(torch.equal(got.to(slots[0]), want),
              "phase10 dryrun: the core/acc step != K2")
    knn_grid = mesh.make_mesh(len(slots), 1, devices=slots)
    knn = 4
    sb_self = samebits_matrix(a, a).astype(np.int64)
    np.fill_diagonal(sb_self, -(2**31))
    sigs = rng.integers(0, 3, (na, 5)).astype(np.uint16)
    shared = (sigs[:, None, :] == sigs[None, :, :]).any(axis=2)
    for label, kw, want in (
            ("plain", {}, sb_self),
            ("masked", dict(a_sig=sigs, b_sig=sigs),
             np.where(shared, sb_self, -(2**31)))):
        v, _ = mesh.sharded_knn_step(a, a, s64, knn_grid, knn, n_real=na,
                                     exclude_self=True, col_tile=na, **kw)
        v = v.cpu().numpy().astype(np.int64)
        v[v == -0x7FFFFFFF] = -(2**31)
        for r in range(na):
            check(np.array_equal(np.sort(v[r])[::-1],
                                 np.sort(want[r])[::-1][:knn]),
                  f"phase10 dryrun: the {label} kNN step, row {r}")
    n_inv = 4 * knn_grid.shape["rows"] + 3
    sign_mat = rng.integers(0, 7, (n_inv, 5), dtype=np.uint16)
    inv = mesh.ShardedInvertedEngine(sign_mat, knn_grid)
    shared_inv = (sign_mat[:, None, :] == sign_mat[None, :, :]).any(axis=2)
    check(inv.any_shared_bin_count() == int(np.triu(shared_inv, 1).sum()),
          "phase10 dryrun: the inverted count")
    q = sign_mat[:3]
    check(np.array_equal(inv.match_counts(q),
                         (q[:, None, :] == sign_mat[None, :, :]).sum(axis=2)),
          "phase10 dryrun: the inverted match counts")
    print(f"phase10 dryrun_multichip's sequence on a {n_rows} x {n_words} "
          f"grid (s64 {s64}, {na} x {nb}): the distance step within 1e-6 of "
          f"the host chain, the core/acc step (plain, completeness) equal "
          f"to K2, the kNN step (plain, masked) on {len(slots)} rows-only "
          f"slots equal to the host top-k, the inverted count and match "
          f"counts equal to the host's")


# --- phase 8: two ranks on the one card ------------------------------------

P8_RANKS = 2
P8_DEADLINE_S = 480  # both ranks' runs, start-up included


def phase8_commands(d: Path) -> list:
    """(name, argv, kernels every rank must launch) of the rank runs, each
    the argv of an earlier phase's single-process run with the output in
    `d` (stdout, where a command prints its result, goes to
    d/<name>.rank<r>.out)."""
    p3inv, p4, p5 = WORK / "p3inv", WORK / "p4", WORK / "p5"
    mixed = WORK / "p3reads" / "mixed.txt"
    cmds = [
        ("knn_k17", ["dist", p5 / "db", "-k", "17", "--knn", KNN, "-o",
                     d / "knn_k17.txt"], ("knn_select",)),
        ("knn_coreacc", ["dist", p5 / "db", "--subset", p5 / "first.txt",
                         "--knn", KNN, "-o", d / "knn_coreacc.txt"],
         ("coreacc",)),
        ("dense_coreacc", ["dist", p4 / "db8k", "-o",
                           d / "dense_coreacc.txt"], ("coreacc",)),
        ("dense_k17", ["dist", p4 / "db8k", "-k", "17", "-o",
                       d / "dense_k17.txt"], ("samebits",)),
        ("count", ["inverted", "precluster", WORK / "p6inv" / "idx.ski",
                   "--count"], ("pair_count",)),
        ("precluster_k17", ["inverted", "precluster",
                            WORK / "p6pc" / "pc.ski", "--skd", p5 / "db",
                            "--knn", KNN, "-o", d / "pc_k17.txt"],
         ("knn_select_masked",)),
        ("sketch_aa", ["sketch", "-f", WORK / "p7" / "faa" / "rfile.txt",
                       "-o", d / "aa", "-k", ",".join(map(str, AA_KMERS)),
                       "-s", SKETCH_SIZE, "--seq-type", "aa", "--threads",
                       THREADS], ("aahash_bin_multi",)),
        ("sketch_reads_prefilter", [
            "sketch", "-f", WORK / "p6reads" / "reads.txt", "-o",
            d / "reads_pf", "-k", ",".join(map(str, KMERS)), "-s",
            SKETCH_SIZE, "--min-count", "5", "--threads", THREADS],
         ("nthash_signs", "sign_prefilter")),
        ("inv", ["inverted", "build", "-f", mixed, "-o", d / "inv", "-s",
                 "100", "-k", "17", "--write-skq", "--threads", THREADS],
         ("nthash_bin_multi",)),
        ("inv_sp", ["inverted", "build", "-f", mixed, "-o", d / "inv_sp",
                    "-k", "17", "--write-skq", "--species-names",
                    p3inv / "species.txt", "--metadata", p3inv / "meta.txt",
                    "--threads", THREADS], ("nthash_bin_multi",)),
    ]
    for q, mode in (("match-count", "count"), ("all-bins", "all"),
                    ("any-bins", "any")):
        cmds.append((f"query_{q}", [
            "inverted", "query", p3inv / "port_inv_sp.ski", "-f", mixed,
            "--query-type", q, "--threads", THREADS, "-o",
            d / f"query_{q}.txt"], ("nthash_bin_multi", f"signeq_{mode}")))
    return [(name, [str(a) for a in argv] + ["--quiet"], expect)
            for name, argv, expect in cmds]


def phase8_rank(rank: int, port: int, d: Path, commands, queue) -> None:
    """One rank of phase 8, in a process of its own (spawned, with the
    parent's environment): torchrun's variables for a local process group,
    then each command through the port's cli.main with the launch counts
    from 0; its stdout and compute window go to `d`. Puts (rank, None,
    [(name, wall s, compute window s, launches)], start-up s), or (rank,
    the traceback, None, None)."""
    import traceback

    t0 = time.time()
    try:
        os.environ.update(WORLD_SIZE=str(P8_RANKS), RANK=str(rank),
                          LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=str(port))
        from sketchtpu_torch.cli import main as cli_main

        wrappers = kernel_wrappers()
        for fn in wrappers.values():
            fn.launches = 0
        ready, runs = time.time() - t0, []
        for name, argv, _ in commands:
            window = d / f"{name}.rank{rank}.window.json"
            os.environ["SKETCHTPU_COMPUTE_WINDOW_FILE"] = str(window)
            before = {k: fn.launches for k, fn in wrappers.items()}
            knob = prefilter_knob if name.endswith("_prefilter") else \
                contextlib.nullcontext
            with open(d / f"{name}.rank{rank}.out", "w") as f, \
                    contextlib.redirect_stdout(f), knob():
                t = time.time()
                check(cli_main(argv) == 0, f"rank {rank}: {name} failed")
                wall = time.time() - t
            runs.append((name, wall,
                         json.loads(window.read_text())["compute_s"],
                         {k: fn.launches - before[k]
                          for k, fn in wrappers.items()}))
        queue.put((rank, None, runs, ready))
    except BaseException:
        queue.put((rank, traceback.format_exc(), None, None))


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(d: Path, commands) -> dict:
    """Start P8_RANKS spawned ranks on the card and wait for their results
    ({rank: (runs, start-up s)}); a rank that fails or dies fails the
    phase, and every rank is stopped before this returns."""
    import multiprocessing
    import queue as queue_mod

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=phase8_rank,
                         args=(r, port, d, commands, results))
             for r in range(P8_RANKS)]
    for p in procs:
        p.start()
    got, deadline = {}, time.time() + P8_DEADLINE_S
    try:
        while len(got) < P8_RANKS:
            check(time.time() < deadline,
                  f"phase8: ranks {sorted(set(range(P8_RANKS)) - set(got))} "
                  f"past {P8_DEADLINE_S} s")
            try:
                rank, error, runs, ready = results.get(timeout=5)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                check(not dead, f"phase8: rank(s) {dead} died "
                      f"({[procs[r].exitcode for r in dead]})")
                continue
            check(error is None, f"phase8 rank {rank} failed:\n{error}")
            got[rank] = (runs, ready)
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return got


def phase8(cli_main, gpu: str) -> dict:
    """Two ranks on the one card, under torchrun's environment (a gloo
    process group), run the commands of phases 4-7 and 3's index (
    phase8_commands); the parts (or rank 0's merge, or its printed total)
    must equal the single-process output byte for byte, and each rank must
    have launched its path's kernels. Then `dist -k 17 --knn 3` on 3
    samples as 5 ranks by --process-id/--n-processes in this process:
    the surplus ranks write empty parts and launch nothing. Returns the
    launches of every rank summed."""
    d = WORK / "p8"
    d.mkdir(parents=True, exist_ok=True)
    commands = phase8_commands(d)
    t0 = time.time()
    got = run_ranks(d, commands)
    wall = time.time() - t0
    totals = {k: 0 for k in kernel_wrappers()}
    for rank, (runs, ready) in sorted(got.items()):
        print(f"phase8 rank {rank}: ready in {ready:.1f} s (spawn, imports)")
        for (name, _, expect), (_, _, _, made) in zip(commands, runs):
            print(f"phase8 {name} rank {rank}: launches "
                  f"{ {k: v for k, v in made.items() if v} }")
            for k in expect:
                check(made[k] > 0, f"phase8 {name}: rank {rank} did not "
                      f"launch {k}")
            for k, v in made.items():
                totals[k] += v
    for i, (name, _, _) in enumerate(commands):
        ranks = ", ".join(
            f"rank {r} {got[r][0][i][1]:.2f} s (compute window "
            f"{got[r][0][i][2]:.2f} s)" for r in sorted(got))
        single = SINGLE_WALL.get(name)
        print(f"phase8 {name}: {ranks}; one process "
              + (f"{single:.2f} s" if single is not None else "not timed")
              + f", {gpu}")
    print(f"phase8: {P8_RANKS} ranks ran {len(commands)} commands in "
          f"{wall:.1f} s of wall, {gpu}")
    phase8_compare(d)
    totals_surplus = phase8_surplus(cli_main, d)
    return {k: totals[k] + totals_surplus[k] for k in totals}


def phase8_compare(d: Path) -> None:
    """Each rank run's output against the single-process one."""
    parts = lambda name: [Path(f"{d / name}.part{r}")  # noqa: E731
                          for r in range(P8_RANKS)]
    for name, single in (("knn_k17.txt", WORK / "p5" / "k17.txt"),
                         ("knn_coreacc.txt", WORK / "p5" / "coreacc.txt"),
                         ("pc_k17.txt", WORK / "p6pc" / "k17.txt")):
        check(single.stat().st_size > 0
              and sha256_of(parts(name)) == sha256_of([single]),
              f"phase8 {name}: the parts differ from {single.name}")
    for name in ("dense_coreacc", "dense_k17"):
        check(sha256_of(parts(f"{name}.txt")) == SINGLE_SHA256[name],
              f"phase8 {name}: the parts differ from phase 4's output")
        for p in parts(f"{name}.txt"):
            p.unlink()
    for q in ("match-count", "all-bins", "any-bins"):
        check(sha256_of(parts(f"query_{q}.txt"))
              == sha256_of([WORK / "p3inv" / f"port_query_{q}.txt"]),
              f"phase8 query {q}: the parts differ from phase 3's")
    merged = [(d / f"{who}{e}", WORK / src / f"{single}{e}")
              for who, src, single in (("aa", "p7", "db"),
                                       ("reads_pf", "p6reads", "port7"))
              for e in (".skd", ".skm")]
    for who in ("inv", "inv_sp"):
        merged += [(d / f"{who}{e}", WORK / "p3inv" / f"port_{who}{e}")
                   for e in (".ski", ".skq")]
    for got, want in merged:
        check(same_bytes(got, want), f"phase8 {got.name}: rank 0's merge "
              f"differs from {want.name}")
        check(not Path(f"{d / got.stem}.part0{got.suffix}").exists(),
              f"phase8 {got.name}: shards left behind")
    count = (WORK / "p6inv" / "count.txt").read_text()
    check((d / "count.rank0.out").read_text() == count and count,
          "phase8 precluster --count: rank 0's total differs from phase 6's")
    check((d / "count.rank1.out").read_text() == "",
          "phase8 precluster --count: rank 1 printed")
    print(f"phase8: every rank-split output byte-identical to the "
          f"single-process run (dist --knn 50 -k 17 at {N_KNN} and "
          f"core/acc at {N_KNN_CA}, dense core/acc and -k 17 at {N_SCALE}, "
          f"precluster --skd --knn 50 at {N_KNN}, queries: the parts in "
          f"rank order; sketch --seq-type aa of {P7_SAMPLES} proteomes, "
          f"sketch of phase 6's reads with the prefilter on and both "
          f"inverted builds: rank 0's merge; precluster --count at "
          f"{N_INDEX}: rank 0's total, {count.strip()!r})")


def phase8_surplus(cli_main, d: Path) -> dict:
    """`dist -k 17 --knn 3` on the first 3 samples of phase 3's database
    as 5 ranks by the flags (rank 0 last), here: the parts equal the
    single run, ranks without rows write empty parts and launch nothing.
    Returns the ranks' launches."""
    slice_database(WORK / "p3" / "port_db", d / "tiny", 3)
    argv = ["dist", str(d / "tiny"), "-k", "17", "--knn", "3", "--quiet"]
    check(cli_main(argv + ["-o", str(d / "tiny.txt")]) == 0,
          "phase8 tiny single failed")
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    made = {}
    for rank in (1, 2, 3, 4, 0):
        before = {k: fn.launches for k, fn in wrappers.items()}
        check(cli_main(argv + ["-o", str(d / "tiny5.txt"), "--n-processes",
                               "5", "--process-id", str(rank)]) == 0,
              f"phase8 tiny rank {rank} failed")
        made[rank] = sum(fn.launches - before[k]
                         for k, fn in wrappers.items())
    parts = [Path(f"{d / 'tiny5.txt'}.part{r}").read_bytes()
             for r in range(5)]
    check(b"".join(parts) == (d / "tiny.txt").read_bytes() and parts[0],
          "phase8 tiny: 5 ranks' parts differ from the single run")
    check(parts[3] == parts[4] == b"" and made[3] == made[4] == 0
          and all(made[r] > 0 for r in range(3)),
          f"phase8 tiny: surplus ranks wrote or launched ({made})")
    print(f"phase8 dist -k 17 --knn 3 on 3 samples as 5 ranks: parts equal "
          f"the single run; ranks 3 and 4 wrote empty parts and launched "
          f"nothing; launches by rank {made}")
    return {k: fn.launches for k, fn in wrappers.items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from sketchtpu_torch import _build, _native
    from sketchtpu_torch.cli import main as cli_main

    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).strip().splitlines()[0]
    nvcc = run([_build.nvcc_path(), "--version"]).strip().splitlines()[-1]
    print(smi)
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}); {nvcc}; "
          f"compute capability {torch.cuda.get_device_capability(0)}; "
          f"python {sys.version.split()[0]}")
    os.environ["SKETCHTPU_TORCH_BACKEND"] = "cuda"
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir()
    try:
        t0 = time.time()
        lib_path = _build.build()
        print(f"phase1 built {lib_path.name} in {time.time() - t0:.1f} s")
        for ln in lib_path.with_suffix(".log").read_text().splitlines():
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
                print("  ptxas:", ln.replace("ptxas info    :", "").strip())
        t0 = time.time()
        _native.lib()
        print(f"phase1 built the host helper (csrc/host/native.cpp) in "
              f"{time.time() - t0:.1f} s")

        results: dict[str, dict] = {}
        t0 = time.time()
        words = derived_words(16384, SEED)
        big = derived_words(N_KNN, SEED + 2, kmers=(17,))[:, 0]
        phase2_samebits(words, big, results, lib_path)
        phase2_coreacc(words, results, lib_path)
        phase2_words(results, lib_path)
        phase2_knn_keys(words, results)
        phase2_knn_select(words, big, results, lib_path)
        del big
        phase2_knn_masked(words, results, lib_path)
        phase2_coreacc_masked(words, results)
        del words
        phase2_nthash(results)
        dpx_rate = phase2_compare(lib_path)
        phase2_nthash_signs(results)
        phase2_sign_prefilter(results)
        phase2_signeq(results, lib_path, dpx_rate)
        phase2_aahash(results, lib_path)
        torch.cuda.empty_cache()
        print(f"phase2: {time.time() - t0:.1f} s")

        wrappers = kernel_wrappers()

        def counted(path, kernels, *phases):
            """Run a path's phases with every count at 0 before; its
            launches just after, each of `kernels` at least once."""
            for fn in wrappers.values():
                fn.launches = 0
            out = [phase() for phase in phases]
            got = {name: fn.launches for name, fn in wrappers.items()}
            print(f"{path} path launches: {got}")
            for name in kernels:
                check(got[name] > 0, f"kernel {name} never launched on the "
                      f"{path} path")
            return got, out

        t0 = time.time()
        aa, _ = counted("aa", AA_PATH, lambda: phase3_aa(cli_main),
                        lambda: phase7_aa(cli_main, smi))
        print(f"aa path phases 3, 7: {time.time() - t0:.1f} s")
        t0 = time.time()
        dense, (p3, _, _, _) = counted(
            "dense", DENSE_PATH, lambda: phase3_dense(cli_main),
            lambda: phase3_k4(cli_main, WORK / "p3"),
            lambda: phase3_many_k(cli_main),
            lambda: phase4(cli_main, WORK / "p3" / "port_db", smi))
        print(f"dense path phases 3 (with the 40,000-bin K4 runs and "
              f"300 k) and 4: "
              f"{time.time() - t0:.1f} s")
        t0 = time.time()
        knn, (_, _, p5) = counted(
            "kNN", KNN_PATH, lambda: phase3_knn(cli_main, p3),
            lambda: phase3_knn1025(cli_main, p3),
            lambda: phase5_run(cli_main, p3 / "port_db", smi))
        print(f"kNN path phases 3, 5: {time.time() - t0:.1f} s")
        t0 = time.time()
        phase5_check(p5)
        print(f"phase5 check: {time.time() - t0:.1f} s")
        t0 = time.time()
        inverted, _ = counted(
            "reads + inverted", INVERTED_PATH,
            lambda: phase3_inverted(cli_main, phase3_reads(cli_main, p3)),
            lambda: phase6_reads(cli_main, smi),
            lambda: phase6_index(cli_main, p3, smi),
            lambda: phase6_precluster(cli_main, p5, smi))
        print(f"reads + inverted path phases 3, 6: {time.time() - t0:.1f} s")
        t0 = time.time()
        torch.cuda.empty_cache()
        mesh, _ = counted("multi-device", MESH_PATH,
                          lambda: phase9(cli_main, smi))
        print(f"multi-device path phase 9: {time.time() - t0:.1f} s")
        t0 = time.time()
        torch.cuda.empty_cache()
        words_axis, _ = counted("words", WORDS_PATH, lambda: phase10(smi))
        print(f"words path phase 10: {time.time() - t0:.1f} s")
        t0 = time.time()
        torch.cuda.empty_cache()
        ranks = phase8(cli_main, smi)
        print(f"ranks path phase 8: {time.time() - t0:.1f} s")
        loaded = [m for m in sys.modules
                  if m.split(".")[0] in ("sketchtpu", "jax")]
        check(not loaded, f"the port's phases loaded {loaded[:5]}")
        launches = {name: dense[name] + knn[name] + inverted[name] + aa[name]
                    + mesh[name] + words_axis[name] + ranks[name]
                    for name in wrappers}
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    record = []
    for name, (source, replaces) in SOURCES.items():
        r = results[name]
        record.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
