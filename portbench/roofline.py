"""The least time the card could take over a job's kernel work, counted
from the job's shapes (never from how the port tiles it).

Peaks of one NVIDIA H100 SXM at its 700 W limit:
- 3.35 TB/s of HBM (NVIDIA's data sheet);
- Hopper's integer throughputs (CUDA C++ Programming Guide, arithmetic
  instruction throughput, compute capability 9.0): 64 32-bit bitwise
  operations and 16 popcounts a clock and SM, 132 SMs at the 1.98 GHz
  boost clock. These kernels do integer logic and popcounts; the 67 T/s
  FP32 rate counts an FMA as two operations and is no bound for them;
- the DPX compare VIADDMNMX.U16x2 (one word of two u16 signs) at 64 a
  clock and SM, the integer pipe's rate (chip_smoke.py's compare
  microbenchmark reads 62.73 on an H100 80GB HBM3 at 700 W).
Work per pair (chip_smoke.py's integer_floor_ms and pair_count floor):
- samebits at one k: per 64-bin chunk, two u32 words x BBITS LOP3 (one
  folds a plane's XOR and AND) and two popcounts, the pipes overlapped;
- pair_count: one DPX compare per word of two signs.
Pairs are the n(n - 1) / 2 that the inputs need: samebits and sign
equality are symmetric. Bytes: each input read once, each output written
once."""

from __future__ import annotations

PEAK_BYTES = 3.35e12
SMS, CLOCK_HZ = 132, 1.98e9
LOP3_PER_CLOCK, POPC_PER_CLOCK, DPX_PER_CLOCK = 64, 16, 64
BBITS = 14


def self_pairs(n: int) -> int:
    return n * (n - 1) // 2


def at_rate_s(count: float, per_clock_and_sm: int) -> float:
    """Seconds for `count` instructions at a per-clock, per-SM rate."""
    return count / (per_clock_and_sm * SMS * CLOCK_HZ)


def samebits_least_s(n: int, nk: int, s64: int, knn: int) -> float:
    """A self kNN scan of n samples at nk k: the samebits of every pair at
    every k; reads the words, writes knn (key, column) a row."""
    chunks = self_pairs(n) * nk * s64
    ops_s = max(at_rate_s(chunks * 2 * BBITS, LOP3_PER_CLOCK),
                at_rate_s(chunks * 2, POPC_PER_CLOCK))
    return max(ops_s, (n * nk * s64 * BBITS * 8 + n * knn * 8) / PEAK_BYTES)


def pair_count_least_s(n: int, signs: int) -> float:
    """`precluster --count` over n samples of `signs` u16 signs."""
    ops_s = at_rate_s(self_pairs(n) * -(-signs // 2), DPX_PER_CLOCK)
    return max(ops_s, (n * signs * 2 + 8) / PEAK_BYTES)


def roofline_pct(least_per_job_s: float, jobs: int, measured_s: float):
    """100 x the least time of the jobs over the measured time, or None
    where nothing was measured."""
    if measured_s <= 0 or jobs <= 0:
        return None
    return 100.0 * least_per_job_s * jobs / measured_s
