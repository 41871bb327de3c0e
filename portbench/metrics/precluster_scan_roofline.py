"""The masked precluster scan against the least time of its candidates'
work, per job: the samebits of every candidate pair (the pairs that share
a sign, counted by the reference into the cell's shapes) at every k, at
roofline.samebits_least_s' rate a pair, or, where longer, one read of
the words and the signs; over the card's busy time inside the program's
"scan" spans (portbench/spans.py).

The measured time is found by the span, not by a kernel's name, and the
least work is the candidates' whatever computes them: a scan that
enumerates the candidates instead of masking every pair is read by the
same yardstick, and cannot pass 100 % by doing less than they need."""

from portbench.roofline import (BBITS, PEAK_BYTES, roofline_pct,
                                samebits_least_s, self_pairs)
from portbench.spans import overlap, stage_intervals

# samples at which samebits_least_s is bound by its operations (which
# grow with the pairs), not by its bytes (which grow with the samples)
_RATE_N = 1 << 16


def least_s(cell: dict) -> float:
    """The least time of one job of the cell's shapes."""
    n, nk, s64 = cell["n"], cell["nk"], cell["s64"]
    per_pair = samebits_least_s(_RATE_N, nk, s64, 0) / self_pairs(_RATE_N)
    read = (n * nk * s64 * BBITS * 8 + n * -(-cell["signs"] // 2) * 4
            + n * cell["knn"] * 8)
    return max(cell["candidate_pairs"] * per_pair, read / PEAK_BYTES)


def read(trace, spans=None):
    if "candidate_pairs" not in trace.cell:
        return None
    scans = stage_intervals(trace, "scan", spans)
    if not scans:
        return None
    busy_s = overlap(scans, trace.busy_intervals()) / 1e9
    return roofline_pct(least_s(trace.cell), trace.n_jobs, busy_s)
