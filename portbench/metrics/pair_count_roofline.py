"""pair_count (csrc/signeq.cu, pair_count_kernel) against the least time
of the sign compares of every pair, per job."""

from portbench.roofline import pair_count_least_s, roofline_pct


def read(trace):
    c = trace.cell
    measured = trace.device_s(lambda n: "pair_count_kernel" in n)
    return roofline_pct(pair_count_least_s(c["n"], c["signs"]), trace.n_jobs,
                        measured)
