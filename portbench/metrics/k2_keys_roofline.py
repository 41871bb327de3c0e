"""K2 in key mode (csrc/coreacc.cu, coreacc_kernel) against the least time
of the samebits of every pair at every k, per job."""

from portbench.roofline import roofline_pct, samebits_least_s


def read(trace):
    c = trace.cell
    measured = trace.device_s(lambda n: "coreacc_kernel" in n)
    return roofline_pct(samebits_least_s(c["n"], c["nk"], c["s64"], c["knn"]),
                        trace.n_jobs, measured)
