"""K3 in selection mode (csrc/knn_scan.cu: knn_select_kernel and its merge
knn_merge_kernel) against the least time of the samebits of every pair at
the one k scanned, per job."""

from portbench.roofline import roofline_pct, samebits_least_s


def read(trace):
    c = trace.cell
    measured = trace.device_s(
        lambda n: "knn_select_kernel" in n or "knn_merge_kernel" in n)
    return roofline_pct(samebits_least_s(c["n"], 1, c["s64"], c["knn"]),
                        trace.n_jobs, measured)
