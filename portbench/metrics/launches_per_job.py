"""Kernels launched on the card per job, counted from the trace."""


def read(trace):
    n = len(trace.in_window(trace.kernels))
    return n / trace.n_jobs if n else None
