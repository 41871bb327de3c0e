"""Host-to-device copies' device time per job, ms."""


def read(trace):
    s = trace.device_s(lambda n: n.startswith("Memcpy HtoD"))
    return 1e3 * s / trace.n_jobs if s > 0 else None
