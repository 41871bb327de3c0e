"""Device time per job of the top-k, sort and concatenation kernels that
merge K2's key tiles (dist/knn_torch.py::_merge), ms."""

_PARTS = ("topk", "sort", "catarray")


def read(trace):
    s = trace.device_s(lambda n: any(p in n.lower() for p in _PARTS)
                       and not n.startswith(("Memcpy", "Memset")))
    return 1e3 * s / trace.n_jobs if s > 0 else None
