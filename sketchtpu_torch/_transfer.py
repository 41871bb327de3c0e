"""Device-to-host copies that overlap the next kernel."""

from __future__ import annotations

import torch


class HostCopy:
    """Starts copying `t` to pinned host memory on the current stream and
    returns at once, so a kernel launched next runs while the host waits
    for (and then formats) this result. A CPU tensor is its own copy."""

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            self._buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._buf.copy_(t, non_blocking=True)
            self._done = torch.cuda.Event()
            self._done.record(torch.cuda.current_stream(t.device))
        else:
            self._buf = t
            self._done = None

    def numpy(self):
        if self._done is not None:
            self._done.synchronize()
        return self._buf.numpy()
