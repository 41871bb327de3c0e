"""Device-to-host copies that overlap the next kernel, and pitched
device-to-device copies by the copy engines."""

from __future__ import annotations

import math

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


def pitch_of(x: torch.Tensor) -> tuple[int, int] | None:
    """(rows, pitch in elements) of x as rows of x.shape[-1] contiguous
    elements at one pitch (a range of the last axis of a contiguous
    tensor, or of a view of whole rows of one), or None."""
    if x.dim() == 0 or (x.shape[-1] > 1 and x.stride(-1) != 1):
        return None
    if x.dim() == 1:
        return 1, x.shape[0]
    for i in range(x.dim() - 2):
        if x.shape[i] > 1 and x.stride(i) != x.stride(i + 1) * x.shape[i + 1]:
            return None
    pitch = x.stride(-2) if x.shape[-2] > 1 else x.shape[-1]
    if pitch < x.shape[-1]:
        return None
    return math.prod(x.shape[:-1]), pitch


def copy_pitched(x: torch.Tensor, device) -> torch.Tensor:
    """A contiguous copy of x (a CUDA tensor whose pitch_of is not None)
    on the CUDA `device`, made by one 2-D memcpy enqueued on the current
    stream of `device`: the copy engines move it, from another GPU too,
    and no kernel runs on either GPU. The caller orders the stream after
    x's writers and keeps x alive until the copy is done."""
    from . import _build

    rows, pitch = pitch_of(x)
    out = torch.empty(x.shape, dtype=x.dtype, device=device)
    width = x.shape[-1] * x.element_size()
    _build.launch(out.device, "stpu_copy2d", out.data_ptr(), width,
                  x.data_ptr(), pitch * x.element_size(), width, rows,
                  x.device.index, what="copy2d")
    return out
