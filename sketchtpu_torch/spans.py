"""Spans of the port's host stages, and of device work inside mesh.timeline().

A host span (span(name, **counts)) times one stage of a command on the
host: name, start_ns and end_ns by time.time_ns(), the span it opened
inside on the same thread (parent), the thread, counts added by count(),
and the run: every span opened while a root span (one opened with no span
open anywhere in the process, cli.main's) is open shares its id.
recorded() returns the closed spans, kept in memory.

Host spans are recorded exactly while a torch profiler runs in the
process (torch.autograd.profiler._is_profiler_enabled); there is no flag
of their own. Off, a span costs a read of the profiler's flag and returns
a shared no-op. time.time_ns() is the clock kineto stamps host and device
events with, so a span placed beside a profiler trace holds the device's
idle gaps that fell inside it. Under a profiler that the program did not
start (a benchmark's) a span opens no record_function range, whose
device-side twin in the kineto trace would read as device work; under one
it started itself (annotate(True): the CLI's --jax-profile), each span
also opens record_function(name), so the Chrome trace shows the stages.
A span never synchronizes, copies or reorders work: its host time holds
whatever wait its stage already had.

A device span (device_span) times the work enqueued inside it on a CUDA
stream by two CUDA events, while device_spans() is open (mesh.timeline()
opens it), whatever the profiler. device_spans() pairs an origin event on
every GPU with time.time_ns() (synchronize, record, read the clock), and
a device span's events are placed on that clock when read.

This module imports torch only once torch is loaded: importing the
package imports neither jax nor torch.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import sys
import threading
import time
from dataclasses import dataclass, field


class _BeforeTorch:
    """The profiler's flag before torch is imported (no profiler can run
    then); the module itself takes its place once torch is loaded."""

    @property
    def _is_profiler_enabled(self) -> bool:
        global _profiler
        mod = sys.modules.get("torch.autograd.profiler")
        if mod is None:
            return False
        _profiler = mod
        return mod._is_profiler_enabled


_profiler = _BeforeTorch()
_annotate = False  # the program started the running profiler itself
_ids = itertools.count(1)
_runs = itertools.count(1)
_run = None  # the id of the run whose root span is open, or None
_spans: list = []  # every span, a host one as opened, a device one as enqueued
_device = None  # the open _DeviceClock, or None


class _Open(threading.local):
    """The host spans open on this thread, innermost last."""

    def __init__(self):
        self.stack = []


_open = _Open()


@dataclass(eq=False)
class Span:
    """One span, and while open (a host span) its own context manager."""

    name: str
    start_ns: int
    end_ns: int | None = None
    parent: int | None = None  # id of the span it opened inside
    thread: int = 0  # threading.get_ident() of the thread that opened it
    run: int | None = None
    id: int = 0
    counts: dict = field(default_factory=dict)
    # a device span's stream and slot; None for a host span
    where: dict | None = None
    _kernels: tuple = ()
    _launched: int = 0
    _root: bool = False  # it opened its run
    _rf: object = None
    _events: tuple | None = None  # (clock, start, end) until placed

    def __enter__(self):
        global _run
        stack = _open.stack
        if stack:
            self.parent, self.run = stack[-1].id, stack[-1].run
        elif _run is None:
            self.run = _run = next(_runs)
            self._root = True
        else:
            self.run = _run
        self.id = next(_ids)
        self.thread = threading.get_ident()
        stack.append(self)
        _spans.append(self)
        if self._kernels:
            self._launched = _launches(self._kernels)
        if _annotate:
            import torch

            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        global _run
        self.end_ns = time.time_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        if self._kernels:
            self.counts["launches"] = (self.counts.get("launches", 0)
                                       + _launches(self._kernels)
                                       - self._launched)
        _open.stack.remove(self)
        if self._root:
            _run = None
        return False


class _Off:
    """The span of a stage while nothing records: does nothing."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _launches(kernels) -> int:
    return sum(k.launches for k in kernels)


def span(name: str, kernels: tuple = (), **counts):
    """A host span `name` with the initial counts given, recorded while a
    torch profiler runs. kernels: kernel wrappers (functions with a
    `.launches` attribute) whose launches inside the span are added to
    its count "launches"."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return Span(name, 0, counts=counts, _kernels=kernels)


def count(name: str, n: int) -> None:
    """Add n to the count `name` of this thread's innermost open span
    (nothing while no span records)."""
    if not _profiler._is_profiler_enabled:
        return
    stack = _open.stack
    if stack:
        c = stack[-1].counts
        c[name] = c.get(name, 0) + n


def spanned(name: str, kernels: tuple = ()):
    """A decorator: each call of the function inside span(name, kernels)."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name, kernels):
                return fn(*args, **kwargs)

        return call

    return wrap


def annotate(on: bool) -> None:
    """Whether spans also open record_function ranges: only under a
    profiler the program started itself."""
    global _annotate
    _annotate = on


def recorded() -> list[Span]:
    """Every closed span, host and device: a host span where it was
    opened, a device span where its work was enqueued, the times of each
    device span placed once its end event has completed."""
    for s in _spans:
        if s._events is not None and s.end_ns is None:
            s._events[0].place(s)
    return [s for s in _spans if s.end_ns is not None]


class _DeviceClock:
    """Origins of every GPU's events on time.time_ns(): per GPU, an event
    recorded on its current stream once the GPU is idle, with the clock
    read just after."""

    def __init__(self):
        import torch

        self.origin = {}
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(i))
            self.origin[i] = (ev, time.time_ns())
        self.start_ns = min((t for _, t in self.origin.values()),
                            default=time.time_ns())
        self.spans: list[Span] = []

    def read(self) -> list[Span]:
        """The device spans recorded, in the order enqueued, placed."""
        for s in self.spans:
            if s.end_ns is None:
                self.place(s)
        return list(self.spans)

    def place(self, s: Span) -> None:
        _, start, end = s._events
        end.synchronize()
        ev, t0 = self.origin[s.where["stream"].device.index]
        s.start_ns = t0 + round(ev.elapsed_time(start) * 1e6)
        s.end_ns = t0 + round(ev.elapsed_time(end) * 1e6)


@contextlib.contextmanager
def device_spans():
    """Record device spans inside (one recording at a time): yields the
    clock, whose .spans are those recorded and .start_ns its origin."""
    global _device
    _device = _DeviceClock()
    try:
        yield _device
    finally:
        _device = None


@contextlib.contextmanager
def device_span(name: str, device, stream=None, slot: str = ""):
    """Time the work enqueued inside on `stream` (default: the current
    stream of the CUDA `device`) as a device span of `slot`, while
    device_spans() is open; otherwise, or off the card, do nothing."""
    clock = _device
    if clock is None or device.type != "cuda":
        yield
        return
    import torch

    stream = stream or torch.cuda.current_stream(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    stack = _open.stack
    s = Span(name, 0, parent=stack[-1].id if stack else None,
             thread=threading.get_ident(),
             run=stack[-1].run if stack else None, id=next(_ids),
             where=dict(stream=stream, slot=slot),
             _events=(clock, start, end))
    start.record(stream)
    yield
    end.record(stream)
    _spans.append(s)
    clock.spans.append(s)
