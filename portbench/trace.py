"""The traced run's record: torch.profiler over the measured window, reduced
to the jobs' spans, the device's kernels and copies, and the main
thread's host operations, on one clock (ns). The per-layer readers
(portbench/metrics/) and the breakdown read a Trace."""

from __future__ import annotations

import heapq
import re
from dataclasses import dataclass, field

JOB_SPAN = "portbench.job"
_NOT_DEVICE_WORK = {"Activity Buffer Request", JOB_SPAN}


@dataclass
class Trace:
    jobs: list  # [(start, end)] of each job, ns
    kernels: list  # [(name, start, end)] device kernels, ns
    copies: list  # [(name, start, end)] memcpy / memset on the device, ns
    host: list = field(default_factory=list)  # [(name, start, end)] main thread
    cell: dict = field(default_factory=dict)  # shapes of the cell's jobs

    @property
    def window(self) -> tuple[int, int]:
        return self.jobs[0][0], self.jobs[-1][1]

    @property
    def window_s(self) -> float:
        t0, t1 = self.window
        return (t1 - t0) / 1e9

    @property
    def n_jobs(self) -> int:
        return len(self.jobs)

    def in_window(self, events) -> list:
        t0, t1 = self.window
        return [(n, max(s, t0), min(e, t1)) for n, s, e in events
                if e > t0 and s < t1]

    def busy_intervals(self) -> list:
        """The union of every kernel's and copy's interval in the window."""
        spans = sorted((s, e) for _, s, e in self.in_window(self.kernels + self.copies))
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def device_s(self, match) -> float:
        """Device seconds in the window of the kernels and copies whose name
        `match` accepts."""
        return sum(e - s for n, s, e in self.in_window(self.kernels + self.copies)
                   if match(n)) / 1e9

    def idle_gaps(self) -> list:
        """[(start, end)] of the window's stretches with nothing on the
        device."""
        t0, t1 = self.window
        gaps, at = [], t0
        for s, e in self.busy_intervals():
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if t1 > at:
            gaps.append((at, t1))
        return gaps


def short_name(name: str) -> str:
    """A device operation's name without its argument list and template
    arguments, at most 100 characters."""
    anon = "(anonymous namespace)"
    name = re.sub(r"^void ", "", name).replace(anon, "\0")
    depth, out = 0, []
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and out:
            break
        elif depth == 0:
            out.append(ch)
    short = "".join(out).strip() or name
    return short.replace("\0", anon)[:100]


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by the
    host operation the main thread was in (its outermost one; "host
    outside torch operations" where it was in none), each as [[name,
    seconds]] with at most `top` entries."""
    by_op: dict[str, float] = {}
    for n, s, e in trace.in_window(trace.kernels + trace.copies):
        key = short_name(n)
        by_op[key] = by_op.get(key, 0.0) + (e - s) / 1e9
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    host = sorted(trace.host, key=lambda h: h[1])
    gaps = sorted(trace.idle_gaps(), key=lambda g: (g[0] + g[1]) // 2)
    by_host: dict[str, float] = {}
    active: list = []  # heap of (start, end, name): the outermost on top
    i = 0
    for s, e in gaps:
        mid = (s + e) // 2
        while i < len(host) and host[i][1] <= mid:
            heapq.heappush(active, (host[i][1], host[i][2], host[i][0]))
            i += 1
        while active and active[0][1] < mid:
            heapq.heappop(active)
        label = active[0][2] if active else "host outside torch operations"
        by_host[label] = by_host.get(label, 0.0) + (e - s) / 1e9
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in idle]}


def from_profiler(prof, cell: dict) -> Trace:
    """A Trace of a finished torch.profiler.profile whose jobs ran inside
    record_function(JOB_SPAN)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    jobs, kernels, copies, raw = [], [], [], []
    main_thread = None
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if ev.device_type() == cuda:
            if name in _NOT_DEVICE_WORK:
                continue
            (copies if name.startswith(("Memcpy", "Memset")) else
             kernels).append((name, s, e))
        elif name == JOB_SPAN:
            jobs.append((s, e))
            main_thread = ev.start_thread_id()
        else:
            raw.append((name, s, e, ev.start_thread_id()))
    host = [(n, s, e) for n, s, e, t in raw if t == main_thread]
    jobs.sort()
    return Trace(jobs=jobs, kernels=kernels, copies=copies, host=host,
                 cell=cell)
