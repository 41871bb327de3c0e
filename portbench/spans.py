#!/usr/bin/env python3
"""The program's own spans (sketchtpu_torch/spans.py) in a traced run, read
beside the run's device trace (portbench/trace.py): a stage's host wall,
and the device's idle time that fell inside it, per job.

The program records its host stages (load, engine, scan, values, write,
and the spans inside them) while a torch profiler runs, on
time.time_ns(), the clock of the trace's events. The per-layer readers
load_ms_per_job, engine_ms_per_job, scan_idle_ms_per_job,
values_ms_per_job and write_ms_per_job read them here, keeping the spans
inside the trace's window. A program without the recorder (no
sketchtpu_torch.spans) gives nothing to read: each returns None.

    python3 portbench/spans.py --workload <cell> --seed <n> --seconds <s>

runs the cell traced (portbench/run.py with --trace 1, whose lines it
prints first) and then prints the table of the window's device-idle
seconds a job by stage: each span under the jobs' cli.* roots by its path
of names, its host wall, the idle time inside it, and its counts a job
(MB/s of bytes, pairs/s of pairs, launches), then the idle time inside
the roots but in no stage, and outside the roots."""

from __future__ import annotations

import sys
from collections import defaultdict
from pathlib import Path


def program_spans() -> list:
    """The host spans the program recorded, or [] for a program without
    the recorder."""
    try:
        from sketchtpu_torch import spans
    except ImportError:
        return []
    return [s for s in spans.recorded() if s.where is None]


def union(intervals) -> list:
    """The union of [(start, end)] as sorted, disjoint [start, end]."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def overlap(a, b) -> int:
    """The length of the intersection of two sorted, disjoint lists of
    intervals."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def in_window(trace, spans) -> list:
    """(span, start, end) of the spans that overlap the trace's window,
    clipped to it."""
    t0, t1 = trace.window
    return [(s, max(s.start_ns, t0), min(s.end_ns, t1)) for s in spans
            if s.end_ns > t0 and s.start_ns < t1]


def stage_intervals(trace, name: str, spans=None) -> list:
    """The union of the spans named `name` inside the window."""
    spans = program_spans() if spans is None else spans
    return union((a, b) for s, a, b in in_window(trace, spans)
                 if s.name == name)


def wall_ms_per_job(trace, name: str, spans=None):
    """Host ms a job inside the spans `name`, or None where there are
    none."""
    iv = stage_intervals(trace, name, spans)
    if not iv:
        return None
    return sum(e - s for s, e in iv) / 1e6 / trace.n_jobs


def idle_ms_per_job(trace, name: str, spans=None):
    """Ms a job with nothing on the device inside the spans `name`, or
    None where there are none."""
    iv = stage_intervals(trace, name, spans)
    if not iv:
        return None
    return overlap(iv, union(trace.idle_gaps())) / 1e6 / trace.n_jobs


def _paths(spans) -> dict:
    """{span id: its path of names below its cli.* root} of every span
    under a root; roots have the path ()."""
    by_id = {s.id: s for s in spans}
    paths = {}

    def path(s):
        if s.id not in paths:
            if s.parent is None:
                paths[s.id] = () if s.name.startswith("cli.") else None
            else:
                up = by_id.get(s.parent)
                above = path(up) if up is not None else None
                paths[s.id] = None if above is None else above + (s.name,)
        return paths[s.id]

    for s in spans:
        path(s)
    return {k: v for k, v in paths.items() if v is not None}


def _rates(counts: dict, wall_s: float, jobs: int) -> str:
    out = []
    for k, v in sorted(counts.items()):
        if k == "bytes":
            out.append(f"{v / jobs / 1e6:.3f} MB"
                       + (f" ({v / wall_s / 1e6:.0f} MB/s)" if wall_s else ""))
        elif k == "pairs":
            out.append(f"{v / jobs:.0f} pairs"
                       + (f" ({v / wall_s:.3g} pairs/s)" if wall_s else ""))
        else:
            out.append(f"{v / jobs:.1f} {k}")
    return ", ".join(out)


def table(trace, spans=None) -> dict:
    """The window's device idle by stage: rows [path, wall s a job, idle s
    a job, counts (summed)], and the idle s a job in all, inside the
    roots' stages, inside the roots but in no stage, and outside the
    roots."""
    spans = program_spans() if spans is None else spans
    kept = in_window(trace, spans)
    paths = _paths([s for s, _, _ in kept])
    idle = union(trace.idle_gaps())
    jobs = trace.n_jobs
    groups = defaultdict(list)
    counts = defaultdict(lambda: defaultdict(int))
    for s, a, b in kept:
        p = paths.get(s.id)
        if p is None:
            continue
        groups[p].append((a, b))
        for k, v in s.counts.items():
            counts[p][k] += v
    rows = []
    first = {p: min(a for a, _ in ivs) for p, ivs in groups.items()}
    # each stage, its spans below it, in the order they first opened
    for p in sorted(groups, key=lambda p: [first[p[:i + 1]]
                                           for i in range(len(p))]):
        if not p:
            continue
        iv = union(groups[p])
        rows.append([p, sum(e - s for s, e in iv) / 1e9 / jobs,
                     overlap(iv, idle) / 1e9 / jobs, dict(counts[p])])
    roots = union(groups.get((), []))
    stages = union(iv for p, ivs in groups.items() if len(p) == 1
                   for iv in ivs)
    total = sum(e - s for s, e in idle) / 1e9 / jobs
    in_stages = overlap(stages, idle) / 1e9 / jobs
    in_roots = overlap(roots, idle) / 1e9 / jobs
    return {"rows": rows, "idle": total, "stages": in_stages,
            "roots_not_stages": in_roots - in_stages,
            "outside_roots": total - in_roots, "jobs": jobs,
            "window_s": trace.window_s}


def show(t: dict) -> str:
    lines = [f"{t['jobs']} jobs in {t['window_s']:.2f} s; device idle "
             f"{t['idle']:.4f} s a job",
             f"{'span (path under cli.*)':36} {'wall s/job':>11} "
             f"{'idle s/job':>11} {'of idle':>8}  counts a job"]
    for p, wall, idle, counts in t["rows"]:
        name = "  " * (len(p) - 1) + p[-1]
        share = 100 * idle / t["idle"] if t["idle"] else 0.0
        lines.append(f"{name:36} {wall:11.4f} {idle:11.4f} {share:7.2f}%  "
                     + _rates(counts, wall * t["jobs"], t["jobs"]))
    for key, label in (("stages", "the stages in all"),
                       ("roots_not_stages", "inside cli.*, in no stage"),
                       ("outside_roots", "outside cli.* (between jobs)")):
        share = 100 * t[key] / t["idle"] if t["idle"] else 0.0
        lines.append(f"{label:36} {'':11} {t[key]:11.4f} {share:7.2f}%")
    return "\n".join(lines)


def main(argv=None) -> int:
    """portbench/run.py --trace 1 on the arguments given, then the table
    of its window."""
    from portbench import run
    from portbench import trace as tr

    seen = []
    from_profiler = tr.from_profiler

    def keep(prof, cell):
        seen.append(from_profiler(prof, cell))
        return seen[-1]

    tr.from_profiler = keep
    try:
        rc = run.main([*(sys.argv[1:] if argv is None else argv),
                       "--trace", "1"])
    finally:
        tr.from_profiler = from_profiler
    if rc == 0 and seen:
        print(show(table(seen[-1])))
    return rc


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    sys.exit(main())
