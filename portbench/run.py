#!/usr/bin/env python3
"""Run one cell of the benchmark of sketchtpu_torch once, on the GPU.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is an entry of BENCHMARK.json's
`workloads`: a configuration (its file under portbench/configs/ makes the
database, portbench/databases/<kind>.py) and a traffic mix
(portbench/traffic/<name>.json names the job, portbench/jobs/<job>.py).

Set-up makes the database from the seed and writes it under $TMPDIR, to
the disk and not only to the page cache, then runs one warm-up job on its
first WARMUP_SAMPLES samples, written as a database of their own (the same
k, sketch size and kernels), to build and warm everything. The window
then runs jobs back to back, each the port's CLI called in-process
(sketchtpu_torch.cli.main), and closes at the first job to end at or after
--seconds. Each job reads the database under a name of its own (its files
hard-linked into a new directory) and writes its output file anew, so
nothing that the program keeps by path from one job can serve the next,
and a job that writes nothing fails the run. With --trace 0 the result
holds the end-to-end metrics (pairs_per_s: the pairs of the completed jobs
over the window; setup_s: process start to the window's start); with
--trace 1 torch.profiler records the window and the result holds the
per-layer metrics (portbench/metrics/<name>.py), busy_s, window_s and the
breakdown. After the window the last job's output is judged against the
plain reference (portbench/reference/), and each number compared is
printed with its limit, last on stderr and as `checks`, the last key of
the result.

The result is the last line of stdout, one JSON object. The run exits
non-zero and prints no result without the GPUs the cell asks for, or if
jax, jaxlib, flax or sketchtpu is loaded once the window has closed."""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib.util
import io
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "sketchtpu")
# the warm-up job's samples: a whole K2 / K3 column tile (8192) and four
# row tiles, a fraction of a cell's work
WARMUP_SAMPLES = 8192


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc); 0 elsewhere."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def load_cell(root: Path, name: str):
    """(BENCHMARK.json, the cell's workload entry, its configuration,
    its traffic mix) of the cell `name`."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads(
        (root / "portbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    return bench, cell, config, traffic


def module_by_name(kind: str, name: str):
    """portbench/<kind>/<name>.py, found by the name BENCHMARK.json or a data
    file gives."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"no {kind} module {path}")
    qual = f"portbench.{kind}.{name}"
    if qual in sys.modules:
        return sys.modules[qual]
    spec = importlib.util.spec_from_file_location(qual, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[qual] = mod
    spec.loader.exec_module(mod)
    return mod


def banned_modules() -> list[str]:
    """Top-level names in sys.modules that the benchmark may not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


class JobRecord:
    """What the jobs of a run left: the output file (each job writes it
    anew) and each job's captured stdout."""

    def __init__(self, out: Path):
        self.out = out
        self.stdout: list[str] = []


def under_new_name(db, directory: Path):
    """db with its files hard-linked into `directory`, made anew: the same
    bytes, nothing written, under a path that no earlier job named."""
    shutil.rmtree(directory, ignore_errors=True)
    directory.mkdir(parents=True)
    files = []
    for f in db.files:
        os.link(f, directory / f.name)
        files.append(directory / f.name)
    return dataclasses.replace(db, prefix=directory / db.prefix.name,
                               files=files)


def settle(files) -> None:
    """Write the files' dirty pages to disk now, in set-up, so that their
    writeback does not fall into the window's first job."""
    for f in files:
        fd = os.open(f, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)


def run_job(cli_main, job, db, traffic, record: JobRecord, sync,
            directory: Path) -> None:
    """One job: the traffic's command on db under a new name in
    `directory`, its output file removed before and required after where
    the command names it."""
    argv = job.argv(under_new_name(db, directory), traffic, record.out)
    record.out.unlink(missing_ok=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    sync()
    shutil.rmtree(directory)
    if rc != 0:
        raise RuntimeError(f"job {argv} exited {rc}")
    if str(record.out) in argv and not record.out.is_file():
        raise RuntimeError(f"job {argv} exited 0 and wrote no {record.out}")
    record.stdout.append(buf.getvalue())


def measure(one_job, seconds: float, span=None):
    """Jobs back to back, one_job(i) the i-th, until the first that ends at
    or after `seconds`: (each job's end, s from the window's start)."""
    ends = []
    t0 = time.perf_counter()
    while not ends or ends[-1] < seconds:
        with span() if span else contextlib.nullcontext():
            one_job(len(ends))
        ends.append(time.perf_counter() - t0)
    return ends


def device_info(torch, chips: int, on_gpu: bool) -> dict:
    if not on_gpu:
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak)}


def main(argv=None, root: Path = ROOT, require_cuda: bool = True) -> int:
    age0 = process_age_s()
    t_start = time.perf_counter() - age0
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench, cell, config, traffic = load_cell(Path(root), args.workload)
    chips = int(cell["chips"])
    if require_cuda:
        os.environ.setdefault("CUDA_VISIBLE_DEVICES",
                              ",".join(str(i) for i in range(chips)))
        os.environ["SKETCHTPU_TORCH_BACKEND"] = "cuda"
    import torch

    if require_cuda and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < chips):
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = "cuda" if require_cuda else "cpu"
    sync = torch.cuda.synchronize if require_cuda else (lambda: None)

    workdir = Path(tempfile.gettempdir()) / "portbench" / args.workload
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    try:
        return _run(args, bench, cell, config, traffic, chips, device, sync,
                    workdir, t_start, torch, require_cuda)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _run(args, bench, cell, config, traffic, chips, device, sync, workdir,
         t_start, torch, on_gpu) -> int:
    database = module_by_name("databases", config["database"])
    job = module_by_name("jobs", traffic["job"])
    db = database.make(config, args.seed, workdir)
    settle(db.files)
    record = JobRecord(workdir / "out.txt")

    from sketchtpu_torch import cli

    def one_job(i, on=db):
        run_job(cli.main, job, on, traffic, record, sync, workdir / f"job{i}")

    # warm-up: builds, loads, warms
    one_job("-warmup", database.subset(db, min(WARMUP_SAMPLES, db.n),
                                       args.seed, workdir / "warmup"))
    shutil.rmtree(workdir / "warmup")
    record.stdout.clear()
    if on_gpu:
        for i in range(chips):
            torch.cuda.reset_peak_memory_stats(i)
    setup_s = time.perf_counter() - t_start

    if args.trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        from portbench.trace import JOB_SPAN

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_gpu
                                         else [])
        with profile(activities=acts) as prof:
            ends = measure(one_job, args.seconds,
                           lambda: record_function(JOB_SPAN))
    else:
        ends = measure(one_job, args.seconds)
    jobs, window_s = len(ends), ends[-1]

    device_json = device_info(torch, chips, on_gpu)
    found = banned_modules()
    if found:
        print(f"portbench: loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 3
    gc.collect()
    if on_gpu:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    checks = job.check(db, traffic, record, args.seed, device)
    print(f"portbench: set-up {setup_s:.2f} s, window {window_s:.2f} s "
          f"({jobs} jobs), check {time.perf_counter() - t_check:.2f} s; "
          f"jobs took {', '.join(f'{b - a:.3f}' for a, b in zip([0.0] + ends, ends))} s",
          file=sys.stderr)
    limits = job.LIMITS
    correct = all(checks[k] <= limits[k] for k in checks)

    names = [m["name"] for m in (bench["per_layer"] if args.trace
                                 else bench["end_to_end"])
             if args.workload in m.get("workloads", [args.workload])]
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    metrics = {}
    result = {"correct": correct, "attempted": jobs, "failed": 0}
    if args.trace:
        from portbench import trace as tr

        t = tr.from_profiler(prof, job.shapes(db, traffic))
        for name in names:
            value = module_by_name("metrics", name).read(t)
            if value is not None:
                metrics[name] = {"value": value, "unit": units[name]}
        device_json.update(busy_s=t.busy_s(), window_s=t.window_s)
        result["breakdown"] = tr.breakdown(t)
    else:
        values = {"pairs_per_s": jobs * job.pairs(db, traffic) / window_s,
                  "setup_s": setup_s}
        metrics = {k: {"value": values[k], "unit": units[k]} for k in names}
    result.update(metrics=metrics, device=device_json)
    result["checks"] = {k: {"value": v, "limit": limits[k]}
                        for k, v in checks.items()}
    for k, v in checks.items():
        print(f"check {k} = {v} (limit {limits[k]})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
