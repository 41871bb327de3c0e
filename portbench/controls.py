#!/usr/bin/env python3
"""The controls of `correct`, at a cell's own size, on the GPU: for each
seed, the numbers the job's comparison gives when the reference, one step
of precision down, stands in the port's place (portbench/jobs/<job>.py
`control`). Each must come out above its limit. The benchmark's runs do
not run this.

    python3 portbench/controls.py --workload <cell> --seeds 1 2 3

prints one JSON line a seed: {"seed", "numbers", "fault", "limits",
"seconds"}, where "fault" holds the numbers of a planted fault where the
job defines one (`fault`: the knn-th neighbour replaced by the next)."""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    from portbench import run

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    _, cell, config, traffic = run.load_cell(ROOT, args.workload)
    os.environ["SKETCHTPU_TORCH_BACKEND"] = "cuda"
    import torch

    if not torch.cuda.is_available():
        print("controls: no CUDA device", file=sys.stderr)
        return 2
    database = run.module_by_name("databases", config["database"])
    job = run.module_by_name("jobs", traffic["job"])
    workdir = Path(tempfile.gettempdir()) / "portbench-controls" / args.workload
    for seed in args.seeds:
        shutil.rmtree(workdir, ignore_errors=True)
        workdir.mkdir(parents=True)
        t0 = time.perf_counter()
        db = database.make(config, seed, workdir)
        numbers = job.control(db, traffic, seed, "cuda", workdir)
        planted = (job.fault(db, traffic, seed, "cuda", workdir)
                   if hasattr(job, "fault") else None)
        print(json.dumps({"seed": seed, "numbers": numbers, "fault": planted,
                          "limits": job.LIMITS,
                          "seconds": time.perf_counter() - t0}), flush=True)
    shutil.rmtree(workdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
