#!/usr/bin/env python3
"""The in-process multi-device path on every GPU of one host, against one
GPU, in one process.

    python3 tools/mesh_devices.py [--turns N]   # from the root of a checkout
    python3 tools/mesh_devices.py --rehearse    # small sizes on CPU slots
    python3 tools/mesh_devices.py --words [--rehearse]   # the words axis

Builds the kernels and makes chip_smoke.py's data at its full sizes: 8
synthetic 2 Mb assemblies (k = 17..29 step 2, -s 1000), 8192 and 100,000
samples derived from them, 2 read samples of 10 Mb, 256 proteomes of
1.2 M residues, the 661,000-sample index at S = 100 and a 100,000-sample
one for precluster. Then it runs each command of chip_smoke.py's phase 9
through the port's CLI with runtime.devices giving one GPU ("one") or
every GPU ("all"), in the turns one, all, all, one (N times): each output
of "all" must equal "one"'s byte for byte. Prints every wall beside the
cards' names and power limits, one JSON line a run, and writes them all
to chiprun_out/mesh_devices.json. Needs two GPUs or more; --rehearse
runs the same steps at small sizes with CPU slots ([cpu] against
[cpu] * 3, the kernels' plain twins).

--words runs only the words axis of shard/mesh.py, chip_smoke.py's phase
10, with slot i of each grid on GPU i % count: on four GPUs the 1 x 2,
2 x 2 and 1 x 4 grids put every words slot on a GPU of its own, so each
slot holds only its share of the 4096 x 7 k x 102,400-bin words and its
partials cross to the lead GPU; every result is checked against one
GPU's unsplit kernels bit for bit, each grid's walls printed beside the
unsplit ones, with each slot's timeline of the distance and core/acc
steps (set-up copies, partial, transfers, finish, by CUDA events on one
time axis; each lead's stream checked to run its own partial first), then
the dry run's 4 x 2 grid.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORK = ROOT / "mesh_devices_work"
FULL = dict(assembly=2_000_000, dense=8192, knn=100_000, knn_ca=50_000,
            index=661_000, reads=10_000_000, proteomes=256, records=4000,
            knn_k=50)
SMALL = dict(assembly=30_000, dense=300, knn=600, knn_ca=300, index=2000,
             reads=200_000, proteomes=6, records=20, knn_k=5)


def make_data(C, cli_main, size: dict) -> dict:
    """Every input of the commands, made on one device; returns paths."""
    from sketchtpu_torch.synth import (
        derive_database,
        derive_signs,
        read_samples,
        related_assemblies,
        related_proteomes,
        write_derived_inverted,
    )

    t0 = time.time()
    rfile = related_assemblies(WORK / "fa", 8, size["assembly"], C.SEED)
    kmers = ",".join(map(str, C.KMERS))
    C.check(cli_main(["sketch", "-f", str(rfile), "-o", str(WORK / "db"),
                      "-k", kmers, "-s", str(C.SKETCH_SIZE), "--quiet"]) == 0,
            "sketch of the assemblies failed")
    derive_database(str(WORK / "db"), str(WORK / "dense"), size["dense"],
                    C.SEED)
    derive_database(str(WORK / "db"), str(WORK / "knn"), size["knn"],
                    C.SEED + 5)
    (WORK / "first.txt").write_text(
        "".join(f"derived_{i:05d}\n" for i in range(size["knn_ca"])))
    lines = read_samples(WORK / "fq", 2, size["reads"] // 25, 25,
                         C.SEED + 10)
    (WORK / "reads.txt").write_text("".join(lines))
    related_proteomes(WORK / "faa", size["proteomes"], size["records"], 300,
                      C.SEED + 40, n_ancestors=8)
    sig = C.index_signs(size["index"], C.SEED + 11)
    write_derived_inverted(str(WORK / "idx"),
                           [f"sample_{i:06d}" for i in range(size["index"])],
                           sig, C.INDEX_K)
    write_derived_inverted(str(WORK / "pc"),
                           [f"derived_{i:05d}" for i in range(size["knn"])],
                           derive_signs(size["knn"], C.INDEX_SIZE, 800,
                                        C.SEED + 12), 17)
    print(f"data made in {time.time() - t0:.1f} s (set-up)", flush=True)
    return dict(rfile=rfile)


def commands(C, d: Path, paths: dict, size: dict) -> list:
    """(name, argv, outputs or None for stdout) of phase 9's commands."""
    kmers = ",".join(map(str, C.KMERS))
    knn = str(size["knn_k"])
    cmds = [
        ("sketch_dna", ["sketch", "-f", paths["rfile"], "-o", d / "db", "-k",
                        kmers, "-s", C.SKETCH_SIZE],
         [d / "db.skd", d / "db.skm"]),
        ("sketch_reads", ["sketch", "-f", WORK / "reads.txt", "-o",
                          d / "reads", "-k", kmers, "-s", C.SKETCH_SIZE,
                          "--min-count", "5", "--threads", C.THREADS],
         [d / "reads.skd", d / "reads.skm"]),
        ("sketch_aa", ["sketch", "-f", WORK / "faa" / "rfile.txt", "-o",
                       d / "aa", "-k", ",".join(map(str, C.AA_KMERS)), "-s",
                       C.SKETCH_SIZE, "--seq-type", "aa", "--threads",
                       C.THREADS], [d / "aa.skd", d / "aa.skm"]),
        ("dense_coreacc", ["dist", WORK / "dense", "-o", d / "dense.txt"],
         [d / "dense.txt"]),
        ("knn_k17", ["dist", WORK / "knn", "-k", "17", "--knn", knn, "-o",
                     d / "knn_k17.txt"], [d / "knn_k17.txt"]),
        ("knn_coreacc", ["dist", WORK / "knn", "--subset",
                         WORK / "first.txt", "--knn", knn, "-o",
                         d / "knn_coreacc.txt"], [d / "knn_coreacc.txt"]),
        ("count", ["inverted", "precluster", WORK / "idx.ski", "--count"],
         None),
        ("precluster_k17", ["inverted", "precluster", WORK / "pc.ski",
                            "--skd", WORK / "knn", "--knn", knn, "-o",
                            d / "pc_k17.txt"], [d / "pc_k17.txt"]),
    ]
    for q in ("match-count", "all-bins", "any-bins"):
        cmds.append((f"query661k_{q}", [
            "inverted", "query", WORK / "idx.ski", "-f", paths["rfile"],
            "--query-type", q, "--threads", C.THREADS, "-o",
            d / f"query_{q}.txt"], [d / f"query_{q}.txt"]))
    return [(name, [str(a) for a in argv] + ["--quiet"], outs)
            for name, argv, outs in cmds]


def run_turn(C, cli_main, label: str, devs, paths, size, digests, records,
             gpu: str) -> None:
    """Every command on devs; the first "one" turn keeps each output's
    SHA-256, every other turn must match it."""
    d = WORK / label
    d.mkdir(parents=True, exist_ok=True)
    for name, argv, outs in commands(C, d, paths, size):
        outs = outs or [d / f"{name}.out"]  # the command's stdout
        with C.visible_devices(devs), contextlib.ExitStack() as stack:
            if name == "count":
                stack.enter_context(contextlib.redirect_stdout(
                    stack.enter_context(open(outs[0], "w"))))
            t0 = time.time()
            rc = cli_main(argv)
            wall = time.time() - t0
        C.check(rc == 0, f"{label} {name} failed")
        digest = C.sha256_of(outs)
        if name not in digests:
            digests[name] = digest
        C.check(digest == digests[name],
                f"{label} {name}: output differs from one device's")
        rec = dict(command=name, devices=label, n_devices=len(devs),
                   wall_s=wall, gpu=gpu)
        records.append(rec)
        print(json.dumps(rec), flush=True)
        for p in outs:
            p.unlink()


def words_axis(C, build, rehearse: bool) -> int:
    """chip_smoke.py's phase 10 on every GPU (or, rehearsing, on CPU slots
    at 96 samples and s64 = 16)."""
    import torch

    if rehearse:
        os.environ["SKETCHTPU_TORCH_BACKEND"] = "cpu"
        C.phase10("CPU slots (rehearsal: no device numbers)", n=96, s64=16,
                  device="cpu")
        return 0
    if not torch.cuda.is_available():
        print("mesh_devices: torch sees no GPU", file=sys.stderr)
        return 2
    os.environ["SKETCHTPU_TORCH_BACKEND"] = "cuda"
    gpu = "; ".join(C.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"]).strip().splitlines())
    print(gpu)
    t0 = time.time()
    build.build()
    print(f"built the kernels in {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    C.phase10(gpu)
    print(f"the words axis on {torch.cuda.device_count()} GPUs: every "
          f"result bit-equal to one GPU's unsplit kernels in "
          f"{time.time() - t0:.1f} s; {gpu}")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--turns", type=int, default=1,
                    help="repeats of the turns one, all, all, one")
    ap.add_argument("--rehearse", action="store_true",
                    help="small sizes on CPU slots (no GPU needed)")
    ap.add_argument("--words", action="store_true",
                    help="only the words axis (chip_smoke.py phase 10)")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as C
    from sketchtpu_torch import _build
    from sketchtpu_torch.cli import main as cli_main

    if args.words:
        return words_axis(C, _build, args.rehearse)

    if args.rehearse:
        os.environ["SKETCHTPU_TORCH_BACKEND"] = "cpu"
        one, every = [torch.device("cpu")], [torch.device("cpu")] * 3
        size, gpu = SMALL, "CPU slots (rehearsal: no device numbers)"
    else:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < 2:
            print(f"mesh_devices: needs two GPUs or more, torch sees {n}",
                  file=sys.stderr)
            return 2
        os.environ["SKETCHTPU_TORCH_BACKEND"] = "cuda"
        one = [torch.device("cuda", 0)]
        every = [torch.device("cuda", i) for i in range(n)]
        size = FULL
        gpu = "; ".join(C.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"]).strip().splitlines())
        print(gpu)
        t0 = time.time()
        _build.build()
        print(f"built the kernels in {time.time() - t0:.1f} s", flush=True)
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir()
    records, digests = [], {}
    try:
        with C.visible_devices(one):
            paths = make_data(C, cli_main, size)
        for _ in range(args.turns):
            for label, devs in (("one", one), ("all", every), ("all", every),
                                ("one", one)):
                run_turn(C, cli_main, label, devs, paths, size, digests,
                         records, gpu)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "mesh_devices.json").write_text(
        "\n".join(json.dumps(r) for r in records) + "\n")
    print(f"every output on {len(every)} devices byte-identical to one "
          f"device's; {gpu}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
