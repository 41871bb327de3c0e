#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sketchtpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

1. Builds the port's CUDA kernels from sketchtpu_torch/csrc.
2. Holds every kernel against its plain PyTorch twin on the card at the
   main path's shapes (sketch size 1000 -> s64 = 16, k = 17..29 step 2),
   and times both with CUDA events.
3. Drives the main path (`sketch` of 8 synthetic 2 Mb assemblies, then
   dense `dist` self and ref-vs-query: -k 17, --ani, --exact, f32
   core/accessory) through the port's CLI, and checks the result against
   `python -m sketchtpu.cli` on its NumPy host oracle: .skd/.skm and the
   exact dist outputs byte for byte, f32 core/accessory within 1e-5.
4. Runs dense dist on 8192 samples derived from those sketches (33.5 M
   pairs) and reports pairs per second with the card's name and power limit.

Every kernel launch on the main path (phases 3 and 4) is counted; the run
fails if a kernel was never launched there. Any failure exits non-zero.
The second-to-last stdout line is the kernels' JSON record, the last one
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "chip_smoke_work"
KMERS = (17, 19, 21, 23, 25, 27, 29)
SKETCH_SIZE = 1000
S64 = 16
ATOL = 1e-5
N_SCALE = 8192
SEED = 20261016

SOURCES = {
    "samebits": ("sketchtpu_torch/csrc/samebits.cu",
                 "sketchtpu/dist/pallas_kernels.py:136"),
    "coreacc": ("sketchtpu_torch/csrc/coreacc.cu",
                "sketchtpu/dist/coreacc_pallas.py:100"),
    "nthash_bin": ("sketchtpu_torch/csrc/nthash_bin.cu",
                   "sketchtpu/hash/nthash_jax.py:227"),
}


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call of fn() on the card, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def run(cmd, **kw) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, **kw)
    check(proc.returncode == 0,
          f"{' '.join(map(str, cmd))} failed ({proc.returncode}):\n"
          f"{proc.stderr[-3000:]}")
    return proc.stdout


# --- phase 2: kernels against their twins ---------------------------------

def derived_words(n: int, seed: int):
    """(n, nk, s64*14) int64 related sketch words on the card."""
    import numpy as np
    import torch

    from sketchtpu_torch.synth import derive_words

    rng = np.random.default_rng(seed)
    parents = rng.integers(0, 2**64, (8, len(KMERS), S64, 14), dtype=np.uint64)
    words = derive_words(parents, n, KMERS, seed)
    return torch.from_numpy(
        words.reshape(n, len(KMERS), S64 * 14).view(np.int64)
    ).cuda()


def phase2_samebits(words, results):
    import torch

    from sketchtpu_torch.dist.samebits_kernels import samebits, samebits_ref

    b = words[:, 0]
    worst = 0
    times = {}
    for label, a, kw in (
        ("int16 tri row0=4096", b[4096:6144], dict(out_dtype=torch.int16,
                                                    tri=True, row0=4096)),
        ("int32", b[:2048], dict(out_dtype=torch.int32)),
    ):
        got = samebits(a, b, **kw)
        for r0 in (0, a.shape[0] - 256):
            want = samebits_ref(a[r0 : r0 + 256], b, out_dtype=kw["out_dtype"])
            blk = got[r0 : r0 + 256]
            if kw.get("tri"):
                rows = kw["row0"] + r0 + torch.arange(256, device=b.device)
                read = torch.arange(b.shape[0], device=b.device)[None, :] > rows[:, None]
            else:
                read = torch.ones_like(blk, dtype=torch.bool)
            err = (blk[read].long() - want[read].long()).abs().max().item()
            check(err == 0, f"samebits {label}: kernel != twin (max {err})")
            worst = max(worst, err)
        ms = cuda_ms(lambda: samebits(a, b, **kw), reps=10)
        plain = cuda_ms(lambda: samebits_ref(a, b, **kw), reps=2, warmup=0)
        times[label] = (ms, plain)
        print(f"phase2 samebits {label} {tuple(a.shape[:1]) + (b.shape[0],)}: "
              f"equal to twin; kernel {ms:.4f} ms, twin {plain:.2f} ms, "
              f"{a.shape[0] * b.shape[0] / ms / 1e6:.3f} G pair/s")
    ms, plain = times["int16 tri row0=4096"]
    results["samebits"] = dict(max_abs_err=float(worst), ms=ms, plain_ms=plain)


def phase2_coreacc(words, results):
    import torch

    from sketchtpu_torch.dist.coreacc_kernels import coreacc, coreacc_ref

    a, b = words[4096:6144], words
    comp = torch.linspace(0.6, 1.0, b.shape[0], device=b.device)
    comp = comp[torch.randperm(b.shape[0], device=b.device)]
    worst, jumps = 0.0, 0
    times = {}
    for label, c1, c2 in (("plain", None, None),
                          ("completeness", comp[4096:6144], comp)):
        core, acc = coreacc(a, b, KMERS, S64 * 64, c1, c2)
        for r0 in (0, a.shape[0] - 128):
            rs = slice(r0, r0 + 128)
            wc, wa = coreacc_ref(a[rs], b, KMERS, S64 * 64,
                                 None if c1 is None else c1[rs], c2)
            dc = (core[rs] - wc).abs()
            # the beta == 0 discontinuity: core jumps between 0 and 1
            jump = (dc > ATOL) & (torch.minimum(core[rs], wc) < 1e-3) & (
                torch.maximum(core[rs], wc) == 1.0)
            jumps += int(jump.sum())
            err = max(dc[~jump].max().item(), (acc[rs] - wa).abs().max().item())
            check(err <= ATOL, f"coreacc {label}: kernel vs twin {err}")
            worst = max(worst, err)
            fitted = int(((wc > 0) & (wc < 1)).sum())
            check(fitted > 0, f"coreacc {label}: no pair reached the fit")
        ms = cuda_ms(lambda: coreacc(a, b, KMERS, S64 * 64, c1, c2), reps=5)
        plain = cuda_ms(lambda: coreacc_ref(a, b, KMERS, S64 * 64, c1, c2),
                        reps=1, warmup=0)
        times[label] = (ms, plain)
        print(f"phase2 coreacc {label} (2048, 16384) nk=7: within {ATOL} of "
              f"twin (max {worst:.3g}, fitted pairs in sub-block {fitted}); "
              f"kernel {ms:.4f} ms, twin {plain:.2f} ms, "
              f"{a.shape[0] * b.shape[0] / ms / 1e6:.3f} G pair/s")
    print(f"phase2 coreacc beta==0 discontinuity pairs: {jumps}")
    ms, plain = times["plain"]
    results["coreacc"] = dict(max_abs_err=worst, ms=ms, plain_ms=plain,
                              beta0_pairs=jumps)


def phase2_nthash(results):
    import torch

    from sketchtpu_torch.hash.nthash_torch import (
        nthash_bin,
        nthash_bin_ref,
        pack_group,
        tap_tables,
    )
    from sketchtpu_torch.synth import random_streams

    streams = random_streams([2_000_000] * 8 + [20_000_000], SEED)
    seq, starts = pack_group(streams)
    seq_d = torch.from_numpy(seq).cuda()
    starts_d = torch.from_numpy(starts).cuda()
    nbins = S64 * 64
    ms = plain = 0.0
    for k in KMERS:
        tf, tr = (torch.from_numpy(t).cuda() for t in tap_tables(k))
        got = nthash_bin(seq_d, k, tf, tr, True, starts_d, nbins)
        want = nthash_bin_ref(seq_d, k, tf, tr, True, starts_d, nbins)
        check(torch.equal(got, want), f"nthash_bin k={k}: kernel != twin")
        check(not (got == -1).all(dim=1).any(), f"nthash_bin k={k}: empty row")
        ms += cuda_ms(lambda: nthash_bin(seq_d, k, tf, tr, True, starts_d,
                                         nbins), reps=5)
        plain += cuda_ms(lambda: nthash_bin_ref(seq_d, k, tf, tr, True,
                                                starts_d, nbins),
                         reps=1, warmup=0)
    print(f"phase2 nthash_bin 8 x 2 Mb + 20 Mb ({seq.size} bases), 7 k: "
          f"equal to twin; kernel {ms:.3f} ms, twin {plain:.2f} ms for all "
          f"k, {seq.size * len(KMERS) / ms / 1e6:.3f} G base-k/s")
    results["nthash_bin"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain)


# --- phase 3: main path against the host oracle ----------------------------

DIST_MODES = {"k17": ["-k", "17"], "ani": ["-k", "17", "--ani"],
              "exact": ["--exact"], "coreacc": []}


def host_env() -> dict:
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["SKETCHTPU_BACKEND"] = "host"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else [])
    )
    return env


def main_path_commands(prefix: Path, rfile: Path, rfile_q: Path):
    p = str(prefix)
    kmers = ",".join(map(str, KMERS))
    cmds = [
        ["sketch", "-f", str(rfile), "-o", f"{p}db", "-k", kmers,
         "-s", str(SKETCH_SIZE), "--quiet"],
        ["sketch", "-f", str(rfile_q), "-o", f"{p}q", "-k", kmers,
         "-s", str(SKETCH_SIZE), "--quiet"],
    ]
    for name, flags in DIST_MODES.items():
        cmds.append(["dist", f"{p}db", *flags, "-o", f"{p}self_{name}.txt",
                     "--quiet"])
        cmds.append(["dist", f"{p}db", f"{p}q", *flags, "-o",
                     f"{p}cross_{name}.txt", "--quiet"])
    return cmds


def same_bytes(a: Path, b: Path) -> bool:
    return a.stat().st_size > 0 and a.read_bytes() == b.read_bytes()


def knife_edge(got, want):
    """Pairs whose f32 and f64 values differ only because the regression
    sits on a discontinuity of the reference's math, where rounding noise
    in either precision picks the branch: a slope at zero (core jumps
    between ~0 and 1) or a flat Jaccard-vs-k profile (the y variance is 0
    up to rounding, so one side takes the degenerate (0, 0) branch and the
    other reports acc = 1 - J)."""
    import numpy as np

    off = (np.abs(got - want) > ATOL).any(axis=1)
    jump = (np.minimum(got[:, 0], want[:, 0]) < 1e-3) & (
        np.maximum(got[:, 0], want[:, 0]) == 1.0)
    flat = (got == 0).all(axis=1) | (want == 0).all(axis=1)
    return off & (jump | flat)


def compare_coreacc(label: str, got_path: Path, want_path: Path) -> None:
    """f32 core/acc output against the f64 chain: same pairs, every value
    within ATOL except knife-edge pairs, which are counted."""
    import numpy as np

    names, got = coreacc_table(got_path)
    want_names, want = coreacc_table(want_path)
    check(names == want_names and got.shape == want.shape and got.size,
          f"{label}: core/acc pairs differ")
    edge = knife_edge(got, want)
    err = float(np.abs(got[~edge] - want[~edge]).max())
    check(err <= ATOL, f"{label}: core/acc off by {err}")
    print(f"{label}: f32 core/acc max |err| {err:.3g} over {got.shape[0]} "
          f"pairs; knife-edge pairs (slope 0 or flat profile): "
          f"{int(edge.sum())}")


def coreacc_table(path: Path):
    import numpy as np

    rows = [ln.split("\t") for ln in path.read_text().splitlines()]
    return ([r[:2] for r in rows],
            np.array([[float(v) for v in r[2:]] for r in rows]))


def phase3(cli_main):
    from sketchtpu_torch.synth import related_assemblies

    d = WORK / "p3"
    rfile = related_assemblies(d / "fa", 8, 2_000_000, SEED)
    lines = rfile.read_text().splitlines()
    rfile_q = d / "rfile_q.txt"
    rfile_q.write_text("\n".join(lines[5:]) + "\n")
    port_s, host_s = [], []
    for argv in main_path_commands(d / "port_", rfile, rfile_q):
        t0 = time.time()
        check(cli_main(argv) == 0, f"port {argv[0]} failed")
        port_s.append(time.time() - t0)
    for argv in main_path_commands(d / "host_", rfile, rfile_q):
        t0 = time.time()
        run([sys.executable, "-m", "sketchtpu.cli", *argv], env=host_env())
        host_s.append(time.time() - t0)
    mbk = 8 * 2.0 * len(KMERS)
    print(f"phase3 sketch 8 x 2 Mb x {len(KMERS)} k: port {port_s[0]:.3f} s "
          f"= {mbk / port_s[0]:.1f} Mbase-k/s end to end (parse, upload, "
          f"kernels, densify, .skd), host oracle {host_s[0]:.3f} s (a new "
          f"process each)")
    print(f"phase3 all {len(port_s)} commands: port {sum(port_s):.2f} s, "
          f"host oracle {sum(host_s):.2f} s")
    for db in ("db", "q"):
        for ext in (".skd", ".skm"):
            check(same_bytes(d / f"port_{db}{ext}", d / f"host_{db}{ext}"),
                  f"{db}{ext} differs from the host oracle")
    for side in ("self", "cross"):
        for name in ("k17", "ani", "exact"):
            check(same_bytes(d / f"port_{side}_{name}.txt",
                             d / f"host_{side}_{name}.txt"),
                  f"dist {side} {name} differs from the host oracle")
        print(f"phase3 {side}: .skd/.skm, -k 17, --ani, --exact "
              f"byte-identical")
        compare_coreacc(f"phase3 {side} vs host", d / f"port_{side}_coreacc.txt",
                        d / f"host_{side}_coreacc.txt")
    return d / "port_db"


# --- phase 4: a database of the size users run -----------------------------

def scan_dist_file(path: Path, n_values: int) -> int:
    """Line count of a dist output; fails on a line with the wrong number
    of fields or a value that is not finite."""
    lines = 0
    tail = b""
    with open(path, "rb") as f:
        while chunk := f.read(1 << 26):
            chunk = tail + chunk
            cut = chunk.rfind(b"\n") + 1
            body, tail = chunk[:cut], chunk[cut:]
            lines += body.count(b"\n")
            check(b"nan" not in body.lower() and b"inf" not in body,
                  f"{path.name}: non-finite value")
            check(body.count(b"\t") == body.count(b"\n") * (1 + n_values),
                  f"{path.name}: malformed line")
    check(tail == b"", f"{path.name}: unterminated last line")
    return lines


def profile_dist(cli_main, argv, label: str) -> None:
    """One more run of a dist command under torch.profiler: device time by
    kernel against the host clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        check(cli_main(argv) == 0, f"profiled {label} failed")
        torch.cuda.synchronize()
        wall = time.time() - t0
    by_name: dict[str, list] = {}
    for e in prof.events():  # device-side activity only: kernels, copies
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and e.name != "Activity Buffer Request"):
            tot = by_name.setdefault(e.name, [0.0, 0])
            tot[0] += e.time_range.elapsed_us()
            tot[1] += 1
    rows = sorted(((us, n, name) for name, (us, n) in by_name.items()),
                  reverse=True)
    busy_ms = sum(us for us, _, _ in rows) / 1e3
    print(f"phase4 profile {label}: wall {wall:.3f} s (profiler on), device "
          f"kernels + copies {busy_ms:.2f} ms = "
          f"{100 * busy_ms / 1e3 / wall:.2f}% of wall")
    for us, count, key in rows[:6]:
        print(f"  {us / 1e3:10.3f} ms  x{count:<4d} {key[:90]}")


def phase4(cli_main, parent_db: Path, gpu: str) -> None:
    import numpy as np

    from sketchtpu_torch.synth import derive_database

    d = WORK / "p4"
    d.mkdir(parents=True, exist_ok=True)
    db = d / "db8k"
    derive_database(str(parent_db), str(db), N_SCALE, SEED)
    pairs = N_SCALE * (N_SCALE - 1) // 2
    for name, flags, n_values in (("coreacc", [], 2), ("k17", ["-k", "17"], 1)):
        out = d / f"{name}.txt"
        t0 = time.time()
        check(cli_main(["dist", str(db), *flags, "-o", str(out), "--quiet"])
              == 0, f"dist {name} at n={N_SCALE} failed")
        wall = time.time() - t0
        lines = scan_dist_file(out, n_values)
        check(lines == pairs, f"{name}: {lines} lines, expected {pairs}")
        print(f"phase4 dist {name} n={N_SCALE}: {pairs} pairs in {wall:.2f} s "
              f"= {pairs / wall / 1e6:.3f} M pairs/s end to end (load, "
              f"kernels, host format, {out.stat().st_size / 1e9:.2f} GB "
              f"written), {gpu}")
        profile_dist(cli_main, ["dist", str(db), *flags, "-o", str(out),
                                "--quiet"], f"dist {name} n={N_SCALE}")
        out.unlink()
    names = [f"derived_{i:05d}" for i in
             np.random.default_rng(SEED).choice(N_SCALE, 512, replace=False)]
    subset = d / "subset.txt"
    subset.write_text("\n".join(sorted(names)) + "\n")
    for name, flags in (("f32", []), ("exact", ["--exact"])):
        check(cli_main(["dist", str(db), "--subset", str(subset), *flags,
                        "-o", str(d / f"subset_{name}.txt"), "--quiet"]) == 0,
              f"subset dist {name} failed")
    check(scan_dist_file(d / "subset_f32.txt", 2) == 512 * 511 // 2,
          "subset pair count")
    compare_coreacc("phase4 --subset 512 vs --exact", d / "subset_f32.txt",
                    d / "subset_exact.txt")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from sketchtpu_torch import _build
    from sketchtpu_torch.cli import main as cli_main
    from sketchtpu_torch.dist.coreacc_kernels import coreacc
    from sketchtpu_torch.dist.samebits_kernels import samebits
    from sketchtpu_torch.hash.nthash_torch import nthash_bin

    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).strip().splitlines()[0]
    nvcc = run([_build.nvcc_path(), "--version"]).strip().splitlines()[-1]
    print(smi)
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}); {nvcc}; "
          f"compute capability {torch.cuda.get_device_capability(0)}; "
          f"python {sys.version.split()[0]}")
    os.environ["SKETCHTPU_TORCH_BACKEND"] = "cuda"
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir()
    try:
        t0 = time.time()
        lib_path = _build.build()
        print(f"phase1 built {lib_path.name} in {time.time() - t0:.1f} s")
        for ln in lib_path.with_suffix(".log").read_text().splitlines():
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
                print("  ptxas:", ln.replace("ptxas info    :", "").strip())

        results: dict[str, dict] = {}
        words = derived_words(16384, SEED)
        phase2_samebits(words, results)
        phase2_coreacc(words, results)
        del words
        phase2_nthash(results)
        torch.cuda.empty_cache()

        wrappers = {"samebits": samebits, "coreacc": coreacc,
                    "nthash_bin": nthash_bin}
        for fn in wrappers.values():
            fn.launches = 0
        parent = phase3(cli_main)
        phase4(cli_main, parent, smi)
        launches = {name: fn.launches for name, fn in wrappers.items()}
        print(f"main-path launches: {launches}")
        for name, count in launches.items():
            check(count > 0, f"kernel {name} never launched on the main path")
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    record = []
    for name, (source, replaces) in SOURCES.items():
        r = results[name]
        record.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"],
        })
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
