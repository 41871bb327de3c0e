#!/usr/bin/env python3
"""Design variants of two kernels of the port, timed on one NVIDIA GPU.

    python3 tools/kernel_variants.py         # from the root of a checkout

Each variant is a patched copy of sketchtpu_torch/csrc (the shipped
sources with a few text substitutions), built with the port's own nvcc
flags into kernel_variants_work/<variant>/ and loaded in a process of its
own. The variants, against the shipped design:
- signs_run32, signs_run64: the signs kernel (nthash_signs) with runs of
  32 or 64 window starts a thread instead of 16;
- pair_xor: pair_count with the XOR / IADD / LOP3 compare of signeq.cuh
  (AnyEq) in place of the DPX one, in the same tile, ring and resident
  row tile.
Each variant is held against the plain twin, then timed by CUDA events in
turns (every variant once, then again): nthash_signs over the reads
path's chunk (4,793,490 window starts x 7 k) of a stream that fills it,
and of chip_smoke.py's 2 Mb stream; pair_count on rows [0, 8192) of
chip_smoke.py's 661,000-row index at S = 100. Prints one JSON line per
measurement and writes them all to chiprun_out/kernel_variants.json.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
WORK = ROOT / "kernel_variants_work"
SIGNS_LG = ("constexpr int SLG = 4;", "constexpr int SLG = {};")
PAIR_XOR = [
    ("return pad ? (v & 0xFFFFu) | 0x10000u : v;",
     "return pad ? (x & 0xFFFFu) | 0xFFFF0000u : x;"),
    ("for (int j = 0; j < 8; ++j) acc[i][j] = 0xFFFFFFFFu;",
     "for (int j = 0; j < 8; ++j) acc[i][j] = 0u;"),
    ("acc[i][j] = __viaddmin_u16x2(av[i], bv[j], acc[i][j]);",
     "AnyEq::step(acc[i][j], av[i], bv[j]);"),
    ("return ((acc & 0xFFFFu) == 0u) | (acc < 0x10000u);",
     "return AnyEq::any(acc);"),
]
# name: (patches of signeq.cu, patches of nthash_bin.cu, signs run lg)
VARIANTS = {
    "shipped": ([], [], 4),
    "signs_run32": ([], [(SIGNS_LG[0], SIGNS_LG[1].format(5))], 5),
    "signs_run64": ([], [(SIGNS_LG[0], SIGNS_LG[1].format(6))], 6),
    "pair_xor": (PAIR_XOR, [], 4),
}


def prepare(name: str) -> Path:
    """The variant's patched csrc; fails if a patch does not apply."""
    signeq, nthash, _ = VARIANTS[name]
    d = WORK / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(ROOT / "sketchtpu_torch" / "csrc", d / "csrc")
    for fname, patches in (("signeq.cu", signeq), ("nthash_bin.cu", nthash)):
        path = d / "csrc" / fname
        text = path.read_text()
        for old, new in patches:
            if old not in text:
                raise SystemExit(f"{name}: patch does not apply: {old}")
            text = text.replace(old, new)
        path.write_text(text)
    return d


def use(name: str):
    """Point the port's builder at the variant and build it."""
    from sketchtpu_torch import _build
    from sketchtpu_torch.hash import nthash_torch

    d = WORK / name
    _build.CSRC, _build.BUILD_DIR = d / "csrc", d / "build"
    nthash_torch._SIGNS_RUN_LG = VARIANTS[name][2]
    _build.build()
    return _build


def measure(name: str, rep: int) -> list:
    import torch

    import chip_smoke as C
    from sketchtpu_torch.hash.nthash_torch import (
        nthash_signs,
        nthash_signs_ref,
        pack_group,
    )
    from sketchtpu_torch.inverted.device import (
        pack_signs,
        pair_count,
        pair_count_ref,
    )
    from sketchtpu_torch.sketchcore.sketch_torch import _READ_CHUNK_SIGNS

    use(name)
    gpu = torch.cuda.get_device_name(0)
    out = []
    own = _READ_CHUNK_SIGNS // len(C.KMERS)
    reach = max(C.KMERS) - 1
    for label, n in (("full chunk", own + reach), ("2 Mb", 2_000_000)):
        seq = torch.from_numpy(
            pack_group([C.reads_stream(n, C.SEED)])[0]).cuda()
        got = nthash_signs(seq, C.KMERS, True, own)
        want = nthash_signs_ref(seq, C.KMERS, True, own)
        if not torch.equal(got, want):
            raise SystemExit(f"{name}: nthash_signs != twin ({label})")
        del want
        ms = C.cuda_ms(lambda: nthash_signs(seq, C.KMERS, True, own),
                       reps=20)
        out.append(dict(variant=name, rep=rep, kernel="nthash_signs",
                        shape=f"{own} starts x 7 k, {label}", ms=ms,
                        gpu=gpu))
    m = pack_signs(C.index_signs(C.N_INDEX, C.SEED + 6), "cuda")
    got = pair_count(m, C.INDEX_SIZE, 0, 8192)
    if rep == 0 and got != pair_count_ref(m, C.INDEX_SIZE, 0, 8192,
                                          tile=2048):
        raise SystemExit(f"{name}: pair_count != twin")
    ms = C.cuda_ms(lambda: pair_count(m, C.INDEX_SIZE, 0, 8192), reps=5)
    out.append(dict(variant=name, rep=rep, kernel="pair_count",
                    shape="rows [0, 8192) x 661000, S = 100", ms=ms,
                    pairs_sharing=got, gpu=gpu))
    return out


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--measure":
        for rec in measure(sys.argv[2], int(sys.argv[3])):
            print("RESULT " + json.dumps(rec), flush=True)
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--build":
        use(sys.argv[2])
        return 0
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    for name in VARIANTS:
        prepare(name)
    builds = [subprocess.Popen([sys.executable, __file__, "--build", name])
              for name in VARIANTS]
    if any(p.wait() for p in builds):
        return 1
    records = []
    for rep in range(2):
        for name in VARIANTS:
            proc = subprocess.run(
                [sys.executable, __file__, "--measure", name, str(rep)],
                capture_output=True, text=True, cwd=ROOT)
            if proc.returncode:
                print(proc.stdout[-2000:], proc.stderr[-4000:])
                return 1
            for ln in proc.stdout.splitlines():
                if ln.startswith("RESULT "):
                    records.append(json.loads(ln[7:]))
                    print(ln[7:], flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "kernel_variants.json").write_text(
        json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
