#!/usr/bin/env python3
"""Design variants of the port's kernels, timed on one NVIDIA GPU.

    python3 tools/kernel_variants.py         # from the root of a checkout

Each variant is a patched copy of sketchtpu_torch/csrc (the shipped
sources with a few text substitutions, and where a variant needs it a
launch setting of the Python wrapper), built with the port's own nvcc
flags into kernel_variants_work/<variant>/ and loaded in a process of its
own. The variants, against the shipped design:
- signs_run32, signs_run64: the signs kernel (nthash_signs) with runs of
  32 or 64 window starts a thread instead of 16;
- pair_xor: pair_count with the XOR / IADD / LOP3 compare of signeq.cuh
  (AnyEq) in place of the DPX one, in the same tile, ring and resident
  row tile;
- count_swar: signeq's count mode with the six-operation SWAR compare
  (x = q ^ m; ~(((x & 0x7FFF7FFF) + 0x7FFF7FFF) | x) & 0x80008000 a word)
  in place of two DPX VIADDMNMX and an IADD3 per two words;
- signeq_rpt2, signeq_cap8: the 16-query group with two index rows a
  thread instead of four, or with stages of 8 words instead of 12;
- aa_lb4: the aaHash kernel's shift mode capped at 64 registers (4 blocks
  an SM) instead of 48 (5);
- aa_kg1: one k a pass (k as the outer loop, as the parent design rolled
  it) instead of up to four chains;
- aa_runs124: runs of up to 124 starts (one tile a block at phase 2's
  shape) instead of 60;
- pf_subs256: the prefilter's keep block splits a bucket by 8 more key
  bits (256 groups) instead of 11;
- pf_ballots: that split finds a window's peers by one ballot a digit
  bit instead of __match_any_sync;
- pf_tile4096: the prefilter's partition passes stage tiles of 4096
  windows (three blocks an SM) instead of 8192 (two).
Each variant is held against the plain twin, then timed by CUDA events in
turns (every variant once, then again) on the kernels it changes:
nthash_signs over the reads path's chunk (4,793,490 window starts x 7 k)
of a stream that fills it, and of chip_smoke.py's 2 Mb stream; pair_count
on rows [0, 8192) of chip_smoke.py's 661,000-row index at S = 100; signeq
count / any / all with 1, 8 and 101 queries against that index; and
aahash_bin_multi at chip_smoke.py's phase 2 shape (16 x 1.2 M residues,
k = 6, 9, 12, 1024 bins); and the prefilter's step (sign_prefilter_flags)
on a 2^24-window segment and a whole 50 M-window row of reads of a 2 Mb
genome at 25x (tools/kernel_ab.py's row; k = 17, --min-count 5, 1024
bins). Prints one JSON line per measurement and writes them all to
kernel_variants.json in the output directory. Kernel names as arguments
(nthash_signs, pair_count, signeq, aahash, prefilter) keep the variants
of those alone:

    python3 tools/kernel_variants.py prefilter
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
# the query staged as stored, its odd-S pad half and pad words never equal
COUNT_SWAR = [
    ("  if (w >= words) return MODE == ANY ? 0x00010001u : 0u;",
     "  if (w >= words) return MODE == ANY ? 0x00010001u\n"
     "                       : MODE == COUNT ? 0xFFFFFFFFu : 0u;"),
    ("  if (MODE == ALL) return pad ? v & 0xFFFFu : v;",
     "  if (MODE == ALL) return pad ? v & 0xFFFFu : v;\n"
     "  if (MODE == COUNT) return pad ? v | 0xFFFF0000u : v;"),
    ("""    acc += __viaddmin_u16x2(q.x, m.x, 0x00010001u) +
           __viaddmin_u16x2(q.y, m.y, 0x00010001u);
    acc += __viaddmin_u16x2(q.z, m.z, 0x00010001u) +
           __viaddmin_u16x2(q.w, m.w, 0x00010001u);""",
     """    const unsigned x[4] = {q.x ^ m.x, q.y ^ m.y, q.z ^ m.z, q.w ^ m.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      acc += (~(((x[i] & 0x7FFF7FFFu) + 0x7FFF7FFFu) | x[i]) &
              0x80008000u) >> 15;"""),
    ("                2 * words - (int)((a & 0xFFFFu) + (a >> 16));",
     "                (int)((a & 0xFFFFu) + (a >> 16));"),
]
ROWS = "  return QR >= 16 ? 4 : 1;"
LMAX = "  const int lmax = room < 12 ? 4 : (room - 4) / 8 * 8 + 4;"
AA_BLOCKS = "  return POW2 ? 5 : 4;"
AA_KG = "constexpr int KG = 4;       // k rolled together"
SIGNS = ("nthash_signs",)
PF_ROUNDS = ("constexpr int ROUNDS = 32;", "constexpr int ROUNDS = 16;")
PF_SCATTER_LB = ("__global__ void __launch_bounds__(PT, 2) pf_scatter(",
                 "__global__ void __launch_bounds__(PT, 3) pf_scatter(")
PF = ("prefilter",)
# name: patches of csrc files, the wrapper settings, the kernels timed
VARIANTS = {
    "shipped": ({}, {}, ("nthash_signs", "pair_count", "signeq", "aahash",
                         "prefilter")),
    "signs_run32": ({"nthash_bin.cu": [(SIGNS_LG[0], SIGNS_LG[1].format(5))]},
                    {"signs_lg": 5}, SIGNS),
    "signs_run64": ({"nthash_bin.cu": [(SIGNS_LG[0], SIGNS_LG[1].format(6))]},
                    {"signs_lg": 6}, SIGNS),
    "pair_xor": ({"signeq.cu": PAIR_XOR}, {}, ("pair_count",)),
    "count_swar": ({"signeq.cu": COUNT_SWAR}, {}, ("signeq",)),
    "signeq_rpt2": ({"signeq.cu": [(ROWS, ROWS.replace("4 : 1", "2 : 1"))]},
                    {}, ("signeq",)),
    "signeq_cap8": ({"signeq.cu": [(LMAX, "  const int lmax = qr >= 16 ? 8 "
                                          ": (room < 12 ? 4 : (room - 4) / 8"
                                          " * 8 + 4);")]}, {}, ("signeq",)),
    "aa_lb4": ({"aahash_bin.cu": [(AA_BLOCKS, "  return 4;")]}, {},
               ("aahash",)),
    "aa_kg1": ({"aahash_bin.cu": [(AA_KG, AA_KG.replace("4;", "1;"))]},
               {"aa_kg": 1}, ("aahash",)),
    "aa_runs124": ({}, {"aa_runs": tuple(range(4, 125, 8))}, ("aahash",)),
    "pf_subs256": ({"sign_prefilter.cu": [("constexpr int SUB_BITS = 11;",
                                           "constexpr int SUB_BITS = 8;")]},
                   {}, PF),
    "pf_ballots": ({"sign_prefilter.cu": [(
        "    const u32 peers = __match_any_sync(FULL, d);",
        "    const u32 peers = peers_of(d, SUB_BITS);")]}, {}, PF),
    "pf_tile4096": ({"sign_prefilter.cu": [PF_ROUNDS, PF_SCATTER_LB]},
                    {"pf_tile": 4096}, PF),
}


def prepare(name: str) -> Path:
    """The variant's patched csrc; fails if a patch does not apply."""
    patches = VARIANTS[name][0]
    d = WORK / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(ROOT / "sketchtpu_torch" / "csrc", d / "csrc")
    for fname, subs in patches.items():
        path = d / "csrc" / fname
        text = path.read_text()
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"{name}: patch does not apply: {old}")
            text = text.replace(old, new)
        path.write_text(text)
    return d


def use(name: str):
    """Point the port's builder and wrappers at the variant and build it."""
    from sketchtpu_torch import _build
    from sketchtpu_torch.hash import aahash_torch, nthash_torch
    from sketchtpu_torch.sketchcore import sign_prefilter

    settings = VARIANTS[name][1]
    d = WORK / name
    _build.CSRC, _build.BUILD_DIR = d / "csrc", d / "build"
    sign_prefilter.TILE = settings.get("pf_tile", sign_prefilter.TILE)
    nthash_torch._SIGNS_RUN_LG = settings.get("signs_lg", 4)
    aahash_torch._KG = settings.get("aa_kg", aahash_torch._KG)
    aahash_torch._RUNS = settings.get("aa_runs", aahash_torch._RUNS)
    _build.build()
    return _build


def measure(name: str, rep: int, only=()) -> list:
    import numpy as np
    import torch

    import chip_smoke as C

    use(name)
    gpu = torch.cuda.get_device_name(0)
    kernels = [k for k in VARIANTS[name][2] if not only or k in only]
    out = []

    def record(kernel, shape, ms, **extra):
        out.append(dict(variant=name, rep=rep, kernel=kernel, shape=shape,
                        ms=ms, gpu=gpu, **extra))

    if "nthash_signs" in kernels:
        from sketchtpu_torch.hash.nthash_torch import (
            nthash_signs,
            nthash_signs_ref,
            pack_group,
        )
        from sketchtpu_torch.sketchcore.sketch_torch import _READ_CHUNK_SIGNS

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
            record("nthash_signs", f"{own} starts x 7 k, {label}", ms)
    if "pair_count" in kernels or "signeq" in kernels:
        from sketchtpu_torch.inverted.device import (
            pack_signs,
            pair_count,
            pair_count_ref,
            signeq,
            signeq_ref,
        )

        sig = C.index_signs(C.N_INDEX, C.SEED + 6)
        m = pack_signs(sig, "cuda")
    if "pair_count" in kernels:
        got = pair_count(m, C.INDEX_SIZE, 0, 8192)
        if rep == 0 and got != pair_count_ref(m, C.INDEX_SIZE, 0, 8192,
                                              tile=2048):
            raise SystemExit(f"{name}: pair_count != twin")
        ms = C.cuda_ms(lambda: pair_count(m, C.INDEX_SIZE, 0, 8192), reps=5)
        record("pair_count", "rows [0, 8192) x 661000, S = 100", ms,
               pairs_sharing=got)
    if "signeq" in kernels:
        rng = np.random.default_rng(C.SEED)
        for nq in (1, 8, 101):
            q = pack_signs(sig[rng.choice(C.N_INDEX, nq, replace=False)],
                           "cuda")
            for mode in ("count", "any", "all"):
                if not torch.equal(signeq(q, m, C.INDEX_SIZE, mode),
                                   signeq_ref(q, m, C.INDEX_SIZE, mode)):
                    raise SystemExit(f"{name}: signeq {mode} != twin")
                ms = C.cuda_ms(lambda: signeq(q, m, C.INDEX_SIZE, mode),
                               reps=20)
                record(f"signeq_{mode}", f"({nq}, 661000), S = 100", ms)
    if "aahash" in kernels:
        from sketchtpu_torch.hash.aahash_torch import (
            aahash_bin_multi,
            aahash_bin_multi_ref,
            pack_aa_group,
        )

        codes, starts = pack_aa_group(C.aa_streams(C.AA_SAMPLES,
                                                   C.AA_RESIDUES, C.SEED))
        cd, sd = torch.from_numpy(codes).cuda(), torch.from_numpy(starts).cuda()
        got = aahash_bin_multi(cd, C.AA_KMERS, 1, sd, 1024)
        want = aahash_bin_multi_ref(cd, C.AA_KMERS, 1, sd, 1024)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise SystemExit(f"{name}: aahash_bin_multi != twin")
        del want
        ms = C.cuda_ms(lambda: aahash_bin_multi(cd, C.AA_KMERS, 1, sd, 1024),
                       reps=20)
        record("aahash_bin_multi", "16 x 1.2 M aa, k 6, 9, 12, 1024 bins", ms)
    if "prefilter" in kernels:
        sys.path.insert(0, str(ROOT / "tools"))
        from kernel_ab import PF_BINS, PF_MIN_COUNT, reads_row

        from sketchtpu_torch.sketchcore import sign_prefilter as sp

        row = reads_row("cuda")
        for label, part in (("2^24-window segment", row[: 1 << 24]),
                            (f"whole row, {row.numel()} windows", row)):
            got = sp.sign_prefilter_flags(part, PF_BINS, PF_MIN_COUNT)
            if not torch.equal(got, sp.sign_prefilter_flags_ref(
                    part, PF_BINS, PF_MIN_COUNT)):
                raise SystemExit(f"{name}: sign_prefilter != twin ({label})")
            ms = C.cuda_ms(lambda: sp.sign_prefilter_flags(
                part, PF_BINS, PF_MIN_COUNT), reps=10)
            record("sign_prefilter", f"{label}, k 17, --min-count 5, 1024 "
                   f"bins", ms)
    return out


def main() -> int:
    if len(sys.argv) >= 4 and sys.argv[1] == "--measure":
        for rec in measure(sys.argv[2], int(sys.argv[3]), sys.argv[4:]):
            print("RESULT " + json.dumps(rec), flush=True)
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--build":
        use(sys.argv[2])
        return 0
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    only = sys.argv[1:]
    names = [n for n in VARIANTS
             if not only or set(VARIANTS[n][2]) & set(only)]
    for name in names:
        prepare(name)
    builds = [subprocess.Popen([sys.executable, __file__, "--build", name])
              for name in names]
    if any(p.wait() for p in builds):
        return 1
    records = []
    for rep in range(2):
        for name in names:
            proc = subprocess.run(
                [sys.executable, __file__, "--measure", name, str(rep),
                 *only], capture_output=True, text=True, cwd=ROOT)
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
