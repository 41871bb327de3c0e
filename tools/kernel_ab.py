#!/usr/bin/env python3
"""signeq's count / any / all and aahash_bin_multi of two checkouts, timed
in turns on one NVIDIA GPU.

    python3 tools/kernel_ab.py OTHER_ROOT     # from the root of a checkout

OTHER_ROOT is another checkout of the repository (for example the parent
commit unpacked with `git archive`). Each checkout builds its own kernels
and runs in a process of its own, in the turns other, this, this, other:
signeq in every mode with 1, 8 and 101 queries against chip_smoke.py's
661,000-row index at S = 100 (each held against its twin first), and
aahash_bin_multi at chip_smoke.py's phase 2 shape (16 x 1.2 M residues,
k = 6, 9, 12, 1024 bins), then K2 (plain, and masked key mode) and K3's
masked selection at phase 2's shapes through each checkout's own
chip_smoke.py phase 2 functions. Each checkout's aaHash kernel also reports its
registers and its SASS atomics, and its SASS goes to
chiprun_out/kernel_ab_<turn>_aahash.sass. Prints one JSON line per
measurement and writes them all to chiprun_out/kernel_ab.json.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def measure(root: Path, label: str) -> list:
    """Times of the checkout at root, with its own chip_smoke helpers."""
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import chip_smoke as C
    from sketchtpu_torch import _build
    from sketchtpu_torch.hash.aahash_torch import (
        aahash_bin_multi,
        aahash_bin_multi_ref,
        pack_aa_group,
    )
    from sketchtpu_torch.inverted.device import pack_signs, signeq, signeq_ref

    lib_path = _build.build()
    gpu = torch.cuda.get_device_name(0)
    out = []
    regs = C.ptxas_report(lib_path, "aahash_multi_kernel",
                          {"ILb0E": "multiply-high", "ILb1E": "shift",
                           "aahash_multi_kernelEPKh": "one mode"})
    atoms = {}
    for name, ops in C.sass_counts(lib_path, "aahash_multi_kernel").items():
        atoms[name[-30:]] = {k: v for k, v in ops.items()
                             if k.startswith(("ATOMS", "RED"))}
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    text = C.run([str(cuobjdump), "-sass", str(lib_path)])
    dump = "".join(body for body in text.split("Function : ")[1:]
                   if "aahash_multi_kernel" in body.split("\n", 1)[0])
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / f"kernel_ab_{label}_aahash.sass").write_text(dump)
    out.append(dict(tree=label, kernel="aahash_bin_multi", registers=regs,
                    sass_atomics=atoms, gpu=gpu))
    sig = C.index_signs(C.N_INDEX, C.SEED + 6)
    m = pack_signs(sig, "cuda")
    rng = np.random.default_rng(C.SEED)
    for nq in (1, 8, 101):
        q = pack_signs(sig[rng.choice(C.N_INDEX, nq, replace=False)], "cuda")
        for mode in ("count", "any", "all"):
            if not torch.equal(signeq(q, m, C.INDEX_SIZE, mode),
                               signeq_ref(q, m, C.INDEX_SIZE, mode)):
                raise SystemExit(f"{label}: signeq {mode} != twin")
            ms = C.cuda_ms(lambda: signeq(q, m, C.INDEX_SIZE, mode), reps=20)
            out.append(dict(tree=label, kernel=f"signeq_{mode}",
                            shape=f"({nq}, 661000), S = 100", ms=ms, gpu=gpu))
    del m
    codes, starts = pack_aa_group(C.aa_streams(C.AA_SAMPLES, C.AA_RESIDUES,
                                               C.SEED))
    cd, sd = torch.from_numpy(codes).cuda(), torch.from_numpy(starts).cuda()
    got = aahash_bin_multi(cd, C.AA_KMERS, 1, sd, 1024)
    want = aahash_bin_multi_ref(cd, C.AA_KMERS, 1, sd, 1024)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise SystemExit(f"{label}: aahash_bin_multi != twin")
    ms = C.cuda_ms(lambda: aahash_bin_multi(cd, C.AA_KMERS, 1, sd, 1024),
                   reps=20)
    out.append(dict(tree=label, kernel="aahash_bin_multi",
                    shape="16 x 1.2 M aa, k 6, 9, 12, 1024 bins", ms=ms,
                    gpu=gpu))
    del cd, sd, got, want
    # K2 (plain, key and masked key mode) and K3's masked selection at
    # phase 2's shapes, each held against its twin there first
    results: dict = {}
    words = C.derived_words(16384, C.SEED)
    C.phase2_coreacc(words, results, lib_path)
    C.phase2_knn_masked(words, results, lib_path)
    C.phase2_coreacc_masked(words, results)
    for kernel, shape in (("coreacc", "plain, nk 7, 2048 x 16384"),
                          ("knn_select_masked", "2048 x 8192, S = 1000"),
                          ("coreacc_keys_masked",
                           "2048 x 8192, nk 7, S = 1000")):
        out.append(dict(tree=label, kernel=kernel, shape=shape,
                        ms=results[kernel]["ms"], gpu=gpu))
    return out


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--measure":
        for rec in measure(Path(sys.argv[2]).resolve(), sys.argv[3]):
            print("RESULT " + json.dumps(rec), flush=True)
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    other = Path(sys.argv[1]).resolve()
    records = []
    for turn, root in enumerate((other, ROOT, ROOT, other), 1):
        label = f"{turn}_{'this' if root == ROOT else 'other'}"
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--measure",
             str(root), label],
            capture_output=True, text=True, cwd=root)
        if proc.returncode:
            print(proc.stdout[-2000:], proc.stderr[-4000:])
            return 1
        for ln in proc.stdout.splitlines():
            if ln.startswith("RESULT "):
                records.append(json.loads(ln[7:]))
                print(ln[7:], flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "kernel_ab.json").write_text(
        json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
