#!/usr/bin/env python3
"""signeq's count / any / all, aahash_bin_multi, K1 / K4, K2, K3's masked
selection and the reads prefilter's step of two checkouts, timed in turns
on one NVIDIA GPU.

    python3 tools/kernel_ab.py OTHER_ROOT [GROUP ...]   # from a checkout

OTHER_ROOT is another checkout of the repository (for example the parent
commit unpacked with `git archive`). Each checkout builds its own kernels
and runs in a process of its own, in the turns other, this, this, other.
The groups (all by default):
- signeq: every mode with 1, 8 and 101 queries against chip_smoke.py's
  661,000-row index at S = 100 (each held against its twin first);
- aahash: aahash_bin_multi at chip_smoke.py's phase 2 shape (16 x 1.2 M
  residues, k = 6, 9, 12, 1024 bins), its registers and SASS atomics (the
  SASS to kernel_ab_<turn>_aahash.sass in the output directory);
- samebits: K1 (the int16 strip) and K4 at phase 2's shapes through each
  checkout's own chip_smoke.py phase2_samebits, and the -Xptxas -v
  registers, static shared memory and spills of every instantiation of
  the samebits and core/accessory kernels;
- coreacc: K2 (plain, and masked key mode) and K3's masked selection at
  phase 2's shapes through each checkout's own chip_smoke.py functions,
  then K2's key mode at phase 2's kNN tile and coreacc_chain over a 2 x 2
  lead's two (7, 2048, 4096) slabs (phase 2's words shape) through its
  modules;
- prefilter: the reads prefilter's step, one row of signs to its keep
  flags (sign_prefilter.keep_flags), and with the gather
  (prefilter_signs), on a 2^24-window segment and a whole 50 M-window row
  of reads of a 2 Mb genome at 25x (k = 17, --min-count 5, 1024 bins),
  each held against the twin first, with the peak memory of one step;
  then `sketch` of chip_smoke.py phase 6's reads (2 x 50 Mb at 25x, 7 k,
  --min-count 5, written once by this checkout) with the prefilter on
  through the checkout's own CLI: its peak device memory allocated.
Prints one JSON line per measurement and writes them all to
kernel_ab.json in the output directory beside the checkout's root.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


GROUPS = ("signeq", "aahash", "samebits", "coreacc", "prefilter")
PF_GENOME, PF_COVERAGE = 2_000_000, 25
PF_K, PF_MIN_COUNT, PF_BINS = 17, 5, 1024


def reads_row(device):
    """The signs at k = PF_K of every window of 150 bp reads (half
    reverse-complemented) of a random 2 Mb genome at 25x: 50 M windows."""
    import numpy as np
    import torch

    from sketchtpu_torch.hash.nthash_torch import nthash_signs, pack_group
    from sketchtpu_torch.ingest.fastx import DnaStream

    rng = np.random.default_rng(20261017)
    genome = rng.integers(0, 4, PF_GENOME).astype(np.uint8)
    n_reads = PF_GENOME * PF_COVERAGE // 150
    starts = rng.integers(0, PF_GENOME - 150, n_reads)
    reads = genome[starts[:, None] + np.arange(150)]
    flip = rng.random(n_reads) < 0.5
    reads[flip] = 3 - reads[flip][:, ::-1]
    stream = DnaStream(codes=reads.reshape(-1),
                       breaks=np.arange(1, n_reads + 1, dtype=np.int64) * 150,
                       reads=True)
    seq = torch.from_numpy(pack_group([stream])[0]).to(device)
    return nthash_signs(seq, [PF_K], True)[0]


def measure_prefilter(C, label: str, gpu: str) -> list:
    """The prefilter's step and the step with its gather, on a 2^24-window
    segment and the whole row, in the checkout's own API."""
    import torch

    from sketchtpu_torch.sketchcore import sign_prefilter as sp

    row = reads_row("cuda")
    out = []
    for what, part in (("2^24-window segment", row[: 1 << 24]),
                       (f"whole row, {row.numel()} windows", row)):
        rows = part.view(1, -1)
        want = sp.sign_prefilter_keep_ref(*sp.sorted_keys(part, PF_BINS),
                                          PF_MIN_COUNT, PF_BINS)
        if not torch.equal(sp.keep_flags(rows, PF_BINS, PF_MIN_COUNT)[0],
                           want):
            raise SystemExit(f"{label}: prefilter {what} != twin")
        del want
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        sp.keep_flags(rows, PF_BINS, PF_MIN_COUNT)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        ms = C.cuda_ms(lambda: sp.keep_flags(rows, PF_BINS, PF_MIN_COUNT),
                       reps=10)
        gather_ms = C.cuda_ms(
            lambda: sp.prefilter_signs(part, PF_BINS, PF_MIN_COUNT), reps=5)
        out.append(dict(tree=label, kernel="prefilter step",
                        shape=f"{what}, k {PF_K}, --min-count "
                        f"{PF_MIN_COUNT}, {PF_BINS} bins", ms=ms,
                        with_gather_ms=gather_ms, peak_mib=peak / 2**20,
                        gpu=gpu))
    del row, part, rows
    rfile = os.environ.get("KERNEL_AB_READS")
    if rfile:
        import tempfile

        from sketchtpu_torch.cli import main as cli_main

        os.environ["SKETCHTPU_FASTQ_PREFILTER"] = "1"
        prefix = Path(tempfile.mkdtemp()) / "reads"
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        rc = cli_main(["sketch", "-f", rfile, "-o", str(prefix), "-k",
                       ",".join(map(str, C.KMERS)), "-s", "1000",
                       "--min-count", "5", "--threads", C.THREADS,
                       "--quiet"])
        wall = time.time() - t0
        if rc:
            raise SystemExit(f"{label}: sketch of the reads failed")
        out.append(dict(tree=label, kernel="sketch reads, prefilter on",
                        shape="2 x 50 Mb of reads x 7 k, --min-count 5",
                        wall_s=wall, peak_gib=torch.cuda.max_memory_allocated()
                        / 2**30, gpu=gpu))
    return out


def measure_aahash(C, label: str, gpu: str, lib_path) -> list:
    """aahash_bin_multi's registers, SASS atomics and time."""
    import torch

    from sketchtpu_torch import _build
    from sketchtpu_torch.hash.aahash_torch import (
        aahash_bin_multi,
        aahash_bin_multi_ref,
        pack_aa_group,
    )

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
    out = [dict(tree=label, kernel="aahash_bin_multi", registers=regs,
                sass_atomics=atoms, gpu=gpu)]
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
    return out


def measure_signeq(C, label: str, gpu: str) -> list:
    """signeq in every mode at 1, 8 and 101 queries."""
    import numpy as np
    import torch

    from sketchtpu_torch.inverted.device import pack_signs, signeq, signeq_ref

    sig = C.index_signs(C.N_INDEX, C.SEED + 6)
    m = pack_signs(sig, "cuda")
    rng = np.random.default_rng(C.SEED)
    out = []
    for nq in (1, 8, 101):
        q = pack_signs(sig[rng.choice(C.N_INDEX, nq, replace=False)], "cuda")
        for mode in ("count", "any", "all"):
            if not torch.equal(signeq(q, m, C.INDEX_SIZE, mode),
                               signeq_ref(q, m, C.INDEX_SIZE, mode)):
                raise SystemExit(f"{label}: signeq {mode} != twin")
            ms = C.cuda_ms(lambda: signeq(q, m, C.INDEX_SIZE, mode), reps=20)
            out.append(dict(tree=label, kernel=f"signeq_{mode}",
                            shape=f"({nq}, 661000), S = 100", ms=ms, gpu=gpu))
    return out


def measure_coreacc(C, label: str, gpu: str, lib_path) -> list:
    """K2 (plain, key and masked key mode) and K3's masked selection at
    phase 2's shapes, each held against its twin there first; K2's key
    mode and coreacc_chain (held against their twins in phase 2) timed
    alone."""
    from sketchtpu_torch.dist.coreacc_kernels import (
        coreacc_chain,
        coreacc_keys,
    )
    from sketchtpu_torch.dist.samebits_kernels import samebits_stack
    from sketchtpu_torch.shard.mesh import word_ranges

    results: dict = {}
    words = C.derived_words(16384, C.SEED)
    C.phase2_coreacc(words, results, lib_path)
    C.phase2_knn_masked(words, results, lib_path)
    C.phase2_coreacc_masked(words, results)
    a, bk = words[4096:6144], words[:8192]
    kw = dict(row0=4096, col0=0, nb_real=words.shape[0], exclude_self=True)
    results["coreacc_keys"] = {"ms": C.cuda_ms(lambda: coreacc_keys(
        a, bk, C.KMERS, C.S64 * 64, **kw), reps=10)}
    del words, a, bk
    w = C.device_words(C.N_WORDS, C.S64_WORDS, C.SEED + 4)
    na = C.N_WORDS // 2
    slabs = [samebits_stack(w[:na, :, r], w[:, :, r])
             for r in word_ranges(C.S64_WORDS, 2)]
    del w
    results["coreacc_chain"] = {"ms": C.cuda_ms(lambda: coreacc_chain(
        slabs, C.KMERS, C.S64_WORDS * 64, C.S64_WORDS), reps=10)}
    return [dict(tree=label, kernel=kernel, shape=shape,
                 ms=results[kernel]["ms"], gpu=gpu)
            for kernel, shape in (("coreacc", "plain, nk 7, 2048 x 16384"),
                                  ("coreacc_keys", "nk 7, 2048 x 8192"),
                                  ("knn_select_masked",
                                   "2048 x 8192, S = 1000"),
                                  ("coreacc_keys_masked",
                                   "2048 x 8192, nk 7, S = 1000"),
                                  ("coreacc_chain",
                                   "2 slabs (7, 2048, 4096)"))]


def ptxas_records(lib_path, label: str, gpu: str) -> list:
    """Registers, static shared memory and spill stores of every samebits
    and core/accessory kernel instantiation, from the build's -Xptxas -v
    log."""
    lines = lib_path.with_suffix(".log").read_text().splitlines()
    out = []
    for i, ln in enumerate(lines):
        if "Compiling entry" in ln and ("samebits_kernel" in ln
                                        or "coreacc_" in ln):
            text = " ".join(lines[i + 1 : i + 4])
            smem = text.split(" bytes smem")[0].split()[-1] \
                if " bytes smem" in text else "0"
            out.append(dict(
                tree=label, ptxas=ln.split("'")[1],
                registers=int(text.split("Used ")[1].split(" registers")[0]),
                smem_bytes=int(smem),
                spill_store_bytes=int(text.split("bytes stack frame, ")[1]
                                      .split(" bytes spill")[0]),
                gpu=gpu))
    return out


def measure_samebits(C, label: str, gpu: str, lib_path) -> list:
    """K1 (i) and K4 (iii) at phase 2's shapes (every entry held against
    its twin there first), and the kernels' ptxas records."""
    results: dict = {}
    words = C.derived_words(16384, C.SEED)
    big = C.derived_words(C.N_KNN, C.SEED + 2, kmers=(17,))[:, 0]
    C.phase2_samebits(words, big, results, lib_path)
    return [dict(tree=label, kernel=kernel, shape=shape,
                 ms=results[kernel]["ms"], gpu=gpu)
            for kernel, shape in (
                ("samebits", "(i) int16 tri row0 4096, 2048 x 16384"),
                ("samebits_full", "(iii) 2048 x 16384"))] \
        + ptxas_records(lib_path, label, gpu)


def measure(root: Path, label: str, groups) -> list:
    """Times of the checkout at root, with its own chip_smoke helpers."""
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as C
    from sketchtpu_torch import _build

    lib_path = _build.build()
    gpu = torch.cuda.get_device_name(0)
    out = []
    if "aahash" in groups:
        out += measure_aahash(C, label, gpu, lib_path)
    if "signeq" in groups:
        out += measure_signeq(C, label, gpu)
    if "samebits" in groups:
        out += measure_samebits(C, label, gpu, lib_path)
    if "coreacc" in groups:
        out += measure_coreacc(C, label, gpu, lib_path)
    if "prefilter" in groups:
        out += measure_prefilter(C, label, gpu)
    return out


def main() -> int:
    if len(sys.argv) >= 4 and sys.argv[1] == "--measure":
        for rec in measure(Path(sys.argv[2]).resolve(), sys.argv[3],
                           sys.argv[4:]):
            print("RESULT " + json.dumps(rec), flush=True)
        return 0
    groups = sys.argv[2:] or list(GROUPS)
    if len(sys.argv) < 2 or any(g not in GROUPS for g in groups):
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    other = Path(sys.argv[1]).resolve()
    if "prefilter" in groups:
        sys.path.insert(0, str(ROOT))
        import chip_smoke

        chip_smoke.WORK.mkdir(exist_ok=True)
        os.environ["KERNEL_AB_READS"] = str(chip_smoke.phase6_reads_files())
    records = []
    for turn, root in enumerate((other, ROOT, ROOT, other), 1):
        label = f"{turn}_{'this' if root == ROOT else 'other'}"
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--measure",
             str(root), label, *groups],
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
