"""Synthetic related genomes and sketch databases, made from a seed.

Random bit-planes make every pair unrelated (every core/accessory
regression then takes its no-fit branch), so the inputs here are related:
assemblies are mutated copies of a few ancestors, and derived databases
re-draw each bin of a parent sketch with a probability that rises with k,
as a real divergence does.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from sketchtpu.constants import BBITS

_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def related_assemblies(out_dir, n: int, length: int, seed: int,
                       n_ancestors: int = 2, divergence=(0.001, 0.05),
                       max_contigs: int = 40) -> Path:
    """Write n FASTA assemblies of about `length` bases and an rfile
    (name<TAB>path per line) listing them; returns the rfile's path.

    Sample i copies ancestor i % n_ancestors with substitutions at a
    divergence from `divergence` (log-spaced over the samples), a few
    replaced blocks (accessory sequence) of a size that grows with it,
    1-4 runs of N, and 1-max_contigs contigs."""
    out_dir = Path(out_dir).resolve()
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    ancestors = [rng.integers(0, 4, length, dtype=np.uint8)
                 for _ in range(n_ancestors)]
    divs = np.geomspace(divergence[0], divergence[1], n)
    lines = []
    for i in range(n):
        seq = ancestors[i % n_ancestors].copy()
        mut = rng.random(length) < divs[i]
        seq[mut] = (seq[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        for _ in range(int(rng.integers(1, 6))):
            blen = max(1, int(length * divs[i] * rng.uniform(0.2, 1.0)))
            start = int(rng.integers(0, max(1, length - blen)))
            seq[start : start + blen] = rng.integers(0, 4, blen, dtype=np.uint8)
        text = _ACGT[seq]
        for _ in range(int(rng.integers(1, 5))):
            run = int(rng.integers(10, 100))
            start = int(rng.integers(0, max(1, length - run)))
            text[start : start + run] = ord("N")
        n_contigs = int(rng.integers(1, max_contigs + 1))
        cuts = np.sort(rng.choice(np.arange(1, length), n_contigs - 1,
                                  replace=False))
        bounds = [0, *cuts.tolist(), length]
        name = f"sample_{i:02d}"
        path = out_dir / f"{name}.fa"
        with open(path, "wb") as f:
            for c in range(n_contigs):
                contig = text[bounds[c] : bounds[c + 1]].tobytes()
                f.write(f">{name}_contig{c + 1}\n".encode())
                for p in range(0, len(contig), 80):
                    f.write(contig[p : p + 80] + b"\n")
        lines.append(f"{name}\t{path}\n")
    rfile = out_dir / "rfile.txt"
    rfile.write_text("".join(lines))
    return rfile


def random_streams(lengths, seed: int, breaks_per_mb: int = 10):
    """DnaStreams of random bases with the given lengths and random breaks
    (record ends and N runs, about breaks_per_mb per Mb), as
    read_dna_sample would give for real assemblies."""
    from sketchtpu.ingest.fastx import DnaStream

    rng = np.random.default_rng(seed)
    out = []
    for n in lengths:
        codes = rng.integers(0, 4, n, dtype=np.uint8)
        n_breaks = max(1, n * breaks_per_mb // 1_000_000)
        breaks = np.unique(np.append(rng.integers(1, n, n_breaks), n))
        out.append(DnaStream(codes=codes, breaks=breaks.astype(np.int64),
                             acgt=np.bincount(codes, minlength=4)))
    return out


def derive_words(parents: np.ndarray, n: int, kmers, seed: int,
                 divergence=(0.001, 0.05)) -> np.ndarray:
    """(n, nk, s64, BBITS) u64 sketch words of n samples derived from
    `parents` (P, nk, s64, BBITS): sample i copies parent i % P and re-draws
    each bin's sign at k with probability 1 - (1 - d_i)^k (the chance that
    a k-mer holds a mutation at divergence d_i, log-spaced over the
    samples in random order)."""
    rng = np.random.default_rng(seed)
    n_par, nk, s64, _ = parents.shape
    d = rng.permutation(np.geomspace(divergence[0], divergence[1], n))
    out = np.empty((n, nk, s64, BBITS), dtype=np.uint64)
    src = np.arange(n) % n_par
    for ki, k in enumerate(kmers):
        p = 1.0 - (1.0 - d) ** k
        redraw = rng.random((n, s64, 64)) < p[:, None, None]
        mask = np.packbits(redraw, axis=-1, bitorder="little")
        mask = mask.view(np.uint64).reshape(n, s64, 1)
        fresh = rng.integers(0, 2**64, (n, s64, BBITS), dtype=np.uint64)
        out[:, ki] = (parents[src, ki] & ~mask) | (fresh & mask)
    return out


def derive_database(parent_prefix: str, out_prefix: str, n: int,
                    seed: int) -> None:
    """Write out_prefix.skd/.skm: n samples derived (derive_words) from the
    sketches of parent_prefix, through sketchtpu.formats."""
    from sketchtpu.formats.skd import SketchDataWriter
    from sketchtpu.formats.skm import MultiSketch
    from sketchtpu.sketchcore.sketch import Sketch

    ms = MultiSketch.load_metadata(parent_prefix)
    ms.read_sketch_data(parent_prefix)
    n_par = ms.number_samples_loaded()
    nk = len(ms.kmer_lengths)
    parents = ms.sketch_bins.reshape(n_par, nk, ms.sketchsize64, BBITS)
    words = derive_words(parents, n, ms.kmer_lengths, seed)
    sketches = []
    with SketchDataWriter(f"{out_prefix}.skd") as writer:
        for i in range(n):
            meta = ms.sketch_metadata[i % n_par]
            sketches.append(Sketch(
                name=f"derived_{i:05d}",
                index=writer.write_sketch(words[i].reshape(-1)),
                rc=meta.rc,
                reads=False,
                seq_length=meta.seq_length,
                densified=meta.densified,
                acgt=meta.acgt,
                non_acgt=meta.non_acgt,
            ))
    MultiSketch(sketches, ms.sketch_size, ms.kmer_lengths,
                ms.hash_type).save_metadata(out_prefix)
