"""Synthetic related genomes, proteomes and sketch databases, made from a
seed.

Random bit-planes make every pair unrelated (every core/accessory
regression then takes its no-fit branch), so the inputs here are related:
assemblies are mutated copies of a few ancestors, and derived databases
re-draw each bin of a parent sketch with a probability that rises with k,
as a real divergence does.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .constants import BBITS

_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
_AA = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)


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


def related_proteomes(out_dir, n: int, n_records: int, record_len: int,
                      seed: int, n_ancestors: int = 2,
                      divergence=(0.001, 0.05), invalid: float = 0.001,
                      gzipped: bool = False) -> Path:
    """Write n protein FASTAs (proteomes of n_records records of about
    record_len residues) and an rfile listing them; returns its path.

    Sample i copies ancestor i % n_ancestors with substitutions at a
    divergence from `divergence` (log-spaced over the samples) and a few
    replaced blocks (accessory proteins). About 1 % of residues are written
    in lower case, and a share `invalid` of them as 'X' or '*' (invalid
    residues); records are cut at random lengths of about record_len / 2
    to 3 record_len / 2 (scaled to sum to the proteome) and wrapped at 60
    columns."""
    import gzip

    out_dir = Path(out_dir).resolve()
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    total = n_records * record_len
    ancestors = [rng.integers(0, 20, total, dtype=np.uint8)
                 for _ in range(n_ancestors)]
    divs = np.geomspace(divergence[0], divergence[1], n)
    lines = []
    for i in range(n):
        seq = ancestors[i % n_ancestors].copy()
        mut = rng.random(total) < divs[i]
        seq[mut] = (seq[mut] + rng.integers(1, 20, int(mut.sum()))) % 20
        for _ in range(int(rng.integers(1, 6))):
            blen = max(1, int(total * divs[i] * rng.uniform(0.2, 1.0)))
            start = int(rng.integers(0, max(1, total - blen)))
            seq[start : start + blen] = rng.integers(0, 20, blen,
                                                     dtype=np.uint8)
        text = _AA[seq]
        text[rng.random(total) < 0.01] += 32  # lower case
        bad = np.flatnonzero(rng.random(total) < invalid)
        text[bad] = np.where(rng.random(bad.size) < 0.5, ord("X"), ord("*"))
        lens = rng.integers(record_len // 2, record_len * 3 // 2 + 1,
                            n_records)
        ends = np.cumsum(lens) * total // int(lens.sum())  # ends[-1] = total
        name = f"proteome_{i:03d}"
        path = out_dir / f"{name}.faa{'.gz' if gzipped else ''}"
        out, start = [], 0
        for r, end in enumerate(ends.tolist()):
            rec = text[start:end].tobytes()
            out.append(b">%s_p%d\n" % (name.encode(), r + 1))
            out.extend(rec[p : p + 60] + b"\n" for p in range(0, len(rec), 60))
            start = end
        data = b"".join(out)
        if gzipped:
            data = gzip.compress(data, compresslevel=1)
        path.write_bytes(data)
        lines.append(f"{name}\t{path}\n")
    rfile = out_dir / "rfile.txt"
    rfile.write_text("".join(lines))
    return rfile


def random_streams(lengths, seed: int, breaks_per_mb: int = 10):
    """DnaStreams of random bases with the given lengths and random breaks
    (record ends and N runs, about breaks_per_mb per Mb), as
    read_dna_sample would give for real assemblies."""
    from .ingest.fastx import DnaStream

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
    sketches of parent_prefix."""
    from .formats.skd import SketchDataWriter
    from .formats.skm import MultiSketch
    from .sketchcore.sketch import Sketch

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


def write_fastq_gz(path, total: int, seed: int, read_len: int = 150,
                   coverage: int = 25, genome: np.ndarray | None = None):
    """Synthetic FASTQ.gz: `total` bases of `read_len` reads at `coverage`x
    off one genome (random from the seed unless given as 2-bit codes),
    every other read reverse-complemented, ~0.5 % substitutions, Q40."""
    import gzip

    rng = np.random.default_rng(seed)
    if genome is None:
        glen = max(total // coverage, read_len + 1)
        genome = rng.integers(0, 4, glen).astype(np.uint8)
    glen = genome.shape[0]
    n_reads = total // read_len
    qual = b"I" * read_len
    with gzip.open(path, "wb", compresslevel=1) as f:
        for i, s in enumerate(rng.integers(0, glen - read_len, n_reads)):
            seg = genome[s : s + read_len]
            if i % 2:
                seg = 3 - seg[::-1]
            err = rng.random(read_len) < 0.005
            if err.any():
                seg = seg.copy()
                seg[err] = (seg[err] + rng.integers(1, 4, int(err.sum()))) % 4
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, _ACGT[seg].tobytes(), qual))


def read_samples(out_dir, n: int, genome_len: int, coverage: int, seed: int,
                 paired: bool = False, read_len: int = 150) -> list[str]:
    """Write n read samples (FASTQ.gz at `coverage`x of their own random
    genome of genome_len bases; with `paired`, the reads split into two
    files) and return their rfile lines (name<TAB>path[<TAB>path])."""
    out_dir = Path(out_dir).resolve()
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        genome = rng.integers(0, 4, genome_len).astype(np.uint8)
        total = genome_len * coverage
        name = f"reads_{i:02d}{'_pe' if paired else ''}"
        paths = [out_dir / f"{name}_{e}.fq.gz" for e in ((1, 2) if paired
                                                         else (1,))]
        for e, path in enumerate(paths):
            write_fastq_gz(path, total // len(paths), seed * 1000 + 2 * i + e,
                           read_len, coverage, genome)
        lines.append("\t".join([name, *map(str, paths)]) + "\n")
    return lines


def derive_signs(n: int, sketch_size: int, n_clusters: int, seed: int,
                 redraw: float = 0.3) -> np.ndarray:
    """(n, sketch_size) u16 inverted-index signs of n samples in n_clusters
    independent clusters: sample i copies the random signs of cluster
    i % n_clusters and re-draws each bin with probability `redraw`. Pairs
    of one cluster share most bins; pairs of two share one with the chance
    that two random u16 signs of S bins meet, about S / 65536."""
    rng = np.random.default_rng(seed)
    parents = rng.integers(0, 1 << 16, (n_clusters, sketch_size),
                           dtype=np.uint16)
    out = np.empty((n, sketch_size), dtype=np.uint16)
    step = 1 << 16
    for r0 in range(0, n, step):
        rows = np.arange(r0, min(n, r0 + step))
        sig = parents[rows % n_clusters]
        fresh = rng.random(sig.shape) < redraw
        sig[fresh] = rng.integers(0, 1 << 16, int(fresh.sum()), dtype=np.uint16)
        out[rows] = sig
    return out


def write_derived_inverted(prefix: str, names: list[str], signs: np.ndarray,
                           kmer: int) -> None:
    """Write prefix.ski and prefix.skq for the sign matrix `signs` (rows in
    the order of names)."""
    from .formats.skd import SketchDataWriter
    from .inverted.index import Inverted
    from .sketchcore.sketch import HashType

    inv = Inverted(sign_matrix=signs, sample_names=list(names),
                   kmer_size=kmer, rc=True, hash_type=HashType("dna"))
    inv.save(prefix)
    with SketchDataWriter(f"{prefix}.skq", dtype=np.uint16) as w:
        w.write_sketch(signs.reshape(-1))
