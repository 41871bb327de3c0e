"""The `collection` database kind: one collection of many species, written
both as a sketch database (.skd + .skm) and as the inverted index of the
same genomes (.ski + .skq), made from the seed.

Species, lineages, samples, as sketches.py derives lineages from one
ancestor:
- `species` independent random ancestor sketches (unrelated at k >= 17),
  of Zipf(`species_zipf`) sizes that sum to `samples`;
- `parents` lineage parents a species, each re-drawing every bin of its
  ancestor with the chance 1 - (1 - d)^k at its divergence d (log-spaced
  over `parent_divergence`, in an order drawn from the seed);
- sample j of a species copies its lineage parent j % parents and
  re-draws in the same way at its own divergence (log-spaced over
  `divergence` across the collection, in an order drawn from the seed).
The index's S = `index_sketch_size` u16 signs at k = `index_k` follow the
same tree at the same divergences: a species holds S random signs, a
lineage re-draws each bin with the chance 1 - (1 - d_parent)^k, a sample
with 1 - (1 - d)^k. So the index and the sketches describe the same
genomes, and two species share a sign only by the chance that two
random u16 signs meet.

The samples' order is drawn from the seed, so that the first 8,192 (the
warm-up's) hold every species. The index lists the samples in an order of
its own, also drawn from the seed, as an index built from another listing
of the same files would: precluster maps it onto the .skd's by name.
.skq: the index's signs, flat little-endian u16, in .ski sample order
(`inverted build --write-skq`)."""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from . import index, sketches
from .sketches import BBITS, _redraw, rng_for, sample_names


@dataclass
class CollectionDatabase:
    prefix: Path  # prefix.skd / .skm (what --skd takes), prefix.ski / .skq
    names: list[str]  # in .skd order
    words: np.ndarray  # (n, nk, s64, BBITS) u64
    signs: np.ndarray  # (n, S) u16, in .skd order
    species: np.ndarray  # (n,) each sample's species
    ski_order: np.ndarray  # (n,) the .skd sample at each .ski position
    kmers: list[int]
    sketch_size: int  # bins as the .skm stores them: s64 * 64
    k: int  # the index's k
    files: list[Path]  # every file a job reads; the harness links them

    @property
    def n(self) -> int:
        return self.words.shape[0]

    @property
    def s64(self) -> int:
        return self.words.shape[2]


def species_sizes(n: int, species: int, exponent: float) -> np.ndarray:
    """Sizes proportional to 1 / rank^exponent, largest first, rounded by
    largest remainder so that they sum to n."""
    share = 1.0 / np.arange(1, species + 1) ** exponent
    exact = n * share / share.sum()
    sizes = np.floor(exact).astype(np.int64)
    short = n - int(sizes.sum())
    sizes[np.argsort(-(exact - sizes), kind="stable")[:short]] += 1
    return sizes


def tree(config: dict, seed: int):
    """(species, lineage, d_parent, d) of the configuration's samples in
    their order: each sample's species and lineage parent (species *
    parents + j), each lineage parent's divergence from its species, each
    sample's from its parent."""
    n, n_sp, n_par = config["samples"], config["species"], config["parents"]
    rng = rng_for(seed, 4)
    sizes = species_sizes(n, n_sp, config["species_zipf"])
    species = np.repeat(np.arange(n_sp), sizes)
    within = np.arange(n) - np.repeat(np.cumsum(sizes) - sizes, sizes)
    lineage = species * n_par + within % n_par
    order = rng.permutation(n)
    d_parent = np.concatenate([
        rng.permutation(np.geomspace(*config["parent_divergence"], n_par))
        for _ in range(n_sp)])
    d = rng.permutation(np.geomspace(*config["divergence"], n))
    return species[order], lineage[order], d_parent, d


def _redraw_signs(rng, signs: np.ndarray, p: np.ndarray) -> np.ndarray:
    """signs (m, S) u16 with each bin re-drawn with probability p (m,)."""
    hit = rng.random(signs.shape, dtype=np.float32) < p[:, None].astype(np.float32)
    out = signs.copy()
    out[hit] = rng.integers(0, 1 << 16, int(hit.sum()), dtype=np.uint16)
    return out


def generate(config: dict, seed: int):
    """(words (n, nk, s64, BBITS) u64, signs (n, S) u16, species (n,)) of
    the configuration's samples."""
    species, lineage, d_parent, d = tree(config, seed)
    n, kmers = config["samples"], config["kmers"]
    s64 = -(-config["sketch_size"] // 64)
    n_par = config["parents"]
    parent_species = np.arange(d_parent.size) // n_par
    rng = rng_for(seed, 5)
    words = np.empty((n, len(kmers), s64, BBITS), dtype=np.uint64)
    for ki, k in enumerate(kmers):
        ancestors = rng.integers(0, 1 << 64, (config["species"], s64, BBITS),
                                 dtype=np.uint64)
        parents = _redraw(rng, ancestors[parent_species],
                          1.0 - (1.0 - d_parent) ** k)
        words[:, ki] = _redraw(rng, parents[lineage], 1.0 - (1.0 - d) ** k)
    rng = rng_for(seed, 6)
    k = config["index_k"]
    ancestors = rng.integers(0, 1 << 16,
                             (config["species"], config["index_sketch_size"]),
                             dtype=np.uint16)
    parents = _redraw_signs(rng, ancestors[parent_species],
                            1.0 - (1.0 - d_parent) ** k)
    signs = _redraw_signs(rng, parents[lineage], 1.0 - (1.0 - d) ** k)
    return words, signs, species


def write(prefix: Path, words, signs, ski_order, kmers, k: int,
          seed: int) -> list[Path]:
    """prefix.skd, .skm, .ski and .skq; returns the four paths. Samples are
    named by their .skd position; the index lists them in ski_order."""
    names = sample_names(words.shape[0])
    files = sketches.write(prefix, words, kmers, seed)
    ski = index.write(Path(f"{prefix}.ski"), signs[ski_order],
                      [names[i] for i in ski_order], k)
    skq = Path(f"{prefix}.skq")
    np.ascontiguousarray(signs[ski_order]).astype("<u2").tofile(skq)
    return [*files, ski, skq]


def make(config: dict, seed: int, workdir: Path) -> CollectionDatabase:
    """Generate the configuration's collection from the seed and write its
    four files under workdir."""
    words, signs, species = generate(config, seed)
    ski_order = rng_for(seed, 7).permutation(words.shape[0])
    prefix = Path(workdir) / "db"
    files = write(prefix, words, signs, ski_order, config["kmers"],
                  config["index_k"], seed)
    return CollectionDatabase(
        prefix=prefix, names=sample_names(words.shape[0]), words=words,
        signs=signs, species=species, ski_order=ski_order,
        kmers=list(config["kmers"]), sketch_size=words.shape[2] * 64,
        k=config["index_k"], files=files)


def subset(db: CollectionDatabase, m: int, seed: int,
           workdir: Path) -> CollectionDatabase:
    """The first m samples of db (.skd order), written under workdir as a
    collection of its own: the same k, sketch sizes and index order, for
    the warm-up job."""
    Path(workdir).mkdir(parents=True, exist_ok=True)
    prefix = Path(workdir) / db.prefix.name
    ski_order = db.ski_order[db.ski_order < m]
    files = write(prefix, db.words[:m], db.signs[:m], ski_order, db.kmers,
                  db.k, seed)
    return CollectionDatabase(
        prefix=prefix, names=db.names[:m], words=db.words[:m],
        signs=db.signs[:m], species=db.species[:m], ski_order=ski_order,
        kmers=db.kmers, sketch_size=db.sketch_size, k=db.k, files=files)
