"""The `sketches` database kind: a sketch database (.skd + .skm) of related
samples, made from the seed.

A frozen, vectorised copy of sketchtpu_torch/synth.py::derive_words with
writers of its own, so that the inputs stay the same whatever a later
change does to the port. One ancestor sketch of random bit-planes; the
configuration's `parents` lineage parents each re-draw every bin of it
with the chance 1 - (1 - d)^k that a k-mer holds a mutation at the
parent's divergence d (log-spaced over `parent_divergence`); sample i
copies parent i % parents and re-draws each bin in the same way at its own
divergence (log-spaced over `divergence`, in an order drawn from the
seed). A bin is re-drawn whole: all BBITS bit-planes of it.

.skd: little-endian u64, sample-major, then k ascending, then 64-bin chunk,
then bit-plane (sketchlib.rust sketch_datafile.rs). .skm: snappy-framed
CBOR of the MultiSketch serde map (sketchlib.rust multisketch.rs)."""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from . import native
from .encode import cbor_dumps

BBITS = 14  # bit-planes a 64-bin chunk keeps (sketchlib.rust sketch/mod.rs)
FORMAT_VERSION = "0.3.0"


@dataclass
class SketchDatabase:
    prefix: Path  # what `dist` takes: the path without .skd / .skm
    names: list[str]
    words: np.ndarray  # (n, nk, s64, BBITS) u64
    kmers: list[int]
    sketch_size: int  # bins as the .skm stores them: s64 * 64
    files: list[Path]  # every file a job reads; the harness links them

    @property
    def n(self) -> int:
        return self.words.shape[0]

    @property
    def s64(self) -> int:
        return self.words.shape[2]


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """The generator of one stream of a run's data, from the run's seed
    (any whole number)."""
    return np.random.default_rng([seed % (1 << 64), stream])


def _redraw(rng, words: np.ndarray, p: np.ndarray) -> np.ndarray:
    """words (m, s64, BBITS) with each 64-bin chunk's bins re-drawn with
    probability p (m,): fresh random signs in every bit-plane of a bin."""
    m, s64, _ = words.shape
    hit = rng.random((m, s64, 64), dtype=np.float32) < p[:, None, None].astype(np.float32)
    mask = np.packbits(hit, axis=-1, bitorder="little").view(np.uint64)
    fresh = rng.integers(0, 1 << 64, (m, s64, BBITS), dtype=np.uint64)
    return (words & ~mask) | (fresh & mask)


def generate(config: dict, seed: int) -> np.ndarray:
    """(n, nk, s64, BBITS) u64 sketch words of the configuration's samples."""
    n, kmers = config["samples"], config["kmers"]
    s64 = -(-config["sketch_size"] // 64)
    n_par = config["parents"]
    rng = rng_for(seed, 1)
    ancestor = rng.integers(0, 1 << 64, (len(kmers), s64, BBITS),
                            dtype=np.uint64)
    d_par = rng.permutation(np.geomspace(*config["parent_divergence"], n_par))
    d = rng.permutation(np.geomspace(*config["divergence"], n))
    src = np.arange(n) % n_par
    out = np.empty((n, len(kmers), s64, BBITS), dtype=np.uint64)
    for ki, k in enumerate(kmers):
        parents = _redraw(rng, np.repeat(ancestor[ki][None], n_par, axis=0),
                          1.0 - (1.0 - d_par) ** k)
        out[:, ki] = _redraw(rng, parents[src], 1.0 - (1.0 - d) ** k)
    return out


def sample_names(n: int) -> list[str]:
    return [f"sample_{i:06d}" for i in range(n)]


def metadata(n: int, seed: int) -> list[dict]:
    """Each sample's .skm entry (serde field order): an assembly of about
    2 Mb, its base counts, both strands."""
    rng = rng_for(seed, 2)
    length = rng.integers(1_900_000, 2_300_000, n)
    gc = rng.uniform(0.38, 0.42, n)
    c = (length * gc / 2).astype(np.int64)
    a = (length - 2 * c) // 2
    t = length - 2 * c - a
    return [{"name": name, "index": i, "rc": True, "reads": False,
             "seq_length": int(length[i]), "densified": False,
             "acgt": [int(a[i]), int(c[i]), int(t[i]), int(c[i])],
             "non_acgt": 0}
            for i, name in enumerate(sample_names(n))]


def write(prefix: Path, words: np.ndarray, kmers, seed: int) -> list[Path]:
    """prefix.skd and prefix.skm of the words; returns both paths."""
    n, nk, s64, _ = words.shape
    skd, skm = Path(f"{prefix}.skd"), Path(f"{prefix}.skm")
    np.ascontiguousarray(words).astype("<u8", copy=False).tofile(skd)
    meta = metadata(n, seed)
    serde = {
        "sketch_size": s64 * 64,
        "sketchsize64": s64,
        "kmer_lengths": list(kmers),
        "sketch_metadata": meta,
        "name_map": {m["name"]: i for i, m in enumerate(meta)},
        "bin_stride": 1,
        "kmer_stride": s64 * BBITS,
        "sample_stride": s64 * BBITS * nk,
        "sketch_version": FORMAT_VERSION,
        "hash_type": "DNA",
    }
    skm.write_bytes(native.snappy_frame(cbor_dumps(serde)))
    return [skd, skm]


def make(config: dict, seed: int, workdir: Path) -> SketchDatabase:
    """Generate the configuration's samples from the seed and write them
    under workdir."""
    words = generate(config, seed)
    prefix = Path(workdir) / "db"
    files = write(prefix, words, config["kmers"], seed)
    return SketchDatabase(prefix=prefix, names=sample_names(words.shape[0]),
                          words=words, kmers=list(config["kmers"]),
                          sketch_size=words.shape[2] * 64, files=files)


def subset(db: SketchDatabase, m: int, seed: int,
           workdir: Path) -> SketchDatabase:
    """The first m samples of db, written under workdir as a database of
    their own: the same k and sketch size, for the warm-up job."""
    Path(workdir).mkdir(parents=True, exist_ok=True)
    prefix = Path(workdir) / db.prefix.name
    files = write(prefix, db.words[:m], db.kmers, seed)
    return SketchDatabase(prefix=prefix, names=db.names[:m],
                          words=db.words[:m], kmers=db.kmers,
                          sketch_size=db.sketch_size, files=files)
