"""The `index` database kind: an inverted index (.ski) of u16 signs in
clusters, made from the seed.

A frozen, vectorised copy of sketchtpu_torch/synth.py::derive_signs with a
writer of its own: `clusters` independent clusters of random signs; sample
i copies cluster i % clusters and re-draws each bin with probability
`redraw`. Pairs of one cluster share most bins; pairs of two share one
with the chance that two random u16 signs of S bins meet, about S / 65536.

.ski: snappy-framed MessagePack of the Inverted struct in rmp-serde's
compact form (sketchlib.rust inverted.rs:194-225): a list of S bins, each
a map of u16 sign to the roaring bitmap of its samples, then the sample
count, names, metadata, labels, k, format version, rc and hash type."""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from . import native
from .encode import Raw, msgpack_array_header, msgpack_dumps
from .sketches import FORMAT_VERSION, rng_for, sample_names


@dataclass
class IndexDatabase:
    prefix: Path  # what `precluster` takes: the .ski path
    names: list[str]
    signs: np.ndarray  # (n, S) u16
    k: int
    files: list[Path]  # every file a job reads; the harness links them

    @property
    def n(self) -> int:
        return self.signs.shape[0]


def generate(config: dict, seed: int) -> np.ndarray:
    """(n, S) u16 signs of the configuration's samples."""
    n, s = config["samples"], config["sketch_size"]
    rng = rng_for(seed, 3)
    parents = rng.integers(0, 1 << 16, (config["clusters"], s),
                           dtype=np.uint16)
    signs = parents[np.arange(n) % config["clusters"]]
    fresh = rng.random((n, s), dtype=np.float32) < np.float32(config["redraw"])
    signs[fresh] = rng.integers(0, 1 << 16, int(fresh.sum()), dtype=np.uint16)
    return signs


def _bins(signs: np.ndarray) -> bytes:
    """The index list: per bin, the msgpack map of each distinct sign
    (ascending) to the roaring bitmap of its samples (ascending)."""
    lib = native.lib()
    n, s = signs.shape
    cap = 5 + n * 64 + 32
    buf = np.empty(cap, dtype=np.uint8)
    parts = [msgpack_array_header(s)]
    for b in range(s):
        col = signs[:, b]
        order = np.argsort(col, kind="stable").astype(np.uint32)
        sv = col[order]
        starts = np.flatnonzero(np.concatenate([[True], sv[1:] != sv[:-1]]))
        ent_off = np.append(starts, n).astype(np.int64)
        uniq = np.ascontiguousarray(sv[starts])
        written = lib.pb_ski_bin_msgpack(
            uniq.ctypes.data, ent_off.ctypes.data, order.ctypes.data,
            ctypes.c_int64(uniq.size), buf.ctypes.data, cap)
        if written < 0:
            raise RuntimeError("a .ski bin overflowed its buffer")
        parts.append(buf[:written].tobytes())
    return b"".join(parts)


def write(path: Path, signs: np.ndarray, names: list[str], k: int) -> Path:
    serde = [Raw(_bins(signs)), signs.shape[0], names, None, None, k,
             FORMAT_VERSION, True, "DNA"]
    path.write_bytes(native.snappy_frame(msgpack_dumps(serde)))
    return path


def make(config: dict, seed: int, workdir: Path) -> IndexDatabase:
    """Generate the configuration's signs from the seed and write the .ski
    under workdir."""
    signs = generate(config, seed)
    names = sample_names(signs.shape[0])
    path = write(Path(workdir) / "index.ski", signs, names, config["k"])
    return IndexDatabase(prefix=path, names=names, signs=signs,
                         k=config["k"], files=[path])


def subset(db: IndexDatabase, m: int, seed: int,
           workdir: Path) -> IndexDatabase:
    """The first m samples of db, written under workdir as an index of
    their own: the same S and k, for the warm-up job."""
    Path(workdir).mkdir(parents=True, exist_ok=True)
    path = write(Path(workdir) / db.prefix.name, db.signs[:m], db.names[:m],
                 db.k)
    return IndexDatabase(prefix=path, names=db.names[:m], signs=db.signs[:m],
                         k=db.k, files=[path])
