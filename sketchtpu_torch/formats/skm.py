"""MultiSketch: the .skm metadata container + .skd data access.

File format compatible with the reference (src/sketch/multisketch.rs):
snappy-framed CBOR of a serde struct map, including the v0.2.0
back-compatibility shim for the sketchsize64 field.
"""

from __future__ import annotations

import numpy as np

from .. import spans
from ..constants import BBITS, num_bins
from ..sketchcore.sketch import HashType, Sketch
from . import cbor, snappy, skd

FORMAT_VERSION = "0.3.0"  # sketch file format version we are compatible with


class MultiSketch:
    def __init__(
        self,
        sketches: list[Sketch],
        sketch_size: int,
        kmer_lengths: list[int],
        hash_type: HashType,
        sketch_version: str = FORMAT_VERSION,
        name_map: dict[str, int] | None = None,
    ):
        # sketch_size here is the rounded (multiple-of-64) bin count, as the
        # reference stores it (lib.rs:279-297 passes signs_size).
        self.sketch_size = sketch_size
        self.sketchsize64, _signs, usigs_size = num_bins(sketch_size)
        self.kmer_lengths = list(kmer_lengths)
        self.sketch_metadata = sketches
        if name_map is None:
            name_map = {s.name: s.index for s in sketches}
        self.name_map = name_map
        self.bin_stride = 1
        self.kmer_stride = usigs_size
        self.sample_stride = self.kmer_stride * len(kmer_lengths)
        self.sketch_version = sketch_version
        self.hash_type = hash_type
        self.block_reindex: list[int] | None = None
        self.sketch_bins: np.ndarray | None = None

    # --- serialization ---

    def to_serde(self) -> dict:
        return {
            "sketch_size": self.sketch_size,
            "sketchsize64": self.sketchsize64,
            "kmer_lengths": self.kmer_lengths,
            "sketch_metadata": [s.to_serde() for s in self.sketch_metadata],
            "name_map": {k: v for k, v in self.name_map.items()},
            "bin_stride": self.bin_stride,
            "kmer_stride": self.kmer_stride,
            "sample_stride": self.sample_stride,
            "sketch_version": self.sketch_version,
            "hash_type": self.hash_type.to_serde(),
        }

    def save_metadata(self, file_prefix: str) -> None:
        import os

        payload = cbor.dumps(self.to_serde())
        # write-then-rename so the .skm appears atomically: the multi-
        # process sketch merge uses its existence as the shard-complete
        # signal (the .skd is written before the metadata)
        tmp = f"{file_prefix}.skm.tmp"
        with open(tmp, "wb") as f:
            f.write(snappy.frame_compress(payload))
        os.replace(tmp, f"{file_prefix}.skm")

    @classmethod
    @spans.spanned("load.skm")
    def load_metadata(cls, file_prefix: str) -> "MultiSketch":
        with open(f"{file_prefix}.skm", "rb") as f:
            raw = f.read()
        spans.count("bytes", len(raw))
        payload = snappy.frame_decompress(raw)
        obj = cbor.loads(payload)
        sketch_size = obj["sketch_size"]
        sketchsize64 = obj.get("sketchsize64", 0)
        if not sketchsize64:
            # pre-v0.2.0 files stored sketchsize64 in sketch_size
            # (multisketch.rs:96-100)
            sketchsize64 = sketch_size
            sketch_size = sketch_size * 64
        ms = cls(
            sketches=[Sketch.from_serde(s) for s in obj["sketch_metadata"]],
            sketch_size=sketch_size,
            kmer_lengths=list(obj["kmer_lengths"]),
            hash_type=HashType.from_serde(obj["hash_type"]),
            sketch_version=obj.get("sketch_version", ""),
            name_map={k: v for k, v in obj["name_map"].items()},
        )
        ms.sketchsize64 = sketchsize64
        ms.bin_stride = obj.get("bin_stride", 1)
        ms.kmer_stride = obj.get("kmer_stride", sketchsize64 * BBITS)
        ms.sample_stride = obj.get(
            "sample_stride", ms.kmer_stride * len(ms.kmer_lengths)
        )
        # The reference's delete saves the pre-delete name_map next to the
        # filtered metadata (multisketch.rs:298-301), so files it produced
        # can carry entries for deleted samples / out-of-range positions.
        # Rebuild from the metadata when the keys disagree (our own delete
        # writes a consistent map).
        names = {s.name for s in ms.sketch_metadata}
        if set(ms.name_map) != names:
            import logging

            logging.getLogger(__name__).warning(
                ".skm name_map is inconsistent with its sketch metadata "
                "(a database deleted by sketchlib.rust?); rebuilding"
            )
            ms.name_map = {
                s.name: i for i, s in enumerate(ms.sketch_metadata)
            }
        return ms

    # --- data access ---

    def number_samples_loaded(self) -> int:
        if self.block_reindex is not None:
            return len(self.block_reindex)
        return len(self.sketch_metadata)

    def sketch_name(self, index: int) -> str:
        if self.block_reindex is not None:
            return self.sketch_metadata[self.block_reindex[index]].name
        return self.sketch_metadata[index].name

    def get_sample_index(self, name: str):
        if self.block_reindex is not None:
            for logical, meta_idx in enumerate(self.block_reindex):
                if self.sketch_metadata[meta_idx].name == name:
                    return logical
            return None
        return self.name_map.get(name)

    def get_k_idx(self, k: int):
        try:
            return self.kmer_lengths.index(k)
        except ValueError:
            return None

    @spans.spanned("load.skd")
    def read_sketch_data(self, file_prefix: str) -> None:
        self.sketch_bins = skd.read_all_skd(f"{file_prefix}.skd")
        spans.count("bytes", self.sketch_bins.nbytes)

    @spans.spanned("load.skd")
    def read_sketch_data_block(self, file_prefix: str, names: list[str]) -> None:
        block_reindex = []
        read_indices = []
        for name in names:
            idx = self.name_map.get(name)
            if idx is None:
                raise ValueError(
                    f"Could not find requested sample {name} in sketch metadata"
                )
            read_indices.append(self.sketch_metadata[idx].index)
            block_reindex.append(idx)
        self.block_reindex = block_reindex
        self.sketch_bins = skd.read_skd_batch(
            f"{file_prefix}.skd", read_indices, self.sample_stride
        )
        spans.count("bytes", self.sketch_bins.nbytes)

    def get_sketch_slice(self, sketch_idx: int, k_idx: int) -> np.ndarray:
        """The usigs (kmer_stride u64 words) of loaded sample sketch_idx at
        k index k_idx, a view of the loaded bins."""
        start = sketch_idx * self.sample_stride + k_idx * self.kmer_stride
        return self.sketch_bins[start : start + self.kmer_stride]

    def bins_matrix(self, k_idx: int) -> np.ndarray:
        """All loaded samples' usigs at one k as a (n, kmer_stride) matrix."""
        n = self.number_samples_loaded()
        mat = self.sketch_bins.reshape(n, self.sample_stride)
        return mat[:, k_idx * self.kmer_stride : (k_idx + 1) * self.kmer_stride]

    # --- compat / lifecycle (multisketch.rs:222-348) ---

    def is_compatible_with(self, other: "MultiSketch") -> bool:
        """Whether the two databases can merge: the same k-mer lengths,
        sketch size and hash type."""
        return not self.incompatibilities(other)

    def incompatibilities(self, other: "MultiSketch") -> list[str]:
        """Human-readable list of the properties that differ (the checks of
        multisketch.rs:222-226), empty when the DBs can merge."""
        diffs = []
        if self.kmer_lengths != other.kmer_lengths:
            diffs.append(
                f"k-mer lengths: {self.kmer_lengths} vs {other.kmer_lengths}"
            )
        if self.sketch_size != other.sketch_size:
            diffs.append(
                f"sketch size: {self.sketch_size} vs {other.sketch_size}"
            )
        if self.hash_type != other.hash_type:
            diffs.append(f"hash type: {self.hash_type} vs {other.hash_type}")
        return diffs

    def append_compatibility(self, name_vec) -> bool:
        duplicates = [name for name, _files in name_vec if name in self.name_map]
        if duplicates:
            print(f"Duplicates found: {duplicates!r}")
        return not duplicates

    def merge_sketches(self, other: "MultiSketch") -> "MultiSketch":
        offset = len(self.sketch_metadata)
        for sketch in other.sketch_metadata:
            if sketch.name in self.name_map:
                raise ValueError(
                    f"{sketch.name} appears in both databases. "
                    "Cannot merge sketches."
                )
            merged = Sketch(**{**sketch.__dict__})
            merged.index = sketch.index + offset
            self.name_map[merged.name] = merged.index
            self.sketch_metadata.append(merged)
        return self

    def debug_str(self) -> str:
        kmers = "[" + ", ".join(str(k) for k in self.kmer_lengths) + "]"
        return (
            f"sketch_version={self.sketch_version}\n"
            f"sequence_type={self.hash_type.debug_str()}\n"
            f"sketch_size={self.sketch_size}\n"
            f"n_samples={len(self.sketch_metadata)}\n"
            f"kmers={kmers}\ninverted=false"
        )

    def display_str(self) -> str:
        lines = [
            "Name\tSequence length\tBase frequencies\tMissing/ambig bases\t"
            "From reads\tSingle strand\tDensified"
        ]
        for sketch in self.sketch_metadata:
            lines.append(sketch.display_row())
        return "\n".join(lines) + "\n"
