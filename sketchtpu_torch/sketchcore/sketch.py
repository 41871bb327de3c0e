"""Sketch objects and the per-sample sketching pipeline (host oracle path).

Mirrors sketchlib.rust src/sketch/mod.rs (Sketch::new, get_signs) with the
data-parallel hash formulations of hash/nthash_np.py and
hash/aahash_np.py. The batched device backends (sketchcore/sketch_torch.py)
produce bit-identical signs.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..constants import SIGN_MOD, num_bins
from ..hash.aahash_np import aahash_valid
from ..hash.nthash_np import nthash_valid
from ..ingest.fastx import AaStream, DnaStream
from .signs import (
    bin_minima,
    bin_minima_filtered,
    densify,
    fill_usigs,
    signs_from_hashes,
)


@dataclass
class HashType:
    """Sequence alphabet: "dna", "aa" (with level 1-3) or "pdb"."""

    kind: str = "dna"
    level: int = 1

    def to_serde(self):
        """serde external-tag representation used in .skm/.ski files."""
        if self.kind == "dna":
            return "DNA"
        if self.kind == "pdb":
            return "PDB"
        return {"AA": f"Level{self.level}"}

    @classmethod
    def from_serde(cls, obj) -> "HashType":
        if obj == "DNA":
            return cls("dna")
        if obj == "PDB":
            return cls("pdb")
        if isinstance(obj, dict) and "AA" in obj:
            level = {"Level1": 1, "Level2": 2, "Level3": 3}[obj["AA"]]
            return cls("aa", level)
        raise ValueError(f"unknown hash type {obj!r}")

    def debug_str(self) -> str:
        """Rust Debug formatting, used by the info command."""
        if self.kind == "dna":
            return "DNA"
        if self.kind == "pdb":
            return "PDB"
        return f"AA(Level{self.level})"

    def __eq__(self, other):
        if not isinstance(other, HashType):
            return NotImplemented
        if self.kind != other.kind:
            return False
        return self.kind != "aa" or self.level == other.level


@dataclass
class Sketch:
    """One sample's sketch metadata (+ optionally its transposed bins)."""

    name: str
    index: int | None = None
    rc: bool = True
    reads: bool = False
    seq_length: int = 0
    densified: bool = False
    acgt: tuple[int, int, int, int] = (0, 0, 0, 0)
    non_acgt: int = 0
    usigs: np.ndarray | None = field(default=None, repr=False)

    def to_serde(self) -> dict:
        """CBOR map in serde field order (usigs is #[serde(skip)])."""
        return {
            "name": self.name,
            "index": self.index,
            "rc": self.rc,
            "reads": self.reads,
            "seq_length": self.seq_length,
            "densified": self.densified,
            "acgt": list(self.acgt),
            "non_acgt": self.non_acgt,
        }

    @classmethod
    def from_serde(cls, obj: dict) -> "Sketch":
        return cls(
            name=obj["name"],
            index=obj.get("index"),
            rc=obj.get("rc", True),
            reads=obj.get("reads", False),
            seq_length=obj.get("seq_length", 0),
            densified=obj.get("densified", False),
            acgt=tuple(obj.get("acgt", (0, 0, 0, 0))),
            non_acgt=obj.get("non_acgt", 0),
        )

    def display_row(self) -> str:
        """One row of `info --sample-info` output (src/sketch/mod.rs:261-278).

        Note the reference prints base counts in A,C,G,T order while storing
        them in encode order A,C,T,G; and 'Single strand' is !rc.
        """
        a, c, t, g = self.acgt
        return (
            f"{self.name}\t{self.seq_length}\t[{a}, {c}, {g}, {t}]\t"
            f"{self.non_acgt}\t{str(self.reads).lower()}\t"
            f"{str(not self.rc).lower()}\t{str(self.densified).lower()}"
        )


def sketch_dna_sample(
    stream: DnaStream,
    name: str,
    kmer_lengths: list[int],
    sketch_size: int,
    rc: bool,
    min_count: int,
) -> Sketch:
    """Sketch one DNA sample across k-mer lengths (Sketch::new equivalent)."""
    if stream.seq_len == 0:
        raise ValueError(f"{name} has no valid sequence")
    _s64, bins, _usize = num_bins(sketch_size)
    usigs_parts = []
    minhash_sum = 0.0
    densified_any = False
    for k in kmer_lengths:
        hashes = nthash_valid(stream, k, rc)
        if hashes.size == 0:
            raise ValueError("K-mer larger than smallest valid sequence")
        signs = signs_from_hashes(hashes)
        if stream.reads:
            binned = bin_minima_filtered(signs, bins, min_count)
        else:
            binned = bin_minima(signs, bins)
        densified_any |= densify(binned)
        minhash_sum += float(binned[0]) / float(SIGN_MOD)
        usigs_parts.append(fill_usigs(binned))
    seq_length = (
        int(len(kmer_lengths) / minhash_sum) if stream.reads else stream.seq_len
    )
    return Sketch(
        name=name,
        rc=rc,
        reads=stream.reads,
        seq_length=seq_length,
        densified=densified_any,
        acgt=tuple(int(x) for x in stream.acgt),
        non_acgt=stream.non_acgt,
        usigs=np.concatenate(usigs_parts),
    )



def sketch_aa_sample(
    stream: AaStream,
    name: str,
    kmer_lengths: list[int],
    sketch_size: int,
    level: int,
    rc: bool = True,
) -> Sketch:
    """Sketch one amino-acid (or 3Di) sample across k-mer lengths."""
    if stream.seq_len == 0:
        raise ValueError(f"{name} has no valid sequence")
    _s64, bins, _usize = num_bins(sketch_size)
    usigs_parts = []
    densified_any = False
    for k in kmer_lengths:
        hashes = aahash_valid(stream, k, level)
        signs = signs_from_hashes(hashes)
        binned = bin_minima(signs, bins)
        densified_any |= densify(binned)
        usigs_parts.append(fill_usigs(binned))
    return Sketch(
        name=name,
        rc=rc,
        reads=False,
        seq_length=stream.seq_len,
        densified=densified_any,
        acgt=(0, 0, 0, 0),
        non_acgt=stream.invalid_count,
        usigs=np.concatenate(usigs_parts),
    )
