"""Inverted sketch index (.ski/.skq): build, query, precluster.

The reference stores one HashMap<u16 sign -> RoaringBitmap of samples> per
bin (sketchlib.rust src/inverted.rs:48-58). The in-memory representation
here is the dense [n_samples x sketch_size] uint16 sign matrix: bin queries
become equality reductions over rows (on the card: inverted/device.py and
csrc/signeq.cu), while the .ski file keeps the reference's exact on-disk
encoding (snappy-framed MessagePack with roaring bitmaps).
"""

from __future__ import annotations

import struct

import numpy as np

from .. import _native, spans
from .._native import run_split
from ..formats import msgpack, roaring, skd, snappy
from ..formats.skm import FORMAT_VERSION, _strings
from ..sketchcore.sketch import HashType
from ..sketchcore.signs import (
    bin_minima,
    bin_minima_filtered,
    densify,
    signs_from_hashes,
)
from ..hash.nthash_np import nthash_valid
from ..ingest.fastx import read_dna_sample

_U16_MAX = np.uint16(0xFFFF)


def _msgpack_list_header(n: int) -> bytes:
    if n < 16:
        return bytes([0x90 | n])
    if n < 1 << 16:
        return b"\xdc" + n.to_bytes(2, "big")
    return b"\xdd" + n.to_bytes(4, "big")


def _value_at(payload: bytes, pos: int):
    """(the msgpack value at pos, the offset past it), or None where the
    payload is cut or malformed there (msgpack.py reads a cut str short,
    past the end)."""
    try:
        value, end = msgpack._decode(payload, pos)
    except (IndexError, ValueError, struct.error):
        return None
    return (value, end) if end <= len(payload) else None


def _str_list(lib, base: int, size: int, pos: int):
    """(the msgpack array of str at pos, the offset past it), decoded by
    the host helper, or None for another value."""
    info = np.zeros(3, np.int64)
    if lib.stpu_msgpack_strs(base, size, pos, None, None,
                             info.ctypes.data) < 0:
        return None
    count, nbytes, end = info.tolist()
    blob = np.empty(nbytes, np.uint8)
    off = np.empty(count + 1, np.int64)
    plain = lib.stpu_msgpack_strs(base, size, pos, blob.ctypes.data,
                                  off.ctypes.data, info.ctypes.data)
    return _strings(blob.tobytes(), off, bool(plain)), end


class Inverted:
    def __init__(
        self,
        sign_matrix: np.ndarray,  # (n_samples, sketch_size) uint16
        sample_names: list[str],
        kmer_size: int,
        rc: bool,
        hash_type: HashType,
        metadata: list[str] | None = None,
        labels: list[str] | None = None,
        sketch_version: str = FORMAT_VERSION,
    ):
        self.sign_matrix = np.ascontiguousarray(sign_matrix, dtype=np.uint16)
        self.sample_names = sample_names
        self.n_samples = len(sample_names)
        self.metadata = metadata
        self.labels = labels
        self.kmer_size = kmer_size
        self.sketch_version = sketch_version
        self.rc = rc
        self.hash_type = hash_type

    @property
    def sketch_size(self) -> int:
        return int(self.sign_matrix.shape[1])

    # --- construction (inverted.rs:66-113, 303-416) ---

    @classmethod
    def build(
        cls,
        input_files: list[tuple[str, list[str]]],
        file_order: list[int],
        k: int,
        sketch_size: int,
        rc: bool,
        min_count: int,
        min_qual: int,
        write_skq: str | None = None,
        metadata: list[str] | None = None,
        labels: list[str] | None = None,
        hash_type: HashType | None = None,
        progress=None,
        backend=None,
        threads: int = 1,
    ) -> "Inverted":
        hash_type = hash_type or HashType("dna")
        if hash_type.kind != "dna":
            raise NotImplementedError("Inverted index only supported for DNA")
        sketches, names = sketch_files_inverted(
            input_files,
            file_order,
            k,
            sketch_size,
            rc,
            min_count,
            min_qual,
            progress=progress,
            backend=backend,
            threads=threads,
        )
        if write_skq:
            with skd.SketchDataWriter(write_skq, dtype=np.uint16) as w:
                for row in sketches:
                    w.write_sketch(row)
        return cls(
            sign_matrix=sketches,
            sample_names=names,
            kmer_size=k,
            rc=rc,
            hash_type=hash_type,
            metadata=metadata,
            labels=labels,
        )

    def sketch_queries(
        self,
        input_files: list[tuple[str, list[str]]],
        min_count: int,
        min_qual: int,
        progress=None,
        backend=None,
        threads: int = 1,
    ):
        file_order = list(range(len(input_files)))
        return sketch_files_inverted(
            input_files,
            file_order,
            self.kmer_size,
            self.sketch_size,
            self.rc,
            min_count,
            min_qual,
            progress=progress,
            backend=backend,
            threads=threads,
        )

    # --- file IO (inverted.rs:194-225) ---

    def _index_raw(self):
        """The per-bin {sign: roaring} index as a pre-encoded msgpack.Raw
        list, encoded by the host helper (byte-identical to the JAX
        package's msgpack + roaring encoder: tests/test_torch_inverted.py)."""
        import ctypes

        lib = _native.lib()
        mat = self.sign_matrix
        n, s = mat.shape
        parts = [_msgpack_list_header(s)]
        # worst case per bin: map hdr + per distinct sign (3B key + 5B bin
        # hdr + roaring hdr/offsets 16B + 8192B bitset) bounded by 2B/member
        cap = 5 + n * 64 + 32
        buf = ctypes.create_string_buffer(cap)
        for b in range(s):
            col = mat[:, b]
            order = np.argsort(col, kind="stable").astype(np.uint32)
            svals = col[order]
            starts = (
                np.flatnonzero(
                    np.concatenate([[True], svals[1:] != svals[:-1]])
                )
                if n
                else np.zeros(0, dtype=np.int64)  # empty shard
            )
            ent_off = np.append(starts, n).astype(np.int64)
            signs = np.ascontiguousarray(svals[starts], dtype=np.uint16)
            members = np.ascontiguousarray(order)
            written = lib.stpu_ski_bin_msgpack(
                signs.ctypes.data,
                ent_off.ctypes.data,
                members.ctypes.data,
                signs.shape[0],
                buf,
                cap,
            )
            if written < 0:  # cap is sufficient by construction
                raise RuntimeError("the .ski bin encoder overflowed its "
                                   "buffer")
            parts.append(ctypes.string_at(buf, written))
        return msgpack.Raw(b"".join(parts))

    def to_serde(self):
        """rmp-serde compact representation: struct as positional array."""
        return [
            self._index_raw(),
            self.n_samples,
            self.sample_names,
            self.metadata,
            self.labels,
            self.kmer_size,
            self.sketch_version,
            self.rc,
            self.hash_type.to_serde(),
        ]

    def save(self, file_prefix: str) -> None:
        import os

        payload = msgpack.dumps(self.to_serde())
        # write-then-rename so the .ski appears atomically: the multi-
        # process build uses its existence as the shard-complete signal
        tmp = f"{file_prefix}.ski.tmp"
        with open(tmp, "wb") as f:
            f.write(snappy.frame_compress(payload))
        os.replace(tmp, f"{file_prefix}.ski")

    @classmethod
    @spans.spanned("load.ski")
    def load(cls, file_prefix: str) -> "Inverted":
        with spans.span("read"):
            with open(f"{file_prefix}.ski", "rb") as f:
                raw = f.read()
            spans.count("bytes", len(raw))
        with spans.span("snappy"):
            payload = snappy.frame_decompress(raw)
            spans.count("bytes", len(payload))
        del raw
        with spans.span("parse"):
            inv = cls._parse_native(payload)
            native = 0 if inv is None else inv.sketch_size
            if inv is None:
                inv = cls._parse(payload)
        # the bins the host helper decoded (0: the Python path)
        spans.count("native", native)
        return inv

    @classmethod
    def _parse_native(cls, payload: bytes, workers: int | None = None):
        """The index of a .ski's decompressed payload as the host helper
        decodes it (csrc/host/native.cpp, stpu_ski_bins_*): every bin's
        signs into a bin-major matrix, its bins split over `workers`
        threads (default _native.WORKERS), then transposed; the names,
        and the metadata and labels when lists of str, into packed
        strings. None where the payload is outside the helper's subset:
        the caller then decodes it with _parse."""
        lib = _native.lib()
        buf = np.frombuffer(payload, np.uint8)
        base, size = buf.ctypes.data, buf.size
        with spans.span("bins"):
            s = lib.stpu_ski_bins_scan(base, size, None, 0)
            if s < 0:
                return None
            starts = np.empty(s + 1, np.int64)
            if lib.stpu_ski_bins_scan(base, size, starts.ctypes.data,
                                      s + 1) < 0:
                return None
            head = _value_at(payload, int(starts[s]))
            if head is None or type(head[0]) is not int or head[0] < 0:
                return None
            n_samples, pos = head
            by_bin = np.empty((s, n_samples), np.uint16)
            filled = run_split(
                lambda lo, hi: lib.stpu_ski_bins_fill(
                    base, starts.ctypes.data, lo, hi, n_samples,
                    by_bin.ctypes.data) == 0,
                s, workers)
            if not all(filled):
                return None
            mat = np.empty((n_samples, s), np.uint16)
            run_split(
                lambda lo, hi: lib.stpu_transpose_u16(
                    by_bin.ctypes.data, s, n_samples, mat.ctypes.data, lo,
                    hi),
                n_samples, workers, least=4096)
            del by_bin
        with spans.span("tail"):
            # the names (a list of str, by the helper alone), the metadata
            # and labels (by the helper where lists of str, else by
            # msgpack.py), then the scalars
            tail = []
            for field in range(7):
                got = _str_list(lib, base, size, pos) if field < 3 else None
                if got is None and field > 0:
                    got = _value_at(payload, pos)
                if got is None:
                    return None
                value, pos = got
                tail.append(value)
        (sample_names, metadata, labels, kmer_size, sketch_version, rc,
         hash_type) = tail
        inv = cls(
            sign_matrix=mat,
            sample_names=sample_names,
            kmer_size=kmer_size,
            rc=rc,
            hash_type=HashType.from_serde(hash_type),
            metadata=metadata,
            labels=labels,
            sketch_version=sketch_version,
        )
        inv.n_samples = n_samples
        return inv

    @classmethod
    def _parse(cls, payload: bytes) -> "Inverted":
        """The index of a .ski's decompressed MessagePack payload, decoded
        in Python."""
        obj = msgpack.loads(payload)
        (
            index,
            n_samples,
            sample_names,
            metadata,
            labels,
            kmer_size,
            sketch_version,
            rc,
            hash_type,
        ) = obj
        sketch_size = len(index)
        mat = np.full((n_samples, sketch_size), _U16_MAX, dtype=np.uint16)
        for b, bin_map in enumerate(index):
            for sign, blob in bin_map.items():
                members = roaring.deserialize(blob)
                mat[members, b] = np.uint16(sign)
        inv = cls(
            sign_matrix=mat,
            sample_names=list(sample_names),
            kmer_size=kmer_size,
            rc=rc,
            hash_type=HashType.from_serde(hash_type),
            metadata=metadata,
            labels=labels,
            sketch_version=sketch_version,
        )
        inv.n_samples = n_samples
        return inv

    # --- queries (inverted.rs:229-300) ---

    def query_match_count(self, query_sigs: np.ndarray) -> np.ndarray:
        """Per-sample count of matching bins (u32)."""
        q = np.asarray(query_sigs, dtype=np.uint16)
        return (self.sign_matrix == q[None, :]).sum(axis=1, dtype=np.int64)

    def match_count(self, query_sigs: np.ndarray, engine=None) -> np.ndarray:
        """query_match_count, on the card when `engine` is given."""
        if engine is None:
            return self.query_match_count(query_sigs)
        q = np.asarray(query_sigs, dtype=np.uint16)[None, :]
        return engine.match_counts(q)[0]

    def all_shared_bins(self, query_sigs: np.ndarray) -> np.ndarray:
        q = np.asarray(query_sigs, dtype=np.uint16)
        return np.flatnonzero((self.sign_matrix == q[None, :]).all(axis=1))

    def any_shared_bins(self, query_sigs: np.ndarray) -> np.ndarray:
        q = np.asarray(query_sigs, dtype=np.uint16)
        return np.flatnonzero((self.sign_matrix == q[None, :]).any(axis=1))

    def query_probs(
        self,
        input_files: list[tuple[str, list[str]]],
        nouts: int = 10,
        min_count: int = 5,
        min_qual: int = 20,
        backend=None,
        engine=None,
    ) -> dict:
        """In-memory analogue of the WASM frontend's
        `SketchlibData::{query,get_probs}` (lib.rs:1019-1111): sketch ONE
        query sample against this index, match-count it, convert each
        count d to the Jaccard estimate d / (2*sketch_size - d), and
        return the top `nouts` as {"probs", "names", "metadata"}. Like
        the reference, names come from the index labels (metadata from
        the metadata vector), empty strings when absent, and equal probs
        keep the reference's stable-sort-then-reverse order (descending
        sample index among ties). `backend` sketches the query and
        `engine` (inverted/device.py) counts its matches on the card."""
        queries, _names = self.sketch_queries(
            input_files, min_count, min_qual, backend=backend
        )
        d = self.match_count(queries[0], engine).astype(np.float64)
        probs = d / (2.0 * self.sketch_size - d)
        order = np.argsort(probs, kind="stable")[::-1][:nouts]
        return {
            "probs": [float(probs[i]) for i in order],
            "names": [
                self.labels[i] if self.labels is not None else ""
                for i in order
            ],
            "metadata": [
                self.metadata[i] if self.metadata is not None else ""
                for i in order
            ],
        }

    def any_shared_bin_count(
        self, tile: int = 2048, engine=None, row_range: slice | None = None
    ) -> int:
        """Number of distinct sample pairs sharing at least one bin (the
        precluster --count mode, inverted.rs:271-300). Tiled over pair
        blocks so it scales; `engine` (inverted/device.py) runs the
        equality-any tiles on the card. With row_range, counts only pairs whose
        smaller index falls in [lo, hi) — rank partials sum to the total."""
        if engine is not None:
            return engine.any_shared_bin_count(row_range=row_range)
        n = self.n_samples
        lo, hi = (row_range.start, row_range.stop) if row_range else (0, n)
        total = 0
        mat = self.sign_matrix
        for i0 in range(lo, hi, tile):
            i1 = min(i0 + tile, hi)
            a = mat[i0:i1]
            for j0 in range(i0, n, tile):
                b = mat[j0 : j0 + tile]
                eq = (a[:, None, :] == b[None, :, :]).any(axis=2)
                ri = i0 + np.arange(i1 - i0)[:, None]
                ci = j0 + np.arange(b.shape[0])[None, :]
                total += int((eq & (ci > ri)).sum())
        return total

    def debug_str(self) -> str:
        sizes = [
            len(np.unique(self.sign_matrix[:, b])) for b in range(self.sketch_size)
        ]
        avg = np.format_float_positional(
            np.float64(sum(sizes) / len(sizes)), unique=True, trim="-"
        )
        return (
            f"sketch_version={self.sketch_version}\n"
            f"sequence_type={self.hash_type.debug_str()}\n"
            f"sketch_size={self.sketch_size}\n"
            f"n_samples={len(self.sample_names)}\n"
            f"kmer={self.kmer_size}\n"
            f"rc={str(self.rc).lower()}\n"
            f"inverted=true\n"
            f"max_hashes_per_bin={max(sizes)}\n"
            f"min_hashes_per_bin={min(sizes)}\n"
            f"avg_hashes_per_bin={avg}"
        )

    def display_str(self) -> str:
        return "Name\n" + "".join(f"{name}\n" for name in self.sample_names)


def sketch_files_inverted(
    input_files: list[tuple[str, list[str]]],
    file_order: list[int],
    k: int,
    sketch_size: int,
    rc: bool,
    min_count: int,
    min_qual: int,
    progress=None,
    backend=None,
    threads: int = 1,
) -> tuple[np.ndarray, list[str]]:
    """Sketch without bit-plane transpose; returns the (n, sketch_size) u16
    sign matrix and sample names in index order.

    Multi-entry samples (same name, several input rows mapped to one
    genome_idx) are merged by per-bin minimum of the *u16-truncated* signs
    and — exactly as the reference does — are never densified afterwards,
    because the truncated empty-bin marker 0xFFFF no longer equals u64::MAX
    (inverted.rs:376-405).

    With `backend` (the batched device sketcher), assembly inputs are
    hashed/binned on the card in chunks of samples (streams are parsed on
    host threads and released per chunk, so memory stays bounded at 661k
    scale) and reads go through its in-order signs; bin minima are
    bit-identical to the host loop.
    """
    from collections import Counter

    if not input_files:  # empty multi-process query slice
        return np.zeros((0, sketch_size), dtype=np.uint16), []

    n_distinct = len(set(name for name, _ in input_files))
    results: list[np.ndarray | None] = [None] * n_distinct
    seen_names: set[str] = set()
    name_counts = Counter(n for n, _ in input_files)
    multi = {name for name, c in name_counts.items() if c > 1}
    names_out = [""] * n_distinct
    for idx, (name, _files) in zip(file_order, input_files):
        names_out[idx] = name

    def merge_binned(name: str, genome_idx: int, binned: np.ndarray):
        if name not in seen_names:
            if name not in multi:
                densify(binned)
            results[genome_idx] = binned.astype(np.uint16)
            seen_names.add(name)
        else:
            results[genome_idx] = np.minimum(
                results[genome_idx], binned.astype(np.uint16)
            )
        if progress is not None:
            progress()

    if backend is not None:
        from concurrent.futures import ThreadPoolExecutor

        chunk = 256
        with ThreadPoolExecutor(max_workers=max(threads, 1)) as pool:
            for c0 in range(0, len(input_files), chunk):
                part = input_files[c0 : c0 + chunk]
                order = file_order[c0 : c0 + chunk]
                streams = list(
                    pool.map(lambda nf: read_dna_sample(nf[1], min_qual), part)
                )
                for (name, _f), gi, s in zip(part, order, streams):
                    if s.seq_len == 0:
                        raise ValueError(f"Genome {gi} has no valid sequence")
                asm = [i for i, s in enumerate(streams) if not s.reads]
                if asm:
                    bins = backend.bin_minima_multi_k(
                        [streams[i] for i in asm], [k], rc, sketch_size
                    )[k]
                for bi, i in enumerate(asm) if asm else []:
                    merge_binned(part[i][0], order[i], bins[bi].copy())
                reads = [(i, s) for i, s in enumerate(streams) if s.reads]
                futs = backend.read_minima(
                    reads, [k], rc, sketch_size, min_count, pool
                )
                for i, _s in reads:
                    merge_binned(part[i][0], order[i], futs[k, i].result())
        mat = np.stack([r for r in results])
        return mat, names_out

    for (name, files), genome_idx in zip(input_files, file_order):
        stream = read_dna_sample(files, min_qual)
        if stream.seq_len == 0:
            raise ValueError(f"Genome {genome_idx} has no valid sequence")
        hashes = nthash_valid(stream, k, rc)
        signs = signs_from_hashes(hashes)
        if stream.reads:
            binned = bin_minima_filtered(signs, sketch_size, min_count)
        else:
            binned = bin_minima(signs, sketch_size)
        merge_binned(name, genome_idx, binned)

    mat = np.stack([r for r in results])
    return mat, names_out
