"""FASTA/FASTQ ingestion of DNA into packed base-code streams, and of
amino-acid (or 3Di) FASTA into raw residue streams.

Mirrors the observable behaviour of the reference's sequence preprocessing
(sketchlib.rust src/hashing/nthash_iterator.rs:204-251 add_dna_seq):
invalid bases and record boundaries become *breaks* in the stream (k-mers
never span a break), valid DNA bases are 2-bit encoded with
(ascii >> 1) & 3, and base/quality filtering happens at parse time.

The output is a NumPy-first representation suitable for feeding the device
hashers: a dense array of base codes plus a sorted array of break positions
in valid-base coordinates.
"""

from __future__ import annotations

import gzip
import io
from dataclasses import dataclass, field

import numpy as np

from ..constants import SEQSEP

# (ascii >> 1) & 3 gives A=0, C=1, T=2, G=3 (U behaves as T).
_VALID_DNA = np.zeros(256, dtype=bool)
for _b in b"acgtuACGTU":
    _VALID_DNA[_b] = True
_ENCODE_DNA = (np.arange(256, dtype=np.uint8) >> 1) & 3

# Valid IUPAC amino-acid letters (src/hashing/aahash_iterator.rs:10-13).
_VALID_AA = np.zeros(256, dtype=bool)
for _c in b"acdefghiklmnpqrstvwyACDEFGHIKLMNPQRSTVWY":
    _VALID_AA[_c] = True


def open_maybe_gzip(path: str) -> io.BufferedReader:
    f = open(path, "rb")
    magic = f.peek(2)[:2]
    if magic == b"\x1f\x8b":
        return io.BufferedReader(gzip.GzipFile(fileobj=f))  # type: ignore[arg-type]
    return f


def _sniff_format(path: str) -> str:
    with open_maybe_gzip(path) as f:
        first = f.read(1)
    if first == b">":
        return "fasta"
    if first == b"@":
        return "fastq"
    raise ValueError(f"Invalid FASTA/Q record in {path}")


def iter_fastx(path: str):
    """Yield (seq_bytes, qual_bytes_or_None) records from a fast[aq][.gz] file."""
    fmt = _sniff_format(path)
    with open_maybe_gzip(path) as f:
        if fmt == "fasta":
            seq_parts: list[bytes] = []
            started = False
            for line in f:
                line = line.strip()
                if not line:
                    continue
                if line.startswith(b">"):
                    if started:
                        yield b"".join(seq_parts), None
                        seq_parts = []
                    started = True
                else:
                    seq_parts.append(line)
            if started:
                yield b"".join(seq_parts), None
        else:
            while True:
                header = f.readline()
                if not header:
                    break
                header = header.strip()
                if not header:
                    continue
                if not header.startswith(b"@"):
                    raise ValueError(f"Invalid FASTQ record in {path}")
                seq = f.readline().strip()
                plus = f.readline()
                if not plus.startswith(b"+"):
                    raise ValueError(f"Invalid FASTQ record in {path}")
                qual = f.readline().strip()
                if len(qual) != len(seq):
                    raise ValueError(f"Invalid FASTQ record in {path}")
                yield seq, qual


@dataclass
class DnaStream:
    """A sample's concatenated DNA as base codes with break positions."""

    codes: np.ndarray = field(
        default_factory=lambda: np.zeros(0, dtype=np.uint8)
    )  # values 0..3, valid bases only
    breaks: np.ndarray = field(
        default_factory=lambda: np.zeros(0, dtype=np.int64)
    )  # positions (valid-base coords) where a k-mer window may not cross
    acgt: np.ndarray = field(default_factory=lambda: np.zeros(4, dtype=np.int64))
    non_acgt: int = 0
    reads: bool = False

    @property
    def seq_len(self) -> int:
        return int(self.codes.shape[0])


# byte -> 2-bit code for the native parser; invalid bytes -> 255
_ENC_NATIVE = np.where(_VALID_DNA, _ENCODE_DNA, np.uint8(255))


def _parse_dna_native_bytes(lib, raw: bytes, fmt: int, min_qual: int):
    """One C++ state-machine call over a byte buffer. The call releases the
    GIL and writes only to caller-owned buffers, so ranges of one file can
    parse concurrently."""
    import ctypes

    n = len(raw)
    codes = np.empty(n + 1, dtype=np.uint8)
    breaks = np.empty(n + 2, dtype=np.int64)
    acgt = np.zeros(4, dtype=np.int64)
    n_codes = ctypes.c_int64()
    n_breaks = ctypes.c_int64()
    non_acgt = ctypes.c_int64()
    rc = lib.stpu_parse_dna(
        raw,
        n,
        fmt,
        _ENC_NATIVE.ctypes.data,
        min_qual if fmt == 1 else 0,
        codes.ctypes.data,
        breaks.ctypes.data,
        ctypes.byref(n_codes),
        ctypes.byref(n_breaks),
        acgt.ctypes.data_as(ctypes.c_void_p),
        ctypes.byref(non_acgt),
    )
    if rc != 0:
        return None
    return (
        codes[: n_codes.value].copy(),
        breaks[: n_breaks.value].copy(),
        acgt,
        int(non_acgt.value),
    )


# a FASTA file below this parses in one native call (the split's chunk
# copies + merge cost more than they save)
_PAR_MIN_BYTES = 4 << 20


def _fasta_ranges(raw: bytes, parts: int) -> list[tuple[int, int]]:
    """Record-aligned byte ranges covering the whole buffer: every range
    after the first starts at a '>' that follows a newline, so each parses
    independently (the parser emits an end-of-record break per record, so
    range results concatenate exactly — the same property the multi-file
    merge already relies on)."""
    n = len(raw)
    target = n // parts
    starts = [0]
    for i in range(1, parts):
        guess = max(i * target, starts[-1] + 1)
        pos = raw.find(b"\n>", guess - 1)
        if pos == -1:
            break
        if pos + 1 > starts[-1]:
            starts.append(pos + 1)
    return [
        (s, starts[i + 1] if i + 1 < len(starts) else n)
        for i, s in enumerate(starts)
    ]


def _merge_parsed(parts: list[tuple]) -> tuple:
    """Concatenate per-range (codes, breaks, acgt, non_acgt) results,
    offsetting break positions — identical to the multi-file merge in
    read_dna_sample."""
    code_parts, break_parts = [], []
    acgt = np.zeros(4, dtype=np.int64)
    non_acgt = 0
    base = 0
    for codes_f, breaks_f, acgt_f, na_f in parts:
        code_parts.append(codes_f)
        break_parts.append(breaks_f + base)
        acgt += acgt_f
        non_acgt += na_f
        base += codes_f.shape[0]
    return (
        np.concatenate(code_parts) if code_parts else np.zeros(0, np.uint8),
        np.concatenate(break_parts) if break_parts else np.zeros(0, np.int64),
        acgt,
        non_acgt,
    )


def _parse_dna_native(path: str, min_qual: int, threads: int = 1) -> tuple | None:
    """Single-file parse via the C++ state machine (the per-line Python loop
    is the host bottleneck at scale). Large plain FASTA files split into
    record-aligned byte ranges parsed concurrently when threads > 1 (the
    reference's rayon parallelism is over samples only,
    nthash_iterator.rs:94-145 — one big file is single-core there).
    Returns (codes, breaks, acgt, non_acgt) or None to fall back
    (malformed input, whose error messages come from the Python
    parser)."""
    from .._native import lib as native_lib

    lib = native_lib()
    with open_maybe_gzip(path) as f:
        raw = f.read()
    first = raw[:1]
    if first == b">":
        fmt = 0
    elif first == b"@":
        fmt = 1
    else:
        raise ValueError(f"Invalid FASTA/Q record in {path}")
    if fmt == 0 and threads > 1 and len(raw) > _PAR_MIN_BYTES:
        ranges = _fasta_ranges(raw, min(threads, len(raw) // _PAR_MIN_BYTES + 1))
        if len(ranges) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=len(ranges)) as pool:
                parts = list(
                    pool.map(
                        lambda se: _parse_dna_native_bytes(
                            lib, raw[se[0] : se[1]], 0, 0
                        ),
                        ranges,
                    )
                )
            if all(p is not None for p in parts):
                return _merge_parsed(parts)
            return None  # malformed mid-file: Python parser owns the error
    return _parse_dna_native_bytes(lib, raw, fmt, min_qual)


def read_dna_sample(
    files: list[str], min_qual: int = 0, threads: int = 1
) -> DnaStream:
    """Read one sample's file set into a DnaStream.

    Matches NtHashIterator::new (nthash_iterator.rs:94-145): the reads flag is
    sniffed from the first record of the first file; reads with more than two
    input files are an error; low-quality bases count as invalid (the quality
    comparison is against the raw PHRED+33 byte, as in the reference,
    nthash_iterator.rs:225). threads > 1 parallelises within large FASTA
    files (record-aligned ranges); results are identical either way.
    """
    reads = _sniff_format(files[0]) == "fastq"
    if reads and len(files) > 2:
        raise ValueError(
            "Input files are reads, but there are more than two input files"
        )

    native_parts = []
    for path in files:
        parsed = _parse_dna_native(path, min_qual, threads=threads)
        if parsed is None:
            native_parts = None
            break
        native_parts.append(parsed)
    if native_parts is not None:
        code_parts = []
        break_parts = []
        acgt = np.zeros(4, dtype=np.int64)
        non_acgt = 0
        base_count = 0
        for codes_f, breaks_f, acgt_f, na_f in native_parts:
            code_parts.append(codes_f)
            break_parts.append(breaks_f + base_count)
            acgt += acgt_f
            non_acgt += na_f
            base_count += codes_f.shape[0]
        return DnaStream(
            codes=(
                np.concatenate(code_parts)
                if code_parts
                else np.zeros(0, dtype=np.uint8)
            ),
            breaks=(
                np.concatenate(break_parts)
                if break_parts
                else np.zeros(0, dtype=np.int64)
            ),
            acgt=acgt,
            non_acgt=non_acgt,
            reads=reads,
        )

    code_parts: list[np.ndarray] = []
    break_parts: list[np.ndarray] = []
    acgt = np.zeros(4, dtype=np.int64)
    non_acgt = 0
    base_count = 0  # running count of valid bases

    for path in files:
        for seq, qual in iter_fastx(path):
            arr = np.frombuffer(seq, dtype=np.uint8)
            valid = _VALID_DNA[arr]
            if qual is not None and min_qual > 0:
                qarr = np.frombuffer(qual, dtype=np.uint8)
                valid = valid & (qarr >= min_qual)
            codes = _ENCODE_DNA[arr[valid]]
            n_valid = codes.shape[0]
            n_invalid = arr.shape[0] - n_valid
            if n_valid:
                counts = np.bincount(codes, minlength=4)
                acgt += counts
            non_acgt += int(n_invalid)
            # Break positions: for each invalid base, the number of valid
            # bases seen before it; plus an end-of-record break.
            if n_invalid:
                invalid_pos = np.flatnonzero(~valid)
                # number of valid bases before each invalid one
                valid_cum = np.cumsum(valid)
                rel = np.where(invalid_pos > 0, valid_cum[invalid_pos - 1], 0)
                break_parts.append(base_count + rel.astype(np.int64))
            code_parts.append(codes)
            base_count += n_valid
            break_parts.append(np.array([base_count], dtype=np.int64))

    codes = (
        np.concatenate(code_parts) if code_parts else np.zeros(0, dtype=np.uint8)
    )
    breaks = (
        np.concatenate(break_parts) if break_parts else np.zeros(0, dtype=np.int64)
    )
    return DnaStream(
        codes=codes,
        breaks=breaks,
        acgt=acgt,
        non_acgt=non_acgt,
        reads=reads,
    )


@dataclass
class AaStream:
    """A sample's amino-acid sequence, kept as raw bytes with SEQSEP markers.

    Unlike DNA, the reference keeps invalid residues in-stream as SEQSEP
    bytes (aahash_iterator.rs:100-107), and appends SEQSEP after each record
    unless concat_fasta splits records into separate samples.
    """

    seq: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.uint8))
    invalid_count: int = 0

    @property
    def seq_len(self) -> int:
        return int(self.seq.shape[0])


def _refuse_fastq(path: str):
    raise ValueError(
        f"Unexpected quality information with AA sequences in {path}. "
        "Correct sequence type set?"
    )


def _parse_aa_native(path: str) -> tuple | None:
    """(residues with invalid bytes -> SEQSEP, record end offsets, invalid
    count) of one file via the C++ parser, or None to fall back
    (malformed input, whose error messages come from the Python
    parser)."""
    import ctypes

    from .._native import lib as native_lib

    lib = native_lib()
    with open_maybe_gzip(path) as f:
        raw = f.read()
    if raw[:1] == b"@":
        _refuse_fastq(path)
    n = len(raw)
    seq = np.empty(n + 1, dtype=np.uint8)
    rec_off = np.empty(n + 2, dtype=np.int64)
    n_seq = ctypes.c_int64()
    n_rec = ctypes.c_int64()
    invalid = ctypes.c_int64()
    rc = lib.stpu_parse_aa(
        raw,
        n,
        _VALID_AA.ctypes.data,
        SEQSEP,
        seq.ctypes.data,
        rec_off.ctypes.data,
        ctypes.byref(n_seq),
        ctypes.byref(n_rec),
        ctypes.byref(invalid),
    )
    if rc != 0:
        return None
    return seq[: n_seq.value], rec_off[: n_rec.value], invalid.value


def read_aa_sample(files: list[str], concat_fasta: bool) -> list[AaStream]:
    """Read amino-acid fasta file(s) -> one AaStream (or one per record when
    concat_fasta). Mirrors AaHashIterator::new (aahash_iterator.rs:84-124):
    without concat_fasta every record is followed by one SEQSEP."""
    parsed = []
    for path in files:
        one = _parse_aa_native(path)
        if one is None:
            return _read_aa_python(files, concat_fasta)
        parsed.append(one)
    if concat_fasta:
        out = []
        for seq, ends, _invalid in parsed:
            start = 0
            for end in ends.tolist():
                rec = seq[start:end].copy()
                out.append(AaStream(seq=rec,
                                    invalid_count=int((rec == SEQSEP).sum())))
                start = end
        return out
    parts = [np.insert(seq, ends, np.uint8(SEQSEP))
             for seq, ends, _invalid in parsed]
    return [AaStream(
        seq=np.concatenate(parts) if parts else np.zeros(0, dtype=np.uint8),
        invalid_count=sum(invalid for _s, _e, invalid in parsed))]


def _read_aa_python(files: list[str], concat_fasta: bool) -> list[AaStream]:
    """read_aa_sample without the native parser (identical streams)."""
    out = []
    parts = []
    invalid = 0
    for path in files:
        if _sniff_format(path) == "fastq":
            _refuse_fastq(path)
        for seq, _ in iter_fastx(path):
            arr = np.frombuffer(seq, dtype=np.uint8).copy()
            bad = ~_VALID_AA[arr]
            invalid += int(bad.sum())
            arr[bad] = SEQSEP
            if concat_fasta:
                out.append(AaStream(seq=arr, invalid_count=invalid))
                invalid = 0
            else:
                parts.append(arr)
                parts.append(np.array([SEQSEP], dtype=np.uint8))
    if not concat_fasta:
        seq = np.concatenate(parts) if parts else np.zeros(0, dtype=np.uint8)
        out.append(AaStream(seq=seq, invalid_count=invalid))
    return out


def aa_stream_from_string(sequence: str) -> AaStream:
    """3Di string -> AaStream (no trailing separator), matching
    AaHashIterator::from_3di_string (aahash_iterator.rs:132-136).

    Invalid characters are not replaced here (the reference stores the raw
    bytes); hashing treats any non-AA byte as a break.
    """
    arr = np.frombuffer(sequence.encode(), dtype=np.uint8).copy()
    return AaStream(seq=arr, invalid_count=0)
