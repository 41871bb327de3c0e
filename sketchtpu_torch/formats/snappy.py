"""Snappy codec: raw block format and framing format.

The reference stores .skm (CBOR) payloads inside snappy *framed* streams
(snap::write::FrameEncoder, sketchlib.rust
src/sketch/multisketch.rs:84-95).
Implemented here from the public format descriptions
(google/snappy format_description.txt and framing_format.txt).

The host helper (csrc/host/native.cpp) does the codec's work; a framed
stream it declines (a malformed one, whose error text is Python's) is
walked chunk by chunk here.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from .. import _native, spans
from .._native import run_split

_STREAM_IDENTIFIER = b"\xff\x06\x00\x00sNaPpY"
_CHUNK_COMPRESSED = 0x00
_CHUNK_UNCOMPRESSED = 0x01
_CHUNK_PADDING = 0xFE
_MAX_UNCOMPRESSED_CHUNK = 65536


def crc32c(data: bytes) -> int:
    lib = _native.lib()
    return lib.stpu_crc32c(data, len(data), 0)


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --- raw block format ---


def _read_varint(data, pos):
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def decompress_raw(data: bytes) -> bytes:
    """Decompress a snappy raw block."""
    ulen, _pos = _read_varint(data, 0)
    out = ctypes.create_string_buffer(max(ulen, 1))
    lib = _native.lib()
    n = lib.stpu_snappy_decompress(data, len(data), out, ulen)
    if n == ctypes.c_size_t(-1).value:
        raise ValueError("malformed snappy block")
    return out.raw[:n]


def compress_raw(data: bytes) -> bytes:
    """Compress to a snappy raw block."""
    lib = _native.lib()
    cap = lib.stpu_snappy_max_compressed(len(data))
    out = ctypes.create_string_buffer(cap)
    n = lib.stpu_snappy_compress(data, len(data), out, cap)
    if n == 0:  # cap is the format's bound
        raise RuntimeError("snappy compression overflowed its buffer")
    return out.raw[:n]


# --- framing format ---


def frame_compress(data: bytes) -> bytes:
    """Compress into a snappy framed stream (what snap::FrameEncoder writes)."""
    out = bytearray(_STREAM_IDENTIFIER)
    pos = 0
    data = bytes(data)
    while pos < len(data) or pos == 0 == len(data):
        chunk = data[pos : pos + _MAX_UNCOMPRESSED_CHUNK]
        pos += len(chunk)
        crc = _masked_crc(chunk)
        compressed = compress_raw(chunk)
        if len(compressed) < len(chunk):
            body = struct.pack("<I", crc) + compressed
            out.append(_CHUNK_COMPRESSED)
        else:
            body = struct.pack("<I", crc) + chunk
            out.append(_CHUNK_UNCOMPRESSED)
        out += len(body).to_bytes(3, "little")
        out += body
        if pos >= len(data):
            break
    return bytes(out)


def frame_decompress(data: bytes, verify_checksums: bool = True,
                     workers: int | None = None) -> bytes:
    """Decompress a snappy framed stream. Checksums are verified by
    default, like the reference's snap::FrameDecoder — corruption then
    fails here with a clear error instead of surfacing as a confusing
    CBOR/msgpack decode failure (or silently wrong metadata). The host
    helper decodes the whole stream, its chunks split over `workers`
    threads (default _native.WORKERS); a stream it leaves, and any
    error, takes the Python path. Counts `native`: the data chunks the
    helper decoded (0: the Python path)."""
    native = _frame_decompress_native(data, verify_checksums, workers)
    spans.count("native", 0 if native is None else native[1])
    if native is not None:
        return native[0]
    return _frame_decompress_py(data, verify_checksums)


# a new bytes object of n bytes, left for the caller to fill (the C API's
# PyBytes_FromStringAndSize(NULL, n)): the helper writes the payload into
# it, with no copy after
_new_bytes = ctypes.pythonapi.PyBytes_FromStringAndSize
_new_bytes.restype = ctypes.py_object
_new_bytes.argtypes = (ctypes.c_char_p, ctypes.c_ssize_t)


def _frame_decompress_native(data, verify: bool, workers: int | None):
    """(payload, data chunks) from the host helper, or None where it
    declines the stream."""
    lib = _native.lib()
    buf = np.frombuffer(data, np.uint8)
    base = buf.ctypes.data
    total = ctypes.c_int64()
    chunks = lib.stpu_snappy_frame_scan(base, buf.size, None,
                                        ctypes.byref(total))
    if chunks < 0:
        return None
    info = np.empty((chunks, 4), np.int64)
    lib.stpu_snappy_frame_scan(base, buf.size, info.ctypes.data,
                               ctypes.byref(total))
    out = _new_bytes(None, total.value) if total.value else b""
    ok = run_split(
        lambda lo, hi: lib.stpu_snappy_frame_chunks(
            base, info.ctypes.data, lo, hi, out, int(verify)) == 0,
        chunks, workers, least=8)
    return (out, chunks) if all(ok) else None


def _frame_decompress_py(data: bytes, verify_checksums: bool) -> bytes:
    if data[: len(_STREAM_IDENTIFIER)] != _STREAM_IDENTIFIER:
        raise ValueError("not a snappy framed stream")
    pos = len(_STREAM_IDENTIFIER)
    out = bytearray()
    n = len(data)
    while pos < n:
        ctype = data[pos]
        length = int.from_bytes(data[pos + 1 : pos + 4], "little")
        body = data[pos + 4 : pos + 4 + length]
        pos += 4 + length
        if ctype == _CHUNK_COMPRESSED:
            crc = struct.unpack("<I", body[:4])[0]
            chunk = decompress_raw(body[4:])
        elif ctype == _CHUNK_UNCOMPRESSED:
            crc = struct.unpack("<I", body[:4])[0]
            chunk = body[4:]
        elif ctype == _CHUNK_PADDING or 0x80 <= ctype <= 0xFD:
            continue
        elif ctype == 0xFF:  # repeated stream identifier
            continue
        else:
            raise ValueError(f"unskippable unknown chunk type 0x{ctype:02x}")
        if verify_checksums and _masked_crc(chunk) != crc:
            raise ValueError("snappy frame checksum mismatch")
        out += chunk
    return bytes(out)
