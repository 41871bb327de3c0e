"""Minimal CBOR (RFC 8949) codec.

Covers the subset produced/consumed by serde+ciborium for the .skm metadata
container (sketchlib.rust src/sketch/multisketch.rs:80-103): unsigned /
negative integers, byte and text strings, arrays, maps, null, bools and
floats. Encoding uses definite lengths and minimal-width integers, which is
what ciborium emits; decoding additionally accepts indefinite-length items.
"""

from __future__ import annotations

import struct
from typing import Any


def _encode_head(major: int, value: int, out: bytearray) -> None:
    if value < 24:
        out.append((major << 5) | value)
    elif value < 1 << 8:
        out.append((major << 5) | 24)
        out.append(value)
    elif value < 1 << 16:
        out.append((major << 5) | 25)
        out += value.to_bytes(2, "big")
    elif value < 1 << 32:
        out.append((major << 5) | 26)
        out += value.to_bytes(4, "big")
    else:
        out.append((major << 5) | 27)
        out += value.to_bytes(8, "big")


def _encode(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xF6)
    elif obj is True:
        out.append(0xF5)
    elif obj is False:
        out.append(0xF4)
    elif isinstance(obj, int):
        if obj >= 0:
            _encode_head(0, obj, out)
        else:
            _encode_head(1, -1 - obj, out)
    elif isinstance(obj, float):
        out.append(0xFB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, bytes):
        _encode_head(2, len(obj), out)
        out += obj
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _encode_head(3, len(data), out)
        out += data
    elif isinstance(obj, (list, tuple)):
        _encode_head(4, len(obj), out)
        for item in obj:
            _encode(item, out)
    elif isinstance(obj, dict):
        _encode_head(5, len(obj), out)
        for key, value in obj.items():
            _encode(key, out)
            _encode(value, out)
    else:
        raise TypeError(f"cannot CBOR-encode {type(obj)}")


def dumps(obj: Any) -> bytes:
    out = bytearray()
    _encode(obj, out)
    return bytes(out)


_BREAK = object()


def _decode(data: bytes, pos: int):
    initial = data[pos]
    pos += 1
    major = initial >> 5
    info = initial & 0x1F
    if initial == 0xFF:
        return _BREAK, pos

    length = None
    if info < 24:
        arg = info
    elif info == 24:
        arg = data[pos]
        pos += 1
    elif info == 25:
        arg = int.from_bytes(data[pos : pos + 2], "big")
        pos += 2
    elif info == 26:
        arg = int.from_bytes(data[pos : pos + 4], "big")
        pos += 4
    elif info == 27:
        arg = int.from_bytes(data[pos : pos + 8], "big")
        pos += 8
    elif info == 31:
        arg = None  # indefinite
    else:
        raise ValueError(f"reserved CBOR additional info {info}")

    if major == 0:
        return arg, pos
    if major == 1:
        return -1 - arg, pos
    if major == 2 or major == 3:
        if arg is None:  # indefinite string: concatenation of chunks
            chunks = []
            while True:
                item, pos = _decode(data, pos)
                if item is _BREAK:
                    break
                chunks.append(item if isinstance(item, bytes) else item.encode())
            raw = b"".join(chunks)
        else:
            raw = data[pos : pos + arg]
            pos += arg
        return (raw if major == 2 else raw.decode("utf-8")), pos
    if major == 4:
        items = []
        if arg is None:
            while True:
                item, pos = _decode(data, pos)
                if item is _BREAK:
                    break
                items.append(item)
        else:
            for _ in range(arg):
                item, pos = _decode(data, pos)
                items.append(item)
        return items, pos
    if major == 5:
        result = {}
        if arg is None:
            while True:
                key, pos = _decode(data, pos)
                if key is _BREAK:
                    break
                value, pos = _decode(data, pos)
                result[key] = value
        else:
            for _ in range(arg):
                key, pos = _decode(data, pos)
                value, pos = _decode(data, pos)
                result[key] = value
        return result, pos
    if major == 6:  # tag: decode and discard the tag number
        return _decode(data, pos)
    # major 7
    if info == 20:
        return False, pos
    if info == 21:
        return True, pos
    if info == 22 or info == 23:
        return None, pos
    if info == 25:
        (value,) = struct.unpack(">e", data[pos - 2 : pos])
        return value, pos
    if info == 26:
        (value,) = struct.unpack(">f", data[pos - 4 : pos])
        return value, pos
    if info == 27:
        (value,) = struct.unpack(">d", data[pos - 8 : pos])
        return value, pos
    if info < 20:
        return arg, pos  # simple value
    raise ValueError(f"unsupported CBOR item {initial:#x}")


def loads(data: bytes, pos: int = 0) -> Any:
    """The item that starts at byte pos of data."""
    obj, _end = _decode(data, pos)
    return obj
