"""Minimal MessagePack codec.

Covers the subset produced/consumed by serde+rmp-serde for the .ski inverted
index container (sketchlib.rust
src/inverted.rs:194-225): ints, strings,
bytes (bin), arrays, maps, nil, bools. rmp-serde's compact mode serializes
structs as positional arrays, unit enum variants as their name string and
newtype variants as single-entry maps; those conventions are applied by the
caller (inverted/index.py), not here.
"""

from __future__ import annotations

import struct
from typing import Any


class Raw:
    """Pre-encoded msgpack bytes embedded verbatim (native fast paths)."""

    __slots__ = ("data",)

    def __init__(self, data: bytes):
        self.data = data


def _encode(obj: Any, out: bytearray) -> None:
    if isinstance(obj, Raw):
        out += obj.data
    elif obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        if obj >= 0:
            if obj < 0x80:
                out.append(obj)
            elif obj < 1 << 8:
                out += bytes([0xCC, obj])
            elif obj < 1 << 16:
                out.append(0xCD)
                out += obj.to_bytes(2, "big")
            elif obj < 1 << 32:
                out.append(0xCE)
                out += obj.to_bytes(4, "big")
            else:
                out.append(0xCF)
                out += obj.to_bytes(8, "big")
        else:
            if obj >= -32:
                out.append(obj & 0xFF)
            elif obj >= -(1 << 7):
                out.append(0xD0)
                out += obj.to_bytes(1, "big", signed=True)
            elif obj >= -(1 << 15):
                out.append(0xD1)
                out += obj.to_bytes(2, "big", signed=True)
            elif obj >= -(1 << 31):
                out.append(0xD2)
                out += obj.to_bytes(4, "big", signed=True)
            else:
                out.append(0xD3)
                out += obj.to_bytes(8, "big", signed=True)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        n = len(data)
        if n < 32:
            out.append(0xA0 | n)
        elif n < 1 << 8:
            out += bytes([0xD9, n])
        elif n < 1 << 16:
            out.append(0xDA)
            out += n.to_bytes(2, "big")
        else:
            out.append(0xDB)
            out += n.to_bytes(4, "big")
        out += data
    elif isinstance(obj, (bytes, bytearray)):
        n = len(obj)
        if n < 1 << 8:
            out += bytes([0xC4, n])
        elif n < 1 << 16:
            out.append(0xC5)
            out += n.to_bytes(2, "big")
        else:
            out.append(0xC6)
            out += n.to_bytes(4, "big")
        out += obj
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        if n < 16:
            out.append(0x90 | n)
        elif n < 1 << 16:
            out.append(0xDC)
            out += n.to_bytes(2, "big")
        else:
            out.append(0xDD)
            out += n.to_bytes(4, "big")
        for item in obj:
            _encode(item, out)
    elif isinstance(obj, dict):
        n = len(obj)
        if n < 16:
            out.append(0x80 | n)
        elif n < 1 << 16:
            out.append(0xDE)
            out += n.to_bytes(2, "big")
        else:
            out.append(0xDF)
            out += n.to_bytes(4, "big")
        for key, value in obj.items():
            _encode(key, out)
            _encode(value, out)
    else:
        raise TypeError(f"cannot msgpack-encode {type(obj)}")


def dumps(obj: Any) -> bytes:
    out = bytearray()
    _encode(obj, out)
    return bytes(out)


def _decode(data: bytes, pos: int):
    b = data[pos]
    pos += 1
    if b < 0x80:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8F:
        return _decode_map(data, pos, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return _decode_array(data, pos, b & 0x0F)
    if 0xA0 <= b <= 0xBF:
        n = b & 0x1F
        return data[pos : pos + n].decode("utf-8"), pos + n
    if b == 0xC0:
        return None, pos
    if b == 0xC2:
        return False, pos
    if b == 0xC3:
        return True, pos
    if b in (0xC4, 0xC5, 0xC6):
        w = 1 << (b - 0xC4)
        n = int.from_bytes(data[pos : pos + w], "big")
        pos += w
        return bytes(data[pos : pos + n]), pos + n
    if b == 0xCA:
        return struct.unpack(">f", data[pos : pos + 4])[0], pos + 4
    if b == 0xCB:
        return struct.unpack(">d", data[pos : pos + 8])[0], pos + 8
    if b in (0xCC, 0xCD, 0xCE, 0xCF):
        w = 1 << (b - 0xCC)
        return int.from_bytes(data[pos : pos + w], "big"), pos + w
    if b in (0xD0, 0xD1, 0xD2, 0xD3):
        w = 1 << (b - 0xD0)
        return int.from_bytes(data[pos : pos + w], "big", signed=True), pos + w
    if b in (0xD9, 0xDA, 0xDB):
        w = 1 << (b - 0xD9)
        n = int.from_bytes(data[pos : pos + w], "big")
        pos += w
        return data[pos : pos + n].decode("utf-8"), pos + n
    if b == 0xDC:
        n = int.from_bytes(data[pos : pos + 2], "big")
        return _decode_array(data, pos + 2, n)
    if b == 0xDD:
        n = int.from_bytes(data[pos : pos + 4], "big")
        return _decode_array(data, pos + 4, n)
    if b == 0xDE:
        n = int.from_bytes(data[pos : pos + 2], "big")
        return _decode_map(data, pos + 2, n)
    if b == 0xDF:
        n = int.from_bytes(data[pos : pos + 4], "big")
        return _decode_map(data, pos + 4, n)
    raise ValueError(f"unsupported msgpack byte {b:#x}")


def _decode_array(data, pos, n):
    items = []
    for _ in range(n):
        item, pos = _decode(data, pos)
        items.append(item)
    return items, pos


def _decode_map(data, pos, n):
    result = {}
    for _ in range(n):
        key, pos = _decode(data, pos)
        value, pos = _decode(data, pos)
        result[key] = value
    return result, pos


def loads(data: bytes) -> Any:
    obj, _ = _decode(data, 0)
    return obj
