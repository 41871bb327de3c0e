"""CBOR and MessagePack encoders of the benchmark's frozen writers.

A frozen copy of the subsets the port's formats write (.skm: serde +
ciborium CBOR with definite lengths and minimal-width integers; .ski:
rmp-serde compact MessagePack), from RFC 8949 and the MessagePack
specification, for the types these files hold: null, booleans,
non-negative integers, text, arrays and (CBOR) maps. `Raw` embeds bytes
already encoded (the .ski bins, which the native helper encodes)."""

from __future__ import annotations

from typing import Any


class Raw:
    """Pre-encoded MessagePack bytes, embedded verbatim."""

    __slots__ = ("data",)

    def __init__(self, data: bytes):
        self.data = data


def _cbor_head(major: int, value: int, out: bytearray) -> None:
    if value < 24:
        out.append((major << 5) | value)
    elif value < 1 << 8:
        out += bytes([(major << 5) | 24, value])
    elif value < 1 << 16:
        out.append((major << 5) | 25)
        out += value.to_bytes(2, "big")
    elif value < 1 << 32:
        out.append((major << 5) | 26)
        out += value.to_bytes(4, "big")
    else:
        out.append((major << 5) | 27)
        out += value.to_bytes(8, "big")


def _cbor(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xF6)
    elif obj is True:
        out.append(0xF5)
    elif obj is False:
        out.append(0xF4)
    elif isinstance(obj, int) and obj >= 0:
        _cbor_head(0, obj, out)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _cbor_head(3, len(data), out)
        out += data
    elif isinstance(obj, (list, tuple)):
        _cbor_head(4, len(obj), out)
        for item in obj:
            _cbor(item, out)
    elif isinstance(obj, dict):
        _cbor_head(5, len(obj), out)
        for key, value in obj.items():
            _cbor(key, out)
            _cbor(value, out)
    else:
        raise TypeError(f"cannot CBOR-encode {type(obj)}")


def cbor_dumps(obj: Any) -> bytes:
    out = bytearray()
    _cbor(obj, out)
    return bytes(out)


def _msgpack_len(n: int, fix: int, fix_max: int, b16: int, b32: int,
                 out: bytearray, b8: int | None = None) -> None:
    if n < fix_max:
        out.append(fix | n)
    elif b8 is not None and n < 1 << 8:
        out += bytes([b8, n])
    elif n < 1 << 16:
        out.append(b16)
        out += n.to_bytes(2, "big")
    else:
        out.append(b32)
        out += n.to_bytes(4, "big")


def _msgpack(obj: Any, out: bytearray) -> None:
    if isinstance(obj, Raw):
        out += obj.data
    elif obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int) and obj >= 0:
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
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _msgpack_len(len(data), 0xA0, 32, 0xDA, 0xDB, out, b8=0xD9)
        out += data
    elif isinstance(obj, (list, tuple)):
        _msgpack_len(len(obj), 0x90, 16, 0xDC, 0xDD, out)
        for item in obj:
            _msgpack(item, out)
    else:
        raise TypeError(f"cannot msgpack-encode {type(obj)}")


def msgpack_dumps(obj: Any) -> bytes:
    out = bytearray()
    _msgpack(obj, out)
    return bytes(out)


def msgpack_array_header(n: int) -> bytes:
    out = bytearray()
    _msgpack_len(n, 0x90, 16, 0xDC, 0xDD, out)
    return bytes(out)
