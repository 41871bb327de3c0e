"""Roaring bitmap portable serialization.

Implements the public RoaringFormatSpec
(https://github.com/RoaringBitmap/RoaringFormatSpec), which is the byte
format roaring-rs writes for RoaringBitmap values embedded in .ski files
(roaring 0.10 "serde" feature serializes via serialize_into ->
serialize_bytes). Writing emits the no-run-container layout (cookie 12346),
as roaring-rs does; reading accepts both cookies including run containers.

Bitmaps are represented in Python as sorted numpy uint32 arrays.
"""

from __future__ import annotations

import numpy as np

SERIAL_COOKIE_NO_RUNCONTAINER = 12346
SERIAL_COOKIE = 12347
NO_OFFSET_THRESHOLD = 4
ARRAY_LIMIT = 4096


def serialize(values: np.ndarray) -> bytes:
    """Sorted unique uint32 values -> portable roaring bytes."""
    values = np.asarray(values, dtype=np.uint32)
    keys = (values >> np.uint32(16)).astype(np.uint16)
    lows = (values & np.uint32(0xFFFF)).astype(np.uint16)
    uniq_keys, starts = np.unique(keys, return_index=True)
    n_containers = uniq_keys.shape[0]
    boundaries = np.append(starts, values.shape[0])

    header = bytearray()
    header += int(SERIAL_COOKIE_NO_RUNCONTAINER).to_bytes(4, "little")
    header += int(n_containers).to_bytes(4, "little")
    containers = []
    for ci in range(n_containers):
        lo = lows[boundaries[ci] : boundaries[ci + 1]]
        card = lo.shape[0]
        header += int(uniq_keys[ci]).to_bytes(2, "little")
        header += int(card - 1).to_bytes(2, "little")
        if card <= ARRAY_LIMIT:
            containers.append(lo.astype("<u2").tobytes())
        else:
            bits = np.zeros(1024, dtype="<u8")
            word = lo.astype(np.uint32) >> np.uint32(6)
            bit = lo.astype(np.uint32) & np.uint32(63)
            np.bitwise_or.at(bits, word, np.uint64(1) << bit.astype(np.uint64))
            containers.append(bits.tobytes())

    # offset header: byte position of each container from stream start
    offset_base = len(header) + 4 * n_containers
    offsets = bytearray()
    pos = offset_base
    for c in containers:
        offsets += int(pos).to_bytes(4, "little")
        pos += len(c)
    return bytes(header) + bytes(offsets) + b"".join(containers)


def deserialize(data: bytes) -> np.ndarray:
    """Portable roaring bytes -> sorted numpy uint32 array."""
    cookie = int.from_bytes(data[0:4], "little")
    pos = 4
    has_runs = False
    run_bitset = b""
    if cookie & 0xFFFF == SERIAL_COOKIE:
        size = (cookie >> 16) + 1
        has_runs = True
        nbytes = (size + 7) // 8
        run_bitset = data[pos : pos + nbytes]
        pos += nbytes
    elif cookie == SERIAL_COOKIE_NO_RUNCONTAINER:
        size = int.from_bytes(data[4:8], "little")
        pos = 8
    else:
        raise ValueError(f"not a roaring bitmap (cookie {cookie})")

    keys = np.empty(size, dtype=np.uint32)
    cards = np.empty(size, dtype=np.int64)
    for i in range(size):
        keys[i] = int.from_bytes(data[pos : pos + 2], "little")
        cards[i] = int.from_bytes(data[pos + 2 : pos + 4], "little") + 1
        pos += 4

    if not has_runs or size >= NO_OFFSET_THRESHOLD:
        pos += 4 * size  # skip offset header

    out_parts = []
    for i in range(size):
        is_run = has_runs and bool(run_bitset[i // 8] & (1 << (i % 8)))
        if is_run:
            n_runs = int.from_bytes(data[pos : pos + 2], "little")
            pos += 2
            runs = np.frombuffer(data[pos : pos + 4 * n_runs], dtype="<u2").reshape(
                n_runs, 2
            )
            pos += 4 * n_runs
            lows = np.concatenate(
                [
                    np.arange(int(s), int(s) + int(l) + 1, dtype=np.uint32)
                    for s, l in runs
                ]
            ) if n_runs else np.zeros(0, dtype=np.uint32)
        elif cards[i] <= ARRAY_LIMIT:
            lows = np.frombuffer(
                data[pos : pos + 2 * cards[i]], dtype="<u2"
            ).astype(np.uint32)
            pos += 2 * int(cards[i])
        else:
            bits = np.frombuffer(data[pos : pos + 8192], dtype="<u8")
            pos += 8192
            lows = np.flatnonzero(
                np.unpackbits(
                    bits.view(np.uint8), bitorder="little"
                )
            ).astype(np.uint32)
        out_parts.append((keys[i] << np.uint32(16)) | lows)
    if not out_parts:
        return np.zeros(0, dtype=np.uint32)
    return np.concatenate(out_parts)
