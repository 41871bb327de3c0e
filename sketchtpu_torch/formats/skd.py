""".skd / .skq flat binary sketch data files.

Byte-compatible with the reference (sketchlib.rust
src/sketch/sketch_datafile.rs):
- .skd: little-endian u64 stream, no header. Sample-major; per sample, for
  each k (ascending), sketchsize64*BBITS words.
- .skq: little-endian u16 stream, sample stride = sketch_size bins.
"""

from __future__ import annotations

import numpy as np


class SketchDataWriter:
    """Serial writer; returns the running sample index for each write,
    mirroring SketchArrayWriter (sketch_datafile.rs:48-96)."""

    def __init__(self, path: str, dtype=np.uint64):
        self._f = open(path, "wb")
        self._dtype = dtype
        self._index = 0

    def write_sketch(self, flat: np.ndarray) -> int:
        arr = np.ascontiguousarray(flat, dtype=self._dtype)
        self._f.write(arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes())
        idx = self._index
        self._index += 1
        return idx

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_all_skd(path: str) -> np.ndarray:
    """Whole-file read of an .skd as a flat uint64 array."""
    data = np.fromfile(path, dtype="<u8")
    return data.astype(np.uint64, copy=False)


def read_all_skq(path: str) -> np.ndarray:
    """Whole-file read of an .skq as a flat uint16 array."""
    return np.fromfile(path, dtype="<u2").astype(np.uint16, copy=False)


def read_skd_batch(path: str, sample_indices, sample_stride: int) -> np.ndarray:
    """Read selected samples (by on-disk index) via memory map, concatenated
    in the given order (sketch_datafile.rs:172-194)."""
    mm = np.memmap(path, dtype="<u8", mode="r")
    out = np.empty(len(sample_indices) * sample_stride, dtype=np.uint64)
    for i, idx in enumerate(sample_indices):
        start = idx * sample_stride
        out[i * sample_stride : (i + 1) * sample_stride] = mm[
            start : start + sample_stride
        ]
    return out


def append_skd(src_path: str, dst_file) -> None:
    """Stream-copy an .skd file into an open binary file object."""
    with open(src_path, "rb") as src:
        while True:
            chunk = src.read(1 << 22)
            if not chunk:
                break
            dst_file.write(chunk)
