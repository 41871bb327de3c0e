"""The writers' native helper (portbench/native/writers.cpp), built by g++
at first use into portbench/_build/ under a name keyed by a hash of its
source, so a changed source is never loaded stale. The directory is fixed
and inside the checkout: only the first run of a checkout builds."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent
SRC = HERE / "native" / "writers.cpp"
BUILD_DIR = HERE / "_build"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_P = ctypes.c_void_p
_SIGNATURES = {
    "pb_snappy_max_compressed": (ctypes.c_size_t, [ctypes.c_size_t]),
    "pb_snappy_frame": (ctypes.c_size_t,
                        [_P, ctypes.c_size_t, _P, ctypes.c_size_t]),
    "pb_ski_bin_msgpack": (ctypes.c_int64,
                           [_P, _P, _P, ctypes.c_int64, _P, ctypes.c_int64]),
}
_lib = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libportbench_writers_{h.hexdigest()[:16]}.so"


def lib() -> ctypes.CDLL:
    """The loaded helper, built first if need be (g++ must be on PATH)."""
    global _lib
    if _lib is None:
        out = library_path()
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(out.name + f".tmp{os.getpid()}")
            subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SRC)],
                           check=True, capture_output=True, timeout=300)
            os.replace(tmp, out)
        handle = ctypes.CDLL(str(out))
        for name, (res, args) in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.restype, fn.argtypes = res, args
        _lib = handle
    return _lib


def snappy_frame(payload: bytes) -> bytes:
    """payload as a snappy framed stream (what snap::FrameEncoder writes)."""
    h = lib()
    n = len(payload)
    chunks = n // 65536 + 1
    cap = 10 + chunks * 8 + h.pb_snappy_max_compressed(65536) * chunks
    out = np.empty(cap, dtype=np.uint8)
    src = np.frombuffer(payload, dtype=np.uint8) if n else np.zeros(1, np.uint8)
    written = h.pb_snappy_frame(src.ctypes.data, n, out.ctypes.data, cap)
    if written == 0:
        raise RuntimeError("snappy framing overflowed its buffer")
    return out[:written].tobytes()
