"""ctypes loader for the host helper library, csrc/host/native.cpp.

g++ compiles it at first use into `_build/` under a name keyed by a hash of
the source, so a stale build is never loaded; concurrent processes wait
for one compile (`_build.build_lock`). The port needs it as it needs its
kernels: lib() raises with g++'s output when it does not build, as
`_build.lib()` does with nvcc's. run_split runs a helper's call over
ranges of its work on threads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent
_SRC = _PKG / "csrc" / "host" / "native.cpp"
_BUILD_DIR = _PKG / "_build"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

# threads for the helper's calls that split their work (a ctypes call
# releases the GIL): dist/output.py's text, the snappy frame, the .ski bins
WORKERS = min(8, os.cpu_count() or 1)

_lock = threading.Lock()
_loaded = None

_P = ctypes.c_void_p
_I64 = ctypes.c_int64

# (restype, argtypes) of every entry point
_SIGNATURES = {
    "stpu_crc32c": (ctypes.c_uint32,
                    [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint32]),
    "stpu_snappy_max_compressed": (ctypes.c_size_t, [ctypes.c_size_t]),
    "stpu_snappy_compress": (ctypes.c_size_t,
                             [ctypes.c_char_p, ctypes.c_size_t, _P,
                              ctypes.c_size_t]),
    "stpu_snappy_decompress": (ctypes.c_size_t,
                               [ctypes.c_char_p, ctypes.c_size_t, _P,
                                ctypes.c_size_t]),
    "stpu_filter_bin_signs": (None,
                              [_P, ctypes.c_size_t, ctypes.c_uint16,
                               ctypes.c_uint64, _P, ctypes.c_size_t]),
    "stpu_bin_signs": (None,
                       [_P, ctypes.c_size_t, ctypes.c_uint64, _P,
                        ctypes.c_size_t]),
    "stpu_parse_dna": (ctypes.c_int,
                       [ctypes.c_char_p, _I64, ctypes.c_int, _P, ctypes.c_int,
                        _P, _P, _P, _P, _P, _P]),
    "stpu_parse_aa": (ctypes.c_int,
                      [ctypes.c_char_p, _I64, _P, ctypes.c_uint8, _P, _P, _P,
                       _P, _P]),
    "stpu_format_dist_lines": (_I64,
                               [ctypes.c_char_p, _P, ctypes.c_char_p, _P, _P,
                                _P, _P, _P, _I64, _P, _I64]),
    "stpu_ski_bin_msgpack": (_I64, [_P, _P, _P, _I64, _P, _I64]),
    "stpu_crc32c_table": (ctypes.c_uint32,
                          [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint32]),
    "stpu_snappy_frame_scan": (_I64, [_P, _I64, _P, _P]),
    "stpu_snappy_frame_chunks": (_I64, [_P, _P, _I64, _I64, ctypes.c_char_p,
                                        ctypes.c_int]),
    "stpu_ski_bins_scan": (_I64, [_P, _I64, _P, _I64]),
    "stpu_ski_bins_fill": (_I64, [_P, _P, _I64, _I64, _I64, _P]),
    "stpu_transpose_u16": (None, [_P, _I64, _I64, _P, _I64, _I64]),
    "stpu_msgpack_strs": (_I64, [_P, _I64, _I64, _P, _P, _P]),
    "stpu_skm_decode": (_P, [ctypes.c_char_p, _I64, _P]),
    "stpu_skm_columns": (None, [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P]),
    "stpu_skm_free": (None, [_P]),
}


def library_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return _BUILD_DIR / f"libsketchtpu_host_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    """g++ the helper into `out` unless another process built it while
    this one waited for the build directory's lock. It compiles to a
    process-unique temp path and os.replace's it into place, so that
    nothing ever CDLLs a half-linked file."""
    from ._build import build_lock

    with build_lock(_BUILD_DIR):
        if out.exists():
            return
        tmp = out.with_suffix(f".so.tmp.{os.getpid()}")
        cmd = ["g++", *_FLAGS, "-o", str(tmp), str(_SRC)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=120)
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(f"g++ could not build the host helper "
                               f"{_SRC}: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed ({proc.returncode}) on the host "
                               f"helper {_SRC}:\n{proc.stderr[-4000:]}")
        os.replace(tmp, out)


def lib() -> ctypes.CDLL:
    """The loaded host helper (built on first call)."""
    global _loaded
    with _lock:
        if _loaded is None:
            out = library_path()
            if not out.exists():
                _compile(out)
            handle = ctypes.CDLL(str(out))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _loaded = handle
        return _loaded


def run_split(call, n: int, workers: int | None = None, least: int = 1) -> list:
    """call(lo, hi) over [0, n) in contiguous ranges of `least` items or
    more, at most `workers` of them (default WORKERS), each range on a
    thread of its own; the results in the ranges' order."""
    parts = max(1, min(WORKERS if workers is None else workers, n // least))
    bounds = [n * i // parts for i in range(parts + 1)]
    ranges = list(zip(bounds, bounds[1:]))
    if parts == 1:
        return [call(*ranges[0])]
    with ThreadPoolExecutor(parts) as pool:
        return list(pool.map(lambda r: call(*r), ranges))
