"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Every `csrc/*.cu` file compiles into ONE shared library with a plain C
interface (no PyTorch headers, so a cold build takes seconds). The library
lands in `_build/` under a name keyed by a hash of the sources and the
flags, and is built at first use: a fresh checkout needs nothing but
`nvcc`. Nothing here runs at import time, so `import sketchtpu_torch` works
on a machine with no CUDA toolkit; the CPU twins never reach this module.

Each C entry point takes device pointers, sizes and the CUDA stream, and
returns the `cudaError_t` of its launch; callers raise on a non-zero value.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # keep a*b+c as two roundings, like the plain PyTorch twins, so the
    # f32 core/accessory chain agrees with its twin to the last bit
    "--fmad=false",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_ULL = ctypes.c_ulonglong
_F = ctypes.c_float

# C signature of every entry point (restype int: the launch's cudaError_t)
_SIGNATURES = {
    "stpu_samebits": (_P, _LL, _P, _LL, _P, _LL, _I, _I, _I, _I, _I, _LL, _P),
    "stpu_coreacc": (
        _P, _LL, _P, _LL, _LL, _I, _I, _I, _I, _P, _F, _P, _P, _F,
        _F, _F, _F, _F, _P, _P, _LL, _I, _LL, _P,
    ),
    "stpu_nthash_bin": (
        _P, _LL, _I, _P, _P, _I, _P, _I, _ULL, _I, _P, _P,
    ),
}

_lock = threading.Lock()
_lib = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the "
            "port's CUDA kernels are built from sketchtpu_torch/csrc at "
            "first use"
        )
    return found


def library_path() -> Path:
    return BUILD_DIR / f"libsketchtpu_kernels_{_digest()}.so"


def build() -> Path:
    """Compile csrc/*.cu into the hash-keyed library unless it exists.
    Returns its path; the compiler's report (registers, shared memory,
    spills from -Xptxas -v) is kept next to it as a .log file."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.tmp.{os.getpid()}")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in sources() if s.suffix == ".cu"]]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    out.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}"
        )
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            handle.stpu_error_string.argtypes = [ctypes.c_int]
            handle.stpu_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a kernel launch returned a CUDA error."""
    if err != 0:
        msg = lib().stpu_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
