"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Every `csrc/*.cu` file compiles into ONE shared library with a plain C
interface (no PyTorch headers, so a cold build takes seconds). The library
lands in `_build/` under a name keyed by a hash of the sources and the
flags, and is built at first use: a fresh checkout needs nothing but
`nvcc`. Processes that build at once wait for one build (`build_lock`).
Nothing here runs at import time, so `import sketchtpu_torch` works
on a machine with no CUDA toolkit; the CPU twins never reach this module.

Each C entry point takes device pointers, sizes and the CUDA stream, and
returns the `cudaError_t` of its launch; callers raise on a non-zero value.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *NVCC_ARCH,
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    # keep a*b+c as two roundings, like the plain PyTorch twins, so the
    # f32 chains agree with their twins to the last bit (no fast math:
    # IEEE division and logf/expf)
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
        _P, _LL, _P, _LL, _LL, _I, _I, _I, _I, _I, _P, _P, _P, _F, _F, _F,
        _F, _F, _P, _P, _LL, _I, _I, _LL, _LL, _I, _P, _P, _I, _LL, _I, _P,
    ),
    "stpu_coreacc_blocks_per_sm": (_I,),
    "stpu_nthash_multi": (
        _P, _LL, _P, _I, _I, _I, _P, _I, _ULL, _I, _I, _I, _I, _I, _P, _P,
    ),
    "stpu_nthash_signs": (_P, _LL, _P, _I, _I, _I, _I, _I, _LL, _P, _P),
    "stpu_nthash_signs_blocks_per_sm": (_I,),
    "stpu_aahash_multi": (
        _P, _LL, _P, _I, _I, _P, _I, _ULL, _I, _I, _I, _I, _I, _I, _I, _P,
        _P, _P,
    ),
    "stpu_aahash_blocks_per_sm": (_I, _I),
    "stpu_magic_div": (_P, _I, _ULL, _I, _P, _P),
    "stpu_knn_keys": (
        _P, _LL, _P, _LL, _P, _LL, _I, _I, _I, _I, _LL, _LL, _I, _I, _LL,
        _I, _P, _P, _F, _F, _F, _F, _P, _P, _I, _LL, _I, _P,
    ),
    "stpu_knn_select": (
        _P, _LL, _P, _LL, _P, _P, _I, _I, _I, _I, _I, _LL, _I, _I, _LL, _I,
        _P, _P, _F, _F, _F, _F, _P, _P, _I, _LL, _I, _P,
    ),
    "stpu_knn_select_rows": (_I, _I, _I),
    "stpu_signeq": (_P, _LL, _I, _P, _LL, _I, _I, _I, _I, _I, _I, _P, _P),
    "stpu_signeq_blocks_per_sm": (_I, _I, _I),
    "stpu_pair_count": (_P, _LL, _I, _I, _I, _I, _I, _I, _P, _P),
    "stpu_pair_count_blocks_per_sm": (_I,),
    "stpu_compare_rate": (_I, _I, _I, _P, _P),
    "stpu_compare_rate_blocks_per_sm": (),
    "stpu_knn_select_blocks_per_sm": (_I, _I, _I, _I),
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


@contextlib.contextmanager
def build_lock(build_dir: Path):
    """Hold the build directory's lock (an flock on `.lock` in it, which
    the system drops when its process dies): processes that build into
    one directory at once, such as the ranks of a multi-process run on a
    fresh checkout, take turns, so only the first compiles."""
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / ".lock", "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build() -> Path:
    """Compile csrc/*.cu into the hash-keyed library unless it exists: one
    nvcc per source, all started together, then one link, under the build
    directory's lock. Returns its path; the compiler's report (registers,
    shared memory, spills from -Xptxas -v) is kept next to it as a .log
    file."""
    out = library_path()
    if out.exists():
        return out
    with build_lock(BUILD_DIR):
        if not out.exists():  # else another process built it meanwhile
            _compile(out)
    return out


def _compile(out: Path) -> None:
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = nvcc_path()
    jobs = []
    for src in (s for s in sources() if s.suffix == ".cu"):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    tmp = out.with_suffix(f".so.tmp.{os.getpid()}")
    link = [nvcc, *NVCC_ARCH, "-shared", "-o", str(tmp),
            *[str(obj) for _, obj, _ in jobs]]
    log, failed = [], None
    try:
        for cmd, _, proc in jobs:
            text, _ = proc.communicate(timeout=900)
            log.append(" ".join(cmd) + "\n" + text)
            if proc.returncode != 0 and failed is None:
                failed = f"nvcc failed ({proc.returncode}):\n{text[-4000:]}"
        if failed is None:
            proc = subprocess.run(link, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True,
                                  timeout=300)
            log.append(" ".join(link) + "\n" + proc.stdout)
            if proc.returncode != 0:
                failed = f"nvcc link failed ({proc.returncode}):\n{proc.stdout[-4000:]}"
    finally:
        for _, obj, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            obj.unlink(missing_ok=True)
    out.with_suffix(".log").write_text("\n".join(log))
    if failed is not None:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(failed)
    os.replace(tmp, out)


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
