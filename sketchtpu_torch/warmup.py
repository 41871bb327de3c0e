"""`warmup`: pay the port's one-time start-up cost ahead of the runs.

The JAX package's warmup fills the persistent XLA compile cache by driving
the CLI on synthetic inputs, because its programs specialise on shapes.
The port's kernels do not: every CUDA kernel lives in one library built by
nvcc from `csrc/*.cu`, and the host helper is one g++ build of
`csrc/host/native.cpp`, both into `_build/` under names keyed by the
sources, once per checkout. So warmup builds them (the kernels only in
cuda mode; the cpu and host modes never load them) and reports each
library's path and build seconds. Nothing that a synthetic CLI run would
warm (the CUDA context, the loaded library) outlives its process, so none
is made. The builds hold `_build/`'s lock, so concurrent warmups and ranks
wait for one build and then load it.

It takes the JAX package's flags; only --modes matters, and each mode
needs the same build. An unknown mode name is an error.
"""

from __future__ import annotations

import sys
import time

MODES = ("sketch", "dense", "knn", "coreacc-dense", "coreacc-knn", "exact",
         "cross", "reads", "inverted")


def parse_modes(text: str | None) -> list[str]:
    """The --modes list; a name outside MODES raises ValueError."""
    modes = [m for m in (text or "").split(",") if m]
    unknown = [m for m in modes if m not in MODES]
    if unknown:
        raise ValueError(f"warmup: unknown mode(s) {', '.join(unknown)}; "
                         f"expected a subset of {','.join(MODES)}")
    return modes


def run_warmup(args) -> dict:
    """Build the host helper, and the kernels in cuda mode; returns
    {what: (library path, seconds)} and prints one line for each."""
    from . import _native
    from .runtime import mode

    modes = parse_modes(args.modes)
    built = {}
    t0 = time.time()
    _native.lib()
    built["host helper"] = (_native.library_path(), time.time() - t0)
    if mode() == "cuda":
        from . import _build

        t0 = time.time()
        built["CUDA kernels"] = (_build.build(), time.time() - t0)
    for what, (path, secs) in built.items():
        print(f"  {what}: {path} ({secs:.1f} s)", file=sys.stderr)
    if mode() != "cuda":
        print(f"  CUDA kernels: not needed in {mode()} mode", file=sys.stderr)
    print(f"warmup complete for {','.join(modes) or 'no mode'}",
          file=sys.stderr)
    return built
