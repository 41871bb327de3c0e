"""Engine selection for the port, mirroring sketchtpu/runtime.py.

SKETCHTPU_TORCH_BACKEND picks one of three modes:
- cuda (the default): the device engines, with the hand-written kernels on
  the card, at any size. Raises when torch sees no CUDA device.
- cpu: the same engine code on CPU tensors, where every kernel wrapper runs
  its plain PyTorch twin (what the tests drive).
- host: the NumPy oracle of the JAX package; every selector returns None.

A selector never falls back: an engine this port does not have yet raises
NotImplementedError in cuda and cpu mode, naming its ROADMAP item. The
only None results outside host mode are the JAX package's own routes to
the exact host chain (fewer than two k for core/accessory, more than 32767
bins for the int16 strip engines).
"""

from __future__ import annotations

import logging
import os

import torch

from .dist.samebits_kernels import INT16_MAX_BINS

log = logging.getLogger("sketchtpu")

MODES = ("cuda", "cpu", "host")


def mode() -> str:
    m = os.environ.get("SKETCHTPU_TORCH_BACKEND", "cuda")
    if m not in MODES:
        raise ValueError(
            f"SKETCHTPU_TORCH_BACKEND={m!r}: expected one of {', '.join(MODES)}"
        )
    return m


def device() -> torch.device | None:
    """The device the engines run on, or None in host mode."""
    m = mode()
    if m == "host":
        return None
    if m == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "SKETCHTPU_TORCH_BACKEND=cuda but torch sees no CUDA device "
            "(set SKETCHTPU_TORCH_BACKEND=cpu for the plain PyTorch twins)"
        )
    return torch.device("cuda", torch.cuda.current_device())


def _unported(what: str, item: int):
    raise NotImplementedError(
        f"{what} is not ported to sketchtpu_torch yet (ROADMAP queue 1 "
        f"item {item}); SKETCHTPU_TORCH_BACKEND=host runs the NumPy oracle"
    )


def select_backend(seq_type, n_samples: int):
    """Batched sketching backend (DNA), or None for the host path."""
    dev = device()
    if dev is None:
        return None
    if seq_type.kind != "dna":
        _unported("AA/3Di sketching", 7)
    from .sketchcore.sketch_torch import DeviceSketchBackend

    return DeviceSketchBackend(dev)


def select_coreacc_engine(ms, completeness_vec=None,
                          completeness_cutoff: float = 0.64,
                          exact: bool = False):
    """Dense core/accessory engine: the f32 fused kernel, or with
    exact=True (`dist --exact`) per-k exact strips + the host f64 chain."""
    dev = device()
    if dev is None or len(ms.kmer_lengths) < 2:
        return None
    if exact and ms.sketchsize64 * 64 > INT16_MAX_BINS:
        log.info(
            "--exact: sketch size %d bins exceeds the exact engine's int16 "
            "samebits range (max 32767 bins); using the host f64 pipeline",
            ms.sketchsize64 * 64,
        )
        return None
    if exact:
        from .dist.coreacc_torch import DeviceCoreAccExactStreamEngine

        return DeviceCoreAccExactStreamEngine(
            ms, dev, completeness_vec=completeness_vec,
            completeness_cutoff=completeness_cutoff,
        )
    from .dist.coreacc_torch import DeviceCoreAccEngine

    return DeviceCoreAccEngine(
        ms, dev, completeness_vec=completeness_vec,
        completeness_cutoff=completeness_cutoff,
    )


def select_dense_stream_engine(ms, dist_type):
    """Streaming single-k dense engine (exact samebits on the card, the
    f64 chain on the host)."""
    dev = device()
    if dev is None or dist_type.coreacc:
        return None
    if ms.sketchsize64 * 64 > INT16_MAX_BINS:
        return None  # samebits would overflow the int16 strips
    from .dist.jaccard_torch import DeviceDenseStreamEngine

    return DeviceDenseStreamEngine(ms, dist_type.k_idx, dev)


def select_knn_engine(ms, dist_type):
    if device() is None:
        return None
    _unported("Sparse kNN (dist --knn, precluster --skd)", 4)


def select_inverted_engine(inv):
    if device() is None:
        return None
    _unported("The inverted index engine", 6)


def select_engine(ms):
    """samebits engine for the host distance functions, or None."""
    dev = device()
    if dev is None:
        return None
    from .dist.jaccard_torch import DeviceSamebitsEngine

    return DeviceSamebitsEngine(ms.sketchsize64, dev).matrix
