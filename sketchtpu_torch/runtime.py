"""Engine selection for the port, mirroring the JAX package's runtime.py.

SKETCHTPU_TORCH_BACKEND picks one of three modes:
- cuda (the default): the device engines, with the hand-written kernels on
  the card, at any size. Raises when torch sees no CUDA device. Under
  torchrun each rank runs on GPU LOCAL_RANK modulo the GPUs.
- cpu: the same engine code on CPU tensors, where every kernel wrapper runs
  its plain PyTorch twin (what the tests drive).
- host: this package's NumPy oracle (sketchcore/sketch.py, dist/api.py);
  every selector returns None.

A selector never falls back. The only None results outside host mode are
the JAX package's own routes to the exact host chain (fewer than two k for
core/accessory, more than 32767 bins for the int16 strip engines). Unlike
the JAX package, no selector picks the host by sample count: in cuda mode
every engine runs on the card at any n.
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
    """The device the engines run on, or None in host mode. In cuda mode
    under torchrun (LOCAL_RANK set) that is the rank's GPU, LOCAL_RANK
    modulo the GPUs, which this makes the current device (the kernels
    launch on the current device's context)."""
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
    local = os.environ.get("LOCAL_RANK")
    if local is not None:
        index = int(local) % torch.cuda.device_count()
        if index != torch.cuda.current_device():
            torch.cuda.set_device(index)
    return torch.device("cuda", torch.cuda.current_device())


def select_backend(seq_type, n_samples: int):
    """Batched sketching backend (DNA, or AA/3Di), or None for the host
    path."""
    dev = device()
    if dev is None:
        return None
    if seq_type.kind != "dna":
        from .sketchcore.sketch_torch import DeviceAaSketchBackend

        return DeviceAaSketchBackend(dev)
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
    """Sparse kNN engine (dist --knn): K3 keys for single-k, K2 tiles for
    core/accessory, at any n; fewer than two k for core/accessory take the
    host chain."""
    dev = device()
    if dev is None or (dist_type.coreacc and len(ms.kmer_lengths) < 2):
        return None
    from .dist.knn_torch import DeviceKnnEngine

    return DeviceKnnEngine(ms, dev)


def select_engine(ms):
    """samebits engine for the host distance functions, or None."""
    dev = device()
    if dev is None:
        return None
    from .dist.jaccard_torch import DeviceSamebitsEngine

    return DeviceSamebitsEngine(ms.sketchsize64, dev).matrix


def select_inverted_engine(inv):
    """Inverted-index query and `precluster --count` engine (csrc/signeq.cu
    on the card), at any number of samples; None in host mode."""
    dev = device()
    if dev is None:
        return None
    from .inverted.device import DeviceInvertedEngine

    return DeviceInvertedEngine(inv.sign_matrix, dev)
