"""Engine selection for the port, mirroring the JAX package's runtime.py.

SKETCHTPU_TORCH_BACKEND picks one of three modes:
- cuda (the default): the device engines, with the hand-written kernels on
  the card, at any size. Raises when torch sees no CUDA device. One
  process uses every visible GPU (devices()): with more than one, the
  selectors return the in-process multi-device engines of shard/mesh.py
  and sketching sends its batches round-robin over them, as the JAX
  package does over its local devices. Under torchrun each rank runs on
  its own GPU, LOCAL_RANK modulo the GPUs, and on that one only.
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


def devices() -> list[torch.device] | None:
    """The devices the engines run on, or None in host mode: [cpu] in cpu
    mode; in cuda mode every visible GPU, or under torchrun (LOCAL_RANK
    set) the rank's one GPU, LOCAL_RANK modulo the GPUs, which this makes
    the current device. So a GPU serves either ranks or one process's
    multi-device engines, never both."""
    m = mode()
    if m == "host":
        return None
    if m == "cpu":
        return [torch.device("cpu")]
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
        return [torch.device("cuda", index)]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def device() -> torch.device | None:
    """The first of devices(), or None in host mode."""
    devs = devices()
    return None if devs is None else devs[0]


def select_backend(seq_type, n_samples: int):
    """Batched sketching backend (DNA, or AA/3Di) over devices(), or None
    for the host path."""
    devs = devices()
    if devs is None:
        return None
    if seq_type.kind != "dna":
        from .sketchcore.sketch_torch import DeviceAaSketchBackend

        return DeviceAaSketchBackend(devs)
    from .sketchcore.sketch_torch import DeviceSketchBackend

    return DeviceSketchBackend(devs)


def select_coreacc_engine(ms, completeness_vec=None,
                          completeness_cutoff: float = 0.64,
                          exact: bool = False):
    """Dense core/accessory engine: the f32 fused kernel (over every
    device when there are several), or with exact=True (`dist --exact`)
    per-k exact strips + the host f64 chain on the first device."""
    devs = devices()
    if devs is None or len(ms.kmer_lengths) < 2:
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
            ms, devs[0], completeness_vec=completeness_vec,
            completeness_cutoff=completeness_cutoff,
        )
    if len(devs) > 1:
        from .shard.mesh import ShardedCoreAccEngine

        return ShardedCoreAccEngine(
            ms, devs, completeness_vec=completeness_vec,
            completeness_cutoff=completeness_cutoff,
        )
    from .dist.coreacc_torch import DeviceCoreAccEngine

    return DeviceCoreAccEngine(
        ms, devs[0], completeness_vec=completeness_vec,
        completeness_cutoff=completeness_cutoff,
    )


def select_dense_stream_engine(ms, dist_type):
    """Streaming single-k dense engine (exact samebits on the card, the
    f64 chain on the host), on the first device, as in the JAX package."""
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
    host chain. Several devices split the rows."""
    devs = devices()
    if devs is None or (dist_type.coreacc and len(ms.kmer_lengths) < 2):
        return None
    if len(devs) > 1:
        from .shard.mesh import ShardedKnnEngine

        return ShardedKnnEngine(ms, devs)
    from .dist.knn_torch import DeviceKnnEngine

    return DeviceKnnEngine(ms, devs[0])


def select_engine(ms):
    """samebits engine for the host distance functions (rows split over
    the devices when there are several), or None."""
    devs = devices()
    if devs is None:
        return None
    if len(devs) > 1:
        from .shard.mesh import ShardedSamebitsEngine

        return ShardedSamebitsEngine(ms.sketchsize64, devs).matrix
    from .dist.jaccard_torch import DeviceSamebitsEngine

    return DeviceSamebitsEngine(ms.sketchsize64, devs[0]).matrix


def select_inverted_engine(inv):
    """Inverted-index query and `precluster --count` engine (csrc/signeq.cu
    on the card, split over the devices when there are several), at any
    number of samples; None in host mode."""
    devs = devices()
    if devs is None:
        return None
    if len(devs) > 1:
        from .shard.mesh import ShardedInvertedEngine

        return ShardedInvertedEngine(inv.sign_matrix, devs)
    from .inverted.device import DeviceInvertedEngine

    return DeviceInvertedEngine(inv.sign_matrix, devs[0])
