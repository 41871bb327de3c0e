"""The port's engine selection, CLI routing and kernel wrappers' dispatch:
no GPU means no cuda mode, unported engines raise, a CUDA tensor goes to
the kernel launcher (never the twin) and is counted, and the JAX CLI gets
its own selectors back after a port run."""

import numpy as np
import pytest
import torch

import sketchtpu.runtime as jax_runtime
from sketchtpu.dist.api import DistType
from sketchtpu.sketchcore.sketch import HashType
from sketchtpu_torch import cli as port_cli
from sketchtpu_torch import runtime
from sketchtpu_torch.dist import coreacc_kernels, samebits_kernels
from sketchtpu_torch.hash import nthash_torch


def _MS(bins: int = 256):
    """A three-sample MultiSketch at k = 17, 21, 25 (zero sketch words)."""
    from sketchtpu.formats.skm import MultiSketch
    from sketchtpu.sketchcore.sketch import Sketch

    ms = MultiSketch([Sketch(name=f"g{i}", index=i) for i in range(3)], bins,
                     [17, 21, 25], HashType("dna"))
    ms.sketch_bins = np.zeros(3 * ms.sample_stride, dtype=np.uint64)
    return ms


class _FakeCuda:
    """Stands in for a CUDA tensor on a machine without one: the wrappers
    read only device, dtype, shape, strides and contiguity before they
    dispatch."""

    def __init__(self, t: torch.Tensor):
        self._t = t
        self.device = torch.device("cuda", 0)
        self.dtype = t.dtype
        self.shape = t.shape

    def dim(self):
        return self._t.dim()

    def stride(self, *d):
        return self._t.stride(*d)

    def numel(self):
        return self._t.numel()

    def is_contiguous(self):
        return self._t.is_contiguous()


def test_cuda_mode_without_gpu_raises(monkeypatch):
    monkeypatch.setenv("SKETCHTPU_TORCH_BACKEND", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runtime.select_engine(_MS())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runtime.select_backend(HashType("dna"), 1)


def test_unknown_mode_raises(monkeypatch):
    monkeypatch.setenv("SKETCHTPU_TORCH_BACKEND", "tpu")
    with pytest.raises(ValueError, match="expected one of"):
        runtime.device()


@pytest.mark.parametrize(
    "call,item",
    [
        (lambda: runtime.select_knn_engine(_MS(), DistType()), "item 4"),
        (lambda: runtime.select_inverted_engine(object()), "item 6"),
        (lambda: runtime.select_backend(HashType("aa", 1), 1), "item 7"),
    ],
)
def test_unported_selectors_raise(monkeypatch, call, item):
    monkeypatch.setenv("SKETCHTPU_TORCH_BACKEND", "cpu")
    with pytest.raises(NotImplementedError, match=item):
        call()


def test_host_mode_selects_nothing(monkeypatch):
    monkeypatch.setenv("SKETCHTPU_TORCH_BACKEND", "host")
    ms = _MS()
    assert runtime.select_engine(ms) is None
    assert runtime.select_knn_engine(ms, DistType()) is None
    assert runtime.select_coreacc_engine(ms) is None
    assert runtime.select_backend(HashType("aa", 1), 1) is None


def test_cpu_mode_selects_device_engines(monkeypatch):
    from sketchtpu_torch.dist.coreacc_torch import (
        DeviceCoreAccEngine,
        DeviceCoreAccExactStreamEngine,
    )
    from sketchtpu_torch.dist.jaccard_torch import DeviceDenseStreamEngine

    monkeypatch.setenv("SKETCHTPU_TORCH_BACKEND", "cpu")
    ms = _MS()
    assert isinstance(runtime.select_coreacc_engine(ms), DeviceCoreAccEngine)
    assert isinstance(runtime.select_coreacc_engine(ms, exact=True),
                      DeviceCoreAccExactStreamEngine)
    assert isinstance(
        runtime.select_dense_stream_engine(ms, DistType(k_idx=0, k=17.0)),
        DeviceDenseStreamEngine,
    )
    assert runtime.select_engine(ms) is not None


def test_int16_overflow_routes_to_the_host_chain(monkeypatch):
    """Above 32767 bins the int16 strip engines step aside, as in the JAX
    runtime; the int32 samebits engine still serves dist/api.py."""
    monkeypatch.setenv("SKETCHTPU_TORCH_BACKEND", "cpu")
    ms = _MS(bins=32768 + 64)
    assert runtime.select_dense_stream_engine(ms, DistType(k_idx=0, k=17.0)) is None
    assert runtime.select_coreacc_engine(ms, exact=True) is None
    assert runtime.select_engine(ms) is not None


def _refuse_twin(*args, **kwargs):
    raise AssertionError("a CUDA tensor reached the CPU twin")


def test_samebits_wrapper_launches_for_cuda_tensors(monkeypatch):
    calls = []
    monkeypatch.setattr(samebits_kernels, "samebits_ref", _refuse_twin)
    monkeypatch.setattr(samebits_kernels, "_launch_samebits",
                        lambda *a: calls.append(a) or "out")
    a = _FakeCuda(torch.zeros((8, 56), dtype=torch.int64))
    before = samebits_kernels.samebits.launches
    assert samebits_kernels.samebits(a, a, out_dtype=torch.int16, tri=True,
                                     row0=3) == "out"
    assert samebits_kernels.samebits.launches == before + 1
    assert calls[0][2:] == (torch.int16, True, 3)


def test_coreacc_wrapper_launches_for_cuda_tensors(monkeypatch):
    calls = []
    monkeypatch.setattr(coreacc_kernels, "coreacc_ref", _refuse_twin)
    monkeypatch.setattr(coreacc_kernels, "_launch_coreacc",
                        lambda *a: calls.append(a) or ("core", "acc"))
    w = _FakeCuda(torch.zeros((8, 3, 56), dtype=torch.int64))
    before = coreacc_kernels.coreacc.launches
    assert coreacc_kernels.coreacc(w, w, (17, 21, 25), 256) == ("core", "acc")
    assert coreacc_kernels.coreacc.launches == before + 1
    assert len(calls) == 1


def test_nthash_wrapper_launches_for_cuda_tensors(monkeypatch):
    calls = []
    monkeypatch.setattr(nthash_torch, "nthash_bin_ref", _refuse_twin)
    monkeypatch.setattr(nthash_torch, "_launch_nthash_bin",
                        lambda *a: calls.append(a) or "out")
    seq = _FakeCuda(torch.zeros(100, dtype=torch.uint8))
    tf = _FakeCuda(torch.zeros((5, 4), dtype=torch.int64))
    starts = _FakeCuda(torch.zeros(1, dtype=torch.int64))
    before = nthash_torch.nthash_bin.launches
    assert nthash_torch.nthash_bin(seq, 5, tf, tf, True, starts, 64) == "out"
    assert nthash_torch.nthash_bin.launches == before + 1
    assert len(calls) == 1 and calls[0][1] == 5


@pytest.mark.parametrize(
    "argv,item",
    [
        (["inverted", "precluster", "x.ski", "--count"], "item 6"),
        (["warmup"], "item 10"),
        (["dist", "db", "--jax-profile", "p"], "item 10"),
        (["dist", "db", "--n-processes", "2", "--process-id", "0"], "item 8"),
    ],
)
def test_cli_refuses_unported(argv, item):
    with pytest.raises(NotImplementedError, match=item):
        port_cli.main(argv)


def test_jax_cli_keeps_its_selectors_after_a_port_run(tmp_path, monkeypatch):
    from sketchtpu_torch.synth import related_assemblies

    original = {n: getattr(jax_runtime, n) for n in port_cli.ROUTED}
    rfile = related_assemblies(tmp_path, 2, 3000, seed=3, max_contigs=2)
    monkeypatch.setenv("SKETCHTPU_TORCH_BACKEND", "cpu")
    seen = {}
    real = runtime.select_backend

    def spy(seq_type, n):
        seen["bound"] = jax_runtime.select_backend is spy
        return real(seq_type, n)

    monkeypatch.setattr(runtime, "select_backend", spy)
    assert port_cli.main(["sketch", "-f", str(rfile), "-o",
                          str(tmp_path / "db"), "-k", "9,13", "-s", "64",
                          "--quiet"]) == 0
    assert seen == {"bound": True}
    for name, fn in original.items():
        assert getattr(jax_runtime, name) is fn, name
