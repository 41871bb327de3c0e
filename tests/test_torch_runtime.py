"""The port's engine selection, CLI refusals and kernel wrappers'
dispatch: no GPU means no cuda mode, what the port cannot honour is refused
before any work, a CUDA tensor goes to the kernel launcher (never the twin)
and is counted; and the port imports nothing of the JAX package."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from sketchtpu_torch import _build
from sketchtpu_torch import cli as port_cli
from sketchtpu_torch import runtime
from sketchtpu_torch.dist import coreacc_kernels, knn_kernels, samebits_kernels
from sketchtpu_torch.dist.api import DistType
from sketchtpu_torch.formats.skm import MultiSketch
from sketchtpu_torch.hash import nthash_torch
from sketchtpu_torch.sketchcore.sketch import HashType, Sketch

REPO = Path(__file__).resolve().parent.parent


def _MS(bins: int = 256, kmers=(17, 21, 25)):
    """A three-sample MultiSketch (zero sketch words)."""
    ms = MultiSketch([Sketch(name=f"g{i}", index=i) for i in range(3)], bins,
                     list(kmers), HashType("dna"))
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


# argv, JAX_COORDINATOR_ADDRESS, what the refusal says
REFUSED = [
    (["warmup", "--modes", "sketch,bogus"], None, "unknown mode(s) bogus"),
    (["sketch", "x.fa", "-o", "o"], "localhost:1234",
     "WORLD_SIZE, RANK, MASTER_ADDR, MASTER_PORT"),
    (["sketch", "x.fa", "-o", "o", "--n-processes", "2", "--process-id",
      "2"], None, "outside [0, 2)"),
]


@pytest.mark.parametrize("argv,coordinator,message", REFUSED)
def test_unported_selectors_raise(monkeypatch, capsys, argv, coordinator,
                                  message):
    """No engine selector refuses (every module is ported); what the port
    cannot honour is refused before any selector runs: an unknown warmup
    mode, a jax.distributed coordinator without torchrun's variables or
    the rank flags, a rank outside the process count."""
    monkeypatch.setenv("SKETCHTPU_TORCH_BACKEND", "cpu")
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    if coordinator:
        monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", coordinator)
    monkeypatch.setattr(runtime, "devices", lambda: pytest.fail("work began"))
    parser = port_cli.build_parser()
    with pytest.raises(SystemExit) as exc:
        port_cli.refuse_unported(parser.parse_args(argv), parser)
    assert exc.value.code == 2 and message in capsys.readouterr().err


@pytest.mark.parametrize("kind", ["aa", "pdb"])
@pytest.mark.parametrize("mode", ["cpu", "cuda"])
def test_aa_selects_the_aa_backend(monkeypatch, mode, kind):
    """cpu and cuda mode select DeviceAaSketchBackend for AA and 3Di (on
    the mode's device); host mode selects nothing."""
    from sketchtpu_torch.sketchcore.sketch_torch import DeviceAaSketchBackend

    monkeypatch.setenv("SKETCHTPU_TORCH_BACKEND", mode)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    backend = runtime.select_backend(HashType(kind, 2), 1)
    assert isinstance(backend, DeviceAaSketchBackend)
    assert [d.type for d in backend.devices] == [mode]
    monkeypatch.setenv("SKETCHTPU_TORCH_BACKEND", "host")
    assert runtime.select_backend(HashType(kind, 2), 1) is None


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
    from sketchtpu_torch.dist.knn_torch import DeviceKnnEngine

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
    assert isinstance(runtime.select_knn_engine(ms, DistType()), DeviceKnnEngine)
    assert isinstance(
        runtime.select_knn_engine(ms, DistType(k_idx=1, k=21.0)),
        DeviceKnnEngine,
    )


def test_knn_coreacc_with_one_k_routes_to_the_host_chain(monkeypatch):
    """As in the JAX runtime: core/accessory needs two k, so the selector
    steps aside and the host path raises its own error."""
    monkeypatch.setenv("SKETCHTPU_TORCH_BACKEND", "cpu")
    ms = _MS(kmers=(17,))
    assert runtime.select_knn_engine(ms, DistType()) is None
    assert runtime.select_knn_engine(ms, DistType(k_idx=0, k=17.0)) is not None


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


def test_coreacc_keys_wrapper_launches_for_cuda_tensors(monkeypatch):
    """Key mode launches K2 too, counted with its plain mode, with the
    tile's column offset, real column count and self exclusion."""
    calls = []
    monkeypatch.setattr(coreacc_kernels, "coreacc_keys_ref", _refuse_twin)
    monkeypatch.setattr(coreacc_kernels, "coreacc_ref", _refuse_twin)
    monkeypatch.setattr(coreacc_kernels, "_launch_coreacc",
                        lambda *a: calls.append(a) or ("keys", "acc"))
    w = _FakeCuda(torch.zeros((8, 3, 56), dtype=torch.int64))
    before = coreacc_kernels.coreacc.launches
    got = coreacc_kernels.coreacc_keys(w, w, (17, 21, 25), 256, row0=2,
                                       col0=5, nb_real=9, exclude_self=True)
    assert got == ("keys", "acc")
    assert coreacc_kernels.coreacc.launches == before + 1
    assert calls[0][7:] == (False, 2, (5, 4, True), None)


def test_coreacc_rejects_more_k_than_the_kernel_takes_on_cuda():
    nk = coreacc_kernels.MAX_NK + 1
    kmers = tuple(range(3, 3 + nk))
    w = torch.zeros((2, nk, 14), dtype=torch.int64)
    with pytest.raises(ValueError, match=f"limit of {nk - 1}"):
        coreacc_kernels.coreacc(_FakeCuda(w), _FakeCuda(w), kmers, 64)
    with pytest.raises(ValueError, match=f"limit of {nk - 1}"):
        coreacc_kernels.coreacc_keys(_FakeCuda(w), _FakeCuda(w), kmers, 64)
    core, acc = coreacc_kernels.coreacc(w, w, kmers, 64)  # the twin: no limit
    assert core.shape == acc.shape == (2, 2)


def test_coreacc_k_limit_is_the_kernels():
    """The wrapper's MAX_NK and MAX_NK_BY_VALUE are the bounds
    csrc/coreacc.cu sizes its 16-bit included-k count and its by-value k
    table (and byte-wide count) by; the table the wrapper builds has the
    kernel's layout on either side of the by-value bound."""
    src = (REPO / "sketchtpu_torch" / "csrc" / "coreacc.cu").read_text()
    assert f"constexpr int MAX_NK = {coreacc_kernels.MAX_NK};" in src
    assert (f"constexpr int MAX_NK_BY_VALUE = "
            f"{coreacc_kernels.MAX_NK_BY_VALUE};") in src
    assert coreacc_kernels.MAX_NK <= 65535
    assert coreacc_kernels.MAX_NK_BY_VALUE <= 255
    table = coreacc_kernels._k_table((17, 19, 21))
    assert len(table) == 3 * coreacc_kernels.MAX_NK_BY_VALUE + 3
    wide = tuple(range(3, 4 + coreacc_kernels.MAX_NK_BY_VALUE))
    assert len(coreacc_kernels._k_table(wide)) == 3 * len(wide) + 3


def test_words_slots_limit_is_the_kernels():
    """The wrappers' MAX_WORDS_SLOTS is the one bound csrc/tile.cuh sizes
    the finish's and the chain's pointer array by, and neither kernel
    source keeps a bound of its own."""
    csrc = REPO / "sketchtpu_torch" / "csrc"
    tile = (csrc / "tile.cuh").read_text()
    assert (f"constexpr int MAX_WORDS_SLOTS = "
            f"{samebits_kernels.MAX_WORDS_SLOTS};") in tile
    assert "const int* p[MAX_WORDS_SLOTS];" in tile
    for name in ("samebits.cu", "coreacc.cu"):
        src = (csrc / name).read_text()
        assert "const WordsParts " in src
        assert "const int* p[" not in src


def test_coreacc_engines_past_the_k_limit_stay_on_the_card(monkeypatch):
    """In cuda mode more k than K2 takes still selects the card's
    core/accessory engines (whose launch then raises): no route to the
    host chain."""
    from sketchtpu_torch.dist import coreacc_torch, knn_torch

    many = tuple(range(3, 3 + coreacc_kernels.MAX_NK + 1))
    monkeypatch.setattr(runtime, "devices", lambda: [torch.device("cuda", 0)])
    monkeypatch.setattr(coreacc_torch, "DeviceCoreAccEngine",
                        lambda ms, dev, **kw: ("dense", dev))
    monkeypatch.setattr(knn_torch, "DeviceKnnEngine",
                        lambda ms, dev: ("knn", dev))
    cuda = torch.device("cuda", 0)
    assert runtime.select_coreacc_engine(_MS(kmers=many)) == ("dense", cuda)
    assert runtime.select_knn_engine(_MS(kmers=many), DistType()) == \
        ("knn", cuda)


def test_samebits_full_wrapper_launches_for_cuda_tensors(monkeypatch):
    calls = []
    monkeypatch.setattr(samebits_kernels, "samebits_ref", _refuse_twin)
    monkeypatch.setattr(samebits_kernels, "_launch_samebits",
                        lambda *a: calls.append(a) or "out")
    a = _FakeCuda(torch.zeros((8, 56), dtype=torch.int64))
    before = samebits_kernels.samebits_full.launches
    k1_before = samebits_kernels.samebits.launches
    assert samebits_kernels.samebits_full(a, a) == "out"
    assert samebits_kernels.samebits_full.launches == before + 1
    assert samebits_kernels.samebits.launches == k1_before
    assert calls[0][2:] == (torch.int32, False, 0)


@pytest.mark.parametrize("comp", [False, True])
def test_knn_keys_wrapper_launches_for_cuda_tensors(monkeypatch, comp):
    calls = []
    monkeypatch.setattr(knn_kernels, "knn_keys_ref", _refuse_twin)
    monkeypatch.setattr(knn_kernels, "_launch_knn_keys",
                        lambda *a: calls.append(a) or "out")
    a = _FakeCuda(torch.zeros((8, 56), dtype=torch.int64))
    c = None
    if comp:
        c = knn_kernels.Completeness(_FakeCuda(torch.ones(8)),
                                     _FakeCuda(torch.ones(11)), 0.64, 4)
    before = knn_kernels.knn_keys.launches
    assert knn_kernels.knn_keys(a, a, col0=3, nb_real=11, exclude_self=True,
                                comp=c) == "out"
    assert knn_kernels.knn_keys.launches == before + 1
    assert calls[0][2:] == (0, 3, 11, True, c, None)


def _fake_nthash_launch(monkeypatch, calls):
    """A stand-in launch that fills its rows with their k (the result then
    lives on the CPU, where torch.full leaves it)."""
    full = torch.full

    def launch(seq, ks, rc, starts, nbins, out):
        calls.append((seq, ks, rc, starts, nbins))
        out.copy_(torch.tensor(ks)[:, None, None].expand_as(out))

    monkeypatch.setattr(nthash_torch, "_launch_nthash_multi", launch)
    monkeypatch.setattr(torch, "full",
                        lambda *a, device=None, **kw: full(*a, **kw))


def test_nthash_wrapper_launches_for_cuda_tensors(monkeypatch):
    """The single-k entry point is the multi-k kernel with one k."""
    calls = []
    monkeypatch.setattr(nthash_torch, "nthash_bin_ref", _refuse_twin)
    monkeypatch.setattr(nthash_torch, "nthash_bin_multi_ref", _refuse_twin)
    _fake_nthash_launch(monkeypatch, calls)
    seq = _FakeCuda(torch.zeros(100, dtype=torch.uint8))
    tf = _FakeCuda(torch.zeros((5, 4), dtype=torch.int64))
    starts = _FakeCuda(torch.zeros(1, dtype=torch.int64))
    before = nthash_torch.nthash_bin_multi.launches
    got = nthash_torch.nthash_bin(seq, 5, tf, tf, True, starts, 64)
    assert torch.equal(got, torch.full((1, 64), 5))
    assert nthash_torch.nthash_bin_multi.launches == before + 1
    assert len(calls) == 1 and calls[0][1] == [5]


def test_nthash_multi_wrapper_launches_for_cuda_tensors(monkeypatch):
    """One launch for the k list, ascending; the rows come back in kmers
    order."""
    calls = []
    monkeypatch.setattr(nthash_torch, "nthash_bin_ref", _refuse_twin)
    monkeypatch.setattr(nthash_torch, "nthash_bin_multi_ref", _refuse_twin)
    _fake_nthash_launch(monkeypatch, calls)
    seq = _FakeCuda(torch.zeros(100, dtype=torch.uint8))
    starts = _FakeCuda(torch.zeros(1, dtype=torch.int64))
    before = nthash_torch.nthash_bin_multi.launches
    got = nthash_torch.nthash_bin_multi(seq, (21, 17), True, starts, 64)
    assert got.shape == (2, 1, 64) and got[:, 0, 0].tolist() == [21, 17]
    assert nthash_torch.nthash_bin_multi.launches == before + 1
    assert calls[0][1:] == ([17, 21], True, starts, 64)


def test_nthash_multi_rejects_what_the_kernel_does_not_take():
    seq = _FakeCuda(torch.zeros(100, dtype=torch.uint8))
    starts = _FakeCuda(torch.zeros(1, dtype=torch.int64))
    with pytest.raises(ValueError, match="limit"):
        nthash_torch.nthash_bin_multi(seq, (nthash_torch.MAX_K_CUDA + 1,),
                                      True, starts, 64)
    with pytest.raises(ValueError, match="not empty"):
        nthash_torch.nthash_bin_multi(seq, (), True, starts, 64)


def test_nthash_multi_without_a_window_launches_nothing(monkeypatch):
    monkeypatch.setattr(nthash_torch, "_launch_nthash_multi", _refuse_twin)
    monkeypatch.setattr(torch, "full", lambda *a, **kw: (a, kw["dtype"]))
    seq = _FakeCuda(torch.zeros(10, dtype=torch.uint8))
    starts = _FakeCuda(torch.zeros(2, dtype=torch.int64))
    before = nthash_torch.nthash_bin_multi.launches
    got = nthash_torch.nthash_bin_multi(seq, (17, 21), True, starts, 64)
    assert got == (((2, 2, 64), -1), torch.int64)
    assert nthash_torch.nthash_bin_multi.launches == before


@pytest.mark.parametrize("comp", [False, True])
def test_knn_select_wrapper_launches_for_cuda_tensors(monkeypatch, comp):
    calls = []
    monkeypatch.setattr(knn_kernels, "knn_select_ref", _refuse_twin)
    monkeypatch.setattr(knn_kernels, "knn_keys_ref", _refuse_twin)
    monkeypatch.setattr(knn_kernels, "_launch_knn_select",
                        lambda *a: calls.append(a) or "out")
    a = _FakeCuda(torch.zeros((8, 56), dtype=torch.int64))
    b = _FakeCuda(torch.zeros((11, 56), dtype=torch.int64))
    c = None
    if comp:
        c = knn_kernels.Completeness(_FakeCuda(torch.ones(8)),
                                     _FakeCuda(torch.ones(11)), 0.64, 4)
    before = knn_kernels.knn_select.launches
    tiles_before = knn_kernels.knn_keys.launches
    assert knn_kernels.knn_select(a, b, 5, row0=3, exclude_self=True,
                                  comp=c) == "out"
    assert knn_kernels.knn_select.launches == before + 1
    assert knn_kernels.knn_keys.launches == tiles_before
    assert calls[0][2:] == (5, 3, 11, True, c, None, None)


def test_knn_select_rejects_knn_past_its_limit_on_cuda():
    a = _FakeCuda(torch.zeros((8, 56), dtype=torch.int64))
    with pytest.raises(ValueError, match=f"limit of {knn_kernels.MAX_KNN}"):
        knn_kernels.knn_select(a, a, knn_kernels.MAX_KNN + 1)
    w = torch.zeros((8, 56), dtype=torch.int64)  # the twin: no limit
    assert knn_kernels.knn_select(w, w, knn_kernels.MAX_KNN + 1).shape == \
        (8, knn_kernels.MAX_KNN + 1)


def test_knn_select_limits_are_the_kernels():
    """MAX_KNN is the one csrc/knn_scan.cu sizes its shared-memory lists
    by; the split rule on the kernel's rows per block."""
    src = (REPO / "sketchtpu_torch" / "csrc" / "knn_scan.cu").read_text()
    assert f"constexpr int MAX_KNN = {knn_kernels.MAX_KNN};" in src
    # splits: whole waves of the 264 blocks an H100 holds at once
    splits = knn_kernels.default_splits
    assert splits(100_000, 100_000, 64, 264) == 1  # 1563 row tiles: 6 waves
    assert splits(264 * 64, 100_000, 64, 264) == 1
    assert splits(2048, 100_000, 64, 264) == 8  # 32 row tiles: 256 blocks
    assert splits(313 * 64, 100_000, 64, 264) == 5  # 1565 blocks: 6 waves
    assert splits(3, 100_000, 64, 264) == 264
    assert splits(3, 100, 64, 264) == 2
    # at the largest knn a block holds 16 rows: 128 row tiles
    assert splits(2048, 100_000, 16, 132) == splits(2048 * 4, 100_000, 64, 132)


def test_single_k_scan_makes_one_selection_launch(monkeypatch):
    """knn_scan hands all rows and the whole column plane to knn_select
    once: no key tile, no torch.topk merge on its path."""
    from sketchtpu_torch.dist import knn_torch

    calls = []

    def select(rows, cols, knn, **kw):
        calls.append((rows.shape[0], cols.shape[0], knn, kw))
        return knn_kernels.knn_select_ref(rows, cols, knn, **kw)

    monkeypatch.setattr(knn_torch, "knn_select", select)
    monkeypatch.setattr(knn_torch, "_merge", _refuse_twin)
    g = torch.Generator().manual_seed(1)
    w = torch.randint(-2**62, 2**62, (300, 28), generator=g)
    sb, idx = knn_torch.knn_scan(w, w, 4, exclude_self=True)
    assert sb.shape == idx.shape == (300, 4)
    assert calls == [(300, 300, 4, dict(row0=0, nb_real=300,
                                        exclude_self=True, comp=None,
                                        sig=None))]


@pytest.mark.parametrize(
    "argv,coordinator,message",
    [
        (["warmup", "--modes", "dense,inverted,sort"], None,
         "unknown mode(s) sort"),
        (["dist", "db", "--jax-profile", "p"], "localhost:1234",
         "does not join a jax.distributed coordinator"),
        (["dist", "db", "--process-id", "0"], None,
         "--process-id needs --n-processes"),
    ],
)
def test_cli_refuses_unported(monkeypatch, capsys, argv, coordinator,
                              message):
    """main() refuses them at argument parsing (exit code 2), before any
    work: nothing is read, built or profiled."""
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    if coordinator:
        monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", coordinator)
    monkeypatch.setattr(port_cli, "_start_profile",
                        lambda args: pytest.fail("profiling began"))
    with pytest.raises(SystemExit) as exc:
        port_cli.main(argv)
    assert exc.value.code == 2 and message in capsys.readouterr().err


def test_cli_runs_inverted_commands(tmp_path, monkeypatch, capsys):
    """The inverted commands and info on a .ski run on the port (here its
    cpu mode), and so do their multi-process runs: a rank's partial
    count."""
    from sketchtpu_torch.inverted.index import Inverted

    monkeypatch.setenv("SKETCHTPU_TORCH_BACKEND", "cpu")
    mat = np.array([[1, 2, 3], [1, 5, 6], [7, 8, 9], [7, 8, 10]], np.uint16)
    Inverted(sign_matrix=mat, sample_names=list("abcd"), kmer_size=17,
             rc=True, hash_type=HashType("dna")).save(str(tmp_path / "x"))
    assert port_cli.main(["inverted", "precluster", str(tmp_path / "x.ski"),
                          "--count", "--quiet"]) == 0
    assert port_cli.main(["info", str(tmp_path / "x.ski")]) == 0
    out = capsys.readouterr().out
    assert "Identified 2 prefilter pairs from a max of 6" in out
    assert "n_samples=4" in out and "inverted=true" in out
    assert port_cli.main(["inverted", "precluster", str(tmp_path / "x.ski"),
                          "--count", "--n-processes", "2", "--process-id",
                          "0", "--quiet"]) == 0
    assert capsys.readouterr().out == (
        "Identified 1 prefilter pairs in rows [0, 1) of 4 (rank 0/2 partial; "
        "sum ranks for the total)\n")


def test_cli_refuses_k_past_the_card_at_parsing(monkeypatch, capsys):
    """In cuda mode a k past MAX_K_CUDA is refused before any work (no
    route to the host), with the limit in the message."""
    monkeypatch.setenv("SKETCHTPU_TORCH_BACKEND", "cuda")
    monkeypatch.setattr(runtime, "devices", lambda: pytest.fail("work began"))
    big = str(nthash_torch.MAX_K_CUDA + 1)
    for argv in (["sketch", "x.fa", "-o", "o", "-k", f"17,{big}"],
                 ["inverted", "build", "x.fa", "-o", "o", "-k", big]):
        with pytest.raises(SystemExit) as exc:
            port_cli.main(argv)
        assert exc.value.code == 2
        assert f"k <= {nthash_torch.MAX_K_CUDA}" in capsys.readouterr().err
    monkeypatch.setenv("SKETCHTPU_TORCH_BACKEND", "cpu")
    port_cli.refuse_past_card_limits(
        port_cli.build_parser().parse_args(["sketch", "x", "-o", "o", "-k",
                                            big]), None)


@pytest.mark.parametrize("seq_type", ["aa", "pdb"])
def test_cli_refuses_aa_k_past_the_card_at_parsing(monkeypatch, capsys,
                                                   seq_type):
    """--seq-type aa|pdb is held to the AA kernel's limit, MAX_K_AA_CUDA,
    in cuda mode only."""
    from sketchtpu_torch.hash.aahash_torch import MAX_K_AA_CUDA

    monkeypatch.setenv("SKETCHTPU_TORCH_BACKEND", "cuda")
    monkeypatch.setattr(runtime, "devices", lambda: pytest.fail("work began"))
    big = str(MAX_K_AA_CUDA + 1)
    argv = ["sketch", "x.faa", "-o", "o", "--seq-type", seq_type, "-k",
            f"9,{big}"]
    with pytest.raises(SystemExit) as exc:
        port_cli.main(argv)
    assert exc.value.code == 2
    assert f"k <= {MAX_K_AA_CUDA}" in capsys.readouterr().err
    monkeypatch.setenv("SKETCHTPU_TORCH_BACKEND", "cpu")
    port_cli.refuse_past_card_limits(port_cli.build_parser().parse_args(argv),
                                     None)


@pytest.mark.parametrize("kind", ["dna", "aa"])
def test_cli_refuses_append_past_the_card_at_parsing(tmp_path, monkeypatch,
                                                     capsys, kind):
    """`append` to a database whose k pass the card's hash kernel (sketched
    in cpu or host mode) is refused in cuda mode before any work."""
    from sketchtpu_torch.hash.aahash_torch import MAX_K_AA_CUDA

    limit = nthash_torch.MAX_K_CUDA if kind == "dna" else MAX_K_AA_CUDA
    MultiSketch([Sketch(name="g0", index=0)], 64, [9, limit + 1],
                HashType(kind)).save_metadata(str(tmp_path / "db"))
    monkeypatch.setenv("SKETCHTPU_TORCH_BACKEND", "cuda")
    monkeypatch.setattr(runtime, "devices", lambda: pytest.fail("work began"))
    with pytest.raises(SystemExit) as exc:
        port_cli.main(["append", str(tmp_path / "db"), "x.fa", "-o", "o"])
    assert exc.value.code == 2
    assert f"k <= {limit}" in capsys.readouterr().err


def _imports_of_jax_package(path: Path) -> list[str]:
    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        found += [f"{path.name}:{node.lineno} {name}" for name in names
                  if name.split(".")[0] in ("sketchtpu", "jax", "jaxlib")]
    return found


@pytest.mark.parametrize(
    "path",
    sorted((REPO / "sketchtpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_port_imports_nothing_of_the_jax_package(path):
    """The port keeps its own copies of the host layers: no module of it,
    and not chip_smoke.py, imports sketchtpu or jax (a subprocess that runs
    the JAX CLI as the host oracle is allowed)."""
    assert _imports_of_jax_package(path) == []


def test_port_import_check_covers_the_mesh_engines():
    paths = sorted((REPO / "sketchtpu_torch").rglob("*.py"))
    assert REPO / "sketchtpu_torch" / "shard" / "mesh.py" in paths
    assert _imports_of_jax_package(
        REPO / "sketchtpu_torch" / "shard" / "mesh.py") == []


def _kernel_entry_calls(path: Path) -> list[str]:
    """Where a module reaches the kernel library other than through
    _build.launch / _build.query: `_build.lib` itself, `lib` imported
    from _build, or an stpu_* attribute of a call's result."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if (isinstance(node, ast.Attribute) and node.attr == "lib"
                and isinstance(node.value, ast.Name)
                and node.value.id == "_build"):
            found.append(f"{path.name}:{node.lineno} _build.lib")
        elif (isinstance(node, ast.ImportFrom)
              and (node.module or "").endswith("_build")
              and any(a.name == "lib" for a in node.names)):
            found.append(f"{path.name}:{node.lineno} import lib")
        elif (isinstance(node, ast.Attribute)
              and node.attr.startswith("stpu_")
              and isinstance(node.value, ast.Call)):
            found.append(f"{path.name}:{node.lineno} {node.attr}")
    return found


@pytest.mark.parametrize(
    "path",
    [p for p in sorted((REPO / "sketchtpu_torch").rglob("*.py"))
     if p.name != "_build.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_kernels_launch_only_through_the_device_guarded_helper(path):
    """Every kernel entry point is called through _build.launch (or, for
    the occupancy queries, _build.query), which makes the tensors' device
    current around the call."""
    assert _kernel_entry_calls(path) == []


def test_the_launch_helper_makes_the_device_current(monkeypatch):
    """_build.launch calls the entry point with the device current and
    that device's stream as the last argument, and raises on a CUDA
    error; _build.query returns the entry point's value with the device
    current."""
    from types import SimpleNamespace

    from sketchtpu_torch import _build

    current = []

    class Guard:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            current.append(self.dev)

        def __exit__(self, *exc):
            current.pop()

    class Lib:
        calls = []

        def stpu_x(self, *args):
            self.calls.append((current[-1], args))
            return 0

        def stpu_q(self, *args):
            return (current[-1], args)

        def stpu_fail(self, *args):
            return 700

        def stpu_error_string(self, err):
            return b"an illegal memory access"

    lib = Lib()
    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev:
                        SimpleNamespace(cuda_stream=1000 + dev.index))
    monkeypatch.setattr(_build, "lib", lambda: lib)
    dev = torch.device("cuda", 1)
    _build.launch(dev, "stpu_x", 5, 6)
    assert lib.calls == [(dev, (5, 6, 1001))] and not current
    assert _build.query(dev, "stpu_q", 3) == (dev, (3,))
    with pytest.raises(RuntimeError, match="pair_count kernel launch failed: "
                       "an illegal memory access"):
        _build.launch(dev, "stpu_fail", what="pair_count")
    assert not current


@pytest.mark.parametrize("local_rank", [None, "3"])
def test_devices_are_every_gpu_or_the_ranks_one(monkeypatch, local_rank):
    """cuda mode: every visible GPU in one process, the rank's one GPU
    under torchrun (LOCAL_RANK); cpu mode one CPU device; host none."""
    monkeypatch.setenv("SKETCHTPU_TORCH_BACKEND", "cuda")
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    chosen = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device",
                        lambda: chosen[-1] if chosen else 0)
    monkeypatch.setattr(torch.cuda, "set_device", chosen.append)
    devs = runtime.devices()
    if local_rank is None:
        assert devs == [torch.device("cuda", 0), torch.device("cuda", 1)]
        assert chosen == []
    else:
        assert devs == [torch.device("cuda", 1)] and chosen == [1]
    assert runtime.device() == devs[0]
    monkeypatch.setenv("SKETCHTPU_TORCH_BACKEND", "cpu")
    assert runtime.devices() == [torch.device("cpu")]
    monkeypatch.setenv("SKETCHTPU_TORCH_BACKEND", "host")
    assert runtime.devices() is None and runtime.device() is None


def _c_entry_points() -> dict:
    """{name: [ctypes type of each parameter]} of every extern "C"
    stpu_* function in csrc/*.cu, from its declaration."""
    import ctypes
    import re

    def ctype(param: str):
        if "*" in param:
            return ctypes.c_void_p
        for c_name, t in (("unsigned long long", ctypes.c_ulonglong),
                          ("long long", ctypes.c_longlong),
                          ("float", ctypes.c_float), ("int", ctypes.c_int)):
            if c_name in param:
                return t
        raise AssertionError(f"unknown C parameter type: {param!r}")

    found = {}
    for src in _build.sources():
        for m in re.finditer(r'extern "C"\s+[\w\s*]*?\b(stpu_\w+)\s*\(([^)]*)\)',
                             src.read_text()):
            params = [p for p in m.group(2).split(",")
                      if p.strip() not in ("", "void")]
            found[m.group(1)] = [ctype(p) for p in params]
    return found


def test_every_kernel_entry_point_is_bound_with_its_c_signature():
    """The ctypes signature of each C entry point (_build._SIGNATURES)
    matches its declaration in csrc/ parameter for parameter (pointers,
    int, long long, float), and every stpu_* function but the error
    string is bound: nothing compiles the sources here, and a wrong
    binding would pass the wrong bytes without an error."""
    declared = _c_entry_points()
    assert set(declared) - set(_build._SIGNATURES) == {"stpu_error_string"}
    for name, argtypes in _build._SIGNATURES.items():
        assert list(argtypes) == declared[name], name
