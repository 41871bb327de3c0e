"""Reads (FASTQ) sketching in the port: the signs mode of the ntHash kernel
(its twin, and its wrapper on CPU tensors) against the JAX package's XLA
program hash_signs_kernel on JAX-CPU and against its NumPy oracle, bit for
bit; the chunked read path against the unchunked one, n_starts included;
and `sketch` of reads, alone, paired and mixed with assemblies, at
--min-count 1, 2 and 3, byte-identical to the JAX package's host oracle.
Inputs are made from seeds with numpy."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sketchtpu import cli as jax_cli
from sketchtpu.hash.nthash_np import nthash_all, valid_window_mask
from sketchtpu.ingest.fastx import DnaStream, read_dna_sample
from sketchtpu.sketchcore.signs import signs_from_hashes
from sketchtpu.sketchcore.sketch_jax import DeviceSketchBackend as JaxBackend
from sketchtpu_torch.hash import nthash_torch
from sketchtpu_torch.hash.nthash_torch import (
    k_groups,
    nthash_signs,
    nthash_signs_ref,
    pack_group,
)
from sketchtpu_torch.ingest import fastx as port_fastx
from sketchtpu_torch.sketchcore import sketch_torch
from sketchtpu_torch.sketchcore.sketch_torch import (
    DeviceSketchBackend,
    read_chunks,
)
from sketchtpu_torch.synth import read_samples, related_assemblies

REPO = Path(__file__).resolve().parent.parent
U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def _read_stream(n: int, seed: int, read_len: int = 150):
    """A reads-like stream: random bases, a break at every read end and a
    few N runs (breaks inside reads)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n).astype(np.uint8)
    breaks = np.arange(read_len, n + 1, read_len)
    breaks = np.unique(np.concatenate([breaks, rng.integers(1, n, n // 400),
                                       [n]]))
    return codes, breaks.astype(np.int64)


def _streams(n: int, seed: int):
    codes, breaks = _read_stream(n, seed)
    return (DnaStream(codes=codes, breaks=breaks, reads=True),
            port_fastx.DnaStream(codes=codes, breaks=breaks, reads=True))


def _port_signs(stream, kmers, rc, n_out=None):
    seq, _ = pack_group([stream])
    return nthash_signs(torch.from_numpy(seq), kmers, rc, n_out).numpy().view(
        np.uint64)


@pytest.mark.parametrize("rc", [True, False])
@pytest.mark.parametrize("k", [3, 17, 31])
def test_signs_twin_matches_hash_signs_kernel(k, rc):
    """The XLA program on JAX-CPU: the sign of every window start, kept
    where valid_window_mask says the window is valid."""
    jax_stream, stream = _streams(3000, seed=k)
    got = _port_signs(stream, [k], rc)[0]
    backend = JaxBackend()
    lo, hi = backend._dispatch_signs(jax_stream, k, rc)
    m = stream.seq_len - k + 1
    want = (np.asarray(hi)[:m].astype(np.uint64) << np.uint64(32)) | \
        np.asarray(lo)[:m].astype(np.uint64)
    mask = valid_window_mask(stream.seq_len, jax_stream.breaks, k)
    assert got.shape == (m,)
    assert ((got != U64_MAX) == mask).all()
    assert (got[mask] == want[mask]).all()
    assert (got[mask] == backend.signs_in_order(jax_stream, k, rc)).all()


@pytest.mark.parametrize("k", [1, 2, 64, 100])
def test_signs_twin_matches_numpy_oracle(k):
    jax_stream, stream = _streams(2000, seed=100 + k)
    got = _port_signs(stream, [k], True)[0]
    mask = valid_window_mask(stream.seq_len, jax_stream.breaks, k)
    want = signs_from_hashes(nthash_all(jax_stream.codes, k, True))
    assert ((got != U64_MAX) == mask).all()
    assert (got[mask] == want[mask]).all()
    assert (got < np.uint64((1 << 61) - 1))[mask].all()


def test_signs_multi_k_rows_are_the_single_k_rows():
    """One call for several k (unsorted, repeated) gives each k's row over
    the window starts of the smallest k, u64 max past a k's last window."""
    _, stream = _streams(1500, seed=3)
    kmers = [21, 5, 33, 5]
    got = _port_signs(stream, kmers, True)
    assert got.shape == (4, stream.seq_len - 5 + 1)
    for ki, k in enumerate(kmers):
        m = stream.seq_len - k + 1
        assert (got[ki, :m] == _port_signs(stream, [k], True)[0]).all()
        assert (got[ki, m:] == U64_MAX).all()


def test_signs_n_out_and_short_sequences():
    _, stream = _streams(600, seed=4)
    full = _port_signs(stream, [17], True)
    assert (_port_signs(stream, [17], True, n_out=100) == full[:, :100]).all()
    over = _port_signs(stream, [17], True, n_out=700)
    assert (over[:, : full.shape[1]] == full).all()
    assert (over[:, full.shape[1]:] == U64_MAX).all()
    seq = torch.zeros(5, dtype=torch.uint8)
    assert nthash_signs(seq, [17], True).shape == (1, 0)
    assert (nthash_signs(seq, [17], True, n_out=3) == -1).all()


def test_signs_twin_is_the_wrapper_on_cpu():
    _, stream = _streams(900, seed=5)
    seq = torch.from_numpy(pack_group([stream])[0])
    assert torch.equal(nthash_signs(seq, [17, 19], True),
                       nthash_signs_ref(seq, [17, 19], True, 900 - 17 + 1))


@pytest.mark.parametrize("chunk", [1, 7, 64, 10_000])
@pytest.mark.parametrize("n_starts", [None, 0, 1, 63, 64, 65, 500])
def test_chunked_signs_equal_unchunked(chunk, n_starts, monkeypatch):
    """Chunks of `chunk` window starts, each reading its k - 1 bases of
    overlap: the concatenated valid signs are the unchunked stream's, with
    n_starts carried through every split."""
    _, stream = _streams(1200, seed=6)
    k = 21
    monkeypatch.setattr(sketch_torch, "_chunk_starts", lambda nk: chunk)
    backend = DeviceSketchBackend(torch.device("cpu"))
    got = backend.collect_signs_maybe_filtered(
        backend.dispatch_signs_maybe_filtered(stream, k, True, 64, 1,
                                              n_starts=n_starts))
    row = _port_signs(stream, [k], True)[0]
    take = row.shape[0] if n_starts is None else min(n_starts, row.shape[0])
    want = row[:take][row[:take] != U64_MAX]
    assert np.array_equal(got, want)
    owned = [own for _, own in read_chunks(stream.seq_len, [k], chunk,
                                            n_starts)]
    assert sum(owned) == take and all(o <= chunk for o in owned)


def test_signs_streams_all_k_in_one_pass_equal_per_k(monkeypatch):
    """The sketch path's multi-k chunk launches against signs_in_order per
    (stream, k), for streams shorter and longer than a chunk."""
    streams = [_streams(n, seed=10 + n)[1] for n in (40, 700, 2500)]
    kmers = [17, 25, 31]
    monkeypatch.setattr(sketch_torch, "_chunk_starts", lambda nk: 300)
    backend = DeviceSketchBackend(torch.device("cpu"))
    got = {}
    backend._signs_streams(list(enumerate(streams)), kmers, True,
                           lambda i, signs: got.__setitem__(i, signs))
    assert sorted(got) == [0, 1, 2]
    for i, s in enumerate(streams):
        for ki, k in enumerate(kmers):
            assert np.array_equal(got[i][ki], backend.signs_in_order(s, k,
                                                                     True))


def test_read_chunks_bound_launches(monkeypatch):
    """A stream of many chunks keeps at most _READ_AHEAD launches in
    flight: each chunk's copy is read before the next but one starts."""
    _, stream = _streams(3000, seed=8)
    monkeypatch.setattr(sketch_torch, "_chunk_starts", lambda nk: 100)
    backend = DeviceSketchBackend(torch.device("cpu"))
    events = _track_copies(monkeypatch)
    backend._signs_streams([(0, stream)], [17], True, lambda *a: None)
    in_flight = np.cumsum([1 if e == "launch" else -1 for e in events])
    assert events.count("launch") == 30
    assert in_flight.max() == sketch_torch._READ_AHEAD + 1


def _track_copies(monkeypatch) -> list:
    """Every launch's HostCopy (made as the launch is) and every read of
    one, in order."""
    events = []

    class Tracked(sketch_torch.HostCopy):
        def __init__(self, t):
            super().__init__(t)
            events.append("launch")

        def numpy(self):
            events.append("read")
            return super().numpy()

    monkeypatch.setattr(sketch_torch, "HostCopy", Tracked)
    return events


def _on_cpu(fn):
    """torch.empty / torch.full that ignore the device (a CUDA stand-in's
    results live on the CPU)."""
    return lambda *a, device=None, **kw: fn(*a, **kw)


def test_signs_split_past_128_k_makes_two_launches(monkeypatch):
    """129 k values on a CUDA tensor: two launches of the signs mode (128
    k, then 1), written into one result in kmers order."""
    from tests.test_torch_runtime import _FakeCuda

    calls = []

    def launch(seq, ks, rc, n_out, out):
        calls.append(list(ks))
        out.copy_(nthash_signs_ref(seq._t, ks, rc, n_out))

    monkeypatch.setattr(nthash_torch, "_launch_nthash_signs", launch)
    monkeypatch.setattr(nthash_torch, "nthash_signs_ref",
                        lambda *a: pytest.fail("twin reached"))
    monkeypatch.setattr(torch, "empty", _on_cpu(torch.empty))
    _, stream = _streams(400, seed=9)
    seq_cpu = torch.from_numpy(pack_group([stream])[0])
    kmers = list(range(130, 1, -1))  # 129 values, descending
    before = nthash_signs.launches
    got = nthash_signs(_FakeCuda(seq_cpu), kmers, True)
    assert nthash_signs.launches == before + 2
    assert [len(c) for c in calls] == [128, 1]
    assert calls[0] == sorted(calls[0]) and calls[1] == [130]
    monkeypatch.undo()
    assert torch.equal(got, nthash_signs(seq_cpu, kmers, True))


def test_bin_split_past_128_k_makes_two_launches(monkeypatch):
    """The bin mode's split: 129 k values, two launches into one result."""
    from tests.test_torch_runtime import _FakeCuda

    calls = []

    def launch(seq, ks, rc, starts, nbins, out):
        calls.append(list(ks))
        out.copy_(nthash_torch.nthash_bin_multi_ref(seq._t, ks, rc,
                                                    starts._t, nbins))

    monkeypatch.setattr(nthash_torch, "_launch_nthash_multi", launch)
    monkeypatch.setattr(torch, "full", _on_cpu(torch.full))
    _, stream = _streams(300, seed=10)
    seq, starts = (torch.from_numpy(x) for x in pack_group([stream]))
    kmers = list(range(2, 131))
    before = nthash_torch.nthash_bin_multi.launches
    got = nthash_torch.nthash_bin_multi(_FakeCuda(seq), kmers, True,
                                        _FakeCuda(starts), 64)
    assert nthash_torch.nthash_bin_multi.launches == before + 2
    assert [len(c) for c in calls] == [128, 1]
    monkeypatch.undo()
    assert torch.equal(got, nthash_torch.nthash_bin_multi(seq, kmers, True,
                                                          starts, 64))


# --- `sketch` of reads through the CLIs --------------------------------------

@pytest.fixture(scope="module")
def reads_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_reads")
    lines = (read_samples(d / "fq", 2, 6000, 10, seed=1)
             + read_samples(d / "fq", 1, 6000, 10, seed=2, paired=True))
    (d / "reads.txt").write_text("".join(lines))
    rfile = related_assemblies(d / "fa", 3, 12000, seed=5, max_contigs=4)
    (d / "mixed.txt").write_text(rfile.read_text() + "".join(lines))
    return d


_PORT_SKETCH = """
import sys
from sketchtpu_torch.cli import main
assert main(sys.argv[1:]) == 0
assert "jax" not in sys.modules
"""


@pytest.mark.parametrize("min_count", [1, 2, 3])
@pytest.mark.parametrize("inputs", ["reads", "mixed"])
def test_sketch_reads_identical_to_host(reads_dir, inputs, min_count,
                                        monkeypatch):
    d = reads_dir
    argv = ["sketch", "-f", str(d / f"{inputs}.txt"), "-k", "17,21,25",
            "-s", "256", "--min-count", str(min_count), "--threads", "2",
            "--quiet"]
    port, host = d / f"port_{inputs}_{min_count}", d / f"host_{inputs}_{min_count}"
    proc = subprocess.run(
        [sys.executable, "-c", _PORT_SKETCH, *argv, "-o", str(port)],
        env={**os.environ, "SKETCHTPU_TORCH_BACKEND": "cpu",
             "PYTHONPATH": str(REPO)},
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    monkeypatch.setenv("SKETCHTPU_BACKEND", "host")
    assert jax_cli.main([*argv, "-o", str(host)]) == 0
    for ext in (".skd", ".skm"):
        got, want = Path(f"{port}{ext}"), Path(f"{host}{ext}")
        assert got.stat().st_size > 0
        assert got.read_bytes() == want.read_bytes(), ext


def test_inverted_reads_take_the_bounded_chunked_path(reads_dir,
                                                      monkeypatch):
    """`inverted build` / `query` sketch reads through the sketch path's
    chunk launches (at most _READ_AHEAD + 1 copies in flight) and its
    pooled count filter: the sign matrix equals the host loop's."""
    from sketchtpu_torch.inverted.index import sketch_files_inverted

    lines = (reads_dir / "mixed.txt").read_text().splitlines()
    files = [(ln.split("\t")[0], ln.split("\t")[1:]) for ln in lines]
    order = list(range(len(files)))
    want, names = sketch_files_inverted(files, order, 17, 100, True, 2, 20)
    monkeypatch.setattr(sketch_torch, "_chunk_starts", lambda nk: 5000)
    events = _track_copies(monkeypatch)
    got, got_names = sketch_files_inverted(
        files, order, 17, 100, True, 2, 20,
        backend=DeviceSketchBackend(torch.device("cpu")), threads=2)
    assert got_names == names and np.array_equal(got, want)
    in_flight = np.cumsum([1 if e == "launch" else -1 for e in events])
    assert events.count("launch") > 3 * 10  # 3 read samples of 60 kb
    assert in_flight.max() <= sketch_torch._READ_AHEAD + 1


def test_backend_reads_sketch_equals_host_sketches(reads_dir, monkeypatch):
    """The backend on parsed streams (paired files are one stream),
    against the JAX host oracle's Sketch objects: signs and the reads'
    seq_length estimate."""
    from sketchtpu.sketchcore.sketch import sketch_dna_sample

    lines = (reads_dir / "reads.txt").read_text().splitlines()
    files = [ln.split("\t")[1:] for ln in lines]
    streams = [port_fastx.read_dna_sample(f, 20) for f in files]
    monkeypatch.setattr(sketch_torch, "_chunk_starts", lambda nk: 5000)
    got = DeviceSketchBackend(torch.device("cpu")).sketch_dna_streams(streams, ["a", "b", "c"], [17, 21], 256, True, 2)
    for f, sk in zip(files, got):
        want = sketch_dna_sample(read_dna_sample(f, 20), "x", [17, 21], 256,
                                 True, 2)
        assert sk.reads and sk.seq_length == want.seq_length
        assert np.array_equal(sk.usigs, want.usigs)
        assert sk.densified == want.densified
