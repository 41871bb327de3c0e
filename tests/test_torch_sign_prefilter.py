"""The reads path's sign prefilter in the port
(sketchtpu_torch/sketchcore/sign_prefilter.py, SKETCHTPU_FASTQ_PREFILTER).

Its plain PyTorch twin against the JAX package's XLA program
prefilter_signs_device on JAX-CPU, survivor for survivor (the same signs
given as (lo, hi, validbits) there and as int64 with -1 here); replay of
the survivors through the host count filter, whole and over arbitrary
segmentations, against the full stream's bins; a NumPy model of the
kernel's control flow (csrc/sign_prefilter.cu: tiles, a thread's windows,
the block scan of state maps) against the twin; the kernel wrapper's
dispatch; the backend under the JAX package's own call pattern; and
`sketch` / `inverted build` of reads in cpu mode with the knob on,
byte-identical to the knob off and to the JAX package's host oracle.
Inputs are made from seeds with numpy."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketchtpu import cli as jax_cli
from sketchtpu.ingest.fastx import DnaStream as JaxStream
from sketchtpu.sketchcore.sign_prefilter import prefilter_signs_device
from sketchtpu.sketchcore.signs import bin_minima_filtered as jax_filtered
from sketchtpu.sketchcore.sketch_jax import DeviceSketchBackend as JaxBackend
from sketchtpu.sketchcore.sketch_jax import bin_magic
from sketchtpu_torch import _build
from sketchtpu_torch import cli as port_cli
from sketchtpu_torch.ingest.fastx import DnaStream
from sketchtpu_torch.sketchcore import sign_prefilter as sp
from sketchtpu_torch.sketchcore import sketch_torch
from sketchtpu_torch.sketchcore.sketch_torch import DeviceSketchBackend
from sketchtpu_torch.sketchcore.signs import bin_minima_filtered, bin_size
from sketchtpu_torch.synth import read_samples, related_assemblies
from tests.test_torch_runtime import _FakeCuda as _FakeTensor

U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)
NONE = (1 << 63) - 1


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The twins run many small CPU ops: one intra-op thread a test keeps
    them from waiting on a thread pool that shares its cores with the
    other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _heavy(seed, m, nbins, invalid=0.1):
    """m signs drawn from 400 values of the bins' range (heavy collisions,
    so the count filter's state matters), and which windows are valid."""
    rng = np.random.default_rng(seed)
    values = rng.integers(0, int(bin_size(nbins)) * nbins, 400).astype(
        np.uint64)
    return rng.choice(values, m), rng.random(m) >= invalid


def _jax_survivors(signs, valid, nbins, mc):
    m = signs.size
    vbits = np.packbits(np.pad(valid, (0, (-m) % 8)), bitorder="little")
    lo = (signs & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (signs >> np.uint64(32)).astype(np.uint32)
    c_lo, c_hi, count = prefilter_signs_device(
        jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(vbits), min_count=mc,
        num_bins=nbins, magic=bin_magic(nbins), cap=m)
    count = int(count)
    return (np.asarray(c_hi)[:count].astype(np.uint64) << np.uint64(32)) | \
        np.asarray(c_lo)[:count].astype(np.uint64)


def _as_row(signs, valid) -> torch.Tensor:
    """The signs as nthash_signs writes them: int64, -1 where invalid."""
    return torch.from_numpy(np.where(valid, signs, U64_MAX).view(np.int64))


def _port_survivors(signs, valid, nbins, mc, fn=sp.prefilter_signs_ref):
    return fn(_as_row(signs, valid), nbins, mc).numpy().view(np.uint64)


def _check_against_xla(signs, valid, nbins, mc) -> np.ndarray:
    """The twin's survivors: the XLA program's sequence, and a replay that
    gives the full stream's bins."""
    got = _port_survivors(signs, valid, nbins, mc)
    assert np.array_equal(got, _jax_survivors(signs, valid, nbins, mc))
    assert np.array_equal(bin_minima_filtered(got, nbins, mc),
                          bin_minima_filtered(signs[valid], nbins, mc))
    return got


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("m,nbins", [(4000, 64), (20000, 16)])
@pytest.mark.parametrize("mc", [2, 3, 5])
def test_twin_equals_the_xla_program(seed, m, nbins, mc):
    signs, valid = _heavy(seed, m, nbins)
    got = _check_against_xla(signs, valid, nbins, mc)
    assert got.size < valid.sum()  # high coverage: most are dropped
    assert np.array_equal(got, _port_survivors(signs, valid, nbins, mc,
                                                sp.prefilter_signs))


def _unique(nbins):
    rng = np.random.default_rng(3)
    m = 1000
    signs = rng.permutation(np.arange(1, m + 1, dtype=np.uint64)
                            * np.uint64(12345701)) % np.uint64(
        int(bin_size(nbins)) * nbins)
    return signs, np.ones(m, bool)


def _out_of_range(nbins):
    top = np.uint64(int(bin_size(nbins)) * nbins)
    signs = np.array([5, top + np.uint64(7), 5, top + np.uint64(9), 5],
                     dtype=np.uint64)
    return signs, np.ones(5, bool)


def _all_invalid(nbins):
    signs, _ = _heavy(4, 3000, nbins)
    return signs, np.zeros(3000, bool)


def _one_long_run(nbins):
    """One sign of bin 0 in 600 of 2000 windows, the rest collisions."""
    signs, valid = _heavy(5, 2000, nbins)
    rng = np.random.default_rng(6)
    signs[rng.random(2000) < 0.3] = np.uint64(int(bin_size(nbins)) // 3)
    return signs, valid


@pytest.mark.parametrize("mc", [2, 5])
@pytest.mark.parametrize("case,kept", [
    (_unique, "all"), (_out_of_range, 3), (_all_invalid, 0),
    (_one_long_run, None)])
def test_special_streams(case, kept, mc):
    """Every sign unique (no count ever reaches min_count: all kept, in
    stream order), signs past the last bin (dropped), no valid window, and
    one sign's run longer than most of the stream."""
    signs, valid = case(16)
    got = _check_against_xla(signs, valid, 16, mc)
    if kept == "all":
        assert np.array_equal(got, signs)
    elif kept is not None:
        assert got.size == kept


def test_empty_row():
    """m = 0: nothing kept, the bins stay empty (the XLA program is not
    defined for an empty stream: its scans reject the length)."""
    empty = torch.zeros(0, dtype=torch.int64)
    for fn in (sp.prefilter_signs, sp.prefilter_signs_ref):
        assert fn(empty, 16, 3).numel() == 0
    assert sp.keep_flags(empty.view(1, 0), 16, 3)[0].numel() == 0
    assert sp.survivors(empty.view(0, 5), []) == []


@pytest.mark.parametrize("mc", [2, 3, 5])
@pytest.mark.parametrize("seed", range(3))
def test_segmentations_replay_to_the_stream_bins(seed, mc):
    """Survivors of each segment, concatenated in order, replay to the
    whole stream's bins, for cuts at random points and at a fixed length
    below the long run's (one sign in 30 % of the windows)."""
    nbins = 32
    signs, valid = _one_long_run(nbins) if seed == 0 else _heavy(
        seed, 6000, nbins)
    m = signs.size
    want = bin_minima_filtered(signs[valid], nbins, mc)
    rng = np.random.default_rng(100 + seed)
    cut_sets = [np.sort(rng.choice(np.arange(1, m), 7, replace=False)),
                np.arange(50, m, 50), np.array([], dtype=np.int64)]
    for cuts in cut_sets:
        bounds = [0, *cuts.tolist(), m]
        kept = np.concatenate([
            _port_survivors(signs[a:b], valid[a:b], nbins, mc)
            for a, b in zip(bounds[:-1], bounds[1:])])
        assert np.array_equal(bin_minima_filtered(kept, nbins, mc), want)


def test_sorted_keys_put_invalid_and_unbinned_signs_last():
    nbins = 16
    top = int(bin_size(nbins)) * nbins
    row = torch.tensor([9, -1, top, 3, 9, top - 1, -1, 3])
    keys, pos = sp.sorted_keys(row, nbins)
    assert keys.tolist() == [3, 3, 9, 9, top - 1] + [NONE] * 3
    assert pos.tolist()[:5] == [3, 7, 0, 4, 5]


def _kernel_model(keys, pos, mc, nbins, nt, ipt):
    """csrc/sign_prefilter.cu's control flow in NumPy on Python ints: a
    block per bin (its span by binary search), tiles of nt threads x ipt
    windows, each thread composing its windows' maps of the state (before,
    running) with Then, an exclusive scan of the threads' maps in the
    tree order of a Hillis-Steele scan (not left to right), and the state
    carried from tile to tile."""
    keys, pos = keys.tolist(), pos.tolist()
    flags = np.zeros(len(keys), bool)
    bs = int(bin_size(nbins))
    ident = (NONE, NONE, 0)  # (a, x, f)

    def then(s1, s2):
        return (min(s1[1], s2[0]) if s2[2] else s1[0], min(s1[1], s2[1]),
                s1[2] | s2[2])

    for b in range(nbins):
        lo = int(np.searchsorted(keys, b * bs))
        hi = int(np.searchsorted(keys, (b + 1) * bs))
        before = running = NONE
        for t0 in range(lo, hi, nt * ipt):
            mine, windows = [], []
            for t in range(nt):
                step, ws = ident, []
                for j in range(ipt):
                    i = t0 + t * ipt + j
                    if i >= hi:
                        continue
                    start = i == lo or keys[i] != keys[i - 1]
                    s = i - (mc - 1)
                    c = (pos[i] if s >= lo and keys[s] == keys[i]
                         and (s == lo or keys[s - 1] != keys[i]) else NONE)
                    step = then(step, (NONE, c, int(start)))
                    ws.append((start, c, pos[i]))
                mine.append(step)
                windows.append(ws)
            incl, d = list(mine), 1
            while d < nt:
                incl = [incl[t] if t < d else then(incl[t - d], incl[t])
                        for t in range(nt)]
                d *= 2
            prefix = [ident] + incl[:-1]
            for t in range(nt):
                a, x, f = prefix[t]
                bf = min(running, a) if f else before
                rn = min(running, x)
                for start, c, p in windows[t]:
                    if start:
                        bf = rn
                    rn = min(rn, c)
                    if bf >= p:
                        flags[p] = True
            a, x, f = incl[-1]
            before = min(running, a) if f else before
            running = min(running, x)
    return flags


@pytest.mark.parametrize("nt,ipt", [(4, 3), (8, 8), (32, 1)])
@pytest.mark.parametrize("mc", [1, 2, 5])
def test_kernel_model_equals_the_twin(nt, ipt, mc):
    """Bins longer than a tile, tiles that end inside a run, runs that
    start in one thread and end in another."""
    signs, valid = _heavy(nt * ipt + mc, 1500, 4)
    keys, pos = sp.sorted_keys(_as_row(signs, valid), 4)
    want = sp.sign_prefilter_keep_ref(keys, pos, mc, 4)
    assert np.array_equal(_kernel_model(keys, pos, mc, 4, nt, ipt),
                          want.numpy())
    assert want.sum() < valid.sum()


class _FakeCuda(_FakeTensor):
    """A CUDA tensor's stand-in with a data pointer to launch with."""

    def __init__(self, t, ptr):
        super().__init__(t)
        self._ptr = ptr

    def data_ptr(self):
        return self._ptr


def test_keep_wrapper_launches_on_cuda_tensors(monkeypatch):
    """A CUDA tensor launches the kernel (one block a bin: nbins and the
    bin size go with the pointers) and counts the launch; the twin is
    never reached."""
    calls = []
    monkeypatch.setattr(_build, "launch",
                        lambda dev, name, *args, what: calls.append(
                            (dev, name, args, what)))
    monkeypatch.setattr(sp, "sign_prefilter_keep_ref",
                        lambda *a: pytest.fail("twin reached"))
    real_zeros = torch.zeros
    monkeypatch.setattr(torch, "zeros",
                        lambda *a, device=None, **kw: real_zeros(*a, **kw))
    keys, pos = sp.sorted_keys(torch.tensor([4, 2, -1, 2]), 8)
    before = sp.sign_prefilter_keep.launches
    flags = sp.sign_prefilter_keep(_FakeCuda(keys, 111), _FakeCuda(pos, 222),
                                   3, 8)
    assert sp.sign_prefilter_keep.launches == before + 1
    (dev, name, args, what), = calls
    assert (dev.type, name, what) == ("cuda", "stpu_sign_prefilter_keep",
                                      "sign_prefilter_keep")
    assert args == (111, 222, 4, 3, int(bin_size(8)), 8, flags.data_ptr())
    empty = torch.zeros(0, dtype=torch.int64)
    sp.sign_prefilter_keep(_FakeCuda(empty, 1), _FakeCuda(empty, 2), 3, 8)
    assert len(calls) == 1 and sp.sign_prefilter_keep.launches == before + 1


def test_keep_wrapper_checks_its_input():
    keys, pos = sp.sorted_keys(torch.tensor([4, 2, 2]), 8)
    assert torch.equal(sp.sign_prefilter_keep(keys, pos, 2, 8),
                       sp.sign_prefilter_keep_ref(keys, pos, 2, 8))
    for bad in ((keys.int(), pos, 2, 8), (keys, pos[:2], 2, 8),
                (keys, pos, 0, 8), (keys, pos, 2, 0),
                (keys.view(1, 3), pos.view(1, 3), 2, 8)):
        with pytest.raises(ValueError):
            sp.sign_prefilter_keep(*bad)


def test_knob(monkeypatch):
    monkeypatch.delenv("SKETCHTPU_FASTQ_PREFILTER", raising=False)
    assert not sp.enabled(5)
    for value, on in (("1", True), ("on", True), ("0", False),
                      ("yes", False)):
        monkeypatch.setenv("SKETCHTPU_FASTQ_PREFILTER", value)
        assert sp.enabled(5) == on and not sp.enabled(1)


# --- the backend --------------------------------------------------------------

def _reads_streams(seed, genome=4000, reads=300, read_len=150):
    """(JAX, port) DnaStreams of reads of a random genome at
    reads * read_len / genome coverage, half reverse-complemented."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, genome).astype(np.uint8)
    codes = np.empty(reads * read_len, np.uint8)
    for i, s in enumerate(rng.integers(0, genome - read_len, reads)):
        r = g[s : s + read_len]
        codes[i * read_len : (i + 1) * read_len] = 3 - r[::-1] if i % 2 else r
    breaks = np.arange(1, reads, dtype=np.int64) * read_len
    acgt = np.ones(4, np.int64)
    return (JaxStream(codes=codes, breaks=breaks, acgt=acgt, reads=True),
            DnaStream(codes=codes, breaks=breaks, acgt=acgt, reads=True))


@pytest.mark.parametrize("knob", ["0", "1"])
@pytest.mark.parametrize("mc", [1, 2, 3])
def test_the_jax_call_pattern_on_the_port(knob, mc, monkeypatch):
    """inverted/index.py:555-558's calls, made on the port's backend and on
    the JAX backend (JAX-CPU): the same bins, the full stream's; with the
    prefilter on, the same signs, fewer than the stream's."""
    monkeypatch.setenv("SKETCHTPU_FASTQ_PREFILTER", knob)
    jax_stream, stream = _reads_streams(20 + mc)
    k, rc, sketch_size = 17, True, 64
    got = {}
    for who, backend, s in (("port", DeviceSketchBackend(torch.device("cpu")),
                             stream), ("jax", JaxBackend(), jax_stream)):
        h = backend.dispatch_signs_maybe_filtered(s, k, rc, sketch_size, mc)
        signs = backend.collect_signs_maybe_filtered(h)
        got[who] = (signs, jax_filtered(signs, sketch_size, mc))
    full = JaxBackend().signs_in_order(jax_stream, k, rc)
    assert np.array_equal(got["port"][0], got["jax"][0])
    assert np.array_equal(got["port"][1], got["jax"][1])
    assert np.array_equal(got["port"][1], jax_filtered(full, sketch_size, mc))
    filtered = knob == "1" and mc >= 2
    assert (got["port"][0].size < full.size) == filtered


@pytest.mark.parametrize("n_starts", [None, 1, 5000, 20000])
def test_dispatch_on_a_device_and_a_window_range(n_starts, monkeypatch):
    """dev and n_starts as the JAX backend takes them: the survivors of
    window starts [0, n_starts), on the given device."""
    monkeypatch.setenv("SKETCHTPU_FASTQ_PREFILTER", "1")
    _, stream = _reads_streams(30)
    backend = DeviceSketchBackend([torch.device("cpu")] * 2)
    got = backend.dispatch_signs_maybe_filtered(stream, 21, True, 64, 3,
                                                dev="cpu", n_starts=n_starts)
    full = backend.signs_in_order(stream, 21, True, n_starts)
    assert np.array_equal(bin_minima_filtered(got, 64, 3),
                          bin_minima_filtered(full, 64, 3))
    assert got.size <= full.size


@pytest.mark.parametrize("nk,starts", [(1, 1 << 26), (7, 1 << 26),
                                       (9, (1 << 29) // 9), (32, 1 << 24),
                                       (128, 1 << 24)])
def test_segment_length(nk, starts):
    """A segment holds at most 2^26 window starts and 2^29 signs over all
    k, and at least the JAX package's 2^24 window starts."""
    assert sketch_torch._segment_starts(nk) == starts
    assert starts >= sketch_torch._SEGMENT_MIN_STARTS


@pytest.mark.parametrize("segment", [20000, 1 << 20])
@pytest.mark.parametrize("slots", [1, 3])
def test_segments_replay_to_the_stream_bins(segment, slots, monkeypatch):
    """read_minima over streams in segments of `segment` window starts (a
    sign's run spans all three at 20000), segments in turn over device
    slots: the bins equal the knob off's, from fewer signs."""
    _, long = _reads_streams(40, genome=3000, reads=400)
    _, short = _reads_streams(41, genome=1000, reads=2)
    jobs = [(0, long), (1, short), (2, DnaStream(
        codes=np.zeros(10, np.uint8), breaks=np.zeros(0, np.int64),
        acgt=np.ones(4, np.int64), reads=True))]
    kmers = [17, 25]
    backend = DeviceSketchBackend([torch.device("cpu")] * slots)
    monkeypatch.setattr(sketch_torch, "_segment_starts", lambda nk: segment)
    seen = {}
    real = sketch_torch.bin_minima_filtered

    def counted(signs, nbins, mc):
        seen[knob] = seen.get(knob, 0) + signs.size
        return real(signs, nbins, mc)

    monkeypatch.setattr(sketch_torch, "bin_minima_filtered", counted)
    bins = {}
    for knob in ("0", "1"):
        monkeypatch.setenv("SKETCHTPU_FASTQ_PREFILTER", knob)
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(2) as pool:
            futs = backend.read_minima(jobs, kmers, True, 128, 4, pool)
            bins[knob] = {key: f.result() for key, f in futs.items()}
    assert sorted(bins["1"]) == sorted(bins["0"]) and len(bins["0"]) == 6
    for key, b in bins["0"].items():
        assert np.array_equal(bins["1"][key], b), key
    assert seen["1"] < seen["0"]


# --- `sketch` and `inverted build` of reads through the CLIs -----------------

@pytest.mark.parametrize("slots", [1, 2, 3])
def test_segments_in_flight(slots, monkeypatch):
    """Each segment's keep flags are launched before the segment before it
    is gathered: up to one segment a device slot and one more are in
    flight, on one device too, and every segment is gathered once."""
    monkeypatch.setenv("SKETCHTPU_FASTQ_PREFILTER", "1")
    _, stream = _reads_streams(42, genome=3000, reads=200)
    monkeypatch.setattr(sketch_torch, "_segment_starts", lambda nk: 2000)
    events = []
    real_flags, real_gather = sketch_torch.keep_flags, sketch_torch.survivors

    def flags(*a):
        events.append(1)
        return real_flags(*a)

    def gather(*a):
        events.append(-1)
        return real_gather(*a)

    monkeypatch.setattr(sketch_torch, "keep_flags", flags)
    monkeypatch.setattr(sketch_torch, "survivors", gather)
    backend = DeviceSketchBackend([torch.device("cpu")] * slots)
    got = backend.dispatch_signs_maybe_filtered(stream, 17, True, 64, 3)
    segments = -(-(stream.seq_len - 16) // 2000)
    assert events.count(1) == events.count(-1) == segments > slots + 1
    assert np.cumsum(events).max() == slots + 1
    full = backend.signs_in_order(stream, 17, True)
    assert np.array_equal(bin_minima_filtered(got, 64, 3),
                          bin_minima_filtered(full, 64, 3))


@pytest.fixture(scope="module")
def reads_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_prefilter")
    lines = (read_samples(d / "fq", 2, 6000, 12, seed=11)
             + read_samples(d / "fq", 1, 6000, 12, seed=12, paired=True))
    (d / "reads.txt").write_text("".join(lines))
    rfile = related_assemblies(d / "fa", 3, 12000, seed=13, max_contigs=4)
    (d / "mixed.txt").write_text(rfile.read_text() + "".join(lines))
    return d


_COMMANDS = {
    "sketch": (["sketch", "-k", "17,21,25", "-s", "256"], (".skd", ".skm")),
    "inverted": (["inverted", "build", "-s", "100", "-k", "17",
                  "--write-skq"], (".ski", ".skq")),
}


def _oracle(d: Path, command, inputs, mc, monkeypatch) -> Path:
    """The JAX package's host oracle's output, made once per case."""
    out = d / f"host_{command}_{inputs}_{mc}"
    argv, exts = _COMMANDS[command]
    if not Path(f"{out}{exts[0]}").exists():
        with monkeypatch.context() as m:
            m.setenv("SKETCHTPU_BACKEND", "host")
            assert jax_cli.main([*argv, "-f", str(d / f"{inputs}.txt"), "-o",
                                 str(out), "--min-count", str(mc),
                                 "--quiet"]) == 0
    return out


@pytest.mark.parametrize("mc", [1, 2, 3])
@pytest.mark.parametrize("inputs", ["reads", "mixed"])
@pytest.mark.parametrize("command", ["sketch", "inverted"])
def test_cli_with_the_prefilter_is_byte_identical(reads_dir, command, inputs,
                                                  mc, monkeypatch):
    """Reads (single and paired files), alone and with assemblies, in cpu
    mode: the knob on gives the knob off's bytes and the host oracle's;
    with --min-count >= 2 fewer signs reach the host's count filter (and
    with segments of 5000 window starts too)."""
    d = reads_dir
    want = _oracle(d, command, inputs, mc, monkeypatch)
    argv, exts = _COMMANDS[command]
    monkeypatch.setenv("SKETCHTPU_TORCH_BACKEND", "cpu")
    seen = {}
    real = sketch_torch.bin_minima_filtered

    def counted(signs, nbins, min_count):
        seen[run] = seen.get(run, 0) + signs.size
        return real(signs, nbins, min_count)

    monkeypatch.setattr(sketch_torch, "bin_minima_filtered", counted)
    for run, knob, segment in (("off", "0", None), ("on", "1", None),
                               ("on_5000", "1", 5000)):
        monkeypatch.setenv("SKETCHTPU_FASTQ_PREFILTER", knob)
        if segment is not None:
            monkeypatch.setattr(sketch_torch, "_segment_starts",
                                lambda nk: segment)
        out = d / f"port_{command}_{inputs}_{mc}_{run}"
        assert port_cli.main([*argv, "-f", str(d / f"{inputs}.txt"), "-o",
                              str(out), "--min-count", str(mc), "--threads",
                              "2", "--quiet"]) == 0
        for ext in exts:
            got = Path(f"{out}{ext}").read_bytes()
            assert got and got == Path(f"{want}{ext}").read_bytes(), (run,
                                                                     ext)
    if mc >= 2:
        assert seen["on"] < seen["off"] and seen["on_5000"] < seen["off"]
    else:
        assert seen["on"] == seen["off"] == seen["on_5000"]
