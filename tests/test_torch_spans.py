"""The port's span recorder (sketchtpu_torch/spans.py): off outside a
profiler and free there, its records under one (nesting, parent, run,
thread, counts, launches) on kineto's host clock, the stages that the
CLI's dist --knn and precluster --count record under their root, and
mesh.timeline()'s device spans off the card."""

import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sketchtpu_torch import cli as port_cli
from sketchtpu_torch import spans
from sketchtpu_torch.formats import skd, skm, snappy
from sketchtpu_torch.formats.skm import MultiSketch
from sketchtpu_torch.sketchcore.sketch import HashType, Sketch
from sketchtpu_torch.synth import derive_signs, derive_words

KMERS = (17, 21, 25)


def _new(before: int) -> list:
    return spans.recorded()[before:]


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _many(k: int) -> None:
    for _ in range(k):
        with spans.span("load"):
            spans.count("bytes", 1)


def test_off_records_nothing_and_allocates_nothing():
    """Outside a profiler a span is the shared no-op: nothing is recorded
    and nothing it allocates stays, or grows with the number of spans."""
    assert spans.span("load") is spans.span("scan", bytes=3)
    before = len(spans.recorded())
    _many(100)
    tracemalloc.start()
    try:
        _many(100)
        start, _ = tracemalloc.get_traced_memory()
        tracemalloc.reset_peak()
        _many(20_000)
        end, peak = tracemalloc.get_traced_memory()
        kept = tracemalloc.take_snapshot().filter_traces(
            [tracemalloc.Filter(True, spans.__file__)])
    finally:
        tracemalloc.stop()
    assert end <= start and peak - start < 2048
    assert sum(st.size for st in kept.statistics("filename")) == 0
    assert len(spans.recorded()) == before


def test_records_under_a_profiler_and_stops_with_it():
    before = len(spans.recorded())
    with _cpu_profile():
        with spans.span("cli.dist") as root:
            with spans.span("load", bytes=3):
                spans.count("bytes", 4)
                with spans.span("load.skd"):
                    spans.count("bytes", 10)
            with spans.span("write"):
                pass
    with spans.span("scan"):
        pass
    got = _new(before)
    assert [s.name for s in got] == ["cli.dist", "load", "load.skd", "write"]
    by = {s.name: s for s in got}
    assert by["load"].counts == {"bytes": 7}
    assert by["load.skd"].counts == {"bytes": 10}
    assert by["cli.dist"].parent is None
    assert by["load"].parent == root.id == by["write"].parent
    assert by["load.skd"].parent == by["load"].id
    assert len({s.run for s in got}) == 1 and root.run is not None
    assert {s.thread for s in got} == {threading.get_ident()}
    for s in got:
        assert s.start_ns <= s.end_ns
    assert root.start_ns <= by["load"].start_ns <= by["load.skd"].end_ns \
        <= by["load"].end_ns <= by["write"].start_ns <= root.end_ns


def test_runs_threads_and_launches():
    """Spans of another thread join the run that is open, with no parent
    there and counts of their own; each root opens a run of its own; a
    span given kernels counts their launches inside it."""

    def kernel():
        kernel.launches += 1

    kernel.launches = 5
    before = len(spans.recorded())
    with _cpu_profile():
        with spans.span("cli.dist") as first:

            def work():
                with spans.span("values"):
                    spans.count("pairs", 2)

            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
            with spans.span("scan", kernels=(kernel,)) as scan:
                kernel()
                kernel()
                spans.count("launches", 1)
        with spans.span("cli.inverted") as second:
            pass
    got = {s.name: s for s in _new(before)}
    other = got["values"]
    assert other.thread != first.thread and other.parent is None
    assert other.run == first.run and other.counts == {"pairs": 2}
    assert scan.counts == {"launches": 3} and scan.parent == first.id
    assert second.run != first.run


def test_an_op_inside_a_span_is_inside_it_on_kinetos_clock():
    """time.time_ns() is the clock kineto stamps host events with: an aten
    op run inside a span starts inside it."""
    with _cpu_profile() as prof:
        with spans.span("scan") as s:
            x = torch.arange(1000) + 1
    assert int(x[-1]) == 1000
    starts = [ev.start_ns() for ev in prof.profiler.kineto_results.events()
              if ev.name() == "aten::add"]
    assert starts and all(s.start_ns <= t <= s.end_ns for t in starts)


def test_annotate_opens_record_function_ranges():
    """Under a profiler the program started itself, each span is also a
    record_function range of its name; otherwise it is none."""
    with _cpu_profile() as prof:
        with spans.span("load"):
            pass
        spans.annotate(True)
        try:
            with spans.span("scan"):
                pass
        finally:
            spans.annotate(False)
    names = {ev.name() for ev in prof.profiler.kineto_results.events()}
    assert "scan" in names and "load" not in names


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    """A 60-sample database at three k and its inverted index."""
    d = tmp_path_factory.mktemp("torch_spans")
    n = 60
    rng = np.random.default_rng(11)
    parents = rng.integers(0, 2**64, (3, len(KMERS), 4, 14), dtype=np.uint64)
    words = derive_words(parents, n, KMERS, 11)
    names = [f"s{i:03d}" for i in range(n)]
    with skd.SketchDataWriter(str(d / "db.skd")) as wr:
        sketches = [Sketch(name=nm, index=wr.write_sketch(words[i].reshape(-1)))
                    for i, nm in enumerate(names)]
    MultiSketch(sketches, 256, list(KMERS), HashType("dna")).save_metadata(
        str(d / "db"))
    from sketchtpu_torch.synth import write_derived_inverted

    write_derived_inverted(str(d / "inv"), names, derive_signs(n, 30, 4, 12),
                           17)
    return d


def _stages(argv) -> dict:
    """{path of names below the root: span} of one CLI run under a
    profiler, with the root under the key ()."""
    before = len(spans.recorded())
    with _cpu_profile():
        assert port_cli.main(argv) == 0
    got = _new(before)
    by_id = {s.id: s for s in got}
    roots = [s for s in got if s.parent is None]
    assert len(roots) == 1 and len({s.run for s in got}) == 1
    out = {}
    for s in got:
        path, up = [], s
        while up.parent is not None:
            path.append(up.name)
            up = by_id[up.parent]
        out.setdefault(tuple(reversed(path)), []).append(s)
    return out


@pytest.mark.parametrize("mode", ["coreacc", "single-k"])
def test_dist_knn_records_its_stages(db, tmp_path, monkeypatch, mode):
    monkeypatch.setenv("SKETCHTPU_TORCH_BACKEND", "cpu")
    k = ["-k", "17"] if mode == "single-k" else []
    out = tmp_path / "out.txt"
    got = _stages(["dist", str(db / "db"), *k, "--knn", "5", "-o", str(out),
                   "--quiet"])
    assert got[()][0].name == "cli.dist"
    stages = {p[0] for p in got if len(p) == 1}
    assert stages == {"load", "engine", "scan", "values", "write"}
    assert {p for p in got if len(p) == 2} == {
        ("load", "load.skm"), ("load", "load.skd"), ("engine", "upload")}
    skd_bytes = (db / "db.skd").stat().st_size
    assert got[("load", "load.skd")][0].counts == {"bytes": skd_bytes}
    assert got[("load", "load.skm")][0].counts == {
        "bytes": (db / "db.skm").stat().st_size}
    assert {p for p in got if len(p) == 3} == {
        ("load", "load.skm", "snappy"), ("load", "load.skm", "decode")}
    assert got[("load", "load.skm", "decode")][0].counts == {"native": 60}
    assert got[("engine", "upload")][0].counts == {"bytes": skd_bytes}
    assert got[("values",)][0].counts == {"pairs": 60 * 5}
    assert got[("write",)][0].counts == {"bytes": out.stat().st_size}
    assert got[("scan",)][0].counts == {"launches": 0}  # the CPU twins
    # one engine span for the samebits engine, one for the kNN engine
    assert len(got[("engine",)]) == 2


@pytest.mark.parametrize("native", [True, False])
def test_load_skm_records_snappy_and_decode(db, tmp_path, native):
    """load.skm holds snappy (bytes: the payload; native: the frame's
    data chunks the host helper decoded) and decode (native: the records
    the native decoder produced, 0 for a payload it declines: here the
    same map as one of indefinite length, which cbor.loads takes)."""
    prefix = db / "db"
    payload = snappy.frame_decompress((db / "db.skm").read_bytes())
    if not native:
        assert payload[0] >> 5 == 5 and payload[0] & 31 < 24  # a map head
        payload = b"\xbf" + payload[1:] + b"\xff"
        prefix = tmp_path / "declined"
        (tmp_path / "declined.skm").write_bytes(snappy.frame_compress(payload))
    before = len(spans.recorded())
    with _cpu_profile():
        ms = MultiSketch.load_metadata(str(prefix))
    got = _new(before)
    (load,) = [s for s in got if s.name == "load.skm"]
    assert ms.number_samples_loaded() == 60
    assert ms.kmer_lengths == list(KMERS)
    assert load.counts == {"bytes": prefix.with_suffix(".skm").stat().st_size}
    assert sorted((s.name, s.counts) for s in got if s.parent == load.id) == [
        ("decode", {"native": 60 if native else 0}),
        ("snappy", {"bytes": len(payload),
                    "native": -(-len(payload) // 65536)})]


SELF, CROSS = 60 * 59 // 2, 60 * 60


@pytest.mark.parametrize("backend,argv,lines", [
    ("cpu", ["-k", "17"], SELF),
    ("cpu", [], SELF),
    ("cpu", ["--exact"], SELF),
    ("cpu", ["{db}", "-k", "21"], CROSS),
    ("cpu", ["{db}"], CROSS),
    ("host", ["-k", "17"], SELF),
    ("host", [], SELF),
    ("host", ["{db}", "-k", "25"], CROSS),
], ids=["stream_k17", "stream_coreacc", "stream_exact", "stream_cross_k21",
        "stream_cross_coreacc", "host_k17", "host_coreacc", "host_cross_k25"])
def test_dense_dist_write_counts_its_bytes(db, tmp_path, monkeypatch, backend,
                                           argv, lines):
    """A dense dist records one write span whose bytes are the output
    file's size: the stream engines' strips and blocks (cpu) and the host
    writers (host) all go through an OutputPipeline, which counts them."""
    monkeypatch.setenv("SKETCHTPU_TORCH_BACKEND", backend)
    out = tmp_path / "out.txt"
    argv = [a.format(db=db / "db") for a in argv]
    got = _stages(["dist", str(db / "db"), *argv, "-o", str(out), "--quiet"])
    (write,) = got[("write",)]
    assert len(out.read_text().splitlines()) == lines
    assert write.counts == {"bytes": out.stat().st_size}


def test_precluster_count_records_its_stages(db, monkeypatch, capsys):
    monkeypatch.setenv("SKETCHTPU_TORCH_BACKEND", "cpu")
    got = _stages(["inverted", "precluster", str(db / "inv.ski"), "--count",
                   "--quiet"])
    line = capsys.readouterr().out
    assert got[()][0].name == "cli.inverted"
    assert {p for p in got if p} == {
        ("load",), ("load", "load.ski"), ("load", "load.ski", "read"),
        ("load", "load.ski", "snappy"), ("load", "load.ski", "parse"),
        ("load", "load.ski", "parse", "bins"),
        ("load", "load.ski", "parse", "tail"),
        ("engine",), ("engine", "upload"), ("scan",), ("write",)}
    read = got[("load", "load.ski", "read")][0].counts["bytes"]
    assert read == (db / "inv.ski").stat().st_size
    assert got[("load", "load.ski", "snappy")][0].counts["bytes"] > read
    assert got[("load", "load.ski", "snappy")][0].counts["native"] >= 1
    assert got[("load", "load.ski")][0].counts == {"native": 30}
    assert got[("engine", "upload")][0].counts == {"bytes": 60 * 15 * 4}
    assert got[("write",)][0].counts == {"bytes": len(line)}


def test_timeline_off_the_card_records_nothing():
    """mesh.timeline() records device spans of CUDA devices only: CPU
    slots leave it empty."""
    from sketchtpu_torch.shard import mesh

    dev = torch.device("cpu")
    with mesh.timeline() as tl:
        with mesh._span("partial", dev):
            time.sleep(0.001)
    assert tl.read() == []


@pytest.mark.gpu
def test_pair_count_launches_fall_inside_the_scan_span(db, monkeypatch):
    """On the card, in a traced count job: the host-side launch of every
    pair_count_kernel falls inside the job's scan span, and the kernel
    itself runs after its launch and ends before the scan does (the scan
    waits for the count), so the spans and the device trace share one
    clock."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setenv("SKETCHTPU_TORCH_BACKEND", "cuda")
    argv = ["inverted", "precluster", str(db / "inv.ski"), "--count",
            "--quiet"]
    assert port_cli.main(argv) == 0  # builds and warms
    before = len(spans.recorded())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        assert port_cli.main(argv) == 0
    (scan,) = [s for s in _new(before) if s.name == "scan"]
    assert scan.counts == {"launches": 1}
    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.profiler.kineto_results.events())
    kernels = [e for e in events if e.device_type() == cuda
               and "pair_count_kernel" in e.name()]
    launches = {e.correlation_id(): e for e in events
                if e.device_type() != cuda and "aunch" in e.name()}
    assert len(kernels) == 1
    for k in kernels:
        launch = launches.get(k.correlation_id())
        assert launch is not None, sorted({e.name() for e in events})
        gaps = (launch.start_ns() - scan.start_ns,
                k.start_ns() - launch.start_ns(), scan.end_ns - k.end_ns())
        print("pair_count: launch %d ns after the scan span opens; kernel "
              "%d ns after its launch; the span closes %d ns after the "
              "kernel ends" % gaps)
        assert scan.start_ns <= launch.start_ns() <= scan.end_ns
        assert launch.start_ns() <= k.start_ns() <= k.end_ns() <= scan.end_ns
