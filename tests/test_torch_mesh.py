"""The port's in-process multi-device engines (sketchtpu_torch/shard/mesh.py)
on CPU slots, against the JAX package's engines of the same name on its
virtual 8-device CPU mesh (make_mesh(n_rows=r), tests/conftest.py), and
against the port's one-device engines, at 1, 2, 3 and 8 slots: uneven
splits, fewer rows than slots, row ranges, completeness and both
--retain-unmatched modes. Samebits, single-k kNN, precluster, counts and
queries are exact; f32 core/accessory is held to the single-device parity
tests' 1e-5 against the JAX package's XLA tile and must be bit-identical
to the port's one-device engine. Then the CLI with runtime.devices giving
3 CPU slots writes the bytes of one slot."""

import contextlib
import io
from pathlib import Path

import numpy as np
import pytest
import torch

from sketchtpu.dist import api as jax_api
from sketchtpu.formats.skm import MultiSketch as JaxMultiSketch
from sketchtpu.inverted.index import Inverted as JaxInverted
from sketchtpu.shard import mesh as jax_mesh
from sketchtpu_torch import cli as port_cli
from sketchtpu_torch import runtime
from sketchtpu_torch.dist import api
from sketchtpu_torch.dist.coreacc_torch import DeviceCoreAccEngine
from sketchtpu_torch.dist.jaccard_torch import DeviceSamebitsEngine
from sketchtpu_torch.dist.knn_torch import DeviceKnnEngine
from sketchtpu_torch.formats import skd
from sketchtpu_torch.formats.skm import MultiSketch
from sketchtpu_torch.inverted.device import DeviceInvertedEngine
from sketchtpu_torch.inverted.index import Inverted
from sketchtpu_torch.shard import mesh
from sketchtpu_torch.sketchcore.sketch import HashType, Sketch
from sketchtpu_torch.synth import (
    derive_signs,
    derive_words,
    read_samples,
    related_assemblies,
    related_proteomes,
    write_derived_inverted,
)

CPU = torch.device("cpu")
SLOTS = [1, 2, 3, 8]
KMERS = (17, 21, 25)
N, NQ, S = 45, 7, 37  # samples, queries, index signs: uneven over 2, 3, 8
ATOL = 1e-5  # f32 core/accessory against the JAX package's XLA tile


def _write_db(d: Path, name: str, words: np.ndarray, prefix: str) -> list:
    names = [f"{prefix}{i:03d}" for i in range(words.shape[0])]
    with skd.SketchDataWriter(str(d / f"{name}.skd")) as wr:
        sketches = [Sketch(name=nm, index=wr.write_sketch(words[i].reshape(-1)))
                    for i, nm in enumerate(names)]
    MultiSketch(sketches, 256, list(KMERS), HashType("dna")).save_metadata(
        str(d / name))
    return names


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A 45-sample database of related families at three k, 7 queries of
    the same families, its .ski/.skq (clusters, and three samples that
    share no sign), and completeness values."""
    d = tmp_path_factory.mktemp("torch_mesh")
    rng = np.random.default_rng(31)
    parents = rng.integers(0, 2**64, (3, len(KMERS), 4, 14), dtype=np.uint64)
    words = derive_words(parents, N + NQ, KMERS, 32)
    names = _write_db(d, "db", words[:N], "s")
    _write_db(d, "q", words[N:], "q")
    sig = derive_signs(N, S, 5, 33, redraw=0.7)
    for r in (2, 30, 44):
        sig[r] = rng.integers(0, 1 << 16, S)
    write_derived_inverted(str(d / "inv"), names, sig, 17)
    return {"d": d, "sig": sig, "comp": rng.uniform(0.6, 1.0, N),
            "qcomp": rng.uniform(0.6, 1.0, NQ)}


def _load(d: Path, name: str):
    port = MultiSketch.load_metadata(str(d / name))
    port.read_sketch_data(str(d / name))
    jax_ms = JaxMultiSketch.load_metadata(str(d / name))
    jax_ms.read_sketch_data(str(d / name))
    return port, jax_ms


def _items(rows):
    return [[(int(j), *map(np.float32, v)) for j, *v in r] for r in rows]


def _close(got, want):
    """Same neighbours in the same order, f32 values within ATOL."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [x[0] for x in g] == [x[0] for x in w]
        np.testing.assert_allclose([x[1:] for x in g], [x[1:] for x in w],
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("r", SLOTS)
def test_split_rows_and_pairs_cover_the_range(r):
    for lo, hi in ((0, 45), (3, 4), (10, 10), (7, 50)):
        for blocks in (mesh.split_rows(lo, hi, r),
                       mesh.split_pairs(lo, hi, 50, r)):
            assert len(blocks) == r
            assert blocks[0].start == lo and blocks[-1].stop == max(lo, hi)
            assert all(a.stop == b.start for a, b in zip(blocks, blocks[1:]))
    sizes = [b.stop - b.start for b in mesh.split_rows(0, 45, r)]
    assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("r", SLOTS)
def test_samebits_engine(data, r):
    ms, jax_ms = _load(data["d"], "db")
    a, b = ms.bins_matrix(1), ms.bins_matrix(1)
    want = jax_mesh.ShardedSamebitsEngine(
        ms.sketchsize64, jax_mesh.make_mesh(n_rows=r)).matrix(a, b)
    got = mesh.ShardedSamebitsEngine(ms.sketchsize64, [CPU] * r).matrix(a, b)
    assert got.dtype == np.int32 and np.array_equal(got, want)
    one = DeviceSamebitsEngine(ms.sketchsize64, CPU).matrix(a[:3], b)
    assert np.array_equal(
        mesh.ShardedSamebitsEngine(ms.sketchsize64, [CPU] * r).matrix(
            a[:3], b), one)  # fewer rows than slots


@pytest.mark.parametrize("comp", [False, True])
@pytest.mark.parametrize("r", SLOTS)
def test_coreacc_engine(data, r, comp):
    d = data["d"]
    ms, jax_ms = _load(d, "db")
    qms, jax_qms = _load(d, "q")
    cv = data["comp"] if comp else None
    names = [ms.sketch_name(i) for i in range(N)]
    qnames = [qms.sketch_name(i) for i in range(NQ)]
    port = mesh.ShardedCoreAccEngine(ms, [CPU] * r, tile=16,
                                     completeness_vec=cv)
    one = DeviceCoreAccEngine(ms, CPU, tile=16, completeness_vec=cv)
    jax_eng = jax_mesh.ShardedCoreAccEngine(
        jax_ms, jax_mesh.make_mesh(n_rows=r), tile=16, completeness_vec=cv)
    rows, cols = slice(5, 40), slice(0, N)
    got = port.tile_dists(rows, cols)
    assert np.array_equal(got, one.tile_dists(rows, cols))
    seen = [_close_ca(got.reshape(-1, 2),
                      jax_eng.tile_dists(rows, cols).reshape(-1, 2))]
    for row_range in (None, slice(3, 29), slice(44, 45)):
        texts = []
        for eng in (port, one, jax_eng):
            out = io.StringIO()
            eng.stream_self_dense(out, names, row_range=row_range)
            texts.append(out.getvalue())
        # the last row has no pair past it
        assert texts[0] == texts[1] and (texts[0] or row_range.start == N - 1)
        seen.append(_close_text(texts[0], texts[2]))
        texts = []
        qc = data["qcomp"] if comp else None
        for eng, q in ((port, qms), (one, qms), (jax_eng, jax_qms)):
            out = io.StringIO()
            eng.stream_cross_dense(out, names, qnames, q, rcomp=cv,
                                   qcomp=qc, row_range=row_range)
            texts.append(out.getvalue())
        assert texts[0] and texts[0] == texts[1]
        seen.append(_close_text(texts[0], texts[2]))
    jumps, pairs = np.sum(seen, axis=0)
    assert jumps <= 0.02 * pairs


def _close_ca(got: np.ndarray, want: np.ndarray) -> tuple[int, int]:
    """(pairs, 2) core/accessory within ATOL, but for the beta == 0
    discontinuity of the regression, where core may jump between ~0 and 1
    in either f32 chain (tests/test_torch_coreacc.py's rule). Returns
    (jumps, pairs): the caller holds the jumps rare."""
    core, core_w = got[:, 0], want[:, 0]
    jump = (np.abs(core - core_w) > ATOL) \
        & (np.minimum(core, core_w) < 1e-3) & (np.maximum(core, core_w) == 1.0)
    np.testing.assert_allclose(core[~jump], core_w[~jump], atol=ATOL, rtol=0)
    np.testing.assert_allclose(got[:, 1], want[:, 1], atol=ATOL, rtol=0)
    return int(jump.sum()), core.size


def _close_text(got: str, want: str) -> tuple[int, int]:
    g = [ln.split("\t") for ln in got.splitlines()]
    w = [ln.split("\t") for ln in want.splitlines()]
    assert [x[:2] for x in g] == [x[:2] for x in w]
    return _close_ca(np.array([x[2:] for x in g], float).reshape(-1, 2),
                     np.array([x[2:] for x in w], float).reshape(-1, 2))


KNN_CASES = {
    "k17": dict(k=17, knn=5), "k21_ani": dict(k=21, ani=True, knn=4),
    "comp": dict(k=17, knn=5, comp=True),
    "range": dict(k=17, knn=3, row_range=slice(4, 31)),
    "one_row": dict(k=25, knn=6, row_range=slice(44, 45)),
    "past_n": dict(k=17, knn=60),
}


@pytest.mark.parametrize("case", list(KNN_CASES))
@pytest.mark.parametrize("r", SLOTS)
def test_knn_engine_single_k(data, r, case):
    """self and cross kNN: exact against the JAX engine (Jaccard; the JAX
    engine prints ANI in another rounding, so ANI is held against the
    port's one-device engine and the host oracle)."""
    cfg = KNN_CASES[case]
    ms, jax_ms = _load(data["d"], "db")
    qms, jax_qms = _load(data["d"], "q")
    dt = api.set_k(ms, cfg["k"], cfg.get("ani", False))
    jax_api.set_k(jax_ms, cfg["k"], cfg.get("ani", False))
    cv = data["comp"] if cfg.get("comp") else None
    qc = data["qcomp"] if cfg.get("comp") else None
    rr, knn = cfg.get("row_range"), cfg["knn"]
    port = mesh.ShardedKnnEngine(ms, [CPU] * r, row_tile=8, col_tile=16)
    one = DeviceKnnEngine(ms, CPU, row_tile=8, col_tile=16)
    jax_eng = jax_mesh.ShardedKnnEngine(jax_ms, jax_mesh.make_mesh(n_rows=r),
                                        col_tile=16)
    got = _items(port.self_knn(knn, dt, row_range=rr, completeness_vec=cv))
    assert got and got == _items(one.self_knn(knn, dt, row_range=rr,
                                              completeness_vec=cv))
    got_x = _items(port.cross_knn(qms, knn, dt, ref_completeness_vec=cv,
                                  query_completeness_vec=qc))
    assert got_x == _items(one.cross_knn(qms, knn, dt,
                                         ref_completeness_vec=cv,
                                         query_completeness_vec=qc))
    if dt.ani:
        assert got == _items(api.self_dists_knn(ms, knn, dt, cv,
                                                row_range=rr))
        return
    assert got == _items(jax_eng.self_knn(knn, dt, row_range=rr,
                                          completeness_vec=cv))
    assert got_x == _items(jax_eng.cross_knn(jax_qms, knn, dt,
                                             ref_completeness_vec=cv,
                                             query_completeness_vec=qc))


def _explained_by_the_discontinuity(got, want, host_more) -> int:
    """Core/accessory kNN rows against the JAX engine's (f32 selection in
    the XLA chain's rounding): a row may differ only where the port (with
    the host oracle) selects pairs whose f64 core is ~0, which the JAX
    chain put on the other side of the beta == 0 discontinuity (core 1);
    the JAX row is then the host's next neighbours without them. Returns
    the rows that differ."""
    differ = 0
    for g, w, h in zip(got, want, host_more):
        if [x[0] for x in g] != [x[0] for x in w]:
            dropped = [x for x in g if x[0] not in {y[0] for y in w}]
            assert dropped and all(x[1] < 1e-3 for x in dropped), (g, w)
            h = [x for x in h if x not in dropped][: len(w)]
            _close([h], [w])
            differ += 1
        else:
            _close([g], [w])
    return differ


@pytest.mark.parametrize("comp", [False, True])
@pytest.mark.parametrize("r", SLOTS)
def test_knn_engine_coreacc(data, r, comp):
    """Core/accessory kNN: bit-identical to the port's one-device engine
    and to the host oracle's f64 chain; against the JAX engine the same
    neighbours but for pairs on the regression's discontinuity, values
    within 1e-5 (it rounds completeness to f32)."""
    ms, jax_ms = _load(data["d"], "db")
    qms, jax_qms = _load(data["d"], "q")
    cv = data["comp"] if comp else None
    qc = data["qcomp"] if comp else None
    port = mesh.ShardedKnnEngine(ms, [CPU] * r, row_tile=8, col_tile=16)
    one = DeviceKnnEngine(ms, CPU, row_tile=8, col_tile=16)
    jax_eng = jax_mesh.ShardedKnnEngine(jax_ms, jax_mesh.make_mesh(n_rows=r),
                                        col_tile=16)
    differ = rows = 0
    for rr in (None, slice(6, 13)):
        got = _items(port.self_knn_coreacc(4, row_range=rr,
                                           completeness_vec=cv))
        assert got and got == _items(one.self_knn_coreacc(
            4, row_range=rr, completeness_vec=cv))
        assert got == _items(jax_api.self_dists_knn(
            jax_ms, 4, jax_api.DistType(), cv, row_range=rr))
        differ += _explained_by_the_discontinuity(
            got, _items(jax_eng.self_knn_coreacc(4, row_range=rr,
                                                 completeness_vec=cv)),
            _items(api.self_dists_knn(ms, 8, api.DistType(), cv,
                                      row_range=rr)))
        rows += len(got)
    got = _items(port.cross_knn_coreacc(qms, 5, ref_completeness_vec=cv,
                                        query_completeness_vec=qc))
    assert got == _items(one.cross_knn_coreacc(qms, 5,
                                               ref_completeness_vec=cv,
                                               query_completeness_vec=qc))
    assert got == _items(jax_api.cross_dists_knn(jax_ms, jax_qms, 5,
                                                 jax_api.DistType(), cv, qc))
    differ += _explained_by_the_discontinuity(
        got, _items(jax_eng.cross_knn_coreacc(
            jax_qms, 5, ref_completeness_vec=cv, query_completeness_vec=qc)),
        _items(api.cross_dists_knn(ms, qms, 9, api.DistType(), cv, qc)))
    assert differ <= (rows + NQ) // 10


PC_CASES = {
    "k17": dict(k=17), "singleton": dict(k=17, retain="singleton"),
    "bruteforce": dict(k=17, retain="bruteforce"),
    "comp": dict(k=17, comp=True),
    "range": dict(k=17, retain="bruteforce", row_range=slice(1, 31)),
    "coreacc": dict(k=None), "coreacc_bruteforce": dict(k=None,
                                                        retain="bruteforce"),
    "coreacc_singleton": dict(k=None, retain="singleton"),
    "few_rows": dict(k=17, retain="bruteforce", row_range=slice(40, 43)),
    "coreacc_few_rows": dict(k=None, retain="bruteforce",
                             row_range=slice(1, 4)),
}


@pytest.mark.parametrize("case", list(PC_CASES))
@pytest.mark.parametrize("r", SLOTS)
def test_knn_engine_precluster(data, r, case):
    cfg = PC_CASES[case]
    d = data["d"]
    ms, jax_ms = _load(d, "db")
    inv = Inverted.load(str(d / "inv"))
    jinv = JaxInverted.load(str(d / "inv"))
    skq = skd.read_all_skq(str(d / "inv.skq"))
    if cfg["k"] is None:
        api.set_k(ms, 17, False)
        jax_api.set_k(jax_ms, 17, False)
        dt = api.DistType()
    else:
        dt = api.set_k(ms, cfg["k"], False)
        jax_api.set_k(jax_ms, cfg["k"], False)
    cv = data["comp"] if cfg.get("comp") else None
    retain, rr = cfg.get("retain"), cfg.get("row_range")
    args = (skq, 5, dt, retain)
    kw = dict(row_range=rr, completeness_vec=cv)
    got = _items(mesh.ShardedKnnEngine(ms, [CPU] * r, row_tile=8,
                                       col_tile=16).precluster_knn(
        inv, *args, **kw))
    assert got and got == _items(DeviceKnnEngine(ms, CPU).precluster_knn(
        inv, *args, **kw))
    want = _items(jax_mesh.ShardedKnnEngine(
        jax_ms, jax_mesh.make_mesh(n_rows=r), col_tile=16).precluster_knn(
        jinv, *args, **kw))
    if dt.coreacc or cv is not None:
        _close(got, want)  # the JAX engine's f32 completeness / XLA tile
    else:
        assert got == want
    host = api.self_dists_knn_precluster(ms, inv, skq, inv.sketch_size, 5,
                                         dt, cv, 0.64, retain, row_range=rr)
    assert got == _items(host)


@pytest.mark.parametrize("r", SLOTS)
def test_inverted_engine(data, r):
    sig = data["sig"]
    rng = np.random.default_rng(34)
    port = mesh.ShardedInvertedEngine(sig, [CPU] * r)
    one = DeviceInvertedEngine(sig, CPU)
    jax_eng = jax_mesh.ShardedInvertedEngine(
        sig, mesh=jax_mesh.make_mesh(n_rows=r), tile=16)
    total = port.any_shared_bin_count()
    assert total > 0
    assert total == one.any_shared_bin_count() == jax_eng.any_shared_bin_count()
    for rr in (slice(0, 17), slice(17, 45), slice(40, 41), slice(9, 9)):
        assert port.any_shared_bin_count(row_range=rr) == \
            jax_eng.any_shared_bin_count(row_range=rr)
    for queries in (rng.integers(0, 1 << 16, (NQ, S), dtype=np.uint16),
                    sig[[3, 7, 30]], sig[:1]):
        queries = queries.copy()
        queries[0, :5] = sig[11, :5]
        for fn in ("match_counts", "any_shared_rows", "all_shared_rows"):
            got = getattr(port, fn)(queries)
            assert got.dtype == getattr(one, fn)(queries).dtype
            assert np.array_equal(got, getattr(one, fn)(queries))
            assert np.array_equal(got, getattr(jax_eng, fn)(queries))


@pytest.mark.parametrize("r", [2, 8])
def test_knn_zero_on_every_slot_count(data, r):
    """knn 0: no neighbour in any mode, and singleton rows of their own
    (the host oracle's rows), from the multi-device engine too."""
    d = data["d"]
    ms, _ = _load(d, "db")
    qms, _ = _load(d, "q")
    inv = Inverted.load(str(d / "inv"))
    skq = skd.read_all_skq(str(d / "inv.skq"))
    eng = mesh.ShardedKnnEngine(ms, [CPU] * r)
    dt = api.set_k(ms, 17, False)
    assert _items(eng.self_knn(0, dt)) == [[]] * N
    assert _items(eng.cross_knn(qms, 0, dt)) == [[]] * NQ
    for retain in (None, "singleton", "bruteforce"):
        for mode in (dt, api.DistType()):
            got = _items(eng.precluster_knn(inv, skq, 0, mode, retain))
            want = _items(api.self_dists_knn_precluster(
                ms, inv, skq, inv.sketch_size, 0, mode, None, 0.64, retain))
            assert got == want


def test_selectors_return_the_sharded_engines(data, monkeypatch):
    """More than one device: every selector but the dense single-k and
    --exact streams (one device, as in the JAX package) returns a
    multi-device engine; one device: the one-device engines."""
    ms, _ = _load(data["d"], "db")
    inv = Inverted.load(str(data["d"] / "inv"))
    monkeypatch.setenv("SKETCHTPU_TORCH_BACKEND", "cpu")
    dt = api.set_k(ms, 17, False)
    for devs, sharded in (([CPU, CPU], True), ([CPU], False)):
        monkeypatch.setattr(runtime, "devices", lambda d=devs: d)
        engines = {
            mesh.ShardedCoreAccEngine: runtime.select_coreacc_engine(ms),
            mesh.ShardedKnnEngine: runtime.select_knn_engine(ms, dt),
            mesh.ShardedInvertedEngine: runtime.select_inverted_engine(inv),
            mesh.ShardedSamebitsEngine:
                runtime.select_engine(ms).__self__,
        }
        for cls, eng in engines.items():
            assert isinstance(eng, cls) == sharded, cls
        assert type(runtime.select_dense_stream_engine(ms, dt)).__name__ == \
            "DeviceDenseStreamEngine"
        assert type(runtime.select_coreacc_engine(ms, exact=True)).__name__ \
            == "DeviceCoreAccExactStreamEngine"
        assert runtime.select_backend(HashType("dna"), 1).devices == devs
        assert runtime.select_backend(HashType("aa"), 1).devices == devs


# --- the CLI on 3 CPU slots against one ---------------------------------------

def _cli(d: Path, p: str) -> list[list[str]]:
    p = str(d / p)
    mixed, aa = str(d / "mixed.txt"), str(d / "faa" / "rfile.txt")
    return [
        ["sketch", "-f", mixed, "-o", f"{p}db", "-k", "17,21,25", "-s", "256",
         "--min-count", "2", "--quiet"],
        ["sketch", "-f", aa, "-o", f"{p}aa", "-k", "6,9", "-s", "256",
         "--seq-type", "aa", "--quiet"],
        ["dist", f"{p}db", "-o", f"{p}dense.txt", "--quiet"],
        ["dist", f"{p}db", f"{p}db", "-o", f"{p}dense_x.txt", "--quiet"],
        ["dist", f"{p}db", "-k", "17", "--knn", "3", "-o", f"{p}knn.txt",
         "--quiet"],
        ["dist", f"{p}db", "--knn", "3", "-o", f"{p}knn_ca.txt", "--quiet"],
        ["dist", f"{p}db", f"{p}db", "-k", "21", "--knn", "2", "-o",
         f"{p}knn_x.txt", "--quiet"],
        ["dist", f"{p}db", "-k", "17", "--knn", "0", "-o", f"{p}knn0.txt",
         "--quiet"],
        ["inverted", "build", "-f", mixed, "-o", f"{p}inv", "-s", "100",
         "-k", "17", "--write-skq", "--quiet"],
        ["inverted", "precluster", f"{p}inv.ski", "--count", ">",
         f"{p}count.txt"],
        ["inverted", "precluster", f"{p}inv.ski", "--skd", f"{p}db", "--knn",
         "3", "--retain-unmatched", "bruteforce", "-o", f"{p}pc.txt",
         "--quiet"],
        ["inverted", "query", f"{p}inv.ski", "-f", mixed, "--query-type",
         "match-count", "-o", f"{p}q_count.txt", "--quiet"],
        ["inverted", "query", f"{p}inv.ski", "-f", mixed, "--query-type",
         "any-bins", "-o", f"{p}q_any.txt", "--quiet"],
    ]


CLI_FILES = ("db.skd", "db.skm", "aa.skd", "aa.skm", "dense.txt",
             "dense_x.txt", "knn.txt", "knn_ca.txt", "knn_x.txt", "knn0.txt",
             "inv.ski", "inv.skq", "count.txt", "pc.txt", "q_count.txt",
             "q_any.txt")


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_mesh_cli")
    rfile = related_assemblies(d / "fa", 5, 20000, seed=41)
    reads = read_samples(d / "fq", 2, 8000, 8, 42)
    (d / "mixed.txt").write_text(rfile.read_text() + "".join(reads))
    related_proteomes(d / "faa", 4, 20, 150, 43)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SKETCHTPU_TORCH_BACKEND", "cpu")
        for prefix, devs in (("one_", [CPU]), ("three_", [CPU] * 3)):
            mp.setattr(runtime, "devices", lambda d=devs: d)
            for argv in _cli(d, prefix):
                out = None
                if ">" in argv:
                    argv, out = argv[: argv.index(">")], argv[-1]
                with contextlib.ExitStack() as stack:
                    if out is not None:
                        stack.enter_context(contextlib.redirect_stdout(
                            stack.enter_context(open(out, "w"))))
                    assert port_cli.main(argv) == 0, argv
    return d


@pytest.mark.parametrize("name", CLI_FILES)
def test_cli_on_three_slots_writes_one_slots_bytes(cli_runs, name):
    one = (cli_runs / f"one_{name}").read_bytes()
    assert (cli_runs / f"three_{name}").read_bytes() == one
    assert one or name == "knn0.txt"
