"""The port's library surface (`import sketchtpu_torch as st`) against the
JAX package's (`import sketchtpu`), on synthetic related assemblies made
from a seed: sketch_database and load_database give the same files and
bins; set_k and the distance functions give the same values, in the
port's cpu mode (samebits on the kernels' twins, the engine the package
root picks by default) and host mode (its NumPy oracle); and the root's
distance functions pick the card's engine unless the caller passes one."""

import numpy as np
import pytest

import sketchtpu as jst
import sketchtpu_torch as st
from sketchtpu_torch import runtime
from sketchtpu_torch.formats import skd
from sketchtpu_torch.synth import related_assemblies

MODES = ["cpu", "host"]
KMERS = [21, 17, 25]  # sketch_database sorts them


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """{who: (prefix, MultiSketch returned by sketch_database)} for the JAX
    package (host) and the port in each mode, of the same 7 assemblies; an
    inverted index with its .skq; the input list."""
    d = tmp_path_factory.mktemp("library")
    rfile = related_assemblies(d / "fa", 7, 20000, 41, max_contigs=3)
    inputs = st.get_input_list(str(rfile), None)
    assert inputs == jst.get_input_list(str(rfile), None)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SKETCHTPU_BACKEND", "host")
        out["jax"] = (str(d / "jax"), jst.sketch_database(
            str(d / "jax"), inputs, kmers=KMERS, sketch_size=200,
            min_count=0))
        inv = jst.Inverted.build(inputs, list(range(len(inputs))), 17, 12,
                                 True, 0, 20, write_skq=str(d / "inv.skq"))
        inv.save(str(d / "inv"))
        for mode in MODES:
            mp.setenv("SKETCHTPU_TORCH_BACKEND", mode)
            out[mode] = (str(d / mode), st.sketch_database(
                str(d / mode), inputs, kmers=KMERS, sketch_size=200,
                min_count=0))
    return out, str(d / "inv"), inputs


@pytest.mark.parametrize("mode", MODES)
def test_sketch_database_identical(dbs, mode):
    out, _, inputs = dbs
    prefix, ms = out[mode]
    jprefix, jms = out["jax"]
    assert ms.kmer_lengths == jms.kmer_lengths == sorted(KMERS)
    assert ms.sketch_size == jms.sketch_size == 256
    assert [s.name for s in ms.sketch_metadata] == [n for n, _ in inputs]
    for ext in (".skd", ".skm"):
        want = open(jprefix + ext, "rb").read()
        assert want and open(prefix + ext, "rb").read() == want


@pytest.mark.parametrize("subset", [None, ["sample_05", "sample_01"]])
def test_load_database(dbs, subset):
    out, _, _ = dbs
    ms = st.load_database(out["cpu"][0], subset)
    jms = jst.load_database(out["jax"][0], subset)
    assert ms.number_samples_loaded() == jms.number_samples_loaded() == (
        7 if subset is None else 2)
    np.testing.assert_array_equal(ms.sketch_bins, jms.sketch_bins)
    assert ms.block_reindex == jms.block_reindex


def _same(got, want):
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:  # kNN rows: per row a list of (column, value...) tuples
        assert [list(r) for r in got] == [list(r) for r in want]
        assert sum(len(r) for r in want) > 0


CALLS = {
    "self_all_k17": lambda m, q, k: m.self_dists_all(q[0], k(q[0], 17)),
    "self_all_ani": lambda m, q, k: m.self_dists_all(
        q[0], k(q[0], 21, True)),
    "self_all_coreacc": lambda m, q, k: m.self_dists_all(q[0], k(q[0], None)),
    "self_knn_k17": lambda m, q, k: m.self_dists_knn(q[0], 3, k(q[0], 17)),
    "self_knn_coreacc": lambda m, q, k: m.self_dists_knn(
        q[0], 3, k(q[0], None)),
    "cross_all_k25": lambda m, q, k: m.cross_dists_all(
        q[0], q[1], k(q[0], 25)),
    "cross_all_coreacc": lambda m, q, k: m.cross_dists_all(
        q[0], q[1], k(q[0], None)),
    "cross_knn_k17": lambda m, q, k: m.cross_dists_knn(
        q[0], q[1], 2, k(q[0], 17)),
    "cross_knn_coreacc": lambda m, q, k: m.cross_dists_knn(
        q[0], q[1], 2, k(q[0], None)),
    "precluster_k17": lambda m, q, k: m.self_dists_knn_precluster(
        q[0], q[2], q[3], 12, 2, k(q[0], 17)),
    "precluster_bruteforce": lambda m, q, k: m.self_dists_knn_precluster(
        q[0], q[2], q[3], 12, 2, k(q[0], 17), retain_unmatched="bruteforce"),
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("call", list(CALLS))
def test_distances_identical(dbs, monkeypatch, mode, call):
    """Each distance function at the package root gives the JAX package's
    values on the same database: byte-identical single-k, and the f64
    chain's core/accessory (the samebits are exact integers either way)."""
    out, inv_prefix, _ = dbs
    monkeypatch.setenv("SKETCHTPU_TORCH_BACKEND", mode)
    queries = ["sample_02", "sample_06", "sample_03"]

    def args(pkg, prefix, inverted, read_skq):
        return (pkg.load_database(prefix), pkg.load_database(prefix, queries),
                inverted.load(inv_prefix), read_skq(f"{inv_prefix}.skq"))

    from sketchtpu.formats import skd as jax_skd

    got = CALLS[call](st, args(st, out["cpu"][0], st.Inverted,
                               skd.read_all_skq),
                      lambda ms, k, ani=False: st.set_k(ms, k, ani))
    want = CALLS[call](jst, args(jst, out["jax"][0], jst.Inverted,
                                 jax_skd.read_all_skq),
                       lambda ms, k, ani=False: jst.set_k(ms, k, ani))
    _same(got, want)


def test_root_distances_pick_the_cards_engine(dbs, monkeypatch):
    """Without `engine`, a root distance function passes
    runtime.select_engine(reference database), None in host mode; an
    engine the caller gives, None included, is used as given."""
    out, _, _ = dbs
    ms = st.load_database(out["cpu"][0])
    seen = []
    monkeypatch.setattr(runtime, "select_engine",
                        lambda m: seen.append(m) or None)
    dt = st.set_k(ms, 17, False)
    want = st.self_dists_all(ms, dt)
    assert seen == [ms]
    assert np.array_equal(st.self_dists_all(ms, dt, engine=None), want)
    assert np.array_equal(st.self_dists_all(ms, dt, None, 0.64, None), want)
    assert seen == [ms]
    monkeypatch.undo()
    monkeypatch.setenv("SKETCHTPU_TORCH_BACKEND", "host")
    assert runtime.select_engine(ms) is None
    with pytest.raises(ValueError, match="K-mer size 19 not found"):
        st.set_k(ms, 19, False)


def _both_multisketches(prefix: str, names=None):
    """The JAX package's and the port's MultiSketch of one .skm/.skd, with
    their bins (of the samples `names` only, when given)."""
    out = []
    for pkg in (jst, st):
        ms = pkg.MultiSketch.load_metadata(prefix)
        if names is None:
            ms.read_sketch_data(prefix)
        else:
            ms.read_sketch_data_block(prefix, names)
        out.append(ms)
    return out


@pytest.mark.parametrize("block", [False, True])
def test_multisketch_get_sketch_slice(dbs, block):
    """get_sketch_slice(sample, k index) on the same .skm/.skd: the JAX
    package's words for every sample and k, of the whole database or of a
    block read out of order."""
    out, _, inputs = dbs
    names = [inputs[i][0] for i in (4, 0, 2)] if block else None
    jms, pms = _both_multisketches(out["jax"][0], names)
    n = pms.number_samples_loaded()
    assert n == jms.number_samples_loaded() == (3 if block else len(inputs))
    for i in range(n):
        for k_idx in range(len(KMERS)):
            got = pms.get_sketch_slice(i, k_idx)
            want = jms.get_sketch_slice(i, k_idx)
            assert got.dtype == want.dtype and got.shape == (pms.kmer_stride,)
            assert np.array_equal(got, want)
    assert not np.array_equal(pms.get_sketch_slice(0, 0),
                              pms.get_sketch_slice(1, 0))


def test_multisketch_is_compatible_with(dbs):
    """is_compatible_with against the JAX package's on the same databases,
    and on copies that differ in k, sketch size or hash type."""
    import copy

    out, _, _ = dbs
    jms, pms = _both_multisketches(out["jax"][0])
    jother, pother = _both_multisketches(out["cpu"][0])
    changes = [{}, {"kmer_lengths": [17, 21]}, {"sketch_size": 512},
               {"hash_type": None}]
    seen = []
    for change in changes:
        pair = []
        for base, other in ((jms, jother), (pms, pother)):
            other = copy.copy(other)
            for attr, value in change.items():
                setattr(other, attr, value)
            pair.append((base.is_compatible_with(other),
                         other.is_compatible_with(base)))
        assert pair[1] == pair[0], change
        seen.append(pair[1])
    assert seen[0] == (True, True)
    assert all(s == (False, False) for s in seen[1:])


def test_multisketch_has_every_public_member_of_the_jax_class(dbs):
    """Every public method and attribute of the JAX package's MultiSketch,
    on the class and on a loaded instance, exists on the port's."""
    out, _, _ = dbs
    jms, pms = _both_multisketches(out["jax"][0])
    public = {n for n in dir(jst.MultiSketch) if not n.startswith("_")}
    assert public and public <= set(dir(st.MultiSketch)), \
        sorted(public - set(dir(st.MultiSketch)))
    for name in public:
        assert callable(getattr(st.MultiSketch, name)) == callable(
            getattr(jst.MultiSketch, name)), name
    attrs = {n for n in vars(jms) if not n.startswith("_")}
    # the port's data attributes: the instance's own, and the class's
    # properties (sketch_metadata and name_map, built on first access from
    # the columns load_metadata decoded)
    data = set(vars(pms)) | {n for n, v in vars(st.MultiSketch).items()
                             if isinstance(v, property)}
    assert attrs and attrs <= data, sorted(attrs - data)
