"""K2 core/accessory: the port's twin (and its wrapper on CPU tensors)
against the Pallas kernel in interpret mode, the XLA tile, and the f64
host chain, on related sketches at several divergences; the kernels' k
table at any number of k; and the port's CLI at 260 k against the JAX
package's."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sketchtpu.dist.coreacc_jax import coreacc_tile
from sketchtpu.dist.coreacc_pallas import chunk_major, coreacc_pallas
from sketchtpu.dist.jaccard_np import (
    core_acc_from_jaccards,
    jaccard_from_samebits,
    samebits_matrix,
)
from sketchtpu import cli as jax_cli
from sketchtpu_torch.cli import main as port_cli
from sketchtpu_torch.dist.coreacc_kernels import (
    KEY_INVALID,
    MAX_NK_BY_VALUE,
    _k_table,
    coreacc,
    coreacc_keys,
    coreacc_ref,
    k_centre,
)
from sketchtpu_torch.synth import derive_words, related_assemblies

KMERS = (17, 19, 21, 23, 25, 27, 29)
ATOL = 1e-5  # f32 chain vs f32 chain, and vs the f64 oracle


def _related(n, s64, seed, n_parents=3):
    """(n, nk, s64*14) u64: families derived from random parents, at
    divergences 0.1-5% (unrelated families exercise the no-fit branch)."""
    rng = np.random.default_rng(seed)
    parents = rng.integers(0, 2**64, (n_parents, len(KMERS), s64, 14),
                           dtype=np.uint64)
    words = derive_words(parents, n, KMERS, seed)
    words[-1] = words[0]  # identical pair: the degenerate branch
    return words.reshape(n, len(KMERS), s64 * 14)


def _t(m):
    return torch.from_numpy(np.ascontiguousarray(m).view(np.int64).copy())


def _stack32(w):
    """(n, nk, W) u64 -> (nk, n, 2W) u32, the JAX tiles' layout."""
    return np.ascontiguousarray(w.transpose(1, 0, 2)).view(np.uint32)


def _comp(n, seed):
    return np.random.default_rng(seed).uniform(0.7, 1.0, n).astype(np.float32)


ALL_K = tuple(range(len(KMERS)))


# the original cases keep their ids; the others add sketch sizes whose
# chunk count the card kernel's 2-chunk stages do not divide, and nk = 2
# (the n < 3 branch everywhere)
@pytest.mark.parametrize("with_comp,s64,kidx", [
    pytest.param(False, 4, ALL_K, id="False"),
    pytest.param(True, 4, ALL_K, id="True"),
    pytest.param(False, 1, ALL_K, id="s64_1"),
    pytest.param(True, 3, ALL_K, id="s64_3-comp"),
    pytest.param(False, 5, ALL_K, id="s64_5"),
    pytest.param(False, 4, (0, 3), id="nk_2"),
    pytest.param(True, 3, (1, 5), id="nk_2-s64_3-comp"),
])
def test_coreacc_matches_pallas_interpret_and_xla(with_comp, s64, kidx):
    n = 24
    kmers = tuple(KMERS[i] for i in kidx)
    w = np.ascontiguousarray(_related(n, s64, 1)[:, list(kidx)])
    sketch_size = s64 * 64
    c = _comp(n, 2) if with_comp else None
    cj = dict(c1=jnp.asarray(c), c2=jnp.asarray(c), cutoff=0.64) if with_comp else {}
    stack = jnp.asarray(_stack32(w))
    xla = np.asarray(coreacc_tile(stack, stack, s64, kmers, sketch_size, **cj))
    cm = chunk_major(stack, s64)
    pallas = np.asarray(coreacc_pallas(
        cm, jnp.transpose(cm), s64, kmers, sketch_size, ti=8, tj=8,
        interpret=True, **cj,
    ))
    ct = dict(c1=torch.from_numpy(c), c2=torch.from_numpy(c), cutoff=0.64) \
        if with_comp else {}
    core, acc = coreacc(_t(w), _t(w), kmers, sketch_size, **ct)
    got = np.stack([core.numpy(), acc.numpy()], axis=-1)
    if len(kmers) < 3:
        assert (got == 1).all()  # fewer than 3 points: no fit
    elif s64 == 4:
        # the branches the fixture must reach: fitted, no-fit, degenerate
        assert ((got[..., 0] > 0) & (got[..., 0] < 1)).sum() > n
        assert (got[..., 0] == 1).any() and (got[..., 0] == 0).any()
    np.testing.assert_allclose(got, xla, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=0)


@pytest.mark.parametrize("with_comp", [False, True])
def test_coreacc_matches_f64_oracle(with_comp):
    s64, na, nb = 16, 20, 28
    w = _related(na + nb, s64, 3)
    a, b = w[:na], w[na:]
    sketch_size = s64 * 64
    c = _comp(na + nb, 4) if with_comp else None
    jaccs = np.empty((na * nb, len(KMERS)))
    c1 = np.repeat(c[:na], nb) if with_comp else None
    c2 = np.tile(c[na:], na) if with_comp else None
    for ki in range(len(KMERS)):
        sb = samebits_matrix(a[:, ki], b[:, ki]).reshape(-1)
        jaccs[:, ki] = jaccard_from_samebits(sb, s64, c1, c2, 0.64)
    core_h, acc_h = core_acc_from_jaccards(jaccs, list(KMERS), sketch_size)
    ct = dict(c1=torch.from_numpy(c[:na].copy()),
              c2=torch.from_numpy(c[na:].copy())) if with_comp else {}
    core, acc = coreacc(_t(a), _t(b), KMERS, sketch_size, **ct)
    core, acc = core.numpy().reshape(-1), acc.numpy().reshape(-1)
    # the beta == 0 discontinuity (core jumps 0 <-> 1) is the one allowed
    # difference; it must stay rare
    jump = (np.abs(core - core_h) > ATOL) & (np.minimum(core, core_h) < 1e-3) \
        & (np.maximum(core, core_h) == 1.0)
    assert jump.sum() <= 0.02 * core.size
    assert ((core_h > 0) & (core_h < 1)).sum() > core.size // 10
    np.testing.assert_allclose(core[~jump], core_h[~jump], atol=ATOL, rtol=0)
    np.testing.assert_allclose(acc, acc_h, atol=ATOL, rtol=0)


@pytest.mark.parametrize("row0", [0, 8, 40])
def test_coreacc_tri_matches_full_above_diagonal(row0):
    s64, n = 4, 48
    w = _t(_related(n, s64, 5))
    a = w[row0 : row0 + 8]
    full = coreacc_ref(a, w, KMERS, s64 * 64)
    tri = coreacc(a, w, KMERS, s64 * 64, tri=True, row0=row0)
    upper = torch.arange(n)[None, :] > row0 + torch.arange(a.shape[0])[:, None]
    for f, t in zip(full, tri):
        assert torch.equal(t[upper], f[upper])


def test_coreacc_rejects_bad_input():
    w = _t(_related(4, 4, 0))
    with pytest.raises(ValueError):
        coreacc(w, w, KMERS[:-1], 256)
    with pytest.raises(ValueError):
        coreacc(w, w, tuple(reversed(KMERS)), 256)
    with pytest.raises(ValueError):
        coreacc(w, w, KMERS, 256, c1=torch.ones(4))
    with pytest.raises(ValueError):
        coreacc(w, w, KMERS, 256, c1=torch.ones(4, dtype=torch.float64),
                c2=torch.ones(4, dtype=torch.float64))


@pytest.mark.parametrize("with_comp", [False, True])
@pytest.mark.parametrize(
    "tr,tc,row0,col0,nb_real",
    [
        (8, 8, 0, 0, 8),  # one tile on the diagonal
        (7, 13, 0, 0, 13),  # ragged, diagonal inside
        (5, 11, 20, 15, 40),  # off the diagonal, overlapping ids
        (6, 12, 10, 4, 13),  # nb_real inside the tile
        (4, 9, 0, 30, 33),  # mostly past nb_real
        (3, 6, 0, 40, 33),  # wholly past nb_real
    ],
)
def test_coreacc_keys_twin_packs_coreacc_ref(with_comp, tr, tc, row0, col0,
                                             nb_real):
    """Key mode on the CPU (its twin): the int64 key of every real pair is
    ordered_bits(-core) << 32 | (2^32 - 1 - column) over coreacc_ref's
    core, with acc beside it; self pairs and columns past nb_real get
    KEY_INVALID (acc 0 past nb_real)."""
    s64 = 4
    w = _t(_related(48, s64, 9))
    a, b = w[row0 : row0 + tr], w[col0 : col0 + tc]
    c1 = c2 = None
    if with_comp:
        c = torch.from_numpy(_comp(48, 10))
        c1, c2 = c[row0 : row0 + tr].contiguous(), c[col0 : col0 + tc].contiguous()
    keys, acc = coreacc_keys(a, b, KMERS, s64 * 64, c1, c2, row0=row0,
                             col0=col0, nb_real=nb_real, exclude_self=True)
    assert keys.dtype == torch.int64 and acc.dtype == torch.float32
    ncols = max(0, min(tc, nb_real - col0))
    core_r, acc_r = coreacc_ref(a, b[:ncols], KMERS, s64 * 64, c1,
                                None if c2 is None else c2[:ncols])
    bits = (-core_r).numpy().view(np.int32)
    ordered = np.where(bits < 0, bits ^ 0x7FFFFFFF, bits).astype(np.int64)
    cols = col0 + np.arange(tc)
    want = np.full((tr, tc), KEY_INVALID, dtype=np.int64)
    want[:, :ncols] = (ordered << 32) | (0xFFFFFFFF - cols[:ncols])
    self_pair = cols[None, :] == row0 + np.arange(tr)[:, None]
    want[self_pair] = KEY_INVALID
    np.testing.assert_array_equal(keys.numpy(), want)
    want_acc = np.zeros((tr, tc), dtype=np.float32)
    want_acc[:, :ncols] = acc_r.numpy()
    np.testing.assert_array_equal(acc.numpy(), want_acc)
    # keys descending is core ascending, then column ascending
    for i in range(tr):
        real = np.nonzero(want[i] != KEY_INVALID)[0]
        got_order = real[np.argsort(-want[i, real], kind="stable")]
        core_i = core_r.numpy()[i]
        want_order = real[np.lexsort((cols[real], core_i[real]))]
        np.testing.assert_array_equal(got_order, want_order)


@pytest.mark.parametrize("nk", [3, 7, MAX_NK_BY_VALUE, MAX_NK_BY_VALUE + 1,
                                300])
def test_k_table_is_the_twins_centred_k_and_prefix_sums(nk):
    """The kernels' k table (by value up to MAX_NK_BY_VALUE k, in device
    memory past it, csrc/coreacc.cu): w = max(nk, MAX_NK_BY_VALUE) centred
    k values, then w + 1 prefix sums of x and of x * x, then kc; each sum
    the f32 value the twin's chain accumulates over the first n k, bit for
    bit, and zeros past the k."""
    kmers = tuple(range(15, 15 + 2 * nk, 2))
    table = _k_table(kmers)
    w = max(nk, MAX_NK_BY_VALUE)
    assert table.dtype == np.float32 and table.shape == (3 * w + 3,)
    kf, xs, xq = table[:w], table[w:2 * w + 1], table[2 * w + 1:3 * w + 2]
    kc = k_centre(kmers)
    assert table[-1] == np.float32(kc) == kmers[nk // 2]
    x = torch.tensor([float(k) - kc for k in kmers], dtype=torch.float32)
    assert np.array_equal(kf[:nk], x.numpy()) and not kf[nk:].any()
    xsum = torch.zeros((), dtype=torch.float32)
    xsq = torch.zeros((), dtype=torch.float32)
    assert xs[0] == 0 and xq[0] == 0
    for q, k in enumerate(kmers):  # coreacc_chain_ref's sums, in its order
        k_fl = float(k) - kc
        xsum = xsum + torch.tensor(k_fl, dtype=torch.float32)
        xsq = xsq + torch.tensor(k_fl * k_fl, dtype=torch.float32)
        assert xs[q + 1].tobytes() == xsum.numpy().tobytes(), q
        assert xq[q + 1].tobytes() == xsq.numpy().tobytes(), q
    assert not xs[nk + 1:].any() and not xq[nk + 1:].any()


def test_cli_at_260_k_matches_the_jax_package(tmp_path, monkeypatch):
    """`sketch --k-seq 15,274,1` (260 k, past K2's by-value k table) of 3
    related genomes, then dense core/accessory `dist` and `dist --knn 2`:
    the port's CLI in cpu mode writes the JAX package's .skd/.skm bytes
    (its host oracle), its f32 core/acc is within ATOL of the f64 chain,
    and its core/acc kNN (f32 selection, f64 values) is byte-identical."""
    rfile = related_assemblies(tmp_path / "fa", 3, 4000, seed=16,
                               n_ancestors=1)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the twins of 260 k, under parallel workers
    try:
        for main, who, env in ((port_cli, "port", "SKETCHTPU_TORCH_BACKEND"),
                               (jax_cli.main, "host", "SKETCHTPU_BACKEND")):
            monkeypatch.setenv(env, "cpu" if who == "port" else "host")
            p = str(tmp_path / who)
            for argv in (["sketch", "-f", str(rfile), "-o", p, "--k-seq",
                          "15,274,1", "-s", "128", "--quiet"],
                         ["dist", p, "-o", f"{p}_ca.txt", "--quiet"],
                         ["dist", p, "--knn", "2", "-o", f"{p}_knn.txt",
                          "--quiet"]):
                assert main(argv) == 0, (who, argv)
    finally:
        torch.set_num_threads(threads)
    for ext in (".skd", ".skm"):
        port = (tmp_path / f"port{ext}").read_bytes()
        assert port and port == (tmp_path / f"host{ext}").read_bytes()
    tables = []
    for who in ("port", "host"):
        rows = [ln.split("\t") for ln in
                (tmp_path / f"{who}_ca.txt").read_text().splitlines()]
        tables.append(np.array([[float(v) for v in r[2:]] for r in rows]))
    assert tables[0].shape == tables[1].shape == (3, 2)
    assert ((tables[1][:, 0] > 0) & (tables[1][:, 0] < 1)).all()  # fitted
    np.testing.assert_allclose(tables[0], tables[1], atol=ATOL, rtol=0)
    knn = (tmp_path / "port_knn.txt").read_bytes()
    assert knn and knn == (tmp_path / "host_knn.txt").read_bytes()
