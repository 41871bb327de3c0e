"""K3 (the kNN scan: tile and selection mode), K4 and the port's kNN engine
on the CPU twins,
against the JAX package: samebits_pallas_chunked / samebits_pallas in
interpret mode, the JAX scans (_knn_scan_block_packed with its Pallas
tile in interpret mode, _knn_scan_block_comp on JAX-CPU) and the host
kNN functions. Data crosses as numpy arrays."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sketchtpu.dist.jaccard_np import samebits_matrix
from sketchtpu.dist.knn_jax import _knn_scan_block_comp, _knn_scan_block_packed
from sketchtpu.dist.pallas_kernels import (
    chunk_group_major,
    samebits_pallas,
    samebits_pallas_chunked,
)
from sketchtpu_torch.constants import BBITS
from sketchtpu_torch.dist import api
from sketchtpu_torch.dist.knn_kernels import (
    Completeness,
    INVALID,
    key_layout,
    knn_keys,
    knn_select,
    knn_select_ref,
    pack_shift,
)
from sketchtpu_torch.dist.knn_torch import DeviceKnnEngine, knn_scan
from sketchtpu_torch.dist.samebits_kernels import samebits_full
from sketchtpu_torch.formats.skm import MultiSketch
from sketchtpu_torch.sketchcore.sketch import HashType, Sketch


def _u32(n, s64, rng):
    return rng.integers(0, 2**32, (n, s64 * BBITS * 2), dtype=np.uint32)


def _t(m32):
    """u32 (n, W2) words (the JAX layout) as the port's int64 (n, W)."""
    return torch.from_numpy(np.ascontiguousarray(m32).view(np.int64).copy())


def _scan_inputs(seed):
    """The JAX scan tests' inputs (tests/test_pallas.py): rows are the
    first columns (self exclusion on the diagonal), duplicate columns
    (ties go to the lowest column)."""
    rng = np.random.default_rng(seed)
    s64, nb, tr = 4, 512, 256
    a = _u32(tr, s64, rng)
    b = _u32(nb, s64, rng)
    b[:tr] = a
    b[300] = b[10]
    b[301] = b[10]
    return s64, a, b


def test_knn_keys_twin_samebits_match_pallas_chunked():
    """K3's twin decodes to the samebits of samebits_pallas_chunked."""
    s64 = 16
    rng = np.random.default_rng(1)
    a, b = _u32(256, s64, rng), _u32(1024, s64, rng)
    want = np.asarray(samebits_pallas_chunked(
        chunk_group_major(jnp.asarray(a), s64),
        jnp.transpose(chunk_group_major(jnp.asarray(b), s64)),
        s64, ti=256, tj=1024, interpret=True,
    ))
    keys = knn_keys(_t(a), _t(b)).numpy()
    dtype, shift, colmask = key_layout(s64, 1024, False)
    assert dtype == torch.int32 and shift == pack_shift(s64) == 20
    np.testing.assert_array_equal(keys >> shift, want)
    np.testing.assert_array_equal(colmask - (keys & colmask),
                                  np.broadcast_to(np.arange(1024), want.shape))


@pytest.mark.parametrize("nb_real", [512, 509])
def test_plain_scan_matches_jax_packed_scan(nb_real):
    s64, a, b = _scan_inputs(4)
    want_v, want_i = _knn_scan_block_packed(
        chunk_group_major(jnp.asarray(a), s64),
        jnp.transpose(chunk_group_major(jnp.asarray(b), s64)),
        np.int32(0), np.int32(nb_real),
        s64=s64, knn=5, tc=256, exclude_self=True, pallas=True,
        ti=256, tj=256, interpret=True,
    )
    sb, idx = knn_scan(_t(a), _t(b[:nb_real]), 5, exclude_self=True)
    np.testing.assert_array_equal(sb, np.asarray(want_v))
    np.testing.assert_array_equal(idx, np.asarray(want_i))


@pytest.mark.parametrize("nb_real", [512, 509])
def test_completeness_scan_matches_jax_comp_scan(nb_real):
    s64, a, b = _scan_inputs(3)
    rng = np.random.default_rng(5)
    c1 = rng.uniform(0.5, 1.0, a.shape[0]).astype(np.float32)
    c2 = rng.uniform(0.5, 1.0, b.shape[0]).astype(np.float32)
    c2[:a.shape[0]] = c1
    sig = np.zeros((a.shape[0], 1), np.int32)
    want_v, want_i = _knn_scan_block_comp(
        jnp.asarray(a), jnp.asarray(b), np.int32(0), np.int32(nb_real),
        sig, np.zeros((b.shape[0], 1), np.int32), jnp.asarray(c1),
        jnp.asarray(c2), s64=s64, knn=5, tc=256, exclude_self=True,
        masked=False, cutoff=0.64,
    )
    sb, idx = knn_scan(_t(a), _t(b[:nb_real]), 5, exclude_self=True,
                       comp_rows=c1, comp_cols=c2[:nb_real], cutoff=0.64)
    np.testing.assert_array_equal(sb, np.asarray(want_v))
    np.testing.assert_array_equal(idx, np.asarray(want_i))


def test_completeness_keys_order_by_corrected_jaccard():
    """Completeness keys: int64, value = the corrected Jaccard's f32 bits,
    column ascending among equal values (clamped at 1.0 here)."""
    s64 = 4
    rng = np.random.default_rng(6)
    a = _u32(3, s64, rng)
    b = np.concatenate([a, a, _u32(5, s64, rng)])
    comp = Completeness(torch.full((3,), 0.9), torch.full((11,), 0.9), 0.64,
                        s64)
    keys = knn_keys(_t(a), _t(b), comp=comp).numpy()
    assert keys.dtype == np.int64
    j = (keys >> 32).astype(np.int32).view(np.float32)
    assert (j[:, :6][np.arange(3), np.arange(3)] == 1.0).all()
    order = np.argsort(-keys, axis=1, kind="stable")
    assert (order[:, :2] == np.stack([np.arange(3), np.arange(3) + 3], 1)).all()


def test_k4_samebits_full_matches_pallas():
    s64 = 16
    rng = np.random.default_rng(0)
    a, b = _u32(256, s64, rng), _u32(512, s64, rng)
    want = np.asarray(samebits_pallas(
        jnp.asarray(a), jnp.asarray(np.ascontiguousarray(b.T)), s64,
        ti=256, tj=512, interpret=True,
    ))
    got = samebits_full(_t(a), _t(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _ms(words: np.ndarray, kmers) -> MultiSketch:
    """A port MultiSketch holding (n, nk, W) u64 words."""
    n = words.shape[0]
    sketches = [Sketch(name=f"g{i}", index=i) for i in range(n)]
    ms = MultiSketch(sketches, (words.shape[2] // BBITS) * 64, list(kmers),
                     HashType("dna"))
    ms.sketch_bins = np.ascontiguousarray(words).reshape(-1)
    return ms


def _related(n, nk, s64, seed, dup=()):
    """Bit flips off one base sketch (more at larger k); rows in `dup`
    (pairs (src, dst)) are exact copies."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 2**63, (nk, s64 * BBITS), dtype=np.uint64)
    words = np.repeat(base[None], n, axis=0)
    for i in range(n):
        for ki in range(nk):
            for _ in range(1 + 3 * ki + int(rng.integers(0, 6))):
                w = rng.integers(0, s64 * BBITS)
                words[i, ki, w] ^= np.uint64(1) << np.uint64(rng.integers(0, 64))
    for src, dst in dup:
        words[dst] = words[src]
    return words


def _lists(rows):
    return [[(j, *map(np.float32, v)) for j, *v in r] for r in rows]


def test_ties_go_to_the_lowest_column():
    """Duplicated samples tie exactly; the lowest columns must win, as the
    host path's stable selection picks them."""
    words = _related(40, 2, 2, 7, dup=[(3, 9), (3, 20), (3, 31), (5, 33)])
    ms = _ms(words, (17, 21))
    dt = api.set_k(ms, 17, False)
    dev = DeviceKnnEngine(ms, torch.device("cpu"), row_tile=16, col_tile=8)
    got = _lists(dev.self_knn(3, dt))
    want = _lists(api.self_dists_knn(ms, 3, dt))
    assert got == want
    assert [j for j, _ in got[3]] == [9, 20, 31]
    assert [j for j, _ in got[31]] == [3, 9, 20]


@pytest.mark.parametrize("knn", [39, 40, 55])
def test_knn_at_or_past_n_truncates_rows(knn):
    """knn >= n: every row keeps its n - 1 candidates (self excluded), in
    the host order; the core/acc rows likewise."""
    words = _related(40, 4, 2, 8)
    ms = _ms(words, (17, 21, 25, 29))
    dt = api.set_k(ms, 21, True)
    dev = DeviceKnnEngine(ms, torch.device("cpu"), row_tile=16, col_tile=16)
    got = _lists(dev.self_knn(knn, dt))
    assert all(len(r) == 39 for r in got)
    assert got == _lists(api.self_dists_knn(ms, knn, dt))
    ca = _lists(dev.self_knn_coreacc(knn))
    host_ca = _lists(api.self_dists_knn(ms, knn, api.DistType()))
    assert [sorted(j for j, *_ in r) for r in ca] == \
        [sorted(j for j, *_ in r) for r in host_ca]


def test_cross_rows_with_fewer_candidates_than_knn():
    refs = _ms(_related(6, 2, 2, 9), (17, 21))
    queries = _ms(_related(4, 2, 2, 10), (17, 21))
    dt = api.set_k(refs, 17, False)
    dev = DeviceKnnEngine(refs, torch.device("cpu"), row_tile=3, col_tile=4)
    got = _lists(dev.cross_knn(queries, 9, dt))
    assert all(len(r) == 6 for r in got)
    assert got == _lists(api.cross_dists_knn(refs, queries, 9, dt))


def test_scan_reaches_int64_keys_past_the_int32_column_field(monkeypatch):
    """Past 2^shift - 1 columns the plain keys widen to int64 and select
    the same pairs."""
    from sketchtpu_torch.dist import knn_kernels

    s64, a, b = _scan_inputs(11)
    want = knn_scan(_t(a), _t(b), 4, exclude_self=True)
    monkeypatch.setattr(knn_kernels, "pack_shift", lambda s64: 8)
    assert knn_kernels.key_layout(s64, 512, False)[0] == torch.int64
    got = knn_scan(_t(a), _t(b), 4, exclude_self=True)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_samebits_of_scan_match_oracle():
    s64, a, b = _scan_inputs(12)
    sb, idx = knn_scan(_t(a), _t(b), 6, exclude_self=False)
    full = samebits_matrix(a.view(np.uint64), b.view(np.uint64))
    np.testing.assert_array_equal(sb, np.take_along_axis(full, idx, 1))


# --- K3 in selection mode: the twin against the JAX scans -------------------

def _decode(keys, s64, nb_real, comp):
    """(value field, column) of selection keys; -1 / -1 where INVALID."""
    _dtype, shift, colmask = key_layout(s64, nb_real, comp)
    k = keys.numpy().astype(np.int64)
    bad = k == INVALID
    return (np.where(bad, -1, k >> shift),
            np.where(bad, -1, colmask - (k & colmask)))


def _jax_packed(a, b, s64, nb_real, knn):
    v, i = _knn_scan_block_packed(
        chunk_group_major(jnp.asarray(a), s64),
        jnp.transpose(chunk_group_major(jnp.asarray(b), s64)),
        np.int32(0), np.int32(nb_real),
        s64=s64, knn=knn, tc=256, exclude_self=True, pallas=True,
        ti=256, tj=256, interpret=True,
    )
    return np.asarray(v), np.asarray(i)


@pytest.mark.parametrize("knn", [3, 50])
@pytest.mark.parametrize("nb_real", [512, 509])
def test_knn_select_twin_matches_jax_packed_scan(nb_real, knn):
    """The selection twin picks the JAX packed scan's columns and samebits,
    whatever its merge tile: exact equality."""
    s64, a, b = _scan_inputs(21)
    want_v, want_i = _jax_packed(a, b, s64, nb_real, knn)
    for col_tile in (64, 200, 8192):
        keys = knn_select_ref(_t(a), _t(b), knn, nb_real=nb_real,
                              exclude_self=True, col_tile=col_tile,
                              row_tile=96)
        assert keys.dtype == torch.int32 and keys.shape == (256, knn)
        assert (keys[:, :-1] > keys[:, 1:]).all()  # descending, unique
        sb, idx = _decode(keys, s64, nb_real, False)
        np.testing.assert_array_equal(sb, want_v)
        np.testing.assert_array_equal(idx, want_i)
    via_wrapper = knn_select(_t(a), _t(b), knn, nb_real=nb_real,
                             exclude_self=True)
    assert torch.equal(via_wrapper, keys)


@pytest.mark.parametrize("knn", [3, 50])
@pytest.mark.parametrize("nb_real", [512, 509])
def test_knn_select_twin_matches_jax_comp_scan(nb_real, knn):
    """Completeness keys: the columns of _knn_scan_block_comp, and their
    exact samebits after knn_scan's gather."""
    s64, a, b = _scan_inputs(22)
    rng = np.random.default_rng(23)
    c1 = rng.uniform(0.5, 1.0, a.shape[0]).astype(np.float32)
    c2 = rng.uniform(0.5, 1.0, b.shape[0]).astype(np.float32)
    c2[:a.shape[0]] = c1
    sig = np.zeros((a.shape[0], 1), np.int32)
    want_v, want_i = _knn_scan_block_comp(
        jnp.asarray(a), jnp.asarray(b), np.int32(0), np.int32(nb_real),
        sig, np.zeros((b.shape[0], 1), np.int32), jnp.asarray(c1),
        jnp.asarray(c2), s64=s64, knn=knn, tc=256, exclude_self=True,
        masked=False, cutoff=0.64,
    )
    comp = Completeness(torch.from_numpy(c1), torch.from_numpy(c2), 0.64, s64)
    keys = knn_select(_t(a), _t(b), knn, nb_real=nb_real, exclude_self=True,
                      comp=comp)
    assert torch.equal(keys, knn_select_ref(
        _t(a), _t(b), knn, nb_real=nb_real, exclude_self=True, comp=comp,
        row_tile=100, col_tile=128))
    assert keys.dtype == torch.int64
    _jac, idx = _decode(keys, s64, nb_real, True)
    np.testing.assert_array_equal(idx, np.asarray(want_i))
    sb, idx2 = knn_scan(_t(a), _t(b[:nb_real]), knn, exclude_self=True,
                        comp_rows=c1, comp_cols=c2[:nb_real], cutoff=0.64)
    np.testing.assert_array_equal(sb, np.asarray(want_v))
    np.testing.assert_array_equal(idx2, np.asarray(want_i))


@pytest.mark.parametrize("knn", [39, 40, 64])
def test_knn_select_twin_pads_rows_with_fewer_candidates(knn):
    """knn >= n: the n - 1 valid keys in order, then INVALID."""
    rng = np.random.default_rng(24)
    s64, n = 2, 40
    a = _u32(n, s64, rng)
    keys = knn_select(_t(a), _t(a), knn, exclude_self=True)
    assert keys.shape == (n, knn)
    assert (keys[:, : n - 1] >= 0).all() and (keys[:, n - 1 :] == INVALID).all()
    _sb, idx = _decode(keys, s64, n, False)
    for r in range(n):
        assert sorted(idx[r, : n - 1]) == [c for c in range(n) if c != r]


def test_knn_select_twin_ties_go_to_the_lowest_column():
    """Equal samebits: the lower column has the larger key."""
    s64, a, b = _scan_inputs(25)
    keys = knn_select(_t(a), _t(b), 4, exclude_self=True)
    sb, idx = _decode(keys, s64, 512, False)
    # row 10 equals columns 300 and 301 (and itself, excluded)
    assert list(idx[10, :2]) == [300, 301] and sb[10, 0] == sb[10, 1] == s64 * 64


def test_knn_select_twin_int64_key_route(monkeypatch):
    """Past the int32 column field the keys widen to int64 and select the
    same columns and samebits."""
    from sketchtpu_torch.dist import knn_kernels

    s64, a, b = _scan_inputs(26)
    want = _decode(knn_select(_t(a), _t(b), 7, exclude_self=True), s64, 512,
                   False)
    monkeypatch.setattr(knn_kernels, "pack_shift", lambda s64: 8)
    keys = knn_select(_t(a), _t(b), 7, exclude_self=True)
    assert keys.dtype == torch.int64
    got = _decode(keys, s64, 512, False)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_knn_select_rows_offset_excludes_the_global_row():
    """row0 shifts the rows' ids: exclude_self drops column row0 + i."""
    s64, a, b = _scan_inputs(27)
    keys = knn_select(_t(b[100:140]), _t(b), 5, row0=100, exclude_self=True)
    _sb, idx = _decode(keys, s64, 512, False)
    assert not (idx == (100 + np.arange(40))[:, None]).any()
    full = samebits_matrix(b[100:140].view(np.uint64), b.view(np.uint64))
    full[np.arange(40), 100 + np.arange(40)] = -1
    np.testing.assert_array_equal(np.sort(full, axis=1)[:, ::-1][:, :5],
                                  _decode(keys, s64, 512, False)[0])
