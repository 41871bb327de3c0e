"""The port's CUDA kernels against their plain PyTorch twins on the card:
ragged tile edges, strided k-planes, tri offsets, completeness, several
k and genome layouts. Every test needs a CUDA device and skips without
one. This file imports no jax, so on a machine with a card and no jax it
runs without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from sketchtpu_torch.dist.api import DistType
from sketchtpu_torch.dist.coreacc_kernels import (
    KEY_INVALID,
    MAX_NK,
    coreacc,
    coreacc_keys,
    coreacc_keys_ref,
    coreacc_ref,
)
from sketchtpu_torch.dist.knn_kernels import Completeness, knn_keys, knn_keys_ref
from sketchtpu_torch.dist.knn_torch import DeviceKnnEngine
from sketchtpu_torch.dist.samebits_kernels import (
    samebits,
    samebits_full,
    samebits_ref,
)
from sketchtpu_torch.formats.skm import MultiSketch
from sketchtpu_torch.hash.nthash_torch import (
    nthash_bin,
    nthash_bin_ref,
    pack_group,
    tap_tables,
)
from sketchtpu_torch.sketchcore.sketch import HashType, Sketch
from sketchtpu_torch.synth import derive_words, random_streams

pytestmark = pytest.mark.gpu

KMERS = (17, 21, 25, 29)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _words(n, s64, seed, device):
    rng = np.random.default_rng(seed)
    parents = rng.integers(0, 2**64, (3, len(KMERS), s64, 14), dtype=np.uint64)
    w = derive_words(parents, n, KMERS, seed).reshape(n, len(KMERS), s64 * 14)
    return torch.from_numpy(w.view(np.int64)).to(device)


@pytest.mark.parametrize("na,nb,s64", [(1, 1, 1), (70, 130, 16), (64, 64, 3),
                                        (200, 333, 16)])
@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
def test_samebits_kernel_matches_twin(cuda, na, nb, s64, dtype):
    w = _words(max(na, nb), s64, 1, cuda)
    a, b = w[:na, 1], w[:nb, 2]  # strided k-planes, read in place
    got = samebits(a, b, out_dtype=dtype)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert torch.equal(got, samebits_ref(a, b, out_dtype=dtype))


@pytest.mark.parametrize("row0", [0, 37, 64, 250, 1000])
def test_samebits_tri_matches_twin_above_diagonal(cuda, row0):
    w = _words(300, 16, 2, cuda)[:, 0]
    a = w[: 100]
    got = samebits(a, w, out_dtype=torch.int16, tri=True, row0=row0)
    want = samebits_ref(a, w, out_dtype=torch.int16)
    upper = (torch.arange(300, device=cuda)[None, :]
             > row0 + torch.arange(100, device=cuda)[:, None])
    assert torch.equal(got[upper], want[upper])


def _kwords(n, kmers, s64, seed, device):
    """(n, nk, s64*14) words of related samples at each k of kmers."""
    rng = np.random.default_rng(seed)
    parents = rng.integers(0, 2**64, (3, len(kmers), s64, 14), dtype=np.uint64)
    w = derive_words(parents, n, kmers, seed).reshape(n, len(kmers), s64 * 14)
    return torch.from_numpy(w.view(np.int64)).to(device)


def _comp(n, seed, device):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(n, generator=g) * 0.4 + 0.6).to(device)


# one below, at and one past the 64 x 64 pair tile, and two tiles
@pytest.mark.parametrize("na,nb", [(1, 1), (33, 65), (63, 63), (64, 64),
                                   (65, 65), (100, 257), (129, 63)])
@pytest.mark.parametrize("with_comp", [False, True])
def test_coreacc_kernel_matches_twin(cuda, na, nb, with_comp):
    w = _words(na + nb, 16, 3, cuda)
    a, b = w[:na], w[na:]
    c1 = c2 = None
    if with_comp:
        c = _comp(na + nb, na * nb, cuda)
        c1, c2 = c[:na].contiguous(), c[na:].contiguous()
    got = coreacc(a, b, KMERS, 1024, c1, c2)
    torch.cuda.synchronize()
    want = coreacc_ref(a, b, KMERS, 1024, c1, c2)
    for g, r in zip(got, want):
        assert torch.equal(g, r)  # the twin's operations in its order


# s64 that the kernel's 2-chunk stages do not divide; nk < 3 takes the
# n < 3 branch; the k-planes are a strided selection (row stride > nk*W)
@pytest.mark.parametrize("s64", [1, 3, 5, 16])
@pytest.mark.parametrize("nk", [1, 2, 3, 7, MAX_NK])
@pytest.mark.parametrize("with_comp", [False, True])
def test_coreacc_kernel_matches_twin_across_s64_and_nk(cuda, s64, nk,
                                                        with_comp):
    kmers = tuple(range(9, 9 + 2 * (nk + 1), 2))
    w = _kwords(150, kmers, s64, 10 + s64, cuda)[:, 1:]
    a, b, kmers = w[:70], w[20:150], kmers[1:]
    c1 = c2 = None
    if with_comp:
        c = _comp(150, s64 * nk, cuda)
        c1, c2 = c[:70].contiguous(), c[20:150].contiguous()
    got = coreacc(a, b, kmers, s64 * 64, c1, c2)
    torch.cuda.synchronize()
    want = coreacc_ref(a, b, kmers, s64 * 64, c1, c2)
    for g, r in zip(got, want):
        assert torch.equal(g, r)
    if nk < 3:
        assert (got[0] == 1).all() and (got[1] == 1).all()


@pytest.mark.parametrize("row0", [0, 20, 63, 64, 95, 130, 190])
def test_coreacc_tri_matches_twin_above_diagonal(cuda, row0):
    w = _words(260, 16, 4, cuda)
    a = w[row0 : row0 + 70]
    got = coreacc(a, w, KMERS, 1024, tri=True, row0=row0)
    want = coreacc_ref(a, w, KMERS, 1024)
    upper = (torch.arange(260, device=cuda)[None, :]
             > row0 + torch.arange(a.shape[0], device=cuda)[:, None])
    for g, r in zip(got, want):
        assert torch.equal(g[upper], r[upper])


@pytest.mark.parametrize("comp", [False, True])
@pytest.mark.parametrize(
    "tr,tc,row0,col0,nb_real",
    [
        (64, 64, 0, 0, 64),  # one tile on the diagonal
        (70, 131, 0, 0, 131),  # ragged tiles, diagonal inside
        (33, 100, 120, 50, 400),  # off the diagonal, partly overlapping ids
        (65, 190, 300, 0, 400),  # off the diagonal, no overlap
        (45, 160, 10, 40, 157),  # nb_real inside the last tile
        (20, 200, 0, 100, 165),  # whole tiles past nb_real
    ],
)
def test_coreacc_keys_kernel_matches_twin(cuda, comp, tr, tc, row0, col0,
                                          nb_real):
    w = _words(500, 16, 6, cuda)
    a = w[row0 : row0 + tr]
    b = w[col0 : col0 + tc]
    c1 = c2 = None
    if comp:
        c = _comp(500, tr * tc, cuda)
        c1, c2 = c[row0 : row0 + tr].contiguous(), c[col0 : col0 + tc].contiguous()
    for excl in (False, True):
        kw = dict(row0=row0, col0=col0, nb_real=nb_real, exclude_self=excl)
        keys, acc = coreacc_keys(a, b, KMERS, 1024, c1, c2, **kw)
        torch.cuda.synchronize()
        want_keys, want_acc = coreacc_keys_ref(a, b, KMERS, 1024, c1, c2, **kw)
        assert keys.dtype == torch.int64
        assert torch.equal(keys, want_keys)
        assert torch.equal(acc, want_acc)
        ids = col0 + torch.arange(tc, device=cuda)
        assert (keys[:, ids >= nb_real] == KEY_INVALID).all()


def test_coreacc_rejects_nk_past_its_limit(cuda):
    kmers = tuple(range(3, 3 + MAX_NK + 1))
    w = torch.zeros((4, len(kmers), 14), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="limit"):
        coreacc(w, w, kmers, 64)
    with pytest.raises(ValueError, match="limit"):
        coreacc_keys(w, w, kmers, 64)


@pytest.mark.parametrize("k", [1, 3, 17, 31, 64, 200])
@pytest.mark.parametrize("rc", [True, False])
def test_nthash_kernel_matches_twin(cuda, k, rc):
    streams = random_streams([300, 70_000, 5, 123_457], seed=k,
                             breaks_per_mb=2000)
    seq, starts = pack_group(streams)
    seq_d, starts_d = torch.from_numpy(seq).to(cuda), torch.from_numpy(starts).to(cuda)
    tf, tr = (torch.from_numpy(t).to(cuda) for t in tap_tables(k))
    for nbins in (64, 1024, 1000):
        got = nthash_bin(seq_d, k, tf, tr, rc, starts_d, nbins)
        assert torch.equal(got, nthash_bin_ref(seq_d, k, tf, tr, rc, starts_d,
                                               nbins))


def test_nthash_kernel_rejects_k_past_its_limit(cuda):
    seq = torch.zeros(1000, dtype=torch.uint8, device=cuda)
    tf = torch.zeros((513, 4), dtype=torch.int64, device=cuda)
    starts = torch.zeros(1, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="limit"):
        nthash_bin(seq, 513, tf, tf, True, starts, 64)


@pytest.mark.parametrize("na,nb", [(1, 1), (70, 130), (200, 333)])
def test_samebits_full_kernel_matches_twin(cuda, na, nb):
    w = _words(max(na, nb), 16, 5, cuda)
    a, b = w[:na, 3], w[:nb, 0]
    got = samebits_full(a, b)
    assert got.dtype == torch.int32
    assert torch.equal(got, samebits_ref(a, b))


@pytest.mark.parametrize("comp", [False, True])
@pytest.mark.parametrize(
    "tr,tc,row0,col0,nb_real",
    [
        (64, 64, 0, 0, 64),  # aligned, on the diagonal
        (70, 131, 0, 0, 131),  # ragged tiles, diagonal inside
        (33, 100, 120, 50, 400),  # off the diagonal, partly overlapping ids
        (50, 190, 300, 0, 400),  # off the diagonal, no overlap
        (45, 160, 10, 40, 157),  # nb_real inside the last tile
        (20, 64, 0, 200, 210),  # a tile mostly past nb_real
    ],
)
def test_knn_keys_kernel_matches_twin(cuda, comp, tr, tc, row0, col0,
                                      nb_real):
    w = _words(500, 16, 6, cuda)
    a = w[row0 : row0 + tr, 2]  # strided k-plane, read in place
    b = w[col0 : col0 + tc, 2]
    c = None
    if comp:
        cv = torch.rand(500, device=cuda) * 0.5 + 0.5
        c = Completeness(cv[row0 : row0 + tr].contiguous(), cv, 0.64, 16)
    for excl in (False, True):
        kw = dict(row0=row0, col0=col0, nb_real=nb_real, exclude_self=excl,
                  comp=c)
        got = knn_keys(a, b, **kw)
        torch.cuda.synchronize()
        want = knn_keys_ref(a, b, **kw)
        assert got.dtype == want.dtype == (torch.int64 if comp else torch.int32)
        assert torch.equal(got, want)


@pytest.mark.parametrize("s64", [3, 5])
def test_knn_keys_completeness_twin_divides_as_the_kernel(cuda, s64):
    """At a sketch size whose bit count is not a power of two the twin's
    divisions must still be IEEE quotients, as the kernel's are."""
    w = _kwords(200, KMERS, s64, 20 + s64, cuda)[:, 1]
    cv = _comp(200, s64, cuda)
    comp = Completeness(cv[:70].contiguous(), cv, 0.64, s64)
    kw = dict(row0=0, col0=0, nb_real=200, exclude_self=True, comp=comp)
    assert torch.equal(knn_keys(w[:70], w, **kw), knn_keys_ref(w[:70], w, **kw))


def _engine_ms(n, kmers, seed):
    s64 = 16
    rng = np.random.default_rng(seed)
    parents = rng.integers(0, 2**64, (4, len(kmers), s64, 14), dtype=np.uint64)
    words = derive_words(parents, n, kmers, seed)
    words[n - 3 :] = words[:3]  # exact ties
    ms = MultiSketch([Sketch(name=f"g{i}", index=i) for i in range(n)],
                     s64 * 64, list(kmers), HashType("dna"))
    ms.sketch_bins = words.reshape(-1)
    return ms


@pytest.mark.parametrize("with_comp", [False, True])
def test_knn_engine_on_card_matches_cpu_twins(cuda, with_comp):
    kmers = (17, 21, 25, 29)
    ms = _engine_ms(700, kmers, 7)
    comp = (np.random.default_rng(8).uniform(0.6, 1.0, 700)
            if with_comp else None)
    kw = dict(row_tile=256, col_tile=300)
    on_card = DeviceKnnEngine(ms, cuda, **kw)
    on_cpu = DeviceKnnEngine(ms, torch.device("cpu"), **kw)
    for dt in (DistType(k_idx=0, k=17.0), DistType(k_idx=2, k=25.0, ani=True)):
        got = on_card.self_knn(10, dt, completeness_vec=comp)
        want = on_cpu.self_knn(10, dt, completeness_vec=comp)
        for g, w in zip(got.as_arrays(), want.as_arrays()):
            np.testing.assert_array_equal(g, w)
    got = on_card.self_knn_coreacc(10, completeness_vec=comp)
    want = on_cpu.self_knn_coreacc(10, completeness_vec=comp)
    for g, w in zip(got.as_arrays(), want.as_arrays()):
        np.testing.assert_array_equal(g, w)
