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
from sketchtpu_torch import _build
from sketchtpu_torch.dist.knn_kernels import (
    INVALID,
    MAX_KNN,
    Completeness,
    knn_keys,
    knn_keys_ref,
    knn_select,
    knn_select_ref,
)
from sketchtpu_torch.dist.knn_torch import DeviceKnnEngine
from sketchtpu_torch.dist.samebits_kernels import (
    samebits,
    samebits_full,
    samebits_ref,
)
from sketchtpu_torch.formats.skm import MultiSketch
from sketchtpu_torch.hash.nthash_torch import (
    MAX_K_CUDA,
    bin_size,
    magic_div,
    nthash_bin,
    nthash_bin_multi,
    nthash_bin_multi_ref,
    nthash_bin_ref,
    pack_group,
    tap_tables,
)
from sketchtpu_torch.ingest.fastx import DnaStream
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
    """Every entry: counts above the diagonal, zeros at and below it."""
    w = _words(300, 16, 2, cuda)[:, 0]
    a = w[: 100]
    got = samebits(a, w, out_dtype=torch.int16, tri=True, row0=row0)
    want = samebits_ref(a, w, out_dtype=torch.int16, tri=True, row0=row0)
    assert torch.equal(got, want)
    upper = (torch.arange(300, device=cuda)[None, :]
             > row0 + torch.arange(100, device=cuda)[:, None])
    assert torch.equal(got[upper], samebits_ref(a, w, out_dtype=torch.int16)[upper])


# the pair tile of samebits.cu: 64 rows x 64 columns, 16 x 16 threads
_SB_TI, _SB_TJ = 64, 64


# one below, at and one past the block tile in each dimension, and more
@pytest.mark.parametrize("na", [1, _SB_TI - 1, _SB_TI, _SB_TI + 1,
                                2 * _SB_TI + 3])
@pytest.mark.parametrize("nb", [1, _SB_TJ - 1, _SB_TJ, _SB_TJ + 1,
                                3 * _SB_TJ - 5])
@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
def test_samebits_kernel_at_tile_edges(cuda, na, nb, dtype):
    w = _words(max(na, nb), 3, 11, cuda)
    a, b = w[:na, 0], w[:nb, 3]
    got = samebits(a, b, out_dtype=dtype)
    torch.cuda.synchronize()
    assert torch.equal(got, samebits_ref(a, b, out_dtype=dtype))


# s64 1 and 3 (and 625) leave the last stage of the two-chunk ring half
# empty; 625 chunks are 40,000 bins, past int16 (K4 only there)
@pytest.mark.parametrize("s64,kernel", [
    (s64, kernel) for s64 in (1, 2, 3, 16, 625)
    for kernel in ("K1 int16", "K1 int32", "K4")
    if not (kernel == "K1 int16" and s64 * 64 > 32767)
])
def test_samebits_kernels_across_s64_on_strided_planes(cuda, s64, kernel):
    w = _words(200, s64, 20 + s64, cuda)
    a, b = w[3:150, 1], w[:, 2]  # k-planes read through their row stride
    if kernel == "K4":
        got, want = samebits_full(a, b), samebits_ref(a, b)
    else:
        dtype = torch.int16 if kernel == "K1 int16" else torch.int32
        got = samebits(a, b, out_dtype=dtype)
        want = samebits_ref(a, b, out_dtype=dtype)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype
    assert torch.equal(got, want)


# row0 on warp-tile (16) and block-tile (64) boundaries and off them;
# row0 >= nb skips every block
@pytest.mark.parametrize("row0", [0, 15, 16, 63, 64, 65, 127, 128, 129, 191,
                                  299, 300, 5000])
@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
def test_samebits_tri_every_entry(cuda, row0, dtype):
    w = _words(300, 5, 7, cuda)
    a = w[40:240, 1]
    got = samebits(a, w[:, 1], out_dtype=dtype, tri=True, row0=row0)
    torch.cuda.synchronize()
    want = samebits_ref(a, w[:, 1], out_dtype=dtype, tri=True, row0=row0)
    assert torch.equal(got, want)
    if row0 >= 300:
        assert not got.any()


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
    k = MAX_K_CUDA + 1
    seq = torch.zeros(1000, dtype=torch.uint8, device=cuda)
    tf = torch.zeros((k, 4), dtype=torch.int64, device=cuda)
    starts = torch.zeros(1, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="limit"):
        nthash_bin(seq, k, tf, tf, True, starts, 64)
    with pytest.raises(ValueError, match="limit"):
        nthash_bin_multi(seq, (17, k), True, starts, 64)


def _edge_streams(run, seed):
    """Genomes whose starts and breaks fall on the first, last and middle
    window start of a thread's run of `run` windows, with a genome shorter
    than most k and an empty one."""
    rng = np.random.default_rng(seed)
    lens = [run * 256 + run, 45, 0, 7, run * 2 + 1, run * 300 - 1, 70_001]
    streams = []
    for n in lens:
        codes = rng.integers(0, 4, n).astype(np.uint8)
        at = {run, run + 1, 2 * run - 1, run + run // 2, 40, run * 256 - 1,
              run * 256, run * 256 + 1}
        at |= {int(b) for b in rng.integers(1, max(n, 2), 6)}
        brk = np.array(sorted(b for b in at if 0 < b < n), dtype=np.int64)
        streams.append(DnaStream(codes=codes, breaks=brk,
                                 acgt=np.bincount(codes, minlength=4)))
    return streams


# 8192 bins do not fit the block's shared-memory table beside its span:
# there the minima go to device memory directly
@pytest.mark.parametrize("nbins", [64, 1000, 8192])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("rc", [True, False])
def test_nthash_multi_kernel_matches_twin_at_run_edges(cuda, nbins, seed, rc):
    seq, starts = pack_group(_edge_streams(64, seed))  # 64 starts per thread
    seq_d = torch.from_numpy(seq).to(cuda)
    starts_d = torch.from_numpy(starts).to(cuda)
    kmers = (3, 17, 31, 64, 513)
    want = nthash_bin_multi_ref(seq_d, kmers, rc, starts_d, nbins)
    got = nthash_bin_multi(seq_d, kmers, rc, starts_d, nbins)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    # the caller's k order, duplicates included
    mixed = nthash_bin_multi(seq_d, (64, 3, 17, 3), rc, starts_d, nbins)
    assert torch.equal(mixed, want[[3, 0, 1, 0]])


def test_nthash_multi_kernel_at_its_largest_k(cuda):
    streams = random_streams([40_000, 300, 20_000], seed=3, breaks_per_mb=50)
    seq, starts = pack_group(streams)
    seq_d = torch.from_numpy(seq).to(cuda)
    starts_d = torch.from_numpy(starts).to(cuda)
    kmers = (31, 4097, MAX_K_CUDA)
    got = nthash_bin_multi(seq_d, kmers, True, starts_d, 256)
    assert torch.equal(got, nthash_bin_multi_ref(seq_d, kmers, True, starts_d,
                                                 256))


@pytest.mark.parametrize("nbins", [1, 64, 1000, 1024, 32768 + 64, 2**31])
def test_magic_division_kernel_on_its_boundaries(cuda, nbins):
    d = bin_size(nbins)
    last = ((1 << 61) - 2) // d
    xs = [0, 1, (1 << 61) - 2, (1 << 61) - 1]
    for m in (1, 2, last, last + 1):
        xs += [m * d - 1, m * d, m * d + 1]
    xs = [x for x in xs if 0 <= x < 1 << 61]
    rng = np.random.default_rng(nbins % 1000)
    xs += [int(v) for v in rng.integers(0, 1 << 61, 4096)]
    got = magic_div(torch.tensor(xs, dtype=torch.int64, device=cuda), d)
    assert got.tolist() == [x // d for x in xs]


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


# --- K3 in selection mode ---------------------------------------------------

def _select_case(cuda, tr, nb, s64, knn, *, row0=0, nb_real=None, comp=False,
                 excl=True, splits=None, seed=11):
    w = _kwords(max(row0 + tr, nb), KMERS, s64, seed, cuda)[:, 1]
    rows, cols = w[row0 : row0 + tr], w[:nb]
    c = None
    if comp:
        cv = _comp(max(row0 + tr, nb), seed, cuda)
        c = Completeness(cv[row0 : row0 + tr].contiguous(), cv[:nb].contiguous(),
                         0.64, s64)
    kw = dict(row0=row0, nb_real=nb_real, exclude_self=excl, comp=c)
    got = knn_select(rows, cols, knn, splits=splits, **kw)
    torch.cuda.synchronize()
    want = knn_select_ref(rows, cols, knn, col_tile=100, **kw)
    assert got.dtype == want.dtype and got.shape == (tr, knn)
    assert torch.equal(got, want)
    return got


# one below, at and one past the 64-row and 64-column tiles
@pytest.mark.parametrize("tr", [1, 63, 64, 65])
@pytest.mark.parametrize("nb", [63, 64, 65, 200])
@pytest.mark.parametrize("comp", [False, True])
def test_knn_select_kernel_matches_twin_at_tile_edges(cuda, tr, nb, comp):
    _select_case(cuda, tr, nb, 16, 10, comp=comp)
    _select_case(cuda, tr, nb, 16, 10, comp=comp, excl=False, row0=30)


@pytest.mark.parametrize("s64", [1, 3, 5, 16])
@pytest.mark.parametrize("comp", [False, True])
def test_knn_select_kernel_matches_twin_across_s64(cuda, s64, comp):
    _select_case(cuda, 130, 700, s64, 20, comp=comp, nb_real=650)


@pytest.mark.parametrize("knn", [1, 31, 32, 33, 50, 64, 65, 200, MAX_KNN])
@pytest.mark.parametrize("comp", [False, True])
def test_knn_select_kernel_matches_twin_across_knn(cuda, knn, comp):
    """List lengths around the warp's 32 lanes, the usual 50, and the limit
    (32 or 16 rows per block there); fewer columns than knn pads rows."""
    _select_case(cuda, 100, 1500, 16, knn, comp=comp)
    if knn > 100:
        got = _select_case(cuda, 70, 90, 16, knn, comp=comp)
        assert (got[:, 89:] == INVALID).all() and (got[:, :89] >= 0).all()


def test_knn_select_kernel_rows_per_block(cuda):
    """Fewer rows per block where longer lists need the shared memory; the
    sign mask's staging leaves the same rows."""
    rows = _build.lib().stpu_knn_select_rows
    for mask in (0, 1):
        assert rows(50, 4, mask) == rows(50, 8, mask) == rows(128, 4, mask) \
            == 64
        assert rows(MAX_KNN, 4, mask) == 32
        assert rows(MAX_KNN, 8, mask) == 16
        assert rows(MAX_KNN + 1, 4, mask) == 0


def test_knn_select_kernel_rejects_knn_past_its_limit(cuda):
    w = _kwords(10, KMERS, 16, 1, cuda)[:, 0]
    with pytest.raises(ValueError, match="limit"):
        knn_select(w, w, MAX_KNN + 1)


def test_knn_select_kernel_all_invalid_rows(cuda):
    """No real column, or the only column is the row itself: INVALID."""
    w = _kwords(70, KMERS, 16, 2, cuda)[:, 0]
    got = knn_select(w[:1], w[:1], 5, exclude_self=True)
    assert (got == INVALID).all() and got.shape == (1, 5)
    got = knn_select(w, w, 5, nb_real=0)
    assert (got == INVALID).all() and got.shape == (70, 5)


@pytest.mark.parametrize("comp", [False, True])
def test_knn_select_kernel_column_splits_agree(cuda, comp):
    """1 to 8 column splits (and more than there are column tiles) merge to
    the same selection; 3 rows take the default split."""
    base = _select_case(cuda, 3, 3000, 16, 50, comp=comp, excl=False, splits=1)
    for splits in (2, 3, 4, 5, 6, 7, 8, 1000, None):
        got = _select_case(cuda, 3, 3000, 16, 50, comp=comp, excl=False,
                           splits=splits)
        assert torch.equal(got, base)
    _select_case(cuda, 200, 777, 5, 33, comp=comp, splits=4)


def test_knn_select_kernel_int64_plain_keys(cuda, monkeypatch):
    """Past the int32 column field plain keys are int64."""
    from sketchtpu_torch.dist import knn_kernels

    monkeypatch.setattr(knn_kernels, "pack_shift", lambda s64: 8)
    got = _select_case(cuda, 100, 400, 16, 12)
    assert got.dtype == torch.int64


# --- the signs mode of the ntHash kernel (reads) ----------------------------

def _reads_stream(n, seed, read_len=150):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n).astype(np.uint8)
    breaks = np.arange(read_len, n + 1, read_len)
    breaks = np.unique(np.concatenate([breaks, rng.integers(1, n, n // 300),
                                       [n]]))
    return DnaStream(codes=codes, breaks=breaks.astype(np.int64), reads=True)


def _signs_case(cuda, stream_seq, kmers, rc, n_out=None):
    from sketchtpu_torch.hash.nthash_torch import nthash_signs, nthash_signs_ref

    seq_d = torch.from_numpy(stream_seq).to(cuda)
    got = nthash_signs(seq_d, kmers, rc, n_out)
    torch.cuda.synchronize()
    n = got.shape[1]
    want = torch.stack([nthash_signs_ref(seq_d, [k], rc, n)[0]
                        for k in kmers])
    assert torch.equal(got, want)
    return got


@pytest.mark.parametrize("k", [1, 17, 31, 64, 4097])
@pytest.mark.parametrize("rc", [True, False])
def test_nthash_signs_kernel_matches_twin(cuda, k, rc):
    """Breaks at every read end, N runs inside reads, a random assembly
    with its own breaks: every window start's sign or u64 max (reads have
    no window past their 150 bases)."""
    breaks = 2000 if k < 500 else 50
    for seq in (pack_group([_reads_stream(70_001, k)])[0],
                pack_group(random_streams([123_457], seed=k,
                                          breaks_per_mb=breaks))[0]):
        got = _signs_case(cuda, seq, [k], rc)
        assert (got != -1).any() or len(seq) == 70_001 and k > 150


@pytest.mark.parametrize("n_out", [None, 1, 63, 64, 16_383, 16_384, 16_385,
                                   40_000])
def test_nthash_signs_kernel_multi_k_and_n_out(cuda, n_out):
    """Several k (unsorted) in one launch, owned starts below, at and past
    a thread's run and a block's span, and past the last window."""
    seq = pack_group([_reads_stream(33_000, 5)])[0]
    _signs_case(cuda, seq, [31, 17, 21, 129], True, n_out)


@pytest.mark.parametrize("n_out", [17, 4095, 4097, 20_001, 33_001])
@pytest.mark.parametrize("kmers", [[17], list(range(131, 2, -1))])
def test_nthash_signs_kernel_ragged_runs(cuda, n_out, kmers):
    """n_out not a multiple of a thread's run or of a block's starts, odd
    (every other k row is not 16-byte aligned) and past the last window;
    one k and 129 k (two launches)."""
    seq = pack_group([_reads_stream(33_000, 8)])[0]
    _signs_case(cuda, seq, kmers, True, n_out)


def test_nthash_signs_kernel_on_chunks_of_a_stream(cuda):
    """Chunks as the backend cuts them (views into one upload, k - 1 bases
    of overlap) concatenate to the whole stream's signs."""
    from sketchtpu_torch.hash.nthash_torch import nthash_signs
    from sketchtpu_torch.sketchcore.sketch_torch import read_chunks

    stream = _reads_stream(200_000, 6)
    seq_d = torch.from_numpy(pack_group([stream])[0]).to(cuda)
    kmers = [17, 25]
    whole = nthash_signs(seq_d, kmers, True)
    parts = [nthash_signs(seq_d[c0 : min(200_000, c0 + own + 24)], kmers,
                          True, own)
             for c0, own in read_chunks(200_000, kmers, 16_411)]
    assert torch.equal(torch.cat(parts, dim=1), whole)


def test_nthash_split_past_128_k_on_the_card(cuda):
    """129 k values: two launches of each mode, one result."""
    from sketchtpu_torch.hash.nthash_torch import (
        nthash_signs,
        nthash_signs_ref,
    )

    kmers = list(range(3, 132))
    seq = pack_group([_reads_stream(5000, 7)])[0]
    seq_d = torch.from_numpy(seq).to(cuda)
    before = nthash_signs.launches
    got = nthash_signs(seq_d, kmers[::-1], True)
    assert nthash_signs.launches == before + 2
    assert torch.equal(got, nthash_signs_ref(seq_d, kmers[::-1], True,
                                             got.shape[1]))
    starts = torch.zeros(1, dtype=torch.int64, device=cuda)
    before = nthash_bin_multi.launches
    got = nthash_bin_multi(seq_d, kmers, True, starts, 256)
    assert nthash_bin_multi.launches == before + 2
    assert torch.equal(got, nthash_bin_multi_ref(seq_d, kmers, True, starts,
                                                 256))


def test_reads_backend_on_card_matches_cpu(cuda, monkeypatch):
    from sketchtpu_torch.sketchcore import sketch_torch
    from sketchtpu_torch.sketchcore.sketch_torch import DeviceSketchBackend

    streams = [_reads_stream(n, 20 + n) for n in (30_000, 151, 80_000)]
    streams.append(random_streams([50_000], seed=3)[0])
    names = list("abcd")
    want = DeviceSketchBackend(torch.device("cpu")).sketch_dna_streams(
        streams, names, [17, 21, 25], 1024, True, 1)
    for chunk in (None, 7_777):
        if chunk is not None:
            monkeypatch.setattr(sketch_torch, "_chunk_starts",
                                lambda nk: chunk)
        got = DeviceSketchBackend(cuda).sketch_dna_streams(
            streams, names, [17, 21, 25], 1024, True, 1)
        for g, w in zip(got, want):
            assert np.array_equal(g.usigs, w.usigs)
            assert g.seq_length == w.seq_length


# --- signeq.cu: the inverted index's sign equality ----------------------------

def _sign_rows(n, s, alphabet, seed):
    rng = np.random.default_rng(seed)
    m = rng.integers(0, alphabet, (n, s)).astype(np.uint16)
    m[rng.random((n, s)) < 0.01] = 0xFFFF
    return m


@pytest.mark.parametrize("s", [1, 2, 99, 100, 1000])
@pytest.mark.parametrize("nq,n", [(1, 1), (63, 65), (64, 64), (65, 200),
                                  (130, 63), (1, 3000), (8, 2000),
                                  (17, 300), (101, 1500)])
def test_signeq_kernel_matches_twin(cuda, s, nq, n):
    """1 (serve), 8 and 101 (inverted query at 661,000 rows) queries, a
    query-group edge (17 = 16 + 1) and ragged row tiles, on a contiguous
    index and on one whose row stride is past its words (4-byte copies
    where the stride is odd)."""
    from sketchtpu_torch.inverted.device import pack_signs, signeq, signeq_ref

    alphabet = 4 if s < 50 else 40
    m = _sign_rows(n, s, alphabet, s + n)
    q = _sign_rows(nq, s, alphabet, s + nq + 1)
    q[0] = m[min(n - 1, 3)]  # an all-bins match
    qd, md = pack_signs(q, cuda), pack_signs(m, cuda)
    for pad in (0, 1, 2):
        wide = torch.zeros((n, md.shape[1] + pad), dtype=torch.int32,
                           device=cuda)
        wide[:, : md.shape[1]] = md
        mv = wide[:, : md.shape[1]]
        for mode in ("count", "any", "all"):
            got = signeq(qd, mv, s, mode)
            torch.cuda.synchronize()
            assert torch.equal(got, signeq_ref(qd, md, s, mode)), (mode, pad)
    assert signeq(qd, md, s, "all")[0, min(n - 1, 3)]


@pytest.mark.parametrize("s", [99, 100])
@pytest.mark.parametrize("qr", [1, 2, 4, 8, 16])
def test_signeq_kernel_launch_shapes(cuda, monkeypatch, s, qr):
    """Every query group size against every row split the wrapper makes:
    groups with pad queries, row ranges shorter than a tile."""
    from sketchtpu_torch.inverted import device

    m = device.pack_signs(_sign_rows(2000, s, 40, s), cuda)
    q = device.pack_signs(_sign_rows(19, s, 40, s + 1), cuda)
    monkeypatch.setattr(device, "query_group", lambda nq, words: qr)
    for slots in (1, 3 * -(-19 // qr), 7 * -(-19 // qr), 10_000):
        monkeypatch.setattr(device, "_slots", lambda *a: slots)
        for mode in ("count", "any", "all"):
            got = device.signeq(q, m, s, mode)
            assert torch.equal(got, device.signeq_ref(q, m, s, mode)), (
                mode, slots)


def test_signeq_kernel_splits_words(cuda, monkeypatch):
    """Past _MAX_WORDS the wrapper runs the kernel on column slices and
    sums the counts, ORs any and ANDs all."""
    from sketchtpu_torch.inverted import device

    monkeypatch.setattr(device, "_MAX_WORDS", 16)
    for s in (99, 100):
        m = _sign_rows(300, s, 3, s)
        q = _sign_rows(5, s, 3, s + 1)
        q[1] = m[7]
        qd, md = device.pack_signs(q, cuda), device.pack_signs(m, cuda)
        before = device.signeq.launches
        for mode in ("count", "any", "all"):
            got = device.signeq(qd, md, s, mode)
            assert torch.equal(got, device.signeq_ref(qd, md, s, mode)), mode
        assert device.signeq.launches == before + 3 * 4
        assert device.signeq(qd, md, s, "all")[1, 7]


@pytest.mark.parametrize("s", [1, 99, 100, 1000])
@pytest.mark.parametrize("lo,hi", [(0, 700), (3, 700), (65, 129), (64, 64),
                                   (699, 700), (200, 210)])
def test_pair_count_kernel_matches_twin(cuda, s, lo, hi):
    from sketchtpu_torch.inverted.device import (
        pack_signs,
        pair_count,
        pair_count_ref,
    )

    m = pack_signs(_sign_rows(700, s, 3 if s < 50 else 500, s), cuda)
    want = pair_count_ref(m, s, lo, hi)
    for splits in (None, 1, 2, 7, 1000):
        assert pair_count(m, s, lo, hi, splits=splits) == want


def _adversarial_signs(n, s, seed):
    """Signs from {0, 1, 0x7FFF, 0x8000, 0xFFFF} and a wide alphabet: rows
    equal only in their last real sign, rows that would match only in an
    odd S's pad half, all-0 and all-0xFFFF rows."""
    rng = np.random.default_rng(seed)
    edge = np.array([0, 1, 0x7FFF, 0x8000, 0xFFFF], np.uint16)
    m = rng.integers(0, 1 << 16, (n, s)).astype(np.uint16)
    pick = rng.random((n, s)) < 0.05
    m[pick] = edge[rng.integers(0, 5, int(pick.sum()))]
    m[0], m[1] = 0, 0xFFFF
    m[2] = (m[3].astype(np.int64) + 1).astype(np.uint16)
    m[2, -1] = m[3, -1]  # equal only in the last real sign
    m[4] = (m[5].astype(np.int64) + 7).astype(np.uint16)  # equal nowhere
    return m


@pytest.mark.parametrize("s", [1, 2, 67, 99, 100, 130, 250, 1000])
@pytest.mark.parametrize("lo,hi", [(0, 900), (127, 129), (128, 384),
                                   (1, 899), (255, 641), (896, 900)])
def test_pair_count_kernel_tile_and_chunk_edges(cuda, s, lo, hi):
    """Row ranges across the 128-row tile, word counts that the 32-word
    chunk does not divide (S = 67: 2 x 17; 130: 22 + 22 + 21; 250: past
    the resident row tile, 3 x 32 + 29), the values 0, 1, 0x7FFF, 0x8000
    and 0xFFFF, and odd S whose only equal half would be the pad."""
    from sketchtpu_torch.inverted.device import (
        pack_signs,
        pair_count,
        pair_count_ref,
    )

    m = pack_signs(_adversarial_signs(900, s, s), cuda)
    want = pair_count_ref(m, s, lo, hi)
    for splits in (None, 1, 3, 1000):
        assert pair_count(m, s, lo, hi, splits=splits) == want


def test_pair_count_kernel_past_2_31(cuda):
    """Every pair shares a sign: n (n - 1) / 2 > 2^31 at n = 70,000; the
    kernel's 64-bit total, against the closed form."""
    from sketchtpu_torch.inverted.device import pack_signs, pair_count

    n = 70_000
    m = pack_signs(np.zeros((n, 3), np.uint16), cuda)
    assert pair_count(m, 3) == n * (n - 1) // 2 > 1 << 31


def test_device_inverted_engine_on_card_matches_cpu(cuda):
    from sketchtpu_torch.inverted.device import DeviceInvertedEngine

    mat = _sign_rows(1000, 100, 30, 1)
    q = _sign_rows(9, 100, 30, 2)
    q[4] = mat[500]
    on_card = DeviceInvertedEngine(mat, cuda)
    on_cpu = DeviceInvertedEngine(mat, torch.device("cpu"))
    for name in ("match_counts", "any_shared_rows", "all_shared_rows"):
        assert np.array_equal(getattr(on_card, name)(q),
                              getattr(on_cpu, name)(q)), name
    for rr in (None, slice(0, 1000), slice(333, 777)):
        assert on_card.any_shared_bin_count(rr) == \
            on_cpu.any_shared_bin_count(rr)


# --- the precluster mask in K3 and K2 ----------------------------------------

def _mask(cuda, n, s, seed, rows=None):
    from sketchtpu_torch.dist.knn_kernels import SignMask
    from sketchtpu_torch.inverted.device import pack_signs
    from sketchtpu_torch.synth import derive_signs

    sig = derive_signs(n, s, 5, seed, redraw=0.6)
    sig[7] = np.random.default_rng(seed).integers(0, 1 << 16, s)
    w = pack_signs(sig, cuda)
    r0, r1 = rows if rows is not None else (0, n)
    return SignMask(w[r0:r1], w, s)


@pytest.mark.parametrize("s", [1, 99, 100, 1000])
@pytest.mark.parametrize("comp", [False, True])
@pytest.mark.parametrize(
    "tr,tc,row0,col0,nb_real",
    [(64, 64, 0, 0, 64), (70, 131, 0, 0, 131), (33, 100, 120, 50, 400),
     (45, 160, 10, 40, 157), (20, 200, 0, 100, 165)],
)
def test_masked_knn_keys_kernel_matches_twin(cuda, s, comp, tr, tc, row0,
                                             col0, nb_real):
    from sketchtpu_torch.dist.knn_kernels import SignMask

    w = _kwords(500, KMERS, 16, 6, cuda)[:, 0]
    full = _mask(cuda, 500, s, s + tr)
    sig = SignMask(full.cols[row0 : row0 + tr], full.cols, s)
    c = None
    if comp:
        cv = _comp(500, tr, cuda)
        c = Completeness(cv[row0 : row0 + tr].contiguous(), cv, 0.64, 16)
    for excl in (False, True):
        kw = dict(row0=row0, col0=col0, nb_real=nb_real, exclude_self=excl,
                  comp=c, sig=sig)
        got = knn_keys(w[row0 : row0 + tr], w[col0 : col0 + tc], **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, knn_keys_ref(w[row0 : row0 + tr],
                                             w[col0 : col0 + tc], **kw))


@pytest.mark.parametrize("knn", [1, 50, MAX_KNN])
@pytest.mark.parametrize("s", [1, 100, 1000])
@pytest.mark.parametrize("comp", [False, True])
def test_masked_knn_select_kernel_matches_twin(cuda, knn, s, comp):
    w = _kwords(1500, KMERS, 16, 9, cuda)[:, 1]
    sig = _mask(cuda, 1500, s, knn + s, rows=(200, 330))
    c = None
    if comp:
        cv = _comp(1500, knn, cuda)
        c = Completeness(cv[200:330].contiguous(), cv, 0.64, 16)
    kw = dict(row0=200, exclude_self=True, comp=c, sig=sig)
    got = knn_select(w[200:330], w, knn, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, knn_select_ref(w[200:330], w, knn, col_tile=300,
                                           **kw))


@pytest.mark.parametrize("comp", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_knn_past_max_knn_on_the_card(cuda, comp, masked):
    """knn = MAX_KNN + 1: K3's tile keys merged by torch.topk, the
    selection of the twin (and of the host)."""
    from sketchtpu_torch.dist.knn_torch import select_keys

    w = _kwords(1400, KMERS, 16, 10, cuda)[:, 0]
    c = sig = None
    if comp:
        cv = _comp(1400, 3, cuda)
        c = Completeness(cv[100:300].contiguous(), cv, 0.64, 16)
    if masked:
        sig = _mask(cuda, 1400, 100, 4, rows=(100, 300))
    kw = dict(row0=100, exclude_self=True, comp=c, sig=sig)
    select_before = knn_select.launches
    tiles_before = knn_keys.launches
    got = select_keys(w[100:300], w, MAX_KNN + 1, **kw)
    assert knn_select.launches == select_before
    assert knn_keys.launches > tiles_before
    assert torch.equal(got, knn_select_ref(w[100:300], w, MAX_KNN + 1, **kw))


@pytest.mark.parametrize("s", [1, 100, 1000])
@pytest.mark.parametrize("comp", [False, True])
@pytest.mark.parametrize(
    "tr,tc,row0,col0,nb_real",
    [(64, 64, 0, 0, 64), (70, 131, 0, 0, 131), (33, 100, 120, 50, 400),
     (20, 200, 0, 100, 165)],
)
def test_masked_coreacc_keys_kernel_matches_twin(cuda, s, comp, tr, tc,
                                                 row0, col0, nb_real):
    from sketchtpu_torch.dist.knn_kernels import SignMask

    w = _words(500, 16, 6, cuda)
    full = _mask(cuda, 500, s, s + tc)
    sig = SignMask(full.cols[row0 : row0 + tr], full.cols, s)
    c1 = c2 = None
    if comp:
        c = _comp(500, tr * tc, cuda)
        c1, c2 = c[row0 : row0 + tr].contiguous(), c[col0 : col0 + tc].contiguous()
    kw = dict(row0=row0, col0=col0, nb_real=nb_real, exclude_self=True,
              sig=sig)
    keys, acc = coreacc_keys(w[row0 : row0 + tr], w[col0 : col0 + tc], KMERS,
                             1024, c1, c2, **kw)
    torch.cuda.synchronize()
    want_keys, want_acc = coreacc_keys_ref(w[row0 : row0 + tr],
                                           w[col0 : col0 + tc], KMERS, 1024,
                                           c1, c2, **kw)
    assert torch.equal(keys, want_keys)
    assert torch.equal(acc, want_acc)


@pytest.mark.parametrize("mode", ["k17", "ani", "comp", "singleton",
                                  "bruteforce", "coreacc",
                                  "coreacc_bruteforce"])
def test_precluster_on_card_matches_cpu(cuda, mode):
    from sketchtpu_torch.inverted.index import Inverted
    from sketchtpu_torch.synth import derive_signs

    n, s = 400, 100
    ms = _engine_ms(n, (17, 21, 25), 12)
    sig = derive_signs(n, s, 9, 13, redraw=0.7)
    rng = np.random.default_rng(14)
    for r in (5, 200):
        sig[r] = rng.integers(0, 1 << 16, s)
    inv = Inverted(sign_matrix=sig, sample_names=[f"g{i}" for i in range(n)],
                   kmer_size=17, rc=True, hash_type=HashType("dna"))
    comp = rng.uniform(0.6, 1, n) if "comp" in mode else None
    retain = next((r for r in ("singleton", "bruteforce") if r in mode), None)
    dt = (DistType() if mode.startswith("coreacc")
          else DistType(k_idx=0, k=17.0, ani=mode == "ani"))
    args = (inv, sig.reshape(-1), 10, dt, retain)
    for rr in (None, slice(190, 260)):
        got = DeviceKnnEngine(ms, cuda, row_tile=128, col_tile=300) \
            .precluster_knn(*args, row_range=rr, completeness_vec=comp)
        want = DeviceKnnEngine(ms, torch.device("cpu"), row_tile=128,
                               col_tile=300) \
            .precluster_knn(*args, row_range=rr, completeness_vec=comp)
        # entries past a row's candidates are not printed; their slot
        # order follows torch.topk's ties, which differ between devices
        gi, gv, gm = got.as_arrays()
        wi, wv, wm = want.as_arrays()
        shown = np.ones(gi.shape, bool) if gm is None else gm
        assert (gm is None) == (wm is None)
        assert gm is None or np.array_equal(gm, wm)
        assert np.array_equal(gi[shown], wi[shown])
        assert np.array_equal(gv[shown], wv[shown])


# --- aaHash (csrc/aahash_bin.cu) -------------------------------------------

_AA_LETTERS = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWYacdefghiklmnpqrstvwy",
                            dtype=np.uint8)


def _aa_streams(lens, seed, p_invalid=0.01, run=64):
    """AaStreams of the given lengths with invalid residues (SEQSEP and raw
    bytes), separators on the first, last and middle window start of a
    thread's run, and the final-window quirk's cases."""
    from sketchtpu_torch.ingest.fastx import AaStream

    rng = np.random.default_rng(seed)
    out = []
    for n in lens:
        seq = _AA_LETTERS[rng.integers(0, _AA_LETTERS.size, n)]
        bad = rng.random(n) < p_invalid
        seq = np.where(bad, rng.choice([5, ord("X"), ord("*")], n), seq)
        at = [p for p in (run - 1, run, 2 * run - 1, run + run // 2)
              if p < n and rng.random() < 0.5]
        seq[at] = 5
        out.append(AaStream(seq=seq.astype(np.uint8)))
    letters = bytes(_AA_LETTERS[:40])
    for text in (letters[:13], b"\x05" + letters[:12], letters[:12] + b"*"):
        out.append(AaStream(seq=np.frombuffer(text, np.uint8).copy()))
    return out


def _aa_case(cuda, streams, kmers, level, nbins):
    from sketchtpu_torch.hash.aahash_torch import (
        aahash_bin_multi,
        aahash_bin_multi_ref,
        pack_aa_group,
    )

    codes, starts = pack_aa_group(streams)
    codes_d = torch.from_numpy(codes).to(cuda)
    starts_d = torch.from_numpy(starts).to(cuda)
    before = aahash_bin_multi.launches
    got = aahash_bin_multi(codes_d, kmers, level, starts_d, nbins)
    torch.cuda.synchronize()
    want = aahash_bin_multi_ref(codes_d, kmers, level, starts_d, nbins)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    return got, aahash_bin_multi.launches - before


# (a) run and block edges, a sample shorter than most k; (b) 300 samples
# over many blocks; (c) one long sample, 8192 bins (no shared-memory table)
AA_SHAPES = {
    "edges": ([64 * 256 + 64, 45, 7, 64 * 2 + 1, 64 * 300 - 1, 20_001],
              1000),
    "many": ([int(n) for n in np.random.default_rng(9).integers(
        200, 900, 300)], 1024),
    "long": ([300_001], 8192),
}


@pytest.mark.parametrize("shape", list(AA_SHAPES))
@pytest.mark.parametrize("level", [1, 2, 3])
def test_aahash_kernel_matches_twin(cuda, level, shape):
    lens, nbins = AA_SHAPES[shape]
    streams = _aa_streams(lens, seed=level)
    (mins, reach), launches = _aa_case(cuda, streams, (3, 6, 9, 12, 31, 64),
                                       level, nbins)
    assert launches == 1
    # the final-only sample (second to last) is unreachable at k = 12
    assert reach[3, -2] == 0 and reach[3, -3] == 1 and reach[3, 0] == 1
    # the caller's k order, duplicates included
    (mixed, mreach), _ = _aa_case(cuda, streams, (64, 3, 9, 3), level, nbins)
    assert torch.equal(mixed, mins[[5, 0, 2, 0]])
    assert torch.equal(mreach, reach[[5, 0, 2, 0]])


def test_aahash_kernel_many_waves_and_one_block(cuda, monkeypatch):
    """Runs of 4 starts a tile and no tile loop: a 2.8 M batch launches
    over 2700 blocks (four waves and more at 5 blocks an SM of 132); a
    300-residue batch at the chosen shape is one block."""
    from sketchtpu_torch.hash import aahash_torch

    streams = _aa_streams([1_400_000, 700_000, 699_999, 3], seed=11)
    monkeypatch.setattr(aahash_torch, "run_shape",
                        lambda windows, slots, kmax, nk: (4, 1))
    _aa_case(cuda, streams, (6, 9, 12), 1, 1024)
    monkeypatch.undo()
    _aa_case(cuda, _aa_streams([200, 100], seed=12), (6, 9, 12), 3, 1000)


@pytest.mark.parametrize("run,tiles", [(12, 1), (12, 3), (60, 2)])
def test_aahash_kernel_sample_edges_on_run_and_block_edges(cuda, monkeypatch,
                                                           run, tiles):
    """Samples that start and end on run, tile and block edges (and one
    residue off them), at a fixed run length and tile count."""
    from sketchtpu_torch.hash import aahash_torch

    monkeypatch.setattr(aahash_torch, "run_shape",
                        lambda windows, slots, kmax, nk: (run, tiles))
    tile = 256 * run
    lens = [run, tile, tile - 1, run + 1, tiles * tile, tiles * tile + 1,
            2 * tile - run, 5 * run]
    _aa_case(cuda, _aa_streams(lens, seed=run + tiles, run=run),
             (3, 6, 9, 12), 2, 1024)


def test_aahash_kernel_splits_past_128_k(cuda):
    streams = _aa_streams([5000, 900, 70_000], seed=4)
    _, launches = _aa_case(cuda, streams, list(range(133, 2, -1)), 2, 256)
    assert launches == 2


def test_aahash_kernel_at_its_largest_k(cuda):
    from sketchtpu_torch.hash.aahash_torch import MAX_K_AA_CUDA

    streams = _aa_streams([40_000, 300, 20_000], seed=5, p_invalid=1e-4)
    (_, reach), _ = _aa_case(cuda, streams, (31, 4097, MAX_K_AA_CUDA), 1, 256)
    assert reach[:, 0].tolist() == [1, 1, 1]


def test_aahash_kernel_rejects_k_past_its_limit(cuda):
    from sketchtpu_torch.hash.aahash_torch import MAX_K_AA_CUDA, aahash_bin_multi

    codes = torch.zeros(1000, dtype=torch.uint8, device=cuda)
    starts = torch.zeros(1, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="limit"):
        aahash_bin_multi(codes, (9, MAX_K_AA_CUDA + 1), 1, starts, 64)


@pytest.mark.parametrize("level", [1, 3])
def test_aa_backend_on_card_matches_cpu(cuda, level):
    from sketchtpu_torch.sketchcore.sketch_torch import DeviceAaSketchBackend

    streams = _aa_streams([3000, 200, 64 * 256 + 7, 999], seed=6)[:-3]
    names = [f"s{i}" for i in range(len(streams))]
    got = DeviceAaSketchBackend(cuda).sketch_aa_streams(
        streams, names, [6, 9, 12], 1000, level, True)
    want = DeviceAaSketchBackend(torch.device("cpu")).sketch_aa_streams(
        streams, names, [6, 9, 12], 1000, level, True)
    for a, b in zip(got, want):
        assert (a.name, a.densified, a.seq_length) == (b.name, b.densified,
                                                       b.seq_length)
        assert np.array_equal(a.usigs, b.usigs)


def test_two_ranks_on_the_card(cuda, tmp_path, monkeypatch):
    """Two processes under torchrun's environment share the card (a gloo
    process group): `sketch` merges on rank 0 into the single-process
    database, and `dist -k 17 --knn 5` and core/accessory `--knn 5`
    parts concatenate into the single-process output."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    from sketchtpu_torch.cli import main as cli_main
    from sketchtpu_torch.synth import related_assemblies

    repo = Path(__file__).resolve().parent.parent
    monkeypatch.chdir(tmp_path)
    rfile = related_assemblies(tmp_path / "fa", 12, 200_000, 61)
    runs = {  # name: (argv, output prefix of the single run)
        "db": (["sketch", "-f", str(rfile), "-k", "17,21,25", "-s", "1000"],
               "single"),
        "knn": (["dist", "single", "-k", "17", "--knn", "5"], "knn.txt"),
        "knn_ca": (["dist", "single", "--knn", "5"], "knn_ca.txt"),
    }
    for argv, out in runs.values():
        assert cli_main(argv + ["-o", out, "--quiet"]) == 0
    for name, (argv, out) in runs.items():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "sketchtpu_torch", *argv, "-o",
             f"multi_{out}", "--quiet"], cwd=tmp_path,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            env=dict(os.environ, PYTHONPATH=str(repo), WORLD_SIZE="2",
                     RANK=str(r), LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(port), SKETCHTPU_TORCH_BACKEND="cuda"))
            for r in range(2)]
        try:
            outs = [p.communicate(timeout=300) for p in procs]
        finally:
            for p in procs:
                p.kill()
        assert [p.returncode for p in procs] == [0, 0], outs
        if name == "db":
            for ext in (".skd", ".skm"):
                assert (tmp_path / f"multi_single{ext}").read_bytes() == (
                    tmp_path / f"single{ext}").read_bytes()
        else:
            parts = b"".join((tmp_path / f"multi_{out}.part{r}").read_bytes()
                             for r in range(2))
            want = (tmp_path / out).read_bytes()
            assert want.count(b"\n") == 12 * 5 and parts == want
