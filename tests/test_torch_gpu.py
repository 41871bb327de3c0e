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
    MAX_NK_BY_VALUE,
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
# n < 3 branch; past MAX_NK_BY_VALUE the k table is read from device
# memory; the k-planes are a strided selection (row stride > nk*W)
@pytest.mark.parametrize("s64", [1, 3, 5, 16])
@pytest.mark.parametrize("nk", [1, 2, 3, 7, MAX_NK_BY_VALUE,
                                MAX_NK_BY_VALUE + 1, 300])
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


# --- the in-process multi-device engines (shard/mesh.py) ---------------------

def _device_lists(cuda):
    """slots: two slots of the first card; distinct: every GPU (skips on a
    host with one)."""
    return {"slots": [cuda] * 2,
            "distinct": [torch.device("cuda", i)
                         for i in range(torch.cuda.device_count())]}


def _ms_pair(n, seed):
    ms = _engine_ms(n, (17, 21, 25), seed)
    q = _engine_ms(37, (17, 21, 25), seed + 1)
    for i, sk in enumerate(q.sketch_metadata):
        sk.name = f"q{i}"
    return ms, q


@pytest.mark.parametrize("kind", ["slots", "distinct"])
def test_sharded_engines_equal_one_device(cuda, kind):
    """Each multi-device engine on two slots of the card, or on every GPU,
    gives the one-device engine's result bit for bit (samebits, core/acc
    tiles and text, single-k and core/accessory kNN, precluster, the pair
    count and the queries)."""
    import io

    from sketchtpu_torch.dist.coreacc_torch import DeviceCoreAccEngine
    from sketchtpu_torch.dist.jaccard_torch import DeviceSamebitsEngine
    from sketchtpu_torch.inverted.device import DeviceInvertedEngine
    from sketchtpu_torch.inverted.index import Inverted
    from sketchtpu_torch.shard import mesh
    from sketchtpu_torch.synth import derive_signs

    devs = _device_lists(cuda)[kind]
    if len(devs) < 2:
        pytest.skip("needs two GPUs")
    one = torch.device("cuda", 0)
    n, s = 1500, 100
    ms, q = _ms_pair(n, 71)
    names = [f"g{i}" for i in range(n)]
    qnames = [f"q{i}" for i in range(37)]
    a = ms.bins_matrix(1)
    assert np.array_equal(
        mesh.ShardedSamebitsEngine(ms.sketchsize64, devs).matrix(a[:700], a),
        DeviceSamebitsEngine(ms.sketchsize64, one).matrix(a[:700], a))
    comp = np.random.default_rng(72).uniform(0.6, 1, n)
    for cv in (None, comp):
        sh = mesh.ShardedCoreAccEngine(ms, devs, tile=512,
                                       completeness_vec=cv)
        single = DeviceCoreAccEngine(ms, one, tile=512, completeness_vec=cv)
        assert np.array_equal(sh.tile_dists(slice(3, 900), slice(0, n)),
                              single.tile_dists(slice(3, 900), slice(0, n)))
        for call in (lambda e, o: e.stream_self_dense(o, names),
                     lambda e, o: e.stream_cross_dense(
                         o, names, qnames, q, rcomp=cv,
                         qcomp=cv[:37] if cv is not None else None)):
            texts = []
            for eng in (sh, single):
                out = io.StringIO()
                call(eng, out)
                texts.append(out.getvalue())
            assert texts[0] and texts[0] == texts[1]
    dt = DistType(k_idx=0, k=17.0)
    sh = mesh.ShardedKnnEngine(ms, devs)
    single = DeviceKnnEngine(ms, one)

    def same(x, y):
        for u, v in zip(x.as_arrays(), y.as_arrays()):
            assert (u is None) == (v is None)
            assert u is None or np.array_equal(u, v)

    for cv in (None, comp):
        same(sh.self_knn(10, dt, completeness_vec=cv),
             single.self_knn(10, dt, completeness_vec=cv))
        same(sh.self_knn_coreacc(10, completeness_vec=cv),
             single.self_knn_coreacc(10, completeness_vec=cv))
    same(sh.self_knn(1100, dt, row_range=slice(5, 260)),
         single.self_knn(1100, dt, row_range=slice(5, 260)))
    same(sh.cross_knn(q, 10, dt), single.cross_knn(q, 10, dt))
    same(sh.cross_knn_coreacc(q, 10), single.cross_knn_coreacc(q, 10))
    sig = derive_signs(n, s, 9, 73, redraw=0.7)
    sig[[5, 700]] = np.random.default_rng(74).integers(0, 1 << 16, (2, s))
    inv = Inverted(sign_matrix=sig, sample_names=names, kmer_size=17,
                   rc=True, hash_type=HashType("dna"))
    for retain in ("singleton", "bruteforce"):
        for mode in (dt, DistType()):
            args = (inv, sig.reshape(-1), 10, mode, retain)
            same(sh.precluster_knn(*args), single.precluster_knn(*args))
    shi = mesh.ShardedInvertedEngine(sig, devs)
    singlei = DeviceInvertedEngine(sig, one)
    assert shi.any_shared_bin_count() == singlei.any_shared_bin_count() > 0
    queries = sig[[1, 2, 3, 400, 1499]]
    for fn in ("match_counts", "any_shared_rows", "all_shared_rows"):
        assert np.array_equal(getattr(shi, fn)(queries),
                              getattr(singlei, fn)(queries))


@pytest.mark.parametrize("kind", ["slots", "distinct"])
def test_round_robin_sketching_equals_one_device(cuda, kind, monkeypatch):
    """Assembly batches, read chunks and AA batches sent round-robin over
    the slots or the GPUs give one device's sketches."""
    from sketchtpu_torch.sketchcore import sketch_torch
    from sketchtpu_torch.sketchcore.sketch_torch import (
        DeviceAaSketchBackend,
        DeviceSketchBackend,
    )

    devs = _device_lists(cuda)[kind]
    if len(devs) < 2:
        pytest.skip("needs two GPUs")
    monkeypatch.setattr(sketch_torch, "_MAX_GROUP", 3)  # several batches
    monkeypatch.setattr(sketch_torch, "_chunk_starts", lambda nk: 7_777)
    streams = random_streams([40_000, 900, 70_000, 5_000, 12_000], seed=8)
    streams += [_reads_stream(n, 30 + n) for n in (30_000, 151, 80_000)]
    names = [f"s{i}" for i in range(len(streams))]
    want = DeviceSketchBackend(cuda).sketch_dna_streams(
        streams, names, [17, 21, 25], 1024, True, 1)
    got = DeviceSketchBackend(devs).sketch_dna_streams(
        streams, names, [17, 21, 25], 1024, True, 1)
    for g, w in zip(got, want):
        assert np.array_equal(g.usigs, w.usigs)
        assert g.seq_length == w.seq_length
    aa = _aa_streams([3000, 5000, 4000, 3500], seed=6)[:-3]
    aa_names = [f"p{i}" for i in range(len(aa))]
    want = DeviceAaSketchBackend(cuda).sketch_aa_streams(
        aa, aa_names, [6, 9, 12], 1000, 1, True)
    got = DeviceAaSketchBackend(devs).sketch_aa_streams(
        aa, aa_names, [6, 9, 12], 1000, 1, True)
    for g, w in zip(got, want):
        assert np.array_equal(g.usigs, w.usigs)


def test_kernels_launch_on_their_tensors_device(cuda):
    """With the first GPU current, K1, K2 and K3 on tensors of the second
    launch there (into its stream, with its shared-memory attributes) and
    equal their twins on that GPU."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs")
    other = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    w = _words(300, 16, 81, other)
    a, b = w[:100, 1], w[:, 1]
    got = samebits(a, b, out_dtype=torch.int16, tri=True, row0=7)
    assert got.device == other
    assert torch.equal(got, samebits_ref(a, b, out_dtype=torch.int16,
                                         tri=True, row0=7))
    got = coreacc(w[:100], w, KMERS, 1024)
    torch.cuda.synchronize(other)
    for g, r in zip(got, coreacc_ref(w[:100], w, KMERS, 1024)):
        assert g.device == other and torch.equal(g, r)
    got = knn_select(a, b, 20, exclude_self=True)
    assert got.device == other
    assert torch.equal(got, knn_select_ref(a, b, 20, exclude_self=True))
    assert torch.cuda.current_device() == 0


# --- sign_prefilter.cu: the reads path's sign prefilter -----------------------

def _prefilter_case(cuda, row, nbins, mc, **plan):
    """The kernels' flags and the compacted survivors of one row of signs
    on the card, bit for bit against the twins there, in one counted
    launch (none for an empty row)."""
    from sketchtpu_torch.sketchcore import sign_prefilter as sp

    before = sp.sign_prefilter_flags.launches
    got = sp.sign_prefilter_flags(row, nbins, mc, **plan)
    torch.cuda.synchronize()
    assert sp.sign_prefilter_flags.launches == before + (row.numel() > 0)
    assert torch.equal(got, sp.sign_prefilter_flags_ref(row, nbins, mc))
    kept = sp.prefilter_signs(row, nbins, mc)
    assert torch.equal(kept, sp.prefilter_signs_ref(row, nbins, mc))
    return kept


def _collisions(nbins, m, distinct, seed):
    """m signs from `distinct` values of the bins' range, 10 % invalid and
    1 % past the last bin."""
    rng = np.random.default_rng(seed)
    top = bin_size(nbins) * nbins
    row = rng.choice(rng.integers(0, top, distinct), m)
    row[rng.random(m) < 0.1] = -1
    row[rng.random(m) < 0.01] = top + 5
    return row


@pytest.mark.parametrize("nbins,m,distinct", [
    (1, 100, 5), (16, 5000, 400), (64, 100_000, 400), (100, 70_001, 50),
    (1024, 300_001, 100_000), (1024, 2049, 2000),
    (40_000, 1_000_003, 300_000)])
@pytest.mark.parametrize("mc", [1, 2, 3, 5])
def test_sign_prefilter_kernel_matches_twin(cuda, nbins, m, distinct, mc):
    """Heavy collisions (runs across threads, buckets and bins, a bin over
    many buckets at 1 and 16 bins, empty buckets, many bins a bucket at
    40,000), invalid windows, signs past the last bin."""
    row = _collisions(nbins, m, distinct, m + mc)
    kept = _prefilter_case(cuda, torch.from_numpy(row).to(cuda), nbins, mc)
    assert kept.numel() <= (row >= 0).sum()


@pytest.mark.parametrize("bits,cap", [(0, 1), (4, 64), (9, 300), (16, 2000)])
@pytest.mark.parametrize("mc", [2, 5])
def test_sign_prefilter_past_the_capacity(cuda, bits, cap, mc):
    """Buckets past `cap` windows take the path in device memory (radix
    passes, two streaming scans) beside buckets ordered on chip, with
    carries between both kinds; one and two partition passes."""
    row = _collisions(64, 200_000, 20_000, bits + cap + mc)
    _prefilter_case(cuda, torch.from_numpy(row).to(cuda), 64, mc, bits=bits,
                    cap=cap)


def test_sign_prefilter_constants_match_the_library(cuda):
    """The wrapper sizes its workspace and checks its plan with the
    kernels' own constants."""
    from sketchtpu_torch.sketchcore import sign_prefilter as sp

    assert [_build.query(cuda, "stpu_sign_prefilter_limits", i)
            for i in range(5)] == [sp.MAX_BITS, sp.CAP, sp.TILE, sp.DIGITS,
                                   sp.SCAN_SUMS]


def test_sign_prefilter_kernel_on_empty_and_invalid_rows(cuda):
    for row in (torch.zeros(0, dtype=torch.int64),
                torch.full((5000,), -1, dtype=torch.int64)):
        assert _prefilter_case(cuda, row.to(cuda), 1024, 3).numel() == 0


def test_sign_prefilter_one_sign_repeated(cuda):
    """One sign 2^22 times: one bucket far past the capacity, already in
    order (no radix pass); its first min_count occurrences are kept."""
    row = torch.full((1 << 22,), int(bin_size(64)) * 7 // 3,
                     dtype=torch.int64, device=cuda)
    kept = _prefilter_case(cuda, row, 64, 5)
    assert kept.numel() == 1 << 22  # no earlier run in its bin: all kept


def test_sign_prefilter_every_window_in_one_bin(cuda):
    """4 M windows in bin 9 of 64: the bin over 128 buckets of 2^13."""
    rng = np.random.default_rng(9)
    bs = int(bin_size(64))
    values = rng.integers(9 * bs, 10 * bs, 1 << 20)
    row = torch.from_numpy(rng.choice(values, 1 << 22)).to(cuda)
    for mc in (2, 5):
        kept = _prefilter_case(cuda, row, 64, mc)
        assert 0 < kept.numel() < row.numel()


def _genome_reads(genome_len, n_reads, seed):
    """A reads stream: n_reads 150 bp reads of a random genome, half
    reverse-complemented, a break at every read end."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len).astype(np.uint8)
    starts = rng.integers(0, genome.size - 150, n_reads)
    reads = genome[starts[:, None] + np.arange(150)]
    flip = rng.random(n_reads) < 0.5
    reads[flip] = 3 - reads[flip][:, ::-1]
    return DnaStream(codes=reads.reshape(-1),
                     breaks=np.arange(1, n_reads + 1, dtype=np.int64) * 150,
                     reads=True)


@pytest.mark.parametrize("windows", [1 << 24, 1 << 26])
def test_sign_prefilter_kernel_at_a_segment(cuda, windows):
    """Reads of a 2 Mb genome at k = 17, --min-count 5, 1024 bins: a
    2^24-window segment (the JAX package's) and a whole 2^26-window row
    (the longest segment of the reads path)."""
    from sketchtpu_torch.hash.nthash_torch import nthash_signs

    stream = _genome_reads(2_000_000, (windows + 16) // 150 + 1, 24)
    seq = torch.from_numpy(pack_group([stream])[0]).to(cuda)
    row = nthash_signs(seq, [17], True, windows)[0]
    del seq
    assert row.numel() == windows
    kept = _prefilter_case(cuda, row, 1024, 5)
    assert 0 < kept.numel() < (row >= 0).sum() // 2


@pytest.mark.parametrize("segment", [None, 20_000])
def test_reads_backend_prefilter_on_card_matches_cpu(cuda, monkeypatch,
                                                     segment):
    """The reads path with the prefilter on: the card's sketches equal the
    CPU twins' and the prefilter off's, in one segment a stream and in
    segments of 20,000 window starts, on one device and round-robin over
    two slots of the card."""
    from sketchtpu_torch.sketchcore import sign_prefilter as sp
    from sketchtpu_torch.sketchcore import sketch_torch
    from sketchtpu_torch.sketchcore.sketch_torch import DeviceSketchBackend

    streams = [_genome_reads(g, n, g) for g, n in ((5000, 400),
                                                   (20_000, 800),
                                                   (2000, 400))]
    names = list("abc")
    want = DeviceSketchBackend(torch.device("cpu")).sketch_dna_streams(
        streams, names, [17, 21, 25], 1024, True, 3)
    if segment is not None:
        monkeypatch.setattr(sketch_torch, "_segment_starts",
                            lambda nk: segment)
    monkeypatch.setenv("SKETCHTPU_FASTQ_PREFILTER", "1")
    for devs in (cuda, [cuda, cuda]):
        before = sp.sign_prefilter_flags.launches
        got = DeviceSketchBackend(devs).sketch_dna_streams(
            streams, names, [17, 21, 25], 1024, True, 3)
        # one launch a (segment, k) row
        rows = 3 * sum(len(sketch_torch.read_chunks(
            s.seq_len, [17, 21, 25], sketch_torch._segment_starts(3)))
            for s in streams)
        assert sp.sign_prefilter_flags.launches - before == rows
        for g, w in zip(got, want):
            assert np.array_equal(g.usigs, w.usigs)
            assert g.seq_length == w.seq_length


# --- the words axis: K4's distance epilogue, K2's chain, the grids --------

def _ulps(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest distance in units in the last place between non-negative
    f32 values."""
    return int((got.view(torch.int32).long()
                - want.view(torch.int32).long()).abs().max())


# s64 = 16 (the main path), 625 (-s 40000) and 1600 (102,400 bins, the
# axis's size); ragged tiles; rows read in place from strided k-planes
@pytest.mark.parametrize("s64,na,nb", [(16, 70, 130), (625, 65, 33),
                                       (1600, 1, 129), (1600, 97, 63)])
@pytest.mark.parametrize("with_base", [False, True])
def test_samebits_dist_kernel_matches_twin(cuda, s64, na, nb, with_base):
    """samebits_dist (K4's f32 epilogue) against its twin; with_base, the
    words split's finish pass (samebits_finish over two K4 partials, a
    third of the chunks and the rest) against its twin and bit-equal to
    the unsplit samebits_dist, in Jaccard and ANI."""
    from sketchtpu_torch.dist.jaccard_torch import jaccard_dist_block
    from sketchtpu_torch.dist.samebits_kernels import (
        samebits_dist,
        samebits_dist_ref,
        samebits_finish,
        samebits_finish_ref,
    )

    w = _words(max(na, nb), s64, 20 + s64, cuda)
    a, b = w[:na, 1], w[:nb, 1]  # samples i and j related when i = j mod 3
    cut = s64 // 3 * 14
    parts = [samebits_full(a[:, :cut], b[:, :cut]),
             samebits_full(a[:, cut:], b[:, cut:])]
    for ani in (False, True):
        if with_base:
            got = samebits_finish(parts, s64, k=21.0, ani=ani)
            torch.cuda.synchronize()
            want = samebits_finish_ref(parts, s64, k=21.0, ani=ani)
        else:
            got = samebits_dist(a, b, s64, k=21.0, ani=ani)
            torch.cuda.synchronize()
            want = samebits_dist_ref(a, b, s64, k=21.0, ani=ani)
        if ani:
            assert _ulps(got, want) <= 2  # logf against torch's log
        else:
            assert torch.equal(got, want)
        assert torch.equal(got, jaccard_dist_block(a, b, s64, k=21.0,
                                                   ani=ani))
        assert ((got > 0) & (got < 1)).any()
    same = jaccard_dist_block(a[:1], a[:1], s64, k=21.0, ani=True)
    assert float(same) == 1.0
    far = jaccard_dist_block(a[:1], ~a[:1], s64, k=21.0, ani=True)
    assert float(far) == 0.0


# n = 1, a block's worth, ragged; 1 to 8 partials
@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, 70 * 130 + 3])
@pytest.mark.parametrize("n_parts", [1, 2, 3, 8])
def test_samebits_finish_count_mode_matches_twin(cuda, n, n_parts):
    from sketchtpu_torch.dist.samebits_kernels import (
        samebits_finish,
        samebits_finish_ref,
    )

    g = torch.Generator(device=cuda).manual_seed(n * 10 + n_parts)
    parts = [torch.randint(0, 1 << 20, (n,), generator=g, device=cuda,
                           dtype=torch.int32) for _ in range(n_parts)]
    got = samebits_finish(parts)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32
    assert torch.equal(got, samebits_finish_ref(parts))
    assert torch.equal(got, torch.stack(parts).sum(0, dtype=torch.int32))


@pytest.mark.parametrize("s64,na,nb,nk", [(1, 1, 1, 1), (16, 70, 130, 7),
                                          (625, 65, 33, 3), (16, 64, 64, 1),
                                          (1600, 97, 63, 2)])
def test_samebits_stack_kernel_equals_nk_launches(cuda, s64, na, nb, nk):
    """K4 at every k-plane in one launch: bit-equal to nk samebits_full
    launches and the twin, on whole words and on a range of chunks read in
    place (plane and row strides of the full tensor)."""
    from sketchtpu_torch.dist.samebits_kernels import (
        samebits_stack,
        samebits_stack_ref,
    )

    kmers = tuple(range(15, 15 + 2 * nk, 2))
    w = _kwords(max(na, nb), kmers, s64, 60 + s64, cuda)
    cut = max(1, s64 // 2) * 14
    for r in (slice(None), slice(0, cut), slice(cut, None)):
        a, b = w[:na, :, r], w[:nb, :, r]
        if a.shape[-1] == 0:
            continue
        got = samebits_stack(a, b)
        torch.cuda.synchronize()
        want = torch.stack([samebits_full(a[:, ki], b[:, ki])
                            for ki in range(nk)])
        assert got.shape == (nk, na, nb) and torch.equal(got, want)
        assert torch.equal(got, samebits_stack_ref(a, b))


@pytest.mark.parametrize("nk", [2, 3, 4, 5, 6, 7])
@pytest.mark.parametrize("with_comp", [False, True])
@pytest.mark.parametrize("n_slabs", [1, 2, 4])
def test_coreacc_chain_kernel_equals_k2(cuda, nk, with_comp, n_slabs):
    """K2's chain over the partial samebits slabs of n_slabs word ranges
    (one samebits_stack launch each, taken as they stand) gives K2's
    (core, acc) bit for bit, and its twin's."""
    from sketchtpu_torch.dist.coreacc_kernels import (
        coreacc_chain,
        coreacc_chain_ref,
    )
    from sketchtpu_torch.dist.samebits_kernels import samebits_stack
    from sketchtpu_torch.shard.mesh import word_ranges

    kmers = tuple(range(15, 15 + 2 * nk, 2))
    w = _kwords(230, kmers, 16, 40 + nk, cuda)
    a, b = w[:97], w[60:230]
    c1 = c2 = None
    if with_comp:
        c = _comp(230, nk, cuda)
        c1, c2 = c[:97].contiguous(), c[60:230].contiguous()
    want = coreacc(a, b, kmers, 1024, c1, c2)
    slabs = [samebits_stack(a[..., r], b[..., r])
             for r in word_ranges(16, n_slabs)]
    got = coreacc_chain(slabs, kmers, 1024, 16, c1, c2)
    torch.cuda.synchronize()
    for g, x, t in zip(got, want, coreacc_chain_ref(slabs, kmers, 1024, 16,
                                                    c1, c2)):
        assert torch.equal(g, x) and torch.equal(g, t)
    if nk < 3:  # fewer than three k: the fit's n < 3 branch
        assert (got[0] == 1).all() and (got[1] == 1).all()
    else:
        assert ((want[0] > 0) & (want[0] < 1)).sum() > 0


def test_copy_pitched_moves_a_slots_share(cuda):
    """A words slot's share (a range of each sample's words at every k,
    and of one k-plane) by one 2-D memcpy: equal to the view, on the card
    and, where a host has two GPUs, onto the other."""
    from sketchtpu_torch._transfer import copy_pitched

    w = _kwords(200, (17, 21, 25), 16, 84, cuda)
    targets = [torch.device("cuda", i)
               for i in range(min(2, torch.cuda.device_count()))]
    for view in (w[3:150][..., 70:140], w[:, 1][:, 14:42], w[5:9, 2]):
        for dev in targets:
            got = copy_pitched(view, dev)
            torch.cuda.synchronize(dev)
            assert got.is_contiguous() and got.device == dev
            assert torch.equal(got.to(cuda), view)


@pytest.mark.parametrize("kind", ["slots", "distinct"])
@pytest.mark.parametrize("rows,words", [(1, 2), (2, 2), (1, 4)])
def test_words_lead_runs_its_own_partial_first(cuda, kind, rows, words):
    """On slots of the card, or with slot i on GPU i % count: each slot's
    partial runs on a stream of its own; the first span on a lead's stream
    is its own partial, no other slot's work is on it, and its finish
    begins after every partial of its row block has ended
    (mesh.timeline)."""
    from sketchtpu_torch.shard import mesh

    n = torch.cuda.device_count()
    if kind == "distinct" and n < 2:
        pytest.skip("needs two GPUs")
    devs = [torch.device("cuda", i % n if kind == "distinct" else 0)
            for i in range(rows * words)]
    t = _kwords(300, (17, 21, 25), 16, 83, cuda)
    grid = mesh.make_mesh(rows, words, devices=devs)
    with mesh.timeline() as tl:
        got = mesh.sharded_coreacc_step(t, t[:150], 16, grid, (17, 21, 25),
                                        1024)
    spans = tl.read()
    want = torch.stack(coreacc(t, t[:150], (17, 21, 25), 1024), dim=-1)
    assert torch.equal(got.to(cuda), want)
    partials = [sp for sp in spans if sp["what"] == "partial"]
    assert len(partials) == rows * words
    assert len({(sp["device"], sp["stream"]) for sp in partials}) \
        == rows * words
    for r in range(rows):
        lead = next(sp for sp in partials if sp["slot"] == f"r{r}w0")
        on_it = [sp for sp in spans if sp["stream"] == lead["stream"]
                 and sp["device"] == lead["device"]]
        assert on_it[0]["what"] == "partial" and on_it[0]["slot"] == f"r{r}w0"
        assert {sp["slot"] for sp in on_it} == {f"r{r}w0"}
        finish = next(sp for sp in on_it if sp["what"] == "finish")
        block = [sp for sp in partials if sp["slot"].startswith(f"r{r}w")]
        assert len(block) == words
        # times of one device compare exactly; across GPUs, to the origins'
        assert all(finish["start_ms"] >= sp["end_ms"] - (
            0 if sp["device"] == lead["device"] else 0.5) for sp in block)


def _written_late(stream, *xs):
    """Copies of xs (tensors of one GPU) whose values a copy on `stream`
    (of that GPU) writes only after the stream has spun for ~0.1 s, with
    no sync after: a reader not ordered after the writer reads zeros (or
    what a reused block held)."""
    dev = xs[0].device
    outs = [torch.zeros_like(x) for x in xs]
    torch.cuda.synchronize(dev)
    with torch.cuda.device(dev), torch.cuda.stream(stream):
        torch.cuda._sleep(1 << 28)
        for o, x in zip(outs, xs):
            o.copy_(x)
    return outs


@pytest.mark.parametrize("grid_of", ["rows_distinct", "words_distinct",
                                     "rows_outside", "words_outside"])
def test_words_setup_copies_wait_for_the_operands_writer(cuda, grid_of):
    """The row operand and c1 written on a stream of GPU 0 (the caller's
    current stream there) just before a step, with no sync; the column
    operand and c2 ready on GPU 1. On a rows-only grid of distinct GPUs,
    a words grid of distinct GPUs, and grids that leave GPU 0 out, every
    step's result equals the unsplit kernels' on the written values. The
    completeness values are strided views (a column of a (n, 2) tensor),
    which a slot on another GPU first gathers on their GPU."""
    from sketchtpu_torch.dist.jaccard_torch import jaccard_dist_block
    from sketchtpu_torch.shard import mesh

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs")
    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    grid = {"rows_distinct": lambda: mesh.as_mesh([d1, d0]),
            "words_distinct": lambda: mesh.make_mesh(1, 2, [d1, d0]),
            "rows_outside": lambda: mesh.as_mesh([d1]),
            "words_outside": lambda: mesh.make_mesh(1, 2, [d1, d1])}[grid_of]()
    kmers = (17, 21, 25)
    steps = {
        "samebits": lambda a, b, c1, c2: mesh.sharded_samebits(
            a[:, 1], b[:, 1], 16, grid),
        "dist": lambda a, b, c1, c2: mesh.sharded_dist_step(
            a[:, 0], b[:, 0], 16, grid, 17.0),
        "coreacc": lambda a, b, c1, c2: mesh.sharded_coreacc_step(
            a, b, 16, grid, kmers, 1024, c1=c1, c2=c2),
    }
    t = _kwords(300, kmers, 16, 86, d0)
    comp = _comp(300, 87, d0)
    pair = torch.stack([comp, 1 - comp], dim=1)
    b, b_pair = t[:150].to(d1), pair[:150].to(d1)
    want = {"samebits": samebits_full(t[:, 1], t[:150, 1]),
            "dist": jaccard_dist_block(t[:, 0], t[:150, 0], 16, k=17.0),
            "coreacc": torch.stack(coreacc(t, t[:150], kmers, 1024, comp,
                                           comp[:150].contiguous()), dim=-1)}
    # built, and the allocator's blocks hold other values than the step's
    other, other_pair = _kwords(300, kmers, 16, 88, d0), 1 - pair
    for step in steps.values():
        step(other, b, other_pair[:, 0], b_pair[:, 0])
    torch.cuda.synchronize(d0)
    torch.cuda.synchronize(d1)
    writer = torch.cuda.Stream(device=d0)
    for name, step in steps.items():
        late_t, late_pair = _written_late(writer, t, pair)
        with torch.cuda.stream(writer):
            got = step(late_t, b, late_pair[:, 0], b_pair[:, 0])
        torch.cuda.synchronize(got.device)
        assert torch.equal(got.to(d0), want[name]), name


@pytest.mark.parametrize("kind", ["slots", "distinct"])
def test_words_grids_equal_unsplit(cuda, kind):
    """The words grids (1 x 2, 2 x 2, 1 x 4) on slots of the card, or on
    every GPU: samebits, distances, core/acc steps and the dense engine
    bit-equal to the unsplit kernels and the one-device engine."""
    import io

    from sketchtpu_torch.dist.coreacc_torch import DeviceCoreAccEngine
    from sketchtpu_torch.dist.jaccard_torch import jaccard_dist_block
    from sketchtpu_torch.shard import mesh

    if kind == "slots":
        devs = [cuda] * 4
    else:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
        if len(devs) < 2:
            pytest.skip("needs two GPUs")
    ms, _ = _ms_pair(300, 81)
    n, names = 300, [f"g{i}" for i in range(300)]
    t = torch.from_numpy(
        ms.sketch_bins.reshape(n, 3, -1).view(np.int64)).to(cuda)
    comp = _comp(n, 82, cuda)
    grids = [(r, len(devs) // r) for r in (1, 2) if len(devs) // r >= 2]
    if kind == "slots":
        grids = [(1, 2), (2, 2), (1, 4)]
    for rows, words in grids:
        grid = mesh.make_mesh(rows, words, devices=devs)
        assert torch.equal(mesh.sharded_samebits(t[:, 1], t[:150, 1], 16,
                                                 grid).to(cuda),
                           samebits_full(t[:, 1], t[:150, 1]))
        for ani in (False, True):
            assert torch.equal(
                mesh.sharded_dist_step(t[:, 0], t[:150, 0], 16, grid, 17.0,
                                       ani).to(cuda),
                jaccard_dist_block(t[:, 0], t[:150, 0], 16, k=17.0, ani=ani))
        for c in (None, comp):
            got = mesh.sharded_coreacc_step(
                t, t[:150], 16, grid, (17, 21, 25), 1024,
                c1=c, c2=c[:150] if c is not None else None)
            core, acc = coreacc(t, t[:150], (17, 21, 25), 1024, c,
                                c[:150].contiguous() if c is not None
                                else None)
            assert torch.equal(got.to(cuda),
                               torch.stack([core, acc], dim=-1))
            cv = c.cpu().numpy() if c is not None else None
            sh = mesh.ShardedCoreAccEngine(ms, grid, tile=128,
                                           completeness_vec=cv)
            one = DeviceCoreAccEngine(ms, cuda, tile=128,
                                      completeness_vec=cv)
            assert np.array_equal(sh.tile_dists(slice(7, 290), slice(0, n)),
                                  one.tile_dists(slice(7, 290), slice(0, n)))
            texts = []
            for eng in (sh, one):
                out = io.StringIO()
                eng.stream_self_dense(out, names)
                texts.append(out.getvalue())
            assert texts[0] and texts[0] == texts[1]


@pytest.mark.parametrize("nk", [MAX_NK_BY_VALUE, MAX_NK_BY_VALUE + 1, 300])
def test_coreacc_modes_and_chain_around_the_by_value_table(cuda, nk):
    """K2's plain, key and masked key modes and coreacc_chain at nk k
    values (k = 15, 16, ...) on either side of the by-value table's bound
    (past it the table is read from device memory and the included-k
    count is 16 bits): bit-equal to their twins, with and without
    completeness, where close pairs include every k in the fit."""
    from sketchtpu_torch.dist.coreacc_kernels import (
        coreacc_chain,
        coreacc_chain_ref,
    )
    from sketchtpu_torch.dist.knn_kernels import SignMask
    from sketchtpu_torch.dist.samebits_kernels import samebits_stack
    from sketchtpu_torch.shard.mesh import word_ranges

    kmers = tuple(range(15, 15 + nk))
    w = _kwords(200, kmers, 4, 90 + nk, cuda)
    a, b = w[:70], w[30:200]
    comp = _comp(200, nk, cuda)
    full = _mask(cuda, 200, 100, nk)
    for c1, c2 in ((None, None),
                   (comp[:70].contiguous(), comp[30:200].contiguous())):
        got = coreacc(a, b, kmers, 256, c1, c2)
        want = coreacc_ref(a, b, kmers, 256, c1, c2)
        for g, x in zip(got, want):
            assert torch.equal(g, x)
        assert ((want[0] > 0) & (want[0] < 1)).sum() > 0
        kw = dict(row0=0, col0=30, nb_real=190, exclude_self=True)
        for sig in (None, SignMask(full.cols[:70], full.cols, 100)):
            keys, acc = coreacc_keys(a, b, kmers, 256, c1, c2, sig=sig, **kw)
            want_k, want_a = coreacc_keys_ref(a, b, kmers, 256, c1, c2,
                                              sig=sig, **kw)
            assert torch.equal(keys, want_k) and torch.equal(acc, want_a)
        slabs = [samebits_stack(a[..., r], b[..., r])
                 for r in word_ranges(4, 2)]
        chain = coreacc_chain(slabs, kmers, 256, 4, c1, c2)
        twin = coreacc_chain_ref(slabs, kmers, 256, 4, c1, c2)
        for g, x, t in zip(chain, got, twin):
            assert torch.equal(g, x) and torch.equal(g, t)
    torch.cuda.synchronize()


@pytest.mark.parametrize("rows", [1, 2])
def test_words_grid_of_16_slots_on_the_card(cuda, rows):
    """rows x 16 grids of slots of the card, past MAX_WORDS_SLOTS (each
    lead folds its partials in two groups of 8 before its finish):
    samebits, distances, core/acc steps and the two engines' words grids
    bit-equal to the unsplit kernels and the one-device engine."""
    from sketchtpu_torch.dist.coreacc_torch import DeviceCoreAccEngine
    from sketchtpu_torch.dist.jaccard_torch import jaccard_dist_block
    from sketchtpu_torch.shard import mesh

    ms, _ = _ms_pair(300, 92)
    t = torch.from_numpy(
        ms.sketch_bins.reshape(300, 3, -1).view(np.int64)).to(cuda)
    comp = _comp(300, 93, cuda)
    grid = mesh.make_mesh(rows, 16, devices=[cuda] * (16 * rows))
    host = ms.sketch_bins.reshape(300, 3, -1)[:, 1]
    assert np.array_equal(
        mesh.ShardedSamebitsEngine(16, grid).matrix(host, host[:150]),
        samebits_full(t[:, 1], t[:150, 1]).cpu().numpy())
    for ani in (False, True):
        assert torch.equal(
            mesh.sharded_dist_step(t[:, 0], t[:150, 0], 16, grid, 17.0, ani),
            jaccard_dist_block(t[:, 0], t[:150, 0], 16, k=17.0, ani=ani))
    for c in (None, comp):
        c2 = c[:150].contiguous() if c is not None else None
        got = mesh.sharded_coreacc_step(t, t[:150], 16, grid, (17, 21, 25),
                                        1024, c1=c, c2=c2)
        want = coreacc(t, t[:150], (17, 21, 25), 1024, c, c2)
        assert torch.equal(got, torch.stack(want, dim=-1))
        cv = c.cpu().numpy() if c is not None else None
        sh = mesh.ShardedCoreAccEngine(ms, grid, tile=128,
                                       completeness_vec=cv)
        one = DeviceCoreAccEngine(ms, cuda, tile=128, completeness_vec=cv)
        assert np.array_equal(sh.tile_dists(slice(7, 290), slice(0, 300)),
                              one.tile_dists(slice(7, 290), slice(0, 300)))


def test_words_setup_copy_waits_for_a_strided_operands_gather(cuda):
    """A strided c1 (a column of an (n, 2) tensor) is the only operand on
    GPU 1, written there by the caller's stream after a ~0.1 s spin with
    no sync; a, b and c2 are ready on GPU 0, and the grid's slots are on
    GPU 0 (and GPU 2 where there is one). The slot first gathers c1 on GPU
    1; its copy to GPU 0 must wait for that gather: every core/acc step
    equals the one with the contiguous c1, bit for bit."""
    from sketchtpu_torch.shard import mesh

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two GPUs")
    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    kmers = (17, 21, 25)
    t = _kwords(300, kmers, 16, 94, d0)
    comp = _comp(300, 95, d0)
    pair = torch.stack([comp, 1 - comp], dim=1).to(d1)
    c2 = comp[:150].contiguous()
    want = torch.stack(coreacc(t, t[:150], kmers, 1024, comp, c2), dim=-1)
    grids = [mesh.as_mesh([d0]), mesh.make_mesh(1, 2, [d0, d0]),
             mesh.make_mesh(2, 1, [d0, d0])]
    if n > 2:
        grids.append(mesh.make_mesh(1, 2, [d0, torch.device("cuda", 2)]))
    # built, and the allocator's blocks hold other values than the step's
    for grid in grids:
        mesh.sharded_coreacc_step(t, t[:150], 16, grid, kmers, 1024,
                                  c1=(1 - pair)[:, 0], c2=c2)
    for i in range(n):
        torch.cuda.synchronize(i)
    writer = torch.cuda.Stream(device=d1)
    for grid in grids:
        (late,) = _written_late(writer, pair)
        assert late[:, 0].stride() == (2,)
        with torch.cuda.stream(writer):
            got = mesh.sharded_coreacc_step(t, t[:150], 16, grid, kmers,
                                            1024, c1=late[:, 0], c2=c2)
        torch.cuda.synchronize(got.device)
        assert torch.equal(got.to(d0), want), grid
        torch.cuda.synchronize(d1)
