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

from sketchtpu_torch.dist.coreacc_kernels import coreacc, coreacc_ref
from sketchtpu_torch.dist.samebits_kernels import samebits, samebits_ref
from sketchtpu_torch.hash.nthash_torch import (
    nthash_bin,
    nthash_bin_ref,
    pack_group,
    tap_tables,
)
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


@pytest.mark.parametrize("na,nb", [(1, 1), (33, 65), (100, 257)])
@pytest.mark.parametrize("with_comp", [False, True])
def test_coreacc_kernel_matches_twin(cuda, na, nb, with_comp):
    w = _words(na + nb, 16, 3, cuda)
    a, b = w[:na], w[na:]
    c1 = c2 = None
    if with_comp:
        c = torch.rand(na + nb, device=cuda) * 0.4 + 0.6
        c1, c2 = c[:na].contiguous(), c[na:].contiguous()
    got = coreacc(a, b, KMERS, 1024, c1, c2)
    want = coreacc_ref(a, b, KMERS, 1024, c1, c2)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=0)


@pytest.mark.parametrize("row0", [0, 20, 95])
def test_coreacc_tri_matches_twin_above_diagonal(cuda, row0):
    w = _words(160, 16, 4, cuda)
    a = w[row0 : row0 + 40]
    got = coreacc(a, w, KMERS, 1024, tri=True, row0=row0)
    want = coreacc_ref(a, w, KMERS, 1024)
    upper = (torch.arange(160, device=cuda)[None, :]
             > row0 + torch.arange(a.shape[0], device=cuda)[:, None])
    for g, r in zip(got, want):
        torch.testing.assert_close(g[upper], r[upper], atol=1e-5, rtol=0)


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
