"""K1 samebits: the port's twin (and its wrapper on CPU tensors) against the
Pallas strip kernel in interpret mode, the XLA tile and the NumPy oracle.
Exact equality wherever consumers read (with tri: column > row)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sketchtpu.dist.jaccard_jax import _samebits_tile
from sketchtpu.dist.jaccard_np import samebits_matrix
from sketchtpu.dist.pallas_kernels import chunk_group_major, samebits_strip_fused
from sketchtpu_torch.dist.samebits_kernels import (
    popcount64,
    samebits,
    samebits_ref,
)


def _words(n, s64, seed):
    """(n, s64*14) u64 words: random rows plus near-copies of row 0, so
    counts span the whole range."""
    rng = np.random.default_rng(seed)
    w = s64 * 14
    m = rng.integers(0, 2**64, (n, w), dtype=np.uint64)
    flips = rng.random((n, w)) < 0.02
    m[: n // 2] = np.where(flips[: n // 2], m[: n // 2], m[0])
    return m


def _t(m):
    return torch.from_numpy(m.view(np.int64).copy())


def test_popcount64_matches_numpy():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2**64, 4096, dtype=np.uint64)
    x[:4] = [0, 2**64 - 1, 2**63, 1]
    got = popcount64(_t(x)).numpy()
    np.testing.assert_array_equal(got, np.bitwise_count(x).astype(np.int64))


def test_samebits_int32_matches_oracle_and_xla():
    s64 = 16
    a = _words(37, s64, 1)
    b = _words(53, s64, 2)
    b[:5] = a[:5]  # identical pairs: samebits == s64 * 64
    want = samebits_matrix(a, b)
    got = samebits(_t(a), _t(b), out_dtype=torch.int32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    xla = np.asarray(_samebits_tile(jnp.asarray(a.view(np.uint32)),
                                    jnp.asarray(b.view(np.uint32)), s64))
    np.testing.assert_array_equal(got.numpy(), xla)


@pytest.mark.parametrize("tri,row0", [(False, 0), (True, 0), (True, 512)])
def test_samebits_strip_matches_pallas_interpret(tri, row0):
    """int16 strips against samebits_strip_fused(interpret=True)."""
    s64, n, blk = 4, 1024, 512
    mat = _words(n, s64, 5)
    mat32 = jnp.asarray(mat.view(np.uint32))
    cm = chunk_group_major(mat32, s64)
    rows = slice(row0, row0 + blk)
    want = np.asarray(samebits_strip_fused(
        cm[rows], jnp.transpose(cm), s64, row0=jnp.int32(row0), tri=tri,
        interpret=True,
    ))
    got = samebits(_t(mat[rows]), _t(mat), out_dtype=torch.int16, tri=tri,
                   row0=row0).numpy()
    assert got.dtype == np.int16
    read = (np.arange(n)[None, :] > row0 + np.arange(blk)[:, None]) if tri \
        else np.ones((blk, n), bool)
    np.testing.assert_array_equal(got[read], want[read])
    np.testing.assert_array_equal(
        got[read], samebits_matrix(mat[rows], mat).astype(np.int16)[read]
    )


def test_samebits_reads_k_plane_in_place():
    """A k-plane of an (n, nk, W) database tensor (row stride nk*W) gives
    the same counts as its contiguous copy."""
    s64, nk, n = 4, 3, 40
    db = np.stack([_words(n, s64, 10 + k) for k in range(nk)], axis=1)
    t = _t(db)
    for ki in range(nk):
        plane = t[:, ki]
        assert plane.stride(0) == nk * s64 * 14
        got = samebits(plane[5:17], plane, out_dtype=torch.int32)
        np.testing.assert_array_equal(
            got.numpy(), samebits_matrix(db[5:17, ki], db[:, ki])
        )


def test_samebits_rejects_bad_input():
    a = _t(_words(4, 4, 0))
    with pytest.raises(TypeError):
        samebits(a.to(torch.int32), a)
    with pytest.raises(ValueError):
        samebits(a[:, :-1], a[:, :-1])
    with pytest.raises(ValueError):
        samebits(a, a[:, :28])
    with pytest.raises(ValueError):
        samebits(a.t().contiguous().t(), a)
    big = _t(_words(2, 512, 0))  # 32768 bins overflow int16
    with pytest.raises(ValueError):
        samebits(big, big, out_dtype=torch.int16)


def test_twin_tiles_columns_exactly(monkeypatch):
    """The twin's column tiling (bounded working set) changes nothing."""
    from sketchtpu_torch.dist import samebits_kernels as sk

    a, b = _words(9, 4, 3), _words(31, 4, 4)
    want = samebits_ref(_t(a), _t(b)).numpy()
    monkeypatch.setattr(sk, "_REF_ELEMS", 9 * 4 * 5)
    np.testing.assert_array_equal(samebits_ref(_t(a), _t(b)).numpy(), want)
