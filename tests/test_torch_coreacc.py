"""K2 core/accessory: the port's twin (and its wrapper on CPU tensors)
against the Pallas kernel in interpret mode, the XLA tile, and the f64
host chain, on related sketches at several divergences."""

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
from sketchtpu_torch.dist.coreacc_kernels import coreacc, coreacc_ref
from sketchtpu_torch.synth import derive_words

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


@pytest.mark.parametrize("with_comp", [False, True])
def test_coreacc_matches_pallas_interpret_and_xla(with_comp):
    s64, n = 4, 24
    w = _related(n, s64, 1)
    sketch_size = s64 * 64
    c = _comp(n, 2) if with_comp else None
    cj = dict(c1=jnp.asarray(c), c2=jnp.asarray(c), cutoff=0.64) if with_comp else {}
    stack = jnp.asarray(_stack32(w))
    xla = np.asarray(coreacc_tile(stack, stack, s64, KMERS, sketch_size, **cj))
    cm = chunk_major(stack, s64)
    pallas = np.asarray(coreacc_pallas(
        cm, jnp.transpose(cm), s64, KMERS, sketch_size, ti=8, tj=8,
        interpret=True, **cj,
    ))
    ct = dict(c1=torch.from_numpy(c), c2=torch.from_numpy(c), cutoff=0.64) \
        if with_comp else {}
    core, acc = coreacc(_t(w), _t(w), KMERS, sketch_size, **ct)
    got = np.stack([core.numpy(), acc.numpy()], axis=-1)
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
