"""The words axis of the port's shard/mesh.py (rows x words grids of CPU
slots: each words slot's partial samebits summed at its row block's lead)
and dist/jaccard_torch.py's jaccard_dist_block, against the JAX package's
make_mesh / step functions / engines on its virtual 8-device CPU mesh
(tests/conftest.py), and against the port's own unsplit path. Samebits and
kNN are exact; f32 distances within 1e-6 of the JAX package's (ANI: of
its f64 oracle, and within 5e-6 of its XLA program); f32
core/accessory within 1e-5 of it (the port centres k; pairs on the
regression's beta == 0 discontinuity counted and held rare, as in
tests/test_torch_mesh.py); every split result bit-equal to the port's
unsplit one. Grids of 16 words slots (1 x 16, 2 x 16; past the finish's
MAX_WORDS_SLOTS, so each lead folds its partials first) run at s64 = 16
and are held against the port's 1 x 1 grid bit for bit and against the
JAX package's unsplit functions on its 1 x 1 mesh (its 8-device mesh
cannot hold 16 slots)."""

import io
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from sketchtpu.dist import jaccard_jax
from sketchtpu.dist import jaccard_np as jax_np
from sketchtpu.shard import mesh as jax_mesh
from sketchtpu_torch import runtime
from sketchtpu_torch._transfer import pitch_of
from sketchtpu_torch.dist import api
from sketchtpu_torch.dist.coreacc_kernels import (
    coreacc_chain,
    coreacc_chain_ref,
    coreacc_ref,
    samebits_stack_ref,
)
from sketchtpu_torch.dist.coreacc_torch import DeviceCoreAccEngine
from sketchtpu_torch.dist.jaccard_np import samebits_matrix, samebits_pairs
from sketchtpu_torch.dist.jaccard_torch import jaccard_dist_block
from sketchtpu_torch.dist.knn_kernels import SignMask
from sketchtpu_torch.dist.knn_torch import scan_coreacc
from sketchtpu_torch.dist.samebits_kernels import (
    MAX_WORDS_SLOTS,
    samebits_dist,
    samebits_finish,
    samebits_finish_ref,
    samebits_full,
    samebits_ref,
    samebits_stack,
)
from sketchtpu_torch.formats import skd
from sketchtpu_torch.formats.skm import MultiSketch
from sketchtpu_torch.dist.sign_words import pack_signs
from sketchtpu_torch.shard import mesh
from sketchtpu_torch.sketchcore.sketch import HashType, Sketch
from sketchtpu_torch.synth import derive_signs, derive_words

CPU = torch.device("cpu")
SLOTS = [CPU] * 8
GRIDS = [(8, 1), (4, 2), (2, 4), (1, 8)]
# past MAX_WORDS_SLOTS: on 32 CPU slots, at S64_WIDE
GRIDS_WIDE = [(1, 16), (2, 16)]
KMERS = (17, 21, 25)
S64 = 8  # 512 bins: whole chunks for every words slot up to 8
S64_WIDE = 16  # 1024 bins: one chunk a slot of a 16-wide grid
NA, NB = 37, 23
ATOL_DIST, ATOL_CA = 1e-6, 1e-5
# ANI against the JAX package's XLA program: XLA:CPU may lower f32 log to a
# polynomial that errs up to ~5e-6 relative in ln (measured 1.4e-6 in ANI
# at k = 21, depending on its code generation), so ANI is held to the JAX
# package's f64 host oracle within ATOL_DIST and to the XLA program within
# this
ATOL_ANI_XLA = 5e-6


def _related_words(s64: int, seed: int) -> dict:
    """(NA + NB, nk, s64 * 14) u64 words of related samples (3 families)
    and completeness values."""
    rng = np.random.default_rng(seed)
    parents = rng.integers(0, 2**64, (3, len(KMERS), s64, 14),
                           dtype=np.uint64)
    w = derive_words(parents, NA + NB, KMERS, seed + 1)
    return {"w": w.reshape(NA + NB, len(KMERS), s64 * 14),
            "comp": rng.uniform(0.6, 1.0, NA + NB).astype(np.float32),
            "s64": s64}


@pytest.fixture(scope="module")
def words():
    return _related_words(S64, 141)


@pytest.fixture(scope="module")
def words_wide():
    return _related_words(S64_WIDE, 151)


def _grid_case(request, rows: int, words_: int):
    """A grid's case: (words fixture, its s64, the port's device slots,
    the JAX mesh's (rows, words): the grid's own where its 8 devices hold
    it, else 1 x 1, the unsplit functions)."""
    if rows * words_ <= 8:
        return request.getfixturevalue("words"), S64, SLOTS, (rows, words_)
    return (request.getfixturevalue("words_wide"), S64_WIDE,
            [CPU] * (rows * words_), (1, 1))


def _jax_put(x, grid, spec):
    return jax.device_put(x, NamedSharding(grid, spec))


def _pad(x: np.ndarray, mult: int, axis: int = 0) -> np.ndarray:
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, (-x.shape[axis]) % mult)
    return np.pad(x, pad)


def _close_ca(got: np.ndarray, want: np.ndarray) -> tuple[int, int]:
    """(..., 2) core/accessory within ATOL_CA but for the beta == 0
    discontinuity, where core may jump between ~0 and 1 in either f32
    chain; returns (jumps, pairs)."""
    got, want = got.reshape(-1, 2), want.reshape(-1, 2)
    core, core_w = got[:, 0], want[:, 0]
    jump = (np.abs(core - core_w) > ATOL_CA) \
        & (np.minimum(core, core_w) < 1e-3) & (np.maximum(core, core_w) == 1.0)
    np.testing.assert_allclose(core[~jump], core_w[~jump], atol=ATOL_CA,
                               rtol=0)
    np.testing.assert_allclose(got[:, 1], want[:, 1], atol=ATOL_CA, rtol=0)
    return int(jump.sum()), core.size


def test_make_mesh_shapes_and_defaults(monkeypatch):
    for rows, words in [(None, 1), (None, 2), (4, 2), (2, 4), (1, 8),
                        (3, 2), (None, 3)]:
        got = mesh.make_mesh(rows, words, devices=SLOTS)
        want = jax_mesh.make_mesh(n_rows=rows, n_words=words)
        assert got.shape == dict(want.shape), (rows, words)
        assert len(got.devices) == want.devices.size
    monkeypatch.setattr(runtime, "devices", lambda: [CPU] * 3)
    assert mesh.make_mesh().shape == {"rows": 3, "words": 1}
    assert mesh.make_mesh(n_words=3).shape == {"rows": 1, "words": 3}
    with pytest.raises(ValueError, match="needs"):
        mesh.make_mesh(2, 2)
    one = [torch.device("cpu")] * 2
    assert mesh.as_mesh(one).shape == {"rows": 2, "words": 1}
    grid = mesh.make_mesh(2, 2, devices=SLOTS)
    assert mesh.as_mesh(grid) is grid
    with pytest.raises(ValueError, match="at least one device"):
        mesh.as_mesh([])


def test_uneven_words_split_is_refused(words):
    """s64 % n_words: refused, as the JAX mesh cannot shard it either."""
    w = words["w"]
    grid = mesh.make_mesh(1, 3, devices=SLOTS)
    with pytest.raises(ValueError, match="does not split"):
        mesh.sharded_samebits(w[:NA, 0], w[NA:, 0], S64, grid)
    with pytest.raises(ValueError, match="does not split"):
        mesh.sharded_dist_step(w[:NA, 0], w[NA:, 0], S64, grid, 21.0, True)
    with pytest.raises(ValueError, match="does not split"):
        mesh.sharded_coreacc_step(w[:NA], w[NA:], S64, grid, KMERS, S64 * 64)
    with pytest.raises(ValueError, match="does not split"):
        mesh.ShardedSamebitsEngine(S64, grid)
    a32 = np.ascontiguousarray(w[:NA, 0]).view(np.uint32)
    with pytest.raises(Exception):  # the JAX mesh fails at device_put
        jax.block_until_ready(_jax_put(a32, jax_mesh.make_mesh(1, 3),
                                       P("rows", "words")))


@pytest.mark.parametrize("rows,words_", GRIDS + GRIDS_WIDE)
def test_samebits_engine_on_grids(request, rows, words_):
    words, s64, slots, jax_shape = _grid_case(request, rows, words_)
    w = words["w"]
    a, b = np.ascontiguousarray(w[:NA, 1]), np.ascontiguousarray(w[NA:, 1])
    want = jax_mesh.ShardedSamebitsEngine(
        s64, jax_mesh.make_mesh(*jax_shape)).matrix(a, b)
    grid = mesh.make_mesh(rows, words_, devices=slots)
    got = mesh.ShardedSamebitsEngine(s64, grid).matrix(a, b)
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert np.array_equal(got, samebits_matrix(a, b))
    assert np.array_equal(got, mesh.ShardedSamebitsEngine(
        s64, mesh.make_mesh(1, 1, devices=[CPU])).matrix(a, b))
    # int64 tensors give the same counts, on the grid's first slot
    t = mesh.sharded_samebits(torch.from_numpy(a.view(np.int64)),
                              torch.from_numpy(b.view(np.int64)), s64, grid)
    assert t.device == CPU and np.array_equal(t.numpy(), want)


def _oracle(a: np.ndarray, b: np.ndarray, s64: int, k: float,
            ani: bool) -> np.ndarray:
    """The JAX package's f64 host oracle of the f32 distances."""
    j = jax_np.jaccard_from_samebits(jax_np.samebits_matrix(a, b), s64)
    return (jax_np.ani_pois(j, k) if ani else 1.0 - j).astype(np.float32)


def _close_to_jax(got: torch.Tensor, xla: np.ndarray, a, b, s64, k, ani):
    """Distances within ATOL_DIST of the JAX package (its XLA program for
    Jaccard; for ANI its f64 oracle, and its XLA program within
    ATOL_ANI_XLA)."""
    got = got.numpy()
    np.testing.assert_allclose(got, xla, rtol=0,
                               atol=ATOL_ANI_XLA if ani else ATOL_DIST)
    np.testing.assert_allclose(got, _oracle(a, b, s64, k, ani), rtol=0,
                               atol=ATOL_DIST)


def _jax_dist_step(a32, b32, rows, words_, k, ani, s64=S64):
    grid = jax_mesh.make_mesh(rows, words_)
    out = jax_mesh.sharded_dist_step(
        _jax_put(_pad(a32, rows), grid, P("rows", "words")),
        _jax_put(b32, grid, P(None, "words")), s64, grid, k, ani)
    return np.asarray(out)[: a32.shape[0]]


@pytest.mark.parametrize("ani", [False, True])
@pytest.mark.parametrize("rows,words_", [(4, 2), (2, 4)] + GRIDS_WIDE)
def test_dist_step_on_grids(request, rows, words_, ani):
    words, s64, slots, jax_shape = _grid_case(request, rows, words_)
    w = words["w"]
    a, b = np.ascontiguousarray(w[:NA, 0]), np.ascontiguousarray(w[NA:, 0])
    want = _jax_dist_step(a.view(np.uint32), b.view(np.uint32), *jax_shape,
                          17.0, ani, s64)
    got = mesh.sharded_dist_step(a, b, s64,
                                 mesh.make_mesh(rows, words_, devices=slots),
                                 17.0, ani)
    assert got.dtype == torch.float32 and got.shape == (NA, NB)
    _close_to_jax(got, want, a, b, s64, 17.0, ani)
    whole = jaccard_dist_block(torch.from_numpy(a.view(np.int64)),
                               torch.from_numpy(b.view(np.int64)), s64,
                               k=17.0, ani=ani)
    assert torch.equal(got, whole)
    assert torch.equal(got, mesh.sharded_dist_step(
        a, b, s64, mesh.make_mesh(1, 1, devices=[CPU]), 17.0, ani))
    assert ((got > 0.0) & (got < 1.0)).sum() > NA  # related pairs


def test_jaccard_dist_block_at_the_entry_shape():
    """__graft_entry__.entry()'s tile: 128 x 128 random words, s64 = 16,
    k = 21; then identical and complementary rows (j = 1 and j = 0)."""
    s64 = 16
    rng = np.random.default_rng(0)
    a32 = rng.integers(0, 2**32, (128, s64 * 28), dtype=np.uint32)
    b32 = rng.integers(0, 2**32, (128, s64 * 28), dtype=np.uint32)
    a, b = (torch.from_numpy(x.view(np.int64)) for x in (a32, b32))
    for ani in (False, True):
        want = np.asarray(jaccard_jax.jaccard_dist_block(
            jnp.asarray(a32), jnp.asarray(b32), s64=s64, k=21.0, ani=ani))
        got = jaccard_dist_block(a, b, s64, k=21.0, ani=ani)
        _close_to_jax(got, want, a32.view(np.uint64), b32.view(np.uint64),
                      s64, 21.0, ani)
    # related rows: the bias-corrected Jaccard away from 0
    rel32 = a32.copy()
    rel32[:, : s64 * 14] = b32[:, : s64 * 14]
    for ani in (False, True):
        want = np.asarray(jaccard_jax.jaccard_dist_block(
            jnp.asarray(rel32), jnp.asarray(b32), s64=s64, k=21.0, ani=ani))
        got = jaccard_dist_block(torch.from_numpy(rel32.view(np.int64)), b,
                                 s64, k=21.0, ani=ani)
        _close_to_jax(got, want, rel32.view(np.uint64), b32.view(np.uint64),
                      s64, 21.0, ani)
        diag = got.diagonal()  # row i shares half its words with b's row i
        assert ((diag > 0.0) & (diag < 1.0)).all()
    # the ANI edges: j = 1 gives exactly 1, j = 0 (log 0) exactly 0
    same = jaccard_dist_block(a[:4], a[:4], s64, k=21.0, ani=True)
    assert torch.all(same.diagonal() == 1.0)
    assert torch.all(jaccard_dist_block(a[:4], a[:4], s64).diagonal() == 0.0)
    disjoint = jaccard_dist_block(a[:4], ~a[:4], s64, k=21.0, ani=True)
    want = np.asarray(jaccard_jax.jaccard_dist_block(
        jnp.asarray(a32[:4]), jnp.asarray(~a32[:4]), s64=s64, k=21.0,
        ani=True))
    _close_to_jax(disjoint, want, a32[:4].view(np.uint64),
                  (~a32[:4]).view(np.uint64), s64, 21.0, True)
    assert torch.all(disjoint.diagonal() == 0.0)
    assert np.all(np.diagonal(want) == 0.0)
    assert torch.all(
        jaccard_dist_block(a[:4], ~a[:4], s64).diagonal() == 1.0)


def test_samebits_dist_base_adds_the_other_chunks(words):
    """A chunk range's partial samebits and the other range's, summed by
    the finish pass (samebits_finish), give the whole sketch's distances,
    bit for bit; widths past s64 and a bad partial are refused."""
    t = torch.from_numpy(words["w"].view(np.int64))
    a, b = t[:NA, 2], t[NA:, 2]
    cut = 3 * 14
    base = samebits_ref(a[:, cut:], b[:, cut:])
    own = samebits_ref(a[:, :cut], b[:, :cut])
    for ani in (False, True):
        assert torch.equal(
            samebits_finish([own, base], S64, k=25.0, ani=ani),
            jaccard_dist_block(a, b, S64, k=25.0, ani=ani))
    with pytest.raises(ValueError, match="exceed"):
        samebits_dist(a, b, S64 - 1)
    with pytest.raises(ValueError, match="partials"):
        samebits_finish([own, base.to(torch.int64)], S64)


def _jax_coreacc_step(stack, rows, words_, comp, s64=S64):
    """The JAX step on (nk, n, W2) u32 stacks: rows NA of a, all of b."""
    grid = jax_mesh.make_mesh(rows, words_)
    a = _jax_put(_pad(stack[:, :NA], rows, 1), grid, P(None, "rows", "words"))
    b = _jax_put(stack[:, NA:], grid, P(None, None, "words"))
    kw = {}
    if comp is not None:
        kw = dict(c1=_jax_put(_pad(comp[:NA], rows), grid, P("rows")),
                  c2=_jax_put(comp[NA:], grid, P(None)), cutoff=0.64)
    out = jax_mesh.sharded_coreacc_step(a, b, s64, grid, KMERS, s64 * 64, **kw)
    return np.asarray(out)[:NA]


@pytest.mark.parametrize("comp", [False, True])
@pytest.mark.parametrize("rows,words_", [(8, 1), (4, 2), (2, 4)]
                         + GRIDS_WIDE)
def test_coreacc_step_on_grids(request, rows, words_, comp):
    words, s64, slots, jax_shape = _grid_case(request, rows, words_)
    w, cv = words["w"], words["comp"] if comp else None
    stack = np.ascontiguousarray(w.transpose(1, 0, 2)).view(np.uint32)
    want = _jax_coreacc_step(stack, *jax_shape, cv, s64)
    c1, c2 = (cv[:NA], cv[NA:]) if comp else (None, None)
    grid = mesh.make_mesh(rows, words_, devices=slots)
    got = mesh.sharded_coreacc_step(w[:NA], w[NA:], s64, grid, KMERS,
                                    s64 * 64, c1=c1, c2=c2)
    assert got.shape == (NA, NB, 2) and got.dtype == torch.float32
    jumps, pairs = _close_ca(got.numpy(), want)
    assert jumps <= 0.02 * pairs
    t = torch.from_numpy(w.view(np.int64))
    c = torch.from_numpy(cv) if comp else None
    core, acc = coreacc_ref(t[:NA], t[NA:], KMERS, s64 * 64,
                            c[:NA] if comp else None,
                            c[NA:] if comp else None)
    assert torch.equal(got, torch.stack([core, acc], dim=-1))
    assert torch.equal(got, mesh.sharded_coreacc_step(
        w[:NA], w[NA:], s64, mesh.make_mesh(1, 1, devices=[CPU]), KMERS,
        s64 * 64, c1=c1, c2=c2))
    fitted = ((core > 0) & (core < 1)).sum()
    assert fitted > NA  # pairs reached the fit


@pytest.mark.parametrize("rows,words_", [(2, 1), (1, 2), (2, 2)])
def test_set_up_copies_run_after_marks_of_the_operands_devices(
        monkeypatch, words, rows, words_):
    """Every set-up copy of a step (mesh._to: a slot's share of a, of b,
    and the completeness values), a rows-only grid's too, runs in a task
    that waits for marks (mesh._marks) recorded on the grid's devices and
    on the device of every tensor operand, so that a copy from another
    GPU comes after what the caller queued there."""
    marked = []

    def marks(devices):
        marked.append(list(devices))
        return [("mark", len(marked))]

    seen = []
    to = mesh._to

    def spy(x, device, what):
        seen.append((what, list(mesh._this.after)))
        return to(x, device, what)

    monkeypatch.setattr(mesh, "_marks", marks)
    monkeypatch.setattr(mesh, "_to", spy)
    t = torch.from_numpy(words["w"].view(np.int64))
    c = torch.from_numpy(words["comp"]).to(torch.float64)
    grid = mesh.make_mesh(rows, words_, devices=SLOTS)
    got = mesh.sharded_coreacc_step(t[:NA], t[NA:], S64, grid, KMERS,
                                    S64 * 64, c1=c[:NA], c2=c[NA:])
    core, acc = coreacc_ref(t[:NA], t[NA:], KMERS, S64 * 64,
                            c[:NA].float(), c[NA:].float())
    assert torch.equal(got, torch.stack([core, acc], dim=-1))
    # the slots' set-up, then the step, each marking the operands' devices
    assert len(marked) == 2
    assert all({t.device, c.device} <= set(m) for m in marked)
    whats = [w for w, _ in seen]
    assert whats.count("setup b") == words_
    assert whats.count("setup a") == rows * words_
    assert whats.count("setup c") == 2 * rows
    for what, after in seen:
        assert after == [("mark", 1 if what == "setup b" else 2)], what


def test_coreacc_chain_twin_is_coreacc_refs_chain(words):
    """coreacc_chain_ref of summed per-range samebits equals coreacc_ref bit
    for bit, with and without completeness; coreacc_chain on CPU tensors
    is its twin."""
    t = torch.from_numpy(words["w"].view(np.int64))
    c = torch.from_numpy(words["comp"])
    a, b = t[:NA], t[NA:]
    split = sum(samebits_stack_ref(a[..., r], b[..., r])
                for r in mesh.word_ranges(S64, 4))
    assert torch.equal(split, samebits_stack_ref(a, b))
    for c1, c2 in ((None, None), (c[:NA], c[NA:])):
        want = coreacc_ref(a, b, KMERS, S64 * 64, c1, c2)
        got = coreacc_chain_ref(split, KMERS, S64 * 64, S64, c1, c2)
        assert all(torch.equal(g, x) for g, x in zip(got, want))
        got = coreacc_chain(split, KMERS, S64 * 64, S64, c1, c2)
        assert all(torch.equal(g, x) for g, x in zip(got, want))
    with pytest.raises(ValueError, match="stack"):
        coreacc_chain(split.to(torch.int64), KMERS, S64 * 64, S64)
    with pytest.raises(ValueError, match="both"):
        coreacc_chain(split, KMERS, S64 * 64, S64, c[:NA], None)


@pytest.mark.parametrize("n_words", [1, 2, 4, 8])
def test_chain_and_finish_over_slabs_against_the_jax_steps(words, n_words):
    """coreacc_chain_ref over the n_words slots' partial (nk, NA, NB)
    slabs (as samebits_stack makes them), and the distance finish's twin
    over one k's partial counts, against the JAX package's
    sharded_coreacc_step / sharded_dist_step on its 8-device CPU mesh with
    that many words slots (f32 tolerances as in the grid tests), and bit
    for bit against the port's unsplit twins; the count mode is exact."""
    w, cv = words["w"], words["comp"]
    t = torch.from_numpy(w.view(np.int64))
    a, b = t[:NA], t[NA:]
    rows = 8 // n_words
    slabs = [samebits_stack(a[..., r], b[..., r])
             for r in mesh.word_ranges(S64, n_words)]
    assert len(slabs) == n_words
    stack = np.ascontiguousarray(w.transpose(1, 0, 2)).view(np.uint32)
    for comp in (False, True):
        c1, c2 = ((torch.from_numpy(cv[:NA]), torch.from_numpy(cv[NA:]))
                  if comp else (None, None))
        got = torch.stack(coreacc_chain_ref(slabs, KMERS, S64 * 64, S64, c1,
                                            c2), dim=-1)
        unsplit = coreacc_ref(a, b, KMERS, S64 * 64, c1, c2)
        assert torch.equal(got, torch.stack(unsplit, dim=-1))
        assert all(torch.equal(g, x) for g, x in zip(
            coreacc_chain(slabs, KMERS, S64 * 64, S64, c1, c2), unsplit))
        want = _jax_coreacc_step(stack, rows, n_words, cv if comp else None)
        jumps, pairs = _close_ca(got.numpy(), want)
        assert jumps <= 0.02 * pairs
    ki = 1
    parts = [slab[ki] for slab in slabs]
    pa, pb = (np.ascontiguousarray(w[:NA, ki]),
              np.ascontiguousarray(w[NA:, ki]))
    for ani in (False, True):
        got = samebits_finish_ref(parts, S64, k=17.0, ani=ani)
        assert torch.equal(got, samebits_finish(parts, S64, k=17.0, ani=ani))
        assert torch.equal(got, jaccard_dist_block(a[:, ki], b[:, ki], S64,
                                                   k=17.0, ani=ani))
        _close_to_jax(got, _jax_dist_step(pa.view(np.uint32),
                                          pb.view(np.uint32), rows, n_words,
                                          17.0, ani), pa, pb, S64, 17.0, ani)
    counts = samebits_finish_ref(parts)
    assert counts.dtype == torch.int32
    assert np.array_equal(counts.numpy(), samebits_matrix(pa, pb))
    assert np.array_equal(counts.numpy(), jax_mesh.ShardedSamebitsEngine(
        S64, jax_mesh.make_mesh(rows, n_words)).matrix(pa, pb))


def test_finish_refuses_more_slabs_than_its_bound(words):
    """The finish and the chain take 1 to MAX_WORDS_SLOTS partials."""
    t = torch.from_numpy(words["w"].view(np.int64))
    slab = samebits_stack(t[:4, :, :14], t[4:9, :, :14])
    many = [slab] * (MAX_WORDS_SLOTS + 1)
    for call in (lambda: coreacc_chain(many, KMERS, S64 * 64, S64),
                 lambda: coreacc_chain_ref(many, KMERS, S64 * 64, S64),
                 lambda: samebits_finish([x[0] for x in many], S64),
                 lambda: samebits_finish_ref([x[0] for x in many]),
                 lambda: samebits_finish([], S64)):
        with pytest.raises(ValueError, match="partials"):
            call()
    with pytest.raises(ValueError, match="one shape"):
        samebits_finish([slab[0], slab[1][:2]])
    assert torch.equal(coreacc_chain([slab] * MAX_WORDS_SLOTS, KMERS,
                                     S64 * 64 * MAX_WORDS_SLOTS,
                                     S64 * MAX_WORDS_SLOTS)[0],
                       coreacc_chain(slab * MAX_WORDS_SLOTS, KMERS,
                                     S64 * 64 * MAX_WORDS_SLOTS,
                                     S64 * MAX_WORDS_SLOTS)[0])


@pytest.mark.parametrize("n", [1, 8, 9, 16, 17, 64, 65])
def test_fold_leaves_a_finish_at_most_its_bound(n):
    """mesh._fold: the partials of n words slots as 1 to MAX_WORDS_SLOTS
    int32 tensors with the same (exact) sum, by samebits_finish's count
    mode over groups in order; up to MAX_WORDS_SLOTS they stand as they
    are."""
    rng = np.random.default_rng(n)
    parts = [torch.from_numpy(rng.integers(0, 1 << 24, (5, 7), dtype=np.int32))
             for _ in range(n)]
    got = mesh._fold(parts)
    assert 1 <= len(got) <= MAX_WORDS_SLOTS
    if n <= MAX_WORDS_SLOTS:
        assert all(g is p for g, p in zip(got, parts)) and len(got) == n
    want = torch.from_numpy(sum(p.numpy().astype(np.int64) for p in parts))
    assert torch.equal(samebits_finish(got).to(torch.int64), want)


def test_samebits_stack_is_nk_samebits_full_calls(words):
    """The one-launch per-k partials equal nk samebits_full calls, on the
    whole words and on a strided range of chunks read in place."""
    t = torch.from_numpy(words["w"].view(np.int64))
    a, b = t[:NA], t[NA:]
    for r in (slice(None), mesh.word_ranges(S64, 4)[1]):
        got = samebits_stack(a[..., r], b[..., r])
        want = torch.stack([samebits_full(a[:, ki, r], b[:, ki, r])
                            for ki in range(len(KMERS))])
        assert got.dtype == torch.int32 and got.shape == (len(KMERS), NA, NB)
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="dims"):
        samebits_stack(a[:, 0], b[:, 0])
    with pytest.raises(ValueError, match="same"):
        samebits_stack(a[:, :2], b)


def test_pitch_of_reads_a_slots_share_in_place(words):
    """pitch_of gives a slot's share of an operand (a range of each
    sample's words, of every k or of one k-plane) as rows at one pitch of
    its base tensor, so copy_pitched's 2-D memcpy reads exactly the share;
    views that are not such rows are refused (they are made contiguous
    first)."""
    t = torch.from_numpy(words["w"].view(np.int64))
    for view in (t[3:20][..., mesh.word_ranges(S64, 4)[2]],
                 t[:, 1][:, 14:42], t[5:9, 2], t[0], t[2:3, :, 14:28],
                 t[7:8, 1, 28:42]):
        rows, pitch = pitch_of(view)
        read = torch.as_strided(t, (rows, view.shape[-1]), (pitch, 1),
                                view.storage_offset())
        assert torch.equal(read.reshape(view.shape), view)
    assert pitch_of(t.transpose(0, 1)) is None
    assert pitch_of(t[..., ::2]) is None


@pytest.mark.parametrize("rows,words_", [g for g in GRIDS if g[1] > 1])
def test_words_schedule_runs_the_leads_partial_first(rows, words_):
    """DeviceSlots.split_words: each row block's lead runs its own partial
    before it waits for anything (here every other slot's partial waits
    until its lead's has begun: a lead that waited first would stall them,
    caught by the timeout), and the finish gets every slot's partial, the
    lead's first, on the lead's slot."""
    import threading

    blocks = mesh.split_rows(0, 20, rows)
    begun = [threading.Event() for _ in blocks]

    def partial(eng, rws):
        r, w = blocks.index(rws), eng.w
        if w == 0:
            begun[r].set()
        elif not begun[r].wait(timeout=10):
            raise AssertionError(f"row block {r}: the lead waited first")
        return torch.tensor([w, rws.start], dtype=torch.int32)

    def finish(eng, rws, parts):
        return eng.w, [p.tolist() for p in parts]

    slots = mesh.DeviceSlots(mesh.make_mesh(rows, words_, devices=SLOTS),
                             lambda d, w: SimpleNamespace(device=d, w=w))
    try:
        got = [f.result() for f in slots.split_words(0, 20, partial, finish)]
    finally:
        slots.close()
    for (lead, parts), rws in zip(got, blocks):
        assert lead == 0
        assert parts == [[w, rws.start] for w in range(words_)]


def _write_db(d: Path, name: str, words: np.ndarray, sketch_size: int):
    names = [f"{name}{i:03d}" for i in range(words.shape[0])]
    with skd.SketchDataWriter(str(d / f"{name}.skd")) as wr:
        sketches = [Sketch(name=nm, index=wr.write_sketch(words[i].reshape(-1)))
                    for i, nm in enumerate(names)]
    MultiSketch(sketches, sketch_size, list(KMERS), HashType("dna")) \
        .save_metadata(str(d / name))
    ms = MultiSketch.load_metadata(str(d / name))
    ms.read_sketch_data(str(d / name))
    return ms, names


def _dbs(words, d: Path):
    w, s64 = words["w"], words["s64"]
    ms, names = _write_db(d, "r", w[:NA], s64 * 64)
    qms, qnames = _write_db(d, "q", w[NA:], s64 * 64)
    return ms, names, qms, qnames


@pytest.fixture(scope="module")
def dbs(words, tmp_path_factory):
    return _dbs(words, tmp_path_factory.mktemp("torch_words"))


@pytest.fixture(scope="module")
def dbs_wide(words_wide, tmp_path_factory):
    return _dbs(words_wide, tmp_path_factory.mktemp("torch_words_wide"))


@pytest.mark.parametrize("comp", [False, True])
@pytest.mark.parametrize("rows,words_", [(2, 2), (1, 4), (4, 2)]
                         + GRIDS_WIDE)
def test_words_grid_coreacc_engine(request, rows, words_, comp):
    """tile_dists, stream_self_dense and stream_cross_dense over a words
    grid: the one-device engine's bytes, and within 2e-4 of the host f64
    chain (the JAX sharding tests' tolerance)."""
    words, _, slots, _ = _grid_case(request, rows, words_)
    ms, names, qms, qnames = request.getfixturevalue(
        "dbs" if words_ <= 8 else "dbs_wide")
    cv = words["comp"][:NA].astype(np.float64) if comp else None
    qc = words["comp"][NA:].astype(np.float64) if comp else None
    grid = mesh.make_mesh(rows, words_, devices=slots)
    port = mesh.ShardedCoreAccEngine(ms, grid, tile=16, completeness_vec=cv)
    one = DeviceCoreAccEngine(ms, CPU, tile=16, completeness_vec=cv)
    got = port.tile_dists(slice(3, 30), slice(0, NA))
    assert np.array_equal(got, one.tile_dists(slice(3, 30), slice(0, NA)))
    host = api.self_dists_all(ms, api.set_k(ms, None, False),
                              completeness_vec=cv)
    iu = np.triu_indices(NA, 1)
    full = port.tile_dists(slice(0, NA), slice(0, NA))
    np.testing.assert_allclose(full[iu], host, atol=2e-4, rtol=0)
    for row_range in (None, slice(5, 29)):
        texts = []
        for eng in (port, one):
            out = io.StringIO()
            eng.stream_self_dense(out, names, row_range=row_range)
            texts.append(out.getvalue())
        assert texts[0] and texts[0] == texts[1]
    texts = []
    for eng in (port, one):
        out = io.StringIO()
        eng.stream_cross_dense(out, names, qnames, qms, rcomp=cv, qcomp=qc)
        texts.append(out.getvalue())
    assert texts[0] and texts[0] == texts[1]
    host = api.cross_dists_all(ms, qms, api.set_k(ms, None, False), cv, qc)
    vals = np.array([ln.split("\t")[2:] for ln in texts[0].splitlines()],
                    float)
    np.testing.assert_allclose(vals, host.reshape(-1, 2), atol=2e-4, rtol=0)


def _jax_knn(a, b, rows, knn, exclude_self, c, sig, ca):
    """The JAX step on (rows-padded) a against all of b; its output rows
    cut back to a's."""
    grid = jax_mesh.make_mesh(rows, 1)
    na = a.shape[-2]
    kw = {}
    if c is not None:
        kw.update(c1=np.pad(c[0], (0, (-na) % rows), constant_values=1.0),
                  c2=c[1])
    if sig is not None:
        kw.update(a_sig=_pad(sig[0].astype(np.int32), rows),
                  b_sig=sig[1].astype(np.int32))
    if ca:
        out = jax_mesh.sharded_knn_ca_step(
            _pad(a, rows, 1), b, S64, grid, knn, n_real=b.shape[1],
            exclude_self=exclude_self, kmers=KMERS, sketch_size=S64 * 64,
            col_tile=b.shape[1], **kw)
    else:
        out = jax_mesh.sharded_knn_step(
            _pad(a, rows), b, S64, grid, knn, n_real=b.shape[0],
            exclude_self=exclude_self, col_tile=b.shape[0], **kw)
    return [np.asarray(x)[:na] for x in out]


@pytest.mark.parametrize("mode", ["plain", "comp", "masked"])
def test_knn_steps_at_8_rows(words, mode):
    """sharded_knn_step exact against the JAX step (values and indices);
    sharded_knn_ca_step's selection and f32 values within 1e-5 of it."""
    w = words["w"]
    n = NA + NB
    c = words["comp"] if mode == "comp" else None
    sig = derive_signs(n, 9, 4, 143, redraw=0.8) if mode == "masked" else None
    plane = np.ascontiguousarray(w[:, 1])
    grid = mesh.make_mesh(8, 1, devices=SLOTS)
    kw = {}
    if c is not None:
        kw.update(c1=c, c2=c)
    if sig is not None:
        kw.update(a_sig=sig, b_sig=sig)
    got = mesh.sharded_knn_step(plane, plane, S64, grid, 6, n_real=n,
                                exclude_self=True, **kw)
    want = _jax_knn(plane.view(np.uint32), plane.view(np.uint32), 8, 6, True,
                    (c, c) if c is not None else None,
                    (sig, sig) if sig is not None else None, False)
    for g, x in zip(got, want):
        assert g.dtype == torch.int32 and np.array_equal(g.numpy(), x)
    if mode == "masked":
        assert (got[1] == 0x7FFFFFFF).any()  # rows short of candidates
    stack = np.ascontiguousarray(w.transpose(1, 0, 2)).view(np.uint32)
    got = mesh.sharded_knn_ca_step(w, w, S64, grid, 5, n_real=n,
                                   exclude_self=True, kmers=KMERS,
                                   sketch_size=S64 * 64, **kw)
    want = _jax_knn(stack, stack, 8, 5, True,
                    (c, c) if c is not None else None,
                    (sig, sig) if sig is not None else None, True)
    t = torch.from_numpy(w.view(np.int64))
    c_t = torch.from_numpy(c) if c is not None else None
    one = scan_coreacc(
        t, t, KMERS, S64 * 64, 5, True, c_t, c_t,
        sig=SignMask(pack_signs(sig, CPU), pack_signs(sig, CPU), 9)
        if sig is not None else None)
    assert all(torch.equal(g, x) for g, x in zip(got, one))
    core, acc, idx = (x.numpy() for x in got)
    valid = idx != 0x7FFFFFFF
    assert np.array_equal(np.isinf(core), ~valid)
    # the selection by f32 core: a pair on the beta == 0 discontinuity
    # (core ~0 in one chain, 1 in the other) changes its row's list
    same = (idx == want[2]).all(axis=1)
    assert same.sum() >= 0.9 * n
    for got_v, want_v in ((core, want[0]), (acc, want[1])):
        np.testing.assert_allclose(got_v[same][valid[same]],
                                   want_v[same][valid[same]], atol=ATOL_CA,
                                   rtol=0)


def test_knn_and_inverted_refuse_a_words_axis(words, dbs):
    ms = dbs[0]
    w = words["w"]
    grid = mesh.make_mesh(4, 2, devices=SLOTS)
    jax_grid = jax_mesh.make_mesh(4, 2)
    sig = derive_signs(NA, 9, 4, 144)
    for port, jax_fn in (
        (lambda: mesh.ShardedKnnEngine(ms, grid),
         lambda: jax_mesh.ShardedKnnEngine(ms, jax_grid)),
        (lambda: mesh.sharded_knn_step(w[:, 0], w[:, 0], S64, grid, 3,
                                       NA, True),
         lambda: jax_mesh.sharded_knn_step(w[:, 0], w[:, 0], S64, jax_grid,
                                           3, NA, True)),
        (lambda: mesh.sharded_knn_ca_step(w, w, S64, grid, 3, NA, True,
                                          KMERS, S64 * 64),
         lambda: jax_mesh.sharded_knn_ca_step(w, w, S64, jax_grid, 3, NA,
                                              True, KMERS, S64 * 64)),
        (lambda: mesh.ShardedInvertedEngine(sig, grid),
         lambda: jax_mesh.ShardedInvertedEngine(sig, jax_grid)),
    ):
        with pytest.raises(ValueError) as want:
            jax_fn()
        with pytest.raises(ValueError, match=str(want.value)):
            port()


def test_samebits_pairs_matches_the_jax_packages(words):
    w = words["w"]
    a, b = np.ascontiguousarray(w[:NB, 0]), np.ascontiguousarray(w[NA:, 0])
    got = samebits_pairs(a, b)
    assert got.dtype == np.int64
    assert np.array_equal(got, jax_np.samebits_pairs(a, b))
    assert np.array_equal(got, np.diagonal(samebits_matrix(a, b)))


def test_no_cli_flag_or_variable_reaches_the_words_axis(monkeypatch):
    """The runtime hands the engines a list of devices: a rows-only grid."""
    monkeypatch.setenv("SKETCHTPU_TORCH_BACKEND", "cpu")
    monkeypatch.setattr(runtime, "devices", lambda: [CPU] * 3)
    assert mesh.as_mesh(runtime.devices()).shape == {"rows": 3, "words": 1}
    src = (Path(runtime.__file__).read_text()
           + Path(runtime.__file__).with_name("cli.py").read_text())
    assert "make_mesh" not in src and "n_words" not in src
