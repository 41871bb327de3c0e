"""Amino-acid and 3Di sketching in the port against the JAX package: the
aaHash kernel's twin against the XLA device-mask program (on JAX's CPU) and
the NumPy oracle, the AA backend, AA ingest (native and Python parsers),
and the CLI (`sketch --seq-type aa|pdb`, levels 1-3, --concat-fasta,
--convert-pdb, `append`, `dist`) in cpu and host mode against
`sketchtpu.cli` on its host oracle. Tolerance: bit-exact everywhere, except
f32 core/accessory `dist` (within 1e-5 of the f64 chain, as for DNA)."""

import contextlib
import gzip
import json
import math
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from sketchtpu import cli as jax_cli
from sketchtpu.hash import aahash_np as jax_aahash_np
from sketchtpu.hash.aahash_jax import AA_COMPACT as JAX_AA_COMPACT
from sketchtpu.hash.aahash_jax import aa_hash_bin_kernel_devmask, aa_tap_tables_u32
from sketchtpu.hash.nthash_jax import MAX_K, combine_bin_minima
from sketchtpu.ingest import fastx as jax_fastx
from sketchtpu.sketchcore.sketch import sketch_aa_sample as jax_sketch_aa_sample
from sketchtpu.sketchcore.sketch_aa_jax import (
    DeviceAaSketchBackend as JaxAaBackend,
)
from sketchtpu.sketchcore.sketch_jax import (
    DeviceSketchBackend as JaxDnaBackend,
    _bucket_size,
    _exact_rows,
)
from sketchtpu_torch.hash import aahash_torch
from sketchtpu_torch.hash.aahash_np import aahash_valid
from sketchtpu_torch.hash.aahash_torch import (
    AA_COMPACT,
    aahash_bin_multi,
    aahash_bin_multi_ref,
    pack_aa_group,
)
from sketchtpu_torch.ingest import fastx
from sketchtpu_torch.ingest.fastx import AaStream
from sketchtpu_torch.sketchcore import sketch_torch
from sketchtpu_torch.sketchcore.signs import bin_minima, signs_from_hashes
from sketchtpu_torch.sketchcore.sketch import sketch_aa_sample
from sketchtpu_torch.sketchcore.sketch_torch import DeviceAaSketchBackend
from sketchtpu_torch.synth import related_proteomes

REPO = Path(__file__).resolve().parent.parent
SEQSEP = 5
LEVELS = [1, 2, 3]
KS = [3, 6, 9, 12, 31]
_LETTERS = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWYacdefghiklmnpqrstvwy",
                         dtype=np.uint8)
ATOL = 1e-5  # f32 core/accessory against the f64 chain


def _stream(rng, n, p_invalid=0.03) -> AaStream:
    seq = _LETTERS[rng.integers(0, _LETTERS.size, n)]
    bad = rng.random(n) < p_invalid
    seq = np.where(bad, SEQSEP, seq).astype(np.uint8)
    return AaStream(seq=seq, invalid_count=int(bad.sum()))


def _raw(text: bytes) -> AaStream:
    seq = np.frombuffer(text, dtype=np.uint8).copy()
    return AaStream(seq=seq, invalid_count=int((seq == SEQSEP).sum()))


def _batch(k: int, seed: int, shorter: bool) -> list[AaStream]:
    """Random samples with invalid residues and separators, samples of
    length k, k + 1 and k + 2, and the final-window quirk's cases: the
    final window emitted (k + 1 valid residues), and a sample whose only
    valid window is its final one, which the oracle refuses (unreachable).
    With `shorter`, also samples shorter than k."""
    rng = np.random.default_rng(seed)
    letters = bytes(_LETTERS[rng.integers(0, 20, k + 2)])
    streams = [_stream(rng, int(n)) for n in rng.integers(k, 400, 6)]
    streams += [_stream(rng, k + d, 0.0) for d in (0, 1, 2)]
    streams += [
        _raw(letters[: k + 1]),                   # final window emitted
        _raw(b"\x05" + letters[:k]),               # only the final window
        _raw(letters[: k + 1] + b"\x05" + letters[:k]),
        _raw(letters[:k] + b"\x05" + letters[: k + 1]),
        _raw(b"*X" + letters[: k + 2]),           # raw invalid bytes
    ]
    if shorter:
        streams += [_stream(rng, max(1, k - 1), 0.0), _stream(rng, 1, 0.0)]
    return streams


def _jax_devmask(streams, k: int, level: int, nbins: int):
    """(minima (samples, nbins) u64, reachable (samples,) bool) of the JAX
    package's XLA device-mask program on JAX's CPU, packed as its backend
    packs a group."""
    total = sum(s.seq_len for s in streams)
    codes = np.zeros(_bucket_size(total + MAX_K), dtype=np.uint8)
    starts, pos = [], 0
    for s in streams:
        codes[pos : pos + s.seq_len] = JAX_AA_COMPACT[s.seq]
        starts.append(pos)
        pos += s.seq_len
    rows = _exact_rows(len(streams))
    starts_pad = np.full(rows, total, dtype=np.int32)
    starts_pad[: len(starts)] = starts
    mh, ml, fd, counts = aa_hash_bin_kernel_devmask(
        codes, starts_pad, np.int32(k), aa_tap_tables_u32(k, level),
        np.int32(total), num_bins=nbins, magic=JaxDnaBackend._magic(nbins),
        out_rows=rows)
    g = len(streams)
    minima = combine_bin_minima(np.asarray(mh).reshape(-1, nbins)[:g],
                                np.asarray(ml).reshape(-1, nbins)[:g],
                                np.asarray(fd).reshape(-1, nbins)[:g])
    return minima, np.asarray(counts)[:g] > 0


def _twin(streams, kmers, level: int, nbins: int):
    codes, starts = pack_aa_group(streams)
    mins, reach = aahash_bin_multi_ref(torch.from_numpy(codes), kmers, level,
                                       torch.from_numpy(starts), nbins)
    return mins.numpy().view(np.uint64), reach.numpy()


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("level", LEVELS)
def test_twin_matches_jax_device_mask_program(level, k):
    """Bins and reachability flags bit for bit against
    aa_hash_bin_kernel_devmask (which takes samples of at least k)."""
    streams = _batch(k, seed=10 * level + k, shorter=False)
    for nbins in (64, 1024):
        mins, reach = _twin(streams, [k], level, nbins)
        want_mins, want_reach = _jax_devmask(streams, k, level, nbins)
        np.testing.assert_array_equal(reach[0] == 1, want_reach)
        assert want_reach.any() and not want_reach.all()
        # an unreachable sample's bins are of no use (the callers raise)
        np.testing.assert_array_equal(mins[0][want_reach],
                                      want_mins[want_reach])


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("level", LEVELS)
def test_twin_matches_host_oracle(level, k):
    """Bins bit for bit against aahash_valid -> bin_minima of both
    packages' oracles, and a flag of 0 exactly where the oracle raises."""
    streams = _batch(k, seed=100 + 10 * level + k, shorter=True)
    mins, reach = _twin(streams, [k], level, 256)
    raised = 0
    for i, s in enumerate(streams):
        try:
            hashes = aahash_valid(s, k, level)
        except ValueError:
            with pytest.raises(ValueError, match="K-mer larger"):
                jax_aahash_np.aahash_valid(
                    jax_fastx.AaStream(seq=s.seq), k, level)
            assert reach[0, i] == 0
            raised += 1
            continue
        np.testing.assert_array_equal(
            hashes, jax_aahash_np.aahash_valid(jax_fastx.AaStream(seq=s.seq),
                                               k, level))
        assert reach[0, i] == 1
        np.testing.assert_array_equal(
            mins[0, i], bin_minima(signs_from_hashes(hashes), 256))
    assert raised >= 3  # the final-only sample and the two shorter ones


def test_twin_multi_k_rows_are_the_single_k_rows():
    streams = _batch(9, seed=3, shorter=True)
    mins, reach = _twin(streams, [12, 3, 9, 3], 2, 128)
    for row, k in enumerate([12, 3, 9, 3]):
        one_mins, one_reach = _twin(streams, [k], 2, 128)
        np.testing.assert_array_equal(mins[row], one_mins[0])
        np.testing.assert_array_equal(reach[row], one_reach[0])


def test_twin_is_the_wrapper_on_cpu():
    streams = _batch(6, seed=4, shorter=False)
    codes, starts = (torch.from_numpy(a) for a in pack_aa_group(streams))
    before = aahash_bin_multi.launches
    got = aahash_bin_multi(codes, [6, 9], 3, starts, 64)
    want = aahash_bin_multi_ref(codes, [6, 9], 3, starts, 64)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert aahash_bin_multi.launches == before
    with pytest.raises(ValueError, match="level"):
        aahash_bin_multi(codes, [6], 4, starts, 64)


def test_packer_codes_and_flags():
    """AA_COMPACT is the JAX package's; a packed byte is the code, the
    invalid flag on every code-20 byte, the start flag on each sample's
    first residue."""
    np.testing.assert_array_equal(AA_COMPACT, JAX_AA_COMPACT)
    streams = [_raw(b"Ac\x05Y"), _raw(b"*w"), _raw(b"QQ")]
    codes, starts = pack_aa_group(streams)
    assert starts.tolist() == [0, 4, 6]
    inv, st = aahash_torch.INVALID, aahash_torch.START
    assert codes.tolist() == [0 | st, 1, 20 | inv, 19, 20 | inv | st, 18,
                              13 | st, 13]


def _kernel_model(codes, starts, kmers, level, nbins, nt=4, run=4, tiles=2,
                  smin=True, kg=4, emitted=None):
    """csrc/aahash_bin.cu's control flow in Python integers, at nt threads
    of `run` window starts a tile and `tiles` tiles a block: the span from
    the residue before a tile, the Horner start shared by ascending k, k
    rolled in passes of kg chains by the O(1) roll from the per-k table,
    the barrier rule with the final-window test, reachability marked
    before each sample change and at a pass's end, and the block's filter
    cache of 32-bit keys (sign >> 29) for its first sample in front of the
    minima. `emitted`, when given, collects each emitted (k, start)."""
    from sketchtpu_torch.constants import srol

    m61, umax = (1 << 61) - 1, (1 << 64) - 1
    total, n = len(codes), len(starts)
    ks = sorted(set(kmers))
    tab = [int(w) for w in aahash_torch._k_table(tuple(ks), level).view(
        np.uint64)]
    kw = 33
    seed = tab[len(ks) * kw:]
    out = [[[umax] * nbins for _ in range(n)] for _ in ks]
    reach = [[0] * n for _ in ks]
    binsize = aahash_torch.bin_size(nbins)

    def sample_of(s):
        return int(np.searchsorted(starts, s, side="right")) - 1

    per_block = tiles * nt * run
    for first in range(0, total - ks[0] + 1, per_block):
        gtab = sample_of(first) if smin else -1
        cache = [[(1 << 32) - 1] * nbins for _ in range(min(kg, len(ks)))]
        for tile in range(tiles):
            base = first + tile * nt * run
            if base >= total:
                break
            for tid in range(nt):
                s0 = base + tid * run

                def rb(j):  # residue s0 + j, 0 past the batch
                    p = s0 + j
                    return int(codes[p]) if 0 <= p < total else 0

                fh, j = 0, 0
                b = rb(-1)
                bar = 0 if b & 0x20 else (-1 if b & 0x40 else -2)
                trel = total - s0
                for k0 in range(0, len(ks), kg):
                    kc = min(kg, len(ks) - k0)
                    kk, f, lb = ks[k0 : k0 + kc], [0] * kc, [0] * kc
                    for c in range(kc):
                        if trel - kk[c] + 1 > 0:
                            while j < kk[c]:
                                b = rb(j)
                                bar = j + 1 if b & 0x20 else (
                                    j if b & 0x40 else bar)
                                fh = srol(fh, 1) ^ seed[b & 31]
                                j += 1
                            f[c], lb[c] = fh, bar
                    nw0 = max(0, min(trel - kk[0] + 1, run))
                    g = sample_of(s0)
                    nrel = (starts[g + 1] if g + 1 < n else total) - s0
                    seen = set()
                    for w in range(nw0):
                        for c in range(kc):
                            if w and w + kk[c] <= trel:
                                bo, bi = rb(w - 1), rb(w + kk[c] - 1)
                                lb[c] = w + kk[c] if bi & 0x20 else (
                                    w + kk[c] - 1 if bi & 0x40 else lb[c])
                                t = tab[(k0 + c) * kw : (k0 + c) * kw + 32]
                                f[c] = srol(f[c], 1) ^ t[bo & 31] ^ seed[
                                    bi & 31]
                        while w >= nrel and g + 1 < n:
                            for c in seen:
                                reach[k0 + c][g] = 1
                            seen = set()
                            g += 1
                            nrel = (starts[g + 1] if g + 1 < n else total) - s0
                        for c in range(kc):
                            valid = w + kk[c] <= trel and lb[c] <= w
                            fin = w + kk[c] == nrel
                            if valid and not fin:
                                seen.add(c)
                            if not valid or (fin and lb[c] == w):
                                continue
                            if emitted is not None:
                                emitted.add((kk[c], s0 + w))
                            x = (f[c] & m61) + (f[c] >> 61)
                            x -= m61 if x >= m61 else 0
                            key = x // binsize
                            plane = out[k0 + c][g]
                            if g == gtab:
                                if x >> 29 <= cache[c][key]:
                                    cache[c][key] = x >> 29
                                    plane[key] = min(plane[key], x)
                            else:
                                plane[key] = min(plane[key], x)
                    for c in seen:
                        reach[k0 + c][g] = 1
                    if len(ks) > kg:
                        cache = [[(1 << 32) - 1] * nbins for _ in range(kc)]
    rows = [ks.index(k) for k in kmers]
    return (np.array(out, dtype=np.uint64)[rows].view(np.int64),
            np.array(reach, dtype=np.int32)[rows])


@pytest.mark.parametrize("seed", range(6))
def test_kernel_model_matches_twin(seed):
    """The kernel's barrier rule and final-window test, run, tile and
    block edges included, the k passes and the filter cache, against the
    twin (bit-exact): random batches with separators, invalid residues and
    the quirk's samples."""
    rng = np.random.default_rng(seed)
    streams = [_stream(rng, int(n), float(rng.choice([0, 0.05, 0.3])))
               for n in rng.integers(1, 80, int(rng.integers(1, 8)))]
    streams += [_raw(b"\x05ACDEF"), _raw(b"ACDEF"), _raw(b"ACDEFG")]
    codes, starts = pack_aa_group(streams)
    kmers = [int(k) for k in rng.choice([3, 4, 5, 6, 9, 12],
                                        int(rng.integers(1, 4)), False)]
    level = int(rng.integers(1, 4))
    want = aahash_bin_multi_ref(torch.from_numpy(codes), kmers, level,
                                torch.from_numpy(starts), 64)
    for smin, kg in ((True, 4), (False, 4), (True, 1)):
        mins, reach = _kernel_model(codes, starts, kmers, level, 64,
                                    smin=smin, kg=kg)
        np.testing.assert_array_equal(mins, want[0].numpy())
        np.testing.assert_array_equal(reach, want[1].numpy())


@pytest.mark.parametrize("run,tiles", [(4, 1), (4, 3), (12, 2)])
def test_kernel_model_windows_are_the_oracles(run, tiles):
    """Samples whose edges fall on run, tile and block edges (lengths of
    whole runs and tiles, one past, one short): the model's emitted
    windows are exactly the JAX package's aa_window_valid ones in every
    sample, each start once, and reach is 0 exactly where it raises."""
    nt, kmers = 4, [3, 5, 8]
    rng = np.random.default_rng(run * 10 + tiles)
    tile = nt * run
    lens = [tile, run + 1, tiles * tile - 1, 2 * run, 9, tile + 1, 4,
            run - 1 if run > 4 else 7]
    streams = [_stream(rng, n, 0.08) for n in lens]
    streams[1] = _raw(b"\x05" + bytes(_LETTERS[:run]))  # the quirk
    codes, starts = pack_aa_group(streams)
    emitted = set()
    _, reach = _kernel_model(codes, starts, kmers, 2, 64, nt=nt, run=run,
                             tiles=tiles, emitted=emitted)
    assert len(emitted) == len(set(emitted))
    for ki, k in enumerate(kmers):
        got = {s for kk, s in emitted if kk == k}
        for g, st in enumerate(streams):
            mine = sorted(p - starts[g] for p in got
                          if starts[g] <= p < starts[g] + len(st.seq))
            try:
                mask = jax_aahash_np.aa_window_valid(st.seq, k)
            except ValueError:
                assert reach[ki, g] == 0
                continue
            assert reach[ki, g] == 1
            assert mine == np.flatnonzero(mask).tolist(), (k, g)


@pytest.mark.parametrize("windows", [1, 255, 256 * 4 + 1, 9_000_000,
                                     19_199_000, 77_777_777])
@pytest.mark.parametrize("slots", [1, 660, 528])
def test_run_shape_is_one_wave_that_covers_every_start(windows, slots):
    """run_shape's runs have run / 4 odd (a warp's byte reads on 32 banks)
    and at most 60 starts; its blocks of `tiles` tiles of 256 runs cover
    every window start exactly once (starts past the batch hold no
    window) in one wave of at most `slots` blocks."""
    run, tiles = aahash_torch.run_shape(windows, slots, 12, 3)
    assert run in aahash_torch._RUNS and run % 8 == 4 and run <= 60
    per_block = tiles * 256 * run
    blocks = -(-windows // per_block)
    assert blocks <= slots and (blocks - 1) * per_block < windows
    # block b, tile t, thread i, window w: start b * per_block + t * 256
    # run + i * run + w, a bijection onto [0, blocks * per_block)
    b, t, i, w = np.meshgrid(np.arange(min(blocks, 3)), np.arange(tiles),
                             np.arange(256), np.arange(run), indexing="ij")
    s = (b * per_block + t * 256 * run + i * run + w).ravel()
    assert np.array_equal(np.sort(s), np.arange(min(blocks, 3) * per_block))


def test_pow2_shift_is_the_exact_bin():
    """For every power-of-two nbins the kernel takes (a C int), sign >>
    pow2_shift(nbins) is sign // bin_size(nbins) at the edges of every bin
    and at random signs below 2^61 - 1; any other nbins has no shift."""
    m61 = (1 << 61) - 1
    rng = np.random.default_rng(5)
    rand = [int(x) for x in rng.integers(0, m61, 2000, dtype=np.int64)]
    for p in range(31):
        nbins = 1 << p
        d = aahash_torch.bin_size(nbins)
        shift = aahash_torch.pow2_shift(nbins)
        assert d == 1 << shift or (nbins == 1 and d == m61)
        for b in {0, 1, nbins // 2, nbins - 1}:
            for x in (b * d - 1, b * d, b * d + 1, (b + 1) * d - 1):
                if 0 <= x < m61:
                    assert x >> shift == x // d
        assert all(x >> shift == x // d for x in rand + [m61 - 1])
    for nbins in (3, 1000, 1023, 1025, 24 * 64, 625 * 64):
        assert aahash_torch.pow2_shift(nbins) == -1


class _FakeCuda:
    """Stands in for a CUDA tensor: the wrapper reads only device, dtype,
    shape and contiguity before it dispatches."""

    def __init__(self, t: torch.Tensor):
        self._t = t
        self.device = torch.device("cuda", 0)
        self.dtype = t.dtype
        self.shape = t.shape

    def dim(self):
        return self._t.dim()

    def numel(self):
        return self._t.numel()

    def is_contiguous(self):
        return self._t.is_contiguous()


def _refuse_twin(*_a, **_kw):
    raise AssertionError("the twin ran for a CUDA tensor")


def test_wrapper_launches_for_cuda_tensors(monkeypatch):
    """CUDA tensors go to the launcher, one launch per 128 ascending k;
    the rows come back in the caller's k order; past MAX_K_AA_CUDA the
    wrapper refuses."""
    calls = []
    full, zeros = torch.full, torch.zeros

    def launch(codes, ks, level, starts, nbins, out, reach):
        calls.append((ks, level, nbins))
        out.copy_(torch.tensor(ks)[:, None, None].expand_as(out))
        reach.copy_(torch.tensor(ks, dtype=torch.int32)[:, None].expand_as(
            reach))

    monkeypatch.setattr(aahash_torch, "aahash_bin_multi_ref", _refuse_twin)
    monkeypatch.setattr(aahash_torch, "_launch", launch)
    monkeypatch.setattr(torch, "full",
                        lambda *a, device=None, **kw: full(*a, **kw))
    monkeypatch.setattr(torch, "zeros",
                        lambda *a, device=None, **kw: zeros(*a, **kw))
    codes = _FakeCuda(torch.zeros(500, dtype=torch.uint8))
    starts = _FakeCuda(torch.zeros(2, dtype=torch.int64))
    before = aahash_bin_multi.launches
    kmers = list(range(132, 2, -1))  # 130 k, descending
    mins, reach = aahash_bin_multi(codes, kmers, 2, starts, 64)
    assert aahash_bin_multi.launches == before + 2
    assert [c[0] for c in calls] == [list(range(3, 131)), [131, 132]]
    assert mins[:, 0, 0].tolist() == kmers
    assert reach[:, 1].tolist() == kmers
    with pytest.raises(ValueError, match="limit"):
        aahash_bin_multi(codes, [aahash_torch.MAX_K_AA_CUDA + 1], 1, starts,
                         64)


# --- the backend --------------------------------------------------------


def _assert_sketches_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.name, a.densified, a.seq_length, a.non_acgt, a.acgt,
                a.reads) == (b.name, b.densified, b.seq_length, b.non_acgt,
                             tuple(b.acgt), b.reads)
        np.testing.assert_array_equal(a.usigs, b.usigs)


@pytest.mark.parametrize("level", LEVELS)
def test_backend_matches_jax_backend_and_host(level):
    """DeviceAaSketchBackend on CPU tensors against the JAX package's
    DeviceAaSketchBackend (XLA on JAX's CPU) and both host oracles: same
    usigs, densified flag, seq_length and non_acgt (bit-exact)."""
    rng = np.random.default_rng(level)
    streams = [_stream(rng, n) for n in (40, 97, 513, 64, 2048, 31, 300,
                                         1200, 55)]
    names = [f"s{i}" for i in range(len(streams))]
    kmers = [6, 9, 14]
    got = DeviceAaSketchBackend(torch.device("cpu")).sketch_aa_streams(
        streams, names, kmers, 64, level, rc=True)
    jax_streams = [jax_fastx.AaStream(seq=s.seq, invalid_count=s.invalid_count)
                   for s in streams]
    _assert_sketches_equal(got, JaxAaBackend().sketch_aa_streams(
        jax_streams, names, kmers, 64, level, rc=True))
    _assert_sketches_equal(got, [
        jax_sketch_aa_sample(s, n, kmers, 64, level)
        for s, n in zip(jax_streams, names)])
    _assert_sketches_equal(got, [
        sketch_aa_sample(s, n, kmers, 64, level)
        for s, n in zip(streams, names)])


def test_backend_batches_equal_one_batch(monkeypatch):
    """Batches of at most 3 samples or 600 residues (a longer sample is a
    batch by itself) give the same sketches as one batch."""
    rng = np.random.default_rng(5)
    streams = [_stream(rng, int(n)) for n in rng.integers(20, 900, 11)]
    names = [f"s{i}" for i in range(len(streams))]
    backend = DeviceAaSketchBackend(torch.device("cpu"))
    want = backend.sketch_aa_streams(streams, names, [5, 8], 128, 1, True)
    launches = []
    monkeypatch.setattr(sketch_torch, "_MAX_GROUP", 3)
    monkeypatch.setattr(sketch_torch, "_BATCH_BASES", 600)
    dispatch = backend._dispatch
    monkeypatch.setattr(backend, "_dispatch",
                        lambda g, *a: launches.append(len(g)) or dispatch(g, *a))
    _assert_sketches_equal(
        backend.sketch_aa_streams(streams, names, [5, 8], 128, 1, True), want)
    assert len(launches) > 3 and max(launches) <= 3


@pytest.mark.parametrize("case", ["final_only", "shorter_than_k",
                                  "empty"])
def test_backend_raises_where_the_host_oracle_raises(case):
    streams = {"final_only": [_raw(b"ACDEFGHIK"), _raw(b"\x05ACDEFG")],
               "shorter_than_k": [_raw(b"ACDEFGHIK"), _raw(b"ACDE")],
               "empty": [_raw(b"ACDEFGHIK"), _raw(b"")]}[case]
    names = ["a", "b"]
    match = "has no valid sequence" if case == "empty" else "K-mer larger"
    with pytest.raises(ValueError, match=match):
        sketch_aa_sample(streams[1], "b", [6], 64, 1)
    with pytest.raises(ValueError, match=match):
        DeviceAaSketchBackend(torch.device("cpu")).sketch_aa_streams(
            streams, names, [6], 64, 1, True)


# --- ingest -------------------------------------------------------------


def _write_faa(path: Path, gz: bool) -> Path:
    text = (b">p1 first\nACDEFghik\nLMNPQ*XRST\n\n>p2\nvwyACD\n"
            b">empty\n>p3\r\nMK\x05LB\r\n>p4\nACDEFGHIKLMNPQRSTVWY\n")
    path.write_bytes(gzip.compress(text) if gz else text)
    return path


def _same_streams(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.seq, b.seq)
        assert a.invalid_count == b.invalid_count


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("concat", [False, True])
@pytest.mark.parametrize("gz", [False, True])
def test_read_aa_sample_matches_jax(tmp_path, monkeypatch, gz, concat,
                                    native):
    """The port's read_aa_sample (its native stpu_parse_aa, or its Python
    parser) against sketchtpu.ingest.fastx on two files: the same streams,
    SEQSEP after each record without --concat-fasta, one stream a record
    with it."""
    files = [str(_write_faa(tmp_path / f"a{i}.faa{'.gz' if gz else ''}", gz))
             for i in range(2)]
    if not native:
        monkeypatch.setattr(fastx, "_parse_aa_native", lambda _p: None)
    got = fastx.read_aa_sample(files, concat)
    _same_streams(got, jax_fastx.read_aa_sample(files, concat))
    assert len(got) == (10 if concat else 1)


@pytest.mark.parametrize("native", [True, False])
def test_fastq_as_aa_input_is_refused(tmp_path, monkeypatch, native):
    path = tmp_path / "r.fq"
    path.write_bytes(b"@r1\nACDE\n+\nIIII\n")
    if not native:
        monkeypatch.setattr(fastx, "_parse_aa_native", lambda _p: None)
    for reader in (fastx.read_aa_sample, jax_fastx.read_aa_sample):
        with pytest.raises(ValueError, match="Unexpected quality"):
            reader([str(path)], False)


def test_native_parse_aa_is_the_jax_packages(tmp_path):
    """stpu_parse_aa of the port's host helper against the JAX package's
    native parser (record bytes, offsets, invalid count)."""
    from sketchtpu_torch._native import get_lib

    assert get_lib() is not None
    path = str(_write_faa(tmp_path / "a.faa", False))
    seq, ends, invalid = fastx._parse_aa_native(path)
    records, counts = jax_fastx._parse_aa_native(path)
    assert ends.tolist() == np.cumsum([r.size for r in records]).tolist()
    np.testing.assert_array_equal(seq, np.concatenate(records))
    assert invalid == sum(counts) == 4


def test_aa_stream_from_string_keeps_raw_bytes():
    got = fastx.aa_stream_from_string("ACD,EFG")
    want = jax_fastx.aa_stream_from_string("ACD,EFG")
    np.testing.assert_array_equal(got.seq, want.seq)
    assert got.invalid_count == want.invalid_count == 0


# --- the CLI ------------------------------------------------------------

AA_KMERS = "6,9,12"
SKETCHES = ([f"aa_l{lv}" for lv in LEVELS] + [f"cat_l{lv}" for lv in LEVELS]
            + ["pdb", "q", "appended"])
DIST_MODES = {"k9": ["-k", "9"], "ani": ["-k", "9", "--ani"],
              "exact": ["--exact"], "knn_k9": ["-k", "9", "--knn", "3"],
              "knn_coreacc": ["--knn", "3"]}


def _aa_commands(d: Path, prefix: str) -> list[list[str]]:
    p = str(d / prefix)
    common = ["-k", AA_KMERS, "-s", "256", "--quiet"]
    cmds = []
    for lv in LEVELS:
        for tag, extra in (("aa", []), ("cat", ["--concat-fasta"])):
            cmds.append(["sketch", "-f", str(d / "rfile.txt"), "-o",
                         f"{p}{tag}_l{lv}", "--seq-type", "aa", "--level",
                         f"level{lv}", *extra, *common])
    cmds.append(["sketch", "-f", str(d / "rfile_3di.txt"), "-o", f"{p}pdb",
                 "--seq-type", "pdb", *common])
    cmds.append(["sketch", "-f", str(d / "rfile_q.txt"), "-o", f"{p}q",
                 "--seq-type", "aa", *common])
    cmds.append(["append", f"{p}aa_l1", "-f", str(d / "rfile_x.txt"), "-o",
                 f"{p}appended", "--quiet"])
    for name, flags in {**DIST_MODES, "coreacc": []}.items():
        cmds.append(["dist", f"{p}aa_l1", *flags, "-o",
                     f"{p}self_{name}.txt", "--quiet"])
        cmds.append(["dist", f"{p}aa_l1", f"{p}q", *flags, "-o",
                     f"{p}cross_{name}.txt", "--quiet"])
    cmds.append(["dist", f"{p}pdb", "-k", "6", "-o", f"{p}pdb_k6.txt",
                 "--quiet"])
    return cmds


_PORT_RUN = """
import json, sys
from sketchtpu_torch.cli import main
for argv in json.loads(sys.argv[1]):
    assert main(argv) == 0, argv
assert "jax" not in sys.modules, "the port loaded jax"
assert not [m for m in sys.modules if m.split(".")[0] == "sketchtpu"], \\
    "the port loaded the JAX package"
print("PORT-RUN-OK")
"""


def _port_run(d: Path, mode: str, cmds) -> subprocess.CompletedProcess:
    env = {**os.environ, "SKETCHTPU_TORCH_BACKEND": mode,
           "PYTHONPATH": str(REPO)}
    return subprocess.run([sys.executable, "-c", _PORT_RUN, json.dumps(cmds)],
                          env=env, capture_output=True, text=True,
                          timeout=600, cwd=d)


@pytest.fixture(scope="module")
def aa_runs(tmp_path_factory):
    """Proteomes (lower case, 'X' / '*' residues, several wrapped records),
    3Di text files and a query and an append set, sketched and compared by
    the port in cpu and host mode and by the JAX package's host oracle."""
    d = tmp_path_factory.mktemp("torch_aa")
    rfile = related_proteomes(d / "faa", 6, 30, 200, seed=21,
                              invalid=0.003)
    lines = rfile.read_text().splitlines()
    (d / "rfile.txt").write_text(rfile.read_text())
    (d / "rfile_q.txt").write_text("\n".join(lines[3:]) + "\n")
    extra = related_proteomes(d / "faa_x", 2, 20, 150, seed=22, gzipped=True)
    (d / "rfile_x.txt").write_text("".join(
        f"extra_{i}\t{ln.split(chr(9))[1]}\n"
        for i, ln in enumerate(extra.read_text().splitlines())))
    rng = np.random.default_rng(23)
    di = []
    for i in range(3):
        path = d / f"s{i}.3di"
        text = b"".join(b">%d\n%s\n" % (r, bytes(_LETTERS[rng.integers(
            0, 20, 120)])) for r in range(4))
        path.write_bytes(text)
        di.append(f"struct_{i}\t{path}\n")
    (d / "rfile_3di.txt").write_text("".join(di))
    procs = {mode: _port_run(d, mode, _aa_commands(d, f"{mode}_"))
             for mode in ("cpu", "host")}
    for mode, proc in procs.items():
        assert proc.returncode == 0, (mode, proc.stderr[-3000:])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SKETCHTPU_BACKEND", "host")
        for argv in _aa_commands(d, "oracle_"):
            assert jax_cli.main(argv) == 0, argv
    return d, {m: p.stdout for m, p in procs.items()}


@pytest.mark.parametrize("mode", ["cpu", "host"])
def test_aa_port_run_never_loads_jax(aa_runs, mode):
    assert "PORT-RUN-OK" in aa_runs[1][mode]


@pytest.mark.parametrize("ext", [".skd", ".skm"])
@pytest.mark.parametrize("db", SKETCHES)
@pytest.mark.parametrize("mode", ["cpu", "host"])
def test_aa_sketch_files_identical_to_host(aa_runs, mode, db, ext):
    d = aa_runs[0]
    port = (d / f"{mode}_{db}{ext}").read_bytes()
    assert port and port == (d / f"oracle_{db}{ext}").read_bytes()


@pytest.mark.parametrize("side", ["self", "cross"])
@pytest.mark.parametrize("name", list(DIST_MODES))
@pytest.mark.parametrize("mode", ["cpu", "host"])
def test_aa_dist_byte_identical(aa_runs, mode, name, side):
    d = aa_runs[0]
    port = (d / f"{mode}_{side}_{name}.txt").read_bytes()
    assert port and port == (d / f"oracle_{side}_{name}.txt").read_bytes()


def _table(path):
    rows = [ln.split("\t") for ln in path.read_text().splitlines()]
    return [r[:2] for r in rows], np.array([[float(v) for v in r[2:]]
                                            for r in rows])


@pytest.mark.parametrize("side", ["self", "cross"])
def test_aa_dist_coreacc_within_tolerance(aa_runs, side):
    """The f32 engine (cpu mode) within 1e-5 of the f64 chain; host mode
    byte-identical."""
    d = aa_runs[0]
    names, got = _table(d / f"cpu_{side}_coreacc.txt")
    want_names, want = _table(d / f"oracle_{side}_coreacc.txt")
    assert names == want_names and got.shape == want.shape and got.size
    assert ((got[:, 0] > 0) & (got[:, 0] < 1)).any()  # fitted pairs exist
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert (d / f"host_{side}_coreacc.txt").read_bytes() == (
        d / f"oracle_{side}_coreacc.txt").read_bytes()


def test_aa_dist_on_the_3di_database(aa_runs):
    d = aa_runs[0]
    for mode in ("cpu", "host"):
        port = (d / f"{mode}_pdb_k6.txt").read_bytes()
        assert port and port == (d / "oracle_pdb_k6.txt").read_bytes()


@pytest.mark.parametrize("mode", ["cpu", "host"])
def test_aa_sketch_refused_where_the_host_oracle_refuses(tmp_path, mode,
                                                         monkeypatch):
    """--concat-fasta on a record whose only valid window is its final
    one: both packages fail with the reference's set_k panic."""
    faa = tmp_path / "x.faa"
    faa.write_bytes(b">ok\nACDEFGHIKLMNPQ\n>final_only\nXACDEFGHI\n")
    argv = ["sketch", str(faa), "-o", str(tmp_path / "x"), "--seq-type",
            "aa", "--concat-fasta", "-k", "8", "-s", "64", "--quiet"]
    proc = _port_run(tmp_path, mode, [argv])
    assert proc.returncode != 0
    assert "K-mer larger than smallest valid sequence" in proc.stderr
    monkeypatch.setenv("SKETCHTPU_BACKEND", "host")
    with pytest.raises(ValueError, match="K-mer larger"):
        jax_cli.main(argv)


# --- --convert-pdb with stand-in mini3di / Bio.PDB ------------------------
# A copy of tests/test_pdb3di_e2e.py's stand-ins: a fixed-column PDB parser
# and a deterministic geometry encoder over mini3di's Encoder API.

ALPHABET = "ACDEFGHIKLMNPQRSTVWY"


def _helix(n: int, phase: float):
    return [(2.3 * math.cos(0.9 * i + phase), 2.3 * math.sin(0.9 * i + phase),
             1.5 * i + 0.37 * (i * i % 7)) for i in range(n)]


_CA_A, _CA_B, _CA_C = _helix(40, 0.0), [(20.0, 20.0, 20.0)], _helix(25, 1.3)


def _pdb_text() -> str:
    lines = []
    serial = 1
    for chain, cas in (("A", _CA_A), ("B", _CA_B), ("C", _CA_C)):
        for i, (x, y, z) in enumerate(cas, start=1):
            lines.append(f"ATOM  {serial:>5} CA   ALA {chain}{i:>4}    "
                         f"{x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00           C")
            serial += 1
        lines.append("TER")
    lines.append("END")
    return "\n".join(lines) + "\n"


def _encode_states(cas) -> list[int]:
    if len(cas) < 2:
        raise IndexError("chain too short to encode")
    return [int(math.dist(cas[i], cas[i + 1]) * 7.3) % 20
            for i in range(len(cas) - 1)]


def _install_fakes(monkeypatch):
    class _Atom:
        def __init__(self, name, coord):
            self.name = name
            self.coord = coord

    class _Chain:
        def __init__(self, cid):
            self.id = cid
            self.residues = []

        def __iter__(self):
            return iter(self.residues)

        def __repr__(self):
            return f"<Chain id={self.id}>"

    class _Structure:
        def __init__(self, chains):
            self._chains = chains

        def get_chains(self):
            return iter(self._chains)

    class PDBParser:
        def __init__(self, QUIET=False):
            pass

        def get_structure(self, name, filename):
            chains, residues = {}, {}
            with open(filename) as fh:
                for line in fh:
                    if not line.startswith("ATOM"):
                        continue
                    cid, resseq = line[21], int(line[22:26])
                    xyz = (float(line[30:38]), float(line[38:46]),
                           float(line[46:54]))
                    chain = chains.setdefault(cid, _Chain(cid))
                    if (cid, resseq) not in residues:
                        residues[cid, resseq] = []
                        chain.residues.append(residues[cid, resseq])
                    residues[cid, resseq].append(
                        _Atom(line[12:16].strip(), xyz))
            return _Structure(list(chains.values()))

    class Encoder:
        def encode_chain(self, chain):
            return _encode_states([a.coord for res in chain for a in res
                                   if a.name == "CA"])

        def build_sequence(self, states):
            return "".join(ALPHABET[s] for s in states)

    mini3di = types.ModuleType("mini3di")
    mini3di.Encoder = Encoder
    bio = types.ModuleType("Bio")
    bio_pdb = types.ModuleType("Bio.PDB")
    bio_pdb.PDBParser = PDBParser
    bio.PDB = bio_pdb
    monkeypatch.setitem(sys.modules, "mini3di", mini3di)
    monkeypatch.setitem(sys.modules, "Bio", bio)
    monkeypatch.setitem(sys.modules, "Bio.PDB", bio_pdb)


def test_pdb_to_3di_matches_jax(tmp_path, monkeypatch):
    """Per-chain encode, comma join, chains that cannot be encoded warned
    and skipped, as in the JAX package."""
    from sketchtpu.ingest.pdb3di import pdb_to_3di as jax_pdb_to_3di
    from sketchtpu_torch.ingest.pdb3di import pdb_to_3di

    _install_fakes(monkeypatch)
    pdb = tmp_path / "toy.pdb"
    pdb.write_text(_pdb_text())
    with pytest.warns(RuntimeWarning, match="Not able to code"):
        got = pdb_to_3di("toy", str(pdb))
    with pytest.warns(RuntimeWarning, match="Not able to code"):
        assert got == jax_pdb_to_3di("toy", str(pdb))
    assert got.count(",") == 1


def test_pdb_to_3di_without_the_packages_raises(monkeypatch):
    from sketchtpu_torch.ingest.pdb3di import pdb_to_3di

    monkeypatch.setitem(sys.modules, "mini3di", None)
    with pytest.raises(RuntimeError, match="mini3di"):
        pdb_to_3di("x", "x.pdb")


@pytest.mark.parametrize("mode", ["cpu", "host"])
def test_convert_pdb_sketch_identical_to_host(tmp_path, monkeypatch, mode):
    """`sketch --seq-type pdb --convert-pdb` of two structures (one of two
    files) in the port's cpu and host mode against the JAX CLI on its host
    oracle: .skd and .skm byte-identical."""
    from sketchtpu_torch.cli import main as port_main

    _install_fakes(monkeypatch)
    paths = []
    for i in range(3):
        pdb = tmp_path / f"s{i}.pdb"
        pdb.write_text(_pdb_text() if i != 1 else _pdb_text().replace(
            " 1.00  0.00", " 1.00  0.50"))
        paths.append(str(pdb))
    rfile = tmp_path / "rfile.txt"
    rfile.write_text(f"one\t{paths[0]}\ntwo\t{paths[1]}\t{paths[2]}\n")
    argv = ["sketch", "-f", str(rfile), "--seq-type", "pdb", "--convert-pdb",
            "-k", "3,5", "-s", "64", "--quiet", "-o"]
    monkeypatch.setenv("SKETCHTPU_TORCH_BACKEND", mode)
    monkeypatch.setenv("SKETCHTPU_BACKEND", "host")
    with contextlib.ExitStack() as stack:
        stack.enter_context(pytest.warns(RuntimeWarning))
        assert port_main(argv + [str(tmp_path / "port")]) == 0
        assert jax_cli.main(argv + [str(tmp_path / "oracle")]) == 0
    for ext in (".skd", ".skm"):
        port = (tmp_path / f"port{ext}").read_bytes()
        assert port and port == (tmp_path / f"oracle{ext}").read_bytes()
