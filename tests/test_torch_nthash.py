"""ntHash bin minima: the port's twin (and its wrapper on CPU tensors)
against the JAX hash_bin_kernel + combine_bin_minima and against the host
oracle, bit-exact; and the port's sketch backend against the host
sketches. Each package parses the same files into its own streams."""

from pathlib import Path

import numpy as np
import pytest
import torch

from sketchtpu.hash.nthash_jax import (
    combine_bin_minima,
    hash_bin_kernel,
    tap_tables_u32,
)
from sketchtpu.hash.nthash_np import nthash_valid
from sketchtpu.ingest.fastx import DnaStream, read_dna_sample
from sketchtpu.sketchcore.signs import bin_minima, signs_from_hashes
from sketchtpu.sketchcore.sketch import sketch_dna_sample
from sketchtpu.sketchcore.sketch_jax import DeviceSketchBackend, bin_magic
from sketchtpu_torch.constants import (
    NT_HASH_SEEDS,
    NT_RC_HASH_SEEDS,
    SIGN_MOD,
    nt_tap_tables,
    srol,
)
from sketchtpu_torch.hash.nthash_torch import (
    _k_table,
    _smem_bytes,
    _span_pitch,
    bin_size,
    magic_div,
    magic_divisor,
    nthash_bin,
    nthash_bin_multi,
    pack_group,
    tap_tables,
)
from sketchtpu_torch.ingest import fastx as port_fastx
from sketchtpu_torch.sketchcore.sketch_torch import (
    DeviceSketchBackend as TorchSketchBackend,
)
from sketchtpu_torch.synth import related_assemblies

NBINS = 1024


@pytest.fixture(scope="module")
def both_streams(tmp_path_factory):
    """Parsed assemblies with N runs and several records each, plus a
    genome shorter than most k: (the JAX package's streams, the port's)."""
    rfile = related_assemblies(tmp_path_factory.mktemp("nthash"), 3, 20000,
                               seed=9, max_contigs=6)
    paths = [ln.split("\t")[1] for ln in rfile.read_text().splitlines()]
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 4, 60).astype(np.uint8)
    out = []
    for read, stream_cls in ((read_dna_sample, DnaStream),
                             (port_fastx.read_dna_sample, port_fastx.DnaStream)):
        parsed = [read([p]) for p in paths]
        assert all(s.breaks.size > 1 for s in parsed)
        parsed.append(stream_cls(codes=codes, breaks=np.array([12, 60]),
                                 acgt=np.bincount(codes, minlength=4)))
        out.append(parsed)
    for j, p in zip(*out):
        np.testing.assert_array_equal(j.codes, p.codes)
        np.testing.assert_array_equal(j.breaks, p.breaks)
    return out


@pytest.fixture(scope="module")
def streams(both_streams):
    return both_streams[1]


def _port(streams, k, rc):
    seq, starts = pack_group(streams)
    tf, tr = (torch.from_numpy(t) for t in tap_tables(k))
    out = nthash_bin(torch.from_numpy(seq), k, tf, tr, rc,
                     torch.from_numpy(starts), NBINS)
    return out.numpy().view(np.uint64)


@pytest.mark.parametrize("rc", [True, False])
@pytest.mark.parametrize("k", [3, 17, 31, 64])
def test_bin_minima_match_jax_and_oracle(both_streams, k, rc):
    got = _port(both_streams[1], k, rc)
    streams = both_streams[0]
    host = np.stack([
        bin_minima(signs_from_hashes(nthash_valid(s, k, rc)), NBINS)
        for s in streams
    ])
    np.testing.assert_array_equal(got, host)

    g = len(streams)
    packed, breakbits, starts, total = DeviceSketchBackend()._prepare_group(
        streams, k
    )
    taps_fwd, taps_rev = tap_tables_u32(k, rc)
    min_hi, min_lo, found = hash_bin_kernel(
        packed, breakbits, DeviceSketchBackend._pad_starts(starts, total),
        np.int32(total), np.int32(k), taps_fwd, taps_rev, rc=rc,
        num_bins=NBINS, magic=bin_magic(NBINS), out_rows=7,
    )
    jax_minima = combine_bin_minima(
        np.asarray(min_hi).reshape(-1, NBINS)[:g],
        np.asarray(min_lo).reshape(-1, NBINS)[:g],
        np.asarray(found).reshape(-1, NBINS)[:g],
    )
    np.testing.assert_array_equal(got, jax_minima)


def test_window_longer_than_batch_gives_empty_bins(streams):
    got = _port(streams[-1:], 64, True)
    assert (got == np.uint64(2**64 - 1)).all()


def test_sketch_backend_matches_host(both_streams):
    kmers = [17, 21, 29]
    streams = both_streams[0]
    names = [f"g{i}" for i in range(len(streams))]
    dev = TorchSketchBackend(torch.device("cpu")).sketch_dna_streams(
        both_streams[1], names, kmers, 1024, True, 0
    )
    for s, name, d in zip(streams, names, dev):
        h = sketch_dna_sample(s, name, kmers, 1024, True, 0)
        np.testing.assert_array_equal(d.usigs, h.usigs)
        assert (d.seq_length, d.densified, d.acgt, d.non_acgt) == (
            h.seq_length, h.densified, h.acgt, h.non_acgt
        )
    assert dev[-1].densified  # the short genome leaves bins to densify


def test_sketch_backend_sketches_reads(both_streams):
    """A stream flagged as reads takes the in-order signs and the count
    filter (the refusal this replaces is gone): the host oracle's sketch,
    bit for bit, beside an assembly of the same batch."""
    jax_streams, streams = both_streams
    reads = port_fastx.DnaStream(codes=streams[0].codes,
                                 breaks=streams[0].breaks, reads=True)
    jax_reads = DnaStream(codes=jax_streams[0].codes,
                          breaks=jax_streams[0].breaks, reads=True)
    got = TorchSketchBackend(torch.device("cpu")).sketch_dna_streams(
        [reads, streams[1]], ["r", "a"], [17, 21], NBINS, True, 1)
    for sk, js in zip(got, (jax_reads, jax_streams[1])):
        want = sketch_dna_sample(js, "x", [17, 21], NBINS, True, 1)
        assert np.array_equal(sk.usigs, want.usigs)
        assert (sk.reads, sk.seq_length, sk.densified) == \
            (want.reads, want.seq_length, want.densified)
    assert got[0].reads and not got[1].reads


# --- the multi-k entry point ------------------------------------------------

def _jax_minima(streams, k, rc):
    g = len(streams)
    packed, breakbits, starts, total = DeviceSketchBackend()._prepare_group(
        streams, k
    )
    taps_fwd, taps_rev = tap_tables_u32(k, rc)
    min_hi, min_lo, found = hash_bin_kernel(
        packed, breakbits, DeviceSketchBackend._pad_starts(starts, total),
        np.int32(total), np.int32(k), taps_fwd, taps_rev, rc=rc,
        num_bins=NBINS, magic=bin_magic(NBINS), out_rows=7,
    )
    return combine_bin_minima(
        np.asarray(min_hi).reshape(-1, NBINS)[:g],
        np.asarray(min_lo).reshape(-1, NBINS)[:g],
        np.asarray(found).reshape(-1, NBINS)[:g],
    )


@pytest.mark.parametrize("rc", [True, False])
@pytest.mark.parametrize("kmers", [(3,), (17, 19, 21), (31, 64)],
                         ids=lambda ks: "-".join(map(str, ks)))
def test_multi_k_minima_match_jax_and_oracle(both_streams, kmers, rc):
    """nthash_bin_multi (its twin, on CPU tensors) against hash_bin_kernel
    and the NumPy oracle, for every k of the list. The last genome (60
    bases, a break at 12) is shorter than k = 64 and has a break inside
    its windows."""
    seq, starts = pack_group(both_streams[1])
    got = nthash_bin_multi(torch.from_numpy(seq), kmers, rc,
                           torch.from_numpy(starts), NBINS)
    assert got.shape == (len(kmers), len(both_streams[1]), NBINS)
    got = got.numpy().view(np.uint64)
    for ki, k in enumerate(kmers):
        host = np.stack([
            bin_minima(signs_from_hashes(nthash_valid(s, k, rc)), NBINS)
            for s in both_streams[0]
        ])
        np.testing.assert_array_equal(got[ki], host)
        np.testing.assert_array_equal(got[ki],
                                      _jax_minima(both_streams[0], k, rc))
    if max(kmers) > 60:
        assert (got[-1][-1] == np.uint64(2**64 - 1)).all()


def test_multi_k_keeps_the_callers_k_order(streams):
    seq, starts = (torch.from_numpy(x) for x in pack_group(streams))
    up = nthash_bin_multi(seq, (17, 21, 29), True, starts, NBINS)
    mixed = nthash_bin_multi(seq, (29, 17, 21, 17), True, starts, NBINS)
    assert torch.equal(mixed, up[[2, 0, 1, 0]])


# The kernel's arithmetic, modelled with Python integers: the split
# rotation by one as a rotate and a swap of bits 0 and 33, the Horner build
# that extends from one k to the next, the O(1) roll, the last-flag break
# rule and the magic division (csrc/nthash_bin.cu).

_M64 = (1 << 64) - 1


def _srol1(x):
    y = ((x << 1) | (x >> 63)) & _M64
    t = (y ^ (y >> 33)) & 1
    return y ^ (t | (t << 33))


def _sror1(x):
    t = (x ^ (x >> 33)) & 1
    y = x ^ (t | (t << 33))
    return ((y >> 1) | (y << 63)) & _M64


def _srolk(x, r33, r31):
    lo, hi = x & ((1 << 33) - 1), x >> 33
    lo = ((lo << r33) | (lo >> (33 - r33))) & ((1 << 33) - 1)
    hi = ((hi << r31) | (hi >> (31 - r31))) & ((1 << 31) - 1)
    return (hi << 33) | lo


def _kernel_model(seq, kmers, rc, starts, nbins, run):
    """Per-(k, genome, bin) minima by the kernel's recurrences, one run of
    `run` window starts at a time."""
    total = len(seq)
    ks = sorted(kmers)
    tab = _k_table(tuple(ks)).view(np.uint64).tolist()
    seed, rcs = tab[len(ks) * 10 : len(ks) * 10 + 4], tab[len(ks) * 10 + 4 :]
    magic, shift = magic_divisor(bin_size(nbins))
    out = np.full((len(ks), len(starts), nbins), 2**64 - 1, dtype=np.uint64)
    starts = list(starts) + [total]
    for s0 in range(0, total, run):
        fh = v = 0
        j = last = 0
        for ki, k in enumerate(ks):
            t = tab[ki * 10 : ki * 10 + 10]
            assert t[8] == k
            if s0 + k > total:
                continue
            while j < k:
                b = int(seq[s0 + j])
                if j > 0 and b & 4:
                    last = j
                fh = _srol1(fh) ^ seed[b & 3]
                v = _sror1(v ^ rcs[b & 3])
                j += 1
            f, r = fh, _srolk(v, t[9] & 0xFFFFFFFF, t[9] >> 32)
            lf = last
            for w in range(min(run, total - k + 1 - s0)):
                if w > 0:
                    bo = int(seq[s0 + w - 1]) & 3
                    bi = int(seq[s0 + w + k - 1])
                    if bi & 4:
                        lf = w + k - 1
                    f = _srol1(f) ^ t[bo] ^ seed[bi & 3]
                    r = _sror1(r ^ rcs[bo]) ^ t[4 + (bi & 3)]
                if lf > w:
                    continue
                h = min(f, r) if rc else f
                x = (h & SIGN_MOD) + (h >> 61)
                if x >= SIGN_MOD:
                    x -= SIGN_MOD
                b = (x * magic) >> (64 + shift)
                g = max(i for i in range(len(starts) - 1)
                        if starts[i] <= s0 + w)
                out[ki, g, b] = min(int(out[ki, g, b]), x)
    return out


@pytest.mark.parametrize("run", [1, 16, 32])
@pytest.mark.parametrize("rc", [True, False])
def test_rolling_recurrences_match_the_tap_form(run, rc):
    """The kernel's rolling formulation gives the twin's minima bit for
    bit: genome starts and breaks on the first, last and middle window of a
    run, a genome shorter than the largest k, an empty genome."""
    rng = np.random.default_rng(31)
    lens = [run * 3, 45, 0, 7, run * 2 + 1, 130]
    streams = []
    for n in lens:
        codes = rng.integers(0, 4, n).astype(np.uint8)
        brk = np.array(sorted({b for b in (run, run + 1, 2 * run - 1,
                                           run + run // 2, 40) if 0 < b < n}),
                       dtype=np.int64)
        streams.append(port_fastx.DnaStream(codes=codes, breaks=brk,
                                            acgt=np.bincount(codes, minlength=4)))
    seq, starts = pack_group(streams)
    kmers = (3, 5, 17, 33, 64)
    want = nthash_bin_multi(torch.from_numpy(seq), kmers, rc,
                            torch.from_numpy(starts), 64)
    got = _kernel_model(seq, kmers, rc, starts, 64, run)
    np.testing.assert_array_equal(got, want.numpy().view(np.uint64))


def test_split_rotation_steps_match_srol():
    rng = np.random.default_rng(32)
    for x in [int(v) for v in rng.integers(0, 2**64, 50, dtype=np.uint64)] + \
            [1, 1 << 32, 1 << 33, 1 << 63, _M64]:
        assert _srol1(x) == srol(x, 1)
        assert _sror1(srol(x, 1)) == x
        for k in (1, 17, 31, 33, 64, 513, 1023):
            assert _srolk(x, k % 33, k % 31) == srol(x, k)
    fwd, rev = nt_tap_tables(21)
    tab = _k_table((21,)).view(np.uint64)
    assert [int(t) for t in tab[10:14]] == list(NT_HASH_SEEDS)
    assert [int(t) for t in tab[14:18]] == list(NT_RC_HASH_SEEDS)
    assert (tab[4:8] == rev[20]).all()  # srol^(k-1)(RC): the last tap


@pytest.mark.parametrize("nbins", [1, 64, 1000, 1024, 32768 + 64, 2**31])
def test_magic_division_is_exact_on_its_boundaries(nbins):
    """(x * magic) >> (64 + shift) == x // binsize at every bin's first and
    last value for the first and last bins, and at the largest sign."""
    d = bin_size(nbins)
    magic, shift = magic_divisor(d)
    assert 0 <= shift and magic < 2**64
    last = (SIGN_MOD - 1) // d
    xs = [0, 1, SIGN_MOD - 1, 2**61 - 2, 2**61 - 1]
    for m in (1, 2, last, last + 1):
        xs += [m * d - 1, m * d, m * d + 1]
    xs = [x for x in xs if 0 <= x < 2**61]
    for x in xs:
        assert (x * magic) >> (64 + shift) == x // d
    t = torch.tensor([x for x in xs], dtype=torch.int64)
    assert magic_div(t, d).tolist() == [x // d for x in xs]


def test_signs_kernel_layout_and_launch():
    """The signs kernel's run (SL = 16 starts a thread, its own kernel) as
    the wrapper and the source both state it, its span pitch covering
    every byte a block reads, its shared memory within a block's opt-in
    227 KB at 128 k of 16384, and the reads path's chunk at 7 k as the
    blocks of at least two waves at the residency its threads, shared
    memory and registers allow."""
    from sketchtpu_torch.hash import nthash_torch as nt
    from sketchtpu_torch.sketchcore.sketch_torch import _READ_CHUNK_SIGNS

    src = (Path(nt.__file__).parents[1] / "csrc" / "nthash_bin.cu").read_text()
    lg = nt._SIGNS_RUN_LG
    assert f"constexpr int SLG = {lg};" in src
    assert f"constexpr int ROUND = {nt._SIGNS_ROUND};" in src
    assert "__global__ void __launch_bounds__(NT)\n    nthash_signs_kernel(" in src
    assert "template <bool SIGNS>" not in src  # the bin mode has no signs branch
    for kmax in (1, 2, 3, 31, 64, 513, nt.MAX_K_CUDA):
        pitch = _span_pitch(kmax, lg)
        span = (256 << lg) + kmax - 1
        assert pitch >= ((span - 1) >> lg) + 1
        assert pitch % 4 == 0 and (pitch // 4) % 2 == 1
    assert nt._signs_smem_bytes(nt.MAX_NK_CUDA, nt.MAX_K_CUDA) <= nt._SMEM_MAX
    own = _READ_CHUNK_SIGNS // 7
    assert own == 4_793_490 and nt.signs_blocks(own) == 1171
    assert nt.signs_blocks(1) == 1 and nt.signs_blocks(4096) == 1
    assert nt.signs_blocks(4097) == 2
    # resident blocks an SM: by threads 8, by shared memory 6, by the 78
    # registers a thread that ptxas gives the kernel for sm_90a 3
    smem = nt._signs_smem_bytes(7, 29)
    per_sm = min(2048 // 256, (228 * 1024) // (smem + 1024),
                 65536 // (256 * 80))
    assert per_sm == 3 and nt.signs_blocks(own) >= 2 * 132 * per_sm


def test_kernel_shared_memory_layout_fits():
    """The launch's span pitch covers every byte a block reads, in whole
    words, an odd number of them; the limits fit 48 KB."""
    from sketchtpu_torch.hash import nthash_torch as nt

    src = (Path(nt.__file__).parents[1] / "csrc" / "nthash_bin.cu").read_text()
    lg = nt._RUN_LG
    assert f"constexpr int LG = {lg};" in src
    for kmax in (1, 2, 3, 31, 64, 513, nt.MAX_K_CUDA):
        pitch = _span_pitch(kmax)
        span = (256 << lg) + kmax - 1
        assert pitch >= ((span - 1) >> lg) + 1
        assert pitch % 4 == 0 and (pitch // 4) % 2 == 1
    assert _smem_bytes(nt.MAX_NK_CUDA, nt.MAX_K_CUDA, 1024, False) <= 48 * 1024
    assert _smem_bytes(7, 29, 1024, True) <= 48 * 1024
    assert _smem_bytes(7, 29, 8192, True) > 48 * 1024  # no table there
