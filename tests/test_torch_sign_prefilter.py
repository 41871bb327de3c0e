"""The reads path's sign prefilter in the port
(sketchtpu_torch/sketchcore/sign_prefilter.py, SKETCHTPU_FASTQ_PREFILTER).

Its plain PyTorch twin against the JAX package's XLA program
prefilter_signs_device on JAX-CPU, survivor for survivor (the same signs
given as (lo, hi, validbits) there and as int64 with -1 here); replay of
the survivors through the host count filter, whole and over arbitrary
segmentations, against the full stream's bins; a NumPy model of the
kernels' control flow (csrc/sign_prefilter.cu: the stable partition into
buckets, each bucket ordered on chip or past its capacity in device
memory, the block scan of state maps, the look-back's carries) against
the twin; the kernels' wrapper's dispatch; the backend under the JAX
package's own call pattern; and
`sketch` / `inverted build` of reads in cpu mode with the knob on,
byte-identical to the knob off and to the JAX package's host oracle.
Inputs are made from seeds with numpy."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketchtpu import cli as jax_cli
from sketchtpu.ingest.fastx import DnaStream as JaxStream
from sketchtpu.sketchcore.sign_prefilter import prefilter_signs_device
from sketchtpu.sketchcore.signs import bin_minima_filtered as jax_filtered
from sketchtpu.sketchcore.sketch_jax import DeviceSketchBackend as JaxBackend
from sketchtpu.sketchcore.sketch_jax import bin_magic
from sketchtpu_torch import _build
from sketchtpu_torch import cli as port_cli
from sketchtpu_torch.ingest.fastx import DnaStream
from sketchtpu_torch.sketchcore import sign_prefilter as sp
from sketchtpu_torch.sketchcore import sketch_torch
from sketchtpu_torch.sketchcore.sketch_torch import DeviceSketchBackend
from sketchtpu_torch.sketchcore.signs import bin_minima_filtered, bin_size
from sketchtpu_torch.synth import read_samples, related_assemblies
from tests.test_torch_runtime import _FakeCuda as _FakeTensor

U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)
NONE = (1 << 63) - 1


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The twins run many small CPU ops: one intra-op thread a test keeps
    them from waiting on a thread pool that shares its cores with the
    other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _heavy(seed, m, nbins, invalid=0.1):
    """m signs drawn from 400 values of the bins' range (heavy collisions,
    so the count filter's state matters), and which windows are valid."""
    rng = np.random.default_rng(seed)
    values = rng.integers(0, int(bin_size(nbins)) * nbins, 400).astype(
        np.uint64)
    return rng.choice(values, m), rng.random(m) >= invalid


def _jax_survivors(signs, valid, nbins, mc):
    m = signs.size
    vbits = np.packbits(np.pad(valid, (0, (-m) % 8)), bitorder="little")
    lo = (signs & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (signs >> np.uint64(32)).astype(np.uint32)
    c_lo, c_hi, count = prefilter_signs_device(
        jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(vbits), min_count=mc,
        num_bins=nbins, magic=bin_magic(nbins), cap=m)
    count = int(count)
    return (np.asarray(c_hi)[:count].astype(np.uint64) << np.uint64(32)) | \
        np.asarray(c_lo)[:count].astype(np.uint64)


def _as_row(signs, valid) -> torch.Tensor:
    """The signs as nthash_signs writes them: int64, -1 where invalid."""
    return torch.from_numpy(np.where(valid, signs, U64_MAX).view(np.int64))


def _port_survivors(signs, valid, nbins, mc, fn=sp.prefilter_signs_ref):
    return fn(_as_row(signs, valid), nbins, mc).numpy().view(np.uint64)


def _check_against_xla(signs, valid, nbins, mc) -> np.ndarray:
    """The twin's survivors: the XLA program's sequence, and a replay that
    gives the full stream's bins."""
    got = _port_survivors(signs, valid, nbins, mc)
    assert np.array_equal(got, _jax_survivors(signs, valid, nbins, mc))
    assert np.array_equal(bin_minima_filtered(got, nbins, mc),
                          bin_minima_filtered(signs[valid], nbins, mc))
    return got


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("m,nbins", [(4000, 64), (20000, 16)])
@pytest.mark.parametrize("mc", [2, 3, 5])
def test_twin_equals_the_xla_program(seed, m, nbins, mc):
    signs, valid = _heavy(seed, m, nbins)
    got = _check_against_xla(signs, valid, nbins, mc)
    assert got.size < valid.sum()  # high coverage: most are dropped
    assert np.array_equal(got, _port_survivors(signs, valid, nbins, mc,
                                                sp.prefilter_signs))


def _unique(nbins):
    rng = np.random.default_rng(3)
    m = 1000
    signs = rng.permutation(np.arange(1, m + 1, dtype=np.uint64)
                            * np.uint64(12345701)) % np.uint64(
        int(bin_size(nbins)) * nbins)
    return signs, np.ones(m, bool)


def _out_of_range(nbins):
    top = np.uint64(int(bin_size(nbins)) * nbins)
    signs = np.array([5, top + np.uint64(7), 5, top + np.uint64(9), 5],
                     dtype=np.uint64)
    return signs, np.ones(5, bool)


def _all_invalid(nbins):
    signs, _ = _heavy(4, 3000, nbins)
    return signs, np.zeros(3000, bool)


def _one_long_run(nbins):
    """One sign of bin 0 in 600 of 2000 windows, the rest collisions."""
    signs, valid = _heavy(5, 2000, nbins)
    rng = np.random.default_rng(6)
    signs[rng.random(2000) < 0.3] = np.uint64(int(bin_size(nbins)) // 3)
    return signs, valid


@pytest.mark.parametrize("mc", [2, 5])
@pytest.mark.parametrize("case,kept", [
    (_unique, "all"), (_out_of_range, 3), (_all_invalid, 0),
    (_one_long_run, None)])
def test_special_streams(case, kept, mc):
    """Every sign unique (no count ever reaches min_count: all kept, in
    stream order), signs past the last bin (dropped), no valid window, and
    one sign's run longer than most of the stream."""
    signs, valid = case(16)
    got = _check_against_xla(signs, valid, 16, mc)
    if kept == "all":
        assert np.array_equal(got, signs)
    elif kept is not None:
        assert got.size == kept


def test_empty_row():
    """m = 0: nothing kept, the bins stay empty (the XLA program is not
    defined for an empty stream: its scans reject the length)."""
    empty = torch.zeros(0, dtype=torch.int64)
    for fn in (sp.prefilter_signs, sp.prefilter_signs_ref):
        assert fn(empty, 16, 3).numel() == 0
    assert sp.keep_flags(empty.view(1, 0), 16, 3)[0].numel() == 0
    assert sp.survivors(empty.view(0, 5), []) == []


@pytest.mark.parametrize("mc", [2, 3, 5])
@pytest.mark.parametrize("seed", range(3))
def test_segmentations_replay_to_the_stream_bins(seed, mc):
    """Survivors of each segment, concatenated in order, replay to the
    whole stream's bins, for cuts at random points and at a fixed length
    below the long run's (one sign in 30 % of the windows)."""
    nbins = 32
    signs, valid = _one_long_run(nbins) if seed == 0 else _heavy(
        seed, 6000, nbins)
    m = signs.size
    want = bin_minima_filtered(signs[valid], nbins, mc)
    rng = np.random.default_rng(100 + seed)
    cut_sets = [np.sort(rng.choice(np.arange(1, m), 7, replace=False)),
                np.arange(50, m, 50), np.array([], dtype=np.int64)]
    for cuts in cut_sets:
        bounds = [0, *cuts.tolist(), m]
        kept = np.concatenate([
            _port_survivors(signs[a:b], valid[a:b], nbins, mc)
            for a, b in zip(bounds[:-1], bounds[1:])])
        assert np.array_equal(bin_minima_filtered(kept, nbins, mc), want)


def test_sorted_keys_put_invalid_and_unbinned_signs_last():
    nbins = 16
    top = int(bin_size(nbins)) * nbins
    row = torch.tensor([9, -1, top, 3, 9, top - 1, -1, 3])
    keys, pos = sp.sorted_keys(row, nbins)
    assert keys.tolist() == [3, 3, 9, 9, top - 1] + [NONE] * 3
    assert pos.tolist()[:5] == [3, 7, 0, 4, 5]


NONE32 = 0xFFFFFFFF
RR, RS, RA = 1, 2, 4  # csrc/sign_prefilter.cu's map flags
IDENT = (NONE32, NONE32, 0)  # (a, x, flags)


def _then(s1, s2):
    """Then: the map s1, then s2, of the state (bf, rn)."""
    a1, x1, f1 = s1
    a2, x2, f2 = s2
    x = x2 if f2 & RR else min(x1, x2)
    rr = (f1 | f2) & RR
    if f2 & RS:
        return (a2 if f2 & RA else min(x1, a2), x,
                rr | RS | (RA if f2 & RA or f1 & RR else 0))
    return a1, x, rr | (f1 & (RS | RA))


def _apply(s, state):
    a, x, f = s
    bf, rn = state
    return ((a if f & RA else min(rn, a)) if f & RS else bf,
            x if f & RR else min(rn, x))


def _window(sign, k, mc, bsz, p):
    """Run start, bin start, and p if window k is its run's mc-th."""
    v = sign(k)
    rs = k == 0 or sign(k - 1) != v
    bs = rs and k > 0 and v // bsz != sign(k - 1) // bsz
    r0 = k - (mc - 1)
    mth = r0 >= 0 and sign(r0) == v and (r0 == 0 or sign(r0 - 1) != v)
    return rs, bs, p if mth else NONE32


def _block_scan(steps):
    """Exclusive prefixes of the threads' maps in the tree order of a
    Hillis-Steele scan (not left to right), and the total."""
    incl, d = list(steps), 1
    while d < len(steps):
        incl = [incl[t] if t < d else _then(incl[t - d], incl[t])
                for t in range(len(steps))]
        d *= 2
    return [IDENT] + incl[:-1], incl[-1]


def _stable_split(keys, nwarps, span):
    """The kernels' stable split (a partition pass, a radix pass in
    device memory): the indices of keys >= 0 in key order. Tiles
    of nwarps x span in stream order; in a tile, each key's cursor runs
    over the warps in order, and a warp ranks its windows in rounds of 32
    by the lanes below with the same key."""
    valid = [k for k in keys if k >= 0]
    counts = np.bincount(valid, minlength=1) if valid else np.zeros(1, int)
    cursor = np.concatenate([[0], np.cumsum(counts)[:-1]]).tolist()
    out = [-1] * len(valid)
    for t0 in range(0, len(keys), nwarps * span):
        spans = [(min(len(keys), t0 + w * span),
                  min(len(keys), t0 + (w + 1) * span)) for w in range(nwarps)]
        wcur = []
        for w0, w1 in spans:  # the warps' counts, then their cursors
            c = {}
            for i in range(w0, w1):
                if keys[i] >= 0:
                    c[keys[i]] = c.get(keys[i], 0) + 1
            wcur.append(c)
        for key in {k for c in wcur for k in c}:
            for c in wcur:
                n = c.get(key, 0)
                c[key] = cursor[key]
                cursor[key] += n
        for (w0, w1), cur in zip(spans, wcur):
            for r in range(w0, w1, 32):
                lanes = range(r, min(w1, r + 32))
                for i in lanes:
                    if keys[i] >= 0:
                        rank = sum(keys[j] == keys[i] for j in lanes if j < i)
                        out[cur[keys[i]] + rank] = i
                for key in {keys[i] for i in lanes if keys[i] >= 0}:
                    cur[key] += sum(keys[i] == key for i in lanes)
    return out


def _look_back(status, h, first, rng):
    """The min pmc of bin `first` in the buckets before h, from their
    status: each one's (last bin, aggregate, inclusive prefix), None if
    empty; a predecessor shows its prefix or only its aggregate, at
    random, as blocks that have or have not finished."""
    acc = NONE32
    for j in range(h - 1, -1, -1):
        if status[j] is None:
            continue
        last, agg, pre = status[j]
        if last != first:
            return acc
        if rng.random() < 0.5:
            return min(acc, pre)
        acc = min(acc, agg)
    return acc


def _kernel_model(row, nbins, mc, bits, cap, seed, pw=2, rounds=2, kw=4,
                  sub_bits=3, kt=8, oipt=3, radix_rounds=2):
    """csrc/sign_prefilter.cu's control flow in NumPy on Python ints, at
    small sizes (pw warps of `rounds` rounds of 32 windows a partition
    tile, kw warps and kt threads a keep block): the stable partition into
    2^bits buckets of the top key bits in passes of at most 8 bits, low
    digit first; the buckets' starts from the boundaries; per bucket in
    ticket order, at most cap windows split stably by sub_bits more bits,
    the windows of a group of more than one sign placed by their rank by
    (sign, position), one thread range each, or past cap radix-sorted by
    its varying 8-bit digits and
    scanned in tiles of kt x oipt; the state maps' block scan; the carry
    by look-back; flags."""
    rng = np.random.default_rng(seed)
    row = [int(v) for v in row]
    m = len(row)
    flags = np.zeros(m, bool)
    bsz = int(bin_size(nbins))
    top = nbins * bsz
    shift = max(0, (min(top, 1 << 61) - 1).bit_length() - bits)
    nb = 1 << bits

    def key(s):
        return min(s >> shift, nb - 1) if 0 <= s < top else -1

    low = bits - 8 if bits > 8 else 0
    order = list(range(m))
    for dshift, dbits in ([(0, low), (low, bits - low)] if low else
                          [(0, bits)]):
        digits = [(key(row[i]) >> dshift) & ((1 << dbits) - 1)
                  if key(row[i]) >= 0 else -1 for i in order]
        order = [order[j] for j in _stable_split(digits, pw, 32 * rounds)]
    part_s, part_p = [row[i] for i in order], order
    n_all = len(order)
    starts = [None] * (nb + 1)
    for i in range(n_all):  # pf_bounds
        for b in range(key(part_s[i - 1]) + 1 if i else 0,
                       key(part_s[i]) + 1):
            starts[b] = i
    for b in range(key(part_s[-1]) + 1 if n_all else 0, nb + 1):
        starts[b] = n_all
    status = []
    for h in range(nb):
        lo, n = starts[h], starts[h + 1] - starts[h]
        if n == 0:
            status.append(None)
            continue
        S, P = part_s[lo : lo + n], part_p[lo : lo + n]
        first, last = min(S) // bsz, max(S) // bsz
        if n <= cap:
            sh2 = max(shift - sub_bits, 0)
            digits = [min((s >> sh2) - (h << (shift - sh2)),
                          (1 << (shift - sh2)) - 1) for s in S]
            idx = _stable_split(digits, kw, -(-n // kw))
            g = 0
            while g < n:  # a group of more than one sign: ranks
                e = g
                while e < n and digits[idx[e]] == digits[idx[g]]:
                    e += 1
                if any(S[idx[k - 1]] > S[idx[k]] for k in range(g + 1, e)):
                    grp = idx[g:e]
                    for i in grp:
                        idx[g + sum((S[j], P[j]) < (S[i], P[i])
                                    for j in grp)] = i
                g = e
            per = -(-n // kt)
            tiles = [[(min(n, t * per), min(n, t * per + per))
                      for t in range(kt)]]
        else:
            varying = 0
            for s in S:
                varying |= s ^ S[0]
            idx = list(range(n))
            for q in range(0, 64, 8):
                if (varying >> q) & 0xFF:
                    new = _stable_split([(S[i] >> q) & 0xFF for i in idx],
                                        kw, 32 * radix_rounds)
                    idx = [idx[j] for j in new]
            tiles = [[(min(n, t0 + t * oipt), min(n, t0 + t * oipt + oipt))
                      for t in range(kt)] for t0 in range(0, n, kt * oipt)]

        def sign(k, idx=idx, S=S):
            return S[idx[k]]

        scans, agg = [], IDENT
        for tile in tiles:
            mine = []
            for k0, k1 in tile:
                step = IDENT
                for k in range(k0, k1):
                    rs, bs, c = _window(sign, k, mc, bsz, P[idx[k]])
                    step = _then(step, (NONE32, c, (RR | RS | RA) if bs
                                        else RS if rs else 0))
                mine.append(step)
            prefix, total = _block_scan(mine)
            scans.append((prefix, total))
            agg = _then(agg, total)
        carry = _look_back(status, h, first, rng)
        status.append((last, agg[1],
                       agg[1] if agg[2] & RR else min(carry, agg[1])))
        entry = (NONE32, carry)
        for tile, (prefix, total) in zip(tiles, scans):
            for (k0, k1), pre in zip(tile, prefix):
                bf, rn = _apply(pre, entry)
                for k in range(k0, k1):
                    p = P[idx[k]]
                    rs, bs, c = _window(sign, k, mc, bsz, p)
                    if bs:
                        bf, rn = NONE32, c
                    else:
                        bf = rn if rs else bf
                        rn = min(rn, c)
                    flags[p] |= bf >= p
            entry = _apply(total, entry)
    return flags


def _one_sign(m, nbins):
    return np.full(m, int(bin_size(nbins)) * 5 // 2, np.uint64), \
        np.ones(m, bool)


def _one_bin(m, nbins):
    """Every window in bin 5 of nbins (the bin spans several buckets)."""
    rng = np.random.default_rng(m)
    bs = int(bin_size(nbins))
    values = rng.integers(5 * bs, 6 * bs, m // 4, dtype=np.uint64)
    return rng.choice(values, m), rng.random(m) >= 0.05


def _crowded(m, nbins):
    """Distinct signs below 2^20: one bucket, sorted by several digits."""
    rng = np.random.default_rng(m + 1)
    return rng.choice(rng.integers(0, 1 << 20, m // 3, dtype=np.uint64),
                      m), np.ones(m, bool)


def _past_2_61(m, nbins):
    """Signs from 2^61 - 1 up to the last bin's end (top > 2^61 at nbins
    = 40,000), crowded into the last bucket with the others of its range."""
    rng = np.random.default_rng(m + 2)
    top = int(bin_size(nbins)) * nbins
    values = np.concatenate([
        rng.integers((1 << 61) - 300, 1 << 61, 30, dtype=np.uint64),
        rng.integers(1 << 61, top, 30, dtype=np.uint64),
        rng.integers(0, top, 200, dtype=np.uint64)])
    return rng.choice(values, m), rng.random(m) >= 0.05


def _heavy_case(m, nbins):
    return _heavy(m + nbins, m, nbins)


@pytest.mark.parametrize("case,m,nbins,mc,bits,cap", [
    (_heavy_case, 1500, 4, 1, 4, 96),      # pieces on chip and past cap
    (_heavy_case, 3000, 1024, 2, 10, 64),  # two partition passes
    (_heavy_case, 3000, 64, 5, 11, 3),
    (_heavy_case, 1500, 4, 2, 4, 96),
    (_heavy_case, 1500, 4, 5, 4, 96),
    (_heavy_case, 2000, 1, 3, 5, 64),      # one bin over every bucket
    (_heavy_case, 1200, 40_000, 2, 2, 400),  # many bins a bucket
    (_heavy_case, 1200, 40_000, 4, 3, 100),
    (_one_sign, 2000, 64, 3, 4, 48),       # one run past cap
    (_one_sign, 300, 64, 1, 0, 400),       # one run on chip
    (_one_bin, 1600, 64, 2, 8, 32),        # every window in one bin
    (_one_bin, 1600, 64, 5, 8, 500),
    (_crowded, 900, 16, 2, 3, 64),         # radix passes past cap
    (_crowded, 900, 16, 3, 0, 1000),
    (_past_2_61, 1500, 40_000, 3, 3, 1000),
    (_past_2_61, 1500, 40_000, 2, 4, 48),
    (_all_invalid, 0, 16, 3, 2, 48),
    (_unique, 0, 16, 2, 3, 48),
])
def test_kernel_model_equals_the_twin(case, m, nbins, mc, bits, cap):
    """The kernels' model at small capacities: bins split into pieces
    (buckets) with their carries, the thread ranges and device-memory
    tiles that end inside runs, one repeated sign, a row in one bin at 64
    bins, 40,000 bins, min_count 1 to 5, and rows with no binned window."""
    signs, valid = case(nbins) if m == 0 else case(m, nbins)
    row = _as_row(signs, valid)
    want = sp.sign_prefilter_flags_ref(row, nbins, mc)
    got = _kernel_model(row.numpy(), nbins, mc, bits, cap, seed=m + mc)
    assert np.array_equal(got, want.numpy())
    if case is _all_invalid:
        assert not got.any()


def test_kernel_model_on_an_empty_row():
    assert _kernel_model(np.zeros(0, np.int64), 64, 3, 0, 48, 0).size == 0
    assert sp.sign_prefilter_flags_ref(torch.zeros(0, dtype=torch.int64),
                                       64, 3).numel() == 0


@pytest.mark.parametrize("m,bits", [(1, 0), (2048, 0), (2049, 1),
                                    (1 << 24, 13), (49_999_934, 15),
                                    (1 << 26, 15), (1 << 27, 16),
                                    ((1 << 27) + 1, 16)])
def test_bucket_bits(m, bits):
    """2^bits buckets of at most 2048 windows on average, up to 2^16."""
    assert sp.bucket_bits(m) == bits


class _FakeCuda(_FakeTensor):
    """A CUDA tensor's stand-in with a data pointer to launch with."""

    def __init__(self, t, ptr):
        super().__init__(t)
        self._ptr = ptr

    def data_ptr(self):
        return self._ptr


def test_keep_wrapper_launches_on_cuda_tensors(monkeypatch):
    """A CUDA row launches the kernels once (the row, its bins and the
    bucket bits, then the workspace, look-back status, partition and
    scratch buffers the wrapper allocates, and the flags) and counts the
    launch; the twin is never reached."""
    calls = []
    monkeypatch.setattr(_build, "launch",
                        lambda dev, name, *args, what: calls.append(
                            (dev, name, args, what)))
    monkeypatch.setattr(sp, "sign_prefilter_keep_ref",
                        lambda *a: pytest.fail("twin reached"))
    made = []
    real_empty = torch.empty

    def empty(*a, device=None, **kw):
        made.append(real_empty(*a, **kw))
        return made[-1]

    monkeypatch.setattr(torch, "empty", empty)
    row = torch.tensor([4, 2, -1, 2] * 10000)
    before = sp.sign_prefilter_flags.launches
    flags = sp.sign_prefilter_flags(_FakeCuda(row, 111), 8, 3)
    assert sp.sign_prefilter_flags.launches == before + 1
    (dev, name, args, what), = calls
    assert (dev.type, name, what) == ("cuda", "stpu_sign_prefilter",
                                      "sign_prefilter")
    flags_t, ws, status, ps, pp, ss, spos = made
    assert flags_t is flags and flags.dtype == torch.bool
    bits = sp.bucket_bits(40000)
    assert bits == 5 and ws.numel() == 5 * 256 + 8192 + 32 + 4
    assert status.dtype == torch.int64 and status.numel() == 32
    for t, dt in ((ps, torch.int64), (pp, torch.int32), (ss, torch.int64),
                  (spos, torch.int32)):
        assert t.dtype == dt and t.numel() == 40000
    assert args == (111, 40000, 3, int(bin_size(8)), 8, bits, sp.CAP,
                    ws.data_ptr(), status.data_ptr(), ps.data_ptr(),
                    pp.data_ptr(), ss.data_ptr(), spos.data_ptr(),
                    flags.data_ptr())
    sp.sign_prefilter_flags(_FakeCuda(torch.tensor([5, 6]), 1), 8, 3,
                            bits=0, cap=7)
    assert calls[-1][2][5:7] == (0, 7)
    empty_row = torch.zeros(0, dtype=torch.int64)
    assert sp.sign_prefilter_flags(_FakeCuda(empty_row, 1), 8,
                                   3).numel() == 0
    assert len(calls) == 2 and sp.sign_prefilter_flags.launches == before + 2


def test_keep_wrapper_checks_its_input():
    row = torch.tensor([4, 2, 2, -1])
    assert torch.equal(sp.sign_prefilter_flags(row, 8, 2),
                       sp.sign_prefilter_flags_ref(row, 8, 2))
    assert sp.sign_prefilter_flags(row, 8, 2).tolist() == [True, True, True,
                                                           False]
    for bad in ((row.int(), 8, 2), (row, 8, 0), (row, 0, 2),
                (row.view(2, 2), 8, 2), (row[::2], 8, 2),
                (row, 1 << 30, 2)):
        with pytest.raises(ValueError):
            sp.sign_prefilter_flags(*bad)
    fake = _FakeCuda(row, 1)
    for kw in ({"bits": 17}, {"bits": -1}, {"cap": 0},
               {"cap": sp.CAP + 1}):
        with pytest.raises(ValueError):
            sp.sign_prefilter_flags(fake, 8, 2, **kw)
    huge = _FakeCuda(torch.zeros(1, dtype=torch.int64), 1)
    huge.numel = lambda: sp.MAX_WINDOWS + 1
    with pytest.raises(ValueError):
        sp.sign_prefilter_flags(huge, 8, 2)


def test_knob(monkeypatch):
    monkeypatch.delenv("SKETCHTPU_FASTQ_PREFILTER", raising=False)
    assert not sp.enabled(5)
    for value, on in (("1", True), ("on", True), ("0", False),
                      ("yes", False)):
        monkeypatch.setenv("SKETCHTPU_FASTQ_PREFILTER", value)
        assert sp.enabled(5) == on and not sp.enabled(1)


# --- the backend --------------------------------------------------------------

def _reads_streams(seed, genome=4000, reads=300, read_len=150):
    """(JAX, port) DnaStreams of reads of a random genome at
    reads * read_len / genome coverage, half reverse-complemented."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, genome).astype(np.uint8)
    codes = np.empty(reads * read_len, np.uint8)
    for i, s in enumerate(rng.integers(0, genome - read_len, reads)):
        r = g[s : s + read_len]
        codes[i * read_len : (i + 1) * read_len] = 3 - r[::-1] if i % 2 else r
    breaks = np.arange(1, reads, dtype=np.int64) * read_len
    acgt = np.ones(4, np.int64)
    return (JaxStream(codes=codes, breaks=breaks, acgt=acgt, reads=True),
            DnaStream(codes=codes, breaks=breaks, acgt=acgt, reads=True))


@pytest.mark.parametrize("knob", ["0", "1"])
@pytest.mark.parametrize("mc", [1, 2, 3])
def test_the_jax_call_pattern_on_the_port(knob, mc, monkeypatch):
    """inverted/index.py:555-558's calls, made on the port's backend and on
    the JAX backend (JAX-CPU): the same bins, the full stream's; with the
    prefilter on, the same signs, fewer than the stream's."""
    monkeypatch.setenv("SKETCHTPU_FASTQ_PREFILTER", knob)
    jax_stream, stream = _reads_streams(20 + mc)
    k, rc, sketch_size = 17, True, 64
    got = {}
    for who, backend, s in (("port", DeviceSketchBackend(torch.device("cpu")),
                             stream), ("jax", JaxBackend(), jax_stream)):
        h = backend.dispatch_signs_maybe_filtered(s, k, rc, sketch_size, mc)
        signs = backend.collect_signs_maybe_filtered(h)
        got[who] = (signs, jax_filtered(signs, sketch_size, mc))
    full = JaxBackend().signs_in_order(jax_stream, k, rc)
    assert np.array_equal(got["port"][0], got["jax"][0])
    assert np.array_equal(got["port"][1], got["jax"][1])
    assert np.array_equal(got["port"][1], jax_filtered(full, sketch_size, mc))
    filtered = knob == "1" and mc >= 2
    assert (got["port"][0].size < full.size) == filtered


@pytest.mark.parametrize("n_starts", [None, 1, 5000, 20000])
def test_dispatch_on_a_device_and_a_window_range(n_starts, monkeypatch):
    """dev and n_starts as the JAX backend takes them: the survivors of
    window starts [0, n_starts), on the given device."""
    monkeypatch.setenv("SKETCHTPU_FASTQ_PREFILTER", "1")
    _, stream = _reads_streams(30)
    backend = DeviceSketchBackend([torch.device("cpu")] * 2)
    got = backend.dispatch_signs_maybe_filtered(stream, 21, True, 64, 3,
                                                dev="cpu", n_starts=n_starts)
    full = backend.signs_in_order(stream, 21, True, n_starts)
    assert np.array_equal(bin_minima_filtered(got, 64, 3),
                          bin_minima_filtered(full, 64, 3))
    assert got.size <= full.size


@pytest.mark.parametrize("nk,starts", [(1, 1 << 26), (7, 1 << 26),
                                       (9, (1 << 29) // 9), (32, 1 << 24),
                                       (128, 1 << 24)])
def test_segment_length(nk, starts):
    """A segment holds at most 2^26 window starts and 2^29 signs over all
    k, and at least the JAX package's 2^24 window starts."""
    assert sketch_torch._segment_starts(nk) == starts
    assert starts >= sketch_torch._SEGMENT_MIN_STARTS


@pytest.mark.parametrize("segment", [20000, 1 << 20])
@pytest.mark.parametrize("slots", [1, 3])
def test_segments_replay_to_the_stream_bins(segment, slots, monkeypatch):
    """read_minima over streams in segments of `segment` window starts (a
    sign's run spans all three at 20000), segments in turn over device
    slots: the bins equal the knob off's, from fewer signs."""
    _, long = _reads_streams(40, genome=3000, reads=400)
    _, short = _reads_streams(41, genome=1000, reads=2)
    jobs = [(0, long), (1, short), (2, DnaStream(
        codes=np.zeros(10, np.uint8), breaks=np.zeros(0, np.int64),
        acgt=np.ones(4, np.int64), reads=True))]
    kmers = [17, 25]
    backend = DeviceSketchBackend([torch.device("cpu")] * slots)
    monkeypatch.setattr(sketch_torch, "_segment_starts", lambda nk: segment)
    seen = {}
    real = sketch_torch.bin_minima_filtered

    def counted(signs, nbins, mc):
        seen[knob] = seen.get(knob, 0) + signs.size
        return real(signs, nbins, mc)

    monkeypatch.setattr(sketch_torch, "bin_minima_filtered", counted)
    bins = {}
    for knob in ("0", "1"):
        monkeypatch.setenv("SKETCHTPU_FASTQ_PREFILTER", knob)
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(2) as pool:
            futs = backend.read_minima(jobs, kmers, True, 128, 4, pool)
            bins[knob] = {key: f.result() for key, f in futs.items()}
    assert sorted(bins["1"]) == sorted(bins["0"]) and len(bins["0"]) == 6
    for key, b in bins["0"].items():
        assert np.array_equal(bins["1"][key], b), key
    assert seen["1"] < seen["0"]


# --- `sketch` and `inverted build` of reads through the CLIs -----------------

@pytest.mark.parametrize("slots", [1, 2, 3])
def test_segments_in_flight(slots, monkeypatch):
    """Each segment's keep flags are launched before the segment before it
    is gathered: up to one segment a device slot and one more are in
    flight, on one device too, and every segment is gathered once."""
    monkeypatch.setenv("SKETCHTPU_FASTQ_PREFILTER", "1")
    _, stream = _reads_streams(42, genome=3000, reads=200)
    monkeypatch.setattr(sketch_torch, "_segment_starts", lambda nk: 2000)
    events = []
    real_flags, real_gather = sketch_torch.keep_flags, sketch_torch.survivors

    def flags(*a):
        events.append(1)
        return real_flags(*a)

    def gather(*a):
        events.append(-1)
        return real_gather(*a)

    monkeypatch.setattr(sketch_torch, "keep_flags", flags)
    monkeypatch.setattr(sketch_torch, "survivors", gather)
    backend = DeviceSketchBackend([torch.device("cpu")] * slots)
    got = backend.dispatch_signs_maybe_filtered(stream, 17, True, 64, 3)
    segments = -(-(stream.seq_len - 16) // 2000)
    assert events.count(1) == events.count(-1) == segments > slots + 1
    assert np.cumsum(events).max() == slots + 1
    full = backend.signs_in_order(stream, 17, True)
    assert np.array_equal(bin_minima_filtered(got, 64, 3),
                          bin_minima_filtered(full, 64, 3))


@pytest.fixture(scope="module")
def reads_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_prefilter")
    lines = (read_samples(d / "fq", 2, 6000, 12, seed=11)
             + read_samples(d / "fq", 1, 6000, 12, seed=12, paired=True))
    (d / "reads.txt").write_text("".join(lines))
    rfile = related_assemblies(d / "fa", 3, 12000, seed=13, max_contigs=4)
    (d / "mixed.txt").write_text(rfile.read_text() + "".join(lines))
    return d


_COMMANDS = {
    "sketch": (["sketch", "-k", "17,21,25", "-s", "256"], (".skd", ".skm")),
    "inverted": (["inverted", "build", "-s", "100", "-k", "17",
                  "--write-skq"], (".ski", ".skq")),
}


def _oracle(d: Path, command, inputs, mc, monkeypatch) -> Path:
    """The JAX package's host oracle's output, made once per case."""
    out = d / f"host_{command}_{inputs}_{mc}"
    argv, exts = _COMMANDS[command]
    if not Path(f"{out}{exts[0]}").exists():
        with monkeypatch.context() as m:
            m.setenv("SKETCHTPU_BACKEND", "host")
            assert jax_cli.main([*argv, "-f", str(d / f"{inputs}.txt"), "-o",
                                 str(out), "--min-count", str(mc),
                                 "--quiet"]) == 0
    return out


@pytest.mark.parametrize("mc", [1, 2, 3])
@pytest.mark.parametrize("inputs", ["reads", "mixed"])
@pytest.mark.parametrize("command", ["sketch", "inverted"])
def test_cli_with_the_prefilter_is_byte_identical(reads_dir, command, inputs,
                                                  mc, monkeypatch):
    """Reads (single and paired files), alone and with assemblies, in cpu
    mode: the knob on gives the knob off's bytes and the host oracle's;
    with --min-count >= 2 fewer signs reach the host's count filter (and
    with segments of 5000 window starts too)."""
    d = reads_dir
    want = _oracle(d, command, inputs, mc, monkeypatch)
    argv, exts = _COMMANDS[command]
    monkeypatch.setenv("SKETCHTPU_TORCH_BACKEND", "cpu")
    seen = {}
    real = sketch_torch.bin_minima_filtered

    def counted(signs, nbins, min_count):
        seen[run] = seen.get(run, 0) + signs.size
        return real(signs, nbins, min_count)

    monkeypatch.setattr(sketch_torch, "bin_minima_filtered", counted)
    for run, knob, segment in (("off", "0", None), ("on", "1", None),
                               ("on_5000", "1", 5000)):
        monkeypatch.setenv("SKETCHTPU_FASTQ_PREFILTER", knob)
        if segment is not None:
            monkeypatch.setattr(sketch_torch, "_segment_starts",
                                lambda nk: segment)
        out = d / f"port_{command}_{inputs}_{mc}_{run}"
        assert port_cli.main([*argv, "-f", str(d / f"{inputs}.txt"), "-o",
                              str(out), "--min-count", str(mc), "--threads",
                              "2", "--quiet"]) == 0
        for ext in exts:
            got = Path(f"{out}{ext}").read_bytes()
            assert got and got == Path(f"{want}{ext}").read_bytes(), (run,
                                                                     ext)
    if mc >= 2:
        assert seen["on"] < seen["off"] and seen["on_5000"] < seen["off"]
    else:
        assert seen["on"] == seen["off"] == seen["on_5000"]
