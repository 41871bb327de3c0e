"""The inverted index in the port, on the CPU twins, against the JAX
package: the msgpack / roaring / .skq codecs and the native .ski helpers
byte for byte; Inverted build / save / load; the sign-equality kernel's
twin (count, any, all, pair_count) against the XLA programs of
sketchtpu/inverted/device.py on JAX-CPU; the sign mask of K3 and K2's key
mode against the masked JAX scans (Pallas in interpret mode);
precluster_knn against the JAX engine and the host oracle; the CLI
(inverted build / query / precluster, info on a .ski, dist --knn past the
card's selection limit) and the HTTP server against the JAX package's.
Inputs are made from seeds with numpy; everything is exact unless a test
says otherwise."""

import contextlib
import http.client
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sketchtpu import cli as jax_cli
from sketchtpu.dist import api as jax_api
from sketchtpu.dist.coreacc_pallas import chunk_major
from sketchtpu.dist.knn_jax import (
    DeviceKnnEngine as JaxKnnEngine,
    _knn_scan_block_ca_pallas,
    _knn_scan_block_comp_pallas,
    _knn_scan_block_packed,
)
from sketchtpu.dist.pallas_kernels import chunk_group_major
from sketchtpu.formats import msgpack as jax_msgpack
from sketchtpu.formats import roaring as jax_roaring
from sketchtpu.formats import skd as jax_skd
from sketchtpu.formats.skm import MultiSketch as JaxMultiSketch
from sketchtpu.inverted import device as jax_device
from sketchtpu.inverted.index import Inverted as JaxInverted
from sketchtpu.inverted.serve import make_server as jax_make_server
from sketchtpu.sketchcore.sketch import HashType as JaxHashType
from sketchtpu_torch.dist import api, coreacc_kernels, knn_kernels, knn_torch
from sketchtpu_torch.dist.coreacc_kernels import (
    KEY_INVALID,
    coreacc_keys,
    coreacc_keys_ref,
)
from sketchtpu_torch.dist.knn_kernels import (
    Completeness,
    SignMask,
    knn_keys,
    knn_keys_ref,
    knn_select,
    knn_select_ref,
)
from sketchtpu_torch.dist.knn_torch import DeviceKnnEngine, knn_scan
from sketchtpu_torch import cli as port_cli
from sketchtpu_torch.formats import msgpack, roaring, skd
from sketchtpu_torch.formats.skm import MultiSketch
from sketchtpu_torch.inverted import device
from sketchtpu_torch.inverted.device import (
    DeviceInvertedEngine,
    pack_signs,
    pair_count,
    pair_count_ref,
    signeq,
)
from sketchtpu_torch.inverted.index import Inverted
from sketchtpu_torch.inverted.serve import make_server
from sketchtpu_torch.sketchcore.sketch import HashType, Sketch
from sketchtpu_torch.synth import (
    derive_signs,
    derive_words,
    read_samples,
    related_assemblies,
)

REPO = Path(__file__).resolve().parent.parent
KMERS = (17, 21, 25)


def _signs(n, s, alphabet, seed):
    """(n, s) u16 signs from a small alphabet (many equal bins) with a few
    u16::MAX empties, as tests/test_inverted_device.py makes them."""
    rng = np.random.default_rng(seed)
    mat = rng.integers(0, alphabet, (n, s)).astype(np.uint16)
    mat[rng.random((n, s)) < 0.01] = np.uint16(0xFFFF)
    return mat


# --- formats ----------------------------------------------------------------

def test_msgpack_bytes_equal_jax():
    rng = np.random.default_rng(1)
    obj = [
        [{int(s): bytes(rng.integers(0, 256, int(n), dtype=np.uint8))
          for s, n in zip(rng.integers(0, 1 << 16, 20),
                          rng.integers(0, 70000, 20))}],
        700001, ["a", "é" * 40, "x" * 300], None, ["m"] * 17, 21, "0.3.0",
        True, {"AA": "Level2"}, -5, -200, -40000, 1 << 40, b"", [],
    ]
    got = msgpack.dumps(obj)
    assert got == jax_msgpack.dumps(obj)
    assert msgpack.loads(got) == jax_msgpack.loads(got)


@pytest.mark.parametrize("members", [
    [], [0], [1, 5, 65535, 65536, 70000],
    list(range(0, 200000, 3)),  # a bitset container
    list(range(5000)) + [1 << 20],
])
def test_roaring_bytes_equal_jax(members):
    m = np.array(members, dtype=np.uint32)
    blob = roaring.serialize(m)
    assert blob == jax_roaring.serialize(m)
    assert np.array_equal(roaring.deserialize(blob), m)


def test_skq_writer_and_reader_equal_jax(tmp_path):
    mat = _signs(9, 13, 60000, 2)
    for mod, name in ((skd, "port"), (jax_skd, "jax")):
        with mod.SketchDataWriter(str(tmp_path / f"{name}.skq"),
                                  dtype=np.uint16) as w:
            for row in mat:
                w.write_sketch(row)
    got = (tmp_path / "port.skq").read_bytes()
    assert got == (tmp_path / "jax.skq").read_bytes()
    assert np.array_equal(skd.read_all_skq(str(tmp_path / "port.skq")),
                          mat.reshape(-1))


def _inv(cls, ht, mat, **kw):
    n = mat.shape[0]
    return cls(sign_matrix=mat, sample_names=[f"g{i}" for i in range(n)],
               kmer_size=21, rc=True, hash_type=ht("dna"), **kw)


@pytest.mark.parametrize("n,s,alphabet", [
    (37, 11, 60000), (300, 7, 5), (70001, 3, 2), (900, 40, 200),
])
def test_native_ski_helpers_equal_jax_python_encoder(n, s, alphabet):
    """The port's C++ index writer against the JAX package's Python
    msgpack + roaring encoder, as tests/test_native_ski.py holds the JAX
    package's own helper."""
    mat = _signs(n, s, alphabet, n)
    inv = _inv(Inverted, HashType, mat, metadata=["m"] * n)
    raw = inv._index_raw()
    assert raw is not None
    fallback = [{sign: jax_roaring.serialize(m) for sign, m in bm.items()}
                for bm in _inv(JaxInverted, JaxHashType, mat)._index_maps()]
    assert raw.data == jax_msgpack.dumps(fallback)


@pytest.mark.parametrize("labels", [False, True])
def test_inverted_save_load_bytes_equal_jax(tmp_path, labels):
    mat = _signs(500, 33, 300, 3)
    kw = dict(metadata=[f"m{i}" for i in range(500)],
              labels=[f"l{i % 7}" for i in range(500)] if labels else None)
    _inv(Inverted, HashType, mat, **kw).save(str(tmp_path / "port"))
    _inv(JaxInverted, JaxHashType, mat, **kw).save(str(tmp_path / "jax"))
    assert (tmp_path / "port.ski").read_bytes() == \
        (tmp_path / "jax.ski").read_bytes()
    back = Inverted.load(str(tmp_path / "jax"))
    assert np.array_equal(back.sign_matrix, mat)
    assert back.metadata == kw["metadata"] and back.labels == kw["labels"]
    want = JaxInverted.load(str(tmp_path / "port"))
    assert back.debug_str() == want.debug_str()
    assert back.display_str() == want.display_str()


def test_native_ski_reader_equals_python_reader(tmp_path, monkeypatch):
    mat = _signs(3000, 9, 4, 4)  # bitset containers
    _inv(Inverted, HashType, mat).save(str(tmp_path / "a"))
    native = Inverted.load(str(tmp_path / "a"))
    monkeypatch.setattr(Inverted, "_parse_native", classmethod(
        lambda cls, payload: None))
    python = Inverted.load(str(tmp_path / "a"))
    assert np.array_equal(native.sign_matrix, python.sign_matrix)
    assert np.array_equal(native.sign_matrix, mat)


@pytest.fixture(scope="module")
def small_index(tmp_path_factory):
    """An index the port's CLI built from 6 assemblies, with species names
    and metadata, and its rfile."""
    d = tmp_path_factory.mktemp("ski_reader")
    rfile = related_assemblies(d / "fa", 6, 8000, seed=23, max_contigs=2)
    names = [ln.split("\t")[0] for ln in rfile.read_text().splitlines()]
    (d / "species.txt").write_text("".join(
        f"{nm}\tsp{i % 2}\n" for i, nm in enumerate(names)))
    (d / "meta.txt").write_text("".join(f"{nm}\tmé{i}\n"
                                        for i, nm in enumerate(names)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SKETCHTPU_TORCH_BACKEND", "cpu")
        assert port_cli.main([
            "inverted", "build", "-f", str(rfile), "-o", str(d / "inv"),
            "-s", "100", "-k", "17", "--species-names",
            str(d / "species.txt"), "--metadata", str(d / "meta.txt"),
            "--quiet"]) == 0
    return d, rfile


@pytest.mark.parametrize("argv", [
    ["info", "{d}/inv.ski"],
    ["info", "{d}/inv.ski", "--sample-info"],
    ["inverted", "precluster", "{d}/inv.ski", "--count", "--quiet"],
    ["inverted", "query", "{d}/inv.ski", "-f", "{rfile}", "--query-type",
     "match-count", "--quiet"],
    ["inverted", "query", "{d}/inv.ski", "-f", "{rfile}", "--query-type",
     "any-bins", "--quiet"],
], ids=["info", "info_samples", "count", "match_count", "any_bins"])
def test_native_ski_reader_equals_python_reader_through_cli(
        small_index, argv, monkeypatch, capsys):
    """info, precluster --count and inverted query print the same bytes
    whether the .ski goes through the host helper or the Python path."""
    d, rfile = small_index
    argv = [a.format(d=d, rfile=rfile) for a in argv]
    monkeypatch.setenv("SKETCHTPU_TORCH_BACKEND", "cpu")
    outs = []
    for native in (True, False):
        with monkeypatch.context() as mp:
            if not native:
                mp.setattr(Inverted, "_parse_native", classmethod(
                    lambda cls, payload: None))
            assert port_cli.main(argv) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] and outs[0] == outs[1]


# --- signeq: the twin against the XLA programs --------------------------------

def _pad(m, tc, extra=0):
    n = m.shape[0]
    pad = (-n) % tc + extra
    return np.pad(m.astype(np.int32), ((0, pad), (0, 0)))


@pytest.mark.parametrize("s", [1, 2, 99, 100])
@pytest.mark.parametrize("mode", ["count", "any", "all"])
def test_signeq_twin_matches_match_matrix_scan(mode, s):
    n, nq, tc = 203, 9, 64
    m = _signs(n, s, 6, s)
    q = _signs(nq, s, 6, s + 1)
    q[3] = m[77]
    q[4] = m[0]
    want = np.asarray(jax_device._match_matrix_scan(
        jnp.asarray(q.astype(np.int32)), jnp.asarray(_pad(m, tc)), tc, mode)
    )[:, :n]
    got = signeq(pack_signs(q, "cpu"), pack_signs(m, "cpu"), s, mode).numpy()
    assert np.array_equal(got, want)
    if mode == "all":
        assert got[3, 77] and got[4, 0]


@pytest.mark.parametrize("lo,hi", [(0, 203), (5, 150), (63, 65), (70, 70),
                                   (202, 203), (0, 0)])
@pytest.mark.parametrize("s", [1, 99, 100])
def test_pair_count_twin_matches_count_schedule_and_strip(lo, hi, s):
    """pair_count with an unaligned lo against _match_count_schedule (the
    whole schedule, split-int32 subtotals) and _match_count_strip summed
    over strips; n = 203 is not a multiple of the tile."""
    n, tc = 203, 64
    m = _signs(n, s, 30 if s < 50 else 3000, s)
    got = pair_count(pack_signs(m, "cpu"), s, lo, hi)
    nstrips = -(-(hi - lo) // tc)
    if nstrips:
        subs = np.asarray(jax_device._match_count_schedule(
            jnp.asarray(_pad(m, tc, extra=tc)), np.int32(lo), np.int32(hi),
            np.int32(n), tc=tc, nstrips=nstrips)).astype(np.int64)
        want = int((subs[:, 1].sum() << 16) + subs[:, 0].sum())
    else:
        want = 0
    assert got == want
    padded = _pad(m, tc)
    strips = 0
    for i0 in range(lo, hi, tc):
        na = min(tc, hi - i0)
        a = np.zeros((tc, s), np.int32)
        a[:na] = m[i0 : i0 + na]
        strips += int(np.asarray(jax_device._match_count_strip(
            jnp.asarray(a), jnp.asarray(padded), np.int32(i0), np.int32(na),
            np.int32(n), tc=tc)).sum())
    assert got == strips
    host = _inv(JaxInverted, JaxHashType, m)
    assert got == host.any_shared_bin_count(tile=50, row_range=slice(lo, hi))


def test_pair_count_twin_accumulates_in_int64(monkeypatch):
    """A model of the total past 2^31 (661k samples reach it): every tile
    of the twin reports 2^31 - 1 pairs; the total is their exact sum."""
    big = (1 << 31) - 1
    monkeypatch.setattr(device, "_strip_count",
                        lambda keep: torch.tensor(big, dtype=torch.int64))
    m = pack_signs(_signs(10, 4, 3, 1), "cpu")
    tiles = sum(len(range(r0, 10, 4)) for r0 in range(0, 10, 4))
    assert pair_count_ref(m, 4, 0, 10, tile=4) == tiles * big > 1 << 32


def test_pair_count_kernel_sums_in_64_bits():
    """The kernel's total is a u64 atomic; its per-thread tally (8 x 8
    pairs a 128-column tile, at most 2^31 / 128 column tiles) fits 32
    bits."""
    src = (REPO / "sketchtpu_torch" / "csrc" / "signeq.cu").read_text()
    assert "unsigned long long* __restrict__ total" in src
    assert "atomicAdd(total, block)" in src
    assert "unsigned acc[8][8];" in src and "unsigned tally = 0u;" in src
    pt = _signeq_constants()["PT"]
    assert 64 * ((1 << 31) // pt) < 1 << 32


def test_pair_count_splits():
    assert device.default_pair_splits(10_329, 10_329, 1056) == 1
    assert device.default_pair_splits(2, 10_000, 1056) == 1056
    assert device.default_pair_splits(3, 5, 1056) == 5
    # the 128-row tile at 661,000 samples, two blocks an SM on 132 SMs:
    # the whole count needs no split, phase 2's strip of 8192 rows nine
    tiles = -(-661_000 // device._PAIR_TILE)
    assert device.default_pair_splits(tiles, tiles, 264) == 1
    assert device.default_pair_splits(8192 // device._PAIR_TILE, tiles,
                                      264) == 9


# --- pair_count's DPX compare, modelled in NumPy -----------------------------

def _neg_halves(x):
    """csrc/signeq.cu neg_halves on u32 words."""
    x = x.astype(np.uint32)
    return (((np.uint32(0) - x) & np.uint32(0xFFFF))
            | ((np.uint32(0) - (x & np.uint32(0xFFFF0000)))
               & np.uint32(0xFFFF0000)))


def _dpx_any(rows, cols, s, pad_rule=True):
    """(na, nb) bool, exactly as pair_count computes it on packed words:
    the row word negated per half (its odd-S pad half staged as 1), the
    column word as stored, then per word acc = min_u16x2(na + b, acc)
    (wrapping u16 adds, per-half unsigned minimum, acc from 0xFFFFFFFF),
    and a pair shares a sign where either half of acc is 0."""
    a = pack_signs(rows, "cpu").numpy().view(np.uint32)
    b = pack_signs(cols, "cpu").numpy().view(np.uint32)
    na = _neg_halves(a)
    if s % 2 and pad_rule:
        na[:, -1] = (na[:, -1] & np.uint32(0xFFFF)) | np.uint32(0x10000)
    acc_lo = np.full((a.shape[0], b.shape[0]), 0xFFFF, np.uint32)
    acc_hi = acc_lo.copy()
    for w in range(a.shape[1]):
        lo = ((na[:, None, w] & 0xFFFF) + (b[None, :, w] & 0xFFFF)) & 0xFFFF
        hi = ((na[:, None, w] >> 16) + (b[None, :, w] >> 16)) & 0xFFFF
        acc_lo, acc_hi = np.minimum(lo, acc_lo), np.minimum(hi, acc_hi)
    acc = acc_lo | (acc_hi << np.uint32(16))
    return ((acc & 0xFFFF) == 0) | (acc < 0x10000)


def _adversarial_signs(n, s, seed):
    """Signs from {0, 1, 0x7FFF, 0x8000, 0xFFFF} and a wide alphabet: rows
    equal only in their last real sign, rows equal nowhere (with an odd S,
    their pad halves are both 0), all-0 and all-0xFFFF rows."""
    rng = np.random.default_rng(seed)
    edge = np.array([0, 1, 0x7FFF, 0x8000, 0xFFFF], np.uint16)
    m = rng.integers(0, 1 << 16, (n, s)).astype(np.uint16)
    pick = rng.random((n, s)) < 0.05
    m[pick] = edge[rng.integers(0, 5, int(pick.sum()))]
    m[0], m[1] = 0, 0xFFFF
    m[2] = (m[3].astype(np.int64) + 1).astype(np.uint16)
    m[2, -1] = m[3, -1]  # equal only in the last real sign
    m[4] = (m[5].astype(np.int64) + 7).astype(np.uint16)  # equal nowhere
    m[6] = 0x8000 - m[7].astype(np.int64)  # a + b = 0x8000, never equal
    return m


@pytest.mark.parametrize("s", [1, 2, 99, 100, 1000])
def test_dpx_compare_model_matches_any_mask_and_count_strip(s):
    """The NumPy model of pair_count's compare against any_mask_ref, the
    host oracle's any-equal and the JAX package's _match_count_strip /
    _match_count_schedule, with adversarial signs."""
    n, tc = 150, 64
    m = _adversarial_signs(n, s, s)
    got = _dpx_any(m, m, s)
    packed = pack_signs(m, "cpu")
    assert np.array_equal(got, device.any_mask_ref(packed, packed, s).numpy())
    assert np.array_equal(got, (m[:, None, :] == m[None, :, :]).any(2))
    assert not got[4, 5] and not got[6, 7] and got[0, 0] and not got[0, 1]
    if s > 1:
        assert got[2, 3] and (m[2, :-1] != m[3, :-1]).all()
    if s % 2:  # the pad rule: without it the pad halves (0 + 0) "match"
        assert _dpx_any(m[4:5], m[5:6], s, pad_rule=False)[0, 0]
    pairs = np.triu(got, 1)
    lo, hi = 5, 131
    want = int(pairs[lo:hi].sum())
    strips = 0
    padded = _pad(m, tc)
    for i0 in range(lo, hi, tc):
        na = min(tc, hi - i0)
        a = np.zeros((tc, s), np.int32)
        a[:na] = m[i0 : i0 + na]
        strips += int(np.asarray(jax_device._match_count_strip(
            jnp.asarray(a), jnp.asarray(padded), np.int32(i0), np.int32(na),
            np.int32(n), tc=tc)).sum())
    assert strips == want
    subs = np.asarray(jax_device._match_count_schedule(
        jnp.asarray(_pad(m, tc, extra=tc)), np.int32(0), np.int32(n),
        np.int32(n), tc=tc, nstrips=-(-n // tc))).astype(np.int64)
    assert int((subs[:, 1].sum() << 16) + subs[:, 0].sum()) == int(pairs.sum())
    assert pair_count(packed, s, lo, hi) == want


def _query_model(q, m, s, mode, cw):
    """(nq, n) results exactly as signeq.cu's count / any / all compute
    them on packed words: the query words in the compare's form (any,
    count: negated per half with the odd-S pad half 1; all: as stored with
    the pad half 0; the pad words past the row as never / always
    matching), the index words in chunks of cw words zero-filled to a
    multiple of 4, and per word any: acc = min_u16x2(nq + m, acc); count:
    acc += min_u16x2(nq + m, 1), count = 2 words - both halves; all:
    acc |= q ^ m, all = (acc == 0)."""
    a = pack_signs(q, "cpu").numpy().view(np.uint32)
    b = pack_signs(m, "cpu").numpy().view(np.uint32)
    words = a.shape[1]
    qp = -(-words // 4) * 4
    if mode == "all":
        qa = a.copy()
        if s % 2:
            qa[:, -1] &= np.uint32(0xFFFF)
    else:
        qa = _neg_halves(a)
        if s % 2:
            qa[:, -1] = (qa[:, -1] & np.uint32(0xFFFF)) | np.uint32(0x10000)
    pad = np.uint32(0x00010001 if mode == "any" else 0)
    qa = np.concatenate([qa, np.full((a.shape[0], qp - words), pad,
                                     np.uint32)], axis=1)

    def lo_hi(x):
        return x & np.uint32(0xFFFF), x >> np.uint32(16)

    init = 0xFFFFFFFF if mode == "any" else 0
    acc = np.full((a.shape[0], b.shape[0]), init, np.uint64)
    for w0 in range(0, words, cw):
        cwc = min(cw, words - w0)
        staged = np.zeros((b.shape[0], -(-cwc // 4) * 4), np.uint32)
        staged[:, :cwc] = b[:, w0 : w0 + cwc]  # the rest zero-filled
        for w in range(staged.shape[1]):
            x = qa[:, None, w0 + w]
            y = staged[None, :, w]
            if mode == "all":
                acc |= (x ^ y).astype(np.uint64)
                continue
            (xl, xh), (yl, yh) = lo_hi(x), lo_hi(y)
            sl = (xl + yl) & np.uint32(0xFFFF)
            sh = (xh + yh) & np.uint32(0xFFFF)
            al, ah = lo_hi(acc.astype(np.uint32))
            if mode == "any":
                acc = (np.minimum(sl, al) | (np.minimum(sh, ah) << 16)
                       ).astype(np.uint64)
            else:
                acc = ((al + np.minimum(sl, 1)) | ((ah + np.minimum(sh, 1))
                                                    << 16)).astype(np.uint64)
    acc = acc.astype(np.uint32)
    if mode == "any":
        return ((acc & 0xFFFF) == 0) | (acc < 0x10000)
    if mode == "all":
        return acc == 0
    return (2 * words - ((acc & 0xFFFF) + (acc >> 16))).astype(np.int32)


@pytest.mark.parametrize("mode", ["count", "any", "all"])
@pytest.mark.parametrize("s", [1, 2, 99, 100, 1000])
def test_query_compare_model_matches_signeq_ref_and_scan(s, mode):
    """The NumPy model of the count / any / all compares (in whole-row
    stages and, past them, in chunks of 36 words) against signeq_ref, the
    host oracle's equality and the JAX package's _match_matrix_scan, with
    adversarial signs: without the odd-S pad rule an all-differing pair
    would share its pad half."""
    m = _adversarial_signs(70, s, s + 7)
    q = np.concatenate([m[:9], _adversarial_signs(8, s, s + 8)[4:]])
    want = signeq(pack_signs(q, "cpu"), pack_signs(m, "cpu"), s, mode).numpy()
    tc = 64
    scan = np.asarray(jax_device._match_matrix_scan(
        jnp.asarray(q.astype(np.int32)), jnp.asarray(_pad(m, tc)), tc, mode)
    )[:, : m.shape[0]]
    eq = q[:, None, :] == m[None, :, :]
    oracle = {"count": eq.sum(2), "any": eq.any(2), "all": eq.all(2)}[mode]
    assert np.array_equal(want, scan) and np.array_equal(want, oracle)
    for cw in {52, 36}:
        got = _query_model(q, m, s, mode, cw)
        assert np.array_equal(got, want), cw
    if mode == "all":
        assert got[:9].diagonal().all()
    if s % 2 and mode != "all":  # the pad rule, as in pair_count
        assert _dpx_any(m[4:5], m[5:6], s, pad_rule=False)[0, 0]


def _signeq_shape_model(words, qr, rpt):
    """csrc/signeq.cu signeq_shape: (qp, cw, nc, ld) within two blocks'
    shared memory an SM."""
    qp = -(-words // 4) * 4
    room = (113 * 1024 - qr * qp * 4) // (2 * 256 * rpt * 4)
    lmax = 4 if room < 12 else (room - 4) // 8 * 8 + 4
    n0 = -(-qp // lmax)
    cw = (-(-words // n0) + 3) & ~3
    nc = -(-words // cw)
    ld = cw if (cw // 4) % 2 else cw + 4
    return qp, cw, nc, ld


@pytest.mark.parametrize("s", [1, 2, 99, 100, 250, 1000, 65535])
def test_signeq_stage_arithmetic(s):
    """The stages of every query group: chunks of a multiple of 4 words
    that cover the row (one chunk where S = 100's 50 words fit), a pitch
    with pitch / 4 odd (bank-free 16-byte loads of consecutive rows), and
    the queries and two stages within a block's shared memory (two blocks
    an SM where the queries leave room)."""
    words = (s + 1) // 2
    for qr in device._QUERY_GROUPS:
        if qr != device.query_group(qr, words):
            continue  # the wrapper halves qr for so many words
        rpt = device.row_tile(qr) // 256
        qp, cw, nc, ld = _signeq_shape_model(words, qr, rpt)
        assert cw % 4 == 0 and (nc - 1) * cw < words <= nc * cw
        assert (ld // 4) % 2 == 1 and cw <= ld <= cw + 4
        smem = (qr * qp + 2 * 256 * rpt * ld) * 4
        assert smem <= 227 * 1024
        if qr * qp * 4 <= 64 * 1024:
            assert smem <= 113 * 1024
        if s == 100 and rpt == 1:
            assert nc == 1


@pytest.mark.parametrize("nq", [1, 8, 64, 65, 101, 130])
@pytest.mark.parametrize("n,slots", [(1, 264), (700, 264), (661_000, 264),
                                     (5000, 3)])
def test_signeq_launch_covers_every_pair_once(nq, n, slots):
    """The launch of signeq.cu's count / any / all as the wrapper shapes
    it: query groups (grid.x) times equal row ranges (grid.y), each walked
    in tiles whose rows the threads own (lane l of warp v: v * 32 rpt + l
    + 32 i); every (query, row) pair is computed and stored exactly once,
    and no group holds more pad queries than it must."""
    words = 50
    qr, groups, row_blocks = device.signeq_shape(nq, n, words, slots)
    assert groups * qr >= nq > (groups - 1) * qr
    assert qr == min(16, 1 << (nq - 1).bit_length())
    assert 1 <= row_blocks <= max(1, slots // groups)
    rpt = device.row_tile(qr) // 256
    tr = 256 * rpt
    lane, warp = np.arange(256) % 32, np.arange(256) // 32
    owned = (warp[:, None] * 32 * rpt + lane[:, None]
             + 32 * np.arange(rpt)[None, :]).ravel()
    assert np.array_equal(np.sort(owned), np.arange(tr))
    hits = np.zeros(n, np.int64)
    for by in range(row_blocks):
        lo, hi = n * by // row_blocks, n * (by + 1) // row_blocks
        for t0 in range(lo, hi, tr):
            rows = t0 + owned
            np.add.at(hits, rows[rows < hi], 1)
    assert (hits == 1).all()  # per query group, so every pair once
    queries = np.concatenate([np.arange(g * qr, min(nq, g * qr + qr))
                              for g in range(groups)])
    assert np.array_equal(queries, np.arange(nq))


def _signeq_constants():
    """pair_count's launch constants, read from csrc/signeq.cu."""
    import re

    src = (REPO / "sketchtpu_torch" / "csrc" / "signeq.cu").read_text()
    found = {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
             for k in ("PT", "PTH", "PCW", "PSTAGES", "PRES")}
    found["PLD_PAD"] = int(re.search(r"constexpr int PLD = PT \+ (\d+);",
                                     src).group(1))
    return found


@pytest.mark.parametrize("s,chunks", [(1, (1, 1)), (99, (25, 2)),
                                      (100, (25, 2)), (130, (22, 3)),
                                      (192, (32, 3)), (1000, (32, 16))])
def test_pair_count_launch_arithmetic(s, chunks):
    """The word chunks are balanced (S = 100: two of 25, no short tail),
    the resident row tile and the ring fit two blocks an SM (227 KB of
    shared memory), and the tile is 128 x 128 pairs of 8 x 8 a thread."""
    c = _signeq_constants()
    assert c["PT"] == device._PAIR_TILE == 8 * c["PTH"]
    words = (s + 1) // 2
    nc = -(-words // c["PCW"])
    cw = -(-words // nc)
    assert (cw, nc) == chunks
    assert words - (nc - 1) * cw > cw // 2  # the last chunk is no tail
    pitch = (c["PT"] + c["PLD_PAD"]) * 4
    resident = words <= c["PRES"]
    smem = ((words if resident else 0)
            + c["PSTAGES"] * (1 if resident else 2) * cw) * pitch
    assert 2 * (smem + 1024) <= 228 * 1024
    assert (s <= 192) == resident




def test_device_inverted_engine_on_cpu_matches_host():
    mat = _signs(300, 65, 40, 5)
    inv = _inv(JaxInverted, JaxHashType, mat)
    queries = _signs(9, 65, 40, 6)
    queries[7] = mat[77]
    mat[212] = mat[77]
    engine = DeviceInvertedEngine(mat, torch.device("cpu"))
    counts = engine.match_counts(queries)
    anyr, allr = engine.any_shared_rows(queries), engine.all_shared_rows(queries)
    assert counts.dtype == np.int64 and allr[7].sum() == 2
    for qi in range(9):
        assert np.array_equal(counts[qi], inv.query_match_count(queries[qi]))
        assert np.array_equal(np.flatnonzero(anyr[qi]),
                              inv.any_shared_bins(queries[qi]))
        assert np.array_equal(np.flatnonzero(allr[qi]),
                              inv.all_shared_bins(queries[qi]))
    assert engine.any_shared_bin_count() == inv.any_shared_bin_count()
    assert engine.any_shared_bin_count(slice(30, 31)) == \
        inv.any_shared_bin_count(row_range=slice(30, 31))


# --- the sign mask of K3 and K2 against the masked JAX scans ------------------

def _u32(n, s64, rng):
    return rng.integers(0, 2**32, (n, s64 * 14 * 2), dtype=np.uint32)


def _t(m32):
    return torch.from_numpy(np.ascontiguousarray(m32).view(np.int64).copy())


def _mask_inputs(seed, s=37):
    """Rows are the first columns; signs in clusters so that about a third
    of the pairs are candidates; two rows with no candidate at all."""
    rng = np.random.default_rng(seed)
    s64, nb, tr = 4, 512, 256
    a = _u32(tr, s64, rng)
    b = _u32(nb, s64, rng)
    b[:tr] = a
    b[300] = b[10]
    sig = derive_signs(nb, s, 3, seed, redraw=0.5)
    sig[7] = rng.integers(0, 1 << 16, s)
    sig[9] = rng.integers(0, 1 << 16, s)
    return s64, a, b, sig


def _sig_mask(sig, tr, s):
    w = pack_signs(sig, "cpu")
    return SignMask(w[:tr], w, s)


@pytest.mark.parametrize("knn", [3, 40])
@pytest.mark.parametrize("nb_real", [512, 509])
def test_masked_selection_twin_matches_jax_packed_scan(nb_real, knn):
    """_knn_scan_block_packed(masked=True, pallas=True) in interpret mode:
    the same columns and samebits, -1 / missing where a row has fewer
    candidates (row 7 has none)."""
    s64, a, b, sig = _mask_inputs(31)
    want_v, want_i = _knn_scan_block_packed(
        chunk_group_major(jnp.asarray(a), s64),
        jnp.transpose(chunk_group_major(jnp.asarray(b), s64)),
        np.int32(0), np.int32(nb_real), s64=s64, knn=knn, tc=256,
        exclude_self=True, pallas=True, ti=256, tj=256, interpret=True,
        a_sig=jnp.asarray(sig[:256].astype(np.int32)),
        b_sig=jnp.asarray(sig.astype(np.int32)), masked=True,
    )
    sm = _sig_mask(sig, 256, sig.shape[1])
    sb, idx = knn_scan(_t(a), _t(b[:nb_real]), knn, exclude_self=True,
                       sig=sm)
    np.testing.assert_array_equal(sb, np.asarray(want_v))
    np.testing.assert_array_equal(idx, np.asarray(want_i))
    assert (sb[7] == knn_torch._NEG).all()
    keys = knn_select(_t(a), _t(b[:nb_real]), knn, exclude_self=True, sig=sm)
    assert torch.equal(keys, knn_select_ref(
        _t(a), _t(b[:nb_real]), knn, exclude_self=True, sig=sm, row_tile=100,
        col_tile=64))


@pytest.mark.parametrize("nb_real", [512, 509])
def test_masked_completeness_twin_matches_jax_comp_pallas(nb_real):
    s64, a, b, sig = _mask_inputs(32)
    rng = np.random.default_rng(33)
    c1 = rng.uniform(0.5, 1.0, a.shape[0]).astype(np.float32)
    c2 = rng.uniform(0.5, 1.0, b.shape[0]).astype(np.float32)
    c2[: a.shape[0]] = c1
    want_v, want_i = _knn_scan_block_comp_pallas(
        chunk_group_major(jnp.asarray(a), s64),
        jnp.transpose(chunk_group_major(jnp.asarray(b), s64)),
        np.int32(0), np.int32(nb_real),
        jnp.asarray(sig[:256].astype(np.int32)),
        jnp.asarray(sig.astype(np.int32)), jnp.asarray(c1), jnp.asarray(c2),
        s64=s64, knn=5, tc=256, exclude_self=True, masked=True, cutoff=0.64,
        ti=256, tj=256, interpret=True,
    )
    sb, idx = knn_scan(_t(a), _t(b[:nb_real]), 5, exclude_self=True,
                       comp_rows=c1, comp_cols=c2[:nb_real], cutoff=0.64,
                       sig=_sig_mask(sig, 256, sig.shape[1]))
    np.testing.assert_array_equal(sb, np.asarray(want_v))
    np.testing.assert_array_equal(idx, np.asarray(want_i))


@pytest.mark.parametrize("s", [1, 36, 37])
@pytest.mark.parametrize("comp", [False, True])
def test_masked_keys_twin_is_the_unmasked_keys_where_shared(comp, s):
    """The tile twin's mask against the plain equality of the sign rows:
    a key survives exactly where its rows share a sign."""
    s64, a, b, sig = _mask_inputs(34, s)
    c = (Completeness(torch.full((64,), 0.9), torch.full((512,), 0.8), 0.64,
                      s64) if comp else None)
    w = pack_signs(sig, "cpu")
    kw = dict(row0=100, col0=7, nb_real=300, exclude_self=True, comp=c)
    plain = knn_keys(_t(a[100:164]), _t(b[7:307]), **kw)
    masked = knn_keys(_t(a[100:164]), _t(b[7:307]),
                      sig=SignMask(w[100:164], w, s), **kw)
    shared = (sig[100:164, None, :] == sig[None, 7:307, :]).any(2)
    assert torch.equal(masked, torch.where(torch.from_numpy(shared), plain,
                                           -1))
    assert shared.any() and not shared.all()


def _ca_inputs(seed, s=21):
    rng = np.random.default_rng(seed)
    parents = rng.integers(0, 2**64, (3, len(KMERS), 4, 14), dtype=np.uint64)
    w = derive_words(parents, 96, KMERS, seed).reshape(96, len(KMERS), 56)
    sig = derive_signs(96, s, 3, seed, redraw=0.6)
    sig[5] = rng.integers(0, 1 << 16, s)
    return w, sig


@pytest.mark.parametrize("comp", [False, True])
def test_masked_coreacc_keys_match_jax_ca_pallas(comp, monkeypatch):
    """K2's masked key tile against _knn_scan_block_ca_pallas with its
    Pallas tile in interpret mode (the scan takes no interpret flag, so
    the tile it imports is wrapped here); f32 chains that differ in
    rounding, so: every candidate of a row is selected at knn = n, the
    same columns, and the core values within 1e-5 apart from pairs on the
    slope-0 discontinuity, where either chain may land on 0 or 1
    (counted)."""
    import functools

    from sketchtpu.dist import coreacc_pallas

    monkeypatch.setattr(coreacc_pallas, "coreacc_pallas", functools.partial(
        coreacc_pallas.coreacc_pallas, interpret=True))
    w, sig = _ca_inputs(41)
    n, s64, s = w.shape[0], 4, sig.shape[1]
    stack = jnp.asarray(np.ascontiguousarray(
        w.transpose(1, 0, 2)).view(np.uint32))
    cm = chunk_major(stack, s64)
    c = np.random.default_rng(42).uniform(0.7, 1, n).astype(np.float32)
    cj = dict(c1=jnp.asarray(c), c2=jnp.asarray(c)) if comp else {}
    core_j, _acc_j, idx_j = _knn_scan_block_ca_pallas(
        cm, jnp.transpose(cm), np.int32(0), np.int32(n),
        jnp.asarray(sig.astype(np.int32)), jnp.asarray(sig.astype(np.int32)),
        s64=s64, kmers=KMERS, sketch_size=256, knn=n, tc=n,
        exclude_self=True, masked=True, cutoff=0.64, **cj)
    core_j, idx_j = np.asarray(core_j), np.asarray(idx_j)
    wt = _t(w.reshape(n, -1).view(np.uint32)).view(n, len(KMERS), 56)
    sw = pack_signs(sig, "cpu")
    ct = (torch.from_numpy(c), torch.from_numpy(c)) if comp else (None, None)
    keys, _acc = coreacc_keys(wt, wt, KMERS, 256, *ct, row0=0, col0=0,
                              exclude_self=True, sig=SignMask(sw, sw, s))
    shared = (sig[:, None, :] == sig[None, :, :]).any(2)
    np.fill_diagonal(shared, False)
    assert torch.equal(keys == KEY_INVALID, torch.from_numpy(~shared))
    hi = (keys >> 32).to(torch.int32)
    core = -torch.where(hi < 0, hi ^ 0x7FFFFFFF, hi).view(torch.float32)
    jumps = fitted = 0
    for r in range(n):
        ok = np.isfinite(core_j[r])
        assert set(idx_j[r][ok]) == set(np.flatnonzero(shared[r]))
        got = core[r].numpy()
        want = {int(i): v for i, v in zip(idx_j[r][ok], core_j[r][ok])}
        for j in np.flatnonzero(shared[r]):
            g, w = float(got[j]), float(want[j])
            fitted += 0 < w < 1
            if min(g, w) < 1e-3 and max(g, w) == 1.0:
                jumps += 1
                continue
            assert abs(g - w) <= 1e-5
    assert fitted > n and jumps <= fitted // 50
    assert not shared[5].any()
    assert torch.equal(keys, coreacc_keys_ref(
        wt, wt, KMERS, 256, *ct, row0=0, col0=0, exclude_self=True,
        sig=SignMask(sw, sw, s))[0])


# --- precluster_knn against the JAX engine and the host oracle -----------------

@pytest.fixture(scope="module")
def pc_db(tmp_path_factory):
    """A 90-sample .skd/.skm (three k, related families) and its .ski/.skq
    (clustered signs, three samples that share no sign with any other),
    with one completeness file; the .ski lists the samples in .skd order
    (host ties break like the device's) and, permuted, in another."""
    d = tmp_path_factory.mktemp("torch_precluster")
    n, s = 90, 40
    rng = np.random.default_rng(7)
    parents = rng.integers(0, 2**64, (4, len(KMERS), 4, 14), dtype=np.uint64)
    words = derive_words(parents, n, KMERS, 7)
    names = [f"s{i:03d}" for i in range(n)]
    with skd.SketchDataWriter(str(d / "db.skd")) as wr:
        sketches = [Sketch(name=nm, index=wr.write_sketch(words[i].reshape(-1)))
                    for i, nm in enumerate(names)]
    MultiSketch(sketches, 256, list(KMERS), HashType("dna")).save_metadata(
        str(d / "db"))
    sig = derive_signs(n, s, 6, 8, redraw=0.7)
    for r in (4, 50, 88):
        sig[r] = rng.integers(0, 1 << 16, s)
    from sketchtpu_torch.synth import write_derived_inverted

    write_derived_inverted(str(d / "inv"), names, sig, 17)
    perm = rng.permutation(n)
    write_derived_inverted(str(d / "perm"), [names[i] for i in perm],
                           sig[perm], 17)
    (d / "comp.txt").write_text("".join(
        f"{nm}\t{c:.3f}\n" for nm, c in zip(names, rng.uniform(0.6, 1, n))))
    return d


def _load_both(d):
    port = MultiSketch.load_metadata(str(d / "db"))
    port.read_sketch_data(str(d / "db"))
    jax_ms = JaxMultiSketch.load_metadata(str(d / "db"))
    jax_ms.read_sketch_data(str(d / "db"))
    return port, jax_ms


def _comp_vec(d, ms):
    from sketchtpu_torch.ingest.inputs import read_completeness_file

    return read_completeness_file(str(d / "comp.txt"), ms)


PC_MODES = {
    "k17": dict(k=17, ani=False), "ani": dict(k=17, ani=True),
    "comp": dict(k=17, ani=False, comp=True),
    "singleton": dict(k=17, ani=False, retain="singleton"),
    "bruteforce": dict(k=17, ani=False, retain="bruteforce"),
    "ani_bruteforce": dict(k=17, ani=True, retain="bruteforce"),
    "coreacc": dict(k=None, ani=False),
    "coreacc_bruteforce": dict(k=None, ani=False, retain="bruteforce"),
    "coreacc_singleton": dict(k=None, ani=False, retain="singleton"),
    "coreacc_comp": dict(k=None, ani=False, comp=True),
}


def _pc_args(d, ms, mode, ski="inv"):
    cfg = PC_MODES[mode]
    inv = Inverted.load(str(d / ski))
    skq = skd.read_all_skq(str(d / f"{ski}.skq"))
    if cfg["k"] is None:
        api.set_k(ms, 17, False)
        dist_type = api.DistType()
    else:
        dist_type = api.set_k(ms, cfg["k"], cfg["ani"])
    comp = _comp_vec(d, ms) if cfg.get("comp") else None
    return inv, skq, dist_type, comp, cfg.get("retain")


def _rows_equal(got, want, exact=True):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [x[0] for x in g] == [x[0] for x in w]
        for x, y in zip(g, w):
            for a, b in zip(x[1:], y[1:]):
                if exact:
                    assert np.float32(a) == np.float32(b)
                else:
                    assert abs(float(a) - float(b)) <= 1e-5


@pytest.mark.parametrize("row_range", [None, slice(3, 61), slice(50, 51)])
@pytest.mark.parametrize("mode", list(PC_MODES))
def test_precluster_knn_matches_host_oracle(pc_db, mode, row_range):
    """The port's engine in cpu mode against the host oracle (the JAX
    package's api.self_dists_knn_precluster and the port's copy): the
    same rows, neighbours and values, exactly."""
    ms, jax_ms = _load_both(pc_db)
    inv, skq, dist_type, comp, retain = _pc_args(pc_db, ms, mode)
    got = DeviceKnnEngine(ms, torch.device("cpu")).precluster_knn(
        inv, skq, 5, dist_type, retain, row_range=row_range,
        completeness_vec=comp)
    jinv = JaxInverted.load(str(pc_db / "inv"))
    want = jax_api.self_dists_knn_precluster(
        jax_ms, jinv, skq, inv.sketch_size, 5, dist_type, comp, 0.64, retain,
        row_range=row_range)
    _rows_equal(got, want)
    copy = api.self_dists_knn_precluster(ms, inv, skq, inv.sketch_size, 5,
                                         dist_type, comp, 0.64, retain,
                                         row_range=row_range)
    _rows_equal(copy, want)
    if retain is not None and row_range is None:
        empty = [r for r in (4, 50, 88)]
        assert all(len(got[r]) >= 1 for r in empty)


@pytest.mark.parametrize("ski", ["inv", "perm"])
@pytest.mark.parametrize("mode", ["k17", "comp", "bruteforce", "coreacc",
                                  "coreacc_bruteforce", "ani"])
def test_precluster_knn_matches_jax_engine(pc_db, mode, ski):
    """Against the JAX DeviceKnnEngine.precluster_knn on JAX-CPU, also with
    a .ski whose sample order is not the .skd's (the name maps): the same
    neighbours; single-k values exact except the ANI rounding (the JAX
    engine prints f32(ANI), the port the host's 1 - f32(1 - ANI)) and
    core/accessory values within 1e-5 (f32 completeness there)."""
    ms, jax_ms = _load_both(pc_db)
    inv, skq, dist_type, comp, retain = _pc_args(pc_db, ms, mode, ski)
    got = DeviceKnnEngine(ms, torch.device("cpu")).precluster_knn(
        inv, skq, 5, dist_type, retain, completeness_vec=comp)
    want = JaxKnnEngine(jax_ms).precluster_knn(
        JaxInverted.load(str(pc_db / ski)), skq, 5, dist_type, retain,
        completeness_vec=comp)
    _rows_equal(got, want, exact=mode in ("k17", "bruteforce"))


# --- the CLI against the JAX package's, and the server ------------------------

_PORT_RUN = """
import contextlib, json, sys
from sketchtpu_torch.cli import main
for argv in json.loads(sys.argv[1]):
    out = None
    if ">" in argv:
        argv, out = argv[: argv.index(">")], argv[argv.index(">") + 1]
    with contextlib.ExitStack() as stack:
        if out is not None:
            stack.enter_context(contextlib.redirect_stdout(
                stack.enter_context(open(out, "w"))))
        assert main(argv) == 0, argv
assert "jax" not in sys.modules, "the port loaded jax"
assert not [m for m in sys.modules if m.split(".")[0] == "sketchtpu"]
print("PORT-RUN-OK")
"""

PRECLUSTER_FORMS = {
    "k17": [], "ani": ["--ani"], "singleton": ["--retain-unmatched",
                                               "singleton"],
    "bruteforce": ["--retain-unmatched", "bruteforce"],
    "coreacc": ["--core-acc"],
}


def _cli_commands(d: Path, p: str) -> list[list[str]]:
    p = str(d / p)
    mixed = str(d / "mixed.txt")
    cmds = [
        ["sketch", "-f", mixed, "-o", f"{p}db", "-k", "17,21,25", "-s", "256",
         "--min-count", "2", "--quiet"],
        ["inverted", "build", "-f", mixed, "-o", f"{p}inv", "-s", "100", "-k",
         "17", "--write-skq", "--min-count", "2", "--quiet"],
        ["inverted", "build", "-f", mixed, "-o", f"{p}inv_sp", "-k", "17",
         "--write-skq", "--species-names", str(d / "species.txt"),
         "--metadata", str(d / "meta.txt"), "--min-count", "2", "--quiet"],
        ["info", f"{p}inv_sp.ski", ">", f"{p}info.txt"],
        ["info", f"{p}inv_sp.ski", "--sample-info", ">", f"{p}info_s.txt"],
        ["inverted", "precluster", f"{p}inv.ski", "--count", ">",
         f"{p}count.txt"],
    ]
    for q in ("match-count", "all-bins", "any-bins"):
        cmds.append(["inverted", "query", f"{p}inv_sp.ski", "-f", mixed,
                     "--query-type", q, "--min-count", "2", "-o",
                     f"{p}query_{q}.txt", "--quiet"])
    for name, flags in PRECLUSTER_FORMS.items():
        cmds.append(["inverted", "precluster", f"{p}inv.ski", "--skd",
                     f"{p}db", "--knn", "3", *flags, "-o",
                     f"{p}pc_{name}.txt", "--quiet"])
    cmds.append(["inverted", "precluster", f"{p}inv.ski", "--skd", f"{p}db",
                 "--knn", "3", "--ref-completeness-file", str(d / "comp.txt"),
                 "-o", f"{p}pc_comp.txt", "--quiet"])
    cmds.append(["dist", str(d / "big"), "-k", "17", "--knn", "1025", "-o",
                 f"{p}knn1025.txt", "--quiet"])
    return cmds


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_inverted_cli")
    rfile = related_assemblies(d / "fa", 5, 15000, seed=17, max_contigs=5)
    lines = rfile.read_text().splitlines(keepends=True)
    lines += read_samples(d / "fq", 2, 5000, 10, seed=18)
    lines += read_samples(d / "fq", 1, 5000, 10, seed=19, paired=True)
    (d / "mixed.txt").write_text("".join(lines))
    names = [ln.split("\t")[0] for ln in lines]
    (d / "species.txt").write_text("".join(
        f"{nm}\tsp{i % 3}\n" for i, nm in enumerate(names)))
    (d / "meta.txt").write_text("".join(f"{nm}\tm{i}\n"
                                        for i, nm in enumerate(names)))
    rng = np.random.default_rng(20)
    (d / "comp.txt").write_text("".join(
        f"{nm}\t{c:.3f}\n" for nm, c in zip(names, rng.uniform(0.6, 1, 8))))
    # a database past the card's selection limit: 1100 derived samples
    from sketchtpu_torch.synth import derive_database

    parent = d / "parent"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SKETCHTPU_BACKEND", "host")
        assert jax_cli.main(["sketch", "-f", str(rfile), "-o", str(parent),
                             "-k", "17,21", "-s", "256", "--quiet"]) == 0
    derive_database(str(parent), str(d / "big"), 1100, 21)
    proc = subprocess.run(
        [sys.executable, "-c", _PORT_RUN,
         json.dumps(_cli_commands(d, "port_"))],
        env={**os.environ, "SKETCHTPU_TORCH_BACKEND": "cpu",
             "PYTHONPATH": str(REPO)},
        capture_output=True, text=True, timeout=900, cwd=d)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SKETCHTPU_BACKEND", "host")
        for argv in _cli_commands(d, "host_"):
            out = None
            if ">" in argv:
                argv, out = argv[: argv.index(">")], argv[argv.index(">") + 1]
            with contextlib.ExitStack() as stack:
                if out is not None:
                    stack.enter_context(contextlib.redirect_stdout(
                        stack.enter_context(open(out, "w"))))
                assert jax_cli.main(argv) == 0, argv
    return d, proc.stdout


def test_port_inverted_run_never_loads_jax(cli_runs):
    assert "PORT-RUN-OK" in cli_runs[1]


CLI_OUTPUTS = (
    ["db.skd", "db.skm", "inv.ski", "inv.skq", "inv_sp.ski", "inv_sp.skq",
     "info.txt", "info_s.txt", "count.txt", "pc_comp.txt", "knn1025.txt"]
    + [f"query_{q}.txt" for q in ("match-count", "all-bins", "any-bins")]
    + [f"pc_{name}.txt" for name in PRECLUSTER_FORMS]
)


@pytest.mark.parametrize("name", CLI_OUTPUTS)
def test_inverted_cli_identical_to_host(cli_runs, name):
    d = cli_runs[0]
    got, want = d / f"port_{name}", d / f"host_{name}"
    assert got.stat().st_size > 0
    assert got.read_bytes() == want.read_bytes()


def test_precluster_reaches_rows_without_candidates(cli_runs):
    """The reads samples share no sign with the others at -s 100, so the
    singleton and bruteforce forms differ from the plain one."""
    d = cli_runs[0]
    plain = (d / "port_pc_k17.txt").read_text()
    assert plain != (d / "port_pc_singleton.txt").read_text()
    assert plain != (d / "port_pc_bruteforce.txt").read_text()


def test_knn_1025_rows(cli_runs):
    d = cli_runs[0]
    lines = (d / "port_knn1025.txt").read_text().splitlines()
    assert len(lines) == 1100 * 1025


def _serve(server):
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server.server_address[1]


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_serve_answers_as_the_jax_server(cli_runs):
    """GET /info, POST /match-count and POST /query of the port's server
    (cpu engines) against the JAX package's server on the same .ski."""
    d = cli_runs[0]
    body = Path((d / "mixed.txt").read_text().splitlines()[1]
                .split("\t")[1]).read_bytes()
    fq = Path((d / "mixed.txt").read_text().splitlines()[5]
              .split("\t")[1]).read_bytes()
    inv = Inverted.load(str(d / "port_inv_sp"))
    port_srv = make_server(inv, "127.0.0.1", 0,
                           backend=_cpu_backend(),
                           engine=DeviceInvertedEngine(inv.sign_matrix,
                                                       torch.device("cpu")))
    jax_srv = jax_make_server(JaxInverted.load(str(d / "host_inv_sp")),
                              "127.0.0.1", 0)
    ports = (_serve(port_srv), _serve(jax_srv))
    try:
        reqs = [("GET", "/info", None),
                ("POST", "/match-count?name=x&min_count=1", body),
                ("POST", "/match-count?min_count=2", fq),
                ("POST", "/query?nouts=4&min_count=1", body),
                ("POST", "/query", b""), ("GET", "/nope", None)]
        for method, path, data in reqs:
            got = _request(ports[0], method, path, data)
            assert got == _request(ports[1], method, path, data), path
        assert got[0] == 404
    finally:
        for srv in (port_srv, jax_srv):
            srv.shutdown()
            srv.server_close()


def _cpu_backend():
    from sketchtpu_torch.sketchcore.sketch_torch import DeviceSketchBackend

    return DeviceSketchBackend(torch.device("cpu"))


# --- the two repairs: dispatch on CUDA tensors --------------------------------

def test_knn_past_max_knn_on_cuda_takes_tiles_and_merge(monkeypatch):
    """knn > MAX_KNN on a CUDA tensor never reaches knn_select: K3's tile
    keys (knn_keys) merged by torch.topk (_merge), the selection
    knn_select_ref makes."""
    from tests.test_torch_runtime import _FakeCuda

    g = torch.Generator().manual_seed(3)
    w = torch.randint(-2**62, 2**62, (40, 56), generator=g)
    tiles = []

    def keys(a, b, **kw):
        tiles.append((a.shape[0], b.shape[0], kw["col0"]))
        return knn_keys_ref(a._t, b._t, **kw)

    monkeypatch.setattr(knn_torch, "knn_keys", keys)
    monkeypatch.setattr(knn_torch, "knn_select",
                        lambda *a, **kw: pytest.fail("knn_select reached"))
    monkeypatch.setattr(torch, "full", lambda *a, device=None, **kw:
                        torch.ones(1).new_full(*a, **kw))

    class Rows(_FakeCuda):
        def __getitem__(self, s):
            return Rows(self._t[s])

    knn = knn_kernels.MAX_KNN + 1
    got = knn_torch.select_keys(Rows(w), Rows(w), knn, exclude_self=True)
    monkeypatch.undo()
    assert tiles == [(40, 40, 0)]
    want = knn_select_ref(w, w, knn, exclude_self=True)
    assert torch.equal(got, want)
    small = knn_torch._select_tiles(w, w, 5, row0=0, nb_real=40,
                                    exclude_self=True, comp=None, sig=None,
                                    row_tile=16, col_tile=8)
    assert torch.equal(small, knn_select_ref(w, w, 5, exclude_self=True))


def test_select_keys_keeps_one_selection_launch_up_to_max_knn(monkeypatch):
    calls = []
    monkeypatch.setattr(knn_torch, "knn_select",
                        lambda *a, **kw: calls.append(a[2]) or "sel")
    monkeypatch.setattr(knn_torch, "_select_tiles",
                        lambda *a, **kw: pytest.fail("tiles"))
    w = torch.zeros((4, 56), dtype=torch.int64)
    assert knn_torch.select_keys(w, w, knn_kernels.MAX_KNN) == "sel"
    assert knn_torch.select_keys(w, w, knn_kernels.MAX_KNN + 7) == "sel"
    assert calls == [knn_kernels.MAX_KNN, knn_kernels.MAX_KNN + 7]
