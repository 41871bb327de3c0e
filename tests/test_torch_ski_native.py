"""The .ski read through the host helper (csrc/host/native.cpp: the snappy
frame in one call, stpu_ski_bins_* and stpu_msgpack_strs, read by
formats/snappy.py and Inverted._parse_native) against the Python path it
replaces (formats/snappy.py's chunk loop, msgpack.loads and
roaring.deserialize in Inverted._parse): the sign matrix, names, metadata,
labels, k, version, rc and hash type, for one thread and for many; the
fallback on every payload outside the helper's subset; the frame's chunk
kinds and its errors; the raw block's overlapping copies and the checksum
against the JAX package's pure-Python codec; and that a helper that does
not build raises with the compiler's message."""

import struct

import numpy as np
import pytest

from portbench.databases import index as bench_index
from sketchtpu.formats import snappy as jax_snappy
from sketchtpu_torch import _native
from sketchtpu_torch.formats import msgpack, roaring, snappy
from sketchtpu_torch.inverted.index import Inverted
from sketchtpu_torch.sketchcore.sketch import HashType

WORKERS = [1, 3, 8]
ATTRS = ("sample_names", "metadata", "labels", "kmer_size", "sketch_version",
         "rc", "hash_type", "n_samples")


def _lib():
    return _native.lib()


def _signs(n, s, alphabet, seed):
    rng = np.random.default_rng(seed)
    mat = rng.integers(0, alphabet, (n, s)).astype(np.uint16)
    mat[rng.random((n, s)) < 0.01] = np.uint16(0xFFFF)
    return mat


def _payload(inv: Inverted) -> bytes:
    return msgpack.dumps(inv.to_serde())


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as e:  # the error itself is what is compared
        return "raised", (type(e), str(e))


def _assert_same(got: Inverted, want: Inverted) -> None:
    assert got.sign_matrix.dtype == np.uint16
    assert got.sign_matrix.flags.c_contiguous
    assert np.array_equal(got.sign_matrix, want.sign_matrix)
    for attr in ATTRS:
        assert getattr(got, attr) == getattr(want, attr), attr
        assert type(getattr(got, attr)) is type(getattr(want, attr)), attr


def _check_native(payload: bytes, workers: int) -> Inverted:
    """The payload decodes natively, into what the Python path gives."""
    _lib()
    got = Inverted._parse_native(payload, workers=workers)
    assert got is not None
    _assert_same(got, Inverted._parse(payload))
    return got


# --- the index ----------------------------------------------------------------

NAMES = {
    "ascii": lambda n: [f"g{i}" for i in range(n)],
    "utf8": lambda n: [f"génome_{i}_ß中\U0001f9ec" for i in range(n)],
    "nul": lambda n: [f"a\0{i}" if i % 7 == 0 else f"b{i}" for i in range(n)],
    "empty": lambda n: ["" if i % 3 else f"x{i}" for i in range(n)],
}


@pytest.mark.parametrize("workers", WORKERS)
@pytest.mark.parametrize("n,s,alphabet", [
    (37, 11, 60000),  # fixmap bins, array containers
    (900, 7, 300),  # map16 bins
    (70001, 3, 5),  # two container keys: bitset and array containers
])
def test_index_equals_python_path(n, s, alphabet, workers):
    mat = _signs(n, s, alphabet, n)
    inv = Inverted(mat, NAMES["ascii"](n), 17, True, HashType("dna"))
    got = _check_native(_payload(inv), workers)
    assert np.array_equal(got.sign_matrix, mat)


@pytest.mark.parametrize("workers", [1, 8])
def test_map32_bin(workers):
    """A bin of 65,536 distinct signs is a map32; the others a fixmap."""
    n = 70000
    mat = np.zeros((n, 2), np.uint16)
    mat[:, 0] = np.arange(n) % 65536
    payload = _payload(Inverted(mat, NAMES["ascii"](n), 17, True,
                                HashType("dna")))
    lib = _lib()
    base = np.frombuffer(payload, np.uint8).ctypes.data
    starts = np.empty(3, np.int64)
    assert lib.stpu_ski_bins_scan(base, len(payload), starts.ctypes.data,
                                  3) == 2
    assert payload[starts[0]] == 0xDF and payload[starts[1]] == 0x81
    got = _check_native(payload, workers)
    assert np.array_equal(got.sign_matrix, mat)


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("names", sorted(NAMES))
@pytest.mark.parametrize("lists", ["both", "none", "metadata", "labels"])
def test_names_metadata_labels(names, lists, workers):
    n = 300
    meta = [f"m{i}é" for i in range(n)]
    labels = [f"sp{i % 5}\0" if i % 2 else f"sp{i % 5}" for i in range(n)]
    inv = Inverted(
        _signs(n, 9, 40, 5), NAMES[names](n), 21, False, HashType("dna"),
        metadata=meta if lists in ("both", "metadata") else None,
        labels=labels if lists in ("both", "labels") else None)
    got = _check_native(_payload(inv), workers)
    assert got.sample_names == NAMES[names](n)
    assert got.metadata == inv.metadata and got.labels == inv.labels


@pytest.mark.parametrize("hash_type", [HashType("dna"), HashType("pdb"),
                                       HashType("aa", 2)])
def test_hash_types_and_version(hash_type):
    inv = Inverted(_signs(50, 4, 9, 6), NAMES["ascii"](50), 9, True,
                   hash_type, sketch_version="0.2.9")
    got = _check_native(_payload(inv), 2)
    assert got.hash_type == hash_type and got.sketch_version == "0.2.9"


def test_empty_index():
    inv = Inverted(np.zeros((0, 5), np.uint16), [], 17, True,
                   HashType("dna"))
    got = _check_native(_payload(inv), 4)
    assert got.sign_matrix.shape == (0, 5) and got.sample_names == []


@pytest.mark.parametrize("workers", WORKERS)
@pytest.mark.parametrize("writer", ["port", "bench"])
def test_benchmark_layout(tmp_path, writer, workers):
    """An index of the benchmark's layout (portbench/databases/index.py:
    clusters of signs, a bin re-drawn at 0.3, S = 100), written by the
    port's Inverted.save and by the benchmark's own writer, read by
    Inverted.load with either path."""
    config = {"samples": 5000, "sketch_size": 100, "clusters": 40,
              "redraw": 0.3, "k": 17}
    signs = bench_index.generate(config, 2147003001)
    names = [f"sample_{i:06d}" for i in range(5000)]
    if writer == "port":
        Inverted(signs, names, 17, True, HashType("dna")).save(
            str(tmp_path / "index"))
    else:
        bench_index.write(tmp_path / "index.ski", signs, names, 17)
    payload = snappy.frame_decompress((tmp_path / "index.ski").read_bytes(),
                                      workers=workers)
    got = _check_native(payload, workers)
    assert np.array_equal(got.sign_matrix, signs)
    assert got.sample_names == names
    loaded = Inverted.load(str(tmp_path / "index"))
    _assert_same(loaded, got)


# --- payloads outside the helper's subset -------------------------------------

def _run_blob(members: np.ndarray) -> bytes:
    """A roaring bitmap with one run container (cookie 12347)."""
    lo, hi = int(members.min()), int(members.max())
    assert np.array_equal(members, np.arange(lo, hi + 1))
    return (struct.pack("<I", 12347) + b"\x01"
            + struct.pack("<HH", 0, hi - lo) + struct.pack("<H", 1)
            + struct.pack("<HH", lo, hi - lo))


def _serde(index, n, names=None, meta=None, labels=None):
    names = NAMES["ascii"](n) if names is None else names
    return [index, n, names, meta, labels, 17, "0.3.0", True, "DNA"]


def _plain_index(n):
    return [{3: roaring.serialize(np.arange(n // 2)),
             9: roaring.serialize(np.arange(n // 2, n))}]


FALLBACKS = {
    # a run container, which the Python path reads
    "run_container": lambda: msgpack.dumps(_serde(
        [{5: _run_blob(np.arange(10, 40))}, {}], 50)),
    # a key above 0xFFFF
    "wide_key": lambda: msgpack.dumps(_serde(
        [{0x10005: roaring.serialize(np.arange(4))}], 10)),
    # a sample name that is not a str
    "int_name": lambda: msgpack.dumps(_serde(
        _plain_index(6), 6, names=["a", "b", 7, "d", "e", "f"])),
    # invalid UTF-8 in a name
    "bad_utf8": lambda: msgpack.dumps(_serde(_plain_index(4), 4)).replace(
        b"\xa2g1", b"\xa2\xff1"),
    # a member past the sample count
    "member_past_n": lambda: msgpack.dumps(_serde(
        [{1: roaring.serialize(np.array([0, 2, 12]))}], 10)),
    # a top-level array of another length
    "short_struct": lambda: msgpack.dumps(_serde(_plain_index(4), 4)[:8]),
    # metadata of ints: the helper leaves it to msgpack.py, the rest its own
    "int_metadata": lambda: msgpack.dumps(_serde(
        _plain_index(4), 4, meta=[1, 2, 3, 4])),
}


@pytest.mark.parametrize("case", sorted(FALLBACKS))
def test_fallback_is_the_python_path(case):
    _lib()
    payload = FALLBACKS[case]()
    native = Inverted._parse_native(payload)
    if case == "int_metadata":
        _assert_same(native, Inverted._parse(payload))
        assert native.metadata == [1, 2, 3, 4]
        return
    assert native is None
    got = _outcome(lambda: _parse_like_load(payload))
    want = _outcome(lambda: Inverted._parse(payload))
    assert got[0] == want[0] == (
        "ok" if case in ("run_container", "int_name") else "raised")
    if got[0] == "ok":
        _assert_same(got[1], want[1])
    else:
        assert got[1] == want[1]


def _parse_like_load(payload: bytes) -> Inverted:
    return Inverted._parse_native(payload) or Inverted._parse(payload)


@pytest.mark.parametrize("cut", [1, 2, 5, 40, 300, 2000])
def test_truncated_payload(cut):
    """Every cut of a payload's tail or its bins: the helper declines, and
    the Python path raises (or reads) what it always did."""
    _lib()
    inv = Inverted(_signs(400, 6, 30, 9), NAMES["utf8"](400), 17, True,
                   HashType("dna"), metadata=[f"m{i}" for i in range(400)])
    payload = _payload(inv)[:-cut]
    assert Inverted._parse_native(payload) is None
    got = _outcome(lambda: _parse_like_load(payload))
    want = _outcome(lambda: Inverted._parse(payload))
    assert got[0] == want[0] == "raised" and got[1] == want[1]


def test_helper_that_does_not_build_raises_with_the_compilers_message(
        tmp_path, monkeypatch):
    """The port needs its host helper as it needs its kernels: a source
    g++ rejects makes lib() raise with g++'s own message, leaves no
    library or temporary file, and a load of a .ski then raises too."""
    inv = Inverted(_signs(50, 8, 20, 3), NAMES["utf8"](50), 17, True,
                   HashType("dna"))
    inv.save(str(tmp_path / "a"))
    src = tmp_path / "broken.cpp"
    src.write_text('extern "C" int stpu_broken() { return undeclared_x; }\n')
    monkeypatch.setattr(_native, "_SRC", src)
    monkeypatch.setattr(_native, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_native, "_loaded", None)
    with pytest.raises(RuntimeError, match="undeclared_x") as err:
        _native.lib()
    assert "g++ failed" in str(err.value) and "broken.cpp" in str(err.value)
    assert not [p for p in (tmp_path / "build").iterdir()
                if p.name != ".lock"]
    with pytest.raises(RuntimeError, match="undeclared_x"):
        Inverted.load(str(tmp_path / "a"))


# --- the snappy frame ---------------------------------------------------------

def _chunk(ctype: int, body: bytes) -> bytes:
    return bytes([ctype]) + len(body).to_bytes(3, "little") + body


def _compressible(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(1, 9), np.uint8))
             for _ in range(200)]
    return b"".join(words[i] for i in rng.integers(0, 200, n // 4))[:n]


def _frames():
    text = _compressible(300_000, 1)
    noise = np.random.default_rng(2).bytes(150_000)  # stored uncompressed
    mixed = text[:70_000] + noise[:70_000] + text[70_000:200_000]
    framed = snappy.frame_compress(mixed)
    ident = snappy._STREAM_IDENTIFIER
    first = 10 + 4 + int.from_bytes(framed[11:14], "little")
    return {
        "compressed": (snappy.frame_compress(text), text),
        "uncompressed": (snappy.frame_compress(noise), noise),
        "mixed": (framed, mixed),
        "empty": (snappy.frame_compress(b""), b""),
        "padding_skippable": (
            framed[:first] + _chunk(0xFE, b"\0" * 9) + _chunk(0x80, b"x")
            + _chunk(0xFD, b"") + framed[first:] + _chunk(0xFE, b""), mixed),
        "repeated_identifier": (
            framed[:first] + ident + framed[first:] + ident, mixed),
    }


@pytest.mark.parametrize("workers", WORKERS)
@pytest.mark.parametrize("case", sorted(_frames()))
def test_frame_equals_python_path(case, workers):
    _lib()
    framed, data = _frames()[case]
    got = snappy._frame_decompress_native(framed, True, workers)
    assert got is not None and got[0] == data and type(got[0]) is bytes
    assert snappy.frame_decompress(framed, workers=workers) == data
    assert snappy._frame_decompress_py(framed, True) == data


def _flip(framed: bytes, at: int) -> bytes:
    out = bytearray(framed)
    out[at] ^= 0x5A
    return bytes(out)


def _bad_frames():
    framed, _ = _frames()["mixed"]
    first = 10 + 4 + int.from_bytes(framed[11:14], "little")
    return {
        "crc_first": _flip(framed, 14),
        "crc_later": _flip(framed, first + 5),
        "body_byte": _flip(framed, first + 400),
        "unknown_type": framed[:first] + _chunk(0x02, b"abcd") + framed[first:],
        "reserved_type": framed[:first] + _chunk(0x7F, b"") + framed[first:],
        "truncated": framed[:-7],
        "no_identifier": framed[10:],
        "bad_varint": framed[:first] + _chunk(0x00, b"\0\0\0\0\xff\xff")
        + framed[first:],
    }


@pytest.mark.parametrize("workers", [1, 8])
@pytest.mark.parametrize("case", sorted(_bad_frames()))
def test_bad_frame_raises_as_python_path(case, workers):
    _lib()
    framed = _bad_frames()[case]
    assert snappy._frame_decompress_native(framed, True, workers) is None
    got = _outcome(lambda: snappy.frame_decompress(framed, workers=workers))
    assert got == _outcome(lambda: snappy._frame_decompress_py(framed, True))
    assert got[0] == "raised"
    if case.startswith("crc"):
        assert got[1] == (ValueError, "snappy frame checksum mismatch")
    if case == "unknown_type":
        assert got[1] == (ValueError, "unskippable unknown chunk type 0x02")


def test_unverified_frame_skips_the_checksum():
    _lib()
    framed = _bad_frames()["crc_later"]
    _, data = _frames()["mixed"]
    assert snappy.frame_decompress(framed, verify_checksums=False) == data


# --- the raw block and the checksum -------------------------------------------

def _varint(v: int) -> bytes:
    return jax_snappy._write_varint(v)


def _random_block(seed: int) -> bytes:
    """A raw block of literals and copies, many overlapping (offset < 8),
    of every tag kind."""
    rng = np.random.default_rng(seed)
    elems, out_len = [], 0
    while out_len < 20_000:
        if out_len == 0 or rng.random() < 0.25:
            n = int(rng.integers(1, 70))
            lit = rng.bytes(n)
            elems.append(bytes([(n - 1) << 2]) if n <= 60
                         else bytes([60 << 2, n - 1]))
            elems.append(lit)
            out_len += n
            continue
        kind = int(rng.integers(1, 4))
        offset = int(rng.integers(1, 8)) if rng.random() < 0.6 else int(
            rng.integers(1, min(out_len, 2047) + 1))
        offset = min(offset, out_len)
        if kind == 1:
            length = int(rng.integers(4, 12))
            elems.append(bytes([1 | ((length - 4) << 2) | ((offset >> 8) << 5),
                                offset & 0xFF]))
        else:
            length = int(rng.integers(1, 65))
            elems.append(bytes([kind | ((length - 1) << 2)])
                         + offset.to_bytes(2 if kind == 2 else 4, "little"))
        out_len += length
    return _varint(out_len) + b"".join(elems)


@pytest.mark.parametrize("seed", range(6))
def test_overlapping_copies_equal_python(seed):
    _lib()
    block = _random_block(seed)
    want = jax_snappy._decompress_raw_py(block)
    assert snappy.decompress_raw(block) == want
    framed = (snappy._STREAM_IDENTIFIER
              + _chunk(0x00, struct.pack("<I", snappy._masked_crc(want))
                       + block))
    assert snappy.frame_decompress(framed) == want


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 63, 64, 4099, 65536])
def test_crc32c_instruction_equals_table(n):
    lib = _lib()
    data = np.random.default_rng(n).bytes(n)
    want = jax_snappy._crc32c_py(data)
    assert lib.stpu_crc32c(data, n, 0) == want
    assert lib.stpu_crc32c_table(data, n, 0) == want
    assert lib.stpu_crc32c(data, n, 0x1234) == \
        lib.stpu_crc32c_table(data, n, 0x1234)


def test_new_bytes_are_their_own():
    """Each payload the helper fills is a new bytes object, never one
    shared with another value."""
    _lib()
    framed, data = _frames()["compressed"]
    a = snappy.frame_decompress(framed)
    b = snappy.frame_decompress(framed)
    assert a == b == data and a is not b
    one = snappy.frame_compress(b"z")
    assert snappy.frame_decompress(one) == b"z"
    assert b"z" == bytes([122])
