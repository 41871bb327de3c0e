"""The .skm metadata's native decoder (csrc/host/native.cpp, stpu_skm_decode,
read by formats/skm.py's SkmColumns) against the Python path it replaces
(formats/cbor.py's loads and Sketch.from_serde): every Sketch field,
name_map, kmer_lengths, sizes, strides, sketch_version and hash_type on
the files the port and the benchmark write, on hand-made payloads at the
edges of the schema, and the fallback on anything outside it; the CLI's
output with either; and that a dist --knn run builds no Sketch object.
The Python path is reached by name: SkmColumns.decode declining, as it
does for a payload outside the native decoder's subset."""

import logging
from pathlib import Path

import numpy as np
import pytest

from portbench.databases import sketches as bench_sketches
from sketchtpu_torch import cli as port_cli
from sketchtpu_torch.constants import BBITS
from sketchtpu_torch.formats import cbor, skd, snappy
from sketchtpu_torch.formats.skm import MultiSketch, SkmColumns
from sketchtpu_torch.sketchcore.sketch import HashType, Sketch
from sketchtpu_torch.synth import (derive_words, related_assemblies,
                                   related_proteomes)

ATTRS = ("sketch_size", "sketchsize64", "kmer_lengths", "bin_stride",
         "kmer_stride", "sample_stride", "sketch_version", "hash_type")


def _payload(prefix) -> bytes:
    return snappy.frame_decompress(Path(f"{prefix}.skm").read_bytes())


def _declined(mp) -> None:
    """Make the native decoder decline every payload: _from_payload then
    takes cbor.loads and MultiSketch's Python construction."""
    mp.setattr(SkmColumns, "decode", classmethod(lambda cls, payload: None))


def _python_path(payload: bytes, monkeypatch) -> MultiSketch:
    with monkeypatch.context() as mp:
        _declined(mp)
        return MultiSketch._from_payload(payload)


def _typed(value):
    """A value with the type of each part, so that 1 and True differ."""
    if isinstance(value, (tuple, list)):
        return type(value), [_typed(v) for v in value]
    return type(value), value


def _assert_same(got: MultiSketch, want: MultiSketch) -> None:
    assert [_typed(list(vars(s).values())) for s in got.sketch_metadata] == \
        [_typed(list(vars(s).values())) for s in want.sketch_metadata]
    assert list(got.name_map.items()) == list(want.name_map.items())
    assert _typed(list(got.name_map.values())) == \
        _typed(list(want.name_map.values()))
    for attr in ATTRS:
        assert getattr(got, attr) == getattr(want, attr), attr
    n = len(want.sketch_metadata)
    assert got.number_samples_loaded() == n
    assert [got.sketch_name(i) for i in range(n)] == \
        [s.name for s in want.sketch_metadata]


def _check_native(payload: bytes, monkeypatch) -> MultiSketch:
    """The payload decodes natively, into what the Python path gives."""
    assert SkmColumns.decode(payload) is not None
    want = _python_path(payload, monkeypatch)
    # names and counts from the columns, before any Sketch is built
    got = MultiSketch._from_payload(payload)
    assert got._sketches is None
    assert [got.sketch_name(i) for i in range(len(want.sketch_metadata))] \
        == [s.name for s in want.sketch_metadata]
    _assert_same(got, want)
    return got


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as e:  # the error itself is what is compared
        return "raised", (type(e), str(e))


def _check_fallback(payload: bytes, monkeypatch) -> None:
    """The payload is not the native decoder's: it returns None, and
    load_metadata's result (or error) is the Python path's."""
    assert SkmColumns.decode(payload) is None
    got = _outcome(lambda: MultiSketch._from_payload(payload))
    want = _outcome(lambda: _python_path(payload, monkeypatch))
    assert got[0] == want[0]
    if got[0] == "ok":
        _assert_same(got[1], want[1])
    else:
        assert got[1] == want[1]


def _record(i: int, **fields) -> dict:
    rec = {"name": f"s{i}", "index": i, "rc": True, "reads": False,
           "seq_length": 1000 + i, "densified": False,
           "acgt": [i, i + 1, i + 2, i + 3], "non_acgt": i % 3}
    rec.update(fields)
    return rec


def _serde(records, name_map=None, **top) -> dict:
    obj = {"sketch_size": 1024, "sketchsize64": 16, "kmer_lengths": [17, 21],
           "sketch_metadata": records,
           "name_map": ({r["name"]: i for i, r in enumerate(records)}
                        if name_map is None else name_map),
           "bin_stride": 1, "kmer_stride": 1024, "sample_stride": 2048,
           "sketch_version": "0.3.0", "hash_type": "DNA"}
    obj.update(top)
    return obj


@pytest.mark.parametrize("n", [1, 7, 2000])
def test_benchmark_databases(tmp_path, monkeypatch, n):
    words = np.zeros((n, 1, 16, 14), np.uint64)
    bench_sketches.write(tmp_path / "db", words, [17], 20260000 + n)
    _check_native(_payload(tmp_path / "db"), monkeypatch)


def test_empty_database(monkeypatch):
    ms = _check_native(cbor.dumps(_serde([])), monkeypatch)
    assert ms.number_samples_loaded() == 0 and ms.name_map == {}


@pytest.fixture(scope="module")
def sketched(tmp_path_factory):
    """The port's own .skm files: DNA assemblies, and proteomes at each
    level, sketched on the CPU twins."""
    d = tmp_path_factory.mktemp("skm_native")
    rfile = related_assemblies(d / "fa", 5, 6000, 23, max_contigs=3)
    faa = related_proteomes(d / "faa", 4, 12, 200, 29)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SKETCHTPU_TORCH_BACKEND", "cpu")
        assert port_cli.main(["sketch", "-f", str(rfile), "-o",
                              str(d / "dna"), "-k", "17,21", "-s", "256",
                              "--quiet"]) == 0
        for lv in (1, 2, 3):
            assert port_cli.main([
                "sketch", "-f", str(faa), "-o", str(d / f"aa{lv}"), "-k",
                "6,9", "-s", "128", "--seq-type", "aa", "--level",
                f"level{lv}", "--quiet"]) == 0
    return d


@pytest.mark.parametrize("db", ["dna", "aa1", "aa2", "aa3"])
def test_port_sketch_databases(sketched, monkeypatch, db):
    ms = _check_native(_payload(sketched / db), monkeypatch)
    level = {"dna": None, "aa1": 1, "aa2": 2, "aa3": 3}[db]
    assert ms.hash_type == (HashType("dna") if level is None
                            else HashType("aa", level))


def test_reference_fixture(ref_in, monkeypatch):
    files = sorted(ref_in.glob("*.skm"))
    if not files:
        pytest.skip("no .skm among the reference fixtures")
    for f in files:
        _check_native(_payload(f.with_suffix("")), monkeypatch)


def test_pre_v020_layout_without_sketchsize64(monkeypatch):
    obj = _serde([_record(i) for i in range(3)], sketch_size=16)
    del obj["sketchsize64"], obj["kmer_stride"], obj["sample_stride"]
    ms = _check_native(cbor.dumps(obj), monkeypatch)
    assert (ms.sketch_size, ms.sketchsize64) == (1024, 16)
    assert ms.sample_stride == 2 * ms.kmer_stride == 2 * 16 * BBITS


@pytest.mark.parametrize("case", ["extra_key", "missing_key", "renamed",
                                  "duplicate_name"])
def test_inconsistent_name_map_warns_and_rebuilds(monkeypatch, caplog, case):
    records = [_record(i) for i in range(4)]
    name_map = {r["name"]: i for i, r in enumerate(records)}
    if case == "extra_key":
        name_map["gone"] = 9
    elif case == "missing_key":
        del name_map["s2"]
    elif case == "renamed":
        name_map = {"x" + k: v for k, v in name_map.items()}
    else:  # two records of one name: the map's keys are still the names
        records[3]["name"] = "s1"
        del name_map["s3"]
    payload = cbor.dumps(_serde(records, name_map))
    for native in (True, False):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            ms = (_check_native(payload, monkeypatch) if native
                  else _python_path(payload, monkeypatch))
        warned = any("inconsistent" in r.message for r in caplog.records)
        assert warned == (case != "duplicate_name")
    if case != "duplicate_name":
        assert ms.name_map == {f"s{i}": i for i in range(4)}


def test_name_map_in_another_order_with_repeated_keys(monkeypatch):
    """A map in hash order (sketchlib.rust's HashMap), and a key written
    twice, as a Python dict reads it: consistent, the later value wins."""
    records = [_record(i) for i in range(6)]
    body = cbor.dumps(_serde(records, {"s5": 5}))  # one entry, to splice
    entries = b"".join(cbor.dumps(k) + cbor.dumps(v) for k, v in
                       [("s3", 3), ("s0", 0), ("s5", 5), ("s1", 1), ("s2", 2),
                        ("s4", 4), ("s0", 7)])
    payload = body.replace(cbor.dumps({"s5": 5}), bytes([0xA7]) + entries)
    ms = _check_native(payload, monkeypatch)
    assert ms.name_map["s0"] == 7 and list(ms.name_map)[0] == "s3"


@pytest.mark.parametrize("fields", [
    ("name",), ("name", "index"), ("name", "rc", "acgt"),
    ("name", "seq_length", "densified", "reads", "non_acgt"),
])
def test_records_with_absent_fields(monkeypatch, fields):
    records = [_record(i) for i in range(5)]
    records[1] = {f: records[1][f] for f in fields}
    records[3] = {f: records[3][f] for f in reversed(fields)}
    ms = _check_native(cbor.dumps(_serde(records)), monkeypatch)
    s = ms.sketch_metadata[1]
    if "index" not in fields:
        assert s.index is None
    if "rc" not in fields:
        assert s.rc is True


def test_null_index_and_repeated_field(monkeypatch):
    """index null reads as absent; a field written twice, last wins."""
    records = [_record(i) for i in range(3)]
    records[0]["index"] = None
    payload = cbor.dumps(_serde(records))
    # records[2]'s seq_length twice: one more entry in its map
    rec2 = cbor.dumps(records[2])
    twice = bytes([rec2[0] + 1]) + rec2[1:] + cbor.dumps("seq_length") + \
        cbor.dumps(5)
    assert rec2 in payload
    ms = _check_native(payload.replace(rec2, twice), monkeypatch)
    assert ms.sketch_metadata[0].index is None
    assert ms.sketch_metadata[2].seq_length == 5


def test_names_outside_ascii(monkeypatch):
    records = [_record(i) for i in range(4)]
    records[0]["name"] = "Streptococcus pneumoniæ №1 中"
    records[1]["name"] = "with\x00nul"
    records[2]["name"] = ""
    records[3]["name"] = "\U0001f9ec"
    _check_native(cbor.dumps(_serde(records)), monkeypatch)


def test_non_minimal_integer_widths(monkeypatch):
    """Every head (integers, lengths) in its widest form, as another CBOR
    writer may put them."""
    def wide(major, value, out):
        out.append((major << 5) | 27)
        out += value.to_bytes(8, "big")

    obj = _serde([_record(i, seq_length=2**63 + i) for i in range(3)])
    with monkeypatch.context() as mp:
        mp.setattr(cbor, "_encode_head", wide)
        payload = cbor.dumps(obj)
    assert len(payload) > 2 * len(cbor.dumps(obj))
    ms = _check_native(payload, monkeypatch)
    assert ms.sketch_metadata[2].seq_length == 2**63 + 2


def _indefinite(items: list) -> bytes:
    return b"\x9f" + b"".join(cbor.dumps(x) for x in items) + b"\xff"


@pytest.mark.parametrize("case", [
    "indefinite_records", "indefinite_record", "indefinite_top",
    "indefinite_other", "indefinite_name", "tag_other", "tag_field",
    "negative_field", "float_field", "null_rc", "int_rc", "acgt_of_three",
    "unknown_key", "no_name", "byte_name", "map_value_text",
    "two_sketch_metadata", "no_name_map", "top_is_array", "simple_24",
])
def test_fallback_takes_the_python_path(monkeypatch, case):
    records = [_record(i) for i in range(3)]
    obj = _serde(records)
    enc = cbor.dumps
    if case == "indefinite_records":
        payload = enc(obj).replace(enc(records), _indefinite(records))
    elif case == "indefinite_record":
        r = records[1]
        one = b"\xbf" + b"".join(enc(k) + enc(v) for k, v in r.items()) + \
            b"\xff"
        payload = enc(obj).replace(enc(r), one)
    elif case == "indefinite_top":
        payload = b"\xbf" + enc(obj)[1:] + b"\xff"
    elif case == "indefinite_other":
        payload = enc(obj).replace(enc([17, 21]), _indefinite([17, 21]))
    elif case == "indefinite_name":
        payload = enc(obj).replace(enc("s1"), b"\x7f" + enc("s") + enc("1")
                                   + b"\xff")
    elif case == "tag_other":
        payload = enc(obj).replace(enc("0.3.0"), b"\xc0" + enc("0.3.0"))
    elif case == "tag_field":
        payload = enc(obj).replace(enc("seq_length") + enc(1001),
                                   enc("seq_length") + b"\xc2" + enc(1001))
    elif case == "negative_field":
        payload = enc(_serde([_record(0), _record(1, non_acgt=-1)]))
    elif case == "float_field":
        payload = enc(_serde([_record(0, seq_length=1.5)]))
    elif case == "null_rc":
        payload = enc(_serde([_record(0, rc=None)]))
    elif case == "int_rc":
        payload = enc(_serde([_record(0, rc=1)]))
    elif case == "acgt_of_three":
        payload = enc(_serde([_record(0, acgt=[1, 2, 3])]))
    elif case == "unknown_key":
        payload = enc(_serde([_record(0, colour="blue")]))
    elif case == "no_name":
        payload = enc(_serde([{"index": 0}], name_map={}))
    elif case == "byte_name":
        payload = enc(obj).replace(enc("s1"), b"\x42s1")
    elif case == "map_value_text":
        payload = enc(_serde(records, {"s0": 0, "s1": "1", "s2": 2}))
    elif case == "two_sketch_metadata":
        body = enc(obj)
        extra = enc("sketch_metadata") + enc(records[:1])
        payload = bytes([body[0] + 1]) + body[1:] + extra
    elif case == "no_name_map":
        del obj["name_map"]
        payload = enc(obj)
    elif case == "top_is_array":
        payload = enc([obj])
    else:  # a one-byte simple value, which cbor.py refuses
        payload = enc(obj).replace(enc("DNA"), b"\xf8\x20")
    _check_fallback(payload, monkeypatch)


@pytest.mark.parametrize("cut", [0, 1, 2, 40, 0.5, -9, -2, -1])
def test_truncated_payload(tmp_path, monkeypatch, cut):
    words = np.zeros((5, 1, 16, 14), np.uint64)
    bench_sketches.write(tmp_path / "db", words, [17], 7)
    payload = _payload(tmp_path / "db")
    end = int(len(payload) * cut) if isinstance(cut, float) else cut
    _check_fallback(payload[:end], monkeypatch)


def test_utf8_taken_as_python_takes_it(monkeypatch):
    """A name is decoded natively exactly where Python's strict UTF-8
    decoder takes it: every lead byte with second bytes at the edges of
    the ranges, and the continuations after them."""
    edges = (0x00, 0x41, 0x7F, 0x80, 0x8F, 0x90, 0x9F, 0xA0, 0xBF, 0xC0, 0xFF)
    names = [bytes([lead, b]) + tail for lead in range(0x80, 0x100)
             for b in edges for tail in (b"", b"\x80", b"\xbf\x80", b"A")]
    names += [b"\xef\xbf\xbf", b"\xf4\x8f\xbf\xbf", b"\xe0\xa0\x80"]
    head = cbor.dumps(_serde([_record(0)]))
    for raw in names:
        try:
            raw.decode("utf-8")
            valid = True
        except UnicodeDecodeError:
            valid = False
        name = bytes([0x78, len(raw)]) + raw
        payload = head.replace(cbor.dumps("s0"), name)
        assert (SkmColumns.decode(payload) is not None) == valid, raw


def test_invalid_utf8_raises_as_before(monkeypatch):
    for bad in (b"\xc3\x28", b"\xed\xa0\x80", b"\xf4\x90\x80\x80",
                b"\xe0\x80\xaf", b"ok\xff"):
        payload = cbor.dumps(_serde([_record(i) for i in range(2)]))
        payload = payload.replace(cbor.dumps("s1"),
                                  bytes([0x60 | len(bad)]) + bad)
        _check_fallback(payload, monkeypatch)


@pytest.fixture(scope="module")
def small_db(tmp_path_factory):
    """A 24-sample database at three k, a second one to merge, a subset
    list and a delete list."""
    d = tmp_path_factory.mktemp("skm_native_cli")
    kmers = (17, 21, 25)
    rng = np.random.default_rng(5)
    parents = rng.integers(0, 2**64, (3, len(kmers), 4, 14), dtype=np.uint64)
    for prefix, n, tag in (("db", 24, "s"), ("other", 6, "o")):
        words = derive_words(parents, n, kmers, 5 + n)
        with skd.SketchDataWriter(str(d / f"{prefix}.skd")) as wr:
            sketches = [Sketch(name=f"{tag}{i:02d}", seq_length=5000 + i,
                               acgt=(i, 2 * i, 3 * i, 4 * i), densified=i == 3,
                               index=wr.write_sketch(words[i].reshape(-1)))
                        for i in range(n)]
        MultiSketch(sketches, 256, list(kmers), HashType("dna")) \
            .save_metadata(str(d / prefix))
    (d / "subset.txt").write_text("s05\ns01\ns17\ns09\n")
    (d / "delete.txt").write_text("s02\ns11\n")
    return d


def _cli_outputs(d: Path, tag: str, capsys) -> dict:
    """stdout and every file each command writes, keyed by command."""
    db = str(d / "db")
    cmds = {
        "info": ["info", db],
        "sample_info": ["info", db, "--sample-info"],
        "knn": ["dist", db, "--knn", "3", "-o", str(d / f"knn_{tag}.txt")],
        "knn_k17": ["dist", db, "-k", "17", "--knn", "3", "-o",
                    str(d / f"k17_{tag}.txt")],
        "subset": ["dist", db, "-k", "17", "--subset", str(d / "subset.txt"),
                   "-o", str(d / f"sub_{tag}.txt")],
        "query": ["dist", db, str(d / "other"), "-k", "21", "--knn", "2",
                  "-o", str(d / f"q_{tag}.txt")],
        "merge": ["merge", db, str(d / "other"), "-o", str(d / f"m_{tag}")],
        "delete": ["delete", db, str(d / "delete.txt"), str(d / f"del_{tag}")],
    }
    outs = {}
    for name, argv in cmds.items():
        capsys.readouterr()
        assert port_cli.main([*argv, "--quiet"] if argv[0] == "dist"
                             else argv) in (0, None)
        outs[name] = capsys.readouterr().out
    for f in sorted(d.glob(f"*_{tag}.*")):
        outs[f.name.replace(f"_{tag}.", ".")] = f.read_bytes()
    return outs


def test_cli_output_identical_and_dist_builds_no_sketch(small_db, monkeypatch,
                                                       capsys):
    """info (with and without --sample-info), dist (self, --subset,
    query), merge and delete give the same bytes on either path; the dist
    commands build no Sketch object on the native one."""
    monkeypatch.setenv("SKETCHTPU_TORCH_BACKEND", "cpu")
    built = []
    init = Sketch.__init__

    def counted(self, *args, **kwargs):
        built.append(1)
        init(self, *args, **kwargs)

    with monkeypatch.context() as mp:
        mp.setattr(Sketch, "__init__", counted)
        db, other = str(small_db / "db"), str(small_db / "other")
        for argv in ([db, "--knn", "3"], [db, "-k", "17", "--knn", "3"],
                     [db, "-k", "17", "--subset",
                      str(small_db / "subset.txt")],
                     [db, other, "-k", "21", "--knn", "2"]):
            assert port_cli.main(["dist", *argv, "-o",
                                  str(small_db / "x.txt"), "--quiet"]) == 0
            assert not built, argv
    native = _cli_outputs(small_db, "native", capsys)
    with monkeypatch.context() as mp:
        _declined(mp)
        python = _cli_outputs(small_db, "python", capsys)
    assert native.keys() == python.keys() and len(native) >= 12
    for name in native:
        assert native[name] == python[name], name
    assert native["sample_info"].count("\n") == 24 + 2
    assert b"s05" in native["sub.txt"]
