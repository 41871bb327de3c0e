"""The spans and counters of the port's preclustered kNN (`inverted
precluster <ski> --skd <db> --knn`): load.skq inside load, the sign path
("signs": the .ski -> .skd reorder and the packed signs' upload) between
engine and scan, the rows with no candidate counted as "unmatched" in
"rows", and nothing recorded with tracing off."""

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from sketchtpu_torch import cli as port_cli
from sketchtpu_torch import spans
from sketchtpu_torch.formats import skd
from sketchtpu_torch.formats.skm import MultiSketch
from sketchtpu_torch.sketchcore.sketch import HashType, Sketch
from sketchtpu_torch.synth import derive_signs, derive_words, write_derived_inverted

KMERS = (17, 21, 25)
N, S = 60, 31  # an odd S: the packed signs pad their last word
ALONE = 4  # rows 0-3 hold signs no other sample holds in their bin


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    """A 60-sample database at three k and its inverted index (.ski +
    .skq), listed in an order of its own, where the first ALONE samples
    share no sign with any other."""
    d = tmp_path_factory.mktemp("torch_precluster_spans")
    rng = np.random.default_rng(21)
    parents = rng.integers(0, 2**64, (3, len(KMERS), 4, 14), dtype=np.uint64)
    words = derive_words(parents, N, KMERS, 21)
    names = [f"s{i:03d}" for i in range(N)]
    with skd.SketchDataWriter(str(d / "db.skd")) as wr:
        sketches = [Sketch(name=nm, index=wr.write_sketch(words[i].reshape(-1)))
                    for i, nm in enumerate(names)]
    MultiSketch(sketches, 256, list(KMERS), HashType("dna")).save_metadata(
        str(d / "db"))
    signs = derive_signs(N, S, 4, 22)
    for r in range(ALONE):
        for b in range(S):
            taken = set(np.delete(signs[:, b], r).tolist())
            signs[r, b] = next(v for v in range(r * 1000, 65536)
                               if v not in taken)
    order = rng.permutation(N)
    write_derived_inverted(str(d / "inv"), [names[i] for i in order],
                           signs[order], 17)
    return d, signs


def _no_candidate(signs) -> int:
    same = (signs[:, None, :] == signs[None, :, :]).any(-1)
    np.fill_diagonal(same, False)
    return int((~same.any(1)).sum())


def _stages(argv) -> dict:
    """{path of names below the root: [spans]} of one CLI run under a
    profiler, the root under ()."""
    before = len(spans.recorded())
    with profile(activities=[ProfilerActivity.CPU]):
        assert port_cli.main(argv) == 0
    got = spans.recorded()[before:]
    by_id = {s.id: s for s in got}
    out = {}
    for s in got:
        path, up = [], s
        while up.parent is not None:
            path.append(up.name)
            up = by_id[up.parent]
        out.setdefault(tuple(reversed(path)), []).append(s)
    return out


def _argv(d, tmp_path, mode, retain):
    extra = ["--core-acc"] if mode == "core-acc" else []
    if retain:
        extra += ["--retain-unmatched", retain]
    return ["inverted", "precluster", str(d / "inv.ski"), "--skd",
            str(d / "db"), "--knn", "5", *extra, "-o",
            str(tmp_path / "out.txt"), "--quiet"]


@pytest.mark.parametrize("mode", ["core-acc", "single-k"])
def test_precluster_records_the_sign_path(db, tmp_path, monkeypatch, mode):
    monkeypatch.setenv("SKETCHTPU_TORCH_BACKEND", "cpu")
    d, signs = db
    got = _stages(_argv(d, tmp_path, mode, None))
    assert got[()][0].name == "cli.inverted"
    stages = [p[0] for p in got if len(p) == 1]
    assert set(stages) == {"load", "engine", "signs", "scan", "values",
                           "rows", "write"}
    (skq,) = got[("load", "load.skq")]
    assert skq.counts == {"bytes": (d / "inv.skq").stat().st_size}
    (sign_span,) = got[("signs",)]
    (upload,) = got[("signs", "upload")]
    assert upload.counts == {"bytes": N * -(-S // 2) * 4}
    engine = max(s.end_ns for s in got[("engine",)])
    scan = min(s.start_ns for s in got[("scan",)])
    assert engine <= sign_span.start_ns <= sign_span.end_ns <= scan
    # every count of the path lands in a stage, none on the root
    assert got[()][0].counts == {}


@pytest.mark.parametrize("mode", ["core-acc", "single-k"])
@pytest.mark.parametrize("retain", [None, "singleton"])
def test_unmatched_counts_the_rows_with_no_candidate(db, tmp_path,
                                                     monkeypatch, mode,
                                                     retain):
    monkeypatch.setenv("SKETCHTPU_TORCH_BACKEND", "cpu")
    d, signs = db
    want = _no_candidate(signs)
    assert want == ALONE
    got = _stages(_argv(d, tmp_path, mode, retain))
    (rows,) = got[("rows",)]
    assert rows.counts == {"unmatched": want}
    lines = (tmp_path / "out.txt").read_text().splitlines()
    own = [ln for ln in lines if ln.split("\t")[0] == ln.split("\t")[1]]
    assert len(own) == (want if retain == "singleton" else 0)


def test_tracing_off_records_no_span(db, tmp_path, monkeypatch):
    monkeypatch.setenv("SKETCHTPU_TORCH_BACKEND", "cpu")
    d, _ = db
    before = len(spans.recorded())
    assert port_cli.main(_argv(d, tmp_path, "core-acc", "singleton")) == 0
    assert len(spans.recorded()) == before
