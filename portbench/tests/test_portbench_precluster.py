"""The precluster cell, mix64-n50k.precluster50: the `collection` generator
and its files, the port's `inverted precluster --core-acc` against the
plain reference (reference/precluster.py) on the CPU (the port on its
plain PyTorch twins), the control and the planted fault, the two readers
of the cell's per-layer metrics, and the cell run whole."""

from __future__ import annotations

import json

import numpy as np
import pytest
from test_portbench_cells import REPO, root, run_cell  # noqa: F401 (a fixture)

from portbench import roofline, run
from portbench.databases import collection
from portbench.jobs import precluster_knn as job
from portbench.reference import precluster as ref
from portbench.reference.count import shared_pair_count
from portbench.reference.samebits import samebits_rows
from portbench.trace import Trace

CELL = "mix64-n50k.precluster50"
CONFIG = json.loads((REPO / "portbench/configs/mix64-n50k.json").read_text())
TRAFFIC = json.loads((REPO / "portbench/traffic/precluster50.json").read_text())
# 1,200 samples of 8 species, the smallest two under knn + 1 = 51 samples
SMALL = {**CONFIG, "samples": 1200, "species": 8, "species_zipf": 1.2}
SEED = 2**31 + 4321  # past 32 signed bits: seeds may be that large
MS = 1_000_000  # ns


def test_generator_is_deterministic_by_seed():
    cfg = {**SMALL, "samples": 300}
    a, b = collection.generate(cfg, SEED), collection.generate(cfg, SEED)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    c = collection.generate(cfg, SEED + 1)
    assert not np.array_equal(a[0], c[0]) and not np.array_equal(a[1], c[1])


@pytest.mark.parametrize("n,species,exponent", [
    (50_000, 64, 1.0), (1200, 8, 1.2), (700, 8, 1.0), (101, 7, 0.5)])
def test_species_sizes_sum_to_the_samples(n, species, exponent):
    sizes = collection.species_sizes(n, species, exponent)
    assert sizes.sum() == n and len(sizes) == species
    assert np.all(np.diff(sizes) <= 0)


def test_every_species_of_the_cell_has_knn_plus_one_samples():
    sizes = collection.species_sizes(CONFIG["samples"], CONFIG["species"],
                                     CONFIG["species_zipf"])
    assert sizes.min() >= TRAFFIC["knn"] + 1
    assert (sizes.max(), sizes.min()) == (10_540, 165)
    assert min(collection.species_sizes(1200, 8, 1.2)) < TRAFFIC["knn"] + 1


def test_the_warm_up_subset_holds_every_species():
    species, lineage, d_parent, d = collection.tree(CONFIG, SEED)
    assert len(species) == CONFIG["samples"] == len(d)
    assert len(np.unique(species[: run.WARMUP_SAMPLES])) == CONFIG["species"]
    assert d_parent.size == CONFIG["species"] * CONFIG["parents"]
    assert np.array_equal(lineage // CONFIG["parents"], species)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return collection.make(SMALL, SEED, tmp_path_factory.mktemp("collection"))


def test_files_load_in_the_port(small):
    from sketchtpu_torch.dist.knn_torch import precluster_signs
    from sketchtpu_torch.formats.skd import read_all_skq
    from sketchtpu_torch.formats.skm import MultiSketch
    from sketchtpu_torch.inverted.index import Inverted

    ms = MultiSketch.load_metadata(str(small.prefix))
    ms.read_sketch_data(str(small.prefix))
    assert [ms.sketch_name(i) for i in range(small.n)] == small.names
    assert np.array_equal(ms.sketch_bins.reshape(small.words.shape),
                          small.words)
    inv = Inverted.load(str(small.prefix))
    assert not np.array_equal(small.ski_order, np.arange(small.n))
    assert inv.sample_names == [small.names[i] for i in small.ski_order]
    assert np.array_equal(inv.sign_matrix, small.signs[small.ski_order])
    skq = read_all_skq(f"{small.prefix}.skq")
    assert np.array_equal(skq, small.signs[small.ski_order].ravel())
    assert np.array_equal(precluster_signs(ms, inv, skq), small.signs)


def test_species_share_signs_and_species_apart_rarely(small):
    degrees = ref.candidate_counts(small.signs, "cpu")
    assert shared_pair_count(small.signs, "cpu") == degrees.sum() // 2
    rows = np.arange(small.n)
    mask = ref.candidate_mask(small.signs, rows, "cpu")
    assert np.array_equal(mask.sum(1), degrees)
    same = small.species[:, None] == small.species[None, :]
    np.fill_diagonal(same, False)
    # nearly every pair of a species shares a sign; of two species, about
    # S / 65536 of the pairs
    assert mask[same].mean() > 0.9
    assert mask[~same & ~np.eye(small.n, dtype=bool)].mean() < 0.01


@pytest.fixture(scope="module")
def ported(small, tmp_path_factory):
    """The port's precluster --core-acc on the small collection, on the
    CPU: its output file."""
    from sketchtpu_torch import cli

    out = tmp_path_factory.mktemp("ported") / "out.txt"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SKETCHTPU_TORCH_BACKEND", "cpu")
        assert cli.main(job.argv(small, TRAFFIC, out)) == 0
    return out


def test_the_port_matches_the_reference_on_every_row(small, ported):
    rows = np.arange(small.n)
    sb = samebits_rows(small.words, rows, "cpu").numpy()
    candidates = ref.candidate_mask(small.signs, rows, "cpu")
    degrees = candidates.sum(1)
    knn = TRAFFIC["knn"]
    short = np.flatnonzero(degrees < knn)
    assert short.size > 0 and degrees.min() > 0  # short rows, none empty
    out = ref.read_output(ported, small.names, rows)
    assert np.array_equal(out.counts, np.minimum(degrees, knn))
    got = ref.judge(out, sb, rows, candidates, degrees, small.signs,
                    small.names, small.kmers, small.sketch_size, small.s64,
                    knn, "cpu")
    assert got["wrong_lines"] == 0 and got["non_candidate_lines"] == 0
    assert got["selection_excess"] <= job.LIMITS["selection_excess"]


def test_the_check_passes_the_ports_file(small, ported):
    record = run.JobRecord(ported)
    got = job.check(small, TRAFFIC, record, SEED, "cpu")
    assert all(got[k] <= job.LIMITS[k] for k in job.LIMITS)


@pytest.mark.parametrize("stand_in", ["control", "fault"])
def test_control_and_fault_fail_a_limit(small, stand_in):
    got = getattr(job, stand_in)(small, TRAFFIC, SEED, "cpu")
    assert set(got) == set(job.LIMITS)
    assert any(got[k] > job.LIMITS[k] for k in job.LIMITS)


def test_the_mask_ignored_fails_a_limit_where_rows_are_short(small):
    """Where a row has fewer than knn candidates, a scan that ignores the
    mask prints too many lines and lines of pairs that share no sign."""
    got = job.mask_fault(small, TRAFFIC, SEED, "cpu")
    assert set(got) == set(job.LIMITS)
    assert got["wrong_lines"] > 0 and got["non_candidate_lines"] > 0


def test_a_pair_shares_no_sign_with_a_non_candidate_or_itself(small):
    candidates = ref.candidate_mask(small.signs, [0], "cpu")[0]
    far = int(np.flatnonzero(~candidates)[1])  # [0] is the row itself
    shared = ref.shares_a_sign(small.signs, np.array([0, 1, 0]),
                               np.array([far, 1, int(np.argmax(candidates))]),
                               "cpu")
    assert shared.tolist() == [False, False, True]


def recorded():
    """Two jobs of 100 ms, the device busy 10-40 and 120-150 ms; each job
    a cli.inverted root over load (holding load.skq), engine, signs, scan
    (12-45 ms into a job) and values."""
    from sketchtpu_torch.spans import Span

    trace = Trace(jobs=[(0, 100 * MS), (100 * MS, 200 * MS)],
                  kernels=[("k", 10 * MS, 40 * MS), ("k", 120 * MS, 150 * MS)],
                  copies=[],
                  cell={"n": 50_000, "nk": 7, "s64": 16, "knn": 50,
                        "signs": 100, "candidate_pairs": 90_000_000})
    spans, ids = [], iter(range(1, 1000))

    def add(name, a, b, parent=None):
        s = Span(name, a * MS, b * MS, parent=parent, thread=1, run=1,
                 id=next(ids))
        spans.append(s)
        return s

    for j in (0, 100):
        root_ = add("cli.inverted", j + 1, j + 99)
        load = add("load", j + 1, j + 7, root_.id)
        add("load.skq", j + 2, j + 4, load.id)
        add("engine", j + 7, j + 9, root_.id)
        add("signs", j + 9, j + 12, root_.id)
        add("scan", j + 12, j + 45, root_.id)
        add("values", j + 45, j + 70, root_.id)
    return trace, spans


def read(name, trace, spans):
    return run.module_by_name("metrics", name).read(trace, spans)


def test_the_scan_roofline_counts_the_candidates_alone():
    trace, spans = recorded()
    # 90 M candidate pairs x 7 k x 16 chunks x 28 LOP3 at 64 a clock and
    # SM, 132 SMs at 1.98 GHz: 16.873 ms a job; the words (627.2 MB), the
    # packed signs (10 MB) and the output (20 MB) at 3.35 TB/s: 0.196 ms
    least = 90_000_000 * 7 * 16 * 28 / (64 * 132 * 1.98e9)
    assert least == pytest.approx(0.016873, rel=1e-4)
    # busy inside the scans: 12-40 and 120-145 ms
    assert read("precluster_scan_roofline", trace, spans) == pytest.approx(
        100 * least * 2 / 0.053)
    # the same least work a pair as the full scan's
    full = dict(trace.cell, candidate_pairs=roofline.self_pairs(50_000))
    mod = run.module_by_name("metrics", "precluster_scan_roofline")
    assert mod.least_s(full) == pytest.approx(
        roofline.samebits_least_s(50_000, 7, 16, 50))


def test_the_scan_roofline_without_its_inputs_is_none():
    trace, spans = recorded()
    assert read("precluster_scan_roofline", trace, []) is None
    trace.cell.pop("candidate_pairs")
    assert read("precluster_scan_roofline", trace, spans) is None


def test_signs_ms_per_job_reads_the_sign_path():
    trace, spans = recorded()
    # load.skq 2 ms and signs 3 ms a job
    assert read("signs_ms_per_job", trace, spans) == pytest.approx(5.0)
    # a program without the two spans (the parent's): nothing to read
    old = [s for s in spans if s.name not in ("load.skq", "signs")]
    assert read("signs_ms_per_job", trace, old) is None


def test_run_finds_every_module_of_the_cell_by_name():
    bench, cell, config, traffic = run.load_cell(REPO, CELL)
    assert cell["chips"] == 1 and config["database"] == "collection"
    assert run.module_by_name("databases", config["database"]) is not None
    assert run.module_by_name("jobs", traffic["job"]) is job
    names = [m["name"] for m in bench["per_layer"]
             if CELL in m.get("workloads", [CELL])]
    assert names == ["precluster_scan_roofline", "signs_ms_per_job"]
    for name in names:
        assert callable(run.module_by_name("metrics", name).read)


def test_the_cell_runs_whole_and_is_correct(root, capsys):  # noqa: F811
    res = run_cell(root, CELL, capsys)
    assert res["correct"] is True and res["attempted"] >= 1
    assert set(res["checks"]) == set(job.LIMITS)
    res = run_cell(root, CELL, capsys, trace=1)
    assert res["correct"] is True
    # on the CPU no device time falls in the scans: the roofline reads
    # nothing (on the card, portbench/run.py reports both)
    assert set(res["metrics"]) == {"signs_ms_per_job"}
    assert res["metrics"]["signs_ms_per_job"]["value"] > 0


def _skip_the_reorder(monkeypatch):
    from sketchtpu_torch.dist import knn_torch

    monkeypatch.setattr(knn_torch, "precluster_signs",
                        lambda ms, inv, skq: skq.reshape(-1, inv.sketch_size))


def _alter_first_value(monkeypatch):
    from sketchtpu_torch.dist import knn_torch

    exact = knn_torch.exact_ca_values

    def altered(*a, **kw):
        core, acc, idx = exact(*a, **kw)
        acc = acc.copy()
        acc[:, 0] += np.float32(1e-3)
        return core, acc, idx

    monkeypatch.setattr(knn_torch, "exact_ca_values", altered)


@pytest.mark.parametrize("fault", [_skip_the_reorder, _alter_first_value],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_broken_timed_path_is_not_correct(root, fault, capsys,  # noqa: F811
                                            monkeypatch):
    fault(monkeypatch)
    res = run_cell(root, CELL, capsys)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())
