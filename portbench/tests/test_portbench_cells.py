"""Whole runs of the harness on the CPU at tiny sizes (the port on its plain
PyTorch twins, SKETCHTPU_TORCH_BACKEND=cpu), with the look for a GPU
skipped: each cell's kind, a cell added as new files and one entry, and
the timed path broken underneath (correct must come out false)."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from portbench import run

REPO = Path(run.__file__).resolve().parent.parent
TINY = {"ca7-n50k": {"samples": 300, "kmers": [17, 19, 21, 23, 25]},
        "k17-n100k": {"samples": 400},
        "idx661k-s100": {"samples": 2000, "clusters": 15}}


@pytest.fixture
def root(tmp_path, monkeypatch):
    """A checkout's BENCHMARK.json and data files with each configuration
    cut to a tiny size (the code is the harness's own)."""
    monkeypatch.setenv("SKETCHTPU_TORCH_BACKEND", "cpu")
    monkeypatch.setenv("TMPDIR", str(tmp_path / "tmp"))
    (tmp_path / "tmp").mkdir()
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for entry in bench["configs"]:
        cfg = json.loads((REPO / entry["file"]).read_text())
        cfg.update(TINY[entry["name"]])
        dst = tmp_path / entry["file"]
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_text(json.dumps(cfg))
    shutil.copytree(REPO / "portbench" / "traffic",
                    tmp_path / "portbench" / "traffic")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


def run_cell(root: Path, cell: str, capsys, trace: int = 0,
             seed: int = 2**31 + 77) -> dict:
    import tempfile

    tempfile.tempdir = None  # take $TMPDIR as the fixture set it
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "0.2", "--trace", str(trace)], root=root,
                  require_cuda=False)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ["ca7-n50k.knn50", "k17-n100k.knn50",
                                  "idx661k-s100.count"])
def test_each_cell_runs_and_is_correct(root, cell, capsys):
    res = run_cell(root, cell, capsys)
    assert res["correct"] is True and res["attempted"] >= 1
    assert set(res["metrics"]) == {"pairs_per_s", "setup_s"}
    assert list(res)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())


def test_traced_run_reports_the_cells_per_layer_metrics(root, capsys):
    res = run_cell(root, "ca7-n50k.knn50", capsys, trace=1)
    assert res["correct"] is True
    assert {"window_s", "busy_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_cell_added_as_files_and_one_entry_is_found_and_run(root, capsys):
    cfg = json.loads((root / "portbench/configs/k17-n100k.json").read_text())
    cfg.update(name="k21-n350", kmers=[21], samples=350)
    (root / "portbench/configs/k21-n350.json").write_text(json.dumps(cfg))
    (root / "portbench/traffic/knn7.json").write_text(
        json.dumps({"job": "dist_knn", "knn": 7, "why": "seven"}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "k21-n350", "source": "test",
                             "file": "portbench/configs/k21-n350.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "k21-n350.knn7", "config": "k21-n350",
                               "traffic": "knn7", "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = run_cell(root, "k21-n350.knn7", capsys)
    assert res["correct"] is True
    assert res["metrics"]["pairs_per_s"]["value"] > 0


def _alter_first_value(monkeypatch):
    from sketchtpu_torch.dist import knn_torch

    exact = knn_torch.exact_ca_values

    def altered(*a, **kw):
        core, acc, idx = exact(*a, **kw)
        acc = acc.copy()
        acc[:, 0] += np.float32(1e-3)
        return core, acc, idx

    monkeypatch.setattr(knn_torch, "exact_ca_values", altered)


def _alter_single_value(monkeypatch):
    from sketchtpu_torch.dist import knn_torch

    rows = knn_torch.rows_from_samebits

    def altered(*a, **kw):
        res = rows(*a, **kw)
        res.vals[:, 0] += np.float32(1e-3)
        return res

    monkeypatch.setattr(knn_torch, "rows_from_samebits", altered)


def _drop_half_the_rows(monkeypatch):
    from sketchtpu_torch.dist import output

    write = output.write_sparse

    def half(out, row_names, ref_names, rows, coreacc):
        idx, vals, valid = rows.as_arrays()
        valid = np.ones(idx.shape, bool) if valid is None else valid.copy()
        valid[len(valid) // 2 :] = False
        rows.valid = valid
        return write(out, row_names, ref_names, rows, coreacc)

    monkeypatch.setattr(output, "write_sparse", half)


def _count_one_more(monkeypatch):
    from sketchtpu_torch.inverted.index import Inverted

    count = Inverted.any_shared_bin_count
    monkeypatch.setattr(Inverted, "any_shared_bin_count",
                        lambda self, **kw: count(self, **kw) + 1)


def _count_half_the_rows(monkeypatch):
    from sketchtpu_torch.inverted.index import Inverted

    count = Inverted.any_shared_bin_count

    def half(self, engine=None, row_range=None, **kw):
        return count(self, engine=engine,
                     row_range=slice(0, self.n_samples // 2), **kw)

    monkeypatch.setattr(Inverted, "any_shared_bin_count", half)


@pytest.mark.parametrize("cell,fault", [
    ("ca7-n50k.knn50", _alter_first_value),
    ("ca7-n50k.knn50", _drop_half_the_rows),
    ("k17-n100k.knn50", _alter_single_value),
    ("k17-n100k.knn50", _drop_half_the_rows),
    ("idx661k-s100.count", _count_one_more),
    ("idx661k-s100.count", _count_half_the_rows),
], ids=lambda v: v if isinstance(v, str) else v.__name__.strip("_"))
def test_a_broken_timed_path_is_not_correct(root, cell, fault, capsys,
                                            monkeypatch):
    fault(monkeypatch)
    res = run_cell(root, cell, capsys)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_no_gpu_no_result(root, capsys, monkeypatch):
    """Without the GPU a cell asks for, a run fails and prints no result:
    it never falls back to the CPU."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")  # restored after
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    rc = run.main(["--workload", "ca7-n50k.knn50", "--seed", "1",
                   "--seconds", "1"], root=root)
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_benchmark_files_alone_do_not_run(tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/, a run
    exits non-zero and prints nothing on stdout."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "ca7-n50k.knn50",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0 and proc.stdout == ""


@pytest.mark.gpu
def test_a_cell_on_the_card(tmp_path, monkeypatch):
    """One short run of the smallest cell's kind on the card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "k17-n100k.knn50",
         "--seed", str(2**31 + 5), "--seconds", "3", "--trace", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"


def test_count_control_comes_out_wrong(tmp_path, monkeypatch):
    """The count at 8 bits a sign (the port over an index of the low
    bytes) departs from the reference's 16-bit count."""
    from portbench.databases import index
    from portbench.jobs import precluster_count

    monkeypatch.setenv("SKETCHTPU_TORCH_BACKEND", "cpu")
    cfg = json.loads((REPO / "portbench/configs/idx661k-s100.json").read_text())
    cfg.update(TINY["idx661k-s100"])
    db = index.make(cfg, 31, tmp_path)
    got = precluster_count.control(db, {}, 31, "cpu", tmp_path)
    assert got["count_gap"] > precluster_count.LIMITS["count_gap"]


def test_a_job_that_writes_nothing_fails_the_run(root, capsys, monkeypatch):
    """The output file is removed before each job and required after, so a
    job that exits 0 without writing it (here: it writes elsewhere) is
    never judged on an earlier job's output."""
    from sketchtpu_torch import cli

    main = cli.main

    def elsewhere(argv):
        argv = list(argv)
        argv[argv.index("-o") + 1] += ".elsewhere"
        return main(argv)

    monkeypatch.setattr(cli, "main", elsewhere)
    with pytest.raises(RuntimeError, match="wrote no"):
        run.main(["--workload", "k17-n100k.knn50", "--seed", "5",
                  "--seconds", "0.2", "--trace", "0"], root=root,
                 require_cuda=False)
    assert capsys.readouterr().out == ""


def test_each_job_reads_the_database_under_a_new_name(root, capsys,
                                                      monkeypatch):
    """A cache that the program keys on the database's path cannot serve
    one job from the last, and the warm-up reads a cut of its own."""
    from sketchtpu_torch import cli

    seen = []
    main = cli.main

    def spy(argv):
        seen.append((argv[1], Path(argv[1]).with_suffix(".skd").stat().st_size
                     if argv[0] == "dist" else None))
        return main(argv)

    monkeypatch.setattr(cli, "main", spy)
    monkeypatch.setattr(run, "WARMUP_SAMPLES", 100)
    res = run_cell(root, "ca7-n50k.knn50", capsys)
    assert res["correct"] is True and len(seen) == res["attempted"] + 1
    paths = [p for p, _ in seen]
    assert len(set(paths)) == len(paths)
    (warm, warm_size), *timed = seen
    assert all(size > 2 * warm_size for _, size in timed)
    assert not any(Path(p).exists() for p in paths)
