"""The readers of the program's spans (portbench/spans.py and the five
metrics that read through it) on a small recorded trace and span list, a
program without the recorder, and traced tiny runs of the cells."""

from __future__ import annotations

import sys

import pytest
from test_portbench_cells import root, run_cell  # noqa: F401 (a fixture)

from portbench import spans as ps
from portbench.run import module_by_name
from portbench.trace import Trace
from sketchtpu_torch.spans import Span

MS = 1_000_000  # ns
STAGES = [("load", 1, 10), ("engine", 10, 12), ("scan", 12, 45),
          ("values", 45, 70), ("write", 70, 95)]


def recorded():
    """Two jobs of 100 ms, the device busy 10-40 ms in the first and
    120-150 in the second; each job a cli.dist root (1-99 ms of it) over
    the five stages, a load.skd inside the load; and spans before the
    window (a warm-up's) and across its end."""
    trace = Trace(jobs=[(0, 100 * MS), (100 * MS, 200 * MS)],
                  kernels=[("k", 10 * MS, 40 * MS), ("k", 120 * MS, 150 * MS)],
                  copies=[])
    spans, ids = [], iter(range(1, 1000))

    def add(name, a, b, parent=None, **counts):
        s = Span(name, a * MS, b * MS, parent=parent, thread=1, run=1,
                 id=next(ids), counts=counts)
        spans.append(s)
        return s

    add("scan", -50, -10)  # before the window
    for j in (0, 100):
        root = add("cli.dist", j + 1, j + 99)
        for name, a, b in STAGES:
            s = add(name, j + a, j + b, root.id,
                    **({"bytes": 1000} if name == "load" else {}))
            if name == "load":
                add("load.skd", j + 2, j + 8, s.id, bytes=600)
    add("write", 190, 260)  # across the window's end
    return trace, spans


def read(name, trace, spans):
    return module_by_name("metrics", name).read(trace, spans)


def test_stage_readers():
    trace, spans = recorded()
    assert read("load_ms_per_job", trace, spans) == pytest.approx(9.0)
    assert read("engine_ms_per_job", trace, spans) == pytest.approx(2.0)
    assert read("values_ms_per_job", trace, spans) == pytest.approx(25.0)
    # 70-95 and 170-200 (the second write and the one across the end,
    # clipped to the window) in two jobs
    assert read("write_ms_per_job", trace, spans) == pytest.approx(27.5)
    # idle inside the scans: 40-45 ms in the first, 112-120 in the second
    assert read("scan_idle_ms_per_job", trace, spans) == pytest.approx(6.5)


def test_nothing_to_read_is_none(monkeypatch):
    trace, _ = recorded()
    for name in ("load_ms_per_job", "engine_ms_per_job",
                 "scan_idle_ms_per_job", "values_ms_per_job",
                 "write_ms_per_job"):
        assert read(name, trace, []) is None
    # a program without the recorder: nothing, and no error
    import sketchtpu_torch

    monkeypatch.delattr(sketchtpu_torch, "spans")
    monkeypatch.setitem(sys.modules, "sketchtpu_torch.spans", None)
    assert ps.program_spans() == []
    assert module_by_name("metrics", "load_ms_per_job").read(trace) is None


def test_table_splits_the_idle_time_by_stage():
    trace, spans = recorded()
    t = ps.table(trace, spans)
    rows = {p: (wall, idle, counts) for p, wall, idle, counts in t["rows"]}
    assert list(rows) == [("load",), ("load", "load.skd"), ("engine",),
                          ("scan",), ("values",), ("write",)]
    assert rows[("load",)][:2] == pytest.approx((0.009, 0.009))
    assert rows[("load",)][2] == {"bytes": 2000}
    # the stages' idle a job: 9 + 0 + 5 + 25 + 25 ms, then 9 + 2 + 8 + 20
    # + 25
    assert t["stages"] == pytest.approx(0.064)
    assert rows[("load", "load.skd")][2] == {"bytes": 1200}
    # idle: 0-10, 40-120, 150-200 ms: 140 ms in two jobs
    assert t["idle"] == pytest.approx(0.070)
    # in the roots but no stage: 95-99 and 195-199 ms; outside the roots:
    # 0-1, 99-101 and 199-200
    assert t["roots_not_stages"] == pytest.approx(0.004)
    assert t["outside_roots"] == pytest.approx(0.002)
    assert t["stages"] + t["roots_not_stages"] + t["outside_roots"] \
        == pytest.approx(t["idle"])
    text = ps.show(t)
    assert "load.skd" in text and "MB/s" in text


def test_traced_tiny_runs_report_the_stages(root, capsys):  # noqa: F811
    res = run_cell(root, "ca7-n50k.knn50", capsys, trace=1)
    assert res["correct"] is True
    assert {"load_ms_per_job", "engine_ms_per_job", "scan_idle_ms_per_job",
            "values_ms_per_job", "write_ms_per_job"} <= set(res["metrics"])
    res = run_cell(root, "idx661k-s100.count", capsys, trace=1)
    assert res["correct"] is True
    got = set(res["metrics"])
    assert {"load_ms_per_job", "engine_ms_per_job",
            "scan_idle_ms_per_job"} <= got
    assert not {"values_ms_per_job", "write_ms_per_job"} & got
    assert all(m["value"] > 0 for m in res["metrics"].values()
               if m["unit"] == "ms/job")
