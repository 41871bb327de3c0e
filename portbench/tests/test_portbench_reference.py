"""The plain reference against brute force and against the port's own host
chain, and the controls: the reference one step down comes out wrong."""

from __future__ import annotations

import numpy as np
import pytest

from portbench.databases import index, sketches
from portbench.jobs import dist_knn
from portbench.reference import chain, knn
from portbench.reference.count import shared_pair_count
from portbench.reference.samebits import samebits_rows

SK = {"samples": 300, "sketch_size": 1000, "kmers": [17, 19, 21, 23, 25],
      "parents": 3, "divergence": [0.001, 0.05],
      "parent_divergence": [0.005, 0.05]}


def test_samebits_rows_match_brute_force():
    words = sketches.generate(SK, 21)
    rows = np.array([0, 7, 150, 299])
    got = samebits_rows(words, rows, "cpu", block=3).numpy()
    x = ~(words[rows][:, None] ^ words[None])  # (r, n, nk, s64, BBITS)
    want = np.bitwise_count(np.bitwise_and.reduce(x, axis=-1)).sum(-1)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("s", [100, 99, 1])
def test_shared_pair_count_matches_brute_force(s):
    signs = index.generate({"samples": 1500, "sketch_size": s,
                            "clusters": 11, "redraw": 0.3}, 4 + s)
    eq = np.zeros((len(signs),) * 2, dtype=bool)
    for b in range(s):
        eq |= signs[:, b][:, None] == signs[:, b][None, :]
    assert shared_pair_count(signs, "cpu") == int(np.triu(eq, 1).sum())


def test_chain_matches_the_ports_host_chain():
    from sketchtpu_torch.dist.jaccard_np import (core_acc_from_jaccards,
                                                 jaccard_from_samebits)

    rng = np.random.default_rng(3)
    sb = rng.integers(0, 1025, (5000, 7))
    sb[:50] = 0  # the no-fit branch
    kmers = [17, 19, 21, 23, 25, 27, 29]
    j = chain.jaccard(sb, 16)
    assert np.array_equal(j, jaccard_from_samebits(sb, 16))
    core, acc = chain.core_acc(j, kmers, 1024)
    pc, pa = core_acc_from_jaccards(j, kmers, 1024)
    assert np.array_equal(core.astype(np.float32), pc)
    assert np.array_equal(acc.astype(np.float32), pa)


def test_fmt_prints_as_the_reference_tool():
    assert [chain.fmt(v) for v in (1.0, 0.5, 1e-5, 0.1)] == \
        ["1", "0.5", "0.00001", "0.1"]


@pytest.mark.parametrize("kmers,number", [([17], "wrong_lines"),
                                          (SK["kmers"], "wrong_lines")])
def test_control_comes_out_wrong(kmers, number):
    """The reference in the port's place one step down (core/accessory in
    f32; Jaccard with equal samebits in descending column order) fails a
    compared number, where the reference itself passes."""
    cfg = dict(SK, kmers=kmers, samples=600)
    db = sketches.SketchDatabase(prefix=None, names=sketches.sample_names(600),
                                 words=sketches.generate(cfg, 8),
                                 kmers=kmers, sketch_size=1024, files=[])
    traffic = {"knn": 50}
    got = dist_knn.control(db, traffic, 9, "cpu")
    assert got[number] > dist_knn.LIMITS[number]
    rows = dist_knn.check_rows(db, 9)
    sb = samebits_rows(db.words, rows, "cpu").numpy()
    want = dist_knn._expected(db, traffic, rows, sb)
    assert all(v <= dist_knn.LIMITS[k] for k, v in dist_knn.judge(
        db, traffic, rows, sb, 600 * 50, want).items())


def test_judge_counts_a_missing_line_and_a_swapped_neighbour():
    db = sketches.SketchDatabase(prefix=None, names=sketches.sample_names(300),
                                 words=sketches.generate(SK, 2),
                                 kmers=SK["kmers"], sketch_size=1024,
                                 files=[])
    traffic = {"knn": 10}
    rows = np.array([3, 40])
    sb = samebits_rows(db.words, rows, "cpu").numpy()
    want = dist_knn._expected(db, traffic, rows, sb)
    ok = dist_knn.judge(db, traffic, rows, sb, 3000, want)
    assert ok == {"wrong_lines": 0, "selection_excess": 0.0}
    short = dist_knn.judge(db, traffic, rows, sb, 2999, want)
    assert short["wrong_lines"] == 1
    # row 3's worst neighbour replaced by its farthest sample
    core, _ = knn.coreacc_values(sb[0], db.kmers, 1024, 16)
    core[3] = -1
    far = int(np.argmax(core))
    cols, _ = knn.coreacc_select(sb[0], 3, 10, db.kmers, 1024, 16)
    bad = dict(want)
    bad[3] = knn.coreacc_lines(sb[0], 3, [*cols[:-1], far], db.names,
                               db.kmers, 1024, 16)
    swapped = dist_knn.judge(db, traffic, rows, sb, 3000, bad)
    assert swapped["selection_excess"] > dist_knn.LIMITS["selection_excess"]
