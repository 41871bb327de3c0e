"""Each per-layer reader on a small recorded trace, the breakdown, and the
roofline counts against hand counts."""

from __future__ import annotations

import pytest

from portbench import roofline
from portbench.run import module_by_name
from portbench.trace import Trace, breakdown, short_name

MS = 1_000_000  # ns

K2 = "void (anonymous namespace)::coreacc_kernel<2, true>(unsigned long const*, long long)"
K3 = "void (anonymous namespace)::knn_select_kernel<long>(unsigned long const*)"
PC = "void (anonymous namespace)::pair_count_kernel(unsigned int const*, long long, int)"
TOPK = "void at::native::sbtopk::gatherTopK<long, unsigned int, 2, false>(at::cuda::detail::TensorInfo)"
CAT = "void at::native::(anonymous namespace)::CatArrayBatchedCopy<long, unsigned int, 2>(...)"


def recorded() -> Trace:
    """Two jobs of 100 ms; the device busy 0-5 ms (an upload) and 10-45 ms
    (K2, its merge, a download) in the first and 120-150 ms (K2) in the
    second; one kernel outside the window."""
    return Trace(
        jobs=[(0, 100 * MS), (100 * MS, 200 * MS)],
        kernels=[(K2, 10 * MS, 20 * MS), (TOPK, 20 * MS, 35 * MS),
                 (CAT, 35 * MS, 40 * MS), (K2, 120 * MS, 150 * MS),
                 (K2, 250 * MS, 260 * MS)],
        copies=[("Memcpy HtoD (Pageable -> Device)", 0, 5 * MS),
                ("Memcpy DtoH (Device -> Pageable)", 40 * MS, 45 * MS)],
        host=[("aten::to", 0, 6 * MS), ("aten::topk", 19 * MS, 36 * MS),
              ("aten::nonzero", 150 * MS, 190 * MS)],
        cell={"n": 50_000, "nk": 7, "s64": 16, "knn": 50, "signs": 100})


def read(name: str, trace: Trace):
    return module_by_name("metrics", name).read(trace)


def test_busy_and_idle():
    t = recorded()
    assert t.window_s == pytest.approx(0.2)
    assert t.busy_s() == pytest.approx(0.070)
    assert read("device_idle_pct", t) == pytest.approx(65.0)


def test_per_job_readers():
    t = recorded()
    assert read("h2d_ms_per_job", t) == pytest.approx(2.5)
    assert read("merge_ms_per_job", t) == pytest.approx(10.0)
    assert read("launches_per_job", t) == pytest.approx(2.0)


def test_rooflines_read_their_kernels_and_nothing_else():
    t = recorded()
    least = roofline.samebits_least_s(50_000, 7, 16, 50)
    assert read("k2_keys_roofline", t) == pytest.approx(
        100 * least * 2 / 0.040)
    # no K3 and no pair_count in this trace: nothing to read, never 0
    assert read("k3_select_roofline", t) is None
    assert read("pair_count_roofline", t) is None
    t.kernels.append((PC, 60 * MS, 80 * MS))
    t.kernels.append((K3, 160 * MS, 170 * MS))
    assert read("pair_count_roofline", t) == pytest.approx(
        100 * roofline.pair_count_least_s(50_000, 100) * 2 / 0.020)
    assert read("k3_select_roofline", t) == pytest.approx(
        100 * roofline.samebits_least_s(50_000, 1, 16, 50) * 2 / 0.010)


def test_roofline_counts_against_hand_counts():
    # 64 a clock and SM over 132 SMs at 1.98 GHz: 16.727 T a second
    rate64 = 64 * 132 * 1.98e9
    # 50,000 samples: 1,249,975,000 pairs x 7 k x 16 chunks x 28 LOP3 at
    # 16.727 T/s: 234.34 ms (the popcounts, 2 a chunk at 16 a clock, take
    # 66.95 ms; the words, 627.2 MB at 3.35 TB/s, 0.19 ms)
    assert roofline.samebits_least_s(50_000, 7, 16, 50) == pytest.approx(
        1_249_975_000 * 7 * 16 * 28 / rate64)
    assert roofline.samebits_least_s(50_000, 7, 16, 50) == pytest.approx(
        0.23434, rel=1e-4)
    # 100,000 at one k: 4,999,950,000 x 16 x 28 / 16.727e12 = 133.91 ms
    assert roofline.samebits_least_s(100_000, 1, 16, 50) == pytest.approx(
        0.133913, rel=1e-4)
    # 661,000 at S = 100: 218,460,169,500 pairs x 50 words, one DPX
    # compare each: 653.0 ms
    assert roofline.pair_count_least_s(661_000, 100) == pytest.approx(
        218_460_169_500 * 50 / rate64)
    assert roofline.pair_count_least_s(661_000, 100) == pytest.approx(
        0.65302, rel=1e-4)
    # odd S pads its last word
    assert roofline.pair_count_least_s(1000, 99) == pytest.approx(
        499_500 * 50 / rate64)
    # bytes bound where operations are few: 2 samples, one pair
    assert roofline.samebits_least_s(2, 1, 16, 1) == pytest.approx(
        (2 * 16 * 14 * 8 + 2 * 8) / 3.35e12)


def test_breakdown_names_ops_and_what_the_host_did_while_idle():
    b = breakdown(recorded())
    ops = dict(b["device_ops"])
    assert ops[short_name(K2)] == pytest.approx(0.040)
    assert short_name(K2) == "(anonymous namespace)::coreacc_kernel"
    assert short_name(CAT) == \
        "at::native::(anonymous namespace)::CatArrayBatchedCopy"
    assert short_name("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD"
    idle = dict(b["idle_gaps"])
    # idle 5-10 ms and 45-120 outside any host operation, and 150-200
    # while the host was in aten::nonzero
    assert idle["host outside torch operations"] == pytest.approx(0.080)
    assert idle["aten::nonzero"] == pytest.approx(0.050)
    assert sum(idle.values()) == pytest.approx(0.130)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
