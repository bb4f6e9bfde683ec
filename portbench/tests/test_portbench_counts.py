"""The roofline counts, the idle union and the whole-window arithmetic."""

import math

import pytest

import devtrace
import run as harness
from metrics import dcs_roofline_pct, device_idle_pct, refine_s
from roofline import PEAK_BYTES, PEAK_FP32_FLOPS, dcs_counts, least_seconds


def test_dcs_counts_by_hand():
    # 2 points of 1 dimension, 1 cut of 2 clusters, both ids inside one:
    # 2·2·(2·1 + 3) + 2·2 operations; 4·(2 + 2 + 4) bytes
    assert dcs_counts(2, 1, 1, 2, 2) == (24.0, 32.0)
    assert least_seconds(24.0, 32.0) == max(24 / PEAK_FP32_FLOPS,
                                            32 / PEAK_BYTES)


def test_dcs_bound_at_the_26k_flagship():
    # 26,000 × 15 points, 4 cuts with 449 clusters, every cell labelled:
    # the 0.3733134328358209 ms bound the port's records carry
    ops, nbytes = dcs_counts(26000, 15, 4, 449, 4 * 26000)
    assert ops == 26000 ** 2 * 33 + 26000 * 104000
    assert least_seconds(ops, nbytes) * 1e3 == pytest.approx(
        0.3733134328358209, rel=1e-12)
    assert ops / PEAK_FP32_FLOPS > nbytes / PEAK_BYTES


@pytest.mark.parametrize("name, hit", [
    ("void (anonymous namespace)::sweep_kernel<16, 4>(float const*)", True),
    ("(anonymous namespace)::reduce_kernel(float const*, float*, int)", True),
    ("(anonymous namespace)::prepare_kernel(float const*, int const*)", True),
    ("(anonymous namespace)::keys_kernel(int const*, int*, int)", True),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>",
     False),
    ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<float>", False),
])
def test_dcs_kernel_names(name, hit):
    assert bool(dcs_roofline_pct.KERNELS.match(name)) is hit


def _fake_run(jobs, window_s, failed=0, trace=None):
    run = harness.Run.__new__(harness.Run)
    run.jobs, run.window_s, run.failed, run.trace = jobs, window_s, failed, \
        trace
    return run


def test_refine_s_is_whole_window_arithmetic():
    jobs = [{"wall_s": w, "stage_walls_s": {}} for w in (2.0, 3.0, 4.0)]
    # the window's seconds over its jobs, not a mean or median of walls
    assert refine_s.read(_fake_run(jobs, 9.6)) == pytest.approx(3.2)
    assert refine_s.read(_fake_run(jobs, 9.6, failed=1)) is None
    assert refine_s.read(_fake_run([], 9.6)) is None


def _x(name, ts, dur, cat):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def test_idle_union_on_a_synthetic_trace():
    events = [
        _x("portbench.window", 0.0, 1e6, "user_annotation"),
        _x("portbench.refine", 1e5, 8e5, "user_annotation"),
        _x("k1", 1e5, 2e5, "kernel"),
        _x("k2", 2e5, 2e5, "kernel"),          # overlaps k1: counted once
        _x("copy", 6e5, 1e5, "gpu_memcpy"),
        _x("k1", 2e6, 1e5, "kernel"),          # outside the window
        _x("host", 0.0, 5e5, "cpu_op"),        # host time is not busy
    ]
    jobs = [{"spans": [{"name": "tree", "kind": "stage", "depth": 0,
                        "t0_s": 0.35, "wall_synced_s": 0.2}]}]
    s = devtrace.summarize({"traceEvents": events}, jobs)
    assert s["window_s"] == pytest.approx(1.0)
    assert s["busy_s"] == pytest.approx(0.4)
    assert s["kernel_s"] == pytest.approx({"k1": 0.2, "k2": 0.2,
                                           "copy": 0.1})
    gaps = dict((round(sec, 6), name)
                for name, sec in s["breakdown"]["idle_gaps"])
    # [0.4, 0.6] s lies in the tree stage, [0, 0.1] before the refine,
    # [0.7, 1.0] in the refine after its stages
    assert gaps == {0.2: "stage:tree", 0.1: "between jobs",
                    0.3: "refine"}
    run = _fake_run([], 1.0, trace=s)
    assert device_idle_pct.read(run) == pytest.approx(60.0)


def test_union_intervals_clips_and_merges():
    busy = devtrace.union_intervals([(5, 8), (0, 2), (1, 3), (9, 20)], 1, 10)
    assert busy == [(1, 3), (5, 8), (9, 10)]
    assert devtrace.gaps(busy, 0, 12) == [(0, 1), (3, 5), (8, 9), (10, 12)]
    assert math.isclose(sum(e - s for s, e in busy), 6)


def test_the_judged_jobs_copy_leaves_the_window():
    events = [
        _x("portbench.window", 0.0, 1e6, "user_annotation"),
        _x("k1", 1e5, 2e5, "kernel"),
        _x("portbench.keep", 5e5, 2e5, "user_annotation"),
        _x("copy", 5e5, 1e5, "gpu_memcpy"),     # the copy: not counted
        _x("k2", 8e5, 1e5, "kernel"),
    ]
    s = devtrace.summarize({"traceEvents": events}, [])
    assert s["window_s"] == pytest.approx(0.8)
    assert s["busy_s"] == pytest.approx(0.3)
    assert s["kernel_s"] == pytest.approx({"k1": 0.2, "k2": 0.1})
    idle = sorted(round(sec, 6) for _, sec in s["breakdown"]["idle_gaps"])
    # [0, 0.1], [0.3, 0.5], [0.7, 0.8], [0.9, 1.0]: the keep stretch is out
    assert idle == [0.1, 0.1, 0.1, 0.2]
    assert devtrace.subtract([(0, 10)], [(2, 3), (5, 7)]) == [
        (0, 2), (3, 5), (7, 10)]
