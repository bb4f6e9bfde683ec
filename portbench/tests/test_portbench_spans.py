"""The program's spans in a traced run's trace (``spantrace.py``) and the
readers of ``consensus_s``, ``de_idle_s``, ``de_launches``, ``ward_s`` and
``implicit_syncs``, on a hand-built Chrome trace and on a traced run of a
small cell on the CPU."""

import gzip
import json
import math
import os
import types

import pytest

import devtrace
import run as harness
import spantrace
from conftest import make_root
from metrics import (consensus_s, de_idle_s, de_launches, implicit_syncs,
                     ward_s)

READERS = {"consensus_s": consensus_s, "de_idle_s": de_idle_s,
           "de_launches": de_launches, "ward_s": ward_s,
           "implicit_syncs": implicit_syncs}


def _x(name, ts, dur, cat, **args):
    e = {"ph": "X", "name": name, "ts": float(ts), "dur": float(dur),
         "cat": cat}
    if args:
        e["args"] = args
    return e


def _ann(name, ts, dur):
    return _x(name, ts, dur, "user_annotation")


# One job in a 1-s window (µs): the benchmark's annotations, the program's
# spans inside them, four kernels and a copy, their launches, and host
# calls that do and do not wait on the card.
BENCH_EVENTS = [
    _ann("portbench.window", 0, 1_000_000),
    _ann("portbench.contingency", 50_000, 100_000),
    _ann("portbench.refine", 200_000, 700_000),
    _ann("portbench.keep", 910_000, 50_000),
]
PROGRAM_EVENTS = [
    _ann("consensus", 60_000, 80_000),
    _ann("de", 250_000, 250_000),
    _ann("wilcox_test", 260_000, 230_000),
    _ann("wilcox_bucket", 300_000, 100_000),
    _ann("cuts", 600_000, 200_000),          # cutree opens with it
    _ann("cutree", 600_000, 100_000),
]
DEVICE_EVENTS = [
    _x("copy", 100_000, 10_000, "gpu_memcpy", correlation=4),
    _x("k1", 320_000, 60_000, "kernel", correlation=1),
    _x("k2", 460_000, 20_000, "kernel", correlation=2),
    _x("k3", 550_000, 30_000, "kernel", correlation=3),
    _x("k4", 640_000, 20_000, "kernel", correlation=5),
    _x("k5", 930_000, 10_000, "kernel", correlation=6),   # in the keep
]
HOST_CALLS = [
    _x("cudaMemcpyAsync", 95_000, 1, "cuda_runtime", correlation=4),
    _x("cudaLaunchKernel", 300_000, 1, "cuda_runtime", correlation=1),
    _x("cudaLaunchKernel", 450_000, 1, "cuda_runtime", correlation=2),
    _x("cudaLaunchKernel", 540_000, 1, "cuda_runtime", correlation=3),
    _x("cuLaunchKernel", 630_000, 1, "cuda_driver", correlation=5),
    _x("cudaLaunchKernel", 925_000, 1, "cuda_runtime", correlation=6),
    _x("cudaStreamSynchronize", 55_000, 1, "cuda_runtime"),   # not consensus
    _x("cudaMemcpy", 100_000, 1, "cuda_runtime"),             # consensus
    _x("cudaStreamSynchronize", 420_000, 1, "cuda_runtime"),  # refine
    _x("cudaDeviceSynchronize", 500_000, 1, "cuda_runtime"),  # a drain
    _x("cudaEventSynchronize", 650_000, 1, "cuda_runtime"),   # refine
    _x("cudaStreamSynchronize", 950_000, 1, "cuda_runtime"),  # between
]
TRACE = {"traceEvents": BENCH_EVENTS + PROGRAM_EVENTS + DEVICE_EVENTS
         + HOST_CALLS}
BARE = {"traceEvents": BENCH_EVENTS + DEVICE_EVENTS + HOST_CALLS}

# busy: [100, 110], [320, 380], [460, 480], [550, 580], [640, 660] ms;
# the keep [910, 960] is out of the window: idle 810 ms, cut at every
# annotation's ends
IDLE_BY_SPAN = {
    "between jobs": 0.150, "contingency": 0.020, "stage:consensus": 0.070,
    "refine": 0.220, "stage:de": 0.020, "stage:de/wilcox_test": 0.110,
    "stage:de/wilcox_bucket": 0.040, "stage:cuts/cutree": 0.080,
    "stage:cuts": 0.100,
}


def test_the_summary_of_a_trace_with_the_programs_spans():
    s = spantrace.summarize_spans(TRACE, 1)
    assert s["idle_by_span"] == pytest.approx(IDLE_BY_SPAN)
    assert s["idle_s"] == pytest.approx(0.81)
    assert s["consensus_s"] == pytest.approx(0.08)
    assert s["de_s"] == pytest.approx(0.25)
    # the de window less k1 and k2
    assert s["de_idle_s"] == pytest.approx(0.17)
    assert s["de_launches"] == 2
    assert s["launches_by_span"] == pytest.approx({
        "stage:de/wilcox_bucket": 1, "stage:de/wilcox_test": 1,
        "refine": 1, "stage:cuts/cutree": 1})
    assert s["device_s_by_span"] == pytest.approx({
        "stage:de/wilcox_bucket": 0.06, "stage:de/wilcox_test": 0.02,
        "refine": 0.03, "stage:cuts/cutree": 0.02})
    # the copy inside the consensus, a stream and an event wait inside the
    # refine; not the drain, the async copy or a wait outside both
    assert s["implicit_syncs"] == 3
    assert s["syncs_by_span"] == pytest.approx({
        "stage:consensus": 1, "stage:de/wilcox_test": 1,
        "stage:cuts/cutree": 1})
    assert s["annotations_per_job"] == len(PROGRAM_EVENTS)
    assert s["annotations_by_name"] == dict.fromkeys(
        ("consensus", "cuts", "cutree", "de", "wilcox_bucket",
         "wilcox_test"), 1.0)


def test_idle_by_span_adds_up_to_devtraces_idle_time():
    s = spantrace.summarize_spans(TRACE, 2)
    d = devtrace.summarize(TRACE, [])
    per_job = (d["window_s"] - d["busy_s"]) / 2
    assert sum(s["idle_by_span"].values()) == pytest.approx(per_job)
    assert s["idle_s"] == pytest.approx(per_job)
    assert s["de_idle_s"] == pytest.approx(0.085)


def test_gaps_are_named_by_the_innermost_span_under_the_stage():
    gaps = [(n, round(sec, 6))
            for n, sec in spantrace.summarize_spans(TRACE, 1)["idle_gaps"]]
    assert gaps == [("stage:cuts", 0.25), ("refine", 0.21),
                    ("contingency", 0.1), ("stage:de/wilcox_test", 0.08),
                    ("refine", 0.07), ("stage:cuts/cutree", 0.06),
                    ("between jobs", 0.04)]


@pytest.mark.parametrize("stack, name", [
    (["cuts"], "stage:cuts"),
    (["cuts", "cutree"], "stage:cuts/cutree"),
    (["de", "wilcox_test", "wilcox_bucket"], "stage:de/wilcox_bucket"),
])
def test_span_names(stack, name):
    assert spantrace.span_name(stack) == name


def test_a_gap_is_split_at_every_span_it_crosses():
    # one gap across the end of a bucket and of its stage and into the
    # refine: three pieces, three names
    events = [_ann("portbench.window", 0, 100), _ann("portbench.refine",
                                                     0, 100),
              _ann("de", 10, 60), _ann("wilcox_bucket", 10, 30),
              _x("k", 0, 20, "kernel"), _x("k", 90, 10, "kernel")]
    s = spantrace.summarize_spans({"traceEvents": events}, 1)
    assert s["idle_by_span"] == pytest.approx({
        "stage:de/wilcox_bucket": 20e-6, "stage:de": 30e-6,
        "refine": 20e-6})
    assert s["idle_gaps"] == [["stage:de", pytest.approx(70e-6)]]


def test_a_trace_without_the_programs_spans_gives_none():
    assert spantrace.summarize_spans(BARE, 1) is None
    assert spantrace.summarize_spans({"traceEvents": []}, 1) is None
    assert spantrace.summarize_spans(TRACE, 0) is None


def _run_over(tmp_path, trace, spans=None, traced=True, n_jobs=1):
    """A run whose window left ``trace`` where ``devtrace.export`` keeps
    it, with ``n_jobs`` jobs (each with ``spans``)."""
    out = tmp_path / "portbench" / "_out"
    out.mkdir(parents=True, exist_ok=True)
    with gzip.open(out / "x.cell.trace.json.gz", "wt") as f:
        json.dump(trace, f)
    run = harness.Run.__new__(harness.Run)
    run.cell = types.SimpleNamespace(root=str(tmp_path), name="x.cell")
    run.traced = traced
    run.jobs = [{"wall_s": 1.0, "stage_walls_s": {"tree": 0.3},
                 "spans": spans or []} for _ in range(n_jobs)]
    run.failed, run.window_s = 0, 1.0
    run.trace = devtrace.summarize(trace, run.jobs)
    return run


WARD = [{"name": "tree", "kind": "stage", "depth": 0, "t0_s": 0.3,
         "wall_synced_s": 0.3},
        {"name": "ward", "kind": "detail", "depth": 1, "t0_s": 0.4,
         "wall_synced_s": None, "wall_submitted_s": 0.125}]


def test_the_readers_on_a_run_with_the_programs_spans(tmp_path):
    run = _run_over(tmp_path, TRACE, spans=WARD, n_jobs=2)
    got = {name: r.read(run) for name, r in READERS.items()}
    assert got == pytest.approx({
        "consensus_s": 0.04, "de_idle_s": 0.085, "de_launches": 1.0,
        "ward_s": 0.125, "implicit_syncs": 1.5})
    # the summary is written beside the trace, and read once
    path = tmp_path / "portbench" / "_out" / "x.cell.spans.json"
    with open(path) as f:
        assert json.load(f)["idle_by_span"] == pytest.approx(
            {k: v / 2 for k, v in IDLE_BY_SPAN.items()})
    os.unlink(path)
    assert consensus_s.read(run) == pytest.approx(0.04)


def test_the_readers_give_none_without_the_programs_spans(tmp_path):
    run = _run_over(tmp_path, BARE)
    assert {name: r.read(run) for name, r in READERS.items()} == dict.fromkeys(
        READERS)
    # an untraced run reads no trace at all
    run = _run_over(tmp_path / "u", TRACE, spans=WARD, traced=False)
    assert {n: r.read(run) for n, r in READERS.items() if n != "ward_s"} \
        == dict.fromkeys(set(READERS) - {"ward_s"})


def test_a_traced_cpu_run_reports_the_new_metrics(tmp_path):
    """The pool branch of a small cell, traced on the CPU: the program's
    spans are in the trace and the readers find them (no card: no device
    event, no launch and no sync)."""
    cell = harness.Cell("tiny.wilcox", make_root(tmp_path, branch="pool"))
    run = harness.run_cell(cell, 2**33 + 11, 0.0, True, device="cpu")
    m = {k: v["value"] for k, v in
         harness.result_line(run, "cpu")["metrics"].items()}
    assert set(READERS) <= set(m)
    assert all(math.isfinite(m[k]) for k in READERS)
    assert 0 < m["consensus_s"] <= m["pipeline_other_s"]
    assert 0 < m["ward_s"] <= m["tree_s"]
    assert 0 < m["de_idle_s"] <= m["de_s"]
    assert m["de_launches"] == m["implicit_syncs"] == 0
    s = spantrace.of(run)
    assert {"stage:consensus", "stage:de/wilcox_bucket",
            "stage:cuts/cutree"} <= set(s["idle_by_span"])
