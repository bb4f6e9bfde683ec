"""The port's spans on the profiler's clock (``obs/trace.py``,
``utils/timing.py``): every span is a ``record_function`` window while a
``torch.profiler`` records, whoever opened it, and costs no
``record_function`` call otherwise; ``refine()`` opens the spans the
benchmark reads (``consensus``, ``preflight``, the ``de`` window, the
tree's, the cut's and the pooled silhouette's); the kernel capture still
joins kernels to spans; ``StageClock`` drains the card once a boundary."""

import json
import logging
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import scconsensus_tpu_torch as port
from scconsensus_tpu_torch.obs import kernels, trace
from scconsensus_tpu_torch.utils.logging import StageTimer
from scconsensus_tpu_torch.utils.synthetic import noisy_labeling, synthetic_scrna
from scconsensus_tpu_torch.utils.timing import StageClock


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    lg = logging.getLogger("scconsensus_tpu_torch")
    level = lg.level
    lg.setLevel(logging.WARNING)
    yield
    lg.setLevel(level)
    torch.set_num_threads(n)


def _windows(prof, tmp_path):
    """The host annotation windows of a finished profile: [(name, start,
    end)] by start."""
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in events if e.get("ph") == "X"
                  and e.get("cat") == "user_annotation")


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_tracer_and_null_spans_are_nested_profiler_windows(tmp_path):
    tr = trace.Tracer(sync="off")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("outer_stage", kind="stage"):
            with trace.span("inner_detail"):
                torch.ones(8) @ torch.ones(8)
        # no ambient tracer: the null span records nothing, but annotates
        with trace.span("lonely") as sp:
            sp["ignored"] = 1
    wins = {w[0]: w for w in _windows(prof, tmp_path)}
    assert {"outer_stage", "inner_detail", "lonely"} <= set(wins)
    assert _inside(wins["inner_detail"], wins["outer_stage"])
    assert wins["lonely"][1] >= wins["outer_stage"][2]
    # the tracer's tree is the windows' nesting
    recs = {r["name"]: r for r in tr.span_records()}
    assert recs["inner_detail"]["parent_id"] == recs["outer_stage"]["span_id"]
    assert "lonely" not in recs


def test_no_record_function_call_without_a_profiler(monkeypatch):
    import torch.profiler as tp

    calls = []
    real = tp.record_function

    def counting(name, *a, **k):
        calls.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(tp, "record_function", counting)
    tr = trace.Tracer(sync="off")
    assert not trace.profiling()
    with tr.span("stage_a", kind="stage"):
        with trace.span("detail_a"):
            pass
    with trace.span("null_a"):
        pass
    with StageClock(torch.device("cpu"), tracer=tr).stage("de", span=False):
        pass
    assert calls == []
    # the same spans under a profiler do call it: the counter is live
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.profiling()
        with tr.span("stage_b", kind="stage"):
            with trace.span("detail_b"):
                pass
    assert calls == ["stage_b", "detail_b"]


def test_profiling_reads_no_torch_that_is_not_loaded(monkeypatch):
    # a process that never imported torch: the check neither imports it
    # nor annotates
    monkeypatch.setitem(sys.modules, "torch", None)
    assert trace.profiling() is False
    with trace.annotation("x"):
        pass


def test_stage_clock_without_a_span_is_a_profiler_window(tmp_path):
    tr = trace.Tracer(sync="off")
    clock = StageClock(torch.device("cpu"), tracer=tr)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with clock.stage("de", span=False):
            with clock.stage("wilcox_test"):
                pass
    wins = {w[0]: w for w in _windows(prof, tmp_path)}
    assert _inside(wins["wilcox_test"], wins["de"])
    # a window, not a span: the tracer's tree has no "de"
    assert [r["name"] for r in tr.span_records()] == ["wilcox_test"]
    assert set(clock.walls) == {"de", "wilcox_test"}
    assert clock.walls["de"] >= clock.walls["wilcox_test"]


def test_stage_clock_drains_once_a_boundary(monkeypatch):
    """On the card a stage span drains at its two boundaries and the
    clock adds none; a stage without a span, or a detail span that does
    not drain, is drained by the clock."""
    synced, drained = [], []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: synced.append(1))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)

    def drain():
        drained.append(1)
        return True

    monkeypatch.setattr(trace, "device_drain", drain)
    tr = trace.Tracer(sync="stage", sample_device=False)
    clock = StageClock(torch.device("cuda"), tracer=tr)
    with clock.stage("tree") as sp:
        pass
    assert (len(drained), len(synced)) == (2, 0)
    assert sp.synced and clock.walls["tree"] == sp.wall_synced_s
    with clock.stage("de", span=False):
        pass
    assert (len(drained), len(synced)) == (2, 2)
    with clock.detail("edger_setup"):
        pass
    assert (len(drained), len(synced)) == (2, 4)
    # every span drains under SCC_TRACE_SYNC=all: the detail too
    clock_all = StageClock(torch.device("cuda"),
                           tracer=trace.Tracer(sync="all",
                                               sample_device=False))
    with clock_all.detail("edger_setup"):
        pass
    assert (len(drained), len(synced)) == (4, 4)
    assert set(clock.walls) == {"tree", "de", "edger_setup"}


@pytest.fixture(scope="module")
def pooled_inputs():
    data, truth, _ = synthetic_scrna(n_genes=200, n_cells=900, n_clusters=4,
                                     seed=3)
    sup = noisy_labeling(truth, 0.05, seed=1, prefix="T")
    uns = noisy_labeling(truth, 0.10, seed=2, prefix="L")
    config = port.ReclusterConfig(approx_threshold=400, n_pool_centroids=100)
    return data, sup, uns, config


def test_refine_past_approx_threshold_opens_the_port_spans(pooled_inputs,
                                                           tmp_path):
    data, sup, uns, config = pooled_inputs
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cons = port.plot_contingency_table(sup, uns)
        res = port.refine(data, cons, config, device="cpu", mesh=None)
    names = [w[0] for w in _windows(prof, tmp_path)]
    for name in ("consensus", "preflight", "de", "ladder_plan",
                 "wilcox_bucket", "lloyd", "pool_to_host", "ward", "expand",
                 "colors", "pooled_widths", "aggregate"):
        assert name in names, name
    assert names.count("cutree") == len(config.deep_split_values) == 4
    spans = res.metrics["spans"]
    by = {s["span_id"]: s for s in spans}

    def parent(s):
        return by[s["parent_id"]]["name"]

    cutrees = [s for s in spans if s["name"] == "cutree"]
    assert [s["attrs"]["deep_split"] for s in cutrees] == [1, 2, 3, 4]
    assert {parent(s) for s in cutrees} == {"cuts"}
    ward = next(s for s in spans if s["name"] == "ward")
    assert parent(ward) == "tree" and ward["attrs"]["engine"] in (
        "native", "numpy")
    for name, stage in (("lloyd", "tree"), ("pool_to_host", "tree"),
                        ("expand", "cuts"), ("colors", "cuts"),
                        ("pooled_widths", "silhouette"),
                        ("aggregate", "silhouette")):
        s = next(s for s in spans if s["name"] == name)
        assert s["kind"] == "detail" and parent(s) == stage, name
    pre = next(s for s in spans if s["name"] == "preflight")
    assert pre["kind"] == "detail" and pre["parent_id"] is None
    # the consensus ran with no tracer, "de" is the clock's window: the
    # reference's span tree has neither, the trace has both
    assert not {"consensus", "de"} & {s["name"] for s in spans}
    assert "de" in res.metrics["stage_walls_s"]


def test_kernel_capture_joins_kernels_to_the_port_spans(pooled_inputs,
                                                       tmp_path,
                                                       monkeypatch):
    """``SCC_OBS_KERNELS`` with the default timer: every span is a window
    in the capture, and a kernel launched inside one is put down to it."""
    data, sup, uns, config = pooled_inputs
    monkeypatch.setenv("SCC_OBS_KERNELS", str(tmp_path / "kern"))
    res = port.refine(data, port.plot_contingency_table(sup, uns), config,
                      device="cpu", mesh=None)
    sec = res.metrics["kernels"]
    kernels.validate_kernels(sec)
    assert sec["n_windows"] == len(res.metrics["spans"])
    tr = kernels.parse_trace_file(sec["trace_file"])
    wins = {w["span"]: w for w in kernels.annotation_windows(
        tr, {s["name"] for s in res.metrics["spans"]})}
    # one launch inside each of three spans, its kernel after it
    for corr, span in enumerate(("ward", "cutree", "pooled_widths"), 1):
        t = wins[span]["ts_us"] + 0.5 * wins[span]["dur_us"]
        tr["traceEvents"] += [
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "ts": t, "dur": 1.0, "args": {"correlation": corr}},
            {"ph": "X", "cat": "kernel", "name": f"k_{span}",
             "ts": t + 5e6, "dur": 2.0, "args": {"correlation": corr}}]
    joined = kernels.kernels_section(tr, res.metrics["spans"])
    assert joined["n_unlinked"] == 0
    assert {k: v["span"] for k, v in joined["by_kernel"].items()} == {
        "k_ward": "ward", "k_cutree": "cutree",
        "k_pooled_widths": "pooled_widths"}
    assert {v["stage"] for v in joined["by_kernel"].values()} == {
        "tree", "cuts", "silhouette"}
    np.testing.assert_array_equal(
        res.dynamic_labels["deepsplit: 1"],
        port.refine(data, port.plot_contingency_table(sup, uns), config,
                    device="cpu", mesh=None,
                    timer=StageTimer(logging.getLogger("tw.quiet"))
                    ).dynamic_labels["deepsplit: 1"])
