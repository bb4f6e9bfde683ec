"""The run record in the port, held against the JAX package: the schema
module (``obs/export.py``), the tracer's views and annotate mode
(``obs/trace.py``), ``StageTimer`` (``utils/logging.py``), the kernel
capture (``obs/kernels.py``), ``refine(timer=...)`` with ``SCC_TRACE_DIR``
and ``SCC_OBS_KERNELS``, and the soak workers' records. Records cross in
both directions: the port's pass the reference's validator, and the
reference's pass the port's for the sections the port has."""

import copy
import json
import logging
import os

import numpy as np
import pytest
import torch

import scconsensus_tpu.obs.export as ref_export
import scconsensus_tpu.obs.kernels as ref_kernels
import scconsensus_tpu.obs.trace as ref_trace
import scconsensus_tpu_torch as port
from scconsensus_tpu.config import ReclusterConfig as RefConfig
from scconsensus_tpu.models.pipeline import refine as ref_refine
from scconsensus_tpu.utils.logging import StageTimer as RefTimer
from scconsensus_tpu.utils.synthetic import noisy_labeling, synthetic_scrna
from scconsensus_tpu_torch.obs import export, kernels, trace
from scconsensus_tpu_torch.utils.logging import StageTimer, get_logger


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _quiet(name):
    lg = logging.getLogger(name)
    lg.setLevel(logging.WARNING)
    return lg


@pytest.fixture(scope="module")
def runs():
    """One small Wilcoxon refine in each package with a StageTimer."""
    data, truth, _ = synthetic_scrna(n_genes=120, n_cells=300, n_clusters=3,
                                     seed=3)
    labels = noisy_labeling(truth, 0.05, seed=2)
    ref = ref_refine(data, labels, RefConfig(),
                     timer=RefTimer(_quiet("rr.ref")), mesh=None)
    timer = StageTimer(_quiet("rr.port"))
    got = port.refine(data, labels, port.ReclusterConfig(), device="cpu",
                      mesh=None, timer=timer)
    return {"data": data, "labels": labels, "ref": ref, "got": got,
            "timer": timer}


def _tree(spans):
    by = {s["span_id"]: s for s in spans}
    return [(s["name"], s["kind"], s["depth"],
             by[s["parent_id"]]["name"] if s["parent_id"] is not None
             else None) for s in spans]


# --------------------------------------------------------------------------
# refine(timer=...) and the tracer's views
# --------------------------------------------------------------------------

def test_refine_metrics_carry_the_tracer_views(runs):
    got, ref = runs["got"].metrics, runs["ref"].metrics
    for key in ("stages", "total_s", "spans", "schema", "schema_version"):
        assert key in got, key
    assert got["schema"] == ref["schema"] == "scc-run-record"
    assert got["schema_version"] == ref["schema_version"] == 1
    # the stages and the span tree have the reference's shape
    assert [s["stage"] for s in got["stages"]] == \
        [s["stage"] for s in ref["stages"]]
    assert _tree(got["spans"]) == _tree(ref["spans"])
    assert got["total_s"] == pytest.approx(
        sum(s["wall_s"] for s in got["stages"]), abs=1e-3)
    # the stage walls the port kept are the spans' stages plus de
    assert set(got["stage_walls_s"]) - {s["stage"] for s in got["stages"]} \
        == {"de"}
    union = next(s for s in got["stages"] if s["stage"] == "union")
    assert union["union_size"] == got["union_size"]
    # the timer the caller passed owns the tracer
    assert runs["timer"].records == got["stages"]
    assert runs["timer"].total_s() == got["total_s"]


def test_stage_records_and_summaries_equal_the_reference():
    """The same spans through both tracers give the same views; the log
    rendering summarizes long lists the same way."""
    recs = {}
    for name, mod in (("port", trace), ("ref", ref_trace)):
        tr = mod.Tracer(sync="off")
        with tr.span("de", kind="stage", n_pairs=3) as sp:
            sp["per_pair"] = list(range(40))
            with tr.span("wilcox_bucket", kind="detail", window=64):
                pass
        tr.add_completed_span("edger_setup", 0.01, kind="detail")
        recs[name] = tr
    a, b = recs["port"], recs["ref"]
    strip = ("wall_s", "wall_submitted_s", "wall_synced_s", "synced")
    assert [{k: v for k, v in r.items() if k not in strip}
            for r in a.stage_records()] == \
        [{k: v for k, v in r.items() if k not in strip}
         for r in b.stage_records()]
    assert _tree(a.span_records()) == _tree(b.span_records())
    rec = {"per_pair_de_counts": list(range(50)),
           "occupancy": {"buckets": list(range(20)), "n": 3}, "x": 1.5}
    assert trace.summarize_record(rec) == ref_trace.summarize_record(rec)
    d = a.as_dict()
    # the compile stats of the tracer's window (the native builds: none
    # here), under the reference's keys
    assert set(d) == set(b.as_dict()) == {"stages", "total_s", "spans",
                                          "schema", "schema_version",
                                          "compile"}
    assert a.compile_stats() == {"events": 0, "total_s": 0.0,
                                 "by_event": {}}
    assert set(a.compile_stats()) == set(b.compile_stats())


def test_open_stack_live_records_and_ambient_stage():
    tr = trace.Tracer(sync="off")
    assert trace.current_tracer() is None
    assert trace.ambient_stage() == (None, 0)  # the last tracer, no stage
    with tr.span("de", kind="stage"):
        with tr.span("de", kind="stage"):
            pass
        with tr.span("wilcox_bucket", kind="detail"):
            stack = tr.open_stack()
            assert [s["name"] for s in stack] == ["de", "wilcox_bucket"]
            assert trace.ambient_stage() == ("de", 2)
            live = tr.live_span_records()
            rec = export.build_run_record("live", 1, spans=live)
            export.validate_run_record(rec)
            ref_export.validate_run_record(rec)
            assert sum(1 for s in live if (s.get("attrs") or {}).get(
                "open")) == 2


def test_annotate_mode_emits_profiler_windows(tmp_path):
    """Annotate mode: each span is a record_function window in a
    torch.profiler trace, nested as the spans are."""
    from torch.profiler import ProfilerActivity, profile

    timer = StageTimer(_quiet("rr.ann"), trace=True)
    assert timer.tracer.annotate
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.stage("embed"):
            with trace.span("wilcox_bucket"):
                torch.ones(8) @ torch.ones(8)
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    wins = kernels.annotation_windows(kernels.parse_trace_file(path),
                                      {"embed", "wilcox_bucket"})
    assert sorted(w["span"] for w in wins) == ["embed", "wilcox_bucket"]
    outer = next(w for w in wins if w["span"] == "embed")
    inner = next(w for w in wins if w["span"] == "wilcox_bucket")
    assert outer["ts_us"] <= inner["ts_us"]
    assert inner["ts_us"] + inner["dur_us"] <= outer["ts_us"] + \
        outer["dur_us"]


def test_get_logger_logs_each_stage_once(caplog):
    lg = get_logger("rr.logger-test")
    assert lg.level == logging.INFO and lg.handlers
    lg.propagate = True
    try:
        with caplog.at_level(logging.INFO, logger="rr.logger-test"):
            timer = StageTimer(lg)
            with timer.stage("union", per_pair=list(range(30))):
                pass
        lines = [r.getMessage() for r in caplog.records]
        assert len(lines) == 1 and lines[0].startswith("stage ")
        assert json.loads(lines[0][6:])["per_pair"]["n"] == 30
    finally:
        lg.propagate = False


# --------------------------------------------------------------------------
# the schema module
# --------------------------------------------------------------------------

def test_port_records_pass_the_reference_validator(runs):
    m = runs["got"].metrics
    rec = export.build_run_record(
        "refine wall", 1.25, spans=m["spans"], quality=m["quality"],
        extra={"platform": "cpu"})
    assert rec["run"]["torch_version"] == torch.__version__
    assert "jax_version" not in rec["run"]
    assert rec["device"]["memory"] is None  # no card in this process
    # no tracer given: no compile stats, as in the reference
    assert "compile" not in rec["device"]
    for validate in (export.validate_run_record,
                     ref_export.validate_run_record):
        validate(rec)
    # with a tracer the device section carries its compile stats (the
    # native builds since it was made: none here), the reference's shape
    tr = trace.Tracer(sync="off")
    with_tracer = export.build_run_record("x", 1, tracer=tr)
    assert with_tracer["device"]["compile"] == {
        "events": 0, "total_s": 0.0, "by_event": {}}
    assert set(with_tracer["device"]["compile"]) == set(
        ref_trace.Tracer(sync="off").compile_stats())
    for validate in (export.validate_run_record,
                     ref_export.validate_run_record):
        validate(with_tracer)
    assert export.check_schema_version(rec) == \
        ref_export.check_schema_version(rec) == "v1"


def test_reference_records_pass_the_port_validator(runs):
    m = runs["ref"].metrics
    rec = ref_export.build_run_record(
        "refine wall", 1.0, spans=m["spans"], quality=m["quality"],
        kernels=ref_kernels.kernels_section({"traceEvents": []}, m["spans"]),
        tunnel={"state": "missing"})
    rec["termination"] = {"cause": "clean", "last_span": "quality",
                          "open_spans": []}
    export.validate_run_record(rec)
    ref_export.validate_run_record(rec)


@pytest.mark.parametrize("breakage", [
    "schema", "version", "metric", "dangling", "synced", "negative",
    "termination", "kernels", "tunnel"])
def test_both_validators_refuse_the_same_records(runs, breakage):
    rec = export.build_run_record("x", 1, spans=runs["got"].metrics["spans"])
    rec = copy.deepcopy(rec)
    if breakage == "schema":
        rec["schema"] = "other"
    elif breakage == "version":
        rec["schema_version"] = 2
    elif breakage == "metric":
        rec["metric"] = ""
    elif breakage == "dangling":
        rec["spans"][0]["parent_id"] = 10 ** 6
    elif breakage == "synced":
        rec["spans"][0].update(synced=True, wall_synced_s=None)
    elif breakage == "negative":
        rec["spans"][0]["t0_s"] = -1.0
    elif breakage == "termination":
        rec["termination"] = {"cause": "melted"}
    elif breakage == "kernels":
        rec["kernels"] = {"n_events": -1, "total_device_time_s": 0,
                          "top": []}
    elif breakage == "tunnel":
        rec["tunnel"] = {"state": "sunny"}
    msgs = []
    for validate in (export.validate_run_record,
                     ref_export.validate_run_record):
        with pytest.raises(ValueError) as ei:
            validate(rec)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_check_schema_version_verdicts_equal_the_reference():
    for rec in ({}, {"metric": "legacy"}, [],
                {"schema": "scc-run-record", "schema_version": 1}):
        assert export.check_schema_version(rec) == \
            ref_export.check_schema_version(rec)
    for rec in ({"schema": "nope"},
                {"schema": "scc-run-record", "schema_version": 7}):
        msgs = []
        for mod in (export, ref_export):
            with pytest.raises(ValueError) as ei:
                mod.check_schema_version(rec, source="f.json")
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]
    assert (export.SCHEMA_NAME, export.SCHEMA_VERSION,
            export.TERMINATION_CAUSES) == (
        ref_export.SCHEMA_NAME, ref_export.SCHEMA_VERSION,
        ref_export.TERMINATION_CAUSES)


@pytest.mark.parametrize("section", ["loadgen"])
def test_a_section_the_port_cannot_validate_raises(section, monkeypatch):
    # every section is validated now (the load generator's was the last);
    # the refusal is held here on a stand-in, as for UNPORTED_FLAGS
    assert export.UNPORTED_SECTIONS == ()
    monkeypatch.setattr(export, "UNPORTED_SECTIONS", (section,))
    rec = export.build_run_record("x", 1, **{section: {"anything": 1}})
    assert rec[section] == {"anything": 1}
    with pytest.raises(NotImplementedError, match=section):
        export.validate_run_record(rec)


def _ported_section(section):
    """A small valid section of each kind the port now validates, built
    by the port's own builders."""
    from scconsensus_tpu_torch.obs import compilelog, graphs, hostprof, \
        profile

    res = {"mode": "audit", "to_device": {"calls": 1, "bytes": 64},
           "to_host": {"calls": 1, "bytes": 8},
           "by_stage": {"de": {"to_host_bytes": 8, "to_device_bytes": 64,
                               "calls": 2}},
           "by_boundary": {"label_fetch": {"to_host_bytes": 8,
                                           "to_device_bytes": 0,
                                           "calls": 1}},
           "events": [], "violations": []}
    return {
        "residency": res,
        "profile": profile.build_profile(
            [{"name": "de", "kind": "stage", "wall_synced_s": 1.5}],
            residency=res),
        "residency_burndown": profile.build_burndown(res),
        "host_profile": hostprof.build_host_profile(
            [(0.0, "de", "python", "a.py:f:1"),
             (0.02, None, "blocking_wait", None)]),
        "memory_timeline": hostprof.build_memory_timeline(
            [(0.0, 1 << 20, None, "de"), (0.02, 2 << 20, 4096, None)]),
        "compile": compilelog.build_compile_section(
            [("scc/native/cuda_backend_compile", 12.5, None, 0),
             ("scc/native/ward_backend_compile", 3.25, "tree", 1)],
            cache_hits=1),
        # the pure builder, without the fingerprint: the reference's
        # validator keys the digest on JAX's fields (test_torch_obs_graphs)
        "graphs": graphs.build_graphs_section([graphs.build_passport(
            "gates.pair_gates_fast", {"gt": 2, "_local_scalar_dense": 1},
            callbacks=[{"target": "_local_scalar_dense",
                        "where": "scconsensus_tpu_torch/ops/gates.py:1"}],
            memory={"argument_bytes": 64, "output_bytes": 32},
            stage="gates")]),
    }[section]


# (section, a corruption each validator must refuse)
PORTED_SECTIONS = {
    "residency": ("mode", "bogus"),
    "profile": ("version", 9),
    "residency_burndown": ("total_bytes", -1),
    "host_profile": ("n_samples", 99),
    "memory_timeline": ("rss_peak_bytes", 0),
    "compile": ("retraces", 5),
    "graphs": ("version", 2),
}


@pytest.mark.parametrize("section", PORTED_SECTIONS)
def test_a_ported_section_validates(section):
    """A section the port now carries passes the port's validator and the
    reference's, and a corrupt one fails both."""
    sec = _ported_section(section)
    rec = export.build_run_record("x", 1, **{section: sec})
    export.validate_run_record(rec)
    ref_export.validate_run_record(rec)
    key, bad = PORTED_SECTIONS[section]
    broken = copy.deepcopy(rec)
    broken[section][key] = bad
    for validate in (export.validate_run_record,
                     ref_export.validate_run_record):
        with pytest.raises(ValueError):
            validate(broken)


def test_a_captured_graphs_section_with_its_fingerprint_in_both_validators():
    """A real CPU capture, fingerprint included, in a whole run record:
    the port's validator passes it, and the reference's refuses it with
    exactly the digest error (it recomputes the digest over JAX's
    fields) and passes it once the fingerprint alone is dropped. This is
    the boundary of what a port record can show the reference."""
    from scconsensus_tpu_torch.obs import graphs
    from scconsensus_tpu_torch.ops.pca import pca_scores

    graphs.install_and_mark(force=True)
    try:
        pca_scores(torch.randn(40, 6), 3)
        sec = graphs.snapshot()
    finally:
        graphs.reset()
    assert sec["fingerprint"]["backend"] == "cpu"
    assert [p["program"] for p in sec["programs"].values()] == [
        "embed.pca_scores"]
    rec = export.build_run_record("x", 1, graphs=sec)
    export.validate_run_record(rec)
    with pytest.raises(ValueError) as err:
        ref_export.validate_run_record(rec)
    assert str(err.value) == ("graphs section: fingerprint.digest does not "
                              "match its fields")
    stripped = dict(rec, graphs={k: v for k, v in sec.items()
                                 if k != "fingerprint"})
    ref_export.validate_run_record(stripped)


def test_chrome_trace_equals_the_reference(runs, tmp_path):
    spans = runs["got"].metrics["spans"]
    got = export.chrome_trace(spans)
    assert got == ref_export.chrome_trace(spans)
    assert sum(e["ph"] == "X" for e in got["traceEvents"]) == len(spans)
    export.write_chrome_trace(str(tmp_path / "a.json"), spans)
    ref_export.write_chrome_trace(str(tmp_path / "b.json"), spans)
    assert json.load(open(tmp_path / "a.json")) == \
        json.load(open(tmp_path / "b.json"))


# --------------------------------------------------------------------------
# SCC_TRACE_DIR and SCC_OBS_KERNELS through refine()
# --------------------------------------------------------------------------

def _check_trace_dir(d, n_spans=None):
    rec = json.load(open(os.path.join(d, "run_record.json")))
    export.validate_run_record(rec)
    ref_export.validate_run_record(rec)
    tr = json.load(open(os.path.join(d, "trace.json")))
    xs = [e for e in tr["traceEvents"] if e["ph"] == "X"]
    assert len(xs) == len(rec["spans"])
    if n_spans is not None:
        assert len(rec["spans"]) == n_spans
    return rec


def test_trace_dir_and_kernel_capture_on_a_cpu_run(runs, tmp_path,
                                                   monkeypatch):
    monkeypatch.setenv("SCC_TRACE_DIR", str(tmp_path / "trace"))
    monkeypatch.setenv("SCC_OBS_KERNELS", str(tmp_path / "kern"))
    res = port.refine(runs["data"], runs["labels"], port.ReclusterConfig(),
                      device="cpu", mesh=None)
    rec = _check_trace_dir(str(tmp_path / "trace"))
    assert [s["name"] for s in rec["spans"] if s["kind"] == "stage"] == \
        [s["stage"] for s in res.metrics["stages"]]
    # a CPU capture: the annotation windows are there, no CUDA kernel
    sec = res.metrics["kernels"]
    kernels.validate_kernels(sec)
    ref_kernels.validate_kernels(sec)
    assert sec["n_events"] == 0 and sec["n_windows"] >= len(
        res.metrics["stages"])
    assert os.path.exists(sec["trace_file"]) and \
        sec["trace_file"].endswith(".trace.json.gz")
    full = export.build_run_record("refine", 1.0, spans=res.metrics["spans"],
                                   kernels=sec)
    export.validate_run_record(full)
    ref_export.validate_run_record(full)
    # annotations and capture change no result
    np.testing.assert_array_equal(res.de_gene_union_idx,
                                  runs["got"].de_gene_union_idx)
    for key, lab in runs["got"].dynamic_labels.items():
        np.testing.assert_array_equal(res.dynamic_labels[key], lab)


def test_trace_dir_is_written_when_a_stage_raises(runs, tmp_path,
                                                  monkeypatch):
    """A failed run still leaves both files (the export runs in a
    finally), for the post-mortem: an empty DE union fails after DE."""
    monkeypatch.setenv("SCC_TRACE_DIR", str(tmp_path / "trace"))
    with pytest.raises(ValueError, match="DE gene union"):
        port.refine(runs["data"], runs["labels"],
                    port.ReclusterConfig(log_fc_thrs=100.0), device="cpu",
                    mesh=None)
    rec = _check_trace_dir(str(tmp_path / "trace"))
    names = [s["name"] for s in rec["spans"]]
    assert "de_call" in names and "embed" not in names


# --------------------------------------------------------------------------
# the kernel join on a committed profiler-trace fixture
# --------------------------------------------------------------------------

def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": 1,
            "ts": ts, "dur": dur, "args": args}


# A torch.profiler Chrome trace in miniature: host annotation windows
# (user_annotation), host launches (cuda_runtime / cuda_driver) and CUDA
# kernels (kernel) tied by correlation ids. The kernels run after their
# launching span's host window has closed, as asynchronous kernels do.
FIXTURE = {"traceEvents": [
    {"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
     "args": {"name": "python"}},
    _x("wilcox_test", "user_annotation", 100.0, 100.0),
    _x("wilcox_bucket", "user_annotation", 120.0, 30.0),
    _x("silhouette", "user_annotation", 300.0, 10.0),
    _x("aten::index_select", "cpu_op", 125.0, 3.0),
    _x("cudaLaunchKernel", "cuda_runtime", 130.0, 2.0, correlation=1),
    _x("cudaLaunchKernel", "cuda_runtime", 140.0, 2.0, correlation=2),
    _x("cuLaunchKernel", "cuda_driver", 305.0, 1.0, correlation=3),
    _x("cudaLaunchKernel", "cuda_runtime", 306.0, 1.0, correlation=4),
    # device side: later than the host windows
    _x("rank_sums_kernel", "kernel", 160.0, 20.0, correlation=1),
    _x("rank_sums_kernel", "kernel", 210.0, 20.0, correlation=2),
    _x("void sweep_kernel<4, 8>(float const*)", "kernel", 320.0, 1300.0,
       correlation=3),
    _x("reduce_kernel", "kernel", 1620.0, 5.0, correlation=4),
    # a kernel whose launch is not in the trace: placed by its own time
    _x("orphan_kernel", "kernel", 305.5, 1.0, correlation=99),
    # the device-side copy of an annotation is not a host window
    _x("silhouette", "gpu_user_annotation", 320.0, 1305.0),
]}
SPANS = [
    {"name": "wilcox_bucket", "kind": "detail"},
    {"name": "wilcox_test", "kind": "stage"},
    {"name": "silhouette", "kind": "stage"},
]


def test_kernel_join_goes_through_the_launch():
    sec = kernels.kernels_section(copy.deepcopy(FIXTURE), SPANS, top_k=3)
    kernels.validate_kernels(sec)
    ref_kernels.validate_kernels(sec)
    bk = sec["by_kernel"]
    assert bk["rank_sums_kernel"] == {"count": 2, "device_time_s": 4e-05,
                                      "span": "wilcox_bucket",
                                      "stage": "wilcox_test"}
    sweep = bk["void sweep_kernel<4, 8>(float const*)"]
    assert (sweep["span"], sweep["stage"], sweep["count"]) == (
        "silhouette", "silhouette", 1)
    assert bk["reduce_kernel"]["span"] == "silhouette"
    assert bk["orphan_kernel"]["span"] == "silhouette"
    assert sec["n_events"] == 5 and sec["n_kernels"] == 4
    assert sec["n_unlinked"] == 1 and sec["n_windows"] == 3
    assert [a["kernel"] for a in sec["top"]] == [
        "void sweep_kernel<4, 8>(float const*)", "rank_sums_kernel",
        "reduce_kernel"]
    assert sec["total_device_time_s"] == pytest.approx(1346e-6)
    assert sec["by_stage_device_s"] == {"silhouette": 0.001306,
                                        "wilcox_test": 4e-05}
    # joined on the kernels' own device timestamps (the reference's rule
    # for XLA's host-stamped events), three of five land in no span
    ks = kernels.device_op_events(FIXTURE)
    wins = kernels.annotation_windows(FIXTURE, {s["name"] for s in SPANS})
    ref_kernels.join_kernels_to_spans(ks, wins, ("wilcox_test",
                                                 "silhouette"))
    assert sum(k["span"] is None for k in ks) == 3


def test_kernel_capture_off_and_failing():
    assert kernels.KernelCapture(directory="").section() is None
    cap = kernels.KernelCapture(directory="/nonexistent/\0bad")
    with cap:
        pass
    sec = cap.section([])
    assert sec["n_events"] == 0 and "error" in sec
    kernels.validate_kernels(sec)


# --------------------------------------------------------------------------
# the soak workers' records
# --------------------------------------------------------------------------

def test_stream_soak_summary_carries_a_validated_record(tmp_path):
    from scconsensus_tpu.stream import soak as ref_stream_soak
    from scconsensus_tpu_torch.stream import soak as stream_soak

    kw = dict(n_cells=600, n_genes=48, n_clusters=3, seed=7)
    got = stream_soak.run_stream_soak(str(tmp_path / "p"), device="cpu",
                                      **kw)
    ref = ref_stream_soak.run_stream_soak(str(tmp_path / "r"), **kw)
    assert set(got) == set(ref)
    assert got["ok"] and got["invalid"] is None
    for validate in (export.validate_run_record,
                     ref_export.validate_run_record):
        validate(got["record"])
        validate(ref["record"])
    assert got["record"]["streaming"]["chunks"] == \
        ref["record"]["streaming"]["chunks"]
    assert _tree(got["record"]["spans"]) == _tree(ref["record"]["spans"])
