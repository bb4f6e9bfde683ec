"""The port's robustness core and telemetry against the JAX package's, on
the CPU: the environment-flag registry, fault injection, the retry
classifier and policy, the robustness log and its validator, the serving
and SLO validators, the OpenMetrics exposition and the tracer.

Everything here is host code copied or translated from the reference, so
the tolerance is exact: the same input gives the same class, section,
text or verdict in both packages. The port adds the CUDA runtime's and
PyTorch's error text to the classifier; each such signature has a case,
and none changes the class of a string of the reference's own corpus."""

import copy
import json

import numpy as np
import pytest
import torch

import scconsensus_tpu.config as ref_config
from scconsensus_tpu.robust import faults as ref_faults
from scconsensus_tpu.robust import record as ref_record
from scconsensus_tpu.robust import retry as ref_retry
from scconsensus_tpu.serve import metrics as ref_metrics
from scconsensus_tpu.serve import slo as ref_slo
from scconsensus_tpu_torch import config as port_config
from scconsensus_tpu_torch.obs import trace
from scconsensus_tpu_torch.robust import faults, record, retry
from scconsensus_tpu_torch.serve import metrics, slo

PORT_FLAGS = sorted(port_config.ENV_FLAGS)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # the suite runs six workers on the machine's cores; two torch threads
    # a worker keep these small tensors from crowding out the other files
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_state(monkeypatch):
    """Millisecond backoffs, no plan, fresh logs in both packages."""
    monkeypatch.setenv("SCC_ROBUST_BACKOFF_S", "0.002")
    monkeypatch.delenv("SCC_FAULT_PLAN", raising=False)
    for mod in (faults, ref_faults):
        mod.reset()
    for mod in (record, ref_record):
        mod.begin_run()
    yield
    for mod in (faults, ref_faults):
        mod.reset()


def _plan(tmp_path, rules, monkeypatch):
    path = tmp_path / "plan.json"
    path.write_text(json.dumps({"faults": rules}))
    monkeypatch.setenv("SCC_FAULT_PLAN", str(path))
    faults.reset()
    ref_faults.reset()
    return str(path)


# --------------------------------------------------------------------------
# the environment-flag registry
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", PORT_FLAGS)
def test_flag_pinned_to_the_reference_registry(name):
    ours = port_config.ENV_FLAGS[name]
    ref = ref_config.ENV_FLAGS[name]
    assert (ours.name, ours.type, ours.default) == \
        (ref.name, ref.type, ref.default)
    assert ours.doc


def test_the_slice_registers_every_flag_it_reads():
    want = {n for n in ref_config.ENV_FLAGS
            if n.startswith(("SCC_SERVE_", "SCC_SLO_", "SCC_STREAM_",
                             "SCC_FLEET_", "SCC_LOADGEN_", "SCC_AUTOSCALE_"))}
    want |= {"SCC_FAULT_PLAN", "SCC_ROBUST_BUDGET", "SCC_ROBUST_BACKOFF_S",
             "SCC_INTEGRITY", "SCC_OBS_TRACE", "SCC_STAGE_SYNC",
             "SCC_TRACE_SYNC", "SCC_ROBUST_DE_CKPT",
             "SCC_INTEGRITY_TOL_SCALE", "SCC_INTEGRITY_EVICT_THRESHOLD",
             "SCC_OBS_NUMERIC", "SCC_ELASTIC", "SCC_ELASTIC_MIN_DEVICES"}
    # the run record's export and kernel capture, the landmark policy's
    # flags, the store's checksum switch, the observation flags of
    # refine(), the compile log's and the passports' flags, and the
    # reference's flags the port refuses while they are unported (none)
    want |= {"SCC_TRACE_DIR", "SCC_OBS_KERNELS", "SCC_TREE_EXACT",
             "SCC_TREE_LANDMARK_THRESHOLD", "SCC_TREE_LANDMARK_K",
             "SCC_TREE_LANDMARK_C", "SCC_ROBUST_CHECKSUM",
             "SCC_OBS_TRANSFERS", "SCC_OBS_RESIDENCY", "SCC_OBS_COST",
             "SCC_WILCOX_PROBE", "SCC_OBS_HEARTBEAT", "SCC_OBS_STALL_S",
             "SCC_OBS_STALL_TRACE", "SCC_HOSTPROF", "SCC_HOSTPROF_HZ",
             "SCC_EVIDENCE_DIR", "SCC_COMPILELOG",
             "SCC_COMPILELOG_MAX_EVENTS", "SCC_GRAPHS",
             "SCC_GRAPHS_MAX_PROGRAMS", *port_config.UNPORTED_FLAGS}
    assert set(PORT_FLAGS) == want


@pytest.mark.parametrize("raw", [None, "", "0", "false", "OFF", "no", "none",
                                 "1", "yes", " on "])
def test_env_flag_parses_as_the_reference(raw):
    env = {} if raw is None else {"SCC_OBS_TRACE": raw,
                                  "SCC_SERVE_MAX_BATCH": "64",
                                  "SCC_SLO_P99_MS": "12.5"}
    for name in ("SCC_OBS_TRACE", "SCC_SERVE_MAX_BATCH", "SCC_SLO_P99_MS",
                 "SCC_FAULT_PLAN"):
        assert port_config.env_flag(name, env) == \
            ref_config.env_flag(name, env)
    with pytest.raises(KeyError):
        port_config.env_flag("SCC_NOT_A_FLAG")


# --------------------------------------------------------------------------
# the classifier
# --------------------------------------------------------------------------

_REF_CORPUS = sorted(set(
    ref_retry._RESOURCE_PAT + ref_retry._TRANSIENT_PAT + ref_retry._DISK_PAT
    + ref_retry._SILENT_CORRUPTION_PAT + ref_retry._DEVICE_LOST_PAT))


@pytest.mark.parametrize("sig", _REF_CORPUS)
def test_every_reference_signature_classifies_as_the_reference(sig):
    for text in (sig, sig.upper(), f"XlaRuntimeError: {sig} at stage de",
                 f"RuntimeError: CUDA error: {sig}"):
        assert retry.classify_text(text) == ref_retry.classify_text(text)
    exc = RuntimeError(f"{sig} (while serving)")
    assert retry.classify_exception(exc) == ref_retry.classify_exception(exc)


@pytest.mark.parametrize("fclass", ["oom", "transient", "device_loss",
                                    "disk"])
def test_injected_fault_messages_classify_as_the_reference(
        tmp_path, monkeypatch, fclass):
    _plan(tmp_path, [{"site": "serve_device", "class": fclass}],
          monkeypatch)
    with pytest.raises(faults.InjectedFault) as ours:
        faults.fault_point("serve_device")
    with pytest.raises(ref_faults.InjectedFault) as ref:
        ref_faults.fault_point("serve_device")
    assert str(ours.value) == str(ref.value)
    assert type(ours.value).__name__ == type(ref.value).__name__
    assert retry.classify_exception(ours.value) == \
        ref_retry.classify_exception(ref.value)
    assert retry.classify_text(str(ours.value)) == \
        ref_retry.classify_text(str(ref.value))


@pytest.mark.parametrize("text,want", [
    ("CUDA out of memory. Tried to allocate 80.00 GiB. GPU 0 has a total "
     "capacity of 79.19 GiB of which 77.50 GiB is free.", "resource"),
    ("RuntimeError: CUDA error: CUBLAS_STATUS_ALLOC_FAILED when calling "
     "`cublasCreate(handle)`", "resource"),
    ("RuntimeError: CUDA error: an illegal memory access was encountered\n"
     "CUDA kernel errors might be asynchronously reported at some other "
     "API call", "device_lost"),
    ("RuntimeError: CUDA error: unspecified launch failure", "device_lost"),
    ("RuntimeError: CUDA error: device-side assert triggered",
     "device_lost"),
    ("RuntimeError: No CUDA GPUs are available", "device_lost"),
], ids=["cuda_oom", "cublas_alloc", "illegal_address", "launch_failure",
        "device_assert", "no_gpus"])
def test_cuda_runtime_text_classifies(text, want):
    assert retry.classify_text(text) == want
    assert retry.classify_exception(RuntimeError(text)) == want


def test_cuda_out_of_memory_type_is_resource_whatever_its_text():
    assert retry.classify_exception(
        torch.cuda.OutOfMemoryError("allocator refused")) == "resource"


@pytest.mark.parametrize("exc", [
    MemoryError(), ConnectionResetError(), TimeoutError("slow"),
    ValueError("bad labels"), OSError(28, "No space left on device"),
    OSError(5, "Input/output error"), OSError(2, "No such file"),
    RuntimeError("something else entirely"),
], ids=lambda e: type(e).__name__ + str(getattr(e, "errno", "") or ""))
def test_typed_exceptions_classify_as_the_reference(exc):
    assert retry.classify_exception(exc) == ref_retry.classify_exception(exc)


def test_resource_beats_transient_and_none_stays_none():
    for text in ("UNAVAILABLE after out of memory", "something else", None):
        assert retry.classify_text(text) == ref_retry.classify_text(text)


# --------------------------------------------------------------------------
# the retry policy
# --------------------------------------------------------------------------

def test_retry_fatal_raises_at_once():
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        raise ValueError("fatal by class")

    with pytest.raises(ValueError):
        retry.RetryPolicy(max_attempts=5).call(fn, site="t")
    assert calls["n"] == 1 and not record.current_run().retries


def test_retry_transient_recovers_and_records_as_the_reference():
    def flaky(mod):
        calls = {"n": 0}

        def fn():
            calls["n"] += 1
            if calls["n"] < 3:
                raise mod.InjectedTransientError("UNAVAILABLE: flaky")
            return "ok"
        return fn

    assert retry.RetryPolicy(max_attempts=3).call(
        flaky(faults), site="t") == "ok"
    assert ref_retry.RetryPolicy(max_attempts=3).call(
        flaky(ref_faults), site="t") == "ok"
    # the deterministic jitter is the reference's: the same entry
    assert record.current_run().retries == ref_record.current_run().retries
    assert record.section() == {**ref_record.section(),
                                "consumed_s": record.section()["consumed_s"]}


def test_retry_resource_runs_the_degrade_hook():
    seen = []

    def fn():
        if not seen:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return 1

    assert retry.RetryPolicy(max_attempts=2).call(
        fn, site="t", degrade=seen.append) == 1
    assert seen == [1]


def test_retry_device_lost_without_hook_is_fatal_and_with_hook_retries():
    def lost():
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    with pytest.raises(RuntimeError):
        retry.RetryPolicy(max_attempts=3).call(lost, site="t")
    hooks, calls = [], {"n": 0}

    def once():
        calls["n"] += 1
        if calls["n"] == 1:
            lost()
        return 2

    assert retry.RetryPolicy(max_attempts=3).call(
        once, site="t", on_device_loss=hooks.append) == 2
    assert hooks == [1]


def test_retry_budget_exhaustion_reraises(monkeypatch):
    monkeypatch.setenv("SCC_ROBUST_BUDGET", "1")
    record.begin_run()

    def fn():
        raise faults.InjectedTransientError("UNAVAILABLE: always")

    with pytest.raises(faults.InjectedTransientError):
        retry.RetryPolicy(max_attempts=10).call(fn, site="t")
    run = record.current_run()
    assert run.budget_used == 1 and run.retries[-1]["recovered"] is False


@pytest.mark.parametrize("attempt", [1, 2, 5])
def test_backoff_equals_the_reference(attempt):
    assert retry.RetryPolicy(backoff_base=0.1).backoff_s("site", attempt) == \
        ref_retry.RetryPolicy(backoff_base=0.1).backoff_s("site", attempt)


def test_retry_counts_on_the_enclosing_span():
    tr = trace.Tracer(sync="off")
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        if calls["n"] == 1:
            raise faults.InjectedTransientError("UNAVAILABLE")
        return 0

    with tr.span("stage_x") as sp:
        retry.call(fn, site="t")
    assert sp.metrics.to_dict()["robust_retries"]["value"] == 1
    assert [s.name for s in tr.spans] == ["robust_retry", "stage_x"]


# --------------------------------------------------------------------------
# fault injection
# --------------------------------------------------------------------------

def test_fault_window_is_deterministic(tmp_path, monkeypatch):
    _plan(tmp_path, [{"site": "serve_batch", "class": "transient",
                      "after": 1, "times": 2}], monkeypatch)
    faults.fault_point("serve_batch")
    for _ in range(2):
        with pytest.raises(faults.InjectedTransientError):
            faults.fault_point("serve_batch")
    faults.fault_point("serve_batch")
    faults.fault_point("serve_device")
    assert [f["seq"] for f in record.current_run().faults] == [1, 2]


def test_no_plan_is_inactive():
    assert not faults.active()
    faults.fault_point("serve_batch")
    assert faults.corrupt_value("serve_classify", 3) == 3


def test_malformed_plan_is_loud(tmp_path, monkeypatch):
    _plan(tmp_path, [{"site": "serve_batch", "class": "nonsense"}],
          monkeypatch)
    with pytest.raises(ValueError, match="class"):
        faults.fault_point("anything")


def test_stall_sleeps_and_records(tmp_path, monkeypatch):
    import time

    _plan(tmp_path, [{"site": "serve_batch", "class": "stall",
                      "stall_s": 0.05}], monkeypatch)
    t0 = time.perf_counter()
    faults.fault_point("serve_batch")
    assert time.perf_counter() - t0 >= 0.05
    assert record.current_run().faults[0]["class"] == "stall"


@pytest.mark.parametrize("mode", ["truncate", "flip"])
def test_corrupt_artifact_as_the_reference(tmp_path, monkeypatch, mode):
    _plan(tmp_path, [{"site": "artifact:m", "class": "corrupt",
                      "mode": mode}], monkeypatch)
    blob = bytes(range(256)) * 8
    ours, ref = tmp_path / "a.npz", tmp_path / "b.npz"
    for p in (ours, ref):
        p.write_bytes(blob)
    assert faults.corrupt_artifact("m", str(ours))
    assert ref_faults.corrupt_artifact("m", str(ref))
    assert ours.read_bytes() == ref.read_bytes() != blob
    assert not faults.corrupt_artifact("m", str(ours))  # window spent


@pytest.mark.parametrize("mode", ["scale", "signflip", "shift"])
def test_corrupt_value_as_the_reference(tmp_path, monkeypatch, mode):
    rules = [{"site": "serve_classify", "class": "corruption",
              "mode": mode, "times": 4}]
    _plan(tmp_path, rules, monkeypatch)
    rng = np.random.default_rng(3)
    vals = rng.normal(size=(5, 7)).astype(np.float32)
    labs = rng.integers(0, 9, size=11).astype(np.int64)
    for v in (vals, labs):
        want = ref_faults.corrupt_value("serve_classify", v.copy())
        got = faults.corrupt_value("serve_classify", v.copy())
        np.testing.assert_array_equal(got, np.asarray(want))
        # a tensor is perturbed where it lies, to the same values
        t = faults.corrupt_value("serve_classify", torch.from_numpy(v.copy()))
        assert isinstance(t, torch.Tensor)
        np.testing.assert_array_equal(t.numpy(), np.asarray(want))


def test_kill_class_sigkills_the_process(tmp_path):
    import os
    import signal
    import subprocess
    import sys

    plan = tmp_path / "kill.json"
    plan.write_text(json.dumps({"faults": [{"site": "serve_batch",
                                            "class": "kill"}]}))
    code = ("from scconsensus_tpu_torch.robust import faults\n"
            "faults.fault_point('serve_batch')\nprint('survived')\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         env={**os.environ, "SCC_FAULT_PLAN": str(plan)},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == -signal.SIGKILL
    assert "survived" not in out.stdout


_MESH_SITE_RULES = [
    ({"site": "refine_step", "class": "oom"},
     ref_faults.InjectedResourceExhausted, faults.InjectedResourceExhausted),
    ({"site": "sharded:ranksum", "class": "transient"},
     ref_faults.InjectedTransientError, faults.InjectedTransientError),
    ({"site": "sharded:aggregates", "class": "device_loss"},
     ref_faults.InjectedDeviceLoss, faults.InjectedDeviceLoss),
    ({"site": "ring:distance_sums", "class": "oom"},
     ref_faults.InjectedResourceExhausted, faults.InjectedResourceExhausted),
]


@pytest.mark.parametrize("rule,ref_exc,exc", _MESH_SITE_RULES,
                         ids=[f"{r['site']}-{r['class']}"
                              for r, _, _ in _MESH_SITE_RULES])
def test_a_plan_naming_a_mesh_site_fires_as_in_the_reference(
        tmp_path, monkeypatch, rule, ref_exc, exc):
    """The mesh engines' sites are the port's now: a plan naming one is
    read, and the site fires the rule's class, as in the reference."""
    _plan(tmp_path, [rule], monkeypatch)
    faults.fault_point("serve_batch")       # another site: no action
    ref_faults.fault_point("serve_batch")
    with pytest.raises(ref_exc):
        ref_faults.fault_point(rule["site"])
    with pytest.raises(exc):
        faults.fault_point(rule["site"])


@pytest.mark.parametrize("rule", [
    {"site": "ring:distance_sums", "class": "corruption"},
    {"site": "serve_device", "class": "corruption"},
], ids=lambda r: f"{r['site']}-{r['class']}")
def test_a_corruption_rule_at_a_site_with_no_value_hook_is_refused_where_the_reference_runs_a_no_op(
        tmp_path, monkeypatch, rule):
    # a stated difference: neither package corrupts a value at such a
    # site; the reference runs the plan and fires nothing, the port
    # refuses the plan as malformed, as the reference's loader refuses one
    _plan(tmp_path, [rule], monkeypatch)
    # the reference: fault_point skips the rule and records nothing, and
    # its code reads corruption rules only at the seven value sites
    assert ref_faults.fault_point(rule["site"]) is None
    assert ref_faults.fault_point("serve_batch") is None
    assert ref_record.section() is None
    assert _reference_value_sites() == set(faults._VALUE_SITES)
    assert rule["site"] not in _reference_value_sites()
    with pytest.raises(ValueError, match="neither package corrupts"):
        faults.fault_point("serve_batch")
    with pytest.raises(ValueError, match=rule["site"]):
        faults.corrupt_value(rule["site"], torch.zeros(3))


def _reference_value_sites() -> set:
    """The site names the reference's code hands ``corrupt_value``."""
    import pathlib
    import re

    import scconsensus_tpu

    root = pathlib.Path(scconsensus_tpu.__file__).parent
    pat = re.compile(r"corrupt_value\(\s*\"([^\"]+)\"")
    return {m for f in root.rglob("*.py") for m in pat.findall(f.read_text())}


# --------------------------------------------------------------------------
# the robustness log and its validator
# --------------------------------------------------------------------------

def _log_events(rec):
    rec.note_fault("serve_device", "oom", seq=0)
    rec.note_retry("serve_device", "resource", 2, recovered=True,
                   backoff_s=0.01234567)
    rec.note_degradation("serve_device", "host-fallback", "breaker open")
    rec.note_resume_point("de", "pairs", 3, 10)
    rec.note_mesh_transition("de", [0, 1, 2, 3], [0, 1], 1024)
    for _ in range(70):  # past the list cap
        rec.note_fault("serve_batch", "stall", seq=1)


def test_robustness_section_equals_the_reference():
    assert record.section() is None and ref_record.section() is None
    _log_events(record)
    _log_events(ref_record)
    ours, ref = record.section(), ref_record.section()
    assert ours == ref
    assert ours["events_dropped"] == 7 and ours["recovered"] is True
    with record.timed():
        pass
    assert record.current_run().consumed_s >= 0.0


def _robustness_cases():
    good = {"faults_injected": [{"site": "s", "class": "oom", "seq": 0}],
            "retries": [{"site": "s", "error_class": "resource",
                         "attempts": 2, "recovered": True}],
            "degradations": [{"site": "s", "action": "a"}],
            "resume_points": [], "recovered": True,
            "budget": {"limit": 16, "used": 1}}
    cases = {"good": good}

    def bad(name, fn):
        c = copy.deepcopy(good)
        fn(c)
        cases[name] = c

    bad("no_evidence", lambda c: c["retries"].clear())
    bad("bad_class", lambda c: c["faults_injected"][0].update(
        {"class": "boom"}))
    bad("bad_error_class", lambda c: c["retries"][0].update(
        {"error_class": "weird"}))
    bad("zero_attempts", lambda c: c["retries"][0].update({"attempts": 0}))
    bad("growing_mesh", lambda c: c.update({"mesh_transitions": [
        {"stage": "de", "from_devices": [0], "to_devices": [0, 1]}]}))
    bad("shrinking_mesh", lambda c: c.update({"mesh_transitions": [
        {"stage": "de", "from_devices": [0, 1], "to_devices": [0]}]}))
    bad("resume_over_total", lambda c: c["resume_points"].append(
        {"stage": "de", "completed": 5, "total": 3}))
    bad("bad_budget", lambda c: c.update({"budget": {"limit": -1,
                                                     "used": 0}}))
    bad("degradation_without_action", lambda c: c["degradations"][0].pop(
        "action"))
    return cases


_ROB = _robustness_cases()


def _verdict(fn, section):
    try:
        fn(copy.deepcopy(section))
    except ValueError as e:
        return str(e)
    return "ok"


@pytest.mark.parametrize("case", sorted(_ROB))
def test_validate_robustness_verdicts_equal_the_reference(case):
    assert _verdict(record.validate_robustness, _ROB[case]) == \
        _verdict(ref_record.validate_robustness, _ROB[case])


# --------------------------------------------------------------------------
# the serving section, the SLO section and the exposition
# --------------------------------------------------------------------------

def _stats(mod):
    st = mod.ServingStats(queue_capacity=8)
    for i, (outcome, ms) in enumerate([("ok", 3.0), ("ok", 12.0),
                                       ("degraded", 30.0),
                                       ("quarantined", 7.0),
                                       ("rejected_queue", None),
                                       ("failed", 600.0)]):
        st.note_submit(i % 3)
        st.note_outcome(outcome, None if ms is None else ms / 1e3,
                        trace_id=f"t{i}")
    st.note_batch(2, 40)
    st.note_breaker("open", tripped=True)
    st.note_drift_batch(quarantined=1)
    st.note_stage_latency("queue_wait", 0.002)
    st.note_stage_latency("compute", 0.004)
    return st


def test_serving_section_equals_the_reference():
    ours, ref = _stats(metrics).section(), _stats(ref_metrics).section()
    for sec in (ours, ref):
        for key in ("window_s", "throughput_rps"):
            sec.pop(key)
    assert ours == ref
    metrics.validate_serving(_stats(metrics).section())


def _serving_cases():
    st = _stats(ref_metrics)
    good = st.section()
    cases = {"good": good}

    def bad(name, fn):
        c = copy.deepcopy(good)
        fn(c)
        cases[name] = c

    bad("accounting", lambda c: c["requests"].update({"submitted": 99}))
    bad("ordering", lambda c: c["latency_ms"].update({"p50": 1e6}))
    bad("degraded_without_trip", lambda c: c["breaker"].update(
        {"trips": 0}))
    bad("quarantine_without_drift", lambda c: c["drift"].update(
        {"batches_flagged": 0}))
    bad("unbounded_queue", lambda c: c["queue"].update({"capacity": 0}))
    bad("breaker_state", lambda c: c["breaker"].update({"state": "ajar"}))
    bad("wire_accounting", lambda c: c.update({"wire": {
        "requests": {"submitted": 2, "ok": 1}, "status_codes": {"200": 1}}}))
    bad("wire_codes", lambda c: c.update({"wire": {
        "requests": {"submitted": 1, "ok": 1}, "status_codes": {}}}))
    bad("fleet_owners", lambda c: c.update({"fleet": {
        "replicas": 2, "active_fp": "ab", "live_replicas": 0,
        "per_replica": [], "submitted_by_owner": {"replicas": 1}}}))
    bad("fleet_good", lambda c: c.update({"fleet": {
        "replicas": 1, "active_fp": "ab", "live_replicas": 0,
        "per_replica": [],
        "submitted_by_owner": {"replicas": c["requests"]["submitted"]}}}))
    return cases


_SERV = _serving_cases()


@pytest.mark.parametrize("case", sorted(_SERV))
def test_validate_serving_verdicts_equal_the_reference(case):
    assert _verdict(metrics.validate_serving, _SERV[case]) == \
        _verdict(ref_metrics.validate_serving, _SERV[case])


def _snapshot():
    snap = _stats(ref_metrics).expo_snapshot()
    slo_sec = ref_slo.build_slo_section(
        snap["counts"], 25.0, snap["window_deltas"],
        latency_hist=snap["latency_hist"], stage_hist=snap["stage_hist"],
        obs_overhead={"on_ms": 1.0, "off_ms": 0.9, "ratio": 1.11})
    scope = {"labels": {"replica": "0", "model": 'fp"x\\y'}, **snap}
    return {"scopes": [scope], "wire": {"counts": snap["counts"]},
            "slo": slo_sec}


def test_openmetrics_render_and_parse_equal_the_reference():
    snap = _snapshot()
    text = slo.render_openmetrics(copy.deepcopy(snap))
    assert text == ref_slo.render_openmetrics(copy.deepcopy(snap))
    assert slo.parse_openmetrics(text) == ref_slo.parse_openmetrics(text)
    for broken in (text.replace("# EOF\n", ""), text + "x 1\n",
                   text.replace('outcome="ok"}', 'outcome=ok}', 1)):
        with pytest.raises(ValueError) as ours:
            slo.parse_openmetrics(broken)
        with pytest.raises(ValueError) as ref:
            ref_slo.parse_openmetrics(broken)
        assert str(ours.value) == str(ref.value)


def test_slo_section_and_its_validator_equal_the_reference():
    snap = _stats(metrics).expo_snapshot()
    kw = dict(latency_hist=snap["latency_hist"],
              stage_hist=snap["stage_hist"])
    ours = slo.build_slo_section(snap["counts"], 25.0,
                                 snap["window_deltas"], **kw)
    ref = ref_slo.build_slo_section(snap["counts"], 25.0,
                                    snap["window_deltas"], **kw)
    assert ours == ref
    slo.validate_slo(ours)
    slo.validate_slo(_stats(metrics).slo_section())
    broken = copy.deepcopy(ours)
    broken["availability"]["good"] += 1
    assert _verdict(slo.validate_slo, broken) == \
        _verdict(ref_slo.validate_slo, broken) != "ok"
    h = slo.LatencyHistogram()
    for ms in (0.5, 3.0, 3.0, 20000.0):
        h.observe(ms)
    r = ref_slo.LatencyHistogram()
    for ms in (0.5, 3.0, 3.0, 20000.0):
        r.observe(ms)
    assert h.to_dict() == r.to_dict()


def test_live_summary_reads_the_active_stats():
    assert metrics.live_summary() is None
    st = _stats(metrics)
    metrics.set_active(st)
    try:
        live = metrics.live_summary()
    finally:
        metrics.set_active(None)
    ref = _stats(ref_metrics)
    ref_metrics.set_active(ref)
    try:
        want = ref_metrics.live_summary()
    finally:
        ref_metrics.set_active(None)
    for d in (live, want):
        for r in d.get("recent", []):
            r.pop("ts")
    assert live == want


# --------------------------------------------------------------------------
# the tracer
# --------------------------------------------------------------------------

def test_tracer_nests_spans_and_back_dates_completed_ones():
    tr = trace.Tracer(sync="all")
    with tr.span("stage_a", n=3) as a:
        a.attrs["extra"] = 1
        with trace.span("detail_b") as b:
            tr.add_completed_span("serve_request", wall_s=0.01,
                                  outcome="ok")
    names = [s.name for s in tr.spans]
    assert names == ["serve_request", "detail_b", "stage_a"]
    rec = {s.name: s.record() for s in tr.spans}
    assert rec["detail_b"]["parent_id"] == a.span_id
    assert rec["serve_request"]["parent_id"] == b.span_id
    assert rec["stage_a"]["attrs"] == {"n": 3, "extra": 1}
    assert rec["stage_a"]["kind"] == "stage"
    assert rec["detail_b"]["kind"] == "detail"
    assert trace.last_tracer() is tr
    # nothing queued on a card in this process: the drain is a no-op
    assert rec["stage_a"]["synced"] is torch.cuda.is_initialized()
    with trace.span("no_tracer_here") as sp:
        sp.attrs["x"] = 1  # the null sink takes attrs and records nothing
    assert "no_tracer_here" not in [s.name for s in tr.spans]


def test_trace_ids_are_unique_hex_with_one_process_prefix():
    ids = [trace.new_trace_id() for _ in range(100)]
    assert len(set(ids)) == 100
    assert all(len(i) == 16 and int(i, 16) >= 0 for i in ids)
    assert len({i[:8] for i in ids}) == 1
