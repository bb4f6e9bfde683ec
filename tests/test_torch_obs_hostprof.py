"""The port's host profiler (``obs.hostprof``): the classifier's torch
sync points and native builds, the pure section builders pinned to the
reference's on the same samples, the validators, the live sampler, the
``SCC_HOSTPROF`` gate, and ``refine()``'s sections passing the
reference's validators."""

import gc
import sys
import time

import pytest
import torch

import scconsensus_tpu.obs.hostprof as ref_hostprof
import scconsensus_tpu_torch as port
from scconsensus_tpu_torch import ReclusterConfig
from scconsensus_tpu_torch.obs import hostprof
from scconsensus_tpu_torch.obs.hostprof import (
    OUTSIDE_SPANS,
    HostProfiler,
    build_host_profile,
    build_memory_timeline,
    classify_stack,
    validate_host_profile,
    validate_memory_timeline,
)
from scconsensus_tpu_torch.obs.trace import Tracer
from scconsensus_tpu_torch.utils.synthetic import (
    noisy_labeling,
    synthetic_scrna,
)


class TestClassifyStack:
    def test_none_frame_is_python_without_frame(self):
        assert classify_stack(None) == ("python", None)

    def test_plain_python_frame_named(self):
        cat, top = classify_stack(sys._getframe())
        assert cat == "python"
        assert "test_torch_obs_hostprof.py:test_plain_python_frame_named:" \
            in top

    @pytest.mark.parametrize("waiter", ["device_drain", "synchronize",
                                        "_sync", "_fetch", "fetched",
                                        "moved"])
    def test_the_ports_sync_points_are_blocking_waits(self, waiter):
        def leaf():
            return classify_stack(sys._getframe())

        ns = {"leaf": leaf}
        exec(f"def {waiter}():\n    return leaf()", ns)
        cat, top = ns[waiter]()
        assert cat == "blocking_wait" and ":leaf:" in top

    def test_a_native_build_is_compile(self):
        from scconsensus_tpu_torch.ops import cuda_kernels

        code = compile("def build():\n    return probe()",
                       cuda_kernels.__file__, "exec")
        ns = {"probe": lambda: classify_stack(sys._getframe())}
        exec(code, ns)
        assert ns["build"]()[0] == "compile"


HOST_CASES = {
    "stages-and-causes": dict(samples=[
        (0.02, "consensus", "python", "a.py:f:1"),
        (0.04, "consensus", "python", "a.py:f:1"),
        (0.06, "consensus", "blocking_wait", None),
        (0.08, None, "python", "b.py:g:2")], period_s=0.02),
    "empty": dict(samples=[], period_s=0.02),
    "gc-outside": dict(samples=[], gc={"collections": 3, "by_stage": {
        None: {"pauses": 3, "pause_s": 0.5}}}, period_s=0.02),
    "gc-on-stage": dict(samples=[(0.02, "de", "python", None)],
                        gc={"collections": 1, "by_stage": {
                            "de": {"pauses": 1, "pause_s": 0.1}}},
                        period_s=0.02),
    "unknown-category": dict(samples=[(0.02, "s", "martian", None)]),
    "top-frames": dict(samples=[(0.01 * i, "t", "python", f"f{i % 7}")
                                for i in range(40)], top_frames=3,
                       sampler_self_s=0.004),
}


@pytest.mark.parametrize("case", HOST_CASES)
def test_build_host_profile_equals_the_reference(case):
    got = build_host_profile(**HOST_CASES[case])
    assert got == ref_hostprof.build_host_profile(**HOST_CASES[case])
    validate_host_profile(got)
    ref_hostprof.validate_host_profile(got)


MEM_CASES = {
    "empty": dict(mem_samples=[]),
    "no-rss": dict(mem_samples=[(0.1, None, None, None)]),
    "peaks-and-deltas": dict(mem_samples=[
        (0.0, 100, None, None), (0.1, 300, 7, "de"),
        (0.2, 200, None, "de"), (0.3, 150, None, None)], period_s=0.1),
    "downsampled": dict(mem_samples=[(i * 0.01, 100 + i, None, None)
                                     for i in range(1000)],
                        period_s=0.01, max_points=50),
    "unordered": dict(mem_samples=[(0.2, 5, None, None),
                                   (0.1, 9, None, None)]),
}


@pytest.mark.parametrize("case", MEM_CASES)
def test_build_memory_timeline_equals_the_reference(case):
    got = build_memory_timeline(**MEM_CASES[case])
    assert got == ref_hostprof.build_memory_timeline(**MEM_CASES[case])
    if got is not None:
        validate_memory_timeline(got)
        ref_hostprof.validate_memory_timeline(got)


@pytest.mark.parametrize("section,mutate,match", [
    ("host", lambda s: s.__setitem__("n_samples", 5), "sum"),
    ("host", lambda s: s["stages"]["de"]["causes"].__setitem__(
        "python", -1.0), "causes"),
    ("host", lambda s: s.__setitem__("version", 2), "version"),
    ("mem", lambda s: s.__setitem__("rss_peak_bytes", 1), "peak"),
    ("mem", lambda s: s["samples"].reverse(), "ordered"),
])
def test_corrupt_sections_rejected_like_the_reference(section, mutate,
                                                      match):
    if section == "host":
        sec = build_host_profile([(0.02, "de", "python", "a.py:f:1")])
        checks = (validate_host_profile, ref_hostprof.validate_host_profile)
    else:
        sec = build_memory_timeline([(0.0, 100, None, None),
                                     (0.1, 200, None, "de")])
        checks = (validate_memory_timeline,
                  ref_hostprof.validate_memory_timeline)
    mutate(sec)
    for validate in checks:
        with pytest.raises(ValueError, match=match):
            validate(sec)


def test_constants_are_the_references():
    assert (hostprof.HOSTPROF_VERSION, hostprof.OUTSIDE_SPANS,
            hostprof.CATEGORIES) == (ref_hostprof.HOSTPROF_VERSION,
                                     ref_hostprof.OUTSIDE_SPANS,
                                     ref_hostprof.CATEGORIES)
    assert hostprof.__all__ == ref_hostprof.__all__


class TestHostProfilerLive:
    def test_samples_stage_gc_and_memory(self):
        prof = HostProfiler(period_s=0.005)
        tr = Tracer(sync="off")
        prof.start()
        try:
            with tr.span("busy_stage"):
                t0 = time.perf_counter()
                x = 0.0
                while time.perf_counter() - t0 < 0.2:
                    x += sum(i * i for i in range(500))
                gc.collect()
        finally:
            prof.stop()
        secs = prof.sections()
        hp = secs["host_profile"]
        validate_host_profile(hp)
        assert hp["n_samples"] >= 5 and "busy_stage" in hp["stages"]
        assert hp["stages"]["busy_stage"]["causes"]["python"] > 0
        assert hp["gc"]["collections"] >= 1
        validate_memory_timeline(secs["memory_timeline"])
        assert secs["memory_timeline"]["rss_peak_bytes"] > 0

    def test_sections_safe_while_running(self):
        prof = HostProfiler(period_s=0.005).start()
        try:
            time.sleep(0.05)
            validate_host_profile(prof.sections()["host_profile"])
        finally:
            prof.stop()

    def test_a_collection_inside_the_locked_region_finishes(self):
        """A collection can start in a thread that holds the profiler's
        lock (an allocation inside ``_tick`` or ``sections``): its
        callback must not wait on that lock. Run in a daemon thread so
        that a deadlock fails, not hangs."""
        import threading

        prof = HostProfiler(period_s=0.01)
        gc.callbacks.append(prof._on_gc)
        done = threading.Event()

        def body():
            with prof._lock:
                gc.collect()
            done.set()

        try:
            threading.Thread(target=body, daemon=True).start()
            finished = done.wait(timeout=30)
        finally:
            gc.callbacks.remove(prof._on_gc)
        assert finished, "the gc callback deadlocked on the profiler lock"
        if not prof._lock.acquire(timeout=5):
            pytest.fail("the profiler lock is still held")
        prof._lock.release()
        assert prof.sections()["host_profile"]["gc"]["collections"] >= 1

    def test_a_collection_inside_the_tracers_locked_region_finishes(self):
        """The callback names the open stage through ``ambient_stage``. A
        collection can start in a thread that holds the tracer's lock (a
        span's exit, or the sampler reading the stage): the callback must
        not wait on that lock, and still names the stage."""
        import threading

        prof = HostProfiler(period_s=0.01)
        tr = Tracer(sync="off")
        gc.callbacks.append(prof._on_gc)
        done = threading.Event()
        stages = []

        def body():
            with tr.span("locked_stage"):
                with tr._lock:
                    gc.collect()
                stages.extend(s for s, _ in prof._gc_pauses)
            done.set()

        try:
            threading.Thread(target=body, daemon=True).start()
            finished = done.wait(timeout=30)
        finally:
            gc.callbacks.remove(prof._on_gc)
        assert finished, "the gc callback deadlocked on the tracer lock"
        if not tr._lock.acquire(timeout=5):
            pytest.fail("the tracer lock is still held")
        tr._lock.release()
        assert "locked_stage" in stages

    def test_stop_removes_gc_callback(self):
        prof = HostProfiler(period_s=0.01).start()
        assert prof._on_gc in gc.callbacks
        prof.stop()
        assert prof._on_gc not in gc.callbacks


class TestEnvGate:
    def test_disabled_by_default(self, monkeypatch):
        monkeypatch.delenv("SCC_HOSTPROF", raising=False)
        monkeypatch.setitem(hostprof._ACTIVE, "prof", None)
        assert hostprof.start_if_enabled() is None
        assert hostprof.active_profiler() is None

    def test_enabled_starts_and_stop_active_clears(self, monkeypatch):
        monkeypatch.setenv("SCC_HOSTPROF", "1")
        monkeypatch.setenv("SCC_HOSTPROF_HZ", "100")
        monkeypatch.setitem(hostprof._ACTIVE, "prof", None)
        prof = hostprof.start_if_enabled()
        try:
            assert prof.period_s == pytest.approx(0.01)
            assert hostprof.start_if_enabled() is prof
        finally:
            hostprof.stop_active()
        assert hostprof.active_profiler() is None

    def test_refine_arms_and_stops_it(self, monkeypatch):
        monkeypatch.setenv("SCC_HOSTPROF", "1")
        monkeypatch.setenv("SCC_HOSTPROF_HZ", "200")
        monkeypatch.setitem(hostprof._ACTIVE, "prof", None)
        torch.set_num_threads(2)
        data, truth, _ = synthetic_scrna(n_genes=60, n_cells=150,
                                         n_clusters=2,
                                         n_markers_per_cluster=6, seed=5)
        res = port.refine(data, noisy_labeling(truth, 0.05, seed=1),
                          ReclusterConfig(), device="cpu")
        assert hostprof.active_profiler() is None
        hp, mt = res.metrics["host_profile"], res.metrics["memory_timeline"]
        ref_hostprof.validate_host_profile(hp)
        ref_hostprof.validate_memory_timeline(mt)
        assert set(hp["stages"]) <= {OUTSIDE_SPANS, *(
            s["name"] for s in res.metrics["spans"])}
