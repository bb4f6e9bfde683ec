"""The port's compile log (``obs.compilelog`` over ``obs.device``'s event
stream), held against the reference's: the section builder, the
validator and the event classifier give equal outputs and equal refusals
on the same synthetic event streams; a real ``build()`` cache hit and a
simulated nvcc build land in the stage and entry ordinal that loaded
them. The sections are pure functions of the events, so every comparison
is exact."""

import copy
import subprocess

import pytest

import scconsensus_tpu.obs.compilelog as ref_compilelog
from scconsensus_tpu.obs.export import validate_run_record as ref_validate
from scconsensus_tpu_torch.obs import compilelog, export
from scconsensus_tpu_torch.obs import device as obs_device
from scconsensus_tpu_torch.obs.hostprof import OUTSIDE_SPANS
from scconsensus_tpu_torch.obs.trace import Tracer
from scconsensus_tpu_torch.ops import cuda_kernels

# event streams of both packages' spellings: the reference's jax events
# (traces, retraces, compiles) and the port's native builds
STREAMS = {
    "empty": ([], 0),
    "legacy-pairs": ([("pjit_compile", 0.01)], 0),
    "jax-retrace": ([
        ("/jax/core/compile/jaxpr_trace_duration", 0.05, "de", 1),
        ("/jax/core/compile/backend_compile_duration", 0.10, "de", 1),
        ("/jax/core/compile/jaxpr_trace_duration", 0.08, "de", 2),
        ("/jax/core/compile/backend_compile_duration", 0.12, "de", 2),
        ("/jax/core/compile/jaxpr_trace_duration", 0.02, None, 1),
    ], 3),
    "native-cold": ([
        ("scc/native/cuda_backend_compile", 41.25, None, 0),
        ("scc/native/ward_backend_compile", 3.5, None, 0),
    ], 0),
    "native-in-stages": ([
        ("scc/native/cuda_backend_compile", 12.0, "silhouette", 1),
        ("scc/native/ward_backend_compile", 2.0, "tree", 2),
    ], 2),
}


@pytest.mark.parametrize("stream", STREAMS)
def test_build_compile_section_equals_the_reference(stream):
    events, hits = STREAMS[stream]
    got = compilelog.build_compile_section(events, cache_hits=hits)
    assert got == ref_compilelog.build_compile_section(events,
                                                       cache_hits=hits)
    compilelog.validate_compile(got)
    ref_compilelog.validate_compile(got)
    rec = export.build_run_record("x", 1, compile=got)
    export.validate_run_record(rec)
    ref_validate(rec)


def test_native_builds_are_backend_compiles():
    sec = compilelog.build_compile_section(STREAMS["native-cold"][0])
    assert (sec["events"], sec["compiles"], sec["traces"]) == (2, 2, 0)
    assert sec["by_stage"][OUTSIDE_SPANS]["compiles"] == 2
    assert sorted(sec["by_event"]) == ["scc_native_cuda_backend_compile",
                                       "scc_native_ward_backend_compile"]


@pytest.mark.parametrize("name", [
    "/jax/core/compile/backend_compile_duration", "Backend-Compile Duration",
    "backendCompile_duration", "/jax/core/compile/jaxpr_trace_duration",
    "Jaxpr TRACE duration", "/jax/core/compile/something_else",
    "scc/native/cuda_backend_compile", "scc/native/ward_compile_cache_hit"])
def test_event_kind_equals_the_reference(name):
    assert compilelog.event_kind(name) == ref_compilelog.event_kind(name)


# (field, value) corruptions each validator must refuse, with the same
# message
BREAKAGES = [("version", 2), ("events", -1), ("retraces", 9),
             ("events", 7), ("compile_wall_s", -1.0), ("by_event", [])]


@pytest.mark.parametrize("field,value", BREAKAGES)
def test_both_validators_refuse_the_same_sections(field, value):
    sec = compilelog.build_compile_section(
        [("/jax/core/compile/jaxpr_trace_duration", 0.05, "de", 2)])
    sec[field] = value
    msgs = []
    for validate in (compilelog.validate_compile,
                     ref_compilelog.validate_compile):
        with pytest.raises(ValueError) as ei:
            validate(copy.deepcopy(sec))
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_a_null_section_is_refused_by_both():
    rec = export.build_run_record("x", 1)
    rec["compile"] = None
    for validate in (export.validate_run_record, ref_validate):
        with pytest.raises(ValueError, match="omitted when absent"):
            validate(rec)


# --------------------------------------------------------------------------
# the runtime: arm, mark, snapshot
# --------------------------------------------------------------------------

@pytest.fixture
def disarmed(monkeypatch):
    monkeypatch.setitem(compilelog._STATE, "armed", False)
    monkeypatch.setitem(compilelog._STATE, "dur_mark", 0)
    monkeypatch.setitem(compilelog._STATE, "cache_mark", 0)


def test_snapshot_none_when_never_armed(disarmed):
    assert compilelog.snapshot() is None


def test_env_gate_respected(disarmed, monkeypatch):
    monkeypatch.delenv("SCC_COMPILELOG", raising=False)
    assert compilelog.install_and_mark() is False
    assert compilelog.armed() is False
    monkeypatch.setenv("SCC_COMPILELOG", "1")
    assert compilelog.install_and_mark() is True
    assert compilelog.armed() is True


def test_armed_with_nothing_built_is_a_section_of_zeros(disarmed):
    assert compilelog.install_and_mark(force=True) is True
    sec = compilelog.snapshot()
    assert sec == ref_compilelog.build_compile_section([])
    compilelog.validate_compile(sec)


def test_explicit_marks_scope_the_window(disarmed):
    obs_device.install_compile_listener()
    with obs_device._COMPILE_LOCK:
        n0 = len(obs_device._COMPILE_EVENTS)
        obs_device._COMPILE_EVENTS.append(("pjit_compile", 0.5))
    try:
        sec = compilelog.snapshot(dur_mark=n0, cache_mark=0)
        assert sec["events"] == 1
        assert sec["compile_wall_s"] == pytest.approx(0.5)
    finally:
        with obs_device._COMPILE_LOCK:
            del obs_device._COMPILE_EVENTS[n0:n0 + 1]


def test_a_real_ward_cache_hit_lands_in_its_stage_and_ordinal(disarmed):
    """The Ward library is built (or found built) once; a second
    ``build()`` inside the second entry of stage ``tree`` is a cache hit
    stamped ("tree", 2), and compiles nothing."""
    from scconsensus_tpu_torch.native import build as build_ward

    build_ward()  # built here if this host has no build yet
    assert compilelog.install_and_mark(force=True)
    tr = Tracer(sync="off")
    with tr.span("tree", kind="stage"):
        pass
    with tr.span("tree", kind="stage"):
        _, secs = build_ward()
    assert secs == 0.0
    hits = obs_device.cache_events(since=compilelog._STATE["cache_mark"])
    assert hits == [("scc/native/ward_compile_cache_hit", "tree", 2)]
    sec = compilelog.snapshot()
    assert (sec["events"], sec["compiles"], sec["cache_hits"]) == (0, 0, 1)
    assert tr.compile_stats() == {"events": 0, "total_s": 0.0,
                                  "by_event": {}}


def test_a_simulated_nvcc_build_lands_in_its_stage(disarmed, monkeypatch,
                                                   tmp_path):
    """``ops.cuda_kernels.build()`` with nvcc stood in for by a writer of
    the output file: the build is a ``backend`` compile event of its
    seconds, in the stage that asked for it, counted by the tracer's
    compile stats and by the section."""
    so = str(tmp_path / "libscc_cuda-test.so")
    monkeypatch.setattr(cuda_kernels, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_kernels, "_so_path", lambda: so)
    monkeypatch.setattr(cuda_kernels, "_nvcc", lambda: "nvcc")

    def fake_nvcc(argv, **kw):
        with open(argv[-1], "wb") as f:
            f.write(b"\0")
        return subprocess.CompletedProcess(argv, 0, "", "")

    monkeypatch.setattr(cuda_kernels.subprocess, "run", fake_nvcc)
    assert compilelog.install_and_mark(force=True)
    tr = Tracer(sync="off")
    with tr.span("silhouette", kind="stage"):
        path, secs, _ = cuda_kernels.build()
    assert path == so and secs > 0
    evs = obs_device.compile_events(since=compilelog._STATE["dur_mark"])
    assert evs == [("scc/native/cuda_backend_compile", secs, "silhouette",
                    1)]
    # found built: a cache hit, outside any span
    assert cuda_kernels.build() == (so, 0.0, "")
    sec = compilelog.snapshot()
    assert sec == ref_compilelog.build_compile_section(evs, cache_hits=1)
    assert sec["by_stage"]["silhouette"]["compiles"] == 1
    stats = tr.compile_stats()
    assert stats["events"] == 1 and stats["total_s"] == round(secs, 4)
    rec = export.build_run_record("x", 1, tracer=tr, compile=sec)
    export.validate_run_record(rec)
    ref_validate(rec)
    assert rec["device"]["compile"] == stats
