"""The port's flight recorder (``obs.live``): the heartbeat stream, the
stall watchdog's stack dump, a refine() child killed by SIGTERM inside a
stage leaving a signal-stamped partial record that the port's and the
reference's validators take and the ledger ingests as partial, and the
torch.profiler capture window. The child is started with ``python -c``
from this file: the reference's ``tests/live_worker.py`` imports the
reference."""

import json
import os
import pathlib
import signal
import subprocess
import sys
import time

import pytest

from scconsensus_tpu.obs.export import validate_run_record as ref_validate
from scconsensus_tpu.obs.live import LiveRecorder as RefRecorder
from scconsensus_tpu_torch.obs import live
from scconsensus_tpu_torch.obs.export import (
    build_run_record,
    validate_run_record,
)
from scconsensus_tpu_torch.obs.ledger import (
    Ledger,
    is_partial_entry,
    is_partial_record,
)
from scconsensus_tpu_torch.obs.live import (
    LiveRecorder,
    heartbeat_path,
    partial_record_path,
    read_heartbeat_tail,
)
from scconsensus_tpu_torch.obs.trace import Tracer

REPO = pathlib.Path(__file__).resolve().parents[1]


def _stream_lines(path):
    return [json.loads(ln) for ln in
            pathlib.Path(path).read_text().strip().splitlines()]


class TestHeartbeatStream:
    def test_stream_carries_open_spans_rss_and_progress(self, tmp_path):
        rec = LiveRecorder(str(tmp_path / "run"), metric="t",
                           extra={"config": "quick", "platform": "cpu"},
                           heartbeat_s=0.05, stall_s=0.0).start(
                               install_signals=False)
        tr = Tracer(sync="off")
        with tr.span("stage_a"):
            with tr.span("inner", kind="detail") as sp:
                sp.metrics.counter("genes").add(7)
                time.sleep(0.3)
        rec.stop("clean")
        lines = _stream_lines(rec.hb_path)
        assert lines[0]["t"] == "header" and lines[0]["pid"] == os.getpid()
        assert lines[0]["key"]["dataset"] == "quick"
        assert lines[-1]["t"] == "end" and lines[-1]["cause"] == "clean"
        hbs = [ln for ln in lines if ln["t"] == "hb"]
        mid = next(ln for ln in hbs
                   if [s["name"] for s in ln["open_spans"]]
                   == ["stage_a", "inner"])
        assert mid["rss_bytes"] > 0 and mid["since_progress_s"] >= 0
        assert mid["metrics"]["inner.genes"] == 7.0
        # the keys a reader of the reference's stream finds
        assert {"ts", "seq", "up_s", "progress_unix", "spans_done",
                "stalls", "rss_peak_bytes"} <= set(mid)

    def test_disabled_recorder_writes_nothing(self, tmp_path):
        rec = LiveRecorder(str(tmp_path / "off"), heartbeat_s=0.0)
        rec.start(install_signals=False)
        assert not rec.enabled
        rec.stop("clean")
        assert not os.path.exists(rec.hb_path)
        assert not os.path.exists(rec.partial_path)

    def test_read_heartbeat_tail_skips_torn_final_line(self, tmp_path):
        p = tmp_path / "s_heartbeat.jsonl"
        p.write_text('{"t": "hb", "ts": 5.0, "seq": 1}\n{"t": "hb", "ts"')
        assert read_heartbeat_tail(str(p)) == {"t": "hb", "ts": 5.0,
                                               "seq": 1}
        assert read_heartbeat_tail(str(tmp_path / "missing.jsonl")) is None

    def test_paths_and_constants_are_the_references(self):
        import scconsensus_tpu.obs.live as ref_live

        assert heartbeat_path("b") == ref_live.heartbeat_path("b")
        assert partial_record_path("b") == ref_live.partial_record_path("b")
        assert (live.CAPTURE_WINDOW_S, live.FLUSH_EVERY_S) == (
            ref_live.CAPTURE_WINDOW_S, ref_live.FLUSH_EVERY_S)
        assert live.__all__ == ref_live.__all__
        a = LiveRecorder("x", heartbeat_s=1.0, stall_s=2.0)
        b = RefRecorder("x", heartbeat_s=1.0, stall_s=2.0)
        assert (a.hb_path, a.partial_path, a.flush_every_s, a.capture_s) \
            == (b.hb_path, b.partial_path, b.flush_every_s, b.capture_s)


class TestStallWatchdog:
    def test_stall_dumps_stacks_and_counts(self, tmp_path):
        rec = LiveRecorder(str(tmp_path / "run"), metric="stall test",
                           heartbeat_s=0.05, stall_s=0.25,
                           flush_every_s=0.2).start(install_signals=False)
        tr = Tracer(sync="off")
        with tr.span("wilcox_test"):
            time.sleep(0.8)  # no span transition for > stall_s
            mid = json.load(open(rec.partial_path))
        time.sleep(0.25)
        rec.stop("clean")
        assert rec.stall_count == 1
        lines = _stream_lines(rec.hb_path)
        (stall,) = [ln for ln in lines if ln["t"] == "stall"]
        assert "test_torch_obs_live" in stall["stack"]
        assert stall["open_spans"][-1]["name"] == "wilcox_test"
        assert stall["since_progress_s"] >= 0.25
        assert any(ln["t"] == "recovered" for ln in lines)
        for validate in (validate_run_record, ref_validate):
            validate(mid)
        assert mid["termination"]["cause"] == "stall"
        assert is_partial_record(mid)

    def test_stall_counter_in_termination_stamp(self, tmp_path):
        rec = LiveRecorder(str(tmp_path / "r"), heartbeat_s=0.04,
                           stall_s=0.15).start(install_signals=False)
        time.sleep(0.5)
        rec.stop("clean")
        final = json.load(open(rec.partial_path))
        assert final["termination"]["stall_count"] >= 1
        assert final["termination"]["cause"] == "clean"

    def test_stall_escalates_to_a_profiler_capture(self, tmp_path):
        cap = tmp_path / "cap"
        rec = LiveRecorder(str(tmp_path / "run"), heartbeat_s=0.05,
                           stall_s=0.15, capture_dir=str(cap),
                           capture_s=0.2).start(install_signals=False)
        # the capture thread starts torch.profiler (seconds on a loaded
        # host), records 0.2 s and exports
        deadline = time.time() + 20
        while time.time() < deadline and "capture-done" not in [
                ln["t"] for ln in _stream_lines(rec.hb_path)]:
            time.sleep(0.1)
        rec.stop("clean")
        kinds = [ln["t"] for ln in _stream_lines(rec.hb_path)]
        assert kinds.index("stall") < kinds.index("capture") \
            < kinds.index("capture-done"), kinds
        assert any(p.suffix == ".json" for p in cap.iterdir())


def test_the_stall_precedes_its_capture_with_a_warm_profiler(
        tmp_path, monkeypatch):
    """A profiler that starts at once, and a stall event slow to write:
    the capture thread still writes ``capture`` after the ``stall`` that
    triggered it."""
    monkeypatch.setattr(live, "_start_profiler", lambda d: object())
    monkeypatch.setattr(live, "_stop_profiler", lambda p, d: "none.json")
    rec = LiveRecorder(str(tmp_path / "run"), heartbeat_s=0.05,
                       stall_s=0.15, capture_dir=str(tmp_path / "cap"),
                       capture_s=0.01)
    emit = rec._emit

    def slow_stall(obj):
        if obj.get("t") == "stall":
            time.sleep(0.3)
        emit(obj)

    monkeypatch.setattr(rec, "_emit", slow_stall)
    rec.start(install_signals=False)
    deadline = time.time() + 20
    while time.time() < deadline and "capture-done" not in [
            ln["t"] for ln in _stream_lines(rec.hb_path)]:
        time.sleep(0.05)
    rec.stop("clean")
    kinds = [ln["t"] for ln in _stream_lines(rec.hb_path)]
    assert kinds.index("stall") < kinds.index("capture") \
        < kinds.index("capture-done"), kinds


# a refine() child held inside stage "tree" by a stall fault, under a
# recorder with a fast heartbeat
_CHILD = """
import sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
import scconsensus_tpu_torch as port
from scconsensus_tpu_torch.obs.live import LiveRecorder
from scconsensus_tpu_torch.utils.synthetic import noisy_labeling, synthetic_scrna

data, truth, _ = synthetic_scrna(n_genes=60, n_cells=150, n_clusters=2,
                                 n_markers_per_cluster=6, seed=5)
rec = LiveRecorder({base!r}, extra={{"config": "victim", "platform": "cpu"}},
                   heartbeat_s=0.05).start()
port.refine(data, noisy_labeling(truth, 0.05, seed=1),
            port.ReclusterConfig(), device="cpu")
rec.stop()
"""


def test_sigterm_inside_a_stage_leaves_a_signal_stamped_partial(tmp_path):
    base = str(tmp_path / "victim")
    plan = tmp_path / "stall.json"
    plan.write_text(json.dumps({"faults": [
        {"site": "stage:tree", "class": "stall", "stall_s": 20.0}]}))
    env = {k: v for k, v in os.environ.items() if not k.startswith("SCC_")}
    env["SCC_FAULT_PLAN"] = str(plan)
    proc = subprocess.Popen(
        [sys.executable, "-c", _CHILD.format(repo=str(REPO), base=base)],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    try:
        deadline = time.time() + 60
        while time.time() < deadline:
            tail = read_heartbeat_tail(heartbeat_path(base))
            if tail and tail.get("t") == "hb" and any(
                    s["name"] == "tree" for s in tail["open_spans"]):
                break
            time.sleep(0.05)
        else:
            pytest.fail("no heartbeat inside stage tree; stderr: "
                        f"{proc.stderr.read()[-800:]}")
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == -signal.SIGTERM
    partial = json.load(open(partial_record_path(base)))
    for validate in (validate_run_record, ref_validate):
        validate(partial)
    term = partial["termination"]
    assert term["cause"] == "signal" and term["last_span"] == "tree"
    assert [s["name"] for s in term["open_spans"]] == ["tree"]
    opens = [s for s in partial["spans"] if (s.get("attrs") or {}).get(
        "open")]
    assert [s["name"] for s in opens] == ["tree"]
    assert partial["extra"]["partial"] is True
    entry = Ledger(str(tmp_path / "evidence")).ingest(partial)
    assert entry["termination"] == "signal" and is_partial_entry(entry)


def test_validate_rejects_unknown_cause():
    rec = build_run_record("m", 1.0)
    rec["termination"] = {"cause": "gremlins", "last_span": None,
                          "open_spans": []}
    with pytest.raises(ValueError, match="termination.cause"):
        validate_run_record(rec)


def test_the_heartbeats_robustness_and_integrity_panels(monkeypatch):
    """The panels the recorder reads each tick: the robustness trail's
    and the integrity log's live summaries, the reference's on the same
    events."""
    import scconsensus_tpu.robust.integrity as ref_integrity
    import scconsensus_tpu.robust.record as ref_record
    from scconsensus_tpu_torch.robust import integrity, record

    for mod in (record, ref_record, integrity, ref_integrity):
        monkeypatch.setattr(mod, "_RUN", None)  # restored afterwards
    for mod in (record, ref_record):
        mod.begin_run()
        assert mod.live_summary() is None
        mod.note_fault("stage:tree", "transient", 1)
        mod.note_retry("stage:tree", "transient", 2, True, 0.05)
        mod.note_degradation("stage:embed", "evict-devcache")
    assert record.live_summary() == ref_record.live_summary()
    monkeypatch.setenv("SCC_INTEGRITY", "audit")
    for mod in (integrity, ref_integrity):
        mod.begin_run()
        assert mod.live_summary() is None
        mod.current().note_check("bh_monotone", "stage:de", True, 0.0, 1e-6)
    ours, ref = integrity.live_summary(), ref_integrity.live_summary()
    assert ours == ref and ours["checks_passed"] == 1
