"""Live flight recorder: heartbeats, stall stack-dumps, partial run records.

The port's form of ``scconsensus_tpu/obs/live.py``. A run that stalls or
is killed must still leave evidence, so the recorder keeps three things
going beside the run:

  * **Heartbeat stream** — a daemon sampler thread appends one JSONL line
    per tick (``SCC_OBS_HEARTBEAT`` seconds; default off) to a sibling
    ``<base>_heartbeat.jsonl``: the open-span stack with elapsed walls,
    counter/gauge snapshots of the open spans, host RSS and the card's
    ``memory_snapshot()``, the quality, residency, robustness, streaming,
    integrity and serving panels where those layers are live, and the
    recorder's own ``progress_unix``. Appends are line-granular
    (crash-safe: a SIGKILL can truncate at most the line being written).

  * **Stall watchdog** — with ``SCC_OBS_STALL_S`` set, a tick that sees no
    span transition for the whole window dumps all-thread stacks via
    ``faulthandler`` into the stream as a ``stall`` event, increments the
    stall counter, and — when ``SCC_OBS_STALL_TRACE`` names a directory —
    escalates to an on-demand ``torch.profiler`` capture window (CPU and,
    with a card, CUDA activity; its Chrome trace is exported into that
    directory). SIGUSR1 requests the same capture on a live run at any
    time. Starting the profiler is not free (CUPTI's set-up takes seconds
    on the card), so a capture window shows up in the run it watches.

  * **Incremental run-record flushing** — the recorder periodically (and
    on SIGTERM / atexit) writes a schema-valid partial record to
    ``<base>_partial.json`` stamped ``termination: {cause, last_span,
    open_spans, ...}``. The periodic stamp is ``cause="crash"`` on
    purpose: the on-disk file always describes what it would mean if it
    turned out to be the last evidence. SIGTERM rewrites it as
    ``"signal"``, a fired watchdog as ``"stall"``, and a clean
    :meth:`LiveRecorder.stop` as ``"clean"``. ``obs.ledger`` ingests
    partial records (the entry carries the cause).

The sampler thread keeps ticking while the run thread is blocked inside a
device wait (the C++ wait releases the GIL), so the stream shows a live
process with a frozen ``progress_unix`` and the exact span it froze in.
The port compiles no XLA program; its compile events (the native
libraries' builds, ``obs.device``) do not count as progress, and the
heartbeat carries no ``compile`` panel.
"""

from __future__ import annotations

import atexit
import faulthandler
import json
import os
import signal
import sys
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from scconsensus_tpu_torch.config import env_flag
from scconsensus_tpu_torch.obs import trace as obs_trace
from scconsensus_tpu_torch.obs.export import (
    TERMINATION_CAUSES,
    build_run_record,
    write_json_atomic,
)
# stdlib-only by contract (like robust.record): imported at module level
# so the sampler's per-tick streaming-panel check is one attribute read,
# not per-tick import machinery under a contended GIL
from scconsensus_tpu_torch.stream import record as stream_record

__all__ = [
    "LiveRecorder",
    "active_recorder",
    "flush_active",
    "heartbeat_path",
    "partial_record_path",
    "read_heartbeat_tail",
    "dump_all_stacks",
]

_LOCK = threading.Lock()
_ACTIVE: "Optional[LiveRecorder]" = None

# Default seconds of profiler capture per stall/SIGUSR1 escalation.
CAPTURE_WINDOW_S = 15.0
# Partial-record flush cadence (seconds) when heartbeats are faster.
FLUSH_EVERY_S = 30.0


def heartbeat_path(base: str) -> str:
    """``<base>_heartbeat.jsonl`` (base = artifact path minus ``.json``)."""
    return f"{base}_heartbeat.jsonl"


def partial_record_path(base: str) -> str:
    return f"{base}_partial.json"


def active_recorder() -> "Optional[LiveRecorder]":
    return _ACTIVE


def flush_active(cause: str) -> Optional[str]:
    """Flush the process's active recorder (if any) with ``cause``; returns
    the partial-record path or None. Safe to call from signal handlers —
    never raises."""
    rec = _ACTIVE
    if rec is None:
        return None
    try:
        return rec.flush_partial(cause)
    except Exception:
        return None


def dump_all_stacks() -> str:
    """All-thread stack dump as text (faulthandler needs a real fd, so the
    dump round-trips through a temp file)."""
    try:
        with tempfile.TemporaryFile(mode="w+") as tf:
            faulthandler.dump_traceback(file=tf, all_threads=True)
            tf.seek(0)
            return tf.read()
    except Exception as e:  # pragma: no cover - faulthandler is stdlib
        return f"<stack dump failed: {e!r}>"


def read_heartbeat_tail(path: str, max_bytes: int = 256 << 10
                        ) -> Optional[Dict[str, Any]]:
    """Newest parseable heartbeat/stall line of a stream, or None. Reads
    only the file tail — post-mortem consumers poll this on long streams.
    The window must comfortably hold one STALL line (an embedded
    all-thread faulthandler dump easily exceeds 8 KiB under XLA thread
    pools), or tail readers go blind exactly when a stall just fired."""
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - max_bytes))
            chunk = f.read().decode("utf-8", errors="replace")
    except OSError:
        return None
    for line in reversed(chunk.strip().splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                return json.loads(line)
            except json.JSONDecodeError:
                continue
    return None


def _start_profiler(directory: str):
    """Open a ``torch.profiler`` session (CPU, and CUDA when a card is
    present) for an on-demand capture window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(directory, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    return prof


def _stop_profiler(prof, directory: str) -> str:
    """Close a capture session and export its Chrome trace; the path."""
    prof.__exit__(None, None, None)
    path = os.path.join(directory,
                        f"capture-{os.getpid()}-{int(time.time())}.json")
    prof.export_chrome_trace(path)
    return path


class LiveRecorder:
    """Background heartbeat sampler + stall watchdog + partial flusher.

    ``path_base`` anchors the two output files (``<base>_heartbeat.jsonl``,
    ``<base>_partial.json``). ``record_fn`` (optional) builds the partial
    run record — emitters that already have a cumulative record builder
    plug it in here; without one the recorder
    builds a record from the last-created tracer's live span tree.
    ``heartbeat_s``/``stall_s`` default from the env-flag registry
    (``SCC_OBS_HEARTBEAT`` / ``SCC_OBS_STALL_S``); fractional values are
    the test-scale hook. A recorder with ``heartbeat_s <= 0`` is disabled:
    ``start()`` is a no-op, so callers wire it unconditionally.
    """

    def __init__(self, path_base: str, metric: str = "live flight record",
                 extra: Optional[Dict[str, Any]] = None,
                 heartbeat_s: Optional[float] = None,
                 stall_s: Optional[float] = None,
                 capture_dir: Optional[str] = None,
                 capture_s: float = CAPTURE_WINDOW_S,
                 flush_every_s: float = FLUSH_EVERY_S,
                 record_fn: Optional[Callable[[], Dict[str, Any]]] = None):
        self.path_base = path_base
        self.hb_path = heartbeat_path(path_base)
        self.partial_path = partial_record_path(path_base)
        self.metric = metric
        self.extra = dict(extra or {})
        self.heartbeat_s = float(
            env_flag("SCC_OBS_HEARTBEAT") if heartbeat_s is None
            else heartbeat_s
        )
        self.stall_s = float(
            env_flag("SCC_OBS_STALL_S") if stall_s is None else stall_s
        )
        self.capture_dir = (capture_dir if capture_dir is not None
                            else env_flag("SCC_OBS_STALL_TRACE"))
        self.capture_s = float(capture_s)
        self.flush_every_s = float(flush_every_s)
        self.record_fn = record_fn

        self.ticks = 0
        self.stall_count = 0
        # Cumulative CPU seconds the sampler thread spent inside ticks
        # (time.thread_time: per-thread CPU, NOT wall — wall would charge
        # the sampler for GIL waits caused by the run thread and overstate
        # overhead by >10x on a busy interpreter). The overhead-guard test
        # asserts this stays <1% of the workload wall.
        self.tick_cpu_s = 0.0
        self._t_start = time.time()
        self._progress_unix = self._t_start
        self._last_transition_seen = 0.0
        self._stalled = False          # current stall episode
        # capture machinery: "idle" | "open" | "dead" (a wedged profiler
        # start is never retried); owner says WHO opened the window
        # ("mainthread" toggle vs "thread" stall escalation) so the two
        # can never double-stop one profiler session
        self._capture_state = "idle"
        self._capture_owner: Optional[str] = None
        self._profiler: Any = None
        self._last_flush = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._f = None
        # sampler thread, capture thread, annotate()/toggle_capture() on
        # the run/main thread all emit; unserialized writes could tear
        # lines and blind read_heartbeat_tail right when it matters
        self._emit_lock = threading.Lock()
        self._prev_term = None
        self._prev_usr1 = None
        self._atexit_registered = False

    # -- properties --------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self.heartbeat_s > 0

    # -- lifecycle ---------------------------------------------------------
    def start(self, install_signals: bool = True) -> "LiveRecorder":
        """Open the stream, write the header line, spawn the sampler
        thread. No-op when disabled (SCC_OBS_HEARTBEAT unset/0)."""
        global _ACTIVE
        if not self.enabled or self._thread is not None:
            return self
        # warm the per-tick panel modules NOW, on the caller's thread:
        # a first-tick lazy-import storm on the sampler thread costs
        # ~0.9 s of GIL-contended wall next to a busy run thread
        # (measured), which is a missed tick and a fat CPU bill charged
        # to the sampler's own overhead budget
        for mod in ("scconsensus_tpu_torch.obs.quality",
                    "scconsensus_tpu_torch.obs.residency",
                    "scconsensus_tpu_torch.robust.record",
                    "scconsensus_tpu_torch.robust.integrity",
                    "scconsensus_tpu_torch.serve.metrics"):
            try:
                __import__(mod)
            except Exception:
                pass
        os.makedirs(os.path.dirname(os.path.abspath(self.hb_path)) or ".",
                    exist_ok=True)
        self._f = open(self.hb_path, "a", buffering=1)
        self._emit({
            "t": "header", "ts": round(time.time(), 3), "pid": os.getpid(),
            "metric": self.metric, "extra": self.extra,
            "heartbeat_s": self.heartbeat_s, "stall_s": self.stall_s,
            "argv": list(sys.argv),
            "key": self._run_key(),
        })
        with _LOCK:
            _ACTIVE = self
        if install_signals:
            self._install_signals()
        # first periodic flush lands flush_every_s from NOW (0 here would
        # make every tick rewrite+fsync the partial record — measured at
        # ~100 ms/tick on slow filesystems)
        self._last_flush = time.time()
        self._thread = threading.Thread(
            target=self._run, name="scc-heartbeat", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, cause: str = "clean") -> None:
        """Stop the sampler and write the final partial record stamped with
        ``cause`` (idempotent; safe when never started)."""
        global _ACTIVE
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=max(2.0, 4 * self.heartbeat_s))
        if self.enabled and self._f is not None:
            self.flush_partial(cause)
            self._emit({"t": "end", "ts": round(time.time(), 3),
                        "cause": cause, "ticks": self.ticks,
                        "stalls": self.stall_count})
            try:
                self._f.close()
            except OSError:
                pass
            self._f = None
        with _LOCK:
            if _ACTIVE is self:
                _ACTIVE = None

    # -- signal / exit wiring ---------------------------------------------
    def _install_signals(self) -> None:
        """SIGTERM: flush a ``signal``-stamped partial, then chain to the
        handler that was installed before us (a caller's own checkpoint
        handler keeps working). SIGUSR1: request a profiler capture.
        atexit: flush ``crash`` if nothing flushed a better cause (a
        process dying of an unhandled exception still leaves its record).
        Non-main-thread installs are skipped silently."""
        def _on_term(signum, frame):  # pragma: no cover - signal path
            try:
                self.flush_partial("signal")
            except Exception:
                pass
            prev = self._prev_term
            if callable(prev):
                prev(signum, frame)
            elif prev == signal.SIG_DFL:
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGTERM)

        def _on_usr1(signum, frame):  # pragma: no cover - signal path
            # Runs on the MAIN thread. Toggle: first USR1 opens the
            # window, second closes it.
            try:
                self.toggle_capture()
            except Exception:
                pass

        try:
            self._prev_term = signal.signal(signal.SIGTERM, _on_term)
            self._prev_usr1 = signal.signal(signal.SIGUSR1, _on_usr1)
        except (ValueError, OSError, AttributeError):
            pass
        if not self._atexit_registered:
            self._atexit_registered = True

            def _at_exit():
                # stop() already ran on the happy path (then _f is None)
                if self._f is not None:
                    self.stop("crash")

            atexit.register(_at_exit)

    # -- sampling ----------------------------------------------------------
    def _run_key(self) -> Optional[Dict[str, str]]:
        """Run key of this recorder's workload (for tail_run.py's ETA
        lookup against the evidence ledger); None when extras carry no
        workload identity."""
        try:
            if not self.extra:
                return None
            from scconsensus_tpu_torch.obs.ledger import run_key

            return run_key({"extra": self.extra,
                            "unit": self.extra.get("unit", "seconds")})
        except Exception:
            return None

    def _emit(self, obj: Dict[str, Any]) -> None:
        f = self._f
        if f is None:
            return
        try:
            line = json.dumps(obj, default=str) + "\n"
            with self._emit_lock:
                f.write(line)
                f.flush()
        except (OSError, ValueError):
            pass

    def _observe_progress(self, now: float) -> None:
        """Update ``progress_unix`` from span transitions."""
        tr = obs_trace.last_tracer()
        if tr is not None:
            t = tr.last_transition_unix
            if t > self._last_transition_seen:
                self._last_transition_seen = t
                self._progress_unix = max(self._progress_unix, t)

    def touch(self) -> None:
        """Manual progress mark for instrumented host-side work that opens
        no spans (chunked generators, long pure-numpy phases)."""
        self._progress_unix = time.time()

    def annotate(self, **extra: Any) -> None:
        """Update the recorder's workload extras after start (e.g. the
        platform, known only once the backend answered) and append an
        ``annotate`` line so stream consumers (tail_run.py's ETA key
        lookup) see the refined run key."""
        self.extra.update(extra)
        self._emit({"t": "annotate", "ts": round(time.time(), 3),
                    "extra": dict(extra), "key": self._run_key()})

    def _open_metrics(self, tr) -> Dict[str, Any]:
        """Scalar counter/gauge snapshots of the open spans (histograms are
        summarized by n/sum)."""
        out: Dict[str, Any] = {}
        try:
            with tr._lock:
                stack = list(tr._stack)
            for sp in stack:
                ms = sp._metrics
                if ms is None or ms.empty():
                    continue
                for name, m in ms.to_dict().items():
                    if m.get("type") in ("counter", "gauge"):
                        out[f"{sp.name}.{name}"] = m.get("value")
                    else:
                        out[f"{sp.name}.{name}"] = {
                            "n": m.get("n"), "sum": m.get("sum")
                        }
        except Exception:
            pass
        return out

    def _snapshot(self, now: float) -> Dict[str, Any]:
        from scconsensus_tpu_torch.obs import device as obs_device

        tr = obs_trace.last_tracer()
        open_spans: List[Dict[str, Any]] = []
        spans_done = 0
        metrics: Dict[str, Any] = {}
        if tr is not None:
            try:
                open_spans = tr.open_stack()
                spans_done = len(tr.spans)
                metrics = self._open_metrics(tr)
            except Exception:
                pass
        hb: Dict[str, Any] = {
            "t": "hb",
            "ts": round(now, 3),
            "seq": self.ticks,
            "up_s": round(now - self._t_start, 3),
            "progress_unix": round(self._progress_unix, 3),
            "since_progress_s": round(now - self._progress_unix, 3),
            "open_spans": open_spans,
            "spans_done": spans_done,
            "stalls": self.stall_count,
            # BOTH gauges ride every tick: rss_bytes is the instantaneous
            # value (where memory is NOW), rss_peak_bytes the kernel
            # high-water mark since process start — the number the
            # streaming budget assertion (stream.budget) and the run
            # record's bounded-memory evidence are judged by, so the
            # tail_run panel and the gate read the SAME quantity. (The
            # pre-r17 stream carried ru_maxrss under the rss_bytes name —
            # a spike-blind live view and a mislabeled peak at once.)
            "rss_bytes": obs_device.host_rss_bytes(),
            "rss_peak_bytes": obs_device.host_peak_rss_bytes(),
        }
        if metrics:
            hb["metrics"] = metrics
        try:
            # quality panel: sentinel trip count + latest funnel totals,
            # so tail_run shows NaN storms and empty funnels LIVE
            from scconsensus_tpu_torch.obs import quality as obs_quality

            q = obs_quality.live_summary(tr)
            if q:
                hb["quality"] = q
        except Exception:
            pass
        try:
            # residency panel: cumulative transfer counters of the active
            # auditor — tail_run differences consecutive ticks into a live
            # transfer-bytes rate (a host-round-trip storm is visible as
            # MB/s while the run is still going, not post-mortem)
            from scconsensus_tpu_torch.obs import residency as obs_residency

            tc = obs_residency.live_counters()
            if tc:
                hb["transfers"] = tc
        except Exception:
            pass
        try:
            # robustness panel: live fault/retry/degradation counters
            # (robust.record) — a run fighting for its life shows it on
            # the stream, and a SIGKILLed run's LAST heartbeat says what
            # it had already survived
            from scconsensus_tpu_torch.robust import record as robust_record

            rs = robust_record.live_summary()
            if rs:
                hb["robust"] = rs
        except Exception:
            pass
        try:
            # streaming panel: chunks completed/planned, staged bytes,
            # window halvings, peak RSS vs the host budget — an
            # out-of-core run's vitals tick by tick, and a SIGKILLed
            # ingest's LAST heartbeat says which chunk was durable
            sm = stream_record.live_summary()
            if sm:
                hb["streaming"] = sm
        except Exception:
            pass
        try:
            # integrity panel: invariant checks passed/run, ghost-replay
            # progress + lag, mismatches and recomputes (robust.
            # integrity) — a run silently fighting corruption shows it
            # on the stream, tick by tick
            from scconsensus_tpu_torch.robust import (
                integrity as robust_integrity,
            )

            ig = robust_integrity.live_summary()
            if ig:
                hb["integrity"] = ig
        except Exception:
            pass
        try:
            # serving panel: queue depth, rolling p99, breaker state and
            # the degraded/quarantined/rejected tallies of the process's
            # active serving driver — an online path fighting for its
            # life shows it on the stream tick by tick
            from scconsensus_tpu_torch.serve import metrics as serve_metrics

            ss = serve_metrics.live_summary()
            if ss:
                hb["serving"] = ss
        except Exception:
            pass
        mem = obs_device.memory_snapshot()
        if mem is not None:
            hb["hbm"] = mem
        return hb

    # -- stall handling ----------------------------------------------------
    def _check_stall(self, now: float) -> None:
        if self.stall_s <= 0:
            return
        since = now - self._progress_unix
        if since <= self.stall_s:
            if self._stalled:
                self._emit({"t": "recovered", "ts": round(now, 3),
                            "stalls": self.stall_count})
            self._stalled = False
            return
        if self._stalled:
            return  # one dump per stall episode
        self._stalled = True
        self.stall_count += 1
        tr = obs_trace.last_tracer()
        event: Dict[str, Any] = {
            "t": "stall",
            "ts": round(now, 3),
            "since_progress_s": round(since, 3),
            "stalls": self.stall_count,
            "open_spans": tr.open_stack() if tr is not None else [],
            "stack": dump_all_stacks(),
        }
        emitted = threading.Event()
        if self.capture_dir:
            event["capture"] = self._spawn_capture("stall", after=emitted)
        self._emit(event)
        emitted.set()
        self.flush_partial("stall")

    def toggle_capture(self) -> None:
        """Synchronous main-thread capture toggle (the SIGUSR1 handler):
        first call opens a ``torch.profiler`` window, second closes it and
        exports its trace into the capture directory."""
        now = time.time()
        if not self.capture_dir or "torch" not in sys.modules:
            self._emit({"t": "capture-failed", "ts": round(now, 3),
                        "error": "no SCC_OBS_STALL_TRACE dir or torch not "
                                 "loaded"})
            return
        if self._capture_state == "open":
            if self._capture_owner != "mainthread":
                # a stall-escalation capture thread owns the session and
                # will stop it itself; stopping here would double-stop
                # the profiler and poison the machinery as "dead"
                self._emit({"t": "capture-busy", "ts": round(now, 3),
                            "owner": self._capture_owner})
                return
            path = _stop_profiler(self._profiler, self.capture_dir)
            self._profiler = None
            self._capture_state = "idle"
            self._capture_owner = None
            self._emit({"t": "capture-done", "ts": round(now, 3),
                        "dir": self.capture_dir, "file": path})
        else:
            self._profiler = _start_profiler(self.capture_dir)
            self._capture_state = "open"
            self._capture_owner = "mainthread"
            self._emit({"t": "capture", "ts": round(now, 3),
                        "trigger": "sigusr1", "dir": self.capture_dir})

    def _spawn_capture(self, trigger: str,
                       after: threading.Event) -> Optional[str]:
        """Stall-escalation capture: a self-contained daemon thread runs
        start → sleep(capture_s) → stop and export, and emits the
        capture/capture-done events itself, so a wedged profiler start can
        never hang the sampler loop (the thread just parks and the state
        stays "open" — no retries, and the missing ``capture`` event in
        the stream is itself the diagnosis). Never the first torch
        touch. The thread starts the profiler only once ``after`` is set,
        so the trigger's own event (the stall) precedes ``capture`` in
        the stream even when a warm profiler starts at once."""
        if ("torch" not in sys.modules or not self.capture_dir
                or self._capture_state != "idle"):
            return None
        self._capture_state = "open"
        self._capture_owner = "thread"
        cap_dir, cap_s = self.capture_dir, self.capture_s

        def _go():
            after.wait()
            try:
                prof = _start_profiler(cap_dir)
                self._emit({"t": "capture", "ts": round(time.time(), 3),
                            "trigger": trigger, "dir": cap_dir,
                            "duration_s": cap_s})
                time.sleep(cap_s)
                path = _stop_profiler(prof, cap_dir)
                self._emit({"t": "capture-done",
                            "ts": round(time.time(), 3), "dir": cap_dir,
                            "file": path})
                self._capture_state = "idle"
                self._capture_owner = None
            except Exception as e:
                self._emit({"t": "capture-failed",
                            "ts": round(time.time(), 3),
                            "error": repr(e)[:200]})
                self._capture_state = "dead"

        threading.Thread(target=_go, daemon=True,
                         name="scc-capture").start()
        return cap_dir

    # -- partial record ----------------------------------------------------
    def build_partial_record(self, cause: str) -> Dict[str, Any]:
        if cause not in TERMINATION_CAUSES:
            raise ValueError(f"unknown termination cause {cause!r}")
        tr = obs_trace.last_tracer()
        if self.record_fn is not None:
            rec = self.record_fn()
        else:
            rec = build_run_record(
                metric=self.metric, value=-1.0, unit="seconds",
                vs_baseline=None, extra=dict(self.extra),
                spans=tr.live_span_records() if tr is not None else [],
            )
        open_spans = tr.open_stack() if tr is not None else []
        rec["termination"] = {
            "cause": cause,
            "last_span": open_spans[-1]["name"] if open_spans else None,
            "open_spans": open_spans,
            "stall_count": self.stall_count,
            "heartbeat_path": os.path.basename(self.hb_path),
            "flushed_unix": round(time.time(), 3),
        }
        if cause != "clean":
            rec.setdefault("extra", {})["partial"] = True
        return rec

    def flush_partial(self, cause: str = "crash") -> Optional[str]:
        """Atomically (re)write ``<base>_partial.json``. The on-disk stamp
        always answers "what does it mean if this file is the last
        evidence" — hence the periodic flush's standing ``crash``."""
        try:
            rec = self.build_partial_record(cause)
            rec = json.loads(json.dumps(rec, default=str))
            write_json_atomic(self.partial_path, rec)
            self._last_flush = time.time()
            return self.partial_path
        except Exception:
            return None

    # -- the sampler thread ------------------------------------------------
    def _run(self) -> None:
        while not self._stop.wait(self.heartbeat_s):
            t0 = time.thread_time()
            try:
                now = time.time()
                self._observe_progress(now)
                self.ticks += 1
                self._emit(self._snapshot(now))
                self._check_stall(now)
                if now - self._last_flush >= self.flush_every_s:
                    # the standing stamp while running is "crash": see
                    # flush_partial. A stall episode keeps its own stamp.
                    self.flush_partial("stall" if self._stalled else "crash")
            except Exception:  # the sampler must never kill the run
                pass
            finally:
                self.tick_cpu_s += time.thread_time() - t0
