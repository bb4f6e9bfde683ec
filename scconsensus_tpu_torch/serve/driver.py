"""Micro-batching serving driver with its guards.

The port of ``scconsensus_tpu/serve/driver.py``. ``ConsensusServer``
serves ``classify(new_cells)`` against a frozen
:class:`~scconsensus_tpu_torch.serve.model.ConsensusModel` on the device
it resolves at construction (``cuda`` unless ``device="cpu"``; with no
card it raises):

  * **bounded admission**: a submit at capacity raises typed
    :class:`QueueFull` with ``retry_after_s``;
  * **per-request deadlines**, checked at dequeue and after compute; an
    overrun resolves as typed :class:`DeadlineExceeded`;
  * **a circuit breaker over the device path**: failures classified by
    ``robust.retry.classify_exception`` (XLA's, CUDA's and the injected
    faults' signatures alike) count toward the trip threshold; an open
    breaker serves from the model's float64 host mirror with every
    response flagged ``degraded=True``, counted under the ``degraded``
    outcome and noted on the robustness log, then half-open-probes the
    device after a cooldown. Fatal-class errors fail each request as
    typed :class:`RequestFailed`. This flagged path is the only one to
    the host;
  * **drift quarantine**: a request past the model's calibrated
    foreign-cell fraction gets no labels, a quarantine-ledger row (JSONL)
    and ``quarantined=True``;
  * **accounting**: every request ends as exactly one
    ``serve.metrics.OUTCOMES`` entry.

Fault sites (``robust.faults``): ``serve_load`` (model load),
``serve_batch`` (micro-batch assembly), ``serve_device`` (inside the
device call). Every request rides a back-dated ``serve_request`` span.

Under ``SCC_INTEGRITY`` (``audit`` or ``enforce``) the injected
``serve_classify`` corruption site may perturb the device labels, and
the first batch of every 64 is ghost-replayed against the model's
float64 host mirror (``robust.integrity.replay_classify``); in enforce
mode a mismatch raises typed silent_corruption, which the in-batch retry
recomputes and the breaker counts.

Against the reference: batches are not padded to a power of two (that
bounds XLA's compile cache; eager PyTorch compiles nothing, and rows are
independent, so labels do not change).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import threading
import time
from typing import Any, Dict, List, Optional, Union

import numpy as np

from scconsensus_tpu_torch.config import env_flag
from scconsensus_tpu_torch.device import resolve_device
from scconsensus_tpu_torch.obs import trace as obs_trace
from scconsensus_tpu_torch.robust import faults
from scconsensus_tpu_torch.robust import integrity as robust_integrity
from scconsensus_tpu_torch.robust import record as rb_record
from scconsensus_tpu_torch.robust import retry as robust_retry
from scconsensus_tpu_torch.serve import metrics as serve_metrics
from scconsensus_tpu_torch.serve.errors import (
    DeadlineExceeded,
    ModelLoadError,
    QueueFull,
    RequestFailed,
    RequestInvalid,
    ServeError,
    ServerClosed,
)
from scconsensus_tpu_torch.serve.model import (
    ConsensusModel,
    load_consensus_model,
)

__all__ = [
    "ServeConfig",
    "ServeResponse",
    "RequestHandle",
    "CircuitBreaker",
    "ConsensusServer",
    "QUARANTINE_LEDGER_NAME",
    "QUARANTINE_CELLS_DIR",
]

QUARANTINE_LEDGER_NAME = "QUARANTINE_LEDGER.jsonl"
_NO_SPAN = contextlib.nullcontext()
# sibling dir of the ledger for the quarantined cells (the reference's
# name, which its re-consensus loop reads)
QUARANTINE_CELLS_DIR = "quarantine_cells"


@dataclasses.dataclass
class ServeConfig:
    """Driver knobs; ``None`` fields resolve from the registered serve
    env flags (config.ENV_FLAGS) at construction."""

    max_batch_cells: Optional[int] = None     # SCC_SERVE_MAX_BATCH
    queue_capacity: Optional[int] = None      # SCC_SERVE_QUEUE_CAP
    batch_window_s: Optional[float] = None    # SCC_SERVE_BATCH_WINDOW_S
    default_deadline_s: Optional[float] = None  # SCC_SERVE_DEADLINE_S
    breaker_threshold: Optional[int] = None   # SCC_SERVE_BREAKER_THRESHOLD
    breaker_cooldown_s: Optional[float] = None  # SCC_SERVE_BREAKER_COOLDOWN_S
    drift_quarantine_frac: Optional[float] = None  # SCC_SERVE_DRIFT_FRAC
    quarantine_path: Optional[str] = None     # default <model_dir>/ledger
    ledger_dir: Optional[str] = None          # SCC_SERVE_LEDGER_DIR

    def resolved(self) -> "ServeConfig":
        def _r(v, flag):
            return env_flag(flag) if v is None else v

        return ServeConfig(
            max_batch_cells=int(_r(self.max_batch_cells,
                                   "SCC_SERVE_MAX_BATCH")),
            queue_capacity=int(_r(self.queue_capacity,
                                  "SCC_SERVE_QUEUE_CAP")),
            batch_window_s=float(_r(self.batch_window_s,
                                    "SCC_SERVE_BATCH_WINDOW_S")),
            default_deadline_s=float(_r(self.default_deadline_s,
                                        "SCC_SERVE_DEADLINE_S")),
            breaker_threshold=int(_r(self.breaker_threshold,
                                     "SCC_SERVE_BREAKER_THRESHOLD")),
            breaker_cooldown_s=float(_r(self.breaker_cooldown_s,
                                        "SCC_SERVE_BREAKER_COOLDOWN_S")),
            drift_quarantine_frac=float(_r(self.drift_quarantine_frac,
                                           "SCC_SERVE_DRIFT_FRAC")),
            quarantine_path=self.quarantine_path,
            ledger_dir=_r(self.ledger_dir, "SCC_SERVE_LEDGER_DIR"),
        )


@dataclasses.dataclass
class ServeResponse:
    """One request's terminal answer. ``labels`` is None exactly when the
    drift gate quarantined the request (``outcome == "quarantined"``)."""

    req_id: int
    outcome: str                       # "ok" | "degraded" | "quarantined"
    labels: Optional[np.ndarray]
    distances: Optional[np.ndarray]
    degraded: bool
    quarantined: bool
    drift_fraction: float
    latency_s: float
    batch_seq: int
    # fingerprint of the model that answered
    model_fp: Optional[str] = None
    # the request's trace id, minted at admission (or passed in) and
    # carried through the span, the ledger row and the stats
    trace_id: Optional[str] = None


class RequestHandle:
    """Future-style handle returned by :meth:`ConsensusServer.submit`.
    ``result()`` returns the :class:`ServeResponse` or raises the
    request's typed error.

    The wait is a lock held from creation until the request resolves (a
    ``threading.Event`` builds a condition variable per request, which the
    zero-fault path pays for on every request); waiters take and release
    it in turn."""

    __slots__ = ("req_id", "cells", "n", "deadline_mono", "enqueued_mono",
                 "trace_id", "_latch", "_done", "_response", "_error")

    def __init__(self, req_id: int, cells: np.ndarray,
                 deadline_mono: float, trace_id: Optional[str] = None):
        # monotonic stamps: deadlines and latencies are DURATIONS, and a
        # wall-clock step (NTP) must not expire a queue or stretch a p99
        self.req_id = req_id
        self.cells = cells
        self.n = int(cells.shape[0])
        self.deadline_mono = float(deadline_mono)
        self.trace_id = trace_id
        self.enqueued_mono = time.monotonic()
        self._latch = threading.Lock()
        self._latch.acquire()
        self._done = False
        self._response: Optional[ServeResponse] = None
        self._error: Optional[BaseException] = None

    def _resolve(self, response: Optional[ServeResponse] = None,
                 error: Optional[BaseException] = None) -> None:
        self._response = response
        self._error = error
        self._done = True
        self._latch.release()

    def done(self) -> bool:
        return self._done

    def result(self, timeout: Optional[float] = None) -> ServeResponse:
        if not self._done:
            if not self._latch.acquire(
                    timeout=-1 if timeout is None else max(timeout, 0.0)):
                raise TimeoutError(
                    f"request {self.req_id} not resolved within {timeout}s"
                )
            self._latch.release()
        if self._error is not None:
            raise self._error
        assert self._response is not None
        return self._response


class CircuitBreaker:
    """closed → (threshold consecutive device-class failures) → open →
    (cooldown) → half_open probe → closed on success / open on failure.
    Device-class = resource/transient/device_lost per the shared
    classifier; fatal never counts."""

    def __init__(self, threshold: int, cooldown_s: float,
                 stats: serve_metrics.ServingStats):
        self.threshold = max(int(threshold), 1)
        self.cooldown_s = float(cooldown_s)
        self.stats = stats
        self.state = "closed"
        self.failures = 0
        self.opened_at = 0.0
        self.trips = 0
        # the autoscaler's degraded-mode lever: a forced-open breaker
        # routes every batch to the host path, with no half-open probe,
        # until force_close() lifts it
        self.forced = False
        self._lock = threading.Lock()

    def route(self, now: Optional[float] = None) -> str:
        """'device' or 'fallback' for the next batch."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if self.forced:
                return "fallback"
            if self.state == "closed":
                return "device"
            if self.state == "open":
                if now - self.opened_at >= self.cooldown_s:
                    self.state = "half_open"
                    self.stats.note_breaker("half_open")
                    return "device"  # the probe
                return "fallback"
            return "device"  # half_open: keep probing

    def force_open(self, now: Optional[float] = None) -> None:
        """Degraded-mode entry: pin the breaker open (every batch is
        served flagged degraded from the host path, no probing). It counts
        as a trip: a record of degraded service shows a tripped breaker."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if self.forced:
                return
            self.forced = True
            if self.state != "open":
                self.state = "open"
                self.opened_at = now
                self.trips += 1
                self.stats.note_breaker("open", tripped=True)

    def force_close(self) -> None:
        """Degraded-mode exit: the breaker returns to closed and failure
        counting resumes."""
        with self._lock:
            if not self.forced:
                return
            self.forced = False
            if self.state != "closed":
                self.state = "closed"
                self.stats.note_breaker("closed")
            self.failures = 0

    def record_success(self) -> None:
        with self._lock:
            if self.forced:
                # a host-path success never closes a forced-open breaker:
                # only force_close() ends degraded mode
                self.failures = 0
                return
            if self.state != "closed":
                self.state = "closed"
                self.stats.note_breaker("closed")
            self.failures = 0

    def record_failure(self, err_class: str,
                       now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            self.failures += 1
            if self.state == "half_open" or (
                self.state == "closed" and self.failures >= self.threshold
            ):
                self.state = "open"
                self.opened_at = now
                self.trips += 1
                self.stats.note_breaker("open", tripped=True)


class ConsensusServer:
    """The guarded online classify() path. Use as a context manager or
    call :meth:`start` / :meth:`stop` explicitly."""

    def __init__(self, model: Union[ConsensusModel, str],
                 config: Optional[ServeConfig] = None,
                 readonly: bool = False,
                 register_live: bool = True,
                 device=None):
        dev = resolve_device(device)
        if isinstance(model, str):
            # typed refusal path: ModelLoadError propagates — a server
            # must not come up on a model it cannot prove intact. The
            # default keeps the quarantine contract (a corrupt artifact
            # is renamed aside as a post-mortem); readonly=True serves a
            # frozen dir on a read-only mount and refuses WITHOUT
            # touching the operator's files.
            self.model_dir: Optional[str] = model
            self.model = load_consensus_model(model, readonly=readonly,
                                              device=dev)
        else:
            self.model_dir = None
            self.model = model.to(dev)
        self.config = (config or ServeConfig()).resolved()
        self.stats = serve_metrics.ServingStats(
            queue_capacity=self.config.queue_capacity
        )
        self.breaker = CircuitBreaker(
            self.config.breaker_threshold,
            self.config.breaker_cooldown_s,
            self.stats,
        )
        qp = self.config.quarantine_path
        if qp is None and self.config.ledger_dir:
            # the writable sidecar dir (SCC_SERVE_LEDGER_DIR): the only
            # way a server on a frozen read-only model dir keeps drift
            # evidence (the ledger lines and the quarantined cells)
            qp = os.path.join(self.config.ledger_dir,
                              QUARANTINE_LEDGER_NAME)
        if qp is None and self.model_dir is not None and not readonly:
            # never default the ledger INTO a readonly model dir: the
            # appends would all fail silently against the promise that a
            # frozen mount is never written — a readonly server needs an
            # explicit quarantine_path or ledger_dir, else the response
            # flag alone is the signal
            qp = os.path.join(self.model_dir, QUARANTINE_LEDGER_NAME)
        self.quarantine_path = qp
        self._register_live = bool(register_live)
        self._q_cells_saved = 0
        self._q_seq = 0
        self._queue: List[RequestHandle] = []
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._closed = True
        self._draining = False
        self._thread: Optional[threading.Thread] = None
        self._req_seq = 0
        self._batch_seq = 0
        # EWMA of recent batch walls — the retry_after hint's basis
        self._batch_wall_ewma = 0.01

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ConsensusServer":
        if self._thread is not None:
            return self
        self._closed = False
        self._draining = False
        if self._register_live:
            # the process's active stats, which metrics.live_summary
            # reads; a server that is one of several (the atlas
            # scenario's batch workload) passes register_live=False
            serve_metrics.set_active(self.stats)
        self._thread = threading.Thread(
            target=self._worker, name="scc-serve", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout_s: float = 60.0) -> None:
        """Close admission, optionally drain the queue, stop the worker.
        With ``drain=False`` queued requests resolve as ServerClosed —
        still typed, still accounted. ``timeout_s`` bounds the worker
        join."""
        with self._lock:
            if self._closed and self._thread is None:
                return
            self._closed = True
            self._draining = drain
            self._not_empty.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout=max(float(timeout_s), 0.1))
        self._thread = None
        with self._lock:
            leftovers = self._queue
            self._queue = []
        for r in leftovers:
            r._resolve(error=ServerClosed(
                f"server stopped before request {r.req_id} was served"
            ))
            # a drain refusal is a typed REJECTION, not a fatal error —
            # "failed" must stay the fatal-bug signal
            self.stats.note_outcome("rejected_closed")
        if serve_metrics.active_stats() is self.stats:
            serve_metrics.set_active(None)

    def __enter__(self) -> "ConsensusServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def closed(self) -> bool:
        """True when the driver is not accepting requests (never started,
        stopped, or draining): the wire front's /healthz signal."""
        return self._closed

    # -- admission ---------------------------------------------------------
    def submit(self, cells: np.ndarray,
               deadline_s: Optional[float] = None,
               trace_id: Optional[str] = None) -> RequestHandle:
        """Enqueue one request ((n, G) genes-length rows). Typed refusals:
        ServerClosed, RequestInvalid, QueueFull(retry_after_s).
        ``trace_id`` rides in from the wire front; without one, and with
        SCC_OBS_TRACE on, the request gets a trace id here. The queue
        capacity is read at each admission, so the autoscaler can tighten
        it on a live replica.

        Admission overhead is self-measured in per-thread CPU time
        (``time.thread_time``): wall would charge admission for GIL waits
        caused by the worker's compute and overstate the guard cost by
        >10x on a busy interpreter. The worker's own share is wall time
        (see ``_process``)."""
        t0 = time.thread_time()
        if trace_id is None and env_flag("SCC_OBS_TRACE"):
            trace_id = obs_trace.new_trace_id()
        try:
            if self._closed:
                raise ServerClosed("server is not accepting requests")
            x = np.asarray(cells)
            if x.ndim != 2 or x.shape[0] < 1:
                raise RequestInvalid(
                    f"cells must be a non-empty (n, G) matrix, "
                    f"got shape {x.shape}"
                )
            if x.shape[1] != self.model.n_genes:
                raise RequestInvalid(
                    f"cells have {x.shape[1]} genes; the frozen model "
                    f"expects {self.model.n_genes}"
                )
            if x.shape[0] > self.config.max_batch_cells:
                raise RequestInvalid(
                    f"request of {x.shape[0]} cells exceeds the "
                    f"max batch of {self.config.max_batch_cells}; split it"
                )
            # NO full NaN/Inf scan here: a non-finite cell necessarily
            # produces a non-finite nearest-landmark distance, and the
            # classify computes those anyway (rows are independent, so a
            # poisoned request cannot corrupt its batch-mates) — the
            # finiteness guard rides the batch for free and resolves as
            # a typed RequestInvalid at resolution (see _process)
            dl = (self.config.default_deadline_s
                  if deadline_s is None else float(deadline_s))
            with self._lock:
                if self._closed:
                    # re-check UNDER the lock: a submit racing stop()
                    # must never append to a queue no worker will drain
                    # (the handle would hang unresolved and break the
                    # accounting contract)
                    raise ServerClosed("server is not accepting requests")
                depth = len(self._queue)
                if depth >= self.config.queue_capacity:
                    # retry-after: roughly the time to drain half the queue
                    per_req = self._batch_wall_ewma / max(
                        1.0, self.config.max_batch_cells / max(x.shape[0], 1)
                    )
                    retry = max(per_req * depth / 2.0, 0.001)
                    self.stats.note_outcome("rejected_queue")
                    self.stats.note_submit(depth)
                    raise QueueFull(depth, self.config.queue_capacity,
                                    retry_after_s=retry)
                self._req_seq += 1
                req = RequestHandle(self._req_seq, x,
                                    time.monotonic() + dl,
                                    trace_id=trace_id)
                self._queue.append(req)
                self.stats.note_submit(len(self._queue))
                self._not_empty.notify()
            return req
        except (RequestInvalid, ServerClosed):
            # invalid/closed submissions are accounted too — a typed
            # rejection is an outcome, not a disappearance
            self.stats.note_submit(len(self._queue))
            self.stats.note_outcome(
                "rejected_invalid" if not self._closed
                else "rejected_closed"
            )
            raise
        finally:
            self.stats.add_consumed(time.thread_time() - t0)

    def classify(self, cells: np.ndarray,
                 deadline_s: Optional[float] = None,
                 timeout: Optional[float] = None) -> ServeResponse:
        """submit + wait convenience for synchronous callers."""
        return self.submit(cells, deadline_s=deadline_s).result(
            timeout=timeout
        )

    # -- the worker --------------------------------------------------------
    def _collect(self) -> Optional[List[RequestHandle]]:
        """Block for the first request, then linger ``batch_window_s``
        (or until ``max_batch_cells``) coalescing concurrent arrivals —
        the micro-batch. None = shut down."""
        with self._not_empty:
            while not self._queue:
                if self._closed:
                    return None
                self._not_empty.wait(timeout=0.05)
            if self._closed and not self._draining:
                # stop(drain=False): leave the backlog for stop() to
                # resolve as typed ServerClosed — don't serve it
                return None
            batch = [self._queue.pop(0)]
            cells = batch[0].n
        window_end = time.monotonic() + self.config.batch_window_s
        while cells < self.config.max_batch_cells:
            with self._not_empty:
                if not self._queue:
                    remaining = window_end - time.monotonic()
                    if remaining <= 0 or (self._closed
                                          and not self._queue):
                        break
                    self._not_empty.wait(timeout=min(remaining, 0.05))
                if (self._queue and self._queue[0].n + cells
                        <= self.config.max_batch_cells):
                    r = self._queue.pop(0)
                    batch.append(r)
                    cells += r.n
                elif self._queue:
                    break  # next request would overflow the batch
                elif time.monotonic() >= window_end:
                    break
        with self._lock:
            self.stats.note_queue_depth(len(self._queue))
        return batch

    def _worker(self) -> None:
        while True:
            batch = self._collect()
            if batch is None:
                # closed: with drain the queue is already empty (the
                # collect loop kept serving until then); without it the
                # backlog is stop()'s to refuse typed
                return
            try:
                self._process(batch)
            except BaseException as e:  # noqa: BLE001 - last-ditch guard
                # the accounting contract survives even a driver bug:
                # every in-flight request resolves typed, never hangs
                for r in batch:
                    if not r.done():
                        r._resolve(error=RequestFailed(
                            f"serving driver error: {e!r}",
                            error_class="fatal",
                        ))
                        self.stats.note_outcome("failed")

    def _device_classify(self, x: np.ndarray):
        """One guarded device call (fault site ``serve_device``); the
        ``serve_classify`` corruption site may perturb its labels, and
        under ``SCC_INTEGRITY`` the first batch of every 64 is
        ghost-replayed against the model's float64 host mirror."""
        faults.fault_point("serve_device")
        labels, dist = self.model.classify(x)
        labels = faults.corrupt_value("serve_classify", labels)
        if robust_integrity.enabled() and \
                robust_integrity.current().want_replay(
                    "serve", self._batch_seq // 64):
            robust_integrity.replay_classify(
                "serve_classify", x, labels, self.model,
                unit=f"batch:{self._batch_seq}",
            )
        return labels, dist

    def _process(self, batch: List[RequestHandle]) -> None:
        # the worker's own share of the guard is taken in wall time: a
        # thread-CPU read is a system call, four a batch, and on the
        # card's host those reads were a third of the guard they measure
        t_batch0 = time.perf_counter()
        now = time.monotonic()
        self._batch_seq += 1
        # the batch span only where a tracer is active on this thread (the
        # module-level span is a null sink otherwise; skipping it keeps
        # the zero-fault path inside the guard's budget)
        span = (obs_trace.span("serve_batch", kind="detail",
                               n_requests=len(batch),
                               n_cells=sum(r.n for r in batch))
                if obs_trace.current_tracer() is not None else _NO_SPAN)
        with span:
            # deadline check at dequeue: a request that already missed its
            # deadline must not burn device time
            live: List[RequestHandle] = []
            for r in batch:
                if now > r.deadline_mono:
                    self._finish(r, error=DeadlineExceeded(
                        f"request {r.req_id} exceeded its deadline in the "
                        f"queue", late_by_s=now - r.deadline_mono,
                    ), outcome="deadline_exceeded")
                else:
                    live.append(r)
            if not live:
                return
            self.stats.note_batch(len(live), sum(r.n for r in live))
            for r in live:
                # queue_wait stage histogram: dequeue minus enqueue per
                # request — the half of the p99 batching owns
                self.stats.note_stage_latency(
                    "queue_wait", now - r.enqueued_mono
                )
            try:
                # batching-layer fault site: kill/stall/corrupt plans
                # land between dequeue and dispatch — mid-batch
                faults.fault_point("serve_batch")
            except Exception as e:
                err_class = robust_retry.classify_exception(e)
                if err_class == "fatal":
                    for r in live:
                        self._finish(r, error=RequestFailed(
                            f"batch assembly failed: {e}",
                            error_class=err_class,
                        ), outcome="failed")
                    return
                # non-fatal batch fault: treat like a device failure —
                # count it on the breaker and serve degraded below
                self.breaker.record_failure(err_class)
            x = (live[0].cells if len(live) == 1
                 else np.concatenate([r.cells for r in live]))
            x = np.asarray(x, np.float32)

            # Device path with in-batch typed retry: a device-class
            # failure (resource/transient/device_lost per the shared
            # classifier) counts one breaker failure and the batch
            # retries; once the breaker trips (threshold consecutive
            # failures, or any half-open probe failure), the batch —
            # and every batch until the cooldown probe succeeds — serves
            # from the HOST fallback, explicitly flagged degraded. A
            # transient blip therefore recovers invisibly; a broken
            # device degrades loudly; a bug (fatal class) fails typed.
            degraded = False
            t_dev0 = time.perf_counter()
            labels = dist = None
            attempt = 0
            while True:
                if self.breaker.route() != "device":
                    rb_record.note_degradation(
                        "serve_device", "host-fallback",
                        f"breaker {self.breaker.state} — serving degraded",
                    )
                    labels, dist = self.model.classify_host(x)
                    degraded = True
                    break
                try:
                    labels, dist = self._device_classify(x)
                    self.breaker.record_success()
                    break
                except Exception as e:
                    err_class = robust_retry.classify_exception(e)
                    if err_class == "fatal":
                        for r in live:
                            self._finish(r, error=RequestFailed(
                                f"device classify failed fatally: {e}",
                                error_class=err_class,
                            ), outcome="failed")
                        return
                    attempt += 1
                    self.breaker.record_failure(err_class)
                    time.sleep(min(0.01 * attempt, 0.1))
            batch_wall = time.perf_counter() - t_dev0
            self.stats.add_classify_wall(batch_wall)
            # compute stage histogram: the classify wall this batch paid
            self.stats.note_stage_latency("compute", batch_wall)
            self._batch_wall_ewma = (0.7 * self._batch_wall_ewma
                                     + 0.3 * batch_wall)

            # per-request resolution: slice, drift-score, deadline-check
            off = 0
            now2 = time.monotonic()
            quarantined_n = 0
            any_drift = False
            thr = self.model.drift_threshold
            for r in live:
                if len(live) == 1:
                    lab, d = labels, dist
                else:
                    lab = labels[off:off + r.n]
                    d = dist[off:off + r.n]
                    off += r.n
                # one reduction serves both checks: the max is NaN or inf
                # exactly when a distance is, and no cell is past the
                # drift threshold when the max is not
                d_max = float(d.max())
                if not math.isfinite(d_max):
                    # the free finiteness guard (see submit): NaN/Inf
                    # cells surface as non-finite distances on the (n,)
                    # result — reject typed, never label garbage
                    self._finish(r, error=RequestInvalid(
                        f"request {r.req_id} contains non-finite cells "
                        f"({int((~np.isfinite(d)).sum())} of {r.n})"
                    ), outcome="rejected_invalid")
                    continue
                if now2 > r.deadline_mono:
                    self._finish(r, error=DeadlineExceeded(
                        f"request {r.req_id} exceeded its deadline during "
                        f"compute", late_by_s=now2 - r.deadline_mono,
                    ), outcome="deadline_exceeded")
                    continue
                frac = (0.0 if d_max <= thr
                        else self.model.drift_fraction(d))
                # a quarantine fraction > 1 is unreachable by construction
                # — the documented way to disable the drift gate
                if frac >= self.config.drift_quarantine_frac:
                    any_drift = True
                    quarantined_n += 1
                    self._quarantine_entry(r, frac, d)
                    self._finish(r, response=ServeResponse(
                        req_id=r.req_id, outcome="quarantined",
                        labels=None, distances=d, degraded=degraded,
                        quarantined=True, drift_fraction=frac,
                        latency_s=now2 - r.enqueued_mono,
                        batch_seq=self._batch_seq,
                        model_fp=self.model.fingerprint(),
                        trace_id=r.trace_id,
                    ), outcome="quarantined")
                    continue
                self._finish(r, response=ServeResponse(
                    req_id=r.req_id,
                    outcome="degraded" if degraded else "ok",
                    labels=lab, distances=d, degraded=degraded,
                    quarantined=False, drift_fraction=frac,
                    latency_s=now2 - r.enqueued_mono,
                    batch_seq=self._batch_seq,
                    model_fp=self.model.fingerprint(),
                    trace_id=r.trace_id,
                ), outcome="degraded" if degraded else "ok")
            if any_drift:
                self.stats.note_drift_batch(quarantined=quarantined_n)
        # guard bookkeeping = the batch's wall minus the classify call
        self.stats.add_consumed(
            max(time.perf_counter() - t_batch0 - batch_wall, 0.0)
        )

    def _finish(self, r: RequestHandle,
                response: Optional[ServeResponse] = None,
                error: Optional[BaseException] = None,
                outcome: str = "ok") -> None:
        """Resolve one request: stats outcome + a back-dated
        ``serve_request`` span so every request rides the trace; span
        and stats both carry the request's trace id."""
        latency = time.monotonic() - r.enqueued_mono
        self.stats.note_outcome(outcome, latency_s=latency,
                                trace_id=r.trace_id)
        try:
            tr = obs_trace.last_tracer()
            if tr is not None:
                attrs: Dict[str, Any] = dict(
                    outcome=outcome, n_cells=r.n, req_id=r.req_id,
                )
                if r.trace_id:
                    attrs["trace_id"] = r.trace_id
                tr.add_completed_span(
                    "serve_request", wall_s=latency, kind="detail",
                    **attrs,
                )
        except Exception:
            pass  # tracing must never cost a response
        r._resolve(response=response, error=error)

    def _quarantine_entry(self, r: RequestHandle, frac: float,
                          dist: np.ndarray) -> None:
        """Append one quarantine-ledger line: the request's identity, its
        drift fraction, and a distance-quantile fingerprint: enough for an
        operator to decide whether a re-consensus is warranted.
        Best-effort by contract: the response flag is the source of
        truth, the ledger is the audit trail."""
        if not self.quarantine_path:
            return
        d = np.asarray(dist, np.float64)
        entry = {
            "ts": round(time.time(), 3),
            "req_id": r.req_id,
            # joins this row to the response and the serve_request span
            "trace_id": r.trace_id,
            "n_cells": r.n,
            "drift_fraction": round(float(frac), 6),
            "threshold": round(float(self.model.drift_threshold), 6),
            "dist_q": [round(float(q), 6) for q in np.quantile(
                d, (0.1, 0.5, 0.9, 0.99)
            )] if d.size else [],
            "model_fp": self.model.fingerprint(),
        }
        # the quarantined cells beside the ledger (bounded by
        # SCC_SERVE_LEDGER_MAX_CELLS): a re-consensus needs the rows, not
        # only their distances. Ledger lines keep appending past the cap;
        # only the payloads stop.
        cells_file = self._save_quarantined_cells(r)
        if cells_file:
            entry["cells_file"] = cells_file
        try:
            with open(self.quarantine_path, "a") as f:
                f.write(json.dumps(entry) + "\n")
        except OSError:
            pass

    QUARANTINE_CELLS_DIR = QUARANTINE_CELLS_DIR  # module constant

    def _save_quarantined_cells(self, r: RequestHandle) -> Optional[str]:
        """Write one ``qcells_*.npy`` payload into the ledger dir's cells
        subdir; returns the ledger-relative path, or None (cap reached /
        write failed — the response flag and ledger line still stand)."""
        cap = int(env_flag("SCC_SERVE_LEDGER_MAX_CELLS"))
        if self._q_cells_saved + r.n > cap:
            return None
        base = os.path.dirname(os.path.abspath(self.quarantine_path))
        cdir = os.path.join(base, self.QUARANTINE_CELLS_DIR)
        self._q_seq += 1
        name = f"qcells_{os.getpid()}_{self._q_seq:06d}.npy"
        try:
            os.makedirs(cdir, exist_ok=True)
            with open(os.path.join(cdir, name), "wb") as f:
                np.save(f, np.asarray(r.cells, np.float32))
        except OSError:
            return None
        self._q_cells_saved += r.n
        return os.path.join(self.QUARANTINE_CELLS_DIR, name)

    # -- record ------------------------------------------------------------
    def serving_section(self) -> Dict[str, Any]:
        """The validated ``serving`` run-record section for this server's
        lifetime (``obs.export.build_run_record(serving=...)``)."""
        sec = self.stats.section()
        if self.quarantine_path and os.path.exists(self.quarantine_path):
            sec["drift"]["ledger_path"] = os.path.basename(
                self.quarantine_path
            )
        sec["model"] = {
            "fingerprint": self.model.fingerprint(),
            "k": self.model.k,
            "n_pcs": self.model.n_pcs,
            "deep_split": self.model.meta.get("deep_split"),
        }
        return sec
