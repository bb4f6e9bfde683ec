"""Nested-span tracer with explicit device-sync boundaries.

The port's copy of ``scconsensus_tpu/obs/trace.py:63-545``. A span
records its submitted wall (host dispatch time) and, for sync-eligible
spans, the device-synced wall: ``torch.cuda.synchronize`` drains the card
at the boundary, so queued kernels cannot land one span's compute on
whichever later span first blocks. Spans nest (``stage`` spans hold
``detail`` children); entering a span publishes its tracer to a
contextvar, so deep code opens child spans through the module-level
:func:`span` without threading a tracer through every signature, and with
no active tracer that is a no-op sink.

While a ``torch.profiler`` records, whoever opened it (a benchmark,
``SCC_OBS_KERNELS``, ``SCC_OBS_STALL_TRACE``), every span, a null span
too, is a ``torch.profiler.record_function(name)`` window, so span
windows appear in the profiler's timeline, on its clock, beside the CUDA
kernels they launched (the kernel capture, ``obs.kernels``, joins the
two). With no profiler recording a span pays one check of the profiler's
state and makes no ``record_function`` call. The run-record views are the
reference's: ``stage_records``, ``span_records``, ``open_stack``,
``live_span_records``, ``total_s``, ``as_dict`` and :func:`ambient_stage`.
``compile_stats`` aggregates the compile events since the tracer was
built (``obs.device``: the native libraries' builds, the port's only
compiles), so records carry ``device.compile`` as the reference's do.
``sample_device`` snapshots the card's allocator counters
(``obs.device.memory_snapshot``) at each synced span exit.
"""

from __future__ import annotations

import contextvars
import itertools
import json
import logging
import threading
import time
import weakref
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

from scconsensus_tpu_torch.config import env_flag

__all__ = [
    "Span",
    "Tracer",
    "span",
    "current_tracer",
    "current_span",
    "ambient_stage",
    "last_tracer",
    "device_drain",
    "profiling",
    "annotation",
    "summarize_record",
    "new_trace_id",
]


# Trace-id state: one random process prefix (minted lazily, ONE urandom
# syscall per process) + a monotone counter. Deliberately NOT uuid4 per
# request: os.urandom releases the GIL every call, which measurably
# perturbs the admission/worker scheduling the serve driver's
# backpressure behavior (and its tests) depend on — the telemetry plane
# must observe the system, not reschedule it.
_TRACE_PREFIX: Optional[str] = None
_TRACE_SEQ = itertools.count(1)


def new_trace_id() -> str:
    """Mint one request trace id (16 hex chars: an 8-hex process prefix
    and an 8-hex sequence), issued at the serving driver's admission and
    carried through the serve_request span, the quarantine ledger row and
    the stats' recent-request ring."""
    global _TRACE_PREFIX
    if _TRACE_PREFIX is None:
        import uuid

        _TRACE_PREFIX = uuid.uuid4().hex[:8]
    return f"{_TRACE_PREFIX}{next(_TRACE_SEQ) & 0xFFFFFFFF:08x}"

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "scc_active_tracer", default=None
)

# Most recently created tracer, for observers on other threads (the
# serving driver's worker cannot see the contextvar). A weakref: it must
# never keep a finished run's span tree alive.
_LAST_TRACER: "Optional[weakref.ref]" = None


def last_tracer() -> "Optional[Tracer]":
    """The most recently created (still-alive) tracer in this process, or
    None. Unlike :func:`current_tracer` it works from any thread (the
    serving driver stamps its ``serve_request`` spans through it)."""
    ref = _LAST_TRACER
    return ref() if ref is not None else None

_LOG_LIST_CAP = 16


def summarize_record(rec: Dict[str, Any]) -> Dict[str, Any]:
    """Log-line rendering of a record: long lists (e.g. the per-pair DE
    counts at K=44 → 946 entries) are summarized; the STORED record — what
    metrics/bench consumers read — keeps the full values. Recurses into
    nested dicts (the wilcox stage's ``occupancy`` probe carries a
    per-bucket list that can run tens of entries at 1M-cell shapes)."""
    out: Dict[str, Any] = {}
    for k, v in rec.items():
        if isinstance(v, dict):
            out[k] = summarize_record(v)
        elif isinstance(v, (list, tuple)) and len(v) > _LOG_LIST_CAP:
            out[k] = {
                "n": len(v),
                "head": list(v[:_LOG_LIST_CAP]),
                "sum": sum(v) if v and isinstance(v[0], (int, float)) else None,
            }
        else:
            out[k] = v
    return out


def device_drain() -> bool:
    """Block until every kernel queued on the card has retired
    (``torch.cuda.synchronize``). Returns False when torch is not imported
    or CUDA was never initialized in this process: nothing can be queued
    then, and a drain must not initialize a context of its own."""
    import sys

    torch = sys.modules.get("torch")
    if torch is None:
        return False
    try:
        if not torch.cuda.is_initialized():
            return False
        torch.cuda.synchronize()
        return True
    except Exception:
        return False


def profiling() -> bool:
    """True while a ``torch.profiler`` records in this process. Reads the
    profiler's state without importing torch: False when torch is not
    loaded."""
    import sys

    torch = sys.modules.get("torch")
    if torch is None:
        return False
    try:
        return bool(torch.autograd._profiler_enabled())
    except Exception:
        return False


def _enter_annotation(name: str):
    """An entered ``record_function(name)`` while a profiler records, else
    None (no ``record_function`` call)."""
    if not profiling():
        return None
    try:
        from torch.profiler import record_function

        ann = record_function(name)
        ann.__enter__()
        return ann
    except Exception:
        return None


@contextmanager
def annotation(name: str):
    """A profiler window named ``name`` around the block while a profiler
    records; nothing otherwise. For a timed region that is not a span
    (``utils.timing.StageClock``'s stages run with ``span=False``)."""
    ann = _enter_annotation(name)
    try:
        yield
    finally:
        if ann is not None:
            ann.__exit__(None, None, None)


_WARNED_SYNC_VALUES = set()


def _sync_mode() -> str:
    """Resolve the tracer sync policy from the env-flag registry:
    'stage' (default — drain at stage-span boundaries), 'all' (every
    span; diagnosis runs), or 'off' (dispatch intervals, the pre-obs
    behavior). Legacy SCC_STAGE_SYNC=1 forces at least 'stage'. An
    unrecognized value (e.g. a typo'd 'al') warns once and runs the
    default — a silent fallback would hand a diagnosis run dispatch
    walls and misattribute exactly what the subsystem exists to pin."""
    v = str(env_flag("SCC_TRACE_SYNC") or "").strip().lower()
    if v in ("off", "0", "none", "false", "no"):
        return "stage" if env_flag("SCC_STAGE_SYNC") else "off"
    if v == "all":
        return "all"
    if v not in ("", "stage", "1", "true", "on", "yes"):
        if v not in _WARNED_SYNC_VALUES:
            _WARNED_SYNC_VALUES.add(v)
            logging.getLogger("scconsensus_tpu_torch").warning(
                "unrecognized SCC_TRACE_SYNC=%r; using 'stage' "
                "(valid: stage|all|off)", v,
            )
    return "stage"


class Span:
    """One timed region. Dict-style access reads/writes ``attrs`` so legacy
    writers (``rec["union_size"] = ...``, the engine's ``probe_out`` sink)
    work on a Span exactly as they did on the old StageTimer record dict."""

    __slots__ = (
        "name", "span_id", "parent_id", "depth", "kind", "attrs",
        "t0_s", "wall_submitted_s", "wall_synced_s", "synced",
        "device_mem", "_metrics", "_token", "_t_enter",
    )

    def __init__(self, name: str, span_id: int, parent_id: Optional[int],
                 depth: int, kind: str, attrs: Dict[str, Any]):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.depth = depth
        self.kind = kind
        self.attrs = attrs
        self.t0_s = 0.0
        self.wall_submitted_s = 0.0
        self.wall_synced_s: Optional[float] = None
        self.synced = False
        self.device_mem: Optional[Dict[str, Any]] = None
        self._metrics = None
        self._token = None
        self._t_enter = 0.0

    # -- dict-style back-compat surface -----------------------------------
    def __setitem__(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def __getitem__(self, key: str) -> Any:
        return self.attrs[key]

    def __contains__(self, key: str) -> bool:
        return key in self.attrs

    def get(self, key: str, default: Any = None) -> Any:
        return self.attrs.get(key, default)

    def setdefault(self, key: str, default: Any = None) -> Any:
        return self.attrs.setdefault(key, default)

    def update(self, *a, **kw) -> None:
        self.attrs.update(*a, **kw)

    # -- typed metrics -----------------------------------------------------
    @property
    def metrics(self):
        """Lazily created :class:`~scconsensus_tpu_torch.obs.metrics.MetricSet`."""
        if self._metrics is None:
            from scconsensus_tpu_torch.obs.metrics import MetricSet

            self._metrics = MetricSet()
        return self._metrics

    # -- views -------------------------------------------------------------
    @property
    def wall_s(self) -> float:
        """Headline wall: device-synced when a sync ran, else submitted."""
        return (self.wall_synced_s if self.wall_synced_s is not None
                else self.wall_submitted_s)

    def stage_record(self) -> Dict[str, Any]:
        """Legacy StageTimer-shaped record (``{"stage", ..., "wall_s"}``)."""
        rec: Dict[str, Any] = {"stage": self.name, **self.attrs}
        rec["wall_s"] = round(self.wall_s, 4)
        rec["wall_submitted_s"] = round(self.wall_submitted_s, 4)
        if self.wall_synced_s is not None:
            rec["wall_synced_s"] = round(self.wall_synced_s, 4)
        if self.synced:
            rec["synced"] = True
        return rec

    def record(self) -> Dict[str, Any]:
        """Full span record (the run-record schema's ``spans[]`` entry)."""
        rec: Dict[str, Any] = {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "depth": self.depth,
            "kind": self.kind,
            "t0_s": round(self.t0_s, 6),
            "wall_submitted_s": round(self.wall_submitted_s, 6),
            "wall_synced_s": (round(self.wall_synced_s, 6)
                              if self.wall_synced_s is not None else None),
            "synced": self.synced,
        }
        if self.attrs:
            rec["attrs"] = self.attrs
        if self._metrics is not None and not self._metrics.empty():
            rec["metrics"] = self._metrics.to_dict()
        if self.device_mem is not None:
            rec["device_mem"] = self.device_mem
        return rec


class _NullSpan(Span):
    """Sink for module-level :func:`span` with no active tracer: accepts
    attrs/metrics, records nothing."""

    def __init__(self):
        super().__init__("<null>", -1, None, 0, "detail", {})


class Tracer:
    """Collects a span tree for one run.

    ``sync``: 'stage' | 'all' | 'off' (default from the SCC_TRACE_SYNC
    flag). ``annotate`` is the reference's argument and changes nothing:
    every span is a profiler window whenever a profiler records.
    ``sample_device=True`` snapshots the card's live and peak
    bytes at each synced span exit (None on the CPU). With a ``logger``,
    every finished stage span logs one summarized line.
    """

    def __init__(self, logger: Optional[logging.Logger] = None,
                 sync: Optional[str] = None, annotate: bool = False,
                 sample_device: bool = True):
        self.t_origin = time.perf_counter()
        self.spans: List[Span] = []          # finished spans, completion order
        self.logger = logger
        self.sync = sync if sync in ("stage", "all", "off") else _sync_mode()
        self.sample_device = sample_device
        # wall-clock of the last span enter/exit: a live reader's progress
        # signal
        self.last_transition_unix = time.time()
        self._stack: List[Span] = []
        self._ids = itertools.count()
        # per-stage-name entry counts: the Nth time a stage span named X
        # opens, _stage_entries[X] == N
        self._stage_entries: Dict[str, int] = {}
        self._lock = threading.Lock()
        global _LAST_TRACER
        _LAST_TRACER = weakref.ref(self)
        from scconsensus_tpu_torch.obs import device as obs_device

        obs_device.install_compile_listener()
        self._compile_mark = obs_device.compile_mark()

    # -- span lifecycle ----------------------------------------------------
    def drains(self, kind: str) -> bool:
        """Whether a span of ``kind`` drains the card at its boundaries
        (with no per-span override)."""
        if self.sync == "all":
            return True
        if self.sync == "stage":
            return kind == "stage"
        return False

    def _should_sync(self, kind: str, override: Optional[bool]) -> bool:
        return self.drains(kind) if override is None else override

    @contextmanager
    def span(self, name: str, kind: str = "stage",
             sync: Optional[bool] = None, **attrs: Any):
        with self._lock:
            parent = self._stack[-1] if self._stack else None
            sp = Span(
                name, next(self._ids),
                parent.span_id if parent is not None else None,
                len(self._stack), kind, dict(attrs),
            )
            self._stack.append(sp)
            if kind == "stage":
                self._stage_entries[name] = \
                    self._stage_entries.get(name, 0) + 1
            self.last_transition_unix = time.time()
        do_sync = self._should_sync(kind, sync)
        ann = _enter_annotation(name)
        if do_sync:
            # entry boundary: queued work from the PREDECESSOR retires now,
            # so it cannot be billed to this span
            device_drain()
        sp._token = _ACTIVE.set(self)
        sp._t_enter = time.perf_counter()
        sp.t0_s = sp._t_enter - self.t_origin
        try:
            yield sp
        finally:
            now = time.perf_counter()
            sp.wall_submitted_s = now - sp._t_enter
            if do_sync and device_drain():
                sp.synced = True
                sp.wall_synced_s = time.perf_counter() - sp._t_enter
            if sp.synced and self.sample_device:
                try:
                    from scconsensus_tpu_torch.obs import device as obs_device

                    sp.device_mem = obs_device.memory_snapshot()
                except Exception:
                    pass
            if ann is not None:
                ann.__exit__(None, None, None)
            _ACTIVE.reset(sp._token)
            with self._lock:
                if self._stack and self._stack[-1] is sp:
                    self._stack.pop()
                self.spans.append(sp)
                self.last_transition_unix = time.time()
            if self.logger is not None and kind == "stage":
                self.logger.info(
                    "stage %s",
                    json.dumps(summarize_record(sp.stage_record()),
                               default=str),
                )

    def add_completed_span(self, name: str, wall_s: float,
                           kind: str = "detail", synced: bool = False,
                           **attrs: Any) -> Span:
        """Synthesize an already-finished child span of the innermost open
        span, covering the ``wall_s`` seconds that just elapsed.

        For a region whose name or extent is known only at its end (the
        serving driver's ``serve_request``, back-dated from the request's
        latency). It never touches the open-span stack."""
        now_pc = time.perf_counter()
        with self._lock:
            parent = self._stack[-1] if self._stack else None
            sp = Span(
                name, next(self._ids),
                parent.span_id if parent is not None else None,
                parent.depth + 1 if parent is not None else 0,
                kind, dict(attrs),
            )
            sp.t0_s = max(now_pc - self.t_origin - wall_s, 0.0)
            sp._t_enter = sp.t0_s + self.t_origin
            sp.wall_submitted_s = wall_s
            if synced:
                sp.synced = True
                sp.wall_synced_s = wall_s
            self.spans.append(sp)
            self.last_transition_unix = time.time()
        return sp

    # -- views -------------------------------------------------------------
    def stage_records(self) -> List[Dict[str, Any]]:
        return [s.stage_record() for s in self.spans if s.kind == "stage"]

    def span_records(self) -> List[Dict[str, Any]]:
        return [s.record() for s in self.spans]

    def open_stack(self) -> List[Dict[str, Any]]:
        """Snapshot of the currently open spans, outermost first: name,
        kind, depth, span_id/parent_id, and the wall elapsed since entry.
        Thread-safe (a live reader calls it from its own thread while the
        run thread is mid-span)."""
        now = time.perf_counter()
        with self._lock:
            stack = list(self._stack)
        return [{
            "name": s.name,
            "span_id": s.span_id,
            "parent_id": s.parent_id,
            "depth": s.depth,
            "kind": s.kind,
            "elapsed_s": round(max(now - s._t_enter, 0.0), 4),
        } for s in stack]

    def live_span_records(self) -> List[Dict[str, Any]]:
        """Finished span records PLUS provisional records for still-open
        spans (wall = elapsed so far, ``synced`` False, ``attrs["open"]``
        True). A mid-run record built only from finished spans would carry
        dangling parent_ids (children of a still-open stage complete
        first) and lose what was running when the process died."""
        now = time.perf_counter()
        with self._lock:
            done = list(self.spans)
            stack = list(self._stack)
        out = [s.record() for s in done]
        for s in stack:
            out.append({
                "name": s.name,
                "span_id": s.span_id,
                "parent_id": s.parent_id,
                "depth": s.depth,
                "kind": s.kind,
                "t0_s": round(s.t0_s, 6),
                "wall_submitted_s": round(max(now - s._t_enter, 0.0), 6),
                "wall_synced_s": None,
                "synced": False,
                "attrs": {**s.attrs, "open": True},
            })
        return out

    def total_s(self) -> float:
        return sum(s.wall_s for s in self.spans if s.kind == "stage")

    def compile_stats(self) -> Optional[Dict[str, Any]]:
        """Compile events observed since this tracer was created: the
        native libraries built in that window (``obs.device``)."""
        from scconsensus_tpu_torch.obs import device as obs_device

        return obs_device.compile_stats(since=self._compile_mark)

    def as_dict(self) -> Dict[str, Any]:
        from scconsensus_tpu_torch.obs.export import (
            SCHEMA_NAME,
            SCHEMA_VERSION,
        )

        out: Dict[str, Any] = {
            "stages": self.stage_records(),
            "total_s": self.total_s(),
            "spans": self.span_records(),
            "schema": SCHEMA_NAME,
            "schema_version": SCHEMA_VERSION,
        }
        cs = self.compile_stats()
        if cs is not None:
            out["compile"] = cs
        return out


def current_tracer() -> Optional[Tracer]:
    """The tracer of the innermost active span, or None."""
    return _ACTIVE.get()


def current_span() -> Optional[Span]:
    """The innermost active span of the ambient tracer, or None."""
    tr = _ACTIVE.get()
    if tr is None:
        return None
    with tr._lock:
        return tr._stack[-1] if tr._stack else None


def ambient_stage() -> Tuple[Optional[str], int]:
    """``(stage_name, entry_ordinal)`` of the innermost open stage-kind
    span, or ``(None, 0)`` with no stage open. Contextvar first, then
    :func:`last_tracer`, so off-thread observers resolve the stage the
    run thread is in. Thread-safe; never raises.

    Reads a snapshot of the stack without the tracer's lock: the host
    profiler's ``gc.callbacks`` hook calls this, and a collection can
    start in a thread that already holds that (non-reentrant) lock, which
    would then wait on itself. ``tuple(list)`` is one step under the GIL."""
    tr = _ACTIVE.get()
    if tr is None:
        tr = last_tracer()
    if tr is None:
        return (None, 0)
    try:
        for s in reversed(tuple(tr._stack)):
            if s.kind == "stage":
                return (s.name, tr._stage_entries.get(s.name, 1))
    except Exception:
        pass
    return (None, 0)


@contextmanager
def span(name: str, kind: str = "detail", sync: Optional[bool] = None,
         **attrs: Any):
    """Open a child span on the ambient tracer (a sink that records
    nothing when none is active, but is still a profiler window while a
    profiler records) — the instrumentation entry point for deep engine
    code."""
    tr = _ACTIVE.get()
    if tr is None:
        with annotation(name):
            yield _NullSpan()
        return
    with tr.span(name, kind=kind, sync=sync, **attrs) as sp:
        yield sp
