"""Per-run robustness log and the validated ``robustness`` section.

The port's copy of ``scconsensus_tpu/robust/record.py`` (stdlib only).
One module-level :class:`RunLog` per run (``begin_run()`` resets it);
fault injection, retries, the artifact store's quarantine and the
serving driver's degraded path append through the module functions. The
log becomes the section::

    robustness: {
      faults_injected: [{site, class, seq}],
      retries:      [{site, error_class, attempts, recovered, backoff_s}],
      degradations: [{site, action, detail}],
      resume_points: [{stage, unit, completed, total}],
      mesh_transitions: [{stage, from_devices, to_devices,
                          recovered_state_bytes, cause}],
      recovered: bool,
      budget: {limit, used},
      consumed_s: float,
    }

:func:`validate_robustness` rejects ``recovered: true`` without evidence
(a recovered retry, a resume point or a mesh transition) and a mesh
transition whose device set does not shrink.

Budget persistence: with an artifact store active, ``refine()`` arms
``set_budget_persist`` so every consumed retry lands in the store's
``robust_state`` sidecar, and a resumed run re-seeds ``budget_used``
from it (``restore_budget``) instead of refreshing the allowance. The
heartbeat's ``live_summary`` waits for the live recorder.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from scconsensus_tpu_torch.config import env_flag

__all__ = [
    "RunLog",
    "begin_run",
    "current_run",
    "note_fault",
    "note_retry",
    "note_degradation",
    "note_resume_point",
    "note_mesh_transition",
    "add_consumed",
    "section",
    "live_summary",
    "validate_robustness",
]

# capped: a retry storm must not grow a run record without bound (the
# counts stay exact; only the event lists truncate)
_LIST_CAP = 64


class RunLog:
    """Append-only robustness trail for one run (thread-safe: retries can
    fire from worker threads; the heartbeat sampler reads live)."""

    def __init__(self) -> None:
        self.faults: List[Dict[str, Any]] = []
        self.retries: List[Dict[str, Any]] = []
        self.degradations: List[Dict[str, Any]] = []
        self.resume_points: List[Dict[str, Any]] = []
        self.mesh_transitions: List[Dict[str, Any]] = []
        self.budget_limit = int(env_flag("SCC_ROBUST_BUDGET"))
        self.budget_used = 0
        self.consumed_s = 0.0
        self._n_dropped = 0
        self._budget_persist = None  # set_budget_persist
        self._lock = threading.Lock()

    def _append(self, lst: List[Dict[str, Any]], item: Dict[str, Any]):
        with self._lock:
            if len(lst) < _LIST_CAP:
                lst.append(item)
            else:
                self._n_dropped += 1

    def budget_take(self) -> bool:
        """Consume one retry from the per-run budget; False = exhausted
        (the caller must re-raise instead of retrying). Every take is
        mirrored through the persist hook (when armed), so a killed run
        cannot come back with a fresh allowance."""
        with self._lock:
            if self.budget_used >= self.budget_limit:
                return False
            self.budget_used += 1
            used, persist = self.budget_used, self._budget_persist
        if persist is not None:
            try:  # durability must not become a new failure mode
                persist(used)
            except Exception:
                pass
        return True

    def restore_budget(self, used: int) -> None:
        """Seed ``budget_used`` from a persisted resume checkpoint; takes
        the max, so a restore can never lower the count."""
        with self._lock:
            self.budget_used = max(self.budget_used, int(used))

    def set_budget_persist(self, fn) -> None:
        """Arm ``fn(used)`` to run after every budget take (the pipeline
        points it at the artifact store's robust_state sidecar)."""
        with self._lock:
            self._budget_persist = fn

    def empty(self) -> bool:
        return not (self.faults or self.retries or self.degradations
                    or self.resume_points or self.mesh_transitions
                    or self.budget_used)

    def section(self) -> Optional[Dict[str, Any]]:
        """The run record's ``robustness`` section, or None when nothing
        robustness-related happened (healthy runs carry no section —
        absence IS the healthy signal, and zero bytes of overhead)."""
        with self._lock:
            if self.empty():
                return None
            recovered = (
                any(r.get("recovered") for r in self.retries)
                or bool(self.resume_points)
                or bool(self.mesh_transitions)
            )
            out: Dict[str, Any] = {
                "faults_injected": [dict(f) for f in self.faults],
                "retries": [dict(r) for r in self.retries],
                "degradations": [dict(d) for d in self.degradations],
                "resume_points": [dict(p) for p in self.resume_points],
                "recovered": recovered,
                "budget": {"limit": self.budget_limit,
                           "used": self.budget_used},
                "consumed_s": round(self.consumed_s, 4),
            }
            if self.mesh_transitions:
                # absent on mesh-stable runs: the list only exists when
                # elastic execution actually moved the run between meshes
                out["mesh_transitions"] = [
                    dict(t) for t in self.mesh_transitions
                ]
            if self._n_dropped:
                out["events_dropped"] = self._n_dropped
            return out


_RUN: Optional[RunLog] = None


def begin_run() -> RunLog:
    """Fresh log for a new run (refine()/bench worker entry)."""
    global _RUN
    _RUN = RunLog()
    return _RUN


def current_run() -> RunLog:
    """The active run's log, lazily created so engine-level retries
    outside a pipeline (direct pairwise_de callers, devcache in tests)
    still record somewhere."""
    global _RUN
    if _RUN is None:
        _RUN = RunLog()
    return _RUN


def note_fault(site: str, fclass: str, seq: int = 0) -> None:
    current_run()._append(current_run().faults,
                          {"site": site, "class": fclass, "seq": int(seq)})


def note_retry(site: str, error_class: str, attempts: int,
               recovered: bool, backoff_s: float) -> None:
    current_run()._append(current_run().retries, {
        "site": site, "error_class": error_class,
        "attempts": int(attempts), "recovered": bool(recovered),
        "backoff_s": round(float(backoff_s), 4),
    })


def note_degradation(site: str, action: str, detail: str = "") -> None:
    current_run()._append(current_run().degradations, {
        "site": site, "action": action, "detail": detail,
    })


def note_resume_point(stage: str, unit: str, completed: int,
                      total: int) -> None:
    """Record that ``stage`` re-entered from persisted mid-stage state:
    ``completed`` of ``total`` ``unit``s were loaded instead of
    recomputed. This is the evidence ``recovered: true`` requires."""
    current_run()._append(current_run().resume_points, {
        "stage": stage, "unit": unit,
        "completed": int(completed), "total": int(total),
    })


def note_mesh_transition(stage: str, from_devices, to_devices,
                         recovered_state_bytes: int = 0,
                         cause: str = "device_loss") -> None:
    """Record an elastic mesh transition: the run moved from the
    ``from_devices`` mesh onto the smaller ``to_devices`` mesh at
    ``stage`` — either in-process (a lost device, cause="device_loss")
    or across a checkpoint boundary (a shape-polymorphic resume onto a
    smaller mesh, cause="resume"). ``recovered_state_bytes`` counts the
    live sharded state re-laid-out / checkpoint bytes re-adopted."""
    current_run()._append(current_run().mesh_transitions, {
        "stage": stage,
        "from_devices": [int(d) for d in from_devices],
        "to_devices": [int(d) for d in to_devices],
        "recovered_state_bytes": int(recovered_state_bytes),
        "cause": str(cause),
    })


def add_consumed(dt: float) -> None:
    run = current_run()
    with run._lock:
        run.consumed_s += max(float(dt), 0.0)


class timed:
    """``with timed():`` accumulates the block's wall onto the run's
    self-measured overhead (the <2% zero-fault guard reads it)."""

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        add_consumed(time.perf_counter() - self._t0)
        return False


def section() -> Optional[Dict[str, Any]]:
    return _RUN.section() if _RUN is not None else None


def live_summary() -> Optional[Dict[str, Any]]:
    """Compact counters for one heartbeat tick (None = nothing to say)."""
    run = _RUN
    if run is None or run.empty():
        return None
    with run._lock:
        out: Dict[str, Any] = {}
        if run.faults:
            out["faults"] = len(run.faults)
        if run.retries:
            out["retries"] = len(run.retries)
            out["last_retry"] = dict(run.retries[-1])
        if run.degradations:
            out["degradations"] = len(run.degradations)
        if run.resume_points:
            out["resumes"] = len(run.resume_points)
        if run.mesh_transitions:
            # live mesh panel: current device count = the latest
            # transition's destination
            last = run.mesh_transitions[-1]
            out["mesh"] = {
                "transitions": len(run.mesh_transitions),
                "devices": len(last.get("to_devices") or []),
                "path": " → ".join(
                    [str(len(run.mesh_transitions[0].get("from_devices")
                             or []))]
                    + [str(len(t.get("to_devices") or []))
                       for t in run.mesh_transitions]
                ),
            }
        return out or None


# --------------------------------------------------------------------------
# schema validation
# --------------------------------------------------------------------------

_ERROR_CLASSES = ("transient", "resource", "disk", "silent_corruption",
                  "device_lost", "fatal")
_TRANSITION_CAUSES = ("device_loss", "resume")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"robustness section: {msg}")


def validate_robustness(rb: Dict[str, Any]) -> None:
    """Structural validation of a record's ``robustness`` section;
    ``export.validate_run_record`` calls this. The load-bearing rule: a
    section claiming ``recovered: true`` must carry evidence — at least
    one recovered retry or one resume point — or it is rejected."""
    from scconsensus_tpu_torch.robust.faults import FAULT_CLASSES

    _require(isinstance(rb, dict), "must be an object")
    for key in ("faults_injected", "retries", "degradations",
                "resume_points", "mesh_transitions"):
        v = rb.get(key, [])
        _require(isinstance(v, list), f"{key} must be a list")
        for i, item in enumerate(v):
            _require(isinstance(item, dict), f"{key}[{i}] must be an object")
    for i, f in enumerate(rb.get("faults_injected", [])):
        _require(bool(f.get("site")), f"faults_injected[{i}] missing site")
        _require(f.get("class") in FAULT_CLASSES,
                 f"faults_injected[{i}].class must be one of "
                 f"{FAULT_CLASSES}, got {f.get('class')!r}")
    for i, r in enumerate(rb.get("retries", [])):
        _require(bool(r.get("site")), f"retries[{i}] missing site")
        _require(r.get("error_class") in _ERROR_CLASSES,
                 f"retries[{i}].error_class must be one of "
                 f"{_ERROR_CLASSES}, got {r.get('error_class')!r}")
        att = r.get("attempts")
        _require(isinstance(att, int) and att >= 1,
                 f"retries[{i}].attempts must be an int >= 1")
        _require(isinstance(r.get("recovered"), bool),
                 f"retries[{i}].recovered must be a bool")
    for i, d in enumerate(rb.get("degradations", [])):
        _require(bool(d.get("site")) and bool(d.get("action")),
                 f"degradations[{i}] needs site and action")
    for i, p in enumerate(rb.get("resume_points", [])):
        _require(bool(p.get("stage")), f"resume_points[{i}] missing stage")
        comp, tot = p.get("completed"), p.get("total")
        _require(isinstance(comp, int) and comp >= 0,
                 f"resume_points[{i}].completed must be an int >= 0")
        _require(isinstance(tot, int) and tot >= comp,
                 f"resume_points[{i}].total must be an int >= completed")
    for i, t in enumerate(rb.get("mesh_transitions", [])):
        where = f"mesh_transitions[{i}]"
        _require(bool(t.get("stage")), f"{where} missing stage")
        src, dst = t.get("from_devices"), t.get("to_devices")
        _require(isinstance(src, list) and isinstance(dst, list),
                 f"{where}: from_devices/to_devices must be lists")
        _require(len(dst) >= 1, f"{where}: to_devices must be non-empty "
                                "(a mesh cannot shrink to zero devices)")
        # the shrink rule: elastic recovery only ever moves onto
        # SURVIVORS, so the destination must be a strict subset of the
        # source — anything else (growth, disjoint sets, same set) is a
        # corrupted or fabricated transition, not recovery evidence
        _require(
            set(dst) < set(src),
            f"{where}: device sets must shrink (to_devices must be a "
            f"proper subset of from_devices; got {src} -> {dst})",
        )
        rsb = t.get("recovered_state_bytes", 0)
        _require(isinstance(rsb, int) and rsb >= 0,
                 f"{where}.recovered_state_bytes must be an int >= 0")
        cause = t.get("cause", "device_loss")
        _require(cause in _TRANSITION_CAUSES,
                 f"{where}.cause must be one of {_TRANSITION_CAUSES}, "
                 f"got {cause!r}")
    if rb.get("recovered"):
        has_evidence = (
            any(r.get("recovered") for r in rb.get("retries", []))
            or bool(rb.get("resume_points"))
            or bool(rb.get("mesh_transitions"))
        )
        _require(
            has_evidence,
            "recovered claimed without evidence (no recovered retry and "
            "resume_points empty) — a run cannot claim survival it never "
            "demonstrated",
        )
    budget = rb.get("budget")
    if budget is not None:
        _require(isinstance(budget, dict), "budget must be an object")
        lim, used = budget.get("limit"), budget.get("used")
        _require(isinstance(lim, int) and lim >= 0,
                 "budget.limit must be an int >= 0")
        _require(isinstance(used, int) and 0 <= used,
                 "budget.used must be an int >= 0")
    orch = rb.get("orchestration")
    if orch is not None:
        _require(isinstance(orch, dict), "orchestration must be an object")
        _require(isinstance(orch.get("attempts", []), list),
                 "orchestration.attempts must be a list")
