"""Per-stage compile telemetry → the ``compile`` section.

The port's copy of ``scconsensus_tpu/obs/compilelog.py``. The pure half
is the reference's, unchanged: :func:`build_compile_section` folds the
captured ``(name, secs, stage, entry_ordinal)`` events into the section
(compiles, traces, retraces, cache hits, compile wall, by event and by
stage), :func:`validate_compile` checks one, :func:`event_kind` classifies
an event name. Zero events with an armed log is an honest section of
zeros: "this run compiled nothing" is evidence, not absence.

The runtime half (:func:`install_and_mark`, :func:`armed`,
:func:`snapshot`) sits over ``obs.device``'s event stream, which in the
port carries the native libraries' builds: the CUDA kernel's nvcc build
and the Ward library's g++ build are ``backend`` events with their
seconds, a library found built is a cache hit, each stamped with the
stage that first loaded it (on a fresh process the kernel's in
``silhouette``, Ward's in ``tree``). A trace-shaped event never occurs:
eager torch traces nothing, so ``traces`` and ``retraces`` stay 0.
Gated by ``SCC_COMPILELOG``; the caller arms it (the reference's bench
worker does, not ``refine()``).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Sequence

from scconsensus_tpu_torch.config import env_flag
from scconsensus_tpu_torch.obs.hostprof import OUTSIDE_SPANS

__all__ = [
    "COMPILELOG_VERSION",
    "build_compile_section",
    "validate_compile",
    "install_and_mark",
    "armed",
    "snapshot",
    "event_kind",
]

COMPILELOG_VERSION = 1


def _norm_key(k: str) -> str:
    # lowercase, collapse non-alnum runs to one underscore: the
    # reference's spelling-drift armor, kept so both packages key events
    # alike
    out = []
    for ch in str(k).strip().lower():
        if ch.isalnum():
            out.append(ch)
        elif not out or out[-1] != "_":
            out.append("_")
    return "".join(out).strip("_")


def event_kind(name: str) -> str:
    """Classify one duration-event name: ``backend`` (a compile),
    ``trace`` (a trace or lowering), or ``other`` compilation-shaped work.
    Normalized-spelling match, so ``backend_compile`` and a
    ``backendCompile`` respelling classify identically; the port's native
    builds (``scc/native/<library>_backend_compile``) are ``backend``."""
    # match on the separator-stripped spelling too: a camelCase respell
    # ("backendCompile") has no non-alnum run for _norm_key to collapse
    flat = _norm_key(name).replace("_", "")
    if "backendcompile" in flat:
        return "backend"
    if "trace" in flat:
        return "trace"
    return "other"


def build_compile_section(
    dur_events: Iterable[Sequence],
    cache_hits: int = 0,
) -> Dict[str, Any]:
    """``compile`` section from captured duration events.

    ``dur_events``: ``(name, secs[, stage|None[, entry_ordinal]])``
    tuples as :func:`obs.device.compile_events` returns them (bare
    2-tuples — the legacy capture shape — default to no stage, first
    entry). Zero events with an armed log is an honest section of
    zeros: "this run compiled nothing" is evidence, not absence."""
    events = compiles = traces = retraces = 0
    wall = 0.0
    by_event: Dict[str, Dict[str, Any]] = {}
    by_stage: Dict[str, Dict[str, Any]] = {}
    for ev in dur_events:
        name, secs = str(ev[0]), float(ev[1])
        stage = (ev[2] if len(ev) > 2 and ev[2] else OUTSIDE_SPANS)
        occ = int(ev[3]) if len(ev) > 3 and ev[3] else 1
        kind = event_kind(name)
        events += 1
        wall += secs
        is_retrace = kind == "trace" and occ >= 2
        if kind == "backend":
            compiles += 1
        elif kind == "trace":
            traces += 1
            if is_retrace:
                retraces += 1
        be = by_event.setdefault(_norm_key(name), {"n": 0, "total_s": 0.0})
        be["n"] += 1
        be["total_s"] += secs
        bs = by_stage.setdefault(stage, {
            "events": 0, "compiles": 0, "retraces": 0, "total_s": 0.0,
        })
        bs["events"] += 1
        bs["total_s"] += secs
        if kind == "backend":
            bs["compiles"] += 1
        if is_retrace:
            bs["retraces"] += 1
    for row in by_event.values():
        row["total_s"] = round(row["total_s"], 6)
    for row in by_stage.values():
        row["total_s"] = round(row["total_s"], 6)
    return {
        "version": COMPILELOG_VERSION,
        "events": events,
        "compiles": compiles,
        "traces": traces,
        "retraces": retraces,
        "cache_hits": int(cache_hits),
        "compile_wall_s": round(wall, 6),
        "by_event": {k: by_event[k] for k in sorted(by_event)},
        "by_stage": {k: by_stage[k] for k in sorted(by_stage)},
    }


# --------------------------------------------------------------------------
# runtime: arm the listeners, mark the stream, snapshot at finalize
# --------------------------------------------------------------------------

# dur_mark/cache_mark are positions in obs.device's process-wide event
# streams at arm time, so a worker's section counts only its own run
_STATE: Dict[str, Any] = {"armed": False, "dur_mark": 0, "cache_mark": 0}


def install_and_mark(force: bool = False) -> bool:
    """Arm compile logging: open obs.device's event stream (once per
    process) and mark it. Gated on ``SCC_COMPILELOG`` unless ``force``.
    Returns whether the log is armed."""
    if not force and not env_flag("SCC_COMPILELOG"):
        return False
    from scconsensus_tpu_torch.obs import device as obs_device

    if not obs_device.install_compile_listener():
        return False
    _STATE["armed"] = True
    _STATE["dur_mark"] = obs_device.compile_mark()
    _STATE["cache_mark"] = obs_device.cache_mark()
    return True


def armed() -> bool:
    return bool(_STATE["armed"])


def snapshot(dur_mark: Optional[int] = None,
             cache_mark: Optional[int] = None) -> Optional[Dict[str, Any]]:
    """The ``compile`` section for events since the arm marks (explicit
    marks override, for tests that scope to their own window). None
    when the log was never armed — the record omits the section rather
    than claim a run that wasn't listening compiled nothing."""
    if dur_mark is None and not _STATE["armed"]:
        return None
    from scconsensus_tpu_torch.obs import device as obs_device

    dm = _STATE["dur_mark"] if dur_mark is None else int(dur_mark)
    cm = _STATE["cache_mark"] if cache_mark is None else int(cache_mark)
    return build_compile_section(
        obs_device.compile_events(since=dm),
        cache_hits=len(obs_device.cache_events(since=cm)),
    )


# --------------------------------------------------------------------------
# validation (export.validate_run_record dispatches here)
# --------------------------------------------------------------------------

def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"compile section: {msg}")


def validate_compile(sec: Dict[str, Any]) -> None:
    """Structural validation of a record's ``compile`` section
    (additive scc-run-record v1 extension)."""
    _require(isinstance(sec, dict), "must be an object")
    _require(sec.get("version") == COMPILELOG_VERSION,
             f"version must be {COMPILELOG_VERSION}")
    for k in ("events", "compiles", "traces", "retraces", "cache_hits"):
        v = sec.get(k)
        _require(isinstance(v, int) and v >= 0,
                 f"{k} must be an int >= 0")
    _require(sec["compiles"] + sec["traces"] <= sec["events"],
             "compiles + traces exceed total events")
    _require(sec["retraces"] <= sec["traces"],
             "more retraces than traces")
    w = sec.get("compile_wall_s")
    _require(isinstance(w, (int, float)) and w >= 0,
             "compile_wall_s must be a number >= 0")
    be = sec.get("by_event")
    _require(isinstance(be, dict), "by_event must be an object")
    n_sum = 0
    for name, row in be.items():
        _require(isinstance(row, dict), f"by_event[{name!r}] not an object")
        n = row.get("n")
        _require(isinstance(n, int) and n >= 1,
                 f"by_event[{name!r}].n must be an int >= 1")
        n_sum += n
        t = row.get("total_s")
        _require(isinstance(t, (int, float)) and t >= 0,
                 f"by_event[{name!r}].total_s must be >= 0")
    _require(n_sum == sec["events"],
             "by_event counts do not sum to events")
    bs = sec.get("by_stage")
    _require(isinstance(bs, dict), "by_stage must be an object")
    ev_sum = 0
    for name, row in bs.items():
        _require(isinstance(row, dict), f"by_stage[{name!r}] not an object")
        for k in ("events", "compiles", "retraces"):
            v = row.get(k)
            _require(isinstance(v, int) and v >= 0,
                     f"by_stage[{name!r}].{k} must be an int >= 0")
        _require(row["compiles"] + row["retraces"] <= row["events"],
                 f"by_stage[{name!r}] counts exceed its events")
        ev_sum += row["events"]
        t = row.get("total_s")
        _require(isinstance(t, (int, float)) and t >= 0,
                 f"by_stage[{name!r}].total_s must be >= 0")
    _require(ev_sum == sec["events"],
             "by_stage events do not sum to events")
