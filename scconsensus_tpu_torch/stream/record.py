"""The validated ``streaming`` run-record section and its live feed.

The port's copy of ``scconsensus_tpu/stream/record.py`` (stdlib only, as
there). One section per out-of-core run::

    streaming: {
      chunks: {planned, completed, fresh, resumed, recomputed,
               quarantined},
      window: {initial_rows, final_rows, halvings},
      ckpt:   {initial_every, final_every},      # ENOSPC degradation
      budget: {limit_mb, stage_limit_mb, baseline_rss_mb, peak_rss_mb,
               peak_staged_mb, within_budget, budget_mb?},
      complete: bool,
    }

The port's accountant judges a run by the budget over the process's
baseline RSS (``stream.budget``): ``limit_mb`` is baseline + budget, and
the extra key ``budget_mb`` the budget itself, so both packages'
validators read the same claim.

Validation contract:

  * **bounded memory needs evidence**: ``budget.within_budget: true``
    without a numeric ``peak_rss_mb``, or with ``peak_rss_mb`` over
    ``limit_mb``, is rejected (the peak is ``ru_maxrss`` via
    ``obs.device.host_peak_rss_bytes``);
  * **chunk counts must sum**: ``completed`` equals ``fresh + resumed``,
    ``recomputed`` does not exceed ``quarantined`` and implies
    ``fresh >= 1``, and ``complete: true`` requires ``completed ==
    planned``.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional

__all__ = [
    "build_streaming_section",
    "validate_streaming",
    "set_active",
    "live_summary",
]


def build_streaming_section(
    planned: int, fresh: int, resumed: int, recomputed: int,
    quarantined: int, window_initial: int, window_final: int,
    halvings: int, ckpt_initial: int, ckpt_final: int,
    limit_mb: float, stage_limit_mb: float,
    baseline_rss_mb: Optional[float], peak_rss_mb: Optional[float],
    peak_staged_mb: float, complete: bool,
    budget_mb: Optional[float] = None,
) -> Dict[str, Any]:
    """Assemble one schema-conforming section (the single construction
    point, so the field list cannot drift from the validator).
    ``within_budget`` is COMPUTED here, never asserted by the caller — a
    run with no peak evidence gets ``within_budget: false`` by
    construction. ``budget_mb`` (the port's accountant) is the budget
    over the baseline RSS whose sum is ``limit_mb``; the key is left out
    when not given, as the reference's builder has none."""
    peak_ok = isinstance(peak_rss_mb, (int, float))
    sec = {
        "chunks": {
            "planned": int(planned),
            "completed": int(fresh) + int(resumed),
            "fresh": int(fresh),
            "resumed": int(resumed),
            "recomputed": int(recomputed),
            "quarantined": int(quarantined),
        },
        "window": {
            "initial_rows": int(window_initial),
            "final_rows": int(window_final),
            "halvings": int(halvings),
        },
        "ckpt": {
            "initial_every": int(ckpt_initial),
            "final_every": int(ckpt_final),
        },
        "budget": {
            "limit_mb": round(float(limit_mb), 3),
            "stage_limit_mb": round(float(stage_limit_mb), 3),
            "baseline_rss_mb": (round(float(baseline_rss_mb), 3)
                                if baseline_rss_mb is not None else None),
            "peak_rss_mb": (round(float(peak_rss_mb), 3)
                            if peak_ok else None),
            "peak_staged_mb": round(float(peak_staged_mb), 3),
            "within_budget": bool(
                peak_ok and float(peak_rss_mb) <= float(limit_mb)
            ),
        },
        "complete": bool(complete),
    }
    if budget_mb is not None:
        sec["budget"]["budget_mb"] = round(float(budget_mb), 3)
    return sec


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"streaming section: {msg}")


def _nonneg_int(v: Any, name: str) -> int:
    _require(isinstance(v, int) and v >= 0,
             f"{name} must be an int >= 0, got {v!r}")
    return v


def validate_streaming(sm: Dict[str, Any]) -> None:
    """Structural validation of a record's ``streaming`` section;
    the soak worker and the streaming runner call it. The two
    load-bearing rules, bounded-memory-needs-evidence and
    chunk-counts-must-sum, are spelled out in the module docstring; their
    rejection messages name the rule, as the reference's do."""
    _require(isinstance(sm, dict), "must be an object")
    ch = sm.get("chunks")
    _require(isinstance(ch, dict), "chunks must be an object")
    planned = _nonneg_int(ch.get("planned"), "chunks.planned")
    completed = _nonneg_int(ch.get("completed"), "chunks.completed")
    fresh = _nonneg_int(ch.get("fresh"), "chunks.fresh")
    resumed = _nonneg_int(ch.get("resumed"), "chunks.resumed")
    recomputed = _nonneg_int(ch.get("recomputed"), "chunks.recomputed")
    quarantined = _nonneg_int(ch.get("quarantined"), "chunks.quarantined")
    _require(
        completed == fresh + resumed,
        "chunk counts do not sum: completed must equal fresh + resumed "
        f"(got completed={completed}, fresh={fresh}, resumed={resumed}) "
        "— a chunk was either computed this run or adopted from a "
        "durable checkpoint, anything else is a lost chunk",
    )
    _require(completed <= planned,
             f"chunk counts do not sum: completed ({completed}) exceeds "
             f"planned ({planned})")
    _require(recomputed <= quarantined,
             f"chunk counts do not sum: recomputed ({recomputed}) exceeds "
             f"quarantined ({quarantined}) — a recompute without a "
             "quarantine is a phantom corruption")
    if recomputed:
        _require(fresh >= 1,
                 "chunk counts do not sum: recomputed chunks claimed "
                 "with fresh == 0 — every recompute is fresh work")
    if sm.get("complete"):
        _require(completed == planned,
                 "complete claimed with completed != planned "
                 f"({completed} != {planned})")
    win = sm.get("window")
    _require(isinstance(win, dict), "window must be an object")
    wi = _nonneg_int(win.get("initial_rows"), "window.initial_rows")
    wf = _nonneg_int(win.get("final_rows"), "window.final_rows")
    _require(wi >= 1 and wf >= 1, "window rows must be >= 1")
    _require(wf <= wi, "window.final_rows must be <= initial_rows "
                       "(recovery only ever shrinks the window)")
    _nonneg_int(win.get("halvings"), "window.halvings")
    ck = sm.get("ckpt")
    _require(isinstance(ck, dict), "ckpt must be an object")
    ci = _nonneg_int(ck.get("initial_every"), "ckpt.initial_every")
    cf = _nonneg_int(ck.get("final_every"), "ckpt.final_every")
    _require(cf >= ci >= 1, "ckpt granularity only ever coarsens "
                            "(final_every >= initial_every >= 1)")
    bud = sm.get("budget")
    _require(isinstance(bud, dict), "budget must be an object")
    lim = bud.get("limit_mb")
    _require(isinstance(lim, (int, float)) and lim > 0,
             "budget.limit_mb must be a positive number")
    peak = bud.get("peak_rss_mb")
    _require(peak is None or (isinstance(peak, (int, float)) and peak >= 0),
             "budget.peak_rss_mb must be a number >= 0 or null")
    if bud.get("within_budget"):
        _require(
            isinstance(peak, (int, float)),
            "within_budget claimed without RSS evidence (peak_rss_mb "
            "missing) — a record claiming bounded memory must carry the "
            "peak it is bounded BY",
        )
        _require(
            float(peak) <= float(lim),
            f"within_budget claimed with peak RSS over budget "
            f"(peak_rss_mb={peak} > limit_mb={lim}) — the claim "
            "contradicts its own evidence",
        )


# --------------------------------------------------------------------------
# live feed
# --------------------------------------------------------------------------

_LOCK = threading.Lock()
_ACTIVE_FN: Optional[Callable[[], Optional[Dict[str, Any]]]] = None


def set_active(summary_fn: Optional[Callable[[], Optional[Dict[str, Any]]]]
               ) -> None:
    """Register the live streaming summary source (the runner's
    accountant registers on entry, clears on exit). The reference's
    heartbeat snapshots it; the port has no heartbeat yet, so only
    :func:`live_summary` reads it."""
    global _ACTIVE_FN
    with _LOCK:
        _ACTIVE_FN = summary_fn


def live_summary() -> Optional[Dict[str, Any]]:
    fn = _ACTIVE_FN
    if fn is None:
        return None
    try:
        return fn()
    except Exception:
        return None
