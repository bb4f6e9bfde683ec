"""Unified per-run profile + residency burn-down.

A copy of ``scconsensus_tpu/obs/profile.py`` (pure over already-built
sections; the tests pin it equal to the reference on the same inputs).
In the port the ``cost`` column is ``obs.cost``'s dispatch count and
``device_s`` comes from the ``kernels`` section's ``vs_cost_model``
block (``torch.profiler`` device time per stage).

The run record grew four disjoint perf sections — stage walls
(obs.trace spans), static FLOPs/bytes (obs.cost), device-kernel
timelines (obs.kernels), and host↔device crossings (obs.residency) —
and no tool joined them, so a regression read as "headline slower"
with the evidence scattered across sections that only a human could
correlate. This module computes the join once, at record-build time:

* :func:`build_profile` — one row per stage span unifying wall time,
  device time, cost-model FLOPs/bytes, achieved rates (vs. an optional
  measured ceiling), and transfer bytes, plus one row per declared
  residency boundary. Attached to records as the ``profile`` section.
* :func:`build_burndown` — the residency burn-down ledger: bytes
  crossed per declared boundary with the ``TODO(item-2)`` boundaries
  (the device-residency refactor's work list) totalled separately, so
  item 1's fusion progress is a ratcheting number, not a TODO grep.
  Attached as the ``residency_burndown`` section.

Both are pure functions of already-collected sections — no new
instrumentation runs, so the attribution overhead is a dict join
(pinned by test inside a noise band). Sections are additive
scc-run-record v1 extensions; ``export.validate_run_record`` calls the
validators here.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from scconsensus_tpu_torch.obs.residency import BOUNDARIES

__all__ = [
    "ITEM2_BOUNDARIES",
    "build_profile",
    "build_burndown",
    "profile_sections_of",
    "validate_profile",
    "validate_residency_burndown",
]

PROFILE_VERSION = 1

# The device-residency refactor's work list: boundaries whose in-code
# justification carries a TODO(item-2) marker. Derived from the
# allowlist itself so declaring (or retiring) a boundary updates the
# burn-down denominator automatically — a hand-kept copy here would rot
# the first time residency.BOUNDARIES moves.
ITEM2_BOUNDARIES = frozenset(
    name for name, why in BOUNDARIES.items() if "TODO(item-2)" in why
)


def _stage_walls(spans: List[Dict[str, Any]]) -> Dict[str, float]:
    """Headline wall per stage name (synced preferred), repeated stages
    summed — mirrors ledger.stage_walls so profile rows and manifest
    stamps can never disagree on what a stage's wall is."""
    out: Dict[str, float] = {}
    for s in spans:
        if not isinstance(s, dict) or s.get("kind") != "stage":
            continue
        name = s.get("name")
        if not isinstance(name, str):
            continue
        wall = s.get("wall_synced_s")
        if wall is None:
            wall = s.get("wall_submitted_s")
        if isinstance(wall, (int, float)) and wall >= 0:
            out[name] = out.get(name, 0.0) + float(wall)
    return out


def build_profile(
    spans: Optional[List[Dict[str, Any]]],
    kernels: Optional[Dict[str, Any]] = None,
    cost: Optional[Dict[str, Dict[str, Any]]] = None,
    residency: Optional[Dict[str, Any]] = None,
    ceilings: Optional[Dict[str, float]] = None,
) -> Optional[Dict[str, Any]]:
    """Join the per-signal sections into one profile, or None when the
    run traced no stage spans (a profile of nothing would validate but
    mislead — absence means "no attribution ran", never zeros).

    ``kernels`` / ``cost`` / ``residency`` are the record sections of
    the same names (``cost`` in ``stage_cost_summary`` shape, i.e. the
    record's ``extra.stage_throughput``); any may be absent and its
    columns are simply omitted per stage. ``ceilings`` is an optional
    ``{"gflops": ..., "gbps": ...}`` measured-peak dict (bench's MFU
    probe); when given, stages with achieved rates gain
    ``pct_peak_flops`` / ``pct_peak_bw``.
    """
    walls = _stage_walls(spans or [])
    if not walls:
        return None
    cost = cost if isinstance(cost, dict) else {}
    vs_cost = {}
    if isinstance(kernels, dict):
        vs = kernels.get("vs_cost_model")
        if isinstance(vs, dict):
            vs_cost = vs
    by_stage_xfer = {}
    by_boundary = {}
    if isinstance(residency, dict):
        bs = residency.get("by_stage")
        if isinstance(bs, dict):
            by_stage_xfer = bs
        bb = residency.get("by_boundary")
        if isinstance(bb, dict):
            by_boundary = bb

    peak_gflops = peak_gbps = None
    if isinstance(ceilings, dict):
        v = ceilings.get("gflops")
        if isinstance(v, (int, float)) and v > 0:
            peak_gflops = float(v)
        v = ceilings.get("gbps")
        if isinstance(v, (int, float)) and v > 0:
            peak_gbps = float(v)

    stages: Dict[str, Dict[str, Any]] = {}
    tot_wall = tot_device = tot_flops = tot_bytes = 0.0
    tot_d2h = tot_h2d = 0
    for name in sorted(walls):
        row: Dict[str, Any] = {"wall_s": round(walls[name], 6)}
        tot_wall += walls[name]
        dev = vs_cost.get(name)
        if isinstance(dev, dict):
            dt = dev.get("device_time_s")
            if isinstance(dt, (int, float)) and dt >= 0:
                row["device_s"] = round(float(dt), 6)
                tot_device += float(dt)
        c = cost.get(name)
        if isinstance(c, dict):
            for k in ("flops", "bytes_accessed", "kernels",
                      "achieved_gflops", "achieved_gbps"):
                v = c.get(k)
                if isinstance(v, (int, float)):
                    row[k] = v
            tot_flops += float(c.get("flops") or 0)
            tot_bytes += float(c.get("bytes_accessed") or 0)
            if peak_gflops and isinstance(row.get("achieved_gflops"),
                                          (int, float)):
                row["pct_peak_flops"] = round(
                    100.0 * row["achieved_gflops"] / peak_gflops, 2
                )
            if peak_gbps and isinstance(row.get("achieved_gbps"),
                                        (int, float)):
                row["pct_peak_bw"] = round(
                    100.0 * row["achieved_gbps"] / peak_gbps, 2
                )
        x = by_stage_xfer.get(name)
        if isinstance(x, dict):
            d2h = int(x.get("to_host_bytes") or 0)
            h2d = int(x.get("to_device_bytes") or 0)
            row["to_host_bytes"] = d2h
            row["to_device_bytes"] = h2d
            row["transfer_calls"] = int(x.get("calls") or 0)
            tot_d2h += d2h
            tot_h2d += h2d
        stages[name] = row

    boundaries: Dict[str, Dict[str, Any]] = {}
    for name in sorted(by_boundary):
        d = by_boundary[name]
        if not isinstance(d, dict):
            continue
        boundaries[name] = {
            "to_host_bytes": int(d.get("to_host_bytes") or 0),
            "to_device_bytes": int(d.get("to_device_bytes") or 0),
            "calls": int(d.get("calls") or 0),
            "todo_item2": name in ITEM2_BOUNDARIES,
        }

    sec: Dict[str, Any] = {
        "version": PROFILE_VERSION,
        "stages": stages,
        "totals": {
            "wall_s": round(tot_wall, 6),
            "device_s": round(tot_device, 6),
            "flops": tot_flops,
            "bytes_accessed": tot_bytes,
            "to_host_bytes": tot_d2h,
            "to_device_bytes": tot_h2d,
        },
    }
    if boundaries:
        sec["boundaries"] = boundaries
    if peak_gflops or peak_gbps:
        ceil: Dict[str, float] = {}
        if peak_gflops:
            ceil["gflops"] = peak_gflops
        if peak_gbps:
            ceil["gbps"] = peak_gbps
        sec["ceilings"] = ceil
    return sec


def build_burndown(residency: Optional[Dict[str, Any]]
                   ) -> Optional[Dict[str, Any]]:
    """Residency burn-down ledger from a record's ``residency`` section:
    bytes crossed per declared boundary, with the ``TODO(item-2)``
    boundaries (the crossings the device-residency refactor exists to
    remove) totalled separately so their sum can only ratchet down.
    None when no audit ran — absence of audit must not read as a
    burn-down of zero bytes."""
    if not isinstance(residency, dict):
        return None
    by_boundary = residency.get("by_boundary")
    if not isinstance(by_boundary, dict) or not by_boundary:
        return None
    rows: Dict[str, Dict[str, Any]] = {}
    total = item2_total = 0
    for name in sorted(by_boundary):
        d = by_boundary[name]
        if not isinstance(d, dict):
            continue
        d2h = int(d.get("to_host_bytes") or 0)
        h2d = int(d.get("to_device_bytes") or 0)
        todo = name in ITEM2_BOUNDARIES
        rows[name] = {
            "bytes": d2h + h2d,
            "to_host_bytes": d2h,
            "to_device_bytes": h2d,
            "calls": int(d.get("calls") or 0),
            "todo_item2": todo,
        }
        total += d2h + h2d
        if todo:
            item2_total += d2h + h2d
    if not rows:
        return None
    return {
        "version": PROFILE_VERSION,
        "boundaries": rows,
        "total_bytes": total,
        "todo_item2_bytes": item2_total,
        "n_boundaries": len(rows),
        "n_todo_item2": sum(1 for r in rows.values() if r["todo_item2"]),
    }


def profile_sections_of(rec: Dict[str, Any]
                        ) -> Dict[str, Optional[Dict[str, Any]]]:
    """Both derived sections from a full run record — the one call
    bench's ``_finalize`` and the diff tooling share, so a profile
    computed at record-build time and one recomputed from a committed
    record can never disagree. Reads the record's existing sections
    (``spans``, ``kernels``, ``residency``, ``extra.stage_throughput``,
    ``extra.mfu`` ceilings) and returns ``{"profile": ...,
    "residency_burndown": ...}`` with None for what can't be built."""
    extra = rec.get("extra") or {}
    ceilings = None
    mfu = extra.get("mfu")
    if isinstance(mfu, dict):
        ceil: Dict[str, float] = {}
        v = mfu.get("measured_gflops")
        if isinstance(v, (int, float)) and v > 0:
            ceil["gflops"] = float(v)
        v = mfu.get("measured_gbps")
        if isinstance(v, (int, float)) and v > 0:
            ceil["gbps"] = float(v)
        ceilings = ceil or None
    return {
        "profile": build_profile(
            rec.get("spans"),
            kernels=rec.get("kernels"),
            cost=extra.get("stage_throughput"),
            residency=rec.get("residency"),
            ceilings=ceilings,
        ),
        "residency_burndown": build_burndown(rec.get("residency")),
    }


# --------------------------------------------------------------------------
# validation
# --------------------------------------------------------------------------

def _require(cond: bool, section: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{section} section: {msg}")


def _check_boundary_row(d: Any, name: str, section: str) -> None:
    _require(isinstance(d, dict), section,
             f"boundaries[{name!r}] is not an object")
    _require(name in BOUNDARIES, section,
             f"boundaries names undeclared boundary {name!r}")
    for k in ("to_host_bytes", "to_device_bytes", "calls"):
        v = d.get(k)
        _require(isinstance(v, int) and v >= 0, section,
                 f"boundaries[{name!r}].{k} must be an int >= 0")
    _require(d.get("todo_item2") == (name in ITEM2_BOUNDARIES), section,
             f"boundaries[{name!r}].todo_item2 disagrees with the "
             "declared allowlist")


def validate_profile(sec: Dict[str, Any]) -> None:
    """Structural validation of a record's ``profile`` section (additive
    scc-run-record v1 extension; ``export.validate_run_record`` calls
    this)."""
    _require(isinstance(sec, dict), "profile", "must be an object")
    _require(sec.get("version") == PROFILE_VERSION, "profile",
             f"version must be {PROFILE_VERSION}")
    stages = sec.get("stages")
    _require(isinstance(stages, dict) and stages, "profile",
             "stages must be a non-empty object")
    for name, row in stages.items():
        _require(isinstance(row, dict), "profile",
                 f"stages[{name!r}] is not an object")
        w = row.get("wall_s")
        _require(isinstance(w, (int, float)) and w >= 0, "profile",
                 f"stages[{name!r}].wall_s must be a number >= 0")
        for k in ("device_s", "flops", "bytes_accessed",
                  "achieved_gflops", "achieved_gbps"):
            v = row.get(k)
            _require(v is None or (isinstance(v, (int, float)) and v >= 0),
                     "profile", f"stages[{name!r}].{k} must be >= 0")
        for k in ("to_host_bytes", "to_device_bytes", "transfer_calls"):
            v = row.get(k)
            _require(v is None or (isinstance(v, int) and v >= 0),
                     "profile", f"stages[{name!r}].{k} must be an "
                     "int >= 0")
    tot = sec.get("totals")
    _require(isinstance(tot, dict), "profile", "totals must be an object")
    for k in ("wall_s", "device_s", "flops", "bytes_accessed",
              "to_host_bytes", "to_device_bytes"):
        v = tot.get(k)
        _require(isinstance(v, (int, float)) and v >= 0, "profile",
                 f"totals.{k} must be a number >= 0")
    bounds = sec.get("boundaries")
    if bounds is not None:
        _require(isinstance(bounds, dict), "profile",
                 "boundaries must be an object")
        for name, d in bounds.items():
            _check_boundary_row(d, name, "profile")


def validate_residency_burndown(sec: Dict[str, Any]) -> None:
    """Structural validation of a record's ``residency_burndown``
    section. The totals are re-checked against the rows — a burn-down
    whose headline number disagrees with its own table is exactly the
    corruption this section exists to make impossible."""
    _require(isinstance(sec, dict), "residency_burndown",
             "must be an object")
    _require(sec.get("version") == PROFILE_VERSION, "residency_burndown",
             f"version must be {PROFILE_VERSION}")
    rows = sec.get("boundaries")
    _require(isinstance(rows, dict) and rows, "residency_burndown",
             "boundaries must be a non-empty object")
    total = item2 = 0
    for name, d in rows.items():
        _check_boundary_row(d, name, "residency_burndown")
        b = d.get("bytes")
        _require(isinstance(b, int) and b >= 0, "residency_burndown",
                 f"boundaries[{name!r}].bytes must be an int >= 0")
        _require(b == d["to_host_bytes"] + d["to_device_bytes"],
                 "residency_burndown",
                 f"boundaries[{name!r}].bytes != d2h + h2d")
        total += b
        if d["todo_item2"]:
            item2 += b
    _require(sec.get("total_bytes") == total, "residency_burndown",
             "total_bytes disagrees with the per-boundary rows")
    _require(sec.get("todo_item2_bytes") == item2, "residency_burndown",
             "todo_item2_bytes disagrees with the per-boundary rows")
    _require(sec.get("n_boundaries") == len(rows), "residency_burndown",
             "n_boundaries disagrees with the per-boundary rows")
