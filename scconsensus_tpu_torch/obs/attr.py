"""Differential run attribution: structurally diff two run records and
name the root cause.

The port's copy of ``scconsensus_tpu/obs/attr.py``, over the port's
``obs.profile`` (``profile_sections_of``, ``build_burndown``) and its
noise floors (``obs.regress``). ``regress.gate_record`` can say a stage's
wall left its band and ``regress.diff_span_trees`` can name the child
span that grew; :func:`diff_records` diffs two records' unified profiles
and emits a deterministic ranked cause list, each cause naming its
driver::

    stage `de` +38 % wall, driven by +2.1 GB d2h at boundary
    `funnel_counts`

Drivers, in claim order (first sufficient signal wins — the ordering is
part of the report's determinism contract):

* ``transfer`` — the stage's audited bytes grew past the residency
  noise band; the cause names the declared boundary whose same-
  direction bytes grew most.
* ``device`` — device-kernel time accounts for most of the wall growth.
* ``work`` — cost-model FLOPs grew past noise (more work dispatched).
* ``host`` — wall grew with transfers, device time, and FLOPs flat:
  host-side time by elimination. When both records carry the host
  observatory's sections (``host_profile`` / ``compile``), the bucket
  splits into named drivers — claim order ``gc``, ``compile/retrace``,
  ``blocking-wait``, ``serialization``, ``python-compute`` (with the
  dominant frame named) — and the cause keeps "host-side" in its
  summary. Records without the sections keep the plain ``host``
  driver.

:func:`top_suspect` names what a gate failure should name,
:func:`format_report` renders the text report. Everything here is a pure
function of two records, deterministic by construction.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from scconsensus_tpu_torch.obs.regress import (
    ABS_NOISE_FLOOR_BYTES,
    ABS_NOISE_FLOOR_S,
    REL_NOISE_FLOOR,
)

__all__ = [
    "diff_records",
    "format_report",
    "top_suspect",
]

DIFF_SCHEMA = "scc-perf-diff"
DIFF_VERSION = 1

# Internal host-cause keys (host_profile.stages[*].causes spelling) in
# claim order, and their report driver names. Order is part of the
# determinism contract: on an exact tie the earlier cause wins.
_HOST_CAUSE_KEYS = ("gc", "compile", "blocking_wait", "serialization",
                    "python")
_HOST_DRIVER_NAMES = {
    "gc": "gc",
    "compile": "compile/retrace",
    "blocking_wait": "blocking-wait",
    "serialization": "serialization",
    "python": "python-compute",
}


def _fmt_bytes(n: float) -> str:
    sign = "+" if n >= 0 else "-"
    n = abs(float(n))
    for unit, div in (("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if n >= div:
            return f"{sign}{n / div:.1f} {unit}"
    return f"{sign}{n:.0f} B"


def _fmt_pct(pct: Optional[float]) -> str:
    return "n/a" if pct is None else f"{pct:+.1f} %"


def _profile_of(rec: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """The record's profile section, recomputed from the raw sections
    when absent (pre-profile records diff fine as long as they still
    carry spans)."""
    p = rec.get("profile")
    if isinstance(p, dict):
        return p
    from scconsensus_tpu_torch.obs.profile import profile_sections_of

    return profile_sections_of(rec)["profile"]


def _burndown_of(rec: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    b = rec.get("residency_burndown")
    if isinstance(b, dict):
        return b
    from scconsensus_tpu_torch.obs.profile import build_burndown

    return build_burndown(rec.get("residency"))


def _xfer_total(row: Dict[str, Any]) -> int:
    return int(row.get("to_host_bytes") or 0) + int(
        row.get("to_device_bytes") or 0
    )


def _boundary_deltas(cand_bd: Optional[Dict[str, Any]],
                     base_bd: Optional[Dict[str, Any]]
                     ) -> Dict[str, Dict[str, Any]]:
    cb = (cand_bd or {}).get("boundaries") or {}
    bb = (base_bd or {}).get("boundaries") or {}
    out: Dict[str, Dict[str, Any]] = {}
    for name in sorted(set(cb) | set(bb)):
        c, b = cb.get(name) or {}, bb.get(name) or {}
        out[name] = {
            "candidate_bytes": _xfer_total(c),
            "baseline_bytes": _xfer_total(b),
            "delta_bytes": _xfer_total(c) - _xfer_total(b),
            "delta_to_host_bytes": int(c.get("to_host_bytes") or 0)
            - int(b.get("to_host_bytes") or 0),
            "delta_to_device_bytes": int(c.get("to_device_bytes") or 0)
            - int(b.get("to_device_bytes") or 0),
            "todo_item2": bool(
                c.get("todo_item2", b.get("todo_item2", False))
            ),
        }
    return out


def _host_cause_rows(rec: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """Per-stage host-cause seconds from a record's round-19 sections:
    ``{stage: {gc, compile, blocking_wait, serialization, python,
    _retraces, _top_frame?}}``. Empty for pre-19 records (no sections)
    — the caller falls back to the undifferentiated host driver.
    Every field read is guarded: a malformed or future-shaped section
    degrades to zeros, never raises out of a diff."""
    out: Dict[str, Dict[str, Any]] = {}

    def _row(stage: str) -> Dict[str, Any]:
        return out.setdefault(
            stage, {k: 0.0 for k in _HOST_CAUSE_KEYS} | {"_retraces": 0}
        )

    hp = rec.get("host_profile")
    if isinstance(hp, dict):
        for stage, srow in (hp.get("stages") or {}).items():
            if not isinstance(srow, dict):
                continue
            row = _row(stage)
            causes = srow.get("causes") or {}
            for k in _HOST_CAUSE_KEYS:
                v = causes.get(k) if isinstance(causes, dict) else None
                if isinstance(v, (int, float)) and v > 0:
                    row[k] += float(v)
            tf = srow.get("top_frame")
            if isinstance(tf, str) and tf:
                row["_top_frame"] = tf
    comp = rec.get("compile")
    if isinstance(comp, dict):
        for stage, crow in (comp.get("by_stage") or {}).items():
            if not isinstance(crow, dict):
                continue
            row = _row(stage)
            t = crow.get("total_s")
            if isinstance(t, (int, float)) and t > 0:
                # measured compile wall wins over the sampler's estimate
                # of the same seconds (max, not sum: one wall, two
                # instruments)
                row["compile"] = max(row["compile"], float(t))
            r = crow.get("retraces")
            if isinstance(r, int) and r > 0:
                row["_retraces"] += r
    return out


def _split_host_cause(head: str, cause: Dict[str, Any],
                      host_cand: Optional[Dict[str, Any]],
                      host_base: Optional[Dict[str, Any]]
                      ) -> Optional[Dict[str, Any]]:
    """Name the dominant host cause of a stage's wall growth from both
    records' per-stage cause seconds. None when neither record carries
    host-observatory data for the stage or no cause's delta clears the
    absolute noise floor — the caller keeps the legacy host driver."""
    if not host_cand and not host_base:
        return None
    hc = host_cand or {}
    hb = host_base or {}
    best_key: Optional[str] = None
    best_delta = ABS_NOISE_FLOOR_S
    for k in _HOST_CAUSE_KEYS:
        d = float(hc.get(k) or 0.0) - float(hb.get(k) or 0.0)
        if d > best_delta:
            best_key, best_delta = k, d
    if best_key is None:
        return None
    cause["driver"] = _HOST_DRIVER_NAMES[best_key]
    cause["delta_host_cause_s"] = round(best_delta, 6)
    if best_key == "gc":
        detail = f"{best_delta:+.3f} s GC pauses"
    elif best_key == "compile":
        dr = int(hc.get("_retraces") or 0) - int(hb.get("_retraces") or 0)
        cause["delta_retraces"] = dr
        detail = f"{best_delta:+.3f} s compile/retrace"
        if dr > 0:
            detail += f" (+{dr} retrace{'s' if dr != 1 else ''})"
    elif best_key == "blocking_wait":
        detail = (f"{best_delta:+.3f} s blocking waits "
                  "(block_until_ready/transfers)")
    elif best_key == "serialization":
        detail = f"{best_delta:+.3f} s serialization"
    else:
        detail = f"{best_delta:+.3f} s python compute"
        frame = hc.get("_top_frame")
        if isinstance(frame, str) and frame:
            cause["frame"] = frame
            detail += f" at `{frame}`"
    cause["summary"] = f"{head}, host-side driven by {detail}"
    return cause


def _compile_delta(candidate: Dict[str, Any], baseline: Dict[str, Any]
                   ) -> Optional[Dict[str, Any]]:
    """Record-level compile-telemetry delta (None when neither record
    carries a ``compile`` section)."""
    c, b = candidate.get("compile"), baseline.get("compile")
    if not isinstance(c, dict) and not isinstance(b, dict):
        return None
    c = c if isinstance(c, dict) else {}
    b = b if isinstance(b, dict) else {}

    def _i(d: Dict[str, Any], k: str) -> int:
        v = d.get(k)
        return int(v) if isinstance(v, int) else 0

    def _f(d: Dict[str, Any], k: str) -> float:
        v = d.get(k)
        return float(v) if isinstance(v, (int, float)) else 0.0

    return {
        "candidate_retraces": _i(c, "retraces"),
        "baseline_retraces": _i(b, "retraces"),
        "delta_compiles": _i(c, "compiles") - _i(b, "compiles"),
        "delta_retraces": _i(c, "retraces") - _i(b, "retraces"),
        "delta_cache_hits": _i(c, "cache_hits") - _i(b, "cache_hits"),
        "delta_wall_s": round(
            _f(c, "compile_wall_s") - _f(b, "compile_wall_s"), 6
        ),
    }


def _transfer_driver(boundaries: Dict[str, Dict[str, Any]],
                     direction_key: str
                     ) -> Optional[Tuple[str, int]]:
    """The declared boundary whose bytes grew most in the stage's
    dominant direction — ties broken by name so the report is stable."""
    best: Optional[Tuple[str, int]] = None
    for name in sorted(boundaries):
        d = boundaries[name][direction_key]
        if d > 0 and (best is None or d > best[1]):
            best = (name, d)
    return best


def diff_records(candidate: Dict[str, Any], baseline: Dict[str, Any],
                 candidate_label: str = "candidate",
                 baseline_label: str = "baseline") -> Dict[str, Any]:
    """Structural diff of two run records: per-stage wall / device /
    FLOPs / transfer deltas, per-boundary byte deltas, and a ranked
    ``causes`` list (largest absolute wall delta first, name-tiebroken)
    with each cause's driver classified per the module docstring.
    Deterministic: same pair of records, same report, always."""
    cand_p = _profile_of(candidate) or {"stages": {}, "totals": {}}
    base_p = _profile_of(baseline) or {"stages": {}, "totals": {}}
    cs, bs = cand_p.get("stages") or {}, base_p.get("stages") or {}
    boundaries = _boundary_deltas(_burndown_of(candidate),
                                  _burndown_of(baseline))
    host_cand = _host_cause_rows(candidate)
    host_base = _host_cause_rows(baseline)

    stages: Dict[str, Dict[str, Any]] = {}
    for name in sorted(set(cs) | set(bs)):
        c, b = cs.get(name) or {}, bs.get(name) or {}
        cw = float(c.get("wall_s") or 0.0)
        bw = float(b.get("wall_s") or 0.0)
        row: Dict[str, Any] = {
            "candidate_wall_s": round(cw, 6),
            "baseline_wall_s": round(bw, 6),
            "delta_wall_s": round(cw - bw, 6),
            "pct_wall": round(100.0 * (cw - bw) / bw, 1) if bw > 0
            else None,
            "only_in": "candidate" if name not in bs
            else ("baseline" if name not in cs else None),
        }
        band = max(ABS_NOISE_FLOOR_S, REL_NOISE_FLOOR * bw)
        row["within_noise"] = abs(cw - bw) <= band and row["only_in"] is \
            None
        cd, bd = c.get("device_s"), b.get("device_s")
        if cd is not None or bd is not None:
            row["delta_device_s"] = round(
                float(cd or 0.0) - float(bd or 0.0), 6
            )
        cf, bf = c.get("flops"), b.get("flops")
        if cf is not None or bf is not None:
            row["delta_flops"] = float(cf or 0.0) - float(bf or 0.0)
            row["baseline_flops"] = float(bf or 0.0)
        if "to_host_bytes" in c or "to_host_bytes" in b:
            row["delta_to_host_bytes"] = int(c.get("to_host_bytes") or 0) \
                - int(b.get("to_host_bytes") or 0)
            row["delta_to_device_bytes"] = \
                int(c.get("to_device_bytes") or 0) \
                - int(b.get("to_device_bytes") or 0)
            row["baseline_transfer_bytes"] = _xfer_total(b)
        stages[name] = row

    causes: List[Dict[str, Any]] = []
    ranked = sorted(
        stages.items(),
        key=lambda kv: (-abs(kv[1]["delta_wall_s"]), kv[0]),
    )
    for name, row in ranked:
        if row["delta_wall_s"] == 0 and row["only_in"] is None:
            continue
        cause = _classify(name, row, boundaries,
                          host_cand.get(name), host_base.get(name))
        cause["rank"] = len(causes) + 1
        causes.append(cause)

    cv, bv = candidate.get("value"), baseline.get("value")
    headline: Dict[str, Any] = {
        "candidate": cv,
        "baseline": bv,
        "unit": candidate.get("unit"),
    }
    if isinstance(cv, (int, float)) and isinstance(bv, (int, float)):
        headline["delta"] = round(float(cv) - float(bv), 6)
        if bv:
            headline["pct"] = round(100.0 * (float(cv) - float(bv))
                                    / float(bv), 1)

    cand_bd, base_bd = _burndown_of(candidate), _burndown_of(baseline)
    burndown: Optional[Dict[str, Any]] = None
    if cand_bd or base_bd:
        ct = int((cand_bd or {}).get("total_bytes") or 0)
        bt = int((base_bd or {}).get("total_bytes") or 0)
        ci = int((cand_bd or {}).get("todo_item2_bytes") or 0)
        bi = int((base_bd or {}).get("todo_item2_bytes") or 0)
        burndown = {
            "candidate_total_bytes": ct,
            "baseline_total_bytes": bt,
            "delta_total_bytes": ct - bt,
            "candidate_todo_item2_bytes": ci,
            "baseline_todo_item2_bytes": bi,
            "delta_todo_item2_bytes": ci - bi,
        }

    return {
        "schema": DIFF_SCHEMA,
        "schema_version": DIFF_VERSION,
        "candidate": {"label": candidate_label,
                      "metric": candidate.get("metric")},
        "baseline": {"label": baseline_label,
                     "metric": baseline.get("metric")},
        "headline": headline,
        "causes": causes,
        "stages": stages,
        "boundaries": boundaries,
        "burndown": burndown,
        "compile": _compile_delta(candidate, baseline),
    }


def _classify(name: str, row: Dict[str, Any],
              boundaries: Dict[str, Dict[str, Any]],
              host_cand: Optional[Dict[str, Any]] = None,
              host_base: Optional[Dict[str, Any]] = None
              ) -> Dict[str, Any]:
    """One cause entry for a stage delta: driver + human summary. Only
    wall *growth* gets a root-cause claim; shrinkage and stages unique
    to one record are reported as what they are."""
    delta = row["delta_wall_s"]
    pct = row["pct_wall"]
    head = f"stage `{name}` {_fmt_pct(pct)} wall" if pct is not None \
        else f"stage `{name}` {delta:+.3f} s wall"
    cause: Dict[str, Any] = {
        "stage": name,
        "delta_wall_s": delta,
        "pct_wall": pct,
        "within_noise": row["within_noise"],
    }
    if row["only_in"] is not None:
        cause["driver"] = "structure"
        cause["summary"] = (
            f"stage `{name}` only in {row['only_in']} "
            f"({delta:+.3f} s wall)"
        )
        return cause
    if delta < 0:
        cause["driver"] = "improvement"
        cause["summary"] = f"{head} (improvement)"
        return cause

    d2h = row.get("delta_to_host_bytes")
    h2d = row.get("delta_to_device_bytes")
    if d2h is not None:
        xfer_delta = d2h + h2d
        base_xfer = row.get("baseline_transfer_bytes") or 0
        xfer_band = max(ABS_NOISE_FLOOR_BYTES,
                        REL_NOISE_FLOOR * base_xfer)
        if xfer_delta > xfer_band:
            direction = "d2h" if d2h >= h2d else "h2d"
            dir_key = "delta_to_host_bytes" if direction == "d2h" \
                else "delta_to_device_bytes"
            grown = max(d2h, h2d)
            suspect = _transfer_driver(boundaries, dir_key)
            cause["driver"] = "transfer"
            cause["delta_transfer_bytes"] = xfer_delta
            at = ""
            if suspect is not None:
                cause["boundary"] = suspect[0]
                at = f" at boundary `{suspect[0]}`"
            cause["summary"] = (
                f"{head}, driven by {_fmt_bytes(grown)} {direction}{at}"
            )
            return cause

    dev = row.get("delta_device_s")
    if dev is not None and dev > 0 and dev >= 0.5 * delta:
        cause["driver"] = "device"
        cause["summary"] = (
            f"{head}, driven by {dev:+.3f} s device-kernel time"
        )
        return cause

    df = row.get("delta_flops")
    if df is not None and df > 0:
        bf = row.get("baseline_flops") or 0.0
        if df > REL_NOISE_FLOOR * bf:
            cause["driver"] = "work"
            cause["summary"] = (
                f"{head}, driven by {df / 1e9:+.2f} GFLOP more work "
                "dispatched"
            )
            return cause

    split = _split_host_cause(head, cause, host_cand, host_base)
    if split is not None:
        return split
    cause["driver"] = "host"
    cause["summary"] = (
        f"{head}, host-side (transfers, device time, and FLOPs flat)"
    )
    return cause


def top_suspect(diff: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """The highest-ranked out-of-noise wall *growth* — what a perf_gate
    FAIL should name. None when nothing grew past noise (the FAIL came
    from a non-wall gate: drift, transfers, SLO...)."""
    for cause in diff.get("causes") or []:
        if cause.get("delta_wall_s", 0) > 0 and not cause.get(
            "within_noise"
        ) and cause.get("driver") not in ("improvement",):
            return cause
    return None


def format_report(diff: Dict[str, Any], max_causes: int = 10) -> str:
    """Render the diff as the deterministic text report perf_diff
    prints: headline, ranked causes, burn-down delta, per-boundary
    table."""
    lines: List[str] = []
    c, b = diff["candidate"], diff["baseline"]
    lines.append(f"perf-diff: {c['label']} vs {b['label']}")
    h = diff.get("headline") or {}
    if isinstance(h.get("candidate"), (int, float)) and isinstance(
        h.get("baseline"), (int, float)
    ):
        unit = h.get("unit") or ""
        pct = f" ({_fmt_pct(h['pct'])})" if "pct" in h else ""
        lines.append(
            f"headline: {h['candidate']:.4g} vs {h['baseline']:.4g} "
            f"{unit}{pct}"
        )
    causes = diff.get("causes") or []
    if causes:
        lines.append("ranked causes:")
        for cause in causes[:max_causes]:
            noise = "  [within noise]" if cause.get("within_noise") \
                else ""
            lines.append(f"  {cause['rank']}. {cause['summary']}{noise}")
        if len(causes) > max_causes:
            lines.append(f"  ... {len(causes) - max_causes} more below "
                         "threshold")
    else:
        lines.append("ranked causes: none (no stage walls differ)")
    comp = diff.get("compile")
    if comp:
        rt = f" ({comp['candidate_retraces']} vs " \
             f"{comp['baseline_retraces']} retraces)"
        lines.append(
            f"compile: {comp['delta_compiles']:+d} compiles, "
            f"{comp['delta_retraces']:+d} retraces{rt}, "
            f"{comp['delta_cache_hits']:+d} cache hits, "
            f"{comp['delta_wall_s']:+.3f} s compile wall"
        )
    bd = diff.get("burndown")
    if bd:
        lines.append(
            "residency burn-down: total "
            f"{_fmt_bytes(bd['candidate_total_bytes'])[1:]} "
            f"({_fmt_bytes(bd['delta_total_bytes'])}); TODO(item-2) "
            f"{_fmt_bytes(bd['candidate_todo_item2_bytes'])[1:]} "
            f"({_fmt_bytes(bd['delta_todo_item2_bytes'])})"
        )
        for name, row in (diff.get("boundaries") or {}).items():
            tag = "  [item-2]" if row["todo_item2"] else ""
            lines.append(
                f"  boundary `{name}` "
                f"{_fmt_bytes(row['candidate_bytes'])[1:]} "
                f"({_fmt_bytes(row['delta_bytes'])}){tag}"
            )
    return "\n".join(lines)
