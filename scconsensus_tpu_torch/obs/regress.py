"""Noise-aware regression verdicts + numeric-drift sentinels over the ledger.

The port's copy of ``scconsensus_tpu/obs/regress.py:68-1387``, reading
the port's records and ledger (``obs.ledger``, ``obs.residency``,
``obs.cost``). Two consumers of ledger history:

Performance gate. Per-stage baselines are the **median of the last ≤3
runs** of the same (dataset, backend, config_fp) key, with a noise band
derived from the anchor spread (floored at 10 % of the baseline and
50 ms). A synced stage wall beyond baseline + band is a regression; the
verdict diffs the candidate's span tree against the baseline run's to
name the offending child span, and when cost attribution ran
(``obs.cost``) the verdict also expresses the loss as achieved-throughput
efficiency. The same banding gates transfer bytes by stage and boundary,
serving latency, streaming peak RSS and sustained traffic;
:func:`slo_verdicts` and the traffic lane's breach claim need no history;
:func:`graphs_verdicts` holds a record's ``graphs`` section to a
``graph_ratchet`` pin entry and refuses one keyed by another toolchain's
fingerprint (a JAX pin against a port passport, for one).

Drift sentinel. A run's numeric fingerprint — DE p-value quantiles, NB
dispersion quantiles, final-label ARI vs pinned fixtures — is compared
against committed pins; any shift beyond tolerance must be acknowledged
by a machine-readable entry in the drift ledger (``DRIFT_LEDGER.jsonl``)
pinning the *new* value, or the gate fails.
:func:`reference_fingerprint` runs the reference's pinned workload
through the port's ``recluster_de_consensus`` (on the card unless told
otherwise); ``python -m scconsensus_tpu_torch.obs.regress --write-pins
PATH`` writes a pins file from it.

``adjusted_rand_index`` keeps one repair (the reference's int64 pair-count
product wraps past 2^63; the port's takes it in float64), and
``ari_from_table`` scores a contingency table directly.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "ANCHOR_RUNS",
    "StageVerdict",
    "TransferVerdict",
    "ServingVerdict",
    "StreamingVerdict",
    "LoadgenVerdict",
    "GateVerdict",
    "stage_baselines",
    "stage_transfer_baselines",
    "boundary_baselines",
    "stage_trends",
    "serving_baselines",
    "streaming_baselines",
    "loadgen_baselines",
    "loadgen_verdicts",
    "diff_span_trees",
    "gate_record",
    "DRIFT_LEDGER_NAME",
    "PINS_NAME",
    "REFERENCE_DATASET",
    "pins_for_dataset",
    "history_pins",
    "resolve_pins",
    "drift_fingerprint",
    "load_drift_acks",
    "append_drift_ack",
    "check_drift",
    "adjusted_rand_index",
    "ari_from_table",
]

ANCHOR_RUNS = 3          # median-of-3 (BASELINE.md measurement policy)
REL_NOISE_FLOOR = 0.10   # band is never tighter than 10 % of baseline
ABS_NOISE_FLOOR_S = 0.05  # ...or 50 ms (timer + drain jitter at tiny walls)
# Transfer-bytes bands (BASELINE.md residency-gate policy): transfers are
# near-deterministic per workload, but event-cap truncation and data-
# dependent paths (overflow redo, exact-branch pair counts) wiggle a few
# KiB — 64 KiB absolute floor, same 10 % relative floor as walls.
ABS_NOISE_FLOOR_BYTES = 64 << 10
# Serving-latency bands (BASELINE.md serving-latency policy): tail
# latency is the noisiest gated quantity (scheduler jitter, GC pauses,
# queue-shape luck), so the relative floor is 25 % — wide enough that a
# loaded CI box doesn't false-fail, narrow enough that a 3× p99 cannot
# hide — with a 1 ms absolute floor for sub-ms baselines.
SERVE_REL_NOISE_FLOOR = 0.25
ABS_NOISE_FLOOR_MS = 1.0
# Streaming peak-RSS bands (BASELINE.md streaming policy, round 17):
# the kernel high-water mark moves with allocator/page-cache luck, so
# 15 % relative / 64 MB absolute floors — wide enough that GC timing
# can't false-fail, narrow enough that a leaked chunk window (2× peak)
# cannot hide. A peak-RSS regression is a MEMORY regression: the
# quantity the whole out-of-core design exists to bound.
STREAM_REL_NOISE_FLOOR = 0.15
ABS_NOISE_FLOOR_MB = 64.0
# Loadgen bands (BASELINE.md traffic policy, round 21): sustained RPS
# at SLO inherits throughput's noise profile (scheduler jitter, queue-
# shape luck under open-loop arrivals), so the serving relative floor
# (25 %) with a 1 rps absolute floor for tiny offered rates. Lower is
# the regression — a fleet that sustains less traffic at SLO than its
# baseline has regressed even with every wall clean. Breaches gate
# history-free: a run with ANY SLO breach fails outright (a breached
# run's 0.0 headline must never ingest as a quiet new baseline).
LOADGEN_REL_NOISE_FLOOR = 0.25
ABS_NOISE_FLOOR_RPS = 1.0


# --------------------------------------------------------------------------
# per-stage baselines (walls and transfer bytes share one banding policy)
# --------------------------------------------------------------------------

def _banded_baselines(series: Dict[str, List[float]], abs_floor: float,
                      rel_floor: float = REL_NOISE_FLOOR
                      ) -> Dict[str, Dict[str, float]]:
    """Median-of-≤ANCHOR_RUNS with a noise band floored at
    ``max(spread, rel_floor·baseline, abs_floor)`` — the BASELINE.md
    policy, shared by stage walls, stage transfer bytes, and serving
    latency so the gates can never drift apart (only the floors differ
    per quantity)."""
    out: Dict[str, Dict[str, float]] = {}
    for stage, vs in series.items():
        anchor = sorted(vs[-ANCHOR_RUNS:])
        n = len(anchor)
        baseline = anchor[n // 2] if n % 2 else (
            0.5 * (anchor[n // 2 - 1] + anchor[n // 2])
        )
        spread = anchor[-1] - anchor[0]
        band = max(spread, rel_floor * baseline, abs_floor)
        out[stage] = {
            "baseline": baseline,
            "band": band,
            "spread": spread,
            "n": n,
        }
    return out


def stage_baselines(history: Sequence[Dict[str, Any]]
                    ) -> Dict[str, Dict[str, float]]:
    """Noise-aware per-stage baselines from manifest entries (oldest
    first). Uses each entry's ``stage_walls``; the anchor set per stage is
    the last ``ANCHOR_RUNS`` entries that measured that stage. Returns
    ``{stage: {baseline_s, band_s, n, spread_s}}``.

    Flight-recorder partials (``termination`` cause != clean) are excluded
    unconditionally: a SIGTERMed or stalled run's stage walls are
    truncated at the moment of death, and a baseline anchored on one
    would read every subsequent healthy run as a regression."""
    from scconsensus_tpu_torch.obs.ledger import is_partial_entry

    walls: Dict[str, List[float]] = {}
    for e in history:
        if is_partial_entry(e):
            continue
        for stage, w in (e.get("stage_walls") or {}).items():
            if isinstance(w, (int, float)) and w >= 0:
                walls.setdefault(stage, []).append(float(w))
    return {
        stage: {
            "baseline_s": round(b["baseline"], 6),
            "band_s": round(b["band"], 6),
            "spread_s": round(b["spread"], 6),
            "n": b["n"],
        }
        for stage, b in _banded_baselines(walls, ABS_NOISE_FLOOR_S).items()
    }


def stage_transfer_baselines(history: Sequence[Dict[str, Any]]
                             ) -> Dict[str, Dict[str, float]]:
    """Per-stage transfer-byte baselines from manifest entries' ledger-
    stamped ``stage_transfer_bytes`` (total of both directions; stamped at
    ingest from the record's residency section). Same median-of-≤3 +
    noise-band machinery as :func:`stage_baselines`, partials excluded
    for the same reason. Returns ``{stage: {baseline_bytes, band_bytes,
    spread_bytes, n}}``; stages never audited simply have no entry —
    absence of audit must not read as zero bytes."""
    from scconsensus_tpu_torch.obs.ledger import is_partial_entry

    series: Dict[str, List[float]] = {}
    for e in history:
        if is_partial_entry(e):
            continue
        for stage, b in (e.get("stage_transfer_bytes") or {}).items():
            if isinstance(b, (int, float)) and b >= 0:
                series.setdefault(stage, []).append(float(b))
    return {
        stage: {
            "baseline_bytes": round(b["baseline"]),
            "band_bytes": round(b["band"]),
            "spread_bytes": round(b["spread"]),
            "n": b["n"],
        }
        for stage, b in _banded_baselines(
            series, ABS_NOISE_FLOOR_BYTES
        ).items()
    }


def boundary_baselines(history: Sequence[Dict[str, Any]]
                       ) -> Dict[str, Dict[str, float]]:
    """Per-declared-boundary byte baselines from manifest entries'
    ledger-stamped ``boundary_bytes`` (total of both directions per
    residency boundary, stamped at ingest). Same median-of-≤3 + noise-
    band machinery and byte floors as :func:`stage_transfer_baselines`
    — the residency burn-down ledger's denominator: BASELINE.md pins
    these numbers and item-2 progress is the TODO boundaries' baselines
    ratcheting toward zero. Partials excluded; boundaries never crossed
    simply have no entry."""
    from scconsensus_tpu_torch.obs.ledger import is_partial_entry

    series: Dict[str, List[float]] = {}
    for e in history:
        if is_partial_entry(e):
            continue
        for boundary, b in (e.get("boundary_bytes") or {}).items():
            if isinstance(b, (int, float)) and b >= 0:
                series.setdefault(boundary, []).append(float(b))
    return {
        boundary: {
            "baseline_bytes": round(b["baseline"]),
            "band_bytes": round(b["band"]),
            "spread_bytes": round(b["spread"]),
            "n": b["n"],
        }
        for boundary, b in _banded_baselines(
            series, ABS_NOISE_FLOOR_BYTES
        ).items()
    }


def stage_trends(history: Sequence[Dict[str, Any]],
                 min_points: int = 2) -> Dict[str, Dict[str, Any]]:
    """Per-stage wall trend lines over the FULL ledger history (oldest
    first) — where :func:`stage_baselines` answers "is this run slower
    than the recent anchor", this answers "which way has the stage been
    drifting across rounds". Returns ``{stage: {n, first_s, last_s,
    delta_s, pct, slope_s_per_run, direction}}`` with ``direction`` one
    of ``up`` / ``down`` / ``flat``.

    Degenerate histories are first-class, never errors: a single-entry
    series reports ``flat`` with a zero slope (one point has no
    trend), an all-identical series reports ``flat`` (zero variance
    must not read as drift), and entries missing the stage key — e.g.
    a backend that never ran it — simply don't contribute points.
    A series is ``flat`` unless its endpoint delta clears the same
    noise floors the gate uses (10 % / 50 ms), so timer jitter can
    never be reported as a trend."""
    from scconsensus_tpu_torch.obs.ledger import is_partial_entry

    series: Dict[str, List[float]] = {}
    for e in history:
        if is_partial_entry(e):
            continue
        for stage, w in (e.get("stage_walls") or {}).items():
            if isinstance(w, (int, float)) and w >= 0:
                series.setdefault(stage, []).append(float(w))
    out: Dict[str, Dict[str, Any]] = {}
    for stage, vs in series.items():
        n = len(vs)
        first, last = vs[0], vs[-1]
        delta = last - first
        # least-squares slope over run index; a 1-point series has no
        # trend and a zero-variance index (impossible past the n==1
        # guard, but cheap to keep explicit) must never divide
        slope = 0.0
        if n >= 2:
            mean_x = (n - 1) / 2.0
            mean_y = sum(vs) / n
            sxx = sum((i - mean_x) ** 2 for i in range(n))
            if sxx > 0:
                slope = sum(
                    (i - mean_x) * (v - mean_y) for i, v in enumerate(vs)
                ) / sxx
        band = max(ABS_NOISE_FLOOR_S, REL_NOISE_FLOOR * first)
        if n < max(min_points, 2) or abs(delta) <= band:
            direction = "flat"
        else:
            direction = "up" if delta > 0 else "down"
        out[stage] = {
            "n": n,
            "first_s": round(first, 6),
            "last_s": round(last, 6),
            "delta_s": round(delta, 6),
            "pct": round(100.0 * delta / first, 1) if first > 0 else None,
            "slope_s_per_run": round(slope, 6),
            "direction": direction,
        }
    return out


def serving_baselines(history: Sequence[Dict[str, Any]]
                      ) -> Dict[str, Dict[str, float]]:
    """Serving-latency baselines from manifest entries' ledger-stamped
    ``serving`` summaries (obs.ledger ingest). Gated metrics: ``p99_ms``
    (the tail is the serving contract) with ``p50_ms`` carried for the
    report. Same median-of-≤3 machinery, SERVING floors (25 % / 1 ms),
    partials excluded. Entries without a serving stamp simply don't
    anchor — absence of serving must not read as zero latency.

    Fleet round: every metric anchors under a replica-count key
    (``p99_ms@r<N>``, plus ``throughput_rps@r<N>`` — a 4-replica p99 is
    not comparable to a 1-replica p99, and fleet throughput is gated in
    its own right; entries without a replica stamp key as r1, the bare
    r15 driver). The unkeyed p50/p99 series anchor ONLY on unstamped
    (single-driver) entries — a fleet's pool-level tail must never drag
    the single-driver baseline a non-fleet candidate gates against."""
    from scconsensus_tpu_torch.obs.ledger import is_partial_entry

    series: Dict[str, List[float]] = {}
    for e in history:
        if is_partial_entry(e):
            continue
        sv = e.get("serving") or {}
        nrep = sv.get("replicas")
        fleet_stamped = isinstance(nrep, int) and nrep >= 1
        nrep = int(nrep) if fleet_stamped else 1
        for metric in ("p50_ms", "p99_ms"):
            v = sv.get(metric)
            if isinstance(v, (int, float)) and v >= 0:
                if not fleet_stamped:
                    series.setdefault(metric, []).append(float(v))
                series.setdefault(f"{metric}@r{nrep}",
                                  []).append(float(v))
        tp = sv.get("throughput_rps")
        if isinstance(tp, (int, float)) and tp >= 0:
            series.setdefault(f"throughput_rps@r{nrep}",
                              []).append(float(tp))
    return {
        metric: {
            "baseline_ms": round(b["baseline"], 4),
            "band_ms": round(b["band"], 4),
            "spread_ms": round(b["spread"], 4),
            "n": b["n"],
        }
        for metric, b in _banded_baselines(
            series, ABS_NOISE_FLOOR_MS, rel_floor=SERVE_REL_NOISE_FLOOR
        ).items()
    }


def streaming_baselines(history: Sequence[Dict[str, Any]]
                        ) -> Dict[str, Dict[str, float]]:
    """Peak-RSS baselines from manifest entries' ledger-stamped
    ``streaming`` summaries (obs.ledger ingest). Same median-of-≤3
    machinery, STREAMING floors (15 % / 64 MB), partials excluded;
    entries without a streaming stamp simply don't anchor."""
    from scconsensus_tpu_torch.obs.ledger import is_partial_entry

    series: Dict[str, List[float]] = {}
    for e in history:
        if is_partial_entry(e):
            continue
        v = (e.get("streaming") or {}).get("peak_rss_mb")
        if isinstance(v, (int, float)) and v >= 0:
            series.setdefault("peak_rss_mb", []).append(float(v))
    return {
        metric: {
            "baseline_mb": round(b["baseline"], 3),
            "band_mb": round(b["band"], 3),
            "spread_mb": round(b["spread"], 3),
            "n": b["n"],
        }
        for metric, b in _banded_baselines(
            series, ABS_NOISE_FLOOR_MB, rel_floor=STREAM_REL_NOISE_FLOOR
        ).items()
    }


def loadgen_baselines(history: Sequence[Dict[str, Any]]
                      ) -> Dict[str, Dict[str, float]]:
    """Sustained-RPS-at-SLO baselines from manifest entries' ledger-
    stamped ``loadgen`` summaries (obs.ledger ingest). Keyed per arrival
    profile (``rps_at_slo@<profile>`` — spike traffic is not comparable
    to steady traffic), LOADGEN floors (25 % / 1 rps), partials
    excluded. Breached runs (``breaches > 0`` — headline pinned 0.0 by
    the section's own consistency rule) never anchor: a baseline must
    describe what the fleet sustains WITHIN its SLO."""
    from scconsensus_tpu_torch.obs.ledger import is_partial_entry

    series: Dict[str, List[float]] = {}
    for e in history:
        if is_partial_entry(e):
            continue
        lg = e.get("loadgen") or {}
        v = lg.get("rps_at_slo")
        profile = lg.get("profile")
        if (isinstance(v, (int, float)) and v >= 0
                and isinstance(profile, str)
                and not lg.get("breaches")):
            series.setdefault(f"rps_at_slo@{profile}",
                              []).append(float(v))
    return {
        metric: {
            "baseline_rps": round(b["baseline"], 4),
            "band_rps": round(b["band"], 4),
            "spread_rps": round(b["spread"], 4),
            "n": b["n"],
        }
        for metric, b in _banded_baselines(
            series, ABS_NOISE_FLOOR_RPS, rel_floor=LOADGEN_REL_NOISE_FLOOR
        ).items()
    }


# --------------------------------------------------------------------------
# span-tree diff (name the offender)
# --------------------------------------------------------------------------

def _child_walls(spans: Iterable[Dict[str, Any]], stage: str
                 ) -> Dict[str, float]:
    """Aggregate descendant walls by span name under every stage-kind span
    named ``stage``. Child spans of the same name (ladder buckets, chunk
    loops) sum — the diff compares *where the time went*, not individual
    iterations."""
    spans = [s for s in spans if isinstance(s, dict)]
    children: Dict[Any, List[Dict[str, Any]]] = {}
    for s in spans:
        children.setdefault(s.get("parent_id"), []).append(s)
    out: Dict[str, float] = {}
    roots = [s for s in spans
             if s.get("kind") == "stage" and s.get("name") == stage]
    stack = [c for r in roots for c in children.get(r.get("span_id"), [])]
    while stack:
        s = stack.pop()
        wall = s.get("wall_synced_s")
        if wall is None:
            wall = s.get("wall_submitted_s") or 0.0
        out[s["name"]] = out.get(s["name"], 0.0) + float(wall)
        stack.extend(children.get(s.get("span_id"), []))
    return out


def diff_span_trees(cand_spans: Sequence[Dict[str, Any]],
                    base_spans: Sequence[Dict[str, Any]],
                    stage: str) -> Optional[Dict[str, Any]]:
    """Name the child span that grew the most under a regressed stage.
    None when neither tree has children there (the stage itself is the
    finest attribution available)."""
    cand = _child_walls(cand_spans, stage)
    base = _child_walls(base_spans, stage)
    if not cand and not base:
        return None
    deltas = {
        name: cand.get(name, 0.0) - base.get(name, 0.0)
        for name in set(cand) | set(base)
    }
    name = max(deltas, key=lambda k: deltas[k])
    return {
        "span": name,
        "wall_s": round(cand.get(name, 0.0), 4),
        "baseline_s": round(base.get(name, 0.0), 4),
        "delta_s": round(deltas[name], 4),
    }


# --------------------------------------------------------------------------
# the gate
# --------------------------------------------------------------------------

@dataclasses.dataclass
class StageVerdict:
    stage: str
    wall_s: float
    baseline_s: float
    band_s: float
    regressed: bool
    excess_s: float = 0.0
    offender: Optional[Dict[str, Any]] = None
    efficiency: Optional[Dict[str, Any]] = None

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        return {k: v for k, v in d.items() if v is not None}


@dataclasses.dataclass
class TransferVerdict:
    """Per-stage transfer-bytes verdict (residency section vs the key's
    ledger-stamped baselines) — the same shape of claim as StageVerdict,
    in bytes instead of seconds."""

    stage: str
    bytes: int
    baseline_bytes: int
    band_bytes: int
    regressed: bool
    excess_bytes: int = 0

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ServingVerdict:
    """Serving verdict (candidate serving section vs the key's
    ledger-stamped baselines) — the tail-latency equivalent of a
    stage-wall claim. A clean-walls candidate whose p99 blew out fails
    on THIS verdict alone. Fleet candidates gate replica-count-keyed
    metrics (``p99_ms@r<N>``) plus throughput (``throughput_rps@r<N>``,
    ``unit="rps"``) — for throughput LOWER is the regression, so
    ``excess_ms`` carries the shortfall below the band floor."""

    metric: str                    # "p99_ms" | "p50_ms" | "...@r<N>"
    value_ms: float
    baseline_ms: float
    band_ms: float
    regressed: bool
    excess_ms: float = 0.0
    unit: str = "ms"

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class SLOVerdict:
    """SLO-lane verdict (round 20): the candidate's ``slo`` section
    judged against its OWN declared objectives — no history needed,
    because the record carries its targets (burn_limit, p99 target).
    A clean-walls candidate whose error-budget burn breached its limit,
    or whose p99 missed its own target, fails on THIS verdict alone."""

    metric: str                    # "worst_burn" | "p99_ms"
    value: float
    limit: float
    regressed: bool
    detail: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        return {k: v for k, v in d.items() if v is not None}


@dataclasses.dataclass
class StreamingVerdict:
    """Out-of-core memory verdict (candidate streaming section's peak
    RSS vs the key's ledger-stamped baselines) — a peak-RSS blowout is
    a first-class regression even when every wall is green, because
    bounded memory IS the streaming contract."""

    metric: str                    # "peak_rss_mb"
    value_mb: float
    baseline_mb: float
    band_mb: float
    regressed: bool
    excess_mb: float = 0.0

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class LoadgenVerdict:
    """Traffic-lane verdict (round 21). Two claims: ``slo_breaches``
    gates history-free (any breach during the run fails outright — the
    spike-recovery contract is ZERO breaches), and
    ``rps_at_slo@<profile>`` gates against the key's ledger-stamped
    baselines where LOWER is the regression (``excess`` carries the
    shortfall below the band floor)."""

    metric: str                    # "slo_breaches" | "rps_at_slo@<p>"
    value: float
    baseline: float
    band: float
    regressed: bool
    excess: float = 0.0
    unit: str = "rps"
    detail: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        return {k: v for k, v in d.items() if v is not None}


@dataclasses.dataclass
class GraphsVerdict:
    """Transfer-op ratchet verdict (round 24): one statically counted
    host-crossing metric from the candidate's ``graphs`` section (or
    its residency audit, for the TODO(item-2) boundary debt) judged
    against the pinned starting debt in NUMERIC_PINS.json
    ``graph_ratchet``. No noise band and no history — op counts are
    deterministic properties of the compiled program, so the pin is a
    ceiling: a count above it fails outright (``detail`` names the op
    kind and source line), a count below it is ratchet progress (the
    pin update is a reviewed edit, never automatic)."""

    metric: str          # "transfer_ops@<stage>" | "host_callbacks@<stage>"
    #                    # | "boundary_calls@<boundary>"
    value: int
    pinned: int
    regressed: bool
    excess: int = 0
    detail: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        return {k: v for k, v in d.items() if v is not None}


@dataclasses.dataclass
class GateVerdict:
    ok: bool
    key: Dict[str, str]
    n_history: int
    stages: List[StageVerdict]
    note: Optional[str] = None
    # flight-recorder bookkeeping: history entries excluded from the
    # baselines because they are partial, and the candidate's own
    # termination cause when it is itself a partial record
    n_partial_excluded: int = 0
    candidate_termination: Optional[str] = None
    # per-stage transfer-bytes verdicts (empty when the candidate carried
    # no residency audit or the key has no transfer history)
    transfers: List[TransferVerdict] = dataclasses.field(
        default_factory=list
    )
    # serving-latency verdicts (empty when the candidate carried no
    # serving section or the key has no latency history)
    serving: List[ServingVerdict] = dataclasses.field(
        default_factory=list
    )
    # out-of-core peak-RSS verdicts (empty when the candidate carried no
    # streaming section or the key has no streaming history)
    streaming: List[StreamingVerdict] = dataclasses.field(
        default_factory=list
    )
    # SLO verdicts (round 20; empty when the candidate carried no slo
    # section) — judged against the record's OWN declared objectives,
    # so they apply even to a key with zero history
    slo: List[SLOVerdict] = dataclasses.field(default_factory=list)
    # traffic-lane verdicts (round 21; empty when the candidate carried
    # no loadgen section) — the breach claim gates history-free
    loadgen: List[LoadgenVerdict] = dataclasses.field(
        default_factory=list
    )
    # transfer-op ratchet verdicts (round 24; empty when the candidate
    # carried no graphs section or NUMERIC_PINS.json has no
    # graph_ratchet entry for its dataset) — pins are ceilings, no band
    graphs: List[GraphsVerdict] = dataclasses.field(
        default_factory=list
    )

    @property
    def regressions(self) -> List[StageVerdict]:
        return [s for s in self.stages if s.regressed]

    @property
    def transfer_regressions(self) -> List[TransferVerdict]:
        return [t for t in self.transfers if t.regressed]

    @property
    def serving_regressions(self) -> List[ServingVerdict]:
        return [s for s in self.serving if s.regressed]

    @property
    def streaming_regressions(self) -> List[StreamingVerdict]:
        return [s for s in self.streaming if s.regressed]

    @property
    def slo_regressions(self) -> List[SLOVerdict]:
        return [s for s in self.slo if s.regressed]

    @property
    def loadgen_regressions(self) -> List[LoadgenVerdict]:
        return [v for v in self.loadgen if v.regressed]

    @property
    def graphs_regressions(self) -> List[GraphsVerdict]:
        return [v for v in self.graphs if v.regressed]

    def to_dict(self) -> Dict[str, Any]:
        return {
            "ok": self.ok,
            "key": self.key,
            "n_history": self.n_history,
            "note": self.note,
            "n_partial_excluded": self.n_partial_excluded,
            "candidate_termination": self.candidate_termination,
            "regressions": [s.to_dict() for s in self.regressions],
            "stages": [s.to_dict() for s in self.stages],
            "transfers": [t.to_dict() for t in self.transfers],
            "transfer_regressions": [
                t.to_dict() for t in self.transfer_regressions
            ],
            "serving": [s.to_dict() for s in self.serving],
            "serving_regressions": [
                s.to_dict() for s in self.serving_regressions
            ],
            "streaming": [s.to_dict() for s in self.streaming],
            "streaming_regressions": [
                s.to_dict() for s in self.streaming_regressions
            ],
            "slo": [s.to_dict() for s in self.slo],
            "slo_regressions": [
                s.to_dict() for s in self.slo_regressions
            ],
            "loadgen": [v.to_dict() for v in self.loadgen],
            "loadgen_regressions": [
                v.to_dict() for v in self.loadgen_regressions
            ],
            "graphs": [v.to_dict() for v in self.graphs],
            "graphs_regressions": [
                v.to_dict() for v in self.graphs_regressions
            ],
        }


def slo_verdicts(candidate: Dict[str, Any]) -> List[SLOVerdict]:
    """SLO-lane verdicts for one candidate: the ``slo`` section judged
    against its OWN declared objectives. Unlike every other lane this
    needs no history — a record whose worst window burn exceeds its
    declared burn_limit, or whose p99 misses its own target, fails
    outright (the section's internal arithmetic was already enforced by
    serve.slo.validate_slo before gating)."""
    slo = candidate.get("slo")
    if not isinstance(slo, dict):
        return []
    out: List[SLOVerdict] = []
    obj = slo.get("objectives") or {}
    worst = slo.get("worst_burn")
    limit = obj.get("burn_limit")
    if isinstance(worst, (int, float)) and isinstance(limit, (int, float)):
        breach = None
        for b in slo.get("burn_rates") or []:
            if (isinstance(b, dict)
                    and float(b.get("burn", 0.0)) > float(limit)):
                breach = (f"window {b.get('window_s')}s burned "
                          f"{b.get('burn')}x its error budget "
                          f"({b.get('bad')}/{b.get('total')} bad)")
                break
        out.append(SLOVerdict(
            metric="worst_burn", value=round(float(worst), 4),
            limit=float(limit),
            regressed=float(worst) > float(limit),
            detail=breach,
        ))
    lat = slo.get("latency") or {}
    p99 = lat.get("p99_ms")
    target = lat.get("target_ms", obj.get("p99_ms"))
    if isinstance(p99, (int, float)) and isinstance(target, (int, float)):
        out.append(SLOVerdict(
            metric="p99_ms", value=round(float(p99), 4),
            limit=float(target),
            regressed=float(p99) > float(target),
        ))
    return out


def loadgen_verdicts(candidate: Dict[str, Any],
                     history: Sequence[Dict[str, Any]]
                     ) -> List[LoadgenVerdict]:
    """Traffic-lane verdicts for one candidate's ``loadgen`` section.

    The breach claim is history-free (the SLOVerdict rule): any breach
    recorded during the run — including a transient mid-spike breach
    the final windows recovered from — fails the gate, because the
    spike-soak contract is recovery WITHOUT a breach. The headline
    claim gates ``rps_at_slo`` against the key's per-profile baselines;
    lower is the regression."""
    lg = candidate.get("loadgen")
    if not isinstance(lg, dict):
        return []
    out: List[LoadgenVerdict] = []
    breaches = lg.get("breaches")
    if isinstance(breaches, list):
        out.append(LoadgenVerdict(
            metric="slo_breaches", value=float(len(breaches)),
            baseline=0.0, band=0.0, regressed=len(breaches) > 0,
            unit="breaches",
            detail="; ".join(str(b) for b in breaches) or None,
        ))
    v = lg.get("rps_at_slo")
    profile = lg.get("profile")
    if isinstance(v, (int, float)) and isinstance(profile, str):
        base = loadgen_baselines(history).get(f"rps_at_slo@{profile}")
        if base is not None:
            floor = base["baseline_rps"] - base["band_rps"]
            lv = LoadgenVerdict(
                metric=f"rps_at_slo@{profile}",
                value=round(float(v), 4),
                baseline=base["baseline_rps"], band=base["band_rps"],
                regressed=float(v) < floor,
            )
            if lv.regressed:
                lv.excess = round(floor - float(v), 4)
            out.append(lv)
    return out


def _graph_sites(sec: Dict[str, Any], stage: str, kind: str) -> str:
    """Human-readable site list for one stage's transfer ops or host
    callbacks: ``op@file:line`` per site, drawn from the stage's
    passports — the line the ratchet FAIL message names."""
    parts: List[str] = []
    programs = sec.get("programs") or {}
    row = (sec.get("by_stage") or {}).get(stage) or {}
    for name in row.get("programs") or []:
        block = (programs.get(name) or {}).get(kind) or {}
        for site in block.get("sites") or []:
            op = site.get("op") or site.get("target") or "?"
            where = site.get("where") or "unknown source"
            parts.append(f"{op}@{where} [{name}]")
    return "; ".join(parts)


def graphs_verdicts(
    candidate: Dict[str, Any], ratchet: Optional[Dict[str, Any]]
) -> Tuple[List[GraphsVerdict], Optional[str]]:
    """Transfer-op ratchet verdicts (round 24) for one candidate against
    one dataset's ``graph_ratchet`` pins entry.

    Three metric families, all ceilings with no noise band (op counts
    are deterministic properties of the compiled program):

    * ``transfer_ops@<stage>`` / ``host_callbacks@<stage>`` — the
      candidate's per-stage static counts from its ``graphs`` section;
      a regressed verdict's detail names each op kind and source line.
    * ``boundary_calls@<boundary>`` — runtime call counts at the
      ``TODO(item-2)`` residency boundaries (the declared host
      crossings item 1 is burning down), from the residency audit.

    Returns ``(verdicts, note)``. The lane refuses to gate — empty
    verdicts, explanatory note — when the candidate has no graphs
    section, the ratchet entry is absent, or the candidate's
    environment-fingerprint digest differs from the pinned one
    (op censuses from different toolchains are different programs)."""
    if not isinstance(ratchet, dict) or not ratchet:
        return [], None
    sec = candidate.get("graphs")
    if not isinstance(sec, dict):
        return [], "graph ratchet pinned but candidate has no graphs section"
    pinned_fp = ratchet.get("fingerprint_digest")
    cand_fp = (sec.get("fingerprint") or {}).get("digest")
    if pinned_fp and cand_fp and pinned_fp != cand_fp:
        return [], (
            f"graph ratchet not applied: candidate fingerprint {cand_fp} "
            f"!= pinned {pinned_fp} (different toolchain compiles a "
            "different program; re-pin on the new toolchain)"
        )
    out: List[GraphsVerdict] = []
    by_stage = sec.get("by_stage") or {}
    for stage in sorted(ratchet.get("stages") or {}):
        pins = ratchet["stages"][stage] or {}
        row = by_stage.get(stage) or {}
        for field, kind in (("transfer_ops", "transfer_ops"),
                            ("host_callbacks", "host_callbacks")):
            pin = pins.get(field)
            if pin is None:
                continue
            value = int(row.get(field, 0))
            v = GraphsVerdict(
                metric=f"{field}@{stage}", value=value, pinned=int(pin),
                regressed=value > int(pin),
            )
            if v.regressed:
                v.excess = value - int(pin)
                v.detail = (_graph_sites(sec, stage, kind)
                            or "sites unavailable in passports")
            out.append(v)
    boundaries = ratchet.get("boundaries") or {}
    if boundaries:
        by_boundary = ((candidate.get("residency") or {})
                       .get("by_boundary") or {})
        for bname in sorted(boundaries):
            pin = (boundaries[bname] or {}).get("calls")
            if pin is None:
                continue
            row = by_boundary.get(bname) or {}
            value = int(row.get("calls", 0))
            v = GraphsVerdict(
                metric=f"boundary_calls@{bname}", value=value,
                pinned=int(pin), regressed=value > int(pin),
            )
            if v.regressed:
                v.excess = value - int(pin)
                v.detail = (
                    f"declared TODO(item-2) crossing {bname!r} ran "
                    f"{value}x vs pinned {int(pin)}x "
                    "(obs.residency BOUNDARIES names the call site)"
                )
            out.append(v)
    return out, None


def _efficiency(cand_cost: Optional[Dict[str, Any]],
                base_cost: Optional[Dict[str, Any]],
                stage: str) -> Optional[Dict[str, Any]]:
    """Regression as efficiency loss: achieved flops/s now vs baseline.
    Needs cost attribution on both sides of the same stage."""
    c = (cand_cost or {}).get(stage)
    b = (base_cost or {}).get(stage)
    if not c or not b:
        return None
    ca, ba = c.get("achieved_gflops"), b.get("achieved_gflops")
    if not ca or not ba:
        return None
    return {
        "achieved_gflops": ca,
        "baseline_gflops": ba,
        "efficiency_loss": round(1.0 - ca / ba, 4),
    }


def gate_record(candidate: Dict[str, Any],
                history: Sequence[Dict[str, Any]],
                baseline_spans: Optional[Sequence[Dict[str, Any]]] = None,
                baseline_cost: Optional[Dict[str, Any]] = None,
                ) -> GateVerdict:
    """Verdict for one candidate run record against its key's history
    (manifest entries, oldest first, candidate excluded). With no history
    the gate passes with a note — a first run cannot regress, it *seeds*
    the baseline. Partial history entries are reported (counted) but never
    anchor baselines; a partial CANDIDATE is gated informationally — its
    completed stages still compare, and the verdict says so."""
    from scconsensus_tpu_torch.obs.cost import stage_cost_summary
    from scconsensus_tpu_torch.obs.ledger import (
        is_partial_entry,
        is_partial_record,
        run_key,
        stage_walls,
        termination_cause,
    )

    key = run_key(candidate)
    n_partial = sum(1 for e in history if is_partial_entry(e))
    cand_term = (termination_cause(candidate)
                 if is_partial_record(candidate) else None)
    note = None
    if cand_term is not None:
        note = (f"candidate is a PARTIAL record (termination.cause="
                f"{cand_term}): reported only — it must never be ingested "
                "as a baseline anchor")
    history = [e for e in history if not is_partial_entry(e)]
    # the SLO lane needs no history: the record carries its own targets
    # (burn_limit, p99), so the verdict applies even on a seeding run —
    # a first record that already burned through its error budget must
    # not seed as if it were clean
    slo = slo_verdicts(candidate)
    # the traffic lane's breach claim is history-free too — a breached
    # load run must not seed as if it were clean
    lg_verdicts = loadgen_verdicts(candidate, history)
    if not history:
        return GateVerdict(ok=(not any(s.regressed for s in slo)
                               and not any(v.regressed
                                           for v in lg_verdicts)),
                           key=key, n_history=0, stages=[],
                           note=note or
                           "no baseline history for this key; "
                           "candidate seeds the baseline",
                           n_partial_excluded=n_partial,
                           candidate_termination=cand_term,
                           slo=slo, loadgen=lg_verdicts)
    baselines = stage_baselines(history)
    if cand_term is not None:
        # "completed stages still compare": OPEN span snapshots in a
        # partial record carry the wall at the moment of death — a wedged
        # stage would fake a regression, a just-started one a pass. Gate
        # only the spans that actually closed.
        candidate = {**candidate, "spans": [
            s for s in candidate.get("spans") or []
            if not (isinstance(s, dict) and (s.get("attrs") or {}).get("open"))
        ]}
    cand_walls = stage_walls(candidate)
    cand_cost = stage_cost_summary(candidate.get("spans") or [])
    stages: List[StageVerdict] = []
    for stage, wall in sorted(cand_walls.items()):
        base = baselines.get(stage)
        if base is None:
            continue  # new stage: nothing to regress against
        limit = base["baseline_s"] + base["band_s"]
        sv = StageVerdict(
            stage=stage, wall_s=round(wall, 6),
            baseline_s=base["baseline_s"], band_s=base["band_s"],
            regressed=wall > limit,
        )
        if sv.regressed:
            sv.excess_s = round(wall - limit, 6)
            if baseline_spans is not None:
                sv.offender = diff_span_trees(
                    candidate.get("spans") or [], baseline_spans, stage
                )
            sv.efficiency = _efficiency(cand_cost, baseline_cost, stage)
        stages.append(sv)
    # transfer-bytes gate (obs.residency): per-stage bytes vs the key's
    # ledger-stamped baselines, same noise-band policy as walls. Only
    # stages BOTH sides audited compare — a candidate without an audit
    # (or a history without one) silently gates walls only.
    from scconsensus_tpu_torch.obs.residency import (
        stage_transfer_bytes as _cand_transfers,
    )

    transfers: List[TransferVerdict] = []
    cand_bytes = _cand_transfers(candidate)
    if cand_bytes:
        tbase = stage_transfer_baselines(history)
        for stage, nbytes in sorted(cand_bytes.items()):
            tb = tbase.get(stage)
            if tb is None:
                continue
            limit_b = tb["baseline_bytes"] + tb["band_bytes"]
            tv = TransferVerdict(
                stage=stage, bytes=int(nbytes),
                baseline_bytes=int(tb["baseline_bytes"]),
                band_bytes=int(tb["band_bytes"]),
                regressed=nbytes > limit_b,
            )
            if tv.regressed:
                tv.excess_bytes = int(nbytes - limit_b)
            transfers.append(tv)
    # serving gate: the candidate's p50/p99 vs the key's ledger-stamped
    # latency baselines (BASELINE.md serving-latency policy). Only the
    # tail (p99) fails the gate; p50 is reported informationally — a p50
    # shift inside a clean p99 is tuning, not a regression. A FLEET
    # candidate (serving.fleet present) gates replica-count-keyed
    # baselines instead — a 4-replica p99 must never be judged against
    # 1-replica history — and additionally gates fleet THROUGHPUT, where
    # lower is the regression: a fleet that kept its single-replica tail
    # clean while losing aggregate throughput has still regressed.
    serving: List[ServingVerdict] = []
    cand_sv = candidate.get("serving") or {}
    cand_lat = cand_sv.get("latency_ms") or {}
    cand_fleet = cand_sv.get("fleet") or {}
    if cand_lat.get("n"):
        sbase = serving_baselines(history)
        if cand_fleet.get("replicas"):
            nrep = int(cand_fleet["replicas"])
            suffix = f"@r{nrep}"
        else:
            suffix = ""
        for short in ("p50", "p99"):
            metric = f"{short}_ms{suffix}"
            v = cand_lat.get(short)
            base = sbase.get(metric)
            if v is None or base is None:
                continue
            limit_ms = base["baseline_ms"] + base["band_ms"]
            svv = ServingVerdict(
                metric=metric, value_ms=round(float(v), 4),
                baseline_ms=base["baseline_ms"], band_ms=base["band_ms"],
                regressed=(short == "p99" and v > limit_ms),
            )
            if svv.regressed:
                svv.excess_ms = round(float(v) - limit_ms, 4)
            serving.append(svv)
        if suffix:
            tp = cand_sv.get("throughput_rps")
            base = sbase.get(f"throughput_rps{suffix}")
            if tp is not None and base is not None:
                floor_rps = base["baseline_ms"] - base["band_ms"]
                svv = ServingVerdict(
                    metric=f"throughput_rps{suffix}",
                    value_ms=round(float(tp), 4),
                    baseline_ms=base["baseline_ms"],
                    band_ms=base["band_ms"],
                    regressed=float(tp) < floor_rps,
                    unit="rps",
                )
                if svv.regressed:
                    svv.excess_ms = round(floor_rps - float(tp), 4)
                serving.append(svv)
    # streaming gate (round 17): the candidate's peak RSS vs the key's
    # ledger-stamped streaming baselines — bounded memory is the
    # out-of-core contract, so a 2× peak with clean walls still fails.
    streaming: List[StreamingVerdict] = []
    cand_sm = candidate.get("streaming") or {}
    peak = (cand_sm.get("budget") or {}).get("peak_rss_mb")
    if isinstance(peak, (int, float)):
        smbase = streaming_baselines(history).get("peak_rss_mb")
        if smbase is not None:
            limit_mb = smbase["baseline_mb"] + smbase["band_mb"]
            smv = StreamingVerdict(
                metric="peak_rss_mb", value_mb=round(float(peak), 3),
                baseline_mb=smbase["baseline_mb"],
                band_mb=smbase["band_mb"],
                regressed=float(peak) > limit_mb,
            )
            if smv.regressed:
                smv.excess_mb = round(float(peak) - limit_mb, 3)
            streaming.append(smv)
    ok = (not any(s.regressed for s in stages)
          and not any(t.regressed for t in transfers)
          and not any(s.regressed for s in serving)
          and not any(s.regressed for s in streaming)
          and not any(s.regressed for s in slo)
          and not any(v.regressed for v in lg_verdicts))
    return GateVerdict(ok=ok, key=key, n_history=len(history),
                       stages=stages, note=note,
                       n_partial_excluded=n_partial,
                       candidate_termination=cand_term,
                       transfers=transfers, serving=serving,
                       streaming=streaming, slo=slo,
                       loadgen=lg_verdicts)


# --------------------------------------------------------------------------
# numeric-drift sentinels
# --------------------------------------------------------------------------

DRIFT_LEDGER_NAME = "DRIFT_LEDGER.jsonl"
_QUANTILES = (0.01, 0.10, 0.25, 0.50, 0.75, 0.90, 0.99)


def _quantiles(values) -> List[float]:
    import numpy as np

    v = np.asarray(values, dtype=np.float64).ravel()
    v = v[np.isfinite(v)]
    if v.size == 0:
        return []
    return [round(float(q), 10) for q in np.quantile(v, _QUANTILES)]


def adjusted_rand_index(a, b) -> float:
    """Plain-numpy ARI (Hubert & Arabie) of two labelings of the same
    items. The reference multiplies the two pair-count sums as int64,
    which wraps once their product passes 2^63 (a few clusters over
    about 80,000 items); here the product is taken in float64, so the
    result is the reference's wherever the reference does not wrap."""
    import numpy as np

    a = np.asarray(a).ravel()
    b = np.asarray(b).ravel()
    if a.size != b.size:
        raise ValueError("label arrays differ in length")
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    c = np.zeros((ai.max() + 1, bi.max() + 1), np.int64)
    np.add.at(c, (ai, bi), 1)
    return ari_from_table(c)


def ari_from_table(c) -> float:
    """ARI from the (Ka, Kb) int64 contingency table of two labelings:
    the same integer pair counts, and so the same float, as
    :func:`adjusted_rand_index` of the labelings themselves."""
    n = int(c.sum())

    def comb2(x):
        return (x * (x - 1)) // 2

    sum_ij = comb2(c).sum()
    sum_a = comb2(c.sum(axis=1)).sum()
    sum_b = comb2(c.sum(axis=0)).sum()
    expected = float(sum_a) * float(sum_b) / max(comb2(n), 1)
    max_index = 0.5 * (sum_a + sum_b)
    if max_index == expected:
        return 1.0
    return float((sum_ij - expected) / (max_index - expected))


def drift_fingerprint(log_p=None, dispersions=None, labels=None,
                      ref_labels=None) -> Dict[str, Any]:
    """Per-run numeric fingerprint: the three cross-round quantities whose
    silent shifts have historically cost diagnosis time. Every field is
    optional — pass what the run computed."""
    fp: Dict[str, Any] = {}
    if log_p is not None:
        fp["de_logp_q"] = _quantiles(log_p)
    if dispersions is not None:
        fp["nb_dispersion_q"] = _quantiles(dispersions)
    if labels is not None and ref_labels is not None:
        fp["label_ari"] = round(adjusted_rand_index(labels, ref_labels), 10)
    return fp


def load_drift_acks(path: str) -> List[Dict[str, Any]]:
    """Acknowledged-drift entries (one JSON object per line; unreadable
    lines are skipped so a half-appended ack cannot poison the file)."""
    acks: List[Dict[str, Any]] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    d = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(d, dict) and d.get("field"):
                    acks.append(d)
    except OSError:
        pass
    return acks


def append_drift_ack(path: str, field: str, pinned, current,
                     reason: str) -> Dict[str, Any]:
    """Append one machine-readable acknowledgement. The entry pins the NEW
    value: a later run matching it is acknowledged, a further shift is a
    fresh drift."""
    entry = {
        "field": field,
        "pinned": pinned,
        "new": current,
        "reason": reason,
        "ts": round(time.time(), 3),
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(entry) + "\n")
    return entry


def _close(a, b, rtol: float, atol: float) -> bool:
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        a = a if isinstance(a, (list, tuple)) else [a]
        b = b if isinstance(b, (list, tuple)) else [b]
        return len(a) == len(b) and all(
            _close(x, y, rtol, atol) for x, y in zip(a, b)
        )
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return abs(a - b) <= atol + rtol * abs(b)
    return a == b


def check_drift(current: Dict[str, Any], pinned: Dict[str, Any],
                acks: Sequence[Dict[str, Any]] = (),
                rtol: float = 1e-3, atol: float = 1e-9
                ) -> List[Dict[str, Any]]:
    """Compare a fingerprint against its pins. Returns one machine-readable
    drift record per shifted field; ``acknowledged`` is True when a drift
    ledger entry pins the new value (within the same tolerance). Fields
    present only on one side are drifts too — a sentinel that silently
    stopped being computed is exactly the failure mode this exists for.
    Underscore-prefixed pin fields are metadata (the pinned labels array,
    the workload note), not sentinels."""
    out: List[Dict[str, Any]] = []
    for field in sorted(set(current) | set(pinned)):
        if field.startswith("_"):
            continue
        cur, pin = current.get(field), pinned.get(field)
        if field in current and field in pinned and _close(
                cur, pin, rtol, atol):
            continue
        acked = any(
            a.get("field") == field and _close(a.get("new"), cur, rtol, atol)
            for a in acks
        )
        out.append({
            "field": field,
            "pinned": pin,
            "current": cur,
            "acknowledged": acked,
        })
    return out


# --------------------------------------------------------------------------
# the pinned reference workload
# --------------------------------------------------------------------------

def reference_fingerprint(ref_labels=None, device=None) -> Dict[str, Any]:
    """Fingerprint of the pinned reference workload: a fixed tiny synthetic
    edgeR slow-path run (seeded, 80 genes × 200 cells × 3 clusters)
    touching every sentinel surface — NB pseudo-counts/dispersions, DE
    p-values, and the final dynamic-cut labels. This is the run
    ``NUMERIC_PINS.json`` pins. Pass the pinned labels to score
    ``label_ari`` against them (without, ARI scores against the run's own
    labels, i.e. 1.0 — the value a pin generation records). ``device``:
    the card by default, as every entry point."""
    data, labels = _reference_workload()
    return _workload_fingerprint(data, labels, ref_labels, device)


def _reference_workload():
    """The pinned workload's seeded input: (data (80, 200) float32,
    noisy labels)."""
    from scconsensus_tpu_torch.utils.synthetic import (
        noisy_labeling,
        synthetic_scrna,
    )

    data, truth, _ = synthetic_scrna(
        n_genes=80, n_cells=200, n_clusters=3, n_markers_per_cluster=8,
        seed=11,
    )
    return data, noisy_labeling(truth, 0.05, seed=2)


def _workload_fingerprint(data, labels, ref_labels=None,
                          device=None) -> Dict[str, Any]:
    """The sentinel fingerprint of the pinned workload's run on ``data``."""
    import numpy as np

    from scconsensus_tpu_torch.models.pipeline import recluster_de_consensus

    result = recluster_de_consensus(
        data, labels, method="edgeR", q_val_thrs=0.05, fc_thrs=1.5,
        deep_split_values=(2,), mesh=None, device=device,
    )
    final = result.dynamic_labels["deepsplit: 2"]
    aux = result.de.aux or {}

    def host(t):
        return None if t is None else np.asarray(t.cpu(), np.float64)

    fp = drift_fingerprint(
        log_p=host(result.de.log_p),
        dispersions=host(aux.get("tagwise_dispersion")),
        labels=final,
        ref_labels=final if ref_labels is None else ref_labels,
    )
    fp["_final_labels"] = [int(v) for v in final]
    return fp


def _fingerprint_spread(a: Dict[str, Any], b: Dict[str, Any]
                        ) -> Dict[str, float]:
    """How far fingerprint ``a`` lies from ``b``: the largest absolute
    difference of the log p quantiles and the largest relative difference
    of the dispersion quantiles."""
    import numpy as np

    lp = np.abs(np.subtract(a["de_logp_q"], b["de_logp_q"]))
    disp = np.abs(np.subtract(a["nb_dispersion_q"], b["nb_dispersion_q"]))
    return {"de_logp_q": float(lp.max()),
            "nb_dispersion_q": float(
                (disp / np.abs(b["nb_dispersion_q"])).max())}


def _input_noise_spread(base: Dict[str, Any], seeds: int = 8,
                        rel: float = 1e-6, device=None
                        ) -> Tuple[Dict[str, float], List[Dict[str, float]]]:
    """The pinned workload's own conditioning: the run on its input times
    ``1 + rel · N(0, 1)`` (numpy seeds 0..seeds−1), each fingerprint's
    :func:`_fingerprint_spread` from ``base`` (the unperturbed run on the
    same device). Returns (the largest spread of each field, every run's
    spread). A difference between two devices no larger than this is
    indistinguishable from float32 rounding of the input."""
    import numpy as np

    data, labels = _reference_workload()
    runs = []
    for seed in range(seeds):
        noise = np.random.default_rng(seed).standard_normal(data.shape)
        runs.append(_fingerprint_spread(_workload_fingerprint(
            (data * (1.0 + rel * noise)).astype(data.dtype), labels,
            device=device), base))
    worst = {k: max(r[k] for r in runs) for k in runs[0]}
    return worst, runs


REFERENCE_DATASET = "reference"


def pins_for_dataset(pins_doc: Any, dataset: str
                     ) -> Optional[Dict[str, Any]]:
    """NUMERIC_PINS.json is keyed by dataset (``{"<dataset>": {pins}}``),
    because a fingerprint is only comparable against pins of the SAME
    workload — scoring a cite8k run against the tiny reference-workload
    pins would read every real bench record as drift. Returns the pin set
    for ``dataset``, or None (= no drift check) when none is pinned."""
    if not isinstance(pins_doc, dict):
        return None
    pins = pins_doc.get(dataset)
    return pins if isinstance(pins, dict) else None


PINS_NAME = "NUMERIC_PINS.json"


def resolve_pins(evidence_dir: str, dataset: str,
                 history: Sequence[Dict[str, Any]]
                 ) -> "Tuple[Optional[Dict[str, Any]], Optional[str]]":
    """ONE pin-resolution policy for every fingerprint consumer
    (perf_gate and explain_run must never disagree about what a
    candidate is compared against): (1) the evidence dir's
    ``NUMERIC_PINS.json`` entry for ``dataset`` when present and
    non-empty; (2) else the key's newest clean manifest entry
    (:func:`history_pins`); (3) else ``(None, None)`` — the candidate
    seeds. Returns ``(pins, source)`` where source is the pins filename
    or ``"history"``. An unreadable pins file falls through to the
    history fallback rather than erroring — a half-written pins file
    must not mask drift checking entirely."""
    pins = None
    path = os.path.join(evidence_dir, PINS_NAME)
    try:
        with open(path) as f:
            pins = pins_for_dataset(json.load(f), dataset)
    except (OSError, json.JSONDecodeError):
        pins = None
    if pins:
        return pins, PINS_NAME
    hp = history_pins(history)
    if hp:
        return hp, "history"
    return None, None


def history_pins(history: Sequence[Dict[str, Any]]
                 ) -> Optional[Dict[str, Any]]:
    """Implicit pins for a dataset with no NUMERIC_PINS entry: the newest
    CLEAN manifest entry's ledger-stamped ``numeric_fingerprint`` (every
    ingested run is stamped — obs.ledger). The quality-drift contract
    then covers any dataset: a candidate fingerprint shifting against its
    own key's previous run fails the gate until acknowledged in the drift
    ledger, exactly like a pinned-reference shift. Returns None with no
    usable history (a first run seeds, it cannot drift)."""
    from scconsensus_tpu_torch.obs.ledger import is_partial_entry

    for e in reversed(list(history)):
        if is_partial_entry(e):
            continue  # a truncated run's fingerprint is not a contract
        fp = e.get("numeric_fingerprint")
        if isinstance(fp, dict) and fp:
            return fp
    return None


def write_pins(path: str, device=None) -> Dict[str, Any]:
    """(Re)generate ``NUMERIC_PINS.json`` from the reference workload
    (stored under the ``"reference"`` dataset key; pins for other datasets
    in an existing file are preserved), run on ``device`` (the card by
    default). Updating the pins is half of acknowledging a drift — the
    other half is the drift-ledger entry (:func:`append_drift_ack`)."""
    from scconsensus_tpu_torch.obs.export import write_json_atomic

    fp = reference_fingerprint(device=device)
    fp["_workload"] = ("edgeR slow path, synthetic 80x200x3 seed=11, "
                       "noisy labels seed=2, deep_split=2 — "
                       "obs.regress.reference_fingerprint")
    doc: Dict[str, Any] = {}
    try:
        with open(path) as f:
            existing = json.load(f)
        if isinstance(existing, dict):
            doc = {k: v for k, v in existing.items()
                   if isinstance(v, dict)}
    except (OSError, json.JSONDecodeError):
        pass
    doc[REFERENCE_DATASET] = fp
    write_json_atomic(path, doc)
    return fp


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="numeric-drift pin tool")
    ap.add_argument("--write-pins", metavar="PATH",
                    help="regenerate NUMERIC_PINS.json at PATH")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.write_pins:
        fp = write_pins(args.write_pins, device=args.device)
        shown = {k: v for k, v in fp.items() if not k.startswith("_")}
        print(json.dumps(shown, indent=1))
        return 0
    ap.error("nothing to do (--write-pins PATH)")
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
