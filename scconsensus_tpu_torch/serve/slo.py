"""SLO objects, mergeable latency histograms and OpenMetrics exposition.

The port's copy of ``scconsensus_tpu/serve/slo.py`` (stdlib only):

* fixed-bucket latency histograms (:data:`LATENCY_BUCKETS_MS`): every
  emitter observes into the same frozen edges, so histograms merge by
  per-bucket addition;
* SLO objects: availability (client-fault refusals excluded from the
  denominator, server-fault outcomes burn the budget) and p99 latency
  against a target, with multi-window burn rates from the same
  cumulative counters the accounting contract validates;
* OpenMetrics text: :func:`render_openmetrics` and the strict reader
  :func:`parse_openmetrics`.

:func:`validate_slo` rejects a section whose availability counts do not
sum, whose burn rates contradict their error ratios, or whose histogram
buckets do not sum to their count.
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from scconsensus_tpu_torch.config import env_flag

__all__ = [
    "LATENCY_BUCKETS_MS",
    "OUTCOME_STATUS",
    "OUTCOME_CLASS",
    "LatencyHistogram",
    "SLOTracker",
    "classify_counts",
    "resolve_objectives",
    "build_slo_section",
    "validate_slo",
    "render_openmetrics",
    "parse_openmetrics",
    "merge_histogram_dicts",
    "p99_ms",
]

# THE fixed bucket upper bounds (ms). Frozen: replica histograms merge
# by per-bucket addition ONLY while every emitter shares these edges.
# Changing them is a schema-level event (old and new records stop being
# mergeable), not a tuning knob.
LATENCY_BUCKETS_MS: Tuple[float, ...] = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0,
)

# One outcome, one status code — the r16 wire table, moved here so the
# wire front, the exposition, and the SLO classification share ONE copy
# (serve.fleet.wire re-exports it; the parity lint pins the coupling).
OUTCOME_STATUS: Dict[str, int] = {
    "ok": 200,
    "degraded": 200,
    "quarantined": 409,
    "rejected_queue": 429,
    "rejected_invalid": 422,
    "rejected_closed": 503,
    "deadline_exceeded": 504,
    "failed": 500,
}

# Availability classes derived from the status table: 2xx serve the
# request, 4xx are client-fault/consistency refusals (excluded from the
# SLO denominator), 5xx are server-fault (they burn the error budget).
OUTCOME_CLASS: Dict[str, str] = {
    o: ("good" if s < 400 else "client" if s < 500 else "bad")
    for o, s in OUTCOME_STATUS.items()
}


def classify_counts(counts: Dict[str, int]) -> Dict[str, int]:
    """Fold per-outcome counters into availability counts:
    ``{good, bad, client, total}`` where total = good + bad (the SLO
    denominator excludes client-fault refusals)."""
    good = bad = client = 0
    for o, n in counts.items():
        cls = OUTCOME_CLASS.get(o)
        if cls == "good":
            good += int(n)
        elif cls == "bad":
            bad += int(n)
        elif cls == "client":
            client += int(n)
    return {"good": good, "bad": bad, "client": client,
            "total": good + bad}


class LatencyHistogram:
    """Fixed-bucket latency histogram (counts per LATENCY_BUCKETS_MS
    bucket + one +Inf overflow bucket, running sum and count). NOT
    thread-safe — the owner's lock (ServingStats/WireStats) serializes
    observers, exactly like the existing counters."""

    __slots__ = ("counts", "sum_ms", "n")

    def __init__(self, counts: Optional[Sequence[int]] = None,
                 sum_ms: float = 0.0, n: int = 0):
        self.counts: List[int] = (list(int(c) for c in counts)
                                  if counts is not None
                                  else [0] * (len(LATENCY_BUCKETS_MS) + 1))
        if len(self.counts) != len(LATENCY_BUCKETS_MS) + 1:
            raise ValueError(
                f"histogram needs {len(LATENCY_BUCKETS_MS) + 1} buckets, "
                f"got {len(self.counts)}"
            )
        self.sum_ms = float(sum_ms)
        self.n = int(n)

    def observe(self, ms: float) -> None:
        ms = max(float(ms), 0.0)
        # the first bucket whose upper bound is >= ms (the overflow bucket
        # past the last bound)
        self.counts[bisect.bisect_left(LATENCY_BUCKETS_MS, ms)] += 1
        self.sum_ms += ms
        self.n += 1

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        for i, c in enumerate(other.counts):
            self.counts[i] += int(c)
        self.sum_ms += other.sum_ms
        self.n += other.n
        return self

    def to_dict(self) -> Dict[str, Any]:
        return {"buckets": list(self.counts),
                "sum_ms": round(self.sum_ms, 4), "count": self.n}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LatencyHistogram":
        return cls(counts=d.get("buckets") or [],
                   sum_ms=float(d.get("sum_ms", 0.0)),
                   n=int(d.get("count", 0)))


def merge_histogram_dicts(dicts: Sequence[Dict[str, Any]]
                          ) -> Dict[str, Any]:
    """Merge serialized histograms (per-bucket sums) — the fleet-level
    series is exactly this over its replicas'."""
    out = LatencyHistogram()
    for d in dicts:
        out.merge(LatencyHistogram.from_dict(d))
    return out.to_dict()


def p99_ms(samples: Sequence[float]) -> Optional[float]:
    """The p99 of raw latency samples (ms), or None when empty — the
    ONE formula every slo-section emitter shares (pool, wire, driver),
    so the gated tail can never be computed three slightly different
    ways."""
    if not samples:
        return None
    s = sorted(float(v) for v in samples)
    return s[min(int(0.99 * len(s)), len(s) - 1)]


class SLOTracker:
    """Time series of cumulative (bad, total) availability counts, ring-
    bounded, for multi-window burn rates computed from the same counters
    the accounting contract validates. ``note`` is called under the
    owner's lock on every outcome; it appends at most one snapshot per
    ``snap_every_s`` so a request storm cannot grow the ring unboundedly
    faster than time passes."""

    _RING = 4096

    def __init__(self, windows_s: Optional[Sequence[float]] = None):
        self.windows_s = tuple(float(w) for w in (
            windows_s if windows_s is not None else resolve_windows()
        ))
        if not self.windows_s:
            raise ValueError("SLO needs at least one burn window")
        # snapshot cadence: fine enough that the SHORTEST window holds
        # ≥16 points, bounded below so a test-scale 0.1 s window still
        # works and above so a 1 h window doesn't snapshot every ms
        self.snap_every_s = min(max(min(self.windows_s) / 16.0, 0.005),
                                5.0)
        self._snaps: List[Tuple[float, int, int]] = []  # (ts, bad, total)
        self._last_snap = 0.0

    def note(self, bad: int, total: int,
             now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else float(now)
        if now - self._last_snap < self.snap_every_s and self._snaps:
            return
        self._snaps.append((now, int(bad), int(total)))
        self._last_snap = now
        if len(self._snaps) > self._RING:
            del self._snaps[: len(self._snaps) - self._RING]

    def window_deltas(self, bad: int, total: int,
                      now: Optional[float] = None
                      ) -> List[Dict[str, Any]]:
        """Per-window (bad_delta, total_delta) vs the oldest snapshot
        inside each trailing window (or the process origin when the
        window is longer than the series — a young process's window IS
        its lifetime)."""
        now = time.monotonic() if now is None else float(now)
        out: List[Dict[str, Any]] = []
        for w in self.windows_s:
            cutoff = now - w
            base_bad = base_total = 0
            for ts, b, t in self._snaps:
                if ts >= cutoff:
                    break
                base_bad, base_total = b, t
            out.append({
                "window_s": w,
                "bad": max(int(bad) - base_bad, 0),
                "total": max(int(total) - base_total, 0),
            })
        return out


def resolve_windows() -> Tuple[float, ...]:
    """Burn windows from SCC_SLO_WINDOWS_S (comma-separated seconds)."""
    raw = str(env_flag("SCC_SLO_WINDOWS_S") or "").strip()
    ws: List[float] = []
    for part in raw.split(","):
        part = part.strip()
        if part:
            ws.append(float(part))
    return tuple(ws) or (300.0, 3600.0)


def resolve_objectives() -> Dict[str, Any]:
    """The process's SLO objectives from the env-flag registry — stamped
    onto the section so the record is self-describing (the gate reads
    the record's own objectives, never this process's env)."""
    return {
        "availability": float(env_flag("SCC_SLO_AVAIL_TARGET")),
        "p99_ms": float(env_flag("SCC_SLO_P99_MS")),
        "windows_s": [float(w) for w in resolve_windows()],
        "burn_limit": float(env_flag("SCC_SLO_BURN_LIMIT")),
    }


def build_slo_section(
    counts: Dict[str, int],
    p99_ms: Optional[float],
    window_deltas: List[Dict[str, Any]],
    latency_hist: Optional[Dict[str, Dict[str, Any]]] = None,
    stage_hist: Optional[Dict[str, Dict[str, Any]]] = None,
    objectives: Optional[Dict[str, Any]] = None,
    obs_overhead: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Assemble the validated ``slo`` run-record section from per-outcome
    counters (+ the tracker's window deltas + serialized histograms)."""
    obj = dict(objectives or resolve_objectives())
    avail = classify_counts(counts)
    ratio = (avail["good"] / avail["total"]) if avail["total"] else 1.0
    budget = max(1.0 - float(obj["availability"]), 1e-9)
    burns: List[Dict[str, Any]] = []
    for wd in window_deltas:
        err = (wd["bad"] / wd["total"]) if wd["total"] else 0.0
        burns.append({
            "window_s": float(wd["window_s"]),
            "bad": int(wd["bad"]),
            "total": int(wd["total"]),
            "error_ratio": round(err, 6),
            "burn": round(err / budget, 4),
        })
    worst = max((b["burn"] for b in burns), default=0.0)
    sec: Dict[str, Any] = {
        "objectives": obj,
        "availability": {
            "good": avail["good"], "bad": avail["bad"],
            "client_excluded": avail["client"], "total": avail["total"],
            "ratio": round(ratio, 6),
        },
        "latency": {
            "p99_ms": (round(float(p99_ms), 4)
                       if p99_ms is not None else None),
            "target_ms": float(obj["p99_ms"]),
            "met": (p99_ms is None
                    or float(p99_ms) <= float(obj["p99_ms"])),
        },
        "burn_rates": burns,
        "worst_burn": round(worst, 4),
        "bucket_bounds_ms": list(LATENCY_BUCKETS_MS),
    }
    if latency_hist:
        sec["latency_hist"] = latency_hist
    if stage_hist:
        sec["stage_hist"] = stage_hist
    if obs_overhead:
        sec["obs_overhead"] = obs_overhead
    return sec


# --------------------------------------------------------------------------
# schema validation (obs.export.validate_run_record dispatches here)
# --------------------------------------------------------------------------

def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"slo section: {msg}")


def _validate_hist(h: Dict[str, Any], where: str) -> None:
    _require(isinstance(h, dict), f"{where} must be an object")
    buckets = h.get("buckets")
    _require(isinstance(buckets, list)
             and len(buckets) == len(LATENCY_BUCKETS_MS) + 1,
             f"{where}.buckets must list "
             f"{len(LATENCY_BUCKETS_MS) + 1} counts "
             f"(the frozen bucket grid + overflow)")
    _require(all(isinstance(c, int) and c >= 0 for c in buckets),
             f"{where}.buckets must be ints >= 0")
    n = h.get("count")
    _require(isinstance(n, int) and n >= 0,
             f"{where}.count must be an int >= 0")
    _require(sum(buckets) == n,
             f"{where}: bucket counts sum to {sum(buckets)} but count "
             f"claims {n} — a histogram must account for every "
             f"observation")
    s = h.get("sum_ms")
    _require(isinstance(s, (int, float)) and s >= 0,
             f"{where}.sum_ms must be a number >= 0")


def validate_slo(slo: Dict[str, Any]) -> None:
    """Structural validation of a record's ``slo`` section. Load-bearing
    rules: availability counts must sum (good + bad == total, the same
    no-lost-request contract one abstraction up), every burn rate must
    equal its own window's error ratio over the declared budget, the
    declared worst_burn must BE the worst, and histogram bucket counts
    must sum to their count — an SLO claim that contradicts its own
    arithmetic is rejected."""
    _require(isinstance(slo, dict), "must be an object")
    obj = slo.get("objectives")
    _require(isinstance(obj, dict), "objectives must be an object")
    tgt = obj.get("availability")
    _require(isinstance(tgt, (int, float)) and 0.0 < tgt <= 1.0,
             "objectives.availability must be in (0, 1]")
    p99t = obj.get("p99_ms")
    _require(isinstance(p99t, (int, float)) and p99t > 0,
             "objectives.p99_ms must be a number > 0")
    ws = obj.get("windows_s")
    _require(isinstance(ws, list) and ws
             and all(isinstance(w, (int, float)) and w > 0 for w in ws),
             "objectives.windows_s must be a non-empty list of "
             "positive seconds")
    lim = obj.get("burn_limit")
    _require(isinstance(lim, (int, float)) and lim > 0,
             "objectives.burn_limit must be a number > 0")
    av = slo.get("availability")
    _require(isinstance(av, dict), "availability must be an object")
    for k in ("good", "bad", "total"):
        v = av.get(k)
        _require(isinstance(v, int) and v >= 0,
                 f"availability.{k} must be an int >= 0")
    _require(
        av["good"] + av["bad"] == av["total"],
        f"availability accounting broken: good={av['good']} + "
        f"bad={av['bad']} != total={av['total']}",
    )
    ratio = av.get("ratio")
    _require(isinstance(ratio, (int, float)) and 0.0 <= ratio <= 1.0,
             "availability.ratio must be in [0, 1]")
    if av["total"]:
        want = av["good"] / av["total"]
        _require(abs(float(ratio) - want) < 1e-3,
                 f"availability.ratio={ratio} contradicts its own "
                 f"counts (good/total = {want:.6f})")
    lat = slo.get("latency")
    _require(isinstance(lat, dict), "latency must be an object")
    p99 = lat.get("p99_ms")
    if p99 is not None:
        _require(isinstance(p99, (int, float)) and p99 >= 0,
                 "latency.p99_ms must be a number >= 0 or null")
        _require(bool(lat.get("met")) == (float(p99)
                                          <= float(lat.get("target_ms",
                                                           p99t))),
                 "latency.met contradicts p99_ms vs target_ms")
    burns = slo.get("burn_rates")
    _require(isinstance(burns, list) and len(burns) == len(ws),
             "burn_rates must list exactly one entry per "
             "objectives.windows_s window")
    budget = max(1.0 - float(tgt), 1e-9)
    worst = 0.0
    for i, b in enumerate(burns):
        where = f"burn_rates[{i}]"
        _require(isinstance(b, dict), f"{where} must be an object")
        _require(b.get("window_s") == ws[i],
                 f"{where}.window_s must match objectives.windows_s[{i}]")
        for k in ("bad", "total"):
            v = b.get(k)
            _require(isinstance(v, int) and v >= 0,
                     f"{where}.{k} must be an int >= 0")
        err = b.get("error_ratio")
        _require(isinstance(err, (int, float)) and 0.0 <= err <= 1.0,
                 f"{where}.error_ratio must be in [0, 1]")
        if b["total"]:
            want = b["bad"] / b["total"]
            _require(abs(float(err) - want) < 1e-3,
                     f"{where}.error_ratio={err} contradicts its own "
                     f"counts (bad/total = {want:.6f})")
        burn = b.get("burn")
        _require(isinstance(burn, (int, float)) and burn >= 0,
                 f"{where}.burn must be a number >= 0")
        _require(abs(float(burn) - float(err) / budget) < 0.01
                 * max(1.0, float(burn)),
                 f"{where}.burn={burn} contradicts error_ratio/budget "
                 f"({float(err) / budget:.4f})")
        worst = max(worst, float(burn))
    wb = slo.get("worst_burn")
    _require(isinstance(wb, (int, float)) and abs(float(wb) - worst)
             < 0.01 * max(1.0, worst),
             f"worst_burn={wb} is not the worst burn rate ({worst})")
    bounds = slo.get("bucket_bounds_ms")
    _require(bounds == list(LATENCY_BUCKETS_MS),
             "bucket_bounds_ms must be the frozen grid "
             "(histograms are only mergeable on shared edges)")
    for fam in ("latency_hist", "stage_hist"):
        hists = slo.get(fam)
        if hists is None:
            continue
        _require(isinstance(hists, dict), f"{fam} must be an object")
        for key, h in hists.items():
            _validate_hist(h, f"{fam}[{key}]")
    oh = slo.get("obs_overhead")
    if oh is not None:
        _require(isinstance(oh, dict), "obs_overhead must be an object")
        for k in ("on_ms", "off_ms"):
            v = oh.get(k)
            _require(isinstance(v, (int, float)) and v >= 0,
                     f"obs_overhead.{k} must be a number >= 0")


# --------------------------------------------------------------------------
# OpenMetrics text exposition
# --------------------------------------------------------------------------

def _esc(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _labels(d: Dict[str, Any]) -> str:
    if not d:
        return ""
    inner = ",".join(f'{k}="{_esc(v)}"' for k, v in sorted(d.items()))
    return "{" + inner + "}"


def _fmt(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


class _Expo:
    """Accumulates families in declaration order, renders once."""

    def __init__(self):
        self._fams: List[Tuple[str, str, str, List[str]]] = []
        self._index: Dict[str, int] = {}

    def family(self, name: str, mtype: str, help_text: str) -> None:
        if name not in self._index:
            self._index[name] = len(self._fams)
            self._fams.append((name, mtype, help_text, []))

    def sample(self, name: str, labels: Dict[str, Any], value: float,
               suffix: str = "") -> None:
        self._fams[self._index[name]][3].append(
            f"{name}{suffix}{_labels(labels)} {_fmt(value)}"
        )

    def histogram(self, name: str, labels: Dict[str, Any],
                  h: Dict[str, Any]) -> None:
        cum = 0
        buckets = h.get("buckets") or []
        for i, le in enumerate(LATENCY_BUCKETS_MS):
            cum += int(buckets[i]) if i < len(buckets) else 0
            self.sample(name, {**labels, "le": _fmt(le)}, cum,
                        suffix="_bucket")
        cum += int(buckets[-1]) if len(buckets) == len(
            LATENCY_BUCKETS_MS) + 1 else 0
        self.sample(name, {**labels, "le": "+Inf"}, cum,
                    suffix="_bucket")
        self.sample(name, labels, int(h.get("count", 0)),
                    suffix="_count")
        self.sample(name, labels, float(h.get("sum_ms", 0.0)),
                    suffix="_sum")

    def render(self) -> str:
        out: List[str] = []
        for name, mtype, help_text, samples in self._fams:
            out.append(f"# TYPE {name} {mtype}")
            if help_text:
                out.append(f"# HELP {name} {help_text}")
            out.extend(samples)
        out.append("# EOF")
        return "\n".join(out) + "\n"


def render_openmetrics(snapshot: Dict[str, Any]) -> str:
    """OpenMetrics text from one telemetry snapshot:

    ``snapshot = {"scopes": [scope...], "wire": wire?, "slo": slo?}``
    where each scope is ``{"labels": {replica, model?}, "counts",
    "queue_depth", "queue_cap", "breaker", "trips", "latency_hist":
    {outcome: hist}, "stage_hist": {stage: hist}}`` — per-replica scopes
    plus the pre-merged ``replica="fleet"`` aggregate, all taken under
    ONE lock (the hot-swap torn-read fix lives in the snapshot, not
    here). Every OUTCOMES entry gets exactly one counter and one
    histogram series per scope — zero-valued series are emitted on
    purpose; the parity lint reads them."""
    from scconsensus_tpu_torch.serve import metrics as serve_metrics

    e = _Expo()
    e.family("scc_requests_total", "counter",
             "typed request outcomes (one per OUTCOMES entry)")
    e.family("scc_request_latency_ms", "histogram",
             "request latency by outcome (frozen bucket grid)")
    e.family("scc_stage_latency_ms", "histogram",
             "per-stage latency (queue_wait, compute)")
    e.family("scc_queue_depth", "gauge", "admission queue depth")
    e.family("scc_queue_capacity", "gauge", "admission queue capacity")
    e.family("scc_breaker_state", "gauge",
             "circuit breaker (0=closed 1=half_open 2=open)")
    e.family("scc_breaker_trips_total", "counter", "breaker trips")
    for scope in snapshot.get("scopes") or []:
        labels = dict(scope.get("labels") or {})
        counts = scope.get("counts") or {}
        for o in serve_metrics.OUTCOMES:
            e.sample("scc_requests_total", {**labels, "outcome": o},
                     int(counts.get(o, 0)))
        lh = scope.get("latency_hist") or {}
        for o in serve_metrics.OUTCOMES:
            e.histogram("scc_request_latency_ms",
                        {**labels, "outcome": o},
                        lh.get(o) or LatencyHistogram().to_dict())
        for stage, h in sorted((scope.get("stage_hist") or {}).items()):
            e.histogram("scc_stage_latency_ms",
                        {**labels, "stage": stage}, h)
        if scope.get("queue_depth") is not None:
            e.sample("scc_queue_depth", labels,
                     int(scope["queue_depth"]))
            e.sample("scc_queue_capacity", labels,
                     int(scope.get("queue_cap", 0)))
        state = scope.get("breaker")
        if state is not None:
            e.sample("scc_breaker_state", labels,
                     serve_metrics.BREAKER_SEVERITY.get(state, 0))
            e.sample("scc_breaker_trips_total", labels,
                     int(scope.get("trips", 0)))
    wire = snapshot.get("wire")
    if wire is not None:
        e.family("scc_wire_requests_total", "counter",
                 "wire outcomes (one per outcome, with its one "
                 "status code)")
        counts = wire.get("counts") or {}
        for o, code in sorted(OUTCOME_STATUS.items()):
            e.sample("scc_wire_requests_total",
                     {"outcome": o, "code": str(code)},
                     int(counts.get(o, 0)))
    slo = snapshot.get("slo")
    if slo is not None:
        e.family("scc_slo_availability", "gauge",
                 "availability ratio (good / (good+bad))")
        e.family("scc_slo_burn_rate", "gauge",
                 "error-budget burn rate per trailing window")
        av = slo.get("availability") or {}
        if av.get("ratio") is not None:
            e.sample("scc_slo_availability", {}, float(av["ratio"]))
        for b in slo.get("burn_rates") or []:
            e.sample("scc_slo_burn_rate",
                     {"window_s": _fmt(b["window_s"])},
                     float(b["burn"]))
        oh = slo.get("obs_overhead")
        if oh and oh.get("ratio") is not None:
            e.family("scc_obs_overhead_ratio", "gauge",
                     "telemetry-plane overhead: mean latency with the "
                     "plane on / off")
            e.sample("scc_obs_overhead_ratio", {}, float(oh["ratio"]))
    return e.render()


def parse_openmetrics(text: str) -> Dict[str, Any]:
    """Minimal OpenMetrics reader for tests/tools: returns
    ``{"types": {family: type}, "samples": {(name, (sorted label
    pairs...)): value}}``. Raises ValueError on a malformed line or a
    missing ``# EOF`` — 'parseable' is an acceptance criterion, so the
    checker must be strict."""
    types: Dict[str, str] = {}
    samples: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
    saw_eof = False
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        if saw_eof:
            raise ValueError(f"line {lineno}: content after # EOF")
        if line == "# EOF":
            saw_eof = True
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            name, _, mtype = rest.partition(" ")
            types[name] = mtype.strip()
            continue
        if line.startswith("#"):
            continue  # HELP/UNIT
        brace = line.find("{")
        if brace >= 0:
            name = line[:brace]
            end = line.rfind("}")
            if end < brace:
                raise ValueError(f"line {lineno}: unterminated labels")
            body, value_s = line[brace + 1:end], line[end + 1:].strip()
            labels: List[Tuple[str, str]] = []
            for part in _split_labels(body):
                k, _, v = part.partition("=")
                if not (v.startswith('"') and v.endswith('"')):
                    raise ValueError(
                        f"line {lineno}: unquoted label value in {part!r}"
                    )
                labels.append((k, _unescape(v[1:-1])))
        else:
            name, _, value_s = line.partition(" ")
            labels = []
        try:
            value = float(value_s.split()[0])
        except (ValueError, IndexError):
            raise ValueError(f"line {lineno}: bad sample value "
                             f"{value_s!r}")
        key = (name, tuple(sorted(labels)))
        if key in samples:
            raise ValueError(f"line {lineno}: duplicate series {key}")
        samples[key] = value
    if not saw_eof:
        raise ValueError("missing # EOF terminator")
    return {"types": types, "samples": samples}


def _unescape(v: str) -> str:
    """Left-to-right escape decoding (the inverse of _esc). Sequential
    str.replace passes decode r'\\n' (backslash-then-n in the source
    value) to a real newline; a single scan cannot."""
    out: List[str] = []
    i = 0
    while i < len(v):
        if v[i] == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            if nxt == "n":
                out.append("\n")
                i += 2
                continue
            if nxt in ('"', "\\"):
                out.append(nxt)
                i += 2
                continue
        out.append(v[i])
        i += 1
    return "".join(out)


def _split_labels(body: str) -> List[str]:
    """Split a label body on commas outside quotes."""
    parts: List[str] = []
    cur: List[str] = []
    in_q = False
    prev = ""
    for ch in body:
        if ch == '"' and prev != "\\":
            in_q = not in_q
        if ch == "," and not in_q:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
        prev = ch
    if cur:
        parts.append("".join(cur))
    return [p for p in (p.strip() for p in parts) if p]


# --------------------------------------------------------------------------
# obs-overhead gauge (the plane accounting for itself)
# --------------------------------------------------------------------------

_OVERHEAD_LOCK = threading.Lock()
_OVERHEAD: Optional[Dict[str, Any]] = None


def set_obs_overhead(gauge: Optional[Dict[str, Any]]) -> None:
    """Publish (or clear) the process's measured obs-overhead gauge —
    the soak's on/off measurement writes it; the exposition and the
    slo section read it."""
    global _OVERHEAD
    with _OVERHEAD_LOCK:
        _OVERHEAD = dict(gauge) if gauge else None


def obs_overhead() -> Optional[Dict[str, Any]]:
    with _OVERHEAD_LOCK:
        return dict(_OVERHEAD) if _OVERHEAD else None
