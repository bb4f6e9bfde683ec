"""Serving stats and the validated ``serving`` section.

The port's copy of ``scconsensus_tpu/serve/metrics.py`` (stdlib only).
One :class:`ServingStats` per driver; the driver registers it as the
process's active stats, which :func:`live_summary` reads (a running
``ReplicaPool`` registers its aggregated fleet summary instead, through
:func:`set_active_fleet`). The section's load-bearing rule, enforced by
:func:`validate_serving`: every submitted request is accounted for,
``requests.submitted`` equals the sum of the outcome counters, at the
wire front (:class:`WireStats`) as at each replica, and across a fleet's
merged sections (:func:`merge_serving_sections`).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional

from scconsensus_tpu_torch.serve import slo as serve_slo

__all__ = [
    "OUTCOMES",
    "BREAKER_STATES",
    "BREAKER_SEVERITY",
    "STAGE_HIST_STAGES",
    "ServingStats",
    "WireStats",
    "merge_serving_sections",
    "active_stats",
    "set_active_fleet",
    "live_summary",
    "validate_serving",
]

# Every way a request can leave the system. submit-time rejections
# (queue-full, invalid, closed) never reach a batch; the rest resolve
# from one.
OUTCOMES = (
    "ok",                 # labels returned, device path, breaker closed
    "degraded",           # labels returned by the HOST fallback, flagged
    "quarantined",        # drift gate refused confident labels; ledgered
    "rejected_queue",     # bounded-admission backpressure (retry-after)
    "rejected_invalid",   # malformed request, refused at admission
    "rejected_closed",    # typed ServerClosed (shutdown / undrained stop)
    "deadline_exceeded",  # typed late failure (queue wait or compute)
    "failed",             # fatal batch error, typed RequestFailed
)

BREAKER_STATES = ("closed", "open", "half_open")

# Rolling latency reservoir size: enough for a stable p99 (the live panel
# and the section both read it), bounded so a soak cannot grow the record.
_LATENCY_RING = 4096

# The per-stage latency histogram vocabulary (serve.slo fixed-bucket
# grids): queue_wait is dequeue-minus-enqueue per request, compute is the
# batch classify wall — the two halves a p99 decomposes into.
STAGE_HIST_STAGES = ("queue_wait", "compute")

# Recent-request ring per stats object (trace ids, outcomes, latencies),
# bounded so a live summary stays small.
_RECENT_RING = 8


class ServingStats:
    """Thread-safe counters for one serving driver's lifetime."""

    def __init__(self, queue_capacity: int = 0):
        self.queue_capacity = int(queue_capacity)
        self.counts: Dict[str, int] = {o: 0 for o in OUTCOMES}
        self.submitted = 0
        self.queue_depth = 0
        self.queue_peak = 0
        self.batches = 0
        self.batch_cells = 0
        self.batch_max = 0
        self.breaker_state = "closed"
        self.breaker_trips = 0
        self.drift_batches = 0
        self.quarantine_entries = 0
        self.consumed_s = 0.0       # self-measured driver bookkeeping
        self.classify_wall_s = 0.0  # cumulative classify-call wall
        self.started_unix = time.time()
        self._lat_ms: List[float] = []
        self._lat_i = 0             # ring cursor
        self._lat_n = 0
        self._lat_sum = 0.0
        self._lat_max = 0.0
        # per-outcome and per-stage fixed-bucket histograms, the
        # multi-window SLO tracker and the recent-trace ring
        self.lat_hist: Dict[str, serve_slo.LatencyHistogram] = {
            o: serve_slo.LatencyHistogram() for o in OUTCOMES
        }
        self.stage_hist: Dict[str, serve_slo.LatencyHistogram] = {
            s: serve_slo.LatencyHistogram() for s in STAGE_HIST_STAGES
        }
        self.slo_track = serve_slo.SLOTracker()
        self.recent: "collections.deque" = collections.deque(
            maxlen=_RECENT_RING
        )
        # running availability counters (good+bad=total, client-fault
        # excluded): kept incrementally so the per-request note is O(1)
        # — this path sits inside the <2% driver overhead guard
        self._av_bad = 0
        self._av_total = 0
        self._lock = threading.Lock()

    # -- notes -------------------------------------------------------------
    def note_submit(self, depth: int) -> None:
        with self._lock:
            self.submitted += 1
            self.queue_depth = int(depth)
            self.queue_peak = max(self.queue_peak, int(depth))

    def note_queue_depth(self, depth: int) -> None:
        with self._lock:
            self.queue_depth = int(depth)
            self.queue_peak = max(self.queue_peak, int(depth))

    def note_outcome(self, outcome: str,
                     latency_s: Optional[float] = None,
                     trace_id: Optional[str] = None) -> None:
        if outcome not in OUTCOMES:
            raise ValueError(f"unknown serving outcome {outcome!r}")
        with self._lock:
            self.counts[outcome] += 1
            if latency_s is not None:
                ms = max(float(latency_s), 0.0) * 1e3
                if len(self._lat_ms) < _LATENCY_RING:
                    self._lat_ms.append(ms)
                else:
                    self._lat_ms[self._lat_i] = ms
                    self._lat_i = (self._lat_i + 1) % _LATENCY_RING
                self._lat_n += 1
                self._lat_sum += ms
                self._lat_max = max(self._lat_max, ms)
                self.lat_hist[outcome].observe(ms)
            cls = serve_slo.OUTCOME_CLASS.get(outcome)
            if cls == "good":
                self._av_total += 1
            elif cls == "bad":
                self._av_bad += 1
                self._av_total += 1
            self.slo_track.note(self._av_bad, self._av_total)
            if trace_id:
                self.recent.append({
                    "trace_id": trace_id, "outcome": outcome,
                    "latency_ms": (round(float(latency_s) * 1e3, 3)
                                   if latency_s is not None else None),
                    "ts": round(time.time(), 3),
                })

    def note_stage_latency(self, stage: str, seconds: float) -> None:
        """Observe one per-stage latency (queue_wait / compute) into the
        stage's fixed-bucket histogram."""
        if stage not in STAGE_HIST_STAGES:
            raise ValueError(f"unknown latency stage {stage!r}")
        with self._lock:
            self.stage_hist[stage].observe(max(float(seconds), 0.0) * 1e3)

    def note_batch(self, n_requests: int, n_cells: int) -> None:
        with self._lock:
            self.batches += 1
            self.batch_cells += int(n_cells)
            self.batch_max = max(self.batch_max, int(n_cells))

    def note_breaker(self, state: str, tripped: bool = False) -> None:
        if state not in BREAKER_STATES:
            raise ValueError(f"unknown breaker state {state!r}")
        with self._lock:
            self.breaker_state = state
            if tripped:
                self.breaker_trips += 1

    def note_drift_batch(self, quarantined: int = 0) -> None:
        with self._lock:
            self.drift_batches += 1
            self.quarantine_entries += int(quarantined)

    def add_consumed(self, dt: float) -> None:
        with self._lock:
            self.consumed_s += max(float(dt), 0.0)

    def add_classify_wall(self, dt: float) -> None:
        with self._lock:
            self.classify_wall_s += max(float(dt), 0.0)

    def latency_samples(self) -> List[float]:
        """Copy of the raw latency ring (ms) — the fleet aggregator merges
        per-replica rings so pool quantiles come from real samples, not
        from averaging quantiles (which is statistically meaningless)."""
        with self._lock:
            return list(self._lat_ms)

    def expo_snapshot(self) -> Dict[str, Any]:
        """One internally consistent exposition snapshot (counters,
        gauges, serialized histograms, the recent-trace ring, and the
        SLO window deltas) taken under this stats object's lock: the unit
        ``serve.slo.render_openmetrics`` renders."""
        with self._lock:
            av = serve_slo.classify_counts(self.counts)
            return {
                "counts": dict(self.counts),
                "submitted": self.submitted,
                "queue_depth": self.queue_depth,
                "queue_cap": self.queue_capacity,
                "breaker": self.breaker_state,
                "trips": self.breaker_trips,
                "latency_hist": {o: h.to_dict()
                                 for o, h in self.lat_hist.items()},
                "stage_hist": {s: h.to_dict()
                               for s, h in self.stage_hist.items()},
                "recent": list(self.recent),
                "window_deltas": self.slo_track.window_deltas(
                    av["bad"], av["total"]
                ),
            }

    def slo_section(self, obs_overhead: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, Any]:
        """The validated ``slo`` section for this driver's lifetime."""
        snap = self.expo_snapshot()
        p99 = self.latency_ms().get("p99")
        return serve_slo.build_slo_section(
            snap["counts"], p99, snap["window_deltas"],
            latency_hist=snap["latency_hist"],
            stage_hist=snap["stage_hist"],
            obs_overhead=obs_overhead or serve_slo.obs_overhead(),
        )

    # -- reads -------------------------------------------------------------
    def latency_ms(self) -> Dict[str, Any]:
        with self._lock:
            if self._lat_n == 0:
                return {"n": 0}
            # one sort for both quantiles, under the lock the hot path
            # takes
            s = sorted(self._lat_ms)
            return {
                "n": self._lat_n,
                "p50": round(s[min(int(0.50 * len(s)), len(s) - 1)], 4),
                "p99": round(s[min(int(0.99 * len(s)), len(s) - 1)], 4),
                "max": round(self._lat_max, 4),
                "mean": round(self._lat_sum / self._lat_n, 4),
            }

    def section(self) -> Dict[str, Any]:
        """The run record's ``serving`` section (always present once a
        driver ran — unlike robustness, an all-healthy serving window is
        itself the evidence: N requests in, N outcomes out)."""
        lat = self.latency_ms()
        with self._lock:
            wall = max(time.time() - self.started_unix, 0.0)
            served = sum(self.counts[o]
                         for o in ("ok", "degraded", "quarantined"))
            return {
                "requests": {"submitted": self.submitted,
                             **dict(self.counts)},
                "latency_ms": lat,
                "throughput_rps": round(served / wall, 4) if wall else 0.0,
                "batches": {
                    "count": self.batches,
                    "cells": self.batch_cells,
                    "max_cells": self.batch_max,
                    "mean_cells": (round(self.batch_cells / self.batches, 2)
                                   if self.batches else 0.0),
                },
                "queue": {"depth_peak": self.queue_peak,
                          "capacity": self.queue_capacity},
                "breaker": {"state": self.breaker_state,
                            "trips": self.breaker_trips},
                "drift": {"batches_flagged": self.drift_batches,
                          "quarantine_entries": self.quarantine_entries},
                "consumed_s": round(self.consumed_s, 4),
                "classify_wall_s": round(self.classify_wall_s, 4),
                "window_s": round(wall, 4),
            }


# -- wire-front accounting --------------------------------------------------

class WireStats:
    """HTTP-layer accounting for the fleet's wire front: every wire
    request resolves to exactly ONE typed outcome (the same OUTCOMES
    vocabulary the driver uses) mapped to exactly one status code. The
    r15 accounting rule holds at the wire layer too — a wire request
    that got a socket but no counted outcome is the dropped-request
    failure mode all over again, one layer up."""

    def __init__(self):
        self.submitted = 0
        self.counts: Dict[str, int] = {o: 0 for o in OUTCOMES}
        self.status_codes: Dict[str, int] = {}
        # wire-level telemetry (round 20): the front is the one place
        # every request of the whole fleet passes, so the formal SLO
        # (availability + burn windows) and the end-to-end per-outcome
        # latency histograms anchor HERE; replicas keep their own for
        # the per-replica exposition and the merge proof
        self.lat_hist: Dict[str, serve_slo.LatencyHistogram] = {
            o: serve_slo.LatencyHistogram() for o in OUTCOMES
        }
        self.slo_track = serve_slo.SLOTracker()
        self.recent: "collections.deque" = collections.deque(
            maxlen=_RECENT_RING
        )
        self._av_bad = 0
        self._av_total = 0
        self._lock = threading.Lock()

    def note(self, outcome: str, status: int,
             latency_s: Optional[float] = None,
             trace_id: Optional[str] = None) -> None:
        if outcome not in OUTCOMES:
            raise ValueError(f"unknown wire outcome {outcome!r}")
        with self._lock:
            self.submitted += 1
            self.counts[outcome] += 1
            key = str(int(status))
            self.status_codes[key] = self.status_codes.get(key, 0) + 1
            if latency_s is not None:
                self.lat_hist[outcome].observe(
                    max(float(latency_s), 0.0) * 1e3
                )
            cls = serve_slo.OUTCOME_CLASS.get(outcome)
            if cls == "good":
                self._av_total += 1
            elif cls == "bad":
                self._av_bad += 1
                self._av_total += 1
            self.slo_track.note(self._av_bad, self._av_total)
            if trace_id:
                self.recent.append({
                    "trace_id": trace_id, "outcome": outcome,
                    "status": int(status),
                    "ts": round(time.time(), 3),
                })

    def section(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "requests": {"submitted": self.submitted,
                             **dict(self.counts)},
                "status_codes": dict(self.status_codes),
            }

    def expo_snapshot(self) -> Dict[str, Any]:
        """Wire-scope exposition snapshot (counters + status codes +
        end-to-end histograms + SLO window deltas), one lock hold."""
        with self._lock:
            av = serve_slo.classify_counts(self.counts)
            return {
                "counts": dict(self.counts),
                "submitted": self.submitted,
                "status_codes": dict(self.status_codes),
                "latency_hist": {o: h.to_dict()
                                 for o, h in self.lat_hist.items()},
                "recent": list(self.recent),
                "window_deltas": self.slo_track.window_deltas(
                    av["bad"], av["total"]
                ),
            }


# -- fleet aggregation ------------------------------------------------------

# one severity order for every consumer (pool routing, live-panel
# worst-state fold, merged-section breaker) — two copies of this map
BREAKER_SEVERITY = {"closed": 0, "half_open": 1, "open": 2}


def _quantile_summary(samples: List[float], n_total: int,
                      total_sum: float, mx: float) -> Dict[str, Any]:
    if not samples or n_total <= 0:
        return {"n": 0}
    s = sorted(samples)
    return {
        "n": int(n_total),
        "p50": round(s[min(int(0.50 * len(s)), len(s) - 1)], 4),
        "p99": round(s[min(int(0.99 * len(s)), len(s) - 1)], 4),
        "max": round(mx, 4),
        "mean": round(total_sum / n_total, 4),
    }


def merge_serving_sections(
    sections: List[Dict[str, Any]],
    latency_samples: List[List[float]],
    window_s: float,
) -> Dict[str, Any]:
    """Fold per-replica serving sections (live + retired + the pool's own
    boundary stats) into ONE pool-level section the accounting rule still
    holds over: counters sum, latency quantiles come from the merged raw
    sample rings, the breaker reports the worst live state, and drift /
    batch / queue evidence aggregates. Sum-of-valid-sections is valid by
    construction: submitted and the outcome counters sum on both sides of
    the accounting equation."""
    req: Dict[str, int] = {"submitted": 0, **{o: 0 for o in OUTCOMES}}
    batches = {"count": 0, "cells": 0, "max_cells": 0}
    queue = {"depth_peak": 0, "capacity": 0}
    breaker = {"state": "closed", "trips": 0}
    drift = {"batches_flagged": 0, "quarantine_entries": 0}
    consumed = classify_wall = 0.0
    lat_n = 0
    lat_sum = 0.0
    lat_max = 0.0
    for sec in sections:
        r = sec.get("requests") or {}
        req["submitted"] += int(r.get("submitted", 0))
        for o in OUTCOMES:
            req[o] += int(r.get(o, 0))
        b = sec.get("batches") or {}
        batches["count"] += int(b.get("count", 0))
        batches["cells"] += int(b.get("cells", 0))
        batches["max_cells"] = max(batches["max_cells"],
                                   int(b.get("max_cells", 0)))
        q = sec.get("queue") or {}
        queue["depth_peak"] = max(queue["depth_peak"],
                                  int(q.get("depth_peak", 0)))
        queue["capacity"] += int(q.get("capacity", 0))
        br = sec.get("breaker") or {}
        if (BREAKER_SEVERITY.get(br.get("state"), 0)
                > BREAKER_SEVERITY[breaker["state"]]):
            breaker["state"] = br.get("state")
        breaker["trips"] += int(br.get("trips", 0))
        d = sec.get("drift") or {}
        drift["batches_flagged"] += int(d.get("batches_flagged", 0))
        drift["quarantine_entries"] += int(d.get("quarantine_entries", 0))
        consumed += float(sec.get("consumed_s", 0.0))
        classify_wall += float(sec.get("classify_wall_s", 0.0))
        lat = sec.get("latency_ms") or {}
        n = int(lat.get("n", 0))
        lat_n += n
        lat_sum += float(lat.get("mean", 0.0)) * n
        lat_max = max(lat_max, float(lat.get("max", 0.0)))
    merged = [ms for ring in latency_samples for ms in ring]
    served = sum(req[o] for o in ("ok", "degraded", "quarantined"))
    window_s = max(float(window_s), 0.0)
    batches["mean_cells"] = (round(batches["cells"] / batches["count"], 2)
                             if batches["count"] else 0.0)
    return {
        "requests": req,
        "latency_ms": _quantile_summary(merged, lat_n, lat_sum, lat_max),
        "throughput_rps": (round(served / window_s, 4)
                           if window_s else 0.0),
        "batches": batches,
        "queue": queue,
        "breaker": breaker,
        "drift": drift,
        "consumed_s": round(consumed, 4),
        "classify_wall_s": round(classify_wall, 4),
        "window_s": round(window_s, 4),
    }


# -- the process's active stats (heartbeat feed) ----------------------------

_ACTIVE: Optional[ServingStats] = None
_ACTIVE_FLEET = None  # () -> live-summary dict; a ReplicaPool registers it
_ACTIVE_LOCK = threading.Lock()


def set_active(stats: Optional[ServingStats]) -> None:
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = stats


def set_active_fleet(summary_fn) -> None:
    """Register (or clear, with None) the process's fleet live feed: a
    zero-arg callable returning the pool-aggregated live summary. A fleet
    wins over a single active driver in :func:`live_summary`: with a pool
    running, per-replica stats are panel rows, not the headline."""
    global _ACTIVE_FLEET
    with _ACTIVE_LOCK:
        _ACTIVE_FLEET = summary_fn


def active_stats() -> Optional[ServingStats]:
    return _ACTIVE


def live_summary() -> Optional[Dict[str, Any]]:
    """Compact serving counters of the active driver (None = no driver
    running): queue depth, rolling p99, breaker state, and the degraded,
    quarantined and rejected tallies. With a fleet registered, the pool's
    aggregated summary (and its per-replica ``fleet`` panel) is the tick."""
    fleet = _ACTIVE_FLEET
    if fleet is not None:
        try:
            return fleet()
        except Exception:
            return None
    st = _ACTIVE
    if st is None:
        return None
    lat = st.latency_ms()
    with st._lock:
        out: Dict[str, Any] = {
            "queue_depth": st.queue_depth,
            "queue_cap": st.queue_capacity,
            "breaker": st.breaker_state,
            "ok": st.counts["ok"],
        }
        for key in ("degraded", "quarantined", "deadline_exceeded",
                    "failed"):
            if st.counts[key]:
                out[key] = st.counts[key]
        rejected = (st.counts["rejected_queue"]
                    + st.counts["rejected_invalid"]
                    + st.counts["rejected_closed"])
        if rejected:
            out["rejected"] = rejected
        if st.breaker_trips:
            out["breaker_trips"] = st.breaker_trips
        # per-outcome histogram counts, the live SLO (availability and
        # burn per window) and the recent-trace ring
        av = serve_slo.classify_counts(st.counts)
        deltas = st.slo_track.window_deltas(av["bad"], av["total"])
        hist = {o: {"n": h.n, "buckets": list(h.counts)}
                for o, h in st.lat_hist.items() if h.n}
        recent = list(st.recent)
    out["slo"] = slo_summary(av, deltas)
    if hist:
        out["lat_hist"] = hist
    if recent:
        out["recent"] = recent
    if lat.get("p99") is not None:
        out["p99_ms"] = lat["p99"]
    return out


def slo_summary(avail: Dict[str, int],
                window_deltas: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Compact live SLO: availability ratio and burn per window (one
    formula with build_slo_section, shared via classify_counts and
    window_deltas)."""
    budget = max(1.0 - float(env_or_default_avail()), 1e-9)
    ratio = ((avail["good"] / avail["total"]) if avail["total"] else 1.0)
    burns = {}
    for wd in window_deltas:
        err = (wd["bad"] / wd["total"]) if wd["total"] else 0.0
        # %g keying: int() would collide the sub-second test-scale
        # windows ("0.1" and "0.5" both -> "0")
        burns[f"{float(wd['window_s']):g}"] = round(err / budget, 3)
    return {"availability": round(ratio, 6), "burn": burns}


def env_or_default_avail() -> float:
    from scconsensus_tpu_torch.config import env_flag

    return float(env_flag("SCC_SLO_AVAIL_TARGET"))


# -- schema validation ------------------------------------------------------

def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"serving section: {msg}")


def validate_serving(sv: Dict[str, Any]) -> None:
    """Structural validation of a record's ``serving`` section
    (``export.validate_run_record`` dispatches here). Load-bearing rules:

    * accounting — ``requests.submitted == sum(outcome counters)``; a
      record that lost a request is rejected;
    * latency sanity — ``0 <= p50 <= p99 <= max`` whenever latencies
      were measured;
    * evidence coupling — degraded responses require a tripped breaker,
      quarantined responses require drift-flagged batches, queue
      rejections require a bounded queue (capacity > 0);
    * wire accounting (fleet round, when a ``wire`` subsection is
      present) — the SAME rule one layer up: every wire request must
      end as exactly one typed outcome, and every outcome must have
      produced exactly one status code;
    * fleet coherence (when a ``fleet`` subsection is present) —
      replicas >= 1, an active fingerprint, and the submitted-by-owner
      split (live replicas + retired replicas + pool boundary) must sum
      to ``requests.submitted``: a request the fleet cannot attribute to
      an owner is a lost request wearing a disguise.
    """
    _require(isinstance(sv, dict), "must be an object")
    req = sv.get("requests")
    _require(isinstance(req, dict), "requests must be an object")
    sub = req.get("submitted")
    _require(isinstance(sub, int) and sub >= 0,
             "requests.submitted must be an int >= 0")
    total = 0
    for o in OUTCOMES:
        v = req.get(o, 0)
        _require(isinstance(v, int) and v >= 0,
                 f"requests.{o} must be an int >= 0")
        total += v
    _require(
        total == sub,
        f"request accounting broken: submitted={sub} but outcomes sum to "
        f"{total} — every request must end as exactly one of {OUTCOMES}",
    )
    lat = sv.get("latency_ms")
    _require(isinstance(lat, dict), "latency_ms must be an object")
    n = lat.get("n", 0)
    _require(isinstance(n, int) and n >= 0,
             "latency_ms.n must be an int >= 0")
    if n > 0:
        p50, p99, mx = lat.get("p50"), lat.get("p99"), lat.get("max")
        for name, v in (("p50", p50), ("p99", p99), ("max", mx)):
            _require(isinstance(v, (int, float)) and v >= 0,
                     f"latency_ms.{name} must be a number >= 0")
        _require(p50 <= p99 <= mx,
                 f"latency ordering broken: p50={p50} p99={p99} max={mx}")
    br = sv.get("breaker")
    _require(isinstance(br, dict), "breaker must be an object")
    _require(br.get("state") in BREAKER_STATES,
             f"breaker.state must be one of {BREAKER_STATES}, "
             f"got {br.get('state')!r}")
    trips = br.get("trips", 0)
    _require(isinstance(trips, int) and trips >= 0,
             "breaker.trips must be an int >= 0")
    if req.get("degraded", 0) > 0:
        _require(
            trips >= 1,
            "degraded responses claimed with breaker.trips == 0 — the "
            "host fallback only serves behind a tripped breaker",
        )
    drift = sv.get("drift") or {}
    _require(isinstance(drift, dict), "drift must be an object")
    if req.get("quarantined", 0) > 0:
        _require(
            int(drift.get("batches_flagged", 0)) >= 1
            and int(drift.get("quarantine_entries", 0)) >= 1,
            "quarantined responses claimed without drift evidence "
            "(drift.batches_flagged / quarantine_entries)",
        )
    q = sv.get("queue") or {}
    if req.get("rejected_queue", 0) > 0:
        _require(
            int(q.get("capacity", 0)) > 0,
            "queue rejections claimed with no bounded queue "
            "(queue.capacity must be > 0)",
        )
    tp = sv.get("throughput_rps")
    if tp is not None:
        _require(isinstance(tp, (int, float)) and tp >= 0,
                 "throughput_rps must be a number >= 0")
    wire = sv.get("wire")
    if wire is not None:
        _require(isinstance(wire, dict), "wire must be an object")
        wreq = wire.get("requests") or {}
        wsub = wreq.get("submitted")
        _require(isinstance(wsub, int) and wsub >= 0,
                 "wire.requests.submitted must be an int >= 0")
        wtotal = 0
        for o in OUTCOMES:
            v = wreq.get(o, 0)
            _require(isinstance(v, int) and v >= 0,
                     f"wire.requests.{o} must be an int >= 0")
            wtotal += v
        _require(
            wtotal == wsub,
            f"wire accounting broken: submitted={wsub} but outcomes sum "
            f"to {wtotal} — every wire request must end as exactly one "
            f"typed outcome",
        )
        codes = wire.get("status_codes") or {}
        _require(isinstance(codes, dict),
                 "wire.status_codes must be an object")
        ctotal = sum(int(v) for v in codes.values())
        _require(
            ctotal == wsub,
            f"wire status-code accounting broken: submitted={wsub} but "
            f"status codes sum to {ctotal} — every typed outcome maps to "
            f"exactly one status code",
        )
        # NOTE: wire submitted may legitimately EXCEED serving
        # submitted — a malformed body (422) is refused before it can
        # reach admission accounting; both layers stay internally
        # consistent, which is the rule that matters.
    fleet = sv.get("fleet")
    if fleet is not None:
        _require(isinstance(fleet, dict), "fleet must be an object")
        nrep = fleet.get("replicas")
        _require(isinstance(nrep, int) and nrep >= 1,
                 "fleet.replicas (configured width) must be an "
                 "int >= 1")
        _require(isinstance(fleet.get("active_fp"), str)
                 and fleet["active_fp"],
                 "fleet.active_fp must be a non-empty string")
        live = fleet.get("live_replicas")
        _require(isinstance(live, int) and live >= 0,
                 "fleet.live_replicas must be an int >= 0")
        per = fleet.get("per_replica")
        _require(isinstance(per, list) and len(per) == live,
                 "fleet.per_replica must list exactly "
                 "fleet.live_replicas entries")
        owners = fleet.get("submitted_by_owner")
        _require(isinstance(owners, dict),
                 "fleet.submitted_by_owner must be an object")
        osum = 0
        for part in ("replicas", "retired", "pool"):
            v = owners.get(part, 0)
            _require(isinstance(v, int) and v >= 0,
                     f"fleet.submitted_by_owner.{part} must be an "
                     f"int >= 0")
            osum += v
        _require(
            osum == sub,
            f"fleet ownership accounting broken: submitted={sub} but "
            f"owners (replicas+retired+pool) sum to {osum} — every "
            f"request must be attributable to exactly one owner",
        )
        swaps = fleet.get("swaps", [])
        _require(isinstance(swaps, list), "fleet.swaps must be a list")
        for i, sw in enumerate(swaps):
            _require(isinstance(sw, dict) and sw.get("from_fp")
                     and sw.get("to_fp"),
                     f"fleet.swaps[{i}] must carry from_fp and to_fp")
            _require(sw.get("from_fp") != sw.get("to_fp"),
                     f"fleet.swaps[{i}]: a swap onto the SAME "
                     f"fingerprint is not a swap")
        scales = fleet.get("scales", [])
        _require(isinstance(scales, list),
                 "fleet.scales must be a list")
        for i, sc in enumerate(scales):
            _require(isinstance(sc, dict),
                     f"fleet.scales[{i}] must be an object")
            frm, to = sc.get("from"), sc.get("to")
            _require(isinstance(frm, int) and frm >= 0
                     and isinstance(to, int) and to >= 1,
                     f"fleet.scales[{i}] must carry int from >= 0 "
                     f"and to >= 1")
            _require(frm != to,
                     f"fleet.scales[{i}]: a resize to the SAME width "
                     f"is not a scale action (no-ops are un-stamped)")
            _require(isinstance(sc.get("ts"), (int, float)),
                     f"fleet.scales[{i}].ts must be a number")
