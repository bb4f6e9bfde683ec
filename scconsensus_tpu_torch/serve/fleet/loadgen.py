"""Open-loop load generator: seeded traffic against the real wire front.

The port of ``scconsensus_tpu/serve/fleet/loadgen.py``. The soak
(``serve.fleet.soak``) is closed-loop: each pump waits for a response
before sending the next request, so offered load throttles itself to what
the fleet absorbs. This module is the open-loop twin: the arrival schedule
is computed up front (seeded Poisson thinning over a rate profile, or
bursty trains), every request fires at its scheduled offset whether or not
earlier ones have answered, and what the fleet cannot absorb shows up as
queue backpressure (typed 429s, client-class, so shed load never burns
the SLO budget), latency, or burn. That is what the burn-rate autoscaler
(:mod:`.autoscale`) is exercised against.

Everything is deterministic given the seed: the rate profile, the thinned
arrival offsets, the per-request scenario assignment (mixes are drawn over
the registered workload-zoo scenarios; a mix naming another is refused)
and the per-scenario query batches (``soak.make_query_batches``).

The run produces a wire-side run record (``extra.config =
"loadgen-<profile>"``) whose headline is sustained RPS at SLO: good
responses per second if the record's own slo section holds (worst burn
within its declared burn limit and p99 within its declared target), else
0.0. The validated ``loadgen`` section carries the schedule, the mix, the
accounting (offered, sent, completed, good; open-loop lateness) and every
autoscaler actuation.

The module imports neither torch nor the pool at module level (the
export validators import it); :func:`run_load` imports them when run.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from scconsensus_tpu_torch.config import env_flag
from scconsensus_tpu_torch.workloads import scenario_names

__all__ = [
    "PROFILES",
    "ARRIVALS",
    "DEFAULT_MIX",
    "rate_profile",
    "arrival_offsets",
    "resolve_mix",
    "assign_scenarios",
    "build_loadgen_section",
    "validate_loadgen",
    "slo_breaches",
    "run_load",
]

# rate profiles: base_rps modulated over the run's duration
#   steady   flat at base_rps
#   diurnal  one sinusoidal day compressed into the run (trough 0.6x,
#            crest 1.4x of base — peak_rps is ignored)
#   spike    base_rps with a flat peak_rps plateau in the middle third
#   ramp     linear base_rps -> peak_rps
PROFILES = ("steady", "diurnal", "spike", "ramp")

ARRIVALS = ("poisson", "burst")

# open-loop honesty gauge: a request fired later than this past its
# scheduled offset counts late (the generator, not the fleet, fell
# behind — late_fraction near 1 means the measurement is closed-loop
# in disguise and the record says so)
LATE_TOLERANCE_S = 0.050

# relative batch geometry per registered scenario: the mix models the
# zoo's request-size diversity (atlas_transfer is the bulk batch
# workload; cite_dual's per-request matrices are smaller than the
# RNA-only shapes). Scaled onto the run's --cells.
_SCENARIO_CELL_FACTOR = {
    "multi_sample": 1.0,
    "cite_dual": 0.5,
    "atlas_transfer": 2.0,
    "topo_inputs": 0.75,
}


# --------------------------------------------------------------------------
# the schedule (pure, seeded)
# --------------------------------------------------------------------------

def rate_profile(profile: str, t: float, duration_s: float,
                 base_rps: float, peak_rps: float) -> float:
    """Instantaneous arrival rate (req/s) at offset ``t``."""
    if profile not in PROFILES:
        raise ValueError(
            f"unknown profile {profile!r} (known: {PROFILES})"
        )
    if profile == "steady":
        return base_rps
    if profile == "diurnal":
        # one compressed day: trough at the endpoints, crest mid-run
        frac = (t / duration_s) if duration_s > 0 else 0.0
        return base_rps * (1.0 + 0.4 * math.sin(2.0 * math.pi * frac
                                                - math.pi / 2.0))
    if profile == "spike":
        third = duration_s / 3.0
        return peak_rps if third <= t < 2.0 * third else base_rps
    # ramp
    frac = (t / duration_s) if duration_s > 0 else 0.0
    return base_rps + (peak_rps - base_rps) * frac


def arrival_offsets(profile: str, base_rps: float, peak_rps: float,
                    duration_s: float, seed: int,
                    arrival: str = "poisson",
                    burst_size: int = 4) -> List[float]:
    """The full arrival schedule as sorted offsets from t0, seeded and
    deterministic.

    ``poisson`` draws an inhomogeneous Poisson process by Lewis
    thinning: homogeneous exponential gaps at the profile's max rate,
    each candidate kept with probability rate(t)/max_rate. ``burst``
    keeps every thinned arrival but replaces it with a back-to-back
    train of ``burst_size`` requests (the base rate is divided by the
    burst size so the OFFERED volume matches poisson in expectation —
    same load, burstier arrivals)."""
    if arrival not in ARRIVALS:
        raise ValueError(
            f"unknown arrival {arrival!r} (known: {ARRIVALS})"
        )
    if duration_s <= 0 or base_rps <= 0:
        raise ValueError("duration_s and base_rps must be > 0")
    peak_rps = max(float(peak_rps), float(base_rps))
    train = max(int(burst_size), 1) if arrival == "burst" else 1
    rng = np.random.default_rng(int(seed))
    max_rate = max(
        rate_profile(profile, t, duration_s, base_rps, peak_rps)
        for t in np.linspace(0.0, duration_s, 257)
    ) / train
    out: List[float] = []
    t = 0.0
    while True:
        t += float(rng.exponential(1.0 / max_rate))
        if t >= duration_s:
            break
        rate = rate_profile(profile, t, duration_s, base_rps,
                            peak_rps) / train
        if float(rng.random()) <= rate / max_rate:
            for j in range(train):
                tj = t + j * 1e-3  # back-to-back, 1ms spaced
                if tj < duration_s:
                    out.append(round(tj, 6))
    return sorted(out)


def resolve_mix(mix: Optional[Dict[str, float]]
                ) -> Dict[str, float]:
    """Validate and normalize a traffic mix over REGISTERED scenarios.
    ``None`` means the default mix (every registered scenario, equal
    weight)."""
    if mix is None:
        names = scenario_names()
        return {n: round(1.0 / len(names), 6) for n in names}
    if not isinstance(mix, dict) or not mix:
        raise ValueError("mix must be a non-empty "
                         "{scenario_name: weight} object")
    known = set(scenario_names())
    total = 0.0
    for name, w in mix.items():
        if name not in known:
            raise ValueError(
                f"mix names unregistered scenario {name!r} "
                f"(registered: {sorted(known)})"
            )
        if not isinstance(w, (int, float)) or w <= 0:
            raise ValueError(f"mix[{name!r}] must be a number > 0")
        total += float(w)
    return {n: round(float(w) / total, 6) for n, w in mix.items()}


# canonical default for docs/CLI help
DEFAULT_MIX = "all registered scenarios, equal weight"


def assign_scenarios(n: int, mix: Dict[str, float],
                     seed: int) -> List[str]:
    """Seeded per-request scenario assignment drawn from the mix."""
    names = sorted(mix)
    probs = np.asarray([mix[k] for k in names], np.float64)
    probs = probs / probs.sum()
    rng = np.random.default_rng(int(seed) + 17)
    idx = rng.choice(len(names), size=max(int(n), 0), p=probs)
    return [names[int(i)] for i in idx]


# --------------------------------------------------------------------------
# the record section
# --------------------------------------------------------------------------

def build_loadgen_section(profile: str, arrival: str, base_rps: float,
                          peak_rps: float, duration_s: float, seed: int,
                          mix: Dict[str, float], offered: int,
                          sent: int, completed: int, good: int,
                          late_fraction: float, achieved_rps: float,
                          breaches: List[str],
                          autoscale: Optional[Dict[str, Any]] = None,
                          ) -> Dict[str, Any]:
    slo_held = not breaches
    sec: Dict[str, Any] = {
        "profile": profile,
        "arrival": arrival,
        "base_rps": round(float(base_rps), 4),
        "peak_rps": round(max(float(peak_rps), float(base_rps)), 4),
        "duration_s": round(float(duration_s), 4),
        "seed": int(seed),
        "mix": {k: round(float(v), 6) for k, v in mix.items()},
        "offered": int(offered),
        "sent": int(sent),
        "completed": int(completed),
        "good": int(good),
        "late_fraction": round(float(late_fraction), 6),
        "achieved_rps": round(float(achieved_rps), 4),
        "slo_held": slo_held,
        "breaches": list(breaches),
        "rps_at_slo": round(float(achieved_rps), 4) if slo_held else 0.0,
    }
    if autoscale is not None:
        sec["autoscale"] = autoscale
    return sec


def slo_breaches(slo: Dict[str, Any]) -> List[str]:
    """Judge a record's slo section against its OWN declared objectives
    (the SLOVerdict rule, history-free): a worst burn past the declared
    burn limit and a missed latency target are each one breach."""
    out: List[str] = []
    obj = slo.get("objectives") or {}
    worst = slo.get("worst_burn")
    limit = obj.get("burn_limit")
    if (isinstance(worst, (int, float)) and isinstance(limit, (int, float))
            and worst > limit):
        out.append(f"burn: worst_burn {worst} > limit {limit}")
    lat = slo.get("latency") or {}
    if lat.get("met") is False:
        out.append(f"latency: p99 {lat.get('p99_ms')}ms > target "
                   f"{lat.get('target_ms')}ms")
    return out


def _lg_require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"loadgen section: {msg}")


def validate_loadgen(lg: Dict[str, Any]) -> None:
    """Structural validation of a record's ``loadgen`` section
    (``obs.export.validate_run_record`` dispatches here). Load-bearing
    rules: the mix must name only registered scenarios with positive
    weights summing to 1, the open-loop accounting must hold (offered >=
    sent >= completed >= good), and the headline must be consistent with
    the record's own SLO verdict — ``rps_at_slo`` is ``achieved_rps``
    when the SLO held and exactly 0.0 when it did not (a breached run
    sustains nothing)."""
    _lg_require(isinstance(lg, dict), "must be an object")
    _lg_require(lg.get("profile") in PROFILES,
                f"profile must be one of {PROFILES}, "
                f"got {lg.get('profile')!r}")
    _lg_require(lg.get("arrival") in ARRIVALS,
                f"arrival must be one of {ARRIVALS}, "
                f"got {lg.get('arrival')!r}")
    for k in ("base_rps", "peak_rps", "duration_s"):
        v = lg.get(k)
        _lg_require(isinstance(v, (int, float)) and v > 0,
                    f"{k} must be a number > 0")
    _lg_require(lg["peak_rps"] >= lg["base_rps"],
                "peak_rps must be >= base_rps")
    _lg_require(isinstance(lg.get("seed"), int), "seed must be an int")
    mix = lg.get("mix")
    _lg_require(isinstance(mix, dict) and mix,
                "mix must be a non-empty object")
    known = set(scenario_names())
    for name, w in mix.items():
        _lg_require(name in known,
                    f"mix names unregistered scenario {name!r}")
        _lg_require(isinstance(w, (int, float)) and w > 0,
                    f"mix[{name!r}] must be a number > 0")
    _lg_require(abs(sum(float(w) for w in mix.values()) - 1.0) < 1e-3,
                "mix weights must sum to 1")
    counts = [lg.get(k) for k in ("offered", "sent", "completed", "good")]
    _lg_require(all(isinstance(c, int) and c >= 0 for c in counts),
                "offered/sent/completed/good must be ints >= 0")
    _lg_require(counts[0] >= counts[1] >= counts[2] >= counts[3],
                f"open-loop accounting must hold: offered >= sent >= "
                f"completed >= good, got {counts}")
    lf = lg.get("late_fraction")
    _lg_require(isinstance(lf, (int, float)) and 0.0 <= lf <= 1.0,
                "late_fraction must be in [0, 1]")
    ar = lg.get("achieved_rps")
    _lg_require(isinstance(ar, (int, float)) and ar >= 0,
                "achieved_rps must be a number >= 0")
    breaches = lg.get("breaches")
    _lg_require(isinstance(breaches, list)
                and all(isinstance(b, str) for b in breaches),
                "breaches must be a list of strings")
    _lg_require(lg.get("slo_held") == (len(breaches) == 0),
                "slo_held must equal breaches == []")
    rps = lg.get("rps_at_slo")
    _lg_require(isinstance(rps, (int, float)), "rps_at_slo must be a "
                "number")
    if lg["slo_held"]:
        _lg_require(abs(float(rps) - float(ar)) <= 0.01 + 1e-6,
                    f"rps_at_slo ({rps}) must equal achieved_rps "
                    f"({ar}) when the SLO held")
    else:
        _lg_require(float(rps) == 0.0,
                    "rps_at_slo must be 0.0 when the SLO was breached")
    auto = lg.get("autoscale")
    if auto is not None:
        from scconsensus_tpu_torch.serve.fleet.autoscale import (
            validate_actuation,
        )

        _lg_require(isinstance(auto, dict), "autoscale must be an object")
        acts = auto.get("actuations")
        _lg_require(isinstance(acts, list),
                    "autoscale.actuations must be a list")
        for a in acts:
            validate_actuation(a)
        for k in ("ticks", "final_target"):
            _lg_require(isinstance(auto.get(k), int) and auto[k] >= 0,
                        f"autoscale.{k} must be an int >= 0")


# --------------------------------------------------------------------------
# the run
# --------------------------------------------------------------------------

def _build_request_bodies(offsets: List[float], mix: Dict[str, float],
                          cells_per: int, n_genes: int, n_clusters: int,
                          seed: int) -> Tuple[List[bytes], List[str]]:
    """Per-arrival request bodies: seeded scenario assignment over the
    mix, per-scenario batch geometry, batches from the same replayable
    generator the atlas bench drives."""
    from scconsensus_tpu_torch.serve.fleet.soak import make_query_batches

    scen = assign_scenarios(len(offsets), mix, seed)
    by_scen: Dict[str, List[int]] = {}
    for i, name in enumerate(scen):
        by_scen.setdefault(name, []).append(i)
    bodies: List[bytes] = [b""] * len(offsets)
    for name, idxs in sorted(by_scen.items()):
        cells = max(int(round(cells_per
                              * _SCENARIO_CELL_FACTOR.get(name, 1.0))), 1)
        # the generator's seed ALSO seeds the atlas centers the cells
        # are drawn around — it must match the model build seed or every
        # request reads as drift and the fleet (correctly) quarantines
        # the whole run; scenarios still differ by batch geometry
        batches = make_query_batches(len(idxs), cells, seed,
                                     n_genes=n_genes,
                                     n_clusters=n_clusters)
        for i, batch in zip(idxs, batches):
            bodies[i] = json.dumps(
                {"cells": batch.tolist()}).encode()
    return bodies, scen


def run_load(workdir: str, profile: Optional[str] = None,
             base_rps: Optional[float] = None,
             peak_rps: Optional[float] = None,
             duration_s: Optional[float] = None,
             seed: Optional[int] = None,
             mix: Optional[Dict[str, float]] = None,
             arrival: str = "poisson",
             replicas: Optional[int] = None,
             cells_per: int = 8, n_genes: int = 120,
             n_clusters: int = 4, n_train: int = 360,
             queue_capacity: Optional[int] = None,
             deadline_s: Optional[float] = None,
             autoscale: bool = True,
             policy: Optional[Any] = None,
             pumps: int = 8,
             heartbeat_s: Optional[float] = None,
             fresh: bool = False,
             device=None) -> Dict[str, Any]:
    """One open-loop load run against a real fleet behind the real wire
    front; returns the summary dict with the validated run record.

    ``replicas`` is the pool's configured width — the autoscale FLOOR
    and the replica-keyed baseline key. With ``autoscale`` the
    burn-rate controller runs over the pool for the run's duration and
    its every actuation lands in the record and the actuation ledger
    (``ACTUATION_LEDGER.jsonl`` under ``workdir/ledger`` — the
    postmortem bundle auto-collects it). The replicas serve on
    ``device``, where the model is built too."""
    import http.client

    from scconsensus_tpu_torch.device import resolve_device

    from scconsensus_tpu_torch.obs import trace as obs_trace
    from scconsensus_tpu_torch.obs.export import (
        build_run_record,
        validate_run_record,
    )
    from scconsensus_tpu_torch.obs.live import LiveRecorder
    from scconsensus_tpu_torch.serve.driver import ServeConfig
    from scconsensus_tpu_torch.serve.fleet.autoscale import Autoscaler
    from scconsensus_tpu_torch.serve.fleet.pool import ReplicaPool
    from scconsensus_tpu_torch.serve.fleet.soak import build_atlas_model
    from scconsensus_tpu_torch.serve.fleet.wire import WireFront
    from scconsensus_tpu_torch.serve.model import MODEL_STAGE
    from scconsensus_tpu_torch.utils.artifacts import ArtifactStore

    dev = resolve_device(device)
    profile = profile or str(env_flag("SCC_LOADGEN_PROFILE"))
    base_rps = float(base_rps if base_rps is not None
                     else env_flag("SCC_LOADGEN_RPS"))
    peak_rps = float(peak_rps if peak_rps is not None
                     else 4.0 * base_rps)
    duration_s = float(duration_s if duration_s is not None
                       else env_flag("SCC_LOADGEN_DURATION_S"))
    seed = int(seed if seed is not None
               else env_flag("SCC_LOADGEN_SEED"))
    norm_mix = resolve_mix(mix)

    model_dir = os.path.join(workdir, "model_v1")
    if fresh or not ArtifactStore(model_dir).has(MODEL_STAGE):
        build_atlas_model(model_dir, n_genes=n_genes,
                          n_clusters=n_clusters, n_train=n_train,
                          seed=seed, device=dev)

    offsets = arrival_offsets(profile, base_rps, peak_rps, duration_s,
                              seed, arrival=arrival)
    bodies, scen = _build_request_bodies(offsets, norm_mix, cells_per,
                                         n_genes, n_clusters, seed)

    ledger_dir = os.path.join(workdir, "ledger")
    cfg = ServeConfig(batch_window_s=0.001,
                      default_deadline_s=deadline_s,
                      ledger_dir=ledger_dir,
                      queue_capacity=(int(queue_capacity)
                                      if queue_capacity is not None
                                      else None))

    tracer = obs_trace.Tracer(sync="off")
    recorder = LiveRecorder(
        os.path.join(workdir, "LOAD_RUN"),
        metric="open-loop load run flight record",
        extra={"config": f"loadgen-{profile}", "platform": dev.type},
        heartbeat_s=heartbeat_s,
    )
    recorder.start(install_signals=False)

    pool = ReplicaPool(model_dir, n_replicas=replicas, config=cfg,
                       device=dev)
    front = WireFront(pool)
    scaler: Optional[Autoscaler] = None
    results: List[Optional[Dict[str, Any]]] = [None] * len(offsets)
    next_i = [0]
    lock = threading.Lock()
    try:
      with pool, front:
        port = front.port
        if autoscale:
            scaler = Autoscaler(pool, policy=policy,
                                ledger_dir=ledger_dir).start()

        t0 = time.monotonic()

        def _pump():
            conn = http.client.HTTPConnection("127.0.0.1", port,
                                              timeout=60)
            while True:
                with lock:
                    if next_i[0] >= len(offsets):
                        conn.close()
                        return
                    i = next_i[0]
                    next_i[0] += 1
                # open loop: fire at the SCHEDULED offset, never gated
                # on earlier responses
                delay = (t0 + offsets[i]) - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                fired = time.monotonic() - t0
                try:
                    conn.request(
                        "POST", "/classify", body=bodies[i],
                        headers={"Content-Type": "application/json"})
                    r = conn.getresponse()
                    outcome = json.loads(r.read()).get("outcome")
                    out = {"i": i, "status": r.status,
                           "outcome": outcome,
                           "scenario": scen[i],
                           "late_s": round(max(fired - offsets[i],
                                               0.0), 6),
                           "latency_s": round(
                               time.monotonic() - t0 - fired, 6)}
                except (OSError, http.client.HTTPException,
                        ValueError) as e:
                    out = {"i": i, "status": None,
                           "outcome": "wire-error",
                           "scenario": scen[i],
                           "late_s": round(max(fired - offsets[i],
                                               0.0), 6),
                           "error": str(e)[:200]}
                    conn.close()
                    conn = http.client.HTTPConnection(
                        "127.0.0.1", port, timeout=60)
                results[i] = out

        threads = [threading.Thread(target=_pump, daemon=True)
                   for _ in range(max(1, int(pumps)))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=duration_s + 120.0)
        elapsed = max(time.monotonic() - t0, duration_s)
        if scaler is not None:
            scaler.stop()
        section = front.serving_section()
        slo_section = front.slo_section()
    except BaseException:
        recorder.stop("crash")
        raise
    else:
        recorder.stop("clean")

    done = [r for r in results if r is not None]
    good = sum(1 for r in done if r["status"] == 200)
    completed = sum(1 for r in done if r["status"] is not None)
    late = sum(1 for r in done if r["late_s"] > LATE_TOLERANCE_S)
    breaches = slo_breaches(slo_section)
    achieved = good / elapsed if elapsed > 0 else 0.0
    lg = build_loadgen_section(
        profile, arrival, base_rps, peak_rps, duration_s, seed,
        norm_mix, offered=len(offsets), sent=len(done),
        completed=completed, good=good,
        late_fraction=(late / len(done)) if done else 0.0,
        achieved_rps=achieved, breaches=breaches,
        autoscale=scaler.section() if scaler is not None else None,
    )
    rec = build_run_record(
        metric="sustained RPS at SLO",
        value=lg["rps_at_slo"],
        unit="rps",
        extra={"config": f"loadgen-{profile}", "platform": dev.type},
        spans=tracer.live_span_records(),
        serving=section,
        slo=slo_section,
        loadgen=lg,
    )
    accounting_ok = True
    try:
        validate_run_record(rec)
    except ValueError as e:
        accounting_ok = False
        rec = {"invalid": str(e)}

    counts: Dict[str, int] = {}
    for r in done:
        counts[str(r["outcome"])] = counts.get(str(r["outcome"]), 0) + 1
    by_scenario: Dict[str, int] = {}
    for name in scen:
        by_scenario[name] = by_scenario.get(name, 0) + 1
    ok = (len(done) == len(offsets)
          and accounting_ok
          and not any(r["outcome"] == "wire-error" for r in done))
    summary: Dict[str, Any] = {
        "ok": ok,
        "profile": profile,
        "arrival": arrival,
        "offered": len(offsets),
        "sent": len(done),
        "completed": completed,
        "good": good,
        "achieved_rps": round(achieved, 4),
        "rps_at_slo": lg["rps_at_slo"],
        "slo_held": lg["slo_held"],
        "breaches": breaches,
        "late_fraction": lg["late_fraction"],
        "outcome_counts": counts,
        "mix_counts": by_scenario,
        "replicas_floor": pool.n_default,
        "accounting_ok": accounting_ok,
        "actuations": (list(scaler.actuations)
                       if scaler is not None else []),
        "scales": [dict(s) for s in pool.telemetry_snapshot()["scales"]],
        "record": rec,
    }
    if recorder.enabled:
        summary["heartbeat_stream"] = os.path.basename(recorder.hb_path)
        summary["partial_record"] = os.path.basename(
            recorder.partial_path)
    return summary
