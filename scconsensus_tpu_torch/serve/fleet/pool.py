"""Replica fleet: N guarded servers behind one admission layer.

The port of ``scconsensus_tpu/serve/fleet/pool.py``. :class:`ReplicaPool`
owns a set of :class:`ConsensusServer` replicas, all on the pool's one
device (``cuda`` unless ``device="cpu"``), grouped by model fingerprint.
The invariants, in the order they matter:

* **One owner per request.** Admission routes each request to exactly
  one replica (least queue depth among the target model's replicas,
  preferring closed breakers); from there the driver's accounting covers
  it. Requests the pool itself refuses (unknown model, closed fleet) ride
  the pool's own boundary stats, so the merged section's
  ``submitted_by_owner`` split always sums (``serve.metrics.
  validate_serving`` rejects one that does not).
* **Hot-swap by fingerprint, never a half-loaded model.** ``hot_swap``
  loads v2 through the readonly sha256 path, builds and starts v2's
  replicas first, performs the cutover under the routing lock, then
  drains v1's in-flight batches (bounded by ``SCC_FLEET_SWAP_DRAIN_S``).
  Admission holds the same lock as the cutover, so every request either
  enqueued on v1 before the flip (and drains there) or routes to v2
  after it. Retired replicas' stats are banked into the pool's lifetime
  accounting: a swap loses no request and no evidence.
* **Multi-model routing.** ``add_model`` registers more frozen models,
  addressable per request by fingerprint; the active fingerprint serves
  unaddressed requests.

Replicas share the device and its default stream: N replicas do not
multiply the device's throughput, they overlap one replica's host work
(admission, batching, the drift gate) with another's device call.

Fault sites (``robust.faults``): ``fleet_route`` fires at admission,
``fleet_swap`` at the start of a hot-swap.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Union

import numpy as np

from scconsensus_tpu_torch.config import env_flag
from scconsensus_tpu_torch.device import resolve_device
from scconsensus_tpu_torch.robust import faults
from scconsensus_tpu_torch.serve import metrics as serve_metrics
from scconsensus_tpu_torch.serve import slo as serve_slo
from scconsensus_tpu_torch.serve.driver import (
    ConsensusServer,
    RequestHandle,
    ServeConfig,
    ServeResponse,
)
from scconsensus_tpu_torch.serve.errors import RequestInvalid, ServerClosed
from scconsensus_tpu_torch.serve.model import ConsensusModel, load_consensus_model

__all__ = ["Replica", "ReplicaPool"]

_BREAKER_RANK = serve_metrics.BREAKER_SEVERITY


@dataclasses.dataclass
class Replica:
    index: int
    model_fp: str
    server: ConsensusServer


class ReplicaPool:
    """N ``ConsensusServer`` replicas behind one shared admission layer.
    Use as a context manager or call :meth:`start`/:meth:`stop`."""

    def __init__(self, model: Union[ConsensusModel, str],
                 n_replicas: Optional[int] = None,
                 config: Optional[ServeConfig] = None,
                 readonly: bool = False,
                 register_live: bool = True,
                 device=None):
        self.device = resolve_device(device)
        self.config = (config or ServeConfig()).resolved()
        self.n_default = int(n_replicas if n_replicas is not None
                             else env_flag("SCC_FLEET_REPLICAS"))
        if self.n_default < 1:
            raise ValueError("a fleet needs at least one replica")
        self._register_live = bool(register_live)
        self._lock = threading.Lock()
        self._closed = True
        self._rep_seq = 0
        # pool-boundary accounting: refusals that never reach a replica
        self._pool_stats = serve_metrics.ServingStats(queue_capacity=0)
        self._retired_sections: List[Dict[str, Any]] = []
        self._retired_samples: List[List[float]] = []
        self._retired_expo: List[Dict[str, Any]] = []
        # replicas removed from routing but not yet banked (stop() can
        # take seconds): the telemetry snapshot still counts them, so
        # fleet-aggregate counters never dip and rebound mid-retire —
        # a scraper would read the dip as a counter reset
        self._dying: List[Replica] = []
        self._swaps: List[Dict[str, Any]] = []
        self._kills: List[Dict[str, Any]] = []
        self._scales: List[Dict[str, Any]] = []
        self._started_unix = time.time()
        first = self._load(model, readonly)
        self._models: Dict[str, ConsensusModel] = {
            first.fingerprint(): first
        }
        self._active_fp = first.fingerprint()
        self._groups: Dict[str, List[Replica]] = {
            first.fingerprint(): self._build_group(first, self.n_default)
        }

    # -- construction ------------------------------------------------------
    def _load(self, model: Union[ConsensusModel, str],
              readonly: bool) -> ConsensusModel:
        if isinstance(model, str):
            # the readonly sha256 path: every model entering the fleet is
            # verified intact, and a frozen mount is never written
            return load_consensus_model(model, readonly=readonly,
                                        device=self.device)
        return model.to(self.device)

    def _build_group(self, model: ConsensusModel,
                     n: int) -> List[Replica]:
        group = []
        for _ in range(max(int(n), 1)):
            srv = ConsensusServer(model, self.config, register_live=False,
                                  device=self.device)
            group.append(Replica(index=self._rep_seq,
                                 model_fp=model.fingerprint(),
                                 server=srv))
            self._rep_seq += 1
        return group

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ReplicaPool":
        with self._lock:
            if not self._closed:
                return self
            self._closed = False
            self._started_unix = time.time()
            reps = [r for g in self._groups.values() for r in g]
        for rep in reps:
            rep.server.start()
        if self._register_live:
            serve_metrics.set_active_fleet(self._live_summary)
        return self

    def stop(self, drain: bool = True) -> None:
        with self._lock:
            if self._closed and not any(self._groups.values()):
                return
            self._closed = True
            groups = self._groups
            self._groups = {fp: [] for fp in groups}
            # dying registration happens under the SAME lock hold that
            # removes the replicas from routing (here and in every
            # retire caller): a telemetry snapshot can never catch a
            # replica in neither the live nor the retired bucket
            for g in groups.values():
                self._dying.extend(g)
        for group in groups.values():
            self._retire_group(group, drain=drain)
        if self._register_live:
            serve_metrics.set_active_fleet(None)

    def __enter__(self) -> "ReplicaPool":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def closed(self) -> bool:
        return self._closed

    # -- admission ---------------------------------------------------------
    def _pool_refuse(self, outcome: str) -> None:
        # keep the boundary stats internally consistent: one submit, one
        # outcome — the merged section's accounting rule depends on it
        self._pool_stats.note_submit(0)
        self._pool_stats.note_outcome(outcome)

    def submit(self, cells: np.ndarray,
               deadline_s: Optional[float] = None,
               model_fp: Optional[str] = None,
               trace_id: Optional[str] = None) -> RequestHandle:
        """Route one request to exactly one replica of the addressed
        model (default: the active fingerprint). Typed refusals:
        ServerClosed (fleet closed), RequestInvalid (unknown model),
        plus everything the replica's own admission can raise.
        ``trace_id`` (from the wire front) rides through routing to the
        owning replica's admission unchanged — admission must never
        re-mint an id the front already issued."""
        faults.fault_point("fleet_route")
        with self._lock:
            if self._closed:
                self._pool_refuse("rejected_closed")
                raise ServerClosed("fleet is not accepting requests")
            fp = model_fp or self._active_fp
            group = self._groups.get(fp)
            if not group:
                self._pool_refuse("rejected_invalid")
                raise RequestInvalid(
                    f"no model {fp!r} in the fleet "
                    f"(have {sorted(self._groups)})"
                )
            rep = self._least_depth(group)
            # enqueue UNDER the pool lock: hot_swap's cutover takes the
            # same lock, so a request either lands on v1 before the flip
            # (the drain serves it) or routes to v2 after — never to a
            # replica already marked for draining
            return rep.server.submit(cells, deadline_s=deadline_s,
                                     trace_id=trace_id)

    @staticmethod
    def _least_depth(group: List[Replica]) -> Replica:
        """Least-depth routing, preferring replicas whose breaker is
        closest to closed: a healthy shallow queue beats a degraded
        one — but a fully-open fleet still serves (degraded beats
        down)."""
        return min(
            group,
            key=lambda rep: (
                _BREAKER_RANK.get(rep.server.breaker.state, 0),
                len(rep.server._queue),
            ),
        )

    def classify(self, cells: np.ndarray,
                 deadline_s: Optional[float] = None,
                 model_fp: Optional[str] = None,
                 timeout: Optional[float] = None) -> ServeResponse:
        return self.submit(cells, deadline_s=deadline_s,
                           model_fp=model_fp).result(timeout=timeout)

    # -- hot-swap + multi-model routing ------------------------------------
    def hot_swap(self, model: Union[ConsensusModel, str],
                 readonly: bool = False,
                 n_replicas: Optional[int] = None,
                 drain_timeout_s: Optional[float] = None) -> str:
        """Atomic cutover of the ACTIVE model: load v2 (sha256-verified),
        start its replicas, flip the routing pointer under the admission
        lock, then drain v1. Returns the new active fingerprint.
        Swapping to the already-active fingerprint is a no-op (idempotent
        — a retried swap must not restart the fleet); swapping to a
        model already routed via ``add_model`` PROMOTES its running
        group rather than replacing it (its replicas and their
        accounting survive)."""
        faults.fault_point("fleet_swap")
        new_model = self._load(model, readonly)
        new_fp = new_model.fingerprint()
        with self._lock:
            if self._closed:
                raise ServerClosed("fleet is not accepting a swap")
            if new_fp == self._active_fp:
                return new_fp
            build = new_fp not in self._groups
        group: List[Replica] = []
        if build:
            # build AND start v2 before any routing change: no request
            # is ever admitted toward a half-loaded model
            group = self._build_group(new_model,
                                      n_replicas or self.n_default)
            for rep in group:
                rep.server.start()
        redundant: List[Replica] = []
        with self._lock:
            if self._closed:
                # a stop() raced the swap: the new group never routed
                for rep in group:
                    rep.server.stop(drain=False)
                raise ServerClosed("fleet stopped during hot-swap")
            # re-read EVERYTHING under the cutover lock: a concurrent
            # swap may have flipped the pointer (or installed this very
            # fingerprint) since the first check
            old_fp = self._active_fp
            if old_fp == new_fp:
                redundant, group = group, []  # lost a race to an
                old_group: List[Replica] = []  # identical swap — done
                swap = None
            else:
                if new_fp in self._groups:
                    # promote the already-routed group (add_model, or a
                    # racing swap's install): a freshly built twin group
                    # must not overwrite live replicas
                    redundant, group = group, []
                else:
                    self._groups[new_fp] = group
                    self._models[new_fp] = new_model
                old_group = self._groups.pop(old_fp, [])
                self._dying.extend(old_group)
                self._active_fp = new_fp
                swap = {"from_fp": old_fp, "to_fp": new_fp,
                        "ts": round(time.time(), 3)}
        if redundant:
            # never-routed servers: stop without banking (zero traffic)
            for rep in redundant:
                rep.server.stop(drain=False)
        if swap is None:
            return new_fp
        # v1 drains OUTSIDE the lock: in-flight batches finish on v1 (a
        # request is never split across models), new traffic is already
        # routing to v2
        drained = self._retire_group(old_group, drain=True,
                                     timeout_s=drain_timeout_s)
        swap["drained_requests"] = drained
        with self._lock:
            self._swaps.append(swap)
            self._models.pop(old_fp, None)
        return new_fp

    def add_model(self, model: Union[ConsensusModel, str],
                  n_replicas: int = 1,
                  readonly: bool = False) -> str:
        """Register an additional routed model (atlas-per-tissue):
        requests addressed to its fingerprint route to its replicas; the
        active model keeps serving unaddressed traffic."""
        m = self._load(model, readonly)
        fp = m.fingerprint()
        group = self._build_group(m, n_replicas)
        with self._lock:
            if self._closed:
                raise ServerClosed("fleet is not accepting models")
            if fp in self._groups:
                raise ValueError(f"model {fp!r} is already in the fleet")
            self._groups[fp] = group
            self._models[fp] = m
        for rep in group:
            rep.server.start()
        return fp

    def retire_model(self, fp: str,
                     drain_timeout_s: Optional[float] = None) -> None:
        """Drain and remove a routed model (refuses the active one —
        hot-swap first)."""
        with self._lock:
            if fp == self._active_fp:
                raise ValueError(
                    f"cannot retire the active model {fp!r}; hot_swap a "
                    "replacement first"
                )
            group = self._groups.pop(fp, None)
            self._models.pop(fp, None)
            if group:
                self._dying.extend(group)
        if group:
            self._retire_group(group, drain=True,
                               timeout_s=drain_timeout_s)

    def kill_replica(self, index: Optional[int] = None,
                     respawn: bool = True) -> Dict[str, Any]:
        """Hard-kill one live replica of the ACTIVE model (no drain —
        its queued requests resolve as typed ServerClosed, exactly what
        a process death looks like one layer up) and, by default,
        respawn a fresh replica of the same model so the fleet returns
        to width. The killed replica's stats are banked into the
        retired accounting — a kill loses zero requests AND zero
        evidence — and the kill is stamped into ``fleet.kills``.
        Returns the kill record. The soak's replica-kill plan drives
        this; a client that retries its refused request with the SAME
        trace id produces the two-attempts-one-trace story the
        postmortem bundle proves."""
        with self._lock:
            if self._closed:
                raise ServerClosed("fleet is not accepting a kill")
            group = self._groups.get(self._active_fp) or []
            if not group:
                raise ValueError("no live replica of the active model "
                                 "to kill")
            if index is None:
                # default to the DEEPEST queue: a kill exists to prove
                # queued requests refuse typed and retry clean, so aim
                # it where the requests are
                rep = max(group,
                          key=lambda r: r.server.stats.queue_depth)
            else:
                matches = [r for r in group if r.index == int(index)]
                if not matches:
                    raise ValueError(
                        f"no live replica {index!r} in the active group "
                        f"(have {[r.index for r in group]})"
                    )
                rep = matches[0]
            group.remove(rep)
            self._dying.append(rep)
            model = self._models[self._active_fp]
            fp = self._active_fp
        # stop OUTSIDE the lock, without drain: queued requests resolve
        # typed rejected_closed on the dead replica's own stats
        rep.server.stop(drain=False, timeout_s=5.0)
        sec = rep.server.stats.section()
        with self._lock:
            self._retired_sections.append(sec)
            self._retired_samples.append(
                rep.server.stats.latency_samples()
            )
            self._retired_expo.append(rep.server.stats.expo_snapshot())
            self._dying.remove(rep)
        kill: Dict[str, Any] = {
            "replica": rep.index,
            "model_fp": fp,
            "refused": int(sec["requests"]["rejected_closed"]),
            "ts": round(time.time(), 3),
        }
        if respawn:
            new_group = self._build_group(model, 1)
            for nr in new_group:
                nr.server.start()
            with self._lock:
                if self._closed or self._active_fp != fp:
                    # the fleet moved on mid-respawn: the fresh replica
                    # never routed, stop it without banking
                    for nr in new_group:
                        nr.server.stop(drain=False)
                else:
                    self._groups[fp].extend(new_group)
                    kill["respawned"] = new_group[0].index
        with self._lock:
            self._kills.append(kill)
        return kill

    def scale_to(self, n: int,
                 drain_timeout_s: Optional[float] = None,
                 reason: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, Any]:
        """Resize the ACTIVE model's replica group to ``n`` (the
        autoscaler's actuator). Scale-up mirrors the kill/respawn path:
        fresh replicas are built AND started outside the lock, then
        joined to routing only if the fleet has not moved on. Scale-down
        drains the removed replicas (shallowest queues first) and banks
        their stats — a scale action loses zero requests and zero
        evidence. The action is stamped into ``fleet.scales``; a no-op
        resize is returned un-stamped. Returns the scale record."""
        n = int(n)
        if n < 1:
            raise ValueError("a fleet needs at least one replica")
        with self._lock:
            if self._closed:
                raise ServerClosed("fleet is not accepting a resize")
            fp = self._active_fp
            model = self._models[fp]
            group = self._groups.get(fp) or []
            cur = len(group)
            victims: List[Replica] = []
            if n < cur:
                # shed the SHALLOWEST queues: a scale-down exists to
                # trim idle width, so aim it away from queued work
                by_depth = sorted(group,
                                  key=lambda r: r.server.stats.queue_depth)
                victims = by_depth[:cur - n]
                for rep in victims:
                    group.remove(rep)
                # dying registration under the SAME lock hold that
                # unroutes them (the stop()/kill discipline)
                self._dying.extend(victims)
        rec: Dict[str, Any] = {"from": cur, "to": n,
                               "ts": round(time.time(), 3)}
        if reason:
            rec["reason"] = dict(reason)
        if n == cur:
            rec["noop"] = True
            return rec
        if victims:
            drained = self._retire_group(victims, drain=True,
                                         timeout_s=drain_timeout_s)
            rec["drained_requests"] = drained
        elif n > cur:
            new_group = self._build_group(model, n - cur)
            for nr in new_group:
                nr.server.start()
            with self._lock:
                if self._closed or self._active_fp != fp:
                    # the fleet moved on mid-build: the fresh replicas
                    # never routed, stop them without banking
                    for nr in new_group:
                        nr.server.stop(drain=False)
                    rec["aborted"] = True
                    return rec
                self._groups[fp].extend(new_group)
                rec["added"] = [r.index for r in new_group]
        with self._lock:
            self._scales.append(rec)
        return rec

    def _retire_group(self, group: List[Replica], drain: bool,
                      timeout_s: Optional[float] = None) -> int:
        """Stop a group's servers and bank their stats into the pool's
        lifetime accounting (a swap loses zero evidence). Returns the
        group's total submitted count."""
        budget = float(timeout_s if timeout_s is not None
                       else env_flag("SCC_FLEET_SWAP_DRAIN_S"))
        deadline = time.monotonic() + max(budget, 0.1)
        total = 0
        for rep in group:
            left = max(deadline - time.monotonic(), 0.1)
            rep.server.stop(drain=drain, timeout_s=left)
            sec = rep.server.stats.section()
            samples = rep.server.stats.latency_samples()
            expo = rep.server.stats.expo_snapshot()
            total += int(sec["requests"]["submitted"])
            with self._lock:
                self._retired_sections.append(sec)
                self._retired_samples.append(samples)
                # histograms survive retirement too: the fleet-merged
                # exposition/slo series must not lose a killed or
                # swapped-out replica's observations
                self._retired_expo.append(expo)
                # the caller registered the group as dying under the
                # lock that unrouted it; banking supersedes that
                if rep in self._dying:
                    self._dying.remove(rep)
        return total

    # -- introspection -----------------------------------------------------
    def active_fingerprint(self) -> str:
        return self._active_fp

    def active_model(self) -> ConsensusModel:
        with self._lock:
            return self._models[self._active_fp]

    def fingerprints(self) -> List[str]:
        with self._lock:
            return sorted(self._groups)

    def replicas(self) -> List[Replica]:
        with self._lock:
            return [r for g in self._groups.values() for r in g]

    # -- the validated section + the heartbeat feed ------------------------
    def serving_section(self) -> Dict[str, Any]:
        """The pool-level ``serving`` run-record section: per-replica
        sections (live + retired + pool boundary) merged so the
        accounting rule holds fleet-wide, plus the ``fleet`` subsection
        (replica table, swap history, submitted-by-owner split). Like the
        driver's, read it quiescent: mid-flight requests are counted
        submitted but not yet resolved."""
        with self._lock:
            live = [r for g in self._groups.values() for r in g]
            retired_secs = list(self._retired_sections)
            retired_samps = list(self._retired_samples)
            swaps = [dict(s) for s in self._swaps]
            active = self._active_fp
            models = {fp: len(g) for fp, g in self._groups.items() if g}
        live_secs = [rep.server.stats.section() for rep in live]
        live_samps = [rep.server.stats.latency_samples() for rep in live]
        pool_sec = self._pool_stats.section()
        sec = serve_metrics.merge_serving_sections(
            live_secs + retired_secs + [pool_sec],
            live_samps + retired_samps
            + [self._pool_stats.latency_samples()],
            window_s=time.time() - self._started_unix,
        )
        with self._lock:
            kills = [dict(k) for k in self._kills]
            scales = [dict(s) for s in self._scales]
        sec["fleet"] = {
            # configured fleet width — the replica-keyed baseline key (a
            # workload property, stable across stop/drain)...
            "replicas": self.n_default,
            # ...vs the replicas alive RIGHT NOW (0 after stop; the
            # per_replica table below describes exactly these)
            "live_replicas": len(live),
            "active_fp": active,
            "models": models,
            "swaps": swaps,
            "kills": kills,
            "scales": scales,
            "submitted_by_owner": {
                "replicas": sum(s["requests"]["submitted"]
                                for s in live_secs),
                "retired": sum(s["requests"]["submitted"]
                               for s in retired_secs),
                "pool": pool_sec["requests"]["submitted"],
            },
            "per_replica": [
                {
                    "replica": rep.index,
                    "model_fp": rep.model_fp,
                    "submitted": s["requests"]["submitted"],
                    "ok": s["requests"]["ok"],
                    "breaker": s["breaker"]["state"],
                    "trips": s["breaker"]["trips"],
                    "queue_depth_peak": s["queue"]["depth_peak"],
                    "p99_ms": (s["latency_ms"] or {}).get("p99"),
                }
                for rep, s in zip(live, live_secs)
            ],
        }
        return sec

    # -- the shared telemetry snapshot --------------------------------------
    def telemetry_snapshot(self) -> Dict[str, Any]:
        """One internally consistent fleet telemetry snapshot, taken
        UNDER the admission/swap lock: the replica table and every
        per-replica stats snapshot are read while no hot-swap cutover
        (or kill/respawn) can flip the groups mid-read. Both consumers
        — the ``/metrics`` OpenMetrics exposition and the JSON
        ``live_summary`` panel — assemble from THIS one structure, so
        the two can never disagree on per-replica keys while a swap is
        in flight (reading the replica list under the lock and the stats
        after releasing it tears exactly when a scrape races a
        cutover)."""
        with self._lock:
            live = [r for g in self._groups.values() for r in g]
            reps = [{
                "replica": rep.index,
                "model_fp": rep.model_fp,
                "expo": rep.server.stats.expo_snapshot(),
                "lat": rep.server.stats.latency_ms(),
                "samples": rep.server.stats.latency_samples(),
            } for rep in live]
            # mid-retire replicas (removed from routing, stop() still
            # running) count as already-retired evidence: aggregate
            # counters stay monotonic through a kill or swap
            dying_expo = [r.server.stats.expo_snapshot()
                          for r in self._dying]
            dying_samples = [r.server.stats.latency_samples()
                             for r in self._dying]
            return {
                "active_fp": self._active_fp,
                "replicas": reps,
                "retired_expo": [dict(e) for e in self._retired_expo]
                + dying_expo,
                "retired_samples": [list(s)
                                    for s in self._retired_samples]
                + dying_samples,
                "pool_expo": self._pool_stats.expo_snapshot(),
                "kills": [dict(k) for k in self._kills],
                "scales": [dict(s) for s in self._scales],
            }

    def expo_scopes(self, snap: Optional[Dict[str, Any]] = None
                    ) -> List[Dict[str, Any]]:
        """Exposition scopes for ``serve.slo.render_openmetrics``: one
        per live replica plus the ``replica="fleet"`` aggregate whose
        counters are exact sums (live + retired + pool boundary) and
        whose histograms are per-bucket merges — mergeable by the frozen
        bucket grid."""
        snap = snap or self.telemetry_snapshot()
        scopes: List[Dict[str, Any]] = []
        for r in snap["replicas"]:
            e = r["expo"]
            scopes.append({
                "labels": {"replica": str(r["replica"]),
                           "model": r["model_fp"][:8]},
                "counts": e["counts"],
                "queue_depth": e["queue_depth"],
                "queue_cap": e["queue_cap"],
                "breaker": e["breaker"],
                "trips": e["trips"],
                "latency_hist": e["latency_hist"],
                "stage_hist": e["stage_hist"],
            })
        all_expo = ([r["expo"] for r in snap["replicas"]]
                    + snap["retired_expo"] + [snap["pool_expo"]])
        counts: Dict[str, int] = {o: 0 for o in serve_metrics.OUTCOMES}
        for e in all_expo:
            for o in serve_metrics.OUTCOMES:
                counts[o] += int((e.get("counts") or {}).get(o, 0))
        lat_hist = {
            o: serve_slo.merge_histogram_dicts([
                (e.get("latency_hist") or {}).get(o)
                or serve_slo.LatencyHistogram().to_dict()
                for e in all_expo
            ]) for o in serve_metrics.OUTCOMES
        }
        stage_hist = {
            s: serve_slo.merge_histogram_dicts([
                (e.get("stage_hist") or {}).get(s)
                or serve_slo.LatencyHistogram().to_dict()
                for e in all_expo
            ]) for s in serve_metrics.STAGE_HIST_STAGES
        }
        live_expo = [r["expo"] for r in snap["replicas"]]
        worst = "closed"
        for e in live_expo:
            if (_BREAKER_RANK.get(e["breaker"], 0)
                    > _BREAKER_RANK[worst]):
                worst = e["breaker"]
        scopes.append({
            "labels": {"replica": "fleet"},
            "counts": counts,
            "queue_depth": sum(e["queue_depth"] for e in live_expo),
            "queue_cap": sum(e["queue_cap"] for e in live_expo),
            "breaker": worst,
            "trips": sum(e["trips"] for e in all_expo),
            "latency_hist": lat_hist,
            "stage_hist": stage_hist,
        })
        return scopes

    def slo_section(self, snap: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, Any]:
        """The fleet-level validated ``slo`` run-record section:
        availability over the SAME cumulative counters the accounting
        rule validates (live + retired + pool boundary — a killed
        replica's refusals still burn the budget), p99 from the merged
        raw sample rings, burn windows from the live replicas' + pool
        boundary's summed window deltas."""
        snap = snap or self.telemetry_snapshot()
        scopes = self.expo_scopes(snap)
        fleet = scopes[-1]
        # retired/killed replicas' raw samples stay in the gated tail:
        # a kill must lose zero latency evidence, or the record's p99
        # understates exactly the incident it should report
        merged = [ms for r in snap["replicas"] for ms in r["samples"]]
        for samples in snap.get("retired_samples") or []:
            merged.extend(samples)
        p99 = serve_slo.p99_ms(merged)
        # live + RETIRED trackers both burn: a killed replica's typed
        # refusals must show in the burn windows, not just availability
        live_deltas = ([r["expo"]["window_deltas"]
                        for r in snap["replicas"]]
                       + [e.get("window_deltas") or []
                          for e in snap.get("retired_expo") or []]
                       + [snap["pool_expo"]["window_deltas"]])
        # window order follows the trackers' declared objectives order
        # (first-seen), NOT numeric sort: validate_slo pins burn_rates
        # positionally against objectives.windows_s
        order: List[float] = []
        windows: Dict[float, Dict[str, int]] = {}
        for deltas in live_deltas:
            for wd in deltas:
                w = float(wd["window_s"])
                agg = windows.get(w)
                if agg is None:
                    agg = windows[w] = {"bad": 0, "total": 0}
                    order.append(w)
                agg["bad"] += int(wd["bad"])
                agg["total"] += int(wd["total"])
        window_deltas = [
            {"window_s": w, **windows[w]} for w in order
        ]
        return serve_slo.build_slo_section(
            fleet["counts"], p99, window_deltas,
            latency_hist=fleet["latency_hist"],
            stage_hist=fleet["stage_hist"],
            obs_overhead=serve_slo.obs_overhead(),
        )

    def _live_summary(self) -> Dict[str, Any]:
        """One heartbeat tick (``serve.metrics.live_summary`` delegates
        here while the pool is registered): aggregated vitals plus the
        per-replica fleet panel tail_run renders — assembled from the
        same swap-lock snapshot the exposition reads."""
        snap = self.telemetry_snapshot()
        out: Dict[str, Any] = {"queue_depth": 0, "queue_cap": 0,
                               "breaker": "closed", "ok": 0}
        agg: Dict[str, int] = {}
        trips_total = 0
        merged: List[float] = []
        reps: List[Dict[str, Any]] = []
        recent: List[Dict[str, Any]] = []
        hist_src: Dict[str, List[Dict[str, Any]]] = {}
        counts_sum: Dict[str, int] = {o: 0
                                      for o in serve_metrics.OUTCOMES}
        window_order: List[float] = []
        window_sum: Dict[float, Dict[str, int]] = {}
        for r in snap["replicas"]:
            e = r["expo"]
            counts = e["counts"]
            out["queue_depth"] += e["queue_depth"]
            out["queue_cap"] += e["queue_cap"]
            out["ok"] += counts["ok"]
            if (_BREAKER_RANK.get(e["breaker"], 0)
                    > _BREAKER_RANK[out["breaker"]]):
                out["breaker"] = e["breaker"]
            trips_total += e["trips"]
            for key in ("degraded", "quarantined", "deadline_exceeded",
                        "failed"):
                agg[key] = agg.get(key, 0) + counts[key]
            agg["rejected"] = (agg.get("rejected", 0)
                               + counts["rejected_queue"]
                               + counts["rejected_invalid"]
                               + counts["rejected_closed"])
            merged.extend(r["samples"])
            recent.extend(e.get("recent") or [])
            for o in serve_metrics.OUTCOMES:
                counts_sum[o] += int(counts.get(o, 0))
                h = (e.get("latency_hist") or {}).get(o)
                if h and h.get("count"):
                    hist_src.setdefault(o, []).append(h)
            for wd in e.get("window_deltas") or []:
                w = float(wd["window_s"])
                a = window_sum.get(w)
                if a is None:
                    a = window_sum[w] = {"bad": 0, "total": 0}
                    window_order.append(w)
                a["bad"] += int(wd["bad"])
                a["total"] += int(wd["total"])
            entry: Dict[str, Any] = {
                "replica": r["replica"],
                "model_fp": r["model_fp"][:8],
                "queue_depth": e["queue_depth"],
                "breaker": e["breaker"],
            }
            if e["trips"]:
                entry["trips"] = e["trips"]
            if r["lat"].get("p99") is not None:
                entry["p99_ms"] = r["lat"]["p99"]
            reps.append(entry)
        for key, v in agg.items():
            if v:
                out[key] = v
        if trips_total:
            out["breaker_trips"] = trips_total
        p99 = serve_slo.p99_ms(merged)
        if p99 is not None:
            out["p99_ms"] = round(p99, 4)
        av = serve_slo.classify_counts(counts_sum)
        out["slo"] = serve_metrics.slo_summary(av, [
            {"window_s": w, **window_sum[w]} for w in window_order
        ])
        # panel histograms through the ONE merge implementation (the
        # exposition's), reshaped to the heartbeat's compact {n,
        # buckets} form
        hist = {
            o: {"n": m["count"], "buckets": list(m["buckets"])}
            for o, m in ((o, serve_slo.merge_histogram_dicts(hs))
                         for o, hs in hist_src.items())
        }
        if hist:
            out["lat_hist"] = hist
        if recent:
            recent.sort(key=lambda x: x.get("ts") or 0)
            out["recent"] = recent[-8:]
        out["fleet"] = {"active_fp": snap["active_fp"][:8],
                        "replicas": reps}
        if snap.get("scales"):
            # the heartbeat panel's autoscale tail: tail_run renders it
            out["fleet"]["scales"] = [dict(s)
                                      for s in snap["scales"][-3:]]
        return out
