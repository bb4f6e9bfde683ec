"""Burn-rate-driven fleet autoscaler: the loop that acts on telemetry.

The port of ``scconsensus_tpu/serve/fleet/autoscale.py``:

* :func:`decide` is the pure control policy, ``(state, observation,
  policy) -> (state', actions)`` with no clock, no threads and no pool,
  so every hysteresis rule (consecutive-tick streaks, post-actuation
  cooldown, the no-flap guarantee under an oscillating burn series) is
  table-testable without a fleet.
* :class:`Autoscaler` runs it on a cadence against a live
  :class:`~scconsensus_tpu_torch.serve.fleet.pool.ReplicaPool`: one
  telemetry snapshot per tick (the swap-lock snapshot the exposition
  reads), one decision, then actuation through the pool: replica width
  through ``pool.scale_to``, admission tightening by shrinking each live
  replica's queue capacity (429s are client-class: shed load never burns
  the SLO budget), and degraded-mode entry and exit by forcing the
  replicas' breakers open and closed.

Every action lands as a typed ``actuation`` record in the in-memory list
(the run record's ``loadgen.autoscale.actuations``), as one JSONL row in
``ACTUATION_LEDGER.jsonl``, and, through the pool, in
``serving.fleet.scales``. With ``SCC_OBS_TRACE`` on each record carries a
trace id of its own.

The module imports neither torch nor the pool (the export validators
import it)."""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from scconsensus_tpu_torch.config import env_flag
from scconsensus_tpu_torch.obs.trace import new_trace_id
from scconsensus_tpu_torch.serve import slo as serve_slo

__all__ = [
    "ACTUATION_LEDGER_NAME",
    "ACTUATION_KINDS",
    "AutoscalePolicy",
    "ControlState",
    "Observation",
    "decide",
    "validate_actuation",
    "Autoscaler",
]

ACTUATION_LEDGER_NAME = "ACTUATION_LEDGER.jsonl"

ACTUATION_KINDS = (
    "scale_up", "scale_down",
    "tighten_admission", "relax_admission",
    "enter_degraded", "exit_degraded",
)


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """The control policy's knobs. ``from_env()`` resolves the scale
    thresholds from the registered autoscale env flags; the
    admission/degraded levels default relative to the burn thresholds
    (tighten fires between scale-up pressure and degraded entry)."""

    min_replicas: int = 1
    max_replicas: int = 4
    # scale pressure: worst multi-window burn OR queue fill fraction
    burn_up: float = 2.0
    burn_down: float = 0.25
    queue_high: float = 0.5
    queue_low: float = 0.05
    # hysteresis: consecutive pressured/idle ticks before acting, then
    # a cooldown during which no further scale action fires
    up_ticks: int = 2
    down_ticks: int = 8
    cooldown_ticks: int = 4
    # admission tightening: above tighten_burn the queue capacity
    # shrinks by tighten_factor (shed as client-class 429s); at or
    # below relax_burn it is restored
    tighten_burn: float = 6.0
    relax_burn: float = 1.0
    tighten_factor: float = 0.5
    # degraded mode: sustained burn past degrade_burn forces the
    # breakers open (flagged host-fallback service); sustained calm
    # below recover_burn lifts it
    degrade_burn: float = 14.4
    recover_burn: float = 1.0
    degrade_ticks: int = 3
    recover_ticks: int = 6

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if not (0.0 < self.tighten_factor <= 1.0):
            raise ValueError("tighten_factor must be in (0, 1]")
        # every paired threshold is a dead band: the hysteresis
        # guarantees collapse if the enter level is not above the exit
        for hi, lo, what in (
                (self.burn_up, self.burn_down, "burn_up/burn_down"),
                (self.queue_high, self.queue_low,
                 "queue_high/queue_low"),
                (self.tighten_burn, self.relax_burn,
                 "tighten_burn/relax_burn"),
                (self.degrade_burn, self.recover_burn,
                 "degrade_burn/recover_burn")):
            if hi <= lo:
                raise ValueError(
                    f"{what} must form a dead band (enter > exit)")

    @classmethod
    def from_env(cls, **overrides: Any) -> "AutoscalePolicy":
        kw: Dict[str, Any] = dict(
            min_replicas=int(env_flag("SCC_AUTOSCALE_MIN")),
            max_replicas=int(env_flag("SCC_AUTOSCALE_MAX")),
            burn_up=float(env_flag("SCC_AUTOSCALE_BURN_UP")),
            burn_down=float(env_flag("SCC_AUTOSCALE_BURN_DOWN")),
            up_ticks=int(env_flag("SCC_AUTOSCALE_UP_TICKS")),
            down_ticks=int(env_flag("SCC_AUTOSCALE_DOWN_TICKS")),
            cooldown_ticks=int(env_flag("SCC_AUTOSCALE_COOLDOWN_TICKS")),
        )
        kw.update(overrides)
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class Observation:
    """One tick's view of the fleet, reduced to the control inputs:
    the worst burn across the record-validated multi-window burn rates
    (live + retired + pool-boundary trackers — the same counters the
    slo section carries), the merged-sample p99, the fleet queue fill
    fraction, and the live width."""

    worst_burn: float
    p99_ms: Optional[float]
    queue_frac: float
    live_replicas: int


@dataclasses.dataclass
class ControlState:
    """The controller's memory between ticks. ``target`` is the width
    the controller wants; streaks and cooldown implement hysteresis;
    the admission/degraded booleans make those actions edge-triggered
    (an actuation happens on the transition, never re-fired while the
    condition holds)."""

    target: int
    up_streak: int = 0
    down_streak: int = 0
    cooldown: int = 0
    tightened: bool = False
    degraded: bool = False
    degrade_streak: int = 0
    recover_streak: int = 0


def decide(state: ControlState, obs: Observation,
           policy: AutoscalePolicy
           ) -> Tuple[ControlState, List[Dict[str, Any]]]:
    """One control step: pure, deterministic, clock-free.

    Hysteresis rules (the no-flap guarantee):

    * scale pressure must hold for ``up_ticks`` (``down_ticks``)
      CONSECUTIVE ticks — a flip to the opposite pressure resets the
      streak, so an oscillating burn series (above ``burn_up`` one
      tick, below ``burn_down`` the next) never accumulates a streak
      and never actuates;
    * after any scale action, ``cooldown_ticks`` ticks must pass
      before the next one — two actions are always at least the
      cooldown apart;
    * admission tightening and degraded mode are edge-triggered
      transitions with their own enter/exit thresholds separated by a
      dead band (``tighten_burn`` > ``relax_burn``, ``degrade_burn`` >
      ``recover_burn``).

    Returns the new state and the ordered action list; each action is
    a dict ``{"kind", "from", "to", "reason"}`` (``from``/``to`` are
    replica widths for scale actions, booleans for mode actions).
    """
    s = dataclasses.replace(state)  # shallow copy; fields are scalars
    actions: List[Dict[str, Any]] = []
    reason = {
        "worst_burn": round(float(obs.worst_burn), 4),
        "queue_frac": round(float(obs.queue_frac), 4),
    }
    if obs.p99_ms is not None:
        reason["p99_ms"] = round(float(obs.p99_ms), 4)

    # -- scale streaks -----------------------------------------------------
    pressure_up = (obs.worst_burn >= policy.burn_up
                   or obs.queue_frac >= policy.queue_high)
    pressure_down = (obs.worst_burn <= policy.burn_down
                     and obs.queue_frac <= policy.queue_low)
    if pressure_up:
        s.up_streak += 1
        s.down_streak = 0
    elif pressure_down:
        s.down_streak += 1
        s.up_streak = 0
    else:
        s.up_streak = 0
        s.down_streak = 0

    if s.cooldown > 0:
        s.cooldown -= 1
    elif (s.up_streak >= policy.up_ticks
            and s.target < policy.max_replicas):
        frm, s.target = s.target, s.target + 1
        s.up_streak = 0
        s.cooldown = policy.cooldown_ticks
        actions.append({"kind": "scale_up", "from": frm,
                        "to": s.target, "reason": dict(reason)})
    elif (s.down_streak >= policy.down_ticks
            and s.target > policy.min_replicas):
        frm, s.target = s.target, s.target - 1
        s.down_streak = 0
        s.cooldown = policy.cooldown_ticks
        actions.append({"kind": "scale_down", "from": frm,
                        "to": s.target, "reason": dict(reason)})

    # -- admission tightening (edge-triggered, burn dead band) -------------
    if not s.tightened and obs.worst_burn >= policy.tighten_burn:
        s.tightened = True
        actions.append({"kind": "tighten_admission", "from": False,
                        "to": True, "reason": dict(reason)})
    elif s.tightened and obs.worst_burn <= policy.relax_burn:
        s.tightened = False
        actions.append({"kind": "relax_admission", "from": True,
                        "to": False, "reason": dict(reason)})

    # -- degraded mode (sustained-burn entry, sustained-calm exit) ---------
    if not s.degraded:
        s.degrade_streak = (s.degrade_streak + 1
                            if obs.worst_burn >= policy.degrade_burn
                            else 0)
        if s.degrade_streak >= policy.degrade_ticks:
            s.degraded = True
            s.degrade_streak = 0
            actions.append({"kind": "enter_degraded", "from": False,
                            "to": True, "reason": dict(reason)})
    else:
        s.recover_streak = (s.recover_streak + 1
                            if obs.worst_burn <= policy.recover_burn
                            else 0)
        if s.recover_streak >= policy.recover_ticks:
            s.degraded = False
            s.recover_streak = 0
            actions.append({"kind": "exit_degraded", "from": True,
                            "to": False, "reason": dict(reason)})
    return s, actions


def validate_actuation(a: Dict[str, Any]) -> None:
    """Structural validation of one typed actuation record (the loadgen
    section validator and the ledger-row reader share it)."""
    if not isinstance(a, dict):
        raise ValueError("actuation must be an object")
    if a.get("kind") not in ACTUATION_KINDS:
        raise ValueError(
            f"actuation.kind must be one of {ACTUATION_KINDS}, "
            f"got {a.get('kind')!r}"
        )
    if not isinstance(a.get("ts"), (int, float)):
        raise ValueError("actuation.ts must be a number")
    if not isinstance(a.get("reason"), dict):
        raise ValueError("actuation.reason must be an object")
    if a["kind"] in ("scale_up", "scale_down"):
        frm, to = a.get("from"), a.get("to")
        if not (isinstance(frm, int) and isinstance(to, int)):
            raise ValueError("scale actuation needs int from/to widths")
        if (to > frm) != (a["kind"] == "scale_up"):
            raise ValueError(
                f"actuation kind {a['kind']!r} contradicts its own "
                f"from={frm} to={to}"
            )


class Autoscaler:
    """The control loop over a live pool. ``tick()`` is one observe →
    decide → actuate step (call it directly for deterministic tests);
    ``start()``/``stop()`` run it on the ``SCC_AUTOSCALE_TICK_S``
    cadence in a daemon thread. Every actuation is appended to
    ``self.actuations`` and one JSONL row to ``ledger_dir/``
    ``ACTUATION_LEDGER.jsonl`` (when a ledger dir is given)."""

    def __init__(self, pool: Any,
                 policy: Optional[AutoscalePolicy] = None,
                 ledger_dir: Optional[str] = None,
                 tick_s: Optional[float] = None):
        self.pool = pool
        self.policy = policy or AutoscalePolicy.from_env()
        self.tick_s = float(tick_s if tick_s is not None
                            else env_flag("SCC_AUTOSCALE_TICK_S"))
        self.ledger_path = (os.path.join(ledger_dir,
                                         ACTUATION_LEDGER_NAME)
                            if ledger_dir else None)
        start_width = max(min(pool.n_default,
                              self.policy.max_replicas),
                          self.policy.min_replicas)
        self.state = ControlState(target=start_width)
        self.actuations: List[Dict[str, Any]] = []
        self.ticks = 0
        # the untightened per-replica queue capacity (the pool config's
        # resolved value — each server holds its own mutable copy)
        self._base_queue_cap = int(pool.config.queue_capacity)
        self._objectives = serve_slo.resolve_objectives()
        self._budget = max(1.0 - float(self._objectives["availability"]),
                           1e-9)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- observe -----------------------------------------------------------
    def observe(self) -> Observation:
        """Reduce one swap-lock telemetry snapshot to the control
        inputs. Burn is computed from the SAME window deltas the
        record's slo section carries (live + retired + pool boundary),
        with the budget from this process's declared objectives."""
        snap = self.pool.telemetry_snapshot()
        live = snap["replicas"]
        all_deltas = ([r["expo"]["window_deltas"] for r in live]
                      + [e.get("window_deltas") or []
                         for e in snap.get("retired_expo") or []]
                      + [snap["pool_expo"]["window_deltas"]])
        windows: Dict[float, Dict[str, int]] = {}
        for deltas in all_deltas:
            for wd in deltas:
                w = float(wd["window_s"])
                agg = windows.setdefault(w, {"bad": 0, "total": 0})
                agg["bad"] += int(wd["bad"])
                agg["total"] += int(wd["total"])
        worst = 0.0
        for agg in windows.values():
            if agg["total"]:
                err = agg["bad"] / agg["total"]
                worst = max(worst, err / self._budget)
        depth = sum(int(r["expo"]["queue_depth"]) for r in live)
        cap = sum(int(r["expo"]["queue_cap"]) for r in live)
        merged = [ms for r in live for ms in r["samples"]]
        return Observation(
            worst_burn=worst,
            p99_ms=serve_slo.p99_ms(merged),
            queue_frac=(depth / cap) if cap else 0.0,
            live_replicas=len(live),
        )

    # -- actuate -----------------------------------------------------------
    def _stamp(self, action: Dict[str, Any]) -> Dict[str, Any]:
        rec = {
            "kind": action["kind"],
            "from": action["from"],
            "to": action["to"],
            "reason": dict(action.get("reason") or {}),
            "ts": round(time.time(), 3),
        }
        if env_flag("SCC_OBS_TRACE"):
            rec["trace_id"] = new_trace_id()
        with self._lock:
            self.actuations.append(rec)
        if self.ledger_path:
            try:
                os.makedirs(os.path.dirname(self.ledger_path),
                            exist_ok=True)
                # ledger rows discriminate on "kind" (the quarantine
                # rows own the legacy shape), so the action name moves
                # to "action" in the on-disk twin
                row = dict(rec)
                row["action"] = row.pop("kind")
                row["kind"] = "actuation"
                with open(self.ledger_path, "a") as f:
                    f.write(json.dumps(row) + "\n")
            except OSError:
                pass  # actuation must not die on a full disk
        return rec

    def _actuate(self, action: Dict[str, Any]) -> None:
        kind = action["kind"]
        if kind in ("scale_up", "scale_down"):
            self.pool.scale_to(int(action["to"]),
                               reason=action.get("reason"))
        elif kind == "tighten_admission":
            cap = max(int(self._base_queue_cap
                          * self.policy.tighten_factor), 1)
            for rep in self.pool.replicas():
                rep.server.config.queue_capacity = cap
        elif kind == "relax_admission":
            for rep in self.pool.replicas():
                rep.server.config.queue_capacity = self._base_queue_cap
        elif kind == "enter_degraded":
            for rep in self.pool.replicas():
                rep.server.breaker.force_open()
        elif kind == "exit_degraded":
            for rep in self.pool.replicas():
                rep.server.breaker.force_close()
        self._stamp(action)

    def tick(self) -> List[Dict[str, Any]]:
        """One observe → decide → actuate step; returns the actions it
        took (possibly empty)."""
        obs = self.observe()
        self.state, actions = decide(self.state, obs, self.policy)
        for action in actions:
            self._actuate(action)
        self.ticks += 1
        # newly scaled-up replicas start with the BASE capacity; while
        # tightened, pull them down to the tightened one
        if self.state.tightened and any(
                a["kind"] == "scale_up" for a in actions):
            cap = max(int(self._base_queue_cap
                          * self.policy.tighten_factor), 1)
            for rep in self.pool.replicas():
                rep.server.config.queue_capacity = cap
        return actions

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "Autoscaler":
        if self._thread is not None:
            return self
        self._stop.clear()

        def _loop():
            while not self._stop.wait(self.tick_s):
                try:
                    self.tick()
                except Exception:
                    # the control loop must outlive a torn snapshot
                    # mid-shutdown; the next tick observes fresh
                    continue

        self._thread = threading.Thread(target=_loop,
                                        name="scc-autoscale",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._thread = None

    def __enter__(self) -> "Autoscaler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def section(self) -> Dict[str, Any]:
        """The autoscaler's summary block (rides the run record's
        ``loadgen`` section): policy, final state, every actuation."""
        with self._lock:
            acts = [dict(a) for a in self.actuations]
        return {
            "policy": dataclasses.asdict(self.policy),
            "ticks": int(self.ticks),
            "final_target": int(self.state.target),
            "degraded": bool(self.state.degraded),
            "tightened": bool(self.state.tightened),
            "actuations": acts,
        }
