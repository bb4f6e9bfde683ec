"""The port's burn-rate autoscaler policy: the reference's pure
``decide()`` tables (``tests/test_autoscale.py``), run on
``scconsensus_tpu_torch.serve.fleet.autoscale``.

The control policy is a pure function over scalar observations, so every
hysteresis rule (streaks, cooldown spacing, edge-triggered admission,
degraded-mode dead bands, the no-flap guarantee) runs here as a table
with no pool, no wire and no clock. Exact equality throughout: the
policy is integer and threshold logic.
"""

import dataclasses

import pytest
import torch

from scconsensus_tpu_torch.serve.fleet.autoscale import (
    ACTUATION_KINDS,
    AutoscalePolicy,
    ControlState,
    Observation,
    decide,
    validate_actuation,
)

torch.set_num_threads(2)

POLICY = AutoscalePolicy(
    min_replicas=1, max_replicas=3,
    burn_up=2.0, burn_down=0.25,
    queue_high=0.5, queue_low=0.05,
    up_ticks=2, down_ticks=3, cooldown_ticks=2,
    tighten_burn=6.0, relax_burn=1.0,
    degrade_burn=14.4, recover_burn=1.0,
    degrade_ticks=2, recover_ticks=3,
)


def obs(burn=0.0, queue=0.0, p99=None):
    return Observation(worst_burn=burn, p99_ms=p99, queue_frac=queue,
                       live_replicas=1)


def run_series(series, state=None, policy=POLICY):
    """Feed observations through decide; returns the final state plus
    ``[(tick index, action), ...]`` for every actuation taken."""
    s = state if state is not None \
        else ControlState(target=policy.min_replicas)
    log = []
    for i, o in enumerate(series):
        s, actions = decide(s, o, policy)
        log.extend((i, a) for a in actions)
    return s, log


def kinds(log, *names):
    return [(i, a) for i, a in log if a["kind"] in names]


class TestScaleHysteresis:
    def test_one_hot_tick_never_scales(self):
        s, log = run_series([obs(burn=50.0)])
        assert log == [] or all(a["kind"] not in ("scale_up",
                                                  "scale_down")
                                for _, a in log)
        assert s.target == 1

    def test_burn_streak_scales_up(self):
        s, log = run_series([obs(burn=3.0), obs(burn=3.0)])
        ups = kinds(log, "scale_up")
        assert [(i, a["from"], a["to"]) for i, a in ups] == [(1, 1, 2)]
        assert ups[0][1]["reason"]["worst_burn"] == 3.0
        assert s.target == 2

    def test_queue_pressure_alone_scales_up(self):
        # zero burn (every request fine) but a standing queue: the spike
        # arc — clean runs scale on queue fill, not on errors
        _, log = run_series([obs(queue=0.9), obs(queue=0.9)])
        assert [(i, a["from"], a["to"])
                for i, a in kinds(log, "scale_up")] == [(1, 1, 2)]

    def test_cooldown_spaces_consecutive_actions(self):
        # sustained pressure: up at t1; then the 2-tick cooldown must
        # pass (t2, t3) before the streak can fire again at t4
        _, log = run_series([obs(burn=9.9, queue=1.0)] * 8,
                            state=ControlState(target=1))
        ups = kinds(log, "scale_up")
        assert [(i, a["from"], a["to"]) for i, a in ups] \
            == [(1, 1, 2), (4, 2, 3)]

    def test_scale_down_after_sustained_calm(self):
        _, log = run_series([obs(burn=0.0, queue=0.0)] * 8,
                            state=ControlState(target=3))
        downs = kinds(log, "scale_down")
        assert [(i, a["from"], a["to"]) for i, a in downs] \
            == [(2, 3, 2), (5, 2, 1)]

    def test_bounds_are_hard(self):
        s, _ = run_series([obs(burn=9.0, queue=1.0)] * 20)
        assert s.target == POLICY.max_replicas
        s, log = run_series([obs()] * 20)
        assert s.target == POLICY.min_replicas
        assert kinds(log, "scale_down") == []

    def test_decide_never_mutates_its_input(self):
        state = ControlState(target=1)
        decide(state, obs(burn=9.0, queue=1.0), POLICY)
        assert state == ControlState(target=1)


class TestNoFlapUnderOscillation:
    def test_alternating_pressure_never_actuates(self):
        # burn above burn_up one tick, below burn_down the next, 40
        # ticks: each flip resets the opposite streak, so NOTHING fires
        # — the no-flap guarantee the docstring promises
        series = [obs(burn=3.0 if i % 2 == 0 else 0.1)
                  for i in range(40)]
        s, log = run_series(series, state=ControlState(target=2))
        assert log == []
        assert s.target == 2

    def test_neither_pressure_resets_both_streaks(self):
        # a dead-band tick (burn between the thresholds) after a hot
        # tick zeroes the up streak: hot, calm-ish, hot never fires
        series = [obs(burn=3.0), obs(burn=1.0), obs(burn=3.0),
                  obs(burn=1.0)]
        _, log = run_series(series)
        assert kinds(log, "scale_up", "scale_down") == []


class TestAdmissionEdges:
    def test_tighten_then_relax_fire_once_each(self):
        series = [obs(burn=7.0)] * 3 + [obs(burn=0.5)] * 2
        _, log = run_series(series)
        tightens = kinds(log, "tighten_admission")
        relaxes = kinds(log, "relax_admission")
        assert [i for i, _ in tightens] == [0]
        assert [i for i, _ in relaxes] == [3]
        assert tightens[0][1]["from"] is False
        assert tightens[0][1]["to"] is True

    def test_dead_band_holds_the_tightened_state(self):
        # burn drops below tighten_burn but stays above relax_burn: the
        # admission cap must NOT relax inside the dead band
        series = [obs(burn=7.0), obs(burn=1.5), obs(burn=1.5)]
        s, log = run_series(series)
        assert kinds(log, "relax_admission") == []
        assert s.tightened is True


class TestDegradedMode:
    def test_sustained_burn_enters_once(self):
        series = [obs(burn=20.0)] * 6
        s, log = run_series(series)
        enters = kinds(log, "enter_degraded")
        assert [i for i, _ in enters] == [1]  # degrade_ticks=2
        assert s.degraded is True

    def test_one_hot_tick_does_not_degrade(self):
        s, log = run_series([obs(burn=20.0), obs(burn=0.0)])
        assert kinds(log, "enter_degraded") == []
        assert s.degraded is False

    def test_recovery_streak_resets_on_relapse(self):
        state = ControlState(target=1, degraded=True)
        series = [obs(burn=0.5), obs(burn=0.5), obs(burn=20.0),
                  obs(burn=0.5), obs(burn=0.5), obs(burn=0.5)]
        s, log = run_series(series, state=state)
        exits = kinds(log, "exit_degraded")
        assert [i for i, _ in exits] == [5]  # recover_ticks=3, reset at 2
        assert s.degraded is False


class TestPolicyAndValidation:
    def test_policy_rejects_inverted_thresholds(self):
        with pytest.raises(ValueError):
            AutoscalePolicy(min_replicas=3, max_replicas=1)
        with pytest.raises(ValueError):
            AutoscalePolicy(burn_up=0.2, burn_down=2.0)

    def test_validate_actuation_happy_path(self):
        for kind in ACTUATION_KINDS:
            frm, to = ((1, 2) if kind == "scale_up"
                       else (2, 1) if kind == "scale_down"
                       else (False, True))
            validate_actuation({"kind": kind, "from": frm, "to": to,
                                "ts": 1.0, "reason": {"worst_burn": 3.0}})

    @pytest.mark.parametrize("bad, msg", [
        ({"kind": "restart", "ts": 1.0, "reason": {}}, "kind"),
        ({"kind": "scale_up", "reason": {}}, "ts"),
        ({"kind": "scale_up", "ts": 1.0, "reason": None}, "reason"),
        ({"kind": "scale_up", "from": 2, "to": 1, "ts": 1.0,
          "reason": {}}, "contradicts"),
        ({"kind": "scale_down", "from": 1, "to": 2, "ts": 1.0,
          "reason": {}}, "contradicts"),
        ({"kind": "scale_up", "from": "1", "to": 2, "ts": 1.0,
          "reason": {}}, "int"),
    ])
    def test_validate_actuation_rejects(self, bad, msg):
        with pytest.raises(ValueError, match=msg):
            validate_actuation(bad)

    def test_from_env_overrides_win(self):
        p = AutoscalePolicy.from_env(max_replicas=7, up_ticks=5)
        assert p.max_replicas == 7
        assert p.up_ticks == 5
