"""The port's open-loop load generator: the reference's seeded
schedules, mixes and section rules (``tests/test_loadgen.py``), plus the
Autoscaler's actuation plumbing over a duck-typed pool, run on
``scconsensus_tpu_torch.serve.fleet``.

Schedules and validators are pure, and the Autoscaler's observe and
actuate plumbing is exercised against a fake pool whose telemetry the
test scripts tick by tick. The end-to-end run over the wire is in
``tests/test_torch_fleet_chaos.py``.
"""

import json
import os
import types

import numpy as np
import pytest
import torch

from scconsensus_tpu_torch.serve.fleet.loadgen import (
    PROFILES,
    arrival_offsets,
    build_loadgen_section,
    rate_profile,
    resolve_mix,
    slo_breaches,
    validate_loadgen,
)

torch.set_num_threads(2)


# --------------------------------------------------------------------------
# arrival schedules
# --------------------------------------------------------------------------

class TestSchedules:
    def test_offsets_deterministic_per_seed(self):
        a = arrival_offsets("steady", 20.0, 20.0, 4.0, seed=7)
        b = arrival_offsets("steady", 20.0, 20.0, 4.0, seed=7)
        c = arrival_offsets("steady", 20.0, 20.0, 4.0, seed=8)
        assert a == b
        assert a != c

    @pytest.mark.parametrize("profile", PROFILES)
    def test_offsets_sorted_and_bounded(self, profile):
        offs = arrival_offsets(profile, 15.0, 60.0, 5.0, seed=3)
        assert offs == sorted(offs)
        assert all(0.0 <= t < 5.0 for t in offs)
        assert len(offs) > 0

    def test_poisson_volume_tracks_offered_rate(self):
        # law of large numbers, loose band: a steady 50 rps over 20 s
        # offers ~1000 arrivals
        offs = arrival_offsets("steady", 50.0, 50.0, 20.0, seed=11)
        assert 800 <= len(offs) <= 1200

    def test_spike_concentrates_in_middle_third(self):
        d = 9.0
        offs = arrival_offsets("spike", 5.0, 100.0, d, seed=5)
        mid = [t for t in offs if d / 3 <= t < 2 * d / 3]
        # the middle third runs 20x the base rate: the bulk must land in
        # it
        assert len(mid) > 0.7 * len(offs)

    def test_ramp_back_loads_the_schedule(self):
        d = 10.0
        offs = arrival_offsets("ramp", 2.0, 60.0, d, seed=5)
        first, last = [t for t in offs if t < d / 2], \
            [t for t in offs if t >= d / 2]
        assert len(last) > 2 * len(first)

    def test_burst_arrivals_form_trains(self):
        offs = arrival_offsets("steady", 40.0, 40.0, 6.0, seed=9,
                               arrival="burst", burst_size=4)
        gaps = np.diff(offs)
        # train members are 1 ms apart; a healthy share of consecutive
        # gaps must be exactly the intra-train spacing
        assert (np.abs(gaps - 0.001) < 1e-9).sum() >= len(offs) / 3

    def test_rate_profile_shapes(self):
        assert rate_profile("steady", 3.0, 10.0, 8.0, 32.0) == 8.0
        assert rate_profile("spike", 5.0, 10.0, 8.0, 32.0) == 32.0
        assert rate_profile("spike", 0.5, 10.0, 8.0, 32.0) == 8.0
        r0 = rate_profile("ramp", 0.0, 10.0, 8.0, 32.0)
        r1 = rate_profile("ramp", 10.0, 10.0, 8.0, 32.0)
        assert r0 == pytest.approx(8.0)
        assert r1 == pytest.approx(32.0)
        lo = rate_profile("diurnal", 0.0, 10.0, 8.0, 32.0)
        hi = rate_profile("diurnal", 5.0, 10.0, 8.0, 32.0)
        assert lo < 8.0 < hi


# --------------------------------------------------------------------------
# traffic mixes
# --------------------------------------------------------------------------

class TestMixes:
    def test_default_mix_is_equal_over_the_zoo(self):
        from scconsensus_tpu_torch.workloads import scenario_names

        mix = resolve_mix(None)
        names = scenario_names()
        assert sorted(mix) == names
        assert all(w == pytest.approx(1.0 / len(names))
                   for w in mix.values())

    def test_mix_normalizes(self):
        mix = resolve_mix({"multi_sample": 3.0, "cite_dual": 1.0})
        assert mix["multi_sample"] == pytest.approx(0.75)
        assert sum(mix.values()) == pytest.approx(1.0)

    def test_unregistered_scenario_rejected(self):
        with pytest.raises(ValueError, match="scenario"):
            resolve_mix({"not_a_scenario": 1.0})

    def test_nonpositive_weight_rejected(self):
        with pytest.raises(ValueError, match="number > 0"):
            resolve_mix({"multi_sample": 0.0})


# --------------------------------------------------------------------------
# the loadgen section and its validator
# --------------------------------------------------------------------------

def _section(**over):
    base = dict(
        profile="spike", arrival="poisson", base_rps=12.0,
        peak_rps=150.0, duration_s=15.0, seed=7,
        mix={"multi_sample": 0.5, "atlas_transfer": 0.5},
        offered=200, sent=200, completed=200, good=184,
        late_fraction=0.01, achieved_rps=12.3, breaches=[],
    )
    base.update(over)
    return build_loadgen_section(**base)


class TestSectionRules:
    def test_clean_section_validates(self):
        lg = _section()
        assert lg["slo_held"] is True
        assert lg["rps_at_slo"] == lg["achieved_rps"]
        validate_loadgen(lg)

    def test_breached_run_forfeits_its_headline(self):
        lg = _section(breaches=["burn: worst 20.0x over limit 14.4x"])
        assert lg["slo_held"] is False
        assert lg["rps_at_slo"] == 0.0
        validate_loadgen(lg)

    def test_nonzero_headline_on_breached_run_rejected(self):
        lg = _section(breaches=["latency: p99 over target"])
        lg["rps_at_slo"] = 12.3  # the lie the validator exists to catch
        with pytest.raises(ValueError, match="rps_at_slo"):
            validate_loadgen(lg)

    def test_slo_held_must_agree_with_breaches(self):
        lg = _section()
        lg["slo_held"] = False
        with pytest.raises(ValueError, match="slo_held"):
            validate_loadgen(lg)

    def test_accounting_ladder_enforced(self):
        lg = _section()
        lg["sent"] = lg["offered"] + 1
        with pytest.raises(ValueError, match="offered"):
            validate_loadgen(lg)

    def test_actuations_validated_through_the_section(self):
        lg = _section()
        lg["autoscale"] = {
            "ticks": 10, "final_target": 1,
            "actuations": [{"kind": "scale_up", "from": 2, "to": 1,
                            "ts": 1.0, "reason": {}}],
        }
        with pytest.raises(ValueError, match="contradicts"):
            validate_loadgen(lg)

    def test_slo_breach_rules_are_history_free(self):
        clean = {"objectives": {"burn_limit": 14.4},
                 "worst_burn": 2.0,
                 "latency": {"p99_ms": 100.0, "target_ms": 250.0,
                             "met": True}}
        assert slo_breaches(clean) == []
        burned = dict(clean, worst_burn=20.0)
        assert any("burn" in b for b in slo_breaches(burned))
        late = dict(clean, latency={"p99_ms": 400.0,
                                    "target_ms": 250.0, "met": False})
        assert any("latency" in b for b in slo_breaches(late))


# --------------------------------------------------------------------------
# Autoscaler plumbing over a scripted fake pool
# --------------------------------------------------------------------------

class _FakeBreaker:
    def __init__(self):
        self.forced = False

    def force_open(self):
        self.forced = True

    def force_close(self):
        self.forced = False


class _FakePool:
    """Duck-typed pool: telemetry scripted by the test, actuations
    recorded. queue_cap/queue_depth drive the controller's queue_frac;
    bad/total drive its burn."""

    def __init__(self, queue_capacity=16):
        self.n_default = 1
        self.config = types.SimpleNamespace(
            queue_capacity=queue_capacity)
        self.width = 1
        self.scale_calls = []
        self._reps = [types.SimpleNamespace(server=types.SimpleNamespace(
            config=types.SimpleNamespace(queue_capacity=queue_capacity),
            breaker=_FakeBreaker()))]
        self.depth = 0
        self.bad = 0
        self.total = 0

    def replicas(self):
        return list(self._reps)

    def scale_to(self, n, reason=None, **kw):
        self.scale_calls.append((self.width, n, reason))
        self.width = n

    def telemetry_snapshot(self):
        return {
            "replicas": [{
                "expo": {
                    "window_deltas": [{"window_s": 60.0,
                                       "bad": self.bad,
                                       "total": self.total}],
                    "queue_depth": self.depth,
                    "queue_cap": self.config.queue_capacity,
                },
                "samples": [],
            }],
            "retired_expo": [],
            "pool_expo": {"window_deltas": []},
        }


class TestAutoscalerPlumbing:
    def _scaler(self, tmp_path, **policy_kw):
        from scconsensus_tpu_torch.serve.fleet.autoscale import (
            Autoscaler,
            AutoscalePolicy,
        )

        pool = _FakePool()
        kw = dict(min_replicas=1, max_replicas=3, up_ticks=2,
                  down_ticks=3, cooldown_ticks=2)
        kw.update(policy_kw)
        sc = Autoscaler(pool, policy=AutoscalePolicy(**kw),
                        ledger_dir=str(tmp_path), tick_s=0.01)
        return pool, sc

    def test_queue_pressure_actuates_and_stamps_the_ledger(self,
                                                           tmp_path):
        from scconsensus_tpu_torch.serve.fleet.autoscale import (
            ACTUATION_LEDGER_NAME,
        )

        pool, sc = self._scaler(tmp_path)
        pool.depth = 16  # full queue
        sc.tick()
        assert sc.tick()  # streak threshold: the 2nd tick actuates
        assert [(frm, to) for frm, to, _ in pool.scale_calls] \
            == [(1, 2)]
        assert pool.scale_calls[0][2]["queue_frac"] == 1.0
        assert [a["kind"] for a in sc.actuations] == ["scale_up"]
        rows = [json.loads(ln) for ln in open(
            os.path.join(str(tmp_path), ACTUATION_LEDGER_NAME))]
        assert [(r["kind"], r["action"], r["from"], r["to"])
                for r in rows] == [("actuation", "scale_up", 1, 2)]
        assert rows[0]["reason"]["queue_frac"] == 1.0

    def test_burn_tightens_then_restores_admission(self, tmp_path):
        pool, sc = self._scaler(tmp_path, tighten_burn=6.0,
                                relax_burn=1.0)
        # availability budget 0.001 → 2 bad / 100 = 20x burn
        pool.bad, pool.total = 2, 100
        sc.tick()
        rep_cfg = pool.replicas()[0].server.config
        assert sc.state.tightened is True
        assert rep_cfg.queue_capacity == 8  # 16 * tighten_factor 0.5
        pool.bad = 0
        sc.tick()
        assert sc.state.tightened is False
        assert rep_cfg.queue_capacity == 16

    def test_sustained_burn_forces_breakers_then_releases(self,
                                                          tmp_path):
        pool, sc = self._scaler(tmp_path, degrade_ticks=2,
                                recover_ticks=2)
        br = pool.replicas()[0].server.breaker
        pool.bad, pool.total = 50, 100  # far past degrade_burn 14.4
        sc.tick()
        assert br.forced is False
        sc.tick()
        assert br.forced is True  # entered degraded on the 2nd tick
        pool.bad = 0
        sc.tick()
        sc.tick()
        assert br.forced is False
        acts = [a["kind"] for a in sc.actuations]
        assert "enter_degraded" in acts and "exit_degraded" in acts

    def test_section_carries_every_actuation(self, tmp_path):
        pool, sc = self._scaler(tmp_path)
        pool.depth = 16
        sc.tick()
        sc.tick()
        sec = sc.section()
        assert sec["ticks"] == 2
        assert sec["final_target"] == 2
        assert len(sec["actuations"]) == 1
        from scconsensus_tpu_torch.serve.fleet.autoscale import (
            validate_actuation,
        )

        for a in sec["actuations"]:
            validate_actuation(a)
