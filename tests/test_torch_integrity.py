"""The port's computation-integrity layer (``robust/integrity.py``)
against the JAX package's, on the CPU: the invariant checks and the
float64 ghost-replay oracle, every corruption site the port opens
detected in both packages under the same check name and recomputed to a
result bit-identical to the unfaulted run, and the ``integrity``
section's validation.

Tolerances: the oracle is float64 arithmetic shared verbatim with the
reference, so it agrees with the reference's oracle exactly and with
scipy to 1e-9; the port's float32 rank-sum kernel agrees with the oracle
within the layer's own bands (U 0.51, log p 5e-2). Labels and DE masks
of a recovered run are compared bit for bit with the unfaulted run of the
same package."""

import json

import numpy as np
import pytest
import torch

from scconsensus_tpu.config import ReclusterConfig as RefConfig
from scconsensus_tpu.models.pipeline import refine as ref_refine
from scconsensus_tpu.robust import faults as ref_faults
from scconsensus_tpu.robust import integrity as ref_integrity
from scconsensus_tpu.robust import record as ref_record
from scconsensus_tpu.utils.synthetic import noisy_labeling, synthetic_scrna
import scconsensus_tpu_torch as port
from scconsensus_tpu_torch.carry import config_from_reference
from scconsensus_tpu_torch.robust import faults, integrity
from scconsensus_tpu_torch.robust import record as robust_record
from scconsensus_tpu_torch.robust import retry as robust_retry
from scconsensus_tpu_torch.robust.record import validate_robustness


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # the suite runs six workers on the machine's cores; two torch threads
    # a worker keep these small tensors from crowding out the other files
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_state(monkeypatch):
    """Fast backoffs and fresh fault, robustness and integrity state in
    both packages (integrity stays off unless a test opts in)."""
    monkeypatch.setenv("SCC_ROBUST_BACKOFF_S", "0.002")
    monkeypatch.delenv("SCC_FAULT_PLAN", raising=False)
    monkeypatch.delenv("SCC_INTEGRITY", raising=False)
    for mod in (faults, ref_faults):
        mod.reset()
    for mod in (robust_record, ref_record):
        mod.begin_run()
    for mod in (integrity, ref_integrity):
        mod.begin_run()
    yield
    faults.reset()
    ref_faults.reset()


@pytest.fixture(scope="module")
def small_case():
    data, truth, _ = synthetic_scrna(
        n_genes=60, n_cells=200, n_clusters=3, n_markers_per_cluster=8,
        seed=11,
    )
    return data, noisy_labeling(truth, 0.05, seed=2)


def _ref_cfg(**kw):
    base = dict(deep_split_values=(1, 2), min_cluster_size=5,
                q_val_thrs=0.1, log_fc_thrs=0.2, min_pct=5.0)
    base.update(kw)
    return RefConfig(**base)


def _cfg(**kw):
    return config_from_reference(_ref_cfg(**kw).to_json())


def _plan(tmp_path, rules, monkeypatch, name="plan.json"):
    path = tmp_path / name
    path.write_text(json.dumps({"faults": rules}))
    monkeypatch.setenv("SCC_FAULT_PLAN", str(path))
    faults.reset()
    ref_faults.reset()


def _bits(res):
    """Labels and the DE mask, as bytes."""
    out = {k: np.asarray(v).tobytes() for k, v in res.dynamic_labels.items()}
    mask = res.de.de_mask
    out["de_mask"] = np.asarray(
        mask.numpy() if isinstance(mask, torch.Tensor) else mask).tobytes()
    return out


def _detected_by(section):
    """The check names that caught something on an integrity section."""
    return ({v["check"] for v in section["violations"]}
            | {m["check"] for m in section["ghost"]["mismatches"]})


# --------------------------------------------------------------------------
# invariant and oracle units
# --------------------------------------------------------------------------

class TestInvariants:
    def test_wilcox_bucket_clean_passes_and_signflip_detected(
        self, monkeypatch
    ):
        monkeypatch.setenv("SCC_INTEGRITY", "enforce")
        integrity.begin_run()
        rng = np.random.default_rng(0)
        P, Gc = 3, 8
        n1 = np.array([40, 50, 60], np.int32)
        n2 = np.array([50, 60, 40], np.int32)
        u = (rng.random((Gc, P)) * (n1 * n2)[None, :]).astype(np.float32)
        m = (n1 + n2).astype(np.float64)
        ties = (rng.random((Gc, P)) * (m ** 3 - m)[None, :] * 0.5
                ).astype(np.float32)
        lp = -np.abs(rng.normal(2.0, 1.0, (Gc, P))).astype(np.float32)
        t = torch.from_numpy
        integrity.check_wilcox_bucket("wilcox_bucket", t(lp), t(u),
                                      t(ties), n1, n2)  # no raise
        bad = lp.copy()
        bad[1, 1] = -bad[1, 1]  # a positive log p: impossible output
        with pytest.raises(integrity.InvariantViolation) as ei:
            integrity.check_wilcox_bucket("wilcox_bucket", t(bad), t(u),
                                          t(ties), n1, n2)
        log = integrity.current()
        assert log.checks["wilcox_conservation"][1] == 2
        assert log.checks["wilcox_conservation"][2] == 1
        # the same residual as the reference's check on the same arrays
        import jax.numpy as jnp

        monkeypatch.setenv("SCC_INTEGRITY", "audit")
        ref_integrity.begin_run()
        ref_integrity.check_wilcox_bucket(
            "wilcox_bucket", jnp.asarray(bad), jnp.asarray(u),
            jnp.asarray(ties), n1, n2)
        (v,) = ref_integrity.current().violations
        assert round(ei.value.magnitude, 6) == v["magnitude"]
        assert ei.value.check == v["check"] == "wilcox_conservation"

    def test_bh_monotonicity_detects_q_below_p(self, monkeypatch):
        monkeypatch.setenv("SCC_INTEGRITY", "enforce")
        integrity.begin_run()
        lp = torch.log(torch.tensor([[0.5, 0.01, 0.2]]))
        lq = torch.log(torch.tensor([[0.5, 0.03, 0.2]]))
        integrity.check_bh("bh_adjust", lp, lq)  # q >= p everywhere: ok
        bad = torch.log(torch.tensor([[0.5, 0.001, 0.2]]))
        with pytest.raises(integrity.InvariantViolation):
            integrity.check_bh("bh_adjust", lp, bad)  # q < p
        over = torch.tensor([[0.1, -1.0, -2.0]])     # q > 1
        with pytest.raises(integrity.InvariantViolation):
            integrity.check_bh("bh_adjust", lp, over)
        # an all-NaN slab has nothing finite to check and passes
        nan = torch.full((1, 3), float("nan"))
        integrity.check_bh("bh_adjust", nan, nan)
        assert integrity.current().checks["bh_monotonic"] == [4, 4, 2]

    def test_pca_audited_orthonormal_and_replay(self, monkeypatch):
        from scconsensus_tpu_torch.ops.pca import (
            pca_scores,
            pca_scores_audited,
        )

        monkeypatch.setenv("SCC_INTEGRITY", "enforce")
        integrity.begin_run()
        x = torch.from_numpy(np.random.default_rng(3).normal(
            size=(80, 20)).astype(np.float32))
        scores, resid, mean, comps = pca_scores_audited(x, 5)
        # the audit does not change the science: the same bits
        np.testing.assert_array_equal(scores.numpy(),
                                      pca_scores(x, 5).numpy())
        assert float(resid) <= integrity.tol("pca_orthonormal")
        integrity.check_pca_basis("stage:embed", resid)  # ok
        integrity.replay_pca_rows("stage:embed", x, mean, comps, scores,
                                  n_rows=80)  # ok
        with pytest.raises(integrity.InvariantViolation):
            integrity.check_pca_basis("stage:embed", torch.tensor(1.0))
        # a scaled score row disagrees with the float64 projection
        with pytest.raises(integrity.GhostReplayMismatch):
            integrity.replay_pca_rows("stage:embed", x, mean, comps,
                                      scores * 1.5, n_rows=80)

    def test_landmark_occupancy_and_contingency(self, monkeypatch):
        monkeypatch.setenv("SCC_INTEGRITY", "enforce")
        integrity.begin_run()
        assign = np.array([0, 1, 1, 2, 0, 2], np.int64)
        integrity.check_landmark_occupancy("landmark_assign", assign,
                                           3, 6)  # ok
        with pytest.raises(integrity.InvariantViolation):
            integrity.check_landmark_occupancy(
                "landmark_assign", np.array([0, 1, 5], np.int64), 3, 3)
        # a negative index raises the same typed violation, not
        # np.bincount's untyped ValueError
        with pytest.raises(integrity.InvariantViolation):
            integrity.check_landmark_occupancy(
                "landmark_assign", np.array([0, -1, 2], np.int64), 3, 3)
        ridx = np.array([0, 0, 1, 1])
        cidx = np.array([0, 1, 0, 1])
        mat = np.ones((2, 2), np.int64)
        integrity.check_contingency("contingency_table", mat, ridx, cidx)
        with pytest.raises(integrity.InvariantViolation):
            integrity.check_contingency(
                "contingency_table", mat + np.eye(2, dtype=np.int64),
                ridx, cidx)

    def test_mismatch_rearms_the_replay_unit(self, monkeypatch):
        """A mismatch re-arms its (kind, key) sample, so the recompute is
        verified by the same replay; a passing replay stays deduped."""
        monkeypatch.setenv("SCC_INTEGRITY", "enforce")
        integrity.begin_run()
        log = integrity.current()
        assert log.want_replay("landmark", 0)
        log.note_mismatch("landmark_replay", "landmark_assign",
                          "block0", 1.0, 1e-5)
        assert log.want_replay("landmark", 0)
        assert log.site_streak("landmark_assign") == 1
        log.note_mismatch("landmark_replay", "landmark_assign",
                          "block0", 1.0, 1e-5)
        assert log.site_streak("landmark_assign") == 2
        assert log.want_replay("landmark", 0)
        log.note_replay_ok("landmark_assign")
        assert not log.want_replay("landmark", 0)
        assert log.replays_planned == 3
        assert log.replays_run == 3

    def test_both_packages_sample_the_same_units(self):
        for n, k in [(0, 3), (2, 3), (3, 3), (100, 3), (26_000, 256),
                     (7, 4)]:
            np.testing.assert_array_equal(integrity._sample_idx(n, k),
                                          ref_integrity._sample_idx(n, k))
        ours, ref = integrity.IntegrityLog(), ref_integrity.IntegrityLog()
        keys = [("wilcox", 1024), ("wilcox", 1024), ("wilcox", 2048),
                ("pca", 0), ("serve", 0), ("serve", 0), ("serve", 1)]
        assert [ours.want_replay(*k) for k in keys] == \
            [ref.want_replay(*k) for k in keys]

    def test_oracle_matches_scipy_the_reference_and_the_kernel(self):
        from scipy.stats import mannwhitneyu

        from scconsensus_tpu_torch.ops.ranksum_allpairs import ranksum_body

        rng = np.random.default_rng(5)
        g1 = np.round(rng.gamma(2.0, 1.0, 60), 1)  # ties guaranteed
        g2 = np.round(rng.gamma(2.5, 1.0, 80), 1)
        vals = np.concatenate([g1, g2])
        cids = np.concatenate([np.zeros(60, np.int32),
                               np.ones(80, np.int32)])
        lp, u = integrity.wilcox_oracle_pair(vals, cids, 60, 80, 0, 1,
                                             pad_zeros=False)
        assert (lp, u) == ref_integrity.wilcox_oracle_pair(
            vals, cids, 60, 80, 0, 1, pad_zeros=False)
        ref = mannwhitneyu(g1, g2, alternative="two-sided",
                           method="asymptotic", use_continuity=True)
        assert u == pytest.approx(float(ref.statistic), abs=1e-9)
        assert lp == pytest.approx(float(np.log(ref.pvalue)), abs=1e-9)
        # the port's rank-sum kernel on the same slice, within the bands
        lp_d, u_d, _ = ranksum_body(
            torch.from_numpy(vals[None, :].astype(np.float32)),
            torch.from_numpy(cids.astype(np.int64)),
            torch.tensor([60, 80], dtype=torch.int32),
            torch.tensor([0]), torch.tensor([1]), 2)
        assert float(u_d[0, 0]) == pytest.approx(u, abs=0.51)
        assert float(lp_d[0, 0]) == pytest.approx(lp, abs=5e-2)


# --------------------------------------------------------------------------
# every corruption site: detected in both packages under the same check,
# recovered typed, bit-identical to the unfaulted run
# --------------------------------------------------------------------------

def _run_port(data, labels):
    integrity.begin_run()
    return port.refine(data, labels, _cfg(), device="cpu")


def _run_ref(data, labels):
    ref_integrity.begin_run()
    return ref_refine(data, labels, _ref_cfg(), mesh=None)


class TestCorruptionMatrix:
    @pytest.fixture(scope="class")
    def clean(self, small_case):
        data, labels = small_case
        mp = pytest.MonkeyPatch()
        mp.setenv("SCC_INTEGRITY", "enforce")
        try:
            ours, ref = _run_port(data, labels), _run_ref(data, labels)
        finally:
            mp.undo()
        return _bits(ours), ours, ref

    def test_healthy_enforce_run_passes_the_reference_s_checks(self, clean):
        _, ours, ref = clean
        ig, rig = ours.metrics["integrity"], ref.metrics["integrity"]
        integrity.validate_integrity(ig)
        ref_integrity.validate_integrity(ig)
        assert ig["all_checks_passed"] is True
        # the same checks and the same sampled replays as the reference
        for k in ("mode", "checks", "per_check", "all_checks_passed"):
            assert ig[k] == rig[k], k
        for k in ("planned", "run", "passed", "mismatches", "recomputes"):
            assert ig["ghost"][k] == rig["ghost"][k], k
        assert "robustness" not in ours.metrics

    def test_csr_input_runs_the_reference_s_checks(self, small_case,
                                                   monkeypatch):
        """From CSR the ladder's compacted windows are checked and
        replayed as the reference checks and replays them."""
        import scipy.sparse as sp

        data, labels = small_case
        monkeypatch.setenv("SCC_INTEGRITY", "audit")
        csr = sp.csr_matrix(data)
        ig = _run_port(csr, labels).metrics["integrity"]
        rig = _run_ref(csr, labels).metrics["integrity"]
        assert ig["all_checks_passed"] is True
        assert ig["per_check"] == rig["per_check"]
        for k in ("planned", "run", "passed", "mismatches"):
            assert ig["ghost"][k] == rig["ghost"][k], k

    @pytest.mark.parametrize("site,mode", [
        ("wilcox_bucket_out", "signflip"),
        ("wilcox_bucket_out", "scale"),
        ("bh_logq", "signflip"),
        ("embed_scores", "scale"),
    ])
    def test_refine_site_detected_recovered_identical(
        self, tmp_path, small_case, clean, monkeypatch, site, mode,
    ):
        data, labels = small_case
        clean_bits, _, _ = clean
        monkeypatch.setenv("SCC_INTEGRITY", "enforce")
        _plan(tmp_path, [{"site": site, "class": "corruption",
                          "mode": mode}], monkeypatch)
        res = _run_port(data, labels)
        ref = _run_ref(data, labels)
        ig = res.metrics["integrity"]
        assert _detected_by(ig), "the corruption must be detected"
        assert _detected_by(ig) == _detected_by(ref.metrics["integrity"])
        rb = res.metrics["robustness"]
        assert any(r["error_class"] == "silent_corruption"
                   and r["recovered"] for r in rb["retries"])
        assert ig["ghost"]["recomputes"] >= 1
        assert _bits(res) == clean_bits
        integrity.validate_integrity(ig)
        validate_robustness(rb)

    def test_landmark_assign_site(self, tmp_path, monkeypatch):
        from scconsensus_tpu.ops.pooling import landmark_pool as ref_pool
        from scconsensus_tpu.robust import retry as ref_retry
        from scconsensus_tpu_torch.ops.pooling import landmark_pool

        monkeypatch.setenv("SCC_INTEGRITY", "enforce")
        x = np.random.default_rng(1).normal(size=(2000, 6)).astype(
            np.float32)
        kw = dict(n_landmarks=16, sketch=512, seed=3)
        clean_cent, clean_assign, _ = landmark_pool(x, device="cpu", **kw)
        _plan(tmp_path, [{"site": "landmark_assign", "class": "corruption"}],
              monkeypatch)
        integrity.begin_run()
        cent, assign, _ = robust_retry.call(
            lambda: landmark_pool(x, device="cpu", **kw), site="stage:tree")
        np.testing.assert_array_equal(assign, clean_assign)
        np.testing.assert_array_equal(cent, clean_cent)
        assert any(r["error_class"] == "silent_corruption" and r["recovered"]
                   for r in robust_record.current_run().retries)
        ref_integrity.begin_run()
        ref_retry.call(lambda: ref_pool(x, **kw), site="stage:tree")
        assert _detected_by(integrity.section()) == \
            _detected_by(ref_integrity.section()) == {"replay_landmark_d2"}

    def test_contingency_site(self, tmp_path, monkeypatch):
        from scconsensus_tpu.consensus.contingency import (
            contingency_table as ref_table,
        )
        from scconsensus_tpu.robust import retry as ref_retry
        from scconsensus_tpu_torch.consensus.contingency import (
            contingency_table,
        )

        monkeypatch.setenv("SCC_INTEGRITY", "enforce")
        l1 = ["a"] * 5 + ["b"] * 7
        l2 = ["x"] * 4 + ["y"] * 8
        clean = contingency_table(l1, l2)
        _plan(tmp_path, [{"site": "contingency_table",
                          "class": "corruption"}], monkeypatch)
        integrity.begin_run()
        out = robust_retry.call(lambda: contingency_table(l1, l2),
                                site="consensus")
        np.testing.assert_array_equal(out.matrix, clean.matrix)
        assert any(r["error_class"] == "silent_corruption" and r["recovered"]
                   for r in robust_record.current_run().retries)
        ref_integrity.begin_run()
        ref_retry.call(lambda: ref_table(l1, l2), site="consensus")
        assert _detected_by(integrity.section()) == \
            _detected_by(ref_integrity.section()) == {"contingency_sums"}

    def test_serve_classify_site(self, tmp_path, monkeypatch):
        """A corrupted device classify is caught by the host-mirror replay
        and recomputed in the batch: the response is ok with the model's
        own labels."""
        from scconsensus_tpu_torch.serve.driver import ServeConfig
        from scconsensus_tpu_torch.serve.soak import (
            build_demo_model,
            make_requests,
        )

        model = build_demo_model(str(tmp_path / "model"), seed=7,
                                 device="cpu")
        monkeypatch.setenv("SCC_INTEGRITY", "enforce")
        _plan(tmp_path, [{"site": "serve_classify", "class": "corruption"}],
              monkeypatch)
        integrity.begin_run()
        x = make_requests(1, 12, 7)[0]
        cfg = ServeConfig(max_batch_cells=256, queue_capacity=32,
                          batch_window_s=0.001, default_deadline_s=10.0,
                          breaker_threshold=3, breaker_cooldown_s=0.2,
                          drift_quarantine_frac=0.5)
        with port.ConsensusServer(model, cfg, device="cpu") as srv:
            resp = srv.classify(x, timeout=30.0)
        assert resp.outcome == "ok" and not resp.degraded
        np.testing.assert_array_equal(resp.labels, model.classify_host(x)[0])
        assert _detected_by(integrity.section()) == {"replay_classify_d2"}

    def test_serve_audit_replays_one_batch_in_64(self, tmp_path,
                                                 monkeypatch):
        from scconsensus_tpu_torch.serve.soak import (
            build_demo_model,
            make_requests,
        )

        model = build_demo_model(str(tmp_path / "model"), seed=7,
                                 device="cpu")
        monkeypatch.setenv("SCC_INTEGRITY", "audit")
        integrity.begin_run()
        with port.ConsensusServer(model, device="cpu") as srv:
            for x in make_requests(3, 8, 7):
                srv.classify(x, timeout=30.0)
        sec = integrity.section()
        assert sec["mode"] == "audit" and sec["all_checks_passed"]
        assert sec["ghost"]["planned"] == sec["ghost"]["passed"] == 1

    def test_audit_mode_records_without_raising(
        self, tmp_path, small_case, monkeypatch
    ):
        data, labels = small_case
        monkeypatch.setenv("SCC_INTEGRITY", "audit")
        _plan(tmp_path, [{"site": "wilcox_bucket_out", "class": "corruption",
                          "mode": "signflip"}], monkeypatch)
        res = _run_port(data, labels)  # must not raise
        ig = res.metrics["integrity"]
        assert _detected_by(ig) == \
            _detected_by(_run_ref(data, labels).metrics["integrity"])
        assert ig["all_checks_passed"] is False
        assert ig["mode"] == "audit"
        # audit observes, enforce acts: no recovery ran
        assert not any(
            r["error_class"] == "silent_corruption"
            for r in (res.metrics.get("robustness") or {}).get(
                "retries", []))


# --------------------------------------------------------------------------
# the validated integrity section: claims must carry evidence
# --------------------------------------------------------------------------

def _good_section():
    return {
        "mode": "enforce",
        "checks": {"planned": 5, "run": 5, "passed": 4},
        "per_check": {
            "wilcox_conservation": {"planned": 3, "run": 3, "passed": 2},
            "bh_monotonic": {"planned": 2, "run": 2, "passed": 2},
        },
        "violations": [{"check": "wilcox_conservation",
                        "site": "wilcox_bucket", "magnitude": 9.0,
                        "tol": 0.51}],
        "ghost": {"planned": 2, "run": 2, "passed": 1,
                  "mismatches": [{"check": "replay_wilcox_logp",
                                  "site": "wilcox_bucket",
                                  "unit": "window:1024",
                                  "magnitude": 1.2, "tol": 0.05}],
                  "recomputes": 2},
        "all_checks_passed": False,
        "consumed_s": 0.01,
    }


def _unrun(sec):
    sec.update(checks={"planned": 9, "run": 7, "passed": 7},
               violations=[], all_checks_passed=True)
    sec["per_check"] = {}
    sec["ghost"] = {"planned": 0, "run": 0, "passed": 0,
                    "mismatches": [], "recomputes": 0}


def _contradicted(sec):
    sec.update(all_checks_passed=True)
    sec["checks"] = {"planned": 5, "run": 5, "passed": 4}


def _unnested(sec):
    sec["checks"] = {"planned": 5, "run": 5, "passed": 6}


def _fabricated(sec):
    sec["ghost"]["passed"] = 2  # run 2, passed 2, yet one mismatch


def _phantom(sec):
    sec["violations"] = []
    sec["checks"] = {"planned": 5, "run": 5, "passed": 5}
    sec["per_check"] = {}
    sec["ghost"] = {"planned": 2, "run": 2, "passed": 2,
                    "mismatches": [], "recomputes": 1}


def _bad_mode(sec):
    sec["mode"] = "sometimes"


class TestValidation:
    @pytest.mark.parametrize("pkg", ["port", "ref"])
    def test_good_section_validates(self, pkg):
        {"port": integrity, "ref": ref_integrity}[pkg].validate_integrity(
            _good_section())

    @pytest.mark.parametrize("breaker,match", [
        (_unrun, "checks_run < checks_planned"),
        (_contradicted, "contradicts"),
        (_unnested, "passed"),
        (_fabricated, "fabricated"),
        (_phantom, "phantom"),
        (_bad_mode, "mode"),
    ], ids=["all_checks_passed_needs_every_check_run",
            "all_checks_passed_contradicted_by_violations",
            "counters_must_nest", "fabricated_mismatches_rejected",
            "phantom_recompute_rejected", "unknown_mode_rejected"])
    def test_rejected_by_both_packages(self, breaker, match):
        sec = _good_section()
        breaker(sec)
        for mod in (integrity, ref_integrity):
            with pytest.raises(ValueError, match=match):
                mod.validate_integrity(sec)

    def test_off_mode_carries_no_section(self, small_case):
        data, labels = small_case
        res = _run_port(data, labels)
        assert "integrity" not in res.metrics
        assert integrity.section() is None
