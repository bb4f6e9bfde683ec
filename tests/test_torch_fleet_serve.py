"""The port's serving fleet against the reference's fleet tests
(``tests/test_serve_fleet.py``): wire front, replica pool, hot-swap under
wire load, the readonly ledger redirect, the reconsensus loop, the fleet
schema and the telemetry plane, on ``scconsensus_tpu_torch.serve`` with
every entry point on the CPU.

The reference's tests that time the machinery (the wire-overhead guard)
run on the card in ``chip_smoke.py``; its tests of tools (``tail_run``,
the chaos matrix) are not repeated. Labels are compared exactly: classify
is an argmin over landmarks that the gaussian atlas separates widely.
"""

import io
import json
import os
import stat
import threading

import http.client

import functools

import numpy as np
import pytest
import torch

from scconsensus_tpu_torch.robust import faults, record as robust_record
from scconsensus_tpu_torch.serve import metrics as serve_metrics
from scconsensus_tpu_torch.serve import driver as _driver
from scconsensus_tpu_torch.serve.driver import ServeConfig
from scconsensus_tpu_torch.serve.errors import (
    RequestInvalid,
    ServerClosed,
)
from scconsensus_tpu_torch.serve import model as _model
from scconsensus_tpu_torch.serve.fleet import pool as _pool
from scconsensus_tpu_torch.serve.fleet import reconsensus as _recon
from scconsensus_tpu_torch.serve.fleet import soak as _soak
from scconsensus_tpu_torch.serve.fleet.reconsensus import (
    read_quarantine_batch,
)
from scconsensus_tpu_torch.serve.fleet.soak import make_query_batches
from scconsensus_tpu_torch.serve.fleet.wire import OUTCOME_STATUS, WireFront
from scconsensus_tpu_torch.serve.metrics import validate_serving

torch.set_num_threads(2)

# every entry point that builds a replica or a model runs on the CPU
ConsensusServer = functools.partial(_driver.ConsensusServer, device="cpu")
ReplicaPool = functools.partial(_pool.ReplicaPool, device="cpu")
build_atlas_model = functools.partial(_soak.build_atlas_model, device="cpu")
run_fleet_soak = functools.partial(_soak.run_fleet_soak, device="cpu")
reconsensus_update = functools.partial(_recon.reconsensus_update,
                                       device="cpu")
run_reconsensus = functools.partial(_recon.run_reconsensus, device="cpu")
load_consensus_model = functools.partial(_model.load_consensus_model,
                                         device="cpu")

_GENES = 120


@pytest.fixture(autouse=True)
def _clean_fault_state(monkeypatch):
    monkeypatch.delenv("SCC_FAULT_PLAN", raising=False)
    monkeypatch.delenv("SCC_SERVE_LEDGER_DIR", raising=False)
    faults.reset()
    robust_record.begin_run()
    yield
    faults.reset()


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("fleet-model"))
    build_atlas_model(d, seed=7)
    return d


@pytest.fixture(scope="module")
def model(model_dir):
    return load_consensus_model(model_dir)


def _fast_cfg(**kw):
    base = dict(
        max_batch_cells=256, queue_capacity=32, batch_window_s=0.001,
        default_deadline_s=10.0, breaker_threshold=3,
        breaker_cooldown_s=0.2, drift_quarantine_frac=0.5,
    )
    base.update(kw)
    return ServeConfig(**base)


def _post(conn, body, ctype="application/json", headers=None,
          path="/classify"):
    h = {"Content-Type": ctype}
    h.update(headers or {})
    conn.request("POST", path, body=body, headers=h)
    r = conn.getresponse()
    return r, json.loads(r.read())


# --------------------------------------------------------------------------
# wire front: the outcome -> status-code contract
# --------------------------------------------------------------------------

class TestWireFront:
    def test_outcome_status_table_is_total(self):
        # every serving outcome maps to exactly one status code — a new
        # outcome without a wire mapping must fail HERE, not at 3am
        assert set(OUTCOME_STATUS) == set(serve_metrics.OUTCOMES)

    def test_json_roundtrip_matches_bare_classify(self, model):
        reqs = make_query_batches(4, 8, 7)
        pool = ReplicaPool(model, n_replicas=2, config=_fast_cfg())
        with pool, WireFront(pool) as front:
            conn = http.client.HTTPConnection("127.0.0.1", front.port,
                                              timeout=30)
            for x in reqs:
                r, doc = _post(conn, json.dumps({"cells": x.tolist()}))
                assert r.status == 200
                assert doc["outcome"] == "ok"
                assert doc["model_fp"] == model.fingerprint()
                lab, _ = model.classify(x)
                assert doc["labels"] == [int(v) for v in lab]
            conn.close()
        sec = front.serving_section()
        validate_serving(sec)
        assert sec["wire"]["requests"]["submitted"] == 4
        assert sec["wire"]["status_codes"] == {"200": 4}

    def test_npy_payload_same_labels(self, model):
        x = make_query_batches(1, 8, 7)[0]
        pool = ReplicaPool(model, n_replicas=1, config=_fast_cfg())
        with pool, WireFront(pool) as front:
            conn = http.client.HTTPConnection("127.0.0.1", front.port,
                                              timeout=30)
            buf = io.BytesIO()
            np.save(buf, x)
            r, doc = _post(conn, buf.getvalue(),
                           ctype="application/x-npy")
            conn.close()
        assert r.status == 200
        lab, _ = model.classify(x)
        assert doc["labels"] == [int(v) for v in lab]

    def test_quarantined_is_409(self, model):
        ood = make_query_batches(1, 8, 7, n_ood=1)[0]
        pool = ReplicaPool(model, n_replicas=1, config=_fast_cfg())
        with pool, WireFront(pool) as front:
            conn = http.client.HTTPConnection("127.0.0.1", front.port,
                                              timeout=30)
            r, doc = _post(conn, json.dumps({"cells": ood.tolist()}))
            conn.close()
        assert r.status == 409
        assert doc["outcome"] == "quarantined"
        assert doc["labels"] is None

    def test_invalid_bodies_are_422(self, model):
        pool = ReplicaPool(model, n_replicas=1, config=_fast_cfg())
        with pool, WireFront(pool) as front:
            conn = http.client.HTTPConnection("127.0.0.1", front.port,
                                              timeout=30)
            # wrong gene dimension
            r1, d1 = _post(conn, json.dumps({"cells": [[1.0, 2.0]]}))
            # unparseable JSON
            r2, d2 = _post(conn, b"{nope")
            # no cells key
            r3, d3 = _post(conn, json.dumps({"rows": []}))
            # unknown model fingerprint
            x = make_query_batches(1, 4, 7)[0]
            r4, d4 = _post(conn, json.dumps(
                {"cells": x.tolist(), "model_fp": "no-such-model"}
            ))
            # non-numeric deadline: a malformed REQUEST, never a 500
            r5, d5 = _post(conn, json.dumps(
                {"cells": x.tolist(), "deadline_s": "soon"}
            ))
            conn.close()
        for r, d in ((r1, d1), (r2, d2), (r3, d3), (r4, d4), (r5, d5)):
            assert r.status == 422
            assert d["outcome"] == "rejected_invalid"
        sec = front.serving_section()
        validate_serving(sec)
        assert sec["wire"]["requests"]["rejected_invalid"] == 5
        assert sec["wire"]["status_codes"]["422"] == 5

    def test_queue_full_is_429_with_retry_after(self, model, monkeypatch,
                                                tmp_path):
        plan = tmp_path / "stall.json"
        plan.write_text(json.dumps({"faults": [
            {"site": "serve_batch", "class": "stall", "stall_s": 0.5,
             "times": 4}
        ]}))
        monkeypatch.setenv("SCC_FAULT_PLAN", str(plan))
        faults.reset()
        pool = ReplicaPool(model, n_replicas=1, config=_fast_cfg(
            queue_capacity=2, max_batch_cells=8, default_deadline_s=30.0,
        ))
        reqs = make_query_batches(10, 8, 7)
        with pool, WireFront(pool) as front:
            results = [None] * len(reqs)

            def _send(i):
                c = http.client.HTTPConnection("127.0.0.1", front.port,
                                               timeout=60)
                r, doc = _post(c, json.dumps(
                    {"cells": reqs[i].tolist()}
                ))
                results[i] = (r.status, doc,
                              r.getheader("Retry-After"))
                c.close()

            ts = [threading.Thread(target=_send, args=(i,))
                  for i in range(len(reqs))]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=120.0)
        rejected = [r for r in results if r and r[0] == 429]
        assert rejected, "queue never filled through the wire"
        for status, doc, retry_after in rejected:
            assert doc["outcome"] == "rejected_queue"
            assert doc["retry_after_s"] > 0
            assert retry_after is not None and int(retry_after) >= 1
        sec = front.serving_section()
        validate_serving(sec)
        assert (sec["wire"]["requests"]["rejected_queue"]
                == len(rejected))

    def test_deadline_exceeded_is_504(self, model, monkeypatch,
                                      tmp_path):
        plan = tmp_path / "stall.json"
        plan.write_text(json.dumps({"faults": [
            {"site": "serve_batch", "class": "stall", "stall_s": 0.4}
        ]}))
        monkeypatch.setenv("SCC_FAULT_PLAN", str(plan))
        faults.reset()
        x = make_query_batches(1, 8, 7)[0]
        pool = ReplicaPool(model, n_replicas=1, config=_fast_cfg())
        with pool, WireFront(pool) as front:
            conn = http.client.HTTPConnection("127.0.0.1", front.port,
                                              timeout=60)
            r, doc = _post(conn, json.dumps(
                {"cells": x.tolist(), "deadline_s": 0.1}
            ))
            conn.close()
        assert r.status == 504
        assert doc["outcome"] == "deadline_exceeded"
        assert doc["late_by_s"] > 0

    def test_closed_fleet_is_503_and_healthz_flips(self, model):
        pool = ReplicaPool(model, n_replicas=1, config=_fast_cfg())
        front = WireFront(pool)
        pool.start()
        front.start()
        try:
            conn = http.client.HTTPConnection("127.0.0.1", front.port,
                                              timeout=30)
            conn.request("GET", "/healthz")
            h1 = conn.getresponse()
            h1_doc = json.loads(h1.read())
            assert h1.status == 200 and h1_doc["status"] == "ok"
            pool.stop()
            x = make_query_batches(1, 4, 7)[0]
            r, doc = _post(conn, json.dumps({"cells": x.tolist()}))
            assert r.status == 503
            assert doc["outcome"] == "rejected_closed"
            conn.request("GET", "/healthz")
            h2 = conn.getresponse()
            h2_doc = json.loads(h2.read())
            assert h2.status == 503 and h2_doc["status"] == "unhealthy"
            conn.close()
        finally:
            front.stop()
            pool.stop()
        sec = front.serving_section()
        validate_serving(sec)
        assert sec["wire"]["status_codes"].get("503") == 1
        # the refusal is attributed to the POOL boundary, not a replica
        assert sec["fleet"]["submitted_by_owner"]["pool"] == 1

    def test_metrics_endpoint_serves_fleet_panel(self, model):
        # round 20: /metrics is OpenMetrics text exposition; the JSON
        # live summary (fleet panel included) moved to /metrics.json
        from scconsensus_tpu_torch.serve import slo as serve_slo

        pool = ReplicaPool(model, n_replicas=2, config=_fast_cfg())
        with pool, WireFront(pool) as front:
            conn = http.client.HTTPConnection("127.0.0.1", front.port,
                                              timeout=30)
            x = make_query_batches(1, 4, 7)[0]
            _post(conn, json.dumps({"cells": x.tolist()}))
            conn.request("GET", "/metrics")
            m = conn.getresponse()
            ctype = m.getheader("Content-Type") or ""
            text = m.read().decode()
            conn.request("GET", "/metrics.json")
            mj = conn.getresponse()
            doc = json.loads(mj.read())
            conn.close()
        assert m.status == 200
        assert ctype.startswith("application/openmetrics-text")
        parsed = serve_slo.parse_openmetrics(text)
        key = ("scc_requests_total",
               (("outcome", "ok"), ("replica", "fleet")))
        assert parsed["samples"][key] == 1.0
        assert mj.status == 200
        assert doc["fleet"]["active_fp"] == model.fingerprint()[:8]
        assert len(doc["fleet"]["replicas"]) == 2

    def test_wire_section_rides_run_record(self, model):
        from scconsensus_tpu_torch.obs.export import (
            build_run_record,
            validate_run_record,
        )

        pool = ReplicaPool(model, n_replicas=1, config=_fast_cfg())
        with pool, WireFront(pool) as front:
            conn = http.client.HTTPConnection("127.0.0.1", front.port,
                                              timeout=30)
            for x in make_query_batches(3, 4, 7):
                _post(conn, json.dumps({"cells": x.tolist()}))
            conn.close()
            sec = front.serving_section()
        rec = build_run_record(metric="fleet wire test", value=1.0,
                               unit="x", serving=sec)
        validate_run_record(rec)


# --------------------------------------------------------------------------
# replica pool: routing, multi-model, swap semantics
# --------------------------------------------------------------------------

class TestReplicaPool:
    def test_least_depth_routing_spreads_load(self, model):
        pool = ReplicaPool(model, n_replicas=3, config=_fast_cfg(
            max_batch_cells=8, batch_window_s=0.0,
        ))
        reqs = make_query_batches(18, 8, 7)
        with pool:
            handles = [pool.submit(x) for x in reqs]
            for h in handles:
                h.result(timeout=60.0)
            sec = pool.serving_section()
        validate_serving(sec)
        busy = [r for r in sec["fleet"]["per_replica"]
                if r["submitted"] > 0]
        assert len(busy) >= 2, (
            "least-depth routing pinned every request to one replica"
        )
        assert (sum(r["submitted"] for r in sec["fleet"]["per_replica"])
                == 18)

    def test_closed_pool_refuses_typed_and_accounted(self, model):
        pool = ReplicaPool(model, n_replicas=1, config=_fast_cfg())
        pool.start()
        pool.stop()
        with pytest.raises(ServerClosed):
            pool.submit(make_query_batches(1, 4, 7)[0])
        sec = pool.serving_section()
        validate_serving(sec)
        assert sec["requests"]["rejected_closed"] == 1
        assert sec["fleet"]["submitted_by_owner"]["pool"] == 1

    def test_unknown_model_fp_refused_typed(self, model):
        pool = ReplicaPool(model, n_replicas=1, config=_fast_cfg())
        with pool:
            with pytest.raises(RequestInvalid, match="no model"):
                pool.submit(make_query_batches(1, 4, 7)[0],
                            model_fp="missing")

    def test_multi_model_routing_by_fingerprint(self, model, tmp_path):
        v2_dir = str(tmp_path / "tissue2")
        build_atlas_model(v2_dir, seed=7, landmark_seed=99)
        pool = ReplicaPool(model, n_replicas=1, config=_fast_cfg())
        with pool:
            fp2 = pool.add_model(v2_dir, n_replicas=1)
            assert fp2 != pool.active_fingerprint()
            x = make_query_batches(1, 8, 7)[0]
            r_default = pool.classify(x, timeout=30.0)
            r_routed = pool.classify(x, model_fp=fp2, timeout=30.0)
            assert r_default.model_fp == model.fingerprint()
            assert r_routed.model_fp == fp2
            # the active model cannot be retired out from under traffic
            with pytest.raises(ValueError, match="active"):
                pool.retire_model(pool.active_fingerprint())
            pool.retire_model(fp2)
            assert pool.fingerprints() == [model.fingerprint()]
            sec = pool.serving_section()
            validate_serving(sec)
            # the retired tissue's request survives in pool accounting
            assert sec["fleet"]["submitted_by_owner"]["retired"] == 1
            assert sec["requests"]["submitted"] == 2

    def test_hot_swap_promotes_an_added_model_group(self, model,
                                                    tmp_path):
        # hot_swap to a fingerprint already routed via add_model must
        # PROMOTE the running group — not overwrite it with a twin,
        # leaking live workers and their accounting
        v2_dir = str(tmp_path / "v2")
        build_atlas_model(v2_dir, seed=7, landmark_seed=77)
        pool = ReplicaPool(model, n_replicas=1, config=_fast_cfg())
        with pool:
            fp2 = pool.add_model(v2_dir, n_replicas=1)
            x = make_query_batches(1, 8, 7)[0]
            pool.classify(x, model_fp=fp2, timeout=30.0)
            before = [id(r.server) for r in pool.replicas()
                      if r.model_fp == fp2]
            assert pool.hot_swap(v2_dir) == fp2
            after = [id(r.server) for r in pool.replicas()
                     if r.model_fp == fp2]
            assert after == before  # the SAME live group, promoted
            assert pool.active_fingerprint() == fp2
            sec = pool.serving_section()
            validate_serving(sec)
            # the promoted group's pre-promotion request is still owned
            # by a LIVE replica — nothing leaked, nothing lost
            assert sec["fleet"]["submitted_by_owner"]["replicas"] == 1

    def test_hot_swap_same_fingerprint_is_noop(self, model):
        pool = ReplicaPool(model, n_replicas=2, config=_fast_cfg())
        with pool:
            before = [id(r.server) for r in pool.replicas()]
            assert pool.hot_swap(model) == model.fingerprint()
            assert [id(r.server) for r in pool.replicas()] == before
            sec = pool.serving_section()
        assert sec["fleet"]["swaps"] == []

    def test_hot_swap_retires_old_replicas_and_keeps_evidence(
            self, model, tmp_path):
        v2_dir = str(tmp_path / "v2")
        build_atlas_model(v2_dir, seed=7, landmark_seed=1000)
        pool = ReplicaPool(model, n_replicas=2, config=_fast_cfg())
        reqs = make_query_batches(6, 8, 7)
        with pool:
            for x in reqs[:3]:
                pool.classify(x, timeout=30.0)
            fp2 = pool.hot_swap(v2_dir)
            assert pool.active_fingerprint() == fp2
            assert pool.fingerprints() == [fp2]
            for x in reqs[3:]:
                assert pool.classify(x, timeout=30.0).model_fp == fp2
            sec = pool.serving_section()
        validate_serving(sec)
        owners = sec["fleet"]["submitted_by_owner"]
        assert owners["retired"] == 3  # pre-swap traffic banked
        assert owners["replicas"] == 3
        assert sec["requests"]["submitted"] == 6
        assert len(sec["fleet"]["swaps"]) == 1
        sw = sec["fleet"]["swaps"][0]
        assert sw["from_fp"] == model.fingerprint()
        assert sw["to_fp"] == fp2
        assert sw["drained_requests"] == 3


# --------------------------------------------------------------------------
# e2e: hot-swap under concurrent wire load (acceptance criterion)
# --------------------------------------------------------------------------

class TestSwapUnderWireLoad:
    def test_swap_under_concurrent_wire_load_zero_loss_v2_only(
            self, tmp_path):
        summary = run_fleet_soak(
            str(tmp_path / "fleet"), n_requests=30, cells_per=8,
            seed=7, replicas=3, swap_after=10, fresh=True,
        )
        assert summary["ok"], summary["outcome_counts"]
        # zero dropped accounting across the swap: every wire request
        # resolved as exactly one typed outcome and the validated
        # section agreed
        assert summary["resolved"] == summary["requests"] == 30
        assert summary["accounting_ok"] is True
        # the swap actually happened mid-traffic...
        assert summary["swapped"] and summary["post_swap_responses"] > 0
        # ...every response came from exactly one KNOWN model...
        assert set(summary["fps_seen"]) <= {summary["fp_v1"],
                                            summary["fp_v2"]}
        # ...and post-swap requests classified against the new model ONLY
        assert summary["post_swap_pure"] is True
        sv = summary["record"]["serving"]
        assert len(sv["fleet"]["swaps"]) == 1
        assert sv["fleet"]["active_fp"] == summary["fp_v2"]
        assert sv["wire"]["requests"]["submitted"] == 30

    def test_replay_across_replicas_identical_labels(self, tmp_path):
        s1 = run_fleet_soak(str(tmp_path / "fleet"), n_requests=10,
                            cells_per=8, seed=7, replicas=1, fresh=True)
        s3 = run_fleet_soak(str(tmp_path / "fleet"), n_requests=10,
                            cells_per=8, seed=7, replicas=3)
        assert s1["ok"] and s3["ok"]
        assert s1["fp_v1"] == s3["fp_v1"]
        # routing must never change an answer
        assert s1["labels_sha"] == s3["labels_sha"]


# --------------------------------------------------------------------------
# satellite 1: readonly model dir + SCC_SERVE_LEDGER_DIR
# --------------------------------------------------------------------------

class TestReadonlyLedgerRedirect:
    def test_readonly_model_server_accumulates_drift_evidence(
            self, tmp_path, monkeypatch):
        mdir = str(tmp_path / "frozen")
        build_atlas_model(mdir, seed=7)
        ldir = str(tmp_path / "sidecar")
        mode = stat.S_IRUSR | stat.S_IXUSR
        os.chmod(mdir, mode)  # a genuinely read-only model mount
        try:
            monkeypatch.setenv("SCC_SERVE_LEDGER_DIR", ldir)
            srv = ConsensusServer(mdir, _fast_cfg(), readonly=True)
            with srv:
                ood = make_query_batches(2, 8, 7, n_ood=2)
                for x in ood:
                    resp = srv.classify(x, timeout=30.0)
                    assert resp.outcome == "quarantined"
            # the r15 gap, closed: the frozen dir was never written, yet
            # the drift evidence exists — ledger lines AND the cell
            # payloads the reconsensus loop needs
            ledger = os.path.join(ldir, "QUARANTINE_LEDGER.jsonl")
            assert os.path.exists(ledger)
            entries = [json.loads(ln) for ln in open(ledger)
                       if ln.strip()]
            assert len(entries) == 2
            assert all(e.get("cells_file") for e in entries)
            cells, got = read_quarantine_batch(ldir)
            assert cells.shape == (16, _GENES)
            assert len(got) == 2
        finally:
            os.chmod(mdir, mode | stat.S_IWUSR)

    def test_without_ledger_dir_readonly_server_has_no_ledger(
            self, tmp_path):
        mdir = str(tmp_path / "frozen")
        build_atlas_model(mdir, seed=7)
        srv = ConsensusServer(mdir, _fast_cfg(), readonly=True)
        assert srv.quarantine_path is None  # the documented r15 gap

    def test_ledger_cells_capped(self, tmp_path, monkeypatch):
        ldir = str(tmp_path / "sidecar")
        mdir = str(tmp_path / "m")
        build_atlas_model(mdir, seed=7)
        monkeypatch.setenv("SCC_SERVE_LEDGER_DIR", ldir)
        monkeypatch.setenv("SCC_SERVE_LEDGER_MAX_CELLS", "12")
        with ConsensusServer(mdir, _fast_cfg()) as srv:
            for x in make_query_batches(3, 8, 7, n_ood=3):
                srv.classify(x, timeout=30.0)
        entries = [json.loads(ln) for ln in open(
            os.path.join(ldir, "QUARANTINE_LEDGER.jsonl"))
            if ln.strip()]
        # every quarantine ledgered, but only the first payload fit the
        # 12-cell cap (8 saved, next 8 would overflow)
        assert len(entries) == 3
        assert sum(1 for e in entries if e.get("cells_file")) == 1


# --------------------------------------------------------------------------
# reconsensus loop
# --------------------------------------------------------------------------

def _planted_drift_requests(n_per=6, cells_per=16, seed=0):
    """Two far-away planted clusters the frozen atlas has never seen."""
    rng = np.random.default_rng(seed)
    d = [(40.0 + rng.normal(0, 0.6, size=(cells_per, _GENES))
          ).astype(np.float32) for _ in range(n_per)]
    e = [(-40.0 + rng.normal(0, 0.6, size=(cells_per, _GENES))
          ).astype(np.float32) for _ in range(n_per)]
    return d, e


class TestReconsensus:
    def test_insufficient_evidence_reports_reason(self, model,
                                                  tmp_path):
        out = run_reconsensus(str(tmp_path / "ledger"),
                              str(tmp_path / "out"), model=model,
                              min_cells=64)
        assert out["updated"] is False
        assert "floor" in out["reason"]

    def test_update_requires_nonconforming_cells(self, model):
        # in-distribution cells: everything conforms, nothing to refine
        cells = np.concatenate(make_query_batches(4, 16, 7))
        built, summary = reconsensus_update(model, cells)
        assert built is None
        assert summary["n_nonconforming"] < summary["n_batch"] // 2
        assert "reason" in summary

    def test_update_is_strictly_additive(self, model):
        d, e = _planted_drift_requests()
        cells = np.concatenate(d + e)
        built, summary = reconsensus_update(model, cells, seed=3)
        assert built is not None and summary["updated"]
        arrays, meta = built
        k_old = model.k
        # old decision surface untouched: centroids, labels, counts are
        # a byte-identical prefix, the calibration only widened
        np.testing.assert_array_equal(
            arrays["centroids"][:k_old], model.centroids
        )
        np.testing.assert_array_equal(
            arrays["centroid_labels"][:k_old], model.centroid_labels
        )
        np.testing.assert_array_equal(
            arrays["centroid_counts"][:k_old], model.centroid_counts
        )
        assert arrays["centroids"].shape[0] > k_old
        assert meta["drift_threshold"] >= model.drift_threshold
        assert np.all(arrays["calib_q"] >= model.calib_q)
        assert summary["n_new_clusters"] >= 2
        new_labels = set(meta["label_values"]) - set(
            model.meta["label_values"])
        assert new_labels  # numbered past the existing label space
        assert min(new_labels) > max(model.meta["label_values"])

    def test_e2e_planted_drift_quarantine_reconsensus_swap_ari(
            self, tmp_path, monkeypatch):
        """The acceptance loop: planted-drift cells are quarantined, the
        loop produces and hot-swaps an updated model, and the same cells
        then classify non-quarantined with ARI vs planted labels
        pinned."""
        from scconsensus_tpu_torch.obs.regress import adjusted_rand_index

        mdir = str(tmp_path / "model_v1")
        ldir = str(tmp_path / "ledger")
        odir = str(tmp_path / "model_v2")
        build_atlas_model(mdir, seed=7)
        d, e = _planted_drift_requests()
        planted = [(x, 1) for x in d] + [(x, 2) for x in e]
        pool = ReplicaPool(mdir, n_replicas=2,
                           config=_fast_cfg(ledger_dir=ldir))
        with pool:
            fp1 = pool.active_fingerprint()
            for x, _ in planted:
                assert pool.classify(
                    x, timeout=30.0).outcome == "quarantined"
            summary = run_reconsensus(ldir, odir, pool=pool,
                                      min_cells=64, seed=3)
            assert summary["updated"], summary
            fp2 = pool.active_fingerprint()
            assert fp2 == summary["swapped_fp"] != fp1
            # the consumed ledger moved aside: a second loop turn finds
            # no fresh evidence instead of double-counting this batch
            again = run_reconsensus(ldir, str(tmp_path / "m3"),
                                    pool=pool, min_cells=64)
            assert again["updated"] is False
            # replay: served, labeled, against the NEW model only
            served_maj, truth = [], []
            for x, lab in planted:
                resp = pool.classify(x, timeout=30.0)
                assert resp.outcome == "ok"
                assert resp.model_fp == fp2
                served_maj.append(int(np.bincount(resp.labels).argmax()))
                truth.append(lab)
            sec = pool.serving_section()
        validate_serving(sec)
        assert adjusted_rand_index(served_maj, truth) >= 0.99
        # the new clusters are new LABELS, disjoint from the atlas's
        assert set(served_maj).isdisjoint(
            set(load_consensus_model(mdir).meta["label_values"]))
        # and the swapped artifact carries its lineage
        m2 = load_consensus_model(odir)
        assert m2.meta["reconsensus"]["parent_fp"] == fp1
        assert m2.meta["reconsensus"]["round"] == 1

    def test_reconsensus_model_survives_reload(self, model, tmp_path):
        # the updated artifact rides the same sha256 path as any model
        d, e = _planted_drift_requests()
        built, _ = reconsensus_update(
            model, np.concatenate(d + e), seed=3)
        arrays, meta = built
        from scconsensus_tpu_torch.serve.model import MODEL_STAGE
        from scconsensus_tpu_torch.utils.artifacts import ArtifactStore

        out = str(tmp_path / "m2")
        ArtifactStore(out).save(MODEL_STAGE, arrays, meta)
        m2 = load_consensus_model(out)
        assert m2.k == arrays["centroids"].shape[0]
        assert m2.drift_threshold == meta["drift_threshold"]

    def test_no_update_restores_consumed_evidence(self, model,
                                                  tmp_path,
                                                  monkeypatch):
        # the loop snapshots the ledger BEFORE processing; when no
        # update lands, the evidence must flow back and keep
        # accumulating — not vanish into an unread *.consumed-N
        mdir = str(tmp_path / "m")
        build_atlas_model(mdir, seed=7)
        ldir = str(tmp_path / "ledger")
        with ConsensusServer(mdir, _fast_cfg(ledger_dir=ldir)) as srv:
            for x in make_query_batches(2, 8, 7, n_ood=2):
                assert srv.classify(
                    x, timeout=30.0).outcome == "quarantined"
        out = run_reconsensus(ldir, str(tmp_path / "out"), model=model,
                              min_cells=1000)  # floor unreachable
        assert out["updated"] is False
        cells, entries = read_quarantine_batch(ldir)
        assert cells.shape[0] == 16 and len(entries) == 2
        # evidence written DURING a (simulated) loop turn survives too:
        # the snapshot happened first, so a fresh ledger accumulated
        with ConsensusServer(mdir, _fast_cfg(ledger_dir=ldir)) as srv:
            srv.classify(make_query_batches(1, 8, 7, n_ood=1)[0],
                         timeout=30.0)
        cells2, entries2 = read_quarantine_batch(ldir)
        assert cells2.shape[0] == 24 and len(entries2) == 3

    def test_read_quarantine_batch_skips_unreadable(self, tmp_path):
        ldir = str(tmp_path / "ledger")
        os.makedirs(os.path.join(ldir, "quarantine_cells"))
        good = np.ones((3, 5), np.float32)
        np.save(os.path.join(ldir, "quarantine_cells", "a.npy"), good)
        with open(os.path.join(
                ldir, "quarantine_cells", "bad.npy"), "wb") as f:
            f.write(b"not an npy")
        with open(os.path.join(ldir, "QUARANTINE_LEDGER.jsonl"),
                  "w") as f:
            f.write(json.dumps({"req_id": 1, "n_cells": 3,
                                "cells_file": "quarantine_cells/a.npy"})
                    + "\n")
            f.write(json.dumps({"req_id": 2, "n_cells": 3,
                                "cells_file":
                                "quarantine_cells/bad.npy"}) + "\n")
            f.write(json.dumps({"req_id": 3, "n_cells": 4}) + "\n")
            f.write("{truncated\n")
        cells, entries = read_quarantine_batch(ldir)
        assert cells.shape == (3, 5)  # the one readable payload
        assert len(entries) == 3     # evidence lines all kept


# --------------------------------------------------------------------------
# validation: wire + fleet schema rules
# --------------------------------------------------------------------------

class TestFleetSchema:
    def _fleet_sec(self):
        st = serve_metrics.ServingStats(queue_capacity=8)
        st.note_submit(1)
        st.note_outcome("ok", 0.005)
        sec = st.section()
        sec["wire"] = {
            "requests": {"submitted": 1,
                         **{o: 0 for o in serve_metrics.OUTCOMES}},
            "status_codes": {"200": 1},
        }
        sec["wire"]["requests"]["ok"] = 1
        sec["fleet"] = {
            "replicas": 1,
            "live_replicas": 1,
            "active_fp": "abc123",
            "models": {"abc123": 1},
            "swaps": [],
            "submitted_by_owner": {"replicas": 1, "retired": 0,
                                   "pool": 0},
            "per_replica": [{"replica": 0, "model_fp": "abc123",
                             "submitted": 1, "ok": 1,
                             "breaker": "closed", "trips": 0,
                             "queue_depth_peak": 1, "p99_ms": 5.0}],
        }
        return sec

    def test_clean_fleet_section_validates(self):
        validate_serving(self._fleet_sec())

    def test_wire_accounting_violation_rejected(self):
        sec = self._fleet_sec()
        sec["wire"]["requests"]["submitted"] = 2
        with pytest.raises(ValueError, match="wire accounting"):
            validate_serving(sec)

    def test_wire_status_code_mismatch_rejected(self):
        sec = self._fleet_sec()
        sec["wire"]["status_codes"] = {"200": 2}
        with pytest.raises(ValueError, match="status-code"):
            validate_serving(sec)

    def test_owner_split_must_sum(self):
        sec = self._fleet_sec()
        sec["fleet"]["submitted_by_owner"]["pool"] = 5
        with pytest.raises(ValueError, match="ownership"):
            validate_serving(sec)

    def test_same_fp_swap_rejected(self):
        sec = self._fleet_sec()
        sec["fleet"]["swaps"] = [{"from_fp": "a", "to_fp": "a"}]
        with pytest.raises(ValueError, match="SAME"):
            validate_serving(sec)

    def test_per_replica_length_must_match(self):
        sec = self._fleet_sec()
        sec["fleet"]["live_replicas"] = 2
        with pytest.raises(ValueError, match="per_replica"):
            validate_serving(sec)

    def test_scale_stamps_validate(self):
        sec = self._fleet_sec()
        sec["fleet"]["scales"] = [
            {"from": 1, "to": 2, "ts": 1.0, "reason": "autoscale"},
            {"from": 2, "to": 1, "ts": 2.0,
             "drained_requests": 0},
        ]
        validate_serving(sec)

    def test_noop_scale_stamp_rejected(self):
        sec = self._fleet_sec()
        sec["fleet"]["scales"] = [{"from": 2, "to": 2, "ts": 1.0}]
        with pytest.raises(ValueError, match="SAME width"):
            validate_serving(sec)

    def test_scale_stamp_needs_int_widths_and_ts(self):
        sec = self._fleet_sec()
        sec["fleet"]["scales"] = [{"from": "1", "to": 2, "ts": 1.0}]
        with pytest.raises(ValueError, match="int from"):
            validate_serving(sec)
        sec["fleet"]["scales"] = [{"from": 1, "to": 2}]
        with pytest.raises(ValueError, match="ts must be a number"):
            validate_serving(sec)


# --------------------------------------------------------------------------
# the fleet's live feed, its gate keys and its ledger key
# --------------------------------------------------------------------------

class TestFleetFeeds:
    def test_serving_baselines_keyed_by_replica_count(self):
        from scconsensus_tpu_torch.obs.regress import serving_baselines

        hist = [
            {"serving": {"p50_ms": 4.0, "p99_ms": 10.0,
                         "throughput_rps": 100.0}},
            {"serving": {"p50_ms": 4.2, "p99_ms": 11.0,
                         "throughput_rps": 104.0, "replicas": 1}},
            {"serving": {"p50_ms": 2.0, "p99_ms": 6.0,
                         "throughput_rps": 390.0, "replicas": 4}},
        ]
        base = serving_baselines(hist)
        # unstamped entries key as r1 (the bare r15 driver)
        assert base["p99_ms@r1"]["n"] == 2
        assert base["p99_ms@r4"]["baseline_ms"] == 6.0
        assert base["throughput_rps@r4"]["baseline_ms"] == 390.0
        # the unkeyed single-driver series anchors ONLY on unstamped
        # entries: a fleet's pool-level tail must never drag the
        # baseline a non-fleet candidate gates against
        assert base["p99_ms"]["n"] == 1
        assert base["p99_ms"]["baseline_ms"] == 10.0

    def test_gate_fleet_throughput_regression(self):
        from scconsensus_tpu_torch.obs.regress import gate_record

        hist = [
            {"serving": {"p99_ms": 10.0, "throughput_rps": 100.0,
                         "replicas": 2}},
            {"serving": {"p99_ms": 10.4, "throughput_rps": 102.0,
                         "replicas": 2}},
            {"serving": {"p99_ms": 10.2, "throughput_rps": 101.0,
                         "replicas": 2}},
        ]
        cand = {
            "extra": {"config": "x", "platform": "cpu"},
            "serving": {
                "latency_ms": {"n": 50, "p50": 4.0, "p99": 10.1,
                               "max": 12.0},
                "throughput_rps": 40.0,
                "fleet": {"replicas": 2},
            },
        }
        verdict = gate_record(cand, hist)
        reg = verdict.serving_regressions
        assert not verdict.ok
        assert [s.metric for s in reg] == ["throughput_rps@r2"]
        assert reg[0].unit == "rps"
        # clean p99 at the same replica count gated, not regressed
        assert any(s.metric == "p99_ms@r2" and not s.regressed
                   for s in verdict.serving)

    def test_pool_feeds_live_summary(self, model):
        pool = ReplicaPool(model, n_replicas=2, config=_fast_cfg())
        with pool:
            pool.classify(make_query_batches(1, 8, 7)[0], timeout=30.0)
            live = serve_metrics.live_summary()
            assert live is not None
            assert live["ok"] == 1
            assert live["fleet"]["active_fp"] == model.fingerprint()[:8]
            assert len(live["fleet"]["replicas"]) == 2
        assert serve_metrics.live_summary() is None  # stop() detaches

    def test_ledger_ingest_stamps_replica_count(self, model, tmp_path):
        from scconsensus_tpu_torch.obs.export import build_run_record
        from scconsensus_tpu_torch.obs.ledger import Ledger

        pool = ReplicaPool(model, n_replicas=2, config=_fast_cfg())
        with pool:
            pool.classify(make_query_batches(1, 8, 7)[0], timeout=30.0)
            sec = pool.serving_section()
        rec = build_run_record(
            metric="fleet ledger test", value=1.0, unit="ms",
            extra={"config": "fleet-test", "platform": "cpu"},
            serving=sec,
        )
        entry = Ledger(str(tmp_path)).ingest(rec, source="test")
        assert entry["serving"]["replicas"] == 2


# --------------------------------------------------------------------------
# the telemetry plane through the fleet
# --------------------------------------------------------------------------

class TestTelemetryPlane:
    def test_client_trace_id_rides_the_whole_story(self, model,
                                                   tmp_path):
        # one supplied id: response header + body, the replica's
        # recent-trace ring, and the quarantine ledger row all carry it
        from scconsensus_tpu_torch.serve.fleet.wire import TRACE_HEADER

        tid = "cafe0001deadbeef"
        ood = make_query_batches(1, 8, 7, n_ood=1)[0]
        cfg = _fast_cfg(ledger_dir=str(tmp_path / "ledger"))
        pool = ReplicaPool(model, n_replicas=1, config=cfg)
        with pool, WireFront(pool) as front:
            conn = http.client.HTTPConnection("127.0.0.1", front.port,
                                              timeout=30)
            r, doc = _post(conn, json.dumps({"cells": ood.tolist()}),
                           headers={TRACE_HEADER: tid})
            conn.close()
            snap = pool.telemetry_snapshot()
        assert r.status == 409 and doc["outcome"] == "quarantined"
        assert r.getheader(TRACE_HEADER) == tid
        assert doc["trace_id"] == tid
        recent = [e for rep in snap["replicas"]
                  for e in rep["expo"]["recent"]]
        assert any(e["trace_id"] == tid for e in recent)
        ledger = tmp_path / "ledger" / "QUARANTINE_LEDGER.jsonl"
        rows = [json.loads(ln) for ln in
                ledger.read_text().splitlines()]
        assert any(row.get("trace_id") == tid for row in rows)

    def test_driver_mints_when_no_front_upstream(self, model):
        srv = ConsensusServer(model, _fast_cfg())
        with srv:
            x = make_query_batches(1, 4, 7)[0]
            resp = srv.submit(x).result(timeout=30)
        assert resp.outcome == "ok"
        assert resp.trace_id and len(resp.trace_id) == 16

    def test_trace_dark_mode_mints_nothing(self, model, monkeypatch):
        monkeypatch.setenv("SCC_OBS_TRACE", "0")
        srv = ConsensusServer(model, _fast_cfg())
        with srv:
            x = make_query_batches(1, 4, 7)[0]
            resp = srv.submit(x).result(timeout=30)
        assert resp.outcome == "ok"
        assert resp.trace_id is None

    def test_kill_replica_respawns_and_keeps_evidence(self, model):
        pool = ReplicaPool(model, n_replicas=2, config=_fast_cfg())
        with pool:
            x = make_query_batches(1, 4, 7)[0]
            assert pool.submit(x).result(timeout=30).outcome == "ok"
            before = {r.index for g in pool._groups.values() for r in g}
            kill = pool.kill_replica()
            after = {r.index for g in pool._groups.values() for r in g}
            # width restored with a FRESH replica index
            assert len(after) == len(before) == 2
            assert kill["respawned"] not in before
            assert kill["replica"] in before
            # the killed replica still serves... the fleet, not the dead
            assert pool.submit(x).result(timeout=30).outcome == "ok"
            sec = pool.serving_section()
        assert len(sec["fleet"]["kills"]) == 1
        # the killed replica's ok is banked: nothing lost to the kill
        assert sec["requests"]["ok"] == 2

    def test_kill_refused_requests_burn_into_the_fleet_slo(self, model):
        # a killed replica's banked refusals must keep burning the
        # fleet-level error budget (retired evidence merges)
        pool = ReplicaPool(model, n_replicas=1, config=_fast_cfg())
        with pool:
            rep = next(r for g in pool._groups.values() for r in g)
            rep.server.stats.note_outcome("rejected_closed",
                                          trace_id="t1")
            pool.kill_replica()
            slo = pool.slo_section()
        assert slo["availability"]["bad"] == 1
        # ...and the refusal burns a WINDOW too, not just availability:
        # the dead replica's tracker deltas merge into the fleet burn
        assert slo["worst_burn"] > 0
        from scconsensus_tpu_torch.serve.slo import validate_slo

        validate_slo(slo)

    def test_exposition_consistent_under_hot_swap(self, model,
                                                  tmp_path):
        # the torn-read fix: scrapes racing a hot-swap must always
        # parse, and each exposition's per-replica scopes must agree
        # with ONE snapshot (never half-v1 half-v2 replica tables)
        from scconsensus_tpu_torch.serve import slo as serve_slo

        v2_dir = str(tmp_path / "v2")
        build_atlas_model(v2_dir, seed=7, landmark_seed=4242)
        pool = ReplicaPool(model, n_replicas=2, config=_fast_cfg())
        with pool, WireFront(pool) as front:
            stop = threading.Event()
            bad: list = []

            def scrape():
                conn = http.client.HTTPConnection(
                    "127.0.0.1", front.port, timeout=30)
                while not stop.is_set():
                    try:
                        conn.request("GET", "/metrics")
                        text = conn.getresponse().read().decode()
                        serve_slo.parse_openmetrics(text)
                        conn.request("GET", "/metrics.json")
                        json.loads(conn.getresponse().read())
                    except Exception as e:  # noqa: BLE001
                        bad.append(repr(e))
                        return
                conn.close()

            t = threading.Thread(target=scrape, daemon=True)
            t.start()
            for _ in range(3):
                pool.hot_swap(v2_dir)
                pool.hot_swap(model)
            stop.set()
            t.join(timeout=30)
        assert not bad, bad

    def test_kill_soak_end_to_end_contract(self, tmp_path):
        # the in-process twin of the chaos plan: kill one replica under
        # load, zero lost requests, trace continuity on any retry, and
        # validated serving + slo sections on the record
        summary = run_fleet_soak(
            str(tmp_path), n_requests=12, cells_per=32, seed=7,
            replicas=2, kill_after=2, fresh=True, concurrency=4,
        )
        assert summary["ok"], summary.get("outcome_counts")
        assert summary["resolved"] == 12
        assert summary["kills"]
        assert summary["trace_continuity"] is not False
        assert summary["traced_responses"] == 12
        rec = summary["record"]
        assert "slo" in rec and "serving" in rec
        from scconsensus_tpu_torch.obs.export import validate_run_record

        validate_run_record(rec)

    def test_killed_replica_latency_stays_in_gated_p99(self, model):
        # a kill must lose zero LATENCY evidence: the dead replica's
        # slow samples keep anchoring the slo section's p99
        pool = ReplicaPool(model, n_replicas=1, config=_fast_cfg())
        with pool:
            rep = next(r for g in pool._groups.values() for r in g)
            for _ in range(4):
                rep.server.stats.note_outcome("ok", latency_s=5.0)
            pool.kill_replica()
            slo = pool.slo_section()
        assert slo["latency"]["p99_ms"] == pytest.approx(5000.0)
        assert slo["latency_hist"]["ok"]["count"] == 4

    def test_descending_burn_windows_still_validate(self, model,
                                                    monkeypatch):
        # burn_rates order must follow the DECLARED objectives order:
        # a descending SCC_SLO_WINDOWS_S must not break validation
        from scconsensus_tpu_torch.serve.slo import validate_slo

        monkeypatch.setenv("SCC_SLO_WINDOWS_S", "3600,300")
        pool = ReplicaPool(model, n_replicas=2, config=_fast_cfg())
        with pool:
            x = make_query_batches(1, 4, 7)[0]
            assert pool.submit(x).result(timeout=30).outcome == "ok"
            slo = pool.slo_section()
        validate_slo(slo)
        assert [b["window_s"] for b in slo["burn_rates"]] == [3600.0,
                                                             300.0]

    def test_json_body_trace_id_wins_over_minting(self, model):
        tid = "feedbead00000001"
        pool = ReplicaPool(model, n_replicas=1, config=_fast_cfg())
        with pool, WireFront(pool) as front:
            conn = http.client.HTTPConnection("127.0.0.1", front.port,
                                              timeout=30)
            x = make_query_batches(1, 4, 7)[0]
            r, doc = _post(conn, json.dumps({"cells": x.tolist(),
                                             "trace_id": tid}))
            conn.close()
        assert r.status == 200
        assert doc["trace_id"] == tid

    def test_malformed_client_trace_id_is_replaced(self, model):
        # a header value that is not id-shaped (CRLF, spaces, oversized)
        # must never be echoed into the response header or the ledger
        from scconsensus_tpu_torch.serve.fleet.wire import TRACE_HEADER

        pool = ReplicaPool(model, n_replicas=1, config=_fast_cfg())
        with pool, WireFront(pool) as front:
            conn = http.client.HTTPConnection("127.0.0.1", front.port,
                                              timeout=30)
            x = make_query_batches(1, 4, 7)[0]
            r, doc = _post(conn, json.dumps({
                "cells": x.tolist(), "trace_id": "evil id\nX-Bad: 1"
            }), headers={TRACE_HEADER: "also bad !!"})
            conn.close()
        assert r.status == 200
        tid = doc["trace_id"]
        assert tid and len(tid) == 16
        int(tid, 16)  # a freshly minted id, not the client garbage
