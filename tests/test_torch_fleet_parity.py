"""The port's serving fleet held against the reference's, package to package.

One model dir built by the reference's ``build_atlas_model`` is served by
both packages' pools (the port on the CPU); the pure pieces (the
autoscaler's ``decide``, the load generator's schedules and bodies, the
wire's status table) are pinned equal; the validators refuse what the
reference refuses with its messages, and the port's records pass the
reference's validator; the reconsensus update gives the same new clusters;
and the fleet's three fault sites fire as in the reference.

Labels and outcomes are compared exactly: classify is an argmin over
landmarks that the gaussian atlas separates widely, and both packages
read the same stored arrays.
"""

import copy
import http.client
import json
import os
import shutil

import numpy as np
import pytest
import torch

from scconsensus_tpu.obs import export as ref_export
from scconsensus_tpu.robust import faults as ref_faults
from scconsensus_tpu.serve import metrics as ref_metrics
from scconsensus_tpu.serve.fleet import autoscale as ref_autoscale
from scconsensus_tpu.serve.fleet import loadgen as ref_loadgen
from scconsensus_tpu.serve.fleet import pool as ref_pool
from scconsensus_tpu.serve.fleet import reconsensus as ref_recon
from scconsensus_tpu.serve.fleet import soak as ref_soak
from scconsensus_tpu.serve.fleet import wire as ref_wire
from scconsensus_tpu.serve.driver import ServeConfig as RefServeConfig
from scconsensus_tpu_torch.obs import export
from scconsensus_tpu_torch.obs.regress import adjusted_rand_index
from scconsensus_tpu_torch.robust import faults
from scconsensus_tpu_torch.serve import fleet, metrics
from scconsensus_tpu_torch.serve.driver import ServeConfig
from scconsensus_tpu_torch.serve.errors import ServerClosed
from scconsensus_tpu_torch.serve.fleet import autoscale, loadgen, pool, \
    reconsensus, soak, wire
from scconsensus_tpu_torch.serve.model import load_consensus_model

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _no_plan(monkeypatch):
    monkeypatch.delenv("SCC_FAULT_PLAN", raising=False)
    monkeypatch.delenv("SCC_SERVE_LEDGER_DIR", raising=False)
    faults.reset()
    ref_faults.reset()
    yield
    faults.reset()
    ref_faults.reset()


@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    """The reference's atlas model (120 genes, 4 clusters, 360 cells)."""
    d = str(tmp_path_factory.mktemp("ref-atlas") / "model_v1")
    ref_soak.build_atlas_model(d, seed=7)
    return d


def _cfg(cls, **kw):
    base = dict(max_batch_cells=256, queue_capacity=32,
                batch_window_s=0.001, default_deadline_s=10.0,
                breaker_threshold=3, breaker_cooldown_s=0.2,
                drift_quarantine_frac=0.5)
    base.update(kw)
    return cls(**base)


# --------------------------------------------------------------------------
# one model, two packages
# --------------------------------------------------------------------------

def test_the_surfaces_equal_the_reference():
    from scconsensus_tpu.serve import fleet as ref_fleet

    assert fleet.__all__ == ref_fleet.__all__
    for ours, ref in ((pool, ref_pool), (wire, ref_wire), (soak, ref_soak),
                      (reconsensus, ref_recon), (autoscale, ref_autoscale),
                      (loadgen, ref_loadgen), (metrics, ref_metrics)):
        assert ours.__all__ == ref.__all__, ours.__name__
    assert wire.OUTCOME_STATUS == ref_wire.OUTCOME_STATUS
    assert wire.TRACE_HEADER == ref_wire.TRACE_HEADER
    assert (loadgen.PROFILES, loadgen.ARRIVALS, loadgen.LATE_TOLERANCE_S,
            loadgen._SCENARIO_CELL_FACTOR) == (
        ref_loadgen.PROFILES, ref_loadgen.ARRIVALS,
        ref_loadgen.LATE_TOLERANCE_S, ref_loadgen._SCENARIO_CELL_FACTOR)
    assert (autoscale.ACTUATION_KINDS, autoscale.ACTUATION_LEDGER_NAME) == (
        ref_autoscale.ACTUATION_KINDS, ref_autoscale.ACTUATION_LEDGER_NAME)
    # the generator is the reference's, draw for draw
    for args in ((6, 16, 7, 120, 4, 2), (3, 64, 11, 2000, 12, 1)):
        for a, b in zip(soak.make_query_batches(*args),
                        ref_soak.make_query_batches(*args)):
            assert a.tobytes() == b.tobytes()
    for a, b in zip(soak._gaussian_atlas(50, 3, 90, 5),
                    ref_soak._gaussian_atlas(50, 3, 90, 5)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_a_reference_model_serves_the_same_answers(ref_dir):
    reqs = ref_soak.make_query_batches(6, 16, 7, n_ood=1)
    got = {}
    for name, P, cfg, kw in (
            ("ref", ref_pool.ReplicaPool, _cfg(RefServeConfig), {}),
            ("port", pool.ReplicaPool, _cfg(ServeConfig),
             {"device": "cpu"})):
        p = P(ref_dir, n_replicas=2, config=cfg, readonly=True, **kw)
        with p:
            fp = p.active_fingerprint()
            out = []
            for x in reqs:
                r = p.classify(x, timeout=30.0)
                out.append((r.outcome, None if r.labels is None
                            else [int(v) for v in r.labels], r.model_fp))
        got[name] = (fp, out)
    assert got["port"] == got["ref"]
    assert [o for o, _, _ in got["port"][1]] == ["ok"] * 5 + ["quarantined"]


@pytest.mark.parametrize("n_ood", [0, 2])
def test_the_fleet_soak_labels_sha_equals_the_reference(ref_dir, tmp_path,
                                                        n_ood):
    """At the soak's defaults (24 requests x 16 cells, 2 replicas): the
    reference's run, the port serving the reference's model, and the port
    serving its own build give one ``labels_sha``."""
    ref = ref_soak.run_fleet_soak(str(tmp_path / "ref"), replicas=2,
                                  n_ood=n_ood)
    shutil.copytree(ref_dir, str(tmp_path / "on-ref" / "model_v1"))
    on_ref = soak.run_fleet_soak(str(tmp_path / "on-ref"), replicas=2,
                                 n_ood=n_ood, device="cpu")
    own = soak.run_fleet_soak(str(tmp_path / "own"), replicas=2,
                              n_ood=n_ood, device="cpu")
    assert ref["ok"] and on_ref["ok"] and own["ok"]
    assert on_ref["fp_v1"] == ref["fp_v1"]
    assert ref["labels_sha"] == on_ref["labels_sha"] == own["labels_sha"]
    assert (ref["outcome_counts"] == on_ref["outcome_counts"]
            == own["outcome_counts"] == {"ok": 24 - n_ood,
                                         **({"quarantined": n_ood}
                                            if n_ood else {})})
    # the port's record passes both validators
    ref_export.validate_run_record(on_ref["record"])
    export.validate_run_record(on_ref["record"])


def test_the_port_build_matches_the_reference_build(ref_dir, tmp_path):
    """The port's ``build_atlas_model`` at the same seed: the same labels
    for every training cell, the same landmark count and label multiset,
    the PCA mean within 1e-5, and the three axes that separate the four
    clusters within 1e-3 after fixing their signs. The other five axes
    span within-cluster noise whose singular values lie within a few
    percent of each other: both packages' subspace iterations stop at
    another rotation of that subspace, which changes no label."""
    ours = soak.build_atlas_model(str(tmp_path / "m"), seed=7, device="cpu")
    ref = load_consensus_model(ref_dir, device="cpu")
    cells, truth, _ = ref_soak._gaussian_atlas(120, 4, 360, 7)
    lab_ours, _ = ours.classify(cells)
    lab_ref, _ = ref.classify(cells)
    np.testing.assert_array_equal(lab_ours, lab_ref)
    assert adjusted_rand_index(lab_ours, truth) == 1.0
    assert ours.k == ref.k
    assert sorted(ours.centroid_labels) == sorted(ref.centroid_labels)
    np.testing.assert_allclose(ours.pca_mean, ref.pca_mean, atol=1e-5)
    sv = np.linalg.svd(cells - cells.mean(0), compute_uv=False)
    assert sv[2] > 5 * sv[3]  # the cluster axes stand clear of the noise
    for j in range(3):
        a, b = ours.pca_components[j], ref.pca_components[j]
        np.testing.assert_allclose(a * np.sign(a @ b), b, atol=1e-3)


# --------------------------------------------------------------------------
# the pure pieces
# --------------------------------------------------------------------------

def _series():
    """Observation series (burn, queue) covering the policy's rules."""
    return {
        "burn-streak": [(3.0, 0.0)] * 6,
        "queue-streak-and-cooldown": [(0.0, 0.9)] * 10,
        "no-flap": [(3.0, 0.0), (0.0, 0.0)] * 8,
        "calm-scale-down": [(0.0, 0.9)] * 3 + [(0.0, 0.0)] * 14,
        "tighten-relax": [(7.0, 0.0), (3.0, 0.0), (0.5, 0.0), (7.0, 0.0)],
        "degraded-entry-exit": [(20.0, 0.0)] * 3 + [(0.5, 0.0)] * 7,
        "degrade-relapse": ([(20.0, 0.0)] * 3 + [(0.5, 0.0)] * 2
                            + [(5.0, 0.0)] + [(0.5, 0.0)] * 6),
        "bounds": [(50.0, 1.0)] * 20 + [(0.0, 0.0)] * 40,
    }


@pytest.mark.parametrize("name", sorted(_series()))
def test_decide_takes_the_reference_actions(name):
    series = _series()[name]
    kw = dict(min_replicas=1, max_replicas=3, up_ticks=2, down_ticks=3,
              cooldown_ticks=2, degrade_ticks=2, recover_ticks=3)
    runs = []
    for mod in (autoscale, ref_autoscale):
        policy = mod.AutoscalePolicy(**kw)
        state = mod.ControlState(target=1)
        log = []
        for i, (burn, queue) in enumerate(series):
            state, acts = mod.decide(
                state, mod.Observation(worst_burn=burn, p99_ms=1.5,
                                       queue_frac=queue, live_replicas=1),
                policy)
            log += [(i, a) for a in acts]
        runs.append((log, vars(state)))
    assert runs[0] == runs[1]
    assert runs[0][0] or name == "no-flap"
    if name == "no-flap":
        assert runs[0][0] == []


@pytest.mark.parametrize("arrival", ["poisson", "burst"])
@pytest.mark.parametrize("profile", ["steady", "diurnal", "spike", "ramp"])
@pytest.mark.parametrize("seed", [0, 7, 123])
def test_the_load_schedule_is_the_reference_schedule(seed, profile,
                                                     arrival):
    args = (profile, 10.0, 30.0, 2.0, seed)
    offsets = loadgen.arrival_offsets(*args, arrival=arrival)
    assert offsets == ref_loadgen.arrival_offsets(*args, arrival=arrival)
    mix = loadgen.resolve_mix(None)
    assert mix == ref_loadgen.resolve_mix(None)
    assert (loadgen.assign_scenarios(len(offsets), mix, seed)
            == ref_loadgen.assign_scenarios(len(offsets), mix, seed))
    ours = loadgen._build_request_bodies(offsets, mix, 8, 120, 4, seed)
    ref = ref_loadgen._build_request_bodies(offsets, mix, 8, 120, 4, seed)
    assert ours == ref


def _malformed(x):
    return [
        ("application/json", json.dumps({"cells": [[1.0, 2.0]]}).encode()),
        ("application/json", b"{nope"),
        ("application/json", json.dumps({"rows": []}).encode()),
        ("application/json", json.dumps(
            {"cells": x.tolist(), "model_fp": "no-such-model"}).encode()),
        ("application/json", json.dumps(
            {"cells": x.tolist(), "deadline_s": "soon"}).encode()),
        ("application/json", json.dumps({"cells": "abc"}).encode()),
        ("application/json", json.dumps([1, 2]).encode()),
        ("application/x-npy", b"not an npy payload"),
    ]


def test_the_wire_answers_malformed_bodies_as_the_reference(ref_dir):
    x = ref_soak.make_query_batches(1, 4, 7)[0]
    answers = {}
    for name, P, W, cfg, kw in (
            ("ref", ref_pool.ReplicaPool, ref_wire.WireFront,
             _cfg(RefServeConfig), {}),
            ("port", pool.ReplicaPool, wire.WireFront, _cfg(ServeConfig),
             {"device": "cpu"})):
        p = P(ref_dir, n_replicas=1, config=cfg, **kw)
        got = []
        with p, W(p) as front:
            conn = http.client.HTTPConnection("127.0.0.1", front.port,
                                              timeout=30)
            for ctype, body in _malformed(x):
                conn.request("POST", "/classify", body=body,
                             headers={"Content-Type": ctype})
                r = conn.getresponse()
                doc = json.loads(r.read())
                got.append((r.status, doc["outcome"], doc["error"]))
            conn.request("GET", "/nowhere")
            r = conn.getresponse()
            got.append((r.status, json.loads(r.read())["error"]))
            conn.close()
            sec = front.serving_section()
        answers[name] = (got, sec["wire"])
    assert answers["port"] == answers["ref"]
    assert {s for s, *_ in answers["port"][0][:-1]} == {422}


# --------------------------------------------------------------------------
# the validators, both ways
# --------------------------------------------------------------------------

def _fleet_section():
    st = metrics.ServingStats(queue_capacity=8)
    st.note_submit(1)
    st.note_outcome("ok", 0.005)
    sec = st.section()
    sec["wire"] = {"requests": {"submitted": 1,
                                **{o: 0 for o in metrics.OUTCOMES}},
                   "status_codes": {"200": 1}}
    sec["wire"]["requests"]["ok"] = 1
    sec["fleet"] = {
        "replicas": 1, "live_replicas": 1, "active_fp": "abc123",
        "models": {"abc123": 1}, "swaps": [], "kills": [], "scales": [],
        "submitted_by_owner": {"replicas": 1, "retired": 0, "pool": 0},
        "per_replica": [{"replica": 0, "model_fp": "abc123",
                         "submitted": 1, "ok": 1, "breaker": "closed",
                         "trips": 0, "queue_depth_peak": 1,
                         "p99_ms": 5.0}],
    }
    return sec


def _serving_breaks():
    def w(f):
        sec = _fleet_section()
        f(sec)
        return sec
    return {
        "wire-accounting": w(lambda s: s["wire"]["requests"].update(
            submitted=2)),
        "wire-status": w(lambda s: s["wire"].update(
            status_codes={"200": 2})),
        "owner-split": w(lambda s: s["fleet"]["submitted_by_owner"].update(
            pool=5)),
        "same-fp-swap": w(lambda s: s["fleet"].update(
            swaps=[{"from_fp": "a", "to_fp": "a"}])),
        "per-replica": w(lambda s: s["fleet"].update(live_replicas=2)),
        "noop-scale": w(lambda s: s["fleet"].update(
            scales=[{"from": 2, "to": 2, "ts": 1.0}])),
        "scale-widths": w(lambda s: s["fleet"].update(
            scales=[{"from": "1", "to": 2, "ts": 1.0}])),
        "scale-ts": w(lambda s: s["fleet"].update(
            scales=[{"from": 1, "to": 2}])),
    }


def _loadgen_section():
    return loadgen.build_loadgen_section(
        "spike", "poisson", 12.0, 150.0, 15.0, 7, loadgen.resolve_mix(None),
        offered=100, sent=100, completed=98, good=90, late_fraction=0.01,
        achieved_rps=6.0, breaches=[],
        autoscale={"policy": {}, "ticks": 3, "final_target": 2,
                   "degraded": False, "tightened": False,
                   "actuations": [{"kind": "scale_up", "from": 1, "to": 2,
                                   "reason": {"queue_frac": 1.0},
                                   "ts": 1.0}]})


def _loadgen_breaks():
    def w(f):
        sec = copy.deepcopy(_loadgen_section())
        f(sec)
        return sec
    return {
        "profile": w(lambda s: s.update(profile="sawtooth")),
        "arrival": w(lambda s: s.update(arrival="uniform")),
        "rates": w(lambda s: s.update(peak_rps=1.0)),
        "mix-name": w(lambda s: s.update(mix={"nope": 1.0})),
        "mix-sum": w(lambda s: s.update(mix={"cite_dual": 0.5})),
        "ladder": w(lambda s: s.update(good=99)),
        "late": w(lambda s: s.update(late_fraction=1.5)),
        "slo-held": w(lambda s: s.update(breaches=["burn: x"])),
        "headline": w(lambda s: s.update(rps_at_slo=3.0)),
        "actuation-kind": w(lambda s: s["autoscale"]["actuations"][0].update(
            kind="reboot")),
        "actuation-widths": w(lambda s: s["autoscale"]["actuations"][0]
                              .update(to=1, **{"from": 2})),
        "ticks": w(lambda s: s["autoscale"].update(ticks=-1)),
    }


def _message(fn, sec):
    with pytest.raises(ValueError) as ei:
        fn(sec)
    return str(ei.value)


@pytest.mark.parametrize("case", sorted(_serving_breaks()))
def test_validate_serving_refuses_what_the_reference_refuses(case):
    sec = _serving_breaks()[case]
    assert (_message(metrics.validate_serving, sec)
            == _message(ref_metrics.validate_serving, sec))


@pytest.mark.parametrize("case", sorted(_loadgen_breaks()))
def test_validate_loadgen_refuses_what_the_reference_refuses(case):
    sec = _loadgen_breaks()[case]
    assert (_message(loadgen.validate_loadgen, sec)
            == _message(ref_loadgen.validate_loadgen, sec))


def test_the_clean_sections_pass_both_validators():
    metrics.validate_serving(_fleet_section())
    ref_metrics.validate_serving(_fleet_section())
    loadgen.validate_loadgen(_loadgen_section())
    ref_loadgen.validate_loadgen(_loadgen_section())
    rec = export.build_run_record("x", 1.0, serving=_fleet_section(),
                                  loadgen=_loadgen_section())
    export.validate_run_record(rec)
    ref_export.validate_run_record(rec)
    bad = dict(rec, loadgen=_loadgen_breaks()["headline"])
    assert (_message(export.validate_run_record, bad)
            == _message(ref_export.validate_run_record, bad))
    for a in ({"kind": "scale_down", "from": 1, "to": 2, "ts": 1.0,
               "reason": {}}, {"kind": "exit_degraded", "ts": "now",
                               "reason": {}}, [1]):
        assert (_message(autoscale.validate_actuation, a)
                == _message(ref_autoscale.validate_actuation, a))


# --------------------------------------------------------------------------
# reconsensus
# --------------------------------------------------------------------------

def _planted(seed=0, n_per=6, cells_per=16):
    rng = np.random.default_rng(seed)
    d = [(40.0 + rng.normal(0, 0.6, size=(cells_per, 120))
          ).astype(np.float32) for _ in range(n_per)]
    e = [(-40.0 + rng.normal(0, 0.6, size=(cells_per, 120))
          ).astype(np.float32) for _ in range(n_per)]
    return d, e


def test_reconsensus_update_finds_the_reference_clusters(ref_dir):
    """The same frozen model and quarantined cells through both packages:
    the same new clusters, the old landmarks kept bit for bit, and labels
    of the drifted cells with ARI 1 against the reference's."""
    from scconsensus_tpu.serve.model import (
        load_consensus_model as ref_load,
    )
    from scconsensus_tpu_torch.serve.model import _assemble

    d, e = _planted()
    cells = np.concatenate(d + e)
    ref_model = ref_load(ref_dir)
    ours_model = load_consensus_model(ref_dir, device="cpu")
    (ra, rm), rs = ref_recon.reconsensus_update(ref_model, cells, seed=3)
    (oa, om), os_ = reconsensus.reconsensus_update(ours_model, cells,
                                                   seed=3, device="cpu")
    assert os_["n_new_clusters"] == rs["n_new_clusters"] == 2
    assert os_["new_labels"] == rs["new_labels"]
    assert (os_["n_conforming"], os_["n_nonconforming"]) == (
        rs["n_conforming"], rs["n_nonconforming"])
    assert om["label_values"] == rm["label_values"]
    k = ours_model.k
    np.testing.assert_array_equal(oa["centroids"][:k], ra["centroids"][:k])
    np.testing.assert_array_equal(oa["centroid_labels"][:k],
                                  ra["centroid_labels"][:k])
    new_ours = _assemble(oa, om, torch.device("cpu"))
    new_ref = ref_recon._assemble(ra, rm)
    lo, _ = new_ours.classify(cells)
    lr, _ = new_ref.classify(cells)
    assert adjusted_rand_index(lo, lr) == 1.0
    assert set(np.unique(lo)) == set(rs["new_labels"])


# --------------------------------------------------------------------------
# the fleet's fault sites
# --------------------------------------------------------------------------

def _plan(tmp_path, monkeypatch, rule):
    p = tmp_path / "plan.json"
    p.write_text(json.dumps({"faults": [rule]}))
    monkeypatch.setenv("SCC_FAULT_PLAN", str(p))
    faults.reset()
    ref_faults.reset()


def _site_run(P, W, cfg, kw, ref_dir, v2_dir):
    """Two wire requests and a swap under the plan; returns what the
    client saw and the sections' accounting."""
    x = ref_soak.make_query_batches(1, 8, 7)[0]
    body = json.dumps({"cells": x.tolist()})
    p = P(ref_dir, n_replicas=2, config=cfg, **kw)
    seen = []

    def post(port):
        # one connection a request: the reference leaves the body of a
        # request refused before it was read in the socket (ROADMAP C22)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("POST", "/classify", body=body,
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        doc = json.loads(r.read())
        conn.close()
        return r.status, doc["outcome"], doc.get("error", "").split(":")[0]

    with p, W(p) as front:
        seen += [post(front.port), post(front.port)]
        try:
            p.hot_swap(v2_dir)
            seen.append("swapped")
        except Exception as err:  # noqa: BLE001 - the typed fault
            seen.append(type(err).__name__)
        seen.append(post(front.port))
        sec = front.serving_section()
    return seen, sec


@pytest.mark.parametrize("rule", [
    {"site": "wire_request", "class": "transient"},
    {"site": "fleet_route", "class": "oom"},
    {"site": "fleet_swap", "class": "disk"},
], ids=lambda r: r["site"])
def test_the_fleet_fault_sites_fire_as_in_the_reference(
        ref_dir, tmp_path, monkeypatch, rule):
    v2_dir = str(tmp_path / "v2")
    ref_soak.build_atlas_model(v2_dir, seed=7, landmark_seed=1007)
    _plan(tmp_path, monkeypatch, rule)
    ours = _site_run(pool.ReplicaPool, wire.WireFront, _cfg(ServeConfig),
                     {"device": "cpu"}, ref_dir, v2_dir)
    ref = _site_run(ref_pool.ReplicaPool, ref_wire.WireFront,
                    _cfg(RefServeConfig), {}, ref_dir, v2_dir)
    seen, sec = ours
    assert seen == ref[0]
    for key in ("wire", "requests"):
        assert sec[key] == ref[1][key], key
    # the rule fires once, typed, and every request stays accounted
    metrics.validate_serving(sec)
    ref_metrics.validate_serving(sec)
    assert sec["wire"]["requests"]["submitted"] == 3
    if rule["site"] == "fleet_swap":
        assert seen[2] == "InjectedDiskFault"
        assert not sec["fleet"]["swaps"]
        assert [s[0] for s in seen if s != seen[2]] == [200, 200, 200]
    else:
        assert seen[0][:2] == (500, "failed") and seen[2] == "swapped"
        assert seen[1][0] == 200 and seen[3][0] == 200
        assert len(sec["fleet"]["swaps"]) == 1


def test_a_request_refused_before_its_body_keeps_the_connection(
        ref_dir, tmp_path, monkeypatch):
    """ROADMAP C22: a request answered before its body was read (a
    ``wire_request`` fault, an unknown path) drains the body, so the next
    request on the same keep-alive connection is served and counted."""
    _plan(tmp_path, monkeypatch, {"site": "wire_request",
                                  "class": "transient"})
    x = ref_soak.make_query_batches(1, 8, 7)[0]
    body = json.dumps({"cells": x.tolist()})
    p = pool.ReplicaPool(ref_dir, n_replicas=1, config=_cfg(ServeConfig),
                         device="cpu")
    with p, wire.WireFront(p) as front:
        conn = http.client.HTTPConnection("127.0.0.1", front.port,
                                          timeout=30)
        statuses = []
        for path in ("/classify", "/nowhere", "/classify"):
            conn.request("POST", path, body=body,
                         headers={"Content-Type": "application/json"})
            r = conn.getresponse()
            json.loads(r.read())
            statuses.append(r.status)
        conn.close()
        sec = front.serving_section()
    assert statuses == [500, 404, 200]
    assert sec["wire"]["requests"]["submitted"] == 2
    assert sec["wire"]["status_codes"] == {"500": 1, "200": 1}
    metrics.validate_serving(sec)


def test_the_wire_answers_without_nagle_delays(ref_dir, monkeypatch):
    """ROADMAP C23: the handler turns Nagle's algorithm off on every
    connection it accepts (a reply is two writes, and the second would wait
    for the client's delayed ACK); the reference's handler leaves it on."""
    import socket

    seen = []
    setup = wire._WireHandler.setup

    def recording_setup(self):
        setup(self)
        seen.append(self.connection.getsockopt(socket.IPPROTO_TCP,
                                               socket.TCP_NODELAY))

    monkeypatch.setattr(wire._WireHandler, "setup", recording_setup)
    x = ref_soak.make_query_batches(1, 8, 7)[0]
    p = pool.ReplicaPool(ref_dir, n_replicas=1, config=_cfg(ServeConfig),
                         device="cpu")
    with p, wire.WireFront(p) as front:
        conn = http.client.HTTPConnection("127.0.0.1", front.port,
                                          timeout=30)
        for _ in range(2):
            conn.request("POST", "/classify",
                         body=json.dumps({"cells": x.tolist()}),
                         headers={"Content-Type": "application/json"})
            r = conn.getresponse()
            r.read()
            assert r.status == 200
        conn.close()
    assert seen and all(seen), seen  # one keep-alive connection, no delay
    assert wire._WireHandler.disable_nagle_algorithm is True
    assert ref_wire._WireHandler.disable_nagle_algorithm is False


# --------------------------------------------------------------------------
# the device rule
# --------------------------------------------------------------------------

def test_the_fleet_entry_points_raise_without_a_card(ref_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    calls = {
        "ReplicaPool": lambda: pool.ReplicaPool(ref_dir),
        "build_atlas_model": lambda: soak.build_atlas_model(
            str(tmp_path / "m")),
        "run_fleet_soak": lambda: soak.run_fleet_soak(str(tmp_path / "s")),
        "run_load": lambda: loadgen.run_load(str(tmp_path / "l")),
        "reconsensus_update": lambda: reconsensus.reconsensus_update(
            load_consensus_model(ref_dir, device="cpu"),
            np.zeros((4, 120), np.float32)),
        "run_reconsensus": lambda: reconsensus.run_reconsensus(
            str(tmp_path / "ledger"), str(tmp_path / "out"),
            model=load_consensus_model(ref_dir, device="cpu")),
        "soak main": lambda: soak.main(["--dir", str(tmp_path / "w")]),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pool.ReplicaPool(ref_dir, n_replicas=1, device="cpu") as p:
        assert p.device.type == "cpu"
        assert all(r.server.model.device.type == "cpu"
                   for r in p.replicas())
    with pytest.raises(ServerClosed):
        p.submit(np.zeros((1, 120), np.float32))
