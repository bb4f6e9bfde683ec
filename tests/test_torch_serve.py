"""The port's serving path against the JAX package's, on the CPU: the
PCA basis, the frozen model's arrays, export on the reduced flagship,
models that cross between the packages both ways, the store's readonly
mode and fault hook, the driver (batching, deadlines, backpressure, the
breaker and its flagged host path, drift quarantine), the kill-restart
soak and the overhead guard.

Tolerances, each where it is used: the PCA mean within 1e-6 and the
components within 1e-4 after per-row sign alignment (float32 subspace
iteration on both sides, held as the pipeline's embed is); a frozen
model's labels identical, apart from cells inside the reference's tie
band (``robust/integrity.py`` ``replay_classify_d2``, 1e-3 relative in
d²; 0 expected on well-separated data); distances within 1e-4 of the
largest distance between the packages (their landmarks are float32
Lloyd means summed in another order), within 1e-5 relative plus the
float32 cancellation floor of sqrt(‖a‖² + ‖b‖² − 2ab) between two loads
of one model, and within 1e-3 between the device path and the float64
host mirror (the reference's own test's). The driver's outcomes are
counted exactly: the same request set and fault plan give the same
outcome counts and the same section keys in both packages, except where
a count depends on thread timing (backpressure, an undrained stop), which
is held by its invariants."""

import json
import os
import subprocess
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scconsensus_tpu as ref_pkg
from scconsensus_tpu.models.pipeline import refine as ref_refine
from scconsensus_tpu.config import ReclusterConfig as RefConfig
from scconsensus_tpu.ops.pca import pca_basis as ref_pca_basis
from scconsensus_tpu.robust import faults as ref_faults
from scconsensus_tpu.robust import record as ref_record
from scconsensus_tpu.serve import driver as ref_driver
from scconsensus_tpu.serve import errors as ref_errors
from scconsensus_tpu.serve import metrics as ref_metrics
from scconsensus_tpu.serve import model as ref_model_mod
from scconsensus_tpu.obs import export as ref_export
from scconsensus_tpu.serve import soak as ref_soak
from scconsensus_tpu.utils import artifacts as ref_artifacts
from scconsensus_tpu.utils.synthetic import noisy_labeling, synthetic_scrna
import scconsensus_tpu_torch as port
from scconsensus_tpu_torch.carry import (
    config_from_reference,
    omega_from_reference,
)
from scconsensus_tpu_torch.obs.regress import adjusted_rand_index
from scconsensus_tpu_torch.ops.pca import pca_basis, pca_scores
from scconsensus_tpu_torch.robust import faults, record
from scconsensus_tpu_torch.obs import export as port_export
from scconsensus_tpu_torch.serve import driver, errors, metrics
from scconsensus_tpu_torch.serve import model as model_mod
from scconsensus_tpu_torch.serve import soak
from scconsensus_tpu_torch.utils import artifacts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIE_BAND = 1e-3       # the reference's replay_classify_d2 tolerance
EPS32 = float(np.finfo(np.float32).eps)

# one namespace per package: the driver scenarios run through either
REF = types.SimpleNamespace(
    name="ref", server=ref_driver.ConsensusServer,
    config=ref_driver.ServeConfig, breaker=ref_driver.CircuitBreaker,
    handle=ref_driver.RequestHandle, errors=ref_errors,
    metrics=ref_metrics, faults=ref_faults, record=ref_record,
    soak=ref_soak, load=ref_model_mod.load_consensus_model, kw={})
PORT = types.SimpleNamespace(
    name="port", server=driver.ConsensusServer, config=driver.ServeConfig,
    breaker=driver.CircuitBreaker, handle=driver.RequestHandle,
    errors=errors, metrics=metrics, faults=faults, record=record,
    soak=soak, load=model_mod.load_consensus_model, kw={"device": "cpu"})


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # the suite runs six workers on the machine's cores; two torch threads
    # a worker keep these small tensors from crowding out the other files
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_fault_state(monkeypatch):
    monkeypatch.delenv("SCC_FAULT_PLAN", raising=False)
    for pkg in (REF, PORT):
        pkg.faults.reset()
        pkg.record.begin_run()
    yield
    for pkg in (REF, PORT):
        pkg.faults.reset()


def _set_plan(tmp_path, monkeypatch, rules):
    path = tmp_path / "plan.json"
    path.write_text(json.dumps({"faults": rules}))
    monkeypatch.setenv("SCC_FAULT_PLAN", str(path))
    for pkg in (REF, PORT):
        pkg.faults.reset()


def _fast_cfg(pkg, **kw):
    base = dict(
        max_batch_cells=256, queue_capacity=32, batch_window_s=0.001,
        default_deadline_s=10.0, breaker_threshold=3,
        breaker_cooldown_s=0.2, drift_quarantine_frac=0.5,
    )
    base.update(kw)
    return pkg.config(**base)


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    """Each package's demo model (its own build), loaded."""
    out = {}
    for pkg in (REF, PORT):
        d = str(tmp_path_factory.mktemp(f"serve-model-{pkg.name}"))
        pkg.soak.build_demo_model(d, seed=7, **pkg.kw)
        out[pkg.name] = (d, pkg.load(d, **pkg.kw))
    return out


def _floor(model, x):
    """Per cell, the float32 floor of a distance taken as
    sqrt(‖a‖² + ‖b‖² − 2ab) (a cell on its landmark reads about this)."""
    xp = model._gather_panel(x).astype(np.float64)
    proj = (xp - model.pca_mean.astype(np.float64)) @ \
        model.pca_components.astype(np.float64).T
    c2 = float(np.max(np.sum(model.centroids.astype(np.float64) ** 2, 1)))
    return np.sqrt(4.0 * EPS32 * (np.sum(proj * proj, axis=1) + c2))


def _outside_tie_band(model, x, got) -> int:
    """Cells whose label ``got`` is further than the tie band from the
    float64 host mirror's best landmark (the reference's replay rule)."""
    xp = model._gather_panel(x).astype(np.float64)
    proj = (xp - model.pca_mean.astype(np.float64)) @ \
        model.pca_components.astype(np.float64).T
    c = model.centroids.astype(np.float64)
    d2 = (np.sum(proj * proj, axis=1, keepdims=True) - 2.0 * proj @ c.T
          + np.sum(c * c, axis=1)[None, :])
    best = d2.min(axis=1)
    bad = 0
    for r in range(got.size):
        cands = np.nonzero(model.centroid_labels == got[r])[0]
        chosen = d2[r, cands].min() if cands.size else np.inf
        if chosen - best[r] > TIE_BAND * max(abs(best[r]), 1e-9):
            bad += 1
    return bad


# --------------------------------------------------------------------------
# the PCA basis and the frozen arrays
# --------------------------------------------------------------------------

def _ref_omega(f, n, k):
    return np.asarray(jax.random.normal(
        jax.random.PRNGKey(0), (f, min(k + 10, f, n)), jnp.float32))


def test_pca_basis_equals_the_reference_with_omega_carried():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(80, 40)).astype(np.float32)
    x[:, :5] += 3.0 * rng.normal(size=(80, 1)).astype(np.float32)
    want_mean, want = (np.asarray(a) for a in
                       ref_pca_basis(jnp.asarray(x), 8))
    omega = omega_from_reference(_ref_omega(40, 80, 8))
    mean, comps = pca_basis(torch.from_numpy(x), 8, omega=omega)
    np.testing.assert_allclose(mean.numpy(), want_mean, rtol=0, atol=1e-6)
    sign = np.sign(np.sum(comps.numpy() * want, axis=1))[:, None]
    np.testing.assert_allclose(comps.numpy() * sign, want, rtol=0,
                               atol=1e-4)
    # one shared subspace body: the basis reproduces the pipeline's scores
    scores = pca_scores(torch.from_numpy(x), 8, omega=omega).numpy()
    rebuilt = (x - mean.numpy()) @ comps.numpy().T
    np.testing.assert_allclose(rebuilt, scores, rtol=1e-5, atol=1e-5)


def test_freeze_model_arrays_equals_the_reference():
    rng = np.random.default_rng(5)
    emb = rng.normal(size=(300, 8)).astype(np.float32)
    cents = rng.normal(size=(32, 8))
    assign = np.concatenate([np.arange(32), rng.integers(0, 32, 268)])
    labels = rng.integers(0, 5, 300)
    tree = types.SimpleNamespace(merge=rng.integers(-32, 31, (31, 2)),
                                 height=np.sort(rng.random(31)),
                                 order=rng.permutation(32) + 1)
    args = (np.arange(8) * 3, rng.normal(size=8), rng.normal(size=(8, 8)),
            emb, cents, assign, labels, tree)
    kw = dict(n_genes=40, drift_margin=1.5,
              meta_extra={"deep_split": 2, "config_fp": "x"})
    got_a, got_m = model_mod.freeze_model_arrays(*args, **kw)
    want_a, want_m = ref_model_mod.freeze_model_arrays(*args, **kw)
    assert got_a.keys() == want_a.keys()
    for key in want_a:
        assert got_a[key].dtype == want_a[key].dtype, key
        np.testing.assert_array_equal(got_a[key], want_a[key])
    for m in (got_m, want_m):
        m.pop("created_unix")
    assert got_m == want_m


# --------------------------------------------------------------------------
# export on the reduced flagship, and models crossing both ways
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    """The reduced flagship (2,000 cells × 800 genes × 4 clusters, seed
    7): each package refines the same consensus with the same config and
    projection, then exports its model."""
    data, truth, _ = synthetic_scrna(n_genes=800, n_cells=2000,
                                     n_clusters=4, n_markers_per_cluster=40,
                                     seed=7)
    sup = noisy_labeling(truth, 0.05, seed=1, prefix="sup")
    uns = noisy_labeling(truth, 0.10, n_out_clusters=2, seed=2,
                         prefix="uns")
    cons = ref_pkg.plot_contingency_table(sup, uns)
    ref_cfg = RefConfig()
    cfg = config_from_reference(ref_cfg.to_json())
    ref_res = ref_refine(data, cons, ref_cfg, mesh=None)
    f = ref_res.de_gene_union_idx.size
    omega = omega_from_reference(_ref_omega(f, 2000, ref_cfg.n_pcs))
    res = port.refine(data, cons, cfg, device="cpu", omega=omega)
    ref_dir = str(tmp_path_factory.mktemp("flagship-ref"))
    port_dir = str(tmp_path_factory.mktemp("flagship-port"))
    ref_m = ref_model_mod.export_consensus_model(data, ref_res, ref_cfg,
                                                 ref_dir)
    m = port.export_consensus_model(data, res, cfg, port_dir, omega=omega,
                                    device="cpu")
    rng = np.random.default_rng(11)
    cols = rng.choice(2000, 1000, replace=False)
    query = (data[:, cols].T + rng.normal(0.0, 0.05, (1000, 800))
             ).astype(np.float32)
    return dict(data=data, ref_res=ref_res, res=res, ref=ref_m, port=m,
                ref_dir=ref_dir, port_dir=port_dir, query=query)


def test_flagship_export_panel_and_landmarks_equal_the_reference(flagship):
    ref_m, m = flagship["ref"], flagship["port"]
    np.testing.assert_array_equal(m.panel_idx, ref_m.panel_idx)
    np.testing.assert_array_equal(flagship["res"].de_gene_union_idx,
                                  flagship["ref_res"].de_gene_union_idx)
    assert (m.k, m.n_pcs, m.n_genes) == (ref_m.k, ref_m.n_pcs,
                                         ref_m.n_genes)
    assert m.meta["config_fp"] == ref_m.meta["config_fp"]
    # landmarks matched across the packages: signs of the components
    # aligned, each of the reference's landmarks to its nearest
    sign = np.sign(np.sum(m.pca_components * ref_m.pca_components,
                          axis=1))
    cp = m.centroids * sign[None, :]
    d2 = ((ref_m.centroids[:, None, :] - cp[None, :, :]) ** 2).sum(-1)
    match = d2.argmin(axis=1)
    assert np.unique(match).size == ref_m.k   # a bijection
    scale = float(np.abs(ref_m.centroids).max())
    assert float(np.sqrt(d2.min(axis=1)).max()) <= 1e-3 * scale
    np.testing.assert_array_equal(m.centroid_labels[match],
                                  ref_m.centroid_labels)
    np.testing.assert_array_equal(m.centroid_counts[match],
                                  ref_m.centroid_counts)
    np.testing.assert_allclose(m.drift_threshold, ref_m.drift_threshold,
                               rtol=1e-4)


def test_flagship_query_labels_and_distances_equal_the_reference(flagship):
    ref_m, m, x = flagship["ref"], flagship["port"], flagship["query"]
    want, want_d = ref_m.classify(x)
    got, got_d = m.classify(x)
    off = got != want
    assert _outside_tie_band(m, x[off], got[off]) == 0
    assert int(off.sum()) == 0   # well-separated data: no tie either
    # the landmarks are float32 Lloyd means summed in another order on
    # each side (they move by ~3e-5 of the embedding's scale), so the
    # distances are held at 1e-4 of the largest one, as the embedding is
    # held at 1e-4 of its largest score (tests/test_torch_pipeline.py)
    assert float(np.abs(got_d - want_d).max()) <= 1e-4 * float(want_d.max())


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_models_cross_between_the_packages(flagship, direction):
    if direction == "ref_to_port":
        writer, reader = flagship["ref"], port.load_consensus_model(
            flagship["ref_dir"], device="cpu")
    else:
        writer, reader = flagship["port"], \
            ref_model_mod.load_consensus_model(flagship["port_dir"])
    assert reader.fingerprint() == writer.fingerprint()
    assert reader.k == writer.k and reader.meta == writer.meta
    x = flagship["query"]
    want, want_d = writer.classify(x)
    got, got_d = reader.classify(x)
    np.testing.assert_array_equal(got, want)
    floor = _floor(writer, x)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=floor.max())


# --------------------------------------------------------------------------
# the frozen model artifact (mirrors tests/test_serve.py TestModelArtifact)
# --------------------------------------------------------------------------

def test_round_trip_preserves_decision_surface(demo):
    d, m = demo["port"]
    m2 = port.load_consensus_model(d, device="cpu")
    assert m2.fingerprint() == m.fingerprint() and m2.k == m.k
    np.testing.assert_array_equal(m2.centroid_labels, m.centroid_labels)
    assert m2.tree_merge.shape[0] == m.k - 1
    assert m2.device == torch.device("cpu")


def test_device_and_host_classify_agree(demo):
    _, m = demo["port"]
    for x in soak.make_requests(4, 12, 7):
        lab_d, dist_d = m.classify(x)
        lab_h, dist_h = m.classify_host(x)
        np.testing.assert_array_equal(lab_d, lab_h)
        np.testing.assert_allclose(dist_d, dist_h, rtol=1e-3, atol=1e-3)
        assert set(np.unique(lab_d)) <= set(m.meta["label_values"]) | {0}


def test_export_from_pipeline_result(tmp_path):
    data, truth, _ = synthetic_scrna(n_genes=60, n_cells=150, n_clusters=3,
                                     n_markers_per_cluster=8, seed=11)
    labels = noisy_labeling(truth, 0.05, seed=2)
    cfg = port.ReclusterConfig(deep_split_values=(1, 2))
    res = port.refine(data, labels, cfg, device="cpu")
    m = port.export_consensus_model(data, res, cfg, str(tmp_path / "m"),
                                    n_landmarks=64, device="cpu")
    assert m.n_genes == 60
    assert m.panel_idx.shape[0] == res.de_gene_union_idx.shape[0]
    served, _ = port.load_consensus_model(
        str(tmp_path / "m"), device="cpu").classify(
        np.asarray(data.T, np.float32))
    ref = res.dynamic_labels["deepsplit: 2"]
    mask = (ref > 0) & (served > 0)
    assert adjusted_rand_index(served[mask],
                                                ref[mask]) > 0.8
    # a tensor and a CSR give the same model as the numpy matrix
    import scipy.sparse as sp

    for other in (torch.from_numpy(data), sp.csr_matrix(data)):
        m2 = port.export_consensus_model(other, res, cfg,
                                         str(tmp_path / "m2"),
                                         n_landmarks=64, device="cpu")
        assert m2.fingerprint() == m.fingerprint()
    with pytest.raises(ValueError, match="no cut"):
        port.export_consensus_model(data, res, cfg, str(tmp_path / "m3"),
                                    deep_split=9, device="cpu")


def test_missing_model_is_typed(tmp_path):
    with pytest.raises(errors.ModelLoadError, match="no consensus model"):
        port.load_consensus_model(str(tmp_path / "empty"), device="cpu")


def _flip_mid_file(path):
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size // 2)
        b = f.read(1)
        f.seek(size // 2)
        f.write(bytes([b[0] ^ 0xFF]))


def test_corrupt_model_quarantined_and_refused(tmp_path):
    d = str(tmp_path / "model")
    soak.build_demo_model(d, seed=3, device="cpu")
    npz = os.path.join(d, f"{model_mod.MODEL_STAGE}.npz")
    _flip_mid_file(npz)
    with pytest.raises(errors.ModelLoadError) as ei:
        port.load_consensus_model(d, device="cpu")
    assert ei.value.quarantined
    assert not os.path.exists(npz)
    assert any(n.startswith(f"{model_mod.MODEL_STAGE}.npz.quarantined")
               for n in os.listdir(d))
    # the quarantine is noted on the robustness log
    deg = record.section()["degradations"]
    assert deg[0]["site"] == "artifact:consensus_model"
    assert deg[0]["action"] == "quarantine"
    with pytest.raises(errors.ModelLoadError):
        port.ConsensusServer(d, _fast_cfg(PORT), device="cpu")


def test_wrong_schema_refused(tmp_path):
    d = str(tmp_path / "model")
    artifacts.ArtifactStore(d).save(model_mod.MODEL_STAGE,
                                    {"panel_idx": np.arange(3)},
                                    {"schema": "something-else",
                                     "version": 1})
    with pytest.raises(errors.ModelLoadError, match="not a consensus model"):
        port.load_consensus_model(d, device="cpu")


def test_corrupt_plan_at_export_refused_at_load(tmp_path, monkeypatch):
    _set_plan(tmp_path, monkeypatch, [
        {"site": "artifact:consensus_model", "class": "corrupt"}])
    d = str(tmp_path / "model")
    soak.build_demo_model(d, seed=5, device="cpu")
    assert record.section()["faults_injected"][0]["site"] == \
        "artifact:consensus_model"
    monkeypatch.delenv("SCC_FAULT_PLAN")
    faults.reset()
    with pytest.raises(errors.ModelLoadError) as ei:
        port.load_consensus_model(d, device="cpu")
    assert ei.value.quarantined


def test_readonly_store_refuses_save_and_leaves_corrupt_in_place(tmp_path):
    d = str(tmp_path / "model")
    soak.build_demo_model(d, seed=3, device="cpu")
    npz = os.path.join(d, f"{model_mod.MODEL_STAGE}.npz")
    with open(npz, "r+b") as f:
        f.truncate(os.path.getsize(npz) // 2)
    for store_mod in (artifacts, ref_artifacts):
        ro = store_mod.ArtifactStore(d, readonly=True)
        with pytest.raises(RuntimeError, match="readonly"):
            ro.save("x", {"a": np.zeros(1)})
        with pytest.raises(store_mod.ArtifactCorrupt):
            ro.load(model_mod.MODEL_STAGE)
        assert os.path.exists(npz)  # refused but not renamed
    with pytest.raises(errors.ModelLoadError) as ei:
        port.load_consensus_model(d, readonly=True, device="cpu")
    assert not ei.value.quarantined and os.path.exists(npz)
    # a readonly store does not even create its directory
    artifacts.ArtifactStore(str(tmp_path / "absent"), readonly=True)
    assert not os.path.exists(tmp_path / "absent")


@pytest.mark.parametrize("value", [
    {"b": 1, "a": [1, 2.5, None]}, "x", 3, {"nested": {"z": np.int64(4)}}])
def test_config_fingerprint_equals_the_reference(value):
    assert artifacts.config_fingerprint(value) == \
        ref_artifacts.config_fingerprint(value)
    assert artifacts.config_fingerprint(value, n_hex=20) == \
        ref_artifacts.config_fingerprint(value, n_hex=20)


def test_serving_entry_points_raise_without_a_card(tmp_path, demo):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    d, m = demo["port"]
    res = types.SimpleNamespace(dynamic_labels={"deepsplit: 1": [1]},
                                de_gene_union_idx=[0], embedding=np.zeros(
                                    (1, 1)))
    for call in (lambda: port.load_consensus_model(d),
                 lambda: port.ConsensusServer(m),
                 lambda: port.ConsensusServer(d),
                 lambda: soak.build_demo_model(str(tmp_path / "x")),
                 lambda: port.export_consensus_model(
                     np.zeros((2, 1)), res, port.ReclusterConfig(
                         deep_split_values=(1,)), str(tmp_path / "y"))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    fresh = model_mod._assemble(
        {k: getattr(m, k) for k in model_mod._REQUIRED_ARRAYS},
        {**m.meta, "drift_threshold": m.drift_threshold})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fresh.classify(np.zeros((2, m.n_genes), np.float32))


# --------------------------------------------------------------------------
# the driver, in both packages on the same requests and plans
# --------------------------------------------------------------------------

def _scenario_bare(pkg, m, tmp_path, monkeypatch):
    reqs = pkg.soak.make_requests(6, 10, 7)
    with pkg.server(m, _fast_cfg(pkg), **pkg.kw) as srv:
        for x in reqs:
            resp = srv.classify(x, timeout=30.0)
            assert resp.outcome == "ok" and not resp.degraded
            np.testing.assert_array_equal(resp.labels, m.classify(x)[0])
    return srv.serving_section()


def _scenario_coalesce(pkg, m, tmp_path, monkeypatch):
    reqs = pkg.soak.make_requests(12, 8, 7)
    with pkg.server(m, _fast_cfg(pkg, batch_window_s=0.05),
                    **pkg.kw) as srv:
        handles = [srv.submit(x) for x in reqs]
        assert all(h.result(timeout=30.0).outcome == "ok" for h in handles)
    sec = srv.serving_section()
    assert sec["batches"]["count"] < 12 and sec["batches"]["max_cells"] > 8
    return sec


def _scenario_deadline(pkg, m, tmp_path, monkeypatch):
    _set_plan(tmp_path, monkeypatch, [
        {"site": "serve_batch", "class": "stall", "stall_s": 0.4}])
    with pkg.server(m, _fast_cfg(pkg), **pkg.kw) as srv:
        h = srv.submit(pkg.soak.make_requests(1, 8, 7)[0], deadline_s=0.1)
        with pytest.raises(pkg.errors.DeadlineExceeded) as ei:
            h.result(timeout=30.0)
        assert ei.value.late_by_s > 0
    return srv.serving_section()


def _scenario_invalid(pkg, m, tmp_path, monkeypatch):
    with pkg.server(m, _fast_cfg(pkg), **pkg.kw) as srv:
        with pytest.raises(pkg.errors.RequestInvalid, match="genes"):
            srv.submit(np.zeros((3, 7), np.float32))
        with pytest.raises(pkg.errors.RequestInvalid, match="max batch"):
            srv.submit(np.zeros((100000, m.n_genes), np.float32))
        bad = pkg.soak.make_requests(1, 4, 7)[0].copy()
        bad[0, 0] = np.nan
        h = srv.submit(bad)
        with pytest.raises(pkg.errors.RequestInvalid, match="non-finite"):
            h.result(timeout=30.0)
    return srv.serving_section()


def _scenario_after_stop(pkg, m, tmp_path, monkeypatch):
    srv = pkg.server(m, _fast_cfg(pkg), **pkg.kw).start()
    srv.stop()
    with pytest.raises(pkg.errors.ServerClosed):
        srv.submit(pkg.soak.make_requests(1, 4, 7)[0])
    return srv.serving_section()


def _scenario_transient(pkg, m, tmp_path, monkeypatch):
    _set_plan(tmp_path, monkeypatch, [
        {"site": "serve_device", "class": "transient", "times": 2}])
    with pkg.server(m, _fast_cfg(pkg), **pkg.kw) as srv:
        resp = srv.classify(pkg.soak.make_requests(1, 8, 7)[0],
                            timeout=30.0)
    assert resp.outcome == "ok" and not resp.degraded
    return srv.serving_section()


def _scenario_persistent(pkg, m, tmp_path, monkeypatch):
    _set_plan(tmp_path, monkeypatch, [
        {"site": "serve_device", "class": "oom", "times": 50}])
    reqs = pkg.soak.make_requests(5, 8, 7)
    with pkg.server(m, _fast_cfg(pkg, breaker_cooldown_s=60.0),
                    **pkg.kw) as srv:
        responses = [srv.classify(x, timeout=30.0) for x in reqs]
    assert all(r.outcome == "degraded" and r.degraded for r in responses)
    for x, r in zip(reqs, responses):
        np.testing.assert_array_equal(r.labels, m.classify_host(x)[0])
    # the flagged host path is on the robustness log
    degs = pkg.record.section()["degradations"]
    assert {d["action"] for d in degs} == {"host-fallback"}
    return srv.serving_section()


def _scenario_half_open(pkg, m, tmp_path, monkeypatch):
    _set_plan(tmp_path, monkeypatch, [
        {"site": "serve_device", "class": "oom", "times": 3}])
    with pkg.server(m, _fast_cfg(pkg, breaker_cooldown_s=0.05),
                    **pkg.kw) as srv:
        r1 = srv.classify(pkg.soak.make_requests(1, 8, 7)[0], timeout=30.0)
        assert r1.degraded
        time.sleep(0.1)
        r2 = srv.classify(pkg.soak.make_requests(1, 8, 7)[0], timeout=30.0)
        assert r2.outcome == "ok" and not r2.degraded
    return srv.serving_section()


def _scenario_device_lost(pkg, m, tmp_path, monkeypatch):
    _set_plan(tmp_path, monkeypatch, [
        {"site": "serve_device", "class": "device_loss", "times": 50}])
    with pkg.server(m, _fast_cfg(pkg, breaker_cooldown_s=60.0),
                    **pkg.kw) as srv:
        r = srv.classify(pkg.soak.make_requests(1, 8, 7)[0], timeout=30.0)
    assert r.outcome == "degraded"
    return srv.serving_section()


def _scenario_fatal_batch(pkg, m, tmp_path, monkeypatch):
    _set_plan(tmp_path, monkeypatch, [
        {"site": "serve_batch", "class": "disk"}])
    with pkg.server(m, _fast_cfg(pkg), **pkg.kw) as srv:
        r = srv.classify(pkg.soak.make_requests(1, 8, 7)[0], timeout=30.0)
    # a disk-class fault at batch assembly counts on the breaker; below
    # the threshold the device still answers
    assert r.outcome == "ok"
    return srv.serving_section()


def _scenario_drift(pkg, m, tmp_path, monkeypatch):
    os.makedirs(tmp_path / pkg.name, exist_ok=True)
    qpath = str(tmp_path / pkg.name / "quarantine.jsonl")
    ood = pkg.soak.make_requests(3, 8, 7, n_ood=1)
    with pkg.server(m, _fast_cfg(pkg, quarantine_path=qpath),
                    **pkg.kw) as srv:
        ok_resp = srv.classify(ood[0], timeout=30.0)
        q_resp = srv.classify(ood[-1], timeout=30.0)
    assert ok_resp.outcome == "ok"
    assert q_resp.outcome == "quarantined" and q_resp.labels is None
    assert q_resp.drift_fraction >= 0.5
    with open(qpath) as f:
        (entry,) = [json.loads(ln) for ln in f if ln.strip()]
    assert entry["n_cells"] == 8 and entry["model_fp"] == m.fingerprint()
    assert len(entry["dist_q"]) == 4
    assert os.path.exists(os.path.join(str(tmp_path / pkg.name),
                                       entry["cells_file"]))
    return srv.serving_section()


def _scenario_drift_off(pkg, m, tmp_path, monkeypatch):
    ood = pkg.soak.make_requests(1, 8, 7, n_ood=1)
    with pkg.server(m, _fast_cfg(pkg, drift_quarantine_frac=2.0),
                    **pkg.kw) as srv:
        assert srv.classify(ood[0], timeout=30.0).outcome == "ok"
    return srv.serving_section()


_SCENARIOS = {
    "bare": _scenario_bare, "coalesce": _scenario_coalesce,
    "deadline": _scenario_deadline, "invalid": _scenario_invalid,
    "after_stop": _scenario_after_stop, "transient": _scenario_transient,
    "persistent": _scenario_persistent, "half_open": _scenario_half_open,
    "device_lost": _scenario_device_lost,
    "batch_fault": _scenario_fatal_batch, "drift": _scenario_drift,
    "drift_off": _scenario_drift_off,
}


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + ".")
    return out


@pytest.mark.parametrize("name", sorted(_SCENARIOS))
def test_driver_scenario_matches_the_reference(name, demo, tmp_path,
                                               monkeypatch):
    secs = {}
    for pkg in (REF, PORT):
        pkg.record.begin_run()
        secs[pkg.name] = _SCENARIOS[name](pkg, demo[pkg.name][1], tmp_path,
                                          monkeypatch)
        pkg.metrics.validate_serving(secs[pkg.name])
        monkeypatch.delenv("SCC_FAULT_PLAN", raising=False)
        pkg.faults.reset()
    ours, ref = secs["port"], secs["ref"]
    assert ours["requests"] == ref["requests"]
    assert ours["breaker"] == ref["breaker"]
    assert ours["drift"] == ref["drift"]
    assert _keys(ours) == _keys(ref)


def test_queue_full_backpressure_with_retry_after(demo, tmp_path,
                                                  monkeypatch):
    # stall the worker so the queue backs up; how many are rejected
    # depends on thread timing, so each package is held to the invariants
    for pkg in (REF, PORT):
        _set_plan(tmp_path, monkeypatch, [
            {"site": "serve_batch", "class": "stall", "stall_s": 0.5,
             "times": 4}])
        m = demo[pkg.name][1]
        cfg = _fast_cfg(pkg, queue_capacity=4, default_deadline_s=30.0)
        with pkg.server(m, cfg, **pkg.kw) as srv:
            handles, rejected, retry_after = [], 0, None
            for x in pkg.soak.make_requests(12, 4, 7):
                try:
                    handles.append(srv.submit(x))
                except pkg.errors.QueueFull as e:
                    rejected += 1
                    retry_after = e.retry_after_s
            assert rejected > 0 and retry_after > 0
            for h in handles:
                h.result(timeout=60.0)
        sec = srv.serving_section()
        pkg.metrics.validate_serving(sec)
        assert sec["requests"]["rejected_queue"] == rejected
        assert sec["requests"]["ok"] == 12 - rejected
        assert sec["queue"]["depth_peak"] <= 4


def test_stop_without_drain_refuses_backlog_typed(demo, tmp_path,
                                                  monkeypatch):
    for pkg in (REF, PORT):
        _set_plan(tmp_path, monkeypatch, [
            {"site": "serve_batch", "class": "stall", "stall_s": 0.3,
             "times": 6}])
        srv = pkg.server(demo[pkg.name][1],
                         _fast_cfg(pkg, max_batch_cells=16),
                         **pkg.kw).start()
        handles = [srv.submit(x) for x in pkg.soak.make_requests(6, 16, 7)]
        time.sleep(0.05)
        srv.stop(drain=False)
        outcomes = []
        for h in handles:
            try:
                outcomes.append(h.result(timeout=10.0).outcome)
            except pkg.errors.ServerClosed:
                outcomes.append("closed")
        assert "closed" in outcomes
        sec = srv.serving_section()
        pkg.metrics.validate_serving(sec)
        assert sec["requests"]["rejected_closed"] == outcomes.count("closed")


def test_request_handle_wakes_every_waiter_under_contention():
    """The handle's latch under contention: 16 handles, 8 waiters each
    (more threads than cores), resolved from another thread with a short
    switch interval; every waiter gets its handle's answer, none hangs."""
    import threading

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        handles = [driver.RequestHandle(i, np.zeros((1, 2)), 0.0)
                   for i in range(16)]
        got, lock = [], threading.Lock()

        def wait(h):
            r = h.result(timeout=30.0)
            with lock:
                got.append((h.req_id, r))

        waiters = [threading.Thread(target=wait, args=(h,))
                   for h in handles for _ in range(8)]
        for t in waiters:
            t.start()
        resolver = threading.Thread(target=lambda: [
            h._resolve(response=f"r{h.req_id}") for h in handles])
        resolver.start()
        for t in waiters + [resolver]:
            t.join(timeout=30.0)
        assert not any(t.is_alive() for t in waiters + [resolver])
    finally:
        sys.setswitchinterval(old)
    assert sorted(got) == sorted((i, f"r{i}") for i in range(16)
                                 for _ in range(8))
    assert all(h.done() and h.result(0) == f"r{h.req_id}" for h in handles)
    with pytest.raises(TimeoutError):
        driver.RequestHandle(99, np.zeros((1, 2)), 0.0).result(timeout=0.01)


@pytest.mark.parametrize("pkg", [REF, PORT], ids=["ref", "port"])
def test_breaker_unit_transitions(pkg):
    stats = pkg.metrics.ServingStats()
    br = pkg.breaker(threshold=2, cooldown_s=10.0, stats=stats)
    seq = [br.route(now=0.0)]
    br.record_failure("transient", now=0.0)
    seq.append(br.state)
    br.record_failure("resource", now=0.0)
    seq += [br.state, br.trips, br.route(now=1.0), br.route(now=11.0),
            br.state]
    br.record_failure("transient", now=11.0)
    seq += [br.state, br.trips, br.route(now=22.0)]
    br.record_success()
    seq.append(br.state)
    assert seq == ["device", "closed", "open", 1, "fallback", "device",
                   "half_open", "open", 2, "device", "closed"]
    assert stats.breaker_trips == 2 and stats.breaker_state == "closed"


def test_live_summary_feeds_and_stop_detaches(demo):
    m = demo["port"][1]
    with port.ConsensusServer(m, _fast_cfg(PORT), device="cpu") as srv:
        srv.classify(soak.make_requests(1, 8, 7)[0], timeout=30.0)
        live = metrics.live_summary()
        assert live["breaker"] == "closed" and live["ok"] == 1
        assert live["queue_cap"] == srv.config.queue_capacity
        assert live["recent"][0]["trace_id"]
    assert metrics.live_summary() is None


@pytest.mark.parametrize("register_live", [True, False],
                         ids=["registered", "unregistered"])
@pytest.mark.parametrize("pkg", [REF, PORT], ids=["ref", "port"])
def test_register_live_decides_the_active_stats(pkg, register_live, demo):
    """``register_live=False`` (a server that is one of several, as the
    atlas scenario runs it) leaves the process's active stats as they
    were through ``start()`` and ``stop()``; the default sets them and
    clears them again. Both packages alike."""
    m = demo[pkg.name][1]
    other = pkg.metrics.ServingStats()
    pkg.metrics.set_active(other)
    try:
        srv = pkg.server(m, _fast_cfg(pkg), register_live=register_live,
                         **pkg.kw)
        srv.start()
        try:
            srv.classify(pkg.soak.make_requests(1, 8, 7)[0], timeout=30.0)
            during = pkg.metrics.active_stats()
        finally:
            srv.stop()
        after = pkg.metrics.active_stats()
    finally:
        pkg.metrics.set_active(None)
    if register_live:
        assert during is srv.stats and after is None
    else:
        assert during is other and after is other


def test_serve_requests_ride_the_ambient_tracer(demo):
    from scconsensus_tpu_torch.obs import trace

    tr = trace.Tracer(sync="off")
    with port.ConsensusServer(demo["port"][1], _fast_cfg(PORT),
                              device="cpu") as srv:
        for x in soak.make_requests(3, 8, 7):
            srv.classify(x, timeout=30.0)
    spans = [s for s in tr.spans if s.name == "serve_request"]
    assert len(spans) == 3
    assert {s.attrs["outcome"] for s in spans} == {"ok"}
    assert all(len(s.attrs["trace_id"]) == 16 for s in spans)


def test_soak_accounting_matches_the_reference(tmp_path):
    ours = soak.run_soak(str(tmp_path / "port"), n_requests=8, cells_per=8,
                         seed=7, n_ood=2, device="cpu")
    ref = ref_soak.run_soak(str(tmp_path / "ref"), n_requests=8,
                            cells_per=8, seed=7, n_ood=2)
    assert ours["ok"] and ours["resolved"] == ours["requests"] == 8
    assert ours["outcome_counts"] == ref["outcome_counts"] == \
        {"ok": 6, "quarantined": 2}
    # the summary carries a whole run record, as the reference's does,
    # and each package's validator takes the other's
    assert set(ours) == set(ref)
    ref_export.validate_run_record(ours["record"])
    port_export.validate_run_record(ref["record"])
    metrics.validate_serving(ours["record"]["serving"])
    assert ours["record"]["serving"]["requests"] == ref["record"][
        "serving"]["requests"]
    assert _keys(ours["record"]["serving"]) == _keys(ref["record"]["serving"])


# --------------------------------------------------------------------------
# kill-and-restart durability (subprocess, real SIGKILL)
# --------------------------------------------------------------------------

def _soak_worker(workdir, plan_path, n_requests=10):
    env = dict(os.environ)
    env.pop("SCC_FAULT_PLAN", None)
    if plan_path:
        env["SCC_FAULT_PLAN"] = plan_path
    summary = os.path.join(workdir, "SOAK_SUMMARY.json")
    try:
        os.remove(summary)
    except OSError:
        pass
    proc = subprocess.run(
        [sys.executable, "-m", "scconsensus_tpu_torch.serve.soak",
         "--dir", workdir, "--requests", str(n_requests),
         "--summary", summary, "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=240, cwd=REPO,
    )
    try:
        with open(summary) as f:
            return proc.returncode, json.load(f)
    except (OSError, json.JSONDecodeError):
        return proc.returncode, None


def test_sigkill_mid_batch_then_restart_identical_labels(tmp_path):
    workdir = str(tmp_path / "serve")
    os.makedirs(workdir)
    rc0, ref = _soak_worker(workdir, None)
    assert rc0 == 0 and ref and ref["ok"], "reference run failed"
    plan = tmp_path / "kill.json"
    plan.write_text(json.dumps({"faults": [
        {"site": "serve_batch", "class": "kill", "after": 1}]}))
    rc1, dead = _soak_worker(workdir, str(plan))
    assert rc1 != 0, "kill plan did not kill the worker"
    assert dead is None, "a SIGKILLed worker cannot have summarized"
    rc2, restart = _soak_worker(workdir, None)
    assert rc2 == 0 and restart and restart["ok"]
    assert restart["model_built"] is False
    assert restart["model_fp"] == ref["model_fp"]
    assert restart["labels_sha"] == ref["labels_sha"]
    metrics.validate_serving(restart["record"]["serving"])


def test_soak_expect_refusal_on_a_corrupt_model(tmp_path):
    d = str(tmp_path / "m")
    soak.build_demo_model(d, seed=7, device="cpu")
    _flip_mid_file(os.path.join(d, f"{model_mod.MODEL_STAGE}.npz"))
    assert soak.main(["--dir", d, "--expect-refusal", "--device",
                      "cpu"]) == 0
    with open(os.path.join(d, "SOAK_SUMMARY.json")) as f:
        out = json.load(f)
    assert out["refused"] and out["quarantined"]


# --------------------------------------------------------------------------
# zero-fault overhead guard (< 2 %, the reference's contract)
# --------------------------------------------------------------------------

def _production_shaped_model():
    """The reference's fabricated frozen model at serving scale (2,000
    genes, a 1,500-gene panel, 32 PCs, 512 landmarks), drift gate off."""
    rng = np.random.default_rng(0)
    G, F, P, K = 2000, 1500, 32, 512
    return model_mod.ConsensusModel(
        panel_idx=np.sort(rng.choice(G, F, replace=False)).astype(np.int64),
        pca_mean=rng.normal(size=F).astype(np.float32),
        pca_components=rng.normal(size=(P, F)).astype(np.float32),
        centroids=rng.normal(size=(K, P)).astype(np.float32),
        centroid_labels=rng.integers(1, 9, K).astype(np.int64),
        centroid_counts=np.ones(K, np.int64),
        tree_merge=np.zeros((K - 1, 2)), tree_height=np.zeros(K - 1),
        tree_order=np.arange(K), calib_q=np.array([1.0, 2.0, 3.0, 4.0]),
        drift_threshold=float("inf"), meta={"n_genes": G, "deep_split": 2},
        device="cpu",
    ), G


def test_guard_layers_under_two_percent_vs_bare_classify():
    """The reference's guard test: the layers the driver wraps around a
    bare ``classify()`` add < 2 % over the classify call itself, zero
    fault and breaker closed, measured differentially on one thread
    (the driver's own classify wall against the wall of driving the
    batch path), best of 3."""
    import gc

    import scconsensus_tpu_torch.obs.trace as trace_mod

    trace_mod._LAST_TRACER = None
    gc.collect()
    m, G = _production_shaped_model()
    rng = np.random.default_rng(1)
    reqs = [rng.normal(size=(2048, G)).astype(np.float32) for _ in range(8)]
    m.classify(reqs[0])
    best = float("inf")
    for _ in range(3):
        srv = port.ConsensusServer(m, _fast_cfg(
            PORT, max_batch_cells=2048, queue_capacity=64,
            batch_window_s=0.0), device="cpu")
        t0 = time.perf_counter()
        for i, x in enumerate(reqs):
            r = driver.RequestHandle(i, x, time.monotonic() + 30.0)
            srv._process([r])
            assert r.result(0).outcome == "ok"
        guarded = time.perf_counter() - t0
        assert srv.stats.breaker_trips == 0
        assert srv.stats.classify_wall_s > 0
        best = min(best, guarded / srv.stats.classify_wall_s)
    assert best < 1.02, (
        f"zero-fault, breaker-closed guard layers added {best - 1:+.1%} "
        "over the bare classify wall; contract is < 2%")
