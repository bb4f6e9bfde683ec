"""The port's edgeR slow path against the JAX package's, on the CPU.

Two workloads: the drift sentinel's fingerprint run (synthetic_scrna(80
genes, 200 cells, 3 clusters, 8 markers, seed 11), a 5 %-noisy labeling)
and the verify recipe (synthetic_scrna(300, 800, 5, seed 7), a supervised
and an unsupervised noisy labeling merged into 8 consensus clusters). Each
runs in both compat modes of ``CompatFlags.edger_log_counts``:

- compat (True, the headline): log-normalized values enter the NB model
  as counts. Every common dispersion sits at the grid floor (1e-4) and the
  tagwise dispersions near the low end of their grid, where the argmax is
  ill-conditioned: a relative input change of 1e-6 moves the JAX
  package's own tagwise values by up to 9.6× and its log p by 1e-3. So
  compat mode holds the common dispersion, log p, the DE mask and the
  union, never tagwise values entry by entry.
- count scale (False): expm1 of the matrix, dispersions 0.48–1.14 inside
  the grid, where the same perturbation moves the JAX package's common
  dispersion by 1e-4 relative, tagwise by 6.7e-4 and log p by 0.089.

The reference runs live (not against NUMERIC_PINS.json) on the same
seeded numpy input; its config crosses through ``carry``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scconsensus_tpu as ref_pkg
import scconsensus_tpu_torch as port
from scconsensus_tpu.config import CompatFlags as RefCompat
from scconsensus_tpu.config import ReclusterConfig as RefConfig
from scconsensus_tpu.de import edger as ref_edger
from scconsensus_tpu.de import engine as ref_engine
from scconsensus_tpu.obs.regress import adjusted_rand_index
from scconsensus_tpu.ops import gates as ref_gates
from scconsensus_tpu.ops import multipletests as ref_mt
from scconsensus_tpu.utils.synthetic import noisy_labeling, synthetic_scrna
from scconsensus_tpu_torch.carry import (
    config_from_reference,
    omega_from_reference,
)
from scconsensus_tpu_torch.de import edger, engine
from scconsensus_tpu_torch.io import sparsemat
from scconsensus_tpu_torch.ops import gates, multipletests


def _t(a):
    return torch.from_numpy(np.array(a))


def _workload(name):
    if name == "fingerprint":
        data, truth, _ = synthetic_scrna(n_genes=80, n_cells=200,
                                         n_clusters=3,
                                         n_markers_per_cluster=8, seed=11)
        return data, np.asarray(noisy_labeling(truth, 0.05, seed=2))
    data, truth, _ = synthetic_scrna(n_genes=300, n_cells=800, n_clusters=5,
                                     seed=7)
    sup = noisy_labeling(truth, 0.05, n_out_clusters=3, seed=1, prefix="T")
    uns = noisy_labeling(truth, 0.10, seed=2, prefix="L")
    return data, np.asarray(ref_pkg.plot_contingency_table(sup, uns))


def _edger_config(log_counts, **kw):
    # the headline's thresholds (bench.py: q 0.01, fc 2, scaling 2)
    return RefConfig(method="edger", q_val_thrs=0.01,
                     log_fc_thrs=math.log(2.0), mean_scaling_factor=2.0,
                     compat=RefCompat(edger_log_counts=log_counts), **kw)


@pytest.fixture(scope="module", params=[
    ("fingerprint", True), ("fingerprint", False),
    ("verify", True), ("verify", False),
], ids=["fingerprint-compat", "fingerprint-countscale", "verify-compat",
        "verify-countscale"])
def de_runs(request):
    name, log_counts = request.param
    data, labels = _workload(name)
    cfg = _edger_config(log_counts)
    ref = ref_engine.pairwise_de(data, labels, cfg, mesh=None)
    got = engine.pairwise_de(data, labels, config_from_reference(
        cfg.to_json()), device="cpu")
    return dict(ref=ref, got=got, compat=log_counts, data=data,
                labels=labels)


def test_edger_de_mask_and_union_identical(de_runs):
    ref, got = de_runs["ref"], de_runs["got"]
    assert got.cluster_names == list(ref.cluster_names)
    np.testing.assert_array_equal(got.de_mask.numpy(),
                                  np.asarray(ref.de_mask))
    np.testing.assert_array_equal(got.tested.numpy(), np.asarray(ref.tested))
    np.testing.assert_array_equal(engine.de_gene_union(got, 30),
                                  ref_engine.de_gene_union(ref, 30))
    if not de_runs["compat"]:
        assert got.de_mask.any()


def test_edger_common_dispersion(de_runs):
    ref, got = de_runs["ref"], de_runs["got"]
    want = np.asarray(ref.aux["common_dispersion"])
    have = got.aux["common_dispersion"].numpy()
    if de_runs["compat"]:
        # every pair at the grid floor: the bit-equal grid and argmax give
        # the same float32 value (0 ulps measured)
        assert np.all(want < 1.1e-4)
        np.testing.assert_array_equal(have, want)
    else:
        # interior of the grid: the gene-summed LL differs in its last
        # bits and the parabola's vertex with it (6.4e-5 measured)
        np.testing.assert_allclose(have, want, rtol=2e-4)


def test_edger_tagwise_dispersion(de_runs):
    ref, got = de_runs["ref"], de_runs["got"]
    want = np.asarray(ref.aux["tagwise_dispersion"])
    have = got.aux["tagwise_dispersion"].numpy()
    assert have.shape == want.shape and np.isfinite(have).all()
    if de_runs["compat"]:
        # ill-conditioned near the grid's low end (see the module
        # docstring): held to the grid's range only
        lo = want.min() / 2.0 ** 0.5
        assert np.all((have >= lo) & (have <= want.max() * 2.0 ** 0.5))
    else:
        # 8.0e-4 relative at most (measured), the JAX package's own
        # sensitivity being 6.7e-4
        np.testing.assert_allclose(have, want, rtol=2e-3)


def test_edger_log_p(de_runs):
    ref, got = de_runs["ref"], de_runs["got"]
    want = np.asarray(ref.log_p)
    have = got.log_p.numpy()
    # the same entries are finite: NaN rows, and -inf where the reference's
    # backends flush a sub-normal tail to zero
    np.testing.assert_array_equal(np.isnan(have), np.isnan(want))
    np.testing.assert_array_equal(np.isneginf(have), np.isneginf(want))
    fin = np.isfinite(want)
    err = np.abs(have[fin] - want[fin])
    if de_runs["compat"]:
        # 9.7e-4 at most (measured)
        assert err.max() <= 2e-3, err.max()
    else:
        # 0.059 at most, 0.039 at the 99.9th percentile (measured); the
        # JAX package's own sensitivity is 0.089 and 0.029
        assert err.max() <= 0.1, err.max()
        assert np.quantile(err, 0.999) <= 0.05
    np.testing.assert_allclose(got.log_fc.numpy(), np.asarray(ref.log_fc),
                               rtol=1e-5, atol=2e-6)


def test_run_edger_pairs_matches_the_reference():
    data, labels = _workload("fingerprint")
    counts = np.expm1(data).astype(np.float32)
    names, cell_idx = engine.filter_clusters(labels, 10)
    cell_idx_of = [np.nonzero(cell_idx == k)[0].astype(np.int32)
                   for k in range(len(names))]
    pi, pj = engine._all_pairs(len(names))
    want = ref_edger.run_edger_pairs(counts, cell_idx_of, pi, pj,
                                     counts.shape[0], seed=1)
    got = edger.run_edger_pairs(_t(counts), cell_idx_of, pi, pj,
                                counts.shape[0], seed=1)
    assert isinstance(got.log_p, torch.Tensor)
    # count scale, so the tolerances of test_edger_* above
    np.testing.assert_allclose(got.common_disp.numpy(), want.common_disp,
                               rtol=2e-4)
    np.testing.assert_allclose(got.tagwise_disp.numpy(),
                               np.asarray(want.tagwise_disp), rtol=2e-3)
    np.testing.assert_allclose(got.log_fc.numpy(), want.log_fc, rtol=1e-5,
                               atol=2e-6)
    wl = np.asarray(want.log_p)
    fin = np.isfinite(wl)
    np.testing.assert_array_equal(np.isfinite(got.log_p.numpy()), fin)
    assert np.abs(got.log_p.numpy()[fin] - wl[fin]).max() <= 0.1


def _table_case():
    """The reference's own node-table case
    (tests/test_edger_parity.py::test_zero_compacted_table_equals_
    uncompacted), plus two all-zero genes."""
    rng = np.random.default_rng(5)
    G, Ns, K, R = 32, 180, 4, 24
    counts = rng.poisson(0.9, (G, Ns)).astype(np.float32)
    counts[rng.random((G, Ns)) < 0.5] = 0.0
    counts[:2] = 0.0
    lib = rng.uniform(200.0, 900.0, Ns).astype(np.float32)
    cid = rng.integers(0, K, Ns).astype(np.int32)
    onehot = np.zeros((Ns, K), np.float32)
    onehot[np.arange(Ns), cid] = 1.0
    rates = rng.gamma(0.4, 0.004, (G, K)).astype(np.float32)
    r_nodes = np.exp(np.linspace(-5.0, 9.0, R)).astype(np.float32)
    return counts, lib, cid, onehot, rates, r_nodes


def test_zero_compacted_table_equals_uncompacted():
    counts, lib, cid, onehot, rates, r_nodes = _table_case()
    phi, clib = 0.07, 500.0
    cid_t = _t(cid.astype(np.int64))
    psub = edger._sub_pseudo_chunk(_t(counts), _t(lib), cid_t, _t(rates),
                                   clib, phi)
    t_plain, z_plain = edger._table_chunk(psub, _t(onehot), _t(r_nodes))
    max_nnz = int((counts > 0).sum(axis=1).max())
    for window in (max_nnz, counts.shape[1]):
        t_got, z_got = edger._sub_table_sorted_chunk(
            _t(counts), _t(lib), cid_t, _t(rates), clib, phi, _t(r_nodes),
            window, _t(onehot))
        # the reference's own tolerances for the same comparison
        np.testing.assert_allclose(z_got.numpy(), z_plain.numpy(),
                                   rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(t_got.numpy(), t_plain.numpy(),
                                   rtol=1e-4, atol=2e-2)
    # an all-zero block takes no gamma window at all
    t0, z0 = edger._sub_table_sorted_chunk(
        _t(counts[:2]), _t(lib), cid_t, _t(rates[:2]), clib, phi,
        _t(r_nodes), 0, _t(onehot))
    np.testing.assert_allclose(t0.numpy(), t_plain[:2].numpy(), rtol=1e-4,
                               atol=2e-2)
    # ... and the reference's plain table on the same inputs
    ref_psub = ref_edger._sub_pseudo_chunk(
        jnp.asarray(counts), jnp.asarray(lib), jnp.asarray(cid),
        jnp.asarray(rates), jnp.float32(clib), jnp.float32(phi))
    t_ref, z_ref = ref_edger._table_chunk(ref_psub, jnp.asarray(onehot),
                                          jnp.asarray(r_nodes))
    np.testing.assert_allclose(z_plain.numpy(), np.asarray(z_ref),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(t_plain.numpy(), np.asarray(t_ref),
                               rtol=1e-4, atol=2e-2)


def test_lagrange_and_dense_weights_equal_the_reference():
    rho = np.random.default_rng(9).uniform(-12.0, 14.0, (5, 11)).astype(
        np.float32)
    got = edger._dense_weights(rho, np.float32(-11.0), 1.1, 24)
    want = ref_edger._dense_weights(rho, np.float32(-11.0), 1.1, 24)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got.sum(axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("method", ["edger", "wilcoxon"])
def test_skipped_pair_rows_are_nan(method):
    data, labels = _workload("fingerprint")
    sizes = np.unique(labels, return_counts=True)[1]
    # above the smallest cluster, below the others: its pairs skip
    cfg = RefConfig(method=method, q_val_thrs=0.05,
                    log_fc_thrs=math.log(1.5),
                    min_cells_group=int(np.sort(sizes)[0]) + 1)
    ref = ref_engine.pairwise_de(data, labels, cfg, mesh=None)
    got = engine.pairwise_de(data, labels,
                             config_from_reference(cfg.to_json()),
                             device="cpu")
    skipped = np.asarray(ref.pair_skipped)
    assert skipped.any() and not skipped.all()
    np.testing.assert_array_equal(got.pair_skipped, skipped)
    assert got.skip_reasons == ref.skip_reasons
    assert np.isnan(got.log_p.numpy()[skipped]).all()
    assert np.isnan(got.log_q.numpy()[skipped]).all()
    assert not got.de_mask.numpy()[skipped].any()
    assert not got.tested.numpy()[skipped].any()
    np.testing.assert_array_equal(got.de_mask.numpy(),
                                  np.asarray(ref.de_mask))
    if method == "edger":
        for key in ("common_dispersion", "tagwise_dispersion"):
            assert np.isnan(got.aux[key].numpy()[skipped]).all()
            assert np.isfinite(got.aux[key].numpy()[~skipped]).all()


def test_edger_drop_logfc_calls_nothing_and_refine_says_so():
    data, labels = _workload("fingerprint")
    flags = port.CompatFlags(edger_drop_logfc=True)
    res = engine.pairwise_de(data, labels, port.ReclusterConfig(
        method="edger", compat=flags), device="cpu")
    assert not res.de_mask.any()
    with pytest.raises(ValueError, match="nothing to re-embed"):
        port.recluster_de_consensus(data, labels, method="edgeR",
                                    compat=flags, device="cpu")


@pytest.mark.parametrize("compat", [True, False])
def test_slow_wilcoxon_de_matches_reference(compat):
    data, labels = _workload("verify")
    cfg = RefConfig(method="wilcoxon", q_val_thrs=0.01,
                    log_fc_thrs=math.log(2.0), mean_scaling_factor=2.0,
                    compat=RefCompat(bh_reference_n=compat,
                                     mean_gate_mixed_spaces=compat))
    ref = ref_engine.pairwise_de(data, labels, cfg, mesh=None)
    got = engine.pairwise_de(data, labels,
                             config_from_reference(cfg.to_json()),
                             device="cpu")
    np.testing.assert_array_equal(got.de_mask.numpy(),
                                  np.asarray(ref.de_mask))
    assert got.de_mask.any()
    assert got.pct1 is None and got.aux is None
    want = np.asarray(ref.log_p)
    np.testing.assert_array_equal(np.isnan(got.log_p.numpy()),
                                  np.isnan(want))
    fin = np.isfinite(want)
    # the rank-sum tolerances of test_torch_de.py
    np.testing.assert_allclose(got.log_p.numpy()[fin], want[fin],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got.log_fc.numpy(), np.asarray(ref.log_fc),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mixed", [True, False])
def test_pair_gates_slow(mixed):
    rng = np.random.default_rng(10)
    data = (rng.gamma(0.6, 1.0, (40, 120))
            * (rng.random((40, 120)) < 0.5)).astype(np.float32)
    cid = rng.integers(-1, 4, 120).astype(np.int32)
    pi, pj = (a.astype(np.int32) for a in np.triu_indices(4, 1))
    thr = 2.0 * float(np.mean(np.expm1(data)))
    ref_agg = ref_gates.compute_aggregates_cid(jnp.asarray(data),
                                               jnp.asarray(cid), 4)
    want = ref_gates.pair_gates_slow(ref_agg, jnp.asarray(pi),
                                     jnp.asarray(pj), thr, mixed_spaces=mixed)
    agg = gates.compute_aggregates_cid(_t(data), _t(cid), 4)
    got = gates.pair_gates_slow(agg, _t(pi).long(), _t(pj).long(), thr,
                                mixed_spaces=mixed)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(agg.mean_log.numpy(),
                               np.asarray(ref_agg.mean_log), rtol=1e-6)


@pytest.mark.parametrize("n", [None, 500.0])
def test_bh_adjust_explicit_n(n):
    rng = np.random.default_rng(11)
    lp = np.log(rng.uniform(1e-12, 1.0, (6, 300))).astype(np.float32)
    lp[0, :40] = np.nan
    lp[1, :3] = -np.inf
    lp[2, 5] = lp[2, 6]    # a tie
    want = np.asarray(ref_mt.bh_adjust(
        jnp.asarray(lp), None if n is None else jnp.asarray(n)))
    got = multipletests.bh_adjust(_t(lp), n=n).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)


def test_expm1_and_mean_helpers():
    x = np.random.default_rng(12).gamma(0.5, 1.0, (30, 50)).astype(
        np.float32)
    np.testing.assert_allclose(sparsemat.expm1_sparse(_t(x)).numpy(),
                               np.expm1(x), rtol=1e-6)
    assert sparsemat.mean_expm1(_t(x)) == pytest.approx(
        float(np.mean(np.expm1(x))), rel=1e-6)
    assert sparsemat.mean_value(_t(x)) == pytest.approx(
        float(np.mean(x)), rel=1e-6)


def test_slow_path_preset_equals_the_reference():
    ours = port.ReclusterConfig.slow_path_preset(0.01, 2.0, method="edger",
                                                 mean_scaling_factor=2.0)
    want = RefConfig.slow_path_preset(0.01, 2.0, method="edger",
                                      mean_scaling_factor=2.0)
    assert ours.to_json() == want.to_json()
    assert config_from_reference(want.to_json()) == ours


# --------------------------------------------------------------------------
# end to end: recluster_de_consensus, the reference's config and projection
# carried across
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["edgeR", "Wilcoxon"])
def slow_runs(request):
    method = request.param
    data, cons = _workload("verify")
    kw = dict(q_val_thrs=0.01, fc_thrs=2.0, mean_scaling_factor=2.0)
    ref = ref_pkg.recluster_de_consensus(data, cons, method=method,
                                         mesh=None, **kw)
    ref_cfg = RefConfig(method=method.lower(), q_val_thrs=0.01,
                        log_fc_thrs=math.log(2.0), mean_scaling_factor=2.0)
    cfg = config_from_reference(ref_cfg.to_json())
    f = ref.de_gene_union_idx.size
    omega = omega_from_reference(np.asarray(jax.random.normal(
        jax.random.PRNGKey(0),
        (f, min(ref_cfg.n_pcs + 10, f, data.shape[1])), jnp.float32)))
    got = port.refine(data, cons, cfg, device="cpu", omega=omega)
    # the entry point builds the same config and gives the same result
    again = port.recluster_de_consensus(data, cons, method=method,
                                        device="cpu", omega=omega, **kw)
    return dict(ref=ref, got=got, again=again, cfg=cfg, method=method)


def test_slow_entry_point_builds_the_reference_config(slow_runs):
    got, again = slow_runs["got"], slow_runs["again"]
    assert port.ReclusterConfig(
        method=slow_runs["method"].lower(), q_val_thrs=0.01,
        log_fc_thrs=math.log(2.0), mean_scaling_factor=2.0,
    ) == slow_runs["cfg"]
    np.testing.assert_array_equal(again.de_gene_union_idx,
                                  got.de_gene_union_idx)
    for key in got.dynamic_labels:
        np.testing.assert_array_equal(again.dynamic_labels[key],
                                      got.dynamic_labels[key])
    with pytest.raises(ValueError, match="Incorrect method"):
        port.recluster_de_consensus(np.zeros((4, 4), np.float32), list("aabb"),
                                    method="roc", device="cpu")


def test_slow_union_identical(slow_runs):
    ref, got = slow_runs["ref"], slow_runs["got"]
    assert got.de_gene_union_idx.size >= 2
    np.testing.assert_array_equal(got.de_gene_union_idx,
                                  ref.de_gene_union_idx)
    np.testing.assert_array_equal(got.de.de_mask.numpy(),
                                  np.asarray(ref.de.de_mask))


def test_slow_cuts_and_silhouettes(slow_runs):
    ref, got = slow_runs["ref"], slow_runs["got"]
    assert got.dynamic_labels.keys() == ref.dynamic_labels.keys()
    for key in ref.dynamic_labels:
        assert adjusted_rand_index(got.dynamic_labels[key],
                                   ref.dynamic_labels[key]) == 1.0, key
    for g, r in zip(got.deep_split_info, ref.deep_split_info):
        assert g["n_clusters"] == r["n_clusters"]
        # float32 distance sums over 800 cells in another order
        assert abs(g["silhouette"] - r["silhouette"]) <= 1e-4
    np.testing.assert_array_equal(got.nodg, ref.nodg)
    walls = got.metrics["stage_walls_s"]
    stages = ["de", "bh_adjust", "union", "embed", "tree", "cuts",
              "silhouette"]
    if slow_runs["method"] == "edgeR":
        stages += ["edger_nb", "edger_setup", "edger_pass_a",
                   "edger_pilot_table", "edger_common_grid", "edger_table1",
                   "edger_z1_sweep", "edger_tagwise", "edger_exact_normal",
                   "edger_exact_small"]
        assert got.de.aux["tagwise_dispersion"].shape == got.de.log_p.shape
    else:
        stages.append("wilcox_test")
    for stage in stages:
        assert walls[stage] >= 0.0, stage
