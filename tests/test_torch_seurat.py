"""The port's Seurat tests (bimod LRT, Welch t, roc's AUC) and its
``betainc`` against the JAX package, on the CPU.

The pair forms run on the same seeded numpy input in both packages; ``pairwise_de`` runs on the bench's reduced flagship (2,000
cells × 800 genes × 4 planted clusters, seed 7) under two labelings: the
truth, and the consensus of ``chip_smoke.py``'s recipe (8 clusters, 28
pairs). Both packages flush p < FLT_MIN to log p = −inf (the reference
through XLA's handling of its subnormal 1e-38 floor, the port explicitly),
so the −inf positions and the DE masks are held identical.
"""

import jax
import jax.numpy as jnp
import jax.scipy.special as jsp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import scconsensus_tpu as ref_pkg
from scconsensus_tpu.config import ReclusterConfig as RefConfig
from scconsensus_tpu.de import engine as ref_engine
from scconsensus_tpu.models.pipeline import refine as ref_refine
from scconsensus_tpu.ops import gates as ref_gates
from scconsensus_tpu.ops import seurat_tests as ref_st
from scconsensus_tpu.utils.synthetic import noisy_labeling, synthetic_scrna
import scconsensus_tpu_torch as port
from scconsensus_tpu_torch.carry import config_from_reference
from scconsensus_tpu_torch.de import engine
from scconsensus_tpu_torch.ops import seurat_tests as st
from scconsensus_tpu_torch.ops.gates import ClusterAggregates
from scconsensus_tpu_torch.ops.special import FLT_MIN, betainc, flush_log

# log p: the same float32 formulas on both sides from the same aggregates,
# but gammaincc, lgamma and log are different implementations, a few ulps
# apart. The bimod LRT is 2·(ll1 + ll2 − ll_pooled) of likelihoods of size
# up to ~1e4 (float32 ulp ~1e-3), and the Welch prefactor subtracts
# log-gammas of df/2 up to ~500, where XLA's lgamma and torch's differ by
# up to 1e-3; over all 28 × 800 pair entries log p moved by at most
# 3.0e-3 (bimod) and 5.7e-3 (t), and by at most 1.6e-4 relative below
# log p = −10
LOGP_RTOL, LOGP_ATOL = 2e-4, 1e-2
# betainc over the grid: the reference takes its log-beta in float32,
# where lgamma(a) and lgamma(a + b) of size up to ~6e3 cancel and keep
# their ulps (~1e-4); the port takes it in float64. exp(−lbeta) carries
# that into the result, and 1 − I after the symmetry switch magnifies it
# where I is near 1 (measured 2.9e-4 absolute, at most 3.6e-5 where the
# result is below 1e-3)
BETAINC_RTOL, BETAINC_ATOL = 2e-3, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # the suite runs six workers on the machine's cores; two torch threads
    # a worker keep these small tensors from crowding out the other files
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def flagship():
    """The reduced flagship and its two labelings."""
    data, truth, _ = synthetic_scrna(n_genes=800, n_cells=2000,
                                     n_clusters=4, n_markers_per_cluster=40,
                                     seed=7)
    sup = noisy_labeling(truth, 0.05, seed=1, prefix="sup")
    uns = noisy_labeling(truth, 0.10, n_out_clusters=2, seed=2,
                         prefix="uns")
    return {"data": data,
            "truth": np.array([f"c{v}" for v in truth]),
            "cons": ref_pkg.plot_contingency_table(sup, uns)}


def _small_case(seed=0, G=6, N=64):
    """log-normal-ish values with half zeros and an all-zero gene, over
    five clusters: three random ones, a one-cell cluster and an empty
    one."""
    rng = np.random.default_rng(seed)
    vals = (rng.gamma(2.0, 1.0, (G, N))
            * (rng.random((G, N)) < 0.5)).astype(np.float32)
    vals[0] = 0.0                                  # an all-zero gene
    cid = rng.integers(0, 3, N).astype(np.int32)
    cid[5] = 3                                     # one-cell cluster 3
    return vals, cid, 5                            # cluster 4 is empty


def _assert_logp(got, want):
    got, want = np.asarray(got), np.asarray(want)
    # Welch t at t ≈ 0: x = df/(df + t²) rounds to 1, and the reference's
    # fused XLA arithmetic can land it one ulp above 1, where betainc is
    # NaN; the port gives p = 1 (log p = 0) there. Such entries are never
    # DE; at most 1 in 1,000 entries may differ so (2 of 22,400 measured)
    at_one = np.isnan(want) & (got == 0.0)
    assert at_one.sum() <= 1e-3 * want.size, int(at_one.sum())
    want = np.where(at_one, 0.0, want).astype(want.dtype)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=LOGP_RTOL,
                               atol=LOGP_ATOL)


@pytest.mark.parametrize("test", ["bimod", "t"])
def test_pair_forms_keep_the_nan_rules_of_the_reference(test):
    vals, cid, k = _small_case()
    agg = ref_gates.compute_aggregates_cid(jnp.asarray(vals),
                                           jnp.asarray(cid), k)
    ours = _port_aggregates(agg)
    pi, pj = (a.astype(np.int64) for a in np.triu_indices(k, 1))
    ref_fn = {"bimod": ref_st.bimod_lrt_pairs, "t": ref_st.welch_t_pairs}
    fn = {"bimod": st.bimod_lrt_pairs, "t": st.welch_t_pairs}
    want = np.asarray(ref_fn[test](agg, jnp.asarray(pi), jnp.asarray(pj)))
    got = fn[test](ours, _t(pi), _t(pj)).numpy()
    _assert_logp(got, want)
    # bimod needs a cell in each group, t two: every pair with the empty
    # cluster is NaN, and for t every pair with the one-cell cluster too
    small = {"bimod": (4,), "t": (3, 4)}[test]
    nan_pair = np.isin(pi, small) | np.isin(pj, small)
    assert np.isnan(got[nan_pair]).all()
    assert not np.isnan(got[~nan_pair]).all(axis=1).any()


def test_zinorm_loglik_stats_matches_reference():
    vals, cid, k = _small_case(seed=1)
    for xmin in (0.0, 0.5):
        # sufficient statistics per cluster, the empty and one-cell ones
        # included: n, positives, their sum and sum of squares
        m = cid[None, :] == np.arange(k)[:, None]             # (k, N)
        pos = m[:, None, :] & (vals[None] > xmin)             # (k, G, N)
        vp = np.where(pos, vals[None], 0.0)
        stats = [np.broadcast_to(m.sum(1)[:, None], pos.shape[:2]),
                 pos.sum(-1), vp.sum(-1), (vp * vp).sum(-1)]
        stats = [np.ascontiguousarray(x, np.float32) for x in stats]
        want = ref_st._zinorm_loglik_stats(*(jnp.asarray(x) for x in stats))
        got = st._zinorm_loglik_stats(*(_t(x) for x in stats))
        # the same float32 formula from the same statistics; log and
        # sqrt are different implementations, an ulp apart, in terms of
        # size up to ~1e2
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-3)


def _port_aggregates(agg):
    """The port's ``ClusterAggregates`` from the reference's (the same
    host numbers)."""
    return ClusterAggregates(*(torch.from_numpy(np.array(getattr(agg, f)))
                               for f in ("sum_log", "sum_expm1", "sum_sq",
                                         "nnz", "counts")))


def _aggregates(data, labels):
    """The reference's segment-sum aggregates of ``data`` (host numbers
    both packages read) and the all-pairs index."""
    names, cell_idx = ref_engine.filter_clusters(labels, 10)
    k = len(names)
    agg = ref_gates.compute_aggregates_cid(jnp.asarray(data),
                                           jnp.asarray(cell_idx), k)
    pi, pj = (a.astype(np.int64) for a in np.triu_indices(k, 1))
    return agg, _port_aggregates(agg), pi, pj


@pytest.mark.parametrize("test", ["bimod", "t"])
def test_pair_forms_match_reference(flagship, test):
    agg, ours, pi, pj = _aggregates(flagship["data"], flagship["cons"])
    ref_fn = {"bimod": ref_st.bimod_lrt_pairs, "t": ref_st.welch_t_pairs}
    fn = {"bimod": st.bimod_lrt_pairs, "t": st.welch_t_pairs}
    want = np.asarray(ref_fn[test](agg, jnp.asarray(pi), jnp.asarray(pj)))
    got = fn[test](ours, _t(pi), _t(pj)).numpy()
    assert np.isneginf(want).any() and np.isfinite(want).any()
    _assert_logp(got, want)


def test_auc_from_u_matches_reference():
    rng = np.random.default_rng(2)
    n1 = rng.integers(0, 40, (5, 1)).astype(np.float32)
    n2 = rng.integers(1, 40, (5, 1)).astype(np.float32)
    u = (rng.random((5, 7)) * n1 * n2).round().astype(np.float32)
    want = ref_st.auc_from_u(jnp.asarray(u), jnp.asarray(n1),
                             jnp.asarray(n2))
    got = st.auc_from_u(_t(u), _t(n1), _t(n2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)


def test_betainc_matches_jax_over_a_grid():
    a = np.array([1e-3, 0.1, 0.5, 1, 2.5, 10, 50, 300, 1000], np.float32)
    b = np.array([1e-3, 0.5, 1, 3, 20], np.float32)
    x = np.array([0, 1e-6, 1e-3, 0.05, 0.3, 0.5, 0.7, 0.95, 0.999,
                  1 - 1e-6, 1], np.float32)
    A, B, X = (v.ravel() for v in np.meshgrid(a, b, x, indexing="ij"))
    want = np.asarray(jax.jit(jsp.betainc)(A, B, X))
    got = betainc(_t(A), _t(B), _t(X)).numpy()
    np.testing.assert_allclose(got, want, rtol=BETAINC_RTOL,
                               atol=BETAINC_ATOL)


def test_betainc_edge_cases_match_jax():
    inf, nan = np.inf, np.nan
    # a or b zero or infinite, x at 0 or 1, NaN anywhere, out of range
    a = np.array([0, 0, 1, inf, 1, 2, nan, -1, 1, 0, inf, 1, 1, 3, 1, 2],
                 np.float32)
    b = np.array([1, 1, 0, 1, inf, .5, 1, 1, 1, 0, inf, 1, 1, nan, -2, 0],
                 np.float32)
    x = np.array([0, .5, .5, .5, .5, 1, .5, .5, 1.5, .5, .5, 0, 1, .5, .5,
                  1], np.float32)
    want = np.asarray(jsp.betainc(a, b, x))
    got = betainc(_t(a), _t(b), _t(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_flush_matches_reference():
    p = np.array([0.0, 5e-39, 1.1e-38, FLT_MIN, 2e-38, 0.5, 1.0, np.nan],
                 np.float32)
    want = np.asarray(jax.jit(lambda q: jnp.log(jnp.maximum(q, 1e-38)))(p))
    got = flush_log(_t(p)).numpy()
    # every p below FLT_MIN is −inf in both; above it the same log
    np.testing.assert_array_equal(np.isneginf(got), p < FLT_MIN)
    np.testing.assert_array_equal(got, want)


def _as(kind, data):
    return sp.csr_matrix(data) if kind == "csr" else data


@pytest.mark.parametrize("cap", [None, 200], ids=["all-cells", "cap200"])
@pytest.mark.parametrize("kind", ["dense", "csr"])
@pytest.mark.parametrize("method", ["bimod", "t", "roc"])
def test_pairwise_de_matches_reference(flagship, method, kind, cap):
    data, labels = _as(kind, flagship["data"]), flagship["cons"]
    rc = RefConfig(method=method, max_cells_per_ident=cap)
    ref = ref_engine.pairwise_de(data, labels, rc)
    got = engine.pairwise_de(data, labels, config_from_reference(rc.to_json()),
                             device="cpu")
    assert got.cluster_names == ref.cluster_names
    _assert_logp(got.log_p.numpy(), ref.log_p)
    # no entry sits within the tolerance of the BH threshold: the masks
    # are the same
    np.testing.assert_array_equal(got.de_mask.numpy(),
                                  np.asarray(ref.de_mask))
    np.testing.assert_array_equal(got.tested.numpy(), np.asarray(ref.tested))
    assert sorted(got.aux) == sorted(ref.aux)
    np.testing.assert_array_equal(got.aux["funnel_gate_full"].numpy(),
                                  np.asarray(ref.aux["funnel_gate_full"]))
    if method == "roc":
        # U is an exact integer or half on both sides
        for k in ("auc", "power"):
            np.testing.assert_allclose(got.aux[k].numpy(),
                                       np.asarray(ref.aux[k]), rtol=0,
                                       atol=1e-6)
    else:
        # the flush drops hundreds of the most significant entries
        # (ROADMAP C9); both packages drop the same ones
        assert int(np.isneginf(np.asarray(ref.log_p)).sum()) > 100


@pytest.mark.parametrize("method", ["bimod", "t"])
def test_truth_labels_call_no_genes_in_either_package(flagship, method):
    # every tested entry of the planted clusters has p < FLT_MIN, so BH
    # masks them all and refine stops at an empty union (ROADMAP C9)
    data, labels = flagship["data"], flagship["truth"]
    rc = RefConfig(method=method)
    ref = ref_engine.pairwise_de(data, labels, rc)
    cfg = config_from_reference(rc.to_json())
    got = engine.pairwise_de(data, labels, cfg, device="cpu")
    tested = np.asarray(ref.tested)
    assert tested.sum() > 0
    assert np.isneginf(np.asarray(ref.log_p)[tested]).all()
    assert np.isneginf(got.log_p.numpy()[tested]).all()
    assert int(np.asarray(ref.de_mask).sum()) == 0
    assert int(got.de_mask.sum()) == 0
    with pytest.raises(ValueError, match="union has 0 genes"):
        ref_refine(data, labels, rc, mesh=None)
    with pytest.raises(ValueError, match="union has 0 genes"):
        port.refine(data, labels, cfg, device="cpu")
