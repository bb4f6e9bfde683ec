"""The port's Wilcoxon DE engine against the JAX package's, on the CPU.

The JAX side runs on CPU, where it takes its CPU forms (segment-sum
aggregates, the run-space rank-sum kernel). Each port function is held
against both of the reference's forms where the reference has two.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scconsensus_tpu.config import ReclusterConfig as RefConfig
from scconsensus_tpu.de import engine as ref_engine
from scconsensus_tpu.ops import gates as ref_gates
from scconsensus_tpu.ops import multipletests as ref_mt
from scconsensus_tpu.ops import ranksum_allpairs as ref_rs
from scconsensus_tpu.ops import wilcoxon as ref_wx
from scconsensus_tpu.utils.synthetic import synthetic_scrna
from scconsensus_tpu_torch.carry import config_from_reference
from scconsensus_tpu_torch.de import engine
from scconsensus_tpu_torch.ops import gates, multipletests, ranksum_allpairs
from scconsensus_tpu_torch.ops import wilcoxon

# log-p tolerance: both sides evaluate the same float32 formula from the
# same (exact) U and tie sums; jax's norm.logcdf and torch's log_ndtr are
# different implementations of the normal tail, a few ulps apart.
LOGP_RTOL, LOGP_ATOL = 1e-5, 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _ranksum_case(kind):
    """(chunk, cid, n_of, pair_i, pair_j, K). All rank statistics are
    integers or halves below 2**24, so U and the tie sums are exact on
    both sides whatever the summation order."""
    rng = np.random.default_rng({"ties": 3, "continuous": 4}[kind])
    G, N, K = 10, 240, 4
    if kind == "ties":   # small integers, half zeros: long tie runs
        x = rng.integers(0, 4, (G, N)) * (rng.random((G, N)) < 0.5)
    else:                # distinct positives with a zero block
        x = rng.gamma(2.0, 1.0, (G, N)) * (rng.random((G, N)) < 0.4)
    cid = rng.integers(-1, K, N).astype(np.int32)   # -1 = excluded cells
    n_of = np.bincount(cid[cid >= 0], minlength=K).astype(np.int32)
    pi, pj = np.triu_indices(K, 1)
    return (x.astype(np.float32), cid, n_of, pi.astype(np.int32),
            pj.astype(np.int32), K)


@pytest.mark.parametrize("kind", ["ties", "continuous"])
@pytest.mark.parametrize("window", [0, 128])
@pytest.mark.parametrize("ref_cpu_forms", [True, False])
@pytest.mark.parametrize("port_cpu_forms", [True, False])
def test_ranksum_body_matches_reference(kind, window, ref_cpu_forms,
                                        port_cpu_forms):
    x, cid, n_of, pi, pj, K = _ranksum_case(kind)
    assert (x > 0).sum(axis=1).max() <= 128  # every gene fits the window
    ref = ref_rs.ranksum_body(
        jnp.asarray(x), jnp.asarray(cid), jnp.asarray(n_of),
        jnp.asarray(pi), jnp.asarray(pj), K, window=window,
        cpu_forms=ref_cpu_forms)
    got = ranksum_allpairs.ranksum_body(
        _t(x), _t(cid), _t(n_of), _t(pi), _t(pj), K, window=window,
        cpu_forms=port_cpu_forms)
    lp_r, u_r, ts_r = (np.asarray(a) for a in ref)
    lp, u, ts = (a.numpy() for a in got)
    np.testing.assert_array_equal(u, u_r)
    np.testing.assert_array_equal(ts, ts_r)
    np.testing.assert_allclose(lp, lp_r, rtol=LOGP_RTOL, atol=LOGP_ATOL)


def test_chunk_genes_for_budget_matches_reference():
    for n, k in ((26000, 44), (800, 8), (100000, 80), (10, 2)):
        assert ranksum_allpairs.chunk_genes_for_budget(n, k) == \
            ref_rs.chunk_genes_for_budget(n, k)
    assert engine._window_floor(26000) == ref_engine._window_floor(26000)
    assert engine._window_floor(10 ** 6) == ref_engine._window_floor(10 ** 6)


def test_wilcoxon_from_ranks_matches_reference():
    rng = np.random.default_rng(0)
    n1 = rng.integers(0, 60, 400).astype(np.float32)
    n2 = rng.integers(0, 60, 400).astype(np.float32)
    n = n1 + n2
    rs1 = (rng.random(400) * n1 * (n + 1)).astype(np.float32)
    ties = np.where(rng.random(400) < 0.3, 0.0,
                    rng.random(400) * n ** 3 * 0.5).astype(np.float32)
    ties[:5] = (n[:5] ** 3 - n[:5])  # all tied: zero variance → NaN
    lp_r, u_r = ref_wx.wilcoxon_from_ranks(
        jnp.asarray(rs1), jnp.asarray(ties), jnp.asarray(n1),
        jnp.asarray(n2))
    lp, u = wilcoxon.wilcoxon_from_ranks(_t(rs1), _t(ties), _t(n1), _t(n2))
    np.testing.assert_array_equal(u.numpy(), np.asarray(u_r))
    lp_r = np.asarray(lp_r)
    assert np.isnan(lp_r).any()
    np.testing.assert_array_equal(np.isnan(lp.numpy()), np.isnan(lp_r))
    np.testing.assert_allclose(lp.numpy(), lp_r, rtol=LOGP_RTOL,
                               atol=LOGP_ATOL)


@pytest.mark.parametrize("seed", [1, 2])
def test_bh_adjust_masked_matches_reference(seed):
    rng = np.random.default_rng(seed)
    lp = np.log(rng.random((12, 300))).astype(np.float32) * 3
    lp[rng.random(lp.shape) < 0.05] = np.nan
    lp[0, :10] = lp[0, 10]  # tied p-values
    mask = rng.random(lp.shape) < 0.7
    mask[1] = False  # a row with nothing to adjust
    ref = np.asarray(ref_mt.bh_adjust_masked(jnp.asarray(lp),
                                             jnp.asarray(mask)))
    got = multipletests.bh_adjust_masked(_t(lp), _t(mask)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    # same float32 ops in the same order; sorts agree on every tie
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def _agg_case():
    data = synthetic_scrna(n_genes=120, n_cells=300, n_clusters=4, seed=2,
                           n_markers_per_cluster=20)[0]
    cid = np.random.default_rng(5).integers(-1, 6, 300).astype(np.int32)
    return data, cid, 6


@pytest.mark.parametrize("port_form", ["segment", "matmul"])
@pytest.mark.parametrize("ref_form", ["segment", "matmul"])
def test_aggregates_match_reference(port_form, ref_form):
    data, cid, K = _agg_case()
    if ref_form == "segment":  # the reference's CPU form
        ref = ref_gates.compute_aggregates_cid(jnp.asarray(data),
                                               jnp.asarray(cid), K)
    else:                      # its accelerator form: one-hot products
        onehot = (cid[:, None] == np.arange(K)[None, :]).astype(np.float32)
        ref = ref_gates.compute_aggregates(jnp.asarray(data),
                                           jnp.asarray(onehot))
    got = gates.compute_aggregates_cid(_t(data), _t(cid), K, form=port_form)
    for f in ("sum_log", "sum_expm1", "sum_sq", "nnz", "counts"):
        # float32 sums of ≤300 terms taken in another order
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    np.testing.assert_array_equal(got.nnz.numpy(), np.asarray(ref.nnz))


@pytest.mark.parametrize("only_pos", [False, True])
@pytest.mark.parametrize("min_diff_pct", [-float("inf"), 5.0])
def test_pair_gates_fast_matches_reference(only_pos, min_diff_pct):
    data, cid, K = _agg_case()
    ref_agg = ref_gates.compute_aggregates_cid(jnp.asarray(data),
                                               jnp.asarray(cid), K)
    agg = gates.ClusterAggregates(*(_t(np.asarray(a)) for a in (
        ref_agg.sum_log, ref_agg.sum_expm1, ref_agg.sum_sq, ref_agg.nnz,
        ref_agg.counts)))
    pi, pj = np.triu_indices(K, 1)
    kw = dict(min_pct=20.0, min_diff_pct=min_diff_pct, log_fc_thrs=0.25,
              mean_exprs_thrs=0.0, pseudocount=1.0, only_pos=only_pos)
    ref = ref_gates.pair_gates_fast(ref_agg, jnp.asarray(pi),
                                    jnp.asarray(pj), **kw)
    got = gates.pair_gates_fast(agg, _t(pi), _t(pj), **kw)
    # the same aggregates go in; only elementwise float32 log/expm1 differ
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-6)


def _de_case():
    """The SKILL recipe's data with two clusters cut below 50 cells, so
    their pair takes R's exact branch (26 of its genes are tie-free)."""
    data, truth, _ = synthetic_scrna(n_genes=300, n_cells=800, n_clusters=5,
                                     seed=7)
    labels = np.array([f"c{t}" for t in truth])
    labels[np.nonzero(truth == 0)[0][:30]] = "s0"
    labels[np.nonzero(truth == 1)[0][:40]] = "s1"
    return data, labels


def _union_diff_reason(log_fc, de_mask, a, b, n_top):
    """None when the unions agree; otherwise a message naming the genes
    that differ and whether each is a |logFC| tie at some pair's top-k
    boundary (the one accepted difference)."""
    diff = sorted(set(a.tolist()) ^ set(b.tolist()))
    if not diff:
        return None
    ties = set()
    for p in range(de_mask.shape[0]):
        fc = np.where(de_mask[p], np.abs(log_fc[p]), -np.inf)
        k = min(n_top, fc.size)
        kth = np.sort(fc)[::-1][k - 1]
        if np.isfinite(kth) and (fc == kth).sum() > 1:
            ties |= set(np.nonzero(fc == kth)[0].tolist())
    untied = [g for g in diff if g not in ties]
    return f"union differs at {diff}; not boundary ties: {untied}"


def test_pairwise_de_wilcox_matches_reference():
    data, labels = _de_case()
    ref_cfg = RefConfig()
    cfg = config_from_reference(ref_cfg.to_json())
    ref = ref_engine.pairwise_de(data, labels, ref_cfg, mesh=None)
    got = engine.pairwise_de(data, labels, cfg, device="cpu")
    assert got.cluster_names == ref.cluster_names
    np.testing.assert_array_equal(got.pair_i, ref.pair_i)
    np.testing.assert_array_equal(got.pair_skipped, ref.pair_skipped)

    # the exact branch ran: the (s0, s1) pair has tie-free genes
    names = got.cluster_names
    s0, s1 = names.index("s0"), names.index("s1")
    p = int(np.nonzero((got.pair_i == s0) & (got.pair_j == s1))[0][0])
    cells = np.nonzero(np.isin(labels, ["s0", "s1"]))[0]
    tie_free = [g for g in range(data.shape[0])
                if np.unique(data[g, cells]).size == cells.size]
    assert len(tie_free) > 0

    # U from the reference's own rank-sum driver (exact, < 2**24)
    idx_of = [np.nonzero(labels == n)[0].astype(np.int32) for n in names]
    _, u_ref = ref_engine._run_wilcox(data, idx_of, ref.pair_i, ref.pair_j)
    np.testing.assert_array_equal(got.u.numpy(), u_ref)

    tested = got.tested.numpy()
    np.testing.assert_array_equal(tested, np.asarray(ref.tested))
    lp, lp_r = got.log_p.numpy(), np.asarray(ref.log_p)
    np.testing.assert_array_equal(np.isnan(lp), np.isnan(lp_r))
    np.testing.assert_allclose(lp, lp_r, rtol=LOGP_RTOL, atol=LOGP_ATOL)
    assert np.isfinite(lp[p, tie_free]).any()
    # log_fc: segment sums of ≤800 float32 terms in another order
    np.testing.assert_allclose(got.log_fc.numpy(), np.asarray(ref.log_fc),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got.de_mask.numpy(),
                                  np.asarray(ref.de_mask))

    union = engine.de_gene_union(got, cfg.n_top_de_genes)
    union_r = ref_engine.de_gene_union(ref, ref_cfg.n_top_de_genes)
    reason = _union_diff_reason(np.asarray(ref.log_fc),
                                np.asarray(ref.de_mask), union, union_r,
                                cfg.n_top_de_genes)
    assert reason is None or "not boundary ties: []" in reason, reason
    assert union.size > 10


def test_pairwise_de_subsampling_matches_reference():
    data, labels = _de_case()
    ref_cfg = RefConfig(max_cells_per_ident=60, random_seed=3)
    ref = ref_engine.pairwise_de(data, labels, ref_cfg, mesh=None)
    got = engine.pairwise_de(data, labels,
                             config_from_reference(ref_cfg.to_json()),
                             device="cpu")
    np.testing.assert_allclose(got.log_p.numpy(), np.asarray(ref.log_p),
                               rtol=LOGP_RTOL, atol=LOGP_ATOL)
    np.testing.assert_array_equal(got.de_mask.numpy(),
                                  np.asarray(ref.de_mask))
