"""The reference's test oracles in the port, held against the JAX
package: ``rank_sum_groups`` (ops/ranks.py), the naive tree-cut twin
``cutree_hybrid_direct`` (ops/treecut_direct.py) and the direct per-pair
NB engine ``run_edger_pairs`` (de/edger_direct.py), plus the production
engines they are the oracles of, with the reference's own bars."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import spearmanr

from scconsensus_tpu.de.edger_direct import run_edger_pairs as ref_direct
from scconsensus_tpu.de.engine import _bucket_pairs as ref_buckets
from scconsensus_tpu.ops.linkage import ward_linkage as ref_ward
from scconsensus_tpu.ops.ranks import rank_sum_groups as ref_rank_sum
from scconsensus_tpu.ops.treecut_direct import (
    cutree_hybrid_direct as ref_cut_direct,
)
from scconsensus_tpu_torch import ReclusterConfig
from scconsensus_tpu_torch.de.edger_direct import (
    _bucket_pairs,
    run_edger_pairs,
)
from scconsensus_tpu_torch.de.engine import pairwise_de
from scconsensus_tpu_torch.ops.linkage import HClustTree, ward_linkage
from scconsensus_tpu_torch.ops.ranks import rank_sum_groups
from scconsensus_tpu_torch.ops.treecut import cutree_hybrid
from scconsensus_tpu_torch.ops.treecut_direct import cutree_hybrid_direct


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# rank_sum_groups
# --------------------------------------------------------------------------

@pytest.mark.parametrize("ties", ["integers", "continuous"])
@pytest.mark.parametrize("mask_rank", [1, 2])
def test_rank_sum_groups_equals_the_reference(ties, mask_rank):
    """Midrank sums are halves and tie sums integers, exact in float32:
    the two packages agree exactly."""
    rng = np.random.default_rng(3 + mask_rank)
    B, n = 40, 90
    x = (rng.integers(0, 6, (B, n)).astype(np.float32) if ties == "integers"
         else rng.normal(size=(B, n)).astype(np.float32))
    grp = rng.integers(0, 3, n if mask_rank == 1 else (B, n))
    g1, g2 = grp == 0, grp == 1
    got = rank_sum_groups(torch.from_numpy(x), torch.from_numpy(g1),
                          torch.from_numpy(g2))
    want = ref_rank_sum(jnp.asarray(x), jnp.asarray(g1), jnp.asarray(g2))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_rank_sum_groups_is_r_rank_sum():
    """R's ``sum(rank(c(x, y))[seq_along(x)])`` by hand: x = (1, 2),
    y = (2, 3); pooled midranks 1, 2.5, 2.5, 4; one tie run of 2."""
    v = torch.tensor([[1.0, 2.0, 2.0, 3.0, 9.0]])
    g1 = torch.tensor([True, True, False, False, False])
    g2 = torch.tensor([False, False, True, True, False])
    rs, ties = rank_sum_groups(v, g1, g2)
    assert float(rs) == 3.5 and float(ties) == 6.0


# --------------------------------------------------------------------------
# cutree_hybrid_direct (tests/test_treecut.py's cases)
# --------------------------------------------------------------------------

def _mixed(seed):
    rng = np.random.default_rng(seed)
    parts = [
        rng.normal((0, 0), 0.8, size=(60, 2)),
        rng.normal((6, 0), 1.6, size=(25, 2)),
        rng.normal((0, 7), 0.5, size=(90, 2)),
        np.stack([np.linspace(10, 16, 40), rng.normal(0, 0.3, 40)], axis=1),
        rng.uniform(-4, 18, size=(15, 2)),
    ]
    return np.concatenate(parts).astype(np.float32)


def _both_trees(x):
    """The reference's Ward tree, and the same tree as the port's type."""
    ref = ref_ward(x)
    return ref, HClustTree(merge=np.asarray(ref.merge),
                           height=np.asarray(ref.height),
                           order=np.asarray(ref.order))


@pytest.mark.parametrize("deep_split", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("pam", [False, True])
def test_cut_direct_matches_the_reference_and_the_cut(deep_split, pam):
    """Labels equal: the port's oracle against the reference's oracle on
    the reference's tree, and against the port's production cut (the
    reference's ``test_matches_naive_oracle`` geometry)."""
    x = _mixed(deep_split * 2 + int(pam))
    ref_tree, tree = _both_trees(x)
    for mcs in (5, 12):
        kw = dict(deep_split=deep_split, min_cluster_size=mcs, pam_stage=pam)
        got = cutree_hybrid_direct(tree, x, **kw)
        np.testing.assert_array_equal(got, ref_cut_direct(ref_tree, x, **kw))
        np.testing.assert_array_equal(got, cutree_hybrid(tree, x, **kw))


def test_cut_direct_large_random_tree():
    """800 unstructured points: a deep, tie-rich tree (the reference's
    ``test_matches_naive_oracle_large_random``), built by the port."""
    rng = np.random.default_rng(99)
    x = rng.normal(size=(800, 5)).astype(np.float32)
    x[200:420] += (4.0, 0, 0, 0, 0)
    x[420:520] *= 0.3
    ref_tree, _ = _both_trees(x)
    tree = ward_linkage(x)
    for ds in (1, 3):
        got = cutree_hybrid_direct(tree, x, deep_split=ds,
                                   min_cluster_size=15)
        np.testing.assert_array_equal(
            got, cutree_hybrid(tree, x, deep_split=ds, min_cluster_size=15))
        np.testing.assert_array_equal(
            cutree_hybrid_direct(_both_trees(x)[1], x, deep_split=ds,
                                 min_cluster_size=15),
            ref_cut_direct(ref_tree, x, deep_split=ds, min_cluster_size=15))


def test_cut_direct_cut_height_and_pam_dist():
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.normal(loc=c, scale=1.2, size=(30, 2))
                        for c in ((0, 0), (8, 0), (0, 9))]).astype(np.float32)
    ref_tree, tree = _both_trees(x)
    hmax = float(tree.height[-1])
    for ch in (0.5 * hmax, 0.9 * hmax, None):
        for mpd in (None, 2.0):
            kw = dict(deep_split=2, min_cluster_size=10, cut_height=ch,
                      pam_stage=True, max_pam_dist=mpd)
            got = cutree_hybrid_direct(tree, x, **kw)
            np.testing.assert_array_equal(
                got, ref_cut_direct(ref_tree, x, **kw))
            np.testing.assert_array_equal(got, cutree_hybrid(tree, x, **kw))


def test_cut_direct_refuses_a_bad_deep_split():
    _, tree = _both_trees(_mixed(0))
    with pytest.raises(ValueError, match="deep_split"):
        cutree_hybrid_direct(tree, _mixed(0), deep_split=5)


# --------------------------------------------------------------------------
# run_edger_pairs (de/edger_direct.py)
# --------------------------------------------------------------------------

def _nb_case(G=300, sizes=(70, 90, 55), phi=0.4, seed=42):
    """The reference's ``tests/test_edger_parity.py`` matrix: planted DE
    blocks per cluster, per-cell depth variation."""
    rng = np.random.default_rng(seed)
    K = len(sizes)
    r = 1.0 / phi
    base = rng.uniform(1.0, 12.0, size=(G, 1))
    mu = np.tile(base, (1, K))
    for k in range(K):
        mu[k * 40: (k + 1) * 40, k] *= 4.0
    cols, cid = [], []
    for k, n in enumerate(sizes):
        depth = rng.uniform(0.6, 1.6, size=n)
        m = mu[:, [k]] * depth[None, :]
        cols.append(rng.negative_binomial(r, r / (r + m)).astype(np.float32))
        cid += [k] * n
    counts = np.concatenate(cols, axis=1)
    cid = np.array(cid, np.int32)
    cell_idx_of = [np.nonzero(cid == k)[0].astype(np.int32)
                   for k in range(K)]
    pi, pj = (a.astype(np.int32) for a in np.triu_indices(K, k=1))
    return counts, cell_idx_of, pi, pj


@pytest.fixture(scope="module")
def nb_runs():
    counts, cell_idx_of, pi, pj = _nb_case()
    G = counts.shape[0]
    ref = ref_direct(counts, ref_buckets(cell_idx_of, pi, pj), G, pi.size)
    got = run_edger_pairs(counts, _bucket_pairs(cell_idx_of, pi, pj), G,
                          pi.size, device="cpu")
    # the production engine as refine() calls it: pairwise_de with
    # method="edger" in compat mode, which hands the matrix over as counts
    labels = np.repeat([f"k{k}" for k in range(len(cell_idx_of))],
                       [g.size for g in cell_idx_of])
    engine = pairwise_de(counts, labels, ReclusterConfig(method="edger"),
                         device="cpu")
    return ref, got, engine


def test_buckets_equal_the_reference():
    _, cell_idx_of, pi, pj = _nb_case()
    for a, b in zip(_bucket_pairs(cell_idx_of, pi, pj),
                    ref_buckets(cell_idx_of, pi, pj)):
        for f in ("rows", "cell_idx", "mask1", "mask2", "n1", "n2"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_edger_direct_equals_the_reference(nb_runs):
    """The same NB arithmetic over torch's lgamma, exp and QR-free sums:
    float32 agreement, not bits. Common dispersion within 1e-4 relative,
    tagwise within 1e-3, log fc within 1e-5 absolute, log p within 2e-4
    relative or 2e-3 absolute (the edgeR tolerance of the card-against-CPU
    checks) and the same finite pattern."""
    ref, got, _ = nb_runs
    np.testing.assert_allclose(got.common_disp, ref.common_disp, rtol=1e-4)
    np.testing.assert_allclose(got.tagwise_disp, ref.tagwise_disp,
                               rtol=1e-3)
    np.testing.assert_allclose(got.log_fc, ref.log_fc, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(np.isfinite(got.log_p),
                                  np.isfinite(ref.log_p))
    fin = np.isfinite(ref.log_p)
    np.testing.assert_allclose(got.log_p[fin], ref.log_p[fin], rtol=2e-4,
                               atol=2e-3)


def test_edger_engine_against_the_direct_oracle(nb_runs):
    """The port's ``pairwise_de(method="edger")`` against the port's
    oracle, at the
    reference's statistical bars (tests/test_edger_parity.py: common
    dispersion within a factor of 2, tagwise log-correlation > 0.6, log p
    Spearman > 0.95 per pair, DE calls agreeing on > 95 % of entries,
    planted fold changes within a median 0.2)."""
    _, old, de = nb_runs
    new_cd = de.aux["common_dispersion"].numpy()
    ratio = new_cd / np.maximum(old.common_disp, 1e-8)
    assert np.all((ratio > 0.5) & (ratio < 2.0)), ratio
    lt_new = np.log(np.maximum(de.aux["tagwise_dispersion"].numpy(),
                               1e-8)).ravel()
    lt_old = np.log(np.maximum(old.tagwise_disp, 1e-8)).ravel()
    m = np.isfinite(lt_new) & np.isfinite(lt_old)
    assert np.corrcoef(lt_new[m], lt_old[m])[0, 1] > 0.6
    lp_new = de.log_p.numpy()
    for p in range(lp_new.shape[0]):
        m = np.isfinite(lp_new[p]) & np.isfinite(old.log_p[p])
        assert spearmanr(lp_new[p][m], old.log_p[p][m]).statistic > 0.95
    thr = np.log(0.01 / lp_new.shape[1])
    assert np.nanmean((lp_new < thr) == (old.log_p < thr)) > 0.95
    fc_new = de.log_fc.numpy()
    m = np.isfinite(fc_new) & np.isfinite(old.log_fc)
    big = m & (np.abs(old.log_fc) > np.log(2.0))
    assert np.median(np.abs(fc_new[big] - old.log_fc[big])) < 0.2


def test_edger_direct_takes_sparse_input(nb_runs):
    """A scipy.sparse matrix gives the dense run's numbers (gene chunks
    densified on demand)."""
    import scipy.sparse as sp

    counts, cell_idx_of, pi, pj = _nb_case()
    got = run_edger_pairs(sp.csr_matrix(counts),
                          _bucket_pairs(cell_idx_of, pi, pj),
                          counts.shape[0], pi.size, device="cpu")
    dense = nb_runs[1]
    for f in ("log_p", "log_fc", "common_disp", "tagwise_disp"):
        np.testing.assert_array_equal(getattr(got, f), getattr(dense, f))
