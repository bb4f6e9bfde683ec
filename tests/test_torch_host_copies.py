"""The port's copies of the reference's host modules give the reference's
arrays on the same inputs (numpy in, numpy out: equality, not tolerance,
except where stated)."""

import os

import numpy as np
import pytest
import torch

from scconsensus_tpu.consensus import contingency as ref_ctg
from scconsensus_tpu.io import sparsemat as ref_sparse
from scconsensus_tpu.ops import colors as ref_colors
from scconsensus_tpu.ops import linkage as ref_linkage
from scconsensus_tpu.ops import treecut as ref_treecut
from scconsensus_tpu.ops import wilcoxon as ref_wilcoxon
from scconsensus_tpu.utils import synthetic as ref_synth
from scconsensus_tpu_torch.consensus import contingency
from scconsensus_tpu_torch.io import sparsemat
from scconsensus_tpu_torch.ops import colors, linkage, treecut, wilcoxon
from scconsensus_tpu_torch.utils import synthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _labelings(seed):
    rng = np.random.default_rng(seed)
    truth = rng.integers(0, 6, 900)
    a = ref_synth.noisy_labeling(truth, 0.05, seed=seed, prefix="A")
    b = ref_synth.noisy_labeling(truth, 0.10, n_out_clusters=4,
                                 seed=seed + 1, prefix="B")
    return a, b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_contingency_and_automated_consensus_equal(seed):
    a, b = _labelings(seed)
    r = ref_ctg.contingency_table(a, b)
    p = contingency.contingency_table(a, b)
    np.testing.assert_array_equal(p.matrix, r.matrix)
    np.testing.assert_array_equal(p.row_labels, r.row_labels)
    np.testing.assert_array_equal(p.col_labels, r.col_labels)
    for mcs in (5, 10, 40):
        np.testing.assert_array_equal(
            contingency.automated_consensus(a, b, min_clust_size=mcs),
            ref_ctg.automated_consensus(a, b, min_clust_size=mcs))
    np.testing.assert_array_equal(
        contingency.plot_contingency_table(b, a),
        ref_ctg.plot_contingency_table(b, a))


def test_labels_to_colors_equal():
    lab = np.array([0, -1, 1, 2, 50, 51, 120, 7])
    np.testing.assert_array_equal(colors.labels_to_colors(lab),
                                  ref_colors.labels_to_colors(lab))


def _blobs(n=240, d=5, k=4, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=6.0, size=(k, d))
    lab = rng.integers(0, k, n)
    return (centers[lab] + rng.normal(size=(n, d))).astype(np.float32)


@pytest.mark.parametrize("native", [True, False])
def test_ward_linkage_equal_native_and_numpy(native):
    pts = _blobs(seed=1)
    r = ref_linkage.ward_linkage(pts, use_native=native)
    p = linkage.ward_linkage(pts, use_native=native)
    assert linkage.LAST_ENGINE == ("native" if native else "numpy")
    np.testing.assert_array_equal(p.merge, r.merge)
    np.testing.assert_array_equal(p.order, r.order)
    # the same chain arithmetic; 1e-10 covers FMA contraction differences
    np.testing.assert_allclose(p.height, r.height, rtol=0, atol=1e-10)


def test_ward_source_is_the_reference_source():
    with open(os.path.join(REPO, "scconsensus_tpu", "native", "ward.cpp"),
              "rb") as f:
        ref_src = f.read()
    with open(os.path.join(REPO, "scconsensus_tpu_torch", "native",
                           "ward.cpp"), "rb") as f:
        assert f.read() == ref_src


@pytest.mark.parametrize("pam", [False, True])
def test_cutree_hybrid_equal(pam):
    pts = _blobs(n=300, k=5, seed=2)
    tree = ref_linkage.ward_linkage(pts)
    ptree = linkage.HClustTree(tree.merge, tree.height, tree.order)
    for ds in range(5):
        for mcs in (5, 10, 20):
            np.testing.assert_array_equal(
                treecut.cutree_hybrid(ptree, pts, deep_split=ds,
                                      min_cluster_size=mcs, pam_stage=pam),
                ref_treecut.cutree_hybrid(tree, pts, deep_split=ds,
                                          min_cluster_size=mcs,
                                          pam_stage=pam))


@pytest.mark.parametrize("n1,n2", [(3, 4), (12, 30), (49, 49), (7, 1)])
def test_wilcoxon_exact_host_equal(n1, n2):
    u = np.arange(0, n1 * n2 + 1, dtype=np.float64)
    np.testing.assert_array_equal(
        wilcoxon.wilcoxon_exact_host(u, n1, n2),
        ref_wilcoxon.wilcoxon_exact_host(u, n1, n2))
    assert wilcoxon.EXACT_N_LIMIT == ref_wilcoxon.EXACT_N_LIMIT


@pytest.mark.parametrize("kw", [
    dict(n_genes=300, n_cells=800, n_clusters=5, seed=7),
    dict(n_genes=120, n_cells=333, n_clusters=3, seed=11,
         log_normalize=False),
])
def test_synthetic_scrna_bytes_equal(kw):
    for a, b in zip(synthetic.synthetic_scrna(**kw),
                    ref_synth.synthetic_scrna(**kw)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    truth = ref_synth.synthetic_scrna(**kw)[1]
    for args in ((0.05, None, 1, "T"), (0.1, 2, 2, "L")):
        np.testing.assert_array_equal(
            synthetic.noisy_labeling(truth, *args),
            ref_synth.noisy_labeling(truth, *args))


def test_device_generator_keeps_the_planted_structure():
    # the card draws other random numbers than numpy; what must match is
    # the planted part (labels, markers) and the value distribution
    kw = dict(n_genes=200, n_cells=400, n_clusters=4, seed=5)
    d, lab, mask = synthetic.synthetic_scrna_device(device="cpu", **kw)
    h, hlab, hmask = ref_synth.synthetic_scrna(**kw)
    np.testing.assert_array_equal(lab, hlab)
    np.testing.assert_array_equal(mask, hmask)
    d = d.numpy()
    assert d.shape == h.shape and d.dtype == np.float32
    assert np.isfinite(d).all() and d.min() >= 0
    assert abs((d > 0).mean() - (h > 0).mean()) < 0.02
    assert abs(d.mean() - h.mean()) < 0.05 * h.mean()


def test_rows_dense_and_nodg_equal():
    data = ref_synth.synthetic_scrna(n_genes=60, n_cells=90, n_clusters=3,
                                     n_markers_per_cluster=10, seed=4)[0]
    idx = np.array([5, 0, 59, 17])
    t = torch.from_numpy(data)
    np.testing.assert_array_equal(sparsemat.rows_dense(t, idx).numpy(),
                                  ref_sparse.rows_dense(data, idx))
    np.testing.assert_array_equal(sparsemat.nodg(t), ref_sparse.nodg(data))
