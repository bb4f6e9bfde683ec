"""The port's fast-Wilcoxon ``refine()`` end to end against the JAX
package on the CPU, on the verify recipe (synthetic_scrna(300, 800, 5,
seed=7), a supervised and an unsupervised noisy labeling, their automated
consensus). The reference's ``recluster_de_consensus_fast`` config and its
PCA projection cross through ``carry``, and the port's ``refine`` runs
them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import scconsensus_tpu as ref_pkg
import scconsensus_tpu_torch as port
from scconsensus_tpu.config import ReclusterConfig as RefConfig
from scconsensus_tpu.obs.regress import adjusted_rand_index
from scconsensus_tpu.utils.synthetic import noisy_labeling, synthetic_scrna
from scconsensus_tpu_torch.carry import (
    config_from_reference,
    omega_from_reference,
)


@pytest.fixture(scope="module")
def runs():
    data, truth, _ = synthetic_scrna(n_genes=300, n_cells=800, n_clusters=5,
                                     seed=7)
    sup = noisy_labeling(truth, 0.05, n_out_clusters=3, seed=1, prefix="T")
    uns = noisy_labeling(truth, 0.10, seed=2, prefix="L")
    cons_r = ref_pkg.plot_contingency_table(sup, uns)
    cons = port.plot_contingency_table(sup, uns)
    ref = ref_pkg.recluster_de_consensus_fast(data, cons_r, q_val_thrs=0.1,
                                              mesh=None)
    # the config that call builds, carried across as its JSON string: the
    # port runs exactly what the reference ran
    ref_cfg = RefConfig(method="wilcox", q_val_thrs=0.1)
    cfg = config_from_reference(ref_cfg.to_json())
    # the reference's embed draws its projection from PRNGKey(0) at
    # (|union|, min(n_pcs + 10, |union|, N)) (scconsensus_tpu/ops/pca.py)
    f = ref.de_gene_union_idx.size
    omega = np.asarray(jax.random.normal(
        jax.random.PRNGKey(0),
        (f, min(ref_cfg.n_pcs + 10, f, data.shape[1])), jnp.float32))
    got = port.refine(data, cons, cfg, device="cpu",
                      omega=omega_from_reference(omega))
    return dict(cons_r=cons_r, cons=cons, ref=ref, got=got, cfg=cfg)


def test_consensus_and_config_cross_unchanged(runs):
    np.testing.assert_array_equal(runs["cons"], runs["cons_r"])
    # the carried config is the one the port's own fast entry point builds
    assert runs["cfg"] == port.ReclusterConfig(q_val_thrs=0.1)


def test_union_identical(runs):
    np.testing.assert_array_equal(runs["got"].de_gene_union_idx,
                                  runs["ref"].de_gene_union_idx)
    np.testing.assert_array_equal(runs["got"].de.de_mask.numpy(),
                                  np.asarray(runs["ref"].de.de_mask))


def test_cuts_agree_per_deep_split(runs):
    ref, got = runs["ref"], runs["got"]
    assert got.dynamic_labels.keys() == ref.dynamic_labels.keys()
    for key in ref.dynamic_labels:
        a, b = got.dynamic_labels[key], ref.dynamic_labels[key]
        assert adjusted_rand_index(a, b) == 1.0, key
        np.testing.assert_array_equal(got.dynamic_colors[key],
                                      ref.dynamic_colors[key])


def test_embedding_and_tree_within_tolerance(runs):
    ref, got = runs["ref"], runs["got"]
    sign = np.sign(np.sum(got.embedding * ref.embedding, axis=0))
    # float32 subspace iteration on both sides: the trailing noise
    # components have near-tied singular values, which amplify float32
    # rounding; held at 1e-4 of the largest |score|
    scale = float(np.abs(ref.embedding).max())
    np.testing.assert_allclose(got.embedding * sign, ref.embedding,
                               rtol=0, atol=1e-4 * scale)
    # Ward heights from those scores (native NN-chain on both sides): the
    # well-separated signal components set the merge heights
    np.testing.assert_allclose(got.cell_tree.height, ref.cell_tree.height,
                               rtol=0, atol=1e-4)
    assert got.metrics["tree_engine"] == "native"


def test_silhouettes_and_nodg(runs):
    ref, got = runs["ref"], runs["got"]
    for g, r in zip(got.deep_split_info, ref.deep_split_info):
        assert g["deep_split"] == r["deep_split"]
        assert g["n_clusters"] == r["n_clusters"]
        # float32 distance sums over 800 cells in another order
        assert abs(g["silhouette"] - r["silhouette"]) <= 1e-4
    np.testing.assert_array_equal(got.nodg, ref.nodg)
    walls = got.metrics["stage_walls_s"]
    for stage in ("de", "wilcox_test", "union", "embed", "tree", "cuts",
                  "silhouette", "nodg"):
        assert walls[stage] >= 0.0
