"""``refine()`` past ``approx_threshold`` in the port against the JAX
package on the CPU: the pooled silhouette estimator and the exact
single-cut silhouette on the same inputs, then the whole pipeline in its
pool, landmark (with ``landmark_verify``), kNN and Pearson branches and
at the threshold crossovers, on 3,000 cells × 300 genes with four
strongly separated planted clusters. The reference's config crosses as
its JSON string and its PCA projection as a numpy draw (``carry``), so
both sides run the same thing; each branch also runs once more with the
reference's PCA scores handed to the port, which holds the tree, cut and
silhouette stages on the same points. The reference reads landmark flags from the
environment; they are cleared so that both sides take the registered
defaults."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scconsensus_tpu as ref_pkg
import scconsensus_tpu_torch as port
from scconsensus_tpu.config import ReclusterConfig as RefConfig
from scconsensus_tpu.obs.regress import adjusted_rand_index
from scconsensus_tpu.ops import silhouette as ref_sil
from scconsensus_tpu.ops.pooling import kmeans_pool as ref_kmeans_pool
from scconsensus_tpu.utils.synthetic import synthetic_scrna
from scconsensus_tpu_torch.carry import config_from_reference, omega_from_reference
from scconsensus_tpu_torch.models import pipeline as port_pipeline
from scconsensus_tpu_torch.ops import silhouette as port_sil


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # the suite runs six workers on the machine's cores; two torch threads
    # a worker keep these small tensors from crowding out the other files
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

LANDMARK_FLAGS = ("SCC_TREE_LANDMARK_THRESHOLD", "SCC_TREE_LANDMARK_K",
                  "SCC_TREE_LANDMARK_C", "SCC_TREE_EXACT")

BRANCHES = {
    "pool": dict(approx_threshold=1000, n_pool_centroids=256),
    "landmark": dict(approx_threshold=1000, landmark_threshold=1000,
                     landmark_verify=True),
    "knn": dict(approx_threshold=1000, approx_method="knn"),
    "pearson": dict(distance="pearson"),
    "at_threshold": dict(approx_threshold=3000),
    "past_threshold": dict(approx_threshold=2999, n_pool_centroids=256),
    "at_landmark_threshold": dict(approx_threshold=1000,
                                  landmark_threshold=3000,
                                  n_pool_centroids=256),
}


def _blobs(n, seed, k=6, d=15):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=5.0, size=(k, d))
    lab = rng.integers(0, k, n)
    return (centers[lab] + rng.normal(size=(n, d))).astype(np.float32), lab


# --- the silhouette estimators on the same inputs --------------------------

def _labelings(lab, seed):
    """Three cuts of the same cells: the planted clusters; the same with
    6 % of cells excluded (−1) and two singletons; a coarser cut."""
    rng = np.random.default_rng(seed)
    a = lab.copy()
    b = lab.copy()
    b[rng.random(lab.size) < 0.06] = -1
    b[:2] = [97, 98]                       # two singleton clusters
    c = lab // 2
    return [a, b, c]


@pytest.mark.parametrize("sample", [None, 700], ids=["all", "sampled"])
@pytest.mark.parametrize("pool", ["given", "fitted"])
def test_pooled_silhouette_matches_the_reference(sample, pool):
    x, lab = _blobs(3000, seed=5)
    labs = _labelings(lab, seed=6)
    kw = dict(n_centroids=128, seed=2, sample=sample, block=1024)
    if pool == "given":
        cent, assign = ref_kmeans_pool(x, 128, seed=2)
        kw.update(centroids=cent, assign=assign)
    want = ref_sil.pooled_multi_cut_silhouette(x, labs, **kw)
    got = port_sil.pooled_multi_cut_silhouette(x, labs, device="cpu", **kw)
    for (g, g_per), (w, w_per) in zip(got, want):
        # float32 (b, m) @ (m, K) products in another order on each side
        assert abs(g - w) <= 1e-5
        assert g_per.keys() == w_per.keys()
        for key in w_per:
            assert abs(g_per[key] - w_per[key]) <= 1e-5
    single, _ = port_sil.pooled_mean_cluster_silhouette(
        x, labs[1], device="cpu", **kw)
    assert abs(single - want[1][0]) <= 1e-5


@pytest.mark.parametrize("case", ["planted", "excluded", "with_zero"])
def test_mean_cluster_silhouette_matches_the_reference(case):
    x, lab = _blobs(1500, seed=7)
    if case == "excluded":
        lab = np.where(np.random.default_rng(1).random(1500) < 0.1, -1, lab)
    elif case == "with_zero":
        lab = lab * (lab % 3 > 0)          # label 0 is a cluster too
    g, g_per = port.mean_cluster_silhouette(x, lab, device="cpu")
    w, w_per = ref_sil.mean_cluster_silhouette(x, lab, mesh=None)
    # the kernel's plain version (blocked a² + b² − 2ab, 1,500 terms a sum)
    assert abs(g - w) <= 1e-5
    assert g_per.keys() == w_per.keys()
    np.testing.assert_allclose(
        port_sil.silhouette_widths(x, lab, device="cpu"),
        ref_sil.silhouette_widths(x, lab), rtol=0, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adjusted_rand_index_equals_the_reference(seed):
    from scconsensus_tpu_torch.obs.regress import adjusted_rand_index as ari

    rng = np.random.default_rng(seed)
    a = rng.integers(0, 5, 400)
    b = np.where(rng.random(400) < 0.2, rng.integers(0, 7, 400), a)
    for x, y in ((a, b), (a, a), (a, np.zeros(400, int)), (b, a[::-1])):
        assert ari(x, y) == adjusted_rand_index(x, y)
    with pytest.raises(ValueError):
        ari(a, b[:-1])


def test_adjusted_rand_index_does_not_wrap_at_a_million_cells():
    from fractions import Fraction

    from scconsensus_tpu_torch.obs.regress import adjusted_rand_index as ari

    # two clusters of 500,000 against a 1 %-perturbed copy: the pair-count
    # sums are ~2.5e11, their product ~6e22 > 2^63
    rng = np.random.default_rng(0)
    a = np.repeat([0, 1], 500_000)
    b = np.where(rng.random(a.size) < 0.01, 1 - a, a)
    table = np.array([[np.sum((a == i) & (b == j)) for j in (0, 1)]
                      for i in (0, 1)], dtype=object)

    def c2(v):
        return v * (v - 1) // 2

    s_ij = sum(c2(int(v)) for v in table.ravel())
    s_a = sum(c2(int(v)) for v in table.sum(axis=1))
    s_b = sum(c2(int(v)) for v in table.sum(axis=0))
    exp = Fraction(s_a * s_b, c2(a.size))
    exact = float((s_ij - exp) / (Fraction(s_a + s_b, 2) - exp))
    got = ari(a, b)
    assert abs(got - exact) <= 1e-12 and 0.9 < got < 1.0


def test_planted_embedding_draws_the_bench_structure():
    from scconsensus_tpu_torch.utils.synthetic import planted_embedding_device

    x, lab, rng = planted_embedding_device(n_cells=5000, device="cpu")
    # the host draws of the reference bench's run_brain1m (bench.py:774-775)
    bench = np.random.default_rng(3)
    centers = bench.normal(scale=6.0, size=(24, 15))
    np.testing.assert_array_equal(lab, bench.integers(0, 24, 5000))
    assert x.shape == (5000, 15) and x.dtype == torch.float32
    noise = x.numpy() - centers[lab].astype(np.float32)
    assert abs(float(noise.mean())) < 0.05
    assert abs(float(noise.std()) - 1.0) < 0.05
    # the generator goes on as the bench's does (its silhouette sample)
    np.testing.assert_array_equal(rng.choice(5000, 50, replace=False),
                                  bench.choice(5000, 50, replace=False))


# --- refine end to end ------------------------------------------------------

@pytest.fixture(scope="module")
def data():
    d, truth, _ = synthetic_scrna(n_cells=3000, n_genes=300, n_clusters=4,
                                  n_markers_per_cluster=25, marker_log_fc=3.0,
                                  nb_dispersion=0.2, seed=4)
    return d, np.array([f"c{v}" for v in truth]), truth


@pytest.fixture(scope="module")
def runs(data):
    """Per branch: the reference's run, the port's run with its own embed,
    and the port's run handed the reference's embedding (its PCA scores),
    so that the stages this file is about start from the same points."""
    x, labels, truth = data
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for flag in LANDMARK_FLAGS:
            mp.delenv(flag, raising=False)
        for name, kw in BRANCHES.items():
            ref = ref_pkg.recluster_de_consensus_fast(
                x, labels, q_val_thrs=0.1, mesh=None, **kw)
            cfg = config_from_reference(
                RefConfig(method="wilcox", q_val_thrs=0.1, **kw).to_json())
            f = ref.de_gene_union_idx.size
            omega = np.asarray(jax.random.normal(
                jax.random.PRNGKey(0),
                (f, min(cfg.n_pcs + 10, f, x.shape[1])), jnp.float32))
            got = port.refine(x, labels, cfg, device="cpu",
                              omega=omega_from_reference(omega))
            with pytest.MonkeyPatch.context() as embed:
                scores = torch.from_numpy(np.array(ref.embedding))
                embed.setattr(port_pipeline, "pca_scores",
                              lambda cells, n_pcs, omega=None: scores)
                same = port.refine(x, labels, cfg, device="cpu")
            out[name] = (ref, got, same)
    return out


def _stage(res, name):
    return next(r for r in res.metrics["stages"] if r["stage"] == name)


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_union_cuts_and_silhouettes_match(runs, branch):
    ref, _, got = runs[branch]
    np.testing.assert_array_equal(got.de_gene_union_idx,
                                  ref.de_gene_union_idx)
    assert got.dynamic_labels.keys() == ref.dynamic_labels.keys()
    for key in ref.dynamic_labels:
        assert adjusted_rand_index(got.dynamic_labels[key],
                                   ref.dynamic_labels[key]) == 1.0, key
    for g, r in zip(got.deep_split_info, ref.deep_split_info):
        assert g["n_clusters"] == r["n_clusters"]
        assert g.get("silhouette_method") == r.get("silhouette_method")
        # the same points; float32 distance sums in another order
        assert abs(g["silhouette"] - r["silhouette"]) <= 1e-4


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_own_embedding_run_matches(runs, branch):
    ref, got, _ = runs[branch]
    np.testing.assert_array_equal(got.de_gene_union_idx,
                                  ref.de_gene_union_idx)
    # float32 subspace iteration on both sides (tests/test_torch_pipeline.py)
    sign = np.sign(np.sum(got.embedding * ref.embedding, axis=0))
    scale = float(np.abs(ref.embedding).max())
    np.testing.assert_allclose(got.embedding * sign, ref.embedding,
                               rtol=0, atol=1e-4 * scale)
    for g, r in zip(got.deep_split_info, ref.deep_split_info):
        key = f"deepsplit: {g['deep_split']}"
        ari = adjusted_rand_index(got.dynamic_labels[key],
                                  ref.dynamic_labels[key])
        if g["deep_split"] <= 3:
            # cuts that follow the four planted clusters
            assert ari == 1.0, key
            assert abs(g["silhouette"] - r["silhouette"]) <= 1e-4
        else:
            # deepSplit 4 partitions the noise inside the clusters (30 or
            # more clusters): there the cut follows the embedding's float32
            # rounding, which moves with the summation order (0.73 and 0.94
            # measured with two torch threads, 1.0 with eight), so only its
            # agreement is held
            assert ari >= 0.5, key


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_tree_record_matches(runs, branch):
    ref, _, got = runs[branch]
    tree = _stage(ref, "tree")
    assert got.metrics["tree"]["approx"] is tree["approx"]
    assert got.metrics["tree"]["landmark"] is bool(tree.get("landmark"))
    assert got.metrics["tree"]["landmark_k"] == tree.get("landmark_k")
    assert got.cell_tree.merge.shape == ref.cell_tree.merge.shape
    sil = _stage(ref, "silhouette")
    mine = got.metrics["silhouette"]
    if tree["approx"]:
        assert mine == {"method": sil["method"],
                        "n_centroids": sil["n_centroids"],
                        "pool_reused": sil["pool_reused"]}
    else:
        assert mine == {"method": "exact"} and "method" not in sil


def test_landmark_info_matches(runs):
    ref, _, got = runs["landmark"]
    want = ref.metrics["quality"]["cluster_structure"]["landmark"]
    mine = got.metrics["landmark"]
    for key in ("branch", "k", "sketch", "threshold", "linkage",
                "occupancy", "ari_vs_exact"):
        assert mine[key] == want[key], key
    assert got.metrics["silhouette"]["pool_reused"] is True
    # the pooled heights weigh each landmark by its occupancy
    np.testing.assert_allclose(got.cell_tree.height, ref.cell_tree.height,
                               rtol=1e-4)


def test_threshold_crossover(runs, data):
    _, _, truth = data
    at, past = runs["at_threshold"][1], runs["past_threshold"][1]
    lm_at = runs["at_landmark_threshold"][1]        # the port's own embed
    # N = 3,000 at the threshold: exact; one past it: the pool branch
    assert at.metrics["tree"]["approx"] is False
    assert at.metrics["silhouette"] == {"method": "exact"}
    assert at.cell_tree.n_leaves == 3000
    for res in (past, lm_at):
        # at the landmark threshold the legacy pool runs, not the landmarks
        assert res.metrics["tree"] == {"approx": True, "landmark": False,
                                       "landmark_k": None}
        assert res.metrics["landmark"] is None
        assert res.metrics["silhouette"]["pool_reused"] is True
        assert res.cell_tree.n_leaves <= 256
    for res in (at, past, lm_at):
        lab = res.dynamic_labels["deepsplit: 1"]
        assert lab.shape == (3000,)
        m = lab > 0
        assert adjusted_rand_index(lab[m], truth[m]) > 0.9
