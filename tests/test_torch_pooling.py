"""The port's centroid pooling (``scconsensus_tpu_torch/ops/pooling.py``)
against the JAX package's on the CPU: the landmark policies, the legacy
full-data Lloyd and its Ward tree, the landmark engine and its tree, and
the per-landmark majority labels, on planted blobs drawn with numpy from
a seed. Both sides take the same float32 points."""

import numpy as np
import pytest
import torch

from scconsensus_tpu.obs.regress import adjusted_rand_index
from scconsensus_tpu.ops import pooling as ref
from scconsensus_tpu.ops.treecut import cutree_hybrid as ref_cutree
from scconsensus_tpu_torch.obs.regress import adjusted_rand_index as port_ari
from scconsensus_tpu_torch.ops import pooling as port
from scconsensus_tpu_torch.ops.treecut import cutree_hybrid


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # the suite runs six workers on the machine's cores; two torch threads
    # a worker keep these small tensors from crowding out the other files
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _blobs(n, seed, k=5, d=15, scale=8.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=scale, size=(k, d))
    lab = rng.integers(0, k, n)
    return (centers[lab] + rng.normal(size=(n, d))).astype(np.float32), lab


def _cuts(tree, points, assign, weights, cutree):
    return {ds: cutree(tree, points, deep_split=ds, min_cluster_size=10,
                       weights=weights)[assign] for ds in (1, 2, 3, 4)}


@pytest.mark.parametrize("n", [2, 3, 100, 511, 512, 1_000, 10_000, 65_536,
                               100_000, 262_144, 1_000_000, 4_194_304,
                               10_000_000])
@pytest.mark.parametrize("c,k_min,k_max", [(2.0, 512, 4096),
                                           (0.5, 64, 1000),
                                           (3.7, 100, 8192)])
def test_landmark_policies_equal_the_reference(n, c, k_min, k_max):
    k = port.landmark_k_policy(n, c=c, k_min=k_min, k_max=k_max)
    assert k == ref.landmark_k_policy(n, c=c, k_min=k_min, k_max=k_max)
    for kk in (k, 2, 4096):
        assert port.landmark_sketch_policy(n, kk) == \
            ref.landmark_sketch_policy(n, kk)


@pytest.mark.parametrize("n", [999, 1000, 1001, 200_000, 200_001,
                               1_000_000])
@pytest.mark.parametrize("fields", [
    {}, dict(landmark_threshold=1000), dict(landmark_threshold=1000,
                                            landmark_k=777, landmark_c=3.0),
    dict(landmark_threshold=500, landmark_sketch=4096,
         landmark_linkage="knn", knn_graph_k=9, landmark_k_min=64,
         landmark_k_max=1024),
], ids=["defaults", "threshold", "k_and_c", "sketch_knn"])
def test_landmark_policy_resolves_like_the_reference(monkeypatch, n, fields):
    from scconsensus_tpu.config import ReclusterConfig as RefConfig
    from scconsensus_tpu_torch.config import ReclusterConfig

    # the reference fills unset fields from these flags; cleared, both
    # sides take the registered defaults
    for flag in ("SCC_TREE_LANDMARK_THRESHOLD", "SCC_TREE_LANDMARK_K",
                 "SCC_TREE_LANDMARK_C", "SCC_TREE_EXACT"):
        monkeypatch.delenv(flag, raising=False)
    assert ReclusterConfig(**fields).landmark_policy(n) == \
        RefConfig(**fields).landmark_policy(n)


@pytest.fixture(scope="module")
def pooled():
    x, _ = _blobs(3000, seed=0)
    return x, ref.pooled_ward_linkage(x, n_centroids=256, seed=1), \
        port.pooled_ward_linkage(x, n_centroids=256, seed=1, device="cpu")


def test_kmeans_pool_matches_the_reference(pooled):
    x, (_, ref_assign, ref_cent), (_, assign, cent) = pooled
    # planted blobs: no point sits on a near-tie between two centroids,
    # so every assignment is identical
    np.testing.assert_array_equal(assign, ref_assign)
    assert cent.dtype == np.float64 and cent.shape == ref_cent.shape
    # float32 centroid sums in another order (segment sums here, a one-hot
    # product in XLA): 1e-5 of the largest |coordinate|
    np.testing.assert_allclose(cent, ref_cent, rtol=0,
                               atol=1e-5 * np.abs(ref_cent).max())


def test_pooled_ward_tree_and_cuts_match_the_reference(pooled):
    x, (ref_tree, ref_assign, ref_cent), (tree, assign, cent) = pooled
    # Ward in float64 on centroids that agree to 1e-5
    np.testing.assert_allclose(tree.height, ref_tree.height, rtol=1e-4)
    w = np.bincount(assign, minlength=cent.shape[0]).astype(np.float64)
    got = _cuts(tree, cent, assign, w, cutree_hybrid)
    want = _cuts(ref_tree, ref_cent, ref_assign, w, ref_cutree)
    for ds in got:
        assert adjusted_rand_index(got[ds], want[ds]) == 1.0, ds


@pytest.mark.parametrize("case", [
    dict(n=5000, seed=0, kw={}),                                  # k_min
    dict(n=6000, seed=1, kw=dict(n_landmarks=256, sketch=3000)),  # sketch
    dict(n=4000, seed=2, kw=dict(c=8.0, k_min=64, k_max=900)),    # c, caps
], ids=["policy", "sketch", "clamped"])
def test_landmark_engine_matches_the_reference(case):
    x, _ = _blobs(case["n"], seed=case["seed"])
    r_tree, r_assign, r_cent, r_info = ref.landmark_ward_linkage(
        x, seed=case["seed"], **case["kw"])
    tree, assign, cent, info = port.landmark_ward_linkage(
        x, seed=case["seed"], device="cpu", **case["kw"])
    assert info == r_info
    np.testing.assert_array_equal(assign, r_assign)
    # centroids: 1e-5 of the largest |coordinate| (float32 segment sums in
    # another order); Ward heights from them 1e-4 relative
    np.testing.assert_allclose(cent, r_cent, rtol=0,
                               atol=1e-5 * np.abs(r_cent).max())
    np.testing.assert_allclose(tree.height, r_tree.height, rtol=1e-4)
    w = np.bincount(assign, minlength=cent.shape[0]).astype(np.float64)
    got = _cuts(tree, cent, assign, w, cutree_hybrid)
    want = _cuts(r_tree, r_cent, r_assign, w, ref_cutree)
    for ds in got:
        assert port_ari(got[ds], want[ds]) == 1.0, ds


def test_landmark_pool_takes_a_tensor_where_it_lies():
    x, _ = _blobs(2000, seed=3)
    cent, assign, info = port.landmark_pool(torch.from_numpy(x), seed=3)
    r_cent, r_assign, r_info = ref.landmark_pool(x, seed=3)
    assert info == r_info
    np.testing.assert_array_equal(assign, r_assign)


def test_landmark_knn_linkage_matches_the_reference():
    x, _ = _blobs(3000, seed=4)
    kw = dict(n_landmarks=256, seed=4, linkage="knn", knn_k=10)
    r_tree, r_assign, r_cent, r_info = ref.landmark_ward_linkage(x, **kw)
    tree, assign, cent, info = port.landmark_ward_linkage(x, device="cpu",
                                                          **kw)
    assert info == r_info
    np.testing.assert_array_equal(assign, r_assign)
    np.testing.assert_allclose(tree.height, r_tree.height, rtol=1e-4)
    w = np.bincount(assign, minlength=cent.shape[0]).astype(np.float64)
    got = _cuts(tree, cent, assign, w, cutree_hybrid)
    want = _cuts(r_tree, r_cent, r_assign, w, ref_cutree)
    for ds in got:
        assert adjusted_rand_index(got[ds], want[ds]) == 1.0, ds


class TestDeterminism:
    """The reference's TestDeterminism, on the port."""

    def test_same_seed_same_result(self):
        x, _ = _blobs(3000, seed=5)
        a = port.landmark_ward_linkage(x, seed=7, device="cpu")
        b = port.landmark_ward_linkage(x, seed=7, device="cpu")
        np.testing.assert_array_equal(a[0].merge, b[0].merge)
        np.testing.assert_array_equal(a[0].height, b[0].height)
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], b[2])
        c = port.kmeans_pool(x, 128, seed=7, device="cpu")
        d = port.kmeans_pool(x, 128, seed=7, device="cpu")
        np.testing.assert_array_equal(c[0], d[0])
        np.testing.assert_array_equal(c[1], d[1])

    def test_another_seed_differs(self):
        x, _ = _blobs(3000, seed=5)
        a = port.landmark_ward_linkage(x, n_landmarks=256, sketch=1500,
                                       seed=7, device="cpu")
        b = port.landmark_ward_linkage(x, n_landmarks=256, sketch=1500,
                                       seed=8, device="cpu")
        assert not np.array_equal(a[2], b[2])
        c = port.kmeans_pool(x, 128, seed=7, device="cpu")
        d = port.kmeans_pool(x, 128, seed=8, device="cpu")
        assert not np.array_equal(c[0], d[0])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_centroid_majority_labels_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    k = 40
    assign = rng.integers(0, k, 2000)
    labels = rng.integers(0, 6, 2000)       # 0 = unassigned, never votes
    labels[assign == 3] = 0                 # a landmark without votes
    got = port.centroid_majority_labels(assign, labels, k)
    np.testing.assert_array_equal(
        got, ref.centroid_majority_labels(assign, labels, k))
    assert got[3] == 0
    with pytest.raises(ValueError):
        port.centroid_majority_labels(assign[:-1], labels, k)


def test_mesh_raises():
    # the landmark tree takes a parallel.mesh.Mesh; "auto" is refine()'s
    x, _ = _blobs(600, seed=6)
    with pytest.raises(TypeError, match="Mesh"):
        port.landmark_ward_linkage(x, device="cpu", mesh="auto")
