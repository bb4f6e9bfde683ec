"""The port's one-device kNN sweep (``parallel/ring.py`` ``ring_knn``) and
the graph-restricted Ward agglomeration (``ops/knn_linkage.py``) against
the JAX package on the CPU. The reference's ring runs on the suite's
8-device virtual mesh; its result does not depend on the sharding.

The graph is held exactly on tie-free data whose arithmetic is exact:
integer coordinates in [0, 512) in 15 dimensions keep every partial sum
of a² + b² − 2ab an integer below 2^24, so both packages form the same
float32 squared distances in any order (the sqrt differs by an ulp at
most), and the seeds are ones where no
row has two equal distances among its 16 nearest (checked in
``_tie_free``). ``jax.lax.top_k`` breaks ties by position and
``torch.topk`` promises no order, so ties would make the comparison
meaningless. On real-valued clustered data the a² + b² − 2ab cancellation
leaves a few float32 ulps of max |x|², and the test there allows for it.
"""

import numpy as np
import pytest
import torch

from scconsensus_tpu.obs.regress import adjusted_rand_index
from scconsensus_tpu.ops.knn_linkage import knn_ward_linkage as ref_knn_ward
from scconsensus_tpu.ops.treecut import cutree_hybrid as ref_cutree
from scconsensus_tpu.parallel.ring import ring_knn as ref_ring_knn
from scconsensus_tpu_torch import ReclusterConfig, recluster_de_consensus_fast
from scconsensus_tpu_torch.ops.knn_linkage import knn_ward_linkage
from scconsensus_tpu_torch.ops.treecut import cutree_hybrid
from scconsensus_tpu_torch.parallel.ring import ring_knn


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # the suite runs six workers on the machine's cores; two torch threads
    # a worker keep these small tensors from crowding out the other files
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _exact_sq(x):
    x = x.astype(np.int64)
    sq = (x * x).sum(axis=1)
    d2 = sq[:, None] + sq[None, :] - 2 * x @ x.T
    np.fill_diagonal(d2, np.iinfo(np.int64).max)
    return d2


def _tie_free(x, k=15):
    """x as float32, after checking that no row has two equal distances
    among its k + 1 nearest."""
    near = np.sort(_exact_sq(x), axis=1)[:, :k + 1]
    assert not (np.diff(near, axis=1) == 0).any(), "seed gives a tie"
    return x.astype(np.float32)


def _grid(n, seed):
    rng = np.random.default_rng(seed)
    return _tie_free(rng.integers(0, 512, (n, 15)))


def _blobs(n, seed, d=15, k=4):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=6.0, size=(k, d))
    lab = rng.integers(0, k, n)
    return (centers[lab] + rng.normal(size=(n, d))).astype(np.float32)


@pytest.fixture(scope="module")
def reference_knn():
    out = {}
    for n in (2000, 2003):        # 2,003 rows: the reference pads its ring
        x = _grid(n, seed=1)
        for k in (1, 15):
            out[n, k] = (x,) + ref_ring_knn(x, k)
    return out


@pytest.mark.parametrize("n", [2000, 2003])
@pytest.mark.parametrize("k", [1, 15])
@pytest.mark.parametrize("block", [None, 257, 4096])
def test_ring_knn_matches_the_reference(reference_knn, n, k, block):
    x, r_dist, r_idx = reference_knn[n, k]
    dist, idx = ring_knn(x, k, block=block, device="cpu")
    assert dist.shape == idx.shape == (n, k)
    # tie-free rows: the same neighbours in the same order
    np.testing.assert_array_equal(idx.numpy(), r_idx)
    # the same exact float32 squared distances; XLA's float32 sqrt on the
    # CPU is within an ulp (0.5 % of entries differ by one), so 1e-6
    np.testing.assert_allclose(dist.numpy(), r_dist, rtol=1e-6, atol=0)
    assert not (idx.numpy() == np.arange(n)[:, None]).any()


def test_ring_knn_on_clustered_float_data_agrees_to_the_cancellation():
    x = _blobs(2000, seed=2000)
    r_dist, r_idx = ref_ring_knn(x, 15)
    dist, idx = ring_knn(torch.from_numpy(x), 15)
    # each side's float32 squared distances carry a few ulps of the largest
    # |x|²: 8 float32 epsilons of it (1.1e-3 here). The true (float64)
    # squared distance at every rank agrees within that, so a neighbour
    # differs only where two distances are that close
    x64 = x.astype(np.float64)
    tol = 8 * np.finfo(np.float32).eps * float((x64 ** 2).sum(1).max())
    rows = np.arange(2000)[:, None]
    true = ((x64[:, None, :] - x64[None, :, :]) ** 2).sum(-1)
    got, want = true[rows, idx.numpy()], true[rows, r_idx]
    assert np.abs(got - want).max() <= tol
    assert np.abs(dist.numpy().astype(np.float64) ** 2
                  - r_dist.astype(np.float64) ** 2).max() <= tol
    # and such near-ties are rare: 2 of 30,000 entries when measured
    assert (idx.numpy() == r_idx).mean() >= 0.999


def test_ring_knn_block_size_does_not_change_the_result():
    x = torch.from_numpy(_blobs(1500, seed=9))
    d1, i1 = ring_knn(x, 7, block=100)
    d2, i2 = ring_knn(x, 7, block=1500)
    assert torch.equal(i1, i2)
    assert torch.equal(d1, d2)


def test_ring_knn_refuses_what_it_cannot_do():
    x = _blobs(50, seed=1)
    # "auto" is refine()'s policy; the ring takes a parallel.mesh.Mesh
    with pytest.raises(TypeError, match="Mesh"):
        ring_knn(x, 3, mesh="auto", device="cpu")
    with pytest.raises(ValueError):
        ring_knn(x, 50, device="cpu")


@pytest.mark.parametrize("weighted", [False, True])
def test_knn_ward_linkage_matches_the_reference(weighted):
    x = _grid(2000, seed=1)
    w = (np.random.default_rng(3).integers(1, 20, 2000).astype(np.float64)
         if weighted else None)
    ref = ref_knn_ward(x, k=15, weights=w)
    got = knn_ward_linkage(x, k=15, weights=w, device="cpu")
    # the same graph and the same float64 host arithmetic: the same merges
    np.testing.assert_array_equal(got.merge, ref.merge)
    np.testing.assert_array_equal(got.order, ref.order)
    np.testing.assert_allclose(got.height, ref.height, rtol=1e-4)
    for ds in (1, 2, 3, 4):
        a = cutree_hybrid(got, x, deep_split=ds, min_cluster_size=10,
                          weights=w)
        b = ref_cutree(ref, x, deep_split=ds, min_cluster_size=10,
                       weights=w)
        assert adjusted_rand_index(a, b) == 1.0, ds


def test_knn_ward_linkage_finishes_disconnected_components():
    # two far groups, k = 3: the graph has several components, which the
    # exact Ward over their centroids joins
    rng = np.random.default_rng(0)
    x = _tie_free(np.concatenate([rng.integers(0, 100, (120, 15)),
                                  rng.integers(400, 512, (90, 15))]), k=3)
    ref = ref_knn_ward(x, k=3)
    got = knn_ward_linkage(torch.from_numpy(x), k=3)
    np.testing.assert_array_equal(got.merge, ref.merge)
    np.testing.assert_allclose(got.height, ref.height, rtol=1e-4)
    assert got.merge.shape == (209, 2)


def test_knn_branch_refuses_a_mesh():
    # a mesh that is not one: the linkage takes a parallel.mesh.Mesh, and
    # refine() knows "auto", a Mesh and None
    x = _blobs(40, seed=2)
    with pytest.raises(TypeError, match="Mesh"):
        knn_ward_linkage(x, k=3, mesh="auto", device="cpu")
    from scconsensus_tpu_torch.utils.synthetic import synthetic_scrna

    data, truth, _ = synthetic_scrna(n_genes=120, n_cells=240, n_clusters=3,
                                     seed=3)
    labels = [f"c{v}" for v in truth]
    with pytest.raises(ValueError, match="mesh"):
        recluster_de_consensus_fast(data, labels, approx_threshold=100,
                                    approx_method="knn", device="cpu",
                                    mesh="everywhere")
    with pytest.raises(ValueError, match="approx_method"):
        recluster_de_consensus_fast(data, labels, approx_method="tree",
                                    device="cpu")
    assert ReclusterConfig().approx_method == "pool"
