"""``distance_cluster_sums`` and the silhouette built on it, against the
JAX package. On the CPU the wrapper runs its plain PyTorch version; the
CUDA kernel itself is held against that version by the ``cuda``-marked
case below and by ``chip_smoke.py``.

The JAX package is imported inside the tests that compare with it, so
that the ``cuda`` cases also run on a machine with a card and no JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``
(the suite's conftest imports JAX)."""

import numpy as np
import pytest
import torch

from scconsensus_tpu_torch.ops import silhouette
from scconsensus_tpu_torch.ops.cuda_kernels import (
    distance_cluster_sums,
    distance_cluster_sums_reference,
    labels_onehot,
)


def _ids(rng, n, k, n_cuts):
    """(n, n_cuts) int32 ids: cut c draws from its own range of [0, k),
    and about 5 % of the cells have no cluster (−1) in the later cuts."""
    edges = np.linspace(0, k, n_cuts + 1).astype(int)
    ids = np.stack([rng.integers(edges[c], edges[c + 1], n)
                    for c in range(n_cuts)], axis=1).astype(np.int32)
    ids[:, 1:][rng.random((n, n_cuts - 1)) < 0.05] = -1
    return np.ascontiguousarray(ids)


def _onehot(ids, k):
    oh = np.zeros((ids.shape[0], k), np.float32)
    for c in range(ids.shape[1]):
        keep = ids[:, c] >= 0
        oh[np.nonzero(keep)[0], ids[keep, c]] += 1.0
    return oh


# the shapes of tests/test_pallas_kernels.py: n off the 256 tile, a
# multi-tile grid in both axes, and K past the 128-lane padding; the last
# two split K over several cuts, as the silhouette stage does
SHAPES = [(300, 15, 5, 1), (520, 7, 3, 1), (260, 4, 131, 1),
          (300, 15, 40, 4), (260, 4, 131, 3)]


@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_distance_cluster_sums_matches_reference(rng, backend, shape):
    from scconsensus_tpu.ops.pallas_kernels import (
        distance_cluster_sums as ref_sums,
    )

    n, d, k, n_cuts = shape
    x = rng.normal(size=(n, d)).astype(np.float32)
    ids = _ids(rng, n, k, n_cuts)
    oh = _onehot(ids, k)
    ref = ref_sums(x, oh, backend=backend)
    before = distance_cluster_sums.launches
    got = distance_cluster_sums(torch.from_numpy(x), torch.from_numpy(ids), k)
    assert distance_cluster_sums.launches == before  # CPU: no kernel
    np.testing.assert_array_equal(labels_onehot(torch.from_numpy(ids),
                                                k).numpy(), oh)
    # the reference's own pallas-vs-xla tolerance: float32 sums of N
    # distances in another order
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-3)


def test_silhouette_widths_match_reference(rng):
    from scconsensus_tpu.ops import silhouette as ref_sil

    x = rng.normal(size=(280, 6)).astype(np.float32)
    labels = rng.integers(0, 4, 280)
    labels[:7] = -1
    ref = ref_sil.silhouette_widths(x, labels, backend="xla")
    valid = labels >= 0
    uniq, inv = np.unique(labels[valid], return_inverse=True)
    ids = inv.astype(np.int32)[:, None]
    sums = distance_cluster_sums(torch.from_numpy(x[valid].copy()),
                                 torch.from_numpy(ids), uniq.size).numpy()
    got = np.full(280, np.nan, np.float32)
    got[valid] = silhouette.widths_from_cluster_sums(
        sums, np.bincount(inv).astype(np.float32), inv)
    # widths are ratios of the sums above (held at 1e-4): same bound
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4,
                               equal_nan=True)


def test_multi_cut_silhouette_matches_reference(rng):
    from scconsensus_tpu.ops import silhouette as ref_sil

    x = rng.normal(size=(300, 5)).astype(np.float32)
    x[:100] += 4.0
    cuts = [rng.integers(0, k, 300) for k in (2, 3, 7)]
    cuts[1][:11] = -1          # excluded cells in one cut
    cuts.append(np.zeros(300, np.int64))  # a one-cluster cut: NaN
    ref = ref_sil.multi_cut_silhouette(x, cuts, backend="xla")
    got = silhouette.multi_cut_silhouette(torch.from_numpy(x), cuts)
    # means of hundreds of widths: the per-sum float32 differences
    # average down below 1e-5
    for (g_si, g_per), (r_si, r_per) in zip(got, ref):
        if np.isnan(r_si):
            assert np.isnan(g_si)
            continue
        assert abs(g_si - r_si) <= 1e-5
        assert g_per.keys() == r_per.keys()
        for k in r_per:
            assert abs(g_per[k] - r_per[k]) <= 1e-5


@pytest.mark.parametrize("bad", ["float64", "strided", "numpy", "rows",
                                 "rank", "float_ids", "int64_ids",
                                 "strided_ids", "negative_k"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x = torch.zeros((8, 3))
    ids = torch.zeros((8, 2), dtype=torch.int32)
    args = {
        "float64": (x.double(), ids, 2),
        "strided": (torch.zeros((3, 8)).T, ids, 2),
        "numpy": (x.numpy(), ids, 2),
        "rows": (x, torch.zeros((7, 2), dtype=torch.int32), 2),
        "rank": (x[None], ids, 2),
        "float_ids": (x, ids.float(), 2),
        "int64_ids": (x, ids.long(), 2),
        "strided_ids": (x, torch.zeros((2, 8), dtype=torch.int32).T, 2),
        "negative_k": (x, ids, -1),
    }[bad]
    with pytest.raises((TypeError, ValueError)):
        distance_cluster_sums(*args)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(26000, 15, 100, 1), (300, 7, 131, 3),
                                   (257, 3, 2, 1), (3000, 200, 1100, 2)],
                         ids=["flagship", "ragged", "skinny", "wide"])
def test_cuda_kernel_matches_plain_version(cuda_device, shape):
    n, d, k, n_cuts = shape
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)
                         ).to(cuda_device)
    ids = torch.from_numpy(_ids(rng, n, k, n_cuts)).to(cuda_device)
    before = distance_cluster_sums.launches
    got = distance_cluster_sums(x, ids, k)
    assert distance_cluster_sums.launches == before + 1
    ref = distance_cluster_sums_reference(x, ids, k)
    torch.cuda.synchronize()
    # float32 sums of N terms in another order, and the sqrt of the
    # a²+b²−2ab residue on the diagonal: 1e-4 of the largest sum
    err = float((got - ref).abs().max())
    assert err <= 1e-4 * max(float(ref.abs().max()), 1.0)
