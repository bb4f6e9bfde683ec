"""The preparation ``distance_cluster_sums`` does before its kernel:
cells in cluster order (``_cell_order``), the count of run sums a row
writes (``run_flushes``) and the split of j over the grid
(``_plan_splits``). On the CPU all of it is plain PyTorch; the ``cuda``
case holds the card's packed keys against the CPU's, and the kernel itself
is held against its plain version by the ``cuda``-marked case in
``test_torch_kernels.py``."""

import numpy as np
import pytest
import torch

from scconsensus_tpu_torch.ops.cuda_kernels import (
    _MAX_PART,
    _ORDER_MIN,
    _TN,
    _cell_order,
    _plan_splits,
    _valid_ids,
    distance_cluster_sums_reference,
    run_flushes,
)


def _random_ids(rng, n, k, n_cuts):
    """Cut c draws from its own range of [0, k); about 5 % of the cells
    have no cluster (−1) in the later cuts and 3 % an id past K in cut 0."""
    edges = np.linspace(0, k, n_cuts + 1).astype(int)
    ids = np.stack([rng.integers(edges[c], edges[c + 1], n)
                    for c in range(n_cuts)], axis=1).astype(np.int32)
    ids[:, 1:][rng.random((n, n_cuts - 1)) < 0.05] = -1
    ids[rng.random(n) < 0.03, 0] = k + 3
    return np.ascontiguousarray(ids)


def nested_ids(rng, n, sizes):
    """Cuts that refine each other, as deepSplit cuts of one tree mostly
    do: a fine labeling into sizes[-1] clusters, coarsened into sizes[c]
    clusters for cut c, each cut's ids offset past the cuts before it;
    about 5 % of the cells have no cluster (−1) in each cut after the
    first. Returns (ids (n, C) int32, K)."""
    fine = rng.integers(0, sizes[-1], n)
    cols, k0 = [], 0
    for c, m in enumerate(sizes):
        col = (fine * m // sizes[-1] + k0).astype(np.int32)
        if c:
            col[rng.random(n) < 0.05] = -1
        cols.append(col)
        k0 += m
    return np.ascontiguousarray(np.stack(cols, axis=1)), k0


def _numpy_runs(ids, k):
    """The numpy model: sort the cells lexicographically by their valid
    ids (cut 0 first) and count, in each cut, the maximal stretches of one
    id in [0, K)."""
    key = np.where((ids >= 0) & (ids < k), ids, -1)
    order = np.lexsort(key.T[::-1])
    key = key[order]
    runs = 0
    for c in range(key.shape[1]):
        col = key[:, c]
        starts = np.r_[True, col[1:] != col[:-1]]
        runs += int((starts & (col >= 0)).sum())
    return runs, key


CASES = [("one cut", 1), ("three cuts", 3), ("four cuts", 4)]


@pytest.mark.parametrize("name,n_cuts", CASES, ids=[c[0] for c in CASES])
def test_cell_order_is_a_permutation(rng, name, n_cuts):
    ids = torch.from_numpy(_random_ids(rng, 500, 37, n_cuts))
    order = _cell_order(ids, 37)
    assert order.dtype == torch.int64
    assert np.array_equal(np.sort(order.numpy()), np.arange(500))


@pytest.mark.parametrize("name,n_cuts", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("kind", ["random", "nested"])
def test_each_cut_is_contiguous_inside_the_cuts_before_it(rng, name, n_cuts,
                                                          kind):
    if kind == "random":
        k = 37
        ids = _random_ids(rng, 700, k, n_cuts)
    else:
        ids, k = nested_ids(rng, 700, [3, 7, 20, 45][:n_cuts])
    key = _valid_ids(torch.from_numpy(ids), k)[
        _cell_order(torch.from_numpy(ids), k)].numpy()
    assert (key < k).all()
    # the ids outside [0, K) of cut 0 come first, as −1
    for c in range(n_cuts):
        prefix = [tuple(r) for r in key[:, :c]]
        seen = set()
        for j in range(key.shape[0]):
            tag = prefix[j] + (key[j, c],)
            if tag in seen:
                # a tuple seen before must be the one just before
                assert prefix[j - 1] + (key[j - 1, c],) == tag, (c, j)
            seen.add(tag)
    assert np.array_equal(key, _numpy_runs(ids, k)[1])


def test_plain_version_does_not_depend_on_the_cell_order(rng):
    n, k = 600, 45
    x = torch.from_numpy(rng.normal(size=(n, 9)).astype(np.float32))
    ids, k = nested_ids(rng, n, [3, 7, 20, 45])
    ids = torch.from_numpy(ids)
    order = _cell_order(ids, k)
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(n)
    ref = distance_cluster_sums_reference(x, ids, k)
    moved = distance_cluster_sums_reference(x[order].contiguous(),
                                            ids[order].contiguous(), k)
    # the same float32 sums taken in another order: 1e-4 of the largest
    err = float((moved[inverse] - ref).abs().max())
    assert err <= 1e-4 * float(ref.abs().max())


@pytest.mark.parametrize("n", [_ORDER_MIN, 2 * _ORDER_MIN + 1])
def test_one_cut_writes_one_run_per_cluster(rng, n):
    k = 17
    ids = np.r_[np.arange(k), rng.integers(0, k, n - k)].astype(np.int32)
    ids = torch.from_numpy(rng.permutation(ids)[:, None].copy())
    assert run_flushes(ids, k) == k


@pytest.mark.parametrize("n", [1, 64, _ORDER_MIN - 1])
def test_below_the_order_threshold_runs_follow_the_callers_order(rng, n):
    ids = rng.integers(0, 5, (n, 2)).astype(np.int32)
    ids[:, 1] += 5
    runs = 0
    for c in range(2):
        col = ids[:, c]
        runs += int(np.r_[True, col[1:] != col[:-1]].sum())
    assert run_flushes(torch.from_numpy(ids), 10) == runs


@pytest.mark.parametrize("sizes", [[4], [4, 9], [3, 7, 20], [10, 40, 150,
                                                             250]])
def test_nested_cuts_write_few_runs(rng, sizes):
    ids, k = nested_ids(rng, 3000, sizes)  # past _ORDER_MIN: ordered
    runs = run_flushes(torch.from_numpy(ids), k)
    assert runs == _numpy_runs(ids, k)[0]
    valid = np.where(ids >= 0, ids, -1)
    tuples = np.unique(valid, axis=0).shape[0]
    assert runs <= len(sizes) * tuples
    assert runs < 3000 * len(sizes) // 2


@pytest.mark.parametrize("n_cuts", [1, 3, 4, 11])
def test_random_cuts_count_matches_the_numpy_model(rng, n_cuts):
    ids = _random_ids(rng, _ORDER_MIN + 100, 60, n_cuts)
    # the kernel takes up to 4 cuts in one sweep, each group in its order
    expect = sum(_numpy_runs(ids[:, g:g + 4], 60)[0]
                 for g in range(0, n_cuts, 4))
    assert run_flushes(torch.from_numpy(ids), 60) == expect


@pytest.mark.parametrize("n,k,n_sm,per_sm", [
    (26000, 449, 132, 4), (50000, 24, 132, 4), (3000, 1100, 132, 3),
    (300, 131, 132, 4), (1, 1, 132, 4), (10 ** 6, 4000, 132, 2),
    (26000, 449, 114, 3)])
def test_plan_splits_covers_j_and_fills_the_card(n, k, n_sm, per_sm):
    splits, per = _plan_splits(n, k, n_sm, per_sm)
    tiles = -(-n // _TN)
    assert 1 <= splits <= 65535 and per >= 1
    assert (splits - 1) * per < tiles <= splits * per
    assert splits <= 8
    assert splits == 1 or splits * k * n <= _MAX_PART


def test_plan_splits_fills_the_sms_at_the_26k_path():
    # 102 blocks of 256 rows: five splits give 510 of 528 block slots
    assert _plan_splits(26000, 449, 132, 4)[0] == 5
    assert _plan_splits(50000, 24, 132, 4)[0] == 5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_orders_the_cells_as_the_cpu_does(cuda_device):
    # its own generator: the card runs this file without the suite's
    # conftest (and its ``rng`` fixture)
    rng = np.random.default_rng(0)
    ids, k = nested_ids(rng, 5000, [10, 40, 150, 250])
    ids[::7, 0] = k + 5  # outside [0, K) in the first cut too
    ids = torch.from_numpy(ids)
    for g in (slice(None), slice(1, 3)):
        assert torch.equal(_cell_order(ids.to(cuda_device), k, g).cpu(),
                           _cell_order(ids, k, g))
