"""Approximate Ward.D2 linkage restricted to a kNN graph.

A copy of ``scconsensus_tpu/ops/knn_linkage.py`` (:35-139). The graph's
k nearest neighbours of every cell come from the device, or from the
mesh's ring (``parallel.ring.ring_knn``); the host agglomerates, merging only
graph-adjacent clusters, cheapest first from a heap. Ward in centroid
form is exact under merging,

    D²(A, B) = 2·|A||B| / (|A|+|B|) · ‖c_A − c_B‖²,

so the only approximation is the candidate restriction. Components that
never connect are finished exactly by ``ward_linkage`` over their
centroids, so the result is always a complete hclust tree.
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Set

import numpy as np
import torch

from scconsensus_tpu_torch.ops.linkage import HClustTree, _to_hclust, ward_linkage
from scconsensus_tpu_torch.parallel.ring import ring_knn

__all__ = ["knn_ward_linkage"]


def _ward_d2(cent, size, u, v) -> float:
    du = cent[u] - cent[v]
    return float(
        2.0 * size[u] * size[v] / (size[u] + size[v]) * np.dot(du, du)
    )


def knn_ward_linkage(x, k: int = 15, mesh=None,
                     weights: Optional[np.ndarray] = None,
                     device=None) -> HClustTree:
    """Ward tree of the rows of x (N, d) over the kNN-graph restriction.

    ``x``: a numpy array (the kNN sweep runs on ``device``, the card by
    default) or a tensor (the sweep runs where it lies). ``weights``
    treats rows as pre-merged clusters (the landmark path). ``mesh``: an
    optional ``parallel.mesh.Mesh`` around which the kNN sweep's cell
    blocks rotate (``parallel.ring.ring_knn``); the graph does not depend
    on it away from distance ties."""
    from scconsensus_tpu_torch.obs import residency

    pts = x if isinstance(x, torch.Tensor) else None
    # the kNN branch's tree is host Ward over the graph: the points and
    # the (N, k) neighbour ids cross, as the pooled branch's pool does
    with residency.boundary("tree_pool_fetch"):
        x = np.ascontiguousarray(
            x.cpu().numpy() if pts is not None else x, np.float64)
    n = x.shape[0]
    if n < 2:
        raise ValueError("need at least 2 points")
    k = min(k, n - 1)
    _, nbr = ring_knn(x.astype(np.float32) if pts is None else pts, k, mesh,
                      device=device)
    with residency.boundary("tree_pool_fetch"):
        nbr = nbr.cpu().numpy()

    cap = 2 * n - 1
    cent = np.zeros((cap, x.shape[1]), np.float64)
    cent[:n] = x
    size = np.zeros(cap, np.float64)
    size[:n] = 1.0 if weights is None else np.asarray(weights, np.float64)
    active = np.zeros(cap, bool)
    active[:n] = True

    adj: List[Set[int]] = [set() for _ in range(cap)]
    for i in range(n):
        for j in nbr[i]:
            j = int(j)
            if j >= 0 and j != i:
                adj[i].add(j)
                adj[j].add(i)

    heap = []
    for i in range(n):
        for j in adj[i]:
            if j > i:
                heapq.heappush(heap, (_ward_d2(cent, size, i, j), i, j))

    raw_pairs = np.zeros((n - 1, 2), np.int64)
    raw_h = np.zeros(n - 1, np.float64)
    next_slot = n
    n_merges = 0

    while heap and n_merges < n - 1:
        d2, u, v = heapq.heappop(heap)
        if not (active[u] and active[v]):
            continue  # stale entry: one endpoint was merged away
        s = next_slot
        raw_pairs[n_merges] = (u, v)
        raw_h[n_merges] = np.sqrt(max(d2, 0.0))
        su, sv = size[u], size[v]
        cent[s] = (su * cent[u] + sv * cent[v]) / (su + sv)
        size[s] = su + sv
        active[u] = active[v] = False
        active[s] = True
        neighbors = (adj[u] | adj[v]) - {u, v}
        adj[s] = set()
        for w in neighbors:
            adj[w].discard(u)
            adj[w].discard(v)
            if active[w]:
                adj[s].add(w)
                adj[w].add(s)
                heapq.heappush(heap, (_ward_d2(cent, size, s, w), min(s, w),
                                      max(s, w)))
        adj[u] = adj[v] = set()
        next_slot = s + 1
        n_merges += 1

    # Disconnected components: finish exactly over their centroids.
    rest = np.nonzero(active)[0]
    if rest.size > 1:
        sub = ward_linkage(cent[rest], use_native=rest.size > 64,
                           weights=size[rest])
        # sub's merge codes reference its own leaf/row numbering; remap onto
        # our slot space (leaf m -> rest[m], row r -> the slot it created).
        slot_of_row = np.zeros(rest.size - 1, np.int64)
        for r in range(rest.size - 1):
            a, b = int(sub.merge[r, 0]), int(sub.merge[r, 1])
            ua = rest[-a - 1] if a < 0 else slot_of_row[a - 1]
            ub = rest[-b - 1] if b < 0 else slot_of_row[b - 1]
            raw_pairs[n_merges] = (ua, ub)
            raw_h[n_merges] = sub.height[r]
            s = next_slot
            sua, sub_ = size[ua], size[ub]
            cent[s] = (sua * cent[ua] + sub_ * cent[ub]) / (sua + sub_)
            size[s] = sua + sub_
            slot_of_row[r] = s
            next_slot = s + 1
            n_merges += 1

    if n_merges != n - 1:
        raise RuntimeError(f"{n_merges} merges for {n} leaves")
    return _to_hclust(raw_pairs, raw_h, n)
