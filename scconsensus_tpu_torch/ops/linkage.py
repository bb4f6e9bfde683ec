"""Ward.D2 agglomerative clustering via the nearest-neighbor-chain algorithm.

Replaces ``fastcluster::hclust(d, "ward.D2")`` (R/reclusterDEConsensus.R:242-246).
Rather than consuming an N×N distance matrix, clusters are represented by
(centroid, size) and the Ward.D2 dissimilarity is computed on the fly:

    D(A, B) = sqrt(2·|A||B| / (|A|+|B|)) · ‖c_A − c_B‖

which reproduces R's ward.D2 heights on euclidean input exactly (it is the
Lance–Williams recurrence in closed form). Memory is O(N·d) instead of O(N²),
which is what makes the 1M-cell approximate path possible (SURVEY.md §7).

Ward dissimilarity is reducible, so NN-chain merges are globally optimal and,
after a stable sort by height, yield an hclust-compatible (merge, height,
order) triple that dynamicTreeCut can consume.

A C++ implementation of the same chain loop lives in ``native/ward.cpp``
(ctypes-loaded); this numpy version is the always-available fallback and the
golden reference for it. The numpy chain is far slower at tens of thousands
of cells, so ``LAST_ENGINE`` records which engine the latest call ran
("native" or "numpy") and the chip smoke run fails unless it is native.

A copy of ``scconsensus_tpu/ops/linkage.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from scconsensus_tpu_torch.native import ward_native
from scconsensus_tpu_torch.obs.trace import span

__all__ = ["HClustTree", "ward_linkage", "cut_tree_k", "LAST_ENGINE"]

# engine of the latest ward_linkage call: "native", "numpy" or None
LAST_ENGINE: Optional[str] = None


@dataclasses.dataclass
class HClustTree:
    """R hclust-compatible tree.

    merge: (N-1, 2) int32; negative = −(singleton index+1), positive = 1-based
      row of a prior merge (R convention, consumed by the tree cutter).
    height: (N-1,) float64 non-decreasing merge heights.
    order: (N,) leaf permutation for crossing-free dendrogram drawing.
    """

    merge: np.ndarray
    height: np.ndarray
    order: np.ndarray

    @property
    def n_leaves(self) -> int:
        return self.merge.shape[0] + 1


def _nn_of(cent, size, active_idx, u):
    """Index (into active_idx) of the Ward-nearest active cluster to u."""
    c = cent[active_idx]
    du = c - cent[u]
    sq = np.einsum("ij,ij->i", du, du)
    s = size[active_idx] * size[u] / (size[active_idx] + size[u])
    d2 = 2.0 * s * sq
    # self-distance excluded by caller (u not in active_idx)
    k = int(np.argmin(d2))
    return k, d2[k]


def ward_linkage(
    points: np.ndarray,
    use_native: bool = True,
    weights: Optional[np.ndarray] = None,
) -> HClustTree:
    """Ward.D2 linkage of the rows of ``points`` (N, d).

    ``weights`` (N,) treats each point as a pre-merged cluster of that many
    observations (the centroid-pooling approximate path); default 1.
    Runs in a ``ward`` span whose ``engine`` attribute names the engine.
    """
    with span("ward", n=int(np.shape(points)[0])) as sp:
        tree = _ward(points, use_native, weights)
        sp["engine"] = LAST_ENGINE
    return tree


def _ward(points, use_native: bool, weights) -> HClustTree:
    points = np.ascontiguousarray(points, dtype=np.float64)
    n = points.shape[0]
    if n < 2:
        raise ValueError("need at least 2 points")
    w = (
        np.ones(n, np.float64)
        if weights is None
        else np.ascontiguousarray(weights, np.float64)
    )
    global LAST_ENGINE
    if use_native:
        try:
            raw_pairs, raw_h = ward_native(points, w)
        except (OSError, RuntimeError):
            pass  # no compiler or no build: the numpy chain below
        else:
            LAST_ENGINE = "native"
            return _to_hclust(raw_pairs, raw_h, n)
    LAST_ENGINE = "numpy"

    cap = 2 * n - 1
    cent = np.zeros((cap, points.shape[1]), np.float64)
    cent[:n] = points
    size = np.zeros(cap, np.float64)
    size[:n] = w
    active = np.ones(cap, bool)
    active[n:] = False

    raw_pairs = np.zeros((n - 1, 2), np.int64)
    raw_h = np.zeros(n - 1, np.float64)
    next_slot = n
    chain = []
    n_active = n
    while n_active > 1:
        if not chain:
            chain.append(int(np.nonzero(active)[0][0]))
        while True:
            u = chain[-1]
            active[u] = False
            act = np.nonzero(active)[0]
            active[u] = True
            k, d2 = _nn_of(cent, size, act, u)
            v = int(act[k])
            if len(chain) > 1 and v == chain[-2]:
                break
            chain.append(v)
        u = chain.pop()
        v = chain.pop()
        h = np.sqrt(max(d2, 0.0))
        raw_pairs[next_slot - n] = (u, v)
        raw_h[next_slot - n] = h
        su, sv = size[u], size[v]
        cent[next_slot] = (su * cent[u] + sv * cent[v]) / (su + sv)
        size[next_slot] = su + sv
        active[u] = active[v] = False
        active[next_slot] = True
        next_slot += 1
        n_active -= 1
    return _to_hclust(raw_pairs, raw_h, n)


def _to_hclust(raw_pairs: np.ndarray, raw_h: np.ndarray, n: int) -> HClustTree:
    """Order raw merges by height and rewrite slot ids into R hclust merge
    codes.

    The ordering is a height-prioritized topological (Kahn) pass rather than
    a plain argsort: a merge becomes eligible only once both child rows are
    placed. For reducible linkages (NN-chain Ward) parent heights dominate
    children, so this reproduces the stable height sort exactly; for
    candidate-restricted agglomerations (ops.knn_linkage) a parent can sit
    BELOW a child (an inversion — legal in hclust trees, cf. centroid
    linkage), and a plain height sort would emit a row referencing a later
    row: a structurally invalid tree."""
    import heapq

    m = n - 1
    dep_count = np.zeros(m, np.int32)
    dependents: list = [[] for _ in range(m)]
    for r in range(m):
        for slot in (int(raw_pairs[r, 0]), int(raw_pairs[r, 1])):
            if slot >= n:
                dep_count[r] += 1
                dependents[slot - n].append(r)
    heap = [(float(raw_h[r]), r) for r in range(m) if dep_count[r] == 0]
    heapq.heapify(heap)
    order_rows = np.empty(m, np.int64)
    rank_of_raw = np.empty(m, np.int64)
    placed = 0
    while heap:
        _, r = heapq.heappop(heap)
        order_rows[placed] = r
        rank_of_raw[r] = placed
        placed += 1
        for d in dependents[r]:
            dep_count[d] -= 1
            if dep_count[d] == 0:
                heapq.heappush(heap, (float(raw_h[d]), d))
    if placed != m:  # a cycle would mean corrupt input, not a bad sort
        raise ValueError("merge list is not a forest")

    def code(slot: int, _rank=rank_of_raw, _n=n) -> int:
        if slot < _n:
            return -(slot + 1)
        return int(_rank[slot - _n]) + 1

    merge = np.zeros((n - 1, 2), np.int32)
    height = raw_h[order_rows]
    for new_row, raw_row in enumerate(order_rows):
        a = code(int(raw_pairs[raw_row, 0]))
        b = code(int(raw_pairs[raw_row, 1]))
        # Normalize rows: singletons (negative) before clusters; within a kind,
        # ascending |code|. (Cosmetic; consumers only need structural validity.)
        if (a > 0 and b < 0) or (a < 0 and b < 0 and a < b) or (a > 0 and b > 0 and a > b):
            a, b = b, a
        merge[new_row] = (a, b)

    # Leaf order: DFS over the final merge rows (left child first).
    order = np.zeros(n, np.int64)
    pos = 0
    stack = [n - 2]  # root = last row
    while stack:
        node = stack.pop()
        if node < 0:
            order[pos] = -node - 1
            pos += 1
            continue
        a, b = merge[node]
        ca = int(a) - 1 if a > 0 else int(a)
        cb = int(b) - 1 if b > 0 else int(b)
        stack.append(cb)
        stack.append(ca)
    return HClustTree(merge=merge, height=height, order=order)


def cut_tree_k(tree: HClustTree, k: int) -> np.ndarray:
    """Flat cut into k clusters (R ``cutree`` analog), labels 1..k by order of
    first appearance. Test utility for cross-checking linkage correctness."""
    n = tree.n_leaves
    parent = {}
    for row in range(n - 1 - (k - 1)):
        a, b = tree.merge[row]
        for c in (int(a), int(b)):
            parent[c] = row + 1
    # union-find style resolution: leaf -> top surviving component
    labels = np.zeros(n, np.int64)
    comp_of = {}
    next_label = 1

    def resolve(code: int) -> int:
        while code in parent:
            code = parent[code]
        return code

    for leaf in range(n):
        top = resolve(-(leaf + 1))
        if top not in comp_of:
            nonlocal_label = next_label
            comp_of[top] = nonlocal_label
            next_label += 1
        labels[leaf] = comp_of[top]
    return labels
