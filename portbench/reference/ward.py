"""Exact Ward.D2 by rounds of reciprocal nearest neighbours, on the device.

Clusters are (centroid, size) pairs and the Ward.D2 dissimilarity is
D(A, B) = sqrt(2·|A||B| / (|A| + |B|)) · ‖c_A − c_B‖. Ward is reducible,
so every pair of clusters that are each other's nearest neighbour can
merge in the same round and the hierarchy is the one the one-at-a-time
agglomeration builds. Each round finds every active cluster's nearest
neighbour over the whole (m, m) table in row blocks, merges all
reciprocal pairs (the closest pair alone when ties leave none) and
repeats until one cluster is left. The merges are then ordered by height
into an R hclust tree (merge codes, heights, leaf order), as
``_to_hclust`` below, a copy of the JAX package's ``ops/linkage.py``.
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np
import torch

__all__ = ["Tree", "ward_tree"]

ROW_BLOCK = 4096


@dataclasses.dataclass
class Tree:
    """R hclust-shaped tree: merge (n − 1, 2) codes (−(leaf + 1) for a
    leaf, the 1-based row of an earlier merge otherwise), non-decreasing
    heights and the leaf order."""

    merge: np.ndarray
    height: np.ndarray
    order: np.ndarray

    @property
    def n_leaves(self) -> int:
        return self.merge.shape[0] + 1


def _nearest(cent: torch.Tensor, size: torch.Tensor):
    m = cent.shape[0]
    sq = (cent * cent).sum(dim=1)
    best = torch.empty(m, dtype=cent.dtype, device=cent.device)
    arg = torch.empty(m, dtype=torch.int64, device=cent.device)
    for r0 in range(0, m, ROW_BLOCK):
        blk = cent[r0:r0 + ROW_BLOCK]
        b = blk.shape[0]
        d2 = (sq[r0:r0 + b, None] + sq[None, :] - 2.0 * (blk @ cent.T)
              ).clamp_min_(0.0)
        s = size[r0:r0 + b, None]
        d2 *= 2.0 * s * size[None, :] / (s + size[None, :])
        d2[torch.arange(b, device=cent.device),
           torch.arange(r0, r0 + b, device=cent.device)] = float("inf")
        best[r0:r0 + b], arg[r0:r0 + b] = d2.min(dim=1)
    return best, arg


def ward_tree(points: np.ndarray, device, dtype=torch.float64,
              sizes=None) -> Tree:
    """Ward.D2 over the points, each a cluster of ``sizes`` (1 each by
    default: a pooled tree weights its centroids by their occupancy)."""
    x = torch.as_tensor(np.asarray(points), device=device).to(dtype)
    n = x.shape[0]
    cent = x.clone()
    size = (torch.ones(n, dtype=dtype, device=device) if sizes is None
            else torch.as_tensor(np.asarray(sizes), device=device).to(dtype))
    slot = torch.arange(n, device=device)
    pairs, heights = [], []
    next_slot = n
    while cent.shape[0] > 1:
        m = cent.shape[0]
        best, nn = _nearest(cent, size)
        idx = torch.arange(m, device=device)
        rnn = (nn[nn] == idx) & (idx < nn)
        a = idx[rnn]
        if a.numel() == 0:
            a = torch.argmin(best).reshape(1)
        b = nn[a]
        sa, sb = size[a], size[b]
        diff = cent[a] - cent[b]
        h = torch.sqrt(2.0 * sa * sb / (sa + sb) * (diff * diff).sum(dim=1))
        new_c = (sa[:, None] * cent[a] + sb[:, None] * cent[b]) \
            / (sa + sb)[:, None]
        pairs.append(torch.stack([slot[a], slot[b]], dim=1))
        heights.append(h)
        new_slot = torch.arange(next_slot, next_slot + a.numel(),
                                device=device)
        next_slot += a.numel()
        keep = torch.ones(m, dtype=torch.bool, device=device)
        keep[a] = False
        keep[b] = False
        cent = torch.cat([cent[keep], new_c])
        size = torch.cat([size[keep], sa + sb])
        slot = torch.cat([slot[keep], new_slot])
    raw_pairs = torch.cat(pairs).cpu().numpy()
    raw_h = torch.cat(heights).to(torch.float64).cpu().numpy()
    return _to_hclust(raw_pairs, raw_h, n)


def _to_hclust(raw_pairs: np.ndarray, raw_h: np.ndarray, n: int) -> Tree:
    """Order raw merges (slot n + r is the cluster raw row r made) by
    height, each after both its children, and rewrite slots as hclust
    codes; the leaf order is a left-first walk from the root."""
    m = n - 1
    dep_count = np.zeros(m, np.int32)
    dependents: list = [[] for _ in range(m)]
    for r in range(m):
        for s in (int(raw_pairs[r, 0]), int(raw_pairs[r, 1])):
            if s >= n:
                dep_count[r] += 1
                dependents[s - n].append(r)
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
    if placed != m:
        raise ValueError("merge list is not a forest")

    def code(s: int) -> int:
        return -(s + 1) if s < n else int(rank_of_raw[s - n]) + 1

    merge = np.zeros((m, 2), np.int32)
    for new_row, raw_row in enumerate(order_rows):
        a = code(int(raw_pairs[raw_row, 0]))
        b = code(int(raw_pairs[raw_row, 1]))
        if (a > 0 > b) or (a < 0 and b < 0 and a < b) or (0 < b < a):
            a, b = b, a
        merge[new_row] = (a, b)
    order = np.zeros(n, np.int64)
    pos = 0
    stack = [m - 1]
    while stack:
        node = stack.pop()
        if node < 0:
            order[pos] = -node - 1
            pos += 1
            continue
        a, b = merge[node]
        stack.append(int(b) - 1 if b > 0 else int(b))
        stack.append(int(a) - 1 if a > 0 else int(a))
    return Tree(merge=merge, height=raw_h[order_rows], order=order)
