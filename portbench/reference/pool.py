"""The pool branch past ``approx_threshold``, worked out again from the
job's embedding.

The judge uses the pool for the pooled silhouette alone: at 100,000 cells
and 4,096 centroids, Lloyd's steps reach a different pool from rounding
alone on some seeds (float32 and float64 runs of this module differ there
by tens of cells and move centroids by ~0.1), and the tree's near-tied top
merges and the cuts follow, so the program's tree and cut are held only
to ``pool_cut_structure``. The control builds the whole branch.

The port states the branch (``approx_method="pool"``, N ≤ the landmark
threshold) so: m = min(``n_pool_centroids``, N) initial centroids are the
rows ``numpy.random.default_rng(random_seed).choice(N, m, replace=False)``
of the embedding; ten Lloyd steps each move every centroid to the mean of
the points nearest to it (squared distance ‖x‖² − 2·x·c + ‖c‖², an empty
centroid stays); every point takes its nearest centroid, and centroids
that own no point are dropped, the rest kept in index order. The tree is
Ward.D2 over those centroids with their occupancy as sizes; each
deepSplit's cut runs on the centroids with the size floor scaled by the
average occupancy, max(2, round(min_cluster_size / max(N / m', 1))), and
every cell takes its centroid's label. The silhouette is the pooled
estimator: the distance sum from cell i to cluster k is priced at the
centroids, S(i, k) = Σ_p count[p, k] · ‖x_i − c_p‖, less
‖x_i − c_{p(i)}‖ for i's own cluster, and the widths and their mean of
cluster means follow as for exact silhouettes.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from reference.treecut import cutree_hybrid
from reference.ward import Tree, ward_tree

__all__ = ["N_ITER", "lloyd_pool", "pool_tree", "pool_cut",
           "pooled_silhouette", "pool_cut_structure", "pool_silhouette_gap"]

N_ITER = 10
ROW_BLOCK = 16384


def _nearest(x: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    c2 = (cent * cent).sum(dim=1)[None, :]
    out = []
    for r0 in range(0, x.shape[0], ROW_BLOCK):
        b = x[r0:r0 + ROW_BLOCK]
        d2 = (b * b).sum(dim=1, keepdim=True) - 2.0 * (b @ cent.T) + c2
        out.append(d2.argmin(dim=1))
    return torch.cat(out)


def lloyd_pool(points: np.ndarray, n_centroids: int, seed: int, device,
               dtype=torch.float64, n_iter: int = N_ITER
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(used centroids (m', d) float64, assignment (N,) onto them)."""
    x = torch.as_tensor(np.asarray(points), device=device).to(dtype)
    n, d = x.shape
    m = min(int(n_centroids), n)
    init = np.random.default_rng(int(seed)).choice(n, size=m, replace=False)
    cent = x[torch.as_tensor(init, device=device)]
    for _ in range(n_iter):
        a = _nearest(x, cent)
        counts = torch.bincount(a, minlength=m).to(dtype)
        sums = torch.zeros((m, d), dtype=dtype, device=device).index_add_(
            0, a, x)
        cent = torch.where(counts[:, None] > 0,
                           sums / counts.clamp(min=1.0)[:, None], cent)
    a = _nearest(x, cent).cpu().numpy()
    used = np.unique(a)
    remap = -np.ones(m, np.int64)
    remap[used] = np.arange(used.size)
    return (cent.to(torch.float64).cpu().numpy()[used], remap[a])


def pool_tree(cent: np.ndarray, assign: np.ndarray, device,
              dtype=torch.float64) -> Tree:
    """Ward.D2 over the centroids, each weighted by its occupancy."""
    counts = np.bincount(assign, minlength=cent.shape[0])
    return ward_tree(cent, device, dtype=dtype, sizes=counts)


def pool_cut(tree: Tree, cent: np.ndarray, assign: np.ndarray,
             deep_split: int, min_cluster_size: int) -> np.ndarray:
    """One deepSplit's per-cell labels: the cut of the centroid tree with
    the size floor scaled by the average occupancy, broadcast to cells."""
    avg = max(assign.shape[0] / cent.shape[0], 1.0)
    floor = max(2, int(round(min_cluster_size / avg)))
    return cutree_hybrid(tree, cent, deep_split=int(deep_split),
                         min_cluster_size=floor)[assign]


def pooled_silhouette(points: np.ndarray, labels: np.ndarray,
                      cent: np.ndarray, assign: np.ndarray, device,
                      dtype=torch.float64) -> float:
    """The pooled estimator's mean of cluster-mean widths for ``labels``
    (label > 0 clustered), NaN with fewer than two clusters."""
    labels = np.asarray(labels)
    valid = labels > 0
    uniq, inv = np.unique(labels[valid], return_inverse=True)
    k = uniq.size
    if k < 2:
        return math.nan
    m = cent.shape[0]
    cm = np.bincount(assign[valid] * k + inv, minlength=m * k).reshape(m, k)
    cm_t = torch.as_tensor(cm, device=device).to(dtype)
    counts = cm_t.sum(dim=0)
    c = torch.as_tensor(cent, device=device).to(dtype)
    c2 = (c * c).sum(dim=1)[None, :]
    x_all = torch.as_tensor(np.asarray(points)[valid], device=device)
    own_all = torch.as_tensor(inv, device=device)
    p_all = torch.as_tensor(assign[valid], device=device)
    widths = torch.empty(x_all.shape[0], dtype=dtype, device=device)
    for r0 in range(0, x_all.shape[0], ROW_BLOCK):
        xb = x_all[r0:r0 + ROW_BLOCK].to(dtype)
        rows = torch.arange(xb.shape[0], device=device)
        dist = torch.sqrt(((xb * xb).sum(dim=1, keepdim=True)
                           - 2.0 * (xb @ c.T) + c2).clamp_min_(0.0))
        sums = dist @ cm_t
        own = own_all[r0:r0 + ROW_BLOCK]
        sums[rows, own] -= dist[rows, p_all[r0:r0 + ROW_BLOCK]]
        n_own = counts[own]
        a = sums[rows, own] / torch.clamp(n_own - 1.0, min=1.0)
        other = sums / torch.clamp(counts, min=1.0)[None, :]
        other[rows, own] = math.inf
        b = other.min(dim=1).values
        s = (b - a) / torch.clamp(torch.maximum(a, b), min=1e-30)
        widths[r0:r0 + ROW_BLOCK] = torch.where(n_own <= 1.0,
                                                torch.zeros_like(s), s)
    per = torch.zeros(k, dtype=dtype, device=device).index_add_(
        0, own_all, widths) / torch.bincount(own_all, minlength=k).to(dtype)
    return float(per.mean())


def pool_cut_structure(labels: Dict[int, np.ndarray], n_cells: int,
                       n_leaves: int) -> float:
    """Violations of what a pooled cut is, whatever the tree: every cell
    labelled with an integer ≥ 0; each deepSplit's clusters numbered
    1..K with K ≤ the tree's leaves; and no more distinct label tuples
    across deepSplits than leaves, since the cells of one centroid share
    every label."""
    bad = 0.0
    tuples = []
    for lab in labels.values():
        lab = np.asarray(lab)
        if lab.shape != (n_cells,) or lab.dtype.kind not in "iu":
            return math.inf
        bad += float(np.count_nonzero(lab < 0))
        ks = np.unique(lab[lab > 0])
        bad += float(ks.size - np.count_nonzero(ks == np.arange(1, ks.size + 1)))
        bad += float(max(0, ks.size - n_leaves))
        tuples.append(lab)
    if tuples:
        n_tuples = np.unique(np.stack(tuples, axis=1), axis=0).shape[0]
        bad += float(max(0, n_tuples - n_leaves))
    return bad


def pool_silhouette_gap(silhouettes: Dict[int, float],
                        ref_sils: Dict[int, float]) -> float:
    """The largest |Δ| of a deepSplit's silhouette from the reference's,
    0 where both are NaN."""
    gap = 0.0
    for d, r in ref_sils.items():
        s = silhouettes.get(d, math.nan)
        if math.isnan(s) or math.isnan(r):
            gap = max(gap, 0.0 if math.isnan(s) and math.isnan(r)
                      else math.inf)
        else:
            gap = max(gap, abs(s - r))
    return gap
