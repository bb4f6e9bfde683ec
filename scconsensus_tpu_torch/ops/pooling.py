"""Centroid pooling for the approximate tree past ``approx_threshold``.

The torch form of ``scconsensus_tpu/ops/pooling.py``. Cells are pooled
onto m ≪ N centroids by Lloyd iterations on the device, exact Ward.D2
runs on the centroids (float64, on the host, weighted by occupancy), and
cut labels reach the cells through the pool assignment
(``labels[assign]``). Two engines, as in the reference:

* ``kmeans_pool`` / ``pooled_ward_linkage``: the legacy full-data Lloyd
  (every iteration sweeps all N points), for N in (``approx_threshold``,
  ``landmark_threshold``].
* ``landmark_pool`` / ``landmark_ward_linkage``: k = clamp(c·√N, k_min,
  k_max) landmarks fitted on a seeded sketch, then one blocked
  nearest-landmark pass over every cell.

Points are swept in blocks of 65,536 rows, so the (block, m) distance
tile is the largest temporary (1.07 GB at m = 4,096). The centroid update
is a segment sum (``bincount`` and ``index_add_``), never a (block, m)
one-hot. The seeded numpy draws (initial centroids, sketch) are the
reference's call for call, and each distance tile sums its terms in the
reference's order, so argmins agree. On the card ``index_add_`` adds in
an unspecified order, so centroids may differ from run to run in the last
bits. The reference's integrity checks, fault injection and graph
passports are left out.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from scconsensus_tpu_torch.device import as_points
from scconsensus_tpu_torch.ops.distance import sq_dists
from scconsensus_tpu_torch.ops.linkage import HClustTree, ward_linkage

__all__ = [
    "kmeans_pool",
    "pooled_ward_linkage",
    "landmark_k_policy",
    "landmark_sketch_policy",
    "landmark_pool",
    "landmark_ward_linkage",
    "centroid_majority_labels",
]

# rows per block of every sweep: bounds the live (block, m) distance tile
_LLOYD_BLOCK = 65_536


def _lloyd_argmin(block: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """Nearest centroid of each row, from ‖b‖² − 2·b·cᵀ + ‖c‖² summed in
    that order and not clamped (the legacy ``_lloyd``'s tile)."""
    dist = (torch.sum(block * block, dim=1, keepdim=True)
            - (2.0 * block) @ cent.T
            + torch.sum(cent * cent, dim=1)[None, :])
    return torch.argmin(dist, dim=1)


def _nearest(block: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """Nearest centroid of each row over the clamped ``sq_dists`` tile (the
    landmark engine's)."""
    return torch.argmin(sq_dists(block, cent), dim=1)


def _update(points: torch.Tensor, cent: torch.Tensor, argmin) -> torch.Tensor:
    """One Lloyd step: every centroid moves to the mean of the points
    nearest to it; an empty centroid stays where it is."""
    m, d = cent.shape
    counts = torch.zeros(m, dtype=points.dtype, device=points.device)
    sums = torch.zeros((m, d), dtype=points.dtype, device=points.device)
    for s in range(0, points.shape[0], _LLOYD_BLOCK):
        block = points[s:s + _LLOYD_BLOCK]
        a = argmin(block, cent)
        counts += torch.bincount(a, minlength=m).to(points.dtype)
        sums.index_add_(0, a, block)
    return torch.where(counts[:, None] > 0,
                       sums / torch.clamp(counts, min=1.0)[:, None], cent)


def _assign(points: torch.Tensor, cent: torch.Tensor, argmin) -> torch.Tensor:
    """(N,) nearest centroid of every point, block by block."""
    return torch.cat([argmin(points[s:s + _LLOYD_BLOCK], cent)
                      for s in range(0, points.shape[0], _LLOYD_BLOCK)])


def _used(cent: torch.Tensor, assign: torch.Tensor, m: int
          ) -> Tuple[np.ndarray, np.ndarray]:
    """The (m', d) float64 centroids that own a point, and the assignment
    renumbered onto them."""
    cent = cent.cpu().numpy().astype(np.float64)
    assign = assign.cpu().numpy()
    used = np.unique(assign)
    remap = -np.ones(m, np.int64)
    remap[used] = np.arange(used.size)
    return cent[used], remap[assign]


def kmeans_pool(x, n_centroids: int, n_iter: int = 10, seed: int = 0,
                device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Pool the rows of x (N, d) onto ``n_centroids`` k-means centroids by
    full-data Lloyd. Returns (centroids (m, d) float64, assignment (N,));
    empty centroids are dropped."""
    xd = as_points(x, device)
    n = xd.shape[0]
    m = min(n_centroids, n)
    rng = np.random.default_rng(seed)
    init = xd[torch.as_tensor(rng.choice(n, size=m, replace=False),
                              device=xd.device)]
    cent = init
    for _ in range(n_iter):
        cent = _update(xd, cent, _lloyd_argmin)
    return _used(cent, _assign(xd, cent, _lloyd_argmin), m)


def pooled_ward_linkage(x, n_centroids: int = 4096, n_iter: int = 10,
                        seed: int = 0, device=None
                        ) -> Tuple[HClustTree, np.ndarray, np.ndarray]:
    """Ward tree over k-means centroids, weighted by pool occupancy so that
    heights approximate full-data Ward.D2. Returns (tree, assignment (N,),
    centroids)."""
    cent, assign = kmeans_pool(x, n_centroids, n_iter, seed, device=device)
    counts = np.bincount(assign, minlength=cent.shape[0]).astype(np.float64)
    return ward_linkage(cent, weights=counts), assign, cent


def landmark_k_policy(n: int, c: float = 2.0, k_min: int = 512,
                      k_max: int = 4096) -> int:
    """N-scaled landmark count: ``clamp(c·√N, k_min, k_max)``, rounded up
    to a multiple of 128 when above 128; the caps win over the rounding,
    and k never exceeds N."""
    k = int(math.ceil(c * math.sqrt(max(n, 1))))
    k = min(max(k, int(k_min), 2), int(k_max))
    if k > 128:
        k = min(((k + 127) // 128) * 128, int(k_max))
    return min(k, n)


def landmark_sketch_policy(n: int, k: int) -> int:
    """Rows the landmark Lloyd fits on: about 32 per landmark, at least
    16,384, at most 131,072; always ≥ k and ≤ N."""
    return int(min(n, max(32 * k, 16_384, k), 131_072))


def landmark_pool(x, n_landmarks: Optional[int] = None,
                  sketch: Optional[int] = None, n_iter: int = 10,
                  seed: int = 0, c: float = 2.0, k_min: int = 512,
                  k_max: int = 4096, device=None
                  ) -> Tuple[np.ndarray, np.ndarray, Dict]:
    """Pool the rows of x (N, d) onto k ≪ N landmarks: Lloyd on a seeded
    sketch, then one nearest-landmark pass over every row.

    Returns (centroids (k', d) float64, assignment (N,), info) with empty
    landmarks dropped (k' ≤ k); ``info`` holds k requested and used, the
    sketch size and the iterations."""
    xd = as_points(x, device)
    n = xd.shape[0]
    k = int(n_landmarks) if n_landmarks else landmark_k_policy(
        n, c=c, k_min=k_min, k_max=k_max)
    k = min(k, n)
    s = int(sketch) if sketch else landmark_sketch_policy(n, k)
    s = min(max(s, k), n)
    rng = np.random.default_rng(seed)
    sk_idx = rng.choice(n, size=s, replace=False) if s < n else None
    init_idx = rng.choice(s, size=k, replace=False)
    sk = xd if sk_idx is None else xd[torch.as_tensor(sk_idx,
                                                      device=xd.device)]
    cent = sk[torch.as_tensor(init_idx, device=xd.device)]
    for _ in range(n_iter):
        cent = _update(sk, cent, _nearest)
    cent, assign = _used(cent, _assign(xd, cent, _nearest), k)
    info = {
        "k_requested": int(k),
        "k_used": int(cent.shape[0]),
        "sketch": int(s),
        "n_iter": int(n_iter),
    }
    return cent, assign, info


def landmark_ward_linkage(x, n_landmarks: Optional[int] = None,
                          sketch: Optional[int] = None, n_iter: int = 10,
                          seed: int = 0, c: float = 2.0, k_min: int = 512,
                          k_max: int = 4096, linkage: str = "exact",
                          knn_k: int = 15, mesh=None, device=None
                          ) -> Tuple[HClustTree, np.ndarray, np.ndarray,
                                     Dict]:
    """Landmark tree: occupancy-weighted Ward.D2 over the centroids of
    ``landmark_pool``, by the native NN-chain (``linkage="exact"``) or the
    kNN-graph agglomeration (``"knn"``, ``knn_k`` neighbours a landmark).
    Returns (tree, assignment (N,), centroids, info). ``mesh`` must be
    None: the multi-device path is not ported yet."""
    if mesh is not None:
        raise NotImplementedError("the multi-device (mesh) path is not "
                                  "ported yet; pass mesh=None")
    if linkage not in ("exact", "knn"):
        raise ValueError(
            f"landmark linkage must be 'exact' or 'knn', got {linkage!r}")
    xd = as_points(x, device)
    cent, assign, info = landmark_pool(
        xd, n_landmarks=n_landmarks, sketch=sketch, n_iter=n_iter,
        seed=seed, c=c, k_min=k_min, k_max=k_max)
    counts = np.bincount(assign, minlength=cent.shape[0]).astype(np.float64)
    if linkage == "knn":
        from scconsensus_tpu_torch.ops.knn_linkage import knn_ward_linkage

        tree = knn_ward_linkage(cent, k=knn_k, weights=counts,
                                device=xd.device)
    else:
        tree = ward_linkage(cent, weights=counts)
    info["linkage"] = linkage
    return tree, assign, cent, info


def centroid_majority_labels(assign: np.ndarray, labels: np.ndarray,
                             k: int) -> np.ndarray:
    """Per-landmark cluster labels by majority vote of the cells assigned
    to it; cells labelled 0 (unassigned) do not vote. Returns (k,) int64,
    0 for a landmark without votes; ties go to the smallest label."""
    assign = np.asarray(assign, np.int64)
    labels = np.asarray(labels, np.int64)
    if assign.shape != labels.shape:
        raise ValueError(
            f"assign {assign.shape} and labels {labels.shape} differ")
    out = np.zeros(int(k), np.int64)
    voting = labels > 0
    if not voting.any():
        return out
    a, lab = assign[voting], labels[voting]
    votes = np.zeros((int(k), int(lab.max()) + 1), np.int64)
    np.add.at(votes, (a, lab), 1)
    winners = np.argmax(votes, axis=1)
    has_votes = votes.sum(axis=1) > 0
    out[has_votes] = winners[has_votes]
    return out
