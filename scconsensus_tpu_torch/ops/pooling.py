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
bits. The landmark assignment carries the reference's integrity tier
(the ``landmark_assign`` corruption site, occupancy conservation and a
sampled ghost replay, ``robust.integrity``).

Graph passports (``obs.graphs``, ``SCC_GRAPHS``) under the reference's
names (:249-253): ``_lloyd`` (the legacy full-data Lloyd) is
``landmark.lloyd``, ``_lloyd_sketch`` (Lloyd on the landmark sketch)
``landmark.lloyd_sketch`` and ``_assign_blocks`` (the nearest-landmark
pass over every cell) ``landmark.assign_blocks``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from scconsensus_tpu_torch.device import as_points
from scconsensus_tpu_torch.obs import residency
from scconsensus_tpu_torch.obs.graphs import instrument as _passport
from scconsensus_tpu_torch.ops.distance import sq_dists
from scconsensus_tpu_torch.ops.linkage import HClustTree, ward_linkage
from scconsensus_tpu_torch.robust import faults
from scconsensus_tpu_torch.robust import integrity as robust_integrity

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


def _lloyd(points: torch.Tensor, cent: torch.Tensor, n_iter: int
           ) -> torch.Tensor:
    """``n_iter`` full-data Lloyd steps over the unclamped tile."""
    for _ in range(n_iter):
        cent = _update(points, cent, _lloyd_argmin)
    return cent


def _lloyd_sketch(sketch: torch.Tensor, cent: torch.Tensor, n_iter: int
                  ) -> torch.Tensor:
    """``n_iter`` Lloyd steps over the landmark sketch (clamped tile)."""
    for _ in range(n_iter):
        cent = _update(sketch, cent, _nearest)
    return cent


def _assign_blocks(points: torch.Tensor, cent: torch.Tensor
                   ) -> torch.Tensor:
    """The nearest landmark of every point, block by block."""
    return _assign(points, cent, _nearest)


_lloyd = _passport("landmark.lloyd", _lloyd)
_lloyd_sketch = _passport("landmark.lloyd_sketch", _lloyd_sketch)
_assign_blocks = _passport("landmark.assign_blocks", _assign_blocks)


def _host(cent: torch.Tensor, assign: torch.Tensor, boundary: str
          ) -> Tuple[np.ndarray, np.ndarray]:
    """Centroids (float64) and assignment on the host, the declared
    ``boundary``'s two crossings."""
    with residency.boundary(boundary):
        return cent.cpu().numpy().astype(np.float64), assign.cpu().numpy()


def _used(cent: np.ndarray, assign: np.ndarray, m: int
          ) -> Tuple[np.ndarray, np.ndarray]:
    """The (m', d) centroids that own a point, and the assignment
    renumbered onto them."""
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
    cent = _lloyd(xd, init, n_iter)
    return _used(*_host(cent, _assign(xd, cent, _lloyd_argmin),
                        "tree_pool_fetch"), m)


def pooled_ward_linkage(x, n_centroids: int = 4096, n_iter: int = 10,
                        seed: int = 0, device=None
                        ) -> Tuple[HClustTree, np.ndarray, np.ndarray]:
    """Ward tree over k-means centroids, weighted by pool occupancy so that
    heights approximate full-data Ward.D2. Returns (tree, assignment (N,),
    centroids)."""
    cent, assign = kmeans_pool(x, n_centroids, n_iter, seed, device=device)
    counts = np.bincount(assign, minlength=cent.shape[0]).astype(np.float64)
    return ward_linkage(cent, weights=counts), assign, cent


def _charge_staging(x, charge) -> None:
    """Price the (N, d) float32 staging of ``x`` through ``charge``."""
    if charge is not None:
        charge(int(x.shape[0]) * int(x.shape[1]) * 4, "landmark_staging")


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
                  k_max: int = 4096, device=None, charge=None
                  ) -> Tuple[np.ndarray, np.ndarray, Dict]:
    """Pool the rows of x (N, d) onto k ≪ N landmarks: Lloyd on a seeded
    sketch, then one nearest-landmark pass over every row.

    Returns (centroids (k', d) float64, assignment (N,), info) with empty
    landmarks dropped (k' ≤ k); ``info`` holds k requested and used, the
    sketch size and the iterations.

    ``charge(nbytes, what)`` (optional): the out-of-core runner's budget
    hook, called with the (N, d) float32 staging's bytes as
    ``landmark_staging`` before the staging exists, so a breach raises
    typed ``HostBudgetExceeded`` before the allocation."""
    _charge_staging(x, charge)
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
    cent = _lloyd_sketch(sk, sk[torch.as_tensor(init_idx,
                                                device=xd.device)], n_iter)
    cent, assign = _host(cent, _assign_blocks(xd, cent),
                         "landmark_assign_fetch")
    # the integrity tier: the injected corruption site, occupancy
    # conservation, and once per run the float64 ghost replay of a seeded
    # 256-row block against the fetched landmarks; a detection raises
    # typed silent_corruption inside the tree stage's guard
    assign = faults.corrupt_value("landmark_assign", assign)
    if robust_integrity.enabled():
        robust_integrity.check_landmark_occupancy(
            "landmark_assign", assign, k, n)
        if robust_integrity.current().want_replay("landmark", 0):
            blk = robust_integrity._sample_idx(n, 256)
            robust_integrity.replay_landmark_block(
                "landmark_assign",
                xd[torch.as_tensor(blk, device=xd.device)], cent,
                assign[blk], unit="block0")
    cent, assign = _used(cent, assign, k)
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
                          knn_k: int = 15, mesh=None, device=None,
                          charge=None
                          ) -> Tuple[HClustTree, np.ndarray, np.ndarray,
                                     Dict]:
    """Landmark tree: occupancy-weighted Ward.D2 over the centroids of
    ``landmark_pool``, by the native NN-chain (``linkage="exact"``) or the
    kNN-graph agglomeration (``"knn"``, ``knn_k`` neighbours a landmark).
    Returns (tree, assignment (N,), centroids, info). ``mesh``: an
    optional ``parallel.mesh.Mesh`` for the kNN linkage's ring sweep over
    the landmarks (``"knn"`` only; the reference's :374-403).
    ``charge``: see ``landmark_pool``."""
    if mesh is not None:
        from scconsensus_tpu_torch.parallel.mesh import require_mesh

        mesh = require_mesh(mesh)
    if linkage not in ("exact", "knn"):
        raise ValueError(
            f"landmark linkage must be 'exact' or 'knn', got {linkage!r}")
    _charge_staging(x, charge)
    xd = as_points(x, device)
    cent, assign, info = landmark_pool(
        xd, n_landmarks=n_landmarks, sketch=sketch, n_iter=n_iter,
        seed=seed, c=c, k_min=k_min, k_max=k_max)
    counts = np.bincount(assign, minlength=cent.shape[0]).astype(np.float64)
    if linkage == "knn":
        from scconsensus_tpu_torch.ops.knn_linkage import knn_ward_linkage

        tree = knn_ward_linkage(cent, k=knn_k, weights=counts,
                                device=xd.device, mesh=mesh)
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
