"""Silhouette widths from per-cluster distance sums.

The sufficient statistic is S (N, K) = Σ_{j∈cluster k} d(i, j), from the
CUDA kernel ``ops.cuda_kernels.distance_cluster_sums`` on the card (its
plain version on the CPU); the N×N matrix never exists. The torch form of
``scconsensus_tpu/ops/silhouette.py``: ``widths_from_cluster_sums``
(:35-50), ``silhouette_widths`` (:53-82), ``multi_cut_silhouette``
(:85-130), ``pooled_multi_cut_silhouette`` (:133-222),
``pooled_mean_cluster_silhouette`` (:225-233), ``_aggregate_widths``
(:236) and ``mean_cluster_silhouette`` (:255-270).

On a mesh (``mesh_multi_cut_silhouette``) the embedding, (N, d) with
d ≤ 15 and so small beside the N² distance work, goes to this process's
first shard's device (``Mesh.home``: shard 0's in one process) and the kernel scores every cut in one pass. The reference's mesh instead
runs its XLA ring once per cut; the port keeps that ring as
``parallel.ring.sharded_silhouette_widths``, which gives the same widths
(within 1e-4) without the kernel.

Past ``approx_threshold`` the pipeline scores cuts with the pooled
O(N·m) estimator instead: each cluster sum prices the other cells at
their pool centroid. It runs on the device in row blocks of the (N, m)
cell–centroid distances, contracted with each cut's (m, K) count table.

Semantics match ``cluster::silhouette``: a(i) = mean distance to the own
cluster's other members; b(i) = min over other clusters of the mean
distance; s(i) = (b−a)/max(a,b); singletons get 0. The reported scalar is
the mean of per-cluster average widths.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from scconsensus_tpu_torch.device import as_points
from scconsensus_tpu_torch.obs import residency
from scconsensus_tpu_torch.obs.trace import span
from scconsensus_tpu_torch.ops.cuda_kernels import distance_cluster_sums

__all__ = [
    "cut_labels",
    "silhouette_widths",
    "mean_cluster_silhouette",
    "multi_cut_silhouette",
    "mesh_multi_cut_silhouette",
    "pooled_multi_cut_silhouette",
    "pooled_mean_cluster_silhouette",
    "widths_from_cluster_sums",
]


def widths_from_cluster_sums(
    sums: np.ndarray, counts: np.ndarray, own: np.ndarray
) -> np.ndarray:
    """Per-point silhouette widths from S (N, K), cluster sizes (K,), and
    each point's own-cluster index (N,). Self-distance is zero, so the
    own-cluster mean divides by (n_own − 1)."""
    n = sums.shape[0]
    idx = np.arange(n)
    sum_own = sums[idx, own]
    n_own = counts[own]
    a = sum_own / np.maximum(n_own - 1.0, 1.0)
    mean_other = sums / np.maximum(counts[None, :], 1.0)
    mean_other[idx, own] = np.inf
    b = mean_other.min(axis=1)
    s = (b - a) / np.maximum(np.maximum(a, b), 1e-30)
    return np.where(n_own <= 1.0, 0.0, s).astype(np.float32)


def _widths_on_device(sums: torch.Tensor, counts: torch.Tensor,
                      own: torch.Tensor) -> torch.Tensor:
    """``widths_from_cluster_sums`` on tensors, in the same float32
    arithmetic."""
    idx = torch.arange(sums.shape[0], device=sums.device)
    n_own = counts[own]
    a = sums[idx, own] / torch.clamp(n_own - 1.0, min=1.0)
    mean_other = sums / torch.clamp(counts[None, :], min=1.0)
    mean_other[idx, own] = float("inf")
    b = mean_other.min(dim=1).values
    s = (b - a) / torch.clamp(torch.maximum(a, b), min=1e-30)
    return torch.where(n_own <= 1.0, torch.zeros_like(s), s)


def silhouette_widths(x, labels, device=None) -> np.ndarray:
    """Per-cell silhouette widths (N,) from the points x (N, d) and integer
    labels, through the kernel with one cut (C = 1) over the labelled
    cells; cells with label < 0 are excluded (width NaN). ``x``: a tensor
    (the sums run where it lies) or a numpy array (on ``device``, the card
    by default)."""
    labels = np.asarray(labels)
    valid = labels >= 0
    uniq, inv = np.unique(labels[valid], return_inverse=True)
    k = uniq.size
    out = np.full(labels.shape[0], np.nan, np.float32)
    if k < 2:
        return out
    xd = as_points(x, device)
    if not valid.all():
        xd = xd[torch.as_tensor(np.nonzero(valid)[0], device=xd.device)]
    with residency.boundary("silhouette_slab_fetch"):
        ids = torch.as_tensor(inv.astype(np.int32)[:, None],
                              device=xd.device)
        sums = distance_cluster_sums(xd.contiguous(), ids, k).cpu().numpy()
    counts = np.bincount(inv, minlength=k).astype(np.float32)
    out[valid] = widths_from_cluster_sums(sums, counts, inv)
    return out


def mean_cluster_silhouette(x, labels, device=None, mesh=None
                            ) -> Tuple[float, Dict[int, float]]:
    """Mean of the per-cluster average widths (the reference's reported
    silhouette) and the per-cluster breakdown. With a ``mesh`` the sums
    run on the mesh's home device (``mesh_multi_cut_silhouette``)."""
    if mesh is not None:
        if device is not None and not isinstance(x, torch.Tensor):
            x = as_points(x, device)
        return mesh_multi_cut_silhouette(x, [labels], mesh)[0]
    w = silhouette_widths(x, labels, device=device)
    return _aggregate_widths(w, np.asarray(labels))


def cut_labels(labels_list) -> Tuple[np.ndarray, int, list]:
    """The (N, C) int32 cluster ids of C labelings of the same points, the
    ids of cut c offset past those of the cuts before it (label < 0 = no
    cluster in that cut, id −1), the total cluster count K, and per cut
    (labels, valid, uniq, inv, counts)."""
    cuts = []
    cols = []
    k0 = 0
    for labels in labels_list:
        labels = np.asarray(labels)
        valid = labels >= 0
        uniq, inv = np.unique(labels[valid], return_inverse=True)
        ids = np.full(labels.shape[0], -1, np.int32)
        ids[valid] = k0 + inv
        counts = np.bincount(inv, minlength=uniq.size).astype(np.float32)
        cuts.append((labels, valid, uniq, inv, counts))
        cols.append(ids)
        k0 += uniq.size
    return np.ascontiguousarray(np.stack(cols, axis=1)), k0, cuts


def multi_cut_silhouette(x: torch.Tensor, labels_list) -> List[
        Tuple[float, Dict[int, float]]]:
    """Mean silhouette (and per-cluster breakdown) of every labeling in
    ``labels_list`` of the rows of ``x`` (N, d), from one distance pass:
    the cuts' cluster ids go to the kernel together, so the N² distances
    are computed once for all cuts. ``x`` lies on the device the sums run
    on. Returns [(mean_si, per_cluster_dict), …]."""
    ids, k_total, cuts = cut_labels(labels_list)
    n = ids.shape[0]
    with residency.boundary("silhouette_slab_fetch"):
        sums_all = distance_cluster_sums(
            x.to(torch.float32).contiguous(),
            torch.from_numpy(ids).to(x.device), k_total,
        ).cpu().numpy()
    out = []
    c0 = 0
    for labels, valid, uniq, inv, counts in cuts:
        k = uniq.size
        sums = sums_all[valid, c0:c0 + k]
        c0 += k
        w = np.full(n, np.nan, np.float32)
        if k >= 2:
            w[valid] = widths_from_cluster_sums(sums, counts, inv)
        out.append(_aggregate_widths(w, labels))
    return out


def mesh_multi_cut_silhouette(x, labels_list, mesh) -> List[
        Tuple[float, Dict[int, float]]]:
    """``multi_cut_silhouette`` on a mesh: the exact silhouette of every
    cut, also past ``approx_threshold`` (the reference's rule), from one
    kernel pass on ``mesh.home``, this process's first shard's device,
    where the embedding is moved (host input goes there too); across
    processes every rank scores the cuts itself. The fault site ``ring:distance_sums`` fires
    here, where the reference's mesh silhouette runs its ring, so a
    device-loss plan written for it recovers the same way."""
    from scconsensus_tpu_torch.parallel.mesh import require_mesh
    from scconsensus_tpu_torch.robust.faults import fault_point

    mesh = require_mesh(mesh)
    fault_point("ring:distance_sums")
    return multi_cut_silhouette(as_points(x, mesh.home), labels_list)


def pooled_multi_cut_silhouette(
    x,
    labels_list,
    n_centroids: int = 2048,
    seed: int = 0,
    block: int = 65536,
    centroids: Optional[np.ndarray] = None,
    assign: Optional[np.ndarray] = None,
    sample: Optional[int] = None,
    device=None,
) -> List[Tuple[float, Dict[int, float]]]:
    """Pooled silhouette estimator, O(N·m) instead of O(N²).

    Every cluster sum S(i, k) = Σ_{j∈k} d(i, j) is estimated by pricing
    each j at its pool centroid,

        S(i, k) ≈ Σ_p count[p, k] · d(x_i, c_p) − d(x_i, c_{p(i)})·[k = own],

    the own-cluster sum dropping i's own pooled term. ``centroids`` /
    ``assign`` reuse the tree stage's pool; without them a ``kmeans_pool``
    of ``n_centroids`` is fitted. ``sample`` > 0 evaluates widths on a
    seeded row subset (the same draw as the reference's); counts and
    cluster sizes always use every cell. ``x`` is a tensor (the estimator
    runs where it lies) or a numpy array (on ``device``, the card by
    default). Returns [(mean_si, per_cluster_dict), …]."""
    from scconsensus_tpu_torch.ops.pooling import kmeans_pool

    xd = as_points(x, device)
    dev = xd.device
    n = xd.shape[0]
    if centroids is None or assign is None:
        centroids, assign = kmeans_pool(xd, n_centroids, seed=seed)
    with residency.boundary("silhouette_slab_fetch"):
        cents = torch.as_tensor(np.asarray(centroids, np.float32),
                                device=dev)
    assign = np.asarray(assign)
    m = cents.shape[0]

    if sample is not None and sample < n:
        rng = np.random.default_rng(seed)
        eval_idx = np.sort(rng.choice(n, size=int(sample), replace=False))
    else:
        eval_idx = np.arange(n)

    # the card pass (span pooled_widths): per-cut membership tables
    # (m, k) from every cell, the widths block by block, fetched; then
    # the host's per-cluster means (span aggregate)
    with span("pooled_widths", m=int(m), n_cuts=len(labels_list)):
        cuts = []
        for labels in labels_list:
            labels = np.asarray(labels)
            valid = labels >= 0
            uniq, inv = np.unique(labels[valid], return_inverse=True)
            k = uniq.size
            cm = np.bincount(assign[valid] * max(k, 1) + inv,
                             minlength=m * max(k, 1)).astype(np.float32)
            cm = torch.as_tensor(cm.reshape(m, max(k, 1)), device=dev)
            own = np.full(n, -1, np.int64)
            own[valid] = inv
            cuts.append((labels, k, cm, cm.sum(dim=0),
                         torch.as_tensor(own, device=dev),
                         torch.full((n,), float("nan"), dtype=torch.float32,
                                    device=dev)))

        assign_d = torch.as_tensor(assign, device=dev)
        c2 = torch.sum(cents * cents, dim=1)[None, :]
        for b0 in range(0, eval_idx.size, block):
            rows = torch.as_tensor(eval_idx[b0:b0 + block], device=dev)
            xb = xd[rows]
            d2 = (torch.sum(xb * xb, dim=1, keepdim=True)
                  - (2.0 * xb) @ cents.T + c2)
            d = torch.sqrt(torch.clamp(d2, min=0.0))            # (b, m)
            d_self = d[torch.arange(rows.numel(), device=dev),
                       assign_d[rows]]
            for _labels, k, cm, counts, own, w in cuts:
                if k < 2:
                    continue
                ok = torch.nonzero(own[rows] >= 0).squeeze(1)
                ob = own[rows][ok]
                sums = d @ cm                                   # (b, k)
                sums[ok, ob] -= d_self[ok]
                w[rows[ok]] = _widths_on_device(sums[ok], counts, ob)
        with residency.boundary("silhouette_slab_fetch"):
            widths = [w.cpu().numpy() for *_rest, w in cuts]
    with span("aggregate"):
        return [_aggregate_widths(w, cut[0])
                for w, cut in zip(widths, cuts)]


def pooled_mean_cluster_silhouette(x, labels, n_centroids: int = 2048,
                                   seed: int = 0, **kw
                                   ) -> Tuple[float, Dict[int, float]]:
    """Single-cut form of ``pooled_multi_cut_silhouette``."""
    return pooled_multi_cut_silhouette(
        x, [np.asarray(labels)], n_centroids=n_centroids, seed=seed, **kw
    )[0]


def _aggregate_widths(w: np.ndarray, labels: np.ndarray
                      ) -> Tuple[float, Dict[int, float]]:
    """Per-cluster mean widths + mean-of-means (the reference's reported
    SI)."""
    per: Dict[int, float] = {}
    for u in np.unique(labels[labels >= 0]):
        wu = w[labels == u]
        if not np.any(np.isfinite(wu)):
            continue
        per[int(u)] = float(np.nanmean(wu))
    if not per:
        return float("nan"), per
    return float(np.mean(list(per.values()))), per
