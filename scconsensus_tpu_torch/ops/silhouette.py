"""Silhouette widths from per-cluster distance sums.

The sufficient statistic is S (N, K) = Σ_{j∈cluster k} d(i, j), from the
CUDA kernel ``ops.cuda_kernels.distance_cluster_sums`` on the card (its
plain version on the CPU); the N×N matrix never exists. The width
arithmetic is a copy of ``scconsensus_tpu/ops/silhouette.py``
``widths_from_cluster_sums`` (:35-50), ``multi_cut_silhouette`` (:85-130)
and ``_aggregate_widths`` (:236).

Semantics match ``cluster::silhouette``: a(i) = mean distance to the own
cluster's other members; b(i) = min over other clusters of the mean
distance; s(i) = (b−a)/max(a,b); singletons get 0. The reported scalar is
the mean of per-cluster average widths.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from scconsensus_tpu_torch.ops.cuda_kernels import distance_cluster_sums

__all__ = ["widths_from_cluster_sums", "cut_labels", "multi_cut_silhouette"]


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
