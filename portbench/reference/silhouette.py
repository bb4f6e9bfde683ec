"""Exact silhouettes of a labelling (``cluster::silhouette`` semantics).

For each labelled cell i (label > 0): a(i) = mean distance to the other
members of its cluster, b(i) = least mean distance to another cluster,
s(i) = (b − a) / max(a, b), 0 for a singleton. The reported value is the
mean over clusters of each cluster's mean width, NaN with fewer than two
clusters. The per-cluster distance sums come from row blocks of the
(N, N) euclidean distances, contracted with the cluster one-hot.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["mean_silhouette"]

ROW_BLOCK = 4096


def mean_silhouette(points: np.ndarray, labels: np.ndarray, device,
                    dtype=torch.float64) -> float:
    labels = np.asarray(labels)
    valid = labels > 0
    uniq, inv = np.unique(labels[valid], return_inverse=True)
    k = uniq.size
    if k < 2:
        return math.nan
    x = torch.as_tensor(np.asarray(points)[valid], device=device).to(dtype)
    own = torch.as_tensor(inv, device=device)
    onehot = (own[:, None] == torch.arange(k, device=device)[None, :]
              ).to(dtype)
    counts = onehot.sum(dim=0)
    sq = (x * x).sum(dim=1)
    n = x.shape[0]
    widths = torch.empty(n, dtype=dtype, device=device)
    for r0 in range(0, n, ROW_BLOCK):
        blk = x[r0:r0 + ROW_BLOCK]
        b = blk.shape[0]
        d = torch.sqrt((sq[r0:r0 + b, None] + sq[None, :]
                        - 2.0 * (blk @ x.T)).clamp_min_(0.0))
        d[torch.arange(b, device=device),
          torch.arange(r0, r0 + b, device=device)] = 0.0
        sums = d @ onehot                                     # (b, K)
        mine = own[r0:r0 + b]
        rows = torch.arange(b, device=device)
        n_own = counts[mine]
        a = sums[rows, mine] / torch.clamp(n_own - 1.0, min=1.0)
        other = sums / torch.clamp(counts, min=1.0)[None, :]
        other[rows, mine] = math.inf
        bb = other.min(dim=1).values
        s = (bb - a) / torch.clamp(torch.maximum(a, bb), min=1e-30)
        widths[r0:r0 + b] = torch.where(n_own <= 1.0, torch.zeros_like(s), s)
    per = torch.zeros(k, dtype=dtype, device=device).index_add_(
        0, own, widths) / counts
    return float(per.mean())
