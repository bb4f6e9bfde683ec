"""Cell–cell and cell–centroid distance tiles.

The torch form of ``scconsensus_tpu/ops/distance.py`` ``distance_tile``
and ``_sq_dists_raw`` (:29-38): the one tile that Lloyd's nearest-landmark
pass, the kNN sweep and the pooled silhouette share. Squared distances
are ‖a‖² + ‖b‖² − 2·a·bᵀ, summed in that order and clamped at 0 (the
cancellation can go slightly negative), so that argmins over a tile pick
what the reference's pick.
"""

from __future__ import annotations

import torch

__all__ = ["sq_dists", "distance_tile"]


def sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(Na, Nb) squared euclidean distances between the rows of a and b."""
    a2 = torch.sum(a * a, dim=1, keepdim=True)
    b2 = torch.sum(b * b, dim=1, keepdim=True)
    return torch.clamp(a2 + b2.T - 2.0 * (a @ b.T), min=0.0)


def distance_tile(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(Na, Nb) euclidean distances between the rows of a and b."""
    return torch.sqrt(sq_dists(a, b))
