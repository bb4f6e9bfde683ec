"""Cell–cell and cell–centroid distance tiles.

The torch form of ``scconsensus_tpu/ops/distance.py`` ``distance_tile``
and ``_sq_dists_raw`` (:29-38): the one tile that Lloyd's nearest-landmark
pass, the kNN sweep and the pooled silhouette share. Squared distances
are ‖a‖² + ‖b‖² − 2·a·bᵀ, summed in that order and clamped at 0 (the
cancellation can go slightly negative), so that argmins over a tile pick
what the reference's pick.

``pearson_unit_cells`` is the ``distance="pearson"`` embed's input: the
cells centred and scaled to unit norm, so that euclidean distances between
them are sqrt(2·(1 − r)), monotone in the reference's
``pearson_distance_matrix`` (:53-61), which the port never materializes.

Graph passports (``obs.graphs``, ``SCC_GRAPHS``): ``sq_dists`` is the
reference's ``distance.sq_dists`` program, ``pearson_unit_cells`` stands
in for ``distance.pearson_distance_matrix``.
"""

from __future__ import annotations

import torch

from scconsensus_tpu_torch.obs.graphs import instrument as _passport

__all__ = ["sq_dists", "distance_tile", "pearson_unit_cells"]


def sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(Na, Nb) squared euclidean distances between the rows of a and b."""
    a2 = torch.sum(a * a, dim=1, keepdim=True)
    b2 = torch.sum(b * b, dim=1, keepdim=True)
    return torch.clamp(a2 + b2.T - 2.0 * (a @ b.T), min=0.0)


def distance_tile(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(Na, Nb) euclidean distances between the rows of a and b."""
    return torch.sqrt(sq_dists(a, b))


def pearson_unit_cells(cols: torch.Tensor) -> torch.Tensor:
    """The columns (cells) of ``cols`` (genes × cells) centred over genes
    and scaled to unit norm."""
    c = cols - cols.mean(dim=0, keepdim=True)
    norm = torch.linalg.norm(c, dim=0, keepdim=True)
    return c / torch.clamp(norm, min=1e-12)


sq_dists = _passport("distance.sq_dists", sq_dists)
pearson_unit_cells = _passport("distance.pearson_distance_matrix",
                               pearson_unit_cells)
