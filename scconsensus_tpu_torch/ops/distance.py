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
``pearson_distance_matrix`` (:53-61). The pipeline never materializes an
N×N matrix; ``euclidean_distance_matrix``, ``pearson_distance_matrix`` and
``distance_row_blocks`` (:45-86) are the reference's full-matrix and
row-block forms, for callers whose N² fits.

Graph passports (``obs.graphs``, ``SCC_GRAPHS``): ``sq_dists`` is the
reference's ``distance.sq_dists`` program, ``pearson_unit_cells`` stands
in for ``distance.pearson_distance_matrix``.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

from scconsensus_tpu_torch.device import as_points
from scconsensus_tpu_torch.obs.graphs import instrument as _passport

__all__ = ["sq_dists", "euclidean_distance_matrix", "pearson_distance_matrix",
           "distance_row_blocks", "distance_tile", "pearson_unit_cells"]


def sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(Na, Nb) squared euclidean distances between the rows of a and b."""
    a2 = torch.sum(a * a, dim=1, keepdim=True)
    b2 = torch.sum(b * b, dim=1, keepdim=True)
    return torch.clamp(a2 + b2.T - 2.0 * (a @ b.T), min=0.0)


def distance_tile(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(Na, Nb) euclidean distances between the rows of a and b."""
    return torch.sqrt(sq_dists(a, b))


def euclidean_distance_matrix(x) -> torch.Tensor:
    """The full (N, N) euclidean distance matrix of the rows of ``x`` (a
    tensor where it lies, a numpy array on the card), with an exact zero
    diagonal despite the cancellation. Only where N² fits."""
    x = as_points(x)
    d = torch.sqrt(sq_dists(x, x))
    return d.fill_diagonal_(0.0)


def pearson_distance_matrix(cols) -> torch.Tensor:
    """1 − the Pearson correlation between the columns (cells) of ``cols``
    (genes × cells): 1 − xnᵀ·xn over the centred, unit-norm columns."""
    xn = pearson_unit_cells(as_points(cols))
    return 1.0 - xn.T @ xn


def distance_row_blocks(x, block: int = 4096
                        ) -> Iterator[Tuple[int, int, np.ndarray]]:
    """Stream (start, stop, D[start:stop, :]) euclidean row-blocks of the
    distance matrix to the host, with an exact zero self-distance, without
    an N×N matrix anywhere. ``x``: a tensor where it lies, or a numpy
    array, uploaded to the card. Each fetch is a declared crossing of the
    reference's ``silhouette_slab_fetch`` boundary."""
    from scconsensus_tpu_torch.obs.residency import boundary

    with boundary("silhouette_slab_fetch"):
        xd = as_points(x)
    n = xd.shape[0]
    for s in range(0, n, block):
        e = min(s + block, n)
        with boundary("silhouette_slab_fetch"):
            d = torch.sqrt(sq_dists(xd[s:e], xd)).cpu().numpy()
        d[np.arange(e - s), np.arange(s, e)] = 0.0
        yield s, e, d


def pearson_unit_cells(cols: torch.Tensor) -> torch.Tensor:
    """The columns (cells) of ``cols`` (genes × cells) centred over genes
    and scaled to unit norm."""
    c = cols - cols.mean(dim=0, keepdim=True)
    norm = torch.linalg.norm(c, dim=0, keepdim=True)
    return c / torch.clamp(norm, min=1e-12)


sq_dists = _passport("distance.sq_dists", sq_dists)
pearson_unit_cells = _passport("distance.pearson_distance_matrix",
                               pearson_unit_cells)
