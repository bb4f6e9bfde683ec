"""k nearest neighbours of every cell, on one device.

The one-device form of ``scconsensus_tpu/parallel/ring.py`` ``ring_knn``
(:145-206). The reference rotates cell blocks around a device mesh and
keeps a running top-k; on a one-device mesh that is a single (N, N) tile
(40 GB at 100k cells). Here the rows go in blocks, each against all N
cells, so the live tile is (block, N), and ``torch.topk`` keeps the k
smallest distances of each row, self excluded. The multi-device ring
waits for the mesh slice of the port.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from scconsensus_tpu_torch.device import as_points
from scconsensus_tpu_torch.ops.distance import distance_tile

__all__ = ["ring_knn"]

# elements of the live (block, N) distance tile: 512 MB of float32
_TILE_ELEMS = 1 << 27


def ring_knn(x, k: int, mesh=None, block: Optional[int] = None,
             device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest neighbours of every row of x (N, d), self excluded.

    Returns (distances (N, k) float32, indices (N, k) int64) on the
    device of the points, nearest first. ``block`` rows are swept at a
    time (default: a (block, N) tile of 2^27 elements); the result does
    not depend on it. ``mesh`` must be None. ``k`` must be < N."""
    if mesh is not None:
        raise NotImplementedError("the multi-device ring is not ported "
                                  "yet; pass mesh=None")
    xd = as_points(x, device)
    n = xd.shape[0]
    if k >= n:
        raise ValueError(f"k={k} must be < n_points={n} (self excluded)")
    if block is None:
        block = max(1, min(n, _TILE_ELEMS // max(n, 1)))
    dist = torch.empty((n, k), dtype=torch.float32, device=xd.device)
    idx = torch.empty((n, k), dtype=torch.int64, device=xd.device)
    for s in range(0, n, block):
        d = distance_tile(xd[s:s + block], xd)
        rows = torch.arange(d.shape[0], device=xd.device)
        d[rows, rows + s] = float("inf")
        dist[s:s + block], idx[s:s + block] = torch.topk(
            d, k, dim=1, largest=False, sorted=True)
    return dist, idx
