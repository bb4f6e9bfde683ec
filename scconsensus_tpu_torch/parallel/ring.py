"""Ring-rotation distance collectives: cell blocks around the mesh.

The torch form of ``scconsensus_tpu/parallel/ring.py``. Cells shard into
blocks across the mesh; each step of the ring computes one (local block ×
visiting block) distance tile per shard, folds it into a running
accumulator and :func:`~parallel.mesh.ppermute` s the visiting blocks on
by one shard, so the N×N matrix never exists and no shard holds more than
N/n_shards rows of distance work. The tile is ``ops.distance``'s, the
fold a ``torch.matmul``: the reference computes the ring body with XLA,
outside any Pallas kernel, so it stays plain tensor code here.

Two folds: the per-cluster distance sums behind the silhouette
(:func:`ring_cluster_distance_sums`, fault site ``ring:distance_sums``)
and a running top-k for the kNN graph (:func:`ring_knn`). Each ring step
sweeps the local rows in blocks whose tile against the visiting block
holds at most ``_TILE_ELEMS`` elements, the budget of the one-device
sweep, which ``ring_knn`` without a mesh runs: each row block against
all N cells, the live tile (block, N).

``refine()``'s silhouette on a mesh does not take the ring: it runs the
CUDA kernel over the whole embedding on the mesh's home device
(``ops.silhouette.mesh_multi_cut_silhouette``), one pass for every cut.
The ring sums and :func:`sharded_silhouette_widths` are the reference's
engine API, held against it in the tests and used by the fused step
(``parallel.step``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from scconsensus_tpu_torch.device import as_points
from scconsensus_tpu_torch.ops.distance import distance_tile
from scconsensus_tpu_torch.parallel.mesh import (
    CELL_AXIS,
    Mesh,
    _as_tensor,
    gather,
    make_mesh,
    pad_and_shard,
    ppermute,
    require_dense,
    require_mesh,
)

__all__ = ["ring_cluster_distance_sums", "sharded_silhouette_widths",
           "ring_knn"]

# elements of the live distance tile, (block, N) or (block, visiting
# block): 512 MB of float32
_TILE_ELEMS = 1 << 27


def _row_blocks(n_rows: int, n_cols: int):
    """Row slices whose (rows, n_cols) tile fits ``_TILE_ELEMS``."""
    step = max(1, _TILE_ELEMS // max(n_cols, 1))
    return [slice(r, r + step) for r in range(0, n_rows, step)]


def _points_for(x, mesh: Mesh) -> torch.Tensor:
    """Dense float32 points: a tensor where it lies, host input on shard
    0's device."""
    require_dense(x)
    if isinstance(x, torch.Tensor):
        return as_points(x)
    return as_points(x, mesh.home)


def _ring_sums(mesh: Mesh, xs: List[torch.Tensor],
               ohs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Per shard: Σ over every cell block of distance(local, block) @
    block's one-hot, the blocks visiting in the reference's order (shard s
    sees block s, s−1, …), the local rows swept in tile-budget blocks."""
    accs = [torch.zeros((x.shape[0], o.shape[1]), dtype=torch.float32,
                        device=x.device) for x, o in zip(xs, ohs)]
    ys, oys = list(xs), list(ohs)
    for step in range(mesh.size):
        for s in range(len(xs)):  # this process's shards
            for r in _row_blocks(xs[s].shape[0], ys[s].shape[0]):
                accs[s][r] += distance_tile(xs[s][r], ys[s]) @ oys[s]
        if step + 1 < mesh.size:
            ys, oys = ppermute(ys, mesh), ppermute(oys, mesh)
    return accs


def ring_cluster_distance_sums(
    x,
    onehot,
    mesh: Optional[Mesh] = None,
    axis_name: str = CELL_AXIS,
) -> torch.Tensor:
    """(N, K) summed distance from every cell to every cluster,
    cell-sharded. x: (N, d) embedding; onehot: (N, K) membership (zero
    rows allowed: padding or unassigned cells count for no cluster).
    Returns a tensor on the device x lay on (shard 0's for host input)."""
    mesh = require_mesh(mesh or make_mesh(axis_name=axis_name))
    require_dense(onehot)
    # a device_loss here models a device dying in the rotation (the
    # silhouette stage guard's supervisor recovers)
    from scconsensus_tpu_torch.robust.faults import fault_point

    fault_point("ring:distance_sums")
    xd = _points_for(x, mesh)
    n = xd.shape[0]
    xs, _ = pad_and_shard(xd, mesh, 0)
    ohs, _ = pad_and_shard(_as_tensor(onehot).to(torch.float32), mesh, 0)
    return gather(_ring_sums(mesh, xs, ohs), 0, xd.device, mesh=mesh)[:n]


def sharded_silhouette_widths(
    x,
    labels,
    mesh: Optional[Mesh] = None,
    axis_name: str = CELL_AXIS,
) -> np.ndarray:
    """Per-cell silhouette widths through the ring engine; label < 0 →
    NaN. ``ops.silhouette.silhouette_widths``'s semantics
    (``cluster::silhouette``) with the distance work spread over the
    mesh."""
    from scconsensus_tpu_torch.ops.silhouette import widths_from_cluster_sums

    labels = np.asarray(labels)
    n = labels.shape[0]
    valid = labels >= 0
    out = np.full(n, np.nan, np.float32)
    uniq, inv_all = np.unique(labels[valid], return_inverse=True)
    k = uniq.size
    if k < 2:
        return out
    onehot = np.zeros((n, k), np.float32)
    onehot[np.nonzero(valid)[0], inv_all] = 1.0
    from scconsensus_tpu_torch.obs import residency

    with residency.boundary("silhouette_slab_fetch"):
        sums = ring_cluster_distance_sums(x, onehot, mesh,
                                          axis_name).cpu().numpy()
    iv = np.nonzero(valid)[0]
    out[iv] = widths_from_cluster_sums(sums[iv], onehot.sum(axis=0),
                                       inv_all)
    return out


def _ring_knn(mesh: Mesh, xd: torch.Tensor, k: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Running k-NN over the ring: each shard keeps (distances, global
    indices) of its rows' k nearest among the blocks seen so far, the
    local rows swept in tile-budget blocks."""
    n = xd.shape[0]
    xs, n_pad = pad_and_shard(xd, mesh, 0)
    # padding rows carry index −2: never a real self index, and masked
    # to +inf as candidates
    gidx = torch.arange(n + n_pad, dtype=torch.int64, device=xd.device)
    gidx[n:] = -2
    ids, _ = pad_and_shard(gidx, mesh, 0)
    best_d = [torch.full((b.shape[0], k), float("inf"), device=b.device)
              for b in xs]
    best_i = [torch.full((b.shape[0], k), -1, dtype=torch.int64,
                         device=b.device) for b in xs]
    ys, yids = list(xs), list(ids)
    for step in range(mesh.size):
        for s in range(len(xs)):  # this process's shards
            for r in _row_blocks(xs[s].shape[0], ys[s].shape[0]):
                d = distance_tile(xs[s][r], ys[s])
                drop = (ids[s][r, None] == yids[s][None, :]) \
                    | (yids[s] < 0)[None, :]
                d = torch.where(drop, torch.full_like(d, float("inf")), d)
                cat_d = torch.cat([best_d[s][r], d], dim=1)
                cat_i = torch.cat(
                    [best_i[s][r], yids[s][None, :].expand(d.shape)], dim=1)
                best_d[s][r], pos = torch.topk(cat_d, k, dim=1,
                                               largest=False, sorted=True)
                best_i[s][r] = torch.gather(cat_i, 1, pos)
        if step + 1 < mesh.size:
            ys, yids = ppermute(ys, mesh), ppermute(yids, mesh)
    return (gather(best_d, 0, xd.device, mesh=mesh)[:n],
            gather(best_i, 0, xd.device, mesh=mesh)[:n])


def ring_knn(x, k: int, mesh: Optional[Mesh] = None,
             block: Optional[int] = None, device=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest neighbours of every row of x (N, d), self excluded.

    Returns (distances (N, k) float32, indices (N, k) int64) on the
    device of the points, nearest first. With a ``mesh`` the cell blocks
    rotate around it; without one ``block`` rows are swept at a time on
    one device (default: a (block, N) tile of 2^27 elements). Neither
    changes the result away from ties. ``k`` must be < N."""
    if mesh is not None:
        mesh = require_mesh(mesh)
    xd = as_points(x, device) if device is not None or mesh is None \
        else _points_for(x, mesh)
    n = xd.shape[0]
    if k >= n:
        raise ValueError(f"k={k} must be < n_points={n} (self excluded)")
    if mesh is not None:
        return _ring_knn(mesh, xd, int(k))
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
