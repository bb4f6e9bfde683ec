"""Sharded DE engine stages: cell-sharded aggregates, gene-sharded tests.

The torch form of ``scconsensus_tpu/parallel/sharded_de.py``. Two
sharding roles over the one mesh axis:

  * aggregates: the (G, N)·(N, K) reductions shard the contracted cells
    axis; each shard reduces its cell block and :func:`~parallel.mesh.psum`
    completes the sums;
  * the rank-sum tests: genes are independent, so the gene axis shards
    and every shard sorts its own rows. The per-shard body of
    :func:`sharded_allpairs_ranksum` is the serial engine's scan body
    (``ops.ranksum_allpairs.ranksum_body``): each gene's arithmetic is
    the serial path's, so its log p is too (the rank counts are integers
    and halves, exact in float32).

The fault sites ``sharded:aggregates`` and ``sharded:ranksum`` fire at
each call's entry: a ``device_loss`` there models a device dying inside
the collective and propagates to the stage guard, whose elastic
supervisor shrinks the mesh (``robust.elastic``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from scconsensus_tpu_torch.obs import trace as obs_trace
from scconsensus_tpu_torch.ops.gates import ClusterAggregates
from scconsensus_tpu_torch.obs.cost import attach_cost
from scconsensus_tpu_torch.ops.ranksum_allpairs import ranksum_body
from scconsensus_tpu_torch.ops.wilcoxon import wilcoxon_pairs_tile
from scconsensus_tpu_torch.parallel.mesh import (
    CELL_AXIS,
    Mesh,
    _as_tensor,
    gather,
    make_mesh,
    pad_and_shard,
    psum,
    put_sharded,
    require_dense,
    require_mesh,
)
from scconsensus_tpu_torch.robust.faults import fault_point

__all__ = [
    "sharded_aggregates", "sharded_wilcox_logp", "sharded_allpairs_ranksum",
]


def _as_f32(x) -> torch.Tensor:
    """A dense matrix as float32: a tensor where it lies, numpy on the
    host (each block then moves to its shard)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def _agg_local(data_loc: torch.Tensor, onehot_loc: torch.Tensor
               ) -> Tuple[torch.Tensor, ...]:
    """One shard's partial aggregates of data_loc (G, Nl) against
    onehot_loc (Nl, K): (sum_log, sum_expm1, sum_sq, nnz, counts), in full
    fp32 (TF32 stays off: the sums feed variance cancellations)."""
    return (data_loc @ onehot_loc,
            torch.expm1(data_loc) @ onehot_loc,
            (data_loc * data_loc) @ onehot_loc,
            (data_loc > 0).to(torch.float32) @ onehot_loc,
            onehot_loc.sum(dim=0))


def _aggregates_on(mesh: Mesh, data_blocks: List[torch.Tensor],
                   onehot_blocks: List[torch.Tensor], device
                   ) -> ClusterAggregates:
    """Per-shard partials, then the psum of each statistic (on shard 0's
    device); the sums moved to ``device``."""
    parts = [_agg_local(d, o) for d, o in zip(data_blocks, onehot_blocks)]
    return ClusterAggregates(*(psum([p[f] for p in parts], mesh)[0].to(device)
                               for f in range(5)))


def _onehot_of(cid: torch.Tensor, n_clusters: int) -> torch.Tensor:
    """(Nl, K) float32 one-hot of a shard's cluster ids (−1 = none), built
    on the shard's device."""
    return (cid[:, None] == torch.arange(n_clusters, device=cid.device,
                                         dtype=cid.dtype)[None, :]
            ).to(torch.float32)


def sharded_aggregates(
    data,
    onehot=None,
    mesh: Optional[Mesh] = None,
    axis_name: str = CELL_AXIS,
    cid=None,
    n_clusters: Optional[int] = None,
) -> ClusterAggregates:
    """Cell-sharded ``ClusterAggregates`` (the serial aggregates' result).

    data: (G, N) log-normalized; onehot: (N, K). Or ``cid`` (N,) per-cell
    cluster ids (−1 = excluded) and ``n_clusters`` instead of ``onehot``:
    each shard builds its one-hot slice on its device, so the (N, K)
    membership never crosses. Padding cells (zero data columns, zero
    one-hot rows, id −1) perturb no statistic. ``mesh`` defaults to every
    visible card. The sums land on the device ``data`` lay on (shard 0's
    for host input)."""
    require_dense(data)
    mesh = require_mesh(mesh or make_mesh(axis_name=axis_name))
    with obs_trace.span("sharded_aggregates", n_shards=mesh.size) as sp:
        fault_point("sharded:aggregates")
        x = _as_f32(data)
        out_dev = x.device if isinstance(data, torch.Tensor) \
            else mesh.home
        dp, _ = pad_and_shard(x, mesh, 1)
        if cid is not None:
            if onehot is not None:
                raise ValueError("pass either onehot or cid, not both")
            if n_clusters is None:
                raise ValueError("cid form requires n_clusters")
            c = _as_tensor(cid).to(torch.int64).reshape(-1)
            # pad with −1 (excluded), not 0: a zero id would count the
            # phantom cells into cluster 0
            cp, _ = pad_and_shard(c, mesh, 0, fill=-1)
            ops = [_onehot_of(b, int(n_clusters)) for b in cp]
        else:
            require_dense(onehot)
            ops, _ = pad_and_shard(_as_f32(onehot), mesh, 0)
        attach_cost(sp, _aggregates_on, mesh, dp, ops, out_dev)
        return _aggregates_on(mesh, dp, ops, out_dev)


def _ranksum_on(mesh: Mesh, chunk: torch.Tensor, cid: torch.Tensor,
                n_of, pair_i, pair_j, n_clusters: int, window: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gene axis of ``chunk`` sharded, each shard through the serial
    scan body; (log_p, u, tie_sum) gathered on the chunk's device."""
    gc = chunk.shape[0]
    blocks, _ = pad_and_shard(chunk, mesh, 0)
    if cid.dim() == 2:
        # a compacted window's per-gene (Gc, W) ids ride the gene sharding;
        # padding rows carry −1 (excluded) and zero values, doubly inert
        cids, _ = pad_and_shard(cid, mesh, 0, fill=-1)
    else:
        cids = put_sharded(cid, mesh)
    reps = [put_sharded(t, mesh) for t in (n_of, pair_i, pair_j)]
    outs = [ranksum_body(b, c, n, pi, pj, n_clusters, window=window)
            for b, c, n, pi, pj in zip(blocks, cids, *reps)]
    return tuple(gather([o[f] for o in outs], 0, chunk.device,
                        mesh=mesh)[:gc] for f in range(3))


def sharded_allpairs_ranksum(
    chunk,
    cid,
    n_of,
    pair_i,
    pair_j,
    n_clusters: int,
    mesh: Optional[Mesh] = None,
    axis_name: str = CELL_AXIS,
    window: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gene-sharded all-pairs rank sum: ``ranksum_body`` over the gene
    chunk's rows, sharded (cid and the pair tensors replicated).

    chunk: (Gc, N); returns (log_p, u, tie_sum), each (Gc, P), equal to the
    serial ``ranksum_body`` of the whole chunk. The gene axis pads to the
    shard count; the all-zero padding rows give NaN and are sliced off.
    ``window``: the zero-block width (see ``ranksum_body``); a 2-D (Gc, W)
    pre-compacted ``cid`` (CSR windows) rides the gene sharding."""
    mesh = require_mesh(mesh or make_mesh(axis_name=axis_name))
    chunk = _as_f32(chunk)
    with obs_trace.span("sharded_ranksum", n_shards=mesh.size,
                        n_genes=int(chunk.shape[0]), window=int(window)):
        # fires per bucket: a device_loss plan can kill the mesh between
        # finished (checkpointed) buckets
        fault_point("sharded:ranksum")
        args = (mesh, chunk, _as_tensor(cid).to(torch.int64),
                *(_as_tensor(t) for t in (n_of, pair_i, pair_j)))
        kw = dict(n_clusters=int(n_clusters), window=int(window))
        attach_cost(None, _ranksum_on, *args, **kw)
        return _ranksum_on(*args, **kw)


def _wilcox_on(mesh: Mesh, data: torch.Tensor, idx, m1, m2, n1, n2
               ) -> torch.Tensor:
    """Genes of ``data`` sharded, each shard one pairs tile; (B, G) log p
    gathered on the data's device."""
    g = data.shape[0]
    blocks, _ = pad_and_shard(data, mesh, 0)
    reps = [put_sharded(_as_tensor(t), mesh) for t in (idx, m1, m2, n1, n2)]
    outs = [wilcoxon_pairs_tile(b, *r)[0] for b, *r in zip(blocks, *reps)]
    return gather(outs, 1, data.device, mesh=mesh)[:, :g]


def sharded_wilcox_logp(
    data,
    idx,
    m1,
    m2,
    n1,
    n2,
    mesh: Optional[Mesh] = None,
    axis_name: str = CELL_AXIS,
) -> torch.Tensor:
    """Rank-sum log p for one pair bucket, genes sharded across the mesh.

    data: (G, N); idx/m1/m2: (B, W) each pair's gathered cells; n1/n2:
    (B,). Returns (B, G) log p on the device ``data`` lay on (shard 0's
    for host input). Reference-parity API through the sort-midrank tile
    (``ops.wilcoxon.wilcoxon_pairs_tile``), off ``refine()``'s path,
    which shards the scan body (:func:`sharded_allpairs_ranksum`)."""
    require_dense(data)
    mesh = require_mesh(mesh or make_mesh(axis_name=axis_name))
    x = _as_f32(data)
    if not isinstance(data, torch.Tensor):
        x = x.to(mesh.home)
    with obs_trace.span("sharded_wilcox_logp", n_shards=mesh.size,
                        n_genes=int(x.shape[0])) as sp:
        attach_cost(sp, _wilcox_on, mesh, x, idx, m1, m2, n1, n2)
        return _wilcox_on(mesh, x, idx, m1, m2, n1, n2)
