"""One refinement step, on one device or over a mesh.

The torch form of ``scconsensus_tpu/parallel/step.py``: every device
stage of ``refine()`` in one step body: the per-cluster aggregates (cells
summed across shards), the pair gates, the gene-sharded Wilcoxon, BH and
the DE call, the PCA scores of a fixed panel of the strongest DE genes,
and the ring silhouette sums over the embedding. One body serves both
forms: :func:`distributed_refine_step` hands it the sharded engines,
:func:`fused_refine_step` the plain tensor ones, so the two cannot
diverge. The reference jits the body; here it runs eagerly, one kernel
after another. The fault site ``refine_step`` fires at each call.

This is the reference's step API, held against it in the tests; no
entry point of the port calls it (``refine()`` runs its stages through
``parallel.sharded_de.sharded_allpairs_ranksum`` and the kernel), and
its removal from both packages is queued.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from scconsensus_tpu_torch.obs import trace as obs_trace
from scconsensus_tpu_torch.ops.distance import distance_tile
from scconsensus_tpu_torch.ops.gates import ClusterAggregates, pair_gates_fast
from scconsensus_tpu_torch.ops.multipletests import bh_adjust_masked
from scconsensus_tpu_torch.ops.pca import pca_scores
from scconsensus_tpu_torch.ops.wilcoxon import wilcoxon_pairs_tile
from scconsensus_tpu_torch.parallel.mesh import (
    CELL_AXIS,
    Mesh,
    gather,
    pad_and_shard,
    require_mesh,
)
from scconsensus_tpu_torch.parallel.ring import _ring_sums
from scconsensus_tpu_torch.parallel.sharded_de import (
    _agg_local,
    _aggregates_on,
    _wilcox_on,
)

__all__ = ["distributed_refine_step", "fused_refine_step",
           "build_step_inputs"]


def _build_step(agg_fn, wilcox_fn, sil_fn, *, min_pct, log_fc_thrs,
                q_val_thrs, n_pcs):
    """The one step body. Kernel slots: agg_fn(data, onehot) ->
    ClusterAggregates; wilcox_fn(data, idx, m1, m2, n1, n2) -> log_p (B,
    G); sil_fn(scores, onehot) -> (N, K) per-cluster distance sums."""
    log_thr = float(np.log(np.float32(q_val_thrs)))

    def step(data, onehot, pair_i, pair_j, idx, m1, m2, n1, n2):
        pair_i, pair_j = pair_i.long(), pair_j.long()
        # 1. per-cluster aggregates
        agg = agg_fn(data, onehot)
        # 2. gates for every pair
        gate, log_fc, _pct1, _pct2 = pair_gates_fast(
            agg, pair_i, pair_j, min_pct=min_pct, min_diff_pct=-math.inf,
            log_fc_thrs=log_fc_thrs, mean_exprs_thrs=0.0)
        # 3. the rank-sum test (genes independent)
        log_p = wilcox_fn(data, idx, m1, m2, n1, n2)
        # 4. BH over the gated genes and the DE call
        log_q = bh_adjust_masked(log_p, gate)
        de = gate & (log_q < log_thr)
        # 5. embed a fixed panel of the strongest DE genes (per-gene best
        #    |logFC| among DE calls, de_gene_union's order); genes with no
        #    DE call rank after every DE gene, among themselves by
        #    expression (the +10 offset dominates the [0, 1) tiebreak)
        de_score = torch.max(torch.where(
            de, torch.abs(log_fc), torch.full_like(log_fc, -math.inf)),
            dim=0).values
        var = agg.sum_expm1.sum(dim=1)
        var_rank = var / (torch.max(var) + 1e-30)
        score = torch.where(torch.isfinite(de_score), de_score + 10.0,
                            var_rank)
        top_idx = torch.topk(score, min(64, data.shape[0])).indices
        scores = pca_scores(data[top_idx].T.contiguous(), n_pcs)
        # 6. silhouette sufficient statistics over the embedding
        sil_sums = sil_fn(scores, onehot)
        return {
            "de_mask": de,
            "log_q": log_q,
            "log_fc": log_fc,
            "de_counts": de.sum(dim=1),
            "scores": scores,
            "sil_sums": sil_sums,
            "counts": agg.counts,
        }

    def traced_step(*args):
        with obs_trace.span("refine_step") as sp:
            # elastic and chaos plans can kill the step here
            from scconsensus_tpu_torch.robust.faults import fault_point

            fault_point("refine_step")
            data = torch.as_tensor(args[0])
            out = step(data, *(torch.as_tensor(a).to(data.device)
                               for a in args[1:]))
            sp.attrs["n_outputs"] = len(out)
            return out

    return traced_step


def fused_refine_step(*, min_pct: float = 20.0, log_fc_thrs: float = 0.5,
                      q_val_thrs: float = 0.1, n_pcs: int = 8):
    """One-device form: the plain tensor engines in the step body."""
    return _build_step(
        lambda data, onehot: ClusterAggregates(*_agg_local(data, onehot)),
        lambda data, idx, m1, m2, n1, n2: wilcoxon_pairs_tile(
            data, idx, m1, m2, n1, n2)[0],
        lambda scores, onehot: distance_tile(scores, scores) @ onehot,
        min_pct=min_pct, log_fc_thrs=log_fc_thrs,
        q_val_thrs=q_val_thrs, n_pcs=n_pcs,
    )


def distributed_refine_step(mesh: Mesh, axis_name: str = CELL_AXIS, *,
                            min_pct: float = 20.0, log_fc_thrs: float = 0.5,
                            q_val_thrs: float = 0.1, n_pcs: int = 8):
    """Mesh form. Returns step(data, onehot, pair_i, pair_j, idx, m1, m2,
    n1, n2) -> dict of outputs on the data's device. Shardings (one mesh
    axis): data (G, N) by cells for the aggregates and by genes for the
    test; onehot (N, K) by cells; the pair and bucket tensors replicated;
    the embedding by cells, rotating around the ring."""
    mesh = require_mesh(mesh)

    def agg_fn(data, onehot):
        dp, _ = pad_and_shard(data, mesh, 1)
        op, _ = pad_and_shard(onehot, mesh, 0)
        return _aggregates_on(mesh, dp, op, data.device)

    def sil_fn(scores, onehot):
        n = scores.shape[0]
        xs, _ = pad_and_shard(scores, mesh, 0)
        ohs, _ = pad_and_shard(onehot, mesh, 0)
        return gather(_ring_sums(mesh, xs, ohs), 0, scores.device,
                      mesh=mesh)[:n]

    return _build_step(
        agg_fn,
        lambda data, idx, m1, m2, n1, n2: _wilcox_on(mesh, data, idx, m1,
                                                     m2, n1, n2),
        sil_fn,
        min_pct=min_pct, log_fc_thrs=log_fc_thrs,
        q_val_thrs=q_val_thrs, n_pcs=n_pcs,
    )


def build_step_inputs(n_cells: int, n_genes: int, n_clusters: int,
                      n_shards: int, pair_width: int = 32, seed: int = 0
                      ) -> Dict[str, np.ndarray]:
    """Small seeded shard-divisible inputs for the step (the reference's
    numpy draws, so both packages get the same arrays)."""
    rng = np.random.default_rng(seed)
    n = n_cells + ((-n_cells) % n_shards)
    g = n_genes + ((-n_genes) % n_shards)
    data = np.log1p(rng.poisson(1.0, size=(g, n)).astype(np.float32))
    labels = rng.integers(0, n_clusters, size=n)
    onehot = np.zeros((n, n_clusters), np.float32)
    onehot[np.arange(n), labels] = 1.0
    pi, pj = np.triu_indices(n_clusters, k=1)
    B = pi.size
    idx = np.zeros((B, pair_width), np.int32)
    m1 = np.zeros((B, pair_width), bool)
    m2 = np.zeros((B, pair_width), bool)
    n1 = np.zeros(B, np.int32)
    n2 = np.zeros(B, np.int32)
    for b in range(B):
        ci = np.nonzero(labels == pi[b])[0][: pair_width // 2]
        cj = np.nonzero(labels == pj[b])[0][: pair_width - pair_width // 2]
        idx[b, : ci.size] = ci
        idx[b, ci.size: ci.size + cj.size] = cj
        m1[b, : ci.size] = True
        m2[b, ci.size: ci.size + cj.size] = True
        n1[b], n2[b] = ci.size, cj.size
    return {
        "data": data,
        "onehot": onehot,
        "pair_i": pi.astype(np.int32),
        "pair_j": pj.astype(np.int32),
        "idx": idx,
        "m1": m1,
        "m2": m2,
        "n1": n1,
        "n2": n2,
    }
