"""DE feature gates for all cluster pairs from per-cluster aggregates.

The (genes × cells) matrix is reduced against the cell→cluster map once,
and every pair's Seurat gates (pct, mean expression, |logFC|) come from the
(genes × clusters) aggregates: masks, never ragged selections. The torch
form of ``scconsensus_tpu/ops/gates.py`` ``ClusterAggregates`` (:35-60),
``compute_aggregates`` (:63-77) and ``compute_aggregates_cid`` (:80-118),
``pair_gates_fast`` (:128-166) and ``pair_gates_slow`` (:169-196).

The aggregates come in the reference's two forms. ``"segment"``: segment
sums over cells at each cell's cluster id, O(G·N), the form the reference
takes on CPU. ``"matmul"``: products against a (N, K) one-hot built on the
device, O(G·N·K) in full fp32, the form it takes on an accelerator. The
default picks the matmul form on ``cuda`` and the segment form on the CPU.

Graph passports (``obs.graphs``, ``SCC_GRAPHS``) under the reference's
names (:199-205): ``gates.compute_aggregates_cid``,
``gates.pair_gates_fast`` and ``gates.pair_gates_slow``. The reference's
one-hot-input ``gates.compute_aggregates`` runs
``compute_aggregates_cid`` here, so its passport is that one's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from scconsensus_tpu_torch.obs.graphs import instrument as _passport

__all__ = ["ClusterAggregates", "compute_aggregates", "compute_aggregates_cid",
           "pair_gates_fast", "pair_gates_slow"]


@dataclasses.dataclass
class ClusterAggregates:
    """Per-cluster sufficient statistics, all (G, K) except counts (K,)."""

    sum_log: torch.Tensor      # Σ x (x = log-normalized input)
    sum_expm1: torch.Tensor    # Σ expm1(x)
    sum_sq: torch.Tensor       # Σ x²
    nnz: torch.Tensor          # Σ [x > 0]
    counts: torch.Tensor       # cells per cluster (K,)

    @property
    def mean_log(self) -> torch.Tensor:
        return self.sum_log / torch.clamp(self.counts, min=1.0)[None, :]

    @property
    def mean_expm1(self) -> torch.Tensor:
        return self.sum_expm1 / torch.clamp(self.counts, min=1.0)[None, :]

    @property
    def pct(self) -> torch.Tensor:
        """Percent of cells expressing, Seurat's pct.1/pct.2 scale (0-100)."""
        return 100.0 * self.nnz / torch.clamp(self.counts, min=1.0)[None, :]


def compute_aggregates(data: torch.Tensor,
                       onehot: torch.Tensor) -> ClusterAggregates:
    """The reference's one-hot signature: ``data`` (G, N), ``onehot``
    (N, K) 0/1 cluster membership with at most one 1 a row (an all-zero
    row excludes its cell). Runs ``compute_aggregates_cid`` on the ids the
    one-hot encodes, in the form ``data``'s device picks; a weighted or multi-membership ``onehot``, which the
    reference's matmul would take, raises ``ValueError``."""
    onehot = torch.as_tensor(onehot)
    member = onehot != 0
    if bool((member & (onehot != 1)).any()) or \
            bool((member.sum(dim=1) > 1).any()):
        raise ValueError("onehot must be 0/1 with at most one 1 a row: a "
                         "weighted or multi-membership one-hot has no "
                         "cluster-id form")
    cid = torch.where(member.any(dim=1),
                      member.to(torch.float32).argmax(dim=1),
                      torch.full((onehot.shape[0],), -1,
                                 device=onehot.device))
    return compute_aggregates_cid(data, cid, int(onehot.shape[1]))


def compute_aggregates_cid(data: torch.Tensor, cid: torch.Tensor,
                           n_clusters: int,
                           form: Optional[str] = None,
                           nonzero: bool = False) -> ClusterAggregates:
    """Aggregates of ``data`` (G, N) over the (N,) cluster ids ``cid``
    (−1 = excluded). ``form``: "segment", "matmul" or None (matmul on
    cuda, segment on the CPU). ``nonzero``: count x ≠ 0 as detected, the
    rule of sparse input (``io.sparsemat.aggregates_from_sparse``), instead
    of x > 0."""
    K = n_clusters

    def detected() -> torch.Tensor:
        return ((data != 0) if nonzero else (data > 0)).to(torch.float32)

    if form is None:
        form = "matmul" if data.device.type == "cuda" else "segment"
    cid = cid.to(device=data.device, dtype=torch.int64)
    if form == "segment":
        safe = torch.where(cid >= 0, cid, torch.full_like(cid, K))
        counts = torch.zeros(K + 1, dtype=torch.float32, device=data.device)
        counts.index_add_(0, safe, torch.ones_like(safe, dtype=torch.float32))

        def seg(x: torch.Tensor) -> torch.Tensor:       # (G, N) -> (G, K)
            z = torch.zeros((x.shape[0], K + 1), dtype=torch.float32,
                            device=x.device)
            return z.index_add_(1, safe, x)[:, :K]

        return ClusterAggregates(
            seg(data), seg(torch.expm1(data)), seg(data * data),
            seg(detected()), counts[:K],
        )
    if form != "matmul":
        raise ValueError(f"form must be 'segment' or 'matmul', got {form!r}")
    onehot = (cid[:, None] == torch.arange(K, device=data.device)[None, :]
              ).to(torch.float32)                       # (N, K)
    return ClusterAggregates(
        data @ onehot,
        torch.expm1(data) @ onehot,
        (data * data) @ onehot,
        detected() @ onehot,
        onehot.sum(dim=0),
    )


def pair_gates_fast(
    agg: ClusterAggregates,
    pair_i: torch.Tensor,
    pair_j: torch.Tensor,
    min_pct: float,
    min_diff_pct: float,
    log_fc_thrs: float,
    mean_exprs_thrs: float,
    pseudocount: float = 1.0,
    only_pos: bool = False,
):
    """Seurat-convention gates for a batch of pairs (P,).

    Returns (gate (P, G) bool, log_fc (P, G), pct1, pct2) with
    log_fc = log(mean(expm1 x)+pc) − log(mean(expm1 y)+pc)
    (ComputePairWiseDE mean.fxn, R/reclusterDEConsensusFast.R:259-272)."""
    pct = agg.pct                                       # (G, K)
    pct1 = pct[:, pair_i].T                             # (P, G)
    pct2 = pct[:, pair_j].T
    alpha_min = torch.maximum(pct1, pct2)
    alpha_diff = alpha_min - torch.minimum(pct1, pct2)

    me = agg.mean_expm1
    obj1 = torch.log(me[:, pair_i].T + pseudocount)
    obj2 = torch.log(me[:, pair_j].T + pseudocount)
    log_fc = obj1 - obj2

    gate = alpha_min > min_pct
    if min_diff_pct > -float("inf"):
        gate &= alpha_diff > min_diff_pct
    # mean gate: expm1(obj) > thrs (R/reclusterDEConsensusFast.R:274-275)
    gate &= (torch.expm1(obj1) > mean_exprs_thrs) | (
        torch.expm1(obj2) > mean_exprs_thrs)
    if only_pos:
        gate &= log_fc > log_fc_thrs
    else:
        gate &= torch.abs(log_fc) > log_fc_thrs
    return gate, log_fc, pct1, pct2


def pair_gates_slow(
    agg: ClusterAggregates,
    pair_i: torch.Tensor,
    pair_j: torch.Tensor,
    mean_exprs_thrs: float,
    mixed_spaces: bool = True,
):
    """Slow-path mean-expression gate and logFC (difference of log-means).

    ``mixed_spaces=True`` is the reference's literal arithmetic: cluster
    means of log values against log of the count-space threshold
    (R/reclusterDEConsensus.R:109-113, quirk §2d-3); ``False`` compares the
    count-space cluster mean with the count-space threshold.

    Returns (mean_gate (P, G) bool, log_fc (P, G))."""
    ml = agg.mean_log
    m1 = ml[:, pair_i].T
    m2 = ml[:, pair_j].T
    thr = torch.tensor(mean_exprs_thrs, dtype=torch.float32,
                       device=ml.device)
    if mixed_spaces:
        thr = torch.log(thr)
        gate = (m1 > thr) | (m2 > thr)
    else:
        me = agg.mean_expm1
        gate = (me[:, pair_i].T > thr) | (me[:, pair_j].T > thr)
    return gate, m1 - m2


compute_aggregates_cid = _passport("gates.compute_aggregates_cid",
                                   compute_aggregates_cid)
pair_gates_fast = _passport("gates.pair_gates_fast", pair_gates_fast)
pair_gates_slow = _passport("gates.pair_gates_slow", pair_gates_slow)
