"""Batched midranks with tie statistics.

The torch form of ``scconsensus_tpu/ops/ranks.py``: ``masked_midranks``
(:27-58) and ``rank_sum_groups`` (:61-81). Ties resolve to midranks
exactly as
R's ``rank()``: every member of a tie run gets the average of the ranks
the run spans, and the run sizes give the variance correction Σ(t³−t) of
the normal-approximation Wilcoxon test. Invalid (padded) entries sort to
the end as +inf and count in no tie statistic, so ragged pairs batch in
one static shape. Ranks are halves and tie sums integers, exact in
float32 below 2^24 elements.

Reference-parity API off ``refine()``'s path: only the sort-midrank
Wilcoxon tile (``ops.wilcoxon.wilcoxon_pairs_tile``) uses
``masked_midranks``, for the fused step and
``parallel.sharded_de.sharded_wilcox_logp``, and ``rank_sum_groups`` is
the statistical tests' oracle; the DE ladder ranks with the scan body
(``ops.ranksum_allpairs``).
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["masked_midranks", "rank_sum_groups"]


def masked_midranks(values: torch.Tensor, mask: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Midranks of the valid entries of each row of ``values`` (B, n).

    Returns (ranks (B, n), tie_sum (B,)): ranks[b, i] is the 1-based
    midrank of values[b, i] among the row's valid entries (0 where
    invalid); tie_sum = Σ over tie runs of (t³ − t)."""
    v = torch.where(mask, values.to(torch.float32),
                    torch.full_like(values, float("inf"), dtype=torch.float32))
    sv, order = torch.sort(v, dim=-1, stable=True)
    # first and last occurrence of each sorted value: the run's extent
    first = torch.searchsorted(sv, sv, right=False)
    last = torch.searchsorted(sv, sv, right=True) - 1
    mid = 0.5 * (first + last).to(torch.float32) + 1.0
    valid_sorted = torch.gather(mask, -1, order)
    # Σ(t³−t) = Σ over elements of (t² − 1), t its run's size
    t = (last - first + 1).to(torch.float32)
    tie_sum = torch.sum(torch.where(valid_sorted, t * t - 1.0,
                                    torch.zeros_like(t)), dim=-1)
    ranks = torch.zeros_like(v).scatter_(
        -1, order, torch.where(valid_sorted, mid, torch.zeros_like(mid)))
    return ranks, tie_sum



def rank_sum_groups(values: torch.Tensor, group1_mask: torch.Tensor,
                    group2_mask: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank sum of group 1 within the union of both groups, batched over
    rows.

    values: (B, n) rows (e.g. genes × pair cells); group1_mask and
    group2_mask: (B, n) or (n,) boolean membership, disjoint. Returns
    (rank_sum_1, tie_sum), (B,) each: rank_sum_1 is the sum of the
    midranks of group 1's entries among the pooled entries, R's
    ``sum(r[seq_along(x)])``."""
    group1_mask = torch.as_tensor(group1_mask, device=values.device)
    group2_mask = torch.as_tensor(group2_mask, device=values.device)
    if group1_mask.ndim == 1:
        group1_mask = group1_mask.expand(values.shape)
    if group2_mask.ndim == 1:
        group2_mask = group2_mask.expand(values.shape)
    ranks, tie_sum = masked_midranks(values, group1_mask | group2_mask)
    rs1 = torch.sum(torch.where(group1_mask, ranks, torch.zeros_like(ranks)),
                    dim=-1)
    return rs1, tie_sum
