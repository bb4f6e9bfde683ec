"""Batched midranks with tie statistics.

The torch form of ``scconsensus_tpu/ops/ranks.py`` ``masked_midranks``
(:27-58). Ties resolve to midranks exactly as
R's ``rank()``: every member of a tie run gets the average of the ranks
the run spans, and the run sizes give the variance correction Σ(t³−t) of
the normal-approximation Wilcoxon test. Invalid (padded) entries sort to
the end as +inf and count in no tie statistic, so ragged pairs batch in
one static shape. Ranks are halves and tie sums integers, exact in
float32 below 2^24 elements.

Reference-parity API off ``refine()``'s path: only the sort-midrank
Wilcoxon tile (``ops.wilcoxon.wilcoxon_pairs_tile``) uses it, for the
fused step and ``parallel.sharded_de.sharded_wilcox_logp``; the DE
ladder ranks with the scan body (``ops.ranksum_allpairs``). Its removal
from both packages is queued.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["masked_midranks"]


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

