"""Benjamini–Hochberg adjustment, batched and mask-aware, in log space.

Matches R ``p.adjust(method="BH")``; the fast path adjusts over the
surviving features only (R/reclusterDEConsensusFast.R:347-350), which is
``bh_adjust_masked``. The torch form of
``scconsensus_tpu/ops/multipletests.py:22-85``.
"""

from __future__ import annotations

import torch

__all__ = ["bh_adjust_masked"]


def _bh_batch(logp: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """BH over the last axis of a (B, m) batch: sort, scale by n / rank,
    cumulative minimum from the right, cap at 1, scatter back. Entries
    outside ``mask`` sort last as +inf, stay inert, and come back NaN."""
    m = logp.shape[-1]
    lp = torch.where(mask, logp, torch.full_like(logp, float("inf")))
    lp_sorted, idx_sorted = torch.sort(lp, dim=-1, stable=True)
    n = mask.sum(dim=-1)
    rank = torch.arange(1, m + 1, dtype=torch.float32, device=logp.device)
    adj = lp_sorted + torch.log(n.to(torch.float32))[..., None] \
        - torch.log(rank)
    adj = torch.flip(torch.cummin(torch.flip(adj, [-1]), dim=-1).values,
                     [-1])
    adj = torch.clamp(adj, max=0.0)
    out = torch.empty_like(adj).scatter_(-1, idx_sorted, adj)
    return torch.where(mask, out, torch.full_like(out, float("nan")))


def bh_adjust_masked(logp: torch.Tensor, mask: torch.Tensor
                     ) -> torch.Tensor:
    """BH-adjust log p-values along the last axis over only the
    ``mask``-selected finite entries (n = their count per row);
    masked-out entries return NaN. Returns log q."""
    mask = mask & torch.isfinite(logp)
    flat_lp = logp.reshape(-1, logp.shape[-1])
    flat_mask = mask.reshape(-1, logp.shape[-1])
    return _bh_batch(flat_lp, flat_mask).reshape(logp.shape)
