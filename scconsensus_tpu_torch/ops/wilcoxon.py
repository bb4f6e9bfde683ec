"""Wilcoxon rank-sum test with R ``wilcox.test`` semantics.

Device path (``wilcoxon_from_ranks``): normal approximation with tie and
continuity correction, batched over genes × cluster pairs, p-values in log
space. Host path (``wilcoxon_exact_host``): R's exact branch (both n < 50,
no ties) via the Gaussian-binomial counting DP behind ``pwilcox``.

The torch form of ``scconsensus_tpu/ops/wilcoxon.py:37-98``
(``jstats.norm.logcdf`` becomes ``torch.special.log_ndtr``): the
statistic from rank sums and the per-tile test over gathered pair cells
(``wilcoxon_pairs_tile``); and a numpy copy of its exact branch
(:101-137).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

__all__ = ["wilcoxon_from_ranks", "wilcoxon_pairs_tile", "wilcoxon_exact_host",
           "EXACT_N_LIMIT"]

# R: exact branch iff n.x < 50 && n.y < 50 (and no ties).
EXACT_N_LIMIT = 50


def wilcoxon_from_ranks(
    rank_sum_1: torch.Tensor,
    tie_sum: torch.Tensor,
    n1: torch.Tensor,
    n2: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-sided normal-approximation p from group-1 rank sums, with the
    continuity correction.

    Arguments broadcast: rank_sum_1 = Σ midranks of group 1 in the pooled
    sample; tie_sum = Σ(t³−t); n1/n2 = group sizes. Returns (log_p, U) with
    U the Mann-Whitney statistic of group 1 (R's ``STATISTIC``). An empty
    group or zero variance gives log_p = NaN, as R's p-value does."""
    n1 = n1.to(torch.float32)
    n2 = n2.to(torch.float32)
    u = rank_sum_1 - n1 * (n1 + 1.0) / 2.0
    z = u - n1 * n2 / 2.0
    z = z - torch.sign(z) * 0.5
    n = n1 + n2
    tie_term = tie_sum / torch.clamp(n * (n - 1.0), min=1.0)
    sigma2 = (n1 * n2 / 12.0) * ((n + 1.0) - tie_term)
    sigma = torch.sqrt(torch.clamp(sigma2, min=0.0))
    zs = z / sigma  # sigma == 0 -> ±inf / NaN, masked below
    log_p = math.log(2.0) + torch.special.log_ndtr(-torch.abs(zs))
    log_p = torch.clamp(log_p, max=0.0)  # cap p at 1
    bad = (n1 < 1) | (n2 < 1) | (sigma <= 0.0)
    log_p = torch.where(bad, torch.full_like(log_p, float("nan")), log_p)
    return log_p, u


def wilcoxon_pairs_tile(
    data_chunk: torch.Tensor,  # (Gc, N) gene chunk of the matrix
    idx: torch.Tensor,         # (B, W) each pair's gathered cells
    m1: torch.Tensor,          # (B, W) group-1 membership of those cells
    m2: torch.Tensor,
    n1: torch.Tensor,          # (B,) group sizes
    n2: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rank-sum test for one (gene chunk × pair bucket) tile
    (``scconsensus_tpu/ops/wilcoxon.py:71-98``): the body of the
    gene-sharded ``parallel.sharded_de.sharded_wilcox_logp`` and of the
    fused refine step, both reference-parity API off ``refine()``'s path
    (the DE ladder takes ``ops.ranksum_allpairs``). Returns (log_p, u,
    tie_sum), each (B, Gc)."""
    from scconsensus_tpu_torch.ops.ranks import masked_midranks

    dev = data_chunk.device
    idx = torch.as_tensor(idx, device=dev).to(torch.int64)
    m1 = torch.as_tensor(m1, device=dev).to(torch.bool)
    m2 = torch.as_tensor(m2, device=dev).to(torch.bool)
    vals = data_chunk[:, idx].transpose(0, 1)         # (B, Gc, W)
    B, Gc, W = vals.shape
    flat = vals.reshape(B * Gc, W)
    flat_mask = (m1 | m2)[:, None, :].expand(B, Gc, W).reshape(B * Gc, W)
    ranks, tie_sum = masked_midranks(flat, flat_mask)
    ranks = ranks.reshape(B, Gc, W)
    tie_sum = tie_sum.reshape(B, Gc)
    rs1 = torch.sum(torch.where(m1[:, None, :], ranks,
                                torch.zeros_like(ranks)), dim=-1)
    n1 = torch.as_tensor(n1, device=dev)[:, None]
    n2 = torch.as_tensor(n2, device=dev)[:, None]
    log_p, u = wilcoxon_from_ranks(rs1, tie_sum, n1, n2)
    return log_p, u, tie_sum


@lru_cache(maxsize=512)
def _wilcox_pmf(m: int, n: int) -> np.ndarray:
    """PMF of the Mann-Whitney U distribution for group sizes (m, n):
    coefficients of the Gaussian binomial [m+n choose m]_q, normalized.
    Float64 counts — same rounding regime as R's ``cwilcox`` doubles."""
    size = m * n + 1
    c = np.zeros(size, dtype=np.float64)
    c[0] = 1.0
    for i in range(1, m + 1):
        # multiply by (1 - q^(n+i))
        d = c.copy()
        if n + i < size:
            d[n + i :] -= c[: size - (n + i)]
        # divide by (1 - q^i): running sum with stride i
        for u in range(i, size):
            d[u] += d[u - i]
        c = d
    total = c.sum()
    return c / total


def wilcoxon_exact_host(u_stat: np.ndarray, n1: int, n2: int) -> np.ndarray:
    """Two-sided exact p for U statistics (no ties), R's exact branch:
    p = min(2 * tail, 1) with the smaller tail doubled
    (stats::wilcox.test exact two.sided arithmetic)."""
    pmf = _wilcox_pmf(int(n1), int(n2))
    cdf = np.cumsum(pmf)
    u = np.asarray(u_stat)
    w = np.rint(u).astype(np.int64)
    mid = n1 * n2 / 2.0
    # upper tail: P(U >= w) = 1 - cdf[w-1]; lower tail: P(U <= w) = cdf[w]
    p_upper = 1.0 - np.where(w >= 1, cdf[np.clip(w - 1, 0, len(cdf) - 1)], 0.0)
    p_lower = cdf[np.clip(w, 0, len(cdf) - 1)]
    p = np.where(w > mid, p_upper, p_lower)
    return np.minimum(2.0 * p, 1.0)
