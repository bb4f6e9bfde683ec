"""Seurat-style DE tests of the fast path: bimod LRT, Welch t, AUC.

The torch form of ``scconsensus_tpu/ops/seurat_tests.py`` (``:32-197``):
the zero-inflated-normal likelihood from sufficient statistics, the bimod
likelihood-ratio test and the two-sided Welch t for all pairs straight
from the per-cluster aggregates, and the AUC and Seurat's marker power
from the Mann-Whitney U. The reference's (B, G, W) tile forms,
``bimod_lrt_tile`` and ``welch_t_tile``, take masked cells instead of
aggregates; the fast path does not call them, and they share the pair
forms' bodies here.

Library names map one to one: ``gammaincc`` → ``torch.special.gammaincc``,
``gammaln`` → ``torch.lgamma``, ``betainc`` → ``ops.special.betainc``
(torch has none). The log p of both tests goes through
``ops.special.flush_log``: the reference's 1e-38 floor is a float32
subnormal that XLA flushes, so p < FLT_MIN gives −inf there, and here.

NaN rules as in the reference: bimod is NaN for a group below 1 cell;
Welch t for a group below 2 cells or a standard error ≤ 0. Every
function runs where its tensors lie, float32 throughout.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from scconsensus_tpu_torch.ops.gates import ClusterAggregates
from scconsensus_tpu_torch.ops.special import betainc, flush_log

__all__ = ["bimod_lrt_tile", "welch_t_tile", "bimod_lrt_pairs",
           "welch_t_pairs", "auc_from_u"]

_PI_CLIP_LO = 1e-5  # Seurat's MinMax(…, 1e-5, 1-1e-5) on the positive fraction
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def _zinorm_loglik_stats(n, n_pos, s, ss):
    """Seurat bimodLikData from sufficient statistics: n masked cells, n_pos
    positives, s = Σ positives, ss = Σ positives². sd uses the n−1
    denominator (R ``sd``) and falls back to 1 below 2 positive cells."""
    n_zero = n - n_pos
    frac = torch.clamp(n_pos / torch.clamp(n, min=1.0), _PI_CLIP_LO,
                       1.0 - _PI_CLIP_LO)
    mean = s / torch.clamp(n_pos, min=1.0)
    var = (ss - n_pos * mean * mean) / torch.clamp(n_pos - 1.0, min=1.0)
    sd = torch.where(n_pos < 2.0, 1.0,
                     torch.sqrt(torch.clamp(var, min=1e-30)))
    # Σ log N(x; mean, sd) over positives, from the same moments:
    # −n_pos·log(sd·√2π) − (ss − 2·mean·s + n_pos·mean²)/(2 sd²)
    quad = ss - 2.0 * mean * s + n_pos * mean * mean
    lik_pos = (n_pos * torch.log(frac)
               - n_pos * (torch.log(sd) + _HALF_LOG_2PI)
               - quad / (2.0 * sd * sd))
    lik_zero = n_zero * torch.log1p(-frac)
    return lik_zero + lik_pos


def _zero_inflated_loglik(vals, mask, xmin: float):
    """Per-cell-tile form of ``_zinorm_loglik_stats`` (vals/mask (..., W);
    positives are entries > xmin among masked cells)."""
    pos = mask & (vals > xmin)
    n = mask.sum(dim=-1).to(torch.float32)
    n_pos = pos.sum(dim=-1).to(torch.float32)
    vp = torch.where(pos, vals, 0.0)
    return _zinorm_loglik_stats(n, n_pos, vp.sum(dim=-1),
                                (vp * vp).sum(dim=-1))


def _chi2_3_log_sf(lrt):
    """Flushed log P(χ²₃ > lrt) = log Γ_upper-reg(3/2, lrt/2)."""
    half = lrt / 2.0
    return flush_log(torch.special.gammaincc(torch.full_like(half, 1.5),
                                             half))


def _welch_log_p(n1, mu1, v1, n2, mu2, v2):
    """Two-sided Welch log p from each group's size, mean and variance:
    p = I_{df/(df+t²)}(df/2, 1/2) with the Welch–Satterthwaite df."""
    se1 = v1 / torch.clamp(n1, min=1.0)
    se2 = v2 / torch.clamp(n2, min=1.0)
    se = se1 + se2
    t = (mu1 - mu2) / torch.sqrt(torch.clamp(se, min=1e-30))
    df = se * se / torch.clamp(
        se1 * se1 / torch.clamp(n1 - 1.0, min=1.0)
        + se2 * se2 / torch.clamp(n2 - 1.0, min=1.0),
        min=1e-30,
    )
    x = df / (df + t * t)
    log_p = flush_log(betainc(df / 2.0, torch.full_like(df, 0.5), x))
    bad = (n1 < 2) | (n2 < 2) | (se <= 0.0)
    return torch.where(bad, float("nan"), log_p)


def _pair_stats(agg: ClusterAggregates, k: torch.Tensor):
    """(n (P, 1), nnz, Σx, Σx² (P, G)) of the clusters ``k`` (P,)."""
    return (agg.counts[k][:, None], agg.nnz[:, k].T, agg.sum_log[:, k].T,
            agg.sum_sq[:, k].T)


def bimod_lrt_tile(vals: torch.Tensor, m1: torch.Tensor, m2: torch.Tensor,
                   xmin: float = 0.0) -> torch.Tensor:
    """Likelihood-ratio test of separate vs pooled zero-inflated normal
    fits, χ² with 3 df (DifferentialLRT, R/reclusterDEConsensusFast.R:
    110-133). vals: (B, G, W); m1/m2: (B, W) boolean masks (broadcast
    over genes). Returns (B, G) log p-values."""
    m1e, m2e = m1[:, None, :], m2[:, None, :]
    lrt = 2.0 * (_zero_inflated_loglik(vals, m1e, xmin)
                 + _zero_inflated_loglik(vals, m2e, xmin)
                 - _zero_inflated_loglik(vals, m1e | m2e, xmin))
    log_p = _chi2_3_log_sf(torch.clamp(lrt, min=0.0))
    n1 = m1.sum(dim=-1)[:, None]
    n2 = m2.sum(dim=-1)[:, None]
    return torch.where((n1 < 1) | (n2 < 1), float("nan"), log_p)


def welch_t_tile(vals: torch.Tensor, m1: torch.Tensor, m2: torch.Tensor
                 ) -> torch.Tensor:
    """Two-sided Welch t-test (R ``t.test`` default, var.equal=FALSE;
    reference per-gene loop R/reclusterDEConsensusFast.R:185-196). vals:
    (B, G, W); m1/m2: (B, W) boolean masks. Returns (B, G) log p-values."""

    def moments(mask):
        n = mask.sum(dim=-1).to(torch.float32)
        v = torch.where(mask, vals, 0.0)
        mean = v.sum(dim=-1) / torch.clamp(n, min=1.0)
        var = ((v * v).sum(dim=-1) - n * mean * mean) / torch.clamp(
            n - 1.0, min=1.0)
        return n, mean, torch.clamp(var, min=0.0)

    return _welch_log_p(*moments(m1[:, None, :]), *moments(m2[:, None, :]))


def bimod_lrt_pairs(agg: ClusterAggregates, pair_i: torch.Tensor,
                    pair_j: torch.Tensor) -> torch.Tensor:
    """All-pairs bimod LRT straight from per-cluster aggregates.

    The zero-inflated-normal fit needs only {n, n_pos, Σx, Σx²} per group,
    and the pooled group's statistics are the sums of the two clusters', so
    every pair's test is a gather over the (G, K) aggregates (xmin = 0:
    positives are the aggregates' detected entries). Returns (P, G) log
    p-values."""
    n1, p1, s1, ss1 = _pair_stats(agg, pair_i)
    n2, p2, s2, ss2 = _pair_stats(agg, pair_j)
    ll1 = _zinorm_loglik_stats(n1, p1, s1, ss1)
    ll2 = _zinorm_loglik_stats(n2, p2, s2, ss2)
    ll_pooled = _zinorm_loglik_stats(n1 + n2, p1 + p2, s1 + s2, ss1 + ss2)
    lrt = torch.clamp(2.0 * (ll1 + ll2 - ll_pooled), min=0.0)
    log_p = _chi2_3_log_sf(lrt)
    return torch.where((n1 < 1) | (n2 < 1), float("nan"), log_p)


def welch_t_pairs(agg: ClusterAggregates, pair_i: torch.Tensor,
                  pair_j: torch.Tensor) -> torch.Tensor:
    """All-pairs two-sided Welch t from per-cluster aggregates (mean and
    variance per group from {n, Σx, Σx²}). Returns (P, G) log p-values."""

    def moments(k):
        n, _, s, ss = _pair_stats(agg, k)
        mean = s / torch.clamp(n, min=1.0)
        var = (ss - n * mean * mean) / torch.clamp(n - 1.0, min=1.0)
        return n, mean, torch.clamp(var, min=0.0)

    return _welch_log_p(*moments(pair_i), *moments(pair_j))


def auc_from_u(u, n1, n2) -> Tuple[torch.Tensor, torch.Tensor]:
    """AUC and Seurat's marker 'power' from the Mann-Whitney U statistic
    (the ROCR AUC of the reference's roc branch equals U/(n1·n2);
    power = 2|AUC − 0.5|, R/reclusterDEConsensusFast.R:144-150)."""
    auc = u / torch.clamp(n1 * n2, min=1.0)
    return auc, 2.0 * torch.abs(auc - 0.5)
