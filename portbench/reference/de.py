"""All-pairs differential expression on the fast path, Wilcoxon test.

What ``recluster_de_consensus_fast(method="wilcox")`` computes, by its
published semantics (R/reclusterDEConsensusFast.R: Seurat's
``FindMarkers`` gates and ``wilcox.test`` per cluster pair, BH per pair
over the genes tested):

1. clusters: the str-cast labels, sorted; a cluster survives with more
   than ``min_cluster_size`` cells and no "grey" in its name; pairs are
   (i, j), i < j, and a pair with a group under ``min_cells_group`` cells
   is not tested;
2. gates per (pair, gene): max(pct.1, pct.2) > ``min_pct`` (pct = percent
   of the cluster's cells with x > 0), a cluster mean of expm1(x) above
   ``mean_exprs_thrs`` on either side, and |log_fc| > ``log_fc_thrs`` with
   log_fc = log(mean expm1 + pseudocount) difference;
3. the two-sided rank-sum test with R's continuity and tie corrections
   (and R's exact branch when both groups have under 50 cells and no
   ties), from each gene's tied runs: with R[k, r] the cells of cluster k
   in run r (runs in increasing value), U[i, j] = Σ_r R[i, r]·(cells of j
   below r + R[j, r]/2) and the tie moments M[k, l] = Σ_r R[k, r]²·R[l, r]
   are two contractions a gene, and every pair's statistic follows;
4. BH per pair over its tested genes with finite p, and the call
   q < ``q_val_thrs``.

The cluster aggregates and the run contractions are matrix products in
``dtype``: float64 for the reference, float32 under TF32 for the control.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

__all__ = ["clusters", "pairwise_de", "bh_log", "wilcox_exact_p"]

GENE_BLOCK = 2048      # genes a block of the aggregates
RUN_BLOCK = 8          # genes a block of the run contractions
EXACT_N = 50           # R: exact p iff both groups < 50 and no ties


def clusters(labels, min_cluster_size: int, drop_grey: bool = True):
    """(kept names sorted, each cell's index into them or −1)."""
    lab = np.asarray(labels).astype(str)
    names, codes, counts = np.unique(lab, return_inverse=True,
                                     return_counts=True)
    keep = counts > min_cluster_size
    if drop_grey:
        keep &= np.char.find(names, "grey") < 0
    index = np.full(names.size, -1, np.int64)
    index[keep] = np.arange(int(keep.sum()))
    return [str(n) for n in names[keep]], index[codes.ravel()]


def bh_log(log_p: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """BH over the last axis among ``mask`` entries, in log space
    (q = min over ranks ≥ r of p·n/rank, capped at 1); NaN elsewhere."""
    lp = torch.where(mask, log_p, torch.full_like(log_p, math.inf))
    srt, order = torch.sort(lp, dim=-1, stable=True)
    n = mask.sum(dim=-1, keepdim=True).to(log_p.dtype)
    rank = torch.arange(1, lp.shape[-1] + 1, dtype=log_p.dtype,
                        device=log_p.device)
    adj = srt + torch.log(n) - torch.log(rank)
    adj = torch.flip(torch.cummin(torch.flip(adj, [-1]), dim=-1).values,
                     [-1]).clamp(max=0.0)
    out = torch.empty_like(adj).scatter_(-1, order, adj)
    return torch.where(mask, out, torch.full_like(out, math.nan))


def wilcox_exact_p(u: float, n1: int, n2: int) -> float:
    """R's exact two-sided p of the Mann-Whitney statistic (no ties)."""
    size = n1 * n2 + 1
    c = np.zeros(size)
    c[0] = 1.0
    for i in range(1, n1 + 1):          # Gaussian binomial [n1+n2, n1]_q
        d = c.copy()
        if n2 + i < size:
            d[n2 + i:] -= c[:size - (n2 + i)]
        for v in range(i, size):
            d[v] += d[v - i]
        c = d
    cdf = np.cumsum(c / c.sum())
    w = int(round(u))
    if w > n1 * n2 / 2.0:
        p = 1.0 - (cdf[w - 1] if w >= 1 else 0.0)
    else:
        p = cdf[w]
    return float(min(2.0 * p, 1.0))


def _aggregates(data: torch.Tensor, cid: torch.Tensor, k: int, dtype):
    """(sum of expm1(x), cells with x > 0) per gene and cluster, (G, K)."""
    onehot = (cid[:, None] == torch.arange(k, device=cid.device)[None, :]
              ).to(dtype)
    s_e, s_nz = [], []
    for g0 in range(0, data.shape[0], GENE_BLOCK):
        x = data[g0:g0 + GENE_BLOCK].to(dtype)
        s_e.append(torch.expm1(x) @ onehot)
        s_nz.append((x > 0).to(dtype) @ onehot)
        del x
    return torch.cat(s_e), torch.cat(s_nz), onehot.sum(dim=0)


def _run_moments(x: torch.Tensor, cid: torch.Tensor, k: int, dtype):
    """U (B, K, K) and tie moments M (B, K, K) of B gene rows x (B, N)."""
    b, n = x.shape
    srt, order = torch.sort(x, dim=1)
    start = torch.ones_like(srt, dtype=torch.bool)
    start[:, 1:] = srt[:, 1:] != srt[:, :-1]
    run = torch.cumsum(start.to(torch.int64), dim=1) - 1        # (B, N)
    cl = cid[order]                                             # (B, N)
    ok = cl >= 0
    rows = torch.arange(b, device=x.device)[:, None].expand(b, n)
    r = torch.zeros((b, k, n), dtype=dtype, device=x.device)
    r.index_put_((rows[ok], cl[ok], run[ok]),
                 torch.ones((), dtype=dtype, device=x.device),
                 accumulate=True)
    below = torch.cumsum(r, dim=2) - r
    u = torch.bmm(r, (below + 0.5 * r).transpose(1, 2))
    m = torch.bmm(r * r, r.transpose(1, 2))
    return u, m


def pairwise_de(data: torch.Tensor, labels, kw: Dict, dtype=torch.float64
                ) -> Dict[str, np.ndarray]:
    """The fast-path Wilcoxon DE of every pair. ``kw``: the job's options
    (``min_cluster_size``, ``min_per_cent``, ``log_fc_thrs``,
    ``q_val_thrs``, ...), absent keys at the entry point's defaults.
    Returns host arrays: cluster_names, log_p, log_q, log_fc, tested,
    de_mask (P, G), and for the band rules pct_max."""
    dev = data.device
    min_cluster_size = int(kw.get("min_cluster_size", 10))
    min_pct = float(kw.get("min_per_cent", 20.0))
    log_fc_thrs = float(kw.get("log_fc_thrs", 0.5))
    q_thr = float(kw.get("q_val_thrs", 0.1))
    mean_thr = float(kw.get("mean_exprs_thrs", 0.0))
    pc = float(kw.get("pseudocount", 1.0))
    min_cells_group = int(kw.get("min_cells_group", 3))
    names, cid_np = clusters(labels, min_cluster_size)
    k = len(names)
    pi, pj = np.triu_indices(k, k=1)
    cid = torch.as_tensor(cid_np, device=dev)
    s_e, s_nz, n_of = _aggregates(data, cid, k, dtype)
    n_np = n_of.cpu().numpy()
    pair_ok = (n_np[pi] >= min_cells_group) & (n_np[pj] >= min_cells_group)
    n_c = torch.clamp(n_of, min=1.0)
    pct = 100.0 * s_nz / n_c[None, :]
    me = s_e / n_c[None, :]
    ti = torch.as_tensor(pi, device=dev)
    tj = torch.as_tensor(pj, device=dev)
    pct_max = torch.maximum(pct[:, ti], pct[:, tj]).T               # (P, G)
    log_fc = (torch.log(me[:, ti] + pc) - torch.log(me[:, tj] + pc)).T
    tested = ((pct_max > min_pct)
              & ((torch.expm1(torch.log(me[:, ti] + pc)) > mean_thr)
                 | (torch.expm1(torch.log(me[:, tj] + pc)) > mean_thr)).T
              & (torch.abs(log_fc) > log_fc_thrs)
              & torch.as_tensor(pair_ok, device=dev)[:, None])
    n1 = n_of[ti][:, None]
    n2 = n_of[tj][:, None]
    log_p = torch.full(tested.shape, math.nan, dtype=dtype, device=dev)
    genes = torch.nonzero(tested.any(dim=0)).flatten()
    for g0 in range(0, genes.numel(), RUN_BLOCK):
        gs = genes[g0:g0 + RUN_BLOCK]
        u, m = _run_moments(data[gs].to(dtype), cid, k, dtype)
        u = u[:, ti, tj].T                                          # (P, B)
        ties = (m[:, ti, ti] + 3.0 * m[:, ti, tj] + 3.0 * m[:, tj, ti]
                + m[:, tj, tj]).T - n1 - n2
        z = u - n1 * n2 / 2.0
        z = z - torch.sign(z) * 0.5
        n = n1 + n2
        sigma2 = n1 * n2 / 12.0 * ((n + 1.0) - ties / (n * (n - 1.0)))
        sigma = torch.sqrt(torch.clamp(sigma2, min=0.0))
        lp = math.log(2.0) + torch.special.log_ndtr(-torch.abs(z / sigma))
        lp = torch.clamp(lp, max=0.0)
        lp = torch.where(sigma > 0, lp, torch.full_like(lp, math.nan))
        small = ((n1 < EXACT_N) & (n2 < EXACT_N) & (ties == 0)
                 ).expand_as(lp)
        if bool(small.any()):
            uu = u.cpu().numpy()
            for p, c in torch.nonzero(small).cpu().numpy():
                lp[p, c] = math.log(max(wilcox_exact_p(
                    float(uu[p, c]), int(n_np[pi[p]]), int(n_np[pj[p]])),
                    1e-300))
        log_p[:, gs] = lp
        del u, m
    log_p = torch.where(tested, log_p, torch.full_like(log_p, math.nan))
    log_q = bh_log(log_p, tested & torch.isfinite(log_p))
    de_mask = tested & (log_q < math.log(q_thr))

    def host(t):
        return t.cpu().numpy()

    return {"cluster_names": names, "log_p": host(log_p),
            "log_q": host(log_q), "log_fc": host(log_fc),
            "tested": host(tested), "de_mask": host(de_mask),
            "pct_max": host(pct_max), "q_thr": q_thr,
            "log_fc_thrs": log_fc_thrs, "min_pct": min_pct}
