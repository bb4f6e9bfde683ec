"""Direct per-pair NB reference engine (test oracle for ``de.edger``).

The torch form of ``scconsensus_tpu/de/edger_direct.py``: the dense
per-pair formulation of the reference pipeline
(R/reclusterDEConsensus.R:123-156: per pair, DGEList(group ±1) →
estimateCommonDisp → estimateTagwiseDisp → calcNormFactors("none") →
exactTest). It equalizes library sizes per pair and evaluates every
conditional-likelihood grid densely over the pair's cells, so it is
O(pairs × genes × cells × grid) and not reachable from the production
engine: ``de.edger`` (global equalization and node-table grids) is held
against it by the statistical parity bars of the reference's
``tests/test_edger_parity.py``.

Pairs are bucketed by padded width (:func:`_bucket_pairs`, the
reference's ``de/engine.py:269-305``). Two phases per bucket, each a
plain torch function over the port's ``ops.negbin`` (the reference's two
jitted XLA programs, ``_pilot_kernel`` and ``_pass2_kernel``):

  phase 1 (pilot): on a strided gene subsample, equalize library sizes at
    the pilot dispersion 0.01, score the conditional log-likelihood over a
    φ grid, and take the per-pair qCML common dispersion (grid and
    quadratic refine);
  phase 2 (full): re-equalize at the common dispersion, accumulate
    per-gene conditional-LL grids for the tagwise EB shrinkage and the
    group pseudo-count sums; then the Beta-Binomial exact test per gene.

Compat mode hands the log-normalized values to the NB model as if they
were counts, as the reference does; fixed mode tests ``expm1(data)``.
Every phase runs on the matrix's device; results come back as host
arrays, as the reference's do.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from scconsensus_tpu_torch.device import as_points, resolve_device
from scconsensus_tpu_torch.ops.negbin import (
    TAGWISE_GRID_EXPONENTS,
    common_dispersion_grid,
    delta_grid,
    equalize_pseudo,
    nb_cond_log_lik,
    nb_exact_test_logp,
    tagwise_dispersion,
)

__all__ = ["run_edger_pairs", "EdgerPairResult"]

_PILOT_DISPERSION = 0.01
_PILOT_MAX_GENES = 2048
_ROWSUM_FILTER = 5.0
_PRIOR_DF = 10.0
_LOGFC_PRIOR_COUNT = 0.125
_EXACT_SMAX = 4096
# per-chunk element budget for (B, Gc, W) tiles (transcendental-heavy)
_NB_CHUNK_ELEMS = 8_000_000


@dataclasses.dataclass
class EdgerPairResult:
    log_p: np.ndarray        # (P, G)
    log_fc: np.ndarray       # (P, G) natural-log fold change 1 vs 2
    common_disp: np.ndarray  # (P,)
    tagwise_disp: np.ndarray  # (P, G)


@dataclasses.dataclass
class _PairBucket:
    rows: np.ndarray      # (B,) indices into the global pair list
    cell_idx: np.ndarray  # (B, W) gather indices into the columns
    mask1: np.ndarray     # (B, W) group-1 membership of the gathered cells
    mask2: np.ndarray
    n1: np.ndarray        # (B,)
    n2: np.ndarray


def _next_pow2(x: int) -> int:
    return 1 << (int(x) - 1).bit_length()


def _bucket_pairs(cell_idx_of: List[np.ndarray], pair_i: np.ndarray,
                  pair_j: np.ndarray) -> List[_PairBucket]:
    """Group pairs by padded width so each bucket runs in one shape."""
    widths = {}
    for r in range(pair_i.shape[0]):
        w = _next_pow2(
            cell_idx_of[pair_i[r]].size + cell_idx_of[pair_j[r]].size)
        widths.setdefault(w, []).append(r)
    buckets = []
    for w, rows in sorted(widths.items()):
        B = len(rows)
        idx = np.zeros((B, w), np.int32)
        m1 = np.zeros((B, w), bool)
        m2 = np.zeros((B, w), bool)
        n1 = np.zeros(B, np.int32)
        n2 = np.zeros(B, np.int32)
        for b, r in enumerate(rows):
            ci = cell_idx_of[pair_i[r]]
            cj = cell_idx_of[pair_j[r]]
            idx[b, : ci.size] = ci
            idx[b, ci.size: ci.size + cj.size] = cj
            m1[b, : ci.size] = True
            m2[b, ci.size: ci.size + cj.size] = True
            n1[b], n2[b] = ci.size, cj.size
        buckets.append(_PairBucket(np.asarray(rows), idx, m1, m2, n1, n2))
    return buckets


def _gather(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(G', N) rows at the bucket's (B, W) cells: (B, G', W)."""
    return rows[:, idx].transpose(0, 1)


def _pilot_grid(sub_counts, idx, m1, m2, lib_tile, common_lib, deltas):
    """Pilot-phase conditional-LL grid: (B, D) LL sums over the filtered
    subsample genes. sub_counts: (Gs, N); idx/m1/m2/lib_tile: (B, W);
    common_lib: (B,); deltas: (D,) tensor."""
    y = _gather(sub_counts, idx)                      # (B, Gs, W)
    m1e, m2e = m1[:, None, :], m2[:, None, :]
    lib = lib_tile[:, None, :]
    pilot = torch.full_like(common_lib[:, None], _PILOT_DISPERSION)
    ps = equalize_pseudo(y, lib, m1e, m2e, common_lib[:, None], pilot)
    pooled = m1e | m2e
    z = torch.where(pooled, y, torch.zeros_like(y)).sum(dim=-1)  # (B, Gs)
    keep = z > _ROWSUM_FILTER
    cols = []
    for delta in deltas:
        r = (1.0 - delta) / delta
        ll = nb_cond_log_lik(ps.pseudo, m1e, r) + nb_cond_log_lik(
            ps.pseudo, m2e, r)
        cols.append(torch.where(keep, ll, torch.zeros_like(ll)).sum(dim=-1))
    return torch.stack(cols, dim=-1)


def _pass2(chunk, idx, m1, m2, lib_tile, common_lib, common_disp):
    """Full-phase per-gene statistics at the common dispersion: (s1, s2,
    ll_grid (B, Gc, T), keep (B, Gc)). chunk: (Gc, N); common_disp:
    (B,)."""
    y = _gather(chunk, idx)                           # (B, Gc, W)
    m1e, m2e = m1[:, None, :], m2[:, None, :]
    lib = lib_tile[:, None, :]
    ps = equalize_pseudo(y, lib, m1e, m2e, common_lib[:, None],
                         common_disp[:, None])
    zero = torch.zeros_like(ps.pseudo)
    s1 = torch.where(m1e, ps.pseudo, zero).sum(dim=-1)
    s2 = torch.where(m2e, ps.pseudo, zero).sum(dim=-1)
    pooled = m1e | m2e
    z = torch.where(pooled, y, torch.zeros_like(y)).sum(dim=-1)
    keep = z > _ROWSUM_FILTER
    expos = torch.as_tensor(TAGWISE_GRID_EXPONENTS, device=chunk.device)
    grid = []
    for expo in expos:
        phi = common_disp[:, None] * torch.exp2(expo)  # (B, 1)
        r = 1.0 / torch.clamp(phi, min=1e-10)
        grid.append(nb_cond_log_lik(ps.pseudo, m1e, r)
                    + nb_cond_log_lik(ps.pseudo, m2e, r))
    return s1, s2, torch.stack(grid, dim=-1), keep


def _dense_rows(counts, g0: int, g1: int, dev) -> torch.Tensor:
    """Rows [g0, g1) of ``counts`` (a tensor, or a scipy.sparse matrix
    densified one gene chunk at a time) as a float32 tensor on ``dev``."""
    if isinstance(counts, torch.Tensor):
        return counts[g0:g1]
    return torch.as_tensor(np.asarray(counts[g0:g1].toarray(), np.float32),
                           device=dev)


def run_edger_pairs(counts, buckets, n_genes: int, n_pairs: int,
                    device=None) -> EdgerPairResult:
    """Run the NB pipeline for every bucketed pair.

    counts: (G, N) the matrix handed to DGEList (log-normalized data in
    compat mode, the reference's literal behavior, or expm1 of it): a
    tensor (its phases run on its device), a numpy array (on ``device``,
    the card by default) or a scipy.sparse matrix (gene chunks densified
    on demand, on ``device``). buckets: :func:`_bucket_pairs`'s list.
    """
    import scipy.sparse as sp

    sparse = sp.issparse(counts)
    if sparse:
        counts = sp.csr_matrix(counts, dtype=np.float32)
        dev = resolve_device(device)
        lib_all = torch.as_tensor(
            np.asarray(counts.sum(axis=0), np.float32).ravel(), device=dev)
    else:
        counts = as_points(counts, device)
        dev = counts.device
        lib_all = counts.sum(dim=0)                   # (N,) library sizes
    G = n_genes

    log_p = np.full((n_pairs, G), np.nan, np.float32)
    log_fc = np.full((n_pairs, G), np.nan, np.float32)
    common_out = np.zeros(n_pairs, np.float32)
    tagwise_out = np.full((n_pairs, G), np.nan, np.float32)

    stride = max(1, G // _PILOT_MAX_GENES)
    sub_idx = np.arange(0, G, stride, dtype=np.int64)[:_PILOT_MAX_GENES]
    if sparse:
        sub = torch.as_tensor(counts[sub_idx].toarray(), device=dev)
    else:
        sub = counts[torch.as_tensor(sub_idx, device=dev)]
    deltas_np = delta_grid(24)
    deltas = torch.as_tensor(deltas_np, device=dev)
    n_t = TAGWISE_GRID_EXPONENTS.shape[0]

    for bucket in buckets:
        B, W = bucket.cell_idx.shape
        idx = torch.as_tensor(bucket.cell_idx, dtype=torch.long, device=dev)
        m1 = torch.as_tensor(bucket.mask1, device=dev)
        m2 = torch.as_tensor(bucket.mask2, device=dev)
        n1 = torch.as_tensor(bucket.n1, device=dev).to(torch.float32)
        n2 = torch.as_tensor(bucket.n2, device=dev).to(torch.float32)
        lib_tile = lib_all[idx]                       # (B, W)
        pooled = bucket.mask1 | bucket.mask2
        # geometric mean of the pooled cells' library sizes
        lib_np = lib_tile.cpu().numpy()
        with np.errstate(divide="ignore"):
            loglib = np.where(pooled, np.log(np.maximum(lib_np, 1e-30)), 0.0)
        common_lib = torch.as_tensor(
            np.exp(loglib.sum(axis=1) / np.maximum(pooled.sum(axis=1), 1)),
            dtype=torch.float32, device=dev)

        # phase 1: the pilot common dispersion
        grid = _pilot_grid(sub, idx, m1, m2, lib_tile, common_lib, deltas)
        common = common_dispersion_grid(grid, deltas_np)      # (B,)
        common_out[bucket.rows] = common.cpu().numpy()

        # phase 2: per-gene LL grids and pseudo sums, chunked over genes
        gc = max(128, _NB_CHUNK_ELEMS // max(B * W, 1))
        gc = min(_next_pow2(gc), _next_pow2(G))
        s1_full = np.zeros((B, G), np.float32)
        s2_full = np.zeros((B, G), np.float32)
        ll_full = np.zeros((B, G, n_t), np.float32)
        keep_full = np.zeros((B, G), bool)
        for g0 in range(0, G, gc):
            g1 = min(g0 + gc, G)
            chunk = _dense_rows(counts, g0, g1, dev)
            if chunk.shape[0] < gc:
                chunk = torch.nn.functional.pad(
                    chunk, (0, 0, 0, gc - chunk.shape[0]))
            s1, s2, ll_g, keep = _pass2(chunk, idx, m1, m2, lib_tile,
                                        common_lib, common)
            s1_full[:, g0:g1] = s1.cpu().numpy()[:, : g1 - g0]
            s2_full[:, g0:g1] = s2.cpu().numpy()[:, : g1 - g0]
            ll_full[:, g0:g1] = ll_g.cpu().numpy()[:, : g1 - g0]
            keep_full[:, g0:g1] = keep.cpu().numpy()[:, : g1 - g0]

        # tagwise EB shrinkage (prior.df = 10, trend="none")
        prior_n = torch.as_tensor(
            _PRIOR_DF / np.maximum(bucket.n1 + bucket.n2 - 2, 1),
            dtype=torch.float32, device=dev)
        tagwise = tagwise_dispersion(
            torch.as_tensor(ll_full, device=dev), common, prior_n,
            torch.as_tensor(keep_full, device=dev))   # (B, G)
        tagwise_np = tagwise.cpu().numpy()
        tagwise_out[bucket.rows] = tagwise_np

        # the exact test, chunked to bound the (B, Gc, s_max) tail tensor;
        # s_max follows the largest rounded total present (a power of two)
        max_total = float(np.max(np.round(s1_full) + np.round(s2_full),
                                 initial=0.0))
        s_max = int(min(_EXACT_SMAX,
                        _next_pow2(max(int(max_total) + 2, 64))))
        gce = max(64, _NB_CHUNK_ELEMS // max(B * s_max, 1))
        for g0 in range(0, G, gce):
            g1 = min(g0 + gce, G)
            pad_w = ((0, 0), (0, gce - (g1 - g0)))
            lp = nb_exact_test_logp(
                torch.as_tensor(np.pad(s1_full[:, g0:g1], pad_w),
                                device=dev),
                torch.as_tensor(np.pad(s2_full[:, g0:g1], pad_w),
                                device=dev),
                n1[:, None], n2[:, None],
                torch.as_tensor(np.pad(tagwise_np[:, g0:g1], pad_w,
                                       constant_values=1.0), device=dev),
                s_max=s_max)
            log_p[bucket.rows, g0:g1] = lp.cpu().numpy()[:, : g1 - g0]

        # natural-log fold change from the equalized group abundances
        # with the small prior count
        ab1 = s1_full / np.maximum(bucket.n1[:, None], 1) + _LOGFC_PRIOR_COUNT
        ab2 = s2_full / np.maximum(bucket.n2[:, None], 1) + _LOGFC_PRIOR_COUNT
        log_fc[bucket.rows] = np.log(ab1) - np.log(ab2)

    return EdgerPairResult(log_p=log_p, log_fc=log_fc,
                           common_disp=common_out, tagwise_disp=tagwise_out)
