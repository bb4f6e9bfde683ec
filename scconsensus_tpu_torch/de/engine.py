"""All-pairs differential-expression engine: the dense Wilcoxon path.

The torch form of the dense, mesh-free ``method="wilcox"`` path of
``scconsensus_tpu/de/engine.py``: every statistic for all K(K−1)/2 cluster
pairs at once from per-cluster structures.

  1. cluster filter (count > min_cluster_size, 'grey' dropped),
  2. per-cluster aggregates (``ops.gates``),
  3. per-pair Seurat gates from the aggregates (masks),
  4. the rank-sum test for every (pair, gene) through ``ranksum_body``,
     driven by the window ladder: genes sorted by nonzero count run in
     buckets whose window is the next power of two of their nnz, so the
     mostly-zero rows of expression data pay a fraction of the full scan;
     R's exact branch for pairs of small groups runs on the host,
  5. per-pair BH over the tested genes,
  6. the DE call and the top-N union.

The (P, G) results stay on the matrix's device; the union fetches only the
(P, n_top) indices. Left out against the reference: the mesh, sparse
input, the run-space kernel and its overflow redo, mid-stage checkpoints,
ladder recovery, the occupancy probe, integrity hooks and fault injection,
and methods other than ``wilcox``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from scconsensus_tpu_torch.config import ReclusterConfig
from scconsensus_tpu_torch.device import resolve_device
from scconsensus_tpu_torch.ops.gates import (
    compute_aggregates_cid,
    pair_gates_fast,
)
from scconsensus_tpu_torch.ops.multipletests import bh_adjust_masked
from scconsensus_tpu_torch.ops.ranksum_allpairs import (
    ALLPAIRS_ELEM_BUDGET,
    chunk_genes_for_budget,
    ranksum_body,
)
from scconsensus_tpu_torch.ops.wilcoxon import (
    EXACT_N_LIMIT,
    wilcoxon_exact_host,
)
from scconsensus_tpu_torch.utils.timing import StageClock

__all__ = ["PairwiseDEResult", "pairwise_de", "filter_clusters",
           "de_gene_union", "as_device_matrix"]


@dataclasses.dataclass
class PairwiseDEResult:
    """Dense all-pairs DE summary (P = #pairs, G = #genes). The (P, G)
    fields are tensors on the matrix's device."""

    cluster_names: List[str]
    pair_i: np.ndarray       # (P,) index into cluster_names
    pair_j: np.ndarray
    log_p: torch.Tensor      # (P, G); NaN where untested/degenerate
    log_q: torch.Tensor      # (P, G); NaN where not adjusted
    log_fc: torch.Tensor     # (P, G) natural-log fold change
    tested: torch.Tensor     # (P, G) bool: entered the statistical test
    de_mask: torch.Tensor    # (P, G) bool: final DE call
    pair_skipped: np.ndarray  # (P,) bool: skipped by group-size validation
    pct1: torch.Tensor       # (P, G)
    pct2: torch.Tensor
    u: torch.Tensor          # (P, G) Mann-Whitney U of group 1
    skip_reasons: Optional[List[str]] = None

    def de_counts(self) -> np.ndarray:
        """Per-pair DE gene counts (P ints to the host)."""
        return self.de_mask.sum(dim=1).cpu().numpy()


def filter_clusters(labels: Sequence, min_cluster_size: int,
                    drop_grey: bool = True) -> Tuple[List[str], np.ndarray]:
    """Clusters with count > min_cluster_size (strictly greater, §2d-7),
    'grey' substring dropped; returns (sorted names, per-cell index into
    names, −1 for dropped cells)."""
    lab = np.asarray(labels).astype(str)
    names, counts = np.unique(lab, return_counts=True)
    keep = counts > min_cluster_size
    if drop_grey:
        keep &= np.char.find(names, "grey") == -1
    kept = [str(n) for n in names[keep]]
    index = {n: i for i, n in enumerate(kept)}
    cell_idx = np.array([index.get(v, -1) for v in lab], dtype=np.int32)
    return kept, cell_idx


def _all_pairs(k: int) -> Tuple[np.ndarray, np.ndarray]:
    ii, jj = np.triu_indices(k, k=1)
    return ii.astype(np.int32), jj.astype(np.int32)


def _next_pow2(x: int) -> int:
    return 1 << (int(x) - 1).bit_length()


def _cid_from_groups(cell_idx_of: List[np.ndarray], n_cells: int
                     ) -> np.ndarray:
    """Per-cell cluster index (−1 = excluded) from the per-cluster cell
    lists — the post-subsampling groups every test uses."""
    cid = np.full(n_cells, -1, np.int32)
    for k, ci in enumerate(cell_idx_of):
        cid[ci] = k
    return cid


def _window_floor(n_cells: int) -> int:
    """Window-ladder floor: 1024, rising with N (N/256, capped at 16k) so
    the sparse tail of the ladder does not shatter into tiny buckets."""
    return int(min(max(1024, _next_pow2(max(n_cells // 256, 1))), 16384))


def as_device_matrix(data, device: torch.device) -> torch.Tensor:
    """The (G, N) float32 matrix on ``device``: a tensor already there is
    used as it is, anything else crosses once."""
    if isinstance(data, torch.Tensor):
        return data.to(device=device, dtype=torch.float32)
    if not isinstance(data, np.ndarray):
        raise NotImplementedError(
            f"input of type {type(data).__name__} is not supported yet "
            "(dense numpy arrays and tensors only; sparse input waits for "
            "a later slice)"
        )
    return torch.from_numpy(
        np.ascontiguousarray(data, dtype=np.float32)).to(device)


def _run_wilcox(
    data: torch.Tensor,
    cell_idx_of: List[np.ndarray],
    pair_i: np.ndarray,
    pair_j: np.ndarray,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank-sum (log_p, u), each (P, G) on the matrix's device, through
    the window ladder (or full-width gene chunks when any value is
    negative). R's exact branch replaces the normal approximation on the
    host for pairs with both groups < 50 cells, at their tie-free genes."""
    G, N = data.shape
    dev = data.device
    K = len(cell_idx_of)
    n_of = np.array([ci.size for ci in cell_idx_of], np.int32)
    cid = torch.as_tensor(_cid_from_groups(cell_idx_of, N), device=dev)
    tn = torch.as_tensor(n_of, device=dev)
    tpi = torch.as_tensor(pair_i, dtype=torch.int64, device=dev)
    tpj = torch.as_tensor(pair_j, dtype=torch.int64, device=dev)

    # O(G) ints to plan the ladder; the decomposition needs zeros as the
    # minimum, so any negative value sends every gene to full width
    nnz_g = (data > 0).sum(dim=1).cpu().numpy()
    windowed = not bool((data < 0).any())
    parts = []  # (gene ids, (log_p, u, tie_sum)), each block (Gb, P)
    if windowed:
        floor = _window_floor(N)
        order = np.argsort(nnz_g, kind="stable").astype(np.int64)
        nnz_sorted = nnz_g[order]
        g0 = 0
        while g0 < G:
            w = int(min(_next_pow2(max(int(nnz_sorted[g0]), floor)),
                        _next_pow2(N)))
            scan_w = min(w, N)
            # block size respects both working sets: the (gcb, K, scan_w)
            # kernel tensors and the (gcb, N) sort buffers
            gcb = max(8, min(ALLPAIRS_ELEM_BUDGET // max(scan_w * K, 1),
                             (ALLPAIRS_ELEM_BUDGET // 2) // max(N, 1)))
            gcb = 1 << (int(gcb).bit_length() - 1)
            g1 = g0
            while (g1 < G and g1 - g0 < gcb
                   and (w >= N or nnz_sorted[g1] <= w)):
                g1 += 1
            ids = order[g0:g1]
            rows = data.index_select(0, torch.as_tensor(ids, device=dev))
            parts.append((ids, ranksum_body(
                rows, cid, tn, tpi, tpj, K, window=w if w < N else 0)))
            g0 = g1
    else:
        gc = min(chunk_genes_for_budget(N, K), _next_pow2(G))
        for g0 in range(0, G, gc):
            ids = np.arange(g0, min(g0 + gc, G))
            parts.append((ids, ranksum_body(data[g0:g0 + gc], cid, tn,
                                            tpi, tpj, K)))
    inv = torch.as_tensor(
        np.argsort(np.concatenate([ids for ids, _ in parts]), kind="stable"),
        device=dev)

    def _gather(f: int) -> torch.Tensor:
        """Blocks in ladder order → (P, G) in gene order."""
        return torch.cat([o[f] for _, o in parts], dim=0)[inv].T

    log_p, u_stat = _gather(0), _gather(1)
    small = np.nonzero((n_of[pair_i] < EXACT_N_LIMIT)
                       & (n_of[pair_j] < EXACT_N_LIMIT))[0]
    if small.size:
        # R's exact branch runs on the host by design: fetch only the
        # small pairs' rows (u and the tie indicator)
        rows = torch.as_tensor(small, device=dev)
        u_small = u_stat[rows].cpu().numpy()
        tie_small = _gather(2)[rows].cpu().numpy()
        lp_small = log_p[rows].cpu().numpy()
        for r, p in enumerate(small):
            tiefree = tie_small[r] == 0
            if tiefree.any():
                pe = wilcoxon_exact_host(
                    u_small[r][tiefree],
                    int(n_of[pair_i[p]]), int(n_of[pair_j[p]]),
                )
                lp_small[r, np.nonzero(tiefree)[0]] = np.log(
                    pe).astype(np.float32)
        log_p[rows] = torch.from_numpy(lp_small).to(dev)
    return log_p, u_stat


def pairwise_de(
    data,
    labels: Sequence,
    config: ReclusterConfig,
    device=None,
    clock: Optional[StageClock] = None,
) -> PairwiseDEResult:
    """Run the all-pairs Wilcoxon DE test.

    data: (G, N) log-normalized expression, a numpy array or a tensor
    (kept where it is when it already lies on ``device``); labels:
    per-cell cluster names. Runs on ``cuda`` unless ``device="cpu"``."""
    dev = resolve_device(device)
    if config.method.lower() != "wilcox":
        raise NotImplementedError(
            f"DE method {config.method!r} is not ported yet (wilcox only)"
        )
    clock = clock or StageClock(dev)
    data = as_device_matrix(data, dev)
    G, N = data.shape

    with clock.stage("cluster_filter"):
        names, cell_idx = filter_clusters(
            labels, config.min_cluster_size, config.drop_grey
        )
        K = len(names)
        if K < 2:
            raise ValueError(
                f"need >= 2 clusters above min_cluster_size="
                f"{config.min_cluster_size}, got {K}"
            )
        cell_idx_of = [np.nonzero(cell_idx == k)[0].astype(np.int32)
                       for k in range(K)]
        if config.max_cells_per_ident is not None:
            rng = np.random.default_rng(config.random_seed)
            cap = config.max_cells_per_ident
            cell_idx_of = [
                rng.choice(ci, size=cap, replace=False)
                if ci.size > cap else ci
                for ci in cell_idx_of
            ]
        pair_i, pair_j = _all_pairs(K)
        # Group-size validation: pairs with a group below min_cells_group
        # are skipped with a recorded reason (the reference hard-errors,
        # R/reclusterDEConsensusFast.R:201-226).
        n_of = np.array([ci.size for ci in cell_idx_of], np.int32)
        pair_ok = (n_of[pair_i] >= config.min_cells_group) & (
            n_of[pair_j] >= config.min_cells_group
        )
        skip_reasons = [
            f"{names[i]} vs {names[j]}: group sizes ({n_of[i]}, {n_of[j]}) "
            f"below min_cells_group={config.min_cells_group}"
            for i, j in zip(pair_i[~pair_ok], pair_j[~pair_ok])
        ]
        if not pair_ok.any():
            raise ValueError(
                "every cluster pair has a group below "
                f"min_cells_group={config.min_cells_group}; nothing to test"
            )

    with clock.stage("aggregates"):
        agg = compute_aggregates_cid(
            data, torch.as_tensor(cell_idx, device=dev), K)

    pi = torch.as_tensor(pair_i, dtype=torch.int64, device=dev)
    pj = torch.as_tensor(pair_j, dtype=torch.int64, device=dev)
    ok = torch.as_tensor(pair_ok, device=dev)
    with clock.stage("gates"):
        gate, log_fc, pct1, pct2 = pair_gates_fast(
            agg, pi, pj,
            min_pct=config.min_pct,
            min_diff_pct=config.min_diff_pct,
            log_fc_thrs=config.log_fc_thrs,
            mean_exprs_thrs=config.mean_exprs_thrs,
            pseudocount=config.pseudocount,
            only_pos=config.only_pos,
        )
        tested = gate & ok[:, None]

    with clock.stage("wilcox_test"):
        log_p, u = _run_wilcox(data, cell_idx_of, pair_i, pair_j)
        # untested entries surface as NaN (and stay out of BH and the call)
        log_p = torch.where(tested, log_p,
                            torch.full_like(log_p, float("nan")))
    with clock.stage("bh_adjust"):
        log_q = bh_adjust_masked(log_p, tested)
    with clock.stage("de_call"):
        log_thr = float(np.log(np.float32(config.q_val_thrs)))
        de = tested & (log_q < log_thr) & ~torch.isnan(log_q)
    return PairwiseDEResult(
        cluster_names=names, pair_i=pair_i, pair_j=pair_j,
        log_p=log_p, log_q=log_q, log_fc=log_fc, tested=tested,
        de_mask=de, pair_skipped=~pair_ok, pct1=pct1, pct2=pct2, u=u,
        skip_reasons=skip_reasons or None,
    )


def de_gene_union(result: PairwiseDEResult, n_top: int = 30) -> np.ndarray:
    """Top-``n_top`` DE genes per pair by |logFC|, unioned
    (R/reclusterDEConsensus.R:209-227; fast path :386-392). The per-pair
    top-k runs on the device and only the (P, n_top) indices cross.
    Returns sorted unique gene indices."""
    masked = torch.where(result.de_mask, torch.abs(result.log_fc),
                         torch.full_like(result.log_fc, -float("inf")))
    k = min(n_top, masked.shape[1])
    vals, idx = torch.topk(masked, k, dim=1)
    vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
    return np.unique(idx[vals > -np.inf]).astype(np.int64)
