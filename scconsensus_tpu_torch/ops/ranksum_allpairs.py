"""All-pairs Mann-Whitney U from one sort per gene — no per-pair tiles.

The torch form of ``scconsensus_tpu/ops/ranksum_allpairs.py``
``chunk_genes_for_budget`` (:111-115), ``ranksum_body`` (:145-252, the scan
form) and ``_pairs_finish`` (:255-318). For one gene, sort all N cells
once. With C the (K, N) cluster indicator in sorted order and S its
inclusive cumsum, every sorted position p knows for every cluster k

    L[k, p] = # cells of k strictly below x_p   (forward fill of run starts)
    T[k, p] = # cells of k at or below x_p      (backward fill of run ends)

so U[i, j] = Σ_p C[i, p] · (L[j, p] + T[j, p]) / 2 and the pooled tie
moments B[k, l] = Σ_runs r_k² r_l = Σ_p C[k, p] · e(p) · E[l, p] (E = T − L,
e(p) the cell's own-run count) are two contractions per gene; every pair's
p-value follows from the (K, K) matrices.

Translation notes: ``lax.sort`` with ``num_keys=1`` becomes
``torch.sort(stable=True)`` with the cluster ids gathered by the returned
indices (the statistics depend only on run membership, never on the order
inside a tie run); ``lax.cummax`` becomes ``torch.cummax(...).values``; the
reverse ``cummin`` is a flip, a ``cummin`` and a flip back. Counts are
exact in float32 (N < 2²⁴) and the contractions run in full fp32
(``device.py`` keeps TF32 off).

``cpu_forms``: the reference's two contraction forms. True: segment sums
over the one-hot cluster axis and flat gathers of pair entries, O(W·K)
(the form it takes on CPU). False: batched matrix products and one-hot
pair selections (the form it takes on an accelerator). None picks by the
chunk's device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from scconsensus_tpu_torch.ops.wilcoxon import wilcoxon_from_ranks

__all__ = ["ranksum_body", "chunk_genes_for_budget", "ALLPAIRS_ELEM_BUDGET"]

# Element budget for the (Gc, K, N) working tensors (~6 live at once).
ALLPAIRS_ELEM_BUDGET = 320_000_000


def chunk_genes_for_budget(n_cells: int, n_clusters: int) -> int:
    """Gene-chunk width keeping Gc·N·K under the working-set budget."""
    gc = max(8, ALLPAIRS_ELEM_BUDGET // max(n_cells * n_clusters, 1))
    return max(8, 1 << (int(gc).bit_length() - 1))  # floor power of two


def ranksum_body(
    chunk: torch.Tensor,     # (Gc, N) gene rows
    cid: torch.Tensor,       # (N,) int cluster index, -1 = excluded
    n_of: torch.Tensor,      # (K,) cluster sizes
    pair_i: torch.Tensor,    # (P,) cluster index of group 1 per pair
    pair_j: torch.Tensor,    # (P,)
    n_clusters: int,
    window: int = 0,
    cpu_forms: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rank-sum log-p for every (gene, pair) of one gene chunk.

    Returns (log_p, u, tie_sum), each (Gc, P). Excluded cells (cid = −1)
    occupy sorted positions but count for no cluster.

    ``window`` > 0 enables the zero-block decomposition for sparse rows:
    values sort descending so the ≤ ``window`` positive entries land in a
    prefix, the (Gc, K, ·) machinery runs at the window width, and the
    all-zero tie block enters through closed-form corrections (z_k = zero
    count of cluster k, U′ = above-or-tied dominance among window cells):

        U[i,j] = n_i·n_j − (U′[i,j] + z_i·nnz_j + z_i·z_j/2),
        B[k,l] = B′[k,l] + z_k²·z_l.

    Every gene in the chunk must have ≤ ``window`` positive cells and no
    negative values; the engine buckets genes by nnz.
    """
    Gc, N = chunk.shape
    K = n_clusters
    dev = chunk.device
    sparse_mode = window > 0
    use_cpu = (dev.type == "cpu") if cpu_forms is None else bool(cpu_forms)
    w_eff = min(window, N) if sparse_mode else N
    key = -chunk if sparse_mode else chunk
    sv, perm = torch.sort(key, dim=1, stable=True)
    scid = cid.to(device=dev, dtype=torch.int64)[perm]   # (Gc, N)
    if sparse_mode:
        sv = sv[:, :w_eff]
        scid = torch.where(sv < 0, scid[:, :w_eff],
                           torch.full_like(scid[:, :w_eff], -1))
    W = sv.shape[1]
    # (Gc, K, W): cells on the minor axis.
    C = (scid[:, None, :] == torch.arange(K, device=dev)[None, :, None]
         ).to(torch.float32)
    S = torch.cumsum(C, dim=-1)                          # inclusive

    new_run = torch.cat(
        [torch.ones((Gc, 1), dtype=torch.bool, device=dev),
         sv[:, 1:] != sv[:, :-1]], dim=1,
    )[:, None, :]                                        # (Gc, 1, W)
    is_end = torch.cat(
        [new_run[:, :, 1:],
         torch.ones((Gc, 1, 1), dtype=torch.bool, device=dev)], dim=2,
    )
    # Segmented fills without gathers: cumsum values at run starts (ends)
    # are monotone along the cells, so a cummax of start values masked to
    # −1 forward-fills the strictly-below counts, and a reverse cummin of
    # end values masked to W+1 backward-fills the through-run totals.
    L = torch.cummax(torch.where(new_run, S - C, torch.full_like(S, -1.0)),
                     dim=2).values
    T = torch.where(is_end, S, torch.full_like(S, float(W + 1)))
    T = torch.flip(torch.cummin(torch.flip(T, [2]), dim=2).values, [2])
    E = T - L                                            # equal counts
    V = 0.5 * (L + T)                                    # L + E/2
    own_eq = torch.sum(C * E, dim=1)                     # (Gc, W)
    if use_cpu:
        # C is one-hot along k: row i of u_mat is the segment sum of V's
        # columns over cluster i's cells (row K collects excluded cells).
        flat = (torch.arange(Gc, device=dev)[:, None] * (K + 1)
                + torch.where(scid >= 0, scid, torch.full_like(scid, K))
                ).reshape(-1)                            # (Gc·W,)
        Vt = V.transpose(1, 2).reshape(Gc * W, K)
        u_mat = torch.zeros((Gc * (K + 1), K), dtype=torch.float32,
                            device=dev).index_add_(0, flat, Vt)
        u_mat = u_mat.view(Gc, K + 1, K)[:, :K, :]
        eEt = (E.transpose(1, 2) * own_eq[:, :, None]).reshape(Gc * W, K)
        B = torch.zeros((Gc * (K + 1), K), dtype=torch.float32,
                        device=dev).index_add_(0, flat, eEt)
        B = B.view(Gc, K + 1, K)[:, :K, :]
    else:
        u_mat = torch.bmm(C, V.transpose(1, 2))          # (Gc, K, K)
        B = torch.bmm(C * own_eq[:, None, :], E.transpose(1, 2))

    nnz_k = torch.sum(C, dim=-1)                         # (Gc, K)
    return _pairs_finish(u_mat, B, nnz_k, n_of, pair_i, pair_j, K,
                         sparse_mode, use_cpu)


def _pairs_finish(u_mat, B, nnz_k, n_of, pair_i, pair_j, n_clusters: int,
                  sparse_mode: bool, use_cpu: bool):
    """Per-pair extraction from the (K, K) statistic matrices, zero-block
    corrections (sparse mode) and the p-value."""
    Gc = u_mat.shape[0]
    K = n_clusters
    dev = u_mat.device
    pair_i = pair_i.to(device=dev, dtype=torch.int64)
    pair_j = pair_j.to(device=dev, dtype=torch.int64)
    n_of = n_of.to(device=dev)
    P = pair_i.shape[0]
    b_diag = torch.diagonal(B, dim1=1, dim2=2)           # (Gc, K)
    if use_cpu:
        flat_ij = pair_i * K + pair_j                    # (P,)
        flat_ji = pair_j * K + pair_i
        u = u_mat.reshape(Gc, K * K)[:, flat_ij]
        b_ij = B.reshape(Gc, K * K)[:, flat_ij]
        b_ji = B.reshape(Gc, K * K)[:, flat_ji]
        d_i = b_diag[:, pair_i]                          # (Gc, P)
        d_j = b_diag[:, pair_j]
    else:
        eye = torch.eye(K, dtype=torch.float32, device=dev)
        sel_i = eye[pair_i]                              # (P, K)
        sel_j = eye[pair_j]
        sel_ij = (sel_i[:, :, None] * sel_j[:, None, :]).reshape(P, K * K)
        sel_ji = (sel_j[:, :, None] * sel_i[:, None, :]).reshape(P, K * K)
        u = u_mat.reshape(Gc, K * K) @ sel_ij.T
        b_ij = B.reshape(Gc, K * K) @ sel_ij.T
        b_ji = B.reshape(Gc, K * K) @ sel_ji.T
        d_i = b_diag @ sel_i.T                           # (Gc, P)
        d_j = b_diag @ sel_j.T

    n1 = n_of[pair_i].to(torch.float32)                  # (P,)
    n2 = n_of[pair_j].to(torch.float32)

    if sparse_mode:
        z_k = torch.clamp(n_of.to(torch.float32)[None, :] - nnz_k, min=0.0)
        if use_cpu:
            nnz_j = nnz_k[:, pair_j]                     # (Gc, P)
            z_i = z_k[:, pair_i]
            z_j = z_k[:, pair_j]
        else:
            nnz_j = nnz_k @ sel_j.T
            z_i = z_k @ sel_i.T
            z_j = z_k @ sel_j.T
        # u holds U′ (descending order = above-or-tied dominance)
        u = n1[None, :] * n2[None, :] - (u + z_i * nnz_j + 0.5 * z_i * z_j)
        # zero-run tie moments: B_full[k,l] = B′[k,l] + z_k²·z_l
        d_i = d_i + z_i * z_i * z_i
        d_j = d_j + z_j * z_j * z_j
        b_ij = b_ij + z_i * z_i * z_j
        b_ji = b_ji + z_j * z_j * z_i

    tie_sum = d_i + d_j + 3.0 * (b_ij + b_ji) - (n1 + n2)[None, :]
    rs1 = u + n1 * (n1 + 1.0) / 2.0
    log_p, u_out = wilcoxon_from_ranks(rs1, tie_sum, n1, n2)
    return log_p, u_out, tie_sum
