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
inside a tie run). The reference fills L and T with a ``cummax`` and a
reverse ``cummin`` over the (Gc, K, W) counts; here the scans run over the
(Gc, W) positions of each cell's run start and run end, and L and T are
gathers of S − C and S at those positions: the same integers, without the
scans' (Gc, K, W) values and int64 indices (at the 1M-cell ladder's widest
blocks each such tensor is a gigabyte). Counts are exact in float32
(N < 2²⁴) and the contractions run in full fp32 (``device.py`` keeps TF32
off).

``cpu_forms``: the reference's two contraction forms. True: segment sums
over the one-hot cluster axis and flat gathers of pair entries, O(W·K)
(the form it takes on CPU). False: batched matrix products and one-hot
pair selections (the form it takes on an accelerator). None picks by the
chunk's device.

``ranksum_body_runspace`` (:321-470) is the reference's tied-run form of
the same statistic, with its overflow output (the tied runs a gene holds;
entries past ``run_cap`` are invalid). The port's engine keeps its one
rank-sum form, the scan body, on both devices, where the reference's
engine takes the run-space form on XLA:CPU only
(``scconsensus_tpu/de/engine.py:768-772``): the port's CPU is its test
device, and the labels are the same either way. Its tables are built in
the reference's CPU forms (scatter-adds and per-cell gathers, O(W·K)),
on any device.

Graph passports (``obs.graphs``, ``SCC_GRAPHS``) under the reference's
names (:472-483): ``ranksum_body`` is ``wilcox.allpairs_ranksum_chunk``
(``allpairs_ranksum_chunk``, the reference's public name for it, is the
same function), ``sort_probe`` is ``wilcox.sort_probe``. The engine never
runs the run-space form, so ``allpairs_ranksum_runspace_chunk`` (the same
function as ``ranksum_body_runspace``) has no passport.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from scconsensus_tpu_torch.obs.graphs import instrument as _passport
from scconsensus_tpu_torch.ops.wilcoxon import wilcoxon_from_ranks

__all__ = ["allpairs_ranksum_chunk", "allpairs_ranksum_runspace_chunk",
           "ranksum_body", "ranksum_body_runspace", "chunk_genes_for_budget",
           "sort_probe", "RUN_CAP", "ALLPAIRS_ELEM_BUDGET"]

# Element budget for the (Gc, K, N) working tensors (~6 live at once).
ALLPAIRS_ELEM_BUDGET = 320_000_000

# Upper bound on the run-space form's tied-run table height (a memory
# guard): the height is pow2(W/2), the most size-≥2 runs a W-wide window
# holds, so only windows wider than 2·RUN_CAP can overflow it.
RUN_CAP = 65536


def chunk_genes_for_budget(n_cells: int, n_clusters: int) -> int:
    """Gene-chunk width keeping Gc·N·K under the working-set budget."""
    gc = max(8, ALLPAIRS_ELEM_BUDGET // max(n_cells * n_clusters, 1))
    return max(8, 1 << (int(gc).bit_length() - 1))  # floor power of two


def sort_probe(chunk: torch.Tensor, window: int = 0):
    """The body's first stage — the stable value sort of each gene row —
    alone. The engine's occupancy probe (``SCC_WILCOX_PROBE=1``) times it
    separately per bucket so the sort's cost splits out of the
    contraction's."""
    return torch.sort(-chunk if window > 0 else chunk, dim=1, stable=True)


def ranksum_body(
    chunk: torch.Tensor,     # (Gc, N) gene rows
    cid: torch.Tensor,       # (N,) or (Gc, N) int cluster index, -1 = excluded
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
    negative values; the engine buckets genes by nnz. ``window`` may equal
    (or exceed) the chunk width for pre-compacted input: rows holding only
    a gene's stored CSR entries with a matching (Gc, W) ``cid`` (padding
    slots 0 / −1), where every absent cell is an implicit zero the same
    corrections account for.
    """
    Gc, N = chunk.shape
    K = n_clusters
    dev = chunk.device
    sparse_mode = window > 0
    use_cpu = (dev.type == "cpu") if cpu_forms is None else bool(cpu_forms)
    w_eff = min(window, N) if sparse_mode else N
    key = -chunk if sparse_mode else chunk
    sv, perm = torch.sort(key, dim=1, stable=True)
    cid = cid.to(device=dev, dtype=torch.int64)
    # a shared (N,) vector, or each gene's own (Gc, N) row of a compacted
    # window
    scid = torch.gather(cid, 1, perm) if cid.dim() == 2 else cid[perm]
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
    )                                                    # (Gc, W)
    is_end = torch.cat(
        [new_run[:, 1:], torch.ones((Gc, 1), dtype=torch.bool, device=dev)],
        dim=1,
    )
    # Segmented fills: each cell's run start is the last start at or before
    # it (a cummax of start positions) and its run end the first end at or
    # after it (a reverse cummin of end positions). L is S − C at the run
    # start (the cells strictly below), T is S at the run end (the cells at
    # or below).
    pos = torch.arange(W, device=dev).expand(Gc, W)
    start = torch.cummax(torch.where(new_run, pos, 0), dim=1).values
    end = torch.flip(torch.cummin(torch.flip(
        torch.where(is_end, pos, W - 1), [1]), dim=1).values, [1])
    L = torch.gather(S - C, 2, start[:, None, :].expand(Gc, K, W))
    T = torch.gather(S, 2, end[:, None, :].expand(Gc, K, W))
    del S
    E = T - L                                            # equal counts
    V = 0.5 * (L + T)                                    # L + E/2
    del L, T
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


def ranksum_body_runspace(
    chunk: torch.Tensor,
    cid: torch.Tensor,
    n_of: torch.Tensor,
    pair_i: torch.Tensor,
    pair_j: torch.Tensor,
    n_clusters: int,
    window: int = 0,
    run_cap: int = RUN_CAP,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Tied-run formulation of ``ranksum_body``: one cumsum, no fills.

    A position p in a size-1 run has L_j(p) + E_j(p)/2 = S_j(p) − C_j(p)
    straight from the inclusive cumsum S; positions in size-≥2 runs go
    through a per-run table, with R[k, t] = # cells of cluster k in tied
    run t and Lg[j, t] = # j-cells strictly before the run:

        U[i, j] = Σ_{p untied} C_i(S_j − C_j) + Σ_t R_i·(Lg_j + R_j/2),
        B[k, l] = diag(# untied positions of k) + Σ_t R_k²·R_l,

    the scan body's statistic exactly (size-1 runs add t³−t = 0 to the tie
    moments). The table height is min(run_cap, pow2(W/2)); the tables are
    filled by scatter-adds and read back per cell by gathers. Returns
    (log_p, u, tie_sum, n_tied_runs), each statistic (Gc, P); entries of a
    gene whose ``n_tied_runs > run_cap`` had tail runs merged and are
    invalid (the reference's engine redoes those genes with the scan
    body). ``window`` and pre-compacted (Gc, W) ``cid`` rows as in
    ``ranksum_body``.
    """
    Gc, N = chunk.shape
    K = n_clusters
    dev = chunk.device
    sparse_mode = window > 0
    w_eff = min(window, N) if sparse_mode else N
    key = -chunk if sparse_mode else chunk
    sv, perm = torch.sort(key, dim=1, stable=True)
    cid = cid.to(device=dev, dtype=torch.int64)
    scid = torch.gather(cid, 1, perm) if cid.dim() == 2 else cid[perm]
    if sparse_mode:
        sv = sv[:, :w_eff]
        scid = torch.where(sv < 0, scid[:, :w_eff],
                           torch.full_like(scid[:, :w_eff], -1))
    W = sv.shape[1]
    oh_k = (scid[:, :, None] == torch.arange(K, device=dev)[None, None, :]
            ).to(torch.float32)                          # (Gc, W, K)
    S = torch.cumsum(oh_k, dim=1)                        # inclusive
    SmC = S - oh_k                                       # strictly before

    no = torch.zeros((Gc, 1), dtype=torch.bool, device=dev)
    same_prev = torch.cat([no, sv[:, 1:] == sv[:, :-1]], dim=1)
    same_next = torch.cat([same_prev[:, 1:], no], dim=1)
    tied = same_prev | same_next                         # (Gc, W)
    if sparse_mode:
        # the window's all-zero tail is excluded already; it must not
        # count as a tied run
        tied = tied & (sv < 0)
    tstart = tied & ~same_prev
    tid_raw = torch.cumsum(tstart.to(torch.int64), dim=1) - 1
    n_truns = tid_raw[:, -1] + 1                         # tied runs a gene
    T = int(min(run_cap, 1 << max(W // 2 - 1, 1).bit_length()))
    tid = torch.clamp(tid_raw, 0, T - 1)
    rows = torch.arange(Gc, device=dev)[:, None]

    def scatter(height: int, idx: torch.Tensor, vals: torch.Tensor):
        # (Gc, W, K) values added into (Gc, height, K) rows idx (Gc, W)
        flat = (rows * height + idx).reshape(-1)
        out = torch.zeros((Gc * height, K), dtype=torch.float32, device=dev)
        return out.index_add_(0, flat, vals.reshape(-1, K)).view(
            Gc, height, K)

    tied_f = tied[:, :, None].to(torch.float32)
    R = scatter(T, tid, oh_k * tied_f)                   # (Gc, T, K)
    Lg = scatter(T, tid, SmC * tstart[:, :, None].to(torch.float32))
    untied_k = torch.sum(oh_k * (1.0 - tied_f), dim=1)   # (Gc, K)
    valid = scid >= 0
    trash = torch.full_like(scid, K)
    idx_un = torch.where(valid & ~tied, scid, trash)
    idx_t = torch.where(tied & valid, scid, trash)
    tidb = tid[:, :, None].expand(Gc, W, K)
    Xg = torch.gather(Lg + 0.5 * R, 1, tidb)             # (Gc, W, K)
    u_mat = (scatter(K + 1, idx_un, SmC)
             + scatter(K + 1, idx_t, Xg))[:, :K, :]
    Rg = torch.gather(R, 1, tidb)
    r_own = torch.sum(Rg * oh_k, dim=2)                  # (Gc, W)
    B = scatter(K + 1, idx_t, Rg * r_own[:, :, None])[:, :K, :]
    B = B + untied_k[:, :, None] * torch.eye(K, device=dev)[None]
    log_p, u_out, tie_sum = _pairs_finish(
        u_mat, B, S[:, -1, :], n_of, pair_i, pair_j, K, sparse_mode,
        dev.type == "cpu")
    # a gene past the effective height T (below run_cap at small windows)
    # must read as over the cap too
    n_truns = torch.where(n_truns > T,
                          torch.clamp(n_truns, min=run_cap + 1), n_truns)
    return log_p, u_out, tie_sum, n_truns


ranksum_body = _passport("wilcox.allpairs_ranksum_chunk", ranksum_body)
sort_probe = _passport("wilcox.sort_probe", sort_probe)
# the reference's public names of the two bodies
allpairs_ranksum_chunk = ranksum_body
allpairs_ranksum_runspace_chunk = ranksum_body_runspace
