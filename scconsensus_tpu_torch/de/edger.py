"""All-pairs edgeR-style NB DE (``method="edger"`` of the engine).

The torch form of ``scconsensus_tpu/de/edger.py``. It replaces the
reference R pipeline (R/reclusterDEConsensus.R:123-156: per pair DGEList →
estimateCommonDisp → estimateTagwiseDisp → calcNormFactors("none") →
exactTest) with per-cluster structures, never a pair × cell tensor:

  1. setup: library sizes, the geometric-mean common library size, and
     the seeded dispersion subsample (≤ ``_SUB_CELLS`` cells a cluster,
     drawn by numpy exactly as the reference draws it);
  2. pass A: raw cluster sums and per-cluster Poisson rates;
  3. pilot table: Σ_{cells∈cluster} lgamma_shift(pseudo, r) on the
     subsample at ``_NODE_COUNT`` log-spaced r nodes, pseudo-counts from
     the full NB quantile map at the pilot dispersion (the gamma half
     only on each gene's positive entries);
  4. common grid: per-pair qCML conditional likelihood on the 24-point δ
     grid by 4-point Lagrange interpolation in log r, argmax + parabola;
  5. table 1: the node table again at the median common dispersion;
  6. z1 sweep: every cell's count mapped by the normal half to the common
     library size, summed per cluster;
  7. tagwise: weighted-likelihood EB dispersions per (pair, gene);
  8. exact test: the normal branch for every entry, then the exact
     Beta-Binomial tails for the entries with small totals, bucketed by
     total on the device and scattered back.

Each step is a sub-stage of the caller's ``StageClock`` (``edger_setup``
… ``edger_exact_small``). ``counts`` is a dense tensor or the CSR holder
``io.sparsemat.DeviceCSR`` (``scconsensus_tpu/de/edger.py`` :368-449,
:552): its library sizes, subsample columns, pass A sums and z1 sweep run
over gene chunks gathered from the triplet, never the whole matrix. The
reference pads chunks to fixed shapes to bound XLA recompiles; eager
torch needs no padding, and no result depends on the chunking. Every
(P, G) result stays on the matrix's device. Under ``SCC_OBS_NUMERIC`` the
common and tagwise dispersions and the exact test's log p pass the
numeric sentinels (``obs.quality``), as in the reference.

Graph passports (``obs.graphs``, ``SCC_GRAPHS``) under the reference's
names (:292-298): ``_sub_table_sorted_chunk`` is
``edger.sub_table_sorted_chunk``, ``_table_chunk`` is
``edger.table_chunk``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from scconsensus_tpu_torch.de.engine import _cid_from_groups, _next_pow2
from scconsensus_tpu_torch.obs import quality as obs_quality
from scconsensus_tpu_torch.obs import residency
from scconsensus_tpu_torch.obs.cost import attach_cost
from scconsensus_tpu_torch.obs.graphs import instrument as _passport
from scconsensus_tpu_torch.io.sparsemat import (
    DeviceCSR,
    column_sums,
    columns_dense,
    row_chunks,
)
from scconsensus_tpu_torch.ops.negbin import (
    TAGWISE_GRID_EXPONENTS,
    common_dispersion_grid,
    delta_grid,
    lgamma_shift,
    nb_exact_test_logp,
    nb_exact_test_logp_normal,
    q2q_gamma_raw,
    q2q_nbinom,
    q2q_normal,
    q2q_normal_raw,
    tagwise_dispersion,
)
from scconsensus_tpu_torch.utils.timing import StageClock

__all__ = ["run_edger_pairs", "EdgerPairResult"]

_PILOT_DISPERSION = 0.01
_ROWSUM_FILTER = 5.0
_PRIOR_DF = 10.0
_LOGFC_PRIOR_COUNT = 0.125
_EXACT_SMAX = 4096
_SUB_CELLS = 64          # dispersion-estimation cells per cluster
_NODE_COUNT = 24         # log-r conditional-likelihood node table size
_DELTA_GRID = 24         # qCML common-dispersion δ grid
_CHUNK_ELEMS = 32_000_000  # budget for (genes, cells[, nodes]) sweeps
_EXACT_TASK_ELEMS = 64_000_000  # budget for the (tasks, s_max) tail tensor
_PAIR_CHUNK = 64         # pairs per grid / tagwise assembly


@dataclasses.dataclass
class EdgerPairResult:
    """Per-pair NB results, all tensors on the matrix's device."""

    log_p: torch.Tensor         # (P, G)
    log_fc: torch.Tensor        # (P, G) natural-log fold change, 1 vs 2
    common_disp: torch.Tensor   # (P,)
    tagwise_disp: torch.Tensor  # (P, G)


def _onehot(cid: torch.Tensor, k: int) -> torch.Tensor:
    """(N, K) float32 membership; cells with cid < 0 get a zero row."""
    return (cid[:, None] == torch.arange(k, device=cid.device)[None, :]
            ).to(torch.float32)


# --------------------------------------------------------------------------
# device stages
# --------------------------------------------------------------------------

def _raw_sums_chunk(chunk: torch.Tensor, onehot: torch.Tensor
                    ) -> torch.Tensor:
    """(Gc, N) @ (N, K) raw cluster sums."""
    return chunk @ onehot


def _pseudo_sums_chunk(chunk, onehot, lib, cid_safe, kept, rates,
                       common_lib: float, phi: float) -> torch.Tensor:
    """Normal-map equalization of one gene chunk (Gc, N) to the common
    library size, summed per cluster. rates (Gc, K); cid_safe (N,) with
    excluded cells at 0 and ``kept`` (N,) masking them out."""
    lam = torch.clamp(rates[:, cid_safe], min=1e-10)         # (Gc, N)
    pseudo = q2q_normal(chunk, lam * lib, lam * common_lib, phi)
    return torch.where(kept, pseudo, 0.0) @ onehot


def _sub_pseudo_chunk(sub_chunk, lib_sub, cid_sub, rates, common_lib: float,
                      phi: float) -> torch.Tensor:
    """The full (normal + gamma average) quantile map of the subsample
    columns, every entry: the plain form the compacted table is held
    against."""
    lam = torch.clamp(rates[:, cid_sub], min=1e-10)
    return q2q_nbinom(sub_chunk, lam * lib_sub, lam * common_lib, phi)


def _table_chunk(psub: torch.Tensor, sub_onehot: torch.Tensor,
                 r_nodes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Conditional-LL node table of one gene chunk: psub (Gc, Ns), r_nodes
    (R,). Returns (table (Gc, K, R), zs (Gc, K)) with
    table[g, k, m] = Σ_{n∈k} lgamma_shift(psub[g, n], r_m)."""
    lg = lgamma_shift(psub[..., None], r_nodes)
    table = torch.einsum("gnr,nk->gkr", lg, sub_onehot)
    return table, psub @ sub_onehot


def _sub_table_sorted_chunk(sc, lib_sub, cid_sub, rates_chunk,
                            common_lib: float, phi: float, r_nodes,
                            window: int, sub_onehot
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero-compacted q2q map + node table for one gene block (Gb, Ns).

    The gamma half of the quantile map costs four ``gammainc`` an entry
    and maps a zero count to exactly 0. So each row's ``window`` largest
    entries (every positive lands there: ``window`` ≥ the block's largest
    subsample nnz) are picked by ``topk``, the gamma half runs on them
    alone and scatters back into zeros, and the cheap normal half runs
    full width. The reference sorts each row and sums in sorted order
    against a per-row one-hot; scattering back to column order lets the
    table use the shared (Ns, K) one-hot of ``_table_chunk``. Same
    values as ``_sub_pseudo_chunk`` + ``_table_chunk``."""
    lam = torch.clamp(rates_chunk[:, cid_sub], min=1e-10)    # (Gb, Ns)
    mu_in = lam * lib_sub
    mu_out = lam * common_lib
    qn = q2q_normal_raw(sc, mu_in, mu_out, phi)
    qg = torch.zeros_like(qn)
    if window > 0:
        x, win = torch.topk(sc, window, dim=1)
        qg.scatter_(1, win, q2q_gamma_raw(
            x, mu_in.gather(1, win), mu_out.gather(1, win), phi))
    psub = torch.clamp(0.5 * (qn + qg), min=0.0)
    return _table_chunk(psub, sub_onehot, r_nodes)


_sub_table_sorted_chunk = _passport("edger.sub_table_sorted_chunk",
                                    _sub_table_sorted_chunk)
_table_chunk = _passport("edger.table_chunk", _table_chunk)


def _pair_zterm(zs_i, zs_j, ns_i, ns_j, r) -> torch.Tensor:
    """lgamma_shift of each pair's two subsample group sums: (G, Pc, D)
    from zs (G, Pc), ns (Pc,) and r (1 or Pc, D)."""
    return (lgamma_shift(zs_i[..., None], ns_i[None, :, None] * r[None])
            + lgamma_shift(zs_j[..., None], ns_j[None, :, None] * r[None]))


def _cl_grid_pairs(table_i, table_j, w_grid, zs_i, zs_j, ns_i, ns_j, keep,
                   r_grid) -> torch.Tensor:
    """Keep-masked conditional LL summed over genes at each δ grid point.

    table_i/j (G, Pc, R) node values of each pair's two clusters; w_grid
    (D, R) interpolation weights; zs (G, Pc); ns (Pc,); keep (G, Pc);
    r_grid (D,). Returns (Pc, D)."""
    m = torch.einsum("gpr,dr->gpd", table_i + table_j, w_grid)
    cl = m - _pair_zterm(zs_i, zs_j, ns_i, ns_j, r_grid[None, :])
    return torch.where(keep[..., None], cl, 0.0).sum(dim=0)


def _tagwise_pairs(table_i, table_j, w_tag, zs_i, zs_j, ns_i, ns_j, keep,
                   r_tag, common, prior_n) -> torch.Tensor:
    """Per-gene tagwise dispersions of a pair chunk: w_tag (Pc, T, R);
    r_tag (Pc, T); common, prior_n (Pc,). Returns (Pc, G)."""
    m = torch.einsum("gpr,ptr->gpt", table_i + table_j, w_tag)
    ll = (m - _pair_zterm(zs_i, zs_j, ns_i, ns_j, r_tag)).movedim(0, 1)
    return tagwise_dispersion(ll, common, prior_n, keep.T)


# --------------------------------------------------------------------------
# host-side helpers
# --------------------------------------------------------------------------

def _lagrange_weights(x: np.ndarray, n_nodes: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """4-point Lagrange weights on a uniform node grid: x in node units.
    Returns (base index (…) int, weights (…, 4)); queries outside the
    grid clamp to the boundary stencils."""
    i = np.clip(np.floor(x).astype(np.int64), 1, n_nodes - 3)
    f = np.clip(x - i, -1.0, 2.0)
    w = np.stack([
        -f * (f - 1.0) * (f - 2.0) / 6.0,
        (f + 1.0) * (f - 1.0) * (f - 2.0) / 2.0,
        -(f + 1.0) * f * (f - 2.0) / 2.0,
        (f + 1.0) * f * (f - 1.0) / 6.0,
    ], axis=-1)
    return i, w


def _node_grid() -> Tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """The qCML δ grid (D,), its r = 1/φ values (D,), the log-r nodes of
    the conditional-likelihood table (R,) and their spacing h, all float32
    host arrays. The nodes span the δ grid and the tagwise band (2^±6)
    around any grid value, with half a unit of margin."""
    deltas = delta_grid(_DELTA_GRID)
    r_grid = (1.0 - deltas) / deltas
    rho_lo = float(np.log(r_grid.min())) - 6.0 * np.log(2.0) - 0.5
    rho_hi = float(np.log(r_grid.max())) + 6.0 * np.log(2.0) + 0.5
    rho_nodes = np.linspace(rho_lo, rho_hi, _NODE_COUNT).astype(np.float32)
    return deltas, r_grid, rho_nodes, float(rho_nodes[1] - rho_nodes[0])


def _dense_weights(rho: np.ndarray, rho0: float, h: float,
                   n_nodes: int) -> np.ndarray:
    """Dense (…, R) interpolation-weight rows for query points rho: the 4
    Lagrange weights scattered at their node stencil (applied on the
    device as a plain product)."""
    i, w4 = _lagrange_weights((rho - rho0) / h, n_nodes)
    out = np.zeros(rho.shape + (n_nodes,), np.float32)
    idx = np.indices(rho.shape)
    for q in range(4):
        out[(*idx, i - 1 + q)] += w4[..., q]
    return out


# --------------------------------------------------------------------------
# entry point
# --------------------------------------------------------------------------

def run_edger_pairs(
    counts,
    cell_idx_of: List[np.ndarray],
    pair_i: np.ndarray,
    pair_j: np.ndarray,
    n_genes: int,
    seed: int = 0,
    clock: Optional[StageClock] = None,
) -> EdgerPairResult:
    """Run the NB pipeline for every cluster pair.

    counts: (G, N) matrix handed to DGEList (the log-normalized matrix in
    compat mode, the reference's literal behaviour, or expm1 of it), a
    float32 tensor or a ``DeviceCSR``; every stage runs on its device.
    cell_idx_of: per-cluster cell indices (after subsampling);
    pair_i/pair_j: (P,) cluster indices.
    ``seed`` draws the dispersion subsample."""
    dev = counts.device
    clock = clock or StageClock(dev)
    G, N = n_genes, counts.shape[1]
    K = len(cell_idx_of)
    P = int(pair_i.shape[0])

    def _t(a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype, device=dev)

    with clock.detail("edger_setup"):
        cid = _cid_from_groups(cell_idx_of, N)
        kept = cid >= 0
        lib = column_sums(counts)
        # the NB driver's host reads of its statistics (library sizes,
        # subsample nnz, common dispersions, the exact tails' largest
        # total) are declared with the DE result's fetch
        with residency.boundary("de_result_fetch"):
            lib_all = lib.cpu().numpy()
        libsum_c = np.array([lib_all[ci].sum() for ci in cell_idx_of],
                            np.float32)
        n_of = np.array([ci.size for ci in cell_idx_of], np.float32)
        with np.errstate(divide="ignore"):
            loglib = np.log(np.maximum(lib_all[kept], 1e-30))
        common_lib = float(np.exp(loglib.mean())) if kept.any() else 1.0

        rng = np.random.default_rng(seed)
        sub_idx_of = [
            rng.choice(ci, size=_SUB_CELLS, replace=False)
            if ci.size > _SUB_CELLS else ci
            for ci in cell_idx_of
        ]
        sub_cells = _t(np.concatenate(sub_idx_of).astype(np.int64))
        ns_of = np.array([s.size for s in sub_idx_of], np.float32)
        cid_sub = _t(np.concatenate(
            [np.full(s.size, k, np.int64) for k, s in enumerate(sub_idx_of)]))
        t_cid = _t(cid, torch.int64)
        onehot = _onehot(t_cid, K)
        sub_onehot = _onehot(cid_sub, K)
        cid_safe = torch.clamp(t_cid, min=0)
        t_kept = _t(kept)
        lib_sub = lib[sub_cells]
        sub_counts = columns_dense(counts, sub_cells)        # (G, Ns)
        Ns = int(sub_cells.numel())
        # genes in ascending subsample nnz: each table block's gamma window
        # (the gammainc part) hugs its own largest positive count
        with residency.boundary("de_result_fetch"):
            sub_nnz = (sub_counts > 0).sum(dim=1).cpu().numpy()
        sub_order = np.argsort(sub_nnz, kind="stable")

        deltas, r_grid, rho_nodes, h = _node_grid()
        r_nodes = _t(np.exp(rho_nodes))
        t_pi = _t(pair_i, torch.int64)
        t_pj = _t(pair_j, torch.int64)
        t_ns = _t(ns_of)

    gc = max(1, _CHUNK_ELEMS // max(N, 1))
    with clock.detail("edger_pass_a"):
        if isinstance(counts, DeviceCSR):
            Zy = torch.cat([_raw_sums_chunk(c, onehot)
                            for _, _, c in row_chunks(counts, gc)])
        else:
            Zy = _raw_sums_chunk(counts, onehot)             # (G, K)
        rates = Zy / torch.clamp(_t(libsum_c), min=1e-30)    # Poisson MLE

    def _build_table(phi: float) -> Tuple[torch.Tensor, torch.Tensor]:
        """(G, K, R) node table and (G, K) subsample pseudo sums at phi."""
        table = torch.empty((G, K, _NODE_COUNT), device=dev)
        zs = torch.empty((G, K), device=dev)
        # the (block, Ns, R) lgamma node tensor dominates memory
        sgc = max(1, _CHUNK_ELEMS // max(Ns * _NODE_COUNT, 1))
        for b0 in range(0, G, sgc):
            ids = sub_order[b0:b0 + sgc]
            tid = _t(ids.astype(np.int64))
            kargs = (sub_counts[tid], lib_sub, cid_sub, rates[tid],
                     common_lib, phi, r_nodes, int(sub_nnz[ids[-1]]),
                     sub_onehot)
            # the NB node-table build is the driver's hot kernel: priced
            # on the ambient (edger_*) span when SCC_OBS_COST is on
            attach_cost(None, _sub_table_sorted_chunk, *kargs)
            table[tid], zs[tid] = _sub_table_sorted_chunk(*kargs)
        return table, zs

    with clock.detail("edger_pilot_table"):
        table0, zs0 = _build_table(_PILOT_DISPERSION)

    def _pairs(p0: int):
        return t_pi[p0:p0 + _PAIR_CHUNK], t_pj[p0:p0 + _PAIR_CHUNK]

    with clock.detail("edger_common_grid"):
        w_grid = _t(_dense_weights(np.log(r_grid).astype(np.float32),
                                   rho_nodes[0], h, _NODE_COUNT))
        t_r_grid = _t(r_grid.astype(np.float32))
        parts = []
        for p0 in range(0, P, _PAIR_CHUNK):
            pi, pj = _pairs(p0)
            keep = (Zy[:, pi] + Zy[:, pj]) > _ROWSUM_FILTER
            kargs = (table0[:, pi], table0[:, pj], w_grid, zs0[:, pi],
                     zs0[:, pj], t_ns[pi], t_ns[pj], keep, t_r_grid)
            attach_cost(None, _cl_grid_pairs, *kargs)
            cl = _cl_grid_pairs(*kargs)
            parts.append(common_dispersion_grid(cl, deltas))
        t_common = torch.cat(parts)
        with residency.boundary("de_result_fetch"):
            common = t_common.cpu().numpy()
    del table0, zs0
    if obs_quality.enabled():
        # a NaN/Inf dispersion here poisons every tagwise grid and exact
        # test downstream
        obs_quality.check_array("common_dispersion", common,
                                where="edger_nb")

    # re-equalize at the median common dispersion
    phi_req = float(np.median(common))
    with clock.detail("edger_table1"):
        table1, zs1 = _build_table(phi_req)

    with clock.detail("edger_z1_sweep"):
        Z1 = torch.empty((G, K), device=dev)
        for g0, g1, chunk in row_chunks(counts, gc):
            Z1[g0:g1] = _pseudo_sums_chunk(
                chunk, onehot, lib, cid_safe, t_kept, rates[g0:g1],
                common_lib, phi_req)

    with clock.detail("edger_tagwise"):
        prior_n = (_PRIOR_DF / np.maximum(
            ns_of[pair_i] + ns_of[pair_j] - 2.0, 1.0)).astype(np.float32)
        parts = []
        for p0 in range(0, P, _PAIR_CHUNK):
            pi, pj = _pairs(p0)
            phi_t = common[p0:p0 + _PAIR_CHUNK, None] * np.exp2(
                TAGWISE_GRID_EXPONENTS)[None, :]                # (Pc, T)
            w_tag = _t(_dense_weights((-np.log(phi_t)).astype(np.float32),
                                      rho_nodes[0], h, _NODE_COUNT))
            keep = (Zy[:, pi] + Zy[:, pj]) > _ROWSUM_FILTER
            parts.append(_tagwise_pairs(
                table1[:, pi], table1[:, pj], w_tag, zs1[:, pi], zs1[:, pj],
                t_ns[pi], t_ns[pj], keep,
                _t((1.0 / phi_t).astype(np.float32)),
                t_common[p0:p0 + _PAIR_CHUNK],
                _t(prior_n[p0:p0 + _PAIR_CHUNK])))
        tagwise = torch.cat(parts)                           # (P, G)
    del table1, zs1
    if obs_quality.enabled():
        obs_quality.check_array("tagwise_dispersion", tagwise,
                                where="edger_nb")

    with clock.detail("edger_exact_normal"):
        t_n_of = _t(n_of)
        n1, n2 = t_n_of[t_pi], t_n_of[t_pj]
        s1 = Z1[:, t_pi].T.contiguous()                      # (P, G)
        s2 = Z1[:, t_pj].T.contiguous()
        log_p = nb_exact_test_logp_normal(s1, s2, n1[:, None], n2[:, None],
                                          tagwise)
        # logFC from the equalized abundances
        log_fc = (
            torch.log(s1 / torch.clamp(n1, min=1.0)[:, None]
                      + _LOGFC_PRIOR_COUNT)
            - torch.log(s2 / torch.clamp(n2, min=1.0)[:, None]
                        + _LOGFC_PRIOR_COUNT)
        )

    # the exact tails for small totals, bucketed by each entry's own total
    # on a pow-2 ladder up to s_max: an entry pays at most twice its
    # support width. Routing depends only on the total.
    with clock.detail("edger_exact_small"):
        tot = (torch.round(s1) + torch.round(s2)).reshape(-1)
        with residency.boundary("de_result_fetch"):
            max_total = float(tot.max())
        s_max = int(min(_EXACT_SMAX,
                        _next_pow2(max(int(max_total) + 2, 64))))
        buckets, sb = [], 64
        while sb < s_max:
            buckets.append(sb)
            sb *= 2
        buckets.append(s_max)
        flat_lp = log_p.view(-1)
        s1f, s2f, twf = s1.view(-1), s2.view(-1), tagwise.view(-1)
        lower = 0.5  # a zero total is a point mass: the normal branch's p=1
        for sb in buckets:
            flat = torch.nonzero((tot >= lower) & (tot < float(sb))
                                 ).squeeze(1)
            lower = float(sb)
            tb = max(1024, _EXACT_TASK_ELEMS // sb)
            for t0 in range(0, int(flat.numel()), tb):
                f = flat[t0:t0 + tb]
                rows = f // G
                flat_lp[f] = nb_exact_test_logp(
                    s1f[f], s2f[f], n1[rows], n2[rows], twf[f], s_max=sb)

    if obs_quality.enabled():
        obs_quality.check_array("exact_test_log_p", log_p, kinds=("nan",),
                                where="edger_nb")
    return EdgerPairResult(log_p=log_p, log_fc=log_fc,
                           common_disp=t_common, tagwise_disp=tagwise)
