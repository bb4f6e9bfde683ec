"""The DE-gene union and the PCA embedding of the cells over it.

``union``: every pair's top ``n_top`` DE genes by |log_fc| (among the
pair's DE calls), unioned and sorted (R/reclusterDEConsensus.R:209-227).

``embedding``: the cells (N, |union|), centred per gene, projected on
their top ``n_pcs`` principal directions by randomized subspace
iteration, the method that stands in for ``irlba::prcomp_irlba``: a
Gaussian (|union|, n_pcs + 10) start drawn from torch's CPU generator
seeded with 0 in float32, four power iterations with QR, and the SVD of
the projected (k, |union|) block. Scores are defined up to an orthogonal
transform of the components (signs, and rotations within equal singular
values), which Ward and silhouettes do not see; ``procrustes_gap``
compares two embeddings up to that transform.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["union", "embedding", "procrustes_gap"]

OVERSAMPLE = 10
POWER_ITERS = 4
OMEGA_SEED = 0


def union(de_mask: np.ndarray, log_fc: np.ndarray, n_top: int = 30
          ) -> np.ndarray:
    score = np.where(de_mask, np.abs(log_fc.astype(np.float64)), -np.inf)
    k = min(n_top, score.shape[1])
    top = np.argpartition(-score, k - 1, axis=1)[:, :k]
    hit = np.isfinite(np.take_along_axis(score, top, axis=1))
    return np.unique(top[hit]).astype(np.int64)


def embedding(data: torch.Tensor, genes: np.ndarray, n_pcs: int = 15,
              dtype=torch.float64) -> np.ndarray:
    cells = data[torch.as_tensor(genes, device=data.device)].T.to(dtype)
    n, f = cells.shape
    n_pcs = min(n_pcs, f)
    k = min(n_pcs + OVERSAMPLE, f, n)
    xc = cells - cells.mean(dim=0)[None, :]
    del cells
    gen = torch.Generator().manual_seed(OMEGA_SEED)
    omega = torch.randn((f, k), generator=gen, dtype=torch.float32)
    q, _ = torch.linalg.qr(xc @ omega.to(device=xc.device, dtype=dtype))
    for _ in range(POWER_ITERS):
        w, _ = torch.linalg.qr(xc.T @ q)
        q, _ = torch.linalg.qr(xc @ w)
    _, _, vt = torch.linalg.svd(q.T @ xc, full_matrices=False)
    return (xc @ vt[:n_pcs].T).cpu().numpy()


def procrustes_gap(candidate: np.ndarray, reference: np.ndarray) -> float:
    """‖C·R − E‖_F / ‖E‖_F for the orthogonal R that fits C to E best."""
    c = np.asarray(candidate, np.float64)
    e = np.asarray(reference, np.float64)
    if c.shape != e.shape:
        return float("inf")
    u, _, vt = np.linalg.svd(c.T @ e)
    return float(np.linalg.norm(c @ (u @ vt) - e) / np.linalg.norm(e))
