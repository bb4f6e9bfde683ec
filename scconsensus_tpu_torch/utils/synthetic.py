"""Synthetic scRNA-seq data generators for tests and benchmarks.

The reference validates only manually against the Zenodo 26k-PBMC dataset
(reference README.md:32-36); this environment has no network egress, so all
tests and benches run on synthetic negative-binomial data with planted cluster
structure (SURVEY.md §4 "Integration").

The numpy generators are copies of ``scconsensus_tpu/utils/synthetic.py``
(same bytes out for the same seed); ``synthetic_scrna_device`` and
``planted_embedding_device`` draw on the card with torch.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "synthetic_scrna",
    "synthetic_scrna_device",
    "planted_embedding_device",
    "planted_clusters",
    "noisy_labeling",
]


def planted_clusters(
    n_cells: int, n_clusters: int, rng: np.random.Generator, balance: float = 0.5
) -> np.ndarray:
    """Cluster assignment vector with mildly imbalanced sizes."""
    w = rng.dirichlet(np.full(n_clusters, 1.0 / max(balance, 1e-3)))
    w = 0.5 * w + 0.5 / n_clusters  # keep every cluster populated
    return rng.choice(n_clusters, size=n_cells, p=w / w.sum())


def synthetic_scrna(
    n_genes: int = 2000,
    n_cells: int = 1000,
    n_clusters: int = 4,
    n_markers_per_cluster: int = 40,
    marker_log_fc: float = 2.0,
    nb_dispersion: float = 0.5,
    depth: float = 2000.0,
    seed: int = 0,
    log_normalize: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Generate a (genes, cells) matrix with planted clusters.

    Counts are NB-distributed around a per-gene baseline; each cluster
    up-regulates its own disjoint marker block by ``marker_log_fc`` (natural
    log). When ``log_normalize``, returns log1p(counts / libsize * depth) —
    the "log-transformed and normalized" input the reference expects
    (R/reclusterDEConsensus.R:5).

    Returns (data, labels, marker_mask) where marker_mask is (n_clusters,
    n_genes) boolean.
    """
    if n_clusters * n_markers_per_cluster > n_genes:
        raise ValueError(
            f"marker blocks overflow the gene space: {n_clusters} clusters x "
            f"{n_markers_per_cluster} markers > {n_genes} genes"
        )
    rng = np.random.default_rng(seed)
    labels = planted_clusters(n_cells, n_clusters, rng)

    base = np.exp(rng.normal(loc=-1.0, scale=1.0, size=n_genes))
    log_mu = np.log(base)[:, None] * np.ones((1, n_cells))

    marker_mask = np.zeros((n_clusters, n_genes), dtype=bool)
    for k in range(n_clusters):
        lo = k * n_markers_per_cluster
        hi = min(lo + n_markers_per_cluster, n_genes)
        marker_mask[k, lo:hi] = True
        cells_k = labels == k
        log_mu[lo:hi][:, cells_k] += marker_log_fc

    mu = np.exp(log_mu)
    mu *= depth / mu.sum(axis=0, keepdims=True)
    # NB via gamma-Poisson mixture.
    shape = 1.0 / nb_dispersion
    lam = rng.gamma(shape=shape, scale=mu / shape)
    counts = rng.poisson(lam).astype(np.float64)

    if log_normalize:
        libsize = counts.sum(axis=0, keepdims=True)
        libsize = np.maximum(libsize, 1.0)
        data = np.log1p(counts / libsize * depth)
    else:
        data = counts
    return data.astype(np.float32), labels, marker_mask


def _gamma(alpha: float, shape, generator, device) -> "torch.Tensor":
    """Gamma(alpha, 1) draws from ``generator`` alone (Marsaglia & Tsang
    2000): ``torch.distributions.Gamma`` takes no generator. For alpha < 1
    the boost Gamma(alpha) = Gamma(alpha + 1) · U^(1/alpha) applies."""
    import torch

    a = alpha if alpha >= 1.0 else alpha + 1.0
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.empty(shape, dtype=torch.float32, device=device).view(-1)
    todo = torch.arange(out.numel(), device=device)
    while todo.numel():
        z = torch.randn(todo.numel(), generator=generator, device=device)
        u = torch.rand(todo.numel(), generator=generator, device=device)
        v = (1.0 + c * z) ** 3
        ok = (v > 0) & (
            torch.log(u) < 0.5 * z * z + d - d * v
            + d * torch.log(v.clamp_min(1e-30))
        )
        out[todo[ok]] = d * v[ok]
        todo = todo[~ok]
    if alpha < 1.0:
        u = torch.rand(out.numel(), generator=generator, device=device)
        out *= u ** (1.0 / alpha)
    return out.view(shape)


def synthetic_scrna_device(
    n_genes: int = 2000,
    n_cells: int = 1000,
    n_clusters: int = 4,
    n_markers_per_cluster: int = 40,
    marker_log_fc: float = 2.0,
    nb_dispersion: float = 0.5,
    depth: float = 2000.0,
    seed: int = 0,
    log_normalize: bool = True,
    device=None,
):
    """``synthetic_scrna`` twin that draws the matrix on the card.

    Same planted structure (labels, baselines and marker blocks come from
    the identical numpy procedure), but the gamma–Poisson draws happen on
    the device from an explicit ``torch.Generator`` seeded with ``seed``,
    so only the labels and per-gene parameters cross from the host; at
    26k × 15k the host generator costs minutes of numpy time. The draws
    are not the host generator's numbers. Blocks of 2048 genes bound the
    per-block temporaries. Returns (data (G, N) float32
    tensor on ``device``, labels, marker_mask), the last two numpy, shaped
    like ``synthetic_scrna``'s.
    """
    import torch

    from scconsensus_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if n_clusters * n_markers_per_cluster > n_genes:
        raise ValueError(
            f"marker blocks overflow the gene space: {n_clusters} clusters x "
            f"{n_markers_per_cluster} markers > {n_genes} genes"
        )
    rng = np.random.default_rng(seed)
    labels = planted_clusters(n_cells, n_clusters, rng)
    base = np.exp(rng.normal(loc=-1.0, scale=1.0, size=n_genes))
    marker_mask = np.zeros((n_clusters, n_genes), dtype=bool)
    for k in range(n_clusters):
        lo = k * n_markers_per_cluster
        hi = min(lo + n_markers_per_cluster, n_genes)
        marker_mask[k, lo:hi] = True

    gen = torch.Generator(device=dev).manual_seed(int(seed))
    lab = torch.as_tensor(labels, dtype=torch.int64, device=dev)
    log_base = torch.as_tensor(np.log(base), dtype=torch.float32, device=dev)
    mask = torch.as_tensor(marker_mask.T, dtype=torch.float32, device=dev)
    B = min(2048, n_genes)

    def mu_block(g0: int) -> "torch.Tensor":
        bump = marker_log_fc * mask[g0:g0 + B][:, lab]          # (B, N)
        return torch.exp(log_base[g0:g0 + B, None] + bump)

    mu_colsum = torch.zeros(n_cells, dtype=torch.float32, device=dev)
    for g0 in range(0, n_genes, B):
        mu_colsum += mu_block(g0).sum(dim=0)
    mu_scale = depth / mu_colsum.clamp_min(1e-30)
    shape = 1.0 / nb_dispersion
    counts = torch.empty((n_genes, n_cells), dtype=torch.float32,
                         device=dev)
    for g0 in range(0, n_genes, B):
        mu = mu_block(g0) * mu_scale[None, :]
        lam = _gamma(shape, tuple(mu.shape), gen, dev) * (mu / shape)
        counts[g0:g0 + B] = torch.poisson(lam, generator=gen)
    if log_normalize:
        libsize = counts.sum(dim=0).clamp_min(1.0)
        counts.mul_((depth / libsize)[None, :]).log1p_()
    return counts, labels, marker_mask


def planted_embedding_device(
    n_cells: int = 1_000_000,
    n_dims: int = 15,
    n_clusters: int = 24,
    scale: float = 6.0,
    seed: int = 3,
    device=None,
):
    """A planted-cluster embedding drawn on the card: the reference bench's
    1M-cell landmark configuration (``bench.py`` ``run_brain1m``: centres
    ~ N(0, scale²) in ``n_dims`` dimensions, uniform labels, unit noise).

    The centres and labels are the numpy draws of ``default_rng(seed)``
    in the bench's order; the noise comes from a ``torch.Generator``
    seeded with ``seed`` on the device, so it is not the host generator's.
    Returns (x (N, n_dims) float32 tensor on ``device``, labels (N,)
    numpy, the numpy generator after its draws, which the bench goes on
    using for its silhouette sample)."""
    import torch

    from scconsensus_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=scale, size=(n_clusters, n_dims))
    labels = rng.integers(0, n_clusters, n_cells)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    x = torch.as_tensor(centers, dtype=torch.float32, device=dev)[
        torch.as_tensor(labels, device=dev)]
    x += torch.randn((n_cells, n_dims), generator=gen, device=dev)
    return x, labels, rng


def noisy_labeling(
    labels: np.ndarray,
    flip_frac: float,
    n_out_clusters: Optional[int] = None,
    seed: int = 0,
    prefix: str = "c",
) -> np.ndarray:
    """Derive a degraded string labeling from ground truth: a fraction of cells
    get a random label; optionally *coarsen* to ``n_out_clusters`` (values >= the
    true cluster count are a no-op — refinement is not simulated).
    Used to simulate the supervised/unsupervised input pair for consensus tests."""
    rng = np.random.default_rng(seed)
    lab = labels.copy()
    k = labels.max() + 1
    if n_out_clusters is not None and n_out_clusters < k:
        merge_map = rng.integers(0, n_out_clusters, size=k)
        lab = merge_map[lab]
        k = n_out_clusters
    flip = rng.random(lab.shape[0]) < flip_frac
    lab[flip] = rng.integers(0, k, size=int(flip.sum()))
    return np.array([f"{prefix}{v}" for v in lab])
