"""Scenario dataset generators (the workload zoo's data half).

The port's copy of ``scconsensus_tpu/workloads/data.py``: numpy over
``utils.synthetic`` (itself a copy of the reference's generators), so the
same arguments give the same bytes in both packages. Each generator is a
pure function of its arguments (numpy RNG seeded per call), so scenario
runs replay byte-identically — the property the kill-resume soak leans on.
The scenarios need structure the anchor data lacks: per-sample batch
confounds, a second (ADT-like) modality nested under the RNA clusters,
and an atlas/query split with a seeded drift.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = [
    "multi_sample_dataset",
    "cite_seq_dataset",
    "atlas_query_dataset",
]


def multi_sample_dataset(
    n_cells: int,
    n_genes: int,
    n_clusters: int,
    n_samples: int,
    seed: int = 7,
    batch_shift: float = 0.8,
    libsize_spread: float = 0.5,
    batch_gene_frac: float = 0.25,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """S-sample scRNA data with per-sample shift + library-size confounds.

    Cells carry a planted biological truth (the shared cluster
    structure) AND a sample id; each sample perturbs the raw counts two
    ways before normalization: a per-sample multiplicative shift on a
    random ``batch_gene_frac`` subset of genes (technical batch effect,
    magnitude ``batch_shift`` on the log scale) and a per-sample
    library-size factor (``exp(N(0, libsize_spread))``). The consensus
    layer's job on this data is to recover the truth ACROSS samples —
    scored with per-batch ARI + batch-mixing entropy (obs.quality).

    Returns ``(data (G, N) f32 log-normalized, truth (N,) int,
    batches (N,) int)``.
    """
    from scconsensus_tpu_torch.utils.synthetic import synthetic_scrna

    counts, truth, _ = synthetic_scrna(
        n_genes=n_genes, n_cells=n_cells, n_clusters=n_clusters,
        n_markers_per_cluster=min(40, n_genes // max(n_clusters, 1)),
        seed=seed, log_normalize=False,
    )
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x5A3]))
    # samples assigned independently of truth: every sample sees every
    # cluster (the integration problem, not a confounded design)
    batches = rng.integers(0, n_samples, size=n_cells)
    counts = np.asarray(counts, np.float64)
    for b in range(n_samples):
        brng = np.random.default_rng(
            np.random.SeedSequence([seed, 0x5A3, b + 1])
        )
        sel = batches == b
        if not sel.any():
            continue
        # technical gene shift: a per-sample subset of genes is scaled
        # up/down — the classic probe/chemistry batch signature
        n_hit = max(int(n_genes * batch_gene_frac), 1)
        hit = brng.choice(n_genes, size=n_hit, replace=False)
        shift = np.exp(brng.normal(0.0, batch_shift, size=n_hit))
        counts[np.ix_(hit, np.nonzero(sel)[0])] *= shift[:, None]
        # library-size confound: whole-sample depth factor
        counts[:, sel] *= float(np.exp(brng.normal(0.0, libsize_spread)))
    libsize = np.maximum(counts.sum(axis=0, keepdims=True), 1.0)
    data = np.log1p(counts / libsize * 2000.0).astype(np.float32)
    return data, truth, batches


def cite_seq_dataset(
    n_cells: int,
    n_genes: int,
    n_adt: int,
    k_coarse: int,
    k_fine: int,
    seed: int = 7,
    adt_sep: float = 3.0,
    adt_noise: float = 0.8,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Dual-modality CITE-seq-like data: RNA (fine) + ADT (coarse).

    Truth is hierarchical: ``k_coarse`` coarse lineages, each split into
    fine subclusters (``k_fine`` total, ``k_fine >= k_coarse``). The RNA
    modality carries the FINE structure (marker blocks per fine
    cluster, the usual NB generator); the ADT modality is a
    low-dimensional (``n_adt`` proteins) gaussian readout of the COARSE
    lineage only — surface proteins distinguish lineages, not
    subclusters. Clustering ADT coarsely and RNA finely yields the
    paper's supervised/unsupervised pair generalized to modalities.

    Returns ``(rna (G, N) f32 log-normalized, adt (A, N) f32,
    truth_fine (N,), truth_coarse (N,))``.
    """
    if k_fine < k_coarse:
        raise ValueError(
            f"cite_seq_dataset: k_fine={k_fine} < k_coarse={k_coarse}"
        )
    from scconsensus_tpu_torch.utils.synthetic import synthetic_scrna

    rna, truth_fine, _ = synthetic_scrna(
        n_genes=n_genes, n_cells=n_cells, n_clusters=k_fine,
        n_markers_per_cluster=min(40, n_genes // max(k_fine, 1)),
        seed=seed, log_normalize=True,
    )
    # fine -> coarse: contiguous blocks of fine clusters share a lineage
    fine_to_coarse = (np.arange(k_fine) * k_coarse) // k_fine
    truth_coarse = fine_to_coarse[truth_fine]
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xC17E]))
    proto = rng.normal(0.0, adt_sep, size=(k_coarse, n_adt))
    adt = (proto[truth_coarse]
           + rng.normal(0.0, adt_noise, size=(n_cells, n_adt)))
    # ADT counts are non-negative and roughly log-scale in real data;
    # softplus keeps the geometry while staying positive
    adt = np.log1p(np.exp(np.clip(adt, -30.0, 30.0))).astype(np.float32)
    return rna, adt.T.copy(), truth_fine, truth_coarse


def atlas_query_dataset(
    n_atlas: int,
    n_query: int,
    n_genes: int,
    n_clusters: int,
    seed: int = 7,
    center_scale: float = 4.0,
    noise: float = 0.6,
    query_drift: float = 0.15,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Atlas/query split over one planted gaussian population.

    Both splits draw from the same ``n_clusters`` centers; query cells
    additionally carry a small global drift (``query_drift`` ×
    ``noise``) so transfer is nontrivial but inside the frozen model's
    drift calibration. Atlas labels are 1-based (the serve model's
    label convention — 0 is the unassigned marker).

    Returns ``(atlas (n_atlas, G) f32, atlas_labels (n_atlas,) int
    1..K, query (n_query, G) f32, query_truth (n_query,) int 1..K)``.
    """
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xA7145]))
    centers = rng.normal(0.0, center_scale, size=(n_clusters, n_genes))

    def _draw(n: int, drift: float) -> Tuple[np.ndarray, np.ndarray]:
        lab = rng.integers(0, n_clusters, size=n)
        x = (centers[lab]
             + rng.normal(0.0, noise, size=(n, n_genes))
             + drift * noise)
        return np.asarray(x, np.float32), lab + 1

    atlas, atlas_labels = _draw(n_atlas, 0.0)
    query, query_truth = _draw(n_query, query_drift)
    return atlas, atlas_labels, query, query_truth
