"""End-to-end refinement: ``refine()`` and the two entry points.

The torch form of the dense, mesh-free branches of
``scconsensus_tpu/models/pipeline.py`` (``ReclusterResult`` :44-59,
``_refine_impl`` :342-717, ``recluster_de_consensus`` :797-833,
``recluster_de_consensus_fast`` :836-871).

Stages, each timed into ``result.metrics["stage_walls_s"]`` (on the card
every boundary synchronizes): de (cluster filter, aggregates, gates, the
Wilcoxon ladder or the edgeR sub-stages ``edger_*``, BH, call) → union →
embed (rSVD PCA on the device, of the DE-gene rows, or with
``distance="pearson"`` of the centred unit-norm cell vectors) → tree →
cuts (dynamic tree cut per deepSplit, host) → silhouette → nodg.

At or below ``approx_threshold`` cells the tree is exact Ward.D2 (native
NN-chain on the host) and the silhouette takes all cuts in one pass of
the CUDA distance × cluster-sum kernel. Above it (``approx``):

* ``approx_method="pool"`` and N ≤ the landmark threshold (200,000 by
  default): full-data Lloyd onto ``n_pool_centroids`` on the device, Ward
  on the centroids weighted by occupancy, cuts on the centroids with the
  size floor scaled by the average occupancy;
* ``approx_method="pool"`` above the landmark threshold: landmarks fitted
  on a sketch, one nearest-landmark pass, Ward on the landmarks, cuts with
  occupancy weights (and with ``landmark_verify`` the exact tree's cuts
  too, scored by ARI);
* ``approx_method="knn"``: kNN graph of the cells on the device, Ward
  agglomeration restricted to it on the host;

and the silhouette is the pooled O(N·m) estimator on the device, reusing
the tree stage's pool where there is one.

``result.metrics`` keys: ``device``, ``stage_walls_s``, ``union_size``,
``per_pair_de_counts``, ``tree_engine`` (engine of the tree stage's last
Ward.D2 call, or None), ``n_genes``, ``n_cells``, ``tree`` (``approx``,
``landmark``, ``landmark_k``), ``landmark`` (None, or ``branch``, ``k``,
``sketch``, ``threshold``, ``linkage``, ``occupancy`` per cut and, with
``landmark_verify``, ``ari_vs_exact`` per cut) and ``silhouette`` (None
without silhouettes, else ``method``: "exact" or "pooled-estimator", and
for the estimator ``n_centroids`` and ``pool_reused``).

Not ported yet, and raising ``NotImplementedError``: sparse input, a
mesh, the methods bimod, roc and t, and the DE heatmap (``plot_name``).
The artifact store, retry, integrity, observability and report wrappers
are left out.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from scconsensus_tpu_torch.config import CompatFlags, ReclusterConfig
from scconsensus_tpu_torch.de.engine import (
    PairwiseDEResult,
    as_device_matrix,
    de_gene_union,
    pairwise_de,
)
from scconsensus_tpu_torch.device import resolve_device
from scconsensus_tpu_torch.io.sparsemat import nodg as count_detected
from scconsensus_tpu_torch.io.sparsemat import rows_dense
from scconsensus_tpu_torch.obs.regress import adjusted_rand_index
from scconsensus_tpu_torch.ops import linkage
from scconsensus_tpu_torch.ops.colors import labels_to_colors
from scconsensus_tpu_torch.ops.knn_linkage import knn_ward_linkage
from scconsensus_tpu_torch.ops.linkage import HClustTree, ward_linkage
from scconsensus_tpu_torch.ops.pca import pca_scores
from scconsensus_tpu_torch.ops.pooling import (
    landmark_ward_linkage,
    pooled_ward_linkage,
)
from scconsensus_tpu_torch.ops.silhouette import (
    multi_cut_silhouette,
    pooled_multi_cut_silhouette,
)
from scconsensus_tpu_torch.ops.treecut import cutree_hybrid
from scconsensus_tpu_torch.utils.timing import StageClock

__all__ = ["ReclusterResult", "refine", "recluster_de_consensus",
           "recluster_de_consensus_fast"]


@dataclasses.dataclass
class ReclusterResult:
    """Pipeline output: the reference's {deGeneUnion, cellTree,
    dynamicColors} plus what it computed and dropped (silhouette, metrics).
    """

    de_gene_union: np.ndarray          # gene names if provided, else indices
    de_gene_union_idx: np.ndarray      # always indices into the input rows
    cell_tree: HClustTree
    dynamic_colors: Dict[str, np.ndarray]   # "deepsplit: k" -> color per cell
    dynamic_labels: Dict[str, np.ndarray]   # same keys -> labels (0 = none)
    deep_split_info: List[Dict]        # per deepSplit: n_clusters, silhouette
    nodg: np.ndarray                   # number of detected genes per cell
    embedding: np.ndarray              # (N, n_pcs) PCA scores
    de: PairwiseDEResult
    metrics: Dict


def refine(
    data,
    labels: Sequence,
    config: ReclusterConfig,
    gene_names: Optional[Sequence[str]] = None,
    device=None,
    omega: Optional[torch.Tensor] = None,
    mesh=None,
) -> ReclusterResult:
    """Full DE → embed → recluster refinement.

    Args:
      data: (G, N) log-transformed, normalized genes × cells matrix, a
        numpy array or a tensor (a tensor already on ``device`` stays).
      labels: per-cell consensus cluster labels (e.g. from
        ``plot_contingency_table``).
      device: "cuda" by default; "cpu" only when asked for.
      omega: optional (F, k) random projection for the PCA embed (F = the
        DE-gene union size, k = min(n_pcs + 10, F, N)); see ``carry``.
      mesh: must be None; the multi-device path is not ported yet.

    See the module docstring for the branches past ``approx_threshold``
    and the keys of ``result.metrics``.
    """
    if mesh is not None:
        raise NotImplementedError("the multi-device (mesh) path is not "
                                  "ported yet; pass mesh=None")
    dev = resolve_device(device)
    if config.plot_name:
        raise NotImplementedError("the DE heatmap is not ported yet")
    data = as_device_matrix(data, dev)
    G, N = data.shape
    if len(labels) != N:
        raise ValueError(f"{len(labels)} labels for {N} cells")
    clock = StageClock(dev)

    with clock.stage("de"):
        de_res = pairwise_de(data, labels, config, device=dev, clock=clock)

    with clock.stage("union"):
        union = de_gene_union(de_res, config.n_top_de_genes)
    if union.size < 2:
        raise ValueError(
            f"DE gene union has {union.size} genes — nothing to re-embed. "
            "Loosen q_val_thrs/log_fc_thrs or check cluster labels."
        )

    with clock.stage("embed"):
        n_pcs = min(union.size, config.n_pcs)
        cols = rows_dense(data, union)                   # (|U|, N)
        if config.distance == "pearson":
            # centred unit-norm cells: euclidean distance between them is
            # sqrt(2·(1 − r)), monotone in the Pearson distance
            c = cols - cols.mean(dim=0, keepdim=True)
            norm = torch.linalg.norm(c, dim=0, keepdim=True)
            cols = c / torch.clamp(norm, min=1e-12)
        cells = cols.T.contiguous()                      # (N, |U|)
        scores = pca_scores(cells, n_pcs, omega=omega)   # device
        # tree and cuts are host algorithms: the (N, n_pcs) scores cross
        embedding = scores.cpu().numpy()

    with clock.stage("tree"):
        approx = N > config.approx_threshold
        if config.approx_method not in ("pool", "knn"):
            raise ValueError(
                f"approx_method must be 'pool' or 'knn', got "
                f"{config.approx_method!r}"
            )
        lm_policy = (config.landmark_policy(N)
                     if approx and config.approx_method == "pool" else None)
        pool_assign = pool_centroids = landmark_info = None
        linkage.LAST_ENGINE = None
        if approx and config.approx_method == "knn":
            tree = knn_ward_linkage(scores, k=config.knn_graph_k)
        elif lm_policy is not None:
            tree, pool_assign, pool_centroids, lm = landmark_ward_linkage(
                scores, n_landmarks=lm_policy["k"],
                sketch=lm_policy["sketch"], seed=config.random_seed,
                c=lm_policy["c"], k_min=lm_policy["k_min"],
                k_max=lm_policy["k_max"], linkage=lm_policy["linkage"],
                knn_k=lm_policy["knn_k"],
            )
            landmark_info = {"branch": "landmark", "k": lm["k_used"],
                             "sketch": lm["sketch"],
                             "threshold": lm_policy["threshold"],
                             "linkage": lm["linkage"]}
        elif approx:
            tree, pool_assign, pool_centroids = pooled_ward_linkage(
                scores, n_centroids=config.n_pool_centroids,
                seed=config.random_seed)
        else:
            tree = ward_linkage(embedding)
        tree_engine = linkage.LAST_ENGINE

    dynamic_colors: Dict[str, np.ndarray] = {}
    dynamic_labels: Dict[str, np.ndarray] = {}
    deep_split_info: List[Dict] = []
    with clock.stage("cuts"):
        cut_weights = None
        if pool_assign is None:
            cut_points, cut_min_size = embedding, config.min_cluster_size
        elif landmark_info is not None:
            # cuts on the landmarks in cell units: occupancy weights carry
            # the size floor exactly
            cut_points, cut_min_size = pool_centroids, config.min_cluster_size
            cut_weights = np.bincount(
                pool_assign, minlength=pool_centroids.shape[0]
            ).astype(np.float64)
        else:
            # cuts on the pool: the size floor scaled by the average
            # occupancy
            avg_pool = max(N / pool_centroids.shape[0], 1.0)
            cut_points = pool_centroids
            cut_min_size = max(2, int(round(config.min_cluster_size
                                            / avg_pool)))
        for dsv in config.deep_split_values:
            cut_labels = cutree_hybrid(
                tree, cut_points, deep_split=int(dsv),
                min_cluster_size=cut_min_size,
                pam_stage=config.pam_stage, weights=cut_weights,
            )
            if pool_assign is not None:
                cut_labels = cut_labels[pool_assign]
            key = f"deepsplit: {dsv}"
            dynamic_labels[key] = cut_labels
            dynamic_colors[key] = labels_to_colors(cut_labels)
            deep_split_info.append({
                "deep_split": int(dsv),
                "n_clusters": int(len(set(
                    cut_labels[cut_labels > 0].tolist()))),
            })

        if landmark_info is not None:
            # how many of the landmarks each cut uses
            landmark_info["occupancy"] = {
                f"ds{dsv}": {
                    "landmarks_assigned": int(np.unique(pool_assign[
                        dynamic_labels[f"deepsplit: {dsv}"] > 0]).size),
                    "n_landmarks": int(pool_centroids.shape[0]),
                } for dsv in config.deep_split_values
            }
            if config.landmark_verify:
                # the exact tree and cuts too, scored by ARI per deepSplit:
                # O(N²), for mid-size verification runs only
                exact_tree = ward_linkage(embedding)
                ari = {}
                for dsv in config.deep_split_values:
                    ex = cutree_hybrid(
                        exact_tree, embedding, deep_split=int(dsv),
                        min_cluster_size=config.min_cluster_size,
                        pam_stage=config.pam_stage,
                    )
                    lm_cut = dynamic_labels[f"deepsplit: {dsv}"]
                    m = (lm_cut > 0) & (ex > 0)
                    ari[f"ds{dsv}"] = (
                        round(adjusted_rand_index(lm_cut[m], ex[m]), 6)
                        if int(m.sum()) else None
                    )
                landmark_info["ari_vs_exact"] = ari

    sil_info = None
    if config.compat.return_silhouette:
        with clock.stage("silhouette"):
            labs = [
                np.where(dynamic_labels[f"deepsplit: {dsv}"] > 0,
                         dynamic_labels[f"deepsplit: {dsv}"], -1)
                for dsv in config.deep_split_values
            ]
            if approx:
                # the exact pass is O(N²): past the threshold the pooled
                # O(N·m) estimator prices neighbours at the tree stage's
                # pool when there is one
                sil_info = {
                    "method": "pooled-estimator",
                    "n_centroids": (int(pool_centroids.shape[0])
                                    if pool_centroids is not None
                                    else config.silhouette_pool_centroids),
                    "pool_reused": pool_centroids is not None,
                }
                sils = pooled_multi_cut_silhouette(
                    scores, labs,
                    n_centroids=config.silhouette_pool_centroids,
                    seed=config.random_seed, centroids=pool_centroids,
                    assign=pool_assign, sample=config.silhouette_sample,
                )
            else:
                sil_info = {"method": "exact"}
                sils = multi_cut_silhouette(scores, labs)
            for info, (si, _per) in zip(deep_split_info, sils):
                info["silhouette"] = si
                if approx:
                    info["silhouette_method"] = "pooled-estimator"

    with clock.stage("nodg"):
        nodg = count_detected(data)

    union_names = (np.asarray(gene_names)[union] if gene_names is not None
                   else union.copy())
    return ReclusterResult(
        de_gene_union=union_names,
        de_gene_union_idx=union,
        cell_tree=tree,
        dynamic_colors=dynamic_colors,
        dynamic_labels=dynamic_labels,
        deep_split_info=deep_split_info,
        nodg=nodg,
        embedding=embedding,
        de=de_res,
        metrics={
            "device": str(dev),
            "stage_walls_s": dict(clock.walls),
            "union_size": int(union.size),
            "per_pair_de_counts": de_res.de_counts().tolist(),
            "tree_engine": tree_engine,
            "n_genes": int(G),
            "n_cells": int(N),
            "tree": {"approx": bool(approx),
                     "landmark": landmark_info is not None,
                     "landmark_k": (landmark_info or {}).get("k")},
            "landmark": landmark_info,
            "silhouette": sil_info,
        },
    )


def recluster_de_consensus(
    data_matrix,
    consensus_cluster_labels: Sequence,
    method: str = "Wilcoxon",
    mean_scaling_factor: float = 5.0,
    q_val_thrs: float = 0.01,
    fc_thrs: float = 2.0,
    deep_split_values: Sequence[int] = (1, 2, 3, 4),
    min_cluster_size: int = 10,
    gene_names: Optional[Sequence[str]] = None,
    plot_name: Optional[str] = None,
    compat: Optional[CompatFlags] = None,
    device=None,
    omega: Optional[torch.Tensor] = None,
    mesh=None,
    **kw,
) -> ReclusterResult:
    """Reference-shaped slow path (R/reclusterDEConsensus.R:20-29).

    ``method``: "Wilcoxon" or "edgeR" (case as in the reference).
    ``fc_thrs`` is a ratio; the DE criterion uses its natural log.
    ``device``: "cuda" by default. ``omega``: see ``refine``."""
    m = {"wilcoxon": "wilcoxon", "edger": "edger"}.get(method.lower())
    if m is None:
        raise ValueError(
            f"Incorrect method chosen: {method!r} (Wilcoxon|edgeR)")
    config = ReclusterConfig(
        method=m,
        q_val_thrs=q_val_thrs,
        log_fc_thrs=math.log(fc_thrs),
        mean_scaling_factor=mean_scaling_factor,
        deep_split_values=tuple(int(v) for v in deep_split_values),
        min_cluster_size=min_cluster_size,
        plot_name=plot_name,
        compat=compat or CompatFlags(),
        **kw,
    )
    return refine(data_matrix, consensus_cluster_labels, config, gene_names,
                  device=device, omega=omega, mesh=mesh)


def recluster_de_consensus_fast(
    data_matrix,
    consensus_cluster_labels: Sequence,
    method: str = "wilcox",
    q_val_thrs: float = 0.1,
    log_fc_thrs: float = 0.5,
    deep_split_values: Sequence[int] = (1, 2, 3, 4),
    min_cluster_size: int = 10,
    min_per_cent: float = 20.0,
    number_top_de_genes: int = 30,
    gene_names: Optional[Sequence[str]] = None,
    plot_name: Optional[str] = None,
    compat: Optional[CompatFlags] = None,
    device=None,
    omega: Optional[torch.Tensor] = None,
    mesh=None,
    **kw,
) -> ReclusterResult:
    """Reference-shaped fast path (R/reclusterDEConsensusFast.R:22-33).

    ``method``: only ``wilcox`` is ported so far (bimod, roc, t raise). ``device``: "cuda" by
    default. ``omega``: see ``refine``."""
    config = ReclusterConfig(
        method=method.lower(),
        q_val_thrs=q_val_thrs,
        log_fc_thrs=log_fc_thrs,
        deep_split_values=tuple(int(v) for v in deep_split_values),
        min_cluster_size=min_cluster_size,
        min_pct=min_per_cent,
        n_top_de_genes=number_top_de_genes,
        plot_name=plot_name,
        compat=compat or CompatFlags(),
        **kw,
    )
    return refine(data_matrix, consensus_cluster_labels, config, gene_names,
                  device=device, omega=omega, mesh=mesh)
