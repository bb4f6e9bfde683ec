"""End-to-end refinement: ``refine()`` and the two entry points.

The torch form of the dense, mesh-free, ≤ ``approx_threshold`` branch of
``scconsensus_tpu/models/pipeline.py`` (``ReclusterResult`` :44-59,
``_refine_impl`` :342-717, ``recluster_de_consensus`` :797-833,
``recluster_de_consensus_fast`` :836-871).

Stages, each timed into ``result.metrics["stage_walls_s"]`` (on the card
every boundary synchronizes): de (cluster filter, aggregates, gates, the
Wilcoxon ladder or the edgeR sub-stages ``edger_*``, BH, call) → union →
embed (euclidean rSVD PCA, on the device) → tree (exact Ward.D2, native
NN-chain on the host) → cuts (dynamic tree cut per deepSplit, host) →
silhouette (the CUDA distance × cluster-sum kernel, all cuts in one
pass) → nodg.

Not ported yet, and raising ``NotImplementedError``: sparse input, more
than ``approx_threshold`` cells, a mesh, ``pearson`` distance, the
methods bimod, roc and t, and the DE heatmap (``plot_name``). The
artifact store, retry, integrity, observability and report wrappers are
left out.
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
from scconsensus_tpu_torch.ops import linkage
from scconsensus_tpu_torch.ops.colors import labels_to_colors
from scconsensus_tpu_torch.ops.linkage import HClustTree, ward_linkage
from scconsensus_tpu_torch.ops.pca import pca_scores
from scconsensus_tpu_torch.ops.silhouette import multi_cut_silhouette
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
    """
    if mesh is not None:
        raise NotImplementedError("the multi-device (mesh) path is not "
                                  "ported yet; pass mesh=None")
    dev = resolve_device(device)
    if config.distance != "euclidean":
        raise NotImplementedError(
            f"distance {config.distance!r} is not ported yet (euclidean)")
    if config.plot_name:
        raise NotImplementedError("the DE heatmap is not ported yet")
    data = as_device_matrix(data, dev)
    G, N = data.shape
    if N > config.approx_threshold:
        raise NotImplementedError(
            f"{N} cells is above approx_threshold="
            f"{config.approx_threshold}: the approximate tree and pooled "
            "silhouette paths are not ported yet"
        )
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
        cells = rows_dense(data, union).T.contiguous()   # (N, |U|)
        scores = pca_scores(cells, n_pcs, omega=omega)   # device
        # tree and cuts are host algorithms: the (N, n_pcs) scores cross
        embedding = scores.cpu().numpy()

    with clock.stage("tree"):
        tree = ward_linkage(embedding)
        tree_engine = linkage.LAST_ENGINE

    dynamic_colors: Dict[str, np.ndarray] = {}
    dynamic_labels: Dict[str, np.ndarray] = {}
    deep_split_info: List[Dict] = []
    with clock.stage("cuts"):
        for dsv in config.deep_split_values:
            cut_labels = cutree_hybrid(
                tree, embedding, deep_split=int(dsv),
                min_cluster_size=config.min_cluster_size,
                pam_stage=config.pam_stage,
            )
            key = f"deepsplit: {dsv}"
            dynamic_labels[key] = cut_labels
            dynamic_colors[key] = labels_to_colors(cut_labels)
            deep_split_info.append({
                "deep_split": int(dsv),
                "n_clusters": int(len(set(
                    cut_labels[cut_labels > 0].tolist()))),
            })

    if config.compat.return_silhouette:
        with clock.stage("silhouette"):
            labs = [
                np.where(dynamic_labels[f"deepsplit: {dsv}"] > 0,
                         dynamic_labels[f"deepsplit: {dsv}"], -1)
                for dsv in config.deep_split_values
            ]
            for info, (si, _per) in zip(
                    deep_split_info, multi_cut_silhouette(scores, labs)):
                info["silhouette"] = si

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
