"""Pipeline configuration: ``CompatFlags`` and ``ReclusterConfig``.

A mirror of ``scconsensus_tpu/config.py:503-669``: every field with the
reference's default, and ``to_json``. The reference's environment-flag
registry (and the landmark policy that reads it) is not part of the port.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

__all__ = ["CompatFlags", "ReclusterConfig"]


@dataclasses.dataclass
class CompatFlags:
    """Reference-quirk switches (SURVEY.md §2d). ``True`` reproduces the
    reference's literal arithmetic; ``False`` applies the documented fix."""

    # §2d-1: the reference edgeR path drops fold-changes; fixed mode uses
    # edgeR's logFC converted from log2 to natural log.
    edger_drop_logfc: bool = False
    # §2d-3: slow path compares mean-of-logs against log(count threshold).
    mean_gate_mixed_spaces: bool = True
    # §2d-4: BH with n = total gene count (slow) vs surviving features (fast).
    bh_reference_n: bool = True
    # §2d-6: return the per-deepSplit silhouette (reference computes & drops).
    return_silhouette: bool = True
    # The reference hands the log-normalized matrix to DGEList as counts.
    edger_log_counts: bool = True


@dataclasses.dataclass
class ReclusterConfig:
    """Configuration of the DE → embed → recluster refinement pipeline.

    Field provenance (reference defaults): slow path
    R/reclusterDEConsensus.R:20-29, fast path
    R/reclusterDEConsensusFast.R:22-33."""

    # --- DE testing ---
    method: str = "wilcox"  # wilcox | edger | bimod | roc | t
    q_val_thrs: float = 0.1
    log_fc_thrs: float = 0.5  # natural-log fold-change threshold
    mean_scaling_factor: float = 5.0  # slow-path mean-expression gate scale
    mean_exprs_thrs: float = 0.0  # fast-path gate (Seurat MeanExprsThrs)
    min_pct: float = 20.0  # fast path: min % of cells expressing
    min_diff_pct: float = -float("inf")
    min_cells_group: int = 3  # pairs with a smaller group are skipped
    pseudocount: float = 1.0
    max_cells_per_ident: Optional[int] = None  # subsample per group (seeded)
    random_seed: int = 1
    only_pos: bool = False
    n_top_de_genes: int = 30

    # --- cluster filtering ---
    min_cluster_size: int = 10  # strictly-greater filter (§2d-7)
    drop_grey: bool = True  # 'grey' = unclustered

    # --- embed + recluster ---
    n_pcs: int = 15
    distance: str = "euclidean"  # euclidean | pearson
    deep_split_values: Tuple[int, ...] = (1, 2, 3, 4)
    pam_stage: bool = False

    # --- scale-out ---
    approx_threshold: int = 100_000
    approx_method: str = "pool"  # pool | knn
    n_pool_centroids: int = 4096
    knn_graph_k: int = 15
    landmark_threshold: Optional[int] = None
    landmark_k: Optional[int] = None
    landmark_c: Optional[float] = None
    landmark_k_min: int = 512
    landmark_k_max: int = 4096
    landmark_sketch: Optional[int] = None
    landmark_linkage: str = "exact"  # exact | knn
    landmark_verify: bool = False
    silhouette_pool_centroids: int = 2048
    silhouette_sample: Optional[int] = None

    # --- misc ---
    compat: CompatFlags = dataclasses.field(default_factory=CompatFlags)
    artifact_dir: Optional[str] = None
    plot_name: Optional[str] = None

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["min_diff_pct"] = (
            None if self.min_diff_pct == -float("inf") else self.min_diff_pct
        )
        return json.dumps(d, indent=2, default=str)
