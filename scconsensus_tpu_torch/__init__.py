"""scconsensus_tpu_torch — the PyTorch / CUDA port of scconsensus_tpu.

Consensus clustering and DE-based refinement for single-cell RNA-seq on an
NVIDIA Hopper card. The JAX package ``scconsensus_tpu`` is the reference;
this package imports nothing of it (nor JAX) and is held against it by the
``tests/test_torch_*.py`` parity tests.

Entry points run on ``cuda`` by default and on the CPU only when called
with ``device="cpu"``; with no card and no CPU request they raise. So far
the port covers the dense ``refine()`` end to end with the fast Wilcoxon,
slow Wilcoxon and edgeR tests, at any cell count: past
``approx_threshold`` through the pooled, landmark or kNN tree and the
pooled silhouette estimator.
"""

from scconsensus_tpu_torch.config import CompatFlags, ReclusterConfig
from scconsensus_tpu_torch.consensus.contingency import plot_contingency_table
from scconsensus_tpu_torch.models.pipeline import (
    recluster_de_consensus,
    recluster_de_consensus_fast,
    refine,
)
from scconsensus_tpu_torch.ops.knn_linkage import knn_ward_linkage
from scconsensus_tpu_torch.ops.pooling import (
    landmark_ward_linkage,
    pooled_ward_linkage,
)
from scconsensus_tpu_torch.ops.silhouette import (
    mean_cluster_silhouette,
    pooled_multi_cut_silhouette,
)

__all__ = [
    "plot_contingency_table",
    "recluster_de_consensus",
    "recluster_de_consensus_fast",
    "refine",
    "ReclusterConfig",
    "CompatFlags",
    "pooled_ward_linkage",
    "landmark_ward_linkage",
    "knn_ward_linkage",
    "mean_cluster_silhouette",
    "pooled_multi_cut_silhouette",
]
