from scconsensus_tpu_torch.config import CompatFlags, ReclusterConfig
from scconsensus_tpu_torch.models.pipeline import (
    ReclusterResult,
    recluster_de_consensus,
    recluster_de_consensus_fast,
    refine,
)

__all__ = [
    "CompatFlags",
    "ReclusterConfig",
    "ReclusterResult",
    "recluster_de_consensus",
    "recluster_de_consensus_fast",
    "refine",
]
