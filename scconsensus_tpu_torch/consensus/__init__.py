from scconsensus_tpu_torch.consensus.contingency import (
    ContingencyResult,
    automated_consensus,
    contingency_table,
    plot_contingency_table,
)

__all__ = [
    "contingency_table",
    "automated_consensus",
    "plot_contingency_table",
    "ContingencyResult",
]
