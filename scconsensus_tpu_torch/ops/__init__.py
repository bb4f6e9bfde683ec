"""Batched statistical and linear-algebra ops (the port's "ops" layer).

The reference's exports (``scconsensus_tpu/ops/__init__.py``). The CUDA
kernel (``ops.cuda_kernels``) is not imported here: it builds at its
first launch, never at import.
"""

from scconsensus_tpu_torch.ops.multipletests import bh_adjust, bh_adjust_masked
from scconsensus_tpu_torch.ops.ranks import masked_midranks, rank_sum_groups
from scconsensus_tpu_torch.ops.wilcoxon import (
    wilcoxon_exact_host,
    wilcoxon_from_ranks,
)

__all__ = [
    "masked_midranks",
    "rank_sum_groups",
    "bh_adjust",
    "bh_adjust_masked",
    "wilcoxon_from_ranks",
    "wilcoxon_exact_host",
]
