"""Row gathers and per-cell counts over the dense (G, N) matrix.

The dense-tensor forms of ``scconsensus_tpu/io/sparsemat.py`` ``rows_dense``
(:91), ``expm1_sparse``, ``mean_expm1`` and ``mean_value`` (:103-137) and
``nodg`` (:140). Sparse (CSR) input waits for a later slice.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["rows_dense", "expm1_sparse", "mean_expm1", "mean_value", "nodg"]


def rows_dense(x: torch.Tensor, idx) -> torch.Tensor:
    """(|idx|, N) float32 gather of gene rows, on the matrix's device."""
    idx = torch.as_tensor(np.asarray(idx, np.int64), device=x.device)
    return x.index_select(0, idx).float()


def expm1_sparse(x: torch.Tensor) -> torch.Tensor:
    """expm1 of every entry (a new matrix on ``x``'s device)."""
    return torch.expm1(x)


def mean_expm1(x: torch.Tensor) -> float:
    """mean(expm1(x)) over all entries: the slow path's global threshold
    base (R/reclusterDEConsensus.R:36)."""
    return float(torch.mean(torch.expm1(x)))


def mean_value(x: torch.Tensor) -> float:
    """Mean over all entries."""
    return float(torch.mean(x))


def nodg(x: torch.Tensor) -> np.ndarray:
    """Number of detected genes per cell: column-wise nonzero counts (the
    reference's O(N·G) loop, R/reclusterDEConsensus.R:272). The (N,)
    counts are a pipeline output and come to the host."""
    return (x > 0).sum(dim=0).cpu().numpy().astype(np.int64)
