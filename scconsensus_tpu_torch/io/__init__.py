"""Sparse-first data IO.

Matrices load as CSR (genes × cells) and stay sparse: an entry point
uploads the CSR triplet once (``sparsemat.DeviceCSR``) and only gene
chunks, row gathers and compacted rank-sum windows are densified on the
device. For a matrix that does fit the card, ``csr_to_device`` densifies
it there from the triplet.
"""

from scconsensus_tpu_torch.io.loaders import (
    ExpressionData,
    load_h5ad,
    load_mtx,
    load_npz,
    log_normalize,
)
from scconsensus_tpu_torch.io.sparsemat import (
    DeviceCSR,
    aggregates_from_sparse,
    csr_to_device,
    expm1_sparse,
    is_jax,
    is_sparse,
    mean_expm1,
    nodg,
    row_chunk_dense,
)

__all__ = [
    "ExpressionData",
    "load_mtx",
    "load_npz",
    "load_h5ad",
    "log_normalize",
    "DeviceCSR",
    "is_sparse",
    "is_jax",
    "row_chunk_dense",
    "expm1_sparse",
    "mean_expm1",
    "nodg",
    "csr_to_device",
    "aggregates_from_sparse",
]
