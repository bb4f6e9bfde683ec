"""Format loaders: MatrixMarket, scipy .npz, and a minimal AnnData .h5ad
reader (h5py-based, no anndata dependency). All return CSR genes × cells
float32 plus names, matching the pipeline's (G, N) input contract
(R/reclusterDEConsensus.R:5 — "log-transformed, normalised" genes × cells).

A copy of ``scconsensus_tpu/io/loaders.py`` (numpy and scipy only); the
tests hold the two equal on the same files. The CSR they return goes to
any entry point as it is.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Sequence

import numpy as np

import scipy.io as _sio
import scipy.sparse as _sp

__all__ = ["ExpressionData", "load_mtx", "load_npz", "load_h5ad", "log_normalize"]


class ExpressionData(NamedTuple):
    """CSR genes × cells matrix with row/column names."""

    matrix: "_sp.csr_matrix"
    gene_names: Optional[np.ndarray] = None
    cell_names: Optional[np.ndarray] = None


def _read_lines(path: Optional[str]) -> Optional[np.ndarray]:
    if path is None or not os.path.exists(path):
        return None
    with open(path) as f:
        first = [line.rstrip("\n").split("\t")[0] for line in f if line.strip()]
    return np.asarray(first)


def load_mtx(
    mtx_path: str,
    genes_path: Optional[str] = None,
    barcodes_path: Optional[str] = None,
    genes_as_rows: bool = True,
) -> ExpressionData:
    """MatrixMarket triplet (10x-style: genes.tsv / barcodes.tsv alongside)."""
    m = _sio.mmread(mtx_path)
    if not genes_as_rows:
        m = m.T
    return ExpressionData(
        matrix=_sp.csr_matrix(m, dtype=np.float32),
        gene_names=_read_lines(genes_path),
        cell_names=_read_lines(barcodes_path),
    )


def load_npz(path: str) -> ExpressionData:
    """scipy.sparse.save_npz archive (genes × cells)."""
    return ExpressionData(matrix=_sp.load_npz(path).tocsr().astype(np.float32))


def load_h5ad(path: str) -> ExpressionData:
    """Minimal AnnData .h5ad reader via h5py: X (sparse CSR/CSC groups or
    dense dataset), var index as gene names, obs index as cell names.

    AnnData stores X as cells × genes; transposed here to genes × cells.
    """
    try:
        import h5py
    except ImportError as e:  # pragma: no cover
        raise NotImplementedError(
            "load_h5ad requires h5py, which is not installed"
        ) from e

    with h5py.File(path, "r") as f:
        x = f["X"]
        if isinstance(x, h5py.Group):
            data = np.asarray(x["data"])
            indices = np.asarray(x["indices"])
            indptr = np.asarray(x["indptr"])
            enc = x.attrs.get("encoding-type")
            if isinstance(enc, bytes):
                enc = enc.decode()
            shape = tuple(int(v) for v in x.attrs["shape"])
            if enc is None:
                # Older h5ad files may omit encoding-type; infer the layout
                # from the indptr length (CSR: shape[0]+1, CSC: shape[1]+1)
                # rather than guessing — a wrong guess can yield a
                # shape-valid but scrambled matrix.
                csr_len, csc_len = shape[0] + 1, shape[1] + 1
                if indptr.size == csr_len and indptr.size != csc_len:
                    enc = "csr_matrix"
                elif indptr.size == csc_len and indptr.size != csr_len:
                    enc = "csc_matrix"
                elif indptr.size == csr_len:  # square: either is consistent
                    import warnings

                    warnings.warn(
                        f"X is square ({shape}) with no encoding-type attr; "
                        "CSR and CSC are indistinguishable from indptr — "
                        "assuming CSR. If the file is CSC the result is the "
                        "transpose.",
                        stacklevel=2,
                    )
                    enc = "csr_matrix"
                else:
                    raise ValueError(
                        f"cannot infer sparse layout of X: indptr length "
                        f"{indptr.size} matches neither CSR ({csr_len}) nor "
                        f"CSC ({csc_len}) for shape {shape}"
                    )
            cls = _sp.csr_matrix if "csr" in enc else _sp.csc_matrix
            mat = cls((data, indices, indptr), shape=shape)
        else:
            mat = _sp.csr_matrix(np.asarray(x))

        def index_of(group_name: str) -> Optional[np.ndarray]:
            if group_name not in f:
                return None
            g = f[group_name]
            key = g.attrs.get("_index", "index" if "index" in g else None)
            if isinstance(key, bytes):
                key = key.decode()
            if key is None or key not in g:
                return None
            vals = np.asarray(g[key])
            if vals.dtype.kind in ("S", "O"):
                vals = vals.astype(str)
            return vals

        cells = index_of("obs")
        genes = index_of("var")
    return ExpressionData(
        matrix=mat.T.tocsr().astype(np.float32),
        gene_names=genes,
        cell_names=cells,
    )


def log_normalize(
    counts, scale: float = 10_000.0
):
    """log1p(counts / libsize · scale): the standard normalization producing
    the "log-transformed, normalised" matrix the reference expects as input
    (README workflow; sparse-preserving — zero entries stay zero)."""
    if _sp.issparse(counts):
        c = counts.tocsc(copy=True).astype(np.float32)
        lib = np.asarray(c.sum(axis=0)).ravel()
        lib = np.maximum(lib, 1.0)
        scale_per_cell = (scale / lib).astype(np.float32)
        # scale each column's stored values, then log1p them
        c.data *= np.repeat(scale_per_cell, np.diff(c.indptr))
        c.data = np.log1p(c.data)
        return c.tocsr()
    counts = np.asarray(counts, np.float32)
    lib = np.maximum(counts.sum(axis=0, keepdims=True), 1.0)
    return np.log1p(counts / lib * scale)
