"""Sparse-matrix helpers behind the never-densify contract.

The torch form of ``scconsensus_tpu/io/sparsemat.py``. Each helper takes
one of three inputs and dispatches on its type, as the reference does:

* a ``scipy.sparse`` matrix: the host copies of the reference's helpers
  (``as_csr`` :55, ``row_chunk_dense`` and ``padded_row_chunk`` :64-88,
  ``rows_dense`` :91, ``expm1_sparse``, ``mean_expm1`` and ``mean_value``
  :103-137, ``nodg`` :140, ``csr_window_rows`` :194 and
  ``aggregates_from_sparse`` :228), numpy and scipy only. They are the
  plain versions the tests hold against the reference;
* a :class:`DeviceCSR`, the CSR triplet uploaded once to the device (values
  float32 and column indices int32, nnz · 8 bytes, and the row pointer
  int64): the device forms the engine runs. Gene chunks, row gathers and
  the compacted rank-sum windows are gathered from the triplet on the
  device; no helper builds the whole dense (G, N) matrix;
* a dense (G, N) tensor: the dense forms.

``csr_to_device`` is the reference's opt-in route for a matrix that does
fit the card: the triplet crosses and is densified there. ``is_jax``
(:44) is the reference's check for a ``jax.Array``, by the value's type
and without importing JAX, so that input from the reference's device
path can be named.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np
import scipy.sparse as _sp
import torch

from scconsensus_tpu_torch.ops.gates import (
    ClusterAggregates,
    compute_aggregates_cid,
)

__all__ = [
    "DeviceCSR",
    "is_sparse",
    "is_jax",
    "as_csr",
    "row_chunk_dense",
    "padded_row_chunk",
    "row_chunks",
    "rows_dense",
    "columns_dense",
    "column_sums",
    "expm1_sparse",
    "mean_expm1",
    "mean_value",
    "nodg",
    "csr_to_device",
    "csr_window_rows",
    "aggregates_from_sparse",
    "csr_aggregates",
]

# budget for one densified (genes, cells) chunk of a DeviceCSR
CHUNK_ELEMS = 32_000_000


@dataclasses.dataclass
class DeviceCSR:
    """A (G, N) CSR matrix held as its triplet on one device.

    ``values`` (nnz,) float32, ``indices`` (nnz,) int32 column of each
    stored entry, ``indptr`` (G + 1,) int64 on the device, and
    ``host_indptr``, its host copy, which plans chunks and windows without
    a device round trip."""

    values: torch.Tensor
    indices: torch.Tensor
    indptr: torch.Tensor
    host_indptr: np.ndarray
    shape: Tuple[int, int]

    @classmethod
    def from_scipy(cls, m, device) -> "DeviceCSR":
        """Upload a scipy sparse matrix (any format; canonicalized, with
        duplicate entries summed) to ``device``."""
        m = as_csr(m)
        if not m.has_canonical_format:
            m = m.copy()  # tocsr() may alias the input: leave the caller's
            m.sum_duplicates()
        if m.shape[1] >= np.iinfo(np.int32).max:
            raise ValueError(f"{m.shape[1]} columns do not fit int32 indices")
        host_indptr = np.asarray(m.indptr, np.int64)
        return cls(
            values=torch.from_numpy(
                np.ascontiguousarray(m.data, np.float32)).to(device),
            indices=torch.from_numpy(
                np.ascontiguousarray(m.indices, np.int32)).to(device),
            indptr=torch.from_numpy(host_indptr).to(device),
            host_indptr=host_indptr,
            shape=(int(m.shape[0]), int(m.shape[1])),
        )

    @property
    def device(self) -> torch.device:
        return self.values.device

    def to(self, device) -> "DeviceCSR":
        device = torch.device(device)
        if device == self.device:
            return self
        return dataclasses.replace(
            self, values=self.values.to(device),
            indices=self.indices.to(device), indptr=self.indptr.to(device))

    def with_values(self, values: torch.Tensor) -> "DeviceCSR":
        """The same sparsity pattern holding ``values`` (nnz,)."""
        return dataclasses.replace(self, values=values)

    def stored_per_row(self) -> np.ndarray:
        """(G,) stored entries of each gene (explicit zeros included)."""
        return np.diff(self.host_indptr)

    def _entries(self, gene_ids: np.ndarray
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The stored entries of the genes ``gene_ids`` (B,), gene by gene
        in storage order: (row in the block, slot in the row, position in
        the triplet), each (Σ stored,) int64 on the device."""
        ids = np.asarray(gene_ids, np.int64)
        lens = self.host_indptr[ids + 1] - self.host_indptr[ids]
        total = int(lens.sum())
        dev = self.device
        t_lens = torch.from_numpy(lens).to(dev)
        row = torch.repeat_interleave(
            torch.arange(ids.size, device=dev), t_lens, output_size=total)
        first = torch.cumsum(t_lens, 0) - t_lens          # (B,)
        slot = torch.arange(total, device=dev) - first[row]
        start = self.indptr[torch.from_numpy(ids).to(dev)]
        return row, slot, start[row] + slot

    def gather_rows(self, gene_ids) -> torch.Tensor:
        """Dense (B, N) float32 rows of the genes ``gene_ids``."""
        ids = np.asarray(gene_ids, np.int64)
        row, _, pos = self._entries(ids)
        out = torch.zeros((ids.size, self.shape[1]), dtype=torch.float32,
                          device=self.device)
        out[row, self.indices[pos].long()] = self.values[pos]
        return out

    def window_rows(self, gene_ids, width: int, cid: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Compacted rank-sum windows on the device: (B, width) float32
        rows of each gene's stored values, and the (B, width) int64
        cluster ids ``cid[col]`` of their cells; padding slots are 0 / −1.
        The device form of ``csr_window_rows``."""
        ids = np.asarray(gene_ids, np.int64)
        lens = self.host_indptr[ids + 1] - self.host_indptr[ids]
        if lens.size and int(lens.max()) > width:
            b = int(np.argmax(lens))
            raise ValueError(f"gene {int(ids[b])} has {int(lens[b])} stored "
                             f"entries > window {width}")
        row, slot, pos = self._entries(ids)
        vals = torch.zeros((ids.size, width), dtype=torch.float32,
                           device=self.device)
        wcid = torch.full((ids.size, width), -1, dtype=torch.int64,
                          device=self.device)
        vals[row, slot] = self.values[pos]
        wcid[row, slot] = cid.to(self.device, torch.int64)[
            self.indices[pos].long()]
        return vals, wcid

    def to_dense(self) -> torch.Tensor:
        """The whole (G, N) float32 matrix on the device."""
        return self.gather_rows(np.arange(self.shape[0]))


def _chunk_rows(n_cells: int) -> int:
    return max(1, CHUNK_ELEMS // max(n_cells, 1))


def is_sparse(x) -> bool:
    return _sp.issparse(x)


def is_jax(x) -> bool:
    """True for a ``jax.Array`` (a concrete array, a PRNG key array or a
    tracer), judged by the type's module and its classes alone: JAX is
    never imported."""
    if type(x).__module__.split(".")[0] not in ("jax", "jaxlib"):
        return False
    return any(c.__module__.split(".")[0] == "jax"
               and c.__name__ in ("Array", "Tracer")
               for c in type(x).__mro__)


def as_csr(x):
    """Canonicalize any scipy-sparse format to CSR (summing duplicate COO
    entries); anything else passes through."""
    if is_sparse(x):
        return x.tocsr()
    return x


def row_chunk_dense(x, g0: int, g1: int):
    """Dense float32 rows [g0, g1): a host array for host input, a tensor
    on the matrix's device otherwise."""
    if isinstance(x, DeviceCSR):
        return x.gather_rows(np.arange(g0, min(g1, x.shape[0])))
    if isinstance(x, torch.Tensor):
        return x[g0:g1].float()
    return np.asarray(x[g0:g1].toarray(), dtype=np.float32)


def padded_row_chunk(x, g0: int, width: int):
    """Dense float32 rows [g0, g0+width), zero-padded to ``width`` rows."""
    g1 = min(g0 + width, x.shape[0])
    chunk = row_chunk_dense(x, g0, g1)
    pad = width - chunk.shape[0]
    if pad > 0:
        if isinstance(chunk, torch.Tensor):
            chunk = torch.nn.functional.pad(chunk, (0, 0, 0, pad))
        else:
            chunk = np.pad(chunk, ((0, pad), (0, 0)))
    return chunk


def row_chunks(x, gc: int) -> Iterator[Tuple[int, int, torch.Tensor]]:
    """(g0, g1, dense rows) over a device matrix, ``gc`` genes at a time:
    slices of a tensor, or gene chunks gathered from a DeviceCSR, the
    only densification of the sparse path (the counterpart of the
    reference engine's ``_gene_chunks``)."""
    G = x.shape[0]
    for g0 in range(0, G, gc):
        g1 = min(g0 + gc, G)
        yield g0, g1, (x.gather_rows(np.arange(g0, g1))
                       if isinstance(x, DeviceCSR) else x[g0:g1])


def rows_dense(x, idx):
    """(|idx|, N) float32 gather of gene rows: on the matrix's device for a
    tensor or a DeviceCSR, a host array for host input."""
    if isinstance(x, DeviceCSR):
        return x.gather_rows(idx)
    if isinstance(x, torch.Tensor):
        from scconsensus_tpu_torch.obs import residency

        with residency.boundary("input_staging"):
            idx = torch.as_tensor(np.asarray(idx, np.int64),
                                  device=x.device)
        return x.index_select(0, idx).float()
    return np.asarray(x[idx].toarray(), dtype=np.float32)


def columns_dense(x, cols: torch.Tensor) -> torch.Tensor:
    """(G, |cols|) float32 gather of cell columns of a device matrix (a
    DeviceCSR gathers gene chunk by gene chunk)."""
    if isinstance(x, DeviceCSR):
        return torch.cat([c.index_select(1, cols) for _, _, c in
                          row_chunks(x, _chunk_rows(x.shape[1]))])
    return x.index_select(1, cols)


def column_sums(x) -> torch.Tensor:
    """(N,) per-cell sums of a device matrix. A DeviceCSR adds its gene
    chunks' sums in chunk order, the same bits on every run."""
    if isinstance(x, DeviceCSR):
        out = torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
        for _, _, c in row_chunks(x, _chunk_rows(x.shape[1])):
            out += c.sum(dim=0)
        return out
    return x.sum(dim=0)


def expm1_sparse(x):
    """expm1 of the stored values only (expm1(0) = 0 keeps the sparsity);
    every entry of a dense input."""
    if isinstance(x, DeviceCSR):
        return x.with_values(torch.expm1(x.values))
    if isinstance(x, torch.Tensor):
        return torch.expm1(x)
    out = x.copy()
    out.data = np.expm1(out.data)
    return out


def mean_expm1(x) -> float:
    """mean(expm1(x)) over all G·N entries without densifying: the slow
    path's global threshold base (R/reclusterDEConsensus.R:36). A
    DeviceCSR sums its stored values in float64."""
    from scconsensus_tpu_torch.obs import residency

    # one scalar the slow path's gates read on the host
    with residency.boundary("de_result_fetch"):
        if isinstance(x, DeviceCSR):
            total = float(torch.expm1(x.values).sum(dtype=torch.float64))
            return total / float(x.shape[0] * x.shape[1])
        if isinstance(x, torch.Tensor):
            return float(torch.mean(torch.expm1(x)))
    total = float(np.expm1(x.data).sum())
    return total / float(x.shape[0] * x.shape[1])


def mean_value(x) -> float:
    """Mean over all G·N entries without densifying."""
    if isinstance(x, DeviceCSR):
        total = float(x.values.sum(dtype=torch.float64))
        return total / float(x.shape[0] * x.shape[1])
    if isinstance(x, torch.Tensor):
        return float(torch.mean(x))
    return float(x.sum()) / float(x.shape[0] * x.shape[1])


def nodg(x) -> np.ndarray:
    """Number of detected genes per cell (R/reclusterDEConsensus.R:272),
    an (N,) host array. Sparse input counts every stored nonzero,
    negatives included (the reference's ``x.astype(bool)``); dense input
    counts x > 0."""
    if isinstance(x, DeviceCSR):
        cols = x.indices[x.values != 0].long()
        return torch.bincount(cols, minlength=x.shape[1]).cpu().numpy(
        ).astype(np.int64)
    if isinstance(x, torch.Tensor):
        return (x > 0).sum(dim=0).cpu().numpy().astype(np.int64)
    return np.asarray(x.astype(bool).sum(axis=0)).ravel().astype(np.int64)


def csr_to_device(m, device=None) -> torch.Tensor:
    """Densify a scipy sparse matrix into a (G, N) float32 tensor on
    ``device`` (the card unless told otherwise): only the CSR triplet
    crosses, and the values are scattered into zeros there. For a matrix
    that fits the card; the pipeline itself keeps CSR input sparse."""
    from scconsensus_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if isinstance(m, torch.Tensor):
        return m.to(device=dev, dtype=torch.float32)
    if not is_sparse(m):
        return torch.from_numpy(np.ascontiguousarray(m, np.float32)).to(dev)
    return DeviceCSR.from_scipy(m, dev).to_dense()


def csr_window_rows(
    x, gene_ids: np.ndarray, width: int, cid: np.ndarray,
    pad_rows: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Compacted rank-sum windows straight from CSR storage (host): for
    each gene in ``gene_ids`` (all with ≤ ``width`` stored entries), a
    (B, width) f32 row of its stored values plus a matching (B, width)
    int32 row of the owning cells' cluster ids (``cid[col]``; padding
    slots are 0 / −1). ``pad_rows`` ≥ B appends inert all-padding rows."""
    B = int(gene_ids.size)
    rows = max(B, int(pad_rows))
    vals = np.zeros((rows, width), np.float32)
    wcid = np.full((rows, width), -1, np.int32)
    indptr, indices, data = x.indptr, x.indices, x.data
    for b, g in enumerate(np.asarray(gene_ids)):
        s, e = int(indptr[g]), int(indptr[g + 1])
        n = e - s
        if n > width:
            raise ValueError(
                f"gene {int(g)} has {n} stored entries > window {width}"
            )
        vals[b, :n] = data[s:e]
        wcid[b, :n] = cid[indices[s:e]]
    return vals, wcid


def aggregates_from_sparse(x, onehot: np.ndarray) -> Tuple[np.ndarray, ...]:
    """Per-cluster sufficient statistics (Σx, Σexpm1 x, Σx², Σ[x≠0] for
    sparse or Σ[x>0] for dense input, counts) as host products against the
    membership one-hot (N, K)."""
    counts = onehot.sum(axis=0)
    if is_sparse(x):
        sum_log = np.asarray(x @ onehot, dtype=np.float32)
        sum_expm1 = np.asarray(expm1_sparse(x) @ onehot, dtype=np.float32)
        sum_sq = np.asarray(x.multiply(x) @ onehot, dtype=np.float32)
        nnz_mat = x.astype(bool).astype(np.float32)
        nnz = np.asarray(nnz_mat @ onehot, dtype=np.float32)
    else:
        sum_log = x @ onehot
        sum_expm1 = np.expm1(x) @ onehot
        sum_sq = (x * x) @ onehot
        nnz = (x > 0).astype(np.float32) @ onehot
    return sum_log, sum_expm1, sum_sq, nnz, counts.astype(np.float32)


def csr_aggregates(x: DeviceCSR, cid: torch.Tensor, n_clusters: int,
                   form=None) -> ClusterAggregates:
    """The aggregates of ``aggregates_from_sparse`` on the device: gene
    chunks gathered from the triplet through ``compute_aggregates_cid``
    with the sparse detection rule (x ≠ 0). Deterministic on the card (the
    matmul form has no atomics), as the dense path is."""
    parts = [compute_aggregates_cid(c, cid, n_clusters, form=form,
                                    nonzero=True)
             for _, _, c in row_chunks(x, _chunk_rows(x.shape[1]))]
    return ClusterAggregates(
        *(torch.cat([getattr(p, f) for p in parts]) for f in
          ("sum_log", "sum_expm1", "sum_sq", "nnz")),
        parts[0].counts,
    )
