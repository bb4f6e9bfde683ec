"""Consensus layer: contingency table + automated label-merge grammar.

Reproduces the *behavior* of the reference's consensus entry point
(``R/plotContingencyTable.R:15-116``) with a host-side numpy implementation —
this stage is O(N) once per run, so it stays on host by design (SURVEY.md §3 E1).
A copy of ``scconsensus_tpu/consensus/contingency.py`` without its integrity
hooks; the heatmap waits for the port's report layer.

Semantics implemented (anchors into the reference for parity checking):
  * contingency table = cross-tab of two label vectors, rows/cols in sorted
    label order (R ``table`` factor-level order) — plotContingencyTable.R:21-26.
  * base-labeling selection: the labeling with more distinct labels wins; on a
    tie, the one with the larger median cluster size — :70-84.
  * orientation: the matrix is transposed so rows correspond to the base
    labeling (cols > rows → transpose; square → transpose unless row names
    already match the base label set) — :86-99.
  * merge grammar: for every (base row i, remainder col j) cell holding >= 10%
    of row i's cells AND strictly more than ``min_clust_size`` cells, those
    cells are split out under the compound label ``"<row>_<col>"`` — :102-113.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

__all__ = [
    "ContingencyResult",
    "contingency_table",
    "automated_consensus",
    "plot_contingency_table",
]


@dataclasses.dataclass
class ContingencyResult:
    """Cross-tabulation of two clusterings.

    Attributes:
      matrix: (K1, K2) int64 counts, rows = labels_1 levels, cols = labels_2 levels.
      row_labels: sorted unique labels of the first clustering.
      col_labels: sorted unique labels of the second clustering.
    """

    matrix: np.ndarray
    row_labels: np.ndarray
    col_labels: np.ndarray

    def transpose(self) -> "ContingencyResult":
        return ContingencyResult(self.matrix.T, self.col_labels, self.row_labels)


def _as_label_array(labels: Sequence) -> np.ndarray:
    arr = np.asarray(labels)
    if arr.ndim != 1:
        raise ValueError(f"label vector must be 1-D, got shape {arr.shape}")
    return arr.astype(str)


def contingency_table(labels_1: Sequence, labels_2: Sequence) -> ContingencyResult:
    """Cross-tabulate two label vectors (R ``table(l1, l2)`` semantics).

    Levels are the sorted unique labels of each vector, matching R's default
    factor-level ordering used at plotContingencyTable.R:21.
    """
    l1 = _as_label_array(labels_1)
    l2 = _as_label_array(labels_2)
    if l1.shape != l2.shape:
        raise ValueError(
            f"label vectors disagree in length: {l1.shape[0]} vs {l2.shape[0]}"
        )
    row_labels, ridx = np.unique(l1, return_inverse=True)
    col_labels, cidx = np.unique(l2, return_inverse=True)
    k1, k2 = row_labels.size, col_labels.size
    mat = np.zeros((k1, k2), dtype=np.int64)
    np.add.at(mat, (ridx, cidx), 1)
    return ContingencyResult(mat, row_labels, col_labels)


def _median_cluster_size(labels: np.ndarray) -> float:
    _, counts = np.unique(labels, return_counts=True)
    return float(np.median(counts))


def automated_consensus(
    labels_1: Sequence,
    labels_2: Sequence,
    min_clust_size: int = 10,
    ctg: Optional[ContingencyResult] = None,
) -> np.ndarray:
    """Automated consensus labeling (plotContingencyTable.R:69-115).

    The finer-grained labeling becomes the base (tie broken by larger median
    cluster size); each base cluster is split by any remainder cluster that
    overlaps it by >=10% of the base cluster's cells and more than
    ``min_clust_size`` cells, producing compound ``"base_remainder"`` labels.

    Returns the consensus label vector (same length/order as the inputs).
    """
    l1 = _as_label_array(labels_1)
    l2 = _as_label_array(labels_2)
    if ctg is None:
        ctg = contingency_table(l1, l2)

    k1 = np.unique(l1).size
    k2 = np.unique(l2).size
    if k1 > k2:
        base, remainder = l1, l2
    elif k1 < k2:
        base, remainder = l2, l1
    else:
        if _median_cluster_size(l1) > _median_cluster_size(l2):
            base, remainder = l1, l2
        else:
            base, remainder = l2, l1

    # Orient the matrix so rows = base labels (reference :86-99).
    mat, rows, cols = ctg.matrix, ctg.row_labels, ctg.col_labels
    r, c = mat.shape
    base_levels = np.unique(base)
    if c > r:
        mat, rows, cols = mat.T, cols, rows
    elif c == r:
        if np.intersect1d(base_levels, rows).size != r:
            mat, rows, cols = mat.T, cols, rows

    consensus = base.copy().astype(object)
    row_sums = mat.sum(axis=1)
    for i in range(mat.shape[0]):
        row = mat[i]
        total = row_sums[i]
        if total == 0:
            continue
        percent_row = 100.0 * row / total
        for j in range(mat.shape[1]):
            if percent_row[j] >= 10.0 and row[j] > min_clust_size:
                sel = (base == rows[i]) & (remainder == cols[j])
                consensus[sel] = f"{rows[i]}_{cols[j]}"
    return consensus.astype(str)


def plot_contingency_table(
    cluster_labels_1: Sequence = None,
    cluster_labels_2: Sequence = None,
    automate_consensus: bool = True,
    min_clust_size: int = 10,
    filename: Optional[str] = None,
) -> Optional[np.ndarray]:
    """Reference-shaped entry point (plotContingencyTable.R:15).

    When ``automate_consensus`` is set, returns the automated consensus label
    vector. Drawing the heatmap (``filename``) is not ported yet and raises
    ``NotImplementedError``.
    """
    if cluster_labels_1 is None or cluster_labels_2 is None:
        raise ValueError("Incomplete parameters provided.")
    ctg = contingency_table(cluster_labels_1, cluster_labels_2)
    if filename is not None:
        raise NotImplementedError(
            "drawing the contingency heatmap is not ported yet; pass "
            "filename=None"
        )
    if automate_consensus:
        return automated_consensus(
            cluster_labels_1, cluster_labels_2, min_clust_size=min_clust_size, ctg=ctg
        )
    return None
