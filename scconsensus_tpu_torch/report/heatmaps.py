"""Contingency heatmap report.

The port's copy of ``scconsensus_tpu/report/heatmaps.py`` (host
matplotlib, imported at the call).

Matplotlib reproduction of the reference's ComplexHeatmap rendering
(R/plotContingencyTable.R:29-67): per-cell counts drawn in each grid cell, a
5-stop cyan→green→yellow→orange→red ramp symmetric around zero, labels_2 on
columns (top), labels_1 on rows (left).
"""

from __future__ import annotations

import numpy as np

__all__ = ["plot_contingency_heatmap"]

# The reference's 5-stop ramp over [-max|x|, +max|x|] (plotContingencyTable.R:31-45).
_RAMP_STOPS = ["#00FFFF", "#7FFF7F", "#FFFF00", "#FF7F00", "#FF0000"]


def _ramp_cmap():
    from matplotlib.colors import LinearSegmentedColormap

    return LinearSegmentedColormap.from_list("scc_ctg", _RAMP_STOPS)


def plot_contingency_heatmap(ctg, filename: str, show_counts: bool = True) -> None:
    """Render a ContingencyResult to ``filename`` (format from extension)."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    mat = np.asarray(ctg.matrix, dtype=np.float64)
    vmax = max(np.abs(mat).max(), 1.0)
    k1, k2 = mat.shape
    fig_w = max(6.0, 0.6 * k2 + 3)
    fig_h = max(6.0, 0.6 * k1 + 3)
    fig, ax = plt.subplots(figsize=(fig_w, fig_h))
    ax.imshow(mat, cmap=_ramp_cmap(), vmin=-vmax, vmax=vmax, aspect="auto")
    ax.set_xticks(range(k2), labels=[str(c) for c in ctg.col_labels], fontweight="bold")
    ax.set_yticks(range(k1), labels=[str(r) for r in ctg.row_labels], fontweight="bold")
    ax.xaxis.tick_top()
    ax.set_title("Cluster labels 2", fontsize=16, fontweight="bold", pad=30)
    ax.set_ylabel("Cluster Labels 1", fontsize=16, fontweight="bold")
    if show_counts:
        for i in range(k1):
            for j in range(k2):
                ax.text(j, i, f"{int(mat[i, j])}", ha="center", va="center",
                        fontweight="bold", color="black")
    fig.tight_layout()
    fig.savefig(filename)
    plt.close(fig)
