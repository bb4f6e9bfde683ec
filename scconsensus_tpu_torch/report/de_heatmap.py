"""DE-gene heatmap report (``cellTypeDEPlot`` equivalent).

The port's copy of ``scconsensus_tpu/report/de_heatmap.py`` (host
matplotlib and scipy, imported at the call).

Matplotlib reproduction of R/cellTypeDEPlot.R:17-293: genes × cells expression
heatmap of the DE-gene union with columns in dendrogram order, a column
dendrogram panel, stacked annotations (per-consensus-cluster one-hot
black/white bars, one color bar per deepSplit cut, a NODG barplot), and the
reference's three ramp schemes with their value-range semantics. The
reference's O(N·(K+D)) element-naming loop (:116-136) is replaced by
vectorized index mapping; its 50×50-inch rasterized PDF (:250-258) by
aggregation-aware column binning (each rendered column is the mean /
membership-fraction / majority-color of a contiguous run of dendrogram-
ordered cells, so small clusters shade bins instead of vanishing).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

__all__ = ["cell_type_de_plot", "COLOR_SCHEMES", "SCHEME_RANGES"]

# The reference's circlize::colorRamp2 stop colors, verbatim
# (R/cellTypeDEPlot.R:174-222): "blue" and "green" share one 9-stop
# blue→cyan→yellow→red rainbow and differ only in the value range the ramp
# spans; "violet" is a 5-stop lightblue→white→red→darkred ramp.
_RAINBOW_9 = [
    "#00007F", "blue", "#007FFF", "cyan", "#7FFF7F",
    "yellow", "#FF7F00", "red", "#7F0000",
]
COLOR_SCHEMES = {
    "blue": list(_RAINBOW_9),
    "green": list(_RAINBOW_9),
    "violet": ["#7777FF", "white", "red", "#7F0000", "#2F0000"],
}


def SCHEME_RANGES(scheme: str, data: np.ndarray):
    """(vmin, vmax) per the reference's seq() endpoints for each scheme:
    blue = [min, max] of the data (:179); green = ±max|data| (:197);
    violet = [min|data|, max|data|] (:215)."""
    if scheme == "blue":
        return float(data.min()), float(data.max())
    if scheme == "green":
        a = float(np.abs(data).max())
        return -a, a
    if scheme == "violet":
        ab = np.abs(data)
        return float(ab.min()), float(ab.max())
    raise ValueError(f"col_scheme must be one of {sorted(COLOR_SCHEMES)}")


_R_COLOR_FALLBACKS = {
    "grey60": "#999999",
    "lightcyan1": "#E0FFFF",
    "sienna3": "#CD6839",
    "skyblue3": "#6CA6CD",
    "plum1": "#FFBBFF",
    "plum2": "#EEAEEE",
    "orangered4": "#8B2500",
    "mediumpurple3": "#8968CD",
    "lightsteelblue1": "#CAE1FF",
    "darkorange2": "#EE7600",
    "brown4": "#8B2323",
    "bisque4": "#8B7D6B",
    "thistle2": "#EED2EE",
}


def _to_mpl_color(name: str):
    from matplotlib.colors import to_rgba

    base = name.split(".")[0]  # cycled palette suffix
    if base in _R_COLOR_FALLBACKS:
        return to_rgba(_R_COLOR_FALLBACKS[base])
    try:
        return to_rgba(base)
    except ValueError:
        return to_rgba("grey")


def _scipy_linkage(tree) -> np.ndarray:
    """Convert an R-convention HClustTree to a scipy linkage matrix
    (leaves 0..n-1, merge row i becomes cluster n+i, 4th column = size)."""
    n = tree.n_leaves
    z = np.zeros((n - 1, 4))
    sizes = np.zeros(n - 1)
    for i in range(n - 1):
        s = 0.0
        for c, v in enumerate(tree.merge[i]):
            if v < 0:
                z[i, c] = -v - 1
                s += 1.0
            else:
                z[i, c] = n + v - 1
                s += sizes[v - 1]
        z[i, 2] = tree.height[i]
        z[i, 3] = s
        sizes[i] = s
    return z


def _resolve_filename(filename: str) -> str:
    """The reference writes paste0(filename, ".pdf") (:256-258): a name
    without an extension gets ".pdf"; explicit extensions are respected."""
    root, ext = os.path.splitext(filename)
    if ext.lower() in (".pdf", ".png", ".svg", ".jpg", ".jpeg"):
        return filename
    return filename + ".pdf"


def cell_type_de_plot(
    data_matrix: np.ndarray,
    nodg: Optional[np.ndarray] = None,
    cell_tree=None,
    cluster_labels: Sequence[str] = (),
    dynamic_colors_list: Optional[Dict[str, np.ndarray]] = None,
    gene_labels: Optional[Sequence[str]] = None,
    col_scheme: str = "green",
    filename: str = "DE_Heatmap",
    max_cells_rendered: int = 4000,
    cluster_genes: bool = True,
    gene_groups: Optional[Sequence[str]] = None,
) -> str:
    """Render the DE heatmap report. Returns the written file path.

    data_matrix: (|U|, N) expression of the DE-gene union;
    nodg: per-cell detected-gene counts; None recomputes them from
    ``data_matrix > 0`` (the reference's fallback, R/cellTypeDEPlot.R:31-36);
    cell_tree: HClustTree whose ``order`` sets the column order (its
    dendrogram is drawn above the heatmap, :229-239);
    dynamic_colors_list: {"deepsplit: k": color-name per cell};
    col_scheme: 'green' (default, :23) | 'blue' | 'violet';
    filename: extension-less names get ".pdf" appended (:256);
    cluster_genes: order rows by a Ward dendrogram over genes (the
    reference Heatmap's row clustering, :230);
    gene_groups: optional per-gene group names rendered as a row-annotation
    color bar (the reference's geneLabels annotation, :260-282).

    Past ``max_cells_rendered``, columns are binned (means / membership
    fractions / majority colors over contiguous dendrogram-ordered runs)
    rather than subsampled, so no cluster can disappear from the bars.
    """
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    from matplotlib.colors import LinearSegmentedColormap

    if col_scheme not in COLOR_SCHEMES:
        raise ValueError(f"col_scheme must be one of {sorted(COLOR_SCHEMES)}")
    if cell_tree is None:
        raise ValueError("cell_tree is required (sets the column order)")
    dynamic_colors_list = dynamic_colors_list or {}
    data_matrix = np.asarray(data_matrix)
    if nodg is None:
        nodg = (data_matrix > 0).sum(axis=0)

    order = np.asarray(cell_tree.order)
    n = order.size
    labels = np.asarray(cluster_labels).astype(str)
    if labels.size != n:
        raise ValueError(
            f"cluster_labels length {labels.size} != n_cells {n}"
        )
    n_bins = min(n, max_cells_rendered)
    edges = np.linspace(0, n, n_bins + 1).astype(int)
    counts = np.diff(edges).astype(float)
    # bin id of each ORIGINAL column (contiguous runs in dendrogram order);
    # binning via a sparse aggregation matmul / bincounts avoids ever
    # materializing a reordered copy of the (|U|, N) matrix.
    col_bin = np.empty(n, np.int64)
    col_bin[order] = np.repeat(np.arange(n_bins), np.diff(edges))

    from scipy import sparse as _sp

    agg = _sp.csr_matrix(
        ((1.0 / counts[col_bin]).astype(np.float32),
         (np.arange(n), col_bin)),
        shape=(n, n_bins),
    )
    mat = np.asarray((agg.T @ data_matrix.T).T)  # (|U|, n_bins) bin means
    nodg_b = np.bincount(col_bin, weights=np.asarray(nodg, float),
                         minlength=n_bins) / counts

    gene_order = np.arange(mat.shape[0])
    if cluster_genes and mat.shape[0] > 2:
        from scconsensus_tpu_torch.ops.linkage import ward_linkage

        gene_order = np.asarray(ward_linkage(mat).order)
    mat = mat[gene_order]
    if gene_labels is not None:
        gene_labels = np.asarray(gene_labels)[gene_order]
    if gene_groups is not None:
        gene_groups = np.asarray(gene_groups).astype(str)[gene_order]

    uniq_clusters = sorted(set(labels.tolist()))
    n_k = len(uniq_clusters)
    n_ds = len(dynamic_colors_list)

    heights = [1.6, 1.2] + [0.25] * n_k + [0.4] * n_ds + [8.0]
    fig_h = min(6 + 0.25 * n_k + 0.4 * n_ds + 0.12 * mat.shape[0], 60)
    fig, axes = plt.subplots(
        len(heights), 1, figsize=(16, fig_h),
        gridspec_kw={"height_ratios": heights, "hspace": 0.05},
    )

    ax = axes[0]  # column dendrogram (reference :229-239, top side)
    try:
        from scipy.cluster.hierarchy import dendrogram

        z = _scipy_linkage(cell_tree)
        if n > n_bins:
            # collapse to ~bin resolution so leaf spacing tracks the binned
            # columns (the reference rasterizes all N instead)
            dendrogram(z, ax=ax, truncate_mode="lastp", p=n_bins,
                       no_labels=True, color_threshold=0.0,
                       above_threshold_color="black", show_contracted=False)
        else:
            dendrogram(z, ax=ax, no_labels=True, color_threshold=0.0,
                       above_threshold_color="black")
        ax.set_ylabel("tree", fontsize=8)
        ax.set_xticks([])
        for side in ("top", "right", "bottom"):
            ax.spines[side].set_visible(False)
    except Exception:  # dendrogram drawing must never kill the report
        ax.set_axis_off()

    ax = axes[1]  # NODG barplot (reference :153-166)
    ax.bar(np.arange(n_bins), nodg_b, width=1.0, color="#777777")
    ax.set_xlim(-0.5, n_bins - 0.5)
    ax.set_ylabel("NODG", fontsize=8)
    ax.yaxis.set_label_position("left")
    ax.yaxis.tick_right()  # axis_param side = "right" (:160)
    ax.tick_params(labelbottom=False, bottom=False)

    for i, cl in enumerate(uniq_clusters):  # one-hot bars (:53-95)
        ax = axes[2 + i]
        frac = np.bincount(col_bin, weights=(labels == cl).astype(float),
                           minlength=n_bins) / counts
        ax.imshow(frac[None, :], aspect="auto", cmap="binary", vmin=0, vmax=1,
                  interpolation="nearest")
        ax.set_ylabel(cl, rotation=0, ha="right", va="center", fontsize=7)
        ax.set_xticks([]); ax.set_yticks([])

    for j, (key, colors) in enumerate(dynamic_colors_list.items()):  # (:144-147)
        ax = axes[2 + n_k + j]
        uc, inv = np.unique(np.asarray(colors).astype(str), return_inverse=True)
        per_bin = np.bincount(
            col_bin * uc.size + inv, minlength=n_bins * uc.size
        ).reshape(n_bins, uc.size)
        majority = uc[per_bin.argmax(axis=1)]
        rgba = np.array([_to_mpl_color(c) for c in majority])
        ax.imshow(rgba[None, :, :], aspect="auto", interpolation="nearest")
        ax.set_ylabel(key, rotation=0, ha="right", va="center", fontsize=7)
        ax.set_xticks([]); ax.set_yticks([])

    ax = axes[-1]  # main heatmap, scheme ranges per the reference
    vmin, vmax = SCHEME_RANGES(col_scheme, data_matrix)
    if vmax <= vmin:
        vmax = vmin + 1e-6
    cmap = LinearSegmentedColormap.from_list(
        f"scc_{col_scheme}", COLOR_SCHEMES[col_scheme]
    )
    ax.imshow(mat, aspect="auto", cmap=cmap, vmin=vmin, vmax=vmax,
              interpolation="nearest")
    ax.set_xticks([])
    if gene_labels is not None and len(gene_labels) <= 120:
        ax.set_yticks(range(len(gene_labels)), labels=list(gene_labels), fontsize=5)
    else:
        ax.set_yticks([])
    ax.set_ylabel(f"{mat.shape[0]} DE genes", fontsize=9)

    if gene_groups is not None:  # row annotation (:260-282)
        from scconsensus_tpu_torch.ops.colors import labels_to_colors

        uniq = sorted(set(gene_groups.tolist()))
        group_idx = {g: i + 1 for i, g in enumerate(uniq)}
        group_colors = labels_to_colors(
            np.array([group_idx[g] for g in gene_groups])
        )
        rgba = np.array([_to_mpl_color(c) for c in group_colors])
        inset = ax.inset_axes([1.005, 0.0, 0.015, 1.0])
        inset.imshow(rgba[:, None, :], aspect="auto", interpolation="nearest")
        inset.set_xticks([])
        inset.set_yticks([])
        inset.set_title("groups", fontsize=6)

    fig.suptitle("DE gene expression (columns in dendrogram order)", fontsize=12)
    out = _resolve_filename(filename)
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out
