"""Host reports: the contingency heatmap and the DE-gene heatmap
(matplotlib, imported only when a report is drawn)."""

from scconsensus_tpu_torch.report.heatmaps import plot_contingency_heatmap

__all__ = ["plot_contingency_heatmap"]


def __getattr__(name):
    if name in ("cell_type_de_plot",):
        from scconsensus_tpu_torch.report import de_heatmap

        return getattr(de_heatmap, name)
    raise AttributeError(name)
