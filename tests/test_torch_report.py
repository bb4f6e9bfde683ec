"""The port's host reports (``report/heatmaps.py``, ``report/de_heatmap.py``)
against the JAX package's, on the CPU: the literal constants of the
reference's R report, the two render paths, the same pixels as the
reference's rendering of the same inputs, and the two entry points that
draw them (``plot_name`` and ``plot_contingency_table(filename=...)``).

Tolerance: the images are compared pixel for pixel (PNG, decoded): both
packages hand matplotlib the same arrays, and the one computed input,
the gene order of ``cluster_genes``, comes from the same native Ward."""

import os

import numpy as np
import pytest
import torch

import scconsensus_tpu as ref_pkg
from scconsensus_tpu.ops.linkage import ward_linkage as ref_ward
from scconsensus_tpu.report import de_heatmap as ref_de_heatmap
from scconsensus_tpu.report import heatmaps as ref_heatmaps
from scconsensus_tpu.utils.synthetic import noisy_labeling, synthetic_scrna
import scconsensus_tpu_torch as port
from scconsensus_tpu_torch.consensus.contingency import contingency_table
from scconsensus_tpu_torch.ops.linkage import ward_linkage
from scconsensus_tpu_torch.report import de_heatmap
from scconsensus_tpu_torch.report.heatmaps import plot_contingency_heatmap


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # the suite runs six workers on the machine's cores; two torch threads
    # a worker keep these small tensors from crowding out the other files
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pixels(path):
    from matplotlib.image import imread

    return imread(path)


class TestCellTypeDEPlotFidelity:
    """The report's constants are the reference's, which are the R
    report's (R/cellTypeDEPlot.R:173-258)."""

    def test_ramp_stops_match_reference(self):
        rainbow = ["#00007F", "blue", "#007FFF", "cyan", "#7FFF7F",
                   "yellow", "#FF7F00", "red", "#7F0000"]  # :180-190
        assert de_heatmap.COLOR_SCHEMES["blue"] == rainbow
        assert de_heatmap.COLOR_SCHEMES["green"] == rainbow
        assert de_heatmap.COLOR_SCHEMES["violet"] == [
            "#7777FF", "white", "red", "#7F0000", "#2F0000"]  # :216-220
        assert de_heatmap.COLOR_SCHEMES == ref_de_heatmap.COLOR_SCHEMES

    def test_scheme_ranges(self):
        data = np.array([[-2.0, 1.0], [0.5, 3.0]])
        for scheme, want in (("blue", (-2.0, 3.0)), ("green", (-3.0, 3.0)),
                             ("violet", (0.5, 3.0))):
            assert de_heatmap.SCHEME_RANGES(scheme, data) == want
            assert ref_de_heatmap.SCHEME_RANGES(scheme, data) == want
        with pytest.raises(ValueError, match="col_scheme"):
            de_heatmap.SCHEME_RANGES("red", data)

    def test_default_scheme_is_green(self):
        import inspect

        sig = inspect.signature(de_heatmap.cell_type_de_plot)
        assert sig.parameters["col_scheme"].default == "green"  # :23
        assert sig == inspect.signature(ref_de_heatmap.cell_type_de_plot)

    def test_pdf_naming_and_nodg_fallback(self, tmp_path, rng):
        n, g = 60, 12
        mat = np.abs(rng.normal(size=(g, n))).astype(np.float32)
        tree = ward_linkage(rng.normal(size=(n, 4)))
        out = de_heatmap.cell_type_de_plot(
            data_matrix=mat,
            nodg=None,  # the reference's fallback :31-36
            cell_tree=tree,
            cluster_labels=np.array([f"c{i % 2}" for i in range(n)]),
            dynamic_colors_list={"deepsplit: 1": np.array(["turquoise"] * n)},
            filename=str(tmp_path / "report"),  # no extension
        )
        assert out.endswith("report.pdf")  # paste0(filename, ".pdf") :256
        assert os.path.getsize(out) > 5_000

    def test_binned_rendering_keeps_small_cluster(self, tmp_path, rng):
        n, g = 600, 10
        mat = np.abs(rng.normal(size=(g, n))).astype(np.float32)
        points = rng.normal(size=(n, 4))
        labels = np.array(["big"] * (n - 3) + ["tiny"] * 3)
        kw = dict(data_matrix=mat, nodg=(mat > 0.5).sum(axis=0),
                  cluster_labels=labels, dynamic_colors_list={},
                  max_cells_rendered=50)  # force aggregation
        out = de_heatmap.cell_type_de_plot(
            cell_tree=ward_linkage(points),
            filename=str(tmp_path / "binned.png"), **kw)
        assert os.path.getsize(out) > 5_000
        want = ref_de_heatmap.cell_type_de_plot(
            cell_tree=ref_ward(points),
            filename=str(tmp_path / "binned_ref.png"), **kw)
        np.testing.assert_array_equal(_pixels(out), _pixels(want))


def test_de_heatmap_renders_with_groups(tmp_path, rng):
    n, g = 120, 30
    mat = np.abs(rng.normal(size=(g, n))).astype(np.float32)
    points = rng.normal(size=(n, 5))
    kw = dict(
        data_matrix=mat,
        nodg=(mat > 0.5).sum(axis=0),
        cluster_labels=np.array([f"c{i % 3}" for i in range(n)]),
        dynamic_colors_list={"deepsplit: 1": np.array(["turquoise"] * n)},
        gene_labels=np.array([f"g{i}" for i in range(g)]),
        gene_groups=np.array(["A", "B"] * (g // 2)),
        cluster_genes=True,
    )
    out = str(tmp_path / "de.png")
    de_heatmap.cell_type_de_plot(cell_tree=ward_linkage(points),
                                 filename=out, **kw)
    assert os.path.getsize(out) > 10_000
    want = str(tmp_path / "de_ref.png")
    ref_de_heatmap.cell_type_de_plot(cell_tree=ref_ward(points),
                                     filename=want, **kw)
    np.testing.assert_array_equal(_pixels(out), _pixels(want))


def test_contingency_heatmap_renders(tmp_path):
    from scconsensus_tpu.consensus import contingency_table as ref_table

    l1 = np.array(["a", "a", "b", "b", "c"] * 10)
    l2 = np.array(["x", "y", "x", "y", "y"] * 10)
    out = str(tmp_path / "ctg.pdf")
    plot_contingency_heatmap(contingency_table(l1, l2), out)
    assert os.path.getsize(out) > 1_000
    png, want = str(tmp_path / "ctg.png"), str(tmp_path / "ctg_ref.png")
    plot_contingency_heatmap(contingency_table(l1, l2), png)
    ref_heatmaps.plot_contingency_heatmap(ref_table(l1, l2), want)
    np.testing.assert_array_equal(_pixels(png), _pixels(want))


def test_plot_contingency_table_draws_and_returns_the_consensus(tmp_path):
    _, truth, _ = synthetic_scrna(n_genes=200, n_cells=300, n_clusters=4,
                                  seed=3)
    sup = noisy_labeling(truth, 0.05, n_out_clusters=3, seed=1, prefix="T")
    uns = noisy_labeling(truth, 0.10, seed=2, prefix="L")
    out = str(tmp_path / "ctg.png")
    cons = port.plot_contingency_table(sup, uns, filename=out)
    want = str(tmp_path / "ctg_ref.png")
    np.testing.assert_array_equal(
        cons, ref_pkg.plot_contingency_table(sup, uns, filename=want))
    np.testing.assert_array_equal(_pixels(out), _pixels(want))


def test_plot_name_draws_the_de_heatmap(tmp_path):
    data, truth, _ = synthetic_scrna(n_genes=150, n_cells=200, n_clusters=3,
                                     seed=5)
    labels = np.array([f"c{v}" for v in truth])
    plain = port.recluster_de_consensus_fast(
        data, labels, deep_split_values=(1,), device="cpu")
    res = port.recluster_de_consensus_fast(
        data, labels, deep_split_values=(1,), device="cpu",
        plot_name=str(tmp_path / "de_plot"))
    assert os.path.getsize(tmp_path / "de_plot.pdf") > 5_000
    assert "report" in res.metrics["stage_walls_s"]
    # drawing changes nothing the run computed
    for key in plain.dynamic_labels:
        np.testing.assert_array_equal(res.dynamic_labels[key],
                                      plain.dynamic_labels[key])
