"""Scaffold of the PyTorch port: independence from JAX, the device rule,
the config mirror and what the port leaves out so far. Imports nothing
that needs JAX, so its ``cuda`` cases run on a card without it."""

import ast
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import scconsensus_tpu.config as ref_config
import scconsensus_tpu_torch as port
from scconsensus_tpu_torch import ReclusterConfig
from scconsensus_tpu_torch.carry import config_from_reference
from scconsensus_tpu_torch.config import CompatFlags
from scconsensus_tpu_torch.de.edger import run_edger_pairs
from scconsensus_tpu_torch.de.engine import filter_clusters, pairwise_de
from scconsensus_tpu_torch.ops.cuda_kernels import distance_cluster_sums
from scconsensus_tpu_torch.ops.pca import pca_scores
from scconsensus_tpu_torch.parallel.ring import ring_knn
from scconsensus_tpu_torch.utils.synthetic import (
    noisy_labeling,
    planted_embedding_device,
    synthetic_scrna,
    synthetic_scrna_device,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO, "scconsensus_tpu_torch")


def _tiny():
    data, truth, _ = synthetic_scrna(n_genes=120, n_cells=240, n_clusters=3,
                                     seed=3)
    return data, np.array([f"c{v}" for v in truth])


def test_port_runs_with_jax_and_reference_blocked():
    # a module set to None in sys.modules makes every import of it fail
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["jaxlib"] = None
        sys.modules["scconsensus_tpu"] = None
        sys.path.insert(0, {REPO!r})
        import importlib, os
        import scconsensus_tpu_torch as port
        for root, dirs, names in os.walk({PORT_DIR!r}):
            # packages only: build outputs live in plain directories
            dirs[:] = [d for d in dirs if os.path.exists(
                os.path.join(root, d, "__init__.py"))]
            for n in sorted(names):
                if n.endswith(".py"):
                    rel = os.path.relpath(os.path.join(root, n[:-3]), {REPO!r})
                    importlib.import_module(
                        rel.replace(os.sep, ".").replace(".__init__", ""))
        from scconsensus_tpu_torch.utils.synthetic import synthetic_scrna
        data, truth, _ = synthetic_scrna(n_genes=120, n_cells=240,
                                         n_clusters=3, seed=3)
        res = port.refine(data, [f"c{{v}}" for v in truth],
                          port.ReclusterConfig(), device="cpu")
        assert res.embedding.shape[0] == 240
        assert not any(k == "jax" or k.startswith(("jax.", "scconsensus_tpu."))
                       for k in sys.modules if sys.modules[k] is not None)
        print("OK", res.de_gene_union_idx.size)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("OK")


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0], node.lineno


def test_no_jax_or_reference_import_anywhere_in_the_port():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, names in os.walk(PORT_DIR):
        # packages only: build outputs live in plain directories
        dirs[:] = [d for d in dirs
                   if os.path.exists(os.path.join(root, d, "__init__.py"))]
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    bad = [
        f"{os.path.relpath(p, REPO)}:{line} imports {mod}"
        for p in files for mod, line in _imported_roots(p)
        if mod in ("jax", "jaxlib", "scconsensus_tpu")
    ]
    assert not bad, bad


def test_entry_points_raise_without_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    data, labels = _tiny()
    calls = {
        "refine": lambda: port.refine(data, labels, ReclusterConfig()),
        "recluster_de_consensus_fast":
            lambda: port.recluster_de_consensus_fast(data, labels),
        "recluster_de_consensus":
            lambda: port.recluster_de_consensus(data, labels,
                                                method="edgeR"),
        "pairwise_de": lambda: pairwise_de(data, labels, ReclusterConfig()),
        "pca_scores": lambda: pca_scores(data.T, 3),
        "synthetic_scrna_device":
            lambda: synthetic_scrna_device(n_genes=50, n_cells=40),
        "planted_embedding_device":
            lambda: planted_embedding_device(n_cells=40),
        "pooled_ward_linkage":
            lambda: port.pooled_ward_linkage(data.T, n_centroids=8),
        "landmark_ward_linkage":
            lambda: port.landmark_ward_linkage(data.T, n_landmarks=8),
        "knn_ward_linkage": lambda: port.knn_ward_linkage(data.T, k=3),
        "ring_knn": lambda: ring_knn(data.T, 3),
        "mean_cluster_silhouette":
            lambda: port.mean_cluster_silhouette(data.T, np.arange(240) % 3),
        "pooled_multi_cut_silhouette":
            lambda: port.pooled_multi_cut_silhouette(
                data.T, [np.arange(240) % 3], n_centroids=8),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # the kernel wrapper takes tensors only, and runs where they lie
    with pytest.raises(TypeError):
        distance_cluster_sums(np.zeros((4, 2), np.float32),
                              np.zeros((4, 1), np.int32), 1)
    # ... and the same calls run when the CPU is asked for
    res = port.refine(data, labels, ReclusterConfig(), device="cpu")
    assert res.metrics["device"] == "cpu"


def _fields(cls):
    out = {}
    for f in dataclasses.fields(cls):
        if f.default_factory is not dataclasses.MISSING:
            out[f.name] = dataclasses.asdict(f.default_factory())
        else:
            out[f.name] = f.default
    return out


@pytest.mark.parametrize("pair", ["CompatFlags", "ReclusterConfig"])
def test_config_mirror_fields_and_defaults_equal_the_reference(pair):
    ours = {"CompatFlags": CompatFlags,
            "ReclusterConfig": ReclusterConfig}[pair]
    assert _fields(ours) == _fields(getattr(ref_config, pair))


def test_config_round_trips_from_the_reference_json():
    ref = ref_config.ReclusterConfig(
        q_val_thrs=0.05, deep_split_values=(2, 4), min_diff_pct=5.0,
        max_cells_per_ident=300,
        compat=ref_config.CompatFlags(return_silhouette=False),
    )
    ours = config_from_reference(ref.to_json())
    assert ours.to_json() == ref.to_json()
    assert ours.deep_split_values == (2, 4)
    assert ours.compat.return_silhouette is False
    default = config_from_reference(ref_config.ReclusterConfig().to_json())
    assert default == ReclusterConfig()
    with pytest.raises(ValueError, match="unknown"):
        config_from_reference('{"not_a_field": 1}')


@pytest.mark.parametrize("case", ["method", "sparse", "mesh", "ring_mesh",
                                  "knn_mesh", "plot", "heatmap"])
def test_what_the_slice_leaves_out_raises(case):
    import scipy.sparse as sp

    data, labels = _tiny()
    cfg = ReclusterConfig()
    run = {
        "method": lambda: port.refine(
            data, labels, ReclusterConfig(method="bimod"), device="cpu"),
        "ring_mesh": lambda: ring_knn(data.T, 5, mesh="auto", device="cpu"),
        "knn_mesh": lambda: port.refine(
            data, labels, ReclusterConfig(approx_threshold=100,
                                          approx_method="knn"),
            device="cpu", mesh="auto"),
        "sparse": lambda: port.refine(
            sp.csr_matrix(data), labels, cfg, device="cpu"),
        "mesh": lambda: port.recluster_de_consensus_fast(
            data, labels, device="cpu", mesh="auto"),
        "plot": lambda: port.refine(
            data, labels, ReclusterConfig(plot_name="de.pdf"), device="cpu"),
        "heatmap": lambda: port.plot_contingency_table(
            labels, labels, filename="ctg.pdf"),
    }[case]
    with pytest.raises(NotImplementedError):
        run()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("log_counts", [True, False],
                         ids=["compat", "countscale"])
def test_run_edger_pairs_on_the_card_matches_the_cpu(cuda_device,
                                                     log_counts):
    # the drift sentinel's fingerprint workload, 80 genes x 200 cells
    data, truth, _ = synthetic_scrna(n_genes=80, n_cells=200, n_clusters=3,
                                     n_markers_per_cluster=8, seed=11)
    labels = noisy_labeling(truth, 0.05, seed=2)
    counts = torch.from_numpy(data if log_counts else np.expm1(data))
    names, cell_idx = filter_clusters(labels, 10)
    groups = [np.nonzero(cell_idx == k)[0] for k in range(len(names))]
    pi, pj = (a.astype(np.int32) for a in np.triu_indices(len(names), 1))
    cpu = run_edger_pairs(counts, groups, pi, pj, counts.shape[0], seed=1)
    gpu = run_edger_pairs(counts.to(cuda_device), groups, pi, pj,
                          counts.shape[0], seed=1)
    assert gpu.log_p.device.type == "cuda"
    got = {k: getattr(gpu, k).cpu().numpy() for k in
           ("log_p", "log_fc", "common_disp", "tagwise_disp")}
    # the tolerances held between the port and the JAX package on the CPU
    # (tests/test_torch_edger.py): the card's special functions are a
    # third implementation
    np.testing.assert_allclose(got["common_disp"], cpu.common_disp.numpy(),
                               rtol=2e-4)
    np.testing.assert_allclose(got["log_fc"], cpu.log_fc.numpy(), rtol=1e-5,
                               atol=2e-6)
    want = cpu.log_p.numpy()
    np.testing.assert_array_equal(np.isfinite(got["log_p"]),
                                  np.isfinite(want))
    fin = np.isfinite(want)
    err = np.abs(got["log_p"][fin] - want[fin])
    # a pseudo-count sum at a half-integer rounds to the other count on
    # the other device and moves its log p by a count's step: one entry
    # in 1,000 may (chip_smoke.py phase 5)
    n_out = int((err > (2e-3 if log_counts else 0.1)).sum())
    assert n_out <= max(1, 1e-3 * err.size), err.max()
    if not log_counts:
        np.testing.assert_allclose(got["tagwise_disp"],
                                   cpu.tagwise_disp.numpy(), rtol=2e-3)


@pytest.mark.cuda
def test_scale_ops_on_the_card_match_the_cpu(cuda_device):
    from scconsensus_tpu_torch.ops.pooling import landmark_pool
    from scconsensus_tpu_torch.ops.silhouette import (
        pooled_multi_cut_silhouette,
    )

    rng = np.random.default_rng(0)
    centers = rng.normal(scale=6.0, size=(5, 15))
    lab = rng.integers(0, 5, 6000)
    x = (centers[lab] + rng.normal(size=(6000, 15))).astype(np.float32)
    # kNN: the card's matmul sums in another order, so near-tied
    # neighbours may swap (tests/test_torch_knn.py measured 2 in 30,000
    # between the packages on the CPU)
    d_c, i_c = ring_knn(x, 15, device="cpu")
    d_g, i_g = ring_knn(x, 15, device=cuda_device)
    assert (i_g.cpu() == i_c).float().mean() >= 0.999
    tol = 8 * np.finfo(np.float32).eps * float((x.astype(np.float64) ** 2)
                                               .sum(1).max())
    assert float((d_g.cpu().double() ** 2 - d_c.double() ** 2).abs()
                 .max()) <= tol
    # landmarks: the same seeded draws, and planted blobs leave no point
    # on a near-tie between two landmarks
    cent_c, a_c, info_c = landmark_pool(x, n_landmarks=256, sketch=3000,
                                        seed=1, device="cpu")
    cent_g, a_g, info_g = landmark_pool(x, n_landmarks=256, sketch=3000,
                                        seed=1, device=cuda_device)
    assert info_g == info_c
    assert (a_g == a_c).mean() >= 0.999
    # the pooled estimator on the same pool: float32 sums in another order
    labs = [lab, np.where(lab % 2 == 0, lab, -1)]
    got = pooled_multi_cut_silhouette(x, labs, centroids=cent_c,
                                      assign=a_c, device=cuda_device)
    want = pooled_multi_cut_silhouette(x, labs, centroids=cent_c,
                                       assign=a_c, device="cpu")
    for (g, _), (w, _) in zip(got, want):
        assert abs(g - w) <= 1e-5
