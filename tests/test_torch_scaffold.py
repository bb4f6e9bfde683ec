"""Scaffold of the PyTorch port: independence from JAX, the device rule,
the config mirror and what the first slice leaves out."""

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
from scconsensus_tpu_torch.de.engine import pairwise_de
from scconsensus_tpu_torch.ops.cuda_kernels import distance_cluster_sums
from scconsensus_tpu_torch.ops.pca import pca_scores
from scconsensus_tpu_torch.utils.synthetic import (
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
        "pairwise_de": lambda: pairwise_de(data, labels, ReclusterConfig()),
        "pca_scores": lambda: pca_scores(data.T, 3),
        "synthetic_scrna_device":
            lambda: synthetic_scrna_device(n_genes=50, n_cells=40),
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


@pytest.mark.parametrize("case", ["method", "distance", "cells", "sparse",
                                  "mesh", "plot", "heatmap"])
def test_what_the_slice_leaves_out_raises(case):
    import scipy.sparse as sp

    data, labels = _tiny()
    cfg = ReclusterConfig()
    run = {
        "method": lambda: port.refine(
            data, labels, ReclusterConfig(method="edger"), device="cpu"),
        "distance": lambda: port.refine(
            data, labels, ReclusterConfig(distance="pearson"), device="cpu"),
        "cells": lambda: port.refine(
            data, labels, ReclusterConfig(approx_threshold=100),
            device="cpu"),
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
