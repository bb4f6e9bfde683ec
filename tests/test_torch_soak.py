"""The integrity-soak worker (``robust/soak.py``) against the JAX
package's: one ``labels_sha`` for (seed, shape) across the in-memory,
streamed and 8-shard mesh runs, equal to the reference's when the
reference's PCA projection is handed over; a run record that both
packages' validators accept; and the exit code as the contract."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scconsensus_tpu.config as ref_config
import scconsensus_tpu.obs.export as ref_export
from scconsensus_tpu.de import de_gene_union, pairwise_de
from scconsensus_tpu.robust.soak import run_integrity_soak as ref_soak
from scconsensus_tpu.stream.soak import chunk_generator, consensus_input
from scconsensus_tpu_torch.carry import omega_from_reference
from scconsensus_tpu_torch.obs.export import validate_run_record
from scconsensus_tpu_torch.robust import soak

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = dict(n_cells=600, n_genes=60, n_clusters=3, seed=7)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_run(tmp_path_factory):
    """The reference's soak at SHAPE, and its PCA projection draw (from
    PRNGKey(0) at (|union|, min(n_pcs + 10, |union|, N)),
    ``scconsensus_tpu/ops/pca.py``)."""
    summary = ref_soak(str(tmp_path_factory.mktemp("ref")), **SHAPE)
    cfg = ref_config.ReclusterConfig(
        method="wilcox", q_val_thrs=0.1, log_fc_thrs=0.25, min_pct=5.0,
        deep_split_values=(1, 2), min_cluster_size=10, n_top_de_genes=20,
        random_seed=SHAPE["seed"])
    g, n, k = SHAPE["n_genes"], SHAPE["n_cells"], SHAPE["n_clusters"]
    data = chunk_generator(g, n, k, SHAPE["seed"])(0, g)
    f = de_gene_union(pairwise_de(
        data, consensus_input(n, k, SHAPE["seed"]), cfg), 20).size
    omega = omega_from_reference(np.asarray(jax.random.normal(
        jax.random.PRNGKey(0), (f, min(25, f, n)), jnp.float32)))
    return summary, omega


@pytest.mark.parametrize("form", ["memory", "stream", "stream-window",
                                  "mesh-8"])
def test_labels_sha_equals_the_reference(form, ref_run, tmp_path):
    ref, omega = ref_run
    kw = {"memory": {}, "stream": {"stream": True},
          "stream-window": {"stream": True, "stream_window": 16},
          "mesh-8": {"mesh": "8"}}[form]
    got = soak.run_integrity_soak(str(tmp_path), device="cpu", omega=omega,
                                  **SHAPE, **kw)
    assert got["ok"] and got["invalid"] is None
    assert got["labels_sha"] == ref["labels_sha"]
    assert set(got) == set(ref)
    validate_run_record(ref["record"])  # the reference's, by the port
    assert (got["detections"], got["recomputes"],
            got["mesh_transitions"]) == (0, 0, 0)
    validate_run_record(got["record"])
    ref_export.validate_run_record(got["record"])
    if kw.get("stream"):
        assert got["record"]["streaming"]["complete"] is True


def test_own_draw_gives_one_sha_across_forms(tmp_path):
    """Without the reference's projection the port draws its own, on the
    host generator: one sha for the in-memory, streamed and mesh runs."""
    shas = {soak.run_integrity_soak(str(tmp_path / f), device="cpu",
                                    **SHAPE, **kw)["labels_sha"]
            for f, kw in (("m", {}), ("s", {"stream": True}),
                          ("8", {"mesh": "8"}), ("a", {"mesh": "auto"}))}
    assert len(shas) == 1


def test_audited_run_record_validates_in_both_packages(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("SCC_INTEGRITY", "audit")
    got = soak.run_integrity_soak(str(tmp_path), device="cpu", **SHAPE)
    ig = got["record"]["integrity"]
    assert got["ok"] and ig["all_checks_passed"]
    assert got["integrity"] == ig
    validate_run_record(got["record"])
    ref_export.validate_run_record(got["record"])


def test_main_exit_code_is_the_contract(tmp_path):
    workdir = str(tmp_path / "w")
    proc = subprocess.run(
        [sys.executable, "-m", "scconsensus_tpu_torch.robust.soak",
         "--dir", workdir, "--cells", "300", "--genes", "40",
         "--mesh", "2", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    summary = json.load(open(os.path.join(
        workdir, "INTEGRITY_SOAK_SUMMARY.json")))
    assert line["ok"] is True and summary["ok"] is True
    assert line["labels_sha"] == summary["labels_sha"][:16]
    assert summary["record"]["extra"]["mesh"] == "2"
    validate_run_record(summary["record"])
    with pytest.raises(SystemExit):
        soak.main(["--dir", workdir, "--mesh", "eight"])
