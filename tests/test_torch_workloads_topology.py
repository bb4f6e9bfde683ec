"""The port's topology clusterer (``workloads/topology.py``) and the zoo
soak worker's ``--topo`` audit against the JAX package's, on the CPU.

Tolerance: none. On the same embedding the two packages give the same
label strings, and the audit the same ``labels_sha``: the device pieces
are argmins and argmaxes over float32 distances, which agree unless two
candidates lie within float32 rounding of each other (none does on these
inputs; a near-tie would show here as a differing string)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scconsensus_tpu.obs.regress import adjusted_rand_index
from scconsensus_tpu.workloads import soak as ref_soak
from scconsensus_tpu.workloads import topology as ref_topology
from scconsensus_tpu.workloads.common import pca_embed as ref_pca_embed
from scconsensus_tpu_torch.carry import omega_from_reference
from scconsensus_tpu_torch.workloads import soak, topology

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # the suite runs six workers on the machine's cores; two torch threads
    # a worker keep these small tensors from crowding out the other files
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _blobs(n=600, k=3, d=6, seed=5, spread=0.5):
    """The reference tests' blobs (tests/test_workloads.py)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0.0, 6.0, size=(k, d))
    lab = rng.integers(0, k, size=n)
    x = (centers[lab]
         + rng.normal(0.0, spread, size=(n, d))).astype(np.float32)
    return x, lab


@pytest.mark.parametrize("case", [
    dict(n_covers=10, seed=3),
    dict(n_covers=10, seed=4),
    dict(n_covers=6, seed=0, overlap=2.0),
    dict(n_covers=12, seed=1, min_overlap=2, local_iters=4),
    dict(n_covers=500, seed=2),          # capped at N // 4
])
def test_topology_cluster_equals_the_reference(case):
    x, lab = _blobs()
    got = topology.topology_cluster(x, device="cpu", **case)
    want = ref_topology.topology_cluster(x, **case)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_pure_function_that_recovers_separated_blobs():
    x, lab = _blobs()
    a = topology.topology_cluster(x, n_covers=10, seed=3, device="cpu")
    b = topology.topology_cluster(x.copy(), n_covers=10, seed=3,
                                  device="cpu")
    assert np.array_equal(a, b)
    assert adjusted_rand_index(a, lab) > 0.95


def test_topology_labeling_equals_the_reference_with_its_draw():
    rng = np.random.default_rng(9)
    data = rng.gamma(2.0, size=(50, 400)).astype(np.float32)
    omega = omega_from_reference(np.asarray(jax.random.normal(
        jax.random.PRNGKey(2), (50, 16), jnp.float32)))
    got = topology.topology_labeling(data, n_pcs=6, n_covers=8, seed=2,
                                     omega=omega, device="cpu")
    # the two-piece composition over the reference's own embedding
    emb = ref_pca_embed(data, 6, seed=2)
    assert np.array_equal(
        got, topology.topology_cluster(emb, n_covers=8, seed=2,
                                       device="cpu"))
    assert np.array_equal(
        got, ref_topology.topology_labeling(data, n_pcs=6, n_covers=8,
                                            seed=2))


@pytest.mark.parametrize("shape", [
    dict(n_cells=800, n_clusters=3),        # tools/verify_run.py's shape
    dict(n_cells=2000, n_clusters=4),       # the worker's default
])
def test_topo_audit_sha_equals_the_reference(shape, tmp_path):
    got = soak.run_topo_audit(str(tmp_path), device="cpu", **shape)
    want = ref_soak.run_topo_audit(str(tmp_path), **shape)
    assert got["ok"] and got["labels_sha"] == want["labels_sha"]
    assert got["n_topo_clusters"] == want["n_topo_clusters"]


def test_topo_worker_module_exits_zero_on_the_cpu(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "scconsensus_tpu_torch.workloads.soak",
         "--dir", str(tmp_path), "--topo", "--cells", "800",
         "--clusters", "3", "--device", "cpu"],
        capture_output=True, text=True, timeout=240, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert (tmp_path / "WORKLOAD_SOAK_SUMMARY.json").exists()
