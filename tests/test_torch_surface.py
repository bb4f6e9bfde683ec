"""The port's whole surface against the reference's, and the reference
names that were the last to be ported, each held against the reference on
the CPU.

Every reference module with a port module (all but
``ops/pallas_kernels.py``, which became the CUDA kernel, and the JAX-only
``utils/jax_compat.py`` and ``utils/xla_bootstrap.py``) has its whole
``__all__`` in the port module's ``__all__``, in the reference's order; the
port may export more. A reference module without ``__all__`` has each
class and function it defines in the port module.
"""

import ast
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from scconsensus_tpu.io import sparsemat as ref_sparsemat
from scconsensus_tpu.obs import graphs as ref_graphs
from scconsensus_tpu.ops import distance as ref_distance
from scconsensus_tpu.ops import gates as ref_gates
from scconsensus_tpu.ops import ranksum_allpairs as ref_rs
from scconsensus_tpu.ops import seurat_tests as ref_st
from scconsensus_tpu.parallel import mesh as ref_mesh
from scconsensus_tpu_torch.io import sparsemat
from scconsensus_tpu_torch.obs import graphs
from scconsensus_tpu_torch.ops import distance, gates
from scconsensus_tpu_torch.ops import ranksum_allpairs as rs
from scconsensus_tpu_torch.ops import seurat_tests as st
from scconsensus_tpu_torch.parallel import mesh as pmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_DIR = os.path.join(REPO, "scconsensus_tpu")
# the reference modules with no port module, and why
NO_PORT = {
    "scconsensus_tpu.ops.pallas_kernels": "became csrc/distance_cluster_sums.cu",
    "scconsensus_tpu.utils.jax_compat": "JAX-only",
    "scconsensus_tpu.utils.xla_bootstrap": "JAX-only",
}
# log p of the Seurat tiles: the tolerances of tests/test_torch_seurat.py
# and for its reasons (the same float32 formulas; gammaincc, lgamma and log
# are other implementations, a few ulps apart, and the likelihoods and
# log-gammas they take are large)
LOGP_RTOL, LOGP_ATOL = 2e-4, 1e-2


def _reference_modules():
    mods = []
    for root, dirs, files in os.walk(REF_DIR):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
            name = rel.replace(os.sep, ".")
            if name.endswith(".__init__"):
                name = name[:-len(".__init__")]
            mods.append(name)
    return mods


REFERENCE_MODULES = _reference_modules()


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_the_reference_modules_without_a_port_are_the_three_named():
    assert len(REFERENCE_MODULES) > 90
    missing = set()
    for name in REFERENCE_MODULES:
        try:
            importlib.import_module(name.replace("scconsensus_tpu",
                                                 "scconsensus_tpu_torch", 1))
        except ModuleNotFoundError:
            missing.add(name)
    assert missing == set(NO_PORT)


@pytest.mark.parametrize("name", [m for m in REFERENCE_MODULES
                                  if m not in NO_PORT])
def test_the_port_module_exports_the_reference_modules_names(name):
    ref = importlib.import_module(name)
    ours = importlib.import_module(
        name.replace("scconsensus_tpu", "scconsensus_tpu_torch", 1))
    if not hasattr(ref, "__all__"):
        defined = [n for n, v in vars(ref).items() if not n.startswith("_")
                   and getattr(v, "__module__", None) == name]
        assert [n for n in defined if not hasattr(ours, n)] == []
        return
    exported = list(ours.__all__)
    assert [n for n in ref.__all__ if n not in exported] == []
    assert [n for n in exported if n in ref.__all__] == list(ref.__all__)
    for n in exported:
        assert hasattr(ours, n), n


# --------------------------------------------------------------------------
# ops/distance.py
# --------------------------------------------------------------------------

def _points(seed=0, n=70, d=6):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def test_euclidean_distance_matrix_equals_the_reference():
    """rtol 1e-5, atol 1e-5: the same ‖a‖² + ‖b‖² − 2ab form in float32 on
    both sides, distances of size ~3, whose sums and products differ in
    the last ulps; the diagonal exactly 0 in both."""
    x = _points()
    got = distance.euclidean_distance_matrix(torch.from_numpy(x)).numpy()
    want = np.asarray(ref_distance.euclidean_distance_matrix(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (np.diag(got) == 0).all() and (np.diag(want) == 0).all()


def test_pearson_distance_matrix_equals_the_reference():
    """rtol 1e-5, atol 1e-6: 1 − r of float32 unit columns, r summed over
    80 genes in another order (the diagonal is 0 up to that rounding)."""
    cols = np.abs(_points(1, 80, 50))
    got = distance.pearson_distance_matrix(torch.from_numpy(cols)).numpy()
    want = np.asarray(ref_distance.pearson_distance_matrix(
        jnp.asarray(cols)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_distance_row_blocks_equal_the_references_blocks():
    """The same (start, stop) blocks, each at rtol 1e-5 / atol 1e-5 (as the
    full matrix), the self-distance exactly 0."""
    x = _points(2, 45)
    got = list(distance.distance_row_blocks(torch.from_numpy(x), block=16))
    want = list(ref_distance.distance_row_blocks(x, block=16))
    assert [(s, e) for s, e, _ in got] == [(s, e) for s, e, _ in want] == [
        (0, 16), (16, 32), (32, 45)]
    for (s, e, d), (_, _, w) in zip(got, want):
        assert isinstance(d, np.ndarray) and d.shape == (e - s, 45)
        np.testing.assert_allclose(d, w, rtol=1e-5, atol=1e-5)
        assert (d[np.arange(e - s), np.arange(s, e)] == 0).all()


# --------------------------------------------------------------------------
# ops/gates.py
# --------------------------------------------------------------------------

def _aggregate_inputs():
    rng = np.random.default_rng(3)
    data = rng.poisson(1.2, size=(30, 90)).astype(np.float32)
    cid = rng.integers(-1, 5, size=90)      # -1: a cell in no cluster
    onehot = np.zeros((90, 5), np.float32)
    onehot[np.arange(90)[cid >= 0], cid[cid >= 0]] = 1.0
    return data, cid, onehot


def _assert_aggregates_equal(got, want):
    """Integer counts, so Σx, Σx², the detected counts and the cell counts
    are integers below 2²⁴ and exact in float32 in any order: equal. Σ
    expm1(x) sums non-integers in another order: rtol 1e-6."""
    for f in ("sum_log", "sum_sq", "nnz", "counts"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    np.testing.assert_allclose(got.sum_expm1.numpy(),
                               np.asarray(want.sum_expm1), rtol=1e-6)


def test_compute_aggregates_equals_the_reference_on_integer_counts():
    """The one-hot signature, in the form the CPU picks."""
    data, _, onehot = _aggregate_inputs()
    got = gates.compute_aggregates(torch.from_numpy(data),
                                   torch.from_numpy(onehot))
    want = ref_gates.compute_aggregates(jnp.asarray(data),
                                        jnp.asarray(onehot))
    _assert_aggregates_equal(got, want)


@pytest.mark.parametrize("form", ["segment", "matmul"])
def test_both_cid_forms_equal_the_reference_on_integer_counts(form):
    """Both forms ``compute_aggregates`` can reach (the device picks one),
    held to the reference's one-hot aggregates."""
    data, cid, onehot = _aggregate_inputs()
    got = gates.compute_aggregates_cid(torch.from_numpy(data),
                                       torch.from_numpy(cid), 5, form=form)
    want = ref_gates.compute_aggregates(jnp.asarray(data),
                                        jnp.asarray(onehot))
    _assert_aggregates_equal(got, want)


def test_compute_aggregates_refuses_a_weighted_onehot():
    data = torch.ones((3, 4))
    with pytest.raises(ValueError, match="0/1"):
        gates.compute_aggregates(data, torch.full((4, 2), 0.5))
    with pytest.raises(ValueError, match="at most one 1"):
        gates.compute_aggregates(data, torch.ones((4, 2)))


# --------------------------------------------------------------------------
# ops/seurat_tests.py
# --------------------------------------------------------------------------

def _tile_case():
    """(B, G, W) tiles over 5 masks pairs: random genes, genes whose groups
    lie far apart (p below FLT_MIN: −inf after the floor's flush, C fact
    9), genes whose groups hold the same values (t ≈ 0, where the
    reference's Welch can be NaN, C fact 10), an all-zero gene, and pairs
    with a group below 1 and below 2 cells (NaN by rule)."""
    rng = np.random.default_rng(5)
    B, G, W = 5, 9, 120
    vals = (rng.gamma(2.0, 1.0, (B, G, W))
            * (rng.random((B, G, W)) < 0.6)).astype(np.float32)
    m1 = np.zeros((B, W), bool)
    m2 = np.zeros((B, W), bool)
    m1[:, :60], m2[:, 60:] = True, True
    vals[:, 3, :60] = 9.0 + rng.random((B, 60))        # far apart
    vals[:, 3, 60:] = 0.01 * rng.random((B, 60))
    vals[:, 4, 60:] = vals[:, 4, :60][:, ::-1]         # the same values
    vals[:, 5] = 0.0                                   # all zero
    m1[3] = False
    m1[3, 0] = True                                    # a one-cell group
    m2[4] = False                                      # an empty group
    return vals, m1, m2


def _assert_logp(got, want):
    """The Seurat parity rule (tests/test_torch_seurat.py): a reference NaN
    where the port gives log p = 0 only at t ≈ 0 (C fact 10), NaN and −inf
    in the same places, the finite rest at LOGP_RTOL/ATOL."""
    got, want = np.asarray(got), np.asarray(want)
    at_one = np.isnan(want) & (got == 0.0)
    assert at_one[:, [0, 1, 2, 3, 5, 6, 7, 8]].sum() == 0
    want = np.where(at_one, 0.0, want).astype(want.dtype)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=LOGP_RTOL,
                               atol=LOGP_ATOL)
    return got


@pytest.mark.parametrize("test", ["bimod", "welch"])
def test_the_seurat_tiles_equal_the_reference(test):
    vals, m1, m2 = _tile_case()
    if test == "bimod":
        got = st.bimod_lrt_tile(torch.from_numpy(vals), torch.from_numpy(m1),
                                torch.from_numpy(m2))
        want = ref_st.bimod_lrt_tile(jnp.asarray(vals), jnp.asarray(m1),
                                     jnp.asarray(m2))
    else:
        got = st.welch_t_tile(torch.from_numpy(vals), torch.from_numpy(m1),
                              torch.from_numpy(m2))
        want = ref_st.welch_t_tile(jnp.asarray(vals), jnp.asarray(m1),
                                   jnp.asarray(m2))
    got = _assert_logp(got.numpy(), np.asarray(want))
    assert got.shape == (5, 9)
    assert np.isneginf(got[:3, 3]).all()          # the flush: C fact 9
    assert np.isnan(got[4]).all()                 # an empty group
    if test == "welch":
        assert np.isnan(got[3]).all()             # a one-cell group
    else:
        assert not np.isnan(got[3]).any()


# --------------------------------------------------------------------------
# ops/ranksum_allpairs.py
# --------------------------------------------------------------------------

def test_allpairs_ranksum_chunk_is_the_ports_scan_body():
    assert rs.allpairs_ranksum_chunk is rs.ranksum_body
    assert rs.allpairs_ranksum_runspace_chunk is rs.ranksum_body_runspace
    assert rs.RUN_CAP == ref_rs.RUN_CAP


def _ranksum_case(window=False):
    """Log counts of 20 distinct values (about 20 tied runs a gene) over 4
    clusters, a few cells excluded; with ``window`` at most 30 positive
    cells a gene of 6 distinct values, for a 32-cell window."""
    rng = np.random.default_rng(9)
    G, N, K = 12, 80, 4
    counts = rng.integers(0, 20, size=(G, N))
    if window:
        counts = rng.integers(1, 7, size=(G, N))
        counts[:, 30:] = 0
        counts = rng.permuted(counts, axis=1)
    data = np.log1p(counts).astype(np.float32)
    cid = rng.integers(0, K, size=N).astype(np.int32)
    cid[:3] = -1
    n_of = np.bincount(cid[cid >= 0], minlength=K).astype(np.int32)
    pi, pj = np.triu_indices(K, k=1)
    return data, cid, n_of, pi.astype(np.int32), pj.astype(np.int32), K


@pytest.mark.parametrize("window,run_cap", [(0, 8), (0, ref_rs.RUN_CAP),
                                            (32, 4), (32, ref_rs.RUN_CAP)])
def test_the_runspace_body_equals_the_reference(window, run_cap):
    """The tied-run counts and the overflow flag exactly; log p at rtol
    1e-5 / atol 1e-6 and U and the tie sums exactly (rank sums of integer
    and half-integer counts, exact in float32). A small ``run_cap`` puts
    more tied runs in a gene than its table holds: the flag is set in both,
    and the merged tail runs give the same (invalid) statistics."""
    data, cid, n_of, pi, pj, K = _ranksum_case(window > 0)
    if window:
        assert ((data > 0).sum(axis=1) <= window).all()
    got = rs.ranksum_body_runspace(
        torch.from_numpy(data), torch.from_numpy(cid), torch.from_numpy(n_of),
        torch.from_numpy(pi), torch.from_numpy(pj), K, window=window,
        run_cap=run_cap)
    want = ref_rs.allpairs_ranksum_runspace_chunk(
        jnp.asarray(data), jnp.asarray(cid), jnp.asarray(n_of),
        jnp.asarray(pi), jnp.asarray(pj), K, window=window, run_cap=run_cap)
    lp, u, ties, n_truns = (t.numpy() for t in got)
    np.testing.assert_array_equal(n_truns, np.asarray(want[3]))
    over = n_truns > run_cap
    if run_cap < ref_rs.RUN_CAP:
        assert over.any()
    else:
        assert not over.any()
    np.testing.assert_allclose(lp, np.asarray(want[0]), rtol=1e-5,
                               atol=1e-6, equal_nan=True)
    np.testing.assert_array_equal(u, np.asarray(want[1]))
    np.testing.assert_array_equal(ties, np.asarray(want[2]))
    # where the table holds every run, the run-space statistic is the scan
    # body's
    scan = rs.ranksum_body(
        torch.from_numpy(data), torch.from_numpy(cid), torch.from_numpy(n_of),
        torch.from_numpy(pi), torch.from_numpy(pj), K, window=window)
    np.testing.assert_array_equal(u[~over], scan[1].numpy()[~over])
    np.testing.assert_array_equal(ties[~over], scan[2].numpy()[~over])


# --------------------------------------------------------------------------
# parallel/mesh.py, io/sparsemat.py
# --------------------------------------------------------------------------

def test_drain_if_cpu_mesh_keeps_the_reference_signature():
    """On a CPU mesh a Python shard loop cannot deadlock and a CPU tensor
    is ready when its operator returns: the call waits on no card and
    returns None."""
    import inspect

    assert list(inspect.signature(pmesh.drain_if_cpu_mesh).parameters) == \
        list(inspect.signature(ref_mesh.drain_if_cpu_mesh).parameters)
    mesh = pmesh.make_mesh(4, device="cpu")
    blocks, _ = pmesh.pad_and_shard(np.ones((9, 3), np.float32), mesh, 0)
    assert pmesh.drain_if_cpu_mesh(mesh, blocks, blocks[0]) is None
    with pytest.raises(TypeError, match="Mesh"):
        pmesh.drain_if_cpu_mesh("auto")
    assert "drain_if_cpu_mesh" in pmesh.__doc__


def test_is_jax_names_jax_arrays_without_importing_jax():
    x = jnp.ones(3)
    seen = []
    jax.jit(lambda y: seen.append(sparsemat.is_jax(y)) or y)(x)
    values = [x, jax.random.key(0), np.ones(3), torch.ones(3),
              sp.csr_matrix(np.eye(3)), 1.5, [1.0], None]
    assert [sparsemat.is_jax(v) for v in values] == \
        [ref_sparsemat.is_jax(v) for v in values] == \
        [True, True] + [False] * 6
    assert seen == [True]              # a tracer is a jax.Array too
    from scconsensus_tpu_torch import io

    assert io.is_jax is sparsemat.is_jax


# --------------------------------------------------------------------------
# obs/graphs.py
# --------------------------------------------------------------------------

def _reference_tests_hlo() -> str:
    """The optimized-HLO module the reference's own tests parse
    (``tests/test_obs_graphs.py`` ``_HLO``)."""
    path = os.path.join(REPO, "tests", "test_obs_graphs.py")
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.Assign) and \
                [t.id for t in node.targets] == ["_HLO"]:
            return ast.literal_eval(node.value)
    raise AssertionError("no _HLO in tests/test_obs_graphs.py")


def _captured_hlo() -> str:
    """A module JAX compiles here, with a host callback."""
    def f(x):
        y = jax.pure_callback(lambda a: np.asarray(a) * 2,
                              jax.ShapeDtypeStruct(x.shape, x.dtype), x)
        return jnp.sin(y) @ x.T

    return jax.jit(f).lower(jnp.ones((4, 4))).compile().as_text()


@pytest.mark.parametrize("source", ["reference_tests", "captured"])
def test_passport_from_hlo_equals_the_reference(source):
    text = _reference_tests_hlo() if source == "reference_tests" \
        else _captured_hlo()
    assert graphs.TRANSFER_OP_KINDS == ref_graphs.TRANSFER_OP_KINDS
    memory = {"argument_bytes": 64, "output_bytes": 64, "temp_bytes": 32,
              "alias_bytes": 16, "generated_code_bytes": 7}
    for kw in ({}, {"donated": 1}, {"donated": 2, "memory": memory},
               {"stage": "wilcox", "entry_ordinal": 2, "capture_s": 0.5,
                "cost": {"flops": 10}}):
        got = graphs.passport_from_hlo("p", text, **kw)
        assert got == ref_graphs.passport_from_hlo("p", text, **kw)
    assert got["ops"] > 0
    if source == "reference_tests":
        assert got["transfer_ops"]["count"] and got["host_callbacks"]["count"]
    else:
        assert got["host_callbacks"]["count"] == 1
