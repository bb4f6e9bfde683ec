"""The port's mesh (``scconsensus_tpu_torch/parallel/``) against the JAX
package on the CPU: a mirror of ``tests/test_parallel.py``. The port's
mesh is 8 shards on ``cpu`` (one process, a Python loop of shards); the
reference's is JAX's 8 virtual CPU devices from the suite's conftest.
Every sharded engine is held against the reference's engine and against
the port's serial form on the same seeded numpy input, with the
reference's tolerances; ``refine()`` on the mesh is held to the serial
run by ``assert_mesh_equals_serial`` and to the reference's mesh run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import scconsensus_tpu_torch as port
from scconsensus_tpu.config import ReclusterConfig as RefConfig
from scconsensus_tpu.models import pipeline as ref_pl
from scconsensus_tpu.obs.regress import adjusted_rand_index
from scconsensus_tpu.ops.gates import compute_aggregates as ref_aggregates
from scconsensus_tpu.ops.ranksum_allpairs import (
    allpairs_ranksum_chunk as ref_allpairs,
)
from scconsensus_tpu.ops.silhouette import (
    mean_cluster_silhouette as ref_mean_silhouette,
)
from scconsensus_tpu.ops.silhouette import silhouette_widths as ref_widths
from scconsensus_tpu.ops.wilcoxon import wilcoxon_pairs_tile as ref_tile
from scconsensus_tpu.parallel import mesh as ref_mesh_mod
from scconsensus_tpu.parallel import ring as ref_ring
from scconsensus_tpu.parallel import sharded_de as ref_sharded
from scconsensus_tpu.parallel import step as ref_step
from scconsensus_tpu.parallel import validate as ref_validate
from scconsensus_tpu.utils.synthetic import noisy_labeling, synthetic_scrna
from scconsensus_tpu_torch.carry import config_from_reference, omega_from_reference
from scconsensus_tpu_torch.models import pipeline as port_pipeline
from scconsensus_tpu_torch.ops.ranksum_allpairs import ranksum_body
from scconsensus_tpu_torch.ops import silhouette as port_sil
from scconsensus_tpu_torch.ops.silhouette import (
    mean_cluster_silhouette,
    multi_cut_silhouette,
    silhouette_widths,
)
from scconsensus_tpu_torch.ops.wilcoxon import wilcoxon_pairs_tile
from scconsensus_tpu_torch.parallel import (
    distributed_refine_step,
    make_mesh,
    ring_cluster_distance_sums,
    sharded_aggregates,
    sharded_silhouette_widths,
    sharded_wilcox_logp,
)
from scconsensus_tpu_torch.parallel import mesh as mesh_mod
from scconsensus_tpu_torch.parallel import ring as ring_mod
from scconsensus_tpu_torch.parallel.ring import ring_knn
from scconsensus_tpu_torch.parallel.sharded_de import sharded_allpairs_ranksum
from scconsensus_tpu_torch.parallel.step import (
    build_step_inputs,
    fused_refine_step,
)
from scconsensus_tpu_torch.parallel.validate import assert_mesh_equals_serial

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # the suite runs six workers on the machine's cores
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8, device="cpu")


@pytest.fixture(scope="module")
def ref_mesh():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    return ref_mesh_mod.make_mesh(8)


def _synthetic(rng, n=96, g=40, k=4):
    data = np.log1p(rng.poisson(1.5, size=(g, n))).astype(np.float32)
    labels = rng.integers(0, k, size=n)
    onehot = np.zeros((n, k), np.float32)
    onehot[np.arange(n), labels] = 1.0
    return data, labels, onehot


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_aggregates(got, want, fields=("sum_log", "sum_expm1", "sum_sq")):
    for f in fields:
        np.testing.assert_allclose(_np(getattr(got, f)),
                                   np.asarray(getattr(want, f)), rtol=1e-5)
    for f in ("nnz", "counts"):
        np.testing.assert_allclose(_np(getattr(got, f)),
                                   np.asarray(getattr(want, f)), rtol=0)


# --------------------------------------------------------------------------
# the mesh itself
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 4, 8])
def test_mesh_shape_meta_is_the_references_json(n, ref_mesh):
    ours = mesh_mod.mesh_shape_meta(make_mesh(n, device="cpu"))
    ref = ref_mesh_mod.mesh_shape_meta(ref_mesh_mod.make_mesh(n))
    assert ours == ref
    assert mesh_mod.mesh_device_ids(make_mesh(n, device="cpu")) == \
        ref_mesh_mod.mesh_device_ids(ref_mesh_mod.make_mesh(n))


def test_serial_shape_meta_is_the_references_json():
    assert mesh_mod.mesh_shape_meta(None) == ref_mesh_mod.mesh_shape_meta(None)
    assert mesh_mod.mesh_device_ids(None) == [0]


def test_auto_resolves_to_serial_on_the_cpu():
    assert mesh_mod.auto_mesh("cpu") is None
    from scconsensus_tpu_torch.robust.elastic import ElasticMeshSupervisor

    sup, m = ElasticMeshSupervisor.resolve("auto", torch.device("cpu"))
    assert m is None and sup.mesh is None and sup.device_ids() == [0]


def test_a_mesh_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("needs a host with no CUDA card")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(2, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh_mod.Mesh((torch.device("cuda"),), (0,))


def test_collectives_on_lists_of_shards(mesh):
    parts = [torch.full((3,), float(i)) for i in range(8)]
    summed = mesh_mod.psum(parts, mesh)
    assert len(summed) == 8
    assert all(torch.equal(s, torch.full((3,), 28.0)) for s in summed)
    rolled = mesh_mod.ppermute(parts, mesh)
    assert [float(b[0]) for b in rolled] == [7.0, 0, 1, 2, 3, 4, 5, 6]
    x = torch.arange(13 * 2, dtype=torch.float32).reshape(13, 2)
    blocks, n_pad = mesh_mod.pad_and_shard(x, mesh, 0, fill=-1)
    assert n_pad == 3 and [b.shape[0] for b in blocks] == [2] * 8
    back = mesh_mod.gather(blocks, 0)
    assert torch.equal(back[:13], x) and bool((back[13:] == -1).all())
    xp, n = mesh_mod.pad_axis_to_multiple(np.ones((3, 5)), 1, 4)
    assert xp.shape == (3, 8) and n == 3


def test_the_reference_exports_are_the_ports():
    from scconsensus_tpu import parallel as ref_parallel
    from scconsensus_tpu_torch import parallel as port_parallel

    assert port_parallel.__all__ == ref_parallel.__all__
    for name in ref_mesh_mod.__all__:
        assert hasattr(mesh_mod, name), name


def test_string_meshes_are_refused_below_refine(rng):
    x = rng.normal(size=(20, 3)).astype(np.float32)
    with pytest.raises(TypeError, match="Mesh"):
        ring_knn(x, 3, mesh="auto", device="cpu")
    with pytest.raises(TypeError, match="dense"):
        sharded_aggregates(sp.csr_matrix(x.T), np.ones((3, 1), np.float32),
                           make_mesh(2, device="cpu"))


# --------------------------------------------------------------------------
# the sharded engines against the reference's and the serial forms
# --------------------------------------------------------------------------

def test_sharded_aggregates_match_dense(rng, mesh, ref_mesh):
    data, _, onehot = _synthetic(rng)
    want = ref_aggregates(jnp.asarray(data), jnp.asarray(onehot))
    _same_aggregates(sharded_aggregates(data, onehot, mesh), want)
    _same_aggregates(ref_sharded.sharded_aggregates(data, onehot, ref_mesh),
                     want)


def test_sharded_aggregates_ragged_n(rng, mesh):
    data, _, onehot = _synthetic(rng, n=101)
    want = ref_aggregates(jnp.asarray(data), jnp.asarray(onehot))
    got = sharded_aggregates(data, onehot, mesh)
    _same_aggregates(got, want, fields=("sum_log",))


def test_sharded_aggregates_device_resident(rng, mesh):
    """A tensor input stays a tensor: padded and split where it lies."""
    data, _, onehot = _synthetic(rng, n=101)
    want = ref_aggregates(jnp.asarray(data), jnp.asarray(onehot))
    got = sharded_aggregates(torch.from_numpy(data),
                             torch.from_numpy(onehot), mesh)
    assert got.sum_log.device == CPU
    _same_aggregates(got, want, fields=("sum_log", "sum_sq"))


def test_sharded_aggregates_cid_form(rng, mesh, ref_mesh):
    """The cid form (one-hot built per shard) equals the one-hot form,
    excluded cells (−1) counting nowhere; n not a multiple of 8, so the
    −1 id padding runs."""
    data, labels, _ = _synthetic(rng, n=101)
    cid = labels.astype(np.int32).copy()
    cid[:7] = -1
    k = 4
    onehot = np.zeros((101, k), np.float32)
    v = cid >= 0
    onehot[np.nonzero(v)[0], cid[v]] = 1.0
    want = ref_aggregates(jnp.asarray(data), jnp.asarray(onehot))
    _same_aggregates(sharded_aggregates(data, mesh=mesh, cid=cid,
                                        n_clusters=k), want)
    _same_aggregates(sharded_aggregates(torch.from_numpy(data), mesh=mesh,
                                        cid=torch.from_numpy(cid),
                                        n_clusters=k), want)
    ref = ref_sharded.sharded_aggregates(data, mesh=ref_mesh, cid=cid,
                                         n_clusters=k)
    _same_aggregates(sharded_aggregates(data, mesh=mesh, cid=cid,
                                        n_clusters=k), ref)


def _one_bucket(data, labels):
    ci = np.nonzero(labels == 0)[0].astype(np.int32)
    cj = np.nonzero(labels == 1)[0].astype(np.int32)
    w = ci.size + cj.size
    idx = np.concatenate([ci, cj])[None, :]
    m1 = np.zeros((1, w), bool)
    m1[0, : ci.size] = True
    return (idx, m1, ~m1, np.array([ci.size], np.int32),
            np.array([cj.size], np.int32))


@pytest.mark.parametrize("g", [24, 26])
def test_sharded_wilcox_matches_serial(rng, mesh, ref_mesh, g):
    """g = 26 runs the gene-axis padding; the tile's midranks and tie
    sums are exact, so the port's serial tile equals the reference's."""
    data, labels, _ = _synthetic(rng, n=64, g=g, k=2)
    bucket = _one_bucket(data, labels)
    ref = np.asarray(jax.jit(ref_tile)(
        jnp.asarray(data), *(jnp.asarray(b) for b in bucket))[0])
    serial = wilcoxon_pairs_tile(torch.from_numpy(data),
                                 *(torch.from_numpy(b) for b in bucket))[0]
    np.testing.assert_allclose(serial.numpy(), ref, rtol=1e-4, atol=1e-4)
    got = sharded_wilcox_logp(data, *bucket, mesh)
    np.testing.assert_array_equal(got.numpy(), serial.numpy())
    np.testing.assert_allclose(
        got.numpy()[0], ref_sharded.sharded_wilcox_logp(
            data, *bucket, ref_mesh)[0], rtol=1e-4, atol=1e-4)


def test_sharded_wilcox_device_resident(rng, mesh):
    data, labels, _ = _synthetic(rng, n=64, g=26, k=2)
    bucket = _one_bucket(data, labels)
    want = sharded_wilcox_logp(data, *bucket, mesh)
    got = sharded_wilcox_logp(torch.from_numpy(data),
                              *(torch.from_numpy(b) for b in bucket), mesh)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_ring_sums_match_dense(rng, mesh, ref_mesh):
    x = rng.normal(size=(50, 5)).astype(np.float32)
    _, _, onehot = _synthetic(rng, n=50)
    d = np.sqrt(np.maximum(
        np.sum((x[:, None, :] - x[None, :, :]) ** 2, axis=-1), 0.0))
    got = ring_cluster_distance_sums(x, onehot, mesh).numpy()
    np.testing.assert_allclose(got, d @ onehot, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        got, ref_ring.ring_cluster_distance_sums(x, onehot, ref_mesh),
        rtol=1e-4, atol=1e-4)


def test_sharded_silhouette_matches_blocked(rng, mesh, ref_mesh):
    x = rng.normal(size=(70, 4)).astype(np.float32)
    labels = rng.integers(0, 3, size=70)
    labels[:5] = -1  # unassigned cells excluded
    got = sharded_silhouette_widths(x, labels, mesh)
    np.testing.assert_allclose(got, ref_widths(x, labels), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got, silhouette_widths(x, labels,
                                                      device="cpu"),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        got, ref_ring.sharded_silhouette_widths(x, labels, ref_mesh),
        rtol=1e-4, atol=1e-4)
    assert np.isnan(got[:5]).all()


def test_mean_silhouette_on_a_mesh_matches_the_references(rng, mesh,
                                                         ref_mesh):
    """The port's mesh silhouette (the kernel's sums on shard 0's device)
    against the reference's ring, cluster by cluster."""
    x = rng.normal(size=(70, 4)).astype(np.float32)
    labels = rng.integers(0, 3, size=70)
    labels[:5] = -1
    got, got_per = mean_cluster_silhouette(x, labels, device="cpu",
                                           mesh=mesh)
    want, want_per = ref_mean_silhouette(x, labels, mesh=ref_mesh)
    assert abs(got - want) < 1e-4
    assert got_per.keys() == want_per.keys()
    for c in want_per:
        assert abs(got_per[c] - want_per[c]) < 1e-4


def test_ring_tiles_keep_to_the_budget(rng, mesh, monkeypatch):
    """With a tile budget below one (local × visiting) block the ring
    sweeps the local rows in blocks: no tile passes the budget, and the
    sums and the kNN graph are those of whole-block steps."""
    x = rng.integers(0, 512, size=(83, 3)).astype(np.float32)
    _, _, onehot = _synthetic(rng, n=83)
    whole_sums = ring_cluster_distance_sums(x, onehot, mesh)
    whole_d, whole_i = ring_knn(x, 5, mesh)
    budget = 40                      # blocks of 11 rows: 3 rows a tile
    tiles = []
    tile = ring_mod.distance_tile

    def spy(a, b):
        tiles.append(a.shape[0] * b.shape[0])
        return tile(a, b)

    monkeypatch.setattr(ring_mod, "_TILE_ELEMS", budget)
    monkeypatch.setattr(ring_mod, "distance_tile", spy)
    sums = ring_cluster_distance_sums(x, onehot, mesh)
    d, i = ring_knn(x, 5, mesh)
    assert tiles and max(tiles) <= budget
    assert len(tiles) > 2 * 8 * 8    # more than one tile per shard and step
    torch.testing.assert_close(sums, whole_sums, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(i.numpy(), whole_i.numpy())
    torch.testing.assert_close(d, whole_d)


def test_ring_knn_matches_bruteforce(rng, mesh, ref_mesh):
    # integer coordinates: every float32 partial sum exact, so the tile's
    # distances are the brute force's and no tie decides the graph
    x = rng.integers(0, 512, size=(41, 3)).astype(np.float32)
    d = np.sqrt(np.sum((x[:, None, :].astype(np.float64)
                        - x[None, :, :]) ** 2, axis=-1))
    np.fill_diagonal(d, np.inf)
    k = 5
    assert (np.diff(np.sort(d, axis=1)[:, :k + 1], axis=1) > 0).all()
    ref_idx = np.argsort(d, axis=1)[:, :k]
    ref_d = np.take_along_axis(d, ref_idx, axis=1)
    got_d, got_i = ring_knn(x, k, mesh)
    np.testing.assert_allclose(got_d.numpy(), ref_d, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got_i.numpy(), ref_idx)
    r_d, r_i = ref_ring.ring_knn(x, k, ref_mesh)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(r_i))
    # the one-device sweep gives the same graph
    s_d, s_i = ring_knn(x, k, device="cpu")
    np.testing.assert_array_equal(s_i.numpy(), got_i.numpy())


def test_sharded_allpairs_ranksum_matches_serial(rng, mesh, ref_mesh):
    k = 4
    data, labels, _ = _synthetic(rng, n=90, g=26, k=k)  # g % 8 != 0
    cid = labels.astype(np.int32)
    n_of = np.array([(cid == c).sum() for c in range(k)], np.int32)
    pi, pj = (a.astype(np.int32) for a in np.triu_indices(k, k=1))
    args = (cid, n_of, pi, pj)
    serial = ranksum_body(torch.from_numpy(data),
                          *(torch.from_numpy(a) for a in args), k)
    got = sharded_allpairs_ranksum(data, *args, k, mesh=mesh)
    ref = ref_allpairs(jnp.asarray(data), *(jnp.asarray(a) for a in args), k)
    ref_m = ref_sharded.sharded_allpairs_ranksum(
        jnp.asarray(data), *(jnp.asarray(a) for a in args), k, mesh=ref_mesh)
    for s, g, r, rm in zip(serial, got, ref, ref_m):
        np.testing.assert_array_equal(g.numpy(), s.numpy())
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(rm), rtol=1e-5,
                                   atol=1e-5)


def test_sharded_allpairs_ranksum_compacted_cid(rng, mesh, ref_mesh):
    """Pre-compacted (Gc, W) int cid rows through the mesh: the gene-axis
    padding keeps the ids integers (−1) and the result is the serial
    windowed run's."""
    from scconsensus_tpu.de.engine import _all_pairs
    from scconsensus_tpu.io.sparsemat import csr_window_rows

    k, g, n = 3, 26, 256
    data = np.zeros((g, n), np.float32)
    for row in range(g):
        idx = rng.choice(n, size=40, replace=False)
        data[row, idx] = np.round(rng.gamma(2.0, size=40) * 4) / 4 + 0.25
    labels = rng.integers(0, k, n).astype(np.int32)
    w = 64
    vals, wcid = csr_window_rows(sp.csr_matrix(data), np.arange(g), w,
                                 labels)
    n_of = np.array([(labels == c).sum() for c in range(k)], np.int32)
    pi, pj = _all_pairs(k)
    serial = ranksum_body(torch.from_numpy(vals), torch.from_numpy(wcid),
                          torch.from_numpy(n_of), torch.from_numpy(pi),
                          torch.from_numpy(pj), k, window=w)
    got = sharded_allpairs_ranksum(vals, wcid, n_of, pi, pj, k, mesh=mesh,
                                   window=w)
    ref = ref_sharded.sharded_allpairs_ranksum(
        jnp.asarray(vals), jnp.asarray(wcid), jnp.asarray(n_of),
        jnp.asarray(pi), jnp.asarray(pj), k, mesh=ref_mesh, window=w)
    for s, gg, r in zip(serial, got, ref):
        np.testing.assert_array_equal(gg.numpy(), s.numpy())
        np.testing.assert_allclose(gg.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


# --------------------------------------------------------------------------
# the fused step
# --------------------------------------------------------------------------

def test_distributed_refine_step_runs(mesh, ref_mesh):
    inputs = build_step_inputs(n_cells=64, n_genes=48, n_clusters=3,
                               n_shards=8)
    ref_inputs = ref_step.build_step_inputs(n_cells=64, n_genes=48,
                                            n_clusters=3, n_shards=8)
    for key in inputs:
        np.testing.assert_array_equal(inputs[key], ref_inputs[key])
    names = ("data", "onehot", "pair_i", "pair_j", "idx", "m1", "m2", "n1",
             "n2")
    args = [inputs[n] for n in names]
    out = distributed_refine_step(mesh, n_pcs=4)(*args)
    g, n = inputs["data"].shape
    assert out["de_mask"].shape == (3, g)
    assert out["scores"].shape == (n, 4)
    assert out["sil_sums"].shape == (n, 3)
    assert bool(torch.isfinite(out["scores"]).all())
    # the step's silhouette sums against the standalone ring engine
    ring = ring_cluster_distance_sums(out["scores"], inputs["onehot"], mesh)
    np.testing.assert_allclose(out["sil_sums"].numpy(), ring.numpy(),
                               rtol=1e-3, atol=1e-3)
    # one body: the plain form computes the same step
    plain = fused_refine_step(n_pcs=4)(*args)
    for key in ("de_mask", "de_counts", "counts"):
        np.testing.assert_array_equal(out[key].numpy(), plain[key].numpy())
    np.testing.assert_allclose(out["log_q"].numpy(), plain["log_q"].numpy(),
                               rtol=1e-5, atol=1e-6)
    # and the reference's mesh step, up to its own PCA draw
    ref = ref_step.distributed_refine_step(ref_mesh, n_pcs=4)(
        *(jnp.asarray(a) for a in args))
    for key in ("de_mask", "de_counts", "counts"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]))
    np.testing.assert_allclose(out["log_q"].numpy(), np.asarray(ref["log_q"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out["log_fc"].numpy(),
                               np.asarray(ref["log_fc"]), rtol=1e-5,
                               atol=1e-5)


# --------------------------------------------------------------------------
# refine() on the mesh
# --------------------------------------------------------------------------

KW = dict(q_val_thrs=0.2, deep_split_values=(1, 2), min_cluster_size=5)
BRANCHES = {
    "fast": {},
    "knn": dict(approx_threshold=100, approx_method="knn", knn_graph_k=10),
    "landmark": dict(approx_threshold=100, landmark_threshold=100,
                     landmark_k=48, landmark_linkage="knn", knn_graph_k=8),
}


@pytest.fixture(scope="module")
def case():
    data, truth, _ = synthetic_scrna(n_genes=120, n_cells=240, n_clusters=3,
                                     seed=5, n_markers_per_cluster=8)
    return data, noisy_labeling(truth, 0.05, seed=1)


def _port_run(data, labels, mesh, **kw):
    return port.recluster_de_consensus_fast(data, labels, mesh=mesh,
                                            device="cpu", **{**KW, **kw})


def test_mesh_refine_matches_serial(case, mesh):
    data, labels = case
    mesh_res = _port_run(data, labels, mesh)
    ser_res = _port_run(data, labels, None)
    assert_mesh_equals_serial(mesh_res, ser_res)
    np.testing.assert_array_equal(mesh_res.de.log_p.numpy(),
                                  ser_res.de.log_p.numpy())
    assert mesh_res.metrics["wilcox_ladder"]["kernel"] == "mesh-scan"
    assert mesh_res.metrics["silhouette"] == {
        "method": "exact", "engine": "kernel", "n_shards": 8}
    # "auto" on the CPU is the serial run
    auto = _port_run(data, labels, "auto")
    assert_mesh_equals_serial(auto, ser_res)
    assert auto.metrics["wilcox_ladder"]["kernel"] == "scan"


def test_mesh_silhouette_takes_the_kernel_once(case, mesh, monkeypatch):
    """On a mesh every cut's silhouette comes from one call of the
    kernel's wrapper (its plain version here, on the CPU), never from
    the ring."""
    data, labels = case
    calls = []
    kernel = port_sil.distance_cluster_sums

    def spy(x, ids, k):
        calls.append(tuple(ids.shape))
        return kernel(x, ids, k)

    def no_ring(*a, **kw):
        raise AssertionError("the silhouette took the ring")

    monkeypatch.setattr(port_sil, "distance_cluster_sums", spy)
    monkeypatch.setattr(ring_mod, "ring_cluster_distance_sums", no_ring)
    res = _port_run(data, labels, mesh)
    assert calls == [(data.shape[1], len(KW["deep_split_values"]))]
    assert res.metrics["silhouette"]["engine"] == "kernel"


def test_mesh_refine_sparse_matches_serial(case, mesh):
    data, labels = case
    sdata = sp.csr_matrix(data)
    mesh_res = _port_run(sdata, labels, mesh)
    assert_mesh_equals_serial(mesh_res, _port_run(sdata, labels, None))
    # and sparse on the mesh == dense on the mesh
    assert_mesh_equals_serial(mesh_res, _port_run(data, labels, mesh))


@pytest.mark.parametrize("branch", ["knn", "landmark"])
def test_mesh_branches_match_serial(case, mesh, branch):
    """Past ``approx_threshold`` the serial silhouette is the pooled
    estimator and the mesh's the exact one (the reference's rule), so
    the branches are held with the silhouette off, and the mesh's
    silhouettes against the exact serial ones of the same cuts."""
    data, labels = case
    kw = BRANCHES[branch]
    off = port.CompatFlags(return_silhouette=False)
    assert_mesh_equals_serial(_port_run(data, labels, mesh, compat=off, **kw),
                              _port_run(data, labels, None, compat=off, **kw))
    res = _port_run(data, labels, mesh, **kw)
    labs = [np.where(res.dynamic_labels[f"deepsplit: {d}"] > 0,
                     res.dynamic_labels[f"deepsplit: {d}"], -1)
            for d in KW["deep_split_values"]]
    exact = multi_cut_silhouette(torch.from_numpy(res.embedding), labs)
    for info, (si, _) in zip(res.deep_split_info, exact):
        assert abs(info["silhouette"] - si) < 1e-4
    assert res.metrics["tree"]["approx"] is True


def _ref_and_port_mesh_runs(data, labels, mesh, ref_mesh, **kw):
    """The reference's mesh run and the port's, the port handed the
    reference's config (as JSON) and PCA scores, so that the tree, the
    cuts and the silhouette start from the same points."""
    ref = ref_pl.recluster_de_consensus_fast(data, labels, mesh=ref_mesh,
                                             **{**KW, **kw})
    cfg = config_from_reference(RefConfig(
        method="wilcox", q_val_thrs=KW["q_val_thrs"],
        deep_split_values=KW["deep_split_values"],
        min_cluster_size=KW["min_cluster_size"], **kw).to_json())
    f = ref.de_gene_union_idx.size
    omega = np.asarray(jax.random.normal(
        jax.random.PRNGKey(0), (f, min(cfg.n_pcs + 10, f, data.shape[1])),
        jnp.float32))
    own = port.refine(data, labels, cfg, device="cpu", mesh=mesh,
                      omega=omega_from_reference(omega))
    with pytest.MonkeyPatch.context() as mp:
        scores = torch.from_numpy(np.array(ref.embedding))
        mp.setattr(port_pipeline, "pca_scores",
                   lambda cells, n_pcs, omega=None: scores)
        same = port.refine(data, labels, cfg, device="cpu", mesh=mesh)
    return ref, own, same


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_mesh_refine_equals_the_references_mesh_run(case, mesh, ref_mesh,
                                                    branch):
    data, labels = case
    ref, own, same = _ref_and_port_mesh_runs(data, labels, mesh, ref_mesh,
                                             **BRANCHES[branch])
    for got in (own, same):
        np.testing.assert_array_equal(got.de_gene_union_idx,
                                      ref.de_gene_union_idx)
        np.testing.assert_array_equal(got.de.de_mask.numpy(),
                                      np.asarray(ref.de.de_mask))
        np.testing.assert_allclose(got.de.log_p.numpy(),
                                   np.asarray(ref.de.log_p), rtol=1e-4,
                                   atol=1e-4)
    # from the same points: the same cuts, and the port's kernel
    # silhouettes equal the reference's ring ones
    assert_mesh_equals_serial(same, ref)
    for key in ref.dynamic_labels:
        assert adjusted_rand_index(own.dynamic_labels[key],
                                   ref.dynamic_labels[key]) == 1.0, key


def test_validate_is_pinned_to_the_references(case):
    """The copied contract accepts and refuses what the reference's does:
    log p within 1e-4, masks, union and labels exact, silhouettes within
    1e-4."""
    data, labels = case
    a = ref_pl.recluster_de_consensus_fast(data, labels, mesh=None, **KW)
    b = ref_pl.recluster_de_consensus_fast(data, labels, mesh=None, **KW)
    ref_validate.assert_mesh_equals_serial(a, b)
    assert_mesh_equals_serial(a, b)
    from dataclasses import replace

    for damage in ("logp", "mask", "union", "labels", "silhouette"):
        de, union = b.de, b.de_gene_union_idx
        labs, info = dict(b.dynamic_labels), [dict(d)
                                              for d in b.deep_split_info]
        if damage == "logp":
            de = replace(de, log_p=np.asarray(de.log_p) + 1.0)
        elif damage == "mask":
            m = np.array(de.de_mask)
            m[0, 0] = ~m[0, 0]
            de = replace(de, de_mask=m)
        elif damage == "union":
            union = union[1:]
        elif damage == "labels":
            key = next(iter(labs))
            labs[key] = labs[key] + 1
        else:
            info[0]["silhouette"] += 2e-4
        c = replace(b, de=de, de_gene_union_idx=union, dynamic_labels=labs,
                    deep_split_info=info)
        with pytest.raises(AssertionError):
            ref_validate.assert_mesh_equals_serial(c, a)
        with pytest.raises(AssertionError):
            assert_mesh_equals_serial(c, a)


def test_streaming_input_runs_serially_whatever_the_mesh(tmp_path, mesh,
                                                        monkeypatch):
    """A chunk store routes to streaming_refine with no mesh, as the
    reference's runner does."""
    from scconsensus_tpu_torch.stream import runner
    from scconsensus_tpu_torch.stream.store import ChunkedCSRStore

    seen = {}

    def fake(data, labels, config, **kw):
        seen.update(kw)
        return "streamed"

    monkeypatch.setattr(runner, "streaming_refine", fake)
    store = ChunkedCSRStore.create(str(tmp_path / "s"), 40, 60, 8)
    assert port.refine(store, np.zeros(60), port.ReclusterConfig(),
                       device="cpu", mesh=mesh) == "streamed"
    assert "mesh" not in seen and seen["device"] == "cpu"
