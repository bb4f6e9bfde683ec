"""The port's mesh across two processes, on the CPU: the counterpart of
``tests/test_multihost.py`` and ``tests/multihost_worker.py``.

Two OS processes join one gloo group (``torch.distributed``) and each
builds ``make_mesh(8, device="cpu")``: an 8-shard mesh whose shards split
4 and 4 across the processes, so every ``psum``, ``ppermute`` and
``gather`` crosses the process boundary. Each process runs the reference
worker's checks at its sizes (G = 48, N = 96, K = 4, seed 0), held
against the reference's serial results, which this file's test computes
with JAX and hands over in a file: the cell-sharded aggregates at rtol
1e-5 with exact counts, and the gene-sharded all-pairs rank sum, log p at
rtol 1e-5 / atol 1e-6 and U at rtol 1e-5. Beyond the reference worker it
holds the collectives to a one-process mesh of the same 8 shards bit for
bit (the psum's shard-order additions, the ring's rotation), the
device-resident branch of ``pad_and_shard``, and a ``refine()`` at 400
cells on the 2-process mesh against the serial run
(``parallel.validate.assert_mesh_equals_serial``) and against a
one-process 8-shard mesh (one ``labels_sha``).

The worker is this file run as a script (``python
tests/test_torch_multihost.py <port> <rank> <reference.npz>``); it
imports the port only (``tests/test_torch_scaffold.py`` scans it), and
each runs under a ``timeout`` of its own.
"""

import hashlib
import json
import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G, N, K = 48, 96, 4
SHARDS, PROCS = 8, 2
REFINE_SHAPE = dict(n_genes=200, n_cells=400, n_clusters=4, seed=5)
WORKER_TIMEOUT_S = 90


def _inputs():
    """The reference worker's draw (tests/multihost_worker.py:52-58)."""
    rng = np.random.default_rng(0)  # same seed → same data in every process
    data = np.log1p(rng.poisson(1.5, size=(G, N))).astype(np.float32)
    labels = rng.integers(0, K, size=N)
    onehot = np.zeros((N, K), np.float32)
    onehot[np.arange(N), labels] = 1.0
    return data, labels, onehot


def _labels_sha(dynamic_labels) -> str:
    h = hashlib.sha256()
    for key in sorted(dynamic_labels):
        h.update(key.encode())
        h.update(np.asarray(dynamic_labels[key], np.int64).tobytes())
    return h.hexdigest()


def _refine_case():
    from scconsensus_tpu_torch.utils.synthetic import synthetic_scrna

    data, truth, _ = synthetic_scrna(**REFINE_SHAPE)
    return data, np.array([f"c{v}" for v in truth])


def _worker_main(port: int, rank: int, ref_path: str) -> None:
    # the worker runs the port alone
    sys.modules["jax"] = None
    sys.modules["scconsensus_tpu"] = None
    sys.path.insert(0, REPO)
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=PROCS, rank=rank,
                            timeout=timedelta(seconds=60))
    import scconsensus_tpu_torch as port_pkg
    from scconsensus_tpu_torch.parallel import mesh as pmesh
    from scconsensus_tpu_torch.parallel.ring import (
        ring_cluster_distance_sums,
        ring_knn,
    )
    from scconsensus_tpu_torch.parallel.sharded_de import (
        sharded_aggregates,
        sharded_allpairs_ranksum,
    )
    from scconsensus_tpu_torch.parallel.validate import (
        assert_mesh_equals_serial,
    )

    ref = np.load(ref_path)
    mesh = pmesh.make_mesh(SHARDS, device="cpu")
    assert (mesh.size, mesh.procs, mesh.rank) == (SHARDS, PROCS, rank)
    assert list(mesh.local) == list(range(rank * 4, rank * 4 + 4))
    assert pmesh.mesh_shape_meta(mesh)["device_ids"] == list(range(SHARDS))
    # the same 8 shards in one process: the bits the collectives must give
    one = pmesh.Mesh(mesh.devices, mesh.ids)
    data, labels, onehot = _inputs()

    # ---- cell-sharded aggregates: psum crosses the process boundary ----
    got = sharded_aggregates(data, onehot, mesh)
    np.testing.assert_allclose(got.sum_log.numpy(), ref["sum_log"],
                               rtol=1e-5)
    np.testing.assert_allclose(got.counts.numpy(), ref["counts"], rtol=0)
    fields = ("sum_log", "sum_expm1", "sum_sq", "nnz", "counts")
    same = sharded_aggregates(data, onehot, one)
    by_cid = sharded_aggregates(data, mesh=mesh, cid=labels, n_clusters=K)
    for f in fields:
        assert torch.equal(getattr(got, f), getattr(same, f)), f
        assert torch.equal(getattr(got, f), getattr(by_cid, f)), f

    # ---- gene-sharded all-pairs rank sum: gathered across processes ----
    n_of = np.bincount(labels, minlength=K).astype(np.int32)
    pi, pj = np.triu_indices(K, k=1)
    cid = labels.astype(np.int32)
    lp, u, ts = sharded_allpairs_ranksum(data, cid, n_of, pi, pj, K,
                                         mesh=mesh)
    np.testing.assert_allclose(lp.numpy(), ref["lp"], rtol=1e-5, atol=1e-6,
                               equal_nan=True)
    np.testing.assert_allclose(u.numpy(), ref["u"], rtol=1e-5)
    for a, b in zip((lp, u, ts), sharded_allpairs_ranksum(
            data, cid, n_of, pi, pj, K, mesh=one)):
        assert torch.equal(a.nan_to_num(-7.0), b.nan_to_num(-7.0))

    # ---- the ring: ppermute's boundary blocks cross the processes -------
    x = np.random.default_rng(1).normal(size=(N, 5)).astype(np.float32)
    sums = ring_cluster_distance_sums(x, onehot, mesh)
    assert torch.equal(sums, ring_cluster_distance_sums(x, onehot, one))
    d, i = ring_knn(x, 6, mesh=mesh)
    d1, i1 = ring_knn(x, 6, mesh=one)
    assert torch.equal(d, d1) and torch.equal(i, i1)

    # ---- pad_and_shard keeps the local blocks, host or tensor input ----
    t = torch.from_numpy(x[:90])
    blocks, n_pad = pmesh.pad_and_shard(t, mesh, 0)
    whole, _ = pmesh.pad_and_shard(x[:90], one, 0)
    assert n_pad == 6 and len(blocks) == 4
    for b, w in zip(blocks, whole[rank * 4:rank * 4 + 4]):
        assert torch.equal(b, w)
    sent = dict(pmesh.SENT_BYTES)
    assert all(v > 0 for v in sent.values()), sent

    # ---- refine() on the 2-process mesh against the serial run ---------
    rdata, rlabels = _refine_case()
    cfg = port_pkg.ReclusterConfig()
    gathered = pmesh.SENT_BYTES["gather"]
    on_mesh = port_pkg.refine(rdata, rlabels, cfg, device="cpu", mesh=mesh)
    # the rank-sum buckets' results crossed the group
    assert pmesh.SENT_BYTES["gather"] > gathered
    serial = port_pkg.refine(rdata, rlabels, cfg, device="cpu", mesh=None)
    assert_mesh_equals_serial(on_mesh, serial)
    assert on_mesh.metrics["wilcox_ladder"]["kernel"] == "mesh-scan"
    dist.barrier()
    dist.destroy_process_group()
    print("MULTIHOST_OK " + json.dumps({
        "rank": rank, "sent_bytes": sent,
        "labels_sha": _labels_sha(on_mesh.dynamic_labels),
        "serial_sha": _labels_sha(serial.dynamic_labels)}), flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _reference_results(path: str) -> None:
    """The reference's serial aggregates and rank sum on the inputs."""
    import jax.numpy as jnp

    from scconsensus_tpu.ops.gates import compute_aggregates
    from scconsensus_tpu.ops.ranksum_allpairs import allpairs_ranksum_chunk

    data, labels, onehot = _inputs()
    agg = compute_aggregates(jnp.asarray(data), jnp.asarray(onehot))
    n_of = np.bincount(labels, minlength=K).astype(np.int32)
    pi, pj = np.triu_indices(K, k=1)
    lp, u, _ = allpairs_ranksum_chunk(
        jnp.asarray(data), jnp.asarray(labels.astype(np.int32)),
        jnp.asarray(n_of), jnp.asarray(pi.astype(np.int32)),
        jnp.asarray(pj.astype(np.int32)), K)
    np.savez(path, sum_log=np.asarray(agg.sum_log),
             counts=np.asarray(agg.counts), lp=np.asarray(lp),
             u=np.asarray(u))


def test_two_process_mesh_matches_the_reference_and_one_process(tmp_path):
    import torch

    import scconsensus_tpu_torch as port_pkg
    from scconsensus_tpu_torch.parallel.mesh import make_mesh

    ref_path = str(tmp_path / "reference.npz")
    _reference_results(ref_path)
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MASTER_", "RANK", "WORLD_SIZE"))}
    procs = [subprocess.Popen(
        ["timeout", "-k", "5", str(WORKER_TIMEOUT_S), sys.executable,
         os.path.abspath(__file__), str(port), str(rank), ref_path],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(PROCS)]
    # meanwhile, the one-process 8-shard mesh's refine
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        rdata, rlabels = _refine_case()
        one = port_pkg.refine(rdata, rlabels, port_pkg.ReclusterConfig(),
                              device="cpu",
                              mesh=make_mesh(SHARDS, device="cpu"))
    finally:
        torch.set_num_threads(n)
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=WORKER_TIMEOUT_S + 30)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    got = []
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
        line = [ln for ln in out.splitlines()
                if ln.startswith("MULTIHOST_OK ")]
        assert line, f"rank {rank} output:\n{out[-4000:]}"
        got.append(json.loads(line[-1][len("MULTIHOST_OK "):]))
    sha = _labels_sha(one.dynamic_labels)
    assert {g["labels_sha"] for g in got} == {sha}
    assert {g["serial_sha"] for g in got} == {sha}
    # each rank sent its half: the two ranks' counts agree
    assert got[0]["sent_bytes"] == got[1]["sent_bytes"]


if __name__ == "__main__":
    _worker_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
