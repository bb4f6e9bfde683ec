"""The mesh over every rank's devices, on the CPU: ``mesh="auto"``,
``make_mesh(n)`` and ``make_mesh(devices=...)`` across two processes, and
a device loss across them as the reference runs it.

Two port workers join one gloo group (``torch.distributed``); beside them
two reference workers join one ``jax.distributed`` cluster with 4 virtual
CPU devices each, as ``tests/multihost_worker.py`` does. Held:

* ``auto_mesh("cpu")`` is 2 shards, one a rank (one CPU device a
  process, JAX's default), with the stamp of ``make_mesh(2,
  device="cpu")`` across the two ranks;
* ``make_mesh(devices=["cpu"] * 4)`` is the reference worker's 8-shard
  mesh, 4 a rank, and its checks pass on it (the cell-sharded aggregates
  at rtol 1e-5 with exact counts, the gene-sharded all-pairs rank sum at
  rtol 1e-5 / atol 1e-6, against the reference's serial results, which
  this file's fixture computes with JAX); ``make_mesh(n)`` takes the
  first n of the global list (each rank's visible devices stood in for
  by 4 CPU entries, as 4 cards a rank);
* a list that gives the ranks different shard counts raises
  ``ValueError``;
* ``refine()`` with the default mesh equals the serial run on both ranks
  (``assert_mesh_equals_serial``: log p within 1e-4, every discrete
  decision exact), where the reference's raises at
  ``scconsensus_tpu/parallel/ring.py:95`` (ROADMAP C30);
* an injected ``device_loss`` at ``stage:silhouette``: rank 0 records
  the halving onto the lowest ids and gives the serial labels, rank 1
  raises ``DeviceLossUnrecoverable``; at 4 shards a rank, rank 0's
  ``to_devices`` and labels equal the reference's process 0 (its ids
  ``[0..3, 2048..2051]`` → ``[0..3]``; the port's ids are positions,
  ``[0..7]``), and the reference's process 1 fails on JAX's
  non-addressable fetch.

Both packages' refines take the same PCA projection (the reference's
``PRNGKey(0)`` draw, handed over in a file), so their labels compare
exactly. The port worker is this file run as a script (``python
tests/test_torch_multihost_auto.py port <port> <rank> <dir>``) and
imports the port only (``tests/test_torch_scaffold.py`` scans it); the
reference worker is ``... reference <coordinator> <pid> <dir>``. Each
runs under a ``timeout`` of its own.
"""

import hashlib
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G, N, K = 48, 96, 4
REFINE_SHAPE = dict(n_genes=200, n_cells=400, n_clusters=4, seed=5)
PROCS, PER_RANK = 2, 4
PLAN = {"faults": [{"site": "stage:silhouette", "class": "device_loss"}]}
WORKER_TIMEOUT_S = 90


def _inputs():
    """The reference worker's draw (tests/multihost_worker.py:52-58)."""
    rng = np.random.default_rng(0)
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


def _labels_json(dynamic_labels) -> dict:
    return {k: np.asarray(v).tolist() for k, v in dynamic_labels.items()}


def _mesh_view(mesh) -> dict:
    from scconsensus_tpu_torch.parallel.mesh import mesh_shape_meta

    return {"size": mesh.size, "procs": mesh.procs, "rank": mesh.rank,
            "local": list(mesh.local), "ids": list(mesh.ids),
            "meta": mesh_shape_meta(mesh)}


def _raises(fn, exc) -> str:
    """The message of the ``exc`` that ``fn()`` raises."""
    try:
        fn()
    except exc as e:
        return str(e)
    raise AssertionError(f"{fn} raised no {exc.__name__}")


def _port_checks(rank: int, root: str) -> dict:
    """Every check of one port rank (the group is initialized)."""
    import torch

    import scconsensus_tpu_torch as port_pkg
    from scconsensus_tpu_torch.parallel import mesh as pmesh
    from scconsensus_tpu_torch.parallel.sharded_de import (
        sharded_aggregates,
        sharded_allpairs_ranksum,
    )
    from scconsensus_tpu_torch.parallel.validate import (
        assert_mesh_equals_serial,
    )
    from scconsensus_tpu_torch.robust import faults
    from scconsensus_tpu_torch.robust.elastic import DeviceLossUnrecoverable
    from scconsensus_tpu_torch.utils.synthetic import synthetic_scrna

    out = {"rank": rank}
    ref = np.load(os.path.join(root, "reference.npz"))

    # ---- mesh="auto": one CPU device a rank ----------------------------
    out["auto"] = _mesh_view(pmesh.auto_mesh("cpu"))
    out["two"] = _mesh_view(pmesh.make_mesh(2, device="cpu"))

    # ---- the reference worker's mesh from device lists -----------------
    eight = pmesh.make_mesh(devices=["cpu"] * PER_RANK)
    out["eight"] = _mesh_view(eight)
    data, labels, onehot = _inputs()
    got = sharded_aggregates(data, onehot, eight)
    np.testing.assert_allclose(got.sum_log.numpy(), ref["sum_log"],
                               rtol=1e-5)
    np.testing.assert_allclose(got.counts.numpy(), ref["counts"], rtol=0)
    n_of = np.bincount(labels, minlength=K).astype(np.int32)
    pi, pj = np.triu_indices(K, k=1)
    lp, u, _ = sharded_allpairs_ranksum(data, labels.astype(np.int32), n_of,
                                        pi, pj, K, mesh=eight)
    np.testing.assert_allclose(lp.numpy(), ref["lp"], rtol=1e-5, atol=1e-6,
                               equal_nan=True)
    np.testing.assert_allclose(u.numpy(), ref["u"], rtol=1e-5)

    # make_mesh(n): the first n of the global list, each rank's visible
    # devices stood in for by 4 CPU entries (4 cards a rank)
    visible = pmesh._visible_devices
    pmesh._visible_devices = lambda kind: [torch.device("cpu")] * PER_RANK
    try:
        out["first_8"] = _mesh_view(pmesh.make_mesh(8))
        out["all"] = _mesh_view(pmesh.make_mesh())
        # the first 4 are rank 0's: rank 1 would hold no shard
        out["first_4_error"] = _raises(lambda: pmesh.make_mesh(4),
                                       ValueError)
    finally:
        pmesh._visible_devices = visible

    # ---- lists that give the ranks different shard counts --------------
    out["uneven_error"] = _raises(
        lambda: pmesh.make_mesh(devices=["cpu"] * (rank + 1)), ValueError)
    out["first_6_error"] = _raises(
        lambda: pmesh.make_mesh(6, devices=["cpu"] * PER_RANK), ValueError)

    # ---- refine(): the default mesh against the serial run -------------
    rdata, truth, _ = synthetic_scrna(**REFINE_SHAPE)
    rlabels = np.array([f"c{v}" for v in truth])
    omega = torch.from_numpy(np.load(os.path.join(root, "omega.npy")))
    cfg = port_pkg.ReclusterConfig()
    serial = port_pkg.refine(rdata, rlabels, cfg, device="cpu", mesh=None,
                             omega=omega)
    on_auto = port_pkg.refine(rdata, rlabels, cfg, device="cpu",
                              omega=omega)
    assert_mesh_equals_serial(on_auto, serial)
    out["serial_sha"] = _labels_sha(serial.dynamic_labels)
    out["auto_sha"] = _labels_sha(on_auto.dynamic_labels)
    out["auto_kernel"] = on_auto.metrics["wilcox_ladder"]["kernel"]
    out["auto_silhouette"] = on_auto.metrics["silhouette"]

    # ---- ranks that pass different inputs: refused on every rank ------
    out["other_data_error"] = _raises(lambda: port_pkg.refine(
        rdata * (1 + rank), rlabels, cfg, device="cpu", omega=omega),
        ValueError)
    out["other_labels_error"] = _raises(lambda: port_pkg.refine(
        rdata, np.roll(rlabels, rank), cfg, device="cpu", omega=omega),
        ValueError)

    # ---- an injected device loss, on the auto mesh and at 4 a rank -----
    os.environ["SCC_FAULT_PLAN"] = os.path.join(root, "plan.json")
    for name, mesh in (("loss_auto", lambda: "auto"),
                       ("loss_eight", lambda: pmesh.make_mesh(
                           devices=["cpu"] * PER_RANK))):
        faults.reset()
        try:
            res = port_pkg.refine(rdata, rlabels, cfg, device="cpu",
                                  mesh=mesh(), omega=omega)
        except DeviceLossUnrecoverable as e:
            out[name] = {"raised": type(e).__name__, "message": str(e)}
            continue
        assert_mesh_equals_serial(res, serial)
        out[name] = {
            "transitions": res.metrics["robustness"]["mesh_transitions"],
            "labels_sha": _labels_sha(res.dynamic_labels),
            "labels": _labels_json(res.dynamic_labels)}
    del os.environ["SCC_FAULT_PLAN"]
    return out


def _worker_main(port: int, rank: int, root: str) -> None:
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
    out = _port_checks(rank, root)
    dist.destroy_process_group()
    print("MULTIHOST_AUTO_OK " + json.dumps(out), flush=True)


def _reference_worker_main(coordinator: str, pid: int, root: str) -> None:
    """The reference's refine() with the default mesh, then under the
    device-loss plan, in one of two JAX processes with 4 CPU devices
    each; each outcome recorded with the file and line it raised at."""
    import traceback

    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4")
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, REPO)
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=PROCS, process_id=pid)
    from scconsensus_tpu.config import ReclusterConfig
    from scconsensus_tpu.models.pipeline import refine
    from scconsensus_tpu.robust import faults
    from scconsensus_tpu.utils.synthetic import synthetic_scrna

    rdata, truth, _ = synthetic_scrna(**REFINE_SHAPE)
    rlabels = np.array([f"c{v}" for v in truth])

    def run():
        try:
            res = refine(rdata, rlabels, ReclusterConfig())
        except RuntimeError as e:
            frames = [(os.path.relpath(f.filename, REPO), f.lineno)
                      for f in traceback.extract_tb(e.__traceback__)]
            return {"raised": type(e).__name__, "message": str(e),
                    "frames": frames}
        return {"transitions": res.metrics["robustness"]["mesh_transitions"],
                "labels": _labels_json(res.dynamic_labels)}

    out = {"pid": pid, "n_devices": len(jax.devices()), "auto": run()}
    os.environ["SCC_FAULT_PLAN"] = os.path.join(root, "plan.json")
    faults.reset()
    out["loss"] = run()
    print("REFERENCE_OK " + json.dumps(out), flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _reference_inputs(root: str) -> None:
    """The reference's serial aggregates and rank sum on the worker's
    inputs, and its PCA projection draw for the refine case (PRNGKey(0),
    (F, min(n_pcs + 10, F, N)), F the DE-gene union's size)."""
    import jax
    import jax.numpy as jnp

    import scconsensus_tpu_torch as port_pkg
    from scconsensus_tpu.ops.gates import compute_aggregates
    from scconsensus_tpu.ops.ranksum_allpairs import allpairs_ranksum_chunk
    from scconsensus_tpu_torch.de.engine import de_gene_union, pairwise_de
    from scconsensus_tpu_torch.utils.synthetic import synthetic_scrna

    data, labels, onehot = _inputs()
    agg = compute_aggregates(jnp.asarray(data), jnp.asarray(onehot))
    n_of = np.bincount(labels, minlength=K).astype(np.int32)
    pi, pj = np.triu_indices(K, k=1)
    lp, u, _ = allpairs_ranksum_chunk(
        jnp.asarray(data), jnp.asarray(labels.astype(np.int32)),
        jnp.asarray(n_of), jnp.asarray(pi.astype(np.int32)),
        jnp.asarray(pj.astype(np.int32)), K)
    np.savez(os.path.join(root, "reference.npz"),
             sum_log=np.asarray(agg.sum_log), counts=np.asarray(agg.counts),
             lp=np.asarray(lp), u=np.asarray(u))
    rdata, truth, _ = synthetic_scrna(**REFINE_SHAPE)
    cfg = port_pkg.ReclusterConfig()
    de = pairwise_de(rdata, np.array([f"c{v}" for v in truth]), cfg,
                     device="cpu")
    f = int(de_gene_union(de, cfg.n_top_de_genes).size)
    k = min(cfg.n_pcs + 10, f, rdata.shape[1])
    np.save(os.path.join(root, "omega.npy"), np.asarray(
        jax.random.normal(jax.random.PRNGKey(0), (f, k), jnp.float32)))
    with open(os.path.join(root, "plan.json"), "w") as fh:
        json.dump(PLAN, fh)


def _collect(procs, tag: str) -> list:
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=WORKER_TIMEOUT_S + 30)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    got = []
    for rank, (p, out) in enumerate(zip(procs, outs)):
        line = [ln for ln in out.splitlines() if ln.startswith(tag + " ")]
        assert p.returncode == 0 and line, \
            f"{tag} worker {rank} (exit {p.returncode}):\n{out[-4000:]}"
        got.append(json.loads(line[-1][len(tag) + 1:]))
    return got


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' two-process runs, started together."""
    root = str(tmp_path_factory.mktemp("multihost_auto"))
    _reference_inputs(root)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MASTER_", "RANK", "WORLD_SIZE",
                                "SCC_FAULT_PLAN"))}
    # the reference worker pins its own platform and device count
    ref_env = {k: v for k, v in env.items()
               if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    me = os.path.abspath(__file__)
    port, coord = _free_port(), f"127.0.0.1:{_free_port()}"
    workers = [subprocess.Popen(
        ["timeout", "-k", "5", str(WORKER_TIMEOUT_S), sys.executable, me,
         "port", str(port), str(rank), root],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(PROCS)]
    refs = [subprocess.Popen(
        ["timeout", "-k", "5", str(WORKER_TIMEOUT_S), sys.executable, me,
         "reference", coord, str(pid), root],
        env=ref_env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pid in range(PROCS)]
    try:
        port_out = _collect(workers, "MULTIHOST_AUTO_OK")
    finally:
        ref_out = _collect(refs, "REFERENCE_OK")
    return {"port": port_out, "reference": ref_out}


def test_auto_mesh_is_one_shard_a_rank_with_the_stamp_of_make_mesh_2(runs):
    for rank, out in enumerate(runs["port"]):
        auto = out["auto"]
        assert (auto["size"], auto["procs"], auto["rank"]) == (2, 2, rank)
        assert auto["local"] == [rank] and auto["ids"] == [0, 1]
        assert auto["meta"] == out["two"]["meta"] == {
            "n_devices": 2, "device_ids": [0, 1], "axis": "cells",
            "platform": "cpu"}


def test_make_mesh_joins_the_ranks_device_lists_in_rank_order(runs):
    for rank, out in enumerate(runs["port"]):
        local = list(range(rank * PER_RANK, (rank + 1) * PER_RANK))
        for key in ("eight", "first_8", "all"):
            m = out[key]
            assert (m["size"], m["procs"], m["rank"]) == (8, 2, rank), key
            assert m["local"] == local and m["ids"] == list(range(8)), key
            assert m["meta"]["device_ids"] == list(range(8)), key
    # the reference's own worker builds this mesh from 8 devices, 4 a
    # process (its checks ran on the port's in each worker)
    assert all(r["n_devices"] == 8 for r in runs["reference"])


@pytest.mark.parametrize("key,counts", [
    ("uneven_error", "[1, 2]"), ("first_6_error", "[4, 2]"),
    ("first_4_error", "[4, 0]")])
def test_a_list_that_splits_unevenly_raises(runs, key, counts):
    for out in runs["port"]:
        assert "same number of shards on every rank" in out[key]
        assert f"give the ranks {counts}" in out[key]


def test_refine_with_the_default_mesh_gives_the_serial_labels(runs):
    port = runs["port"]
    assert {o["auto_sha"] for o in port} == {port[0]["serial_sha"]}
    assert {o["serial_sha"] for o in port} == {port[0]["serial_sha"]}
    for out in port:
        assert out["auto_kernel"] == "mesh-scan"
        assert out["auto_silhouette"]["n_shards"] == 2


@pytest.mark.parametrize("key", ["other_data_error", "other_labels_error"])
def test_ranks_that_pass_different_inputs_are_refused(runs, key):
    """A mesh run is one input on every rank: ranks each running their
    own ``refine()`` raise, all of them, before any shard runs."""
    msgs = {out[key] for out in runs["port"]}
    assert len(msgs) == 1
    assert "ranks [1] passed another input than rank 0" in msgs.pop()


def test_the_references_default_mesh_refine_fails_across_processes(runs):
    """ROADMAP C30: the port runs what the reference only sets out to."""
    for ref in runs["reference"]:
        auto = ref["auto"]
        assert auto["raised"] == "RuntimeError"
        assert "non-addressable" in auto["message"]
        assert ["scconsensus_tpu/parallel/ring.py", 95] in auto["frames"]


def test_a_device_loss_leaves_rank_0_on_the_lowest_half(runs):
    r0, r1 = runs["port"]
    (t,) = r0["loss_auto"]["transitions"]
    assert (t["stage"], t["cause"]) == ("stage:silhouette", "device_loss")
    assert (t["from_devices"], t["to_devices"]) == ([0, 1], [0])
    assert r0["loss_auto"]["labels_sha"] == r0["serial_sha"]
    (t,) = r0["loss_eight"]["transitions"]
    assert (t["from_devices"], t["to_devices"]) == (list(range(8)),
                                                     [0, 1, 2, 3])
    assert r0["loss_eight"]["labels_sha"] == r0["serial_sha"]
    for key in ("loss_auto", "loss_eight"):
        assert r1[key]["raised"] == "DeviceLossUnrecoverable"
        assert "all on rank 0" in r1[key]["message"]
        assert "rank 1 holds none" in r1[key]["message"]


def test_the_loss_matches_the_references_two_processes(runs):
    ref0, ref1 = runs["reference"]
    (rt,) = ref0["loss"]["transitions"]
    (t,) = runs["port"][0]["loss_eight"]["transitions"]
    # JAX's CPU ids are 0..3 and 2048..2051; the port's are positions
    assert rt["from_devices"] == [0, 1, 2, 3, 2048, 2049, 2050, 2051]
    assert len(t["from_devices"]) == len(rt["from_devices"])
    assert t["to_devices"] == rt["to_devices"] == [0, 1, 2, 3]
    assert (t["stage"], t["cause"]) == (rt["stage"], rt["cause"])
    assert t["recovered_state_bytes"] == rt["recovered_state_bytes"]
    labels = runs["port"][0]["loss_eight"]["labels"]
    assert labels.keys() == ref0["loss"]["labels"].keys()
    for key, want in ref0["loss"]["labels"].items():
        np.testing.assert_array_equal(labels[key], want, err_msg=key)
    # the reference's process 1 is left on a mesh it cannot address
    assert ref1["loss"]["raised"] == "RuntimeError"
    assert "non-addressable" in ref1["loss"]["message"]


if __name__ == "__main__":
    if sys.argv[1] == "port":
        _worker_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    else:
        _reference_worker_main(sys.argv[2], int(sys.argv[3]), sys.argv[4])
