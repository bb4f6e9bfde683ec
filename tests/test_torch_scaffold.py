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
        # the mesh path too: two shards on the CPU
        from scconsensus_tpu_torch.parallel import make_mesh
        on_mesh = port.refine(data, [f"c{{v}}" for v in truth],
                              port.ReclusterConfig(), device="cpu",
                              mesh=make_mesh(2, device="cpu"))
        assert on_mesh.metrics["wilcox_ladder"]["kernel"] == "mesh-scan"
        # the serving path too: export, load, serve
        import tempfile
        d = tempfile.mkdtemp()
        port.export_consensus_model(data, res, port.ReclusterConfig(), d,
                                    n_landmarks=32, device="cpu")
        model = port.load_consensus_model(d, device="cpu")
        with port.ConsensusServer(model, device="cpu") as srv:
            assert srv.classify(data.T[:8].copy()).outcome == "ok"
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
    # the port's examples are the port's too
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "examples", "torch_quickstart.py"),
             os.path.join(REPO, "examples", "torch_device_resident.py")]
    for root, dirs, names in os.walk(PORT_DIR):
        # packages only: build outputs live in plain directories
        dirs[:] = [d for d in dirs
                   if os.path.exists(os.path.join(root, d, "__init__.py"))]
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    # the serving path, the robustness core, the streaming layer and the
    # mesh are in the scan
    rel = {os.path.relpath(p, PORT_DIR) for p in files}
    for sub in ("serve", "serve/fleet", "robust", "obs", "stream",
                "parallel"):
        mods = {os.path.join(sub, n) for n in
                os.listdir(os.path.join(PORT_DIR, sub)) if n.endswith(".py")}
        assert mods and mods <= rel, sub
    assert {"serve/driver.py", "serve/model.py", "serve/soak.py",
            "robust/faults.py", "robust/retry.py", "robust/record.py",
            "obs/trace.py", "obs/device.py", "obs/residency.py",
            "stream/budget.py", "stream/record.py", "stream/runner.py",
            "stream/soak.py", "stream/store.py", "robust/elastic.py",
            "parallel/mesh.py", "parallel/sharded_de.py", "parallel/ring.py",
            "parallel/step.py", "parallel/validate.py", "ops/ranks.py",
            "robust/soak.py", "obs/kernels.py", "obs/export.py",
            "utils/logging.py", "ops/treecut_direct.py",
            "de/edger_direct.py", "utils/devcache.py"} <= rel
    bad = [
        f"{os.path.relpath(p, REPO)}:{line} imports {mod}"
        for p in files for mod, line in _imported_roots(p)
        if mod in ("jax", "jaxlib", "scconsensus_tpu")
    ]
    assert not bad, bad


def _scan_worker(name: str, parent_only: set) -> None:
    """A test file that runs as a worker script: its module level and
    every function but the tests and ``parent_only`` (the reference's
    side) import the port alone."""
    path = os.path.join(REPO, "tests", name)
    tree = ast.parse(open(path).read(), filename=path)
    scanned, bad = [], []
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and (
                node.name.startswith("test_") or node.name in parent_only):
            continue
        scanned.append(getattr(node, "name", type(node).__name__))
        for sub in ast.walk(node):
            mods = []
            if isinstance(sub, ast.Import):
                mods = [a.name for a in sub.names]
            elif isinstance(sub, ast.ImportFrom) and sub.module and \
                    sub.level == 0:
                mods = [sub.module]
            bad += [f"{name}:{m}:{sub.lineno}" for m in mods
                    if m.split(".")[0] in ("jax", "jaxlib",
                                           "scconsensus_tpu")]
    assert "_worker_main" in scanned
    assert not bad, bad


def test_the_multihost_worker_imports_no_jax_or_reference():
    """``tests/test_torch_multihost.py`` and
    ``tests/test_torch_multihost_auto.py`` run as scripts are the
    multi-process mesh's workers; each imports the port alone (the
    second file's reference worker and its fixture's reference inputs
    are the reference's side)."""
    _scan_worker("test_torch_multihost.py", {"_reference_results"})
    _scan_worker("test_torch_multihost_auto.py",
                 {"_reference_worker_main", "_reference_inputs"})


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
    from scconsensus_tpu_torch.obs.regress import reference_fingerprint
    from scconsensus_tpu_torch.robust.soak import run_integrity_soak

    calls["run_integrity_soak"] = lambda: run_integrity_soak(
        "/nonexistent", n_cells=40, n_genes=20)
    calls["reference_fingerprint"] = reference_fingerprint
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


# the observation flags of refine() the port handles, each with a value
# that turns it on and what that value changes on a run
PORTED_FLAG_VALUES = {
    "SCC_OBS_TRANSFERS": "1", "SCC_OBS_RESIDENCY": "audit",
    "SCC_OBS_COST": "1", "SCC_WILCOX_PROBE": "1", "SCC_OBS_HEARTBEAT": "0.5",
    "SCC_OBS_STALL_S": "30", "SCC_HOSTPROF": "1",
    "SCC_COMPILELOG": "1", "SCC_GRAPHS": "1",
}


@pytest.mark.parametrize("flag", PORTED_FLAG_VALUES)
def test_a_ported_flag_runs(flag, monkeypatch):
    """Each observation flag the port handles carries the reference's
    registration, and set it observes the run without changing it."""
    from scconsensus_tpu_torch.config import ENV_FLAGS
    from scconsensus_tpu_torch.obs import compilelog, graphs
    from scconsensus_tpu_torch.obs.live import LiveRecorder

    ours, ref = ENV_FLAGS[flag], ref_config.ENV_FLAGS[flag]
    assert (ours.type, ours.default, ours.doc) == (ref.type, ref.default,
                                                    ref.doc)
    data, labels = _tiny()
    base = port.refine(data, labels, ReclusterConfig(), device="cpu")
    monkeypatch.setenv(flag, PORTED_FLAG_VALUES[flag])
    # the compile log and the passport registry are armed by the caller,
    # under their flag, as the reference's bench worker arms them
    armed = {"SCC_COMPILELOG": compilelog, "SCC_GRAPHS": graphs}.get(flag)
    if armed is not None:
        monkeypatch.setitem(compilelog._STATE, "armed", False)
        assert armed.install_and_mark() is True
    try:
        res = port.refine(data, labels, ReclusterConfig(), device="cpu")
        sec = armed.snapshot() if armed is not None else None
    finally:
        graphs.reset()
    for key in base.dynamic_labels:
        np.testing.assert_array_equal(base.dynamic_labels[key],
                                      res.dynamic_labels[key])
    m = res.metrics
    if flag == "SCC_OBS_TRANSFERS":
        assert m["transfers"]["to_device_calls"] > 0
    elif flag == "SCC_OBS_RESIDENCY":
        assert m["residency"]["mode"] == "audit"
        assert "embed_scores_fetch" in m["residency"]["by_boundary"]
    elif flag == "SCC_OBS_COST":
        # the CPU's rank-sum forms are segment sums: bytes, no GEMM FLOPs
        assert any((s.get("attrs") or {}).get("xla_cost", {}).get(
            "bytes_accessed") for s in m["spans"]
            if s["name"] == "wilcox_bucket")
    elif flag == "SCC_WILCOX_PROBE":
        assert all("wall_s" in b and "sort_s" in b
                   for b in m["wilcox_ladder"]["buckets"])
    elif flag == "SCC_HOSTPROF":
        assert m["host_profile"]["version"] == 1
        assert m["memory_timeline"]["n_samples"] >= 1
    elif flag == "SCC_COMPILELOG":
        # the Ward library was loaded by the first run: nothing compiled
        compilelog.validate_compile(sec)
        assert sec["compiles"] == 0 and sec["retraces"] == 0
    elif flag == "SCC_GRAPHS":
        graphs.validate_graphs(sec)
        assert {"gates.compute_aggregates_cid", "gates.pair_gates_fast",
                "wilcox.allpairs_ranksum_chunk", "embed.pca_scores"} <= {
            p["program"] for p in sec["programs"].values()}
        assert "errors" not in sec
    else:
        # the flight recorder's flags: read when a recorder is built
        rec = LiveRecorder("unused")
        assert (rec.heartbeat_s, rec.stall_s) == (
            float(os.environ["SCC_OBS_HEARTBEAT"] if flag ==
                  "SCC_OBS_HEARTBEAT" else 0.0),
            float(os.environ["SCC_OBS_STALL_S"] if flag ==
                  "SCC_OBS_STALL_S" else 0.0))


@pytest.mark.parametrize("case", ["method", "sparse_method",
                                  "unported_flag"])
def test_what_the_slice_leaves_out_raises(case, tmp_path, monkeypatch):
    import json

    import scipy.sparse as sp

    from scconsensus_tpu_torch import config as port_config
    from scconsensus_tpu_torch.robust import faults

    data, labels = _tiny()

    if case == "unported_flag":
        # a reference flag of refine() the port does not handle yet (none
        # since the compile log and the passports were ported; the
        # mechanism is held here on a stand-in) is refused when set, by
        # refine() and by streaming_refine() alike
        from scconsensus_tpu_torch.stream.store import ChunkedCSRStore

        assert port_config.UNPORTED_FLAGS == ()
        flag = "SCC_GRAPHS"
        monkeypatch.setattr(port_config, "UNPORTED_FLAGS", (flag,))
        # its off value runs
        monkeypatch.setenv(flag, "0")
        port.refine(data, labels, ReclusterConfig(), device="cpu")
        monkeypatch.setenv(flag, "1")
        with pytest.raises(NotImplementedError, match=flag):
            port.refine(data, labels, ReclusterConfig(), device="cpu")
        store = ChunkedCSRStore.create(str(tmp_path / "c"), 120, 240, 32)
        with pytest.raises(NotImplementedError, match=flag):
            port.streaming_refine(store, labels, ReclusterConfig(),
                                  device="cpu")
        return
    run = {
        # "mast" is a method the reference refuses as well
        "method": lambda: port.refine(
            data, labels, ReclusterConfig(method="mast"), device="cpu"),
        "sparse_method": lambda: port.refine(
            sp.csr_matrix(data), labels, ReclusterConfig(method="mast"),
            device="cpu"),
    }[case]
    with pytest.raises(NotImplementedError):
        run()


def _fake_group(monkeypatch, rank: int) -> None:
    """A default group of 2 ranks with this one at ``rank``; the gather
    of device lists hands every rank this rank's list."""
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)
    monkeypatch.setattr(dist, "get_rank", lambda *a: rank)
    monkeypatch.setattr(dist, "all_gather_object",
                        lambda out, obj, *a, **k: out.__setitem__(
                            slice(None), [obj] * len(out)))


@pytest.mark.parametrize("case", ["mesh_auto_across_processes",
                                  "device_loss_across_processes"])
def test_what_was_left_out_now_runs(case, monkeypatch):
    """The two raise cases of the multi-process mesh, now run: a mesh
    over every rank's devices, and a device loss across processes as the
    reference runs it (two real processes: test_torch_multihost_auto)."""
    from scconsensus_tpu_torch.parallel.mesh import Mesh, auto_mesh, make_mesh
    from scconsensus_tpu_torch.robust import record as robust_record
    from scconsensus_tpu_torch.robust.elastic import (
        DeviceLossUnrecoverable,
        ElasticMeshSupervisor,
    )

    if case == "mesh_auto_across_processes":
        _fake_group(monkeypatch, 0)
        auto = auto_mesh("cpu")
        assert (auto.size, auto.procs, auto.rank) == (2, 2, 0)
        assert auto.local == range(0, 1)
        sup, got = ElasticMeshSupervisor.resolve("auto", "cpu")
        assert (got.size, got.procs, list(got.local)) == (2, 2, [0])
        four = make_mesh(4, devices=["cpu", "cpu"])
        assert (four.procs, four.local) == (2, range(0, 2))
        with pytest.raises(ValueError, match=r"give the ranks \[2, 0\]"):
            make_mesh(2, devices=["cpu", "cpu"])
        assert make_mesh(4, device="cpu").local == range(0, 2)
        return
    # the survivors of the halving, shards 0 and 1, are rank 0's
    robust_record.begin_run()
    mesh = Mesh(("cpu",) * 4, (0, 1, 2, 3), procs=2, rank=1)
    sup, got = ElasticMeshSupervisor.resolve(mesh)
    assert got is mesh and list(got.local) == [2, 3]
    with pytest.raises(DeviceLossUnrecoverable, match="all on rank 0"):
        sup.shrink("sharded:ranksum")
    sup, _ = ElasticMeshSupervisor.resolve(
        Mesh(("cpu",) * 4, (0, 1, 2, 3), procs=2, rank=0))
    sup.shrink("sharded:ranksum")
    alone = sup.mesh
    assert (alone.ids, alone.procs, alone.local) == ((0, 1), 1, range(2))
    (t,) = robust_record.current_run().mesh_transitions
    assert (t["from_devices"], t["to_devices"]) == ([0, 1, 2, 3], [0, 1])


# --------------------------------------------------------------------------
# the package surface (ROADMAP C14) and the landmark flags (C12)
# --------------------------------------------------------------------------

# reference names the port does not export yet (none: the compile log and
# the graph passports were the last)
NOT_EXPORTED = {}


@pytest.mark.parametrize("sub", ["", "consensus", "models", "de", "ops",
                                 "utils", "obs", "native", "utils.devcache"])
def test_every_all_equals_the_reference(sub):
    import importlib

    ours = importlib.import_module(
        "scconsensus_tpu_torch" + (f".{sub}" if sub else ""))
    ref = importlib.import_module(
        "scconsensus_tpu" + (f".{sub}" if sub else ""))
    left_out = NOT_EXPORTED.get(sub, ())
    assert set(left_out) <= set(ref.__all__)
    assert ours.__all__ == [n for n in ref.__all__ if n not in left_out]
    for name in ours.__all__:
        assert getattr(ours, name) is not None, name


def test_the_reference_imports_work_on_the_port():
    from scconsensus_tpu_torch import ReclusterResult, __version__
    from scconsensus_tpu_torch.consensus import contingency_table
    from scconsensus_tpu_torch.models import refine
    from scconsensus_tpu_torch.models.pipeline import (
        ReclusterResult as PipelineResult,
    )
    from scconsensus_tpu_torch.ops import rank_sum_groups, wilcoxon_exact_host
    from scconsensus_tpu_torch.utils import StageTimer, get_logger

    assert refine is port.refine and ReclusterResult is PipelineResult
    assert __version__ == "0.1.0"
    assert callable(contingency_table) and callable(rank_sum_groups)
    assert callable(wilcoxon_exact_host) and callable(get_logger)
    assert StageTimer().tracer is not None


TREE_FLAGS = ("SCC_TREE_EXACT", "SCC_TREE_LANDMARK_THRESHOLD",
              "SCC_TREE_LANDMARK_K", "SCC_TREE_LANDMARK_C",
              "SCC_ROBUST_CHECKSUM", "SCC_TRACE_DIR")
# the serving fleet's flags: pool, wire and reconsensus, the load
# generator, and the autoscaler
FLEET_FLAGS = ("SCC_FLEET_REPLICAS", "SCC_FLEET_WIRE_PORT",
               "SCC_FLEET_SWAP_DRAIN_S", "SCC_FLEET_RECON_MIN_CELLS",
               "SCC_LOADGEN_RPS", "SCC_LOADGEN_PROFILE", "SCC_LOADGEN_SEED",
               "SCC_LOADGEN_DURATION_S", "SCC_AUTOSCALE_MIN",
               "SCC_AUTOSCALE_MAX", "SCC_AUTOSCALE_TICK_S",
               "SCC_AUTOSCALE_BURN_UP", "SCC_AUTOSCALE_BURN_DOWN",
               "SCC_AUTOSCALE_UP_TICKS", "SCC_AUTOSCALE_DOWN_TICKS",
               "SCC_AUTOSCALE_COOLDOWN_TICKS")


@pytest.mark.parametrize("name", TREE_FLAGS + FLEET_FLAGS)
def test_new_flags_carry_the_reference_registration(name):
    from scconsensus_tpu_torch.config import ENV_FLAGS

    ours, ref = ENV_FLAGS[name], ref_config.ENV_FLAGS[name]
    assert (ours.name, ours.type, ours.default, ours.doc) == (
        ref.name, ref.type, ref.default, ref.doc)


@pytest.mark.parametrize("case", [
    # (env, config fields, n_cells): ROADMAP C12's two cases first
    ({"SCC_TREE_LANDMARK_THRESHOLD": "1000"}, {}, 5_000),
    ({"SCC_TREE_EXACT": "1"}, {}, 1_000_000),
    ({}, {}, 1_000_000),
    ({}, {}, 200_000),
    ({"SCC_TREE_LANDMARK_K": "300", "SCC_TREE_LANDMARK_C": "3.5"}, {},
     500_000),
    # config fields win over the flags
    ({"SCC_TREE_LANDMARK_THRESHOLD": "1000", "SCC_TREE_LANDMARK_K": "300",
      "SCC_TREE_LANDMARK_C": "3.5"},
     {"landmark_threshold": 4000, "landmark_k": 128, "landmark_c": 1.5},
     5_000),
    ({"SCC_TREE_LANDMARK_THRESHOLD": "1000"}, {"landmark_threshold": 9000},
     5_000),
    ({"SCC_TREE_EXACT": "0", "SCC_TREE_LANDMARK_THRESHOLD": "10"},
     {"landmark_sketch": 2000, "landmark_linkage": "knn"}, 50),
], ids=["c12-threshold", "c12-exact", "default-1m", "at-threshold",
        "k-and-c", "config-wins", "config-threshold", "exact-off"])
def test_landmark_policy_equals_the_reference(case, monkeypatch):
    env, fields, n = case
    for name in TREE_FLAGS[:4]:
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ours = ReclusterConfig(**fields).landmark_policy(n)
    ref = ref_config.ReclusterConfig(**fields).landmark_policy(n)
    assert ours == ref
    if env == {"SCC_TREE_LANDMARK_THRESHOLD": "1000"} and not fields:
        assert ours is not None and ours["threshold"] == 1000
    if env.get("SCC_TREE_EXACT") == "1":
        assert ours is None


def test_the_landmark_flags_reach_refine(monkeypatch):
    """SCC_TREE_LANDMARK_THRESHOLD moves refine()'s tree onto the
    landmark branch, as in the reference."""
    from scconsensus_tpu_torch.utils.synthetic import synthetic_scrna

    data, truth, _ = synthetic_scrna(n_genes=120, n_cells=600, n_clusters=3,
                                     seed=3)
    labels = np.array([f"c{v}" for v in truth])
    cfg = ReclusterConfig(approx_threshold=300, n_pool_centroids=64,
                          landmark_k=32, deep_split_values=(1,))
    monkeypatch.setenv("SCC_TREE_LANDMARK_THRESHOLD", "500")
    res = port.refine(data, labels, cfg, device="cpu", mesh=None)
    assert res.metrics["landmark"]["threshold"] == 500
    assert res.metrics["tree"]["landmark"] is True
    monkeypatch.setenv("SCC_TREE_EXACT", "1")
    res = port.refine(data, labels, cfg, device="cpu", mesh=None)
    assert res.metrics["landmark"] is None


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


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["bimod", "t"])
def test_seurat_tests_on_the_card_match_the_cpu(cuda_device, method):
    data, truth, _ = synthetic_scrna(n_genes=120, n_cells=200, n_clusters=3,
                                     seed=3)
    labels = noisy_labeling(truth, 0.05, seed=2)
    cfg = ReclusterConfig(method=method)
    gpu = pairwise_de(data, labels, cfg, device=cuda_device)
    cpu = pairwise_de(data, labels, cfg, device="cpu")
    assert gpu.log_p.device.type == "cuda"
    got, want = gpu.log_p.cpu().numpy(), cpu.log_p.numpy()
    # the card's gammaincc, lgamma and log are a third implementation; the
    # CPU tests hold the port to the JAX package at 2e-4 relative and 1e-2
    # absolute (tests/test_torch_seurat.py), and the flush boundary is
    # crossed on one device only by entries within a few ulps of FLT_MIN
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(got) & np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=2e-4, atol=1e-2)
    crossed = np.isneginf(got) != np.isneginf(want)
    assert crossed.sum() <= max(1, 1e-3 * got.size)
    assert int((gpu.de_mask.cpu() != cpu.de_mask).sum()) <= max(
        1, 1e-3 * got.size)
