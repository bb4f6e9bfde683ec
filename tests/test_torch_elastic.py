"""The port's elastic mesh (``robust/elastic.py``) against the JAX package
on the CPU: a mirror of ``tests/test_robust_elastic.py`` on an 8-shard
CPU mesh (``parallel.mesh.make_mesh(8, device="cpu")``).

Device loss is injected (``device_loss`` plans); a real lost card cannot
be produced here. A loss at any stage boundary, inside the sharded
rank-sum, the ring or the fused step recovers in-process onto a smaller
mesh with the serial run's labels, every move stamped as a validated
``mesh_transitions`` entry; a store or bucket checkpoint written on 8
shards resumes on 4, 2 or 1 with identical labels and ``cause:
"resume"`` transitions, also across the two packages. The reference's
< 2 % overhead guard is a timing test and is held on the card
(``chip_smoke.py`` phase 27), not here.
"""

import json
import os

import numpy as np
import pytest
import torch

from scconsensus_tpu.config import ReclusterConfig as RefConfig
from scconsensus_tpu.de import engine as ref_engine
from scconsensus_tpu.models import pipeline as ref_pl
from scconsensus_tpu.parallel import mesh as ref_mesh_mod
from scconsensus_tpu.parallel import sharded_de as ref_sharded
from scconsensus_tpu.robust import faults as ref_faults
from scconsensus_tpu.robust import record as ref_record
from scconsensus_tpu.utils.artifacts import ArtifactStore as RefStore
from scconsensus_tpu.utils.synthetic import noisy_labeling, synthetic_scrna
from scconsensus_tpu_torch.carry import config_from_reference
from scconsensus_tpu_torch.config import ReclusterConfig
from scconsensus_tpu_torch.de.engine import pairwise_de
from scconsensus_tpu_torch.models.pipeline import refine
from scconsensus_tpu_torch.ops import ranksum_allpairs as port_ranksum
from scconsensus_tpu_torch.parallel import sharded_de as port_sharded
from scconsensus_tpu_torch.parallel.mesh import make_mesh
from scconsensus_tpu_torch.robust import faults
from scconsensus_tpu_torch.robust import integrity
from scconsensus_tpu_torch.robust import record as robust_record
from scconsensus_tpu_torch.robust.elastic import (
    DeviceLossUnrecoverable,
    ElasticMeshSupervisor,
)
from scconsensus_tpu_torch.robust.record import validate_robustness
from scconsensus_tpu_torch.robust.retry import (
    RetryPolicy,
    classify_exception,
    classify_text,
)
from scconsensus_tpu_torch.utils.artifacts import ArtifactStore

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fast_backoff(monkeypatch):
    """Millisecond backoffs and fresh fault and robustness state in both
    packages."""
    monkeypatch.setenv("SCC_ROBUST_BACKOFF_S", "0.002")
    monkeypatch.delenv("SCC_FAULT_PLAN", raising=False)
    for mod in (faults, ref_faults):
        mod.reset()
    for mod in (robust_record, ref_record):
        mod.begin_run()
    yield
    for mod in (faults, ref_faults):
        mod.reset()


def _mesh(n):
    return make_mesh(n, device="cpu")


@pytest.fixture(scope="module")
def small_case():
    data, truth, _ = synthetic_scrna(
        n_genes=60, n_cells=152, n_clusters=3, n_markers_per_cluster=8,
        seed=11,
    )
    return data, noisy_labeling(truth, 0.05, seed=2)


def _cfg(**kw):
    return ReclusterConfig(deep_split_values=(1, 2), **kw)


def _run(data, labels, mesh, **kw):
    return refine(data, labels, _cfg(**kw), device="cpu", mesh=mesh)


@pytest.fixture(scope="module")
def serial_ref(small_case):
    data, labels = small_case
    return _run(data, labels, None)


def _plan(tmp_path, rules, monkeypatch, name="plan.json"):
    path = tmp_path / name
    path.write_text(json.dumps({"faults": rules}))
    monkeypatch.setenv("SCC_FAULT_PLAN", str(path))
    faults.reset()
    ref_faults.reset()
    return str(path)


def _assert_labels_equal(res, ref):
    assert res.dynamic_labels.keys() == ref.dynamic_labels.keys()
    for key in ref.dynamic_labels:
        np.testing.assert_array_equal(res.dynamic_labels[key],
                                      ref.dynamic_labels[key])


def _paths(rb):
    return [(len(t["from_devices"]), len(t["to_devices"]))
            for t in rb["mesh_transitions"]]


# --------------------------------------------------------------------------
# classification and the policy's device-loss hook
# --------------------------------------------------------------------------

class TestDeviceLostClassification:
    @pytest.mark.parametrize("text", [
        "XlaRuntimeError: INTERNAL: Device lost: TPU_3 halted",
        "FAILED_PRECONDITION: device 5 not found in client",
        "worker preempted by scheduler",
        "ValueError: mesh should contain the devices of its operands",
        "UNAVAILABLE: device lost during allreduce",
        "RESOURCE_EXHAUSTED after device preempted",
        "CUDA error: an illegal memory access was encountered",
        "RuntimeError: CUDA error: unspecified launch failure",
    ])
    def test_device_lost_signatures_as_the_reference(self, text):
        from scconsensus_tpu.robust.retry import classify_text as ref_text

        assert classify_text(text) == "device_lost"
        if "CUDA" not in text:
            assert ref_text(text) == "device_lost"

    def test_injected_type(self):
        assert classify_exception(
            faults.InjectedDeviceLoss("FAILED_PRECONDITION: device lost")
        ) == "device_lost"

    def test_device_lost_without_handler_is_fatal(self):
        calls = {"n": 0}

        def fn():
            calls["n"] += 1
            raise faults.InjectedDeviceLoss("device lost")

        with pytest.raises(faults.InjectedDeviceLoss):
            RetryPolicy(max_attempts=5).call(fn, site="t")
        assert calls["n"] == 1  # no blind retry against a dead mesh
        assert not robust_record.current_run().retries

    def test_device_lost_with_handler_recovers(self):
        calls = {"n": 0}
        handled = []

        def fn():
            calls["n"] += 1
            if calls["n"] == 1:
                raise faults.InjectedDeviceLoss("device lost")
            return "ok"

        out = RetryPolicy(max_attempts=3).call(
            fn, site="t", on_device_loss=lambda a: handled.append(a))
        assert out == "ok" and handled == [1]
        (entry,) = robust_record.current_run().retries
        assert entry["error_class"] == "device_lost"
        assert entry["recovered"] is True


# --------------------------------------------------------------------------
# mesh_transitions: the shrink rule
# --------------------------------------------------------------------------

def _section_with(transition):
    return {"recovered": True, "mesh_transitions": [transition]}


class TestTransitionValidation:
    def test_valid_shrink_accepted(self):
        validate_robustness(_section_with({
            "stage": "stage:de", "from_devices": [0, 1, 2, 3],
            "to_devices": [0, 1], "recovered_state_bytes": 128,
            "cause": "device_loss",
        }))

    def test_transition_counts_as_recovery_evidence(self):
        validate_robustness(_section_with({
            "stage": "s", "from_devices": [0, 1], "to_devices": [0],
            "recovered_state_bytes": 0, "cause": "resume",
        }))

    @pytest.mark.parametrize("src,dst", [
        ([0, 1], [0, 1, 2, 3]),   # growth
        ([0, 1], [0, 1]),         # no change
        ([0, 1], [2, 3]),         # disjoint
        ([0, 1, 2, 3], []),       # shrink to nothing
    ])
    def test_non_shrinking_sets_rejected(self, src, dst):
        with pytest.raises(ValueError, match="shrink|non-empty"):
            validate_robustness(_section_with({
                "stage": "s", "from_devices": src, "to_devices": dst,
                "recovered_state_bytes": 0, "cause": "device_loss",
            }))

    def test_bad_cause_rejected(self):
        with pytest.raises(ValueError, match="cause"):
            validate_robustness(_section_with({
                "stage": "s", "from_devices": [0, 1], "to_devices": [0],
                "recovered_state_bytes": 0, "cause": "wandered",
            }))


# --------------------------------------------------------------------------
# the supervisor by itself
# --------------------------------------------------------------------------

def _supervisor(n):
    m = _mesh(n)
    return ElasticMeshSupervisor(devices=list(m.devices), ids=list(m.ids),
                                 auto=False)


class TestSupervisor:
    def test_shrink_ladder_8_4_2_1(self):
        sup = _supervisor(8)
        assert sup.mesh is not None and sup.n_devices == 8
        for expect in (4, 2, 1):
            sup.shrink("stage:t")
            assert sup.n_devices == expect
            assert sup.device_ids() == list(range(expect))
        assert sup.mesh is None  # one shard = the serial path
        with pytest.raises(DeviceLossUnrecoverable):
            sup.shrink("stage:t")
        run = robust_record.current_run()
        assert len(run.mesh_transitions) == 3
        validate_robustness(robust_record.section())

    def test_min_devices_floor(self, monkeypatch):
        monkeypatch.setenv("SCC_ELASTIC_MIN_DEVICES", "4")
        sup = _supervisor(8)
        sup.shrink("s")  # 8 -> 4 allowed
        with pytest.raises(DeviceLossUnrecoverable):
            sup.shrink("s")  # 4 -> 2 would cross the floor

    def test_elastic_off_restores_the_bare_mesh(self, monkeypatch):
        monkeypatch.setenv("SCC_ELASTIC", "0")
        m = _mesh(8)
        assert ElasticMeshSupervisor.resolve(m, CPU) == (None, m)
        assert ElasticMeshSupervisor.resolve("auto", CPU) == (None, None)
        assert ElasticMeshSupervisor.resolve(None, CPU) == (None, None)

    def test_elastic_off_loses_the_run(self, monkeypatch, tmp_path,
                                       small_case):
        monkeypatch.setenv("SCC_ELASTIC", "0")
        _plan(tmp_path, [{"site": "stage:tree", "class": "device_loss"}],
              monkeypatch)
        data, labels = small_case
        with pytest.raises(faults.InjectedDeviceLoss):
            _run(data, labels, _mesh(8))

    def test_resume_meta_stamps_only_shrinks(self):
        sup = _supervisor(2)
        run = robust_record.current_run()
        meta = {"mesh_shape": {"n_devices": 8,
                               "device_ids": list(range(8))},
                "_integrity": {"size": 4096}}
        sup.note_artifact_meta("tree", meta)
        sup.note_artifact_meta("tree", meta)
        assert len(run.mesh_transitions) == 1
        t = run.mesh_transitions[0]
        assert t["cause"] == "resume"
        assert t["recovered_state_bytes"] == 4096
        assert t["to_devices"] == [0, 1]
        sup.note_artifact_meta("cuts", {"mesh_shape": {
            "n_devices": 2, "device_ids": [0, 1]}})
        sup.note_artifact_meta("cuts", {"mesh_shape": {
            "n_devices": 1, "device_ids": [0]}})
        assert len(run.mesh_transitions) == 1

    def test_probe_answers_false_instead_of_raising(self):
        assert ElasticMeshSupervisor._probe_device(CPU) is True
        # a device the process cannot reach: no raise, just False
        assert ElasticMeshSupervisor._probe_device(
            torch.device("cuda", 63)) is False

    def test_probed_casualties_are_dropped_exactly(self, monkeypatch):
        sup = _supervisor(8)
        live = [s for s in sup._shard_list() if s[0] != 5]
        monkeypatch.setattr(sup, "survivors", lambda: live)
        sup.shrink("stage:de")
        assert sup.device_ids() == [0, 1, 2, 3, 4, 6, 7]
        assert sup.mesh.ids == (0, 1, 2, 3, 4, 6, 7)
        (t,) = robust_record.current_run().mesh_transitions
        assert t["from_devices"] == list(range(8))
        assert t["to_devices"] == [0, 1, 2, 3, 4, 6, 7]

    def test_serial_run_has_no_smaller_mesh(self):
        sup, mesh = ElasticMeshSupervisor.resolve(None, CPU)
        assert mesh is None and sup.device_ids() == [0]
        with pytest.raises(DeviceLossUnrecoverable):
            sup.loss_handler("stage:de")(1)


# --------------------------------------------------------------------------
# the fault matrix: device_loss at every stage boundary and in the engines
# --------------------------------------------------------------------------

STAGE_SITES = ("stage:de", "stage:union", "stage:embed", "stage:tree",
               "stage:cuts", "stage:silhouette", "stage:nodg")


class TestElasticFaultMatrix:
    @pytest.fixture(scope="class")
    def mesh_ref(self, small_case):
        data, labels = small_case
        return _run(data, labels, _mesh(8))

    @pytest.mark.parametrize("site", STAGE_SITES)
    def test_device_loss_recovers_on_smaller_mesh(
        self, tmp_path, monkeypatch, small_case, serial_ref, mesh_ref, site,
    ):
        data, labels = small_case
        _plan(tmp_path, [{"site": site, "class": "device_loss"}],
              monkeypatch)
        res = _run(data, labels, _mesh(8))
        _assert_labels_equal(res, mesh_ref)
        _assert_labels_equal(res, serial_ref)
        rb = res.metrics["robustness"]
        assert rb["recovered"] is True
        assert any(f["site"] == site and f["class"] == "device_loss"
                   for f in rb["faults_injected"])
        assert any(r["site"] == site and r["recovered"]
                   and r["error_class"] == "device_lost"
                   for r in rb["retries"])
        (t,) = rb["mesh_transitions"]
        assert t["stage"] == site and t["cause"] == "device_loss"
        assert t["from_devices"] == list(range(8))
        assert t["to_devices"] == list(range(4))
        assert t["recovered_state_bytes"] > 0
        validate_robustness(rb)

    @pytest.mark.parametrize("site,stage", [
        ("sharded:ranksum", "stage:de"),
        ("ring:distance_sums", "stage:silhouette"),
    ])
    def test_loss_inside_a_sharded_engine_recovers(
        self, tmp_path, monkeypatch, small_case, serial_ref, site, stage
    ):
        """The loss fires inside a mesh engine, not at a stage boundary:
        it propagates to the stage guard, which shrinks and re-enters."""
        data, labels = small_case
        _plan(tmp_path, [{"site": site, "class": "device_loss"}],
              monkeypatch)
        res = _run(data, labels, _mesh(8))
        _assert_labels_equal(res, serial_ref)
        rb = res.metrics["robustness"]
        assert any(r["site"] == stage and r["recovered"]
                   and r["error_class"] == "device_lost"
                   for r in rb["retries"])
        assert _paths(rb) == [(8, 4)]
        assert rb["mesh_transitions"][0]["stage"] == stage
        validate_robustness(rb)

    def test_double_loss_shrinks_twice(self, tmp_path, monkeypatch,
                                       small_case, serial_ref):
        data, labels = small_case
        _plan(tmp_path, [
            {"site": "stage:de", "class": "device_loss"},
            {"site": "stage:tree", "class": "device_loss"},
        ], monkeypatch)
        res = _run(data, labels, _mesh(8))
        _assert_labels_equal(res, serial_ref)
        rb = res.metrics["robustness"]
        assert _paths(rb) == [(8, 4), (4, 2)]
        validate_robustness(rb)

    def test_triple_loss_ends_serial(self, tmp_path, monkeypatch,
                                     small_case, serial_ref):
        """8 → 4 → 2 → 1 in one run: the last stages run serially."""
        data, labels = small_case
        _plan(tmp_path, [
            {"site": "sharded:ranksum", "class": "device_loss"},
            {"site": "stage:tree", "class": "device_loss"},
            {"site": "ring:distance_sums", "class": "device_loss"},
        ], monkeypatch)
        res = _run(data, labels, _mesh(8))
        _assert_labels_equal(res, serial_ref)
        rb = res.metrics["robustness"]
        assert _paths(rb) == [(8, 4), (4, 2), (2, 1)]
        assert res.metrics["silhouette"] == {"method": "exact"}
        for a, b in zip(res.deep_split_info, serial_ref.deep_split_info):
            assert abs(a["silhouette"] - b["silhouette"]) < 1e-4
        validate_robustness(rb)

    def test_the_min_devices_floor_fails_the_run(self, tmp_path, monkeypatch,
                                                 small_case):
        monkeypatch.setenv("SCC_ELASTIC_MIN_DEVICES", "8")
        _plan(tmp_path, [{"site": "stage:embed", "class": "device_loss"}],
              monkeypatch)
        data, labels = small_case
        with pytest.raises(DeviceLossUnrecoverable):
            _run(data, labels, _mesh(8))


def _engine_ladder(site, sharded, serial):
    """8 → 4 → 2 → 1 at one engine site: three injected losses, each
    recovered by the supervisor's hook, the fourth attempt serial."""
    sup = _supervisor(8)
    out = RetryPolicy(max_attempts=4).call(
        lambda: serial() if sup.mesh is None else sharded(sup.mesh),
        site="engine", on_device_loss=sup.loss_handler("engine"))
    rb = robust_record.section()
    assert _paths(rb) == [(8, 4), (4, 2), (2, 1)]
    assert [f["site"] for f in rb["faults_injected"]] == [site] * 3
    validate_robustness(rb)
    return out


class TestEngineSites:
    """The shrink ladder at each mesh engine's own site, the result after
    three losses equal to the serial form's."""

    def test_sharded_aggregates(self, tmp_path, monkeypatch, small_case):
        from scconsensus_tpu_torch.ops.gates import compute_aggregates_cid

        data, labels = small_case
        cid = np.unique(labels, return_inverse=True)[1].astype(np.int64)
        _plan(tmp_path, [{"site": "sharded:aggregates",
                          "class": "device_loss", "times": 3}], monkeypatch)
        got = _engine_ladder(
            "sharded:aggregates",
            lambda m: port_sharded.sharded_aggregates(
                data, mesh=m, cid=cid, n_clusters=3),
            lambda: compute_aggregates_cid(torch.from_numpy(data),
                                           torch.from_numpy(cid), 3))
        ser = compute_aggregates_cid(torch.from_numpy(data),
                                     torch.from_numpy(cid), 3)
        torch.testing.assert_close(got.sum_log, ser.sum_log)

    def test_sharded_ranksum(self, tmp_path, monkeypatch, small_case):
        data, labels = small_case
        cid = torch.from_numpy(
            np.unique(labels, return_inverse=True)[1].astype(np.int64))
        n_of = torch.bincount(cid, minlength=3)
        pi, pj = (torch.from_numpy(a.astype(np.int64))
                  for a in np.triu_indices(3, k=1))
        x = torch.from_numpy(data)
        _plan(tmp_path, [{"site": "sharded:ranksum", "class": "device_loss",
                          "times": 3}], monkeypatch)
        got = _engine_ladder(
            "sharded:ranksum",
            lambda m: port_sharded.sharded_allpairs_ranksum(
                x, cid, n_of, pi, pj, 3, mesh=m),
            lambda: port_ranksum.ranksum_body(x, cid, n_of, pi, pj, 3))
        ser = port_ranksum.ranksum_body(x, cid, n_of, pi, pj, 3)
        for g, s in zip(got, ser):
            torch.testing.assert_close(g, s, equal_nan=True)

    def test_ring_distance_sums(self, tmp_path, monkeypatch, rng):
        from scconsensus_tpu_torch.ops.distance import distance_tile
        from scconsensus_tpu_torch.parallel.ring import (
            ring_cluster_distance_sums,
        )

        x = torch.from_numpy(rng.normal(size=(50, 5)).astype(np.float32))
        oh = torch.nn.functional.one_hot(
            torch.from_numpy(rng.integers(0, 3, 50)), 3).to(torch.float32)
        _plan(tmp_path, [{"site": "ring:distance_sums",
                          "class": "device_loss", "times": 3}], monkeypatch)
        got = _engine_ladder(
            "ring:distance_sums",
            lambda m: ring_cluster_distance_sums(x, oh, m),
            lambda: distance_tile(x, x) @ oh)
        torch.testing.assert_close(got, distance_tile(x, x) @ oh,
                                   rtol=1e-4, atol=1e-4)

    def test_refine_step(self, tmp_path, monkeypatch):
        from scconsensus_tpu_torch.parallel.step import (
            build_step_inputs,
            distributed_refine_step,
            fused_refine_step,
        )

        inputs = build_step_inputs(n_cells=64, n_genes=48, n_clusters=3,
                                   n_shards=8)
        args = [inputs[n] for n in ("data", "onehot", "pair_i", "pair_j",
                                    "idx", "m1", "m2", "n1", "n2")]
        _plan(tmp_path, [{"site": "refine_step", "class": "device_loss",
                          "times": 3}], monkeypatch)
        got = _engine_ladder(
            "refine_step",
            lambda m: distributed_refine_step(m, n_pcs=4)(*args),
            lambda: fused_refine_step(n_pcs=4)(*args))
        faults.reset()
        monkeypatch.delenv("SCC_FAULT_PLAN")
        want = fused_refine_step(n_pcs=4)(*args)
        for key in ("de_mask", "de_counts", "counts"):
            assert torch.equal(got[key], want[key])


# --------------------------------------------------------------------------
# eviction of a device that computes wrong
# --------------------------------------------------------------------------

def test_a_miscomputing_shard_is_evicted(tmp_path, monkeypatch, small_case,
                                         serial_ref):
    """A corruption pinned to shard 7 keeps firing until the mesh no longer
    holds it (the reference's integrity-evict-device plan): the ladder's detections reach the eviction threshold, the
    stage guard's device-loss hook shrinks the mesh off shard 7, and the
    recompute is clean."""
    monkeypatch.setenv("SCC_INTEGRITY", "enforce")
    monkeypatch.setenv("SCC_INTEGRITY_EVICT_THRESHOLD", "2")
    _plan(tmp_path, [{"site": "wilcox_bucket_out", "class": "corruption",
                      "mode": "signflip", "device": 7, "times": 99}],
          monkeypatch)
    data, labels = small_case
    res = _run(data, labels, _mesh(8))
    _assert_labels_equal(res, serial_ref)
    np.testing.assert_array_equal(res.de.de_mask.numpy(),
                                  serial_ref.de.de_mask.numpy())
    rb = res.metrics["robustness"]
    assert any(d["action"] == "evict-miscomputing-device"
               for d in rb["degradations"])
    (t,) = rb["mesh_transitions"]
    assert t["stage"] == "stage:de" and t["to_devices"] == [0, 1, 2, 3]
    assert res.metrics["integrity"]["ghost"]["recomputes"] >= 1
    validate_robustness(rb)


def test_a_serial_run_reports_no_eviction(tmp_path, monkeypatch, small_case,
                                          serial_ref):
    monkeypatch.setenv("SCC_INTEGRITY", "enforce")
    monkeypatch.setenv("SCC_INTEGRITY_EVICT_THRESHOLD", "2")
    _plan(tmp_path, [{"site": "wilcox_bucket_out", "class": "corruption",
                      "mode": "signflip", "times": 2}], monkeypatch)
    data, labels = small_case
    res = _run(data, labels, None)
    _assert_labels_equal(res, serial_ref)
    rb = res.metrics["robustness"]
    assert any(d["action"] == "eviction-unavailable"
               for d in rb["degradations"])
    assert "mesh_transitions" not in rb


# --------------------------------------------------------------------------
# mid-ladder loss: shrink and resume from the finished buckets
# --------------------------------------------------------------------------

@pytest.fixture()
def tiny_budget(monkeypatch):
    """A small element budget: the 60 genes run in four buckets, in both
    packages."""
    import scconsensus_tpu.ops.ranksum_allpairs as ra

    monkeypatch.setattr(ra, "_ALLPAIRS_ELEM_BUDGET", 16 * 256 * 3)
    monkeypatch.setattr(port_ranksum, "ALLPAIRS_ELEM_BUDGET", 16 * 256 * 3)


class TestMidLadderLoss:
    def test_mid_ladder_loss_resumes_finished_buckets(
        self, tmp_path, monkeypatch, small_case, serial_ref, tiny_budget
    ):
        data, labels = small_case
        # the second bucket: bucket 0 lands and checkpoints on 8 shards,
        # then the mesh dies mid-ladder
        _plan(tmp_path, [{"site": "wilcox_bucket", "class": "device_loss",
                          "after": 1}], monkeypatch)
        res = _run(data, labels, _mesh(8),
                   artifact_dir=str(tmp_path / "store"))
        _assert_labels_equal(res, serial_ref)
        rb = res.metrics["robustness"]
        assert any(r["site"] == "stage:de" and r["recovered"]
                   and r["error_class"] == "device_lost"
                   for r in rb["retries"])
        dl = [t for t in rb["mesh_transitions"]
              if t["cause"] == "device_loss"]
        assert dl and dl[0]["from_devices"] == list(range(8))
        assert any(p["stage"] == "wilcox_test" and p["completed"] >= 1
                   for p in rb["resume_points"])
        validate_robustness(rb)

    def _interrupted(self, monkeypatch, module, fn_name, run):
        """Run ``run`` with the module's sharded rank sum dying after two
        buckets (a kill of the whole process, as the reference's test
        models it)."""
        real = getattr(module, fn_name)
        calls = {"n": 0}

        def dying(*a, **kw):
            calls["n"] += 1
            if calls["n"] > 2:
                raise KeyboardInterrupt("mesh host killed mid-ladder")
            return real(*a, **kw)

        monkeypatch.setattr(module, fn_name, dying)
        with pytest.raises(KeyboardInterrupt):
            run()
        monkeypatch.setattr(module, fn_name, real)

    def _two_blocks(self, root, n_devices):
        done = sorted(n for n in os.listdir(root)
                      if n.startswith("de_wilcox_") and n.endswith(".npz"))
        assert len(done) == 2, "exactly the finished buckets persist"
        _, meta = ArtifactStore(root).load(os.path.splitext(done[0])[0])
        assert meta["mesh_shape"]["n_devices"] == n_devices

    def _resumed_on_two(self, small_case, store, want):
        data, labels = small_case
        robust_record.begin_run()
        res = pairwise_de(data, labels, ReclusterConfig(
            deep_split_values=(1,)), device="cpu", mesh=_mesh(2),
            store=store)
        np.testing.assert_array_equal(res.de_mask.numpy(), want[0])
        np.testing.assert_allclose(res.log_p.numpy(), want[1], rtol=1e-5,
                                   atol=1e-6)
        run = robust_record.current_run()
        (rp,) = run.resume_points
        assert rp["stage"] == "wilcox_test" and rp["completed"] == 2
        (t,) = run.mesh_transitions
        assert t["cause"] == "resume"
        assert t["from_devices"] == list(range(8))
        assert t["to_devices"] == [0, 1]
        assert t["recovered_state_bytes"] > 0

    def test_bucket_ckpts_written_at_8_resume_at_2(
        self, tmp_path, small_case, tiny_budget, monkeypatch
    ):
        data, labels = small_case
        cfg = ReclusterConfig(deep_split_values=(1,))
        ref = pairwise_de(data, labels, cfg, device="cpu", mesh=_mesh(8))
        store = ArtifactStore(str(tmp_path))
        self._interrupted(monkeypatch, port_sharded,
                          "sharded_allpairs_ranksum",
                          lambda: pairwise_de(data, labels, cfg,
                                              device="cpu", mesh=_mesh(8),
                                              store=store))
        self._two_blocks(str(tmp_path), 8)
        self._resumed_on_two(small_case, store,
                             (ref.de_mask.numpy(), ref.log_p.numpy()))

    def test_reference_blocks_at_8_resume_in_the_port_at_2(
        self, tmp_path, small_case, tiny_budget, monkeypatch
    ):
        """The reference's 8-device blocks (its 'mesh' kernel variant)
        resume in the port's 2-shard ladder: the same keys and arrays."""
        data, labels = small_case
        rcfg = RefConfig(deep_split_values=(1,))
        ref_mesh = ref_mesh_mod.make_mesh(8)
        ref = ref_engine.pairwise_de(data, labels, rcfg, mesh=ref_mesh,
                                     store=RefStore(None))
        store = RefStore(str(tmp_path))
        self._interrupted(monkeypatch, ref_sharded,
                          "sharded_allpairs_ranksum",
                          lambda: ref_engine.pairwise_de(
                              data, labels, rcfg, mesh=ref_mesh,
                              store=store))
        self._two_blocks(str(tmp_path), 8)
        self._resumed_on_two(small_case, ArtifactStore(str(tmp_path)),
                             (np.asarray(ref.de_mask),
                              np.asarray(ref.log_p)))

    def test_port_blocks_at_8_resume_in_the_reference_at_2(
        self, tmp_path, small_case, tiny_budget, monkeypatch
    ):
        data, labels = small_case
        cfg = ReclusterConfig(deep_split_values=(1,))
        store = ArtifactStore(str(tmp_path))
        self._interrupted(monkeypatch, port_sharded,
                          "sharded_allpairs_ranksum",
                          lambda: pairwise_de(data, labels, cfg,
                                              device="cpu", mesh=_mesh(8),
                                              store=store))
        self._two_blocks(str(tmp_path), 8)
        ref_record.begin_run()
        ref = ref_engine.pairwise_de(
            data, labels, RefConfig(deep_split_values=(1,)),
            mesh=ref_mesh_mod.make_mesh(2), store=RefStore(str(tmp_path)))
        want = pairwise_de(data, labels, cfg, device="cpu", mesh=None)
        np.testing.assert_array_equal(np.asarray(ref.de_mask),
                                      want.de_mask.numpy())
        run = ref_record.current_run()
        (rp,) = run.resume_points
        assert rp["completed"] == 2
        (t,) = run.mesh_transitions
        assert t["cause"] == "resume" and t["to_devices"] == [0, 1]
        assert t["from_devices"] == list(range(8))


# --------------------------------------------------------------------------
# shape-changing artifact resume: 8 -> 4 -> 1, and across the packages
# --------------------------------------------------------------------------

def _resume_transitions(rb, from_n, to_ids):
    assert rb["recovered"] is True
    assert all(t["cause"] == "resume" for t in rb["mesh_transitions"])
    assert {tuple(t["from_devices"]) for t in rb["mesh_transitions"]} == \
        {tuple(range(from_n))}
    assert all(t["to_devices"] == to_ids for t in rb["mesh_transitions"])
    return {t["stage"] for t in rb["mesh_transitions"]}


class TestShrinkResumeChain:
    def test_store_written_at_8_resumes_at_4_then_1(
        self, tmp_path, small_case, serial_ref
    ):
        data, labels = small_case
        store_dir = str(tmp_path / "store")
        first = _run(data, labels, _mesh(8), artifact_dir=store_dir)
        _assert_labels_equal(first, serial_ref)
        with open(os.path.join(store_dir, "tree.json")) as f:
            assert json.load(f)["mesh_shape"]["n_devices"] == 8

        robust_record.begin_run()
        at4 = _run(data, labels, _mesh(4), artifact_dir=store_dir)
        _assert_labels_equal(at4, serial_ref)
        rb4 = at4.metrics["robustness"]
        stages = _resume_transitions(rb4, 8, [0, 1, 2, 3])
        assert {"de", "union", "embed", "tree", "cuts"} <= stages
        validate_robustness(rb4)

        robust_record.begin_run()
        at1 = _run(data, labels, None, artifact_dir=store_dir)
        _assert_labels_equal(at1, serial_ref)
        _resume_transitions(at1.metrics["robustness"], 8, [0])
        validate_robustness(at1.metrics["robustness"])

    def test_growth_is_no_crossing(self, tmp_path, small_case):
        data, labels = small_case
        store_dir = str(tmp_path / "store")
        _run(data, labels, _mesh(2), artifact_dir=store_dir)
        robust_record.begin_run()
        res = _run(data, labels, _mesh(8), artifact_dir=store_dir)
        assert "robustness" not in res.metrics


def _configs(store_dir):
    ref = RefConfig(artifact_dir=str(store_dir), deep_split_values=(1, 2))
    return ref, config_from_reference(ref.to_json())


class TestAcrossThePackages:
    def test_a_reference_store_at_8_resumes_in_the_port_at_4(
        self, tmp_path, small_case
    ):
        data, labels = small_case
        rcfg, cfg = _configs(tmp_path / "store")
        ref = ref_pl.refine(data, labels, rcfg,
                            mesh=ref_mesh_mod.make_mesh(8))
        got = refine(data, labels, cfg, device="cpu", mesh=_mesh(4))
        _assert_labels_equal(got, ref)
        np.testing.assert_array_equal(got.de_gene_union_idx,
                                      ref.de_gene_union_idx)
        np.testing.assert_array_equal(got.embedding, ref.embedding)
        for a, b in zip(got.deep_split_info, ref.deep_split_info):
            assert abs(a["silhouette"] - b["silhouette"]) < 1e-4
        stages = _resume_transitions(got.metrics["robustness"], 8,
                                     [0, 1, 2, 3])
        assert {"de", "union", "embed", "tree", "cuts"} <= stages
        validate_robustness(got.metrics["robustness"])

    def test_a_port_store_at_8_resumes_in_the_reference_at_4(
        self, tmp_path, small_case
    ):
        data, labels = small_case
        rcfg, cfg = _configs(tmp_path / "store")
        got = refine(data, labels, cfg, device="cpu", mesh=_mesh(8))
        ref = ref_pl.refine(data, labels, rcfg,
                            mesh=ref_mesh_mod.make_mesh(4))
        _assert_labels_equal(ref, got)
        np.testing.assert_array_equal(ref.embedding, got.embedding)
        stages = _resume_transitions(ref.metrics["robustness"], 8,
                                     [0, 1, 2, 3])
        assert {"de", "union", "embed", "tree", "cuts"} <= stages


# --------------------------------------------------------------------------
# retry-budget persistence across kill and resume
# --------------------------------------------------------------------------

class TestBudgetPersistence:
    def test_killed_run_cannot_refresh_budget_on_resume(
        self, tmp_path, monkeypatch, small_case
    ):
        data, labels = small_case
        store_dir = str(tmp_path / "store")
        monkeypatch.setenv("SCC_ROBUST_BUDGET", "3")
        # run 1 dies at stage:tree with 2 of the 3 budget slots burnt
        _plan(tmp_path, [{"site": "stage:tree", "class": "transient",
                          "times": 99}], monkeypatch)
        with pytest.raises(faults.InjectedTransientError):
            _run(data, labels, None, artifact_dir=store_dir)
        _, meta = ArtifactStore(store_dir).load("robust_state")
        assert meta["budget_used"] == 2

        # a new process over the same store starts from used = 2: its
        # first retry spends the allowance and the second fault re-raises
        _plan(tmp_path, [{"site": "stage:union", "class": "transient",
                          "times": 2}], monkeypatch, name="plan2.json")
        robust_record.begin_run()
        with pytest.raises(faults.InjectedTransientError):
            _run(data, labels, None, artifact_dir=store_dir)
        assert robust_record.current_run().budget_used == 3

        # control: the same double fault on a fresh store recovers
        faults.reset()
        res = _run(data, labels, None,
                   artifact_dir=str(tmp_path / "fresh"))
        assert res.metrics["robustness"]["recovered"] is True

    def test_successful_completion_resets_budget(self, tmp_path,
                                                 monkeypatch, small_case):
        data, labels = small_case
        store_dir = str(tmp_path / "store")
        _plan(tmp_path, [{"site": "stage:embed", "class": "transient",
                          "times": 2}], monkeypatch)
        res = _run(data, labels, None, artifact_dir=store_dir)
        assert res.metrics["robustness"]["recovered"] is True
        _, meta = ArtifactStore(store_dir).load("robust_state")
        assert meta["budget_used"] == 0


def test_integrity_section_clean_without_faults(small_case):
    assert integrity.enabled() is False
    data, labels = small_case
    res = _run(data, labels, _mesh(8))
    assert "robustness" not in res.metrics
