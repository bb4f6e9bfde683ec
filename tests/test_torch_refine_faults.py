"""``refine()`` under the fault plan and the typed retry policy, the
mid-stage Wilcoxon checkpoints and the persisted retry budget, against
the JAX package on the CPU.

The contract, as the reference's ``tests/test_robust_faults.py`` states
it: every injected fault at every stage boundary either recovers in the
process (oom, transient: retried by the policy, recorded on a validated
``robustness`` section) or resumes to labels identical to an
uninterrupted run (kill: the artifact store and the ladder's
``de_wilcox_*`` blocks). The kills are real SIGKILLs of a child process
that imports only the port. Half-finished stores cross between the
packages in both directions.

Tolerances: labels, DE masks and the port's own log p are compared bit
for bit with the port's unfaulted run. A store resumed across packages
mixes blocks from both rank-sum kernels, so its log p is held to the
port's parity band with the reference (rtol 1e-5, atol 1e-4: the same
float32 formula, jax's and torch's normal tails a few ulps apart) and
its DE mask exactly. The reference runs its scan kernel
(``SCC_NO_RUNSPACE=1``), the variant the port's block keys name."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import scconsensus_tpu.ops.ranksum_allpairs as ref_ra
from scconsensus_tpu.config import ReclusterConfig as RefConfig
from scconsensus_tpu.de.engine import pairwise_de as ref_pairwise_de
from scconsensus_tpu.models.pipeline import refine as ref_refine
from scconsensus_tpu.robust import faults as ref_faults
from scconsensus_tpu.robust import record as ref_record
from scconsensus_tpu.robust import retry as ref_retry
from scconsensus_tpu.utils.artifacts import ArtifactStore as RefStore
import scconsensus_tpu_torch as port
import scconsensus_tpu_torch.ops.ranksum_allpairs as port_ra
from scconsensus_tpu_torch.config import ReclusterConfig
from scconsensus_tpu_torch.de import engine as port_engine
from scconsensus_tpu_torch.models import pipeline as port_pipeline
from scconsensus_tpu_torch.robust import faults
from scconsensus_tpu_torch.robust import record as robust_record
from scconsensus_tpu_torch.robust import retry as robust_retry
from scconsensus_tpu_torch.robust.record import validate_robustness
from scconsensus_tpu_torch.utils.artifacts import ArtifactStore
from scconsensus_tpu_torch.utils.synthetic import (
    noisy_labeling,
    synthetic_scrna,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGE_SITES = ("stage:de", "stage:union", "stage:embed", "stage:tree",
               "stage:cuts", "stage:silhouette", "stage:nodg")
# 16 genes a block on the 60-gene case: four ladder buckets
TINY_BUDGET = 16 * 256 * 3
# the reference's scan kernel, before any test wraps it
_REF_CHUNK = ref_ra.allpairs_ranksum_chunk


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # the suite runs six workers on the machine's cores; two torch threads
    # a worker keep these small tensors from crowding out the other files
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
    # the default policy reads its backoff when first built: rebuild it
    for mod in (robust_retry, ref_retry):
        monkeypatch.setattr(mod, "_DEFAULT", None)
    for mod in (faults, ref_faults):
        mod.reset()
    for mod in (robust_record, ref_record):
        mod.begin_run()
    yield
    faults.reset()
    ref_faults.reset()


@pytest.fixture(scope="module")
def small_case():
    data, truth, _ = synthetic_scrna(
        n_genes=60, n_cells=150, n_clusters=3, n_markers_per_cluster=8,
        seed=11,
    )
    return data, noisy_labeling(truth, 0.05, seed=2)


def _cfg(**kw):
    return ReclusterConfig(deep_split_values=(1, 2), **kw)


@pytest.fixture(scope="module")
def clean(small_case):
    data, labels = small_case
    return port.refine(data, labels, _cfg(), device="cpu")


def _plan(tmp_path, rules, monkeypatch, name="plan.json"):
    path = tmp_path / name
    path.write_text(json.dumps({"faults": rules}))
    monkeypatch.setenv("SCC_FAULT_PLAN", str(path))
    faults.reset()
    ref_faults.reset()
    return str(path)


def _same_labels(res, ref):
    assert res.dynamic_labels.keys() == ref.dynamic_labels.keys()
    for key in ref.dynamic_labels:
        np.testing.assert_array_equal(res.dynamic_labels[key],
                                      ref.dynamic_labels[key])


def _blocks(root):
    return sorted(n for n in os.listdir(root)
                  if n.startswith("de_wilcox_") and n.endswith(".npz"))


# --------------------------------------------------------------------------
# the fault matrix: in-process recovery at every stage boundary
# --------------------------------------------------------------------------

class TestFaultMatrix:
    @pytest.mark.parametrize("site", STAGE_SITES)
    @pytest.mark.parametrize("fclass", ("oom", "transient"))
    def test_recovers_in_process_with_identical_labels(
        self, tmp_path, monkeypatch, small_case, clean, site, fclass
    ):
        data, labels = small_case
        _plan(tmp_path, [{"site": site, "class": fclass}], monkeypatch)
        res = port.refine(data, labels, _cfg(), device="cpu")
        _same_labels(res, clean)
        rb = res.metrics["robustness"]
        assert rb["recovered"] is True
        assert any(f["site"] == site and f["class"] == fclass
                   for f in rb["faults_injected"])
        assert any(r["site"] == site and r["recovered"]
                   for r in rb["retries"])
        expected = "resource" if fclass == "oom" else "transient"
        assert all(r["error_class"] == expected for r in rb["retries"]
                   if r["site"] == site)
        validate_robustness(rb)

    @pytest.mark.parametrize("site", ["stage:embed", "stage:tree"])
    def test_the_reference_records_the_same_recovery(
        self, tmp_path, monkeypatch, small_case, site
    ):
        data, labels = small_case
        _plan(tmp_path, [{"site": site, "class": "oom"}], monkeypatch)
        res = port.refine(data, labels, _cfg(), device="cpu")
        ref = ref_refine(data, labels, RefConfig(deep_split_values=(1, 2)),
                         mesh=None)
        rb, rrb = res.metrics["robustness"], ref.metrics["robustness"]
        for k in ("faults_injected", "retries", "recovered", "budget"):
            assert rb[k] == rrb[k], k
        # the embed's degrade hook under the reference's action name
        assert [(d["site"], d["action"]) for d in rb["degradations"]] == \
            [(d["site"], d["action"]) for d in rrb["degradations"]]

    def test_wilcox_bucket_oom_degrades_and_recovers(
        self, tmp_path, monkeypatch, small_case, clean
    ):
        data, labels = small_case
        _plan(tmp_path, [{"site": "wilcox_bucket", "class": "oom"}],
              monkeypatch)
        res = port.refine(data, labels, _cfg(), device="cpu")
        _same_labels(res, clean)
        np.testing.assert_array_equal(res.de.log_p.numpy(),
                                      clean.de.log_p.numpy())
        rb = res.metrics["robustness"]
        assert any(d["site"] == "wilcox_bucket"
                   and d["action"] == "halve-chunk-budget"
                   for d in rb["degradations"])
        assert any(r["site"] == "wilcox_bucket" and r["recovered"]
                   and r["error_class"] == "resource"
                   for r in rb["retries"])

    def test_input_staging_oom_frees_and_uploads_again(
        self, tmp_path, monkeypatch, small_case, clean
    ):
        from scconsensus_tpu_torch.utils import devcache

        data, labels = small_case
        # the clean run cached this array's upload (utils.devcache): drop
        # it, so the run uploads and the plan's fault fires
        devcache.clear_cache()
        _plan(tmp_path, [{"site": "input_staging", "class": "oom"}],
              monkeypatch)
        res = port.refine(data, labels, _cfg(), device="cpu")
        _same_labels(res, clean)
        rb = res.metrics["robustness"]
        assert [(d["site"], d["action"]) for d in rb["degradations"]] == \
            [("input_staging", "evict-devcache")]
        assert any(r["site"] == "input_staging" and r["recovered"]
                   for r in rb["retries"])

    def test_stall_fault_completes_and_is_recorded(
        self, tmp_path, monkeypatch, small_case, clean
    ):
        data, labels = small_case
        _plan(tmp_path, [{"site": "stage:tree", "class": "stall",
                          "stall_s": 0.05}], monkeypatch)
        res = port.refine(data, labels, _cfg(), device="cpu")
        _same_labels(res, clean)
        rb = res.metrics["robustness"]
        assert any(f["class"] == "stall" for f in rb["faults_injected"])

    def test_healthy_run_carries_no_section(self, small_case):
        data, labels = small_case
        res = port.refine(data, labels, _cfg(), device="cpu")
        assert "robustness" not in res.metrics

    def test_contract_repairs_land_on_the_robustness_log(self, small_case):
        """A labeling with a sub-floor cluster: the input contract's
        repair is noted as the reference notes it, so the run carries the
        reference's robustness section."""
        data, labels = small_case
        labels = labels.copy()
        labels[:3] = "tiny"
        res = port.refine(data, labels, _cfg(), device="cpu")
        ref = ref_refine(data, labels, RefConfig(deep_split_values=(1, 2)),
                         mesh=None)
        rb, rrb = res.metrics["robustness"], ref.metrics["robustness"]
        assert rb["degradations"] == rrb["degradations"]
        assert rb["degradations"][0]["action"] == "repair:small_clusters"
        assert rb["recovered"] is rrb["recovered"] is False

    def test_fatal_errors_are_not_retried(self, small_case):
        data, labels = small_case
        with pytest.raises(ValueError):
            port.refine(data, labels[:10], _cfg(), device="cpu")
        assert not robust_record.current_run().retries


# --------------------------------------------------------------------------
# kill + resume (a real SIGKILL of a child, then an identical resume)
# --------------------------------------------------------------------------

_KILL_SCRIPT = """
import sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(2)
import scconsensus_tpu_torch as port
import scconsensus_tpu_torch.ops.ranksum_allpairs as ra
from scconsensus_tpu_torch.utils.synthetic import noisy_labeling, synthetic_scrna

if {budget!r} is not None:
    ra.ALLPAIRS_ELEM_BUDGET = {budget!r}
data, truth, _ = synthetic_scrna(n_genes=60, n_cells=150, n_clusters=3,
                                 n_markers_per_cluster=8, seed=11)
labels = noisy_labeling(truth, 0.05, seed=2)
port.refine(data, labels,
            port.ReclusterConfig(deep_split_values=(1, 2),
                                 artifact_dir={store!r}),
            device="cpu")
print("UNEXPECTED: refine survived a kill fault")
"""


def _killed_child(plan, store_dir, budget=None):
    env = dict(os.environ)
    env["SCC_FAULT_PLAN"] = plan
    env.pop("SCC_ROBUST_BACKOFF_S", None)
    proc = subprocess.run(
        [sys.executable, "-c",
         _KILL_SCRIPT.format(repo=REPO, store=store_dir, budget=budget)],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == -9, (
        f"rc={proc.returncode} stdout={proc.stdout[-300:]} "
        f"stderr={proc.stderr[-600:]}"
    )


class TestKillResume:
    def test_sigkill_mid_pipeline_resumes_identically(
        self, tmp_path, small_case, clean, monkeypatch
    ):
        data, labels = small_case
        store_dir = str(tmp_path / "store")
        plan = tmp_path / "kill.json"
        plan.write_text(json.dumps({"faults": [{"site": "stage:cuts",
                                                "class": "kill"}]}))
        _killed_child(str(plan), store_dir)
        # the store holds only complete pre-kill stages, no temp litter
        store = ArtifactStore(store_dir)
        for done in ("de", "union", "embed", "tree"):
            assert store.has(done), f"stage {done} missing after kill"
        assert not store.has("cuts")
        assert not [n for n in os.listdir(store_dir) if ".scc-tmp-" in n]
        assert not _blocks(store_dir)
        # resume in the process with no plan: the finished stages load
        monkeypatch.setattr(
            port_pipeline, "pairwise_de",
            lambda *a, **kw: (_ for _ in ()).throw(
                AssertionError("de re-ran on resume")),
        )
        res = port.refine(data, labels, _cfg(artifact_dir=store_dir),
                          device="cpu")
        _same_labels(res, clean)

    def test_sigkill_at_wilcox_bucket_resumes_the_finished_buckets(
        self, tmp_path, small_case, clean, monkeypatch
    ):
        data, labels = small_case
        store_dir = str(tmp_path / "store")
        plan = tmp_path / "kill.json"
        plan.write_text(json.dumps({"faults": [{"site": "wilcox_bucket",
                                                "class": "kill",
                                                "after": 2}]}))
        _killed_child(str(plan), store_dir, budget=TINY_BUDGET)
        assert len(_blocks(store_dir)) == 2, "the two finished buckets"
        assert not ArtifactStore(store_dir).has("de")
        # resume: a plan whose rule never fires counts the bucket visits
        monkeypatch.setattr(port_ra, "ALLPAIRS_ELEM_BUDGET", TINY_BUDGET)
        _plan(tmp_path, [{"site": "wilcox_bucket", "class": "stall",
                          "after": 10 ** 9}], monkeypatch, name="count.json")
        res = port.refine(data, labels, _cfg(artifact_dir=store_dir),
                          device="cpu")
        n_buckets = len(res.metrics["wilcox_ladder"]["buckets"]) + 2
        assert n_buckets == 4
        assert faults._HITS[0] == n_buckets - 2, "only the rest ran"
        (rp,) = res.metrics["robustness"]["resume_points"]
        assert (rp["stage"], rp["unit"], rp["completed"], rp["total"]) == \
            ("wilcox_test", "bucket", 2, n_buckets)
        _same_labels(res, clean)
        np.testing.assert_array_equal(res.de.log_p.numpy(),
                                      clean.de.log_p.numpy())
        # the blocks are gone once de saved, and the budget reads 0
        assert not _blocks(store_dir)
        _, meta = ArtifactStore(store_dir).load("robust_state")
        assert meta["budget_used"] == 0


# --------------------------------------------------------------------------
# mid-stage Wilcoxon checkpoints
# --------------------------------------------------------------------------

@pytest.fixture
def tiny_budget(monkeypatch):
    """Both packages' ladder element budget shrunk so the 60-gene case
    splits into four buckets of 16 genes."""
    monkeypatch.setattr(port_ra, "ALLPAIRS_ELEM_BUDGET", TINY_BUDGET)
    monkeypatch.setattr(ref_ra, "_ALLPAIRS_ELEM_BUDGET", TINY_BUDGET)
    monkeypatch.setenv("SCC_NO_RUNSPACE", "1")


def _port_de(small_case, store):
    data, labels = small_case
    return port_engine.pairwise_de(data, labels, _cfg(), device="cpu",
                                   store=store)


def _ref_de(small_case, store):
    data, labels = small_case
    return ref_pairwise_de(data, labels, RefConfig(deep_split_values=(1,)),
                           store=store)


def _count_port_kernel(monkeypatch, die_after=None):
    calls = {"n": 0}
    real = port_ra.ranksum_body  # the kernel itself, never a wrapper

    def counting(*a, **kw):
        calls["n"] += 1
        if die_after is not None and calls["n"] > die_after:
            raise KeyboardInterrupt("killed mid-ladder")
        return real(*a, **kw)

    monkeypatch.setattr(port_engine, "ranksum_body", counting)
    return calls


def _count_ref_kernel(monkeypatch, die_after=None):
    calls = {"n": 0}
    real = _REF_CHUNK

    def counting(*a, **kw):
        calls["n"] += 1
        if die_after is not None and calls["n"] > die_after:
            raise KeyboardInterrupt("killed mid-ladder")
        return real(*a, **kw)

    monkeypatch.setattr(ref_ra, "allpairs_ranksum_chunk", counting)
    return calls


class TestWilcoxMidStageResume:
    def test_completed_buckets_resume_without_recompute(
        self, tmp_path, small_case, tiny_budget, monkeypatch
    ):
        store = ArtifactStore(str(tmp_path))
        first = _port_de(small_case, store)
        parts = _blocks(str(tmp_path))
        assert len(parts) == 4, "the case spans four buckets"
        calls = _count_port_kernel(monkeypatch)
        robust_record.begin_run()
        second = _port_de(small_case, store)
        assert calls["n"] == 0, "a resume dispatches no bucket"
        np.testing.assert_array_equal(second.log_p.numpy(),
                                      first.log_p.numpy())
        np.testing.assert_array_equal(second.de_mask.numpy(),
                                      first.de_mask.numpy())
        (rp,) = robust_record.current_run().resume_points
        assert rp["stage"] == "wilcox_test" and rp["unit"] == "bucket"
        assert rp["completed"] == rp["total"] == len(parts)

    def test_interrupt_mid_ladder_resumes_from_completed_buckets(
        self, tmp_path, small_case, tiny_budget, monkeypatch
    ):
        ref = _port_de(small_case, ArtifactStore(None))
        store = ArtifactStore(str(tmp_path))
        _count_port_kernel(monkeypatch, die_after=2)
        with pytest.raises(KeyboardInterrupt):
            _port_de(small_case, store)
        assert len(_blocks(str(tmp_path))) == 2, \
            "exactly the completed buckets persist"
        calls = _count_port_kernel(monkeypatch)
        robust_record.begin_run()
        res = _port_de(small_case, store)
        assert calls["n"] == 2
        np.testing.assert_array_equal(res.log_p.numpy(), ref.log_p.numpy())
        np.testing.assert_array_equal(res.de_mask.numpy(),
                                      ref.de_mask.numpy())
        (rp,) = robust_record.current_run().resume_points
        assert rp["completed"] == 2 and rp["total"] == 4

    def test_pipeline_discards_parts_after_de_artifact(
        self, tmp_path, small_case, tiny_budget
    ):
        data, labels = small_case
        store_dir = str(tmp_path / "store")
        port.refine(data, labels, _cfg(artifact_dir=store_dir),
                    device="cpu")
        assert ArtifactStore(store_dir).has("de")
        assert not [n for n in os.listdir(store_dir)
                    if n.startswith("de_wilcox_")], (
            "bucket checkpoints are discarded once the covering de "
            "artifact lands")

    def test_ckpt_off_flag(self, tmp_path, small_case, tiny_budget,
                           monkeypatch):
        monkeypatch.setenv("SCC_ROBUST_DE_CKPT", "0")
        _port_de(small_case, ArtifactStore(str(tmp_path)))
        assert not [n for n in os.listdir(str(tmp_path))
                    if n.startswith("de_wilcox_")]

    def test_block_keys_and_arrays_are_the_reference_s(
        self, tmp_path, small_case, tiny_budget
    ):
        ours, theirs = str(tmp_path / "port"), str(tmp_path / "ref")
        _port_de(small_case, ArtifactStore(ours))
        _ref_de(small_case, RefStore(theirs))
        assert _blocks(ours) == _blocks(theirs)
        assert len(_blocks(ours)) == 4
        for name in _blocks(ours):
            stage = name[:-len(".npz")]
            a, meta = ArtifactStore(ours).load(stage)
            b, ref_meta = RefStore(theirs).load(stage)
            assert sorted(a) == sorted(b) == ["lp", "ts", "u"]
            assert meta["mesh_shape"] == ref_meta["mesh_shape"]
            for k in ("u", "ts"):
                np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_allclose(a["lp"], b["lp"], rtol=1e-5,
                                       atol=1e-4)

    def test_a_corrupt_block_is_quarantined_and_recomputed(
        self, tmp_path, small_case, tiny_budget, monkeypatch
    ):
        """A resume checks every stored block up front; the one whose
        bytes changed is quarantined when its bucket asks for it and that
        bucket alone runs again, to the same result."""
        store = ArtifactStore(str(tmp_path))
        first = _port_de(small_case, store)
        name = _blocks(str(tmp_path))[1]
        path = tmp_path / name
        raw = bytearray(path.read_bytes())
        raw[len(raw) // 2] ^= 0xFF
        path.write_bytes(bytes(raw))
        calls = _count_port_kernel(monkeypatch)
        robust_record.begin_run()
        second = _port_de(small_case, store)
        assert calls["n"] == 1
        np.testing.assert_array_equal(second.log_p.numpy(),
                                      first.log_p.numpy())
        run = robust_record.current_run()
        (rp,) = run.resume_points
        assert (rp["completed"], rp["total"]) == (3, 4)
        assert [d["site"] for d in run.degradations] == \
            [f"artifact:{name[:-len('.npz')]}"]
        assert any(n.startswith(name + ".quarantined")
                   for n in os.listdir(str(tmp_path)))

    def test_blocks_are_written_uncompressed(self, tmp_path, small_case,
                                             tiny_budget):
        """The ladder's blocks are plain npz members (zlib cannot shrink
        float32 log p, U and ties); the ``de`` artifact stays compressed.
        The sidecar's checksum covers the bytes either way."""
        import zipfile

        store_dir = str(tmp_path / "store")
        _port_de(small_case, ArtifactStore(store_dir))
        assert _blocks(store_dir)
        for name in _blocks(store_dir):
            with zipfile.ZipFile(os.path.join(store_dir, name)) as z:
                assert {i.compress_type for i in z.infolist()} == \
                    {zipfile.ZIP_STORED}
            a, _ = RefStore(store_dir).load(name[:-len(".npz")])
            assert sorted(a) == ["lp", "ts", "u"]
        data, labels = small_case
        port.refine(data, labels, _cfg(artifact_dir=store_dir),
                    device="cpu")
        with zipfile.ZipFile(os.path.join(store_dir, "de.npz")) as z:
            assert {i.compress_type for i in z.infolist()} == \
                {zipfile.ZIP_DEFLATED}

    @pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
    def test_half_finished_store_crosses(
        self, tmp_path, small_case, tiny_budget, monkeypatch, direction
    ):
        store_dir = str(tmp_path / "store")
        clean_port = _port_de(small_case, ArtifactStore(None))
        if direction == "ref_to_port":
            _count_ref_kernel(monkeypatch, die_after=2)
            with pytest.raises(KeyboardInterrupt):
                _ref_de(small_case, RefStore(store_dir))
            assert len(_blocks(store_dir)) == 2
            calls = _count_port_kernel(monkeypatch)
            robust_record.begin_run()
            res = _port_de(small_case, ArtifactStore(store_dir))
            (rp,) = robust_record.current_run().resume_points
            got_mask, got_lp = res.de_mask.numpy(), res.log_p.numpy()
            want_mask, want_lp = (clean_port.de_mask.numpy(),
                                  clean_port.log_p.numpy())
        else:
            _count_port_kernel(monkeypatch, die_after=2)
            with pytest.raises(KeyboardInterrupt):
                _port_de(small_case, ArtifactStore(store_dir))
            assert len(_blocks(store_dir)) == 2
            clean_ref = _ref_de(small_case, RefStore(None))
            calls = _count_ref_kernel(monkeypatch)
            ref_record.begin_run()
            res = _ref_de(small_case, RefStore(store_dir))
            (rp,) = ref_record.current_run().resume_points
            got_mask, got_lp = (np.asarray(res.de_mask),
                                np.asarray(res.log_p))
            want_mask, want_lp = (np.asarray(clean_ref.de_mask),
                                  np.asarray(clean_ref.log_p))
        assert calls["n"] == 2, "only the unfinished buckets ran"
        assert (rp["completed"], rp["total"]) == (2, 4)
        np.testing.assert_array_equal(got_mask, want_mask)
        np.testing.assert_allclose(got_lp, want_lp, rtol=1e-5, atol=1e-4)


# --------------------------------------------------------------------------
# the retry budget persisted in robust_state.json
# --------------------------------------------------------------------------

class TestBudgetPersistence:
    def test_budget_seeded_from_robust_state(self, tmp_path, small_case,
                                             monkeypatch):
        """A store whose robust_state says the budget is spent gives a
        resumed run no retry, in both packages."""
        data, labels = small_case
        monkeypatch.setenv("SCC_ROBUST_BUDGET", "2")
        _plan(tmp_path, [{"site": "stage:embed", "class": "transient"}],
              monkeypatch)
        for name, run, store_cls, exc in (
            ("port", lambda d: port.refine(
                data, labels, _cfg(artifact_dir=d), device="cpu"),
             ArtifactStore, faults.InjectedTransientError),
            ("ref", lambda d: ref_refine(
                data, labels, RefConfig(deep_split_values=(1, 2),
                                        artifact_dir=d), mesh=None),
             RefStore, ref_faults.InjectedTransientError),
        ):
            d = str(tmp_path / name)
            store_cls(d).save("robust_state", meta={"budget_used": 2})
            faults.reset()
            ref_faults.reset()
            with pytest.raises(exc):
                run(d)
            # a failed run leaves its count standing for the next attempt
            assert store_cls(d).load("robust_state")[1]["budget_used"] == 2

    def test_every_take_is_mirrored_and_survives_a_kill(
        self, tmp_path, small_case, clean
    ):
        data, labels = small_case
        store_dir = str(tmp_path / "store")
        plan = tmp_path / "plan.json"
        plan.write_text(json.dumps({"faults": [
            {"site": "stage:tree", "class": "transient"},
            {"site": "stage:cuts", "class": "kill"},
        ]}))
        _killed_child(str(plan), store_dir)
        _, meta = ArtifactStore(store_dir).load("robust_state")
        assert meta["budget_used"] == 1
        # the resumed run starts from the persisted count and resets it
        # once it completes
        res = port.refine(data, labels, _cfg(artifact_dir=store_dir),
                          device="cpu")
        _same_labels(res, clean)
        assert res.metrics["robustness"]["budget"]["used"] == 1
        _, meta = ArtifactStore(store_dir).load("robust_state")
        assert meta["budget_used"] == 0
