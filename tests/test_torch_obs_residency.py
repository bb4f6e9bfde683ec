"""The port's residency auditor (``obs.residency``) against the
reference's: the crossing hook's basics, enforcement, the section's
validation, and refine()'s device path at 800 cells under audit and
enforce, with the boundaries the reference's audited run crosses on CPU
JAX. On the CPU nothing crosses a link, so the tests name the CPU as the
device side (``device_types=("cpu",)``, what ``refine()`` passes for a
CPU run): a CPU tensor's ``.numpy()`` or ``bool()`` is then the crossing
the card run makes with ``.cpu()`` or ``.item()``."""

import numpy as np
import pytest
import torch

import scconsensus_tpu.obs.residency as ref_residency
import scconsensus_tpu_torch as port
from scconsensus_tpu.obs.export import validate_run_record as ref_validate
from scconsensus_tpu.utils.synthetic import noisy_labeling, synthetic_scrna
from scconsensus_tpu_torch import ReclusterConfig
from scconsensus_tpu_torch.obs import residency
from scconsensus_tpu_torch.obs.device import TransferWatch
from scconsensus_tpu_torch.obs.export import (
    build_run_record,
    validate_run_record,
)
from scconsensus_tpu_torch.obs.residency import (
    BOUNDARIES,
    ResidencyAuditor,
    ResidencyError,
    boundary,
    stage_transfer_bytes,
    validate_residency,
)
from scconsensus_tpu_torch.obs.trace import Tracer

CPU = ("cpu",)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _audit(mode="audit"):
    return ResidencyAuditor(mode=mode, device_types=CPU)


class TestAuditorBasics:
    def test_off_mode_is_a_noop(self):
        with ResidencyAuditor(mode="off", device_types=CPU) as a:
            torch.arange(4.0).numpy()
        assert a.n_events == 0

    def test_audit_records_a_fetch_with_its_source_line(self):
        x = torch.arange(32.0)
        with _audit() as a:
            x.numpy()
        d2h = [e for e in a.report()["events"] if e["direction"] == "d2h"]
        assert len(d2h) == 1 and d2h[0]["nbytes"] == 32 * 4
        assert d2h[0]["api"] == "Tensor.numpy"
        # attributed to this file, not to the auditor or torch
        assert d2h[0]["where"].startswith("test_torch_obs_residency.py:")

    def test_implicit_forms_are_marked(self):
        x = torch.ones(3)
        with _audit() as a:
            bool(x.any())
            int(x.sum())
            float(x[0])
        ev = a.report()["events"]
        assert [e["api"] for e in ev] == [
            "Tensor.__bool__", "Tensor.__int__", "Tensor.__float__"]
        assert all(e["implicit"] for e in ev)

    def test_audit_records_span_attribution(self):
        tr = Tracer(sync="off")
        x = torch.arange(8.0)
        with _audit() as a:
            with tr.span("mystage", kind="stage"):
                with tr.span("inner"):
                    x.numpy()
        ev = [e for e in a.report()["events"] if e["direction"] == "d2h"][0]
        assert (ev["span"], ev["stage"]) == ("inner", "mystage")
        assert a.report()["by_stage"]["mystage"]["to_host_bytes"] == 32

    def test_obs_internal_excluded_from_gated_stage_totals(self):
        tr = Tracer(sync="off")
        x = torch.arange(8.0)
        with _audit() as a:
            with tr.span("stagex", kind="stage"):
                with boundary("obs_internal"):
                    x.numpy()
        rep = a.report()
        assert rep["to_host"]["bytes"] == 32
        assert rep["by_boundary"]["obs_internal"]["to_host_bytes"] == 32
        assert "stagex" not in rep["by_stage"]

    def test_failed_transfer_not_billed(self):
        host = np.ones(64, np.float32)
        with _audit() as a:
            with pytest.raises(TypeError):
                torch.as_tensor(host, dtype="not-a-dtype")
            torch.as_tensor(host)  # the retry
        assert a.to_device_bytes == 64 * 4

    def test_audit_records_h2d_staging(self):
        host = np.ones(64, np.float32)
        with _audit() as a:
            torch.as_tensor(host)
            torch.from_numpy(host)
        h2d = [e for e in a.report()["events"] if e["direction"] == "h2d"]
        assert [e["nbytes"] for e in h2d] == [64 * 4, 64 * 4]

    def test_no_double_count_through_delegation(self):
        """``np.asarray`` reaches ``Tensor.__array__``, which calls the
        patched ``.numpy()``; ``x.cpu().numpy()`` moves nothing on the CPU
        and fetches once: each records exactly one event."""
        x = torch.ones(16)
        with _audit() as a:
            np.asarray(x)
            x.cpu().numpy()
        d2h = [e for e in a.report()["events"] if e["direction"] == "d2h"]
        assert len(d2h) == 2
        # a move across the line (here to the meta device) is one event
        with ResidencyAuditor(mode="audit", device_types=("meta",)) as a:
            x.to("meta")
        assert [(e["api"], e["direction"]) for e in a.report()["events"]] \
            == [("Tensor.to", "h2d")]

    def test_unpatched_after_exit(self):
        names = ("cpu", "cuda", "to", "item", "tolist", "numpy", "__bool__",
                 "__int__", "__float__", "copy_")
        before = {n: torch.Tensor.__dict__.get(n) for n in names}
        staging = (torch.as_tensor, torch.tensor, torch.from_numpy)
        with _audit():
            assert torch.as_tensor is not staging[0]
            with TransferWatch(device_types=CPU):
                pass
            assert torch.Tensor.__dict__.get("numpy") is not None
        assert {n: torch.Tensor.__dict__.get(n) for n in names} == before
        assert (torch.as_tensor, torch.tensor, torch.from_numpy) == staging

    def test_transferwatch_misses_what_the_auditor_catches(self):
        """The implicit forms are the auditor's alone, as in the
        reference: the watch counts explicit copies."""
        x = torch.ones(1024)
        with TransferWatch(device_types=CPU) as w:
            bool(x.all())
        assert w.to_host_calls == 0
        with _audit() as a:
            bool(x.all())
        assert a.to_host_calls == 1

    def test_consumed_cpu_grows_and_resets(self):
        residency.reset_cpu()
        assert residency.consumed_cpu_s() == 0.0
        with _audit():
            for _ in range(20):
                torch.ones(4).numpy()
        assert residency.consumed_cpu_s() > 0.0
        residency.reset_cpu()
        assert residency.consumed_cpu_s() == 0.0

    def test_listeners_see_notes_or_events_never_both(self):
        got = []

        def listen(direction, nbytes, bound):
            got.append((direction, nbytes, bound))

        residency.add_transfer_listener(listen)
        try:
            with boundary("stream_block_fetch"):
                residency.note_transfer("d2h", 12)
            assert got == [("d2h", 12, "stream_block_fetch")]
            got.clear()
            with _audit():
                with boundary("stream_block_fetch"):
                    residency.note_transfer("d2h", 12)  # the hook's job
                    torch.ones(3).numpy()
            assert got == [("d2h", 12, "stream_block_fetch")]
        finally:
            residency.remove_transfer_listener(listen)


class TestEnforcement:
    def test_enforce_raises_outside_boundary(self):
        with pytest.raises(ResidencyError, match="Tensor.numpy"):
            with _audit("enforce"):
                torch.arange(16.0).numpy()

    def test_enforce_names_the_span_and_line(self):
        tr = Tracer(sync="off")
        with pytest.raises(ResidencyError,
                           match=r"offending_span.*test_torch_obs_residency"):
            with _audit("enforce"):
                with tr.span("offending_span", kind="stage"):
                    torch.arange(16.0).tolist()

    def test_enforce_allows_declared_boundary(self):
        with _audit("enforce") as a:
            with boundary("label_fetch"):
                torch.arange(16.0).numpy()
        rep = a.report()
        assert [e["boundary"] for e in rep["events"]] == ["label_fetch"]
        assert rep["violations"] == []

    def test_enforce_allows_small_h2d_blocks_large(self):
        with _audit("enforce"):
            torch.as_tensor(np.ones(128, np.float32))
        with pytest.raises(ResidencyError, match="h2d"):
            with _audit("enforce"):
                torch.as_tensor(np.ones((512, 1024), np.float32))

    def test_undeclared_boundary_name_raises_keyerror(self):
        with pytest.raises(KeyError, match="undeclared"):
            with boundary("not_a_real_boundary"):
                pass

    def test_reentrant_auditor_rejected(self):
        with _audit():
            with pytest.raises(RuntimeError, match="already active"):
                _audit().__enter__()

    def test_unknown_mode_rejected(self, monkeypatch):
        monkeypatch.setenv("SCC_OBS_RESIDENCY", "enfrce")
        with pytest.raises(ValueError, match="SCC_OBS_RESIDENCY"):
            ResidencyAuditor()


# --------------------------------------------------------------------------
# refine()'s device path at 800 cells
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def workload():
    data, truth, _ = synthetic_scrna(n_genes=200, n_cells=800, n_clusters=4,
                                     seed=5)
    return data.astype(np.float32), noisy_labeling(truth, 0.05, seed=1)


@pytest.fixture(scope="module")
def runs(workload):
    data, labels = workload
    mp = pytest.MonkeyPatch()
    out = {"base": port.refine(data, labels, ReclusterConfig(),
                               device="cpu")}
    try:
        for mode in ("audit", "enforce"):
            mp.setenv("SCC_OBS_RESIDENCY", mode)
            out[mode] = port.refine(data, labels, ReclusterConfig(),
                                    device="cpu")
    finally:
        mp.undo()
    return out


@pytest.fixture(scope="module")
def reference_boundaries(workload):
    """The boundaries the reference's audited run crosses on CPU JAX at
    the same data."""
    import jax.numpy as jnp

    from scconsensus_tpu import recluster_de_consensus_fast

    data, labels = workload
    mp = pytest.MonkeyPatch()
    mp.setenv("SCC_OBS_RESIDENCY", "audit")
    try:
        res = recluster_de_consensus_fast(jnp.asarray(data), labels,
                                          mesh=None)
    finally:
        mp.undo()
    return set(res.metrics["residency"]["by_boundary"])


class TestDevicePath:
    def test_enforced_path_has_every_fetch_declared(self, runs):
        rep = runs["enforce"].metrics["residency"]
        assert rep["mode"] == "enforce" and rep["violations"] == []
        d2h = [e for e in rep["events"] if e["direction"] == "d2h"]
        assert d2h and all(e["boundary"] is not None for e in d2h)
        assert {"embed_scores_fetch", "funnel_counts",
                "silhouette_slab_fetch", "label_fetch",
                "input_staging"} <= set(rep["by_boundary"])
        validate_residency(rep)
        ref_residency.validate_residency(rep)

    def test_audit_section_rides_the_record(self, runs):
        rep = runs["audit"].metrics["residency"]
        rec = build_run_record("residency smoke", 1.0,
                               spans=runs["audit"].metrics["spans"],
                               residency=rep)
        validate_run_record(rec)
        ref_validate(rec)
        stb = stage_transfer_bytes(rec)
        assert stb["embed"] > 0 and stb["silhouette"] > 0
        assert stb == ref_residency.stage_transfer_bytes(rec)

    @pytest.mark.parametrize("mode", ["audit", "enforce"])
    def test_results_identical_when_observed(self, runs, mode):
        base, got = runs["base"], runs[mode]
        np.testing.assert_array_equal(base.de_gene_union_idx,
                                      got.de_gene_union_idx)
        np.testing.assert_array_equal(base.de.log_p.numpy(),
                                      got.de.log_p.numpy())
        for key in base.dynamic_labels:
            np.testing.assert_array_equal(base.dynamic_labels[key],
                                          got.dynamic_labels[key])
        assert [i["silhouette"] for i in base.deep_split_info] == \
            [i["silhouette"] for i in got.deep_split_info]

    def test_the_references_boundaries_are_crossed(self, runs,
                                                   reference_boundaries):
        """Every boundary the reference's audited run crosses, the port's
        crosses too, but for the differences listed here with their
        reasons."""
        ours = set(runs["audit"].metrics["residency"]["by_boundary"])
        reference_only = {
            # the reference's tracer drains the device by fetching a
            # 0-byte sentinel; the port's drain is torch.cuda.synchronize
            # (nothing on the CPU), which moves no bytes
            "obs_internal",
            # the reference's run-space kernel redoes the genes whose
            # tied runs overflow its table; the port's ladder runs the
            # scan body, which has no table and no redo
            "overflow_redo",
        }
        port_only = {
            # the index vectors each stage uploads (cluster ids, pairs,
            # gene ids): the reference stages them through jit arguments,
            # which its patches do not see
            "input_staging",
        }
        assert reference_boundaries - ours == reference_only
        assert ours - reference_boundaries == port_only


class TestValidation:
    def _minimal(self):
        return {"mode": "audit", "to_device": {"calls": 1, "bytes": 8},
                "to_host": {"calls": 0, "bytes": 0}, "by_stage": {},
                "by_boundary": {}, "events": [], "events_dropped": 0,
                "violations": []}

    def test_minimal_section_validates(self):
        validate_residency(self._minimal())

    @pytest.mark.parametrize("key,value,match", [
        ("mode", "sometimes", "mode"),
        ("by_boundary", {"made_up": {"to_host_bytes": 1,
                                     "to_device_bytes": 0, "calls": 1}},
         "undeclared"),
        ("to_host", {"calls": 1, "bytes": -5}, "to_host"),
        ("events", [{"direction": "sideways", "nbytes": 1}], "direction"),
    ])
    def test_bad_section_rejected_like_the_reference(self, key, value,
                                                     match):
        sec = self._minimal()
        sec[key] = value
        for validate in (validate_residency,
                         ref_residency.validate_residency):
            with pytest.raises(ValueError, match=match):
                validate(sec)

    def test_boundaries_are_the_references(self):
        assert BOUNDARIES == ref_residency.BOUNDARIES
        assert residency.MODES == ref_residency.MODES
        assert set(ref_residency.__all__) <= set(residency.__all__)
