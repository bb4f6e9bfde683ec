"""The port's graph passports (``obs.graphs``), held against the
reference's: the section builder, the validator, the per-stage ratchet
counts and the pins' digest give equal outputs on the same passports;
CPU captures of the instrumented programs give schema-valid passports
that both packages' validators accept; a host sync names its line; a
second call at a signature captures nothing, an unarmed registry
nothing at all; the fingerprint is torch's, so the reference's ratchet
and the reference's digest check both refuse it. The comparisons are of
pure functions on the same dicts, so every one is exact."""

import copy
import json
import pathlib
import time

import numpy as np
import pytest
import torch

import scconsensus_tpu.obs.graphs as ref_graphs
import scconsensus_tpu.obs.regress as ref_regress
import scconsensus_tpu_torch as port
from scconsensus_tpu.obs.export import validate_run_record as ref_validate
from scconsensus_tpu_torch.obs import export, graphs
from scconsensus_tpu_torch.obs import regress as port_regress
from scconsensus_tpu_torch.obs.trace import Tracer
from scconsensus_tpu_torch.ops import ranksum_allpairs
from scconsensus_tpu_torch.ops.gates import (
    compute_aggregates_cid,
    pair_gates_fast,
)
from scconsensus_tpu_torch.ops.pca import pca_scores
from scconsensus_tpu_torch.utils.synthetic import (
    noisy_labeling,
    synthetic_scrna,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
EVIDENCE = REPO / "evidence"
QUICK_R24 = EVIDENCE / "RUN_quick_cpu_dc28fb1eb588_1786061341.json"

_HLO = """\
HloModule synth, input_output_alias={ {}: (0, {}, may-alias) }

ENTRY %main (p0: f32[4,4]) -> f32[4,4] {
  %p0 = f32[4,4]{1,0} parameter(0)
  %fused = f32[4,4]{1,0} fusion(%p0), kind=kLoop, calls=%fcomp
  %cb = f32[4,4]{1,0} custom-call(%fused), custom_call_target="xla_python_cpu_callback", metadata={source_file="/w/scconsensus_tpu/ops/demo.py" source_line=9}
  %of = token[] outfeed(%cb), outfeed_shape=f32[4,4]{1,0}
  ROOT %r = f32[4,4]{1,0} copy(%cb)
}
"""

# the reference's passport programs (scconsensus_tpu/ops/*.py and
# de/edger.py, every `_passport(...)` call)
REFERENCE_PROGRAMS = {
    "distance.sq_dists", "distance.pearson_distance_matrix",
    "gates.compute_aggregates", "gates.compute_aggregates_cid",
    "gates.pair_gates_fast", "gates.pair_gates_slow", "embed.pca_scores",
    "embed.pca_scores_audited", "embed.pca_basis", "landmark.lloyd",
    "landmark.lloyd_sketch", "landmark.assign_blocks",
    "wilcox.allpairs_ranksum_chunk",
    "wilcox.allpairs_ranksum_runspace_chunk", "wilcox.sort_probe",
    "edger.sub_table_sorted_chunk", "edger.table_chunk",
}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def armed():
    graphs.install_and_mark(force=True)
    yield
    graphs.reset()


def _load(path):
    with open(path) as f:
        return json.load(f)


def _synthetic_passports():
    """Passports of both kinds: the port's builder and the reference's HLO
    parser (a hand-written module with a host callback, an outfeed and a
    donation header), over several stages and one program at two
    signatures."""
    return [
        graphs.build_passport(
            "gates.pair_gates_fast", {"gt": 4, "mul": 2,
                                      "_local_scalar_dense": 1},
            callbacks=[{"target": "_local_scalar_dense",
                        "where": "scconsensus_tpu_torch/ops/gates.py:120"}],
            memory={"argument_bytes": 100, "output_bytes": 40,
                    "temp_bytes": 10, "alias_bytes": 0},
            stage="gates", capture_s=0.001),
        graphs.build_passport(
            "gates.pair_gates_fast", {"gt": 4},
            transfers=[{"op": "_to_copy(cuda:0->cpu)", "where": None}],
            stage="gates", entry_ordinal=2),
        graphs.build_passport("embed.pca_scores", {"mm": 9}, stage="embed",
                              cost={"flops": 1e6, "bytes_accessed": 4e5}),
        graphs.build_passport("t.outside", {}),
        ref_graphs.passport_from_hlo("wilcox.chunk", _HLO, donated=2,
                                     stage="wilcox_test"),
    ]


# --------------------------------------------------------------------------
# the pure half
# --------------------------------------------------------------------------

def test_build_graphs_section_equals_the_reference():
    ps = _synthetic_passports()
    for errors in ((), ["wilcox.chunk: boom"]):
        got = graphs.build_graphs_section(copy.deepcopy(ps), errors=errors)
        want = ref_graphs.build_graphs_section(copy.deepcopy(ps),
                                               errors=errors)
        assert got == want
        graphs.validate_graphs(got)
        ref_graphs.validate_graphs(got)
    assert sorted(got["programs"])[:2] == ["embed.pca_scores",
                                          "gates.pair_gates_fast"]
    assert "gates.pair_gates_fast'" in got["programs"]


def test_passport_fields_follow_the_reference_schema():
    p = graphs.build_passport(
        "x", {"add": 2, "sort": 1},
        memory={"argument_bytes": 100, "output_bytes": 50,
                "temp_bytes": 30, "alias_bytes": 40})
    q = ref_graphs.passport_from_hlo("x", "")
    assert set(p) == set(q)
    assert p["fusions"] == 0 and p["ops"] == 3
    assert p["donation"] == {"declared": 0, "hits": 0, "misses": 0}
    assert p["buffers"]["peak_bytes"] == 100 + 50 + 30 - 40


def _section_breakages():
    return {
        "version": lambda s: s.update(version=2),
        "totals": lambda s: s["totals"].update(
            transfer_ops=s["totals"]["transfer_ops"] + 1),
        "unknown-program": lambda s: s["by_stage"]["gates"].update(
            programs=["ghost"]),
        "sites-count": lambda s: s["programs"]["gates.pair_gates_fast"][
            "host_callbacks"].update(count=5),
        "fusions": lambda s: s["programs"]["embed.pca_scores"].update(
            fusions=1),
        "ordinal": lambda s: s["programs"]["embed.pca_scores"].update(
            entry_ordinal=0),
        "errors": lambda s: s.update(errors=[1]),
    }


@pytest.mark.parametrize("breakage", sorted(_section_breakages()))
def test_both_validators_refuse_the_same_sections(breakage):
    sec = graphs.build_graphs_section(_synthetic_passports())
    _section_breakages()[breakage](sec)
    msgs = []
    for validate in (graphs.validate_graphs, ref_graphs.validate_graphs):
        with pytest.raises(ValueError) as ei:
            validate(copy.deepcopy(sec))
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_stage_counts_and_ratchet_ack_equal_the_reference():
    rec = _load(QUICK_R24)
    assert graphs.stage_graph_counts(rec) == \
        ref_graphs.stage_graph_counts(rec)
    mine = {"graphs": graphs.build_graphs_section(_synthetic_passports())}
    assert graphs.stage_graph_counts(mine) == \
        ref_graphs.stage_graph_counts(mine)
    assert graphs.stage_graph_counts({}) == {}
    entry = _load(EVIDENCE / "NUMERIC_PINS.json")["graph_ratchet"]["quick"]
    assert graphs.ratchet_ack(entry) == ref_graphs.ratchet_ack(entry) == \
        rec["extra"]["graph_ratchet_ack"]


# --------------------------------------------------------------------------
# the fingerprint: torch's, and refused where JAX's is expected
# --------------------------------------------------------------------------

def test_fingerprint_is_torch_identity():
    fp = graphs.environment_fingerprint()
    assert fp["torch"] == torch.__version__ and fp["backend"] == "cpu"
    assert fp["digest"] == graphs.fingerprint_digest(fp)
    assert graphs.fingerprint_digest(dict(fp, future="x")) == fp["digest"]
    assert graphs.fingerprint_digest(dict(fp, tf32_matmul=True)) != \
        fp["digest"]
    assert graphs.fingerprint_digest(dict(fp, nvcc_flags_sha="0" * 12)) \
        != fp["digest"]
    jax_fp = _load(QUICK_R24)["graphs"]["fingerprint"]
    assert graphs.fingerprint_digest(jax_fp) != jax_fp["digest"]
    rec = export.build_run_record("m", 1.0)
    assert rec["run"]["env_fingerprint"] == fp


def test_reference_ratchet_refuses_a_port_record(armed):
    """The committed ratchet pins JAX programs under a JAX digest: both
    packages' ``graphs_verdicts`` refuse to gate a port passport, with
    the reference's note."""
    x = torch.randn(40, 6)
    pca_scores(x, 3)
    rec = export.build_run_record("m", 1.0, graphs=graphs.snapshot())
    entry = _load(EVIDENCE / "NUMERIC_PINS.json")["graph_ratchet"]["quick"]
    for mod in (port_regress, ref_regress):
        verdicts, note = mod.graphs_verdicts(rec, entry)
        assert verdicts == [] and "different toolchain" in note


def test_reference_digest_check_refuses_the_port_fingerprint(armed):
    """The reference's validator recomputes the digest over JAX's fields:
    a port section passes it in every respect but its fingerprint."""
    pca_scores(torch.randn(40, 6), 3)
    sec = graphs.snapshot()
    graphs.validate_graphs(sec)
    with pytest.raises(ValueError, match="digest does not match"):
        ref_graphs.validate_graphs(sec)
    ref_graphs.validate_graphs({k: v for k, v in sec.items()
                                if k != "fingerprint"})


# --------------------------------------------------------------------------
# live capture on the CPU
# --------------------------------------------------------------------------

def _tiny_de_inputs():
    data, truth, _ = synthetic_scrna(n_genes=60, n_cells=150, n_clusters=3,
                                     n_markers_per_cluster=8, seed=3)
    x = torch.from_numpy(data)
    cid = torch.as_tensor(truth, dtype=torch.int64)
    pi, pj = (torch.as_tensor(a) for a in np.triu_indices(3, 1))
    return x, cid, pi, pj


def test_cpu_captures_validate_in_both_packages(armed):
    x, cid, pi, pj = _tiny_de_inputs()
    tr = Tracer(sync="off")
    with tr.span("aggregates", kind="stage"):
        agg = compute_aggregates_cid(x, cid, 3)
    with tr.span("gates", kind="stage"):
        pair_gates_fast(agg, pi, pj, 10.0, -float("inf"), 0.25, 0.0)
    with tr.span("wilcox_test", kind="stage"):
        n_of = torch.bincount(cid, minlength=3).to(torch.float32)
        ranksum_allpairs.ranksum_body(x[:16], cid, n_of, pi, pj, 3)
    with tr.span("embed", kind="stage"):
        pca_scores(x.T.contiguous(), 4)
    sec = graphs.snapshot()
    graphs.validate_graphs(sec)
    assert "errors" not in sec
    assert sorted(sec["by_stage"]) == ["aggregates", "embed", "gates",
                                       "wilcox_test"]
    assert sorted(p["program"] for p in sec["programs"].values()) == [
        "embed.pca_scores", "gates.compute_aggregates_cid",
        "gates.pair_gates_fast", "wilcox.allpairs_ranksum_chunk"]
    for p in sec["programs"].values():
        assert p["ops"] > 0 and p["fusions"] == 0
        b = p["buffers"]
        assert b["argument_bytes"] > 0 and b["output_bytes"] > 0
        assert b["peak_bytes"] >= b["argument_bytes"]
    body = sec["programs"]["wilcox.allpairs_ranksum_chunk"]
    assert body["op_histogram"]["sort"] == 1
    assert body["buffers"]["argument_bytes"] >= 16 * 150 * 4
    rec = export.build_run_record("m", 1.0, graphs=sec)
    export.validate_run_record(rec)
    # the reference's validator takes all of it but the fingerprint
    ref_rec = dict(rec, graphs={k: v for k, v in sec.items()
                                if k != "fingerprint"})
    ref_validate(ref_rec)


def _leaky(x):
    y = x * 2.0
    s = y.sum().item()  # the injected host sync
    return y + s


def test_an_injected_item_is_a_host_callback_naming_its_line(armed):
    f = graphs.instrument("t.leaky", _leaky)
    f(torch.ones(4))
    p = graphs.snapshot()["programs"]["t.leaky"]
    (site,) = p["host_callbacks"]["sites"]
    assert site["target"] == "_local_scalar_dense"
    line = _leaky.__code__.co_firstlineno + 2
    assert site["where"] == f"tests/test_torch_obs_graphs.py:{line}"
    assert p["op_histogram"] == {"_local_scalar_dense": 1, "add": 1,
                                 "mul": 1, "sum": 1}


def test_a_boolean_mask_index_is_a_host_callback(armed):
    f = graphs.instrument("t.masked", lambda x: x[x > 0])
    f(torch.randn(16))
    (site,) = graphs.snapshot()["programs"]["t.masked"][
        "host_callbacks"]["sites"]
    assert site["target"] == "index(bool mask)"


def test_second_call_per_signature_captures_nothing(armed):
    f = graphs.instrument("t.memo", lambda x, k: x * k)
    f(torch.ones(4), 2)
    f(torch.ones(4), 2)           # same signature: no recapture
    f(torch.zeros(4), 2)          # same shapes, other values: none either
    f(torch.ones(8), 2)           # new shape: a second passport
    f(torch.ones(8), 3)           # new static value: a third
    sec = graphs.snapshot()
    assert sorted(sec["programs"]) == ["t.memo", "t.memo'", "t.memo''"]


def _sorted_chunk_args(gb):
    """Inputs of ``edger._sub_table_sorted_chunk`` (which calls the
    instrumented ``_table_chunk``) for a block of ``gb`` genes."""
    g = torch.Generator().manual_seed(5)
    ns, k = 12, 3
    sc = torch.poisson(torch.full((gb, ns), 2.0), generator=g)
    lib = torch.full((ns,), 1000.0)
    cid = torch.arange(ns) % k
    rates = torch.full((gb, k), 2e-3)
    onehot = torch.nn.functional.one_hot(cid, k).to(torch.float32)
    return (sc, lib, cid, rates, 1000.0, 0.1, torch.linspace(0.1, 10, 4),
            4, onehot)


def test_nested_programs_at_the_passport_cap_finish(armed, monkeypatch):
    """Once the cap is reached, an unseen outer program runs outside any
    capture, so its unseen inner program asks the registry again: the
    registry must not hold its (non-reentrant) lock while a program
    runs. Run in a daemon thread so that a deadlock fails, not hangs."""
    import threading

    from scconsensus_tpu_torch.de import edger

    monkeypatch.setenv("SCC_GRAPHS_MAX_PROGRAMS", "1")
    out = {}

    def body():
        out["a"] = edger._sub_table_sorted_chunk(*_sorted_chunk_args(3))
        out["b"] = edger._sub_table_sorted_chunk(*_sorted_chunk_args(5))

    t = threading.Thread(target=body, daemon=True)
    t.start()
    t.join(timeout=60)
    if t.is_alive():
        # free the teardown's reset from the stuck thread's lock
        graphs._STATE["lock"] = threading.Lock()
    assert not t.is_alive(), "the passport registry deadlocked"
    assert out["b"][0].shape == (5, 3, 4)
    sec = graphs.snapshot()
    assert [p["program"] for p in sec["programs"].values()] == [
        "edger.sub_table_sorted_chunk"]
    assert sec["errors"] == [
        "passport cap reached (1); further programs dropped"]


def test_two_threads_racing_on_one_program_finish(armed):
    """Two threads at one unseen signature: one captures, the other runs
    the program unobserved; neither waits on the other's program."""
    import threading

    f = graphs.instrument("t.race", lambda x: x * 2.0)
    barrier = threading.Barrier(2)
    res = []

    def body():
        barrier.wait()
        res.append(f(torch.ones(4)))

    ts = [threading.Thread(target=body, daemon=True) for _ in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    assert len(res) == 2 and all(float(r[0]) == 2.0 for r in res)
    assert list(graphs.snapshot()["programs"]) == ["t.race"]


def test_unarmed_nothing_is_captured():
    graphs.reset()
    f = graphs.instrument("t.disarmed", lambda x: x + 1)
    assert float(f(torch.ones(3))[0]) == 2.0
    assert graphs.snapshot() is None
    assert graphs._STATE["seen"] == set()
    assert f.__wrapped__ is not None and f.__name__ == "<lambda>"


def test_wrappers_keep_the_functions_names():
    for fn in (pca_scores, compute_aggregates_cid,
               ranksum_allpairs.ranksum_body):
        assert fn.__name__ == fn.__wrapped__.__name__
        assert fn.__doc__ == fn.__wrapped__.__doc__


def test_the_reference_programs_are_instrumented_less_runspace():
    import scconsensus_tpu_torch.de.edger  # noqa: F401  (registers edger's)

    got = {p for p in graphs.instrumented_programs()
           if not p.startswith("t.")}
    # the runspace chunk is parity API the engine never runs (no passport),
    # and the one-hot-input aggregates run compute_aggregates_cid
    assert got == REFERENCE_PROGRAMS - {
        "wilcox.allpairs_ranksum_runspace_chunk", "gates.compute_aggregates"}
    assert ranksum_allpairs.allpairs_ranksum_runspace_chunk is \
        ranksum_allpairs.ranksum_body_runspace
    assert not hasattr(ranksum_allpairs.ranksum_body_runspace,
                       "__wrapped__")


def test_capture_failure_lands_in_errors_not_raised(armed, monkeypatch):
    def boom(*a):
        raise RuntimeError("no recorder for you")

    monkeypatch.setitem(graphs._RECORDER, "cls", boom)
    f = graphs.instrument("t.boom", lambda x: x + 1)
    assert float(f(torch.ones(2))[1]) == 2.0
    sec = graphs.snapshot()
    assert any("t.boom" in e for e in sec.get("errors", []))
    assert "t.boom" not in sec["programs"]


def test_a_failing_call_propagates_and_leaves_the_signature_unseen(armed):
    calls = []

    def flaky(x):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("transient")
        return x + 1

    f = graphs.instrument("t.flaky", flaky)
    with pytest.raises(RuntimeError, match="transient"):
        f(torch.ones(2))
    f(torch.ones(2))  # the retry captures
    assert list(graphs.snapshot()["programs"]) == ["t.flaky"]


def test_the_cost_models_fake_run_captures_nothing(armed, monkeypatch):
    """Under the cost model's fake-tensor run the wrapper runs unobserved
    and leaves its signature unseen; the real call then captures once,
    with the cost model's counts on its passport."""
    from scconsensus_tpu_torch.obs.cost import cost_analysis_of

    monkeypatch.setenv("SCC_OBS_COST", "1")
    f = graphs.instrument("t.costed", lambda a, b: a @ b)
    a, b = torch.randn(8, 5), torch.randn(5, 3)
    ca = cost_analysis_of(f, a, b)
    assert ca["flops"] == 2 * 8 * 5 * 3
    assert graphs.snapshot()["programs"] == {}
    f(a, b)
    p = graphs.snapshot()["programs"]["t.costed"]
    assert p["cost"]["flops"] == ca["flops"]
    assert p["op_histogram"] == {"mm": 1}


def test_a_refine_under_the_registry_keeps_its_results(armed):
    data, truth, _ = synthetic_scrna(n_genes=120, n_cells=240, n_clusters=3,
                                     seed=3)
    labels = noisy_labeling(truth, 0.05, seed=2)
    graphs.reset()
    base = port.refine(data, labels, port.ReclusterConfig(), device="cpu",
                       mesh=None)
    graphs.install_and_mark(force=True)
    res = port.refine(data, labels, port.ReclusterConfig(), device="cpu",
                      mesh=None)
    for key, lab in base.dynamic_labels.items():
        np.testing.assert_array_equal(res.dynamic_labels[key], lab)
    sec = graphs.snapshot()
    assert sorted(sec["by_stage"]) == ["aggregates", "embed", "gates",
                                       "wilcox_test"]
    assert all(p["capture_s"] >= 0 for p in sec["programs"].values())
    assert "errors" not in sec


def test_unarmed_wrapper_overhead_is_one_flag_check():
    """2,000 unarmed calls add well under the reference's 50 ms budget
    for steady-state passport overhead (tests/test_obs_graphs.py)."""
    graphs.reset()

    def bare(x):
        return x

    f = graphs.instrument("t.overhead", bare)
    x = torch.ones(4)
    n = 2000
    t0 = time.perf_counter()
    for _ in range(n):
        bare(x)
    t_bare = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(n):
        f(x)
    assert time.perf_counter() - t0 - t_bare < 0.050
