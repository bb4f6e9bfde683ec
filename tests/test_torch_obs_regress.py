"""The port's perf gate and drift sentinel (``obs.regress``), held against
the reference's: ``gate_record`` gives the reference's verdict
(``GateVerdict.to_dict()``) on the reference's own fixture histories, on
synthetic histories that feed every lane (stage, transfer, serving,
streaming, SLO, traffic) and on histories of the port's CPU records;
``graphs_verdicts`` agrees on a ratchet pinned from the port's own
passports; ``check_drift``, ``resolve_pins`` and ``history_pins`` agree;
the port's ``reference_fingerprint(device="cpu")`` matches the live
reference's within the tolerances stated below, with ``label_ari`` 1.0.
Everything but the fingerprint is a pure function of the same dicts, so
those comparisons are exact."""

import copy
import json
import os
import pathlib
import shutil

import numpy as np
import pytest
import torch

import scconsensus_tpu.obs.ledger as ref_ledger
import scconsensus_tpu.obs.regress as ref_regress
import scconsensus_tpu_torch as port
from scconsensus_tpu_torch.obs import export, graphs, ledger, regress
from scconsensus_tpu_torch.utils.synthetic import (
    noisy_labeling,
    synthetic_scrna,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "perf_gate"
CANDIDATES = sorted(p.name for p in FIXTURES.glob("candidate_*.json"))
PINS = REPO / "evidence" / "NUMERIC_PINS.json"


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _load(path):
    with open(path) as f:
        return json.load(f)


def _gate_both(candidate, history, base_spans=None, base_cost=None):
    got = regress.gate_record(copy.deepcopy(candidate),
                              copy.deepcopy(history),
                              baseline_spans=copy.deepcopy(base_spans),
                              baseline_cost=copy.deepcopy(base_cost))
    want = ref_regress.gate_record(copy.deepcopy(candidate),
                                   copy.deepcopy(history),
                                   baseline_spans=copy.deepcopy(base_spans),
                                   baseline_cost=copy.deepcopy(base_cost))
    assert got.to_dict() == want.to_dict()
    return got


def _baseline_context(led, history):
    """The freshest clean baseline's spans and stage costs, as the
    reference's perf_gate tool takes them."""
    for entry in reversed(history):
        if ledger.is_partial_entry(entry):
            continue
        spans = led.load(entry["file"]).get("spans")
        if spans:
            return spans, entry.get("stage_cost")
    return None, None


@pytest.fixture(scope="module")
def fixture_evidence(tmp_path_factory):
    """A copy of the reference's fixture ledger (nothing in the repo is
    written)."""
    d = tmp_path_factory.mktemp("evidence")
    for p in (FIXTURES / "evidence").iterdir():
        shutil.copy(p, d / p.name)
    return str(d)


@pytest.mark.parametrize("name", CANDIDATES)
def test_gate_equals_the_reference_on_its_fixture_ledger(name,
                                                         fixture_evidence):
    cand = _load(FIXTURES / name)
    led = ledger.Ledger(fixture_evidence)
    history = led.history(ledger.run_key(cand))
    assert history == ref_ledger.Ledger(fixture_evidence).history(
        ref_ledger.run_key(cand))
    spans, cost = _baseline_context(led, history)
    v = _gate_both(cand, history, spans, cost)
    if name == "candidate_regressed.json":
        (reg,) = [r for r in v.regressions if r.stage == "wilcox_test"]
        assert reg.offender["span"] == "wilcox_bucket"
    # the ratchet lane, as the reference's perf_gate tool runs it
    pins = _load(os.path.join(fixture_evidence, regress.PINS_NAME))
    entry = (pins.get("graph_ratchet") or {}).get(
        ledger.run_key(cand)["dataset"])
    got = regress.graphs_verdicts(cand, entry)
    want = ref_regress.graphs_verdicts(cand, entry)
    assert ([g.to_dict() for g in got[0]], got[1]) == \
        ([g.to_dict() for g in want[0]], want[1])


def _entry(i, walls, partial=False, **stamps):
    e = {"file": f"RUN_{i}.json", "stage_walls": walls, **stamps}
    if partial:
        e["termination"] = "signal"
    return e


def _lane_history():
    """Manifest entries that anchor every lane: walls, transfer and
    boundary bytes, serving (single and fleet), streaming and traffic,
    with a partial entry that must never anchor."""
    hist = []
    for i, (w, p99, rss, rps) in enumerate([(1.0, 40.0, 900.0, 80.0),
                                            (1.2, 44.0, 950.0, 84.0),
                                            (0.9, 42.0, 920.0, 82.0)]):
        hist.append(_entry(
            i, {"aggregates": w, "wilcox_test": 2 * w, "tree": 0.5},
            stage_transfer_bytes={"aggregates": 4096 * (i + 1),
                                  "wilcox_test": 1 << 20},
            boundary_bytes={"funnel_counts": 512},
            serving={"p50_ms": p99 / 4, "p99_ms": p99},
            streaming={"peak_rss_mb": rss},
            loadgen={"rps_at_slo": rps, "profile": "steady",
                     "breaches": []}))
    hist.append(_entry(3, {"aggregates": 9.0, "wilcox_test": 9.0},
                       partial=True, serving={"p99_ms": 900.0}))
    hist.append(_entry(4, {"aggregates": 1.1},
                       serving={"p50_ms": 30.0, "p99_ms": 120.0,
                                "replicas": 4, "throughput_rps": 400.0}))
    return hist


@pytest.mark.parametrize("name", CANDIDATES)
def test_gate_equals_the_reference_on_every_lane(name):
    cand = _load(FIXTURES / name)
    _gate_both(cand, _lane_history())
    _gate_both(cand, [])


def test_baselines_and_lane_verdicts_equal_the_reference():
    hist = _lane_history()
    for fn in ("stage_baselines", "stage_transfer_baselines",
               "boundary_baselines", "stage_trends", "serving_baselines",
               "streaming_baselines", "loadgen_baselines"):
        assert getattr(regress, fn)(hist) == getattr(ref_regress, fn)(hist)
    for name in CANDIDATES:
        cand = _load(FIXTURES / name)
        assert [v.to_dict() for v in regress.slo_verdicts(cand)] == \
            [v.to_dict() for v in ref_regress.slo_verdicts(cand)]
        lg = dict(cand, loadgen={"rps_at_slo": 50.0, "profile": "steady",
                                 "breaches": ["window 60s burned"]})
        assert [v.to_dict() for v in regress.loadgen_verdicts(lg, hist)] \
            == [v.to_dict() for v in ref_regress.loadgen_verdicts(lg, hist)]
    assert (regress.ANCHOR_RUNS, regress.REL_NOISE_FLOOR,
            regress.ABS_NOISE_FLOOR_S, regress.ABS_NOISE_FLOOR_BYTES) == (
        ref_regress.ANCHOR_RUNS, ref_regress.REL_NOISE_FLOOR,
        ref_regress.ABS_NOISE_FLOOR_S, ref_regress.ABS_NOISE_FLOOR_BYTES)


# --------------------------------------------------------------------------
# the port's own CPU records, ingested and gated
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_records(tmp_path_factory):
    """Four small audited Wilcoxon refines on the CPU as run records (the
    last under the passport registry), with the key a bench record
    carries."""
    data, truth, _ = synthetic_scrna(n_genes=120, n_cells=240, n_clusters=3,
                                     seed=3)
    labels = noisy_labeling(truth, 0.05, seed=2)
    mp = pytest.MonkeyPatch()
    mp.setenv("SCC_OBS_RESIDENCY", "audit")
    recs = []
    try:
        for i in range(4):
            if i == 3:
                graphs.install_and_mark(force=True)
            res = port.refine(data, labels, port.ReclusterConfig(),
                              device="cpu", mesh=None)
            m = res.metrics
            recs.append(export.build_run_record(
                "refine wall", m["total_s"], spans=m["spans"],
                residency=m["residency"], quality=m["quality"],
                graphs=graphs.snapshot(),
                extra={"config": "tiny-cpu", "platform": "cpu",
                       "method": "wilcox"}))
    finally:
        graphs.reset()
        mp.undo()
    root = tmp_path_factory.mktemp("port-evidence")
    led = ledger.Ledger(str(root))
    for i, rec in enumerate(recs[:3]):
        rec["run"]["created_unix"] = 1000.0 + i
        led.ingest(rec)
    return {"recs": recs, "ledger": led}


def test_gate_of_a_port_record_equals_the_reference(port_records):
    led, cand = port_records["ledger"], port_records["recs"][3]
    history = led.history(ledger.run_key(cand))
    assert len(history) == 3
    spans, cost = _baseline_context(led, history)
    v = _gate_both(cand, history, spans, cost)
    assert v.n_history == 3 and v.stages and v.transfers
    # a candidate whose tree stage ran 5 s longer: a regression both
    # packages name, with the same verdict, and the only verdict the 5 s
    # add (the candidate's own walls are real CPU walls, so a loaded
    # machine may already have pushed another stage past its band)
    before = sorted(r.stage for r in v.regressions)
    assert "tree" not in before
    slow = copy.deepcopy(cand)
    for s in slow["spans"]:
        if s["name"] == "tree" and s["kind"] == "stage":
            for k in ("wall_synced_s", "wall_submitted_s"):
                if s.get(k) is not None:
                    s[k] += 5.0
    v = _gate_both(slow, history, spans, cost)
    assert not v.ok and sorted(r.stage for r in v.regressions) == sorted(
        before + ["tree"])


def test_a_self_pinned_ratchet_gates_the_port_record(port_records):
    cand = port_records["recs"][3]
    sec = cand["graphs"]
    entry = {"fingerprint_digest": sec["fingerprint"]["digest"],
             "stages": graphs.stage_graph_counts(cand),
             "boundaries": {b: {"calls": row["calls"]} for b, row in
                            cand["residency"]["by_boundary"].items()}}
    for mod in (regress, ref_regress):
        verdicts, note = mod.graphs_verdicts(cand, entry)
        assert note is None and verdicts
        assert not any(v.regressed for v in verdicts)
    # a host sync added to the gates program: regressed, naming its line
    bad = copy.deepcopy(cand)
    prog = next(n for n, p in bad["graphs"]["programs"].items()
                if p["stage"] == "gates")
    bad["graphs"]["programs"][prog]["host_callbacks"] = {
        "count": 1, "sites": [{"target": "_local_scalar_dense",
                               "where": "scconsensus_tpu_torch/ops/"
                                        "gates.py:120"}]}
    bad["graphs"]["by_stage"]["gates"]["host_callbacks"] = 1
    bad["graphs"]["totals"]["host_callbacks"] += 1
    graphs.validate_graphs(bad["graphs"])
    got = regress.graphs_verdicts(bad, entry)
    want = ref_regress.graphs_verdicts(bad, entry)
    assert [v.to_dict() for v in got[0]] == [v.to_dict() for v in want[0]]
    (reg,) = [v for v in got[0] if v.regressed]
    assert reg.metric == "host_callbacks@gates"
    assert "scconsensus_tpu_torch/ops/gates.py:120" in reg.detail


# --------------------------------------------------------------------------
# the drift sentinel
# --------------------------------------------------------------------------

DRIFT_CASES = {
    "equal": ({"label_ari": 1.0, "q": [1.0, 2.0]},
              {"label_ari": 1.0, "q": [1.0, 2.0]}),
    "shifted": ({"label_ari": 0.8, "q": [1.0, 2.0]},
                {"label_ari": 1.0, "q": [1.0, 2.0]}),
    "within-rtol": ({"q": [100.0]}, {"q": [100.05]}),
    "beyond-rtol": ({"q": [100.0]}, {"q": [101.0]}),
    "missing": ({}, {"label_ari": 1.0}),
    "extra": ({"label_ari": 1.0, "new": 3}, {"label_ari": 1.0}),
    "metadata": ({"label_ari": 1.0}, {"label_ari": 1.0, "_workload": "x"}),
    "nan": ({"q": [float("nan")]}, {"q": [float("nan")]}),
    "length": ({"q": [1.0]}, {"q": [1.0, 2.0]}),
}


@pytest.mark.parametrize("case", DRIFT_CASES)
def test_check_drift_equals_the_reference(case, tmp_path):
    current, pinned = DRIFT_CASES[case]
    path = str(tmp_path / regress.DRIFT_LEDGER_NAME)
    regress.append_drift_ack(path, "label_ari", 1.0, 0.8, reason="recut")
    with open(path, "a") as f:
        f.write("{half an entry\n")
    acks = regress.load_drift_acks(path)
    assert acks == ref_regress.load_drift_acks(path)
    for a in ((), acks):
        assert regress.check_drift(current, pinned, a) == \
            ref_regress.check_drift(current, pinned, a)


def test_resolve_and_history_pins_equal_the_reference(tmp_path):
    hist = [{"numeric_fingerprint": {"label_ari": 0.9}},
            {"numeric_fingerprint": {"label_ari": 0.95}},
            {"numeric_fingerprint": {"label_ari": 0.1},
             "termination": "stall"}]
    assert regress.history_pins(hist) == ref_regress.history_pins(hist) \
        == {"label_ari": 0.95}
    d = str(tmp_path)
    cases = {"no-file": None, "unreadable": "{not json",
             "pinned": json.dumps({"ds": {"label_ari": 1.0},
                                   "reference": {"x": 1}}),
             "other-dataset": json.dumps({"reference": {"x": 1}})}
    for text in cases.values():
        p = os.path.join(d, regress.PINS_NAME)
        if text is None:
            if os.path.exists(p):
                os.unlink(p)
        else:
            with open(p, "w") as f:
                f.write(text)
        for h in (hist, []):
            assert regress.resolve_pins(d, "ds", h) == \
                ref_regress.resolve_pins(d, "ds", h)
    doc = _load(PINS)
    for ds in ("reference", "sparse-fullpipe", "nope"):
        assert regress.pins_for_dataset(doc, ds) == \
            ref_regress.pins_for_dataset(doc, ds)
    assert regress.PINS_NAME == ref_regress.PINS_NAME
    assert regress.REFERENCE_DATASET == ref_regress.REFERENCE_DATASET


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adjusted_rand_index_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 5, 300)
    b = np.where(rng.random(300) < 0.2, rng.integers(0, 7, 300), a)
    assert regress.adjusted_rand_index(a, b) == pytest.approx(
        ref_regress.adjusted_rand_index(a, b), abs=1e-12)
    assert regress.drift_fingerprint(labels=a, ref_labels=b) == \
        ref_regress.drift_fingerprint(labels=a, ref_labels=b)


# The pinned reference workload, the port's run against the live
# reference's on the same seeded input (not against NUMERIC_PINS.json:
# the reference itself drifts from its pins, ROADMAP C fact 1). Its
# counts are log-normalized values, where edgeR's dispersions sit at the
# low end of their grid and are ill-conditioned (tests/test_torch_edger.py:
# a relative input change of 1e-6 moves the reference's own tagwise
# values by up to 9.6x and its log p by 1e-3). So: log p quantiles within
# 2e-3 absolute (measured 7.6e-5), dispersion quantiles within a factor of
# 2 each (measured 1.50 at the 90th percentile; single tagwise values may
# move 9.6x, quantiles of 240 of them much less), label ARI exactly 1.0;
# and within the port's own input-noise spread (the test after it).
LOGP_ATOL = 2e-3
DISP_FACTOR = 2.0


@pytest.fixture(scope="module")
def fingerprints():
    ref = ref_regress.reference_fingerprint()
    got = regress.reference_fingerprint(ref_labels=ref["_final_labels"],
                                        device="cpu")
    return ref, got


def test_reference_fingerprint_matches_the_live_reference(fingerprints):
    ref, got = fingerprints
    assert got["label_ari"] == 1.0
    assert got["_final_labels"] == ref["_final_labels"]
    assert set(got) == set(ref)
    np.testing.assert_allclose(got["de_logp_q"], ref["de_logp_q"], rtol=0,
                               atol=LOGP_ATOL)
    ratio = np.asarray(got["nb_dispersion_q"]) / np.asarray(
        ref["nb_dispersion_q"])
    assert np.all((ratio <= DISP_FACTOR) & (ratio >= 1 / DISP_FACTOR))
    # the committed pins: the same drift verdict machinery in both packages
    pins = regress.pins_for_dataset(_load(PINS), regress.REFERENCE_DATASET)
    assert [d["field"] for d in regress.check_drift(got, pins)] == [
        d["field"] for d in ref_regress.check_drift(got, pins)]


def test_the_live_reference_lies_within_the_ports_input_noise(fingerprints):
    """The second witness of the ill-conditioning: the port's CPU run
    against itself with its input times 1 + 1e-6 · N(0, 1) (8 seeds, as
    chip_smoke.py phase 38 measures it on the card's host). The live
    reference lies within that spread in both fields, and the spread
    itself exceeds check_drift's 1e-3 on the dispersions by two orders
    (measured here 1.54 relative; log p 3.9e-4)."""
    ref, got = fingerprints
    noise, runs = regress._input_noise_spread(got, seeds=8, rel=1e-6,
                                              device="cpu")
    assert len(runs) == 8
    assert noise == {k: max(r[k] for r in runs) for k in noise}
    spread = regress._fingerprint_spread(ref, got)
    assert all(spread[k] <= noise[k] for k in spread), (spread, noise)
    assert noise["nb_dispersion_q"] >= 0.1
    assert regress._fingerprint_spread(got, got) == {
        "de_logp_q": 0.0, "nb_dispersion_q": 0.0}


def test_write_pins_goes_to_the_path_it_is_given(tmp_path):
    path = tmp_path / "pins.json"
    path.write_text(json.dumps({"other": {"label_ari": 0.5}, "junk": 3}))
    assert regress.main(["--write-pins", str(path), "--device",
                         "cpu"]) == 0
    doc = _load(path)
    assert doc["other"] == {"label_ari": 0.5} and "junk" not in doc
    fp = doc[regress.REFERENCE_DATASET]
    assert fp["label_ari"] == 1.0 and len(fp["de_logp_q"]) == 7
    assert "edgeR slow path" in fp["_workload"]
    with pytest.raises(SystemExit):
        regress.main([])
