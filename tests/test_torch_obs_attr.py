"""The port's perf-diff attribution (``obs.attr``), held against the
reference's: ``diff_records``, ``top_suspect`` and ``format_report``
give equal outputs on the same record pairs — the reference's committed
evidence pairs, synthetic pairs that drive every cause (transfer at a
boundary, device, work, the host causes split by the host profile and
the compile log, improvement, structure, noise), and pairs of the port's
own CPU records with their ``compile`` sections. Every function is pure
over the two records, so the comparisons are exact."""

import copy
import json
import pathlib

import pytest
import torch

import scconsensus_tpu.obs.attr as ref_attr
import scconsensus_tpu_torch as port
from scconsensus_tpu_torch.obs import attr, compilelog, export
from scconsensus_tpu_torch.utils.synthetic import (
    noisy_labeling,
    synthetic_scrna,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
EVIDENCE = REPO / "evidence"
COMMITTED = {
    "quick-pair": ("RUN_quick_cpu_dc28fb1eb588_1785744955.json",
                   "RUN_quick_cpu_dc28fb1eb588_1785741543.json"),
    "hostprof-gc": ("RUN_hostprofdemo_cpu_9629c861f138_1786000002.json",
                    "RUN_hostprofdemo_cpu_9629c861f138_1786000001.json"),
    "hostprof-retrace": (
        "RUN_hostprofdemo_cpu_9629c861f138_1786000003.json",
        "RUN_hostprofdemo_cpu_9629c861f138_1786000001.json"),
}


def _rec(stages, residency_by_boundary=None, value=1.0):
    """Minimal diffable record: stage spans + optional residency, device
    time and cost-model FLOPs."""
    spans = [{"name": name, "kind": "stage", "wall_synced_s": p["wall"]}
             for name, p in stages.items()]
    rec = {"metric": "m", "value": value, "unit": "seconds",
           "spans": spans}
    if residency_by_boundary is not None:
        rec["residency"] = {"by_boundary": residency_by_boundary}
    kernels = {n: {"device_time_s": p["device"]}
               for n, p in stages.items() if "device" in p}
    cost = {n: {"flops": p["flops"]} for n, p in stages.items()
            if "flops" in p}
    if kernels:
        rec["kernels"] = {"vs_cost_model": kernels}
    if cost:
        rec["extra"] = {"stage_throughput": cost}
    return rec


def _transfer_pair():
    base = _rec({"wilcox_ladder": {"wall": 1.0}},
                {"wilcox_ladder_plan": {"to_host_bytes": 1000,
                                        "to_device_bytes": 0, "calls": 1}})
    base["residency"]["by_stage"] = {
        "wilcox_ladder": {"to_host_bytes": 1000, "to_device_bytes": 0,
                          "calls": 1}}
    cand = _rec({"wilcox_ladder": {"wall": 1.5}},
                {"wilcox_ladder_plan": {"to_host_bytes": 2_100_001_000,
                                        "to_device_bytes": 0, "calls": 2}})
    cand["residency"]["by_stage"] = {
        "wilcox_ladder": {"to_host_bytes": 2_100_001_000,
                          "to_device_bytes": 0, "calls": 2}}
    return cand, base


def _host(causes=None, top_frame=None, compile_by_stage=None,
          compile_totals=None, wall=3.0):
    """An embed stage that grew with device time and FLOPs flat, with the
    host observatory's sections attached."""
    rec = _rec({"embed": {"wall": wall, "device": 0.1, "flops": 1e9}})
    if causes is not None:
        srow = {"samples": 1, "causes": causes, "est_s": 0.0}
        if top_frame:
            srow["top_frame"] = top_frame
        rec["host_profile"] = {"version": 1, "stages": {"embed": srow}}
    comp = {}
    if compile_by_stage is not None:
        comp["by_stage"] = {"embed": compile_by_stage}
    if compile_totals is not None:
        comp.update(compile_totals)
    if comp:
        rec["compile"] = comp
    return rec


SYNTHETIC = {
    "transfer": _transfer_pair,
    "device": lambda: (_rec({"de": {"wall": 2.0, "device": 1.7}}),
                       _rec({"de": {"wall": 1.0, "device": 0.8}})),
    "work": lambda: (_rec({"de": {"wall": 2.0, "flops": 5e9}}),
                     _rec({"de": {"wall": 1.0, "flops": 1e9}})),
    "host": lambda: (_host(), _host(wall=1.0)),
    "improvement-structure": lambda: (
        _rec({"de": {"wall": 1.0}, "new": {"wall": 0.3}}),
        _rec({"de": {"wall": 2.0}, "gone": {"wall": 0.5}})),
    "ranking": lambda: (
        _rec({"a": {"wall": 1.2}, "b": {"wall": 3.0}, "c": {"wall": 1.2}}),
        _rec({"a": {"wall": 1.0}, "b": {"wall": 1.0}, "c": {"wall": 1.0}})),
    "noise": lambda: (_rec({"a": {"wall": 10.3}, "b": {"wall": 2.0}}),
                      _rec({"a": {"wall": 10.0}, "b": {"wall": 1.0}})),
    "all-noise": lambda: (_rec({"a": {"wall": 10.2}}),
                          _rec({"a": {"wall": 10.0}})),
    "gc": lambda: (_host(causes={"gc": 1.5}),
                   _host(causes={"gc": 0.1}, wall=1.0)),
    "compile-retrace": lambda: (
        _host(compile_by_stage={"events": 6, "compiles": 3, "retraces": 5,
                                "total_s": 1.3},
              compile_totals={"compiles": 7, "retraces": 6,
                              "cache_hits": 1, "compile_wall_s": 1.4}),
        _host(compile_by_stage={"events": 1, "compiles": 0, "retraces": 0,
                                "total_s": 0.1},
              compile_totals={"compiles": 1, "retraces": 0,
                              "cache_hits": 4, "compile_wall_s": 0.2},
              wall=1.0)),
    "python-frame": lambda: (
        _host(causes={"python": 2.4}, top_frame="engine.py:rank:142"),
        _host(causes={"python": 0.5}, wall=1.0)),
    "blocking-wait": lambda: (_host(causes={"blocking_wait": 1.9}),
                              _host(causes={"blocking_wait": 0.1},
                                    wall=1.0)),
    "tie": lambda: (_host(causes={"gc": 1.0, "python": 1.0}),
                    _host(causes={"gc": 0.0, "python": 0.0}, wall=1.0)),
    "below-floor": lambda: (_host(causes={"gc": 0.12}),
                            _host(causes={"gc": 0.10}, wall=1.0)),
    "one-sided": lambda: (_host(causes={"gc": 1.5}), _host(wall=1.0)),
}


def _both(cand, base, labels=("candidate", "baseline")):
    got = attr.diff_records(copy.deepcopy(cand), copy.deepcopy(base),
                            *labels)
    want = ref_attr.diff_records(copy.deepcopy(cand), copy.deepcopy(base),
                                 *labels)
    assert got == want
    assert attr.top_suspect(got) == ref_attr.top_suspect(want)
    for n in (10, 2):
        assert attr.format_report(got, max_causes=n) == \
            ref_attr.format_report(want, max_causes=n)
    return got


@pytest.mark.parametrize("case", SYNTHETIC)
def test_diff_equals_the_reference_on_synthetic_pairs(case):
    cand, base = SYNTHETIC[case]()
    diff = _both(cand, base)
    _both(base, cand)
    if case == "transfer":
        assert diff["causes"][0]["boundary"] == "wilcox_ladder_plan"
    if case == "compile-retrace":
        assert diff["causes"][0]["driver"] == "compile/retrace"


@pytest.mark.parametrize("case", COMMITTED)
def test_diff_equals_the_reference_on_committed_pairs(case):
    c, b = COMMITTED[case]
    cand = json.loads((EVIDENCE / c).read_text())
    base = json.loads((EVIDENCE / b).read_text())
    diff = _both(cand, base, (c, b))
    assert "perf-diff:" in attr.format_report(diff)


@pytest.fixture(scope="module")
def port_pair():
    """Two small CPU refines as run records, audited and with the compile
    log's section, the second with its embed stage's wall raised by
    0.5 s."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    data, truth, _ = synthetic_scrna(n_genes=120, n_cells=240, n_clusters=3,
                                     seed=3)
    labels = noisy_labeling(truth, 0.05, seed=2)
    mp = pytest.MonkeyPatch()
    mp.setenv("SCC_OBS_RESIDENCY", "audit")
    mp.setitem(compilelog._STATE, "armed", False)
    recs = []
    try:
        # a first run warms the process up (its stages run slower)
        port.refine(data, labels, port.ReclusterConfig(), device="cpu",
                    mesh=None)
        for _ in range(2):
            assert compilelog.install_and_mark(force=True)
            res = port.refine(data, labels, port.ReclusterConfig(),
                              device="cpu", mesh=None)
            m = res.metrics
            recs.append(export.build_run_record(
                "refine wall", m["total_s"], spans=m["spans"],
                residency=m["residency"], compile=compilelog.snapshot()))
    finally:
        mp.undo()
        torch.set_num_threads(n)
    for s in recs[1]["spans"]:
        if s["name"] == "embed" and s["kind"] == "stage":
            s["wall_synced_s"] = (s.get("wall_synced_s") or 0.0) + 0.5
    return recs


def test_diff_equals_the_reference_on_port_records(port_pair):
    base, cand = port_pair
    for rec in port_pair:
        export.validate_run_record(rec)
    diff = _both(cand, base, ("port-slow", "port"))
    assert attr.top_suspect(diff)["stage"] == "embed"
    assert diff["compile"] == {
        "candidate_retraces": 0, "baseline_retraces": 0,
        "delta_compiles": 0, "delta_retraces": 0, "delta_cache_hits": 0,
        "delta_wall_s": 0.0}
    _both(base, base)

