"""The port's unified run profile and residency burn-down
(``obs.profile``), pinned to the reference's: the same synthetic
sections give equal outputs, every section the port builds passes the
reference's validators, corrupt ones fail both, and the record and the
ledger carry them."""

import copy

import pytest

import scconsensus_tpu.obs.profile as ref_profile
from scconsensus_tpu.obs.export import validate_run_record as ref_validate
from scconsensus_tpu_torch.obs import export, profile
from scconsensus_tpu_torch.obs.ledger import Ledger


def _span(name, wall, kind="stage"):
    return {"name": name, "kind": kind, "wall_synced_s": wall}


def _residency():
    return {
        "by_boundary": {
            "silhouette_slab_fetch": {"to_host_bytes": 1000,
                                      "to_device_bytes": 0, "calls": 2},
            "funnel_counts": {"to_host_bytes": 24, "to_device_bytes": 8,
                              "calls": 1},
        },
        "by_stage": {"silhouette": {"to_host_bytes": 1000,
                                    "to_device_bytes": 0, "calls": 2}},
    }


PROFILE_CASES = {
    "all-signals": dict(
        spans=[_span("silhouette", 2.0), _span("embed", 1.0),
               _span("not_a_stage", 9.0, kind="xfer")],
        kernels={"vs_cost_model": {"silhouette": {"device_time_s": 1.5}}},
        cost={"silhouette": {"flops": 4e9, "bytes_accessed": 2e8,
                             "achieved_gflops": 2.0, "achieved_gbps": 0.1}},
        residency=_residency(), ceilings={"gflops": 100.0, "gbps": 10.0}),
    "walls-only": dict(spans=[_span("de", 1.0), _span("de", 0.5)]),
    "no-stages": dict(spans=[_span("x", 1.0, kind="xfer")]),
    "none": dict(spans=None),
    "submitted-walls": dict(
        spans=[{"name": "tree", "kind": "stage", "wall_synced_s": None,
                "wall_submitted_s": 0.25}],
        residency={"by_stage": {"tree": {"to_host_bytes": 5}}}),
}


@pytest.mark.parametrize("case", PROFILE_CASES)
def test_build_profile_equals_the_reference(case):
    kw = PROFILE_CASES[case]
    got = profile.build_profile(**kw)
    assert got == ref_profile.build_profile(**kw)
    if got is not None:
        profile.validate_profile(got)
        ref_profile.validate_profile(got)


@pytest.mark.parametrize("res", [None, {}, {"by_boundary": {}},
                                 _residency()],
                         ids=["none", "empty", "no-boundaries", "two"])
def test_build_burndown_equals_the_reference(res):
    got = profile.build_burndown(res)
    assert got == ref_profile.build_burndown(res)
    if got is not None:
        profile.validate_residency_burndown(got)
        ref_profile.validate_residency_burndown(got)


def test_profile_sections_of_equals_the_reference():
    rec = {"spans": PROFILE_CASES["all-signals"]["spans"],
           "kernels": PROFILE_CASES["all-signals"]["kernels"],
           "residency": _residency(),
           "extra": {"stage_throughput":
                     PROFILE_CASES["all-signals"]["cost"],
                     "mfu": {"measured_gflops": 50.0,
                             "measured_gbps": 0.0}}}
    got = profile.profile_sections_of(rec)
    assert got == ref_profile.profile_sections_of(rec)
    assert got["profile"]["ceilings"] == {"gflops": 50.0}


def test_item2_boundaries_are_the_references():
    assert profile.ITEM2_BOUNDARIES == ref_profile.ITEM2_BOUNDARIES
    assert "silhouette_slab_fetch" in profile.ITEM2_BOUNDARIES


def _burndown():
    return profile.build_burndown(_residency())


@pytest.mark.parametrize("mutate,match", [
    (lambda b: b.__setitem__("total_bytes", 1), "total_bytes"),
    (lambda b: b.__setitem__("todo_item2_bytes", 0), "todo_item2_bytes"),
    (lambda b: b["boundaries"].__setitem__(
        "made_up", dict(b["boundaries"]["funnel_counts"])), "undeclared"),
    (lambda b: b["boundaries"]["funnel_counts"].__setitem__(
        "todo_item2", True), "todo_item2"),
], ids=["total", "item2-total", "undeclared", "item2-flag"])
def test_corrupt_burndown_rejected_like_the_reference(mutate, match):
    bd = _burndown()
    mutate(bd)
    for validate in (profile.validate_residency_burndown,
                     ref_profile.validate_residency_burndown):
        with pytest.raises(ValueError, match=match):
            validate(bd)


@pytest.mark.parametrize("mutate,match", [
    (lambda p: p["stages"]["embed"].__setitem__("wall_s", -1.0), "wall_s"),
    (lambda p: p.pop("totals"), "totals"),
], ids=["negative-wall", "no-totals"])
def test_corrupt_profile_rejected_like_the_reference(mutate, match):
    sec = profile.build_profile(**PROFILE_CASES["all-signals"])
    mutate(sec)
    for validate in (profile.validate_profile, ref_profile.validate_profile):
        with pytest.raises(ValueError, match=match):
            validate(sec)


def test_sections_ride_the_record_and_the_ledger(tmp_path):
    res = {"mode": "audit", "to_device": {"calls": 1, "bytes": 8},
           "to_host": {"calls": 3, "bytes": 1024}, "events": [],
           "violations": [], **copy.deepcopy(_residency())}
    rec = export.build_run_record(
        "profile smoke", 1.0,
        spans=[{"name": "silhouette", "span_id": 0, "depth": 0,
                "kind": "stage", "t0_s": 0.0, "wall_submitted_s": 2.0,
                "wall_synced_s": 2.0, "synced": True}],
        residency=res)
    for key, sec in profile.profile_sections_of(rec).items():
        rec[key] = sec
    export.validate_run_record(rec)
    ref_validate(rec)
    entry = Ledger(str(tmp_path)).ingest(rec)
    assert entry["boundary_bytes"] == {"silhouette_slab_fetch": 1000,
                                       "funnel_counts": 32}
    assert entry["stage_transfer_bytes"] == {"silhouette": 1000}
