"""The port's evidence ledger (``obs.ledger``), pinned to the
reference's on the same records: run keys, stage walls, partial-record
classification, the lossless legacy upgrade and its inverse, the
manifest entries an ingest writes, the one-shot tree upgrade and
``SCC_EVIDENCE_DIR``."""

import copy
import json

import pytest

import scconsensus_tpu.obs.ledger as ref_ledger
from scconsensus_tpu_torch.obs import ledger
from scconsensus_tpu_torch.obs.export import build_run_record
from scconsensus_tpu_torch.obs.trace import Tracer

# one representative of each pre-schema artifact shape the reference's
# tests pin
LEGACY_SHAPES = {
    "BENCH_r01.json": {
        "n": 1, "cmd": "python bench.py", "rc": 0, "tail": "...",
        "parsed": {"metric": "26k edgeR", "value": 41.2, "unit": "seconds",
                   "vs_baseline": 0.728,
                   "extra": {"platform": "tpu", "config": "flagship"}},
    },
    "BENCH_r03.json": {"n": 3, "cmd": "python bench.py", "rc": 124,
                       "tail": "", "parsed": None},
    "SCALE_r04_cpu.json": {"configs": {
        "cite8k": {"metric": "8k", "value": 8.9, "unit": "seconds",
                   "extra": {"platform": "cpu", "degraded": True}}}},
    "MESH_OVERHEAD_r04.json": {
        "sizes": {"4096": {"mesh8": 1.2, "serial": 0.9, "ratio": 1.33}}},
}


def _record(value=1.0, created=1000.0, **extra):
    tr = Tracer(sync="off")
    with tr.span("aggregates"):
        with tr.span("wilcox_bucket") as sp:
            sp.attrs["xla_cost"] = {"flops": 8e6, "bytes_accessed": 4e6,
                                    "transcendentals": 0.0, "kernels": 1}
    rec = build_run_record(
        "test metric", value, tracer=tr,
        extra={"platform": "cpu", "config": "quick", **extra})
    rec["run"]["created_unix"] = created
    return rec


RECORDS = {
    "plain": _record(),
    "keyed": _record(config="flagship", n_cells=26000, method="wilcox",
                     degraded=True, mesh=4),
    "partial": {**_record(), "termination": {
        "cause": "signal", "last_span": "tree", "open_spans": [],
        "stall_count": 0}},
    "clean-stamp": {**_record(), "termination": {
        "cause": "clean", "last_span": None, "open_spans": []}},
    "audited": {**_record(), "residency": {
        "mode": "audit", "to_device": {"calls": 1, "bytes": 8},
        "to_host": {"calls": 1, "bytes": 4},
        "by_stage": {"aggregates": {"to_host_bytes": 4,
                                    "to_device_bytes": 8, "calls": 2}},
        "by_boundary": {"funnel_counts": {"to_host_bytes": 4,
                                          "to_device_bytes": 0,
                                          "calls": 1}},
        "events": [], "violations": []}},
}


@pytest.mark.parametrize("name", RECORDS)
def test_keys_walls_and_causes_equal_the_reference(name):
    rec = RECORDS[name]
    assert ledger.run_key(rec) == ref_ledger.run_key(rec)
    assert ledger.stage_walls(rec) == ref_ledger.stage_walls(rec)
    assert ledger.termination_cause(rec) == \
        ref_ledger.termination_cause(rec)
    assert ledger.is_partial_record(rec) == ref_ledger.is_partial_record(rec)


@pytest.mark.parametrize("name", RECORDS)
def test_ingest_writes_the_references_manifest_entry(name, tmp_path):
    rec = RECORDS[name]
    ours = ledger.Ledger(str(tmp_path / "ours")).ingest(copy.deepcopy(rec))
    ref = ref_ledger.Ledger(str(tmp_path / "ref")).ingest(copy.deepcopy(rec))
    assert ours == ref
    assert ledger.is_partial_entry(ours) == (name == "partial")
    with open(tmp_path / "ours" / ledger.MANIFEST_NAME) as f:
        assert json.load(f)["entries"] == [ours]


@pytest.mark.parametrize("name", LEGACY_SHAPES)
def test_legacy_upgrade_equals_the_reference_and_round_trips(name):
    payload = LEGACY_SHAPES[name]
    ours = ledger.upgrade_legacy(payload, name, created_unix=5.0)
    assert ours == ref_ledger.upgrade_legacy(payload, name,
                                             created_unix=5.0)
    assert ledger.downgrade_legacy(ours) == payload
    assert ledger.upgrade_legacy(ours, name) is ours  # already schema


def test_upgrade_tree_relocates_like_the_reference(tmp_path):
    for side in ("ours", "ref"):
        root = tmp_path / side
        root.mkdir()
        for name, payload in LEGACY_SHAPES.items():
            (root / name).write_text(json.dumps(payload))
        (root / "SCALE_x_partial.json").write_text("{}")  # a live sidecar
        (root / "PROFILE_bad.json").write_text("{not json")
    done, skipped = ledger.upgrade_tree(str(tmp_path / "ours"))
    assert (done, skipped) == ref_ledger.upgrade_tree(str(tmp_path / "ref"))
    assert sorted(done) == sorted(LEGACY_SHAPES)
    assert skipped == ["PROFILE_bad.json"]
    assert (tmp_path / "ours" / "SCALE_x_partial.json").exists()
    ours = json.loads((tmp_path / "ours" / "evidence" /
                       ledger.MANIFEST_NAME).read_text())
    ref = json.loads((tmp_path / "ref" / "evidence" /
                      ledger.MANIFEST_NAME).read_text())
    # entries sort by file mtime: compare them by name, less the stamp

    def by_file(m):
        return sorted(({k: v for k, v in e.items() if k != "created_unix"}
                       for e in m["entries"]), key=lambda e: e["file"])

    assert by_file(ours) == by_file(ref)


def test_legacy_ingest_and_unknown_manifest_refused(tmp_path):
    led = ledger.Ledger(str(tmp_path))
    with pytest.raises(ValueError, match="schema"):
        led.ingest(LEGACY_SHAPES["BENCH_r03.json"])
    (tmp_path / ledger.MANIFEST_NAME).write_text(json.dumps(
        {"schema": "scc-evidence-manifest", "version": 9, "entries": []}))
    with pytest.raises(ValueError, match="version"):
        ledger.Ledger(str(tmp_path))


def test_evidence_dir_flag(monkeypatch, tmp_path):
    monkeypatch.delenv("SCC_EVIDENCE_DIR", raising=False)
    assert ledger.default_evidence_dir(str(tmp_path)) == \
        str(tmp_path / "evidence")
    monkeypatch.setenv("SCC_EVIDENCE_DIR", str(tmp_path / "elsewhere"))
    assert ledger.default_evidence_dir() == str(tmp_path / "elsewhere")
    assert ledger.default_evidence_dir() == ref_ledger.default_evidence_dir()


def test_module_surface_is_the_references():
    assert ledger.__all__ == ref_ledger.__all__
    assert (ledger.MANIFEST_NAME, ledger.LEGACY_PATTERNS,
            ledger.TRANSIENT_SUFFIXES) == (
        ref_ledger.MANIFEST_NAME, ref_ledger.LEGACY_PATTERNS,
        ref_ledger.TRANSIENT_SUFFIXES)
