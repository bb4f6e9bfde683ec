"""Evidence ledger: one manifest-indexed store of run records.

A copy of ``scconsensus_tpu/obs/ledger.py`` over the port's own schema,
validator, cost summary and residency helpers (framework-free; the tests
pin ``run_key``, the manifest entries and the upgrader equal to the
reference's on the same records). The reference's history follows.

Round 7 gave every emitter the ``scc-run-record`` schema but left ~30
loose ``BENCH_*``/``SCALE_*``/``PROFILE_*``/``MESH_*``/``MULTICHIP_*``
JSONs at the repo root with no index and no history: a regression was
caught by a human rereading VERDICT.md. The ledger fixes the storage half
of that (obs.regress computes the verdicts):

  * every record lives under ``evidence/`` as one file, listed in
    ``evidence/MANIFEST.json`` with its run key, headline, per-stage
    synced walls and (when cost attribution ran) per-stage flops — so
    baseline computation reads the manifest, not thirty files;
  * runs are keyed by ``(dataset, backend, config_fp)`` — the config
    fingerprint hashes the workload-identity fields of ``extra``
    (config name, degraded/size-reduced shrinks, shape overrides), so a
    degraded 2k-cell run can never become the baseline of the 26k one;
  * a one-shot upgrader (``python -m scconsensus_tpu_torch.obs.ledger``)
    lifts the legacy root files
    into schema-v1 envelopes and relocates them here. Upgrades are
    lossless by construction: the entire original payload is preserved
    verbatim under ``extra["legacy"]`` and :func:`downgrade_legacy`
    inverts the lift exactly (round-trip asserted in tests).

The default location is ``<cwd>/evidence``; ``SCC_EVIDENCE_DIR``
overrides it (the test suite points it at a tmp dir so quick bench runs
stay hermetic).
"""

from __future__ import annotations

import glob
import json
import os
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

from scconsensus_tpu_torch.config import env_flag
from scconsensus_tpu_torch.obs.export import (
    SCHEMA_NAME,
    SCHEMA_VERSION,
    check_schema_version,
    validate_run_record,
    write_json_atomic,
)

__all__ = [
    "Ledger",
    "default_evidence_dir",
    "run_key",
    "upgrade_legacy",
    "downgrade_legacy",
    "upgrade_tree",
    "is_transient_artifact",
    "termination_cause",
    "is_partial_record",
    "is_partial_entry",
    "MANIFEST_NAME",
    "LEGACY_PATTERNS",
]

MANIFEST_NAME = "MANIFEST.json"
MANIFEST_SCHEMA = "scc-evidence-manifest"
MANIFEST_VERSION = 1

# Root-level artifact families the one-shot upgrader relocates.
# TUNNEL_LOG.jsonl and BASELINE.json are not run records and stay where
# they are. Two BENCH_* families are EXCLUDED as live working files:
#   * BENCH_CHECKPOINT_* — bench.py overwrites them every run and they are
#     gitignored; indexing one would pin a fresh clone to a file that does
#     not exist (they live under evidence/ now — bench's default
#     checkpoint path — just unindexed);
#   * BENCH_TPU_* — the capture watcher's per-config evidence targets
#     (tpu_capture_watcher.sh `captured()` reads the root path mid-
#     campaign; relocating one would make the watcher re-burn a TPU
#     window re-capturing it).
LEGACY_PATTERNS = (
    "BENCH_*.json",
    "SCALE_*.json",
    "PROFILE_*.json",
    "MESH_*.json",
    "MULTICHIP_*.json",
)
TRANSIENT_PREFIXES = ("BENCH_CHECKPOINT_", "BENCH_TPU_")
# Flight-recorder sidecars (obs.live): the recorder REWRITES these while a
# run is live, and run_sparse_1m anchors them at SCALE_*/PROFILE_* names
# that match LEGACY_PATTERNS — relocating one would index a mid-run
# crash-stamped partial and unlink it out from under the recorder.
TRANSIENT_SUFFIXES = ("_heartbeat.jsonl", "_partial.json")


def is_transient_artifact(name: str) -> bool:
    """Live working files the upgrader must never relocate or index."""
    base = os.path.basename(name)
    return (base.startswith(TRANSIENT_PREFIXES)
            or base.endswith(TRANSIENT_SUFFIXES))


# --------------------------------------------------------------------------
# partial (flight-recorder) records
# --------------------------------------------------------------------------

def termination_cause(rec: Dict[str, Any]) -> Optional[str]:
    """The record's termination cause (obs.live incremental flush), or
    None for records with no termination section (every clean single-shot
    emitter)."""
    term = rec.get("termination")
    return term.get("cause") if isinstance(term, dict) else None


def is_partial_record(rec: Dict[str, Any]) -> bool:
    """True for flight-recorder partials: a termination stamp with any
    cause other than "clean". Partial records are ledger-ingestible (they
    are often the ONLY evidence a dead run left) but must never seed or
    anchor a regression baseline — the walls of the interrupted stage are
    truncated, not measured."""
    cause = termination_cause(rec)
    return cause is not None and cause != "clean"


def is_partial_entry(entry: Dict[str, Any]) -> bool:
    """Manifest-entry twin of :func:`is_partial_record` (the entry carries
    the cause under ``termination``)."""
    cause = entry.get("termination")
    return cause is not None and cause != "clean"

# extra-dict fields that identify the workload (not its outcome): two runs
# agreeing on all of these are comparable, so they share a baseline key.
_KEY_FIELDS = (
    "config",
    "degraded",
    "size_reduced",
    "n_cells",
    "n_genes",
    "n_clusters",
    "n_way",
    "method",
    "mesh",
)


def default_evidence_dir(base: Optional[str] = None) -> str:
    """``SCC_EVIDENCE_DIR`` when set, else ``<base or cwd>/evidence``."""
    override = env_flag("SCC_EVIDENCE_DIR")
    if override:
        return override
    return os.path.join(base or os.getcwd(), "evidence")


def run_key(rec: Dict[str, Any]) -> Dict[str, str]:
    """(dataset, backend, config fingerprint) identity of one run record."""
    from scconsensus_tpu_torch.utils.artifacts import config_fingerprint

    ex = rec.get("extra") or {}
    dataset = str(ex.get("config") or ex.get("dataset") or "unknown")
    backend = str(
        ex.get("platform")
        or (rec.get("run") or {}).get("platform")
        or "unknown"
    )
    ident = {k: ex[k] for k in _KEY_FIELDS if k in ex}
    ident["unit"] = rec.get("unit")
    return {
        "dataset": dataset,
        "backend": backend,
        "config_fp": config_fingerprint(ident),
    }


def stage_walls(rec: Dict[str, Any]) -> Dict[str, float]:
    """Headline wall per stage-kind span, aggregated by name (a stage that
    runs twice — e.g. cold + steady in one tree — sums; baselines compare
    like-for-like because the key fingerprints the workload)."""
    out: Dict[str, float] = {}
    for s in rec.get("spans") or []:
        if not isinstance(s, dict) or s.get("kind") != "stage":
            continue
        wall = s.get("wall_synced_s")
        if wall is None:
            wall = s.get("wall_submitted_s")
        if wall is None:
            continue
        out[s["name"]] = round(out.get(s["name"], 0.0) + float(wall), 6)
    return out


# --------------------------------------------------------------------------
# legacy upgrade (lossless by construction)
# --------------------------------------------------------------------------

def _legacy_headline(d: Dict[str, Any], name: str) -> Dict[str, Any]:
    """Best-effort headline extraction from the known pre-schema shapes:
    driver artifacts ({n, cmd, rc, tail, parsed}), bare bench records,
    SCALE config maps, MESH size tables. Anything unrecognized still
    upgrades (the payload is preserved whole); only the headline degrades
    to nulls."""
    src: Any = d
    if isinstance(d.get("parsed"), dict):  # driver BENCH_r* shape
        src = d["parsed"]
    if not isinstance(src, dict) or "value" not in src:
        for v in (d.get("configs") or {}).values() if isinstance(
                d.get("configs"), dict) else ():
            if isinstance(v, dict) and "value" in v:
                src = v
                break
    metric = src.get("metric") if isinstance(src, dict) else None
    value = src.get("value") if isinstance(src, dict) else None
    unit = src.get("unit") if isinstance(src, dict) else None
    extra = src.get("extra") if isinstance(src, dict) else None
    platform = (extra or {}).get("platform") if isinstance(extra, dict) \
        else None
    return {
        "metric": metric or f"legacy artifact {name}",
        "value": value,
        "unit": unit or "seconds",
        "vs_baseline": src.get("vs_baseline") if isinstance(src, dict)
        else None,
        "platform": platform,
        "config": (extra or {}).get("config") if isinstance(extra, dict)
        else None,
    }


def upgrade_legacy(d: Dict[str, Any], source_name: str,
                   created_unix: Optional[float] = None) -> Dict[str, Any]:
    """Lift a pre-schema artifact into a schema-v1 envelope.

    Lossless: the original payload rides ``extra["legacy"]`` verbatim;
    :func:`downgrade_legacy` returns it unchanged. A record that already
    carries the schema is returned as-is (ValueError on unknown versions,
    same contract as every other ingester)."""
    if check_schema_version(d, source=source_name) != "legacy":
        return d
    head = _legacy_headline(d, source_name)
    run: Dict[str, Any] = {
        "created_unix": round(float(created_unix or time.time()), 3)
    }
    if head["platform"]:
        run["platform"] = head["platform"]
    extra: Dict[str, Any] = {
        "legacy": d,
        "legacy_source": source_name,
        "upgraded": True,
    }
    if head["platform"]:
        extra["platform"] = head["platform"]
    if head["config"]:
        extra["config"] = head["config"]
    return {
        "schema": SCHEMA_NAME,
        "schema_version": SCHEMA_VERSION,
        "metric": head["metric"],
        "value": head["value"],
        "unit": head["unit"],
        "vs_baseline": head["vs_baseline"],
        "run": run,
        "spans": [],
        "device": {},
        "extra": extra,
    }


def downgrade_legacy(rec: Dict[str, Any]) -> Dict[str, Any]:
    """Exact inverse of :func:`upgrade_legacy` for upgraded records."""
    legacy = (rec.get("extra") or {}).get("legacy")
    if legacy is None:
        raise ValueError("record carries no legacy payload to downgrade")
    return legacy


# --------------------------------------------------------------------------
# the ledger
# --------------------------------------------------------------------------

class Ledger:
    """Manifest-indexed run-record store rooted at one directory."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._manifest = self._load_manifest()

    # -- manifest ----------------------------------------------------------
    @property
    def manifest_path(self) -> str:
        return os.path.join(self.root, MANIFEST_NAME)

    def _load_manifest(self) -> Dict[str, Any]:
        try:
            with open(self.manifest_path) as f:
                m = json.load(f)
        except (OSError, json.JSONDecodeError):
            return {"schema": MANIFEST_SCHEMA, "version": MANIFEST_VERSION,
                    "entries": []}
        if m.get("schema") != MANIFEST_SCHEMA:
            raise ValueError(
                f"{self.manifest_path}: unknown manifest schema "
                f"{m.get('schema')!r}"
            )
        if m.get("version") != MANIFEST_VERSION:
            raise ValueError(
                f"{self.manifest_path}: unsupported manifest version "
                f"{m.get('version')!r} (this tool knows {MANIFEST_VERSION})"
            )
        m.setdefault("entries", [])
        return m

    def _write_manifest(self) -> None:
        self._manifest["entries"].sort(
            key=lambda e: (e.get("created_unix") or 0, e.get("file", ""))
        )
        write_json_atomic(self.manifest_path, self._manifest)

    def entries(self) -> List[Dict[str, Any]]:
        return list(self._manifest["entries"])

    # -- ingest ------------------------------------------------------------
    def ingest(self, rec: Dict[str, Any], name: Optional[str] = None,
               source: str = "native") -> Dict[str, Any]:
        """Validate, write ``evidence/<name>`` and index it. Pre-schema
        payloads must go through :func:`upgrade_legacy` first (hard error
        here — silent auto-upgrades would hide that a *current* emitter
        stopped stamping the schema)."""
        validate_run_record(rec)
        key = run_key(rec)
        created = float((rec.get("run") or {}).get("created_unix") or 0.0)
        if name is None:
            name = (
                f"RUN_{key['dataset']}_{key['backend']}_"
                f"{key['config_fp']}_{int(created)}.json"
            )
        if os.sep in name or name == MANIFEST_NAME:
            raise ValueError(f"invalid evidence entry name {name!r}")
        path = os.path.join(self.root, name)
        n = 1
        while os.path.exists(path) and not self._is_entry(name):
            # never clobber an un-indexed file that happens to share a name
            n += 1
            stem, ext = os.path.splitext(name)
            name = f"{stem}.{n}{ext}"
            path = os.path.join(self.root, name)
        write_json_atomic(path, rec)
        entry: Dict[str, Any] = {
            "file": name,
            "key": key,
            "metric": rec.get("metric"),
            "value": rec.get("value"),
            "unit": rec.get("unit"),
            "vs_baseline": rec.get("vs_baseline"),
            "created_unix": created,
            "schema_version": rec.get("schema_version"),
            "source": source,
            "stage_walls": stage_walls(rec),
        }
        cause = termination_cause(rec)
        if cause is not None:
            # the index says up front whether this run ended cleanly —
            # baseline computation (regress.stage_baselines) reads only
            # the manifest and must skip partials without loading files
            entry["termination"] = cause
        rb = rec.get("robustness")
        if isinstance(rb, dict) and rb:
            # survival summary on the index: a gate/report scanning the
            # manifest can see WHICH runs recovered (and how hard they
            # had to work) without loading every record
            entry["robustness"] = {
                "retries": len(rb.get("retries") or []),
                "degradations": len(rb.get("degradations") or []),
                "faults_injected": len(rb.get("faults_injected") or []),
                "resume_points": len(rb.get("resume_points") or []),
                "recovered": bool(rb.get("recovered")),
            }
            if rb.get("mesh_transitions"):
                # elastic runs additionally index the mesh trail (count
                # + final device count) — absent on mesh-stable runs, so
                # pre-elastic manifest consumers see an unchanged shape
                entry["robustness"]["mesh_transitions"] = len(
                    rb["mesh_transitions"]
                )
                entry["robustness"]["mesh_devices"] = len(
                    rb["mesh_transitions"][-1].get("to_devices") or []
                )
        sv = rec.get("serving")
        if isinstance(sv, dict) and sv:
            # serving latency summary on the index: the perf gate's
            # latency baselines (regress.serving_baselines) read the
            # manifest, not N record files — exactly like stage_walls
            lat = sv.get("latency_ms") or {}
            entry["serving"] = {
                "p50_ms": lat.get("p50"),
                "p99_ms": lat.get("p99"),
                "throughput_rps": sv.get("throughput_rps"),
                "requests": (sv.get("requests") or {}).get("submitted"),
            }
            nrep = (sv.get("fleet") or {}).get("replicas")
            if isinstance(nrep, int) and nrep >= 1:
                # replica count on the index: the perf gate's replica-
                # keyed baselines (p99@rN, throughput@rN) read it —
                # absent means the bare r15 driver (keys as r1)
                entry["serving"]["replicas"] = nrep
        lg = rec.get("loadgen")
        if isinstance(lg, dict) and lg:
            # traffic summary on the index (round 21): the perf gate's
            # per-profile sustained-RPS-at-SLO baselines
            # (regress.loadgen_baselines) read the manifest, not N
            # record files — exactly like stage_walls
            entry["loadgen"] = {
                "profile": lg.get("profile"),
                "arrival": lg.get("arrival"),
                "rps_at_slo": lg.get("rps_at_slo"),
                "achieved_rps": lg.get("achieved_rps"),
                "breaches": len(lg.get("breaches") or []),
                "actuations": len(
                    (lg.get("autoscale") or {}).get("actuations") or []
                ),
            }
        ig = rec.get("integrity")
        if isinstance(ig, dict) and ig:
            # computation-integrity summary on the index (round 18): a
            # gate/report scanning the manifest sees WHICH runs proved
            # their arithmetic (and which caught corruption) without
            # loading every record
            entry["integrity"] = {
                "mode": ig.get("mode"),
                "checks_run": (ig.get("checks") or {}).get("run"),
                "checks_passed": (ig.get("checks") or {}).get("passed"),
                "violations": len(ig.get("violations") or []),
                "mismatches": len(
                    (ig.get("ghost") or {}).get("mismatches") or []
                ),
                "recomputes": (ig.get("ghost") or {}).get("recomputes"),
                "all_checks_passed": bool(ig.get("all_checks_passed")),
            }
        sm = rec.get("streaming")
        if isinstance(sm, dict) and sm:
            # out-of-core summary on the index (round 17): the perf
            # gate's peak-RSS baselines (regress.streaming_baselines)
            # read the manifest, not N record files — like stage_walls
            ch = sm.get("chunks") or {}
            bud = sm.get("budget") or {}
            entry["streaming"] = {
                "chunks_planned": ch.get("planned"),
                "chunks_completed": ch.get("completed"),
                "chunks_resumed": ch.get("resumed"),
                "peak_rss_mb": bud.get("peak_rss_mb"),
                "limit_mb": bud.get("limit_mb"),
                "within_budget": bool(bud.get("within_budget")),
            }
        fp = (rec.get("extra") or {}).get("numeric_fingerprint")
        if isinstance(fp, dict) and fp:
            # every ingested run is fingerprint-stamped on its manifest
            # entry (not just the pinned reference workload), so the gate
            # can flag quality drift on ANY dataset by comparing a
            # candidate against its own key's newest clean entry
            # (regress.history_pins) under the DRIFT_LEDGER ack flow
            entry["numeric_fingerprint"] = {
                k: v for k, v in fp.items() if not k.startswith("_")
            }
        try:
            from scconsensus_tpu_torch.obs.cost import stage_cost_summary

            cost = stage_cost_summary(rec.get("spans") or [])
            if cost:
                entry["stage_cost"] = cost
        except Exception:
            pass
        try:
            from scconsensus_tpu_torch.obs.residency import stage_transfer_bytes

            # per-stage transfer totals ride the index so the perf gate's
            # transfer-byte baselines read the manifest, not N files —
            # exactly like stage_walls. Absent when no audit ran (absence
            # must never read as "zero bytes").
            tb = stage_transfer_bytes(rec)
            if tb:
                entry["stage_transfer_bytes"] = tb
        except Exception:
            pass
        try:
            # per-boundary transfer totals (both directions) ride the
            # index too — regress.boundary_baselines anchors the
            # residency burn-down ledger on these stamps. Prefers the
            # record's own burndown section (validated totals), falls
            # back to the raw residency aggregate for pre-round-22
            # records re-ingested by --reindex.
            bb: Dict[str, int] = {}
            bd = rec.get("residency_burndown")
            if isinstance(bd, dict):
                for b, row in (bd.get("boundaries") or {}).items():
                    if isinstance(row, dict):
                        bb[str(b)] = int(row.get("bytes") or 0)
            else:
                res = rec.get("residency")
                if isinstance(res, dict):
                    for b, row in (res.get("by_boundary") or {}).items():
                        if isinstance(row, dict):
                            bb[str(b)] = int(
                                row.get("to_host_bytes") or 0
                            ) + int(row.get("to_device_bytes") or 0)
            if bb:
                entry["boundary_bytes"] = bb
        except Exception:
            pass
        self._manifest["entries"] = [
            e for e in self._manifest["entries"] if e.get("file") != name
        ]
        self._manifest["entries"].append(entry)
        self._write_manifest()
        return entry

    def _is_entry(self, name: str) -> bool:
        return any(e.get("file") == name for e in self._manifest["entries"])

    # -- reads -------------------------------------------------------------
    def load(self, name: str) -> Dict[str, Any]:
        with open(os.path.join(self.root, name)) as f:
            return json.load(f)

    def history(self, key: Dict[str, str],
                exclude_files: Iterable[str] = ()) -> List[Dict[str, Any]]:
        """Manifest entries for one run key, oldest first."""
        skip = set(exclude_files)
        return [
            e for e in self._manifest["entries"]
            if e.get("key") == key and e.get("file") not in skip
        ]


# --------------------------------------------------------------------------
# one-shot tree upgrade (the relocation)
# --------------------------------------------------------------------------

def upgrade_tree(root: str, dest: Optional[str] = None,
                 keep_root: bool = False) -> Tuple[List[str], List[str]]:
    """Lift every legacy-pattern artifact under ``root`` into ``dest``
    (default ``<root>/evidence``) and index it; root files are removed
    after a successful relocation unless ``keep_root``. Returns
    (relocated names, skipped names). Unreadable files are skipped — a
    mid-write artifact must not abort the whole migration."""
    dest = dest or os.path.join(root, "evidence")
    ledger = Ledger(dest)
    done: List[str] = []
    skipped: List[str] = []
    for pat in LEGACY_PATTERNS:
        for path in sorted(glob.glob(os.path.join(root, pat))):
            if os.path.abspath(os.path.dirname(path)) == os.path.abspath(
                    dest):
                continue
            name = os.path.basename(path)
            if is_transient_artifact(name):
                continue  # live checkpoint/capture target, never indexed
            try:
                with open(path) as f:
                    d = json.load(f)
            except (OSError, json.JSONDecodeError):
                skipped.append(name)
                continue
            if not isinstance(d, dict):
                skipped.append(name)
                continue
            source = "legacy-upgrade"
            if check_schema_version(d, source=name) != "legacy":
                source = "native"
            rec = upgrade_legacy(d, name,
                                 created_unix=os.path.getmtime(path))
            ledger.ingest(rec, name=name, source=source)
            if not keep_root:
                os.unlink(path)
            done.append(name)
    return done, skipped


def main(argv: Optional[List[str]] = None) -> int:
    """One-shot upgrader CLI: ``python -m scconsensus_tpu_torch.obs.ledger
    [--root DIR] [--dest DIR] [--keep-root]``."""
    import argparse

    ap = argparse.ArgumentParser(description=upgrade_tree.__doc__)
    ap.add_argument("--root", default=os.getcwd())
    ap.add_argument("--dest", default=None)
    ap.add_argument("--keep-root", action="store_true")
    args = ap.parse_args(argv)
    done, skipped = upgrade_tree(args.root, args.dest,
                                 keep_root=args.keep_root)
    for name in done:
        print(f"relocated {name}")
    for name in skipped:
        print(f"SKIPPED (unreadable) {name}")
    print(f"{len(done)} artifact(s) relocated, {len(skipped)} skipped")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
