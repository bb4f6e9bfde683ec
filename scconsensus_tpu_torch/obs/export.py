"""The run-record schema, its validator, and the Chrome trace export.

The port's copy of ``scconsensus_tpu/obs/export.py:180-653``: schema
``scc-run-record`` version 1, the same keys and the same checks, so a
record written by either package passes the other's validator for the
sections both have. Top-level keys:

  schema, schema_version   "scc-run-record", 1
  metric/value/unit/vs_baseline
                           the run's headline
  run                      {created_unix, platform?, torch_version?,
                            env_fingerprint?} (the reference records
                            jax_version here; env_fingerprint is
                            obs.graphs.environment_fingerprint, torch's)
  spans                    the tracer's span records
  device                   {memory: obs.device.memory_snapshot() or null,
                            host_peak_rss_bytes, compile?, transfers?};
                            ``compile`` is the tracer's compile stats:
                            the native builds since it was made
  extra                    free-form emitter extras
  termination              optional, validated as in the reference
  quality, residency, kernels, robustness, serving, slo, streaming,
  integrity, profile, residency_burndown, tunnel, host_profile,
  compile, memory_timeline, graphs
                           optional sections, each handed to the port's
                           own validator (``obs.quality``,
                           ``obs.residency``, ``obs.kernels``,
                           ``robust.record``, ``serve.metrics``,
                           ``serve.slo``, ``stream.record``,
                           ``robust.integrity``, ``obs.profile``,
                           ``obs.hostprof``, ``obs.compilelog``,
                           ``obs.graphs``; ``tunnel`` inline);
                           ``host_profile``, ``compile``,
                           ``memory_timeline`` and ``graphs`` must be
                           omitted when absent, never null

A record carrying a section the port cannot validate yet
(``UNPORTED_SECTIONS``, empty now) would raise ``NotImplementedError``
naming it, so none passes unchecked. The ``scenario`` section is checked
by ``workloads.validate_scenario`` and the ``loadgen`` section by
``serve.fleet.loadgen.validate_loadgen``.

:func:`chrome_trace` converts span records to ``traceEvents`` complete
("X") events; open the file in Perfetto or chrome://tracing.
:func:`atomic_write` and :func:`write_json_atomic` are the one atomic-write
primitive every artifact writer shares.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "SCHEMA_NAME",
    "SCHEMA_VERSION",
    "TERMINATION_CAUSES",
    "UNPORTED_SECTIONS",
    "build_run_record",
    "validate_run_record",
    "check_schema_version",
    "chrome_trace",
    "write_chrome_trace",
    "write_json_atomic",
    "ATOMIC_TMP_PREFIX",
    "atomic_write",
]

SCHEMA_NAME = "scc-run-record"
SCHEMA_VERSION = 1

# The only admissible termination.cause values: "clean" (the run finished
# and said so), "signal" (an external stop), "stall" (a watchdog fired and
# the process was later reaped), "crash" (a periodic flush's standing
# stamp: the process died with no handler running).
TERMINATION_CAUSES = ("clean", "signal", "stall", "crash")

# sections of the reference's schema whose producers and validators the
# port does not have yet, in the reference's keyword order
UNPORTED_SECTIONS: Tuple[str, ...] = ()


def _device_section(tracer=None,
                    transfers: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, Any]:
    from scconsensus_tpu_torch.obs import device as obs_device

    out: Dict[str, Any] = {
        "memory": obs_device.memory_snapshot(),
        "host_peak_rss_bytes": obs_device.host_peak_rss_bytes(),
    }
    if tracer is not None:
        cs = tracer.compile_stats()
        if cs is not None:
            out["compile"] = cs
    if transfers is not None:
        out["transfers"] = transfers
    return out


def build_run_record(
    metric: str,
    value,
    unit: str = "seconds",
    vs_baseline=None,
    extra: Optional[Dict[str, Any]] = None,
    spans: Optional[List[Dict[str, Any]]] = None,
    tracer=None,
    device: Optional[Dict[str, Any]] = None,
    transfers: Optional[Dict[str, Any]] = None,
    platform: Optional[str] = None,
    quality: Optional[Dict[str, Any]] = None,
    residency: Optional[Dict[str, Any]] = None,
    kernels: Optional[Dict[str, Any]] = None,
    robustness: Optional[Dict[str, Any]] = None,
    serving: Optional[Dict[str, Any]] = None,
    slo: Optional[Dict[str, Any]] = None,
    streaming: Optional[Dict[str, Any]] = None,
    integrity: Optional[Dict[str, Any]] = None,
    scenario: Optional[Dict[str, Any]] = None,
    loadgen: Optional[Dict[str, Any]] = None,
    profile: Optional[Dict[str, Any]] = None,
    residency_burndown: Optional[Dict[str, Any]] = None,
    tunnel: Optional[Dict[str, Any]] = None,
    host_profile: Optional[Dict[str, Any]] = None,
    compile: Optional[Dict[str, Any]] = None,
    memory_timeline: Optional[Dict[str, Any]] = None,
    graphs: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """One schema-v1 run record, with the reference's keyword surface.
    Pass ``tracer`` to take the spans from it, or pre-built ``spans``
    (e.g. ``result.metrics["spans"]``), or neither. Each optional section
    is attached under its own key when given; :func:`validate_run_record`
    checks it. ``run`` records the torch version where the reference
    records jax's, and torch's environment fingerprint (the key of graph
    passports and their ratchet), only when torch is already imported."""
    if spans is None:
        spans = tracer.span_records() if tracer is not None else []
    extra = dict(extra or {})
    run: Dict[str, Any] = {"created_unix": round(time.time(), 3)}
    plat = platform or extra.get("platform")
    if plat is not None:
        run["platform"] = plat
    if "torch" in sys.modules:  # never import torch here
        try:
            run["torch_version"] = sys.modules["torch"].__version__
        except Exception:
            pass
        try:
            from scconsensus_tpu_torch.obs.graphs import (
                environment_fingerprint,
            )

            fp = environment_fingerprint()
            if fp is not None:
                run["env_fingerprint"] = fp
        except Exception:
            pass
    rec = {
        "schema": SCHEMA_NAME,
        "schema_version": SCHEMA_VERSION,
        "metric": metric,
        "value": value,
        "unit": unit,
        "vs_baseline": vs_baseline,
        "run": run,
        "spans": spans,
        "device": device if device is not None
        else _device_section(tracer, transfers),
        "extra": extra,
    }
    sections = {
        "quality": quality, "residency": residency, "kernels": kernels,
        "robustness": robustness, "serving": serving, "slo": slo,
        "streaming": streaming, "integrity": integrity,
        "scenario": scenario, "loadgen": loadgen, "profile": profile,
        "residency_burndown": residency_burndown, "tunnel": tunnel,
        "host_profile": host_profile, "compile": compile,
        "memory_timeline": memory_timeline, "graphs": graphs,
    }
    for key, sec in sections.items():
        if sec is not None:
            rec[key] = sec
    return rec


def check_schema_version(rec: Dict[str, Any], source: str = "record") -> str:
    """Classify a record for ingesters: 'legacy' for pre-schema artifacts
    (no ``schema`` key), 'v<N>' for a known version; raises ValueError on
    an unknown schema name or version."""
    if not isinstance(rec, dict) or "schema" not in rec:
        return "legacy"
    name = rec.get("schema")
    if name != SCHEMA_NAME:
        raise ValueError(f"{source}: unknown schema {name!r}")
    ver = rec.get("schema_version")
    if ver != SCHEMA_VERSION:
        raise ValueError(
            f"{source}: unsupported {SCHEMA_NAME} version {ver!r} "
            f"(this tool knows version {SCHEMA_VERSION})"
        )
    return f"v{ver}"


def _validate_tunnel(tun: Any) -> None:
    if not isinstance(tun, dict):
        raise ValueError("tunnel section must be an object")
    if tun.get("state") not in ("alive", "stale", "dead", "missing",
                                "error"):
        raise ValueError(
            "tunnel.state must be alive|stale|dead|missing|error, "
            f"got {tun.get('state')!r}"
        )
    age = tun.get("age_s")
    if age is not None and (not isinstance(age, (int, float)) or age < 0):
        raise ValueError("tunnel.age_s must be a number >= 0")


def _section_validators() -> Dict[str, Any]:
    """Section key → the port's validator (imported when a record is
    checked: each module is stdlib-level at import)."""
    from scconsensus_tpu_torch.obs.compilelog import validate_compile
    from scconsensus_tpu_torch.obs.graphs import validate_graphs
    from scconsensus_tpu_torch.obs.hostprof import (
        validate_host_profile,
        validate_memory_timeline,
    )
    from scconsensus_tpu_torch.obs.kernels import validate_kernels
    from scconsensus_tpu_torch.obs.profile import (
        validate_profile,
        validate_residency_burndown,
    )
    from scconsensus_tpu_torch.obs.quality import validate_quality
    from scconsensus_tpu_torch.obs.residency import validate_residency
    from scconsensus_tpu_torch.robust.integrity import validate_integrity
    from scconsensus_tpu_torch.robust.record import validate_robustness
    from scconsensus_tpu_torch.serve.metrics import validate_serving
    from scconsensus_tpu_torch.serve.slo import validate_slo
    from scconsensus_tpu_torch.stream.record import validate_streaming
    # torch-free at module level, as the reference's workloads package and
    # load generator are
    from scconsensus_tpu_torch.serve.fleet.loadgen import validate_loadgen
    from scconsensus_tpu_torch.workloads import validate_scenario

    return {"quality": validate_quality, "residency": validate_residency,
            "kernels": validate_kernels,
            "robustness": validate_robustness, "serving": validate_serving,
            "slo": validate_slo, "streaming": validate_streaming,
            "integrity": validate_integrity, "scenario": validate_scenario,
            "loadgen": validate_loadgen,
            "profile": validate_profile,
            "residency_burndown": validate_residency_burndown,
            "tunnel": _validate_tunnel,
            "host_profile": validate_host_profile,
            "compile": validate_compile,
            "memory_timeline": validate_memory_timeline,
            "graphs": validate_graphs}


def validate_run_record(rec: Dict[str, Any]) -> None:
    """Structural validation of a schema-v1 record; raises ValueError with
    the first violation, and NotImplementedError for a section the port
    cannot validate yet (``UNPORTED_SECTIONS``)."""
    if check_schema_version(rec) == "legacy":
        raise ValueError("record has no schema field")
    for key in ("metric", "value", "unit", "vs_baseline", "run", "spans",
                "device", "extra"):
        if key not in rec:
            raise ValueError(f"run record missing key {key!r}")
    if not isinstance(rec["metric"], str) or not rec["metric"]:
        raise ValueError("metric must be a non-empty string")
    if not isinstance(rec["run"], dict) or "created_unix" not in rec["run"]:
        raise ValueError("run section must carry created_unix")
    if not isinstance(rec["spans"], list):
        raise ValueError("spans must be a list")
    all_ids = {
        s.get("span_id") for s in rec["spans"] if isinstance(s, dict)
    }
    for i, s in enumerate(rec["spans"]):
        where = f"spans[{i}]"
        if not isinstance(s, dict):
            raise ValueError(f"{where} is not an object")
        for key in ("name", "span_id", "depth", "kind", "t0_s",
                    "wall_submitted_s", "synced"):
            if key not in s:
                raise ValueError(f"{where} missing {key!r}")
        if not isinstance(s["name"], str) or not s["name"]:
            raise ValueError(f"{where}: name must be a non-empty string")
        if s["t0_s"] < 0 or s["wall_submitted_s"] < 0:
            raise ValueError(f"{where}: negative timing")
        ws = s.get("wall_synced_s")
        if ws is not None and ws < 0:
            raise ValueError(f"{where}: negative synced wall")
        if s["synced"] and ws is None:
            raise ValueError(f"{where}: synced span without wall_synced_s")
        parent = s.get("parent_id")
        if parent is not None and parent not in all_ids:
            raise ValueError(f"{where}: dangling parent_id {parent}")
    if not isinstance(rec["device"], dict):
        raise ValueError("device section must be an object")
    term = rec.get("termination")
    if term is not None:
        if not isinstance(term, dict):
            raise ValueError("termination must be an object")
        if term.get("cause") not in TERMINATION_CAUSES:
            raise ValueError(
                f"termination.cause must be one of {TERMINATION_CAUSES}, "
                f"got {term.get('cause')!r}"
            )
        ls = term.get("last_span")
        if ls is not None and not isinstance(ls, str):
            raise ValueError("termination.last_span must be a string or null")
        if not isinstance(term.get("open_spans", []), list):
            raise ValueError("termination.open_spans must be a list")
    for key in UNPORTED_SECTIONS:
        if key in rec:
            raise NotImplementedError(
                f"run record carries a {key!r} section, which the port "
                "cannot validate yet")
    # the host observatory's sections: absence is the marker for "the
    # instrument never ran", so a present-but-null key is rejected
    for key in ("host_profile", "compile", "memory_timeline", "graphs"):
        if key in rec and rec[key] is None:
            raise ValueError(f"{key} must be omitted when absent, not null")
    for key, validate in _section_validators().items():
        sec = rec.get(key)
        if sec is not None:
            validate(sec)


# --------------------------------------------------------------------------
# Chrome trace events (Perfetto / chrome://tracing)
# --------------------------------------------------------------------------

def chrome_trace(spans: List[Dict[str, Any]],
                 process_name: str = "scconsensus_tpu") -> Dict[str, Any]:
    """Span records → Chrome trace-event JSON (complete "X" events, µs).

    Each span becomes one event spanning [t0, t0 + wall] where the wall is
    the device-synced one when recorded, else the submitted one. Children
    close before their parent by construction, so events nest under
    Perfetto's containment rules. Events are emitted sorted by timestamp.
    The default process name is the reference's, so the two packages give
    the same file for the same spans.
    """
    events: List[Dict[str, Any]] = [{
        "ph": "M", "pid": 0, "tid": 0, "ts": 0,
        "name": "process_name", "args": {"name": process_name},
    }]
    for s in spans:
        wall = s.get("wall_synced_s")
        if wall is None:
            wall = s["wall_submitted_s"]
        args: Dict[str, Any] = {
            "kind": s.get("kind"),
            "synced": s.get("synced"),
            "wall_submitted_s": s.get("wall_submitted_s"),
        }
        if s.get("wall_synced_s") is not None:
            args["wall_synced_s"] = s["wall_synced_s"]
        for src in ("attrs", "metrics"):
            v = s.get(src)
            if v:
                # scalars only: Perfetto renders args flat
                args.update({
                    k: x for k, x in v.items()
                    if isinstance(x, (int, float, str, bool))
                })
        events.append({
            "ph": "X",
            "pid": 0,
            "tid": 0,
            "cat": s.get("kind", "span"),
            "name": s["name"],
            "ts": round(s["t0_s"] * 1e6, 3),
            "dur": round(max(wall, 0.0) * 1e6, 3),
            "args": args,
        })
    events.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


ATOMIC_TMP_PREFIX = ".scc-tmp-"


def atomic_write(path: str, write_fn, inspect_fn=None) -> None:
    """``write_fn(tmp_path)`` produces the full content at a unique temp
    path in the destination dir (same filesystem, so ``os.replace`` is
    atomic), the temp file is fsynced, then renamed over the destination.
    An interrupted writer can leave a stale ``.scc-tmp-*`` file but never a
    truncated artifact under a real name.

    ``inspect_fn(tmp_path)``, when given, runs between the write and the
    replace, for work that must see the final bytes before they land under
    the real name (the artifact store checksums the arrays file here and
    writes its sidecar). A raising inspect_fn aborts the write and cleans
    up the temp."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(prefix=ATOMIC_TMP_PREFIX, dir=d)
    os.close(fd)
    try:
        # mkstemp creates 0600; restore the umask-default mode so shared
        # artifact dirs can read the renamed file
        umask = os.umask(0)
        os.umask(umask)
        os.chmod(tmp, 0o666 & ~umask)
        write_fn(tmp)
        if inspect_fn is not None:
            inspect_fn(tmp)
        with open(tmp, "rb") as f:
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def write_json_atomic(path: str, obj: Any, indent: int = 1) -> None:
    """Atomic JSON export (see :func:`atomic_write`)."""
    def _w(tmp: str) -> None:
        with open(tmp, "w") as f:
            json.dump(obj, f, indent=indent, default=str)

    atomic_write(path, _w)


def write_chrome_trace(path: str, spans: List[Dict[str, Any]],
                       process_name: str = "scconsensus_tpu") -> None:
    write_json_atomic(path, chrome_trace(spans, process_name))
