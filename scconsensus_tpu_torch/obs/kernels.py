"""Device-kernel timeline: a ``torch.profiler`` capture window joined to
tracer spans.

The port's form of ``scconsensus_tpu/obs/kernels.py``. Stage walls
measure the host; this module measures what the card did. It opens a
``torch.profiler`` window (CPU and CUDA activities, no shapes, no stacks)
around the run, exports the profiler's Chrome trace (gzipped) into the
capture directory, parses it, and joins:

  * **CUDA kernel events**: trace X-events of category ``kernel``, one per
    launch on the card, under the names of their ``__global__`` functions
    (the hand kernel's ``.so`` is loaded with ``ctypes``, not as a torch
    extension, and CUPTI still sees its launches);
  * **tracer spans**: while a profiler records, every span is a
    ``torch.profiler.record_function`` window (``obs.trace``), so span
    windows appear in the same timeline as ``user_annotation`` events on
    the host.

A kernel runs asynchronously: its device timestamp often falls after its
span's host window has closed. So a kernel is joined through its launch:
the host-side runtime or driver call (``cudaLaunchKernel``,
``cuLaunchKernel``, ...) that carries the same ``correlation`` id, and
it is attributed to the innermost annotation window covering that
launch's host timestamp (``span``) and to the innermost covering
stage-kind window (``stage``). A kernel whose launch is not in the trace
falls back to its own timestamp and is counted in ``n_unlinked``.

The result is the run record's validated ``kernels`` section: top-K
kernels by total device time, every kernel's count, time, span and stage
(``by_kernel``), device time per span and per stage, and the total device
time. Given ``obs.cost``'s per-stage summary (``SCC_OBS_COST``), the
section gains ``vs_cost_model``: per stage its device time, wall, cost
FLOPs and bytes, and the rates over device time. Its rows are the costed
stages and every stage that ran kernels (a stage with no cost-model
entry, such as ``silhouette`` with the hand kernel, carries its device
time and null costs), so the run's ``profile`` shows every stage's
device time. Capture is gated by
``SCC_OBS_KERNELS`` naming the capture directory; it is best effort: a
profiler that fails to start or export records ``error`` and never
crashes the run.
"""

from __future__ import annotations

import gzip
import json
import os
import shutil
import time
from typing import Any, Dict, List, Optional

from scconsensus_tpu_torch.config import env_flag

__all__ = [
    "capture_dir",
    "KernelCapture",
    "parse_trace_file",
    "device_op_events",
    "launch_events",
    "annotation_windows",
    "join_kernels_to_spans",
    "kernels_section",
    "validate_kernels",
]

DEFAULT_TOP_K = 12
# host-side event categories that carry a launch's correlation id
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver", "runtime", "driver")


def capture_dir() -> Optional[str]:
    """The ``SCC_OBS_KERNELS`` capture directory, or None (= capture off)."""
    d = env_flag("SCC_OBS_KERNELS")
    return str(d) if d else None


# --------------------------------------------------------------------------
# capture window
# --------------------------------------------------------------------------

class KernelCapture:
    """One profiler capture window. ``with KernelCapture(dir):`` starts a
    ``torch.profiler`` session on entry and stops and exports it on exit;
    :meth:`section` then parses the exported trace and builds the run
    record's section. CUDA activity is captured when a card is available.
    Never fatal: a profiler that cannot start or export
    records ``error`` and the run goes on."""

    def __init__(self, directory: Optional[str] = None,
                 top_k: int = DEFAULT_TOP_K):
        self.directory = directory if directory is not None else capture_dir()
        self.top_k = int(top_k)
        self.t_open = 0.0
        self.open_ok = False
        self.error: Optional[str] = None
        self.path: Optional[str] = None
        self.trace_bytes: Optional[int] = None
        self.start_s: Optional[float] = None
        self.export_s: Optional[float] = None
        self._prof = None

    @property
    def enabled(self) -> bool:
        return bool(self.directory)

    def __enter__(self) -> "KernelCapture":
        if not self.enabled:
            return self
        self.t_open = time.time()
        t0 = time.perf_counter()
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            os.makedirs(self.directory, exist_ok=True)
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts, record_shapes=False,
                                 with_stack=False, profile_memory=False)
            self._prof.__enter__()
            self.open_ok = True
        except Exception as e:
            self.error = f"profiler start failed: {e!r}"[:200]
        self.start_s = time.perf_counter() - t0
        return self

    def __exit__(self, *exc) -> None:
        if not self.open_ok:
            return
        t0 = time.perf_counter()
        try:
            self._prof.__exit__(None, None, None)
            stem = os.path.join(
                self.directory,
                f"kernels-{os.getpid()}-{int(self.t_open * 1e3)}.trace.json")
            self._prof.export_chrome_trace(stem)
            self.trace_bytes = os.path.getsize(stem)
            with open(stem, "rb") as src, gzip.open(stem + ".gz", "wb") as dst:
                shutil.copyfileobj(src, dst)
            os.unlink(stem)
            self.path = stem + ".gz"
        except Exception as e:
            self.error = f"profiler export failed: {e!r}"[:200]
            self.open_ok = False
        finally:
            self._prof = None
            self.export_s = time.perf_counter() - t0

    def trace_file(self) -> Optional[str]:
        """The gzipped trace this window exported, or None."""
        return self.path

    def section(self, span_records: Optional[List[Dict[str, Any]]] = None,
                stage_cost: Optional[Dict[str, Dict[str, Any]]] = None,
                ) -> Optional[Dict[str, Any]]:
        """The run record's ``kernels`` section, or None when capture was
        off. A failure degrades to an error-stamped section: a capture
        that was attempted always leaves evidence that it was."""
        if not self.enabled:
            return None
        if self.error and not self.open_ok:
            return {"top": [], "n_events": 0,
                    "total_device_time_s": 0.0, "error": self.error}
        path = self.trace_file()
        if path is None:
            return {"top": [], "n_events": 0, "total_device_time_s": 0.0,
                    "error": "no trace file produced"}
        try:
            sec = kernels_section(parse_trace_file(path), span_records or [],
                                  stage_cost=stage_cost, top_k=self.top_k)
        except Exception as e:
            return {"top": [], "n_events": 0, "total_device_time_s": 0.0,
                    "error": f"trace parse failed: {e!r}"[:200]}
        sec["trace_file"] = path
        sec["trace_bytes"] = self.trace_bytes
        sec["trace_gz_bytes"] = os.path.getsize(path)
        # the window's own cost on the run's wall: starting the profiler
        # (CUPTI's set-up on a card) and stopping and exporting it
        sec["start_s"] = self.start_s
        sec["export_s"] = self.export_s
        return sec


# --------------------------------------------------------------------------
# trace parsing
# --------------------------------------------------------------------------

def parse_trace_file(path: str) -> Dict[str, Any]:
    """Load a profiler Chrome-trace JSON (gzipped or plain)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return json.loads(f.read().decode("utf-8", errors="replace"))


def _correlation(e: Dict[str, Any]) -> Optional[int]:
    c = (e.get("args") or {}).get("correlation")
    return int(c) if isinstance(c, (int, float)) else None


def device_op_events(trace: Dict[str, Any]) -> List[Dict[str, Any]]:
    """The CUDA kernel executions: X-events of category ``kernel``, with
    their name, device start and duration (µs) and launch correlation."""
    out: List[Dict[str, Any]] = []
    for e in trace.get("traceEvents") or []:
        if e.get("ph") != "X" or e.get("cat") != "kernel":
            continue
        out.append({
            "name": str(e.get("name")),
            "ts_us": float(e.get("ts") or 0.0),
            "dur_us": float(e.get("dur") or 0.0),
            "correlation": _correlation(e),
        })
    return out


def launch_events(trace: Dict[str, Any]) -> Dict[int, float]:
    """Correlation id → host timestamp (µs) of the runtime or driver call
    that launched it."""
    out: Dict[int, float] = {}
    for e in trace.get("traceEvents") or []:
        if e.get("ph") != "X" or e.get("cat") not in _LAUNCH_CATS:
            continue
        c = _correlation(e)
        if c is not None and c not in out:
            out[c] = float(e.get("ts") or 0.0)
    return out


def annotation_windows(trace: Dict[str, Any], span_names) -> List[Dict]:
    """Host X-events whose name is a tracer span name: the spans'
    ``record_function`` windows (category ``user_annotation``; the
    profiler's device-side copies, ``gpu_user_annotation``, are in device
    time and left out)."""
    names = set(span_names)
    out = []
    for e in trace.get("traceEvents") or []:
        if e.get("ph") != "X" or e.get("name") not in names:
            continue
        if e.get("cat", "user_annotation") != "user_annotation":
            continue
        out.append({
            "span": str(e["name"]),
            "ts_us": float(e.get("ts") or 0.0),
            "dur_us": float(e.get("dur") or 0.0),
        })
    return out


def join_kernels_to_spans(kernels: List[Dict[str, Any]],
                          windows: List[Dict[str, Any]],
                          stage_names=(),
                          launches: Optional[Dict[int, float]] = None
                          ) -> None:
    """Attribute each kernel event, in place, to the innermost annotation
    window covering its launch's host timestamp (``span``) and to the
    innermost covering stage-named window (``stage``); None when nothing
    covers it. ``launches`` maps correlation ids to launch timestamps
    (:func:`launch_events`); a kernel without one is placed by its own
    device timestamp and marked ``linked: False``.

    One sweep: windows of one thread nest, so with kernels and windows in
    time order a stack of open windows holds, innermost on top, exactly
    the windows covering the current time."""
    launches = launches or {}
    stage_names = set(stage_names)
    for k in kernels:
        t = launches.get(k.get("correlation"))
        k["linked"] = t is not None
        k["t_us"] = t if t is not None else k["ts_us"]
    wins = sorted(windows, key=lambda w: (w["ts_us"], -w["dur_us"]))
    stack: List[Dict[str, Any]] = []
    i = 0
    for k in sorted(kernels, key=lambda k: k["t_us"]):
        t = k["t_us"]
        while i < len(wins) and wins[i]["ts_us"] <= t:
            stack.append(wins[i])
            i += 1
        covering = [w for w in stack if w["ts_us"] + w["dur_us"] >= t]
        stack = covering
        inner = min(covering, key=lambda w: w["dur_us"], default=None)
        k["span"] = inner["span"] if inner is not None else None
        stages = [w for w in covering if w["span"] in stage_names]
        inner_stage = min(stages, key=lambda w: w["dur_us"], default=None)
        k["stage"] = inner_stage["span"] if inner_stage is not None else None


def kernels_section(trace: Dict[str, Any],
                    span_records: List[Dict[str, Any]],
                    stage_cost: Optional[Dict[str, Dict[str, Any]]] = None,
                    top_k: int = DEFAULT_TOP_K) -> Dict[str, Any]:
    """Build the ``kernels`` run-record section from a parsed trace.
    ``span_records``: the tracer's span records (their names and kinds
    feed the join). ``stage_cost``: ``obs.cost``'s per-stage summary —
    when given, the section gains ``vs_cost_model`` (module docstring),
    with ``achieved_gflops_device`` / ``achieved_gbps_device``: cost
    totals over summed device time, the rate wall-based attribution
    understates whenever the host is the bottleneck."""
    kernels = device_op_events(trace)
    span_names = {s.get("name") for s in span_records
                  if isinstance(s, dict) and s.get("name")}
    stage_names = {s.get("name") for s in span_records
                   if isinstance(s, dict) and s.get("kind") == "stage"}
    windows = annotation_windows(trace, span_names)
    join_kernels_to_spans(kernels, windows, stage_names=stage_names,
                          launches=launch_events(trace))

    agg: Dict[str, Dict[str, Any]] = {}
    by_span: Dict[str, float] = {}
    by_stage: Dict[str, float] = {}
    total_us = 0.0
    for k in kernels:
        total_us += k["dur_us"]
        a = agg.setdefault(k["name"], {
            "kernel": k["name"], "device_time_us": 0.0, "count": 0,
            "spans": {}, "stages": {},
        })
        a["device_time_us"] += k["dur_us"]
        a["count"] += 1
        for key, acc, tally in (("span", a["spans"], by_span),
                                ("stage", a["stages"], by_stage)):
            if k.get(key):
                acc[k[key]] = acc.get(k[key], 0.0) + k["dur_us"]
                tally[k[key]] = tally.get(k[key], 0.0) + k["dur_us"]
    rows = sorted(agg.values(), key=lambda a: -a["device_time_us"])
    for a in rows:
        a["device_time_s"] = round(a["device_time_us"] / 1e6, 6)
        a["pct"] = (round(100.0 * a["device_time_us"] / total_us, 2)
                    if total_us else 0.0)
        a["span"] = max(a["spans"], key=a["spans"].get) \
            if a["spans"] else None
        a["stage"] = max(a["stages"], key=a["stages"].get) \
            if a["stages"] else None
        for key in ("spans", "stages", "device_time_us"):
            a.pop(key)
    sec = {
        "n_events": len(kernels),
        "n_kernels": len(agg),
        "n_unlinked": sum(1 for k in kernels if not k["linked"]),
        "n_windows": len(windows),
        "total_device_time_s": round(total_us / 1e6, 6),
        "top": rows[:top_k],
        "by_kernel": {a["kernel"]: {key: a[key] for key in
                                    ("count", "device_time_s", "span",
                                     "stage")} for a in rows},
        "by_span_device_s": {
            k: round(v / 1e6, 6) for k, v in sorted(
                by_span.items(), key=lambda kv: -kv[1])
        },
        "by_stage_device_s": {
            k: round(v / 1e6, 6) for k, v in sorted(
                by_stage.items(), key=lambda kv: -kv[1])
        },
    }
    if stage_cost:
        stages: Dict[str, Dict[str, Any]] = {}
        for stage in sorted(set(stage_cost) | set(by_stage)):
            cost = stage_cost.get(stage) or {}
            dev_s = by_stage.get(stage, 0.0) / 1e6
            row: Dict[str, Any] = {
                "device_time_s": round(dev_s, 6),
                "wall_s": cost.get("wall_s"),
                "flops": cost.get("flops"),
                "bytes_accessed": cost.get("bytes_accessed"),
            }
            if dev_s > 0:
                if cost.get("flops"):
                    row["achieved_gflops_device"] = round(
                        cost["flops"] / dev_s / 1e9, 3)
                if cost.get("bytes_accessed"):
                    row["achieved_gbps_device"] = round(
                        cost["bytes_accessed"] / dev_s / 1e9, 3)
            stages[stage] = row
        sec["vs_cost_model"] = stages
    return sec


# --------------------------------------------------------------------------
# validation
# --------------------------------------------------------------------------

def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"kernels section: {msg}")


def validate_kernels(sec: Dict[str, Any]) -> None:
    """Structural validation of a record's ``kernels`` section (the
    reference's checks; ``export.validate_run_record`` calls this)."""
    _require(isinstance(sec, dict), "must be an object")
    n = sec.get("n_events")
    _require(isinstance(n, int) and n >= 0,
             "n_events must be an int >= 0")
    tot = sec.get("total_device_time_s")
    _require(isinstance(tot, (int, float)) and tot >= 0,
             "total_device_time_s must be a number >= 0")
    top = sec.get("top")
    _require(isinstance(top, list), "top must be a list")
    for i, a in enumerate(top):
        _require(isinstance(a, dict), f"top[{i}] is not an object")
        _require(isinstance(a.get("kernel"), str) and a["kernel"],
                 f"top[{i}].kernel must be a non-empty string")
        dt = a.get("device_time_s")
        _require(isinstance(dt, (int, float)) and dt >= 0,
                 f"top[{i}].device_time_s must be a number >= 0")
        c = a.get("count")
        _require(isinstance(c, int) and c >= 1,
                 f"top[{i}].count must be an int >= 1")
    bs = sec.get("by_span_device_s")
    if bs is not None:
        _require(isinstance(bs, dict), "by_span_device_s must be an object")
        for k, v in bs.items():
            _require(isinstance(v, (int, float)) and v >= 0,
                     f"by_span_device_s[{k!r}] must be a number >= 0")
    vc = sec.get("vs_cost_model")
    if vc is not None:
        _require(isinstance(vc, dict), "vs_cost_model must be an object")
        for stage, row in vc.items():
            _require(isinstance(row, dict),
                     f"vs_cost_model[{stage!r}] not an object")
            dt = row.get("device_time_s")
            _require(isinstance(dt, (int, float)) and dt >= 0,
                     f"vs_cost_model[{stage!r}].device_time_s invalid")
