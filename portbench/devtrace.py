"""What a traced run reads from the profiler: the device's busy intervals,
its idle gaps and the kernels' device time.

The window runs under ``torch.profiler`` (CPU and CUDA activities). Its
Chrome trace is written once, gzipped, to ``portbench/_out/`` and reduced
here:

* device intervals: the X-events of category ``kernel``, ``gpu_memcpy``
  and ``gpu_memset``; their union inside the window is the time the card
  was busy (``busy_s``), and the window's length is the
  ``portbench.window`` annotation's; the stretches annotated
  ``portbench.keep`` (the judged job's copy to the host) are taken out of
  both, as the untraced window leaves them out of its seconds;
* idle gaps: the stretches of the window outside that union, each named
  by the program's stage span open at its middle (the stage spans of
  each job are placed by the job's ``portbench.refine`` annotation and
  the spans' offsets from the start of ``refine()``), else by the
  benchmark's own annotation (``portbench.contingency``, the job loop);
* kernel time by name, summed over the window.

The arithmetic of placing kernels among host windows follows the port's
``obs/kernels.py``; the union and the gaps are this benchmark's own.
"""

from __future__ import annotations

import gzip
import json
import os
import shutil
from typing import Dict, List, Optional, Tuple

__all__ = ["DEVICE_CATS", "read_trace", "union_intervals", "gaps",
           "subtract", "summarize"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def read_trace(path: str) -> Dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return json.loads(f.read().decode("utf-8", errors="replace"))


def export(prof, out_dir: str, stem: str) -> Dict:
    """Export the profiler's trace, keep it gzipped under ``out_dir`` (one
    file a cell, overwritten) and return it parsed."""
    os.makedirs(out_dir, exist_ok=True)
    plain = os.path.join(out_dir, f"{stem}.trace.json")
    prof.export_chrome_trace(plain)
    trace = read_trace(plain)
    with open(plain, "rb") as src, gzip.open(plain + ".gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    os.unlink(plain)
    return trace


def union_intervals(intervals: List[Tuple[float, float]], lo: float,
                    hi: float) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals, clipped to [lo, hi], as sorted
    disjoint intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(busy: List[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] outside the disjoint sorted ``busy``."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def subtract(intervals: List[Tuple[float, float]],
             cut: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The parts of the disjoint sorted ``intervals`` outside the
    disjoint sorted ``cut``."""
    out = []
    for s, e in intervals:
        for cs, ce in cut:
            if ce <= s or cs >= e:
                continue
            if cs > s:
                out.append((s, cs))
            s = max(s, ce)
            if s >= e:
                break
        if s < e:
            out.append((s, e))
    return out


def _annotations(trace: Dict, name: str) -> List[Tuple[float, float]]:
    return sorted(
        (float(e["ts"]), float(e["ts"]) + float(e.get("dur") or 0.0))
        for e in trace.get("traceEvents") or []
        if e.get("ph") == "X" and e.get("name") == name
        and e.get("cat", "user_annotation") == "user_annotation")


def _namer(trace: Dict, jobs: List[Dict]):
    """Name a host instant (µs) by the stage open then."""
    refines = _annotations(trace, "portbench.refine")
    conts = _annotations(trace, "portbench.contingency")
    stages: List[Tuple[float, float, str]] = []
    for (r0, _r1), job in zip(refines, jobs):
        for sp in job.get("spans") or []:
            if sp.get("kind") != "stage" or sp.get("depth", 0) != 0:
                continue
            s = r0 + 1e6 * float(sp["t0_s"])
            wall = sp.get("wall_synced_s") or sp.get("wall_submitted_s") or 0
            stages.append((s, s + 1e6 * float(wall), str(sp["name"])))
    windows = ([(s, e, "contingency") for s, e in conts]
               + [(s, e, "refine") for s, e in refines])

    def name(t: float) -> str:
        for s, e, n in stages:
            if s <= t <= e:
                return f"stage:{n}"
        for s, e, n in windows:
            if s <= t <= e:
                return n
        return "between jobs"

    return name


def summarize(trace: Dict, jobs: List[Dict]) -> Optional[Dict]:
    """busy_s, window_s, the kernels' device seconds by name and the
    breakdown (the top device operations and the longest idle gaps) of
    the ``portbench.window`` annotation; None without that window or
    without any device event."""
    win = _annotations(trace, "portbench.window")
    if not win:
        return None
    lo, hi = win[0]
    keep = union_intervals(_annotations(trace, "portbench.keep"), lo, hi)
    dev, by_name = [], {}
    for e in trace.get("traceEvents") or []:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        s = float(e["ts"])
        d = float(e.get("dur") or 0.0)
        if s + d < lo or s > hi or any(ks <= s < ke for ks, ke in keep):
            continue
        dev.append((s, s + d))
        name = str(e.get("name"))
        by_name[name] = by_name.get(name, 0.0) + d * 1e-6
    if not dev:
        return None
    busy = subtract(union_intervals(dev, lo, hi), keep)
    idle = sorted(subtract(gaps(busy, lo, hi), keep),
                  key=lambda g: g[0] - g[1])[:TOP]
    namer = _namer(trace, jobs)
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "window_s": (hi - lo - sum(e - s for s, e in keep)) * 1e-6,
        "kernel_s": by_name,
        "breakdown": {
            "device_ops": [[n, s] for n, s in top_ops],
            "idle_gaps": [[namer(0.5 * (s + e)), (e - s) * 1e-6]
                          for s, e in idle],
        },
    }
