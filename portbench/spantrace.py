"""The program's spans in a traced run's profiler trace.

While a profiler records, the program's spans are ``record_function``
windows (``user_annotation`` events), so they lie in the trace beside
the benchmark's own ``portbench.*`` annotations and the device's events,
on the trace's clock. This module reads them from the gzipped trace that
``devtrace.export`` keeps under ``portbench/_out/`` (once a run, the
result kept on the run) and gives, per job of the window:

* the seconds of each program annotation by name (``consensus``, ``de``);
* ``idle_by_span``: the window's idle time (outside the union of kernel,
  copy and memset intervals, the ``portbench.keep`` stretches left out,
  as ``devtrace``) cut into pieces, each put down to the innermost
  program annotation it lies in, named ``stage:<top>/<innermost>`` or
  ``stage:<name>`` where the outermost is the innermost, else to the
  benchmark's annotation (``contingency``, ``refine``) or ``between
  jobs``; its seconds add up to the window's idle seconds;
* ``idle_gaps``: the longest gaps, each named so at its midpoint;
* ``de_idle_s``: the idle seconds inside the ``de`` windows;
* ``launches``: kernels by the annotation their launch (matched by
  ``correlation`` id) lies in, and ``de_launches``, those inside ``de``;
* ``device_s_by_span``: the kernels' device seconds by the same, and
  ``annotations_by_name``, the windows of each name (so the seconds of
  one ``wilcox_bucket``);
* ``implicit_syncs``: ``cudaStreamSynchronize``, ``cudaEventSynchronize``
  and synchronous ``cudaMemcpy*`` calls (``cuStreamSynchronize`` and the
  like too) inside the ``consensus`` and ``portbench.refine`` windows,
  and by annotation.
  ``cudaDeviceSynchronize`` is the stage boundaries' own drain and is
  left out.

A trace without program annotations (a program whose spans are not
profiler windows) gives None, and so does each reader. The summary is
also written to ``portbench/_out/<cell>.spans.json``.
"""

from __future__ import annotations

import bisect
import json
import os
from typing import Dict, List, Optional, Tuple

import devtrace

__all__ = ["summarize_spans", "of", "ward_s", "span_name"]

BENCH = "portbench."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize",
              "cuStreamSynchronize", "cuEventSynchronize")
TOP = 10

Interval = Tuple[float, float]


def _is_sync(name: str) -> bool:
    if name in SYNC_CALLS:
        return True
    return name.startswith(("cudaMemcpy", "cuMemcpy")) and "Async" not in name


def _windows(events: List[Dict], lo: float, hi: float
             ) -> List[Tuple[float, float, str]]:
    """The host annotations inside [lo, hi], by start."""
    out = []
    for e in events:
        if e.get("cat") != "user_annotation":
            continue
        s = float(e["ts"])
        t = s + float(e.get("dur") or 0.0)
        if s >= lo and t <= hi:
            out.append((s, t, str(e.get("name"))))
    return sorted(out)


def span_name(stack: List[str]) -> str:
    """The name of an instant from the program annotations open then,
    outermost first: ``stage:<top>/<innermost>``, or ``stage:<top>``
    where the outermost is the innermost."""
    top, inner = stack[0], stack[-1]
    return f"stage:{top}" if len(stack) == 1 else f"stage:{top}/{inner}"


def _segments(prog, bench, lo: float, hi: float
              ) -> Tuple[List[float], List[str]]:
    """[lo, hi] cut at every annotation's ends: the pieces' starts and
    their names (the same annotations are open throughout a piece). A
    piece outside every program annotation takes the benchmark's
    annotation open then, else ``between jobs``."""
    cuts = sorted({lo, hi} | {t for s, e, _ in prog + bench for t in (s, e)
                              if lo < t < hi})
    starts, names = [], []
    i = j = 0
    open_p: List = []
    open_b: List = []
    for a, b in zip(cuts, cuts[1:]):
        mid = 0.5 * (a + b)
        while i < len(prog) and prog[i][0] <= mid:
            open_p.append(prog[i])
            i += 1
        while j < len(bench) and bench[j][0] <= mid:
            open_b.append(bench[j])
            j += 1
        open_p = [w for w in open_p if w[1] >= mid]
        open_b = [w for w in open_b if w[1] >= mid]
        starts.append(a)
        if open_p:
            # annotations nest: outermost first (the longer at one start)
            stack = sorted(open_p, key=lambda w: (w[0], -w[1]))
            names.append(span_name([w[2] for w in stack]))
        else:
            names.append(open_b[-1][2] if open_b else "between jobs")
    return starts, names


def _overlap(pieces: List[Interval], starts: List[float], s: float,
             e: float) -> float:
    """Seconds (µs) of the disjoint sorted ``pieces`` inside [s, e]."""
    i = max(bisect.bisect_right(starts, s) - 1, 0)
    got = 0.0
    while i < len(pieces) and pieces[i][0] < e:
        a, b = pieces[i]
        got += max(0.0, min(b, e) - max(a, s))
        i += 1
    return got


def summarize_spans(trace: Dict, n_jobs: int) -> Optional[Dict]:
    """The per-job summary of the ``portbench.window`` annotation of
    ``trace``; None without the window, without a job or without any
    program annotation in it."""
    events = [e for e in trace.get("traceEvents") or []
              if e.get("ph") == "X"]
    win = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur") or 0))
                 for e in events if e.get("name") == BENCH + "window"
                 and e.get("cat") == "user_annotation")
    if not win or n_jobs <= 0:
        return None
    lo, hi = win[0]
    anns = _windows(events, lo, hi)
    prog = [a for a in anns if not a[2].startswith(BENCH)]
    if not prog:
        return None
    bench = [(s, e, n[len(BENCH):]) for s, e, n in anns
             if n in (BENCH + "contingency", BENCH + "refine")]
    keep = devtrace.union_intervals(
        [(s, e) for s, e, n in anns if n == BENCH + "keep"], lo, hi)

    dev, kernels, calls = [], [], []
    for e in events:
        cat = e.get("cat")
        s = float(e["ts"])
        d = float(e.get("dur") or 0.0)
        if cat in devtrace.DEVICE_CATS:
            if s + d < lo or s > hi or any(ks <= s < ke for ks, ke in keep):
                continue
            dev.append((s, s + d))
            if cat == "kernel":
                kernels.append((e, d))
        elif cat in LAUNCH_CATS:
            calls.append(e)
    busy = devtrace.subtract(devtrace.union_intervals(dev, lo, hi), keep)
    idle = devtrace.subtract(devtrace.gaps(busy, lo, hi), keep)
    idle_starts = [s for s, _ in idle]

    seg_starts, seg_names = _segments(prog, bench, lo, hi)

    def name_of(t: float) -> str:
        return seg_names[max(bisect.bisect_right(seg_starts, t) - 1, 0)]

    per_job = 1.0 / n_jobs
    by_span: Dict[str, float] = {}
    bounds = seg_starts + [hi]
    for k, name in enumerate(seg_names):
        sec = _overlap(idle, idle_starts, bounds[k], bounds[k + 1])
        if sec > 0:
            by_span[name] = by_span.get(name, 0.0) + sec * 1e-6 * per_job

    def seconds_of(name: str) -> Optional[float]:
        ws = [(s, e) for s, e, n in prog if n == name]
        return (sum(e - s for s, e in ws) * 1e-6 * per_job) if ws else None

    de = [(s, e) for s, e, n in prog if n == "de"]
    de_starts = [s for s, _ in de]

    def in_de(t: float) -> bool:
        i = bisect.bisect_right(de_starts, t) - 1
        return i >= 0 and t <= de[i][1]

    launch_ts = {}
    syncs: Dict[str, float] = {}
    sync_windows = sorted([(s, e) for s, e, n in prog if n == "consensus"]
                          + [(s, e) for s, e, n in bench if n == "refine"])
    sync_starts = [s for s, _ in sync_windows]
    n_syncs = 0
    for e in calls:
        corr = (e.get("args") or {}).get("correlation")
        t = float(e["ts"])
        if corr is not None:
            launch_ts[int(corr)] = t
        if not _is_sync(str(e.get("name"))) or not lo <= t <= hi:
            continue
        i = bisect.bisect_right(sync_starts, t) - 1
        if i >= 0 and t <= sync_windows[i][1]:
            n_syncs += 1
            nm = name_of(t)
            syncs[nm] = syncs.get(nm, 0.0) + per_job
    launches: Dict[str, float] = {}
    device_s: Dict[str, float] = {}
    n_de_launches = 0
    for e, d in kernels:
        corr = (e.get("args") or {}).get("correlation")
        t = launch_ts.get(int(corr)) if corr is not None else None
        if t is None:
            continue
        if in_de(t):
            n_de_launches += 1
        nm = name_of(t)
        launches[nm] = launches.get(nm, 0.0) + per_job
        device_s[nm] = device_s.get(nm, 0.0) + d * 1e-6 * per_job

    longest = sorted(idle, key=lambda g: g[0] - g[1])[:TOP]
    idle_s = sum(e - s for s, e in idle) * 1e-6 * per_job
    return {
        "n_jobs": n_jobs,
        "annotations_per_job": len(prog) * per_job,
        "annotations_by_name": {n: sum(1 for a in prog if a[2] == n)
                                * per_job for n in sorted({a[2] for a in prog})},
        "idle_s": idle_s,
        "idle_by_span": dict(sorted(by_span.items(), key=lambda kv: -kv[1])),
        "idle_gaps": [[name_of(0.5 * (s + e)), (e - s) * 1e-6]
                      for s, e in longest],
        "consensus_s": seconds_of("consensus"),
        "de_s": seconds_of("de"),
        "de_idle_s": (sum(_overlap(idle, idle_starts, s, e) for s, e in de)
                      * 1e-6 * per_job) if de else None,
        "de_launches": n_de_launches * per_job if de else None,
        "implicit_syncs": n_syncs * per_job,
        "syncs_by_span": dict(sorted(syncs.items(), key=lambda kv: -kv[1])),
        "launches_by_span": dict(sorted(launches.items(),
                                        key=lambda kv: -kv[1])),
        "device_s_by_span": dict(sorted(device_s.items(),
                                        key=lambda kv: -kv[1])),
    }


def of(run) -> Optional[Dict]:
    """The summary of a traced run, read once from the trace its window
    left under ``portbench/_out/`` (every traced run writes it anew) and
    kept on the run; None for an untraced run or a trace without program
    annotations."""
    if "spantrace" in vars(run):
        return run.spantrace
    run.spantrace = None
    if not run.traced:
        return None
    out = os.path.join(run.cell.root, "portbench", "_out")
    path = os.path.join(out, run.cell.name + ".trace.json.gz")
    if not os.path.exists(path):
        return None
    jobs = [j for j in run.jobs if "error" not in j]
    run.spantrace = summarize_spans(devtrace.read_trace(path), len(jobs))
    if run.spantrace is not None:
        with open(os.path.join(out, run.cell.name + ".spans.json"),
                  "w") as f:
            json.dump(run.spantrace, f, indent=1)
    return run.spantrace


def ward_s(run) -> Optional[float]:
    """The ``ward`` spans' seconds per job, from the jobs' span records;
    None where no job recorded one."""
    jobs = [j for j in run.jobs if "error" not in j]
    walls = [sp.get("wall_synced_s") or sp.get("wall_submitted_s") or 0.0
             for j in jobs for sp in j.get("spans") or []
             if sp.get("name") == "ward"]
    return sum(walls) / len(jobs) if walls else None
