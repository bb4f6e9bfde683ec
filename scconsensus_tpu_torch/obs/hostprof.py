"""Host execution profiler: sampled stacks, GC pauses, memory timeline.

The port's form of ``scconsensus_tpu/obs/hostprof.py``; its section
builders and validators are the reference's, pinned equal by the tests.
Three instruments, all bucketed by the existing trace spans:

* a **sampling stack profiler** — a daemon thread snapshots the run
  thread's stack via ``sys._current_frames()`` every ``period_s``
  (default 50 Hz from ``SCC_HOSTPROF_HZ``), classifies each sample into
  a named host cause and attributes it to the innermost open *stage*
  span (:func:`~scconsensus_tpu_torch.obs.trace.ambient_stage`). A
  torch sync is a C call with no Python frame of its own, so
  ``blocking_wait`` is read from the port's Python sync points: the
  tracer's ``device_drain``, ``torch.cuda.synchronize``, the stage
  clock's ``_sync``, the streaming runner's ``_fetch`` and the residency
  hook's wrappers (``fetched``: ``.item()``, ``.tolist()``, ``.numpy()``,
  ``bool()``, ``int()``, ``float()``; ``moved``: ``.cpu()``, ``.cuda()``,
  ``.to()``), present while an auditor or a transfer watch is active. ``compile`` is the build of a native kernel
  at first use (``ops.cuda_kernels.build``, ``native.build``: nvcc and
  g++); ``serialization`` is the json and pickle codecs;
* **GC pause accounting** — a ``gc.callbacks`` hook measures every
  collection's stop-the-world pause and bills it to the ambient stage
  (or the explicit ``(outside spans)`` bucket);
* a **memory timeline** — host RSS (and, when CUDA is initialized, the
  card's ``bytes_in_use`` from ``obs.device.memory_snapshot``) sampled on
  the same tick grid and laid over the stage timeline.

Everything lands as two run-record sections — ``host_profile`` and
``memory_timeline`` — built by the pure functions
:func:`build_host_profile` / :func:`build_memory_timeline` and validated
by :func:`validate_host_profile` / :func:`validate_memory_timeline` from
``export.validate_run_record``. ``refine()`` starts the profiler when
``SCC_HOSTPROF`` is set and attaches both sections to its result.

Overhead: the sampler does one ``_current_frames`` walk + one
``/proc/self/statm`` pread per tick and self-times its own work
(``sampler_self_s`` lands on the section).
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

from scconsensus_tpu_torch.config import env_flag

__all__ = [
    "HOSTPROF_VERSION",
    "OUTSIDE_SPANS",
    "CATEGORIES",
    "HostProfiler",
    "classify_stack",
    "build_host_profile",
    "build_memory_timeline",
    "validate_host_profile",
    "validate_memory_timeline",
    "start_if_enabled",
    "active_profiler",
    "stop_active",
]

HOSTPROF_VERSION = 1

# Stage bucket for samples/pauses with no open stage span: between
# stages, before the first one, after the last one. An explicit name —
# not a dropped sample — because a GC storm between stages is real wall
# the run paid and the timeline must not silently shrink.
OUTSIDE_SPANS = "(outside spans)"

# Sampled-stack categories. ``gc`` seconds come from the callback
# accounting (measured pauses), never from samples — a sample landing
# mid-collection shows whatever Python frame triggered it.
CATEGORIES = ("python", "gc", "blocking_wait", "compile", "serialization")

# frame-name sets for the sampled-stack classifier (leaf-outward scan,
# first match wins — a python frame *waiting inside* a sync is a blocking
# wait, not python compute)
_BLOCK_NAMES = frozenset({
    "device_drain", "synchronize", "_sync", "_fetch", "fetched", "moved",
})
# the native builds at first use: (function name, file suffix)
_COMPILE_FRAMES = (
    ("build", os.path.join("ops", "cuda_kernels.py")),
    ("build", os.path.join("native", "__init__.py")),
)
_SER_FILE_SUFFIXES = (
    os.path.join("json", "encoder.py"), os.path.join("json", "decoder.py"),
    os.path.join("json", "__init__.py"), "pickle.py",
)
_MAX_WALK_DEPTH = 64


def classify_stack(frame) -> Tuple[str, Optional[str]]:
    """Classify one sampled stack (leaf frame object) into a category +
    the leaf frame's ``file:func:line`` string. Pure over the frame
    chain; None frame classifies as python with no frame (the run
    thread can be gone by the time the sampler looks)."""
    if frame is None:
        return "python", None
    co = frame.f_code
    top = f"{os.path.basename(co.co_filename)}:{co.co_name}:{frame.f_lineno}"
    f, depth = frame, 0
    while f is not None and depth < _MAX_WALK_DEPTH:
        co = f.f_code
        fn, fl = co.co_name, co.co_filename
        if fn in _BLOCK_NAMES:
            return "blocking_wait", top
        if any(fn == name and fl.endswith(suffix)
               for name, suffix in _COMPILE_FRAMES):
            return "compile", top
        if fl.endswith(_SER_FILE_SUFFIXES):
            return "serialization", top
        f = f.f_back
        depth += 1
    return "python", top


def _ambient_stage_name() -> Optional[str]:
    """Innermost open stage-span name, thread-safe (the sampler and the
    gc callback both run off the run thread's context)."""
    try:
        from scconsensus_tpu_torch.obs.trace import ambient_stage

        return ambient_stage()[0]
    except Exception:
        return None


# --------------------------------------------------------------------------
# pure section builders (the degenerate-input tests drive these directly)
# --------------------------------------------------------------------------

def build_host_profile(
    samples: Iterable[Tuple[float, Optional[str], str, Optional[str]]],
    gc: Optional[Dict[str, Any]] = None,
    period_s: float = 0.02,
    sampler_self_s: float = 0.0,
    top_frames: int = 5,
) -> Dict[str, Any]:
    """``host_profile`` section from raw samples + GC accounting.

    ``samples``: ``(t_s, stage|None, category, frame|None)`` tuples;
    ``gc``: ``{"collections": int, "by_stage": {stage|None: {"pauses":
    n, "pause_s": s}}}``. A stage shorter than one sampling period
    simply has no samples (and therefore no row unless GC billed it) —
    zero rows is honest, zero seconds would be a lie about coverage.
    Always returns a section (the profiler *ran*); absence of the
    section on a record means the profiler never ran."""
    period_s = float(period_s)
    stages: Dict[str, Dict[str, Any]] = {}
    frames: Dict[str, Dict[str, int]] = {}
    n = 0
    for s in samples:
        n += 1
        stage = s[1] if s[1] else OUTSIDE_SPANS
        cat = s[2] if s[2] in CATEGORIES else "python"
        row = stages.setdefault(stage, {
            "samples": 0,
            "causes": {c: 0.0 for c in CATEGORIES},
        })
        row["samples"] += 1
        row["causes"][cat] = round(row["causes"][cat] + period_s, 6)
        fr = s[3] if len(s) > 3 else None
        if cat == "python" and isinstance(fr, str) and fr:
            fc = frames.setdefault(stage, {})
            fc[fr] = fc.get(fr, 0) + 1

    gc = gc or {}
    gc_total = 0.0
    gc_outside = 0.0
    for stage, p in (gc.get("by_stage") or {}).items():
        pauses = int(p.get("pauses") or 0)
        pause_s = float(p.get("pause_s") or 0.0)
        gc_total += pause_s
        key = stage if stage else OUTSIDE_SPANS
        if not stage:
            gc_outside += pause_s
        row = stages.setdefault(key, {
            "samples": 0,
            "causes": {c: 0.0 for c in CATEGORIES},
        })
        row["causes"]["gc"] = round(row["causes"]["gc"] + pause_s, 6)
        row["gc_pauses"] = row.get("gc_pauses", 0) + pauses

    for stage, row in stages.items():
        row["est_s"] = round(row["samples"] * period_s, 6)
        fc = frames.get(stage)
        if fc:
            ranked = sorted(fc.items(), key=lambda kv: (-kv[1], kv[0]))
            row["top_frame"] = ranked[0][0]
            row["top_frames"] = [
                {"frame": f, "samples": c}
                for f, c in ranked[:max(int(top_frames), 1)]
            ]

    return {
        "version": HOSTPROF_VERSION,
        "period_s": round(period_s, 6),
        "n_samples": n,
        "sampler_self_s": round(float(sampler_self_s), 6),
        "stages": {k: stages[k] for k in sorted(stages)},
        "gc": {
            "collections": int(gc.get("collections") or 0),
            "pause_s": round(gc_total, 6),
            "outside_spans_pause_s": round(gc_outside, 6),
        },
    }


def build_memory_timeline(
    mem_samples: Iterable[
        Tuple[float, Optional[int], Optional[int], Optional[str]]
    ],
    period_s: float = 0.02,
    max_points: int = 240,
) -> Optional[Dict[str, Any]]:
    """``memory_timeline`` section from ``(t_s, rss_bytes|None,
    hbm_bytes|None, stage|None)`` ticks, downsampled to ``max_points``
    evenly spaced samples (the full grid at 50 Hz over a long run would
    dwarf the record). None when nothing was sampled — absence, never
    an empty timeline claiming the run used no memory."""
    rows = [
        (float(s[0]), int(s[1]),
         int(s[2]) if len(s) > 2 and s[2] is not None else None,
         s[3] if len(s) > 3 and s[3] else None)
        for s in mem_samples
        if s[1] is not None and int(s[1]) >= 0 and float(s[0]) >= 0
    ]
    if not rows:
        return None
    rows.sort(key=lambda r: r[0])
    n = len(rows)
    rss_peak = max(r[1] for r in rows)
    hbm_vals = [r[2] for r in rows if r[2] is not None]

    by_stage: Dict[str, Dict[str, int]] = {}
    for _, rss, _, stage in rows:
        key = stage or OUTSIDE_SPANS
        st = by_stage.setdefault(key, {"rss_first_bytes": rss,
                                       "rss_peak_bytes": rss,
                                       "rss_last_bytes": rss})
        st["rss_peak_bytes"] = max(st["rss_peak_bytes"], rss)
        st["rss_last_bytes"] = rss
    for st in by_stage.values():
        st["rss_delta_bytes"] = st["rss_last_bytes"] - st["rss_first_bytes"]

    keep = rows
    if n > max_points > 0:
        step = n / float(max_points)
        keep = [rows[min(int(i * step), n - 1)] for i in range(max_points)]
        keep[-1] = rows[-1]  # the final sample always survives

    samples: List[Dict[str, Any]] = []
    for t, rss, hbm, stage in keep:
        row: Dict[str, Any] = {"t_s": round(t, 4), "rss_bytes": rss}
        if hbm is not None:
            row["hbm_bytes"] = hbm
        if stage:
            row["stage"] = stage
        samples.append(row)

    sec: Dict[str, Any] = {
        "version": HOSTPROF_VERSION,
        "period_s": round(float(period_s), 6),
        "n_samples": n,
        "samples": samples,
        "rss_peak_bytes": rss_peak,
        "by_stage": {k: by_stage[k] for k in sorted(by_stage)},
    }
    if hbm_vals:
        sec["hbm_peak_bytes"] = max(hbm_vals)
    return sec


# --------------------------------------------------------------------------
# the live sampler
# --------------------------------------------------------------------------

class HostProfiler:
    """Low-overhead sampling profiler for one run thread.

    ``start()`` registers the ``gc.callbacks`` hook and launches the
    sampler thread; ``sections()`` snapshots both record sections at
    any point;
    ``stop()`` tears both down. Every accessor is best-effort: the
    profiler observes the run, it must never kill it."""

    def __init__(self, period_s: float = 0.02,
                 thread_ident: Optional[int] = None,
                 hbm_every: int = 10, max_samples: int = 500_000):
        self.period_s = max(float(period_s), 0.001)
        self._ident = thread_ident if thread_ident is not None \
            else threading.get_ident()
        self._hbm_every = max(int(hbm_every), 1)
        self._max_samples = int(max_samples)
        self._t0 = time.perf_counter()
        self._samples: List[Tuple[float, Optional[str], str,
                                  Optional[str]]] = []
        self._mem: List[Tuple[float, Optional[int], Optional[int],
                              Optional[str]]] = []
        # (stage, pause_s) per collection, appended without the lock: a
        # collection can start in any thread while that thread holds the
        # lock (an allocation inside it), and the lock is not reentrant
        self._gc_pauses: List[Tuple[Optional[str], float]] = []
        self._gc_t0: Optional[float] = None
        self._self_s = 0.0
        self._ticks = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._gc_cb = None

    # -- gc pause accounting ----------------------------------------------
    def _on_gc(self, phase: str, info: Dict[str, Any]) -> None:
        try:
            if phase == "start":
                self._gc_t0 = time.perf_counter()
                return
            t0 = self._gc_t0
            self._gc_t0 = None
            if t0 is None:
                return
            pause = time.perf_counter() - t0
            self._gc_pauses.append((_ambient_stage_name(), pause))
        except Exception:
            pass  # a broken probe must not break collection itself

    # -- sampler loop ------------------------------------------------------
    def _tick(self) -> None:
        t_s = time.perf_counter() - self._t0
        frame = sys._current_frames().get(self._ident)
        stage = _ambient_stage_name()
        cat, top = classify_stack(frame)
        hbm = None
        if self._ticks % self._hbm_every == 0:
            try:
                from scconsensus_tpu_torch.obs import device as obs_device

                ms = obs_device.memory_snapshot()
                if ms:
                    hbm = ms.get("bytes_in_use")
            except Exception:
                hbm = None
        try:
            from scconsensus_tpu_torch.obs import device as obs_device

            rss = obs_device.host_rss_bytes()
        except Exception:
            rss = None
        with self._lock:
            if len(self._samples) < self._max_samples:
                self._samples.append((t_s, stage, cat, top))
                self._mem.append((t_s, rss, hbm, stage))

    def _loop(self) -> None:
        next_t = time.perf_counter()
        while not self._stop.is_set():
            # thread_time, not perf_counter: like the flight recorder's
            # tick accounting, GIL waits while the run thread computes
            # are scheduling, not sampler cost — wall-clock self-timing
            # would charge them to the profiler
            w0 = time.thread_time()
            try:
                self._tick()
            except Exception:
                pass
            self._ticks += 1
            self._self_s += time.thread_time() - w0
            next_t += self.period_s
            delay = next_t - time.perf_counter()
            if delay <= 0:
                # fell behind (GIL starvation): resync instead of a
                # catch-up burst that would multiply the overhead
                next_t = time.perf_counter() + self.period_s
                delay = self.period_s
            self._stop.wait(delay)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "HostProfiler":
        import gc

        if self._thread is not None:
            return self
        self._gc_cb = self._on_gc
        gc.callbacks.append(self._gc_cb)
        self._thread = threading.Thread(
            target=self._loop, name="scc-hostprof", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        import gc

        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        if self._gc_cb is not None:
            try:
                gc.callbacks.remove(self._gc_cb)
            except ValueError:
                pass
            self._gc_cb = None

    # -- views -------------------------------------------------------------
    def sections(self) -> Dict[str, Optional[Dict[str, Any]]]:
        """Both record sections from the data collected so far (safe on
        a still-running profiler: the sampler keeps ticking)."""
        with self._lock:
            samples = list(self._samples)
            mem = list(self._mem)
            self_s = self._self_s
        pauses = list(self._gc_pauses)
        by_stage: Dict[Optional[str], Dict[str, float]] = {}
        for stage, pause in pauses:
            row = by_stage.setdefault(stage, {"pauses": 0, "pause_s": 0.0})
            row["pauses"] += 1
            row["pause_s"] += pause
        gc_stat = {"collections": len(pauses), "by_stage": by_stage}
        return {
            "host_profile": build_host_profile(
                samples, gc=gc_stat, period_s=self.period_s,
                sampler_self_s=self_s,
            ),
            "memory_timeline": build_memory_timeline(
                mem, period_s=self.period_s
            ),
        }


# module-level active profiler (one per process, like the flight recorder)
_ACTIVE: Dict[str, Optional[HostProfiler]] = {"prof": None}


def start_if_enabled() -> Optional[HostProfiler]:
    """Start (once) the process profiler when ``SCC_HOSTPROF`` is set;
    period from ``SCC_HOSTPROF_HZ``. Returns the active profiler or
    None (disabled)."""
    if _ACTIVE["prof"] is not None:
        return _ACTIVE["prof"]
    if not env_flag("SCC_HOSTPROF"):
        return None
    hz = float(env_flag("SCC_HOSTPROF_HZ") or 0.0)
    period = 1.0 / hz if hz > 0 else 0.02
    prof = HostProfiler(period_s=period).start()
    _ACTIVE["prof"] = prof
    return prof


def active_profiler() -> Optional[HostProfiler]:
    return _ACTIVE["prof"]


def stop_active() -> None:
    prof = _ACTIVE["prof"]
    _ACTIVE["prof"] = None
    if prof is not None:
        prof.stop()


# --------------------------------------------------------------------------
# validation (export.validate_run_record dispatches here)
# --------------------------------------------------------------------------

def _require(cond: bool, section: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{section} section: {msg}")


def validate_host_profile(sec: Dict[str, Any]) -> None:
    """Structural validation of a record's ``host_profile`` section
    (additive scc-run-record v1 extension)."""
    _require(isinstance(sec, dict), "host_profile", "must be an object")
    _require(sec.get("version") == HOSTPROF_VERSION, "host_profile",
             f"version must be {HOSTPROF_VERSION}")
    p = sec.get("period_s")
    _require(isinstance(p, (int, float)) and p > 0, "host_profile",
             "period_s must be a number > 0")
    n = sec.get("n_samples")
    _require(isinstance(n, int) and n >= 0, "host_profile",
             "n_samples must be an int >= 0")
    ss = sec.get("sampler_self_s")
    _require(isinstance(ss, (int, float)) and ss >= 0, "host_profile",
             "sampler_self_s must be a number >= 0")
    stages = sec.get("stages")
    _require(isinstance(stages, dict), "host_profile",
             "stages must be an object")
    total_samples = 0
    for name, row in stages.items():
        _require(isinstance(row, dict), "host_profile",
                 f"stages[{name!r}] is not an object")
        k = row.get("samples")
        _require(isinstance(k, int) and k >= 0, "host_profile",
                 f"stages[{name!r}].samples must be an int >= 0")
        total_samples += k
        causes = row.get("causes")
        _require(isinstance(causes, dict), "host_profile",
                 f"stages[{name!r}].causes must be an object")
        for c in CATEGORIES:
            v = causes.get(c)
            _require(isinstance(v, (int, float)) and v >= 0,
                     "host_profile",
                     f"stages[{name!r}].causes.{c} must be >= 0")
        est = row.get("est_s")
        _require(isinstance(est, (int, float)) and est >= 0,
                 "host_profile", f"stages[{name!r}].est_s must be >= 0")
        tf = row.get("top_frames")
        if tf is not None:
            _require(isinstance(tf, list), "host_profile",
                     f"stages[{name!r}].top_frames must be a list")
            for e in tf:
                _require(isinstance(e, dict) and isinstance(
                    e.get("frame"), str) and isinstance(
                        e.get("samples"), int), "host_profile",
                    f"stages[{name!r}].top_frames entries need "
                    "frame/samples")
    _require(total_samples == n, "host_profile",
             "per-stage samples do not sum to n_samples")
    g = sec.get("gc")
    _require(isinstance(g, dict), "host_profile", "gc must be an object")
    c = g.get("collections")
    _require(isinstance(c, int) and c >= 0, "host_profile",
             "gc.collections must be an int >= 0")
    for k in ("pause_s", "outside_spans_pause_s"):
        v = g.get(k)
        _require(isinstance(v, (int, float)) and v >= 0, "host_profile",
                 f"gc.{k} must be a number >= 0")


def validate_memory_timeline(sec: Dict[str, Any]) -> None:
    """Structural validation of a record's ``memory_timeline`` section."""
    _require(isinstance(sec, dict), "memory_timeline", "must be an object")
    _require(sec.get("version") == HOSTPROF_VERSION, "memory_timeline",
             f"version must be {HOSTPROF_VERSION}")
    n = sec.get("n_samples")
    _require(isinstance(n, int) and n >= 1, "memory_timeline",
             "n_samples must be an int >= 1")
    samples = sec.get("samples")
    _require(isinstance(samples, list) and samples, "memory_timeline",
             "samples must be a non-empty list")
    _require(len(samples) <= n, "memory_timeline",
             "more samples than n_samples claims were taken")
    last_t = -1.0
    for i, s in enumerate(samples):
        _require(isinstance(s, dict), "memory_timeline",
                 f"samples[{i}] is not an object")
        t = s.get("t_s")
        _require(isinstance(t, (int, float)) and t >= 0,
                 "memory_timeline", f"samples[{i}].t_s must be >= 0")
        _require(t >= last_t, "memory_timeline",
                 "samples must be time-ordered")
        last_t = t
        r = s.get("rss_bytes")
        _require(isinstance(r, int) and r >= 0, "memory_timeline",
                 f"samples[{i}].rss_bytes must be an int >= 0")
        h = s.get("hbm_bytes")
        _require(h is None or (isinstance(h, int) and h >= 0),
                 "memory_timeline",
                 f"samples[{i}].hbm_bytes must be an int >= 0")
    peak = sec.get("rss_peak_bytes")
    _require(isinstance(peak, int) and peak >= 0, "memory_timeline",
             "rss_peak_bytes must be an int >= 0")
    _require(peak >= max(s["rss_bytes"] for s in samples),
             "memory_timeline",
             "rss_peak_bytes below a carried sample")
    bs = sec.get("by_stage")
    if bs is not None:
        _require(isinstance(bs, dict), "memory_timeline",
                 "by_stage must be an object")
        for name, row in bs.items():
            _require(isinstance(row, dict), "memory_timeline",
                     f"by_stage[{name!r}] is not an object")
            for k in ("rss_first_bytes", "rss_peak_bytes",
                      "rss_last_bytes"):
                v = row.get(k)
                _require(isinstance(v, int) and v >= 0,
                         "memory_timeline",
                         f"by_stage[{name!r}].{k} must be an int >= 0")
