"""Device and host memory gauges.

The port's copy of ``memory_snapshot`` (``scconsensus_tpu/obs/device.py:
62-94``) over ``torch.cuda.memory_stats``, for the run record's
``device.memory`` and the tracer's per-span ``device_mem``, and of
``host_rss_bytes`` and ``host_peak_rss_bytes`` (:106-150). The streaming
layer's budget (``stream.budget``) judges a run by the peak and enforces
against the current value. :class:`TransferWatch` (:321-411) counts
explicit host↔device copies over the residency auditor's crossing hook.

The compile-event stream (:154-300): ``install_compile_listener``,
``compile_mark``, ``compile_stats``, ``compile_events``, ``cache_mark``
and ``cache_events``, with the reference's tuple shapes. The port compiles
no XLA program; what it compiles are its two native libraries, at first
use in a process: the CUDA kernel (nvcc, ``ops.cuda_kernels.build``) and
the Ward library (g++, ``native.build``). Each builder reports through
:func:`native_build_event`: a build that ran is a duration event named
``scc/native/<library>_backend_compile`` (``obs.compilelog`` classifies
it ``backend``) with its seconds, a library found already built is a
cache hit ``scc/native/<library>_compile_cache_hit``. Both are stamped
with the ambient stage and its entry ordinal
(``obs.trace.ambient_stage``). The "listener" is the builders' own call,
so installing it only opens the stream, once per process, as the
reference's install does.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["memory_snapshot", "host_rss_bytes", "host_peak_rss_bytes",
           "install_compile_listener", "compile_mark", "compile_stats",
           "compile_events", "cache_mark", "cache_events",
           "native_build_event", "TransferWatch"]


def memory_snapshot(device=None) -> Optional[Dict[str, int]]:
    """Live and peak device memory of one card (default: the current
    one): ``{bytes_in_use, peak_bytes_in_use, bytes_limit}``, the
    reference's keys, from the caching allocator's counters. None when
    torch is not imported or CUDA was never initialized in this process
    (a CPU run), as the reference gives None with no backend up; the
    snapshot never initializes a context of its own."""
    try:
        torch = sys.modules.get("torch")
        if torch is None or not torch.cuda.is_initialized():
            return None
        dev = torch.cuda.current_device() if device is None else device
        ms = torch.cuda.memory_stats(dev)
        return {
            "bytes_in_use": int(ms.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(ms.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(
                torch.cuda.get_device_properties(dev).total_memory),
        }
    except Exception:
        return None


# one cached /proc/self/statm descriptor per process (re-opened after a
# fork), read with pread under a lock so two threads never race on it
_STATM = {"fd": None, "pid": None, "page": None}
_STATM_LOCK = threading.Lock()


def host_rss_bytes() -> Optional[int]:
    """Current resident set size of this process (``/proc/self/statm``
    on Linux; the peak where /proc is unavailable)."""
    try:
        with _STATM_LOCK:
            pid = os.getpid()
            if _STATM["fd"] is None or _STATM["pid"] != pid:
                fd = os.open("/proc/self/statm", os.O_RDONLY)
                old = _STATM["fd"]
                _STATM["fd"], _STATM["pid"] = fd, pid
                if old is not None:
                    try:
                        os.close(old)
                    except OSError:
                        pass
            if _STATM["page"] is None:
                _STATM["page"] = os.sysconf("SC_PAGE_SIZE")
            # procfs regenerates the content per read; pread needs no seek
            return int(os.pread(_STATM["fd"], 128, 0).split()[1]) \
                * _STATM["page"]
    except Exception:
        return host_peak_rss_bytes()


def host_peak_rss_bytes() -> Optional[int]:
    """Peak resident set size of this process since it started
    (``ru_maxrss``, KiB on Linux): the number a bounded-memory claim is
    judged by, since a spike between two samples is invisible to sampling
    but not to the kernel's high-water mark."""
    try:
        import resource

        ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return int(ru) if sys.platform == "darwin" else int(ru) * 1024
    except Exception:
        return None


# --------------------------------------------------------------------------
# compile events (the native builds)
# --------------------------------------------------------------------------

_COMPILE_LOCK = threading.Lock()
# (name, secs, stage|None, stage_entry_ordinal), the reference's rich
# tuples; consumers unpack with tolerance, as the reference's do
_COMPILE_EVENTS: List[Tuple] = []
_CACHE_EVENTS: List[Tuple] = []  # (name, stage|None, entry_ordinal)
_LISTENER_STATE = {"installed": False}
_EVENT_CAP = {"v": None}  # lazily resolved SCC_COMPILELOG_MAX_EVENTS


def _event_cap() -> int:
    if _EVENT_CAP["v"] is None:
        try:
            from scconsensus_tpu_torch.config import env_flag

            _EVENT_CAP["v"] = int(
                env_flag("SCC_COMPILELOG_MAX_EVENTS") or 65536)
        except Exception:
            _EVENT_CAP["v"] = 65536
    return _EVENT_CAP["v"]


def _ambient_stage() -> Tuple[Optional[str], int]:
    try:
        from scconsensus_tpu_torch.obs.trace import ambient_stage

        return ambient_stage()
    except Exception:
        return (None, 0)


def native_build_event(library: str, secs: float) -> None:
    """Record one native library's load: ``secs`` > 0 is a build that ran
    (a ``backend`` compile event of that many seconds), 0 a library found
    built (a cache hit). Nothing is kept before the stream is installed,
    as the reference keeps nothing before its listener."""
    if not _LISTENER_STATE["installed"]:
        return
    stage, occ = _ambient_stage()
    with _COMPILE_LOCK:
        if secs > 0:
            if len(_COMPILE_EVENTS) < _event_cap():
                _COMPILE_EVENTS.append(
                    (f"scc/native/{library}_backend_compile", float(secs),
                     stage, occ))
        elif len(_CACHE_EVENTS) < _event_cap():
            _CACHE_EVENTS.append(
                (f"scc/native/{library}_compile_cache_hit", stage, occ))


def install_compile_listener() -> bool:
    """Open the compile-event stream (once per process; idempotent).
    Always True: the builders report to it directly."""
    with _COMPILE_LOCK:
        _LISTENER_STATE["installed"] = True
        return True


def compile_mark() -> int:
    """Opaque position in the compile-event stream; pass to
    :func:`compile_stats` to aggregate only the events after it."""
    with _COMPILE_LOCK:
        return len(_COMPILE_EVENTS)


def compile_stats(since: int = 0) -> Dict[str, Any]:
    """Aggregate compile events observed after ``since``."""
    with _COMPILE_LOCK:
        events = _COMPILE_EVENTS[since:]
    by_event: Dict[str, Dict[str, float]] = {}
    for ev in events:
        rec = by_event.setdefault(ev[0], {"n": 0, "total_s": 0.0})
        rec["n"] += 1
        rec["total_s"] += ev[1]
    for rec in by_event.values():
        rec["total_s"] = round(rec["total_s"], 4)
    return {
        "events": len(events),
        "total_s": round(sum(ev[1] for ev in events), 4),
        "by_event": by_event,
    }


def compile_events(since: int = 0) -> List[Tuple]:
    """Raw compile-event tuples after ``since``: ``(name, secs, stage,
    entry_ordinal)``. obs.compilelog builds the run record's ``compile``
    section from these."""
    with _COMPILE_LOCK:
        return list(_COMPILE_EVENTS[since:])


def cache_mark() -> int:
    """Opaque position in the cache-hit event stream."""
    with _COMPILE_LOCK:
        return len(_CACHE_EVENTS)


def cache_events(since: int = 0) -> List[Tuple]:
    """Raw cache-hit tuples ``(name, stage, entry_ordinal)`` after
    ``since``."""
    with _COMPILE_LOCK:
        return list(_CACHE_EVENTS[since:])


# --------------------------------------------------------------------------
# transfer-bytes guard
# --------------------------------------------------------------------------

class TransferWatch:
    """Scoped accounting of explicit host↔device transfers.

    For the duration of the context it attaches to the crossing hook of
    ``obs.residency`` (the patched ``Tensor.cpu``/``.cuda``/``.to``/
    ``.copy_``/``.item``/``.tolist`` and ``torch.as_tensor``/``.tensor``)
    and accumulates bytes per direction. Fetches larger than
    ``flag_host_bytes`` are recorded as *flags* with the ambient span's
    name — the signature of an accidental (P, G)-sized host round-trip.

    Best-effort by design, as in the reference: the implicit forms
    (``bool()``, ``int()``, ``float()`` of a tensor, ``np.asarray`` through
    ``.numpy()``) are the auditor's, not the watch's, so the count is a
    lower bound; the FLAGS are what matter operationally. ``device_types``
    names the device side of the line, as for the auditor.
    """

    def __init__(self, flag_host_bytes: int = 64 << 20,
                 device_types: Sequence[str] = ("cuda",)):
        self.flag_host_bytes = int(flag_host_bytes)
        self.device_types = tuple(device_types)
        self.to_device_bytes = 0
        self.to_host_bytes = 0
        self.to_device_calls = 0
        self.to_host_calls = 0
        self.flags: List[Dict[str, Any]] = []
        self._lock = threading.Lock()

    def _span_name(self) -> Optional[str]:
        try:
            from scconsensus_tpu_torch.obs.trace import current_span

            sp = current_span()
            return sp.name if sp is not None else None
        except Exception:
            return None

    def _crossing(self, direction: str, nbytes: int, implicit: bool,
                  api: str) -> None:
        if implicit:
            return
        with self._lock:
            if direction == "h2d":
                self.to_device_calls += 1
                self.to_device_bytes += nbytes
                return
            self.to_host_calls += 1
            self.to_host_bytes += nbytes
            if nbytes > self.flag_host_bytes:
                self.flags.append({"bytes": nbytes,
                                   "span": self._span_name()})

    def __enter__(self) -> "TransferWatch":
        from scconsensus_tpu_torch.obs import residency

        residency._attach(self)
        return self

    def __exit__(self, *exc) -> None:
        from scconsensus_tpu_torch.obs import residency

        residency._detach(self)

    def report(self) -> Dict[str, Any]:
        return {
            "to_device_bytes": self.to_device_bytes,
            "to_device_calls": self.to_device_calls,
            "to_host_bytes": self.to_host_bytes,
            "to_host_calls": self.to_host_calls,
            "flag_host_bytes": self.flag_host_bytes,
            "flags": self.flags,
        }
