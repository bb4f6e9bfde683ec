"""Device and host memory gauges.

The port's copy of ``memory_snapshot`` (``scconsensus_tpu/obs/device.py:
62-94``) over ``torch.cuda.memory_stats``, for the run record's
``device.memory`` and the tracer's per-span ``device_mem``, and of
``host_rss_bytes`` and ``host_peak_rss_bytes`` (:106-150). The streaming
layer's budget (``stream.budget``) judges a run by the peak and enforces
against the current value. The rest of the reference's module (the
compile listener, the transfer watch) is not ported.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Dict, Optional

__all__ = ["memory_snapshot", "host_rss_bytes", "host_peak_rss_bytes"]


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
