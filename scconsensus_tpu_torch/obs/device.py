"""Device and host memory gauges.

The port's copy of ``memory_snapshot`` (``scconsensus_tpu/obs/device.py:
62-94``) over ``torch.cuda.memory_stats``, for the run record's
``device.memory`` and the tracer's per-span ``device_mem``, and of
``host_rss_bytes`` and ``host_peak_rss_bytes`` (:106-150). The streaming
layer's budget (``stream.budget``) judges a run by the peak and enforces
against the current value. :class:`TransferWatch` (:321-411) counts
explicit host↔device copies over the residency auditor's crossing hook.
The compile listener is not ported: the port compiles no XLA program.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Any, Dict, List, Optional, Sequence

__all__ = ["memory_snapshot", "host_rss_bytes", "host_peak_rss_bytes",
           "TransferWatch"]


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
