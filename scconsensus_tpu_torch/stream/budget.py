"""The host-memory budget accountant for out-of-core streaming.

The port's copy of ``scconsensus_tpu/stream/budget.py``. Two budgets, one
ledger:

  * ``SCC_STREAM_HOST_BUDGET_MB``: the bound the record is judged by,
    taken over the process's baseline: the peak RSS (the kernel's
    high-water mark, ``obs.device.host_peak_rss_bytes``) sampled when the
    accountant is built. A torch process with CUDA up starts at ~4.8 GB
    resident, above the 4,096 MB default, so the budget bounds what the
    run adds to the process it runs in. The peak RSS must stay at or
    under baseline + budget for the run's
    ``streaming.budget.within_budget`` claim to validate (the section's
    ``limit_mb`` is that sum; ``budget_mb`` and ``baseline_rss_mb`` are
    its parts). Sampled on every charge; a charge that would take the
    current RSS past baseline + budget raises typed
    :class:`HostBudgetExceeded` before the allocation.
  * ``SCC_STREAM_STAGE_BUDGET_MB``: the bound the streaming layer
    enforces on its own buffers (loaded CSR chunks, the DE window's
    staging, the dense embed, the (N, n_pcs) scores): each is
    ``charge()``d before it is allocated and ``release()``d when it is
    dropped, so a charge past the budget raises before the memory exists.
    The window-halving ladder converges against this budget.

The declared crossings feed the ledger (``obs.residency``): the bytes
that crossed at ``input_staging`` and ``stream_block_fetch`` are tallied
per boundary, the evidence that chunk staging follows the load → device
→ drop contract. The accountant times itself (``consumed_s``), so the
< 2 % guard prices the accounting too.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

from scconsensus_tpu_torch.config import env_flag

__all__ = ["MB", "HostBudgetExceeded", "HostBudgetAccountant"]

MB = 1 << 20


class HostBudgetExceeded(RuntimeError):
    """A typed streaming budget breach. ``kind`` says which bound broke:
    ``"staged"`` (the streaming layer's own buffers — recoverable by
    halving the window) or ``"rss"`` (whole-process high-water mark —
    recoverable the same way while the floor holds, then fatal).
    Carries the numbers so the recovery ladder can log an attributable
    degradation."""

    def __init__(self, kind: str, need_bytes: int, used_bytes: int,
                 limit_bytes: int, what: str = ""):
        self.kind = kind
        self.need_bytes = int(need_bytes)
        self.used_bytes = int(used_bytes)
        self.limit_bytes = int(limit_bytes)
        self.what = what
        super().__init__(
            f"host budget exceeded ({kind}): charging {need_bytes >> 20} "
            f"MB for {what or 'a streaming buffer'} on top of "
            f"{used_bytes >> 20} MB would pass the {limit_bytes >> 20} MB "
            "budget — halve the streaming window or raise "
            "SCC_STREAM_HOST_BUDGET_MB / SCC_STREAM_STAGE_BUDGET_MB"
        )


class HostBudgetAccountant:
    """Charge/release ledger for the streaming layer's host buffers.

    Thread-safe (a live reader may sample it). Use as a context manager:
    entry registers the live summary (``stream.record.set_active``) and
    the residency transfer listener, exit deregisters both.
    """

    def __init__(self, budget_mb: Optional[float] = None,
                 stage_budget_mb: Optional[float] = None):
        from scconsensus_tpu_torch.obs.device import host_peak_rss_bytes

        self.limit_bytes = int(
            float(budget_mb if budget_mb is not None
                  else env_flag("SCC_STREAM_HOST_BUDGET_MB")) * MB
        )
        self.stage_limit_bytes = int(
            float(stage_budget_mb if stage_budget_mb is not None
                  else env_flag("SCC_STREAM_STAGE_BUDGET_MB")) * MB
        )
        self.baseline_rss = host_peak_rss_bytes() or 0
        self.peak_rss = self.baseline_rss
        self.staged = 0
        self.peak_staged = 0
        self.charges: Dict[str, int] = {}
        self.transfers_by_boundary: Dict[str, Dict[str, int]] = {}
        self.consumed_s = 0.0
        self._progress: Dict[str, Any] = {}
        self._lock = threading.Lock()

    # -- the ledger --------------------------------------------------------
    def charge(self, nbytes: int, what: str) -> int:
        """Account ``nbytes`` of host memory about to be allocated for
        ``what``. Raises :class:`HostBudgetExceeded` BEFORE the caller
        allocates when either bound would break; on success returns the
        new staged total."""
        t0 = time.perf_counter()
        try:
            nbytes = int(nbytes)
            with self._lock:
                if self.staged + nbytes > self.stage_limit_bytes:
                    raise HostBudgetExceeded(
                        "staged", nbytes, self.staged,
                        self.stage_limit_bytes, what,
                    )
                self._sample_rss_locked()
                # enforcement reads the CURRENT rss (what halving can
                # actually lower) against the budget over the baseline;
                # the record's within_budget claim is judged by the
                # monotone high-water mark sampled above against the same
                # bound
                cur = self._current_rss()
                if cur + nbytes > self.effective_limit_bytes:
                    raise HostBudgetExceeded(
                        "rss", nbytes, cur, self.effective_limit_bytes,
                        what,
                    )
                self.staged += nbytes
                self.peak_staged = max(self.peak_staged, self.staged)
                self.charges[what] = self.charges.get(what, 0) + nbytes
                return self.staged
        finally:
            self.consumed_s += time.perf_counter() - t0

    def release(self, nbytes: int, what: str) -> None:
        t0 = time.perf_counter()
        try:
            with self._lock:
                self.staged = max(self.staged - int(nbytes), 0)
                left = self.charges.get(what, 0) - int(nbytes)
                if left > 0:
                    self.charges[what] = left
                else:
                    self.charges.pop(what, None)
        finally:
            self.consumed_s += time.perf_counter() - t0

    def _sample_rss_locked(self) -> int:
        from scconsensus_tpu_torch.obs.device import host_peak_rss_bytes

        rss = host_peak_rss_bytes() or 0
        self.peak_rss = max(self.peak_rss, rss)
        return rss

    @staticmethod
    def _current_rss() -> int:
        from scconsensus_tpu_torch.obs.device import host_rss_bytes

        return host_rss_bytes() or 0

    def sample_rss(self) -> int:
        """Update (and return) the peak-RSS evidence — called at stage
        boundaries so the record's peak is the kernel's, not a tick
        sample's."""
        with self._lock:
            return self._sample_rss_locked()

    # -- residency feed ----------------------------------------------------
    def note_transfer(self, direction: str, nbytes: int,
                      boundary: Optional[str]) -> None:
        """Residency listener: tally declared transfer bytes per
        boundary — the evidence that staged chunks actually crossed to
        device and were dropped, not accumulated."""
        with self._lock:
            b = self.transfers_by_boundary.setdefault(
                boundary or "<undeclared>",
                {"to_device_bytes": 0, "to_host_bytes": 0},
            )
            key = ("to_host_bytes" if direction == "d2h"
                   else "to_device_bytes")
            b[key] += int(nbytes)

    # -- lifecycle ---------------------------------------------------------
    def __enter__(self) -> "HostBudgetAccountant":
        from scconsensus_tpu_torch.obs import residency
        from scconsensus_tpu_torch.stream import record as stream_record

        residency.add_transfer_listener(self.note_transfer)
        stream_record.set_active(self.live_summary)
        return self

    def __exit__(self, *exc) -> None:
        from scconsensus_tpu_torch.obs import residency
        from scconsensus_tpu_torch.stream import record as stream_record

        residency.remove_transfer_listener(self.note_transfer)
        stream_record.set_active(None)

    # -- views -------------------------------------------------------------
    def live_summary(self) -> Dict[str, Any]:
        """Compact counters for a live reader (the reference's heartbeat
        streaming panel); the runner annotates chunk progress in
        via :meth:`note_progress`."""
        with self._lock:
            out: Dict[str, Any] = {
                "staged_bytes": self.staged,
                "peak_staged_bytes": self.peak_staged,
                "peak_rss_bytes": self.peak_rss,
                "budget_bytes": self.limit_bytes,
            }
            out.update(self._progress)
            return out

    def note_progress(self, **kw: Any) -> None:
        """Runner hook: chunk counters for the live panel
        (chunks_done/chunks_planned/halvings/stage)."""
        with self._lock:
            self._progress.update(kw)

    @property
    def effective_limit_bytes(self) -> int:
        """The RSS bound: the budget over the baseline RSS."""
        return self.baseline_rss + self.limit_bytes

    def budget_fields(self) -> Dict[str, Any]:
        """The section builder's budget inputs (stream.record):
        ``limit_mb`` is the bound the peak is judged by (baseline +
        budget), ``budget_mb`` the configured budget over the baseline."""
        with self._lock:
            self._sample_rss_locked()
            return {
                "limit_mb": self.effective_limit_bytes / MB,
                "budget_mb": self.limit_bytes / MB,
                "stage_limit_mb": self.stage_limit_bytes / MB,
                "baseline_rss_mb": self.baseline_rss / MB,
                "peak_rss_mb": self.peak_rss / MB,
                "peak_staged_mb": self.peak_staged / MB,
            }
