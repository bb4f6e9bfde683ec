"""The one typed retry policy engine.

The port's copy of ``scconsensus_tpu/robust/retry.py``.
:meth:`RetryPolicy.call` runs a function under the policy:

  1. classify the exception: ``transient`` (a backend hiccup: retry as
     is), ``resource`` (an allocation failure: run the caller's
     ``degrade`` hook, then retry), ``disk`` (ENOSPC/EIO, a torn or
     checksum-failed artifact: ``degrade`` too), ``silent_corruption``
     (an integrity detection: recompute the unit with a plain retry),
     ``device_lost`` (run the caller's ``on_device_loss`` hook, then
     retry; without a hook the class is fatal, since a dead device cannot
     answer a retry), ``fatal`` (everything else: re-raise at once);
  2. respect the per-run retry budget (``SCC_ROBUST_BUDGET``);
  3. back off exponentially with deterministic jitter (seeded by the
     site name);
  4. record every attempt: a ``robust_retry`` span, a ``robust_retries``
     counter on the enclosing span and an entry in the robustness log.

The classifier keeps every signature of the reference, which are XLA's
status names, so text from either package classifies the same, and adds
what the CUDA runtime and PyTorch print: ``torch.cuda.OutOfMemoryError``
and ``CUBLAS_STATUS_ALLOC_FAILED`` are ``resource``; the sticky context
errors (an illegal memory access, an unspecified launch failure, a
device-side assert), after which no retry in the process can succeed,
and "no CUDA GPUs are available" are ``device_lost``, which the serving
driver's breaker answers with flagged degraded serving.

``robust.integrity``'s typed errors classify as ``silent_corruption``
by type. A site that keeps miscomputing past
``SCC_INTEGRITY_EVICT_THRESHOLD`` runs the caller's device-loss hook
before the recompute: ``refine()``'s stage guards pass the elastic
supervisor's ``loss_handler`` (``robust.elastic``), which shrinks the
mesh off the suspect shard; a serial run has no smaller mesh, which the
hook reports (``eviction-unavailable``), and the recompute ladder goes
on. ``KeyboardInterrupt`` and ``SystemExit`` are never caught.
"""

from __future__ import annotations

import hashlib
import sys
import time
from typing import Any, Callable, Optional

from scconsensus_tpu_torch.config import env_flag
from scconsensus_tpu_torch.robust import faults, record

__all__ = [
    "ERROR_CLASSES",
    "classify_exception",
    "classify_text",
    "RetryPolicy",
    "call",
    "default_policy",
]

ERROR_CLASSES = ("transient", "resource", "disk", "silent_corruption",
                 "device_lost", "fatal")

# Message fragments, lowercase. Matched against str(exc) / raw text; the
# XLA runtime stringifies device failures with their gRPC-style status
# names, so text is the one classification surface that works for real
# XlaRuntimeError, injected faults, and a dead worker's stderr tail alike.
_RESOURCE_PAT = (
    "resource_exhausted", "resource exhausted", "out of memory", "oom",
    "allocation fail", "failed to allocate", "memoryerror",
    "cannot allocate",
    # cuBLAS's workspace allocation failure
    "cublas_status_alloc_failed",
)
_TRANSIENT_PAT = (
    "unavailable", "deadline_exceeded", "deadline exceeded", "aborted",
    "connection reset", "connection refused", "broken pipe", "timed out",
    "transient", "socket closed", "internal: failed to connect",
)
# Disk-fault signatures (round 17, the out-of-core streaming layer):
# what the OS and the artifact layer actually say when the DISK — not the
# device, not the allocator — failed: ENOSPC/EIO strerror text, and the
# artifact/chunk checksum layer's torn-write diagnoses. Classified as
# their own class because the right adaptation is disk-shaped (sweep
# reclaimable files, shrink checkpoint granularity, quarantine-and-
# recompute the torn chunk) — neither a mesh rebuild nor an HBM degrade
# helps a full filesystem.
_DISK_PAT = (
    "enospc", "no space left on device",
    "input/output error", "disk i/o error",
    "read-only file system",
    "checksum mismatch", "torn chunk", "unparseable npz",
    "sidecar unreadable",
)
# Silent-corruption signatures (round 18, robust.integrity): the typed
# integrity errors stringify with these — and a remote worker's stderr
# tail carrying them classifies the same way. Loses only to device_lost
# (a dead chip may also miscompute on the way down, and only a mesh
# rebuild helps); wins over disk/resource/transient because the right
# retry is a RECOMPUTE of the unit, not a different write, a smaller
# shape, or an unchanged re-dispatch of the program that just proved it
# computes wrong.
_SILENT_CORRUPTION_PAT = (
    "silent corruption", "silent_corruption",
    "ghost replay mismatch", "ghost-replay mismatch",
    "integrity violation", "invariant violated",
)
# Device-loss signatures: what the XLA/PJRT runtime actually prints when
# a chip dies or is preempted mid-program, plus the JAX-level errors a
# Mesh raises once its device set no longer matches the live client
# (a preempted TPU slice re-enumerates with fresh device objects).
_DEVICE_LOST_PAT = (
    "device lost", "device is lost", "device was lost",
    "device preempted", "preemption", "worker preempted",
    # NOTE deliberately absent: "halted by previous error" — XLA emits it
    # as follow-on noise after ANY prior failure (an OOM's aftermath most
    # commonly), and classifying it device_lost would trigger the
    # exactly-wrong adaptation (shrink the mesh instead of degrade)
    "device not found", "no such device", "device has been removed",
    "chip is unhealthy", "device unhealthy",
    "data_loss", "failed_precondition: device",
    "failed precondition: device",
    "device assignment", "mesh should contain", "mismatched devices",
    "not addressable",
    # the CUDA runtime's sticky context errors (every later call in the
    # process fails) and a process that sees no card at all
    "illegal memory access", "unspecified launch failure",
    "device-side assert triggered", "no cuda gpus are available",
)


def classify_text(text: Optional[str]) -> Optional[str]:
    """'device_lost' | 'silent_corruption' | 'disk' | 'resource' |
    'transient' | None (no signature recognized) for raw text — stderr
    tails, TUNNEL_LOG probe errors, heartbeat post-mortems. Device-loss
    wins over everything (a dead chip often also prints UNAVAILABLE,
    and only a mesh rebuild helps); silent_corruption wins over
    disk/resource/transient (an integrity detection names the wrongness
    of the ANSWER — recompute-the-unit is the only retry that can fix
    it); disk wins over resource/transient (an ENOSPC strerror also
    says "error", and retrying a full filesystem unchanged loops);
    resource wins over transient (degrading is the safer adaptation — a
    transient retry of a genuinely too-big shape loops)."""
    if not text:
        return None
    low = str(text).lower()
    if any(p in low for p in _DEVICE_LOST_PAT):
        return "device_lost"
    if any(p in low for p in _SILENT_CORRUPTION_PAT):
        return "silent_corruption"
    if any(p in low for p in _DISK_PAT):
        return "disk"
    if any(p in low for p in _RESOURCE_PAT):
        return "resource"
    if any(p in low for p in _TRANSIENT_PAT):
        return "transient"
    return None


def classify_exception(exc: BaseException) -> str:
    """Error class of an exception: type first (MemoryError, the CUDA
    allocator's OutOfMemoryError, the injected fault types, OSError errno
    for the disk family), then message text, else fatal."""
    from scconsensus_tpu_torch.robust import integrity as _integrity

    # the typed integrity errors classify before their message is read
    if isinstance(exc, _integrity.IntegrityError):
        return "silent_corruption"
    if isinstance(exc, faults.InjectedDeviceLoss):
        return "device_lost"
    if isinstance(exc, faults.InjectedDiskFault):
        return "disk"
    if isinstance(exc, (MemoryError, faults.InjectedResourceExhausted)):
        return "resource"
    cuda_oom = getattr(getattr(sys.modules.get("torch"), "cuda", None),
                       "OutOfMemoryError", None)
    if cuda_oom is not None and isinstance(exc, cuda_oom):
        return "resource"
    if isinstance(exc, faults.InjectedTransientError):
        return "transient"
    if isinstance(exc, OSError) and getattr(exc, "errno", None) in (
            28, 5, 30):  # ENOSPC, EIO, EROFS — the disk family by number
        return "disk"
    if isinstance(exc, (ConnectionError, TimeoutError)):
        return "transient"
    return classify_text(f"{type(exc).__name__}: {exc}") or "fatal"


def _jitter(site: str, attempt: int) -> float:
    """Deterministic jitter fraction in [0, 1): hash-derived so retry
    timing reproduces run-to-run (no Date/random dependence)."""
    h = hashlib.sha256(f"{site}:{attempt}".encode()).digest()
    return int.from_bytes(h[:4], "big") / 2**32


class RetryPolicy:
    """Retry policy for one call site family.

    ``max_attempts`` counts the first try (3 = up to 2 retries);
    ``backoff_base`` defaults to ``SCC_ROBUST_BACKOFF_S``. The per-run
    budget is shared across every policy instance (record.RunLog), so a
    pathological run cannot multiply site-level retries without bound.
    """

    def __init__(self, max_attempts: int = 3,
                 backoff_base: Optional[float] = None,
                 backoff_cap: float = 30.0):
        self.max_attempts = int(max_attempts)
        self.backoff_base = (
            float(env_flag("SCC_ROBUST_BACKOFF_S"))
            if backoff_base is None else float(backoff_base)
        )
        self.backoff_cap = float(backoff_cap)

    def backoff_s(self, site: str, attempt: int) -> float:
        """Backoff before retry ``attempt`` (1-based): exponential with
        +0-50% deterministic jitter."""
        base = min(self.backoff_base * 2 ** (attempt - 1), self.backoff_cap)
        return base * (1.0 + 0.5 * _jitter(site, attempt))

    def call(self, fn: Callable[[], Any], site: str,
             degrade: Optional[Callable[[int], Any]] = None,
             classify: Callable[[BaseException], str] = classify_exception,
             on_device_loss: Optional[Callable[[int], Any]] = None,
             ) -> Any:
        """Run ``fn`` under this policy. ``degrade(attempt)`` runs before
        a resource-class retry (evict caches, halve a chunk ladder —
        whatever makes the retry *different*); ``on_device_loss(attempt)``
        runs before a device_lost-class retry (rebuild the mesh on
        surviving devices — robust.elastic wires the supervisor in here;
        without the hook device_lost is FATAL, since re-running the same
        program against a dead mesh can only fail again); a fault plan's
        injection for ``site`` fires at each attempt's entry, so an
        injected fault is recovered by the very machinery it tests."""
        from scconsensus_tpu_torch.obs import trace as obs_trace

        run = record.current_run()
        attempt = 1
        backoff_total = 0.0
        while True:
            try:
                faults.fault_point(site)
                out = fn()
                if attempt > 1:
                    record.note_retry(site, err_class, attempt,
                                      recovered=True,
                                      backoff_s=backoff_total)
                    if err_class == "silent_corruption":
                        # the corrupted unit was recomputed clean: the
                        # integrity section's recovery evidence
                        from scconsensus_tpu_torch.robust import (
                            integrity as _integrity,
                        )

                        _integrity.current().note_recompute()
                        _integrity.current().reset_streak(site)
                return out
            except Exception as e:
                err_class = classify(e)
                if err_class == "fatal" or (
                    err_class == "device_lost" and on_device_loss is None
                ):
                    raise
                if attempt >= self.max_attempts or not run.budget_take():
                    record.note_retry(site, err_class, attempt,
                                      recovered=False,
                                      backoff_s=backoff_total)
                    raise
                backoff = self.backoff_s(site, attempt)
                backoff_total += backoff
                # the attempt as a span event + counter: visible in the
                # span tree, Chrome traces, and the heartbeat stream
                sp = obs_trace.current_span()
                if sp is not None:
                    sp.metrics.counter("robust_retries").add(1)
                with obs_trace.span(
                    "robust_retry", site=site, error_class=err_class,
                    attempt=attempt, backoff_s=round(backoff, 4),
                ):
                    if err_class == "device_lost":
                        # the adaptation IS the recovery here: shrink the
                        # mesh onto survivors before re-entering the stage
                        on_device_loss(attempt)
                    elif err_class == "silent_corruption":
                        # recompute-the-unit: a plain retry, unless the
                        # site keeps miscomputing: past the eviction
                        # threshold the device-loss hook runs, so a device
                        # that computes wrong is treated like one that died
                        from scconsensus_tpu_torch.robust import (
                            integrity as _integrity,
                        )

                        # the streak is keyed on the detection's own site
                        # (the ladder bucket, the serving device call),
                        # which a propagated error carries
                        det_site = getattr(e, "site", "") or site
                        if (on_device_loss is not None
                                and _integrity.should_evict(det_site)):
                            _integrity.current().reset_streak(det_site)
                            try:
                                on_device_loss(attempt)
                                record.note_degradation(
                                    det_site,
                                    "evict-miscomputing-device",
                                    "repeated silent-corruption "
                                    "detections — mesh shrunk off the "
                                    "suspect chip before the recompute",
                                )
                            except Exception:
                                # nothing smaller to move to: the bounded
                                # recompute ladder is the best remaining
                                # move, so keep retrying
                                record.note_degradation(
                                    det_site, "eviction-unavailable",
                                    "repeated silent-corruption "
                                    "detections but no smaller mesh to "
                                    "shrink to; continuing recompute "
                                    "attempts",
                                )
                    elif degrade is not None and err_class in ("resource",
                                                               "disk"):
                        # both classes demand a DIFFERENT retry: resource
                        # frees memory, disk frees/shrinks what it writes
                        # (sweep reclaimable files, coarsen checkpoint
                        # granularity) — the caller's hook knows which
                        degrade(attempt)
                    time.sleep(backoff)
                attempt += 1


_DEFAULT: Optional[RetryPolicy] = None


def default_policy() -> RetryPolicy:
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = RetryPolicy()
    return _DEFAULT


def call(fn: Callable[[], Any], site: str,
         degrade: Optional[Callable[[int], Any]] = None,
         policy: Optional[RetryPolicy] = None,
         on_device_loss: Optional[Callable[[int], Any]] = None) -> Any:
    """Module-level convenience: ``robust.call(fn, site=...)`` under the
    default policy."""
    return (policy or default_policy()).call(
        fn, site, degrade=degrade, on_device_loss=on_device_loss
    )
