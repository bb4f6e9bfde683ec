"""Typed serving errors: the online path's whole failure vocabulary.

The port's copy of ``scconsensus_tpu/serve/errors.py`` (stdlib only). A
request that fails fails with a type the client can branch on: a
``QueueFull`` is retryable after ``retry_after_s``, a ``ModelLoadError``
is not retryable until the artifact is replaced, and the serving stats
account for every one of them.
"""

from __future__ import annotations

__all__ = [
    "ServeError",
    "ModelLoadError",
    "RequestInvalid",
    "QueueFull",
    "DeadlineExceeded",
    "ServerClosed",
    "RequestFailed",
]


class ServeError(Exception):
    """Base of every typed serving failure."""


class ModelLoadError(ServeError):
    """The frozen consensus-model artifact could not be loaded: missing,
    wrong schema/version, incoherent shapes, or corrupt (in which case the
    store has already QUARANTINED the files — ``quarantined`` says so).
    A server must refuse to start on this; serving garbage labels is the
    one failure mode worse than downtime."""

    def __init__(self, msg: str, quarantined: bool = False):
        super().__init__(msg)
        self.quarantined = bool(quarantined)


class RequestInvalid(ServeError, ValueError):
    """The request is malformed (wrong gene dimension, empty, non-finite
    cells, oversized) — rejected at admission, never enqueued."""


class QueueFull(ServeError):
    """Bounded-admission backpressure: the queue is at capacity, the
    request was NOT enqueued, and the client should retry after
    ``retry_after_s`` — the explicit alternative to unbounded growth."""

    def __init__(self, depth: int, capacity: int, retry_after_s: float):
        super().__init__(
            f"admission queue full ({depth}/{capacity}); "
            f"retry after {retry_after_s:.3f}s"
        )
        self.depth = int(depth)
        self.capacity = int(capacity)
        self.retry_after_s = float(retry_after_s)


class DeadlineExceeded(ServeError):
    """The request's deadline passed before a result could be returned
    (queue wait or compute overran it). The typed promise: late answers
    are an error, never a silently stale success."""

    def __init__(self, msg: str, late_by_s: float = 0.0):
        super().__init__(msg)
        self.late_by_s = float(late_by_s)


class ServerClosed(ServeError):
    """submit() after stop(): the driver is draining or gone."""


class RequestFailed(ServeError):
    """A fatal (non-retryable, non-degradable) error killed this request's
    batch — carries the underlying class/message for the client log."""

    def __init__(self, msg: str, error_class: str = "fatal"):
        super().__init__(msg)
        self.error_class = str(error_class)
