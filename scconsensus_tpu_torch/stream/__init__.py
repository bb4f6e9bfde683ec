"""Out-of-core streaming execution: the port of ``scconsensus_tpu/stream``.

Disk-resident chunked CSR input (:class:`~scconsensus_tpu_torch.stream.
store.ChunkedCSRStore`), a hard host-memory budget
(:class:`~scconsensus_tpu_torch.stream.budget.HostBudgetAccountant`) and
a per-shard refine pipeline (:func:`~scconsensus_tpu_torch.stream.runner.
streaming_refine`) whose every stage works chunk at a time with durable,
checksummed progress: a SIGKILL mid-run resumes from the last fsynced
chunk to byte-identical labels, a torn chunk quarantines and recomputes,
ENOSPC coarsens the checkpoints before failing typed, and a budget
breach halves the streaming window.

This ``__init__`` re-exports lazily, as the reference's does, so
``stream.record`` loads without the compute stack.
"""

from __future__ import annotations

__all__ = [
    "ChunkedCSRStore",
    "ChunkCorrupt",
    "HostBudgetAccountant",
    "HostBudgetExceeded",
    "streaming_refine",
    "validate_streaming",
]


def __getattr__(name):
    if name in ("ChunkedCSRStore", "ChunkCorrupt"):
        from scconsensus_tpu_torch.stream import store as _m

        return getattr(_m, name)
    if name in ("HostBudgetAccountant", "HostBudgetExceeded"):
        from scconsensus_tpu_torch.stream import budget as _m

        return getattr(_m, name)
    if name == "streaming_refine":
        from scconsensus_tpu_torch.stream.runner import streaming_refine

        return streaming_refine
    if name == "validate_streaming":
        from scconsensus_tpu_torch.stream.record import validate_streaming

        return validate_streaming
    raise AttributeError(name)
