"""Host→device upload cache for large immutable inputs.

The port's copy of ``scconsensus_tpu/utils/devcache.py``. The engines
treat the (G, N) expression matrix as immutable, so re-running a stage
over the same host array (the cold-then-steady benchmark pattern, a
resumed pipeline re-entering the DE stage, the workload runs over one
matrix) can reuse the device buffer instead of crossing the link again.

Entries are keyed by the host array's identity and the device, and die
with the array (a weakref finalizer), so the cache can never outlive or
alias its host array. A hit is also guarded by a content sentinel: a
strided sample's sha256 (with the shape and dtype) and the insert-time
float64 full sum, so a caller that mutates the cached array in place gets
a miss and a fresh upload, not stale device data. The full-sum pass runs
at insert time and on every hit (arming it lazily at the first hit would
bake a mutation made between insert and first hit into the baseline).

On the CPU ``torch.from_numpy`` aliases the host buffer, so the cached
tensor keeps its host array alive and the finalizer never fires; the cap
of 2 entries (FIFO) keeps that retention finite, as it keeps the pinned
device memory finite on the card. An upload runs under the
``input_staging`` residency boundary and ``RetryPolicy(max_attempts=2)``:
an allocation failure clears the cache, hands the caching allocator's
blocks back to the card and uploads once more (``evict-devcache``).

Where the port differs: the reference keys by identity alone (one JAX
default device); here the key also names the device, so a card run and a
CPU run over one host array hold one entry each. An upload gives what
``jnp.asarray`` gives under JAX's 32-bit default: 64-bit floats and
integers become 32-bit.
"""

from __future__ import annotations

import hashlib
import weakref
from typing import Dict, Tuple

import numpy as np
import torch

__all__ = ["device_put_cached", "clear_cache"]


def clear_cache() -> None:
    """Drop every cached device buffer (the resource-degradation hook: an
    OOM elsewhere in the pipeline frees the cache's memory first)."""
    _cache.clear()


class _Entry:
    __slots__ = ("ref", "sample", "full_sum", "buf")

    def __init__(self, ref, sample: bytes, full_sum: float, buf):
        self.ref = ref
        self.sample = sample
        self.full_sum = full_sum  # insert-time baseline (module docstring)
        self.buf = buf


_cache: Dict[Tuple[int, str], _Entry] = {}
_SENTINEL_SAMPLES = 4096
_MAX_ENTRIES = 2
# hits and misses since the last reset_stats(): what a caller prints to
# show a run reused its upload
STATS = {"hits": 0, "misses": 0}

# JAX's 32-bit default: the dtype jnp.asarray gives a host array
_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
           np.dtype(np.uint64): np.uint32,
           np.dtype(np.complex128): np.complex64}


def reset_stats() -> None:
    STATS.update(hits=0, misses=0)


def _sample_hash(x: np.ndarray) -> bytes:
    """Cheap fingerprint: shape/dtype + a strided element sample."""
    flat = x.reshape(-1)
    step = max(1, flat.size // _SENTINEL_SAMPLES)
    sample = np.ascontiguousarray(flat[::step])
    h = hashlib.sha256()
    h.update(str((x.shape, x.dtype.str)).encode())
    h.update(sample.tobytes())
    return h.digest()


def _full_sum(x: np.ndarray) -> float:
    """One memory-bandwidth pass; catches partial in-place edits the
    strided sample misses (e.g. zeroing one gene row)."""
    return float(np.sum(x.reshape(-1), dtype=np.float64))


def _upload(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    host = np.ascontiguousarray(x, dtype=_NARROW.get(x.dtype, x.dtype))
    return torch.from_numpy(host).to(dev)


def device_put_cached(x, device):
    """``x`` on ``device``, memoized on the identity and content sentinel
    of the host array ``x``. A tensor already on ``device`` is returned
    as it is.

    Only worthwhile for large arrays; small ones should be uploaded
    directly (this path pays a dict lookup, a sample hash and a full
    sum)."""
    from scconsensus_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if isinstance(x, torch.Tensor):
        return x.to(dev)  # ``x`` itself when it is already there
    x = x if isinstance(x, np.ndarray) else np.asarray(x)

    from scconsensus_tpu_torch.obs.residency import boundary

    key = (id(x), str(dev))
    sample = _sample_hash(x)
    ent = _cache.get(key)
    if ent is not None:
        host = ent.ref()
        if host is x and ent.sample == sample:
            cur = _full_sum(x)
            # NaN-bearing matrices: NaN == NaN is False, which would evict
            # and re-upload on every call; NaN baselines count as equal
            # (the strided sample still guards those entries)
            same = (ent.full_sum == cur) or (
                np.isnan(ent.full_sum) and np.isnan(cur))
            if same:
                STATS["hits"] += 1
                return ent.buf
        _cache.pop(key, None)  # freed id reused, or mutated in place
    STATS["misses"] += 1
    with boundary("input_staging"):  # THE intended matrix upload
        # an allocation failure: drop every cached buffer, hand the
        # allocator's blocks back and upload once more, through the
        # central retry policy; any upload failure is classified
        # "resource" here, as in the reference
        from scconsensus_tpu_torch.de.engine import free_device_cache
        from scconsensus_tpu_torch.robust import record as _rb_record
        from scconsensus_tpu_torch.robust.retry import RetryPolicy

        def _evict(_attempt):
            _cache.clear()
            free_device_cache(dev)
            _rb_record.note_degradation(
                "input_staging", "evict-devcache",
                "dropped every pinned device buffer before re-upload",
            )

        buf = RetryPolicy(max_attempts=2).call(
            lambda: _upload(x, dev), site="input_staging",
            degrade=_evict, classify=lambda _e: "resource",
        )
    try:
        ref = weakref.ref(
            x, lambda _r, _k=key, _c=_cache: _c.pop(_k, None))
    except TypeError:
        return buf  # not weakref-able: upload, do not cache
    while len(_cache) >= _MAX_ENTRIES:  # FIFO eviction (dicts keep order)
        _cache.pop(next(iter(_cache)))
    _cache[key] = _Entry(ref, sample, _full_sum(x), buf)
    return buf
