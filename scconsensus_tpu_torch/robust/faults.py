"""Deterministic fault injection at named sites (``SCC_FAULT_PLAN``).

The port's copy of ``scconsensus_tpu/robust/faults.py``. A fault plan is
a JSON file::

    {"seed": 1,
     "faults": [
       {"site": "stage:embed", "class": "oom",       "times": 1},
       {"site": "wilcox_bucket", "class": "transient", "after": 2},
       {"site": "stage:cuts",  "class": "kill"},
       {"site": "artifact:tree", "class": "corrupt", "mode": "truncate"},
       {"site": "wilcox_bucket_out", "class": "corruption"}
     ]}

Each rule fires on hits ``after <= n < after + times`` of its site
(0-based; ``after`` defaults to 0, ``times`` to 1), so a test can assert
exact recovery behaviour. The sites the port has: ``refine()``'s stage
boundaries (``stage:de``, ``stage:union``, ``stage:embed``,
``stage:tree``, ``stage:cuts``, ``stage:silhouette``, ``stage:nodg``), the
DE ladder's buckets (``wilcox_bucket``), the matrix upload
(``input_staging``), the serving driver's ``serve_load`` (model load),
``serve_batch`` (micro-batch assembly) and ``serve_device`` (inside the
device classify call), the out-of-core streaming layer's three
disk-axis sites (``stream_chunk_write``: each chunk and per-chunk
checkpoint write, where ``kill`` plans prove mid-ingest durability and
``disk`` plans the ENOSPC ladder; ``stream_chunk_read``: each chunk load;
``stream_stage``: the streaming runner's stage boundary), artifact writes
(``artifact:<stage>``, consumed by :func:`corrupt_artifact` after the
store's atomic replace; a torn chunk rides ``artifact:stream_chunk``),
the in-computation corruption sites consumed by :func:`corrupt_value`
(``wilcox_bucket_out``, ``embed_scores``, ``bh_logq``,
``landmark_assign``, ``stream_block``, ``contingency_table``,
``serve_classify``), the mesh engines' sites (``sharded:aggregates``,
``sharded:ranksum``, ``ring:distance_sums`` and the fused step's
``refine_step``), the serving fleet's ``wire_request`` (the wire front's
classify handler, before admission), ``fleet_route`` (the pool's
admission) and ``fleet_swap`` (the start of a hot-swap), and any site a
caller names to ``robust.retry.call``.

A plan naming a ``corruption`` rule at a site that is not one of the
in-computation corruption sites raises ``ValueError`` when it is read, so
a chaos run cannot pass by corrupting nowhere. Neither package corrupts
values at such a site; the reference runs that plan as a no-op.

Fault classes and what they do at a compute site:

  oom        raise :class:`InjectedResourceExhausted` (its message carries
             ``RESOURCE_EXHAUSTED``, the reference's allocation failure)
  transient  raise :class:`InjectedTransientError` (``UNAVAILABLE``)
  device_loss
             raise :class:`InjectedDeviceLoss` (``device lost``)
  kill       SIGKILL the process: no handler runs
  stall      sleep ``stall_s`` (default 1.0) without raising
  corrupt    no-op at compute sites; at ``artifact:<stage>`` the store
             calls :func:`corrupt_artifact` after a write, which
             truncates or bit-flips the file on disk
  disk       raise :class:`InjectedDiskFault` (``No space left on
             device``)
  corruption no-op at :func:`fault_point`; consumed by
             :func:`corrupt_value` at the in-computation sites: a
             deterministic perturbation of freshly computed values
             (scale, sign flip of the largest entry, index shift), the
             reference's, so both packages corrupt the same positions.
             ``robust.integrity`` must detect each one and recompute
             the unit. A rule with ``"device": D`` only fires while
             shard D is in the caller's live mesh: a device that
             computes wrong until the elastic supervisor evicts it.

With ``SCC_FAULT_PLAN`` unset every entry point is one registry lookup.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

from scconsensus_tpu_torch.config import env_flag

__all__ = [
    "FAULT_CLASSES",
    "InjectedFault",
    "InjectedResourceExhausted",
    "InjectedTransientError",
    "InjectedDeviceLoss",
    "InjectedDiskFault",
    "fault_point",
    "corrupt_artifact",
    "corrupt_value",
    "active",
    "reset",
]

FAULT_CLASSES = ("oom", "transient", "kill", "stall", "corrupt",
                 "device_loss", "disk", "corruption")


class InjectedFault(Exception):
    """Base of every plan-injected exception (so tests can catch the
    family while the classifier sees only the message text, exactly as
    it would for the real error)."""


class InjectedResourceExhausted(InjectedFault):
    """Mimics an XLA device allocation failure."""


class InjectedTransientError(InjectedFault):
    """Mimics a transient backend/RPC error."""


class InjectedDeviceLoss(InjectedFault):
    """Mimics a lost/preempted accelerator device (the XLA runtime
    stringifies these as FAILED_PRECONDITION/INTERNAL errors naming the
    device)."""


class InjectedDiskFault(InjectedFault):
    """Mimics a disk fault (ENOSPC by default — the message carries the
    exact ``No space left on device`` strerror text a real full
    filesystem raises, so the classifier sees what the OS would say).
    The out-of-core streaming layer's test vector (stream.store)."""


# the in-computation corruption sites, the reference's seven
# (scconsensus_tpu/robust/faults.py:67-71)
_VALUE_SITES = ("wilcox_bucket_out", "embed_scores", "bh_logq",
                "landmark_assign", "stream_block", "contingency_table",
                "serve_classify")


def _check_site(path: str, i: int, rule: Dict[str, Any]) -> None:
    """Refuse a ``corruption`` rule at a site with no value hook. Neither
    package corrupts values there: the reference skips such a rule in
    ``fault_point`` and never reads it in ``corrupt_value``, so its chaos
    run would pass without the fault. The port refuses the plan as
    malformed, with the reference loader's ``ValueError`` (a stated
    difference: the reference runs it as a no-op)."""
    site = str(rule["site"])
    if rule["class"] == "corruption" and site not in _VALUE_SITES:
        raise ValueError(
            f"SCC_FAULT_PLAN {path!r}: faults[{i}] is a 'corruption' rule "
            f"at site {site!r}, where neither package corrupts a value "
            "(the reference would run it as a no-op); the corruption "
            f"sites are {', '.join(_VALUE_SITES)}"
        )


# plan cache: (path, mtime) -> parsed plan; hit counters reset on reload
_LOADED: Optional[Dict[str, Any]] = None
_LOADED_KEY: Optional[tuple] = None
_HITS: Dict[int, int] = {}


def reset() -> None:
    """Drop the cached plan + hit counters (tests switch plans in-process)."""
    global _LOADED, _LOADED_KEY
    _LOADED = None
    _LOADED_KEY = None
    _HITS.clear()


def _plan() -> Optional[Dict[str, Any]]:
    global _LOADED, _LOADED_KEY
    path = env_flag("SCC_FAULT_PLAN")
    if not path:
        if _LOADED is not None:
            reset()
        return None
    try:
        key = (path, os.path.getmtime(path))
    except OSError:
        return None
    if key != _LOADED_KEY:
        try:
            with open(path) as f:
                plan = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            # a malformed plan must be loud: silently running WITHOUT the
            # requested faults would let a chaos run pass vacuously
            raise ValueError(f"SCC_FAULT_PLAN {path!r} unreadable: {e}")
        faults = plan.get("faults")
        if not isinstance(faults, list):
            raise ValueError(
                f"SCC_FAULT_PLAN {path!r}: 'faults' must be a list"
            )
        for i, r in enumerate(faults):
            if r.get("class") not in FAULT_CLASSES:
                raise ValueError(
                    f"SCC_FAULT_PLAN {path!r}: faults[{i}].class must be "
                    f"one of {FAULT_CLASSES}, got {r.get('class')!r}"
                )
            if not r.get("site"):
                raise ValueError(
                    f"SCC_FAULT_PLAN {path!r}: faults[{i}] missing site"
                )
            _check_site(path, i, r)
        _LOADED = plan
        _LOADED_KEY = key
        _HITS.clear()
    return _LOADED


def active() -> bool:
    """True iff a fault plan is loaded for this process."""
    return _plan() is not None


def _matches(site: str) -> List[tuple]:
    plan = _plan()
    if plan is None:
        return []
    out = []
    for i, rule in enumerate(plan.get("faults", ())):
        if rule.get("site") == site:
            out.append((i, rule))
    return out


def _fire(idx: int, rule: Dict[str, Any]) -> bool:
    """Advance the rule's hit counter; True when this hit is in the
    rule's firing window."""
    n = _HITS.get(idx, 0)
    _HITS[idx] = n + 1
    after = int(rule.get("after", 0))
    times = int(rule.get("times", 1))
    return after <= n < after + times


def fault_point(site: str) -> None:
    """The injection hook compute code calls at a named site. No plan ->
    immediate return. A firing rule acts per its class (see module doc);
    every injection is recorded on the run's robustness log BEFORE the
    action, so even a SIGKILL leaves the fault attributable (the partial
    flight record carries the log's live summary)."""
    rules = [(i, r) for i, r in _matches(site)
             if r.get("class") != "corruption"]
    # "corruption" rules are excluded BEFORE the counters advance: they
    # are consumed (and counted) by corrupt_value at the value sites, so
    # a site carrying both hooks cannot double-advance their windows
    if not rules:
        return
    from scconsensus_tpu_torch.robust import record as _record

    # advance EVERY matching rule's hit counter before acting: a firing
    # rule raises, and skipping the siblings' bookkeeping would desync
    # their windows (hit counts must mean "times this site was reached",
    # independent of which rule acted)
    firing = [(idx, rule) for idx, rule in rules if _fire(idx, rule)]
    for idx, rule in firing[:1]:  # at most one action per visit
        fclass = rule["class"]
        _record.note_fault(site, fclass, seq=_HITS[idx] - 1)
        if fclass == "oom":
            raise InjectedResourceExhausted(
                f"RESOURCE_EXHAUSTED: injected device allocation failure "
                f"at {site} (SCC_FAULT_PLAN)"
            )
        if fclass == "transient":
            raise InjectedTransientError(
                f"UNAVAILABLE: injected transient backend error at {site} "
                "(SCC_FAULT_PLAN)"
            )
        if fclass == "device_loss":
            raise InjectedDeviceLoss(
                f"FAILED_PRECONDITION: device lost: injected device "
                f"preemption at {site} (SCC_FAULT_PLAN)"
            )
        if fclass == "disk":
            raise InjectedDiskFault(
                f"ENOSPC: No space left on device: injected disk fault "
                f"at {site} (SCC_FAULT_PLAN)"
            )
        if fclass == "kill":
            import signal

            os.kill(os.getpid(), signal.SIGKILL)
        if fclass == "stall":
            time.sleep(float(rule.get("stall_s", 1.0)))
        # "corrupt" rules are inert at compute sites (corrupt_artifact
        # consumes them at artifact:<stage> sites)


def corrupt_artifact(stage: str, path: str) -> bool:
    """Apply any ``artifact:<stage>`` corrupt rule to a just-written
    artifact file — called by the ArtifactStore AFTER its atomic replace,
    so the corruption models a post-write disk/transport fault that the
    load-time checksum must catch. ``mode``: 'truncate' (default — cut
    the file to 60%) or 'flip' (xor one mid-file byte). Returns True when
    a corruption was applied."""
    applied = False
    for idx, rule in _matches(f"artifact:{stage}"):
        if rule["class"] != "corrupt" or not _fire(idx, rule):
            continue
        from scconsensus_tpu_torch.robust import record as _record

        _record.note_fault(f"artifact:{stage}", "corrupt",
                           seq=_HITS[idx] - 1)
        try:
            size = os.path.getsize(path)
            mode = rule.get("mode", "truncate")
            if mode == "flip" and size:
                with open(path, "r+b") as f:
                    f.seek(size // 2)
                    b = f.read(1)
                    f.seek(size // 2)
                    f.write(bytes([b[0] ^ 0xFF]) if b else b"\xff")
            else:
                with open(path, "r+b") as f:
                    f.truncate(max(1, int(size * 0.6)))
            applied = True
        except OSError:
            pass
    return applied


def _perturb_one(x, mode: str, factor: float):
    """One array perturbed per ``mode``; a tensor stays on its device, a
    numpy array on the host. Modes:

      scale     multiply every element by ``factor`` (float arrays);
      signflip  flip the sign of the max-|x| finite element;
      shift     integer arrays: (x + 1) mod (max + 1), every index wrong
                by one with occupancy totals conserved.
    """
    import numpy as _np

    if not isinstance(x, _np.ndarray):
        import torch

        if mode == "shift" or not torch.is_floating_point(x):
            k = torch.clamp(torch.max(x) + 1, min=1)
            return ((x + 1) % k).to(x.dtype)
        if mode == "scale":
            return x * factor
        flat = x.reshape(-1).clone()
        mag = torch.where(torch.isfinite(flat), flat.abs(),
                          torch.full_like(flat, -float("inf")))
        idx = torch.argmax(mag)
        flat[idx] = -flat[idx]
        return flat.reshape(x.shape)
    if mode == "shift" or not _np.issubdtype(x.dtype, _np.floating):
        k = _np.max(x) + 1
        return ((x + 1) % _np.maximum(k, 1)).astype(x.dtype)
    if mode == "scale":
        return x * _np.asarray(factor, dtype=x.dtype)
    flat = _np.ravel(x).copy()
    mag = _np.where(_np.isfinite(flat), _np.abs(flat), -_np.inf)
    idx = _np.argmax(mag)
    flat[idx] = -flat[idx]
    return flat.reshape(x.shape)


def corrupt_value(site: str, value, live_devices=None):
    """Apply any ``corruption``-class rule at an in-computation ``site``
    to freshly computed values. ``value`` is one array (numpy or tensor)
    or a tuple of them; the first is perturbed (rule key ``"index"``
    picks another). Returns the same structure.

    ``live_devices``: the caller's current mesh shard ids. A rule
    carrying ``"device": D`` fires only while D is live, so an evicted
    device stops corrupting; rules without a pin always fire in their
    window. No plan: one registry lookup and return."""
    rules = [(i, r) for i, r in _matches(site)
             if r.get("class") == "corruption"]
    if not rules:
        return value
    from scconsensus_tpu_torch.robust import record as _record

    firing = [(idx, rule) for idx, rule in rules if _fire(idx, rule)]

    def _live(rule) -> bool:
        dev = rule.get("device")
        return (dev is None or live_devices is None
                or int(dev) in [int(d) for d in live_devices])

    # the liveness gate filters before one rule is picked: a rule pinned
    # to an evicted device goes clean without masking an unpinned rule
    for idx, rule in [fr for fr in firing if _live(fr[1])][:1]:
        _record.note_fault(site, "corruption", seq=_HITS[idx] - 1)
        mode = rule.get("mode", "scale")
        factor = float(rule.get("factor", 1.5))
        if isinstance(value, tuple):
            i = int(rule.get("index", 0))
            return tuple(
                _perturb_one(v, mode, factor) if k == i else v
                for k, v in enumerate(value)
            )
        return _perturb_one(value, mode, factor)
    return value
