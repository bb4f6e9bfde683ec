"""Span-attributed host↔device residency auditor.

The port's form of ``scconsensus_tpu/obs/residency.py``, in three modes
via the registered ``SCC_OBS_RESIDENCY`` flag:

  * ``off`` — zero-overhead no-op (the auditor context degrades to a
    passthrough).
  * ``audit`` — every crossing the auditor can see is recorded with
    direction, nbytes, the owning tracer span, the outermost open
    *stage* span, the innermost declared boundary (or None), and the
    first source line outside the auditor, torch, numpy and the stdlib's
    context machinery. Aggregates land on the run record's validated
    ``residency`` section.
  * ``enforce`` — a crossing that matches no declared boundary raises
    :class:`ResidencyError` naming the offending span and source line.

**How crossings are seen.** A torch program crosses between host and
card only through explicit calls, so for the auditor's scope the crossing
hook patches the entry points the port's code calls, and restores them on
exit:

  * ``Tensor.cpu``, ``Tensor.cuda`` and ``Tensor.to`` (a copy whose
    output lies on the other side of the line), ``Tensor.copy_`` across
    the line;
  * ``Tensor.item``, ``.tolist``, ``.numpy``, ``__bool__``, ``__int__``
    and ``__float__`` of a tensor on the device side (the last three are
    the implicit forms: ``if t.any():``, ``int(t.sum())``, ``float(t)``;
    ``np.asarray(t)`` reaches ``.numpy()``);
  * ``torch.as_tensor`` and ``torch.tensor`` of a numpy array (or of a
    tensor on the other side), and ``torch.from_numpy`` when the host's
    own tensors count as the device side (below).

The patches were chosen over a ``torch.overrides.TorchFunctionMode``,
which sees every torch call but pays a Python dispatch on each of them:
the patches cost a wrapper call on the patched methods alone. A method
that delegates to another patched one (``Tensor.__array__`` →
``.numpy()``) is counted once, at the outer call.

**Which side is the device.** ``device_types`` names the tensor device
types that count as the device (default ``("cuda",)``); host memory is
numpy, Python objects and tensors of any other type. ``refine()`` passes
the run's own device type, so a CPU run audits the same sites as a card
run: there the run's CPU tensors stand for the device, and ``.numpy()``,
``.item()`` or ``bool()`` of one is the crossing the card run makes with
``.cpu()`` or ``.item()``.

**Implicit syncs.** Boolean-mask indexing, ``nonzero`` and ``unique``
copy a size to the host inside one C call, which no Python entry point
shows. On the card the auditor arms ``torch.cuda.set_sync_debug_mode
("warn")`` for its scope and counts each synchronizing operation that
none of the patched calls made, per stage span (span metrics
``implicit_syncs`` and ``implicit_sync:<file>:<line>``) and per stage and
source line (:attr:`ResidencyAuditor.implicit_syncs`); enforce mode does
not turn them into errors.

**Enforcement policy.** Device→host: ANY unallowlisted fetch raises,
regardless of size. Host→device is the normal feed direction, so only a
single transfer ≥ ``enforce_h2d_bytes`` (default 1 MiB) outside a
boundary raises; smaller staging is recorded, not fatal.

**Boundaries.** :data:`BOUNDARIES` is the reference's declared allowlist
of intentional crossings, each with its justification. Code declares a
crossing with ``with residency.boundary("name"):`` — unknown names raise
immediately. Crossings whose source resolves inside ``obs/``
auto-attribute to ``obs_internal`` when no explicit boundary is open.

**Listeners.** ``add_transfer_listener(fn)`` registers
``fn(direction, nbytes, boundary)`` for every recorded event (the
streaming budget accountant). With no auditor active, code that makes a
declared crossing on the card calls :func:`note_transfer`, which feeds
the listeners directly; under an auditor the hook sees the same copy and
a note is dropped, so nothing counts twice.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Sequence, Tuple

from scconsensus_tpu_torch.config import env_flag

__all__ = [
    "MODES",
    "BOUNDARIES",
    "ResidencyError",
    "ResidencyAuditor",
    "mode",
    "boundary",
    "active_auditor",
    "live_counters",
    "stage_transfer_bytes",
    "validate_residency",
    "consumed_cpu_s",
    "reset_cpu",
    "add_transfer_listener",
    "remove_transfer_listener",
    "note_transfer",
]

MODES = ("off", "audit", "enforce")

# The declared allowlist: boundary name -> justification, the reference's
# dict word for word (a record either package writes names only these).
BOUNDARIES: Dict[str, str] = {
    "input_staging": (
        "The one intended host→device upload of the expression matrix and "
        "its index vectors (devcache.device_put_cached, engine setup). The "
        "matrix crosses the link exactly once per run by design."
    ),
    "funnel_counts": (
        "(P,)-sized per-pair count fetches for the DE gate funnel and "
        "de_counts metrics (obs.quality.de_funnel, engine.de_counts) — "
        "O(P) ints, never the (P, G) statistics."
    ),
    "label_fetch": (
        "Pipeline-tail outputs: the final per-cell labels, the (N,) nodg "
        "counts, and the report plot's gene-row gather — the result the "
        "caller asked for has to reach the host once."
    ),
    "de_union_topk": (
        "de_gene_union's device top-k fetch: (P, n_top) ints instead of "
        "two (P, G) arrays through the slow link."
    ),
    "wilcox_ladder_plan": (
        "O(G) nnz counts + a negativity scalar fetched to plan the window "
        "ladder on host. TODO(item-2): fold ladder planning into the "
        "device-resident graph."
    ),
    "overflow_redo": (
        "Run-space overflow redo: one batched O(G) tied-run-count fetch "
        "after all blocks dispatched (engine._redo_overflow_*). "
        "TODO(item-2): keep the redo decision on device."
    ),
    "exact_small_pairs": (
        "R's exact Wilcoxon branch runs on host for pairs with both "
        "groups < 50 cells; only those pairs' rows are fetched. Host by "
        "statistical design, not an accident."
    ),
    "embed_scores_fetch": (
        "The (N, n_pcs) PCA embedding materializes to host because tree/"
        "cuts/silhouette are host algorithms today. TODO(item-2): keep "
        "the embedding device-resident through rSVD→linkage."
    ),
    "tree_pool_fetch": (
        "LEGACY sub-threshold pooled path only (r7 shrank this from the "
        "former any-N scope): the full-data Lloyd's (m, d) centroids + "
        "(N,) assignment come to host for Ward linkage. Above "
        "SCC_TREE_LANDMARK_THRESHOLD the landmark path crosses at "
        "landmark_assign_fetch instead. TODO(item-2): device-resident "
        "tree for the legacy path too."
    ),
    "landmark_assign_fetch": (
        "Landmark recluster path (r7): one h2d staging of the embedding "
        "blocks into the jitted sketch-Lloyd/nearest-landmark kernels, "
        "then exactly two intended d2h crossings — the (k, d) landmark "
        "centroids for host Ward + treecut and the (N,) int32 "
        "assignment that propagates cut labels to cells. The (N, k) "
        "distance tiles never leave the device."
    ),
    "silhouette_slab_fetch": (
        "EXACT-silhouette path only (below approx_threshold; r7 shrank "
        "this — the landmark/pooled estimator reuses the tree stage's "
        "pool on host and performs no slab fetch): distance slabs / "
        "(N, K) cluster distance sums copy to host (ops.distance, "
        "ops.pallas_kernels.distance_cluster_sums). TODO(item-2): "
        "device-resident silhouette reduction."
    ),
    "de_result_fetch": (
        "PairwiseDEResult lazy-field materialization (to_store, "
        "fingerprinting, host consumers) — the documented single batched "
        "fetch of the (P, G) statistics a host consumer asked for."
    ),
    "de_ckpt_fetch": (
        "Mid-stage wilcox checkpointing (robust round): each completed "
        "ladder bucket's (Gb, P) block fetches to host for the "
        "ArtifactStore so a kill mid-stage resumes from completed "
        "buckets. Only active with an artifact store + "
        "SCC_ROBUST_DE_CKPT — durability bought with a declared, "
        "store-gated crossing, never a silent one."
    ),
    "stream_block_fetch": (
        "Out-of-core streaming (round 17, stream.runner): each disk "
        "chunk's per-shard results — the (P, Gc) rank-sum block, the "
        "(Gc, K) aggregate slab — fetch to host for the resumable "
        "stage store, and each chunk's compacted windows stage h2d "
        "through the shared input_staging path. Load → device → drop "
        "is the streaming contract; this boundary is the declared "
        "drop side, sized per-chunk by construction."
    ),
    "workload_inputs": (
        "Workload-zoo input construction (workloads/, round 19): h2d "
        "staging of scenario embeddings/modalities into the jitted "
        "cover/Lloyd labelers and the O(N) int label/node-id fetches "
        "that become consensus INPUT labelings. Scenario setup runs "
        "before the pipeline's own residency story starts; its "
        "crossings are declared so audit-mode bench records attribute "
        "them, never part of the refine stages' transfer budget."
    ),
    "obs_internal": (
        "Measurement infrastructure's own O(1) transfers: tracer drain "
        "sentinels, sentinel-count fetches. Auto-attributed when the "
        "source line resolves inside obs/."
    ),
    "integrity_check": (
        "The computation-integrity layer's verification transfers "
        "(robust.integrity, round 18): one scalar residual per fused "
        "invariant check at a stage boundary, plus the sampled "
        "ghost-replay rows (a few genes × pairs per ladder rung, one "
        "landmark block, one serving batch). Sized O(samples) by "
        "construction and active only under SCC_INTEGRITY=audit|"
        "enforce — the cost of proving the arithmetic, never part of "
        "the workload's own transfer budget."
    ),
}

_EVENT_CAP = 256            # stored events; totals keep counting past it
_ENFORCE_H2D_BYTES = 1 << 20
_SYNC_WARNING = "called a synchronizing CUDA operation"

_CPU = {"s": 0.0}
_LOCK = threading.Lock()
_ACTIVE: "Optional[ResidencyAuditor]" = None
_TLS = threading.local()
# transfer listeners: fn(direction, nbytes, boundary) called on every
# recorded event (stream.budget's host-budget accountant registers one)
_LISTENERS: List[Any] = []


def add_transfer_listener(fn) -> None:
    """Register ``fn(direction, nbytes, boundary)`` to observe every
    transfer the active auditor records (and every :func:`note_transfer`
    made with no auditor active). Idempotent per function."""
    if fn not in _LISTENERS:
        _LISTENERS.append(fn)


def remove_transfer_listener(fn) -> None:
    try:
        _LISTENERS.remove(fn)
    except ValueError:
        pass


def _notify(direction: str, nbytes: int, bound: Optional[str]) -> None:
    # listener errors never kill a transfer: budget breaches raise from
    # the accountant's own charge() calls, where the caller can recover
    for fn in tuple(_LISTENERS):
        try:
            fn(direction, int(nbytes), bound)
        except Exception:
            pass


def note_transfer(direction: str, nbytes: int) -> None:
    """Record one declared crossing (``"h2d"`` or ``"d2h"``) of
    ``nbytes`` under the enclosing boundary, for the listeners. Dropped
    while an auditor is active: its hook sees the copy itself. A copy
    between two host tensors (the CPU runs) moves nothing and is not
    noted by its callers."""
    if not _LISTENERS or _ACTIVE is not None:
        return
    st = _boundary_stack()
    _notify(direction, nbytes, st[-1] if st else None)


def consumed_cpu_s() -> float:
    """Wall-clock spent inside auditor bookkeeping in this process (the
    <2%-of-wall overhead guard reads this; the audited transfers
    themselves are the workload's cost, not the auditor's)."""
    return _CPU["s"]


def reset_cpu() -> None:
    _CPU["s"] = 0.0


def mode() -> str:
    """Resolved ``SCC_OBS_RESIDENCY`` mode; unknown values raise
    ValueError at auditor construction (a typo'd 'enfrce' must not
    silently run unguarded)."""
    v = str(env_flag("SCC_OBS_RESIDENCY") or "off").strip().lower()
    return v if v else "off"


def active_auditor() -> "Optional[ResidencyAuditor]":
    return _ACTIVE


def live_counters() -> Optional[Dict[str, int]]:
    """Cumulative transfer counters of the process's active auditor for
    the flight recorder's heartbeat ticks (None when no audit is live)."""
    a = _ACTIVE
    if a is None:
        return None
    return {
        "to_host_bytes": a.to_host_bytes,
        "to_device_bytes": a.to_device_bytes,
        "events": a.n_events,
    }


class ResidencyError(RuntimeError):
    """An enforce-mode crossing outside the declared allowlist."""


def _boundary_stack() -> List[str]:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


@contextmanager
def boundary(name: str):
    """Declare an intentional host↔device crossing scope. ``name`` must be
    registered in :data:`BOUNDARIES` (KeyError otherwise — the allowlist
    grows only by an explicit, justified entry). Every event recorded
    inside carries the boundary name."""
    if name not in BOUNDARIES:
        raise KeyError(
            f"undeclared residency boundary {name!r}; register it with a "
            "justification in obs.residency.BOUNDARIES"
        )
    stack = _boundary_stack()
    stack.append(name)
    try:
        yield
    finally:
        stack.pop()


# --------------------------------------------------------------------------
# the crossing hook: one set of patches, shared by the auditor and
# obs.device.TransferWatch for as long as either is active
# --------------------------------------------------------------------------

_HOOK: Dict[str, Any] = {"consumers": [], "orig": {}, "types": frozenset()}
_HOOK_LOCK = threading.Lock()

# Tensor attributes the hook patches as fetches: name -> implicit form
_TENSOR_FETCHES = {
    "item": False, "tolist": False, "numpy": False,
    "__bool__": True, "__int__": True, "__float__": True,
}
_TENSOR_MOVES = ("cpu", "cuda", "to")
_TORCH_STAGING = ("as_tensor", "tensor", "from_numpy")


@contextmanager
def _delegating():
    """Re-entrancy guard: ``Tensor.__array__`` delegates to ``.numpy()``
    and a patched call may make another inside torch's own Python, so
    only the outermost patched call records."""
    _TLS.depth = getattr(_TLS, "depth", 0) + 1
    try:
        yield
    finally:
        _TLS.depth -= 1


def _nested() -> bool:
    return getattr(_TLS, "depth", 0) > 0


def _nbytes(t) -> int:
    try:
        return int(t.numel()) * int(t.element_size())
    except Exception:
        return int(getattr(t, "nbytes", 0) or 0)


def _dispatch(direction: str, nbytes: int, implicit: bool,
              api: str) -> None:
    for c in tuple(_HOOK["consumers"]):
        c._crossing(direction, nbytes, implicit, api)


def _install() -> None:
    import numpy as np
    import torch

    orig = _HOOK["orig"]
    T = torch.Tensor

    def on_device(t) -> bool:
        return t.device.type in _HOOK["types"]

    def fetch(name, implicit):
        fn = getattr(T, name)

        def fetched(self, *a, **kw):
            rec = not _nested() and on_device(self)
            with _delegating():
                out = fn(self, *a, **kw)
            if rec:
                _dispatch("d2h", _nbytes(self), implicit, f"Tensor.{name}")
            return out
        return fetched

    def move(name):
        fn = getattr(T, name)

        def moved(self, *a, **kw):
            nested = _nested()
            with _delegating():
                out = fn(self, *a, **kw)
            if not nested and out is not self and isinstance(out, T):
                src, dst = on_device(self), on_device(out)
                if src != dst:
                    _dispatch("d2h" if src else "h2d", _nbytes(out), False,
                              f"Tensor.{name}")
            return out
        return moved

    copy_fn = T.copy_

    def copy_(self, src, *a, **kw):
        nested = _nested()
        with _delegating():
            out = copy_fn(self, src, *a, **kw)
        if not nested and isinstance(src, T):
            s, d = on_device(src), on_device(self)
            if s != d:
                _dispatch("d2h" if s else "h2d", _nbytes(src), False,
                          "Tensor.copy_")
        return out

    def staging(name):
        fn = getattr(torch, name)

        def staged(data, *a, **kw):
            nested = _nested()
            with _delegating():
                out = fn(data, *a, **kw)
            if not nested and isinstance(out, T):
                if isinstance(data, np.ndarray):
                    if on_device(out):
                        _dispatch("h2d", int(data.nbytes), False,
                                  f"torch.{name}")
                elif isinstance(data, T):
                    s, d = on_device(data), on_device(out)
                    if s != d:
                        _dispatch("d2h" if s else "h2d", _nbytes(out),
                                  False, f"torch.{name}")
            return out
        return staged

    for name, implicit in _TENSOR_FETCHES.items():
        orig[("T", name)] = T.__dict__.get(name)
        setattr(T, name, fetch(name, implicit))
    for name in _TENSOR_MOVES:
        orig[("T", name)] = T.__dict__.get(name)
        setattr(T, name, move(name))
    orig[("T", "copy_")] = T.__dict__.get("copy_")
    T.copy_ = copy_
    for name in _TORCH_STAGING:
        orig[("torch", name)] = getattr(torch, name)
        setattr(torch, name, staging(name))


def _uninstall() -> None:
    import torch

    for (where, name), fn in _HOOK["orig"].items():
        if where == "torch":
            setattr(torch, name, fn)
        elif fn is None:
            delattr(torch.Tensor, name)  # inherited from the C base
        else:
            setattr(torch.Tensor, name, fn)
    _HOOK["orig"] = {}


def _attach(consumer) -> None:
    """Add a consumer (``_crossing(direction, nbytes, implicit, api)``,
    ``device_types``); the first one installs the patches."""
    with _HOOK_LOCK:
        if not _HOOK["consumers"]:
            _install()
        _HOOK["consumers"].append(consumer)
        _HOOK["types"] = frozenset(
            t for c in _HOOK["consumers"] for t in c.device_types)


def _detach(consumer) -> None:
    with _HOOK_LOCK:
        if consumer in _HOOK["consumers"]:
            _HOOK["consumers"].remove(consumer)
        _HOOK["types"] = frozenset(
            t for c in _HOOK["consumers"] for t in c.device_types)
        if not _HOOK["consumers"] and _HOOK["orig"]:
            _uninstall()


_OBS_DIR = os.path.dirname(os.path.abspath(__file__))
_THIS_FILE = os.path.abspath(__file__)
_STDLIB_INFRA = ("contextlib.py", "warnings.py", "threading.py")

# filename -> "self" | "obs" | "infra" | basename; memoized because the
# same few files dominate every walk
_FILE_CLASS: Dict[str, str] = {}


def _classify_file(fn: str) -> str:
    c = _FILE_CLASS.get(fn)
    if c is None:
        ab = os.path.abspath(fn)
        if ab == _THIS_FILE:
            c = "self"
        elif ab.startswith(_OBS_DIR + os.sep):
            # os.sep-terminated: a sibling like obs_utils/ must NOT inherit
            # the obs_internal exemption
            c = "obs"
        elif (f"{os.sep}torch{os.sep}" in fn
              or f"{os.sep}numpy{os.sep}" in fn
              or os.path.basename(fn) in _STDLIB_INFRA):
            c = "infra"
        else:
            c = os.path.basename(fn)
        _FILE_CLASS[fn] = c
    return c


def _resolve_source() -> Tuple[str, bool]:
    """``(where, from_obs)``: the first stack frame outside this module,
    torch, numpy and the stdlib's context machinery — the source line
    that asked for the transfer — and whether any obs/ frame sits between
    it and the transfer, i.e. measurement infrastructure asked."""
    f = sys._getframe(2)
    from_obs = False
    for _ in range(32):
        if f is None:
            break
        c = _classify_file(f.f_code.co_filename)
        if c == "obs":
            from_obs = True
        elif c not in ("self", "infra"):
            return f"{c}:{f.f_lineno}", from_obs
        f = f.f_back
    return "<unknown>", from_obs


def _open_spans() -> Tuple[Optional[str], Optional[str], Any]:
    """(innermost span name, outermost open stage name, that stage span)
    of the ambient tracer."""
    try:
        from scconsensus_tpu_torch.obs.trace import (
            current_tracer,
            last_tracer,
        )

        tr = current_tracer() or last_tracer()
        if tr is None:
            return None, None, None
        with tr._lock:
            stack = list(tr._stack)
        span = stack[-1].name if stack else None
        st = next((s for s in stack if s.kind == "stage"), None)
        return span, (st.name if st is not None else None), st
    except Exception:
        return None, None, None


class ResidencyAuditor:
    """Scoped residency audit/enforcement (see module docstring).

    Context manager; re-entrant use is rejected (one auditor per process
    at a time). ``mode`` defaults from the ``SCC_OBS_RESIDENCY`` flag;
    ``device_types`` names the tensor device types on the device side of
    the line (``refine()`` passes its run's).
    """

    def __init__(self, mode: Optional[str] = None,
                 enforce_h2d_bytes: int = _ENFORCE_H2D_BYTES,
                 event_cap: int = _EVENT_CAP,
                 device_types: Sequence[str] = ("cuda",)):
        m = (mode if mode is not None else globals()["mode"]())
        if m not in MODES:
            raise ValueError(
                f"SCC_OBS_RESIDENCY must be one of {MODES}, got {m!r}"
            )
        self.mode = m
        self.enforce_h2d_bytes = int(enforce_h2d_bytes)
        self.event_cap = int(event_cap)
        self.device_types = tuple(device_types)
        self.to_device_bytes = 0
        self.to_host_bytes = 0
        self.to_device_calls = 0
        self.to_host_calls = 0
        self.n_events = 0
        self.events_dropped = 0
        self.events: List[Dict[str, Any]] = []
        self.by_stage: Dict[str, Dict[str, int]] = {}
        self.by_boundary: Dict[str, Dict[str, int]] = {}
        self.violations: List[Dict[str, Any]] = []
        # (stage, source line) -> synchronizing ops no patched call made
        self.implicit_syncs: Dict[Tuple[Optional[str], str], int] = {}
        self._lock = threading.Lock()
        self._entered = False
        self._sync_prev: Any = None
        self._warn_prev: Any = None
        self._filters_prev: List[Any] = []

    # -- recording ----------------------------------------------------------
    def _crossing(self, direction: str, nbytes: int, implicit: bool,
                  api: str) -> None:
        t0 = time.perf_counter()
        try:
            bstack = _boundary_stack()
            bound = bstack[-1] if bstack else None
            where, from_obs = _resolve_source()
            if bound is None and from_obs:
                bound = "obs_internal"
            span, stage, _ = _open_spans()
            with self._lock:
                if direction == "d2h":
                    self.to_host_calls += 1
                    self.to_host_bytes += nbytes
                else:
                    self.to_device_calls += 1
                    self.to_device_bytes += nbytes
                self.n_events += 1
                key = "to_host_bytes" if direction == "d2h" \
                    else "to_device_bytes"
                if stage is not None and bound != "obs_internal":
                    # measurement overhead (sentinel fetches, the probe's
                    # diagnosis fetches) stays OUT of the per-stage totals
                    # the perf gate baselines; it remains visible in the
                    # directional totals and by_boundary["obs_internal"]
                    st = self.by_stage.setdefault(
                        stage, {"to_host_bytes": 0, "to_device_bytes": 0,
                                "calls": 0},
                    )
                    st[key] += nbytes
                    st["calls"] += 1
                if bound is not None:
                    bd = self.by_boundary.setdefault(
                        bound, {"to_host_bytes": 0, "to_device_bytes": 0,
                                "calls": 0},
                    )
                    bd[key] += nbytes
                    bd["calls"] += 1
                if len(self.events) < self.event_cap:
                    self.events.append({
                        "direction": direction,
                        "nbytes": int(nbytes),
                        "implicit": bool(implicit),
                        "api": api,
                        "span": span,
                        "stage": stage,
                        "boundary": bound,
                        "where": where,
                    })
                else:
                    self.events_dropped += 1
            _notify(direction, nbytes, bound)
            if self.mode == "enforce" and bound is None:
                if direction == "d2h" or nbytes >= self.enforce_h2d_bytes:
                    v = {"direction": direction, "nbytes": int(nbytes),
                         "api": api, "span": span, "stage": stage,
                         "where": where}
                    with self._lock:
                        self.violations.append(v)
                    raise ResidencyError(
                        f"residency violation: {direction} transfer of "
                        f"{nbytes} bytes via {api} in span "
                        f"{span or '<no-span>'} (stage "
                        f"{stage or '<none>'}) at {where} matches no "
                        "declared boundary — wrap the crossing in "
                        "obs.residency.boundary(<name>) with an in-code "
                        "justification, or keep the data on device"
                    )
        finally:
            _CPU["s"] += time.perf_counter() - t0

    def _on_warning(self, message, category, filename, lineno, file=None,
                    line=None) -> None:
        """``warnings.showwarning`` while the sync debug mode is armed:
        counts the synchronizing ops no patched call made, hands every
        other warning to the handler it replaced."""
        if _SYNC_WARNING not in str(message):
            self._warn_prev(message, category, filename, lineno, file, line)
            return
        if _nested():
            return  # a patched .cpu()/.item() made it: already an event
        t0 = time.perf_counter()
        try:
            where, _ = _resolve_source()
            _, stage, st = _open_spans()
            with self._lock:
                k = (stage, where)
                self.implicit_syncs[k] = self.implicit_syncs.get(k, 0) + 1
            if st is not None:
                st.metrics.counter("implicit_syncs").add(1)
                st.metrics.counter(f"implicit_sync:{where}").add(1)
        finally:
            _CPU["s"] += time.perf_counter() - t0

    # -- context ------------------------------------------------------------
    def __enter__(self) -> "ResidencyAuditor":
        global _ACTIVE
        if self.mode == "off":
            return self
        with _LOCK:
            if _ACTIVE is not None:
                raise RuntimeError(
                    "a ResidencyAuditor is already active in this process"
                )
            _ACTIVE = self
        try:
            _attach(self)
            self._entered = True
            self._arm_sync_debug()
        except BaseException:
            self.__exit__(None, None, None)
            raise
        return self

    def _arm_sync_debug(self) -> None:
        import torch

        if "cuda" not in self.device_types or not torch.cuda.is_available():
            return
        import warnings

        self._sync_prev = torch.cuda.get_sync_debug_mode()
        self._warn_prev = warnings.showwarning
        self._filters_prev = list(warnings.filters)
        warnings.filterwarnings("always", message=f".*{_SYNC_WARNING}")
        warnings.showwarning = self._on_warning
        torch.cuda.set_sync_debug_mode("warn")

    def __exit__(self, *exc) -> None:
        global _ACTIVE
        if self.mode == "off":
            return
        try:
            if self._sync_prev is not None:
                import warnings

                import torch

                torch.cuda.set_sync_debug_mode(self._sync_prev)
                warnings.showwarning = self._warn_prev
                warnings.filters[:] = self._filters_prev
                self._sync_prev = self._warn_prev = None
            if self._entered:
                _detach(self)
                self._entered = False
        finally:
            with _LOCK:
                if _ACTIVE is self:
                    _ACTIVE = None

    # -- the run-record section ---------------------------------------------
    def report(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "mode": self.mode,
                "to_device": {"calls": self.to_device_calls,
                              "bytes": self.to_device_bytes},
                "to_host": {"calls": self.to_host_calls,
                            "bytes": self.to_host_bytes},
                "by_stage": {k: dict(v) for k, v in self.by_stage.items()},
                "by_boundary": {
                    k: dict(v) for k, v in self.by_boundary.items()
                },
                "events": [dict(e) for e in self.events],
                "events_dropped": self.events_dropped,
                "violations": [dict(v) for v in self.violations],
            }


@contextmanager
def audit_region(auditor: "Optional[ResidencyAuditor]"):
    """Run a region under ``auditor`` (None = passthrough)."""
    if auditor is None:
        yield None
        return
    with auditor:
        yield auditor


# --------------------------------------------------------------------------
# section helpers + validation
# --------------------------------------------------------------------------

def stage_transfer_bytes(rec: Dict[str, Any]) -> Dict[str, int]:
    """Total (both directions) transfer bytes per stage from a record's
    ``residency`` section — the quantity the perf gate baselines. Empty
    when no audit ran."""
    res = rec.get("residency")
    if not isinstance(res, dict):
        return {}
    out: Dict[str, int] = {}
    for stage, d in (res.get("by_stage") or {}).items():
        if isinstance(d, dict):
            out[str(stage)] = int(d.get("to_host_bytes") or 0) + int(
                d.get("to_device_bytes") or 0
            )
    return out


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"residency section: {msg}")


def validate_residency(res: Dict[str, Any]) -> None:
    """Structural validation of a record's ``residency`` section (the
    reference's checks; ``export.validate_run_record`` calls this)."""
    _require(isinstance(res, dict), "must be an object")
    _require(res.get("mode") in ("audit", "enforce"),
             f"mode must be audit|enforce, got {res.get('mode')!r}")
    for side in ("to_device", "to_host"):
        d = res.get(side)
        _require(isinstance(d, dict), f"{side} must be an object")
        for k in ("calls", "bytes"):
            v = d.get(k)
            _require(isinstance(v, int) and v >= 0,
                     f"{side}.{k} must be an int >= 0")
    for agg in ("by_stage", "by_boundary"):
        d = res.get(agg, {})
        _require(isinstance(d, dict), f"{agg} must be an object")
        for name, sd in d.items():
            _require(isinstance(sd, dict), f"{agg}[{name!r}] not an object")
            for k in ("to_host_bytes", "to_device_bytes", "calls"):
                v = sd.get(k, 0)
                _require(isinstance(v, int) and v >= 0,
                         f"{agg}[{name!r}].{k} must be an int >= 0")
    for b in res.get("by_boundary", {}):
        _require(b in BOUNDARIES,
                 f"by_boundary names undeclared boundary {b!r}")
    events = res.get("events", [])
    _require(isinstance(events, list), "events must be a list")
    for i, e in enumerate(events):
        _require(isinstance(e, dict), f"events[{i}] is not an object")
        _require(e.get("direction") in ("h2d", "d2h"),
                 f"events[{i}].direction must be h2d|d2h")
        nb = e.get("nbytes")
        _require(isinstance(nb, int) and nb >= 0,
                 f"events[{i}].nbytes must be an int >= 0")
        bd = e.get("boundary")
        _require(bd is None or bd in BOUNDARIES,
                 f"events[{i}] names undeclared boundary {bd!r}")
    _require(isinstance(res.get("violations", []), list),
             "violations must be a list")
