"""Program observatory: graph passports for the port's stage programs →
the ``graphs`` run-record section.

The port's form of ``scconsensus_tpu/obs/graphs.py``. The reference
captures a passport from each jitted stage program's optimized HLO; the
port runs eager torch, so a passport here is a census of the aten
operators one call of the program dispatches, taken by a recording
``TorchDispatchMode`` around the program's first real call at each
abstract signature (tensor shapes, dtypes and devices, and the values of
the other arguments). The real call, not a fake-tensor rerun: a host sync
(``_local_scalar_dense`` behind ``.item()``, ``nonzero``, a cross-device
``_to_copy``) is exactly what the passport must see, and the cost model's
fake-tensor run records nothing for such programs. The fields, the
reference's schema:

* ``op_histogram`` — aten operator names (the overload packet, e.g.
  ``mm``, ``sort``; other namespaces prefixed ``ns::``), ``ops`` their
  sum;
* ``fusions`` — 0: eager execution fuses nothing (every operator is its
  own kernel launch);
* ``transfer_ops`` — cross-device copies (``_to_copy`` or ``copy_``
  whose source and destination devices differ), each site
  ``{op: "_to_copy(cuda:0->cpu)", where}``;
* ``host_callbacks`` — operators whose result the host must read before
  it can go on (:data:`HOST_SYNC_OPS`, and ``index``/``index_put`` with a
  boolean mask, whose output size depends on the mask), each site
  ``{target, where}``;
* ``where`` — ``file:line`` of the innermost frame inside the package
  outside ``obs/`` (or in ``tests/`` or ``tools/``), so a ratchet
  failure names a line of the port, as the reference names a Python
  line;
* ``donation`` — ``{declared: 0, hits: 0, misses: 0}``: none of the
  reference's instrumented programs declares a donation, and eager torch
  has none to declare;
* ``buffers`` — ``argument_bytes`` and ``output_bytes`` from the call's
  tensors, ``alias_bytes`` the outputs sharing storage with an argument,
  ``temp_bytes`` the peak of the storages the call allocated and held
  (tracked through each new storage's finalizer, no allocator counter
  touched) beyond its new outputs, ``peak_bytes = argument + output +
  temp − alias``. Workspaces a library allocates inside one operator are
  not seen;
* ``capture_s`` — the recorder's own bookkeeping time during the call;
* ``cost`` — the cost model's counts (``obs.cost``) when ``SCC_OBS_COST``
  is on and it counted the call.

Programs are instrumented under the reference's names
(``scconsensus_tpu/ops/*.py``, ``de/edger.py``), each where the port does
that program's work: ``distance.sq_dists``,
``distance.pearson_distance_matrix`` (the port's Pearson path normalizes
the cells, ``ops.distance.pearson_unit_cells``),
``gates.compute_aggregates_cid`` (the reference's one-hot-input
``gates.compute_aggregates`` runs it here),
``gates.pair_gates_fast``, ``gates.pair_gates_slow``,
``embed.pca_scores``, ``embed.pca_scores_audited``, ``embed.pca_basis``,
``landmark.lloyd``, ``landmark.lloyd_sketch``, ``landmark.assign_blocks``,
``wilcox.allpairs_ranksum_chunk`` (``ranksum_body``),
``wilcox.sort_probe``, ``edger.sub_table_sorted_chunk`` and
``edger.table_chunk``. ``wilcox.allpairs_ranksum_runspace_chunk`` is
never run by the port's engine and has no passport.
:func:`instrumented_programs` lists them.

:func:`passport_from_hlo` and :data:`TRANSFER_OP_KINDS` are copies of the
reference's parser of optimized-HLO text (:73-221): it reads text and
needs no JAX, so a passport the reference would build from a module's
text can be built here too.

The runtime mirrors ``obs.compilelog``: :func:`install_and_mark` arms the
registry (gated on ``SCC_GRAPHS``), :func:`instrument` wraps a program
(unarmed, one flag check a call; armed, one signature and one set lookup
after the first call), and :func:`snapshot` builds the section. A capture
never nests: inside another capture, under a fake-tensor mode (the cost
model's counted run) or under any other dispatch mode the call runs
unobserved and its signature stays unseen. The recorder adds no
synchronization: it reads devices, shapes and storage pointers only.
Capture is best effort: a failure lands in the section's ``errors``,
never in the measurement.

Passports are keyed by :func:`environment_fingerprint`: torch's identity
(torch and CUDA versions, backend, device kind and count, the TF32
switches and the kernel's nvcc flags), with the port's own
``_FP_FIELDS``, so a port digest never equals a JAX digest and the
reference's ratchet refuses to gate a port record. The reference's
:func:`validate_graphs` recomputes the digest over JAX's fields and so
refuses a port fingerprint too; everything else in a port section passes
it.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import re
import sys
import threading
import time
import weakref
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, \
    Tuple

from scconsensus_tpu_torch.config import env_flag

__all__ = [
    "GRAPHS_VERSION",
    "TRANSFER_OP_KINDS",
    "passport_from_hlo",
    "TRANSFER_OPS",
    "HOST_SYNC_OPS",
    "build_passport",
    "build_graphs_section",
    "validate_graphs",
    "environment_fingerprint",
    "fingerprint_digest",
    "instrument",
    "instrumented_programs",
    "observe",
    "install_and_mark",
    "armed",
    "snapshot",
    "reset",
    "stage_graph_counts",
    "ratchet_ack",
]

GRAPHS_VERSION = 1

# aten operators that copy between tensors: a transfer when the source
# and destination devices differ
TRANSFER_OPS = frozenset(("_to_copy", "copy_", "_copy_from",
                          "_copy_from_and_resize"))

# aten operators whose result the host must read before it can go on: a
# scalar read back (``.item()``, ``bool()``, ``int()`` and ``float()`` of
# a tensor all reach ``_local_scalar_dense``), or an output whose size
# depends on the values (``repeat_interleave`` reaches the dispatcher
# only with tensor repeats). Composite operators (``argwhere``,
# ``unique``) decompose into these before a dispatch mode sees them.
HOST_SYNC_OPS = frozenset((
    "_local_scalar_dense", "equal", "nonzero", "masked_select", "_unique",
    "_unique2", "unique_dim", "unique_consecutive",
    "unique_dim_consecutive", "repeat_interleave", "bincount",
))
# indexing with a boolean mask sizes its output by the mask
_MASK_INDEX_OPS = frozenset(("index", "index_put", "index_put_",
                             "_index_put_impl_"))

# path markers of frames a site may name (repo-relative after the marker)
_SITE_MARKERS = ("/scconsensus_tpu_torch/", "/tests/", "/tools/")
_OBS_DIR = "/scconsensus_tpu_torch/obs/"


def build_passport(
    program: str,
    op_histogram: Dict[str, int],
    transfers: Sequence[Dict[str, Any]] = (),
    callbacks: Sequence[Dict[str, Any]] = (),
    memory: Optional[Dict[str, Any]] = None,
    cost: Optional[Dict[str, Any]] = None,
    stage: Optional[str] = None,
    entry_ordinal: int = 1,
    capture_s: float = 0.0,
) -> Dict[str, Any]:
    """One graph passport from a recorded operator census (pure; tests
    feed synthetic censuses). ``memory`` carries ``argument_bytes``,
    ``output_bytes``, ``temp_bytes`` and ``alias_bytes``; ``cost`` the
    ``obs.cost`` counts."""
    buffers: Dict[str, int] = {}
    if memory:
        for key in ("argument_bytes", "output_bytes", "temp_bytes",
                    "alias_bytes"):
            v = memory.get(key)
            if isinstance(v, (int, float)):
                buffers[key] = int(v)
        # the reference's live-set estimate: everything resident at once,
        # minus what the outputs reuse of the arguments
        buffers["peak_bytes"] = max(0, (
            buffers.get("argument_bytes", 0)
            + buffers.get("output_bytes", 0)
            + buffers.get("temp_bytes", 0)
            - buffers.get("alias_bytes", 0)
        ))
    passport: Dict[str, Any] = {
        "program": program,
        "stage": stage,
        "entry_ordinal": int(entry_ordinal),
        "ops": int(sum(op_histogram.values())),
        "op_histogram": {k: int(op_histogram[k])
                         for k in sorted(op_histogram)},
        "fusions": 0,
        "transfer_ops": {"count": len(transfers),
                         "sites": [dict(s) for s in transfers]},
        "host_callbacks": {"count": len(callbacks),
                           "sites": [dict(s) for s in callbacks]},
        "donation": {"declared": 0, "hits": 0, "misses": 0},
        "buffers": buffers,
        "capture_s": round(float(capture_s), 6),
    }
    if cost:
        passport["cost"] = {k: float(v) for k, v in cost.items()}
    return passport


# ---- the reference's HLO-text passport (a copy of :73-221) --------------

# HLO op kinds that are host<->device (or cross-device) data movement
# inside a compiled program; host-memory-space copies are caught apart
TRANSFER_OP_KINDS = frozenset((
    "infeed", "outfeed",
    "send", "send-done", "recv", "recv-done",
))

# XLA marks host-memory-space buffers S(5) in layouts: a copy touching
# one is a device<->host transfer
_HOST_SPACE = "S(5)"
_COPY_KINDS = frozenset(("copy", "copy-start", "copy-done"))

# one HLO instruction: `  [ROOT] %name = <type> op-kind(...)`
_OP_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*(?:\([^=]*\)|\S+)\s+"
    r"([a-zA-Z][\w\-]*)\("
)
_META_RE = re.compile(r'source_file="([^"]*)"\s+source_line=(\d+)')
_TARGET_RE = re.compile(r'custom_call_target="([^"]*)"')
# module-header donation evidence: input_output_alias={ {}: (0, {}, ...) }
_ALIAS_BLOCK_RE = re.compile(r"input_output_alias=\{(.*?)\}\s*(?:,|$)")
_ALIAS_PARAM_RE = re.compile(r"\(\s*(\d+)\s*,")


def _hlo_where(line: str) -> Optional[str]:
    """``file:line`` from an HLO op's metadata, repo-relative when
    possible."""
    m = _META_RE.search(line)
    if not m:
        return None
    path, lineno = m.group(1), m.group(2)
    for marker in ("/scconsensus_tpu/", "/tools/", "/tests/"):
        i = path.find(marker)
        if i >= 0:
            path = path[i + 1:]
            break
    return f"{path}:{lineno}"


def _hlo_callback(kind: str, line: str) -> Optional[str]:
    """The custom-call target when this op is a host callback, else
    None."""
    if kind != "custom-call":
        return None
    m = _TARGET_RE.search(line)
    if m and "callback" in m.group(1):
        return m.group(1)
    return None


def _hlo_transfer(kind: str, line: str) -> bool:
    if kind in TRANSFER_OP_KINDS:
        return True
    return kind in _COPY_KINDS and _HOST_SPACE in line


def passport_from_hlo(
    program: str,
    hlo_text: str,
    donated: int = 0,
    memory: Optional[Dict[str, Any]] = None,
    cost: Optional[Dict[str, Any]] = None,
    stage: Optional[str] = None,
    entry_ordinal: int = 1,
    capture_s: float = 0.0,
) -> Dict[str, Any]:
    """One graph passport from optimized-HLO text (pure), the reference's
    exactly. ``donated`` is the number of declared donated buffers; hits
    are the module header's ``input_output_alias`` entries, misses the
    declared remainder. ``memory`` carries XLA's ``CompiledMemoryStats``
    fields as a plain dict; ``cost`` the normalized cost-analysis dict."""
    histogram: Dict[str, int] = {}
    fusions = 0
    transfers: List[Dict[str, Any]] = []
    callbacks: List[Dict[str, Any]] = []
    alias_hits = 0
    for line in hlo_text.splitlines():
        if "input_output_alias={" in line:
            blk = _ALIAS_BLOCK_RE.search(line)
            if blk:
                alias_hits = len(_ALIAS_PARAM_RE.findall(blk.group(1)))
        m = _OP_RE.match(line)
        if not m:
            continue
        kind = m.group(1)
        histogram[kind] = histogram.get(kind, 0) + 1
        if kind == "fusion":
            fusions += 1
        target = _hlo_callback(kind, line)
        if target is not None:
            callbacks.append({"target": target, "where": _hlo_where(line)})
        elif _hlo_transfer(kind, line):
            transfers.append({"op": kind, "where": _hlo_where(line)})
    hits = min(alias_hits, donated) if donated else alias_hits
    misses = max(0, donated - alias_hits)
    buffers: Dict[str, int] = {}
    if memory:
        for key in ("argument_bytes", "output_bytes", "temp_bytes",
                    "alias_bytes", "generated_code_bytes"):
            v = memory.get(key)
            if isinstance(v, (int, float)):
                buffers[key] = int(v)
        buffers["peak_bytes"] = max(0, (
            buffers.get("argument_bytes", 0)
            + buffers.get("output_bytes", 0)
            + buffers.get("temp_bytes", 0)
            - buffers.get("alias_bytes", 0)
        ))
    passport: Dict[str, Any] = {
        "program": program,
        "stage": stage,
        "entry_ordinal": int(entry_ordinal),
        "ops": sum(histogram.values()),
        "op_histogram": {k: histogram[k] for k in sorted(histogram)},
        "fusions": fusions,
        "transfer_ops": {"count": len(transfers), "sites": transfers},
        "host_callbacks": {"count": len(callbacks), "sites": callbacks},
        "donation": {"declared": int(donated), "hits": int(hits),
                     "misses": int(misses)},
        "buffers": buffers,
        "capture_s": round(float(capture_s), 6),
    }
    if cost:
        passport["cost"] = {k: float(v) for k, v in cost.items()}
    return passport


def build_graphs_section(
    passports: Sequence[Dict[str, Any]],
    fingerprint: Optional[Dict[str, Any]] = None,
    errors: Iterable[str] = (),
) -> Dict[str, Any]:
    """The ``graphs`` section from captured passports (pure). Programs
    are keyed by their unique capture name; ``by_stage`` joins them to
    the stage timeline by the ambient stage recorded at first call —
    the same join ``obs.compilelog`` uses, so the compile panel and the
    passport panel name the same rows."""
    programs: Dict[str, Dict[str, Any]] = {}
    by_stage: Dict[str, Dict[str, Any]] = {}
    totals = {"programs": 0, "transfer_ops": 0, "host_callbacks": 0,
              "donation_misses": 0, "fusions": 0}
    for p in passports:
        name = str(p.get("program"))
        while name in programs:  # same program, new abstract signature
            name += "'"
        programs[name] = p
        totals["programs"] += 1
        t = (p.get("transfer_ops") or {}).get("count", 0)
        c = (p.get("host_callbacks") or {}).get("count", 0)
        misses = (p.get("donation") or {}).get("misses", 0)
        totals["transfer_ops"] += t
        totals["host_callbacks"] += c
        totals["donation_misses"] += misses
        totals["fusions"] += p.get("fusions", 0)
        stage = p.get("stage") or _outside()
        row = by_stage.setdefault(stage, {
            "programs": [], "transfer_ops": 0, "host_callbacks": 0,
            "donation_misses": 0,
        })
        row["programs"].append(name)
        row["transfer_ops"] += t
        row["host_callbacks"] += c
        row["donation_misses"] += misses
    sec: Dict[str, Any] = {
        "version": GRAPHS_VERSION,
        "programs": {k: programs[k] for k in sorted(programs)},
        "by_stage": {k: by_stage[k] for k in sorted(by_stage)},
        "totals": totals,
    }
    if fingerprint:
        sec["fingerprint"] = fingerprint
    errs = [str(e) for e in errors]
    if errs:
        sec["errors"] = errs
    return sec


def _outside() -> str:
    from scconsensus_tpu_torch.obs.hostprof import OUTSIDE_SPANS

    return OUTSIDE_SPANS


# --------------------------------------------------------------------------
# environment fingerprint (passports are toolchain-keyed)
# --------------------------------------------------------------------------

_FP_FIELDS = ("torch", "cuda", "backend", "device_kind", "device_count",
              "tf32_matmul", "tf32_cudnn", "nvcc_flags_sha")


def fingerprint_digest(fp: Dict[str, Any]) -> str:
    """12-hex digest over the identity fields (ignores the digest field
    itself and any future additive keys), the single equality the diff
    tool and the ratchet key on."""
    core = {k: fp.get(k) for k in _FP_FIELDS}
    return hashlib.sha256(
        json.dumps(core, sort_keys=True).encode()
    ).hexdigest()[:12]


def environment_fingerprint() -> Optional[Dict[str, Any]]:
    """Toolchain identity of this process: torch and CUDA versions, the
    backend (``cuda`` once this process has a CUDA context, else
    ``cpu``), the card's name and count, the TF32 switches and the
    kernel's nvcc flags with their hash. None when torch was never
    imported. Never imports torch itself and never initializes a device
    that is not already up."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    from scconsensus_tpu_torch.ops.cuda_kernels import _NVCC_FLAGS

    flags = " ".join(_NVCC_FLAGS)
    fp: Dict[str, Any] = {
        "torch": getattr(torch, "__version__", None),
        "cuda": getattr(torch.version, "cuda", None),
        "tf32_matmul": bool(torch.backends.cuda.matmul.allow_tf32),
        "tf32_cudnn": bool(torch.backends.cudnn.allow_tf32),
        "nvcc_flags": flags,
        "nvcc_flags_sha": hashlib.sha256(flags.encode()).hexdigest()[:12],
        "backend": "cpu", "device_kind": "cpu", "device_count": 1,
    }
    try:
        if torch.cuda.is_initialized():
            fp["backend"] = "cuda"
            fp["device_kind"] = torch.cuda.get_device_name(
                torch.cuda.current_device())
            fp["device_count"] = int(torch.cuda.device_count())
    except Exception:
        pass
    fp["digest"] = fingerprint_digest(fp)
    return fp


# --------------------------------------------------------------------------
# runtime: armed registry, memoized first-call capture, snapshot
# --------------------------------------------------------------------------

_STATE: Dict[str, Any] = {
    "armed": False,
    "passports": [],      # captured passport dicts, call order
    "seen": set(),        # (program, signature) keys already captured
    "errors": [],
    "lock": threading.Lock(),
}
_PROGRAMS: Dict[str, Callable] = {}   # name -> the wrapped function


def install_and_mark(force: bool = False) -> bool:
    """Arm the passport registry (gated on ``SCC_GRAPHS`` unless
    ``force``); also clears any capture from a previous arm so a worker
    section holds only its own run's programs."""
    if not force and not env_flag("SCC_GRAPHS"):
        return False
    reset()
    _STATE["armed"] = True
    _warm()
    return True


def _warm() -> None:
    """Build the recorder and dispatch one CPU operator under it: torch
    imports its dispatch machinery (seconds, once per process) on the
    first operator a Python dispatch mode sees, and that belongs to the
    arming, not to the first captured stage."""
    try:
        import torch

        if _RECORDER["cls"] is None:
            _RECORDER["cls"] = _recorder_class()
        with _RECORDER["cls"](set()):
            torch.zeros(1).add_(1)
    except Exception as e:
        with _STATE["lock"]:
            _STATE["errors"].append(f"recorder warm-up: {e!r}")


def armed() -> bool:
    return bool(_STATE["armed"])


def reset() -> None:
    """Disarm and drop all captured state (tests; install re-arms)."""
    with _STATE["lock"]:
        _STATE["armed"] = False
        _STATE["passports"] = []
        _STATE["seen"] = set()
        _STATE["errors"] = []


def instrumented_programs() -> List[str]:
    """The names of the programs wrapped by :func:`instrument`."""
    return sorted(_PROGRAMS)


def _abstract(x: Any) -> Any:
    """Hashable signature element. Never reads a tensor's values: that
    would synchronize with the card mid-stage."""
    import torch

    if isinstance(x, torch.Tensor):
        return ("t", tuple(x.shape), str(x.dtype), str(x.device))
    shape, dtype = getattr(x, "shape", None), getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        return ("nd", tuple(int(s) for s in shape), str(dtype))
    if isinstance(x, (bool, int, float, str, type(None))):
        return ("val", x)
    if isinstance(x, (torch.device, torch.dtype)):
        return ("val", str(x))
    if isinstance(x, (list, tuple)):
        return ("seq", tuple(_abstract(e) for e in x))
    if isinstance(x, dict):
        return ("map", tuple(sorted((str(k), _abstract(v))
                                    for k, v in x.items())))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return ("dc", type(x).__name__,
                tuple(_abstract(getattr(x, f.name))
                      for f in dataclasses.fields(x)))
    return ("type", type(x).__name__)


def _leaves(x: Any) -> Iterable[Any]:
    """Tensor and array leaves of nested sequences, maps and dataclasses."""
    if isinstance(x, (list, tuple)):
        for e in x:
            yield from _leaves(e)
    elif isinstance(x, dict):
        for e in x.values():
            yield from _leaves(e)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from _leaves(getattr(x, f.name))
    elif getattr(x, "shape", None) is not None and \
            getattr(x, "dtype", None) is not None:
        yield x


def _where() -> Optional[str]:
    """``file:line`` of the innermost frame of the port outside ``obs/``,
    or of a test or tool, repo-relative."""
    f = sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename.replace("\\", "/")
        if _OBS_DIR not in path:
            for marker in _SITE_MARKERS:
                i = path.find(marker)
                if i >= 0:
                    return f"{path[i + 1:]}:{f.f_lineno}"
        f = f.f_back
    return None


def _op_name(func) -> str:
    name = func.overloadpacket.__name__
    ns = getattr(func, "namespace", "aten")
    return name if ns == "aten" else f"{ns}::{name}"


def _recorder_class():
    """The recording dispatch mode (built on first capture: torch's
    dispatch-mode module is imported only when a capture runs)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Recorder(TorchDispatchMode):
        """Counts every aten operator of one call, notes transfer and
        host-sync sites, and follows the storages the call allocates."""

        def __init__(self, arg_ptrs):
            super().__init__()
            self.hist: Dict[str, int] = {}
            self.transfers: List[Dict[str, Any]] = []
            self.callbacks: List[Dict[str, Any]] = []
            self.arg_ptrs = arg_ptrs
            self.live: Dict[int, int] = {}   # new storage ptr -> bytes
            self.live_bytes = 0
            self.peak_bytes = 0
            self.self_s = 0.0
            self.error: Optional[BaseException] = None

        def _free(self, ptr: int) -> None:
            self.live_bytes -= self.live.pop(ptr, 0)

        def _note(self, name, args, kwargs) -> None:
            self.hist[name] = self.hist.get(name, 0) + 1
            if name in TRANSFER_OPS:
                if name == "_to_copy":
                    src = args[0].device if args else None
                    dst = kwargs.get("device")
                    dst = torch.device(dst) if dst is not None else src
                elif args and len(args) > 1 and isinstance(
                        args[1], torch.Tensor):
                    src, dst = args[1].device, args[0].device
                else:
                    return
                if src is not None and dst is not None and (
                        src.type != dst.type or None not in (
                            src.index, dst.index) and src.index != dst.index):
                    self.transfers.append(
                        {"op": f"{name}({src}->{dst})", "where": _where()})
            elif name in HOST_SYNC_OPS:
                self.callbacks.append({"target": name, "where": _where()})
            elif name in _MASK_INDEX_OPS:
                idx = args[1] if len(args) > 1 else kwargs.get("indices")
                if any(isinstance(t, torch.Tensor) and t.dtype in (
                        torch.bool, torch.uint8) for t in (idx or ())):
                    self.callbacks.append({"target": f"{name}(bool mask)",
                                           "where": _where()})

        def _track(self, out) -> None:
            for t in _leaves(out):
                if not isinstance(t, torch.Tensor):
                    continue
                st = t.untyped_storage()
                ptr = st.data_ptr()
                if ptr == 0 or ptr in self.live or ptr in self.arg_ptrs:
                    continue
                nb = int(st.nbytes())
                self.live[ptr] = nb
                self.live_bytes += nb
                self.peak_bytes = max(self.peak_bytes, self.live_bytes)
                weakref.finalize(st, self._free, ptr)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            t0 = time.perf_counter()
            if self.error is None:
                try:
                    self._note(_op_name(func), args, kwargs)
                except Exception as e:
                    self.error = e
            t1 = time.perf_counter()
            out = func(*args, **kwargs)
            t2 = time.perf_counter()
            if self.error is None:
                try:
                    self._track(out)
                except Exception as e:
                    self.error = e
            self.self_s += (t1 - t0) + (time.perf_counter() - t2)
            return out

    return _Recorder


_RECORDER: Dict[str, Any] = {"cls": None}


def _nbytes(t) -> int:
    return int(t.numel()) * int(t.element_size()) if hasattr(
        t, "element_size") else int(getattr(t, "nbytes", 0))


def _capture_blocked() -> bool:
    """A capture must not open inside another capture (its recorder is a
    dispatch mode), under a fake-tensor mode (the cost model's counted
    run) or under any other dispatch mode: it would count that mode's
    operators, or count them twice."""
    import torch

    return torch._C._len_torch_dispatch_stack() > 0


def _ambient() -> Tuple[Optional[str], int]:
    try:
        from scconsensus_tpu_torch.obs.trace import ambient_stage

        name, ordinal = ambient_stage()
        if name is not None:
            return str(name), max(1, int(ordinal))
    except Exception:
        pass
    return None, 1


def observe(program: str, fn, args: Tuple = (),
            kwargs: Optional[Dict[str, Any]] = None, wrapper=None) -> Any:
    """Call ``fn(*args, **kwargs)`` and return its result, capturing
    ``program``'s passport when this is its first call at this abstract
    signature and the registry is armed. Best effort: a bookkeeping
    failure records an error string, never raises into the measurement;
    an exception of ``fn`` itself propagates and leaves the signature
    unseen."""
    kwargs = kwargs or {}
    if not _STATE["armed"] or _capture_blocked():
        return fn(*args, **kwargs)
    try:
        key = (program, _abstract((args, kwargs)))
    except Exception:
        key = (program, None)
    if key in _STATE["seen"]:
        return fn(*args, **kwargs)
    # Decide under the lock, run outside it: instrumented programs nest
    # (edger's sorted chunk calls its table chunk), and the lock is not
    # reentrant.
    with _STATE["lock"]:
        capture = key not in _STATE["seen"]
        if capture:
            _STATE["seen"].add(key)
            cap = int(env_flag("SCC_GRAPHS_MAX_PROGRAMS"))
            if len(_STATE["passports"]) >= cap:
                capture = False
                msg = (f"passport cap reached ({cap}); "
                       "further programs dropped")
                if msg not in _STATE["errors"]:
                    _STATE["errors"].append(msg)
    if not capture:
        return fn(*args, **kwargs)
    try:
        if _RECORDER["cls"] is None:
            _RECORDER["cls"] = _recorder_class()
        stage, ordinal = _ambient()
        ins = list(_leaves((args, kwargs)))
        arg_ptrs = set()
        for t in ins:
            if hasattr(t, "untyped_storage"):
                arg_ptrs.add(t.untyped_storage().data_ptr())
        rec = _RECORDER["cls"](arg_ptrs)
    except Exception as e:
        with _STATE["lock"]:
            _STATE["errors"].append(f"{program}: {e!r}")
        return fn(*args, **kwargs)
    try:
        with rec:
            out = fn(*args, **kwargs)
    except BaseException:
        with _STATE["lock"]:
            _STATE["seen"].discard(key)
        raise
    try:
        if rec.error is not None:
            raise rec.error
        outs, seen_out = [], set()
        for t in _leaves(out):
            ptr = t.untyped_storage().data_ptr() if hasattr(
                t, "untyped_storage") else id(t)
            if ptr not in seen_out:
                seen_out.add(ptr)
                outs.append((t, ptr))
        new_out = sum(rec.live.get(p, 0) for _, p in outs)
        memory = {
            "argument_bytes": sum(_nbytes(t) for t in ins),
            "output_bytes": sum(_nbytes(t) for t, _ in outs),
            "alias_bytes": sum(_nbytes(t) for t, p in outs
                               if p in arg_ptrs),
            "temp_bytes": max(0, rec.peak_bytes - new_out),
        }
        cost = None
        from scconsensus_tpu_torch.obs.cost import (
            cost_analysis_of,
            cost_enabled,
        )

        if cost_enabled():
            cost = cost_analysis_of(wrapper or fn, *args, **kwargs)
        passport = build_passport(
            program, rec.hist, rec.transfers, rec.callbacks,
            memory=memory, cost=cost, stage=stage, entry_ordinal=ordinal,
            capture_s=rec.self_s)
        with _STATE["lock"]:
            _STATE["passports"].append(passport)
    except Exception as e:
        with _STATE["lock"]:
            _STATE["errors"].append(f"{program}: {e!r}")
    return out


def instrument(program: str, fn):
    """Wrap ``fn`` as the observed stage program ``program``. Unarmed, a
    call costs one flag check; the wrapper keeps ``fn``'s name, doc and
    ``__wrapped__``."""
    @functools.wraps(fn)
    def observed(*args, **kwargs):
        if _STATE["armed"]:
            return observe(program, fn, args, kwargs, wrapper=observed)
        return fn(*args, **kwargs)

    _PROGRAMS[program] = observed
    return observed


def snapshot() -> Optional[Dict[str, Any]]:
    """The ``graphs`` section for everything captured since arming; None
    when never armed — the record omits the section rather than claim a
    run that was not looking ran no program."""
    if not _STATE["armed"]:
        return None
    with _STATE["lock"]:
        passports = list(_STATE["passports"])
        errors = list(_STATE["errors"])
    return build_graphs_section(
        passports,
        fingerprint=environment_fingerprint(),
        errors=errors,
    )


# --------------------------------------------------------------------------
# consumers: per-stage counts (the perf-gate ratchet) + pins ack
# --------------------------------------------------------------------------

def stage_graph_counts(rec: Dict[str, Any]) -> Dict[str, Dict[str, int]]:
    """``{stage: {transfer_ops, host_callbacks}}`` from a run record's
    graphs section ({} when absent) — the candidate side of the
    perf-gate transfer-op ratchet."""
    sec = rec.get("graphs")
    if not isinstance(sec, dict):
        return {}
    out: Dict[str, Dict[str, int]] = {}
    for stage, row in (sec.get("by_stage") or {}).items():
        if isinstance(row, dict):
            out[str(stage)] = {
                "transfer_ops": int(row.get("transfer_ops", 0)),
                "host_callbacks": int(row.get("host_callbacks", 0)),
            }
    return out


def ratchet_ack(ratchet_entry: Dict[str, Any]) -> str:
    """12-hex digest of one dataset's ``graph_ratchet`` pins — stamped
    into ``extra.graph_ratchet_ack`` on bench records so committed
    evidence names exactly which debt snapshot it was gated against."""
    return hashlib.sha256(
        json.dumps(ratchet_entry, sort_keys=True).encode()
    ).hexdigest()[:12]


# --------------------------------------------------------------------------
# validation (export.validate_run_record dispatches here)
# --------------------------------------------------------------------------

def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"graphs section: {msg}")


def _validate_sites(name: str, block: Any, site_key: str) -> int:
    _require(isinstance(block, dict), f"{name} must be an object")
    n = block.get("count")
    _require(isinstance(n, int) and n >= 0, f"{name}.count must be >= 0")
    sites = block.get("sites")
    _require(isinstance(sites, list), f"{name}.sites must be a list")
    _require(len(sites) == n, f"{name}.sites does not match its count")
    for s in sites:
        _require(isinstance(s, dict) and isinstance(s.get(site_key), str),
                 f"{name} site missing {site_key!r}")
        w = s.get("where")
        _require(w is None or isinstance(w, str),
                 f"{name} site where must be a string or null")
    return n


def validate_graphs(sec: Dict[str, Any]) -> None:
    """Structural validation of a record's ``graphs`` section (additive
    scc-run-record v1 extension): per-program passports internally
    consistent, by_stage rows referencing real programs, totals summing
    to the passports."""
    _require(isinstance(sec, dict), "must be an object")
    _require(sec.get("version") == GRAPHS_VERSION,
             f"version must be {GRAPHS_VERSION}")
    programs = sec.get("programs")
    _require(isinstance(programs, dict), "programs must be an object")
    sums = {"transfer_ops": 0, "host_callbacks": 0, "donation_misses": 0,
            "fusions": 0}
    for name, p in programs.items():
        _require(isinstance(p, dict), f"programs[{name!r}] not an object")
        ops = p.get("ops")
        _require(isinstance(ops, int) and ops >= 0,
                 f"programs[{name!r}].ops must be >= 0")
        hist = p.get("op_histogram")
        _require(isinstance(hist, dict),
                 f"programs[{name!r}].op_histogram must be an object")
        _require(sum(hist.values()) == ops,
                 f"programs[{name!r}] histogram does not sum to ops")
        fus = p.get("fusions")
        _require(isinstance(fus, int) and fus >= 0,
                 f"programs[{name!r}].fusions must be >= 0")
        _require(fus == hist.get("fusion", 0),
                 f"programs[{name!r}].fusions disagrees with histogram")
        t = _validate_sites(f"programs[{name!r}].transfer_ops",
                            p.get("transfer_ops"), "op")
        c = _validate_sites(f"programs[{name!r}].host_callbacks",
                            p.get("host_callbacks"), "target")
        don = p.get("donation")
        _require(isinstance(don, dict),
                 f"programs[{name!r}].donation must be an object")
        for k in ("declared", "hits", "misses"):
            v = don.get(k)
            _require(isinstance(v, int) and v >= 0,
                     f"programs[{name!r}].donation.{k} must be >= 0")
        _require(don["hits"] + don["misses"] <= max(don["declared"],
                                                    don["hits"]),
                 f"programs[{name!r}].donation counts inconsistent")
        _require(isinstance(p.get("buffers"), dict),
                 f"programs[{name!r}].buffers must be an object")
        eo = p.get("entry_ordinal")
        _require(isinstance(eo, int) and eo >= 1,
                 f"programs[{name!r}].entry_ordinal must be >= 1")
        sums["transfer_ops"] += t
        sums["host_callbacks"] += c
        sums["donation_misses"] += don["misses"]
        sums["fusions"] += fus
    by_stage = sec.get("by_stage")
    _require(isinstance(by_stage, dict), "by_stage must be an object")
    listed: List[str] = []
    stage_sums = {"transfer_ops": 0, "host_callbacks": 0,
                  "donation_misses": 0}
    for stage, row in by_stage.items():
        _require(isinstance(row, dict), f"by_stage[{stage!r}] not an object")
        progs = row.get("programs")
        _require(isinstance(progs, list) and progs,
                 f"by_stage[{stage!r}].programs must be a non-empty list")
        for nm in progs:
            _require(nm in programs,
                     f"by_stage[{stage!r}] references unknown program {nm!r}")
            listed.append(nm)
        for k in stage_sums:
            v = row.get(k)
            _require(isinstance(v, int) and v >= 0,
                     f"by_stage[{stage!r}].{k} must be >= 0")
            stage_sums[k] += v
    _require(sorted(listed) == sorted(programs),
             "by_stage programs do not partition the program set")
    totals = sec.get("totals")
    _require(isinstance(totals, dict), "totals must be an object")
    _require(totals.get("programs") == len(programs),
             "totals.programs disagrees with the program set")
    for k, v in sums.items():
        _require(totals.get(k) == v, f"totals.{k} disagrees with passports")
    for k in stage_sums:
        _require(stage_sums[k] == sums[k],
                 f"by_stage {k} does not sum to totals")
    fp = sec.get("fingerprint")
    if fp is not None:
        _require(isinstance(fp, dict), "fingerprint must be an object")
        dig = fp.get("digest")
        _require(isinstance(dig, str) and len(dig) == 12,
                 "fingerprint.digest must be a 12-hex string")
        _require(dig == fingerprint_digest(fp),
                 "fingerprint.digest does not match its fields")
    errs = sec.get("errors")
    if errs is not None:
        _require(isinstance(errs, list)
                 and all(isinstance(e, str) for e in errs),
                 "errors must be a list of strings")
