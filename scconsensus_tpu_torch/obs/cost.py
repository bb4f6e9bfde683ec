"""Cost attribution: FLOPs, bytes and transcendentals on spans.

The port's form of ``scconsensus_tpu/obs/cost.py``. The reference asks
XLA's static model of a compiled program; the port has no compiled
program, so :func:`cost_analysis_of` runs the callable once on fake
tensors of the call's exact shapes (``FakeTensorMode``: every operator
dispatches, no kernel runs) under two dispatch modes and counts what
eager execution would do:

  * ``flops`` — ``torch.utils.flop_counter.FlopCounterMode``: the
    multiply-adds of the matrix products (``mm``, ``bmm``, ``addmm``,
    convolutions, attention), two FLOPs each; elementwise work is not
    priced, as the counter prices none;
  * ``bytes_accessed`` — for every aten operator that is not a view, the
    bytes of its tensor inputs plus its tensor outputs. In eager mode
    every such operator reads its inputs from and writes its outputs to
    device memory, so the sum is the traffic the call makes (an upper
    bound of what a fused program would move);
  * ``transcendentals`` — the output elements of ``exp``, ``log``,
    ``sqrt``, ``erf`` and the like.

The counted run is made once per (callable, abstract signature) and
memoized process-wide, as the reference memoizes its AOT compile; it
launches nothing on the card, so a cost-on run keeps the unobserved
run's results and its device time. A callable whose shapes depend on its
values (``nonzero``, ``.item()``) cannot run on fake tensors and, as in
the reference, records nothing. Everything is gated behind
``SCC_OBS_COST``: unset, nothing is counted. The span attribute keeps the reference's key ``xla_cost`` so the
two packages' records feed the same summaries.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from scconsensus_tpu_torch.config import env_flag

__all__ = [
    "cost_enabled",
    "cost_analysis_of",
    "attach_cost",
    "stage_cost_summary",
]

# (callable key, abstract signature) -> {"flops": ..., ...} | None
_COST_CACHE: Dict[Any, Optional[Dict[str, float]]] = {}

# aten operators whose outputs count as transcendentals
_TRANSCENDENTAL = frozenset({
    "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "sqrt",
    "rsqrt", "pow", "tanh", "sigmoid", "erf", "erfc", "erfinv", "sin",
    "cos", "tan", "atan2", "lgamma", "digamma", "special_ndtr",
    "special_ndtri", "special_log_ndtr", "special_erfcx",
})


def cost_enabled() -> bool:
    return bool(env_flag("SCC_OBS_COST"))


def _abstract(x: Any) -> Any:
    """Hashable signature element: tensors and arrays by shape, dtype and
    device, scalars by value, sequences element by element."""
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        return ("arr", tuple(int(s) for s in shape), str(dtype),
                str(getattr(x, "device", "")))
    if isinstance(x, (int, float, bool, str, type(None))):
        return ("val", x)
    if isinstance(x, (list, tuple)):
        return ("seq", tuple(_abstract(e) for e in x))
    return ("repr", repr(x))


def _count(fn, args, kwargs) -> Dict[str, float]:
    """One run of ``fn`` on fake tensors of the call's shapes, under the
    FLOP counter and the byte tally: the operators dispatch, no kernel
    runs and no result is computed."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves, tree_map
    from torch.utils.flop_counter import FlopCounterMode

    tally = {"bytes_accessed": 0.0, "transcendentals": 0.0}

    def nb(t) -> int:
        return int(t.numel()) * int(t.element_size())

    class _Bytes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            outs = [o for o in tree_leaves(out)
                    if isinstance(o, torch.Tensor)]
            # views move nothing; an operator with no tensor out is a
            # metadata query (the fake tensors' prim.device)
            if outs and not getattr(func, "is_view", False):
                ins = [a for a in tree_leaves((args, kwargs or {}))
                       if isinstance(a, torch.Tensor)]
                tally["bytes_accessed"] += sum(nb(t) for t in ins + outs)
                base = func.overloadpacket.__name__.rstrip("_")
                if base in _TRANSCENDENTAL:
                    tally["transcendentals"] += sum(o.numel() for o in outs)
            return out

    fake = FakeTensorMode(allow_non_fake_inputs=True)
    args, kwargs = tree_map(
        lambda x: fake.from_tensor(x) if isinstance(x, torch.Tensor) else x,
        (args, kwargs))
    flops = FlopCounterMode(display=False)
    with torch.no_grad(), fake, flops, _Bytes():
        fn(*args, **kwargs)
    return {"flops": float(flops.get_total_flops()), **tally}


def cost_analysis_of(fn, *args, **kwargs) -> Optional[Dict[str, float]]:
    """Cost counts for ``fn(*args, **kwargs)``; None when counting fails.
    Memoized per abstract signature, so only the first call at a shape
    pays the counted run."""
    try:
        key = (
            getattr(fn, "__wrapped__", None) or id(fn),
            tuple(_abstract(a) for a in args),
            tuple(sorted((k, _abstract(v)) for k, v in kwargs.items())),
        )
        hash(key)
    except TypeError:
        key = None
    if key is not None and key in _COST_CACHE:
        return _COST_CACHE[key]
    try:
        out: Optional[Dict[str, float]] = _count(fn, args, kwargs)
    except Exception:
        out = None
    if key is not None:
        _COST_CACHE[key] = out
    return out


def attach_cost(span, fn, *args, **kwargs) -> Optional[Dict[str, float]]:
    """Accumulate the call's cost counts onto ``span.attrs["xla_cost"]``
    (ambient span when ``span`` is None). No-op unless SCC_OBS_COST is on —
    instrumentation sites call this unconditionally, like obs.trace.span."""
    if not cost_enabled():
        return None
    if span is None:
        from scconsensus_tpu_torch.obs.trace import current_span

        span = current_span()
        if span is None:
            return None
    ca = cost_analysis_of(fn, *args, **kwargs)
    if not ca:
        return None
    cur = span.attrs.setdefault(
        "xla_cost", {"flops": 0.0, "bytes_accessed": 0.0,
                     "transcendentals": 0.0, "kernels": 0},
    )
    for k, v in ca.items():
        cur[k] = cur.get(k, 0.0) + v
    cur["kernels"] += 1
    return ca


def _span_cost(s: Dict[str, Any]) -> Optional[Dict[str, float]]:
    attrs = s.get("attrs") or {}
    c = attrs.get("xla_cost")
    return c if isinstance(c, dict) else None


def stage_cost_summary(spans: List[Dict[str, Any]]) -> Dict[str, Dict]:
    """Per-stage achieved-vs-cost-model throughput from a span-record tree.

    For every stage-kind span, sums ``xla_cost`` over the span itself and
    all descendants, divides by the stage's headline wall (synced when
    recorded) and aggregates repeated stages by name. Returns
    ``{stage: {flops, bytes_accessed, transcendentals, kernels, wall_s,
    achieved_gflops, achieved_gbps}}`` — stages with no costed calls are
    omitted, so an empty dict means "no attribution ran", never zeros.
    """
    by_id = {s.get("span_id"): s for s in spans if isinstance(s, dict)}
    children: Dict[Any, List[Dict[str, Any]]] = {}
    for s in by_id.values():
        children.setdefault(s.get("parent_id"), []).append(s)

    def _subtree_cost(s) -> Dict[str, float]:
        tot = {"flops": 0.0, "bytes_accessed": 0.0,
               "transcendentals": 0.0, "kernels": 0}
        stack = [s]
        while stack:
            cur = stack.pop()
            c = _span_cost(cur)
            if c:
                for k in tot:
                    tot[k] += c.get(k, 0)
            stack.extend(children.get(cur.get("span_id"), []))
        return tot

    out: Dict[str, Dict] = {}
    for s in by_id.values():
        if s.get("kind") != "stage":
            continue
        cost = _subtree_cost(s)
        if not cost["kernels"]:
            continue
        wall = s.get("wall_synced_s")
        if wall is None:
            wall = s.get("wall_submitted_s") or 0.0
        agg = out.setdefault(
            s["name"],
            {"flops": 0.0, "bytes_accessed": 0.0, "transcendentals": 0.0,
             "kernels": 0, "wall_s": 0.0},
        )
        for k in ("flops", "bytes_accessed", "transcendentals", "kernels"):
            agg[k] += cost[k]
        agg["wall_s"] += float(wall)
    for name, agg in out.items():
        w = agg["wall_s"]
        agg["wall_s"] = round(w, 4)
        if w > 0:
            agg["achieved_gflops"] = round(agg["flops"] / w / 1e9, 3)
            agg["achieved_gbps"] = round(agg["bytes_accessed"] / w / 1e9, 3)
    return out
