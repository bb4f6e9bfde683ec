"""Scientific quality telemetry: what the pipeline computed, not only
where the time went.

The port's copy of ``scconsensus_tpu/obs/quality.py``:

  * **Numeric-health sentinels** (``SCC_OBS_NUMERIC``, off by default):
    NaN/Inf guards at stage boundaries. A trip records the stage, the
    array and the counts on the span's metrics and on the ``quality``
    section's ``numeric_health``, instead of letting a NaN reach the
    labels. Arrays where NaN is the legitimate untested marker (the
    (P, G) ``log_p``) pass their expected NaN count, so only an excess
    trips. On a CUDA tensor a check is one fused count of NaN and Inf
    and one device-to-host copy.

  * **Algorithm funnels**: the DE gate funnel (genes in → pct gate →
    logFC gate → tested → significant, per pair and in total), the
    rank-sum window ladder's occupancy, and the cluster structure
    (size histograms, contingency entropy and ARI against the input
    labeling, label churn across the deepSplit ladder, silhouettes).

  * **The ``quality`` section**, built by ``refine()``'s ``quality``
    stage into ``result.metrics["quality"]`` and checked by
    :func:`validate_quality`.

  * **Scenario scores** for the workload zoo (``workloads/``): the
    per-batch ARI and batch-mixing entropy of a multi-sample run, the
    final cut against named reference labelings (``ari_final_vs``), and
    :func:`validate_scenario_scores`, which :func:`validate_quality`
    applies to a ``quality.scenario`` block.

The cluster structure turns each labeling into integer codes once (one
bincount for integer labels, ``refine()`` passes the DE's codes of the
input) and takes every entropy, contingency and ARI from ``bincount``
tables of those codes: the numbers are the reference's, at a cost that
stays a small share of a 1M-cell run.

Every entry point adds its own wall to a module counter
(:func:`consumed_cpu_s`), which the < 2 % overhead guard reads. A device
check drains the card before its timed region opens, so the counter
holds the check and not the kernels queued before it.
"""

from __future__ import annotations

import logging
import time
import weakref
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from scconsensus_tpu_torch.config import env_flag
from scconsensus_tpu_torch.obs import trace as obs_trace

__all__ = [
    "FUNNEL_STAGES",
    "enabled",
    "check_array",
    "trips",
    "note_funnel",
    "numeric_health",
    "de_funnel",
    "wilcox_ladder",
    "occupancy_from_stage_records",
    "ari_final_vs",
    "cluster_structure",
    "per_batch_ari",
    "batch_mixing_entropy",
    "build_quality_section",
    "validate_quality",
    "validate_scenario_scores",
    "live_summary",
    "consumed_cpu_s",
    "reset_cpu",
]

_LOG = logging.getLogger("scconsensus_tpu")

# Canonical funnel order: counts must be monotone non-increasing along it.
# The pct/logFC gate stages exist only on the fast (Seurat-gated) path;
# slow-path and NB funnels carry input → tested → significant.
FUNNEL_STAGES = ("input", "pct_gate", "logfc_gate", "tested", "significant")


# --------------------------------------------------------------------------
# overhead accounting (the <2%-of-wall guard reads this)
# --------------------------------------------------------------------------

_CPU = {"s": 0.0}


def consumed_cpu_s() -> float:
    """Cumulative wall-clock spent inside quality computations in this
    process (sentinel checks included — their device fetch waits are real
    overhead and are charged here on purpose)."""
    return _CPU["s"]


def reset_cpu() -> None:
    _CPU["s"] = 0.0


@contextmanager
def _timed():
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _CPU["s"] += time.perf_counter() - t0


# --------------------------------------------------------------------------
# numeric-health sentinels
# --------------------------------------------------------------------------

def enabled() -> bool:
    """Sentinel master switch (``SCC_OBS_NUMERIC``). Off by default so
    library users pay zero extra device dispatches; bench workers and the
    long drivers default it on."""
    return bool(env_flag("SCC_OBS_NUMERIC"))


# Trips (and the latest funnel totals for the live quality panel) are
# keyed by tracer (weakref — a finished run's state must not outlive its
# span tree) with a bounded orphan sink for tracer-less use. Tracer
# scoping matters for the funnel too: a process-global "last funnel"
# would leak one section's funnel into the next section's heartbeats
# (bench runs edger → wilcox → probes in one process).
_TRIPS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_ORPHAN: Dict[str, Any] = {"checks": 0, "trips": []}
_TRIP_CAP = 64


def _sink(tracer=None) -> Dict[str, Any]:
    if tracer is None:
        tracer = obs_trace.current_tracer() or obs_trace.last_tracer()
    if tracer is None:
        return _ORPHAN
    sink = _TRIPS.get(tracer)
    if sink is None:
        sink = {"checks": 0, "trips": []}
        _TRIPS[tracer] = sink
    return sink


def trips(tracer=None) -> List[Dict[str, Any]]:
    """Sentinel trips recorded against ``tracer`` (default: the ambient /
    most recent tracer, falling back to the orphan list)."""
    return list(_sink(tracer)["trips"])


def note_funnel(totals: Dict[str, Any], tracer=None) -> None:
    """Record a run's latest DE-funnel totals against its tracer so the
    live heartbeat's quality panel can show them (the funnel lands once
    per run, late; the heartbeat wants the newest for THIS run only)."""
    _sink(tracer)["funnel"] = dict(totals)


def checks_run(tracer=None) -> int:
    return int(_sink(tracer)["checks"])


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def check_array(name: str, x, kinds: Sequence[str] = ("nan", "inf"),
                expected_nan=0, span=None, where: Optional[str] = None,
                ) -> Optional[Dict[str, Any]]:
    """Numeric-health check of one array at a stage boundary.

    No-op (and dispatch-free) when the sentinel flag is off. ``kinds``
    picks the guards; ``expected_nan`` is the count of LEGITIMATE NaNs
    (the untested-entry marker in ``log_p``) — host int or device scalar,
    fetched together with the counts in one transfer. Only an excess
    trips. A trip is recorded onto the innermost span's metrics
    (``numeric_nan``/``numeric_inf`` counters + a ``numeric_trips`` attrs
    list), the tracer's trip list, and the package logger — surfaced,
    never swallowed, and never fatal."""
    if not enabled() or x is None:
        return None
    if _is_tensor(x) and x.is_cuda:
        torch.cuda.synchronize(x.device)
    with _timed():
        try:
            if _is_tensor(x):
                if not torch.is_floating_point(x):
                    return None
                zero = torch.zeros((), dtype=torch.int64, device=x.device)
                nan_d = (torch.isnan(x).sum() if "nan" in kinds else zero)
                inf_d = (torch.isinf(x).sum() if "inf" in kinds else zero)
                exp_d = torch.as_tensor(expected_nan, device=x.device).to(
                    torch.int64).reshape(())
                # one fused count, one device-to-host copy
                nan_c, inf_c, exp_c = (int(v) for v in torch.stack(
                    (nan_d, inf_d, exp_d)).tolist())
                size = int(x.numel())
            else:
                xa = np.asarray(x)
                if not np.issubdtype(xa.dtype, np.floating):
                    return None
                nan_c = int(np.isnan(xa).sum()) if "nan" in kinds else 0
                inf_c = int(np.isinf(xa).sum()) if "inf" in kinds else 0
                exp_c = int(np.asarray(expected_nan))
                size = int(xa.size)
        except Exception as e:  # a guard must never kill the pipeline
            _LOG.warning("numeric sentinel %r failed: %r", name, e)
            return None
        sink = _sink(None)
        sink["checks"] += 1
        excess_nan = max(nan_c - exp_c, 0)
        if excess_nan == 0 and inf_c == 0:
            return None
        if span is None:
            span = obs_trace.current_span()
        span_name = where or (span.name if span is not None else "<no-span>")
        trip = {
            "span": span_name,
            "array": name,
            "nan": excess_nan,
            "inf": inf_c,
            "size": size,
        }
        if span is not None and span.span_id >= 0:
            try:
                span.metrics.counter("numeric_nan").add(excess_nan)
                span.metrics.counter("numeric_inf").add(inf_c)
                span.attrs.setdefault("numeric_trips", []).append(
                    {"array": name, "nan": excess_nan, "inf": inf_c}
                )
            except Exception:
                pass
        if len(sink["trips"]) < _TRIP_CAP:
            sink["trips"].append(trip)
        _LOG.warning(
            "NUMERIC SENTINEL: %s/%s has %d unexpected NaN, %d Inf "
            "(of %d elements)", span_name, name, excess_nan, inf_c, size,
        )
        return trip


def numeric_health(tracer=None) -> Dict[str, Any]:
    """The run record's ``quality.numeric_health`` section."""
    sink = _sink(tracer)
    return {
        "enabled": enabled(),
        "checks": int(sink["checks"]),
        "trips": list(sink["trips"]),
    }


# --------------------------------------------------------------------------
# DE gate funnel
# --------------------------------------------------------------------------

def _row_counts(mask) -> np.ndarray:
    """(P,) per-pair True counts of a (P, G) bool mask, host or device:
    only the (P,) result crosses."""
    if _is_tensor(mask):
        return mask.sum(dim=1).cpu().numpy().astype(np.int64)
    return np.asarray(mask).sum(axis=1).astype(np.int64)


def de_funnel(result, config) -> Optional[Dict[str, Any]]:
    """Gate funnel of one :class:`~scconsensus_tpu.de.engine.PairwiseDEResult`
    under its config: genes in → pct-gate → logFC-gate → tested →
    significant, per pair and aggregated. Reads the RAW (possibly still
    device-resident) result fields and fetches only (P,)-sized count
    vectors — the funnel must not force the (P, G) statistics through the
    slow link. Gate stages appear only when the fast-path pct arrays
    exist; slow/NB funnels are input → tested → significant.

    ``logfc_gate`` is the engine's LITERAL full gate battery (pct ∧
    mean-expression ∧ |logFC|) when the result carries the engine's
    count (``aux["funnel_gate_full"]``), so the tested-stage drop
    measures group-size skips only; on older stored results it degrades
    to a pct ∧ |logFC| recomputation (then the mean gate's rejections
    land in the tested drop)."""
    from scconsensus_tpu_torch.obs.residency import boundary

    # declared residency crossing: the funnel fetches ONLY (P,)-sized
    # count vectors — the allowlisted funnel_counts boundary
    with _timed(), boundary("funnel_counts"):
        tested = result.tested
        de_mask = result.de_mask
        P = int(len(result.pair_i))
        G = int(tested.shape[1])
        per_pair: Dict[str, np.ndarray] = {
            "input": np.full(P, G, np.int64),
        }
        pct1, pct2 = result.pct1, result.pct2
        if pct1 is not None and pct2 is not None:
            xp = torch if _is_tensor(pct1) else np
            alpha = xp.maximum(pct1, pct2)
            pct_gate = alpha > config.min_pct
            if config.min_diff_pct > -float("inf"):
                pct_gate = pct_gate & (
                    (alpha - xp.minimum(pct1, pct2)) > config.min_diff_pct
                )
            per_pair["pct_gate"] = _row_counts(pct_gate)
            gate_full = (result.aux or {}).get("funnel_gate_full")
            if gate_full is not None:
                if _is_tensor(gate_full):
                    gate_full = gate_full.cpu().numpy()
                per_pair["logfc_gate"] = np.asarray(
                    gate_full).astype(np.int64)
            else:
                log_fc = result.log_fc
                if config.only_pos:
                    fc_ok = log_fc > config.log_fc_thrs
                else:
                    fc_ok = xp.abs(log_fc) > config.log_fc_thrs
                per_pair["logfc_gate"] = _row_counts(pct_gate & fc_ok)
        per_pair["tested"] = _row_counts(tested)
        per_pair["significant"] = _row_counts(de_mask)
        total = {k: int(v.sum()) for k, v in per_pair.items()}
        out = {
            "n_pairs": P,
            "n_genes": G,
            "cluster_names": [str(n) for n in result.cluster_names],
            "pair_i": [int(v) for v in result.pair_i],
            "pair_j": [int(v) for v in result.pair_j],
            "per_pair": {k: [int(x) for x in v]
                         for k, v in per_pair.items()},
            "total": total,
        }
        note_funnel(total)
        return out


# --------------------------------------------------------------------------
# rank-sum window-ladder occupancy (SCC_WILCOX_PROBE payload, promoted)
# --------------------------------------------------------------------------

_LADDER_BUCKET_KEYS = (
    "window", "scan_width", "sort_width", "n_genes", "padded_rows",
    "real_elems", "padded_elems", "pad_ratio", "nnz_min", "nnz_max",
    "table_height", "overflow_genes", "wall_s", "sort_s",
)


def wilcox_ladder(occupancy: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Normalize an engine occupancy-probe payload into the schema's
    ``quality.wilcox_ladder`` section: the per-bucket rows plus the
    aggregate padded-vs-real accounting that makes the sparsity math
    visibly add up."""
    if not isinstance(occupancy, dict):
        return None
    with _timed():
        buckets = [
            {k: b.get(k) for k in _LADDER_BUCKET_KEYS if b.get(k) is not None}
            for b in occupancy.get("buckets") or []
            if isinstance(b, dict)
        ]
        real = sum(int(b.get("real_elems") or 0) for b in buckets)
        padded = sum(int(b.get("padded_elems") or 0) for b in buckets)
        out = {
            "windowed": bool(occupancy.get("windowed")),
            "input": occupancy.get("input"),
            "kernel": occupancy.get("kernel"),
            "n_genes": int(occupancy.get("n_genes") or 0),
            "n_cells": int(occupancy.get("n_cells") or 0),
            "window_floor": occupancy.get("window_floor"),
            "n_buckets": len(buckets),
            "genes_bucketed": sum(
                int(b.get("n_genes") or 0) for b in buckets
            ),
            "real_elems": real,
            "padded_elems": padded,
            "pad_ratio": round(padded / real, 3) if real else None,
            "overflow_genes": sum(
                int(b.get("overflow_genes") or 0) for b in buckets
            ),
            "buckets": buckets,
        }
        return out


def occupancy_from_stage_records(stage_records) -> Optional[Dict[str, Any]]:
    """The engine's occupancy probe, wherever a stage record carries it."""
    for rec in stage_records or []:
        if isinstance(rec, dict) and isinstance(rec.get("occupancy"), dict):
            return rec["occupancy"]
    return None


# --------------------------------------------------------------------------
# consensus / cluster structure
# --------------------------------------------------------------------------

def _entropy(counts: np.ndarray) -> float:
    p = counts[counts > 0].astype(np.float64)
    p /= p.sum()
    return float(-(p * np.log(p)).sum())


def _codes(x):
    """(codes, uniques, counts) of one labeling: each item's index into
    its sorted distinct values and each value's count, as ``np.unique(x,
    return_inverse=True, return_counts=True)`` gives them. Integer labels
    of a modest span (the cuts, the input as the DE coded it) take one
    bincount instead of a sort, and no remap when no value is missing."""
    a = np.asarray(x).ravel()
    if a.size and (a.dtype.kind == "i"
                   or (a.dtype.kind == "u" and a.dtype.itemsize < 8)):
        lo = int(a.min())
        span = int(a.max()) - lo + 1
        if span <= 2 * a.size + 1024:
            shifted = a.astype(np.intp, copy=False)
            if lo:
                shifted = shifted - lo
            counts = np.bincount(shifted, minlength=span)
            present = counts > 0
            if present.all():
                return shifted, np.arange(lo, lo + span), counts
            remap = np.cumsum(present) - 1
            return (remap[shifted], np.flatnonzero(present) + lo,
                    counts[present])
    uniq, inv, counts = np.unique(a, return_inverse=True,
                                  return_counts=True)
    return inv.ravel().astype(np.intp), uniq, counts


def _table(ac: np.ndarray, ka: int, bc: np.ndarray, kb: int) -> np.ndarray:
    """(ka, kb) int64 contingency table of two coded labelings."""
    joint = ac * kb
    joint += bc
    return np.bincount(joint, minlength=ka * kb).reshape(ka, kb)


def ari_final_vs(dynamic_labels: Dict[str, np.ndarray],
                 ref_labelings: Dict[str, Any]) -> Dict[str, float]:
    """ARI of the FINAL cut against named reference labelings (e.g. a
    bench run's two raw input labelings). The one implementation behind
    both :func:`cluster_structure` and a bench's post-hoc stamp — size-
    mismatched references are skipped, not crashed on."""
    from scconsensus_tpu_torch.obs.regress import adjusted_rand_index

    if not dynamic_labels or not ref_labelings:
        return {}
    final = np.asarray(dynamic_labels[list(dynamic_labels)[-1]])
    out: Dict[str, float] = {}
    for rname, rl in ref_labelings.items():
        rl = np.asarray(rl)
        if rl.size == final.size:
            out[str(rname)] = round(adjusted_rand_index(final, rl), 6)
    return out


def cluster_structure(dynamic_labels: Dict[str, np.ndarray],
                      deep_split_info: Optional[List[Dict]] = None,
                      input_labels=None,
                      ref_labelings: Optional[Dict[str, Any]] = None,
                      landmark: Optional[Dict[str, Any]] = None,
                      ) -> Dict[str, Any]:
    """Cluster-structure section: per-cut size histograms + silhouette,
    contingency entropy (Shannon, nats, of the joint distribution: low
    when the cut merely renames the input clusters) and ARI vs the input
    labeling, and label churn (ARI between consecutive deepSplit cuts).
    ``input_labels`` may be the labels or any integer coding of them.
    ``ref_labelings`` adds named extra references scored against the
    FINAL cut (``ari_final_vs``). ``landmark`` is the tree stage's landmark-approximation telemetry
    (k, sketch, per-cut landmark occupancy, ARI-vs-exact when a verify
    run computed it) — stamped verbatim so a landmark run record names
    its approximation."""
    from scconsensus_tpu_torch.obs.regress import ari_from_table

    with _timed():
        info_by_ds = {
            int(d.get("deep_split")): d for d in (deep_split_info or [])
            if isinstance(d, dict) and d.get("deep_split") is not None
        }
        inp = inp_counts = None
        if input_labels is not None:
            ic, iu, inp_counts = _codes(input_labels)
            inp = (ic, len(iu))
        cuts: List[Dict[str, Any]] = []
        ari_vs_input: Dict[str, float] = {}
        names = list(dynamic_labels)
        coded = {}
        for key in names:
            lab = np.asarray(dynamic_labels[key])
            lc, lu, counts = _codes(lab)
            coded[key] = (lc, len(lu))
            if np.issubdtype(lab.dtype, np.number):
                counts = counts[lu > 0]      # 0 = unassigned
            sizes = sorted((int(c) for c in counts), reverse=True)
            cut: Dict[str, Any] = {
                "cut": key,
                "n_clusters": len(sizes),
                "n_cells": int(lab.size),
                "n_unassigned": int(lab.size - int(counts.sum())),
                "sizes": sizes,
            }
            try:
                ds = int(str(key).rsplit(":", 1)[-1])
            except ValueError:
                ds = None
            d = info_by_ds.get(ds)
            if d and d.get("silhouette") is not None:
                cut["silhouette"] = float(d["silhouette"])
                if d.get("silhouette_method"):
                    cut["silhouette_method"] = d["silhouette_method"]
            if inp is not None and inp[0].size == lab.size:
                c = _table(*inp, *coded[key])
                cut["contingency_entropy"] = round(_entropy(c.ravel()), 6)
                ari_vs_input[key] = round(ari_from_table(c.T), 6)
            cuts.append(cut)
        churn = []
        for a, b in zip(names, names[1:]):
            if coded[a][0].size == coded[b][0].size:
                churn.append({
                    "from": a, "to": b,
                    "ari": round(ari_from_table(
                        _table(*coded[a], *coded[b])), 6),
                })
        out: Dict[str, Any] = {"cuts": cuts, "churn": churn}
        if landmark:
            out["landmark"] = dict(landmark)
        if ari_vs_input:
            out["ari_vs_input"] = ari_vs_input
        if inp is not None:
            out["input_entropy"] = round(_entropy(inp_counts), 6)
            out["n_input_clusters"] = int(inp[1])
        if ref_labelings and names:
            refs = ari_final_vs(dynamic_labels, ref_labelings)
            if refs:
                out["ari_final_vs"] = refs
        return out


# --------------------------------------------------------------------------
# scenario scoring (workload zoo)
# --------------------------------------------------------------------------

def per_batch_ari(final_labels, truth_labels, batches) -> Dict[str, float]:
    """ARI of the final cut against truth WITHIN each batch/sample.

    The multi-sample scenario's per-batch quality block: an integration
    that nails three samples and shreds the fourth must not hide behind
    a healthy pooled ARI. Keys are ``str(batch)``; a batch with fewer
    than 2 cells is skipped (ARI of a singleton is undefined, not 1)."""
    from scconsensus_tpu_torch.obs.regress import adjusted_rand_index

    with _timed():
        final = np.asarray(final_labels)
        truth = np.asarray(truth_labels)
        batches = np.asarray(batches)
        if not (final.size == truth.size == batches.size):
            raise ValueError(
                f"per_batch_ari: size mismatch (final={final.size}, "
                f"truth={truth.size}, batches={batches.size})"
            )
        out: Dict[str, float] = {}
        for b in np.unique(batches):
            sel = batches == b
            if int(sel.sum()) < 2:
                continue
            out[str(b)] = round(
                adjusted_rand_index(final[sel], truth[sel]), 6
            )
        return out


def batch_mixing_entropy(labels, batches) -> Dict[str, Any]:
    """Batch-composition entropy of every output cluster.

    For each cluster, the Shannon entropy (nats) of its cells' batch
    distribution; ``mean_norm_entropy`` is the cluster-size-weighted
    mean normalized by ``ln(n_batches)`` — 1.0 means every cluster is
    perfectly batch-mixed, 0.0 means every cluster is single-batch (the
    batch effect became the clustering). One contingency table of
    (cluster, batch) codes gives every cluster's counts."""
    with _timed():
        labels = np.asarray(labels)
        batches = np.asarray(batches)
        if labels.size != batches.size:
            raise ValueError(
                f"batch_mixing_entropy: size mismatch "
                f"(labels={labels.size}, batches={batches.size})"
            )
        ub, bi = np.unique(batches, return_inverse=True)
        n_batches = int(ub.size)
        uc, ci = np.unique(labels, return_inverse=True)
        table = _table(ci.ravel(), int(uc.size), bi.ravel(), n_batches)
        per_cluster: Dict[str, Dict[str, Any]] = {}
        wsum, n_tot = 0.0, 0
        for c, counts in zip(uc, table):
            ent = _entropy(counts)
            n = int(counts.sum())
            per_cluster[str(c)] = {"entropy": round(ent, 6), "n": n}
            wsum += ent * n
            n_tot += n
        denom = float(np.log(n_batches)) if n_batches > 1 else 1.0
        mean_norm = (wsum / n_tot / denom) if n_tot else 0.0
        return {
            "n_batches": n_batches,
            "per_cluster": per_cluster,
            "mean_norm_entropy": round(float(mean_norm), 6),
        }


# --------------------------------------------------------------------------
# assembly + validation
# --------------------------------------------------------------------------

def build_quality_section(de_result=None, config=None,
                          dynamic_labels=None, deep_split_info=None,
                          input_labels=None, ref_labelings=None,
                          occupancy=None, landmark=None,
                          tracer=None) -> Dict[str, Any]:
    """One ``quality`` section from whatever the run computed — every
    sub-section optional, numeric health always present."""
    q: Dict[str, Any] = {}
    if de_result is not None and config is not None:
        f = de_funnel(de_result, config)
        if f:
            q["de_funnel"] = f
    if occupancy is not None:
        lad = wilcox_ladder(occupancy)
        if lad:
            q["wilcox_ladder"] = lad
    if dynamic_labels:
        q["cluster_structure"] = cluster_structure(
            dynamic_labels, deep_split_info, input_labels, ref_labelings,
            landmark=landmark,
        )
    q["numeric_health"] = numeric_health(tracer)
    return q


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"quality section: {msg}")


def validate_scenario_scores(s: Dict[str, Any]) -> None:
    """Structural validation of a ``quality.scenario`` scoring block
    (the workload zoo's per-scenario quality evidence). Raises
    ValueError on the first violation; :func:`validate_quality` calls
    this, so a scenario record is held to the same standard as every
    other quality field."""
    _require(isinstance(s, dict), "scenario must be an object")
    name = s.get("name")
    _require(isinstance(name, str) and bool(name),
             "scenario.name must be a non-empty string")
    metrics = s.get("metrics")
    _require(isinstance(metrics, dict) and bool(metrics),
             "scenario.metrics must be a non-empty object")
    for k, v in metrics.items():
        _require(isinstance(v, (int, float)) and not isinstance(v, bool)
                 and np.isfinite(v),
                 f"scenario.metrics[{k!r}] must be a finite number")
    pba = s.get("per_batch_ari")
    if pba is not None:
        _require(isinstance(pba, dict) and bool(pba),
                 "scenario.per_batch_ari must be a non-empty object")
        for k, v in pba.items():
            _require(isinstance(v, (int, float))
                     and -1.0 - 1e-9 <= v <= 1.0 + 1e-9,
                     f"scenario.per_batch_ari[{k!r}] must be an ARI "
                     "in [-1, 1]")
    bm = s.get("batch_mixing")
    if bm is not None:
        _require(isinstance(bm, dict), "scenario.batch_mixing must be "
                 "an object")
        nb = bm.get("n_batches")
        _require(isinstance(nb, int) and nb >= 2,
                 "scenario.batch_mixing.n_batches must be an int >= 2")
        mne = bm.get("mean_norm_entropy")
        _require(isinstance(mne, (int, float))
                 and -1e-9 <= mne <= 1.0 + 1e-9,
                 "scenario.batch_mixing.mean_norm_entropy must be in "
                 "[0, 1]")
        pc = bm.get("per_cluster")
        _require(isinstance(pc, dict) and bool(pc),
                 "scenario.batch_mixing.per_cluster must be a non-empty "
                 "object")
        for k, v in pc.items():
            _require(isinstance(v, dict)
                     and isinstance(v.get("entropy"), (int, float))
                     and v["entropy"] >= -1e-9
                     and isinstance(v.get("n"), int) and v["n"] > 0,
                     f"scenario.batch_mixing.per_cluster[{k!r}] needs "
                     "entropy >= 0 and n > 0")
    # a multi-sample block must carry BOTH halves: a per-batch ARI with
    # no mixing evidence (or vice versa) is half an integration claim
    _require((pba is None) == (bm is None),
             "scenario blocks with batch evidence must carry both "
             "per_batch_ari and batch_mixing")


def validate_quality(q: Dict[str, Any]) -> None:
    """Structural validation of a record's ``quality`` section (the
    additive schema-v1 extension). Raises ValueError on the first
    violation; ``export.validate_run_record`` calls this, so 'schema-
    valid' covers quality fields everywhere it covers spans."""
    _require(isinstance(q, dict), "must be an object")
    f = q.get("de_funnel")
    if f is not None:
        _require(isinstance(f, dict), "de_funnel must be an object")
        total = f.get("total")
        _require(isinstance(total, dict) and total,
                 "de_funnel.total must be a non-empty object")
        stages = [s for s in FUNNEL_STAGES if s in total]
        _require("input" in stages and "significant" in stages,
                 "de_funnel.total needs at least input and significant")
        for s in total:
            _require(s in FUNNEL_STAGES,
                     f"unknown funnel stage {s!r}")
            v = total[s]
            _require(isinstance(v, (int, float)) and v >= 0,
                     f"de_funnel.total.{s} must be a count >= 0")
        for a, b in zip(stages, stages[1:]):
            _require(total[a] >= total[b],
                     f"funnel not monotone: total.{a}={total[a]} < "
                     f"total.{b}={total[b]}")
        pp = f.get("per_pair")
        if pp is not None:
            _require(isinstance(pp, dict), "de_funnel.per_pair must be "
                     "an object")
            n_pairs = f.get("n_pairs")
            for s, vals in pp.items():
                _require(s in FUNNEL_STAGES,
                         f"unknown per_pair funnel stage {s!r}")
                _require(isinstance(vals, list),
                         f"per_pair.{s} must be a list")
                if isinstance(n_pairs, int):
                    _require(len(vals) == n_pairs,
                             f"per_pair.{s} has {len(vals)} entries, "
                             f"n_pairs={n_pairs}")
                if s in total:
                    _require(sum(vals) == total[s],
                             f"per_pair.{s} sums to {sum(vals)}, "
                             f"total.{s}={total[s]}")
            pstages = [s for s in FUNNEL_STAGES if s in pp]
            for a, b in zip(pstages, pstages[1:]):
                for i, (va, vb) in enumerate(zip(pp[a], pp[b])):
                    _require(va >= vb,
                             f"funnel not monotone at pair {i}: "
                             f"{a}={va} < {b}={vb}")
    cs = q.get("cluster_structure")
    if cs is not None:
        _require(isinstance(cs, dict), "cluster_structure must be an "
                 "object")
        _require(isinstance(cs.get("cuts"), list),
                 "cluster_structure.cuts must be a list")
        for i, cut in enumerate(cs["cuts"]):
            _require(isinstance(cut, dict), f"cuts[{i}] is not an object")
            _require(isinstance(cut.get("n_clusters"), int)
                     and cut["n_clusters"] >= 0,
                     f"cuts[{i}].n_clusters must be an int >= 0")
            sizes = cut.get("sizes")
            _require(isinstance(sizes, list)
                     and len(sizes) == cut["n_clusters"],
                     f"cuts[{i}].sizes must list one size per cluster")
            _require(all(isinstance(s, int) and s >= 0 for s in sizes),
                     f"cuts[{i}].sizes must be counts >= 0")
        for key in ("ari_vs_input", "ari_final_vs"):
            d = cs.get(key)
            if d is not None:
                _require(isinstance(d, dict), f"{key} must be an object")
                for k, v in d.items():
                    _require(isinstance(v, (int, float))
                             and -1.0 - 1e-9 <= v <= 1.0 + 1e-9,
                             f"{key}[{k!r}] must be an ARI in [-1, 1]")
        lm = cs.get("landmark")
        if lm is not None:
            _require(isinstance(lm, dict), "landmark must be an object")
            _require(isinstance(lm.get("k"), int) and lm["k"] >= 2,
                     "landmark.k must be an int >= 2")
            _require(isinstance(lm.get("branch"), str) and lm["branch"],
                     "landmark.branch must be a non-empty string")
            # A landmark run is an APPROXIMATION — its record must score
            # the cut against the input labeling or it carries no evidence
            # the approximation held (the r7 accuracy-pin contract; the
            # perf gate rejects records that skip it).
            ari = cs.get("ari_vs_input")
            _require(isinstance(ari, dict) and bool(ari),
                     "landmark run must carry cluster_structure."
                     "ari_vs_input (the approximation's accuracy "
                     "evidence)")
            ave = lm.get("ari_vs_exact")
            if ave is not None:
                _require(isinstance(ave, dict), "landmark.ari_vs_exact "
                         "must be an object")
                for k, v in ave.items():
                    if v is not None:
                        _require(isinstance(v, (int, float))
                                 and -1.0 - 1e-9 <= v <= 1.0 + 1e-9,
                                 f"landmark.ari_vs_exact[{k!r}] must be "
                                 "an ARI in [-1, 1]")
            occ = lm.get("occupancy")
            if occ is not None:
                _require(isinstance(occ, dict), "landmark.occupancy must "
                         "be an object")
                for k, v in occ.items():
                    _require(
                        isinstance(v, dict)
                        and isinstance(v.get("landmarks_assigned"), int)
                        and isinstance(v.get("n_landmarks"), int)
                        and 0 <= v["landmarks_assigned"] <= v["n_landmarks"],
                        f"landmark.occupancy[{k!r}] needs "
                        "landmarks_assigned <= n_landmarks",
                    )
    nh = q.get("numeric_health")
    if nh is not None:
        _require(isinstance(nh, dict), "numeric_health must be an object")
        _require(isinstance(nh.get("trips", []), list),
                 "numeric_health.trips must be a list")
        for i, t in enumerate(nh.get("trips", [])):
            _require(isinstance(t, dict), f"trips[{i}] is not an object")
            for k in ("span", "array"):
                _require(isinstance(t.get(k), str) and t[k],
                         f"trips[{i}].{k} must be a non-empty string")
            for k in ("nan", "inf"):
                _require(isinstance(t.get(k, 0), int) and t.get(k, 0) >= 0,
                         f"trips[{i}].{k} must be an int >= 0")
    sc = q.get("scenario")
    if sc is not None:
        validate_scenario_scores(sc)
    lad = q.get("wilcox_ladder")
    if lad is not None:
        _require(isinstance(lad, dict), "wilcox_ladder must be an object")
        _require(isinstance(lad.get("buckets", []), list),
                 "wilcox_ladder.buckets must be a list")
        for i, b in enumerate(lad.get("buckets", [])):
            _require(isinstance(b, dict)
                     and isinstance(b.get("window"), int)
                     and isinstance(b.get("n_genes"), int),
                     f"wilcox_ladder.buckets[{i}] needs int window/"
                     "n_genes")


# --------------------------------------------------------------------------
# live view (heartbeat quality panel)
# --------------------------------------------------------------------------

def live_summary(tracer=None) -> Optional[Dict[str, Any]]:
    """Compact quality snapshot for one heartbeat tick: sentinel trip
    count (+ the newest trip) and the latest DE funnel totals. None when
    there is nothing to say — the stream stays lean on healthy runs that
    have not reached the funnel yet."""
    sink = _sink(tracer)
    out: Dict[str, Any] = {}
    if sink["trips"]:
        out["trips"] = len(sink["trips"])
        out["last_trip"] = dict(sink["trips"][-1])
    if sink.get("funnel"):
        out["funnel"] = dict(sink["funnel"])
    return out or None
