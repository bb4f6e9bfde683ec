"""Shared runner machinery for the scenario modules.

The port of ``scconsensus_tpu/workloads/common.py``. Every scenario
runner does the same spine — build input labelings, chain them through
the paper's contingency consensus, run the fast refine, and fold the
result's metrics (quality / residency / spans / robustness) into a
:class:`~scconsensus_tpu_torch.workloads.ScenarioOutcome`. This module
owns that spine so four runners cannot drift apart on how they call the
pipeline or assemble evidence.

The device pieces (k-means labeling, PCA embed) run on ``device`` (the
card by default) with their upload and their O(N) result fetch under the
declared ``workload_inputs`` residency boundary.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = [
    "consensus_of",
    "kmeans_labeling",
    "refine_consensus",
    "final_labels",
    "outcome_from_result",
]


def consensus_of(*labelings):
    """Chain ``plot_contingency_table`` across 2+ labelings (3-way
    consensus is consensus(consensus(l1, l2), l3))."""
    from scconsensus_tpu_torch.consensus.contingency import (
        plot_contingency_table,
    )

    out = labelings[0]
    for nxt in labelings[1:]:
        out = plot_contingency_table(out, nxt, filename=None)
    return out


def kmeans_labeling(x: np.ndarray, k: int, seed: int = 0,
                    n_iter: int = 12, prefix: str = "k",
                    device=None) -> np.ndarray:
    """Deterministic device k-means labeling of the rows of ``x``.

    The reference's seeded center init (distinct random rows), the
    blocked Lloyd the landmark recluster uses (``ops.pooling._lloyd``),
    then one assignment pass over the final centers: the reference's
    ``_lloyd`` returns the assignment taken after its last update, the
    port's only the centers. Only the (N,) int assignment crosses to the
    host. Returns string labels ``f"{prefix}{cid}"``.
    """
    import torch

    from scconsensus_tpu_torch.device import as_points
    from scconsensus_tpu_torch.obs.residency import boundary
    from scconsensus_tpu_torch.ops.pooling import (
        _assign,
        _lloyd,
        _lloyd_argmin,
    )

    n = int(x.shape[0])
    k = int(min(k, n))
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x4B]))
    init_idx = rng.choice(n, size=k, replace=False)
    with boundary("workload_inputs"):
        xd = as_points(x, device)
        init = torch.as_tensor(init_idx, dtype=torch.long, device=xd.device)
        cent = _lloyd(xd, xd[init], n_iter=n_iter)
        assign_h = _assign(xd, cent, _lloyd_argmin).cpu().numpy()
    return np.array([f"{prefix}{int(c)}" for c in assign_h])


def pca_embed(data: np.ndarray, n_pcs: int, seed: int = 0,
              omega=None, device=None) -> np.ndarray:
    """(N, n_pcs) rSVD-PCA scores of a (G, N) expression matrix — the
    same ``ops.pca`` path the pipeline's embed stage uses. ``omega``
    (G, k): the random projection to use instead of the port's own draw
    (``carry.omega_from_reference`` hands over the reference's
    ``PRNGKey(seed)`` draw)."""
    from scconsensus_tpu_torch.device import as_points
    from scconsensus_tpu_torch.obs.residency import boundary
    from scconsensus_tpu_torch.ops.pca import pca_scores

    cells = np.asarray(data, np.float32).T
    n_pcs = int(min(n_pcs, cells.shape[1], max(2, cells.shape[0] - 1)))
    with boundary("workload_inputs"):
        xd = as_points(cells, device)
        return pca_scores(xd, n_pcs, seed=seed,
                          omega=omega).cpu().numpy()


def refine_consensus(data: np.ndarray, consensus, smoke: bool,
                     seed: int = 7, device=None, **kw):
    """The zoo's one refine call: fast-path wilcox with scenario-sized
    settings (smoke keeps the deepSplit ladder short so all four
    scenarios fit the tier-1 pytest lane). ``kw`` goes through to
    ``recluster_de_consensus_fast`` (``omega`` among it). Returns
    (elapsed_s, result).
    """
    from scconsensus_tpu_torch.models.pipeline import (
        recluster_de_consensus_fast,
    )

    args: Dict[str, Any] = dict(
        method="wilcox", q_val_thrs=0.1, log_fc_thrs=0.25,
        min_cluster_size=10, number_top_de_genes=20,
        deep_split_values=(1, 2) if smoke else (1, 2, 3, 4),
        random_seed=seed,
    )
    args.update(kw)
    t0 = time.perf_counter()
    result = recluster_de_consensus_fast(data, consensus, device=device,
                                         **args)
    return time.perf_counter() - t0, result


def final_labels(result) -> np.ndarray:
    """The last deepSplit cut — the labeling every scenario scores."""
    return np.asarray(
        result.dynamic_labels[list(result.dynamic_labels)[-1]]
    )


def outcome_from_result(name: str, params: Dict[str, Any], smoke: bool,
                        elapsed_s: float, result,
                        scenario_scores: Dict[str, Any],
                        metric: str, value: float, unit: str,
                        extra: Optional[Dict[str, Any]] = None,
                        serving: Optional[Dict[str, Any]] = None,
                        spans: Optional[List[Dict[str, Any]]] = None):
    """Fold a refine result + scenario scoring block into one
    ScenarioOutcome: the pipeline's own quality section gains the
    ``scenario`` block (validated by obs.quality), the top-level
    ``scenario`` record section carries the shape identity."""
    from scconsensus_tpu_torch.obs.quality import validate_scenario_scores
    from scconsensus_tpu_torch.workloads import (
        ScenarioOutcome,
        build_scenario_section,
    )

    scenario_scores = dict(scenario_scores)
    scenario_scores.setdefault("name", name)
    validate_scenario_scores(scenario_scores)
    metrics = (result.metrics or {}) if result is not None else {}
    quality = dict(metrics.get("quality") or {})
    quality["scenario"] = scenario_scores
    ex = dict(extra or {})
    ex["elapsed_s"] = round(float(elapsed_s), 3)
    return ScenarioOutcome(
        name=name,
        metric=metric,
        value=value,
        unit=unit,
        scenario=build_scenario_section(name, params, smoke),
        extra=ex,
        spans=(spans if spans is not None
               else list(metrics.get("spans") or [])),
        quality=quality,
        serving=serving,
        robustness=metrics.get("robustness"),
        integrity=metrics.get("integrity"),
        residency=metrics.get("residency"),
        kernels=metrics.get("kernels"),
    )
