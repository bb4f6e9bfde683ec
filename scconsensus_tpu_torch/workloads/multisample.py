"""Scenario runner: multi-sample batch-effect consensus.

The port of ``scconsensus_tpu/workloads/multisample.py``.

Cells are drawn from S samples whose raw counts carry per-sample
technical confounds (``workloads.data.multi_sample_dataset``); the
consensus layer gets the paper's supervised/unsupervised pair in its
multi-sample form — ONE truth-aligned supervised labeling (a FACS-style
annotation shared across samples) × one UNALIGNED per-sample clustering
(``workloads.labelings.per_sample_unsupervised``: cluster ids are
sample-local, so the contingency grammar has to reconcile them). The
scenario's scoring block is the integration evidence the anchor configs
cannot produce: per-batch ARI (a sample the refinement shredded cannot
hide behind the pooled number) and batch-mixing entropy (an output
clustering that IS the batch structure scores ~0 mixing).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

__all__ = ["run", "multi_sample_inputs", "multi_sample_scores"]


def multi_sample_scores(final, truth, batches) -> Dict[str, Any]:
    """The multi-sample ``quality.scenario`` scoring block — ONE
    assembly shared by the scenario runner and the soak worker
    (``workloads.soak``), so the kill-resume evidence replays exactly
    the scoring the scenario records."""
    from scconsensus_tpu_torch.obs.quality import (
        batch_mixing_entropy,
        per_batch_ari,
    )
    from scconsensus_tpu_torch.obs.regress import adjusted_rand_index

    pba = per_batch_ari(final, truth, batches)
    bme = batch_mixing_entropy(final, batches)
    pba_vals = list(pba.values())
    return {
        "name": "multi_sample",
        "metrics": {
            "ari_pooled": round(adjusted_rand_index(final, truth), 6),
            "per_batch_ari_mean": round(float(np.mean(pba_vals)), 6),
            "per_batch_ari_min": round(float(np.min(pba_vals)), 6),
            "batch_mixing_mean_norm_entropy": bme["mean_norm_entropy"],
        },
        "per_batch_ari": pba,
        "batch_mixing": bme,
    }


def multi_sample_inputs(params: Dict[str, Any]):
    """Dataset + consensus-input construction — ONE recipe shared by
    the scenario runner and the soak worker (``workloads.soak``),
    like :func:`multi_sample_scores`, so the kill-resume evidence
    replays exactly the inputs the scenario builds. Returns
    ``(data, truth, batches, uns, consensus)``."""
    from scconsensus_tpu_torch.utils.synthetic import noisy_labeling
    from scconsensus_tpu_torch.workloads.common import consensus_of
    from scconsensus_tpu_torch.workloads.data import multi_sample_dataset
    from scconsensus_tpu_torch.workloads.labelings import per_sample_unsupervised

    seed = int(params.get("seed", 7))
    data, truth, batches = multi_sample_dataset(
        n_cells=int(params["n_cells"]),
        n_genes=int(params["n_genes"]),
        n_clusters=int(params["n_clusters"]),
        n_samples=int(params["n_samples"]),
        seed=seed,
    )
    sup = noisy_labeling(truth, 0.05, seed=seed + 1, prefix="sup")
    uns = per_sample_unsupervised(truth, batches, seed=seed)
    return data, truth, batches, uns, consensus_of(sup, uns)


def run(params: Dict[str, Any], smoke: bool = False,
        workdir: Optional[str] = None, device=None):
    from scconsensus_tpu_torch.workloads.common import (
        final_labels,
        outcome_from_result,
        refine_consensus,
    )

    seed = int(params.get("seed", 7))
    data, truth, batches, uns, consensus = multi_sample_inputs(params)
    elapsed, result = refine_consensus(data, consensus, smoke, seed=seed,
                                       device=device)

    final = final_labels(result)
    scores = multi_sample_scores(final, truth, batches)
    n_final = len(set(final[final > 0].tolist()))
    return outcome_from_result(
        "multi_sample", params, smoke, elapsed, result, scores,
        metric=(f"{int(params['n_cells']) // 1000}k-cell "
                f"{params['n_samples']}-sample batch-effect consensus "
                "wall-clock"),
        value=round(elapsed, 3), unit="seconds",
        extra={"n_final_clusters": n_final,
               "n_input_sample_clusters": len(set(uns.tolist()))},
    )
