"""Scenario runner: topology-based unsupervised consensus input.

The port of ``scconsensus_tpu/workloads/topo_scenario.py``.

The Two-Tier-Mapper-style cover-and-cluster labeler
(``workloads.topology``) supplies the unsupervised half of the paper's
pair — a labeling derived from data *geometry* (overlapping cover →
local two-means → nerve components), not from a truth perturbation.
The runner also REPLAYS the topology clusterer on the same embedding
and records whether the two labelings are identical: the labeler is a
pure function of its inputs by contract, and the scenario record
carries that claim as measured evidence (``topo_replay_identical``),
with the cross-shape angle covered by the soak worker's ``--topo``
mode (``workloads.soak``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

__all__ = ["run"]


def run(params: Dict[str, Any], smoke: bool = False,
        workdir: Optional[str] = None, device=None):
    from scconsensus_tpu_torch.obs.regress import adjusted_rand_index
    from scconsensus_tpu_torch.utils.synthetic import (
        noisy_labeling,
        synthetic_scrna,
    )
    from scconsensus_tpu_torch.workloads.common import (
        consensus_of,
        final_labels,
        outcome_from_result,
        pca_embed,
        refine_consensus,
    )
    from scconsensus_tpu_torch.workloads.topology import topology_cluster

    seed = int(params.get("seed", 7))
    n_clusters = int(params["n_clusters"])
    n_covers = int(params["n_covers"])
    data, truth, _ = synthetic_scrna(
        n_genes=int(params["n_genes"]), n_cells=int(params["n_cells"]),
        n_clusters=n_clusters,
        n_markers_per_cluster=min(
            40, int(params["n_genes"]) // max(n_clusters, 1)),
        seed=seed, log_normalize=True,
    )
    sup = noisy_labeling(truth, 0.05, seed=seed + 1, prefix="sup")
    # embed once, cluster twice: the replay prices only the topology
    # labeler, not the shared PCA
    emb = pca_embed(data, n_pcs=10, seed=seed, device=device)
    topo = topology_cluster(emb, n_covers=n_covers, seed=seed,
                            device=device)
    topo_again = topology_cluster(emb, n_covers=n_covers, seed=seed,
                                  device=device)
    replay_identical = bool(np.array_equal(topo, topo_again))

    consensus = consensus_of(sup, topo)
    elapsed, result = refine_consensus(data, consensus, smoke, seed=seed,
                                       device=device)

    final = final_labels(result)
    scores = {
        "metrics": {
            "topo_ari_vs_truth": round(
                adjusted_rand_index(topo, truth), 6),
            "final_ari_vs_truth": round(
                adjusted_rand_index(final, truth), 6),
            "n_topo_clusters": float(len(set(topo.tolist()))),
            "topo_replay_identical": 1.0 if replay_identical else 0.0,
        },
    }
    n_final = len(set(np.asarray(final)[np.asarray(final) > 0].tolist()))
    return outcome_from_result(
        "topo_inputs", params, smoke, elapsed, result, scores,
        metric=(f"{int(params['n_cells']) // 1000}k-cell topology-input "
                "consensus wall-clock"),
        value=round(elapsed, 3), unit="seconds",
        extra={"n_final_clusters": n_final,
               "topo_replay_identical": replay_identical},
    )
