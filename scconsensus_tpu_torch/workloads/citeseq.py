"""Scenario runner: dual-modality CITE-seq consensus.

The port of ``scconsensus_tpu/workloads/citeseq.py``.

The paper's supervised/unsupervised split generalized to modalities:
the ADT modality (a few dozen surface proteins, coarse lineage signal
only) is clustered COARSELY and stands in for the supervised labeling;
the RNA modality (full expression, fine subcluster structure) is
clustered FINELY as the unsupervised labeling. Both clusterings are
seeded device k-means over the modality's own geometry
(``workloads.common.kmeans_labeling``) — neither sees the planted
truth, so the consensus layer is reconciling two *measured* views of
the same cells, which is the scenario the anchor configs' truth-derived
labelings cannot represent. Scored against the hierarchical truth at
both granularities.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

__all__ = ["run"]


def run(params: Dict[str, Any], smoke: bool = False,
        workdir: Optional[str] = None, device=None):
    from scconsensus_tpu_torch.obs.regress import adjusted_rand_index
    from scconsensus_tpu_torch.workloads.common import (
        consensus_of,
        final_labels,
        kmeans_labeling,
        outcome_from_result,
        pca_embed,
        refine_consensus,
    )
    from scconsensus_tpu_torch.workloads.data import cite_seq_dataset

    seed = int(params.get("seed", 7))
    k_coarse = int(params["k_coarse"])
    k_fine = int(params["k_fine"])
    rna, adt, truth_fine, truth_coarse = cite_seq_dataset(
        n_cells=int(params["n_cells"]),
        n_genes=int(params["n_genes"]),
        n_adt=int(params["n_adt"]),
        k_coarse=k_coarse,
        k_fine=k_fine,
        seed=seed,
    )
    # ADT is already low-dimensional: cluster the (N, A) protein space
    # directly at lineage granularity
    adt_lab = kmeans_labeling(adt.T, k_coarse, seed=seed + 1,
                              prefix="adt", device=device)
    # RNA: the pipeline's own rSVD-PCA embed, clustered finely
    n_pcs = int(min(20, max(4, k_fine + 4)))
    rna_emb = pca_embed(rna, n_pcs, seed=seed, device=device)
    rna_lab = kmeans_labeling(rna_emb, k_fine, seed=seed + 2,
                              prefix="rna", device=device)
    consensus = consensus_of(adt_lab, rna_lab)
    elapsed, result = refine_consensus(rna, consensus, smoke, seed=seed,
                                       device=device)

    final = final_labels(result)
    scores = {
        "metrics": {
            # input-labeling quality: how well each modality's own
            # clustering recovers its OWN truth granularity
            "adt_ari_vs_coarse": round(
                adjusted_rand_index(adt_lab, truth_coarse), 6),
            "rna_ari_vs_fine": round(
                adjusted_rand_index(rna_lab, truth_fine), 6),
            # consensus output scored at both granularities
            "final_ari_vs_fine": round(
                adjusted_rand_index(final, truth_fine), 6),
            "final_ari_vs_coarse": round(
                adjusted_rand_index(final, truth_coarse), 6),
        },
    }
    n_final = len(set(np.asarray(final)[np.asarray(final) > 0].tolist()))
    return outcome_from_result(
        "cite_dual", params, smoke, elapsed, result, scores,
        metric=(f"{int(params['n_cells']) // 1000}k-cell dual-modality "
                "ADT×RNA consensus wall-clock"),
        value=round(elapsed, 3), unit="seconds",
        extra={"n_final_clusters": n_final, "n_pcs": n_pcs},
    )
