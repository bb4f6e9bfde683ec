from scconsensus_tpu_torch.de.engine import (
    PairwiseDEResult,
    de_gene_union,
    filter_clusters,
    pairwise_de,
)

__all__ = ["PairwiseDEResult", "pairwise_de", "filter_clusters",
           "de_gene_union"]
