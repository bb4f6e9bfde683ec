"""The control: the reference put in the program's place, one precision
step below the program's.

The port computes in float32 with TF32 off (``device.py``); the step that
would tempt a later change is TF32 matrix products. So the control runs
every stage of the reference in float32 with TF32 on, from the same
inputs, and its outcome is judged like the program's. The judge has to
find it not correct.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from reference.consensus import consensus_labels
from reference.de import pairwise_de
from reference.embed import embedding, union
from reference.judge import Outcome, pool_kw, precision
from reference.pool import lloyd_pool, pool_cut, pool_tree, pooled_silhouette
from reference.silhouette import mean_silhouette
from reference.treecut import cutree_hybrid
from reference.ward import ward_tree

__all__ = ["control_outcome"]


def control_outcome(inputs: Dict, kw: Dict, exact_tree: bool) -> Outcome:
    dtype = torch.float32
    data = inputs["data"]
    dev = data.device
    with precision(True):
        cons = consensus_labels(inputs["sup"], inputs["uns"])
        de = pairwise_de(data, cons, kw, dtype=dtype)
        genes = union(de["de_mask"], de["log_fc"],
                      int(kw.get("number_top_de_genes", 30)))
        emb = embedding(data, genes, int(kw.get("n_pcs", 15)), dtype=dtype)
        tree, labels, sils = None, {}, {}
        if exact_tree:
            tree = ward_tree(emb, dev, dtype=dtype)
            for d in kw.get("deep_split_values", (1, 2, 3, 4)):
                labels[int(d)] = cutree_hybrid(
                    tree, emb, deep_split=int(d),
                    min_cluster_size=int(kw.get("min_cluster_size", 10)))
                sils[int(d)] = mean_silhouette(emb, labels[int(d)], dev,
                                               dtype=dtype)
        else:
            pk = pool_kw(kw)
            cent, assign = lloyd_pool(emb, pk["n_centroids"], pk["seed"],
                                      dev, dtype=dtype)
            tree = pool_tree(cent, assign, dev, dtype=dtype)
            for d in pk["deep_splits"]:
                labels[d] = pool_cut(tree, cent, assign, d,
                                     pk["min_cluster_size"])
                sils[d] = pooled_silhouette(emb, labels[d], cent, assign,
                                            dev, dtype=dtype)
        nodg = (data > 0).sum(dim=0).cpu().numpy()
    return Outcome(consensus=[cons], de=de, union=genes, embedding=emb,
                   tree=tree, labels=labels, silhouettes=sils,
                   nodg=np.asarray(nodg))
