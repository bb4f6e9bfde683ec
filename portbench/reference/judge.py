"""The comparison that decides ``correct``.

An ``Outcome`` holds what a job produced: the consensus labels of every
job in the window, and of one job drawn from the seed the DE result, the
union, the embedding, the tree, each deepSplit's cut labels and
silhouette and the per-cell detected-gene counts. ``judge`` works out the
reference from the benchmark's inputs and returns one number for each
name the cell's ``limits`` list; a run is correct when every number is at
or under its limit. The numbers:

* ``consensus_mismatch``: cells whose consensus label differs from the
  reference's, summed over the window's jobs (exact);
* ``de_tested_mismatch``: (pair, gene) entries tested on one side only,
  leaving out those whose reference gate value lies within float32's
  rounding of its threshold (``PCT_BAND`` of ``min_pct``, ``FC_BAND`` of
  ``log_fc_thrs``);
* ``de_mask_mismatch``: entries tested on both sides with different DE
  calls, leaving out those whose reference log q lies within ``Q_BAND``
  of log(q_val_thrs);
* ``log_fc_gap``: the largest |Δ log fold change| over every entry;
* ``log_p_gap``: the largest |Δ log p| / max(1, |log p|) over the entries
  tested on both sides (inf when one side has a p and the other none);
* ``union_mismatch``: genes in one of the outcome's union and the union
  the reference draws from the outcome's own DE calls (exact);
* ``embed_gap``: ``procrustes_gap`` of the outcome's embedding against
  the reference embedding of the outcome's union;
* ``tree_gap``: the largest gap between the sorted merge heights of the
  outcome's tree and of exact Ward.D2 on the outcome's embedding, over
  the top height (on the reference embedding instead, near-tied top
  merges of the planted clusters flip on float32's rounding);
* ``cut_mismatch``: cells whose cut label differs from the reference cut
  of the outcome's tree and embedding, summed over deepSplits (exact);
* ``silhouette_gap``: the largest |Δ| of a deepSplit's silhouette from
  the exact silhouette of the outcome's labels on its embedding;
* ``nodg_mismatch``: cells whose detected-gene count differs (exact);

and past ``approx_threshold``, where the tree is built over a pool of
centroids (``reference/pool.py`` works the pool out again from the
outcome's embedding):

* ``pool_cut_structure``: violations of what a pooled cut is (cells
  labelled ≥ 0, clusters numbered 1..K, K and the distinct label tuples
  across deepSplits no more than the tree's leaves; exact);
* ``pool_silhouette_gap``: the largest |Δ| of a deepSplit's silhouette
  from the pooled estimator of the outcome's labels on the reference
  pool.

The pool's tree and cut decisions are not compared: Lloyd's pool turns
on rounding at some seeds (``reference/pool.py``).

The reference runs in float64 on the inputs' device, in blocks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from reference.consensus import consensus_labels
from reference.de import pairwise_de
from reference.embed import embedding, procrustes_gap, union
from reference.pool import (lloyd_pool, pool_cut_structure,
                            pool_silhouette_gap, pooled_silhouette)
from reference.silhouette import mean_silhouette
from reference.treecut import cutree_hybrid
from reference.ward import ward_tree

__all__ = ["Outcome", "precision", "Reference", "judge", "NUMBERS",
           "EXACT_TREE_NUMBERS", "POOL_NUMBERS", "pool_kw"]

PCT_BAND = 1e-3     # percent points: float32 pct of up to 100 rounds ~1e-5
FC_BAND = 1e-4      # natural log: float32 log_fc rounds ~1e-6
Q_BAND = 1e-3       # natural log of q: float32 log q rounds ~1e-5

NUMBERS = ("consensus_mismatch", "de_tested_mismatch", "de_mask_mismatch",
           "log_fc_gap", "log_p_gap", "union_mismatch", "embed_gap",
           "tree_gap", "cut_mismatch", "silhouette_gap", "nodg_mismatch",
           "pool_cut_structure", "pool_silhouette_gap")
EXACT_TREE_NUMBERS = ("tree_gap", "cut_mismatch", "silhouette_gap")
POOL_NUMBERS = ("pool_cut_structure", "pool_silhouette_gap")


def pool_kw(kw: Dict) -> Dict:
    """The pool branch's options with the program's defaults."""
    return {"n_centroids": int(kw.get("n_pool_centroids", 4096)),
            "seed": int(kw.get("random_seed", 1)),
            "min_cluster_size": int(kw.get("min_cluster_size", 10)),
            "deep_splits": tuple(int(d) for d in kw.get(
                "deep_split_values", (1, 2, 3, 4)))}


@dataclasses.dataclass
class Outcome:
    consensus: List[np.ndarray]
    de: Dict
    union: np.ndarray
    embedding: np.ndarray
    tree: Optional[object]
    labels: Dict[int, np.ndarray]
    silhouettes: Dict[int, float]
    nodg: np.ndarray


@contextlib.contextmanager
def precision(tf32: bool):
    """Matrix products in TF32 (the control) or in full float32."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


class Reference:
    """The reference's results for one set of inputs, computed once and
    shared by every outcome judged against them."""

    def __init__(self, inputs: Dict, kw: Dict):
        self.inputs = inputs
        self.kw = kw
        self.device = inputs["data"].device
        self._cache: Dict = {}

    def _get(self, key, fn):
        if key not in self._cache:
            with precision(False):
                self._cache[key] = fn()
        return self._cache[key]

    @property
    def consensus(self) -> np.ndarray:
        return self._get("consensus", lambda: consensus_labels(
            self.inputs["sup"], self.inputs["uns"]))

    @property
    def de(self) -> Dict:
        return self._get("de", lambda: pairwise_de(
            self.inputs["data"], self.consensus, self.kw))

    @property
    def nodg(self) -> np.ndarray:
        return self._get("nodg", lambda: (self.inputs["data"] > 0).sum(
            dim=0).cpu().numpy())

    def embedding(self, genes: np.ndarray) -> np.ndarray:
        return self._get(("embed", genes.tobytes()), lambda: embedding(
            self.inputs["data"], genes, int(self.kw.get("n_pcs", 15))))

    def tree(self, points: np.ndarray):
        return self._get(("tree", points.tobytes()), lambda: ward_tree(
            points, self.device))

    def pool_silhouettes(self, points: np.ndarray,
                         labels: Dict[int, np.ndarray]) -> Dict[int, float]:
        """The pooled silhouette of each deepSplit's ``labels`` on the
        reference pool of ``points``."""
        pk = pool_kw(self.kw)
        cent, assign = self._get(("pool", points.tobytes()), lambda: (
            lloyd_pool(points, pk["n_centroids"], pk["seed"], self.device)))
        with precision(False):
            return {d: pooled_silhouette(points, lab, cent, assign,
                                         self.device)
                    for d, lab in labels.items()}


def _count(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return math.inf
    return float(np.count_nonzero(a != b))


def _de_numbers(c: Dict, r: Dict, want) -> Dict[str, float]:
    out: Dict[str, float] = {}
    if list(c["cluster_names"]) != list(r["cluster_names"]) or \
            c["tested"].shape != r["tested"].shape:
        return {k: math.inf for k in want}
    if "de_tested_mismatch" in want:
        diff = c["tested"] != r["tested"]
        near = ((np.abs(r["pct_max"] - r["min_pct"]) < PCT_BAND)
                | (np.abs(np.abs(r["log_fc"]) - r["log_fc_thrs"]) < FC_BAND))
        out["de_tested_mismatch"] = float(np.count_nonzero(diff & ~near))
    both = c["tested"] & r["tested"]
    if "de_mask_mismatch" in want:
        diff = both & (c["de_mask"] != r["de_mask"])
        near = np.abs(r["log_q"] - math.log(r["q_thr"])) < Q_BAND
        out["de_mask_mismatch"] = float(np.count_nonzero(diff & ~near))
    if "log_fc_gap" in want:
        out["log_fc_gap"] = float(np.max(np.abs(
            c["log_fc"].astype(np.float64) - r["log_fc"])))
    if "log_p_gap" in want:
        cp = c["log_p"][both].astype(np.float64)
        rp = r["log_p"][both]
        fin_c, fin_r = np.isfinite(cp), np.isfinite(rp)
        if np.any(fin_c != fin_r):
            out["log_p_gap"] = math.inf
        else:
            gap = np.abs(cp[fin_r] - rp[fin_r]) / np.maximum(
                1.0, np.abs(rp[fin_r]))
            out["log_p_gap"] = float(gap.max()) if gap.size else 0.0
    return out


def judge(outcome: Outcome, ref: Reference, want) -> Dict[str, float]:
    """The cell's numbers (``want``: the names its limits list) for one
    outcome."""
    want = set(want)
    unknown = want - set(NUMBERS)
    if unknown:
        raise ValueError(f"no comparison named {sorted(unknown)}")
    n_top = int(ref.kw.get("number_top_de_genes", 30))
    mcs = int(ref.kw.get("min_cluster_size", 10))
    out: Dict[str, float] = {}
    if "consensus_mismatch" in want:
        out["consensus_mismatch"] = float(sum(
            _count(c, ref.consensus) for c in outcome.consensus))
    de_want = want & {"de_tested_mismatch", "de_mask_mismatch",
                      "log_fc_gap", "log_p_gap"}
    if de_want:
        out.update(_de_numbers(outcome.de, ref.de, de_want))
    genes = np.asarray(outcome.union, np.int64)
    if "union_mismatch" in want:
        drawn = union(outcome.de["de_mask"], outcome.de["log_fc"], n_top)
        out["union_mismatch"] = float(np.setxor1d(drawn, genes).size)
    if "embed_gap" in want:
        out["embed_gap"] = procrustes_gap(outcome.embedding,
                                          ref.embedding(genes))
    if "tree_gap" in want:
        hc = np.sort(np.asarray(outcome.tree.height, np.float64))
        hr = np.sort(ref.tree(outcome.embedding).height)
        out["tree_gap"] = (float(np.max(np.abs(hc - hr)) / hr[-1])
                           if hc.shape == hr.shape else math.inf)
    if "cut_mismatch" in want:
        out["cut_mismatch"] = float(sum(
            _count(lab, cutree_hybrid(outcome.tree, outcome.embedding,
                                      deep_split=d, min_cluster_size=mcs))
            for d, lab in outcome.labels.items()))
    if "silhouette_gap" in want:
        gaps = []
        for d, lab in outcome.labels.items():
            with precision(False):
                s_ref = mean_silhouette(outcome.embedding, lab, ref.device)
            s = outcome.silhouettes.get(d, math.nan)
            if math.isnan(s_ref) and math.isnan(s):
                gaps.append(0.0)
            else:
                gaps.append(abs(s - s_ref) if not (
                    math.isnan(s_ref) or math.isnan(s)) else math.inf)
        out["silhouette_gap"] = float(max(gaps)) if gaps else math.inf
    if "nodg_mismatch" in want:
        out["nodg_mismatch"] = _count(outcome.nodg, ref.nodg)
    if "pool_cut_structure" in want:
        out["pool_cut_structure"] = pool_cut_structure(
            outcome.labels, outcome.embedding.shape[0],
            outcome.tree.merge.shape[0] + 1)
    if "pool_silhouette_gap" in want:
        out["pool_silhouette_gap"] = pool_silhouette_gap(
            outcome.silhouettes,
            ref.pool_silhouettes(outcome.embedding, outcome.labels))
    return out
