"""Naive spec-level twin of ``ops.treecut.cutree_hybrid`` (test oracle).

The port's copy of ``scconsensus_tpu/ops/treecut_direct.py`` (numpy and
scipy, no device code), over the port's ``ops.linkage.HClustTree`` and
``ops.treecut.DEEP_SPLIT_CORE_SCATTER``; held equal to the reference's by
``tests/test_torch_oracles.py``.

Role: the production cut (`ops/treecut.py`) carries hand-tuned fast paths —
bisect-based branch interleaves, triu-free core scatter, C-speed list
surgery — that are exactly where a silent indexing/tie/ordering bug could
hide. This module re-expresses the same published algorithm (Langfelder,
Zhang & Horvath 2008, "Defining clusters from a hierarchical cluster tree";
reference call sites R/reclusterDEConsensus.R:254-260) with the simplest
possible machinery: full stable re-sorts instead of interleaves, scipy
pdist for scatter, per-object loops in the PAM stage. The reference's
``tests/test_treecut.py`` asserts label-identical output across
randomized geometries, deepSplits, size floors, and PAM settings — the
same consumed-oracle treatment the NB engine gets from
``de/edger_direct.py``.

Honesty note: both implementations derive from the same reading of the
published description (the upstream R source is not consultable here), so
agreement rules out implementation divergence, not a shared
misinterpretation; the latter is what ``parity_kit/gen_treecut_fixtures.R``
exists to settle offline.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from scconsensus_tpu_torch.ops.linkage import HClustTree
from scconsensus_tpu_torch.ops.treecut import DEEP_SPLIT_CORE_SCATTER

__all__ = ["cutree_hybrid_direct"]


def _core_size_direct(branch_size: int, min_cluster_size: int) -> int:
    """Independent expression of the published CoreSize formula:
    min(minClusterSize/2 + 1 + sqrt(size − (minClusterSize/2 + 1)), size).
    Deliberately NOT imported from ops.treecut — the oracle must not share
    logic with the module under test (constants are fine, code is not)."""
    base = min_cluster_size / 2.0 + 1.0
    if base >= branch_size:
        return int(branch_size)
    return int(base + np.sqrt(branch_size - base))


def _pairwise_mean_distance(pts: np.ndarray) -> float:
    """Mean euclidean distance over unordered pairs (== off-diagonal mean)."""
    m = pts.shape[0]
    if m < 2:
        return 0.0
    from scipy.spatial.distance import pdist

    return float(np.mean(pdist(pts)))


def _qualifies_direct(
    members: List[Tuple[float, int]],
    death_height: float,
    embedding: np.ndarray,
    min_cluster_size: int,
    max_abs_core_scatter: float,
    min_abs_gap: float,
) -> bool:
    """members: (join_height, leaf) tuples in join order."""
    size = len(members)
    if size < min_cluster_size:
        return False
    cs = _core_size_direct(size, min_cluster_size)
    core_leaves = [leaf for _h, leaf in members[:cs]]
    if _pairwise_mean_distance(embedding[np.asarray(core_leaves)]) > (
        max_abs_core_scatter
    ):
        return False
    return (death_height - members[cs - 1][0]) >= min_abs_gap


def cutree_hybrid_direct(
    tree: HClustTree,
    embedding: np.ndarray,
    deep_split: int = 1,
    min_cluster_size: int = 10,
    cut_height: Optional[float] = None,
    pam_stage: bool = False,
    max_pam_dist: Optional[float] = None,
) -> np.ndarray:
    """Reference-naive hybrid cut; signature mirrors ``cutree_hybrid``."""
    if not 0 <= int(deep_split) <= 4:
        raise ValueError(f"deep_split must be in 0..4, got {deep_split}")
    n = tree.n_leaves
    heights = np.asarray(tree.height, np.float64)
    n_merge = n - 1
    ref_height = float(heights[max(int(round(0.05 * n_merge)), 1) - 1])
    max_height = float(heights[-1])
    if cut_height is None:
        cut_height = 0.99 * (max_height - ref_height) + ref_height
    cut_height = min(cut_height, max_height)

    max_core_scatter = DEEP_SPLIT_CORE_SCATTER[int(deep_split)]
    min_gap = (1.0 - max_core_scatter) * 3.0 / 4.0
    max_abs_core_scatter = ref_height + max_core_scatter * (
        cut_height - ref_height
    )
    min_abs_gap = min_gap * (cut_height - ref_height)

    embedding = np.ascontiguousarray(embedding, np.float64)

    # Branch = list of (join_height, leaf), kept in join order via a full
    # STABLE sort (key = height only) of the concatenation after every
    # fuse: stability makes the first child's members precede the second's
    # on exact height ties while preserving each branch's internal order —
    # the published "members ordered by joining height" rule.
    branches: Dict[int, List[Tuple[float, int]]] = {}
    composite: Dict[int, bool] = {}
    clusters: List[List[int]] = []

    for row in range(n_merge):
        h = float(heights[row])
        if h > cut_height:
            continue
        out: List[Tuple[float, int]] = []
        comp = False
        sides = []
        for code in (int(tree.merge[row, 0]), int(tree.merge[row, 1])):
            if code < 0:
                sides.append(([(h, -code - 1)], False))
            else:
                sides.append((branches.pop(code - 1),
                              composite.pop(code - 1)))
        (ma, ca), (mb, cb) = sides
        if ca or cb:
            for members, is_comp in sides:
                if not is_comp and _qualifies_direct(
                    members, h, embedding, min_cluster_size,
                    max_abs_core_scatter, min_abs_gap,
                ):
                    clusters.append([leaf for _h, leaf in members])
            comp = True
        elif len(ma) > 1 and len(mb) > 1 and _qualifies_direct(
            ma, h, embedding, min_cluster_size,
            max_abs_core_scatter, min_abs_gap,
        ) and _qualifies_direct(
            mb, h, embedding, min_cluster_size,
            max_abs_core_scatter, min_abs_gap,
        ):
            clusters.append([leaf for _h, leaf in ma])
            clusters.append([leaf for _h, leaf in mb])
            comp = True
        else:
            out = sorted(ma + mb, key=lambda t: t[0])  # stable: a first on ties
        branches[row] = out
        composite[row] = comp

    for row, members in branches.items():
        if composite[row]:
            continue
        if _qualifies_direct(members, cut_height, embedding,
                             min_cluster_size, max_abs_core_scatter,
                             min_abs_gap):
            clusters.append([leaf for _h, leaf in members])

    labels = np.zeros(n, np.int64)
    clusters.sort(key=len, reverse=True)
    for cid, members in enumerate(clusters, start=1):
        labels[np.asarray(members)] = cid

    if pam_stage and clusters:
        limit = cut_height if max_pam_dist is None else max_pam_dist
        out_labels = labels.copy()
        for obj in np.nonzero(labels == 0)[0]:
            best_c, best_d = 0, np.inf
            for c in range(1, labels.max() + 1):
                pts = embedding[labels == c]
                d = float(np.mean(
                    np.sqrt(np.sum((pts - embedding[obj]) ** 2, axis=1))
                ))
                if d < best_d:
                    best_c, best_d = c, d
            if best_d <= limit:
                out_labels[obj] = best_c
        labels = out_labels
    return labels
