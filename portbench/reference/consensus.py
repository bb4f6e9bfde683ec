"""Consensus labels from two clusterings (plotContingencyTable's grammar).

The clustering with more distinct labels is the base (on a tie, the one
with the larger median cluster size, the second on equal medians); every
(base label, other label) overlap holding at least 10 % of the base
cluster's cells and more than ``min_clust_size`` cells is split out as
the compound label ``"<base>_<other>"``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["consensus_labels"]


def consensus_labels(labels_1, labels_2, min_clust_size: int = 10
                     ) -> np.ndarray:
    a = np.asarray(labels_1).astype(str)
    b = np.asarray(labels_2).astype(str)
    ua, ia, ca = np.unique(a, return_inverse=True, return_counts=True)
    ub, ib, cb = np.unique(b, return_inverse=True, return_counts=True)
    first = (ua.size > ub.size
             or (ua.size == ub.size and np.median(ca) > np.median(cb)))
    if first:
        base_u, base_i, base_c, rem_u, rem_i = ua, ia, ca, ub, ib
    else:
        base_u, base_i, base_c, rem_u, rem_i = ub, ib, cb, ua, ia
    cross = np.zeros((base_u.size, rem_u.size), np.int64)
    np.add.at(cross, (base_i, rem_i), 1)
    split = ((100.0 * cross) / base_c[:, None] >= 10.0) & (
        cross > min_clust_size)
    out = base_u[base_i].astype(object)
    hit = split[base_i, rem_i]
    out[hit] = np.char.add(np.char.add(base_u[base_i[hit]], "_"),
                           rem_u[rem_i[hit]])
    return out.astype(str)
