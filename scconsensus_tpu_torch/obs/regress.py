"""Label-agreement scoring.

``adjusted_rand_index`` is a copy of
``scconsensus_tpu/obs/regress.py:1109-1134`` with one repair: the
reference multiplies the two pair-count sums as int64, which wraps once
their product passes 2^63 (a few clusters over about 80,000 items, every
1M-cell labeling). Here the product is taken in float64, which rounds it
once, as the reference's division already does, so the result is the
reference's wherever the reference does not wrap. The rest of that
module (the run-record regression machinery) is not part of the port.
"""

from __future__ import annotations

import numpy as np

__all__ = ["adjusted_rand_index"]


def adjusted_rand_index(a, b) -> float:
    """Plain-numpy ARI (Hubert & Arabie) of two labelings of the same
    items."""
    a = np.asarray(a).ravel()
    b = np.asarray(b).ravel()
    if a.size != b.size:
        raise ValueError("label arrays differ in length")
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    n = a.size
    c = np.zeros((ai.max() + 1, bi.max() + 1), np.int64)
    np.add.at(c, (ai, bi), 1)

    def comb2(x):
        return (x * (x - 1)) // 2

    sum_ij = comb2(c).sum()
    sum_a = comb2(c.sum(axis=1)).sum()
    sum_b = comb2(c.sum(axis=0)).sum()
    expected = float(sum_a) * float(sum_b) / max(comb2(n), 1)
    max_index = 0.5 * (sum_a + sum_b)
    if max_index == expected:
        return 1.0
    return float((sum_ij - expected) / (max_index - expected))
