"""WGCNA-style label→color mapping.

``WGCNA::labels2colors`` (called at R/reclusterDEConsensus.R:261) maps integer
cluster ids onto the canonical WGCNA module-color sequence with 0 → "grey"
(unassigned). The downstream grey-exclusion logic
(R/reclusterDEConsensus.R:48-49) depends on this naming, so the table ships
with the framework (SURVEY.md §2b N7). Beyond the named palette, labels cycle
with a numeric suffix, keeping names unique and never colliding with 'grey'.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["labels_to_colors", "STANDARD_COLORS"]

# Canonical leading sequence of WGCNA standardColors().
STANDARD_COLORS = [
    "turquoise", "blue", "brown", "yellow", "green", "red", "black", "pink",
    "magenta", "purple", "greenyellow", "tan", "salmon", "cyan",
    "midnightblue", "lightcyan", "grey60", "lightgreen", "lightyellow",
    "royalblue", "darkred", "darkgreen", "darkturquoise", "darkgrey",
    "orange", "darkorange", "white", "skyblue", "saddlebrown", "steelblue",
    "paleturquoise", "violet", "darkolivegreen", "darkmagenta",
    "sienna3", "yellowgreen", "skyblue3", "plum1", "orangered4", "mediumpurple3",
    "lightsteelblue1", "lightcyan1", "ivory", "floralwhite", "darkorange2",
    "brown4", "bisque4", "darkslateblue", "plum2", "thistle2",
]


def labels_to_colors(labels: Sequence[int]) -> np.ndarray:
    """Map integer cluster ids to color names; 0 (and negatives) → 'grey'."""
    lab = np.asarray(labels, dtype=np.int64)
    out = np.empty(lab.shape, dtype=object)
    n_std = len(STANDARD_COLORS)
    for i, v in enumerate(lab.ravel()):
        if v <= 0:
            out.ravel()[i] = "grey"
        else:
            idx = int(v) - 1
            cycle, pos = divmod(idx, n_std)
            name = STANDARD_COLORS[pos]
            out.ravel()[i] = name if cycle == 0 else f"{name}.{cycle}"
    return out.astype(str)
