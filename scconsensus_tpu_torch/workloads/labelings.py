"""Input-labeling construction strategies.

The port's copy of ``scconsensus_tpu/workloads/labelings.py`` (the same
bytes out for the same arguments). ``truth_perturb`` is the bench's
recipe — every input labeling a perturbation of the planted truth; the
other strategies build labelings from structure rather than truth:
``per_sample`` fragments the unsupervised labeling by sample (cluster
ids are sample-local — the multi-sample scenario's unaligned input), and
the topology clusterer (``workloads.topology``) derives one from data
geometry alone.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

__all__ = [
    "truth_perturb",
    "per_sample_unsupervised",
    "STRATEGIES",
]


def truth_perturb(truth: np.ndarray, n_clusters: int,
                  n_way: int = 2) -> List[np.ndarray]:
    """The bench recipe (byte-stable with the reference's):
    a 5 %-flip "supervised" labeling, a 10 %-flip coarsened
    "unsupervised" labeling, and 8 %-flip extras for n_way > 2."""
    from scconsensus_tpu_torch.utils.synthetic import noisy_labeling

    labelings = [noisy_labeling(truth, 0.05, seed=1, prefix="sup")]
    labelings.append(noisy_labeling(
        truth, 0.10, n_out_clusters=max(2, n_clusters - 4), seed=2,
        prefix="uns"
    ))
    for i in range(n_way - 2):
        labelings.append(
            noisy_labeling(truth, 0.08, seed=3 + i, prefix=f"t{i}")
        )
    return labelings


def per_sample_unsupervised(truth: np.ndarray, batches: np.ndarray,
                            flip_frac: float = 0.08,
                            seed: int = 0) -> np.ndarray:
    """An UNALIGNED per-sample clustering: each sample's cells are
    labeled by an independent noisy clustering whose ids carry a
    sample-local prefix (``s<b>c<k>``), so no label is shared across
    samples — the consensus layer has to reconcile them through the
    contingency grammar, exactly the multi-sample integration problem.
    Deterministic in (truth, batches, seed)."""
    from scconsensus_tpu_torch.utils.synthetic import noisy_labeling

    batches = np.asarray(batches)
    out = np.empty(truth.shape[0], dtype=object)
    for b in sorted(int(v) for v in np.unique(batches)):
        sel = batches == b
        out[sel] = noisy_labeling(
            truth[sel], flip_frac, seed=seed + 17 * (b + 1),
            prefix=f"s{b}c",
        )
    return out.astype(str)


# name -> callable; signatures differ by what a strategy needs (truth,
# batches, data geometry), so the registry documents availability
# rather than enforcing one calling convention.
STRATEGIES: Dict[str, object] = {
    "truth_perturb": truth_perturb,
    "per_sample": per_sample_unsupervised,
}
