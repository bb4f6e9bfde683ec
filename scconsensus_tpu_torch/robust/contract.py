"""Input-contract pre-flight for the ``refine()`` boundary.

The port's copy of ``scconsensus_tpu/robust/contract.py``: the same check
names, policies and order, and the same one-line ``InputContractError``
(a ``ValueError`` whose ``.check`` names the failed check).

  ====================  ======  =============================================
  check                 policy  behavior
  ====================  ======  =============================================
  shape                 reject  data must be 2-D with G, N >= 1 and
                                len(labels) == N
  nan_labels            reject  float-NaN label values (they would collapse
                                into a single "nan" pseudo-cluster)
  nonfinite_matrix      reject  any NaN/Inf in the expression matrix
  noncontiguous_ids     repair  integer label ids with gaps are accepted
                                as-is (labels are categorical names)
  degenerate_clusters   reject  fewer than 2 clusters survive the engine's
                                size filter
  small_clusters        repair  clusters at/below min_cluster_size are
                                dropped by the engine; named up front
  ====================  ======  =============================================

The finite check on a tensor or a ``DeviceCSR`` is one reduction on the
matrix's device, ``torch.isfinite(x).all()`` over the values (the stored
values of a CSR); the counts for the message are taken only once it has
failed. It rejects NaN or ±Inf anywhere and nothing else, the rule of the
reference's numpy path (a float64 sum that no finite float32 matrix can
overflow).

``preflight`` returns the repair records as the reference does and notes
each one as an ``input_contract`` degradation on the run's robustness log
(``robust.record``).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from scconsensus_tpu_torch.io.sparsemat import DeviceCSR, is_sparse
from scconsensus_tpu_torch.obs import residency
from scconsensus_tpu_torch.robust import record as robust_record

__all__ = ["InputContractError", "CHECKS", "preflight"]


class InputContractError(ValueError):
    """A refine() input violated a reject-policy contract check. The
    message is the one-line diagnosis; ``check`` names the failed check
    (a key of :data:`CHECKS`)."""

    def __init__(self, check: str, msg: str):
        super().__init__(f"input contract [{check}]: {msg}")
        self.check = check


# check name -> policy (the reference's registry; preflight runs them in
# the order of the table above)
CHECKS: Dict[str, str] = {
    "shape": "reject",
    "nonfinite_matrix": "reject",
    "nan_labels": "reject",
    "degenerate_clusters": "reject",
    "noncontiguous_ids": "repair",
    "small_clusters": "repair",
}


def _values(data):
    """The values whose finiteness decides the check: a tensor, the stored
    values of a CSR (device or host), or the numpy array."""
    if isinstance(data, torch.Tensor):
        return data
    if isinstance(data, DeviceCSR):
        return data.values
    if is_sparse(data):
        return np.asarray(data.tocsr().data)
    return np.asarray(data)


def _nonfinite_counts(vals) -> Dict[str, int]:
    """The diagnosis, once the finite check has failed."""
    if isinstance(vals, torch.Tensor):
        return {"nan": int(torch.isnan(vals).sum()),
                "inf": int(torch.isinf(vals).sum())}
    return {"nan": int(np.isnan(vals).sum()),
            "inf": int(np.isinf(vals).sum())}


def preflight(data, labels, config) -> List[Dict[str, Any]]:
    """Run every contract check against a refine() call's inputs.

    ``data``: a numpy array, a tensor, a ``scipy.sparse`` matrix or a
    ``DeviceCSR``. Raises :class:`InputContractError` on the first
    reject-policy violation; returns the list of repair records (possibly
    empty), each ``{"check", "policy", "detail"}``.
    """
    from scconsensus_tpu_torch.de.engine import filter_cluster_names

    repairs: List[Dict[str, Any]] = []

    # shape — everything downstream indexes (G, N) against labels
    shape = getattr(data, "shape", None)
    if shape is None or len(shape) != 2:
        raise InputContractError(
            "shape", f"expression matrix must be 2-D (genes × cells), "
                     f"got shape {shape!r}")
    G, N = int(shape[0]), int(shape[1])
    if G < 1 or N < 1:
        raise InputContractError(
            "shape", f"expression matrix must be non-empty, got "
                     f"({G} genes × {N} cells)")
    if len(labels) != N:
        raise InputContractError(
            "shape", f"labels length {len(labels)} != n_cells {N}")

    # nan_labels — float NaN would str()-collapse into one "nan" cluster
    lab_arr = np.asarray(labels)
    if lab_arr.dtype.kind == "f" and bool(np.isnan(lab_arr).any()):
        n_bad = int(np.isnan(lab_arr).sum())
        raise InputContractError(
            "nan_labels", f"{n_bad} of {N} labels are NaN — every one "
                          "would alias into a single 'nan' pseudo-cluster")

    # nonfinite_matrix — one reduction where the values lie
    vals = _values(data)
    # the one scalar the contract reads back from the staged matrix
    with residency.boundary("input_staging"):
        finite = (bool(torch.isfinite(vals).all())
                  if isinstance(vals, torch.Tensor)
                  else bool(np.isfinite(vals).all()))
    if not finite:
        c = _nonfinite_counts(vals)
        raise InputContractError(
            "nonfinite_matrix",
            f"expression matrix contains {c['nan']} NaN and {c['inf']} "
            f"Inf value(s) — clean or mask them before refine()")

    # noncontiguous_ids (repair) — integer labelings with gaps are legal
    # (labels are categorical names), but the gap usually means an
    # upstream filter dropped clusters; say so once
    if lab_arr.dtype.kind in "iu":
        uniq = np.unique(lab_arr)
        lo, hi = int(uniq.min()), int(uniq.max())
        if uniq.size and uniq.size != hi - lo + 1:
            repairs.append({
                "check": "noncontiguous_ids", "policy": "repair",
                "detail": f"integer label ids have gaps ({uniq.size} "
                          f"distinct ids spanning [{lo}, {hi}]); treated "
                          "as categorical names",
            })

    # degenerate_clusters / small_clusters — the engine's own survival
    # rule, applied at the boundary so the failure is one line
    lab_str = lab_arr.astype(str)
    all_names, counts = np.unique(lab_str, return_counts=True)
    names = filter_cluster_names(
        all_names, counts, config.min_cluster_size, config.drop_grey
    )
    dropped = [
        f"{n!s}({c})" for n, c in zip(all_names, counts)
        if str(n) not in names
    ]
    if len(names) < 2:
        raise InputContractError(
            "degenerate_clusters",
            f"only {len(names)} cluster(s) survive the size filter "
            f"(min_cluster_size={config.min_cluster_size}, "
            f"drop_grey={config.drop_grey}); dropped: "
            f"{', '.join(dropped) if dropped else 'none'} — pairwise DE "
            "needs at least 2 clusters")
    if dropped:
        repairs.append({
            "check": "small_clusters", "policy": "repair",
            "detail": f"dropped {len(dropped)} empty/singleton/sub-floor "
                      f"cluster(s) before DE: {', '.join(dropped[:8])}"
                      + (" …" if len(dropped) > 8 else ""),
        })
    for r in repairs:
        robust_record.note_degradation(
            "input_contract", f"repair:{r['check']}", r["detail"]
        )
    return repairs
