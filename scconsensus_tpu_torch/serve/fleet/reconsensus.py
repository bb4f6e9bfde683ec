"""The drift-to-reconsensus loop: quarantined cells back into consensus.

The port of ``scconsensus_tpu/serve/fleet/reconsensus.py``. The drift gate
refuses to label what no longer fits the frozen model and ledgers the
evidence; this module closes the loop:

1. **Accumulate**: :func:`read_quarantine_batch` folds the ledger dir's
   persisted cell payloads (``quarantine_cells/*.npy``, written by the
   driver beside each ledger line) into one batch.
2. **Classify against landmarks**: every quarantined cell is projected
   through the frozen PCA basis and scored against the existing
   landmarks; cells back inside the calibrated drift threshold conform.
3. **Mini-refine the spill**: non-conforming cells get a landmark
   mini-recluster (sketch Lloyd, occupancy-weighted Ward, dynamic cut)
   on ``device``.
4. **Merge via the contingency heuristic**: the frozen model's
   nearest-cluster claim against the mini-refine's cut, through
   ``automated_consensus``: overlap keeps the old label, novelty becomes
   new clusters numbered past the existing label space.
5. **Export and hot-swap**: the combined landmark set freezes into a new
   sha256-verified model artifact with another fingerprint, and
   :func:`run_reconsensus` hot-swaps it into the fleet through the
   verified load path. The consumed ledger is renamed aside
   (``*.consumed-N``), so the next accumulation starts clean.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from scconsensus_tpu_torch.config import env_flag
from scconsensus_tpu_torch.device import resolve_device
from scconsensus_tpu_torch.serve.driver import (
    QUARANTINE_CELLS_DIR,
    QUARANTINE_LEDGER_NAME,
)
from scconsensus_tpu_torch.serve.model import (
    MODEL_STAGE,
    _CALIB_QS,
    ConsensusModel,
    _assemble,
)

__all__ = [
    "read_quarantine_batch",
    "reconsensus_update",
    "run_reconsensus",
]


# --------------------------------------------------------------------------
# accumulate
# --------------------------------------------------------------------------

def _read_ledger_file(path: str, cells_dir: str
                      ) -> Tuple[np.ndarray, List[Dict[str, Any]]]:
    """Fold one ledger file + payload dir into ``(cells (M, G) float32,
    entries)``. ``cells_file`` entries resolve by basename into
    ``cells_dir`` (payloads live flat there), so a snapshotted ledger
    reads against its snapshotted payload dir. Entries without a
    persisted payload (cap reached, write failed) are kept in the entry
    list — they are evidence — but contribute no cells. Unreadable
    payloads are skipped, never fatal: the ledger is an append-only
    audit trail a crashed server may have left mid-write."""
    entries: List[Dict[str, Any]] = []
    blocks: List[np.ndarray] = []
    try:
        with open(path) as f:
            lines = f.readlines()
    except OSError:
        return np.zeros((0, 0), np.float32), entries
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            e = json.loads(line)
        except json.JSONDecodeError:
            continue
        if not isinstance(e, dict):
            continue
        entries.append(e)
        rel = e.get("cells_file")
        if not rel:
            continue
        try:
            blocks.append(np.asarray(
                np.load(os.path.join(cells_dir, os.path.basename(rel)),
                        allow_pickle=False),
                np.float32,
            ))
        except (OSError, ValueError):
            continue
    if not blocks:
        return np.zeros((0, 0), np.float32), entries
    return np.concatenate(blocks, axis=0), entries


def read_quarantine_batch(ledger_dir: str
                          ) -> Tuple[np.ndarray, List[Dict[str, Any]]]:
    """Fold a live ledger dir into ``(cells, entries)`` — see
    :func:`_read_ledger_file`."""
    return _read_ledger_file(
        os.path.join(ledger_dir, QUARANTINE_LEDGER_NAME),
        os.path.join(ledger_dir, QUARANTINE_CELLS_DIR),
    )


# --------------------------------------------------------------------------
# the update
# --------------------------------------------------------------------------

def _host_embed(model: ConsensusModel, cells: np.ndarray) -> np.ndarray:
    """Project (n, G) cells through the frozen panel + PCA basis — the
    same float64 math as ``classify_host``, shared so the loop scores
    drift exactly the way the serving driver did."""
    xp = model._gather_panel(cells).astype(np.float64)
    return ((xp - model.pca_mean.astype(np.float64))
            @ model.pca_components.astype(np.float64).T)


def _nearest(proj: np.ndarray, cents: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray]:
    c = np.asarray(cents, np.float64)
    d2 = (np.sum(proj * proj, axis=1, keepdims=True)
          - 2.0 * proj @ c.T
          + np.sum(c * c, axis=1)[None, :])
    j = np.argmin(d2, axis=1)
    dist = np.sqrt(np.maximum(d2[np.arange(j.size), j], 0.0))
    return j, dist


def reconsensus_update(
    model: ConsensusModel,
    cells: np.ndarray,
    seed: int = 0,
    deep_split: int = 2,
    min_cluster_size: int = 4,
    drift_margin: Optional[float] = None,
    device=None,
) -> Tuple[Optional[Tuple[Dict[str, np.ndarray], Dict[str, Any]]],
           Dict[str, Any]]:
    """One incremental consensus update from a quarantine batch.

    Returns ``((arrays, meta) | None, summary)`` — the arrays+meta of the
    updated model artifact (None when the batch holds no recoverable new
    structure; the summary says why). The updated model keeps every old
    landmark (centroid, label, occupancy) untouched: cells that still
    conform keep classifying identically — the update only ADDS decision
    surface, it never rewrites the frozen atlas. The mini-refine's
    landmark fit runs on ``device``.
    """
    from scconsensus_tpu_torch.consensus.contingency import automated_consensus
    from scconsensus_tpu_torch.ops.linkage import ward_linkage
    from scconsensus_tpu_torch.ops.pooling import (
        centroid_majority_labels,
        landmark_ward_linkage,
    )
    from scconsensus_tpu_torch.ops.treecut import cutree_hybrid

    dev = resolve_device(device)
    m = int(cells.shape[0]) if cells.size else 0
    summary: Dict[str, Any] = {
        "parent_fp": model.fingerprint(),
        "n_batch": m,
        "updated": False,
    }
    if m == 0:
        summary["reason"] = "empty quarantine batch"
        return None, summary

    proj = _host_embed(model, cells)
    j_old, dist_old = _nearest(proj, model.centroids)
    labels_old = model.centroid_labels[j_old].astype(np.int64)
    conform = dist_old <= model.drift_threshold
    nc = ~conform
    n_nc = int(nc.sum())
    summary["n_conforming"] = int(conform.sum())
    summary["n_nonconforming"] = n_nc
    if n_nc < max(2 * min_cluster_size, 8):
        summary["reason"] = (
            f"only {n_nc} non-conforming cells — no recoverable new "
            f"structure (conforming cells need no reconsensus)"
        )
        return None, summary

    # (3) landmark mini-refine on the spill: the landmark engine at batch
    # scale
    k_mini = int(np.clip(round(2.0 * np.sqrt(n_nc)), 8, 256))
    k_mini = min(k_mini, n_nc)
    tree_nc, assign_nc, cents_nc, info = landmark_ward_linkage(
        np.asarray(proj[nc], np.float32), n_landmarks=k_mini, seed=seed,
        device=dev,
    )
    counts_nc = np.bincount(
        assign_nc, minlength=cents_nc.shape[0]
    ).astype(np.int64)
    cut = cutree_hybrid(
        tree_nc, cents_nc, deep_split=deep_split,
        min_cluster_size=min_cluster_size,
        weights=counts_nc.astype(np.float64),
    )
    mini_labels = np.asarray(cut, np.int64)[assign_nc]  # per nc cell

    # (4) the paper's merge grammar over the spill: the frozen model's
    # nearest-cluster claim vs the drift view. The mini labels are
    # namespaced ("n<k>") so a mini cluster id can never collide with an
    # existing label value. Overlapping mass keeps the old label;
    # compound/new labels become clusters numbered past the existing
    # label space; anything touching the mini unassigned bucket ("n0")
    # stays unassigned — noise must not found a cluster.
    consensus = automated_consensus(
        labels_old[nc].astype(str),
        np.array([f"n{v}" for v in mini_labels]),
        min_clust_size=min_cluster_size,
    )
    existing = set(int(v) for v in np.unique(model.centroid_labels)
                   if int(v) > 0)
    existing |= set(int(v) for v in model.meta.get("label_values", []))
    next_id = max(existing | {0}) + 1
    mapping: Dict[str, int] = {}
    for s in sorted(np.unique(consensus)):
        if s.isdigit() and int(s) in existing:
            mapping[s] = int(s)  # merged back into an existing cluster
        elif s == "0" or "n0" in s.split("_"):
            mapping[s] = 0  # unassigned noise, never a new cluster
        else:
            mapping[s] = next_id  # genuinely new structure
            next_id += 1
    merged_nc = np.array([mapping[s] for s in consensus], np.int64)
    new_ids = sorted(set(mapping.values()) - existing - {0})
    summary["merge_table"] = {s: int(v) for s, v in mapping.items()}
    summary["n_new_clusters"] = len(new_ids)
    if not new_ids:
        summary["reason"] = (
            "contingency merge folded every non-conforming cell back "
            "into existing clusters — drift without new structure"
        )
        return None, summary

    # (5) additive landmark set: new centroids labeled by majority vote
    # of the merged consensus (unlabeled mini-landmarks are noise and
    # are dropped — a landmark that would serve label 0 serves nothing)
    votes = centroid_majority_labels(assign_nc, merged_nc,
                                     cents_nc.shape[0])
    keep = (votes > 0) & (counts_nc > 0)
    if not keep.any():
        summary["reason"] = "every mini-landmark voted unassigned"
        return None, summary
    centroids = np.vstack([
        model.centroids.astype(np.float32),
        np.asarray(cents_nc[keep], np.float32),
    ])
    centroid_labels = np.concatenate([model.centroid_labels,
                                      votes[keep]]).astype(np.int64)
    centroid_counts = np.concatenate([model.centroid_counts,
                                      counts_nc[keep]]).astype(np.int64)
    tree = ward_linkage(centroids.astype(np.float64),
                        weights=centroid_counts.astype(np.float64))

    # recalibrate drift on the combined surface: the batch's distances to
    # the combined centroids can only widen the calibration (max-merge) —
    # the updated model must keep admitting everything the old one did
    _, dist_new = _nearest(proj, centroids)
    batch_q = (np.quantile(dist_new, _CALIB_QS) if dist_new.size
               else np.zeros(len(_CALIB_QS)))
    calib_q = np.maximum(model.calib_q, batch_q)
    margin = float(drift_margin if drift_margin is not None
                   else model.meta.get("drift_margin")
                   or env_flag("SCC_SERVE_DRIFT_MARGIN"))
    threshold = float(max(model.drift_threshold,
                          batch_q[_CALIB_QS.index(0.99)] * margin))

    label_values = sorted(existing | set(new_ids))
    meta: Dict[str, Any] = dict(model.meta)
    meta.update({
        "created_unix": round(time.time(), 3),
        "n_cells": int(meta.get("n_cells", 0)) + m,
        "k": int(centroids.shape[0]),
        "drift_margin": margin,
        "drift_threshold": threshold,
        "label_values": [int(v) for v in label_values],
        "reconsensus": {
            "parent_fp": model.fingerprint(),
            "round": int((model.meta.get("reconsensus") or {})
                         .get("round", 0)) + 1,
            "n_batch": m,
            "n_nonconforming": n_nc,
            "n_new_clusters": len(new_ids),
            "new_labels": [int(v) for v in new_ids],
            "mini_landmarks": int(keep.sum()),
        },
    })
    arrays = {
        "panel_idx": np.asarray(model.panel_idx, np.int64),
        "pca_mean": np.asarray(model.pca_mean, np.float32),
        "pca_components": np.asarray(model.pca_components, np.float32),
        "centroids": centroids,
        "centroid_labels": centroid_labels,
        "centroid_counts": centroid_counts,
        "tree_merge": np.asarray(tree.merge),
        "tree_height": np.asarray(tree.height),
        "tree_order": np.asarray(tree.order),
        "calib_q": np.asarray(calib_q, np.float64),
    }
    summary["updated"] = True
    summary["new_labels"] = [int(v) for v in new_ids]
    summary["mini_info"] = {k: v for k, v in info.items()
                            if isinstance(v, (int, float, str))}
    return (arrays, meta), summary


# --------------------------------------------------------------------------
# the loop
# --------------------------------------------------------------------------

def run_reconsensus(
    ledger_dir: str,
    out_dir: str,
    model: Optional[ConsensusModel] = None,
    pool=None,
    min_cells: Optional[int] = None,
    seed: int = 0,
    deep_split: int = 2,
    min_cluster_size: int = 4,
    consume: bool = True,
    device=None,
) -> Dict[str, Any]:
    """One turn of the drift-to-reconsensus loop: accumulate → update →
    export → hot-swap. ``model`` defaults to the pool's active model.
    Returns the summary (``updated`` False with a named reason when the
    evidence is insufficient — the ledger keeps accumulating).

    ``consume=True`` snapshots the ledger (+ its cell payload dir) aside
    as ``*.consumed-N`` BEFORE processing — evidence appended by live
    replicas while the mini-refine runs lands in a fresh ledger and is
    never swallowed unread — and restores the snapshot back into the
    live ledger (merge-append if new evidence arrived meanwhile) when no
    update lands, so evidence is never double-counted, never destroyed,
    and never starved out of a future loop turn. The update runs on
    ``device``, and the new model is assembled there.
    """
    from scconsensus_tpu_torch.utils.artifacts import ArtifactStore

    dev = resolve_device(device)
    if model is None:
        if pool is None:
            raise ValueError("run_reconsensus needs a model or a pool")
        model = pool.active_model()
    floor = int(min_cells if min_cells is not None
                else env_flag("SCC_FLEET_RECON_MIN_CELLS"))
    snap = _snapshot_ledger(ledger_dir) if consume else None
    committed = False
    try:
        if consume:
            cells, entries = (_read_ledger_file(*snap) if snap
                              else (np.zeros((0, 0), np.float32), []))
        else:
            cells, entries = read_quarantine_batch(ledger_dir)
        n = int(cells.shape[0]) if cells.size else 0
        if n < floor:
            return {
                "updated": False,
                "parent_fp": model.fingerprint(),
                "n_batch": n,
                "n_entries": len(entries),
                "reason": f"{n} accumulated cells < the {floor}-cell "
                          f"floor (SCC_FLEET_RECON_MIN_CELLS)",
            }
        built, summary = reconsensus_update(
            model, cells, seed=seed, deep_split=deep_split,
            min_cluster_size=min_cluster_size, device=dev,
        )
        summary["n_entries"] = len(entries)
        if built is None:
            return summary
        arrays, meta = built
        ArtifactStore(out_dir).save(MODEL_STAGE, arrays, meta)
        new_model = _assemble(arrays, meta, dev)
        summary["new_fp"] = new_model.fingerprint()
        summary["model_dir"] = out_dir
        if pool is not None:
            # back into the fleet through the VERIFIED load path: the
            # swap reads the artifact we just wrote, sha256 and all —
            # the loop never injects an unverified in-memory model
            summary["swapped_fp"] = pool.hot_swap(out_dir)
        committed = True
        summary["ledger_consumed"] = bool(snap)
        return summary
    finally:
        if snap and not committed:
            # no model landed (insufficient evidence, no new structure,
            # or a crash): the snapshot flows BACK into the live ledger
            # so the evidence keeps accumulating toward a future turn
            _restore_snapshot(ledger_dir, snap)


def _snapshot_ledger(ledger_dir: str
                     ) -> Optional[Tuple[str, str]]:
    """Move the live ledger + payload dir aside as ``*.consumed-N``
    BEFORE reading (evidence appended during processing lands in a fresh
    live ledger, never consumed unread). Returns the snapshot's
    ``(ledger_path, cells_dir)`` or None when there is no ledger."""
    path = os.path.join(ledger_dir, QUARANTINE_LEDGER_NAME)
    cdir = os.path.join(ledger_dir, QUARANTINE_CELLS_DIR)
    if not os.path.exists(path):
        return None
    n = 1
    while (os.path.exists(f"{path}.consumed-{n}")
           or os.path.exists(f"{cdir}.consumed-{n}")):
        n += 1
    try:
        os.replace(path, f"{path}.consumed-{n}")
        if os.path.exists(cdir):
            os.replace(cdir, f"{cdir}.consumed-{n}")
    except OSError:
        return None
    return f"{path}.consumed-{n}", f"{cdir}.consumed-{n}"


def _restore_snapshot(ledger_dir: str, snap: Tuple[str, str]) -> None:
    """Fold a snapshot back into the live ledger: plain rename when
    nothing new arrived, merge-append otherwise (snapshot lines prepend
    into the live file; payloads move back into the live dir — names
    are unique per (pid, seq), so collisions don't occur in practice
    and a collider is left in the snapshot rather than clobbered)."""
    snap_ledger, snap_cells = snap
    path = os.path.join(ledger_dir, QUARANTINE_LEDGER_NAME)
    cdir = os.path.join(ledger_dir, QUARANTINE_CELLS_DIR)
    try:
        if not os.path.exists(path) and not os.path.exists(cdir):
            os.replace(snap_ledger, path)
            if os.path.exists(snap_cells):
                os.replace(snap_cells, cdir)
            return
        with open(snap_ledger) as f:
            old_lines = f.read()
        with open(path, "a") as f:
            f.write(old_lines)
        os.remove(snap_ledger)
        if os.path.exists(snap_cells):
            os.makedirs(cdir, exist_ok=True)
            for name in os.listdir(snap_cells):
                dst = os.path.join(cdir, name)
                if not os.path.exists(dst):
                    os.replace(os.path.join(snap_cells, name), dst)
            if not os.listdir(snap_cells):
                os.rmdir(snap_cells)
    except OSError:
        pass  # best-effort: the snapshot stays on disk as the audit copy
