"""The frozen consensus-model artifact and the one-device-call classifier.

The port of ``scconsensus_tpu/serve/model.py``. A consensus model is
everything ``classify(new_cells)`` needs to label a cell against a
finished ``refine()`` without running DE and the tree again, stored as
one ``ArtifactStore`` stage (atomic writes, sha256, quarantine):

  * the DE-gene **panel** (the union the pipeline embedded on);
  * the **PCA basis** (column mean and components) that projects panel
    expression into the training embedding (``ops.pca.pca_basis``);
  * the **landmark centroids** and their occupancy-weighted Ward tree
    (``ops.pooling.landmark_ward_linkage``);
  * per-landmark **cluster labels** (occupancy-weighted majority vote);
  * a **drift calibration**: quantiles of the training cells' distance
    to their own landmark, from which the serving driver's quarantine
    gate takes its foreign-cell threshold.

The files are the reference's, so a model written by either package
loads in the other with the same fingerprint. A corrupt artifact (failed
checksum, truncated zip) is quarantined by the store and surfaces as a
typed :class:`~scconsensus_tpu_torch.serve.errors.ModelLoadError`, as
does a wrong schema or incoherent shapes.

The arrays stay numpy, as the reference keeps them: the artifact stores
them, the fingerprint hashes them and ``classify_host`` reads them. The
device buffers live on the device resolved when the model is loaded or
built (``cuda`` unless ``device="cpu"``; with no card that raises).
``classify`` gathers the panel columns on the host, as the reference
does, so only (n, |panel|) floats cross to the card; there it centres,
projects, takes the ‖a‖² + ‖b‖² − 2ab distances to the landmarks, the
argmin, the label and the distance, and one device→host copy returns
both. The reference computes this in one jitted XLA program, not in
Pallas, so it is plain tensor code here. ``classify_host`` is the
float64 numpy mirror the driver serves from, flagged degraded, while
its circuit breaker is open.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from scconsensus_tpu_torch.device import resolve_device
from scconsensus_tpu_torch.serve.errors import ModelLoadError

__all__ = [
    "MODEL_STAGE",
    "MODEL_SCHEMA",
    "MODEL_VERSION",
    "ConsensusModel",
    "freeze_model_arrays",
    "export_consensus_model",
    "load_consensus_model",
    "training_cells",
]

MODEL_STAGE = "consensus_model"
MODEL_SCHEMA = "scc-consensus-model"
MODEL_VERSION = 1

# Calibration quantiles of the training nearest-landmark distance
# (q50/q90/q99/max); the drift threshold is q99 × margin.
_CALIB_QS = (0.50, 0.90, 0.99, 1.0)


@dataclasses.dataclass
class ConsensusModel:
    """In-memory frozen model. Arrays are host numpy; ``device_buffers``
    uploads them once to ``device`` (resolved on first use when None)."""

    panel_idx: np.ndarray          # (F,) int64 gene rows of the DE union
    pca_mean: np.ndarray           # (F,) float32
    pca_components: np.ndarray     # (n_pcs, F) float32
    centroids: np.ndarray          # (k, n_pcs) float32 landmark centroids
    centroid_labels: np.ndarray    # (k,) int64 cluster label per landmark
    centroid_counts: np.ndarray    # (k,) int64 training occupancy
    tree_merge: np.ndarray         # landmark dendrogram (ops.linkage shape)
    tree_height: np.ndarray
    tree_order: np.ndarray
    calib_q: np.ndarray            # (len(_CALIB_QS),) distance quantiles
    drift_threshold: float         # distance beyond which a cell is foreign
    meta: Dict[str, Any]
    device: Optional[torch.device] = None
    _dev: Optional[tuple] = dataclasses.field(default=None, repr=False)
    _fp: Optional[str] = dataclasses.field(default=None, repr=False)

    # -- derived -----------------------------------------------------------
    @property
    def n_genes(self) -> int:
        return int(self.meta["n_genes"])

    @property
    def n_pcs(self) -> int:
        return int(self.pca_components.shape[0])

    @property
    def k(self) -> int:
        return int(self.centroids.shape[0])

    def fingerprint(self) -> str:
        """Short content hash of the decision surface (panel, basis,
        centroids, labels): two servers with one fingerprint answer
        identically. Memoized; the arrays are frozen."""
        if self._fp is None:
            import hashlib

            h = hashlib.sha256()
            for a in (self.panel_idx, self.pca_mean, self.pca_components,
                      self.centroids, self.centroid_labels):
                h.update(np.ascontiguousarray(a).tobytes())
            self._fp = h.hexdigest()[:16]
        return self._fp

    def to(self, device) -> "ConsensusModel":
        """The same model with its device buffers on ``device`` (a copy
        sharing the host arrays; ``self`` when it is there already)."""
        dev = resolve_device(device)
        if self.device is not None and torch.device(self.device) == dev:
            return self
        return dataclasses.replace(self, device=dev, _dev=None)

    # -- classify ----------------------------------------------------------
    def _gather_panel(self, cells: np.ndarray) -> np.ndarray:
        """(n, F) panel columns of ``cells``, gathered as the reference
        gathers them (``x[:, panel]``, a transposed view)."""
        x = np.asarray(cells, np.float32)
        if x.ndim != 2 or x.shape[1] != self.n_genes:
            raise ValueError(
                f"cells must be (n, {self.n_genes}) genes-length rows, "
                f"got {x.shape}"
            )
        return x[:, self.panel_idx]

    def device_buffers(self) -> tuple:
        """(mean, components, centroids, centroid labels) on the device,
        uploaded on first use."""
        if self._dev is None:
            dev = resolve_device(self.device)
            self.device = dev
            self._dev = (
                torch.as_tensor(self.pca_mean, dtype=torch.float32,
                                device=dev),
                torch.as_tensor(self.pca_components, dtype=torch.float32,
                                device=dev),
                torch.as_tensor(self.centroids, dtype=torch.float32,
                                device=dev),
                torch.as_tensor(self.centroid_labels, dtype=torch.int64,
                                device=dev),
            )
        return self._dev

    def _to_device(self, xp: np.ndarray) -> torch.Tensor:
        """Host (n, F) panel rows to the model's device, made contiguous
        first as the reference's ``jnp.asarray`` makes them. At a 2,048 ×
        2,000 batch that copy of the transposed view costs ~6x the gather
        itself; ``np.take(x, panel, axis=1)`` would write contiguous rows
        at once, but then the driver's guard exceeds 2 % of the classify
        on the card (``PERF.md``), so it waits for a cheaper guard."""
        return torch.from_numpy(np.ascontiguousarray(xp)).to(
            self.device_buffers()[0].device)

    def _classify_device(self, x: torch.Tensor) -> torch.Tensor:
        """(2, n) float64 on the device: row 0 the labels, row 1 the
        distance to the winning landmark."""
        from scconsensus_tpu_torch.ops.distance import sq_dists

        mean, comps, cents, clab = self.device_buffers()
        proj = (x - mean[None, :]) @ comps.T
        d2 = sq_dists(proj, cents)
        j = torch.argmin(d2, dim=1)
        d = torch.sqrt(torch.clamp(
            torch.gather(d2, 1, j[:, None])[:, 0], min=0.0))
        return torch.stack([clab[j].to(torch.float64), d.to(torch.float64)])

    @staticmethod
    def _to_host(packed: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
        """The one device→host copy that ends a classify (its sync
        point)."""
        out = packed.cpu().numpy()
        return out[0].astype(np.int64), out[1]

    def classify(self, cells: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Project and assign ``cells`` (n, G) in one device call. Returns
        ``(labels (n,) int64, dist (n,) float64)``, ``dist`` the euclidean
        distance to the winning landmark (the drift gate's signal)."""
        x = self._to_device(self._gather_panel(cells))
        return self._to_host(self._classify_device(x))

    def classify_host(self, cells: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Float64 numpy mirror of :meth:`classify`: the degraded path
        while the device path is broken. Same labels on well-separated
        data (ties may break differently at float32 and float64 margins;
        degraded responses are flagged, never silent)."""
        xp = self._gather_panel(cells).astype(np.float64)
        proj = (xp - self.pca_mean.astype(np.float64)) @ \
            self.pca_components.astype(np.float64).T
        c = self.centroids.astype(np.float64)
        d2 = (
            np.sum(proj * proj, axis=1, keepdims=True)
            - 2.0 * proj @ c.T
            + np.sum(c * c, axis=1)[None, :]
        )
        j = np.argmin(d2, axis=1)
        dist = np.sqrt(np.maximum(d2[np.arange(j.size), j], 0.0))
        return self.centroid_labels[j].astype(np.int64), dist

    def drift_fraction(self, dist: np.ndarray) -> float:
        """Share of a batch past the calibrated foreign-cell threshold."""
        d = np.asarray(dist, np.float64)
        if d.size == 0:
            return 0.0
        return np.count_nonzero(d > self.drift_threshold) / d.size


# --------------------------------------------------------------------------
# export
# --------------------------------------------------------------------------

def freeze_model_arrays(
    panel_idx: np.ndarray,
    pca_mean: np.ndarray,
    pca_components: np.ndarray,
    emb: np.ndarray,
    centroids: np.ndarray,
    assign: np.ndarray,
    cell_labels: np.ndarray,
    tree,
    n_genes: int,
    drift_margin: float,
    meta_extra: Optional[Dict[str, Any]] = None,
) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """The one arrays-and-meta assembly behind every model writer
    (``export_consensus_model`` and the soak's ``build_demo_model``):
    majority landmark labels, occupancy counts, drift calibration, schema
    stamp."""
    from scconsensus_tpu_torch.ops.pooling import centroid_majority_labels

    k = int(centroids.shape[0])
    counts = np.bincount(assign, minlength=k).astype(np.int64)
    cent_labels = centroid_majority_labels(assign, cell_labels, k)
    d = np.linalg.norm(emb.astype(np.float64) - centroids[assign], axis=1)
    calib_q = (np.quantile(d, _CALIB_QS) if d.size
               else np.zeros(len(_CALIB_QS)))
    drift_threshold = float(calib_q[_CALIB_QS.index(0.99)] * drift_margin)
    meta: Dict[str, Any] = {
        "schema": MODEL_SCHEMA,
        "version": MODEL_VERSION,
        "created_unix": round(time.time(), 3),
        "n_cells": int(emb.shape[0]),
        "n_genes": int(n_genes),
        "n_pcs": int(pca_components.shape[0]),
        "k": k,
        "drift_margin": float(drift_margin),
        "drift_threshold": drift_threshold,
        "label_values": sorted(int(v) for v in np.unique(cent_labels)),
    }
    meta.update(meta_extra or {})
    arrays = {
        "panel_idx": np.asarray(panel_idx, np.int64),
        "pca_mean": np.asarray(pca_mean, np.float32),
        "pca_components": np.asarray(pca_components, np.float32),
        "centroids": np.asarray(centroids, np.float32),
        "centroid_labels": cent_labels,
        "centroid_counts": counts,
        "tree_merge": np.asarray(tree.merge),
        "tree_height": np.asarray(tree.height),
        "tree_order": np.asarray(tree.order),
        "calib_q": np.asarray(calib_q, np.float64),
    }
    return arrays, meta


def training_cells(data, panel: np.ndarray,
                   device: torch.device) -> torch.Tensor:
    """(N, |panel|) float32 rows of the training cells on ``device``: a
    tensor or ``DeviceCSR`` is gathered on its own device, numpy and
    ``scipy.sparse`` on the host, and only the panel rows cross."""
    from scconsensus_tpu_torch.io.sparsemat import (
        DeviceCSR,
        is_sparse,
        rows_dense,
    )

    panel = np.asarray(panel, np.int64)
    if isinstance(data, (torch.Tensor, DeviceCSR)) or is_sparse(data):
        rows = torch.as_tensor(rows_dense(data, panel))
    else:
        rows = torch.from_numpy(
            np.ascontiguousarray(np.asarray(data)[panel], np.float32))
    return rows.to(device=device, dtype=torch.float32).T.contiguous()


def export_consensus_model(
    data,
    result,
    config,
    model_dir: str,
    deep_split: Optional[int] = None,
    n_landmarks: Optional[int] = None,
    drift_margin: Optional[float] = None,
    seed: Optional[int] = None,
    omega: Optional[torch.Tensor] = None,
    device=None,
) -> ConsensusModel:
    """Freeze a finished refinement into a servable consensus model.

    ``data`` is the training (G, N) matrix the pipeline ran on (numpy, a
    tensor, ``scipy.sparse`` or a ``DeviceCSR``, as ``refine()`` takes);
    ``result`` its ``ReclusterResult``; ``deep_split`` picks the cut the
    model serves (default: the deepest configured). The PCA basis is
    derived again with ``pca_basis`` at seed 0, as the reference's export
    does (``omega`` replaces its projection draw, see ``carry``), the
    training embedding is projected on ``device`` with TF32 off, and the
    landmarks come from ``landmark_ward_linkage`` over that embedding at
    ``config.random_seed``: a training cell replayed through ``classify``
    lands on the landmark it was calibrated against.
    """
    from scconsensus_tpu_torch.config import env_flag
    from scconsensus_tpu_torch.ops.pca import pca_basis
    from scconsensus_tpu_torch.ops.pooling import landmark_ward_linkage
    from scconsensus_tpu_torch.utils.artifacts import (
        ArtifactStore,
        config_fingerprint,
    )

    dev = resolve_device(device)
    ds = int(deep_split if deep_split is not None
             else config.deep_split_values[-1])
    key = f"deepsplit: {ds}"
    if key not in result.dynamic_labels:
        raise ValueError(
            f"result has no cut for deep_split={ds} "
            f"(available: {sorted(result.dynamic_labels)})"
        )
    labels = np.asarray(result.dynamic_labels[key], np.int64)
    panel = np.asarray(result.de_gene_union_idx, np.int64)
    n_pcs = int(result.embedding.shape[1])
    margin = float(drift_margin if drift_margin is not None
                   else env_flag("SCC_SERVE_DRIFT_MARGIN"))

    cells = training_cells(data, panel, dev)      # (N, F) on the device
    mean, comps = pca_basis(cells, n_pcs, seed=0, omega=omega)
    emb = (cells - mean[None, :]) @ comps.T
    tree, assign, cents, info = landmark_ward_linkage(
        emb,
        n_landmarks=n_landmarks,
        seed=int(seed if seed is not None else config.random_seed),
    )
    arrays, meta = freeze_model_arrays(
        panel, mean.cpu().numpy(), comps.cpu().numpy(), emb.cpu().numpy(),
        cents, assign, labels, tree,
        n_genes=int(data.shape[0]), drift_margin=margin,
        meta_extra={
            "deep_split": ds,
            "landmark_info": {kk: vv for kk, vv in info.items()
                              if isinstance(vv, (int, float, str))},
            "config_fp": config_fingerprint(json.loads(config.to_json())),
        },
    )
    ArtifactStore(model_dir).save(MODEL_STAGE, arrays, meta)
    return _assemble(arrays, meta, dev)


# --------------------------------------------------------------------------
# load (the sha256/quarantine path and the schema refusal)
# --------------------------------------------------------------------------

_REQUIRED_ARRAYS = (
    "panel_idx", "pca_mean", "pca_components", "centroids",
    "centroid_labels", "centroid_counts", "tree_merge", "tree_height",
    "tree_order", "calib_q",
)


def _assemble(arrays: Dict[str, np.ndarray], meta: Dict[str, Any],
              device: Optional[torch.device] = None) -> ConsensusModel:
    return ConsensusModel(
        panel_idx=np.asarray(arrays["panel_idx"], np.int64),
        pca_mean=np.asarray(arrays["pca_mean"], np.float32),
        pca_components=np.asarray(arrays["pca_components"], np.float32),
        centroids=np.asarray(arrays["centroids"], np.float32),
        centroid_labels=np.asarray(arrays["centroid_labels"], np.int64),
        centroid_counts=np.asarray(arrays["centroid_counts"], np.int64),
        tree_merge=arrays["tree_merge"],
        tree_height=arrays["tree_height"],
        tree_order=arrays["tree_order"],
        calib_q=np.asarray(arrays["calib_q"], np.float64),
        drift_threshold=float(meta["drift_threshold"]),
        meta={k: v for k, v in meta.items() if k != "_integrity"},
        device=device,
    )


def load_consensus_model(model_dir: str, readonly: bool = False,
                         device=None) -> ConsensusModel:
    """Load a frozen consensus model onto ``device`` (``cuda`` unless
    ``device="cpu"``), or refuse with a typed error.

    Refusals (all :class:`ModelLoadError`, never a served model): a
    missing artifact; a failed sha256 or an unparseable npz (the store
    has quarantined the files, ``quarantined=True``; a ``readonly`` store
    leaves them in place); a wrong schema name or version; incoherent
    shapes. The fault site ``serve_load`` fires here."""
    from scconsensus_tpu_torch.robust import faults
    from scconsensus_tpu_torch.utils.artifacts import (
        ArtifactCorrupt,
        ArtifactStore,
    )

    dev = resolve_device(device)
    faults.fault_point("serve_load")
    store = ArtifactStore(model_dir, readonly=readonly)
    if not store.has(MODEL_STAGE):
        raise ModelLoadError(
            f"no consensus model artifact at {model_dir!r} "
            f"(expected {MODEL_STAGE}.npz)"
        )
    try:
        arrays, meta = store.load(MODEL_STAGE)
    except ArtifactCorrupt as e:
        if readonly:
            # the readonly store refuses without renaming: say so, and
            # claim no quarantine that never happened
            raise ModelLoadError(
                f"consensus model at {model_dir!r} failed verification; "
                f"readonly store — files left in place, load refused: "
                f"{e}", quarantined=False,
            ) from e
        raise ModelLoadError(
            f"consensus model at {model_dir!r} failed verification and "
            f"was quarantined: {e}", quarantined=True,
        ) from e
    if meta.get("schema") != MODEL_SCHEMA:
        raise ModelLoadError(
            f"artifact at {model_dir!r} is not a consensus model "
            f"(schema={meta.get('schema')!r}, want {MODEL_SCHEMA!r})"
        )
    if meta.get("version") != MODEL_VERSION:
        raise ModelLoadError(
            f"consensus model version {meta.get('version')!r} unsupported "
            f"(this build knows version {MODEL_VERSION})"
        )
    missing = [a for a in _REQUIRED_ARRAYS if a not in arrays]
    if missing:
        raise ModelLoadError(
            f"consensus model at {model_dir!r} missing arrays: {missing}"
        )
    model = _assemble(arrays, meta, dev)
    f = model.pca_components.shape[1]
    if (model.panel_idx.shape[0] != f
            or model.pca_mean.shape[0] != f
            or model.centroids.shape[1] != model.pca_components.shape[0]
            or model.centroid_labels.shape[0] != model.centroids.shape[0]):
        raise ModelLoadError(
            f"consensus model at {model_dir!r} has incoherent shapes "
            f"(panel {model.panel_idx.shape}, mean {model.pca_mean.shape}, "
            f"components {model.pca_components.shape}, "
            f"centroids {model.centroids.shape})"
        )
    return model
