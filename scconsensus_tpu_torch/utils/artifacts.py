"""Stage-keyed artifact store with resume.

The port's copy of ``scconsensus_tpu/utils/artifacts.py``. Each pipeline
stage (per-pair DE tables → gene union → embedding → tree → cuts) is saved
under a stage key and is resumable: re-running a pipeline with the same
store skips completed stages. The files are the reference's, so a store
written by one package resumes in the other.

Format: one ``<stage>.npz`` per stage for arrays plus a ``<stage>.json``
sidecar for scalars/metadata — portable, no pickle. The sidecar carries
the arrays file's sha256 (``_integrity``); a load that finds other bytes,
or an npz that will not parse, moves the stage's files aside under
``*.quarantined-<n>`` names and raises ``ArtifactCorrupt``, and the stage
recomputes.

A ``readonly`` store (the serving path's frozen model directory, which
may live on a read-only mount) touches nothing on disk: it refuses
``save``, and a failed check raises without renaming the files. After
each write the fault plan's ``artifact:<stage>`` rule may corrupt the
file (``robust.faults.corrupt_artifact``), and every quarantine is noted
on the robustness log (``robust.record``).

Left out against the reference until a caller in the port needs them:
``discard_prefix`` (with the mid-stage checkpoints, ROADMAP A8) and the
``SCC_ROBUST_CHECKSUM`` switch (checksums are always written and
verified here).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from scconsensus_tpu_torch.io.sparsemat import DeviceCSR, is_sparse
from scconsensus_tpu_torch.obs.export import (
    ATOMIC_TMP_PREFIX as _TMP_PREFIX,
    atomic_write as _atomic_bytes_writer,
)
from scconsensus_tpu_torch.robust import faults as _faults
from scconsensus_tpu_torch.robust import record as _robust_record

__all__ = ["ArtifactStore", "ArtifactCorrupt", "input_fingerprint",
           "config_fingerprint", "file_sha256", "quarantine_files"]

_log = logging.getLogger("scconsensus_tpu_torch")


class ArtifactCorrupt(ValueError):
    """A stored artifact failed its content checksum or would not parse.
    The offending files are already quarantined when this raises; callers
    (``cached()``, the pipeline's de-resume path) recompute the stage."""


# Stages save atomically through obs.export.atomic_write: interrupted
# writers leave only stale ``.scc-tmp-*`` files, swept (when old) on the
# next store open.
_STALE_TMP_AGE_S = 3600.0


def input_fingerprint(data, labels) -> Dict[str, Any]:
    """Cheap content fingerprint of a pipeline's inputs: shape, nnz, a
    hash of a strided sample of the values (~64k float32) and a hash of
    the labels, so resuming a store with other data raises.

    ``data``: numpy, ``scipy.sparse``, a tensor or a ``DeviceCSR``. A
    tensor is strided on its own device and only the sample crosses to
    the host; its nnz is counted only at ≤ 1e7 elements (else −1), as the
    reference's device branch does. The same values give the reference's
    fingerprint."""
    h = hashlib.sha256()
    if isinstance(data, DeviceCSR):
        vals = data.values
        nnz = int(vals.numel())
    elif is_sparse(data):
        vals = data.data
        nnz = int(data.nnz)
    elif isinstance(data, torch.Tensor):
        vals = data.reshape(-1)
        nnz = int((data != 0).sum()) if vals.numel() <= 10_000_000 else -1
    else:
        vals = np.asarray(data).ravel()
        nnz = int(np.count_nonzero(data)) if vals.size <= 10_000_000 else -1
    n = int(vals.numel()) if isinstance(vals, torch.Tensor) else vals.size
    sample = vals[::max(1, n // 65_536)]
    if isinstance(sample, torch.Tensor):
        sample = sample.cpu().numpy()
    h.update(np.ascontiguousarray(sample, dtype=np.float32).tobytes())
    lab = np.asarray(labels).astype(str)
    lh = hashlib.sha256("\x00".join(lab.tolist()).encode()).hexdigest()[:16]
    return {
        "shape": [int(s) for s in data.shape],
        "nnz": nnz,
        "data_sample_sha": h.hexdigest()[:16],
        "labels_sha": lh,
    }


def config_fingerprint(obj: Any, n_hex: int = 12) -> str:
    """Short, key-order-independent content hash of a JSON-able value
    (the reference's): a frozen model stamps its config's with it.
    Non-JSON leaves go through ``str``, so a numpy scalar fingerprints
    like its value."""
    blob = json.dumps(obj, sort_keys=True, default=str, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:n_hex]


def file_sha256(path: str) -> str:
    """Streaming sha256 of a file's bytes: the content checksum of every
    stored artifact."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def quarantine_files(paths) -> list:
    """Move files aside under ``<path>.quarantined-<n>`` names (never
    silently delete what might be the only copy of a long compute).
    Returns the destination names."""
    dests = []
    for path in paths:
        if not os.path.exists(path):
            continue
        n = 0
        dest = f"{path}.quarantined-{n}"
        while os.path.exists(dest):
            n += 1
            dest = f"{path}.quarantined-{n}"
        try:
            os.replace(path, dest)
            dests.append(dest)
        except OSError:
            try:  # last resort: a corrupt file must not stay loadable
                os.unlink(path)
            except OSError:
                pass
    return dests


class ArtifactStore:
    def __init__(self, root: Optional[str], readonly: bool = False):
        """``root`` None disables the store (nothing is read or written).
        ``readonly=True`` opens it without touching the filesystem (no
        mkdir, no sweep of stale temps)."""
        self.root = root
        self.readonly = bool(readonly)
        if root is not None and not self.readonly:
            os.makedirs(root, exist_ok=True)
            self._sweep_stale_tmp()

    def _sweep_stale_tmp(self) -> None:
        """Remove temp files orphaned by an interrupted writer. Only temps
        older than ``_STALE_TMP_AGE_S`` go: a second process opening the
        same store must not yank a live writer's in-flight temp."""
        try:
            cutoff = time.time() - _STALE_TMP_AGE_S
            for e in os.scandir(self.root):
                if (e.name.startswith(_TMP_PREFIX) and e.is_file()
                        and e.stat().st_mtime < cutoff):
                    try:
                        os.unlink(e.path)
                    except OSError:
                        pass
        except OSError:
            pass

    @property
    def enabled(self) -> bool:
        return self.root is not None

    def _paths(self, stage: str):
        assert self.root is not None
        return (
            os.path.join(self.root, f"{stage}.npz"),
            os.path.join(self.root, f"{stage}.json"),
        )

    def check_config(
        self, config_json: str, inputs: Optional[Dict[str, Any]] = None
    ) -> None:
        """Pin the store to one pipeline configuration + input fingerprint.

        The first call writes ``config.json`` (``{"config": ..., "inputs":
        ...}``); later calls compare and raise ValueError on a mismatch:
        stage caches are keyed only by stage name, so resuming with another
        config or other input data would silently return stale results."""
        if not self.enabled:
            return
        config = json.loads(config_json)
        path = os.path.join(self.root, "config.json")
        if os.path.exists(path):
            with open(path) as f:
                stored = json.load(f)
            if stored.get("config") != config:
                raise ValueError(
                    f"artifact store {self.root!r} was written with a "
                    "different config — use a fresh artifact_dir for a new "
                    "configuration (stored fingerprint: config.json)"
                )
            if (
                inputs is not None
                and stored.get("inputs") is not None
                and stored["inputs"] != inputs
            ):
                raise ValueError(
                    f"artifact store {self.root!r} was written with "
                    "different input data — use a fresh artifact_dir for a "
                    "new dataset (stored fingerprint: config.json)"
                )
            return

        def _w(tmp):
            with open(tmp, "w") as f:
                json.dump({"config": config, "inputs": inputs}, f, indent=2)

        _atomic_bytes_writer(path, _w)

    def has(self, stage: str) -> bool:
        """True iff the stage's array artifact exists (the resume key).
        Meta sidecars alone do not mark a stage complete."""
        if not self.enabled:
            return False
        npz, _ = self._paths(stage)
        return os.path.exists(npz)

    def save(self, stage: str, arrays: Optional[Dict[str, np.ndarray]] = None,
             meta: Optional[Dict[str, Any]] = None) -> None:
        """Atomic per-file writes, meta before arrays: ``has()`` keys
        resume on the ``.npz``, so the only observable intermediate state
        (meta present, arrays absent) reads as stage-not-complete.

        The arrays file is serialized to its temp first so its sha256 can
        ride the sidecar (``_integrity``)."""
        if not self.enabled:
            return
        if self.readonly:
            raise RuntimeError(
                f"artifact store {self.root!r} is readonly — a frozen "
                "model directory is never written by the serving path"
            )
        npz, js = self._paths(stage)

        def _write_sidecar(integrity: Optional[Dict[str, Any]]) -> None:
            payload = dict(meta or {})
            if integrity is not None:
                payload["_integrity"] = integrity

            def _wj(tmp):
                with open(tmp, "w") as f:
                    json.dump(payload, f, indent=2, default=str)

            _atomic_bytes_writer(js, _wj)

        if arrays is None:
            if meta is not None:
                _write_sidecar(None)
            return

        def _wz(tmp):
            # an explicit file handle writes exactly to the temp path
            # (savez_compressed appends .npz to a bare name)
            with open(tmp, "wb") as f:
                np.savez_compressed(
                    f, **{k: np.asarray(v) for k, v in arrays.items()}
                )

        def _seal(tmp):
            # between serialize and replace: checksum the exact bytes about
            # to land, then write the sidecar (meta before arrays)
            _write_sidecar({"sha256": file_sha256(tmp),
                            "size": os.path.getsize(tmp)})

        _atomic_bytes_writer(npz, _wz, inspect_fn=_seal)
        # the fault plan's post-write corruption (artifact:<stage>): a
        # disk or transport fault after the replace, which the load-time
        # checksum exists for
        _faults.corrupt_artifact(stage, npz)

    def _quarantine(self, stage: str, reason: str) -> None:
        """Move the stage's files aside under ``*.quarantined-<n>`` names
        and note it on the robustness log. A readonly store leaves the
        files where they are: the load still raises, nothing is served."""
        if self.readonly:
            _robust_record.note_degradation(
                f"artifact:{stage}", "quarantine", reason + " (readonly)")
            _log.warning("artifact %r failed verification (%s); store is "
                         "readonly, files left in place and load refused",
                         stage, reason)
            return
        quarantine_files(self._paths(stage))
        _robust_record.note_degradation(f"artifact:{stage}", "quarantine",
                                        reason)
        _log.warning("artifact %r quarantined (%s); stage will recompute",
                     stage, reason)

    def load(self, stage: str):
        """(arrays, meta) for a stage. Verifies the sidecar's checksum when
        present; corrupt or unparseable
        entries are quarantined and raise :class:`ArtifactCorrupt`. Stores
        without ``_integrity`` load unverified."""
        npz, js = self._paths(stage)
        meta: Dict[str, Any] = {}
        if os.path.exists(js):
            try:
                with open(js) as f:
                    meta = json.load(f)
            except (json.JSONDecodeError, OSError) as e:
                self._quarantine(stage, f"sidecar unreadable: {e}")
                raise ArtifactCorrupt(
                    f"artifact {stage!r}: sidecar unreadable ({e}); "
                    "quarantined"
                )
        arrays: Dict[str, np.ndarray] = {}
        if os.path.exists(npz):
            integ = meta.get("_integrity")
            if integ:
                actual = file_sha256(npz)
                if actual != integ.get("sha256"):
                    self._quarantine(
                        stage,
                        f"checksum mismatch ({actual[:12]} != "
                        f"{str(integ.get('sha256'))[:12]})",
                    )
                    raise ArtifactCorrupt(
                        f"artifact {stage!r}: content checksum mismatch; "
                        "quarantined"
                    )
            try:
                with np.load(npz, allow_pickle=False) as z:
                    arrays = {k: z[k] for k in z.files}
            except Exception as e:  # BadZipFile, truncated stream, ...
                self._quarantine(stage, f"unparseable npz: {e!r}")
                raise ArtifactCorrupt(
                    f"artifact {stage!r}: unparseable ({e!r}); quarantined"
                )
        return arrays, meta

    def cached(self, stage: str, fn: Callable[[], Dict[str, np.ndarray]],
               meta_fn: Optional[Callable[[], Dict[str, Any]]] = None):
        """Run ``fn`` (returning a dict of arrays) unless ``stage`` already
        has a saved artifact, in which case load and return it. A corrupt
        stored artifact has been quarantined by ``load``: fall through and
        recompute. ``meta_fn()`` gives the sidecar of a computed stage."""
        if self.has(stage):
            try:
                return self.load(stage)[0]
            except ArtifactCorrupt:
                pass  # quarantined inside load(); recompute below
        arrays = fn()
        self.save(stage, arrays, meta_fn() if meta_fn else None)
        return arrays
