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

``discard_prefix`` removes the mid-stage Wilcoxon blocks (``de_wilcox_*``)
once the covering ``de`` artifact lands; ``load_many`` reads and checks
several stages on parallel threads (a resume's ladder blocks). Each file
is read once and hashed over those bytes. The hashing is the robustness
layer's own cost and is timed onto ``robust.record``'s ``consumed_s``,
as in the reference. ``SCC_ROBUST_CHECKSUM=0`` turns the checksums off,
as ``scconsensus_tpu/utils/artifacts.py:233-237`` does: saves write no
``_integrity`` and loads verify none.
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from scconsensus_tpu_torch.config import env_flag
from scconsensus_tpu_torch.io.sparsemat import DeviceCSR, is_sparse
from scconsensus_tpu_torch.obs.export import (
    ATOMIC_TMP_PREFIX as _TMP_PREFIX,
    atomic_write as _atomic_bytes_writer,
)
from scconsensus_tpu_torch.robust import faults as _faults
from scconsensus_tpu_torch.robust import record as _robust_record

__all__ = ["ArtifactStore", "ArtifactCorrupt", "input_fingerprint",
           "config_fingerprint", "file_sha256", "quarantine_files",
           "SERIAL_MESH_SHAPE"]

# the serial run's mesh stamp (parallel.mesh.mesh_shape_meta(None), the
# reference's JSON); refine()'s stages stamp the supervisor's live shape
SERIAL_MESH_SHAPE = {"n_devices": 1, "device_ids": [0], "axis": "cells",
                     "platform": None}

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
    from scconsensus_tpu_torch.obs import residency

    with residency.boundary("input_staging"):
        return _input_fingerprint(data, labels)


def _input_fingerprint(data, labels) -> str:
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


def _checksums_on() -> bool:
    """``SCC_ROBUST_CHECKSUM`` (default on), read at each save and load."""
    return bool(env_flag("SCC_ROBUST_CHECKSUM"))


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
             meta: Optional[Dict[str, Any]] = None,
             compress: bool = True) -> None:
        """Atomic per-file writes, meta before arrays: ``has()`` keys
        resume on the ``.npz``, so the only observable intermediate state
        (meta present, arrays absent) reads as stage-not-complete.

        The arrays file is serialized to its temp first so its sha256 can
        ride the sidecar (``_integrity``). ``compress=False`` writes a
        plain ``.npz`` (``np.savez``) for arrays that zlib cannot shrink;
        ``load`` and the reference read either form."""
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

        writer = np.savez_compressed if compress else np.savez
        checksums = _checksums_on()
        integrity: Dict[str, Any] = {}

        def _wz(tmp):
            # serialize once in memory, checksum exactly those bytes, and
            # write them to the temp path
            buf = io.BytesIO()
            writer(buf, **{k: np.asarray(v) for k, v in arrays.items()})
            data = buf.getbuffer()
            if checksums:
                with _robust_record.timed():
                    integrity["sha256"] = hashlib.sha256(data).hexdigest()
                integrity["size"] = len(data)
            with open(tmp, "wb") as f:
                f.write(data)

        def _seal(tmp):
            # between serialize and replace: the sidecar, meta before arrays
            if checksums or meta is not None:
                _write_sidecar(integrity if checksums else None)

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

    def _fetch(self, stage: str):
        """(meta, the arrays file's bytes or None, their sha256 or None),
        or the reason the sidecar fails (a str): the file is read once
        and, when the sidecar carries ``_integrity``, hashed. Touches no
        state, so threads may run it side by side."""
        npz, js = self._paths(stage)
        meta: Dict[str, Any] = {}
        if os.path.exists(js):
            try:
                with open(js) as f:
                    meta = json.load(f)
            except (json.JSONDecodeError, OSError) as e:
                return f"sidecar unreadable: {e}"
        if not os.path.exists(npz):
            return meta, None, None
        with open(npz, "rb") as f:
            data = f.read()
        digest = (hashlib.sha256(data).hexdigest()
                  if meta.get("_integrity") and _checksums_on() else None)
        return meta, data, digest

    @staticmethod
    def _parse(got):
        """(arrays, meta) from ``_fetch``'s result, or the reason the
        stage fails verification (a str)."""
        if isinstance(got, str):
            return got
        meta, data, digest = got
        if data is None:
            return {}, meta
        want = (meta.get("_integrity") or {}).get("sha256")
        if digest is not None and digest != want:
            return f"checksum mismatch ({digest[:12]} != {str(want)[:12]})"
        try:
            with np.load(io.BytesIO(data), allow_pickle=False) as z:
                return {k: z[k] for k in z.files}, meta
        except Exception as e:  # BadZipFile, truncated stream, ...
            return f"unparseable npz: {e!r}"

    def load(self, stage: str):
        """(arrays, meta) for a stage. Verifies the sidecar's checksum when
        present; corrupt or unparseable
        entries are quarantined and raise :class:`ArtifactCorrupt`. Stores
        without ``_integrity`` load unverified."""
        with _robust_record.timed():
            got = self._fetch(stage)
        got = self._parse(got)
        if isinstance(got, str):
            self._quarantine(stage, got)
            raise ArtifactCorrupt(f"artifact {stage!r}: {got}; quarantined")
        return got

    def load_many(self, stages) -> Dict[str, Any]:
        """``load`` of several stages at once: their reads and checksums
        run on parallel threads (hashing releases the GIL), that wall
        timed onto the robustness layer as ``load`` times its own. Returns
        each stage's (arrays, meta), or None where it fails verification:
        nothing is quarantined here, so a caller that needs such a stage
        ``load``s it to quarantine it."""
        from concurrent.futures import ThreadPoolExecutor

        stages = list(stages)
        if not stages:
            return {}
        with _robust_record.timed():
            with ThreadPoolExecutor(
                    min(len(stages), os.cpu_count() or 1, 8)) as pool:
                fetched = list(pool.map(self._fetch, stages))
        out = {}
        for st, got in zip(stages, fetched):
            got = self._parse(got)
            out[st] = None if isinstance(got, str) else got
        return out

    def stages_with_prefix(self, prefix: str) -> list:
        """The stages whose arrays file is present and whose name starts
        with ``prefix``."""
        if not self.enabled:
            return []
        try:
            return sorted(e.name[:-len(".npz")] for e in os.scandir(self.root)
                          if e.name.startswith(prefix)
                          and e.name.endswith(".npz") and e.is_file())
        except OSError:
            return []

    def discard_prefix(self, prefix: str) -> int:
        """Remove every stage artifact whose file name starts with
        ``prefix`` (.npz and .json): the mid-stage checkpoints, once the
        covering stage artifact has landed. Returns the number of files
        removed; quarantined files stay for post-mortems."""
        if not self.enabled or self.readonly:
            return 0
        n = 0
        try:
            for e in os.scandir(self.root):
                if (e.name.startswith(prefix) and e.is_file()
                        and (e.name.endswith(".npz")
                             or e.name.endswith(".json"))):
                    try:
                        os.unlink(e.path)
                        n += 1
                    except OSError:
                        pass
        except OSError:
            pass
        return n

    def cached(self, stage: str, fn: Callable[[], Dict[str, np.ndarray]],
               meta_fn: Optional[Callable[[], Dict[str, Any]]] = None,
               on_load_meta: Optional[Callable[[Dict[str, Any]], Any]]
               = None):
        """Run ``fn`` (returning a dict of arrays) unless ``stage`` already
        has a saved artifact, in which case load and return it. A corrupt
        stored artifact has been quarantined by ``load``: fall through and
        recompute. ``meta_fn()`` gives the sidecar of a computed stage;
        ``on_load_meta(meta)`` sees the stored sidecar of a resumed one
        (the elastic supervisor reads its ``mesh_shape`` stamp there)."""
        if self.has(stage):
            try:
                arrays, meta = self.load(stage)
                if on_load_meta is not None:
                    on_load_meta(meta)
                return arrays
            except ArtifactCorrupt:
                pass  # quarantined inside load(); recompute below
        arrays = fn()
        self.save(stage, arrays, meta_fn() if meta_fn else None)
        return arrays
