"""Disk-resident chunked CSR store: the out-of-core input format.

The port's copy of ``scconsensus_tpu/stream/store.py``, in the same
on-disk format, so a store written by either package loads in the other.
A :class:`ChunkedCSRStore` holds a (G, N) sparse expression matrix as
fixed-row-window CSR blocks on disk::

    <root>/stream_manifest.json            # shape, window, chunk count
    <root>/chunk_00000.npz                 # data f32, indices i64, indptr i64
    <root>/chunk_00000.json                # {g0, g1, nnz, _integrity:{sha256, size}}
    ...

Every chunk is written through the shared mkstemp + fsync +
``os.replace`` primitive (``obs.export.atomic_write``) and sha256-stamped
with the same ``_integrity`` sidecar as the ArtifactStore
(``utils.artifacts.file_sha256``). Loads verify the stamp; a torn or
bit-flipped chunk is quarantined (``*.quarantined-N``) and raises
:class:`ChunkCorrupt`, a subclass of ArtifactCorrupt.

Disk faults: each write runs under the typed retry policy at site
``stream_chunk_write`` with a disk-class ``degrade`` hook that sweeps
reclaimable bytes (stale temps, quarantined files) before the retry; each
load passes the ``stream_chunk_read`` fault point. A ``kill`` plan at the
write site proves mid-ingest durability: the next process's
:meth:`ensure_chunk` adopts every chunk that finished its fsync and
replace, and recomputes exactly the rest. Left out against the
reference: the heartbeat's progress mark during ingest (with the live
recorder).
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np

from scconsensus_tpu_torch.obs.export import atomic_write, write_json_atomic
from scconsensus_tpu_torch.utils.artifacts import (
    ArtifactCorrupt,
    file_sha256,
    quarantine_files,
)

__all__ = ["ChunkedCSRStore", "ChunkCorrupt", "MANIFEST_NAME"]

MANIFEST_NAME = "stream_manifest.json"
MANIFEST_SCHEMA = "scc-stream-chunks"
MANIFEST_VERSION = 1


class ChunkCorrupt(ArtifactCorrupt):
    """A stored chunk failed its content checksum or would not parse.
    The offending files are already quarantined when this raises;
    :meth:`ChunkedCSRStore.ensure_chunk` recomputes through the
    caller's generator — the same quarantine-and-recompute contract as
    the ArtifactStore's stage artifacts."""


def _csr_parts(block) -> Dict[str, np.ndarray]:
    return {
        "data": np.asarray(block.data, np.float32),
        "indices": np.asarray(block.indices, np.int64),
        "indptr": np.asarray(block.indptr, np.int64),
    }


class ChunkedCSRStore:
    """Fixed-row-window CSR blocks of one (G, N) matrix on disk."""

    def __init__(self, root: str):
        self.root = root
        self._manifest: Optional[Dict[str, Any]] = None
        # per-run chunk accounting (the validated streaming section's
        # counters): each chunk index is classified ONCE per store
        # instance — "fresh" (computed+written by this run) or "resumed"
        # (adopted from a durable prior write) — so multi-pass reads
        # (ingest, DE, nodg) cannot double-count. A chunk that
        # quarantines AFTER being counted reclassifies resumed → fresh:
        # its durable copy proved unusable and this run recomputed it.
        self.counters: Dict[str, int] = {
            "fresh": 0, "resumed": 0, "recomputed": 0, "quarantined": 0,
        }
        self._counted_as: Dict[int, str] = {}

    # -- manifest ----------------------------------------------------------
    @property
    def manifest_path(self) -> str:
        return os.path.join(self.root, MANIFEST_NAME)

    @classmethod
    def create(cls, root: str, n_genes: int, n_cells: int,
               row_window: int,
               meta: Optional[Dict[str, Any]] = None) -> "ChunkedCSRStore":
        """Initialize (or re-open) a store for one matrix shape. An
        existing manifest must MATCH — resuming an ingest into a store
        of a different shape would silently interleave datasets."""
        os.makedirs(root, exist_ok=True)
        st = cls(root)
        doc = {
            "schema": MANIFEST_SCHEMA,
            "version": MANIFEST_VERSION,
            "n_genes": int(n_genes),
            "n_cells": int(n_cells),
            "row_window": int(row_window),
            "n_chunks": (int(n_genes) + int(row_window) - 1)
            // int(row_window),
            "meta": dict(meta or {}),
        }
        if os.path.exists(st.manifest_path):
            cur = st.manifest()
            same = all(cur.get(k) == doc[k] for k in
                       ("n_genes", "n_cells", "row_window"))
            if not same:
                raise ValueError(
                    f"chunk store {root!r} already holds a different "
                    f"matrix shape ({cur.get('n_genes')}x"
                    f"{cur.get('n_cells')} window "
                    f"{cur.get('row_window')}) — use a fresh directory"
                )
            return st
        write_json_atomic(st.manifest_path, doc)
        st._manifest = doc
        return st

    def manifest(self) -> Dict[str, Any]:
        if self._manifest is None:
            try:
                with open(self.manifest_path) as f:
                    m = json.load(f)
            except (OSError, json.JSONDecodeError) as e:
                raise ValueError(
                    f"chunk store {self.root!r}: manifest unreadable ({e})"
                )
            if m.get("schema") != MANIFEST_SCHEMA:
                raise ValueError(
                    f"chunk store {self.root!r}: unknown manifest schema "
                    f"{m.get('schema')!r}"
                )
            self._manifest = m
        return self._manifest

    @property
    def shape(self) -> Tuple[int, int]:
        m = self.manifest()
        return int(m["n_genes"]), int(m["n_cells"])

    @property
    def row_window(self) -> int:
        return int(self.manifest()["row_window"])

    @property
    def n_chunks(self) -> int:
        return int(self.manifest()["n_chunks"])

    def chunk_rows(self, i: int) -> Tuple[int, int]:
        g, _ = self.shape
        w = self.row_window
        return i * w, min((i + 1) * w, g)

    # -- paths -------------------------------------------------------------
    def _paths(self, i: int) -> Tuple[str, str]:
        stem = os.path.join(self.root, f"chunk_{int(i):05d}")
        return f"{stem}.npz", f"{stem}.json"

    def has_chunk(self, i: int) -> bool:
        npz, js = self._paths(i)
        return os.path.exists(npz) and os.path.exists(js)

    def chunk_host_bytes(self, i: int) -> int:
        """Host-byte estimate of a durable chunk's loaded CSR form (from
        the sidecar's nnz — data f32 + indices i64 + indptr i64), so the
        budget accountant can charge BEFORE the load exists. Falls back
        to a dense-ish bound when the sidecar is unreadable (the load
        will quarantine it anyway)."""
        npz, js = self._paths(i)
        g0, g1 = self.chunk_rows(i)
        try:
            with open(js) as f:
                nnz = int(json.load(f).get("nnz", 0))
        except (OSError, json.JSONDecodeError, ValueError):
            # sidecar unreadable: the load will quarantine-and-recompute
            # anyway, so estimate from the compressed file size (×4 for
            # decompression) rather than a dense bound — at 10M cells a
            # dense (window, N) estimate would bust the staged budget
            # BEFORE ensure_chunk could run the recovery path, turning a
            # recoverable torn sidecar into a fatal budget breach
            try:
                return os.path.getsize(npz) * 4 + (g1 - g0 + 1) * 8
            except OSError:
                return 0  # nothing durable: the generator recomputes
        return nnz * 12 + (g1 - g0 + 1) * 8

    def completed_chunks(self) -> int:
        """Count of durable chunks — the mid-ingest resume point a
        SIGKILLed writer leaves behind."""
        return sum(1 for i in range(self.n_chunks) if self.has_chunk(i))

    # -- write -------------------------------------------------------------
    def write_chunk(self, i: int, block) -> None:
        """Atomically persist chunk ``i`` (a scipy CSR block of exactly
        this chunk's rows) with its sha256 integrity stamp. Runs under
        the typed retry policy at ``stream_chunk_write``: a disk-class
        failure (real ENOSPC or an injected one) sweeps reclaimable
        bytes and retries; the fault plan's ``kill`` class fires at the
        site, which is the mid-ingest durability test vector."""
        from scconsensus_tpu_torch.robust import faults as _faults
        from scconsensus_tpu_torch.robust import retry as robust_retry

        g0, g1 = self.chunk_rows(i)
        if block.shape[0] != g1 - g0:
            raise ValueError(
                f"chunk {i}: block has {block.shape[0]} rows, expected "
                f"{g1 - g0} (rows [{g0}, {g1}))"
            )
        npz, js = self._paths(i)
        arrays = _csr_parts(block)

        def _write() -> None:
            def _wz(tmp: str) -> None:
                with open(tmp, "wb") as f:
                    np.savez_compressed(f, **arrays)

            def _seal(tmp: str) -> None:
                write_json_atomic(js, {
                    "g0": int(g0), "g1": int(g1),
                    "n_cells": int(block.shape[1]),
                    "nnz": int(block.nnz),
                    "_integrity": {
                        "sha256": file_sha256(tmp),
                        "size": os.path.getsize(tmp),
                    },
                })

            # sidecar (with the checksum of the exact bytes about to
            # land) goes FIRST via _seal, npz replace last: has_chunk()
            # keys on both files, so the only observable intermediate
            # state reads as chunk-not-durable and recomputes
            atomic_write(npz, _wz, inspect_fn=_seal)

        robust_retry.call(_write, site="stream_chunk_write",
                          degrade=lambda attempt: self._sweep_reclaimable())
        # fault plan's post-write corruption hook: a torn chunk models a
        # disk/transport fault AFTER the atomic replace — exactly what
        # the load-time checksum exists for
        _faults.corrupt_artifact("stream_chunk", npz)

    def _sweep_reclaimable(self) -> int:
        """Disk-class degrade hook: delete what the store can regenerate
        or no longer needs — stale atomic-write temps and quarantined
        corpses (their post-mortem value is worth less than completing
        the run that hit ENOSPC). Returns bytes reclaimed."""
        from scconsensus_tpu_torch.obs.export import ATOMIC_TMP_PREFIX
        from scconsensus_tpu_torch.robust import record as robust_record

        freed = 0
        try:
            for e in os.scandir(self.root):
                if not e.is_file():
                    continue
                if (e.name.startswith(ATOMIC_TMP_PREFIX)
                        or ".quarantined-" in e.name):
                    try:
                        freed += e.stat().st_size
                        os.unlink(e.path)
                    except OSError:
                        pass
        except OSError:
            pass
        robust_record.note_degradation(
            "stream_chunk_write", "sweep-reclaimable",
            f"disk fault: freed {freed} bytes of temps/quarantined "
            "corpses before the retry",
        )
        return freed

    # -- read --------------------------------------------------------------
    def load_chunk(self, i: int):
        """Chunk ``i`` as a scipy CSR block. Verifies the sidecar's
        content checksum; a mismatch or unparseable file quarantines
        BOTH files and raises :class:`ChunkCorrupt` — callers recompute
        through :meth:`ensure_chunk`, never resume garbage."""
        import scipy.sparse as sp

        from scconsensus_tpu_torch.robust import faults as _faults
        from scconsensus_tpu_torch.robust import record as robust_record

        _faults.fault_point("stream_chunk_read")
        npz, js = self._paths(i)
        g0, g1 = self.chunk_rows(i)

        def _quarantine(reason: str) -> None:
            quarantine_files([npz, js])
            robust_record.note_degradation(
                f"stream_chunk:{i}", "quarantine", reason
            )

        try:
            with open(js) as f:
                meta = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            _quarantine(f"sidecar unreadable: {e}")
            raise ChunkCorrupt(
                f"chunk {i}: sidecar unreadable ({e}); quarantined"
            )
        integ = meta.get("_integrity") or {}
        actual = file_sha256(npz)
        if actual != integ.get("sha256"):
            _quarantine(
                f"checksum mismatch ({actual[:12]} != "
                f"{str(integ.get('sha256'))[:12]})"
            )
            raise ChunkCorrupt(
                f"chunk {i}: torn chunk — content checksum mismatch; "
                "quarantined"
            )
        try:
            with np.load(npz, allow_pickle=False) as z:
                data = z["data"]
                indices = z["indices"]
                indptr = z["indptr"]
        except Exception as e:  # BadZipFile, truncated stream, ...
            _quarantine(f"unparseable npz: {e!r}")
            raise ChunkCorrupt(
                f"chunk {i}: unparseable npz ({e!r}); quarantined"
            )
        n_cells = int(meta.get("n_cells") or self.shape[1])
        return sp.csr_matrix(
            (data, indices, indptr), shape=(g1 - g0, n_cells)
        )

    def _count(self, i: int, kind: str) -> None:
        prev = self._counted_as.get(i)
        if prev == kind:
            return
        if prev is not None:
            self.counters[prev] -= 1
        self._counted_as[i] = kind
        self.counters[kind] += 1

    def ensure_chunk(self, i: int, compute_fn: Optional[
            Callable[[int, int], Any]] = None):
        """Load chunk ``i``, or compute+persist it via
        ``compute_fn(g0, g1)`` (a scipy CSR block of those rows). A
        corrupt stored chunk has been quarantined by :meth:`load_chunk`
        — with a generator it RECOMPUTES (counted), without one the
        typed ChunkCorrupt propagates (user-ingested data has no
        regeneration story, and silently fabricating rows would be
        worse than failing). The instance's ``counters`` feed the
        validated streaming section."""
        if self.has_chunk(i):
            try:
                block = self.load_chunk(i)
                if i not in self._counted_as:
                    self._count(i, "resumed")
                return block
            except ChunkCorrupt:
                self.counters["quarantined"] += 1
                if compute_fn is None:
                    raise
                # its durable copy proved unusable: whatever this run
                # adopted it as, it is now fresh work
                self.counters["recomputed"] += 1
                self._count(i, "fresh")
        elif compute_fn is None:
            raise ValueError(
                f"chunk store {self.root!r}: chunk {i} absent and no "
                "generator available to compute it"
            )
        g0, g1 = self.chunk_rows(i)
        block = compute_fn(g0, g1)
        self.write_chunk(i, block)
        self._count(i, "fresh")
        return block

    def iter_chunks(self, compute_fn: Optional[
            Callable[[int, int], Any]] = None
            ) -> Iterator[Tuple[int, int, Any]]:
        """Yield ``(g0, g1, csr_block)`` over every chunk in row order,
        loading (or generating) one at a time — the load → use → drop
        streaming contract; the caller owns budget charging because only
        it knows when the block is dropped."""
        for i in range(self.n_chunks):
            g0, g1 = self.chunk_rows(i)
            yield g0, g1, self.ensure_chunk(i, compute_fn)

    def adopt_durable(self) -> int:
        """Count every durable chunk as resumed WITHOUT loading it — a
        pre-ingested store (no generator) opening for a compute pass
        still reports honest section counters (missing chunks stay
        uncounted and fail typed at first access). Returns the count."""
        n = 0
        for i in range(self.n_chunks):
            if self.has_chunk(i):
                if i not in self._counted_as:
                    self._count(i, "resumed")
                n += 1
        return n

    # -- ingest ------------------------------------------------------------
    def ingest(self, compute_fn: Callable[[int, int], Any]) -> int:
        """Materialize every missing chunk from ``compute_fn(g0, g1)``
        (durable, resumable: chunks that already verify are skipped, so
        a SIGKILL mid-ingest resumes from the last fsynced chunk).
        Returns the number of chunks written this call."""
        from scconsensus_tpu_torch.obs import trace as obs_trace

        written = 0
        with obs_trace.span("stream_ingest", n_chunks=self.n_chunks):
            for i in range(self.n_chunks):
                if self.has_chunk(i):
                    # durable already: COUNT the resume without paying a
                    # verification read — the compute passes verify on
                    # their own loads (where a torn chunk can actually
                    # hurt), so ingest stays one write pass, not
                    # write+read
                    if i not in self._counted_as:
                        self._count(i, "resumed")
                    continue
                self.ensure_chunk(i, compute_fn)
                written += 1
        return written
