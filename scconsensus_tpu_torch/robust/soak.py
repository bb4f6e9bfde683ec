"""Runnable integrity-soak worker: the chaos harness's in-memory workload
and the cross-shape determinism auditor's unit of replay.

The port of ``scconsensus_tpu/robust/soak.py``::

    python -m scconsensus_tpu_torch.robust.soak --dir DIR [--cells N]
        [--genes G] [--clusters K] [--seed S] [--summary PATH]
        [--stream] [--stream-window W] [--mesh none|auto|<n>]
        [--fresh] [--device cuda|cpu]

Builds the same deterministic planted-marker dataset as the streaming
soak (``stream.soak.chunk_generator``: every row a pure function of
(seed, gene), independent of chunk boundaries) and runs one full
``refine()`` over it: in-memory CSR by default, or out of core through a
``ChunkedCSRStore`` with ``--stream`` (``--stream-window`` sets the chunk
shape). Writes one summary JSON whose ``labels_sha`` is a pure function
of (seed, shape), and equal to the reference's at the same seed and
shape when the reference's PCA projection is handed over (``omega``;
the port's own draw is the same on the card and the CPU). ``--mesh``:
``none`` (default) the serial path, ``auto`` every visible card
(``parallel.mesh.auto_mesh``: serial on one card), ``<n>`` an n-shard
``parallel.mesh.make_mesh(n, device=...)`` on the one device, the port's
counterpart of the reference's forced virtual XLA devices; a mesh run
gives the serial run's sha. ``--device`` defaults to ``cuda``.

The exit code is the contract: 0 = the run completed, its run record
(with the integrity, robustness and streaming sections it has)
validates, and every deepSplit has labels; 1 = the contract broke.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
from typing import Any, Dict, Optional

__all__ = ["run_integrity_soak", "main"]


def _resolve_mesh(mesh, device):
    """``none`` → None, ``auto`` → "auto", ``<n>`` (or an int) → an
    n-shard mesh on ``device``."""
    if mesh is None or str(mesh) == "none":
        return None
    if str(mesh) == "auto":
        return "auto"
    from scconsensus_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(int(mesh), device=device)


def run_integrity_soak(
    workdir: str, n_cells: int = 3000, n_genes: int = 120,
    n_clusters: int = 3, seed: int = 7, stream: bool = False,
    stream_window: Optional[int] = None, mesh="none",
    fresh: bool = False, device=None, omega=None,
) -> Dict[str, Any]:
    """One deterministic refine; returns the summary dict (module doc).
    ``omega``: the PCA projection to use instead of the port's own draw
    (``carry.omega_from_reference`` hands over the reference's, which is
    what makes the two packages' ``labels_sha`` comparable)."""
    from scconsensus_tpu_torch.config import ReclusterConfig
    from scconsensus_tpu_torch.device import resolve_device
    from scconsensus_tpu_torch.models.pipeline import refine
    from scconsensus_tpu_torch.obs.export import (
        build_run_record,
        validate_run_record,
    )
    from scconsensus_tpu_torch.stream.soak import (
        _labels_sha,
        chunk_generator,
        consensus_input,
    )

    dev = resolve_device(device)
    gen = chunk_generator(n_genes, n_cells, n_clusters, seed)
    labels = consensus_input(n_cells, n_clusters, seed)
    config = ReclusterConfig(
        method="wilcox", q_val_thrs=0.1, log_fc_thrs=0.25, min_pct=5.0,
        deep_split_values=(1, 2), min_cluster_size=10,
        n_top_de_genes=20, random_seed=seed,
    )
    t0 = time.perf_counter()
    if stream:
        from scconsensus_tpu_torch.stream.runner import streaming_refine
        from scconsensus_tpu_torch.stream.store import ChunkedCSRStore

        chunks_dir = os.path.join(workdir, "chunks")
        stages_dir = os.path.join(workdir, "stages")
        if fresh:
            for d in (chunks_dir, stages_dir):
                shutil.rmtree(d, ignore_errors=True)
        win = int(stream_window or 32)
        store = ChunkedCSRStore.create(chunks_dir, n_genes, n_cells, win)
        config.artifact_dir = stages_dir
        result = streaming_refine(store, labels, config,
                                  stage_dir=stages_dir, regen=gen,
                                  device=dev, omega=omega)
    else:
        data = gen(0, n_genes)  # one scipy CSR matrix, seed-pure
        result = refine(data, labels, config, device=dev, omega=omega,
                        mesh=_resolve_mesh(mesh, dev))
    wall = time.perf_counter() - t0
    ig = result.metrics.get("integrity")
    rb = result.metrics.get("robustness")
    rec = build_run_record(
        metric=f"integrity soak: {n_cells}-cell refine",
        value=round(wall, 3), unit="seconds",
        extra={"config": "integrity-soak", "platform": dev.type,
               "n_cells": n_cells, "n_genes": n_genes,
               "stream": bool(stream), "mesh": str(mesh)},
        spans=result.metrics.get("spans") or [],
        robustness=rb,
        integrity=ig,
        streaming=result.metrics.get("streaming"),
    )
    invalid = None
    try:
        validate_run_record(rec)
    except ValueError as e:
        invalid = str(e)
    have_all_cuts = all(
        f"deepsplit: {d}" in result.dynamic_labels
        for d in config.deep_split_values
    )
    gh = (ig or {}).get("ghost") or {}
    sc_retries = [r for r in (rb or {}).get("retries") or []
                  if r.get("error_class") == "silent_corruption"
                  and r.get("recovered")]
    mesh_transitions = (rb or {}).get("mesh_transitions") or []
    return {
        "ok": bool(invalid is None and have_all_cuts),
        "invalid": invalid,
        "wall_s": round(wall, 3),
        "labels_sha": _labels_sha(result.dynamic_labels),
        "integrity": ig,
        "detections": (len((ig or {}).get("violations") or [])
                       + len(gh.get("mismatches") or [])),
        "recomputes": gh.get("recomputes", 0),
        "sc_retries_recovered": len(sc_retries),
        "mesh_transitions": len(mesh_transitions),
        "mesh_final_devices": (
            len(mesh_transitions[-1].get("to_devices") or [])
            if mesh_transitions else None
        ),
        "record": rec,
    }


def _mesh_arg(v: str) -> str:
    if v in ("none", "auto") or (v.isdigit() and int(v) >= 1):
        return v
    raise argparse.ArgumentTypeError(
        f"--mesh takes none, auto or a shard count, got {v!r}")


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description="integrity soak worker")
    ap.add_argument("--dir", required=True, help="work directory")
    ap.add_argument("--cells", type=int, default=3000)
    ap.add_argument("--genes", type=int, default=120)
    ap.add_argument("--clusters", type=int, default=3)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--stream", action="store_true",
                    help="run out-of-core through a ChunkedCSRStore")
    ap.add_argument("--stream-window", type=int, default=None)
    ap.add_argument("--mesh", type=_mesh_arg, default="none",
                    help="none (default), auto (every visible card) or a "
                         "shard count n: an n-shard mesh on --device")
    ap.add_argument("--summary", default=None)
    ap.add_argument("--fresh", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    summary_path = args.summary or os.path.join(
        args.dir, "INTEGRITY_SOAK_SUMMARY.json"
    )
    os.makedirs(args.dir, exist_ok=True)
    summary = run_integrity_soak(
        args.dir, n_cells=args.cells, n_genes=args.genes,
        n_clusters=args.clusters, seed=args.seed, stream=args.stream,
        stream_window=args.stream_window, mesh=args.mesh,
        fresh=args.fresh, device=args.device,
    )
    with open(summary_path, "w") as f:
        json.dump(summary, f, indent=1, default=str)
    print(json.dumps({
        "ok": summary["ok"],
        "detections": summary["detections"],
        "recomputes": summary["recomputes"],
        "mesh_transitions": summary["mesh_transitions"],
        "labels_sha": summary["labels_sha"][:16],
    }))
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
