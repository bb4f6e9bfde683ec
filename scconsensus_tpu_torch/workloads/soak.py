"""Runnable workload-zoo soak worker: the scenario workload's
kill-resume unit and the topology clusterer's unit of replay.

The port of ``scconsensus_tpu/workloads/soak.py``::

    python -m scconsensus_tpu_torch.workloads.soak --dir DIR
        [--summary PATH] [--cells N] [--genes G] [--clusters K]
        [--samples S] [--seed S] [--fresh] [--topo] [--covers C]
        [--dim D] [--device cuda|cpu]

Default mode — the multi-sample scenario as a kill-resume unit: the
scenario's dataset and input labelings are pure functions of the seed
(``workloads.data.multi_sample_dataset`` + the per-sample unaligned
clustering), and the refine runs over a DURABLE artifact store under
``DIR/stages``. A run SIGKILLed mid-pipeline (``SCC_FAULT_PLAN`` kill
class at a stage site) leaves its completed stage artifacts behind; the
next run over the same DIR adopts them (``resumed_stages`` in the
summary) and must land a ``labels_sha`` byte-identical to an
uninterrupted run. The summary's ``record`` carries the validated
top-level ``scenario`` section plus the ``quality.scenario`` scoring
block (per-batch ARI + batch-mixing).

``--topo`` mode — the topology clusterer as a determinism unit: a
seeded gaussian embedding through ``workloads.topology
.topology_cluster``, summary = sha256 over the label strings, one sha
on every device and execution shape.

``--device`` defaults to ``cuda``. Exit code: 0 = the run completed and
its record validates; 1 = not.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import sys
import time
from typing import Any, Dict, Optional

import numpy as np

__all__ = ["run_workload_soak", "run_topo_audit", "main"]

# the pipeline's durable stage artifacts, in stage order — what a
# resumed run can adopt from a killed one
_STAGES = ("de", "embed", "tree", "cuts")


def run_workload_soak(
    workdir: str, n_cells: int = 3000, n_genes: int = 150,
    n_clusters: int = 3, n_samples: int = 2, seed: int = 7,
    fresh: bool = False, device=None,
) -> Dict[str, Any]:
    """One deterministic multi-sample scenario run over a durable
    artifact store; returns the summary dict (module doc). The PCA
    projection is the port's own draw, the same on the card and the CPU,
    so ``labels_sha`` is one across devices."""
    from scconsensus_tpu_torch.config import ReclusterConfig
    from scconsensus_tpu_torch.device import resolve_device
    from scconsensus_tpu_torch.models.pipeline import refine
    from scconsensus_tpu_torch.obs.export import (
        build_run_record,
        validate_run_record,
    )
    from scconsensus_tpu_torch.stream.soak import _labels_sha
    from scconsensus_tpu_torch.workloads import build_scenario_section
    from scconsensus_tpu_torch.workloads.common import final_labels
    from scconsensus_tpu_torch.workloads.multisample import (
        multi_sample_inputs,
        multi_sample_scores,
    )

    dev = resolve_device(device)
    stages_dir = os.path.join(workdir, "stages")
    if fresh:
        shutil.rmtree(stages_dir, ignore_errors=True)

    def _stage_stats() -> Dict[str, tuple]:
        out = {}
        for s in _STAGES:
            try:
                st = os.stat(os.path.join(stages_dir, f"{s}.npz"))
                out[s] = (st.st_mtime_ns, st.st_size, st.st_ino)
            except OSError:
                pass
        return out

    pre_stats = _stage_stats()

    params = dict(n_cells=n_cells, n_genes=n_genes,
                  n_clusters=n_clusters, n_samples=n_samples, seed=seed)
    data, truth, batches, _, consensus = multi_sample_inputs(params)
    config = ReclusterConfig(
        method="wilcox", q_val_thrs=0.1, log_fc_thrs=0.25, min_pct=5.0,
        deep_split_values=(1, 2), min_cluster_size=10,
        n_top_de_genes=20, random_seed=seed, artifact_dir=stages_dir,
    )
    t0 = time.perf_counter()
    result = refine(data, consensus, config, device=dev)
    wall = time.perf_counter() - t0

    # ADOPTION evidence, not mere pre-existence: a stage counts as
    # resumed only when its artifact existed before the run AND its
    # stat is byte-for-byte unchanged after it. A quarantined-and-
    # recomputed artifact (the pipeline renames the corrupt file aside
    # and os.replace's a fresh one) gets a new mtime/inode, so a silent
    # from-zero recompute can never masquerade as a resume.
    post_stats = _stage_stats()
    adopted = [s for s in _STAGES
               if s in pre_stats and post_stats.get(s) == pre_stats[s]]

    final = final_labels(result)
    scores = multi_sample_scores(final, truth, batches)
    quality = dict((result.metrics or {}).get("quality") or {})
    quality["scenario"] = scores
    rec = build_run_record(
        metric=f"workload-zoo soak: {n_cells}-cell multi_sample refine",
        value=round(wall, 3), unit="seconds",
        extra={"config": "workload-soak", "platform": dev.type,
               "resumed_stages": list(adopted)},
        spans=result.metrics.get("spans") or [],
        quality=quality,
        scenario=build_scenario_section("multi_sample", params,
                                        smoke=True),
        robustness=result.metrics.get("robustness"),
        integrity=result.metrics.get("integrity"),
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
    return {
        "ok": bool(invalid is None and have_all_cuts),
        "invalid": invalid,
        "wall_s": round(wall, 3),
        "labels_sha": _labels_sha(result.dynamic_labels),
        "resumed_stages": list(adopted),
        "per_batch_ari": scores["per_batch_ari"],
        "record": rec,
    }


def run_topo_audit(
    workdir: str, n_cells: int = 2000, dim: int = 8,
    n_clusters: int = 4, n_covers: int = 12, seed: int = 7,
    device=None,
) -> Dict[str, Any]:
    """One deterministic topology clustering of a seeded gaussian
    embedding; ``labels_sha`` must be invariant across devices and
    execution shapes."""
    from scconsensus_tpu_torch.workloads.topology import topology_cluster

    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x7070]))
    centers = rng.normal(0.0, 5.0, size=(n_clusters, dim))
    lab = rng.integers(0, n_clusters, size=n_cells)
    x = (centers[lab]
         + rng.normal(0.0, 0.8, size=(n_cells, dim))).astype(np.float32)
    t0 = time.perf_counter()
    labels = topology_cluster(x, n_covers=n_covers, seed=seed,
                              device=device)
    wall = time.perf_counter() - t0
    sha = hashlib.sha256("\n".join(labels.tolist()).encode()).hexdigest()
    return {
        "ok": True,
        "wall_s": round(wall, 3),
        "labels_sha": sha,
        "n_topo_clusters": len(set(labels.tolist())),
    }


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description="workload-zoo soak worker")
    ap.add_argument("--dir", required=True, help="work directory")
    ap.add_argument("--cells", type=int, default=3000)
    ap.add_argument("--genes", type=int, default=150)
    ap.add_argument("--clusters", type=int, default=3)
    ap.add_argument("--samples", type=int, default=2)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--summary", default=None)
    ap.add_argument("--fresh", action="store_true",
                    help="drop any durable stage artifacts first")
    ap.add_argument("--topo", action="store_true",
                    help="topology-determinism audit mode")
    ap.add_argument("--covers", type=int, default=12)
    ap.add_argument("--dim", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    summary_path = args.summary or os.path.join(
        args.dir, "WORKLOAD_SOAK_SUMMARY.json"
    )
    os.makedirs(args.dir, exist_ok=True)
    if args.topo:
        summary = run_topo_audit(
            args.dir, n_cells=args.cells, dim=args.dim,
            n_clusters=args.clusters, n_covers=args.covers,
            seed=args.seed, device=args.device,
        )
    else:
        summary = run_workload_soak(
            args.dir, n_cells=args.cells, n_genes=args.genes,
            n_clusters=args.clusters, n_samples=args.samples,
            seed=args.seed, fresh=args.fresh, device=args.device,
        )
    with open(summary_path, "w") as f:
        json.dump(summary, f, indent=1, default=str)
    print(json.dumps({
        "ok": summary["ok"],
        "labels_sha": summary["labels_sha"][:16],
        "resumed_stages": summary.get("resumed_stages"),
    }))
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
