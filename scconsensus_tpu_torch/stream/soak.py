"""Runnable streaming-soak worker: the out-of-core chaos workload, and
the brain10m generator.

The port's form of ``scconsensus_tpu/stream/soak.py``::

    python -m scconsensus_tpu_torch.stream.soak --dir DIR [--cells N]
        [--genes G] [--clusters K] [--seed S] [--window W]
        [--budget-mb MB] [--stage-budget-mb MB] [--summary PATH]
        [--fresh] [--device cuda|cpu]

Builds (or resumes) a deterministic chunked synthetic dataset under
``DIR/chunks`` (every chunk is a pure function of the seed and its row
range, so a quarantined chunk regenerates byte-identically and a killed
ingest resumes into the same matrix), runs ``streaming_refine`` with
``DIR/stages`` as the resumable progress store, and writes one summary
JSON. The exit code is the chaos contract:

  0  the run completed all chunks, its run record (``obs.export``,
     with the ``streaming`` and, when present, ``robustness`` sections)
     validates, and every deepSplit has labels;
  1  the contract broke.

The summary's keys, its run record (``record``) and ``labels_sha`` are
the reference's, so the two packages' workers can be held to each other.
``--device`` defaults to ``cuda``.

:func:`chunk_generator` is also the brain10m generator: the same planted
marker shape at any cell count, one gene window in memory at a time.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import sys
import time
from typing import Any, Callable, Dict, Optional

import numpy as np

__all__ = ["chunk_generator", "truth_labels", "consensus_input",
           "run_stream_soak", "main"]


def truth_labels(n_cells: int, n_clusters: int, seed: int) -> np.ndarray:
    """Planted per-cell cluster assignment (int, 0..K-1): O(N) memory,
    deterministic, shared by the generator and the consensus input."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xCE11]))
    return rng.integers(0, n_clusters, size=n_cells).astype(np.int32)


def chunk_generator(
    n_genes: int, n_cells: int, n_clusters: int, seed: int,
    density: float = 0.25, marker_frac: float = 0.6,
) -> Callable[[int, int], Any]:
    """``fn(g0, g1) -> scipy CSR block`` of planted-marker expression.

    Gene ``g`` is a marker of cluster ``g % K``: background entries at
    ``density/2`` over all cells, elevated entries over ``marker_frac``
    of the marker cluster's cells. Each row's randomness is seeded by
    ``(seed, g)`` alone, so a chunk (and the whole matrix) is a pure
    function of the seed and the row range, independent of chunk
    boundaries: window halvings, resumes and quarantine recomputes all
    regenerate byte-identical rows. The reference's draws, call for call.
    """
    import scipy.sparse as sp

    truth = truth_labels(n_cells, n_clusters, seed)
    cells_of = [np.nonzero(truth == k)[0] for k in range(n_clusters)]

    def gen(g0: int, g1: int):
        rows, cols, vals = [], [], []
        for g in range(g0, g1):
            rng = np.random.default_rng(np.random.SeedSequence([seed, g]))
            n_bg = max(int(n_cells * density * 0.5), 4)
            bg_cols = rng.integers(0, n_cells, size=n_bg)
            bg_vals = rng.gamma(2.0, 0.4, size=n_bg).astype(np.float32)
            own = cells_of[g % n_clusters]
            n_hi = max(int(own.size * marker_frac), 1)
            hi_cols = rng.choice(own, size=min(n_hi, own.size),
                                 replace=False)
            hi_vals = (1.0 + rng.gamma(3.0, 0.8, size=hi_cols.size)
                       ).astype(np.float32)
            r = g - g0
            rows.append(np.full(bg_cols.size + hi_cols.size, r, np.int64))
            cols.append(np.concatenate([bg_cols, hi_cols]))
            vals.append(np.concatenate([bg_vals, hi_vals]))
        m = sp.coo_matrix(
            (np.concatenate(vals),
             (np.concatenate(rows), np.concatenate(cols))),
            shape=(g1 - g0, n_cells),
        ).tocsr()
        m.sum_duplicates()
        return m

    return gen


def consensus_input(n_cells: int, n_clusters: int, seed: int) -> np.ndarray:
    """The noisy consensus labeling handed to the refine (string labels,
    5 % flips off the planted truth)."""
    from scconsensus_tpu_torch.utils.synthetic import noisy_labeling

    return noisy_labeling(truth_labels(n_cells, n_clusters, seed),
                          0.05, seed=seed + 1)


def _labels_sha(dynamic_labels: Dict[str, np.ndarray]) -> str:
    h = hashlib.sha256()
    for key in sorted(dynamic_labels):
        h.update(key.encode())
        h.update(np.asarray(dynamic_labels[key], np.int64).tobytes())
    return h.hexdigest()


def run_stream_soak(
    workdir: str, n_cells: int = 4000, n_genes: int = 160,
    n_clusters: int = 4, seed: int = 7, window: Optional[int] = None,
    budget_mb: Optional[float] = None,
    stage_budget_mb: Optional[float] = None,
    fresh: bool = False, device=None,
) -> Dict[str, Any]:
    """One deterministic out-of-core run; returns the summary dict (see
    the module doc)."""
    from scconsensus_tpu_torch.config import ReclusterConfig, env_flag
    from scconsensus_tpu_torch.obs.export import (
        build_run_record,
        validate_run_record,
    )
    from scconsensus_tpu_torch.stream.budget import HostBudgetAccountant
    from scconsensus_tpu_torch.stream.runner import streaming_refine
    from scconsensus_tpu_torch.stream.store import ChunkedCSRStore

    chunks_dir = os.path.join(workdir, "chunks")
    stages_dir = os.path.join(workdir, "stages")
    if fresh:
        for d in (chunks_dir, stages_dir):
            shutil.rmtree(d, ignore_errors=True)
    win = int(window if window is not None else
              min(int(env_flag("SCC_STREAM_WINDOW")), 32))
    store = ChunkedCSRStore.create(chunks_dir, n_genes, n_cells, win)
    gen = chunk_generator(n_genes, n_cells, n_clusters, seed)
    labels = consensus_input(n_cells, n_clusters, seed)
    config = ReclusterConfig(
        method="wilcox", q_val_thrs=0.1, log_fc_thrs=0.25, min_pct=5.0,
        deep_split_values=(1, 2), min_cluster_size=10,
        n_top_de_genes=20, random_seed=seed,
    )
    acct = HostBudgetAccountant(budget_mb=budget_mb,
                                stage_budget_mb=stage_budget_mb)
    t0 = time.perf_counter()
    result = streaming_refine(
        store, labels, config, stage_dir=stages_dir, accountant=acct,
        regen=gen, device=device,
    )
    wall = time.perf_counter() - t0
    section = result.metrics["streaming"]
    rb = result.metrics.get("robustness")
    rec = build_run_record(
        metric=f"stream soak: {n_cells}-cell out-of-core refine",
        value=round(wall, 3), unit="seconds",
        extra={"config": "stream-soak",
               "platform": result.metrics["device"].split(":")[0],
               "n_cells": n_cells, "n_genes": n_genes},
        spans=result.metrics.get("spans") or [],
        streaming=section,
        robustness=rb,
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
    ok = bool(invalid is None and section.get("complete") and have_all_cuts)
    return {
        "ok": ok,
        "invalid": invalid,
        "wall_s": round(wall, 3),
        "labels_sha": _labels_sha(result.dynamic_labels),
        "chunks": section["chunks"],
        "halvings": section["window"]["halvings"],
        "window_final": section["window"]["final_rows"],
        "ckpt_final": section["ckpt"]["final_every"],
        "within_budget": section["budget"]["within_budget"],
        "peak_rss_mb": section["budget"]["peak_rss_mb"],
        "de_resumed": bool((rb or {}).get("resume_points")),
        "record": rec,
    }


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description="streaming soak worker")
    ap.add_argument("--dir", required=True, help="work directory")
    ap.add_argument("--cells", type=int, default=4000)
    ap.add_argument("--genes", type=int, default=160)
    ap.add_argument("--clusters", type=int, default=4)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--window", type=int, default=None)
    ap.add_argument("--budget-mb", type=float, default=None)
    ap.add_argument("--stage-budget-mb", type=float, default=None)
    ap.add_argument("--summary", default=None)
    ap.add_argument("--fresh", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    summary_path = args.summary or os.path.join(args.dir,
                                                "STREAM_SOAK_SUMMARY.json")
    os.makedirs(args.dir, exist_ok=True)
    summary = run_stream_soak(
        args.dir, n_cells=args.cells, n_genes=args.genes,
        n_clusters=args.clusters, seed=args.seed, window=args.window,
        budget_mb=args.budget_mb, stage_budget_mb=args.stage_budget_mb,
        fresh=args.fresh, device=args.device,
    )
    with open(summary_path, "w") as f:
        json.dump(summary, f, indent=1, default=str)
    print(json.dumps({
        "ok": summary["ok"],
        "chunks": summary["chunks"],
        "halvings": summary["halvings"],
        "within_budget": summary["within_budget"],
        "labels_sha": summary["labels_sha"][:16],
    }))
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
