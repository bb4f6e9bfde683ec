"""Scenario runner: atlas→query label transfer through the serve path.

The port of ``scconsensus_tpu/workloads/atlas.py``.

Fit the consensus pipeline on the atlas split, freeze the result into a
consensus-model artifact through the REAL export path
(``serve.model.export_consensus_model`` — sha256'd ArtifactStore, the
same artifact a production server loads), then classify the query split
through :class:`~scconsensus_tpu_torch.serve.driver.ConsensusServer`
as a BATCH workload. The headline is query cells/sec through the serve
driver; the record carries the driver's validated ``serving`` section,
so serve p99/throughput are measured on a shape that is not the 26k
anchor's.

Unlike the serve soak's gaussian demo model, the frozen model here
comes out of an actual refine run (DE panel, PCA basis, landmark tree
all fitted), so the transfer ARI measures the whole pipeline's
portability, not a toy classifier's.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = ["run"]

# batched-classify concurrency: enough to keep the micro-batching
# driver's window busy without racing past its bounded queue
_PUMP_THREADS = 4


def run(params: Dict[str, Any], smoke: bool = False,
        workdir: Optional[str] = None, device=None):
    from scconsensus_tpu_torch.config import ReclusterConfig
    from scconsensus_tpu_torch.device import resolve_device
    from scconsensus_tpu_torch.models.pipeline import refine
    from scconsensus_tpu_torch.obs.regress import adjusted_rand_index
    from scconsensus_tpu_torch.serve.driver import ConsensusServer, ServeConfig
    from scconsensus_tpu_torch.serve.errors import ServeError
    from scconsensus_tpu_torch.serve.model import export_consensus_model
    from scconsensus_tpu_torch.utils.synthetic import noisy_labeling
    from scconsensus_tpu_torch.workloads.common import (
        consensus_of,
        outcome_from_result,
    )
    from scconsensus_tpu_torch.workloads.data import atlas_query_dataset

    dev = resolve_device(device)
    seed = int(params.get("seed", 7))
    n_clusters = int(params["n_clusters"])
    cells_per = int(params["cells_per"])
    atlas, atlas_labels, query, query_truth = atlas_query_dataset(
        n_atlas=int(params["n_atlas"]),
        n_query=int(params["n_query"]),
        n_genes=int(params["n_genes"]),
        n_clusters=n_clusters,
        seed=seed,
    )
    data = np.ascontiguousarray(atlas.T, np.float32)      # (G, n_atlas)
    sup = noisy_labeling(atlas_labels, 0.05, seed=seed + 1, prefix="sup")
    uns = noisy_labeling(atlas_labels, 0.10,
                         n_out_clusters=max(2, n_clusters - 2),
                         seed=seed + 2, prefix="uns")
    consensus = consensus_of(sup, uns)
    config = ReclusterConfig(
        method="wilcox", q_val_thrs=0.1, log_fc_thrs=0.25, min_pct=5.0,
        deep_split_values=(1, 2) if smoke else (1, 2, 3),
        min_cluster_size=10, n_top_de_genes=20, random_seed=seed,
    )
    t0 = time.perf_counter()
    result = refine(data, consensus, config, device=dev)
    fit_s = time.perf_counter() - t0

    own_tmp = workdir is None
    root = workdir or tempfile.mkdtemp(prefix="scc-atlas-transfer-")
    try:
        model_dir = os.path.join(root, "model")
        model = export_consensus_model(
            data, result, config, model_dir,
            # the query split carries a small planted drift by design;
            # a generous margin keeps transfer a classification problem,
            # with drift fractions still measured per batch
            drift_margin=3.0, seed=seed, device=dev,
        )

        batches: List[np.ndarray] = [
            np.ascontiguousarray(query[i:i + cells_per], np.float32)
            for i in range(0, query.shape[0], cells_per)
        ]
        served: List[Optional[np.ndarray]] = [None] * len(batches)
        outcomes: List[str] = ["unresolved"] * len(batches)
        server = ConsensusServer(model_dir, ServeConfig(),
                                 register_live=False, device=dev)
        with server:
            lock = threading.Lock()
            next_i = [0]

            def _pump():
                while True:
                    with lock:
                        if next_i[0] >= len(batches):
                            return
                        i = next_i[0]
                        next_i[0] += 1
                    try:
                        resp = server.classify(batches[i], timeout=120.0)
                        outcomes[i] = resp.outcome
                        if resp.labels is not None:
                            served[i] = np.asarray(resp.labels)
                    except ServeError as e:
                        outcomes[i] = type(e).__name__
                    except TimeoutError:
                        outcomes[i] = "TimeoutError"

            t0 = time.perf_counter()
            threads = [threading.Thread(target=_pump, daemon=True)
                       for _ in range(_PUMP_THREADS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600.0)
            if any(t.is_alive() for t in threads):
                # a live pump thread would keep mutating served/outcomes
                # under the scoring below and outlive the model-dir
                # teardown — fail loudly rather than record a race
                raise RuntimeError(
                    "atlas_transfer query pump did not drain within "
                    "its timeout"
                )
            pump_s = time.perf_counter() - t0
            serving = server.serving_section()
    finally:
        if own_tmp:
            import shutil

            shutil.rmtree(root, ignore_errors=True)

    answered = [i for i, s in enumerate(served) if s is not None]
    n_answered = int(sum(served[i].shape[0] for i in answered))
    truth_parts = [
        query_truth[i * cells_per:i * cells_per + served[i].shape[0]]
        for i in answered
    ]
    transfer_ari = round(adjusted_rand_index(
        np.concatenate([served[i] for i in answered]),
        np.concatenate(truth_parts),
    ), 6) if answered else 0.0
    throughput = round(n_answered / pump_s, 1) if pump_s > 0 else 0.0
    lat = serving.get("latency_ms") or {}
    scores = {
        "metrics": {
            "transfer_ari": transfer_ari,
            "query_cells_per_s": float(throughput),
            "answered_frac": round(n_answered / max(query.shape[0], 1),
                                   6),
            "fit_s": round(fit_s, 3),
        },
    }
    if lat.get("p99") is not None:
        scores["metrics"]["serve_p99_ms"] = float(lat["p99"])
    counts: Dict[str, int] = {}
    for o in outcomes:
        counts[o] = counts.get(o, 0) + 1
    return outcome_from_result(
        "atlas_transfer", params, smoke, pump_s, result, scores,
        metric=(f"atlas→query transfer: {len(batches)} batches × "
                f"{cells_per} cells through the serve driver"),
        value=float(throughput), unit="cells/sec",
        extra={"fit_s": round(fit_s, 3),
               "model_fp": model.fingerprint(),
               "outcome_counts": counts,
               "serve_p99_ms": lat.get("p99")},
        serving=serving,
    )
