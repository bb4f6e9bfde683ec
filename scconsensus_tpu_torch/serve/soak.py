"""Runnable serve-soak worker: the serving workload of a chaos run.

    python -m scconsensus_tpu_torch.serve.soak --dir DIR [--requests N]
        [--cells M] [--seed S] [--ood-requests K] [--summary PATH]
        [--fresh] [--expect-refusal] [--deadline S] [--window S]
        [--device cuda|cpu]

The port of ``scconsensus_tpu/serve/soak.py``. Builds (or loads) a
deterministic demo consensus model under ``DIR``, drives a replayable
request set through :class:`ConsensusServer` under whatever
``SCC_FAULT_PLAN`` is set, and writes one summary JSON: a run record
(``obs.export``) carrying the ``serving`` section, validated, a
per-request outcome list and a sha256 over the returned labels in
request order. The exit code is the chaos contract:

  0  every submitted request ended as exactly one typed outcome and the
     run record validates;
  1  the contract broke (a request vanished, validation failed);
  3  with ``--expect-refusal``: the model loaded when a typed refusal was
     expected.

The model build, the request set and classify are seeded and the model
is frozen, so two clean runs over the same ``DIR`` give identical label
hashes: the kill-and-restart check is ``sha(restart) == sha(reference)``.

The summary's keys are the reference's. ``--device`` (default ``cuda``)
picks where the model and the server run.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import threading
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = ["build_demo_model", "make_requests", "ood_cells", "run_soak",
           "main"]

# demo-model shape: small enough that a soak subprocess finishes in
# seconds, structured enough that labels are stable
_GENES = 120
_CLUSTERS = 4
_TRAIN_CELLS = 360
_LANDMARKS = 32


def _demo_training_set(seed: int):
    """Seeded well-separated gaussian clusters in gene space: (G, N)
    data and per-cell labels 1..K (0 is the unassigned convention)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0.0, 4.0, size=(_CLUSTERS, _GENES))
    per = _TRAIN_CELLS // _CLUSTERS
    cells = np.concatenate([
        centers[c] + rng.normal(0.0, 0.6, size=(per, _GENES))
        for c in range(_CLUSTERS)
    ])
    labels = np.repeat(np.arange(1, _CLUSTERS + 1), per)
    return np.asarray(cells.T, np.float32), labels, centers


def build_demo_model(model_dir: str, seed: int = 7,
                     landmark_seed: Optional[int] = None, device=None):
    """Deterministic demo model through the export path's pieces
    (``pca_basis`` → ``landmark_ward_linkage`` → the shared
    ``freeze_model_arrays`` → ArtifactStore save), without running DE:
    the soak exercises the serving layer. ``landmark_seed`` reseeds only
    the landmark fit (another fingerprint, the same request set)."""
    from scconsensus_tpu_torch.device import resolve_device
    from scconsensus_tpu_torch.ops.pca import pca_basis
    from scconsensus_tpu_torch.ops.pooling import landmark_ward_linkage
    from scconsensus_tpu_torch.serve.model import (
        MODEL_STAGE,
        _assemble,
        freeze_model_arrays,
    )
    from scconsensus_tpu_torch.utils.artifacts import ArtifactStore

    dev = resolve_device(device)
    data, labels, _ = _demo_training_set(seed)
    panel = np.arange(_GENES, dtype=np.int64)  # demo panel = all genes
    cells = np.asarray(data.T, np.float32)
    mean, comps = pca_basis(cells, 8, device=dev)
    mean = mean.cpu().numpy()
    comps = comps.cpu().numpy()
    emb = (cells - mean) @ comps.T
    tree, assign, cents, _info = landmark_ward_linkage(
        emb, n_landmarks=_LANDMARKS,
        seed=seed if landmark_seed is None else int(landmark_seed),
        device=dev,
    )
    arrays, meta = freeze_model_arrays(
        panel, mean, comps, emb, cents, assign, labels, tree,
        n_genes=_GENES, drift_margin=1.5,
        meta_extra={"deep_split": 2, "config_fp": "serve-soak-demo"},
    )
    ArtifactStore(model_dir).save(MODEL_STAGE, arrays, meta)
    return _assemble(arrays, meta, dev)


def ood_cells(rng: np.random.Generator, n_cells: int,
              n_genes: int) -> np.ndarray:
    """(n_cells, n_genes) out-of-distribution cells, drawn far outside
    any training expression (the drift-quarantine targets)."""
    return np.asarray(rng.normal(40.0, 1.0, size=(n_cells, n_genes)),
                      np.float32)


def make_requests(n_requests: int, cells_per: int, seed: int,
                  n_ood: int = 0) -> List[np.ndarray]:
    """Replayable request set: in-distribution cells drawn around the
    training centers; the last ``n_ood`` requests out of distribution."""
    rng = np.random.default_rng(seed + 1)
    _, _, centers = _demo_training_set(seed)
    out: List[np.ndarray] = []
    for i in range(n_requests):
        if i >= n_requests - n_ood:
            x = ood_cells(rng, cells_per, _GENES)
        else:
            c = centers[rng.integers(0, _CLUSTERS)]
            x = c + rng.normal(0.0, 0.6, size=(cells_per, _GENES))
        out.append(np.asarray(x, np.float32))
    return out


def run_soak(model_dir: str, n_requests: int = 24, cells_per: int = 16,
             seed: int = 7, n_ood: int = 0, fresh: bool = False,
             deadline_s: Optional[float] = None,
             window_s: Optional[float] = None,
             concurrency: int = 4, device=None) -> Dict[str, Any]:
    """Drive the request set through a server; returns the summary dict
    (see the module doc). ModelLoadError propagates: the caller decides
    whether a refusal was the expected outcome."""
    from scconsensus_tpu_torch.device import resolve_device
    from scconsensus_tpu_torch.obs.export import (
        build_run_record,
        validate_run_record,
    )
    from scconsensus_tpu_torch.serve.driver import (
        ConsensusServer,
        ServeConfig,
    )
    from scconsensus_tpu_torch.serve.errors import ServeError
    from scconsensus_tpu_torch.serve.model import (
        MODEL_STAGE,
        load_consensus_model,
    )
    from scconsensus_tpu_torch.utils.artifacts import ArtifactStore

    model_built = False
    if fresh or not ArtifactStore(model_dir).has(MODEL_STAGE):
        build_demo_model(model_dir, seed=seed, device=device)
        model_built = True
    model = load_consensus_model(model_dir, device=device)

    requests = make_requests(n_requests, cells_per, seed, n_ood=n_ood)
    cfg = ServeConfig(
        default_deadline_s=deadline_s,
        batch_window_s=window_s,
    )
    outcomes: List[Optional[Dict[str, Any]]] = [None] * len(requests)
    label_blobs: List[bytes] = [b""] * len(requests)

    server = ConsensusServer(model, cfg, device=device)
    with server:
        lock = threading.Lock()
        next_i = [0]

        def _pump():
            while True:
                with lock:
                    if next_i[0] >= len(requests):
                        return
                    i = next_i[0]
                    next_i[0] += 1
                try:
                    resp = server.classify(requests[i], timeout=60.0)
                    outcomes[i] = {
                        "i": i, "outcome": resp.outcome,
                        "degraded": resp.degraded,
                        "quarantined": resp.quarantined,
                    }
                    if resp.labels is not None:
                        label_blobs[i] = np.ascontiguousarray(
                            resp.labels
                        ).tobytes()
                except ServeError as e:
                    outcomes[i] = {
                        "i": i, "outcome": type(e).__name__,
                        "error": str(e)[:200],
                    }
                except TimeoutError as e:
                    outcomes[i] = {"i": i, "outcome": "TimeoutError",
                                   "error": str(e)[:200]}

        threads = [threading.Thread(target=_pump, daemon=True)
                   for _ in range(max(1, concurrency))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
        section = server.serving_section()
    rec = build_run_record(
        metric="serve soak p99 latency",
        value=(section.get("latency_ms") or {}).get("p99"),
        unit="ms",
        extra={"config": "serve-soak",
               "platform": resolve_device(device).type},
        serving=section,
    )
    validate_run_record(rec)

    resolved = [o for o in outcomes if o is not None]
    h = hashlib.sha256()
    for blob in label_blobs:
        h.update(blob)
    return {
        "ok": len(resolved) == len(requests),
        "requests": len(requests),
        "resolved": len(resolved),
        "model_built": model_built,
        "model_fp": model.fingerprint(),
        "labels_sha": h.hexdigest(),
        "outcome_counts": _tally(resolved),
        "outcomes": resolved,
        "record": rec,
    }


def _tally(outcomes: List[Dict[str, Any]]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for o in outcomes:
        out[o["outcome"]] = out.get(o["outcome"], 0) + 1
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="serve soak worker")
    ap.add_argument("--dir", required=True, help="model directory")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--cells", type=int, default=16)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--ood-requests", type=int, default=0,
                    help="trailing requests drawn out-of-distribution "
                         "(drift-quarantine targets)")
    ap.add_argument("--summary", default=None,
                    help="write the summary JSON here (default: "
                         "<dir>/SOAK_SUMMARY.json)")
    ap.add_argument("--fresh", action="store_true",
                    help="rebuild the demo model even if one exists")
    ap.add_argument("--expect-refusal", action="store_true",
                    help="expect a typed ModelLoadError (corrupt-model "
                         "plans); exit 0 on refusal, 3 on a load that "
                         "should not have succeeded")
    ap.add_argument("--deadline", type=float, default=None)
    ap.add_argument("--window", type=float, default=None)
    ap.add_argument("--device", default="cuda",
                    help="where the model and the server run (cuda or "
                         "cpu)")
    args = ap.parse_args(argv)

    from scconsensus_tpu_torch.serve.errors import ModelLoadError

    summary_path = args.summary or os.path.join(args.dir,
                                                "SOAK_SUMMARY.json")
    os.makedirs(args.dir, exist_ok=True)
    try:
        summary = run_soak(
            args.dir, n_requests=args.requests, cells_per=args.cells,
            seed=args.seed, n_ood=args.ood_requests, fresh=args.fresh,
            deadline_s=args.deadline, window_s=args.window,
            device=args.device,
        )
    except ModelLoadError as e:
        refusal = {
            "ok": args.expect_refusal,
            "refused": True,
            "quarantined": bool(getattr(e, "quarantined", False)),
            "error": str(e)[:300],
        }
        with open(summary_path, "w") as f:
            json.dump(refusal, f, indent=1)
        print(json.dumps({k: v for k, v in refusal.items()
                          if k != "error"}))
        return 0 if args.expect_refusal else 1
    if args.expect_refusal:
        print(json.dumps({"ok": False,
                          "error": "model loaded but a refusal was "
                                   "expected"}))
        return 3
    with open(summary_path, "w") as f:
        json.dump(summary, f, indent=1, default=str)
    print(json.dumps({
        "ok": summary["ok"],
        "requests": summary["requests"],
        "resolved": summary["resolved"],
        "outcome_counts": summary["outcome_counts"],
        "labels_sha": summary["labels_sha"][:16],
        "model_built": summary["model_built"],
    }))
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
