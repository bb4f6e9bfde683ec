"""The fleet-soak worker, and the atlas-to-query generator.

    python -m scconsensus_tpu_torch.serve.fleet.soak --dir DIR
        [--replicas N] [--requests N] [--cells M] [--seed S]
        [--swap-after K] [--kill-after K] [--heartbeat S]
        [--obs-overhead M] [--window S] [--concurrency P]
        [--ood-requests K] [--genes G] [--clusters C] [--train T]
        [--summary PATH] [--fresh] [--deadline S] [--device cuda|cpu]

The port of ``scconsensus_tpu/serve/fleet/soak.py``, with the reference's
arguments and summary keys plus ``--device`` (default ``cuda``). It builds
(or loads) a deterministic atlas model under ``DIR/model_v1`` (and, with
``--swap-after``, a same-distribution variant under ``DIR/model_v2``: the
same training data, reseeded landmarks, another fingerprint), drives a
replayable request set through the wire front over a
:class:`ReplicaPool`, optionally hot-swaps v1 to v2 mid-traffic, and
writes one summary JSON. The exit code is the chaos contract:

  0  every wire request ended as exactly one typed outcome, the serving
     section (wire and fleet accounting included) validates, and in swap
     mode every post-swap response was served by v2 only;
  1  the contract broke.

``--kill-after K`` hard-kills one replica (no drain) once K requests
resolved: its queued requests resolve typed ``rejected_closed`` and the
pumps retry them under the same trace id (``X-SCC-Trace-Id``), so the
summary shows both attempts under one trace. ``--heartbeat S`` arms an
``obs.live`` flight recorder over the soak, and the quarantine ledger
lands under ``DIR/ledger``. ``--obs-overhead M`` measures the telemetry
plane's own cost (tracing and scrapes on against off over M requests)
and stamps it on the record's ``slo`` section.

The atlas build, the request set and classify are all seeded, so the
labels of a request are a function of (model, request): the
``replay-across-replicas`` plan runs the same set through 1 and N
replicas, or on the card and the CPU, and pins ``sha(labels)`` equal.

:func:`build_atlas_model` and :func:`make_query_batches` are also the
``atlas_query`` bench configuration's generator.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = [
    "build_atlas_model",
    "make_query_batches",
    "run_fleet_soak",
    "main",
]


# --------------------------------------------------------------------------
# the atlas→query generator (bench + soak share it)
# --------------------------------------------------------------------------

def _gaussian_atlas(n_genes: int, n_clusters: int, n_train: int,
                    seed: int):
    """Seeded well-separated gaussian atlas: (N, G) training cells,
    per-cell labels 1..K, and the (K, G) centers queries draw from."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0.0, 4.0, size=(n_clusters, n_genes))
    per = max(n_train // n_clusters, 1)
    cells = np.concatenate([
        centers[c] + rng.normal(0.0, 0.6, size=(per, n_genes))
        for c in range(n_clusters)
    ]).astype(np.float32)
    labels = np.repeat(np.arange(1, n_clusters + 1), per)
    return cells, labels, centers


def build_atlas_model(model_dir: str, n_genes: int = 120,
                      n_clusters: int = 4, n_train: int = 360,
                      n_landmarks: Optional[int] = None, n_pcs: int = 8,
                      seed: int = 7,
                      landmark_seed: Optional[int] = None,
                      device=None):
    """Freeze a seeded gaussian atlas into a servable consensus model
    through the export pieces (``pca_basis`` and ``landmark_ward_linkage``
    on ``device``, then the shared ``freeze_model_arrays`` and an
    ArtifactStore save). ``landmark_seed`` reseeds only the landmark fit:
    the same distribution, another fingerprint (the hot-swap soak's v2)."""
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
    cells, labels, _ = _gaussian_atlas(n_genes, n_clusters, n_train, seed)
    panel = np.arange(n_genes, dtype=np.int64)
    mean, comps = pca_basis(cells, min(n_pcs, n_genes), device=dev)
    mean = mean.cpu().numpy()
    comps = comps.cpu().numpy()
    emb = (cells - mean) @ comps.T
    k = int(n_landmarks if n_landmarks
            else np.clip(round(2.0 * np.sqrt(cells.shape[0])), 16, 512))
    tree, assign, cents, _info = landmark_ward_linkage(
        emb, n_landmarks=min(k, cells.shape[0]),
        seed=seed if landmark_seed is None else int(landmark_seed),
        device=dev,
    )
    arrays, meta = freeze_model_arrays(
        panel, mean, comps, emb, cents, assign, labels, tree,
        n_genes=n_genes, drift_margin=1.5,
        meta_extra={"deep_split": 2, "config_fp": "fleet-atlas",
                    "atlas": {"n_clusters": int(n_clusters),
                              "n_train": int(cells.shape[0]),
                              "seed": int(seed)}},
    )
    ArtifactStore(model_dir).save(MODEL_STAGE, arrays, meta)
    return _assemble(arrays, meta, dev)


def make_query_batches(n_requests: int, cells_per: int, seed: int,
                       n_genes: int = 120, n_clusters: int = 4,
                       n_ood: int = 0) -> List[np.ndarray]:
    """Replayable query workload: batches drawn around the atlas centers
    (label transfer), the last ``n_ood`` drawn far outside (drift
    targets). Each batch also returns with a planted majority cluster so
    the bench can score transfer accuracy."""
    rng = np.random.default_rng(seed + 1)
    _, _, centers = _gaussian_atlas(n_genes, n_clusters, 4, seed)
    out: List[np.ndarray] = []
    for i in range(n_requests):
        if i >= n_requests - n_ood:
            x = rng.normal(40.0, 1.0, size=(cells_per, n_genes))
        else:
            c = centers[rng.integers(0, n_clusters)]
            x = c + rng.normal(0.0, 0.6, size=(cells_per, n_genes))
        out.append(np.asarray(x, np.float32))
    return out


# --------------------------------------------------------------------------
# the soak
# --------------------------------------------------------------------------

def _fast_cfg(deadline_s: Optional[float], ledger_dir: Optional[str],
              batch_window_s: float = 0.001):
    from scconsensus_tpu_torch.serve.driver import ServeConfig

    return ServeConfig(
        batch_window_s=batch_window_s,
        default_deadline_s=deadline_s,
        ledger_dir=ledger_dir,
    )


def _measure_overhead(port: int, batch: np.ndarray, m: int,
                      concurrency: int = 4) -> Dict[str, Any]:
    """The plane accounting for itself: mean per-request WALL over a
    concurrent burst of ``m`` identical requests with the telemetry
    plane ON (trace minting + one /metrics scrape per ~8 requests — the
    always-on cost profile) vs OFF (SCC_OBS_TRACE=0, no scrapes). A
    burst, not sequential pings: sequential latency phase-locks with
    the batch window (bimodal by ± one window), while burst throughput
    amortizes batching and isolates the plane's own cost. Returns the
    gauge dict the ``slo`` section carries."""
    import http.client

    body = json.dumps({"cells": batch.tolist()})

    def _pump_n(n: int, scrape: bool) -> None:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        for i in range(n):
            conn.request("POST", "/classify", body=body,
                         headers={"Content-Type": "application/json"})
            conn.getresponse().read()
            if scrape and i % 16 == 0:
                conn.request("GET", "/metrics")
                conn.getresponse().read()
        conn.close()

    def _run(scrape: bool) -> float:
        _pump_n(2, scrape=False)  # settle caches outside the clock
        per = max(m // concurrency, 1)
        threads = [threading.Thread(target=_pump_n,
                                    args=(per, scrape), daemon=True)
                   for _ in range(concurrency)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
        return (time.perf_counter() - t0) * 1e3 / (per * concurrency)

    prev = os.environ.get("SCC_OBS_TRACE")
    try:
        os.environ["SCC_OBS_TRACE"] = "0"
        off_ms = _run(scrape=False)
        os.environ["SCC_OBS_TRACE"] = "1"
        on_ms = _run(scrape=True)
    finally:
        if prev is None:
            os.environ.pop("SCC_OBS_TRACE", None)
        else:
            os.environ["SCC_OBS_TRACE"] = prev
    return {"on_ms": round(on_ms, 4), "off_ms": round(off_ms, 4),
            "ratio": round(on_ms / off_ms, 4) if off_ms else None,
            "n": int(m)}


def run_fleet_soak(workdir: str, n_requests: int = 24,
                   cells_per: int = 16, seed: int = 7,
                   replicas: Optional[int] = None,
                   swap_after: Optional[int] = None,
                   kill_after: Optional[int] = None,
                   n_ood: int = 0, n_genes: int = 120,
                   n_clusters: int = 4, n_train: int = 360,
                   fresh: bool = False, concurrency: int = 4,
                   deadline_s: Optional[float] = None,
                   heartbeat_s: Optional[float] = None,
                   obs_overhead_requests: int = 0,
                   batch_window_s: float = 0.001,
                   device=None) -> Dict[str, Any]:
    """Drive the request set through the wire front over a replica pool
    on ``device``; returns the summary dict (see module doc). With
    ``swap_after``, the fleet hot-swaps to the v2 model once that many
    requests have resolved, mid-traffic, while the pumps keep pumping.
    With ``kill_after``, one replica is hard-killed (and respawned) once
    that many requests have resolved; refused requests are retried with
    the same trace id."""
    import http.client

    from scconsensus_tpu_torch.device import resolve_device

    from scconsensus_tpu_torch.obs import trace as obs_trace
    from scconsensus_tpu_torch.obs.export import (
        build_run_record,
        validate_run_record,
    )
    from scconsensus_tpu_torch.obs.live import LiveRecorder
    from scconsensus_tpu_torch.serve import slo as serve_slo
    from scconsensus_tpu_torch.serve.fleet.pool import ReplicaPool
    from scconsensus_tpu_torch.serve.fleet.wire import TRACE_HEADER, WireFront
    from scconsensus_tpu_torch.serve.model import MODEL_STAGE
    from scconsensus_tpu_torch.utils.artifacts import ArtifactStore

    dev = resolve_device(device)
    v1_dir = os.path.join(workdir, "model_v1")
    v2_dir = os.path.join(workdir, "model_v2")
    built = False
    if fresh or not ArtifactStore(v1_dir).has(MODEL_STAGE):
        build_atlas_model(v1_dir, n_genes=n_genes, n_clusters=n_clusters,
                          n_train=n_train, seed=seed, device=dev)
        built = True
    if swap_after is not None and (
            fresh or not ArtifactStore(v2_dir).has(MODEL_STAGE)):
        build_atlas_model(v2_dir, n_genes=n_genes, n_clusters=n_clusters,
                          n_train=n_train, seed=seed,
                          landmark_seed=seed + 1000, device=dev)

    requests = make_query_batches(n_requests, cells_per, seed,
                                  n_genes=n_genes, n_clusters=n_clusters,
                                  n_ood=n_ood)
    outcomes: List[Optional[Dict[str, Any]]] = [None] * len(requests)
    attempts: List[Dict[str, Any]] = []
    label_blobs: List[bytes] = [b""] * len(requests)
    resolved = [0]
    swap_state: Dict[str, Any] = {"done": False, "to_fp": None}
    kill_state: Dict[str, Any] = {"done": False, "kills": []}
    lock = threading.Lock()
    next_i = [0]
    # swap mode reserves a TAIL of the request set until the cutover
    # lands: "hot-swap mid-traffic" must actually observe post-swap
    # traffic, not just in-flight survivors (the swap can outlast a small
    # request set on a fast box)
    swap_gate = (max(min(swap_after, len(requests)),
                     len(requests) - max(len(requests) // 3, 2))
                 if swap_after is not None else None)

    # flight recorder over the soak: the tracer catches each
    # replica's serve_request spans (trace ids included), the recorder
    # streams heartbeats whose serving panel carries the recent-trace
    # ring — the postmortem bundle's per-process inputs. Ledger rows
    # land under DIR/ledger, trace-keyed.
    tracer = obs_trace.Tracer(sync="off")
    recorder = LiveRecorder(
        os.path.join(workdir, "FLEET_SOAK"),
        metric="fleet soak flight record",
        extra={"config": "fleet-soak", "platform": dev.type},
        heartbeat_s=heartbeat_s,
    )
    recorder.start(install_signals=False)
    ledger_dir = os.path.join(workdir, "ledger")

    pool = ReplicaPool(v1_dir, n_replicas=replicas,
                       config=_fast_cfg(deadline_s, ledger_dir,
                                        batch_window_s=batch_window_s),
                       device=dev)
    fp1 = pool.active_fingerprint()
    front = WireFront(pool)
    obs_overhead: Optional[Dict[str, Any]] = None
    try:
      with pool, front:
        port = front.port

        def _pump():
            conn = http.client.HTTPConnection("127.0.0.1", port,
                                              timeout=60)
            while True:
                with lock:
                    if next_i[0] >= len(requests):
                        conn.close()
                        return
                    i = next_i[0]
                    if (swap_gate is not None and i >= swap_gate
                            and not swap_state["done"]):
                        i = None  # tail held back until the swap lands
                    else:
                        next_i[0] += 1
                if i is None:
                    time.sleep(0.002)
                    continue
                body = json.dumps({"cells": requests[i].tolist()})
                trace_id: Optional[str] = None
                attempt = 0
                while True:
                    attempt += 1
                    post_swap = bool(swap_state["done"])
                    headers = {"Content-Type": "application/json"}
                    if trace_id:
                        # the retry carries the SAME id: both attempts
                        # tell one story under one trace
                        headers[TRACE_HEADER] = trace_id
                    try:
                        conn.request("POST", "/classify", body=body,
                                     headers=headers)
                        r = conn.getresponse()
                        doc = json.loads(r.read())
                        tid = (doc.get("trace_id")
                               or r.getheader(TRACE_HEADER))
                        out = {
                            "i": i, "status": r.status,
                            "outcome": doc.get("outcome"),
                            "model_fp": doc.get("model_fp"),
                            "post_swap": post_swap,
                            "trace_id": tid,
                            "attempt": attempt,
                            "ts": round(time.time(), 3),
                        }
                        if doc.get("labels") is not None:
                            label_blobs[i] = np.asarray(
                                doc["labels"], np.int64
                            ).tobytes()
                    except (OSError, http.client.HTTPException,
                            json.JSONDecodeError) as e:
                        out = {"i": i, "status": None,
                               "outcome": "wire-error",
                               "error": str(e)[:200],
                               "post_swap": post_swap,
                               "trace_id": trace_id,
                               "attempt": attempt,
                               "ts": round(time.time(), 3)}
                        conn.close()
                        conn = http.client.HTTPConnection(
                            "127.0.0.1", port, timeout=60)
                    with lock:
                        attempts.append(out)
                    trace_id = out.get("trace_id") or trace_id
                    if (kill_after is not None and attempt < 5
                            and out["outcome"] in ("rejected_queue",
                                                   "rejected_closed")):
                        # a kill-refused request is resubmitted under
                        # its original trace id — the respawned replica
                        # serves attempt 2
                        time.sleep(0.05)
                        continue
                    outcomes[i] = out
                    break
                with lock:
                    resolved[0] += 1

        threads = [threading.Thread(target=_pump, daemon=True)
                   for _ in range(max(1, concurrency))]
        for t in threads:
            t.start()
        if swap_after is not None:
            # mid-traffic hot-swap: wait for the trigger count, cut over
            # while the pumps keep pumping
            while True:
                with lock:
                    if resolved[0] >= min(swap_after, len(requests)):
                        break
                time.sleep(0.002)
            to_fp = pool.hot_swap(v2_dir)
            swap_state["to_fp"] = to_fp
            swap_state["done"] = True
        if kill_after is not None:
            # hard-kill one replica mid-traffic (no drain: its queued
            # requests refuse typed and the pumps retry them). Up to 3
            # kills until one actually catches queued requests — each
            # kill respawns, so the fleet is back at width either way.
            gate = min(int(kill_after), len(requests) - 1)
            while True:
                with lock:
                    if resolved[0] >= gate:
                        break
                time.sleep(0.002)
            for _ in range(3):
                kill = pool.kill_replica()
                kill_state["kills"].append(kill)
                with lock:
                    remaining = len(requests) - resolved[0]
                if kill["refused"] or remaining <= 2:
                    break
                time.sleep(0.01)
            kill_state["done"] = True
        for t in threads:
            t.join(timeout=180.0)
        # sections FIRST: the record's p99/availability/burn describe
        # the soak under test, not the synthetic overhead burst (which
        # also toggles tracing off for half its requests)
        section = front.serving_section()
        slo_section = front.slo_section()
        if obs_overhead_requests > 0:
            obs_overhead = _measure_overhead(port, requests[0],
                                             obs_overhead_requests)
            serve_slo.set_obs_overhead(obs_overhead)
            slo_section["obs_overhead"] = dict(obs_overhead)
    except BaseException:
        # the postmortem's own input must not lie: a soak that died
        # mid-run leaves a crash-stamped partial, never a clean one
        recorder.stop("crash")
        serve_slo.set_obs_overhead(None)
        raise
    else:
        recorder.stop("clean")
        serve_slo.set_obs_overhead(None)

    rec = build_run_record(
        metric="fleet soak wire p99 latency",
        value=(section.get("latency_ms") or {}).get("p99"),
        unit="ms",
        extra={"config": "fleet-soak", "platform": dev.type},
        spans=tracer.live_span_records(),
        serving=section,
        slo=slo_section,
    )
    accounting_ok = True
    try:
        validate_run_record(rec)
    except ValueError as e:
        accounting_ok = False
        rec = {"invalid": str(e)}

    done = [o for o in outcomes if o is not None]
    fps_seen = sorted({o["model_fp"] for o in done if o.get("model_fp")})
    post = [o for o in done
            if o.get("post_swap") and o.get("model_fp")]
    post_swap_pure = all(o["model_fp"] == swap_state["to_fp"]
                         for o in post) if swap_state["done"] else None
    h = hashlib.sha256()
    for blob in label_blobs:
        h.update(blob)
    counts: Dict[str, int] = {}
    for o in done:
        counts[str(o["outcome"])] = counts.get(str(o["outcome"]), 0) + 1
    # trace evidence: every attempt carries a trace id; a
    # request that took >1 attempt must have kept ONE id across them —
    # the continuity contract the postmortem bundle proves end to end
    by_req: Dict[int, List[Dict[str, Any]]] = {}
    for a in attempts:
        by_req.setdefault(int(a["i"]), []).append(a)
    retried = {
        i: [{"attempt": a["attempt"], "outcome": a["outcome"],
             "status": a["status"], "trace_id": a["trace_id"],
             "ts": a["ts"]} for a in sorted(atts,
                                            key=lambda x: x["attempt"])]
        for i, atts in by_req.items() if len(atts) > 1
    }
    trace_continuity = all(
        len({a["trace_id"] for a in atts if a["trace_id"]}) == 1
        for atts in retried.values()
    ) if retried else None
    traced = [o for o in done if o.get("trace_id")]
    ok = (len(done) == len(requests)
          and accounting_ok
          and not any(o["outcome"] == "wire-error" for o in done)
          and (post_swap_pure is not False)
          and (trace_continuity is not False))
    if kill_after is not None:
        # the kill contract: the kill landed, the fleet respawned back
        # to width, and every request STILL ended served (retries
        # rescued the refused ones) — zero lost requests across a
        # replica death
        ok = (ok and kill_state["done"]
              and all(o["outcome"] in ("ok", "degraded", "quarantined")
                      for o in done))
    summary: Dict[str, Any] = {
        "ok": ok,
        "requests": len(requests),
        "resolved": len(done),
        "replicas": pool.n_default,
        "model_built": built,
        "fp_v1": fp1,
        "fp_v2": swap_state["to_fp"],
        "swapped": bool(swap_state["done"]),
        "post_swap_pure": post_swap_pure,
        "post_swap_responses": len(post),
        "fps_seen": fps_seen,
        "labels_sha": h.hexdigest(),
        "outcome_counts": counts,
        "accounting_ok": accounting_ok,
        "traced_responses": len(traced),
        "trace_continuity": trace_continuity,
        "retried": retried,
        "kills": list(kill_state["kills"]),
        "spans_done": len(tracer.spans),
        "outcomes": done,
        "attempts": attempts,
        "record": rec,
    }
    if obs_overhead is not None:
        summary["obs_overhead"] = obs_overhead
    if recorder.enabled:
        summary["heartbeat_stream"] = os.path.basename(recorder.hb_path)
        summary["partial_record"] = os.path.basename(
            recorder.partial_path)
    return summary


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="fleet soak worker")
    ap.add_argument("--dir", required=True, help="work directory")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--cells", type=int, default=16)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--replicas", type=int, default=None)
    ap.add_argument("--swap-after", type=int, default=None,
                    help="hot-swap to the v2 model once this many "
                         "requests resolved (mid-traffic)")
    ap.add_argument("--kill-after", type=int, default=None,
                    help="hard-kill (and respawn) one replica once this "
                         "many requests resolved; refused requests are "
                         "retried under their original trace id")
    ap.add_argument("--heartbeat", type=float, default=None,
                    help="flight-recorder heartbeat cadence in seconds "
                         "(default: SCC_OBS_HEARTBEAT; 0 disables)")
    ap.add_argument("--obs-overhead", type=int, default=0,
                    help="measure the telemetry plane's own cost over "
                         "this many extra requests (plane on vs off) "
                         "and stamp the gauge onto the slo section")
    ap.add_argument("--window", type=float, default=0.001,
                    help="replica batch window (s)")
    ap.add_argument("--concurrency", type=int, default=4,
                    help="client pump threads")
    ap.add_argument("--ood-requests", type=int, default=0)
    ap.add_argument("--genes", type=int, default=120)
    ap.add_argument("--clusters", type=int, default=4)
    ap.add_argument("--train", type=int, default=360)
    ap.add_argument("--summary", default=None)
    ap.add_argument("--fresh", action="store_true")
    ap.add_argument("--deadline", type=float, default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the device the replicas serve on")
    args = ap.parse_args(argv)

    summary_path = args.summary or os.path.join(args.dir,
                                                "FLEET_SOAK_SUMMARY.json")
    os.makedirs(args.dir, exist_ok=True)
    summary = run_fleet_soak(
        args.dir, n_requests=args.requests, cells_per=args.cells,
        seed=args.seed, replicas=args.replicas,
        swap_after=args.swap_after, kill_after=args.kill_after,
        n_ood=args.ood_requests,
        n_genes=args.genes, n_clusters=args.clusters, n_train=args.train,
        fresh=args.fresh, concurrency=args.concurrency,
        deadline_s=args.deadline,
        heartbeat_s=args.heartbeat,
        obs_overhead_requests=args.obs_overhead,
        batch_window_s=args.window,
        device=args.device,
    )
    with open(summary_path, "w") as f:
        json.dump(summary, f, indent=1, default=str)
    print(json.dumps({
        "ok": summary["ok"],
        "requests": summary["requests"],
        "resolved": summary["resolved"],
        "replicas": summary["replicas"],
        "swapped": summary["swapped"],
        "post_swap_pure": summary["post_swap_pure"],
        "kills": len(summary["kills"]),
        "retried": len(summary["retried"]),
        "trace_continuity": summary["trace_continuity"],
        "outcome_counts": summary["outcome_counts"],
        "labels_sha": summary["labels_sha"][:16],
    }))
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
