"""Pipeline configuration and the ``SCC_*`` environment flags.

A mirror of ``scconsensus_tpu/config.py:503-669``: every field of
``CompatFlags`` and ``ReclusterConfig`` with the reference's default,
``landmark_policy`` (config field, then the ``SCC_TREE_*`` flag, then the
registered default, the reference's order) and ``to_json``.

``ENV_FLAGS`` registers every flag the port reads, with the reference's
names, types, defaults and text (``scconsensus_tpu/config.py:32-267,
486``): the tracer's sync policy and ``SCC_TRACE_DIR``, the kernel
capture ``SCC_OBS_KERNELS`` (over ``torch.profiler`` here), the four
``SCC_TREE_*`` landmark flags, the ``SCC_SERVE_*`` knobs, the fault plan,
the retry budget and backoff, ``SCC_ROBUST_CHECKSUM``, ``SCC_ELASTIC`` and
``SCC_ELASTIC_MIN_DEVICES``, ``SCC_INTEGRITY``, request tracing, the SLO
objectives, the four ``SCC_STREAM_*`` flags and the observation flags
of ``refine()`` (the residency auditor, the transfer watch, the cost
model, the flight recorder and its stall watchdog, the host profiler,
the evidence ledger's directory and the Wilcoxon probe), and the compile
log's and the graph passports' four flags (``SCC_COMPILELOG``,
``SCC_COMPILELOG_MAX_EVENTS``, ``SCC_GRAPHS``,
``SCC_GRAPHS_MAX_PROGRAMS``), and the serving fleet's sixteen
(``SCC_FLEET_*``, ``SCC_LOADGEN_*``, ``SCC_AUTOSCALE_*``). A reference flag the port does not handle
would go in ``UNPORTED_FLAGS``, which :func:`refuse_unported_flags`
refuses when set so that none is dropped silently; it is empty now.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, Dict, Mapping, Optional, Tuple

__all__ = ["CompatFlags", "ReclusterConfig", "EnvFlag", "ENV_FLAGS",
           "UNPORTED_FLAGS", "env_flag", "refuse_unported_flags"]


@dataclasses.dataclass
class CompatFlags:
    """Reference-quirk switches (SURVEY.md §2d). ``True`` reproduces the
    reference's literal arithmetic; ``False`` applies the documented fix."""

    # §2d-1: the reference edgeR path drops fold-changes; fixed mode uses
    # edgeR's logFC converted from log2 to natural log.
    edger_drop_logfc: bool = False
    # §2d-3: slow path compares mean-of-logs against log(count threshold).
    mean_gate_mixed_spaces: bool = True
    # §2d-4: BH with n = total gene count (slow) vs surviving features (fast).
    bh_reference_n: bool = True
    # §2d-6: return the per-deepSplit silhouette (reference computes & drops).
    return_silhouette: bool = True
    # The reference hands the log-normalized matrix to DGEList as counts.
    edger_log_counts: bool = True


@dataclasses.dataclass
class ReclusterConfig:
    """Configuration of the DE → embed → recluster refinement pipeline.

    Field provenance (reference defaults): slow path
    R/reclusterDEConsensus.R:20-29, fast path
    R/reclusterDEConsensusFast.R:22-33."""

    # --- DE testing ---
    method: str = "wilcox"  # wilcox | edger | bimod | roc | t
    q_val_thrs: float = 0.1
    log_fc_thrs: float = 0.5  # natural-log fold-change threshold
    mean_scaling_factor: float = 5.0  # slow-path mean-expression gate scale
    mean_exprs_thrs: float = 0.0  # fast-path gate (Seurat MeanExprsThrs)
    min_pct: float = 20.0  # fast path: min % of cells expressing
    min_diff_pct: float = -float("inf")
    min_cells_group: int = 3  # pairs with a smaller group are skipped
    pseudocount: float = 1.0
    max_cells_per_ident: Optional[int] = None  # subsample per group (seeded)
    random_seed: int = 1
    only_pos: bool = False
    n_top_de_genes: int = 30

    # --- cluster filtering ---
    min_cluster_size: int = 10  # strictly-greater filter (§2d-7)
    drop_grey: bool = True  # 'grey' = unclustered

    # --- embed + recluster ---
    n_pcs: int = 15
    distance: str = "euclidean"  # euclidean | pearson
    deep_split_values: Tuple[int, ...] = (1, 2, 3, 4)
    pam_stage: bool = False

    # --- scale-out ---
    approx_threshold: int = 100_000
    approx_method: str = "pool"  # pool | knn
    n_pool_centroids: int = 4096
    knn_graph_k: int = 15
    landmark_threshold: Optional[int] = None
    landmark_k: Optional[int] = None
    landmark_c: Optional[float] = None
    landmark_k_min: int = 512
    landmark_k_max: int = 4096
    landmark_sketch: Optional[int] = None
    landmark_linkage: str = "exact"  # exact | knn
    landmark_verify: bool = False
    silhouette_pool_centroids: int = 2048
    silhouette_sample: Optional[int] = None

    # --- misc ---
    compat: CompatFlags = dataclasses.field(default_factory=CompatFlags)
    artifact_dir: Optional[str] = None
    plot_name: Optional[str] = None

    @classmethod
    def slow_path_preset(cls, q_val_thrs: float, fc_thrs: float,
                         **kw) -> "ReclusterConfig":
        """Reference slow-path defaults: fcThrs given as a ratio
        (natural-log threshold = log(fcThrs)), min_pct 0."""
        return cls(
            method=kw.pop("method", "wilcox"),
            q_val_thrs=q_val_thrs,
            log_fc_thrs=math.log(fc_thrs),
            min_pct=kw.pop("min_pct", 0.0),
            **kw,
        )

    def landmark_policy(self, n_cells: int) -> Optional[Dict[str, Any]]:
        """Resolved landmark-path decision for a run over ``n_cells``
        (``scconsensus_tpu/config.py:625-662``).

        None when the landmark engine must not run (at or below the
        threshold, or ``SCC_TREE_EXACT`` forces the exact behavior);
        otherwise ``{threshold, k (None = the policy at fit time), c,
        k_min, k_max, sketch, linkage, knn_k}``. Config fields win over the
        ``SCC_TREE_*`` flags, the flags fill unset fields, and the
        registered defaults the rest (threshold 200,000, c = 2.0).
        """
        if env_flag("SCC_TREE_EXACT"):
            return None
        thr = self.landmark_threshold
        if thr is None:
            thr = env_flag("SCC_TREE_LANDMARK_THRESHOLD")
        thr = int(thr)
        if n_cells <= thr:
            return None
        k = self.landmark_k
        if k is None:
            k = env_flag("SCC_TREE_LANDMARK_K")
        c = self.landmark_c
        if c is None:
            c = env_flag("SCC_TREE_LANDMARK_C")
        if c is None:
            c = 2.0
        return {
            "threshold": thr,
            "k": int(k) if k else None,
            "c": float(c),
            "k_min": int(self.landmark_k_min),
            "k_max": int(self.landmark_k_max),
            "sketch": (int(self.landmark_sketch)
                       if self.landmark_sketch else None),
            "linkage": str(self.landmark_linkage),
            "knn_k": int(self.knn_graph_k),
        }

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["min_diff_pct"] = (
            None if self.min_diff_pct == -float("inf") else self.min_diff_pct
        )
        return json.dumps(d, indent=2, default=str)


@dataclasses.dataclass(frozen=True)
class EnvFlag:
    name: str
    type: type
    default: Any
    doc: str


_FALSY = ("", "0", "false", "off", "no", "none")

ENV_FLAGS: Dict[str, EnvFlag] = {
    f.name: f
    for f in [
        # --- tracing (obs/trace.py) ---
        EnvFlag("SCC_TRACE_SYNC", str, "stage",
                "Tracer device-sync policy: 'stage' (synchronize the card "
                "at stage-span boundaries; default), 'all' (every span) or "
                "'off' (host dispatch intervals)."),
        EnvFlag("SCC_STAGE_SYNC", bool, False,
                "Force at least stage-boundary synchronization even when "
                "SCC_TRACE_SYNC=off."),
        EnvFlag("SCC_TRACE_DIR", str, None,
                "If set, refine() exports <dir>/run_record.json + "
                "<dir>/trace.json (Chrome trace events; open in Perfetto) "
                "at the end of every pipeline run."),
        EnvFlag("SCC_OBS_KERNELS", str, None,
                "Directory for a torch.profiler capture window around the "
                "pipeline (obs.kernels): CUDA kernel events are parsed "
                "from the exported trace, joined through their launches "
                "to tracer spans, and summarized as the run record's "
                "kernels section (top-K kernels by device time). Unset = "
                "off."),
        # --- observation flags of refine() (obs.residency, obs.device,
        # obs.cost, obs.live, obs.hostprof, obs.ledger, the Wilcoxon probe) ---
        EnvFlag("SCC_OBS_TRANSFERS", bool, False,
                "Wrap refine() in obs.device.TransferWatch: count explicit "
                "host<->device transfer bytes and flag oversized host "
                "fetches on the run record."),
        EnvFlag("SCC_OBS_COST", bool, False,
                "Attach XLA cost_analysis (FLOPs/bytes) to jitted kernel "
                "spans at trace time (obs.cost); one memoized AOT compile "
                "per kernel shape. bench.py workers enable it."),
        EnvFlag("SCC_OBS_HEARTBEAT", float, 0.0,
                "Live flight recorder (obs.live): heartbeat tick interval "
                "in seconds (0 = off). Each tick appends one JSONL line "
                "(open-span stack, RSS/HBM, compile stats) to the run's "
                "*_heartbeat.jsonl stream. bench.py workers default it on."),
        EnvFlag("SCC_OBS_STALL_S", float, 0.0,
                "In-process stall watchdog window (seconds; 0 = off): with "
                "no span transition / compile progress for this long, the "
                "recorder dumps all-thread stacks into the heartbeat "
                "stream, bumps the stall counter, and (with "
                "SCC_OBS_STALL_TRACE set) opens a profiler capture."),
        EnvFlag("SCC_OBS_STALL_TRACE", str, None,
                "Directory for on-demand jax.profiler capture windows "
                "(stall escalation and SIGUSR1 both write here; unset = "
                "no capture, stack dumps only)."),
        EnvFlag("SCC_EVIDENCE_DIR", str, None,
                "Evidence-ledger directory override (default <cwd>/evidence"
                "; bench.py anchors it next to itself). The test suite "
                "points it at a tmp dir."),
        EnvFlag("SCC_OBS_RESIDENCY", str, "off",
                "Host<->device residency auditor (obs.residency): 'off' "
                "(default), 'audit' (record every transfer with direction, "
                "bytes, owning span and source site onto the run record's "
                "residency section), 'enforce' (any crossing outside the "
                "declared boundary allowlist raises with the offending "
                "span named; jax.transfer_guard backs the patched entry "
                "points). bench.py workers default it to 'audit'."),
        EnvFlag("SCC_HOSTPROF", bool, False,
                "Host execution profiler (obs.hostprof): a sampling "
                "stack profiler on the run thread (folded stacks "
                "bucketed per stage span, classified into python / "
                "blocking_wait / compile / serialization causes) plus "
                "gc.callbacks pause accounting and an RSS/HBM memory "
                "timeline — landed as the run record's host_profile and "
                "memory_timeline sections. bench.py workers default it "
                "on."),
        EnvFlag("SCC_HOSTPROF_HZ", float, 50.0,
                "Sampling rate (Hz) of the SCC_HOSTPROF stack/memory "
                "sampler. 50 Hz = one _current_frames walk + one statm "
                "pread every 20 ms; overhead is pinned under the perf "
                "gate's 50 ms noise floor by test."),
        EnvFlag("SCC_WILCOX_PROBE", bool, False,
                "Synced per-bucket occupancy DIAGNOSIS of the Wilcoxon "
                "window ladder (serializes dispatch; tied-run counts and a "
                "sort-only timing are fetched per bucket)."),
        # --- the compile log and graph passports (obs.compilelog,
        # obs.graphs); armed by the caller, as the reference's bench arms
        # them ---
        EnvFlag("SCC_COMPILELOG", bool, False,
                "Per-stage JAX compile/retrace telemetry "
                "(obs.compilelog): jax.monitoring compile events stamped "
                "with the ambient stage span and its entry ordinal, "
                "aggregated (compiles, retraces, cache hits, compile "
                "wall) into the run record's compile section. bench.py "
                "workers default it on."),
        EnvFlag("SCC_COMPILELOG_MAX_EVENTS", int, 65536,
                "Cap on buffered compile/cache events per process "
                "(obs.device): past the cap new events are dropped "
                "rather than grow the buffer unboundedly in a "
                "pathological retrace storm."),
        EnvFlag("SCC_GRAPHS", bool, False,
                "Compiled-program observatory (obs.graphs): capture a "
                "graph passport (op census, transfer ops, host "
                "callbacks, donation hits/misses, fusion count, "
                "XLA-estimated buffer bytes) for every instrumented "
                "jitted stage program on its first call per abstract "
                "signature, landed as the run record's graphs section. "
                "bench.py workers default it on; serve never arms it "
                "(capture lowers+compiles an AOT copy of each "
                "program)."),
        EnvFlag("SCC_GRAPHS_MAX_PROGRAMS", int, 256,
                "Cap on captured graph passports per process "
                "(obs.graphs): past the cap further programs are "
                "dropped with a section error note rather than grow "
                "capture cost unboundedly under a retrace storm."),
        # --- tree stage (the landmark recluster) ---
        EnvFlag("SCC_TREE_LANDMARK_THRESHOLD", int, 200_000,
                "Cell count above which the pooled tree stage switches "
                "from the full-data Lloyd to the landmark recluster path "
                "(sketch-fitted k-means, Ward on k ≪ N landmarks, device "
                "nearest-landmark cut propagation). Runs at or below the "
                "threshold keep the pre-r7 byte-identical behavior. "
                "ReclusterConfig.landmark_threshold overrides when set."),
        EnvFlag("SCC_TREE_LANDMARK_K", int, None,
                "Explicit landmark count for the landmark tree path "
                "(unset = the N-scaled policy clamp(c·√N, k_min, k_max); "
                "see SCC_TREE_LANDMARK_C and the BASELINE.md landmark "
                "policy section)."),
        EnvFlag("SCC_TREE_LANDMARK_C", float, None,
                "Landmark k-policy scale factor c in "
                "k = clamp(c·√N, k_min, k_max) when "
                "ReclusterConfig.landmark_c is unset (config wins; "
                "both unset = 2.0)."),
        EnvFlag("SCC_TREE_EXACT", bool, False,
                "Exact-fallback override: disable the landmark tree path "
                "at any N and run the pre-r7 behavior (full-data pooled "
                "Lloyd above approx_threshold, exact Ward below) — the "
                "escape hatch if a landmark cut looks wrong."),
        # --- robustness (robust/) ---
        EnvFlag("SCC_FAULT_PLAN", str, None,
                "Path to a JSON fault-injection plan (robust.faults): "
                "deterministic injection of named fault classes at the "
                "serving sites and artifact writes. Unset = no injection."),
        EnvFlag("SCC_ROBUST_BUDGET", int, 16,
                "Per-run retry budget shared by every robust.retry call "
                "site; once spent, further failures re-raise."),
        EnvFlag("SCC_ROBUST_BACKOFF_S", float, 0.05,
                "Base backoff of robust.retry's exponential ladder (attempt "
                "n sleeps base*2^(n-1), capped, +0-50% deterministic "
                "jitter)."),
        EnvFlag("SCC_ROBUST_CHECKSUM", bool, True,
                "Content checksums on ArtifactStore artifacts: every "
                "save stamps a sha256 into the stage sidecar and every "
                "load verifies it — corrupt/truncated entries are "
                "QUARANTINED (renamed *.quarantined) and recomputed "
                "instead of crashing or silently loading garbage. Set 0 "
                "to skip verification (trusted store, max throughput)."),
        EnvFlag("SCC_ROBUST_DE_CKPT", bool, True,
                "Mid-stage wilcox checkpointing: with an artifact store "
                "active, each completed window-ladder bucket persists "
                "its (log_p, u, ties) block so a kill mid-stage resumes "
                "from completed buckets instead of recomputing the whole "
                "DE stage. Set 0 to disable (store-less runs are always "
                "unaffected)."),
        # --- elastic mesh (robust/elastic.py) ---
        EnvFlag("SCC_ELASTIC", bool, True,
                "Elastic mesh execution (robust.elastic): the pipeline's "
                "sharded paths run under a mesh supervisor that "
                "classifies device-loss failures, rebuilds the mesh on "
                "surviving devices (8 → 4 → 2 → 1 shrink ladder on an "
                "indistinct loss), re-enters the stage from its last "
                "completed checkpoint, and stamps every transition into "
                "the validated robustness section. Set 0 for the "
                "pre-elastic behavior (a lost device kills the run)."),
        EnvFlag("SCC_ELASTIC_MIN_DEVICES", int, 1,
                "Floor of the elastic shrink ladder: a device loss that "
                "would leave fewer devices than this is FATAL instead of "
                "recovered (for workloads whose sharded working set "
                "genuinely needs a minimum aggregate HBM footprint)."),
        # --- integrity (robust/integrity.py) ---
        EnvFlag("SCC_INTEGRITY", str, "off",
                "Computation-integrity sentinels (robust.integrity): "
                "'off' (default), 'audit' (algebraic invariant checks at "
                "stage boundaries and a seeded ghost-replay sample "
                "recomputed through the float64 host oracle, recorded on "
                "the validated integrity section) or 'enforce' (a "
                "violation or replay mismatch raises typed "
                "silent_corruption and the unit recomputes)."),
        EnvFlag("SCC_INTEGRITY_TOL_SCALE", float, 1.0,
                "Scale factor on every integrity tolerance band "
                "(robust.integrity.TOLERANCES). Tests shrink it to force "
                "detections."),
        EnvFlag("SCC_INTEGRITY_EVICT_THRESHOLD", int, 2,
                "Consecutive silent-corruption detections at one site "
                "before the retry policy escalates to its device-loss "
                "hook (a device that computes wrong is treated like one "
                "that died)."),
        # --- quality telemetry (obs/quality.py) ---
        EnvFlag("SCC_OBS_NUMERIC", bool, False,
                "Numeric-health sentinels (obs.quality): NaN/Inf guards "
                "at stage boundaries in the pipeline, the DE engine and "
                "the NB driver. A trip records the stage, the array and "
                "the counts on the quality section's numeric_health."),
        # --- out-of-core streaming (stream/) ---
        EnvFlag("SCC_STREAM_HOST_BUDGET_MB", int, 4096,
                "Hard host-memory budget (MB) for out-of-core streaming "
                "runs (stream.budget): peak process RSS past it raises "
                "typed HostBudgetExceeded, recovered by halving the "
                "streaming gene window (floor 1 row, then typed "
                "failure). The run record's streaming section carries "
                "peak RSS vs this budget as the bounded-memory "
                "evidence — a record claiming within_budget without it "
                "is rejected."),
        EnvFlag("SCC_STREAM_STAGE_BUDGET_MB", int, 256,
                "Staged-bytes budget (MB) for the streaming layer's own "
                "host buffers (loaded CSR chunks, dense gene-window "
                "staging, the (N, n_pcs) score accumulator): a charge "
                "past it raises typed HostBudgetExceeded before the "
                "allocation, recovered by the same window-halving "
                "ladder. Tighter than the RSS budget by design — it "
                "bounds what the streaming layer ADDS to a process."),
        EnvFlag("SCC_STREAM_WINDOW", int, 64,
                "Row (gene) window of on-disk ChunkedCSRStore blocks "
                "written by stream ingestion — the durability/resume "
                "granule: a SIGKILL mid-ingest resumes from the last "
                "fully fsynced chunk. Smaller windows = finer resume, "
                "more files."),
        EnvFlag("SCC_STREAM_DIR", str, None,
                "Directory for the brain10m bench's chunked CSR store "
                "(unset = a per-run temp dir). Point it at persistent "
                "scratch to reuse the ingested chunks across bench "
                "runs — the steady-state measurement then prices the "
                "streaming refine, not the synthetic ingest."),
        # --- serving (serve/) ---
        EnvFlag("SCC_SERVE_MAX_BATCH", int, 512,
                "Serving micro-batch cell cap: the worker coalesces queued "
                "requests up to this many cells; a larger single request "
                "is rejected typed at admission."),
        EnvFlag("SCC_SERVE_QUEUE_CAP", int, 256,
                "Bounded admission queue capacity in requests: a submit at "
                "capacity raises typed QueueFull with retry_after_s."),
        EnvFlag("SCC_SERVE_BATCH_WINDOW_S", float, 0.002,
                "Micro-batch linger window after the first request of a "
                "batch."),
        EnvFlag("SCC_SERVE_DEADLINE_S", float, 30.0,
                "Default per-request deadline; an overrun resolves as "
                "typed DeadlineExceeded."),
        EnvFlag("SCC_SERVE_BREAKER_THRESHOLD", int, 3,
                "Consecutive device-class failures that open the circuit "
                "breaker and route batches to the flagged host path."),
        EnvFlag("SCC_SERVE_BREAKER_COOLDOWN_S", float, 5.0,
                "Seconds an open breaker waits before a half-open probe "
                "of the device path."),
        EnvFlag("SCC_SERVE_DRIFT_FRAC", float, 0.5,
                "Drift-quarantine gate: a request with at least this "
                "fraction of cells past the model's foreign-cell distance "
                "gets no labels and a ledger row. Values > 1 disable it."),
        EnvFlag("SCC_SERVE_DRIFT_MARGIN", float, 1.5,
                "Export-time drift margin: the foreign-cell threshold is "
                "the training q99 nearest-landmark distance times this."),
        EnvFlag("SCC_SERVE_LEDGER_DIR", str, None,
                "Writable directory for the quarantine ledger and the "
                "quarantined cells; wins over the model-dir default."),
        EnvFlag("SCC_SERVE_LEDGER_MAX_CELLS", int, 100_000,
                "Cap on quarantined cells written beside the ledger per "
                "server lifetime (ledger lines keep appending)."),
        # --- telemetry (serve/slo.py) ---
        EnvFlag("SCC_OBS_TRACE", bool, True,
                "Request tracing: mint a trace id at admission and carry "
                "it through the serve_request span, the ledger row and "
                "the recent-request ring."),
        EnvFlag("SCC_SLO_AVAIL_TARGET", float, 0.999,
                "Availability SLO target (good share of non-client-fault "
                "outcomes)."),
        EnvFlag("SCC_SLO_P99_MS", float, 250.0,
                "Tail-latency SLO target (ms)."),
        EnvFlag("SCC_SLO_WINDOWS_S", str, "300,3600",
                "Comma-separated trailing windows (s) of the SLO burn "
                "rates."),
        EnvFlag("SCC_SLO_BURN_LIMIT", float, 14.4,
                "Burn-rate threshold stamped on the slo section's "
                "objectives."),
        # --- serving fleet (serve/fleet/) ---
        EnvFlag("SCC_FLEET_REPLICAS", int, 2,
                "Default replica count for serve.fleet.ReplicaPool: N "
                "ConsensusServer workers behind one shared admission "
                "layer with least-depth routing and per-replica circuit "
                "breakers."),
        EnvFlag("SCC_FLEET_WIRE_PORT", int, 0,
                "TCP port for the serve.fleet.wire HTTP front "
                "(0 = ephemeral; the bound port is WireFront.port)."),
        EnvFlag("SCC_FLEET_SWAP_DRAIN_S", float, 30.0,
                "Hot-swap drain budget: after the atomic cutover to the "
                "new model's replicas, each outgoing replica gets this "
                "long to finish its in-flight batches before its worker "
                "join is abandoned (requests still resolve typed)."),
        EnvFlag("SCC_FLEET_RECON_MIN_CELLS", int, 64,
                "Minimum accumulated quarantined cells before "
                "serve.fleet.reconsensus will run the mini-refine and "
                "produce an updated model (below it the loop reports "
                "insufficient evidence and leaves the ledger growing)."),
        # --- traffic control plane (serve/fleet/loadgen + autoscale) ---
        EnvFlag("SCC_LOADGEN_RPS", float, 20.0,
                "Open-loop load generator base arrival rate (requests/s) "
                "— the rate profile's 1.0x level; the spike/ramp peak is "
                "a multiple of it."),
        EnvFlag("SCC_LOADGEN_PROFILE", str, "steady",
                "Load-generator rate profile: steady|diurnal|spike|ramp "
                "(serve.fleet.loadgen.PROFILES)."),
        EnvFlag("SCC_LOADGEN_SEED", int, 7,
                "Seed for the load generator's arrival schedule and "
                "traffic-mix draw — the offered load is a pure function "
                "of (profile, rates, duration, seed)."),
        EnvFlag("SCC_LOADGEN_DURATION_S", float, 8.0,
                "Load-generator run length in seconds (the window the "
                "sustained-RPS-at-SLO headline is measured over)."),
        EnvFlag("SCC_AUTOSCALE_MIN", int, 1,
                "Autoscaler replica floor: scale-down never shrinks the "
                "active group below this many replicas."),
        EnvFlag("SCC_AUTOSCALE_MAX", int, 4,
                "Autoscaler replica ceiling: scale-up never grows the "
                "active group past this many replicas."),
        EnvFlag("SCC_AUTOSCALE_TICK_S", float, 0.25,
                "Autoscaler control-loop cadence in seconds (observe -> "
                "decide -> actuate once per tick)."),
        EnvFlag("SCC_AUTOSCALE_BURN_UP", float, 2.0,
                "Scale-up pressure threshold on the worst multi-window "
                "SLO burn rate (queue pressure is the other trigger; "
                "see serve.fleet.autoscale.AutoscalePolicy)."),
        EnvFlag("SCC_AUTOSCALE_BURN_DOWN", float, 0.25,
                "Scale-down eligibility: the worst burn rate must sit at "
                "or below this (and the queue at or below queue_low) for "
                "down_ticks consecutive ticks."),
        EnvFlag("SCC_AUTOSCALE_UP_TICKS", int, 2,
                "Consecutive pressured ticks before a scale-up actuates "
                "(hysteresis against one-tick blips)."),
        EnvFlag("SCC_AUTOSCALE_DOWN_TICKS", int, 8,
                "Consecutive idle ticks before a scale-down actuates — "
                "deliberately slower than scale-up (capacity is cheap, "
                "a breach is not)."),
        EnvFlag("SCC_AUTOSCALE_COOLDOWN_TICKS", int, 4,
                "Post-actuation cooldown in ticks during which no "
                "further scale action fires (with the streak thresholds, "
                "the no-flap guarantee)."),
    ]
}


def env_flag(name: str, env: Optional[Mapping[str, str]] = None) -> Any:
    """Typed read of a registered flag (KeyError on an unregistered name).
    Unset flags give the registered default; reads are dynamic, so tests
    can set the environment. Bools: unset, "", "0", "false", "off", "no"
    and "none" are False."""
    spec = ENV_FLAGS[name]
    raw = (os.environ if env is None else env).get(name)
    if raw is None:
        return spec.default
    if spec.type is bool:
        return raw.strip().lower() not in _FALSY
    if spec.type in (int, float):
        return spec.type(raw)
    return raw


# The flags the reference's refine() path reads that the port does not
# handle yet, each with the value that means "off": a set one raises.
# Empty since the compile log and the graph passports were ported.
UNPORTED_FLAGS: Tuple[str, ...] = ()


def refuse_unported_flags(env: Optional[Mapping[str, str]] = None) -> None:
    """Raise ``NotImplementedError`` naming the first flag of
    ``UNPORTED_FLAGS`` that is set (to a value other than its off state):
    the port must not accept a reference flag and ignore it."""
    for name in UNPORTED_FLAGS:
        if env_flag(name, env):
            raise NotImplementedError(
                f"{name} is a flag of the reference that the port does "
                "not handle yet; unset it")
