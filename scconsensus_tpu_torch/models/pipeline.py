"""End-to-end refinement: ``refine()`` and the two entry points.

The torch form of ``scconsensus_tpu/models/pipeline.py``
(``ReclusterResult`` :44-59, ``refine`` :62-192, ``_refine_impl``
:208-717, ``recluster_de_consensus`` :797-833,
``recluster_de_consensus_fast`` :836-871).

Stages, each timed into ``result.metrics["stage_walls_s"]`` (on the card
every boundary synchronizes): de (cluster filter, aggregates, gates, the
test: ``wilcox_test``, ``roc_test``, ``bimod_test``, ``t_test`` or the
edgeR sub-stages ``edger_*``, BH, call; absent when DE resumes from the
artifact store) → de_store (with an artifact store: the DE result saved)
→ union →
embed (rSVD PCA on the device, of the DE-gene rows, or with
``distance="pearson"`` of the centred unit-norm cell vectors) → tree →
cuts (dynamic tree cut per deepSplit, host) → silhouette → nodg →
quality (the ``quality`` section; never fails the run) → report (with
``plot_name``: the DE heatmap, host matplotlib).

The matrix is dense (a numpy array or a tensor) or ``scipy.sparse`` in
any format (``_refine_impl`` :238-253). Sparse input crosses once as its
CSR triplet (``io.sparsemat.DeviceCSR``) and is never densified whole:
DE reads gene chunks and compacted windows of it, the embed gathers only
the (|union|, N) rows, and NODG counts its stored nonzeros (negative
values included, the reference's rule for sparse input).

At or below ``approx_threshold`` cells the tree is exact Ward.D2 (native
NN-chain on the host) and the silhouette takes all cuts in one pass of
the CUDA distance × cluster-sum kernel. Above it (``approx``):

* ``approx_method="pool"`` and N ≤ the landmark threshold (200,000 by
  default): full-data Lloyd onto ``n_pool_centroids`` on the device, Ward
  on the centroids weighted by occupancy, cuts on the centroids with the
  size floor scaled by the average occupancy;
* ``approx_method="pool"`` above the landmark threshold: landmarks fitted
  on a sketch, one nearest-landmark pass, Ward on the landmarks, cuts with
  occupancy weights (and with ``landmark_verify`` the exact tree's cuts
  too, scored by ARI);
* ``approx_method="knn"``: kNN graph of the cells on the device, Ward
  agglomeration restricted to it on the host;

and the silhouette is the pooled O(N·m) estimator on the device, reusing
the tree stage's pool where there is one.

``result.metrics`` keys: the tracer's ``as_dict()`` (``stages``,
``total_s``, ``spans``, ``schema``, ``schema_version``: every stage above
runs inside a tracer span of the reference's name, ``de`` and
``de_store`` excepted, whose walls the reference does not time; the
edgeR sub-stages are ``detail`` spans), ``device``, ``stage_walls_s``,
``union_size``,
``per_pair_de_counts``, ``wilcox_ladder`` (Wilcoxon methods: the
rank-sum route and its buckets' occupancy, else None), ``tree_engine``
(engine of the tree stage's last Ward.D2 call, or None), ``n_genes``,
``n_cells``, ``tree`` (``approx``, ``landmark``, ``landmark_k``),
``landmark`` (None, or ``branch``, ``k``, ``sketch``, ``threshold``,
``linkage``, ``occupancy`` per cut and, with ``landmark_verify``,
``ari_vs_exact`` per cut), ``silhouette`` (None without silhouettes,
else ``method``: "exact" or "pooled-estimator", and for the estimator
``n_centroids`` and ``pool_reused``), ``quality`` (``obs.quality``: the DE
gate funnel, the ladder's occupancy, the cluster structure and the
numeric sentinels' health), and, only when something happened,
``robustness`` (``robust.record``: injected faults, retries,
degradations, resume points), ``integrity`` (``robust.integrity``,
present under ``SCC_INTEGRITY=audit|enforce``) and ``kernels`` (under
``SCC_OBS_KERNELS``).

Observability (``scconsensus_tpu/models/pipeline.py:61-206``): ``timer``
(a ``utils.logging.StageTimer``; by default one logging each stage at
INFO) owns the tracer. ``SCC_OBS_TRANSFERS=1`` counts explicit
host↔device copies (``obs.device.TransferWatch``,
``metrics["transfers"]``). ``SCC_OBS_RESIDENCY=audit|enforce`` runs the
pipeline under the residency auditor (``obs.residency``, with the run's
device type as the device side: every crossing span-attributed on
``metrics["residency"]``; enforce raises on a crossing outside the
declared boundaries). ``SCC_OBS_COST=1`` prices the rank-sum and edgeR
chunk bodies on their spans (``obs.cost``). ``SCC_OBS_KERNELS=<dir>``
opens a ``torch.profiler`` window around the run (``obs.kernels``), with
the tracer in annotate mode, and joins every CUDA kernel to the span that
launched it (``metrics["kernels"]``, with ``vs_cost_model`` when the
cost model ran). ``SCC_HOSTPROF=1`` samples the run thread
(``obs.hostprof``; ``metrics["host_profile"]`` and
``["memory_timeline"]``), started here unless a profiler is already
active. ``SCC_WILCOX_PROBE=1`` times each Wilcoxon bucket
(``metrics["wilcox_ladder"]``). ``SCC_TRACE_DIR=<dir>`` writes
``<dir>/run_record.json`` (with every section above, the ``profile``
and ``residency_burndown`` joined from them, and the ``compile`` and
``graphs`` sections when the caller armed ``obs.compilelog`` and
``obs.graphs``, under ``SCC_COMPILELOG`` and ``SCC_GRAPHS``) and a
Perfetto ``<dir>/trace.json`` after the run, from a ``finally``, so a
failed run leaves them too. Capture and export are best effort: a
failure logs a warning and never costs the result; no instrument changes
a result. A reference flag the port does not handle
(``config.UNPORTED_FLAGS``, empty now) raises ``NotImplementedError``
when set.

Every ``method`` of the reference runs: "wilcox" (fast), "wilcoxon"
(slow), "edger", and the fast-path Seurat tests "bimod", "t" and "roc".

Before the first stage the matrix upload runs at the fault plan's
``input_staging`` site, and ``robust.contract.preflight`` rejects a wrong
shape, NaN labels, a matrix with a NaN or Inf, and a labeling with fewer
than two clusters that survive the size filter (``InputContractError``).

The guard rails (``scconsensus_tpu/models/pipeline.py:118-163,
:270-341``): each of the seven stages runs under ``robust.retry.call``
with site ``stage:<name>`` (de, union, embed, tree, cuts, silhouette,
nodg), so a transient or resource fault, injected by ``SCC_FAULT_PLAN``
or real (a ``torch.cuda.OutOfMemoryError``), retries; a resource fault in
embed first drops the upload cache (``utils.devcache``) and frees the
caching allocator's blocks (the reference's ``evict-devcache``). Inside
DE the Wilcoxon ladder recovers bucket by bucket. Under
``SCC_INTEGRITY`` the embed is audited (``pca_scores_audited``, the
``embed_scores`` corruption site, the basis check and a sampled float64
replay), and DE, the landmark assignment and the cut boundary carry
their checks.

With ``config.artifact_dir`` set, the run writes the reference's store
(``utils.artifacts``): ``config.json`` (the config and an input
fingerprint; another config or other input data raises ValueError),
``{de,union,embed,tree,cuts}.{npz,json}`` and ``robust_state.json``. A
re-run resumes each stage from a readable artifact; a corrupt one is
quarantined and recomputed. The tree artifact carries the branch it
took (pool or landmark arrays), and the silhouette and NODG are
recomputed on resume, as in the reference. Inside ``de`` the Wilcoxon
ladder writes a ``de_wilcox_*`` block per finished bucket, so a run
killed there resumes from its finished buckets; the blocks are deleted
once ``de`` is saved. The retry budget is seeded from
``robust_state.json`` and every later take is mirrored into it; a run
that completes resets it to 0. Without ``artifact_dir`` nothing is read
or written.

A ``stream.ChunkedCSRStore`` routes to the out-of-core
``streaming_refine`` (``scconsensus_tpu/models/pipeline.py:103-116``),
serially whatever the mesh, as the reference's runner does.

The mesh (``parallel.mesh``): ``mesh="auto"`` (the default) resolves to a
mesh over every visible card of every rank (in rank order across an
initialized ``torch.distributed`` group, one device a rank on the CPU)
when there are two or more, and to None (the serial path) on one card
or the CPU in one process; an explicit
``parallel.mesh.Mesh`` or None pins it. A mesh across processes is one
run over one input: every rank calls ``refine()`` with the same data and
labels (``ValueError`` on every rank otherwise, from their fingerprints),
and a rank that does not call it leaves the others in the mesh's first
collective until the group's timeout. ``robust.elastic``'s supervisor
owns it for the run (``SCC_ELASTIC``): every stage guard passes its
device-loss hook, and each stage reads the supervisor's current mesh
when it runs, so a ``device_lost`` failure re-enters the stage on the
shrunk mesh. On a mesh the rank-sum tests shard their genes
(``parallel.sharded_de``), the kNN graph of the kNN branch and of the
landmark tree's kNN linkage comes from the ring, and the silhouette of
every cut is the exact one, from one kernel pass over the embedding on
the mesh's home device (every rank's own) (``ops.silhouette.mesh_multi_cut_silhouette``), also
past ``approx_threshold``, where the serial path takes the pooled
estimator. Stage artifacts,
``de`` and the Wilcoxon blocks carry the mesh's ``mesh_shape`` stamp; a
resume of artifacts written on a larger mesh stamps a ``cause:
"resume"`` transition on ``metrics["robustness"]``.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from contextlib import nullcontext
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from scconsensus_tpu_torch.config import (
    CompatFlags,
    ReclusterConfig,
    env_flag,
    refuse_unported_flags,
)
from scconsensus_tpu_torch.de.engine import (
    PairwiseDEResult,
    as_device_matrix,
    de_gene_union,
    encode_labels,
    free_device_cache,
    pairwise_de,
)
from scconsensus_tpu_torch.device import resolve_device
from scconsensus_tpu_torch.io.sparsemat import nodg as count_detected
from scconsensus_tpu_torch.io.sparsemat import rows_dense
from scconsensus_tpu_torch.obs import hostprof
from scconsensus_tpu_torch.obs import quality as obs_quality
from scconsensus_tpu_torch.obs import residency as obs_residency
from scconsensus_tpu_torch.obs.cost import stage_cost_summary
from scconsensus_tpu_torch.obs.device import TransferWatch
from scconsensus_tpu_torch.obs.kernels import KernelCapture
from scconsensus_tpu_torch.obs.regress import adjusted_rand_index
from scconsensus_tpu_torch.ops import linkage
from scconsensus_tpu_torch.ops.colors import labels_to_colors
from scconsensus_tpu_torch.ops.distance import pearson_unit_cells
from scconsensus_tpu_torch.ops.knn_linkage import knn_ward_linkage
from scconsensus_tpu_torch.ops.linkage import HClustTree, ward_linkage
from scconsensus_tpu_torch.ops.pca import pca_scores, pca_scores_audited
from scconsensus_tpu_torch.ops.pooling import (
    landmark_ward_linkage,
    pooled_ward_linkage,
)
from scconsensus_tpu_torch.ops.silhouette import (
    mesh_multi_cut_silhouette,
    multi_cut_silhouette,
    pooled_multi_cut_silhouette,
)
from scconsensus_tpu_torch.ops.treecut import cutree_hybrid
from scconsensus_tpu_torch.robust import faults
from scconsensus_tpu_torch.robust import integrity as robust_integrity
from scconsensus_tpu_torch.robust import record as robust_record
from scconsensus_tpu_torch.robust import retry as robust_retry
from scconsensus_tpu_torch.robust.contract import preflight
from scconsensus_tpu_torch.parallel.mesh import (
    mesh_shape_meta,
    require_same_on_every_rank,
)
from scconsensus_tpu_torch.robust.elastic import ElasticMeshSupervisor
from scconsensus_tpu_torch.utils.artifacts import (
    ArtifactStore,
    input_fingerprint,
)
from scconsensus_tpu_torch.utils.logging import StageTimer, get_logger
from scconsensus_tpu_torch.utils.timing import StageClock

__all__ = ["ReclusterResult", "refine", "recluster_de_consensus",
           "recluster_de_consensus_fast"]

_log = logging.getLogger("scconsensus_tpu_torch")


@dataclasses.dataclass
class ReclusterResult:
    """Pipeline output: the reference's {deGeneUnion, cellTree,
    dynamicColors} plus what it computed and dropped (silhouette, metrics).
    """

    de_gene_union: np.ndarray          # gene names if provided, else indices
    de_gene_union_idx: np.ndarray      # always indices into the input rows
    cell_tree: HClustTree
    dynamic_colors: Dict[str, np.ndarray]   # "deepsplit: k" -> color per cell
    dynamic_labels: Dict[str, np.ndarray]   # same keys -> labels (0 = none)
    deep_split_info: List[Dict]        # per deepSplit: n_clusters, silhouette
    nodg: np.ndarray                   # number of detected genes per cell
    embedding: np.ndarray              # (N, n_pcs) PCA scores
    de: PairwiseDEResult
    metrics: Dict


def refine(
    data,
    labels: Sequence,
    config: ReclusterConfig,
    gene_names: Optional[Sequence[str]] = None,
    device=None,
    omega: Optional[torch.Tensor] = None,
    mesh="auto",
    timer: Optional[StageTimer] = None,
) -> ReclusterResult:
    """Full DE → embed → recluster refinement.

    Args:
      data: (G, N) log-transformed, normalized genes × cells matrix, a
        numpy array, a tensor (a tensor already on ``device`` stays), a
        ``scipy.sparse`` matrix (kept sparse on the device) or a
        disk-resident ``stream.ChunkedCSRStore``, which routes to
        ``stream.runner.streaming_refine`` with ``config.artifact_dir`` as
        its stage dir.
      labels: per-cell consensus cluster labels (e.g. from
        ``plot_contingency_table``).
      device: "cuda" by default; "cpu" only when asked for.
      omega: optional (F, k) random projection for the PCA embed (F = the
        DE-gene union size, k = min(n_pcs + 10, F, N)); see ``carry``.
      mesh: "auto" (every visible card of every rank when the run is on
        ``cuda``, one CPU device a rank across an initialized
        ``torch.distributed`` group, when that makes two or more; else
        the serial path), a ``parallel.mesh.Mesh``, or
        None for the serial path. A mesh run equals the serial run
        (``parallel.validate.assert_mesh_equals_serial``). Across
        processes every rank passes the same ``data`` and ``labels``
        (``ValueError`` otherwise).
      timer: the ``utils.logging.StageTimer`` whose tracer times the
        stages (default: a new one logging to ``get_logger()``, in annotate
        mode under ``SCC_OBS_KERNELS``); ``result.metrics`` carries its
        ``as_dict()``.

    See the module docstring for the branches past ``approx_threshold``,
    the mesh, the guard rails and the keys of ``result.metrics``.
    """
    # out-of-core routing: a disk-resident chunk store runs the whole
    # pipeline chunk at a time under the host-memory budget, with per-shard
    # durable progress in config.artifact_dir (stream.runner), serially
    from scconsensus_tpu_torch.stream.store import ChunkedCSRStore

    if isinstance(data, ChunkedCSRStore):
        from scconsensus_tpu_torch.stream.runner import streaming_refine

        return streaming_refine(data, labels, config, gene_names=gene_names,
                                stage_dir=config.artifact_dir,
                                device=device, omega=omega, timer=timer)
    refuse_unported_flags()
    dev = resolve_device(device)
    # fresh robustness and integrity trails for this run: retries,
    # degradations, resume points and injections land on
    # metrics["robustness"]; checks and ghost replays on
    # metrics["integrity"] (absent with SCC_INTEGRITY=off)
    robust_record.begin_run()
    robust_integrity.begin_run()
    capture = KernelCapture()
    if timer is None:
        # the kernel join needs the spans' record_function windows in the
        # profiler's timeline: the tracer's annotate mode
        timer = StageTimer(get_logger(), trace=capture.enabled)
    watch = None
    if env_flag("SCC_OBS_TRANSFERS"):
        watch = TransferWatch(device_types=(dev.type,))
    auditor = None
    if obs_residency.mode() != "off":
        auditor = obs_residency.ResidencyAuditor(device_types=(dev.type,))
    prof, own_prof = hostprof.active_profiler(), False
    if prof is None and env_flag("SCC_HOSTPROF"):
        prof, own_prof = hostprof.start_if_enabled(), True
    result = None
    try:
        with obs_residency.audit_region(auditor), \
                (watch if watch is not None else nullcontext()), capture:
            result = _refine_impl(data, labels, config, gene_names, dev,
                                  omega, timer, mesh)
    finally:
        sections = _observations(timer, watch, auditor, capture, prof)
        if own_prof:
            hostprof.stop_active()
        trace_dir = env_flag("SCC_TRACE_DIR")
        if trace_dir:
            _export_trace(trace_dir, timer, sections)
    for key in ("transfers", "residency", "kernels", "host_profile",
                "memory_timeline"):
        if sections.get(key) is not None:
            result.metrics[key] = sections[key]
    rb_section = robust_record.section()
    if rb_section is not None:
        # absent on healthy unfaulted runs: absence is the healthy signal
        result.metrics["robustness"] = rb_section
    ig_section = robust_integrity.section()
    if ig_section is not None:
        result.metrics["integrity"] = ig_section
    return result


def _observations(timer: StageTimer, watch, auditor, capture,
                  prof) -> Dict:
    """The instruments' sections of one run (None where off): the
    transfer watch, the residency audit, the kernel capture (with the
    cost model's per-stage summary beside it) and the host profiler.
    Built in the run's ``finally``, so a failed run's record has them."""
    spans = timer.tracer.span_records()
    stage_cost = stage_cost_summary(spans) or None
    out = {
        "transfers": watch.report() if watch is not None else None,
        "residency": auditor.report() if auditor is not None else None,
        "stage_throughput": stage_cost,
        "kernels": None, "host_profile": None, "memory_timeline": None,
    }
    if capture.enabled:
        try:
            out["kernels"] = capture.section(span_records=spans,
                                             stage_cost=stage_cost)
        except Exception as e:  # capture is evidence, never a crash
            get_logger().warning("kernel capture section failed: %r", e)
    if prof is not None:
        out.update(prof.sections())
    return out


def _export_trace(trace_dir: str, timer: StageTimer, sections: Dict) -> None:
    """Best-effort post-run export of ``run_record.json`` (with the
    instruments' sections, and the ``profile`` and ``residency_burndown``
    joined from them) and Perfetto's ``trace.json``; never costs the
    pipeline result."""
    try:
        import os

        from scconsensus_tpu_torch.obs.export import (
            build_run_record,
            write_chrome_trace,
            write_json_atomic,
        )
        from scconsensus_tpu_torch.obs import compilelog, graphs
        from scconsensus_tpu_torch.obs.profile import profile_sections_of

        os.makedirs(trace_dir, exist_ok=True)
        tracer = timer.tracer
        extra = {}
        if sections.get("stage_throughput"):
            extra["stage_throughput"] = sections["stage_throughput"]
        rec = build_run_record(
            metric="refine() pipeline trace",
            value=round(tracer.total_s(), 4),
            unit="seconds",
            tracer=tracer,
            extra=extra,
            transfers=sections.get("transfers"),
            residency=sections.get("residency"),
            kernels=sections.get("kernels"),
            host_profile=sections.get("host_profile"),
            memory_timeline=sections.get("memory_timeline"),
            compile=compilelog.snapshot(),
            graphs=graphs.snapshot(),
        )
        for key, sec in profile_sections_of(rec).items():
            if sec is not None:
                rec[key] = sec
        write_json_atomic(os.path.join(trace_dir, "run_record.json"), rec)
        write_chrome_trace(os.path.join(trace_dir, "trace.json"),
                           tracer.span_records())
    except Exception as e:
        get_logger().warning("trace export failed: %r", e)


def _refine_impl(data, labels, config: ReclusterConfig, gene_names, dev,
                 omega, timer: StageTimer, mesh) -> ReclusterResult:
    tracer = timer.tracer
    # the elastic supervisor owns the mesh ("auto", explicit or None);
    # stages read _mesh() when they run, so a device_lost retry re-enters
    # against the shrunk mesh (SCC_ELASTIC=0: the bare mesh, unsupervised)
    supervisor, mesh = ElasticMeshSupervisor.resolve(mesh, dev)

    def _mesh():
        return supervisor.mesh if supervisor is not None else mesh

    # across processes every rank must pass the same input, checked on a
    # strided-sample fingerprint before any rank uploads or fails alone
    if _mesh() is not None and _mesh().procs > 1:
        require_same_on_every_rank(_mesh(), input_fingerprint(data, labels))

    # the matrix upload runs at the input_staging fault site
    data = as_device_matrix(data, dev)
    G, N = data.shape
    # shape, NaN labels, a non-finite matrix and labelings with fewer than
    # two pairable clusters fail here, typed, before any stage runs
    with robust_record.timed():
        preflight(data, labels, config)
    if supervisor is not None:
        # the sharded working set a shrink re-lays out (each transition's
        # recovered_state_bytes)
        supervisor.note_live_state(data)
    store = ArtifactStore(config.artifact_dir)
    run_log = robust_record.current_run()
    if store.enabled:
        store.check_config(config.to_json(),
                           inputs=input_fingerprint(data, labels))
        # the retry budget survives a kill: seed it from the store's
        # robust_state sidecar and mirror every later take into it
        try:
            _, rb_meta = store.load("robust_state")
            if rb_meta.get("budget_used"):
                run_log.restore_budget(int(rb_meta["budget_used"]))
        except ValueError:
            pass  # quarantined sidecar: the budget restarts, the run goes on
        run_log.set_budget_persist(
            lambda used: store.save("robust_state",
                                    meta={"budget_used": used}))
    clock = StageClock(dev, tracer=tracer)

    def _guard(fn, site, degrade=None):
        # a device_lost failure hands the supervisor the shrink before
        # the retry; a serial run's hook finds no smaller mesh and says so
        return robust_retry.call(
            fn, site, degrade=degrade,
            on_device_loss=(supervisor.loss_handler(site)
                            if supervisor is not None else None))

    def _shape():
        return (supervisor.shape_meta() if supervisor is not None
                else mesh_shape_meta(mesh))

    def _stage_cached(stage, fn):
        # saves stamp the current mesh shape; a resume hands the stored
        # stamp to the supervisor, which records a shrinking crossing
        return store.cached(
            stage, fn, meta_fn=lambda: {"mesh_shape": _shape()},
            on_load_meta=(None if supervisor is None else
                          lambda m: supervisor.note_artifact_meta(stage, m)))

    de_res = None
    if store.has("de"):
        try:
            de_arrays, de_meta = store.load("de")
            if supervisor is not None:
                supervisor.note_artifact_meta("de", de_meta)
            de_res = PairwiseDEResult.from_store(de_arrays, de_meta,
                                                 device=dev)
        except ValueError:
            pass  # corrupt (already quarantined) or incomplete: recompute
    if de_res is None:
        with clock.stage("de", span=False):
            de_res = _guard(
                lambda: pairwise_de(data, labels, config, device=dev,
                                    clock=clock, store=store, mesh=_mesh()),
                site="stage:de")
        if store.enabled:
            # the (P, G) fields to the host, compressed and checksummed
            with clock.stage("de_store", span=False):
                de_arrays, de_meta = de_res.to_store()
                store.save("de", de_arrays,
                           {**de_meta, "mesh_shape": _shape()})
                # the covering artifact landed: the ladder's mid-stage
                # blocks have served their purpose
                store.discard_prefix("de_wilcox_")

    with clock.stage("union") as rec:
        union = _guard(
            lambda: _stage_cached("union", lambda: {
                "idx": de_gene_union(de_res, config.n_top_de_genes)}),
            site="stage:union")["idx"]
        per_pair = de_res.de_counts().tolist()
        rec["union_size"] = int(union.size)
        rec["per_pair_de_counts"] = per_pair
    if union.size < 2:
        raise ValueError(
            f"DE gene union has {union.size} genes — nothing to re-embed. "
            "Loosen q_val_thrs/log_fc_thrs or check cluster labels."
        )

    scores = None
    with clock.stage("embed") as rec:
        n_pcs = min(union.size, config.n_pcs)
        rec["n_pcs"] = n_pcs

        def _embed():
            nonlocal scores
            cols = rows_dense(data, union)                   # (|U|, N)
            if config.distance == "pearson":
                # centred unit-norm cells: euclidean distance between them
                # is sqrt(2·(1 − r)), monotone in the Pearson distance
                cols = pearson_unit_cells(cols)
            cells = cols.T.contiguous()                      # (N, |U|)
            if robust_integrity.enabled():
                # the audited embed: the same scores, plus the basis
                # residual and the mean and components the sampled
                # float64 replay checks score rows against; a detection
                # raises here, inside the stage guard and before the
                # store saves
                sc, ortho, pmean, pcomp = pca_scores_audited(
                    cells, n_pcs, omega=omega)
                sc = faults.corrupt_value("embed_scores", sc)
                robust_integrity.check_pca_basis("stage:embed", ortho)
                if robust_integrity.current().want_replay("pca", 0):
                    robust_integrity.replay_pca_rows(
                        "stage:embed", cells, pmean, pcomp, sc,
                        n_rows=int(cells.shape[0]))
            else:
                sc = pca_scores(cells, n_pcs, omega=omega)   # device
            scores = sc
            # tree and cuts are host algorithms: the (N, n_pcs) scores
            # cross
            with obs_residency.boundary("embed_scores_fetch"):
                return {"scores": sc.cpu().numpy()}

        def _embed_degrade(_attempt):
            # an allocation failure in embed: drop the upload cache and
            # hand the allocator's cached blocks back before the PCA
            # retry; the (N, |U|) gather and the PCA scratch are usually
            # what tipped the card over
            from scconsensus_tpu_torch.utils.devcache import clear_cache

            clear_cache()
            free_device_cache(dev)
            robust_record.note_degradation(
                "stage:embed", "evict-devcache",
                "dropped pinned device buffers before PCA retry")

        embedding = _guard(
            lambda: _stage_cached("embed", _embed), site="stage:embed",
            degrade=_embed_degrade)["scores"]
        if scores is None:  # resumed: the stored scores, to the device
            scores = torch.from_numpy(embedding).to(dev)
        if supervisor is not None:
            # the embedding joins the sharded working set (the ring's kNN
            # and silhouette take it on the mesh)
            supervisor.note_live_state(data, embedding)
        if obs_quality.enabled():
            # a NaN/Inf score corrupts every distance, tree and cut below
            obs_quality.check_array("embedding", embedding, where="embed")

    with clock.stage("tree", n_cells=N) as rec:
        approx = N > config.approx_threshold
        rec["approx"] = approx
        if config.approx_method not in ("pool", "knn"):
            raise ValueError(
                f"approx_method must be 'pool' or 'knn', got "
                f"{config.approx_method!r}"
            )
        lm_policy = (config.landmark_policy(N)
                     if approx and config.approx_method == "pool" else None)
        linkage.LAST_ENGINE = None

        def _tree():
            if approx and config.approx_method == "knn":
                t = knn_ward_linkage(scores, k=config.knn_graph_k,
                                     mesh=_mesh())
                return {"merge": t.merge, "height": t.height,
                        "order": t.order}
            if lm_policy is not None:
                t, assign, cents, lm = landmark_ward_linkage(
                    scores, n_landmarks=lm_policy["k"],
                    sketch=lm_policy["sketch"], seed=config.random_seed,
                    c=lm_policy["c"], k_min=lm_policy["k_min"],
                    k_max=lm_policy["k_max"], linkage=lm_policy["linkage"],
                    knn_k=lm_policy["knn_k"], mesh=_mesh(),
                )
                return {"merge": t.merge, "height": t.height,
                        "order": t.order, "pool_assign": assign,
                        "pool_centroids": cents,
                        "landmark_k": np.asarray(lm["k_used"]),
                        "landmark_sketch": np.asarray(lm["sketch"]),
                        # the linkage as an int code, so a resumed
                        # artifact names the tree it holds
                        "landmark_knn_linkage": np.asarray(
                            1 if lm["linkage"] == "knn" else 0)}
            if approx:
                t, assign, cents = pooled_ward_linkage(
                    scores, n_centroids=config.n_pool_centroids,
                    seed=config.random_seed)
                return {"merge": t.merge, "height": t.height,
                        "order": t.order, "pool_assign": assign,
                        "pool_centroids": cents}
            t = ward_linkage(embedding)
            return {"merge": t.merge, "height": t.height, "order": t.order}

        tree_arrays = _guard(
            lambda: _stage_cached("tree", _tree), site="stage:tree")
        tree = HClustTree(merge=tree_arrays["merge"],
                          height=tree_arrays["height"],
                          order=tree_arrays["order"])
        pool_assign = tree_arrays.get("pool_assign")
        pool_centroids = tree_arrays.get("pool_centroids")
        # the branch taken comes from the artifact (a resumed tree keeps
        # its own cut semantics), not from the policy alone
        landmark_info = None
        if "landmark_k" in tree_arrays:
            landmark_info = {
                "branch": "landmark",
                "k": int(tree_arrays["landmark_k"]),
                "sketch": int(tree_arrays["landmark_sketch"]),
                # the run's policy (None when it no longer selects the
                # landmark branch); linkage describes the stored tree
                "threshold": (lm_policy or {}).get("threshold"),
                "linkage": ("knn" if int(tree_arrays.get(
                    "landmark_knn_linkage", 0)) else "exact"),
            }
        tree_engine = linkage.LAST_ENGINE
        rec["landmark"] = landmark_info is not None
        if landmark_info is not None:
            rec["landmark_k"] = landmark_info["k"]

    dynamic_colors: Dict[str, np.ndarray] = {}
    dynamic_labels: Dict[str, np.ndarray] = {}
    deep_split_info: List[Dict] = []
    with clock.stage("cuts"):
        cut_weights = None
        if pool_assign is None:
            cut_points, cut_min_size = embedding, config.min_cluster_size
        elif landmark_info is not None:
            # cuts on the landmarks in cell units: occupancy weights carry
            # the size floor exactly
            cut_points, cut_min_size = pool_centroids, config.min_cluster_size
            cut_weights = np.bincount(
                pool_assign, minlength=pool_centroids.shape[0]
            ).astype(np.float64)
            # occupancy conservation at the cut boundary: the weights the
            # size floor runs in account for every cell exactly once
            robust_integrity.check_landmark_occupancy(
                "stage:cuts", pool_assign, pool_centroids.shape[0], N)
        else:
            # cuts on the pool: the size floor scaled by the average
            # occupancy
            avg_pool = max(N / pool_centroids.shape[0], 1.0)
            cut_points = pool_centroids
            cut_min_size = max(2, int(round(config.min_cluster_size
                                            / avg_pool)))

        def _cuts():
            out = {}
            for dsv in config.deep_split_values:
                cut_labels = cutree_hybrid(
                    tree, cut_points, deep_split=int(dsv),
                    min_cluster_size=cut_min_size,
                    pam_stage=config.pam_stage, weights=cut_weights,
                )
                if pool_assign is not None:
                    cut_labels = cut_labels[pool_assign]
                out[f"ds{dsv}"] = cut_labels
            return out

        cut_arrays = _guard(
            lambda: _stage_cached("cuts", _cuts), site="stage:cuts")
        for dsv in config.deep_split_values:
            cut_labels = cut_arrays[f"ds{dsv}"]
            key = f"deepsplit: {dsv}"
            dynamic_labels[key] = cut_labels
            dynamic_colors[key] = labels_to_colors(cut_labels)
            deep_split_info.append({
                "deep_split": int(dsv),
                "n_clusters": int(len(set(
                    cut_labels[cut_labels > 0].tolist()))),
            })

        if landmark_info is not None:
            # how many of the landmarks each cut uses
            landmark_info["occupancy"] = {
                f"ds{dsv}": {
                    "landmarks_assigned": int(np.unique(pool_assign[
                        dynamic_labels[f"deepsplit: {dsv}"] > 0]).size),
                    "n_landmarks": int(pool_centroids.shape[0]),
                } for dsv in config.deep_split_values
            }
            if config.landmark_verify:
                # the exact tree and cuts too, scored by ARI per deepSplit:
                # O(N²), for mid-size verification runs only
                exact_tree = ward_linkage(embedding)
                ari = {}
                for dsv in config.deep_split_values:
                    ex = cutree_hybrid(
                        exact_tree, embedding, deep_split=int(dsv),
                        min_cluster_size=config.min_cluster_size,
                        pam_stage=config.pam_stage,
                    )
                    lm_cut = dynamic_labels[f"deepsplit: {dsv}"]
                    m = (lm_cut > 0) & (ex > 0)
                    ari[f"ds{dsv}"] = (
                        round(adjusted_rand_index(lm_cut[m], ex[m]), 6)
                        if int(m.sum()) else None
                    )
                landmark_info["ari_vs_exact"] = ari

    sil_info = None
    if config.compat.return_silhouette:
        with clock.stage("silhouette") as sil_rec:
            labs = [
                np.where(dynamic_labels[f"deepsplit: {dsv}"] > 0,
                         dynamic_labels[f"deepsplit: {dsv}"], -1)
                for dsv in config.deep_split_values
            ]

            def _silhouette():
                # the mesh is read per attempt: a device_lost retry rides
                # the shrunk mesh, or the serial branches once it is gone
                nonlocal sil_info
                mesh_now = _mesh()
                if mesh_now is not None:
                    # the exact widths of every cut from one kernel
                    # pass, past the threshold too (the reference's rule)
                    sil_info = {"method": "exact", "engine": "kernel",
                                "n_shards": mesh_now.size}
                    return mesh_multi_cut_silhouette(scores, labs, mesh_now)
                if approx:
                    # the exact pass is O(N²): past the threshold the
                    # pooled O(N·m) estimator prices neighbours at the
                    # tree stage's pool when there is one
                    sil_info = {
                        "method": "pooled-estimator",
                        "n_centroids": (
                            int(pool_centroids.shape[0])
                            if pool_centroids is not None
                            else config.silhouette_pool_centroids),
                        "pool_reused": pool_centroids is not None,
                    }
                    return pooled_multi_cut_silhouette(
                        scores, labs,
                        n_centroids=config.silhouette_pool_centroids,
                        seed=config.random_seed, centroids=pool_centroids,
                        assign=pool_assign, sample=config.silhouette_sample,
                    )
                sil_info = {"method": "exact"}
                return multi_cut_silhouette(scores, labs)

            sils = _guard(_silhouette, site="stage:silhouette")
            if sil_info["method"] == "pooled-estimator":
                sil_rec.update(sil_info)
            for info, (si, _per) in zip(deep_split_info, sils):
                info["silhouette"] = si
                if sil_info["method"] == "pooled-estimator":
                    info["silhouette_method"] = "pooled-estimator"

    with clock.stage("nodg"):
        with obs_residency.boundary("label_fetch"):
            nodg = _guard(lambda: count_detected(data), site="stage:nodg")

    # quality telemetry: the DE gate funnel, the window ladder's
    # occupancy, the cluster structure against the input labeling and the
    # numeric sentinels' trips. Never fatal: a quality failure must not
    # cost the result it describes
    quality_section = None
    with clock.stage("quality"):
        try:
            if config.compat.return_silhouette and obs_quality.enabled():
                sils = np.array([
                    d["silhouette"] for d in deep_split_info
                    if d.get("silhouette") is not None
                ], np.float64)
                obs_quality.check_array("silhouette", sils,
                                        where="silhouette")
            quality_section = obs_quality.build_quality_section(
                de_result=de_res, config=config,
                dynamic_labels=dynamic_labels,
                deep_split_info=deep_split_info,
                input_labels=(de_res.cell_codes
                              if de_res.cell_codes is not None
                              else encode_labels(labels)[1]),
                occupancy=de_res.ladder, landmark=landmark_info,
                tracer=tracer,
            )
        except Exception as e:
            _log.warning("quality telemetry failed: %r", e)

    union_names = (np.asarray(gene_names)[union] if gene_names is not None
                   else union.copy())
    if config.plot_name:
        # the plot's gene-row gather is a pipeline-tail output
        with clock.stage("report"), obs_residency.boundary("label_fetch"):
            from scconsensus_tpu_torch.report.de_heatmap import (
                cell_type_de_plot,
            )

            cell_type_de_plot(
                data_matrix=rows_dense(data, union).cpu().numpy(),
                nodg=nodg,
                cell_tree=tree,
                cluster_labels=np.asarray(labels).astype(str),
                dynamic_colors_list=dynamic_colors,
                gene_labels=union_names.astype(str),
                filename=config.plot_name,
            )
    metrics = {
        **timer.as_dict(),
        "device": str(dev),
        "stage_walls_s": dict(clock.walls),
        "union_size": int(union.size),
        "per_pair_de_counts": per_pair,
        "wilcox_ladder": de_res.ladder,
        "tree_engine": tree_engine,
        "n_genes": int(G),
        "n_cells": int(N),
        "tree": {"approx": bool(approx),
                 "landmark": landmark_info is not None,
                 "landmark_k": (landmark_info or {}).get("k")},
        "landmark": landmark_info,
        "silhouette": sil_info,
    }
    if quality_section is not None:
        metrics["quality"] = quality_section
    if store.enabled:
        # the run completed: reset the persisted retry budget (a failed
        # run never gets here, so its count stands for the next attempt)
        try:
            store.save("robust_state", meta={"budget_used": 0})
        except OSError:
            pass  # the result stands; only the sidecar is lost
    return ReclusterResult(
        de_gene_union=union_names,
        de_gene_union_idx=union,
        cell_tree=tree,
        dynamic_colors=dynamic_colors,
        dynamic_labels=dynamic_labels,
        deep_split_info=deep_split_info,
        nodg=nodg,
        embedding=embedding,
        de=de_res,
        metrics=metrics,
    )


def recluster_de_consensus(
    data_matrix,
    consensus_cluster_labels: Sequence,
    method: str = "Wilcoxon",
    mean_scaling_factor: float = 5.0,
    q_val_thrs: float = 0.01,
    fc_thrs: float = 2.0,
    deep_split_values: Sequence[int] = (1, 2, 3, 4),
    min_cluster_size: int = 10,
    gene_names: Optional[Sequence[str]] = None,
    plot_name: Optional[str] = None,
    compat: Optional[CompatFlags] = None,
    device=None,
    omega: Optional[torch.Tensor] = None,
    mesh="auto",
    **kw,
) -> ReclusterResult:
    """Reference-shaped slow path (R/reclusterDEConsensus.R:20-29).

    ``method``: "Wilcoxon" or "edgeR" (case as in the reference).
    ``fc_thrs`` is a ratio; the DE criterion uses its natural log.
    ``device``: "cuda" by default. ``omega`` and ``mesh``: see
    ``refine``."""
    m = {"wilcoxon": "wilcoxon", "edger": "edger"}.get(method.lower())
    if m is None:
        raise ValueError(
            f"Incorrect method chosen: {method!r} (Wilcoxon|edgeR)")
    config = ReclusterConfig(
        method=m,
        q_val_thrs=q_val_thrs,
        log_fc_thrs=math.log(fc_thrs),
        mean_scaling_factor=mean_scaling_factor,
        deep_split_values=tuple(int(v) for v in deep_split_values),
        min_cluster_size=min_cluster_size,
        plot_name=plot_name,
        compat=compat or CompatFlags(),
        **kw,
    )
    return refine(data_matrix, consensus_cluster_labels, config, gene_names,
                  device=device, omega=omega, mesh=mesh)


def recluster_de_consensus_fast(
    data_matrix,
    consensus_cluster_labels: Sequence,
    method: str = "wilcox",
    q_val_thrs: float = 0.1,
    log_fc_thrs: float = 0.5,
    deep_split_values: Sequence[int] = (1, 2, 3, 4),
    min_cluster_size: int = 10,
    min_per_cent: float = 20.0,
    number_top_de_genes: int = 30,
    gene_names: Optional[Sequence[str]] = None,
    plot_name: Optional[str] = None,
    compat: Optional[CompatFlags] = None,
    device=None,
    omega: Optional[torch.Tensor] = None,
    mesh="auto",
    **kw,
) -> ReclusterResult:
    """Reference-shaped fast path (R/reclusterDEConsensusFast.R:22-33).

    ``method``: "wilcox", "bimod", "t" or "roc". ``device``: "cuda" by
    default. ``omega`` and ``mesh``: see ``refine``."""
    config = ReclusterConfig(
        method=method.lower(),
        q_val_thrs=q_val_thrs,
        log_fc_thrs=log_fc_thrs,
        deep_split_values=tuple(int(v) for v in deep_split_values),
        min_cluster_size=min_cluster_size,
        min_pct=min_per_cent,
        n_top_de_genes=number_top_de_genes,
        plot_name=plot_name,
        compat=compat or CompatFlags(),
        **kw,
    )
    return refine(data_matrix, consensus_cluster_labels, config, gene_names,
                  device=device, omega=omega, mesh=mesh)
