"""Out-of-core streaming refine: the full pipeline over disk chunks.

The torch form of ``scconsensus_tpu/stream/runner.py``.
``streaming_refine(store, labels, config)`` runs DE → union → embed →
tree → cuts → silhouette → nodg against a :class:`ChunkedCSRStore` under
a hard host-memory budget (``stream.budget``): chunks load → compute →
drop, every per-shard result lands in a resumable ArtifactStore stage
keyed by content, and a SIGKILL at any point resumes from the last
durable chunk to byte-identical labels. It runs on ``cuda`` unless
called with ``device="cpu"``, and raises with no card.

Per-shard strategy (chunking the gene axis is exact, not approximate):

  * **DE**: rank tests, gates and BH are per gene. Each chunk's (Gb, N)
    CSR slab crosses to the device and runs the same window ladder as the
    in-memory engine (``de.engine.streaming_wilcox_block``); the (P, Gb)
    log p and U cross back once. The per-cluster aggregates are float64
    host scatter-adds (``np.bincount``), cast to float32 for the gates.
  * **embed**: when the dense (N, |U|) cell matrix fits the staged
    budget, the same randomized subspace iteration as ``refine()`` runs
    on the same bytes (``ops.pca.pca_scores``), so the embedding and
    every label downstream equal ``refine()``'s. Past the budget the run
    degrades (recorded) to the (|U|, |U|) gene-space Gram eigenbasis
    from pairwise chunk joins on the host (:func:`_gram_pca_streamed`),
    deterministic per input.
  * **tree, cuts, silhouette**: the branch policy of ``refine()``: exact
    Ward.D2 and the exact silhouette (the CUDA kernel
    ``distance_cluster_sums``) at or below ``approx_threshold``; above
    it the landmark tree (its staging charged to the budget), the legacy
    pool or the kNN graph, and the pooled silhouette estimator.
  * **nodg**: per-cell detected-gene counts accumulate over chunks.

Recovery ladders (typed, recorded on the robustness trail): a
``HostBudgetExceeded`` halves the streaming gene window (floor 1 row,
then the typed error propagates); a disk-class per-chunk checkpoint
write failure doubles the checkpoint granularity before failing typed; a
torn chunk quarantines and recomputes through the store's generator.

``result.metrics`` holds the tracer's ``as_dict()`` (``stages``,
``total_s``, ``spans``, ``schema``, ``schema_version``; each stage runs
inside a tracer span of the reference's name, the tracer owned by
``timer``), ``device``, ``stage_walls_s``, ``union_size``,
``per_pair_de_counts``, ``n_genes``, ``n_cells``, ``tree``,
``silhouette``, ``stream`` (``embed_regime`` "dense" or "gram", the
chunk loads and their seconds by stage, the ingest's chunks and seconds,
the resumed DE chunks), the validated ``streaming`` section and, when
something happened, ``robustness`` and ``integrity``. Only the fast
Wilcoxon runs out-of-core, and only the euclidean distance, as in the
reference.
"""

from __future__ import annotations

import hashlib
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from scconsensus_tpu_torch.config import (
    ReclusterConfig,
    refuse_unported_flags,
)
from scconsensus_tpu_torch.device import resolve_device
from scconsensus_tpu_torch.stream import record as stream_record
from scconsensus_tpu_torch.stream.budget import (
    HostBudgetAccountant,
    HostBudgetExceeded,
)
from scconsensus_tpu_torch.stream.store import ChunkedCSRStore
from scconsensus_tpu_torch.utils.artifacts import ArtifactStore
from scconsensus_tpu_torch.utils.logging import StageTimer, get_logger
from scconsensus_tpu_torch.utils.timing import StageClock

__all__ = ["streaming_refine"]


def _labels_sha(labels) -> str:
    # hash the unicode array's raw buffer (dtype stamped, since the UCS4
    # width depends on the longest label): one O(N) pass, no per-cell
    # Python strings inside the bounded-memory layer
    lab = np.ascontiguousarray(np.asarray(labels).astype(str))
    h = hashlib.sha256(str(lab.dtype).encode())
    h.update(lab.tobytes())
    return h.hexdigest()[:16]


def _chunk_key(i: int, g0: int, g1: int, n_cells: int, groups_sha: str
               ) -> str:
    """Content-addressed per-chunk DE stage name: rows and the cell-group
    fingerprint, so a resume with other labels or subsampling can never
    adopt the wrong block. The reference's key, so stage dirs cross
    between the packages."""
    h = hashlib.sha256(
        f"{i}:{g0}:{g1}:{n_cells}:{groups_sha}".encode()
    ).hexdigest()[:16]
    return f"stream_de_{h}"


class _StreamState:
    """One run's streaming bookkeeping (the window ladder, the checkpoint
    granularity, resume counts): what the validated section is built
    from at the end."""

    def __init__(self, window_rows: int):
        self.window_initial = int(window_rows)
        self.window_rows = int(window_rows)
        self.halvings = 0
        self.ckpt_initial = 1
        self.ckpt_every = 1
        self.de_resumed = 0

    def halve_window(self, why: str) -> None:
        from scconsensus_tpu_torch.robust import record as robust_record

        if self.window_rows <= 1:
            raise HostBudgetExceeded(
                "staged", 0, 0, 0,
                f"window ladder floor reached (1 row) — {why}",
            )
        self.window_rows = max(self.window_rows // 2, 1)
        self.halvings += 1
        robust_record.note_degradation(
            "stream_stage", "halve-window",
            f"{why}; streaming window now {self.window_rows} rows",
        )

    def coarsen_ckpt(self, why: str) -> None:
        from scconsensus_tpu_torch.robust import record as robust_record

        self.ckpt_every *= 2
        robust_record.note_degradation(
            "stream_stage", "shrink-ckpt-granularity",
            f"{why}; per-chunk checkpoints now every "
            f"{self.ckpt_every} chunk(s)",
        )


class _ChunkLoads:
    """Chunk loads (``store.ensure_chunk``) counted and timed by stage:
    at scale the loads' checksums and decompression, not the card, set
    the wall."""

    def __init__(self, store: ChunkedCSRStore, regen):
        self.store = store
        self.regen = regen
        self.by_stage: Dict[str, Dict[str, float]] = {}

    def __call__(self, i: int, stage: str):
        t0 = time.perf_counter()
        try:
            return self.store.ensure_chunk(i, self.regen)
        finally:
            rec = self.by_stage.setdefault(stage, {"loads": 0, "s": 0.0})
            rec["loads"] += 1
            rec["s"] += time.perf_counter() - t0


def streaming_refine(
    store: ChunkedCSRStore,
    labels: Sequence,
    config: ReclusterConfig,
    gene_names: Optional[Sequence[str]] = None,
    stage_dir: Optional[str] = None,
    accountant: Optional[HostBudgetAccountant] = None,
    regen: Optional[Callable[[int, int], Any]] = None,
    device=None,
    omega: Optional[torch.Tensor] = None,
    timer: Optional[StageTimer] = None,
):
    """Run the refine pipeline out-of-core against ``store``.

    ``stage_dir`` (default ``<store.root>/stages``) holds the resumable
    per-shard progress; ``regen(g0, g1)`` regenerates quarantined chunks
    (the synthetic workloads pass their seeded generator; ingested data
    without one fails typed on a torn chunk). ``device``: "cuda" by
    default, "cpu" only when asked for. ``omega``: the dense embed's
    random projection, as for ``refine()``. ``timer``: the
    ``utils.logging.StageTimer`` whose tracer times the stages (default:
    a new one logging to ``get_logger()``). Returns a
    ``models.pipeline.ReclusterResult`` whose ``metrics`` carry the
    validated ``streaming`` section. Only ``config.method == "wilcox"``
    runs out-of-core.
    """
    from scconsensus_tpu_torch.robust import integrity as robust_integrity
    from scconsensus_tpu_torch.robust import record as robust_record
    from scconsensus_tpu_torch.robust import retry as robust_retry

    if config.method.lower() not in ("wilcox",):
        raise NotImplementedError(
            f"streaming_refine supports method='wilcox' only (got "
            f"{config.method!r}) — the NB/edgeR path is not sharded "
            "out-of-core yet"
        )
    refuse_unported_flags()
    dev = resolve_device(device)
    timer = timer or StageTimer(get_logger())
    robust_record.begin_run()
    robust_integrity.begin_run()
    G, N = store.shape
    lab = np.asarray(labels).astype(str)
    if lab.size != N:
        raise ValueError(
            f"labels have {lab.size} entries for a {N}-cell chunk store"
        )

    stages = ArtifactStore(stage_dir or f"{store.root.rstrip('/')}/stages")
    state = _StreamState(store.row_window)
    acct = accountant or HostBudgetAccountant()
    run_log = robust_record.current_run()

    groups_sha = _labels_sha(lab) + f":{config.min_cluster_size}" \
        f":{config.min_cells_group}:{config.max_cells_per_ident}" \
        f":{config.random_seed}"
    stages.check_config(config.to_json(), inputs={
        "stream_manifest": {k: store.manifest()[k] for k in
                            ("n_genes", "n_cells", "row_window")},
        "groups_sha": groups_sha,
    })
    # the retry budget survives a kill, as in the in-memory pipeline
    try:
        _, rb_meta = stages.load("robust_state")
        if rb_meta.get("budget_used"):
            run_log.restore_budget(int(rb_meta["budget_used"]))
    except ValueError:
        pass
    run_log.set_budget_persist(
        lambda used: stages.save("robust_state",
                                 meta={"budget_used": used})
    )

    def _guard(fn, site="stream_stage", degrade=None):
        return robust_retry.call(fn, site, degrade=degrade)

    with acct:
        result = _streaming_impl(
            store, lab, config, gene_names, stages, state, acct, regen,
            _guard, groups_sha, dev, omega, timer,
        )

    # -- the validated streaming section ---------------------------------
    c = store.counters
    completed = c["fresh"] + c["resumed"]
    bud = acct.budget_fields()
    section = stream_record.build_streaming_section(
        planned=store.n_chunks, fresh=c["fresh"], resumed=c["resumed"],
        recomputed=c["recomputed"], quarantined=c["quarantined"],
        window_initial=state.window_initial,
        window_final=state.window_rows, halvings=state.halvings,
        ckpt_initial=state.ckpt_initial, ckpt_final=state.ckpt_every,
        limit_mb=bud["limit_mb"], stage_limit_mb=bud["stage_limit_mb"],
        baseline_rss_mb=bud["baseline_rss_mb"],
        peak_rss_mb=bud["peak_rss_mb"],
        peak_staged_mb=bud["peak_staged_mb"],
        complete=(completed == store.n_chunks),
        budget_mb=bud["budget_mb"],
    )
    stream_record.validate_streaming(section)  # the emitter self-checks
    result.metrics["streaming"] = section
    rb = robust_record.section()
    if rb is not None:
        result.metrics["robustness"] = rb
    ig = robust_integrity.section()
    if ig is not None:
        result.metrics["integrity"] = ig
    try:
        stages.save("robust_state", meta={"budget_used": 0})
    except Exception:
        pass
    return result


def _gram_pca_streamed(store, union, acct, n_pcs: int,
                       load_part) -> np.ndarray:
    """Fully streamed PCA through the (|U|, |U|) gene-space Gram matrix:
    the eigenvectors of the centred Gram are the principal axes. The Gram
    accumulates from pairwise chunk joins (two chunks' union rows in
    memory at a time), and the (N, p) scores from one sparse-times-dense
    product per chunk; the scores are the one O(N) buffer, charged.
    Deterministic (LAPACK eigh and a fixed sign convention), so resumes
    and reruns reproduce bit for bit. The union-bearing chunks load
    O(u_chunks) times each for the joins: the price of the degraded
    path. Host numpy throughout, the reference's arithmetic."""
    n_cells = store.shape[1]
    u = int(np.asarray(union).size)
    with_rows = []
    for i in range(store.n_chunks):
        g0, g1 = store.chunk_rows(i)
        uni = np.asarray(union)
        if np.any((uni >= g0) & (uni < g1)):
            with_rows.append(i)
    gram = np.zeros((u, u), np.float64)
    msum = np.zeros(u, np.float64)
    for ai, a in enumerate(with_rows):
        xa, sel_a = load_part(a)
        acct.charge(xa.data.nbytes * 3, "gram_join")
        try:
            msum[sel_a] = np.asarray(xa.sum(axis=1), np.float64).ravel()
            gram[np.ix_(sel_a, sel_a)] = (xa @ xa.T).toarray()
            for b in with_rows[ai + 1:]:
                xb, sel_b = load_part(b)
                blockc = np.asarray((xa @ xb.T).toarray(), np.float64)
                gram[np.ix_(sel_a, sel_b)] = blockc
                gram[np.ix_(sel_b, sel_a)] = blockc.T
                del xb
        finally:
            acct.release(xa.data.nbytes * 3, "gram_join")
            del xa
    m = msum / n_cells
    gram -= n_cells * np.outer(m, m)
    evals, evecs = np.linalg.eigh(gram)
    order = np.argsort(evals)[::-1][:n_pcs]
    v = evecs[:, order]
    # deterministic sign convention (eigh signs are arbitrary): the
    # largest-|loading| component positive
    flip = v[np.argmax(np.abs(v), axis=0), np.arange(v.shape[1])] < 0
    v[:, flip] *= -1.0
    v32 = np.ascontiguousarray(v, np.float32)
    acct.charge(n_cells * n_pcs * 4, "scores")
    scores = np.zeros((n_cells, n_pcs), np.float32)
    for a in with_rows:
        xa, sel_a = load_part(a)
        try:
            scores += np.asarray(xa.T.dot(v32[sel_a]), np.float32)
        finally:
            del xa
    return scores - (m @ v).astype(np.float32)[None, :]


def _chunk_aggregates(block, cid: np.ndarray, K: int) -> Dict[str, Any]:
    """Per-cluster sufficient statistics of one (Gb, N) CSR slab as
    nnz-bound float64 host scatter-adds; no (N, K) one-hot ever exists.
    ``np.bincount`` adds its weights in input order, as the reference's
    ``np.add.at`` does, so the sums are the same bits."""
    gb = block.shape[0]
    data, indices, indptr = block.data, block.indices, block.indptr
    rows = np.repeat(np.arange(gb, dtype=np.int64), np.diff(indptr))
    k = cid[indices]
    m = k >= 0
    rows, k, vals = rows[m], k[m], data[m].astype(np.float64)
    flat = rows * K + k
    size = gb * K

    def _sum(w):
        return np.bincount(flat, weights=w, minlength=size).reshape(gb, K)

    return {
        "sum_log": _sum(vals),
        "sum_expm1": _sum(np.expm1(vals)),
        "sum_sq": _sum(vals * vals),
        "nnz": _sum((vals > 0).astype(np.float64)),
    }


def _fetch(x: torch.Tensor) -> np.ndarray:
    """One declared device → host copy (noted on the card only)."""
    from scconsensus_tpu_torch.obs import residency

    if x.device.type == "cuda":
        residency.note_transfer("d2h", x.numel() * x.element_size())
    return x.cpu().numpy()


def _streaming_impl(store, lab, config, gene_names, stages, state, acct,
                    regen, _guard, groups_sha, dev, omega, timer):
    from scconsensus_tpu_torch.de.engine import (
        PairwiseDEResult,
        _all_pairs,
        _cid_from_groups,
        de_gene_union,
        filter_clusters,
        free_device_cache,
        streaming_wilcox_block,
    )
    from scconsensus_tpu_torch.models.pipeline import ReclusterResult
    from scconsensus_tpu_torch.obs import residency
    from scconsensus_tpu_torch.ops.colors import labels_to_colors
    from scconsensus_tpu_torch.ops.gates import (
        ClusterAggregates,
        pair_gates_fast,
    )
    from scconsensus_tpu_torch.ops.linkage import HClustTree, ward_linkage
    from scconsensus_tpu_torch.ops.multipletests import bh_adjust_masked
    from scconsensus_tpu_torch.ops.treecut import cutree_hybrid
    from scconsensus_tpu_torch.robust import integrity as robust_integrity
    from scconsensus_tpu_torch.robust import record as robust_record
    from scconsensus_tpu_torch.robust.faults import corrupt_value

    G, N = store.shape
    clock = StageClock(dev, tracer=timer.tracer)
    load = _ChunkLoads(store, regen)
    ingest = {"chunks": 0, "s": 0.0}

    # ---- cluster groups (host, O(N)) -----------------------------------
    with clock.stage("cluster_filter"):
        names, cell_idx = filter_clusters(
            lab, config.min_cluster_size, config.drop_grey
        )
        K = len(names)
        if K < 2:
            raise ValueError(
                f"need >= 2 clusters above min_cluster_size="
                f"{config.min_cluster_size}, got {K}"
            )
        cell_idx_of = [np.nonzero(cell_idx == k)[0].astype(np.int32)
                       for k in range(K)]
        if config.max_cells_per_ident is not None:
            rng = np.random.default_rng(config.random_seed)
            cap = config.max_cells_per_ident
            cell_idx_of = [
                rng.choice(ci, size=cap, replace=False)
                if ci.size > cap else ci for ci in cell_idx_of
            ]
        pair_i, pair_j = _all_pairs(K)
        P = int(pair_i.size)
        n_of = np.array([ci.size for ci in cell_idx_of], np.int32)
        pair_ok = (n_of[pair_i] >= config.min_cells_group) & (
            n_of[pair_j] >= config.min_cells_group
        )
        skip_reasons = [
            f"{names[i]} vs {names[j]}: group sizes ({n_of[i]}, {n_of[j]})"
            f" below min_cells_group={config.min_cells_group}"
            for i, j in zip(pair_i[~pair_ok], pair_j[~pair_ok])
        ]
        if not pair_ok.any():
            raise ValueError(
                "every cluster pair has a group below min_cells_group="
                f"{config.min_cells_group}; nothing to test"
            )
        acct.charge(cell_idx.nbytes, "cell_groups")
        test_cid = None  # the post-subsampling groups, made on first use

    # ---- DE: chunk-at-a-time Wilcoxon + aggregates ----------------------
    def _process_chunk(i: int, g0: int, g1: int):
        """One chunk's (P, Gb) log p and U and (Gb, K) aggregates, from
        the durable stage artifact when present (the resume path), else
        computed under the window-halving ladder and checkpointed."""
        nonlocal test_cid
        key = _chunk_key(i, g0, g1, N, groups_sha)
        if stages.has(key):
            try:
                arrays, _ = stages.load(key)
                state.de_resumed += 1
                return arrays
            except ValueError:
                pass  # quarantined by load(): recompute below
        est_chunk = store.chunk_host_bytes(i)
        acct.charge(est_chunk, "chunk")
        try:
            # a torn chunk without a generator raises typed ChunkCorrupt
            # (the store already quarantined the files)
            block = load(i, "de")
            gb = block.shape[0]
            lp_rows: List[np.ndarray] = []
            u_rows: List[np.ndarray] = []
            agg_parts: List[Dict[str, Any]] = []
            r0 = 0
            while r0 < gb:
                w = max(min(state.window_rows, gb - r0), 1)
                sub = block[r0:r0 + w]
                # the sub-window's working set: the (P, w) outputs (×2,
                # log p and U, float32 device and host copies) plus the
                # compacted window staging (nnz-bound): what halving
                # shrinks
                est = w * P * 4 * 4 + int(sub.nnz) * 12
                try:
                    acct.charge(est, "de_window")
                except HostBudgetExceeded as e:
                    state.halve_window(str(e).splitlines()[0][:140])
                    continue
                try:
                    lp_d, u_d = streaming_wilcox_block(
                        sub, cell_idx_of, pair_i, pair_j, device=dev)
                    with residency.boundary("stream_block_fetch"):
                        lp_h = np.asarray(_fetch(lp_d), np.float32)
                        u_h = np.asarray(_fetch(u_d), np.float32)
                    del lp_d, u_d
                    # the integrity tier: the stream_block corruption
                    # site, the conservation check over the fetched block
                    # and one host ghost replay per run; a detection
                    # raises typed silent_corruption inside this chunk's
                    # guard, which recomputes the chunk before it persists
                    lp_h, u_h = corrupt_value("stream_block", (lp_h, u_h))
                    if robust_integrity.enabled():
                        robust_integrity.check_wilcox_host(
                            "stream_block", lp_h, u_h,
                            n_of[pair_i], n_of[pair_j],
                        )
                        if robust_integrity.current().want_replay(
                                "stream_chunk", 0):
                            if test_cid is None:
                                test_cid = _cid_from_groups(cell_idx_of, N)
                            robust_integrity.replay_stream_chunk(
                                "stream_block", f"chunk:{i}", sub,
                                test_cid, n_of, pair_i, pair_j, lp_h, u_h,
                            )
                    lp_rows.append(lp_h)
                    u_rows.append(u_h)
                    agg_parts.append(_chunk_aggregates(sub, cell_idx, K))
                finally:
                    acct.release(est, "de_window")
                r0 += w
            arrays = {
                "lp": np.concatenate(lp_rows, axis=1),
                "u": np.concatenate(u_rows, axis=1),
            }
            for f in ("sum_log", "sum_expm1", "sum_sq", "nnz"):
                arrays[f] = np.concatenate(
                    [a[f] for a in agg_parts], axis=0
                ).astype(np.float32)
            if i % state.ckpt_every == 0:
                def _save():
                    stages.save(key, arrays, meta={"g0": g0, "g1": g1})

                def _ckpt_degrade(_attempt):
                    # ENOSPC on a durability write: coarsen granularity
                    # (fewer checkpoints, less disk) before retrying
                    state.coarsen_ckpt(
                        "disk fault writing per-chunk DE checkpoint"
                    )
                try:
                    _guard(_save, site="stream_chunk_write",
                           degrade=_ckpt_degrade)
                except Exception as e:
                    robust_record.note_degradation(
                        "stream_chunk_write", "ckpt-skip",
                        f"checkpoint write failed typed ({e!r}); "
                        "continuing without durability for this chunk",
                    )
            return arrays
        finally:
            acct.release(est_chunk, "chunk")
            # the slab and the ladder's workspace go back between chunks:
            # peak device memory stays one chunk's, not the run's
            free_device_cache(dev)

    with clock.stage("de"):
        # every chunk durable first (the resumable ingest: the generator
        # backed workloads materialize here; pre-ingested stores count
        # their durable chunks, so a full resume still reports completed
        # == planned)
        t0 = time.perf_counter()
        if regen is not None:
            ingest["chunks"] = store.ingest(regen)
        else:
            store.adopt_durable()
        ingest["s"] = time.perf_counter() - t0
        lp_parts: List[np.ndarray] = []
        agg_acc: Dict[str, List[np.ndarray]] = {
            "sum_log": [], "sum_expm1": [], "sum_sq": [], "nnz": [],
        }
        for i in range(store.n_chunks):
            g0, g1 = store.chunk_rows(i)
            arrays = _guard(lambda i=i, g0=g0, g1=g1:
                            _process_chunk(i, g0, g1))
            lp_parts.append(arrays["lp"])
            for f in agg_acc:
                agg_acc[f].append(np.asarray(arrays[f], np.float64))
            acct.note_progress(stage="de", chunks_done=i + 1,
                               chunks_planned=store.n_chunks,
                               halvings=state.halvings)
        if state.de_resumed:
            robust_record.note_resume_point(
                "stream_de", "chunk", state.de_resumed, store.n_chunks
            )
        # U rides the chunk artifacts for resume identity; the fast-path
        # call never reads it
        log_p = np.concatenate(lp_parts, axis=1)      # (P, G) float32
        del lp_parts
        agg_host = {f: np.concatenate(v, axis=0) for f, v in
                    agg_acc.items()}
        del agg_acc

        counts = np.zeros(K, np.float64)
        for k in range(K):
            counts[k] = float(np.sum(cell_idx == k))

        def _t(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        agg = ClusterAggregates(
            sum_log=_t(agg_host["sum_log"]),
            sum_expm1=_t(agg_host["sum_expm1"]),
            sum_sq=_t(agg_host["sum_sq"]),
            nnz=_t(agg_host["nnz"]),
            counts=_t(counts),
        )
        del agg_host
        pi = _t(pair_i, torch.int64)
        pj = _t(pair_j, torch.int64)
        j_ok = _t(pair_ok, torch.bool)
        gate, log_fc, pct1, pct2 = pair_gates_fast(
            agg, pi, pj,
            min_pct=config.min_pct,
            min_diff_pct=config.min_diff_pct,
            log_fc_thrs=config.log_fc_thrs,
            mean_exprs_thrs=config.mean_exprs_thrs,
            pseudocount=config.pseudocount,
            only_pos=config.only_pos,
        )
        tested = gate & j_ok[:, None]
        lp_t = torch.from_numpy(log_p).to(dev)
        del log_p
        jlp = torch.where(tested, lp_t, torch.full_like(lp_t, float("nan")))
        del lp_t
        log_q = bh_adjust_masked(jlp, tested)
        log_thr = float(np.log(np.float32(config.q_val_thrs)))
        de_mask = tested & (log_q < log_thr) & ~torch.isnan(log_q)
        de_res = PairwiseDEResult(
            cluster_names=names,
            pair_i=pair_i, pair_j=pair_j,
            log_p=jlp, log_q=log_q, log_fc=log_fc,
            tested=tested, de_mask=de_mask,
            pair_skipped=~pair_ok,
            pct1=pct1, pct2=pct2,
            aux={"funnel_gate_full": gate.sum(dim=1).to(torch.int32)},
            skip_reasons=skip_reasons or None,
        )

    # ---- union ----------------------------------------------------------
    with clock.stage("union"):
        union = _guard(lambda: stages.cached(
            "union",
            lambda: {"idx": de_gene_union(de_res, config.n_top_de_genes)},
        ))["idx"]
    if union.size < 2:
        raise ValueError(
            f"DE gene union has {union.size} genes — nothing to "
            "re-embed. Loosen q_val_thrs/log_fc_thrs or check cluster "
            "labels."
        )

    # ---- embed: the dense twin, or the streamed Gram PCA ----------------
    regime = {"embed": None}
    with clock.stage("embed"):
        n_pcs = min(int(union.size), config.n_pcs)

        def _union_rows_of(i: int):
            """(local row ids, global union positions) of chunk i."""
            g0, g1 = store.chunk_rows(i)
            uni = np.asarray(union)
            sel = np.nonzero((uni >= g0) & (uni < g1))[0]
            return (uni[sel] - g0), sel

        def _load_union_slab_part(i: int):
            """This chunk's union rows as a CSR part (a transient chunk
            charge; the caller owns the part's lifetime)."""
            est = store.chunk_host_bytes(i)
            acct.charge(est, "chunk")
            try:
                block = load(i, "embed")
                rows, sel = _union_rows_of(i)
                return block[rows], sel
            finally:
                acct.release(est, "chunk")

        def _embed():
            import scipy.sparse as sp

            if config.distance != "euclidean":
                raise NotImplementedError(
                    "streaming_refine supports distance='euclidean' "
                    f"only (got {config.distance!r})"
                )
            # the exact twin first: when the dense (N, |U|) cell matrix
            # fits the staged budget, the same randomized subspace
            # iteration as refine() runs on the same bytes. The
            # reservation covers the dense matrix and the largest
            # transient chunk load the gather charges on top of it
            dense_bytes = int(N) * int(union.size) * 4 * 3 + max(
                store.chunk_host_bytes(i) for i in range(store.n_chunks)
            )
            try:
                acct.charge(dense_bytes, "embed_dense")
            except HostBudgetExceeded:
                robust_record.note_degradation(
                    "stream_stage", "gram-pca-embed",
                    f"dense (N={N}, |U|={union.size}) embed would pass "
                    "the staged budget; using the streamed gene-space "
                    "Gram eigenbasis (deterministic, subspace-equal "
                    "for separated spectra)",
                )
                regime["embed"] = "gram"
                return {"scores": _gram_pca_streamed(
                    store, union, acct, n_pcs, _load_union_slab_part,
                )}
            try:
                from scconsensus_tpu_torch.ops.pca import pca_scores

                regime["embed"] = "dense"
                parts = [None] * store.n_chunks
                for i in range(store.n_chunks):
                    if _union_rows_of(i)[0].size:
                        parts[i] = _load_union_slab_part(i)[0]
                xs = sp.vstack([p for p in parts if p is not None]
                               ).tocsr()  # (|U|, N), union order
                del parts
                # (N, |U|) C-contiguous, the layout refine() hands over
                cells = np.ascontiguousarray(xs.toarray().T, np.float32)
                del xs
                scores = pca_scores(torch.from_numpy(cells).to(dev), n_pcs,
                                    omega=omega)
                del cells
                with residency.boundary("embed_scores_fetch"):
                    acct.charge(N * n_pcs * 4, "scores")
                    return {"scores": _fetch(scores)}
            finally:
                acct.release(dense_bytes, "embed_dense")

        embedding = _guard(lambda: stages.cached("embed", _embed))["scores"]
        scores_d = torch.from_numpy(
            np.ascontiguousarray(embedding, np.float32)).to(dev)

    # ---- tree (refine()'s branch policy) --------------------------------
    with clock.stage("tree"):
        approx = N > config.approx_threshold
        lm_policy = (
            config.landmark_policy(N)
            if approx and config.approx_method == "pool" else None
        )

        def _tree():
            if approx and config.approx_method == "knn":
                from scconsensus_tpu_torch.ops.knn_linkage import (
                    knn_ward_linkage,
                )

                t = knn_ward_linkage(scores_d, k=config.knn_graph_k)
                return {"merge": t.merge, "height": t.height,
                        "order": t.order}
            if lm_policy is not None:
                from scconsensus_tpu_torch.ops.pooling import (
                    landmark_ward_linkage,
                )

                t, assign, cents, info = landmark_ward_linkage(
                    scores_d,
                    n_landmarks=lm_policy["k"],
                    sketch=lm_policy["sketch"],
                    seed=config.random_seed,
                    c=lm_policy["c"],
                    k_min=lm_policy["k_min"],
                    k_max=lm_policy["k_max"],
                    linkage=lm_policy["linkage"],
                    knn_k=lm_policy["knn_k"],
                    charge=lambda nb, what: acct.charge(nb, what) and
                    acct.release(nb, what),
                )
                return {"merge": t.merge, "height": t.height,
                        "order": t.order, "pool_assign": assign,
                        "pool_centroids": cents,
                        "landmark_k": np.asarray(info["k_used"]),
                        "landmark_sketch": np.asarray(info["sketch"])}
            if approx:
                from scconsensus_tpu_torch.ops.pooling import (
                    pooled_ward_linkage,
                )

                t, assign, cents = pooled_ward_linkage(
                    scores_d, n_centroids=config.n_pool_centroids,
                    seed=config.random_seed,
                )
                return {"merge": t.merge, "height": t.height,
                        "order": t.order, "pool_assign": assign,
                        "pool_centroids": cents}
            t = ward_linkage(embedding)
            return {"merge": t.merge, "height": t.height, "order": t.order}

        tree_arrays = _guard(lambda: stages.cached("tree", _tree))
        tree = HClustTree(merge=tree_arrays["merge"],
                          height=tree_arrays["height"],
                          order=tree_arrays["order"])
        pool_assign = tree_arrays.get("pool_assign")
        pool_centroids = tree_arrays.get("pool_centroids")
        landmark_used = "landmark_k" in tree_arrays

    # ---- cuts -----------------------------------------------------------
    dynamic_colors: Dict[str, np.ndarray] = {}
    dynamic_labels: Dict[str, np.ndarray] = {}
    deep_split_info: List[Dict] = []
    with clock.stage("cuts"):
        cut_weights = None
        if pool_assign is None:
            cut_points, cut_min_size = embedding, config.min_cluster_size
        elif landmark_used:
            cut_points = pool_centroids
            cut_min_size = config.min_cluster_size
            cut_weights = np.bincount(
                pool_assign, minlength=pool_centroids.shape[0]
            ).astype(np.float64)
        else:
            avg_pool = max(N / pool_centroids.shape[0], 1.0)
            cut_points = pool_centroids
            cut_min_size = max(
                2, int(round(config.min_cluster_size / avg_pool))
            )

        def _cuts():
            out = {}
            for dsv in config.deep_split_values:
                cut_labels = cutree_hybrid(
                    tree, cut_points, deep_split=int(dsv),
                    min_cluster_size=cut_min_size,
                    pam_stage=config.pam_stage,
                    weights=cut_weights,
                )
                if pool_assign is not None:
                    cut_labels = cut_labels[pool_assign]
                out[f"ds{dsv}"] = cut_labels
            return out

        cut_arrays = _guard(lambda: stages.cached("cuts", _cuts))
        for dsv in config.deep_split_values:
            cut_labels = cut_arrays[f"ds{dsv}"]
            key = f"deepsplit: {dsv}"
            dynamic_labels[key] = cut_labels
            dynamic_colors[key] = labels_to_colors(cut_labels)
            deep_split_info.append({
                "deep_split": int(dsv),
                "n_clusters": int(
                    len(set(cut_labels[cut_labels > 0].tolist()))
                ),
            })

    # ---- silhouette (pooled estimator above threshold, exact below) -----
    sil_info = None
    if config.compat.return_silhouette:
        with clock.stage("silhouette"):
            from scconsensus_tpu_torch.ops.silhouette import (
                multi_cut_silhouette,
                pooled_multi_cut_silhouette,
            )

            labs = [
                np.where(dynamic_labels[f"deepsplit: {dsv}"] > 0,
                         dynamic_labels[f"deepsplit: {dsv}"], -1)
                for dsv in config.deep_split_values
            ]
            sil_info = ({"method": "pooled-estimator",
                         "pool_reused": pool_centroids is not None}
                        if N > config.approx_threshold
                        else {"method": "exact"})

            def _silhouette():
                if N > config.approx_threshold:
                    for info, (si, _per) in zip(
                        deep_split_info,
                        pooled_multi_cut_silhouette(
                            scores_d, labs,
                            n_centroids=config.silhouette_pool_centroids,
                            seed=config.random_seed,
                            centroids=pool_centroids,
                            assign=pool_assign,
                            sample=config.silhouette_sample,
                        ),
                    ):
                        info["silhouette"] = si
                        info["silhouette_method"] = "pooled-estimator"
                else:
                    for info, (si, _per) in zip(
                        deep_split_info,
                        multi_cut_silhouette(scores_d, labs),
                    ):
                        info["silhouette"] = si

            _guard(_silhouette)
    del scores_d

    # ---- nodg: streamed per-cell detected-gene counts -------------------
    with clock.stage("nodg"):
        def _nodg():
            acc = np.zeros(N, np.int64)
            for i in range(store.n_chunks):
                est = store.chunk_host_bytes(i)
                acct.charge(est, "chunk")
                try:
                    block = load(i, "nodg")
                    acc += np.bincount(
                        block.indices[block.data > 0], minlength=N
                    )
                finally:
                    acct.release(est, "chunk")
            return {"nodg": acc}

        nodg = _guard(lambda: stages.cached("nodg", _nodg))["nodg"]

    union_names = (
        np.asarray(gene_names)[union] if gene_names is not None
        else union.copy()
    )
    acct.sample_rss()
    metrics = {
        **timer.as_dict(),
        "device": str(dev),
        "stage_walls_s": dict(clock.walls),
        "union_size": int(union.size),
        "per_pair_de_counts": de_res.de_counts().tolist(),
        "n_genes": int(G),
        "n_cells": int(N),
        "tree": {"approx": bool(approx), "landmark": bool(landmark_used),
                 "landmark_k": (int(tree_arrays["landmark_k"])
                                if landmark_used else None)},
        "silhouette": sil_info,
        "stream": {
            # None when the embed resumed from the stage store
            "embed_regime": regime["embed"],
            "chunk_loads": {k: {"loads": v["loads"], "s": v["s"]}
                            for k, v in load.by_stage.items()},
            "ingest": dict(ingest),
            "de_resumed_chunks": int(state.de_resumed),
            "transfers_by_boundary": {
                k: dict(v) for k, v in acct.transfers_by_boundary.items()},
        },
    }
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
