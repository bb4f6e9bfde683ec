"""All-pairs differential-expression engine: every ``method`` of the
reference.

The torch form of ``scconsensus_tpu/de/engine.py`` for ``method`` ∈
{``wilcox``, ``wilcoxon``, ``edger``, ``bimod``, ``t``, ``roc``}: every
statistic for all K(K−1)/2 cluster pairs at once from per-cluster
structures.

  1. cluster filter (count > min_cluster_size, 'grey' dropped),
  2. per-cluster aggregates (``ops.gates``),
  3. per-pair gates from the aggregates (masks): Seurat's pct / mean /
     |logFC| battery on the fast path, the mean-expression gate and the
     difference of log-means on the slow paths,
  4. the test for every (pair, gene). Wilcoxon and roc: ``ranksum_body``
     driven by the window ladder (genes sorted by nonzero count run in
     buckets whose window is the next power of two of their nnz), with R's
     exact branch for pairs of small groups on the host; roc adds the AUC
     and power from U. edgeR: the NB engine of ``de.edger``. bimod and t:
     ``ops.seurat_tests`` from the aggregates of the post-subsampling
     groups,
  5. BH: per pair over the tested genes (fast path) or over every finite
     entry with n = G (slow paths, ``bh_reference_n``),
  6. the DE call and the top-N union.

The input is a dense (G, N) tensor or a ``scipy.sparse`` matrix, which
crosses as its CSR triplet (``io.sparsemat.DeviceCSR``) and is never
densified whole: its aggregates come from gene chunks gathered on the
device, and its window ladder sorts compacted windows that hold only each
gene's stored entries (``DeviceCSR.window_rows``), so the rank-sum work
scales with nnz rather than with N (``scconsensus_tpu/de/engine.py``
:799-807, :823-890, :923-938).

The (P, G) results stay on the matrix's device; the union fetches only the
(P, n_top) indices, and ``PairwiseDEResult.to_store`` brings them to the
host for the artifact store.

The reference's guard rails ride the ladder: each bucket enters at the
fault plan's ``wilcox_bucket`` site and runs under ``_LadderRecovery`` (a
resource fault halves the element budget and re-enters from the last
finished bucket; a transient or silent-corruption fault retries the
bucket); with an artifact store each finished bucket persists as a
``de_wilcox_<sha>`` block (``_WilcoxCkpt``, the reference's keys and
arrays), so a killed run resumes from its finished buckets. Under
``SCC_INTEGRITY`` each bucket's output passes the rank-sum conservation
check and one bucket per window rung is ghost-replayed against the
float64 oracle; BH passes the monotonicity check (``robust.integrity``,
with the ``wilcox_bucket_out`` and ``bh_logq`` corruption sites before
them). Under ``SCC_OBS_NUMERIC`` the test's ``log_p`` and BH's ``log_q``
pass the numeric sentinels (``obs.quality``). The ladder's occupancy
record (``PairwiseDEResult.ladder``) carries the reference's probe keys.

``streaming_wilcox_block`` is the out-of-core runner's seam: one host
CSR slab of a chunk store through the same ladder.

With a ``parallel.mesh.Mesh`` the rank-sum buckets (and full-width
chunks) shard their gene rows across it
(``parallel.sharded_de.sharded_allpairs_ranksum``, the reference's
:773-782, :949, :1140): the same scan body per shard, so the same log p;
the ladder's occupancy record says ``"kernel": "mesh-scan"``, the
checkpoint blocks carry the variant ``mesh`` and the mesh's shape, and a
resume of blocks written on a larger mesh stamps a ``cause: "resume"``
transition. The aggregates, gates, BH and the other tests run on the
matrix's device as without a mesh, as in the reference.

The engine keeps its one rank-sum form, the scan body, on both devices.
The reference takes the run-space form with its overflow redo on XLA:CPU
only (:768-772); ``ops.ranksum_allpairs.ranksum_body_runspace`` is its
port, parity API the engine does not call: the port's CPU is its test
device, the labels are the same either way, and the serial checkpoint
variant is ``scan``, as the reference's on the card. An unknown method
raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from scconsensus_tpu_torch.config import ReclusterConfig, env_flag
from scconsensus_tpu_torch.device import resolve_device
from scconsensus_tpu_torch.io.sparsemat import (
    DeviceCSR,
    csr_aggregates,
    expm1_sparse,
    is_sparse,
    mean_expm1,
    mean_value,
    row_chunks,
)
from scconsensus_tpu_torch.ops.gates import (
    compute_aggregates_cid,
    pair_gates_fast,
    pair_gates_slow,
)
from scconsensus_tpu_torch.ops.multipletests import (
    bh_adjust,
    bh_adjust_masked,
)
from scconsensus_tpu_torch.obs import quality as obs_quality
from scconsensus_tpu_torch.obs import residency
from scconsensus_tpu_torch.obs import trace as obs_trace
from scconsensus_tpu_torch.obs.cost import attach_cost
from scconsensus_tpu_torch.ops import ranksum_allpairs as _ranksum
from scconsensus_tpu_torch.ops.ranksum_allpairs import (
    chunk_genes_for_budget,
    ranksum_body,
)
from scconsensus_tpu_torch.ops.seurat_tests import (
    auc_from_u,
    bimod_lrt_pairs,
    welch_t_pairs,
)
from scconsensus_tpu_torch.ops.wilcoxon import (
    EXACT_N_LIMIT,
    wilcoxon_exact_host,
)
from scconsensus_tpu_torch.robust import faults
from scconsensus_tpu_torch.robust import integrity as robust_integrity
from scconsensus_tpu_torch.robust import record as robust_record
from scconsensus_tpu_torch.robust import retry as robust_retry
from scconsensus_tpu_torch.utils.timing import StageClock

__all__ = ["PairwiseDEResult", "pairwise_de", "encode_labels",
           "filter_clusters", "filter_cluster_names", "de_gene_union",
           "as_device_matrix", "streaming_wilcox_block"]


@dataclasses.dataclass
class PairwiseDEResult:
    """Dense all-pairs DE summary (P = #pairs, G = #genes). The (P, G)
    fields are tensors on the matrix's device."""

    cluster_names: List[str]
    pair_i: np.ndarray       # (P,) index into cluster_names
    pair_j: np.ndarray
    log_p: torch.Tensor      # (P, G); NaN where untested/degenerate
    log_q: torch.Tensor      # (P, G); NaN where not adjusted
    log_fc: torch.Tensor     # (P, G) natural-log fold change
    tested: torch.Tensor     # (P, G) bool: entered the statistical test
    de_mask: torch.Tensor    # (P, G) bool: final DE call
    pair_skipped: np.ndarray  # (P,) bool: skipped by group-size validation
    pct1: Optional[torch.Tensor] = None  # (P, G), fast path only
    pct2: Optional[torch.Tensor] = None
    u: Optional[torch.Tensor] = None     # (P, G) Mann-Whitney U, Wilcoxon
    # edgeR: "common_dispersion" (P,) and "tagwise_dispersion" (P, G)
    aux: Optional[Dict[str, torch.Tensor]] = None
    skip_reasons: Optional[List[str]] = None
    # Wilcoxon: the rank-sum route and its window ladder (see _run_wilcox)
    ladder: Optional[Dict] = None
    # (N,) each cell's code into the sorted str-cast input labels, dropped
    # clusters included (encode_labels); the quality section reads it
    cell_codes: Optional[np.ndarray] = None

    # what the artifact store keeps: the reference's keys
    # (scconsensus_tpu/de/engine.py:134-203); u, the ladder and the cell
    # codes are the port's own and are not stored
    _ARRAY_FIELDS = ("pair_i", "pair_j", "log_p", "log_q", "log_fc",
                     "tested", "de_mask", "pair_skipped")
    _OPT_ARRAY_FIELDS = ("pct1", "pct2")

    def de_counts(self) -> np.ndarray:
        """Per-pair DE gene counts (P ints to the host)."""
        with residency.boundary("funnel_counts"):
            return self.de_mask.sum(dim=1).cpu().numpy()

    def to_store(self) -> Tuple[Dict[str, np.ndarray], Dict]:
        """(arrays, meta) for the ``ArtifactStore``: the same array keys
        (``aux_<k>`` for each aux field) and meta as the reference's. Each
        device field crosses to the host here, once."""

        def host(v):
            return v.cpu().numpy() if isinstance(v, torch.Tensor) \
                else np.asarray(v)

        with residency.boundary("de_result_fetch"):
            arrays = {f: host(getattr(self, f))
                      for f in self._ARRAY_FIELDS}
            for f in self._OPT_ARRAY_FIELDS:
                v = getattr(self, f)
                if v is not None:
                    arrays[f] = host(v)
            for k, v in (self.aux or {}).items():
                arrays[f"aux_{k}"] = host(v)
        return arrays, {
            "cluster_names": self.cluster_names,
            "skip_reasons": self.skip_reasons or [],
        }

    @classmethod
    def from_store(cls, arrays: Dict[str, np.ndarray], meta: Dict,
                   device=None) -> "PairwiseDEResult":
        """Inverse of ``to_store``, with the (P, G) fields and aux on
        ``device`` (the CPU when None). Raises ValueError on an incomplete
        artifact (a missing meta sidecar or array), so callers recompute
        instead of resuming into a corrupt state."""
        if "cluster_names" not in meta:
            raise ValueError(
                "de artifact incomplete: missing cluster_names meta")
        missing = [f for f in cls._ARRAY_FIELDS if f not in arrays]
        if missing:
            raise ValueError(
                f"de artifact incomplete: missing arrays {missing}")
        dev = torch.device("cpu") if device is None else torch.device(device)

        def dev_t(v):
            return None if v is None else torch.from_numpy(
                np.ascontiguousarray(v)).to(dev)

        host = {"pair_i", "pair_j", "pair_skipped"}
        with residency.boundary("input_staging"):
            fields = {f: (arrays.get(f) if f in host
                          else dev_t(arrays.get(f)))
                      for f in cls._ARRAY_FIELDS + cls._OPT_ARRAY_FIELDS}
            aux = {k[len("aux_"):]: dev_t(v) for k, v in arrays.items()
                   if k.startswith("aux_")}
        return cls(
            cluster_names=list(meta["cluster_names"]), **fields,
            aux=aux or None,
            skip_reasons=list(meta.get("skip_reasons", [])) or None,
        )


def filter_cluster_names(names: np.ndarray, counts: np.ndarray,
                         min_cluster_size: int,
                         drop_grey: bool = True) -> List[str]:
    """The cluster-survival rule alone (count strictly greater than the
    floor, §2d-7; 'grey' substring dropped) over ``np.unique(...,
    return_counts=True)`` of the str-cast labels: shared by
    ``filter_clusters`` and the input-contract pre-flight."""
    keep = counts > min_cluster_size
    if drop_grey:
        keep &= np.char.find(names, "grey") == -1
    return [str(n) for n in names[keep]]


def encode_labels(labels: Sequence
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(sorted distinct names, each cell's code into them, counts) of the
    str-cast labels: one sort."""
    lab = np.asarray(labels).astype(str)
    names, codes, counts = np.unique(lab, return_inverse=True,
                                     return_counts=True)
    return names, codes.ravel(), counts


def filter_clusters(labels: Sequence, min_cluster_size: int,
                    drop_grey: bool = True, encoded=None,
                    ) -> Tuple[List[str], np.ndarray]:
    """Clusters with count > min_cluster_size (strictly greater, §2d-7),
    'grey' substring dropped; returns (sorted names, per-cell index into
    names, −1 for dropped cells). ``encoded``: the labels'
    :func:`encode_labels`, when the caller has it."""
    names, codes, counts = (encoded if encoded is not None
                            else encode_labels(labels))
    kept = filter_cluster_names(names, counts, min_cluster_size, drop_grey)
    index = {n: i for i, n in enumerate(kept)}
    remap = np.array([index.get(str(n), -1) for n in names], np.int32)
    return kept, remap[codes]


def _all_pairs(k: int) -> Tuple[np.ndarray, np.ndarray]:
    ii, jj = np.triu_indices(k, k=1)
    return ii.astype(np.int32), jj.astype(np.int32)


def _next_pow2(x: int) -> int:
    return 1 << (int(x) - 1).bit_length()


def _expand_rows(sub: torch.Tensor, ok_rows: np.ndarray, n_rows: int
                 ) -> torch.Tensor:
    """Scatter per-run-pair results back onto the full pair axis; rows of
    pairs skipped by group-size validation stay NaN (float) / False
    (bool)."""
    if ok_rows.size == n_rows:
        return sub
    fill = False if sub.dtype == torch.bool else float("nan")
    out = torch.full((n_rows,) + tuple(sub.shape[1:]), fill, dtype=sub.dtype,
                     device=sub.device)
    out[torch.as_tensor(ok_rows, device=sub.device)] = sub
    return out


def _cid_from_groups(cell_idx_of: List[np.ndarray], n_cells: int
                     ) -> np.ndarray:
    """Per-cell cluster index (−1 = excluded) from the per-cluster cell
    lists — the post-subsampling groups every test uses."""
    cid = np.full(n_cells, -1, np.int32)
    for k, ci in enumerate(cell_idx_of):
        cid[ci] = k
    return cid


def _window_floor(n_cells: int) -> int:
    """Window-ladder floor: 1024, rising with N (N/256, capped at 16k) so
    the sparse tail of the ladder does not shatter into tiny buckets."""
    return int(min(max(1024, _next_pow2(max(n_cells // 256, 1))), 16384))


def as_device_matrix(data, device: torch.device):
    """The (G, N) matrix on ``device``: a float32 tensor (a tensor already
    there is used as it is, a numpy array crosses once through the upload
    cache, ``utils.devcache``, so a second run over the same host array
    reuses its upload), or for ``scipy.sparse`` input (any format,
    canonicalized to CSR with duplicate entries summed) a ``DeviceCSR``
    holding its triplet.

    The upload runs at the fault plan's ``input_staging`` site under the
    retry policy: an allocation failure frees the caching allocator's
    blocks and uploads once more (the reference's evict-devcache retry;
    for numpy input the cache's own, which also drops its entries).
    """
    dev = torch.device(device)

    def _on_dev(d: torch.device) -> bool:
        return d.type == dev.type and dev.index in (None, d.index)

    if isinstance(data, torch.Tensor) and _on_dev(data.device):
        return data.to(dtype=torch.float32)
    if isinstance(data, DeviceCSR) and _on_dev(data.device):
        return data
    if not isinstance(data, (torch.Tensor, DeviceCSR, np.ndarray)) \
            and not is_sparse(data):
        raise NotImplementedError(
            f"input of type {type(data).__name__} is not supported (numpy "
            "arrays, tensors and scipy.sparse matrices)"
        )
    if isinstance(data, np.ndarray):
        # the reference's one upload a run (de/engine.py:1353-1355)
        from scconsensus_tpu_torch.utils.devcache import device_put_cached

        return device_put_cached(data, dev).to(dtype=torch.float32)

    def _upload():
        if isinstance(data, torch.Tensor):
            return data.to(device=dev, dtype=torch.float32)
        if isinstance(data, DeviceCSR):
            return data.to(dev)
        return DeviceCSR.from_scipy(data, dev)

    def _evict(_attempt):
        free_device_cache(dev)
        robust_record.note_degradation(
            "input_staging", "evict-devcache",
            "freed the caching allocator's blocks before re-upload",
        )

    with residency.boundary("input_staging"):
        return robust_retry.RetryPolicy(max_attempts=2).call(
            _upload, site="input_staging", degrade=_evict)


def free_device_cache(dev: torch.device) -> None:
    """Hand the caching allocator's unused blocks back to the card (the
    port's counterpart of the reference's devcache eviction)."""
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()


class _WilcoxCkpt:
    """Mid-stage checkpoint handle for the Wilcoxon window ladder.

    Each finished bucket persists its (log_p, u, ties) block into the
    run's ArtifactStore under a content-addressed stage name
    (``de_wilcox_<sha>``: gene ids, window and kernel variant), so a run
    killed inside ``de`` resumes from its finished buckets. The keys,
    arrays (``lp``, ``u``, ``ts``) and ``mesh_shape`` meta are the
    reference's (``scconsensus_tpu/de/engine.py:426-539``), so a
    half-finished store crosses between the packages wherever both run
    the same kernel variant. Each block is stamped with the run's mesh
    shape; blocks written on a larger mesh resume on a smaller one, and
    :meth:`note_transitions` stamps that crossing once per stored shape.
    The pipeline deletes the blocks once the covering ``de`` artifact
    lands. Gated by ``SCC_ROBUST_DE_CKPT``."""

    PREFIX = "de_wilcox_"

    def __init__(self, store, mesh=None):
        self.store = store
        self.mesh = mesh  # the run's mesh, stamped on each block
        self.resumed = 0
        self._found = None  # stage -> (arrays, meta) or None, on a resume
        # stored shapes larger than this run's -> the bytes adopted
        self._resumed_shapes: Dict[tuple, int] = {}

    def key(self, ids: np.ndarray, window: int, variant: str) -> str:
        import hashlib

        h = hashlib.sha256()
        h.update(np.ascontiguousarray(ids, np.int64).tobytes())
        h.update(f":{window}:{variant}".encode())
        return f"{self.PREFIX}{h.hexdigest()[:16]}"

    def load(self, key: str, device: torch.device):
        """(lp, u, ts) on ``device``, or None (absent, incomplete or
        quarantined: recompute either way)."""
        from scconsensus_tpu_torch.utils.artifacts import ArtifactCorrupt

        if self._found is None:
            # a resume reads and checks every stored block at once, in
            # parallel, rather than one hash at a time between buckets
            self._found = self.store.load_many(
                self.store.stages_with_prefix(self.PREFIX))
        if not self.store.has(key):
            return None
        got = self._found.pop(key, None)
        if got is None:
            # not read above, or failed its check: load() quarantines it
            try:
                got = self.store.load(key)
            except ArtifactCorrupt:
                return None
        arrays, meta = got
        if not all(k in arrays for k in ("lp", "u", "ts")):
            return None
        self.resumed += 1
        self._track_shape(meta)
        return tuple(torch.from_numpy(np.ascontiguousarray(arrays[k])).to(
            device) for k in ("lp", "u", "ts"))

    def _track_shape(self, meta) -> None:
        """Remember a resumed block written on a larger mesh than this
        run's (the crossing rule is ``robust.elastic``'s)."""
        from scconsensus_tpu_torch.parallel.mesh import mesh_device_ids
        from scconsensus_tpu_torch.robust.elastic import (
            resume_crossing_from_ids,
        )

        from_ids = resume_crossing_from_ids(meta, mesh_device_ids(self.mesh))
        if from_ids is None:
            return
        size = int(((meta or {}).get("_integrity") or {}).get("size") or 0)
        key = tuple(from_ids)
        self._resumed_shapes[key] = self._resumed_shapes.get(key, 0) + size

    def note_transitions(self) -> None:
        """One ``cause: "resume"`` mesh transition per larger stored shape
        the resumed blocks came from (with ``SCC_ELASTIC`` on)."""
        from scconsensus_tpu_torch.parallel.mesh import mesh_device_ids
        from scconsensus_tpu_torch.robust.elastic import elastic_enabled

        if not self._resumed_shapes or not elastic_enabled():
            return
        to_ids = mesh_device_ids(self.mesh)
        for from_t, nbytes in sorted(self._resumed_shapes.items()):
            robust_record.note_mesh_transition(
                stage="wilcox_test", from_devices=list(from_t),
                to_devices=to_ids, recovered_state_bytes=nbytes,
                cause="resume")

    def save(self, key: str, n_rows: int, out) -> None:
        """Persist one finished bucket (its real gene rows), stamped with
        the run's mesh shape. Uncompressed: float32 log p, U and ties
        barely shrink under zlib, which would cost the stored run seconds
        of host time for nothing."""
        from scconsensus_tpu_torch.parallel.mesh import mesh_shape_meta

        with residency.boundary("de_ckpt_fetch"):
            arrays = {k: o[:n_rows].cpu().numpy()
                      for k, o in zip(("lp", "u", "ts"), out)}
        self.store.save(key, arrays,
                        meta={"mesh_shape": mesh_shape_meta(self.mesh)},
                        compress=False)


class _LadderRecovery:
    """Loop-level typed recovery for the Wilcoxon window ladder
    (``scconsensus_tpu/de/engine.py:542-659``).

    Used as ``with recover:`` around one bucket. On an Exception escaping
    the bucket it classifies (``robust.retry``) and, when admissible,
    suppresses it and sets ``retry`` (the loop re-enters at the same
    gene offset, i.e. from the last finished bucket); a resource-class
    failure (an injected OOM or a real ``torch.cuda.OutOfMemoryError``)
    doubles ``budget_div``, halving every later block's element budget.
    Fatal errors, exhausted per-bucket attempts and an exhausted per-run
    budget re-raise; ``KeyboardInterrupt``/``SystemExit`` pass through.
    """

    MAX_BUCKET_ATTEMPTS = 4
    MAX_BUDGET_DIV = 64

    def __init__(self, site: str = "wilcox_bucket"):
        self.site = site
        self.budget_div = 1
        self.attempt = 0          # retries consumed by the current bucket
        self.backoff_total = 0.0
        self.retry = False
        self.err_class: Optional[str] = None
        self._policy = robust_retry.default_policy()

    def bucket_done(self) -> None:
        """Close out the finished bucket's retry bookkeeping (a recovered
        bucket records one aggregated entry)."""
        if self.attempt:
            robust_record.note_retry(
                self.site, self.err_class or "transient", self.attempt + 1,
                recovered=True, backoff_s=self.backoff_total,
            )
            if self.err_class == "silent_corruption":
                # the corrupted bucket recomputed clean: the recovery's
                # evidence on the integrity section
                robust_integrity.current().note_recompute()
                robust_integrity.current().reset_streak(self.site)
        self.attempt = 0
        self.backoff_total = 0.0

    def __enter__(self):
        self.retry = False
        return self

    def __exit__(self, et, ev, tb) -> bool:
        import time as _time

        from scconsensus_tpu_torch.obs import trace as obs_trace

        if et is None or not issubclass(et, Exception):
            return False
        err_class = robust_retry.classify_exception(ev)
        run = robust_record.current_run()
        if err_class == "device_lost":
            return False  # the stage-level guard owns a lost device
        if (err_class == "silent_corruption"
                and robust_integrity.should_evict(self.site)):
            return False  # repeated miscompute: the stage guard decides
        if (err_class == "fatal"
                or self.attempt >= self.MAX_BUCKET_ATTEMPTS
                or not run.budget_take()):
            if err_class != "fatal":
                robust_record.note_retry(
                    self.site, err_class, self.attempt + 1,
                    recovered=False, backoff_s=self.backoff_total,
                )
            return False
        self.attempt += 1
        self.err_class = err_class
        if (err_class == "resource"
                and self.budget_div < self.MAX_BUDGET_DIV):
            self.budget_div *= 2
            robust_record.note_degradation(
                self.site, "halve-chunk-budget",
                f"element budget /{self.budget_div} after "
                f"{et.__name__}; re-entering from the last completed "
                "bucket",
            )
        backoff = self._policy.backoff_s(self.site, self.attempt)
        self.backoff_total += backoff
        sp = obs_trace.current_span()
        if sp is not None:
            sp.metrics.counter("robust_retries").add(1)
        with obs_trace.span(
            "robust_retry", site=self.site, error_class=err_class,
            attempt=self.attempt, backoff_s=round(backoff, 4),
        ):
            _time.sleep(backoff)
        self.retry = True
        return True


def _wilcox_ckpt_for(store, mesh=None) -> Optional[_WilcoxCkpt]:
    """The ladder's checkpoint handle: a store present and the flag on."""
    from scconsensus_tpu_torch.config import env_flag

    if (store is not None and getattr(store, "enabled", False)
            and env_flag("SCC_ROBUST_DE_CKPT")):
        return _WilcoxCkpt(store, mesh=mesh)
    return None


def _run_wilcox(
    data,
    cell_idx_of: List[np.ndarray],
    pair_i: np.ndarray,
    pair_j: np.ndarray,
    ladder: Optional[Dict] = None,
    ckpt: Optional[_WilcoxCkpt] = None,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank-sum (log_p, u), each (P, G) on the matrix's device, through
    the window ladder (or full-width gene chunks when any value is
    negative). R's exact branch replaces the normal approximation on the
    host for pairs with both groups < 50 cells, at their tie-free genes.

    ``data``: a dense (G, N) tensor, whose ladder sorts full-N rows per
    bucket, or a ``DeviceCSR``, whose buckets sort compacted windows of
    each gene's stored entries (window sizes from the stored-entry counts;
    explicit zeros take a slot and stay inert).

    ``ladder``: an optional dict that receives the route
    ("dense-device", "csr-compacted" or the full-width "dense-chunked" /
    "csr-chunked") and the reference's occupancy-probe keys (``windowed``,
    ``input``, ``kernel``, ``n_genes``, ``n_cells``, ``n_clusters``,
    ``window_floor`` and one record per bucket: window, scan and sort
    widths, genes, rows run, real and padded elements, nnz range). The
    port runs each bucket on its own rows, so ``padded_rows`` is the
    bucket's gene count where the reference pads to a power of two.

    ``ckpt``: an optional :class:`_WilcoxCkpt`; each finished bucket
    persists, and a bucket found in the store is loaded instead of run.

    ``mesh``: an optional ``parallel.mesh.Mesh``; each bucket's (or
    chunk's) gene rows shard across it through
    ``sharded_allpairs_ranksum``, and full-width chunks are at least
    8 genes a shard wide, as the reference plans them.
    """
    G, N = data.shape
    dev = data.device
    K = len(cell_idx_of)
    n_of = np.array([ci.size for ci in cell_idx_of], np.int32)
    with residency.boundary("input_staging"):
        cid = torch.as_tensor(_cid_from_groups(cell_idx_of, N), device=dev)
        tn = torch.as_tensor(n_of, device=dev)
        tpi = torch.as_tensor(pair_i, dtype=torch.int64, device=dev)
        tpj = torch.as_tensor(pair_j, dtype=torch.int64, device=dev)
    n1_pairs, n2_pairs = n_of[pair_i], n_of[pair_j]
    gc = min(chunk_genes_for_budget(N, K), _next_pow2(G))
    if mesh is not None:
        from scconsensus_tpu_torch.parallel.sharded_de import (
            sharded_allpairs_ranksum,
        )

        gc = max(gc, mesh.size * 8)
    # live shard ids for the corruption rules' device pins: a rule
    # modelling one bad device stops firing once the supervisor evicts it
    live_dev_ids = list(mesh.ids) if mesh is not None else [0]

    def _rank_sums(vals, kcid, window=0, span=None):
        if mesh is not None:
            return sharded_allpairs_ranksum(vals, kcid, tn, tpi, tpj, K,
                                            mesh=mesh, window=window)
        # the chunk body's FLOPs and bytes on the bucket span (SCC_OBS_COST)
        attach_cost(span, ranksum_body, vals, kcid, tn, tpi, tpj, K,
                    window=window)
        return ranksum_body(vals, kcid, tn, tpi, tpj, K, window=window)

    # O(G) ints to plan the ladder; the decomposition needs zeros as the
    # minimum, so any negative value sends every gene to full width
    compact = isinstance(data, DeviceCSR)
    with obs_trace.span("ladder_plan"), \
            residency.boundary("wilcox_ladder_plan"):
        if compact:
            windowed = not bool((data.values < 0).any())
            nnz_g = data.stored_per_row()
        else:
            windowed = not bool((data < 0).any())
            nnz_g = (data > 0).sum(dim=1).cpu().numpy()
    if windowed:
        route = "csr-compacted" if compact else "dense-device"
    else:
        route = "csr-chunked" if compact else "dense-chunked"
    buckets: List[Dict] = []
    # SCC_WILCOX_PROBE: synced per-bucket walls, a sort-only timing and the
    # rows' value-run counts (a diagnosis: it serializes the ladder)
    probe_on = bool(env_flag("SCC_WILCOX_PROBE"))
    t_ladder = time.perf_counter()
    if ladder is not None:
        ladder.update(
            route=route, windowed=bool(windowed),
            input=("sparse-chunked" if compact and not windowed
                   else "csr-compacted" if compact else "dense-device"),
            kernel="mesh-scan" if mesh is not None else "scan",
            n_genes=int(G), n_cells=int(N),
            n_clusters=int(K), probe_synced=probe_on, buckets=buckets)

    def _audit(out, unit_key, unit, vals, cids, n_rows, full_rows):
        """The integrity tier on one bucket's fresh output: the injected
        corruption site, the conservation check and, on the seeded
        sample unit, the float64 ghost replay. Inside the recovery
        context, so a detection recomputes the bucket."""
        out = faults.corrupt_value("wilcox_bucket_out", out,
                                   live_devices=live_dev_ids)
        if robust_integrity.enabled():
            robust_integrity.check_wilcox_bucket(
                "wilcox_bucket", out[0], out[1], out[2],
                n1_pairs, n2_pairs)
            if robust_integrity.current().want_replay("wilcox", unit_key):
                robust_integrity.replay_wilcox_window(
                    "wilcox_bucket", unit, vals, cids, n_of, pair_i,
                    pair_j, out[0], out[1], n_rows, full_rows=full_rows)
        return out

    parts = []  # (gene ids, (log_p, u, tie_sum)), each block (Gb, P)
    if windowed:
        floor = _window_floor(N)
        if ladder is not None:
            ladder["window_floor"] = floor
        order = np.argsort(nnz_g, kind="stable").astype(np.int64)
        nnz_sorted = nnz_g[order]
        # typed recovery re-enters the loop at the last finished bucket
        recover = _LadderRecovery()
        g0 = 0
        while g0 < G:
            elem_budget = max(
                _ranksum.ALLPAIRS_ELEM_BUDGET // recover.budget_div, 1 << 12)
            w = int(min(_next_pow2(max(int(nnz_sorted[g0]), floor)),
                        _next_pow2(N)))
            # compacted windows are w wide (even when w > N, from the pow-2
            # rounding) and sort only the window; dense rows sort full N
            scan_w = w if compact else min(w, N)
            sort_w = w if compact else N
            # block size respects both working sets: the (gcb, K, scan_w)
            # kernel tensors and the (gcb, sort_w) sort buffers
            gcb = max(8, min(elem_budget // max(scan_w * K, 1),
                             (elem_budget // 2) // max(sort_w, 1)))
            gcb = min(1 << (int(gcb).bit_length() - 1), _next_pow2(G))
            g1 = g0
            while (g1 < G and g1 - g0 < gcb
                   and (w >= N or nnz_sorted[g1] <= w)):
                g1 += 1
            ids = order[g0:g1]
            weff = w if compact else (w if w < N else 0)
            ck_key = None
            if ckpt is not None:
                # content-addressed: a re-entry with other block bounds
                # can only hit blocks holding exactly these genes
                ck_key = ckpt.key(ids, weff,
                                  "mesh" if mesh is not None else "scan")
                out = ckpt.load(ck_key, dev)
                if out is not None:
                    parts.append((ids, out))
                    g0 = g1
                    recover.bucket_done()
                    continue
            t_bucket = time.perf_counter()
            with recover, obs_trace.span(
                    "wilcox_bucket", window=int(w),
                    n_genes=int(ids.size)) as bspan:
                faults.fault_point("wilcox_bucket")
                if compact:
                    # compacted input always runs zero-block mode
                    vals, kcid = data.window_rows(ids, w, cid)
                else:
                    with residency.boundary("wilcox_ladder_plan"):
                        t_ids = torch.as_tensor(ids, device=dev)
                    vals = data.index_select(0, t_ids)
                    kcid = cid
                out = _audit(
                    _rank_sums(vals, kcid, window=weff, span=bspan),
                    int(w), f"window:{int(w)}", vals, kcid, int(ids.size),
                    full_rows=not compact)
                real = int(nnz_sorted[g0:g1].sum())
                padded = int(ids.size) * int(scan_w)
                brec = {
                    "window": w, "scan_width": int(scan_w),
                    "sort_width": int(sort_w), "n_genes": int(ids.size),
                    "padded_rows": int(ids.size), "real_elems": real,
                    "padded_elems": padded,
                    "pad_ratio": round(padded / max(real, 1), 3),
                    "nnz_min": int(nnz_sorted[g0]),
                    "nnz_max": int(nnz_sorted[g1 - 1]),
                    "overflow_genes": 0,
                }
                if probe_on:
                    _probe_bucket(brec, out, vals, weff, scan_w, t_bucket)
                buckets.append(brec)
            if recover.retry:
                continue  # re-enter at g0 with the (maybe halved) budget
            if ckpt is not None:
                try:
                    ckpt.save(ck_key, int(ids.size), out)
                except Exception as e:
                    # durability must not become a fatal failure mode: a
                    # full disk skips this block's checkpoint
                    robust_record.note_degradation(
                        "wilcox_bucket", "ckpt-skip",
                        f"bucket checkpoint write failed ({e!r}); "
                        "continuing without mid-stage durability for "
                        "this block",
                    )
            parts.append((ids, out))
            g0 = g1
            recover.bucket_done()
        if ckpt is not None and ckpt.resumed:
            robust_record.note_resume_point(
                "wilcox_test", "bucket", ckpt.resumed, len(parts))
            # blocks written on a larger mesh: stamp the crossing
            ckpt.note_transitions()
        if ladder is not None and probe_on:
            obs_trace.device_drain()
            ladder["ladder_wall_s"] = round(
                time.perf_counter() - t_ladder, 4)
    else:
        # any negative value: full-width gene chunks (a CSR densifies one
        # chunk at a time on the device)
        for g0, g1, chunk in row_chunks(data, gc):
            out = _audit(_rank_sums(chunk, cid, span=None),
                         "chunk", f"chunk:{int(g0)}", chunk, cid,
                         int(g1 - g0), full_rows=True)
            parts.append((np.arange(g0, g1), out))
    with residency.boundary("wilcox_ladder_plan"):
        inv = torch.as_tensor(
            np.argsort(np.concatenate([ids for ids, _ in parts]),
                       kind="stable"),
            device=dev)

    def _gather(f: int) -> torch.Tensor:
        """Blocks in ladder order → (P, G) in gene order."""
        return torch.cat([o[f] for _, o in parts], dim=0)[inv].T

    log_p, u_stat = _gather(0), _gather(1)
    small = np.nonzero((n_of[pair_i] < EXACT_N_LIMIT)
                       & (n_of[pair_j] < EXACT_N_LIMIT))[0]
    if small.size:
        # R's exact branch runs on the host by design: fetch only the
        # small pairs' rows (u and the tie indicator)
        with obs_trace.span("exact_small_pairs", n_pairs=int(small.size)):
            with residency.boundary("exact_small_pairs"):
                rows = torch.as_tensor(small, device=dev)
                u_small = u_stat[rows].cpu().numpy()
                tie_small = _gather(2)[rows].cpu().numpy()
                lp_small = log_p[rows].cpu().numpy()
            for r, p in enumerate(small):
                tiefree = tie_small[r] == 0
                if tiefree.any():
                    pe = wilcoxon_exact_host(
                        u_small[r][tiefree],
                        int(n_of[pair_i[p]]), int(n_of[pair_j[p]]),
                    )
                    lp_small[r, np.nonzero(tiefree)[0]] = np.log(
                        pe).astype(np.float32)
            with residency.boundary("exact_small_pairs"):
                log_p[rows] = torch.from_numpy(lp_small).to(dev)
    return log_p, u_stat


def _probe_bucket(brec: Dict, out, vals: torch.Tensor, window: int,
                  scan_w: int, t_bucket: float) -> None:
    """``SCC_WILCOX_PROBE``'s diagnosis of one finished bucket, onto its
    record: the synced bucket wall, the sort-only pass over the same rows
    (warmed once untimed first, so no first-call cost lands in it) and
    the rows' value-run counts (distinct values in each sorted row's scan
    window), fetched under ``obs_internal`` as measurement overhead."""
    obs_trace.device_drain()
    brec["wall_s"] = round(time.perf_counter() - t_bucket, 4)
    _ranksum.sort_probe(vals, window)
    obs_trace.device_drain()
    t_s = time.perf_counter()
    sv = _ranksum.sort_probe(vals, window).values
    obs_trace.device_drain()
    brec["sort_s"] = round(time.perf_counter() - t_s, 4)
    sv = sv[:, :scan_w]
    runs = (sv[:, 1:] != sv[:, :-1]).sum(dim=1) + 1
    with residency.boundary("obs_internal"):
        nr = runs.cpu().numpy()
    if nr.size:
        brec["tied_runs_p50"] = int(np.median(nr))
        brec["tied_runs_max"] = int(nr.max())


def streaming_wilcox_block(
    block,
    cell_idx_of: List[np.ndarray],
    pair_i: np.ndarray,
    pair_j: np.ndarray,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank-sum log p and U for one disk chunk's gene rows: the
    out-of-core runner's per-shard entry
    (``scconsensus_tpu/de/engine.py:1225-1254``).

    ``block`` is a host (Gb, N) scipy CSR slab holding every cell of a
    gene window (what a ``ChunkedCSRStore`` chunk is). It crosses once as
    a ``DeviceCSR`` (its int64 column indices narrowed to int32 once per
    slab, at the declared ``input_staging`` boundary) and runs the same
    window ladder as the in-memory engine (``_run_wilcox``): compacted
    windows, R's exact branch for small pairs, the same per-gene outputs,
    since rank tests are per gene. Returns device (P, Gb) log p and U;
    the caller owns the one fetch and the durable per-chunk store."""
    dev = resolve_device(device)
    with residency.boundary("input_staging"):
        slab = DeviceCSR.from_scipy(block, dev)
        if dev.type == "cuda":
            residency.note_transfer(
                "h2d", slab.values.numel() * 4 + slab.indices.numel() * 4
                + slab.indptr.numel() * 8)
    return _run_wilcox(slab, cell_idx_of, pair_i, pair_j)


_METHODS = ("wilcox", "wilcoxon", "edger", "bimod", "t", "roc")


def pairwise_de(
    data,
    labels: Sequence,
    config: ReclusterConfig,
    device=None,
    clock: Optional[StageClock] = None,
    store=None,
    mesh=None,
) -> PairwiseDEResult:
    """Run the all-pairs DE test of ``config.method``: "wilcox" (the fast
    path), "wilcoxon" (the slow-path Wilcoxon), "edger", or the fast-path
    Seurat tests "bimod", "t" and "roc".

    data: (G, N) log-normalized expression, a numpy array, a tensor (kept
    where it is when it already lies on ``device``) or a ``scipy.sparse``
    matrix (never densified whole); labels: per-cell cluster names. Runs
    on ``cuda`` unless ``device="cpu"``. ``store``: an optional
    ``ArtifactStore``; with one enabled (and ``SCC_ROBUST_DE_CKPT`` on)
    the Wilcoxon ladder persists each finished bucket, so a run killed
    inside DE resumes from its finished buckets. ``mesh``: an optional
    ``parallel.mesh.Mesh`` across which the rank-sum tests (wilcox,
    wilcoxon, roc) shard their gene rows."""
    dev = resolve_device(device)
    method = config.method.lower()
    if method not in _METHODS:
        raise NotImplementedError(
            f"DE method {config.method!r} is not supported "
            f"({', '.join(_METHODS)})"
        )
    fast = method in ("wilcox", "bimod", "t", "roc")
    if mesh is not None:
        from scconsensus_tpu_torch.parallel.mesh import require_mesh

        mesh = require_mesh(mesh)
    clock = clock or StageClock(dev)
    data = as_device_matrix(data, dev)
    G, N = data.shape

    with clock.stage("cluster_filter"):
        encoded = encode_labels(labels)
        names, cell_idx = filter_clusters(
            labels, config.min_cluster_size, config.drop_grey,
            encoded=encoded,
        )
        K = len(names)
        if K < 2:
            raise ValueError(
                f"need >= 2 clusters above min_cluster_size="
                f"{config.min_cluster_size}, got {K}"
            )
        cell_idx_of = [np.nonzero(cell_idx == k)[0].astype(np.int32)
                       for k in range(K)]
        subsampled = False
        if config.max_cells_per_ident is not None:
            rng = np.random.default_rng(config.random_seed)
            cap = config.max_cells_per_ident
            subsampled = any(ci.size > cap for ci in cell_idx_of)
            cell_idx_of = [
                rng.choice(ci, size=cap, replace=False)
                if ci.size > cap else ci
                for ci in cell_idx_of
            ]
        pair_i, pair_j = _all_pairs(K)
        P = int(pair_i.size)
        # Group-size validation: pairs with a group below min_cells_group
        # are skipped with a recorded reason (the reference hard-errors,
        # R/reclusterDEConsensusFast.R:201-226).
        n_of = np.array([ci.size for ci in cell_idx_of], np.int32)
        pair_ok = (n_of[pair_i] >= config.min_cells_group) & (
            n_of[pair_j] >= config.min_cells_group
        )
        skip_reasons = [
            f"{names[i]} vs {names[j]}: group sizes ({n_of[i]}, {n_of[j]}) "
            f"below min_cells_group={config.min_cells_group}"
            for i, j in zip(pair_i[~pair_ok], pair_j[~pair_ok])
        ]
        if not pair_ok.any():
            raise ValueError(
                "every cluster pair has a group below "
                f"min_cells_group={config.min_cells_group}; nothing to test"
            )

    def aggregates(cid: np.ndarray):
        with residency.boundary("input_staging"):
            t_cid = torch.as_tensor(cid, device=dev)
        if isinstance(data, DeviceCSR):
            # gene chunks gathered from the triplet; detected = stored ≠ 0
            return csr_aggregates(data, t_cid, K)
        return compute_aggregates_cid(data, t_cid, K)

    with clock.stage("aggregates"):
        agg = aggregates(cell_idx)

    with residency.boundary("input_staging"):
        pi = torch.as_tensor(pair_i, dtype=torch.int64, device=dev)
        pj = torch.as_tensor(pair_j, dtype=torch.int64, device=dev)
        ok = torch.as_tensor(pair_ok, device=dev)
    pct1 = pct2 = u = aux = mean_gate = ladder = None
    if method == "edger":
        from scconsensus_tpu_torch.de.edger import run_edger_pairs

        # The reference hands the log-normalized matrix to DGEList as
        # counts (R/reclusterDEConsensus.R:133); compat keeps that literal
        # arithmetic, fixed mode tests on expm1(data).
        if config.compat.edger_log_counts:
            counts, gate_mean = data, mean_expm1(data)
        else:
            counts = expm1_sparse(data)
            gate_mean = mean_value(counts)
        ok_rows = np.nonzero(pair_ok)[0]
        with clock.stage("edger_nb"):
            nb = run_edger_pairs(counts, cell_idx_of, pair_i[pair_ok],
                                 pair_j[pair_ok], G, seed=config.random_seed,
                                 clock=clock)
        del counts
        with clock.stage("gates"):
            mean_gate, _ = pair_gates_slow(
                agg, pi, pj,
                mean_exprs_thrs=config.mean_scaling_factor * gate_mean,
                mixed_spaces=config.compat.mean_gate_mixed_spaces,
            )
        log_p = _expand_rows(nb.log_p, ok_rows, P)
        log_fc = _expand_rows(nb.log_fc, ok_rows, P)
        if obs_quality.enabled():
            # rows of group-size-skipped pairs are legitimate NaN
            obs_quality.check_array(
                "nb_log_p", log_p, kinds=("nan",),
                expected_nan=int(P - ok_rows.size) * G, where="edger_nb")
            obs_quality.check_array("nb_log_fc", log_fc, kinds=("inf",),
                                    where="edger_nb")
        tested = ok[:, None].expand(P, G).contiguous()
        aux = {
            "common_dispersion": _expand_rows(nb.common_disp, ok_rows, P),
            "tagwise_dispersion": _expand_rows(nb.tagwise_disp, ok_rows, P),
        }
    else:
        with clock.stage("gates"):
            if method == "wilcoxon":
                mean_gate, log_fc = pair_gates_slow(
                    agg, pi, pj,
                    mean_exprs_thrs=(config.mean_scaling_factor
                                     * mean_expm1(data)),
                    mixed_spaces=config.compat.mean_gate_mixed_spaces,
                )
                tested = ok[:, None].expand(P, G).contiguous()
            else:
                gate, log_fc, pct1, pct2 = pair_gates_fast(
                    agg, pi, pj,
                    min_pct=config.min_pct,
                    min_diff_pct=config.min_diff_pct,
                    log_fc_thrs=config.log_fc_thrs,
                    mean_exprs_thrs=config.mean_exprs_thrs,
                    pseudocount=config.pseudocount,
                    only_pos=config.only_pos,
                )
                tested = gate & ok[:, None]
                # per-pair survivors of the full gate battery, as the
                # reference's aux carries them (de/engine.py:1558-1561)
                aux = {"funnel_gate_full":
                       gate.sum(dim=1).to(torch.int32)}
        test_stage = ("wilcox_test" if method in ("wilcox", "wilcoxon")
                      else f"{method}_test")
        if method in ("bimod", "t"):
            # the moment tests run on the post-subsampling groups; the
            # gates above took the full clusters (de/engine.py:1418-1448)
            test_agg = agg
            if subsampled:
                with clock.stage("aggregates"):
                    test_agg = aggregates(_cid_from_groups(cell_idx_of, N))
            with clock.stage(test_stage):
                log_p = (bimod_lrt_pairs if method == "bimod"
                         else welch_t_pairs)(test_agg, pi, pj)
            del test_agg
        else:
            with clock.stage(test_stage):
                ladder = {}
                log_p, u = _run_wilcox(data, cell_idx_of, pair_i, pair_j,
                                       ladder=ladder,
                                       ckpt=_wilcox_ckpt_for(store, mesh),
                                       mesh=mesh)
                if method == "roc":
                    # AUC and power from U over the post-subsampling
                    # groups; significance stays the rank-sum p
                    n1 = torch.as_tensor(n_of[pair_i].astype(np.float32),
                                         device=dev)[:, None]
                    n2 = torch.as_tensor(n_of[pair_j].astype(np.float32),
                                         device=dev)[:, None]
                    auc, power = auc_from_u(u, n1, n2)
                    aux = {"auc": auc, "power": power, **aux}
        # untested entries (skipped pairs on the slow path) surface as NaN
        # and stay out of BH and the call
        log_p = torch.where(tested, log_p,
                            torch.full_like(log_p, float("nan")))
        if obs_quality.enabled():
            # the legitimate NaN budget: untested entries, plus tested
            # entries whose pooled variance is ~0 (all-zero or constant
            # genes), which NaN the rank test and Welch t by contract
            npool = torch.clamp(agg.counts[pi] + agg.counts[pj],
                                min=1.0)[:, None]
            pmean = (agg.sum_log[:, pi].T + agg.sum_log[:, pj].T) / npool
            pvar = ((agg.sum_sq[:, pi].T + agg.sum_sq[:, pj].T) / npool
                    - pmean * pmean)
            degen = pvar <= 1e-4 * torch.clamp(pmean * pmean, min=1e-6)
            obs_quality.check_array(
                "log_p", log_p, kinds=("nan",),
                expected_nan=log_p.numel() - (tested & ~degen).sum(),
                where=test_stage)

    with clock.stage("bh_adjust"):
        if fast:
            log_q = bh_adjust_masked(log_p, tested)
        else:
            # slow semantics (§2d-4): BH over every finite entry, n = G
            log_q = bh_adjust(
                log_p, n=float(G) if config.compat.bh_reference_n else None)
        log_q = faults.corrupt_value("bh_logq", log_q)
        if robust_integrity.enabled():
            # BH monotonicity (q >= p, q <= 1) at the stage boundary: an
            # enforce-mode violation recomputes the DE stage
            robust_integrity.check_bh("bh_adjust", log_p, log_q)
        if obs_quality.enabled():
            # BH leaves non-finite p out, so the legitimate NaN budget is
            # everything outside tested-and-finite
            obs_quality.check_array(
                "log_q", log_q, kinds=("nan",),
                expected_nan=log_q.numel() - (
                    tested & torch.isfinite(log_p)).sum(),
                where="bh_adjust")
    with clock.stage("de_call"):
        log_thr = float(np.log(np.float32(config.q_val_thrs)))
        if fast:
            de = tested & (log_q < log_thr)
        elif method == "edger" and config.compat.edger_drop_logfc:
            # §2d-1: the reference's criterion reads a scalar-NA logFC, so
            # no gene is ever selected: an all-false mask
            de = torch.zeros((P, G), dtype=torch.bool, device=dev)
        else:
            de = ((log_q < log_thr)
                  & (torch.abs(log_fc) > config.log_fc_thrs) & mean_gate)
        de = de & ~torch.isnan(log_q)
    return PairwiseDEResult(
        cluster_names=names, pair_i=pair_i, pair_j=pair_j,
        log_p=log_p, log_q=log_q, log_fc=log_fc, tested=tested,
        de_mask=de, pair_skipped=~pair_ok, pct1=pct1, pct2=pct2, u=u,
        aux=aux, skip_reasons=skip_reasons or None, ladder=ladder,
        cell_codes=encoded[1],
    )


def de_gene_union(result: PairwiseDEResult, n_top: int = 30) -> np.ndarray:
    """Top-``n_top`` DE genes per pair by |logFC|, unioned
    (R/reclusterDEConsensus.R:209-227; fast path :386-392). The per-pair
    top-k runs on the device and only the (P, n_top) indices cross.
    Returns sorted unique gene indices."""
    masked = torch.where(result.de_mask, torch.abs(result.log_fc),
                         torch.full_like(result.log_fc, -float("inf")))
    k = min(n_top, masked.shape[1])
    vals, idx = torch.topk(masked, k, dim=1)
    with residency.boundary("de_union_topk"):
        vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
    return np.unique(idx[vals > -np.inf]).astype(np.int64)
