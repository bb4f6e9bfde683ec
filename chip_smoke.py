#!/usr/bin/env python3
"""Drive the PyTorch/H100 port of scconsensus_tpu on one CUDA card.

Run from the repository root with ``python3 chip_smoke.py``. It needs one
card and no network, builds everything it runs from the sources in the
checkout, and exits non-zero on the first phase that fails:

  1. environment: torch / CUDA versions, the card's name and power limit;
  2. build: the CUDA kernel (nvcc, sm_90a) and the native Ward library,
     both compiles started together;
  3. kernel: ``distance_cluster_sums`` against its plain PyTorch version
     at six shapes (flagship-like, ragged, skinny, wide, and four nested
     cuts at the 26k path's geometry and at the multi-sample scenario's
     100,000 cells), with times, bound, the run sums a row writes
     against N·C, and a bitwise re-run check;
  4. slice, card against CPU: the dense fast-Wilcoxon ``refine()`` at
     2,000 cells × 800 genes × 4 clusters on ``cuda`` and on the CPU;
  5. edgeR, card against CPU: ``recluster_de_consensus(method="edgeR")``
     at the headline's thresholds, 2,000 × 800 × 4, on ``cuda`` and on the
     CPU with the same PCA projection;
  6. the 26k data: 26,000 cells × 15,000 genes × 22 planted clusters,
     drawn once on the card and shared by phases 7 and 8;
  7. Wilcoxon at full size: ``recluster_de_consensus_fast``, with the
     kernel's launch count reset just before and read just after;
  8. the edgeR headline at full size: the reference bench's headline call
     ``recluster_de_consensus(method="edgeR", q_val_thrs=0.01,
     fc_thrs=2.0, mean_scaling_factor=2.0)``, its wall, stage walls (the
     ``edger_*`` sub-stages among them), peak device memory, union,
     common-dispersion quantiles and the kernel's launch count, then the
     kernel at this path's own inputs;
  9. the scale branches, card against CPU, at 2,000 × 800 × 4:
     ``recluster_de_consensus_fast`` past ``approx_threshold`` in the legacy
     pool, landmark (with ``landmark_verify``) and kNN branches, and with
     ``distance="pearson"`` (the exact tree);
 10. Tabula Muris 100k: 100,000 cells × 12,000 genes × 40 planted clusters
     drawn on the card (the 26k data freed first), refined with
     ``approx_threshold=50_000`` as the reference bench runs it: the pool
     branch and the pooled silhouette, which launches no kernel; the
     ``quality`` stage under 2 % of the wall;
 11. the 1M landmark tree: the reference bench's 1,000,000 × 15 planted
     embedding, ``landmark_ward_linkage``, the weighted cut propagated to
     the cells, and the silhouette of a seeded 50,000-cell sample through
     the kernel, then the kernel at that sample's inputs;
 12. sparse input at 2k, card against CPU: the phase 4 data as CSR, saved
     with ``scipy.sparse.save_npz`` and read back through the port's
     ``load_npz``; the fast Wilcoxon and edgeR (both ``edger_log_counts``
     modes) card against CPU, and on the card against the dense matrix;
 13. the 26k data of phase 6 as a host CSR: the fast Wilcoxon and the
     edgeR headline from it, each held against phases 7 and 8 (unions, DE
     masks, cuts, silhouettes), with the kernel's launches, and the CSR
     aggregates computed twice to the same bits;
 14. the 1M sparse full pipeline (``tools/run_sparse_1m.py``'s
     configuration): 1,000,000 cells × 3,000 genes × 16 planted clusters
     drawn on the card as CSR, two noisy labelings merged by the
     contingency grammar, ``recluster_de_consensus_fast(csr, consensus,
     q_val_thrs=0.05, approx_threshold=50_000)``: the compacted window
     ladder, the landmark tree and the pooled silhouette, with peak device
     memory held below the dense matrix's size and the ``quality`` stage
     under 2 % of the wall;
 15. the Seurat tests at 2k, card against CPU: bimod, t and roc on the
     phase 4 data, dense and as CSR through ``load_npz``, and bimod and t
     with ``max_cells_per_ident=200``: the checks of phase 4, log p within
     the CPU tests' tolerance with the entries that change class on one
     device only counted, roc's AUC and power within 1e-6;
 16. bimod, t and roc at the 26k flagship (phase 6's data): walls, stage
     walls, union, DE calls, −inf count, peak memory and launches; bimod
     and t held against the port's CPU functions on the same aggregates
     (every pair for bimod, every 8th for t), roc's union, DE mask and
     log p against phase 7's Wilcoxon run, which must be identical;
 17. the 26k fast Wilcoxon with ``artifact_dir``: the 12 files and their
     bytes, the store's share of the wall, a resume that computes no DE,
     embed, tree or cut and gives the same bits, a corrupt ``de.npz``
     quarantined and recomputed alone, a changed ``q_val_thrs`` refused;
 18. the input contract on the 26k matrix: ``preflight``'s time, then a
     NaN in the dense matrix, an Inf among a CSR's stored values and NaN
     float labels, each refused by ``refine`` with the reference's check
     name before any stage runs;
 19. serving at the 26k flagship: ``export_consensus_model`` from phase
     7's result (its wall, the artifact's bytes, the fingerprint), then
     the reference bench's ``atlas_query`` stream (300 requests of 64
     cells, 292 sampled from the 26k matrix and 8 foreign, from 4 client
     threads) through ``ConsensusServer`` with the default ``ServeConfig``:
     every request accounted for, the 292 ``ok`` with no degraded
     response and no breaker trip, the 8 quarantined with ledger rows,
     each replayed cell on its calibrated landmark's label and on
     ``classify_host``'s within the reference's tie band; then three
     injected allocation failures trip the breaker and a probe closes it,
     a real allocation past the card's memory classifies ``resource``, a
     corrupt model is refused (in place by the readonly store,
     quarantined by the default one), and the reference's overhead guard
     holds guarded over classify wall below 1.02 on the card; latencies,
     throughput, batches, the classify split and peak memory printed;
     then (phase 21 f) the stream again under ``SCC_INTEGRITY=audit``
     with 0 replay mismatches, and a ``serve_classify`` corruption the
     replay catches;
 20. the guard rails at 2k, card against CPU, fast Wilcoxon and edgeR:
     the ``quality`` sections agree (funnel counts exactly, ARIs within
     1e-12, silhouettes within 1e-4); under ``SCC_INTEGRITY=audit`` both
     devices run the same checks and ghost replays with 0 mismatches;
     under ``enforce`` a ``wilcox_bucket_out`` corruption (edgeR: a
     ``bh_logq`` one, its DE having no rank-sum ladder) is detected and
     recomputed to the unfaulted run's bits;
 21. the guarded 26k flagship (phase 6's data, fast Wilcoxon), every run
     held to phase 7's bits with one kernel launch: (a) ``audit`` with
     ``SCC_OBS_NUMERIC=1``, best of 2, the integrity and quality layers
     each under 2 % of the wall with every check passed, and each run's
     ``quality`` stage too; (b) a
     ``stage:embed`` OOM and a ``stage:tree`` transient fault, both
     recovered; (c) ``enforce`` with a ``wilcox_bucket_out`` and a
     ``bh_logq`` corruption, both detected and recomputed; (d) a child
     process (started with the phase, beside (a)–(c)) killed at
     ``wilcox_bucket`` after half the ladder's buckets,
     resumed here from the finished ones (the fault point's hits count
     the rest), its blocks gone once ``de`` saves and
     ``robust_state.json`` at 0; (e) the robustness layer under 2 % of
     that stored run's wall;
 22. the out-of-core ``streaming_refine`` at the soak worker's shape
     (4,000 × 160 × 4) and the reference's test shape (1,200 × 96 × 3),
     window 32: card against CPU with the same projection (unions, DE
     masks, nodg identical, log p within the CPU tests' 1e-5/1e-4, ARI =
     1, the kernel launched); the soak worker in seven child processes
     through the reference's four chaos plans (killed mid-ingest then
     resumed, a torn chunk, two ENOSPC faults, a 0.7 MB stage budget run
     twice), each keeping its sha; audit (0 replay mismatches) and an
     enforce-mode ``stream_block`` corruption recomputed to the same
     bits;
 23. brain10m's generator and config at 20,000 × 2,000 × 16: the
     streaming run on a chunk store against ``refine()`` of the same CSR,
     both on the card (union, DE mask, nodg identical, ARI = 1,
     silhouettes within 1e-4, one launch each, the dense twin engaged),
     the streaming machinery under 2 % of the wall, best of 2;
 24. brain10m's shapes at ``STREAM_SCALE_CELLS`` cells in a child
     process: a cold run (ingest and run) and a steady one against the
     durable chunks under the default budgets, their walls, cells/s,
     peak RSS, staged bytes, chunk counters and loads, store size and
     peak device memory, then the store removed; and the reckoned first
     chunk's charge at that count and at 10,000,000 cells;
 25. the mesh at 2,000 × 800 × 4 on ``make_mesh(4)`` (4 shards of the
     card, and of the CPU): the sharded aggregates in both forms, the
     sharded Wilcoxon, the ring sums and the fused step's silhouette sums
     against their serial forms; then the fast Wilcoxon on dense and CSR
     input, the kNN branch and the landmark branch with the kNN linkage,
     each card mesh run held to the CPU's mesh run and to the card's
     serial run by ``parallel.validate.assert_mesh_equals_serial``, each
     mesh run's silhouette one kernel launch for all its cuts;
 26. the 26k flagship on a 4-shard mesh of the card (phase 7's config),
     held to phase 7's serial run by the same contract: its wall, stage
     walls, the silhouette's wall (one kernel launch) beside the kernel's
     time and the ring engine's for the same cuts, peak device memory,
     the card count and what ``mesh="auto"`` resolves to;
 27. the elastic supervisor at 26k on the 4-shard mesh: a device loss in
     ``sharded:ranksum`` and one in ``ring:distance_sums`` (4 → 2), a
     double loss (4 → 2 → 1), a store written on 4 shards and resumed
     serially (one ``cause: "resume"`` transition a stage), and a child
     (from the launcher, started with the phase) killed at
     ``wilcox_bucket`` halfway through the 4-shard ladder, resumed on 2
     shards; every run held to phase 26's
     labels, union and DE mask, its transitions validated; the
     robustness layer under 2 % of the healthy mesh runs' wall, best
     of 2;
 28. the reference's test oracles on the card at phase 4's data: the
     direct per-pair NB engine (``de/edger_direct.py``) against
     ``pairwise_de(method="edger")`` at the reference's parity bars, in
     count scale and in compat mode; ``cutree_hybrid_direct`` against
     ``cutree_hybrid`` for deepSplit 0-4 on a card run's tree;
     ``rank_sum_groups`` card against CPU (rank sums bit for bit, tie
     sums within 1e-6 relative);
 29. phase 7's run again with ``SCC_TRACE_DIR`` and ``SCC_OBS_KERNELS``
     pointing under ``OUT_DIR/phase29/``: phase 7's bits, the
     exported ``run_record.json`` and ``trace.json`` (one X event a span)
     and the ``kernels`` section validated, the ``.cu``'s kernels under
     span ``silhouette`` with as many sweeps as the launch counter and
     the wrapper's plan give; the top kernels, the card's busy share by
     the profiler, the sweep's profiler time beside phase 7's CUDA-event
     time, the wall beside phase 7's and the trace's bytes printed;
 30. the integrity-soak worker (``python -m
     scconsensus_tpu_torch.robust.soak``) in five fresh processes at once from
     the launcher: the default shape, ``--stream`` at the default host
     budget, ``--stream --stream-window 16``, ``--mesh 8`` and
     ``--device cpu``; each exits 0 with a validated run record, all
     with one ``labels_sha``;
 31. phase 7's run under ``SCC_OBS_RESIDENCY=audit``,
     ``SCC_OBS_TRANSFERS=1`` and ``SCC_HOSTPROF=1`` (records under
     ``OUT_DIR/phase31/``), twice: phase 7's bits, the declared
     crossings ``input_staging``, ``funnel_counts``,
     ``embed_scores_fetch``, ``silhouette_slab_fetch`` and
     ``label_fetch`` made, the upload cache's hits and misses over the
     two runs (none: the matrix is a card tensor), then a host copy of
     the matrix through the cache (one miss and two hits, each timed),
     d2h and h2d bytes by stage and boundary, the
     implicit syncs by stage and line, the exported record carrying
     ``residency``, ``profile``, ``residency_burndown``,
     ``host_profile`` and ``memory_timeline`` and validated, the
     auditor's ``consumed_cpu_s`` under 2 % of the wall (best of 2), the
     audited wall beside phase 7's; then one run under a counting
     ``TorchFunctionMode`` prices the two ways to see crossings (the
     patched entry points against a mode's dispatch on every call);
 32. phase 7's run under ``SCC_OBS_RESIDENCY=enforce``: phase 7's bits,
     no violation, every stored d2h event on a declared boundary; an
     undeclared ``.cpu()`` inside a stage span raises ``ResidencyError``
     naming the span and the line; phase 26's 4-shard mesh once under
     enforce, no violation, phase 26's labels;
 33. (in phase 29's run, with ``SCC_OBS_COST=1``) the ``kernels``
     section's ``vs_cost_model`` for ``wilcox_test``, the record's
     ``profile`` with the card's time under ``silhouette``, each
     stage's cost-model FLOPs, bytes and rates;
 34. phase 7's run under ``SCC_WILCOX_PROBE=1``: phase 7's bits, every
     bucket's synced wall and sort-only time, the bucket walls within
     ``wilcox_test``'s wall, the sort and contraction split;
 35. three child processes, started at once, run phase 7's refine
     under a ``LiveRecorder`` with a 1 s heartbeat: a clean one, one with
     ``SCC_OBS_STALL_S=3`` and a 6 s stall in stage ``tree`` (a
     ``stall`` event with the stacks), one held in ``tree`` by the same
     stall and sent SIGTERM there (a valid partial record stamped
     ``signal`` with the open stage, ingested by the evidence ledger as
     partial);
 36. phase 7's run in a fresh child process (from the launcher, started
     beside phase 35's children) with
     ``SCC_COMPILELOG=1`` and ``SCC_GRAPHS=1`` armed as the reference's
     bench worker arms them: phase 7's labels, DE mask and union with one
     kernel launch; its run record's ``compile`` section (no compile, one
     cache hit for each native library, printed with the stage that
     loaded it) and ``graphs`` section (a passport for each program the
     fast Wilcoxon path reaches, no capture error), validated; each
     passport's transfer ops and host syncs by stage and line, beside
     phase 31's implicit syncs;
 37. the records of phases 7, 29, 31 and 36 ingested into an evidence
     ledger under a temporary path and ``obs.regress.gate_record`` of
     phase 36's against the other three, every verdict printed; the graph
     lane refused by the committed ratchet's fingerprint
     (``evidence/NUMERIC_PINS.json``, read only), and a temporary ratchet
     pinned from phase 36's passports and phase 31's boundary calls
     passed with 0 regressed by a second passport run (phase 31's audited
     config with the passports armed here, phase 31's crossings);
     ``obs.attr.diff_records`` of phase 36 against phase 7, its top
     suspect and the head of its report;
 38. the drift sentinel's pinned workload (``obs.regress.
     reference_fingerprint``, edgeR at 80 × 200 × 3) on the card and on
     the CPU, each against the committed ``reference`` pins (read only;
     the drifted fields printed), the card held to the CPU by
     ``check_drift`` (log p quantiles within phase 5's 2e-3, dispersion
     quantiles within 50 %, label ARI 1.0; its own 1e-3 verdict
     printed);
 39. the workload zoo card against CPU at the ``smoke`` shapes: the PCA
     embed of cite_dual's RNA modality with one projection on both
     devices (each component whose singular value is 1 % clear of its
     neighbours' within 1e-4 of the largest |score| up to sign; the
     others printed), the k-means labelings of both modalities and the
     topology clusterer on the CPU's embedding, labels identical; then
     ``run_scenario(name, smoke=True)`` for the four scenarios on the
     card and on the CPU: final cuts identical, the ``quality.scenario``
     metrics side by side, every record valid, one kernel launch a card
     run;
 40. the four scenarios at their ``full`` shapes (``multi_sample``
     cut from 100,000 to 40,000 cells × 3,000 genes, ``cite_dual``
     40,000 × 8,000, ``atlas_transfer`` 20,000 fitted and 60,000 served,
     ``topo_inputs`` 50,000 × 3,000; their draws start at once, and each
     runs, in the reference's order, as soon as its draw is in) on
     the card in one fresh child from the launcher: headline, stage
     walls, peak device memory, one kernel launch each, the kernel at
     each run's inputs against its plain version, the scenario metrics;
     every record valid (under ``OUT_DIR/phase40/``) with every deepSplit
     cut, every query answered, the topology replay identical;
 41. the zoo's soak worker (``python -m
     scconsensus_tpu_torch.workloads.soak``) in six fresh children from
     the launcher: the reference's workload-kill-resume plan (a clean
     run, a run SIGKILLed at ``stage:tree``, its resume adopting ``de``
     and ``embed`` with the clean run's ``labels_sha``), ``--device
     cpu`` with that sha, and the ``--topo`` audit on the card and on the
     CPU with one sha;
 42. the serving fleet at the reference tests' shapes (the 120-gene,
     4-cluster atlas), one model dir built by the port on the CPU and
     served on the card and on the CPU: a 3-replica pool behind the wire
     front answering 200 (JSON and ``.npy``), 409, 422, 429, 504, 503 and
     a ``degraded`` 200 through ``force_open``; a replica kill through the
     pool and its respawn; the ``wire_request``, ``fleet_route`` and
     ``fleet_swap`` fault sites; the planted-drift reconsensus loop
     (quarantine, update, swap, ARI >= 0.99); card = CPU on the labels,
     the sites, the loop's ``labels_sha`` and the new clusters (the chaos
     plans run once, in phase 44's workers); the model built on
     the card labels the training cells as the CPU's build; then the
     reference's wire-overhead guard on the production-shaped model
     (served p99 with the front and pool under 1.07 x the bare driver's at
     1 replica, best of 3);
 43. the bench's ``atlas_query`` over a 2-replica fleet on the card
     (``run_fleet_soak`` as ``bench.py:1462`` calls it, cut from 300
     requests to 150 of 64 cells, 8 foreign, a 2,000-gene 12-cluster
     atlas of 20,000 cells): the model's build time apart, then the
     pass's cells/s and wall, served p50 and p99, the ``queue_wait`` and
     ``compute`` stage medians, outcomes (142 answered, 8 quarantined)
     and peak device memory, beside the thread CPU the process spends in JSON encoding
     and decoding during that pass, and phase 19's cells/s;
 44. the fleet's chaos worker (``python -m
     scconsensus_tpu_torch.serve.fleet.soak``) and the load generator in
     fresh children from the launcher: swap-under-load, replay-across-
     replicas (1 replica, 3, and 3 with ``--device cpu`` on one model:
     one sha) and kill-replica-under-load (trace continuity on the
     worker's attempt log), the swap and the kill also with ``--device
     cpu`` (card = CPU on each plan's sha), started at once; then one
     ``run_load`` at the reference's defaults alone; then the spike soak
     of ``tools/load_run.py`` alone at its payload and 0.1 s tick (shed
     through 429s, a scale-up from the floor and back, zero SLO
     breaches, ``rps_at_slo`` > 0, a valid record, the postmortem
     bundle with every actuation and resize), once, no retry;
 45. the 26k flagship fast Wilcoxon on phase 26's 4-shard mesh split
     across two processes: two children, started beside phase 41's and
     collected before phase 42, each on ``cuda`` with 2 shards of the
     card, joined by a gloo group, each
     drawing phase 6's data itself (the sha held to phase 6's); each
     rank's result held to phase 7's serial run by
     ``assert_mesh_equals_serial`` and to phase 26's labels, the ranks
     the same bits; each rank's wall, the bytes each collective sent
     across the group and the kernel's launches (one a rank: every rank
     computes the silhouette).

Phases 19 and 22 also validate the run records of the serve and stream
soak workers' summaries. The compile log is armed before phase 2, and
the script's own compile section (on a clean checkout, the nvcc and g++
builds outside any span) is printed before the kernel record.

Phases run in the order 1–5, 12, 15, 20, 25, 28, 6–8, 13, 19, 16–18,
21, 26, 27, 29 (with 33), 31, 32, 34, 35–38, 9–11, 14, 22–24, 30,
39–41, 45, 42–44 (phase 36's child runs beside phase 35's, phase 45's
two beside phase 41's), so that the 26k data serves phases 7–8, 13, 19, 16–18, 21, 26,
27, 29, 31–34 and 37 (phase 19 while phase 7's result is alive) and is
freed before the larger ones (phase 45's children draw it again); the
line before the kernel record gives the total time.

The line before the last is a JSON object describing every kernel of the
path; the last line is ``{"ok": true, "device": {...}}``. Every phase runs
on every call.
"""

from __future__ import annotations

import contextlib
import faulthandler
import functools
import hashlib
import io
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_FP32_FLOPS = 67e12      # H100 SXM, fp32 outside the tensor cores
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
KERNEL_RTOL = 1e-4           # of the largest |sum|; see _measure_kernel
# files the script keeps (phase 29's run record, trace and kernel
# capture): the checkout's git-ignored output directory
OUT_DIR = os.path.join(REPO, "chiprun_out")


def log(*a) -> None:
    print(*a, flush=True)


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def _time_ms(fn, budget_ms: float = 300.0) -> float:
    """Mean device time of fn() over repeated launches (CUDA events),
    after a warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = (time.perf_counter() - t0) * 1e3
    reps = int(min(max(budget_ms / max(once, 1e-3), 3), 50))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _bound(n: int, d: int, c: int, k: int, nnz: int) -> dict:
    """Least time for S[i, k] = Σ_{(j, c): id[j, c] = k} ‖x_i − x_j‖ on this
    card: 2·N²·d for the cross products, 3·N² for a²+b²−2ab, max and sqrt,
    and one add per row for each of the nnz (cell, cut) ids in [0, K)
    (the ones of the one-hot; its zeros need no work), against x (N, d)
    and the ids (N, C) read once and S (N, K) written once."""
    ops = n * n * (2.0 * d + 3.0) + float(n) * nnz
    nbytes = 4.0 * (n * d + n * c + n * k)
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": ops, "bytes": nbytes}


def _measure_kernel(x, ids, k: int, label: str) -> dict:
    """Kernel against its plain version on the same card inputs (x (N, d),
    cluster ids (N, C), K clusters): error, times, bound, the cdist
    yardstick, the run sums each row writes (against N·C read-add-writes
    without the cluster order) and the splits of j. Fails on disagreement
    or when a second launch does not give the same bits."""
    import torch

    from scconsensus_tpu_torch.ops.cuda_kernels import (
        distance_cluster_sums,
        distance_cluster_sums_reference,
        labels_onehot,
        launch_plan,
        run_flushes,
    )

    n, d = x.shape
    c = ids.shape[1]
    nnz = int(((ids >= 0) & (ids < k)).sum())
    got = distance_cluster_sums(x, ids, k)
    ref = distance_cluster_sums_reference(x, ids, k)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: kernel output is not finite")
    err = (got - ref).abs()
    max_abs = float(err.max())
    scale = float(ref.abs().max())
    max_rel = float((err / ref.abs().clamp_min(1e-30)).max())
    # fp32 sums of N terms taken in another order, plus the sqrt of the
    # a²+b²−2ab cancellation residue on the diagonal: held at 1e-4 of the
    # largest sum (the reference's own pallas-vs-xla tolerance is 1e-4).
    if max_abs > KERNEL_RTOL * max(scale, 1.0):
        raise AssertionError(
            f"{label}: kernel disagrees with its plain version: max abs "
            f"err {max_abs} > {KERNEL_RTOL} x max |sum| {scale}"
        )
    # every address the kernel's atomic flushes touch has one writer
    # (csrc/distance_cluster_sums.cu, point 7): the same bits again
    again = distance_cluster_sums(x, ids, k)
    rerun_diff = float((again - got).abs().max())
    if not torch.equal(again, got):
        raise AssertionError(f"{label}: a second launch differs by up to "
                             f"{rerun_diff}")

    plan = launch_plan(n, d, c, k, x.device)

    def _library():
        b = 4096
        onehot = labels_onehot(ids, k)
        return torch.cat([torch.cdist(x[s:s + b], x) @ onehot
                          for s in range(0, n, b)])

    rec = {
        "shape": [n, d, c, k],
        "nnz": nnz,
        "max_abs_sum": scale,
        "max_abs_err": max_abs,
        "max_rel_err": max_rel,
        "rerun_max_abs_diff": rerun_diff,
        "runs_per_row": run_flushes(ids, k),
        "n_times_c": n * c,
        **{key: plan[key] for key in ("splits", "blocks_per_sm", "ordered")},
        "ms": _time_ms(lambda: distance_cluster_sums(x, ids, k)),
        "plain_ms": _time_ms(
            lambda: distance_cluster_sums_reference(x, ids, k)),
        "library_ms": _time_ms(_library),
        **_bound(n, d, c, k, nnz),
    }
    rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
    log(f"[kernel] {label} N={n} d={d} C={c} K={k}: " + json.dumps(rec))
    return rec


def phase_env() -> dict:
    import torch

    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    smi = _smi()
    log(smi)  # name, power limit: exactly as nvidia-smi gives them
    return {"smi": smi, "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase_build() -> None:
    from scconsensus_tpu_torch.native import build as build_ward
    from scconsensus_tpu_torch.ops import cuda_kernels

    with ThreadPoolExecutor(max_workers=2) as pool:
        cu = pool.submit(cuda_kernels.build)
        wd = pool.submit(build_ward)
        so, secs, out = cu.result()
        wso, wsecs = wd.result()
    log(f"[build] cuda kernel {os.path.relpath(so, REPO)}: {secs!r} s")
    for line in out.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            log(f"[build]   ptxas: {line.strip()}")
    log(f"[build] native ward {os.path.relpath(wso, REPO)}: {wsecs!r} s")


def phase_kernel() -> dict:
    import torch

    from scconsensus_tpu_torch.ops.cuda_kernels import distance_cluster_sums

    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    # (N, d, K, cuts), random ids: one cut of K = 100 at the flagship N; K
    # split over three cuts with ragged tiles; a skinny d and K; a wide d
    # and K
    for label, (n, d, k, c) in (("flagship", (26000, 15, 100, 1)),
                                ("ragged", (300, 7, 131, 3)),
                                ("skinny", (257, 3, 2, 1)),
                                ("wide", (3000, 200, 1100, 2))):
        x = torch.randn((n, d), generator=g, device="cuda")
        edges = [k * i // c for i in range(c + 1)]
        ids = torch.stack([
            torch.randint(edges[i], edges[i + 1], (n,), generator=g,
                          device="cuda") for i in range(c)], dim=1)
        if c > 1:  # a few cells with no cluster in the later cuts
            gap = torch.rand((n, c - 1), generator=g, device="cuda") < 0.05
            ids[:, 1:][gap] = -1
        out[label] = _measure_kernel(
            x, ids.to(torch.int32).contiguous(), k, label)
    # the main path's geometry: 26,000 × 15 and four cuts, each refining the
    # one before (10, 40, 150 and 250 clusters: K = 450), about 5 % of the
    # cells in no cluster in each later cut; then the multi-sample
    # scenario's (phase 40): 100,000 × 15 and four nested cuts of 12, 20,
    # 30 and 40 clusters (K = 102)
    for label, n, sizes in (("nested", 26000, (10, 40, 150, 250)),
                            ("nested-100k", 100_000, (12, 20, 30, 40))):
        x = torch.randn((n, 15), generator=g, device="cuda")
        fine = torch.randint(0, sizes[-1], (n,), generator=g, device="cuda")
        cols, k0 = [], 0
        for c, m in enumerate(sizes):
            col = fine * m // sizes[-1] + k0
            if c:
                col[torch.rand(n, generator=g, device="cuda") < 0.05] = -1
            cols.append(col)
            k0 += m
        ids = torch.stack(cols, dim=1).to(torch.int32).contiguous()
        out[label] = _measure_kernel(x, ids, k0, label)
    log(f"[kernel] launches so far (comparison only): "
        f"{distance_cluster_sums.launches}")
    return out


def _ari(a, b) -> float:
    """Adjusted Rand index of two labelings (the port's own)."""
    from scconsensus_tpu_torch.obs.regress import adjusted_rand_index

    return adjusted_rand_index(a, b)


def _consensus_labels(truth, n_clusters: int):
    """The reference bench's two-labeling recipe (workloads/labelings.py
    ``truth_perturb``): a 5 %-flip supervised labeling, a 10 %-flip
    coarsened unsupervised one, merged by the contingency grammar."""
    from scconsensus_tpu_torch import plot_contingency_table
    from scconsensus_tpu_torch.utils.synthetic import noisy_labeling

    sup = noisy_labeling(truth, 0.05, seed=1, prefix="sup")
    uns = noisy_labeling(truth, 0.10, n_out_clusters=max(2, n_clusters - 4),
                         seed=2, prefix="uns")
    return plot_contingency_table(sup, uns)


def _small_data():
    """2,000 cells × 800 genes × 4 clusters (the reference bench's reduced
    flagship): the dense numpy matrix and its consensus labels."""
    from scconsensus_tpu_torch.utils.synthetic import synthetic_scrna

    n_cells, n_genes, n_clusters = 2000, 800, 4
    data, truth, _ = synthetic_scrna(
        n_genes=n_genes, n_cells=n_cells, n_clusters=n_clusters,
        n_markers_per_cluster=min(40, n_genes // n_clusters), seed=7)
    return data, _consensus_labels(truth, n_clusters)


def _same_refine(tag: str, a, b, what: str) -> None:
    """Union identical, ARI = 1 and silhouettes within 1e-4 per deepSplit
    between two refine results ``a`` and ``b`` (named in ``what``)."""
    if not np.array_equal(a.de_gene_union_idx, b.de_gene_union_idx):
        raise AssertionError(f"[{tag}] {what}: unions differ")
    for a_info, b_info in zip(a.deep_split_info, b.deep_split_info):
        key = f"deepsplit: {a_info['deep_split']}"
        ari = _ari(a.dynamic_labels[key], b.dynamic_labels[key])
        dsil = abs(a_info["silhouette"] - b_info["silhouette"])
        log(f"[{tag}] {key}: clusters {a_info['n_clusters']} "
            f"silhouette {a_info['silhouette']!r} ARI({what}) {ari!r} "
            f"|dsil| {dsil!r}")
        if ari != 1.0:
            raise AssertionError(f"[{tag}] {key}: ARI {ari} != 1")
        # fp32 sums over the cells' distances in another order on each side
        if not dsil <= 1e-4:
            raise AssertionError(f"[{tag}] {key}: silhouettes differ {dsil}")


def _card_against_cpu(tag: str, cfg, run, as_input=None):
    """The 2k data (``as_input(data)`` when given, else the dense matrix):
    ``run(data, cons, device, omega)`` on the card against the same on the
    CPU, with the same PCA projection handed to both. Checks the union,
    ARI = 1 and silhouettes per deepSplit; returns both results and the
    projection."""
    import torch

    from scconsensus_tpu_torch.de.engine import de_gene_union, pairwise_de

    data, cons = _small_data()
    if as_input is not None:
        data = as_input(data)
    f = de_gene_union(pairwise_de(data, cons, cfg, device="cuda"),
                      cfg.n_top_de_genes).size
    k = min(cfg.n_pcs + 10, f, data.shape[1])
    omega = torch.randn((f, k), generator=torch.Generator().manual_seed(0))
    t0 = time.perf_counter()
    gpu = run(data, cons, "cuda", omega)
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = run(data, cons, "cpu", omega)
    t_cpu = time.perf_counter() - t0
    log(f"[{tag}] refine walls: cuda {t_gpu!r} s, cpu {t_cpu!r} s; "
        f"union {gpu.de_gene_union_idx.size}")
    _same_refine(tag, gpu, cpu, "card, cpu")
    return gpu, cpu, omega


def phase_small() -> None:
    """The dense fast-Wilcoxon ``refine()``, card against CPU."""
    from scconsensus_tpu_torch import ReclusterConfig, refine

    cfg = ReclusterConfig()
    _card_against_cpu("small", cfg, lambda data, cons, dev, omega: refine(
        data, cons, cfg, device=dev, omega=omega))


# the CPU run's tolerance for finite log p in compat mode
# (tests/test_torch_edger.py: 9.7e-4 measured against the JAX package).
# The exact test rounds each group's pseudo-count sum, so a sum that sits
# at a half-integer rounds to the other count on the other device and its
# log p moves by a whole count's step: at most 1 in 1,000 entries may.
EDGER_LOGP_ATOL = 2e-3
EDGER_ROUNDING_SHARE = 1e-3
# count-scale mode (edger_log_counts=False): the CPU tests' 0.1
# (tests/test_torch_edger.py; the JAX package's own sensitivity is 0.089)
EDGER_COUNTSCALE_LOGP_ATOL = 0.1
EDGER_KW = dict(method="edgeR", q_val_thrs=0.01, fc_thrs=2.0,
                mean_scaling_factor=2.0)


def phase_small_edger() -> None:
    """The edgeR slow path at the headline's thresholds, card against CPU:
    besides the checks of phase 4, identical DE masks and finite log p
    within the CPU tests' tolerance."""
    from scconsensus_tpu_torch import ReclusterConfig, recluster_de_consensus

    cfg = ReclusterConfig(method="edger", q_val_thrs=0.01,
                          log_fc_thrs=math.log(2.0), mean_scaling_factor=2.0)
    gpu, cpu, _ = _card_against_cpu(
        "edger-small", cfg, lambda data, cons, dev, omega:
        recluster_de_consensus(data, cons, device=dev, omega=omega,
                               **EDGER_KW))
    _check_edger_card_cpu("edger-small", gpu, cpu, EDGER_LOGP_ATOL)


def _check_edger_card_cpu(tag: str, gpu, cpu, atol: float) -> None:
    """edgeR card against CPU: identical DE masks, the same finite log p,
    at most one in 1,000 of them more than ``atol`` apart, finite common
    dispersions."""
    gd, cd = gpu.de, cpu.de
    lp_g, lp_c = gd.log_p.cpu().numpy(), cd.log_p.numpy()
    fin = np.isfinite(lp_c)
    errs = np.abs(lp_g[fin] - lp_c[fin])
    n_out = int((errs > atol).sum())
    cg = gd.aux["common_dispersion"].cpu().numpy()
    cc = cd.aux["common_dispersion"].numpy()
    log(f"[{tag}] DE calls {int(gd.de_mask.sum())} / "
        f"{int(cd.de_mask.sum())}; |dlog p| 99.9th percentile "
        f"{float(np.quantile(errs, 1.0 - EDGER_ROUNDING_SHARE))!r}, max "
        f"{float(errs.max())!r}, {n_out} of {errs.size} above "
        f"{atol}; common dispersion max |card / cpu - 1| "
        f"{float(np.max(np.abs(cg / cc - 1.0)))!r}")
    if not np.array_equal(gd.de_mask.cpu().numpy(), cd.de_mask.numpy()):
        raise AssertionError(f"[{tag}] card and CPU DE masks differ")
    if not np.array_equal(np.isfinite(lp_g), fin) or \
            n_out > EDGER_ROUNDING_SHARE * errs.size:
        raise AssertionError(f"[{tag}] {n_out} log p differ by more "
                             f"than {atol}")
    if not np.isfinite(cg).all():
        raise AssertionError(f"[{tag}] a common dispersion is not finite")


def phase_full_data():
    """The 26k flagship data, drawn once on the card for both full-size
    phases."""
    import torch

    from scconsensus_tpu_torch.utils.synthetic import synthetic_scrna_device

    n_cells, n_genes, n_clusters = 26000, 15000, 22
    t0 = time.perf_counter()
    data, truth, _ = synthetic_scrna_device(
        n_genes=n_genes, n_cells=n_cells, n_clusters=n_clusters,
        n_markers_per_cluster=min(40, n_genes // n_clusters), seed=7,
        device="cuda")
    cons = _consensus_labels(truth, n_clusters)
    torch.cuda.synchronize()
    log(f"[data] {tuple(data.shape)} drawn on the card in "
        f"{time.perf_counter() - t0!r} s; nnz fraction "
        f"{float((data > 0).float().mean())!r}; consensus clusters "
        f"{np.unique(cons).size}")
    return data, truth, cons


def _run_full(tag: str, call, truth, min_launches: int = 1,
              engine="native"):
    """One full-size refine with the kernel count reset just before and
    read just after; checks what every path must give (at least
    ``min_launches`` kernel launches, the tree stage's Ward engine
    ``engine``: None where the tree resumes from the artifact store)."""
    import torch

    from scconsensus_tpu_torch.ops.cuda_kernels import distance_cluster_sums

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    distance_cluster_sums.launches = 0
    t0 = time.perf_counter()
    res = call()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = distance_cluster_sums.launches
    m = res.metrics
    n_cells = m["n_cells"]
    log(f"[{tag}] refine wall {wall!r} s, peak device memory "
        f"{torch.cuda.max_memory_allocated()} bytes")
    m["wall_s"] = wall
    m["peak_bytes"] = torch.cuda.max_memory_allocated()
    log(f"[{tag}] stage walls (s): " + json.dumps(m["stage_walls_s"]))
    log(f"[{tag}] union {m['union_size']} genes; tree engine "
        f"{m['tree_engine']}; distance_cluster_sums launches {launches}")
    for info in res.deep_split_info:
        key = f"deepsplit: {info['deep_split']}"
        log(f"[{tag}] {key}: clusters {info['n_clusters']} silhouette "
            f"{info['silhouette']!r} ARI(planted) "
            f"{_ari(res.dynamic_labels[key], truth)!r}")
    if launches < min_launches:
        raise AssertionError(f"[{tag}] the silhouette stage did not launch "
                             "the CUDA kernel")
    if m["tree_engine"] != engine:
        raise AssertionError(f"[{tag}] Ward ran on {m['tree_engine']}")
    if m["union_size"] < 2:
        raise AssertionError(f"[{tag}] union of {m['union_size']} genes")
    if res.embedding.shape != (n_cells, min(m["union_size"], 15)) or \
            not np.isfinite(res.embedding).all():
        raise AssertionError(f"[{tag}] embedding is not finite or "
                             "mis-shaped")
    if not all(np.isfinite(i["silhouette"]) for i in res.deep_split_info):
        raise AssertionError(f"[{tag}] a silhouette is not finite")
    if res.nodg.shape != (n_cells,):
        raise AssertionError(f"[{tag}] nodg is mis-shaped")
    return res, launches


# the guard rails: each layer, measured by itself, costs under 2 % of the
# refine() wall (the reference's contracts: tests/test_robust_integrity.py:
# 811-845, tests/test_robust_faults.py:624-650, tests/test_obs_quality.py:
# 550-580)
LAYER_SHARE_LIMIT = 0.02


def _quality_share(tag: str, m: dict) -> float:
    """The ``quality`` stage's wall over the refine() wall, held to the
    reference's < 2 % contract (tests/test_obs_quality.py:550-580)."""
    share = m["stage_walls_s"]["quality"] / m["wall_s"]
    log(f"[{tag}] quality stage {m['stage_walls_s']['quality']!r} s, "
        f"{share!r} of the wall (limit {LAYER_SHARE_LIMIT})")
    if not share < LAYER_SHARE_LIMIT:
        raise AssertionError(f"[{tag}] the quality stage costs 2 % or more "
                             "of the wall")
    return share


def _measure_main_path(res, label: str) -> dict:
    """The kernel at the inputs the main path gave it."""
    import torch

    from scconsensus_tpu_torch.ops.silhouette import cut_labels

    labs = [np.where(res.dynamic_labels[f"deepsplit: {i['deep_split']}"] > 0,
                     res.dynamic_labels[f"deepsplit: {i['deep_split']}"], -1)
            for i in res.deep_split_info]
    ids, k_total, _ = cut_labels(labs)
    x = torch.from_numpy(res.embedding).cuda().contiguous()
    return _measure_kernel(x, torch.from_numpy(ids).cuda(), k_total, label)


def phase_full(data, truth, cons) -> dict:
    """The fast-Wilcoxon flagship slice on the card."""
    from scconsensus_tpu_torch import recluster_de_consensus_fast

    res, launches = _run_full(
        "full", lambda: recluster_de_consensus_fast(data, cons,
                                                    device="cuda"), truth)
    rec = _measure_main_path(res, "main-path")
    rec["launches"] = launches
    return rec, res


def phase_edger_full(data, truth, cons) -> dict:
    """The edgeR headline on the card."""
    import torch

    from scconsensus_tpu_torch import recluster_de_consensus

    res, launches = _run_full(
        "edger-full", lambda: recluster_de_consensus(
            data, cons, device="cuda", **EDGER_KW), truth)
    common = res.de.aux["common_dispersion"]
    tagwise = res.de.aux["tagwise_dispersion"]
    ok_pairs = ~np.asarray(res.de.pair_skipped)
    c = common.cpu().numpy()[ok_pairs]
    log(f"[edger-full] pairs {c.size}; common dispersion quantiles "
        f"(0, .25, .5, .75, 1): "
        f"{np.quantile(c, [0, .25, .5, .75, 1]).tolist()}; DE calls "
        f"{int(res.de.de_mask.sum())}")
    ok_rows = torch.as_tensor(ok_pairs, device=tagwise.device)
    if not np.isfinite(c).all() or \
            not bool(tagwise[ok_rows].isfinite().all()):
        raise AssertionError("[edger-full] a dispersion is not finite")
    rec = _measure_main_path(res, "edger-main-path")
    rec["launches"] = launches
    return rec, res


# the scale branches of phase 9 (the thresholds of the CPU parity tests,
# tests/test_torch_scale_pipeline.py)
SCALE_VARIANTS = {
    "pool": dict(approx_threshold=1000, n_pool_centroids=256),
    "landmark": dict(approx_threshold=1000, landmark_threshold=1000,
                     landmark_verify=True),
    "knn": dict(approx_threshold=1000, approx_method="knn"),
    "pearson": dict(distance="pearson"),
}


def phase_scale_small() -> None:
    """Each scale branch, card against CPU: besides the checks of phase 4,
    the same tree record, silhouette method and landmark info."""
    from scconsensus_tpu_torch import ReclusterConfig
    from scconsensus_tpu_torch import recluster_de_consensus_fast

    for name, kw in SCALE_VARIANTS.items():
        tag = f"scale-{name}"
        gpu, cpu, _ = _card_against_cpu(
            tag, ReclusterConfig(**kw), lambda data, cons, dev, omega:
            recluster_de_consensus_fast(data, cons, device=dev, omega=omega,
                                        **kw))
        gm, cm = gpu.metrics, cpu.metrics
        log(f"[{tag}] tree {json.dumps(gm['tree'])}; silhouette "
            f"{json.dumps(gm['silhouette'])}; tree stage "
            f"{gm['stage_walls_s']['tree']!r} s on the card, "
            f"{cm['stage_walls_s']['tree']!r} s on the CPU")
        if gm["tree"] != cm["tree"] or gm["silhouette"] != cm["silhouette"]:
            raise AssertionError(f"[{tag}] tree or silhouette records differ")
        if gm["tree"]["approx"] != (name != "pearson"):
            raise AssertionError(f"[{tag}] took the wrong branch")
        if name == "landmark":
            g, c = gm["landmark"], cm["landmark"]
            log(f"[{tag}] landmark k {g['k']} sketch {g['sketch']} "
                f"ari_vs_exact {json.dumps(g['ari_vs_exact'])}")
            for key in ("k", "sketch", "ari_vs_exact", "occupancy"):
                if g[key] != c[key]:
                    raise AssertionError(f"[{tag}] landmark {key} differs: "
                                         f"{g[key]} against {c[key]}")


def phase_tm100k() -> int:
    """Tabula Muris 100k on the card, as the reference bench's ``tm100k``
    runs it; returns the kernel's launches on this path."""
    import torch

    from scconsensus_tpu_torch import recluster_de_consensus_fast
    from scconsensus_tpu_torch.utils.synthetic import synthetic_scrna_device

    n_cells, n_genes, n_clusters = 100_000, 12_000, 40
    t0 = time.perf_counter()
    data, truth, _ = synthetic_scrna_device(
        n_genes=n_genes, n_cells=n_cells, n_clusters=n_clusters,
        n_markers_per_cluster=40, seed=7, device="cuda")
    cons = _consensus_labels(truth, n_clusters)
    torch.cuda.synchronize()
    log(f"[tm100k] {tuple(data.shape)} drawn on the card in "
        f"{time.perf_counter() - t0!r} s; consensus clusters "
        f"{np.unique(cons).size}")
    res, launches = _run_full(
        "tm100k", lambda: recluster_de_consensus_fast(
            data, cons, approx_threshold=50_000, device="cuda"), truth,
        min_launches=0)
    m = res.metrics
    log(f"[tm100k] {n_cells / m['wall_s']!r} cells/s")
    _quality_share("tm100k", m)
    log(f"[tm100k] tree {json.dumps(m['tree'])}; silhouette "
        f"{json.dumps(m['silhouette'])}")
    if not m["tree"]["approx"] or m["tree"]["landmark"]:
        raise AssertionError("[tm100k] expected the legacy pool branch")
    if not m["silhouette"]["pool_reused"]:
        raise AssertionError("[tm100k] the silhouette fitted a second pool")
    if res.cell_tree.n_leaves > 4096:
        raise AssertionError("[tm100k] the tree is not over the pool")
    return launches


def phase_brain1m() -> dict:
    """The 1M landmark tree and the sampled silhouette (the reference
    bench's ``run_brain1m``), then the kernel at the sample's inputs."""
    import torch

    from scconsensus_tpu_torch import (
        landmark_ward_linkage,
        mean_cluster_silhouette,
    )
    from scconsensus_tpu_torch.ops.cuda_kernels import distance_cluster_sums
    from scconsensus_tpu_torch.ops.treecut import cutree_hybrid
    from scconsensus_tpu_torch.utils.synthetic import planted_embedding_device

    n = 1_000_000
    x, planted, rng = planted_embedding_device(n_cells=n, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    distance_cluster_sums.launches = 0
    walls = {}
    t0 = t = time.perf_counter()
    tree, assign, cents, info = landmark_ward_linkage(x, seed=1)
    walls["landmark_ward"] = time.perf_counter() - t
    t = time.perf_counter()
    w = np.bincount(assign, minlength=cents.shape[0]).astype(np.float64)
    cut = cutree_hybrid(tree, cents, deep_split=1,
                        min_cluster_size=max(2, round(2 * n / 4096)),
                        weights=w)
    cells = cut[assign]
    walls["cut"] = time.perf_counter() - t
    t = time.perf_counter()
    sub = rng.choice(n, size=50_000, replace=False)
    xs = x[torch.as_tensor(sub, device="cuda")].contiguous()
    # as the bench: label 0 (cells of no cluster) counts as a cluster here
    si, _ = mean_cluster_silhouette(xs, cells[sub])
    torch.cuda.synchronize()
    walls["silhouette"] = time.perf_counter() - t
    wall = time.perf_counter() - t0
    launches = distance_cluster_sums.launches
    clusters = len(set(cells[cells > 0].tolist()))
    log(f"[brain1m] wall {wall!r} s, {n / wall!r} cells/s, peak device "
        f"memory {torch.cuda.max_memory_allocated()} bytes; walls (s) "
        f"{json.dumps(walls)}")
    log(f"[brain1m] landmarks {json.dumps(info)}; clusters {clusters}; "
        f"silhouette (50,000-cell sample) {si!r}; ARI(planted) "
        f"{_ari(cells, planted)!r}; distance_cluster_sums launches "
        f"{launches}")
    if launches < 1:
        raise AssertionError("[brain1m] the sampled silhouette did not "
                             "launch the CUDA kernel")
    if not np.isfinite(si) or clusters < 2:
        raise AssertionError(f"[brain1m] silhouette {si}, {clusters} "
                             "clusters")
    if info["sketch"] != 65_536 or info["k_requested"] != 2048:
        raise AssertionError(f"[brain1m] landmark policy {info}")
    _, inv = np.unique(cells[sub], return_inverse=True)
    ids = torch.as_tensor(inv.astype(np.int32)[:, None], device="cuda")
    rec = _measure_kernel(xs, ids, int(inv.max()) + 1, "brain1m-sample")
    rec["launches"] = launches
    return rec


def _npz_round_trip(m):
    """``m`` written with ``scipy.sparse.save_npz`` and read back through
    the port's loader (which returns CSR float32)."""
    import tempfile

    import scipy.sparse as sp

    from scconsensus_tpu_torch import load_npz

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "x.npz")
        sp.save_npz(path, sp.csr_matrix(m))
        return load_npz(path).matrix


def phase_small_csr() -> None:
    """Sparse input at 2k: card against CPU (the checks of phases 4 and
    5), and the card's CSR result against its dense one: the same union
    and DE masks."""
    from scconsensus_tpu_torch import (
        CompatFlags,
        ReclusterConfig,
        recluster_de_consensus,
        refine,
    )

    def fast(x, cons, dev, omega):
        return refine(x, cons, ReclusterConfig(), device=dev, omega=omega)

    def edger(log_counts):
        def run(x, cons, dev, omega):
            return recluster_de_consensus(
                x, cons, device=dev, omega=omega,
                compat=CompatFlags(edger_log_counts=log_counts), **EDGER_KW)
        return run

    def edger_cfg(log_counts):
        return ReclusterConfig(
            method="edger", q_val_thrs=0.01, log_fc_thrs=math.log(2.0),
            mean_scaling_factor=2.0,
            compat=CompatFlags(edger_log_counts=log_counts))

    dense, cons = _small_data()
    for tag, cfg, run, atol in (
            ("small-csr", ReclusterConfig(), fast, None),
            ("edger-small-csr-compat", edger_cfg(True), edger(True),
             EDGER_LOGP_ATOL),
            ("edger-small-csr-countscale", edger_cfg(False), edger(False),
             EDGER_COUNTSCALE_LOGP_ATOL)):
        gpu, cpu, omega = _card_against_cpu(tag, cfg, run,
                                            as_input=_npz_round_trip)
        route = (gpu.metrics["wilcox_ladder"] or {}).get("route")
        if atol is None and route != "csr-compacted":
            raise AssertionError(f"[{tag}] the ladder took {route}")
        if atol is not None:
            _check_edger_card_cpu(tag, gpu, cpu, atol)
        ref = run(dense, cons, "cuda", omega)
        _same_refine(tag, gpu, ref, "csr, dense")
        n_diff = int((gpu.de.de_mask != ref.de.de_mask).sum())
        log(f"[{tag}] card: CSR against dense DE-mask differences {n_diff}")
        if n_diff:
            raise AssertionError(f"[{tag}] CSR and dense DE masks differ")


def _host_csr(t):
    """A dense (G, N) card tensor as a host ``scipy.sparse.csr_matrix``:
    its nonzeros found on the card, a block of genes at a time."""
    import scipy.sparse as sp
    import torch

    G, N = t.shape
    counts, cols, vals = [], [], []
    for g0 in range(0, G, 2048):
        blk = t[g0:g0 + 2048]
        rows, c = blk.nonzero(as_tuple=True)
        counts.append(torch.bincount(rows, minlength=blk.shape[0]).cpu())
        cols.append(c.to(torch.int32).cpu())
        vals.append(blk[rows, c].cpu())
    indptr = np.zeros(G + 1, np.int64)
    indptr[1:] = np.cumsum(torch.cat(counts).numpy())
    return sp.csr_matrix((torch.cat(vals).numpy(), torch.cat(cols).numpy(),
                          indptr), shape=(G, N))


def _de_mask_mismatch(tag: str, got, want, q_thr: float,
                      fc_thr: float) -> None:
    """Counts the entries where two DE masks differ and prints the
    largest distance of such an entry from its nearest threshold in
    ``want`` (log q from log q_thr, |logFC| from fc_thr). At most 1 in
    10⁵ of P·G may differ: the CSR aggregates' float32 sums run in
    another order than the dense ones."""
    import torch

    diff = (got.de_mask != want.de_mask)
    n_diff, total = int(diff.sum()), diff.numel()
    dist = None
    if n_diff:
        d = torch.minimum(
            (want.log_q[diff].double()
             - math.log(np.float32(q_thr))).abs(),
            (want.log_fc[diff].abs().double() - fc_thr).abs())
        dist = float(d.max())
    log(f"[{tag}] DE masks CSR against dense: {n_diff} of {total} entries "
        f"differ; nearest threshold distance of a differing entry {dist!r}")
    if n_diff > 1e-5 * total:
        raise AssertionError(f"[{tag}] {n_diff} DE-mask entries differ")


def phase_full_csr(data, truth, cons, dense_fast, dense_edger) -> tuple:
    """The 26k data as a host CSR through the fast Wilcoxon and the edgeR
    headline, each held against its dense run; returns the kernel's
    launches on each path and the host CSR."""
    import torch

    from scconsensus_tpu_torch import (
        recluster_de_consensus,
        recluster_de_consensus_fast,
    )
    from scconsensus_tpu_torch.de.engine import as_device_matrix
    from scconsensus_tpu_torch.io.sparsemat import (
        column_sums,
        csr_aggregates,
    )

    t0 = time.perf_counter()
    csr = _host_csr(data)
    log(f"[csr26k] host CSR {csr.shape} nnz {csr.nnz} (fraction "
        f"{csr.nnz / (csr.shape[0] * csr.shape[1])!r}, "
        f"{csr.data.nbytes + csr.indices.nbytes} bytes of values and "
        f"indices) in {time.perf_counter() - t0!r} s")
    # the CSR aggregates and library sizes: the same bits on a second call
    holder = as_device_matrix(csr, torch.device("cuda"))
    cid = torch.as_tensor(np.unique(cons, return_inverse=True)[1],
                          device="cuda")
    k = int(cid.max()) + 1
    a1, a2 = (csr_aggregates(holder, cid, k) for _ in range(2))
    same = all(torch.equal(getattr(a1, f), getattr(a2, f)) for f in
               ("sum_log", "sum_expm1", "sum_sq", "nnz", "counts"))
    same &= torch.equal(column_sums(holder), column_sums(holder))
    log(f"[csr26k] CSR aggregates and column sums bitwise repeatable: "
        f"{same}")
    if not same:
        raise AssertionError("[csr26k] a second call gave other bits")
    del holder, a1, a2
    out = {}
    # (q, |logFC|) thresholds: the fast path's defaults, the headline's
    for tag, call, dense, thresholds in (
            ("full-csr", lambda: recluster_de_consensus_fast(
                csr, cons, device="cuda"), dense_fast, (0.1, 0.5)),
            ("edger-full-csr", lambda: recluster_de_consensus(
                csr, cons, device="cuda", **EDGER_KW), dense_edger,
             (EDGER_KW["q_val_thrs"], math.log(EDGER_KW["fc_thrs"])))):
        res, launches = _run_full(tag, call, truth)
        _same_refine(tag, res, dense, "csr, dense")
        _de_mask_mismatch(tag, res.de, dense.de, *thresholds)
        log(f"[{tag}] wall {res.metrics['wall_s']!r} s against dense "
            f"{dense.metrics['wall_s']!r} s; peak {res.metrics['peak_bytes']}"
            f" against {dense.metrics['peak_bytes']} bytes")
        out[tag] = launches
    return out["full-csr"], out["edger-full-csr"], csr


def phase_sparse_1m() -> int:
    """The 1M sparse full pipeline; returns the kernel's launches (the
    pooled silhouette launches none)."""
    from scconsensus_tpu_torch import (
        plot_contingency_table,
        recluster_de_consensus_fast,
    )
    from scconsensus_tpu_torch.utils.synthetic import (
        gen_sparse_scrna_device,
        noisy_flip,
    )

    n_cells, n_genes, n_clusters = 1_000_000, 3_000, 16
    t0 = time.perf_counter()
    csr, truth = gen_sparse_scrna_device(n_cells, n_genes, n_clusters,
                                         seed=7, device="cuda")
    gen_s = time.perf_counter() - t0
    nnz_frac = csr.nnz / (n_cells * n_genes)
    t0 = time.perf_counter()
    sup = noisy_flip(truth, 0.05, n_clusters, 1, "S")
    uns = noisy_flip(truth, 0.10, n_clusters, 2, "U")
    cons = plot_contingency_table(sup, uns)
    cons_s = time.perf_counter() - t0
    log(f"[sparse1m] CSR {csr.shape} nnz {csr.nnz} (fraction {nnz_frac!r}) "
        f"drawn on the card in {gen_s!r} s; consensus "
        f"{np.unique(cons).size} labels in {cons_s!r} s")
    res, launches = _run_full(
        "sparse1m", lambda: recluster_de_consensus_fast(
            csr, cons, q_val_thrs=0.05, approx_threshold=50_000,
            device="cuda"), truth, min_launches=0)
    m = res.metrics
    dense_bytes = n_genes * n_cells * 4
    ladder = m["wilcox_ladder"]
    log(f"[sparse1m] {n_cells / m['wall_s']!r} cells/s; peak device memory "
        f"{m['peak_bytes']} bytes against the dense matrix's {dense_bytes}; "
        f"ladder {ladder['route']}, {len(ladder['buckets'])} buckets, "
        f"windows {sorted({b['window'] for b in ladder['buckets']})}")
    _quality_share("sparse1m", m)
    log(f"[sparse1m] tree {json.dumps(m['tree'])}; silhouette "
        f"{json.dumps(m['silhouette'])}")
    if ladder["route"] != "csr-compacted":
        raise AssertionError(f"[sparse1m] the ladder took {ladder['route']}")
    if not m["tree"]["landmark"] or \
            m["silhouette"]["method"] != "pooled-estimator":
        raise AssertionError("[sparse1m] expected the landmark tree and "
                             "the pooled silhouette")
    if not m["peak_bytes"] < dense_bytes:
        raise AssertionError("[sparse1m] peak device memory reached the "
                             "dense matrix's size")
    return launches


# log p of the Seurat tests, one device against another, held as the CPU
# tests hold the port to the reference (tests/test_torch_seurat.py):
# finite entries within their tolerance (gammaincc, lgamma and log are
# different implementations, and the LRT and the Welch prefactor cancel
# terms of size 1e3–1e4), the −inf positions of the FLT_MIN flush and the
# DE masks identical, and only Welch at t ≈ 0 may change class: NaN on one
# device where x = df/(df + t²) rounds past 1, log p = 0 on the other, in
# at most one entry in 1,000
SEURAT_LOGP_RTOL, SEURAT_LOGP_ATOL = 2e-4, 1e-2
SEURAT_NAN_AT_ONE_SHARE = 1e-3
# refine()'s top-level stages (the others nest inside "de")
TOP_STAGES = ("de", "de_store", "union", "embed", "tree", "cuts",
              "silhouette", "nodg")
# the 12 files of a completed run's artifact store (the reference's)
STORE_FILES = sorted(["config.json", "robust_state.json"] + [
    f"{s}.{e}" for s in ("de", "union", "embed", "tree", "cuts")
    for e in ("npz", "json")])


def _seurat_logp_check(tag: str, got, want) -> dict:
    """log p on the card (``got``) against the CPU (``want``), both numpy:
    finite entries within the tolerance, the same −inf positions, and NaN
    on one side only where the other is 0 (Welch at x past 1), within the
    share. Returns the counts."""
    crossed = int((np.isneginf(got) != np.isneginf(want)).sum())
    nan_diff = np.isnan(got) != np.isnan(want)
    at_one = nan_diff & ((got == 0.0) | (want == 0.0))
    fin = np.isfinite(got) & np.isfinite(want)
    err = np.abs(got[fin] - want[fin])
    n_out = int((err > SEURAT_LOGP_ATOL
                 + SEURAT_LOGP_RTOL * np.abs(want[fin])).sum())
    if err.size:
        worst = np.argsort(err)[-3:]
        log(f"[{tag}] largest |d log p|: card {got[fin][worst].tolist()} "
            f"cpu {want[fin][worst].tolist()}")
    rec = {"entries": int(got.size), "finite_both": int(fin.sum()),
           "max_abs_diff": float(err.max()) if err.size else 0.0,
           "beyond_tolerance": n_out,
           "neginf_card": int(np.isneginf(got).sum()),
           "neginf_cpu": int(np.isneginf(want).sum()),
           "flush_crossings": crossed, "nan_differences": int(nan_diff.sum()),
           "nan_at_one": int(at_one.sum())}
    log(f"[{tag}] log p card against CPU: " + json.dumps(rec))
    if (n_out or crossed or (nan_diff & ~at_one).any()
            or at_one.sum() > SEURAT_NAN_AT_ONE_SHARE * got.size):
        raise AssertionError(f"[{tag}] log p differs: {rec}")
    return rec


def phase_small_seurat() -> None:
    """bimod, t and roc at 2k, card against CPU, dense and as CSR through
    ``load_npz``, and bimod and t with ``max_cells_per_ident=200``: the
    checks of phase 4, log p within the CPU tests' tolerance, and roc's
    AUC and power within 1e-6."""
    from scconsensus_tpu_torch import (
        ReclusterConfig,
        recluster_de_consensus_fast,
    )

    for method, cap in (("bimod", None), ("t", None), ("roc", None),
                        ("bimod", 200), ("t", 200)):
        for as_input in (None, _npz_round_trip):
            tag = (f"{method}-small" + ("-csr" if as_input else "")
                   + (f"-cap{cap}" if cap else ""))
            kw = dict(method=method, max_cells_per_ident=cap)
            gpu, cpu, _ = _card_against_cpu(
                tag, ReclusterConfig(**kw), lambda data, cons, dev, omega:
                recluster_de_consensus_fast(data, cons, device=dev,
                                            omega=omega, **kw),
                as_input=as_input)
            gd, cd = gpu.de, cpu.de
            _seurat_logp_check(tag, gd.log_p.cpu().numpy(), cd.log_p.numpy())
            n_diff = int((gd.de_mask.cpu() != cd.de_mask).sum())
            log(f"[{tag}] DE calls {int(gd.de_mask.sum())} / "
                f"{int(cd.de_mask.sum())}; DE-mask differences {n_diff}")
            if n_diff:
                raise AssertionError(f"[{tag}] {n_diff} DE calls differ")
            if method == "roc":
                for k in ("auc", "power"):
                    d = float((gd.aux[k].cpu() - cd.aux[k]).abs().max())
                    log(f"[{tag}] {k} max |card - cpu| {d!r}")
                    # U is an exact integer or half on both devices
                    if d > 1e-6:
                        raise AssertionError(f"[{tag}] {k} differs by {d}")


def phase_full_seurat(data, truth, cons, wilcox_ref) -> dict:
    """bimod, t and roc at the 26k flagship. bimod and t: the card's
    (P, G) log p against the port's Seurat functions on the CPU from the
    same aggregates; roc: union, DE mask and log p identical to phase 7's
    Wilcoxon run. Returns the kernel's launches per method."""
    import torch

    from scconsensus_tpu_torch import recluster_de_consensus_fast
    from scconsensus_tpu_torch.de.engine import filter_clusters
    from scconsensus_tpu_torch.ops.gates import (
        ClusterAggregates,
        compute_aggregates_cid,
    )
    from scconsensus_tpu_torch.ops.seurat_tests import (
        bimod_lrt_pairs,
        welch_t_pairs,
    )

    names, cell_idx = filter_clusters(cons, 10)
    k = len(names)
    pi, pj = (torch.as_tensor(a, dtype=torch.int64)
              for a in np.triu_indices(k, 1))
    launches = {}
    for method in ("bimod", "t", "roc"):
        tag = f"{method}-full"
        res, launches[method] = _run_full(
            tag, lambda: recluster_de_consensus_fast(
                data, cons, method=method, device="cuda"), truth)
        de = res.de
        log(f"[{tag}] DE calls {int(de.de_mask.sum())} of "
            f"{int(de.tested.sum())} tested; log p = -inf "
            f"{int(torch.isneginf(de.log_p).sum())}")
        if method == "roc":
            lp, ref_lp = de.log_p.cpu().numpy(), wilcox_ref["log_p"]
            n_mask = int((de.de_mask.cpu().numpy()
                          != wilcox_ref["de_mask"]).sum())
            n_lp = int((~((lp == ref_lp) | (np.isnan(lp)
                                             & np.isnan(ref_lp)))).sum())
            same_union = np.array_equal(res.de_gene_union_idx,
                                        wilcox_ref["union"])
            log(f"[{tag}] against the Wilcoxon run: union identical "
                f"{same_union}, DE-mask differences {n_mask}, log p "
                f"differences {n_lp}")
            if not same_union or n_mask or n_lp:
                raise AssertionError(f"[{tag}] roc and wilcox differ")
            continue
        fn = bimod_lrt_pairs if method == "bimod" else welch_t_pairs
        agg = compute_aggregates_cid(
            data, torch.as_tensor(cell_idx, device="cuda"), k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = fn(agg, pi.cuda(), pj.cuda())
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        host = ClusterAggregates(*(getattr(agg, f).cpu() for f in (
            "sum_log", "sum_expm1", "sum_sq", "nnz", "counts")))
        # every pair for bimod; every 8th for t, whose betainc runs its
        # 200 Lentz steps over every entry of the batch (86 s for all 946
        # pairs on the card machine's host)
        rows = torch.arange(0, pi.numel(), 1 if method == "bimod" else 8)
        t0 = time.perf_counter()
        cpu = fn(host, pi[rows], pj[rows])
        t_cpu = time.perf_counter() - t0
        # the run's own log p is this card value wherever it was tested
        tested = de.tested
        same_run = torch.equal(card[tested], de.log_p[tested])
        log(f"[{tag}] {fn.__name__}: card {tuple(card.shape)} in "
            f"{t_card!r} s, cpu {tuple(cpu.shape)} in {t_cpu!r} s; the "
            f"run's tested log p bitwise this call's: {same_run}")
        if not same_run:
            raise AssertionError(f"[{tag}] the run's log p is not the "
                                 "card function's")
        _seurat_logp_check(tag, card[rows.cuda()].cpu().numpy(),
                           cpu.numpy())
    return launches


@contextlib.contextmanager
def _counting(module, names):
    """Count the calls of ``module``'s functions ``names`` (which the
    pipeline reads from its module) while the block runs."""
    calls = dict.fromkeys(names, 0)
    saved = {n: getattr(module, n) for n in names}

    def wrap(n):
        def counted(*a, **kw):
            calls[n] += 1
            return saved[n](*a, **kw)
        return counted

    for n in names:
        setattr(module, n, wrap(n))
    try:
        yield calls
    finally:
        for n, f in saved.items():
            setattr(module, n, f)


def _summary(res) -> dict:
    """What a later phase holds a full-size run to: the union, the DE
    mask and log p (host copies), the labels and silhouettes of every
    deepSplit, the wall."""
    return {"union": res.de_gene_union_idx,
            "de_mask": res.de.de_mask.cpu().numpy(),
            "log_p": res.de.log_p.cpu().numpy(),
            "labels": dict(res.dynamic_labels),
            "silhouettes": [i["silhouette"] for i in res.deep_split_info],
            "wall_s": res.metrics["wall_s"]}


def _same_bits(tag: str, res, ref: dict) -> None:
    """Union, labels at every deepSplit and silhouettes of ``res`` bit
    for bit those of the summary ``ref``."""
    if not np.array_equal(res.de_gene_union_idx, ref["union"]):
        raise AssertionError(f"[{tag}] unions differ")
    for key, want in ref["labels"].items():
        if not np.array_equal(res.dynamic_labels[key], want):
            raise AssertionError(f"[{tag}] {key}: labels differ")
    if [i["silhouette"] for i in res.deep_split_info] != ref["silhouettes"]:
        raise AssertionError(f"[{tag}] silhouettes differ")
    log(f"[{tag}] union, labels and silhouettes: the same bits")


def phase_resume(data, truth, cons, wilcox_ref) -> dict:
    """The fast Wilcoxon at 26k with an artifact store: its 12 files, a
    resume that runs no DE, tree or cut stage, a corrupt ``de.npz``
    quarantined and recomputed, a changed config refused. Returns the
    kernel's launches per run."""
    import shutil
    import tempfile

    from scconsensus_tpu_torch import recluster_de_consensus_fast
    from scconsensus_tpu_torch.models import pipeline

    stages = ("pairwise_de", "pca_scores", "ward_linkage", "cutree_hybrid")
    root = tempfile.mkdtemp(prefix="scc-store-")
    launches = {}

    def run(tag, engine, **kw):
        with _counting(pipeline, stages) as calls:
            res, launches[tag] = _run_full(
                tag, lambda: recluster_de_consensus_fast(
                    data, cons, device="cuda", artifact_dir=root, **kw),
                truth, engine=engine)
        log(f"[{tag}] stage computations: {json.dumps(calls)}")
        return res, calls

    try:
        stored, _ = run("resume-store", "native")
        files = sorted(os.listdir(root))
        sizes = {f: os.path.getsize(os.path.join(root, f)) for f in files}
        log(f"[resume-store] files (bytes): {json.dumps(sizes)}; total "
            f"{sum(sizes.values())}; wall {stored.metrics['wall_s']!r} s "
            f"against phase 7's {wilcox_ref['wall_s']!r} s")
        if files != STORE_FILES:
            raise AssertionError(f"[resume-store] files {files}")
        # the DE save is a stage of its own: the top-level stage walls
        # still account for the wall with a store on
        walls = stored.metrics["stage_walls_s"]
        top = sum(walls.get(k, 0.0) for k in TOP_STAGES)
        log(f"[resume-store] de_store {walls['de_store']!r} s; top-level "
            f"stage walls sum {top!r} s of the wall "
            f"{stored.metrics['wall_s']!r} s")
        _same_bits("resume-store", stored, wilcox_ref)
        # the store's own share for DE: the (P, G) fields to the host, the
        # compressed serialization and its checksum
        t0 = time.perf_counter()
        arrays, _ = stored.de.to_store()
        t_host = time.perf_counter() - t0
        t0 = time.perf_counter()
        buf = io.BytesIO()
        np.savez_compressed(buf, **arrays)
        t_zip = time.perf_counter() - t0
        t0 = time.perf_counter()
        hashlib.sha256(buf.getbuffer()).hexdigest()
        log(f"[resume-store] de artifact: to_store (device to host, "
            f"{sum(a.nbytes for a in arrays.values())} bytes) {t_host!r} s, "
            f"savez_compressed ({buf.tell()} bytes) {t_zip!r} s, sha256 "
            f"{time.perf_counter() - t0!r} s")
        del arrays, buf

        resumed, calls = run("resume", None)
        log(f"[resume] wall {resumed.metrics['wall_s']!r} s; stage walls "
            f"{json.dumps(resumed.metrics['stage_walls_s'])}")
        walls = resumed.metrics["stage_walls_s"]
        if any(calls.values()) or "de" in walls or "de_store" in walls:
            raise AssertionError("[resume] a stage was computed again")
        _same_bits("resume", resumed, _summary(stored))

        path = os.path.join(root, "de.npz")
        with open(path, "r+b") as f:
            f.seek(os.path.getsize(path) // 2)
            f.write(bytes(64))
        recomputed, calls = run("resume-corrupt-de", None)
        quarantined = sorted(n for n in os.listdir(root)
                             if ".quarantined-" in n)
        log(f"[resume-corrupt-de] quarantined {quarantined}")
        if quarantined != ["de.json.quarantined-0",
                           "de.npz.quarantined-0"] \
                or calls["pairwise_de"] != 1 \
                or calls["ward_linkage"] or calls["cutree_hybrid"]:
            raise AssertionError("[resume-corrupt-de] DE was not "
                                 "quarantined and recomputed alone")
        _same_bits("resume-corrupt-de", recomputed, _summary(stored))
        try:
            recluster_de_consensus_fast(data, cons, device="cuda",
                                        artifact_dir=root, q_val_thrs=0.05)
        except ValueError as e:
            log(f"[resume-config] a changed q_val_thrs is refused: {e}")
        else:
            raise AssertionError("[resume-config] a changed config ran")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


def phase_contract(data, cons, csr) -> None:
    """The input contract on the 26k matrix on the card: preflight's time,
    then a NaN in the dense matrix, an Inf among a CSR's stored values and
    NaN float labels, each refused by ``refine`` with the reference's
    check name before any stage runs."""
    import scipy.sparse as sp
    import torch

    from scconsensus_tpu_torch import ReclusterConfig, refine
    from scconsensus_tpu_torch.models import pipeline
    from scconsensus_tpu_torch.robust.contract import (
        InputContractError,
        preflight,
    )

    cfg = ReclusterConfig()
    preflight(data, cons, cfg)
    torch.cuda.synchronize()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        preflight(data, cons, cfg)
    ms = (time.perf_counter() - t0) / reps * 1e3
    finite_ms = _time_ms(lambda: torch.isfinite(data).all())
    log(f"[contract] preflight on {tuple(data.shape)} with "
        f"{len(cons)} labels: {ms!r} ms (host clock, {reps} calls); the "
        f"finite reduction alone {finite_ms!r} ms (device)")
    bad = data.clone()
    bad[3, 5] = float("nan")
    vals = csr.data.copy()
    vals[len(vals) // 2] = np.inf
    bad_csr = sp.csr_matrix((vals, csr.indices, csr.indptr), shape=csr.shape)
    nan_labels = np.unique(cons, return_inverse=True)[1].astype(np.float64)
    nan_labels[::100] = np.nan
    with _counting(pipeline, ("pairwise_de",)) as calls:
        for tag, x, labels, want in (
                ("dense-nan", bad, cons, "nonfinite_matrix"),
                ("csr-inf", bad_csr, cons, "nonfinite_matrix"),
                ("nan-labels", data, nan_labels, "nan_labels")):
            try:
                refine(x, labels, cfg, device="cuda")
            except InputContractError as e:
                log(f"[contract] {tag}: {e}")
                if e.check != want:
                    raise AssertionError(f"[contract] {tag}: {e.check}")
            else:
                raise AssertionError(f"[contract] {tag} was accepted")
    if calls["pairwise_de"]:
        raise AssertionError("[contract] a DE stage ran")


# phase 19: the atlas_query request shape of the reference bench
# (bench.py:1054-1056): 300 requests of 64 cells, 8 of them foreign,
# from 4 client threads
SERVE_REQUESTS, SERVE_CELLS, SERVE_OOD, SERVE_CLIENTS = 300, 64, 8, 4
# the reference's tie band for a replayed classify (robust/integrity.py
# TOLERANCES["replay_classify_d2"]): a label that differs is a tie when
# the chosen landmark is no more than 1e-3 further (relative, in d²)
TIE_BAND = 1e-3
# the reference's overhead guard (tests/test_serve.py:621-707): guarded
# wall over classify wall, best of 3
GUARD_LIMIT = 1.02


def _host_proj(model, x) -> np.ndarray:
    """Float64 projection of the cells x (n, G), as ``classify_host``
    takes it."""
    xp = model._gather_panel(x).astype(np.float64)
    return (xp - model.pca_mean.astype(np.float64)) @ \
        model.pca_components.astype(np.float64).T


def _host_d2(model, x) -> np.ndarray:
    """Float64 squared distances of the cells x (n, G) to every landmark,
    as ``classify_host`` takes them."""
    proj = _host_proj(model, x)
    c = model.centroids.astype(np.float64)
    return (np.sum(proj * proj, axis=1, keepdims=True) - 2.0 * proj @ c.T
            + np.sum(c * c, axis=1)[None, :])


def _cancellation_floor(model, x) -> np.ndarray:
    """Per cell, the float32 floor of a distance taken as
    sqrt(‖a‖² + ‖b‖² − 2ab): sqrt(4·eps·(‖a‖² + max ‖b‖²)) with a the
    projected cell and b a landmark. A cell sitting on its landmark (a
    landmark of one training cell) reads about this much, not 0 (the
    hazard both packages share, ROADMAP §C)."""
    proj = _host_proj(model, x)
    c2 = float(np.max(np.sum(model.centroids.astype(np.float64) ** 2, 1)))
    eps = float(np.finfo(np.float32).eps)
    return np.sqrt(4.0 * eps * (np.sum(proj * proj, axis=1) + c2))


def _outside_tie_band(model, x, got, ref_d2) -> int:
    """Cells whose label ``got`` differs from the reference choice by
    more than the tie band: the nearest landmark carrying ``got`` is
    further than ``ref_d2`` by more than TIE_BAND relative."""
    d2 = _host_d2(model, x)
    clab = model.centroid_labels
    bad = 0
    for r in range(got.size):
        cands = np.nonzero(clab == got[r])[0]
        chosen = float(d2[r, cands].min()) if cands.size else float("inf")
        if abs(chosen - ref_d2[r]) > TIE_BAND * max(abs(ref_d2[r]), 1e-9):
            bad += 1
    return bad


def _serve_traffic(model, data, ledger_path: str):
    """The request stream through ``ConsensusServer`` from 4 client
    threads: the in-distribution requests are seeded samples of the 26k
    matrix's cells, the foreign ones drawn as ``make_requests`` draws
    them. Returns the requests, their cell indices (None for foreign),
    the responses, the section and the client-side wall."""
    import threading

    import torch

    from scconsensus_tpu_torch import ConsensusServer
    from scconsensus_tpu_torch.serve.driver import ServeConfig
    from scconsensus_tpu_torch.serve.soak import ood_cells

    rng = np.random.default_rng(19)
    n_genes, n_cells = data.shape
    ood_at = set(np.linspace(0, SERVE_REQUESTS - 1, SERVE_OOD)
                 .astype(int).tolist())
    requests, cell_idx = [], []
    for i in range(SERVE_REQUESTS):
        if i in ood_at:
            requests.append(ood_cells(rng, SERVE_CELLS, n_genes))
            cell_idx.append(None)
        else:
            idx = rng.choice(n_cells, size=SERVE_CELLS, replace=False)
            cols = torch.as_tensor(idx, device=data.device)
            requests.append(
                data.index_select(1, cols).T.contiguous().cpu().numpy())
            cell_idx.append(idx)
    responses = [None] * SERVE_REQUESTS
    nxt = iter(range(SERVE_REQUESTS))
    lock = threading.Lock()
    server = ConsensusServer(model, ServeConfig(quarantine_path=ledger_path),
                             device="cuda")

    def client():
        while True:
            with lock:
                i = next(nxt, None)
            if i is None:
                return
            responses[i] = server.classify(requests[i], timeout=120.0)

    with server:
        threads = [threading.Thread(target=client)
                   for _ in range(SERVE_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        section = server.serving_section()
    return requests, cell_idx, responses, section, wall


def _classify_split(model, x, reps: int = 20) -> dict:
    """Mean ms of each part of ``model.classify(x)``: the host panel
    gather, host→device, the device part (CUDA events) and device→host."""
    import torch

    parts = dict.fromkeys(("gather", "h2d", "device", "d2h"), 0.0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    model.classify(x)
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        xp = model._gather_panel(x)
        parts["gather"] += time.perf_counter() - t
        t = time.perf_counter()
        xd = model._to_device(xp)
        torch.cuda.synchronize()
        parts["h2d"] += time.perf_counter() - t
        start.record()
        packed = model._classify_device(xd)
        end.record()
        end.synchronize()
        parts["device"] += start.elapsed_time(end) / 1e3
        t = time.perf_counter()
        model._to_host(packed)
        parts["d2h"] += time.perf_counter() - t
    return {k: v / reps * 1e3 for k, v in parts.items()}


def _wall_ms(fn, reps: int = 20) -> float:
    """Median host wall of fn() in ms, after a warm-up call."""
    fn()
    walls = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t)
    return float(np.median(walls)) * 1e3


def _serve_faults(model, root: str, request) -> None:
    """The breaker, a real allocation failure and a corrupt model (a copy
    of ``root``/model), each held by an assertion."""
    import shutil

    import torch

    from scconsensus_tpu_torch import ConsensusServer, load_consensus_model
    from scconsensus_tpu_torch.robust import faults, record
    from scconsensus_tpu_torch.robust.retry import (
        classify_exception,
        classify_text,
    )
    from scconsensus_tpu_torch.serve.driver import ServeConfig
    from scconsensus_tpu_torch.serve.errors import ModelLoadError
    from scconsensus_tpu_torch.serve.metrics import validate_serving
    from scconsensus_tpu_torch.serve.model import MODEL_STAGE

    # three injected allocation failures at the device call trip the
    # breaker (threshold 3); after the cooldown a probe closes it
    plan = os.path.join(root, "plan.json")
    with open(plan, "w") as f:
        json.dump({"faults": [{"site": "serve_device", "class": "oom",
                               "times": 3}]}, f)
    os.environ["SCC_FAULT_PLAN"] = plan
    faults.reset()
    record.begin_run()
    try:
        cfg = ServeConfig(breaker_cooldown_s=0.2)
        with ConsensusServer(model, cfg, device="cuda") as srv:
            r1 = srv.classify(request, timeout=60.0)
            time.sleep(0.25)
            r2 = srv.classify(request, timeout=60.0)
        sec = srv.serving_section()
    finally:
        del os.environ["SCC_FAULT_PLAN"]
        faults.reset()
    validate_serving(sec)
    rb = record.section()
    log(f"[serve-faults] oom x3 at serve_device: first response "
        f"{r1.outcome} (degraded {r1.degraded}), after the 0.2 s cooldown "
        f"{r2.outcome}; breaker {json.dumps(sec['breaker'])}; robustness "
        f"faults {len(rb['faults_injected'])}, degradations "
        f"{[d['action'] for d in rb['degradations']]}")
    assert r1.outcome == "degraded" and r1.degraded, r1.outcome
    assert np.array_equal(r1.labels, model.classify_host(request)[0])
    assert r2.outcome == "ok" and not r2.degraded, r2.outcome
    assert sec["breaker"]["state"] == "closed"
    assert sec["breaker"]["trips"] == 1
    assert sec["requests"]["degraded"] == 1 and sec["requests"]["ok"] == 1
    assert len(rb["faults_injected"]) == 3
    assert rb["degradations"][0]["action"] == "host-fallback"

    # a real allocation past the card's memory
    total = torch.cuda.get_device_properties(0).total_memory
    try:
        torch.empty(total // 4 + (1 << 28), dtype=torch.float32,
                    device="cuda")
    except Exception as e:  # noqa: BLE001 - the class is the assertion
        cls, text_cls = classify_exception(e), classify_text(str(e))
        log(f"[serve-faults] {type(e).__name__} for {total} bytes + 1 GiB "
            f"classified {cls!r} (its text alone: {text_cls!r})")
        assert cls == "resource" and text_cls == "resource", (cls, text_cls)
    else:
        raise AssertionError("[serve-faults] an allocation past the card's "
                             "memory succeeded")
    torch.cuda.empty_cache()

    # a corrupt model: the readonly store refuses it in place, the
    # default store quarantines it; neither serves
    bad_dir = os.path.join(root, "corrupt-model")
    shutil.copytree(os.path.join(root, "model"), bad_dir)
    npz = os.path.join(bad_dir, f"{MODEL_STAGE}.npz")
    with open(npz, "r+b") as f:
        f.seek(os.path.getsize(npz) // 2)
        b = f.read(1)
        f.seek(os.path.getsize(npz) // 2)
        f.write(bytes([b[0] ^ 0xFF]))
    try:
        load_consensus_model(bad_dir, readonly=True, device="cuda")
    except ModelLoadError as e:
        assert not e.quarantined and os.path.exists(npz), "renamed"
        log(f"[serve-faults] readonly store: refused in place: {e}")
    else:
        raise AssertionError("[serve-faults] a corrupt model loaded")
    try:
        ConsensusServer(bad_dir, device="cuda")
    except ModelLoadError as e:
        moved = sorted(n for n in os.listdir(bad_dir) if "quarantined" in n)
        assert e.quarantined and not os.path.exists(npz), moved
        assert f"{MODEL_STAGE}.npz.quarantined-0" in moved, moved
        log(f"[serve-faults] default store: refused and quarantined "
            f"{moved}")
    else:
        raise AssertionError("[serve-faults] a server started on a "
                             "corrupt model")


def _take_gather(model, cells) -> np.ndarray:
    """The panel gather as ``np.take(x, panel, axis=1)``, which writes
    contiguous rows at once (the shipped gather is the reference's
    ``x[:, panel]``, a transposed view copied before the upload)."""
    return np.take(np.asarray(cells, np.float32), model.panel_idx, axis=1)


def _gather_forms(model, x) -> dict:
    """Host ms of the shipped gather with its contiguous copy, and of
    ``np.take``, on the cells x."""
    x = np.asarray(x, np.float32)
    return {"shipped": _wall_ms(lambda: np.ascontiguousarray(
                x[:, model.panel_idx])),
            "np.take": _wall_ms(lambda: _take_gather(model, x))}


def _guard_ratio(take: bool = False) -> float:
    """The reference's overhead guard (tests/test_serve.py:621-707) on
    the card: a production-shaped model (2,000 genes, a 1,500-gene
    panel, 32 PCs, 512 landmarks), eight 2,048-cell requests driven one
    at a time through the driver's batch path; guarded wall over the
    driver's own classify wall, best of 3 after a warm-up pass. With
    ``take`` the model gathers with ``np.take`` (measured, not shipped)."""
    import types

    from scconsensus_tpu_torch import ConsensusServer
    from scconsensus_tpu_torch.serve.driver import RequestHandle, ServeConfig
    from scconsensus_tpu_torch.serve.model import ConsensusModel

    rng = np.random.default_rng(0)
    G, F, P, K = 2000, 1500, 32, 512
    model = ConsensusModel(
        panel_idx=np.sort(rng.choice(G, F, replace=False)).astype(np.int64),
        pca_mean=rng.normal(size=F).astype(np.float32),
        pca_components=rng.normal(size=(P, F)).astype(np.float32),
        centroids=rng.normal(size=(K, P)).astype(np.float32),
        centroid_labels=rng.integers(1, 9, K).astype(np.int64),
        centroid_counts=np.ones(K, np.int64),
        tree_merge=np.zeros((K - 1, 2)), tree_height=np.zeros(K - 1),
        tree_order=np.arange(K), calib_q=np.array([1.0, 2.0, 3.0, 4.0]),
        drift_threshold=float("inf"), meta={"n_genes": G, "deep_split": 2},
        device="cuda")
    if take:
        model._gather_panel = types.MethodType(_take_gather, model)
    rng = np.random.default_rng(1)
    reqs = [rng.normal(size=(2048, G)).astype(np.float32) for _ in range(8)]
    model.classify(reqs[0])
    if take:
        log(f"[serve-guard] gather ms at 2,048 x 2,000 -> 1,500: "
            f"{json.dumps(_gather_forms(model, reqs[1]))}")
    ratios = []
    # one unmeasured pass first: the host's first passes over fresh
    # buffers run several times slower than the steady state
    for rep in range(4):
        srv = ConsensusServer(model, ServeConfig(
            max_batch_cells=2048, queue_capacity=64, batch_window_s=0.0,
            default_deadline_s=10.0, breaker_threshold=3,
            breaker_cooldown_s=0.2, drift_quarantine_frac=0.5),
            device="cuda")
        t0 = time.perf_counter()
        for i, x in enumerate(reqs):
            r = RequestHandle(i, x, time.monotonic() + 30.0)
            srv._process([r])
            assert r.result(0).outcome == "ok"
        guarded = time.perf_counter() - t0
        assert srv.stats.breaker_trips == 0
        log(f"[serve-guard] {'np.take ' if take else ''}"
            f"{'warm-up' if rep == 0 else 'measured'}: "
            f"guarded {guarded!r} s, classify {srv.stats.classify_wall_s!r} "
            "s")
        if rep:
            ratios.append(guarded / srv.stats.classify_wall_s)
    return min(ratios)


def phase_serve(data, res) -> int:
    """Phase 19: the serving path at the 26k flagship. Export a model from
    phase 7's result, serve the atlas_query stream through the guarded
    driver, hold the labels against the calibration and the host mirror,
    trip the breaker, fail an allocation and refuse a corrupt model,
    measure the guard's cost; returns the kernel's launches while
    serving (classify launches none)."""
    import shutil
    import tempfile

    import torch

    from scconsensus_tpu_torch import (
        ReclusterConfig,
        export_consensus_model,
        load_consensus_model,
    )
    from scconsensus_tpu_torch.ops.cuda_kernels import distance_cluster_sums
    from scconsensus_tpu_torch.ops.distance import sq_dists
    from scconsensus_tpu_torch.ops.pooling import landmark_k_policy
    from scconsensus_tpu_torch.serve.driver import QUARANTINE_LEDGER_NAME
    from scconsensus_tpu_torch.serve.metrics import validate_serving
    from scconsensus_tpu_torch.serve.model import MODEL_STAGE, training_cells

    root = tempfile.mkdtemp(prefix="scc-serve-")
    model_dir = os.path.join(root, "model")
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = export_consensus_model(data, res, ReclusterConfig(),
                                       model_dir, device="cuda")
        torch.cuda.synchronize()
        t_export = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(model_dir, f))
                     for f in os.listdir(model_dir))
        t0 = time.perf_counter()
        loaded = load_consensus_model(model_dir, device="cuda")
        t_load = time.perf_counter() - t0
        log(f"[serve] export {t_export!r} s, load {t_load!r} s; artifact "
            f"{nbytes} bytes; fingerprint {model.fingerprint()}; panel "
            f"{model.panel_idx.size}, {model.n_pcs} PCs, {model.k} "
            f"landmarks; drift threshold {model.drift_threshold!r}")
        assert loaded.fingerprint() == model.fingerprint()
        assert np.array_equal(model.panel_idx, res.de_gene_union_idx)
        assert model.k == landmark_k_policy(data.shape[1]), model.k
        model = loaded

        # each training cell's landmark, by the export's own projection
        # and nearest-landmark pass on the card
        mean, comps, cents, _ = model.device_buffers()
        emb = (training_cells(data, model.panel_idx, mean.device)
               - mean[None, :]) @ comps.T
        d2 = sq_dists(emb, cents)
        assign = torch.argmin(d2, dim=1)
        calib_d2 = torch.gather(d2, 1, assign[:, None])[:, 0].cpu().numpy()
        assign = assign.cpu().numpy()
        del emb, d2

        distance_cluster_sums.launches = 0
        reqs, cell_idx, resps, sec, wall = _serve_traffic(
            model, data, os.path.join(root, QUARANTINE_LEDGER_NAME))
        launches = distance_cluster_sums.launches
        validate_serving(sec)
        _FACTS["serve_cells_per_s"] = SERVE_REQUESTS * SERVE_CELLS / wall
        n_in = sum(i is not None for i in cell_idx)
        req, lat, bat = sec["requests"], sec["latency_ms"], sec["batches"]
        log(f"[serve] {SERVE_REQUESTS} requests x {SERVE_CELLS} cells from "
            f"{SERVE_CLIENTS} clients in {wall!r} s: "
            f"{SERVE_REQUESTS / wall!r} requests/s, "
            f"{SERVE_REQUESTS * SERVE_CELLS / wall!r} cells/s; latency ms "
            f"p50 {lat['p50']!r} p99 {lat['p99']!r} max {lat['max']!r}; "
            f"batches {bat['count']} of mean {bat['mean_cells']!r} cells "
            f"(max {bat['max_cells']}); classify wall "
            f"{sec['classify_wall_s']!r} s in all; outcomes "
            f"{json.dumps({k: v for k, v in req.items() if v})}; breaker "
            f"{json.dumps(sec['breaker'])}; kernel launches {launches}")
        assert req["ok"] == n_in and req["quarantined"] == SERVE_OOD
        assert req["degraded"] == 0 and sec["breaker"]["trips"] == 0
        assert req["submitted"] == SERVE_REQUESTS
        for r, idx in zip(resps, cell_idx):
            assert r.quarantined == (idx is None), r.outcome
        with open(os.path.join(root, QUARANTINE_LEDGER_NAME)) as f:
            rows = [json.loads(ln) for ln in f if ln.strip()]
        assert len(rows) == SERVE_OOD, len(rows)

        # the replayed cells against their calibration, and the device
        # against the host mirror, under the reference's tie band
        x = np.concatenate([q for q, i in zip(reqs, cell_idx)
                            if i is not None])
        idx = np.concatenate([i for i in cell_idx if i is not None])
        got = np.concatenate([r.labels for r, i in zip(resps, cell_idx)
                              if i is not None])
        dist = np.concatenate([r.distances for r, i in zip(resps, cell_idx)
                               if i is not None])
        want = model.centroid_labels[assign[idx]]
        off = got != want
        off_calib = _outside_tie_band(model, x[off], got[off],
                                      _host_d2(model, x[off])[
                                          np.arange(int(off.sum())),
                                          assign[idx][off]])
        h_lab, h_dist = model.classify_host(x)
        off_h = got != h_lab
        hd2 = _host_d2(model, x[off_h])
        off_host = _outside_tie_band(model, x[off_h], got[off_h],
                                     hd2.min(axis=1))
        floor = _cancellation_floor(model, x)
        err = np.abs(dist - h_dist)
        above = h_dist > 10.0 * floor
        n_out = int((err > 1e-3 * h_dist + floor).sum())
        log(f"[serve] {got.size} replayed cells: {int(off.sum())} off their "
            f"calibrated landmark's label, {off_calib} of them outside the "
            f"tie band; against classify_host {int(off_h.sum())} labels "
            f"differ, {off_host} outside the band; distances: max relative "
            f"difference {float((err / h_dist)[above].max())!r} over the "
            f"{int(above.sum())} cells above 10x the float32 cancellation "
            f"floor (largest floor {float(floor.max())!r}), {n_out} cells "
            f"outside 1e-3 relative + the floor")
        assert off_calib == 0 and off_host == 0
        assert n_out == 0

        # where the classify wall goes, and a bare batch card against CPU
        mean_cells = max(int(round(bat["mean_cells"])), 1)
        split = _classify_split(model, x[:mean_cells])
        x512 = x[:512]
        cpu_model = model.to("cpu")
        card_ms = _wall_ms(lambda: model.classify(x512))
        cpu_ms = _wall_ms(lambda: cpu_model.classify(x512))
        log(f"[serve] classify split at the mean batch ({mean_cells} "
            f"cells), ms: {json.dumps(split)}; driver's classify wall per "
            f"batch {sec['classify_wall_s'] / bat['count'] * 1e3!r} ms; "
            f"bare 512-cell classify {card_ms!r} ms on the card, "
            f"{cpu_ms!r} ms on the CPU")

        _serve_faults(model, root, reqs[0 if cell_idx[0] is not None
                                        else 1])
        ratio = _guard_ratio()
        log(f"[serve-guard] guarded / classify wall, best of 3: {ratio!r} "
            f"(limit {GUARD_LIMIT})")
        assert ratio < GUARD_LIMIT, ratio
        # the faster gather, measured for the record: it shortens the
        # classify, so the same guard is a larger share of it
        log(f"[serve-guard] with the np.take gather (not shipped): "
            f"{_guard_ratio(take=True)!r}; gather ms at the mean batch: "
            f"{json.dumps(_gather_forms(model, x[:mean_cells]))}")
        _serve_audited(model, data, root)
        log(f"[serve] peak device memory {torch.cuda.max_memory_allocated()}"
            " bytes")
        _serve_soak_record(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


def _serve_soak_record(root: str) -> None:
    """The serve soak worker's run on the card (its demo model, 24
    requests of 16 cells from 4 clients): every request resolved, and
    the summary's run record, with its ``serving`` section, validates."""
    from scconsensus_tpu_torch.obs.export import validate_run_record
    from scconsensus_tpu_torch.serve.soak import run_soak

    t0 = time.perf_counter()
    summary = run_soak(os.path.join(root, "soak-model"), device="cuda")
    validate_run_record(summary["record"])
    if not summary["ok"]:
        raise AssertionError("[serve-soak] a request was not resolved")
    sv = summary["record"]["serving"]
    log(f"[serve-soak] {summary['requests']} requests in "
        f"{time.perf_counter() - t0!r} s (model built "
        f"{summary['model_built']}); outcomes "
        f"{json.dumps(summary['outcome_counts'])}; p99 "
        f"{(sv.get('latency_ms') or {}).get('p99')!r} ms; run record "
        "validates")


def _serve_audited(model, data, root: str) -> None:
    """Phase 21 (f): the stream again under SCC_INTEGRITY=audit, with 0
    replay mismatches, then a serve_classify corruption the replay
    catches."""
    from scconsensus_tpu_torch import ConsensusServer
    from scconsensus_tpu_torch.robust import integrity
    from scconsensus_tpu_torch.serve.driver import QUARANTINE_LEDGER_NAME

    with _env(SCC_INTEGRITY="audit"):
        integrity.begin_run()
        reqs, cell_idx, resps, sec, wall = _serve_traffic(
            model, data, os.path.join(root, "audit-" +
                                      QUARANTINE_LEDGER_NAME))
        ig = integrity.section()
        log(f"[serve-audit] {SERVE_REQUESTS} requests in {wall!r} s "
            f"({SERVE_REQUESTS * SERVE_CELLS / wall!r} cells/s); latency "
            f"ms p50 {sec['latency_ms']['p50']!r} p99 "
            f"{sec['latency_ms']['p99']!r}; ghost replays "
            f"{json.dumps({k: ig['ghost'][k] for k in ('planned', 'run', 'passed')})}"
            f", integrity consumed {ig['consumed_s']!r} s")
        if not ig["all_checks_passed"] or ig["ghost"]["mismatches"] \
                or ig["ghost"]["run"] < 1 \
                or sec["requests"]["submitted"] != SERVE_REQUESTS:
            raise AssertionError("[serve-audit] a replay disagreed")
    request = reqs[0 if cell_idx[0] is not None else 1]
    plan = _write_plan(root, [{"site": "serve_classify",
                               "class": "corruption"}])
    with _env(SCC_INTEGRITY="audit", SCC_FAULT_PLAN=plan):
        integrity.begin_run()
        with ConsensusServer(model, device="cuda") as srv:
            srv.classify(request, timeout=60.0)
        ig = integrity.section()
    log(f"[serve-audit] a serve_classify corruption: detected by "
        f"{_detected_by(ig)}")
    if _detected_by(ig) != ["replay_classify_d2"]:
        raise AssertionError("[serve-audit] the corruption went unseen")



@contextlib.contextmanager
def _consumed_by_site():
    """The robustness layer's ``consumed_s`` split by the line of each
    timed block, for the block's duration (a dict filled as it runs)."""
    import traceback

    from scconsensus_tpu_torch.robust import record as robust_record

    by_site: dict = {}
    real = robust_record.add_consumed

    def add(dt):
        frame = traceback.extract_stack(limit=3)[0]
        key = f"{os.path.basename(frame.filename)}:{frame.lineno}"
        by_site[key] = by_site.get(key, 0.0) + dt
        real(dt)

    robust_record.add_consumed = add
    try:
        yield by_site
    finally:
        robust_record.add_consumed = real


@contextlib.contextmanager
def _env(**kw):
    """Set environment flags for the block; the fault plan's cache starts
    fresh."""
    from scconsensus_tpu_torch.robust import faults

    saved = {k: os.environ.get(k) for k in kw}
    os.environ.update({k: str(v) for k, v in kw.items()})
    faults.reset()
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        faults.reset()


def _write_plan(root: str, rules, name: str = "plan.json") -> str:
    path = os.path.join(root, name)
    with open(path, "w") as f:
        json.dump({"faults": rules}, f)
    return path


def _detected_by(section) -> list:
    """The check names that caught something on an integrity section."""
    return sorted({v["check"] for v in section["violations"]}
                  | {m["check"] for m in section["ghost"]["mismatches"]})


def _same_quality(tag: str, a: dict, b: dict) -> None:
    """Two ``quality`` sections, card against CPU: the funnel, the
    ladder, the numeric health and the cluster sizes identical, ARIs and
    entropies within 1e-12, silhouettes within 1e-4."""
    if a["de_funnel"] != b["de_funnel"]:
        raise AssertionError(f"[{tag}] DE funnels differ")
    if a.get("wilcox_ladder") != b.get("wilcox_ladder"):
        raise AssertionError(f"[{tag}] window ladders differ")
    if a["numeric_health"] != b["numeric_health"]:
        raise AssertionError(f"[{tag}] numeric health differs")
    ca, cb = a["cluster_structure"], b["cluster_structure"]
    for ka, kb in ((ca.get("ari_vs_input"), cb.get("ari_vs_input")),
                   ({str(i): c["ari"] for i, c in enumerate(ca["churn"])},
                    {str(i): c["ari"] for i, c in enumerate(cb["churn"])})):
        if ka.keys() != kb.keys() or any(abs(ka[k] - kb[k]) > 1e-12
                                         for k in ka):
            raise AssertionError(f"[{tag}] ARIs differ: {ka} {kb}")
    for x, y in zip(ca["cuts"], cb["cuts"], strict=True):
        for k in ("n_clusters", "n_unassigned", "sizes"):
            if x[k] != y[k]:
                raise AssertionError(f"[{tag}] {x['cut']}: {k} differs")
        if abs(x["contingency_entropy"] - y["contingency_entropy"]) > 1e-12 \
                or abs(x["silhouette"] - y["silhouette"]) > 1e-4:
            raise AssertionError(f"[{tag}] {x['cut']}: entropy or "
                                 "silhouette differs")
    log(f"[{tag}] quality sections agree: funnel "
        f"{json.dumps(a['de_funnel']['total'])}, ARI vs input "
        f"{json.dumps(ca.get('ari_vs_input'))}")


def phase_guard_small() -> None:
    """Phase 20: the guard rails at 2k, card against CPU, fast Wilcoxon
    and edgeR: the quality sections agree; under SCC_INTEGRITY=audit both
    devices run the same checks and replays with 0 mismatches; under
    enforce a corruption on each path's DE (the Wilcoxon ladder's
    wilcox_bucket_out, edgeR's bh_logq) is detected and recomputed to the
    unfaulted run's bits."""
    import shutil
    import tempfile

    from scconsensus_tpu_torch import (
        ReclusterConfig,
        recluster_de_consensus,
        refine,
    )

    fast_cfg = ReclusterConfig()
    edger_cfg = ReclusterConfig(method="edger", q_val_thrs=0.01,
                                log_fc_thrs=math.log(2.0),
                                mean_scaling_factor=2.0)
    # each path with the corruption site its DE runs through: the
    # Wilcoxon ladder's bucket output, edgeR's BH
    runs = {
        "guard-small": (fast_cfg, lambda data, cons, dev, omega: refine(
            data, cons, fast_cfg, device=dev, omega=omega),
            "wilcox_bucket_out"),
        "guard-small-edger": (edger_cfg, lambda data, cons, dev, omega:
                              recluster_de_consensus(
                                  data, cons, device=dev, omega=omega,
                                  **EDGER_KW), "bh_logq"),
    }
    root = tempfile.mkdtemp(prefix="scc-guard-")
    try:
        for tag, (cfg, run, site) in runs.items():
            with _env(SCC_INTEGRITY="audit", SCC_OBS_NUMERIC="1"):
                gpu, cpu, omega = _card_against_cpu(tag, cfg, run)
            _same_quality(tag, gpu.metrics["quality"],
                          cpu.metrics["quality"])
            ig, ic = gpu.metrics["integrity"], cpu.metrics["integrity"]
            for k in ("checks", "per_check"):
                if ig[k] != ic[k]:
                    raise AssertionError(f"[{tag}] integrity {k} differ")
            for k in ("planned", "run", "passed"):
                if ig["ghost"][k] != ic["ghost"][k]:
                    raise AssertionError(f"[{tag}] ghost {k} differ")
            if not (ig["all_checks_passed"] and ic["all_checks_passed"]) \
                    or ig["ghost"]["mismatches"] or ic["ghost"]["mismatches"]:
                raise AssertionError(f"[{tag}] an integrity check failed")
            log(f"[{tag}] audit on both devices: checks "
                f"{json.dumps(ig['checks'])}, ghost replays "
                f"{ig['ghost']['run']} with 0 mismatches; "
                f"{json.dumps(ig['per_check'])}")
            plan = _write_plan(root, [{"site": site,
                                       "class": "corruption",
                                       "mode": "signflip"}])
            data, cons = _small_data()
            with _env(SCC_INTEGRITY="enforce", SCC_FAULT_PLAN=plan):
                faulted = run(data, cons, "cuda", omega)
            fig = faulted.metrics["integrity"]
            rb = faulted.metrics["robustness"]
            recovered = [r for r in rb["retries"]
                         if r["error_class"] == "silent_corruption"
                         and r["recovered"]]
            log(f"[{tag}] enforce with a {site} corruption: "
                f"detected by {_detected_by(fig)}, recomputes "
                f"{fig['ghost']['recomputes']}, retries "
                f"{json.dumps(recovered)}")
            if not _detected_by(fig) or not recovered \
                    or fig["ghost"]["recomputes"] < 1:
                raise AssertionError(f"[{tag}] the corruption was not "
                                     "detected and recomputed")
            _same_bits(f"{tag}-enforce", faulted, {
                "union": gpu.de_gene_union_idx,
                "labels": dict(gpu.dynamic_labels),
                "silhouettes": [i["silhouette"]
                                for i in gpu.deep_split_info]})
            if not np.array_equal(faulted.de.de_mask.cpu().numpy(),
                                  gpu.de.de_mask.cpu().numpy()):
                raise AssertionError(f"[{tag}-enforce] DE masks differ")
    finally:
        shutil.rmtree(root, ignore_errors=True)


_KILL_CHILD = """
import sys
sys.path.insert(0, {repo!r})
import chip_smoke
from scconsensus_tpu_torch import recluster_de_consensus_fast

data, truth, cons = chip_smoke.phase_full_data()
recluster_de_consensus_fast(data, cons, device="cuda",
                            artifact_dir={store!r})
print("UNEXPECTED: the run survived a kill fault")
"""


def phase_guarded(data, truth, cons, wilcox_ref, n_buckets: int) -> dict:
    """Phase 21: the guarded 26k flagship (fast Wilcoxon), each run held
    to phase 7's bits: (a) audit with the numeric sentinels, best of 2,
    each layer's share of the wall; (b) a stage:embed OOM and a
    stage:tree transient fault, both recovered; (c) enforce with a
    wilcox_bucket_out and a bh_logq corruption, both detected and
    recomputed; (d) a child process killed at wilcox_bucket after half
    the ladder (started with the phase, so it runs beside (a)-(c)),
    resumed here from its finished buckets; (e) the robustness layer's
    share of that stored run. Returns the kernel's launches per run."""
    import shutil
    import tempfile

    import torch

    from scconsensus_tpu_torch import recluster_de_consensus_fast
    from scconsensus_tpu_torch.obs import quality
    from scconsensus_tpu_torch.robust import faults, integrity
    from scconsensus_tpu_torch.robust import record as robust_record
    from scconsensus_tpu_torch.utils.artifacts import ArtifactStore

    launches = {}
    root = tempfile.mkdtemp(prefix="scc-guarded-")

    def run(tag, **kw):
        res, launches[tag] = _run_full(
            tag, lambda: recluster_de_consensus_fast(
                data, cons, device="cuda", **kw), truth)
        if launches[tag] != 1:
            raise AssertionError(f"[{tag}] {launches[tag]} kernel launches")
        _same_bits(tag, res, wilcox_ref)
        return res

    # (d)'s child, killed at wilcox_bucket after half the ladder: started
    # now, collected at (d)
    store = os.path.join(root, "store")
    killed_at = n_buckets // 2
    plan = _write_plan(root, [{"site": "wilcox_bucket",
                               "class": "kill", "after": killed_at}],
                       name="kill.json")
    t0 = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, "-c", _KILL_CHILD.format(repo=REPO, store=store)],
        env=dict(os.environ, SCC_FAULT_PLAN=plan), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        # (a) audit + numeric sentinels, best of 2
        shares = []
        with _env(SCC_INTEGRITY="audit", SCC_OBS_NUMERIC="1"):
            for i in range(2):
                quality.reset_cpu()
                res = run(f"guarded-audit-{i}")
                wall = res.metrics["wall_s"]
                ig, q = res.metrics["integrity"], res.metrics["quality"]
                ig_s = integrity.current().consumed_s
                q_s = quality.consumed_cpu_s()
                shares.append((ig_s / wall, q_s / wall))
                log(f"[guarded-audit-{i}] wall {wall!r} s; integrity "
                    f"consumed {ig_s!r} s ({ig_s / wall!r} of the wall), "
                    f"quality {q_s!r} s ({q_s / wall!r}); checks "
                    f"{json.dumps(ig['checks'])}, ghost replays "
                    f"{ig['ghost']['run']} ({json.dumps(ig['per_check'])});"
                    f" numeric checks {q['numeric_health']['checks']}, "
                    f"trips {len(q['numeric_health']['trips'])}; funnel "
                    f"{json.dumps(q['de_funnel']['total'])}")
                if not ig["all_checks_passed"] or \
                        q["numeric_health"]["trips"]:
                    raise AssertionError(f"[guarded-audit-{i}] a check "
                                         "failed")
                _quality_share(f"guarded-audit-{i}", res.metrics)
        ig_share = min(s[0] for s in shares)
        q_share = min(s[1] for s in shares)
        log(f"[guarded-audit] best of 2: integrity {ig_share!r}, quality "
            f"{q_share!r} of the wall (limit {LAYER_SHARE_LIMIT})")
        if not (ig_share < LAYER_SHARE_LIMIT and q_share < LAYER_SHARE_LIMIT):
            raise AssertionError("[guarded-audit] a layer costs 2 % or "
                                 "more of the wall")

        # (b) two stage faults, recovered in the process
        plan = _write_plan(root, [
            {"site": "stage:embed", "class": "oom"},
            {"site": "stage:tree", "class": "transient"}])
        with _env(SCC_FAULT_PLAN=plan):
            res = run("guarded-faults")
        rb = res.metrics["robustness"]
        log(f"[guarded-faults] retries {json.dumps(rb['retries'])}; "
            f"degradations {json.dumps(rb['degradations'])}")
        if sorted((r["site"], r["error_class"]) for r in rb["retries"]
                  if r["recovered"]) != [("stage:embed", "resource"),
                                         ("stage:tree", "transient")]:
            raise AssertionError("[guarded-faults] the two faults were not "
                                 "both recovered")

        # (c) enforce: two corruptions, both detected and recomputed
        plan = _write_plan(root, [
            {"site": "wilcox_bucket_out", "class": "corruption",
             "mode": "signflip"},
            {"site": "bh_logq", "class": "corruption", "mode": "signflip"}])
        with _env(SCC_INTEGRITY="enforce", SCC_FAULT_PLAN=plan):
            res = run("guarded-enforce")
        ig = res.metrics["integrity"]
        rb = res.metrics["robustness"]
        sites = sorted(r["site"] for r in rb["retries"]
                       if r["error_class"] == "silent_corruption"
                       and r["recovered"])
        log(f"[guarded-enforce] detected by {_detected_by(ig)}; recovered "
            f"silent_corruption retries at {sites}; recomputes "
            f"{ig['ghost']['recomputes']}")
        if "bh_monotonic" not in _detected_by(ig) or len(
                _detected_by(ig)) < 2 or sites != ["stage:de",
                                                   "wilcox_bucket"] \
                or ig["ghost"]["recomputes"] < 2:
            raise AssertionError("[guarded-enforce] a corruption was not "
                                 "detected and recomputed")

        # (d) the child killed at wilcox_bucket after half the ladder;
        # resume here from the finished buckets
        _, err = child.communicate(timeout=600)
        t_child = time.perf_counter() - t0
        blocks = sorted(n for n in os.listdir(store)
                        if n.startswith("de_wilcox_") and n.endswith(".npz"))
        log(f"[guarded-kill] child exit {child.returncode} after "
            f"{t_child!r} s from the phase's start; {len(blocks)} of "
            f"{n_buckets} buckets stored "
            f"({sum(os.path.getsize(os.path.join(store, b)) for b in blocks)}"
            " bytes)")
        if child.returncode != -9 or len(blocks) != killed_at:
            raise AssertionError(
                f"[guarded-kill] rc {child.returncode}, {len(blocks)} "
                f"blocks; stderr {err[-800:]}")
        count = _write_plan(root, [{"site": "wilcox_bucket",
                                    "class": "stall", "after": 10 ** 9}],
                            name="count.json")
        with _env(SCC_FAULT_PLAN=count), _consumed_by_site() as by_site:
            res = run("guarded-resume", artifact_dir=store)
            hits = faults._HITS.get(0, 0)
        rb = res.metrics["robustness"]
        rb_s = robust_record.current_run().consumed_s
        wall = res.metrics["wall_s"]
        left = sorted(n for n in os.listdir(store)
                      if n.startswith("de_wilcox_"))
        budget = ArtifactStore(store).load("robust_state")[1]["budget_used"]
        log(f"[guarded-resume] wall {wall!r} s; {hits} buckets computed of "
            f"{n_buckets}; resume points {json.dumps(rb['resume_points'])};"
            f" blocks left {len(left)}; robust_state budget_used {budget}; "
            f"stage walls {json.dumps(res.metrics['stage_walls_s'])}")
        if hits != n_buckets - killed_at or rb["resume_points"] != [{
                "stage": "wilcox_test", "unit": "bucket",
                "completed": killed_at, "total": n_buckets}] \
                or left or budget != 0:
            raise AssertionError("[guarded-resume] the resume did not "
                                 "pick up the finished buckets alone")
        # (e) the robustness layer's share of the stored run
        log(f"[guarded-resume] robustness consumed {rb_s!r} s "
            f"({rb_s / wall!r} of the wall, limit {LAYER_SHARE_LIMIT}); "
            f"by site {json.dumps(by_site)}")
        if not rb_s / wall < LAYER_SHARE_LIMIT:
            raise AssertionError("[guarded-resume] the robustness layer "
                                 "costs 2 % or more of the wall")
        torch.cuda.empty_cache()
    finally:
        if child.poll() is None:  # a failure before (d) collected it
            child.kill()
            child.communicate()
        shutil.rmtree(root, ignore_errors=True)
    return launches


# --------------------------------------------------------------------------
# phases 25-27: the mesh path of refine() and its elastic supervisor
# --------------------------------------------------------------------------

# shards of the mesh on the one card: the counterpart of the reference's
# virtual devices (tests/test_parallel.py holds 8 on the CPU)
MESH_SHARDS = 4

# phase 25's branches at 2,000 cells: the kNN graph past approx_threshold,
# and the landmark tree with the kNN linkage, where the mesh reaches the
# tree through the ring's kNN over the landmarks
MESH_BRANCHES = {
    "fast": {},
    "knn": dict(approx_threshold=500, approx_method="knn"),
    "landmark": dict(approx_threshold=500, landmark_threshold=500,
                     landmark_linkage="knn"),
}


def _mesh_contract(tag: str, got, want, what: str) -> None:
    """``parallel.validate.assert_mesh_equals_serial`` with the pair
    named, and the largest log p difference printed."""
    from scconsensus_tpu_torch.parallel.validate import (
        assert_mesh_equals_serial,
    )

    a = got.de.log_p.cpu().numpy() if hasattr(got.de.log_p, "cpu") \
        else np.asarray(got.de.log_p)
    b = want.de.log_p.cpu().numpy() if hasattr(want.de.log_p, "cpu") \
        else np.asarray(want.de.log_p)
    both = np.isfinite(a) & np.isfinite(b)
    dlogp = float(np.abs(a[both] - b[both]).max()) if both.any() else 0.0
    dsil = max(abs(x["silhouette"] - y["silhouette"]) for x, y in
               zip(got.deep_split_info, want.deep_split_info))
    try:
        assert_mesh_equals_serial(got, want)
    except AssertionError as e:
        raise AssertionError(f"[{tag}] {what}: the mesh contract fails "
                             f"(max |dlog p| {dlogp}, max |dsil| {dsil}): "
                             f"{e!r}")
    log(f"[{tag}] {what}: assert_mesh_equals_serial holds; max |dlog p| "
        f"{dlogp!r}, max |dsilhouette| {dsil!r}")


def _with_exact_silhouettes(res):
    """``res`` with each cut's silhouette replaced by the exact one of its
    own embedding and labels (through the kernel): past
    ``approx_threshold`` the serial path reports the pooled estimator and
    the mesh path the exact silhouette (the reference's rule)."""
    import dataclasses

    import torch

    from scconsensus_tpu_torch.ops.silhouette import multi_cut_silhouette

    labs = [np.where(res.dynamic_labels[f"deepsplit: {i['deep_split']}"] > 0,
                     res.dynamic_labels[f"deepsplit: {i['deep_split']}"], -1)
            for i in res.deep_split_info]
    x = torch.from_numpy(res.embedding).to(res.de.log_p.device)
    exact = multi_cut_silhouette(x, labs)
    return dataclasses.replace(res, deep_split_info=[
        {**i, "silhouette": si} for i, (si, _) in
        zip(res.deep_split_info, exact)])


def _mesh_engines_small() -> None:
    """Phase 25's engine checks on the card: the sharded aggregates (both
    forms), the sharded Wilcoxon and the ring sums against their serial
    forms, and the distributed step's silhouette sums against the ring."""
    import torch

    from scconsensus_tpu_torch.ops.distance import distance_tile
    from scconsensus_tpu_torch.ops.gates import compute_aggregates_cid
    from scconsensus_tpu_torch.ops.wilcoxon import wilcoxon_pairs_tile
    from scconsensus_tpu_torch.parallel import (
        distributed_refine_step,
        make_mesh,
        ring_cluster_distance_sums,
        sharded_aggregates,
        sharded_wilcox_logp,
    )
    from scconsensus_tpu_torch.parallel.step import build_step_inputs

    mesh = make_mesh(MESH_SHARDS, device="cuda")
    data, cons = _small_data()
    x = torch.from_numpy(data).cuda()
    cid = torch.from_numpy(np.unique(cons, return_inverse=True)[1]
                           .astype(np.int64)).cuda()
    k = int(cid.max()) + 1
    want = compute_aggregates_cid(x, cid, k, form="segment")
    onehot = torch.nn.functional.one_hot(cid, k).to(torch.float32)
    for form, got in (("onehot", sharded_aggregates(x, onehot, mesh)),
                      ("cid", sharded_aggregates(x, mesh=mesh, cid=cid,
                                                 n_clusters=k))):
        for f in ("sum_log", "sum_expm1", "sum_sq", "nnz", "counts"):
            a, b = getattr(got, f), getattr(want, f)
            rel = float(((a - b).abs() / b.abs().clamp_min(1.0)).max())
            exact = f in ("nnz", "counts")
            if (exact and not torch.equal(a, b)) or rel > 1e-5:
                raise AssertionError(f"[mesh-small] sharded aggregates "
                                     f"({form}) {f}: rel err {rel}")
        log(f"[mesh-small] sharded_aggregates ({form}) on {MESH_SHARDS} "
            "shards: within 1e-5 of the serial segment sums, counts and "
            "nnz exact")
    ci = torch.nonzero(cid == 0).flatten()[:200]
    cj = torch.nonzero(cid == 1).flatten()[:200]
    idx = torch.cat([ci, cj])[None, :]
    m1 = torch.zeros_like(idx, dtype=torch.bool)
    m1[0, :ci.numel()] = True
    n1 = torch.tensor([ci.numel()], device="cuda")
    n2 = torch.tensor([cj.numel()], device="cuda")
    got = sharded_wilcox_logp(x, idx, m1, ~m1, n1, n2, mesh)
    ser = wilcoxon_pairs_tile(x, idx, m1, ~m1, n1, n2)[0]
    if not torch.equal(torch.nan_to_num(got, nan=7.0),
                       torch.nan_to_num(ser, nan=7.0)):
        raise AssertionError("[mesh-small] sharded_wilcox_logp differs from "
                             "the serial tile")
    log("[mesh-small] sharded_wilcox_logp: the serial tile's bits")
    emb = torch.randn((2000, 15), generator=torch.Generator().manual_seed(3)
                      ).cuda()
    ring = ring_cluster_distance_sums(emb, onehot, mesh)
    plain = distance_tile(emb, emb) @ onehot
    err = float((ring - plain).abs().max())
    scale = float(plain.abs().max())
    log(f"[mesh-small] ring_cluster_distance_sums: max abs err {err!r} of "
        f"max |sum| {scale!r}")
    if err > 1e-4 * scale:
        raise AssertionError("[mesh-small] the ring's sums disagree")
    inputs = build_step_inputs(n_cells=2000, n_genes=800, n_clusters=4,
                               n_shards=MESH_SHARDS)
    args = [torch.from_numpy(inputs[n]).cuda() for n in (
        "data", "onehot", "pair_i", "pair_j", "idx", "m1", "m2", "n1", "n2")]
    out = distributed_refine_step(mesh, n_pcs=8)(*args)
    ref = ring_cluster_distance_sums(out["scores"], args[1], mesh)
    err = float((out["sil_sums"] - ref).abs().max())
    log(f"[mesh-small] distributed_refine_step: de calls "
        f"{out['de_counts'].tolist()}; sil_sums against the ring max abs "
        f"err {err!r}")
    if not bool(torch.isfinite(out["scores"]).all()) or err > 1e-3:
        raise AssertionError("[mesh-small] the fused step's sums disagree")


def phase_mesh_small() -> None:
    """Phase 25: the mesh at 2,000 × 800 × 4, card against CPU, on
    ``make_mesh(4)``: the fast Wilcoxon on dense and on CSR input, the kNN
    and the landmark branches, each card mesh run held to the CPU's mesh
    run and to the card's serial run; the engines on the card."""
    import scipy.sparse as sp

    from scconsensus_tpu_torch import (
        ReclusterConfig,
        recluster_de_consensus_fast,
    )
    from scconsensus_tpu_torch.ops.cuda_kernels import distance_cluster_sums
    from scconsensus_tpu_torch.parallel import make_mesh

    t_phase = time.perf_counter()
    _mesh_engines_small()
    for name, kw in list(MESH_BRANCHES.items()) + [("csr", {})]:
        tag = f"mesh-small-{name}"
        as_input = sp.csr_matrix if name == "csr" else None

        def run(data, cons, dev, omega):
            return recluster_de_consensus_fast(
                data, cons, device=dev, omega=omega,
                mesh=make_mesh(MESH_SHARDS, device=dev), **kw)

        distance_cluster_sums.launches = 0
        gpu, cpu, omega = _card_against_cpu(tag, ReclusterConfig(**kw), run,
                                            as_input=as_input)
        launches = distance_cluster_sums.launches
        _mesh_contract(tag, gpu, cpu, "card mesh, CPU mesh")
        data, cons = _small_data()
        if as_input is not None:
            data = as_input(data)
        serial = recluster_de_consensus_fast(data, cons, device="cuda",
                                             omega=omega, mesh=None, **kw)
        if gpu.metrics["tree"]["approx"]:
            serial = _with_exact_silhouettes(serial)
        _mesh_contract(tag, gpu, serial, "card mesh, card serial")
        sil = gpu.metrics["silhouette"]
        log(f"[{tag}] tree {json.dumps(gpu.metrics['tree'])}; silhouette "
            f"{json.dumps(sil)}; rank-sum kernel "
            f"{gpu.metrics['wilcox_ladder']['kernel']}; kernel launches in "
            f"the mesh runs {launches}")
        if sil != {"method": "exact", "engine": "kernel",
                   "n_shards": MESH_SHARDS} or launches != 1 \
                or gpu.metrics["wilcox_ladder"]["kernel"] != "mesh-scan":
            raise AssertionError(f"[{tag}] the mesh run did not go through "
                                 "the sharded rank sum and one kernel "
                                 "launch")
    log(f"[mesh-small] phase 25 in {time.perf_counter() - t_phase!r} s")


def _summary_view(ref: dict):
    """A phase summary (``_summary``) shaped as a result for
    ``assert_mesh_equals_serial``."""
    from types import SimpleNamespace

    return SimpleNamespace(
        de=SimpleNamespace(log_p=ref["log_p"], de_mask=ref["de_mask"]),
        de_gene_union_idx=ref["union"], dynamic_labels=ref["labels"],
        deep_split_info=[{"silhouette": s} for s in ref["silhouettes"]])


def phase_mesh_full(data, truth, cons, wilcox_ref) -> dict:
    """Phase 26: the 26k flagship on a 4-shard mesh on the card (phase
    7's config), held to phase 7's serial run; its walls, the
    silhouette's wall (one kernel launch for every cut, on shard 0's
    device) beside the kernel's time and the ring engine's for the same
    cuts, peak memory, the card count and what ``mesh="auto"`` resolves
    to here."""
    import torch

    from scconsensus_tpu_torch import recluster_de_consensus_fast
    from scconsensus_tpu_torch.ops.silhouette import cut_labels
    from scconsensus_tpu_torch.parallel import (
        make_mesh,
        ring_cluster_distance_sums,
    )
    from scconsensus_tpu_torch.parallel.mesh import auto_mesh
    from scconsensus_tpu_torch.robust import record as robust_record

    auto = auto_mesh("cuda")
    log(f"[mesh-full] torch.cuda.device_count() {torch.cuda.device_count()};"
        f" mesh='auto' resolves to {auto!r}")
    if torch.cuda.device_count() < 2 and auto is not None:
        raise AssertionError("[mesh-full] 'auto' built a mesh on one card")
    mesh = make_mesh(MESH_SHARDS, device="cuda")
    res, launches = _run_full(
        "mesh-full", lambda: recluster_de_consensus_fast(
            data, cons, device="cuda", mesh=mesh), truth)
    m = res.metrics
    consumed = robust_record.current_run().consumed_s
    _mesh_contract("mesh-full", res, _summary_view(wilcox_ref),
                   "4-shard mesh, phase 7 serial")
    rec = _measure_main_path(res, "mesh-path-cuts")
    # the ring engine (the reference's mesh silhouette) over the same
    # cuts, one ring for all of them, best of 2
    labs = [np.where(res.dynamic_labels[f"deepsplit: {i['deep_split']}"]
                     > 0, res.dynamic_labels[f"deepsplit: {i['deep_split']}"],
                     -1) for i in res.deep_split_info]
    ids, k_total, _ = cut_labels(labs)
    x = torch.from_numpy(res.embedding).cuda()
    onehot = torch.zeros((ids.shape[0], k_total), device="cuda")
    for c in range(ids.shape[1]):
        ok = torch.from_numpy(np.nonzero(ids[:, c] >= 0)[0]).cuda()
        onehot[ok, torch.from_numpy(ids[:, c]).cuda()[ok]] = 1.0
    ring_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ring_cluster_distance_sums(x, onehot, mesh)
        torch.cuda.synchronize()
        ring_s.append(time.perf_counter() - t0)
    log(f"[mesh-full] wall {m['wall_s']!r} s against phase 7's "
        f"{wilcox_ref['wall_s']!r} s; wilcox_test {m['stage_walls_s']['wilcox_test']!r}"
        f" s; silhouette stage {m['stage_walls_s']['silhouette']!r} s "
        f"({m['silhouette']}); for the same cuts the kernel takes "
        f"{rec['ms']!r} ms and the ring engine {min(ring_s)!r} s (best of "
        f"{ring_s!r}); launches {launches}; peak {m['peak_bytes']} bytes; "
        f"robustness consumed {consumed!r} s ({consumed / m['wall_s']!r} of "
        "the wall)")
    if launches != 1 or m["silhouette"].get("engine") != "kernel":
        raise AssertionError("[mesh-full] the silhouette did not take one "
                             "kernel launch")
    return {"summary": _summary(res), "share": consumed / m["wall_s"],
            "n_buckets": len(m["wilcox_ladder"]["buckets"]),
            "launches": launches}


_MESH_KILL_CHILD = """
import os, sys
os.environ["SCC_FAULT_PLAN"] = {plan!r}
sys.path.insert(0, {repo!r})
import chip_smoke
from scconsensus_tpu_torch import recluster_de_consensus_fast
from scconsensus_tpu_torch.parallel import make_mesh

data, truth, cons = chip_smoke.phase_full_data()
recluster_de_consensus_fast(data, cons, device="cuda",
                            artifact_dir={store!r},
                            mesh=make_mesh({shards}, device="cuda"))
print("UNEXPECTED: the run survived a kill fault")
"""


def phase_elastic(data, truth, cons, mesh_ref: dict, launcher) -> dict:
    """Phase 27: the elastic supervisor at 26k on a 4-shard mesh: a device
    loss in the sharded rank sum (4 → 2), one in the ring (4 → 2), a
    double loss (4 → 2 → 1), a store written on 4 shards and resumed
    serially, and a bucket checkpoint written on 4 shards by a child
    killed at wilcox_bucket halfway (started with the phase, beside the
    in-process runs), resumed on 2. Every run keeps phase 26's labels,
    DE mask and union; its transitions validate. Then the robustness
    layer's share of the healthy supervised runs' walls."""
    import shutil
    import tempfile

    from scconsensus_tpu_torch import recluster_de_consensus_fast
    from scconsensus_tpu_torch.parallel import make_mesh
    from scconsensus_tpu_torch.robust import faults
    from scconsensus_tpu_torch.robust import record as robust_record
    from scconsensus_tpu_torch.robust.record import validate_robustness

    ref = _summary_view(mesh_ref["summary"])
    root = tempfile.mkdtemp(prefix="scc-elastic-")
    launches = {}
    shares = [mesh_ref["share"]]

    def run(tag, shards=MESH_SHARDS, engine="native", **kw):
        res, launches[tag] = _run_full(
            tag, lambda: recluster_de_consensus_fast(
                data, cons, device="cuda",
                mesh=make_mesh(shards, device="cuda") if shards else None,
                **kw), truth, engine=engine)
        _mesh_contract(tag, res, ref, "phase 26's mesh run")
        rb = res.metrics.get("robustness")
        if rb is not None:
            validate_robustness(rb)
            log(f"[{tag}] mesh transitions "
                f"{json.dumps(rb.get('mesh_transitions', []))}")
        return res, rb

    def paths(rb):
        return [(len(t["from_devices"]), len(t["to_devices"]), t["cause"])
                for t in (rb or {}).get("mesh_transitions", [])]

    # the child killed at wilcox_bucket halfway through the 4-shard
    # ladder: started now, collected before its resume below
    n_buckets = mesh_ref["n_buckets"]
    killed_at = n_buckets // 2
    kill_store = os.path.join(root, "kill-store")
    plan = _write_plan(root, [{"site": "wilcox_bucket", "class": "kill",
                               "after": killed_at}], name="kill.json")
    t_phase = time.perf_counter()
    _launch_start(launcher, [sys.executable, "-c", _MESH_KILL_CHILD.format(
        plan=plan, repo=REPO, store=kill_store, shards=MESH_SHARDS)], 600)
    collected = False
    try:
        for tag, rules, want in (
                ("elastic-ranksum",
                 [{"site": "sharded:ranksum", "class": "device_loss"}],
                 [(4, 2, "device_loss")]),
                ("elastic-ring",
                 [{"site": "ring:distance_sums", "class": "device_loss"}],
                 [(4, 2, "device_loss")]),
                ("elastic-double",
                 [{"site": "stage:de", "class": "device_loss"},
                  {"site": "stage:embed", "class": "device_loss"}],
                 [(4, 2, "device_loss"), (2, 1, "device_loss")])):
            with _env(SCC_FAULT_PLAN=_write_plan(root, rules,
                                                 name=f"{tag}.json")):
                _, rb = run(tag)
            if paths(rb) != want:
                raise AssertionError(f"[{tag}] transitions {paths(rb)}, "
                                     f"expected {want}")

        # a store written on 4 shards, resumed serially
        store = os.path.join(root, "store")
        res, rb = run("elastic-store-4", artifact_dir=store)
        if rb is not None and (rb["retries"] or rb["faults_injected"]
                               or rb.get("mesh_transitions")):
            raise AssertionError("[elastic-store-4] a healthy run retried "
                                 "or moved between meshes")
        shares.append(robust_record.current_run().consumed_s
                      / res.metrics["wall_s"])
        _, rb = run("elastic-resume-1", shards=0, engine=None,
                    artifact_dir=store)
        stages = sorted({t["stage"] for t in rb["mesh_transitions"]})
        if {p[:2] for p in paths(rb)} != {(4, 1)} or not \
                {"de", "union", "embed", "tree", "cuts"} <= set(stages):
            raise AssertionError(f"[elastic-resume-1] transitions "
                                 f"{paths(rb)} at {stages}")
        log(f"[elastic-resume-1] one cause 'resume' transition 4 -> 1 at "
            f"each of {stages}")

        # the child killed halfway through the 4-shard ladder, resumed
        # here on 2 shards from its finished buckets
        out = _launch_finish(launcher)
        collected = True
        blocks = sorted(n for n in os.listdir(kill_store)
                        if n.startswith("de_wilcox_") and n.endswith(".npz"))
        log(f"[elastic-kill] child exit {out['rc']} after "
            f"{time.perf_counter() - t_phase!r} s from the phase's start; "
            f"{len(blocks)} of {n_buckets} buckets stored on 4 shards")
        if out["rc"] != -9 or len(blocks) != killed_at:
            raise AssertionError(f"[elastic-kill] rc {out['rc']}, "
                                 f"{len(blocks)} blocks; stderr "
                                 f"{out['stderr'][-800:]}")
        count = _write_plan(root, [{"site": "wilcox_bucket",
                                    "class": "stall", "after": 10 ** 9}],
                            name="count.json")
        with _env(SCC_FAULT_PLAN=count):
            _, rb = run("elastic-resume-2", shards=2,
                        artifact_dir=kill_store)
            hits = faults._HITS.get(0, 0)
        log(f"[elastic-resume-2] {hits} buckets computed of {n_buckets}; "
            f"resume points {json.dumps(rb['resume_points'])}")
        if hits != n_buckets - killed_at or paths(rb) != [
                (4, 2, "resume")] or rb["resume_points"][0]["completed"] \
                != killed_at:
            raise AssertionError("[elastic-resume-2] the 2-shard run did "
                                 "not resume the 4-shard buckets")
    finally:
        if not collected:  # keep the launcher's answers in step
            _launch_finish(launcher)
        shutil.rmtree(root, ignore_errors=True)
    share = min(shares)
    log(f"[elastic] robustness consumed / wall of the healthy supervised "
        f"runs {shares!r}; best {share!r} (the reference's limit "
        f"{LAYER_SHARE_LIMIT})")
    if not share < LAYER_SHARE_LIMIT:
        raise AssertionError("[elastic] the supervised mesh run's "
                             "robustness layer costs 2 % or more of the "
                             "wall")
    log(f"[elastic] phase 27 in {time.perf_counter() - t_phase!r} s")
    return launches


# --------------------------------------------------------------------------
# phases 22-24: the out-of-core streaming refine
# --------------------------------------------------------------------------

# the Wilcoxon log p tolerance of the CPU parity tests
# (tests/test_torch_de.py), card against CPU on the same chunks
WILCOX_LOGP_RTOL, WILCOX_LOGP_ATOL = 1e-5, 1e-4
# phase 22's two shapes (cells, genes, clusters, seed): the soak worker's
# defaults and the reference's streaming test shape (tests/test_stream.py)
STREAM_SMALL = {"stream-soak": (4000, 160, 4, 7),
                "stream-test": (1200, 96, 3, 5)}
STREAM_SMALL_WINDOW = 32
# the budget-breach plan's stage budget at the soak shape: the reference's
# (tools/chaos_run.py:178-179). At 0.25 MB the soak shape's first chunk
# charge already breaks the budget outside the window ladder, the 10M
# finding in small
STREAM_SOAK_STAGE_MB = "0.7"
# brain10m's generator and config (bench.py:1043-1047, :1338-1343)
BRAIN10M = dict(n_genes=2000, n_clusters=16, seed=11, density=0.02)
BRAIN10M_KW = dict(approx_threshold=100_000, landmark_threshold=100_000,
                   silhouette_sample=50_000)
STREAM_20K_CELLS = 20_000
# phase 24's cell count: brain10m's 10,000,000 cut to 105,000 (125,000
# until phases 42-44 were added: its child took 85.7 s there); nothing
# else is cut. At 1,000,000 the phase took 482.6 s on the card (cold
# 289.5 s, steady 182.3 s): the Gram embed's 560 chunk loads took
# 137.9-141.0 s of each run and the cold run's ingest 101.7 s; at 500,000
# its child took 211 s, at 250,000 132.8 s (phase 24 156.3 s), the
# script's largest depth after phase 40 once phases 39-41 were added. It
# stays above brain10m's approx_threshold (100,000; the exact tree runs
# at N <= threshold): at 100,000 cells the child built the exact Ward
# tree twice and took 252.5 s
STREAM_SCALE_CELLS = 105_000
MB = float(1 << 20)
# On the card's machine ``import torch`` and CUDA init leave 4.8 GB
# resident, above the 4,096 MB default host budget before any streaming
# starts; the accountant takes the budget over the RSS it finds when it is
# built (stream/budget.py), so phase 24's child and phase 30's worker run
# at the default. The correctness runs of phases 22-23 run in this
# long-lived process, whose peak includes every earlier phase, with the
# roomy budget the reference's own suite gives its in-process runs
# (tests/test_stream.py:28-36), here 64 GB.
STREAM_ROOMY_HOST_MB = "65536"


def _stream_config(seed: int, **kw):
    """The streaming workloads' config (``stream/soak.py``, bench.py's
    brain10m): the fast Wilcoxon at the reference's thresholds."""
    from scconsensus_tpu_torch import ReclusterConfig

    return ReclusterConfig(
        method="wilcox", q_val_thrs=0.1, log_fc_thrs=0.25, min_pct=5.0,
        deep_split_values=(1, 2), min_cluster_size=10, n_top_de_genes=20,
        random_seed=seed, **kw)


def _stream_store(root: str, n_cells: int, n_genes: int, n_clusters: int,
                  seed: int, window: int, density: float = 0.25):
    """A chunk store of the soak generator ingested under ``root``: the
    generator and the consensus labels."""
    from scconsensus_tpu_torch import ChunkedCSRStore
    from scconsensus_tpu_torch.stream.soak import (
        chunk_generator,
        consensus_input,
    )

    gen = chunk_generator(n_genes, n_cells, n_clusters, seed,
                          density=density)
    t0 = time.perf_counter()
    st = ChunkedCSRStore.create(root, n_genes, n_cells, window)
    st.ingest(gen)
    log(f"[stream] ingested {n_cells} x {n_genes} in {st.n_chunks} chunks "
        f"in {time.perf_counter() - t0!r} s ({_dir_bytes(root)} bytes)")
    return gen, consensus_input(n_cells, n_clusters, seed)


def _dir_bytes(root: str) -> int:
    return sum(e.stat().st_size for e in os.scandir(root) if e.is_file())


def _stream_run(tag: str, store_root: str, labels, cfg, stage_dir: str,
                gen, device: str = "cuda", **kw):
    """One ``streaming_refine`` with the kernel count reset just before and
    read just after; logs the walls, the chunk loads and the section."""
    import torch

    from scconsensus_tpu_torch import ChunkedCSRStore, streaming_refine
    from scconsensus_tpu_torch.ops.cuda_kernels import distance_cluster_sums

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    distance_cluster_sums.launches = 0
    t0 = time.perf_counter()
    res = streaming_refine(ChunkedCSRStore(store_root), labels, cfg,
                           stage_dir=stage_dir, regen=gen, device=device,
                           **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = distance_cluster_sums.launches
    m = res.metrics
    m["wall_s"] = wall
    m["peak_bytes"] = torch.cuda.max_memory_allocated()
    log(f"[{tag}] {device} wall {wall!r} s; union {m['union_size']}; "
        f"launches {launches}; peak device memory {m['peak_bytes']} bytes;"
        f" stage walls {json.dumps(m['stage_walls_s'])}; stream "
        f"{json.dumps(m['stream'])}; streaming "
        f"{json.dumps(m['streaming'])}")
    return res, launches


def _same_stream(tag: str, a, b, what: str) -> bool:
    """Union, DE mask and nodg identical, log p within the Wilcoxon
    tolerance, ARI = 1 and silhouettes within 1e-4 per
    deepSplit between two streaming or refine results. Returns whether
    every cut's labels are bitwise equal."""
    if not np.array_equal(a.de_gene_union_idx, b.de_gene_union_idx):
        raise AssertionError(f"[{tag}] {what}: unions differ")
    ma, mb = a.de.de_mask.cpu().numpy(), b.de.de_mask.cpu().numpy()
    if not np.array_equal(ma, mb):
        _report_mask_flips(tag, a, b, ma, mb)
        raise AssertionError(f"[{tag}] {what}: DE masks differ")
    if not np.array_equal(a.nodg, b.nodg):
        raise AssertionError(f"[{tag}] {what}: nodg differs")
    la, lb = a.de.log_p.cpu().numpy(), b.de.log_p.cpu().numpy()
    if not np.array_equal(np.isnan(la), np.isnan(lb)):
        raise AssertionError(f"[{tag}] {what}: NaN log p differ")
    fin = np.isfinite(la) & np.isfinite(lb)
    err = np.abs(la[fin] - lb[fin])
    bad = int((err > WILCOX_LOGP_ATOL
               + WILCOX_LOGP_RTOL * np.abs(lb[fin])).sum())
    log(f"[{tag}] {what}: log p max |diff| "
        f"{float(err.max(initial=0.0))!r}, {bad} outside the tolerance")
    if bad:
        raise AssertionError(f"[{tag}] {what}: log p differ")
    same = True
    for ia, ib in zip(a.deep_split_info, b.deep_split_info):
        key = f"deepsplit: {ia['deep_split']}"
        la, lb = a.dynamic_labels[key], b.dynamic_labels[key]
        ari = _ari(la, lb)
        dsil = abs(ia["silhouette"] - ib["silhouette"])
        equal = bool(np.array_equal(la, lb))
        same &= equal
        log(f"[{tag}] {key}: clusters {ia['n_clusters']} silhouette "
            f"{ia['silhouette']!r} ARI({what}) {ari!r} |dsil| {dsil!r} "
            f"labels bitwise equal {equal}")
        if ari != 1.0 or not dsil <= 1e-4:
            raise AssertionError(f"[{tag}] {key}: ARI {ari}, |dsil| {dsil}")
    return same


def _report_mask_flips(tag: str, a, b, ma, mb) -> None:
    """Each (pair, gene) whose DE call differs: both sides' log q,
    log fc and detection rates, against the thresholds."""
    lq_a, lq_b = a.de.log_q.cpu().numpy(), b.de.log_q.cpu().numpy()
    fc_a, fc_b = a.de.log_fc.cpu().numpy(), b.de.log_fc.cpu().numpy()
    for p, g in zip(*np.nonzero(ma != mb)):
        log(f"[{tag}] DE call flip at pair {int(p)} gene {int(g)}: log q "
            f"{lq_a[p, g]!r} / {lq_b[p, g]!r}, log fc {fc_a[p, g]!r} / "
            f"{fc_b[p, g]!r}")


def _soak_child(workdir: str, *extra, plan=None):
    """The port's soak worker on the card, in a process of its own."""
    env = {k: v for k, v in os.environ.items() if k != "SCC_FAULT_PLAN"}
    if plan:
        env["SCC_FAULT_PLAN"] = plan
    cmd = [sys.executable, "-m", "scconsensus_tpu_torch.stream.soak",
           "--dir", workdir, "--summary", os.path.join(workdir, "S.json"),
           "--device", "cuda", "--window", str(STREAM_SMALL_WINDOW),
           *extra]
    return subprocess.Popen(cmd, cwd=REPO, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _soak_result(tag: str, proc, workdir: str):
    """(exit code, summary or None) of a soak child, logged."""
    try:
        _, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
    try:
        with open(os.path.join(workdir, "S.json")) as f:
            summary = json.load(f)
    except OSError:
        summary = None
    brief = None if summary is None else {
        k: summary[k] for k in ("ok", "wall_s", "labels_sha", "chunks",
                                "halvings", "ckpt_final", "within_budget",
                                "peak_rss_mb")}
    log(f"[{tag}] exit {proc.returncode}; {json.dumps(brief)}")
    if summary is None and proc.returncode != -9:
        log(f"[{tag}] stderr {err[-1500:]}")
    if summary is not None:
        # the summary carries the worker's whole run record
        from scconsensus_tpu_torch.obs.export import validate_run_record

        rec = summary["record"]
        validate_run_record(rec)
        sections = sorted(k for k in ("streaming", "robustness",
                                      "integrity") if k in rec)
        log(f"[{tag}] run record validates: {len(rec['spans'])} spans, "
            f"sections {sections}")
    return proc.returncode, summary


def phase_stream_small() -> int:
    """Phase 22: the streaming refine at two small shapes, card against
    CPU; the soak worker's four chaos plans in child processes; audit and
    an enforce-mode stream_block corruption. Returns the kernel's
    launches in the card runs held against the CPU."""
    import shutil
    import tempfile

    import torch

    from scconsensus_tpu_torch import ChunkedCSRStore

    root = tempfile.mkdtemp(prefix="scc-stream-small-")
    launches = 0
    try:
        with _env(SCC_STREAM_HOST_BUDGET_MB=STREAM_ROOMY_HOST_MB):
            # (a) card against CPU, the same projection on both
            for tag, (n, g, k, seed) in STREAM_SMALL.items():
                store = os.path.join(root, tag)
                gen, labels = _stream_store(store, n, g, k, seed,
                                            STREAM_SMALL_WINDOW)
                cfg = _stream_config(seed)
                first, _ = _stream_run(f"{tag}-draw", store, labels, cfg,
                                       os.path.join(root, f"{tag}-s0"), gen)
                f = first.de_gene_union_idx.size
                omega = torch.randn((f, min(cfg.n_pcs + 10, f, n)),
                                    generator=torch.Generator().manual_seed(0))
                gpu, n_launch = _stream_run(tag, store, labels, cfg,
                                            os.path.join(root, f"{tag}-s1"),
                                            gen, omega=omega)
                cpu, _ = _stream_run(f"{tag}-cpu", store, labels, cfg,
                                     os.path.join(root, f"{tag}-s2"), gen,
                                     device="cpu", omega=omega)
                _same_stream(tag, gpu, cpu, "card, cpu")
                if n_launch < 1:
                    raise AssertionError(f"[{tag}] the exact silhouette did "
                                         "not launch the kernel")
                if gpu.metrics["stream"]["embed_regime"] != "dense":
                    raise AssertionError(f"[{tag}] the dense embed did "
                                         "not run")
                launches += n_launch

            # (b) the soak worker through the four chaos plans (the
            # reference's STREAM_SOAK_MATRIX, tools/chaos_run.py:167-179),
            # each in a child process on the card; independent ones together
            n_chunks = -(-STREAM_SMALL["stream-soak"][1]
                         // STREAM_SMALL_WINDOW)
            plans = {
                "kill": _write_plan(root, [{"site": "stream_chunk_write",
                                            "class": "kill", "after": 2}],
                                    "kill.json"),
                "torn": _write_plan(root, [{"site": "artifact:stream_chunk",
                                            "class": "corrupt", "after": 1}],
                                    "torn.json"),
                # an ENOSPC on an ingest write (swept and retried), then one
                # on the first per-chunk DE checkpoint (its granularity
                # coarsens): the retried ingest write is hit n_chunks
                "disk": _write_plan(root, [
                    {"site": "stream_chunk_write", "class": "disk",
                     "after": 1},
                    {"site": "stream_chunk_write", "class": "disk",
                     "after": n_chunks + 1}], "disk.json"),
            }
            dirs = {t: os.path.join(root, f"soak-{t}") for t in
                    ("ref", "kill", "torn", "disk", "budget-a", "budget-b")}
            t0 = time.perf_counter()
            procs = {
                "ref": _soak_child(dirs["ref"], "--fresh"),
                **{t: _soak_child(dirs[t], "--fresh", plan=plans[t])
                   for t in ("kill", "torn", "disk")},
                **{t: _soak_child(dirs[t], "--fresh", "--stage-budget-mb",
                                  STREAM_SOAK_STAGE_MB)
                   for t in ("budget-a", "budget-b")},
            }
            out = {t: _soak_result(f"soak-{t}", p, dirs[t])
                   for t, p in procs.items()}
            done = ChunkedCSRStore(
                os.path.join(dirs["kill"], "chunks")).completed_chunks()
            out["resume"] = _soak_result(
                "soak-resume", _soak_child(dirs["kill"]), dirs["kill"])
            log(f"[soak] seven children in {time.perf_counter() - t0!r} s; "
                f"{done} of {n_chunks} chunks durable after the kill")
            ref = out["ref"][1]
            if not (ref and ref["ok"]):
                raise AssertionError("[soak] the reference run failed")
            sha = ref["labels_sha"]
            rc, s = out["kill"]
            if rc != -9 or s is not None or not 0 < done < n_chunks:
                raise AssertionError(f"[soak-kill] rc {rc}, {done} chunks")
            s = out["resume"][1]
            if not (s and s["ok"] and s["labels_sha"] == sha
                    and s["chunks"]["resumed"] >= done):
                raise AssertionError("[soak-resume] not the reference's "
                                     "labels")
            s = out["torn"][1]
            if not (s and s["ok"] and s["labels_sha"] == sha
                    and s["chunks"]["quarantined"] >= 1
                    and s["chunks"]["recomputed"] >= 1):
                raise AssertionError("[soak-torn] the torn chunk was not "
                                     "quarantined and recomputed")
            s = out["disk"][1]
            rb = ((s or {}).get("record") or {}).get("robustness") or {}
            disk = [r for r in rb.get("retries", [])
                    if r["error_class"] == "disk" and r["recovered"]]
            if not (s and s["ok"] and s["labels_sha"] == sha
                    and s["ckpt_final"] > 1 and len(disk) == 2):
                raise AssertionError("[soak-disk] the disk faults were not "
                                     "recovered with a coarser checkpoint")
            a, b = out["budget-a"][1], out["budget-b"][1]
            if not (a and b and a["ok"] and b["ok"] and a["halvings"] >= 1
                    and a["labels_sha"] == b["labels_sha"]):
                raise AssertionError("[soak-budget] no halving, or the same "
                                     "budget gave other labels")

            # (c) audit, then a stream_block corruption under enforce
            tag = "stream-test"
            n, g, k, seed = STREAM_SMALL[tag]
            store = os.path.join(root, tag)
            gen, labels = _stream_store(store, n, g, k, seed,
                                        STREAM_SMALL_WINDOW)
            cfg = _stream_config(seed)
            clean, _ = _stream_run(f"{tag}-clean", store, labels, cfg,
                                   os.path.join(root, "c0"), gen)
            with _env(SCC_INTEGRITY="audit"):
                res, _ = _stream_run(f"{tag}-audit", store, labels, cfg,
                                     os.path.join(root, "c1"), gen)
            ig = res.metrics["integrity"]
            log(f"[{tag}-audit] checks {json.dumps(ig['checks'])}, ghost "
                f"{json.dumps({k: v for k, v in ig['ghost'].items()})}")
            if ig["ghost"]["mismatches"] or not ig["all_checks_passed"] \
                    or ig["ghost"]["run"] < 1:
                raise AssertionError(f"[{tag}-audit] replay mismatches")
            _same_stream(f"{tag}-audit", res, clean, "audit, clean")
            plan = _write_plan(root, [{"site": "stream_block",
                                       "class": "corruption",
                                       "mode": "signflip"}], "block.json")
            with _env(SCC_INTEGRITY="enforce", SCC_FAULT_PLAN=plan):
                res, _ = _stream_run(f"{tag}-enforce", store, labels, cfg,
                                     os.path.join(root, "c2"), gen)
            ig = res.metrics["integrity"]
            log(f"[{tag}-enforce] detected by {_detected_by(ig)}; recomputes "
                f"{ig['ghost']['recomputes']}")
            if not _detected_by(ig) or ig["ghost"]["recomputes"] < 1:
                raise AssertionError(f"[{tag}-enforce] the corruption was not "
                                     "detected and recomputed")
            if not _same_stream(f"{tag}-enforce", res, clean,
                                "enforce, clean"):
                raise AssertionError(f"[{tag}-enforce] not the clean bits")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


def phase_stream_20k() -> int:
    """Phase 23: brain10m's generator and config at 20,000 cells, below
    ``approx_threshold``: ``streaming_refine`` on a chunk store against
    ``refine()`` on the same CSR, both on the card, best of 2 for the
    machinery's share. Returns the kernel's launches over the streaming
    runs."""
    import shutil
    import tempfile

    import scipy.sparse as sp
    import torch

    from scconsensus_tpu_torch import (
        ChunkedCSRStore,
        HostBudgetAccountant,
        refine,
    )
    from scconsensus_tpu_torch.config import env_flag
    from scconsensus_tpu_torch.ops.cuda_kernels import distance_cluster_sums
    from scconsensus_tpu_torch.robust import record as robust_record

    tag = "stream-20k"
    b = BRAIN10M
    root = tempfile.mkdtemp(prefix="scc-stream-20k-")
    try:
        with _env(SCC_STREAM_HOST_BUDGET_MB=STREAM_ROOMY_HOST_MB):
            store = os.path.join(root, "chunks")
            gen, labels = _stream_store(
                store, STREAM_20K_CELLS, b["n_genes"], b["n_clusters"],
                b["seed"], int(env_flag("SCC_STREAM_WINDOW")),
                density=b["density"])
            st = ChunkedCSRStore(store)
            full = sp.vstack([st.load_chunk(i) for i in range(st.n_chunks)]
                             ).tocsr()
            cfg = _stream_config(b["seed"], **BRAIN10M_KW)
            torch.cuda.synchronize()
            distance_cluster_sums.launches = 0
            t0 = time.perf_counter()
            mem = refine(full, labels, cfg, device="cuda")
            torch.cuda.synchronize()
            mem_wall = time.perf_counter() - t0
            mem_launches = distance_cluster_sums.launches
            log(f"[{tag}] refine() from the CSR: wall {mem_wall!r} s; "
                f"launches {mem_launches}; stage walls "
                f"{json.dumps(mem.metrics['stage_walls_s'])}")
            launches, best = 0, float("inf")
            for rep in range(2):
                acct = HostBudgetAccountant()
                res, n_launch = _stream_run(
                    f"{tag}-{rep}", store, labels, cfg,
                    os.path.join(root, f"stages-{rep}"), gen, accountant=acct)
                consumed = acct.consumed_s + robust_record.current_run(
                ).consumed_s
                share = consumed / res.metrics["wall_s"]
                best = min(best, share)
                log(f"[{tag}-{rep}] machinery consumed {consumed!r} s "
                    f"(accountant {acct.consumed_s!r}), {share!r} of the wall")
                equal = _same_stream(f"{tag}-{rep}", res, mem,
                                     "streaming, refine()")
                log(f"[{tag}-{rep}] labels bitwise equal to refine()'s: "
                    f"{equal}; embeddings bitwise equal: "
                    f"{bool(np.array_equal(res.embedding, mem.embedding))}")
                if res.metrics["stream"]["embed_regime"] != "dense":
                    raise AssertionError(f"[{tag}] the dense twin did not run")
                if n_launch != 1 or mem_launches != 1:
                    raise AssertionError(f"[{tag}] launches {n_launch}, "
                                         f"{mem_launches}; one each expected")
                launches += n_launch
            log(f"[{tag}] machinery best of 2: {best!r} of the wall (limit "
                f"{LAYER_SHARE_LIMIT})")
            if not best < LAYER_SHARE_LIMIT:
                raise AssertionError(f"[{tag}] the streaming machinery costs "
                                     "2 % or more of the wall")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


_STREAM_SCALE_CHILD = """
import sys
sys.path.insert(0, {repo!r})
import chip_smoke
sys.exit(chip_smoke.stream_scale_child({root!r}, {n_cells!r}))
"""


def stream_scale_child(root: str, n_cells: int) -> int:
    """Phase 24's worker, in a process of its own (``ru_maxrss`` only
    rises, so the budget is judged on a fresh process, as the reference's
    bench runs each config in a worker): a cold run (the ingest and the
    run) and a steady one with a fresh stage dir against the durable
    chunks (bench.py:1345-1395). Prints one ``STREAM_SCALE`` JSON line."""
    import torch

    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    from scconsensus_tpu_torch import ChunkedCSRStore, HostBudgetAccountant
    from scconsensus_tpu_torch.config import env_flag
    from scconsensus_tpu_torch.obs.device import (
        host_peak_rss_bytes,
        host_rss_bytes,
    )
    from scconsensus_tpu_torch.stream.soak import (
        chunk_generator,
        consensus_input,
    )

    baseline_mb = host_peak_rss_bytes() / MB
    budget_mb = float(env_flag("SCC_STREAM_HOST_BUDGET_MB")) + baseline_mb
    log(f"[stream-scale] child baseline_rss_mb {host_rss_bytes() / MB!r} "
        f"(peak {baseline_mb!r}) after import torch and CUDA init; the "
        f"default accountant's bound about {budget_mb!r} MB: the default "
        f"{env_flag('SCC_STREAM_HOST_BUDGET_MB')} MB over its baseline")
    b = BRAIN10M
    window = int(env_flag("SCC_STREAM_WINDOW"))
    gen = chunk_generator(b["n_genes"], n_cells, b["n_clusters"],
                          b["seed"], density=b["density"])
    labels = consensus_input(n_cells, b["n_clusters"], b["seed"])
    cfg = _stream_config(b["seed"], **BRAIN10M_KW)
    chunks = os.path.join(root, "chunks")
    out = {"n_cells": n_cells, "n_genes": b["n_genes"], "window": window,
           "baseline_peak_rss_mb": baseline_mb, "host_budget_mb": budget_mb}
    for tag in ("cold", "steady"):
        ChunkedCSRStore.create(chunks, b["n_genes"], n_cells, window)
        acct = HostBudgetAccountant()
        res, launches = _stream_run(
            f"stream-scale-{tag}", chunks, labels, cfg,
            os.path.join(root, f"stages-{tag}"), gen, accountant=acct)
        m = res.metrics
        # what the parent checks and prints; _stream_run logged the rest
        out[tag] = {
            "wall_s": m["wall_s"],
            "cells_per_s": n_cells / m["wall_s"],
            "launches": launches,
            "peak_device_bytes": m["peak_bytes"],
            "store_bytes": _dir_bytes(chunks),
            "embed_regime": m["stream"]["embed_regime"],
            "chunk_loads": m["stream"]["chunk_loads"],
            "silhouettes": [i["silhouette"] for i in res.deep_split_info],
            "streaming": m["streaming"],
        }
        del res
    log("STREAM_SCALE " + json.dumps(out))
    return 0


def _chunk_charge(n_cells: int, rows: int) -> tuple:
    """Stored entries of brain10m's first ``rows``-gene chunk at
    ``n_cells`` cells, and ``ChunkedCSRStore.chunk_host_bytes``'s charge
    for them (12 bytes an entry and the row pointers), from the
    generator's own draws, without building the matrix."""
    from scconsensus_tpu_torch.stream.soak import truth_labels

    b = BRAIN10M
    truth = truth_labels(n_cells, b["n_clusters"], b["seed"])
    cells_of = [np.nonzero(truth == k)[0] for k in range(b["n_clusters"])]
    nnz = 0
    for g in range(rows):
        rng = np.random.default_rng(np.random.SeedSequence([b["seed"], g]))
        n_bg = max(int(n_cells * b["density"] * 0.5), 4)
        bg = rng.integers(0, n_cells, size=n_bg)
        rng.gamma(2.0, 0.4, size=n_bg)
        own = cells_of[g % b["n_clusters"]]
        hi = rng.choice(own, size=min(max(int(own.size * 0.6), 1),
                                      own.size), replace=False)
        # the generator sums duplicate (gene, cell) entries
        nnz += np.unique(np.concatenate([bg, hi])).size
    return nnz, nnz * 12 + (rows + 1) * 8


# A process that runs one command line at a time for the script and
# answers with its exit code and output. Linux keeps a process's RSS
# high-water mark (``ru_maxrss``) across execve, so a child inherits its
# spawner's: phase 24's worker is started from this launcher, which
# main() starts before anything large is loaded, so that the worker's
# peak is its own and not this script's.
_LAUNCHER = """
import json, subprocess, sys
from concurrent.futures import ThreadPoolExecutor

def run(argv, timeout):
    p = subprocess.run(argv, capture_output=True, text=True,
                       timeout=timeout)
    return {"rc": p.returncode, "stdout": p.stdout, "stderr": p.stderr}

for line in sys.stdin:
    cmd = json.loads(line)
    if "argvs" in cmd:  # several commands at once, results in order
        with ThreadPoolExecutor(len(cmd["argvs"])) as pool:
            out = list(pool.map(lambda a: run(a, cmd["timeout"]),
                                cmd["argvs"]))
    else:
        out = run(cmd["argv"], cmd["timeout"])
    print(json.dumps(out), flush=True)
"""


def _start_launcher():
    return subprocess.Popen([sys.executable, "-c", _LAUNCHER], text=True,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE)


def _stop_launcher(launcher) -> None:
    launcher.stdin.close()
    try:
        launcher.wait(timeout=60)
    except subprocess.TimeoutExpired:
        launcher.kill()
        launcher.wait()


def _launch(launcher, argv, timeout: float) -> dict:
    """Run ``argv`` through the launcher: its exit code and output."""
    return _launcher_call(launcher, {"argv": argv, "timeout": timeout})


def _launch_all(launcher, argvs, timeout: float) -> list:
    """Run every command of ``argvs`` through the launcher at once: their
    exit codes and outputs, in order."""
    return _launcher_call(launcher, {"argvs": argvs, "timeout": timeout})


def _launch_start(launcher, argv, timeout: float) -> None:
    """Hand ``argv`` to the launcher and return at once; the launcher
    takes no other command until ``_launch_finish`` has read its
    answer."""
    _launcher_send(launcher, {"argv": argv, "timeout": timeout})


def _launch_finish(launcher):
    """The launcher's answer to the command it was last handed."""
    line = launcher.stdout.readline()
    if not line:
        raise AssertionError("the launcher died (a command past its time "
                             "limit?)")
    return json.loads(line)


def _launcher_send(launcher, cmd: dict) -> None:
    launcher.stdin.write(json.dumps(cmd) + "\n")
    launcher.stdin.flush()


def _launcher_call(launcher, cmd: dict):
    _launcher_send(launcher, cmd)
    return _launch_finish(launcher)


def phase_stream_scale(launcher) -> int:
    """Phase 24: brain10m's shapes at ``STREAM_SCALE_CELLS`` cells, the
    default budgets, in a child process started by ``launcher``; the
    store removed afterwards. Returns the kernel's launches (0: the
    pooled estimator)."""
    import shutil
    import tempfile

    from scconsensus_tpu_torch.config import env_flag

    rows = int(env_flag("SCC_STREAM_WINDOW"))
    root = tempfile.mkdtemp(prefix="scc-stream-scale-")
    # the 10M finding, reckoned from the generator's draws on one core
    # while the child runs
    reckon = ThreadPoolExecutor(1)
    charges = {n: reckon.submit(_chunk_charge, n, rows)
               for n in (STREAM_SCALE_CELLS, 10_000_000)}
    try:
        t0 = time.perf_counter()
        proc = _launch(launcher, [sys.executable, "-c",
                                  _STREAM_SCALE_CHILD.format(
                                      repo=REPO, root=root,
                                      n_cells=STREAM_SCALE_CELLS)], 900)
        wall = time.perf_counter() - t0
        lines = proc["stdout"].splitlines()
        for line in lines:
            if not line.startswith("STREAM_SCALE "):
                log(line)
        log(f"[stream-scale] child exit {proc['rc']} after {wall!r} s")
        rec = [json.loads(ln[len("STREAM_SCALE "):]) for ln in lines
               if ln.startswith("STREAM_SCALE ")]
        if proc["rc"] != 0 or not rec:
            raise AssertionError(f"[stream-scale] the child failed: "
                                 f"{proc['stderr'][-2000:]}")
        rec = rec[0]
        launches = 0
        for tag in ("cold", "steady"):
            r = rec[tag]
            sm = r["streaming"]
            log(f"[stream-scale-{tag}] wall {r['wall_s']!r} s, "
                f"{r['cells_per_s']!r} cells/s; peak_rss_mb "
                f"{sm['budget']['peak_rss_mb']!r} of "
                f"{sm['budget']['limit_mb']!r} (within_budget "
                f"{sm['budget']['within_budget']}); peak_staged_mb "
                f"{sm['budget']['peak_staged_mb']!r}; chunks "
                f"{json.dumps(sm['chunks'])}; halvings "
                f"{sm['window']['halvings']}; embed {r['embed_regime']}; "
                f"chunk loads {json.dumps(r['chunk_loads'])}; store "
                f"{r['store_bytes']} bytes; peak device memory "
                f"{r['peak_device_bytes']} bytes; launches "
                f"{r['launches']}")
            if not (sm["complete"] and sm["budget"]["within_budget"]):
                raise AssertionError(f"[stream-scale-{tag}] incomplete or "
                                     "over the host budget")
            if not np.isfinite(r["silhouettes"]).all():
                raise AssertionError(f"[stream-scale-{tag}] a silhouette "
                                     "is not finite")
            launches += r["launches"]
        # the 10M finding, reckoned: brain10m's first chunk at its full
        # cell count against the default stage budget
        stage = int(env_flag("SCC_STREAM_STAGE_BUDGET_MB")) << 20
        if rec["n_cells"] != STREAM_SCALE_CELLS:
            raise AssertionError(f"[stream-scale] the child ran "
                                 f"{rec['n_cells']} cells")
        for n, charge_of in charges.items():
            nnz, charge = charge_of.result()
            log(f"[stream-scale] brain10m at {n} cells: the first chunk "
                f"holds {nnz} stored entries, charged {charge} bytes "
                f"against the {stage}-byte stage budget "
                f"({'fits' if charge <= stage else 'breaks it'})")
        return launches
    finally:
        reckon.shutdown()
        shutil.rmtree(root, ignore_errors=True)


# --------------------------------------------------------------------------
# phases 28-30: the oracles, the run record with the kernel capture, the
# soak workers
# --------------------------------------------------------------------------

# the reference's statistical parity bars between the production edgeR
# engine and the direct per-pair oracle (tests/test_edger_parity.py:
# 53-84, 130-165): common dispersion within a factor of 2, tagwise
# dispersions log-correlated above 0.6, log p Spearman above 0.95 per pair,
# DE calls at log(0.01 / G) agreeing on more than 95 % of entries, planted
# fold changes (|log fc| > log 2) within a median 0.2
EDGER_ORACLE_BARS = dict(common_ratio=(0.5, 2.0), tagwise_corr=0.6,
                         spearman=0.95, agree=0.95, logfc_median=0.2)


def _edger_oracle_bars(tag: str, new, old, hold_tagwise: bool) -> dict:
    """The parity bars between ``new`` (the engine: tensors) and ``old``
    (the oracle: host arrays), logged and asserted."""
    from scipy.stats import spearmanr

    b = EDGER_ORACLE_BARS
    cd = new["common"]
    ratio = cd / np.maximum(old.common_disp, 1e-8)
    lt_new = np.log(np.maximum(new["tagwise"], 1e-8)).ravel()
    lt_old = np.log(np.maximum(old.tagwise_disp, 1e-8)).ravel()
    m = np.isfinite(lt_new) & np.isfinite(lt_old)
    corr = float(np.corrcoef(lt_new[m], lt_old[m])[0, 1])
    lp = new["log_p"]
    rhos = []
    for p in range(lp.shape[0]):
        m = np.isfinite(lp[p]) & np.isfinite(old.log_p[p])
        rhos.append(float(spearmanr(lp[p][m], old.log_p[p][m]).statistic))
    thr = np.log(0.01 / lp.shape[1])
    agree = float(np.nanmean((lp < thr) == (old.log_p < thr)))
    fc = new["log_fc"]
    m = np.isfinite(fc) & np.isfinite(old.log_fc)
    big = m & (np.abs(old.log_fc) > np.log(2.0))
    fc_med = float(np.median(np.abs(fc[big] - old.log_fc[big])))
    got = {"common_ratio": [float(ratio.min()), float(ratio.max())],
           "tagwise_corr": corr, "spearman_min": min(rhos),
           "agree": agree, "logfc_median": fc_med,
           "planted_entries": int(big.sum())}
    log(f"[oracles] {tag}: " + json.dumps(got))
    ok = (b["common_ratio"][0] < got["common_ratio"][0]
          and got["common_ratio"][1] < b["common_ratio"][1]
          and got["spearman_min"] > b["spearman"] and agree > b["agree"]
          and fc_med < b["logfc_median"]
          and (corr > b["tagwise_corr"] or not hold_tagwise))
    if not ok:
        raise AssertionError(f"[oracles] {tag}: past the reference's bars "
                             f"{json.dumps(b)}")
    return got


def phase_oracles() -> None:
    """Phase 28: the reference's test oracles on the card at phase 4's
    2,000 × 800 × 4 data: the direct per-pair NB engine against
    ``pairwise_de(method="edger")``, the naive cut twin against
    ``cutree_hybrid`` for every deepSplit, ``rank_sum_groups`` card
    against CPU."""
    import torch

    from scconsensus_tpu_torch import ReclusterConfig, refine
    from scconsensus_tpu_torch.config import CompatFlags
    from scconsensus_tpu_torch.de.edger_direct import (
        _bucket_pairs,
        run_edger_pairs,
    )
    from scconsensus_tpu_torch.de.engine import filter_clusters, pairwise_de
    from scconsensus_tpu_torch.ops.ranks import rank_sum_groups
    from scconsensus_tpu_torch.ops.treecut import cutree_hybrid
    from scconsensus_tpu_torch.ops.treecut_direct import cutree_hybrid_direct

    data, cons = _small_data()
    G = data.shape[0]
    names, cell_idx = filter_clusters(cons, 10)
    groups = [np.nonzero(cell_idx == k)[0].astype(np.int32)
              for k in range(len(names))]
    pi, pj = (a.astype(np.int32) for a in np.triu_indices(len(names), 1))
    # count scale holds every bar; in compat mode the "counts" are
    # log-normalized values whose tagwise dispersions sit on the grid's
    # floor in both engines, so their correlation is no measure there
    for log_counts in (False, True):
        tag = "edger-compat" if log_counts else "edger-countscale"
        cfg = ReclusterConfig(method="edger", compat=CompatFlags(
            edger_log_counts=log_counts))
        t0 = time.perf_counter()
        de = pairwise_de(data, cons, cfg, device="cuda")
        torch.cuda.synchronize()
        t_engine = time.perf_counter() - t0
        counts = torch.from_numpy(data if log_counts else np.expm1(data))
        t0 = time.perf_counter()
        old = run_edger_pairs(counts.cuda(), _bucket_pairs(groups, pi, pj),
                              G, int(pi.size))
        t_oracle = time.perf_counter() - t0
        log(f"[oracles] {tag}: {pi.size} pairs; engine {t_engine!r} s, "
            f"direct oracle {t_oracle!r} s on the card")
        _edger_oracle_bars(tag, {
            "common": de.aux["common_dispersion"].cpu().numpy(),
            "tagwise": de.aux["tagwise_dispersion"].cpu().numpy(),
            "log_p": de.log_p.cpu().numpy(),
            "log_fc": de.log_fc.cpu().numpy()}, old,
            hold_tagwise=not log_counts)

    res = refine(data, cons, ReclusterConfig(), device="cuda")
    t0 = time.perf_counter()
    for ds in range(5):
        kw = dict(deep_split=ds, min_cluster_size=10)
        a = cutree_hybrid(res.cell_tree, res.embedding, **kw)
        b = cutree_hybrid_direct(res.cell_tree, res.embedding, **kw)
        if not np.array_equal(a, b):
            raise AssertionError(f"[oracles] deepSplit {ds}: the naive cut "
                                 "differs from cutree_hybrid")
    log(f"[oracles] cutree_hybrid_direct = cutree_hybrid on the card run's "
        f"tree (2,000 cells) for deepSplit 0-4 in "
        f"{time.perf_counter() - t0!r} s")

    # pair (0, 1)'s cells across every gene: ties at zero throughout
    cells = np.concatenate([groups[0], groups[1]])
    x = torch.from_numpy(np.ascontiguousarray(data[:, cells]))
    g1 = torch.zeros(cells.size, dtype=torch.bool)
    g1[: groups[0].size] = True
    (rs, ties) = rank_sum_groups(x.cuda(), g1.cuda(), (~g1).cuda())
    (rs_c, ties_c) = rank_sum_groups(x, g1, ~g1)
    # rank sums are sums of halves below 2^24: exact in float32 in any
    # order. A tie sum Σ(t³ − t) passes 2^24 once a tie run holds ~256
    # cells (the zeros here), and then rounds by the order it is summed in
    tie_rel = float(((ties.cpu() - ties_c).abs() / ties_c.clamp_min(1.0))
                    .max())
    if not torch.equal(rs.cpu(), rs_c) or tie_rel > 1e-6:
        raise AssertionError(f"[oracles] rank_sum_groups: card != CPU "
                             f"(tie sums within {tie_rel})")
    log(f"[oracles] rank_sum_groups on {tuple(x.shape)}: rank sums card = "
        f"CPU bit for bit, tie sums within {tie_rel!r} relative (max "
        f"{float(ties_c.max())!r})")


def _cu_kernel(name: str):
    """The ``__global__`` function of ``csrc/distance_cluster_sums.cu``
    that a profiler kernel name belongs to, or None (torch's own kernels,
    ``at::native::reduce_kernel`` among them, are not the .cu's)."""
    import re

    if "at::" in name:
        return None
    m = re.search(r"\b(keys|prepare|sweep|reduce)_kernel\b", name)
    return m.group(0) if m else None


def phase_trace_full(data, truth, cons, wilcox_ref, main_rec) -> tuple:
    """Phases 29 and 33: phase 7's run again with ``SCC_TRACE_DIR``,
    ``SCC_OBS_KERNELS`` under ``OUT_DIR`` and ``SCC_OBS_COST``: phase
    7's bits, both exported files and the ``kernels`` section validated,
    the hand kernel's sweeps under span ``silhouette`` as many as the
    launch counter and the wrapper's plan give; the ``kernels`` section's
    ``vs_cost_model`` for ``wilcox_test`` and the record's ``profile``
    with the card's time under ``silhouette``, each stage's cost-model
    FLOPs, bytes and rates printed. Returns (launches, the printed
    numbers)."""
    import shutil

    import torch

    from scconsensus_tpu_torch import recluster_de_consensus_fast
    from scconsensus_tpu_torch.obs.export import (
        build_run_record,
        validate_run_record,
    )
    from scconsensus_tpu_torch.obs.kernels import validate_kernels
    from scconsensus_tpu_torch.ops.cuda_kernels import launch_plan
    from scconsensus_tpu_torch.ops.silhouette import cut_labels

    root = os.path.join(OUT_DIR, "phase29")
    shutil.rmtree(root, ignore_errors=True)
    trace_dir = os.path.join(root, "trace")
    kern_dir = os.path.join(root, "kernels")
    with _env(SCC_TRACE_DIR=trace_dir, SCC_OBS_KERNELS=kern_dir,
              SCC_OBS_COST="1"):
        res, launches = _run_full(
            "trace-26k", lambda: recluster_de_consensus_fast(
                data, cons, device="cuda"), truth)
    _same_bits("trace-26k", res, wilcox_ref)
    if not np.array_equal(res.de.de_mask.cpu().numpy(),
                          wilcox_ref["de_mask"]):
        raise AssertionError("[trace-26k] the DE mask differs from "
                             "phase 7's")
    m = res.metrics
    with open(os.path.join(trace_dir, "run_record.json")) as f:
        rec = json.load(f)
    validate_run_record(rec)
    with open(os.path.join(trace_dir, "trace.json")) as f:
        chrome = json.load(f)
    xs = [e for e in chrome["traceEvents"] if e.get("ph") == "X"]
    if len(xs) != len(rec["spans"]) or not rec["spans"]:
        raise AssertionError(f"[trace-26k] {len(xs)} X events for "
                             f"{len(rec['spans'])} spans")
    sec = m.get("kernels")
    if not sec or sec.get("error"):
        raise AssertionError(f"[trace-26k] no kernels section: {sec}")
    validate_kernels(sec)
    validate_run_record(build_run_record(
        "refine() at 26k", m["wall_s"], spans=m["spans"], kernels=sec,
        quality=m.get("quality")))
    # the hand kernel: one sweep per group of cuts per wrapper launch
    labs = [np.where(res.dynamic_labels[f"deepsplit: {i['deep_split']}"] > 0,
                     res.dynamic_labels[f"deepsplit: {i['deep_split']}"], -1)
            for i in res.deep_split_info]
    ids, k_total, _ = cut_labels(labs)
    n, d = res.embedding.shape
    plan = launch_plan(n, d, ids.shape[1], k_total, torch.device("cuda"))
    want = launches * len(plan["groups"])
    mine = {name: row for name, row in sec["by_kernel"].items()
            if _cu_kernel(name)}
    sweeps = {name: row for name, row in mine.items()
              if _cu_kernel(name) == "sweep_kernel"}
    n_sweeps = sum(r["count"] for r in sweeps.values())
    cu = {_cu_kernel(name): row for name, row in mine.items()}
    log("[trace-26k] the .cu's kernels in the capture: " + json.dumps(cu))
    if n_sweeps != want or any(r["span"] != "silhouette"
                               or r["stage"] != "silhouette"
                               for r in mine.values()):
        raise AssertionError(
            f"[trace-26k] {n_sweeps} sweep launches (want {want}: "
            f"{launches} wrapper launches x {len(plan['groups'])} groups) "
            "or a .cu kernel outside span silhouette")
    sweep_ms = 1e3 * sum(r["device_time_s"] for r in sweeps.values()) \
        / max(n_sweeps, 1)
    cu_ms = 1e3 * sum(r["device_time_s"] for r in mine.values()) \
        / max(launches, 1)
    busy = sec["total_device_time_s"] / m["wall_s"]
    # the same device time over the run without the profiler's window
    busy_phase7 = sec["total_device_time_s"] / wilcox_ref["wall_s"]
    out = {
        "wall_s": m["wall_s"], "phase7_wall_s": wilcox_ref["wall_s"],
        "overhead": m["wall_s"] / wilcox_ref["wall_s"] - 1.0,
        "total_device_time_s": sec["total_device_time_s"],
        "busy_share": busy, "busy_share_of_phase7_wall": busy_phase7,
        "stages_s": m["total_s"], "capture_start_s": sec["start_s"],
        "n_events": sec["n_events"],
        "n_kernels": sec["n_kernels"], "n_unlinked": sec["n_unlinked"],
        "n_windows": sec["n_windows"], "trace_bytes": sec["trace_bytes"],
        "trace_gz_bytes": sec["trace_gz_bytes"], "export_s": sec["export_s"],
        "sweep_profiler_ms": sweep_ms, "sweep_count": n_sweeps,
        "cu_kernels_profiler_ms": cu_ms,
        "kernel_event_ms": main_rec["ms"],
        "record_spans": len(rec["spans"]),
        "by_stage_device_s": sec["by_stage_device_s"],
    }
    # phase 33: the cost model beside the profiler's device time
    vs = sec.get("vs_cost_model") or {}
    wt = vs.get("wilcox_test") or {}
    prof = (rec.get("profile") or {}).get("stages") or {}
    sil = prof.get("silhouette") or {}
    if not wt.get("flops") or not sil.get("device_s"):
        raise AssertionError(
            f"[cost-26k] vs_cost_model wilcox_test {wt}, profile "
            f"silhouette {sil}")
    cost = rec["extra"].get("stage_throughput") or {}
    for name, row in sorted(cost.items()):
        v = vs.get(name) or {}
        log(f"[cost-26k] {name}: {row['flops']!r} FLOPs, "
            f"{row['bytes_accessed']!r} bytes, {row['transcendentals']!r} "
            f"transcendentals in {row['kernels']} costed calls; wall "
            f"{row['wall_s']!r} s, {row.get('achieved_gflops')!r} GFLOP/s "
            f"and {row.get('achieved_gbps')!r} GB/s by wall; device "
            f"{v.get('device_time_s')!r} s, "
            f"{v.get('achieved_gflops_device')!r} GFLOP/s and "
            f"{v.get('achieved_gbps_device')!r} GB/s by device time")
    log(f"[cost-26k] profile silhouette: {json.dumps(sil)}; the .cu's "
        f"kernels {sum(r['device_time_s'] for r in mine.values())!r} s "
        "of it")
    out["stage_cost"] = cost
    out["vs_cost_model"] = vs
    out["profile_silhouette"] = sil
    log("[trace-26k] top kernels by device time:")
    for row in sec["top"]:
        log(f"[trace-26k]   {row['device_time_s']!r} s x {row['count']} "
            f"({row['pct']} %) span {row['span']} stage {row['stage']}: "
            f"{row['kernel'][:120]}")
    log(f"[trace-26k] device busy {sec['total_device_time_s']!r} s of the "
        f"{m['wall_s']!r} s wall: {busy!r} ({busy_phase7!r} of phase 7's "
        f"wall); the sweep {sweep_ms!r} ms and the .cu's four kernels "
        f"{cu_ms!r} ms a launch by the profiler against "
        f"{main_rec['ms']!r} ms by CUDA events in phase 7; wall "
        f"{m['wall_s']!r} s (stages {m['total_s']!r} s) against phase 7's "
        f"{wilcox_ref['wall_s']!r} s; profiler start {sec['start_s']!r} s, "
        f"export {sec['export_s']!r} s; trace {sec['trace_bytes']} bytes "
        f"({sec['trace_gz_bytes']} gzipped)")
    log("[trace-26k] " + json.dumps(out))
    out["record"] = _flagship_record(m, kernels=sec)
    return launches, out


# phase 30's five integrity-soak runs (the worker's default shape,
# 3,000 × 120 × 3): (tag, extra arguments)
SOAK_FORMS = (("default", ()), ("stream", ("--stream",)),
              ("stream-window", ("--stream", "--stream-window", "16")),
              ("mesh-8", ("--mesh", "8")), ("cpu", ("--device", "cpu")))


def phase_soak_workers(launcher) -> dict:
    """Phase 30: ``python -m scconsensus_tpu_torch.robust.soak`` in fresh
    processes from the launcher (started before torch), five ways at
    once; each exits 0, its summary's run record validates, all give one
    ``labels_sha``. The ``--stream`` runs use the default host budget over
    their own baseline."""
    import shutil
    import tempfile

    from scconsensus_tpu_torch.obs.export import validate_run_record

    root = tempfile.mkdtemp(prefix="scc-soak-")
    shas, out = {}, {}
    try:
        argvs = []
        for tag, extra in SOAK_FORMS:
            argv = [sys.executable, "-m", "scconsensus_tpu_torch.robust.soak",
                    "--dir", os.path.join(root, tag), "--fresh", *extra]
            if "--device" not in extra:
                argv += ["--device", "cuda"]
            # the default host budget whatever this process was given
            argvs.append(["env", "-u", "SCC_STREAM_HOST_BUDGET_MB", *argv])
        # the five runs at once: each judges its own peak RSS against
        # its own baseline, so they need not wait for each other
        t0 = time.perf_counter()
        procs = _launch_all(launcher, argvs, 600)
        wall = time.perf_counter() - t0
        for (tag, _), proc in zip(SOAK_FORMS, procs):
            workdir = os.path.join(root, tag)
            try:
                with open(os.path.join(
                        workdir, "INTEGRITY_SOAK_SUMMARY.json")) as f:
                    summary = json.load(f)
            except OSError:
                summary = None
            if proc["rc"] != 0 or summary is None or not summary["ok"]:
                raise AssertionError(
                    f"[soak-{tag}] exit {proc['rc']}: "
                    f"{proc['stderr'][-2000:]}")
            rec = summary["record"]
            validate_run_record(rec)
            shas[tag] = summary["labels_sha"]
            out[tag] = {"process_s": wall, "wall_s": summary["wall_s"],
                        "spans": len(rec["spans"])}
            budget = (rec.get("streaming") or {}).get("budget")
            if budget is not None:
                out[tag]["budget"] = budget
                if not budget["within_budget"] or \
                        budget.get("budget_mb") != 4096.0:
                    raise AssertionError(f"[soak-{tag}] not within the "
                                         f"default budget: {budget}")
            log(f"[soak-{tag}] exit 0, the five in {wall!r} s (refine "
                f"{summary['wall_s']!r} s); labels_sha "
                f"{summary['labels_sha'][:16]}; record validates"
                + (f"; budget {json.dumps(budget)}" if budget else ""))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if len(set(shas.values())) != 1:
        raise AssertionError(f"[soak] the five runs disagree: {shas}")
    log(f"[soak] one labels_sha over the five runs: "
        f"{next(iter(shas.values()))}")
    return out


# ---------------------------------------------------------------------------
# phases 31-35: refine() under the reference's observation flags
# ---------------------------------------------------------------------------

# the declared crossings the audited 26k Wilcoxon run must make (phase 31)
AUDIT_BOUNDARIES = ("input_staging", "funnel_counts", "embed_scores_fetch",
                    "silhouette_slab_fetch", "label_fetch")
NEW_SECTIONS = ("residency", "profile", "residency_burndown",
                "host_profile", "memory_timeline")


def _implicit_syncs(spans) -> dict:
    """The residency auditor's count of synchronizing operations no
    patched call made, by stage span and source line (span metrics
    ``implicit_sync:<file>:<line>``)."""
    out = {}
    for s in spans:
        for name, m in (s.get("metrics") or {}).items():
            if name.startswith("implicit_sync:"):
                key = f"{s['name']}@{name[len('implicit_sync:'):]}"
                out[key] = out.get(key, 0) + int(m.get("value") or 0)
    return out


def _per_call_s(fn, reps: int = 20000) -> float:
    """Host seconds a call of ``fn`` takes, over ``reps`` calls."""
    for _ in range(200):
        fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


def _crossing_hook_costs(data, cons, truth, wilcox_ref) -> dict:
    """The two ways to see crossings, priced on the 26k run: the
    patched entry points (the auditor's) pay a wrapper on the patched
    methods' calls; a ``torch.overrides.TorchFunctionMode`` pays a Python
    dispatch on every torch call. One run under a counting mode gives
    both call counts; each per-call overhead is measured on the card."""
    import torch
    from torch.overrides import TorchFunctionMode

    from scconsensus_tpu_torch import recluster_de_consensus_fast
    from scconsensus_tpu_torch.obs.residency import ResidencyAuditor

    T = torch.Tensor
    patched = {T.cpu, T.cuda, T.to, T.item, T.tolist, T.numpy, T.__bool__,
               T.__int__, T.__float__, T.copy_, torch.as_tensor,
               torch.tensor, torch.from_numpy}

    class Counting(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.calls = 0
            self.patched = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            self.calls += 1
            if func in patched:
                self.patched += 1
            return func(*args, **(kwargs or {}))

    mode = Counting()
    with mode:
        res, launches = _run_full(
            "hook-mode-26k", lambda: recluster_de_consensus_fast(
                data, cons, device="cuda"), truth)
    _same_bits("hook-mode-26k", res, wilcox_ref)
    x = torch.ones(8, device="cuda")
    torch.cuda.synchronize()
    plain_view = _per_call_s(lambda: x.view(-1))
    with Counting():
        mode_view = _per_call_s(lambda: x.view(-1))
    plain_to = _per_call_s(lambda: x.to(torch.float32))
    with ResidencyAuditor(mode="audit"):
        hook_to = _per_call_s(lambda: x.to(torch.float32))
    wall = wilcox_ref["wall_s"]
    out = {
        "torch_calls": mode.calls, "patched_calls": mode.patched,
        "mode_per_call_s": mode_view - plain_view,
        "patch_per_call_s": hook_to - plain_to,
        "mode_wall_s": res.metrics["wall_s"], "phase7_wall_s": wall,
    }
    out["mode_share"] = mode.calls * out["mode_per_call_s"] / wall
    out["patch_share"] = mode.patched * out["patch_per_call_s"] / wall
    log(f"[hook-cost] {mode.calls} torch calls in the 26k run, "
        f"{mode.patched} of them to patched entry points; a "
        f"TorchFunctionMode costs {out['mode_per_call_s']!r} s a call "
        f"({out['mode_share']!r} of phase 7's wall), the patches "
        f"{out['patch_per_call_s']!r} s a patched call "
        f"({out['patch_share']!r}); the run under the counting mode "
        f"{out['mode_wall_s']!r} s against phase 7's {wall!r} s")
    return out, launches


def _devcache_on_card(data) -> dict:
    """The upload cache (``utils.devcache``) at the 26k matrix's size: a
    host copy of phase 6's matrix uploaded (a miss), then the same array
    twice more (hits, each paying the content check's float64 full-sum
    pass on the host), each timed to the card's synchronize; the cached
    buffer the same bits as the card's matrix."""
    import torch

    from scconsensus_tpu_torch.utils import devcache

    host = data.cpu().numpy()
    devcache.reset_stats()
    times, bufs = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bufs.append(devcache.device_put_cached(host, "cuda"))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    stats = dict(devcache.STATS)
    same = bool(torch.equal(bufs[0], data))
    devcache.clear_cache()
    out = {"miss_s": times[0], "hit_s": times[1:], "stats": stats,
           "bytes": int(host.nbytes)}
    log(f"[devcache-26k] a host copy of phase 6's matrix ({host.nbytes} "
        f"bytes): upload (miss) {times[0]!r} s, then hits {times[1:]!r} s "
        f"(the content check's full sum on the host); {json.dumps(stats)}")
    if stats != {"hits": 2, "misses": 1} or bufs[1] is not bufs[0] or \
            not same:
        raise AssertionError(f"[devcache-26k] {stats}, same bits {same}")
    return out


def phase_audit_full(data, truth, cons, wilcox_ref) -> tuple:
    """Phase 31: phase 7's run under ``SCC_OBS_RESIDENCY=audit``,
    ``SCC_OBS_TRANSFERS`` and ``SCC_HOSTPROF`` (and ``SCC_TRACE_DIR``
    under ``OUT_DIR/phase31/``), twice: phase 7's bits, the declared
    crossings the path makes, transfer bytes by stage, the exported
    record with its five new sections validated, the auditor's
    ``consumed_cpu_s`` under 2 % of the wall (best of 2), the audited
    wall beside phase 7's, and the two hook designs priced. Returns
    (launches, the printed numbers)."""
    import shutil

    from scconsensus_tpu_torch import recluster_de_consensus_fast
    from scconsensus_tpu_torch.obs import residency
    from scconsensus_tpu_torch.obs.export import validate_run_record

    from scconsensus_tpu_torch.utils import devcache

    root = os.path.join(OUT_DIR, "phase31")
    shutil.rmtree(root, ignore_errors=True)
    runs, launches = [], 0
    devcache.reset_stats()
    for i in range(2):
        tag = f"audit-26k-{i}"
        trace_dir = os.path.join(root, f"run{i}")
        residency.reset_cpu()
        with _env(SCC_OBS_RESIDENCY="audit", SCC_OBS_TRANSFERS="1",
                  SCC_HOSTPROF="1", SCC_TRACE_DIR=trace_dir):
            res, n = _run_full(tag, lambda: recluster_de_consensus_fast(
                data, cons, device="cuda"), truth)
        consumed = residency.consumed_cpu_s()
        launches += n
        _same_bits(tag, res, wilcox_ref)
        if not np.array_equal(res.de.de_mask.cpu().numpy(),
                              wilcox_ref["de_mask"]):
            raise AssertionError(f"[{tag}] the DE mask differs")
        m = res.metrics
        rep = m["residency"]
        missing = set(AUDIT_BOUNDARIES) - set(rep["by_boundary"])
        if missing:
            raise AssertionError(f"[{tag}] no crossing at {sorted(missing)}"
                                 f": {rep['by_boundary']}")
        with open(os.path.join(trace_dir, "run_record.json")) as f:
            rec = json.load(f)
        absent = [k for k in NEW_SECTIONS if k not in rec]
        if absent:
            raise AssertionError(f"[{tag}] the record lacks {absent}")
        validate_run_record(rec)
        hp = rec["host_profile"]
        share = consumed / m["wall_s"]
        run = {"wall_s": m["wall_s"], "consumed_cpu_s": consumed,
               "share": share, "to_host": rep["to_host"],
               "to_device": rep["to_device"], "by_stage": rep["by_stage"],
               "by_boundary": rep["by_boundary"],
               "events_dropped": rep["events_dropped"],
               "transfers": m["transfers"],
               "implicit_syncs": _implicit_syncs(m["spans"]),
               "host_samples": hp["n_samples"],
               "host_sampler_self_s": hp["sampler_self_s"],
               "blocking_wait_s": sum(r["causes"]["blocking_wait"]
                                      for r in hp["stages"].values()),
               "rss_peak_bytes": rec["memory_timeline"]["rss_peak_bytes"],
               "hbm_peak_bytes": rec["memory_timeline"].get(
                   "hbm_peak_bytes"),
               "burndown": {k: rec["residency_burndown"][k] for k in
                            ("total_bytes", "todo_item2_bytes")}}
        runs.append(run)
        if i == 0:
            records = [_flagship_record(
                m, residency=rep, host_profile=m["host_profile"],
                memory_timeline=m["memory_timeline"])]
        log(f"[{tag}] wall {m['wall_s']!r} s against phase 7's "
            f"{wilcox_ref['wall_s']!r} s; auditor {consumed!r} s "
            f"({share!r} of the wall); d2h {json.dumps(rep['to_host'])}, "
            f"h2d {json.dumps(rep['to_device'])}")
        log(f"[{tag}] bytes by stage: " + json.dumps(rep["by_stage"]))
        log(f"[{tag}] bytes by boundary: " + json.dumps(rep["by_boundary"]))
        log(f"[{tag}] transfer watch: " + json.dumps(m["transfers"]))
        log(f"[{tag}] implicit syncs by stage@line: "
            + json.dumps(run["implicit_syncs"]))
        log(f"[{tag}] host profile: {hp['n_samples']} samples, sampler "
            f"{hp['sampler_self_s']!r} s, blocking_wait "
            f"{run['blocking_wait_s']!r} s; rss peak "
            f"{run['rss_peak_bytes']} bytes, hbm peak "
            f"{run['hbm_peak_bytes']} bytes; burn-down "
            + json.dumps(run["burndown"]))
    # phase 6's matrix is a card tensor: as_device_matrix takes it as it
    # is, so the upload cache sees neither run
    cache = dict(devcache.STATS)
    log(f"[audit-26k] upload cache over the two audited runs: "
        f"{json.dumps(cache)} (the matrix is drawn on the card)")
    if cache != {"hits": 0, "misses": 0}:
        raise AssertionError(f"[audit-26k] the cache saw a card tensor: "
                             f"{cache}")
    best = min(r["share"] for r in runs)
    log(f"[audit-26k] the auditor's best share {best!r} (limit "
        f"{LAYER_SHARE_LIMIT})")
    if not best < LAYER_SHARE_LIMIT:
        raise AssertionError("[audit-26k] the auditor costs 2 % or more of "
                             "the wall")
    hooks, n = _crossing_hook_costs(data, cons, truth, wilcox_ref)
    launches += n
    out = {"runs": runs, "best_share": best, "hooks": hooks,
           "devcache": _devcache_on_card(data)}
    log("[audit-26k] " + json.dumps(out, default=str))
    out["record"] = records[0]
    return launches, out


def phase_enforce_full(data, truth, cons, wilcox_ref, mesh_ref) -> int:
    """Phase 32: phase 7's run under ``SCC_OBS_RESIDENCY=enforce`` (phase
    7's bits, no violation, every stored d2h event on a declared
    boundary); an undeclared ``.cpu()`` inside a stage span raises
    ``ResidencyError`` naming the span and this file's line; phase 26's
    4-shard mesh run once under enforce with no violation and phase 26's
    labels. Returns the launches."""
    import torch

    from scconsensus_tpu_torch import recluster_de_consensus_fast
    from scconsensus_tpu_torch.obs.residency import (
        ResidencyAuditor,
        ResidencyError,
    )
    from scconsensus_tpu_torch.obs.trace import Tracer
    from scconsensus_tpu_torch.parallel import make_mesh

    def check(tag, res):
        rep = res.metrics["residency"]
        d2h = [e for e in rep["events"] if e["direction"] == "d2h"]
        loose = [e for e in d2h if e["boundary"] is None]
        log(f"[{tag}] mode {rep['mode']}: {len(rep['violations'])} "
            f"violations, {len(d2h)} stored d2h events "
            f"({rep['to_host']['calls']} in all), {len(loose)} on no "
            "boundary; boundaries " + json.dumps(rep["by_boundary"]))
        if rep["mode"] != "enforce" or rep["violations"] or loose \
                or not d2h:
            raise AssertionError(f"[{tag}] {rep['violations']} {loose}")

    with _env(SCC_OBS_RESIDENCY="enforce"):
        res, launches = _run_full(
            "enforce-26k", lambda: recluster_de_consensus_fast(
                data, cons, device="cuda"), truth)
    _same_bits("enforce-26k", res, wilcox_ref)
    check("enforce-26k", res)
    del res
    t = torch.ones(4, device="cuda")
    tr = Tracer()
    try:
        with ResidencyAuditor(mode="enforce"), \
                tr.span("silhouette", kind="stage"):
            t.cpu()
    except ResidencyError as e:
        msg = str(e)
    else:
        raise AssertionError("[enforce-undeclared] an undeclared .cpu() "
                             "did not raise")
    log(f"[enforce-undeclared] {msg}")
    if "span silhouette" not in msg or \
            f"{os.path.basename(__file__)}:" not in msg:
        raise AssertionError("[enforce-undeclared] the error names neither "
                             "the span nor the line")
    with _env(SCC_OBS_RESIDENCY="enforce"):
        res, n = _run_full(
            "enforce-mesh-26k", lambda: recluster_de_consensus_fast(
                data, cons, device="cuda",
                mesh=make_mesh(4, device="cuda")), truth)
    check("enforce-mesh-26k", res)
    for key, want in mesh_ref["summary"]["labels"].items():
        if not np.array_equal(res.dynamic_labels[key], want):
            raise AssertionError(f"[enforce-mesh-26k] {key}: labels differ "
                                 "from phase 26's")
    return launches + n


def phase_probe_full(data, truth, cons, wilcox_ref) -> tuple:
    """Phase 34: phase 7's run under ``SCC_WILCOX_PROBE=1``: phase 7's
    bits, every bucket with its synced ``wall_s`` and sort-only
    ``sort_s``, the buckets' walls summing to no more than
    ``wilcox_test``'s; the sort and contraction split printed."""
    from scconsensus_tpu_torch import recluster_de_consensus_fast

    with _env(SCC_WILCOX_PROBE="1"):
        res, launches = _run_full(
            "probe-26k", lambda: recluster_de_consensus_fast(
                data, cons, device="cuda"), truth)
    _same_bits("probe-26k", res, wilcox_ref)
    lad = res.metrics["wilcox_ladder"]
    buckets = lad["buckets"]
    if not buckets or any("wall_s" not in b or "sort_s" not in b
                          for b in buckets):
        raise AssertionError("[probe-26k] a bucket lacks wall_s or sort_s")
    walls = sum(b["wall_s"] for b in buckets)
    sorts = sum(b["sort_s"] for b in buckets)
    stage = res.metrics["stage_walls_s"]["wilcox_test"]
    out = {"buckets": len(buckets), "bucket_walls_s": walls,
           "sort_s": sum(b["sort_s"] for b in buckets),
           "wilcox_test_s": stage, "ladder_wall_s": lad.get("ladder_wall_s"),
           "by_bucket": [{k: b.get(k) for k in
                          ("window", "n_genes", "wall_s", "sort_s",
                           "tied_runs_p50", "tied_runs_max")}
                         for b in buckets]}
    log(f"[probe-26k] {len(buckets)} buckets: walls {walls!r} s, of them "
        f"sort {sorts!r} s, the rest (ranks, contraction, p) "
        f"{walls - sorts!r} s; wilcox_test {stage!r} s; ladder "
        f"{lad.get('ladder_wall_s')!r} s")
    log("[probe-26k] " + json.dumps(out))
    if walls > stage:
        raise AssertionError("[probe-26k] the bucket walls exceed "
                             "wilcox_test's")
    return launches, out


_LIVE_CHILD = """
import os, sys
sys.path.insert(0, {repo!r})
import chip_smoke
from scconsensus_tpu_torch import recluster_de_consensus_fast
from scconsensus_tpu_torch.obs.live import LiveRecorder
from scconsensus_tpu_torch.ops.cuda_kernels import distance_cluster_sums

data, truth, cons = chip_smoke.phase_full_data()
rec = LiveRecorder({base!r}, metric="refine() under the flight recorder",
                   extra={{"config": "flagship_26k", "platform": "gpu",
                          "method": "wilcox"}}, heartbeat_s=1.0).start()
distance_cluster_sums.launches = 0
recluster_de_consensus_fast(data, cons, device="cuda")
rec.stop()
print("LIVE_LAUNCHES", distance_cluster_sums.launches, flush=True)
"""


def _hb_lines(path: str) -> list:
    try:
        with open(path) as f:
            return [json.loads(ln) for ln in f if ln.strip().startswith("{")]
    except (OSError, ValueError):
        return []


def _live_start(tag: str, root: str, env: dict) -> dict:
    """Start one phase-35 child: phase 7's refine under a
    ``LiveRecorder`` with a 1 s heartbeat."""
    base = os.path.join(root, tag)
    proc = subprocess.Popen(
        [sys.executable, "-c", _LIVE_CHILD.format(repo=REPO, base=base)],
        env=dict(os.environ, **env), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    return {"tag": tag, "base": base, "proc": proc,
            "t0": time.perf_counter()}


def _live_finish(child: dict, stop_at=None) -> dict:
    """Collect a phase-35 child started by ``_live_start``. With
    ``stop_at``, SIGTERM it once a heartbeat shows that stage span open.
    Returns its exit code, stream, partial record and launches; its wall
    runs from its start to its collection."""
    import signal

    tag, base, proc, t0 = (child[k] for k in ("tag", "base", "proc", "t0"))
    try:
        if stop_at is not None:
            hb = base + "_heartbeat.jsonl"
            while proc.poll() is None and time.perf_counter() - t0 < 300:
                if any(any(s["name"] == stop_at for s in
                           ln.get("open_spans") or [])
                       for ln in _hb_lines(hb) if ln.get("t") == "hb"):
                    proc.send_signal(signal.SIGTERM)
                    break
                time.sleep(0.2)
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    wall = time.perf_counter() - t0
    launches = [int(ln.split()[1]) for ln in out.splitlines()
                if ln.startswith("LIVE_LAUNCHES ")]
    try:
        with open(base + "_partial.json") as f:
            partial = json.load(f)
    except (OSError, ValueError):
        partial = None
    lines = _hb_lines(base + "_heartbeat.jsonl")
    log(f"[live-{tag}] exit {proc.returncode} after {wall!r} s; "
        f"{sum(ln.get('t') == 'hb' for ln in lines)} heartbeats, events "
        f"{sorted({ln.get('t') for ln in lines})}")
    return {"rc": proc.returncode, "lines": lines, "partial": partial,
            "launches": launches[0] if launches else 0, "wall_s": wall,
            "stderr": err}


LIVE_STAGE = "tree"  # the stage phase 35 stalls in and signals during


def phase_live() -> tuple:
    """Phase 35: three children, started at once, run phase 7's refine
    under a ``LiveRecorder`` (1 s heartbeat): a clean one (the heartbeat
    carries the open spans, RSS, the card's memory and progress; the
    final partial is stamped ``clean``); one with ``SCC_OBS_STALL_S=3`` and a
    6 s stall fault inside stage ``tree`` (its stream has a ``stall``
    event with the stacks and the open stage); one held in stage ``tree``
    by the same fault and sent SIGTERM there (a partial record stamped
    ``signal`` naming the open stage, valid, which the ledger ingests as
    partial). Returns (launches, the printed numbers)."""
    import shutil
    import tempfile

    from scconsensus_tpu_torch.obs.export import validate_run_record
    from scconsensus_tpu_torch.obs.ledger import (
        Ledger,
        is_partial_entry,
        is_partial_record,
    )

    root = tempfile.mkdtemp(prefix="scc-live-")
    plan = os.path.join(root, "stall.json")
    with open(plan, "w") as f:
        json.dump({"faults": [{"site": f"stage:{LIVE_STAGE}",
                               "class": "stall", "stall_s": 6.0}]}, f)
    t0 = time.perf_counter()
    children = {
        "clean": _live_start("clean", root, {}),
        "stall": _live_start("stall", root, {"SCC_OBS_STALL_S": "3",
                                             "SCC_FAULT_PLAN": plan}),
        # held in the stage by the same stall, so the signal lands there
        "sigterm": _live_start("sigterm", root, {"SCC_FAULT_PLAN": plan})}
    try:
        term = _live_finish(children.pop("sigterm"), stop_at=LIVE_STAGE)
        clean = _live_finish(children.pop("clean"))
        stall = _live_finish(children.pop("stall"))
        log(f"[live] the three children, at once, in "
            f"{time.perf_counter() - t0!r} s")
        hbs = [ln for ln in clean["lines"] if ln.get("t") == "hb"]
        if clean["rc"] != 0 or not hbs or \
                (clean["partial"] or {}).get("termination", {}).get(
                    "cause") != "clean":
            raise AssertionError(f"[live-clean] rc {clean['rc']}: "
                                 f"{clean['stderr'][-1500:]}")
        need = ("open_spans", "rss_bytes", "progress_unix", "hbm")
        if not any(all(k in h for k in need) and h["open_spans"]
                   for h in hbs):
            raise AssertionError(f"[live-clean] no heartbeat with {need}")
        validate_run_record(clean["partial"])

        events = [ln for ln in stall["lines"] if ln.get("t") == "stall"]
        if stall["rc"] != 0 or not events or not events[0].get("stack") \
                or not any(s["name"] == LIVE_STAGE
                           for s in events[0]["open_spans"]):
            raise AssertionError(f"[live-stall] rc {stall['rc']}, stall "
                                 f"events {len(events)}: "
                                 f"{stall['stderr'][-1500:]}")
        log(f"[live-stall] stall after {events[0]['since_progress_s']!r} s "
            f"in {[s['name'] for s in events[0]['open_spans']]}; stack dump "
            f"{len(events[0]['stack'])} characters")

        part = term["partial"]
        t = (part or {}).get("termination") or {}
        if term["rc"] != -15 or t.get("cause") != "signal" or \
                t.get("last_span") is None or not any(
                    s["name"] == LIVE_STAGE for s in t["open_spans"]):
            raise AssertionError(f"[live-sigterm] rc {term['rc']}, "
                                 f"termination {t}: "
                                 f"{term['stderr'][-1500:]}")
        validate_run_record(part)
        entry = Ledger(os.path.join(root, "evidence")).ingest(part)
        if not (is_partial_record(part) and is_partial_entry(entry)):
            raise AssertionError(f"[live-sigterm] the ledger entry is not "
                                 f"partial: {entry}")
        log(f"[live-sigterm] partial record: cause {t['cause']}, last span "
            f"{t['last_span']}, open {[s['name'] for s in t['open_spans']]}"
            f"; ledger entry {entry['file']} termination "
            f"{entry['termination']}")
        out = {"clean_s": clean["wall_s"], "stall_s": stall["wall_s"],
               "sigterm_s": term["wall_s"], "heartbeats": len(hbs),
               "stall_since_progress_s": events[0]["since_progress_s"],
               "partial_last_span": t["last_span"]}
        log("[live] " + json.dumps(out))
        return clean["launches"] + stall["launches"], out
    finally:
        for child in children.values():  # a failed collection's siblings
            child["proc"].kill()
            child["proc"].communicate()
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# phases 36-38: the compile log and graph passports, the perf gate and
# perf-diff attribution over the script's own records, the drift sentinel
# ---------------------------------------------------------------------------

# the run key every 26k Wilcoxon record of the script carries, so that the
# evidence ledger files them under one baseline
FLAGSHIP_KEY = {"config": "flagship_26k", "platform": "gpu",
                "method": "wilcox"}
# the programs the fast Wilcoxon path at 26k reaches (phase 36)
WILCOX_PROGRAMS = ("gates.compute_aggregates_cid", "gates.pair_gates_fast",
                   "wilcox.allpairs_ranksum_chunk", "embed.pca_scores")


def _flagship_record(m: dict, **sections) -> dict:
    """A 26k Wilcoxon run's record (``build_run_record``) from its
    metrics, under ``FLAGSHIP_KEY``."""
    from scconsensus_tpu_torch.obs.export import build_run_record

    return build_run_record("refine() at 26k", m["wall_s"],
                            spans=m["spans"], quality=m.get("quality"),
                            extra=dict(FLAGSHIP_KEY), **sections)


_PASSPORT_CHILD = """
import json, os, sys, time
# armed by their flags, as the reference's bench worker arms them
os.environ["SCC_COMPILELOG"] = "1"
os.environ["SCC_GRAPHS"] = "1"
sys.path.insert(0, {repo!r})
import numpy as np
import torch
from scconsensus_tpu_torch.obs import compilelog, graphs
from scconsensus_tpu_torch.obs import device as obs_device
assert compilelog.install_and_mark() and graphs.install_and_mark()
import chip_smoke
from scconsensus_tpu_torch import recluster_de_consensus_fast
from scconsensus_tpu_torch.obs.export import (validate_run_record,
                                              write_json_atomic)
from scconsensus_tpu_torch.ops.cuda_kernels import distance_cluster_sums

data, truth, cons = chip_smoke.phase_full_data()
distance_cluster_sums.launches = 0
torch.cuda.synchronize()
t0 = time.perf_counter()
res = recluster_de_consensus_fast(data, cons, device="cuda")
torch.cuda.synchronize()
m = res.metrics
m["wall_s"] = time.perf_counter() - t0
rec = chip_smoke._flagship_record(m, compile=compilelog.snapshot(),
                                  graphs=graphs.snapshot())
validate_run_record(rec)
write_json_atomic(os.path.join({root!r}, "run_record.json"), rec)
np.savez(os.path.join({root!r}, "result.npz"),
         union=res.de_gene_union_idx, de_mask=res.de.de_mask.cpu().numpy(),
         **{{k.replace(": ", "_"): v for k, v in res.dynamic_labels.items()}})
print("PASSPORT_CHILD " + json.dumps({{
    "launches": distance_cluster_sums.launches,
    "silhouettes": [i["silhouette"] for i in res.deep_split_info],
    "cache_events": obs_device.cache_events(),
    "compile_events": obs_device.compile_events()}}), flush=True)
"""


def _sync_sites(sec: dict) -> dict:
    """``{stage: [kind op@where [program]]}`` of a graphs section's
    transfer ops and host callbacks."""
    out = {}
    for name, p in sorted(sec["programs"].items()):
        for kind, key in (("transfer", "op"), ("callback", "target")):
            block = p["transfer_ops" if kind == "transfer" else
                      "host_callbacks"]
            for site in block["sites"]:
                out.setdefault(p["stage"] or "(outside spans)", []).append(
                    f"{kind} {site[key]}@{site['where']} [{name}]")
    return out


def _passports_start(launcher) -> dict:
    """Start phase 36's child from the launcher (it runs while phase 35's
    children do); ``phase_passports`` collects it."""
    import tempfile

    root = tempfile.mkdtemp(prefix="scc-passports-")
    _launch_start(launcher, [sys.executable, "-c", _PASSPORT_CHILD.format(
        repo=REPO, root=root)], 600)
    return {"root": root, "t0": time.perf_counter()}


def phase_passports(launcher, started, wilcox_ref, audit_out) -> tuple:
    """Phase 36: phase 7's run in a fresh child (from the launcher,
    started by ``_passports_start`` beside phase 35) with
    ``SCC_COMPILELOG=1 SCC_GRAPHS=1``: phase 7's labels, DE mask and union
    and one kernel launch; its record's ``compile`` section (no compile,
    one cache hit per native library, printed with the stage that loaded
    it) and ``graphs`` section (the fast Wilcoxon path's programs, no
    capture error), validated; the passports' transfer ops and host syncs
    by stage and line beside phase 31's implicit syncs. Returns
    (launches, the record, the printed numbers)."""
    import shutil

    from scconsensus_tpu_torch.obs.export import validate_run_record

    root = started["root"]
    try:
        proc = _launch_finish(launcher)
        wall = time.perf_counter() - started["t0"]
        lines = [ln for ln in proc["stdout"].splitlines()
                 if ln.startswith("PASSPORT_CHILD ")]
        if proc["rc"] != 0 or not lines:
            raise AssertionError(f"[passports-26k] the child failed: "
                                 f"{proc['stderr'][-3000:]}")
        child = json.loads(lines[0][len("PASSPORT_CHILD "):])
        with open(os.path.join(root, "run_record.json")) as f:
            rec = json.load(f)
        z = np.load(os.path.join(root, "result.npz"))
        got = {"union": z["union"], "de_mask": z["de_mask"],
               "labels": {k: z[k.replace(": ", "_")]
                          for k in wilcox_ref["labels"]}}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    validate_run_record(rec)
    for key in ("union", "de_mask"):
        if not np.array_equal(got[key], wilcox_ref[key]):
            raise AssertionError(f"[passports-26k] the {key} differs from "
                                 "phase 7's")
    for key, want in wilcox_ref["labels"].items():
        if not np.array_equal(got["labels"][key], want):
            raise AssertionError(f"[passports-26k] {key}: labels differ")
    if child["silhouettes"] != wilcox_ref["silhouettes"] or \
            child["launches"] != 1:
        raise AssertionError(f"[passports-26k] silhouettes "
                             f"{child['silhouettes']} or launches "
                             f"{child['launches']} (want 1)")
    comp = rec["compile"]
    hits = {name: (stage, occ) for name, stage, occ in child["cache_events"]}
    want_hits = {"scc/native/cuda_compile_cache_hit",
                 "scc/native/ward_compile_cache_hit"}
    if comp["compiles"] != 0 or comp["cache_hits"] != 2 or \
            set(hits) != want_hits:
        raise AssertionError(f"[passports-26k] compile section {comp}, "
                             f"cache events {child['cache_events']}")
    log("[passports-26k] compile section: " + json.dumps(comp))
    for name, (stage, occ) in sorted(hits.items()):
        log(f"[passports-26k] cache hit {name} in stage {stage} (entry "
            f"{occ})")
    sec = rec["graphs"]
    progs = {p["program"] for p in sec["programs"].values()}
    missing = set(WILCOX_PROGRAMS) - progs
    if sec.get("errors") or missing:
        raise AssertionError(f"[passports-26k] capture errors "
                             f"{sec.get('errors')}, programs missing "
                             f"{sorted(missing)}")
    by_stage = {s: {k: row[k] for k in ("programs", "transfer_ops",
                                         "host_callbacks")}
                for s, row in sec["by_stage"].items()}
    sites = _sync_sites(sec)
    capture = sum(p["capture_s"] for p in sec["programs"].values())
    implicit = audit_out["runs"][0]["implicit_syncs"]
    out = {"process_s": wall, "wall_s": rec["value"],
           "phase7_wall_s": wilcox_ref["wall_s"],
           "passports": len(sec["programs"]), "capture_s": capture,
           "totals": sec["totals"], "fingerprint": sec["fingerprint"],
           "compile": comp, "cache_hits": hits}
    log(f"[passports-26k] child {wall!r} s, refine wall {rec['value']!r} s "
        f"against phase 7's {wilcox_ref['wall_s']!r} s; {len(progs)} "
        f"programs in {len(sec['programs'])} passports, capture "
        f"{capture!r} s; totals {json.dumps(sec['totals'])}; fingerprint "
        f"{sec['fingerprint']['digest']} (torch "
        f"{sec['fingerprint']['torch']}, {sec['fingerprint']['backend']}, "
        f"{sec['fingerprint']['device_kind']})")
    log("[passports-26k] by stage: " + json.dumps(by_stage))
    for stage, rows in sorted(sites.items()):
        for row in rows:
            log(f"[passports-26k]   {stage}: {row}")
    log(f"[passports-26k] the passports' sync sites (static census of "
        f"aten ops) {sum(len(r) for r in sites.values())} against phase "
        f"31's implicit syncs (the sync debug mode at run time) "
        f"{json.dumps(implicit)}")
    for name, p in sorted(sec["programs"].items()):
        log(f"[passports-26k]   {name} (stage {p['stage']}): {p['ops']} "
            f"ops, buffers {json.dumps(p['buffers'])}, capture "
            f"{p['capture_s']!r} s")
    log("[passports-26k] " + json.dumps(out, default=str))
    return child["launches"], rec, out


def _gate_baseline(led, history):
    """The freshest clean baseline record's spans and stage costs, as the
    reference's perf gate tool takes them."""
    from scconsensus_tpu_torch.obs.ledger import is_partial_entry

    for entry in reversed(history):
        if is_partial_entry(entry):
            continue
        spans = led.load(entry["file"]).get("spans")
        if spans:
            return spans, entry.get("stage_cost")
    return None, None


def phase_gate(data, truth, cons, wilcox_ref, records, audit_out) -> tuple:
    """Phase 37: the records of phases 7, 29, 31 and 36 ingested into a
    fresh evidence ledger under a temporary path; ``gate_record`` of
    phase 36's against the other three, every verdict printed; the graph
    lane against the committed ratchet (``evidence/NUMERIC_PINS.json``,
    read only: refused by fingerprint) and against a temporary ratchet
    pinned from phase 36's passports and phase 31's boundary calls, which
    a second passport run — phase 31's audited config with the passports
    armed in this process — passes with 0 regressed and phase 31's
    crossings; ``attr.diff_records`` of phase 36 against phase 7, its top
    suspect and its report. Returns (launches, the printed numbers)."""
    import copy
    import shutil
    import tempfile

    from scconsensus_tpu_torch import recluster_de_consensus_fast
    from scconsensus_tpu_torch.obs import attr, graphs, regress, residency
    from scconsensus_tpu_torch.obs.export import validate_run_record
    from scconsensus_tpu_torch.obs.ledger import Ledger, run_key

    root = tempfile.mkdtemp(prefix="scc-gate-")
    try:
        led = Ledger(os.path.join(root, "evidence"))
        files = {}
        for i, (tag, rec) in enumerate(records.items()):
            rec = copy.deepcopy(rec)
            rec["run"]["created_unix"] = 1000.0 + i  # ledger order
            files[tag] = led.ingest(rec)["file"]
        cand = records["36"]
        history = led.history(run_key(cand), exclude_files=[files["36"]])
        spans, cost = _gate_baseline(led, history)
        verdict = regress.gate_record(cand, history, baseline_spans=spans,
                                      baseline_cost=cost)
        with open(os.path.join(REPO, "evidence", regress.PINS_NAME)) as f:
            pins_doc = json.load(f)
        # the committed ratchet's one entry, which pins the five stages
        # the port's passports fill, under a JAX fingerprint
        committed = pins_doc["graph_ratchet"]["quick"]
        gv, gnote = regress.graphs_verdicts(cand, committed)
        if gv or not gnote or "different toolchain" not in gnote:
            raise AssertionError(f"[gate-26k] the committed ratchet was "
                                 f"not refused: {gv}, {gnote}")
        d = verdict.to_dict()
        log(f"[gate-26k] phase 36 against phases 7, 29, 31: ok "
            f"{d['ok']}, history {d['n_history']}, note {d['note']}")
        for s in d["stages"]:
            log(f"[gate-26k]   stage {json.dumps(s)}")
        for key in ("transfers", "serving", "streaming", "slo", "loadgen"):
            for v in d[key]:
                log(f"[gate-26k]   {key} {json.dumps(v)}")
        log(f"[gate-26k] regressions: "
            f"{[r['stage'] for r in d['regressions']]}")
        log(f"[gate-26k] committed ratchet (graph_ratchet.quick, digest "
            f"{committed['fingerprint_digest']}): {gnote}")
        # a ratchet pinned from phase 36's own passports
        ratchet = {
            "fingerprint_digest": cand["graphs"]["fingerprint"]["digest"],
            "stages": graphs.stage_graph_counts(cand),
            "boundaries": {b: {"calls": row["calls"]} for b, row in
                           records["31"]["residency"]["by_boundary"]
                           .items()}}
        ack = graphs.ratchet_ack(ratchet)
        log(f"[gate-26k] temporary ratchet (ack {ack}): "
            + json.dumps(ratchet))
        residency.reset_cpu()
        graphs.install_and_mark(force=True)
        try:
            with _env(SCC_OBS_RESIDENCY="audit", SCC_OBS_TRANSFERS="1",
                      SCC_HOSTPROF="1"):
                res, launches = _run_full(
                    "passport-audit-26k", lambda: recluster_de_consensus_fast(
                        data, cons, device="cuda"), truth)
            sec = graphs.snapshot()
        finally:
            graphs.reset()
        _same_bits("passport-audit-26k", res, wilcox_ref)
        if not np.array_equal(res.de.de_mask.cpu().numpy(),
                              wilcox_ref["de_mask"]):
            raise AssertionError("[passport-audit-26k] the DE mask differs")
        m = res.metrics
        rep = m["residency"]
        was = audit_out["runs"][0]
        syncs = _implicit_syncs(m["spans"])
        same = (rep["by_boundary"] == was["by_boundary"]
                and rep["to_host"] == was["to_host"]
                and rep["to_device"] == was["to_device"]
                and syncs == was["implicit_syncs"])
        log(f"[passport-audit-26k] crossings with the passports armed: "
            f"d2h {json.dumps(rep['to_host'])}, h2d "
            f"{json.dumps(rep['to_device'])}, implicit syncs "
            f"{json.dumps(syncs)}; the same as phase 31's: {same}")
        if not same:
            raise AssertionError(
                f"[passport-audit-26k] the crossings moved: by boundary "
                f"{rep['by_boundary']} against {was['by_boundary']}")
        second = _flagship_record(m, residency=rep, graphs=sec)
        second["extra"]["graph_ratchet_ack"] = ack
        validate_run_record(second)
        gv2, gnote2 = regress.graphs_verdicts(second, ratchet)
        bad = [v.to_dict() for v in gv2 if v.regressed]
        if gnote2 is not None or not gv2 or bad or sec.get("errors"):
            raise AssertionError(f"[gate-26k] the second passport run "
                                 f"against the temporary ratchet: "
                                 f"{gnote2}, regressed {bad}, errors "
                                 f"{sec.get('errors')}")
        log(f"[gate-26k] second passport run: {len(gv2)} ratchet verdicts, "
            f"0 regressed; wall {m['wall_s']!r} s against phase 7's "
            f"{wilcox_ref['wall_s']!r} s and phase 31's "
            f"{was['wall_s']!r} s")
        for v in gv2:
            log(f"[gate-26k]   {json.dumps(v.to_dict())}")
        diff = attr.diff_records(cand, records["7"], "phase 36", "phase 7")
        top = attr.top_suspect(diff)
        log(f"[gate-26k] perf-diff top suspect: "
            f"{json.dumps(top) if top else None}")
        for line in attr.format_report(diff).splitlines()[:14]:
            log(f"[gate-26k]   {line}")
        out = {"ok": d["ok"], "regressions": d["regressions"],
               "stages": d["stages"], "committed_note": gnote,
               "ratchet_ack": ack, "ratchet_verdicts": len(gv2),
               "second_wall_s": m["wall_s"], "top_suspect": top}
        log("[gate-26k] " + json.dumps(out, default=str))
        return launches, out
    finally:
        shutil.rmtree(root, ignore_errors=True)


# phase 38 holds the card to the CPU within the CPU's own spread when the
# workload's input is multiplied by 1 + 1e-6 · N(0, 1) (8 seeds, measured
# in the same run): the drift workload's compat-mode dispersions sit at
# the low end of their grid and its log p quantiles follow them, so a
# difference inside that spread cannot be told from float32 rounding of
# the input. check_drift's own 1e-3 relative is printed beside it.
DRIFT_NOISE_SEEDS = 8
DRIFT_NOISE_REL = 1e-6


def phase_drift() -> tuple:
    """Phase 38: the drift sentinel's pinned workload (edgeR, 80 × 200 ×
    3, seed 11) through the port on the card and on the CPU; each held to
    ``evidence/NUMERIC_PINS.json``'s ``reference`` pins (read only) with
    its drifted fields printed. The card is held to the CPU within the
    CPU's own input-noise spread (above), label ARI 1.0; printed beside
    it: ``check_drift``'s verdict at its own tolerance, and what rounding
    the input to bfloat16 reads on the CPU. Returns (launches, the
    printed numbers)."""
    import torch

    from scconsensus_tpu_torch.obs import regress

    with open(os.path.join(REPO, "evidence", regress.PINS_NAME)) as f:
        pins = regress.pins_for_dataset(json.load(f),
                                        regress.REFERENCE_DATASET)
    from scconsensus_tpu_torch.ops.cuda_kernels import distance_cluster_sums

    t0 = time.perf_counter()
    cpu = regress.reference_fingerprint(device="cpu")
    cpu_s = time.perf_counter() - t0
    distance_cluster_sums.launches = 0
    t0 = time.perf_counter()
    card = regress.reference_fingerprint(ref_labels=cpu["_final_labels"],
                                         device="cuda")
    card_s = time.perf_counter() - t0
    launches = distance_cluster_sums.launches
    out = {"cpu_s": cpu_s, "card_s": card_s, "launches": launches}
    for tag, fp in (("card", card), ("cpu", cpu)):
        drifts = regress.check_drift(fp, pins)
        out[f"{tag}_drifted"] = [d["field"] for d in drifts]
        for d in drifts:
            log(f"[drift-{tag}] {d['field']}: pinned {d['pinned']}, "
                f"current {d['current']}")
        log(f"[drift-{tag}] drifted fields against the committed pins: "
            f"{out[f'{tag}_drifted']}")
    strict = regress.check_drift(card, cpu)
    out["card_vs_cpu_at_check_drift_tolerance"] = [d["field"]
                                                   for d in strict]
    log(f"[drift] card against CPU at check_drift's tolerance (rtol 1e-3, "
        f"atol 1e-9): {json.dumps(strict)}")

    t0 = time.perf_counter()
    noise, runs = regress._input_noise_spread(
        cpu, seeds=DRIFT_NOISE_SEEDS, rel=DRIFT_NOISE_REL, device="cpu")
    out["noise_s"] = time.perf_counter() - t0
    data, labels = regress._reference_workload()
    bf16 = torch.from_numpy(data).to(torch.bfloat16).float().numpy()
    out.update(
        card_vs_cpu=regress._fingerprint_spread(card, cpu),
        cpu_input_noise=noise, cpu_input_noise_runs=runs,
        cpu_bf16_input=regress._fingerprint_spread(
            regress._workload_fingerprint(bf16, labels, device="cpu"), cpu))
    log(f"[drift] CPU against itself, input × (1 + {DRIFT_NOISE_REL} · "
        f"N(0, 1)), {DRIFT_NOISE_SEEDS} seeds: {json.dumps(runs)}")
    log(f"[drift] card against CPU {json.dumps(out['card_vs_cpu'])}; the "
        f"CPU's input-noise spread {json.dumps(noise)}; the input rounded "
        f"to bfloat16 on the CPU {json.dumps(out['cpu_bf16_input'])}; "
        f"label ARI {card['label_ari']!r}; {launches} kernel launches on "
        f"the card")
    outside = [k for k, v in out["card_vs_cpu"].items() if v > noise[k]]
    if outside or card["label_ari"] != 1.0 or launches < 1:
        raise AssertionError(f"[drift] the card's fingerprint is not the "
                             f"CPU's: outside the input-noise spread in "
                             f"{outside}, label ARI {card['label_ari']}")
    log("[drift] " + json.dumps(out))
    return launches, out


# ---------------------------------------------------------------------------
# phases 39-41: the workload zoo (workloads/)
# ---------------------------------------------------------------------------

# the reference bench's order of the four scenarios (bench.py:1065-1068)
ZOO_ORDER = ("multi_sample", "cite_dual", "atlas_transfer", "topo_inputs")
# phase 40's one cut of a `full` shape: multi_sample at 40,000 of its
# 100,000 cells (genes, clusters and samples kept). At 100,000 its run
# took 105.93 s, 96.18 of them host Ward, whose exact tree grows with N²,
# and the child waited on its draw (PERF.md §4); phase 3 keeps the
# kernel's 100,000-cell row.
ZOO_FULL_CUTS = {"multi_sample": {"n_cells": 40_000}}
# the quality.scenario metrics printed for each scenario
ZOO_METRICS = {
    "multi_sample": ("ari_pooled", "per_batch_ari_min",
                     "batch_mixing_mean_norm_entropy"),
    "cite_dual": ("adt_ari_vs_coarse", "rna_ari_vs_fine",
                  "final_ari_vs_fine", "final_ari_vs_coarse"),
    "atlas_transfer": ("transfer_ari", "query_cells_per_s",
                       "answered_frac", "serve_p99_ms"),
    "topo_inputs": ("topo_ari_vs_truth", "final_ari_vs_truth",
                    "topo_replay_identical"),
}
# PCA scores card against CPU, of the largest |score|, after per-column
# sign alignment (the CPU tests' tolerance for the embed), for every
# component whose singular value lies at least ZOO_PCA_GAP (relative)
# from its neighbours': a component nearer a neighbour than that is not
# determined to better than float32 rounding times σ / gap on either
# device, and is printed, not held
ZOO_PCA_RTOL = 1e-4
ZOO_PCA_GAP = 0.01
# the kill of the reference's workload-kill-resume plan
# (tools/chaos_run.py:196-201)
ZOO_KILL_PLAN = [{"site": "stage:tree", "class": "kill", "after": 0}]


@contextlib.contextmanager
def _capturing_refine(into: list):
    """Keep every ``refine()`` result made while the block runs (a
    scenario's outcome carries its record sections, not its labels)."""
    from scconsensus_tpu_torch.models import pipeline

    real = pipeline.refine

    def refine(*a, **kw):
        res = real(*a, **kw)
        into.append(res)
        return res

    pipeline.refine = refine
    try:
        yield into
    finally:
        pipeline.refine = real


def _zoo_deep_splits(name: str, smoke: bool) -> list:
    """The deepSplit cuts a scenario's refine makes
    (``workloads/common.py``, ``workloads/atlas.py``)."""
    if smoke:
        return [1, 2]
    return [1, 2, 3] if name == "atlas_transfer" else [1, 2, 3, 4]


def _zoo_record(out, platform: str) -> dict:
    """A scenario outcome as a run record, validated by the port."""
    from scconsensus_tpu_torch.obs.export import (
        build_run_record,
        validate_run_record,
    )

    rec = build_run_record(
        metric=out.metric, value=out.value, unit=out.unit,
        extra=dict({k: v for k, v in out.extra.items()
                    if isinstance(v, (int, float, str, bool))},
                   config=out.name, platform=platform),
        spans=out.spans, quality=out.quality, serving=out.serving,
        scenario=out.scenario, robustness=out.robustness,
        integrity=out.integrity, residency=out.residency,
    )
    validate_run_record(rec)
    return rec


def _zoo_checks(tag: str, out, rec: dict, smoke: bool) -> dict:
    """What every scenario run must show (no score thresholds): a valid
    record (``_zoo_record``), every deepSplit cut, every query answered
    (atlas), an identical replay (topology). Returns the printed
    ``quality.scenario`` metrics."""
    cuts = [c["cut"] for c in rec["quality"]["cluster_structure"]["cuts"]]
    want = [f"deepsplit: {d}" for d in _zoo_deep_splits(out.name, smoke)]
    if cuts != want:
        raise AssertionError(f"[{tag}] cuts {cuts}, expected {want}")
    m = rec["quality"]["scenario"]["metrics"]
    if out.name == "atlas_transfer" and m["answered_frac"] != 1.0:
        raise AssertionError(f"[{tag}] answered_frac {m['answered_frac']}")
    if out.name == "topo_inputs" and m["topo_replay_identical"] != 1.0:
        raise AssertionError(f"[{tag}] the topology replay differs")
    return {k: m.get(k) for k in ZOO_METRICS[out.name]}


def phase_zoo_small() -> int:
    """Phase 39: the zoo card against CPU at the ``smoke`` shapes. The
    device pieces on one input (cite_dual's smoke modalities): the PCA
    embed with one projection on both devices, then the k-means labelings
    and the topology clusterer on the CPU's embedding, labels identical;
    then ``run_scenario(name, smoke=True)`` for the four scenarios on the
    card and on the CPU: final cuts identical (ARI 1), the scenario
    metrics side by side, every record valid, one kernel launch a card
    run. Returns the card runs' launches."""
    import torch

    from scconsensus_tpu_torch.obs.regress import adjusted_rand_index
    from scconsensus_tpu_torch.ops.cuda_kernels import distance_cluster_sums
    from scconsensus_tpu_torch.workloads import SCENARIOS, run_scenario
    from scconsensus_tpu_torch.workloads.common import (
        final_labels,
        kmeans_labeling,
        pca_embed,
    )
    from scconsensus_tpu_torch.workloads.data import cite_seq_dataset
    from scconsensus_tpu_torch.workloads.topology import topology_cluster

    p = SCENARIOS["cite_dual"].smoke
    rna, adt, _, _ = cite_seq_dataset(
        n_cells=p["n_cells"], n_genes=p["n_genes"], n_adt=p["n_adt"],
        k_coarse=p["k_coarse"], k_fine=p["k_fine"], seed=p["seed"])
    n_pcs = int(min(20, max(4, p["k_fine"] + 4)))    # citeseq.py's
    omega = torch.randn((rna.shape[0], n_pcs + 10),
                        generator=torch.Generator().manual_seed(p["seed"]))
    emb = {dev: pca_embed(rna, n_pcs, seed=p["seed"], omega=omega,
                          device=dev) for dev in ("cuda", "cpu")}
    sign = np.sign(np.sum(emb["cuda"] * emb["cpu"], axis=0))
    col_err = np.abs(emb["cuda"] * sign - emb["cpu"]).max(axis=0)
    scale = float(np.abs(emb["cpu"]).max())
    # the centred data's singular values (float64, on the host), one past
    # the kept components, and each kept one's gap to its neighbours
    cells = rna.T.astype(np.float64)
    sv = np.linalg.svd(cells - cells.mean(axis=0), compute_uv=False)
    sv = sv[:n_pcs + 1]
    gap = np.array([min(abs(sv[j] - sv[j + 1]),
                        abs(sv[j] - sv[j - 1]) if j else np.inf) / sv[j]
                    for j in range(n_pcs)])
    held = gap >= ZOO_PCA_GAP
    log(f"[zoo-small] pca_embed {emb['cpu'].shape}: card against CPU max "
        f"abs err by component {col_err.tolist()}; singular values "
        f"{sv.tolist()}; relative gaps {gap.tolist()}; held (gap >= "
        f"{ZOO_PCA_GAP}) {held.tolist()} at {ZOO_PCA_RTOL} x {scale!r}")
    if not held[0] or np.any(col_err[held] > ZOO_PCA_RTOL * scale):
        raise AssertionError("[zoo-small] the PCA scores disagree")
    x = emb["cpu"]
    pieces = {
        "kmeans-rna": lambda dev: kmeans_labeling(
            x, p["k_fine"], seed=p["seed"] + 2, prefix="rna", device=dev),
        "kmeans-adt": lambda dev: kmeans_labeling(
            adt.T, p["k_coarse"], seed=p["seed"] + 1, prefix="adt",
            device=dev),
        "topology": lambda dev: topology_cluster(
            x, n_covers=SCENARIOS["topo_inputs"].smoke["n_covers"],
            seed=p["seed"], device=dev),
    }
    for tag, fn in pieces.items():
        a, b = fn("cuda"), fn("cpu")
        flipped = int(np.sum(a != b))
        log(f"[zoo-small] {tag}: {len(set(a.tolist()))} labels, "
            f"{flipped} of {a.size} differ card against CPU")
        if flipped:
            raise AssertionError(f"[zoo-small] {tag} differs card against "
                                 "CPU")

    launches = 0
    for name in ZOO_ORDER:
        runs = {}
        for dev in ("cuda", "cpu"):
            captured = []
            distance_cluster_sums.launches = 0
            with _capturing_refine(captured):
                t0 = time.perf_counter()
                out = run_scenario(name, smoke=True, device=dev)
                wall = time.perf_counter() - t0
            n_launch = distance_cluster_sums.launches
            rec = _zoo_record(out, "gpu" if dev == "cuda" else "cpu")
            metrics = _zoo_checks(f"zoo-small {name} {dev}", out, rec, True)
            runs[dev] = dict(final=final_labels(captured[-1]), wall=wall,
                             launches=n_launch, metrics=metrics,
                             value=out.value)
        if runs["cuda"]["launches"] != 1 or runs["cpu"]["launches"] != 0:
            raise AssertionError(
                f"[zoo-small] {name}: launches card "
                f"{runs['cuda']['launches']}, CPU {runs['cpu']['launches']}"
                " (expected 1 and 0)")
        launches += runs["cuda"]["launches"]
        ari = adjusted_rand_index(runs["cuda"]["final"], runs["cpu"]["final"])
        log(f"[zoo-small] {name}: final cut ARI card against CPU {ari!r}; "
            "card / CPU: " + json.dumps({
                k: [runs["cuda"][k], runs["cpu"][k]]
                for k in ("value", "wall", "metrics")}))
        if ari != 1.0:
            raise AssertionError(f"[zoo-small] {name}: the final cuts "
                                 "differ card against CPU")
    return launches


def _zoo_draw_args(name: str) -> tuple:
    """(module, function, keywords) of the numpy draw a scenario's runner
    makes at its ``full`` shape, as the runner calls it
    (``workloads/multisample.py``, ``citeseq.py``, ``atlas.py``,
    ``topo_scenario.py``)."""
    from scconsensus_tpu_torch.workloads import SCENARIOS

    p = {**SCENARIOS[name].full, **ZOO_FULL_CUTS.get(name, {})}
    if name == "multi_sample":
        return ("scconsensus_tpu_torch.workloads.data",
                "multi_sample_dataset",
                {k: p[k] for k in ("n_cells", "n_genes", "n_clusters",
                                   "n_samples", "seed")})
    if name == "cite_dual":
        return ("scconsensus_tpu_torch.workloads.data", "cite_seq_dataset",
                {k: p[k] for k in ("n_cells", "n_genes", "n_adt",
                                   "k_coarse", "k_fine", "seed")})
    if name == "atlas_transfer":
        return ("scconsensus_tpu_torch.workloads.data",
                "atlas_query_dataset",
                {k: p[k] for k in ("n_atlas", "n_query", "n_genes",
                                   "n_clusters", "seed")})
    return ("scconsensus_tpu_torch.utils.synthetic", "synthetic_scrna",
            dict(n_genes=p["n_genes"], n_cells=p["n_cells"],
                 n_clusters=p["n_clusters"],
                 n_markers_per_cluster=min(
                     40, p["n_genes"] // max(p["n_clusters"], 1)),
                 seed=p["seed"], log_normalize=True))


def _zoo_draw(name: str):
    """A scenario's ``full`` numpy draw, made in a worker process, and
    the seconds it took there."""
    import importlib

    mod, fn, kw = _zoo_draw_args(name)
    t0 = time.perf_counter()
    out = getattr(importlib.import_module(mod), fn)(**kw)
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def _zoo_prefetched(draws: dict, used: list):
    """While the block runs, a call of a scenario's draw function with the
    keywords ``_zoo_draw_args`` names returns the array drawn beforehand
    (the generators are pure functions of their arguments, so those are
    the bytes the call would draw) and notes the scenario in ``used``;
    any other call draws as usual."""
    import importlib

    saved = []
    for name in draws:
        mod, fn, kw = _zoo_draw_args(name)
        module = importlib.import_module(mod)
        real = getattr(module, fn)

        def patched(*a, _real=real, _kw=kw, _name=name, **k):
            if not a and k == _kw and _name in draws:
                used.append(_name)
                return draws.pop(_name)
            return _real(*a, **k)

        saved.append((module, fn, real))
        setattr(module, fn, patched)
    try:
        yield
    finally:
        for module, fn, real in reversed(saved):
            setattr(module, fn, real)


_ZOO_CHILD = """
import json, multiprocessing, os, resource, sys, time
from concurrent.futures import ProcessPoolExecutor
sys.path.insert(0, {repo!r})
import chip_smoke

if __name__ == "__main__":
    # the four numpy draws at once, in worker processes; each scenario
    # runs, in the reference's order, as soon as its own draw is in,
    # while the later draws go on (they end during the first run, so no
    # kernel timing shares the host with a draw)
    pool = ProcessPoolExecutor(
        len(chip_smoke.ZOO_ORDER),
        mp_context=multiprocessing.get_context("spawn"))
    futures = {{name: pool.submit(chip_smoke._zoo_draw, name)
               for name in chip_smoke.ZOO_ORDER}}
    draws = {{}}

import numpy as np
import torch
from scconsensus_tpu_torch.ops.cuda_kernels import distance_cluster_sums
from scconsensus_tpu_torch.workloads import run_scenario

out_dir = os.path.join(chip_smoke.OUT_DIR, "phase40")
os.makedirs(out_dir, exist_ok=True)
waits, t_wait = {{}}, time.perf_counter()
for name in chip_smoke.ZOO_ORDER:
    # this scenario's draw, in before its run's clock starts
    draws[name], drawn = futures[name].result()
    waits[name] = [drawn, time.perf_counter() - t_wait]
    captured, used = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    distance_cluster_sums.launches = 0
    with chip_smoke._capturing_refine(captured), \\
            chip_smoke._zoo_prefetched(draws, used):
        t0 = time.perf_counter()
        out = run_scenario(name, chip_smoke.ZOO_FULL_CUTS.get(name),
                           workdir=os.path.join({root!r}, name),
                           device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if used != [name]:
        raise AssertionError(name + ": its prefetched draw went unused")
    launches = distance_cluster_sums.launches
    peak = torch.cuda.max_memory_allocated()
    rec = chip_smoke._zoo_record(out, "gpu")
    metrics = chip_smoke._zoo_checks("zoo-full " + name, out, rec, False)
    with open(os.path.join(out_dir, name + ".json"), "w") as f:
        json.dump(rec, f)
    res = captured[-1]
    kern = chip_smoke._measure_main_path(res, "zoo-" + name)
    print("ZOO_CHILD " + json.dumps({{
        "name": name, "value": out.value, "unit": out.unit,
        "metric": out.metric, "wall_s": wall, "launches": launches,
        "peak_device_bytes": peak, "n_cells": int(res.embedding.shape[0]),
        "stage_walls_s": res.metrics["stage_walls_s"],
        "scenario_metrics": metrics, "extra": out.extra,
        "silhouettes": [i["silhouette"] for i in res.deep_split_info],
        "n_clusters": [i["n_clusters"] for i in res.deep_split_info],
        "kernel": kern}}, default=str), flush=True)
    del res, captured, out, rec
    torch.cuda.empty_cache()
    t_wait = time.perf_counter()
pool.shutdown()
print("ZOO_DRAWS_S " + json.dumps(waits), flush=True)
print("ZOO_RSS_MB " + str(
    resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0))
"""


def phase_zoo_full(launcher) -> dict:
    """Phase 40: the four scenarios at their ``full`` shapes on the card,
    in one fresh child process from the launcher, which first draws the
    four numpy datasets at once in worker processes: each one's headline,
    stage walls, peak device memory, kernel launches (one each), the
    kernel's time at its shape against its plain version, and its
    ``quality.scenario`` metrics; every record valid with every deepSplit
    cut (records under ``OUT_DIR/phase40/``). Returns the child's numbers
    by scenario."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="scc-zoo-")
    try:
        t0 = time.perf_counter()
        proc = _launch(launcher, [sys.executable, "-c",
                                  _ZOO_CHILD.format(repo=REPO, root=root)],
                       900)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out, rss = {}, None
    for line in proc["stdout"].splitlines():
        if line.startswith("[kernel]"):
            log(line)
        elif line.startswith("ZOO_CHILD "):
            rec = json.loads(line[len("ZOO_CHILD "):])
            out[rec["name"]] = rec
            brief = {k: rec[k] for k in (
                "value", "unit", "wall_s", "launches", "peak_device_bytes",
                "n_cells", "stage_walls_s", "scenario_metrics",
                "n_clusters", "silhouettes")}
            brief["kernel_ms"] = rec["kernel"]["ms"]
            log(f"[zoo-full] {rec['name']}: {json.dumps(brief)}")
        elif line.startswith("ZOO_RSS_MB "):
            rss = float(line.split()[1])
        elif line.startswith("ZOO_DRAWS_S "):
            log(f"[zoo-full] the four numpy draws, started at once: each "
                f"one's seconds in its worker and the child's wait for it "
                f"before its run: {line[len('ZOO_DRAWS_S '):]}")
    if proc["rc"] != 0 or list(out) != list(ZOO_ORDER):
        raise AssertionError(f"[zoo-full] the child failed (exit "
                             f"{proc['rc']}): {proc['stderr'][-3000:]}")
    for name, rec in out.items():
        if rec["launches"] != 1:
            raise AssertionError(f"[zoo-full] {name}: {rec['launches']} "
                                 "kernel launches, expected 1")
    log(f"[zoo-full] the child in {wall!r} s, peak RSS {rss!r} MB")
    return out


def _zoo_soak_argv(workdir: str, *extra, plan=None) -> list:
    """``python -m scconsensus_tpu_torch.workloads.soak`` on ``workdir``,
    under the fault plan file ``plan`` when given."""
    argv = [sys.executable, "-m", "scconsensus_tpu_torch.workloads.soak",
            "--dir", workdir, *extra]
    if plan is not None:
        argv = ["env", f"SCC_FAULT_PLAN={plan}", *argv]
    return argv


def _zoo_soak_result(tag: str, proc: dict, workdir: str, wall: float):
    """(exit code, summary or None, wall) of one soak child, logged."""
    try:
        with open(os.path.join(workdir, "WORKLOAD_SOAK_SUMMARY.json")) as f:
            summary = json.load(f)
    except OSError:
        summary = None
    brief = None if summary is None else {
        k: summary.get(k) for k in ("ok", "wall_s", "labels_sha",
                                    "resumed_stages", "n_topo_clusters")}
    log(f"[zoo-soak] {tag}: exit {proc['rc']} (its round {wall!r} s); "
        f"{json.dumps(brief)}")
    if summary is None and proc["rc"] != -9:
        log(f"[zoo-soak] {tag} stderr {proc['stderr'][-2000:]}")
    return proc["rc"], summary, wall


def phase_zoo_soak(launcher) -> dict:
    """Phase 41: the zoo's soak worker in fresh children from the
    launcher. The reference's workload-kill-resume plan: a clean
    ``--fresh`` run, a run killed by SIGKILL at ``stage:tree``, and its
    resume, which adopts ``de`` and ``embed`` and gives the clean run's
    ``labels_sha``; the same sha with ``--device cpu``; the ``--topo``
    audit on the card and on the CPU, one sha. Every record valid. The
    five runs that need no other start together; the resume follows."""
    import shutil
    import tempfile

    from scconsensus_tpu_torch.obs.export import validate_run_record

    root = tempfile.mkdtemp(prefix="scc-zoo-soak-")
    out = {}
    try:
        plan = _write_plan(root, ZOO_KILL_PLAN)
        # the five independent runs at once, then the resume of the
        # killed one
        first = {
            "clean": ("clean", ("--fresh", "--device", "cuda"), None),
            "killed": ("kill", ("--fresh", "--device", "cuda"), plan),
            "cpu": ("cpu", ("--fresh", "--device", "cpu"), None),
            "topo-cuda": ("topo-cuda", ("--topo", "--device", "cuda"),
                          None),
            "topo-cpu": ("topo-cpu", ("--topo", "--device", "cpu"), None),
        }
        t0 = time.perf_counter()
        procs = _launch_all(launcher, [
            _zoo_soak_argv(os.path.join(root, d), *extra, plan=pl)
            for d, extra, pl in first.values()], 600)
        wall = time.perf_counter() - t0
        runs = {tag: _zoo_soak_result(tag, proc, os.path.join(root, d),
                                      wall)
                for (tag, (d, _, _)), proc in zip(first.items(), procs)}
        t0 = time.perf_counter()
        proc = _launch(launcher, _zoo_soak_argv(
            os.path.join(root, "kill"), "--device", "cuda"), 600)
        runs["resumed"] = _zoo_soak_result(
            "resumed", proc, os.path.join(root, "kill"),
            time.perf_counter() - t0)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rc, summary, _ = runs["killed"]
    if rc != -9 or summary is not None:
        raise AssertionError(f"[zoo-soak] the planned kill did not happen "
                             f"(exit {rc})")
    for tag in ("clean", "resumed", "cpu", "topo-cuda", "topo-cpu"):
        rc, summary, wall = runs[tag]
        if rc != 0 or summary is None or not summary["ok"]:
            raise AssertionError(f"[zoo-soak] {tag}: exit {rc}")
        if "record" in summary:
            validate_run_record(summary["record"])
        out[tag] = {"process_s": wall, "wall_s": summary["wall_s"],
                    "labels_sha": summary["labels_sha"]}
    if runs["clean"][1]["resumed_stages"]:
        raise AssertionError("[zoo-soak] the clean run adopted stages")
    adopted = runs["resumed"][1]["resumed_stages"]
    if not {"de", "embed"} <= set(adopted):
        raise AssertionError(f"[zoo-soak] the resume adopted {adopted}")
    shas = {t: out[t]["labels_sha"] for t in ("clean", "resumed", "cpu")}
    topo = {t: out[t]["labels_sha"] for t in ("topo-cuda", "topo-cpu")}
    log(f"[zoo-soak] resume adopted {adopted}; labels_sha {shas}; "
        f"topo {topo}")
    if len(set(shas.values())) != 1 or len(set(topo.values())) != 1:
        raise AssertionError("[zoo-soak] the shas differ")
    return out


# --------------------------------------------------------------------------
# phases 42-44: the serving fleet
# --------------------------------------------------------------------------

FLEET_SEED = 7
# the reference fleet tests' fast driver config (tests/test_serve_fleet.py)
FLEET_CFG = dict(max_batch_cells=256, queue_capacity=32,
                 batch_window_s=0.001, default_deadline_s=10.0,
                 breaker_threshold=3, breaker_cooldown_s=0.2,
                 drift_quarantine_frac=0.5)
# the reference's wire-overhead contract (tests/test_serve_fleet.py:949)
WIRE_GUARD_LIMIT = 1.07
# the bench's atlas_query over the fleet (bench.py:1462), cut from 300
# requests to 150 at the same width, its 8 foreign requests kept: the
# 300-request pass took 52.46 s, most of it the host's JSON
ATLAS_QUERY = dict(n_requests=150, cells_per=64, n_ood=8, n_genes=2000,
                   n_clusters=12, n_train=20000, replicas=2, seed=7)
# what phase 19 measured, set beside phase 43's numbers
_FACTS: dict = {}


def _fleet_cfg(**kw):
    from scconsensus_tpu_torch.serve.driver import ServeConfig

    return ServeConfig(**{**FLEET_CFG, **kw})


def _wire_post(port: int, body, ctype: str = "application/json",
               headers=None):
    """One POST /classify on a fresh connection: (status, body, headers)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/classify", body=body,
                 headers={"Content-Type": ctype, **(headers or {})})
    r = conn.getresponse()
    doc = json.loads(r.read())
    conn.close()
    return r.status, doc, dict(r.getheaders())


def _wire_get(port: int, path: str):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    r = conn.getresponse()
    raw = r.read()
    conn.close()
    return r.status, raw


def _fleet_statuses(model_dir: str, device: str, root: str) -> dict:
    """A 3-replica pool behind the wire front on ``device``, driven to each
    status of the reference's ``TestWireFront``: 200 for a JSON and an
    ``.npy`` body, 409, 422, 429 (a stalled batch behind a 2-deep queue),
    504 (a stalled batch past a 0.1 s deadline), 503 after stop, and a
    ``degraded`` 200 through ``force_open``. Returns the labels of every
    answered request and the status of each case."""
    import threading

    from scconsensus_tpu_torch.serve.fleet.pool import ReplicaPool
    from scconsensus_tpu_torch.serve.fleet.soak import make_query_batches
    from scconsensus_tpu_torch.serve.fleet.wire import WireFront
    from scconsensus_tpu_torch.serve.metrics import validate_serving

    out = {"labels": []}
    reqs = make_query_batches(4, 8, FLEET_SEED)
    ood = make_query_batches(1, 8, FLEET_SEED, n_ood=1)[0]
    pool = ReplicaPool(model_dir, n_replicas=3, config=_fleet_cfg(),
                       device=device)
    front = WireFront(pool)
    pool.start()
    front.start()
    try:
        model = pool.active_model()
        for x in reqs:
            st, doc, _ = _wire_post(front.port,
                                    json.dumps({"cells": x.tolist()}))
            assert st == 200 and doc["outcome"] == "ok", doc
            assert doc["labels"] == model.classify(x)[0].tolist()
            out["labels"].append(doc["labels"])
        buf = io.BytesIO()
        np.save(buf, reqs[0])
        st, doc, _ = _wire_post(front.port, buf.getvalue(),
                                ctype="application/x-npy")
        assert st == 200 and doc["labels"] == out["labels"][0], doc
        out["npy"] = st
        st, doc, _ = _wire_post(front.port,
                                json.dumps({"cells": ood.tolist()}))
        assert st == 409 and doc["labels"] is None, doc
        out["quarantined"] = st
        st, doc, _ = _wire_post(front.port,
                                json.dumps({"cells": [[1.0, 2.0]]}))
        assert st == 422 and doc["outcome"] == "rejected_invalid", doc
        out["invalid"] = st
        # degraded mode: every breaker forced open, the host path answers
        for rep in pool.replicas():
            rep.server.breaker.force_open()
        st, doc, _ = _wire_post(front.port,
                                json.dumps({"cells": reqs[1].tolist()}))
        assert st == 200 and doc["outcome"] == "degraded", doc
        assert doc["degraded"] and doc["labels"] == out["labels"][1], doc
        for rep in pool.replicas():
            rep.server.breaker.force_close()
        out["degraded"] = st
        # 504: the one batch stalls 0.4 s past a 0.1 s deadline
        with _env(SCC_FAULT_PLAN=_write_plan(root, [{
                "site": "serve_batch", "class": "stall", "stall_s": 0.4}],
                name=f"stall-{device}.json")):
            st, doc, _ = _wire_post(front.port, json.dumps(
                {"cells": reqs[2].tolist(), "deadline_s": 0.1}))
        assert st == 504 and doc["late_by_s"] > 0, doc
        out["deadline"] = st
        # 429: each replica's batch stalls with a 2-deep queue behind it
        for rep in pool.replicas():
            rep.server.config.queue_capacity = 2
        results = []
        with _env(SCC_FAULT_PLAN=_write_plan(root, [{
                "site": "serve_batch", "class": "stall", "stall_s": 0.5,
                "times": 4}], name=f"queue-{device}.json")):
            # the bodies encoded first and sent 20 ms apart: each arrival
            # misses the 1 ms batch window of the one before it, so the
            # first two batches stall with one request each, two queue
            # behind each, and the rest, inside the 0.5 s stall, are shed
            bodies = [json.dumps({"cells": x.tolist()})
                      for x in make_query_batches(14, 8, FLEET_SEED)]
            ts = [threading.Thread(target=lambda b=b: results.append(
                _wire_post(front.port, b))) for b in bodies]
            for t in ts:
                t.start()
                time.sleep(0.02)
            for t in ts:
                t.join(timeout=120)
        shed = [(st, doc, h) for st, doc, h in results if st == 429]
        assert shed, [st for st, _, _ in results]
        for st, doc, h in shed:
            assert doc["outcome"] == "rejected_queue"
            assert doc["retry_after_s"] > 0 and int(h["Retry-After"]) >= 1
        assert all(st in (200, 429) for st, _, _ in results)
        out["queue_full"] = (429, len(shed))
        st, _ = _wire_get(front.port, "/healthz")
        assert st == 200
        pool.stop()
        st, doc, _ = _wire_post(front.port,
                                json.dumps({"cells": reqs[3].tolist()}))
        assert st == 503 and doc["outcome"] == "rejected_closed", doc
        st_h, _ = _wire_get(front.port, "/healthz")
        assert st_h == 503
        out["closed"] = st
    finally:
        front.stop()
        pool.stop()
    sec = front.serving_section()
    validate_serving(sec)
    wire_req = sec["wire"]["requests"]
    assert wire_req["submitted"] == 4 + 1 + 1 + 1 + 1 + 1 + 14 + 1
    assert sec["fleet"]["submitted_by_owner"]["pool"] == 1
    out["status_codes"] = sec["wire"]["status_codes"]
    return out


def _fleet_sites(model_dir: str, v2_dir: str, device: str,
                 root: str) -> dict:
    """The fleet's three fault sites under a one-rule plan each: what the
    client saw for two requests, a hot-swap and a third request, with the
    accounting validated."""
    from scconsensus_tpu_torch.serve.fleet.pool import ReplicaPool
    from scconsensus_tpu_torch.serve.fleet.soak import make_query_batches
    from scconsensus_tpu_torch.serve.fleet.wire import WireFront
    from scconsensus_tpu_torch.serve.metrics import validate_serving

    body = json.dumps({"cells": make_query_batches(1, 8, FLEET_SEED)[0]
                       .tolist()})
    out = {}
    for rule in ({"site": "wire_request", "class": "transient"},
                 {"site": "fleet_route", "class": "oom"},
                 {"site": "fleet_swap", "class": "disk"}):
        seen = []
        with _env(SCC_FAULT_PLAN=_write_plan(
                root, [rule], name=f"{rule['site']}-{device}.json")):
            pool = ReplicaPool(model_dir, n_replicas=2,
                               config=_fleet_cfg(), device=device)
            with pool, WireFront(pool) as front:
                for _ in range(2):
                    st, doc, _ = _wire_post(front.port, body)
                    seen.append((st, doc["outcome"]))
                try:
                    pool.hot_swap(v2_dir)
                    seen.append("swapped")
                except Exception as err:  # noqa: BLE001 - the typed fault
                    seen.append(type(err).__name__)
                st, doc, _ = _wire_post(front.port, body)
                seen.append((st, doc["outcome"]))
                sec = front.serving_section()
        validate_serving(sec)
        assert sec["wire"]["requests"]["submitted"] == 3
        if rule["site"] == "fleet_swap":
            assert seen == [(200, "ok"), (200, "ok"), "InjectedDiskFault",
                            (200, "ok")], seen
        else:
            assert seen == [(500, "failed"), (200, "ok"), "swapped",
                            (200, "ok")], seen
        out[rule["site"]] = seen
    return out


def _planted_drift(seed: int = 0, n_per: int = 6, cells_per: int = 16):
    """The reference's two far-away planted clusters
    (tests/test_serve_fleet.py:554)."""
    rng = np.random.default_rng(seed)
    d = [(40.0 + rng.normal(0, 0.6, size=(cells_per, 120))
          ).astype(np.float32) for _ in range(n_per)]
    e = [(-40.0 + rng.normal(0, 0.6, size=(cells_per, 120))
          ).astype(np.float32) for _ in range(n_per)]
    return [(x, 1) for x in d] + [(x, 2) for x in e]


def _fleet_reconsensus(model_dir: str, device: str, root: str) -> dict:
    """The planted-drift loop on ``device``: quarantine, reconsensus,
    hot-swap, replay; the replay's majority labels against the planted
    ones by ARI."""
    from scconsensus_tpu_torch.obs.regress import adjusted_rand_index
    from scconsensus_tpu_torch.serve.fleet.pool import ReplicaPool
    from scconsensus_tpu_torch.serve.fleet.reconsensus import run_reconsensus
    from scconsensus_tpu_torch.serve.metrics import validate_serving

    ldir = os.path.join(root, f"ledger-{device}")
    planted = _planted_drift()
    pool = ReplicaPool(model_dir, n_replicas=2,
                       config=_fleet_cfg(ledger_dir=ldir), device=device)
    with pool:
        fp1 = pool.active_fingerprint()
        for x, _ in planted:
            assert pool.classify(x, timeout=60).outcome == "quarantined"
        t0 = time.perf_counter()
        summary = run_reconsensus(ldir, os.path.join(root, f"v3-{device}"),
                                  pool=pool, min_cells=64, seed=3,
                                  device=device)
        t_loop = time.perf_counter() - t0
        assert summary["updated"], summary
        fp2 = pool.active_fingerprint()
        assert fp2 == summary["swapped_fp"] != fp1
        again = run_reconsensus(ldir, os.path.join(root, f"v4-{device}"),
                                pool=pool, min_cells=64, device=device)
        assert again["updated"] is False
        served, truth, blobs = [], [], []
        for x, lab in planted:
            resp = pool.classify(x, timeout=60)
            assert resp.outcome == "ok" and resp.model_fp == fp2
            served.append(int(np.bincount(resp.labels).argmax()))
            truth.append(lab)
            blobs.append(np.asarray(resp.labels, np.int64).tobytes())
        sec = pool.serving_section()
    validate_serving(sec)
    ari = adjusted_rand_index(served, truth)
    assert ari >= 0.99, ari
    return {"ari": ari, "loop_s": t_loop,
            "new_labels": summary["new_labels"],
            "n_new_clusters": summary["n_new_clusters"],
            "labels_sha": hashlib.sha256(b"".join(blobs)).hexdigest()}


def _production_model():
    """The reference guard's large-atlas shape (1,500-gene panel, 64 PCs,
    4,096 landmarks; tests/test_serve_fleet.py:921), drift gate off."""
    from scconsensus_tpu_torch.serve.model import ConsensusModel

    rng = np.random.default_rng(0)
    G, F, P, K = 2000, 1500, 64, 4096
    return ConsensusModel(
        panel_idx=np.sort(rng.choice(G, F, replace=False)).astype(np.int64),
        pca_mean=rng.normal(size=F).astype(np.float32),
        pca_components=rng.normal(size=(P, F)).astype(np.float32),
        centroids=rng.normal(size=(K, P)).astype(np.float32),
        centroid_labels=rng.integers(1, 9, K).astype(np.int64),
        centroid_counts=np.ones(K, np.int64),
        tree_merge=np.zeros((K - 1, 2)), tree_height=np.zeros(K - 1),
        tree_order=np.arange(K), calib_q=np.array([1.0, 2.0, 3.0, 4.0]),
        drift_threshold=float("inf"), meta={"n_genes": G, "deep_split": 2},
        device="cuda"), G


def _wire_guard() -> tuple:
    """The reference's wire-overhead guard on the card: 24 requests of
    1,024 x 2,000 from 4 clients, the bare driver against the wire front
    over a 1-replica pool (``.npy`` bodies), served p99 from each serving
    section; the best ratio of 3 and every trial's p99s."""
    import http.client
    import threading

    from scconsensus_tpu_torch import ConsensusServer
    from scconsensus_tpu_torch.serve.driver import ServeConfig
    from scconsensus_tpu_torch.serve.fleet.pool import ReplicaPool
    from scconsensus_tpu_torch.serve.fleet.wire import WireFront
    from scconsensus_tpu_torch.serve.metrics import validate_serving

    model, G = _production_model()
    rng = np.random.default_rng(1)
    n_req, conc = 24, 4
    reqs = [rng.normal(size=(1024, G)).astype(np.float32)
            for _ in range(n_req)]
    payloads = []
    for x in reqs:
        b = io.BytesIO()
        np.save(b, x)
        payloads.append(b.getvalue())
    model.classify(reqs[0])
    cfg = ServeConfig(max_batch_cells=1024, queue_capacity=64,
                      batch_window_s=0.0, default_deadline_s=300.0,
                      breaker_threshold=3, breaker_cooldown_s=5.0,
                      drift_quarantine_frac=2.0)

    def drive(fn):
        nxt = iter(range(n_req))
        lock = threading.Lock()

        def pump():
            while True:
                with lock:
                    i = next(nxt, None)
                if i is None:
                    return
                fn(i)

        ts = [threading.Thread(target=pump) for _ in range(conc)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=300)

    trials = []
    for _ in range(3):
        with ConsensusServer(model, cfg, device="cuda") as srv:
            drive(lambda i: srv.classify(reqs[i], timeout=300.0))
            sec = srv.serving_section()
            assert sec["requests"]["ok"] == n_req
            bare = sec["latency_ms"]["p99"]
        pool = ReplicaPool(model, n_replicas=1, config=cfg, device="cuda")
        with pool, WireFront(pool) as front:
            local = threading.local()

            def wire_call(i, port=front.port):
                conn = getattr(local, "conn", None)
                if conn is None:
                    conn = local.conn = http.client.HTTPConnection(
                        "127.0.0.1", port, timeout=300)
                conn.request("POST", "/classify", body=payloads[i],
                             headers={"Content-Type": "application/x-npy"})
                r = conn.getresponse()
                doc = json.loads(r.read())
                assert r.status == 200, doc

            drive(wire_call)
            sec = front.serving_section()
            validate_serving(sec)
            assert sec["requests"]["ok"] == n_req
            wired = sec["latency_ms"]["p99"]
        trials.append({"bare_p99_ms": bare, "wire_p99_ms": wired,
                       "ratio": wired / bare})
    return min(t["ratio"] for t in trials), trials


def phase_fleet_small() -> dict:
    """Phase 42: the serving fleet at the reference tests' shapes (the
    120-gene, 4-cluster atlas), one model dir built by the port on the
    CPU and served on the card and on the CPU: the wire front's statuses,
    a replica kill through the pool with its respawn, the three fault
    sites and the planted-drift reconsensus loop; card = CPU on the
    statuses' labels, the sites and the loop's ``labels_sha`` and new
    clusters. Then the model built on the card against the CPU's build,
    and the wire-overhead guard on the production-shaped model. The
    chaos plans (swap, replay, kill under load) run once, in phase 44's
    worker children, on both devices. Returns the guard and the loop's
    numbers."""
    import shutil
    import tempfile

    import torch

    from scconsensus_tpu_torch.serve.fleet.pool import ReplicaPool
    from scconsensus_tpu_torch.serve.fleet.soak import (
        _gaussian_atlas,
        build_atlas_model,
        make_query_batches,
    )
    from scconsensus_tpu_torch.serve.slo import validate_slo

    root = tempfile.mkdtemp(prefix="scc-fleet-")
    out = {}
    try:
        v1 = os.path.join(root, "model_v1")
        v2 = os.path.join(root, "model_v2")
        build_atlas_model(v1, seed=FLEET_SEED, device="cpu")
        build_atlas_model(v2, seed=FLEET_SEED, landmark_seed=FLEET_SEED
                          + 1000, device="cpu")
        by_dev = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            r = {"statuses": _fleet_statuses(v1, dev, root)}
            r["sites"] = _fleet_sites(v1, v2, dev, root)
            with ReplicaPool(v1, n_replicas=2, config=_fleet_cfg(),
                             device=dev) as pool:
                x = make_query_batches(1, 4, FLEET_SEED)[0]
                assert pool.classify(x, timeout=60).outcome == "ok"
                before = {rep.index for rep in pool.replicas()}
                k = pool.kill_replica()
                after = {rep.index for rep in pool.replicas()}
                assert len(after) == 2 and k["respawned"] not in before
                assert pool.classify(x, timeout=60).outcome == "ok"
                sec = pool.serving_section()
                slo = pool.slo_section()
            assert sec["requests"]["ok"] == 2 and len(sec["fleet"]["kills"])
            validate_slo(slo)
            r["recon"] = _fleet_reconsensus(v1, dev, root)
            r["wall_s"] = time.perf_counter() - t0
            by_dev[dev] = r
            log(f"[fleet] {dev}: statuses "
                f"{json.dumps(r['statuses']['status_codes'])} (429 x "
                f"{r['statuses']['queue_full'][1]}); fault sites "
                f"{json.dumps(r['sites'])}; pool kill "
                f"{json.dumps(k)}; reconsensus loop "
                f"{r['recon']['loop_s']!r} s, new labels "
                f"{r['recon']['new_labels']}, ARI {r['recon']['ari']!r}; "
                f"{r['wall_s']!r} s")
        card, cpu = by_dev["cuda"], by_dev["cpu"]
        assert card["statuses"]["labels"] == cpu["statuses"]["labels"]
        assert card["sites"] == cpu["sites"]
        for key in ("new_labels", "n_new_clusters", "labels_sha"):
            assert card["recon"][key] == cpu["recon"][key], key
        # the model built on the card labels the training cells as the
        # CPU's build does
        t0 = time.perf_counter()
        built = build_atlas_model(os.path.join(root, "card"),
                                  seed=FLEET_SEED, device="cuda")
        t_build = time.perf_counter() - t0
        cells, truth, _ = _gaussian_atlas(120, 4, 360, FLEET_SEED)
        from scconsensus_tpu_torch.serve.model import load_consensus_model

        on_cpu = load_consensus_model(v1, device="cuda")
        got = built.classify(cells)[0]
        assert np.array_equal(got, on_cpu.classify(cells)[0])
        log(f"[fleet] card = CPU: statuses' labels, fault sites, "
            f"reconsensus sha "
            f"{card['recon']['labels_sha'][:16]}; the card's build "
            f"{built.fingerprint()} in {t_build!r} s labels the 360 "
            "training cells as the CPU's")
        torch.cuda.synchronize()
        ratio, trials = _wire_guard()
        log(f"[fleet-guard] served p99 with the wire front and pool over "
            f"the bare driver's at 1 replica, best of 3: {ratio!r} (limit "
            f"{WIRE_GUARD_LIMIT}); trials {json.dumps(trials)}")
        if ratio >= WIRE_GUARD_LIMIT:
            raise AssertionError(f"[fleet-guard] {ratio!r}")
        out = {"guard_ratio": ratio, "guard_trials": trials,
               "recon_loop_s": card["recon"]["loop_s"],
               "wall_by_device": {d: r["wall_s"] for d, r in by_dev.items()}}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def _hist_median_ms(hist: dict):
    """The upper edge of the bucket holding a histogram's median (None past
    the last edge), and the mean."""
    from scconsensus_tpu_torch.serve.slo import LATENCY_BUCKETS_MS

    n = hist["count"]
    if not n:
        return None, None
    acc = 0
    for edge, c in zip(list(LATENCY_BUCKETS_MS) + [None], hist["buckets"]):
        acc += c
        if 2 * acc >= n:
            return edge, hist["sum_ms"] / n
    return None, hist["sum_ms"] / n


@contextlib.contextmanager
def _json_cpu():
    """The thread CPU seconds every thread of this process spends in
    ``json.dumps`` and ``json.loads`` during the block (the pumps' request
    bodies and response reads, the handlers' body parses and replies):
    the host's JSON work on the requests the block serves. The calls hold
    the GIL from start to end, so their CPU is their share of the
    process's one interpreter."""
    import threading

    spent = {"encode_s": 0.0, "decode_s": 0.0, "encode_calls": 0,
             "decode_calls": 0}
    lock = threading.Lock()
    dumps, loads = json.dumps, json.loads

    def timed(fn, key):
        def run(*a, **k):
            t = time.thread_time()
            try:
                return fn(*a, **k)
            finally:
                dt = time.thread_time() - t
                with lock:
                    spent[key + "_s"] += dt
                    spent[key + "_calls"] += 1
        return run

    json.dumps, json.loads = timed(dumps, "encode"), timed(loads, "decode")
    try:
        yield spent
    finally:
        json.dumps, json.loads = dumps, loads


def phase_fleet_atlas() -> dict:
    """Phase 43: the bench's ``atlas_query`` over a 2-replica fleet on the
    card (``run_fleet_soak`` as ``bench.py:1462`` calls it, at
    ``ATLAS_QUERY``'s 150 of the bench's 300 requests of 64 cells, the
    last 8 foreign, a 2,000-gene 12-cluster atlas of 20,000 training
    cells). The model is built first and timed apart;
    then one pass, its cells/s, wall, p50 and p99, the stage medians,
    outcomes and peak device memory, and the host's JSON encoding and
    decoding in that pass beside it."""
    import shutil
    import tempfile

    import torch

    from scconsensus_tpu_torch.obs.export import validate_run_record
    from scconsensus_tpu_torch.serve.fleet.soak import (
        build_atlas_model,
        make_query_batches,
        run_fleet_soak,
    )

    q = ATLAS_QUERY
    root = tempfile.mkdtemp(prefix="scc-atlas-query-")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = build_atlas_model(
            os.path.join(root, "model_v1"), n_genes=q["n_genes"],
            n_clusters=q["n_clusters"], n_train=q["n_train"],
            seed=q["seed"], device="cuda")
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        log(f"[atlas-query] model built on the card in {t_build!r} s: "
            f"{model.n_genes} genes, {model.n_pcs} PCs, {model.k} "
            f"landmarks, fingerprint {model.fingerprint()}")
        torch.cuda.reset_peak_memory_stats()
        with _json_cpu() as spent:
            t0 = time.perf_counter()
            s = run_fleet_soak(root, device="cuda", **q)
            wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    assert s["ok"] and not s["model_built"], s["outcome_counts"]
    counts = s["outcome_counts"]
    assert counts == {"ok": q["n_requests"] - q["n_ood"],
                      "quarantined": q["n_ood"]}, counts
    rec = s["record"]
    validate_run_record(rec)
    sec, slo = rec["serving"], rec["slo"]
    lat = sec["latency_ms"]
    stages = {k: _hist_median_ms(h) for k, h in slo["stage_hist"].items()}
    n_cells = q["n_requests"] * q["cells_per"]
    t_enc, t_dec = spent["encode_s"], spent["decode_s"]
    body_mb = len(json.dumps({"cells": make_query_batches(
        1, q["cells_per"], q["seed"], n_genes=q["n_genes"],
        n_clusters=q["n_clusters"])[0].tolist()})) / 1e6
    out = {"build_s": t_build, "wall_s": wall, "cells_per_s": n_cells / wall,
           "p50_ms": lat["p50"], "p99_ms": lat["p99"],
           "stage_median_ms": {k: v[0] for k, v in stages.items()},
           "stage_mean_ms": {k: v[1] for k, v in stages.items()},
           "outcomes": counts, "peak_bytes": peak,
           "json_encode_s": t_enc, "json_decode_s": t_dec,
           "json_calls": (spent["encode_calls"], spent["decode_calls"]),
           "request_mb": body_mb}
    log(f"[atlas-query] {q['n_requests']} requests x {q['cells_per']} "
        f"cells over {q['replicas']} replicas in {wall!r} s: "
        f"{n_cells / wall!r} cells/s (phase 19, the same request shape "
        f"through one ConsensusServer at 15,000 genes: "
        f"{_FACTS.get('serve_cells_per_s')!r} cells/s); served latency ms "
        f"p50 {lat['p50']!r} p99 {lat['p99']!r}; stage median bucket "
        f"(ms, upper edge) and mean {json.dumps(stages)}; outcomes "
        f"{json.dumps(counts)}; peak device memory {peak} bytes; the "
        f"host's JSON in the pass (thread CPU in json.dumps and "
        f"json.loads, {spent['encode_calls']} and {spent['decode_calls']} "
        f"calls; a request body {body_mb!r} MB): encode {t_enc!r} s, "
        f"decode {t_dec!r} s, {(t_enc + t_dec) / wall!r} of the pass's "
        f"wall")
    return out


# the fleet worker and the load generator in children of the launcher
_LOAD_CHILD = """
import json, os, sys
sys.path.insert(0, {repo!r})
from scconsensus_tpu_torch.serve.fleet.autoscale import AutoscalePolicy
from scconsensus_tpu_torch.serve.fleet.loadgen import run_load
kw = json.loads({kw!r})
os.environ.update(kw.pop("env", {{}}))
policy = kw.pop("policy", None)
if policy is not None:
    policy = AutoscalePolicy.from_env(**policy)
workdir = kw.pop("workdir")
s = run_load(workdir, policy=policy, device="cuda", **kw)
# the summary beside the run, as tools/load_run.py writes it: the
# postmortem bundle reads the record's fleet section from it
with open(os.path.join(workdir, "LOAD_SUMMARY.json"), "w") as f:
    json.dump(s, f, indent=1, default=str)
rec = s.pop("record")
s["record_valid"] = "invalid" not in rec
s["ticks"] = ((rec.get("loadgen") or {{}}).get("autoscale") or {{}}).get(
    "ticks")
print(json.dumps(s, default=str))
"""

# tools/load_run.py --spike-soak's defaults (:340-357) and policy (:176-188):
# at the reference's 0.1 s tick the card holds a queue at 96 cells (every
# such run shed), so the payload stays the reference's (PERF.md, the fleet)
SPIKE_SOAK = dict(profile="spike", base_rps=12.0, peak_rps=150.0,
                  duration_s=15.0, seed=7, replicas=1, cells_per=96,
                  queue_capacity=4, autoscale=True, fresh=True)
SPIKE_POLICY = dict(min_replicas=1, max_replicas=3, up_ticks=2,
                    down_ticks=4, cooldown_ticks=3, queue_high=0.25,
                    queue_low=0.05)
# the spike soak's tick (tools/load_run.py:357), set in the child itself:
# the launcher's children take its environment, not this process's
SPIKE_ENV = {"SCC_AUTOSCALE_TICK_S": "0.1"}
# the kill plan's payload (tools/chaos_run.py:694-700)
KILL_ARGS = dict(cells=256, pumps=6)


def _fleet_soak_argv(workdir: str, n: int, *extra) -> list:
    argv = [sys.executable, "-m", "scconsensus_tpu_torch.serve.fleet.soak",
            "--dir", workdir, "--requests", str(n), "--summary",
            os.path.join(workdir, "SUMMARY.json"), *extra]
    if "cpu" in extra:
        # several workers share the host's cores: two torch threads each
        argv = ["env", "OMP_NUM_THREADS=2", *argv]
    return argv


def _load_argv(workdir: str, pumps: int = 8, **kw) -> list:
    code = _LOAD_CHILD.format(repo=REPO, kw=json.dumps(
        {"workdir": workdir, "pumps": pumps, **kw}))
    return [sys.executable, "-c", code]


def _child_summary(tag: str, proc: dict, path=None) -> dict:
    if path is not None:
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            pass
    else:
        try:
            return json.loads(proc["stdout"].strip().splitlines()[-1])
        except (IndexError, ValueError):
            pass
    raise AssertionError(f"[fleet-workers] {tag}: exit {proc['rc']}: "
                         f"{proc['stderr'][-2000:]}")


def _spike_checks(s: dict, floor: int, bundle: dict, pm_rc: int) -> list:
    """tools/load_run.py:207-260's checks over a spike run's summary and
    the postmortem bundle built over its work dir."""
    acts, scales = s.get("actuations") or [], s.get("scales") or []
    ups = [a for a in acts if a.get("kind") == "scale_up"]
    downs = [a for a in acts if a.get("kind") == "scale_down"]
    counts = s.get("outcome_counts") or {}
    timeline = bundle.get("timeline") or []
    tl_acts = [e for e in timeline if e.get("kind") == "actuation"]
    return [
        ("run clean", bool(s["ok"])),
        ("scaled up from the floor", any(a.get("from") == floor
                                         for a in ups)),
        ("recovered to the floor", bool(downs) and bool(scales)
         and scales[-1].get("to") == floor),
        ("shed through 429s", counts.get("rejected_queue", 0) >= 1),
        ("zero SLO breaches", bool(s["slo_held"]) and not s["breaches"]),
        ("rps_at_slo > 0", float(s["rps_at_slo"]) > 0.0),
        ("run record validated", bool(s["record_valid"])),
        ("postmortem bundle built over the workdir",
         pm_rc == 0 and bool(timeline)),
        ("every actuation on the merged timeline",
         bool(acts) and len(tl_acts) >= len(acts)),
        ("replica resizes mirrored onto the timeline",
         any(e.get("kind") == "replica_scale" for e in timeline)),
    ]


def _postmortem(launcher, workdir: str) -> tuple:
    """The reference's stdlib ``tools/postmortem.py`` over ``workdir`` in
    a child: its exit code and the bundle it wrote."""
    path = os.path.join(workdir, "POSTMORTEM_BUNDLE.json")
    proc = _launch(launcher, [sys.executable, os.path.join(
        REPO, "tools", "postmortem.py"), workdir, "--out", path, "--json"],
        120)
    try:
        with open(path) as f:
            return proc["rc"], json.load(f)
    except (OSError, ValueError):
        return proc["rc"], {}


def _kill_argv(workdir: str, cells: int, pumps: int,
               device: str = "cuda") -> list:
    return _fleet_soak_argv(workdir, 30, "--fresh", "--replicas", "2",
                            "--kill-after", "6", "--heartbeat", "0.15",
                            "--cells", str(cells), "--concurrency",
                            str(pumps), "--device", device)


def phase_fleet_workers(launcher) -> dict:
    """Phase 44: the fleet's chaos worker (``python -m
    scconsensus_tpu_torch.serve.fleet.soak``) and the load generator in
    fresh children of the launcher. First the reference's swap-under-load
    (3 replicas, 16 requests, swap after 5), replay-across-replicas (1
    replica, 3, and 3 with ``--device cpu``, on one model built here) and
    kill-replica-under-load (2 replicas, 30 requests of 256 cells from 6
    pumps, heartbeat 0.15 s, kill after 6) plans, the swap and the kill
    also with ``--device cpu``, all started at once (each plan runs only
    here: card = CPU on every plan's ``labels_sha``); then
    one ``run_load`` at the reference's defaults alone; then the spike
    soak of ``tools/load_run.py`` at its defaults alone, with the
    reference's ``tools/postmortem.py`` over its work dir. Each runs
    once, at the reference's payloads, held to the checks the reference's
    tool states; the two load runs alone, as their latency is the fleet's
    only when no other child shares the host's cores."""
    import shutil
    import tempfile

    from scconsensus_tpu_torch.serve.fleet.soak import build_atlas_model

    root = tempfile.mkdtemp(prefix="scc-fleet-workers-")
    d = {k: os.path.join(root, k) for k in ("swap", "replay", "kill",
                                             "swap-cpu", "kill-cpu",
                                             "load", "spike")}

    def soaked(tag, proc, work):
        return _child_summary(tag, proc, os.path.join(work, "SUMMARY.json"))

    walls = []

    def wave(argvs):
        t0 = time.perf_counter()
        out = _launch_all(launcher, argvs, 300)
        walls.append(time.perf_counter() - t0)
        return out

    try:
        # the replay's three runs on one model built here first (the
        # plan's 1-replica run building it otherwise)
        build_atlas_model(os.path.join(d["replay"], "model_v1"),
                          seed=FLEET_SEED, device="cuda")
        for tag in ("-3", "-cpu"):
            shutil.copytree(d["replay"], d["replay"] + tag)
        procs = wave([
            _fleet_soak_argv(d["swap"], 16, "--fresh", "--replicas", "3",
                             "--swap-after", "5", "--device", "cuda"),
            _fleet_soak_argv(d["replay"], 16, "--replicas", "1",
                             "--device", "cuda"),
            _fleet_soak_argv(d["replay"] + "-3", 16, "--replicas", "3",
                             "--device", "cuda"),
            _fleet_soak_argv(d["replay"] + "-cpu", 16, "--replicas", "3",
                             "--device", "cpu"),
            _kill_argv(d["kill"], **KILL_ARGS),
            _fleet_soak_argv(d["swap-cpu"], 16, "--fresh", "--replicas",
                             "3", "--swap-after", "5", "--device", "cpu"),
            _kill_argv(d["kill-cpu"], **KILL_ARGS, device="cpu")])
        swap = soaked("swap", procs[0], d["swap"])
        r1 = soaked("replay-1", procs[1], d["replay"])
        r3 = soaked("replay-3", procs[2], d["replay"] + "-3")
        rcpu = soaked("replay-cpu", procs[3], d["replay"] + "-cpu")
        kill = soaked("kill", procs[4], d["kill"])
        swap_cpu = soaked("swap-cpu", procs[5], d["swap-cpu"])
        kill_cpu = soaked("kill-cpu", procs[6], d["kill-cpu"])
        load = _child_summary("load", wave([_load_argv(d["load"],
                                                       fresh=True)])[0])
        spike = _child_summary("spike", wave([_load_argv(
            d["spike"], policy=SPIKE_POLICY, env=SPIKE_ENV,
            **SPIKE_SOAK)])[0])
        pm_rc, bundle = _postmortem(launcher, d["spike"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    checks = _spike_checks(spike, SPIKE_SOAK["replicas"], bundle, pm_rc)
    acts = [(a["kind"], a["from"], a["to"]) for a in spike["actuations"]]
    log(f"[fleet-workers] the waves of children took {walls!r} s")
    log(f"[fleet-workers] kill plan at {json.dumps(KILL_ARGS)}: kills "
        f"{json.dumps(kill['kills'])}, retried {len(kill['retried'])}, "
        f"continuity {kill['trace_continuity']}, outcomes "
        f"{json.dumps(kill['outcome_counts'])}")
    log(f"[fleet-workers] spike soak at {SPIKE_SOAK['cells_per']} cells a "
        f"request: offered {spike['offered']}, outcomes "
        f"{json.dumps(spike['outcome_counts'])}, rps_at_slo "
        f"{spike['rps_at_slo']!r}, achieved {spike['achieved_rps']!r}, "
        f"late {spike['late_fraction']!r}, breaches {spike['breaches']}, "
        f"actuations {acts} in {spike['ticks']} ticks of "
        f"{SPIKE_ENV['SCC_AUTOSCALE_TICK_S']} s; "
        f"postmortem exit {pm_rc}, {len(bundle.get('timeline') or [])} "
        f"timeline events; checks {checks}")
    log(f"[fleet-workers] swap v1 {swap['fp_v1']} -> v2 {swap['fp_v2']}, "
        f"{swap['post_swap_responses']} post-swap responses; replay sha "
        f"{r1['labels_sha'][:16]} / {r3['labels_sha'][:16]} / "
        f"{rcpu['labels_sha'][:16]} (1 and 3 replicas, card and CPU); "
        f"run_load steady 20 rps 8 s alone: offered {load['offered']}, "
        f"good {load['good']}, rps_at_slo {load['rps_at_slo']!r}, late "
        f"{load['late_fraction']!r}, breaches {load['breaches']}, scales "
        f"{len(load['scales'])}, outcomes "
        f"{json.dumps(load['outcome_counts'])}")
    log(f"[fleet-workers] card = CPU: swap sha {swap['labels_sha'][:16]} "
        f"/ {swap_cpu['labels_sha'][:16]}, kill sha "
        f"{kill['labels_sha'][:16]} / {kill_cpu['labels_sha'][:16]}")
    # swap-under-load (tools/chaos_run.py:651-685), on both devices
    for sw in (swap, swap_cpu):
        sv = sw["record"]["serving"]
        fps = set(sw["fps_seen"])
        assert sw["ok"] and sw["resolved"] == sw["requests"] == 16
        assert sw["accounting_ok"] is True
        assert sw["swapped"] and sw["post_swap_responses"]
        assert fps and fps <= {sw["fp_v1"], sw["fp_v2"]}
        assert sw["post_swap_pure"] is True and len(
            sv["fleet"]["swaps"]) >= 1
    assert swap["labels_sha"] == swap_cpu["labels_sha"]
    # replay-across-replicas (:768-793), and the CPU on the same model
    assert r1["ok"] and r3["ok"] and rcpu["ok"]
    assert r1["labels_sha"] == r3["labels_sha"] == rcpu["labels_sha"]
    assert r1["fp_v1"] == r3["fp_v1"] == rcpu["fp_v1"]
    # kill-replica-under-load (:686-718), on the worker's own attempt log
    assert kill["ok"] and kill["resolved"] == kill["requests"] == 30
    assert any(k.get("respawned") is not None for k in kill["kills"])
    assert all(k in ("ok", "degraded", "quarantined")
               for k in kill["outcome_counts"])
    assert len(kill["retried"]) >= 1 and kill["trace_continuity"] is True
    assert kill_cpu["ok"] and kill_cpu["resolved"] == 30
    assert kill_cpu["trace_continuity"] is not False
    assert kill["labels_sha"] == kill_cpu["labels_sha"]
    # run_load at the defaults, alone (tools/load_run.py:130-167): nothing
    # lost, a valid record; its SLO reading is printed, not held, as the
    # tool does not hold it (PERF.md, the fleet)
    assert load["ok"] and load["sent"] == load["offered"], load
    assert load["record_valid"], load
    # the spike soak (tools/load_run.py:207-260)
    failed = [n for n, c in checks if not c]
    if failed:
        raise AssertionError(f"[fleet-workers] spike soak: {failed}")
    return {"load_rps_at_slo": load["rps_at_slo"],
            "spike_rps_at_slo": spike["rps_at_slo"],
            "spike_cells": SPIKE_SOAK["cells_per"], "kill": KILL_ARGS,
            "wall_s": sum(walls)}


# ---------------------------------------------------------------------------
# phase 45: the mesh across two processes
# ---------------------------------------------------------------------------

# two ranks, each with 2 shards of the one card: phase 26's 4-shard mesh,
# split across a gloo group
MESH2_PROCS = 2


def _data_sha(data, cons) -> str:
    """sha256 of the 26k matrix's bytes and the consensus labels (the
    proof that a child drew phase 6's data)."""
    h = hashlib.sha256()
    h.update(data.cpu().numpy().tobytes())
    h.update("\x00".join(str(c) for c in cons).encode())
    return h.hexdigest()


_MESH2_CHILD = """
import json, os, sys, time
from datetime import timedelta
sys.path.insert(0, {repo!r})
import numpy as np
import torch
import torch.distributed as dist
import chip_smoke

rank = {rank}
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:{port}",
                        world_size={procs}, rank=rank,
                        timeout=timedelta(seconds=300))
from scconsensus_tpu_torch import recluster_de_consensus_fast
from scconsensus_tpu_torch.ops.cuda_kernels import distance_cluster_sums
from scconsensus_tpu_torch.parallel import mesh as pmesh
from scconsensus_tpu_torch.robust import faults
from scconsensus_tpu_torch.robust.elastic import DeviceLossUnrecoverable

data, truth, cons = chip_smoke.phase_full_data()
sha = chip_smoke._data_sha(data, cons)
out = {{"rank": rank, "data_sha": sha}}


def run(tag, **kw):
    # one refine with the counts at 0 just before it; its result saved
    # for the launcher, its numbers into out[tag]
    for k in pmesh.SENT_BYTES:
        pmesh.SENT_BYTES[k] = 0
    distance_cluster_sums.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        res = recluster_de_consensus_fast(data, cons, device="cuda", **kw)
    except DeviceLossUnrecoverable as e:
        out[tag] = {{"raised": type(e).__name__, "message": str(e),
                    "launches": distance_cluster_sums.launches}}
        return
    torch.cuda.synchronize()
    m = res.metrics
    np.savez(os.path.join({root!r}, "rank%d_%s.npz" % (rank, tag)),
             log_p=res.de.log_p.cpu().numpy(),
             de_mask=res.de.de_mask.cpu().numpy(),
             union=res.de_gene_union_idx,
             silhouettes=np.array([i["silhouette"]
                                   for i in res.deep_split_info]),
             keys=np.array(sorted(res.dynamic_labels)),
             **{{"labels%d" % i: res.dynamic_labels[k]
                for i, k in enumerate(sorted(res.dynamic_labels))}})
    out[tag] = {{
        "wall_s": time.perf_counter() - t0,
        "launches": distance_cluster_sums.launches,
        "sent_bytes": dict(pmesh.SENT_BYTES),
        "kernel": m["wilcox_ladder"]["kernel"],
        "silhouette": m["silhouette"], "stage_walls_s": m["stage_walls_s"],
        "transitions": m.get("robustness", {{}}).get("mesh_transitions",
                                                     []),
        "peak_bytes": torch.cuda.max_memory_allocated()}}


# phase 26's 4-shard mesh, 2 shards a rank
mesh = pmesh.make_mesh(chip_smoke.MESH_SHARDS, device="cuda")
out["local"], out["procs"] = list(mesh.local), mesh.procs
dist.barrier()
run("mesh", mesh=mesh)
# (a) the default mesh="auto": every rank's card, one shard a rank
auto = pmesh.auto_mesh("cuda")
out["auto_mesh"] = {{"size": auto.size, "local": list(auto.local),
                    "meta": pmesh.mesh_shape_meta(auto)}}
dist.barrier()
run("auto")
# (b) the same under a device loss at stage:silhouette: rank 0 goes on
# alone on the lowest half, rank 1 leaves the run
os.environ["SCC_FAULT_PLAN"] = os.path.join({root!r}, "plan.json")
faults.reset()
dist.barrier()
run("loss")
print("MESH2 " + json.dumps(out), flush=True)
dist.destroy_process_group()
"""


def _mesh2_view(path: str):
    """A rank's saved result, shaped for ``assert_mesh_equals_serial``."""
    from types import SimpleNamespace

    z = np.load(path)
    labels = {str(k): z[f"labels{i}"] for i, k in enumerate(z["keys"])}
    return SimpleNamespace(
        de=SimpleNamespace(log_p=z["log_p"], de_mask=z["de_mask"]),
        de_gene_union_idx=z["union"], dynamic_labels=labels,
        deep_split_info=[{"silhouette": float(v)}
                         for v in z["silhouettes"]])


def _mesh_procs_start() -> dict:
    """Start phase 45's two children (they run while phase 41's do);
    ``phase_mesh_procs`` collects them. Started from this process, not
    the launcher: the phase reads no host RSS, and the launcher is busy
    with phase 41."""
    import socket
    import tempfile

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = tempfile.mkdtemp(prefix="scc-mesh2-")
    with open(os.path.join(root, "plan.json"), "w") as f:
        json.dump({"faults": [{"site": "stage:silhouette",
                               "class": "device_loss"}]}, f)
    env = {k: v for k, v in os.environ.items() if k != "SCC_FAULT_PLAN"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _MESH2_CHILD.format(
            repo=REPO, rank=r, port=port, procs=MESH2_PROCS, root=root)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(MESH2_PROCS)]
    return {"root": root, "procs": procs, "t0": time.perf_counter()}


def _mesh2_held(tag: str, view, ref: dict) -> None:
    """A rank's result held to phase 7's serial run by
    ``assert_mesh_equals_serial`` and to phase 26's labels."""
    _mesh_contract(tag, view, _summary_view(ref["serial"]),
                   "phase 7 serial")
    for key, want in ref["mesh"]["labels"].items():
        if not np.array_equal(view.dynamic_labels[key], want):
            raise AssertionError(f"[{tag}] {key}: labels differ from "
                                 "phase 26's")


def phase_mesh_procs(started: dict, ref: dict) -> dict:
    """Phase 45: the 26k flagship across two processes, two children
    (started by ``_mesh_procs_start`` beside phase 41), each on ``cuda``
    joined by a gloo group (``torch.distributed``), each drawing phase
    6's data itself (both draws' sha held to phase 6's). Each child runs
    three refines in turn, each with the kernel's count at 0 just before
    it:

    * ``mesh``: phase 26's 4-shard mesh, 2 shards a rank
      (``make_mesh(4, device="cuda")``);
    * ``auto``: the default ``mesh="auto"``, which resolves to every
      rank's card, 2 shards, one a rank (``cuda:0`` in each);
    * ``loss``: ``auto`` under an injected ``device_loss`` at
      ``stage:silhouette``: rank 0 must record the transition [0, 1] →
      [0] and go on alone, rank 1 must raise
      ``DeviceLossUnrecoverable`` (the fault fires at the stage's entry,
      so rank 1 launches no kernel there); anything else fails.

    Every finished run is held to phase 7's serial run by
    ``parallel.validate.assert_mesh_equals_serial`` and to phase 26's
    labels; the ranks' ``mesh`` and ``auto`` results the same bits.
    Printed: each run's wall, the bytes each collective sent across the
    group and the kernel's launches. ``ref``: phase 7's summary
    (``serial``), phase 26's (``mesh``) and phase 6's data sha. Returns
    the launches over both ranks of each path and the numbers."""
    import shutil

    root = started["root"]
    try:
        procs = []
        for p in started["procs"]:
            out, err = p.communicate(timeout=600)
            procs.append({"rc": p.returncode, "stdout": out, "stderr": err})
        wall = time.perf_counter() - started["t0"]
        ranks = []
        for r, proc in enumerate(procs):
            lines = [ln for ln in proc["stdout"].splitlines()
                     if ln.startswith("MESH2 ")]
            if proc["rc"] != 0 or not lines:
                raise AssertionError(
                    f"[mesh-procs] rank {r} failed (exit {proc['rc']}): "
                    f"{proc['stderr'][-3000:]}")
            ranks.append(json.loads(lines[-1][len("MESH2 "):]))
        views = {(r, tag): _mesh2_view(path) for r in range(MESH2_PROCS)
                 for tag in ("mesh", "auto", "loss")
                 for path in [os.path.join(root, f"rank{r}_{tag}.npz")]
                 if os.path.exists(path)}
    finally:
        for p in started["procs"]:  # a failed rank's partner
            if p.poll() is None:
                p.kill()
                p.communicate()
        shutil.rmtree(root, ignore_errors=True)
    for r, rec in enumerate(ranks):
        if rec["data_sha"] != ref["data_sha"]:
            raise AssertionError(f"[mesh-procs] rank {r} drew other data: "
                                 f"{rec['data_sha']} against phase 6's "
                                 f"{ref['data_sha']}")
        if rec["procs"] != MESH2_PROCS or len(rec["local"]) != \
                MESH_SHARDS // MESH2_PROCS:
            raise AssertionError(f"[mesh-procs] rank {r}: {rec['local']}")
        am = rec["auto_mesh"]
        if (am["size"], am["local"], am["meta"]["device_ids"]) != (
                MESH2_PROCS, [r], list(range(MESH2_PROCS))):
            raise AssertionError(f"[mesh-procs] rank {r}: mesh='auto' "
                                 f"resolved to {am}")
        for tag in ("mesh", "auto"):
            run = rec[tag]
            log(f"[mesh-procs] rank {r} {tag} (shards "
                f"{run['silhouette'].get('n_shards')}): refine wall "
                f"{run['wall_s']!r} s, bytes sent across the group by "
                f"collective {json.dumps(run['sent_bytes'])}, kernel "
                f"launches {run['launches']}, peak {run['peak_bytes']} "
                f"bytes; stage walls (s) {json.dumps(run['stage_walls_s'])}")
            if run["kernel"] != "mesh-scan" or run["launches"] != 1 or \
                    run["silhouette"].get("engine") != "kernel":
                raise AssertionError(f"[mesh-procs] rank {r} {tag}: kernel "
                                     f"{run['kernel']}, {run['launches']} "
                                     "launches")
            if not run["sent_bytes"]["gather"] or run["transitions"]:
                raise AssertionError(f"[mesh-procs] rank {r} {tag}: "
                                     f"{run['sent_bytes']}, "
                                     f"{run['transitions']}")
            _mesh2_held(f"mesh-procs-{tag}-{r}", views[(r, tag)], ref)
    loss0, loss1 = ranks[0]["loss"], ranks[1]["loss"]
    if "raised" in loss0 or (0, "loss") not in views:
        raise AssertionError(f"[mesh-procs] rank 0 under the loss: {loss0}")
    trans = [(t["stage"], t["from_devices"], t["to_devices"], t["cause"])
             for t in loss0["transitions"]]
    if trans != [("stage:silhouette", [0, 1], [0], "device_loss")] or \
            loss0["launches"] != 1:
        raise AssertionError(f"[mesh-procs] rank 0 under the loss: "
                             f"{trans}, {loss0['launches']} launches")
    _mesh2_held("mesh-procs-loss-0", views[(0, "loss")], ref)
    if loss1.get("raised") != "DeviceLossUnrecoverable" or \
            "all on rank 0" not in loss1["message"] or \
            loss1["launches"] != 0 or (1, "loss") in views:
        raise AssertionError(f"[mesh-procs] rank 1 under the loss: {loss1}")
    log(f"[mesh-procs] loss: rank 0 went on alone ({trans[0]}), refine "
        f"wall {loss0['wall_s']!r} s, launches {loss0['launches']}; rank 1 "
        f"raised {loss1['raised']}: {loss1['message']}")
    for tag in ("mesh", "auto"):
        a, b = views[(0, tag)], views[(1, tag)]
        if not (np.array_equal(a.de.log_p, b.de.log_p, equal_nan=True)
                and np.array_equal(a.de_gene_union_idx, b.de_gene_union_idx)
                and [i["silhouette"] for i in a.deep_split_info]
                == [i["silhouette"] for i in b.deep_split_info]):
            raise AssertionError(f"[mesh-procs] {tag}: the ranks' results "
                                 "differ")
    launches = {tag: sum(rec[tag]["launches"] for rec in ranks)
                for tag in ("mesh", "auto", "loss")}
    out = {"wall_s": wall, "launches": launches, "ranks": [
        {tag: {k: rec[tag][k] for k in ("wall_s", "sent_bytes", "launches",
                                        "peak_bytes") if k in rec[tag]}
         for tag in ("mesh", "auto", "loss")} for rec in ranks]}
    log(f"[mesh-procs] both ranks' draws sha {ref['data_sha'][:16]} = "
        "phase 6's; every finished run = phase 7's serial run "
        "(assert_mesh_equals_serial) and phase 26's labels; the ranks the "
        f"same bits; launches by path {json.dumps(launches)}; the children "
        f"in {wall!r} s from their start")
    return out


def _time_phases() -> dict:
    """Wrap every ``phase_*`` function of this module (none calls another)
    so that its wall, summed over its calls, lands in the returned dict,
    printed at the end: the script's time accounted phase by phase."""
    walls = {}

    def timed(fn):
        @functools.wraps(fn)
        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                walls[fn.__name__] = (walls.get(fn.__name__, 0.0)
                                      + time.perf_counter() - t)
        return run

    g = globals()
    for name in [n for n in g if n.startswith("phase_")]:
        g[name] = timed(g[name])
    return walls


# a run still going after this many seconds prints every thread's stack
# to stderr (the script must end within 1,200 s), so a hang leaves the
# line it hangs on in the log
HANG_DUMP_S = 1000


def main() -> int:
    faulthandler.dump_traceback_later(HANG_DUMP_S)
    # started before torch is imported (see _LAUNCHER)
    launcher = _start_launcher()
    try:
        return _main(launcher)
    finally:
        _stop_launcher(launcher)
        faulthandler.cancel_dump_traceback_later()


def _main(launcher) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "scconsensus_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(scconsensus_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)

    t_start = time.perf_counter()
    phase_walls = _time_phases()
    # the compile log, armed before phase 2's builds: on a clean checkout
    # it records the nvcc and g++ builds (printed at the end)
    from scconsensus_tpu_torch.obs import compilelog

    compilelog.install_and_mark(force=True)
    env = phase_env()
    phase_build()
    phase_kernel()
    phase_small()
    phase_small_edger()
    phase_small_csr()
    phase_small_seurat()
    phase_guard_small()
    phase_mesh_small()
    phase_oracles()
    data, truth, cons = phase_full_data()
    data_sha = _data_sha(data, cons)
    log(f"[data] sha256 of the matrix and the consensus labels {data_sha}")
    rec, dense_fast = phase_full(data, truth, cons)
    records = {"7": _flagship_record(dense_fast.metrics)}
    erec, dense_edger = phase_edger_full(data, truth, cons)
    csr_launches, ecsr_launches, csr = phase_full_csr(
        data, truth, cons, dense_fast, dense_edger)
    serve_launches = phase_serve(data, dense_fast)
    wilcox_ref = _summary(dense_fast)
    n_buckets = len(dense_fast.metrics["wilcox_ladder"]["buckets"])
    del dense_fast, dense_edger
    seurat_launches = phase_full_seurat(data, truth, cons, wilcox_ref)
    resume_launches = phase_resume(data, truth, cons, wilcox_ref)
    guarded_launches = phase_guarded(data, truth, cons, wilcox_ref,
                                     n_buckets)
    mesh_ref = phase_mesh_full(data, truth, cons, wilcox_ref)
    elastic_launches = phase_elastic(data, truth, cons, mesh_ref, launcher)
    # what phase 45 holds its two processes to
    mesh2_ref = {"serial": wilcox_ref, "mesh": mesh_ref["summary"],
                 "data_sha": data_sha}
    trace_launches, trace_out = phase_trace_full(data, truth, cons,
                                                 wilcox_ref, rec)
    records["29"] = trace_out.pop("record")
    audit_launches, audit_out = phase_audit_full(data, truth, cons,
                                                 wilcox_ref)
    records["31"] = audit_out.pop("record")
    enforce_launches = phase_enforce_full(data, truth, cons, wilcox_ref,
                                          mesh_ref)
    probe_launches, _ = phase_probe_full(data, truth, cons, wilcox_ref)
    phase_contract(data, cons, csr)
    del csr
    torch.cuda.empty_cache()
    # phase 36's child runs while phase 35's three do
    passports = _passports_start(launcher)
    live_launches, _ = phase_live()
    passport_launches, records["36"], _ = phase_passports(
        launcher, passports, wilcox_ref, audit_out)
    gate_launches, _ = phase_gate(data, truth, cons, wilcox_ref, records,
                                  audit_out)
    del data, wilcox_ref, records
    torch.cuda.empty_cache()
    drift_launches, _ = phase_drift()
    phase_scale_small()
    tm_launches = phase_tm100k()
    torch.cuda.empty_cache()
    brec = phase_brain1m()
    torch.cuda.empty_cache()
    s1m_launches = phase_sparse_1m()
    torch.cuda.empty_cache()
    stream_small_launches = phase_stream_small()
    stream_20k_launches = phase_stream_20k()
    stream_1m_launches = phase_stream_scale(launcher)
    phase_soak_workers(launcher)
    zoo_small_launches = phase_zoo_small()
    zoo_full = phase_zoo_full(launcher)
    # phase 45's two children run while phase 41's do, and are collected
    # before the fleet's timed phases
    mesh2 = _mesh_procs_start()
    phase_zoo_soak(launcher)
    mesh2 = phase_mesh_procs(mesh2, mesh2_ref)
    del mesh2_ref
    # the fleet classifies with plain tensor code: its paths launch none
    from scconsensus_tpu_torch.ops.cuda_kernels import distance_cluster_sums

    distance_cluster_sums.launches = 0
    phase_fleet_small()
    fleet_small_launches = distance_cluster_sums.launches
    distance_cluster_sums.launches = 0
    phase_fleet_atlas()
    fleet_atlas_launches = distance_cluster_sums.launches
    phase_fleet_workers(launcher)
    by_path = {"wilcox_26k": rec["launches"],
               "edger_26k": erec["launches"],
               "wilcox_26k_csr": csr_launches,
               "edger_26k_csr": ecsr_launches,
               "bimod_26k": seurat_launches["bimod"],
               "t_26k": seurat_launches["t"],
               "roc_26k": seurat_launches["roc"],
               "wilcox_26k_stored": resume_launches["resume-store"],
               "wilcox_26k_resumed": resume_launches["resume"],
               "wilcox_26k_de_recomputed":
                   resume_launches["resume-corrupt-de"],
               "tm100k": tm_launches,
               "brain1m_sample": brec["launches"],
               "sparse_1m": s1m_launches,
               "serve_26k": serve_launches,
               "wilcox_26k_audit": (guarded_launches["guarded-audit-0"]
                                    + guarded_launches["guarded-audit-1"]),
               "wilcox_26k_faulted": guarded_launches["guarded-faults"],
               "wilcox_26k_enforce": guarded_launches["guarded-enforce"],
               "wilcox_26k_killed_resumed":
                   guarded_launches["guarded-resume"],
               "mesh_26k": mesh_ref["launches"],
               "elastic_26k": sum(elastic_launches.values()),
               "stream_small": stream_small_launches,
               "stream_20k": stream_20k_launches,
               "stream_1m": stream_1m_launches,
               "trace_26k": trace_launches,
               "wilcox_26k_residency_audit": audit_launches,
               "wilcox_26k_residency_enforce": enforce_launches,
               "wilcox_26k_probe": probe_launches,
               "wilcox_26k_live": live_launches,
               "wilcox_26k_passports": passport_launches,
               "wilcox_26k_passport_audit": gate_launches,
               "drift_reference_card": drift_launches,
               "zoo_smoke_card": zoo_small_launches,
               **{f"zoo_{name}": rec["launches"]
                  for name, rec in zoo_full.items()},
               "fleet_small": fleet_small_launches,
               "fleet_atlas_query": fleet_atlas_launches,
               "mesh_26k_2proc": mesh2["launches"]["mesh"],
               "mesh_auto_26k_2proc": mesh2["launches"]["auto"],
               "elastic_26k_2proc": mesh2["launches"]["loss"]}
    comp = compilelog.snapshot()
    log("[compile] this process's compile log: " + json.dumps(comp))
    if comp["cache_hits"] < 2 or comp["compiles"] > 2:
        raise AssertionError(f"[compile] {comp}")
    log("[phase-walls] " + json.dumps(phase_walls))
    log(f"[total] every phase in {time.perf_counter() - t_start!r} s")
    # times from the Wilcoxon path's inputs; launches from every full path
    # (serving and the fleet classify with plain tensor code: no launch)
    log(json.dumps({"kernels": [{
        "name": "distance_cluster_sums",
        "route": "cuda",
        "source": "scconsensus_tpu_torch/csrc/distance_cluster_sums.cu",
        "replaces": "scconsensus_tpu/ops/pallas_kernels.py:51",
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": rec["max_abs_err"],
        "ms": rec["ms"],
        "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"],
        "library_ms": rec["library_ms"],
        "profiler_ms": trace_out["sweep_profiler_ms"],
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": env["name"], "count": env["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
