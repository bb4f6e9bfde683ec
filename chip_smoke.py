#!/usr/bin/env python3
"""Drive the PyTorch/H100 port of scconsensus_tpu on one CUDA card.

Run from the repository root with ``python3 chip_smoke.py``. It needs one
card and no network, builds everything it runs from the sources in the
checkout, and exits non-zero on the first phase that fails:

  1. environment: torch / CUDA versions, the card's name and power limit;
  2. build: the CUDA kernel (nvcc, sm_90a) and the native Ward library,
     both compiles started together;
  3. kernel: ``distance_cluster_sums`` against its plain PyTorch version
     at four shapes (flagship-like, ragged, skinny, wide), with times and
     bound;
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
     branch and the pooled silhouette, which launches no kernel;
 11. the 1M landmark tree: the reference bench's 1,000,000 × 15 planted
     embedding, ``landmark_ward_linkage``, the weighted cut propagated to
     the cells, and the silhouette of a seeded 50,000-cell sample through
     the kernel, then the kernel at that sample's inputs.

The line before the last is a JSON object describing every kernel of the
path; the last line is ``{"ok": true, "device": {...}}``. Every phase runs
on every call.
"""

from __future__ import annotations

import json
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
    cluster ids (N, C), K clusters): error, times, bound and the cdist
    yardstick. Fails on disagreement."""
    import torch

    from scconsensus_tpu_torch.ops.cuda_kernels import (
        distance_cluster_sums,
        distance_cluster_sums_reference,
        labels_onehot,
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
    # (N, d, K, cuts): one cut of K = 100 at the flagship N; K split over
    # three cuts with ragged tiles; a skinny d and K; a wide d and a K
    # past one block's cluster slice
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


def _card_against_cpu(tag: str, cfg, run):
    """2,000 cells × 800 genes × 4 clusters (the reference bench's reduced
    flagship): ``run(data, cons, device, omega)`` on the card against the
    same on the CPU, with the same PCA projection handed to both. Checks
    the union, ARI = 1 and silhouettes per deepSplit; returns both
    results."""
    import torch

    from scconsensus_tpu_torch.de.engine import de_gene_union, pairwise_de
    from scconsensus_tpu_torch.utils.synthetic import synthetic_scrna

    n_cells, n_genes, n_clusters = 2000, 800, 4
    data, truth, _ = synthetic_scrna(
        n_genes=n_genes, n_cells=n_cells, n_clusters=n_clusters,
        n_markers_per_cluster=min(40, n_genes // n_clusters), seed=7)
    cons = _consensus_labels(truth, n_clusters)
    f = de_gene_union(pairwise_de(data, cons, cfg, device="cuda"),
                      cfg.n_top_de_genes).size
    k = min(cfg.n_pcs + 10, f, n_cells)
    omega = torch.randn((f, k), generator=torch.Generator().manual_seed(0))
    t0 = time.perf_counter()
    gpu = run(data, cons, "cuda", omega)
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = run(data, cons, "cpu", omega)
    t_cpu = time.perf_counter() - t0
    log(f"[{tag}] refine walls: cuda {t_gpu!r} s, cpu {t_cpu!r} s; "
        f"union {gpu.de_gene_union_idx.size}")
    if not np.array_equal(gpu.de_gene_union_idx, cpu.de_gene_union_idx):
        raise AssertionError(f"[{tag}] card and CPU unions differ")
    for g_info, c_info in zip(gpu.deep_split_info, cpu.deep_split_info):
        key = f"deepsplit: {g_info['deep_split']}"
        ari = _ari(gpu.dynamic_labels[key], cpu.dynamic_labels[key])
        dsil = abs(g_info["silhouette"] - c_info["silhouette"])
        log(f"[{tag}] {key}: clusters {g_info['n_clusters']} "
            f"silhouette {g_info['silhouette']!r} ARI(card, cpu) {ari!r} "
            f"|dsil| {dsil!r}")
        if ari != 1.0:
            raise AssertionError(f"[{tag}] {key}: ARI {ari} != 1")
        # fp32 sums over 2,000 distances in another order on each side
        if not dsil <= 1e-4:
            raise AssertionError(f"[{tag}] {key}: silhouettes differ {dsil}")
    return gpu, cpu


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
EDGER_KW = dict(method="edgeR", q_val_thrs=0.01, fc_thrs=2.0,
                mean_scaling_factor=2.0)


def phase_small_edger() -> None:
    """The edgeR slow path at the headline's thresholds, card against CPU:
    besides the checks of phase 4, identical DE masks and finite log p
    within the CPU tests' tolerance."""
    import math

    from scconsensus_tpu_torch import ReclusterConfig, recluster_de_consensus

    cfg = ReclusterConfig(method="edger", q_val_thrs=0.01,
                          log_fc_thrs=math.log(2.0), mean_scaling_factor=2.0)
    gpu, cpu = _card_against_cpu(
        "edger-small", cfg, lambda data, cons, dev, omega:
        recluster_de_consensus(data, cons, device=dev, omega=omega,
                               **EDGER_KW))
    gd, cd = gpu.de, cpu.de
    lp_g, lp_c = gd.log_p.cpu().numpy(), cd.log_p.numpy()
    fin = np.isfinite(lp_c)
    errs = np.abs(lp_g[fin] - lp_c[fin])
    n_out = int((errs > EDGER_LOGP_ATOL).sum())
    cg = gd.aux["common_dispersion"].cpu().numpy()
    cc = cd.aux["common_dispersion"].numpy()
    log(f"[edger-small] DE calls {int(gd.de_mask.sum())} / "
        f"{int(cd.de_mask.sum())}; |dlog p| 99.9th percentile "
        f"{float(np.quantile(errs, 1.0 - EDGER_ROUNDING_SHARE))!r}, max "
        f"{float(errs.max())!r}, {n_out} of {errs.size} above "
        f"{EDGER_LOGP_ATOL}; common dispersion max |card / cpu - 1| "
        f"{float(np.max(np.abs(cg / cc - 1.0)))!r}")
    if not np.array_equal(gd.de_mask.cpu().numpy(), cd.de_mask.numpy()):
        raise AssertionError("[edger-small] card and CPU DE masks differ")
    if not np.array_equal(np.isfinite(lp_g), fin) or \
            n_out > EDGER_ROUNDING_SHARE * errs.size:
        raise AssertionError(f"[edger-small] {n_out} log p differ by more "
                             f"than {EDGER_LOGP_ATOL}")
    if not np.isfinite(cg).all():
        raise AssertionError("[edger-small] a common dispersion is not "
                             "finite")


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


def _run_full(tag: str, call, truth, min_launches: int = 1):
    """One full-size refine with the kernel count reset just before and
    read just after; checks what every path must give (at least
    ``min_launches`` kernel launches)."""
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
    if m["tree_engine"] != "native":
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
    return rec


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
    return rec


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
        gpu, cpu = _card_against_cpu(
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "scconsensus_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(scconsensus_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)

    env = phase_env()
    phase_build()
    phase_kernel()
    phase_small()
    phase_small_edger()
    data, truth, cons = phase_full_data()
    rec = phase_full(data, truth, cons)
    erec = phase_edger_full(data, truth, cons)
    del data
    torch.cuda.empty_cache()
    phase_scale_small()
    tm_launches = phase_tm100k()
    torch.cuda.empty_cache()
    brec = phase_brain1m()
    # times from the Wilcoxon path's inputs; launches from every full path
    log(json.dumps({"kernels": [{
        "name": "distance_cluster_sums",
        "route": "cuda",
        "source": "scconsensus_tpu_torch/csrc/distance_cluster_sums.cu",
        "replaces": "scconsensus_tpu/ops/pallas_kernels.py:51",
        "launches": (rec["launches"] + erec["launches"] + tm_launches
                     + brec["launches"]),
        "launches_by_path": {"wilcox_26k": rec["launches"],
                             "edger_26k": erec["launches"],
                             "tm100k": tm_launches,
                             "brain1m_sample": brec["launches"]},
        "max_abs_err": rec["max_abs_err"],
        "ms": rec["ms"],
        "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"],
        "library_ms": rec["library_ms"],
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": env["name"], "count": env["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
