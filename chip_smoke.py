#!/usr/bin/env python3
"""Drive the PyTorch/H100 port of scconsensus_tpu on one CUDA card.

Run from the repository root with ``python3 chip_smoke.py``. It needs one
card and no network, builds everything it runs from the sources in the
checkout, and exits non-zero on the first phase that fails:

  1. environment: torch / CUDA versions, the card's name and power limit;
  2. build: the CUDA kernel (nvcc, sm_90a) and the native Ward library,
     both compiles started together;
  3. kernel: ``distance_cluster_sums`` against its plain PyTorch version
     at three shapes (flagship-like, ragged, skinny), with times and bound;
  4. slice, card against CPU: the dense fast-Wilcoxon ``refine()`` at
     2,000 cells × 800 genes × 4 clusters on ``cuda`` and on the CPU;
  5. slice at full size: ``recluster_de_consensus_fast`` at 26,000 cells ×
     15,000 genes × 22 planted clusters, data drawn on the card, with the
     kernel's launch count reset just before and read just after.

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
    """Adjusted Rand index of two labelings (numpy, no extra packages)."""
    _, ai = np.unique(np.asarray(a), return_inverse=True)
    _, bi = np.unique(np.asarray(b), return_inverse=True)
    table = np.zeros((ai.max() + 1, bi.max() + 1), np.int64)
    np.add.at(table, (ai, bi), 1)

    def pairs(v):
        return float((v * (v - 1) // 2).sum())

    total = pairs(np.array([ai.size]))
    sum_ij = pairs(table)
    sum_a = pairs(table.sum(axis=1))
    sum_b = pairs(table.sum(axis=0))
    expected = sum_a * sum_b / total
    max_idx = 0.5 * (sum_a + sum_b)
    if max_idx == expected:
        return 1.0
    return (sum_ij - expected) / (max_idx - expected)


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


def phase_small() -> None:
    """2,000 cells × 800 genes × 4 clusters (the reference bench's reduced
    flagship): the port on the card against the port on the CPU, with the
    same PCA projection handed to both."""
    import torch

    from scconsensus_tpu_torch import ReclusterConfig, refine
    from scconsensus_tpu_torch.de.engine import de_gene_union, pairwise_de
    from scconsensus_tpu_torch.utils.synthetic import synthetic_scrna

    n_cells, n_genes, n_clusters = 2000, 800, 4
    data, truth, _ = synthetic_scrna(
        n_genes=n_genes, n_cells=n_cells, n_clusters=n_clusters,
        n_markers_per_cluster=min(40, n_genes // n_clusters), seed=7)
    cons = _consensus_labels(truth, n_clusters)
    cfg = ReclusterConfig()
    f = de_gene_union(pairwise_de(data, cons, cfg, device="cuda"),
                      cfg.n_top_de_genes).size
    k = min(cfg.n_pcs + 10, f, n_cells)
    omega = torch.randn((f, k), generator=torch.Generator().manual_seed(0))
    t0 = time.perf_counter()
    gpu = refine(data, cons, cfg, device="cuda", omega=omega)
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = refine(data, cons, cfg, device="cpu", omega=omega)
    t_cpu = time.perf_counter() - t0
    log(f"[small] refine walls: cuda {t_gpu!r} s, cpu {t_cpu!r} s; "
        f"union {gpu.de_gene_union_idx.size}")
    if not np.array_equal(gpu.de_gene_union_idx, cpu.de_gene_union_idx):
        raise AssertionError("[small] card and CPU unions differ")
    for g_info, c_info in zip(gpu.deep_split_info, cpu.deep_split_info):
        key = f"deepsplit: {g_info['deep_split']}"
        ari = _ari(gpu.dynamic_labels[key], cpu.dynamic_labels[key])
        dsil = abs(g_info["silhouette"] - c_info["silhouette"])
        log(f"[small] {key}: clusters {g_info['n_clusters']} "
            f"silhouette {g_info['silhouette']!r} ARI(card, cpu) {ari!r} "
            f"|dsil| {dsil!r}")
        if ari != 1.0:
            raise AssertionError(f"[small] {key}: ARI {ari} != 1")
        # fp32 sums over 2,000 distances in another order on each side
        if not dsil <= 1e-4:
            raise AssertionError(f"[small] {key}: silhouettes differ {dsil}")


def phase_full() -> dict:
    """The flagship slice on the card, with the kernel count reset just
    before the run and read just after."""
    import torch

    from scconsensus_tpu_torch import recluster_de_consensus_fast
    from scconsensus_tpu_torch.ops.cuda_kernels import distance_cluster_sums
    from scconsensus_tpu_torch.ops.silhouette import cut_labels
    from scconsensus_tpu_torch.utils.synthetic import synthetic_scrna_device

    n_cells, n_genes, n_clusters = 26000, 15000, 22
    t0 = time.perf_counter()
    data, truth, _ = synthetic_scrna_device(
        n_genes=n_genes, n_cells=n_cells, n_clusters=n_clusters,
        n_markers_per_cluster=min(40, n_genes // n_clusters), seed=7,
        device="cuda")
    cons = _consensus_labels(truth, n_clusters)
    torch.cuda.synchronize()
    log(f"[full] data {tuple(data.shape)} drawn on the card in "
        f"{time.perf_counter() - t0!r} s; nnz fraction "
        f"{float((data > 0).float().mean())!r}; consensus clusters "
        f"{np.unique(cons).size}")

    torch.cuda.reset_peak_memory_stats()
    distance_cluster_sums.launches = 0
    t0 = time.perf_counter()
    res = recluster_de_consensus_fast(data, cons, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = distance_cluster_sums.launches
    m = res.metrics
    log(f"[full] refine wall {wall!r} s, peak device memory "
        f"{torch.cuda.max_memory_allocated()} bytes")
    log("[full] stage walls (s): " + json.dumps(m["stage_walls_s"]))
    log(f"[full] union {m['union_size']} genes; tree engine "
        f"{m['tree_engine']}; distance_cluster_sums launches {launches}")
    for info in res.deep_split_info:
        key = f"deepsplit: {info['deep_split']}"
        log(f"[full] {key}: clusters {info['n_clusters']} silhouette "
            f"{info['silhouette']!r} ARI(planted) "
            f"{_ari(res.dynamic_labels[key], truth)!r}")
    if launches < 1:
        raise AssertionError("[full] the silhouette stage did not launch "
                             "the CUDA kernel")
    if m["tree_engine"] != "native":
        raise AssertionError(f"[full] Ward ran on {m['tree_engine']}")
    if res.embedding.shape != (n_cells, min(m["union_size"], 15)) or \
            not np.isfinite(res.embedding).all():
        raise AssertionError("[full] embedding is not finite or mis-shaped")
    if not all(np.isfinite(i["silhouette"]) for i in res.deep_split_info):
        raise AssertionError("[full] a silhouette is not finite")
    if res.nodg.shape != (n_cells,):
        raise AssertionError("[full] nodg is mis-shaped")

    # the kernel at the inputs the main path gave it
    labs = [np.where(res.dynamic_labels[f"deepsplit: {i['deep_split']}"] > 0,
                     res.dynamic_labels[f"deepsplit: {i['deep_split']}"], -1)
            for i in res.deep_split_info]
    ids, k_total, _ = cut_labels(labs)
    x = torch.from_numpy(res.embedding).cuda().contiguous()
    rec = _measure_kernel(x, torch.from_numpy(ids).cuda(), k_total,
                          "main-path")
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
    rec = phase_full()
    log(json.dumps({"kernels": [{
        "name": "distance_cluster_sums",
        "route": "cuda",
        "source": "scconsensus_tpu_torch/csrc/distance_cluster_sums.cu",
        "replaces": "scconsensus_tpu/ops/pallas_kernels.py:51",
        "launches": rec["launches"],
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
