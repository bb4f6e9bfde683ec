"""The benchmark's input generator: one (G, N) matrix and two labelings
from a configuration, a traffic mix and ``--seed``.

The matrix model is a copy of the port's ``utils/synthetic.py``
``synthetic_scrna_device`` (negative-binomial counts as a gamma-Poisson
mixture around per-gene baselines, each planted cluster up-regulating its
own disjoint block of marker genes, then log1p(counts / libsize · depth)),
drawn on the card from a ``torch.Generator`` in blocks of genes. The two
labelings copy the reference bench's ``truth_perturb`` recipe: a
supervised labeling with a share of cells relabelled at random, and an
unsupervised one with a larger share relabelled after coarsening the
truth to fewer clusters.

One change from those copies keeps the work of a run the same from seed
to seed: the planted structure (cluster sizes, per-gene baselines, the
coarsening map of the unsupervised labeling) comes from the configuration's fixed ``structure_seed``,
and ``--seed`` draws everything else (which cells belong to which
cluster, the counts, the relabelled cells). So every seed has the same
cluster sizes, genes and consensus-cluster count, in another order and
with other noise.

Nothing here imports the program: the benchmark makes the inputs and
hands the same to the program and to the reference.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

__all__ = ["structure", "make_inputs", "noisy_labeling", "rng_for"]


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy generator for one use of ``--seed``."""
    return np.random.default_rng([int(seed) & (2**64 - 1), int(stream)])


def structure(cfg: Dict, coarsen_by: int) -> Dict:
    """The planted structure of a configuration, fixed by its
    ``structure_seed``: cluster sizes (mildly imbalanced, every cluster
    populated, summing to ``n_cells``), per-gene baselines and the
    coarsening map of the unsupervised labeling."""
    n, k = int(cfg["n_cells"]), int(cfg["n_clusters"])
    g, m = int(cfg["n_genes"]), int(cfg["n_markers_per_cluster"])
    if k * m > g:
        raise ValueError(f"marker blocks overflow the gene space: {k} x {m} "
                         f"> {g}")
    rng = np.random.default_rng(int(cfg["structure_seed"]))
    w = rng.dirichlet(np.full(k, 1.0 / max(float(cfg["balance"]), 1e-3)))
    w = 0.5 * w + 0.5 / k
    w /= w.sum()
    sizes = np.floor(w * n).astype(np.int64)
    sizes[np.argsort(-(w * n - sizes))[: n - int(sizes.sum())]] += 1
    base = np.exp(rng.normal(loc=-1.0, scale=1.0, size=g))
    k_out = max(2, k - int(coarsen_by))
    merge_map = rng.integers(0, k_out, size=k)
    return {"sizes": sizes, "base": base, "merge_map": merge_map,
            "k_out": k_out}


def _gamma(alpha: float, shape, generator, device) -> torch.Tensor:
    """Gamma(alpha, 1) draws from ``generator`` alone (Marsaglia & Tsang
    2000), with the boost Gamma(alpha) = Gamma(alpha + 1) · U^(1/alpha)
    for alpha < 1."""
    a = alpha if alpha >= 1.0 else alpha + 1.0
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.empty(shape, dtype=torch.float32, device=device).view(-1)
    todo = torch.arange(out.numel(), device=device)
    while todo.numel():
        z = torch.randn(todo.numel(), generator=generator, device=device)
        u = torch.rand(todo.numel(), generator=generator, device=device)
        v = (1.0 + c * z) ** 3
        ok = (v > 0) & (
            torch.log(u) < 0.5 * z * z + d - d * v
            + d * torch.log(v.clamp_min(1e-30))
        )
        out[todo[ok]] = d * v[ok]
        todo = todo[~ok]
    if alpha < 1.0:
        u = torch.rand(out.numel(), generator=generator, device=device)
        out *= u ** (1.0 / alpha)
    return out.view(shape)


def _matrix(cfg: Dict, st: Dict, truth: np.ndarray, seed: int,
            device) -> torch.Tensor:
    """The (G, N) float32 log-normalized matrix on ``device``."""
    g, n = int(cfg["n_genes"]), int(cfg["n_cells"])
    k, m = int(cfg["n_clusters"]), int(cfg["n_markers_per_cluster"])
    depth = float(cfg["depth"])
    mask = np.zeros((g, k), np.float32)
    for c in range(k):
        mask[c * m:(c + 1) * m, c] = 1.0
    gen = torch.Generator(device=device).manual_seed(
        int(seed) & (2**63 - 1))
    lab = torch.as_tensor(truth, dtype=torch.int64, device=device)
    log_base = torch.as_tensor(np.log(st["base"]), dtype=torch.float32,
                               device=device)
    t_mask = torch.as_tensor(mask, device=device)
    fc = float(cfg["marker_log_fc"])
    b = min(2048, g)

    def mu_block(g0: int) -> torch.Tensor:
        return torch.exp(log_base[g0:g0 + b, None]
                         + fc * t_mask[g0:g0 + b][:, lab])

    colsum = torch.zeros(n, dtype=torch.float32, device=device)
    for g0 in range(0, g, b):
        colsum += mu_block(g0).sum(dim=0)
    scale = depth / colsum.clamp_min(1e-30)
    shape = 1.0 / float(cfg["nb_dispersion"])
    counts = torch.empty((g, n), dtype=torch.float32, device=device)
    for g0 in range(0, g, b):
        mu = mu_block(g0) * scale[None, :]
        lam = _gamma(shape, tuple(mu.shape), gen, device) * (mu / shape)
        counts[g0:g0 + b] = torch.poisson(lam, generator=gen)
        del mu, lam
    libsize = counts.sum(dim=0).clamp_min(1.0)
    counts.mul_((depth / libsize)[None, :]).log1p_()
    return counts


def noisy_labeling(truth: np.ndarray, flip_frac: float, k: int,
                   rng: np.random.Generator, prefix: str,
                   merge_map=None) -> np.ndarray:
    """A string labeling: the truth (through ``merge_map`` when given),
    with a ``flip_frac`` share of cells relabelled uniformly among ``k``
    labels."""
    lab = truth.copy() if merge_map is None else merge_map[truth]
    flip = rng.random(lab.shape[0]) < flip_frac
    lab[flip] = rng.integers(0, k, size=int(flip.sum()))
    return np.char.add(prefix, lab.astype(str))


def make_inputs(cfg: Dict, traffic: Dict, seed: int, device) -> Dict:
    """Everything a job takes, from ``--seed``: the matrix on ``device``
    and the supervised and unsupervised labelings."""
    st = structure(cfg, int(traffic["uns_coarsen_by"]))
    k = int(cfg["n_clusters"])
    truth = np.repeat(np.arange(k), st["sizes"])
    rng_for(seed, 1).shuffle(truth)
    data = _matrix(cfg, st, truth, seed, device)
    sup = noisy_labeling(truth, float(traffic["sup_flip"]), k,
                         rng_for(seed, 2), "sup")
    uns = noisy_labeling(truth, float(traffic["uns_flip"]), st["k_out"],
                         rng_for(seed, 3), "uns", merge_map=st["merge_map"])
    return {"data": data, "sup": sup, "uns": uns}
