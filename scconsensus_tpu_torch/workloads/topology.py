"""Topology-based input clusterer: a small Two-Tier-Mapper-style
cover-and-cluster labeler (arXiv:1801.01841 flavor).

The port of ``scconsensus_tpu/workloads/topology.py``. The consensus
layer's premise is combining two *different* labelings of the same
cells; this module supplies one derived from data *topology* rather than
a truth perturbation:

  1. **cover** — greedy farthest-point cover centers over the embedding
     (deterministic given the seed), every cell a member of its two
     nearest covers (an overlapping cover — the Mapper pullback);
  2. **local clustering** — inside each cover element, a masked
     two-means split, all covers at once over an (L, N) membership mask
     (the reference maps one cover at a time with ``vmap``), so a cover
     patch straddling two arms of the data separates them locally;
  3. **nerve merge** — local clusters become nodes; a cell's
     (primary-cover node, secondary-cover node) pair is an edge, edges
     with at least ``min_overlap`` supporting cells survive, and
     connected components of that nerve are the final clusters.

The device pieces are plain tensor code on ``device`` over
``ops.distance.sq_dists`` (the reference's ``_sq_dists_raw`` form,
‖a‖² + ‖b‖² − 2·a·bᵀ clamped at 0), with the reference's first-index
argmin/argmax; the reference runs them as XLA programs, not Pallas. Only
the O(N) node ids cross to the host (the declared ``workload_inputs``
boundary) for the tiny union-find. The result is a pure function of
``(x, n_covers, seed, min_overlap, overlap)``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["topology_cluster", "topology_labeling"]


def farthest_point(x, start: int, n_covers: int):
    """Greedy farthest-point cover-center indices (n_covers,) on x's
    device: each next center is the cell farthest from every center so
    far (first index on a tie). No host sync inside the sweep."""
    import torch

    n = x.shape[0]
    idx = [torch.full((1,), int(start), dtype=torch.long, device=x.device)]
    mind = torch.full((n,), float("inf"), dtype=x.dtype, device=x.device)
    for _ in range(1, n_covers):
        c = torch.index_select(x, 0, idx[-1])          # (1, d)
        d = torch.sum((x - c) ** 2, dim=1)
        mind = torch.minimum(mind, d)
        idx.append(torch.argmax(mind).reshape(1))
    return torch.cat(idx)


def top2_covers(x, centers):
    """Primary/secondary cover of every cell + both squared distances."""
    import torch

    from scconsensus_tpu_torch.ops.distance import sq_dists

    d2 = sq_dists(x, centers)                          # (N, L)
    p = torch.argmin(d2, dim=1)
    dp = torch.gather(d2, 1, p[:, None])[:, 0]
    d2s = d2.scatter(1, p[:, None], float("inf"))
    s = torch.argmin(d2s, dim=1)
    ds = torch.gather(d2s, 1, s[:, None])[:, 0]
    return p, s, dp, ds


def _nearest_of_two(x, c):
    """(L, N) the nearer of each cover's two centers c (L, 2, d) for every
    cell, from one ``sq_dists`` tile against all 2·L centers."""
    import torch

    from scconsensus_tpu_torch.ops.distance import sq_dists

    n_cov, _, dim = c.shape
    d = sq_dists(x, c.reshape(2 * n_cov, dim)).reshape(-1, n_cov, 2)
    return torch.argmin(d, dim=2).T


def local_two_means(x, member_mask, centers, n_iter: int):
    """Per-cover masked two-means: (L, N) local id in {0, 1}.
    Deterministic init — the member farthest from the cover center,
    then the member farthest from that one."""
    import torch

    inside = member_mask > 0                           # (L, N)
    d0 = torch.sum((x[None, :, :] - centers[:, None, :]) ** 2, dim=2)
    a = torch.argmax(torch.where(inside, d0, -1.0), dim=1)
    xa = x[a]                                          # (L, d)
    da = torch.sum((x[None, :, :] - xa[:, None, :]) ** 2, dim=2)
    b = torch.argmax(torch.where(inside, da, -1.0), dim=1)
    c = torch.stack([xa, x[b]], dim=1)                 # (L, 2, d)
    for _ in range(n_iter):
        assign = _nearest_of_two(x, c)                 # (L, N)
        oh = (torch.nn.functional.one_hot(assign, 2).to(x.dtype)
              * member_mask[:, :, None])               # (L, N, 2)
        cnt = torch.sum(oh, dim=1)                     # (L, 2)
        sums = oh.transpose(1, 2) @ x                  # (L, 2, d)
        c = torch.where(cnt[:, :, None] > 0,
                        sums / torch.clamp(cnt, min=1.0)[:, :, None], c)
    return _nearest_of_two(x, c)


class _UnionFind:
    def __init__(self, n: int):
        self.parent = list(range(n))

    def find(self, i: int) -> int:
        while self.parent[i] != i:
            self.parent[i] = self.parent[self.parent[i]]
            i = self.parent[i]
        return i

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[max(ra, rb)] = min(ra, rb)


def topology_cluster(
    x: np.ndarray,
    n_covers: int = 16,
    seed: int = 0,
    min_overlap: Optional[int] = None,
    overlap: float = 1.5,
    local_iters: int = 8,
    prefix: str = "topo",
    device=None,
) -> np.ndarray:
    """Cluster the rows of ``x`` (N, d) by cover → local split → nerve.

    ``min_overlap`` is the cell-support an edge of the nerve needs to
    survive (default ``max(3, N // (50 * n_covers))`` — scale-free
    enough that smoke and full shapes use the same recipe);
    ``overlap`` gates which cells count as genuinely shared between
    their two covers (secondary distance within ``overlap ×`` primary).
    Returns string labels ``f"{prefix}{component}"``, a pure function
    of the inputs. ``device``: the card by default, ``"cpu"`` on
    request.
    """
    import torch

    from scconsensus_tpu_torch.device import as_points
    from scconsensus_tpu_torch.obs.residency import boundary

    n = int(x.shape[0])
    n_covers = int(min(n_covers, max(2, n // 4)))
    if min_overlap is None:
        min_overlap = max(3, n // (50 * n_covers))
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x7090]))
    start = int(rng.integers(0, n))

    with boundary("workload_inputs"):
        xd = as_points(x, device)
        cid = farthest_point(xd, start, n_covers)
        centers = xd[cid]
        p, s, dp, ds = top2_covers(xd, centers)
        # membership: primary always; secondary only when the cell is
        # genuinely shared (distance ratio inside the overlap gate)
        shared = torch.sqrt(ds) <= overlap * torch.sqrt(
            torch.clamp(dp, min=1e-12))
        covers = torch.arange(n_covers, device=xd.device)
        mask = ((p[None, :] == covers[:, None])
                | ((s[None, :] == covers[:, None]) & shared[None, :])
                ).to(xd.dtype)                            # (L, N)
        local = local_two_means(xd, mask, centers, local_iters)
        # O(N) int fetches: node ids + the shared gate — the only host
        # crossings this labeler makes
        p_h, s_h, shared_h, local_h = (
            t.cpu().numpy() for t in (p, s, shared, local))

    p_h = np.asarray(p_h, np.int64)
    s_h = np.asarray(s_h, np.int64)
    local_h = np.asarray(local_h, np.int64)
    node_p = 2 * p_h + local_h[p_h, np.arange(n)]
    node_s = 2 * s_h + local_h[s_h, np.arange(n)]

    # nerve: count supporting cells per (node_p, node_s) edge among the
    # genuinely shared cells, keep edges with enough support
    sh = np.asarray(shared_h, bool)
    edge_key = node_p[sh] * (2 * n_covers) + node_s[sh]
    keys, counts = np.unique(edge_key, return_counts=True)
    uf = _UnionFind(2 * n_covers)
    for key, c in zip(keys.tolist(), counts.tolist()):
        if c >= min_overlap:
            uf.union(key // (2 * n_covers), key % (2 * n_covers))

    roots = np.array([uf.find(i) for i in range(2 * n_covers)])
    # deterministic component ids: order of first appearance by node id
    uniq = sorted(set(roots[node_p].tolist()))
    remap = {r: i for i, r in enumerate(uniq)}
    comp = np.array([remap[r] for r in roots[node_p]])
    return np.array([f"{prefix}{c}" for c in comp])


def topology_labeling(
    data: np.ndarray,
    n_pcs: int = 10,
    n_covers: int = 16,
    seed: int = 0,
    prefix: str = "topo",
    omega=None,
    device=None,
    **kw,
) -> np.ndarray:
    """Topology labeling straight from a (G, N) expression matrix: the
    shared rSVD-PCA embed (``workloads.common.pca_embed`` — the same
    ``ops.pca`` path the pipeline uses; ``omega`` as there), then
    :func:`topology_cluster` over the embedding. Scenario runners that
    need the embedding for anything else (the replay pin) call the two
    pieces themselves."""
    from scconsensus_tpu_torch.workloads.common import pca_embed

    if hasattr(data, "toarray"):    # scipy sparse input
        data = data.toarray()
    emb = pca_embed(data, n_pcs, seed=seed, omega=omega, device=device)
    return topology_cluster(emb, n_covers=n_covers, seed=seed,
                            prefix=prefix, device=device, **kw)
