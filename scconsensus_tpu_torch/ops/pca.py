"""Truncated PCA via randomized subspace iteration (matrix products + QR).

The torch form of ``scconsensus_tpu/ops/pca.py`` ``_subspace_basis``,
``pca_scores``, ``pca_scores_audited`` and ``pca_basis`` (:25-119),
replacing ``irlba::prcomp_irlba(x, n, center=TRUE,
scale.=FALSE)`` (R/reclusterDEConsensus.R:234). Component signs are
arbitrary, as with irlba; euclidean distances and Ward are sign-invariant.

``omega`` (F, k) replaces the port's own draw of the random projection.
The reference draws it from ``jax.random.PRNGKey(seed)``, which torch
cannot reproduce; ``carry.omega_from_reference`` hands that draw over.
The port's own draw comes from torch's CPU generator and is then moved
to the data's device, so a run on the card and a run on the CPU project
through the same matrix (the card's generator draws other numbers).

Graph passports (``obs.graphs``, ``SCC_GRAPHS``) under the reference's
names (:122-125): ``embed.pca_scores``, ``embed.pca_scores_audited``,
``embed.pca_basis``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from scconsensus_tpu_torch.device import resolve_device
from scconsensus_tpu_torch.obs.graphs import instrument as _passport

__all__ = ["pca_scores", "pca_scores_audited", "pca_basis"]

_N_OVERSAMPLE = 10  # extra subspace columns beyond n_components
_N_ITER = 4         # power iterations


def _subspace_basis(x: torch.Tensor, n_components: int, seed: int,
                    omega: Optional[torch.Tensor]):
    """(mean (F,), vt (n_components, F), centered x): the one body behind
    both entry points, so a frozen model's basis reproduces the scores."""
    n, f = x.shape
    k = min(n_components + _N_OVERSAMPLE, f, n)
    mean = torch.mean(x, dim=0)
    xc = x - mean[None, :]
    if omega is None:
        gen = torch.Generator().manual_seed(int(seed))
        omega = torch.randn((f, k), generator=gen,
                            dtype=x.dtype).to(x.device)
    else:
        if tuple(omega.shape) != (f, k):
            raise ValueError(
                f"omega must be ({f}, {k}), got {tuple(omega.shape)}"
            )
        omega = omega.to(device=x.device, dtype=x.dtype)
    y = xc @ omega                       # (N, k)
    q, _ = torch.linalg.qr(y)
    for _ in range(_N_ITER):
        z = xc.T @ q                     # (F, k)
        w, _ = torch.linalg.qr(z)
        y = xc @ w                       # (N, k)
        q, _ = torch.linalg.qr(y)
    b = q.T @ xc                         # (k, F)
    _, _, vt = torch.linalg.svd(b, full_matrices=False)
    return mean, vt[:n_components], xc


def pca_scores(
    x: torch.Tensor,
    n_components: int,
    seed: int = 0,
    omega: Optional[torch.Tensor] = None,
    device=None,
) -> torch.Tensor:
    """Principal-component scores of the rows of ``x`` (N, F), centered
    per column: (N, n_components), matching ``prcomp_irlba(...)$x`` up to
    column signs. A tensor is used on its own device unless ``device``
    says otherwise; a numpy array goes to ``device`` ("cuda" by default).
    """
    _, vt, xc = _subspace_basis(_as_rows(x, device), n_components, seed,
                                omega)
    return xc @ vt.T


def pca_scores_audited(
    x: torch.Tensor,
    n_components: int,
    seed: int = 0,
    omega: Optional[torch.Tensor] = None,
    device=None,
):
    """:func:`pca_scores` plus what the integrity layer verifies, from the
    same subspace iteration and the same draw: ``(scores,
    ortho_residual, mean, components)``, where ``ortho_residual`` =
    ‖V·Vᵀ − I‖∞ of the basis (a device scalar) and ``mean`` /
    ``components`` feed the sampled float64 ghost replay of score rows.
    The scores are the bits :func:`pca_scores` gives; the extra work is
    one (k, k) gram."""
    mean, vt, xc = _subspace_basis(_as_rows(x, device), n_components, seed,
                                   omega)
    scores = xc @ vt.T
    g = vt @ vt.T
    resid = torch.max(torch.abs(
        g - torch.eye(g.shape[0], dtype=g.dtype, device=g.device)))
    return scores, resid, mean, vt


def pca_basis(
    x: torch.Tensor,
    n_components: int,
    seed: int = 0,
    omega: Optional[torch.Tensor] = None,
    device=None,
):
    """The explicit projection behind :func:`pca_scores`: ``(mean (F,),
    components (n_components, F))`` from the same subspace iteration, so
    ``(x - mean) @ components.T`` reproduces the scores. A frozen
    consensus model keeps it to project new cells into the space of its
    landmarks. Devices as :func:`pca_scores`."""
    mean, vt, _ = _subspace_basis(_as_rows(x, device), n_components, seed,
                                  omega)
    return mean, vt


def _as_rows(x, device) -> torch.Tensor:
    """``x`` as a float32 tensor: a tensor on its own device unless
    ``device`` says otherwise, a numpy array on ``device`` (the card by
    default)."""
    if not isinstance(x, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
            resolve_device(device))
    if device is not None:
        return x.to(device=resolve_device(device), dtype=torch.float32)
    return x


pca_scores = _passport("embed.pca_scores", pca_scores)
pca_scores_audited = _passport("embed.pca_scores_audited", pca_scores_audited)
pca_basis = _passport("embed.pca_basis", pca_basis)
