"""Truncated PCA via randomized subspace iteration (matrix products + QR).

The torch form of ``scconsensus_tpu/ops/pca.py`` ``_subspace_basis`` and
``pca_scores`` (:25-67), replacing ``irlba::prcomp_irlba(x, n, center=TRUE,
scale.=FALSE)`` (R/reclusterDEConsensus.R:234). Component signs are
arbitrary, as with irlba; euclidean distances and Ward are sign-invariant.

``omega`` (F, k) replaces the port's own draw of the random projection.
The reference draws it from ``jax.random.PRNGKey(seed)``, which torch
cannot reproduce; ``carry.omega_from_reference`` hands that draw over.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from scconsensus_tpu_torch.device import resolve_device

__all__ = ["pca_scores"]

_N_OVERSAMPLE = 10  # extra subspace columns beyond n_components
_N_ITER = 4         # power iterations


def _subspace_basis(x: torch.Tensor, n_components: int, seed: int,
                    omega: Optional[torch.Tensor]):
    """(vt (n_components, F), centered x)."""
    n, f = x.shape
    k = min(n_components + _N_OVERSAMPLE, f, n)
    mean = torch.mean(x, dim=0)
    xc = x - mean[None, :]
    if omega is None:
        gen = torch.Generator(device=x.device).manual_seed(int(seed))
        omega = torch.randn((f, k), generator=gen, device=x.device,
                            dtype=x.dtype)
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
    return vt[:n_components], xc


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
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
            resolve_device(device))
    elif device is not None:
        x = x.to(device=resolve_device(device), dtype=torch.float32)
    vt, xc = _subspace_basis(x, n_components, seed, omega)
    return xc @ vt.T
