"""Special functions torch lacks, and the reference's float32 log-p flush.

``betainc`` is the regularized incomplete beta I_x(a, b) as plain tensor
code: torch has no ``betainc``. It follows the algorithm of JAX 0.9.0's
``regularized_incomplete_beta_impl`` (``jax/_src/lax/special.py``, itself
XLA's ``math.cc``) step for step: the continued fraction of DLMF 8.17.E23
evaluated by the Lentz–Thompson–Barnett recurrence, with the symmetry
switch I_x(a, b) = 1 − I_{1−x}(b, a) where x ≥ (a+1)/(a+b+2), and the same
edge cases (a or b zero or infinite, x at 0 or 1, NaN, out-of-range
arguments). As in XLA the recurrence runs until *every* element has
converged (or 200 iterations), updating all of them each step,
so a result does not depend on where a value sits in its batch relative to
the reference.

``flush_log`` is the log-p of the Seurat tests as the reference computes
it on its CPU and TPU backends; see its docstring.

Every function runs where its tensors lie.
"""

from __future__ import annotations

import torch

from scconsensus_tpu_torch.obs import residency

__all__ = ["FLT_MIN", "betainc", "flush_log"]

# the smallest normal float32; also the floor of ops/negbin.py's _log_tail
FLT_MIN = float(torch.finfo(torch.float32).tiny)


def flush_log(p: torch.Tensor) -> torch.Tensor:
    """log p, with −inf wherever p < FLT_MIN (NaN stays NaN).

    The reference takes ``jnp.log(jnp.maximum(p, 1e-38))``
    (``scconsensus_tpu/ops/seurat_tests.py:87,127,157,185``). 1e-38 is a
    float32 subnormal, and XLA flushes subnormals to zero, so there every
    p below FLT_MIN comes out as log 0 = −inf (BH then masks the entry and
    it is never called DE). Torch keeps subnormals, so the flush is spelled
    out here to give the reference's −inf positions."""
    return torch.where(p < FLT_MIN, float("-inf"), torch.log(p))


def _partial_numerator(it: int, a, b, x):
    """The it-th partial numerator of DLMF 8.17.E23 (1 for it = 1), in the
    reference's evaluation order."""
    if it == 1:
        return torch.ones_like(x)
    m = float((it - 1) // 2)
    if it % 2 == 0:
        if m == 0:
            # XLA's zero_numerator: avoids inaccuracy at tiny a under FTZ
            return -(a + b) * x / (a + 1.0)
        return -(a + m) * (a + b + m) * x / (
            (a + 2.0 * m) * (a + 2.0 * m + 1.0))
    return m * (b - m) * x / ((a + 2.0 * m - 1.0) * (a + 2.0 * m))


def _lentz(a, b, x, n_iter: int, small: float, threshold: float):
    """XLA's ``lentz_thompson_barnett_algorithm`` for the betainc fraction:
    partial denominators 0 (it = 0) then 1; iterate while any element's
    |delta − 1| ≥ threshold and fewer than ``n_iter`` steps were taken."""
    h = torch.full_like(x, small)      # |b_0| = 0 < small
    c = h
    d = torch.zeros_like(x)
    it = 1
    while it < n_iter:
        num = _partial_numerator(it, a, b, x)
        c = 1.0 + num / c
        c = torch.where(c.abs() < small, small, c)
        d = 1.0 + num * d
        d = torch.where(d.abs() < small, small, d)
        d = 1.0 / d
        delta = c * d
        h = h * delta
        it += 1
        # the host loop's convergence read, one scalar a step, declared
        # with the DE result's fetch
        with residency.boundary("de_result_fetch"):
            done = not bool(((delta - 1.0).abs() >= threshold).any())
        if done:
            break
    return h


def betainc(a, b, x) -> torch.Tensor:
    """Regularized incomplete beta I_x(a, b), elementwise over the
    broadcast of ``a``, ``b`` and ``x``, in float32 (the dtype of every
    p-value on the path)."""
    a, b, x = torch.broadcast_tensors(
        *(torch.as_tensor(v, dtype=torch.float32) for v in (a, b, x)))
    dtype = torch.float32
    fi = torch.finfo(dtype)
    inf = float("inf")
    a_is_zero = (a == 0) | (b == inf)
    b_is_zero = (b == 0) | (a == inf)
    x_is_zero = x == 0
    x_is_one = x == 1
    is_nan = torch.isnan(a) | torch.isnan(b) | torch.isnan(x)
    result_is_zero = (b_is_zero & ~x_is_one) | (a_is_zero & x_is_zero)
    result_is_one = (a_is_zero & ~x_is_zero) | (b_is_zero & x_is_one)
    result_is_nan = ((a < 0) | (b < 0) | (x < 0) | (x > 1)
                     | (a_is_zero & b_is_zero) | is_nan)

    # the fraction converges fast below (a+1)/(a+b+2) (DLMF 8.17.E23);
    # above it, the symmetry relation (DLMF 8.17.E4)
    fast = x < (a + 1.0) / (a + b + 2.0)
    a, b = torch.where(fast, a, b), torch.where(fast, b, a)
    x = torch.where(fast, x, 1.0 - x)

    # eps / 2, for both the floor and the tolerance
    half_eps = fi.eps / 2
    frac = _lentz(a, b, x, n_iter=200, small=half_eps, threshold=half_eps)

    # a·Γ(a) = Γ(a + 1) → 1 as a → 0+: the small-a prefactor avoids 0/0.
    # The log-beta terms are taken in float64: at large a, lgamma(a) and
    # lgamma(a + b) are ~1e4 and cancel to a few units, so in float32 each
    # one's last ulps (which differ between the CPU's and the card's
    # lgamma) would move log p by up to ~1e-2
    very_small = fi.tiny * 2
    a64, b64 = a.double(), b.double()
    lbeta_small_a = torch.lgamma(b64) - torch.lgamma(a64 + b64)
    lbeta = (torch.lgamma(a64) + lbeta_small_a).to(dtype)
    lbeta_small_a = lbeta_small_a.to(dtype)
    factor = torch.where(
        a < very_small,
        torch.exp(torch.log1p(-x) * b - lbeta_small_a),
        torch.exp(torch.log(x) * a + torch.log1p(-x) * b - lbeta) / a)
    # XLA flushes a subnormal result to zero on its CPU and TPU backends;
    # a prefactor below FLT_MIN is where a p-value under ~1e-38 is born,
    # so it is flushed here too, or frac > 1 would lift it back to normal
    factor = torch.where(factor.abs() < fi.tiny, 0.0, factor)
    result = frac * factor
    result = torch.where(fast, result, 1.0 - result)
    result = torch.where(result_is_zero, 0.0, result)
    result = torch.where(result_is_one, 1.0, result)
    return torch.where(result_is_nan, float("nan"), result)
