"""edgeR-style negative-binomial DE arithmetic, as PyTorch tensor code.

The torch form of ``scconsensus_tpu/ops/negbin.py``: the stable lgamma
difference, the qCML conditional likelihood, the NB quantile-to-quantile
maps (normal and gamma halves, the gamma quantile by Newton on the
regularized incomplete gamma), the common and tagwise dispersion argmax
grids with their quadratic refinement, and the NB exact test (exact
Beta-Binomial tails from cumulative log pmf-ratios below ``s_max``, a
moment-matched normal above).

Library names map one to one: ``gammaln`` → ``torch.lgamma``,
``gammainc`` → ``torch.special.gammainc``, ``ndtri`` →
``torch.special.ndtri``, ``norm.logcdf`` → ``torch.special.log_ndtr``.
The two libraries' float32 transcendentals differ in the last ulp, so
results agree with the reference to a tolerance, not bit for bit; the
grid constants, which pick the argmax grids, are bit-equal
(``TAGWISE_GRID_EXPONENTS``, ``delta_grid``).

Every function runs where its tensors lie, float32 throughout.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from scconsensus_tpu_torch.ops.special import FLT_MIN

__all__ = [
    "lgamma_shift",
    "nb_cond_log_lik",
    "one_group_nb_rate",
    "q2q_nbinom",
    "q2q_normal",
    "q2q_normal_raw",
    "q2q_gamma_raw",
    "equalize_pseudo",
    "delta_grid",
    "common_dispersion_grid",
    "tagwise_dispersion",
    "nb_exact_test_logp",
    "nb_exact_test_logp_normal",
    "DEFAULT_DELTA_GRID_SIZE",
    "TAGWISE_GRID_EXPONENTS",
]

DEFAULT_DELTA_GRID_SIZE = 64
_STIRLING_SWITCH = 30.0
_LOG2 = float(np.float32(np.log(2.0)))
_TINY = FLT_MIN  # shared with the Seurat tests' log-p flush


def _f32_bits(bits) -> np.ndarray:
    return np.array(bits, np.uint32).view(np.float32)


# estimateTagwiseDisp grid: dispersion = common * 2^linspace(-6, 6, 11).
# The reference takes float32 jnp.linspace, whose values differ from
# numpy's and torch's linspace in the last bits (0 comes out as 2^-23);
# an ulp here moves the argmax grid, so the values are kept bit for bit.
TAGWISE_GRID_EXPONENTS = _f32_bits([
    0xC0C00000, 0xC0999999, 0xC0666667, 0xC0199998, 0xBF99999A, 0x34000000,
    0x3F99999C, 0x4019999A, 0x40666668, 0x4099999A, 0x40C00000,
])

# δ = φ/(1+φ) on edgeR's optimize interval (1e-4, 100/101), log-spaced in
# φ: the float32 values of the reference's exp(jnp.linspace(log 1e-4,
# log 100, n)) / (1 + ...), bit for bit, for the sizes the port uses.
_DELTA_GRIDS = {
    24: _f32_bits([
        0x38D1B1B8, 0x393F2835, 0x39AE3F24, 0x3A1ED00F, 0x3A90B699,
        0x3B03CFBE, 0x3B6FF0E2, 0x3BDA172E, 0x3C45BE71, 0x3CB2810A,
        0x3D1FDE8F, 0x3D8D35F7, 0x3DF3A508, 0x3E4A4EE1, 0x3E9EA279,
        0x3EE674DF, 0x3F194AAD, 0x3F3B3522, 0x3F550F9F, 0x3F66854B,
        0x3F715E56, 0x3F77C34C, 0x3F7B6A73, 0x3F7D7721,
    ]),
    64: _f32_bits([
        0x38D1B1B8, 0x39028D54, 0x39228EDD, 0x394A68B9, 0x397C0708,
        0x399CE714, 0x39C35C45, 0x39F33D66, 0x3A176C76, 0x3A3C868A,
        0x3A6AB5CD, 0x3A921920, 0x3AB5DF0A, 0x3AE26382, 0x3B0CE3B6,
        0x3B2F57C3, 0x3B5A316D, 0x3B87BC6D, 0x3BA8D8AF, 0x3BD1FB61,
        0x3C02877E, 0x3C2237C3, 0x3C498100, 0x3C7A286A, 0x3C9B2ABF,
        0x3CC051FE, 0x3CEE1B24, 0x3D133208, 0x3D35AFB8, 0x3D5FCD20,
        0x3D897F0B, 0x3DA86FEA, 0x3DCD976B, 0x3DF9DA19, 0x3E170A12,
        0x3E35825B, 0x3E5899CB, 0x3E8034B6, 0x3E96682D, 0x3EAEB3D5,
        0x3EC8BE67, 0x3EE40ADB, 0x3F000001, 0x3F0DFA96, 0x3F1BA0CF,
        0x3F28A618, 0x3F34CBEC, 0x3F3FE5A7, 0x3F49D991, 0x3F529F6C,
        0x3F5A3D7E, 0x3F60C4BE, 0x3F664D14, 0x3F6AF204, 0x3F6ED020,
        0x3F72032F, 0x3F74A505, 0x3F76CCE0, 0x3F788F27, 0x3F79FD71,
        0x3F7B26AA, 0x3F7C175F, 0x3F7CD9FC, 0x3F7D7721,
    ]),
}


def delta_grid(n: int = DEFAULT_DELTA_GRID_SIZE) -> np.ndarray:
    """The (n,) float32 δ grid (host array): 24 points for the engine's
    qCML grid, 64 for the reference's default."""
    if n not in _DELTA_GRIDS:
        raise ValueError(f"delta grid size {n} is not tabulated "
                         f"(sizes: {sorted(_DELTA_GRIDS)})")
    return _DELTA_GRIDS[n].copy()


def _stirling_corr(x: torch.Tensor) -> torch.Tensor:
    """1/(12x) − 1/(360x³): first Stirling series corrections."""
    inv = 1.0 / x
    return inv / 12.0 - (inv * inv * inv) / 360.0


def lgamma_shift(y: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """lgamma(y + r) − lgamma(r), stable for large r: below r = 30 the
    plain difference, above it the Stirling form (r−½)·log1p(y/r) +
    y·log(r+y) − y + Δcorr, whose terms are all O(y·log r). y ≥ 0."""
    naive = torch.lgamma(y + r) - torch.lgamma(r)
    rs = torch.clamp(r, min=_STIRLING_SWITCH)  # keep the unused branch finite
    stirling = (
        (rs - 0.5) * torch.log1p(y / rs)
        + y * torch.log(rs + y)
        - y
        + _stirling_corr(rs + y)
        - _stirling_corr(rs)
    )
    return torch.where(r < _STIRLING_SWITCH, naive, stirling)


def nb_cond_log_lik(y: torch.Tensor, mask: torch.Tensor,
                    r: torch.Tensor) -> torch.Tensor:
    """Conditional log-likelihood of one group's counts given their sum,
    NB with common size r = 1/dispersion (Robinson & Smyth 2008 qCML):
    Σ_j [lgamma(y_j+r) − lgamma(r)] − [lgamma(z+nr) − lgamma(nr)].

    y, mask: (..., W); r broadcastable to the leading axes. Returns (...)."""
    ym = torch.where(mask, y, torch.zeros_like(y))
    z = ym.sum(dim=-1)
    n = mask.sum(dim=-1).to(torch.float32)
    per_obs = torch.where(mask, lgamma_shift(ym, r[..., None]),
                          torch.zeros_like(ym)).sum(dim=-1)
    return per_obs - lgamma_shift(z, n * r)


def one_group_nb_rate(y: torch.Tensor, lib: torch.Tensor, mask: torch.Tensor,
                      dispersion: torch.Tensor, n_iter: int = 8
                      ) -> torch.Tensor:
    """MLE of one group's per-library rate λ under NB with log link and
    library offsets (μ_j = λ·lib_j): Newton on log λ from the Poisson MLE.
    y/lib/mask: (..., W); dispersion broadcastable to (...). Returns λ."""
    zero = torch.zeros_like(y)
    ym = torch.where(mask, y, zero)
    libm = torch.where(mask, lib, zero)
    tot_y = ym.sum(dim=-1)
    tot_lib = torch.clamp(libm.sum(dim=-1), min=1e-30)
    beta = torch.log(torch.clamp(tot_y, min=1e-10) / tot_lib)
    r = (1.0 / torch.clamp(dispersion, min=1e-10))[..., None]
    for _ in range(n_iter):
        mu = torch.exp(beta)[..., None] * libm
        w = mu * (ym + r) / (mu + r)
        f = torch.where(mask, ym - w, zero).sum(dim=-1)
        df = -torch.where(mask, mu * r * (ym + r) / torch.square(mu + r),
                          zero).sum(dim=-1)
        step = torch.clamp(f / torch.clamp(df, max=-1e-12), -2.0, 2.0)
        beta = beta - step
    # all-zero groups have no signal: rate 0
    return torch.where(tot_y > 0, torch.exp(beta), torch.zeros_like(beta))


def _qgamma(p: torch.Tensor, shape: torch.Tensor, n_iter: int = 3
            ) -> torch.Tensor:
    """Gamma(shape, 1) quantile: Wilson–Hilferty start, then ``n_iter``
    clamped Newton steps on the regularized incomplete gamma (the
    reference's 3, which its docstring pins against scipy's gammaincinv).
    ``lgamma(shape)`` is loop-invariant and hoisted."""
    z = torch.special.ndtri(torch.clamp(p, 1e-7, 1.0 - 1e-7))
    c = 1.0 / (9.0 * torch.clamp(shape, min=1e-6))
    x = shape * (1.0 - c + z * torch.sqrt(c)) ** 3
    x = torch.clamp(x, min=1e-8)
    log_norm = torch.lgamma(shape)
    for _ in range(n_iter):
        f = torch.special.gammainc(shape, x) - p
        pdf = torch.exp((shape - 1.0) * torch.log(x) - x - log_norm)
        step = f / torch.clamp(pdf, min=1e-30)
        x = torch.clamp(x - torch.clamp(step, -0.5 * x, 0.5 * x + 1.0),
                        min=1e-10)
    return x


def _moments(mu_in, mu_out, dispersion):
    mu_in = torch.clamp(mu_in, min=1e-10)
    mu_out = torch.clamp(mu_out, min=1e-10)
    v_in = mu_in + dispersion * mu_in * mu_in
    v_out = mu_out + dispersion * mu_out * mu_out
    return mu_in, mu_out, v_in, v_out


def q2q_normal_raw(x: torch.Tensor, mu_in: torch.Tensor, mu_out: torch.Tensor,
                   dispersion) -> torch.Tensor:
    """Unclamped normal half of the NB quantile map (z-score transfer
    between the moment-matched normals)."""
    mu_in, mu_out, v_in, v_out = _moments(mu_in, mu_out, dispersion)
    return mu_out + (x - mu_in) * torch.sqrt(v_out / v_in)


def q2q_normal(x, mu_in, mu_out, dispersion) -> torch.Tensor:
    """Normal half of the NB quantile map, clamped at 0: the full-matrix
    equalization, whose values only enter group sums."""
    return torch.clamp(q2q_normal_raw(x, mu_in, mu_out, dispersion), min=0.0)


def q2q_gamma_raw(x: torch.Tensor, mu_in: torch.Tensor, mu_out: torch.Tensor,
                  dispersion) -> torch.Tensor:
    """Gamma half of the NB quantile map: moment-matched shapes, lower-tail
    quantile transfer. x ≤ 0 maps to exactly 0 (the gamma places no mass
    below 0), which lets the node table skip the ``gammainc`` chain on
    zero entries."""
    mu_in, mu_out, v_in, v_out = _moments(mu_in, mu_out, dispersion)
    shape_in = mu_in * mu_in / v_in
    scale_in = v_in / mu_in
    shape_out = mu_out * mu_out / v_out
    scale_out = v_out / mu_out
    p = torch.special.gammainc(shape_in, torch.clamp(x, min=0.0) / scale_in)
    q = _qgamma(p, shape_out) * scale_out
    return torch.where(x > 0, q, torch.zeros_like(q))


def q2q_nbinom(x, mu_in, mu_out, dispersion) -> torch.Tensor:
    """Quantile-to-quantile NB map: the average of the normal and gamma
    halves (the two-approximation average edgeR's quantile adjustment is
    built on), clamped at 0."""
    q = 0.5 * (q2q_normal_raw(x, mu_in, mu_out, dispersion)
               + q2q_gamma_raw(x, mu_in, mu_out, dispersion))
    return torch.clamp(q, min=0.0)


class PseudoCounts(NamedTuple):
    pseudo: torch.Tensor   # (..., W) equalized continuous counts
    rate1: torch.Tensor    # (...) group-1 rate λ
    rate2: torch.Tensor


def equalize_pseudo(y, lib, m1, m2, common_lib, dispersion) -> PseudoCounts:
    """equalizeLibSizes for a two-group tile: fit each group's NB rate,
    then quantile-map every observation from its own library size to the
    common one. y, lib, m1, m2: (..., W); common_lib, dispersion: (...)."""
    r1 = one_group_nb_rate(y, lib, m1, dispersion)
    r2 = one_group_nb_rate(y, lib, m2, dispersion)
    rate = torch.clamp(r1[..., None] * m1 + r2[..., None] * m2, min=1e-10)
    pseudo = q2q_nbinom(y, rate * lib, rate * common_lib[..., None],
                        dispersion[..., None])
    return PseudoCounts(
        torch.where(m1 | m2, pseudo, torch.zeros_like(pseudo)), r1, r2)


def _take(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    return torch.gather(a, -1, i[..., None])[..., 0]


def common_dispersion_grid(ll_grid_sum: torch.Tensor, deltas) -> torch.Tensor:
    """The dispersion φ maximizing the gene-summed conditional LL over the
    δ grid (..., D), refined by the vertex of the parabola through the
    argmax and its neighbours in log φ (clamped to their interval)."""
    deltas = torch.as_tensor(deltas, dtype=torch.float32,
                             device=ll_grid_sum.device)
    log_phi = torch.log(deltas / (1.0 - deltas))
    i = torch.clamp(torch.argmax(ll_grid_sum, dim=-1), 1, deltas.shape[0] - 2)
    y0, y1, y2 = (_take(ll_grid_sum, i + o) for o in (-1, 0, 1))
    x0, x1, x2 = log_phi[i - 1], log_phi[i], log_phi[i + 1]
    # Newton form of the parabola through three (non-uniform) points:
    # x* = (x0+x1)/2 − s01/(2c), s01 the left slope, c the second divided
    # difference
    s01 = (y1 - y0) / torch.clamp(x1 - x0, min=1e-12)
    s12 = (y2 - y1) / torch.clamp(x2 - x1, min=1e-12)
    c = (s12 - s01) / torch.clamp(x2 - x0, min=1e-12)
    x_star = 0.5 * (x0 + x1) - s01 / torch.where(
        torch.abs(c) > 1e-12, 2.0 * c, torch.full_like(c, float("inf")))
    shift = torch.clamp(x_star - x1, x0 - x1, x2 - x1)
    return torch.exp(x1 + shift)


def tagwise_dispersion(ll_grid: torch.Tensor, common_dispersion: torch.Tensor,
                       prior_n: torch.Tensor, gene_mask: torch.Tensor
                       ) -> torch.Tensor:
    """Weighted-likelihood EB tagwise dispersion (trend="none").

    ll_grid: (..., G, T) per-gene conditional LL at common·2^E (E =
    ``TAGWISE_GRID_EXPONENTS``); prior_n: (...) prior weight; gene_mask:
    (..., G) genes in the shared-likelihood average. Returns (..., G)."""
    expo_grid = torch.as_tensor(TAGWISE_GRID_EXPONENTS, device=ll_grid.device)
    w = gene_mask[..., None].to(ll_grid.dtype)
    shared = (ll_grid * w).sum(dim=-2) / torch.clamp(w.sum(dim=-2), min=1.0)
    wl = ll_grid + prior_n[..., None, None] * shared[..., None, :]
    t = expo_grid.shape[0]
    i = torch.clamp(torch.argmax(wl, dim=-1), 1, t - 2)
    y0, y1, y2 = (_take(wl, i + o) for o in (-1, 0, 1))
    denom = y0 - 2.0 * y1 + y2
    h = expo_grid[1] - expo_grid[0]
    shift = torch.where(torch.abs(denom) > 1e-12, 0.5 * (y0 - y2) / denom * h,
                        torch.zeros_like(denom))
    shift = torch.clamp(shift, -h, h)
    return common_dispersion[..., None] * torch.exp2(expo_grid[i] + shift)


def _normal_tails(s1r, s, alpha, beta):
    """Moment-matched Beta-Binomial normal tails with continuity
    correction (the large-total branch of the exact test)."""
    ab = alpha + beta
    m = s * alpha / ab
    var = s * alpha * beta * (ab + s) / (ab * ab * (ab + 1.0))
    sd = torch.sqrt(torch.clamp(var, min=1e-30))
    log_pl = torch.special.log_ndtr((s1r + 0.5 - m) / sd)
    log_pu = torch.special.log_ndtr(-(s1r - 0.5 - m) / sd)
    return log_pl, log_pu


def _log_tail(x: torch.Tensor) -> torch.Tensor:
    """log of a linear tail mass relative to the mode, as the reference
    computes it. The reference floors the mass at 1e-40, a float32
    subnormal; XLA flushes subnormals to zero on its CPU and TPU backends,
    so there a tail below the smallest normal float32 (~e^-87 of the
    mode) takes log 0 = -inf, and BH later drops the entry. Torch keeps
    subnormals, so the flush is spelled out."""
    return torch.log(torch.where(x >= _TINY, x, 0.0))


def _finish(log_pl, log_pu, s, n1, n2) -> torch.Tensor:
    """Double the smaller tail, cap at 1; a zero total is a point mass
    (p = 1) and an empty group no test at all (NaN)."""
    log_p = torch.clamp(torch.minimum(log_pl, log_pu) + _LOG2, max=0.0)
    log_p = torch.where(s <= 0, torch.zeros_like(log_p), log_p)
    bad = (n1 < 1) | (n2 < 1)
    return torch.where(bad, torch.full_like(log_p, float("nan")), log_p)


def nb_exact_test_logp_normal(s1, s2, n1, n2, dispersion) -> torch.Tensor:
    """Two-sided log p by the normal branch alone, for the (pair, gene)
    entries whose totals exceed the exact-tail budget; same rounding,
    doubling and guards as ``nb_exact_test_logp``."""
    s1r, s2r = torch.round(s1), torch.round(s2)
    s = s1r + s2r
    phi = torch.clamp(dispersion, min=1e-10)
    log_pl, log_pu = _normal_tails(s1r, s, n1.to(torch.float32) / phi,
                                   n2.to(torch.float32) / phi)
    return _finish(log_pl, log_pu, s, n1, n2)


def nb_exact_test_logp(s1, s2, n1, n2, dispersion, s_max: int = 4096
                       ) -> torch.Tensor:
    """Two-sided log p of the NB exact test, doubling the smaller tail.

    Given s = s1 + s2 (rounded, edgeR-style), group 1's sum is
    Beta-Binomial(s, α = n1/φ, β = n2/φ). For s < s_max the tails are exact
    sums from cumulative log pmf-ratios
    pmf(a+1)/pmf(a) = (s−a)(a+α) / ((a+1)(s−a−1+β)); above, the normal
    branch. s1, s2, n1, n2, dispersion: (T,) tasks. The sweep holds a few
    (T, s_max) float32 temporaries: callers bound T·s_max."""
    s1r, s2r = torch.round(s1), torch.round(s2)
    s = s1r + s2r
    phi = torch.clamp(dispersion, min=1e-10)
    alpha = n1.to(torch.float32) / phi
    beta = n2.to(torch.float32) / phi

    # exact branch (s < s_max)
    a = torch.arange(s_max, dtype=torch.float32, device=s.device)
    sc = torch.clamp(s, max=float(s_max))[..., None]
    num = (sc - a) * (a + alpha[..., None])
    den = (a + 1.0) * (sc - a - 1.0 + beta[..., None])
    # one log of the ratio: both operands stay far from float32 overflow
    log_ratio = num.clamp_(min=1e-37).div_(den.clamp_(min=1e-37)).log_()
    del den
    # u(a) = log pmf(a) − log pmf(0), valid for a ≤ s
    u = torch.zeros_like(log_ratio)
    u[..., 1:] = torch.cumsum(log_ratio[..., :-1], dim=-1)
    del log_ratio
    invalid = a > sc
    u.masked_fill_(invalid, float("-inf"))
    # one exp sweep for Z and both tails, linear relative to the mode
    m = u.max(dim=-1, keepdim=True).values
    e = u.sub_(m).exp_()
    # the reference's backends flush subnormal terms to zero (_log_tail)
    e.masked_fill_(invalid | (e < _TINY), 0.0)
    del invalid
    z = e.sum(dim=-1)
    pl_lin = torch.where(a <= s1r[..., None], e, 0.0).sum(dim=-1)
    pu_lin = torch.where(a >= s1r[..., None], e, 0.0).sum(dim=-1)
    del e
    log_z = torch.log(z)    # z ≥ 1: the mode's own term is exp(0)
    log_pl_exact = _log_tail(pl_lin) - log_z
    log_pu_exact = _log_tail(pu_lin) - log_z

    # normal branch (s >= s_max)
    log_pl_norm, log_pu_norm = _normal_tails(s1r, s, alpha, beta)
    small = s < float(s_max)
    log_pl = torch.where(small, log_pl_exact, log_pl_norm)
    log_pu = torch.where(small, log_pu_exact, log_pu_norm)
    return _finish(log_pl, log_pu, s, n1, n2)
