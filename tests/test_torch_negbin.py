"""The port's NB arithmetic (``ops/negbin.py``) against the JAX package's,
function by function, on seeded numpy inputs at the ranges the edgeR path
produces: means from 1e-3 to 200, dispersions from 1e-4·2^-6 (the compat
tagwise floor) to 2.5, totals up to and past the exact-test budget.

The two libraries' float32 special functions are different
implementations (XLA's and torch's), measured here first; every later
tolerance sits a little above what those differences produce through
the function under test.
"""

import jax
import jax.numpy as jnp
import jax.scipy.special as jsp
import jax.scipy.stats as jst
import numpy as np
import pytest
import torch

from scconsensus_tpu.ops import negbin as ref
from scconsensus_tpu_torch.de import edger
from scconsensus_tpu_torch.ops import negbin


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _j(fn, *args, **kw):
    return np.asarray(jax.jit(fn, static_argnames=tuple(kw))(*args, **kw))


def _shapes_and_points(rng, n=20000):
    shape = np.exp(rng.uniform(np.log(1e-4), np.log(2e3), n)).astype(
        np.float32)
    x = np.exp(rng.uniform(np.log(1e-6), np.log(5e3), n)).astype(np.float32)
    return shape, x


def _q2q_inputs(rng, n=20000):
    mu_in = np.exp(rng.uniform(np.log(1e-3), np.log(200.0), n)).astype(
        np.float32)
    mu_out = (mu_in * np.exp(rng.uniform(-0.7, 0.7, n))).astype(np.float32)
    x = np.where(rng.random(n) < 0.3, 0.0,
                 rng.gamma(1.0, mu_in)).astype(np.float32)
    return x, mu_in, mu_out


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def test_grid_constants_bit_equal():
    np.testing.assert_array_equal(_bits(negbin.TAGWISE_GRID_EXPONENTS),
                                  _bits(ref.TAGWISE_GRID_EXPONENTS))
    for n in (24, 64):
        np.testing.assert_array_equal(_bits(negbin.delta_grid(n)),
                                      _bits(ref.delta_grid(n)))
    assert negbin.delta_grid().shape == (ref.DEFAULT_DELTA_GRID_SIZE,)
    with pytest.raises(ValueError, match="not tabulated"):
        negbin.delta_grid(10)


def test_node_grid_bit_equal():
    # the reference's run_edger_pairs lines (scconsensus_tpu/de/edger.py
    # :455-462) on its own float32 delta grid
    deltas = np.asarray(ref.delta_grid(24))
    r_grid = (1.0 - deltas) / deltas
    rho_lo = float(np.log(r_grid.min())) - 6.0 * np.log(2.0) - 0.5
    rho_hi = float(np.log(r_grid.max())) + 6.0 * np.log(2.0) + 0.5
    rho_nodes = np.linspace(rho_lo, rho_hi, 24).astype(np.float32)
    h = float(rho_nodes[1] - rho_nodes[0])
    got = edger._node_grid()
    for a, b in zip(got[:3], (deltas, r_grid, rho_nodes)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert got[3] == h


def test_special_functions_agree_at_edger_shapes():
    rng = np.random.default_rng(0)
    shape, x = _shapes_and_points(rng)
    # gammainc: the two float32 series/continued fractions differ by up to
    # 2.4e-4 absolute over this domain (measured); held at 5e-4
    np.testing.assert_allclose(
        torch.special.gammainc(_t(shape), _t(x)).numpy(),
        _j(jsp.gammainc, shape, x), rtol=0, atol=5e-4)
    p = rng.uniform(1e-7, 1 - 1e-7, 20000).astype(np.float32)
    # ndtri: a few ulps (measured 7.2e-7 absolute)
    np.testing.assert_allclose(torch.special.ndtri(_t(p)).numpy(),
                               _j(jsp.ndtri, p), rtol=0, atol=2e-6)
    z = rng.uniform(-40.0, 10.0, 20000).astype(np.float32)
    # log normal cdf: relative 3.4e-7 in the far tail (measured)
    np.testing.assert_allclose(torch.special.log_ndtr(_t(z)).numpy(),
                               _j(jst.norm.logcdf, z), rtol=2e-6, atol=1e-6)
    y = np.exp(rng.uniform(np.log(1e-6), np.log(1e5), 20000)).astype(
        np.float32)
    # lgamma: relative 2e-6 (measured)
    np.testing.assert_allclose(torch.lgamma(_t(y)).numpy(),
                               _j(jsp.gammaln, y), rtol=5e-6, atol=5e-6)


@pytest.mark.parametrize("r", [0.05, 1.0, 25.0, 29.9, 30.0, 31.0, 1e3, 1e5,
                               3e7])
def test_lgamma_shift_both_sides_of_the_switch(r):
    y = np.random.default_rng(1).uniform(0, 50, 2000).astype(np.float32)
    got = negbin.lgamma_shift(_t(y), torch.tensor(r)).numpy()
    want = _j(ref.lgamma_shift, y, np.float32(r))
    # below r = 30 a difference of two lgammas, each a few ulps off
    # (6.1e-5 measured at r = 29.9); above it the Stirling form
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=1e-4)


def test_qgamma():
    rng = np.random.default_rng(2)
    shape, _ = _shapes_and_points(rng)
    p = rng.uniform(1e-7, 1 - 1e-7, shape.size).astype(np.float32)
    got = negbin._qgamma(_t(p), _t(shape)).numpy()
    want = _j(ref._qgamma, p, shape)
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    # three clamped Newton steps carry the gammainc difference: 8e-5
    # relative at the 99.9th percentile, up to 1.9e-2 on quantiles near
    # 1e-9 at shapes below 1e-3 (measured)
    assert np.quantile(rel, 0.999) < 5e-4
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=1e-6)


@pytest.mark.parametrize("phi", [1e-4 * 2.0 ** -6, 1e-4, 0.01, 0.5, 2.5])
def test_q2q_gamma_raw(phi):
    x, mu_in, mu_out = _q2q_inputs(np.random.default_rng(3))
    got = negbin.q2q_gamma_raw(_t(x), _t(mu_in), _t(mu_out), phi).numpy()
    want = _j(ref.q2q_gamma_raw, x, mu_in, mu_out, np.float32(phi))
    # a zero count maps to exactly 0 on both sides
    assert np.all(got[x == 0] == 0.0) and np.all(want[x == 0] == 0.0)
    # the gammainc difference through _qgamma: 1.6e-3 relative, 5.2e-3
    # absolute at most (measured)
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=1e-2)


@pytest.mark.parametrize("phi", [1e-4, 0.5])
def test_q2q_maps_and_equalization(phi):
    rng = np.random.default_rng(4)
    x, mu_in, mu_out = _q2q_inputs(rng, 4000)
    args = (x, mu_in, mu_out)
    for name in ("q2q_normal", "q2q_normal_raw"):
        np.testing.assert_allclose(
            getattr(negbin, name)(*map(_t, args), phi).numpy(),
            _j(getattr(ref, name), *args, np.float32(phi)),
            rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        negbin.q2q_nbinom(*map(_t, args), phi).numpy(),
        _j(ref.q2q_nbinom, *args, np.float32(phi)), rtol=5e-3, atol=1e-2)
    # a two-group tile: rates by Newton, then the full map
    b, w = 6, 40
    y = rng.poisson(3.0, (b, w)).astype(np.float32)
    lib = rng.uniform(500, 1500, (b, w)).astype(np.float32)
    m1 = np.zeros((b, w), bool)
    m1[:, :15] = True
    m2 = ~m1
    m2[:, -5:] = False
    clib = np.full(b, 900.0, np.float32)
    disp = np.full(b, phi, np.float32)
    got = negbin.equalize_pseudo(_t(y), _t(lib), torch.from_numpy(m1),
                                 torch.from_numpy(m2), _t(clib), _t(disp))
    want = jax.jit(ref.equalize_pseudo)(y, lib, m1, m2, clib, disp)
    for g, r_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r_), rtol=5e-3,
                                   atol=1e-2)
    ll = negbin.nb_cond_log_lik(_t(y), torch.from_numpy(m1),
                                _t(1.0 / disp)).numpy()
    np.testing.assert_allclose(
        ll, _j(ref.nb_cond_log_lik, y, m1, (1.0 / disp).astype(np.float32)),
        rtol=1e-5, atol=1e-3)


def _ll_grid(rng, lead, d, peak):
    """Concave LL rows over d grid points peaking at index ``peak`` (an
    edge or the interior), plus noise."""
    xs = np.arange(d, dtype=np.float64)
    centre = np.asarray(peak, np.float64)[..., None] + rng.uniform(
        -0.4, 0.4, lead + (1,))
    ll = -rng.uniform(0.5, 3.0, lead + (1,)) * (xs - centre) ** 2
    return (ll + rng.normal(0, 0.05, lead + (d,)) - 1e3).astype(np.float32)


@pytest.mark.parametrize("peak", ["low_edge", "interior", "high_edge"])
def test_common_dispersion_grid(peak):
    rng = np.random.default_rng(5)
    deltas = negbin.delta_grid(24)
    at = {"low_edge": 0, "interior": 11, "high_edge": 23}[peak]
    ll = _ll_grid(rng, (64,), 24, np.full(64, at))
    got = negbin.common_dispersion_grid(_t(ll), deltas).numpy()
    want = _j(ref.common_dispersion_grid, ll, np.asarray(ref.delta_grid(24)))
    # the same grid and argmax; the vertex goes through one float32 log
    # and one exp on each side (an ulp or two apart)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=0)


@pytest.mark.parametrize("peak", ["low_edge", "interior", "high_edge"])
def test_tagwise_dispersion(peak):
    rng = np.random.default_rng(6)
    p, g, t = 3, 50, 11
    at = {"low_edge": 0, "interior": 5, "high_edge": 10}[peak]
    ll = _ll_grid(rng, (p, g), t, np.full((p, g), at))
    common = rng.uniform(1e-4, 1.0, p).astype(np.float32)
    prior = np.full(p, 10.0 / 58.0, np.float32)
    mask = rng.random((p, g)) < 0.8
    got = negbin.tagwise_dispersion(_t(ll), _t(common), _t(prior),
                                    torch.from_numpy(mask)).numpy()
    want = _j(ref.tagwise_dispersion, ll, common, prior, mask)
    # same argmax; the shared-likelihood mean sums LL values near -1e3 in
    # another order (float32 rounding ~6e-5), which moves the parabola's
    # vertex by that over the curvature: 1.3e-4 relative at most (measured)
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=0)


def _exact_case(rng, n, s_max):
    s1 = rng.gamma(1.0, s_max / 3.0, n).astype(np.float32)
    s2 = rng.gamma(1.0, s_max / 3.0, n).astype(np.float32)
    s1[:8] = 0.0          # zero totals: a point mass, p = 1
    s2[:8] = 0.0
    s1[8:16] = s_max      # totals at and past s_max: the normal branch
    n1 = rng.integers(1, 60, n).astype(np.float32)
    n2 = rng.integers(1, 60, n).astype(np.float32)
    n1[16:20] = 0.0       # an empty group: no test at all
    n2[20:22] = 0.5
    disp = np.exp(rng.uniform(np.log(1e-4 * 2 ** -6), np.log(2.5), n)
                  ).astype(np.float32)
    return s1, s2, n1, n2, disp


@pytest.mark.parametrize("s_max", [64, 256])
def test_exact_test(s_max):
    args = _exact_case(np.random.default_rng(7), 3000, s_max)
    got = negbin.nb_exact_test_logp(*map(_t, args), s_max=s_max).numpy()
    want = _j(ref.nb_exact_test_logp, *args, s_max=s_max)
    s1, s2, n1, n2, _ = args
    bad = (n1 < 1) | (n2 < 1)
    assert np.all(np.isnan(got[bad])) and np.all(np.isnan(want[bad]))
    assert np.all(got[:8][~bad[:8]] == 0.0)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    # cumulative log-ratio sums over up to s_max terms in another order,
    # and log_ndtr against norm.logcdf on the normal branch
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4, atol=2e-4)
    normal = np.round(s1) + np.round(s2) >= s_max
    assert normal[~bad].any() and (~normal[~bad]).any()
    got_n = negbin.nb_exact_test_logp_normal(*map(_t, args)).numpy()
    want_n = _j(ref.nb_exact_test_logp_normal, *args)
    np.testing.assert_array_equal(np.isnan(got_n), np.isnan(want_n))
    fin = np.isfinite(want_n)
    np.testing.assert_allclose(got_n[fin], want_n[fin], rtol=1e-4, atol=2e-4)
    # both functions agree on the normal branch's entries
    np.testing.assert_array_equal(got[normal & ~bad], got_n[normal & ~bad])


def test_exact_test_deep_tail_takes_log_zero_as_the_reference_does():
    # tails below the smallest normal float32 (relative to the mode) are
    # flushed to 0 by the reference's backends: log p = -inf, not -87
    s1 = np.array([0.0, 1.0, 60.0], np.float32)
    s2 = np.array([200.0, 190.0, 60.0], np.float32)
    n = np.full(3, 30.0, np.float32)
    disp = np.full(3, 1e-4, np.float32)
    got = negbin.nb_exact_test_logp(_t(s1), _t(s2), _t(n), _t(n), _t(disp),
                                    s_max=512).numpy()
    want = _j(ref.nb_exact_test_logp, s1, s2, n, n, disp, s_max=512)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isneginf(got[0])
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-4, atol=2e-4)


def test_one_group_rate():
    rng = np.random.default_rng(8)
    y = rng.negative_binomial(2.0, 0.1, (5, 64)).astype(np.float32)
    lib = rng.uniform(500, 1500, (5, 64)).astype(np.float32)
    mask = rng.random((5, 64)) < 0.7
    mask[0] = False       # an empty group: rate 0
    disp = np.array([1e-4, 0.01, 0.3, 0.8, 2.5], np.float32)
    got = negbin.one_group_nb_rate(_t(y), _t(lib), torch.from_numpy(mask),
                                   _t(disp)).numpy()
    want = _j(ref.one_group_nb_rate, y, lib, mask, disp)
    assert got[0] == 0.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
