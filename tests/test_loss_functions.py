"""Distribution-math unit tests (reference: test_loss_functions.R,
test_distribution_losses.R).

Each NLL/deviance is checked against scipy's log-densities (up to the
data-only constants the reference also drops), and each IRLS weight is
checked against the autodiff curvature of its own loss — w(mu) must equal
E[-d2 l/d mu2], evaluated via jax.grad at y = mu.
"""

import numpy as np
import pytest
import scipy.stats as st

pytestmark = pytest.mark.numerics  # numerics-critical subset

import jax
import jax.numpy as jnp

from rcppml_tpu.ops import losses
from rcppml_tpu.config import Loss
import rcppml_tpu as rt


def test_nb_nll_matches_scipy():
    """loss_nb == -log nbinom.pmf up to lgamma(y+1) (loss.hpp:416-426)."""
    y = np.array([0.0, 1, 3, 7, 20])
    mu = np.array([0.5, 2.0, 3.0, 5.0, 18.0])
    r = 2.5
    ours = np.asarray(losses.loss_nb(jnp.asarray(y), jnp.asarray(mu), r))
    p = r / (r + mu)
    ref = -st.nbinom.logpmf(y, r, p)
    const = np.array([__import__("math").lgamma(v + 1) for v in y])
    # atol: accelerator fp32 lgamma/log can be a few hundred ulps off glibc's
    # fp64-backed ones (measured <=5e-4 abs on these values); a wrong
    # TERM in the NLL shifts results by O(0.1+)
    np.testing.assert_allclose(ours, ref - const, rtol=1e-4, atol=1e-3)


def test_kl_poisson_limit_of_gp():
    """GP NLL at theta=0 == Poisson NLL up to log(y!) for y >= 1
    (loss.hpp:383-398; at y=0 the reference's form keeps the -log(s/otp)
    term unconditionally — we reproduce that quirk exactly)."""
    y = np.array([1.0, 4, 9])
    mu = np.array([1.5, 3.5, 8.0])
    ours = np.asarray(losses.loss_gp(jnp.asarray(y), jnp.asarray(mu), 0.0))
    ref = -st.poisson.logpmf(y.astype(int), mu)
    const = np.array([__import__("math").lgamma(v + 1) for v in y])
    # atol: accelerator fp32 transcendental ulps (test_nb_nll_matches_scipy)
    np.testing.assert_allclose(ours, ref - const, rtol=1e-4, atol=1e-3)
    # the y=0 quirk: loss = s - log(s), not s
    q = float(losses.loss_gp(jnp.asarray(0.0), jnp.asarray(0.7), 0.0))
    np.testing.assert_allclose(q, 0.7 - np.log(0.7), rtol=1e-4)


def test_gamma_deviance_properties():
    """Gamma deviance: zero at y == mu, positive elsewhere, scale-invariant."""
    y = jnp.asarray([1.0, 2.0, 5.0])
    assert np.allclose(np.asarray(losses.loss_gamma(y, y)), 0.0, atol=1e-6)
    d1 = np.asarray(losses.loss_gamma(y, 2.0 * y))
    assert (d1 > 0).all()
    d2 = np.asarray(losses.loss_gamma(10.0 * y, 20.0 * y))
    np.testing.assert_allclose(d1, d2, rtol=1e-5)


def test_tweedie_special_cases():
    """Tweedie deviance -> Poisson deviance at p->1 and Gamma at p->2
    (loss.hpp:480-500 p~1/p~2 special cases)."""
    y = jnp.asarray([1.0, 3.0, 6.0])
    mu = jnp.asarray([2.0, 2.5, 5.0])
    tw1 = np.asarray(losses.loss_tweedie(y, mu, 1.0 + 1e-7))
    pois_dev = np.asarray(2.0 * (y * jnp.log(y / mu) - (y - mu)))
    np.testing.assert_allclose(tw1, pois_dev, rtol=1e-3)
    tw2 = np.asarray(losses.loss_tweedie(y, mu, 2.0 - 1e-7))
    gam_dev = np.asarray(losses.loss_gamma(y, mu))
    np.testing.assert_allclose(tw2, gam_dev, rtol=1e-3)


# --------------------------------------------------------------------------
# Fisher-weight consistency: w(mu) == E[-d2 l / d mu2]; for these
# families the expectation equals the curvature at y = mu (KL/NB) so we
# can check the closed-form weights against jax.grad-of-grad.
# --------------------------------------------------------------------------

def _curvature(loss_fn, y, mu):
    g2 = jax.grad(jax.grad(lambda m: loss_fn(y, m)))
    return float(g2(mu))


def test_kl_weight_is_curvature():
    """w_KL = 1/mu == d2/dmu2 of the Poisson NLL at y = mu."""
    for mu in (0.5, 2.0, 7.0):
        w = float(losses.irls_weight_kl(jnp.float32(mu)))
        c = _curvature(lambda y, m: m - y * jnp.log(m), mu, mu)
        np.testing.assert_allclose(w, c, rtol=1e-4)


def test_nb_weight_is_expected_curvature():
    """w_NB = r/(mu(r+mu)) == E[-d2 l/dmu2] (loss.hpp:249-256)."""
    r = 3.0
    def nll(y, m):
        return -r * jnp.log(r / (r + m)) - y * jnp.log(m / (r + m))
    for mu in (0.5, 2.0, 9.0):
        w = float(losses.irls_weight_nb(jnp.float32(mu), r))
        c = _curvature(nll, mu, mu)     # curvature at y = mu == expectation
        np.testing.assert_allclose(w, c, rtol=1e-4)


def test_gp_weight_matches_reference_form():
    """GP Fisher weight: 1/s^2 + (y-1)/(s+theta y)^2 for y >= 1, with the
    per-entry adaptive KL blend (loss.hpp:198-229)."""
    y, s, th = 4.0, 2.0, 0.3
    w = float(losses.irls_weight_gp(jnp.float32(y), jnp.float32(s), th,
                                    blend=1.0))
    expected = 1.0 / s**2 + (y - 1.0) / (s + th * y) ** 2
    np.testing.assert_allclose(w, expected, rtol=1e-5)
    # s < 1: blend scales with s (eff = blend * min(s, 1))
    w_small = float(losses.irls_weight_gp(jnp.float32(2.0), jnp.float32(0.5),
                                          0.0, blend=1.0))
    w_kl = 1.0 / 0.5
    w_gp = 1.0 / 0.25 + 1.0 / 0.25
    expected_small = np.exp(0.5 * np.log(w_kl) + 0.5 * np.log(w_gp))
    np.testing.assert_allclose(w_small, expected_small, rtol=1e-4)


def test_power_weight():
    """w = mu^-p for variance-power families (loss.hpp:271-277)."""
    for p in (2.0, 3.0, 1.5):
        w = float(losses.irls_weight_power(jnp.float32(2.0), p))
        np.testing.assert_allclose(w, 2.0 ** (-p), rtol=1e-5)


def test_weights_capped():
    """All weights respect the 1e6 stability cap."""
    assert float(losses.irls_weight_kl(jnp.float32(1e-30))) <= 1e6 + 1
    assert float(losses.irls_weight_nb(jnp.float32(1e-30), 1.0)) <= 1e6 + 1
    assert float(losses.irls_weight_power(jnp.float32(1e-30), 2.0)) <= 1e6 + 1


def test_huber_robust_modifier():
    """Huber-on-Pearson: weight 1 inside delta, delta/|r| outside
    (loss.hpp:295-303)."""
    A = np.full((6, 8), 2.0, np.float32)
    res = rt.nmf(A + np.eye(6, 8, dtype=np.float32) * 50, 1, robust=True,
                 seed=1, maxit=10)
    assert np.isfinite(res.train_loss)


def test_nb_loss_stable_at_large_theta():
    """Round-3 review finding: at the reference's nb_size_max=1e6 cap the
    direct fp32 lgamma difference carries O(1) error per entry; the
    large-r branch must track float64 to ~1e-5 absolute."""
    import jax.numpy as jnp
    from scipy.special import gammaln
    from rcppml_tpu.ops import losses
    rs = np.random.RandomState(0)
    y = rs.poisson(3.0, 5000).astype(np.float32)
    mu = (rs.rand(5000) * 8 + 0.01).astype(np.float32)
    for r in (10.0, 500.0, 1e4, 1e6):
        got = np.asarray(losses.loss_nb(jnp.asarray(y), jnp.asarray(mu),
                                        jnp.float32(r)), np.float64)
        yf, muf = y.astype(np.float64), mu.astype(np.float64)
        exact = (-gammaln(yf + r) + gammaln(r)
                 - r * np.log(r / (r + muf)) - yf * np.log(muf / (r + muf)))
        assert np.max(np.abs(got - exact)) < 5e-3, f"r={r}"
    # large-r limit equals the Poisson NLL
    pois = muf - yf * np.log(muf)
    got6 = np.asarray(losses.loss_nb(jnp.asarray(y), jnp.asarray(mu),
                                     jnp.float32(1e6)), np.float64)
    assert np.max(np.abs(got6 - pois)) < 0.05
