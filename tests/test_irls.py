"""IRLS distribution tests (reference: test_gp_nmf.R, test_nb_nmf.R,
test_dense_irls.R, test_distribution_losses.R, test_zi_modes.R).

Statistical-correctness: fits converge, losses decrease, dispersion
estimates land in sensible ranges on simulated count data.
"""

import numpy as np
import pytest

import rcppml_tpu as rt
from rcppml_tpu.utils.simulate import simulate_counts, simulate_nmf

pytestmark = pytest.mark.numerics  # numerics-critical subset


@pytest.fixture(scope="module")
def counts():
    return simulate_counts(m=50, n=70, k=3, seed=5)


@pytest.fixture(scope="module")
def nb_counts():
    return simulate_counts(m=50, n=70, k=3, nb_size=2.0, seed=9)


def test_kl_via_gp_none(counts):
    """loss='gp' with dispersion='none' is user-facing KL (loss.hpp:43-45)."""
    A = counts["A"]
    res = rt.nmf(A, 3, loss="gp", dispersion="none", seed=42, maxit=20)
    assert np.isfinite(res.train_loss)
    h = res.loss_history
    assert h[-1] <= h[0]
    assert (res.W >= 0).all() and (res.H >= 0).all()


def test_gp_theta_estimated(counts):
    A = counts["A"]
    res = rt.nmf(A, 3, loss="gp", dispersion="per_row", seed=42, maxit=15)
    assert res.theta is not None and res.theta.shape == (50,)
    assert (res.theta >= 0).all() and (res.theta <= 0.9).all()
    assert np.isfinite(res.train_loss)


def test_nb_fit_and_size(nb_counts):
    A = nb_counts["A"]
    res = rt.nmf(A, 3, loss="nb", dispersion="per_row", seed=42, maxit=20)
    assert res.theta is not None and res.theta.shape == (50,)
    # overdispersed data (r=2): estimated sizes should be well below the
    # Poisson-limit cap for most rows
    assert np.median(res.theta) < 100.0
    h = res.loss_history
    assert h[-1] <= h[0]


def test_nb_poisson_limit():
    """Near-Poisson data should push r toward the cap."""
    sim = simulate_counts(m=40, n=60, k=3, seed=3)  # Poisson
    res = rt.nmf(sim["A"], 3, loss="nb", dispersion="per_row", seed=1, maxit=15)
    assert np.median(res.theta) > 10.0


def test_gamma_fit():
    rs = np.random.RandomState(0)
    W = rs.gamma(2, 1, (40, 3))
    H = rs.gamma(2, 1, (3, 50))
    mu = W @ H
    A = rs.gamma(2.0, mu / 2.0).astype(np.float32)  # Gamma with mean mu
    res = rt.nmf(A, 3, loss="gamma", seed=42, maxit=20)
    assert np.isfinite(res.train_loss)
    assert res.dispersion is not None
    h = res.loss_history
    assert h[-1] <= h[0]


def test_tweedie_fit(counts):
    A = counts["A"]
    res = rt.nmf(A, 3, loss="tweedie", tweedie_power=1.4, seed=42, maxit=12)
    assert np.isfinite(res.train_loss)
    assert res.loss_history[-1] <= res.loss_history[0]


def test_invgauss_fit():
    rs = np.random.RandomState(1)
    W = rs.gamma(2, 1, (30, 2))
    H = rs.gamma(2, 1, (2, 40))
    mu = W @ H
    A = np.abs(rs.wald(mu, mu * 3)).astype(np.float32)
    res = rt.nmf(A, 2, loss="inverse_gaussian", seed=42, maxit=10)
    assert np.isfinite(res.train_loss)


def test_robust_mse(small_factors):
    """Robust (Huber-on-Pearson) with MSE base: downweights outliers."""
    A = small_factors["A"].copy()
    A[0, 0] = 100.0  # inject outlier
    res_rob = rt.nmf(A, 4, robust=True, seed=42, maxit=25)
    res_std = rt.nmf(A, 4, seed=42, maxit=25)
    # robust fit should be less distorted by the outlier in the clean region
    truth = small_factors["A"]
    err_rob = np.linalg.norm(res_rob.reconstruct()[1:] - truth[1:])
    err_std = np.linalg.norm(res_std.reconstruct()[1:] - truth[1:])
    assert err_rob <= err_std * 1.5
    assert np.isfinite(res_rob.train_loss)


def test_zi_row(nb_counts):
    A = nb_counts["A"].copy()
    rs = np.random.RandomState(12)
    drop = rs.uniform(size=A.shape) < 0.3
    A_zi = (A * ~drop).astype(np.float32)
    res = rt.nmf(A_zi, 3, loss="nb", zi="row", seed=42, maxit=15)
    assert res.pi_row is not None
    assert (res.pi_row >= 0.001).all() and (res.pi_row <= 0.999).all()
    # mean dropout estimate in a plausible band around the true 0.3
    assert 0.02 < float(res.pi_row.mean()) < 0.7


def test_gp_reproducible(counts):
    A = counts["A"]
    r1 = rt.nmf(A, 3, loss="gp", seed=4, maxit=8)
    r2 = rt.nmf(A, 3, loss="gp", seed=4, maxit=8)
    np.testing.assert_allclose(r1.W, r2.W, rtol=1e-6, atol=1e-7)


def test_sparse_input_weights_zeros_differently(counts):
    """scipy sparse input uses the sparse-Gram semantics (zeros weight 1)."""
    import scipy.sparse as sp
    A = counts["A"].copy()
    A[A < 2] = 0
    res_dense = rt.nmf(A, 3, loss="gp", dispersion="none", seed=4, maxit=8)
    res_sparse = rt.nmf(sp.csc_matrix(A), 3, loss="gp", dispersion="none",
                        seed=4, maxit=8)
    assert np.isfinite(res_sparse.train_loss)
    # different weighting semantics -> different (but both valid) fits
    assert not np.allclose(res_dense.H, res_sparse.H)


def test_gp_theta_recovery():
    """Per-row GP dispersion estimates track the simulated truth
    (test_gp_nmf.R statistical-correctness analog)."""
    from rcppml_tpu.utils.simulate import simulate_gp_counts
    sim = simulate_gp_counts(m=50, n=120, k=3, theta_range=(0.0, 0.6),
                             seed=13)
    res = rt.nmf(sim["A"], 3, loss="gp", dispersion="per_row", seed=42,
                 maxit=25)
    rho = np.corrcoef(res.theta, sim["theta"])[0, 1]
    assert rho > 0.5
    # high-theta rows estimated materially higher than low-theta rows
    lo = res.theta[sim["theta"] < 0.15].mean()
    hi = res.theta[sim["theta"] > 0.45].mean()
    assert hi > lo + 0.1


def test_nb_size_ordering():
    """Per-row NB size estimates preserve the true dispersion ordering
    (test_nb_nmf.R analog)."""
    rs = np.random.RandomState(17)
    m, n, k = 60, 150, 3
    W = rs.gamma(1.0, 1.0, (m, k))
    H = rs.gamma(1.0, 1.0, (k, n))
    mu = 8.0 * (W @ H) / k
    r_true = np.repeat([0.5, 2.0, 8.0, 1000.0], m // 4)
    A = np.zeros((m, n), np.float32)
    for i in range(m):
        p = r_true[i] / (r_true[i] + mu[i])
        A[i] = rs.negative_binomial(r_true[i], np.clip(p, 1e-9, 1.0))
    res = rt.nmf(A, k, loss="nb", dispersion="per_row", seed=42, maxit=25)
    med = [np.median(res.theta[r_true == r]) for r in (0.5, 2.0, 8.0)]
    assert med[0] < med[1] < med[2]
    # heavy overdispersion (r=0.5) estimated well below the Poisson cap
    assert med[0] < 5.0
