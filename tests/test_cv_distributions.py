"""Speckled CV under every IRLS distribution + projective/symmetric CV.

Mirrors tests/testthat/test_cv_distributions.R (17 blocks): each
distribution must produce a finite, positive held-out loss on both
sparse and dense input, and the variant flags (projective, symmetric)
must compose with CV.
"""
import numpy as np
import pytest
import scipy.sparse as sp

import rcppml_tpu as rt

pytestmark = pytest.mark.numerics  # numerics-critical subset


def _pos_data(m=50, n=35, seed=42):
    # test_cv_distributions.R:7-12
    rs = np.random.RandomState(seed)
    A = np.abs(rs.normal(2.0, 0.5, size=(m, n)))
    return np.maximum(A, 1e-8)


def _count_data(m=50, n=35, k=2, seed=42, nb=False):
    rs = np.random.RandomState(seed)
    W = np.abs(rs.normal(1.0, 0.4, size=(m, k)))
    H = np.abs(rs.normal(1.0, 0.4, size=(k, n)))
    mu = np.maximum(W @ H, 0.01)
    if nb:
        p = 5.0 / (5.0 + mu)
        return rs.negative_binomial(5, p).astype(np.float64)
    return rs.poisson(mu * 5).astype(np.float64)


def _check(res):
    # NLL-based losses (e.g. GP) may be negative; finiteness is the
    # reference's assertion (test_cv_distributions.R "is.finite").
    assert np.isfinite(res.test_loss)
    assert np.all(np.isfinite(np.asarray(res.W)))


def test_cv_mse_dense():
    # test_cv_distributions.R:18-25 — MSE test loss is strictly positive
    res = rt.nmf(_pos_data(40, 30), 3, loss="mse", test_fraction=0.1,
                 maxit=30, tol=1e-4, seed=42)
    _check(res)
    assert res.test_loss > 0


@pytest.mark.parametrize("loss", ["gp", "nb"])
@pytest.mark.parametrize("sparse", [False, True])
def test_cv_count_losses(loss, sparse):
    # test_cv_distributions.R:40-93,144-169
    A = _count_data(nb=(loss == "nb"))
    if sparse:
        A = sp.csc_matrix(A)
    res = rt.nmf(A, 2, loss=loss, dispersion="per_row",
                 test_fraction=0.1, maxit=30, tol=1e-4, seed=42)
    _check(res)


@pytest.mark.parametrize("loss", ["gamma", "inverse_gaussian"])
@pytest.mark.parametrize("sparse", [False, True])
def test_cv_positive_losses(loss, sparse):
    # test_cv_distributions.R:96-126,171-192
    A = _pos_data()
    if sparse:
        A = sp.csc_matrix(A)
    res = rt.nmf(A, 2, loss=loss, dispersion="per_row",
                 test_fraction=0.1, maxit=30, tol=1e-4, seed=42)
    _check(res)


@pytest.mark.parametrize("sparse", [False, True])
def test_cv_tweedie(sparse):
    # test_cv_distributions.R:128-142,193-204
    A = _pos_data()
    if sparse:
        A = sp.csc_matrix(A)
    res = rt.nmf(A, 2, loss="tweedie", tweedie_power=1.5,
                 dispersion="per_row", test_fraction=0.1, maxit=30,
                 tol=1e-4, seed=42)
    _check(res)


@pytest.mark.parametrize("sparse", [False, True])
def test_cv_projective(sparse):
    # test_cv_distributions.R:208-228
    rs = np.random.RandomState(42)
    A = np.abs(rs.normal(2.0, 0.5, size=(50, 40)))
    if sparse:
        A = sp.csc_matrix(A)
    res = rt.nmf(A, 3, loss="mse", projective=True, test_fraction=0.1,
                 maxit=30, tol=1e-4, seed=42)
    _check(res)


@pytest.mark.parametrize("sparse", [False, True])
def test_cv_symmetric(sparse):
    # test_cv_distributions.R:230-260
    rs = np.random.RandomState(42)
    R = np.abs(rs.normal(1.0, 0.3, size=(40, 40)))
    A = (R + R.T) / 2.0
    if sparse:
        A = sp.csc_matrix(A)
    res = rt.nmf(A, 3, loss="mse", symmetric=True, test_fraction=0.1,
                 maxit=30, tol=1e-4, seed=42)
    _check(res)


def test_cv_nb_with_user_mask():
    # fit_cv.hpp:1391-1393 — user-masked entries leave both train and
    # test statistics; held-out loss must stay finite with both active.
    A = _count_data(nb=True)
    rs = np.random.RandomState(7)
    mask = rs.rand(*A.shape) < 0.05
    res = rt.nmf(A, 2, loss="nb", dispersion="per_row", mask=mask,
                 test_fraction=0.1, maxit=20, tol=1e-4, seed=42)
    _check(res)


def test_cv_loss_decreases_under_irls():
    # the held-out history is tracked for IRLS fits just like MSE
    A = _count_data()
    res = rt.nmf(A, 2, loss="gp", dispersion="per_row",
                 test_fraction=0.15, maxit=30, tol=0.0, seed=42)
    hist = np.asarray(res.test_loss_history, dtype=float)
    hist = hist[np.isfinite(hist)]
    assert len(hist) >= 2
    assert hist[-1] <= hist[0]
