"""Convergence behavior — mirrors tests/testthat/test_convergence.R.

Monotone loss, boundedness, rank monotonicity, convergence= modes for
nmf (accepted, loss-semantics) and svd (factor/loss/both honored).
"""
import numpy as np
import pytest
import scipy.sparse as sp

pytestmark = pytest.mark.numerics  # numerics-critical subset

import rcppml_tpu as rt


def _sparse_abs(m=50, n=30, density=0.3, seed=42):
    rs = np.random.RandomState(seed)
    A = sp.random(m, n, density=density, random_state=rs, format="csc")
    A.data = np.abs(A.data)
    return A


def _recon(res):
    return np.asarray(res.W) @ np.diag(np.asarray(res.d)) @ np.asarray(res.H)


def test_loss_decreases_sparse():
    # test_convergence.R:22-46
    res = rt.nmf(_sparse_abs(), 3, maxit=50, tol=0.0, seed=1)
    hist = np.asarray(res.loss_history, dtype=float)
    hist = hist[np.isfinite(hist)]
    assert hist[-1] <= hist[2] * 1.001


def test_converges_on_real_aml():
    # test_convergence.R:69-84
    from rcppml_tpu import datasets
    res = rt.nmf(datasets.aml(), 5, maxit=100, tol=1e-4, seed=42)
    assert res.converged
    assert res.iterations < 100


def test_consistent_across_seeds():
    # test_convergence.R:86-104 — final losses within a band across seeds
    A = np.abs(np.random.RandomState(0).rand(40, 30))
    losses = [rt.nmf(A, 3, maxit=60, tol=1e-6, seed=s).train_loss
              for s in (1, 2, 3, 4)]
    assert np.std(losses) < 0.2 * abs(np.mean(losses)) + 1e-6


def test_reconstruction_bounded():
    # test_convergence.R:106-134 — no divergence
    A = np.abs(np.random.RandomState(1).rand(30, 25)) * 10
    res = rt.nmf(A, 4, maxit=100, tol=0.0, seed=2)
    rec = _recon(res)
    assert np.all(np.isfinite(rec))
    assert rec.max() < A.max() * 10


def test_higher_rank_lower_mse():
    # test_convergence.R:158-173
    A = np.abs(np.random.RandomState(3).rand(40, 30))
    errs = []
    for k in (2, 4, 8):
        res = rt.nmf(A, k, maxit=80, tol=1e-7, seed=42)
        errs.append(float(np.mean((A - _recon(res)) ** 2)))
    assert errs[0] >= errs[1] >= errs[2]


def test_nmf_accepts_convergence_modes():
    # test_convergence.R:247-299 — all modes accepted and valid;
    # "loss" identical to the default (the reference's NMF core is
    # loss-converged regardless, src/RcppFunctions_nmf.cpp:340)
    A = _sparse_abs()
    base = rt.nmf(A, 3, maxit=100, tol=1e-4, seed=1)
    for mode in ("loss", "factor", "both"):
        res = rt.nmf(A, 3, maxit=100, tol=1e-4, seed=1, convergence=mode)
        assert res.iterations <= 100
        np.testing.assert_allclose(np.asarray(res.W), np.asarray(base.W))
    with pytest.raises(ValueError, match="convergence"):
        rt.nmf(A, 3, convergence="bogus")


def test_svd_convergence_modes():
    # svd_config.hpp:25-29 + deflation.hpp:796-814: every mode converges
    # to the true factors on a well-separated spectrum
    rs = np.random.RandomState(5)
    A = rs.rand(60, 40).astype(np.float32)
    s_ref = np.linalg.svd(A, compute_uv=False)[:3]
    for mode in ("factor", "loss", "both"):
        res = rt.svd(A, 3, method="deflation", convergence=mode, seed=1)
        np.testing.assert_allclose(np.asarray(res.d), s_ref, rtol=5e-3)
    with pytest.raises(ValueError, match="convergence"):
        rt.svd(A, 3, convergence="bogus")


def test_svd_krylov_convergence_modes():
    rs = np.random.RandomState(6)
    A = np.abs(rs.rand(50, 35)).astype(np.float32)
    outs = {}
    for mode in ("factor", "loss", "both"):
        res = rt.svd(A, 4, method="krylov", nonneg=(True, True),
                     convergence=mode, seed=1)
        assert res.converged or res.iterations >= 1
        outs[mode] = np.asarray(res.d)
    # same fixed point reached whichever criterion stops the loop
    np.testing.assert_allclose(outs["factor"], outs["loss"], rtol=2e-2)


def test_loss_decreases_dense():
    # test_convergence.R:48-67 — dense MSE decreases with iterations
    rs = np.random.RandomState(9)
    A = np.abs(rs.randn(45, 35)).astype(np.float32)
    res = rt.nmf(A, 3, maxit=50, tol=0.0, seed=1, track_train_loss=True)
    hist = np.asarray(res.loss_history, dtype=float)
    hist = hist[np.isfinite(hist)]
    assert hist[-1] <= hist[2] * 1.001


def test_known_factorizable_low_mse():
    # test_convergence.R — exact rank-3 product is fit to near zero
    rs = np.random.RandomState(4)
    A = (np.abs(rs.rand(40, 6)) @ np.abs(rs.rand(6, 30))).astype(np.float32)
    res = rt.nmf(A, 6, maxit=200, tol=1e-8, seed=2)
    rel = float(np.sum((A - _recon(res)) ** 2) / np.sum(A ** 2))
    assert rel < 0.01


def test_regularization_does_not_diverge():
    # test_convergence.R — L1/L2 combinations stay finite and bounded
    rs = np.random.RandomState(5)
    A = np.abs(rs.rand(40, 30)).astype(np.float32)
    for l1, l2 in [(0.1, 0.0), (0.0, 0.1), (0.1, 0.1), (0.5, 0.5)]:
        res = rt.nmf(A, 3, L1=(l1, l1), L2=(l2, l2), maxit=30, seed=1)
        assert np.isfinite(np.asarray(res.W)).all()
        assert np.isfinite(np.asarray(res.H)).all()
        assert _recon(res).max() < A.max() * 100


def test_tall_matrix():
    # test_convergence.R — m >> n
    rs = np.random.RandomState(6)
    A = np.abs(rs.rand(400, 12)).astype(np.float32)
    res = rt.nmf(A, 4, maxit=30, seed=1)
    assert np.asarray(res.W).shape == (400, 4)
    assert float(np.mean((A - _recon(res)) ** 2)) < float(np.var(A))


def test_wide_matrix():
    # test_convergence.R — n >> m
    rs = np.random.RandomState(7)
    A = np.abs(rs.rand(12, 400)).astype(np.float32)
    res = rt.nmf(A, 4, maxit=30, seed=1)
    assert np.asarray(res.H).shape == (4, 400)
    assert float(np.mean((A - _recon(res)) ** 2)) < float(np.var(A))


def test_very_sparse_matrix():
    # test_convergence.R — 2% density still factorizes finitely
    A = _sparse_abs(m=200, n=150, density=0.02, seed=11)
    res = rt.nmf(A, 3, maxit=30, seed=1)
    assert np.isfinite(np.asarray(res.W)).all()
    assert np.isfinite(float(res.train_loss))


def test_convergence_loss_matches_default():
    # test_convergence.R — convergence='loss' IS the default criterion
    rs = np.random.RandomState(8)
    A = np.abs(rs.rand(40, 30)).astype(np.float32)
    a = rt.nmf(A, 3, maxit=40, seed=1)
    b = rt.nmf(A, 3, maxit=40, seed=1, convergence="loss")
    np.testing.assert_array_equal(np.asarray(a.W), np.asarray(b.W))
