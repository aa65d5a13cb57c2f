"""nnls()/predict()/evaluate() projection API tests (R/solve.R, predict)."""

import numpy as np
import pytest

import rcppml_tpu as rt
from rcppml_tpu.models.project import evaluate, mse, nnls, predict

pytestmark = pytest.mark.numerics  # numerics-critical subset


def test_nnls_exact_recovery():
    rs = np.random.RandomState(0)
    W = np.abs(rs.rand(60, 4)).astype(np.float32)
    H = np.abs(rs.rand(4, 50)).astype(np.float32)
    A = W @ H
    H_hat = nnls(A, w=W)
    np.testing.assert_allclose(H_hat, H, rtol=1e-2, atol=1e-3)


def test_nnls_h_side():
    rs = np.random.RandomState(1)
    W = np.abs(rs.rand(40, 3)).astype(np.float32)
    H = np.abs(rs.rand(3, 30)).astype(np.float32)
    A = W @ H
    W_hat = nnls(A, h=H)
    assert W_hat.shape == (40, 3)
    np.testing.assert_allclose(W_hat, W, rtol=1e-2, atol=1e-3)


def test_nnls_nonneg():
    rs = np.random.RandomState(2)
    W = rs.randn(30, 3).astype(np.float32)
    A = rs.randn(30, 20).astype(np.float32)
    H = nnls(A, w=W, nonneg=True)
    assert (H >= 0).all()
    H2 = nnls(A, w=W, nonneg=False)
    assert (H2 < 0).any()


def test_nnls_l1_sparsifies():
    rs = np.random.RandomState(3)
    W = np.abs(rs.rand(50, 5)).astype(np.float32)
    A = np.abs(rs.rand(50, 40)).astype(np.float32)
    h0 = nnls(A, w=W, solver="cd")
    h1 = nnls(A, w=W, L1=0.3, solver="cd")
    assert (h1 == 0).mean() > (h0 == 0).mean()


def test_predict_projects(small_factors):
    A = small_factors["A"]
    res = rt.nmf(A, 4, seed=42, maxit=40)
    H_new = predict(res, A)
    assert H_new.shape == (4, A.shape[1])
    # projection of training data should reconstruct about as well as H
    rec = (res.W * res.d[None, :]) @ np.linalg.lstsq(
        (res.W * res.d[None, :]), A, rcond=None)[0]
    rec_pred = (res.W * res.d[None, :]) @ H_new
    assert np.linalg.norm(A - rec_pred) < 1.25 * np.linalg.norm(A - rec) + 1e-3


def test_evaluate_and_mse(small_factors):
    A = small_factors["A"]
    res = rt.nmf(A, 4, seed=42, maxit=40)
    m1 = mse(res, A)
    assert m1 == pytest.approx(float(np.mean((A - res.reconstruct()) ** 2)),
                               rel=1e-4)
    kl = evaluate(res, A, loss="gp")    # gp none == KL deviance
    assert np.isfinite(kl)


def test_evaluate_masked(small_factors):
    A = small_factors["A"]
    res = rt.nmf(A, 4, seed=42, maxit=20)
    M = np.zeros_like(A, dtype=bool)
    M[:10] = True
    full = evaluate(res, A)
    masked = evaluate(res, A, mask=M)
    missing = evaluate(res, A, mask=M, missing_only=True)
    assert np.isfinite(masked) and np.isfinite(missing)
    assert masked != missing or abs(full - masked) < 1e-12


def test_predict_uses_stored_config(small_factors):
    A = small_factors["A"]
    res = rt.nmf(A, 4, seed=42, maxit=20, L1=(0, 0.05), solver="cd")
    assert "config" in res.misc
    H_new = predict(res, A)        # picks up stored H-side L1
    assert (H_new == 0).mean() > 0


def test_evaluate_mask_zeros(small_factors):
    """evaluate(mask_zeros=True) restricts to nonzero entries
    (test_evaluate.R:45-54)."""
    from rcppml_tpu.models.project import evaluate
    A = small_factors["A"].copy()
    A[A < np.median(A)] = 0
    res = rt.nmf(A, 4, seed=42, maxit=20)
    full = evaluate(res, A)
    nz = evaluate(res, A, mask_zeros=True)
    assert np.isfinite(nz) and nz != full


def test_evaluate_missing_only_requires_mask(small_factors):
    """missing_only without a mask errors (test_evaluate.R:71-78)."""
    from rcppml_tpu.models.project import evaluate
    res = rt.nmf(small_factors["A"], 4, seed=42, maxit=5)
    with pytest.raises(ValueError, match="mask"):
        evaluate(res, small_factors["A"], missing_only=True)


def test_nnls_warm_start_not_worse():
    """Warm-started CD must not increase the residual
    (test_unified_backend.R:143-186)."""
    from rcppml_tpu.models.project import nnls
    rs = np.random.RandomState(42)
    W = rs.rand(50, 3).astype(np.float32)
    H = rs.rand(3, 40).astype(np.float32)
    A = np.maximum(W @ H + rs.normal(0, 0.01, (50, 40)), 0).astype(np.float32)
    H_cold = nnls(A, w=W, cd_maxit=5, solver="cd")
    H_warm = nnls(A, w=W, cd_maxit=5, warm_start=H_cold)
    r_cold = float(np.sum((A - W @ H_cold) ** 2))
    r_warm = float(np.sum((A - W @ H_warm) ** 2))
    assert r_warm <= r_cold * 1.001
    # h-side orientation: warm start in return orientation (m, k)
    W_cold = nnls(A, h=H, cd_maxit=5, solver="cd")
    W_warm = nnls(A, h=H, cd_maxit=5, warm_start=W_cold)
    assert np.sum((A - W_warm @ H) ** 2) <= np.sum((A - W_cold @ H) ** 2) * 1.001
