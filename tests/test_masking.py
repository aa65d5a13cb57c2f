"""Masking semantics — mirrors tests/testthat/test_masking.R.

mask='zeros' (zeros-as-missing), NA auto-detection + mask='NA', and the
sparse-vs-dense treatment of zeros.
"""
import numpy as np
import pytest
import scipy.sparse as sp

import rcppml_tpu as rt

pytestmark = pytest.mark.numerics  # numerics-critical subset


def _planted(m=60, n=40, k=3, seed=42):
    rs = np.random.RandomState(seed)
    W = np.abs(rs.rand(m, k))
    H = np.abs(rs.rand(k, n))
    return W @ H, rs


def _recon(res):
    return np.asarray(res.W) @ np.diag(np.asarray(res.d)) @ np.asarray(res.H)


def test_mask_zeros_string_equals_flag():
    # R/nmf_thin.R mask="zeros" == mask_zeros=TRUE
    A, rs = _planted()
    A[rs.rand(*A.shape) < 0.3] = 0.0
    r1 = rt.nmf(A, 3, mask="zeros", maxit=15, seed=42)
    r2 = rt.nmf(A, 3, mask_zeros=True, maxit=15, seed=42)
    np.testing.assert_allclose(np.asarray(r1.W), np.asarray(r2.W))
    np.testing.assert_allclose(np.asarray(r1.d), np.asarray(r2.d))


def test_mask_zeros_improves_nonzero_fit():
    # test_masking.R:141-170 — when zeros mean "unobserved", masking them
    # fits the observed entries better than treating them as data.
    T, rs = _planted()
    obs = rs.rand(*T.shape) >= 0.4          # 40% of entries hidden as 0
    A = np.where(obs, T, 0.0)
    masked = rt.nmf(A, 3, mask="zeros", maxit=40, seed=42, tol=1e-6)
    plain = rt.nmf(A, 3, maxit=40, seed=42, tol=1e-6)
    err_m = np.mean((T[obs] - _recon(masked)[obs]) ** 2)
    err_p = np.mean((T[obs] - _recon(plain)[obs]) ** 2)
    assert err_m < err_p


def test_mask_zeros_respects_nonneg():
    # test_masking.R:200-214
    A, rs = _planted()
    A[rs.rand(*A.shape) < 0.5] = 0.0
    res = rt.nmf(A, 3, mask="zeros", maxit=15, seed=42)
    assert np.all(np.asarray(res.W) >= 0)
    assert np.all(np.asarray(res.H) >= 0)


def test_mask_zeros_with_regularization():
    # test_masking.R:76-91
    A, rs = _planted()
    A[rs.rand(*A.shape) < 0.3] = 0.0
    res = rt.nmf(A, 3, mask="zeros", L1=0.05, L2=0.01, maxit=15, seed=42)
    assert np.all(np.isfinite(np.asarray(res.W)))


def test_mask_zeros_with_irls_loss():
    # test_masking.R:56-74 — composes with non-MSE losses
    T, rs = _planted()
    A = rs.poisson(T * 3).astype(np.float64)
    res = rt.nmf(A, 3, mask="zeros", loss="gp", dispersion="none",
                 maxit=10, seed=42)
    assert np.all(np.isfinite(np.asarray(res.W)))


def test_na_auto_detected_and_masked():
    # test_masking.R:240-262
    A, _ = _planted(100, 50)
    A[:5, :5] = np.nan
    with pytest.warns(UserWarning, match="Detected 25 NA"):
        res = rt.nmf(A, 3, maxit=20, seed=42)
    assert np.all(np.isfinite(_recon(res)))
    assert np.all(np.asarray(res.W) >= 0)
    assert np.all(np.asarray(res.H) >= 0)


def test_explicit_mask_na():
    # test_masking.R:264-276 — no warning with explicit mask='NA'
    import warnings
    A, _ = _planted(80, 40)
    A[:3, :3] = np.nan
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        res = rt.nmf(A, 2, mask="NA", maxit=15, seed=42)
    assert np.isfinite(res.train_loss)


def test_na_mask_preserves_unmasked_regions():
    # test_masking.R:279-298 — the NA region must not distort the rest
    T, _ = _planted(60, 40, seed=3)
    A = T.copy()
    A[:4, :4] = np.nan
    res = rt.nmf(A, 3, maxit=200, seed=42, tol=1e-8)
    keep = np.ones_like(T, dtype=bool)
    keep[:4, :4] = False
    err_na = np.mean((T[keep] - _recon(res)[keep]) ** 2)
    # T is exactly rank 3: the unmasked region must be recovered to a
    # tiny fraction of the data variance despite the NA block
    assert err_na < 0.01 * np.var(T[keep])


def test_nan_outside_explicit_matrix_mask_rejected():
    A, _ = _planted(20, 15)
    A[0, 0] = np.nan
    mask = np.zeros_like(A, dtype=bool)   # mask elsewhere, not (0,0)
    mask[5, 5] = True
    with pytest.raises(ValueError, match="outside"):
        rt.nmf(A, 2, mask=mask, maxit=3, seed=1)


def test_invalid_mask_string_rejected():
    A, _ = _planted(20, 15)
    with pytest.raises(ValueError, match="mask="):
        rt.nmf(A, 2, mask="bogus", maxit=3)


def test_sparse_vs_dense_zero_treatment():
    # test_masking.R:93-139 — dense zeros are observed data; identical
    # sparse/dense inputs give identical fits (zeros as data), and
    # mask='zeros' changes the answer.
    A, rs = _planted()
    A[rs.rand(*A.shape) < 0.5] = 0.0
    r_dense = rt.nmf(A, 3, maxit=15, seed=42)
    r_sparse = rt.nmf(sp.csc_matrix(A), 3, maxit=15, seed=42)
    np.testing.assert_allclose(np.asarray(r_dense.W),
                               np.asarray(r_sparse.W), rtol=1e-5,
                               atol=1e-6)
    r_masked = rt.nmf(A, 3, mask="zeros", maxit=15, seed=42)
    assert not np.allclose(np.asarray(r_masked.W), np.asarray(r_dense.W))


def test_mask_zeros_rank_deficient_columns_finite():
    """Columns with fewer observed entries than k make the per-column
    train Gram singular; the batched Cholesky must stay finite (relative
    ridge; the reference's unpivoted LLT NaNs here too)."""
    rs = np.random.RandomState(0)
    A = np.zeros((300, 200), dtype=np.float32)
    idx = rs.rand(*A.shape) < 0.03          # many columns with < 8 obs
    A[idx] = np.abs(rs.rand(int(idx.sum()))).astype(np.float32) + 0.5
    res = rt.nmf(A, 8, mask="zeros", maxit=10, seed=42)
    assert np.all(np.isfinite(np.asarray(res.W)))
    assert np.all(np.isfinite(np.asarray(res.H)))
    assert np.isfinite(res.train_loss)


def test_mask_zeros_few_nonzeros():
    # test_masking.R:216-238 — very few observed entries still fits
    rs = np.random.RandomState(0)
    A = np.zeros((30, 20))
    idx = rs.rand(*A.shape) < 0.08
    A[idx] = np.abs(rs.rand(int(idx.sum()))) + 0.5
    res = rt.nmf(A, 2, mask="zeros", maxit=15, seed=42)
    assert np.all(np.isfinite(np.asarray(res.W)))
