"""SVD API behaviors from test_svd.R not covered by test_svd.py:
mask= handling, robust variants, scale metadata, degenerate inputs,
orthogonality, dimnames.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import rcppml_tpu as rt

pytestmark = pytest.mark.numerics  # numerics-critical subset


@pytest.fixture(scope="module")
def lowrank():
    rs = np.random.RandomState(1)
    U = rs.normal(size=(60, 4))
    V = rs.normal(size=(45, 4))
    return ((U * [30.0, 18.0, 9.0, 4.0]) @ V.T
            + 0.05 * rs.normal(size=(60, 45))).astype(np.float32)


@pytest.fixture(scope="module")
def A_sparse():
    rs = np.random.RandomState(2)
    A = sp.random(60, 45, density=0.3, random_state=rs, format="csc")
    A.data = np.abs(A.data)
    return A


# ---------------------------------------------------------------------------
# mask= (test_svd.R:520-536, R/svd.R:233-268)
# ---------------------------------------------------------------------------

def test_mask_zeros_cv(A_sparse):
    s_nz = rt.svd(A_sparse, 3, method="deflation", seed=1,
                  test_fraction=0.1, cv_seed=42, mask="zeros")
    s_all = rt.svd(A_sparse, 3, method="deflation", seed=1,
                   test_fraction=0.1, cv_seed=42)
    assert np.isfinite(s_nz.test_loss) and np.isfinite(s_all.test_loss)
    assert (np.asarray(s_nz.d) > 0).all()
    # zero-entry holdouts do not change the (already-zero) training
    # matrix, so the FITS match; the held-out evaluation set differs
    assert float(s_nz.test_loss) != float(s_all.test_loss)


def test_obs_mask_excludes_entries(lowrank):
    rs = np.random.RandomState(9)
    corrupt = rs.uniform(size=lowrank.shape) < 0.05
    A_dirty = lowrank + corrupt * 500.0
    masked = rt.svd(A_dirty.astype(np.float32), 4, method="deflation",
                    seed=1, mask=sp.csc_matrix(corrupt.astype(np.float64)))
    plain = rt.svd(A_dirty.astype(np.float32), 4, method="deflation", seed=1)
    sref = np.linalg.svd(lowrank, compute_uv=False)[:4]
    err_m = np.abs(np.asarray(masked.d) - sref) / sref
    err_p = np.abs(np.asarray(plain.d) - sref) / sref
    # masking out the corrupted entries must give far better spectra
    assert err_m.max() < 0.15
    assert err_m.max() < err_p.max()


def test_mask_list_combined(A_sparse):
    m, n = A_sparse.shape
    rs = np.random.RandomState(3)
    excl = sp.csc_matrix((rs.uniform(size=(m, n)) < 0.03).astype(float))
    res = rt.svd(A_sparse, 3, method="deflation", seed=1,
                 test_fraction=0.1, cv_seed=1, mask=("zeros", excl))
    assert np.isfinite(res.test_loss)


def test_mask_validation_errors(A_sparse):
    with pytest.raises(ValueError, match="zeros"):
        rt.svd(A_sparse, 3, mask="nonzeros")
    with pytest.raises(ValueError, match="dimensions"):
        rt.svd(A_sparse, 3, method="deflation",
               mask=np.ones((5, 4)))
    with pytest.raises(ValueError, match="deflation"):
        rt.svd(A_sparse, 3, method="lanczos", mask="zeros")


def test_mask_auto_routes_to_deflation(A_sparse):
    res = rt.svd(A_sparse, 3, method="auto", mask="zeros",
                 test_fraction=0.1, cv_seed=1, seed=1)
    assert res.misc["method"] == "deflation"


# ---------------------------------------------------------------------------
# robust variants (test_svd.R:559-653)
# ---------------------------------------------------------------------------

def test_robust_mae_and_custom_delta(lowrank):
    r_mae = rt.svd(lowrank, 3, method="deflation", robust="mae", seed=1)
    r_num = rt.svd(lowrank, 3, method="deflation", robust=2.5, seed=1)
    assert np.isfinite(np.asarray(r_mae.d)).all()
    assert np.isfinite(np.asarray(r_num.d)).all()


def test_robust_sparse_input(A_sparse):
    res = rt.svd(A_sparse, 3, method="deflation", robust=True, seed=1)
    assert (np.asarray(res.d) > 0).all()


def test_robust_with_cv(lowrank):
    res = rt.svd(lowrank, 4, method="deflation", robust=True,
                 test_fraction=0.1, cv_seed=1, seed=1)
    assert np.isfinite(res.test_loss)
    assert res.k_selected >= 1


# ---------------------------------------------------------------------------
# misc API behaviors
# ---------------------------------------------------------------------------

def test_scale_auto_enables_center(lowrank):
    res = rt.svd(lowrank, 3, method="deflation", scale=True, seed=1)
    assert res.misc.get("center") is not None or "row_sds" in res.misc \
        or res.misc.get("frobenius_norm_sq") == float(
            lowrank.shape[0] * lowrank.shape[1])


def test_deflation_orthogonal_uv(lowrank):
    res = rt.svd(lowrank, 4, method="deflation", seed=1)
    U = np.asarray(res.U)
    V = np.asarray(res.V)
    np.testing.assert_allclose(U.T @ U, np.eye(4), atol=2e-2)
    np.testing.assert_allclose(V.T @ V, np.eye(4), atol=2e-2)


def test_variance_explained_decreasing(lowrank):
    res = rt.svd(lowrank, 4, method="lanczos", seed=1)
    ve = np.asarray(res.variance_explained())
    assert (np.diff(ve) <= 1e-9).all()
    assert ve.sum() <= 1.0 + 1e-6


def test_k1_works(lowrank):
    for method in ("lanczos", "deflation", "randomized"):
        res = rt.svd(lowrank, 1, method=method, seed=1)
        assert np.asarray(res.U).shape == (60, 1)
        s1 = float(np.linalg.svd(lowrank, compute_uv=False)[0])
        np.testing.assert_allclose(float(np.asarray(res.d)[0]), s1,
                                   rtol=1e-2)


def test_invalid_inputs_rejected(lowrank):
    with pytest.raises(ValueError):
        rt.svd(lowrank, 3, method="bogus")
    with pytest.raises(ValueError):
        bad = lowrank.copy()
        bad[0, 0] = np.nan
        rt.svd(bad, 3)


def test_different_seeds_differ():
    rs = np.random.RandomState(5)
    A = rs.rand(50, 40).astype(np.float32)  # full-rank noise
    r1 = rt.svd(A, 3, method="randomized", seed=1, power_iters=0)
    r2 = rt.svd(A, 3, method="randomized", seed=99, power_iters=0)
    assert not np.array_equal(np.asarray(r1.U), np.asarray(r2.U))


def test_svd_preserves_dimnames(lowrank):
    import pandas as pd
    rn = [f"g{i}" for i in range(60)]
    cn = [f"s{j}" for j in range(45)]
    wrapped = pd.DataFrame(np.asarray(lowrank), index=rn, columns=cn)
    res = rt.svd(wrapped, 3, method="lanczos", seed=1)
    assert list(res.row_names) == rn
    assert list(res.col_names) == cn


# ---------------------------------------------------------------------------
# cross-method agreement + combined constraints (test_svd.R:119-228,452-464)
# ---------------------------------------------------------------------------

def test_krylov_agrees_with_deflation(lowrank):
    kk = rt.svd(lowrank, 3, method="krylov", seed=1)
    dd = rt.svd(lowrank, 3, method="deflation", seed=1)
    np.testing.assert_allclose(np.asarray(kk.d), np.asarray(dd.d),
                               rtol=5e-2)


def test_krylov_combined_nonneg_l1(lowrank):
    A = np.abs(lowrank)
    res = rt.svd(A, 3, method="krylov", nonneg=(True, True),
                 L1=(0.0, 0.05), seed=1)
    assert (np.asarray(res.U) >= -1e-6).all()
    assert (np.asarray(res.V) >= -1e-6).all()
    plain = rt.svd(A, 3, method="krylov", nonneg=(True, True), seed=1)
    assert (np.asarray(res.V) == 0).mean() >= (np.asarray(plain.V) == 0).mean()


def test_krylov_deflation_nonneg_quality_comparable(lowrank):
    A = np.abs(lowrank)
    def resid(r):
        rec = np.asarray(r.U) * np.asarray(r.d) @ np.asarray(r.V).T
        return np.linalg.norm(A - rec) / np.linalg.norm(A)
    rk = resid(rt.svd(A, 3, method="krylov", nonneg=(True, True), seed=1))
    rd = resid(rt.svd(A, 3, method="deflation", nonneg=(True, True), seed=1))
    assert rk < 1.5 * rd + 0.05


def test_scale_sparse_dense_agree(A_sparse):
    ds = rt.svd(A_sparse, 3, method="lanczos", scale=True, seed=1)
    dd = rt.svd(np.asarray(A_sparse.todense(), dtype=np.float32), 3,
                method="lanczos", scale=True, seed=1)
    np.testing.assert_allclose(np.asarray(ds.d), np.asarray(dd.d),
                               rtol=1e-4)


def test_scale_multiple_methods(lowrank):
    ref = None
    for method in ("lanczos", "randomized", "deflation"):
        r = rt.svd(lowrank, 3, method=method, scale=True, seed=1,
                   power_iters=6)
        assert np.isfinite(np.asarray(r.d)).all()
        if ref is None:
            ref = np.asarray(r.d)
        else:
            np.testing.assert_allclose(np.asarray(r.d), ref, rtol=5e-2)


def test_unknown_dot_parameter_rejected(lowrank):
    """The reference rejects unknown svd() dot-args (R/parse_dots.R:124-131);
    a typo like power_iterations= must never be swallowed silently."""
    with pytest.raises(ValueError, match="unknown parameter"):
        rt.svd(lowrank, 3, power_iterations=8)
    with pytest.raises(ValueError, match="unknown parameter"):
        rt.svd(lowrank, 3, bogus=True)


def test_auto_rank_k_max_cap(lowrank):
    """k='auto' searches up to k_max (R/svd.R:181 ``k <- k_max``)."""
    res = rt.svd(lowrank, "auto", k_max=2, patience=1)
    assert np.asarray(res.d).shape[0] <= 2
    # threads/resource accepted for R compatibility (single JAX path)
    res2 = rt.svd(lowrank, 3, threads=4, resource="auto")
    assert np.isfinite(np.asarray(res2.d)).all()
