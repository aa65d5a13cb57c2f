"""norm= parameter behaviors (reference: test_norm.R, 16 blocks).

The factor model is A ~ W diag(d) H with W columns and H rows
normalized under the chosen norm and d carrying the scale
(core/types.hpp:99-107).
"""

import numpy as np
import pytest
import scipy.sparse as sp

pytestmark = pytest.mark.numerics  # numerics-critical subset

import rcppml_tpu as rt

K = 3


@pytest.fixture(scope="module")
def A_sparse():
    rs = np.random.RandomState(42)
    A = sp.random(50, 30, density=0.3, random_state=rs, format="csc")
    A.data = np.abs(A.data)
    return A


@pytest.fixture(scope="module")
def A_dense(A_sparse):
    return np.asarray(A_sparse.todense(), dtype=np.float32)


def test_accepts_all_three_norms(A_sparse):
    for norm in ("L1", "L2", "none"):
        res = rt.nmf(A_sparse, K, maxit=5, norm=norm, seed=1)
        assert np.isfinite(res.train_loss)


def test_rejects_invalid_norm(A_sparse):
    with pytest.raises(ValueError):
        rt.nmf(A_sparse, K, maxit=5, norm="L3", seed=1)


def test_default_norm_is_l1(A_sparse):
    m_def = rt.nmf(A_sparse, K, maxit=10, seed=1)
    m_l1 = rt.nmf(A_sparse, K, maxit=10, norm="L1", seed=1)
    np.testing.assert_array_equal(np.asarray(m_def.W), np.asarray(m_l1.W))
    np.testing.assert_array_equal(np.asarray(m_def.d), np.asarray(m_l1.d))
    np.testing.assert_array_equal(np.asarray(m_def.H), np.asarray(m_l1.H))


def test_l1_unit_columns_and_rows(A_sparse):
    m = rt.nmf(A_sparse, K, maxit=50, norm="L1", seed=1)
    np.testing.assert_allclose(np.abs(np.asarray(m.W)).sum(axis=0),
                               1.0, rtol=1e-4)
    np.testing.assert_allclose(np.abs(np.asarray(m.H)).sum(axis=1),
                               1.0, rtol=1e-4)


def test_l2_unit_columns_and_rows(A_sparse):
    m = rt.nmf(A_sparse, K, maxit=50, norm="L2", seed=1)
    np.testing.assert_allclose(
        np.sqrt((np.asarray(m.W) ** 2).sum(axis=0)), 1.0, rtol=1e-4)
    np.testing.assert_allclose(
        np.sqrt((np.asarray(m.H) ** 2).sum(axis=1)), 1.0, rtol=1e-4)


def test_none_norm_d_all_ones(A_sparse):
    m = rt.nmf(A_sparse, K, maxit=50, norm="none", seed=1)
    np.testing.assert_allclose(np.asarray(m.d), 1.0, atol=1e-6)


def test_reconstruction_similar_across_norms(A_sparse):
    recon = {}
    for norm in ("L1", "L2", "none"):
        m = rt.nmf(A_sparse, K, maxit=30, norm=norm, seed=1, tol=1e-10)
        recon[norm] = m.reconstruct()
    ref = np.linalg.norm(recon["L1"])
    assert np.linalg.norm(recon["L1"] - recon["L2"]) / ref < 0.5
    assert np.linalg.norm(recon["L1"] - recon["none"]) / ref < 0.5


def test_all_norms_dense_input(A_dense):
    for norm in ("L1", "L2", "none"):
        res = rt.nmf(A_dense, K, maxit=10, norm=norm, seed=1)
        assert np.isfinite(res.train_loss)


@pytest.mark.parametrize("norm", ["L1", "L2", "none"])
def test_converges_with_each_norm(A_sparse, norm):
    m1 = rt.nmf(A_sparse, K, maxit=1, norm=norm, seed=1, tol=1e-10)
    m50 = rt.nmf(A_sparse, K, maxit=50, norm=norm, seed=1, tol=1e-10)
    A = np.asarray(A_sparse.todense())
    sse1 = float(((A - m1.reconstruct()) ** 2).sum())
    sse50 = float(((A - m50.reconstruct()) ** 2).sum())
    assert sse50 < sse1


@pytest.mark.parametrize("norm", ["L1", "L2", "none"])
def test_seed_reproducible_per_norm(A_sparse, norm):
    m1 = rt.nmf(A_sparse, K, maxit=5, norm=norm, seed=1)
    m2 = rt.nmf(A_sparse, K, maxit=5, norm=norm, seed=1)
    np.testing.assert_array_equal(np.asarray(m1.W), np.asarray(m2.W))
    np.testing.assert_array_equal(np.asarray(m1.d), np.asarray(m2.d))
    np.testing.assert_array_equal(np.asarray(m1.H), np.asarray(m2.H))


def test_different_norms_different_d(A_sparse):
    d = {norm: np.asarray(rt.nmf(A_sparse, K, maxit=20, norm=norm,
                                 seed=1).d)
         for norm in ("L1", "L2", "none")}
    assert not np.allclose(d["L1"], d["L2"], atol=1e-8)
    assert not np.allclose(d["L1"], d["none"], atol=1e-8)


@pytest.mark.parametrize("norm", ["L1", "L2", "none"])
def test_cv_works_with_each_norm(A_sparse, norm):
    cv = rt.nmf(A_sparse, [2, 3], test_fraction=0.1, cv_seed=1,
                norm=norm, seed=1, maxit=10)
    # multi-rank sweep returns the CV table (R data.frame analog)
    ks = sorted({row["k"] for row in cv})
    assert ks == [2, 3]
    assert all(np.isfinite(row["test_mse"]) for row in cv)
