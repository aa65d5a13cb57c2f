"""SVD/PCA projection, reconstruction, and out-of-sample prediction
(reference: tests/testthat/test_project_svd.R; predict.svd semantics from
R/svd_methods.R:141-174).
"""

import numpy as np
import pytest

import rcppml_tpu as rt

pytestmark = pytest.mark.numerics  # numerics-critical subset


@pytest.fixture(scope="module")
def iris_like():
    """150x4 matrix with strong low-rank structure, like iris[, 1:4]."""
    rs = np.random.RandomState(42)
    scores = rs.randn(150, 2)
    loadings = rs.rand(2, 4) * 3 + 1
    A = scores @ loadings + rs.randn(150, 4) * 0.2 + 5.0
    return np.abs(A).astype(np.float32)


def test_pca_reconstruction_and_scores(iris_like):
    # test_project_svd.R:24-38 — 3 factors explain most of the data
    s = rt.pca(iris_like, k=3, method="deflation", seed=1, maxit=200,
               tol=1e-8)
    mse = float(np.mean((iris_like - np.asarray(s.reconstruct())) ** 2))
    assert mse < 1.0
    scores = np.asarray(s.U) * np.asarray(s.d)[None, :]
    assert scores.shape == (150, 3)


def test_pca_stores_row_means(iris_like):
    # test_project_svd.R:40-46 — centered model keeps the row means
    s = rt.pca(iris_like, k=3, method="deflation", seed=1, maxit=200,
               tol=1e-8)
    assert s.center is not None
    assert np.asarray(s.center).shape == (iris_like.shape[0],)
    np.testing.assert_allclose(np.asarray(s.center),
                               iris_like.mean(axis=1), rtol=1e-5)


def test_pca_full_rank_inverts(iris_like):
    # test_project_svd.R:48-55 — k=4 on 4 columns reconstructs ~perfectly
    s = rt.pca(iris_like, k=4, method="deflation", seed=1, maxit=200,
               tol=1e-8)
    mse = float(np.mean((iris_like - np.asarray(s.reconstruct())) ** 2))
    assert mse < 0.01


def test_svd_uncentered_reconstruction():
    # test_project_svd.R:57-66
    rs = np.random.RandomState(99)
    A = np.abs(rs.randn(60, 40)).astype(np.float32)
    s = rt.svd(A, 10, method="deflation", seed=1, maxit=200, tol=1e-6)
    rec = np.asarray(s.reconstruct())
    assert float(((A - rec) ** 2).sum() / (A ** 2).sum()) < 0.5


def test_predict_training_rows_recover_scores(iris_like):
    """predict on the training data returns the left factors U
    (R/svd_methods.R:141-174: scores = X @ V / d)."""
    s = rt.svd(iris_like, 3, method="lanczos", seed=1)
    proj = s.predict(iris_like)
    assert proj.shape == (150, 3)
    # U and the projection may differ in sign per factor
    for j in range(3):
        u = np.asarray(s.U)[:, j]
        p = proj[:, j]
        assert min(np.abs(u - p).max(), np.abs(u + p).max()) < 1e-2


def test_predict_new_rows_finite_and_shaped(iris_like):
    s = rt.pca(iris_like, k=2, method="lanczos", seed=1)
    rs = np.random.RandomState(7)
    new = np.abs(rs.randn(9, 4)).astype(np.float32)
    proj = s.predict(new)
    assert proj.shape == (9, 2)
    assert np.isfinite(proj).all()


def test_predict_wrong_width_errors(iris_like):
    s = rt.svd(iris_like, 2, method="lanczos", seed=1)
    with pytest.raises(ValueError):
        s.predict(np.zeros((5, 7), dtype=np.float32))
