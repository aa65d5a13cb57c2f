"""SVD algorithm tests (reference: tests/testthat/test_svd.R, 749 LoC).

Every algorithm's singular values are checked against numpy's exact SVD.
"""

import numpy as np
import pytest

from rcppml_tpu.models.svd import (deflation_svd, irlba_svd, krylov_svd,
                                   lanczos_svd, pca, randomized_svd, svd)
from rcppml_tpu.config import SVDConfig, FactorConfig
import rcppml_tpu as rt

pytestmark = pytest.mark.numerics  # numerics-critical subset


@pytest.fixture(scope="module")
def lowrank():
    rs = np.random.RandomState(7)
    U = rs.normal(size=(120, 8))
    V = rs.normal(size=(90, 8))
    s = np.array([50, 30, 20, 10, 5, 3, 2, 1.0])
    A = (U * s) @ V.T + 0.01 * rs.normal(size=(120, 90))
    return A.astype(np.float32)


def _exact_svals(A, k):
    return np.linalg.svd(np.asarray(A, np.float64), compute_uv=False)[:k]


def test_lanczos_svals(lowrank):
    k = 5
    res = lanczos_svd(lowrank, SVDConfig(k=k, seed=1))
    np.testing.assert_allclose(res.d, _exact_svals(lowrank, k), rtol=1e-3)
    # orthonormality
    np.testing.assert_allclose(res.U.T @ res.U, np.eye(k), atol=1e-3)
    np.testing.assert_allclose(res.V.T @ res.V, np.eye(k), atol=1e-3)


def test_randomized_svals(lowrank):
    k = 5
    res = randomized_svd(lowrank, SVDConfig(k=k, seed=1, power_iters=3))
    np.testing.assert_allclose(res.d, _exact_svals(lowrank, k), rtol=1e-2)


def test_irlba_svals(lowrank):
    k = 5
    res = irlba_svd(lowrank, SVDConfig(k=k, seed=1))
    np.testing.assert_allclose(res.d, _exact_svals(lowrank, k), rtol=1e-3)


def test_deflation_svals(lowrank):
    k = 4
    res = deflation_svd(lowrank, SVDConfig(k=k, seed=1, tol=1e-7))
    np.testing.assert_allclose(res.d, _exact_svals(lowrank, k), rtol=2e-2)


def test_reconstruction_quality(lowrank):
    res = lanczos_svd(lowrank, SVDConfig(k=8, seed=1))
    rec = res.reconstruct()
    rel = np.linalg.norm(rec - lowrank) / np.linalg.norm(lowrank)
    assert rel < 0.02


def test_pca_centering(lowrank):
    res = pca(lowrank, 4, center=True)
    assert res.center is not None
    # centered reconstruction must beat uncentered on centered data
    ve = res.variance_explained()
    assert ve.sum() <= 1.0 + 1e-6
    assert (np.diff(np.asarray(res.d)) <= 1e-5).all()


def test_center_matches_explicit(lowrank):
    """Implicit centering equals SVD of the explicitly centered matrix."""
    k = 3
    res = lanczos_svd(lowrank, SVDConfig(k=k, seed=1, center=True))
    Ac = lowrank - lowrank.mean(axis=1, keepdims=True)
    np.testing.assert_allclose(res.d, _exact_svals(Ac, k), rtol=1e-3)


def test_nonneg_constrained(lowrank):
    A = np.abs(lowrank)
    res = svd(A, 4, method="krylov", nonneg=(True, True), seed=1)
    assert (res.U >= 0).all()
    assert (res.V >= 0).all()
    rec = res.reconstruct()
    rel = np.linalg.norm(rec - A) / np.linalg.norm(A)
    assert rel < 0.5


def test_sparse_l1(lowrank):
    res_plain = svd(lowrank, 4, method="krylov", L1=(0.0, 0.0), seed=1)
    res_l1 = svd(lowrank, 4, method="krylov", L1=(0.0, 2.0), seed=1)
    # L1 on v should increase sparsity of V
    assert (res_l1.V == 0).mean() >= (res_plain.V == 0).mean()


def test_auto_method_select(lowrank):
    res = svd(lowrank, 4, method="auto", seed=1)
    assert res.misc["method"] == "lanczos"
    res2 = svd(lowrank, 40, method="auto", seed=1)
    assert res2.misc["method"] == "randomized"


def test_deflation_auto_rank():
    rs = np.random.RandomState(3)
    U = rs.normal(size=(80, 3))
    V = rs.normal(size=(70, 3))
    A = ((U * [40, 25, 12]) @ V.T + 0.5 * rs.normal(size=(80, 70))).astype(np.float32)
    res = svd(A, "auto", seed=1)
    assert 1 <= res.k_selected <= 10


def test_robust_deflation_resists_outliers():
    """Huber IRLS downweights planted outliers (deflation.hpp:55-166): the
    robust leading factor must track the CLEAN matrix's factor while the
    non-robust fit is visibly corrupted.  This test fails if robust= is a
    no-op."""
    rs = np.random.RandomState(7)
    U = rs.normal(size=(120, 2))
    V = rs.normal(size=(90, 2))
    A_clean = ((U * [30.0, 12.0]) @ V.T).astype(np.float32)
    u_clean = np.linalg.svd(A_clean, full_matrices=False)[0][:, 0]

    A = A_clean.copy()
    # heavy sparse corruption concentrated in a few entries
    idx = rs.choice(A.size, size=40, replace=False)
    A.flat[idx] += rs.choice([-1.0, 1.0], size=40).astype(np.float32) * 2000.0

    rob = svd(A, 2, method="deflation", robust=True, seed=1)
    plain = svd(A, 2, method="deflation", robust=False, seed=1)
    err_rob = 1.0 - abs(float(np.dot(rob.U[:, 0], u_clean)))
    err_plain = 1.0 - abs(float(np.dot(plain.U[:, 0], u_clean)))
    assert err_rob < 0.02, f"robust factor off clean subspace: {err_rob}"
    assert err_plain > 0.1, "corruption no longer corrupts the plain fit"
    assert err_rob < 0.1 * err_plain, (
        f"robust ({err_rob}) not better than non-robust ({err_plain})")


def test_robust_deflation_clean_data_matches_plain(lowrank):
    """On outlier-free data the Huber weights saturate at 1 and robust
    factors must agree with the plain deflation factors."""
    rob = svd(lowrank, 3, method="deflation", robust=True, seed=1)
    plain = svd(lowrank, 3, method="deflation", robust=False, seed=1)
    np.testing.assert_allclose(rob.d, plain.d, rtol=2e-2)
    for j in range(3):
        assert abs(float(np.dot(rob.U[:, j], plain.U[:, j]))) > 0.98


def test_seed_reproducible(lowrank):
    r1 = randomized_svd(lowrank, SVDConfig(k=4, seed=9))
    r2 = randomized_svd(lowrank, SVDConfig(k=4, seed=9))
    np.testing.assert_array_equal(r1.d, r2.d)


def test_streaming_svd_matches_in_memory(lowrank, tmp_path):
    """Streaming SVD over panels equals the in-memory factorization
    (test_streaming_svd_cv.R analog)."""
    from rcppml_tpu.models.svd import streaming_svd
    from rcppml_tpu.io.loaders import InMemoryLoader
    mem = randomized_svd(lowrank, SVDConfig(k=4, seed=2, power_iters=3))
    stream = streaming_svd(InMemoryLoader(lowrank, chunk_cols=32), 4,
                           method="randomized", seed=2, power_iters=3)
    np.testing.assert_allclose(stream.d, mem.d, rtol=1e-4)
    # subspaces agree up to sign
    cos = np.abs(np.sum(stream.U * mem.U, axis=0))
    assert (cos > 0.999).all()


def test_streaming_svd_lanczos(lowrank):
    from rcppml_tpu.models.svd import streaming_svd
    from rcppml_tpu.io.loaders import InMemoryLoader
    res = streaming_svd(InMemoryLoader(lowrank, chunk_cols=32), 4,
                        method="lanczos", seed=1)
    exact = _exact_svals(lowrank, 4)
    np.testing.assert_allclose(res.d, exact, rtol=1e-3)


def test_streaming_svd_from_spz(lowrank, tmp_path):
    from rcppml_tpu.io.spz import st_write_dense
    path = str(tmp_path / "svd.spz")
    st_write_dense(lowrank, path, chunk_cols=32)
    res = svd(path, 4, method="randomized", seed=1, power_iters=3)
    np.testing.assert_allclose(res.d, _exact_svals(lowrank, 4), rtol=1e-2)


def test_streaming_svd_centered(lowrank):
    from rcppml_tpu.models.svd import streaming_svd
    from rcppml_tpu.io.loaders import InMemoryLoader
    res = streaming_svd(InMemoryLoader(lowrank, chunk_cols=32), 3,
                        method="randomized", center=True, seed=1,
                        power_iters=3)
    Ac = lowrank - lowrank.mean(axis=1, keepdims=True)
    np.testing.assert_allclose(res.d, _exact_svals(Ac, 3), rtol=1e-2)


def test_svd_cv_krylov_heldout_aware(lowrank):
    """Krylov CV is held-out-aware (svd/krylov.hpp:397-414 + test_entries):
    train on the zeroed matrix with the (1 - f) denominator correction and
    select rank by exact per-entry test MSE with patience."""
    res = svd(lowrank, 12, method="krylov", test_fraction=0.1,
              cv_seed=3, seed=1)
    assert np.isfinite(res.test_loss)
    traj = res.misc["test_loss_trajectory"]
    assert len(traj) >= res.k_selected
    # the selected rank minimizes the trajectory and truncates the factors
    assert res.k_selected == int(np.argmin(traj)) + 1
    assert res.U.shape[1] == res.d.shape[0] == res.k_selected
    assert res.test_loss == pytest.approx(min(traj))
    # data has 8 planted components over noise at 0.01: strong ones must
    # survive selection, and the holdout must reject clear overfit ranks
    assert 4 <= res.k_selected <= 12


def test_svd_cv_denominator_correction_unbiases(lowrank):
    """Without the 1-f Gram correction, singular values trained on the
    zeroed matrix shrink by ~(1 - f); with it they match the full-data
    scale (deflation.hpp:547-556 rationale)."""
    ref = _exact_svals(lowrank, 3)
    res = svd(lowrank, 8, method="krylov", test_fraction=0.2,
              cv_seed=5, seed=1)
    # corrected: within a few percent of the true scale
    np.testing.assert_allclose(res.d[:3], ref, rtol=0.05)
    # uncorrected comparison: plain lanczos on the zeroed matrix shrinks
    from rcppml_tpu import rng as rng_mod
    M = rng_mod.holdout_mask(5, *lowrank.shape, int(1 / 0.2))
    shrunk = svd(lowrank * (~M), 3, method="lanczos", seed=1).d
    assert np.all(shrunk < ref * 0.9)


def test_svd_cv_nonsupporting_method_warns(lowrank):
    """Reference restricts CV to deflation/krylov (R/svd.R:284,313); other
    methods drop test_fraction — loudly here, silently in R."""
    with pytest.warns(UserWarning, match="does not support cross-validation"):
        res = svd(lowrank, 4, method="lanczos", test_fraction=0.1, seed=1)
    assert np.isnan(res.test_loss)


def test_svd_cv_auto_method_resolves_heldout_capable(lowrank):
    """method='auto' with CV resolves to a held-out-aware solver
    (R/svd.R:383: deflation)."""
    res = svd(lowrank, 6, method="auto", test_fraction=0.1, cv_seed=2, seed=1)
    assert np.isfinite(res.test_loss)
    assert len(res.misc["test_loss_trajectory"]) >= 1


def test_svd_sparse_input():
    import scipy.sparse as sp
    rs = np.random.RandomState(9)
    A = sp.random(60, 40, density=0.2, random_state=rs, format="csc")
    res = svd(A, 4, method="lanczos", seed=1)
    np.testing.assert_allclose(
        res.d, np.linalg.svd(A.toarray(), compute_uv=False)[:4], rtol=1e-3)
    res2 = svd(A, 4, method="deflation", seed=1)
    assert np.isfinite(res2.d).all()


def test_svd_predict_new_samples(lowrank):
    """predict() projects new samples onto V (R/svd_methods.R:141-174):
    predicting the training rows recovers U."""
    res = lanczos_svd(lowrank, SVDConfig(k=4, seed=1))
    scores = res.predict(lowrank)          # rows of A are "samples"
    np.testing.assert_allclose(scores, np.asarray(res.U), atol=1e-3)
    with pytest.raises(ValueError, match="features"):
        res.predict(np.zeros((3, 7), np.float32))


# ---------------------------------------------------------------------------
# Streaming = in-memory parity for the remaining algorithms (the reference
# streams all five, svd/streaming.hpp:77+; round-1 covered only
# randomized + lanczos)
# ---------------------------------------------------------------------------

def _stream_loader(A, cols=32):
    from rcppml_tpu.io.loaders import InMemoryLoader
    return InMemoryLoader(A, chunk_cols=cols)


def test_streaming_irlba_matches_in_memory(lowrank):
    from rcppml_tpu.models.svd import irlba_svd, streaming_svd
    mem = irlba_svd(lowrank, SVDConfig(k=4, seed=2))
    stream = streaming_svd(_stream_loader(lowrank), 4, method="irlba", seed=2)
    np.testing.assert_allclose(stream.d, mem.d, rtol=1e-3)
    for j in range(4):
        assert abs(float(np.dot(stream.U[:, j], mem.U[:, j]))) > 0.99


def test_streaming_krylov_matches_in_memory(lowrank):
    from rcppml_tpu.models.svd import krylov_svd, streaming_svd
    A = np.abs(lowrank)
    cfg = SVDConfig(k=4, seed=2)
    from rcppml_tpu.config import FactorConfig as FC
    cfg = SVDConfig(k=4, seed=2, u=FC(nonneg=True), v=FC(nonneg=True))
    mem = krylov_svd(A, cfg)
    stream = streaming_svd(_stream_loader(A), 4, method="krylov", seed=2,
                           nonneg=(True, True))
    np.testing.assert_allclose(stream.d, mem.d, rtol=1e-3)
    assert (stream.U >= 0).all() and (stream.V >= 0).all()


def test_streaming_deflation_matches_in_memory(lowrank):
    from rcppml_tpu.models.svd import deflation_svd, streaming_svd
    mem = deflation_svd(lowrank, SVDConfig(k=3, seed=2))
    stream = streaming_svd(_stream_loader(lowrank), 3, method="deflation",
                           seed=2)
    np.testing.assert_allclose(stream.d, mem.d, rtol=2e-3)
    for j in range(3):
        assert abs(float(np.dot(stream.U[:, j], mem.U[:, j]))) > 0.99


def test_streaming_deflation_robust():
    """Robust streaming deflation = robust in-memory deflation (same Huber
    IRLS math through chunked matvecs), and both resist planted outliers."""
    from rcppml_tpu.models.svd import deflation_svd, streaming_svd
    rs = np.random.RandomState(7)
    U = rs.normal(size=(120, 2))
    V = rs.normal(size=(90, 2))
    A_clean = ((U * [30.0, 12.0]) @ V.T).astype(np.float32)
    u_clean = np.linalg.svd(A_clean, full_matrices=False)[0][:, 0]
    A = A_clean.copy()
    idx = rs.choice(A.size, size=40, replace=False)
    A.flat[idx] += rs.choice([-1.0, 1.0], size=40).astype(np.float32) * 2000.0

    stream = streaming_svd(_stream_loader(A), 2, method="deflation", seed=1,
                           robust=True)
    mem = deflation_svd(A, SVDConfig(k=2, seed=1, robust_delta=1.345))
    err_stream = 1.0 - abs(float(np.dot(stream.U[:, 0], u_clean)))
    err_mem = 1.0 - abs(float(np.dot(mem.U[:, 0], u_clean)))
    assert err_stream < 0.02, f"streaming robust off clean: {err_stream}"
    assert err_mem < 0.02
    assert abs(float(np.dot(stream.U[:, 0], mem.U[:, 0]))) > 0.99
    # sigma on corrupted data is trajectory-sensitive (stopping iteration
    # differs between the jitted and host loops) — coarse agreement only
    np.testing.assert_allclose(stream.d, mem.d, rtol=0.1)


def test_streaming_spz_svd_all_methods(tmp_path, lowrank):
    """svd('file.spz', method=...) round-trips through the codec for every
    streaming algorithm."""
    import scipy.sparse as sp
    from rcppml_tpu.io.spz import st_write
    from rcppml_tpu.models.svd import svd as svd_fn
    A = lowrank.copy()
    A[np.abs(A) < 0.5] = 0.0               # sparsify for the codec
    path = str(tmp_path / "m.spz")
    st_write(sp.csc_matrix(A), path, with_transpose=True)
    ref = np.linalg.svd(A, full_matrices=False)[1][:3]
    for meth in ["randomized", "lanczos", "irlba", "deflation"]:
        res = svd_fn(path, 3, method=meth, seed=3)
        np.testing.assert_allclose(res.d, ref, rtol=2e-2), meth


def test_svd_scale_standardizes():
    """scale=True auto-enables centering and matches numpy SVD of the
    row-standardized matrix across methods (test_svd.R:366-465)."""
    rs = np.random.RandomState(4)
    A = (rs.rand(40, 25) * np.linspace(1, 20, 40)[:, None]).astype(np.float32)
    mu = A.mean(axis=1, keepdims=True)
    sd = A.std(axis=1, keepdims=True)
    s_ref = np.linalg.svd((A - mu) / sd, compute_uv=False)[:4]
    for method in ("lanczos", "randomized", "deflation", "krylov"):
        res = rt.svd(A, 4, method=method, scale=True, seed=1)
        np.testing.assert_allclose(np.asarray(res.d), s_ref, rtol=2e-2)
        assert res.scale is not None and res.center is not None
        np.testing.assert_allclose(np.asarray(res.scale), sd.ravel(),
                                   rtol=1e-4)


def test_svd_scale_frobenius_equals_mn():
    # test_svd.R:433-439
    rs = np.random.RandomState(5)
    A = rs.rand(30, 20).astype(np.float32)
    res = rt.svd(A, 3, method="lanczos", scale=True, seed=1)
    assert res.misc["frobenius_norm_sq"] == 30 * 20


def test_svd_scale_reconstruct_roundtrip():
    rs = np.random.RandomState(6)
    A = rs.rand(25, 18).astype(np.float32)
    res = rt.svd(A, min(25, 18), method="lanczos", scale=True, seed=1)
    np.testing.assert_allclose(res.reconstruct(), A, atol=1e-3)


def test_variance_explained_total_variance():
    """d_i^2 / ||A||_F^2 — decreasing, positive, sums <= 1
    (test_svd.R:247-256,466-479)."""
    rs = np.random.RandomState(7)
    A = rs.rand(40, 30).astype(np.float32)
    res = rt.svd(A, 5, method="lanczos", seed=1)
    ve = res.variance_explained()
    assert len(ve) == 5
    assert np.all(ve > 0) and np.all(ve <= 1)
    assert np.all(np.diff(ve) <= 1e-7)
    assert ve.sum() <= 1 + 1e-6
    # scaled: denominator is exactly m*n
    res_s = rt.svd(A, 5, method="lanczos", scale=True, seed=1)
    ves = res_s.variance_explained()
    assert ves.sum() <= 1 + 1e-6


def _chain_laplacian(n):
    L = np.zeros((n, n), np.float32)
    for i in range(n):
        if i > 0:
            L[i, i] += 1; L[i, i - 1] -= 1
        if i < n - 1:
            L[i, i] += 1; L[i, i + 1] -= 1
    return L


def test_svd_graph_reg_smooths_deflation():
    """graph_V Laplacian smooths v along the chain (deflation.hpp:283-292)."""
    rs = np.random.RandomState(8)
    A = (rs.rand(30, 40) + np.sin(np.arange(40) / 3)[None, :]).astype(np.float32)
    L = _chain_laplacian(40)
    plain = rt.svd(A, 3, method="deflation", seed=1)
    # explicit gradient step: stable for lambda * eig(L) < 2 (chain
    # Laplacian eigs <= 4), same stability region as the reference's
    # v -= (lambda/norm_sq) L v
    reg = rt.svd(A, 3, method="deflation", graph_V=L,
                 graph_lambda=(0.0, 0.3), seed=1)

    def rough(V):
        v = np.asarray(V)
        return float(np.sum(np.diff(v, axis=0) ** 2))
    assert rough(reg.V) < rough(plain.V)


def test_svd_graph_reg_smooths_krylov():
    rs = np.random.RandomState(9)
    A = np.abs(rs.rand(30, 40)).astype(np.float32)
    L = _chain_laplacian(40)
    plain = rt.svd(A, 3, method="krylov", nonneg=(True, True), seed=1)
    reg = rt.svd(A, 3, method="krylov", nonneg=(True, True), graph_V=L,
                 graph_lambda=(0.0, 5.0), seed=1)

    def rough(V):
        return float(np.sum(np.diff(np.asarray(V), axis=0) ** 2))
    assert rough(reg.V) < rough(plain.V)


def test_svd_angular_decorrelates():
    """angular pushes factors apart: projection vs prior factors in
    deflation (deflation.hpp:256-267); Gram-level in krylov
    (features/angular.hpp:42-66, runs without degrading)."""
    rs = np.random.RandomState(10)
    base = np.abs(rs.rand(40, 1))
    A = (base @ np.abs(rs.rand(1, 30)) +
         0.3 * np.abs(rs.rand(40, 30))).astype(np.float32)

    def max_cos(U):
        u = np.asarray(U)
        u = u / np.maximum(np.linalg.norm(u, axis=0), 1e-15)
        C = np.abs(u.T @ u) - np.eye(u.shape[1])
        return float(C.max())
    plain = rt.svd(A, 3, method="deflation", nonneg=(True, True), seed=1)
    ang = rt.svd(A, 3, method="deflation", nonneg=(True, True),
                 angular=(0.3, 0.3), seed=1)
    assert max_cos(ang.U) < max_cos(plain.U)
    kry = rt.svd(A, 3, method="krylov", nonneg=(True, True),
                 angular=(0.3, 0.3), seed=1)
    assert np.all(np.isfinite(np.asarray(kry.U)))


def test_svd_l21_krylov_zeroes_components():
    """L21 drives weak components to zero in the krylov solve
    (features/L21.hpp:51-63) — previously accepted but ignored."""
    rs = np.random.RandomState(11)
    A = np.abs(rs.rand(40, 30)).astype(np.float32)
    plain = rt.svd(A, 5, method="krylov", nonneg=(True, True), seed=1)
    reg = rt.svd(A, 5, method="krylov", nonneg=(True, True),
                 L21=(40.0, 40.0), seed=1)
    assert float(np.asarray(reg.d)[-1]) < float(np.asarray(plain.d)[-1])


def test_svd_tier2_unsupported_method_warns():
    rs = np.random.RandomState(12)
    A = rs.rand(20, 15).astype(np.float32)
    with pytest.warns(UserWarning, match="angular"):
        rt.svd(A, 3, method="randomized", angular=(0.5, 0.5), seed=1)


def test_svd_result_methods():
    """dim/head/subsetting on svd results (test_svd.R:258-288)."""
    rs = np.random.RandomState(13)
    A = rs.rand(20, 15).astype(np.float32)
    res = rt.svd(A, 5, method="lanczos", seed=1)
    assert res.shape == (20, 15)
    assert res.head(4).shape == (4, 5)
    sub = res[[0, 2]]
    assert sub.k == 2
    np.testing.assert_array_equal(np.asarray(sub.d),
                                  np.asarray(res.d)[[0, 2]])
    assert repr(res).startswith("SVDResult")


def test_svd_scale_cv_rank_selection():
    """scale=True + CV evaluates held-out residuals in standardized
    units — rank selection must see improvement past k=1 (regression:
    unit mismatch made test MSE increase monotonically)."""
    rs = np.random.RandomState(21)
    U = rs.normal(size=(80, 4))
    V = rs.normal(size=(60, 4))
    A = (((U * [40, 25, 12, 6]) @ V.T + 0.1 * rs.normal(size=(80, 60)))
         * np.linspace(1, 1000, 80)[:, None]).astype(np.float32)
    res = rt.svd(A, 8, method="deflation", scale=True, test_fraction=0.1,
                 seed=1)
    traj = res.misc["test_loss_trajectory"]
    assert res.k_selected >= 3
    assert traj[res.k_selected - 1] < traj[0]
    res_k = rt.svd(A, 8, method="krylov", nonneg=(False, False), L2=(0.01, 0.01),
                   scale=True, test_fraction=0.1, seed=1)
    assert res_k.k_selected >= 3


def test_svd_cv_noninteger_inverse_fraction_unbiased():
    """cv_corr must match the actual 1/inv_prob holdout probability
    (regression: used 1-test_fraction).  The train-matrix sigma is
    attenuated by exactly (1 - 1/inv_prob); with the matching correction
    the singular vectors stay aligned with the clean factors."""
    rs = np.random.RandomState(22)
    U = rs.normal(size=(100, 3))
    V = rs.normal(size=(80, 3))
    A = ((U * [30, 15, 7]) @ V.T).astype(np.float32)
    u_ref = np.linalg.svd(A, full_matrices=False)[0][:, 0]
    s_ref = np.linalg.svd(A, compute_uv=False)
    # test_fraction=0.15 -> inv_prob=6 -> actual holdout probability 1/6
    res = rt.svd(A, 3, method="deflation", test_fraction=0.15, seed=1)
    k_got = len(np.asarray(res.d))
    np.testing.assert_allclose(np.asarray(res.d)[:k_got],
                               s_ref[:k_got] * (1.0 - 1.0 / 6.0),
                               rtol=0.05)
    assert abs(float(np.dot(np.asarray(res.U)[:, 0], u_ref))) > 0.99
