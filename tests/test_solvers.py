"""Solver-primitive unit tests (reference: tests/cpp/test_nnls.cpp,
test_gram.cpp)."""

import numpy as np
import pytest

import jax.numpy as jnp

pytestmark = pytest.mark.numerics  # numerics-critical subset

from rcppml_tpu.ops import linalg, solvers


@pytest.fixture
def spd_system():
    rs = np.random.RandomState(3)
    k, n = 12, 200
    F = rs.rand(k, 50).astype(np.float32)
    G = F @ F.T + 0.5 * np.eye(k, dtype=np.float32)
    B = rs.rand(k, n).astype(np.float32) * 5
    return jnp.asarray(G), jnp.asarray(B)


def test_batched_spd_solve_matches_numpy(spd_system):
    G, B = spd_system
    k = G.shape[0]
    n = B.shape[1]
    rs = np.random.RandomState(0)
    Gb = jnp.asarray(np.stack([
        np.asarray(G) + 0.05 * i * np.eye(k, dtype=np.float32)
        for i in range(n)]))
    X = solvers.batched_spd_solve(Gb, B)
    for j in range(0, n, 40):
        x_ref = np.linalg.solve(np.asarray(Gb[j], np.float64),
                                np.asarray(B[:, j], np.float64))
        np.testing.assert_allclose(np.asarray(X[:, j]), x_ref, rtol=2e-3,
                                   atol=1e-4)


def test_cholesky_clip_batch_unconstrained(spd_system):
    G, B = spd_system
    X = solvers.cholesky_clip_batch(G, B, nonneg=False)
    # verify the residual in fp64 numpy: `G @ X` as a jnp op runs at the
    # backend's DEFAULT matmul precision (TF32/bf16 on an accelerator), which
    # would test the harness's rounding instead of the solver
    np.testing.assert_allclose(
        np.asarray(G, np.float64) @ np.asarray(X, np.float64),
        np.asarray(B, np.float64), rtol=2e-2, atol=1e-3)


def test_cd_exact_nnls_kkt(spd_system):
    """CD solution satisfies NNLS KKT: x>=0; grad>=0 where x=0; grad~0
    where x>0 (grad = Gx - b)."""
    G, B = spd_system
    X = solvers.cd_nnls_batch(G, B, nonneg=True, maxit=500, cd_tol=1e-10)
    grad = np.asarray(G @ X) - np.asarray(B)
    X = np.asarray(X)
    assert (X >= 0).all()
    scale = np.abs(np.asarray(B)).max()
    assert np.abs(grad[X > 1e-6]).max() < 1e-2 * scale
    assert grad[X <= 1e-6].min() > -1e-2 * scale


def test_cd_warm_start_converges_faster(spd_system):
    G, B = spd_system
    X_cold = solvers.cd_nnls_batch(G, B, nonneg=True, maxit=300, cd_tol=1e-10)
    # warm start from the solution: should stay put
    B2 = B - G @ X_cold
    X_warm = solvers.cd_nnls_batch(G, jnp.asarray(B), X_cold, nonneg=True,
                                   maxit=300, cd_tol=1e-10, warm_start=True)
    np.testing.assert_allclose(np.asarray(X_warm), np.asarray(X_cold),
                               rtol=1e-3, atol=1e-4)


def test_gram_psd(spd_system):
    rs = np.random.RandomState(1)
    F = jnp.asarray(rs.rand(8, 100).astype(np.float32))
    G = np.asarray(linalg.gram(F))
    np.testing.assert_allclose(G, G.T, atol=1e-6)
    evals = np.linalg.eigvalsh(G.astype(np.float64))
    assert evals.min() > 0


def test_cd_l1_stationarity(spd_system):
    """CD with L1 uses the reference's ratio-threshold semantics
    (nnls_batch.hpp:92-94: diff = b_i/G_ii - L1): at convergence active
    coords satisfy (b - Gx)_i = L1 * G_ii, inactive ones
    (b - Gx)_i / G_ii <= L1."""
    G, B = spd_system
    from rcppml_tpu.ops import solvers
    import jax.numpy as jnp
    L1 = 0.3
    X = np.asarray(solvers.cd_nnls_batch(jnp.asarray(G), jnp.asarray(B),
                                         L1=L1, nonneg=True, maxit=500,
                                         cd_tol=1e-12))
    resid_ratio = (B - G @ X) / np.diag(G)[:, None]
    active = X > 1e-7
    np.testing.assert_allclose(resid_ratio[active], L1, atol=1e-3)
    assert resid_ratio[~active].max() <= L1 + 1e-3
    # stronger L1 -> sparser
    X2 = np.asarray(solvers.cd_nnls_batch(jnp.asarray(G), jnp.asarray(B),
                                          L1=2.0, nonneg=True, maxit=500,
                                          cd_tol=1e-12))
    assert (X2 == 0).mean() >= (X == 0).mean()


def test_upper_bound_inside_cd(spd_system):
    """Upper bound clamps inside the sweep (nnls_batch.hpp:100-108)."""
    G, B = spd_system
    from rcppml_tpu.ops import solvers
    import jax.numpy as jnp
    X = np.asarray(solvers.cd_nnls_batch(jnp.asarray(G), jnp.asarray(B),
                                         nonneg=True, maxit=300,
                                         cd_tol=1e-10, upper_bound=0.05))
    assert X.max() <= 0.05 + 1e-6 and X.min() >= 0


def test_chol_ridge_rank_deficient():
    """The trace-relative ridge keeps rank-deficient Grams solvable
    (constant-matrix regression: the explicit-inverse variant failed here)."""
    from rcppml_tpu.ops import solvers
    import jax.numpy as jnp
    k = 8
    w = np.ones((k, 20), np.float32) * 0.3
    G = w @ w.T                              # rank 1
    B = w @ np.full((20, 12), 3.0, np.float32)
    X = np.asarray(solvers.cholesky_clip_batch(jnp.asarray(G),
                                               jnp.asarray(B), nonneg=True))
    assert np.isfinite(X).all()
    rec = w.T @ X                            # the solve's fitted values
    assert np.abs(rec - 3.0).max() < 0.05


def test_cd_dead_coordinate_untouched_with_l1():
    """A zero Gram diagonal (dead factor) must skip the WHOLE update, L1
    subtraction included (nnls_batch.hpp:90 'continue'): the warm-start
    value on the dead coordinate stays exactly put."""
    import jax.numpy as jnp
    from rcppml_tpu.ops.solvers import cd_nnls_batch, cd_nnls_batched_gram
    k, n = 4, 6
    rs = np.random.RandomState(3)
    F = np.abs(rs.normal(size=(k, 10))).astype(np.float32)
    F[2, :] = 0.0                       # dead factor -> G[2,2] == 0
    G = (F @ F.T).astype(np.float32)
    B = np.abs(rs.normal(size=(k, n))).astype(np.float32)
    B[2, :] = 0.0
    X0 = np.abs(rs.normal(size=(k, n))).astype(np.float32) + 0.5

    X = np.asarray(cd_nnls_batch(jnp.asarray(G), jnp.asarray(B),
                                 jnp.asarray(X0), L1=0.3, warm_start=True))
    np.testing.assert_array_equal(X[2], X0[2])

    Gb = jnp.broadcast_to(jnp.asarray(G)[None], (n, k, k))
    B_res = jnp.asarray(B) - jnp.einsum("nkj,jn->kn", Gb, jnp.asarray(X0))
    Xb = np.asarray(cd_nnls_batched_gram(Gb, B_res, jnp.asarray(X0), 0.3,
                                         nonneg=True, maxit=50, cd_tol=1e-8))
    np.testing.assert_array_equal(Xb[2], X0[2])
