"""Regularization-effect tests (reference: test_regularization_effects.R,
test_target_regularization.R, test_orthogonality.R)."""

import numpy as np
import pytest

import rcppml_tpu as rt
from rcppml_tpu.utils.simulate import simulate_nmf

pytestmark = pytest.mark.numerics  # numerics-critical subset


@pytest.fixture(scope="module")
def sim():
    return simulate_nmf(m=50, n=70, k=4, noise=0.03, seed=31)


def test_l21_zeroes_factors(sim):
    """L21 group sparsity drives whole factors to zero at overspecified rank
    (features/L21.hpp)."""
    A = sim["A"]                       # true rank 4
    r0 = rt.nmf(A, 8, seed=42, maxit=60, solver="cd")
    r1 = rt.nmf(A, 8, seed=42, maxit=60, solver="cd", L21=(2.0, 2.0))
    dead0 = int((r0.d < 1e-3 * r0.d.max()).sum())
    dead1 = int((r1.d < 1e-3 * r1.d.max()).sum())
    assert dead1 >= dead0
    assert np.isfinite(r1.train_loss)


def test_angular_decorrelates(sim):
    A = sim["A"]
    from rcppml_tpu.utils.metrics import cosine
    r0 = rt.nmf(A, 4, seed=42, maxit=60)
    r1 = rt.nmf(A, 4, seed=42, maxit=60, angular=(0.1, 0.1))

    def mean_offdiag_cos(W):
        C = np.abs(cosine(W))
        k = C.shape[0]
        return (C.sum() - k) / (k * (k - 1))

    assert mean_offdiag_cos(r1.W) <= mean_offdiag_cos(r0.W) + 1e-6


def test_graph_laplacian_smooths(sim):
    """G += lam F L F^T: a chain Laplacian over samples makes adjacent
    H columns more similar (features/graph_reg.hpp)."""
    A = sim["A"]
    n = A.shape[1]
    # chain graph Laplacian over columns
    L = np.zeros((n, n), np.float32)
    for j in range(n - 1):
        L[j, j] += 1
        L[j + 1, j + 1] += 1
        L[j, j + 1] -= 1
        L[j + 1, j] -= 1
    r0 = rt.nmf(A, 4, seed=42, maxit=50)
    r1 = rt.nmf(A, 4, seed=42, maxit=50, graph_H=L, graph_lambda=(0.0, 2.0))

    def roughness(H):
        return float(np.mean(np.diff(H, axis=1) ** 2) / np.mean(H ** 2))

    assert roughness(r1.H) < roughness(r0.H)
    assert np.isfinite(r1.train_loss)


def test_target_enrichment_pulls_h(sim):
    """Positive target_lambda enriches H toward the target
    (variant_helpers.hpp:107-115)."""
    A = sim["A"]
    rs = np.random.RandomState(3)
    target = np.abs(rs.rand(4, A.shape[1])).astype(np.float32)
    target /= target.sum(axis=1, keepdims=True)
    r0 = rt.nmf(A, 4, seed=42, maxit=40)
    r1 = rt.nmf(A, 4, seed=42, maxit=40, target_H=target, target_lambda=5.0)
    d0 = float(np.linalg.norm(r0.H - target))
    d1 = float(np.linalg.norm(r1.H - target))
    assert d1 < d0


def test_proj_adv_batch_removal():
    """Negative target_lambda suppresses the targeted direction in H
    (PROJ_ADV, variant_helpers.hpp:116-145)."""
    rs = np.random.RandomState(0)
    # data with a strong batch direction
    batch = np.repeat([0, 1], 30)
    W = np.abs(rs.rand(40, 3)).astype(np.float32)
    H = np.abs(rs.rand(3, 60)).astype(np.float32)
    A = W @ H + 2.0 * np.outer(np.abs(rs.rand(40)), batch).astype(np.float32)
    A = A.astype(np.float32)

    from rcppml_tpu.utils.guided import compute_target
    r0 = rt.nmf(A, 3, seed=42, maxit=40)
    bt = compute_target(r0.H, batch, whiten=False)
    r1 = rt.nmf(A, 3, seed=42, maxit=40, target_H=bt, target_lambda=-0.8)

    def batch_corr(Hm):
        c = np.corrcoef(np.vstack([Hm, batch[None, :]]))[-1, :-1]
        # factors suppressed to ~constant have zero variance -> NaN corr;
        # treat as zero correlation with the batch
        return float(np.nan_to_num(np.abs(c)).max())

    assert np.isfinite(r1.H).all()

    assert batch_corr(r1.H) <= batch_corr(r0.H) + 0.05
    assert np.isfinite(r1.train_loss)


def test_semi_nmf(sim):
    """nonneg=(False, True): W unconstrained (semi-NMF)."""
    A = sim["A"] - sim["A"].mean()       # signed data
    res = rt.nmf(A, 4, seed=42, maxit=30, nonneg=(False, True))
    assert (res.W < 0).any()
    assert (res.H >= 0).all()
