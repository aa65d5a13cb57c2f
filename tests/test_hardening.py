"""Regression behaviors mirroring the reference's hardening suites
(test_p2_hardening.R, test_g1_g6_fixes.R, test_build_dense_paths.R):
distribution columns in CV sweeps, score-test custom powers, graph-engine
tweedie, seeding variants, dense/sparse penalty parity.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import rcppml_tpu as rt


@pytest.fixture(scope="module")
def counts():
    rs = np.random.RandomState(7)
    W = rs.gamma(2.0, 1.0, size=(30, 3))
    H = rs.gamma(2.0, 1.0, size=(3, 22))
    return rs.poisson(W @ H).astype(np.float32) + 0.0


@pytest.fixture(scope="module")
def gamma_data():
    rs = np.random.RandomState(42)
    A = rs.gamma(2.0, 1.0, size=(40, 25)).astype(np.float32)
    return np.maximum(A, 1e-6)


# ---------------------------------------------------------------------------
# G5: multi-rank CV sweeps carry distribution parameter columns
# (test_g1_g6_fixes.R:137-185)
# ---------------------------------------------------------------------------

def test_cv_sweep_gp_mean_theta(counts):
    rows = rt.nmf(counts, [2, 3], loss="gp", test_fraction=0.1, cv_seed=1,
                  maxit=8)
    assert all(np.isfinite(r["mean_theta"]) for r in rows)


def test_cv_sweep_gamma_mean_dispersion(gamma_data):
    rows = rt.nmf(gamma_data, [2, 3], loss="gamma", test_fraction=0.1,
                  cv_seed=1, maxit=8)
    assert all(np.isfinite(r["mean_dispersion"]) for r in rows)


def test_cv_sweep_mse_nan_distribution_columns(counts):
    rows = rt.nmf(counts, [2, 3], test_fraction=0.1, cv_seed=1, maxit=8)
    assert all(np.isnan(r["mean_theta"]) for r in rows)
    assert all(np.isnan(r["mean_dispersion"]) for r in rows)


# ---------------------------------------------------------------------------
# G1: non-MSE CV returns dispersion vectors of the right length
# (test_g1_g6_fixes.R:15-86)
# ---------------------------------------------------------------------------

def test_tweedie_cv_returns_dispersion(gamma_data):
    res = rt.nmf(gamma_data, 2, loss="tweedie", tweedie_power=1.5,
                 dispersion="global", test_fraction=0.1, cv_seed=1, maxit=10)
    assert res.dispersion is not None
    assert np.isfinite(np.asarray(res.dispersion)).all()


def test_gamma_cv_per_col_dispersion_length(gamma_data):
    res = rt.nmf(gamma_data, 2, loss="gamma", dispersion="per_col",
                 test_fraction=0.1, cv_seed=1, maxit=10)
    assert len(np.asarray(res.dispersion)) == gamma_data.shape[1]


def test_gamma_cv_sparse_returns_dispersion(gamma_data):
    A = sp.csc_matrix(gamma_data * (gamma_data > 1.0))
    res = rt.nmf(A, 2, loss="gamma", dispersion="global", mask="zeros",
                 test_fraction=0.1, cv_seed=1, maxit=10)
    assert res.dispersion is not None


# ---------------------------------------------------------------------------
# G3: score test with non-standard powers; auto distribution end-to-end
# (test_g1_g6_fixes.R:89-114)
# ---------------------------------------------------------------------------

def test_score_test_custom_powers(gamma_data):
    model = rt.nmf(gamma_data, 2, maxit=10, seed=1)
    diag = rt.score_test_distribution(gamma_data, model,
                                      powers=[0.5, 1.5, 2.5])
    assert len(diag["scores"]) == 3
    assert any(str(s["distribution"]).startswith("power_")
               for s in diag["scores"])
    assert np.isfinite(diag["best_power"])


def test_auto_distribution_loss_feeds_nmf(gamma_data):
    auto = rt.auto_nmf_distribution(gamma_data, 3, seed=42, maxit=10)
    model = rt.nmf(gamma_data, 3, loss=auto["loss"], maxit=10, seed=42)
    assert np.isfinite(model.train_loss)


# ---------------------------------------------------------------------------
# G4/G6: tweedie in the graph engine; tweedie_power sensitivity
# (test_g1_g6_fixes.R:120-205)
# ---------------------------------------------------------------------------

def test_factor_net_tweedie(gamma_data):
    inp = rt.factor_input(gamma_data, "X")
    layer = rt.nmf_layer(inp, 2, name="L1")
    gc = rt.factor_config(maxit=8, tol=1e-3, loss="tweedie", seed=1)
    net = rt.factor_net(inp, layer, config=gc)
    res = rt.fit(net)
    assert np.isfinite(res.layers["L1"].loss)


def test_tweedie_power_changes_loss(gamma_data):
    m13 = rt.nmf(gamma_data, 2, loss="tweedie", tweedie_power=1.3,
                 maxit=8, seed=1)
    m17 = rt.nmf(gamma_data, 2, loss="tweedie", tweedie_power=1.7,
                 maxit=8, seed=1)
    assert float(m13.train_loss) != float(m17.train_loss)


# ---------------------------------------------------------------------------
# Seeding variants (test_p2_hardening.R:125-193, test_build_dense_paths.R)
# ---------------------------------------------------------------------------

def test_h_init_only_seeding(counts):
    rs = np.random.RandomState(3)
    H0 = rs.rand(3, counts.shape[1]).astype(np.float32)
    res = rt.nmf(counts, 3, h_init=H0, maxit=8)
    assert np.isfinite(res.train_loss)
    assert np.asarray(res.H).shape == (3, counts.shape[1])


def test_w_and_h_init_beats_random_at_one_iter(counts):
    good = rt.nmf(counts, 3, maxit=30, seed=1)
    seeded = rt.nmf(counts, 3, maxit=1,
                    w_init=np.asarray(good.W) * np.asarray(good.d),
                    h_init=np.asarray(good.H))
    random = rt.nmf(counts, 3, maxit=1, seed=99)
    assert float(seeded.train_loss) < float(random.train_loss)


def test_scalar_k_cv_seed_vector_uses_first(counts):
    a = rt.nmf(counts, 3, test_fraction=0.1, cv_seed=[11, 12], maxit=6,
               seed=1)
    b = rt.nmf(counts, 3, test_fraction=0.1, cv_seed=11, maxit=6, seed=1)
    np.testing.assert_array_equal(np.asarray(a.W), np.asarray(b.W))
    assert float(a.test_loss) == float(b.test_loss)


def test_cv_seed_vector_multi_rank_reps(counts):
    rows = rt.nmf(counts, [2, 3], test_fraction=0.1, cv_seed=[1, 2], maxit=6)
    assert len(rows) == 4
    assert sorted({r["rep"] for r in rows}) == [1, 2]
    # different folds -> different holdout losses at the same k
    k2 = [r["test_mse"] for r in rows if r["k"] == 2]
    assert k2[0] != k2[1]


# ---------------------------------------------------------------------------
# Dense/sparse penalty parity (test_p2_hardening.R:72-91)
# ---------------------------------------------------------------------------

def test_dense_sparse_l1_same_sparsification():
    rs = np.random.RandomState(5)
    A = sp.random(50, 40, density=0.3, random_state=rs, format="csc",
                  dtype=np.float64)
    A.data = np.abs(A.data).astype(np.float64)
    dense = np.asarray(A.todense(), dtype=np.float32)
    md = rt.nmf(dense, 4, L1=0.1, maxit=15, seed=7)
    ms = rt.nmf(A, 4, L1=0.1, maxit=15, seed=7)
    np.testing.assert_allclose(np.asarray(md.H), np.asarray(ms.H),
                               atol=1e-5)
    assert md.sparsity()["H"] > 0.05


# ---------------------------------------------------------------------------
# Edge behaviors (test_p2_hardening.R:220-241)
# ---------------------------------------------------------------------------

def test_single_nonzero_entry():
    A = np.zeros((10, 8), dtype=np.float32)
    A[3, 4] = 5.0
    res = rt.nmf(A, 1, maxit=10, seed=1)
    R = np.asarray(res.reconstruct())
    assert abs(R[3, 4] - 5.0) < 0.5
    assert np.abs(R).sum() - abs(R[3, 4]) < 0.5


def test_maxit_one_valid(counts):
    res = rt.nmf(counts, 3, maxit=1, seed=1)
    assert res.iterations == 1
    assert np.isfinite(res.train_loss)
    assert (np.asarray(res.d) >= 0).all()


# ---------------------------------------------------------------------------
# Device introspection surface (gpu_available/gpu_info analogs,
# R/gpu_backend.R:68-143)
# ---------------------------------------------------------------------------

def test_accelerator_introspection():
    assert rt.tpu_available() in (True, False)
    assert rt.accelerator_available() == rt.tpu_available()
    info = rt.tpu_info()
    assert info["backend"] in ("cpu", "gpu")
    assert info["num_devices"] >= 1
