"""Parameter / combination matrix (reference: test_parameters.R 644 LoC,
test_unsupported_combos.R, test_validation_errors.R).

Every fit in the matrix must produce finite, correctly-shaped factors.
Kept to a compile-budget-friendly subset of the cross product.
"""

import numpy as np
import pytest

import rcppml_tpu as rt
from rcppml_tpu.utils.simulate import simulate_counts, simulate_nmf

A_DENSE = simulate_nmf(m=24, n=30, k=3, noise=0.05, seed=71)["A"]
A_COUNTS = simulate_counts(m=24, n=30, k=3, seed=72)["A"]


def _check(res, m=24, n=30, k=3):
    assert res.W.shape == (m, k)
    assert res.H.shape == (k, n)
    assert np.isfinite(res.W).all() and np.isfinite(res.H).all()
    assert np.isfinite(res.train_loss)


@pytest.mark.parametrize("solver", ["cd", "cholesky"])
@pytest.mark.parametrize("norm", ["L1", "L2", "none"])
def test_solver_norm_matrix(solver, norm):
    _check(rt.nmf(A_DENSE, 3, seed=42, maxit=8, solver=solver, norm=norm,
                  sort_model=False))


@pytest.mark.parametrize("loss,disp", [
    ("gp", "none"), ("gp", "per_row"), ("gp", "per_col"), ("gp", "global"),
    ("nb", "per_row"), ("nb", "global"),
    ("gamma", "per_row"), ("inverse_gaussian", "none"),
    ("tweedie", "per_row"),
])
def test_loss_dispersion_matrix(loss, disp):
    _check(rt.nmf(A_COUNTS, 3, seed=42, maxit=4, loss=loss, dispersion=disp,
                  sort_model=False))


@pytest.mark.parametrize("kw", [
    dict(L1=(0.01, 0.01), solver="cd"),
    dict(L2=(0.1, 0.1)),
    dict(L21=(0.5, 0.5)),
    dict(angular=(0.05, 0.05)),
    dict(upper_bound=(1.0, 1.0)),
    dict(L1=(0.01, 0.0), L2=(0.0, 0.1), solver="cd"),
    dict(projective=True),
    dict(nonneg=(False, True)),
    dict(robust=True, solver="cd"),
    dict(robust="mae", solver="cd"),
    dict(upper_bound=(0.0, 0.5), L1=(0.0, 0.02), solver="cd"),
    dict(angular=(0.0, 0.1), L2=(0.05, 0.0)),
    dict(L21=(0.2, 0.0), norm="L2"),
    dict(nonneg=(True, False)),
    dict(norm="none", upper_bound=(2.0, 2.0)),
    dict(robust=0.8, solver="cd"),
    dict(loss="gamma", robust=True, solver="cd"),
    dict(loss="nb", L1=(0.0, 0.01), solver="cd"),
    dict(projective=True, norm="L2"),
])
def test_feature_combos(kw):
    _check(rt.nmf(A_DENSE, 3, seed=42, maxit=8, sort_model=False, **kw))


def test_svd_init_mode():
    """seed='lanczos' SVD init (init_mode 1, nmf_init.hpp:45-96)."""
    _check(rt.nmf(A_DENSE, 3, seed="lanczos", maxit=8, sort_model=False))


@pytest.mark.parametrize("kw", [
    dict(test_fraction=0.1, cv_seed=1),
    dict(test_fraction=0.2, cv_seed=2, mask_zeros=True),
    dict(test_fraction=0.1, cv_seed=1, loss="gp", dispersion="none",
         solver="cd"),
    dict(test_fraction=0.1, cv_seed=3, loss="gamma", solver="cd"),
    dict(test_fraction=0.1, cv_seed=4, L1=(0.0, 0.02), solver="cd"),
    dict(test_fraction=0.1, cv_seed=5, cv_col_subsample=0.7),
    dict(test_fraction=0.1, cv_seed=6, loss="nb", zi="row", solver="cd"),
])
def test_cv_combos(kw):
    res = rt.nmf(A_COUNTS if "loss" in kw else A_DENSE, 3, seed=42, maxit=6,
                 sort_model=False, **kw)
    _check(res)
    assert np.isfinite(res.test_loss)


@pytest.mark.parametrize("bad", [
    dict(loss="nb", solver="cholesky"),
    dict(robust=True, solver="cholesky"),
    dict(projective=True, symmetric=True),
    dict(zi="row"),                      # zi requires gp/nb
    dict(test_fraction=1.5),
    dict(loss="nope"),
    dict(symmetric=True),                # A_DENSE is 24x30: not square
    dict(convergence="bogus"),
    dict(mask="bogus"),
])
def test_unsupported_combos(bad):
    with pytest.raises((ValueError, KeyError)):
        rt.nmf(A_DENSE, 3, maxit=2, **bad)


@pytest.mark.parametrize("seed_str", ["lanczos", "irlba", "svd"])
def test_svd_init_modes(seed_str):
    _check(rt.nmf(A_DENSE, 3, seed=seed_str, maxit=8, sort_model=False))


def test_zi_modes():
    for zi in ("row", "col"):
        res = rt.nmf(A_COUNTS, 3, seed=42, maxit=4, loss="nb", zi=zi,
                     sort_model=False)
        _check(res)
        pi = res.pi_row if zi == "row" else res.pi_col
        assert pi is not None and np.isfinite(pi).all()


# --------------------------------------------------------------------------
# dimnames carry-through (tests/testthat/test_dimnames.R, 5 cases + methods)
# --------------------------------------------------------------------------

def _named_df(m=30, n=10, rows=True, cols=True, seed=123):
    pd = pytest.importorskip("pandas")
    rs = np.random.RandomState(seed)
    A = np.abs(rs.normal(size=(m, n))).astype(np.float32)
    return pd.DataFrame(A,
                        index=[f"gene{i+1}" for i in range(m)] if rows else None,
                        columns=[f"sample{j+1}" for j in range(n)] if cols else None)


def test_dimnames_dense():
    df = _named_df()
    res = rt.nmf(df, 3, maxit=10, seed=1)
    assert list(res.row_names) == [f"gene{i+1}" for i in range(30)]
    assert list(res.col_names) == [f"sample{j+1}" for j in range(10)]
    rn, cn = res.dimnames()
    assert rn is not None and cn is not None


def test_dimnames_absent():
    rs = np.random.RandomState(0)
    res = rt.nmf(np.abs(rs.normal(size=(20, 12))).astype(np.float32), 2,
                 maxit=5, seed=1)
    assert res.row_names is None and res.col_names is None


def test_dimnames_methods_propagate():
    df = _named_df(m=20, n=12)
    res = rt.nmf(df, 3, maxit=8, seed=1)
    sub = res.subset(rows=[0, 2, 4])
    assert list(sub.row_names) == ["gene1", "gene3", "gene5"]
    assert list(sub.col_names) == [f"sample{j+1}" for j in range(12)]
    tt = res.t()
    assert list(tt.row_names) == list(res.col_names)
    ff = res[[0, 1]]
    assert list(ff.row_names) == list(res.row_names)


def test_dimnames_svd():
    df = _named_df(m=25, n=15)
    res = rt.svd(df, 3, method="randomized", seed=1)
    assert list(res.row_names)[:2] == ["gene1", "gene2"]
    assert list(res.col_names)[:2] == ["sample1", "sample2"]


def test_dimnames_cv_path():
    df = _named_df(m=24, n=16)
    res = rt.nmf(df, 2, maxit=6, seed=1, test_fraction=0.2, cv_seed=3)
    assert res.row_names is not None and len(res.row_names) == 24


def test_dimnames_from_r_datasets():
    """R-matrix dimnames (dataset .attrs) flow onto results like pandas
    indexes (test_dimnames.R semantics for native R data)."""
    from rcppml_tpu import datasets
    res = rt.nmf(datasets.hawaiibirds(), 3, seed=1, maxit=5)
    assert res.row_names is not None and len(res.row_names) == 183
    assert "Myna" in " ".join(str(x) for x in res.row_names[:5])


def test_loss_huber_and_mae_aliases():
    """loss='huber'/'mae' are IRLS reweightings of squared error
    (math/loss.hpp loss_type 1/2): huber == mse+robust(huber_delta),
    mae == mse+robust('mae')."""
    h1 = rt.nmf(A_DENSE, 3, seed=42, maxit=6, loss="huber",
                huber_delta=1.345, solver="cd", sort_model=False)
    h2 = rt.nmf(A_DENSE, 3, seed=42, maxit=6, robust=1.345, solver="cd",
                sort_model=False)
    np.testing.assert_allclose(np.asarray(h1.W), np.asarray(h2.W))
    m1 = rt.nmf(A_DENSE, 3, seed=42, maxit=6, loss="mae", solver="cd",
                sort_model=False)
    m2 = rt.nmf(A_DENSE, 3, seed=42, maxit=6, robust="mae", solver="cd",
                sort_model=False)
    np.testing.assert_allclose(np.asarray(m1.W), np.asarray(m2.W))


def test_dispersion_bound_overrides():
    """theta_max / nb_size bounds flow into the estimators
    (R/parse_dots.R:24-31)."""
    res = rt.nmf(A_COUNTS, 3, seed=42, maxit=6, loss="gp",
                 dispersion="per_row", theta_max=0.2, sort_model=False)
    assert np.all(np.asarray(res.theta) <= 0.2 + 1e-6)
    res = rt.nmf(A_COUNTS, 3, seed=42, maxit=6, loss="nb",
                 dispersion="per_row", nb_size_max=50.0, sort_model=False)
    assert np.all(np.asarray(res.theta) <= 50.0 + 1e-4)


def test_sparse_alias_and_track_train_loss():
    """sparse=True treats zeros as missing (test_parameters.R:260);
    track_train_loss=False suppresses the history."""
    A = A_DENSE.copy()
    A[A < np.median(A)] = 0.0
    r1 = rt.nmf(A, 3, seed=42, maxit=8, sparse=True, sort_model=False)
    r2 = rt.nmf(A, 3, seed=42, maxit=8, mask="zeros", sort_model=False)
    np.testing.assert_allclose(np.asarray(r1.W), np.asarray(r2.W))
    r3 = rt.nmf(A_DENSE, 3, seed=42, maxit=8, track_train_loss=False)
    assert r3.loss_history is None or len(r3.loss_history) == 0


def test_zi_em_iters_accepted():
    res = rt.nmf(A_COUNTS, 3, seed=42, maxit=4, loss="gp", zi="row",
                 dispersion="per_row", zi_em_iters=2, sort_model=False)
    assert res.pi_row is not None


def test_auto_rank_cv_k_range():
    from rcppml_tpu.utils.simulate import simulate_nmf
    sim = simulate_nmf(m=40, n=40, k=3, noise=0.02, seed=5)
    res = rt.nmf(sim["A"], "auto", cv_k_range=(2, 8), test_fraction=0.1,
                 maxit=30, seed=42)
    assert 2 <= res.k <= 8


def test_seed_matrix_custom_init():
    """seed = matrix -> custom W initialization (test_parameters.R:149)."""
    W0 = np.abs(np.random.RandomState(9).rand(24, 3)).astype(np.float32)
    res = rt.nmf(A_DENSE, 3, seed=W0, maxit=5, sort_model=False)
    assert res.W.shape == (24, 3)
    r2 = rt.nmf(A_DENSE, 3, w_init=W0, seed=0, maxit=5, sort_model=False)
    np.testing.assert_allclose(np.asarray(res.W), np.asarray(r2.W))
    with pytest.raises(ValueError, match="Rank mismatch"):
        rt.nmf(A_DENSE, 3, seed=W0[:, :2], maxit=5)


def test_seed_list_multi_restart():
    """seed = list -> best-of-N restart selection with all_inits record
    (test_parameters.R:554-578)."""
    res = rt.nmf(A_DENSE, 2, seed=[11, 22, 33], maxit=10, sort_model=False)
    rows = res.misc["all_inits"]
    assert len(rows) == 3
    assert sum(r["selected"] for r in rows) == 1
    best = min(r["loss"] for r in rows)
    assert res.train_loss == best
    # list of custom init matrices
    inits = [np.abs(np.random.RandomState(s).rand(24, 2)).astype(np.float32)
             for s in (1, 2, 3)]
    res2 = rt.nmf(A_DENSE, 2, seed=inits, maxit=10, sort_model=False)
    assert len(res2.misc["all_inits"]) == 3


def test_inf_input_rejected():
    """Inf input errors cleanly instead of returning non-finite factors
    (test_p2_hardening.R:253-266 allows error-or-valid)."""
    B = A_DENSE.copy()
    B[1, 2] = np.inf
    with pytest.raises(ValueError, match="infinite"):
        rt.nmf(B, 2, maxit=3)


# ---------------------------------------------------------------------------
# bf16_data speed knob (halves the device-memory read of A)
# ---------------------------------------------------------------------------

def test_bf16_data_close_to_fp32():
    rs = np.random.RandomState(0)
    A = (np.abs(rs.randn(80, 60)) @ np.abs(rs.randn(60, 60)) / 60
         ).astype(np.float32)
    m32 = rt.nmf(A, 5, maxit=25, seed=1, tol=0.0)
    m16 = rt.nmf(A, 5, maxit=25, seed=1, tol=0.0, bf16_data=True)
    mse32 = float(np.mean((A - np.asarray(m32.reconstruct())) ** 2))
    mse16 = float(np.mean((A - np.asarray(m16.reconstruct())) ** 2))
    assert np.isfinite(mse16)
    assert mse16 < mse32 * 1.25     # same model quality, reduced precision


def test_bf16_data_rejected_outside_plain_mse():
    A = np.abs(np.random.RandomState(1).rand(30, 20)).astype(np.float32)
    with pytest.raises(ValueError, match="bf16_data"):
        rt.nmf(A, 3, bf16_data=True, loss="gp", maxit=3)
    with pytest.raises(ValueError, match="bf16_data"):
        rt.nmf(A, 3, bf16_data=True, test_fraction=0.1, maxit=3)
    with pytest.raises(ValueError, match="bf16_data"):
        rt.nmf(A, 3, bf16_data=True, mask=np.zeros_like(A, bool), maxit=3)
    with pytest.raises(ValueError, match="bf16_data"):
        rt.nmf(A, 3, bf16_data=True, streaming=True, maxit=3)


def test_seed_list_batched_matches_serial():
    """Plain dense MSE seed-lists take the vmapped batched path
    (models/nmf.py fit_multi_restart): per-restart losses and the
    selected model must match the standalone per-seed fits."""
    rs = np.random.RandomState(7)
    A = np.abs(rs.rand(40, 30)).astype(np.float32)
    res = rt.nmf(A, 3, seed=[5, 6, 7], maxit=12, sort_model=False)
    singles = [rt.nmf(A, 3, seed=s, maxit=12, sort_model=False)
               for s in (5, 6, 7)]
    for row, single in zip(res.misc["all_inits"], singles):
        np.testing.assert_allclose(row["loss"], single.train_loss,
                                   rtol=1e-5)
    best = int(np.argmin([s.train_loss for s in singles]))
    np.testing.assert_allclose(res.W, singles[best].W,
                               rtol=1e-4, atol=1e-6)
    assert res.misc["all_inits"][best]["selected"]


def test_seed_list_ineligible_configs_still_work():
    """Configs outside the batched fast path (CV, IRLS, masks) fall back
    to the serial loop with identical semantics."""
    rs = np.random.RandomState(8)
    A = np.abs(rs.rand(30, 25)).astype(np.float32)
    r_cv = rt.nmf(A, 2, seed=[1, 2], maxit=6, test_fraction=0.1,
                  cv_seed=3, sort_model=False)
    assert len(r_cv.misc["all_inits"]) == 2
    assert np.isfinite(r_cv.test_loss)
    counts = rs.poisson(2.0, (30, 25)).astype(np.float32)
    r_nb = rt.nmf(counts, 2, seed=[1, 2], maxit=4, loss="nb",
                  sort_model=False)
    assert len(r_nb.misc["all_inits"]) == 2


def test_seed_list_nan_and_dimnames():
    """Round-3 review finding: the batched seed-list path must not bypass
    nmf()'s NaN auto-masking or DataFrame dimname carry-through."""
    import warnings
    rs = np.random.RandomState(3)
    A = np.abs(rs.rand(30, 25)).astype(np.float32)
    An = A.copy()
    An[3, 4] = np.nan
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        r = rt.nmf(An, 3, seed=[5, 6], maxit=5, sort_model=False)
    assert np.isfinite(r.train_loss)
    assert any("NA" in str(x.message) for x in w)
    pd = pytest.importorskip("pandas")
    df = pd.DataFrame(A, index=[f"g{i}" for i in range(30)],
                      columns=[f"c{j}" for j in range(25)])
    r2 = rt.nmf(df, 2, seed=[5, 6], maxit=5, sort_model=False)
    assert list(r2.row_names)[:2] == ["g0", "g1"]
    assert list(r2.col_names)[:2] == ["c0", "c1"]


@pytest.mark.parametrize("kw", [
    {"L1": 1.5}, {"L1": -0.1}, {"L2": -0.5}, {"L21": -1.0},
    {"angular": -1.0}, {"upper_bound": -2.0},
    {"L1": (0.0, 1.5)},
])
def test_negative_or_oob_penalties_rejected(kw):
    """Penalty range validation (test_validation_errors.R:35-71) — these
    were previously silently accepted (negative ridge = indefinite Gram)."""
    with pytest.raises(ValueError):
        rt.nmf(A_DENSE, 2, maxit=2, **kw)


def test_negative_graph_lambda_rejected():
    L = np.eye(A_DENSE.shape[0], dtype=np.float32)
    with pytest.raises(ValueError):
        rt.nmf(A_DENSE, 2, maxit=2, graph_W=L, graph_lambda=-1.0)
