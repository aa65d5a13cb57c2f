"""FactorNet graph engine tests (reference: test_factor_net.R, 674 LoC)."""

import numpy as np
import pytest

from rcppml_tpu.models.graph import (Add, Concat, Condition, FactorNet, Input,
                                     NMFLayer, Shared, cross_validate_graph,
                                     factor_input, factor_net, fit, nmf_layer)
from rcppml_tpu.utils.simulate import simulate_nmf

pytestmark = pytest.mark.numerics  # numerics-critical subset


@pytest.fixture(scope="module")
def modalities():
    s1 = simulate_nmf(m=40, n=60, k=3, noise=0.02, seed=1)
    s2 = simulate_nmf(m=25, n=60, k=3, noise=0.02, seed=2)
    return s1["A"], s2["A"]


def test_single_layer_delegates(modalities):
    A, _ = modalities
    inp = Input(A, "x")
    net = factor_net(inp, NMFLayer(inp, 3, name="L1"), maxit=40, seed=42)
    res = fit(net)
    lr = res["L1"]
    assert lr.W.shape == (40, 3)
    assert lr.H.shape == (3, 60)
    assert np.isfinite(res.total_loss)


def test_shared_multimodal_splits_w(modalities):
    A1, A2 = modalities
    i1, i2 = Input(A1, "rna"), Input(A2, "atac")
    shared = Shared(i1, i2)
    net = factor_net([i1, i2], NMFLayer(shared, 3, name="joint"), maxit=40,
                     seed=42)
    res = fit(net)
    lr = res["joint"]
    assert lr.W.shape == (65, 3)
    assert set(lr.W_blocks) == {"rna", "atac"}
    assert lr.W_blocks["rna"].shape == (40, 3)
    assert lr.W_blocks["atac"].shape == (25, 3)
    # joint model reconstructs the stacked data
    stacked = np.vstack([A1, A2])
    rec = (lr.W * lr.d[None, :]) @ lr.H
    rel = np.linalg.norm(rec - stacked) / np.linalg.norm(stacked)
    assert rel < 0.5


def test_two_layer_deep(modalities):
    A, _ = modalities
    inp = Input(A, "x")
    l1 = NMFLayer(inp, 6, name="L1")
    l2 = NMFLayer(l1, 2, name="L2")
    net = factor_net(inp, l2, maxit=20, seed=42)
    res = fit(net)
    assert set(res.layers) == {"L1", "L2"}
    # layer 2 factorizes t(H1): W2 is (n x k2)
    assert res["L2"].W.shape == (60, 2)
    assert res["L2"].H.shape == (2, 6)
    assert np.isfinite(res.total_loss)
    assert res.total_iterations >= 1


def test_condition_appends_covariates(modalities):
    A, _ = modalities
    rs = np.random.RandomState(0)
    Z = rs.rand(60, 2).astype(np.float32)   # per-sample covariates
    inp = Input(A, "x")
    l1 = NMFLayer(inp, 4, name="L1")
    cond = Condition(l1, Z)
    l2 = NMFLayer(cond, 2, name="L2")
    net = factor_net(inp, l2, maxit=10, seed=42)
    res = fit(net)
    # conditioned input is (n x (k1 + 2)) -> H2 has k1+2 columns
    assert res["L2"].H.shape == (2, 6)
    assert res["L2"].W.shape == (60, 2)


def test_concat_branches(modalities):
    A1, A2 = modalities
    i1, i2 = Input(A1, "a"), Input(A2, "b")
    l1 = NMFLayer(i1, 3, name="b1")
    l2 = NMFLayer(i2, 2, name="b2")
    top = NMFLayer(Concat(l1, l2), 2, name="top")
    net = factor_net([i1, i2], top, maxit=10, seed=42)
    res = fit(net)
    assert res["top"].W.shape == (60, 2)      # n x k
    assert res["top"].H.shape == (2, 5)       # k x (k1 + k2)


def test_add_branches(modalities):
    A1, _ = modalities
    i1 = Input(A1, "a")
    l1 = NMFLayer(i1, 3, name="b1")
    l2 = NMFLayer(i1, 3, name="b2")
    top = NMFLayer(Add(l1, l2), 2, name="top")
    net = factor_net(i1, top, maxit=8, seed=42)
    res = fit(net)
    assert res["top"].H.shape == (2, 3)


def test_compile_validation(modalities):
    A, _ = modalities
    inp = Input(A, "x")
    with pytest.raises(ValueError):
        factor_net(inp, inp)                  # no layers
    l1 = NMFLayer(inp, 2, name="same")
    l2 = NMFLayer(l1, 2, name="same")
    with pytest.raises(ValueError):
        factor_net(inp, l2)                   # duplicate names


def test_cross_validate_graph_grid(modalities):
    """Reference semantics (R/cross_validate_graph.R:86): layer_fn + named
    param grid, reps with derived cv_seeds, mean/SE summary, best_params."""
    from rcppml_tpu.models.graph import factor_config
    A1, _ = modalities
    inp = Input(A1, "x")
    cv = cross_validate_graph(
        inp, lambda p: NMFLayer(inp, p["k"], name="L"),
        params={"k": [2, 3]},
        config=factor_config(maxit=20, seed=42),
        reps=2, seed=7)
    assert len(cv.results) == 4                    # 2 combos x 2 reps
    assert all(np.isfinite(r["test_loss"]) for r in cv.results)
    # per-rep cv seeds are distinct -> test losses differ within a combo
    r0 = [r for r in cv.results if r["combo"] == 0]
    assert r0[0]["test_loss"] != r0[1]["test_loss"]
    assert cv.best_params["k"] in (2, 3)
    assert cv.summary[0]["mean_test_loss"] <= cv.summary[-1]["mean_test_loss"]
    # true k=3 data: higher rank should win the holdout
    assert cv.best_params["k"] == 3


def test_cross_validate_graph_multiparam_random(modalities):
    """Multi-parameter search + random strategy subsampling."""
    from rcppml_tpu.models.graph import factor_config, W
    A1, _ = modalities
    inp = Input(A1, "x")
    cv = cross_validate_graph(
        inp, lambda p: NMFLayer(inp, p["k"], W=W(L1=p["L1"]), name="L"),
        params={"k": [2, 3], "L1": [0.0, 0.01, 0.1]},
        config=factor_config(maxit=10, seed=42),
        reps=1, strategy="random", n_random=3, seed=5)
    assert len(cv.results) == 3                    # subsampled from 6 combos
    assert set(cv.best_params) == {"k", "L1"}


def test_cross_validate_graph_failed_combo_is_nan(modalities):
    """A layer_fn error yields a NaN row, not a crash (R: tryCatch)."""
    A1, _ = modalities
    inp = Input(A1, "x")

    def bad_layer(p):
        if p["k"] == 99:
            raise ValueError("boom")
        return NMFLayer(inp, p["k"], name="L")

    with pytest.warns(UserWarning):
        cv = cross_validate_graph(inp, bad_layer, params={"k": [2, 99]},
                                  reps=1, seed=1)
    bad = [r for r in cv.results if r["k"] == 99]
    assert len(bad) == 1 and np.isnan(bad[0]["test_loss"])
    assert cv.best_params["k"] == 2


def test_global_factor_config_propagates(modalities):
    """factor_config() settings reach every layer as defaults; layer
    kwargs override (R/factor_net.R:103-108)."""
    from rcppml_tpu.models.graph import factor_config
    A1, _ = modalities
    inp = Input(A1, "x")
    cfg = factor_config(maxit=15, seed=3, test_fraction=0.1, cv_seed=9)
    net = factor_net(inp, NMFLayer(inp, 3, name="L"), config=cfg)
    res = fit(net)
    assert np.isfinite(res["L"].test_loss)         # CV ran

    # no CV by default
    net2 = factor_net(inp, NMFLayer(inp, 3, name="L"), maxit=15, seed=3)
    assert np.isnan(fit(net2)["L"].test_loss)


def test_fused_deep_matches_host_loop(modalities):
    """The fused on-device outer ALS produces the same factors as the
    host-driven per-layer loop (fixed sweep count, cholesky solver)."""
    A, _ = modalities
    inp = Input(A, "x")

    def build():
        l1 = NMFLayer(inp, 6, name="L1")
        l2 = NMFLayer(l1, 2, name="L2")
        return factor_net(inp, l2, maxit=8, tol=0.0, seed=42)

    net_f = build()
    res_f = fit(net_f)
    assert net_f._fused_fn is not None             # fused path was taken

    net_h = build()
    net_h._fit_deep_fused = lambda data_map, **kw: None  # force host fallback
    res_h = fit(net_h)

    assert res_f.total_iterations == res_h.total_iterations == 8
    np.testing.assert_allclose(res_f.total_loss, res_h.total_loss,
                               rtol=1e-3)
    for name in ("L1", "L2"):
        np.testing.assert_allclose(res_f[name].W, res_h[name].W,
                                   rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(res_f[name].H, res_h[name].H,
                                   rtol=2e-3, atol=2e-4)


def test_fused_deep_with_branches(modalities):
    """Concat/Add/Condition topologies run through the fused executable."""
    A1, A2 = modalities
    i1, i2 = Input(A1, "a"), Input(A2, "b")
    rs = np.random.RandomState(0)
    Z = rs.rand(60, 2).astype(np.float32)
    l1 = NMFLayer(i1, 3, name="b1")
    l2 = NMFLayer(i2, 2, name="b2")
    top = NMFLayer(Condition(Concat(l1, l2), Z), 2, name="top")
    net = factor_net([i1, i2], top, maxit=6, seed=42)
    res = fit(net)
    assert net._fused_fn is not None
    assert res["top"].W.shape == (60, 2)
    assert res["top"].H.shape == (2, 7)            # k1 + k2 + 2 covariates
    assert np.isfinite(res.total_loss)


def test_deep_irls_loss_falls_back_to_host(modalities):
    """Non-MSE layers are ineligible for the fused sweep and still fit."""
    A, _ = modalities
    inp = Input(np.round(A * 4), "x")
    l1 = NMFLayer(inp, 4, name="L1", loss="gp", solver="cd")
    l2 = NMFLayer(l1, 2, name="L2")
    net = factor_net(inp, l2, maxit=3, seed=42)
    res = fit(net)
    assert net._fused_fn is None                   # host path
    assert np.isfinite(res.total_loss)


def test_svd_layer(modalities):
    from rcppml_tpu.models.graph import SVDLayer
    A, _ = modalities
    inp = Input(A, "x")
    net = factor_net(inp, SVDLayer(inp, 3, name="S1"), maxit=25, seed=42)
    res = fit(net)
    lr = res["S1"]
    assert lr.W.shape == (40, 3)
    # unconstrained layer: negative loadings allowed
    assert (lr.W < 0).any() or (lr.H < 0).any()


def test_layer_with_irls_loss(modalities):
    """nmf_layer(loss='tweedie') runs (test_g1_g6_fixes.R G4)."""
    from rcppml_tpu.models.graph import factor_input, factor_net, fit, nmf_layer
    x = factor_input(np.round(modalities[0] * 4))
    layer = nmf_layer(x, 3, loss="tweedie", tweedie_power=1.4, maxit=4,
                      solver="cd", name="tw")
    res = fit(factor_net([x], layer))
    assert np.isfinite(res.total_loss)
    assert res["tw"].W.shape[1] == 3


def test_layer_with_W_H_builders(modalities):
    """W()/H() config builders feed nmf_layer per-side settings."""
    from rcppml_tpu.models.graph import (H, W, factor_input, factor_net,
                                         fit, nmf_layer)
    x = factor_input(modalities[0])
    layer = nmf_layer(x, 3, W=W(L1=0.05), H=H(L2=0.01), maxit=5, name="reg")
    res = fit(factor_net([x], layer))
    assert np.isfinite(res.total_loss)


def test_nmf_list_input_dispatches_to_factor_net():
    """nmf(list/dict) -> shared-H factor_net (R/nmf_thin.R:279-304,
    test_factor_net.R:248-262)."""
    import rcppml_tpu as rt
    rs = np.random.RandomState(0)
    X1 = np.abs(rs.rand(30, 25)).astype(np.float32)
    X2 = np.abs(rs.rand(18, 25)).astype(np.float32)
    res = rt.nmf({"rna": X1, "adt": X2}, 4, maxit=20, seed=42)
    lr = res["L1"]
    assert set(lr.W_blocks) == {"rna", "adt"}
    assert lr.W_blocks["rna"].shape == (30, 4)
    assert lr.W_blocks["adt"].shape == (18, 4)
    assert lr.H.shape == (4, 25)
    res2 = rt.nmf([X1, X2], 4, maxit=10, seed=42)
    assert set(res2["L1"].W_blocks) == {"modal1", "modal2"}
    with pytest.raises(ValueError, match="2\\+"):
        rt.nmf([X1], 4)
    with pytest.raises(ValueError, match="columns"):
        rt.nmf([X1, X2[:, :10]], 4)


def test_graph_result_predict(modalities):
    """predict.factor_net_result chaining (R/factor_methods.R:742-777)."""
    X = modalities[0]
    inp = factor_input(X, "X")
    net = factor_net([inp], nmf_layer(inp, 5, name="L1"), maxit=50,
                     tol=1e-5, seed=42)
    res = fit(net)
    H_pred = res.predict(X)
    assert H_pred.shape == (5, X.shape[1])
    rs = np.random.RandomState(1)
    X_new = np.abs(rs.rand(X.shape[0], 10)).astype(np.float32)
    assert res.predict(X_new).shape == (5, 10)
    # deep net: chained dict of per-layer projections
    deep = factor_net([inp], nmf_layer(nmf_layer(inp, 6, name="L1"), 3,
                                       name="L2"), maxit=20, seed=42)
    dres = fit(deep)
    out = dres.predict(X_new)
    assert set(out) == {"L1", "L2"}
    assert out["L1"].shape == (6, 10)
    assert out["L2"].shape == (3, 10)


def test_factor_input_spz(tmp_path):
    """.spz path inputs route through the native codec
    (test_factor_net.R:406-447)."""
    import scipy.sparse as sp
    from rcppml_tpu.io.spz import st_write
    rs = np.random.RandomState(2)
    X = np.abs(rs.rand(25, 20)).astype(np.float32)
    X[X < 0.4] = 0
    p = str(tmp_path / "g.spz")
    st_write(sp.csc_matrix(X), p)
    inp = factor_input(p, "xs")
    net = factor_net([inp], nmf_layer(inp, 3, name="L1"), maxit=10, seed=1)
    res = fit(net)
    assert res["L1"].W.shape == (25, 3)
    with pytest.raises(ValueError, match="no such"):
        factor_input(str(tmp_path / "missing.spz"))
    with pytest.raises(ValueError, match="spz"):
        factor_input("/tmp/file.csv")


def test_layer_side_config_does_not_leak(modalities):
    """Layer W/H overrides must not mutate the shared GlobalConfig dots
    (regression: in-place list write leaked into sibling layers)."""
    from rcppml_tpu.models.graph import GlobalConfig
    X = modalities[0]
    from rcppml_tpu.models.graph import W as Wcfg
    cfg = GlobalConfig(maxit=5, seed=1, dots={"L1": [0.0, 0.0]})
    inp = factor_input(X, "X")
    l1 = nmf_layer(inp, 4, name="L1", W=Wcfg(L1=0.4))
    net = factor_net([inp], l1, config=cfg)
    fit(net)
    assert cfg.dots == {"L1": [0.0, 0.0]}


def test_multimodal_dispatch_forwards_kwargs():
    """nmf(list, ...) forwards loss/regularization/CV kwargs to the net
    (regression: silently dropped)."""
    import rcppml_tpu as rt
    rs = np.random.RandomState(5)
    X1 = np.abs(rs.rand(30, 25)).astype(np.float32)
    X2 = np.abs(rs.rand(18, 25)).astype(np.float32)
    plain = rt.nmf({"a": X1, "b": X2}, 3, maxit=15, seed=42)
    reg = rt.nmf({"a": X1, "b": X2}, 3, maxit=15, seed=42, L1=(0.0, 0.3))
    h_plain = np.asarray(plain["L1"].H)
    h_reg = np.asarray(reg["L1"].H)
    assert (h_reg == 0).mean() > (h_plain == 0).mean()
    cv = rt.nmf({"a": X1, "b": X2}, 3, maxit=15, seed=42,
                test_fraction=0.1, cv_seed=1)
    assert np.isfinite(cv["L1"].test_loss)


# ---------------------------------------------------------------------------
# round-2 additions mirroring test_factor_net.R behaviors not yet covered
# ---------------------------------------------------------------------------

def test_single_layer_matches_nmf_exactly(modalities):
    """factor_net single layer delegates to nmf() with identical results
    (test_factor_net.R:80-92)."""
    import rcppml_tpu as rt
    A, _ = modalities
    inp = factor_input(A, "X")
    net = factor_net(inp, nmf_layer(inp, 5, name="L1"),
                     config=rt.factor_config(maxit=50, tol=1e-4, seed=42))
    fn = fit(net)["L1"]
    direct = rt.nmf(A, 5, maxit=50, tol=1e-4, seed=42)
    np.testing.assert_allclose(np.sort(fn.d)[::-1],
                               np.sort(np.asarray(direct.d))[::-1],
                               rtol=1e-4)


def test_multimodal_matches_concatenated_nmf(modalities):
    """Shared-H fit == nmf() on the row-stacked matrix
    (test_factor_net.R:113-141)."""
    import rcppml_tpu as rt
    A1, A2 = modalities
    i1, i2 = factor_input(A1, "m1"), factor_input(A2, "m2")
    shared = Shared(i1, i2)
    net = factor_net([i1, i2], nmf_layer(shared, 4, name="J"),
                     config=rt.factor_config(maxit=50, seed=42))
    fn = fit(net)["J"]
    cat = rt.nmf(np.vstack([A1, A2]), 4, maxit=50, seed=42)
    np.testing.assert_allclose(np.sort(fn.d)[::-1],
                               np.sort(np.asarray(cat.d))[::-1], rtol=1e-4)
    recat = np.vstack([fn.W_blocks["m1"], fn.W_blocks["m2"]])
    np.testing.assert_allclose(recat, np.asarray(cat.W), atol=1e-6)


def test_layer_W_H_override_hierarchy(modalities):
    """Layer-level L1 with an H() override still yields a valid sorted
    model (test_factor_net.R:94-107)."""
    import rcppml_tpu as rt
    from rcppml_tpu.models.graph import H as Hcfg
    A, _ = modalities
    inp = factor_input(A, "X")
    layer = nmf_layer(inp, 5, name="L1", L1=0.01, H=Hcfg(L1=0.05))
    net = factor_net(inp, layer, config=rt.factor_config(maxit=30, seed=42))
    res = fit(net)["L1"]
    assert res.W.shape[1] == 5 and res.H.shape[0] == 5
    assert (res.d > 0).all()


def test_single_layer_cv_test_loss(modalities):
    """CV settings in factor_config flow into the layer fit
    (test_factor_net.R:355-371)."""
    import rcppml_tpu as rt
    A, _ = modalities
    inp = factor_input(A, "X")
    net = factor_net(inp, nmf_layer(inp, 5, name="L1"),
                     config=rt.factor_config(maxit=30, tol=1e-4, seed=42,
                                             test_fraction=0.1, cv_seed=99,
                                             patience=5))
    res = fit(net)["L1"]
    assert res.test_loss > 0
    assert res.best_test_loss > 0
    assert res.loss > 0


def test_training_logger_deep_fit(modalities):
    """Logger records one entry per outer iteration with total loss and
    per-layer Frobenius norms (test_factor_net.R:333-349)."""
    import rcppml_tpu as rt
    A, _ = modalities
    logger = rt.training_logger()
    inp = factor_input(A, "X")
    l1 = nmf_layer(inp, 8, name="enc")
    l2 = nmf_layer(l1, 3, name="bot")
    net = factor_net(inp, l2,
                     config=rt.factor_config(maxit=10, tol=1e-8, seed=42))
    res = fit(net, logger=logger)
    assert res.logger is logger
    assert len(logger.records) > 0
    keys = set(logger.records[0])
    assert "iter" in keys and "train_loss" in keys
    assert any(k.endswith("_frobenius") for k in keys)


def test_graph_regularization_changes_w(modalities):
    """W-side graph Laplacian produces different, still-nonnegative
    factors (test_factor_net.R:448-479)."""
    import rcppml_tpu as rt
    from rcppml_tpu.models.graph import W as Wcfg
    A, _ = modalities
    m = A.shape[0]
    lap = (np.diag(np.full(m, 2.0)) + np.diag(np.full(m - 1, -1.0), 1)
           + np.diag(np.full(m - 1, -1.0), -1)).astype(np.float32)
    inp = factor_input(A, "X")
    plain = fit(factor_net(inp, nmf_layer(inp, 5, name="L"),
                           config=rt.factor_config(maxit=30, seed=42)))["L"]
    reg = fit(factor_net(
        inp, nmf_layer(inp, 5, name="L",
                       W=Wcfg(graph=lap, graph_lambda=1.0)),
        config=rt.factor_config(maxit=30, seed=42)))["L"]
    assert np.max(np.abs(plain.W - reg.W)) > 1e-4
    assert (reg.W >= -1e-10).all() and (reg.H >= -1e-10).all()


def test_mixed_svd_nmf_deep(modalities):
    """SVD layer feeding an NMF layer (test_factor_net.R:179-193)."""
    import rcppml_tpu as rt
    from rcppml_tpu.models.graph import svd_layer
    A, _ = modalities
    inp = factor_input(A, "X")
    s1 = svd_layer(inp, 8, name="pca")
    l2 = nmf_layer(s1, 3, name="top")
    net = factor_net(inp, l2, config=rt.factor_config(maxit=10, seed=42))
    res = fit(net)
    assert res["top"].W.shape[1] == 3
    assert np.isfinite(res.total_loss)


def test_svd_layer_signed_factors(modalities):
    """svd_layer factors may be negative, unlike NMF layers
    (test_factor_net.R:214-225)."""
    import rcppml_tpu as rt
    from rcppml_tpu.models.graph import svd_layer
    A, _ = modalities
    B = A - A.mean()       # signed data
    inp = factor_input(B, "X")
    net = factor_net(inp, svd_layer(inp, 3, name="S"),
                     config=rt.factor_config(maxit=10, seed=1))
    res = fit(net)["S"]
    assert (res.W < 0).any() or (res.H < 0).any()


def test_factor_input_rejects_missing_spz(tmp_path):
    """Nonexistent .spz path errors at construction
    (test_factor_net.R:406-408)."""
    with pytest.raises(ValueError, match="spz"):
        factor_input(str(tmp_path / "nope.spz"), "X")


def test_graph_repr_methods(modalities):
    """print methods run without error (test_factor_net.R:505-520)."""
    import rcppml_tpu as rt
    A, _ = modalities
    inp = factor_input(A, "X")
    net = factor_net(inp, nmf_layer(inp, 3, name="L1"),
                     config=rt.factor_config(maxit=5, seed=1))
    assert repr(net)
    res = fit(net)
    assert repr(res)


# ---------------------------------------------------------------------------
# Edge cases: cycles, dim mismatches at shared/concat/add nodes (round-3
# VERDICT #9; the reference host-loops these topologies in graph/fit.hpp)
# ---------------------------------------------------------------------------

def test_cycle_raises(modalities):
    A, _ = modalities
    inp = Input(A, "x")
    l1 = NMFLayer(inp, 2, name="a")
    l2 = NMFLayer(l1, 2, name="b")
    l1.input = l2                              # manual cycle a <-> b
    with pytest.raises(ValueError, match="cycle"):
        factor_net(inp, l2)


def test_shared_unequal_columns_raises(modalities):
    A, _ = modalities
    i1 = Input(A, "a")                         # 40 x 60
    i2 = Input(np.random.rand(10, 59).astype(np.float32), "b")
    shared = Shared(i1, i2)
    net = factor_net([i1, i2], NMFLayer(shared, 2, name="s"), maxit=3)
    with pytest.raises(ValueError, match="equal columns"):
        fit(net)


def test_concat_mismatched_samples_raises(modalities):
    A, B = modalities
    i1 = Input(A, "a")                         # H over 60 cols
    i2 = Input(B[:, :50], "b")                 # H over 50 cols
    l1 = NMFLayer(i1, 2, name="a")
    l2 = NMFLayer(i2, 2, name="b")
    top = NMFLayer(Concat(l1, l2), 2, name="top")
    net = factor_net([i1, i2], top, maxit=3)
    with pytest.raises(ValueError, match="mismatched sample"):
        fit(net)


def test_concat_branch_not_layer_raises(modalities):
    A, B = modalities
    i1 = Input(A, "a")
    i2 = Input(B, "b")
    l1 = NMFLayer(i1, 2, name="a")
    top = NMFLayer(Concat(l1, i2), 2, name="top")
    net = factor_net([i1, i2], top, maxit=3)
    with pytest.raises(ValueError, match="not a layer"):
        fit(net)


def test_add_mismatched_rank_raises(modalities):
    A, B = modalities
    i1 = Input(A, "a")
    i2 = Input(B, "b")
    l1 = NMFLayer(i1, 2, name="a")
    l2 = NMFLayer(i2, 3, name="b")             # different k
    top = NMFLayer(Add(l1, l2), 2, name="top")
    net = factor_net([i1, i2], top, maxit=3)
    with pytest.raises(ValueError, match="mismatched H shapes"):
        fit(net)


def test_per_layer_losses_differ(modalities):
    A, _ = modalities
    inp = Input(A, "x")
    l1 = NMFLayer(inp, 5, name="L1")
    l2 = NMFLayer(l1, 2, name="L2")
    res = fit(factor_net(inp, l2, maxit=25, seed=7))
    # per-layer losses come from the loss history, not the total duplicated
    assert res["L1"].loss != res["L2"].loss
    assert np.isfinite(res["L1"].loss) and np.isfinite(res["L2"].loss)


def test_graph_fit_on_mesh_matches_single(modalities):
    """Fused whole-graph outer ALS under GSPMD on an 8-virtual-device
    (rows, cols) mesh: uneven dims are zero-padded (exact for the
    MSE layers), pads stripped; factors match single-device fp32-tight."""
    import jax
    from rcppml_tpu.parallel.mesh import default_mesh
    A1, A2 = modalities                  # 40x60 and 25x60 (uneven on mesh)
    if len(jax.devices("cpu")) < 8:
        pytest.skip("needs the 8-virtual-device CPU mesh")
    mesh = default_mesh(jax.devices("cpu")[:8])
    i1, i2 = Input(A1, "rna"), Input(A2, "adt")
    shared = Shared(i1, i2)

    def build():
        l1 = NMFLayer(shared, 4, name="J")
        l2 = NMFLayer(l1, 2, name="T")
        return factor_net([i1, i2], l2, maxit=6, tol=0.0, seed=3)

    r_mesh = fit(build(), mesh=mesh)
    r_one = fit(build())
    for name in ("J", "T"):
        assert r_mesh[name].W.shape == r_one[name].W.shape
        np.testing.assert_allclose(r_mesh[name].W, r_one[name].W, atol=1e-4)
    assert set(r_mesh["J"].W_blocks) == {"rna", "adt"}
    assert r_mesh["J"].W_blocks["rna"].shape == (40, 4)


def test_graph_mesh_rejects_host_loop_layers(modalities):
    """mesh= on a graph that must run the host loop (IRLS loss) raises
    instead of silently single-deviceing (the round-2 silent-drop class)."""
    import jax
    from rcppml_tpu.parallel.mesh import default_mesh
    A, _ = modalities
    if len(jax.devices("cpu")) < 8:
        pytest.skip("needs the 8-virtual-device CPU mesh")
    mesh = default_mesh(jax.devices("cpu")[:8])
    inp = Input(A, "x")
    l1 = NMFLayer(inp, 3, name="a", loss="nb")
    l2 = NMFLayer(l1, 2, name="b")
    net = factor_net(inp, l2, maxit=3)
    with pytest.raises(ValueError, match="mesh"):
        fit(net, mesh=mesh)


def test_graph_mesh_with_condition_covariates(modalities):
    """Round-3 review finding: covariates on a layer whose input needs
    mesh padding must pad the SAMPLE axis of Z (both orientations) and
    not mis-count covariate columns against padded dims."""
    import jax
    from rcppml_tpu.parallel.mesh import default_mesh
    mesh = default_mesh(jax.devices("cpu")[:8])
    rs = np.random.RandomState(0)
    A = np.abs(rs.rand(37, 61)).astype(np.float32)   # uneven on (2,4) mesh
    Z = rs.rand(61, 3).astype(np.float32)

    def build(zmat):
        inp = Input(A, "x")
        l1 = NMFLayer(inp, 4, name="L1")
        l2 = NMFLayer(Condition(l1, zmat), 2, name="L2")
        return factor_net(inp, l2, maxit=5, tol=0.0, seed=11), inp

    net_m, _ = build(Z)
    net_s, _ = build(Z)
    r_mesh = fit(net_m, mesh=mesh)
    r_one = fit(net_s)
    np.testing.assert_allclose(r_mesh["L2"].W, r_one["L2"].W, atol=1e-5)
    # transposed covariate orientation pads axis 1
    net_mt, _ = build(Z.T.copy())
    r_mt = fit(net_mt, mesh=mesh)
    np.testing.assert_allclose(r_mt["L2"].W, r_one["L2"].W, atol=1e-5)


def test_graph_mesh_loss_normalized_by_true_size(modalities):
    """Padded element counts must not understate the per-layer losses
    (round-3 review finding: SSE / padded size)."""
    import jax
    from rcppml_tpu.parallel.mesh import default_mesh
    mesh = default_mesh(jax.devices("cpu")[:8])
    rs = np.random.RandomState(1)
    A = np.abs(rs.rand(37, 61)).astype(np.float32)

    def build():
        inp = Input(A, "x")
        l2 = NMFLayer(NMFLayer(inp, 4, name="L1"), 2, name="L2")
        return factor_net(inp, l2, maxit=5, tol=0.0, seed=7)

    r_mesh = fit(build(), mesh=mesh)
    r_one = fit(build())
    np.testing.assert_allclose(r_mesh["L1"].loss, r_one["L1"].loss,
                               rtol=1e-5)
    np.testing.assert_allclose(r_mesh.total_loss, r_one.total_loss,
                               rtol=1e-5)


def test_graph_dev_cache_invalidates_on_new_data(modalities):
    """Replacing a node's data must re-upload, not fit the stale cached
    device array (round-3 review finding)."""
    rs = np.random.RandomState(2)
    A1 = np.abs(rs.rand(30, 40)).astype(np.float32)
    A2 = np.abs(rs.rand(30, 40)).astype(np.float32)
    inp = Input(A1, "x")
    l2 = NMFLayer(NMFLayer(inp, 3, name="L1"), 2, name="L2")
    net = factor_net(inp, l2, maxit=5, tol=0.0, seed=3)
    r1 = fit(net)
    inp.data = A2
    r2 = fit(net)
    assert abs(r1.total_loss - r2.total_loss) > 1e-6
    # and refitting A2 again matches r2 (cache hit on the new data)
    r3 = fit(net)
    np.testing.assert_allclose(r2.total_loss, r3.total_loss, rtol=1e-6)
