"""Streaming = in-memory parity (reference: test_streaming.R, 276 LoC)."""

import numpy as np
import pytest

import rcppml_tpu as rt
from rcppml_tpu.io.loaders import CachingLoader, InMemoryLoader, SpzLoader
from rcppml_tpu.models.nmf_chunked import nmf_chunked
from rcppml_tpu.utils.simulate import simulate_nmf

pytestmark = pytest.mark.numerics  # numerics-critical subset


@pytest.fixture(scope="module")
def sim():
    return simulate_nmf(m=50, n=200, k=3, noise=0.03, seed=17)


def test_in_memory_loader_panels(sim):
    A = sim["A"]
    ld = InMemoryLoader(A, chunk_cols=64)
    assert ld.num_chunks() == 4
    parts = [ch.data for ch in ld.iter_chunks()]
    np.testing.assert_allclose(np.hstack(parts), A)
    partsT = [ch.data for ch in ld.iter_chunks(transpose=True)]
    np.testing.assert_allclose(np.hstack(partsT), A.T)


def test_streaming_matches_in_memory(sim):
    """Chunked ALS must match the in-memory fit (same data, same seed)."""
    A = sim["A"]
    cfg = rt.build_config(3, seed=42, maxit=25, tol=0.0, sort_model=False)
    from rcppml_tpu.models.nmf import nmf_fit
    res_mem = nmf_fit(A, cfg)
    res_str = nmf_chunked(InMemoryLoader(A, chunk_cols=64), cfg)
    np.testing.assert_allclose(res_str.train_loss, res_mem.train_loss,
                               rtol=1e-3)
    np.testing.assert_allclose(res_str.W, res_mem.W, rtol=2e-2, atol=2e-3)


def test_spz_streaming_roundtrip(sim, tmp_path):
    from rcppml_tpu.io.spz import st_write
    A = sim["A"].copy()
    A[A < 0.2] = 0          # sparsify for spz
    path = str(tmp_path / "stream.spz")
    st_write(A, path, with_transpose=True)

    res = rt.nmf(path, 3, seed=42, maxit=15, tol=0.0, sort_model=False)
    cfg = rt.build_config(3, seed=42, maxit=15, tol=0.0, sort_model=False)
    from rcppml_tpu.models.nmf import nmf_fit
    res_mem = nmf_fit(A, cfg)
    np.testing.assert_allclose(res.train_loss, res_mem.train_loss, rtol=1e-3)


def test_streaming_irls_kl(sim):
    """Streaming KL-IRLS (GP->KL, fixed dispersion like the reference
    chunked engine, fit_chunked.hpp:165-172,300-318) matches the in-memory
    KL fit."""
    from rcppml_tpu.models.nmf import nmf_fit
    A = np.maximum(sim["A"], 0)
    cfg = rt.build_config(3, loss="gp", dispersion="none", solver="cd",
                          seed=4, maxit=6, tol=0.0, sort_model=False)
    mem = nmf_fit(A, cfg)
    stream = nmf_chunked(InMemoryLoader(A, chunk_cols=32), cfg)
    assert np.isfinite(stream.train_loss)
    np.testing.assert_allclose(stream.train_loss, mem.train_loss, rtol=1e-3)
    np.testing.assert_allclose(stream.W, mem.W, rtol=2e-2, atol=2e-3)


def test_streaming_nb_fixed_size(sim):
    """Streaming NB runs with the fixed per-row size vector; theta is
    reported at its init value (reference chunked semantics)."""
    A = np.round(np.maximum(sim["A"], 0) * 5)
    cfg = rt.build_config(3, loss="nb", dispersion="per_row", solver="cd",
                          nb_size_init=8.0, seed=4, maxit=4, tol=0.0,
                          sort_model=False)
    res = nmf_chunked(InMemoryLoader(A, chunk_cols=32), cfg)
    assert np.isfinite(res.train_loss)
    np.testing.assert_allclose(res.theta, 8.0)


def test_streaming_gp_zi_rejected(sim):
    """GP-family ZI needs per-iteration theta (frozen in streaming mode)."""
    cfg = rt.build_config(3, loss="gp", dispersion="per_row", zi="row",
                          solver="cd", maxit=3)
    with pytest.raises(NotImplementedError, match="zero-inflation"):
        nmf_chunked(InMemoryLoader(sim["A"]), cfg)


@pytest.fixture(scope="module")
def zi_sim():
    rs = np.random.RandomState(21)
    mu = np.abs(rs.rand(40, 160) @ np.ones((160, 160)) * 0) \
        + np.abs(rs.rand(40, 3) @ rs.rand(3, 160)) * 6.0
    counts = rs.poisson(mu).astype(np.float32)
    drop_rate = np.where(np.arange(40) < 20, 0.5, 0.05)[:, None]
    keep = rs.rand(40, 160) >= drop_rate
    return (counts * keep).astype(np.float32)


def test_streaming_nb_zi_row(zi_sim):
    """NB+ZI streams (beyond the reference, which has no chunked ZI branch):
    pi_row tracks the planted per-row dropout and the NLL decreases."""
    cfg = rt.build_config(3, loss="nb", dispersion="per_row", zi="row",
                          solver="cd", seed=7, maxit=10, tol=0.0,
                          sort_model=False)
    res = nmf_chunked(InMemoryLoader(zi_sim, chunk_cols=48), cfg)
    pi = np.asarray(res.pi_row)
    assert pi.shape == (40,) and np.all(pi >= 0.001) and np.all(pi <= 0.999)
    # rows 0..19 had 10x the dropout of rows 20..39
    assert pi[:20].mean() > pi[20:].mean() + 0.1
    # plain-NLL-on-raw-A drifts up as imputation kicks in — the in-memory
    # EM shows the exact same trajectory shape, so only finiteness is a
    # valid invariant here
    hist = np.asarray(res.loss_history)
    assert np.isfinite(hist).all()
    # factors stay close to an in-memory NB+ZI fit of the same data
    mem = rt.nmf(zi_sim, 3, loss="nb", dispersion="per_row", zi="row",
                 seed=7, maxit=10, tol=0.0, sort_model=False)
    rec_s = (np.asarray(res.W) * np.asarray(res.d)) @ np.asarray(res.H)
    rec_m = (np.asarray(mem.W) * np.asarray(mem.d)) @ np.asarray(mem.H)
    denom = float(np.linalg.norm(rec_m))
    assert np.linalg.norm(rec_s - rec_m) / denom < 0.25
    # pi agrees with the in-memory EM estimate
    assert np.corrcoef(pi, np.asarray(mem.pi_row))[0, 1] > 0.9


def test_streaming_nb_zi_col(zi_sim):
    cfg = rt.build_config(3, loss="nb", dispersion="per_col", zi="col",
                          solver="cd", seed=7, maxit=8, tol=0.0,
                          sort_model=False)
    res = nmf_chunked(InMemoryLoader(zi_sim.T.copy(), chunk_cols=16), cfg)
    pi = np.asarray(res.pi_col)
    assert pi.shape == (40,)
    assert pi[:20].mean() > pi[20:].mean() + 0.1
    assert np.isfinite(np.asarray(res.loss_history)).all()


def test_streaming_zi_cv_rejected(zi_sim):
    cfg = rt.build_config(3, loss="nb", zi="row", solver="cd", maxit=3,
                          test_fraction=0.1, cv_seed=1)
    with pytest.raises(NotImplementedError, match="zero-inflation"):
        nmf_chunked(InMemoryLoader(zi_sim), cfg)


def test_caching_loader(sim):
    inner = InMemoryLoader(sim["A"], chunk_cols=64)
    ld = CachingLoader(inner)
    c1 = ld.chunk(0)
    c2 = ld.chunk(0)
    assert c1 is c2


def test_v3_dense_streaming(sim, tmp_path):
    """Streaming NMF from a v3 dense .spz file (DenseSpzLoader analog)."""
    from rcppml_tpu.io.spz import st_write_dense
    A = sim["A"]
    path = str(tmp_path / "dense.spz")
    st_write_dense(A, path, chunk_cols=64)
    res = rt.nmf(path, 3, seed=42, maxit=12, tol=0.0, sort_model=False)
    cfg = rt.build_config(3, seed=42, maxit=12, tol=0.0, sort_model=False)
    from rcppml_tpu.models.nmf import nmf_fit
    res_mem = nmf_fit(A, cfg)
    np.testing.assert_allclose(res.train_loss, res_mem.train_loss, rtol=1e-3)


def test_streaming_cv_matches_in_memory(tmp_path):
    """Streaming speckled CV equals the in-memory CV fit: the panel masks
    come from the same traced hash (fit_streaming_spz.hpp:129-386 analog)."""
    from rcppml_tpu.models.nmf_cv import fit_cv_or_masked
    from rcppml_tpu.models.nmf_chunked import nmf_chunked
    from rcppml_tpu.io.loaders import InMemoryLoader
    from rcppml_tpu.utils.simulate import simulate_nmf
    import rcppml_tpu as rt

    sim = simulate_nmf(m=48, n=80, k=3, noise=0.05, seed=31)
    cfg = rt.build_config(3, seed=9, maxit=8, tol=0.0, test_fraction=0.15,
                          cv_seed=4, sort_model=False)
    mem = fit_cv_or_masked(sim["A"], cfg)
    stream = nmf_chunked(InMemoryLoader(sim["A"], chunk_cols=32), cfg)
    assert np.isfinite(stream.test_loss)
    np.testing.assert_allclose(stream.test_loss, mem.test_loss, rtol=2e-3)
    np.testing.assert_allclose(stream.W, mem.W, rtol=5e-3, atol=5e-4)


def test_streaming_cv_from_spz(tmp_path):
    """nmf('file.spz', k, test_fraction=...) runs holdout CV out of core."""
    import scipy.sparse as sp
    import rcppml_tpu as rt
    from rcppml_tpu.io.spz import st_write
    from rcppml_tpu.utils.simulate import simulate_nmf
    sim = simulate_nmf(m=40, n=64, k=3, noise=0.05, seed=7)
    A = sim["A"].copy()
    A[A < np.quantile(A, 0.5)] = 0          # sparsify for the codec
    p = str(tmp_path / "cv.spz")
    st_write(sp.csc_matrix(A), p, chunk_cols=24, with_transpose=True)
    res = rt.nmf(p, 3, seed=2, maxit=6, tol=0.0, test_fraction=0.2,
                 cv_seed=5, mask_zeros=True)
    assert np.isfinite(res.test_loss)
    assert res.test_loss_history is not None
    assert len(res.test_loss_history) == res.iterations
    assert "best_test_loss" in res.misc


def test_streaming_svd_init(sim):
    """seed='lanczos' on a streaming fit runs the init SVD out of core
    (better than the reference's full decompress, fit_streaming_spz.hpp)."""
    from rcppml_tpu.models.nmf import nmf_fit
    A = sim["A"]
    cfg = rt.build_config(3, seed="lanczos", maxit=10, tol=0.0,
                          sort_model=False)
    stream = nmf_chunked(InMemoryLoader(A, chunk_cols=64), cfg)
    mem = nmf_fit(A, cfg)
    assert np.isfinite(stream.train_loss)
    np.testing.assert_allclose(stream.train_loss, mem.train_loss, rtol=1e-3)


def test_streaming_user_mask_matches_in_memory(sim):
    """Streaming masked NMF (user mask, no CV) equals the in-memory masked
    fit (streaming mask_sexp analog)."""
    from rcppml_tpu.models.nmf_cv import fit_cv_or_masked
    rs = np.random.RandomState(8)
    A = sim["A"]
    mask = rs.uniform(size=A.shape) < 0.15
    cfg = rt.build_config(3, seed=6, maxit=8, tol=0.0, has_mask=True,
                          sort_model=False)
    mem = fit_cv_or_masked(A, cfg, mask=mask)
    stream = nmf_chunked(InMemoryLoader(A, chunk_cols=64), cfg, mask=mask)
    assert np.isfinite(stream.train_loss)
    np.testing.assert_allclose(stream.W, mem.W, rtol=5e-3, atol=5e-4)


def test_streaming_mask_shape_error(sim):
    cfg = rt.build_config(3, maxit=3, has_mask=True)
    with pytest.raises(ValueError, match="mask shape"):
        nmf_chunked(InMemoryLoader(sim["A"]), cfg,
                    mask=np.zeros((3, 3), bool))


def test_streaming_graph_reg(sim):
    """Graph Laplacian on H in the streaming path (graph_H_sexp analog):
    matches the in-memory graph-regularized fit."""
    from rcppml_tpu.models.nmf import nmf_fit
    A = sim["A"]
    n = A.shape[1]
    # chain-graph Laplacian over samples
    L = (np.diag(np.r_[1, np.full(n - 2, 2.0), 1])
         - np.eye(n, k=1) - np.eye(n, k=-1)).astype(np.float32)
    cfg = rt.build_config(3, seed=11, maxit=8, tol=0.0, sort_model=False,
                          graph_lambda=(0.0, 0.05), has_graph_H=True)
    mem = nmf_fit(A, cfg, aux={"graph_H": L})
    stream = nmf_chunked(InMemoryLoader(A, chunk_cols=64), cfg, graph_H=L)
    np.testing.assert_allclose(stream.W, mem.W, rtol=5e-3, atol=5e-4)


def test_streaming_projective(sim):
    """Projective streaming NMF: H = diag(d) W^T A per panel."""
    from rcppml_tpu.models.nmf import nmf_fit
    A = sim["A"]
    cfg = rt.build_config(3, seed=11, maxit=6, tol=0.0, sort_model=False,
                          projective=True)
    mem = nmf_fit(A, cfg)
    stream = nmf_chunked(InMemoryLoader(A, chunk_cols=64), cfg)
    np.testing.assert_allclose(stream.W, mem.W, rtol=5e-3, atol=5e-4)


def test_streaming_symmetric_rejected(sim):
    cfg = rt.build_config(3, maxit=3, symmetric=True)
    S = sim["A"][:, :50] @ sim["A"][:, :50].T
    with pytest.raises(NotImplementedError):
        nmf_chunked(InMemoryLoader(S), cfg)


def test_streaming_zi_mask_zeros_rejected(zi_sim):
    """Imputation would destroy the zeros that mask_zeros keys on."""
    cfg = rt.build_config(3, loss="nb", zi="row", solver="cd", maxit=3,
                          mask_zeros=True)
    with pytest.raises(NotImplementedError, match="zero-inflation"):
        nmf_chunked(InMemoryLoader(zi_sim), cfg)


def test_streaming_zi_em_iters_warns(zi_sim):
    cfg = rt.build_config(3, loss="nb", zi="row", solver="cd", maxit=2,
                          tol=0.0, zi_em_iters=4)
    with pytest.warns(UserWarning, match="ONE pi EM update"):
        nmf_chunked(InMemoryLoader(zi_sim, chunk_cols=48), cfg)


def test_streaming_checkpoint_path_writes(sim, tmp_path):
    """The host-driven streaming loop checkpoints at sweep granularity
    (round-3: was refused; bitwise-resume coverage lives in
    tests/test_mesh_streaming.py)."""
    import os
    ck = str(tmp_path / "ck.npz")
    rt.nmf(sim["A"], 3, streaming=True, maxit=3, checkpoint_path=ck)
    assert os.path.exists(ck)


def test_panel_cache_off_matches_on():
    """panel_cache=False keeps the strict O(panel) device footprint and
    must produce the same fit as the cached path (round-3 review)."""
    import rcppml_tpu as rt
    from rcppml_tpu.io.loaders import InMemoryLoader
    from rcppml_tpu.models.nmf_chunked import nmf_chunked
    rs = np.random.RandomState(5)
    A = np.abs(rs.rand(60, 90)).astype(np.float32)
    cfg = rt.build_config(4, seed=2, maxit=5, tol=0.0, sort_model=False)
    r_on = nmf_chunked(InMemoryLoader(A, chunk_cols=40), cfg,
                       panel_cache=True)
    r_off = nmf_chunked(InMemoryLoader(A, chunk_cols=40), cfg,
                        panel_cache=False)
    np.testing.assert_array_equal(np.asarray(r_on.W), np.asarray(r_off.W))


def test_loaderop_interrupted_pass_not_cached_partial():
    """An abandoned/failed panel pass must not leave a PARTIAL panel set
    that later cache hits silently serve (round-3 session fix): a full
    mm() after an interrupted pass must still see every panel."""
    from rcppml_tpu.io.loaders import InMemoryLoader
    from rcppml_tpu.models.svd import _LoaderOp
    rs = np.random.RandomState(7)
    A = rs.rand(40, 70).astype(np.float32)
    op = _LoaderOp(InMemoryLoader(A, chunk_cols=20), panel_cache=True)
    it = op._panels(False)
    next(it)          # consume ONE panel...
    it.close()        # ...then abandon the pass
    X = rs.rand(70, 3).astype(np.float32)
    np.testing.assert_allclose(np.asarray(op.mm(X)), A @ X, rtol=2e-5,
                               atol=2e-5)
    # and the cache must now be complete + correct on the hit path
    np.testing.assert_allclose(np.asarray(op.mm(X)), A @ X, rtol=2e-5,
                               atol=2e-5)


# ---------------------------------------------------------------------------
# Sparse device panels (nnz-proportional ingest — VERDICT r4)
# ---------------------------------------------------------------------------

def test_sparse_panels_bitwise_equals_dense():
    """COO upload + on-device scatter densify must produce the SAME dense
    panel as host densification — fits are bitwise identical."""
    import scipy.sparse as sp
    from rcppml_tpu.models.nmf_chunked import nmf_chunked
    from rcppml_tpu.io.loaders import InMemoryLoader
    rs = np.random.RandomState(5)
    A = sp.random(180, 140, density=0.08, random_state=rs,
                  format="csc").astype(np.float32)
    cfg = rt.build_config(5, seed=3, maxit=8, tol=0.0, sort_model=False)
    r_d = nmf_chunked(InMemoryLoader(A, chunk_cols=48), cfg,
                      sparse_panels=False, panel_cache=False)
    r_s = nmf_chunked(InMemoryLoader(A, chunk_cols=48), cfg,
                      sparse_panels=True, panel_cache=False)
    assert np.array_equal(r_d.W, r_s.W)
    assert np.array_equal(r_d.H, r_s.H)
    assert r_d.train_loss == r_s.train_loss


def test_sparse_panels_auto_by_density():
    """Auto mode: sparse for low-density sparse loaders, dense otherwise;
    explicit sparse_panels=True on a dense loader raises."""
    import scipy.sparse as sp
    from rcppml_tpu.models.nmf_chunked import nmf_chunked
    from rcppml_tpu.io.loaders import InMemoryLoader
    rs = np.random.RandomState(6)
    A = sp.random(120, 90, density=0.05, random_state=rs,
                  format="csc").astype(np.float32)
    cfg = rt.build_config(4, seed=1, maxit=4, tol=0.0, sort_model=False)
    # auto (None) on 5% density must match the explicit sparse fit bitwise
    r_auto = nmf_chunked(InMemoryLoader(A, chunk_cols=40), cfg,
                         panel_cache=False)
    r_sp = nmf_chunked(InMemoryLoader(A, chunk_cols=40), cfg,
                       sparse_panels=True, panel_cache=False)
    assert np.array_equal(r_auto.W, r_sp.W)
    with pytest.raises((ValueError, NotImplementedError)):
        nmf_chunked(InMemoryLoader(np.abs(rs.rand(30, 20)), chunk_cols=10),
                    cfg, sparse_panels=True)


def test_sparse_panels_irls_and_cv_paths():
    """Sparse panels compose with the IRLS and CV panel solvers."""
    import scipy.sparse as sp
    from rcppml_tpu.models.nmf_chunked import nmf_chunked
    from rcppml_tpu.io.loaders import InMemoryLoader
    rs = np.random.RandomState(7)
    A = sp.random(100, 80, density=0.1, random_state=rs,
                  format="csc").astype(np.float32)
    A.data[:] = np.ceil(A.data * 9)
    for kw in (dict(loss="nb", dispersion="per_row"),
               dict(test_fraction=0.1, cv_seed=2)):
        cfg = rt.build_config(4, seed=1, maxit=5, tol=0.0,
                              sort_model=False, **kw)
        r_d = nmf_chunked(InMemoryLoader(A, chunk_cols=32), cfg,
                          sparse_panels=False, panel_cache=False)
        r_s = nmf_chunked(InMemoryLoader(A, chunk_cols=32), cfg,
                          sparse_panels=True, panel_cache=False)
        assert np.array_equal(r_d.W, r_s.W), kw


def test_wire_cache_fused_sweep_matches_per_panel():
    """The single-dispatch cached sweep (r5) must reproduce the per-panel
    streaming path: plain MSE, L1+CD, and L2 configs."""
    import scipy.sparse as sp
    rs = np.random.RandomState(0)
    A = sp.random(300, 500, density=0.05, random_state=rs, format="csc",
                  dtype=np.float32)
    for kw in (dict(), dict(L1=(0.0, 0.05), solver="cd"),
               dict(L2=(0.1, 0.0))):
        cfg = rt.build_config(6, seed=3, maxit=6, tol=0.0,
                              sort_model=False, **kw)
        rn = nmf_chunked(InMemoryLoader(A, chunk_cols=97), cfg,
                         panel_cache=False)
        rw = nmf_chunked(InMemoryLoader(A, chunk_cols=97), cfg,
                         panel_cache="wire")
        assert np.abs(np.asarray(rn.W) - np.asarray(rw.W)).max() < 1e-5
        assert abs(rn.train_loss - rw.train_loss) <= \
            1e-5 * abs(rn.train_loss)


def test_wire_cache_fused_cv_sweep_matches_per_panel():
    """CV variant: identical holdout accounting (incl. the pad columns of
    the last panel) and identical factors, both mask_zeros modes."""
    import scipy.sparse as sp
    rs = np.random.RandomState(0)
    A = sp.random(300, 500, density=0.05, random_state=rs, format="csc",
                  dtype=np.float32)
    for mz in (False, True):
        cfg = rt.build_config(6, seed=3, maxit=6, tol=0.0,
                              sort_model=False, test_fraction=0.1,
                              cv_seed=7, cv_patience=10**6, mask_zeros=mz)
        rn = nmf_chunked(InMemoryLoader(A, chunk_cols=97), cfg,
                         panel_cache=False)
        rw = nmf_chunked(InMemoryLoader(A, chunk_cols=97), cfg,
                         panel_cache="wire")
        assert np.abs(np.asarray(rn.W) - np.asarray(rw.W)).max() < 1e-5
        assert abs(rn.test_loss - rw.test_loss) <= \
            1e-5 * max(abs(rn.test_loss), 1e-9)
        assert rn.best_iter == rw.best_iter


def test_wire_cache_fused_irls_sweep_matches_per_panel():
    """Plain streaming IRLS (fixed dispersion) fused sweep == per-panel
    path for KL and NB."""
    import scipy.sparse as sp
    rs = np.random.RandomState(0)
    d_ = (rs.poisson(1.2, (300, 500))
          * (rs.rand(300, 500) < 0.2)).astype(np.float32)
    A = sp.csc_matrix(d_)
    for kw in (dict(loss="kl"), dict(loss="nb", dispersion="per_row")):
        cfg = rt.build_config(6, seed=3, maxit=5, tol=0.0,
                              sort_model=False, **kw)
        rn = nmf_chunked(InMemoryLoader(A, chunk_cols=97), cfg,
                         panel_cache=False)
        rw = nmf_chunked(InMemoryLoader(A, chunk_cols=97), cfg,
                         panel_cache="wire")
        assert np.abs(np.asarray(rn.W) - np.asarray(rw.W)).max() < 1e-5
        assert abs(rn.train_loss - rw.train_loss) <= \
            1e-5 * abs(rn.train_loss)
