"""The opt-in ``fused_vmem`` Newton-Schulz ALS (models/nmf.py _ns_als_xla).

Contract modeled on ``bf16_data``: explicit opt-in, same ALS fixed point
to ~1e-3, trailing digits differ from the Cholesky loop.
"""

import numpy as np
import pytest

import rcppml_tpu as rt


def _planted(m=160, n=120, k=5, noise=0.0, seed=0):
    rs = np.random.RandomState(seed)
    W = np.abs(rs.normal(size=(m, k))).astype(np.float32)
    H = np.abs(rs.normal(size=(k, n))).astype(np.float32)
    A = W @ H
    if noise:
        A = A + noise * rs.rand(m, n).astype(np.float32)
    return np.maximum(A, 0.0).astype(np.float32)


@pytest.mark.numerics
def test_fused_vmem_recovers_planted_rank():
    A = _planted()
    res = rt.nmf(A, 5, seed=7, maxit=200, tol=0.0, sort_model=False,
                 fused_vmem=True)
    rec = res.W @ np.diag(res.d) @ res.H
    rel = np.linalg.norm(A - rec) / np.linalg.norm(A)
    assert np.isfinite(rel) and rel < 0.05, rel


@pytest.mark.numerics
def test_fused_vmem_matches_default_path_at_convergence():
    # different solver (Newton-Schulz inverse vs Cholesky), same ALS fixed
    # point: converged losses agree to ~1e-2 relative.  noise=0.3 keeps
    # the converged loss well above the fp32 gram-trick cancellation
    # floor (~tr(A'A)*eps), where near-exact fits quantize to 1/32 steps
    # and relative comparison is meaningless (measured rel 5e-4 here).
    A = _planted(noise=0.3, seed=3)
    base = rt.nmf(A, 5, seed=7, maxit=300, tol=0.0, sort_model=False)
    fv = rt.nmf(A, 5, seed=7, maxit=300, tol=0.0, sort_model=False,
                fused_vmem=True)
    b, f = base.loss_history[-1], fv.loss_history[-1]
    assert abs(b - f) / abs(b) < 1e-2, (b, f)


def test_fused_vmem_result_shape_contract():
    A = _planted()
    res = rt.nmf(A, 5, seed=1, maxit=30, tol=0.0, sort_model=False,
                 fused_vmem=True)
    assert res.iterations == 30
    assert res.converged is False          # fixed-iteration contract
    assert len(res.loss_history) == 30
    assert np.all(np.isfinite(res.loss_history))
    assert np.isfinite(res.final_tol)
    assert res.W.shape == (160, 5) and res.H.shape == (5, 120)
    assert np.all(res.W >= 0) and np.all(res.H >= 0) and np.all(res.d > 0)
    # loss decreases overall (NS solves are approximate, so assert the
    # envelope rather than per-step monotonicity)
    assert res.loss_history[-1] < res.loss_history[0]


def test_fused_vmem_deterministic():
    A = _planted(seed=5)
    r1 = rt.nmf(A, 5, seed=9, maxit=40, tol=0.0, sort_model=False,
                fused_vmem=True)
    r2 = rt.nmf(A, 5, seed=9, maxit=40, tol=0.0, sort_model=False,
                fused_vmem=True)
    np.testing.assert_array_equal(r1.W, r2.W)
    np.testing.assert_array_equal(r1.H, r2.H)


@pytest.mark.numerics
def test_fused_vmem_bf16_combo_runs():
    A = _planted(noise=0.05, seed=2)
    res = rt.nmf(A, 5, seed=7, maxit=200, tol=0.0, sort_model=False,
                 fused_vmem=True, bf16_data=True)
    rec = res.W @ np.diag(res.d) @ res.H
    rel = np.linalg.norm(A - rec) / np.linalg.norm(A)
    assert np.isfinite(rel) and rel < 0.10, rel


@pytest.mark.parametrize("kw,frag", [
    (dict(tol=1e-4), "tol"),
    (dict(tol=0.0, L21=(0.0, 0.1)), "tier-2 penalties"),
    (dict(tol=0.0, loss="kl"), "MSE"),
    (dict(tol=0.0, test_fraction=0.1, cv_seed=1), "CV"),
    (dict(tol=0.0, projective=True), "variants"),
])
def test_fused_vmem_rejects_unsupported(kw, frag):
    A = _planted()
    with pytest.raises(ValueError, match=frag):
        rt.nmf(A, 5, fused_vmem=True, sort_model=False, **kw)


def test_fused_vmem_rejects_streaming_and_mesh(tmp_path):
    import scipy.sparse as sp
    from rcppml_tpu.io.spz import st_write
    A = _planted()
    path = str(tmp_path / "a.spz")
    st_write(sp.csc_matrix(A), path)
    with pytest.raises(ValueError, match="chunked|streaming"):
        rt.nmf(path, 5, fused_vmem=True, tol=0.0, maxit=10)
    from rcppml_tpu.parallel.mesh import default_mesh, fit_sharded
    import jax
    mesh = default_mesh(jax.devices("cpu")[:4])
    with pytest.raises(ValueError, match="mesh"):
        fit_sharded(A, rt.build_config(5, tol=0.0, fused_vmem=True,
                                       sort_model=False), mesh)


def test_fused_vmem_l1_l2_matches_standard():
    """L1/L2-penalized fused_vmem (r5: RHS-shift / Gram-diagonal in the
    kernel) tracks the standard cholesky path at NS-inverse tolerance."""
    A = _planted()
    kw = dict(seed=7, maxit=60, sort_model=False, L1=(0.0, 0.01),
              L2=(0.05, 0.0))
    ref = rt.nmf(A, 5, tol=0.0, solver="cholesky", **kw)
    fus = rt.nmf(A, 5, tol=0.0, fused_vmem=True, **kw)
    r_ref = (np.asarray(ref.W) * np.asarray(ref.d)) @ np.asarray(ref.H)
    r_fus = (np.asarray(fus.W) * np.asarray(fus.d)) @ np.asarray(fus.H)
    rel = np.abs(r_ref - r_fus).max() / np.abs(r_ref).max()
    assert np.isfinite(rel) and rel < 0.05, rel
    # the L1 penalty must actually bite: H sparser than unpenalized
    fus0 = rt.nmf(A, 5, tol=0.0, fused_vmem=True, seed=7, maxit=60,
                  sort_model=False)
    assert (np.asarray(fus.H) == 0).mean() >= (np.asarray(fus0.H) == 0).mean()


def test_fused_vmem_rejects_callbacks():
    A = _planted()
    with pytest.raises(ValueError, match="callback"):
        rt.nmf(A, 5, fused_vmem=True, tol=0.0,
               on_iteration=lambda *a: None)


def test_fused_vmem_odd_shapes_and_wide():
    # non-multiple-of-128 dims, wide (n > m), k not a multiple of 8
    rs = np.random.RandomState(8)
    W = np.abs(rs.normal(size=(97, 7))).astype(np.float32)
    H = np.abs(rs.normal(size=(7, 301))).astype(np.float32)
    A = np.maximum(W @ H + 0.1 * rs.rand(97, 301), 0).astype(np.float32)
    res = rt.nmf(A, 7, seed=2, maxit=150, tol=0.0, sort_model=False,
                 fused_vmem=True)
    rec = res.W @ np.diag(res.d) @ res.H
    rel = np.linalg.norm(A - rec) / np.linalg.norm(A)
    assert rel < 0.1, rel


def test_fused_vmem_zero_columns_stay_finite():
    A = _planted(seed=4).copy()
    A[:, :10] = 0.0
    res = rt.nmf(A, 5, seed=2, maxit=60, tol=0.0, sort_model=False,
                 fused_vmem=True)
    assert np.all(np.isfinite(res.W)) and np.all(np.isfinite(res.H))
    assert np.all(np.isfinite(res.loss_history))


def test_fused_vmem_sparse_input_densifies():
    import scipy.sparse as sp
    A = _planted(seed=6)
    A[A < np.percentile(A, 60)] = 0.0
    res_s = rt.nmf(sp.csc_matrix(A), 5, seed=3, maxit=50, tol=0.0,
                   sort_model=False, fused_vmem=True)
    res_d = rt.nmf(A, 5, seed=3, maxit=50, tol=0.0, sort_model=False,
                   fused_vmem=True)
    np.testing.assert_array_equal(res_s.W, res_d.W)


def test_fused_vmem_rejects_checkpointing():
    from rcppml_tpu.utils.checkpoint import fit_checkpointed
    A = _planted()
    with pytest.raises(ValueError, match="checkpoint"):
        fit_checkpointed(A, rt.build_config(5, tol=0.0, fused_vmem=True,
                                            sort_model=False), "/tmp/ck.npz")


def test_fused_vmem_rejects_mask_zeros_direct_path():
    # the public nmf() gateway catches mask='zeros' via the materialized
    # mask array; the direct build_config path must reject it too
    with pytest.raises(ValueError, match="CV/masks"):
        rt.build_config(5, tol=0.0, fused_vmem=True,
                        mask_zeros=True).validate()
    with pytest.raises(ValueError, match="mask"):
        rt.build_config(5, bf16_data=True, mask_zeros=True).validate()


@pytest.mark.numerics
def test_fused_vmem_degenerate_rank_d_floor():
    # k far above the data's effective rank: clipped-to-zero factor rows
    # must produce d = 1e-15 (the clamp floor), never 0 or NaN
    rs = np.random.RandomState(1)
    u = np.abs(rs.normal(size=(80, 1))).astype(np.float32)
    v = np.abs(rs.normal(size=(1, 60))).astype(np.float32)
    A = (u @ v).astype(np.float32)
    res = rt.nmf(A, 6, seed=3, maxit=60, tol=0.0, sort_model=False,
                 fused_vmem=True)
    assert np.all(res.d >= 1e-15) and np.all(np.isfinite(res.d))
    assert np.all(np.isfinite(res.W)) and np.all(np.isfinite(res.H))
