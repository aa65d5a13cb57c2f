"""Fused CD NNLS kernels (ops/pallas_kernels.py) against the lax sweep.

The kernels run here in Pallas interpret mode, where they perform the same
fp32 operations in the same order as ``solvers._cd_sweeps`` /
``_cd_sweeps_batched``: the assertion is array_equal, not allclose.  The
``gpu``-marked tests compile them for the card; they skip on the CPU and
run with ``RCPPML_GPU_TESTS=1 python -m pytest -m gpu tests/``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from rcppml_tpu import backend
from rcppml_tpu.ops import pallas_kernels as pk
from rcppml_tpu.ops import solvers as S

TOL = 5e-6  # constants.CD_TOL_F32_FLOOR: the per-sweep exit of fp32 solves


def _system(k, n, seed, batched=False, dead_coord=False):
    """A CD system in residual form: SPD Gram(s), a noisy RHS, X0 = 0."""
    rs = np.random.RandomState(seed)
    F = np.abs(rs.normal(size=(k, 2 * k + 16))).astype(np.float32)
    if dead_coord:
        F[k // 2, :] = 0.0
    G = (F @ F.T).astype(np.float32)
    X = np.maximum(rs.normal(size=(k, n)), 0).astype(np.float32)
    if batched:
        u = rs.uniform(size=(n, k)).astype(np.float32) * np.diag(G).mean()
        if dead_coord:
            u[:, k // 2] = 0.0
        G = (G[None] + u[:, :, None] * np.eye(k, dtype=np.float32)[None])
        B = np.einsum("nkl,ln->kn", G, X)
    else:
        B = G @ X
    B = (B + 0.3 * np.abs(B).mean() * rs.normal(size=B.shape)).astype(
        np.float32)
    return jnp.asarray(G), jnp.asarray(B), jnp.zeros((k, n), jnp.float32)


def _lax(G, B, X0, l1, batched, maxit=100):
    if batched:
        return S._cd_sweeps_batched(G, B, X0, jnp.float32(l1),
                                    jnp.float32(TOL), nonneg=True,
                                    maxit=maxit)
    return S._cd_sweeps(G, B, X0, jnp.float32(l1), jnp.float32(TOL),
                        nonneg=True, maxit=maxit, l1_static=True)


def _kernel(G, B, X0, l1, batched, maxit=100, interpret=True, **kw):
    fn = pk.cd_nnls_batched if batched else pk.cd_nnls_shared
    return fn(G, B, X0, l1, TOL, nonneg=True, maxit=maxit,
              interpret=interpret, **kw)


# n = 45 is not a multiple of the 32-column block and k = 50, 100 are not
# powers of two, so the cases also cover the padded tail block and the
# padded (dead) coordinates.
@pytest.mark.parametrize("l1", [0.0, 0.05], ids=["l1off", "l1on"])
@pytest.mark.parametrize("k", [8, 16, 50, 64, 100])
@pytest.mark.parametrize("batched", [False, True], ids=["shared", "batched"])
def test_kernel_bitwise_interpret(batched, k, l1):
    G, B, X0 = _system(k, 45, seed=k, batched=batched)
    np.testing.assert_array_equal(np.asarray(_kernel(G, B, X0, l1, batched)),
                                  np.asarray(_lax(G, B, X0, l1, batched)))


@pytest.mark.parametrize("batched", [False, True], ids=["shared", "batched"])
def test_kernel_dead_coordinate_interpret(batched):
    """A coordinate with g = 0 is skipped entirely, L1 included."""
    G, B, X0 = _system(12, 37, seed=3, batched=batched, dead_coord=True)
    out = np.asarray(_kernel(G, B, X0, 0.1, batched))
    np.testing.assert_array_equal(out, np.asarray(_lax(G, B, X0, 0.1,
                                                       batched)))
    assert np.all(out[6] == 0.0)


@pytest.mark.parametrize("batched", [False, True], ids=["shared", "batched"])
def test_kernel_upper_bound_and_warm_start_interpret(batched):
    G, B, _ = _system(10, 70, seed=5, batched=batched)
    X0 = jnp.full(B.shape, 0.5, jnp.float32)
    fn = S._cd_sweeps_batched if batched else S._cd_sweeps
    kw = {} if batched else {"l1_static": True}
    ref = fn(G, B, X0, jnp.float32(0.0), jnp.float32(TOL), nonneg=True,
             maxit=7, upper_bound=1.0, **kw)
    out = _kernel(G, B, X0, 0.0, batched, maxit=7, upper_bound=1.0)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))
    assert float(jnp.max(out)) <= 1.0


@pytest.mark.parametrize("n", [1, 31, 32, 33, 100])
@pytest.mark.parametrize("k", [1, 3, 6])
def test_kernel_pads_columns_and_coordinates(k, n):
    """Any (k, n): the wrapper pads k to a power of two and n to whole
    32-column blocks, then slices back."""
    G, B, X0 = _system(k, n, seed=n)
    out = _kernel(G, B, X0, 0.0, False)
    assert out.shape == (k, n)
    np.testing.assert_array_equal(np.asarray(out),
                                  np.asarray(_lax(G, B, X0, 0.0, False)))


def test_padding_helpers():
    assert [pk._next_pow2(k) for k in (1, 2, 3, 8, 9, 50, 64, 100, 128)] == \
        [1, 2, 4, 8, 16, 64, 64, 128, 128]
    X = pk._pad_to(jnp.ones((3, 33)), (4, 64))
    assert X.shape == (4, 64)
    np.testing.assert_array_equal(np.asarray(X[3]), 0)
    np.testing.assert_array_equal(np.asarray(X[:, 33:]), 0)


def test_kernel_choice_follows_platform_and_k(monkeypatch):
    assert backend.platform() == "cpu"
    assert not S._cd_kernel_ok(8)               # no kernel on the CPU
    monkeypatch.setattr(backend, "platform", lambda: "gpu")
    assert S._cd_kernel_ok(8)
    assert S._cd_kernel_ok(pk.MAX_K)
    assert not S._cd_kernel_ok(pk.MAX_K + 1)    # above the register bound


def test_platform_follows_default_device():
    with jax.default_device(jax.devices("cpu")[0]):
        assert backend.platform() == "cpu"
    with jax.default_device("cpu"):
        assert backend.platform() == "cpu"
        assert not backend.on_accelerator()


@pytest.mark.parametrize("batched", [False, True], ids=["shared", "batched"])
def test_dispatch_routes_through_kernel(monkeypatch, batched):
    """With the kernel chosen, the solver entry points hand it the same
    operands (fp32 tol floor, L1) as the lax path gets."""
    calls = []

    def interp(fn):
        def run(*a, **kw):
            calls.append(fn.__name__)
            return fn(*a, interpret=True, **kw)
        return run

    G, B, X0 = _system(9, 40, seed=11, batched=batched)
    if batched:
        def solve():
            return S.cd_nnls_batched_gram(G, B, X0, 0.02, nonneg=True,
                                          maxit=50, cd_tol=1e-8)
    else:
        def solve():
            return S.cd_nnls_batch_traced(G, B, X0, 0.02, nonneg=True,
                                          maxit=50, cd_tol=1e-8)
    ref = np.asarray(solve())
    monkeypatch.setattr(S, "_cd_kernel_ok", lambda k: True)
    monkeypatch.setattr(pk, "cd_nnls_shared", interp(pk.cd_nnls_shared))
    monkeypatch.setattr(pk, "cd_nnls_batched", interp(pk.cd_nnls_batched))
    out = np.asarray(solve())
    assert calls == ["cd_nnls_batched" if batched else "cd_nnls_shared"]
    np.testing.assert_array_equal(out, ref)


# ---------------------------------------------------------------------------
# On the card: compiled Triton kernels against the lax sweep at real widths
# ---------------------------------------------------------------------------

# (batched, k, n): the L1 MSE fit (k=20, 5,000 x 40,000), the KL IRLS fit
# (k=16, 13,714 x 2,638), the CV fit (k=64, 10,000 cells), movielens k=50.
_GPU_CASES = [(False, 20, 40000), (False, 50, 3867), (True, 16, 2638),
              (True, 20, 2638), (True, 64, 10000), (True, 100, 2000)]


@pytest.mark.gpu
@pytest.mark.parametrize("batched,k,n", _GPU_CASES)
def test_kernel_matches_lax_on_gpu(gpu, batched, k, n):
    """On the card the two may round differently (Triton and XLA each
    decide on fused multiply-adds and division): the difference is fp32
    rounding, amplified at most by a column frozen one sweep earlier or
    later (each sweep moves a column by < cd_tol relative at the freeze).
    1e-3 of the column scale bounds both."""
    G, B, X0 = _system(k, n, seed=k, batched=batched)
    out = np.asarray(_kernel(G, B, X0, 0.01, batched, interpret=False))
    ref = np.asarray(_lax(G, B, X0, 0.01, batched))
    assert np.isfinite(out).all()
    scale = np.abs(ref).max(axis=0) + 1e-6
    assert np.max(np.abs(out - ref).max(axis=0) / scale) < 1e-3


@pytest.mark.parametrize("batched", [False, True], ids=["shared", "batched"])
def test_kernel_under_vmap_interpret(batched):
    """Seed-list fits vmap the whole fit (api.nmf multi-restart), so the
    kernel is batched by Pallas' vmap rule: each lane equals its own solve."""
    systems = [_system(6, 40, seed=s, batched=batched) for s in (1, 2)]
    G, B, X0 = (jnp.stack(t) for t in zip(*systems))
    fn = pk.cd_nnls_batched if batched else pk.cd_nnls_shared
    out = jax.vmap(lambda g, b, x: fn(g, b, x, 0.01, TOL, nonneg=True,
                                      maxit=50, interpret=True))(G, B, X0)
    for i, (g, b, x) in enumerate(systems):
        np.testing.assert_array_equal(
            np.asarray(out[i]), np.asarray(_lax(g, b, x, 0.01, batched, 50)))
