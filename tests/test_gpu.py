"""Checks that need an NVIDIA GPU (the kernel ones are in test_cd_kernels.py).

They take the ``gpu`` fixture, so they skip on the CPU; on the card run
``RCPPML_GPU_TESTS=1 python -m pytest -m gpu tests/``.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def test_fill_uniform_traced_bitwise_on_gpu(gpu):
    """The device init is bit-identical to the host SplitMix64 fill: the
    GPU lowering of the uint32 limb arithmetic must not drift."""
    import jax
    from rcppml_tpu import rng
    for seed in (1, 42, 2 ** 40 + 3):
        h = rng.fill_uniform(seed, 16, 1337)
        d = np.asarray(jax.jit(
            lambda s=seed: rng.fill_uniform_traced(s, 16, 1337))())
        np.testing.assert_array_equal(h, d)


def test_fit_runs_on_gpu_and_matches_cpu(gpu):
    """A 3-iteration MSE fit on the card against the same fit on the host
    CPU at full fp32 precision (sums regroup; Cholesky conditioning)."""
    import jax
    import rcppml_tpu as rt
    rs = np.random.RandomState(0)
    A = rs.poisson(2.0, size=(300, 500)).astype(np.float32)
    g = rt.nmf(A, 8, maxit=3, tol=0, seed=1, sort_model=False)
    with jax.default_device(jax.devices("cpu")[0]), \
            jax.default_matmul_precision("highest"):
        h = rt.nmf(A, 8, maxit=3, tol=0, seed=1, sort_model=False)
    for a, b in ((g.W, h.W), (g.H, h.H)):
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()


def test_fused_vmem_matches_default_on_gpu(gpu):
    """``test_fused_vmem_matches_default_path_at_convergence`` on the card:
    the Newton-Schulz ALS reaches the Cholesky loop's fixed point, same
    shape, seed and 1e-2 bound."""
    import rcppml_tpu as rt
    from test_fused_vmem import _planted
    A = _planted(noise=0.3, seed=3)
    base = rt.nmf(A, 5, seed=7, maxit=300, tol=0.0, sort_model=False)
    fv = rt.nmf(A, 5, seed=7, maxit=300, tol=0.0, sort_model=False,
                fused_vmem=True)
    b, f = base.loss_history[-1], fv.loss_history[-1]
    assert abs(b - f) / abs(b) < 1e-2, (b, f)

