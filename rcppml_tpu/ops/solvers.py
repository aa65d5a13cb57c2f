"""Batched NNLS solvers.

JAX equivalents of the reference's solver primitives:

  * :func:`cholesky_clip_batch` — unconstrained Cholesky solve then clip
    (primitives/cpu/cholesky_clip.hpp:129-164), the default (reference
    solver_mode=1): one k x k factorization feeding a triangular solve
    batched over ALL columns at once — dense matrix work.
  * :func:`cd_nnls_batch` — coordinate-descent NNLS
    (primitives/cpu/nnls_batch.hpp:71-225).  The reference parallelizes the
    sequential k-loop over columns with OpenMP; here the SAME k-sequential
    sweep runs with every column in a lane (rank-1 residual updates on the
    full (k, n) block — elementwise work, k small).  Per-column early exit
    becomes a per-column freeze mask so converged columns stop moving
    exactly as they
    would have, preserving the per-column convergence semantics.

Both operate on the whole column batch; under pjit with H sharded over the
column axis they are embarrassingly parallel per shard.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from .. import backend, constants


def _chol_solve(G: jax.Array, B: jax.Array) -> jax.Array:
    """Solve G X = B via Cholesky (G symmetric positive definite, k x k).

    A trace-relative ridge (1e-6) keeps fp32 factorization finite when G is
    numerically rank-deficient (e.g. after PROJ_ADV eigen-clipping or L21
    factor death) — a ~1e-6 relative solution perturbation, below the fp32
    noise of the surrounding algebra.
    """
    k = G.shape[0]
    ridge = (1e-6 / k) * jnp.trace(G)
    L = lax.linalg.cholesky(G + ridge * jnp.eye(k, dtype=G.dtype))
    # An explicit G^-1 + GEMM is no alternative: its fp32 inverse fails
    # outright on near-rank-deficient Grams (constant/rank-1 inputs:
    # residual 7.6 vs 1e-6 even WITH one step of iterative refinement), so
    # the backward-stable solves stay.
    Y = lax.linalg.triangular_solve(L, B, left_side=True, lower=True,
                                    transpose_a=False)
    return lax.linalg.triangular_solve(L, Y, left_side=True, lower=True,
                                       transpose_a=True)


def cholesky_clip_batch(G: jax.Array, B: jax.Array, *, nonneg: bool = True,
                        upper_bound: float = 0.0) -> jax.Array:
    """Solve G X = B for all columns, then clip (cholesky_clip.hpp:129-164).

    B must already carry L1 (subtracted) / the Gram must carry L2 — feature
    application happens upstream exactly as in the reference
    (features/sparsity.hpp:41-48).
    """
    X = _chol_solve(G, B)
    if nonneg:
        X = jnp.maximum(X, 0.0)
    if upper_bound > 0:
        X = jnp.minimum(X, upper_bound)
    return X


@partial(jax.jit, static_argnames=("nonneg", "maxit", "l1_static",
                                   "upper_bound"))
def _cd_sweeps(G, B, X0, L1, cd_tol, *, nonneg: bool, maxit: int,
               l1_static: bool, upper_bound: float = 0.0):
    k = G.shape[0]
    n = B.shape[1]
    dtype = B.dtype
    gdiag = jnp.diag(G)
    gdiag_ok = gdiag > 0
    inv_k = jnp.asarray(1.0 / k, dtype)
    abs_tol = jnp.asarray(constants.CD_ABS_TOL, dtype)

    def coord_step(i, carry):
        X, B_res, tol_sum, active = carry
        g = gdiag[i]
        b_i = lax.dynamic_slice_in_dim(B_res, i, 1, axis=0)[0]   # (n,)
        x_i = lax.dynamic_slice_in_dim(X, i, 1, axis=0)[0]       # (n,)
        diff = jnp.where(gdiag_ok[i], b_i / g, jnp.zeros_like(b_i))
        if l1_static:
            # L1 is part of the same gated update: a dead coordinate is
            # SKIPPED entirely (nnls_batch.hpp:90 'continue'), not decayed
            diff = diff - jnp.where(gdiag_ok[i], L1, jnp.zeros_like(L1))
        new_val = x_i + diff
        if nonneg:
            new_val = jnp.maximum(new_val, 0.0)
        if upper_bound > 0:
            new_val = jnp.minimum(new_val, upper_bound)
        actual = (new_val - x_i) * active                        # freeze done cols
        X = lax.dynamic_update_slice_in_dim(X, (x_i + actual)[None, :], i, axis=0)
        g_col = lax.dynamic_slice_in_dim(G, i, 1, axis=1)        # (k, 1)
        B_res = B_res - g_col * actual[None, :]
        tol_sum = tol_sum + jnp.abs(actual) / (jnp.abs(x_i + actual) + abs_tol)
        return X, B_res, tol_sum, active

    def sweep(carry):
        X, B_res, active, it = carry
        X, B_res, tol_sum, active = lax.fori_loop(
            0, k, coord_step, (X, B_res, jnp.zeros((n,), dtype), active))
        # per-SWEEP relative convergence (nnls_batch.hpp:126-129)
        still = tol_sum * inv_k >= cd_tol
        return X, B_res, active & still, it + 1

    def cond(carry):
        _, _, active, it = carry
        return (it < maxit) & jnp.any(active)

    X, _, _, sweeps = lax.while_loop(
        cond, sweep, (X0, B, jnp.ones((n,), dtype=bool), jnp.int32(0)))
    return X


def cd_nnls_batch(G: jax.Array, B: jax.Array, X: jax.Array | None = None, *,
                  L1: float = 0.0, nonneg: bool = True,
                  maxit: int = constants.CD_MAXIT,
                  cd_tol: float = constants.CD_TOL,
                  upper_bound: float = 0.0,
                  warm_start: bool = False) -> jax.Array:
    """Batched CD NNLS: solve G x = b per column with x >= 0.

    Matches nnls_batch<CPU> (nnls_batch.hpp:150-225): with ``warm_start``
    the incoming B is converted to residual form ``B - G @ X``; otherwise
    the solve starts from X = 0.  ``L1`` here follows the *fused-path*
    semantics (subtracted from diff each visit, fused_nnls.hpp:117); the
    standard path applies L1 to B upstream and passes L1=0.
    """
    k, n = B.shape
    cd_tol = _eff_cd_tol(cd_tol, B.dtype)
    if X is None or not warm_start:
        X0 = jnp.zeros((k, n), dtype=B.dtype)
        B_res = B
    else:
        X0 = X
        B_res = B - jnp.dot(G, X, precision=jax.lax.Precision.HIGHEST)
    return _cd_sweeps(G, B_res, X0, jnp.asarray(L1, B.dtype),
                      jnp.asarray(cd_tol, B.dtype),
                      nonneg=nonneg, maxit=maxit, l1_static=(L1 != 0.0),
                      upper_bound=upper_bound)


def _cd_kernel_ok(k: int) -> bool:
    """Whether the fused Triton CD kernels serve a k-coordinate solve: on a
    GPU, for k within the kernels' register bound."""
    from .pallas_kernels import MAX_K
    return k <= MAX_K and backend.platform() == "gpu"


def _eff_cd_tol(cd_tol: float, dtype) -> float:
    """fp32-aware per-sweep exit threshold (constants.CD_TOL_F32_FLOOR)."""
    import numpy as _np
    if cd_tol > 0 and _np.dtype(dtype) == _np.float32:
        return max(float(cd_tol), constants.CD_TOL_F32_FLOOR)
    return cd_tol


def cd_nnls_batch_traced(G, B_res, X0, L1, *, nonneg: bool, maxit: int,
                         cd_tol: float, upper_bound: float = 0.0):
    """In-trace variant for use inside a jitted fit loop (no re-jit).

    ``B_res`` must already be in residual form relative to ``X0``.
    On a GPU this dispatches to the fused Triton kernel (the whole solve in
    one launch); elsewhere the lax implementation runs.
    """
    cd_tol = _eff_cd_tol(cd_tol, B_res.dtype)
    if _cd_kernel_ok(G.shape[0]):
        from .pallas_kernels import cd_nnls_shared
        return cd_nnls_shared(
            G, B_res, X0, jnp.asarray(L1, B_res.dtype),
            jnp.asarray(cd_tol, B_res.dtype), nonneg=nonneg, maxit=maxit,
            upper_bound=upper_bound)
    return _cd_sweeps.__wrapped__(G, B_res, X0,
                                  jnp.asarray(L1, B_res.dtype),
                                  jnp.asarray(cd_tol, B_res.dtype),
                                  nonneg=nonneg, maxit=maxit,
                                  l1_static=True, upper_bound=upper_bound)


# ---------------------------------------------------------------------------
# Per-column-Gram variants (IRLS weighted solves, CV Gram downdates)
# ---------------------------------------------------------------------------
# The reference solves these column-by-column on CPU threads
# (nnls_batch_irls.hpp:459-516, fit_cv.hpp per-column path); here every
# column's k x k system is solved simultaneously — a vectorized
# batched Cholesky or a lane-parallel CD sweep.

def batched_gram_matvec(Gb, X):
    """y_j = G_j @ x_j for Gb (n, k, k), X (k, n) -> (k, n)."""
    return jnp.einsum("jkl,lj->kj", Gb, X,
                      precision=jax.lax.Precision.HIGHEST)


def batched_spd_solve(Gb, B):
    """Vectorized batched SPD solve: Gb (n, k, k), B (k, n) -> X (k, n).

    Rather than XLA's batched ``lax.linalg.cholesky``, for the small k
    (<~128) systems of the CV/IRLS paths this Cholesky-Crout factorization
    runs k static steps with every op vectorized over the
    whole batch (batch on lanes), followed by vectorized forward/back
    substitution.
    """
    n, k, _ = Gb.shape
    dtype = Gb.dtype
    G = jnp.transpose(Gb, (1, 2, 0))                  # (k, k, n)

    # Cholesky-Crout: k steps, each O(k * n) vectorized work
    L = jnp.zeros((k, k, n), dtype)

    def chol_step(j, L):
        # l_jj = sqrt(g_jj - sum_{s<j} L_js^2)
        row_j = lax.dynamic_slice_in_dim(L, j, 1, axis=0)[0]      # (k, n)
        sum_sq = jnp.sum(row_j * row_j, axis=0)                   # (n,)
        g_jj = lax.dynamic_slice_in_dim(
            lax.dynamic_slice_in_dim(G, j, 1, axis=0), j, 1, axis=1)[0, 0]
        l_jj = jnp.sqrt(jnp.maximum(g_jj - sum_sq, 1e-30))        # (n,)
        # column j below the diagonal: L_ij = (g_ij - <L_i., L_j.>) / l_jj
        g_col = lax.dynamic_slice_in_dim(G, j, 1, axis=1)[:, 0]   # (k, n)
        dots = jnp.sum(L * row_j[None, :, :], axis=1)             # (k, n)
        col = (g_col - dots) / l_jj[None, :]
        mask = (jnp.arange(k) > j)[:, None]
        col = jnp.where(mask, col, 0.0)
        col = col.at[j].set(l_jj)
        return lax.dynamic_update_slice_in_dim(
            L.transpose(1, 0, 2), col[None], j, axis=0).transpose(1, 0, 2)

    L = lax.fori_loop(0, k, chol_step, L)

    # forward substitution L y = b
    def fwd(i, Y):
        row_i = lax.dynamic_slice_in_dim(L, i, 1, axis=0)[0]      # (k, n)
        l_ii = lax.dynamic_slice_in_dim(row_i, i, 1, axis=0)[0]   # (n,)
        b_i = lax.dynamic_slice_in_dim(B, i, 1, axis=0)[0]
        acc = jnp.sum(row_i * Y, axis=0)
        y_i = (b_i - acc) / jnp.maximum(l_ii, 1e-30)
        return lax.dynamic_update_slice_in_dim(Y, y_i[None], i, axis=0)

    Y = lax.fori_loop(0, k, fwd, jnp.zeros((k, n), dtype))

    # back substitution L^T x = y
    def bwd(step, X):
        i = k - 1 - step
        col_i = lax.dynamic_slice_in_dim(L.transpose(1, 0, 2), i, 1,
                                         axis=0)[0]               # (k, n)
        l_ii = lax.dynamic_slice_in_dim(col_i, i, 1, axis=0)[0]
        y_i = lax.dynamic_slice_in_dim(Y, i, 1, axis=0)[0]
        acc = jnp.sum(col_i * X, axis=0)
        x_i = (y_i - acc) / jnp.maximum(l_ii, 1e-30)
        return lax.dynamic_update_slice_in_dim(X, x_i[None], i, axis=0)

    return lax.fori_loop(0, k, bwd, jnp.zeros((k, n), dtype))


def cholesky_clip_batched_gram(Gb, B, *, nonneg: bool = True,
                               upper_bound: float = 0.0):
    """Per-column Cholesky + clip: Gb (n, k, k), B (k, n) -> X (k, n).

    Equivalent of cholesky_clip_col applied per column
    (cholesky_clip.hpp:64-106) — batched factor+solve, all columns at once.
    """
    X = batched_spd_solve(Gb, B)
    if nonneg:
        X = jnp.maximum(X, 0.0)
    if upper_bound > 0:
        X = jnp.minimum(X, upper_bound)
    return X


def cd_nnls_batched_gram(Gb, B_res, X0, L1, *, nonneg: bool, maxit: int,
                         cd_tol: float, upper_bound: float = 0.0):
    """CD NNLS with a distinct Gram per column.

    Gb (n, k, k), B_res (k, n) residual w.r.t. X0 (k, n).  Same sweep /
    freeze semantics as the shared-Gram solver.  On a GPU this dispatches
    to the fused Triton kernel; elsewhere the lax implementation runs.
    """
    cd_tol = _eff_cd_tol(cd_tol, B_res.dtype)
    L1 = jnp.asarray(L1, B_res.dtype)
    cd_tol = jnp.asarray(cd_tol, B_res.dtype)
    if _cd_kernel_ok(Gb.shape[1]):
        from .pallas_kernels import cd_nnls_batched
        return cd_nnls_batched(Gb, B_res, X0, L1, cd_tol, nonneg=nonneg,
                               maxit=maxit, upper_bound=upper_bound)
    return _cd_sweeps_batched.__wrapped__(Gb, B_res, X0, L1, cd_tol,
                                          nonneg=nonneg, maxit=maxit,
                                          upper_bound=upper_bound)


@partial(jax.jit, static_argnames=("nonneg", "maxit", "upper_bound"))
def _cd_sweeps_batched(Gb, B_res, X0, L1, cd_tol, *, nonneg: bool,
                       maxit: int, upper_bound: float = 0.0):
    k = Gb.shape[1]
    n = B_res.shape[1]
    dtype = B_res.dtype
    gdiag = jnp.diagonal(Gb, axis1=1, axis2=2).T       # (k, n)
    inv_k = jnp.asarray(1.0 / k, dtype)
    abs_tol = jnp.asarray(constants.CD_ABS_TOL, dtype)

    def coord_step(i, carry):
        X, B, tol_sum, active = carry
        g = lax.dynamic_slice_in_dim(gdiag, i, 1, axis=0)[0]          # (n,)
        b_i = lax.dynamic_slice_in_dim(B, i, 1, axis=0)[0]
        x_i = lax.dynamic_slice_in_dim(X, i, 1, axis=0)[0]
        # dead coordinates (g <= 0) are skipped entirely, L1 included
        # (nnls_batch.hpp:90 'continue')
        diff = jnp.where(g > 0, b_i / jnp.where(g > 0, g, 1.0) - L1, 0.0)
        new_val = x_i + diff
        if nonneg:
            new_val = jnp.maximum(new_val, 0.0)
        if upper_bound > 0:
            new_val = jnp.minimum(new_val, upper_bound)
        actual = (new_val - x_i) * active
        X = lax.dynamic_update_slice_in_dim(X, (x_i + actual)[None, :], i, axis=0)
        g_col = lax.dynamic_slice_in_dim(Gb, i, 1, axis=2)[..., 0].T   # (k, n)
        B = B - g_col * actual[None, :]
        tol_sum = tol_sum + jnp.abs(actual) / (jnp.abs(x_i + actual) + abs_tol)
        return X, B, tol_sum, active

    def sweep(carry):
        X, B, active, it = carry
        X, B, tol_sum, active = lax.fori_loop(
            0, k, coord_step, (X, B, jnp.zeros((n,), dtype), active))
        still = tol_sum * inv_k >= cd_tol
        return X, B, active & still, it + 1

    def cond(carry):
        return (carry[3] < maxit) & jnp.any(carry[2])

    X, _, _, _ = lax.while_loop(
        cond, sweep, (X0, B_res, jnp.ones((n,), dtype=bool), jnp.int32(0)))
    return X
