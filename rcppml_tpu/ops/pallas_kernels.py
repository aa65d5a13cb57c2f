"""Fused coordinate-descent NNLS as Pallas kernels for NVIDIA GPUs (Triton).

The CD sweep (primitives/cpu/nnls_batch.hpp:71-132) is k-sequential: as
plain lax ops every coordinate step is a few tiny kernels inside a
``while_loop`` of up to ``cd_maxit`` sweeps of k steps.  These kernels run
the whole solve -- all sweeps, all coordinates, the residual updates and
the per-column convergence freeze -- in one launch.

As in the reference's CUDA CD kernel (``gpu/nnls.cuh``), a program owns a
block of ``BC`` columns and keeps their whole state on chip for the solve:
the solution and the residual are (kp, BC) register tiles, k padded to the
next power of two kp (Triton's tiles are powers of two).  Coordinate i's
row is read out of a tile by a masked reduction over the kp axis and
written back by a masked select; its Gram column is loaded where it is used
(one (kp,) column of the shared Gram, or a (kp, BC) tile of the per-column
Grams).  The padded coordinates have g = 0, so the dead-coordinate rule
leaves them at zero.  Each block runs its own sweep loop and stops when all
its columns have frozen.

The arithmetic is that of ``solvers._cd_sweeps`` / ``_cd_sweeps_batched``
step for step; in interpret mode the two agree bitwise.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from .. import constants

# Largest k the kernels serve: past kp = 128 the two (kp, BC) state tiles
# no longer fit a thread's registers.
MAX_K = 128

# Columns per program: one warp.
BC = 32


def _next_pow2(k: int) -> int:
    return 1 << (k - 1).bit_length()


def _pad_to(X, shape):
    return jnp.pad(X, [(0, s - d) for s, d in zip(shape, X.shape)])


def _make_cd_kernel(k: int, kp: int, nonneg: bool, maxit: int,
                    upper_bound: float, batched: bool):
    """Kernel body. Refs: scalars (L1, cd_tol), Gram, B_res, X0, out.

    The Gram ref holds G[r, i] at row ``i * kp + r``: a flat (kp*kp,)
    vector for the shared solve, a (kp*kp, BC) block of per-column Grams
    for the batched one."""
    inv_k = 1.0 / k
    abs_tol = constants.CD_ABS_TOL

    def kernel(s_ref, g_ref, b_ref, x_ref, out_ref):
        L1 = s_ref[0]
        cd_tol = s_ref[1]
        rows = lax.broadcasted_iota(jnp.int32, (kp, BC), 0)

        def coord(i, carry):
            X, B, tol_sum, active = carry
            sel = rows == i
            if batched:
                g_col = g_ref[pl.ds(i * kp, kp), :]              # (kp, BC)
                g_d = jnp.sum(jnp.where(sel, g_col, 0.0), axis=0)
            else:
                g_col = g_ref[pl.ds(i * kp, kp)][:, None]        # (kp, 1)
                g_d = g_ref[i * kp + i]
            b_i = jnp.sum(jnp.where(sel, B, 0.0), axis=0)
            x_i = jnp.sum(jnp.where(sel, X, 0.0), axis=0)
            # dead coordinates (g <= 0) are skipped entirely, L1 included
            # (nnls_batch.hpp:90 'continue')
            ok = g_d > 0
            diff = jnp.where(ok, b_i / jnp.where(ok, g_d, 1.0) - L1, 0.0)
            new_val = x_i + diff
            if nonneg:
                new_val = jnp.maximum(new_val, 0.0)
            if upper_bound > 0:
                new_val = jnp.minimum(new_val, upper_bound)
            actual = (new_val - x_i) * active
            x_new = x_i + actual
            X = jnp.where(sel, x_new[None, :], X)
            B = B - g_col * actual[None, :]                      # rank-1
            tol_sum = tol_sum + jnp.abs(actual) / (jnp.abs(x_new) + abs_tol)
            return X, B, tol_sum, active

        def sweep(carry):
            X, B, active, it = carry
            X, B, tol_sum, active = lax.fori_loop(
                0, k, coord, (X, B, jnp.zeros_like(active), active))
            # per-SWEEP relative convergence (nnls_batch.hpp:126-129)
            still = (tol_sum * inv_k >= cd_tol).astype(active.dtype)
            return X, B, active * still, it + 1

        def cond(carry):
            _, _, active, it = carry
            return (it < maxit) & (jnp.max(active) > 0)

        X0 = x_ref[...]
        X, _, _, _ = lax.while_loop(
            cond, sweep, (X0, b_ref[...], jnp.ones((BC,), X0.dtype), 0))
        out_ref[...] = X

    return kernel


@functools.partial(jax.jit, static_argnames=(
    "nonneg", "maxit", "upper_bound", "batched", "interpret"))
def _cd_call(G, B_res, X0, L1, cd_tol, *, nonneg: bool, maxit: int,
             upper_bound: float, batched: bool, interpret: bool):
    k, n = B_res.shape
    kp = _next_pow2(k)
    n_pad = -(-n // BC) * BC
    dtype = B_res.dtype
    if batched:
        # (n, k, k) -> rows i*kp + r hold G_j[r, i] for every column j
        G_flat = _pad_to(jnp.transpose(G, (2, 1, 0)),
                         (kp, kp, n_pad)).reshape(kp * kp, n_pad)
        g_spec = pl.BlockSpec((kp * kp, BC), lambda j: (0, j))
    else:
        G_flat = _pad_to(G.T, (kp, kp)).reshape(kp * kp)
        g_spec = pl.BlockSpec((kp * kp,), lambda j: (0,))
    col_spec = pl.BlockSpec((kp, BC), lambda j: (0, j))
    scalars = jnp.stack([jnp.asarray(L1, dtype), jnp.asarray(cd_tol, dtype)])
    out = pl.pallas_call(
        _make_cd_kernel(k, kp, nonneg, maxit, upper_bound, batched),
        grid=(n_pad // BC,),
        in_specs=[pl.BlockSpec((2,), lambda j: (0,)), g_spec,
                  col_spec, col_spec],
        out_specs=col_spec,
        out_shape=jax.ShapeDtypeStruct((kp, n_pad), dtype),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=BC // 32,
                                                num_stages=1),
        interpret=interpret,
        name="cd_nnls_batched" if batched else "cd_nnls_shared",
    )(scalars, G_flat, _pad_to(B_res, (kp, n_pad)), _pad_to(X0, (kp, n_pad)))
    return out[:k, :n]


def cd_nnls_shared(G, B_res, X0, L1, cd_tol, *, nonneg: bool, maxit: int,
                   upper_bound: float = 0.0, interpret: bool = False):
    """Shared-Gram CD NNLS: G (k, k), B_res/X0 (k, n) in residual form."""
    return _cd_call(G, B_res, X0, L1, cd_tol, nonneg=nonneg, maxit=maxit,
                    upper_bound=upper_bound, batched=False,
                    interpret=interpret)


def cd_nnls_batched(Gb, B_res, X0, L1, cd_tol, *, nonneg: bool, maxit: int,
                    upper_bound: float = 0.0, interpret: bool = False):
    """Per-column-Gram CD NNLS: Gb (n, k, k), B_res/X0 (k, n)."""
    return _cd_call(Gb, B_res, X0, L1, cd_tol, nonneg=nonneg, maxit=maxit,
                    upper_bound=upper_bound, batched=True,
                    interpret=interpret)
