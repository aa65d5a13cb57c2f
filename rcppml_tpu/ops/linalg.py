"""Core linear-algebra primitives for the ALS engine.

JAX equivalents of the reference's CPU/GPU primitives
(``inst/include/FactorNet/primitives/{cpu,gpu}/``):

  * :func:`gram` — ``G = F @ F.T`` (gram.hpp:30-62 / cuBLAS SYRK).  A k x k
    matmul; under a sharded ``pjit`` this psums over the sharded axis for
    free via GSPMD.
  * :func:`rhs` — ``B = F @ A`` (rhs.hpp / cuSPARSE SpMM).  The reference
    gathers CSC columns with OpenMP; here this is a dense matmul over
    (blocked) dense panels — zeros contribute nothing to the products, so
    results are identical for sparse data stored densely.
  * :func:`extract_scaling` — row-norm extraction into d
    (nmf/variant_helpers.hpp:287-305).
  * :func:`gram_trick_loss` — O(k^2) Frobenius loss
    (nmf/fit_cpu.hpp:17-20, primitives/cpu/loss.hpp).

All matmuls run with ``precision=HIGHEST`` so fp32 Gram matrices feeding
Cholesky factorizations do not lose precision to reduced-precision
(bf16/TF32) matrix-unit passes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import Norm
from .. import backend, constants

# full fp32 matmuls: required for Gram matrices that feed
# Cholesky solves, and for loss parity with the fp32 CPU reference.
PREC = jax.lax.Precision.HIGHEST


def gram(F: jax.Array) -> jax.Array:
    """G = F @ F.T with the reference's +1e-15 diagonal guard (gram.hpp:30-62)."""
    k = F.shape[0]
    G = jnp.dot(F, F.T, precision=PREC)
    return G + constants.TINY_NUM * jnp.eye(k, dtype=F.dtype)


def rhs(F: jax.Array, A: jax.Array) -> jax.Array:
    """B = F @ A (k x n). The throughput kernel (primitives/cpu/rhs.hpp).

    When A is stored bf16 (opt-in ``bf16_data`` fast path) the small
    operand is cast to match so the matmul runs natively in bf16 with
    fp32 accumulation — halving the memory read of the big operand."""
    if A.dtype == jnp.bfloat16:
        return jnp.dot(F.astype(jnp.bfloat16), A,
                       preferred_element_type=jnp.float32)
    return jnp.dot(F, A, precision=PREC)


def extract_scaling(X: jax.Array, norm: Norm):
    """d = row norms of X (+1e-15), X normalized (variant_helpers.hpp:287-305).

    Returns (X_normalized, d).
    """
    if norm == Norm.NONE:
        return X, jnp.ones((X.shape[0],), dtype=X.dtype)
    if norm == Norm.L1:
        d = jnp.sum(jnp.abs(X), axis=1)
    else:
        d = jnp.sqrt(jnp.sum(X * X, axis=1))
    d = d + jnp.asarray(constants.TINY_NUM, X.dtype)
    return X / d[:, None], d


def gram_trick_loss(trAtA, G: jax.Array, B: jax.Array, H: jax.Array):
    """SSE via the Gram trick: ||A - F.T H||^2 = tr(A'A) - 2 tr(B'H) + tr(G HH')
    where B = F @ A and G = F @ F.T (nmf/fit_cpu.hpp:17-20)."""
    cross = jnp.sum(B * H)
    HHt = jnp.dot(H, H.T, precision=PREC)
    recon = jnp.sum(G * HHt)
    return trAtA - 2.0 * cross + recon


def mse_loss_from_saved(trAtA, W_T, d, B_w, G_w):
    """Optimized per-iteration MSE (SSE) reusing W-update matrices
    (fit_cpu.hpp:1710-1753):

      cross = sum_i d_i * <W_T[i, :], B_w[i, :]>      with B_w = H @ A.T
      recon = sum_ij d_i d_j gram(W_T)_ij * G_w_ij    with G_w = gram(H)
      loss  = tr(A'A) - 2*cross + recon
    """
    G_wt = gram(W_T)
    cross = jnp.sum(d[:, None] * W_T * B_w)
    recon = jnp.sum((d[:, None] * d[None, :]) * G_wt * G_w)
    return trAtA - 2.0 * cross + recon


# Khatri-Rao operand budget (floats): k^2 * m above this falls back to the
# blocked batched dot_general (the KR operand would no longer fit HBM
# comfortably; e.g. k=200, m=1e6 -> 4e10 floats)
KR_BUDGET_FLOATS = 1.5e8


def kr_product(F: jax.Array) -> jax.Array:
    """Row-wise Khatri-Rao self-product (k^2, m) in bf16.

    KR[(k1*k + k2), m] = F[k1, m] * F[k2, m]: turns the per-column weighted
    Gram batch G_j = F diag(w_j) F^T into ONE dense matmul
    ``KR @ w -> (k^2, n)`` — a large (k^2, m) x (m, n) product instead of
    n separate (k, m) x (m, k) products whose small k x k outputs
    under-fill the matrix units.

    The product is formed in fp32 and rounded ONCE to bf16 (one rounding
    of F_k*F_l, vs two separate roundings of F in the batched path).
    """
    k, m = F.shape
    return (F[:, None, :] * F[None, :, :]).reshape(k * k, m).astype(
        jnp.bfloat16)


def weighted_gram_and_rhs(F: jax.Array, w: jax.Array, A_blk: jax.Array,
                          KR: jax.Array | None = None,
                          precise: bool = False):
    """Per-column weighted Gram + RHS: G_j = F diag(w_j) F^T, b_j = F (w_j*a_j).

    F (k, m), w (m, bc), A_blk (m, bc) -> (Gb (bc, k, k), b (k, bc)).

    This is the throughput kernel of the IRLS / CV paths (the reference
    computes it per column: nnls_batch_irls.hpp:459-516).  On an
    accelerator inputs are cast to bfloat16 with fp32 accumulation — the
    terms are nonnegative, so each entry is within 2^-8 plus the fp32 sum
    error of its own value (about 2e-4 of a column's largest entry where no
    single row dominates the column), well within the cross-backend
    statistical-equivalence contract
    (rng/rng.hpp:24-25); CPU keeps full fp32 (bf16 is emulated there).

    ``KR``: optional precomputed :func:`kr_product`(F) — callers solving
    many column blocks against one F pass it so the (k^2, m) operand is
    built once per solve, not once per block.  When the KR operand fits
    the budget the Gram batch is ONE large matmul (see kr_product);
    otherwise the blocked batched dot_general runs.
    """
    if not backend.on_accelerator():
        Fw = F[None, :, :] * w.T[:, None, :]
        Gb = jnp.einsum("jkm,lm->jkl", Fw, F, precision=PREC)
        b = jnp.dot(F, w * A_blk, precision=PREC)
        return Gb, b
    if precise:
        # ``precise``: fp32 on an accelerator — the masked/NA MSE solves
        # must match reference (fp32) precision; a bf16 Gram of a near-singular
        # masked column carries ~1e-3 noise that exceeds the stabilizing
        # ridge and NaNs the Cholesky.  Formulated through an fp32 KR
        # operand so no (bc, k, m) intermediate exists — the caller's
        # block sizing assumes none.
        k, m = F.shape
        w = w.astype(F.dtype)
        A_blk = A_blk.astype(F.dtype)
        KR32 = (F[:, None, :] * F[None, :, :]).reshape(k * k, m)
        G_flat = jnp.dot(KR32, w, precision=PREC)
        Gb = jnp.transpose(G_flat.reshape(k, k, -1), (2, 0, 1))
        b = jnp.dot(F, w * A_blk, precision=PREC)
        return Gb, b
    k, m = F.shape
    Fb = F.astype(jnp.bfloat16)
    if KR is None and k * k * m <= KR_BUDGET_FLOATS:
        KR = kr_product(F)
    if KR is not None:
        G_flat = jnp.dot(KR, w.astype(jnp.bfloat16),
                         preferred_element_type=jnp.float32)
        Gb = jnp.transpose(G_flat.reshape(k, k, -1), (2, 0, 1))
    else:
        Fw = Fb[None, :, :] * w.astype(jnp.bfloat16).T[:, None, :]
        Gb = jax.lax.dot_general(
            Fw, jnp.broadcast_to(Fb[None], (Fw.shape[0],) + Fb.shape),
            dimension_numbers=(((2,), (2,)), ((0,), (0,))),
            preferred_element_type=jnp.float32)
    b = jnp.dot(Fb, (w * A_blk).astype(jnp.bfloat16),
                preferred_element_type=jnp.float32)
    return Gb, b


def gathered_gram_downdate(F: jax.Array, idx: jax.Array, val: jax.Array):
    """Per-column Gram DOWNDATE from gathered excluded rows.

    For 0/1 train masks (speckled CV holdout / user masks) the per-column
    Gram is ``G_j = G_full - sum_{r in excl_j} F[:, r] F[:, r]^T`` — the
    reference's per-column rank update (cv_detail.hpp:67-84).  With
    T = max excluded rows per column << m this costs k^2*T*n instead of
    the general weighted path's k^2*m*n and streams a (bc, k, T) instead
    of a (bc, k, m) intermediate — both the FLOPs and the HBM traffic
    drop by ~m/T (= inv_prob for speckled holdouts).

    F (k, m), idx (T, bc) int32 row indices, val (T, bc) 0/1 validity
    (padding slots carry val 0 and any index).  Returns (bc, k, k) — the
    term to SUBTRACT from the full Gram.

    The ``F[:, idx]`` gather is elementwise work where the weighted einsum
    is one dense matmul, so the FLOP saving need not show on an
    accelerator.  The weighted path stays the default dispatch; this
    kernel is opt-in (``fit_cv_or_masked(use_downdate=True)``) for
    gather-cheap backends.
    """
    # fp32 on every backend: this Gram feeds the same masked Cholesky
    # as the (fp32) weighted path — bf16 noise exceeds the stabilizing
    # ridge on near-singular masked columns and breaks downdate/weighted
    # agreement
    Fg = F[:, idx]                                    # (k, T, bc)
    Fgv = Fg * val[None, :, :]
    return jnp.einsum("itc,ltc->cil", Fgv, Fg, precision=PREC)


def cosine_rows(F: jax.Array) -> jax.Array:
    """Row-wise cosine similarity matrix (k x k)."""
    norms = jnp.sqrt(jnp.sum(F * F, axis=1))
    Fh = F / jnp.maximum(norms, 1e-15)[:, None]
    return jnp.dot(Fh, Fh.T, precision=PREC)
