"""Truncated SVD algorithms: Lanczos, IRLBA, randomized, Krylov, deflation.

JAX re-architecture of ``inst/include/FactorNet/svd/`` (gateway.hpp:141-187,
lanczos.hpp, irlba.hpp, randomized.hpp, krylov.hpp, deflation.hpp).  All
matvecs/matmuls are dense ops on device; the small projected problems
(bidiagonal SVDs) are solved host-side in fp64, as the reference solves them
with Eigen in fp32+.

Centering (PCA) is applied implicitly through the matvec identities
``(A - c 1^T) v = A v - c (1^T v)`` so the centered matrix is never
materialized (svd/spmv.hpp centering support).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from .. import rng as rng_mod
from ..config import SVDConfig
from ..ops.linalg import PREC
from ..result import SVDResult


# ---------------------------------------------------------------------------
# Centered operator
# ---------------------------------------------------------------------------

class _Op:
    """y = (A - c 1^T) x and transpose, without materializing centering."""

    def __init__(self, A: jax.Array, center: Optional[jax.Array] = None,
                 scale: Optional[jax.Array] = None):
        self.A = A
        self.center = center
        self.scale = scale
        self.shape = A.shape

    def mv(self, x):                      # (n,) -> (m,)
        y = jnp.dot(self.A, x, precision=PREC)
        if self.center is not None:
            y = y - self.center * jnp.sum(x)
        if self.scale is not None:
            y = y * self.scale
        return y

    def rmv(self, x):                     # (m,) -> (n,)
        if self.scale is not None:
            x = x * self.scale
        y = jnp.dot(self.A.T, x, precision=PREC)
        if self.center is not None:
            y = y - jnp.sum(self.center * x)
        return y

    def mm(self, X):                      # (n, b) -> (m, b)
        Y = jnp.dot(self.A, X, precision=PREC)
        if self.center is not None:
            Y = Y - self.center[:, None] * jnp.sum(X, axis=0)[None, :]
        if self.scale is not None:
            Y = Y * self.scale[:, None]
        return Y

    def rmm(self, X):                     # (m, b) -> (n, b)
        if self.scale is not None:
            X = X * self.scale[:, None]
        Y = jnp.dot(self.A.T, X, precision=PREC)
        if self.center is not None:
            Y = Y - jnp.outer(jnp.ones(self.A.shape[1], X.dtype),
                              jnp.dot(self.center, X, precision=PREC))
        return Y


def _densify(A):
    """numpy / scipy.sparse / jax input -> host dense f32 or device array."""
    if isinstance(A, jax.Array):
        return A
    if hasattr(A, "todense"):
        return np.asarray(A.todense(), dtype=np.float32)
    return np.asarray(A, dtype=np.float32)


def _prep(A, cfg: SVDConfig):
    A = _densify(A)
    if isinstance(A, jax.Array):
        A = A.astype(jnp.float32)     # device-resident: no host round-trip
    else:
        A = jnp.asarray(A)
    center = scale = None
    if cfg.center:
        center = jnp.mean(A, axis=1)
    if cfg.scale:
        sd = jnp.std(A, axis=1)
        scale = 1.0 / jnp.maximum(sd, 1e-8)
    return _Op(A, center, scale), center, scale


def _seed_vector(n: int, seed: int) -> np.ndarray:
    v = rng_mod.fill_uniform(seed if seed != 0 else 12345, n, 1)[:, 0] - 0.5
    v = v.astype(np.float32)
    return v / np.linalg.norm(v)


# ---------------------------------------------------------------------------
# Golub-Kahan bidiagonalization with full reorthogonalization
# ---------------------------------------------------------------------------

def _gkb_extend_impl(op, U, V, alphas, betas, start, v_next, steps: int):
    """Trace-level GKB extension shared by the jitted wrapper below and the
    fully-fused IRLBA while_loop."""

    def body(j, carry):
        U, V, alphas, betas, v = carry
        V = jnp.where(jnp.arange(steps)[None, :] == j, v[:, None], V)
        u = op.mv(v)
        # full reorthogonalization against all stored U columns
        u = u - jnp.dot(U, jnp.dot(U.T, u, precision=PREC), precision=PREC)
        alpha = jnp.sqrt(jnp.sum(u * u))
        # breakdown guard: once the residual falls below ~fp32 noise of the
        # leading coefficient, the invariant subspace is exhausted — zero
        # the chain instead of normalizing rounding junk (which compounds
        # into a fake spectrum on exactly rank-deficient inputs)
        amax = jnp.maximum(jnp.max(alphas), jnp.max(betas))
        ok_a = alpha > 1e-5 * jnp.maximum(amax, 1e-30)
        u = jnp.where(ok_a, u / jnp.maximum(alpha, 1e-30), 0.0)
        alpha = jnp.where(ok_a, alpha, 0.0)
        U = jnp.where(jnp.arange(steps)[None, :] == j, u[:, None], U)
        alphas = alphas.at[j].set(alpha)

        w = op.rmv(u)
        w = w - jnp.dot(V, jnp.dot(V.T, w, precision=PREC), precision=PREC)
        beta = jnp.sqrt(jnp.sum(w * w))
        ok_b = ok_a & (beta > 1e-5 * jnp.maximum(amax, 1e-30))
        v_next = jnp.where(ok_b, w / jnp.maximum(beta, 1e-30), 0.0)
        betas = betas.at[j].set(jnp.where(ok_b, beta, 0.0))
        return U, V, alphas, betas, v_next

    return lax.fori_loop(start, steps, body,
                         (U, V, alphas, betas, v_next))


@partial(jax.jit, static_argnames=("steps",), static_argnums=())
def _gkb_extend(A, center_vec, scale_vec, U, V, alphas, betas, start, v_next,
                *, steps: int):
    """Extend a GKB factorization from column ``start`` to ``steps``.

    U (m, steps), V (n, steps) hold computed vectors in their first ``start``
    columns (zeros elsewhere, so full-basis projections are exact).  Returns
    updated (U, V, alphas, betas, v_last).  Recursion (svd/lanczos.hpp):

        alpha_j u_j = A v_j - beta_{j-1} u_{j-1}   (+ reorth vs U)
        beta_j v_{j+1} = A^T u_j - alpha_j v_j      (+ reorth vs V)
    """
    op = _Op(A, center_vec, scale_vec)
    return _gkb_extend_impl(op, U, V, alphas, betas, start, v_next, steps)


def lanczos_svd(A, cfg: SVDConfig) -> SVDResult:
    """Golub-Kahan Lanczos SVD with full reorthogonalization
    (svd/lanczos.hpp, O(nnz j + (m+n) j^2))."""
    op, center, scale = _prep(A, cfg)
    m, n = op.shape
    k = min(cfg.k, min(m, n))
    steps = min(min(m, n), max(2 * k + 10, 20))

    v0 = jnp.asarray(_seed_vector(n, cfg.seed))
    U = jnp.zeros((m, steps), jnp.float32)
    V = jnp.zeros((n, steps), jnp.float32)
    alphas = jnp.zeros((steps,), jnp.float32)
    betas = jnp.zeros((steps,), jnp.float32)

    U, V, alphas, betas, _ = _gkb_extend(
        op.A, center, scale, U, V, alphas, betas, 0, v0, steps=steps)

    a = np.asarray(alphas, dtype=np.float64)
    b = np.asarray(betas, dtype=np.float64)
    B = np.diag(a) + np.diag(b[:-1], 1)       # upper bidiagonal
    P, s, Qt = np.linalg.svd(B)
    Uk = jnp.dot(U, jnp.asarray(P[:, :k], jnp.float32), precision=PREC)
    Vk = jnp.dot(V, jnp.asarray(Qt[:k].T, jnp.float32), precision=PREC)
    return SVDResult(U=np.asarray(Uk), d=s[:k].astype(np.float32),
                     V=np.asarray(Vk), k_selected=k, converged=True,
                     iterations=steps,
                     center=np.asarray(center) if center is not None else None,
                     scale=(1.0 / np.asarray(scale)) if scale is not None else None)


def _irlba_core(op, gkb_extend, m, n, k, work, max_restarts, tol, seed):
    """Shared augmented implicitly-restarted Lanczos core (Baglama &
    Reichel; svd/irlba.hpp).  ``op`` provides mv/rmv; ``gkb_extend`` runs
    GKB steps — the jitted dense kernel in-memory, the chunked host loop
    when streaming (svd/streaming.hpp runs the same core over streamed
    matvecs).

    Thick restart: SVD of the projected (work x work) matrix, keep k Ritz
    pairs plus the residual coupling row, extend with GKB steps until the
    coupling |beta * P[last, i]| converges for all i <= k.
    """
    dtype = jnp.float32
    v = jnp.asarray(_seed_vector(n, seed))
    U = jnp.zeros((m, work), dtype)
    V = jnp.zeros((n, work), dtype)

    # initial full GKB pass
    alphas = jnp.zeros((work,), dtype)
    betas = jnp.zeros((work,), dtype)
    U, V, alphas, betas, v_next = gkb_extend(U, V, alphas, betas, 0, v)
    a = np.asarray(alphas, np.float64)
    b = np.asarray(betas, np.float64)
    B = np.diag(a) + np.diag(b[:-1], 1)
    beta_last = float(b[-1])

    s = None
    restarts = 0
    converged = False
    for restarts in range(1, max_restarts + 1):
        P, s, Qt = np.linalg.svd(B)
        # convergence: residual coupling of the top-k Ritz values
        res = np.abs(beta_last * P[-1, :k])
        if np.all(res < tol * max(s[0], 1e-30)):
            converged = True
            break

        # thick restart: rotate bases, keep k Ritz vectors + new direction
        Pk = jnp.asarray(P[:, :k], dtype)
        Qk = jnp.asarray(Qt[:k].T, dtype)
        U_new = jnp.dot(U, Pk, precision=PREC)                      # (m, k)
        V_new = jnp.dot(V, Qk, precision=PREC)                      # (n, k)
        rho = (beta_last * P[-1, :k]).astype(np.float64)            # coupling

        U = jnp.zeros((m, work), dtype).at[:, :k].set(U_new)
        V = jnp.zeros((n, work), dtype).at[:, :k].set(V_new)

        # continue: u_{k+1} = A v_next - sum rho_i u_i ; then standard GKB
        u = op.mv(v_next) - jnp.dot(U_new, jnp.asarray(rho, dtype),
                                    precision=PREC)
        u = u - jnp.dot(U, jnp.dot(U.T, u, precision=PREC), precision=PREC)
        alpha_k = float(jnp.sqrt(jnp.sum(u * u)))
        u = u / max(alpha_k, 1e-30)
        U = U.at[:, k].set(u)
        V = V.at[:, k].set(v_next)

        w = op.rmv(u)
        w = w - jnp.dot(V, jnp.dot(V.T, w, precision=PREC), precision=PREC)
        beta_k = float(jnp.sqrt(jnp.sum(w * w)))
        v_next2 = w / max(beta_k, 1e-30)

        alphas = jnp.zeros((work,), dtype).at[k].set(alpha_k)
        betas = jnp.zeros((work,), dtype).at[k].set(beta_k)
        U, V, alphas, betas, v_next = gkb_extend(
            U, V, alphas, betas, k + 1, v_next2)

        # projected matrix after thick restart:
        #   [ diag(s_k)  rho  0  ]
        #   [    0      alpha_k betas/alphas chain ]
        a = np.asarray(alphas, np.float64)
        b = np.asarray(betas, np.float64)
        B = np.zeros((work, work))
        B[np.arange(k), np.arange(k)] = s[:k]
        B[np.arange(k), k] = rho
        for j in range(k, work):
            B[j, j] = a[j]
            if j + 1 < work:
                B[j, j + 1] = b[j]
        beta_last = float(b[-1])

    P, s, Qt = np.linalg.svd(B)
    Uk = jnp.dot(U, jnp.asarray(P[:, :k], dtype), precision=PREC)
    Vk = jnp.dot(V, jnp.asarray(Qt[:k].T, dtype), precision=PREC)
    return SVDResult(U=np.asarray(Uk), d=s[:k].astype(np.float32),
                     V=np.asarray(Vk), k_selected=k, converged=converged,
                     iterations=restarts)


@partial(jax.jit, static_argnames=("k", "work", "max_restarts"))
def _irlba_fused(A, center_vec, scale_vec, v0, tol, *, k: int, work: int,
                 max_restarts: int):
    """Whole-IRLBA kernel: every restart — the (work x work) projected SVD,
    the thick-restart basis rotation, the augmented GKB extension and the
    coupling-residual convergence test — runs inside ONE lax.while_loop,
    so a fit is a single device dispatch with no per-restart host syncs
    (the reference's host loop in svd/irlba.hpp becomes pure XLA).
    """
    op = _Op(A, center_vec, scale_vec)
    m, n = op.shape
    dtype = jnp.float32
    iw = jnp.arange(work)

    U0 = jnp.zeros((m, work), dtype)
    V0 = jnp.zeros((n, work), dtype)
    U0, V0, alphas, betas, v_next = _gkb_extend_impl(
        op, U0, V0, jnp.zeros((work,), dtype), jnp.zeros((work,), dtype),
        0, v0, work)
    B0 = jnp.diag(alphas) + jnp.diag(betas[:-1], 1)

    def restart(U, V, B, betas, v_next, P, s, Qt):
        Pk = P[:, :k]
        U_new = jnp.dot(U, Pk, precision=PREC)                      # (m, k)
        V_new = jnp.dot(V, Qt[:k].T, precision=PREC)                # (n, k)
        rho = betas[-1] * P[-1, :k]                                 # coupling

        U = jnp.zeros((m, work), dtype).at[:, :k].set(U_new)
        V = jnp.zeros((n, work), dtype).at[:, :k].set(V_new)

        u = op.mv(v_next) - jnp.dot(U_new, rho, precision=PREC)
        u = u - jnp.dot(U, jnp.dot(U.T, u, precision=PREC), precision=PREC)
        alpha_k = jnp.sqrt(jnp.sum(u * u))
        u = u / jnp.maximum(alpha_k, 1e-30)
        U = U.at[:, k].set(u)
        V = V.at[:, k].set(v_next)

        w = op.rmv(u)
        w = w - jnp.dot(V, jnp.dot(V.T, w, precision=PREC), precision=PREC)
        beta_k = jnp.sqrt(jnp.sum(w * w))
        v2 = w / jnp.maximum(beta_k, 1e-30)

        al = jnp.zeros((work,), dtype).at[k].set(alpha_k)
        be = jnp.zeros((work,), dtype).at[k].set(beta_k)
        U, V, al, be, v_next = _gkb_extend_impl(op, U, V, al, be, k + 1, v2,
                                                work)

        # projected matrix after thick restart:
        #   [ diag(s_k)  rho ; 0  alpha/beta bidiagonal chain ]
        B = jnp.zeros((work, work), dtype)
        B = B.at[jnp.arange(k), jnp.arange(k)].set(s[:k].astype(dtype))
        B = B.at[jnp.arange(k), k].set(rho)
        B = B + jnp.diag(jnp.where(iw >= k, al, 0.0))
        B = B + jnp.diag(jnp.where(iw[:-1] >= k, be[:-1], 0.0), 1)
        return U, V, B, be, v_next

    def cond(carry):
        _, _, _, _, _, it, conv = carry
        return (it < max_restarts) & jnp.logical_not(conv)

    def body(carry):
        U, V, B, betas, v_next, it, _ = carry
        # one projected SVD per restart: the convergence test and the
        # thick-restart rotation share the same decomposition
        P, s, Qt = jnp.linalg.svd(B)
        res = jnp.abs(betas[-1] * P[-1, :k])
        conv = jnp.all(res < tol * jnp.maximum(s[0], 1e-30))
        U, V, B, betas, v_next = lax.cond(
            conv, lambda a: a[:5], lambda a: restart(*a),
            (U, V, B, betas, v_next, P, s, Qt))
        return (U, V, B, betas, v_next, it + 1, conv)

    U, V, B, betas, v_next, it, conv = lax.while_loop(
        cond, body, (U0, V0, B0, betas, v_next, jnp.int32(0),
                     jnp.bool_(False)))
    P, s, Qt = jnp.linalg.svd(B)
    Uk = jnp.dot(U, P[:, :k], precision=PREC)
    Vk = jnp.dot(V, Qt[:k].T, precision=PREC)
    return Uk, s[:k], Vk, it, conv


def irlba_svd(A, cfg: SVDConfig) -> SVDResult:
    """Augmented implicitly-restarted Lanczos bidiagonalization
    (Baglama & Reichel; svd/irlba.hpp, work = k + 7).

    In-memory fits run the fully-fused on-device kernel (:func:`_irlba_fused`,
    one dispatch per fit); the host-loop core (:func:`_irlba_core`) remains
    for the streaming driver's chunked matvecs."""
    op, center, scale = _prep(A, cfg)
    m, n = op.shape
    k = min(cfg.k, min(m, n) - 1) if min(m, n) > 1 else 1
    work = min(min(m, n), (cfg.work if cfg.work > 0 else k + 7))
    max_restarts = cfg.max_iter if cfg.max_iter > 0 else 100
    tol = cfg.tol if cfg.tol > 0 else 1e-5

    v0 = jnp.asarray(_seed_vector(n, cfg.seed))
    Uk, d, Vk, it, conv = jax.device_get(_irlba_fused(
        op.A, center, scale, v0, jnp.float32(tol),
        k=k, work=work, max_restarts=max_restarts))
    res = SVDResult(U=np.asarray(Uk), d=np.asarray(d, np.float32),
                    V=np.asarray(Vk), k_selected=k, converged=bool(conv),
                    iterations=int(it))
    res.center = np.asarray(center) if center is not None else None
    res.scale = (1.0 / np.asarray(scale)) if scale is not None else None
    return res


def randomized_svd(A, cfg: SVDConfig) -> SVDResult:
    """Halko-Martinsson-Tropp randomized SVD with oversampling + power
    iterations (svd/randomized.hpp).  Dense matmuls: tall-skinny QR + small
    SVD."""
    op, center, scale = _prep(A, cfg)
    m, n = op.shape
    k = min(cfg.k, min(m, n))
    p = min(cfg.oversample, min(m, n) - k)
    q = cfg.power_iters
    b = k + max(p, 0)

    Omega = rng_mod.fill_uniform(cfg.seed if cfg.seed != 0 else 12345,
                                 n, b).astype(np.float32) - 0.5
    Y = op.mm(jnp.asarray(Omega))                       # (m, b)
    Q, _ = jnp.linalg.qr(Y)
    for _ in range(q):
        Z = op.rmm(Q)                                   # (n, b)
        Qz, _ = jnp.linalg.qr(Z)
        Y = op.mm(Qz)
        Q, _ = jnp.linalg.qr(Y)
    Bs = op.rmm(Q).T                                    # (b, n)
    Ub, s, Vt = jnp.linalg.svd(Bs, full_matrices=False)
    U = jnp.dot(Q, Ub[:, :k], precision=PREC)
    return SVDResult(U=np.asarray(U), d=np.asarray(s[:k]),
                     V=np.asarray(Vt[:k].T), k_selected=k, converged=True,
                     iterations=q,
                     center=np.asarray(center) if center is not None else None,
                     scale=(1.0 / np.asarray(scale)) if scale is not None else None)


# ---------------------------------------------------------------------------
# Deflation SVD (rank-1 ALS on deflated residual; svd/deflation.hpp)
# ---------------------------------------------------------------------------

def _soft_threshold(x, t):
    return jnp.sign(x) * jnp.maximum(jnp.abs(x) - t, 0.0)


def _kspr_half(F_other, B, L1, L2, nonneg, upper_bound, cv_corr=1.0,
               G_add=None):
    """One constrained-LS half-update of the KSPR refinement
    (svd/krylov.hpp:420-600): given B = A V (resp. A^T W) and the fixed
    side F_other, solve the ridge system, apply the elementwise constraint
    projection, and return (X, column norms) with X column-normalized.
    Shared between the in-memory and streaming drivers — call inside jit or
    wrap with jax.jit at the call site.

    ``cv_corr``: held-out-aware denominator correction (1 - test_fraction).
    Training on the holdout-zeroed matrix shrinks B by that factor in
    expectation; scaling the Gram and the L1-threshold norms by the same
    factor unbiases the solve (svd/krylov.hpp:474,521)."""
    k = F_other.shape[1]
    G = cv_corr * jnp.dot(F_other.T, F_other, precision=PREC) + \
        (1e-12 + L2) * jnp.eye(k, dtype=F_other.dtype)
    if G_add is not None:
        # tier-2 Gram-level features from the previous iterate of the
        # side being solved (svd/krylov.hpp:481-497)
        G = G + G_add
    L = lax.linalg.cholesky(G)
    Xt = lax.linalg.triangular_solve(L, B.T, left_side=True, lower=True)
    Xt = lax.linalg.triangular_solve(L, Xt, left_side=True, lower=True,
                                     transpose_a=True)
    X = Xt.T
    norm_sq = cv_corr * jnp.sum(F_other * F_other, axis=0)
    if L1 > 0:
        X = _soft_threshold(X, L1 / (2.0 * norm_sq)[None, :])
    if nonneg:
        X = jnp.maximum(X, 0.0)
    if upper_bound > 0:
        X = jnp.minimum(X, upper_bound)
    d = jnp.sqrt(jnp.sum(X * X, axis=0))
    return X / jnp.maximum(d, 1e-30)[None, :], d


def _huber_weights(resid, delta):
    """MAD-scaled Huber IRLS weights (deflation.hpp:96-168).

    scale = median(|r|) / 0.6745 (upper median: nth_element at len/2),
    falling back to 1 when the residuals are ~all zero; then
    w = 1 for |r/scale| <= delta, else delta/|r/scale| in (0, 1]."""
    ar = jnp.abs(resid)
    mad = jnp.sort(ar)[ar.shape[0] // 2]
    scale = mad / 0.6745
    scale = jnp.where(scale < np.float32(np.finfo(np.float32).eps * 100),
                      1.0, scale)
    z = ar / scale
    return jnp.where(z <= delta, 1.0, delta / jnp.maximum(z, 1e-30))


@partial(jax.jit,
         static_argnames=("cfg", "max_iter", "do_robust", "has_gu", "has_gv"))
def _rank1_solve(Ad, At, u0, Uk, dk, Vk, tol_k, gu, gv, cv_corr, *,
                 cfg: SVDConfig, max_iter: int, do_robust: bool,
                 has_gu: bool, has_gv: bool):
    """Full rank-1 ALS on the deflated operator, on-device.

    One lax.while_loop replaces the reference's host iteration loop
    (deflation.hpp:678-795) so there is no per-step host sync.  With
    cfg.robust_delta > 0 this runs the reference's Huber IRLS
    (deflation.hpp:689-766): from iteration 1 on, row weights come from
    the rank-1 residual r_i = (Av)_i - sigma*u_i and column weights from
    r_j = (A'u)_j - sigma*v_j, each MAD-scaled, and the v/u updates use
    the weighted normal equations v = A' diag(w) u_hat / (u_hat' W u_hat).
    Momentum is disabled under IRLS (deflation.hpp:683-686).

    Module-level + data as jit ARGUMENTS: a per-fit closure would bake
    the (m, n) matrix and its transpose into the HLO as constants
    (oversized remote-compile payloads) and recompile on every call.
    Static keys: (shapes, cfg, loop params) — one executable per fit
    configuration, shared across deflation ranks and repeated fits."""
    n = Ad.shape[1]

    def defl_t(x):                 # A^T x - V d U^T x
        return jnp.dot(At, x, precision=PREC) - jnp.dot(
            Vk * dk[None, :], jnp.dot(Uk.T, x, precision=PREC),
            precision=PREC)

    def defl_f(x):                 # A x - U d V^T x
        return jnp.dot(Ad, x, precision=PREC) - jnp.dot(
            Uk * dk[None, :], jnp.dot(Vk.T, x, precision=PREC),
            precision=PREC)

    def cond(carry):
        _u, _v, _u_prev, _sigma, it, cd = carry
        return (it < max_iter) & (cd >= tol_k)

    def body(carry):
        u, v, u_prev, sigma, it, _cd = carry
        itf = it.astype(jnp.float32)
        beta = jnp.where(itf > 1, (itf - 1.0) / (itf + 2.0), 0.0)
        if do_robust:
            beta = jnp.zeros_like(beta)
        u_hat = u + beta * (u - u_prev)

        if do_robust:
            live = itf > 0         # weights need a sigma estimate
            rw = jnp.where(live, _huber_weights(
                defl_f(v) - sigma * u, cfg.robust_delta), 1.0)
            cw = jnp.where(live, _huber_weights(
                defl_t(u) - sigma * v, cfg.robust_delta), 1.0)
            wu = u_hat * rw
            w = defl_t(wu)
            u_sq_w = jnp.sum(wu * u_hat) * cv_corr
        else:
            w = defl_t(u_hat)
            u_sq_w = jnp.sum(u_hat * u_hat) * cv_corr
        v_new = w / jnp.maximum(u_sq_w, 1e-30)
        # regularization always uses the unweighted norm (deflation.hpp:735-741)
        u_sq = jnp.sum(u_hat * u_hat) * cv_corr
        v_new = _apply_reg_vec(v_new, cfg.v.L1, cfg.v.L2, cfg.v.nonneg,
                               cfg.v.upper_bound, u_sq, cfg.v.L21)
        # angular vs prior factors + graph smoothness
        # (deflation.hpp:256-292, applied at :740-741)
        u_sq_safe = jnp.maximum(u_sq, 1e-30)
        if cfg.v.angular > 0:
            v_new = v_new - (cfg.v.angular / u_sq_safe) * jnp.dot(
                Vk, jnp.dot(Vk.T, v_new, precision=PREC), precision=PREC)
        if has_gv:
            v_new = v_new - (cfg.v.graph_lambda / u_sq_safe) * jnp.dot(
                gv, v_new, precision=PREC)
        sigma_v = jnp.sqrt(jnp.sum(v_new * v_new))
        v_new = v_new / jnp.maximum(sigma_v, 1e-30)

        if do_robust:
            wv = v_new * cw
            w2 = defl_f(wv)
            v_sq_w = jnp.sum(wv * v_new) * cv_corr
        else:
            w2 = defl_f(v_new)
            v_sq_w = jnp.sum(v_new * v_new) * cv_corr
        u_new = w2 / jnp.maximum(v_sq_w, 1e-30)
        v_sq = jnp.sum(v_new * v_new) * cv_corr
        u_new = _apply_reg_vec(u_new, cfg.u.L1, cfg.u.L2, cfg.u.nonneg,
                               cfg.u.upper_bound, v_sq, cfg.u.L21)
        v_sq_safe = jnp.maximum(v_sq, 1e-30)
        if cfg.u.angular > 0:   # deflation.hpp:785-787
            u_new = u_new - (cfg.u.angular / v_sq_safe) * jnp.dot(
                Uk, jnp.dot(Uk.T, u_new, precision=PREC), precision=PREC)
        if has_gu:
            u_new = u_new - (cfg.u.graph_lambda / v_sq_safe) * jnp.dot(
                gu, u_new, precision=PREC)
        sigma_new = jnp.sqrt(jnp.sum(u_new * u_new))
        u_new = u_new / jnp.maximum(sigma_new, 1e-30)
        cos_dist = 1.0 - jnp.abs(jnp.sum(u_new * u))
        # convergence modes (deflation.hpp:796-814): FACTOR = cosine
        # distance of consecutive u; LOSS = relative sigma change
        # (valid from iteration 1); BOTH = either
        if cfg.convergence == "factor":
            cd = cos_dist
        else:
            d_sigma = jnp.abs(sigma_new - sigma) / jnp.maximum(
                sigma, np.float32(np.finfo(np.float32).eps))
            d_sigma = jnp.where(it > 0, d_sigma, jnp.float32(jnp.inf))
            cd = (d_sigma if cfg.convergence == "loss"
                  else jnp.minimum(cos_dist, d_sigma))
        # a zero factor means the reference breaks out (deflation.hpp:745,783)
        cd = jnp.where((sigma_new > 0) & (sigma_v > 0), cd, -1.0)
        return (u_new, v_new, u, sigma_new, it + 1, cd)

    init = (u0, jnp.zeros((n,), jnp.float32), u0,
            jnp.float32(0.0), jnp.int32(0), jnp.float32(jnp.inf))
    u, v, _u_prev, sigma, it, _cd = jax.lax.while_loop(cond, body, init)
    return u, v, sigma, it


def _apply_reg_vec(x, L1, L2, nonneg, upper_bound, norm_sq, L21):
    """Per-vector constraint projection (deflation.hpp:192-239).

    L21 degenerates to adaptive L2 for rank-1; L2 scales the whole vector by
    1/(1 + L2/norm_sq); L1 soft-thresholds at L1/(2 norm_sq)."""
    if L21 > 0:
        xn = jnp.sqrt(jnp.sum(x * x))
        L2 = L2 + jnp.where(xn > 1e-10, L21 / jnp.maximum(xn, 1e-10), 0.0)
    if isinstance(L2, jax.Array) or L2 > 0:
        x = x / (1.0 + L2 / norm_sq)
    if L1 > 0:
        x = _soft_threshold(x, L1 / (2.0 * norm_sq))
    if nonneg:
        x = jnp.maximum(x, 0.0)
    if upper_bound > 0:
        x = jnp.minimum(x, upper_bound)
    return x


def deflation_svd(A, cfg: SVDConfig, *, obs_mask=None,
                  aux=None) -> SVDResult:
    """Rank-1 ALS deflation SVD with constraints, robust IRLS, and built-in
    speckled-holdout auto-rank (svd/deflation.hpp:430-900).

    Supports SVD / PCA (center) / NNSVD (nonneg u+v) / sparse PCA (L1) /
    semi-NMF SVD (nonneg one side).  With ``cfg.test_fraction > 0``, stops
    adding factors when held-out MSE stops improving (patience from
    cfg via max(2, ...)).

    ``obs_mask`` (bool (m, n)): user-unobserved entries — zeroed in the
    training matrix BEFORE the CV holdout so the model never sees them
    (deflation.hpp:450-485); ``cfg.mask_zeros`` restricts CV holdout to
    nonzero entries of A (speckled_cv.hpp:52-53).
    """
    from .. import rng as rng_mod
    A_np = np.asarray(_densify(A), dtype=np.float32)
    m, n = A_np.shape
    k_max = min(cfg.k, min(m, n))
    do_cv = cfg.test_fraction > 0
    do_robust = cfg.robust_delta > 0
    patience = cfg.patience

    A_obs = A_np
    if obs_mask is not None:
        obs_mask = np.asarray(obs_mask, dtype=bool)
        if obs_mask.shape != (m, n):
            raise ValueError(f"mask dimensions {obs_mask.shape} must match "
                             f"data {(m, n)}")
        A_obs = A_np * (~obs_mask)

    # CV: zero held-out entries in the training matrix; evaluate on them
    cv_corr = 1.0
    M_test = None
    if do_cv:
        inv_prob = int(1.0 / cfg.test_fraction)
        M_test = rng_mod.holdout_mask(
            cfg.cv_seed if cfg.cv_seed else cfg.seed, m, n, inv_prob)
        if cfg.mask_zeros:
            # only nonzero entries are observed -> eligible for holdout
            # (use A_obs: user-masked entries are not observations)
            M_test &= A_obs != 0
        if obs_mask is not None:
            # user-masked entries are unobserved — they must be excluded
            # from the holdout too, or test loss / auto-rank selection
            # would be scored against values the model never sees
            # (svd/test_entries.hpp skips config-masked entries)
            M_test &= ~obs_mask
        # the holdout hash draws with probability 1/inv_prob — the
        # unbiasing factor must match it, not the raw test_fraction
        # (they differ when 1/test_fraction is not an integer)
        cv_corr = 1.0 - 1.0 / inv_prob
    A_train = A_obs * (~M_test) if M_test is not None else A_obs
    if cfg.center:
        center = A_train.mean(axis=1)
        A_train = A_train - center[:, None]
    else:
        center = None
    row_sds = None
    if cfg.scale:
        # correlation PCA: rows standardized by population sd
        # (deflation.hpp:385-394, spmv.hpp compute_row_sds)
        row_sds = np.maximum(A_train.std(axis=1), 1e-8).astype(np.float32)
        A_train = A_train / row_sds[:, None]

    Ad = jnp.asarray(A_train)
    At = Ad.T
    max_iter = cfg.max_iter if cfg.max_iter > 0 else 100

    U_all = np.zeros((m, k_max), np.float32)
    V_all = np.zeros((n, k_max), np.float32)
    d_all = np.zeros((k_max,), np.float32)
    iters_per_factor = []
    test_traj = []
    best_test = np.inf
    best_k = 0
    pat_ctr = 0
    if do_cv:
        # exact per-entry residual tracking (test_entries.hpp TestEntries):
        # r_ij starts at the true held-out value (training-centered) and
        # each accepted factor subtracts sigma*u_i*v_j — O(T) per factor
        # instead of a dense (m, n) reconstruction
        te_rows, te_cols = np.nonzero(M_test)
        te_resid = A_np[te_rows, te_cols].astype(np.float64)
        if center is not None:
            te_resid = te_resid - np.asarray(center, np.float64)[te_rows]
        if row_sds is not None:
            # factors reconstruct the row-STANDARDIZED matrix: held-out
            # residuals must live in the same units or test MSE is garbage
            te_resid = te_resid / np.asarray(row_sds, np.float64)[te_rows]
    # sequential draws mirror the reference per-factor init stream
    rng_state = {"offset": 0}
    seed = cfg.seed if cfg.seed != 0 else 42

    def rand_u():
        u = rng_mod.fill_uniform(seed, m, 1, offset=rng_state["offset"])[:, 0]
        rng_state["offset"] += m
        return u.astype(np.float32)

    aux = aux or {}
    has_gu = aux.get("graph_U") is not None and cfg.u.graph_lambda > 0
    has_gv = aux.get("graph_V") is not None and cfg.v.graph_lambda > 0
    _gdummy = jnp.zeros((1, 1), jnp.float32)
    gu_dev = jnp.asarray(aux["graph_U"], jnp.float32) if has_gu else _gdummy
    gv_dev = jnp.asarray(aux["graph_V"], jnp.float32) if has_gv else _gdummy


    # any elementwise projection (nonneg / soft-threshold / bound clip)
    # would be undone by Gram-Schmidt re-mixing — skip GS for all of them
    constrained = (cfg.u.nonneg or cfg.v.nonneg or cfg.u.L1 > 0 or
                   cfg.v.L1 > 0 or cfg.u.L2 > 0 or cfg.v.L2 > 0 or
                   cfg.u.L21 > 0 or cfg.v.L21 > 0 or
                   cfg.u.upper_bound > 0 or cfg.v.upper_bound > 0)

    for kk in range(k_max):
        Uk = jnp.asarray(U_all)
        Vk = jnp.asarray(V_all)
        dk = jnp.asarray(d_all)

        if kk == 0:
            u = jnp.asarray(rand_u())
        else:
            # power-step warm start from previous factor (deflation.hpp:637-660)
            u = Uk[:, kk - 1]
            u = u - jnp.dot(Uk, jnp.dot(Uk.T, u, precision=PREC), precision=PREC)
            nu = float(jnp.sqrt(jnp.sum(u * u)))
            if nu < 1e-5:
                u = jnp.asarray(rand_u())
        u = u / jnp.maximum(jnp.sqrt(jnp.sum(u * u)), 1e-30)

        tol_k = cfg.tol if cfg.tol > 0 else 1e-5
        if kk > 0 and d_all[0] > 0 and d_all[kk - 1] > 0:
            tol_k = min(tol_k * d_all[0] / d_all[kk - 1], tol_k * 100)

        u, v, _sig, it = _rank1_solve(
            Ad, At, u, Uk, dk, Vk, jnp.float32(tol_k), gu_dev, gv_dev,
            jnp.float32(cv_corr), cfg=cfg, max_iter=max_iter,
            do_robust=do_robust, has_gu=has_gu, has_gv=has_gv)
        it = int(it)

        # two-pass Gram-Schmidt against stored factors (deflation.hpp:824-850)
        if kk > 0 and not constrained:
            for _ in range(2):
                u = u - jnp.dot(Uk, jnp.dot(Uk.T, u, precision=PREC), precision=PREC)
                v = v - jnp.dot(Vk, jnp.dot(Vk.T, v, precision=PREC), precision=PREC)
            u = u / jnp.maximum(jnp.sqrt(jnp.sum(u * u)), 1e-30)
            v = v / jnp.maximum(jnp.sqrt(jnp.sum(v * v)), 1e-30)

        # Rayleigh sigma after reorthogonalization (deflation.hpp:852-861)
        w2 = jnp.dot(Ad, v, precision=PREC) - jnp.dot(
            Uk * dk[None, :], jnp.dot(Vk.T, v, precision=PREC), precision=PREC)
        sigma = abs(float(jnp.dot(u, w2, precision=PREC)))

        U_all[:, kk] = np.asarray(u)
        V_all[:, kk] = np.asarray(v)
        d_all[kk] = sigma
        iters_per_factor.append(it)

        if do_cv:
            te_resid = te_resid - sigma * (U_all[te_rows, kk].astype(np.float64)
                                           * V_all[te_cols, kk])
            test_mse = (float(np.mean(te_resid ** 2)) if te_resid.size
                        else 0.0)
            test_traj.append(test_mse)
            if test_mse < best_test:
                best_test = test_mse
                best_k = kk + 1
                pat_ctr = 0
            else:
                pat_ctr += 1
                if pat_ctr >= patience:
                    break

    k_sel = best_k if (do_cv and best_k > 0) else (kk + 1)
    res = SVDResult(U=U_all[:, :k_sel], d=d_all[:k_sel], V=V_all[:, :k_sel],
                    k_selected=k_sel, converged=True,
                    iterations=int(np.sum(iters_per_factor)),
                    center=center, scale=row_sds,
                    test_loss=best_test if do_cv else float("nan"))
    res.misc["iters_per_factor"] = iters_per_factor
    res.misc["test_loss_trajectory"] = test_traj
    return res


# ---------------------------------------------------------------------------
# Krylov-Seeded Projected Refinement (constrained SVD; svd/krylov.hpp)
# ---------------------------------------------------------------------------

def _cv_rank_select(A_orig, M_test, U, d, V, center, patience,
                    row_sds=None):
    """Exact per-entry held-out test-loss evaluation (svd/test_entries.hpp).

    The residual of every held-out entry (true value, row-centered like the
    training matrix) is updated as factors are added in descending-sigma
    order — ``r_ij -= sigma_k u_k(i) v_k(j)`` — and rank selection follows
    the patience rule on the exact test MSE (krylov.hpp:698-731,
    deflation.hpp:869-895).  Returns (best_k, best_mse, trajectory)."""
    rows, cols = np.nonzero(M_test)
    resid = A_orig[rows, cols].astype(np.float64)
    if center is not None:
        resid = resid - np.asarray(center, np.float64)[rows]
    if row_sds is not None:
        # match the row-standardized units of the factors (scale=True)
        resid = resid / np.asarray(row_sds, np.float64)[rows]
    best = np.inf
    best_k = 0
    pat = 0
    traj = []
    for rank in range(d.shape[0]):
        resid = resid - float(d[rank]) * U[rows, rank] * V[cols, rank]
        mse = float(np.mean(resid ** 2)) if resid.size else 0.0
        traj.append(mse)
        if mse < best:
            best, best_k, pat = mse, rank + 1, 0
        else:
            pat += 1
            if pat >= patience:
                break
    return best_k, best, traj


def krylov_svd(A, cfg: SVDConfig, aux=None) -> SVDResult:
    """KSPR constrained SVD: Lanczos seed -> batched projected refinement
    (svd/krylov.hpp:420-600).

    Each pass: Gram of the fixed side -> dense SpMM -> Cholesky solve ->
    elementwise constraint projection (L1 soft-threshold at L1/(2 norm_sq),
    nonneg clip) -> column normalization with scale absorbed into d.
    Falls back to pure Lanczos when no constraints are active.

    With ``cfg.test_fraction > 0`` the fit is held-out-aware
    (svd/krylov.hpp:397-414,474,521 + test_entries.hpp): the Lanczos seed
    and every refinement pass see only the holdout-zeroed training matrix,
    the Gram/norm denominators carry the ``1 - test_fraction`` correction,
    and rank is selected by exact per-entry test MSE with patience.
    """
    has_constraints = (cfg.u.nonneg or cfg.v.nonneg or cfg.u.L1 > 0 or
                      cfg.v.L1 > 0 or cfg.u.L2 > 0 or cfg.v.L2 > 0 or
                      cfg.u.L21 > 0 or cfg.v.L21 > 0 or
                      cfg.u.upper_bound > 0 or cfg.v.upper_bound > 0 or
                      cfg.u.angular > 0 or cfg.v.angular > 0 or
                      bool(aux and (aux.get("graph_U") is not None or
                                    aux.get("graph_V") is not None)))
    do_cv = cfg.test_fraction > 0

    M_test = None
    cv_corr = 1.0
    A_orig = None
    if do_cv:
        from .. import rng as rng_mod
        A_orig = np.asarray(_densify(A), dtype=np.float32)
        inv_prob = int(1.0 / cfg.test_fraction)
        M_test = rng_mod.holdout_mask(
            cfg.cv_seed if cfg.cv_seed else cfg.seed,
            A_orig.shape[0], A_orig.shape[1], inv_prob)
        # the holdout hash draws with probability 1/inv_prob — the
        # unbiasing factor must match it, not the raw test_fraction
        # (they differ when 1/test_fraction is not an integer)
        cv_corr = 1.0 - 1.0 / inv_prob
        A = A_orig * (~M_test)          # phases 1+2 train on zeroed matrix

    seed_res = lanczos_svd(A, cfg)
    if not has_constraints and not do_cv:
        return seed_res

    A_np = np.asarray(_densify(A), dtype=np.float32)
    m, n = A_np.shape
    k = seed_res.k
    if cfg.center:
        center = A_np.mean(axis=1)
        A_np = A_np - center[:, None]
    else:
        center = None
    row_sds = None
    if cfg.scale:
        row_sds = np.maximum(A_np.std(axis=1), 1e-8).astype(np.float32)
        A_np = A_np / row_sds[:, None]
    Ad = jnp.asarray(A_np)

    max_passes = cfg.max_iter if cfg.max_iter > 0 else max(
        10, 2 * int(math.ceil(math.log2(max(k, 2)))) + 3)
    tol = cfg.tol if cfg.tol > 0 else 1e-5

    aux = aux or {}
    has_gu = aux.get("graph_U") is not None and cfg.u.graph_lambda > 0
    has_gv = aux.get("graph_V") is not None and cfg.v.graph_lambda > 0
    # Laplacians travel as jit ARGUMENTS (a closure capture would bake
    # them into the HLO as constants — oversized remote-compile payloads)
    dummy = jnp.zeros((1, 1), jnp.float32)
    gu_dev = jnp.asarray(aux["graph_U"], jnp.float32) if has_gu else dummy
    gv_dev = jnp.asarray(aux["graph_V"], jnp.float32) if has_gv else dummy

    def _tier2(X_prev, fc, graph, has_graph):
        # L21 / angular / graph at Gram level from the previous iterate
        # of the side being solved (krylov.hpp:481-497); X_prev is
        # (dim, k) -> the helpers take (k, dim)
        if fc.L21 <= 0 and fc.angular <= 0 and not has_graph:
            return None
        from ..ops import features as feat
        k_ = X_prev.shape[1]
        GA = jnp.zeros((k_, k_), X_prev.dtype)
        Xt = X_prev.T
        if fc.L21 > 0:
            GA = feat.apply_l21(GA, Xt, fc.L21)
        if fc.angular > 0:
            GA = feat.apply_angular_gram(GA, Xt, fc.angular)
        if has_graph:
            GA = feat.apply_graph_reg(GA, graph, Xt, fc.graph_lambda)
        return GA

    @jax.jit
    def one_pass(Adev, W, V, d, gu, gv):
        B = jnp.dot(Adev, V, precision=PREC)                   # (m, k)
        W, d = _kspr_half(V, B, cfg.u.L1, cfg.u.L2, cfg.u.nonneg,
                          cfg.u.upper_bound, cv_corr,
                          G_add=_tier2(W, cfg.u, gu, has_gu))
        B = jnp.dot(Adev.T, W, precision=PREC)                 # (n, k)
        # d REPLACED by the raw column norm each half-update — W and V stay
        # unit-norm, d tracks the singular value (krylov.hpp:424-427)
        V, d = _kspr_half(W, B, cfg.v.L1, cfg.v.L2, cfg.v.nonneg,
                          cfg.v.upper_bound, cv_corr,
                          G_add=_tier2(V, cfg.v, gv, has_gv))
        return W, V, d

    W = jnp.asarray(np.abs(seed_res.U) if cfg.u.nonneg else seed_res.U)
    V = jnp.asarray(np.abs(seed_res.V) if cfg.v.nonneg else seed_res.V)
    d = jnp.asarray(seed_res.d)
    passes = 0
    converged = False
    prev_W = None
    prev_var = None
    for passes in range(1, max_passes + 1):
        W, V, d = one_pass(Ad, W, V, d, gu_dev, gv_dev)
        # convergence modes (krylov.hpp:590-622): FACTOR = relative W
        # change; LOSS = relative change of sum(d^2) (variance proxy)
        factor_conv = loss_conv = False
        if cfg.convergence != "loss" and prev_W is not None:
            dW = float(jnp.linalg.norm(W - prev_W) /
                       (jnp.linalg.norm(prev_W) + 1e-30))
            factor_conv = dW < tol
        if cfg.convergence != "factor" and prev_var is not None:
            var_new = float(jnp.sum(d * d))
            loss_conv = abs(var_new - prev_var) / (prev_var + 1e-30) < tol
        if factor_conv or loss_conv:
            converged = True
            break
        prev_W = W
        prev_var = float(jnp.sum(d * d))

    order = np.argsort(-np.asarray(d), kind="stable")
    U_np = np.asarray(W)[:, order]
    d_np = np.asarray(d)[order]
    V_np = np.asarray(V)[:, order]

    if do_cv:
        best_k, best_mse, traj = _cv_rank_select(
            A_orig, M_test, U_np, d_np, V_np, center, cfg.patience,
            row_sds=row_sds)
        k_sel = best_k if best_k > 0 else k
        res = SVDResult(U=U_np[:, :k_sel], d=d_np[:k_sel], V=V_np[:, :k_sel],
                        k_selected=k_sel, converged=converged,
                        iterations=passes, center=center, scale=row_sds,
                        test_loss=best_mse)
        res.misc["test_loss_trajectory"] = traj
        return res

    return SVDResult(U=U_np, d=d_np, V=V_np, k_selected=k,
                     converged=converged, iterations=passes, center=center,
                     scale=row_sds)


# ---------------------------------------------------------------------------
# Gateway + auto-select (svd/gateway.hpp:141-187, auto_select.hpp:16-99)
# ---------------------------------------------------------------------------

def _auto_select_method(cfg: SVDConfig, k: int) -> str:
    has_constraints = (cfg.u.nonneg or cfg.v.nonneg or cfg.u.L1 > 0 or
                      cfg.v.L1 > 0 or cfg.u.L2 > 0 or cfg.v.L2 > 0 or
                      cfg.u.L21 > 0 or cfg.v.L21 > 0 or
                      cfg.u.upper_bound > 0 or cfg.v.upper_bound > 0 or
                      cfg.u.angular > 0 or cfg.v.angular > 0 or
                      cfg.u.graph_lambda > 0 or cfg.v.graph_lambda > 0)
    if cfg.robust_delta > 0:
        return "deflation"            # only robust-capable method
    if has_constraints:
        return "krylov" if k >= 8 else "deflation"
    if cfg.test_fraction > 0:
        return "deflation"            # CV needs held-out-aware solves (R/svd.R:383)
    # benchmark-derived accelerator policy (auto_select.hpp:60-99):
    # small k -> Lanczos; mid -> randomized; large -> IRLBA
    if k < 32:
        return "lanczos"
    if k < 64:
        return "randomized"
    return "irlba"


_SVD_METHODS = {}


def svd(data, k=10, *, method: str = "auto", center: bool = False,
        scale: bool = False, seed: int = 0, tol: float = 1e-5,
        maxit: int = 0, oversample: int = 10, power_iters: int = 2,
        nonneg=(False, False), L1=(0.0, 0.0), L2=(0.0, 0.0),
        L21=(0.0, 0.0), upper_bound=(0.0, 0.0), angular=(0.0, 0.0),
        graph_U=None, graph_V=None, graph_lambda=(0.0, 0.0), robust=False,
        test_fraction: float = 0.0, cv_seed: int = 0, mask=None,
        convergence: str = "factor", **kw) -> SVDResult:
    """Truncated SVD gateway (R/svd.R:108, svd/gateway.hpp:141-161).

    ``mask`` accepts ``None``, ``"zeros"`` (CV holdout restricted to
    nonzero entries), a matrix of unobserved entries, or
    ``("zeros", matrix)`` for both (R/svd.R:233-268).  Masks are honored
    by the deflation solver only (the reference's other solvers silently
    ignore ``obs_mask`` — deflation.hpp is its sole consumer; we reject
    instead).

    A ``.spz`` path dispatches to the streaming gateway
    (svd/gateway.hpp:173-187)."""
    from ..config import FactorConfig as FC

    # advanced dot-parameters: the reference REJECTS unknown names
    # (R/parse_dots.R:124-131) — never swallow a typo silently.
    _dot_defaults = {"patience": 3, "k_max": 50, "verbose": False,
                     "threads": 0, "resource": "auto"}
    unknown = set(kw) - set(_dot_defaults)
    if unknown:
        raise ValueError(
            f"unknown parameter(s) passed to svd(): "
            f"{', '.join(sorted(repr(u) for u in unknown))}; valid "
            f"advanced parameters: {sorted(_dot_defaults)} "
            "(R/parse_dots.R:106-131)")
    patience = int(kw.get("patience", _dot_defaults["patience"]))
    k_max = int(kw.get("k_max", _dot_defaults["k_max"]))
    verbose = kw.get("verbose", _dot_defaults["verbose"])
    # threads / resource are accepted for R-surface compatibility; the
    # single JAX path has no thread pool or backend switch to steer.
    from ..api import _extract_dimnames

    row_names = col_names = None
    if not isinstance(data, str):
        row_names, col_names, data = _extract_dimnames(data)
        # NaN detection (R/nmf_validation.R): SVD treats masks as
        # unobserved-zero rather than NaN-aware, so fail loudly instead
        # of returning NaN factors.  Device-resident arrays skip the
        # host scan (assumed clean, as in nmf()).
        import jax as _jax
        if not isinstance(data, _jax.Array):
            vals = data.data if hasattr(data, "nnz") else np.asarray(data)
            if np.isnan(np.asarray(vals)).any():
                raise ValueError("data contains NaN/NA values; impute "
                                 "them before svd()")

    if isinstance(data, str) and data.endswith(".spz"):
        if (any(np.atleast_1d(L21) != 0) or any(np.atleast_1d(angular) != 0)
                or graph_U is not None or graph_V is not None):
            raise ValueError(
                "streaming .spz SVD supports L1/L2/nonneg/upper_bound/"
                "robust only; decode in-memory (st_read) for L21/angular/"
                "graph regularization")
        if scale or test_fraction > 0 or convergence != "factor" \
                or mask is not None \
                or (isinstance(k, str) and k == "auto"):
            raise ValueError(
                "streaming .spz SVD does not support scale=, "
                "test_fraction=, mask=, convergence=, or k='auto'; "
                "decode in-memory (st_read) for those")
        if method == "auto":
            has_con = (any(np.atleast_1d(L1) != 0) or
                       any(np.atleast_1d(L2) != 0) or
                       any(np.atleast_1d(upper_bound) != 0) or
                       any(np.atleast_1d(nonneg)))
            robust_on = robust if isinstance(robust, bool) else robust > 0
            method = ("deflation" if robust_on else
                      "krylov" if has_con else "randomized")
        res = streaming_svd(
            data, int(k) if not isinstance(k, str) else 10,
            method=method, center=center, seed=seed, oversample=oversample,
            power_iters=power_iters, tol=tol, maxit=maxit,
            nonneg=nonneg, L1=L1, L2=L2, upper_bound=upper_bound,
            robust=robust)
        if verbose:
            from ..utils import logging as logmod
            logmod.log_summary(
                "[svd] streaming method=%s k=%d iterations=%s converged=%s",
                method, res.k_selected or int(k), res.iterations,
                res.converged, verbose=verbose)
        return res

    def pair(x):
        return (x, x) if np.isscalar(x) else tuple(x)

    l1u, l1v = pair(L1)
    l2u, l2v = pair(L2)
    l21u, l21v = pair(L21)
    nnu, nnv = (nonneg, nonneg) if isinstance(nonneg, bool) else tuple(nonneg)
    ubu, ubv = pair(upper_bound)
    angu, angv = pair(angular)
    glu, glv = pair(graph_lambda)
    if isinstance(robust, bool):
        robust_delta = 1.345 if robust else 0.0
    elif robust == "mae":
        # MAE = Huber with a vanishing quadratic zone (R/nmf_thin.R:341-353)
        robust_delta = 1e-4
    else:
        robust_delta = float(robust)

    def _dense_graph(L):
        if L is None:
            return None
        return np.asarray(L.todense() if hasattr(L, "todense") else L,
                          dtype=np.float32)
    aux = {"graph_U": _dense_graph(graph_U), "graph_V": _dense_graph(graph_V)}

    if convergence not in ("factor", "loss", "both"):
        raise ValueError(f"convergence={convergence!r}: use 'factor', "
                         "'loss', or 'both' (svd/gateway.hpp:119-122)")
    if scale and not center:
        center = True      # correlation PCA needs centering (R/svd.R:189)

    # mask parsing (R/svd.R:233-268): None | "zeros" | matrix |
    # ("zeros", matrix)
    mask_zeros = False
    obs_mask = None
    if mask is not None:
        if isinstance(mask, str):
            if mask != "zeros":
                raise ValueError(f"mask string must be 'zeros'; got {mask!r}")
            mask_zeros = True
        elif isinstance(mask, (list, tuple)):
            if len(mask) < 2 or mask[0] != "zeros":
                raise ValueError("mask sequence must be ('zeros', matrix)")
            mask_zeros = True
            obs_mask = mask[1]
        else:
            obs_mask = mask
        if obs_mask is not None:
            if hasattr(obs_mask, "todense"):
                obs_mask = np.asarray(obs_mask.todense())
            obs_mask = np.asarray(obs_mask) != 0
            if not isinstance(data, str) and obs_mask.shape != data.shape:
                raise ValueError(
                    f"mask dimensions {obs_mask.shape} must match data "
                    f"{tuple(data.shape)}")

    auto_k = isinstance(k, str) and k == "auto"
    cfg = SVDConfig(
        # auto-rank caps the search at k_max (R/svd.R:181 ``k <- k_max``)
        k=(min(k_max, *data.shape) if auto_k else int(k)),
        tol=tol, max_iter=maxit, center=center, scale=scale, seed=seed,
        oversample=oversample, power_iters=power_iters,
        robust_delta=robust_delta, convergence=convergence,
        u=FC(L1=l1u, L2=l2u, L21=l21u, nonneg=bool(nnu), upper_bound=ubu,
             angular=angu, graph_lambda=glu),
        v=FC(L1=l1v, L2=l2v, L21=l21v, nonneg=bool(nnv), upper_bound=ubv,
             angular=angv, graph_lambda=glv),
        test_fraction=(test_fraction if test_fraction > 0 else
                       (0.05 if auto_k else 0.0)),
        cv_seed=cv_seed, mask_zeros=mask_zeros, patience=patience)

    if auto_k:
        method = "deflation"          # built-in auto-rank
    if method == "auto" and (mask_zeros or obs_mask is not None):
        method = "deflation"          # the only mask-honoring solver
    if method == "auto":
        method = _auto_select_method(cfg, cfg.k)
    if (mask_zeros or obs_mask is not None) and method != "deflation":
        raise ValueError(
            f"mask= is supported by method='deflation' only (got "
            f"{method!r}); the reference's other solvers silently ignore "
            "masks (svd/deflation.hpp is the sole obs_mask consumer)")
    methods = {"lanczos": lanczos_svd, "irlba": irlba_svd,
               "randomized": randomized_svd, "krylov": krylov_svd,
               "deflation": deflation_svd}
    if method not in methods:
        raise ValueError(f"unknown SVD method {method!r}; valid: "
                         f"{sorted(methods)} or 'auto'")
    fn = methods[method]

    # CV is supported by the held-out-aware solvers only (R/svd.R:284,313:
    # cv_methods = deflation, krylov).  Auto-rank requires one of them;
    # for a plain test_fraction the reference silently disables CV — we
    # warn instead of dropping the argument silently.
    if cfg.test_fraction > 0 and method not in ("deflation", "krylov"):
        if auto_k:
            raise ValueError(f"method {method!r} does not support auto-rank; "
                             "use 'deflation', 'krylov', or method='auto'")
        import warnings
        warnings.warn(f"method {method!r} does not support cross-validation; "
                      "test_fraction ignored (use 'deflation' or 'krylov')")
        cfg = cfg.replace(test_fraction=0.0)

    if mask_zeros and obs_mask is None and cfg.test_fraction <= 0 \
            and not auto_k:
        # reference semantics: mask="zeros" only restricts CV-holdout
        # eligibility (R/svd.R:64-65); without CV it changes nothing —
        # say so instead of silently accepting (round-2 review #4)
        import warnings
        warnings.warn("svd(mask='zeros') without test_fraction>0 or "
                      "k='auto' has no effect: zeros only restrict CV "
                      "holdout eligibility (R/svd.R:64-65); the fit "
                      "itself treats zeros as observed")

    has_tier2 = (angu > 0 or angv > 0 or
                 aux["graph_U"] is not None or aux["graph_V"] is not None)
    has_elementwise = (bool(nnu) or bool(nnv) or l1u > 0 or l1v > 0 or
                       l2u > 0 or l2v > 0 or l21u > 0 or l21v > 0 or
                       ubu > 0 or ubv > 0)
    if method == "deflation":
        res = fn(data, cfg, aux=aux, obs_mask=obs_mask)
    elif method == "krylov":
        if cfg.robust_delta > 0:
            import warnings
            warnings.warn("method 'krylov' does not support robust= "
                          "(Huber IRLS); use 'deflation' or method='auto'")
        res = fn(data, cfg, aux=aux)
    else:
        # match the streaming gateway: never drop a constraint silently
        if has_tier2 or has_elementwise or cfg.robust_delta > 0:
            import warnings
            dropped = []
            if has_elementwise:
                dropped.append("elementwise constraints "
                               "(nonneg/L1/L2/L21/upper_bound)")
            if has_tier2:
                dropped.append("angular/graph regularization")
            if cfg.robust_delta > 0:
                dropped.append("robust=")
            warnings.warn(f"method {method!r} does not support "
                          f"{'; '.join(dropped)} — ignored (use "
                          "'deflation' or 'krylov')")
        res = fn(data, cfg)
    res.misc["method"] = method
    # total-variance denominator for variance_explained()
    # (deflation.hpp:396-417): ||A||^2, minus n*||rowmean||^2 when
    # centered; exactly m*n when scaled (standardized rows)
    m_, n_ = (data.shape if not isinstance(data, str) else (0, 0))
    if cfg.scale:
        res.misc["frobenius_norm_sq"] = float(m_) * float(n_)
    elif not isinstance(data, str):
        if hasattr(data, "nnz"):
            fro2 = float((data.data.astype(np.float64) ** 2).sum())
            if cfg.center:
                mu = np.asarray(data.mean(axis=1), dtype=np.float64).ravel()
                fro2 -= n_ * float((mu ** 2).sum())
        elif isinstance(data, jax.Array):  # device: one small reduction
            fro2 = float(jnp.sum(data.astype(jnp.float32) ** 2))
            if cfg.center:
                mu = jnp.mean(data, axis=1)
                fro2 -= n_ * float(jnp.sum(mu ** 2))
        else:
            arr = np.asarray(data, dtype=np.float64)
            fro2 = float((arr ** 2).sum())
            if cfg.center:
                mu = arr.mean(axis=1)
                fro2 -= n_ * float((mu ** 2).sum())
        res.misc["frobenius_norm_sq"] = fro2
    res.row_names, res.col_names = row_names, col_names
    if verbose:
        from ..utils import logging as logmod
        logmod.log_summary(
            "[svd] method=%s k=%d iterations=%s converged=%s", method,
            res.k_selected or cfg.k, res.iterations, res.converged,
            verbose=verbose)
    return res


def pca(data, k=10, *, center: bool = True, scale: bool = False, **kw) -> SVDResult:
    """PCA via truncated SVD of the (implicitly) centered matrix
    (R/svd.R:596 pca wrapper)."""
    res = svd(data, k, center=center, scale=scale, **kw)
    d = np.asarray(res.d)
    # np.asarray(scipy.sparse) yields a 0-d object array; use the native
    # .shape (works for ndarray/sparse/jax), or V for .spz path inputs
    n = (np.asarray(res.V).shape[0] if isinstance(data, str)
         else data.shape[1])
    res.misc["sdev"] = d / math.sqrt(max(n - 1, 1))
    return res


# ---------------------------------------------------------------------------
# Streaming SVD over a DataLoader (svd/streaming.hpp:77+)
# ---------------------------------------------------------------------------

class _LoaderOp:
    """Chunked matvec/matmul operator: panels stream through the device,
    accumulating products — A itself never lives in device memory whole
    (svd/streaming_matvec.hpp analog).

    Streaming SVD drives DOZENS of matvecs (one mm + one rmm per GKB
    step), so panels that fit device memory with headroom are cached
    device-resident across calls, with decode skipped on full hits (the
    same residency policy as nmf_chunked's panel cache; inputs larger
    than the budget keep true per-call streaming)."""

    def __init__(self, loader, center=None, panel_cache=None):
        self.loader = loader
        self.shape = loader.shape
        self.center = center
        m, n = loader.shape
        from ..utils.memory import check_dense_alloc, device_hbm_bytes
        if panel_cache is None:
            if device_hbm_bytes() > 0:
                self._cache_ok = check_dense_alloc(2 * m, n,
                                                   where="device").fits
            else:
                # device memory unknown: conservative static bound only
                self._cache_ok = 2.0 * m * n * 4 <= 4 * 1024 ** 3
        else:
            self._cache_ok = bool(panel_cache)
        self._cache: dict = {}
        self._meta: dict = {False: {}, True: {}}
        # a pass that raises (or is abandoned) mid-iteration must not
        # leave a PARTIAL panel set that later hits would silently serve
        self._complete = {False: False, True: False}

    def _panels(self, transpose: bool):
        meta = self._meta[transpose]
        if self._cache_ok and self._complete[transpose]:
            for cs in sorted(meta):
                yield cs, meta[cs], self._cache[(transpose, cs)]
            return
        meta.clear()
        for ch in self.loader.iter_chunks(transpose=transpose):
            meta[ch.col_start] = ch.num_cols
            d = jnp.asarray(ch.data)
            if self._cache_ok:
                self._cache[(transpose, ch.col_start)] = d
            yield ch.col_start, ch.num_cols, d
        self._complete[transpose] = self._cache_ok

    def mm(self, X):                      # (n, b) -> (m, b)
        m, n = self.shape
        X = jnp.asarray(X)
        Y = jnp.zeros((m, X.shape[1]), jnp.float32)
        for cs, nc, data in self._panels(False):
            Xb = X[cs:cs + nc]
            Y = Y + jnp.dot(data, Xb, precision=PREC)
        if self.center is not None:
            Y = Y - jnp.outer(self.center, jnp.sum(X, axis=0))
        return Y

    def rmm(self, X):                     # (m, b) -> (n, b)
        m, n = self.shape
        X = jnp.asarray(X)
        Y = jnp.zeros((n, X.shape[1]), jnp.float32)
        # transpose panels are (n, pc) column blocks of A^T; their columns
        # index the m axis, so each contributes panel @ X[rows-of-A block]
        for cs, nc, data in self._panels(True):
            Xb = X[cs:cs + nc]
            Y = Y + jnp.dot(data, Xb, precision=PREC)
        if self.center is not None:
            Y = Y - jnp.outer(jnp.ones((n,), jnp.float32),
                              jnp.dot(self.center, X, precision=PREC))
        return Y

    def mv(self, x):
        return self.mm(x[:, None])[:, 0]

    def rmv(self, x):
        return self.rmm(x[:, None])[:, 0]

    def row_means(self):
        m, n = self.shape
        s = jnp.zeros((m,), jnp.float32)
        for cs, nc, data in self._panels(False):
            s = s + jnp.sum(data, axis=1)
        return s / n


def _stream_gkb(op, U, V, alphas, betas, start, v_next, steps):
    """Host-loop Golub-Kahan extension over any mv/rmv operator — the
    streaming analog of the jitted ``_gkb_extend`` (svd/streaming_matvec.hpp),
    with the same full reorthogonalization and breakdown guards."""
    amax = float(max(jnp.max(alphas), jnp.max(betas)))
    for j in range(start, steps):
        V = V.at[:, j].set(v_next)
        u = op.mv(v_next)
        u = u - jnp.dot(U, jnp.dot(U.T, u, precision=PREC), precision=PREC)
        alpha = float(jnp.sqrt(jnp.sum(u * u)))
        ok_a = alpha > 1e-5 * max(amax, 1e-30)
        if ok_a:
            u = u / max(alpha, 1e-30)
            amax = max(amax, alpha)
        else:
            u = jnp.zeros_like(u)
            alpha = 0.0
        U = U.at[:, j].set(u)
        alphas = alphas.at[j].set(alpha)

        w = op.rmv(u)
        w = w - jnp.dot(V, jnp.dot(V.T, w, precision=PREC), precision=PREC)
        beta = float(jnp.sqrt(jnp.sum(w * w)))
        ok_b = ok_a and beta > 1e-5 * max(amax, 1e-30)
        if ok_b:
            v_next = w / max(beta, 1e-30)
            amax = max(amax, beta)
        else:
            v_next = jnp.zeros_like(w)
            beta = 0.0
        betas = betas.at[j].set(beta)
    return U, V, alphas, betas, v_next


def streaming_svd(loader, k: int = 10, *, method: str = "randomized",
                  center: bool = False, seed: int = 0, oversample: int = 10,
                  power_iters: int = 2, tol: float = 1e-5, maxit: int = 0,
                  work: int = 0, nonneg=(False, False), L1=(0.0, 0.0),
                  L2=(0.0, 0.0), upper_bound=(0.0, 0.0),
                  robust=False) -> SVDResult:
    """Truncated SVD over a DataLoader / .spz path without materializing A
    (svd/streaming.hpp:77+ streams all five algorithms; so does this).

    randomized / lanczos / irlba / krylov / deflation.  krylov takes the
    elementwise constraints (nonneg/L1/L2/upper_bound per side); deflation
    additionally supports robust Huber IRLS.  Every algorithm touches A
    only through chunked panel products (``_LoaderOp``)."""
    from ..io.loaders import DataLoader, InMemoryLoader, SpzLoader
    if method in ("randomized", "lanczos", "irlba"):
        has_con = (any(np.atleast_1d(L1) != 0) or
                   any(np.atleast_1d(L2) != 0) or
                   any(np.atleast_1d(upper_bound) != 0) or
                   any(np.atleast_1d(nonneg)))
        if has_con:
            import warnings
            warnings.warn(f"streaming method {method!r} does not apply "
                          "elementwise constraints; use 'krylov' or "
                          "'deflation'")
    if isinstance(loader, (str, bytes)):
        loader = SpzLoader(loader)
    elif not isinstance(loader, DataLoader):
        loader = InMemoryLoader(loader)
    m, n = loader.shape
    k = min(k, min(m, n))
    c = None
    op = _LoaderOp(loader)
    if center:
        c = op.row_means()
        op = _LoaderOp(loader, center=c)
    c_np = np.asarray(c) if c is not None else None

    def pair(x):
        return (x, x) if np.isscalar(x) or isinstance(x, bool) else tuple(x)

    if method == "randomized":
        b = k + min(oversample, min(m, n) - k)
        Omega = jnp.asarray(
            rng_mod.fill_uniform(seed if seed else 12345, n, b)
            .astype(np.float32) - 0.5)
        Y = op.mm(Omega)
        Q, _ = jnp.linalg.qr(Y)
        for _ in range(power_iters):
            Z = op.rmm(Q)
            Qz, _ = jnp.linalg.qr(Z)
            Y = op.mm(Qz)
            Q, _ = jnp.linalg.qr(Y)
        Bs = op.rmm(Q).T
        Ub, s, Vt = jnp.linalg.svd(Bs, full_matrices=False)
        U = jnp.dot(Q, Ub[:, :k], precision=PREC)
        return SVDResult(U=np.asarray(U), d=np.asarray(s[:k]),
                         V=np.asarray(Vt[:k].T), k_selected=k,
                         converged=True, iterations=power_iters,
                         center=c_np)

    if method == "lanczos":
        steps = min(min(m, n), max(2 * k + 10, 20))
        U = jnp.zeros((m, steps), jnp.float32)
        V = jnp.zeros((n, steps), jnp.float32)
        alphas = jnp.zeros((steps,), jnp.float32)
        betas = jnp.zeros((steps,), jnp.float32)
        U, V, alphas, betas, _ = _stream_gkb(
            op, U, V, alphas, betas, 0, jnp.asarray(_seed_vector(n, seed)),
            steps)
        B = np.diag(np.asarray(alphas, np.float64)) + \
            np.diag(np.asarray(betas, np.float64)[:-1], 1)
        P, s, Qt = np.linalg.svd(B)
        Uk = jnp.dot(U, jnp.asarray(P[:, :k], jnp.float32), precision=PREC)
        Vk = jnp.dot(V, jnp.asarray(Qt[:k].T, jnp.float32), precision=PREC)
        return SVDResult(U=np.asarray(Uk), d=s[:k].astype(np.float32),
                         V=np.asarray(Vk), k_selected=k, converged=True,
                         iterations=steps, center=c_np)

    if method == "irlba":
        kk = min(k, min(m, n) - 1) if min(m, n) > 1 else 1
        wrk = min(min(m, n), (work if work > 0 else kk + 7))
        max_restarts = maxit if maxit > 0 else 100

        def gkb(U, V, alphas, betas, start, v_next):
            return _stream_gkb(op, U, V, alphas, betas, start, v_next, wrk)

        res = _irlba_core(op, gkb, m, n, kk, wrk, max_restarts, tol, seed)
        res.center = c_np
        return res

    if method == "krylov":
        l1u, l1v = pair(L1)
        l2u, l2v = pair(L2)
        nnu, nnv = pair(nonneg)
        ubu, ubv = pair(upper_bound)
        seed_res = streaming_svd(loader, k, method="lanczos", center=center,
                                 seed=seed, tol=tol)
        if not (nnu or nnv or l1u > 0 or l1v > 0 or l2u > 0 or l2v > 0):
            return seed_res
        max_passes = maxit if maxit > 0 else max(
            10, 2 * int(math.ceil(math.log2(max(k, 2)))) + 3)
        half = partial(jax.jit, static_argnames=(
            "L1", "L2", "nonneg", "upper_bound"))(
            lambda F, B, L1, L2, nonneg, upper_bound:
            _kspr_half(F, B, L1, L2, nonneg, upper_bound))
        W = jnp.asarray(np.abs(seed_res.U) if nnu else seed_res.U)
        V = jnp.asarray(np.abs(seed_res.V) if nnv else seed_res.V)
        d = jnp.asarray(seed_res.d)
        passes = 0
        converged = False
        prev_W = None
        for passes in range(1, max_passes + 1):
            W, d = half(V, op.mm(V), L1=float(l1u), L2=float(l2u),
                        nonneg=bool(nnu), upper_bound=float(ubu))
            V, d = half(W, op.rmm(W), L1=float(l1v), L2=float(l2v),
                        nonneg=bool(nnv), upper_bound=float(ubv))
            if prev_W is not None:
                dW = float(jnp.linalg.norm(W - prev_W) /
                           (jnp.linalg.norm(prev_W) + 1e-30))
                if dW < tol:
                    converged = True
                    break
            prev_W = W
        order = np.argsort(-np.asarray(d), kind="stable")
        return SVDResult(U=np.asarray(W)[:, order], d=np.asarray(d)[order],
                         V=np.asarray(V)[:, order], k_selected=k,
                         converged=converged, iterations=passes, center=c_np)

    if method == "deflation":
        return _stream_deflation(op, k, seed=seed, tol=tol, maxit=maxit,
                                 nonneg=pair(nonneg), L1=pair(L1),
                                 L2=pair(L2), upper_bound=pair(upper_bound),
                                 robust=robust, center=c_np)

    raise ValueError(f"streaming SVD supports 'randomized', 'lanczos', "
                     f"'irlba', 'krylov', 'deflation'; got {method!r}")


def _stream_deflation(op, k_max, *, seed, tol, maxit, nonneg, L1, L2,
                      upper_bound, robust, center) -> SVDResult:
    """Streaming rank-1 ALS deflation (svd/deflation.hpp over
    streaming_matvec.hpp): every access to A is one chunked matvec; the
    deflation correction uses the stored small factors.  Supports the
    elementwise constraints and robust Huber IRLS; no speckled CV (the
    holdout is an in-memory concept here — use the in-memory path)."""
    m, n = op.shape
    k_max = min(k_max, min(m, n))
    max_iter = maxit if maxit > 0 else 100
    tol = tol if tol > 0 else 1e-5
    if isinstance(robust, bool):
        robust_delta = 1.345 if robust else 0.0
    elif robust == "mae":
        # MAE = Huber with a vanishing quadratic zone (R/nmf_thin.R:341-353)
        robust_delta = 1e-4
    else:
        robust_delta = float(robust)
    do_robust = robust_delta > 0

    def huber_w(resid):
        ar = jnp.abs(resid)
        mad = jnp.sort(ar)[ar.shape[0] // 2]
        scale = jnp.where(mad / 0.6745 < np.float32(1.2e-5), 1.0,
                          mad / 0.6745)
        z = ar / scale
        return jnp.where(z <= robust_delta, 1.0,
                         robust_delta / jnp.maximum(z, 1e-30))

    U_all = jnp.zeros((m, k_max), jnp.float32)
    V_all = jnp.zeros((n, k_max), jnp.float32)
    d_all = jnp.zeros((k_max,), jnp.float32)
    iters_total = 0
    rng_state = {"offset": 0}
    seed_i = seed if seed else 42

    def rand_u():
        u = rng_mod.fill_uniform(seed_i, m, 1,
                                 offset=rng_state["offset"])[:, 0]
        rng_state["offset"] += m
        return jnp.asarray(u.astype(np.float32))

    def defl_f(x, kk):      # A x - U d V^T x on the deflated operator
        return op.mv(x) - jnp.dot(U_all * d_all[None, :],
                                  jnp.dot(V_all.T, x, precision=PREC),
                                  precision=PREC) if kk else op.mv(x)

    def defl_t(x, kk):
        return op.rmv(x) - jnp.dot(V_all * d_all[None, :],
                                   jnp.dot(U_all.T, x, precision=PREC),
                                   precision=PREC) if kk else op.rmv(x)

    d_np = np.zeros((k_max,), np.float32)
    for kk in range(k_max):
        # fresh sequential random draw per factor, matching the in-memory
        # deflation_svd (seeding from the previous factor and then
        # orthogonalizing against it is self-cancelling — round-2 review #8)
        u = rand_u()
        if kk > 0:
            u = u - jnp.dot(U_all, jnp.dot(U_all.T, u, precision=PREC),
                            precision=PREC)
        u = u / jnp.maximum(jnp.sqrt(jnp.sum(u * u)), 1e-30)
        tol_k = tol
        if kk > 0 and d_np[0] > 0 and d_np[kk - 1] > 0:
            tol_k = min(tol * d_np[0] / d_np[kk - 1], tol * 100)

        v = jnp.zeros((n,), jnp.float32)
        u_prev = u
        sigma = 0.0
        it = 0
        for it in range(max_iter):
            beta = 0.0 if do_robust else (
                (it - 1.0) / (it + 2.0) if it > 1 else 0.0)
            u_hat = u + beta * (u - u_prev)
            u_prev = u
            if do_robust and it > 0:
                rw = huber_w(defl_f(v, kk) - sigma * u)
                cw = huber_w(defl_t(u, kk) - sigma * v)
                wu = u_hat * rw
                w = defl_t(wu, kk)
                u_sq_w = float(jnp.sum(wu * u_hat))
            else:
                w = defl_t(u_hat, kk)
                u_sq_w = float(jnp.sum(u_hat * u_hat))
            v = w / max(u_sq_w, 1e-30)
            u_sq = float(jnp.sum(u_hat * u_hat))
            v = _apply_reg_vec(v, L1[1], L2[1], nonneg[1], upper_bound[1],
                               u_sq, 0.0)
            sv = float(jnp.sqrt(jnp.sum(v * v)))
            if sv <= 0:
                break
            v = v / sv
            if do_robust and it > 0:
                wv = v * cw
                w2 = defl_f(wv, kk)
                v_sq_w = float(jnp.sum(wv * v))
            else:
                w2 = defl_f(v, kk)
                v_sq_w = float(jnp.sum(v * v))
            u = w2 / max(v_sq_w, 1e-30)
            v_sq = float(jnp.sum(v * v))
            u = _apply_reg_vec(u, L1[0], L2[0], nonneg[0], upper_bound[0],
                               v_sq, 0.0)
            sigma = float(jnp.sqrt(jnp.sum(u * u)))
            if sigma <= 0:
                break
            u = u / sigma
            cd = 1.0 - abs(float(jnp.sum(u * u_prev)))
            if cd < tol_k:
                it += 1
                break
        iters_total += it

        constrained = (nonneg[0] or nonneg[1] or L1[0] > 0 or L1[1] > 0 or
                       L2[0] > 0 or L2[1] > 0 or
                       upper_bound[0] > 0 or upper_bound[1] > 0)
        if kk > 0 and not constrained:
            for _ in range(2):
                u = u - jnp.dot(U_all, jnp.dot(U_all.T, u, precision=PREC),
                                precision=PREC)
                v = v - jnp.dot(V_all, jnp.dot(V_all.T, v, precision=PREC),
                                precision=PREC)
            u = u / jnp.maximum(jnp.sqrt(jnp.sum(u * u)), 1e-30)
            v = v / jnp.maximum(jnp.sqrt(jnp.sum(v * v)), 1e-30)
        sigma = abs(float(jnp.dot(u, defl_f(v, kk), precision=PREC)))
        U_all = U_all.at[:, kk].set(u)
        V_all = V_all.at[:, kk].set(v)
        d_all = d_all.at[kk].set(sigma)
        d_np[kk] = sigma

    return SVDResult(U=np.asarray(U_all), d=d_np, V=np.asarray(V_all),
                     k_selected=k_max, converged=True,
                     iterations=iters_total, center=center)
