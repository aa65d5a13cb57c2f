"""IRLS-distribution NMF: GP / NB / Gamma / InvGauss / Tweedie / robust.

JAX re-architecture of the reference's IRLS machinery:

  * per-column weighted NNLS (primitives/cpu/nnls_batch_irls.hpp) becomes a
    column-blocked batched solve: elementwise weight pass -> per-column
    weighted Gram via one batched matmul -> batched CD solve with one Gram
    per lane;
  * GP theta MM update (nmf/fit_cpu.hpp:914-1086, Ohashi et al. 2025 Eq. 24,
    5 inner MM iterations), NB size MoM (fit_cpu.hpp:1094-1265), ZI EM with
    soft imputation (fit_cpu.hpp:1285-1552), Gamma/IG/Tweedie Pearson phi
    (fit_cpu.hpp:1561-1672) — all masked reductions over the dense residual
    field, fused by XLA.

Key fitting strategy preserved from the reference: GP W/H updates use KL
weights (same fixed point, stable), theta estimated separately
(fit_cpu.hpp:569-575).  Sparse-input semantics (zeros get unit weight —
the sparse-Gram trick, nnls_batch_irls.hpp:176-186) are honored via
``cfg.treat_as_sparse``-style masking on the dense representation.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from .. import backend
from ..config import Dispersion, Loss, NMFConfig, ZI
from ..ops import features as feat
from ..ops import linalg, losses, solvers
from ..ops.linalg import PREC
from ..result import NMFResult
from .nmf import FitState, finalize_result


class IRLSState(NamedTuple):
    W_T: jax.Array
    H: jax.Array
    d: jax.Array
    disp_row: jax.Array       # theta / r / phi indexed by rows of A (m,)
    disp_col: jax.Array       # same indexed by columns (n,) (PER_COL mode)
    pi_row: jax.Array         # (m,) ZI dropout
    pi_col: jax.Array         # (n,)
    A_imp: jax.Array          # (m, n) soft-imputed data (== A when no ZI)
    it: jax.Array
    prev_loss: jax.Array
    patience_ctr: jax.Array
    converged: jax.Array
    final_tol: jax.Array
    loss_hist: jax.Array


def _block_count(n: int, k: int, m: int, budget_floats: float = 1.2e8,
                 kr: bool = False) -> int:
    """Column block size for the weighted-Gram solve: bound the (BC, k, m)
    intermediate to ~budget floats.  With the Khatri-Rao Gram path (``kr``)
    that intermediate does not exist, but each block still materializes the
    (m, BC) data slice AND the (m, BC) weight block plus the (BC, k^2) Gram
    output — the per-column footprint is ~2m + 2k^2 floats, all of which
    must count or fits near the HBM limit OOM."""
    if kr:
        bc = max(8, int(budget_floats / max(2 * m + 2 * k * k, 1)))
    else:
        bc = max(8, int(budget_floats / max(k * m, 1)))
    return min(bc, n)


def _use_kr(k: int, m: int) -> bool:
    """Whether the Khatri-Rao Gram formulation applies (accelerator, operand
    fits)."""
    from ..ops.linalg import KR_BUDGET_FLOATS
    return backend.on_accelerator() and k * k * m <= KR_BUDGET_FLOATS


def _pad_cols(X, bc):
    n = X.shape[-1]
    pad = (-n) % bc
    if pad:
        X = jnp.pad(X, [(0, 0)] * (X.ndim - 1) + [(0, pad)])
    return X, pad


def irls_solve_batch(A_data, F, cfg: NMFConfig, active_loss: Loss,
                     theta_row, theta_col, fc, sparse_zeros: bool,
                     extra_w=None, X_warm=None, G_add=None, target=None):
    """Solve min over X>=0 of the weighted LS for every column of A_data.

    A_data (m, nc) data panel; F (k, m) fixed factor.  Returns X (k, nc).
    Mirrors nnls_batch_irls_{sparse,dense} semantics — the IRLS loop
    reweights -> solves -> converges on per-column relative max change <
    irls_tol (nnls_batch_irls.hpp:320-328) — with one improvement:
    ``X_warm`` (the previous ALS iteration's factor) seeds the loop instead
    of the reference's zero reset, so the first reweighting already uses
    real predictions and the CD solves start warm (same fixed point, far
    fewer sweeps).

    ``G_add``: optional shared k x k tier-2 term (graph reg + L21) added to
    every per-column weighted Gram (cv_detail.hpp:168,272 semantics; the
    reference's non-CV IRLS drops these — we apply them uniformly).
    ``target``: optional (k, nc) enrichment target, fc.target_lambda > 0.
    """
    k, m = F.shape
    n = A_data.shape[1]
    dtype = A_data.dtype
    wcfg = cfg.replace(loss=active_loss)

    use_kr = _use_kr(k, m)
    KR = linalg.kr_product(F) if use_kr else None
    bc = _block_count(n, k, m, kr=use_kr)
    A_pad, pad = _pad_cols(A_data, bc)
    W_pad = _pad_cols(extra_w, bc)[0] if extra_w is not None else None
    Xw_pad = _pad_cols(X_warm, bc)[0] if X_warm is not None else None
    T_pad = _pad_cols(target, bc)[0] if target is not None else None
    th_col = theta_col
    if th_col is None:
        th_col_pad = None
    else:
        th_col_pad, _ = _pad_cols(th_col[None, :], bc)
        th_col_pad = th_col_pad[0]
    nblocks = A_pad.shape[1] // bc

    G_base = linalg.gram(F) if sparse_zeros else None

    # Accelerator field dtype: every (m, bc) intermediate the inner loop
    # touches (mu, w, w*A) lives in bf16 -- the loop streams these fields
    # (a KL or NB fit on an H100 at 700 W runs ~1.4x faster than with fp32
    # fields).  This keeps the objective (a KL fit's loss within ~1e-3 of
    # the fp32 fit).  Single factor entries move far more, as they do in
    # fp32 under any other summation order: the IRLS fit amplifies
    # rounding.  Gram/RHS accumulation stays fp32 (weighted_gram_and_rhs
    # contract), as do X, the CD solve, and the convergence test.  CPU keeps
    # fp32 throughout.
    fdt = jnp.bfloat16 if backend.on_accelerator() else dtype
    F_f = F.astype(fdt)

    def solve_block(blk_idx):
        A_blk = lax.dynamic_slice_in_dim(A_pad, blk_idx * bc, bc, axis=1)
        if th_col_pad is not None:
            th_blk = lax.dynamic_slice_in_dim(th_col_pad, blk_idx * bc, bc)
            theta = jnp.broadcast_to(th_blk[None, :], (m, bc))
        elif theta_row is not None:
            theta = jnp.broadcast_to(theta_row[:, None], (m, bc))
        else:
            theta = jnp.zeros((m, bc), dtype)
        theta_f = theta.astype(fdt)

        nz = A_blk != 0
        A_f = A_blk.astype(fdt)          # hoisted: one cast per block
        # loop-invariant: slice the extra-weight panel ONCE per block —
        # XLA does not reliably hoist dynamic slices out of while loops
        w_extra = (lax.dynamic_slice_in_dim(W_pad, blk_idx * bc, bc, axis=1)
                   .astype(fdt) if W_pad is not None else None)

        def irls_iter(carry):
            X, active, itr = carry
            mu = jnp.dot(F_f.T, X.astype(fdt), precision=PREC,
                         preferred_element_type=fdt)                # (m, bc)
            w = losses.compute_irls_weight(A_f, mu, wcfg, theta_f)
            if sparse_zeros:
                w = jnp.where(nz, w, jnp.asarray(1.0, fdt))
            if w_extra is not None:
                w = w * w_extra
            # per-column weighted Gram + RHS (bf16-in/f32-accum on an
            # accelerator; KR precomputed once per solve, linalg.kr_product).
            Gb, b = linalg.weighted_gram_and_rhs(F, w, A_f, KR=KR)
            if fc.L2 > 0:
                Gb = Gb + fc.L2 * jnp.eye(k, dtype=dtype)[None]
            if G_add is not None:
                Gb = Gb + G_add[None]
            if T_pad is not None:
                Gb = Gb + fc.target_lambda * jnp.eye(k, dtype=dtype)[None]
                b = b + fc.target_lambda * lax.dynamic_slice_in_dim(
                    T_pad, blk_idx * bc, bc, axis=1)

            X_old = X
            B_res = b - solvers.batched_gram_matvec(Gb, X)
            X_new = solvers.cd_nnls_batched_gram(
                Gb, B_res, X, fc.L1, nonneg=fc.nonneg,
                maxit=cfg.cd_max_iter, cd_tol=cfg.cd_tol)
            X = jnp.where(active[None, :], X_new, X_old)
            rel = jnp.max(jnp.abs(X - X_old) / (jnp.abs(X_old) + 1e-12), axis=0)
            active = active & (rel >= cfg.irls_tol)
            return X, active, itr + 1

        def cond(carry):
            return (carry[2] < cfg.irls_max_iter) & jnp.any(carry[1])

        if Xw_pad is not None:
            X0 = lax.dynamic_slice_in_dim(Xw_pad, blk_idx * bc, bc, axis=1)
        else:
            X0 = jnp.zeros((k, bc), dtype)
        X, _, _ = lax.while_loop(cond, irls_iter,
                                 (X0, jnp.ones((bc,), bool), jnp.int32(0)))
        return X

    X_blocks = lax.map(solve_block, jnp.arange(nblocks))   # (nblocks, k, bc)
    X = jnp.transpose(X_blocks, (1, 0, 2)).reshape(k, nblocks * bc)
    return X[:, :n]


# ---------------------------------------------------------------------------
# Dispersion updates
# ---------------------------------------------------------------------------

def gp_theta_update(A, S, theta, cfg: NMFConfig, axis: int):
    """MM theta update (fit_cpu.hpp:914-1086; Ohashi et al. 2025 Eq. 24).

    ``axis`` = 1 for per-row (reduce over columns), 0 for per-col.
    S = max(W_Td^T H, 1e-10) reconstruction.
    """
    red = axis
    sum_y = jnp.sum(A, axis=red)
    sum_s = jnp.sum(S, axis=red)
    nz = A >= 1.0
    n_nz = jnp.sum(nz, axis=red).astype(A.dtype)
    cap = cfg.theta_max

    def expand(v):
        return v[:, None] if red == 1 else v[None, :]

    def mm_iter(_, th):
        denom = jnp.maximum(S + expand(th) * A, 1e-10)
        eta1 = S / denom
        alpha_d = jnp.sum(jnp.where(nz, (A - 1.0) * eta1, 0.0), axis=red)
        gamma_d = jnp.sum(jnp.where(nz, (A - 1.0) * (1.0 - eta1), 0.0), axis=red)
        alpha = alpha_d + n_nz
        beta = (sum_y - sum_s) - gamma_d + alpha
        disc = beta * beta + 4.0 * alpha * gamma_d
        ok = (alpha > 1e-15) & (disc > 0) & jnp.isfinite(disc)
        new_th = (-beta + jnp.sqrt(jnp.maximum(disc, 0.0))) / jnp.maximum(2.0 * alpha, 1e-30)
        ok = ok & jnp.isfinite(new_th) & (new_th >= 0)
        return jnp.where(ok, jnp.minimum(new_th, cap), th)

    theta = lax.fori_loop(0, 5, mm_iter, theta)   # THETA_INNER_ITERS = 5
    if cfg.dispersion == Dispersion.GLOBAL:
        theta = jnp.full_like(theta, jnp.mean(theta))
    return theta


def nb_size_update(A, S, cfg: NMFConfig, axis: int):
    """NB size MoM: r = sum mu^2 / max(sum[(y-mu)^2 - mu], eps)
    (fit_cpu.hpp:1094-1265).  GLOBAL mode takes the median."""
    red = axis
    mu = jnp.maximum(S, 1e-10)
    resid = A - mu
    sum_mu_sq = jnp.sum(mu * mu, axis=red)
    sum_excess = jnp.sum(resid * resid - mu, axis=red)
    r_new = sum_mu_sq / jnp.maximum(sum_excess, 1e-30)
    r_new = jnp.clip(r_new, cfg.nb_size_min, cfg.nb_size_max)
    ok = (sum_excess > 1e-10) & (sum_mu_sq > 1e-10) & jnp.isfinite(r_new)
    r = jnp.where(ok, r_new, cfg.nb_size_max)
    if cfg.dispersion == Dispersion.GLOBAL:
        r = jnp.full_like(r, jnp.median(r))
    return r


def phi_update(A, S, cfg: NMFConfig, axis: int):
    """Pearson MoM dispersion for Gamma/IG/Tweedie (fit_cpu.hpp:1561-1672).
    Only entries with y > 0 contribute."""
    red = axis
    p = (2.0 if cfg.loss == Loss.GAMMA
         else 3.0 if cfg.loss == Loss.INVGAUSS
         else cfg.tweedie_power)
    mu = jnp.maximum(S, 1e-10)
    pos = A > 0
    v_mu = jnp.maximum(mu ** p, 1e-20)
    pear = jnp.where(pos, (A - mu) ** 2 / v_mu, 0.0)
    cnt = jnp.sum(pos, axis=red).astype(A.dtype)
    phi_new = jnp.sum(pear, axis=red) / jnp.maximum(cnt, 1.0)
    phi_new = jnp.clip(phi_new, cfg.gamma_phi_min, cfg.gamma_phi_max)
    phi = jnp.where((cnt > 0) & jnp.isfinite(phi_new), phi_new, 1.0)
    if cfg.dispersion == Dispersion.GLOBAL:
        phi = jnp.full_like(phi, jnp.median(phi))
    return phi


def zi_em_step(A, S, cfg: NMFConfig, disp_row, pi_row, pi_col, valid=None,
               disp_col=None):
    """ZI E/M-step + soft imputation (fit_cpu.hpp:1285-1552).

    Returns (pi_row, pi_col, A_imputed).  zero entries of A get imputed with
    z_ij * mu_ij; real structure stays.  ``valid``: optional (m, n) bool —
    mesh-padding / unobserved entries excluded from zero counts and pi
    denominators (used by the CV path, which runs on the padded matrix
    directly).  ``disp_col``: pass the fitted per-column dispersion when
    dispersion='per_col' — otherwise the dropout prior p0 would be
    computed from the never-updated row-dispersion init."""
    m, n = A.shape
    is_zero = A == 0
    if valid is not None:
        is_zero = is_zero & valid
    s = jnp.maximum(S, 1e-10)
    disp = (disp_col[None, :] if disp_col is not None
            else disp_row[:, None])
    if cfg.loss == Loss.NB:
        r = jnp.maximum(disp, 1e-10)
        p0 = (r / (r + s)) ** r
    else:  # GP
        p0 = jnp.exp(-s / (1.0 + disp))

    if cfg.zi == ZI.ROW:
        pi = pi_row[:, None]
    else:
        pi = pi_col[None, :]
    z = pi / (pi + (1.0 - pi) * p0 + 1e-30)
    z = jnp.where(is_zero, z, 0.0)

    if cfg.zi == ZI.ROW:
        zero_cnt = jnp.sum(is_zero, axis=1)
        denom = (jnp.maximum(jnp.sum(valid, axis=1), 1)
                 if valid is not None else n)
        new_pi = jnp.clip(jnp.sum(z, axis=1) / denom, 0.001, 0.999)
        pi_row = jnp.where(zero_cnt > 0, new_pi, pi_row)
    else:
        zero_cnt = jnp.sum(is_zero, axis=0)
        denom = (jnp.maximum(jnp.sum(valid, axis=0), 1)
                 if valid is not None else m)
        new_pi = jnp.clip(jnp.sum(z, axis=0) / denom, 0.001, 0.999)
        pi_col = jnp.where(zero_cnt > 0, new_pi, pi_col)

    A_imp = jnp.where(is_zero, z * s, A)
    return pi_row, pi_col, A_imp


# ---------------------------------------------------------------------------
# Main IRLS ALS loop
# ---------------------------------------------------------------------------

def _init_dispersion(cfg: NMFConfig, m: int, n: int, dtype):
    """Initial dispersion vectors (fit_cpu.hpp:289-347)."""
    loss = cfg.loss
    if loss == Loss.GP:
        init = cfg.theta_init if cfg.dispersion != Dispersion.NONE else 0.0
    elif loss == Loss.NB:
        init = (cfg.nb_size_init if cfg.dispersion != Dispersion.NONE
                else cfg.nb_size_max)
    elif loss in (Loss.GAMMA, Loss.INVGAUSS, Loss.TWEEDIE):
        init = cfg.gamma_phi_init if cfg.dispersion != Dispersion.NONE else 1.0
    else:
        init = 0.0
    row = np.full((m,), init, dtype)
    col = np.full((n,), init, dtype)
    return row, col


def _zi_pi_init(A, cfg: NMFConfig, valid=None):
    """Data-driven pi init: min(zero_rate * 0.5, 0.3) (fit_cpu.hpp:355-400).

    jnp ops so a device-resident A stays on device (no pull to the
    host); numpy inputs work identically.
    ``valid``: optional (m, n) bool — mesh-padding / unobserved entries
    leave the zero-rate numerator AND denominator (a padded matrix would
    otherwise overstate every real row/column's zero rate)."""
    m, n = A.shape
    pi_row = jnp.zeros((m,), jnp.float32)
    pi_col = jnp.zeros((n,), jnp.float32)
    nzm = (jnp.asarray(A) != 0).astype(jnp.float32)
    if valid is not None:
        v = valid.astype(jnp.float32)
        nzm = nzm * v
    if cfg.zi == ZI.ROW:
        denom = (jnp.maximum(jnp.sum(v, axis=1), 1.0) if valid is not None
                 else float(n))
        zr = 1.0 - jnp.sum(nzm, axis=1) / denom
        pi_row = jnp.minimum(zr * 0.5, 0.3).astype(jnp.float32)
    elif cfg.zi == ZI.COL:
        denom = (jnp.maximum(jnp.sum(v, axis=0), 1.0) if valid is not None
                 else float(m))
        zr = 1.0 - jnp.sum(nzm, axis=0) / denom
        pi_col = jnp.minimum(zr * 0.5, 0.3).astype(jnp.float32)
    return pi_row, pi_col


def _init_irls_state(A_dev, cfg: NMFConfig, W_T0, H0, d0,
                     valid_dims=None) -> IRLSState:
    """Build the initial device-resident IRLSState (dispersion + ZI priors).

    Shared by the whole-fit driver and the segmented (checkpointing)
    driver so both start from identical state."""
    m, n = A_dev.shape
    disp_row0, disp_col0 = _init_dispersion(cfg, m, n, np.float32)
    if cfg.has_zi():
        vmask = None
        if valid_dims is not None:
            vm0, vn0 = valid_dims
            vmask = (jnp.arange(m)[:, None] < vm0) & \
                    (jnp.arange(n)[None, :] < vn0)
        pi_row0, pi_col0 = _zi_pi_init(A_dev, cfg, valid=vmask)
    else:
        pi_row0 = np.zeros((m,), np.float32)
        pi_col0 = np.zeros((n,), np.float32)
    dtype = A_dev.dtype
    return IRLSState(
        W_T=jnp.asarray(W_T0), H=jnp.asarray(H0), d=jnp.asarray(d0),
        disp_row=jnp.asarray(disp_row0), disp_col=jnp.asarray(disp_col0),
        pi_row=jnp.asarray(pi_row0), pi_col=jnp.asarray(pi_col0),
        A_imp=A_dev,
        it=jnp.int32(0),
        prev_loss=jnp.asarray(jnp.finfo(dtype).max, dtype),
        patience_ctr=jnp.int32(0),
        converged=jnp.bool_(False),
        final_tol=jnp.asarray(jnp.nan, dtype),
        loss_hist=jnp.full((cfg.max_iter,), jnp.nan, dtype),
    )


@partial(jax.jit, static_argnames=("cfg", "sparse_zeros", "valid_dims"))
def _fit_irls_jit(cfg: NMFConfig, A, aux, init: IRLSState,
                  sparse_zeros: bool, valid_dims=None, seg_end=None):
    """Run the fused IRLS while-loop from ``init`` up to
    ``min(seg_end, cfg.max_iter)`` iterations.  ``seg_end`` is a TRACED
    bound (None -> max_iter), so the checkpointing driver reuses one
    compiled executable across segments (same design as nmf._fit_mse_seg)."""
    dtype = A.dtype
    m, n = A.shape
    # mesh-padding support: accounting (loss, dispersion, ZI) runs on the
    # statically sliced (vm, vn) true region so padded zeros never bias
    # NLLs, moment sums, or zero counts; the solves stay on padded shapes
    # (padded factors solve to exact zeros — parallel/mesh.py)
    vm, vn = valid_dims if valid_dims is not None else (m, n)
    padded = (vm != m) or (vn != n)

    def _t(X):
        return X[:vm, :vn] if padded else X
    max_iter = cfg.max_iter
    is_gp = cfg.loss == Loss.GP
    is_nb = cfg.loss == Loss.NB
    is_phi = cfg.loss in (Loss.GAMMA, Loss.INVGAUSS, Loss.TWEEDIE)
    per_col = cfg.dispersion == Dispersion.PER_COL
    has_disp = cfg.dispersion != Dispersion.NONE
    is_zi = cfg.has_zi()

    # GP strategy: W/H updates use KL weights; theta estimated separately
    # (fit_cpu.hpp:569-575).  NB uses NB weights directly.
    active_loss = Loss.KL if is_gp else cfg.loss

    def body(state: IRLSState) -> IRLSState:
        W_T, H, d, it = state.W_T, state.H, state.d, state.it
        disp_row, disp_col = state.disp_row, state.disp_col

        # data the solver sees: imputed from iter >= 1 when ZI active
        A_solve = state.A_imp if is_zi else A

        # NB theta plumbing for solves (fit_cpu.hpp:595-612)
        th_row = disp_row if (is_nb and not per_col) else None
        th_col = disp_col if (is_nb and per_col) else None

        # --- H update (warm-started from the previous iteration's H) ---
        warm_gate = (it > 0).astype(A.dtype)
        tgt_h = aux.get("target_H")
        if tgt_h is not None and cfg.H.target_lambda <= 0:
            tgt_h = None
        H_new = irls_solve_batch(A_solve, W_T, cfg, active_loss,
                                 th_row, th_col, cfg.H,
                                 sparse_zeros and not is_zi,
                                 X_warm=H * warm_gate,
                                 G_add=feat.tier2_gram_addition(
                                     H, cfg.H, aux.get("graph_H")),
                                 target=tgt_h)
        if cfg.H.upper_bound > 0:
            H_new = feat.apply_upper_bound(H_new, cfg.H.upper_bound)
        if cfg.H.angular > 0:
            H_new = feat.apply_angular_posthoc(H_new, cfg.H.angular)
        H, d = linalg.extract_scaling(H_new, cfg.norm)

        # --- W update (on A^T; theta roles swap: fit_cpu.hpp:821-833) ---
        th_row_w = disp_col if (is_nb and per_col) else None
        th_col_w = disp_row if (is_nb and not per_col) else None
        tgt_w = aux.get("target_W")
        if tgt_w is not None and cfg.W.target_lambda <= 0:
            tgt_w = None
        W_new = irls_solve_batch(A_solve.T, H, cfg, active_loss,
                                 th_row_w, th_col_w, cfg.W,
                                 sparse_zeros and not is_zi,
                                 X_warm=W_T * warm_gate,
                                 G_add=feat.tier2_gram_addition(
                                     W_T, cfg.W, aux.get("graph_W")),
                                 target=tgt_w)
        if cfg.W.upper_bound > 0:
            W_new = feat.apply_upper_bound(W_new, cfg.W.upper_bound)
        if cfg.W.angular > 0:
            W_new = feat.apply_angular_posthoc(W_new, cfg.W.angular)
        W_T, d = linalg.extract_scaling(W_new, cfg.norm)

        # --- dispersion updates on reconstruction S (fit_cpu.hpp:914-1672) ---
        W_Td = W_T * d[:, None]
        S = jnp.maximum(jnp.dot(W_Td.T, H, precision=PREC), 1e-10)
        A_t, S_t = _t(A), _t(S)

        def _pad_row(v):
            return jnp.pad(v, (0, m - vm), mode="edge") if padded else v

        def _pad_col(v):
            return jnp.pad(v, (0, n - vn), mode="edge") if padded else v

        if has_disp:
            if is_gp:
                if per_col:
                    disp_col = _pad_col(gp_theta_update(
                        A_t, S_t, disp_col[:vn], cfg, axis=0))
                else:
                    disp_row = _pad_row(gp_theta_update(
                        A_t, S_t, disp_row[:vm], cfg, axis=1))
            elif is_nb:
                if per_col:
                    disp_col = _pad_col(nb_size_update(A_t, S_t, cfg, axis=0))
                else:
                    disp_row = _pad_row(nb_size_update(A_t, S_t, cfg, axis=1))
            elif is_phi:
                if per_col:
                    disp_col = _pad_col(phi_update(A_t, S_t, cfg, axis=0))
                else:
                    disp_row = _pad_row(phi_update(A_t, S_t, cfg, axis=1))

        # --- ZI EM + soft imputation (fit_cpu.hpp:1285-1552) ---
        pi_row, pi_col, A_imp = state.pi_row, state.pi_col, state.A_imp
        if is_zi:
            pr, pc = pi_row[:vm], pi_col[:vn]
            for _ in range(max(1, cfg.zi_em_iters)):   # static unroll
                pr, pc, A_imp_t = zi_em_step(
                    A_t, S_t, cfg, disp_row[:vm], pr, pc,
                    disp_col=disp_col[:vn] if per_col else None)
            pi_row, pi_col = _pad_row(pr), _pad_col(pc)
            A_imp = (jnp.pad(A_imp_t, ((0, m - vm), (0, n - vn)))
                     if padded else A_imp_t)
            if cfg.theta_min > 0 and is_gp:
                disp_row = jnp.maximum(disp_row, cfg.theta_min)
                disp_col = jnp.maximum(disp_col, cfg.theta_min)

        # --- explicit loss on original A (fit_cpu.hpp:1690-1709) ---
        theta_for_loss_row = disp_col if per_col else disp_row
        loss = losses.explicit_loss(
            A_t, W_Td[:, :vm] if padded else W_Td,
            H[:, :vn] if padded else H, cfg,
            theta_row=None if per_col else theta_for_loss_row[:vm],
            theta_col=disp_col[:vn] if per_col else None,
            nz_only=sparse_zeros)

        rel = jnp.abs(state.prev_loss - loss) / (jnp.abs(state.prev_loss) + 1e-15)
        loss_conv = (it > 0) & (rel < cfg.tol)
        patience_ctr = jnp.where(loss_conv, state.patience_ctr + 1, 0)
        converged = patience_ctr >= cfg.patience
        final_tol = jnp.where(it > 0, rel, state.final_tol)
        loss_hist = state.loss_hist.at[it].set(loss)

        return IRLSState(W_T, H, d, disp_row, disp_col, pi_row, pi_col,
                         A_imp, it + 1, loss, patience_ctr, converged,
                         final_tol, loss_hist)

    bound = (jnp.int32(max_iter) if seg_end is None
             else jnp.minimum(jnp.int32(seg_end), jnp.int32(max_iter)))

    def cond(state: IRLSState):
        return (state.it < bound) & jnp.logical_not(state.converged)

    return lax.while_loop(cond, body, init)


def fit_irls(A_dev, cfg: NMFConfig, W_T0, H0, d0, aux,
             sparse_zeros: bool = False, valid_dims=None) -> NMFResult:
    """Host driver for the IRLS path (dispatched from models.nmf.nmf_fit).

    ``valid_dims``: true (m, n) when A arrives zero-padded for a device
    mesh — accounting is restricted to the valid region."""
    aux_dev = {key: jnp.asarray(val, jnp.float32)
               for key, val in (aux or {}).items()
               if val is not None and not key.endswith("_gram")}
    init = _init_irls_state(A_dev, cfg, W_T0, H0, d0, valid_dims=valid_dims)
    if cfg.enable_profiling:
        # production-loop profiling, IRLS flavor: the SAME fused loop in
        # segments via the checkpointing kernel (bitwise trajectory),
        # timed per segment.  Coarser than the MSE path's section map —
        # the IRLS iteration is one fused solve+dispersion+ZI block — but
        # never silently dropped (profile=True previously returned an
        # empty map on IRLS losses).
        import time as _time
        scfg = cfg.device_static()
        seg = max(1, min(32, cfg.max_iter // 8 or 1))
        it = 0
        converged = False
        seg_times = []
        state = init
        t0_all = _time.perf_counter()
        while it < cfg.max_iter and not converged:
            seg_end = min(it + seg, cfg.max_iter)
            t0 = _time.perf_counter()
            state = _fit_irls_jit(scfg, A_dev, aux_dev, state, sparse_zeros,
                                  valid_dims=valid_dims,
                                  seg_end=jnp.int32(seg_end))
            new_it, conv = jax.device_get((state.it, state.converged))
            dt = _time.perf_counter() - t0
            if int(new_it) > it:
                seg_times.append((int(new_it) - it, dt))
            it = int(new_it)
            converged = bool(conv)
        prof = {
            "irls_iteration": min((t / k for k, t in seg_times),
                                  default=0.0) * 1e3 * it,
            "fused_total_ms": (_time.perf_counter() - t0_all) * 1e3,
            "fused_per_iter_us": min((t / k for k, t in seg_times),
                                     default=0.0) * 1e6,
            "iterations": it,
            "mode": "fused-segmented",
            "section_basis": "one fused IRLS block per iteration (solves "
                             "+ dispersion + ZI are a single executable); "
                             "best-segment steady state",
        }
        res = finalize_irls_result(cfg, state)
        res.profile = prof
        return res
    state = _fit_irls_jit(cfg.device_static(), A_dev, aux_dev, init,
                          sparse_zeros, valid_dims=valid_dims)
    return finalize_irls_result(cfg, state)


def finalize_irls_result(cfg: NMFConfig, state: IRLSState) -> NMFResult:
    """Transfer the final IRLSState (minus A_imp) and package an NMFResult.

    Shared by ``fit_irls`` and the segmented checkpointing driver."""
    # selective transfer: everything EXCEPT A_imp — the (m, n) imputed
    # matrix is a loop-internal buffer as large as A itself
    state = state._replace(A_imp=jnp.zeros((), jnp.float32))
    state = jax.device_get(state)   # one batched transfer

    per_col = cfg.dispersion == Dispersion.PER_COL
    extra = {}
    disp = np.asarray(state.disp_col if per_col else state.disp_row)
    # dispersion='none' estimates nothing and returns nothing
    # (test_distribution_api.R:181-195, test_gp_nmf.R:124-133)
    if cfg.dispersion == Dispersion.NONE:
        pass
    elif cfg.loss in (Loss.GP, Loss.NB):
        extra["theta"] = disp
    elif cfg.loss in (Loss.GAMMA, Loss.INVGAUSS, Loss.TWEEDIE):
        extra["dispersion"] = disp
    if cfg.has_zi():
        if cfg.zi == ZI.ROW:
            extra["pi_row"] = np.asarray(state.pi_row)
        else:
            extra["pi_col"] = np.asarray(state.pi_col)

    fit_state = FitState(state.W_T, state.H, state.d, state.it,
                         state.prev_loss, state.patience_ctr, state.converged,
                         state.final_tol, state.loss_hist)
    return finalize_result(cfg, fit_state, extra)
