"""Speckled-holdout cross-validation and masked NMF.

JAX re-architecture of the reference CV engine (``nmf/fit_cv.hpp:124-1667``,
``nmf/speckled_cv.hpp:58-339``, ``nmf/masked_nnls.hpp:73-178``).

The reference corrects the Gram per column (``G_local = G - W_test W_test^T``,
cv_detail.hpp:54-84) in an OpenMP loop.  Here this becomes a *weighted*
batched solve: the train mask is a dense 0/1 weight field and each column's
Gram is ``W_T diag(train_j) W_T^T`` computed as one blocked batched
einsum — numerically the same down-date, every column solved at once with a
batched Cholesky or lane-parallel CD.

Holdout masks stay a pure function of (seed, i, j) — SplitMix64 position
hash identical to the reference (rng/rng.hpp:129-170), materialized
host-side as a dense bool array for the in-memory path.

CV convergence (fit_cv.hpp:1584-1621): patience on test-loss improvement,
plus immediate stop when the test-loss relative change drops below tol.
``train_loss``/``test_loss`` are per-entry means (fit_cv.hpp:1545-1548).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from .. import rng as rng_mod
from ..config import Dispersion, Loss, NMFConfig, Solver
from ..ops import features as feat
from ..ops import linalg, losses, solvers
from ..ops.linalg import PREC
from ..result import NMFResult
from . import nmf as nmf_mod
from .nmf_irls import (_block_count, _init_dispersion, _pad_cols,
                       _zi_pi_init, gp_theta_update, irls_solve_batch,
                       nb_size_update, phi_update, zi_em_step)


class CVState(NamedTuple):
    W_T: jax.Array
    H: jax.Array
    d: jax.Array
    disp_row: jax.Array
    disp_col: jax.Array
    it: jax.Array
    prev_conv_loss: jax.Array      # previous test loss (CV) / train (masked)
    patience_ctr: jax.Array
    converged: jax.Array
    final_tol: jax.Array
    train_hist: jax.Array
    test_hist: jax.Array
    best_test_loss: jax.Array
    best_iter: jax.Array
    pi_row: jax.Array              # (m,) ZI dropout (zeros when no ZI)
    pi_col: jax.Array              # (n,)
    A_imp: jax.Array               # (m, n) soft-imputed data (ZI only)


def _rank_ridge(Gb, eye):
    """Relative ridge for batched per-column Grams: a column with < k
    observed train entries has a rank-deficient Gram (the reference's
    unpivoted LLT hits the same hazard, cholesky_clip.hpp:92-95); the
    trace-relative ridge keeps the batched Cholesky finite without
    measurably moving well-conditioned columns (1e-6 << fp32 solve
    error).  Do NOT remove or retune per-site."""
    k = Gb.shape[-1]
    tr = jnp.einsum("bkk->b", Gb) / k
    return Gb + (1e-6 * tr + 1e-12)[:, None, None] * eye[None]


def masked_mse_solve_batch(A_data, F, train_w, cfg: NMFConfig, fc, X_warm,
                           G_add=None, target=None):
    """MSE masked solve: per-column Gram over train entries only.

    A_data (m, nc), F (k, m), train_w (m, nc) 0/1.  Blocked batched solve;
    equivalent to the reference per-column Gram correction
    (cv_detail.hpp:54-84) since sum_train w w' = G_full - sum_test w w'.

    ``G_add``: optional shared k x k tier-2 term (graph reg + L21) added to
    every per-column Gram — the reference's apply_cv_features semantics
    (fit_cv.hpp:417,581).  ``target``: optional (k, nc) enrichment target
    (fc.target_lambda > 0): G.diag += lam, b += lam * T (factor_config.hpp:80-102).
    """
    from .nmf_irls import _use_kr
    k, m = F.shape
    n = A_data.shape[1]
    dtype = A_data.dtype
    use_kr = _use_kr(k, m)
    KR = linalg.kr_product(F) if use_kr else None
    bc = _block_count(n, k, m, kr=use_kr)
    A_pad, _ = _pad_cols(A_data, bc)
    W_pad, _ = _pad_cols(train_w, bc)
    X_warm_pad, _ = _pad_cols(X_warm, bc)
    T_pad = _pad_cols(target, bc)[0] if target is not None else None
    nblocks = A_pad.shape[1] // bc
    eye = jnp.eye(k, dtype=dtype)

    def solve_block(blk_idx):
        A_blk = lax.dynamic_slice_in_dim(A_pad, blk_idx * bc, bc, axis=1)
        w_blk = lax.dynamic_slice_in_dim(W_pad, blk_idx * bc, bc, axis=1)
        # masked MSE trains on 0/1 weights: fp32 Gram (reference precision;
        # bf16 noise NaNs near-singular masked columns)
        Gb, b = linalg.weighted_gram_and_rhs(F, w_blk, A_blk, KR=KR,
                                             precise=True)
        Gb = Gb + (1e-15 + fc.L2) * eye[None]
        if G_add is not None:
            Gb = Gb + G_add[None]
        if T_pad is not None:
            Gb = Gb + fc.target_lambda * eye[None]
            b = b + fc.target_lambda * lax.dynamic_slice_in_dim(
                T_pad, blk_idx * bc, bc, axis=1)
        if cfg.solver == Solver.CHOLESKY:
            if fc.L1 > 0:
                # Cholesky mode applies L1 to the RHS (fused_nnls.hpp:117)
                b = b - fc.L1
            Gb = _rank_ridge(Gb, eye)
            return solvers.cholesky_clip_batched_gram(Gb, b, nonneg=fc.nonneg)
        X0 = lax.dynamic_slice_in_dim(X_warm_pad, blk_idx * bc, bc, axis=1)
        B_res = b - solvers.batched_gram_matvec(Gb, X0)
        # CD applies L1 per coordinate visit as the G_ii-scaled ratio
        # threshold (nnls_batch.hpp:92-94) — NOT a RHS pre-subtraction,
        # which would shrink by L1/G_ii instead
        return solvers.cd_nnls_batched_gram(
            Gb, B_res, X0, fc.L1, nonneg=fc.nonneg,
            maxit=cfg.cd_max_iter, cd_tol=cfg.cd_tol)

    X_blocks = lax.map(solve_block, jnp.arange(nblocks))
    return jnp.transpose(X_blocks, (1, 0, 2)).reshape(k, nblocks * bc)[:, :n]


def masked_downdate_solve_batch(B_full, F, G_feat, idx, val, cfg: NMFConfig,
                                fc, X_warm, target=None):
    """MSE masked solve via gathered per-column Gram DOWNDATES.

    ``B_full`` (k, n) = F @ (train .* A) precomputed with one dense
    matmul; ``G_feat`` (k, k) = full Gram + ridge/L2/tier-2/target-diag;
    ``idx``/``val`` (T, n) = excluded-row indices + validity per column.
    Equivalent to :func:`masked_mse_solve_batch` for 0/1 train weights but
    ~inv_prob x cheaper (see linalg.gathered_gram_downdate).
    """
    k, n = B_full.shape
    T = idx.shape[0]
    bc = max(8, min(n, int(1.2e8 / max(k * max(T, 1), 1))))
    B_pad, _ = _pad_cols(B_full, bc)
    X_warm_pad, _ = _pad_cols(X_warm, bc)
    idx_pad = _pad_cols(idx, bc)[0]
    val_pad = _pad_cols(val, bc)[0]
    T_pad = _pad_cols(target, bc)[0] if target is not None else None
    nblocks = B_pad.shape[1] // bc

    def solve_block(blk_idx):
        b = lax.dynamic_slice_in_dim(B_pad, blk_idx * bc, bc, axis=1)
        i_blk = lax.dynamic_slice_in_dim(idx_pad, blk_idx * bc, bc, axis=1)
        v_blk = lax.dynamic_slice_in_dim(val_pad, blk_idx * bc, bc, axis=1)
        Gb = G_feat[None] - linalg.gathered_gram_downdate(F, i_blk, v_blk)
        if T_pad is not None:
            b = b + fc.target_lambda * lax.dynamic_slice_in_dim(
                T_pad, blk_idx * bc, bc, axis=1)
        if cfg.solver == Solver.CHOLESKY:
            if fc.L1 > 0:
                b = b - fc.L1         # RHS form, Cholesky mode only
            Gb = _rank_ridge(Gb, jnp.eye(Gb.shape[-1], dtype=Gb.dtype))
            return solvers.cholesky_clip_batched_gram(Gb, b, nonneg=fc.nonneg)
        X0 = lax.dynamic_slice_in_dim(X_warm_pad, blk_idx * bc, bc, axis=1)
        B_res = b - solvers.batched_gram_matvec(Gb, X0)
        return solvers.cd_nnls_batched_gram(
            Gb, B_res, X0, fc.L1, nonneg=fc.nonneg,
            maxit=cfg.cd_max_iter, cd_tol=cfg.cd_tol)

    X_blocks = lax.map(solve_block, jnp.arange(nblocks))
    return jnp.transpose(X_blocks, (1, 0, 2)).reshape(k, nblocks * bc)[:, :n]


def _excl_indices(train_w, t_max: int):
    """Excluded-row indices + validity per column, (T, n) each.

    Stable argsort puts excluded rows (train weight 0) first in ascending
    row order; computed ONCE per fit (the mask is iteration-invariant)."""
    excl = train_w == 0
    order = jnp.argsort(jnp.logical_not(excl), axis=0,
                        stable=True).astype(jnp.int32)[:t_max]
    val = jnp.take_along_axis(excl, order, axis=0)
    return order, val.astype(train_w.dtype)


@partial(jax.jit, static_argnames=("cfg", "sparse_zeros", "is_cv", "t_max"))
def _fit_masked_jit(cfg: NMFConfig, A, masks, aux, W_T0, H0, d0,
                    disp_row0, disp_col0, cv_seed_pair,
                    sparse_zeros: bool, is_cv: bool, t_max=None):
    """Unified masked / CV ALS loop.

    ``masks`` is a dict with static key-presence: optional ``user_mask``
    (m, n) bool and optional ``rows_ok``/``cols_ok`` subsample vectors.
    ``aux`` carries optional graph Laplacians / enrichment targets, applied
    with the reference's CV feature semantics (apply_cv_features,
    fit_cv.hpp:417,581: L2 + graph + L21 on the Gram; L1 in the solver;
    enrichment targets additionally supported here — the reference drops
    them in CV).  The speckled CV holdout itself is computed ON DEVICE from
    the traced SplitMix64 hash (bit-identical to the host mask;
    speckled_cv.hpp's lazy design taken to its conclusion — nothing is
    uploaded).  When ``is_cv``: test-loss early stopping and best-iteration
    tracking; otherwise standard patience on the masked train loss."""
    dtype = A.dtype
    m, n = A.shape
    max_iter = cfg.max_iter

    # ---- build the test mask in-trace (seed is TRACED: one executable
    # serves every CV repetition) ----
    M_test = None
    if is_cv and cfg.test_fraction > 0:
        inv_prob = int(1.0 / cfg.test_fraction)
        ii = jnp.arange(m, dtype=jnp.uint32)[:, None]
        jj = jnp.arange(n, dtype=jnp.uint32)[None, :]
        M_test = rng_mod.is_holdout_traced(cv_seed_pair, ii, jj, inv_prob)
        if cfg.mask_zeros:
            M_test = M_test & (A != 0)
        if "rows_ok" in masks:
            M_test = M_test & masks["rows_ok"][:, None]
        if "cols_ok" in masks:
            M_test = M_test & masks["cols_ok"][None, :]
    # user-masked entries leave BOTH train and test accounting
    # (fit_cv.hpp:1391-1393): the CV test statistic stays a pure
    # speckled-holdout quantity.  For a pure masked fit (no CV) the
    # masked entries themselves are reported as the held-out set.
    um = masks.get("user_mask")
    if M_test is None:
        M_test = um if um is not None else jnp.zeros((m, n), dtype=bool)
        um = None
    M_excl = M_test if um is None else (M_test | um)

    # mesh-padding validity: padded rows/cols leave train AND test
    valid = None
    if "valid_rows" in masks:
        valid = masks["valid_rows"][:, None]
    if "valid_cols" in masks:
        vc = masks["valid_cols"][None, :]
        valid = vc if valid is None else (valid & vc)
    if valid is not None:
        M_test = M_test & valid
        if um is not None:
            M_test = M_test & (~um)
        train_w = ((~M_excl) & valid).astype(dtype)
    else:
        if um is not None:
            M_test = M_test & (~um)
        train_w = (~M_excl).astype(dtype)
    test_w = M_test.astype(dtype)
    n_test = jnp.sum(test_w)
    if sparse_zeros:
        nz = (A != 0).astype(dtype)
        n_train = jnp.sum(nz * train_w)
    else:
        n_train = jnp.sum(train_w)

    is_irls = cfg.requires_irls()
    if is_cv and cfg.mask_zeros and is_irls:
        # speckled CV + mask_zeros under IRLS: zeros leave the weighted
        # solves entirely (cv_detail.hpp:123-126,222-232 collect only
        # nonzero train entries); MSE keeps zeros in the Gram as the
        # reference does (compute_train_rhs + apply_gram_correction only
        # downdate holdout rows).
        train_w = train_w * (A != 0).astype(dtype)
        n_train = jnp.sum(train_w)
    is_gp = cfg.loss == Loss.GP
    is_nb = cfg.loss == Loss.NB
    is_phi = cfg.loss in (Loss.GAMMA, Loss.INVGAUSS, Loss.TWEEDIE)
    per_col = cfg.dispersion == Dispersion.PER_COL
    has_disp = cfg.dispersion != Dispersion.NONE and is_irls
    active_loss = Loss.KL if is_gp else cfg.loss
    # zero-inflation rides the CV/masked loop exactly like fit_cv.hpp:
    # the solves see the soft-imputed matrix (:434,485), the EM imputes
    # every zero (:1285-1340), losses stay on the observed A (:1388+)
    is_zi = cfg.has_zi()
    zi_valid = None
    if is_zi:
        # ZI accounting sees TRAINED entries only: user-masked entries
        # leave all accounting (fit_cv.hpp:1391-1393) and held-out /
        # mesh-padded zeros must not inflate dropout estimates
        zi_valid = train_w > 0

    # gathered-downdate fast path for the 0/1-weight MSE solves: excluded
    # indices are a pure function of the (iteration-invariant) masks, so
    # the argsort runs ONCE per fit, outside the ALS loop
    dd_h = dd_w = None
    if not is_irls and t_max is not None:
        t_h, t_w = t_max
        A_train = A * train_w
        idx_h, val_h = _excl_indices(train_w, t_h)
        idx_w, val_w = _excl_indices(train_w.T, t_w)
        dd_h = (idx_h, val_h, A_train)
        dd_w = (idx_w, val_w, A_train.T)

    def solve_side(A_side, F, w_train_side, fc, X_warm, it, th_row, th_col,
                   graph, target, dd=None):
        # tier-2 features from the previous iterate of the factor being
        # solved, shared across all per-column Grams (cv_detail.hpp:168,272)
        G_add = feat.tier2_gram_addition(X_warm, fc, graph)
        tgt = target if (target is not None and fc.target_lambda > 0) else None
        Xw = X_warm * (it > 0).astype(dtype)
        if is_irls:
            # ZI fits solve on the imputed matrix — the zeros-get-unit-
            # weight sparse shortcut must not apply (nmf_irls.py uses the
            # same `and not is_zi` guard on its solve calls)
            return irls_solve_batch(A_side, F, cfg, active_loss,
                                    th_row, th_col, fc,
                                    sparse_zeros and not is_zi,
                                    extra_w=w_train_side, X_warm=Xw,
                                    G_add=G_add, target=tgt)
        if dd is not None:
            idxs, vals, A_tr = dd
            k = F.shape[0]
            eye = jnp.eye(k, dtype=dtype)
            G_feat = linalg.gram(F) + fc.L2 * eye     # gram() adds the 1e-15
            if G_add is not None:
                G_feat = G_feat + G_add
            if tgt is not None:
                G_feat = G_feat + fc.target_lambda * eye
            B_full = jnp.dot(F, A_tr, precision=PREC)
            return masked_downdate_solve_batch(B_full, F, G_feat, idxs, vals,
                                               cfg, fc, Xw, target=tgt)
        return masked_mse_solve_batch(A_side, F, w_train_side, cfg, fc, Xw,
                                      G_add=G_add, target=tgt)

    def body(state: CVState) -> CVState:
        W_T, H, d, it = state.W_T, state.H, state.d, state.it
        disp_row, disp_col = state.disp_row, state.disp_col
        # ZI: solves see the imputed matrix from iteration >= 1
        A_solve = state.A_imp if is_zi else A

        th_row = disp_row if (is_nb and not per_col) else None
        th_col = disp_col if (is_nb and per_col) else None
        H_new = solve_side(A_solve, W_T, train_w, cfg.H, H, it, th_row,
                           th_col,
                           aux.get("graph_H"), aux.get("target_H"), dd=dd_h)
        if cfg.H.upper_bound > 0:
            H_new = feat.apply_upper_bound(H_new, cfg.H.upper_bound)
        if cfg.H.angular > 0:
            H_new = feat.apply_angular_posthoc(H_new, cfg.H.angular)
        if "valid_cols" in masks:
            # mesh padding: fully-excluded pad columns must stay exact zero
            H_new = H_new * masks["valid_cols"][None, :].astype(dtype)
        H, d = linalg.extract_scaling(H_new, cfg.norm)

        th_row_w = disp_col if (is_nb and per_col) else None
        th_col_w = disp_row if (is_nb and not per_col) else None
        W_new = solve_side(A_solve.T, H, train_w.T, cfg.W, W_T, it,
                           th_row_w, th_col_w,
                           aux.get("graph_W"), aux.get("target_W"), dd=dd_w)
        if cfg.W.upper_bound > 0:
            W_new = feat.apply_upper_bound(W_new, cfg.W.upper_bound)
        if cfg.W.angular > 0:
            W_new = feat.apply_angular_posthoc(W_new, cfg.W.angular)
        if "valid_rows" in masks:
            W_new = W_new * masks["valid_rows"][None, :].astype(dtype)
        W_T, d = linalg.extract_scaling(W_new, cfg.norm)

        # --- dispersion updates on TRAIN entries only ---
        W_Td = W_T * d[:, None]
        rec = jnp.dot(W_Td.T, H, precision=PREC)
        S = jnp.maximum(rec, 1e-10)
        if has_disp:
            A_train = A * train_w
            S_train = S * train_w
            if is_gp:
                if per_col:
                    disp_col = gp_theta_update(A_train, S_train, disp_col, cfg, 0)
                else:
                    disp_row = gp_theta_update(A_train, S_train, disp_row, cfg, 1)
            elif is_nb:
                if per_col:
                    disp_col = nb_size_update(A_train, S_train, cfg, 0)
                else:
                    disp_row = nb_size_update(A_train, S_train, cfg, 1)
            elif is_phi:
                if per_col:
                    disp_col = phi_update(A_train, S_train, cfg, 0)
                else:
                    disp_row = phi_update(A_train, S_train, cfg, 1)

        # --- ZI EM + soft imputation (fit_cv.hpp:1285-1340) ---
        pi_row, pi_col, A_imp = state.pi_row, state.pi_col, state.A_imp
        if is_zi:
            for _ in range(max(1, cfg.zi_em_iters)):   # static unroll
                pi_row, pi_col, A_imp = zi_em_step(
                    A, S, cfg, disp_row, pi_row, pi_col, valid=zi_valid,
                    disp_col=disp_col if per_col else None)
            if cfg.theta_min > 0 and is_gp:
                # same post-EM stabilizer as the plain IRLS loop
                disp_row = jnp.maximum(disp_row, cfg.theta_min)
                disp_col = jnp.maximum(disp_col, cfg.theta_min)

        # --- per-entry train / test losses (fit_cv.hpp:1368-1548) ---
        theta = losses._expand_theta(
            None if per_col else disp_row, disp_col if per_col else None,
            A.shape)
        contrib = losses.compute_loss_elements(A, rec, cfg, theta)
        train_contrib = contrib * train_w
        if sparse_zeros:
            train_contrib = train_contrib * nz
        train_loss = jnp.sum(train_contrib) / jnp.maximum(n_train, 1.0)
        test_loss = jnp.sum(contrib * test_w) / jnp.maximum(n_test, 1.0)

        conv_loss = test_loss if is_cv else train_loss
        rel = jnp.abs(state.prev_conv_loss - conv_loss) / \
            (jnp.abs(state.prev_conv_loss) + 1e-15)
        final_tol = jnp.where(it > 0, rel, state.final_tol)

        if is_cv:
            improved = test_loss < state.best_test_loss
            best_test = jnp.where(improved, test_loss, state.best_test_loss)
            best_iter = jnp.where(improved, it, state.best_iter)
            patience_ctr = jnp.where(improved, 0, state.patience_ctr + 1)
            stop_patience = patience_ctr >= cfg.cv_patience
            stop_tol = (it > 0) & (rel < cfg.tol)
            converged = stop_patience | stop_tol
        else:
            best_test = state.best_test_loss
            best_iter = state.best_iter
            loss_conv = (it > 0) & (rel < cfg.tol)
            patience_ctr = jnp.where(loss_conv, state.patience_ctr + 1, 0)
            converged = patience_ctr >= cfg.patience

        return CVState(
            W_T, H, d, disp_row, disp_col, it + 1, conv_loss, patience_ctr,
            converged, final_tol,
            state.train_hist.at[it].set(train_loss),
            state.test_hist.at[it].set(test_loss),
            best_test, best_iter, pi_row, pi_col, A_imp)

    def cond(state: CVState):
        return (state.it < max_iter) & jnp.logical_not(state.converged)

    if is_zi:
        pi_row0, pi_col0 = _zi_pi_init(A, cfg, valid=zi_valid)
    else:
        pi_row0 = jnp.zeros((m,), dtype)
        pi_col0 = jnp.zeros((n,), dtype)

    init = CVState(
        W_T=W_T0, H=H0, d=d0, disp_row=disp_row0, disp_col=disp_col0,
        it=jnp.int32(0),
        prev_conv_loss=jnp.asarray(jnp.finfo(dtype).max, dtype),
        patience_ctr=jnp.int32(0),
        converged=jnp.bool_(False),
        final_tol=jnp.asarray(jnp.nan, dtype),
        train_hist=jnp.full((max_iter,), jnp.nan, dtype),
        test_hist=jnp.full((max_iter,), jnp.nan, dtype),
        best_test_loss=jnp.asarray(jnp.finfo(dtype).max, dtype),
        best_iter=jnp.int32(0),
        pi_row=pi_row0, pi_col=pi_col0,
        A_imp=(A if is_zi else jnp.zeros((), dtype)),
    )
    return lax.while_loop(cond, body, init)


def build_speckled_mask(cfg: NMFConfig, A: np.ndarray) -> np.ndarray:
    """Dense holdout mask from the lazy speckled hash (speckled_cv.hpp:58-130).

    inv_prob = floor(1/test_fraction); seed = uint32(cv_seed), 0 -> 12345.
    mask_zeros restricts eligibility to nonzero entries.
    """
    m, n = A.shape
    inv_prob = int(1.0 / cfg.test_fraction) if cfg.test_fraction > 0 else 0
    seed = np.uint32(cfg.cv_seed)
    mask = rng_mod.holdout_mask(int(seed), m, n, inv_prob)
    if cfg.mask_zeros:
        mask &= (A != 0)
    # row/col subsampling (speckled_cv.hpp:67-104)
    if cfg.cv_row_subsample < 1.0:
        rows_ok = rng_mod.subsample_mask_1d(int(seed), m,
                                            cfg.cv_row_subsample,
                                            use_col_constant=False)
        mask &= rows_ok[:, None]
    if cfg.cv_col_subsample < 1.0:
        cols_ok = rng_mod.subsample_mask_1d(int(seed), n,
                                            cfg.cv_col_subsample,
                                            use_col_constant=True)
        mask &= cols_ok[None, :]
    return mask


def fit_cv_or_masked(A, cfg: NMFConfig, *, mask=None,
                     aux=None, w_init=None, h_init=None,
                     sparse_zeros: bool = False, mesh=None,
                     use_downdate: bool = False) -> NMFResult:
    """Host driver: CV holdout (computed on device), user mask, or both.

    ``mesh``: optional jax.sharding.Mesh — shards A/factors with the
    canonical (rows, cols) layout (parallel/mesh.py) and runs the SAME
    compiled masked/CV program multi-chip; the speckled holdout is computed
    in-jit from the traced hash, so every shard derives its own mask
    locally with zero mask traffic."""
    m, n = A.shape
    is_cv = cfg.is_cv()

    masks = {}
    if mask is not None:
        try:
            import scipy.sparse as sp
            if sp.issparse(mask):
                mask = np.asarray(mask.todense())
        except ImportError:
            pass
        if isinstance(mask, jax.Array):      # keep device-resident
            masks["user_mask"] = mask.astype(bool)
        else:
            masks["user_mask"] = jnp.asarray(np.asarray(mask).astype(bool))
    if is_cv and cfg.cv_row_subsample < 1.0:
        masks["rows_ok"] = jnp.asarray(rng_mod.subsample_mask_1d(
            int(np.uint32(cfg.cv_seed)), m, cfg.cv_row_subsample,
            use_col_constant=False))
    if is_cv and cfg.cv_col_subsample < 1.0:
        masks["cols_ok"] = jnp.asarray(rng_mod.subsample_mask_1d(
            int(np.uint32(cfg.cv_seed)), n, cfg.cv_col_subsample,
            use_col_constant=True))

    A_dev = (A.astype(jnp.float32) if isinstance(A, jax.Array)
             else jnp.asarray(np.asarray(A, dtype=np.float32)))
    aux_dev = {key: jnp.asarray(val, jnp.float32)
               for key, val in (aux or {}).items()
               if val is not None and not key.endswith("_gram")}
    if w_init is None and h_init is None and cfg.init_mode == 0:
        # device-side bit-identical random init (no host fill / transfer)
        W_T0, H0, d0 = nmf_mod._init_random_device(
            cfg.rank, m, n, jnp.asarray(rng_mod.seed_to_u32_pair(cfg.seed)))
    else:
        W_T0, H0, d0 = nmf_mod.init_factors(cfg, m, n, A=A, w_init=w_init,
                                            h_init=h_init)
    disp_row0, disp_col0 = _init_dispersion(cfg, m, n, np.float32)

    # seed travels as a traced uint32 pair; strip it from the static config
    # so different CV repetitions hit the same compiled executable
    seed_pair = jnp.asarray(rng_mod.seed_to_u32_pair(int(np.uint32(cfg.cv_seed))))
    cfg_static = cfg.device_static()

    W_T0, H0, d0 = jnp.asarray(W_T0), jnp.asarray(H0), jnp.asarray(d0)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        from ..parallel.mesh import mesh_padding, shard_arrays
        pm, pn = mesh_padding(mesh, m, n)
        if pm or pn:
            disp_row0, disp_col0 = _init_dispersion(cfg, m + pm, n + pn,
                                                    np.float32)
            # pads are excluded from BOTH train and test accounting via
            # valid_rows/valid_cols (their factors solve to exact zeros)
            if pm:
                masks["valid_rows"] = jnp.pad(
                    jnp.ones(m, bool), (0, pm))
            if pn:
                masks["valid_cols"] = jnp.pad(
                    jnp.ones(n, bool), (0, pn))
            if "user_mask" in masks:
                masks["user_mask"] = jnp.pad(
                    masks["user_mask"], ((0, pm), (0, pn)))
            if "rows_ok" in masks:
                masks["rows_ok"] = jnp.pad(masks["rows_ok"], (0, pm))
            if "cols_ok" in masks:
                masks["cols_ok"] = jnp.pad(masks["cols_ok"], (0, pn))
            # pad aux to the mesh shape: Laplacians get zero cross-terms
            # and targets zero columns, so padded dims contribute nothing
            if "graph_H" in aux_dev:
                aux_dev["graph_H"] = jnp.pad(aux_dev["graph_H"],
                                             ((0, pn), (0, pn)))
            if "graph_W" in aux_dev:
                aux_dev["graph_W"] = jnp.pad(aux_dev["graph_W"],
                                             ((0, pm), (0, pm)))
            if "target_H" in aux_dev:
                aux_dev["target_H"] = jnp.pad(aux_dev["target_H"],
                                              ((0, 0), (0, pn)))
            if "target_W" in aux_dev:
                aux_dev["target_W"] = jnp.pad(aux_dev["target_W"],
                                              ((0, 0), (0, pm)))
        A_dev, W_T0, H0, d0 = shard_arrays(mesh, A_dev, W_T0, H0, d0)
        if "user_mask" in masks:
            masks["user_mask"] = jax.device_put(
                masks["user_mask"], NamedSharding(mesh, P("rows", "cols")))
        for key, axis in (("rows_ok", "rows"), ("valid_rows", "rows"),
                          ("cols_ok", "cols"), ("valid_cols", "cols")):
            if key in masks:
                masks[key] = jax.device_put(
                    masks[key], NamedSharding(mesh, P(axis)))

    # gathered-downdate bound: excluded rows per column <= an 8-sigma
    # binomial tail of the holdout + exact user-mask column counts + mesh
    # padding.  Deterministic in (shape, fraction) — NOT the seed — so CV
    # repetitions keep sharing one compiled executable.
    #
    # OPT-IN ONLY: despite ~m/T fewer FLOPs, the F[:, idx] gather is
    # elementwise work while the weighted per-column Gram einsum is one
    # dense matmul; which wins on the GPU is not measured.  Kept as a
    # tested alternate kernel for hosts/backends where gathers are cheap
    # relative to dense FLOPs (e.g. very large m with tiny holdouts on
    # CPU).
    t_max = None
    if use_downdate and not cfg.requires_irls():
        import math as _math
        mq, nq = A_dev.shape

        def cv_bound(d):
            if not (is_cv and cfg.test_fraction > 0):
                return 0
            # the traced holdout draws with probability 1/int(1/f), which
            # EXCEEDS f when 1/f is not an integer (rng.holdout_mask) —
            # bounding with the raw fraction would truncate _excl_indices
            # and leave held-out entries in the training Gram
            p = 1.0 / int(1.0 / cfg.test_fraction)
            mean = d * p
            return int(_math.ceil(mean + 8.0 * _math.sqrt(max(mean, 1.0))))

        um_col_max = um_row_max = 0
        if mask is not None:
            um_host = np.asarray(masks["user_mask"])
            um_col_max = int(um_host.sum(axis=0).max())
            um_row_max = int(um_host.sum(axis=1).max())
        t_h = min(mq, cv_bound(mq) + um_col_max + (mq - m))
        t_w = min(nq, cv_bound(nq) + um_row_max + (nq - n))
        if t_h <= mq // 2 and t_w <= nq // 2:
            t_max = (t_h, t_w)

    state = _fit_masked_jit(cfg_static, A_dev,
                            masks, aux_dev, W_T0, H0, d0,
                            jnp.asarray(disp_row0), jnp.asarray(disp_col0),
                            seed_pair, sparse_zeros, is_cv, t_max=t_max)
    # selective transfer: the (m, n) imputed buffer is loop-internal and
    # would dominate the device->host transfer (see nmf_irls.py)
    state = state._replace(A_imp=jnp.zeros((), jnp.float32))
    state = jax.device_get(state)   # one batched transfer

    it = int(state.it)
    res = NMFResult(
        W=np.asarray(state.W_T).T[:m], d=np.asarray(state.d),
        H=np.asarray(state.H)[:, :n],
        iterations=it,
        converged=bool(state.converged),
        final_tol=float(state.final_tol),
        train_loss=float(state.train_hist[it - 1]) if it > 0 else float("nan"),
        test_loss=float(state.test_hist[it - 1]) if it > 0 else float("nan"),
        best_iter=int(state.best_iter),
        loss_history=np.asarray(state.train_hist)[:it],
        test_loss_history=np.asarray(state.test_hist)[:it],
    )
    res.misc["best_test_loss"] = float(state.best_test_loss)
    per_col = cfg.dispersion == Dispersion.PER_COL
    disp_len = n if per_col else m      # slice off any mesh padding
    if cfg.dispersion == Dispersion.NONE:
        pass   # dispersion='none' returns nothing (test_distribution_api.R:181)
    elif cfg.loss in (Loss.GP, Loss.NB):
        res.theta = np.asarray(
            state.disp_col if per_col else state.disp_row)[:disp_len]
    elif cfg.loss in (Loss.GAMMA, Loss.INVGAUSS, Loss.TWEEDIE):
        res.dispersion = np.asarray(
            state.disp_col if per_col else state.disp_row)[:disp_len]
    if cfg.has_zi():
        from ..config import ZI
        if cfg.zi == ZI.ROW:
            res.pi_row = np.asarray(state.pi_row)[:m]
        else:
            res.pi_col = np.asarray(state.pi_col)[:n]
    if cfg.sort_model:
        res.sort()
    return res


def cv_sweep(A: np.ndarray, ks, *, cv_seed=0, mask=None, **kwargs):
    """Multi-rank CV sweep (R/nmf_thin.R:1013-1094).

    ``cv_seed`` may be an int or a list (each entry = one CV repetition).
    Returns a list of dict rows: k, rep, train_mse, test_mse, best_iter.
    """
    from ..api import build_config

    seeds = [cv_seed] if np.isscalar(cv_seed) else list(cv_seed)
    kwargs.setdefault("test_fraction", 0.1)
    user_seed = kwargs.pop("seed", None)
    rows = []
    for rep_idx, rep_seed in enumerate(seeds):
        for k in ks:
            # init seed derived per (rep, rank) as in R/nmf_thin.R:1023
            base = int(user_seed) if user_seed is not None else int(rep_seed)
            init_seed = (base + int(k)) % (2**31 - 1)
            cfg = build_config(int(k), cv_seed=int(rep_seed),
                               seed=init_seed, **kwargs)
            res = fit_cv_or_masked(A, cfg, mask=mask)
            rows.append({
                "k": int(k), "rep": rep_idx + 1,
                "train_mse": res.train_loss, "test_mse": res.test_loss,
                "best_test_loss": res.misc["best_test_loss"],
                "best_iter": res.best_iter, "iterations": res.iterations,
                # distribution columns (test_g1_g6_fixes.R G5): NaN for MSE
                "mean_theta": (float(np.mean(res.theta))
                               if res.theta is not None else float("nan")),
                "mean_dispersion": (float(np.mean(res.dispersion))
                                    if res.dispersion is not None
                                    else float("nan")),
            })
    return rows
