"""Chunked / streaming NMF — larger-than-memory ALS over a DataLoader.

JAX re-architecture of ``nmf/fit_chunked.hpp:71+`` and the streaming entry
``nmf/fit_streaming_spz.hpp:54-223``:

  per iteration:
    gram(W_T) once (k x k)  ->  forward column panels: per-panel RHS +
    solve for the H panel (prefetcher overlaps host decode with device
    compute)  ->  gram(H)  ->  transpose panels: per-panel W_T updates  ->
    scaling  ->  Gram-trick loss accumulated panel-wise.

  Memory: O(m k + n k + panel) — A never lives in device memory at
  once — UNLESS the panel residency cache activates (data fits device
  memory with headroom, or panel_cache=True): then forward+transpose
  panel copies stay device-resident across sweeps for speed.  Pass
  panel_cache=False to keep the strict O(panel) footprint.

Panel solves are the standard batched Cholesky / CD primitives; each panel
update is one jit-compiled call reused across panels and iterations.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Union

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from .. import rng as rng_mod
from ..config import ZI, Dispersion, Loss, NMFConfig, Solver
from ..io.loaders import (DataLoader, InMemoryLoader, Prefetcher,
                          SparseChunk, SpzLoader)
from ..ops import features as feat
from ..ops import linalg, solvers
from ..ops.linalg import PREC
from ..result import NMFResult
from .nmf import init_factors


@partial(jax.jit, static_argnames=("nrows", "ncols"))
def _coo_densify(rows, counts, vals, *, nrows: int, ncols: int):
    """Dense (nrows, ncols) panel from compact device-resident CSC-ish
    triples: ``rows`` (uint16 when nrows < 65536, else int32), per-column
    ``counts`` (int32, length ncols+1 — the last entry counts the bucket
    padding), ``vals`` (uint8/uint16 when integral, else f32).

    Column ids are EXPANDED ON DEVICE from the counts (repeat), so they
    never cross the link; padding entries expand to column id == ncols,
    which the scatter's out-of-bounds mode drops.  Minimal wire format:
    ~3 bytes/nnz for uint16-row/uint8-value panels vs 4 bytes/ELEMENT
    dense — the ingest-bandwidth lever of the streaming engine."""
    bucket = rows.shape[0]
    cols = jnp.repeat(jnp.arange(ncols + 1, dtype=jnp.int32), counts,
                      total_repeat_length=bucket)
    Z = jnp.zeros((nrows, ncols), jnp.float32)
    return Z.at[rows.astype(jnp.int32), cols].add(
        vals.astype(jnp.float32), mode="drop")


@partial(jax.jit, static_argnames=("nrows", "ncols"))
def _coo_densify_T(rows, counts, vals, *, nrows: int, ncols: int):
    """TRANSPOSED dense panel (ncols, nrows) from the compact triples.

    Consumers contract over the trailing (nrows) axis, so no transpose
    copy is ever materialized.  Padding entries expand to col == ncols —
    out of bounds, dropped.

    indices_are_sorted is deliberately NOT set: although the expanded
    (col, row) indices of canonical CSC are lexicographically sorted, a
    backend lowering has been seen to silently drop entries of a real
    chunk with the flag on while the flag-off scatter was exact — a
    data-dependent miscompile we refuse to ship against."""
    bucket = rows.shape[0]
    cols = jnp.repeat(jnp.arange(ncols + 1, dtype=jnp.int32), counts,
                      total_repeat_length=bucket)
    Z = jnp.zeros((ncols, nrows), jnp.float32)
    return Z.at[cols, rows.astype(jnp.int32)].add(
        vals.astype(jnp.float32), mode="drop")


def _solve_from_B(cfg: NMFConfig, side: str, G, B, X_warm, warm):
    """The feature + solve tail of :func:`_panel_solve`, for callers that
    computed B = F @ A_panel themselves (e.g. from a transposed panel)."""
    fc = cfg.H if side == "H" else cfg.W
    if fc.L1 > 0:
        B = B - fc.L1
    if cfg.solver == Solver.CHOLESKY:
        X = solvers.cholesky_clip_batch(G, B, nonneg=fc.nonneg)
    else:
        X0 = X_warm * warm.astype(X_warm.dtype)
        B_res = B - jnp.dot(G, X0, precision=PREC)
        X = solvers.cd_nnls_batch_traced(G, B_res, X0, 0.0, nonneg=fc.nonneg,
                                         maxit=cfg.cd_max_iter,
                                         cd_tol=cfg.cd_tol)
    if fc.upper_bound > 0:
        X = feat.apply_upper_bound(X, fc.upper_bound)
    return X


class _CompactChunk:
    """Wire-ready sparse panel: padded/bucketed arrays with compact
    dtypes, produced OFF the consumer's critical path (in the Prefetcher
    worker) by :func:`_compact_sparse`."""

    __slots__ = ("col_start", "num_cols", "nnz", "rows", "counts", "vals")

    def __init__(self, col_start, num_cols, nnz, rows, counts, vals):
        self.col_start = col_start
        self.num_cols = num_cols
        self.nnz = nnz
        self.rows = rows
        self.counts = counts
        self.vals = vals


def _compact_sparse(ch: SparseChunk, rows_dim: int) -> _CompactChunk:
    """SparseChunk -> wire format: pow2 nnz bucket (bounds recompiles),
    uint16 rows when they fit, integral nonneg values in uint8/uint16
    (exact), per-column counts instead of explicit column ids."""
    bucket = max(1 << 12, 1 << int(ch.nnz - 1).bit_length()) \
        if ch.nnz else 1 << 12
    pad = bucket - ch.nnz
    # narrow BEFORE padding (halves the copy) and pad by slice-assign
    rows_src = ch.rows.astype(np.uint16) if rows_dim < (1 << 16) else ch.rows
    rows_a = np.zeros(bucket, rows_src.dtype)
    rows_a[:ch.nnz] = rows_src
    counts_a = np.append(ch.counts, np.int32(pad))
    vals_a = np.zeros(bucket, np.float32)
    vals_a[:ch.nnz] = ch.vals
    # integral-nonneg-u16-range test in ONE cast+compare: a fractional,
    # negative, non-finite, or >= 2^16 float can never equal its own
    # uint16 cast (which wraps/truncates into [0, 65536)) — 22x faster
    # than the floor-based three-pass check on 25M-nnz panels
    v16 = vals_a.astype(np.uint16)
    if np.array_equal(v16, vals_a):
        vals_a = v16.astype(np.uint8) if int(v16.max(initial=0)) < 256 \
            else v16
    return _CompactChunk(ch.col_start, ch.num_cols, ch.nnz, rows_a,
                         counts_a, vals_a)


@partial(jax.jit, static_argnames=("cfg", "side"))
def _panel_solve(cfg: NMFConfig, side: str, G, F, A_panel, X_warm, warm):
    """Solve one column panel: B = F @ A_panel -> features -> solve.

    ``side``: 'H' or 'W' selects the FactorConfig.  G already includes L2
    and tier-2 terms.  Returns the solved panel (k, panel_cols).
    """
    B = jnp.dot(F, A_panel, precision=PREC)
    return _solve_from_B(cfg, side, G, B, X_warm, warm)


def _panel_train_w(seed_pair, row0, col0, rows, cols, inv_prob: int,
                   mask_zeros: bool, A_panel, transposed: bool,
                   user_m=None):
    """In-jit speckled train weights for a panel whose element (r, c) is
    A[row0 + r, col0 + c] (or A[col0 + c, row0 + r] when ``transposed`` —
    the W-update's A^T panels).  Identical hash to the in-memory path
    (nmf/speckled_cv.hpp via rng.is_holdout_traced).  ``user_m`` is an
    optional panel-aligned bool mask of additionally held-out entries."""
    if inv_prob > 0:
        rr = jnp.arange(rows, dtype=jnp.uint32)[:, None] + jnp.uint32(row0)
        cc = (jnp.arange(cols, dtype=jnp.uint32)[None, :]
              + col0.astype(jnp.uint32))
        i, j = (cc, rr) if transposed else (rr, cc)
        M = rng_mod.is_holdout_traced(seed_pair, i, j, inv_prob)
        if mask_zeros:
            M = M & (A_panel != 0)
    else:
        M = jnp.zeros(A_panel.shape, bool)
    if user_m is not None:
        M = M | user_m
    return (~M).astype(A_panel.dtype)


@partial(jax.jit, static_argnames=("cfg", "side", "inv_prob", "mask_zeros",
                                   "transposed"))
def _panel_solve_cv(cfg: NMFConfig, side: str, F, A_panel, X_warm, warm,
                    seed_pair, col0, user_m=None, G_add=None, *,
                    inv_prob: int, mask_zeros: bool, transposed: bool):
    """Masked panel solve: per-column Gram over train entries only (the
    streaming analog of nmf_cv.masked_mse_solve_batch; reference
    fit_streaming_spz.hpp:267-286).  ``G_add``: shared tier-2 k x k term
    (L21), same algebra as the in-memory path (nmf_cv.py G_add)."""
    from .nmf_cv import masked_mse_solve_batch
    fc = cfg.H if side == "H" else cfg.W
    m, nc = A_panel.shape
    train_w = _panel_train_w(seed_pair, 0, col0, m, nc, inv_prob,
                             mask_zeros, A_panel, transposed, user_m)
    Xw = X_warm * warm.astype(A_panel.dtype)
    X = masked_mse_solve_batch(A_panel, F, train_w, cfg, fc, Xw,
                               G_add=G_add)
    if fc.upper_bound > 0:
        X = feat.apply_upper_bound(X, fc.upper_bound)
    return X


def _panel_valid(shape, valid_rc):
    """(rows, cols) -> bool validity mask for a mesh-padded panel; entries
    beyond the true (vr, vc) extent are zero pads that must leave every
    loss/statistic accumulation.  ``valid_rc=None`` means no padding."""
    if valid_rc is None:
        return None
    vr, vc = valid_rc
    # extents may be traced (the fused cached sweep passes per-panel
    # widths from inside a scan); only short-circuit on static ints
    if isinstance(vr, (int, np.integer)) and isinstance(vc, (int, np.integer)) \
            and (int(vr), int(vc)) == shape:
        return None
    return ((jnp.arange(shape[0]) < vr)[:, None]
            & (jnp.arange(shape[1]) < vc)[None, :])


@partial(jax.jit, static_argnames=("cfg", "inv_prob", "mask_zeros",
                                   "sparse_zeros", "valid_rc"))
def _panel_cv_losses(cfg: NMFConfig, W_T, d, H_panel, A_panel, seed_pair,
                     col0, theta_row, theta_col, user_m=None, *,
                     inv_prob: int, mask_zeros: bool, sparse_zeros: bool,
                     valid_rc=None):
    """(train_loss_sum, n_train, test_loss_sum, n_test) for one forward
    panel — distribution-aware per-entry losses, matching the in-memory CV
    accounting (nmf_cv._fit_masked_jit)."""
    from ..ops import losses
    rec = jnp.dot((W_T * d[:, None]).T, H_panel, precision=PREC)
    theta = losses._expand_theta(theta_row, theta_col, A_panel.shape)
    sq = losses.compute_loss_elements(A_panel, rec, cfg, theta)
    m, nc = A_panel.shape
    train_w = _panel_train_w(seed_pair, 0, col0, m, nc, inv_prob,
                             mask_zeros, A_panel, False, user_m)
    test_w = 1.0 - train_w
    vmask = _panel_valid(A_panel.shape, valid_rc)
    if vmask is not None:
        v = vmask.astype(train_w.dtype)
        train_w = train_w * v
        test_w = test_w * v
    if user_m is not None and inv_prob > 0:
        # CV + user mask: user-masked entries leave BOTH statistics — the
        # test statistic stays a pure speckled-holdout quantity, matching
        # the in-memory accounting (nmf_cv.py; fit_cv.hpp:1391-1393).
        # (For a pure masked fit, inv_prob == 0, the masked entries
        # themselves ARE the reported held-out set.)
        test_w = test_w * (1.0 - user_m.astype(test_w.dtype))
    if sparse_zeros:
        nz = (A_panel != 0).astype(sq.dtype)
        train_w = train_w * nz
    return (jnp.sum(sq * train_w), jnp.sum(train_w),
            jnp.sum(sq * test_w), jnp.sum(test_w))


@partial(jax.jit, static_argnames=("cfg", "side", "active_loss",
                                   "inv_prob", "mask_zeros", "transposed"))
def _panel_solve_irls(cfg: NMFConfig, side: str, F, A_panel, X_warm, warm,
                      th_row, th_col, seed_pair, col0, user_m=None,
                      G_add=None, *, active_loss: Loss, inv_prob: int = 0,
                      mask_zeros: bool = False, transposed: bool = False):
    """IRLS panel solve with fixed dispersion — the reference's chunked
    engine never re-estimates nb_size/theta in streaming mode
    (fit_chunked.hpp:165-172,300-318, weight_zeros=true) and maps GP -> KL.
    With ``inv_prob`` > 0, the speckled train weights join the IRLS weights
    (streaming CV + IRLS, fit_chunked.hpp:280-318)."""
    from .nmf_irls import irls_solve_batch
    fc = cfg.H if side == "H" else cfg.W
    extra_w = None
    if inv_prob > 0 or user_m is not None:
        m, nc = A_panel.shape
        extra_w = _panel_train_w(seed_pair, 0, col0, m, nc, inv_prob,
                                 mask_zeros, A_panel, transposed, user_m)
    Xw = X_warm * warm.astype(A_panel.dtype)
    X = irls_solve_batch(A_panel, F, cfg, active_loss, th_row, th_col,
                         fc, False, extra_w=extra_w, X_warm=Xw,
                         G_add=G_add)
    if fc.upper_bound > 0:
        X = feat.apply_upper_bound(X, fc.upper_bound)
    return X


@partial(jax.jit, static_argnames=("cfg", "valid_rc"))
def _panel_irls_loss(cfg: NMFConfig, W_T, d, H_panel, A_panel,
                     theta_row, theta_col, *, valid_rc=None):
    """Explicit per-entry NLL/deviance of one forward panel
    (fit_chunked.hpp:335-390)."""
    from ..ops import losses
    rec = jnp.dot((W_T * d[:, None]).T, H_panel, precision=PREC)
    theta = losses._expand_theta(theta_row, theta_col, A_panel.shape)
    sq = losses.compute_loss_elements(A_panel, rec, cfg, theta)
    vmask = _panel_valid(A_panel.shape, valid_rc)
    if vmask is not None:
        sq = sq * vmask.astype(sq.dtype)
    return jnp.sum(sq)


@jax.jit
def _panel_zi_impute(F, d, X_warm, A_panel, pi_b, r_b):
    """NB soft imputation of one panel's zeros (the streaming analog of
    nmf_irls.zi_em_step's M-side output; fit_cpu.hpp:1285-1552).

    ``F`` (k, rows) and ``X_warm`` (k, pc) reconstruct the panel as
    S = (F d)^T X_warm; ``pi_b`` / ``r_b`` arrive broadcast-shaped
    ((rows, 1) or (1, pc)).  Zero entries become z * S where
    z = pi / (pi + (1-pi) p0) and p0 = (r/(r+S))^r — exactly the
    in-memory E-step, computed panel-locally so the imputed matrix
    never materializes."""
    S = jnp.maximum(jnp.dot((F * d[:, None]).T, X_warm, precision=PREC),
                    1e-10)
    p0 = (r_b / (r_b + S)) ** r_b
    z = pi_b / (pi_b + (1.0 - pi_b) * p0 + 1e-30)
    is_zero = A_panel == 0
    return jnp.where(is_zero, z * S, A_panel)


@partial(jax.jit, static_argnames=("cfg", "valid_rc"))
def _panel_irls_loss_zi(cfg: NMFConfig, W_T, d, H_panel, A_panel,
                        theta_row, theta_col, pi_b, r_b, *, valid_rc=None):
    """Fused loss + ZI E-step statistics of one forward panel — ONE
    reconstruction GEMM serves both (the dominant FLOPs of the loss
    sweep).  Returns (loss, z row-sums, z col-sums, zero row-counts,
    zero col-counts); the z statistics are accumulated across panels to
    run the pi EM update once per sweep (zi_em_step's pi-update algebra,
    with the post-update model like the in-memory EM placement)."""
    from ..ops import losses
    rec = jnp.dot((W_T * d[:, None]).T, H_panel, precision=PREC)
    theta = losses._expand_theta(theta_row, theta_col, A_panel.shape)
    sq = losses.compute_loss_elements(A_panel, rec, cfg, theta)
    S = jnp.maximum(rec, 1e-10)
    p0 = (r_b / (r_b + S)) ** r_b
    z = pi_b / (pi_b + (1.0 - pi_b) * p0 + 1e-30)
    is_zero = A_panel == 0
    vmask = _panel_valid(A_panel.shape, valid_rc)
    if vmask is not None:
        # mesh pads are synthetic zeros: they must leave the loss AND the
        # ZI dropout statistics (they would otherwise inflate pi)
        sq = sq * vmask.astype(sq.dtype)
        is_zero = is_zero & vmask
    z = jnp.where(is_zero, z, 0.0)
    return (jnp.sum(sq), jnp.sum(z, axis=1), jnp.sum(z, axis=0),
            jnp.sum(is_zero, axis=1), jnp.sum(is_zero, axis=0))


@jax.jit
def _panel_cross_term(W_T, d, H_panel, A_panel):
    """Panel contribution to the loss cross term: sum d_i <W_T A_panel, H>."""
    B = jnp.dot(W_T, A_panel, precision=PREC)          # (k, pc)
    return jnp.sum(d[:, None] * B * H_panel)


@partial(jax.jit, static_argnames=("cfg", "dims"))
def _cached_sweep_mse(cfg: NMFConfig, dims, groups_f, groups_t,
                      W_T, H, d, warm, trAtA):
    """ONE-dispatch steady-state sweep for the plain MSE streaming fit.

    When the wire-resident panel cache holds every panel of both sides,
    the per-panel host loop costs ~450 serialized dispatch groups per
    sweep.  This
    runs the full H-update, W-update, scaling and loss as ONE jitted
    program: lax.scan over the stacked compact panel groups, transposed
    sorted-scatter densify (see _coo_densify_T) + direct B GEMM + solve
    per step.  The loss is the saved-matrix Gram trick
    (fit_cpu.hpp:1710-1753): B_w accumulates during the W scan, so the
    forward panels are NOT re-densified a third time.

    ``groups_*``: tuples of dicts {rows (P, bucket), counts (P, NC+1),
    vals (P, bucket), cs (P,)} — panels grouped by bucket/dtype, columns
    padded to the side-wide NC (extra columns solve against all-zero
    data and land beyond the real region).
    """
    m, n, nc_f, nc_t = dims
    k = W_T.shape[0]
    f32 = jnp.float32

    def side_update(G, F, prev, groups, rows_dim, nc, total, side,
                    collect_b: bool):
        buf = jnp.zeros((k, total + nc), f32)
        b_buf = jnp.zeros((k, total + nc), f32) if collect_b else None
        prev_pad = jnp.zeros((k, total + nc), f32).at[:, :total].set(prev)
        for g in groups:
            def step(carry, xs):
                buf, b_buf = carry
                rows, counts, vals, cs = xs
                A_pT = _coo_densify_T(rows, counts, vals, nrows=rows_dim,
                                      ncols=nc)                 # (nc, rows)
                B = lax.dot_general(F, A_pT, (((1,), (1,)), ((), ())),
                                    precision=PREC)             # (k, nc)
                Xw = lax.dynamic_slice(prev_pad, (0, cs), (k, nc))
                X = _solve_from_B(cfg, side, G, B, Xw, warm)
                buf = lax.dynamic_update_slice(buf, X, (0, cs))
                if b_buf is not None:
                    b_buf = lax.dynamic_update_slice(b_buf, B, (0, cs))
                return (buf, b_buf), None
            (buf, b_buf), _ = lax.scan(
                step, (buf, b_buf),
                (g["rows"], g["counts"], g["vals"], g["cs"]))
        return buf[:, :total], (b_buf[:, :total] if collect_b else None)

    # ---- H update ----
    G = linalg.gram(W_T)
    G, _ = feat.apply_l1_l2(G, jnp.zeros(()), 0.0, cfg.H.L2)
    G = feat.apply_l21(G, H, cfg.H.L21)
    H_new, _ = side_update(G, W_T, H, groups_f, m, nc_f, n, "H", False)
    if cfg.H.angular > 0:
        H_new = feat.apply_angular_posthoc(H_new, cfg.H.angular)
    H_new, d_new = linalg.extract_scaling(H_new, cfg.norm)

    # ---- W update (B_w collected for the saved-matrix loss) ----
    G_w = linalg.gram(H_new)                      # saved for loss
    G2, _ = feat.apply_l1_l2(G_w, jnp.zeros(()), 0.0, cfg.W.L2)
    G2 = feat.apply_l21(G2, W_T, cfg.W.L21)
    W_new, B_w = side_update(G2, H_new, W_T, groups_t, n, nc_t, m, "W",
                             True)
    if cfg.W.angular > 0:
        W_new = feat.apply_angular_posthoc(W_new, cfg.W.angular)
    W_new, d_new = linalg.extract_scaling(W_new, cfg.norm)

    # ---- saved-matrix Gram-trick loss (fit_cpu.hpp:1710-1753) ----
    loss = linalg.mse_loss_from_saved(trAtA, W_new, d_new, B_w, G_w)
    return W_new, H_new, d_new, loss


@partial(jax.jit, static_argnames=("cfg", "dims", "inv_prob",
                                   "mask_zeros"))
def _cached_sweep_cv(cfg: NMFConfig, dims, groups_f, groups_t,
                     W_T, H, d, warm, seed_pair, *, inv_prob: int,
                     mask_zeros: bool):
    """Single-dispatch steady-state sweep for the STREAMING SPECKLED-CV
    fit (no user mask, no IRLS) — the CV analog of _cached_sweep_mse.

    Per-panel holdout masks are derived in-jit from the traced hash
    (identical entries to the host loop's _panel_solve_cv calls); the
    per-panel (train_sse, n_train, test_sse, n_test) quartets are
    returned as one (P, 4) array so the host fetches ONCE per sweep and
    sums in float64 (exact counts).
    """
    m, n, nc_f, nc_t = dims
    k = W_T.shape[0]
    f32 = jnp.float32

    def side_update(F, prev, groups, rows_dim, nc, total, side, transposed,
                    G_add):
        buf = jnp.zeros((k, total + nc), f32)
        prev_pad = jnp.zeros((k, total + nc), f32).at[:, :total].set(prev)
        for g in groups:
            def step(carry, xs):
                rows, counts, vals, cs = xs
                A_p = _coo_densify(rows, counts, vals, nrows=rows_dim,
                                   ncols=nc)
                Xw = lax.dynamic_slice(prev_pad, (0, cs), (k, nc))
                X = _panel_solve_cv(cfg, side, F, A_p, Xw, warm, seed_pair,
                                    cs.astype(jnp.uint32), None, G_add,
                                    inv_prob=inv_prob,
                                    mask_zeros=mask_zeros,
                                    transposed=transposed)
                return lax.dynamic_update_slice(carry, X, (0, cs)), None
            buf, _ = lax.scan(
                step, buf, (g["rows"], g["counts"], g["vals"], g["cs"]))
        return buf[:, :total]

    # ---- H update ----
    H_new = side_update(W_T, H, groups_f, m, nc_f, n, "H", False,
                        feat.tier2_gram_addition(H, cfg.H))
    if cfg.H.angular > 0:
        H_new = feat.apply_angular_posthoc(H_new, cfg.H.angular)
    H_new, d_new = linalg.extract_scaling(H_new, cfg.norm)

    # ---- W update ----
    W_new = side_update(H_new, W_T, groups_t, n, nc_t, m, "W", True,
                        feat.tier2_gram_addition(W_T, cfg.W))
    if cfg.W.angular > 0:
        W_new = feat.apply_angular_posthoc(W_new, cfg.W.angular)
    W_new, d_new = linalg.extract_scaling(W_new, cfg.norm)

    # ---- per-panel CV losses over the forward panels ----
    H_pad = jnp.zeros((k, n + nc_f), f32).at[:, :n].set(H_new)
    parts = []
    for g in groups_f:
        def lstep(carry, xs):
            rows, counts, vals, cs = xs
            A_p = _coo_densify(rows, counts, vals, nrows=m, ncols=nc_f)
            H_panel = lax.dynamic_slice(H_pad, (0, cs), (k, nc_f))
            # the LAST panel is column-padded to nc_f: its pad columns
            # must leave the holdout accounting (the speckled hash knows
            # nothing about padding)
            vc = jnp.minimum(jnp.int32(nc_f), jnp.int32(n) - cs)
            # __wrapped__: the jitted wrapper declares valid_rc static
            # (host callers pass ints); in-scan vc is traced
            out = _panel_cv_losses.__wrapped__(
                cfg, W_new, d_new, H_panel, A_p,
                seed_pair, cs.astype(jnp.uint32), None, None, None,
                inv_prob=inv_prob, mask_zeros=mask_zeros,
                sparse_zeros=False, valid_rc=(jnp.int32(m), vc))
            return carry, jnp.stack(out)
        _, ys = lax.scan(lstep, jnp.zeros((), f32),
                         (g["rows"], g["counts"], g["vals"], g["cs"]))
        parts.append(ys)
    acc = jnp.concatenate(parts, axis=0)          # (P, 4)
    return W_new, H_new, d_new, acc


@partial(jax.jit, static_argnames=("cfg", "dims", "active_loss",
                                   "is_nb", "per_col"))
def _cached_sweep_irls(cfg: NMFConfig, dims, groups_f, groups_t,
                       W_T, H, d, warm, nb_vec, *, active_loss: Loss,
                       is_nb: bool, per_col: bool):
    """Single-dispatch steady-state sweep for the plain streaming IRLS
    fit (fixed dispersion, no CV/mask/ZI) — completes the r5 fused-sweep
    family (_cached_sweep_mse / _cached_sweep_cv).  Returns per-panel NLL
    contributions as a (P,) array: ONE host fetch per sweep, f64 sum."""
    m, n, nc_f, nc_t = dims
    k = W_T.shape[0]
    f32 = jnp.float32
    nb_pad_n = (jnp.zeros((n + nc_f,), f32).at[:n].set(nb_vec)
                if (is_nb and per_col) else None)
    nb_pad_m = (jnp.zeros((m + nc_t,), f32).at[:m].set(nb_vec)
                if (is_nb and not per_col) else None)

    def side_update(F, prev, groups, rows_dim, nc, total, side, transposed):
        buf = jnp.zeros((k, total + nc), f32)
        prev_pad = jnp.zeros((k, total + nc), f32).at[:, :total].set(prev)
        G_add = feat.tier2_gram_addition(prev,
                                         cfg.H if side == "H" else cfg.W)
        for g in groups:
            def step(carry, xs):
                rows, counts, vals, cs = xs
                A_p = _coo_densify(rows, counts, vals, nrows=rows_dim,
                                   ncols=nc)
                Xw = lax.dynamic_slice(prev_pad, (0, cs), (k, nc))
                # theta roles swap on the W side (fit_cpu.hpp:821-833)
                if side == "H":
                    th_row = nb_vec if (is_nb and not per_col) else None
                    th_col = (lax.dynamic_slice(nb_pad_n, (cs,), (nc,))
                              if (is_nb and per_col) else None)
                else:
                    th_row = nb_vec if (is_nb and per_col) else None
                    th_col = (lax.dynamic_slice(nb_pad_m, (cs,), (nc,))
                              if (is_nb and not per_col) else None)
                X = _panel_solve_irls(cfg, side, F, A_p, Xw, warm,
                                      th_row, th_col, None,
                                      cs.astype(jnp.uint32), None, G_add,
                                      active_loss=active_loss,
                                      inv_prob=0, mask_zeros=False,
                                      transposed=transposed)
                return lax.dynamic_update_slice(carry, X, (0, cs)), None
            buf, _ = lax.scan(
                step, buf, (g["rows"], g["counts"], g["vals"], g["cs"]))
        return buf[:, :total]

    H_new = side_update(W_T, H, groups_f, m, nc_f, n, "H", False)
    if cfg.H.angular > 0:
        H_new = feat.apply_angular_posthoc(H_new, cfg.H.angular)
    H_new, d_new = linalg.extract_scaling(H_new, cfg.norm)
    W_new = side_update(H_new, W_T, groups_t, n, nc_t, m, "W", True)
    if cfg.W.angular > 0:
        W_new = feat.apply_angular_posthoc(W_new, cfg.W.angular)
    W_new, d_new = linalg.extract_scaling(W_new, cfg.norm)

    H_pad = jnp.zeros((k, n + nc_f), f32).at[:, :n].set(H_new)
    parts = []
    for g in groups_f:
        def lstep(carry, xs):
            rows, counts, vals, cs = xs
            A_p = _coo_densify(rows, counts, vals, nrows=m, ncols=nc_f)
            H_panel = lax.dynamic_slice(H_pad, (0, cs), (k, nc_f))
            th_row = nb_vec if (is_nb and not per_col) else None
            th_col = (lax.dynamic_slice(nb_pad_n, (cs,), (nc_f,))
                      if (is_nb and per_col) else None)
            vc = jnp.minimum(jnp.int32(nc_f), jnp.int32(n) - cs)
            pl = _panel_irls_loss.__wrapped__(
                cfg, W_new, d_new, H_panel, A_p, th_row, th_col,
                valid_rc=(jnp.int32(m), vc))
            return carry, pl
        _, ys = lax.scan(lstep, jnp.zeros((), f32),
                         (g["rows"], g["counts"], g["vals"], g["cs"]))
        parts.append(ys)
    return W_new, H_new, d_new, jnp.concatenate(parts, axis=0)


def nmf_chunked(loader: Union[DataLoader, str], cfg: NMFConfig, *,
                w_init=None, h_init=None, mask=None, graph_W=None,
                graph_H=None, mesh=None, on_iteration=None,
                checkpoint_path=None, checkpoint_every: int = 1,
                panel_cache: Optional[bool] = None,
                sparse_panels: Optional[bool] = None) -> NMFResult:
    """Streaming ALS over a DataLoader (nmf/fit_chunked.hpp:71).

    ``mask``: optional (m, n) bool, True = held out of training (the
    streaming analog of the in-memory user mask; reference streaming
    accepts mask_sexp, R/RcppExports.R Rcpp_nmf_streaming_spz).
    ``graph_W``/``graph_H``: Laplacians for graph regularization — they
    modify only the k x k Gram, so streaming costs nothing extra
    (reference streaming accepts graph_W_sexp/graph_H_sexp).

    ``mesh``: optional jax.sharding.Mesh — SHARDED STREAMING INGEST, the
    composition the reference cannot express (its chunked engine is
    single-node OpenMP, fit_chunked.hpp:71; SURVEY §5 "chunk ingest ->
    per-host sharded loading").  Each decoded panel is ``device_put``
    with the canonical layout (forward panels P(rows, cols), transpose
    panels P(cols, rows)); the factor tables (k-scaled, small) stay
    replicated, so every panel GEMM/solve is GSPMD-distributed with the
    k x k Gram psums riding ICI.  Panels are zero-padded to
    mesh-divisible shapes; pad columns are sliced off every solve and
    pad entries carry zero validity weight in every loss/ZI statistic,
    so results match the single-device stream to fp32 tolerance.

    ``on_iteration(sweep, train_loss, test_loss)``: per-sweep host
    callback (the loop is host-driven per panel, so sweep callbacks are
    natural — config.hpp:388-392 analog).  ``checkpoint_path``:
    preemption-safe sweep-granular checkpointing — the loop state is
    atomically saved every ``checkpoint_every`` sweeps and resumed
    bit-exactly if the path exists."""
    if isinstance(loader, (str, bytes)):
        loader = SpzLoader(loader)
    m, n = loader.shape
    k = cfg.rank
    cfg.validate()
    if cfg.fused_vmem:
        raise ValueError("fused_vmem is a whole-matrix in-memory fit — "
                         "incompatible with the chunked/streaming engine")

    # ---- sharded ingest setup (mesh mode) ----
    # Factor tables are replicated (k-scaled, tiny); every panel is the
    # big operand and is block-sharded.  Panel pads never pollute real
    # entries: B = F @ panel contracts zero F-columns against pad rows,
    # pad-column solutions are sliced off, and the loss/ZI passes carry
    # explicit validity masks (_panel_valid).
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        mesh_rows = mesh.shape["rows"]
        mesh_cols = mesh.shape["cols"]
        s_fwd = NamedSharding(mesh, P("rows", "cols"))
        s_trp = NamedSharding(mesh, P("cols", "rows"))
        s_rep = NamedSharding(mesh, P())
        m_pad = m + (-m) % mesh_rows      # forward-panel rows
        n_pad = n + (-n) % mesh_cols      # transpose-panel rows
    else:
        mesh_rows = mesh_cols = 1
        m_pad, n_pad = m, n
        s_fwd = s_trp = s_rep = None

    # Panel residency cache: every sweep re-decodes AND re-uploads each
    # panel; when forward + transpose copies fit device memory with
    # headroom, keep the device panels across sweeps instead (the loader
    # still provides sweep 0 — true out-of-core inputs larger than device
    # memory keep streaming every sweep, which is the point of this
    # engine).  This is the difference between per-sweep cost
    # ~bytes(A)/link_bw and ~0.
    #
    # Auto-gate rules (panel_cache=None): device memory must be KNOWN
    # (an unknown limit means "proceed" for the allocation guard but must
    # mean "don't pin the matrix" here — the opposite risk profile), and
    # the footprint is per-device (sharded panels divide across the
    # mesh).  panel_cache=False keeps the documented O(panel) device
    # footprint unconditionally; True forces residency.
    from ..utils.memory import check_dense_alloc, device_hbm_bytes
    if panel_cache is None:
        n_dev = int(np.prod(list(mesh.shape.values()))) if mesh is not None \
            else 1
        n_per = -(-n // n_dev)          # sharded panels divide per device
        if device_hbm_bytes() > 0:
            _cache_panels = check_dense_alloc(2 * m, n_per,
                                              where="device").fits
        else:
            # device memory UNKNOWN (a PJRT client without memory_stats):
            # check_dense_alloc's proceed-on-unknown is right for a guard
            # but wrong for opt-in pinning — fall back to a conservative
            # static bound (well under any accelerator's memory)
            # so genuinely out-of-core inputs are never pinned blind
            _cache_panels = (2.0 * m * n_per * 4) <= 4 * 1024 ** 3
    elif panel_cache == "wire":
        _cache_panels = False           # wire cache gated below
    else:
        _cache_panels = bool(panel_cache)
    _panel_cache: dict = {}
    _panel_meta: dict = {False: {}, True: {}}   # col_start -> num_cols

    # ---- nnz-proportional ingest (sparse device panels) ----
    # Auto rule: loader must expose COO panels and the density must be
    # low enough that COO (12 B/nnz) beats dense (4 B/element) with
    # margin — density < 0.15 gives >= 2.2x less link traffic.  Mesh
    # mode keeps dense panels (the scatter would gather across shards).
    if sparse_panels and mesh is not None:
        raise ValueError("sparse_panels is incompatible with mesh= "
                         "(sharded streams ship dense panels)")
    if sparse_panels is None:
        _nnz = loader.nnz() if loader.supports_sparse else None
        _sparse_mode = (mesh is None and _nnz is not None
                        and _nnz < 0.15 * m * n)
    else:
        if sparse_panels and not loader.supports_sparse:
            raise ValueError(
                f"{type(loader).__name__} cannot deliver sparse panels")
        _sparse_mode = bool(sparse_panels)

    # ---- wire-resident panel cache (sparse mode) ----
    # When the DENSE matrix cannot live on device (the flagship's 43 GB)
    # the COMPACT wire arrays often can (u16/i32 rows + u8 vals + counts:
    # ~3-8 B/nnz, bucket-padded).  Cache those on device during sweep 1
    # and densify on device per use — sweeps 2+ then run with ZERO host
    # decode and ZERO link upload.  Opportunistic with a byte budget: if the
    # running total exceeds it, the cache is dropped and the fit falls
    # back to the strict O(panel) footprint.  panel_cache="wire" forces
    # it; panel_cache=False disables (as it does the dense cache).
    _wire_cache = False
    _wire_budget = 0
    if _sparse_mode and not _cache_panels and panel_cache is not False:
        from ..utils.memory import device_hbm_bytes as _hbm
        hbm = _hbm()
        _wire_budget = int(0.55 * hbm) if hbm > 0 else 4 * 1024 ** 3
        _wire_cache = True
    _wire_bytes = 0

    class _CachedChunk:
        __slots__ = ("col_start", "num_cols", "data")

        def __init__(self, cs, nc):
            self.col_start = cs
            self.num_cols = nc
            self.data = None

    def _panels(transposed: bool, prefetch: bool = True):
        """Iterate panels; once the residency cache holds every panel of
        a side, yield metadata-only chunks so later sweeps skip the host
        decode entirely (the Prefetcher would otherwise decompress the
        whole matrix per sweep even on full cache hits)."""
        meta = _panel_meta[transposed]
        if (_cache_panels or _wire_cache) and meta and all(
                (transposed, cs) in _panel_cache for cs in meta):
            for cs in sorted(meta):
                yield _CachedChunk(cs, meta[cs])
            return
        if prefetch:
            rows_dim = (n if transposed else m)
            it = Prefetcher(
                loader, transpose=transposed, sparse=_sparse_mode,
                transform=((lambda ch: _compact_sparse(ch, rows_dim))
                           if _sparse_mode else None))
        elif _sparse_mode:
            rows_dim = (n if transposed else m)
            it = (_compact_sparse(loader.chunk_coo(c, transposed),
                                  rows_dim)
                  for c in range(loader.num_chunks(transposed)))
        else:
            it = loader.iter_chunks(transpose=transposed)
        try:
            for ch in it:
                meta[ch.col_start] = ch.num_cols
                yield ch
        finally:
            if prefetch:
                it.close()

    def _chunk_finite(ch) -> bool:
        vals = ch.vals if isinstance(ch, (SparseChunk, _CompactChunk)) \
            else ch.data
        if vals.dtype.kind == "u":      # compacted integral values
            return True
        return bool(np.isfinite(vals).all())

    def _put_panel(ch, transposed: bool):
        """Place one panel on device: dense chunks are padded to
        mesh-divisible shape and device_put with the canonical sharding;
        SparseChunks ship only (rows, cols, vals) — 12 bytes/nnz instead
        of 4 bytes/element — and densify ON DEVICE with a scatter-add,
        so the dense GEMM path downstream is identical (the
        nnz-proportional ingest option, sp_gpu_bridge.cu analog)."""
        nonlocal _wire_cache, _wire_bytes
        col_start = ch.col_start
        key = (transposed, col_start)
        if (_cache_panels or _wire_cache) and col_start is not None:
            hit = _panel_cache.get(key)
            if hit is not None:
                if _cache_panels:
                    return hit
                rows_d, counts_d, vals_d, nc = hit   # wire tuple
                return _coo_densify(rows_d, counts_d, vals_d,
                                    nrows=(n if transposed else m),
                                    ncols=nc)
        if isinstance(ch, (SparseChunk, _CompactChunk)):
            rows_dim = (n if transposed else m)
            if isinstance(ch, SparseChunk):     # non-prefetch direct use
                ch = _compact_sparse(ch, rows_dim)
            rows_d = jnp.asarray(ch.rows)
            counts_d = jnp.asarray(ch.counts)
            vals_d = jnp.asarray(ch.vals)
            if _wire_cache and col_start is not None:
                _wire_bytes += (ch.rows.nbytes + ch.counts.nbytes
                                + ch.vals.nbytes)
                if _wire_bytes > _wire_budget:
                    # over budget: drop the whole wire cache and stop —
                    # strict O(panel) device footprint from here on
                    for wk in [kk for kk, vv in _panel_cache.items()
                               if isinstance(vv, tuple)]:
                        del _panel_cache[wk]
                    _wire_cache = False
                else:
                    _panel_cache[key] = (rows_d, counts_d, vals_d,
                                         ch.num_cols)
            out = _coo_densify(rows_d, counts_d, vals_d, nrows=rows_dim,
                               ncols=ch.num_cols)
        elif mesh is None:
            out = jnp.asarray(ch.data)
        else:
            block = ch.data
            rows_pad = n_pad if transposed else m_pad
            pc = block.shape[1]
            pc_pad = pc + (-pc) % (mesh_rows if transposed else mesh_cols)
            if block.shape[0] != rows_pad or pc_pad != pc:
                blk = np.zeros((rows_pad, pc_pad), np.float32)
                blk[:block.shape[0], :pc] = block
            else:
                blk = np.ascontiguousarray(block, dtype=np.float32)
            out = jax.device_put(blk, s_trp if transposed else s_fwd)
        if _cache_panels and col_start is not None:
            _panel_cache[key] = out
        return out

    def _pad_cols(nc: int, transposed: bool) -> int:
        if mesh is None:
            return 0
        return (-nc) % (mesh_rows if transposed else mesh_cols)

    def _warm_slice(F, cs: int, nc: int, transposed: bool):
        """X warm-start panel: slice of the factor being solved, zero-
        padded to the panel's padded width."""
        X = jax.lax.dynamic_slice_in_dim(F, cs, nc, axis=1)
        pc = _pad_cols(nc, transposed)
        return jnp.pad(X, ((0, 0), (0, pc))) if pc else X

    def _pad_f(F, rows_pad: int):
        """Replicated, row-padded copy of a factor table for panel ops."""
        if mesh is None:
            return F
        if F.shape[1] != rows_pad:
            F = jnp.pad(F, ((0, 0), (0, rows_pad - F.shape[1])))
        return jax.device_put(F, s_rep)

    def _unpad_x(X, nc: int):
        """Slice a solved panel back to its true width, replicated."""
        if mesh is None:
            return X
        if X.shape[1] != nc:
            X = X[:, :nc]
        return jax.device_put(X, s_rep)

    def _pad1(v, target: int, fill: float = 1.0):
        """Pad a per-row/col parameter vector to a padded panel dim (the
        fill value is masked out of every statistic)."""
        if v is None or v.shape[0] == target:
            return v
        return jnp.pad(v, (0, target - v.shape[0]), constant_values=fill)

    if cfg.bf16_data:
        raise ValueError("bf16_data is not supported on the streaming "
                         "path; use the in-memory fit")
    use_irls = cfg.requires_irls()
    if cfg.symmetric:
        raise NotImplementedError(
            "symmetric NMF needs the full square matrix; use the in-memory "
            "path")
    graph_W = (jnp.asarray(np.asarray(
        graph_W.todense() if hasattr(graph_W, "todense") else graph_W,
        np.float32)) if graph_W is not None else None)
    graph_H = (jnp.asarray(np.asarray(
        graph_H.todense() if hasattr(graph_H, "todense") else graph_H,
        np.float32)) if graph_H is not None else None)
    if (graph_W is not None or graph_H is not None) and \
            (cfg.is_cv() or mask is not None or use_irls):
        raise NotImplementedError(
            "streaming graph regularization requires the shared-Gram MSE "
            "path (no CV/mask/IRLS), like the reference chunked engine")
    if use_irls and cfg.has_zi() and (cfg.loss != Loss.NB or cfg.is_cv()
                                      or mask is not None or cfg.mask_zeros):
        # NB+ZI streams (panel-local E-step, below); GP-family ZI needs the
        # per-iteration theta the chunked engine deliberately freezes, and
        # ZI+CV/mask/mask_zeros accounting needs the full matrix — the
        # imputation would also destroy the zeros mask_zeros keys on.
        # In-memory only (the reference chunked engine has NO ZI branch
        # at all, fit_chunked.hpp)
        raise NotImplementedError(
            "streaming zero-inflation supports loss='nb' without "
            "CV/mask/mask_zeros; use the in-memory path otherwise")
    active_loss = Loss.KL if cfg.loss == Loss.GP else cfg.loss
    per_col = cfg.dispersion == Dispersion.PER_COL
    is_nb = cfg.loss == Loss.NB
    # fixed dispersion, like the reference chunked engine
    # (fit_chunked.hpp:165-172): per-row (or per-col) NB size at its init
    nb_vec = (jnp.full((n if per_col else m,), cfg.nb_size_init,
                       jnp.float32) if is_nb else None)

    # ---- sweep-granular checkpoint resume ----
    _resume = None
    if checkpoint_path is not None:
        if int(checkpoint_every) < 1:
            raise ValueError("checkpoint_every must be >= 1")
        import os as _os
        from ..utils.checkpoint import load_stream_state
        if _os.path.exists(checkpoint_path):
            _resume = load_stream_state(checkpoint_path, cfg)
            if _resume["W_T"].shape != (k, m) or \
                    _resume["H"].shape != (k, n):
                raise ValueError(
                    "checkpoint factor shapes do not match the data")

    # ---- streaming NB zero-inflation (beyond the reference, which has no
    # chunked ZI): panel-local E-step imputation + one pi EM update per
    # sweep.  pi init = min(zero_rate * 0.5, 0.3) exactly like the
    # in-memory _zi_pi_init (fit_cpu.hpp:355-400), streamed in a pre-pass.
    is_zi = use_irls and cfg.has_zi()
    zi_row = cfg.zi == ZI.ROW
    pi_vec = None
    if is_zi:
        if cfg.zi_em_iters > 1:
            import warnings
            warnings.warn(
                f"streaming ZI runs ONE pi EM update per sweep; "
                f"zi_em_iters={cfg.zi_em_iters} applies to the in-memory "
                "path only")
        if _resume is not None and _resume.get("pi_vec") is not None:
            pi_vec = jnp.asarray(_resume["pi_vec"])
        else:
            zc_row = np.zeros((m,), np.float64)
            zc_col = np.zeros((n,), np.float64)
            for ch in loader.iter_chunks(transpose=False):
                zp = np.asarray(ch.data) == 0
                zc_row += zp.sum(axis=1)
                zc_col[ch.col_start:ch.col_start + ch.num_cols] += \
                    zp.sum(axis=0)
            rate = (zc_row / n) if zi_row else (zc_col / m)
            pi_vec = jnp.asarray(
                np.minimum(rate * 0.5, 0.3).astype(np.float32))

    def _zi_bcast(cs, nc, transposed):
        """(pi_b, r_b) broadcast terms for one panel ((rows, 1) / (1, pc));
        forward panels hold columns of A, transpose panels columns of A^T
        (= rows of A), so the row/col roles swap."""
        if transposed:
            pi_b = (pi_vec[cs:cs + nc][None, :] if zi_row
                    else pi_vec[:, None])
            r_b = (nb_vec[:, None] if per_col
                   else nb_vec[cs:cs + nc][None, :])
        else:
            pi_b = (pi_vec[:, None] if zi_row
                    else pi_vec[cs:cs + nc][None, :])
            r_b = (nb_vec[cs:cs + nc][None, :] if per_col
                   else nb_vec[:, None])
        if mesh is not None:
            rows_pad = n_pad if transposed else m_pad
            nc_pad = nc + _pad_cols(nc, transposed)

            def fix(x, fill):
                pr = rows_pad - x.shape[0] if x.shape[0] != 1 else 0
                pc = nc_pad - x.shape[1] if x.shape[1] != 1 else 0
                if pr or pc:
                    x = jnp.pad(x, ((0, pr), (0, pc)),
                                constant_values=fill)
                return x
            # pad values are arbitrary (masked from every statistic);
            # 0.5/1.0 keep the E-step algebra away from 0/0
            pi_b, r_b = fix(pi_b, 0.5), fix(r_b, 1.0)
        return pi_b, r_b

    if _resume is not None:
        W_T0 = _resume["W_T"]
        H0 = _resume["H"]
        d0 = _resume["d"]
    elif cfg.init_mode in (1, 2) and w_init is None:
        # SVD init out of core: the reference decompresses the FULL matrix
        # (with a RAM check + random fallback, fit_streaming_spz.hpp);
        # here the init SVD itself streams over the loader panels
        from .svd import streaming_svd
        # both init modes use the streaming GKB Lanczos (streaming_svd has
        # no irlba restart; the leading subspace is the same)
        sres = streaming_svd(loader, cfg.rank, method="lanczos",
                             seed=cfg.seed)
        sq = np.sqrt(np.maximum(np.asarray(sres.d, np.float64), 0.0))
        W_T0 = (np.abs(np.asarray(sres.U)) * sq[None, :]).T.astype(np.float32)
        H0 = (np.abs(np.asarray(sres.V)) * sq[None, :]).T.astype(np.float32)
        if W_T0.shape[0] < k:
            fill_seed = 54321 if cfg.seed == 0 else cfg.seed + 999
            pad_w = rng_mod.fill_uniform(fill_seed, k - W_T0.shape[0], m)
            pad_h = rng_mod.fill_uniform(fill_seed, k - H0.shape[0], n,
                                         offset=(k - H0.shape[0]) * m)
            W_T0 = np.vstack([W_T0, pad_w])
            H0 = np.vstack([H0, pad_h])
        d0 = np.ones((k,), np.float32)
    else:
        W_T0, H0, d0 = init_factors(cfg, m, n, A=None, w_init=w_init,
                                    h_init=h_init)
    W_T = jnp.asarray(W_T0)
    H = jnp.asarray(H0)
    d = jnp.asarray(d0)

    # streaming speckled CV (fit_streaming_spz.hpp:129-386): the panel
    # holdout mask is derived in-jit from the traced hash, so no mask is
    # ever built host-side — identical entries to the in-memory CV path
    is_cv = cfg.is_cv()
    seed_pair = (jnp.asarray(rng_mod.seed_to_u32_pair(
        int(np.uint32(cfg.cv_seed)))) if is_cv else None)
    inv_prob = int(1.0 / cfg.test_fraction) if is_cv else 0
    cfgs = cfg.device_static()

    if mask is not None:
        if hasattr(mask, "todense"):
            mask = np.asarray(mask.todense())
        mask = np.asarray(mask).astype(bool)
        if mask.shape != (m, n):
            raise ValueError(f"mask shape {mask.shape} != data {(m, n)}")
    has_mask = mask is not None
    use_masked = is_cv or has_mask

    def _mask_panel(cs, nc, transposed):
        if not has_mask:
            return None
        sl = (mask[cs:cs + nc, :].T if transposed
              else mask[:, cs:cs + nc])
        if mesh is not None:
            rows_pad = n_pad if transposed else m_pad
            pc_pad = nc + _pad_cols(nc, transposed)
            if sl.shape != (rows_pad, pc_pad):
                out = np.zeros((rows_pad, pc_pad), bool)
                out[:sl.shape[0], :nc] = sl
                sl = out
        return jnp.asarray(np.ascontiguousarray(sl))

    trAtA = loader.trace_sq()

    if _resume is not None:
        prev_loss = _resume["prev_loss"]
        best_test = _resume["best_test"]
        best_iter = _resume["best_iter"]
        patience = _resume["patience"]
        hist = list(_resume["hist"])
        test_hist = list(_resume["test_hist"])
        converged = _resume["converged"]
        it_start = _resume["it"]
    else:
        prev_loss = np.inf
        best_test = np.inf
        best_iter = -1
        patience = 0
        hist = []
        test_hist = []
        converged = False
        it_start = 0
    # ---- single-dispatch cached-sweep fast path (plain MSE + wire cache) ----
    _stacks_built: dict = {}

    def _fast_ready() -> bool:
        if "g" in _stacks_built:
            return True        # stacks supersede the per-panel entries
        if (has_mask or cfg.projective or mesh is not None
                or graph_W is not None or graph_H is not None):
            return False
        if use_irls and (is_zi or is_cv):
            # ZI needs per-panel imputation state; CV+IRLS keeps the
            # per-panel loop (bounded exclusion)
            return False
        for t in (False, True):
            meta = _panel_meta[t]
            if not meta:
                return False
            css = sorted(meta)
            nc_max = max(meta.values())
            for i, cs in enumerate(css):
                e = _panel_cache.get((t, cs))
                if e is None or not isinstance(e, tuple):
                    return False
                # only the LAST panel may be partial (its column padding
                # then lies entirely beyond the real region)
                if i < len(css) - 1 and meta[cs] != nc_max:
                    return False
        return True

    def _wire_stacks():
        if "g" in _stacks_built:
            return _stacks_built["g"]
        sides = []
        dims = []
        for t in (False, True):
            meta = _panel_meta[t]
            nc_max = int(max(meta.values()))
            groups: dict = {}
            for cs in sorted(meta):
                rows_d, counts_d, vals_d, nc = _panel_cache[(t, cs)]
                if nc < nc_max:   # pad counts to NC+1, bucket-pad stays last
                    counts_d = jnp.concatenate([
                        counts_d[:-1],
                        jnp.zeros((nc_max - nc,), counts_d.dtype),
                        counts_d[-1:]])
                key = (rows_d.shape[0], str(rows_d.dtype), str(vals_d.dtype))
                groups.setdefault(key, []).append(
                    (cs, rows_d, counts_d, vals_d))
            side = []
            for key in list(groups):
                items = groups.pop(key)   # drop the dict's refs too
                # stack ONE group at a time and free its per-panel source
                # buffers immediately: stacking copies, and holding both
                # the full per-panel set and the full stacked set at once
                # OOMs the 469M-nnz flagship (peak = cache + largest
                # group instead of 2x cache)
                g = {"rows": jnp.stack([r for _, r, _, _ in items]),
                     "counts": jnp.stack([c for _, _, c, _ in items]),
                     "vals": jnp.stack([v for _, _, _, v in items]),
                     "cs": jnp.asarray([cs for cs, _, _, _ in items],
                                       jnp.int32)}
                jax.block_until_ready(g["rows"])
                for cs, _, _, _ in items:
                    _panel_cache.pop((t, cs), None)
                del items
                side.append(g)
            groups.clear()
            sides.append(tuple(side))
            dims.append(nc_max)
        _stacks_built["g"] = (sides[0], sides[1],
                              (m, n, dims[0], dims[1]))
        return _stacks_built["g"]

    done_sweeps = it_start
    for it in range(it_start, cfg.max_iter):
        if converged:
            break
        warm = jnp.bool_(it > 0)
        stop = False

        _fast_loss = None
        _fast_cv_acc = None
        _fast_irls_parts = None
        if _fast_ready():
            _gf, _gt, _sdims = _wire_stacks()
            if use_irls:
                W_T, H, d, _fast_irls_parts = _cached_sweep_irls(
                    cfgs, _sdims, _gf, _gt, W_T, H, d, warm, nb_vec,
                    active_loss=active_loss, is_nb=is_nb,
                    per_col=per_col)
                _fast_loss = _fast_irls_parts  # marks the sweep as done
            elif is_cv:
                W_T, H, d, _fast_cv_acc = _cached_sweep_cv(
                    cfgs, _sdims, _gf, _gt, W_T, H, d, warm, seed_pair,
                    inv_prob=inv_prob, mask_zeros=cfg.mask_zeros)
                _fast_loss = _fast_cv_acc      # marks the sweep as done
            else:
                W_T, H, d, _fast_loss = _cached_sweep_mse(
                    cfgs, _sdims, _gf, _gt, W_T, H, d, warm,
                    jnp.float32(trAtA))

        if _fast_loss is None:
            # ---- H-update over forward panels ----
            G_add_H = G_add_W = None
            if not use_masked and not use_irls:
                G = linalg.gram(W_T)
                G, _ = feat.apply_l1_l2(G, jnp.zeros(()), 0.0, cfg.H.L2)
                G = feat.apply_l21(G, H, cfg.H.L21)
                G = feat.apply_graph_reg(G, graph_H, H, cfg.H.graph_lambda)
            else:
                # L21 rides the per-column Grams as the shared tier-2 k x k
                # term, exactly like the in-memory masked/IRLS paths (graph
                # reg is rejected above on these paths)
                G_add_H = feat.tier2_gram_addition(H, cfg.H)
                G_add_W = feat.tier2_gram_addition(W_T, cfg.W)
            H_parts = {}
            W_T_f = _pad_f(W_T, m_pad)
            for ch in _panels(False):
                if it == 0 and not _chunk_finite(ch):
                    # streamed panels (e.g. .spz) bypass the in-memory NaN
                    # auto-mask, so a corrupt/NaN file must fail loudly here
                    # instead of producing NaN factors (round-2 review #3)
                    raise ValueError(
                        f"non-finite values in columns "
                        f"{ch.col_start}..{ch.col_start + ch.num_cols}; "
                        "streaming cannot auto-mask NaN/Inf — clean the data "
                        "or fit in-memory with mask=")
                A_panel = _put_panel(ch, False)
                X_warm = _warm_slice(H, ch.col_start, ch.num_cols, False)
                if cfg.projective:
                    H_parts[ch.col_start] = _unpad_x(jnp.dot(
                        W_T_f * d[:, None], A_panel, precision=PREC),
                        ch.num_cols)
                elif use_irls:
                    th_row = (_pad1(nb_vec, m_pad)
                              if (is_nb and not per_col) else None)
                    th_col = (_pad1(jax.lax.dynamic_slice_in_dim(
                        nb_vec, ch.col_start, ch.num_cols),
                        ch.num_cols + _pad_cols(ch.num_cols, False))
                        if (is_nb and per_col) else None)
                    if is_zi and it > 0:
                        # solves see the soft-imputed panel (in-memory: the
                        # iter>=1 solves read state.A_imp)
                        pi_b, r_b = _zi_bcast(ch.col_start, ch.num_cols, False)
                        A_panel = _panel_zi_impute(W_T_f, d, X_warm, A_panel,
                                                   pi_b, r_b)
                    H_parts[ch.col_start] = _unpad_x(_panel_solve_irls(
                        cfgs, "H", W_T_f, A_panel, X_warm, warm, th_row, th_col,
                        seed_pair, jnp.uint32(ch.col_start),
                        _mask_panel(ch.col_start, ch.num_cols, False),
                        G_add_H,
                        active_loss=active_loss, inv_prob=inv_prob,
                        mask_zeros=cfg.mask_zeros, transposed=False),
                        ch.num_cols)
                elif use_masked:
                    H_parts[ch.col_start] = _unpad_x(_panel_solve_cv(
                        cfgs, "H", W_T_f, A_panel, X_warm, warm, seed_pair,
                        jnp.uint32(ch.col_start),
                        _mask_panel(ch.col_start, ch.num_cols, False),
                        G_add_H, inv_prob=inv_prob,
                        mask_zeros=cfg.mask_zeros, transposed=False),
                        ch.num_cols)
                else:
                    H_parts[ch.col_start] = _unpad_x(
                        _panel_solve(cfg, "H", G, W_T_f, A_panel, X_warm, warm),
                        ch.num_cols)
            H = jnp.concatenate([H_parts[cs] for cs in sorted(H_parts)], axis=1)
            if cfg.H.angular > 0:
                H = feat.apply_angular_posthoc(H, cfg.H.angular)
            H, d = linalg.extract_scaling(H, cfg.norm)

            # ---- W-update over transpose panels ----
            G_w = linalg.gram(H)                             # saved for loss
            if not use_masked and not use_irls:
                G2, _ = feat.apply_l1_l2(G_w, jnp.zeros(()), 0.0, cfg.W.L2)
                G2 = feat.apply_l21(G2, W_T, cfg.W.L21)
                G2 = feat.apply_graph_reg(G2, graph_W, W_T, cfg.W.graph_lambda)
            W_parts = {}
            H_f = _pad_f(H, n_pad)
            for ch in _panels(True):
                At_panel = _put_panel(ch, True)  # (n, pc) cols of A^T
                X_warm = _warm_slice(W_T, ch.col_start, ch.num_cols, True)
                if use_irls:
                    th_row = (_pad1(nb_vec, n_pad)
                              if (is_nb and per_col) else None)
                    th_col = (_pad1(jax.lax.dynamic_slice_in_dim(
                        nb_vec, ch.col_start, ch.num_cols),
                        ch.num_cols + _pad_cols(ch.num_cols, True))
                        if (is_nb and not per_col) else None)
                    if is_zi and it > 0:
                        pi_b, r_b = _zi_bcast(ch.col_start, ch.num_cols, True)
                        At_panel = _panel_zi_impute(H_f, d, X_warm, At_panel,
                                                    pi_b, r_b)
                    W_parts[ch.col_start] = _unpad_x(_panel_solve_irls(
                        cfgs, "W", H_f, At_panel, X_warm, warm, th_row, th_col,
                        seed_pair, jnp.uint32(ch.col_start),
                        _mask_panel(ch.col_start, ch.num_cols, True),
                        G_add_W,
                        active_loss=active_loss, inv_prob=inv_prob,
                        mask_zeros=cfg.mask_zeros, transposed=True),
                        ch.num_cols)
                elif use_masked:
                    W_parts[ch.col_start] = _unpad_x(_panel_solve_cv(
                        cfgs, "W", H_f, At_panel, X_warm, warm, seed_pair,
                        jnp.uint32(ch.col_start),
                        _mask_panel(ch.col_start, ch.num_cols, True),
                        G_add_W, inv_prob=inv_prob,
                        mask_zeros=cfg.mask_zeros, transposed=True),
                        ch.num_cols)
                else:
                    W_parts[ch.col_start] = _unpad_x(
                        _panel_solve(cfg, "W", G2, H_f, At_panel, X_warm, warm),
                        ch.num_cols)
            W_T = jnp.concatenate([W_parts[cs] for cs in sorted(W_parts)], axis=1)
            if cfg.W.angular > 0:
                W_T = feat.apply_angular_posthoc(W_T, cfg.W.angular)
            W_T, d = linalg.extract_scaling(W_T, cfg.norm)

        # ---- loss ----
        W_T_l = _pad_f(W_T, m_pad) if mesh is not None else W_T

        def _vrc(nc):
            # validity extent of a (possibly padded) forward loss panel
            return (m, nc) if mesh is not None else None

        if use_irls and not is_cv and not has_mask:
            tot_parts = []       # per-panel device scalars; f64 host sum
            if _fast_irls_parts is not None:
                tot = float(np.asarray(_fast_irls_parts, np.float64).sum())
            elif is_zi:
                zs_row = np.zeros((m,), np.float64)
                zs_col = np.zeros((n,), np.float64)
                zn_row = np.zeros((m,), np.float64)
                zn_col = np.zeros((n,), np.float64)
            for ch in ([] if _fast_irls_parts is not None
                       else _panels(False, prefetch=False)):
                cs, nc = ch.col_start, ch.num_cols
                th_row = (_pad1(nb_vec, m_pad)
                          if (is_nb and not per_col) else None)
                th_col = (_pad1(nb_vec[cs:cs + nc],
                                nc + _pad_cols(nc, False))
                          if (is_nb and per_col) else None)
                A_panel = _put_panel(ch, False)
                H_panel = _warm_slice(H, cs, nc, False)
                if is_zi:
                    pi_b, r_b = _zi_bcast(cs, nc, False)
                    pl, sr, sc, cr, cc = _panel_irls_loss_zi(
                        cfgs, W_T_l, d, H_panel, A_panel, th_row, th_col,
                        pi_b, r_b, valid_rc=_vrc(nc))
                    tot_parts.append(pl)
                    zs_row += np.asarray(sr)[:m]
                    zn_row += np.asarray(cr)[:m]
                    zs_col[cs:cs + nc] += np.asarray(sc)[:nc]
                    zn_col[cs:cs + nc] += np.asarray(cc)[:nc]
                else:
                    tot_parts.append(_panel_irls_loss(
                        cfgs, W_T_l, d, H_panel, A_panel, th_row, th_col,
                        valid_rc=_vrc(nc)))
            if _fast_irls_parts is None:
                tot = float(np.asarray(jnp.stack(tot_parts),
                                       np.float64).sum()) if tot_parts \
                    else 0.0
            if is_zi:
                # pi M-step (zi_em_step's update rule, once per sweep)
                if zi_row:
                    new_pi = np.clip(zs_row / n, 0.001, 0.999)
                    keep = zn_row > 0
                else:
                    new_pi = np.clip(zs_col / m, 0.001, 0.999)
                    keep = zn_col > 0
                pi_vec = jnp.asarray(np.where(
                    keep, new_pi, np.asarray(pi_vec)).astype(np.float32))
            loss = tot
            hist.append(loss)
            rel = abs(prev_loss - loss) / (abs(prev_loss) + 1e-15)
            if it > 0 and rel < cfg.tol:
                patience += 1
                if patience >= cfg.patience:
                    converged = True
                    stop = True
            else:
                patience = 0
            prev_loss = loss

        elif use_masked or use_irls:
            acc_parts = ([] if _fast_cv_acc is None
                         else [_fast_cv_acc])   # fused sweep: already (P, 4)
            for ch in ([] if _fast_cv_acc is not None
                       else _panels(False, prefetch=False)):
                cs, nc = ch.col_start, ch.num_cols
                th_row = (_pad1(nb_vec, m_pad)
                          if (is_nb and not per_col) else None)
                th_col = (_pad1(nb_vec[cs:cs + nc],
                                nc + _pad_cols(nc, False))
                          if (is_nb and per_col) else None)
                out = _panel_cv_losses(
                    cfgs, W_T_l, d,
                    _warm_slice(H, cs, nc, False),
                    _put_panel(ch, False), seed_pair,
                    jnp.uint32(cs), th_row, th_col,
                    _mask_panel(cs, nc, False),
                    inv_prob=inv_prob,
                    mask_zeros=cfg.mask_zeros, sparse_zeros=False,
                    valid_rc=_vrc(nc))
                acc_parts.append(jnp.stack([out[0], out[1],
                                            out[2], out[3]]))
            # single device fetch; float64 host sum keeps the entry COUNTS
            # exact and the SSE accumulation below fp32 drift (r5 review)
            acc = (np.asarray(_fast_cv_acc, np.float64).sum(axis=0)
                   if _fast_cv_acc is not None
                   else np.asarray(jnp.stack(acc_parts),
                                   np.float64).sum(axis=0))
            tr_sse, tr_n, te_sse, te_n = [float(v) for v in acc]
            loss = tr_sse / max(tr_n, 1.0)
            test_loss = te_sse / max(te_n, 1.0)
            hist.append(loss)
            test_hist.append(test_loss)
            conv_loss = test_loss if is_cv else loss
            if is_cv:
                if test_loss < best_test:
                    best_test = test_loss
                    best_iter = it
                    patience = 0
                else:
                    patience += 1
            rel = abs(prev_loss - conv_loss) / (abs(prev_loss) + 1e-15)
            prev_loss = conv_loss
            if not is_cv:
                # consecutive sub-tol iterations only (same reset rule as
                # the other two loss branches)
                if it > 0 and rel < cfg.tol:
                    patience += 1
                else:
                    patience = 0
            if (is_cv and (patience >= cfg.cv_patience
                           or (it > 0 and rel < cfg.tol))) or \
               (not is_cv and patience >= cfg.patience):
                converged = True
                stop = True

        else:
            if _fast_loss is not None:
                # the cached sweep computed the Gram-trick loss in-jit
                loss = float(_fast_loss)
            else:
                # accumulate the cross term ON DEVICE: float() per panel
                # would be a host round-trip per panel
                cross_d = jnp.zeros((), jnp.float32)
                for ch in _panels(False, prefetch=False):
                    cross_d = cross_d + _panel_cross_term(
                        W_T_l, d,
                        _warm_slice(H, ch.col_start, ch.num_cols, False),
                        _put_panel(ch, False))
                cross = float(cross_d)
                G_wt = linalg.gram(W_T)
                recon = float(jnp.sum((d[:, None] * d[None, :])
                                      * G_wt * G_w))
                loss = trAtA - 2.0 * cross + recon
            hist.append(loss)

            rel = abs(prev_loss - loss) / (abs(prev_loss) + 1e-15)
            if it > 0 and rel < cfg.tol:
                patience += 1
                if patience >= cfg.patience:
                    converged = True
                    stop = True
            else:
                patience = 0
            prev_loss = loss

        # ---- per-sweep observability: the loop is host-driven, so sweep
        # boundaries carry callbacks and preemption-safe checkpoints
        # (round-2 review: streaming fits were observability-dark) ----
        done_sweeps = it + 1
        if on_iteration is not None:
            on_iteration(it + 1, float(hist[-1]),
                         float(test_hist[-1]) if test_hist
                         else float("nan"))
        if checkpoint_path is not None and (
                (it + 1) % int(checkpoint_every) == 0 or stop
                or it + 1 == cfg.max_iter):
            from ..utils.checkpoint import save_stream_state
            save_stream_state(
                checkpoint_path, cfg, W_T=W_T, H=H, d=d, it=it + 1,
                prev_loss=prev_loss, patience=patience,
                best_test=best_test, best_iter=best_iter, hist=hist,
                test_hist=test_hist, pi_vec=pi_vec, converged=converged)
        if stop:
            break

    res = NMFResult(
        W=np.asarray(W_T).T, d=np.asarray(d), H=np.asarray(H),
        iterations=done_sweeps,
        converged=converged,
        train_loss=float(hist[-1]) if hist else float("nan"),
        test_loss=float(test_hist[-1]) if test_hist else float("nan"),
        best_iter=best_iter,
        loss_history=np.asarray(hist, dtype=np.float64),
        test_loss_history=(np.asarray(test_hist, dtype=np.float64)
                           if test_hist else None),
    )
    if is_cv:
        res.misc["best_test_loss"] = float(best_test)
    if is_nb:
        # fixed at init in streaming mode, like the reference chunked engine
        res.theta = np.asarray(nb_vec)
    if is_zi:
        if zi_row:
            res.pi_row = np.asarray(pi_vec)
        else:
            res.pi_col = np.asarray(pi_vec)
    if cfg.sort_model:
        res.sort()
    return res
