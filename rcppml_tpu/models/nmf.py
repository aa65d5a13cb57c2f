"""Alternating-least-squares NMF — the single fit loop.

JAX re-architecture of the reference's unified ALS implementation
(``inst/include/FactorNet/nmf/fit_cpu.hpp:172-1855``).  Where the reference
template-switches CPU/GPU primitives and parallelizes with OpenMP column
loops, this implementation is ONE pure-functional ``lax.while_loop`` step,
jit-compiled per (config, shape) signature:

  * the whole fit (init -> iterate -> converge) executes on-device with no
    per-iteration host round-trips;
  * primitives are dense matmuls (`ops.linalg`) and batched solves
    (`ops.solvers`) over *all* columns at once — the reference's
    ``threads`` knob has no analog because every lane is always busy;
  * under ``pjit`` with A sharded over a (rows, cols) mesh, the identical
    code runs multi-chip: Gram products become psum all-reduces inserted by
    GSPMD (see ``rcppml_tpu/parallel``).

Iteration structure mirrors fit_cpu.hpp:444-1825 exactly:
  H-update (gram(W_T) -> rhs -> features -> solve -> posthoc -> normalize)
  -> W-update (same on A^T) -> dispersion updates -> gram-trick loss ->
  relative-tolerance patience convergence.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from .. import rng as rng_mod
from ..config import Loss, NMFConfig, Norm, Solver
from ..ops import features as feat
from ..ops import linalg, solvers
from ..ops.linalg import PREC
from ..result import NMFResult


class FitState(NamedTuple):
    W_T: jax.Array            # (k, m) transposed storage (fit_cpu.hpp:24-26)
    H: jax.Array              # (k, n)
    d: jax.Array              # (k,)
    it: jax.Array             # int32, completed iterations
    prev_loss: jax.Array
    patience_ctr: jax.Array
    converged: jax.Array      # bool
    final_tol: jax.Array
    loss_hist: jax.Array      # (max_iter,), NaN-padded


# ---------------------------------------------------------------------------
# Solve dispatch (fit_cpu.hpp:577-637 solver branches)
# ---------------------------------------------------------------------------

def _solve(cfg: NMFConfig, G, B, X_warm, fc, it):
    """NNLS solve for one factor side.

    L1/L2 have already been applied to (G, B) by apply_features, so the
    solvers run with zero penalties — matching the reference standard path
    which passes L1=L2=0 into nnls_batch (fit_cpu.hpp:622-637).
    Warm start only after the first iteration (reference ``iter > 0``).
    """
    if cfg.solver == Solver.CHOLESKY:
        return solvers.cholesky_clip_batch(G, B, nonneg=fc.nonneg)
    X0 = X_warm * (it > 0).astype(X_warm.dtype)
    B_res = B - jnp.dot(G, X0, precision=PREC)
    return solvers.cd_nnls_batch_traced(
        G, B_res, X0, 0.0, nonneg=fc.nonneg,
        maxit=cfg.cd_max_iter, cd_tol=cfg.cd_tol)


def _posthoc(X, fc):
    """Post-NNLS upper bound + angular decorrelation (fit_cpu.hpp:637-645)."""
    if fc.upper_bound > 0:
        X = feat.apply_upper_bound(X, fc.upper_bound)
    if fc.angular > 0:
        X = feat.apply_angular_posthoc(X, fc.angular)
    return X


# ---------------------------------------------------------------------------
# The jitted fit
# ---------------------------------------------------------------------------

def make_updates(cfg: NMFConfig, aux):
    """Build the H-update / W-update / loss functions for one config.

    Shared between the fully-fused while-loop fit (:func:`_fit_mse`) and the
    step-mode driver (:func:`fit_stepwise`, used when callbacks/profiling
    are requested) so variant logic exists exactly once — the analog of the
    reference's variant_helpers centralization.
    """
    graph_W = aux.get("graph_W")
    graph_H = aux.get("graph_H")
    target_H = aux.get("target_H")
    target_H_gram = aux.get("target_H_gram")
    target_W = aux.get("target_W")
    target_W_gram = aux.get("target_W_gram")
    use_saved_loss = not (cfg.projective or cfg.symmetric)

    def h_update(A, W_T, H, d, it):
        if cfg.projective:
            # H = diag(d) . W_T . A, no solve (variant_helpers.hpp:321-338)
            W_Td = W_T * d[:, None]
            H_new = linalg.rhs(W_Td, A)
            return linalg.extract_scaling(H_new, cfg.norm)
        if cfg.symmetric:
            return H, d  # set after W-update (variant_helpers.hpp:56)
        G = linalg.gram(W_T)
        B = linalg.rhs(W_T, A)
        G, B = feat.apply_features(G, B, H, cfg.H, graph=graph_H,
                                   target=target_H, target_gram=target_H_gram)
        H_new = _solve(cfg, G, B, H, cfg.H, it)
        H_new = _posthoc(H_new, cfg.H)
        return linalg.extract_scaling(H_new, cfg.norm)

    def w_update(A, W_T, H, d, it):
        """Returns (W_T, H, d, B_w_saved, G_w_saved)."""
        if cfg.symmetric:
            # A ~ W'.diag(d).W — one update on the W side (fit_cpu.hpp:657-705)
            G = linalg.gram(W_T)
            B = linalg.rhs(W_T, A)
            G, B = feat.apply_features(G, B, W_T, cfg.W, graph=graph_W,
                                       target=target_W, target_gram=target_W_gram)
            W_new = _solve(cfg, G, B, W_T, cfg.W, it)
            W_new = _posthoc(W_new, cfg.W)
            W_new, d_new = linalg.extract_scaling(W_new, cfg.norm)
            return W_new, W_new, d_new, None, None
        G_w = linalg.gram(H)                                   # saved pre-features
        B_w = linalg.rhs(H, A.T)                               # saved pre-features
        G, B = feat.apply_features(G_w, B_w, W_T, cfg.W, graph=graph_W,
                                   target=target_W, target_gram=target_W_gram)
        W_new = _solve(cfg, G, B, W_T, cfg.W, it)
        W_new = _posthoc(W_new, cfg.W)
        W_new, d_new = linalg.extract_scaling(W_new, cfg.norm)
        return W_new, H, d_new, B_w, G_w

    def compute_loss(trAtA, A, W_T, H, d, B_w, G_w):
        if use_saved_loss:
            # optimized saved-matrix Gram-trick loss (fit_cpu.hpp:1710-1753)
            return linalg.mse_loss_from_saved(trAtA, W_T, d, B_w, G_w)
        W_Td = W_T * d[:, None]
        G_l = linalg.gram(W_Td)
        B_l = linalg.rhs(W_Td, A)
        return linalg.gram_trick_loss(trAtA, G_l, B_l, H)

    return h_update, w_update, compute_loss


def _mse_loop(cfg: NMFConfig, A, aux, init: FitState, seg_end):
    """The fused ALS while_loop, shared by the whole-fit and segmented
    (checkpointing) drivers.  ``seg_end`` is a traced iteration bound —
    the loop stops at ``min(seg_end, cfg.max_iter)`` so every segment of
    a checkpointed fit reuses ONE compiled executable."""
    dtype = A.dtype
    bound = jnp.minimum(seg_end, cfg.max_iter)
    tol = jnp.asarray(cfg.tol, dtype)
    h_update, w_update, compute_loss = make_updates(cfg, aux)

    # tr(A'A) precomputed once (fit_cpu.hpp:224) — always fp32
    trAtA = jnp.sum(A * A)
    # opt-in bandwidth knob: the loop's matmuls read A in bf16 (half the
    # HBM traffic of the dominant operand); loss bookkeeping stays fp32
    A_mm = A.astype(jnp.bfloat16) if cfg.bf16_data else A

    def body(state: FitState) -> FitState:
        W_T, H, d, it = state.W_T, state.H, state.d, state.it
        with jax.named_scope("h_update"):
            H, d = h_update(A_mm, W_T, H, d, it)
        with jax.named_scope("w_update"):
            W_T, H, d, B_w, G_w = w_update(A_mm, W_T, H, d, it)

        with jax.named_scope("loss"):
            loss = compute_loss(trAtA, A_mm, W_T, H, d, B_w, G_w)

        # relative-tolerance + patience convergence (fit_cpu.hpp:1770-1809)
        rel = jnp.abs(state.prev_loss - loss) / (jnp.abs(state.prev_loss) + 1e-15)
        loss_conv = (it > 0) & (rel < tol)
        patience_ctr = jnp.where(loss_conv, state.patience_ctr + 1, 0)
        converged = patience_ctr >= cfg.patience
        final_tol = jnp.where(it > 0, rel, state.final_tol)
        loss_hist = state.loss_hist.at[it].set(loss)

        return FitState(W_T, H, d, it + 1, loss, patience_ctr, converged,
                        final_tol, loss_hist)

    def cond(state: FitState):
        return (state.it < bound) & jnp.logical_not(state.converged)

    return lax.while_loop(cond, body, init)


def _init_fit_state(cfg: NMFConfig, W_T0, H0, d0, dtype=jnp.float32) -> FitState:
    return FitState(
        W_T=W_T0, H=H0, d=d0,
        it=jnp.int32(0),
        prev_loss=jnp.asarray(jnp.finfo(dtype).max, dtype),
        patience_ctr=jnp.int32(0),
        converged=jnp.bool_(False),
        final_tol=jnp.asarray(jnp.nan, dtype),
        loss_hist=jnp.full((cfg.max_iter,), jnp.nan, dtype),
    )


@partial(jax.jit, static_argnames=("cfg",))
def _fit_mse(cfg: NMFConfig, A, W_T0, H0, d0, aux):
    """Dense MSE ALS fit, fully on-device (standard / projective / symmetric).

    ``aux`` is a dict whose key set is static (part of the jit cache key):
    optional 'graph_W', 'graph_H' (dense Laplacians), 'target_H'/'target_W'
    and their precomputed '. _gram' entries for PROJ_ADV.
    """
    init = _init_fit_state(cfg, W_T0, H0, d0, A.dtype)
    return _mse_loop(cfg, A, aux, init, jnp.int32(cfg.max_iter))


@partial(jax.jit, static_argnames=("cfg",))
def _fit_mse_seg(cfg: NMFConfig, A, state: FitState, aux, seg_end):
    """Resume the fused ALS loop from an existing state up to ``seg_end``
    iterations (traced) — the checkpointing segment kernel."""
    return _mse_loop(cfg, A, aux, state, seg_end)


# ---------------------------------------------------------------------------
# fused_vmem — Newton-Schulz whole-fit ALS (opt-in)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("maxit", "nonneg", "a_bf16", "ns_steps",
                                   "l1_w", "l1_h", "l2_w", "l2_h"))
def _ns_als_xla(A, W_T0, H0, *, maxit: int, nonneg: bool = True,
                a_bf16: bool = False, ns_steps: int = 7,
                l1_w: float = 0.0, l1_h: float = 0.0,
                l2_w: float = 0.0, l2_h: float = 0.0):
    """Fixed-iteration ALS whose k x k solves are Newton-Schulz refinements
    of the previous iteration's Gram inverse, clipped to >= 0 -- the
    ``fused_vmem`` implementation, one plain XLA loop.

    ``ns_steps`` >= 5 is needed for convergence: one warm-started step
    cannot track the per-iteration Gram drift (error recurrence
    e' = (e + delta)^2) and the coupled factor/inverse iteration then
    stalls at a different fixed point."""
    k = W_T0.shape[0]
    f32 = jnp.float32
    eye = jnp.eye(k, dtype=f32)
    PH = lax.Precision.HIGHEST

    def mm(X, Y):
        return jnp.dot(X, Y, precision=PH, preferred_element_type=f32)

    def ridge_of(G):
        return (1e-6 / k) * jnp.trace(G)

    def seed_inverse(G):
        n1 = jnp.max(jnp.sum(jnp.abs(G), axis=0))
        ninf = jnp.max(jnp.sum(jnp.abs(G), axis=1))
        return G.T / (n1 * ninf)

    def ns_refine(G, X):
        M = mm(G, X)
        n1 = jnp.max(jnp.sum(jnp.abs(M), axis=0))
        ninf = jnp.max(jnp.sum(jnp.abs(M), axis=1))
        X = X * (1.0 / jnp.sqrt(n1 * ninf))
        for _ in range(ns_steps):
            X = mm(X, 2.0 * eye - mm(G, X))
        return X

    trata = jnp.sum(A * A, dtype=f32)
    A_mm = A.astype(jnp.bfloat16) if a_bf16 else A
    # ridge BEFORE seeding, as in every iteration
    G0 = mm(W_T0, W_T0.T)
    G0 = G0 + (ridge_of(G0) + l2_h) * eye
    gh0 = ns_refine(G0, seed_inverse(G0))
    Gw0 = mm(H0, H0.T)
    Gw0 = Gw0 + (ridge_of(Gw0) + l2_w) * eye
    gw0 = ns_refine(Gw0, seed_inverse(Gw0))

    def body(it, carry):
        W, H, d, gh, gw, hist = carry
        G = mm(W, W.T)
        G = G + (ridge_of(G) + l2_h) * eye
        Ginv = ns_refine(G, gh)
        B = jnp.dot(W.astype(A_mm.dtype) if a_bf16 else W, A_mm,
                    precision=None if a_bf16 else PH,
                    preferred_element_type=f32)
        Hn = mm(Ginv, B - l1_h if l1_h else B)
        if nonneg:
            Hn = jnp.maximum(Hn, 0.0)
        hs = jnp.maximum(jnp.sum(Hn, axis=1, keepdims=True), 1e-15)
        Hn = Hn / hs
        Gw = mm(Hn, Hn.T)
        Gw = Gw + ridge_of(Gw) * eye      # loss uses the L2-free Gw
        Gw_solve = Gw + l2_w * eye if l2_w else Gw
        Gwinv = ns_refine(Gw_solve, gw)
        Bw = lax.dot_general(Hn.astype(A_mm.dtype) if a_bf16 else Hn, A_mm,
                             (((1,), (1,)), ((), ())),
                             precision=None if a_bf16 else PH,
                             preferred_element_type=f32)
        Wn = mm(Gwinv, Bw - l1_w if l1_w else Bw)
        if nonneg:
            Wn = jnp.maximum(Wn, 0.0)
        ws = jnp.maximum(jnp.sum(Wn, axis=1, keepdims=True), 1e-15)
        Wn = Wn / ws
        dn = ws[:, 0]
        cross = jnp.sum(ws * Wn * Bw)
        loss = trata - 2.0 * cross + jnp.sum((ws * ws.T) * mm(Wn, Wn.T) * Gw)
        return (Wn, Hn, dn, Ginv, Gwinv, hist.at[it].set(loss))

    hist0 = jnp.full((maxit,), jnp.nan, f32)
    W, H, d, _, _, hist = lax.fori_loop(
        0, maxit, body, (W_T0, H0, jnp.ones((k,), f32), gh0, gw0, hist0))
    return W, H, d, hist


def _fit_fused_vmem(cfg: NMFConfig, A_dev, W_T0, H0) -> "NMFResult":
    """Driver for the opt-in ``fused_vmem`` path (:func:`_ns_als_xla`).
    cfg.validate() has already constrained this to the dense nonneg MSE
    fit with tol=0 (fixed max_iter); L1/L2 are supported, tier-2 features
    are not."""
    W_T, H, d, hist = _ns_als_xla(
        A_dev, jnp.asarray(W_T0), jnp.asarray(H0), maxit=cfg.max_iter,
        nonneg=True, a_bf16=cfg.bf16_data,
        l1_w=float(cfg.W.L1), l1_h=float(cfg.H.L1),
        l2_w=float(cfg.W.L2), l2_h=float(cfg.H.L2))
    prev = hist[-2] if cfg.max_iter > 1 else hist[-1]
    final_tol = jnp.abs(prev - hist[-1]) / (jnp.abs(prev) + 1e-15)
    state = FitState(W_T=W_T, H=H, d=d, it=jnp.int32(cfg.max_iter),
                     prev_loss=hist[-1], patience_ctr=jnp.int32(0),
                     converged=jnp.bool_(False), final_tol=final_tol,
                     loss_hist=hist)
    return finalize_result(cfg, state)


# ---------------------------------------------------------------------------
# Step mode — per-iteration host loop with callbacks + section profiling
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("cfg", "section"))
def _step_section(cfg: NMFConfig, section: str, A, W_T, H, d, it, aux,
                  B_w=None, G_w=None, trAtA=None):
    """One profiled section of an ALS iteration (step mode)."""
    h_update, w_update, compute_loss = make_updates(cfg, aux)
    if section == "h_update":
        return h_update(A, W_T, H, d, it)
    if section == "w_update":
        return w_update(A, W_T, H, d, it)
    return compute_loss(trAtA, A, W_T, H, d, B_w, G_w)


def fit_stepwise(A_dev, cfg: NMFConfig, W_T0, H0, d0, aux, *,
                 on_iteration=None) -> NMFResult:
    """Host-driven ALS loop: one jitted call per section per iteration.

    Used when the caller wants per-iteration callbacks (``on_iteration(iter,
    train, test)`` — config.hpp:388-392) or the profiling map
    (``enable_profiling`` — profiling/cpu_timer.hpp:31-50).  Slower than the
    fused while-loop (device sync per section) — exactly the reference's
    profiling-overhead trade-off.
    """
    import time as _time

    W_T = jnp.asarray(W_T0)
    H = jnp.asarray(H0)
    d = jnp.asarray(d0)
    trAtA = jnp.sum(A_dev * A_dev)        # fp32 before any bf16 cast
    if cfg.bf16_data:
        A_dev = A_dev.astype(jnp.bfloat16)
    prof: dict = {}
    hist = []
    prev_loss = np.inf
    patience = 0
    converged = False
    final_tol = float("nan")
    it = 0
    iters_done = 0            # explicit count — matches fused state.it exactly

    def timed(name, fn):
        t0 = _time.perf_counter()
        out = fn()
        jax.block_until_ready(out)
        prof[name] = prof.get(name, 0.0) + (_time.perf_counter() - t0) * 1e3
        return out

    for it in range(cfg.max_iter):
        itj = jnp.int32(it)
        H, d = timed("h_update", lambda: _step_section(
            cfg, "h_update", A_dev, W_T, H, d, itj, aux))
        W_T, H, d, B_w, G_w = timed("w_update", lambda: _step_section(
            cfg, "w_update", A_dev, W_T, H, d, itj, aux))
        loss = timed("loss", lambda: _step_section(
            cfg, "loss", A_dev, W_T, H, d, itj, aux, B_w, G_w, trAtA))
        loss = float(loss)
        hist.append(loss)
        iters_done = it + 1
        if on_iteration is not None:
            on_iteration(it + 1, loss, float("nan"))
        if it > 0:
            rel = abs(prev_loss - loss) / (abs(prev_loss) + 1e-15)
            final_tol = rel
            if rel < cfg.tol:
                patience += 1
                if patience >= cfg.patience:
                    converged = True
                    prev_loss = loss
                    break
            else:
                patience = 0
        prev_loss = loss

    res = NMFResult(
        W=np.asarray(W_T).T, d=np.asarray(d), H=np.asarray(H),
        iterations=iters_done,
        converged=converged, final_tol=final_tol,
        train_loss=float(prev_loss),
        loss_history=np.asarray(hist),
        profile=prof,
    )
    if cfg.sort_model:
        res.sort()
    return res


def fit_profiled(A_dev, cfg: NMFConfig, W_T0, H0, d0, aux) -> NMFResult:
    """Profile the PRODUCTION fused loop (profiling/cpu_timer.hpp:31-50).

    Unlike :func:`fit_stepwise` (one device dispatch per section — what you
    measure is host-loop dispatch, not the production executable), this
    runs the same fused ``lax.while_loop`` the unprofiled fit uses, in
    segments via the checkpointing kernel (:func:`_fit_mse_seg`, bitwise
    identical trajectory), and times each segment wall-clock.  The
    section→ms map contract is kept: per-section costs are measured on the
    jitted section functions at the final state (best-of-3) and scaled by
    the iteration count — estimates of where the fused time goes, marked
    as such in the map.  The fused loop itself carries ``jax.named_scope``
    annotations (h_update/w_update/loss) for ``jax.profiler`` traces.
    """
    import time as _time

    W_T = jnp.asarray(W_T0)
    H = jnp.asarray(H0)
    d = jnp.asarray(d0)
    state = _init_fit_state(cfg, W_T, H, d, A_dev.dtype)
    scfg = cfg.device_static()

    seg = max(1, min(32, cfg.max_iter // 8 or 1))
    it = 0
    converged = False
    seg_times = []          # (iters_in_segment, seconds)
    t_total0 = _time.perf_counter()
    while it < cfg.max_iter and not converged:
        seg_end = min(it + seg, cfg.max_iter)
        t0 = _time.perf_counter()
        state = _fit_mse_seg(scfg, A_dev, state, aux, jnp.int32(seg_end))
        new_it, conv = jax.device_get((state.it, state.converged))
        dt = _time.perf_counter() - t0
        if int(new_it) > it:
            seg_times.append((int(new_it) - it, dt))
        it = int(new_it)
        converged = bool(conv)
    fused_total_ms = (_time.perf_counter() - t_total0) * 1e3

    # steady-state per-iteration cost: best segment (first segment carries
    # the compile; remote-link noise hits individual segments)
    per_iter_s = min((t / n for n, t in seg_times), default=0.0)

    # one-shot section attribution on the production state
    A_sec = A_dev.astype(jnp.bfloat16) if cfg.bf16_data else A_dev
    trAtA = jnp.sum(A_dev * A_dev)
    itj = state.it
    W_Tf, Hf, df = state.W_T, state.H, state.d

    def best_of(fn, reps=3):
        best = float("inf")
        out = None
        for _ in range(reps):
            t0 = _time.perf_counter()
            out = fn()
            jax.block_until_ready(out)
            best = min(best, _time.perf_counter() - t0)
        return best, out

    t_h, _ = best_of(lambda: _step_section(
        scfg, "h_update", A_sec, W_Tf, Hf, df, itj, aux))
    t_w, wout = best_of(lambda: _step_section(
        scfg, "w_update", A_sec, W_Tf, Hf, df, itj, aux))
    B_w, G_w = wout[3], wout[4]
    t_l, _ = best_of(lambda: _step_section(
        scfg, "loss", A_sec, W_Tf, Hf, df, itj, aux, B_w, G_w, trAtA))

    prof = {
        "h_update": t_h * 1e3 * it,
        "w_update": t_w * 1e3 * it,
        "loss": t_l * 1e3 * it,
        "fused_total_ms": fused_total_ms,
        "fused_per_iter_us": per_iter_s * 1e6,
        "iterations": it,
        "mode": "fused-segmented",
        "section_basis": "per-call best-of-3 at final state x iterations "
                         "(the fused executable is XLA-fused across "
                         "sections; use jax.profiler traces for exact "
                         "in-loop attribution via the named_scope marks)",
    }
    return finalize_result(cfg, state, extra={"profile": prof})


# ---------------------------------------------------------------------------
# Initialization (nmf/nmf_init.hpp, fit_cpu.hpp:195-218)
# ---------------------------------------------------------------------------

def init_factors(cfg: NMFConfig, m: int, n: int, A=None,
                 w_init: Optional[np.ndarray] = None,
                 h_init: Optional[np.ndarray] = None,
                 dtype=np.float32):
    """Build (W_T0 (k,m), H0 (k,n), d0 (k,)) on host.

    Random init reproduces the reference's sequential SplitMix64 column-major
    fill order: W_T first (k*m draws), then H (next k*n draws)
    (nmf_init.hpp:167-186).  init_mode 1/2 seed from a truncated SVD:
    ``W_T[i,:] = |U[:,i]| sqrt(d_i)``, ``H[i,:] = |V[:,i]| sqrt(d_i)``
    (nmf_init.hpp:45-96).
    """
    k = cfg.rank
    d0 = np.ones((k,), dtype=dtype)

    if w_init is not None:
        W_T = np.ascontiguousarray(np.asarray(w_init, dtype=dtype).T)
        if h_init is not None:
            H = np.asarray(h_init, dtype=dtype)
        else:
            H = rng_mod.fill_uniform(cfg.seed if cfg.seed != 0 else 12345,
                                     k, n, dtype=dtype)
        return W_T, H, d0

    if cfg.init_mode in (1, 2) and A is not None:
        from . import svd as svd_mod
        from ..config import SVDConfig
        scfg = SVDConfig(k=k, tol=1e-10, center=False, seed=cfg.seed)
        res = (svd_mod.lanczos_svd(A, scfg) if cfg.init_mode == 1
               else svd_mod.irlba_svd(A, scfg))
        kk = min(k, res.k_selected if res.k_selected else k)
        W_T = np.empty((k, m), dtype=dtype)
        H = np.empty((k, n), dtype=dtype)
        sq = np.sqrt(np.maximum(np.asarray(res.d[:kk], dtype=np.float64), 0.0))
        W_T[:kk] = (np.abs(np.asarray(res.U[:, :kk])) * sq[None, :]).T
        H[:kk] = (np.abs(np.asarray(res.V[:, :kk])) * sq[None, :]).T
        if kk < k:
            fill_seed = 54321 if cfg.seed == 0 else cfg.seed + 999
            W_T[kk:] = rng_mod.fill_uniform(fill_seed, k - kk, m, dtype=dtype)
            H[kk:] = rng_mod.fill_uniform(fill_seed, k - kk, n,
                                          offset=(k - kk) * m, dtype=dtype)
        return W_T, H, d0

    W_T = rng_mod.fill_uniform(cfg.seed, k, m, dtype=dtype)
    H = rng_mod.fill_uniform(cfg.seed, k, n, offset=k * m, dtype=dtype)
    return W_T, H, d0


@partial(jax.jit, static_argnames=("cfg",))
def _fit_mse_multi(cfg: NMFConfig, A, seed_pairs):
    """Batched multi-restart: ALL restarts in ONE vmapped fused loop.

    The reference runs restarts serially (R/nmf_thin.R seed-list loop);
    the ALS iteration is memory-bandwidth-bound on re-reading A, so
    vmapping the whole fused fit over the restart axis amortizes the A
    reads — r restarts cost barely more than one (the batched matmuls
    read A once per iteration for all restarts).  Each lane inits from
    its own SplitMix64 seed exactly like a standalone fit; finished
    lanes freeze via while_loop-under-vmap select semantics, so each
    lane's trajectory equals its standalone counterpart up to XLA tiling
    of the batched matmuls.
    """
    k = cfg.rank
    m, n = A.shape

    def one(seed_pair):
        W_T = rng_mod.fill_uniform_traced(seed_pair, k, m)
        H = rng_mod.fill_uniform_traced(seed_pair, k, n, offset=k * m)
        init = _init_fit_state(cfg, W_T, H, jnp.ones((k,), jnp.float32),
                               A.dtype)
        return _mse_loop(cfg, A, {}, init, jnp.int32(cfg.max_iter))

    return jax.vmap(one)(seed_pairs)


def fit_multi_restart(A, cfg: NMFConfig, seeds) -> "NMFResult":
    """Run the seed-list multi-restart as one batched device program and
    return the best-loss restart (R semantics: test_parameters.R:554-578,
    best train loss wins; ``misc['all_inits']`` records every restart)."""
    A_dev = A if isinstance(A, jax.Array) else jnp.asarray(
        np.asarray(A, dtype=np.float32))
    pairs = jnp.asarray(np.stack([rng_mod.seed_to_u32_pair(int(s))
                                  for s in seeds]))
    states = _fit_mse_multi(cfg.device_static(), A_dev, pairs)
    losses = np.asarray(jax.device_get(states.prev_loss), dtype=np.float64)
    best_ix = int(np.nanargmin(losses))
    best_state = jax.tree_util.tree_map(lambda x: x[best_ix], states)
    res = finalize_result(cfg, best_state)
    res.misc["all_inits"] = [
        {"init": i, "loss": float(losses[i]), "selected": i == best_ix}
        for i in range(len(seeds))]
    return res


@partial(jax.jit, static_argnames=("k", "m", "n"))
def _init_random_device(k: int, m: int, n: int, seed_pair):
    """Random init ON DEVICE — bit-identical to the host
    :func:`init_factors` random path (fill_uniform_traced reproduces the
    sequential SplitMix64 fill exactly, incl. the single-rounding uint64 ->
    f32 conversion), so the k*(m+n) init floats never cross the host link.
    ``seed_pair`` is traced (uint32[2]) so all seeds share one executable.
    """
    W_T = rng_mod.fill_uniform_traced(seed_pair, k, m)
    H = rng_mod.fill_uniform_traced(seed_pair, k, n, offset=k * m)
    return W_T, H, jnp.ones((k,), jnp.float32)


# ---------------------------------------------------------------------------
# Host-level driver
# ---------------------------------------------------------------------------

def nmf_fit(A, cfg: NMFConfig, *, w_init=None, h_init=None,
            aux: Optional[dict] = None, device_A=None,
            sparse_zeros: bool = False, on_iteration=None) -> NMFResult:
    """Fit NMF on a dense (or densified) matrix.

    ``A``: (m, n) numpy array (fp32 internally, like the reference's
    double->float boundary cast, src/RcppFunctions_nmf.cpp:4-5).
    ``aux``: optional dict of dense auxiliary arrays (graph Laplacians,
    targets); key presence is static.
    """
    cfg.validate()
    if isinstance(A, jax.Array):
        device_A = A.astype(jnp.float32) if device_A is None else device_A
    else:
        A = np.asarray(A, dtype=np.float32)
    m, n = A.shape
    if cfg.rank > min(m, n):
        raise ValueError(f"rank {cfg.rank} exceeds min(dim) = {min(m, n)}")

    if w_init is None and h_init is None and cfg.init_mode == 0:
        # random init on device — no host fill, no host->device transfer
        W_T0, H0, d0 = _init_random_device(
            cfg.rank, m, n, jnp.asarray(rng_mod.seed_to_u32_pair(cfg.seed)))
    else:
        W_T0, H0, d0 = init_factors(cfg, m, n, A=A, w_init=w_init,
                                    h_init=h_init)

    aux_dev = {key: jnp.asarray(val, jnp.float32)
               for key, val in (aux or {}).items() if val is not None}
    A_dev = device_A if device_A is not None else jnp.asarray(A)

    if cfg.requires_irls():
        from .nmf_irls import fit_irls
        return fit_irls(A_dev, cfg, W_T0, H0, d0, aux_dev,
                        sparse_zeros=sparse_zeros)

    if cfg.fused_vmem:
        if on_iteration is not None or cfg.enable_profiling:
            raise ValueError("fused_vmem runs the whole fit in one device "
                             "program — callbacks/profiling need the "
                             "step-mode loop (drop the knob)")
        return _fit_fused_vmem(cfg, A_dev, W_T0, H0)

    if on_iteration is not None:
        return fit_stepwise(A_dev, cfg, W_T0, H0, d0, aux_dev,
                            on_iteration=on_iteration)
    if cfg.enable_profiling:
        return fit_profiled(A_dev, cfg, W_T0, H0, d0, aux_dev)

    state = _fit_mse(cfg.device_static(), A_dev, jnp.asarray(W_T0),
                     jnp.asarray(H0), jnp.asarray(d0), aux_dev)
    return finalize_result(cfg, state)


@jax.jit
def _pack_state(state: FitState):
    """Flatten the fit state into ONE f32 buffer: a pytree device_get pulls
    each leaf in its own transfer; a single flat array transfers once."""
    f32 = jnp.float32
    return jnp.concatenate([
        state.W_T.ravel(), state.H.ravel(), state.d.ravel(),
        state.loss_hist.ravel(),
        jnp.stack([state.it.astype(f32), state.prev_loss,
                   state.patience_ctr.astype(f32),
                   state.converged.astype(f32), state.final_tol]),
    ])


def _unpack_state(buf: np.ndarray, k: int, m: int, n: int,
                  max_iter: int) -> FitState:
    o = 0
    W_T = buf[o:o + k * m].reshape(k, m); o += k * m
    H = buf[o:o + k * n].reshape(k, n); o += k * n
    d = buf[o:o + k]; o += k
    hist = buf[o:o + max_iter]; o += max_iter
    it, prev_loss, patience, converged, final_tol = buf[o:o + 5]
    return FitState(W_T, H, d, np.int32(it), prev_loss,
                    np.int32(patience), bool(converged > 0.5), final_tol,
                    hist)


def finalize_result(cfg: NMFConfig, state: FitState, extra=None) -> NMFResult:
    """Convert a device FitState into a host NMFResult (fit_cpu.hpp:1827-1854).

    The state is packed to one flat device buffer first so remote backends
    pay exactly one transfer round-trip."""
    k, m = state.W_T.shape
    n = state.H.shape[1]
    max_iter = state.loss_hist.shape[0]
    buf = np.asarray(jax.device_get(_pack_state(state)))
    state = _unpack_state(buf, k, m, n, max_iter)
    it = int(state.it)
    hist = np.asarray(state.loss_hist)[:it]
    res = NMFResult(
        W=np.asarray(state.W_T).T,
        d=np.asarray(state.d),
        H=np.asarray(state.H),
        iterations=it,
        converged=bool(state.converged),
        final_tol=float(state.final_tol),
        train_loss=float(state.prev_loss) if it > 0 else float("nan"),
        loss_history=hist if cfg.track_loss_history else None,
    )
    for key, val in (extra or {}).items():
        setattr(res, key, val)
    if cfg.sort_model:
        res.sort()
    return res
