"""User-facing API, mirroring the reference R surface (R/nmf_thin.R:219-1315).

``nmf(A, k, ...)`` accepts dense numpy arrays or scipy sparse matrices and
returns an :class:`NMFResult`.  Sparse inputs are densified onto the device
when they fit (standard NMF treats zeros as data, so results are identical);
larger-than-memory inputs stream through the chunked path (``models.nmf_chunked``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np

from . import constants
from .config import Dispersion, FactorConfig, Loss, NMFConfig, Norm, Solver, ZI
from .result import NMFResult


def _pair(x, name: str):
    """Normalize scalar-or-pair args like the R API's L1 = c(w, h)."""
    if np.isscalar(x):
        return float(x), float(x)
    x = list(x)
    if len(x) == 1:
        return float(x[0]), float(x[0])
    if len(x) != 2:
        raise ValueError(f"{name} must be a scalar or a (W, H) pair")
    return float(x[0]), float(x[1])


def _is_sparse(data) -> bool:
    try:
        import scipy.sparse as sp
        return sp.issparse(data)
    except ImportError:
        return False


def _to_dense_f32(data, allow_nan: bool = False):
    """Accept numpy / scipy.sparse / device (jax) arrays; return a dense
    float32 (m, n) — jax arrays pass through device-resident."""
    import jax
    if isinstance(data, jax.Array):
        if data.ndim != 2:
            raise ValueError("data must be a 2-D matrix")
        return data
    if _is_sparse(data):
        # memory guard before densification (core/memory.hpp:152-190):
        # refuse with the streaming remedy instead of thrashing/OOMing
        from .utils.memory import guard_dense_input
        guard_dense_input(data.shape[0], data.shape[1])
        arr = np.asarray(data.todense(), dtype=np.float32)
    else:
        arr = np.asarray(data, dtype=np.float32)
    if arr.ndim != 2:
        raise ValueError("data must be a 2-D matrix")
    if not allow_nan and np.isnan(arr).any():
        # R/nmf_validation.R NA detection: fail loudly, not with NaN factors
        raise ValueError("data contains NaN/NA values; impute or mask them "
                         "(use mask= for missing-value factorization)")
    if np.isinf(arr).any():
        # Inf cannot be masked away like NA; erroring (not NaN factors) is
        # the acceptable behavior (test_p2_hardening.R:253-266)
        raise ValueError("data contains infinite values; clip or remove "
                         "them before factorization")
    return arr


def _gram_over_n(t):
    """T @ T.T / n in full fp32 (an accelerator would otherwise run a
    float32 product at reduced precision)."""
    import jax.numpy as jnp
    from .ops.linalg import PREC
    return jnp.dot(t, t.T, precision=PREC) / t.shape[1]


def _resolve_mask(A, mask):
    """NA handling + string masks, matching the reference gateway:

    - ``mask="zeros"`` -> treat zeros as missing (returned as the
      mask_zeros flag; R/nmf_thin.R mask= string form)
    - ``mask="NA"`` -> mask the NaN entries
    - NaN present with no mask -> warn "Detected N NA values" and mask
      them (tests/testthat/test_masking.R:240-262)
    - NaN outside an explicit matrix mask -> error

    Returns (A, mask_array_or_None, mask_zeros_flag); NaN entries are
    zero-filled so the fp32 bridge never ships NaN to the device.
    """
    import warnings
    mask_zeros = False
    if isinstance(mask, str):
        key = mask.strip().lower()
        if key == "zeros":
            return A, None, True
        if key != "na":
            raise ValueError(f"mask={mask!r}: use 'zeros', 'NA', or a "
                             "boolean matrix")
        mask = None
        explicit_na = True
    else:
        explicit_na = False
    import jax
    if isinstance(A, jax.Array):  # device-resident fast path: no NaN scan
        if explicit_na:
            raise ValueError("mask='NA' requires a host array (device-"
                             "resident inputs are assumed NaN-free)")
        return A, mask, mask_zeros
    nan_mask = np.isnan(A)
    n_nan = int(nan_mask.sum())
    if n_nan == 0:
        return A, mask, mask_zeros
    A = np.where(nan_mask, np.float32(0), A)
    if mask is None:
        if not explicit_na:
            warnings.warn(f"Detected {n_nan} NA values in data; treating "
                          "them as masked (missing)")
        return A, nan_mask, mask_zeros
    mask = np.asarray(mask, dtype=bool)
    if (nan_mask & ~mask).any():
        raise ValueError("data contains NaN entries outside the supplied "
                         "mask; mask them or impute")
    return A, mask, mask_zeros


def build_config(
    k: int,
    *,
    tol: float = constants.NMF_TOL,
    maxit: int = constants.NMF_MAXIT,
    L1=(0.0, 0.0),
    L2=(0.0, 0.0),
    L21=(0.0, 0.0),
    angular=(0.0, 0.0),
    upper_bound=(0.0, 0.0),
    graph_lambda=(0.0, 0.0),
    target_lambda: float = 0.0,
    seed: Union[int, str, None] = None,
    loss: str = "mse",
    nonneg=(True, True),
    test_fraction: float = 0.0,
    cv_seed: int = 0,
    mask_zeros: bool = False,
    cv_col_subsample: float = 1.0,
    cv_row_subsample: float = 1.0,
    gp_blend: float = 1.0,
    projective: bool = False,
    symmetric: bool = False,
    zi: str = "none",
    robust=False,
    dispersion: str = "per_row",
    theta_init: float = 0.1,
    theta_min: Optional[float] = None,
    theta_max: Optional[float] = None,
    nb_size_init: float = 10.0,
    nb_size_min: Optional[float] = None,
    nb_size_max: Optional[float] = None,
    gamma_phi_init: float = 1.0,
    gamma_phi_min: Optional[float] = None,
    gamma_phi_max: Optional[float] = None,
    huber_delta: float = 1.0,
    zi_em_iters: int = 1,
    track_train_loss: bool = True,
    tweedie_power: float = 1.5,
    irls_max_iter: int = constants.IRLS_MAX_ITER,
    irls_tol: float = constants.IRLS_TOL,
    solver: str = "auto",
    cd_tol: float = constants.CD_TOL,
    cd_maxit: int = constants.CD_MAXIT,
    patience: int = constants.NMF_PATIENCE,
    cv_patience: int = constants.NMF_PATIENCE,
    norm: str = "L1",
    sort_model: bool = True,
    convergence: str = "loss",
    verbose: bool = False,
    profile: bool = False,
    bf16_data: bool = False,
    fused_vmem: bool = False,
    has_mask: bool = False,
    has_graph_W: bool = False,
    has_graph_H: bool = False,
    has_target_H: bool = False,
    has_target_W: bool = False,
) -> NMFConfig:
    """Translate R-style keyword arguments into a static NMFConfig.

    Solver auto-selection follows R/nmf_thin.R:363-388: IRLS -> cd;
    k < 32 and no L1 -> cholesky; else cd.
    """
    if convergence not in ("loss", "factor", "both"):
        raise ValueError(f"convergence={convergence!r}: use 'loss', "
                         "'factor', or 'both'")
    # accepted for R-API compatibility (R/parse_dots.R:63) but the NMF
    # loop is loss-converged in the reference too — its C++ NMFConfig has
    # no convergence field (src/RcppFunctions_nmf.cpp:340-366), only the
    # SVD honors the mode (svd_config.hpp:25).
    l1w, l1h = _pair(L1, "L1")
    l2w, l2h = _pair(L2, "L2")
    l21w, l21h = _pair(L21, "L21")
    angw, angh = _pair(angular, "angular")
    ubw, ubh = _pair(upper_bound, "upper_bound")
    glw, glh = _pair(graph_lambda, "graph_lambda")
    nnw, nnh = (nonneg, nonneg) if isinstance(nonneg, bool) else tuple(nonneg)

    # loss="huber"/"mae" are IRLS reweightings of squared error
    # (math/loss.hpp:39-50, loss_type 1/2): expressed here as MSE +
    # robust delta (huber_delta / the mae 1e-4 floor)
    if loss == "huber":
        loss = "mse"
        if robust is False:
            robust = float(huber_delta)
    elif loss == "mae":
        loss = "mse"
        if robust is False:
            robust = "mae"
    loss_e = Loss(loss)
    # robust: False=0, True=1.345, "mae"=1e-4, numeric (R/nmf_thin.R:341-353)
    if isinstance(robust, bool):
        robust_delta = 1.345 if robust else 0.0
    elif isinstance(robust, str) and robust.lower() == "mae":
        robust_delta = 1e-4
    else:
        robust_delta = float(robust)

    init_mode = 0
    seed_int = 0
    if isinstance(seed, str):
        init_mode = {"random": 0, "lanczos": 1, "irlba": 2,
                     "randomized": 1, "svd": 1}[seed]
    elif seed is not None:
        seed_int = int(seed)

    needs_irls = loss_e != Loss.MSE or robust_delta > 0
    if solver == "auto":
        # Accelerator policy: IRLS needs CD, and any L1 > 0 needs CD too —
        # Cholesky-solve-then-clip is not the stationary solution of the
        # L1-penalized NNLS subproblem (the reference auto-select uses CD
        # whenever L1 != 0, R/nmf_thin.R:371-375).  Otherwise Cholesky+clip,
        # the reference's C++ default (solver_mode=1, core/config.hpp:133):
        # one batched Cholesky solve replaces the sequential CD sweep.
        solver_e = (Solver.CD if (needs_irls or l1w > 0 or l1h > 0)
                    else Solver.CHOLESKY)
    else:
        solver_e = {"cd": Solver.CD, "cholesky": Solver.CHOLESKY}[solver]
    if solver_e == Solver.CHOLESKY and needs_irls:
        raise ValueError("solver='cholesky' is not supported with non-MSE "
                         "or robust losses; use solver='cd'")

    cfg = NMFConfig(
        rank=int(k), tol=float(tol), max_iter=int(maxit), patience=int(patience),
        W=FactorConfig(L1=l1w, L2=l2w, L21=l21w, angular=angw, nonneg=bool(nnw),
                       upper_bound=ubw, graph_lambda=glw,
                       target_lambda=target_lambda if has_target_W else 0.0),
        H=FactorConfig(L1=l1h, L2=l2h, L21=l21h, angular=angh, nonneg=bool(nnh),
                       upper_bound=ubh, graph_lambda=glh,
                       target_lambda=target_lambda if has_target_H else 0.0),
        loss=loss_e, robust_delta=robust_delta, tweedie_power=float(tweedie_power),
        dispersion=Dispersion(dispersion), theta_init=float(theta_init),
        nb_size_init=float(nb_size_init), gamma_phi_init=float(gamma_phi_init),
        zi=ZI(zi), zi_em_iters=int(zi_em_iters),
        track_loss_history=bool(track_train_loss),
        bf16_data=bool(bf16_data), fused_vmem=bool(fused_vmem),
        solver=solver_e, cd_max_iter=int(cd_maxit), cd_tol=float(cd_tol),
        irls_max_iter=int(irls_max_iter), irls_tol=float(irls_tol),
        seed=seed_int, init_mode=init_mode, norm=Norm(norm),
        projective=projective, symmetric=symmetric, sort_model=sort_model,
        # a cv_seed vector with scalar k uses only its first entry, as the
        # bridge does (src/RcppFunctions_nmf.cpp:358 `cv_seeds[0]`); vectors
        # matter only in the multi-rank sweep (R/nmf_thin.R:1013-1094)
        test_fraction=float(test_fraction),
        cv_seed=int(cv_seed if np.isscalar(cv_seed)
                    else (list(cv_seed) or [0])[0]),
        mask_zeros=bool(mask_zeros),
        cv_patience=int(cv_patience),
        cv_col_subsample=float(cv_col_subsample),
        cv_row_subsample=float(cv_row_subsample),
        gp_blend=float(gp_blend),
        verbose=verbose, enable_profiling=bool(profile),
        has_mask=has_mask, has_graph_W=has_graph_W, has_graph_H=has_graph_H,
        has_target_H=has_target_H, has_target_W=has_target_W,
    )
    # optional dispersion-bound overrides (R/parse_dots.R:24-31)
    bounds = {name: val for name, val in (
        ("theta_min", theta_min), ("theta_max", theta_max),
        ("nb_size_min", nb_size_min), ("nb_size_max", nb_size_max),
        ("gamma_phi_min", gamma_phi_min), ("gamma_phi_max", gamma_phi_max),
    ) if val is not None}
    if bounds:
        import dataclasses
        cfg = dataclasses.replace(cfg, **{k: float(v)
                                          for k, v in bounds.items()})
    cfg.validate()
    return cfg


def _extract_dimnames(data):
    """Pull (row_names, col_names) off a pandas DataFrame, mirroring R's
    dimnames carry-through (tests/testthat/test_dimnames.R: rownames(A) ->
    rownames(W), colnames(A) -> colnames(H))."""
    # R matrices loaded via io.rdata carry dimnames in .attrs
    dn = getattr(data, "attrs", {}).get("dimnames") \
        if not isinstance(data, dict) else None
    if dn is not None and isinstance(dn, list) and len(dn) == 2:
        def arr_or_none(x):
            if x is None:
                return None
            a = np.asarray(x).ravel()
            return a.astype(str) if a.size else None
        return arr_or_none(dn[0]), arr_or_none(dn[1]), data
    if hasattr(data, "index") and hasattr(data, "columns") \
            and hasattr(data, "to_numpy"):
        def names(ix):
            # a default RangeIndex is "no names", like an unnamed R matrix
            if type(ix).__name__ == "RangeIndex" and ix.start == 0 \
                    and ix.step == 1:
                return None
            return np.asarray(ix.astype(str))
        return (names(data.index), names(data.columns),
                data.to_numpy(dtype=np.float32))
    return None, None, data


def nmf(data, k, *, mask=None, graph_W=None, graph_H=None, target_H=None,
        target_W=None, w_init=None, h_init=None, streaming=False,
        chunk_cols=None, on_iteration=None, mesh=None,
        checkpoint_path=None, checkpoint_every=10, **kwargs):
    """Fit A ~ W diag(d) H.  The main entry point (R/nmf_thin.R:219).

    ``k`` may be an int (single fit), a sequence of ints with
    ``test_fraction > 0`` (CV sweep -> returns a list of dict rows), or
    ``"auto"`` (CV rank search).  ``data`` may be a path to a ``.spz`` file
    (out-of-core streaming path, R/nmf_thin.R:422-627) and ``streaming=True``
    forces the chunked loader for in-memory matrices.
    """
    # multi-modal list/dict input -> shared-H factor_net
    # (R/nmf_thin.R:279-304: nmf(list(...)) delegates to factor_net)
    if isinstance(data, (list, tuple, dict)) and not _is_sparse(data):
        from .models import graph as graph_mod
        # the shared-H delegation supports config-level settings only —
        # reject (never silently drop) the matrix-shaped arguments that
        # cannot ride through GlobalConfig (round-2 review #6)
        _unsupported = {"mask": mask, "graph_W": graph_W, "graph_H": graph_H,
                        "target_H": target_H, "target_W": target_W,
                        "w_init": w_init, "h_init": h_init, "mesh": mesh,
                        "on_iteration": on_iteration,
                        "checkpoint_path": checkpoint_path}
        _set = [n for n, v in _unsupported.items() if v is not None]
        if streaming:
            _set.append("streaming")
        if _set:
            raise ValueError(
                f"multi-modal nmf(list/dict) does not support "
                f"{', '.join(sorted(_set))}; build the factor_net "
                "explicitly (rt.factor_input/factor_shared/nmf_layer) to "
                "control per-layer features")
        if isinstance(data, dict):
            named = list(data.items())
        else:
            named = [(f"modal{i + 1}", d) for i, d in enumerate(data)]
        if len(named) < 2:
            raise ValueError("multi-modal NMF requires 2+ matrices with "
                             "the same number of columns (samples)")
        ncols = {np.shape(d)[1] for _, d in named}
        if len(ncols) != 1:
            raise ValueError("all matrices in multi-modal NMF must share "
                             "the number of columns (samples)")
        inputs = [graph_mod.factor_input(_to_dense_f32(d), nm)
                  for nm, d in named]
        shared = graph_mod.factor_shared(*inputs)
        layer = graph_mod.nmf_layer(shared, int(k), name="L1")
        # every remaining fit kwarg rides through GlobalConfig: named
        # settings where they exist, everything else via dots (lowest
        # priority, forwarded verbatim to the layer's nmf() call —
        # R/nmf_thin.R:293-302 builds the same W/H/config plumbing)
        gc_kwargs = dict(kwargs)
        gc_named = {}
        for name in ("maxit", "tol", "loss", "verbose", "seed", "norm",
                     "solver", "test_fraction", "cv_seed", "mask_zeros",
                     "patience"):
            if name in gc_kwargs:
                gc_named[name] = gc_kwargs.pop(name)
        cfg_g = graph_mod.GlobalConfig(dots=gc_kwargs, **gc_named)
        net = graph_mod.factor_net(inputs, layer, config=cfg_g)
        return graph_mod.fit(net)

    # seed = matrix -> custom W init; seed = list -> multi-restart with
    # best-loss selection (test_parameters.R:149,554-578)
    seed_arg = kwargs.get("seed")
    if isinstance(seed_arg, np.ndarray) and seed_arg.ndim == 2:
        if np.isscalar(k) and seed_arg.shape[1] != int(k):
            raise ValueError(
                f"Rank mismatch: seed matrix has {seed_arg.shape[1]} "
                f"columns but k = {int(k)}")
        if w_init is None:
            w_init = seed_arg
        kwargs["seed"] = 0
    elif isinstance(seed_arg, (list, tuple)) and len(seed_arg) > 0:
        if not np.isscalar(k) or isinstance(k, str):
            # a rank sweep / auto-rank search returns CV rows, not a
            # model — best-restart selection has no meaning there; reps
            # come from cv_seed (R/nmf_thin.R:1013-1094 rep x rank)
            raise ValueError(
                "seed=[...] multi-restart requires a scalar integer k; "
                "for a rank sweep use cv_seed=[...] to control "
                "repetitions")
        # batched fast path: plain dense MSE fits vmap over the restart
        # axis — ONE device program whose batched matmuls read A once per
        # iteration for every restart (the serial reference loop pays the
        # full memory-read cost per restart; models/nmf.py
        # fit_multi_restart)
        plain = (mask is None and graph_W is None and graph_H is None
                 and target_H is None and target_W is None
                 and w_init is None and h_init is None
                 and mesh is None and on_iteration is None
                 and checkpoint_path is None
                 and not isinstance(data, str)
                 and streaming in (None, False, "auto")
                 and all(isinstance(s, (int, np.integer))
                         for s in seed_arg))
        if plain and hasattr(data, "shape") and not kwargs.get("sparse"):
            from .utils.memory import check_dense_alloc
            kw0 = {kk: vv for kk, vv in kwargs.items() if kk != "sparse"}
            cfg0 = build_config(int(k), **{**kw0,
                                           "seed": int(seed_arg[0])})
            # the fast path must preserve nmf()'s standard preprocessing:
            # dimnames survive onto the result, and NaN data falls back to
            # the serial loop (which auto-masks via _resolve_mask)
            import jax
            rn0, cn0, data0 = _extract_dimnames(data)
            has_nan = (not isinstance(data0, jax.Array)
                       and not _is_sparse(data0)
                       and np.isnan(np.asarray(data0)).any())
            if (not has_nan
                    and not cfg0.requires_irls() and not cfg0.is_cv()
                    and not cfg0.mask_zeros and cfg0.init_mode == 0
                    and not cfg0.enable_profiling and not cfg0.bf16_data
                    and not cfg0.fused_vmem
                    and not cfg0.projective and not cfg0.symmetric
                    and check_dense_alloc(data.shape[0], data.shape[1],
                                          where="device").fits):
                from .models.nmf import fit_multi_restart
                res_b = fit_multi_restart(_to_dense_f32(data0), cfg0,
                                          [int(s) for s in seed_arg])
                res_b.row_names, res_b.col_names = rn0, cn0
                return res_b
        runs = []
        for ri, s in enumerate(seed_arg):
            sub = dict(kwargs)
            sub["seed"] = s
            ck = checkpoint_path
            if ck is not None:
                # one checkpoint per restart — a shared path would make
                # restart i resume restart i-1's state (config mismatch)
                root, dot, ext = ck.rpartition(".")
                ck = (f"{root}.restart{ri}.{ext}" if dot
                      else f"{ck}.restart{ri}")
            runs.append(nmf(data, k, mask=mask, graph_W=graph_W,
                            graph_H=graph_H, target_H=target_H,
                            target_W=target_W, w_init=w_init,
                            h_init=h_init, streaming=streaming,
                            chunk_cols=chunk_cols, mesh=mesh,
                            on_iteration=on_iteration,
                            checkpoint_path=ck,
                            checkpoint_every=checkpoint_every, **sub))
        losses_ = [float(r.train_loss) for r in runs]
        best_ix = int(np.nanargmin(losses_))
        best = runs[best_ix]
        best.misc["all_inits"] = [
            {"init": i, "loss": losses_[i], "selected": i == best_ix}
            for i in range(len(runs))]
        return best

    if isinstance(mask, str) and mask.strip().lower() == "zeros":
        # R string form mask="zeros" == mask_zeros=True (R/nmf_thin.R)
        mask = None
        kwargs.setdefault("mask_zeros", True)
    if kwargs.pop("sparse", False):
        # R sparse=TRUE: treat zeros as missing (R/parse_dots.R:65,
        # test_parameters.R:260)
        kwargs.setdefault("mask_zeros", True)

    # streaming / out-of-core dispatch (nmf/fit_streaming_spz.hpp:54)
    is_spz = isinstance(data, str) and data.endswith(".spz")
    if (not is_spz and not streaming and mesh is None
            and not isinstance(data, str) and hasattr(data, "shape")
            and np.isscalar(k)):
        # auto-activate streaming when the dense fp32 matrix cannot fit
        # in device memory with headroom (gpu/loader.hpp streaming mode,
        # test_gpu_oom.R:9) — panels stream through the chunked engine
        # instead of OOMing the accelerator.  NB+ZI streams too (panel-
        # local E-step); GP-family ZI and symmetric need the full matrix
        # resident, so they stay on the in-memory path.
        from .utils.memory import check_dense_alloc
        chk = check_dense_alloc(data.shape[0], data.shape[1],
                                where="device")
        zi_ok = (kwargs.get("zi", "none") in (None, "none")
                 or (kwargs.get("loss") == "nb"
                     and not kwargs.get("test_fraction")
                     and mask is None
                     and not kwargs.get("mask_zeros")))
        if not chk.fits and zi_ok and not kwargs.get("symmetric"):
            from .utils import logging as logmod
            logmod.log_summary(
                "[nmf] %d x %d exceeds device memory (%s); streaming in "
                "column panels", data.shape[0], data.shape[1], chk.message,
                verbose=kwargs.get("verbose") or None)
            streaming = True
    if is_spz or streaming:
        if isinstance(mask, str):
            # mask="zeros" was normalized to mask_zeros above; "NA" needs
            # the full matrix in memory (R/nmf_thin.R:463-465)
            raise ValueError(
                "streaming NMF does not support mask='NA' — NA detection "
                "requires the full matrix in memory; pass an explicit "
                "mask matrix or disable streaming")
        from .io.loaders import InMemoryLoader, SpzLoader
        from .models.nmf_chunked import nmf_chunked
        if not is_spz:
            # same NaN auto-mask / Inf rejection contract as the
            # in-memory path — streaming must not silently produce NaN
            # factors (round-2 review #3).  Sparse inputs stay sparse
            # (the loader panels them); their zeros cannot be NaN, so
            # checking the stored values suffices.
            if _is_sparse(data):
                vals = data.data if hasattr(data, "data") else \
                    np.asarray(data.tocsc().data)
                if np.isnan(vals).any():
                    raise ValueError(
                        "data contains NaN/NA values; streaming cannot "
                        "auto-mask them — impute, or pass an explicit "
                        "mask= matrix")
                if np.isinf(vals).any():
                    raise ValueError("data contains infinite values; clip "
                                     "or remove them before factorization")
            else:
                data = _to_dense_f32(data, allow_nan=True)
                data, mask, _mz_s = _resolve_mask(data, mask)
                if _mz_s:
                    kwargs.setdefault("mask_zeros", True)
        cfg = build_config(int(k),
                           has_mask=mask is not None,
                           has_graph_W=graph_W is not None,
                           has_graph_H=graph_H is not None,
                           **kwargs)
        loader = (SpzLoader(data) if is_spz
                  else InMemoryLoader(data, chunk_cols=chunk_cols))
        return nmf_chunked(loader, cfg, w_init=w_init, h_init=h_init,
                           mask=mask, graph_W=graph_W, graph_H=graph_H,
                           mesh=mesh, on_iteration=on_iteration,
                           checkpoint_path=checkpoint_path,
                           checkpoint_every=checkpoint_every)

    # other file paths auto-load in-memory (R/nmf_validation.R:30-120)
    if isinstance(data, str):
        from .utils.resources import load_data
        data = load_data(data)

    row_names, col_names, data = _extract_dimnames(data)
    sparse_input = _is_sparse(data)
    A = _to_dense_f32(data, allow_nan=True)
    A, mask, _mz = _resolve_mask(A, mask)
    if _mz:
        kwargs.setdefault("mask_zeros", True)
    if kwargs.get("symmetric") and A.shape[0] != A.shape[1]:
        raise ValueError(f"symmetric NMF requires a square matrix, got "
                         f"{A.shape[0]} x {A.shape[1]}")
    if kwargs.get("mask_zeros") and not float(kwargs.get("test_fraction", 0)):
        # non-CV mask="zeros": zeros are missing — exact masked fit where
        # zero entries leave Gram AND RHS (fit_cv.hpp is_holdout==zeros ->
        # apply_gram_correction downdates them).  Under speckled CV the
        # flag instead restricts holdout to nonzeros (handled in nmf_cv).
        zm = np.asarray(A) == 0
        mask = zm if mask is None else (np.asarray(mask, dtype=bool) | zm)

    # CV / sweep / auto-rank paths run host-side mask logic: pull device
    # arrays back once
    def _host(x):
        import jax
        return np.asarray(x, dtype=np.float32) if isinstance(x, jax.Array) else x

    # multi-rank CV sweep / auto-rank dispatch (R/nmf_thin.R:922-1094)
    if isinstance(k, str) and k == "auto":
        from .models.rank_cv import find_optimal_rank
        if "cv_k_range" in kwargs:      # R cv_k_range = c(lo, hi)
            lo, hi = kwargs.pop("cv_k_range")
            kwargs.setdefault("k_init", int(lo))
            kwargs.setdefault("max_k", int(hi))
        return find_optimal_rank(_host(A), mask=mask, **kwargs)
    if not np.isscalar(k):
        from .models.nmf_cv import cv_sweep
        return cv_sweep(_host(A), list(k), mask=mask, **kwargs)

    cfg = build_config(int(k),
                       has_mask=mask is not None,
                       has_graph_W=graph_W is not None,
                       has_graph_H=graph_H is not None,
                       has_target_H=target_H is not None,
                       has_target_W=target_W is not None,
                       **kwargs)

    aux = {}
    if graph_W is not None:
        aux["graph_W"] = _to_dense_f32(graph_W)
    if graph_H is not None:
        aux["graph_H"] = _to_dense_f32(graph_H)
    if target_H is not None:
        t = _to_dense_f32(target_H)
        aux["target_H"] = t
        if cfg.H.target_lambda < 0:
            # PROJ_ADV precompute: T @ T.T / n (nmf/fit.hpp:250-274)
            aux["target_H_gram"] = _gram_over_n(t)
    if target_W is not None:
        t = _to_dense_f32(target_W)
        aux["target_W"] = t
        if cfg.W.target_lambda < 0:
            aux["target_W_gram"] = _gram_over_n(t)

    from .utils import logging as logmod
    logmod.log_summary(
        "[nmf] %d x %d  k=%d  loss=%s  solver=%s  device=%s",
        A.shape[0], A.shape[1], cfg.rank, cfg.loss.value,
        cfg.solver.name.lower(),
        __import__("jax").default_backend(), verbose=cfg.verbose or None)

    def _named(res):
        res.row_names, res.col_names = row_names, col_names
        # SUMMARY: final state; DETAILED: per-iteration tolerances, replayed
        # from the returned history so the fused device loop never syncs
        # for logging (core/logging.hpp LogLevel semantics)
        v = cfg.verbose or None
        logmod.log_summary(
            "[nmf] done: %d iters, converged=%s, loss=%.6g",
            res.iterations, res.converged, res.train_loss, verbose=v)
        if res.loss_history is not None:
            hist = np.asarray(res.loss_history, dtype=float)
            for i, l in enumerate(hist[np.isfinite(hist)]):
                logmod.log_detailed("  iter %4d: loss=%.6g", i + 1, l,
                                    verbose=v)
        return res

    if checkpoint_path is not None:
        # preemption-safe segmented fused fit (SURVEY §5); resumes from the
        # checkpoint if one exists at the path.  mesh= is supported (the
        # pod-scale case): segments run under GSPMD, state gathers to host
        if cfg.is_cv() or mask is not None:
            raise ValueError("checkpoint_path currently supports the "
                             "standard dense fit (no CV/mask)")
        from .utils.checkpoint import fit_checkpointed
        res = fit_checkpointed(A, cfg, checkpoint_path,
                               every=int(checkpoint_every),
                               w_init=w_init, h_init=h_init, aux=aux,
                               sparse_zeros=sparse_input, mesh=mesh)
        res.misc["config"] = cfg
        return _named(res)

    if cfg.is_cv() or mask is not None:
        from .models.nmf_cv import fit_cv_or_masked
        return _named(fit_cv_or_masked(_host(A), cfg, mask=mask, aux=aux,
                                       w_init=w_init, h_init=h_init,
                                       sparse_zeros=sparse_input, mesh=mesh))

    if mesh is not None:
        from .parallel.mesh import fit_sharded
        res = fit_sharded(A, cfg, mesh, w_init=w_init, h_init=h_init)
        res.misc["config"] = cfg
        return _named(res)

    from .models.nmf import nmf_fit
    res = nmf_fit(A, cfg, w_init=w_init, h_init=h_init, aux=aux,
                  sparse_zeros=sparse_input, on_iteration=on_iteration)
    res.misc["config"] = cfg      # predict() reuses stored penalties
    return _named(res)
