"""Regularizer / feature application on Gram and RHS matrices.

JAX equivalents of ``inst/include/FactorNet/features/`` and the
shared application sequence in ``nmf/variant_helpers.hpp:89-146``.  All of
these touch only k x k / k x cols matrices — negligible cost next to the
O(m n k) primitives, exactly the reference's design rationale
(core/config.hpp:20-21).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..config import FactorConfig
from .linalg import PREC


def apply_l1_l2(G, B, L1: float, L2: float):
    """features/sparsity.hpp:41-48: G.diag += L2; B -= L1."""
    if L2 > 0:
        G = G + L2 * jnp.eye(G.shape[0], dtype=G.dtype)
    if L1 > 0:
        B = B - L1
    return G, B


def apply_l21(G, factor, lam: float):
    """features/L21.hpp:52-66: G(i,i) += lam / ||row_i||_2 (guarded)."""
    if lam <= 0:
        return G
    row_norm = jnp.sqrt(jnp.sum(factor * factor, axis=1))
    add = jnp.where(row_norm > 1e-10, lam / jnp.maximum(row_norm, 1e-10), 0.0)
    return G + jnp.diag(add.astype(G.dtype))


def apply_graph_reg(G, laplacian, factor, lam: float):
    """features/graph_reg.hpp:46-59: G += lam * F @ L @ F.T.

    ``laplacian`` is a dense (cols x cols) array here; the reference uses
    a sparse SpMM but the result is identical.
    """
    if lam <= 0 or laplacian is None:
        return G
    FL = jnp.dot(factor, laplacian, precision=PREC)
    return G + lam * jnp.dot(FL, factor.T, precision=PREC)


def apply_target(G, B, fc: FactorConfig, target, target_gram):
    """Target regularization (variant_helpers.hpp:107-145).

    Positive lambda — enrichment: ``G.diag += lam; B += lam * T``.
    Negative lambda — PROJ_ADV batch removal: subtract trace-scaled target
    covariance from G, then eigendecompose and clip eigenvalues to 1e-8.
    """
    lam = fc.target_lambda
    if lam == 0 or target is None and target_gram is None:
        return G, B
    k = G.shape[0]
    if lam > 0:
        G = G + lam * jnp.eye(k, dtype=G.dtype)
        B = B + lam * target
        return G, B
    # PROJ_ADV: target_gram = T @ T.T / n precomputed (nmf/fit.hpp:250-274)
    abs_lam = abs(lam)
    trace_G = jnp.trace(G)
    trace_GT = jnp.trace(target_gram)
    scale = jnp.where(trace_GT > 1e-10, trace_G / jnp.maximum(trace_GT, 1e-10), 0.0)
    G = G - abs_lam * scale * target_gram
    evals, evecs = jnp.linalg.eigh(G)
    # clip RELATIVE to G's scale: the reference's constant 1e-8
    # (variant_helpers.hpp:132) is below fp32 resolution of typical Gram
    # magnitudes, letting the reconstructed G go indefinite and the
    # downstream Cholesky produce NaNs
    floor = jnp.maximum(1e-8, 1e-6 * jnp.max(jnp.abs(evals)))
    evals = jnp.maximum(evals, floor)
    G = jnp.dot(evecs * evals[None, :], evecs.T, precision=PREC)
    return G, B


def apply_features(G, B, factor, fc: FactorConfig, *, graph=None,
                   target=None, target_gram=None):
    """The full shared sequence (variant_helpers.hpp:89-146)."""
    G, B = apply_l1_l2(G, B, fc.L1, fc.L2)
    if fc.graph_lambda > 0:
        G = apply_graph_reg(G, graph, factor, fc.graph_lambda)
    G = apply_l21(G, factor, fc.L21)
    if fc.target_lambda != 0:
        G, B = apply_target(G, B, fc, target, target_gram)
    return G, B


def tier2_gram_addition(factor, fc: FactorConfig, graph=None):
    """Shared tier-2 Gram addition for per-column-Gram solves.

    The reference CV loop applies graph-reg + L21 to the FULL Gram before the
    per-column test downdate (``apply_cv_features``, variant_helpers.hpp:174-189,
    called at fit_cv.hpp:417,581 and cv_detail.hpp:168,272).  Since both terms
    depend only on the previous iterate of the factor being solved, they are
    one shared k x k matrix added to every per-column (weighted) Gram —
    identical algebra, one matmul instead of n.

    Returns None when neither feature is configured (static decision).
    """
    has_graph = graph is not None and fc.graph_lambda > 0
    if not has_graph and fc.L21 <= 0:
        return None
    k = factor.shape[0]
    GA = jnp.zeros((k, k), factor.dtype)
    if has_graph:
        GA = apply_graph_reg(GA, graph, factor, fc.graph_lambda)
    if fc.L21 > 0:
        GA = apply_l21(GA, factor, fc.L21)
    return GA


def apply_upper_bound(X, upper_bound: float):
    """features/bounds.hpp:38-42."""
    if upper_bound <= 0:
        return X
    return jnp.minimum(X, upper_bound)


def apply_angular_posthoc(factor, lam: float):
    """Post-NNLS angular decorrelation (features/angular.hpp:95-135).

    Gradient step on sum of pairwise cosines, then clip to nonneg.
    """
    if lam <= 0:
        return factor
    row_norms = jnp.sqrt(jnp.sum(factor * factor, axis=1))
    safe = jnp.maximum(row_norms, 1e-15)
    F_hat = jnp.where(row_norms[:, None] > 1e-15, factor / safe[:, None], factor)
    cos_mat = jnp.dot(F_hat, F_hat.T, precision=PREC)
    cos_mat = cos_mat - jnp.diag(jnp.diag(cos_mat))
    grad = jnp.dot(cos_mat, F_hat, precision=PREC) * row_norms[:, None]
    return jnp.maximum(factor - lam * grad, 0.0)


def apply_angular_gram(G, factor, lam: float):
    """Gram-based angular penalty used by SVD paths (angular.hpp:44-70)."""
    if lam <= 0:
        return G
    overlap = jnp.dot(factor, factor.T, precision=PREC)
    norms = jnp.sqrt(jnp.diag(overlap))
    safe = jnp.where(norms > 0, norms, 1.0)
    overlap = overlap / safe[:, None] / safe[None, :]
    return G + lam * overlap
