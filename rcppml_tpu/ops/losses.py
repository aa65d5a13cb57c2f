"""Distribution math: IRLS weights, NLL/deviance contributions, variance.

Vectorized JAX equivalents of ``inst/include/FactorNet/math/loss.hpp``.
Every function operates elementwise on (m, n) arrays (mu = predicted mean),
so weights/losses are a single fused VPU pass on device.  The reference
computes these per-entry in fp64; here fp32 with the same clamps — the
cross-backend contract is statistical equivalence, not bitwise identity
(rng/rng.hpp:24-25).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import Dispersion, Loss, NMFConfig

_W_CAP = 1e6


def _expand_theta(theta_row, theta_col, shape):
    """Broadcast per-row / per-col dispersion to (m, n)."""
    if theta_col is not None:
        return jnp.broadcast_to(theta_col[None, :], shape)
    if theta_row is not None:
        return jnp.broadcast_to(theta_row[:, None], shape)
    return jnp.zeros(shape)


# ---------------------------------------------------------------------------
# IRLS weights (loss.hpp:150-303)
# ---------------------------------------------------------------------------

def irls_weight_kl(mu):
    """w = 1 / max(mu, 1e-4) (loss.hpp:177-179)."""
    return 1.0 / jnp.maximum(mu, 1e-4)


def irls_weight_gp(y, mu, theta, blend=1.0):
    """Fisher-information GP weight with adaptive KL blend (loss.hpp:198-229)."""
    s = jnp.maximum(mu, 1e-15)
    eff_blend = blend * jnp.minimum(s, 1.0)
    w_gp = 1.0 / (s * s)
    denom = jnp.maximum(s + theta * y, 1e-15)
    w_gp = w_gp + jnp.where(y >= 1.0, (y - 1.0) / (denom * denom), 0.0)
    log_w_kl = -jnp.log(s)
    log_w_gp = jnp.log(jnp.maximum(w_gp, 1e-30))
    w = jnp.exp((1.0 - eff_blend) * log_w_kl + eff_blend * log_w_gp)
    return jnp.minimum(w, _W_CAP)


def irls_weight_nb(mu, r):
    """w = r / (mu (r + mu)) (loss.hpp:249-256)."""
    mu = jnp.maximum(mu, 1e-15)
    r = jnp.maximum(r, 1e-10)
    return jnp.minimum(r / (mu * (r + mu)), _W_CAP)


def irls_weight_power(mu, p):
    """w = 1 / mu^p for V(mu) = mu^p families (loss.hpp:271-277)."""
    mu = jnp.maximum(mu, 1e-15)
    return jnp.minimum(mu ** (-p), _W_CAP)


def variance_fn(mu, cfg: NMFConfig, theta):
    """V(mu) per distribution (loss.hpp:560-590)."""
    mu = jnp.maximum(mu, 1e-10)
    if cfg.loss in (Loss.GP, Loss.KL):
        return mu
    if cfg.loss == Loss.NB:
        r = jnp.maximum(theta, 1e-10)
        return mu + mu * mu / r
    if cfg.loss == Loss.GAMMA:
        return mu * mu
    if cfg.loss == Loss.INVGAUSS:
        return mu * mu * mu
    if cfg.loss == Loss.TWEEDIE:
        return mu ** cfg.tweedie_power
    return jnp.ones_like(mu)          # Gaussian


def compute_irls_weight(A, mu, cfg: NMFConfig, theta):
    """Distribution weight x optional Huber-on-Pearson robust modifier
    (nnls_batch_irls.hpp:96-122).  ``theta`` already broadcast to A.shape.
    """
    loss = cfg.loss
    if loss == Loss.KL:
        w = irls_weight_kl(mu)
    elif loss == Loss.GP:
        w = irls_weight_gp(A, mu, theta, blend=cfg.gp_blend)
    elif loss == Loss.NB:
        w = irls_weight_nb(mu, theta)
    elif loss == Loss.GAMMA:
        w = irls_weight_power(mu, 2.0)
    elif loss == Loss.INVGAUSS:
        w = irls_weight_power(mu, 3.0)
    elif loss == Loss.TWEEDIE:
        w = irls_weight_power(mu, cfg.tweedie_power)
    else:
        w = jnp.ones_like(mu)         # MSE (robust-only path)

    if cfg.robust_delta > 0:
        # Pearson residual via sqrt of distribution weight
        sd_inv = jnp.sqrt(jnp.maximum(w, 1e-15))
        pearson = (A - mu) * sd_inv
        abs_p = jnp.abs(pearson)
        w_rob = jnp.where(abs_p <= cfg.robust_delta, 1.0,
                          cfg.robust_delta / (abs_p + 1e-15))
        w = w * w_rob
    return w


# ---------------------------------------------------------------------------
# Loss contributions (loss.hpp:312-500)
# ---------------------------------------------------------------------------

def loss_mse(y, mu):
    d = y - mu
    return d * d


def loss_kl(y, mu, eps=1e-10):
    y = jnp.maximum(y, eps)
    mu = jnp.maximum(mu, eps)
    return y * jnp.log(y / mu) - y + mu


def loss_gp(y, mu, theta):
    """GP NLL up to log(y!) (loss.hpp:383-398)."""
    s = jnp.maximum(mu, 1e-10)
    otp = 1.0 + theta
    out = -jnp.log(s / otp)
    inner = jnp.maximum((s + theta * y) / otp, 1e-10)
    out = out - jnp.where(y >= 1.0, (y - 1.0) * jnp.log(inner), 0.0)
    return out + (s + theta * y) / otp


def loss_nb(y, mu, r):
    """NB NLL up to lgamma(y+1) (loss.hpp:416-426).

    For large r (near-Poisson genes saturate the nb_size_max=1e6 cap,
    core/config.hpp:189) the direct form cancels catastrophically in
    fp32: lgamma(1e6) ~ 1.29e7 has ulp ~1, so lgamma(y+r)-lgamma(r)
    carries O(1) absolute error per entry — enough to destabilize
    rel-tol stopping and CV best_iter.  The large-r branch recombines
    via Stirling into log1p terms of small arguments
    (error ~ y/(12 r^2), < 1e-8*y at the threshold):

      NLL = (y+r)*log1p(mu/r) - (r+y-1/2)*log1p(y/r) + y - y*log(mu)

    which limits to the Poisson NLL  mu - y*log(mu)  as r -> inf.
    Measured fp32-vs-float64 max abs error on Poisson(3) counts: direct
    5.6e-4 @ r=1e3 growing to 2.3e-1 @ r=1e6; stable 2.7e-5 @ r=300 and
    ~2e-6 beyond — crossover near r=300.
    """
    mu = jnp.maximum(mu, 1e-10)
    r = jnp.maximum(r, 1e-10)
    direct = (-jax.lax.lgamma(y + r) + jax.lax.lgamma(r)
              - r * jnp.log(r / (r + mu)) - y * jnp.log(mu / (r + mu)))
    stable = ((y + r) * jnp.log1p(mu / r)
              - (r + y - 0.5) * jnp.log1p(y / r) + y - y * jnp.log(mu))
    return jnp.where(r > 300.0, stable, direct)


def loss_gamma(y, mu):
    y = jnp.maximum(y, 1e-10)
    mu = jnp.maximum(mu, 1e-10)
    return 2.0 * (-jnp.log(y / mu) + (y - mu) / mu)


def loss_invgauss(y, mu):
    y = jnp.maximum(y, 1e-10)
    mu = jnp.maximum(mu, 1e-10)
    d = y - mu
    return d * d / (mu * mu * y)


def loss_tweedie(y, mu, p: float):
    """Tweedie power deviance with p~1 / p~2 special cases (loss.hpp:480-500)."""
    y = jnp.maximum(y, 1e-10)
    mu = jnp.maximum(mu, 1e-10)
    if abs(p - 1.0) < 1e-6:
        return 2.0 * (y * jnp.log(y / mu) - (y - mu))
    if abs(p - 2.0) < 1e-6:
        return loss_gamma(y, mu)
    omp, tmp = 1.0 - p, 2.0 - p
    return 2.0 * (y ** tmp / (omp * tmp) - y * mu ** omp / omp + mu ** tmp / tmp)


def compute_loss_elements(A, mu, cfg: NMFConfig, theta):
    """Per-element loss (deviance/NLL); Huber-on-Pearson if robust
    (loss.hpp:505-599).  ``theta`` broadcast to A.shape."""
    if cfg.robust_delta > 0:
        mu_c = jnp.maximum(mu, 1e-10)
        var = variance_fn(mu_c, cfg, theta)
        sd = jnp.sqrt(jnp.maximum(var, 1e-20))
        pr = (A - mu_c) / sd
        abs_pr = jnp.abs(pr)
        delta = cfg.robust_delta
        return jnp.where(abs_pr <= delta, 0.5 * pr * pr,
                         delta * abs_pr - 0.5 * delta * delta)
    loss = cfg.loss
    if loss == Loss.MSE:
        return loss_mse(A, mu)
    if loss == Loss.KL:
        return loss_kl(A, mu)
    if loss == Loss.GP:
        return loss_gp(A, mu, theta)
    if loss == Loss.NB:
        return loss_nb(A, mu, theta)
    if loss == Loss.GAMMA:
        return loss_gamma(A, mu)
    if loss == Loss.INVGAUSS:
        return loss_invgauss(A, mu)
    if loss == Loss.TWEEDIE:
        return loss_tweedie(A, mu, cfg.tweedie_power)
    raise ValueError(f"unknown loss {loss}")


def explicit_loss(A, W_Td, H, cfg: NMFConfig, theta_row=None, theta_col=None,
                  nz_only: bool = False):
    """Explicit loss over all (dense) or nonzero (sparse-semantics) entries
    (nmf/explicit_loss.hpp:54-107)."""
    mu = jnp.dot(W_Td.T, H, precision=jax.lax.Precision.HIGHEST)
    theta = _expand_theta(theta_row, theta_col, A.shape)
    contrib = compute_loss_elements(A, mu, cfg, theta)
    if nz_only:
        contrib = jnp.where(A != 0, contrib, 0.0)
    return jnp.sum(contrib)
