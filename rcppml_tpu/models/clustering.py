"""Rank-2 divisive clustering + consensus NMF.

JAX equivalents of ``inst/include/FactorNet/clustering/`` and
``R/{bipartition,dclust,consensus}.R``:

  * :func:`bipartition` — rank-2 NMF with the closed-form 2x2 NNLS solve
    (clustering/bipartition.hpp:190-222), vectorized over ALL columns at
    once on device; samples split by h1 - h2 sign
    (bipartition.hpp:377-407).
  * :func:`dclust` — recursive divisive clustering with binary path ids
    (clustering/dclust.hpp:38-80).
  * :func:`consensus_nmf` — multi-run NMF -> consensus matrix -> cophenetic
    stability (R/consensus.R:75).
  * :func:`bipartite_match` — Hungarian factor alignment
    (R/bipartiteMatch.R:20, vendored RcppHungarian.h); uses
    scipy's LAPJV implementation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import List, Optional

import numpy as np

import jax
import jax.numpy as jnp

from .. import rng as rng_mod
from ..ops.linalg import PREC


@dataclass
class BipartitionResult:
    v: np.ndarray                  # signed split signal per sample
    dist: float                    # relative-cosine separation (or -1)
    size1: int
    size2: int
    samples1: np.ndarray
    samples2: np.ndarray
    center1: Optional[np.ndarray] = None
    center2: Optional[np.ndarray] = None


@dataclass
class Cluster:
    id: str
    samples: np.ndarray
    center: np.ndarray
    size: int
    dist: float = -1.0
    leaf: bool = True


def _nnls2_batch(a00, a01, a11, b0, b1, nonneg):
    """Closed-form 2x2 (N)NLS for a batch of RHS (bipartition.hpp:190-203)."""
    denom = a00 * a11 - a01 * a01
    denom = jnp.where(jnp.abs(denom) > 1e-30, denom, 1e-30)
    x0 = (b0 * a11 - b1 * a01) / denom
    x1 = (b1 * a00 - b0 * a01) / denom
    if nonneg:
        x0 = jnp.maximum(x0, 0.0)
        x1 = jnp.maximum(x1, 0.0)
    return x0, x1


def _rank2_body(A_sub, w, nonneg=True):
    """One rank-2 ALS sweep over all selected columns (bipartition.hpp:342-371).

    A_sub (m, ns); w (2, m).  Returns (w_new, h, d)."""
    a = jnp.dot(w, w.T, precision=PREC)
    B = jnp.dot(w, A_sub, precision=PREC)          # (2, ns)
    h0, h1 = _nnls2_batch(a[0, 0], a[0, 1], a[1, 1], B[0], B[1], nonneg)
    h = jnp.stack([h0, h1])
    d = jnp.sum(jnp.abs(h), axis=1) + 1e-15
    h = h / d[:, None]

    a2 = jnp.dot(h, h.T, precision=PREC)
    Bw = jnp.dot(h, A_sub.T, precision=PREC)       # (2, m)
    w0, w1 = _nnls2_batch(a2[0, 0], a2[0, 1], a2[1, 1], Bw[0], Bw[1], nonneg)
    w_new = jnp.stack([w0, w1])
    dw = jnp.sum(jnp.abs(w_new), axis=1) + 1e-15
    w_new = w_new / dw[:, None]
    return w_new, h, dw


@partial(jax.jit, static_argnames=("nonneg",))
def _rank2_als_step(A_sub, w, nonneg=True):
    return _rank2_body(A_sub, w, nonneg)


def _rank2_block_body(A_sub, w, h, d, nonneg=True):
    """Ten ALS sweeps plus the correlation-distance convergence metric
    between the first and last w (cor() tol)."""
    w_start = w

    def body(i, carry):
        w, h, d = carry
        return _rank2_body(A_sub, w, nonneg)

    w, h, d = jax.lax.fori_loop(0, 10, body, (w, h, d))
    a = w.ravel()
    b = w_start.ravel()
    am = a - jnp.mean(a)
    bm = b - jnp.mean(b)
    denom = jnp.sqrt(jnp.sum(am * am) * jnp.sum(bm * bm))
    cor = jnp.where(denom > 0, jnp.sum(am * bm) / denom, 1.0)
    return w, h, d, 1.0 - cor


@jax.jit
def _rank2_als_block(A_sub, w, h, d):
    """One 10-sweep block (used by the streaming/host drivers)."""
    return _rank2_block_body(A_sub, w, h, d)


@partial(jax.jit, static_argnames=("nonneg",))
def _rank2_als_full(A_sub, w, h, d, tol, max_blocks, nonneg=True):
    """The whole bipartition ALS — all 10-sweep blocks AND the
    convergence test — in one lax.while_loop: a single device dispatch
    replaces the per-block host sync."""
    def cond(carry):
        _, _, _, cd, blk = carry
        return (blk < max_blocks) & (cd >= tol)

    def body(carry):
        w, h, d, _, blk = carry
        w, h, d, cd = _rank2_block_body(A_sub, w, h, d, nonneg)
        return (w, h, d, cd, blk + 1)

    w, h, d, cd, _ = jax.lax.while_loop(
        cond, body, (w, h, d, jnp.float32(jnp.inf), jnp.int32(0)))
    return w, h, d


@jax.jit
def _rel_cosine_dev(A_sub, pos):
    """Device-side relative cosine separation (bipartition.hpp:92-130) for
    the device-resident fast path: centers and projections never leave
    the accelerator."""
    posf = pos.astype(jnp.float32)
    n1 = jnp.maximum(jnp.sum(posf), 1.0)
    n2 = jnp.maximum(jnp.sum(1.0 - posf), 1.0)
    center1 = jnp.dot(A_sub, posf, precision=PREC) / n1
    center2 = jnp.dot(A_sub, 1.0 - posf, precision=PREC) / n2
    c1n = jnp.sqrt(jnp.sum(center1 ** 2))
    c2n = jnp.sqrt(jnp.sum(center2 ** 2))
    x_c1 = jnp.dot(center1, A_sub, precision=PREC)
    x_c2 = jnp.dot(center2, A_sub, precision=PREC)
    d1 = (jnp.sqrt(jnp.maximum(x_c2, 0.0)) * c1n) / \
        (jnp.sqrt(jnp.maximum(x_c1, 1e-30)) * c2n)
    d2 = (jnp.sqrt(jnp.maximum(x_c1, 0.0)) * c2n) / \
        (jnp.sqrt(jnp.maximum(x_c2, 1e-30)) * c1n)
    term = jnp.where(pos, d1, d2)
    term = jnp.where(jnp.isnan(term), 0.0, term)
    dist = 1.0 - jnp.sum(term) / A_sub.shape[1]
    return jnp.where((c1n > 0) & (c2n > 0), dist, -1.0), center1, center2


def _cor_dist(w, w_old):
    """1 - Pearson correlation between consecutive w iterates (tol metric)."""
    a = np.asarray(w).ravel()
    b = np.asarray(w_old).ravel()
    sa, sb = a.std(), b.std()
    if sa == 0 or sb == 0:
        return 0.0
    return float(1.0 - np.corrcoef(a, b)[0, 1])


def _rel_cosine(A_sub_np, v_pos, center1, center2):
    """Relative cosine separation (bipartition.hpp:92-130)."""
    c1n = np.sqrt((center1 ** 2).sum())
    c2n = np.sqrt((center2 ** 2).sum())
    if c1n == 0 or c2n == 0:
        return -1.0
    x_c1 = center1 @ A_sub_np            # (ns,)
    x_c2 = center2 @ A_sub_np
    with np.errstate(divide="ignore", invalid="ignore"):
        d1 = (np.sqrt(np.maximum(x_c2[v_pos], 0)) * c1n) / \
             (np.sqrt(np.maximum(x_c1[v_pos], 1e-30)) * c2n)
        d2 = (np.sqrt(np.maximum(x_c1[~v_pos], 0)) * c2n) / \
             (np.sqrt(np.maximum(x_c2[~v_pos], 1e-30)) * c1n)
    n_tot = len(x_c1)
    return float(1.0 - (np.nansum(d1) + np.nansum(d2)) / n_tot)


def bipartition(data, *, tol: float = 1e-5, maxit: int = 100,
                nonneg: bool = True, samples=None, seed: int = 0,
                calc_dist: bool = True) -> BipartitionResult:
    """Rank-2 NMF split of samples (columns) — R/bipartition.R:62,
    clustering/bipartition.hpp:426-452.

    A device-resident ``data`` (jax.Array) with ``samples=None`` runs the
    whole split — ALS blocks, convergence, centers, and the relative-cosine
    separation — on device with one dispatch and one small transfer."""
    device_in = isinstance(data, jax.Array) and samples is None
    if device_in:
        A = None
        A_sub = data.astype(jnp.float32)
        m, n = A_sub.shape
        samples = np.arange(n)
    else:
        # todense BEFORE asarray: np.asarray(sparse, dtype=...) raises
        A = (np.asarray(data.todense(), dtype=np.float32)
             if hasattr(data, "todense")
             else np.asarray(data, dtype=np.float32))
        m, n = A.shape
        if samples is None:
            samples = np.arange(n)
        samples = np.asarray(samples)
        A_sub = jnp.asarray(A[:, samples])

    # row-major 2 x m init from the sequential stream (bipartition.hpp:438-444)
    vals = rng_mod.next_u64(seed if seed != 0 else 12345, 2 * m)
    w = jnp.asarray((vals.astype(np.float32) / np.float32(2 ** 64))
                    .reshape(2, m))

    h = jnp.zeros((2, len(samples)), jnp.float32)
    d = jnp.ones((2,), jnp.float32)
    # whole ALS (blocks of 10 sweeps + convergence) in ONE device call
    w, h, d = _rank2_als_full(A_sub, w, h, d, jnp.float32(tol),
                              jnp.int32(max(1, maxit // 10)),
                              nonneg=bool(nonneg))

    h_np, d_np = jax.device_get((h, d))
    h_np = np.asarray(h_np)
    d_np = np.asarray(d_np)
    if d_np[0] > d_np[1]:
        v = h_np[0] - h_np[1]
    else:
        v = h_np[1] - h_np[0]
    pos = v > 0
    samples1 = samples[pos]
    samples2 = samples[~pos]

    dist = -1.0
    center1 = center2 = None
    if calc_dist and len(samples1) and len(samples2):
        if device_in:
            dist, c1, c2 = jax.device_get(
                _rel_cosine_dev(A_sub, jnp.asarray(pos)))
            dist = float(dist)
            center1, center2 = np.asarray(c1), np.asarray(c2)
        else:
            A_np = A[:, samples]
            center1 = A[:, samples1].mean(axis=1)
            center2 = A[:, samples2].mean(axis=1)
            dist = _rel_cosine(A_np, pos, center1, center2)

    return BipartitionResult(v=v, dist=dist, size1=int(pos.sum()),
                             size2=int((~pos).sum()),
                             samples1=samples1, samples2=samples2,
                             center1=center1, center2=center2)


def dclust(data, *, min_samples: int = 10, min_dist: float = 0.0,
           tol: float = 1e-5, maxit: int = 100, nonneg: bool = True,
           seed: int = 0, max_depth: int = 100) -> List[Cluster]:
    """Recursive divisive clustering (clustering/dclust.hpp:72+).

    Cluster ids are binary path strings ("0", "01", "011", ...)."""
    A = (np.asarray(data.todense(), dtype=np.float32)
         if hasattr(data, "todense")
         else np.asarray(data, dtype=np.float32))
    n = A.shape[1]

    result: List[Cluster] = []
    queue = [Cluster(id="0", samples=np.arange(n), center=A.mean(axis=1),
                     size=n)]
    while queue:
        cl = queue.pop(0)
        depth = len(cl.id)
        if cl.size < 2 * min_samples or depth >= max_depth:
            result.append(cl)
            continue
        bp = bipartition(A, tol=tol, maxit=maxit, nonneg=nonneg,
                         samples=cl.samples, seed=seed + depth,
                         calc_dist=True)
        if (bp.size1 < min_samples or bp.size2 < min_samples or
                (min_dist > 0 and bp.dist < min_dist)):
            cl.dist = bp.dist
            result.append(cl)
            continue
        cl.leaf = False
        queue.append(Cluster(id=cl.id + "0", samples=bp.samples1,
                             center=bp.center1, size=bp.size1, dist=bp.dist))
        queue.append(Cluster(id=cl.id + "1", samples=bp.samples2,
                             center=bp.center2, size=bp.size2, dist=bp.dist))
    return result


def bipartite_match(cost_matrix) -> dict:
    """Hungarian assignment (R/bipartiteMatch.R:20, RcppHungarian.h)."""
    from scipy.optimize import linear_sum_assignment
    cost = np.asarray(cost_matrix, dtype=np.float64)
    rows, cols = linear_sum_assignment(cost)
    return {"cost": float(cost[rows, cols].sum()),
            "pairs": np.stack([rows, cols], axis=1)}


def align_factors(ref_W: np.ndarray, W: np.ndarray):
    """Align factor columns of W to ref_W by Hungarian on cosine distance
    (R/nmf_methods.R `align`)."""
    rn = ref_W / np.maximum(np.linalg.norm(ref_W, axis=0), 1e-15)
    wn = W / np.maximum(np.linalg.norm(W, axis=0), 1e-15)
    cos = rn.T @ wn
    match = bipartite_match(1.0 - cos)
    perm = match["pairs"][:, 1]
    return perm, cos[np.arange(len(perm)), perm]


def consensus_nmf(data, k: int, *, n_runs: int = 10, seed: int = 0,
                  method: str = "hard", maxit: int = 100, tol: float = 1e-4,
                  **nmf_kwargs) -> dict:
    """Multi-run NMF consensus clustering (R/consensus.R:75).

    ``method='hard'``: samples co-cluster when argmax factor matches.
    Returns consensus matrix, cophenetic correlation, and the aligned runs.
    """
    from ..api import nmf as nmf_api
    A = np.asarray(data, dtype=np.float32)
    n = A.shape[1]
    runs = []
    consensus = np.zeros((n, n), dtype=np.float64)
    for r in range(n_runs):
        res = nmf_api(A, k, seed=seed + r * 1000 + 1, maxit=maxit, tol=tol,
                      **nmf_kwargs)
        runs.append(res)
        if method == "knn_jaccard":
            # co-clustering via shared k-NN sets in embedding space
            E = np.asarray(res.H).T
            d2 = ((E[:, None, :] - E[None]) ** 2).sum(-1)
            knn = min(15, n - 1)
            nbrs = np.argsort(d2, axis=1)[:, 1:knn + 1]
            sets = [set(row.tolist()) for row in nbrs]
            for i in range(n):
                for j in range(i + 1, n):
                    inter = len(sets[i] & sets[j])
                    jac = inter / (2 * knn - inter) if inter else 0.0
                    consensus[i, j] += jac
                    consensus[j, i] += jac
            consensus[np.arange(n), np.arange(n)] += 1.0
        else:
            labels = np.argmax(res.H, axis=0)
            same = labels[:, None] == labels[None, :]
            consensus += same
    consensus /= n_runs

    # cophenetic correlation of the consensus matrix (stability measure)
    from scipy.cluster.hierarchy import cophenet, linkage
    from scipy.spatial.distance import squareform
    dist = 1.0 - consensus
    np.fill_diagonal(dist, 0.0)
    dist = (dist + dist.T) / 2
    cond = squareform(dist, checks=False)
    if cond.size and cond.max() > 0:
        Z = linkage(cond, method="average")
        coph, _ = cophenet(Z, cond)
        coph = float(coph)
    else:
        coph = 1.0
    labels = np.argmax(runs[0].H, axis=0)
    return {"consensus": consensus, "cophenetic": coph, "runs": runs,
            "labels": labels, "k": k}
