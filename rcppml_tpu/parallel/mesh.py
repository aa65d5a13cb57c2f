"""Multi-chip execution: 2-D (rows, cols) mesh over jax.sharding.

The distributed design the reference lacks (SURVEY.md §5: its parallelism is
single-node OpenMP + one GPU).  Here:

  * A is block-sharded (rows, cols) across the mesh;
  * W_T (k, m) is sharded over the row axis and replicated across cols;
  * H (k, n) is sharded over the col axis and replicated across rows;
  * k x k Gram products psum over the sharded axis — GSPMD inserts the
    all-reduces automatically from the data shardings, riding ICI;
  * the H-update solve is embarrassingly parallel over column shards, the
    W-update over row shards.

Because the ALS step is pure functional JAX, multi-chip execution is the
SAME compiled program as single-chip — only the input shardings differ.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import NMFConfig


def check_device_health(devices=None, *, timeout: float = 60.0):
    """Verify every device computes: a tiny committed computation per chip,
    with a timeout so a hung device is reported rather than deadlocking
    the job (SURVEY §5 failure-detection: catch a dead chip at mesh init,
    not mid-fit).  Raises RuntimeError naming the failing devices."""
    import concurrent.futures

    devices = list(devices if devices is not None else jax.devices())

    def probe(dev):
        x = jax.device_put(jnp.asarray([1.0, 2.0], jnp.float32), dev)
        y = np.asarray(jax.device_get(x * 2.0 + 1.0))
        if not np.allclose(y, [3.0, 5.0]):
            raise RuntimeError(f"wrong arithmetic result {y}")

    bad = []
    hung = False
    ex = concurrent.futures.ThreadPoolExecutor(max_workers=4)
    try:
        futs = {ex.submit(probe, d): d for d in devices}
        for fut, dev in futs.items():
            try:
                fut.result(timeout=timeout)
            except concurrent.futures.TimeoutError:
                hung = True
                bad.append(f"{dev}: no response within {timeout:.0f}s (hung)")
            except Exception as e:                       # noqa: BLE001
                bad.append(f"{dev}: {e!r}")
    finally:
        # a probe stuck on a wedged device would make shutdown(wait=True)
        # block forever — exactly the deadlock this check exists to
        # prevent; leave hung worker threads behind instead
        ex.shutdown(wait=not hung, cancel_futures=True)
    if bad:
        raise RuntimeError("unhealthy devices at mesh init:\n  "
                           + "\n  ".join(bad))
    return devices


def default_mesh(devices=None, shape=None, *, health_check: bool = False) -> Mesh:
    """Build a (rows, cols) mesh over the given (or all) devices.

    ``shape``: optional (n_rows, n_cols); defaults to the most square
    factorization of the device count, biased toward the cols axis (samples
    usually outnumber features).  ``health_check=True`` probes every device
    first (:func:`check_device_health`).
    """
    devices = list(devices if devices is not None else jax.devices())
    if health_check:
        check_device_health(devices)
    n = len(devices)
    if shape is None:
        r = int(math.sqrt(n))
        while n % r:
            r -= 1
        shape = (r, n // r)
    arr = np.asarray(devices).reshape(shape)
    return Mesh(arr, ("rows", "cols"))


def mesh_padding(mesh: Mesh, m: int, n: int):
    """Zero-padding needed to make (m, n) divisible by the mesh shape."""
    mr, mc = mesh.shape["rows"], mesh.shape["cols"]
    return (-m) % mr, (-n) % mc


def check_pad_soundness(cfg: NMFConfig, pm: int, pn: int) -> None:
    """Reject the one configuration where mesh zero-padding is unsound.

    Pads solve to exact zeros except when ``nonneg=False`` combines with
    ``L1 > 0``: the unconstrained solve of b = -L1 is off zero, so padded
    rows/columns would leak nonzero factor mass into Grams and losses
    (see :func:`pad_to_mesh`).  Raising here turns silent wrongness into
    an actionable error (round-2 review: Weak #2)."""
    if not (pm or pn):
        return
    bad = [side for side, fc in (("W", cfg.W), ("H", cfg.H))
           if not fc.nonneg and fc.L1 > 0]
    if bad:
        raise ValueError(
            f"semi-NMF (nonneg=False) with L1 > 0 on {'/'.join(bad)} is "
            f"unsound with mesh zero-padding (pads would solve off zero); "
            f"pad the data to mesh-divisible dimensions yourself or drop "
            f"L1 on the unconstrained factor")


def pad_to_mesh(mesh: Mesh, A, W_T, H):
    """Zero-pad A/W_T/H so every dimension divides the mesh.

    Exact for ALS-NMF: an all-zero row/column has RHS b = 0, so its factor
    solves to exactly 0 (nonneg clip, or b=0 with L1=0) and contributes
    nothing to Grams, losses, or normalization.  The one combination where
    pads could go nonzero is L1 > 0 with nonneg=False (b = -L1 pushes the
    unconstrained solve off zero) — callers keep the semi-NMF + L1 combo on
    divisible shapes.
    """
    pm, pn = mesh_padding(mesh, A.shape[0], A.shape[1])
    if pm:
        A = jnp.pad(A, ((0, pm), (0, 0)))
        W_T = jnp.pad(W_T, ((0, 0), (0, pm)))
    if pn:
        A = jnp.pad(A, ((0, 0), (0, pn)))
        H = jnp.pad(H, ((0, 0), (0, pn)))
    return A, W_T, H


def shard_arrays(mesh: Mesh, A, W_T, H, d, *, pad: bool = True):
    """Place the factor model onto the mesh with the canonical shardings,
    zero-padding to mesh-divisible shapes first (see :func:`pad_to_mesh`)."""
    if pad:
        A, W_T, H = pad_to_mesh(mesh, A, W_T, H)
    s_A = NamedSharding(mesh, P("rows", "cols"))
    s_W = NamedSharding(mesh, P(None, "rows"))
    s_H = NamedSharding(mesh, P(None, "cols"))
    s_r = NamedSharding(mesh, P())
    return (jax.device_put(A, s_A), jax.device_put(W_T, s_W),
            jax.device_put(H, s_H), jax.device_put(d, s_r))


def fit_sharded(A, cfg: NMFConfig, mesh: Optional[Mesh] = None, *,
                w_init=None, h_init=None):
    """Multi-chip NMF fit: shard inputs over the mesh and run the standard
    jitted ALS loop — GSPMD partitions the compute to match.
    """
    from ..models import nmf as nmf_mod

    mesh = mesh or default_mesh()
    if cfg.fused_vmem:
        raise ValueError("fused_vmem is a single-device fit — "
                         "incompatible with a sharded mesh fit")
    # an already-sharded global jax.Array (e.g. multihost.shard_host_data)
    # must NOT be pulled to host — in multi-process mode no host holds it
    device_in = isinstance(A, jax.Array)
    if not device_in:
        A = np.asarray(A, dtype=np.float32)
    m, n = A.shape
    check_pad_soundness(cfg, *mesh_padding(mesh, m, n))
    W_T0, H0, d0 = nmf_mod.init_factors(
        cfg, m, n, A=None if device_in else A,
        w_init=w_init, h_init=h_init)
    if device_in:
        pm, pn = mesh_padding(mesh, m, n)
        if pm or pn:
            raise ValueError(
                f"device-resident input of shape {(m, n)} does not divide "
                f"the mesh {dict(mesh.shape)}; pad it before sharding "
                "(host inputs are padded automatically)")
        s_W = NamedSharding(mesh, P(None, "rows"))
        s_H = NamedSharding(mesh, P(None, "cols"))
        A_d = A
        W_d = jax.device_put(jnp.asarray(W_T0), s_W)
        H_d = jax.device_put(jnp.asarray(H0), s_H)
        d_d = jax.device_put(jnp.asarray(d0), NamedSharding(mesh, P()))
    else:
        A_d, W_d, H_d, d_d = shard_arrays(mesh, A, W_T0, H0, d0)
    padded = A_d.shape != (m, n)
    if cfg.requires_irls():
        from ..models.nmf_irls import fit_irls
        res = fit_irls(A_d, cfg, W_d, H_d, d_d, {},
                       valid_dims=(m, n) if padded else None)
    else:
        state = nmf_mod._fit_mse(cfg, A_d, W_d, H_d, d_d, {})
        res = nmf_mod.finalize_result(cfg, state)
    return unpad_result(res, cfg, m, n)


def unpad_result(res, cfg: NMFConfig, m: int, n: int):
    """Slice mesh zero-padding back off a fitted result (pads solve to
    exact zeros); shared by the sharded and checkpointed-sharded drivers."""
    if res.W.shape[0] != m:
        res.W = res.W[:m]
    if res.H.shape[1] != n:
        res.H = res.H[:, :n]
    from ..config import Dispersion
    per_col = cfg.dispersion == Dispersion.PER_COL
    for attr in ("theta", "dispersion"):
        v = getattr(res, attr, None)
        if v is not None and np.ndim(v) == 1:
            setattr(res, attr, v[:n] if per_col else v[:m])
    if getattr(res, "pi_row", None) is not None:
        res.pi_row = res.pi_row[:m]
    if getattr(res, "pi_col", None) is not None:
        res.pi_col = res.pi_col[:n]
    return res
