#!/usr/bin/env python3
"""Bring-up check: the NMF/SVD main path on an NVIDIA GPU.

Drives the package's user entry points -- ``rt.nmf`` (MSE, L1, KL IRLS, CV,
fused_vmem), ``rt.svd`` and the streamed ``rt.nmf(path, k)`` -- at the
reference's published shapes on one GPU, compares each with a plain
reference, and prints one JSON object per phase.  When every phase passed,
the last line is ``{"ok": true, "device": {...}}``.

    python chip_smoke.py [--seed N]           # phases 0-9, one GPU
    python chip_smoke.py --four [--seed N]    # sharded fits on a 2x2 mesh
                                              # of four GPUs, nothing else

Every matrix is generated from ``--seed``.  References run in this same
process: CPU fits under ``jax.default_device(<cpu>)`` at ``highest`` matmul
precision, and scipy on the host.  Wall times include compilation and are
bring-up timings, not benchmarks.  Exits non-zero, without the final line,
when JAX finds no GPU, when the package is missing, or when a phase fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


# ---------------------------------------------------------------------------
# phase bookkeeping
# ---------------------------------------------------------------------------

class Checks:
    """Named comparisons of an error against its tolerance."""

    def __init__(self):
        self.items = {}
        self.info = {}

    def close(self, name, err, tol):
        err = float(err)
        self.items[name] = {"err": err, "tol": tol,
                            "ok": bool(np.isfinite(err) and err <= tol)}

    def true(self, name, cond):
        self.items[name] = {"ok": bool(cond)}

    def record(self):
        out = {"ok": all(c["ok"] for c in self.items.values()),
               "checks": self.items}
        ratios = [(c["err"] / c["tol"] if c["tol"] else np.inf, n)
                  for n, c in self.items.items() if "err" in c]
        if ratios:
            _, worst = max(ratios)
            out["worst"] = {"check": worst, **self.items[worst]}
        out.update(self.info)
        return out


def run_phase(name, fn, results):
    import jax
    dev = jax.devices()[0]
    t0 = time.perf_counter()
    try:
        rec = {"phase": name, **fn()}
    except Exception as e:                       # recorded, exit code set
        traceback.print_exc()
        rec = {"phase": name, "ok": False, "error": repr(e)[:600]}
    rec["bringup_wall_s"] = time.perf_counter() - t0
    rec["peak_bytes_in_use"] = (dev.memory_stats() or {}).get(
        "peak_bytes_in_use")
    print(json.dumps(rec, default=float), flush=True)
    results.append(rec)


def rel(a, b):
    """max |a - b| / max |b| — a normwise relative error (an elementwise
    rtol would be dominated by entries that are zero in one fit)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def recon(r):
    return (np.asarray(r.W, np.float64) * np.asarray(r.d)[None, :]) @ \
        np.asarray(r.H, np.float64)


def same_fit(a, b):
    return all(np.array_equal(np.asarray(getattr(a, f)),
                              np.asarray(getattr(b, f)))
               for f in ("W", "H", "d", "loss_history"))


def timed(fn):
    import jax
    t0 = time.perf_counter()
    out = fn()
    jax.block_until_ready(getattr(out, "W", out))
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# data, generated from the seed
# ---------------------------------------------------------------------------

def planted_counts(key, m, n, k, density):
    """Poisson counts from a planted nonnegative rank-k model with skewed
    (gamma) row and column factors, scaled so that about ``density`` of the
    entries are nonzero.  Built on the default device."""
    import jax
    import jax.numpy as jnp
    kw, kh, kp = jax.random.split(key, 3)
    W = jax.random.gamma(kw, 0.5, (m, k))
    H = jax.random.gamma(kh, 0.5, (k, n))
    R = jnp.dot(W, H, precision="highest")
    sub = np.asarray(R[:min(m, 500), :min(n, 4000)], np.float64)
    lo, hi = 1e-4, 1e4                     # bisect the rate scale
    for _ in range(40):
        s = (lo * hi) ** 0.5
        if np.mean(-np.expm1(-s * sub)) < density:
            lo = s
        else:
            hi = s
    return jax.random.poisson(kp, s * R).astype(jnp.float32)


def planted_spectrum(key, m, n, k):
    """A rank-k signal with singular values 100, 95, ..., plus small noise:
    a clear gap after the k-th value, so a top-k comparison tests the SVD
    drivers rather than how fast they resolve a flat tail."""
    import jax
    import jax.numpy as jnp
    ku, kv, kn = jax.random.split(key, 3)
    U, _ = jnp.linalg.qr(jax.random.normal(ku, (m, k)))
    V, _ = jnp.linalg.qr(jax.random.normal(kv, (n, k)))
    s = 100.0 - 5.0 * jnp.arange(k)
    A = jnp.dot(U * s[None, :], V.T, precision="highest")
    return A + 1e-3 * jax.random.normal(kn, (m, n))


def cpu_ref():
    """Context: computations on the host CPU at full fp32 matmul
    precision -- the plain reference every GPU fit is compared with."""
    import contextlib
    import jax
    stack = contextlib.ExitStack()
    stack.enter_context(jax.default_device(jax.devices("cpu")[0]))
    stack.enter_context(jax.default_matmul_precision("highest"))
    return stack


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_mse(A, A_host):
    import rcppml_tpu as rt
    c = Checks()
    r1, t1 = timed(lambda: rt.nmf(A, 20, maxit=20, tol=0, seed=1))
    r2, t2 = timed(lambda: rt.nmf(A, 20, maxit=20, tol=0, seed=1))
    lh = np.asarray(r1.loss_history, np.float64)
    trata = float(np.sum(np.square(A_host, dtype=np.float64)))
    c.true("losses_finite", np.isfinite(lh).all() and lh.size == 20)
    # Gram-trick fp32 loss: cancellation floor ~ tr(A'A) * eps32, so a
    # rise below 8 eps32 tr(A'A) is rounding, not divergence
    c.close("loss_rise_over_trAtA", max(np.diff(lh).max(), 0.0) / trata,
            8 * 2.0 ** -23)
    c.info["same_seed_bitwise_equal"] = same_fit(r1, r2)
    c.info["fit_s_first_second"] = [t1, t2]
    g = rt.nmf(A, 20, maxit=3, tol=0, seed=1, sort_model=False)
    with cpu_ref():
        h = rt.nmf(A_host, 20, maxit=3, tol=0, seed=1, sort_model=False)
    # fp32 sums in another order on the GPU; the Cholesky solves amplify
    # that rounding by the Gram conditioning -- 1e-4 bounds it
    c.close("W_vs_cpu_3it", rel(g.W, h.W), 1e-4)
    c.close("H_vs_cpu_3it", rel(g.H, h.H), 1e-4)
    return c.record()


def phase_l1(A, A_host):
    import jax.numpy as jnp
    import rcppml_tpu as rt
    from rcppml_tpu.ops import pallas_kernels as pk, solvers
    c = Checks()
    r, t = timed(lambda: rt.nmf(A, 20, L1=(0, 0.01), maxit=20, tol=0,
                                seed=1))
    c.true("losses_finite", np.isfinite(np.asarray(r.loss_history)).all())
    c.info["fit_s"] = t
    g = rt.nmf(A, 20, L1=(0, 0.01), maxit=3, tol=0, seed=1,
               sort_model=False)
    with cpu_ref():
        h = rt.nmf(A_host, 20, L1=(0, 0.01), maxit=3, tol=0, seed=1,
                   sort_model=False)
    # CD stops each column when its mean relative sweep change drops
    # below 5e-6; a column frozen one sweep apart on the two backends
    # differs by that much, amplified through 3 ALS iterations: 1e-3
    c.close("W_vs_cpu_3it", rel(g.W, h.W), 1e-3)
    c.close("H_vs_cpu_3it", rel(g.H, h.H), 1e-3)
    # kernel level: the Triton kernel against the lax sweep, both on
    # the GPU, on this fit's own H-side system (k=20, n=40,000)
    W_T = jnp.asarray(np.asarray(g.W).T * np.asarray(g.d)[:, None])
    G = jnp.dot(W_T, W_T.T, precision="highest")
    B = jnp.dot(W_T, A, precision="highest")
    X0 = jnp.zeros(B.shape, jnp.float32)
    L1, tol = jnp.float32(0.01), jnp.float32(5e-6)
    kern = np.asarray(pk.cd_nnls_shared(G, B, X0, L1, tol, nonneg=True,
                                        maxit=100))
    lax_ = np.asarray(solvers._cd_sweeps(G, B, X0, L1, tol, nonneg=True,
                                         maxit=100, l1_static=True))
    scale = np.abs(lax_).max(axis=0) + 1e-6
    c.close("kernel_vs_lax_colwise", float(
        (np.abs(kern - lax_).max(axis=0) / scale).max()), 1e-3)
    c.info["kernel_vs_lax_bitwise"] = bool(np.array_equal(kern, lax_))
    # a seed list vmaps the whole fit, kernel included
    multi = rt.nmf(A[:, :4000], 20, L1=(0, 0.01), maxit=3, tol=0,
                   seed=[1, 2])
    c.true("seed_list_fit_finite", np.isfinite(np.asarray(multi.W)).all())
    return c.record()


def phase_kl(A3, A3_host):
    import jax.numpy as jnp
    import rcppml_tpu as rt
    from rcppml_tpu.ops import linalg, pallas_kernels as pk, solvers
    c = Checks()
    kw = dict(loss="gp", dispersion="none", maxit=5, tol=0, seed=1,
              sort_model=False)
    g, t = timed(lambda: rt.nmf(A3, 16, **kw))
    g2 = rt.nmf(A3, 16, **kw)
    with cpu_ref():
        h = rt.nmf(A3_host, 16, **kw)
    c.true("losses_finite", np.isfinite(np.asarray(g.loss_history)).all())
    c.true("same_seed_bitwise_equal", same_fit(g, g2))
    c.info["fit_s"] = t
    # 5 KL iterations do not pin the factors down to rounding: another
    # summation order moves single reconstruction entries by up to the
    # largest entry (fp32 throughout, 4 CPU devices vs 1, 2,000 x 600:
    # 1.2), while the loss moves 6.6e-4.  The loss is what the fit
    # determines.  H100 (700 W) readings against the fp32 CPU fit: 1.1e-3,
    # 1.0e-4, 6.7e-4 -- limit 3e-3
    c.close("loss_vs_cpu_5it",
            abs(g.loss_history[-1] - h.loss_history[-1])
            / abs(h.loss_history[-1]), 3e-3)
    Rg, Rh = recon(g), recon(h)
    c.info["recon_fro_rel_vs_cpu"] = float(np.linalg.norm(Rg - Rh)
                                           / np.linalg.norm(Rh))
    c.info["recon_max_rel_vs_cpu"] = rel(Rg, Rh)
    # the accelerator's per-column weighted Gram and RHS (bf16 Khatri-Rao
    # operand and fields, fp32 accumulation) at this fit's own factor,
    # k=16, m=13,714, Poisson weights 1/mu, against fp64 on the host.
    # Every term is nonnegative, so each entry is within two bf16
    # roundings (2^-8) plus the fp32 sum (m 2^-24) of its own value; one
    # dominant row puts a column near that bound, a wrong weight pass far
    # past it
    F = jnp.asarray(np.asarray(g.W).T * np.asarray(g.d)[:, None])
    X = g.H[:, :512]
    mu = jnp.maximum(jnp.dot(F.T, X, precision="highest"), 1e-3)
    w = 1.0 / mu
    A_blk = A3[:, :512]
    Gd, b = linalg.weighted_gram_and_rhs(F, w, A_blk,
                                         KR=linalg.kr_product(F))
    Fn, wn, An = (np.asarray(v, np.float64) for v in (F, w, A_blk))
    Gr = np.einsum("km,mj,lm->jkl", Fn, wn, Fn)
    br = Fn @ (wn * An)
    G = np.asarray(Gd, np.float64)
    bound = 2.0 ** -8 + F.shape[1] * 2.0 ** -24
    c.close("weighted_gram_vs_fp64_colwise", float(
        (np.abs(G - Gr).max(axis=(1, 2))
         / np.abs(Gr).max(axis=(1, 2))).max()), bound)
    c.close("weighted_rhs_vs_fp64_colwise", float(
        (np.abs(np.asarray(b) - br).max(axis=0)
         / np.abs(br).max(axis=0)).max()), bound)
    # the batched Triton CD kernel against the lax sweep, both on the GPU,
    # on these 512 weighted systems (k=16): the same arithmetic in the
    # same order
    X0 = jnp.zeros(b.shape, jnp.float32)
    L1, tol = jnp.float32(0.0), jnp.float32(5e-6)
    kern = np.asarray(pk.cd_nnls_batched(Gd, b, X0, L1, tol, nonneg=True,
                                         maxit=100))
    lax_ = np.asarray(solvers._cd_sweeps_batched(Gd, b, X0, L1, tol,
                                                 nonneg=True, maxit=100))
    scale = np.abs(lax_).max(axis=0) + 1e-6
    c.close("batched_kernel_vs_lax_colwise", float(
        (np.abs(kern - lax_).max(axis=0) / scale).max()), 1e-3)
    c.info["batched_kernel_vs_lax_bitwise"] = bool(np.array_equal(kern,
                                                                  lax_))
    return c.record()


def phase_cv(A4, A4_host):
    import rcppml_tpu as rt
    c = Checks()
    kw = dict(test_fraction=0.1, cv_seed=1, tol=0, seed=1, sort_model=False)
    r, t = timed(lambda: rt.nmf(A4, 64, maxit=10, **kw))
    c.true("train_test_finite", np.isfinite(r.train_loss)
           and np.isfinite(r.test_loss))
    c.info["fit_s"] = t
    c.info["test_loss"] = float(r.test_loss)
    g = rt.nmf(A4, 64, maxit=3, **kw)
    with cpu_ref():
        h = rt.nmf(A4_host, 64, maxit=3, **kw)
    # masked fp32 batched Cholesky per column; columns with few train
    # entries are ill-conditioned (held up by the trace ridge): 1e-3
    c.close("recon_vs_cpu_3it", rel(recon(g), recon(h)), 1e-3)
    c.close("test_loss_vs_cpu_3it",
            abs(g.test_loss - h.test_loss) / abs(h.test_loss), 1e-3)
    return c.record()


def phase_svd(A5):
    import scipy.sparse.linalg as spl
    import rcppml_tpu as rt
    c = Checks()
    ref = np.sort(spl.svds(np.asarray(A5, np.float64), k=10, rng=0,
                           return_singular_vectors=False))[::-1]
    for method in ("randomized", "lanczos", "irlba"):
        r, t = timed(lambda: rt.svd(A5, 10, method=method, seed=1))
        d = np.sort(np.asarray(r.d, np.float64))[::-1][:10]
        c.info[f"{method}_s"] = t
        # top-10 singular values against ARPACK in fp64 on the host
        c.close(f"{method}_sv_rel", float(np.max(np.abs(d - ref) / ref)),
                1e-3)
    return c.record()


def phase_streaming(seed, m=13714, n=20000):
    import scipy.sparse as sp
    import rcppml_tpu as rt
    from rcppml_tpu.io.spz import st_write
    c = Checks()
    rng = np.random.default_rng(seed)
    A6 = sp.random(m, n, density=0.05, format="csc",
                   random_state=rng, dtype=np.float32,
                   data_rvs=lambda n: rng.integers(1, 30, n).astype(
                       np.float32))
    kw = dict(maxit=3, tol=0, seed=1, sort_model=False)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "a.spz")
        t0 = time.perf_counter()
        st_write(A6, path)
        c.info["st_write_s"] = time.perf_counter() - t0
        s, t = timed(lambda: rt.nmf(path, 10, **kw))
    m = rt.nmf(A6, 10, **kw)
    c.info["stream_fit_s"] = t
    c.info["nnz"] = int(A6.nnz)
    # same fp32 ALS over panels vs the whole matrix: sums regroup only
    c.close("W_stream_vs_memory", rel(s.W, m.W), 1e-4)
    c.close("H_stream_vs_memory", rel(s.H, m.H), 1e-4)
    return c.record()


def phase_rng():
    import jax
    from rcppml_tpu import rng
    c = Checks()
    for seed in (1, 42, 2 ** 40 + 3):
        h = rng.fill_uniform(seed, 16, 1337)
        d = np.asarray(jax.jit(
            lambda s=seed: rng.fill_uniform_traced(s, 16, 1337))())
        c.true(f"fill_uniform_bitwise_seed_{seed}", np.array_equal(h, d))
    return c.record()


def phase_fused_vmem(A8, A3):
    import rcppml_tpu as rt
    c = Checks()
    for label, A, k in (("movielens_3867x610_k50", A8, 50),
                        ("pbmc3k_13714x2638_k20", A3, 20)):
        kw = dict(maxit=200, tol=0, seed=1)
        rt.nmf(A, k, **kw)
        base, tb = timed(lambda: rt.nmf(A, k, **kw))
        rt.nmf(A, k, fused_vmem=True, **kw)
        fv, tf = timed(lambda: rt.nmf(A, k, fused_vmem=True, **kw))
        c.info[f"{label}_cholesky_s"] = tb
        c.info[f"{label}_fused_vmem_s"] = tf
        # Newton-Schulz ALS reaches the same fixed point to ~1e-3
        c.close(f"{label}_final_loss_rel",
                abs(fv.loss_history[-1] - base.loss_history[-1])
                / abs(base.loss_history[-1]), 1e-2)
    return c.record()


def phase_kernels(A, A3, A4):
    """Each fit whose NNLS is CD, with the Triton CD kernel and with the
    plain lax sweep (``_cd_sweeps``), second (warm) call of each."""
    import jax
    import rcppml_tpu as rt
    from rcppml_tpu.ops import solvers
    c = Checks()
    fits = {
        "kl_irls_k16_13714x2638": (A3, 16, dict(loss="gp",
                                                dispersion="none", maxit=5)),
        "cv_cd_k64_5000x10000": (A4, 64, dict(test_fraction=0.1, cv_seed=1,
                                              solver="cd", maxit=3)),
        "l1_k20_5000x40000": (A, 20, dict(L1=(0, 0.01), maxit=5)),
    }
    orig = solvers._cd_kernel_ok
    times = {}
    try:
        for use_kernel in (True, False):
            if not use_kernel:
                solvers._cd_kernel_ok = lambda k: False
                jax.clear_caches()
            for name, (X, k, kw) in fits.items():
                kw = dict(kw, tol=0, seed=1, sort_model=False)
                rt.nmf(X, k, **kw)
                r, t = timed(lambda: rt.nmf(X, k, **kw))
                times.setdefault(name, {})["kernel" if use_kernel
                                           else "lax"] = (t, r)
    finally:
        solvers._cd_kernel_ok = orig
        jax.clear_caches()
    for name, d in times.items():
        (tk, rk), (tl, rl) = d["kernel"], d["lax"]
        c.info[name] = {"kernel_s": tk, "lax_s": tl, "speedup": tl / tk}
        # the kernel runs the lax sweep's arithmetic in the same order
        # (bitwise equal on the card); 1e-3 leaves room for a CD column
        # that stops one sweep apart
        c.close(f"{name}_recon_kernel_vs_lax",
                rel(recon(rk), recon(rl)), 1e-3)
    return c.record()


def phase_gpu_tests():
    """The repository's gpu-marked tests, in this process."""
    import pytest
    os.environ["RCPPML_GPU_TESTS"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly", os.path.join(HERE, "tests")])
    c = Checks()
    c.true("pytest_gpu_marked_exit_0", int(rc) == 0)
    return c.record()


def phase_four(A, A3, A4):
    """Sharded fits on a 2x2 mesh of four GPUs against one-GPU fits."""
    import jax
    import rcppml_tpu as rt
    from rcppml_tpu.parallel.mesh import default_mesh
    c = Checks()
    mesh = default_mesh(jax.devices()[:4], shape=(2, 2))
    fits = {
        "mse_k20_5000x40000": (A, 20, {}),
        "cv_k20_5000x10000": (A4, 20, dict(test_fraction=0.1, cv_seed=1)),
        "nb_zi_k20_13714x2638": (A3, 20, dict(loss="nb", zi="row")),
    }
    for name, (X, k, kw) in fits.items():
        kw = dict(kw, maxit=3, tol=0, seed=1, sort_model=False)
        s, ts = timed(lambda: rt.nmf(X, k, mesh=mesh, **kw))
        o, to = timed(lambda: rt.nmf(X, k, **kw))
        c.info[f"{name}_s_mesh_one"] = [ts, to]
        err = rel(recon(s), recon(o))
        if "loss" not in kw:
            # the mesh regroups fp32 sums across the four shards: 1e-4
            c.close(f"{name}_recon_mesh_vs_one", err, 1e-4)
            continue
        # An IRLS fit feeds the regrouped sums back through its weights,
        # and 3 iterations amplify them far past rounding: with fp32
        # throughout, 4 CPU devices vs 1, NB zi="row" at 2,000 x 600 reads
        # 5.4e-3.  Four H100s read 4.35e-3 (700 W) and 5.86e-3 (400 W) on
        # the reconstruction, 5.3e-7 on the loss: limits 1e-2 and 1e-5
        c.close(f"{name}_recon_mesh_vs_one", err, 1e-2)
        c.close(f"{name}_loss_mesh_vs_one",
                abs(s.loss_history[-1] - o.loss_history[-1])
                / abs(o.loss_history[-1]), 1e-5)
    return c.record()


# ---------------------------------------------------------------------------

def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded fits on four GPUs")
    args = ap.parse_args()

    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"no GPU: JAX's default device is {devs[0]}", file=sys.stderr)
        sys.exit(1)
    need = 4 if args.four else 1
    if len(devs) < need:
        print(f"need {need} GPUs, found {len(devs)}", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, HERE)
    import rcppml_tpu  # noqa: F401  (fails here when the package is absent)
    # Every executable of this run is compiled, and autotuned, here: two
    # fits that share a GEMM then share its algorithm.  A cached executable
    # from another process may carry another autotuner choice, which the
    # IRLS fits amplify far past rounding (PERF.md, PR 1)
    jax.config.update("jax_enable_compilation_cache", False)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    import jaxlib
    print(json.dumps({"phase": "device", "ok": True,
                      "jax": jax.__version__, "jaxlib": jaxlib.__version__,
                      "devices": [str(d) for d in devs],
                      "nvidia_smi": smi.splitlines()}), flush=True)

    key = jax.random.PRNGKey(args.seed)
    k1, k3, k4, k5, k8 = jax.random.split(key, 5)
    t0 = time.perf_counter()
    # hcabm40k shape (5,000 x 40,000, ~33M nonzeros), pbmc3k shape
    # (13,714 x 2,638), the 10K-cell CV shape, the movielens shape
    A = planted_counts(k1, 5000, 40000, 20, 0.165)
    A3 = planted_counts(k3, 13714, 2638, 16, 0.07)
    A4 = planted_counts(k4, 5000, 10000, 20, 0.1)
    A8 = planted_counts(k8, 3867, 610, 20, 0.04)
    hosts = [np.asarray(X) for X in (A, A3, A4)]
    print(json.dumps({"phase": "data", "ok": True,
                      "seconds": time.perf_counter() - t0,
                      "nnz": {n: int(np.count_nonzero(h)) for n, h in
                              zip(("A", "A3", "A4"), hosts)}}), flush=True)
    A_host, A3_host, A4_host = hosts

    results = []
    if args.four:
        run_phase("four_gpu_mesh", lambda: phase_four(A, A3, A4), results)
    else:
        for name, fn in (
                ("mse_cholesky", lambda: phase_mse(A, A_host)),
                ("l1_mse_cd_shared", lambda: phase_l1(A, A_host)),
                ("kl_irls_cd_batched", lambda: phase_kl(A3, A3_host)),
                ("cv_k64", lambda: phase_cv(A4, A4_host)),
                ("svd", lambda: phase_svd(
                    planted_spectrum(k5, 5000, 40000, 10))),
                ("streaming", lambda: phase_streaming(args.seed)),
                ("rng", phase_rng),
                ("fused_vmem", lambda: phase_fused_vmem(A8, A3)),
                ("kernel_decisions", lambda: phase_kernels(A, A3, A4)),
                ("gpu_tests", phase_gpu_tests)):
            run_phase(name, fn, results)

    failed = [r["phase"] for r in results if not r["ok"]]
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        sys.exit(1)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
