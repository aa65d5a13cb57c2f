"""Full benchmark suite — mirrors the reference's 10-op CPU-vs-GPU driver
(tools/gpu_bench_cpu56.R:1-50, vignettes/gpu-acceleration.Rmd).

Runs the reference-table workloads on the current backend and prints one
JSON object per line.
Data is pushed to the device once; timings are steady-state (post-compile),
matching how the reference reports its vignette numbers (tol=0, fixed
iteration counts).

Usage: python tools/bench_suite.py [--quick]
"""

import argparse
import json
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def timed(fn, *args, **kw):
    """Warm once, then best-of-3 — robust to transient link noise."""
    import jax

    def block(o):
        jax.block_until_ready(getattr(o, "W", o if not hasattr(o, "d")
                                      else o.d))
    out = fn(*args, **kw)
    block(out)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        block(out)
        best = min(best, time.perf_counter() - t0)
    return out, best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()

    import jax.numpy as jnp

    import rcppml_tpu as rt
    from rcppml_tpu import datasets
    from rcppml_tpu.models.nmf import nmf_fit
    from rcppml_tpu.models.nmf_cv import fit_cv_or_masked
    from rcppml_tpu.models.svd import lanczos_svd, randomized_svd, irlba_svd
    from rcppml_tpu.config import SVDConfig

    results = []

    def rec(name, seconds, ref_cpu=None, ref_gpu=None, **extra):
        row = {"op": name, "seconds": round(seconds, 3)}
        if ref_cpu:
            row["ref_cpu_s"] = ref_cpu
            row["speedup_vs_ref_cpu"] = round(ref_cpu / seconds, 2)
        if ref_gpu:
            row["ref_gpu_s"] = ref_gpu
        row.update(extra)
        results.append(row)
        print(json.dumps(row), flush=True)

    pb = datasets.pbmc3k()
    A = jnp.asarray(np.asarray(pb.todense(), np.float32))
    ml = jnp.asarray(np.asarray(datasets.movielens().todense(), np.float32))
    iters = 5 if args.quick else 20

    # 1. MSE NMF k=20 pbmc3k (ref: CPU 2.18 GPU 0.21 @20 iters)
    cfg = rt.build_config(20, seed=1, maxit=iters, tol=0.0, sort_model=False)
    _, el = timed(nmf_fit, A, cfg, device_A=A)
    rec("nmf_mse_k20_pbmc3k", el, ref_cpu=2.18, ref_gpu=0.21, iters=iters)

    # 2. movielens k=50 ALS throughput
    cfg = rt.build_config(50, seed=1, maxit=100 if not args.quick else 10,
                          tol=0.0, sort_model=False)
    r, el = timed(nmf_fit, ml, cfg, device_A=ml)
    rec("nmf_mse_k50_movielens", el, iters=r.iterations,
        iters_per_sec=round(r.iterations / el, 1))

    # 2b. same workload on the fused_vmem whole-fit kernel (opt-in)
    cfg = cfg.replace(fused_vmem=True)
    r, el = timed(nmf_fit, ml, cfg, device_A=ml)
    rec("nmf_mse_k50_movielens_fused_vmem", el, iters=r.iterations,
        iters_per_sec=round(r.iterations / el, 1))

    # 3. KL (GP dispersion none) k=16 pbmc3k (ref: CPU 23.37 GPU 1.98)
    cfg = rt.build_config(16, loss="gp", dispersion="none", seed=1,
                          maxit=iters, tol=0.0, sort_model=False, solver="cd")
    _, el = timed(nmf_fit, A, cfg, device_A=A)
    rec("nmf_kl_k16_pbmc3k", el, ref_cpu=23.37, ref_gpu=1.98, iters=iters)

    # 4. CV k=16 pbmc3k (ref on 8000x500 subset: CPU 4.04 GPU 0.20)
    cfg = rt.build_config(16, seed=1, maxit=iters, tol=0.0,
                          test_fraction=0.1, cv_seed=1, sort_model=False)
    A_np = np.asarray(A)
    _, el = timed(fit_cv_or_masked, A, cfg)   # device-resident like all rows
    rec("nmf_cv_k16_pbmc3k", el, iters=iters)

    # 5. NB-IRLS zi=row k=20 pbmc3k (BASELINE config #3)
    cfg = rt.build_config(20, loss="nb", zi="row", seed=1,
                          maxit=max(3, iters // 4), tol=0.0,
                          sort_model=False, solver="cd")
    _, el = timed(nmf_fit, A, cfg, device_A=A)
    rec("nmf_nb_zirow_k20_pbmc3k", el, iters=max(3, iters // 4))

    # 6-8. SVD (ref 40K-cell numbers: lanczos 4.78/0.44, rand 17.77/0.41,
    # irlba 5.30/0.38 — our matrix is ~5.5x smaller)
    _, el = timed(lanczos_svd, A, SVDConfig(k=10, seed=1))
    rec("svd_lanczos_k10_pbmc3k", el, ref_cpu=4.78, ref_gpu=0.44)
    _, el = timed(randomized_svd, A, SVDConfig(k=10, seed=1))
    rec("svd_randomized_k10_pbmc3k", el, ref_cpu=17.77, ref_gpu=0.41)
    _, el = timed(irlba_svd, A, SVDConfig(k=10, seed=1))
    rec("svd_irlba_k10_pbmc3k", el, ref_cpu=5.30, ref_gpu=0.38)

    # 9. masked NMF k=20 (ref 10K cells: CPU 10.50 GPU 0.75)
    rs = np.random.RandomState(0)
    import jax.numpy as jnp
    M = jnp.asarray(rs.rand(*A_np.shape) < 0.1)   # device-resident mask
    cfg = rt.build_config(20, seed=1, maxit=iters, tol=0.0, sort_model=False)
    _, el = timed(fit_cv_or_masked, A, cfg, mask=M)
    rec("nmf_masked_k20_pbmc3k", el, ref_cpu=10.50, ref_gpu=0.75,
        iters=iters)

    # 10. rank-2 bipartition (clustering kernel, device-resident fast path)
    from rcppml_tpu.models.clustering import bipartition
    _, el = timed(bipartition, A, seed=1)
    rec("bipartition_pbmc3k", el)

    # 10b. 2-layer factor graph, fused on-device outer ALS (20 sweeps)
    from rcppml_tpu.models.graph import factor_input, factor_net
    from rcppml_tpu.models.graph import fit as graph_fit
    from rcppml_tpu.models.graph import nmf_layer
    x = factor_input(A_np, "x")
    l2 = nmf_layer(nmf_layer(x, 20, name="L1"), 8, name="L2")
    gnet = factor_net(x, l2, maxit=20, tol=0.0, seed=42)
    _, el = timed(graph_fit, gnet)
    rec("graph_2layer_k20_k8_pbmc3k", el, sweeps=20)

    # 11-12. reference headline scale: hcabm40k-shape synthetic (the atlas
    # itself isn't shipped; same shape + ~16.5% uniform density), data
    # generated ON DEVICE to keep the host transfer out of the measurement
    if not args.quick:
        import jax

        def _make(m, n, seed=0, density=0.165):
            key = jax.random.PRNGKey(seed)
            k1, k2 = jax.random.split(key)
            u = jax.random.uniform(k1, (m, n))
            vals = jnp.round(jax.random.gamma(k2, 2.0, (m, n)) * 3)
            return jnp.where(u < density, vals, 0.0).astype(jnp.float32)

        gen = jax.jit(_make, static_argnums=(0, 1))
        Ah = jax.block_until_ready(gen(5000, 40000))
        cfg = rt.build_config(20, seed=42, maxit=20, tol=0.0,
                              sort_model=False)
        _, el = timed(nmf_fit, Ah, cfg, device_A=Ah)
        rec("nmf_mse_k20_hca40k_shape", el, ref_cpu=38.45, ref_gpu=2.78,
            iters=20)
        Ah = jax.block_until_ready(gen(5000, 10000))
        cfg = rt.build_config(64, seed=42, maxit=20, tol=0.0,
                              sort_model=False)
        _, el = timed(nmf_fit, Ah, cfg, device_A=Ah)
        rec("nmf_mse_k64_hca10k_shape", el, ref_cpu=29.23, ref_gpu=0.88,
            iters=20)
        # 13. CV NMF k=64 at the same 10K-cell shape (the largest CV row
        # in the published table — gpu-acceleration.Rmd:105-133)
        cfg = rt.build_config(64, seed=42, maxit=20, tol=0.0,
                              test_fraction=0.1, cv_seed=1,
                              sort_model=False, cv_patience=10**6)
        _, el = timed(fit_cv_or_masked, Ah, cfg)
        rec("nmf_cv_k64_hca10k_shape", el, ref_cpu=75.31, ref_gpu=2.39,
            iters=20)

    print(json.dumps({"summary": results}), flush=True)


if __name__ == "__main__":
    main()
