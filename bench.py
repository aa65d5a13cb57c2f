"""Benchmark driver — prints ONE JSON line with the headline metric.

Headline: the DIRECTLY PUBLISHED workload — NMF MSE k=20 on pbmc3k
(13,714 x 2,638), 20 iterations.  The reference publishes 2.18 s on a
56-thread Xeon Gold 6238R and 0.21 s on an H100 NVL
(vignettes/gpu-acceleration.Rmd:105-133), so ``vs_baseline`` here is
measurement-vs-publication, not an extrapolation.

``extra`` carries the round-1 headline (movielens k=50 ALS iters/s,
single chip, device-resident) and the H100 ratio for continuity.

Both metrics measure steady-state device throughput: data resident in
device memory (as in any production loop); the timed call covers the full
jitted ALS while-loop plus host-side result marshalling.
"""

import json
import time

import numpy as np

PUBLISHED_PBMC_K20_CPU_S = 2.18    # 56-thread Xeon Gold 6238R (vignette)
PUBLISHED_PBMC_K20_H100_S = 0.21   # H100 NVL 96GB (vignette)

# Published per-device peaks for roofline accounting (achieved / peak),
# keyed by jax device_kind; values = (HBM GB/s, dense bf16 TFLOP/s).
# Source: NVIDIA H100 Tensor Core GPU data sheet, SXM5 part, at its full
# 700 W power limit.  A device missing here is an error, not a default.
_DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": (3350.0, 989.0),
}


def device_peaks(kind: str):
    if kind not in _DEVICE_PEAKS:
        raise KeyError(f"no published peaks for device_kind {kind!r}; "
                       "add them to bench._DEVICE_PEAKS with their source")
    return _DEVICE_PEAKS[kind]


def _roofline(m, n, k, iters, seconds, data_bytes, hbm_peak):
    """Model-based achieved GFLOP/s + HBM GB/s for one fused ALS MSE loop.

    Per iteration: two rank-k passes over A (B = WᵀA and AHᵀ, 2·m·n·k FLOPs
    each), two k×k Grams, 2(m+n) k² solve work — FLOPs ≈ 4mnk + 4(m+n)k².
    HBM traffic is dominated by the two A reads per iteration plus factor
    reads/writes.
    """
    it_s = seconds / iters
    flops = 4.0 * m * n * k + 4.0 * (m + n) * k * k
    bytes_ = 2.0 * m * n * data_bytes + 3.0 * (m + n) * k * 4.0
    out = {"us_per_iter": round(it_s * 1e6, 1),
           "achieved_gflops": round(flops / it_s / 1e9, 1),
           "achieved_hbm_gbps": round(bytes_ / it_s / 1e9, 1)}
    if hbm_peak:
        out["hbm_peak_frac"] = round(bytes_ / it_s / 1e9 / hbm_peak, 3)
    return out


def _time_best_of(fn, reps=3):
    # best-of-N: the least-disturbed of N identical calls
    best = float("inf")
    out = None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return best, out


def main():
    import jax.numpy as jnp

    import rcppml_tpu as rt
    from rcppml_tpu import datasets
    from rcppml_tpu.models.nmf import nmf_fit

    # --- headline: pbmc3k k=20, 20 iters (published workload) ---
    pb = np.asarray(datasets.pbmc3k().todense(), dtype=np.float32)
    pb_dev = jnp.asarray(pb)
    cfg_pb = rt.build_config(20, seed=1, maxit=20, tol=0.0, sort_model=False)
    nmf_fit(pb, cfg_pb, device_A=pb_dev)               # compile + warm
    pb_s, _ = _time_best_of(lambda: nmf_fit(pb, cfg_pb, device_A=pb_dev))

    # --- device-loop slope metric: marginal cost per iteration x 20 ---
    # The slope between two maxit values cancels every fixed per-call
    # term (dispatch, result transfer): d(time)/d(iter) x 20 = the fused
    # ALS loop's 20-iteration device time; best-of-5 each side
    cfg_pb_hi = cfg_pb.replace(max_iter=420)
    nmf_fit(pb, cfg_pb_hi, device_A=pb_dev)            # compile + warm
    pb_lo5, _ = _time_best_of(lambda: nmf_fit(pb, cfg_pb,
                                              device_A=pb_dev), reps=5)
    pb_hi_s, _ = _time_best_of(lambda: nmf_fit(pb, cfg_pb_hi,
                                               device_A=pb_dev), reps=5)
    pb_loop_s = max(pb_hi_s - pb_lo5, 0.0) / (420 - 20) * 20

    # same slope for the bf16_data loop
    cfg_pb16 = cfg_pb.replace(bf16_data=True)
    cfg_pb16_hi = cfg_pb16.replace(max_iter=1020)
    nmf_fit(pb, cfg_pb16, device_A=pb_dev)
    nmf_fit(pb, cfg_pb16_hi, device_A=pb_dev)
    pb16_s, _ = _time_best_of(lambda: nmf_fit(pb, cfg_pb16,
                                              device_A=pb_dev), reps=5)
    pb16_hi_s, _ = _time_best_of(lambda: nmf_fit(pb, cfg_pb16_hi,
                                                 device_A=pb_dev), reps=5)
    pb16_loop_s = max(pb16_hi_s - pb16_s, 0.0) / (1020 - 20) * 20

    # fused_vmem (Newton-Schulz ALS) on the headline workload, bf16 A
    cfg_pbfv = cfg_pb16.replace(fused_vmem=True)
    cfg_pbfv_hi = cfg_pbfv.replace(max_iter=1020)
    nmf_fit(pb, cfg_pbfv, device_A=pb_dev)
    nmf_fit(pb, cfg_pbfv_hi, device_A=pb_dev)
    pbfv_s, _ = _time_best_of(lambda: nmf_fit(pb, cfg_pbfv,
                                              device_A=pb_dev), reps=5)
    pbfv_hi_s, _ = _time_best_of(lambda: nmf_fit(pb, cfg_pbfv_hi,
                                                 device_A=pb_dev), reps=5)
    pbfv_loop_s = max(pbfv_hi_s - pbfv_s, 0.0) / (1020 - 20) * 20

    # --- continuity metric: movielens k=50 ALS iters/s ---
    ml = np.asarray(datasets.movielens().todense(), dtype=np.float32)
    ml_dev = jnp.asarray(ml)
    cfg_ml = rt.build_config(50, seed=1, maxit=300, tol=0.0, sort_model=False)
    nmf_fit(ml, cfg_ml, device_A=ml_dev)
    ml_s, res = _time_best_of(lambda: nmf_fit(ml, cfg_ml, device_A=ml_dev))

    # --- bf16_data fast path on the same movielens workload ---
    cfg16 = cfg_ml.replace(bf16_data=True)
    nmf_fit(ml, cfg16, device_A=ml_dev)
    ml16_s, res16 = _time_best_of(lambda: nmf_fit(ml, cfg16,
                                                  device_A=ml_dev))

    # --- movielens slope-isolated device loop: maxit=20 vs 1020 ---
    cfg_ml_lo = cfg_ml.replace(max_iter=20)
    cfg_ml_hi = cfg_ml.replace(max_iter=1020)
    nmf_fit(ml, cfg_ml_lo, device_A=ml_dev)
    nmf_fit(ml, cfg_ml_hi, device_A=ml_dev)
    ml_lo5, _ = _time_best_of(lambda: nmf_fit(ml, cfg_ml_lo,
                                              device_A=ml_dev), reps=5)
    ml_hi5, _ = _time_best_of(lambda: nmf_fit(ml, cfg_ml_hi,
                                              device_A=ml_dev), reps=5)
    ml_loop_us = max(ml_hi5 - ml_lo5, 0.0) / (1020 - 20) * 1e6
    cfg16_lo = cfg16.replace(max_iter=20)
    cfg16_hi = cfg16.replace(max_iter=1020)
    nmf_fit(ml, cfg16_lo, device_A=ml_dev)
    nmf_fit(ml, cfg16_hi, device_A=ml_dev)
    ml16_lo5, _ = _time_best_of(lambda: nmf_fit(ml, cfg16_lo,
                                                device_A=ml_dev), reps=5)
    ml16_hi5, _ = _time_best_of(lambda: nmf_fit(ml, cfg16_hi,
                                                device_A=ml_dev), reps=5)
    ml16_loop_us = max(ml16_hi5 - ml16_lo5, 0.0) / (1020 - 20) * 1e6

    # --- KL IRLS loop — slope-measured at the reference-parity im=5
    # default, published H100 row = 1.98 s / 20 it
    def _kl_fit(maxit):
        r = rt.nmf(pb_dev, 16, loss="kl", maxit=maxit, tol=0.0, seed=1,
                   sort_model=False)
        return float(np.asarray(r.W)[0, 0])
    _kl_fit(2); _kl_fit(42)
    kl_lo, _ = _time_best_of(lambda: _kl_fit(2), reps=5)
    kl_hi, _ = _time_best_of(lambda: _kl_fit(42), reps=5)
    kl_ms_per_iter = max(kl_hi - kl_lo, 0.0) / 40 * 1e3
    kl_e2e, _ = _time_best_of(lambda: _kl_fit(20), reps=3)

    # --- fused_vmem (Newton-Schulz ALS) on the same workload — slope
    # over the same spans
    fv_us = {}
    for label, extra in (("fp32", {}), ("bf16", {"bf16_data": True})):
        cfg_lo = rt.build_config(50, seed=1, maxit=20, tol=0.0,
                                 sort_model=False, fused_vmem=True, **extra)
        cfg_hi = cfg_lo.replace(max_iter=1020)
        nmf_fit(ml, cfg_lo, device_A=ml_dev)
        nmf_fit(ml, cfg_hi, device_A=ml_dev)
        lo5, _ = _time_best_of(lambda: nmf_fit(ml, cfg_lo,
                                               device_A=ml_dev), reps=5)
        hi5, _ = _time_best_of(lambda: nmf_fit(ml, cfg_hi,
                                               device_A=ml_dev), reps=5)
        fv_us[label] = max(hi5 - lo5, 0.0) / (1020 - 20) * 1e6

    import jax
    kind = jax.devices()[0].device_kind
    hbm_peak, bf16_peak = device_peaks(kind)
    roof = {
        "device": kind,
        "peaks_assumed": {"hbm_gbps": hbm_peak, "bf16_tflops": bf16_peak},
        "pbmc3k_k20_fp32": _roofline(*pb.shape, 20, 20, pb_s, 4, hbm_peak),
        # slope can clamp to 0.0 under noise — skip rather than divide
        # by zero
        "pbmc3k_k20_fp32_device_loop": _roofline(*pb.shape, 20, 20,
                                                 pb_loop_s, 4, hbm_peak)
        if pb_loop_s else None,
        "movielens_k50_fp32": _roofline(*ml.shape, 50, res.iterations,
                                        ml_s, 4, hbm_peak),
        "movielens_k50_bf16": _roofline(*ml.shape, 50, res16.iterations,
                                        ml16_s, 2, hbm_peak),
        "movielens_k50_fp32_device_loop": _roofline(
            *ml.shape, 50, 1, ml_loop_us / 1e6, 4, hbm_peak)
        if ml_loop_us else None,
        "movielens_k50_bf16_device_loop": _roofline(
            *ml.shape, 50, 1, ml16_loop_us / 1e6, 2, hbm_peak)
        if ml16_loop_us else None,
    }

    print(json.dumps({
        "metric": "pbmc3k_k20_nmf_20iter_seconds",
        "value": round(pb_s, 4),
        "unit": "s",
        "vs_baseline": round(PUBLISHED_PBMC_K20_CPU_S / pb_s, 2),
        "extra": {
            "vs_h100": round(PUBLISHED_PBMC_K20_H100_S / pb_s, 2),
            # slope-isolated device loop (fixed per-call cost cancelled)
            "pbmc3k_k20_device_loop_seconds": round(pb_loop_s, 4),
            "pbmc3k_device_loop_vs_h100": round(
                PUBLISHED_PBMC_K20_H100_S / pb_loop_s, 2) if pb_loop_s
            else None,
            "pbmc3k_k20_bf16_device_loop_seconds": round(pb16_loop_s, 4),
            "pbmc3k_k20_fused_vmem_bf16_device_loop_seconds": round(
                pbfv_loop_s, 4),
            "pbmc3k_fused_vmem_device_loop_vs_h100": round(
                PUBLISHED_PBMC_K20_H100_S / pbfv_loop_s, 2) if pbfv_loop_s
            else None,
            "movielens_k50_als_iters_per_sec": round(res.iterations / ml_s, 1),
            "movielens_k50_bf16_iters_per_sec": round(
                res16.iterations / ml16_s, 1),
            "movielens_k50_device_us_per_iter": round(ml_loop_us, 1),
            "movielens_k50_bf16_device_us_per_iter": round(ml16_loop_us, 1),
            "movielens_k50_fused_vmem_us_per_iter": round(fv_us["fp32"], 1),
            "movielens_k50_fused_vmem_bf16_us_per_iter": round(
                fv_us["bf16"], 1),
            "pbmc3k_k16_kl_irls_ms_per_iter_im5": round(kl_ms_per_iter, 2),
            "pbmc3k_k16_kl_20iter_seconds": round(kl_e2e, 3),
            "pbmc3k_kl_vs_h100": round(1.98 / kl_e2e, 2) if kl_e2e else None,
            "roofline": roof,
        },
    }))


if __name__ == "__main__":
    main()
