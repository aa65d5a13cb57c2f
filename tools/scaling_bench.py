"""Multi-device scaling measurement.

On real multi-chip hardware this measures ALS throughput vs mesh size
(the BASELINE scaling-efficiency gate).  Without multiple real chips it
can still run on N virtual CPU devices (--cpu N) to exercise the sharded
program and the GSPMD collectives end-to-end; CPU numbers demonstrate the
machinery, not accelerator scaling.

Usage:
  python tools/scaling_bench.py             # real devices
  python tools/scaling_bench.py --cpu 8     # virtual CPU mesh
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", type=int, default=0,
                    help="force N virtual CPU devices")
    ap.add_argument("--m", type=int, default=4096)
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--k", type=int, default=50)
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args()

    if args.cpu:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                   f" --xla_force_host_platform_device_count={args.cpu}")
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax
    import numpy as np

    import rcppml_tpu as rt
    from rcppml_tpu.parallel.mesh import default_mesh, fit_sharded

    devices = jax.devices()
    rs = np.random.RandomState(0)
    A = rs.rand(args.m, args.n).astype(np.float32)
    cfg = rt.build_config(args.k, seed=1, maxit=args.iters, tol=0.0,
                          sort_model=False)

    results = []
    sizes = [s for s in (1, 2, 4, 8, 16, len(devices)) if s <= len(devices)]
    for nd in sorted(set(sizes)):
        mesh = default_mesh(devices[:nd])
        fit_sharded(A, cfg, mesh)                      # compile + warm
        t0 = time.perf_counter()
        res = fit_sharded(A, cfg, mesh)
        el = time.perf_counter() - t0
        ips = res.iterations / el
        row = {"devices": nd, "mesh": dict(zip(mesh.axis_names,
                                               map(int, mesh.devices.shape))),
               "iters_per_sec": round(ips, 2)}
        if results:
            base = results[0]
            row["speedup"] = round(ips / base["iters_per_sec"], 2)
            row["efficiency"] = round(ips / base["iters_per_sec"] / nd, 3)
        results.append(row)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
