"""Flagship streaming-scale proof (VERDICT r3 item 2).

The reference's headline streampress workload is a 38,606 x 278,676
scRNA matrix with 554M nonzeros — 43 GB dense fp32, 4.4 GB raw CSC,
5.36x spz compression (vignettes/streampress.Rmd:347-363).  This driver
synthesizes a matrix of that exact shape/sparsity, writes it through the
native .spz encoder (forward + transpose streams), runs the chunked NMF
engine end-to-end on the chip, and decomposes the wall time into
device-compute / host-decode / link-upload so the chip-busy fraction is
a measurement, not a guess.

Usage:
  python tools/flagship_streaming.py --gen           # ~6 GB in /tmp
  python tools/flagship_streaming.py --fit --sweeps 2
  python tools/flagship_streaming.py --gen --fit --out FLAGSHIP_r04.json

Scale knobs (--m/--n/--nnz) exist for smoke runs; the defaults are the
reference workload.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

DEFAULT_PATH = "/tmp/flagship.spz"


def synthesize(m: int, n: int, target_nnz: int, seed: int = 0):
    """scRNA-shaped sparse counts, fully vectorized.

    Gene popularity ~ lognormal (heavy head like real scRNA); per-cell
    depth ~ lognormal; values ~ shifted geometric (mostly 1-3, tail into
    uint16).  Construction: draw (col, row) coordinates i.i.d., lexsort,
    drop duplicates — the dedup loss is compensated by oversampling.
    """
    rs = np.random.RandomState(seed)
    t0 = time.time()
    pop = rs.lognormal(0.0, 1.6, m)
    cdf = np.cumsum(pop / pop.sum())
    depth = rs.lognormal(0.0, 0.35, n)
    depth = depth / depth.sum()
    draw = int(target_nnz * 1.035)           # oversample for dedup loss
    # column of each draw ~ depth, row ~ popularity
    cols = rs.choice(n, size=draw, p=depth).astype(np.int32)
    rows = np.searchsorted(cdf, rs.random_sample(draw)).astype(np.int32)
    rows = np.minimum(rows, m - 1)
    order = np.lexsort((rows, cols))
    cols = cols[order]
    rows = rows[order]
    del order
    keep = np.empty(draw, bool)
    keep[0] = True
    np.logical_or(cols[1:] != cols[:-1], rows[1:] != rows[:-1],
                  out=keep[1:])
    cols = cols[keep]
    rows = rows[keep]
    nnz = len(rows)
    vals = (1.0 + rs.geometric(0.42, nnz).astype(np.float32))
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(cols, minlength=n), out=indptr[1:])
    print(f"[gen] {m}x{n} nnz={nnz/1e6:.1f}M "
          f"(density {nnz/(m*n)*100:.2f}%) in {time.time()-t0:.0f}s",
          flush=True)
    return indptr, rows, vals


def write_spz(indptr, rows, vals, m, n, path):
    import scipy.sparse as sp

    from rcppml_tpu.io.spz import st_write
    A = sp.csc_matrix((vals, rows, indptr), shape=(m, n))
    t0 = time.time()
    info = st_write(A, path, chunk_cols=2048, with_transpose=True)
    dt = time.time() - t0
    raw = len(vals) * 8 + (n + 1) * 8        # reference's raw-CSC basis
    size = os.path.getsize(path)
    print(f"[spz] wrote {size/1e9:.2f} GB in {dt:.0f}s "
          f"(ratio {raw/size:.2f}x vs raw CSC)", flush=True)
    return {"file_gb": round(size / 1e9, 3),
            "compress_seconds": round(dt, 1),
            "compression_ratio_vs_raw_csc": round(raw / size, 2),
            "value_type": info["value_type"]}


def measure_link_bandwidth():
    """Host->device bandwidth of this attachment (MB/s), measured with a
    64 MB device_put."""
    import jax
    buf = np.zeros(64 << 20, np.uint8)
    jax.block_until_ready(jax.device_put(buf[:1 << 20]))   # warm
    t0 = time.time()
    jax.block_until_ready(jax.device_put(buf))
    return (64 << 20) / (time.time() - t0) / 1e6


def time_device_ops(loader, k: int):
    """Device-only cost of one forward + one transpose panel update
    (densify + RHS GEMM + CD solve), inputs pre-staged on device."""
    import jax
    import jax.numpy as jnp

    import rcppml_tpu as rt
    from rcppml_tpu.models.nmf_chunked import _coo_densify, _panel_solve
    from rcppml_tpu.ops import linalg

    m, n = loader.shape
    cfg = rt.build_config(k, seed=1, maxit=1, sort_model=False)
    out = {}
    from rcppml_tpu.models.nmf_chunked import _compact_sparse
    for transposed, rows_dim, fdim in ((False, m, m), (True, n, n)):
        # the REAL engine's wire format (uint16 values for the >255 tail,
        # 4096 bucket floor) — not a re-implementation that could diverge
        # from what the measured sweep actually ships (round-4 review)
        ch = _compact_sparse(loader.chunk_coo(0, transposed), rows_dim)
        d_rows = jax.device_put(ch.rows)
        d_counts = jax.device_put(ch.counts)
        d_vals = jax.device_put(ch.vals)
        F = jax.device_put(np.abs(np.random.RandomState(0)
                                  .rand(k, fdim)).astype(np.float32))
        X0 = jnp.zeros((k, ch.num_cols), np.float32)
        G = linalg.gram(F)

        def step():
            P = _coo_densify(d_rows, d_counts, d_vals, nrows=rows_dim,
                             ncols=ch.num_cols)
            return _panel_solve(cfg, "H", G, F, P, X0, jnp.float32(0))
        jax.block_until_ready(step())        # compile
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(step())
            best = min(best, time.perf_counter() - t0)
        out["transpose" if transposed else "forward"] = best
    return out


def run_fit(path: str, k: int, sweeps: int):
    import rcppml_tpu as rt
    from rcppml_tpu.io.loaders import SpzLoader
    from rcppml_tpu.models.nmf_chunked import nmf_chunked

    class TimedLoader(SpzLoader):
        decode_s = 0.0
        decode_calls = 0

        def chunk_coo(self, idx, transpose=False):
            t0 = time.perf_counter()
            out = super().chunk_coo(idx, transpose)
            TimedLoader.decode_s += time.perf_counter() - t0
            TimedLoader.decode_calls += 1
            return out

    loader = TimedLoader(path)
    m, n = loader.shape
    nnz = loader.nnz()
    chunks_f = loader.num_chunks(False)
    chunks_t = loader.num_chunks(True)
    print(f"[fit] {m}x{n} nnz={nnz/1e6:.0f}M panels {chunks_f}+{chunks_t}",
          flush=True)

    link_mbps = measure_link_bandwidth()
    dev = time_device_ops(loader, k)
    t_device_sweep = dev["forward"] * chunks_f + dev["transpose"] * chunks_t

    stamps = []
    cfg = rt.build_config(k, seed=1, maxit=sweeps, tol=0.0,
                          sort_model=False)
    t0 = time.time()
    # panel_cache=None: the auto-gate picks the wire-resident compact
    # cache when it fits HBM (sweep 1 streams + pins ~5 GB of wire
    # arrays; sweeps 2+ run with zero host decode / link upload)
    res = nmf_chunked(loader, cfg, panel_cache=None,
                      on_iteration=lambda *a: stamps.append(time.time()))
    total = time.time() - t0
    sweep_walls = np.diff([t0] + stamps) if stamps else [total]
    # steady-state sweep (first sweep carries all jit compiles)
    steady = float(sweep_walls[-1]) if len(sweep_walls) > 1 \
        else float(sweep_walls[0])

    # wire bytes per sweep: forward (u16 rows + u8 vals) + transpose
    # (i32 rows + u8 vals) + counts
    fwd_b = nnz * 3 + chunks_f * 2048 * 4
    trp_b = nnz * 5 + chunks_t * 2048 * 4
    upload_s = (fwd_b + trp_b) / (link_mbps * 1e6)
    decode_per_sweep = TimedLoader.decode_s / max(len(sweep_walls), 1)

    busy = t_device_sweep / steady
    # projection to a locally-attached card (PCIe gen4 x16 ~ 16 GB/s loaded)
    upload_local = (fwd_b + trp_b) / 16e9
    ingest_local = max(decode_per_sweep, upload_local)   # overlapped
    busy_local = t_device_sweep / max(t_device_sweep, ingest_local)

    import jax
    return {
        "workload": f"{m}x{n} k={k}, {nnz/1e6:.0f}M nnz "
                    f"({nnz/(m*n)*100:.2f}% dense: "
                    f"{m*n*4/1e9:.0f} GB would not fit HBM)",
        "device": jax.devices()[0].device_kind,
        "sweeps": sweeps,
        "total_seconds": round(total, 1),
        "steady_sweep_seconds": round(steady, 1),
        "iters_per_sec": round(1.0 / steady, 4),
        "train_loss": float(res.train_loss),
        "decomposition_per_sweep_s": {
            "device_compute": round(t_device_sweep, 2),
            "host_decode": round(decode_per_sweep, 2),
            "link_upload_est": round(upload_s, 2),
        },
        "link_push_mbps": round(link_mbps, 1),
        "device_busy_fraction": round(busy, 4),
        "projection_local_pcie": {
            "assumed_link_gbps": 16,
            "ingest_per_sweep_s": round(ingest_local, 2),
            "device_busy_fraction": round(busy_local, 4),
            "note": "decode and upload overlap device compute "
                    "(Prefetcher + async dispatch); busy = "
                    "device / max(device, ingest)",
        },
        "arithmetic_intensity_note": (
            f"streaming ALS moves each nnz across the link once per "
            f"sweep for ~4k FLOPs of GEMM: {4 * k} FLOP / ~4 wire bytes "
            f"= {k:.0f} FLOP/B, orders of magnitude below what a "
            f"16 GB/s link needs to keep a matrix unit busy, so "
            f"chip-busy is bounded by ingest at ANY attachment — same "
            f"physics as the "
            f"reference's disk-bound chunked engine "
            f"(streampress.Rmd:355: 93 s just to READ this matrix at "
            f"1 thread; its GPU chunked path is PCIe/decode-bound "
            f"too).  The engine's job is to hide ingest behind "
            f"compute (prefetch overlap) and to minimize wire bytes "
            f"(sparse compact panels), both measured here."),
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gen", action="store_true")
    ap.add_argument("--fit", action="store_true")
    ap.add_argument("--m", type=int, default=38606)
    ap.add_argument("--n", type=int, default=278676)
    ap.add_argument("--nnz", type=int, default=554_000_000)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--sweeps", type=int, default=2)
    ap.add_argument("--path", default=DEFAULT_PATH)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    record = {}
    if args.gen:
        indptr, rows, vals = synthesize(args.m, args.n, args.nnz)
        record["spz"] = write_spz(indptr, rows, vals, args.m, args.n,
                                  args.path)
        del indptr, rows, vals
    if args.fit:
        record.update(run_fit(args.path, args.k, args.sweeps))
    print(json.dumps(record))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
