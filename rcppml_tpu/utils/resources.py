"""Device/resource introspection — the `gpu_available()` / `gpu_info()` /
`Resources::detect()` analog (core/resources.hpp:48-149, R/gpu_backend.R).

Single code path: the accelerator is whatever JAX's default backend is; a
CPU-only environment runs the identical program (the reference's dlsym +
try/catch fallback machinery has no analog because there is nothing to
fall back from).
"""

from __future__ import annotations

from typing import List


def tpu_available() -> bool:
    """True when an accelerator backend (e.g. "gpu") is JAX's default."""
    import jax
    try:
        return jax.default_backend() not in ("cpu",)
    except Exception:
        return False


def tpu_info() -> dict:
    """Device inventory + mesh recommendation (gpu_info() analog)."""
    import jax
    devs = jax.devices()
    info = {
        "backend": jax.default_backend(),
        "num_devices": len(devs),
        "devices": [str(d) for d in devs],
        "platform_version": getattr(devs[0], "device_kind", "unknown")
        if devs else None,
    }
    try:
        from ..parallel.mesh import default_mesh
        mesh = default_mesh()
        info["default_mesh"] = {ax: int(sz) for ax, sz in
                                zip(mesh.axis_names, mesh.devices.shape)}
    except Exception:
        info["default_mesh"] = None
    return info


def select_resources(nnz: int = 0, n: int = 0) -> str:
    """Dispatch heuristic analog (GPU_README.md:67-74: accelerator when
    nnz >= 100K or n >= 5000).  Returns the accelerator's backend name as
    JAX reports it (e.g. 'gpu') or 'cpu' — informational, since both run
    the same program."""
    import jax
    return jax.default_backend() if tpu_available() else "cpu"


def load_data(path: str):
    """Auto-detecting matrix loader (R/nmf_validation.R:30-120
    validate_data): .spz / .mtx / .csv / .h5ad / .loom / .h5 / .rda / .npz.
    """
    import os
    if not os.path.exists(path):
        raise FileNotFoundError(f"no such data file: {path}")
    lower = path.lower()
    if lower.endswith((".tsv", ".tsv.gz", ".txt")):
        import numpy as np
        return np.loadtxt(path, delimiter="\t", ndmin=2)
    if lower.endswith(".spz"):
        from ..io.spz import st_read_auto
        return st_read_auto(path)
    if lower.endswith((".mtx", ".mtx.gz")):
        from scipy.io import mmread
        return mmread(path).tocsc()
    if lower.endswith((".csv", ".csv.gz")):
        import numpy as np
        try:
            return np.loadtxt(path, delimiter=",", ndmin=2)
        except ValueError:
            # header row / rowname column (R's read.csv tolerates both,
            # R/nmf_validation.R): let pandas sniff them
            import pandas as pd
            df = pd.read_csv(path)
            first = df.columns[0]
            if not pd.api.types.is_numeric_dtype(df[first]):  # rownames col
                df = df.set_index(first)
                df.index.name = None
            return df                            # DataFrame: names carry
    if lower.endswith(".h5ad"):
        from ..io.spz import _read_h5ad_x
        return _read_h5ad_x(path)
    if lower.endswith(".loom"):
        from ..io.spz import _read_loom
        return _read_loom(path)
    if lower.endswith(".h5"):
        from ..io.spz import _read_10x_h5
        return _read_10x_h5(path)
    if lower.endswith((".rda", ".rdata")):
        from ..io.rdata import read_rda
        objs = read_rda(path)
        if len(objs) == 1:
            return next(iter(objs.values()))
        return objs
    if lower.endswith(".rds"):
        from ..io.rdata import read_rds
        return read_rds(path)
    if lower.endswith(".npz"):
        import numpy as np
        import scipy.sparse as sp
        try:
            return sp.load_npz(path)
        except Exception:
            with np.load(path) as z:
                return z[z.files[0]]
    if lower.endswith(".npy"):
        import numpy as np
        return np.load(path)
    raise ValueError(f"unrecognized data format: {path}")
