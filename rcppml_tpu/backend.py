"""Where the next computation runs.

Every backend-dependent choice (the Triton CD kernels, the bf16 IRLS
fields, the Khatri-Rao weighted Gram) asks :func:`platform`.  It follows
``jax.default_device`` when one is set, so a CPU reference computed inside
``with jax.default_device(jax.devices("cpu")[0])`` takes the CPU paths even
in a process whose default backend is a GPU.  The default device is part
of jit's trace context, so a jitted fit traced for one platform is not
reused for the other.
"""

from __future__ import annotations

import jax


def platform() -> str:
    """``"cpu"``, ``"gpu"``, ... for the default device, else the default
    backend."""
    dev = jax.config.jax_default_device
    if dev is None:
        return jax.default_backend()
    if isinstance(dev, str):
        return jax.devices(dev)[0].platform
    return dev.platform


def on_accelerator() -> bool:
    return platform() != "cpu"
