"""Test harness: run everything on a virtual 8-device CPU mesh.

The reference gates GPU tests on hardware (SURVEY.md §4); we instead test
the multi-chip sharding logic on CPU via XLA's host-platform device-count
flag.  These env vars must be set before jax is imported anywhere.

``RCPPML_GPU_TESTS=1`` keeps the ambient backend instead (the analog of the
reference's hardware-gated suite, test_gpu_accuracy.R:24
``skip_if_not(gpu_available())``): on a machine with an NVIDIA GPU,
``RCPPML_GPU_TESTS=1 python -m pytest -m gpu tests/`` runs the tests that
need the card, in one process.  Each such test takes the ``gpu`` fixture,
which skips it when the default device is not a GPU.
"""

import os

import jax

if not os.environ.get("RCPPML_GPU_TESTS"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    xla_flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in xla_flags:
        os.environ["XLA_FLAGS"] = (
            xla_flags + " --xla_force_host_platform_device_count=8").strip()
    jax.config.update("jax_platforms", "cpu")

import gc

import numpy as np
import pytest


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_per_module():
    """Free compiled XLA executables between test modules.

    Every compiled executable holds JIT code pages as live memory
    mappings; the full suite compiles thousands and crosses the kernel's
    vm.max_map_count (65530) mid-run, at which point mmap failures inside
    XLA's compiler segfault the process.  Clearing the jit caches per
    module keeps the mapping count bounded (measured: ~250 maps/test
    unbounded, segfault at ~450 tests; bounded with this fixture)."""
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="session")
def small_factors():
    from rcppml_tpu.utils.simulate import simulate_nmf
    return simulate_nmf(m=60, n=80, k=4, noise=0.02, seed=123)


@pytest.fixture
def gpu():
    """The GPU the test runs on; skips the test anywhere else."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: run with RCPPML_GPU_TESTS=1 "
                    "on a machine with the card")
    return dev
