"""Memory guards — core/memory.hpp + core/platform.hpp re-targeted.

The reference refuses an in-memory sparse transpose when it would not
fit in host RAM with 2x headroom (core/memory.hpp:152-190,
``check_transpose_memory``) and reads MemAvailable from /proc/meminfo
(core/platform.hpp:42-63).  On this stack the dangerous allocation is
different: sparse inputs are densified to fp32 on the device, so the
guard protects (1) the host densification and (2) the device-resident
copy, and its refusal message points at the .spz streaming path (the
same remedy the reference suggests).
"""
from __future__ import annotations

from dataclasses import dataclass

# Require this multiple of the allocation to be free, matching the
# reference's SAFETY_FACTOR = 2.0 (core/memory.hpp:167-169): fits,
# factors, and solver workspaces ride alongside the data matrix.
SAFETY_FACTOR = 2.0


def format_bytes(n: float) -> str:
    """Human-readable byte count (core/memory.hpp format_bytes)."""
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024.0 or unit == "TB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024.0
    return f"{n:.1f} TB"


def available_host_bytes() -> int:
    """MemAvailable from /proc/meminfo; 0 = unknown (platform.hpp:42-63)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


def device_hbm_bytes() -> int:
    """Per-device accelerator memory in bytes (``bytes_limit`` of the
    device's memory stats); 0 = unknown."""
    try:
        import jax
        stats = jax.devices()[0].memory_stats()
        return int((stats or {}).get("bytes_limit") or 0)
    except Exception:
        return 0


@dataclass
class MemoryCheckResult:
    """Mirror of core/memory.hpp MemoryCheckResult."""
    fits: bool
    required_bytes: int
    available_bytes: int
    headroom_fraction: float
    message: str


def check_dense_alloc(m: int, n: int, itemsize: int = 4,
                      where: str = "host") -> MemoryCheckResult:
    """Would a dense (m, n) allocation fit with 2x headroom?

    ``where`` selects the budget: "host" (RAM, for densifying sparse
    input) or "device" (accelerator memory, for the device-resident copy).
    Unknown
    budgets pass with a note, as in core/memory.hpp:157-165.
    """
    required = int(m) * int(n) * int(itemsize)
    available = (available_host_bytes() if where == "host"
                 else device_hbm_bytes())
    if available == 0:
        return MemoryCheckResult(
            True, required, 0, 0.0,
            f"dense allocation: {format_bytes(required)} "
            f"({where} memory unknown — proceeding)")
    headroom = available / max(required, 1)
    if headroom >= SAFETY_FACTOR:
        return MemoryCheckResult(
            True, required, available, headroom,
            f"dense allocation: {format_bytes(required)} of "
            f"{format_bytes(available)} available ({where}, "
            f"headroom {headroom:.0f}x)")
    return MemoryCheckResult(
        False, required, available, headroom,
        f"INSUFFICIENT {where.upper()} MEMORY for an in-memory dense "
        f"{m} x {n} matrix: needs {format_bytes(required)} "
        f"(x{SAFETY_FACTOR:.0f} headroom) but only "
        f"{format_bytes(available)} is available.\n"
        f"Write the data to .spz (rcppml_tpu.io.spz.st_write) and pass "
        f"the path to nmf()/svd() to stream it in chunks instead.")


def guard_dense_input(m: int, n: int, itemsize: int = 4) -> None:
    """Raise MemoryError before densifying a sparse input that cannot
    fit in host RAM — the check_transpose_memory refusal re-targeted."""
    res = check_dense_alloc(m, n, itemsize, where="host")
    if not res.fits:
        raise MemoryError(res.message)
