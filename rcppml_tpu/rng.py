"""SplitMix64 RNG — deterministic initialization and holdout masks.

Re-implements the RNG *contract* of the reference
(``inst/include/FactorNet/rng/rng.hpp:60-221``) so that

  * the same integer seed produces the same W/H initialization matrices, and
  * cross-validation holdout masks are a pure function of ``(seed, i, j)``
    that is identical everywhere it is evaluated (host numpy, JAX-traced
    uint32-pair arithmetic, or a Pallas kernel).

Two modes, as in the reference:

  1. **Sequential** — golden-ratio counter + SplitMix64 finalizer.  Because
     the state after ``t`` draws is ``seed + t * GOLDEN``, the whole stream
     can be generated *vectorized* (no sequential dependency), which is how
     :func:`fill_uniform` works.
  2. **Position-dependent** — ``hash(seed, i, j)`` never mutates state; used
     for speckled CV masks (rng.hpp:129-170).

All host-side generation uses numpy uint64 (exact).  The traced variant
uses uint32 limb-pair arithmetic so it needs no 64-bit integer support
(JAX runs with x64 disabled by default).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_COLMIX = np.uint64(0x6C62272E07BB0142)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)
_U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def _finalize(z: np.ndarray) -> np.ndarray:
    """SplitMix64 output mixing (rng.hpp:91-94)."""
    with np.errstate(over="ignore"):
        z = (z ^ (z >> np.uint64(30))) * _MIX1
        z = (z ^ (z >> np.uint64(27))) * _MIX2
        return z ^ (z >> np.uint64(31))


def _canon_seed(seed: int) -> np.uint64:
    """Seed 0 is remapped to 12345 to avoid a degenerate state (rng.hpp:73-74)."""
    s = np.uint64(seed & 0xFFFFFFFFFFFFFFFF)
    return np.uint64(12345) if s == 0 else s


def next_u64(seed: int, count: int, offset: int = 0) -> np.ndarray:
    """The sequential SplitMix64 stream, vectorized.

    Draw ``t`` (1-based) of the reference's sequential ``next()`` equals
    ``finalize(seed + t * GOLDEN)``; this returns draws
    ``offset+1 .. offset+count``.
    """
    s = _canon_seed(seed)
    t = np.arange(offset + 1, offset + count + 1, dtype=np.uint64)
    with np.errstate(over="ignore"):
        z = s + t * _GOLDEN
    return _finalize(z)


def fill_uniform(seed: int, rows: int, cols: int, *, offset: int = 0,
                 dtype=np.float32) -> np.ndarray:
    """Column-major uniform [0,1) fill, identical to ``fill_uniform``
    (rng.hpp:194-201): the sequential stream fills column 0 top-to-bottom,
    then column 1, etc.  Returns a (rows, cols) array.
    """
    z = next_u64(seed, rows * cols, offset)
    # float cast of UINT64_MAX rounds to 2^64 in both C++ and numpy.
    u = z.astype(dtype) / dtype(float(int(_U64_MAX)))
    return u.reshape(cols, rows).T


def position_hash(seed: int, i: np.ndarray, j: np.ndarray) -> np.ndarray:
    """Pure position hash (rng.hpp:129-138): ``hash(seed, i, j)``.

    ``i``/``j`` broadcast; uint32 semantics on the indices (matching the
    reference's uint32_t parameters).
    """
    s = _canon_seed_like(seed)
    i64 = np.asarray(i).astype(np.uint32).astype(np.uint64)
    j64 = np.asarray(j).astype(np.uint32).astype(np.uint64)
    with np.errstate(over="ignore"):
        h = s + i64 * _GOLDEN + j64 * _COLMIX
    return _finalize(h)


def _canon_seed_like(seed: int) -> np.uint64:
    # position hash does NOT remap zero seeds in the reference (it is a static
    # function taking seed directly) — but callers pass an engine seeded with
    # the canonical remap, so we preserve the remap for consistency with
    # ``SplitMix64(seed).is_holdout(...)`` usage (rng.hpp:178-182).
    return _canon_seed(seed)


def holdout_mask(seed: int, rows, cols, inv_prob: int) -> np.ndarray:
    """Dense boolean holdout mask: True where (i, j) is held out.

    ``hash(seed,i,j) < UINT64_MAX / inv_prob`` (rng.hpp:164-170).
    ``rows``/``cols`` may be ints (meaning ``arange``) or index arrays.
    """
    if inv_prob <= 0:
        shape_r = rows if not np.isscalar(rows) else np.arange(rows)
        shape_c = cols if not np.isscalar(cols) else np.arange(cols)
        return np.zeros((len(shape_r), len(shape_c)), dtype=bool)
    ii = np.arange(rows, dtype=np.uint32) if np.isscalar(rows) else np.asarray(rows, np.uint32)
    jj = np.arange(cols, dtype=np.uint32) if np.isscalar(cols) else np.asarray(cols, np.uint32)
    h = position_hash(seed, ii[:, None], jj[None, :])
    thresh = _U64_MAX // np.uint64(inv_prob)
    return h < thresh


def r_matrix(rows: int, cols: int, seed: int = 0,
             transpose_identical: bool = False) -> np.ndarray:
    """Reproducible uniform matrix (R/random.R r_matrix).  With
    ``transpose_identical``, entry (i, j) is a pure position hash so
    ``r_matrix(n, m, s, True).T == r_matrix(m, n, s, True)`` — the
    transpose-consistency testing trick."""
    if transpose_identical:
        # symmetric position hash: unordered pair (min, max)
        ii = np.arange(rows, dtype=np.uint32)[:, None]
        jj = np.arange(cols, dtype=np.uint32)[None, :]
        lo = np.minimum(ii, jj)
        hi = np.maximum(ii, jj)
        h = position_hash(seed, lo, hi)
        return (h.astype(np.float64) / float(int(_U64_MAX))).astype(np.float32)
    return fill_uniform(seed, rows, cols)


def r_sparsematrix(rows: int, cols: int, density: float = 0.1, seed: int = 0,
                   transpose_identical: bool = False):
    """Reproducible sparse uniform matrix (R/random.R r_sparsematrix)."""
    import scipy.sparse as sp
    vals = r_matrix(rows, cols, seed, transpose_identical)
    ii = np.arange(rows, dtype=np.uint32)[:, None]
    jj = np.arange(cols, dtype=np.uint32)[None, :]
    if transpose_identical:
        keep_hash = position_hash(seed ^ 0x5BF03635, np.minimum(ii, jj),
                                  np.maximum(ii, jj))
    else:
        keep_hash = position_hash(seed ^ 0x5BF03635, ii, jj)
    keep = keep_hash < np.uint64(density * float(int(_U64_MAX)))
    return sp.csc_matrix(np.where(keep, vals, 0.0))


def r_sample(n: int, size: int, seed: int = 0, replace: bool = False):
    """Reproducible sampling (R/random.R r_sample) via the sequential stream."""
    if replace:
        return (next_u64(seed, size) % np.uint64(n)).astype(np.int64)
    order = np.argsort(next_u64(seed, n), kind="stable")
    return order[:size].astype(np.int64)


def r_unif(count: int, seed: int = 0, lo: float = 0.0, hi: float = 1.0):
    u = next_u64(seed, count).astype(np.float64) / float(int(_U64_MAX))
    return (lo + (hi - lo) * u).astype(np.float32)


def r_binom(count: int, p: float, seed: int = 0):
    u = next_u64(seed, count).astype(np.float64) / float(int(_U64_MAX))
    return (u < p).astype(np.int32)


def subsample_mask_1d(seed: int, count: int, frac: float,
                      use_col_constant: bool = True) -> np.ndarray:
    """Row/column subsample eligibility (speckled_cv.hpp:80-104):
    1-D SplitMix hash with the dedicated subsample seed
    ``seed ^ 0xDEADBEEFCAFEBABE``; columns use the golden-ratio constant,
    rows the column-mix constant, to avoid correlation."""
    if frac >= 1.0:
        return np.ones(count, dtype=bool)
    sub_seed = _canon_seed(seed) ^ np.uint64(0xDEADBEEFCAFEBABE)
    mult = _GOLDEN if use_col_constant else _COLMIX
    idx = np.arange(count, dtype=np.uint64)
    with np.errstate(over="ignore"):
        h = sub_seed + idx * mult
    h = _finalize(h)
    thresh = np.uint64(frac * float(int(_U64_MAX)))
    return h < thresh


# ---------------------------------------------------------------------------
# Traced (JAX) variant — uint32 limb pairs, usable inside jit / Pallas.
# ---------------------------------------------------------------------------

def _u64_from_u32(lo, hi):
    return lo, hi


def _u64_add(a, b):
    alo, ahi = a
    blo, bhi = b
    lo = alo + blo
    carry = (lo < alo).astype(jnp.uint32)
    hi = ahi + bhi + carry
    return lo, hi


def _u64_mul(a, b):
    """64x64 -> low 64 bits, via 16-bit limb products to stay in uint32."""
    alo, ahi = a
    blo, bhi = b

    def mul32(x, y):
        # full 32x32 -> (lo32, hi32)
        x0 = x & jnp.uint32(0xFFFF)
        x1 = x >> jnp.uint32(16)
        y0 = y & jnp.uint32(0xFFFF)
        y1 = y >> jnp.uint32(16)
        p00 = x0 * y0
        p01 = x0 * y1
        p10 = x1 * y0
        p11 = x1 * y1
        mid = (p00 >> jnp.uint32(16)) + (p01 & jnp.uint32(0xFFFF)) + (p10 & jnp.uint32(0xFFFF))
        lo = (p00 & jnp.uint32(0xFFFF)) | (mid << jnp.uint32(16))
        hi = p11 + (p01 >> jnp.uint32(16)) + (p10 >> jnp.uint32(16)) + (mid >> jnp.uint32(16))
        return lo, hi

    lo, carry_hi = mul32(alo, blo)
    hi = carry_hi + alo * bhi + ahi * blo  # low-32 products suffice for hi
    return lo, hi


def _u64_xor(a, b):
    return a[0] ^ b[0], a[1] ^ b[1]


def _u64_shr(a, n):
    lo, hi = a
    n = int(n)
    if n == 0:
        return lo, hi
    if n >= 32:
        return hi >> jnp.uint32(n - 32), jnp.zeros_like(hi)
    return (lo >> jnp.uint32(n)) | (hi << jnp.uint32(32 - n)), hi >> jnp.uint32(n)


def _u64_const(v: int):
    return jnp.uint32(v & 0xFFFFFFFF), jnp.uint32((v >> 32) & 0xFFFFFFFF)


def _finalize_traced(z):
    z = _u64_mul(_u64_xor(z, _u64_shr(z, 30)), _u64_const(0xBF58476D1CE4E5B9))
    z = _u64_mul(_u64_xor(z, _u64_shr(z, 27)), _u64_const(0x94D049BB133111EB))
    return _u64_xor(z, _u64_shr(z, 31))


def seed_to_u32_pair(seed: int) -> np.ndarray:
    """Canonical seed as a (lo32, hi32) uint32 array — lets the seed be a
    TRACED jit argument so CV repetitions share one compiled executable."""
    s = int(_canon_seed(seed))
    return np.asarray([s & 0xFFFFFFFF, (s >> 32) & 0xFFFFFFFF],
                      dtype=np.uint32)


def position_hash_traced(seed, i, j):
    """JAX-traced hash(seed, i, j) -> (lo32, hi32) uint32 pair.

    ``seed`` is an int (static) or a traced uint32[2] (lo, hi) array from
    :func:`seed_to_u32_pair`.  ``i``/``j`` broadcast.  Bit-identical to
    :func:`position_hash` / the reference hash.
    """
    if isinstance(seed, (int, np.integer)):
        s = int(_canon_seed(seed))
        seed_pair = (jnp.uint32(s & 0xFFFFFFFF),
                     jnp.uint32((s >> 32) & 0xFFFFFFFF))
    else:
        seed_pair = (seed[0], seed[1])
    i = i.astype(jnp.uint32)
    j = j.astype(jnp.uint32)
    ti = _u64_mul((i, jnp.zeros_like(i)), _u64_const(0x9E3779B97F4A7C15))
    tj = _u64_mul((j, jnp.zeros_like(j)), _u64_const(0x6C62272E07BB0142))
    h = _u64_add(_u64_add(seed_pair, ti), tj)
    return _finalize_traced(h)


def _u64_to_f32_rn(lo, hi):
    """Exact uint64 -> float32 round-to-nearest-even, on uint32 limb pairs.

    numpy/C++ convert uint64 to float32 with a single correctly-rounded
    conversion; naive ``f32(hi)*2^32 + f32(lo)`` double-rounds (up to 1 ulp
    off), which would break bit-parity between the device and host
    :func:`fill_uniform`.  This reproduces the single rounding with integer
    ops: keep the top 24 significant bits, round by the remainder (ties to
    even), scale by the dropped power of two.
    """
    from jax import lax as _lax
    u32 = jnp.uint32
    nbits = jnp.where(hi == 0,
                      32 - _lax.clz(lo),
                      64 - _lax.clz(hi)).astype(jnp.int32)
    shift = jnp.maximum(nbits - 24, 0).astype(u32)        # 0..40

    # mant = z >> shift (result < 2^24, fits in lo32)
    s_lo = jnp.minimum(shift, u32(31))                    # safe shift amounts
    ge32 = shift >= u32(32)
    sm32 = (u32(32) - jnp.minimum(shift, u32(31)))        # in 1..32, clamp
    # z >> shift for 0 <= shift < 32:  (lo >> shift) | (hi << (32-shift))
    lo_shift_lt32 = jnp.where(
        shift == 0, lo,
        (lo >> s_lo) | (hi << jnp.minimum(sm32, u32(31))))
    # for 32 <= shift < 64: hi >> (shift-32)
    lo_shift_ge32 = hi >> jnp.where(ge32, shift - u32(32), u32(0))
    mant = jnp.where(ge32, lo_shift_ge32, lo_shift_lt32)

    # rem = z & ((1 << shift) - 1), compared against half = 1 << (shift-1)
    sh1 = jnp.where(shift == 0, u32(0), shift - u32(1))   # shift-1 (safe)
    half_lo = jnp.where(sh1 < 32, u32(1) << jnp.minimum(sh1, u32(31)), u32(0))
    half_hi = jnp.where(sh1 >= 32, u32(1) << jnp.where(
        sh1 >= 32, sh1 - u32(32), u32(0)), u32(0))
    # mask for rem
    def _mask_pair(nb):
        # ((1 << nb) - 1) as (lo, hi), nb in 0..40
        lo_m = jnp.where(nb >= 32, u32(0xFFFFFFFF),
                         (u32(1) << jnp.minimum(nb, u32(31))) - u32(1))
        lo_m = jnp.where(nb == 0, u32(0), lo_m)
        hi_m = jnp.where(nb >= 32,
                         (u32(1) << jnp.minimum(nb - u32(32), u32(31)))
                         - u32(1), u32(0))
        return lo_m, hi_m
    m_lo, m_hi = _mask_pair(shift)
    rem_lo, rem_hi = lo & m_lo, hi & m_hi
    gt_half = (rem_hi > half_hi) | ((rem_hi == half_hi) & (rem_lo > half_lo))
    eq_half = (rem_hi == half_hi) & (rem_lo == half_lo)
    odd = (mant & u32(1)) == u32(1)
    round_up = jnp.where(shift == 0, False, gt_half | (eq_half & odd))
    mant = mant + round_up.astype(u32)

    # ldexp, not exp2: exp2 is a polynomial approximation and need not
    # return exact powers of two
    return jnp.ldexp(mant.astype(jnp.float32), shift.astype(jnp.int32))


def fill_uniform_traced(seed, rows: int, cols: int, *, offset: int = 0):
    """JAX-traced :func:`fill_uniform` — bit-identical column-major fill.

    ``seed`` is an int (static) or a uint32[2] (lo, hi) pair from
    :func:`seed_to_u32_pair`.  Runs on the accelerator, so the k*(m+n)
    init draws never cross the host link.
    """
    if isinstance(seed, (int, np.integer)):
        s = int(_canon_seed(int(seed)))
        seed_pair = (jnp.uint32(s & 0xFFFFFFFF),
                     jnp.uint32((s >> 32) & 0xFFFFFFFF))
    else:
        seed_pair = (seed[0], seed[1])
    count = rows * cols
    t = jnp.arange(offset + 1, offset + count + 1, dtype=jnp.uint32)
    t_hi = jnp.zeros_like(t)
    # counts can exceed 2^32 only for absurd shapes; keep the hi limb real
    if offset + count + 1 > 0xFFFFFFFF:
        t64 = np.arange(offset + 1, offset + count + 1, dtype=np.uint64)
        t = jnp.asarray((t64 & np.uint64(0xFFFFFFFF)).astype(np.uint32))
        t_hi = jnp.asarray((t64 >> np.uint64(32)).astype(np.uint32))
    z = _u64_add(seed_pair, _u64_mul((t, t_hi),
                                     _u64_const(0x9E3779B97F4A7C15)))
    z = _finalize_traced(z)
    u = _u64_to_f32_rn(*z) / jnp.float32(float(int(_U64_MAX)))
    return u.reshape(cols, rows).T


def is_holdout_traced(seed, i, j, inv_prob: int):
    """Traced boolean holdout test, identical to rng.hpp:164-170."""
    if inv_prob <= 0:
        return jnp.zeros(jnp.broadcast_shapes(i.shape, j.shape), dtype=bool)
    lo, hi = position_hash_traced(seed, i, j)
    thresh = (0xFFFFFFFFFFFFFFFF) // int(inv_prob)
    tlo = jnp.uint32(thresh & 0xFFFFFFFF)
    thi = jnp.uint32((thresh >> 32) & 0xFFFFFFFF)
    return (hi < thi) | ((hi == thi) & (lo < tlo))
