"""SplitMix64 determinism and cross-implementation parity.

Models the reference's RNG contract tests (tests/cpp/test_rng.cpp):
sequential stream values, position-hash purity, and the holdout threshold.
The traced uint32-pair implementation must be bit-identical to the numpy
uint64 one.
"""

import numpy as np
import pytest

from rcppml_tpu import rng

pytestmark = pytest.mark.numerics  # numerics-critical subset


def _splitmix_scalar(seed):
    """Straightforward scalar SplitMix64 for cross-checking (rng.hpp:89-95)."""
    state = seed & 0xFFFFFFFFFFFFFFFF
    if state == 0:
        state = 12345

    def nxt():
        nonlocal state
        state = (state + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
        z = state
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        return z ^ (z >> 31)
    return nxt


def test_sequential_stream_matches_scalar():
    nxt = _splitmix_scalar(42)
    expected = [nxt() for _ in range(100)]
    got = rng.next_u64(42, 100)
    assert [int(x) for x in got] == expected


def test_zero_seed_remap():
    assert int(rng.next_u64(0, 1)[0]) == int(rng.next_u64(12345, 1)[0])


def test_fill_uniform_column_major_order():
    # column j of a (rows, cols) fill must consume draws j*rows..(j+1)*rows
    vals = rng.next_u64(7, 12).astype(np.float32) / np.float32(2**64)
    M = rng.fill_uniform(7, 3, 4)
    assert M.shape == (3, 4)
    np.testing.assert_array_equal(M[:, 0], vals[0:3])
    np.testing.assert_array_equal(M[:, 2], vals[6:9])


def test_position_hash_pure_and_distributed():
    h1 = rng.position_hash(99, np.arange(50)[:, None], np.arange(60)[None, :])
    h2 = rng.position_hash(99, np.arange(50)[:, None], np.arange(60)[None, :])
    np.testing.assert_array_equal(h1, h2)
    # roughly uniform over u64 range
    frac = (h1.astype(np.float64) / 2.0**64).mean()
    assert 0.4 < frac < 0.6


def test_holdout_mask_probability():
    mask = rng.holdout_mask(3, 300, 400, inv_prob=10)
    rate = mask.mean()
    assert abs(rate - 0.1) < 0.01
    # deterministic
    np.testing.assert_array_equal(mask, rng.holdout_mask(3, 300, 400, inv_prob=10))
    # different seed -> different mask
    assert (mask != rng.holdout_mask(4, 300, 400, inv_prob=10)).any()


def test_traced_hash_matches_numpy():
    import jax.numpy as jnp
    ii = np.arange(64, dtype=np.uint32)
    jj = np.arange(48, dtype=np.uint32)
    expect = rng.position_hash(1234, ii[:, None], jj[None, :])
    lo, hi = rng.position_hash_traced(1234, jnp.asarray(ii)[:, None],
                                      jnp.asarray(jj)[None, :])
    got = np.asarray(hi, dtype=np.uint64) << np.uint64(32)
    got |= np.asarray(lo, dtype=np.uint64)
    np.testing.assert_array_equal(got, expect)


def test_traced_holdout_matches_numpy():
    import jax.numpy as jnp
    expect = rng.holdout_mask(77, 100, 90, inv_prob=5)
    ii = jnp.arange(100, dtype=jnp.uint32)[:, None]
    jj = jnp.arange(90, dtype=jnp.uint32)[None, :]
    got = np.asarray(rng.is_holdout_traced(77, ii, jj, 5))
    np.testing.assert_array_equal(got, expect)


def test_r_matrix_transpose_identical():
    A = rng.r_matrix(30, 40, seed=5, transpose_identical=True)
    B = rng.r_matrix(40, 30, seed=5, transpose_identical=True)
    np.testing.assert_array_equal(A.T, B)


def test_r_sparsematrix():
    S = rng.r_sparsematrix(50, 60, density=0.2, seed=3)
    assert 0.1 < S.nnz / (50 * 60) < 0.3
    S2 = rng.r_sparsematrix(50, 60, density=0.2, seed=3)
    assert (S != S2).nnz == 0
    T = rng.r_sparsematrix(60, 50, density=0.2, seed=3,
                           transpose_identical=True)
    T2 = rng.r_sparsematrix(50, 60, density=0.2, seed=3,
                            transpose_identical=True)
    np.testing.assert_allclose(T.toarray().T, T2.toarray())


def test_r_sample():
    s = rng.r_sample(100, 10, seed=1)
    assert len(set(s.tolist())) == 10
    np.testing.assert_array_equal(s, rng.r_sample(100, 10, seed=1))
    sr = rng.r_sample(10, 50, seed=2, replace=True)
    assert len(sr) == 50 and sr.max() < 10


def test_r_unif_binom():
    u = rng.r_unif(1000, seed=4, lo=2.0, hi=5.0)
    assert 2.0 <= u.min() and u.max() < 5.0
    b = rng.r_binom(5000, 0.3, seed=5)
    assert 0.25 < b.mean() < 0.35


def test_u64_to_f32_single_rounding():
    """The device-side init's uint64 -> float32 conversion must reproduce
    numpy's single correctly-rounded conversion exactly (the bit-parity of
    every device-initialized fit rests on this; rng._u64_to_f32_rn)."""
    import jax
    import jax.numpy as jnp
    rs = np.random.RandomState(0)
    z = (rs.randint(0, 2 ** 63, 300000, dtype=np.uint64) * 2
         + rs.randint(0, 2, 300000).astype(np.uint64))
    z[:10] = [0, 1, 2 ** 24, 2 ** 24 + 1, 2 ** 25 + 3, 2 ** 32 - 1,
              2 ** 32, 2 ** 63, 2 ** 64 - 1, 2 ** 53 + 7]
    lo = jnp.asarray((z & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    hi = jnp.asarray((z >> np.uint64(32)).astype(np.uint32))
    got = np.asarray(jax.jit(rng._u64_to_f32_rn)(lo, hi))
    np.testing.assert_array_equal(got, z.astype(np.float32))


def test_fill_uniform_traced_bit_parity():
    """Device fill == host fill bitwise, across seeds, shapes, offsets —
    the load-bearing claim behind models/nmf._init_random_device."""
    import jax
    for seed in (0, 1, 42, 123456789, 2 ** 63 + 5):
        for rows, cols, off in ((3, 4, 0), (20, 137, 0), (20, 137, 2740),
                                (7, 1, 999)):
            h = rng.fill_uniform(seed, rows, cols, offset=off)
            d = np.asarray(jax.jit(
                lambda s=seed, r=rows, c=cols, o=off:
                rng.fill_uniform_traced(s, r, c, offset=o))())
            np.testing.assert_array_equal(h, d)
