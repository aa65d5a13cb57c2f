"""StreamPress .spz round-trips and reference-format compatibility
(reference: test_spz_roundtrip_comprehensive.R, test_streampress_*.R)."""

import os

import numpy as np
import pytest
import scipy.sparse as sp

pytestmark = pytest.mark.numerics  # numerics-critical subset

scipy_sparse = pytest.importorskip("scipy.sparse")

from rcppml_tpu.io.spz import (SpzChunkReader, compress_to_spz_bytes,
                               decompress_spz_bytes, spz_info_bytes, st_info,
                               st_read, st_read_transpose, st_write)


def _random_sparse(seed=0, m=300, n=200, density=0.06, integer=True):
    rs = np.random.RandomState(seed)
    A = scipy_sparse.random(m, n, density=density, random_state=rs,
                            format="csc")
    if integer:
        A.data[:] = np.ceil(A.data * 30)
    A.eliminate_zeros()
    return A


@pytest.mark.parametrize("vt", ["uint8", "uint16", "uint32", "float32",
                                "float64"])
def test_roundtrip_value_types(vt):
    A = _random_sparse(integer=not vt.startswith("float"))
    if vt.startswith("float"):
        A.data[:] = A.data * 1.7
    buf = compress_to_spz_bytes(A, value_type=vt)
    B = decompress_spz_bytes(buf)
    np.testing.assert_allclose(B.toarray(), A.toarray(), rtol=1e-6)


def test_float16_lossy_roundtrip():
    A = _random_sparse(integer=False)
    buf = compress_to_spz_bytes(A, value_type="float16")
    B = decompress_spz_bytes(buf)
    np.testing.assert_allclose(B.toarray(), A.toarray(), rtol=1e-2, atol=1e-3)


def test_transpose_stream():
    A = _random_sparse(seed=3)
    buf = compress_to_spz_bytes(A, with_transpose=True)
    Bt = decompress_spz_bytes(buf, transpose=True)
    np.testing.assert_allclose(Bt.toarray(), A.toarray().T)


def test_info():
    A = _random_sparse(seed=5)
    buf = compress_to_spz_bytes(A, value_type="uint16")
    info = spz_info_bytes(buf)
    assert info["m"] == 300 and info["n"] == 200
    assert info["nnz"] == A.nnz
    assert info["value_type"] == "uint16"
    assert info["has_transpose"]


def test_file_api(tmp_path):
    A = _random_sparse(seed=7)
    path = str(tmp_path / "test.spz")
    st_write(A, path)
    B = st_read(path)
    np.testing.assert_allclose(B.toarray(), A.toarray())
    Bt = st_read_transpose(path)
    np.testing.assert_allclose(Bt.toarray(), A.toarray().T)
    info = st_info(path)
    assert info["nnz"] == A.nnz
    # compression actually compresses vs raw CSC
    raw = A.data.nbytes + A.indices.nbytes
    assert info["file_size"] < raw


def test_chunk_reader():
    A = _random_sparse(seed=9, n=500)
    buf = compress_to_spz_bytes(A, chunk_cols=128)
    r = SpzChunkReader(buf)
    assert r.num_chunks() == 4
    rebuilt = []
    for c in range(r.num_chunks()):
        cs, sub = r.chunk(c)
        assert cs == c * 128
        rebuilt.append(sub.toarray())
    np.testing.assert_allclose(np.hstack(rebuilt), A.toarray())


def test_reference_pbmc3k_decodes():
    """Cross-implementation compatibility: decode SPZ bytes produced by the
    REFERENCE encoder (shipped inside pbmc3k.rda)."""
    from rcppml_tpu import datasets
    P = datasets.pbmc3k()
    assert P.shape == (13714, 2638)
    assert P.nnz == 2238732
    assert float(P.data.min()) >= 1.0
    col_sums = np.asarray(P.sum(axis=0)).ravel()
    assert (col_sums > 0).all()


def test_empty_columns():
    A = scipy_sparse.csc_matrix((50, 30))
    A[3, 5] = 2.0
    A = A.tocsc()
    buf = compress_to_spz_bytes(A, value_type="uint8")
    B = decompress_spz_bytes(buf)
    np.testing.assert_allclose(B.toarray(), A.toarray())


# ---------------------------------------------------------------------------
# v3 dense format + converters
# ---------------------------------------------------------------------------

def test_v3_dense_roundtrip(tmp_path):
    from rcppml_tpu.io.spz import st_read_dense, st_write_dense
    rs = np.random.RandomState(1)
    A = rs.rand(80, 45).astype(np.float32)
    p = str(tmp_path / "d.spz")
    st_write_dense(A, p, chunk_cols=16)
    np.testing.assert_array_equal(st_read_dense(p), A)
    np.testing.assert_array_equal(st_read_dense(p, transpose=True), A.T)


def test_v3_fp16_codec(tmp_path):
    from rcppml_tpu.io.spz import st_read_dense, st_write_dense
    rs = np.random.RandomState(2)
    A = rs.rand(50, 30).astype(np.float32)
    p = str(tmp_path / "d16.spz")
    info = st_write_dense(A, p, codec="fp16")
    np.testing.assert_allclose(st_read_dense(p), A, atol=2e-3)
    raw = st_write_dense(A, str(tmp_path / "draw.spz"), codec="raw")
    assert info["file_size"] < raw["file_size"]


def test_version_autodetect(tmp_path):
    from rcppml_tpu.io.spz import (st_read_auto, st_write, st_write_dense)
    A = _random_sparse(seed=11)
    p2 = str(tmp_path / "v2.spz")
    st_write(A, p2)
    out2 = st_read_auto(p2)
    assert scipy_sparse.issparse(out2)
    p3 = str(tmp_path / "v3.spz")
    st_write_dense(A.toarray(), p3)
    out3 = st_read_auto(p3)
    assert isinstance(out3, np.ndarray)


def test_st_convert_mtx(tmp_path):
    from scipy.io import mmwrite
    from rcppml_tpu.io.spz import st_convert, st_read
    rs = np.random.RandomState(3)
    M = scipy_sparse.random(40, 30, density=0.2, random_state=rs)
    mp = str(tmp_path / "m.mtx")
    mmwrite(mp, M)
    st_convert(mp, str(tmp_path / "m.spz"))
    np.testing.assert_allclose(st_read(str(tmp_path / "m.spz")).toarray(),
                               M.toarray(), rtol=1e-5)


def test_st_convert_h5ad(tmp_path):
    h5py = pytest.importorskip("h5py")
    from rcppml_tpu.io.spz import st_convert, st_read
    rs = np.random.RandomState(4)
    X = scipy_sparse.random(25, 35, density=0.3, random_state=rs,
                            format="csr")
    hp = str(tmp_path / "t.h5ad")
    with h5py.File(hp, "w") as f:
        g = f.create_group("X")
        g.attrs["encoding-type"] = "csr_matrix"
        g.attrs["shape"] = X.shape
        g["data"] = X.data
        g["indices"] = X.indices
        g["indptr"] = X.indptr
    st_convert(hp, str(tmp_path / "t.spz"))
    got = st_read(str(tmp_path / "t.spz"))
    np.testing.assert_allclose(got.toarray(), X.T.toarray(), rtol=1e-5)


def test_st_add_transpose(tmp_path):
    from rcppml_tpu.io.spz import st_add_transpose, st_info, st_read_transpose, st_write
    A = _random_sparse(seed=6)
    p = str(tmp_path / "nt.spz")
    st_write(A, p, with_transpose=False)
    assert not st_info(p)["has_transpose"]
    st_add_transpose(p)
    assert st_info(p)["has_transpose"]
    np.testing.assert_allclose(st_read_transpose(p).toarray(), A.toarray().T)


def test_obs_var_tables_roundtrip(tmp_path):
    from rcppml_tpu.io.spz import (st_read, st_read_dimnames, st_read_obs,
                                   st_read_var, st_write_with_metadata)
    A = _random_sparse(seed=21, m=30, n=20)
    p = str(tmp_path / "meta.spz")
    st_write_with_metadata(
        A, p,
        obs={"group": np.array(["a", "b"] * 10),
             "score": np.arange(20, dtype=np.float32)},
        var={"gene_id": np.arange(30, dtype=np.int32)},
        rownames=[f"g{i}" for i in range(30)],
        colnames=[f"c{j}" for j in range(20)])
    obs = st_read_obs(p)
    assert [str(x) for x in obs["group"][:4]] == ["a", "b", "a", "b"]
    np.testing.assert_allclose(obs["score"], np.arange(20))
    var = st_read_var(p)
    np.testing.assert_array_equal(var["gene_id"], np.arange(30))
    dn = st_read_dimnames(p)
    assert dn["rownames"][0] == "g0" and dn["colnames"][-1] == "c19"
    np.testing.assert_allclose(st_read(p).toarray(), A.toarray())


def test_reference_pbmc3k_cell_types():
    """Decode the obs/var table the REFERENCE encoder embedded in pbmc3k."""
    from rcppml_tpu.datasets import pbmc3k_cell_types
    ct = pbmc3k_cell_types()
    assert len(ct) == 2638
    assert "Naive CD4 T" in set(ct)
    assert (ct == "B").sum() == 344


def test_slice_and_chunk_ranges(tmp_path):
    from rcppml_tpu.io.spz import (st_chunk_ranges, st_map_chunks, st_slice,
                                   st_slice_cols, st_slice_rows, st_write)
    A = _random_sparse(seed=31, m=40, n=100)
    p = str(tmp_path / "slice.spz")
    st_write(A, p, chunk_cols=32, with_transpose=True)
    ranges = st_chunk_ranges(p)
    assert ranges[0][0] == 0 and ranges[-1][1] == 100
    assert all(e - s <= 32 for s, e in ranges)
    cols = [5, 33, 34, 99]
    np.testing.assert_allclose(st_slice_cols(p, cols).toarray(),
                               A[:, cols].toarray())
    rows = [0, 7, 39]
    np.testing.assert_allclose(st_slice_rows(p, rows).toarray(),
                               A[rows].toarray())
    np.testing.assert_allclose(st_slice(p, rows=rows, cols=cols).toarray(),
                               A[np.ix_(rows, cols)].toarray())
    sums = st_map_chunks(p, lambda c, s, e: np.asarray(c.sum(axis=0)).ravel())
    np.testing.assert_allclose(np.concatenate(sums),
                               np.asarray(A.sum(axis=0)).ravel(), rtol=1e-6)


def test_filter_by_metadata(tmp_path):
    from rcppml_tpu.io.spz import (st_filter_cols, st_filter_rows,
                                   st_obs_indices, st_write_with_metadata)
    A = _random_sparse(seed=32, m=30, n=24)
    p = str(tmp_path / "filt.spz")
    st_write_with_metadata(
        A, p,
        obs={"cell_type": np.array(["B", "T", "NK"] * 8)},
        var={"hv": np.array([True, False] * 15)},
        with_transpose=True)
    idx = st_obs_indices(p, {"cell_type": "B"})
    np.testing.assert_array_equal(idx, np.arange(0, 24, 3))
    B = st_filter_cols(p, {"cell_type": "B"})
    np.testing.assert_allclose(B.toarray(), A[:, idx].toarray())
    # callable predicate on the var (per-row) table
    R = st_filter_rows(p, lambda t: np.asarray(t["hv"], dtype=bool))
    np.testing.assert_allclose(R.toarray(), A[::2].toarray())


def test_st_write_list(tmp_path):
    import scipy.sparse as sp
    from rcppml_tpu.io.spz import st_read, st_write_list
    A = _random_sparse(seed=33, m=25, n=10)
    B = _random_sparse(seed=34, m=25, n=14)
    p = str(tmp_path / "list.spz")
    info = st_write_list([A, B], p)
    assert info["n"] == 24
    np.testing.assert_allclose(
        st_read(p).toarray(), sp.hstack([A, B]).toarray())
    with pytest.raises(ValueError):
        st_write_list([A, _random_sparse(seed=35, m=11, n=3)],
                      str(tmp_path / "bad.spz"))


def test_st_read_device(tmp_path):
    """Device-resident decode (st_read_gpu analog)."""
    import jax
    from rcppml_tpu.io.spz import st_read_device, st_write
    import rcppml_tpu as rt
    A = _random_sparse(seed=41, m=30, n=24)
    p = str(tmp_path / "dev.spz")
    st_write(A, p)
    dev = st_read_device(p)
    assert isinstance(dev, jax.Array)
    np.testing.assert_allclose(np.asarray(dev), A.toarray())
    res = rt.nmf(dev, 3, seed=1, maxit=5)      # no re-upload path
    assert np.isfinite(res.train_loss)


# ---------------------------------------------------------------------------
# Decoder robustness: crafted/corrupt buffers must raise clean errors, never
# read or write out of bounds (round-1 advisor finding; the reference
# validates section sizes at sparsepress_v2.hpp:913)
# ---------------------------------------------------------------------------

def _small_spz_bytes():
    import scipy.sparse as sp
    from rcppml_tpu.io.spz import compress_to_spz_bytes
    rs = np.random.RandomState(0)
    A = sp.random(60, 40, density=0.2, random_state=rs, format="csc",
                  dtype=np.float32)
    A.data[:] = np.round(A.data * 9) + 1
    return compress_to_spz_bytes(A, value_type="uint8"), A


def test_truncated_buffers_raise():
    from rcppml_tpu.io.spz import decompress_spz_bytes, spz_info_bytes
    buf, A = _small_spz_bytes()
    # cuts into header / chunk index / payload must raise cleanly
    for cut in [0, 4, 64, 127, 128, 200, len(buf) // 2]:
        with pytest.raises(Exception):
            decompress_spz_bytes(buf[:cut])
    # cutting only footer slack may legitimately still decode — but then it
    # must decode EXACTLY (never garbage from out-of-bounds reads)
    try:
        out = decompress_spz_bytes(buf[:len(buf) - 20])
        assert (abs(out - A)).max() == 0
    except Exception:
        pass
    with pytest.raises(Exception):
        spz_info_bytes(buf[:64])


def test_corrupt_header_fields_do_not_crash():
    """Inflate nnz / offsets / chunk counts in the header: decode must error
    or produce output, never write past the caller's buffers (would
    segfault / corrupt the heap here)."""
    from rcppml_tpu.io.spz import decompress_spz_bytes
    buf, A = _small_spz_bytes()
    offsets = {
        "nnz": 16, "chunk_count": 32, "chunk_index_offset": 48,
        "data_offset": 64, "transpose_offset": 72,
    }
    for name, off in offsets.items():
        for val in [0, 1, 2**31 - 1, 2**62]:
            bad = bytearray(buf)
            width = 8 if name in ("nnz", "chunk_index_offset",
                                  "data_offset", "transpose_offset") else 4
            bad[off:off + width] = int(val % 2**(8 * width)).to_bytes(
                width, "little")
            try:
                decompress_spz_bytes(bytes(bad))
            except Exception:
                pass        # clean error is the expected outcome


def test_random_byteflip_fuzz():
    """200 random single/multi-byte corruptions: decode either succeeds or
    raises — the process must survive all of them."""
    from rcppml_tpu.io.spz import decompress_spz_bytes
    buf, _ = _small_spz_bytes()
    rs = np.random.RandomState(99)
    for _ in range(200):
        bad = bytearray(buf)
        for _ in range(rs.randint(1, 8)):
            bad[rs.randint(len(bad))] = rs.randint(256)
        try:
            out = decompress_spz_bytes(bytes(bad))
            assert out.shape[0] <= 2**31
        except Exception:
            pass


def test_corrupt_chunk_descriptor_rejected():
    """Chunk descriptor nnz/col fields inflated beyond the header sizes must
    be rejected (they size the caller-allocated CSC arrays)."""
    from rcppml_tpu.io.spz import decompress_spz_bytes
    buf, _ = _small_spz_bytes()
    desc_base = 128                       # first chunk descriptor
    for field_off, val in [(8, 10**6),    # nnz
                           (0, 2**31),    # col_start
                           (4, 2**31)]:   # num_cols
        bad = bytearray(buf)
        bad[desc_base + field_off:desc_base + field_off + 4] = \
            int(val).to_bytes(4, "little")
        with pytest.raises(Exception):
            decompress_spz_bytes(bytes(bad))


def test_stale_so_rebuilds(tmp_path):
    """Touching streampress.cpp newer than the .so triggers a rebuild at
    next load (advisor: stale committed binary hazard)."""
    import rcppml_tpu.io.spz as spz
    import importlib, os, time
    so = spz._LIB_PATH
    src = os.path.join(spz._NATIVE_DIR, "streampress.cpp")
    assert os.path.exists(so)
    os.utime(src, (time.time() + 2, time.time() + 2))
    old_so_mtime = os.path.getmtime(so)
    spz._lib = None
    spz._load_lib()
    assert os.path.getmtime(so) >= old_so_mtime   # rebuilt
    os.utime(src)                                  # restore sane mtime


def test_decode_mt_matches_single_thread():
    """Chunk-parallel native decode is bit-identical to the serial path
    for every thread count, including more threads than chunks."""
    import ctypes
    from rcppml_tpu.io.spz import _load_lib, compress_to_spz_bytes
    rs = np.random.RandomState(5)
    A = sp.random(300, 900, density=0.1, random_state=rs,
                  format="csc").astype(np.float32)
    buf = bytes(compress_to_spz_bytes(A, chunk_cols=128))
    lib = _load_lib()
    m, n, nnz = A.shape[0], A.shape[1], A.nnz

    def decode(threads):
        p = np.zeros(n + 1, np.int64)
        i = np.zeros(nnz, np.int32)
        x = np.zeros(nnz, np.float32)
        rc = lib.spz_decode_mt(
            buf, len(buf), 0,
            p.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            i.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), threads)
        assert rc == 0
        return p, i, x

    p1, i1, x1 = decode(1)
    B = sp.csc_matrix((x1, i1, p1), shape=(m, n))
    assert (B != A).nnz == 0
    for t in (2, 4, 32):
        p, i, x = decode(t)
        np.testing.assert_array_equal(p, p1)
        np.testing.assert_array_equal(i, i1)
        np.testing.assert_array_equal(x, x1)


def test_decode_mt_corrupt_input_errors():
    """A corrupt buffer must error cleanly from worker threads too."""
    import ctypes
    from rcppml_tpu.io.spz import _load_lib, compress_to_spz_bytes
    rs = np.random.RandomState(6)
    A = sp.random(100, 400, density=0.1, random_state=rs,
                  format="csc").astype(np.float32)
    raw = bytearray(compress_to_spz_bytes(A, chunk_cols=64))
    raw[len(raw) // 2] ^= 0xFF          # flip a payload byte
    lib = _load_lib()
    n, nnz = A.shape[1], A.nnz
    p = np.zeros(n + 1, np.int64)
    i = np.zeros(nnz, np.int32)
    x = np.zeros(nnz, np.float32)
    rc = lib.spz_decode_mt(
        bytes(raw), len(raw), 0,
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        i.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), 4)
    # either a clean decode error or (if the flip landed in padding) a
    # successful decode — never a crash; mismatched output is acceptable
    assert rc in (0, -1)
