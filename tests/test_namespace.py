"""Every reference NAMESPACE export (NAMESPACE:30-111) must resolve at
the package top level, so a reference user can ``import rcppml_tpu as
rt`` and find the whole surface under ``rt.``.
"""

import numpy as np
import pytest

import rcppml_tpu as rt

EXPORTS = """align assess auto_nmf_distribution bipartiteMatch bipartition
classify_embedding classify_logistic classify_rf compare_nmf compute_target
consensus_nmf cosine cross_validate_graph dclust diagnose_dispersion
diagnose_zero_inflation evaluate export_log factor_add factor_concat
factor_condition factor_config factor_input factor_net factor_shared fit
nmf nmf_layer nnls pca reconstruct refine score_test_distribution
simulateNMF simulateSwimmer sparsity st_add_transpose st_chunk_ranges
st_filter_cols st_filter_rows st_info st_map_chunks st_obs_indices st_read
st_read_dense st_read_obs st_read_var st_slice st_slice_cols st_slice_rows
st_write st_write_dense st_write_list svd svd_layer training_logger
variance_explained W H r_matrix r_sparsematrix r_sample r_unif
r_binom""".split()


@pytest.mark.parametrize("name", EXPORTS)
def test_namespace_export_resolves(name):
    assert callable(getattr(rt, name)) or name in ("W", "H")


def test_dir_lists_surface():
    d = dir(rt)
    for name in ("nmf", "svd", "st_read", "assess", "factor_net"):
        assert name in d


def test_generic_free_functions_delegate():
    rs = np.random.RandomState(0)
    A = np.abs(rs.rand(20, 15)).astype(np.float32)
    res = rt.nmf(A, 3, seed=1, maxit=10)
    np.testing.assert_array_equal(rt.reconstruct(res), res.reconstruct())
    assert rt.sparsity(res) == res.sparsity()


def test_top_level_graph_roundtrip():
    rs = np.random.RandomState(1)
    X = np.abs(rs.rand(25, 20)).astype(np.float32)
    inp = rt.factor_input(X, "X")
    layer = rt.nmf_layer(inp, 3, maxit=5, name="L1")
    net = rt.factor_net([inp], layer,
                        config=rt.GlobalConfig(maxit=5, seed=1))
    res = rt.fit(net)
    assert np.isfinite(float(res.total_loss)) or res["L1"].W is not None


def test_top_level_st_roundtrip(tmp_path):
    import scipy.sparse as sp
    rs = np.random.RandomState(2)
    A = sp.random(30, 20, density=0.2, random_state=rs, format="csc")
    A.data = np.abs(A.data)
    p = str(tmp_path / "x.spz")
    rt.st_write(A, p)
    B = rt.st_read(p)
    assert (B != A.astype(np.float32)).nnz == 0  # fp32 boundary cast
    info = rt.st_info(p)
    assert (info["m"], info["n"]) == (30, 20)


def test_gpu_compat_aliases_complete_the_namespace():
    """Every reference NAMESPACE export resolves under its literal name
    (JAX-backend analogs for the 4 GPU-specific ones) — a reference
    script's imports run unmodified."""
    import numpy as np
    import scipy.sparse as sp
    import rcppml_tpu as rt
    assert rt.gpu_available() in (True, False)
    info = rt.gpu_info()
    assert isinstance(info, dict)
    # st_read_gpu -> device-resident dense; st_free_gpu releases it
    import tempfile, os
    A = sp.random(30, 20, density=0.2, random_state=0, format="csc").astype(
        np.float32)
    with tempfile.TemporaryDirectory() as td:
        p = os.path.join(td, "x.spz")
        rt.st_write(A, p)
        dev = rt.st_read_gpu(p)
        np.testing.assert_allclose(np.asarray(dev), A.toarray(), atol=1e-6)
        rt.st_free_gpu(dev)
        rt.st_free_gpu(dev)                     # double-free is a no-op
        rt.st_free_gpu(np.zeros(3))             # non-device input too
