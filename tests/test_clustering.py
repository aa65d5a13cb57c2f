"""Clustering tests (reference: test_bipartition.R, test_dclust_expanded.R,
test_consensus.R)."""

import numpy as np
import pytest

from rcppml_tpu.models.clustering import (align_factors, bipartite_match,
                                          bipartition, consensus_nmf, dclust)

pytestmark = pytest.mark.numerics  # numerics-critical subset


def _two_blob_matrix(seed=0, m=30, n1=40, n2=50):
    rs = np.random.RandomState(seed)
    c1 = rs.rand(m) * 2
    c2 = rs.rand(m) * 2 + np.r_[np.ones(m // 2) * 3, np.zeros(m - m // 2)]
    A1 = np.abs(c1[:, None] + 0.1 * rs.randn(m, n1))
    A2 = np.abs(c2[:, None] + 0.1 * rs.randn(m, n2))
    return np.hstack([A1, A2]).astype(np.float32), n1, n2


def test_bipartition_separates_blobs():
    A, n1, n2 = _two_blob_matrix()
    bp = bipartition(A, seed=42)
    assert bp.size1 + bp.size2 == n1 + n2
    # one side should be (nearly) exactly the first blob
    s1 = set(bp.samples1.tolist())
    blob1 = set(range(n1))
    overlap = max(len(s1 & blob1), len(set(bp.samples2.tolist()) & blob1))
    assert overlap >= n1 - 2


def test_bipartition_deterministic():
    A, _, _ = _two_blob_matrix()
    b1 = bipartition(A, seed=7)
    b2 = bipartition(A, seed=7)
    np.testing.assert_array_equal(b1.samples1, b2.samples1)


def test_bipartition_dist():
    A, _, _ = _two_blob_matrix()
    bp = bipartition(A, seed=1, calc_dist=True)
    assert -1.0 <= bp.dist <= 1.0


def test_dclust_ids_and_coverage():
    A, n1, n2 = _two_blob_matrix(m=20, n1=30, n2=36)
    clusters = dclust(A, min_samples=5, seed=3)
    all_samples = np.concatenate([c.samples for c in clusters])
    assert sorted(all_samples.tolist()) == list(range(n1 + n2))
    for c in clusters:
        assert set(c.id) <= {"0", "1"}
        assert c.size == len(c.samples)
    assert len(clusters) >= 2


def test_dclust_min_samples_respected():
    A, _, _ = _two_blob_matrix()
    clusters = dclust(A, min_samples=12, seed=3)
    for c in clusters:
        assert c.size >= 12


def test_hungarian_identity():
    cost = 1.0 - np.eye(4)
    m = bipartite_match(cost)
    np.testing.assert_array_equal(m["pairs"][:, 0], m["pairs"][:, 1])
    assert m["cost"] == 0


def test_align_factors_permutation():
    rs = np.random.RandomState(0)
    W = np.abs(rs.rand(40, 5))
    perm = [3, 1, 4, 0, 2]
    W2 = W[:, perm]
    found, cos = align_factors(W, W2)
    np.testing.assert_array_equal(W2[:, found], W)
    assert (cos > 0.999).all()


def test_consensus_nmf():
    A, _, _ = _two_blob_matrix(m=25, n1=20, n2=24)
    out = consensus_nmf(A, 2, n_runs=3, seed=5, maxit=30)
    C = out["consensus"]
    assert C.shape == (44, 44)
    assert np.allclose(np.diag(C), 1.0)
    assert 0.0 <= out["cophenetic"] <= 1.0


def test_consensus_knn_jaccard():
    A, _, _ = _two_blob_matrix(m=20, n1=16, n2=18)
    out = consensus_nmf(A, 2, n_runs=2, seed=5, maxit=20,
                        method="knn_jaccard")
    C = out["consensus"]
    assert C.shape == (34, 34)
    assert (C >= 0).all() and (C <= 1.0 + 1e-9).all()


def test_bipartition_device_resident_matches_host():
    """The device-resident fast path (single fused dispatch + on-device
    rel-cosine) reproduces the host-path split exactly."""
    import jax.numpy as jnp
    rs = np.random.RandomState(3)
    A = np.abs(rs.rand(50, 80)).astype(np.float32)
    A[:25, :40] *= 4.0                      # plant a 2-block structure
    host = bipartition(A, seed=7)
    dev = bipartition(jnp.asarray(A), seed=7)
    np.testing.assert_array_equal(host.samples1, dev.samples1)
    np.testing.assert_array_equal(host.samples2, dev.samples2)
    np.testing.assert_allclose(host.v, dev.v, rtol=1e-5, atol=1e-6)
    assert dev.dist == pytest.approx(host.dist, rel=1e-4)
    np.testing.assert_allclose(dev.center1, host.center1, rtol=1e-4,
                               atol=1e-5)


def test_dclust_structure_and_nonoverlap():
    """Cluster IDs unique, indices partition the samples, centers have
    feature length (test_dclust_expanded.R:13-135)."""
    from rcppml_tpu.utils.simulate import simulate_nmf
    A = simulate_nmf(m=30, n=120, k=4, noise=0.02, seed=9)["A"]
    out = dclust(A, min_samples=20, seed=1)
    all_idx = np.concatenate([c.samples for c in out])
    assert sorted(all_idx) == list(range(120))
    ids = [c.id for c in out]
    assert len(set(ids)) == len(ids)
    for c in out:
        assert len(c.center) == 30
        assert len(c.samples) >= 1


def test_dclust_min_dist_controls_resolution():
    # test_dclust_expanded.R:47-61 — larger min_dist -> fewer clusters
    from rcppml_tpu.utils.simulate import simulate_nmf
    A = simulate_nmf(m=30, n=150, k=5, noise=0.05, seed=3)["A"]
    lo = dclust(A, min_samples=10, min_dist=0.0, seed=1)
    hi = dclust(A, min_samples=10, min_dist=0.5, seed=1)
    assert len(hi) <= len(lo)


def test_dclust_ground_truth_recovery():
    # test_dclust_expanded.R:136+ — separable blocks are recovered
    rs = np.random.RandomState(4)
    blocks = []
    for b in range(3):
        B = np.full((20, 40), 0.05)
        B[b * 6:(b + 1) * 6, :] = 5.0 + rs.rand(6, 40)
        blocks.append(B)
    A = np.concatenate(blocks, axis=1)
    out = dclust(A, min_samples=25, seed=1)
    assert len(out) == 3
    for c in out:
        cols = np.asarray(c.samples) // 40
        assert len(set(cols.tolist())) == 1     # no mixing across blocks


def test_align_methods_and_errors():
    """align(method='cosine'/'cor'), dim mismatch, identity
    (test_align.R:7-111)."""
    import rcppml_tpu as rt
    from rcppml_tpu.utils.simulate import simulate_nmf
    A = simulate_nmf(m=40, n=50, k=4, noise=0.02, seed=11)["A"]
    r1 = rt.nmf(A, 4, maxit=100, tol=1e-7, seed=1)
    r2 = rt.nmf(A, 4, maxit=100, tol=1e-7, seed=77)

    def diag_cos(a, b):
        wa = np.asarray(a.W) / np.maximum(
            np.linalg.norm(np.asarray(a.W), axis=0), 1e-15)
        wb = np.asarray(b.W) / np.maximum(
            np.linalg.norm(np.asarray(b.W), axis=0), 1e-15)
        return float(np.mean(np.sum(wa * wb, axis=0)))

    before = diag_cos(r2, r1)
    for method in ("cosine", "cor"):
        aligned = r2.align_to(r1, method=method)
        assert diag_cos(aligned, r1) >= before - 1e-9
        # alignment is a permutation: reconstruction unchanged
        np.testing.assert_allclose(aligned.reconstruct(),
                                   r2.reconstruct(), rtol=1e-6)
    ident = r1.align_to(r1)
    np.testing.assert_array_equal(np.asarray(ident.W), np.asarray(r1.W))
    r3 = rt.nmf(A[:20], 4, maxit=5, seed=1)
    with pytest.raises(ValueError, match="identical"):
        r3.align_to(r1)
    with pytest.raises(ValueError, match="method"):
        r2.align_to(r1, method="bogus")
