"""Ground-truth factor recovery — mirrors test_ground_truth_recovery.R.

Planted W/H factors must be recovered (after Hungarian alignment on
cosine distance) at known noise levels, across ranks, through sparse
inputs, with mask='zeros' dropout, and with regularization.
"""
import numpy as np
import pytest
import scipy.sparse as sp

pytestmark = pytest.mark.numerics  # numerics-critical subset

import rcppml_tpu as rt
from rcppml_tpu.models.clustering import align_factors
from rcppml_tpu.utils.simulate import simulate_nmf


def _recon(res):
    return np.asarray(res.W) @ np.diag(np.asarray(res.d)) @ np.asarray(res.H)


def _mean_cor(res, W_true, H_true):
    """Mean aligned column-cosine of W plus row-cosine of H
    (helper-test-utils.R align_nmf_factors semantics)."""
    perm, cos_w = align_factors(W_true, np.asarray(res.W))
    hn = np.asarray(res.H) / np.maximum(
        np.linalg.norm(np.asarray(res.H), axis=1, keepdims=True), 1e-15)
    tn = H_true / np.maximum(
        np.linalg.norm(H_true, axis=1, keepdims=True), 1e-15)
    cos_h = np.sum(tn * hn[perm], axis=1)
    return float(np.mean(cos_w)), float(np.mean(cos_h))


def test_perfect_recovery_no_noise():
    # test_ground_truth_recovery.R:48-80 — best of 5 seeds, cor > 0.9
    sim = simulate_nmf(40, 30, 3, noise=0.0, dropout=0.0, seed=123)
    best = -1.0
    best_rel = np.inf
    for s in (456, 789, 101, 202, 303):
        res = rt.nmf(sim["A"], 3, maxit=500, tol=1e-8, seed=s)
        cw, ch = _mean_cor(res, sim["W"], sim["H"])
        if (cw + ch) / 2 > best:
            best = (cw + ch) / 2
            best_rel = (np.linalg.norm(sim["A"] - _recon(res)) /
                        np.linalg.norm(sim["A"]))
    assert best > 0.90
    assert best_rel < 0.05


def test_recovery_low_noise():
    # test_ground_truth_recovery.R:82-109
    sim = simulate_nmf(60, 50, 4, noise=0.2, dropout=0.1, seed=123)
    best = max(
        np.mean(_mean_cor(rt.nmf(sim["A"], 4, maxit=300, tol=1e-6, seed=s),
                          sim["W"], sim["H"]))
        for s in (456, 789, 101))
    assert best > 0.4


def test_recovery_degrades_with_noise():
    # test_ground_truth_recovery.R:111-135
    cors = []
    for nf in (0.1, 0.3, 0.6, 1.0):
        sim = simulate_nmf(60, 50, 4, noise=nf, dropout=0.2, seed=123)
        res = rt.nmf(sim["A"], 4, maxit=200, tol=1e-6, seed=456)
        cors.append(np.mean(_mean_cor(res, sim["W"], sim["H"])))
    assert cors[0] > cors[3] - 0.2
    assert cors[3] > 0.05


@pytest.mark.parametrize("k", [2, 4, 6])
def test_recovery_across_ranks(k):
    # test_ground_truth_recovery.R:137-160
    sim = simulate_nmf(60, 50, k, noise=0.05, dropout=0.0, seed=7)
    res = rt.nmf(sim["A"], k, maxit=300, tol=1e-7, seed=456)
    cw, ch = _mean_cor(res, sim["W"], sim["H"])
    assert (cw + ch) / 2 > 0.5


def test_recovery_sparse_input():
    # test_ground_truth_recovery.R:162-183
    sim = simulate_nmf(60, 50, 3, noise=0.05, dropout=0.3, seed=11)
    res_d = rt.nmf(sim["A"], 3, maxit=200, tol=1e-6, seed=456)
    res_s = rt.nmf(sp.csc_matrix(sim["A"]), 3, maxit=200, tol=1e-6,
                   seed=456)
    np.testing.assert_allclose(np.asarray(res_d.W), np.asarray(res_s.W),
                               rtol=1e-5, atol=1e-6)


def test_recovery_mask_zeros_dropout():
    # test_ground_truth_recovery.R:185-206 — heavy dropout: masking the
    # zeros recovers the truth better than treating them as data
    sim = simulate_nmf(80, 60, 3, noise=0.02, dropout=0.5, seed=13)
    masked = rt.nmf(sim["A"], 3, mask="zeros", maxit=300, tol=1e-7,
                    seed=456)
    plain = rt.nmf(sim["A"], 3, maxit=300, tol=1e-7, seed=456)
    cm = np.mean(_mean_cor(masked, sim["W"], sim["H"]))
    cp = np.mean(_mean_cor(plain, sim["W"], sim["H"]))
    assert cm > cp - 0.02       # masked at least as good (usually better)
    assert cm > 0.6


def test_recovery_with_regularization():
    # test_ground_truth_recovery.R:308-326
    sim = simulate_nmf(60, 50, 3, noise=0.05, dropout=0.0, seed=17)
    res = rt.nmf(sim["A"], 3, L1=0.01, L2=0.001, maxit=200, tol=1e-6,
                 seed=456)
    assert np.mean(_mean_cor(res, sim["W"], sim["H"])) > 0.5


def test_alignment_resolves_permutation():
    # test_ground_truth_recovery.R:328-353 — two seeds find the same
    # subspace up to factor order; align_to() lines the columns up
    sim = simulate_nmf(60, 50, 4, noise=0.02, dropout=0.0, seed=19)
    r1 = rt.nmf(sim["A"], 4, maxit=400, tol=1e-8, seed=1)
    r2 = rt.nmf(sim["A"], 4, maxit=400, tol=1e-8, seed=99)
    aligned = r2.align_to(r1)
    w1 = np.asarray(r1.W) / np.maximum(
        np.linalg.norm(np.asarray(r1.W), axis=0), 1e-15)
    w2 = np.asarray(aligned.W) / np.maximum(
        np.linalg.norm(np.asarray(aligned.W), axis=0), 1e-15)
    diag_cos = np.sum(w1 * w2, axis=0)
    assert np.mean(diag_cos) > 0.8


def test_recon_error_tracks_recovery():
    # test_ground_truth_recovery.R:278-306 — lower relative recon error
    # across noise levels goes with higher factor correlation
    rels, cors = [], []
    for nf in (0.05, 0.8):
        sim = simulate_nmf(60, 50, 3, noise=nf, dropout=0.0, seed=23)
        res = rt.nmf(sim["A"], 3, maxit=200, tol=1e-6, seed=456)
        rels.append(np.linalg.norm(sim["A"] - _recon(res)) /
                    np.linalg.norm(sim["A"]))
        cors.append(np.mean(_mean_cor(res, sim["W"], sim["H"])))
    assert rels[0] < rels[1]
    assert cors[0] > cors[1]
