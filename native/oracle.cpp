// reference-execution oracle — plain C++/OpenMP port of the REFERENCE CPU
// hot loop, compiled on this host so parity can be asserted against output
// actually produced by reference semantics.
//
// This is NOT part of the framework's compute path.  It exists to
//   (a) emit golden W/d/H fixtures (tests/test_golden_oracle.py),
//   (b) measure the reference's CPU ALS/CV throughput on THIS host so the
//       gate-2 anchor is a measurement, not a FLOP model,
//   (c) run the reference's exponential+golden auto-rank search so the
//       k='auto' decision can be checked for equivalence (gate 5).
//
// Semantics ported from (file:line cites into /root/reference):
//   rng/rng.hpp:73-201            SplitMix64 seq fill + position hash
//   nmf/nmf_init.hpp:167-182      initialize_factors (W_T then H, one engine)
//   primitives/cpu/gram.hpp:36-52       G = F F^T + 1e-15 I
//   primitives/cpu/rhs.hpp:51-133       B = H*A (dense GEMM / CSC gather)
//   primitives/cpu/nnls_batch.hpp:71-225  cd_nnls_col_fixed + batch warm start
//   features/sparsity.hpp:41-48         L2 -> G diag, L1 -> B -= L1
//   nmf/variant_helpers.hpp:287-305     extract_scaling (L1 row norms)
//   primitives/primitives.hpp:126-136   gram_trick_loss
//   nmf/fit_cpu.hpp:171-1860            standard ALS loop, tol+patience
//   nmf/cv_detail.hpp:67-85,303-399     CV gram correction + train RHS
//   nmf/speckled_cv.hpp:118-157         LazySpeckledMask (uint32 seed, 0->12345)
//   nmf/fit_cv.hpp:104-1667             CV loop, test/train loss, best_iter
//   nmf/rank_cv.hpp:66-240              evaluate_rank_with_cv + exp + golden
//
// Everything below is an independent re-expression of those semantics in
// flat-array C++ (no Eigen): the numbers must match, the code does not.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>
#include <limits>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

using std::size_t;

// ---------------------------------------------------------------------------
// SplitMix64 (rng/rng.hpp) — sequential stream + pure position hash
// ---------------------------------------------------------------------------

constexpr uint64_t GOLDEN = 0x9e3779b97f4a7c15ULL;
constexpr uint64_t COLMIX = 0x6c62272e07bb0142ULL;

inline uint64_t mix64(uint64_t z) {
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
}

struct SeqRng {
    uint64_t state;
    explicit SeqRng(uint64_t seed) : state(seed == 0 ? 12345ULL : seed) {}
    uint64_t next() { state += GOLDEN; return mix64(state); }
    double uniform() {
        return static_cast<double>(next())
             / static_cast<double>(UINT64_MAX);
    }
    // column-major fill, col 0 top-to-bottom first (rng.hpp:195-201)
    template <typename S>
    void fill(S* data, int rows, int cols) {
        for (int j = 0; j < cols; ++j)
            for (int i = 0; i < rows; ++i)
                data[static_cast<size_t>(j) * rows + i] =
                    static_cast<S>(uniform());
    }
};

inline uint64_t pos_hash(uint64_t seed, uint32_t i, uint32_t j) {
    return mix64(seed + static_cast<uint64_t>(i) * GOLDEN
                      + static_cast<uint64_t>(j) * COLMIX);
}

// speckled_cv.hpp:118-157: seed is uint32-truncated, 0 -> 12345
struct Speckle {
    uint64_t seed;
    uint64_t inv_prob;   // 0 = no holdout
    Speckle(uint64_t s, double holdout_fraction)
        : seed(static_cast<uint32_t>(s) == 0
                   ? 12345ULL : static_cast<uint32_t>(s)),
          inv_prob(holdout_fraction > 0
                       ? static_cast<uint64_t>(1.0 / holdout_fraction) : 0) {}
    bool held(int i, int j) const {
        if (inv_prob == 0) return false;
        return pos_hash(seed, static_cast<uint32_t>(i),
                        static_cast<uint32_t>(j)) < UINT64_MAX / inv_prob;
    }
};

// ---------------------------------------------------------------------------
// Data view: dense col-major OR CSC sparse (both m x n)
// ---------------------------------------------------------------------------

struct DataView {
    int m = 0, n = 0;
    const double* dense = nullptr;        // col-major m*n, or null
    const int64_t* p = nullptr;           // CSC col ptrs (n+1), or null
    const int32_t* idx = nullptr;         // CSC row indices
    const double* val = nullptr;          // CSC values
    bool sparse() const { return p != nullptr; }
    int64_t nnz() const {
        if (sparse()) return p[n];
        int64_t c = 0;
        for (int64_t t = 0; t < static_cast<int64_t>(m) * n; ++t)
            if (dense[t] != 0.0) ++c;
        return c;
    }
};

// CSC transpose (for W-update gather, fit_cpu.hpp:234-254)
struct Csc {
    std::vector<int64_t> p;
    std::vector<int32_t> idx;
    std::vector<double> val;
};

Csc transpose_csc(const DataView& A) {
    Csc T;
    const int64_t nnz = A.p[A.n];
    T.p.assign(static_cast<size_t>(A.m) + 1, 0);
    T.idx.resize(static_cast<size_t>(nnz));
    T.val.resize(static_cast<size_t>(nnz));
    for (int64_t t = 0; t < nnz; ++t) T.p[A.idx[t] + 1]++;
    for (int i = 0; i < A.m; ++i) T.p[i + 1] += T.p[i];
    std::vector<int64_t> cursor(T.p.begin(), T.p.end() - 1);
    for (int j = 0; j < A.n; ++j)
        for (int64_t t = A.p[j]; t < A.p[j + 1]; ++t) {
            int64_t dst = cursor[A.idx[t]]++;
            T.idx[static_cast<size_t>(dst)] = j;
            T.val[static_cast<size_t>(dst)] = A.val[t];
        }
    return T;
}

// ---------------------------------------------------------------------------
// Primitives
// ---------------------------------------------------------------------------

constexpr double TINY = 1e-15;   // core/constants.hpp:42
constexpr double CD_ABS_TOL = 1e-15;

// G = F F^T + TINY*I, F is k x c col-major (gram.hpp:36-52)
void gram(const double* F, int k, int c, double* G) {
    std::fill(G, G + static_cast<size_t>(k) * k, 0.0);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int a = 0; a < k; ++a) {
        for (int b = a; b < k; ++b) {
            double s = 0;
            const double* Fa = F + a;
            const double* Fb = F + b;
            for (int t = 0; t < c; ++t)
                s += Fa[static_cast<size_t>(t) * k]
                   * Fb[static_cast<size_t>(t) * k];
            G[static_cast<size_t>(a) * k + b] = s;
            G[static_cast<size_t>(b) * k + a] = s;
        }
    }
    for (int a = 0; a < k; ++a) G[static_cast<size_t>(a) * k + a] += TINY;
}

// B = F * A where F is k x m over A (m x n) -> B k x n (rhs.hpp:51-133)
void rhs_forward(const DataView& A, const double* F, int k, double* B,
                 int threads) {
    const int n = A.n;
    std::fill(B, B + static_cast<size_t>(k) * n, 0.0);
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 64) num_threads(threads)
#endif
    for (int j = 0; j < n; ++j) {
        double* bj = B + static_cast<size_t>(j) * k;
        if (A.sparse()) {
            for (int64_t t = A.p[j]; t < A.p[j + 1]; ++t) {
                const double v = A.val[t];
                const double* fc = F + static_cast<size_t>(A.idx[t]) * k;
                for (int a = 0; a < k; ++a) bj[a] += v * fc[a];
            }
        } else {
            const double* aj = A.dense + static_cast<size_t>(j) * A.m;
            for (int i = 0; i < A.m; ++i) {
                const double v = aj[i];
                if (v == 0.0) continue;
                const double* fc = F + static_cast<size_t>(i) * k;
                for (int a = 0; a < k; ++a) bj[a] += v * fc[a];
            }
        }
    }
}

// B = H * A^T -> k x m; sparse uses gather over CSC(A^T)
// (fit_cpu.hpp:120-144)
void rhs_transpose(const DataView& A, const Csc* At, const double* H, int k,
                   double* B, int threads) {
    const int m = A.m;
    std::fill(B, B + static_cast<size_t>(k) * m, 0.0);
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 64) num_threads(threads)
#endif
    for (int i = 0; i < m; ++i) {
        double* bi = B + static_cast<size_t>(i) * k;
        if (At) {
            for (int64_t t = At->p[i]; t < At->p[i + 1]; ++t) {
                const double v = At->val[static_cast<size_t>(t)];
                const double* hc =
                    H + static_cast<size_t>(At->idx[static_cast<size_t>(t)]) * k;
                for (int a = 0; a < k; ++a) bi[a] += v * hc[a];
            }
        } else {
            for (int j = 0; j < A.n; ++j) {
                const double v = A.dense[static_cast<size_t>(j) * m + i];
                if (v == 0.0) continue;
                const double* hc = H + static_cast<size_t>(j) * k;
                for (int a = 0; a < k; ++a) bi[a] += v * hc[a];
            }
        }
    }
}

// cd_nnls_col_fixed (nnls_batch.hpp:71-132), exact semantics
int cd_col(const double* G, double* __restrict__ b, double* __restrict__ x,
           int k, double L1, double L2, bool nonneg, int maxit,
           double cd_tol) {
    const bool check = (cd_tol > 0);
    const double inv_k = 1.0 / k;
    for (int it = 0; it < maxit; ++it) {
        double tol_sum = 0;
        for (int i = 0; i < k; ++i) {
            const double g_diag = G[static_cast<size_t>(i) * k + i];
            if (g_diag <= 0.0) continue;
            double diff = b[i] / g_diag;
            if (L1 != 0) diff -= L1;
            if (L2 != 0) diff += L2 * x[i];
            const double new_val = x[i] + diff;
            double actual;
            if (nonneg && new_val < 0.0) {
                actual = -x[i];
                if (actual == 0.0) continue;
                x[i] = 0.0;
            } else {
                if (diff == 0.0) continue;
                actual = diff;
                x[i] = new_val;
            }
            if (check)
                tol_sum += std::abs(actual) / (std::abs(x[i]) + CD_ABS_TOL);
            const double* gc = G + static_cast<size_t>(i) * k;
            for (int r = 0; r < k; ++r) b[r] -= gc[r] * actual;
        }
        if (check && tol_sum * inv_k < cd_tol) return it + 1;
    }
    return maxit;
}

// Cholesky LLT factor (lower) of a k x k SPD matrix, then solve + clip
// (primitives/cpu/cholesky_clip.hpp:65-106,129-170: Eigen::LLT, no pivoting)
bool llt_factor(const double* G, int k, double* L) {
    std::memcpy(L, G, sizeof(double) * static_cast<size_t>(k) * k);
    for (int j = 0; j < k; ++j) {
        double diag = L[static_cast<size_t>(j) * k + j];
        for (int r = 0; r < j; ++r) {
            const double v = L[static_cast<size_t>(r) * k + j];
            diag -= v * v;
        }
        if (diag <= 0.0) return false;
        diag = std::sqrt(diag);
        L[static_cast<size_t>(j) * k + j] = diag;
        for (int i = j + 1; i < k; ++i) {
            double s = L[static_cast<size_t>(j) * k + i];
            for (int r = 0; r < j; ++r)
                s -= L[static_cast<size_t>(r) * k + i]
                   * L[static_cast<size_t>(r) * k + j];
            L[static_cast<size_t>(j) * k + i] = s / diag;
        }
    }
    return true;
}

void llt_solve(const double* L, int k, const double* b, double* x) {
    // forward: L y = b
    for (int i = 0; i < k; ++i) {
        double s = b[i];
        for (int r = 0; r < i; ++r)
            s -= L[static_cast<size_t>(r) * k + i] * x[r];
        x[i] = s / L[static_cast<size_t>(i) * k + i];
    }
    // backward: L^T x = y
    for (int i = k - 1; i >= 0; --i) {
        double s = x[i];
        for (int r = i + 1; r < k; ++r)
            s -= L[static_cast<size_t>(i) * k + r] * x[r];
        x[i] = s / L[static_cast<size_t>(i) * k + i];
    }
}

// cholesky_clip_col (cholesky_clip.hpp:65-106): L1 on b, LLT solve, clip.
// Used per-column in the CV path (G_local differs per column).
void cholesky_clip_col(const double* G, double* b, double* x, int k,
                       double L1, bool nonneg) {
    if (L1 > 0)
        for (int a = 0; a < k; ++a) b[a] -= L1;
    std::vector<double> L(static_cast<size_t>(k) * k);
    if (!llt_factor(G, k, L.data())) return;
    llt_solve(L.data(), k, b, x);
    if (nonneg)
        for (int a = 0; a < k; ++a)
            if (x[a] < 0.0) x[a] = 0.0;
}

// cholesky_clip_batch (cholesky_clip.hpp:129-170): fresh solve, clip >= 0
void cholesky_clip_batch(const double* G, const double* B, double* X, int k,
                         int ncol, bool nonneg, int threads) {
    std::vector<double> L(static_cast<size_t>(k) * k);
    if (!llt_factor(G, k, L.data())) return;  // leave X as-is on failure
#ifdef _OPENMP
#pragma omp parallel for schedule(static) num_threads(threads)
#endif
    for (int j = 0; j < ncol; ++j) {
        llt_solve(L.data(), k, B + static_cast<size_t>(j) * k,
                  X + static_cast<size_t>(j) * k);
        if (nonneg)
            for (int a = 0; a < k; ++a) {
                double& v = X[static_cast<size_t>(j) * k + a];
                if (v < 0.0) v = 0.0;
            }
    }
}

// nnls_batch: warm start B -= G*X, then per-column CD
// (nnls_batch.hpp:150-185)
void nnls_batch(const double* G, double* B, double* X, int k, int ncol,
                int cd_maxit, double cd_tol, bool nonneg, bool warm,
                int threads) {
    if (warm) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static) num_threads(threads)
#endif
        for (int j = 0; j < ncol; ++j) {
            double* bj = B + static_cast<size_t>(j) * k;
            const double* xj = X + static_cast<size_t>(j) * k;
            for (int a = 0; a < k; ++a) {
                const double xv = xj[a];
                if (xv == 0.0) continue;
                const double* gc = G + static_cast<size_t>(a) * k;
                for (int r = 0; r < k; ++r) bj[r] -= gc[r] * xv;
            }
        }
    } else {
        std::fill(X, X + static_cast<size_t>(k) * ncol, 0.0);
    }
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic) num_threads(threads)
#endif
    for (int j = 0; j < ncol; ++j)
        cd_col(G, B + static_cast<size_t>(j) * k,
               X + static_cast<size_t>(j) * k, k, 0.0, 0.0, nonneg,
               cd_maxit, cd_tol);
}

// extract_scaling with L1 row norms (variant_helpers.hpp:287-305)
// norm_type: 0=None, 1=L1, 2=L2
void extract_scaling(double* F, int k, int c, double* d, int norm_type) {
    if (norm_type == 0) {
        for (int a = 0; a < k; ++a) d[a] = 1.0;
        return;
    }
    for (int a = 0; a < k; ++a) {
        double s = 0;
        for (int t = 0; t < c; ++t) {
            const double v = F[static_cast<size_t>(t) * k + a];
            s += (norm_type == 1) ? std::abs(v) : v * v;
        }
        if (norm_type == 2) s = std::sqrt(s);
        d[a] = s + 1e-15;
    }
    for (int t = 0; t < c; ++t)
        for (int a = 0; a < k; ++a)
            F[static_cast<size_t>(t) * k + a] /= d[a];
}

double trace_AtA(const DataView& A) {
    double s = 0;
    if (A.sparse()) {
        const int64_t nnz = A.p[A.n];
        for (int64_t t = 0; t < nnz; ++t) s += A.val[t] * A.val[t];
    } else {
        const int64_t tot = static_cast<int64_t>(A.m) * A.n;
        for (int64_t t = 0; t < tot; ++t) s += A.dense[t] * A.dense[t];
    }
    return s;
}

// gram_trick_loss (primitives.hpp:126-136)
double gram_trick_loss(double trAtA, const double* G, const double* B,
                       const double* H, int k, int n) {
    double trBtH = 0, trGHHt = 0;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) reduction(+:trBtH, trGHHt)
#endif
    for (int j = 0; j < n; ++j) {
        const double* hj = H + static_cast<size_t>(j) * k;
        const double* bj = B + static_cast<size_t>(j) * k;
        for (int a = 0; a < k; ++a) {
            trBtH += bj[a] * hj[a];
            double gh = 0;
            for (int r = 0; r < k; ++r)
                gh += G[static_cast<size_t>(r) * k + a] * hj[r];
            trGHHt += hj[a] * gh;
        }
    }
    return std::max(trAtA - 2.0 * trBtH + trGHHt, 0.0);
}

// ---------------------------------------------------------------------------
// Standard ALS fit (fit_cpu.hpp nmf_fit, standard path, MSE, no mask)
// ---------------------------------------------------------------------------

struct FitOut {
    std::vector<double> W_T, H, d, loss_hist;
    int iterations = 0;
    bool converged = false;
    double train_loss = 0;
};

FitOut nmf_fit(const DataView& A, int k, uint32_t seed, int max_iter,
               double tol, int patience, int solver_mode, int cd_maxit,
               double cd_tol, double L1_w, double L1_h, double L2_w,
               double L2_h, int norm_type, int threads) {
    const int m = A.m, n = A.n;
    FitOut out;
    out.W_T.resize(static_cast<size_t>(k) * m);
    out.H.resize(static_cast<size_t>(k) * n);
    out.d.assign(static_cast<size_t>(k), 1.0);

    // initialize_factors (nmf_init.hpp:167-182): one engine, W_T then H
    SeqRng rng(seed);
    rng.fill(out.W_T.data(), k, m);
    rng.fill(out.H.data(), k, n);

    const double trA = trace_AtA(A);
    Csc At_store;
    const Csc* At = nullptr;
    if (A.sparse()) { At_store = transpose_csc(A); At = &At_store; }

    std::vector<double> G(static_cast<size_t>(k) * k);
    std::vector<double> B(static_cast<size_t>(k) * std::max(m, n));
    std::vector<double> W_Td(static_cast<size_t>(k) * m);
    std::vector<double> G_loss(static_cast<size_t>(k) * k);
    std::vector<double> B_loss(static_cast<size_t>(k) * n);

    double prev_loss = std::numeric_limits<double>::max();
    int patience_counter = 0;

    for (int iter = 0; iter < max_iter; ++iter) {
        // ---- H update (fit_cpu.hpp:481-645, standard path) ----
        gram(out.W_T.data(), k, m, G.data());
        rhs_forward(A, out.W_T.data(), k, B.data(), threads);
        // features (sparsity.hpp:41-48): L2 -> diag, L1 -> B -= L1
        if (L2_h > 0)
            for (int a = 0; a < k; ++a) G[static_cast<size_t>(a) * k + a] += L2_h;
        if (L1_h > 0)
            for (int64_t t = 0; t < static_cast<int64_t>(k) * n; ++t)
                B[static_cast<size_t>(t)] -= L1_h;
        if (solver_mode == 1)
            cholesky_clip_batch(G.data(), B.data(), out.H.data(), k, n,
                                true, threads);
        else
            nnls_batch(G.data(), B.data(), out.H.data(), k, n, cd_maxit,
                       cd_tol, true, iter > 0, threads);
        extract_scaling(out.H.data(), k, n, out.d.data(), norm_type);

        // ---- W update (fit_cpu.hpp:706-894) ----
        gram(out.H.data(), k, n, G.data());
        rhs_transpose(A, At, out.H.data(), k, B.data(), threads);
        if (L2_w > 0)
            for (int a = 0; a < k; ++a) G[static_cast<size_t>(a) * k + a] += L2_w;
        if (L1_w > 0)
            for (int64_t t = 0; t < static_cast<int64_t>(k) * m; ++t)
                B[static_cast<size_t>(t)] -= L1_w;
        if (solver_mode == 1)
            cholesky_clip_batch(G.data(), B.data(), out.W_T.data(), k, m,
                                true, threads);
        else
            nnls_batch(G.data(), B.data(), out.W_T.data(), k, m, cd_maxit,
                       cd_tol, true, iter > 0, threads);
        extract_scaling(out.W_T.data(), k, m, out.d.data(), norm_type);

        // ---- loss: MSE fallback recompute (fit_cpu.hpp:1755-1764) ----
        for (int t = 0; t < m; ++t)
            for (int a = 0; a < k; ++a)
                W_Td[static_cast<size_t>(t) * k + a] =
                    out.W_T[static_cast<size_t>(t) * k + a] * out.d[a];
        gram(W_Td.data(), k, m, G_loss.data());
        rhs_forward(A, W_Td.data(), k, B_loss.data(), threads);
        const double loss_val =
            gram_trick_loss(trA, G_loss.data(), B_loss.data(),
                            out.H.data(), k, n);
        out.loss_hist.push_back(loss_val);

        bool loss_converged = false;
        if (iter > 0) {
            const double rel = std::abs(prev_loss - loss_val)
                             / (std::abs(prev_loss) + 1e-15);
            if (rel < tol) loss_converged = true;
        }
        prev_loss = loss_val;

        out.iterations = iter + 1;
        if (iter > 0) {
            if (loss_converged) {
                if (++patience_counter >= patience) {
                    out.converged = true;
                    break;
                }
            } else {
                patience_counter = 0;
            }
        }
    }
    out.train_loss = prev_loss;
    return out;
}

// ---------------------------------------------------------------------------
// CV fit (fit_cv.hpp, MSE path, no user mask, mask_zeros=false default)
// ---------------------------------------------------------------------------

struct CvOut {
    std::vector<double> W_T, H, d;          // H returned UNSCALED by d here
    std::vector<double> train_hist, test_hist;
    int iterations = 0, best_iter = 0;
    double train_loss = 0, test_loss = 0, best_test_loss = 0;
};

CvOut nmf_fit_cv(const DataView& A, int k, uint32_t seed, uint32_t cv_seed,
                 double holdout_fraction, bool mask_zeros, int max_iter,
                 double tol, int cv_patience, int solver_mode, int cd_maxit,
                 double L1_w, double L1_h, int norm_type, int threads) {
    const int m = A.m, n = A.n;
    CvOut out;
    out.W_T.resize(static_cast<size_t>(k) * m);
    out.H.resize(static_cast<size_t>(k) * n);
    out.d.assign(static_cast<size_t>(k), 1.0);
    SeqRng rng(seed);
    rng.fill(out.W_T.data(), k, m);
    rng.fill(out.H.data(), k, n);

    // effective_cv_seed (config.hpp:416-418)
    const Speckle mask(cv_seed != 0 ? cv_seed : seed, holdout_fraction);

    const double trA = trace_AtA(A);
    const int64_t nnz = A.nnz();
    Csc At_store;
    const Csc* At = nullptr;
    if (A.sparse()) { At_store = transpose_csc(A); At = &At_store; }

    std::vector<double> G(static_cast<size_t>(k) * k);
    std::vector<double> G_H_saved(static_cast<size_t>(k) * k);
    std::vector<double> B_W_full(static_cast<size_t>(k) * m);
    std::vector<double> G_W_new(static_cast<size_t>(k) * k);
    std::vector<double> W_Td(static_cast<size_t>(k) * m);

    double prev_conv_loss = std::numeric_limits<double>::max();
    double best_test = std::numeric_limits<double>::max();
    int best_iter = 0, patience_count = 0;

    for (int iter = 0; iter < max_iter; ++iter) {
        // ==== H update: per-column gram correction (fit_cv.hpp:410-540) ====
        gram(out.W_T.data(), k, m, G.data());
        for (int a = 0; a < k; ++a)
            G[static_cast<size_t>(a) * k + a] += 1e-15;  // fit_cv.hpp:414

#ifdef _OPENMP
#pragma omp parallel num_threads(threads)
#endif
        {
            std::vector<double> b(static_cast<size_t>(k));
            std::vector<double> Gl(static_cast<size_t>(k) * k);
            std::vector<int> test_rows;
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 64)
#endif
            for (int j = 0; j < n; ++j) {
                // compute_train_rhs (cv_detail.hpp:303-347), mask_zeros=false:
                // every (i, j) is checked; zeros may be held out too
                std::fill(b.begin(), b.end(), 0.0);
                test_rows.clear();
                if (A.sparse()) {
                    int64_t t = A.p[j];
                    const int64_t tend = A.p[j + 1];
                    for (int i = 0; i < m; ++i) {
                        double v = 0;
                        if (t < tend && A.idx[t] == i) v = A.val[t++];
                        if (mask.held(i, j)) {
                            if (!mask_zeros || v != 0.0)
                                test_rows.push_back(i);
                            if (mask_zeros && v == 0.0) continue;
                        } else if (v != 0.0) {
                            const double* wc =
                                out.W_T.data() + static_cast<size_t>(i) * k;
                            for (int a = 0; a < k; ++a) b[a] += v * wc[a];
                        }
                    }
                } else {
                    const double* aj = A.dense + static_cast<size_t>(j) * m;
                    for (int i = 0; i < m; ++i) {
                        const double v = aj[i];
                        if (mask_zeros && v == 0.0) continue;
                        if (mask.held(i, j)) {
                            test_rows.push_back(i);
                        } else if (v != 0.0) {
                            const double* wc =
                                out.W_T.data() + static_cast<size_t>(i) * k;
                            for (int a = 0; a < k; ++a) b[a] += v * wc[a];
                        }
                    }
                }
                // apply_gram_correction (cv_detail.hpp:67-85)
                std::memcpy(Gl.data(), G.data(),
                            sizeof(double) * static_cast<size_t>(k) * k);
                for (int idx : test_rows) {
                    const double* wc =
                        out.W_T.data() + static_cast<size_t>(idx) * k;
                    for (int a = 0; a < k; ++a)
                        for (int r = 0; r < k; ++r)
                            Gl[static_cast<size_t>(a) * k + r] -= wc[a] * wc[r];
                }
                if (solver_mode == 1)
                    cholesky_clip_col(Gl.data(), b.data(),
                                      out.H.data() + static_cast<size_t>(j) * k,
                                      k, L1_h, true);
                else
                    // warm-started CD, fixed sweeps (fit_cv.hpp:473-478:
                    // b NOT residual-adjusted, no cd_tol — faithful port)
                    cd_col(Gl.data(), b.data(),
                           out.H.data() + static_cast<size_t>(j) * k, k,
                           L1_h, 0.0, true, cd_maxit, 0.0);
            }
        }

        // normalize H -> d (fit_cv.hpp:541-553)
        extract_scaling(out.H.data(), k, n, out.d.data(), norm_type);

        // ==== W update: per-row gram correction (fit_cv.hpp:556-770) ====
        gram(out.H.data(), k, n, G.data());
        std::memcpy(G_H_saved.data(), G.data(),
                    sizeof(double) * static_cast<size_t>(k) * k);
        for (int a = 0; a < k; ++a)
            G[static_cast<size_t>(a) * k + a] += 1e-15;

#ifdef _OPENMP
#pragma omp parallel num_threads(threads)
#endif
        {
            std::vector<double> b(static_cast<size_t>(k));
            std::vector<double> bfull(static_cast<size_t>(k));
            std::vector<double> Gl(static_cast<size_t>(k) * k);
            std::vector<int> test_cols;
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 64)
#endif
            for (int i = 0; i < m; ++i) {
                std::fill(b.begin(), b.end(), 0.0);
                test_cols.clear();
                if (At) {
                    int64_t t = At->p[i];
                    const int64_t tend = At->p[i + 1];
                    for (int j = 0; j < n; ++j) {
                        double v = 0;
                        if (t < tend && At->idx[static_cast<size_t>(t)] == j)
                            v = At->val[static_cast<size_t>(t++)];
                        if (mask.held(i, j)) {
                            if (!mask_zeros || v != 0.0)
                                test_cols.push_back(j);
                            if (mask_zeros && v == 0.0) continue;
                        } else if (v != 0.0) {
                            const double* hc =
                                out.H.data() + static_cast<size_t>(j) * k;
                            for (int a = 0; a < k; ++a) b[a] += v * hc[a];
                        }
                    }
                } else {
                    for (int j = 0; j < n; ++j) {
                        const double v =
                            A.dense[static_cast<size_t>(j) * m + i];
                        if (mask_zeros && v == 0.0) continue;
                        if (mask.held(i, j)) {
                            test_cols.push_back(j);
                        } else if (v != 0.0) {
                            const double* hc =
                                out.H.data() + static_cast<size_t>(j) * k;
                            for (int a = 0; a < k; ++a) b[a] += v * hc[a];
                        }
                    }
                }
                // full RHS (train + held-out) for the gram-trick train loss
                // (fit_cv.hpp:619-652)
                std::memcpy(bfull.data(), b.data(), sizeof(double) * k);
                for (int j : test_cols) {
                    double v = 0;
                    if (At) {
                        for (int64_t t = At->p[i]; t < At->p[i + 1]; ++t)
                            if (At->idx[static_cast<size_t>(t)] == j) {
                                v = At->val[static_cast<size_t>(t)];
                                break;
                            }
                    } else {
                        v = A.dense[static_cast<size_t>(j) * m + i];
                    }
                    if (v != 0.0) {
                        const double* hc =
                            out.H.data() + static_cast<size_t>(j) * k;
                        for (int a = 0; a < k; ++a) bfull[a] += v * hc[a];
                    }
                }
                std::memcpy(B_W_full.data() + static_cast<size_t>(i) * k,
                            bfull.data(), sizeof(double) * k);

                std::memcpy(Gl.data(), G.data(),
                            sizeof(double) * static_cast<size_t>(k) * k);
                for (int idx : test_cols) {
                    const double* hc =
                        out.H.data() + static_cast<size_t>(idx) * k;
                    for (int a = 0; a < k; ++a)
                        for (int r = 0; r < k; ++r)
                            Gl[static_cast<size_t>(a) * k + r] -= hc[a] * hc[r];
                }
                if (solver_mode == 1)
                    cholesky_clip_col(Gl.data(), b.data(),
                                      out.W_T.data() + static_cast<size_t>(i) * k,
                                      k, L1_w, true);
                else
                    cd_col(Gl.data(), b.data(),
                           out.W_T.data() + static_cast<size_t>(i) * k, k,
                           L1_w, 0.0, true, cd_maxit, 0.0);
            }
        }

        // ==== loss (fit_cv.hpp:1444-1556) ====
        for (int t = 0; t < m; ++t)
            for (int a = 0; a < k; ++a)
                W_Td[static_cast<size_t>(t) * k + a] =
                    out.W_T[static_cast<size_t>(t) * k + a] * out.d[a];

        double test_sq = 0;
        int64_t n_test = 0;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 64) num_threads(threads) \
    reduction(+:test_sq, n_test)
#endif
        for (int j = 0; j < n; ++j) {
            if (A.sparse()) {
                if (mask_zeros) {
                    for (int64_t t = A.p[j]; t < A.p[j + 1]; ++t)
                        if (mask.held(A.idx[t], j)) {
                            const double* wc =
                                W_Td.data() + static_cast<size_t>(A.idx[t]) * k;
                            const double* hc =
                                out.H.data() + static_cast<size_t>(j) * k;
                            double pred = 0;
                            for (int a = 0; a < k; ++a) pred += wc[a] * hc[a];
                            const double dd = A.val[t] - pred;
                            test_sq += dd * dd;
                            ++n_test;
                        }
                } else {
                    int64_t t = A.p[j];
                    const int64_t tend = A.p[j + 1];
                    for (int i = 0; i < m; ++i) {
                        double v = 0;
                        if (t < tend && A.idx[t] == i) v = A.val[t++];
                        if (!mask.held(i, j)) continue;
                        const double* wc =
                            W_Td.data() + static_cast<size_t>(i) * k;
                        const double* hc =
                            out.H.data() + static_cast<size_t>(j) * k;
                        double pred = 0;
                        for (int a = 0; a < k; ++a) pred += wc[a] * hc[a];
                        const double dd = v - pred;
                        test_sq += dd * dd;
                        ++n_test;
                    }
                }
            } else {
                for (int i = 0; i < m; ++i) {
                    const double v = A.dense[static_cast<size_t>(j) * m + i];
                    if (mask_zeros && v == 0.0) continue;
                    if (!mask.held(i, j)) continue;
                    const double* wc = W_Td.data() + static_cast<size_t>(i) * k;
                    const double* hc =
                        out.H.data() + static_cast<size_t>(j) * k;
                    double pred = 0;
                    for (int a = 0; a < k; ++a) pred += wc[a] * hc[a];
                    const double dd = v - pred;
                    test_sq += dd * dd;
                    ++n_test;
                }
            }
        }

        // train via gram trick reusing B_W_full (fit_cv.hpp:1498-1540)
        double cross = 0;
        for (int a = 0; a < k; ++a) {
            double s = 0;
            for (int i = 0; i < m; ++i)
                s += out.W_T[static_cast<size_t>(i) * k + a]
                   * B_W_full[static_cast<size_t>(i) * k + a];
            cross += out.d[a] * s;
        }
        gram(out.W_T.data(), k, m, G_W_new.data());
        double recon = 0;
        for (int a = 0; a < k; ++a)
            for (int r = 0; r < k; ++r)
                recon += out.d[a] * out.d[r]
                       * G_W_new[static_cast<size_t>(a) * k + r]
                       * G_H_saved[static_cast<size_t>(a) * k + r];
        const double total_sq = std::max(trA - 2.0 * cross + recon, 0.0);
        const double train_sq = std::max(total_sq - test_sq, 0.0);
        const int64_t total_entries =
            mask_zeros ? nnz : static_cast<int64_t>(m) * n;
        const int64_t n_train = total_entries - n_test;
        const double train_loss = n_train > 0 ? train_sq / n_train : 0;
        const double test_loss = n_test > 0 ? test_sq / n_test : 0;

        out.train_hist.push_back(train_loss);
        out.test_hist.push_back(test_loss);
        out.train_loss = train_loss;
        out.test_loss = test_loss;

        double rel = 0;
        if (iter > 0)
            rel = std::abs(prev_conv_loss - test_loss)
                / (std::abs(prev_conv_loss) + 1e-15);

        // early stopping (fit_cv.hpp:1583-1623)
        if (test_loss < best_test) {
            best_test = test_loss;
            best_iter = iter;
            patience_count = 0;
        } else {
            ++patience_count;
        }
        out.iterations = iter + 1;
        if (cv_patience > 0 && patience_count >= cv_patience) break;
        if (iter > 0 && rel < tol) break;
        prev_conv_loss = test_loss;
    }
    out.best_test_loss = best_test;
    out.best_iter = best_iter;
    return out;
}

// ---------------------------------------------------------------------------
// Auto-rank: exponential + golden-section search (rank_cv.hpp:66-240)
// ---------------------------------------------------------------------------

struct RankEval { int rank; double train_final, test_final; };

RankEval eval_rank(const DataView& A, int rank, uint32_t seed,
                   uint32_t cv_seed, double holdout_fraction, int max_iter,
                   double tol, int cv_patience, int cd_maxit, int threads) {
    // rank-dependent seed (rank_cv.hpp:79-82)
    const uint32_t s = seed > 0 ? seed + static_cast<uint32_t>(rank) : seed;
    // RcppFunctions_nmf.cpp:217 forces solver_mode=2 (-> CD dispatch)
    CvOut cv = nmf_fit_cv(A, rank, s, cv_seed, holdout_fraction, false,
                          max_iter, tol, cv_patience, 2, cd_maxit,
                          0.0, 0.0, 1, threads);
    return {rank, cv.train_loss, cv.test_loss};
}

int auto_rank(const DataView& A, int k_init, int max_k, int bracket_tol,
              uint32_t seed, uint32_t cv_seed, double holdout_fraction,
              int max_iter, double tol, int cv_patience, int cd_maxit,
              int threads, int* out_k_low, int* out_k_high,
              int* out_overfit) {
    std::vector<RankEval> evals;
    int k_low = -1, k_high = -1;
    bool overfit = false;
    int k_current = k_init;
    while (k_current <= max_k) {
        evals.push_back(eval_rank(A, k_current, seed, cv_seed,
                                  holdout_fraction, max_iter, tol,
                                  cv_patience, cd_maxit, threads));
        const size_t ne = evals.size();
        if (ne >= 2) {
            const RankEval& prev = evals[ne - 2];
            const RankEval& cur = evals[ne - 1];
            const double train_rel =
                std::abs(cur.train_final - prev.train_final)
                / (prev.train_final + TINY);
            if (train_rel < 0.01 && cur.test_final > prev.test_final) {
                k_low = prev.rank;
                k_high = cur.rank;
                overfit = true;
                break;
            }
        }
        if (k_current * 2 > max_k && k_current < max_k) k_current = max_k;
        else k_current *= 2;
    }
    int k_optimal;
    if (!overfit) {
        k_optimal = evals.empty() ? k_init : evals.back().rank;
    } else {
        // golden-section refinement (rank_cv.hpp:186-229)
        const double phi = (1.0 + std::sqrt(5.0)) / 2.0;
        int lo = k_low, hi = k_high;
        while (hi - lo > bracket_tol) {
            const int k1 = static_cast<int>(hi - (hi - lo) / phi + 0.5);
            const int k2 = static_cast<int>(lo + (hi - lo) / phi + 0.5);
            if (k1 <= lo || k2 >= hi || k1 >= k2) break;
            RankEval e1 = eval_rank(A, k1, seed, cv_seed, holdout_fraction,
                                    max_iter, tol, cv_patience, cd_maxit,
                                    threads);
            RankEval e2 = eval_rank(A, k2, seed, cv_seed, holdout_fraction,
                                    max_iter, tol, cv_patience, cd_maxit,
                                    threads);
            if (e1.test_final < e2.test_final) hi = k2;
            else lo = k1;
        }
        k_optimal = lo;  // conservative lower bound (rank_cv.hpp:227)
    }
    if (out_k_low) *out_k_low = k_low;
    if (out_k_high) *out_k_high = k_high;
    if (out_overfit) *out_overfit = overfit ? 1 : 0;
    return k_optimal;
}

DataView make_view(int m, int n, const double* dense, const int64_t* p,
                   const int32_t* idx, const double* val) {
    DataView A;
    A.m = m; A.n = n;
    if (p) { A.p = p; A.idx = idx; A.val = val; }
    else { A.dense = dense; }
    return A;
}

int resolve_threads(int threads) {
#ifdef _OPENMP
    return threads > 0 ? threads : omp_get_max_threads();
#else
    (void)threads;
    return 1;
#endif
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

// RNG parity probes
void oracle_fill_uniform(uint64_t seed, int rows, int cols, double* out) {
    SeqRng rng(seed);
    rng.fill(out, rows, cols);
}

uint64_t oracle_pos_hash(uint64_t seed, uint32_t i, uint32_t j) {
    return pos_hash(seed, i, j);
}

// Standard ALS fit.  Pass dense (col-major) OR CSC (p/idx/val); the unused
// pointers are null.  Outputs: W_T (k*m col-major), d (k), H (k*n),
// loss_hist (max_iter slots, n_iters filled).  Returns n_iters (<0 on error).
int oracle_nmf_fit(int m, int n, const double* dense, const int64_t* p,
                   const int32_t* idx, const double* val, int k,
                   uint32_t seed, int max_iter, double tol, int patience,
                   int solver_mode, int cd_maxit, double cd_tol,
                   double L1_w, double L1_h,
                   double L2_w, double L2_h, int norm_type, int threads,
                   double* out_W_T, double* out_d, double* out_H,
                   double* out_loss_hist, int* out_converged) {
    if (k <= 0 || m <= 0 || n <= 0) return -1;
    DataView A = make_view(m, n, dense, p, idx, val);
    FitOut r = nmf_fit(A, k, seed, max_iter, tol, patience, solver_mode,
                       cd_maxit, cd_tol, L1_w, L1_h, L2_w, L2_h, norm_type,
                       resolve_threads(threads));
    std::memcpy(out_W_T, r.W_T.data(),
                sizeof(double) * static_cast<size_t>(k) * m);
    std::memcpy(out_d, r.d.data(), sizeof(double) * static_cast<size_t>(k));
    std::memcpy(out_H, r.H.data(),
                sizeof(double) * static_cast<size_t>(k) * n);
    std::memcpy(out_loss_hist, r.loss_hist.data(),
                sizeof(double) * r.loss_hist.size());
    if (out_converged) *out_converged = r.converged ? 1 : 0;
    return r.iterations;
}

// CV fit.  Outputs as above plus train/test trajectories and
// best_iter/best_test_loss.  H is returned UNSCALED (d separate), matching
// the pre-absorption state so factor parity checks see both pieces.
int oracle_nmf_fit_cv(int m, int n, const double* dense, const int64_t* p,
                      const int32_t* idx, const double* val, int k,
                      uint32_t seed, uint32_t cv_seed,
                      double holdout_fraction, int mask_zeros, int max_iter,
                      double tol, int cv_patience, int solver_mode,
                      int cd_maxit,
                      double L1_w, double L1_h, int norm_type, int threads,
                      double* out_W_T, double* out_d, double* out_H,
                      double* out_train_hist, double* out_test_hist,
                      int* out_best_iter, double* out_best_test) {
    if (k <= 0 || m <= 0 || n <= 0) return -1;
    DataView A = make_view(m, n, dense, p, idx, val);
    CvOut r = nmf_fit_cv(A, k, seed, cv_seed, holdout_fraction,
                         mask_zeros != 0, max_iter, tol, cv_patience,
                         solver_mode, cd_maxit, L1_w, L1_h, norm_type,
                         resolve_threads(threads));
    std::memcpy(out_W_T, r.W_T.data(),
                sizeof(double) * static_cast<size_t>(k) * m);
    std::memcpy(out_d, r.d.data(), sizeof(double) * static_cast<size_t>(k));
    std::memcpy(out_H, r.H.data(),
                sizeof(double) * static_cast<size_t>(k) * n);
    std::memcpy(out_train_hist, r.train_hist.data(),
                sizeof(double) * r.train_hist.size());
    std::memcpy(out_test_hist, r.test_hist.data(),
                sizeof(double) * r.test_hist.size());
    if (out_best_iter) *out_best_iter = r.best_iter;
    if (out_best_test) *out_best_test = r.best_test_loss;
    return r.iterations;
}

// Auto-rank search.  Returns k_optimal.
int oracle_auto_rank(int m, int n, const double* dense, const int64_t* p,
                     const int32_t* idx, const double* val, int k_init,
                     int max_k, int bracket_tol, uint32_t seed,
                     uint32_t cv_seed, double holdout_fraction, int max_iter,
                     double tol, int cv_patience, int cd_maxit, int threads,
                     int* out_k_low, int* out_k_high, int* out_overfit) {
    DataView A = make_view(m, n, dense, p, idx, val);
    return auto_rank(A, k_init, max_k, bracket_tol, seed, cv_seed,
                     holdout_fraction, max_iter, tol, cv_patience, cd_maxit,
                     resolve_threads(threads), out_k_low, out_k_high,
                     out_overfit);
}

}  // extern "C"
