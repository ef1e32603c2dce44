// Native sparse-numerics engine for eddy_currents_3d_tpu.
//
// Hosts the inherently *sequential* factorization work that XLA cannot
// express (data-dependent row-by-row elimination): ILU(0) on CSR.  The
// factors themselves are applied on-device (solvers/ilu0.py) — this file is
// the once-per-assembly host step, the analogue of the
// compiled-Fortran tier in the reference (which runs everything on host;
// solvers.f90 runs unpreconditioned, so this is a new capability).
//
// Build: make -C native   (or the first-use build in ops/native.py)

#include <cstdint>
#include <vector>

extern "C" {

// In-place ILU(0) numeric factorization of a CSR matrix.
//
// On exit vals holds L and U interleaved in the original sparsity pattern:
// strictly-lower entries are L (unit diagonal implied), diagonal + upper
// entries are U.  Requires every row to contain its diagonal and columns
// sorted ascending within each row.
//
// Returns 0 on success, i+1 if row i has a zero/missing pivot,
// -(i+1) if row i's columns are unsorted.
int64_t ec3d_ilu0(int64_t n,
                  const int64_t* indptr,
                  const int32_t* cols,
                  double* vals) {
    std::vector<int64_t> diag(n, -1);
    std::vector<int64_t> pos(n, -1);  // column -> index within current row

    for (int64_t i = 0; i < n; ++i) {
        const int64_t lo = indptr[i], hi = indptr[i + 1];
        for (int64_t t = lo; t < hi; ++t) {
            if (t > lo && cols[t] <= cols[t - 1]) return -(i + 1);
            pos[cols[t]] = t;
        }
        // eliminate with previously factored rows k < i present in row i
        for (int64_t t = lo; t < hi && cols[t] < i; ++t) {
            const int64_t k = cols[t];
            const int64_t dk = diag[k];
            if (dk < 0 || vals[dk] == 0.0) {
                for (int64_t u = lo; u < hi; ++u) pos[cols[u]] = -1;
                return k + 1;
            }
            const double lik = vals[t] / vals[dk];
            vals[t] = lik;
            // row_i -= lik * upper(row_k), restricted to row_i's pattern
            for (int64_t s = dk + 1; s < indptr[k + 1]; ++s) {
                const int64_t p = pos[cols[s]];
                if (p >= 0) vals[p] -= lik * vals[s];
            }
        }
        // locate pivot
        for (int64_t t = lo; t < hi; ++t) {
            if (cols[t] == static_cast<int32_t>(i)) { diag[i] = t; break; }
        }
        for (int64_t t = lo; t < hi; ++t) pos[cols[t]] = -1;
        if (diag[i] < 0 || vals[diag[i]] == 0.0) return i + 1;
    }
    return 0;
}

// Exact sequential triangular solves on the packed ILU(0) factors — used by
// the CPU validation path and tests (the device path applies the factors with
// fixed-sweep Jacobi iterations instead; see solvers/ilu0.py).
//
// Solves L y = b (unit lower) then U x = y, writing x over b.
int64_t ec3d_ilu0_solve(int64_t n,
                        const int64_t* indptr,
                        const int32_t* cols,
                        const double* vals,
                        double* b) {
    // forward: y_i = b_i - sum_{j<i} L_ij y_j
    for (int64_t i = 0; i < n; ++i) {
        double acc = b[i];
        for (int64_t t = indptr[i]; t < indptr[i + 1] && cols[t] < i; ++t)
            acc -= vals[t] * b[cols[t]];
        b[i] = acc;
    }
    // backward: x_i = (y_i - sum_{j>i} U_ij x_j) / U_ii
    for (int64_t i = n - 1; i >= 0; --i) {
        double acc = b[i];
        double piv = 0.0;
        for (int64_t t = indptr[i + 1] - 1; t >= indptr[i]; --t) {
            const int32_t j = cols[t];
            if (j > i) acc -= vals[t] * b[j];
            else if (j == i) { piv = vals[t]; break; }
        }
        if (piv == 0.0) return i + 1;
        b[i] = acc / piv;
    }
    return 0;
}

}  // extern "C"
