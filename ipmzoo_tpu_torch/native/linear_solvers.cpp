// Native host tier: dense symmetric factorisations with a C ABI.
//
// The port's copy of ipmzoo_tpu/native/linear_solvers.cpp, code for code
// (only this comment differs): the host yardstick for the factorisation
// kernels the port runs on the card (K2/K3, csrc/ldlt.cu): an unpivoted
// LDL^T with quasi-definite zero-pivot regularisation, and a
// Bunch-Kaufman symmetric-indefinite factorisation (1x1/2x2 pivots,
// alpha = (1+sqrt(17))/8) for formulations whose augmented system is
// genuinely indefinite.  The C++ original keeps the same two algorithms
// as its only native compute tier (its
// src/NumericalOptimization/LinearSolvers.cpp); this implementation is
// written in flat row-major storage with an eye to cache behaviour and
// batch parallelism (OpenMP over instances).
//
// Exposed through ctypes (see native.py); all matrices are row-major
// n*n doubles.

#include <cmath>
#include <cstdint>
#include <cstring>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------------
// LDL^T (no pivoting, zero pivots floored)
// ---------------------------------------------------------------------

// Factor A (n x n, symmetric, row-major) into unit-lower L and diagonal D.
// L and D are outputs; A is untouched.  Returns 0.
int ipm_ldlt_factor(const double* A, int64_t n, double* L, double* D,
                    double pivot_floor) {
  for (int64_t i = 0; i < n; ++i) {
    // d_i = a_ii - sum_k L_ik^2 d_k
    double d = A[i * n + i];
    for (int64_t k = 0; k < i; ++k) {
      const double lik = L[i * n + k];
      d -= lik * lik * D[k];
    }
    D[i] = (d == 0.0) ? pivot_floor : d;

    // column i of L below the diagonal
    const double dinv = 1.0 / D[i];
    for (int64_t j = i + 1; j < n; ++j) {
      double s = A[j * n + i];
      const double* Lj = L + j * n;
      const double* Li = L + i * n;
      for (int64_t k = 0; k < i; ++k) {
        s -= Lj[k] * Li[k] * D[k];
      }
      L[j * n + i] = s * dinv;
    }
    L[i * n + i] = 1.0;
    for (int64_t j = i + 1; j < n; ++j) L[i * n + j] = 0.0;
  }
  return 0;
}

// Solve L D L^T x = b in place (b overwritten with x).
int ipm_ldlt_solve(const double* L, const double* D, double* b, int64_t n) {
  // forward: L y = b (unit diagonal)
  for (int64_t i = 0; i < n; ++i) {
    double s = b[i];
    const double* Li = L + i * n;
    for (int64_t k = 0; k < i; ++k) s -= Li[k] * b[k];
    b[i] = s;
  }
  // scale: D z = y
  for (int64_t i = 0; i < n; ++i) b[i] /= D[i];
  // backward: L^T x = z
  for (int64_t i = n - 1; i >= 0; --i) {
    double s = b[i];
    for (int64_t j = i + 1; j < n; ++j) s -= L[j * n + i] * b[j];
    b[i] = s;
  }
  return 0;
}

// Batched factor+solve: nb independent systems, A (nb,n,n), b (nb,n).
// Parallelised over instances with OpenMP when available.
int ipm_ldlt_factor_solve_batch(const double* A, double* b, int64_t nb,
                                int64_t n, double pivot_floor,
                                double* workspace /* nb*(n*n+n) */) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < nb; ++i) {
    double* L = workspace + i * (n * n + n);
    double* D = L + n * n;
    ipm_ldlt_factor(A + i * n * n, n, L, D, pivot_floor);
    ipm_ldlt_solve(L, D, b + i * n, n);
  }
  return 0;
}

// ---------------------------------------------------------------------
// Bunch-Kaufman symmetric indefinite factorisation (lower, partial
// pivoting, alpha = (1 + sqrt(17)) / 8)
// ---------------------------------------------------------------------
//
// On exit F (row-major, n x n) holds the multipliers below the block
// diagonal and the 1x1/2x2 D blocks on/near the diagonal; ipiv follows
// the LAPACK convention:
//   ipiv[k] >= 0: rows k and ipiv[k] were swapped, 1x1 pivot at k
//   ipiv[k] == ipiv[k+1] < 0: 2x2 pivot in rows (k, k+1); rows k+1 and
//       -(ipiv[k])-1 were swapped.
// Returns 0 on success, (k+1) if the leading block at k is exactly
// singular (factorisation continues, solve may divide by zero).

static void swap_sym_rows(double* F, int64_t n, int64_t r1, int64_t r2) {
  // swap rows/cols r1 < r2 of the lower-triangular working matrix
  if (r1 == r2) return;
  for (int64_t j = 0; j < r1; ++j) {
    double t = F[r1 * n + j];
    F[r1 * n + j] = F[r2 * n + j];
    F[r2 * n + j] = t;
  }
  for (int64_t i = r1 + 1; i < r2; ++i) {
    double t = F[i * n + r1];
    F[i * n + r1] = F[r2 * n + i];
    F[r2 * n + i] = t;
  }
  for (int64_t i = r2 + 1; i < n; ++i) {
    double t = F[i * n + r1];
    F[i * n + r1] = F[i * n + r2];
    F[i * n + r2] = t;
  }
  double t = F[r1 * n + r1];
  F[r1 * n + r1] = F[r2 * n + r2];
  F[r2 * n + r2] = t;
}

int ipm_bunch_kaufman_factor(const double* A, int64_t n, double* F,
                             int64_t* ipiv) {
  const double alpha = (1.0 + std::sqrt(17.0)) / 8.0;
  std::memcpy(F, A, sizeof(double) * n * n);
  int info = 0;

  int64_t k = 0;
  while (k < n) {
    int64_t kstep = 1;
    int64_t kp = k;
    const double absakk = std::fabs(F[k * n + k]);

    // largest off-diagonal magnitude in column k (below diagonal)
    int64_t imax = k;
    double colmax = 0.0;
    for (int64_t i = k + 1; i < n; ++i) {
      const double v = std::fabs(F[i * n + k]);
      if (v > colmax) { colmax = v; imax = i; }
    }

    if (absakk == 0.0 && colmax == 0.0) {
      if (info == 0) info = static_cast<int>(k) + 1;
      kp = k;
    } else if (absakk >= alpha * colmax) {
      kp = k;  // 1x1, no interchange
    } else {
      // rowmax: largest magnitude in row imax among cols k..imax-1 and
      // column imax below the diagonal
      double rowmax = 0.0;
      for (int64_t j = k; j < imax; ++j)
        rowmax = std::max(rowmax, std::fabs(F[imax * n + j]));
      for (int64_t i = imax + 1; i < n; ++i)
        rowmax = std::max(rowmax, std::fabs(F[i * n + imax]));

      if (absakk * rowmax >= alpha * colmax * colmax) {
        kp = k;  // 1x1, no interchange after all
      } else if (std::fabs(F[imax * n + imax]) >= alpha * rowmax) {
        kp = imax;  // 1x1 with interchange
      } else {
        kp = imax;  // 2x2 with interchange of row k+1
        kstep = 2;
      }
    }

    if (kstep == 1) {
      if (kp != k) swap_sym_rows(F, n, k, kp);
      ipiv[k] = kp;
      // eliminate below the 1x1 pivot: update trailing matrix with the
      // unscaled column first, then store the multipliers
      const double d = F[k * n + k];
      if (d != 0.0) {
        const double dinv = 1.0 / d;
        for (int64_t i = k + 1; i < n; ++i) {
          const double wi = F[i * n + k];
          for (int64_t j = k + 1; j <= i; ++j) {
            F[i * n + j] -= wi * dinv * F[j * n + k];
          }
        }
        for (int64_t i = k + 1; i < n; ++i) F[i * n + k] *= dinv;
      } else if (info == 0) {
        info = static_cast<int>(k) + 1;
      }
      k += 1;
    } else {
      if (kp != k + 1) swap_sym_rows(F, n, k + 1, kp);
      ipiv[k] = -kp - 1;
      ipiv[k + 1] = -kp - 1;
      // eliminate below the 2x2 pivot [[d11, d21], [d21, d22]]
      const double d11 = F[k * n + k];
      const double d21 = F[(k + 1) * n + k];
      const double d22 = F[(k + 1) * n + (k + 1)];
      const double det = d11 * d22 - d21 * d21;
      if (det != 0.0) {
        const double idet = 1.0 / det;
        // trailing update with unscaled columns, then store multipliers
        for (int64_t i = k + 2; i < n; ++i) {
          const double w1 = F[i * n + k];
          const double w2 = F[i * n + (k + 1)];
          const double l1 = (d22 * w1 - d21 * w2) * idet;
          const double l2 = (d11 * w2 - d21 * w1) * idet;
          for (int64_t j = k + 2; j <= i; ++j) {
            F[i * n + j] -= l1 * F[j * n + k] + l2 * F[j * n + (k + 1)];
          }
        }
        for (int64_t i = k + 2; i < n; ++i) {
          const double w1 = F[i * n + k];
          const double w2 = F[i * n + (k + 1)];
          F[i * n + k] = (d22 * w1 - d21 * w2) * idet;
          F[i * n + (k + 1)] = (d11 * w2 - d21 * w1) * idet;
        }
      } else if (info == 0) {
        info = static_cast<int>(k) + 1;
      }
      k += 2;
    }
  }
  return info;
}

// Solve using the Bunch-Kaufman factors; b overwritten with x.
//
// The factor routine applies each interchange as a FULL symmetric
// row/column swap (including the already-computed multiplier columns),
// so F is a proper L D L^T factorisation of P A P^T where P is the
// composition of the recorded transpositions.  The solve therefore
// applies all transpositions to b up front (in factor order), performs
// clean triangular/diagonal solves, and unwinds the permutation at the
// end (reverse order).
int ipm_bunch_kaufman_solve(const double* F, const int64_t* ipiv, double* b,
                            int64_t n) {
  // apply P (transpositions in factor order)
  for (int64_t k = 0; k < n; ++k) {
    if (ipiv[k] >= 0) {
      const int64_t kp = ipiv[k];
      if (kp != k) { double t = b[k]; b[k] = b[kp]; b[kp] = t; }
    } else {
      const int64_t kp = -ipiv[k] - 1;
      if (kp != k + 1) { double t = b[k + 1]; b[k + 1] = b[kp]; b[kp] = t; }
      ++k;  // second row of the 2x2 block carries the same code
    }
  }
  // forward: L y = b (unit diagonal; 2x2 blocks have zero multiplier
  // between their two rows, so a plain column sweep is exact)
  int64_t k = 0;
  while (k < n) {
    if (ipiv[k] >= 0) {
      for (int64_t i = k + 1; i < n; ++i) b[i] -= F[i * n + k] * b[k];
      k += 1;
    } else {
      for (int64_t i = k + 2; i < n; ++i)
        b[i] -= F[i * n + k] * b[k] + F[i * n + (k + 1)] * b[k + 1];
      k += 2;
    }
  }
  // diagonal solve
  k = 0;
  while (k < n) {
    if (ipiv[k] >= 0) {
      b[k] /= F[k * n + k];
      k += 1;
    } else {
      const double d11 = F[k * n + k];
      const double d21 = F[(k + 1) * n + k];
      const double d22 = F[(k + 1) * n + (k + 1)];
      const double det = d11 * d22 - d21 * d21;
      const double b1 = b[k], b2 = b[k + 1];
      b[k] = (d22 * b1 - d21 * b2) / det;
      b[k + 1] = (d11 * b2 - d21 * b1) / det;
      k += 2;
    }
  }
  // backward: L^T x = z
  k = n - 1;
  while (k >= 0) {
    const bool two = (ipiv[k] < 0);
    const int64_t k0 = two ? k - 1 : k;
    double s0 = b[k0];
    double s1 = b[k];
    for (int64_t i = k + 1; i < n; ++i) {
      s0 -= F[i * n + k0] * b[i];
      if (two) s1 -= F[i * n + k] * b[i];
    }
    b[k0] = s0;
    if (two) b[k] = s1;
    k = k0 - 1;
  }
  // apply P^T (transpositions in reverse order)
  for (int64_t kk = n - 1; kk >= 0; --kk) {
    if (ipiv[kk] >= 0) {
      const int64_t kp = ipiv[kk];
      if (kp != kk) { double t = b[kk]; b[kk] = b[kp]; b[kp] = t; }
    } else {
      // kk is the second row of its 2x2 block
      const int64_t kp = -ipiv[kk] - 1;
      if (kp != kk) { double t = b[kk]; b[kk] = b[kp]; b[kp] = t; }
      --kk;  // skip the first row of the block
    }
  }
  return 0;
}

}  // extern "C"
