// Whole-reduction block cyclic reduction of an SPD block-tridiagonal
// matrix for Hopper (sm_90a): factor (K6) and multi right-hand-side solve
// (K7), with a plain C interface loaded through ctypes
// (ipmzoo_tpu_torch/ops/cuda_cr.py).
//
// K6 cr_factor_kernel replaces the TPU kernel
//     ipmzoo_tpu/ops/cr_pallas.py:_factor_kernel
// K7 cr_solve_kernel replaces the TPU kernel
//     ipmzoo_tpu/ops/cr_pallas.py:_solve_kernel
// Their plain versions are ipmzoo_tpu_torch/ops/cr.py:cr_factor_plain /
// cr_solve_plain, which repeat this file's arithmetic in the same order.
//
// What they compute.  D (N, b, b) diagonal and E (N-1, b, b) sub-diagonal
// blocks.  At the level of stride s = 1, 2, 4, ... < N the blocks at
// positions p = s, 3s, 5s, ... < N are eliminated: Pinv[p] is the explicit
// inverse of the pivot (Cholesky L, then L^-1 by forward substitution on
// the identity, then L^-T L^-1), Eb[p] / Ea[p] its couplings to p - s and
// p + s, the even blocks take their Schur updates and the couplings of
// the next level are formed.  Every position is eliminated at one level,
// position 0 is the root, so the factors are three (N, b, b) arrays
// indexed by block position.  The solve folds the odd right-hand sides
// into the even ones level by level (down-sweep), solves the root, and
// recovers the odd unknowns in reverse (up-sweep).
//
// What bounds them on this card.  At the banded+arrow slice's shape
// (N = 256, b = 16, float32) the factor reads 0.5 MB, writes 0.8 MB and
// does about 1e7 multiply-adds: memory traffic and arithmetic would both
// take about a microsecond.  The time is the latency of a chain of
// dependent steps, ceil(log2 N) levels of b Cholesky columns and a few
// b-long dot products each, run by the one thread block that owns the
// instance.
//
// Design.  One thread block per instance of the batch (gridDim.x = batch),
// all levels inside the kernel, __syncthreads() between the phases of a
// level.  A thread addresses block p +- s by index, so only the live
// pivots of a level are touched and N need not be a power of two.  Each
// phase is a flat loop over its output elements (pivot, row, column),
// strided over the block's threads, one dot product of length b per
// element; the Cholesky runs its b columns in turn with one thread per
// (pivot, row) and a barrier after every column.  The working copies of
// D and E, the Cholesky workspace and the solve's working right-hand
// sides live in global scratch that the wrapper allocates (at the
// slice's shape they exceed one SM's shared memory and stay in the L2).
// Scratch and outputs that are written and read again inside a kernel are
// not __restrict__ and are read with ordinary loads, which __syncthreads()
// keeps coherent within the block.  b and k are run-time arguments.
//
// Arithmetic is plain IEEE: no fast-math flags.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float root(float x) { return sqrtf(x); }
__device__ __forceinline__ double root(double x) { return sqrt(x); }

// Explicit inverses of the npiv pivots at positions first + i * step:
// P in Dw[p] (overwritten by L^-1), L in Xw[p], the inverse in Pinv[p].
// Ends with a barrier.
template <typename T>
__device__ void chol_inv_phase(T* Dw, T* Xw, T* Pinv, int npiv, int first,
                               int step, int b) {
  const int tid = threadIdx.x, nt = blockDim.x, bb = b * b;
  // Cholesky, column by column: thread (pivot, row i) forms L[i][j].  The
  // diagonal holds 1 / L[j][j]; every thread of a column recomputes it.
  const int rows = npiv * b;
  for (int base = 0; base < rows; base += nt) {
    const int idx = base + tid;
    const bool active = idx < rows;
    const int piv = active ? idx / b : 0;
    const int i = idx - piv * b;
    const int p = first + piv * step;
    const T* P = Dw + p * bb;
    T* L = Xw + p * bb;
    for (int j = 0; j < b; ++j) {
      if (active && i >= j) {
        T acc = P[j * b + j];
        for (int k = 0; k < j; ++k) acc -= L[j * b + k] * L[j * b + k];
        const T idj = T(1) / root(acc);
        if (i == j) {
          L[j * b + j] = idj;
        } else {
          T col = P[i * b + j];
          for (int k = 0; k < j; ++k) col -= L[i * b + k] * L[j * b + k];
          L[i * b + j] = col * idj;
        }
      }
      __syncthreads();
    }
  }
  // X = L^-1, thread (pivot, column j) down its column:
  // X[i][j] = (delta_ij - sum_{j <= k < i} L[i][k] X[k][j]) / L[i][i]
  for (int idx = tid; idx < rows; idx += nt) {
    const int piv = idx / b;
    const int j = idx - piv * b;
    const int p = first + piv * step;
    const T* L = Xw + p * bb;
    T* X = Dw + p * bb;
    X[j * b + j] = L[j * b + j];
    for (int i = j + 1; i < b; ++i) {
      T acc = L[i * b + j] * X[j * b + j];
      for (int k = j + 1; k < i; ++k) acc += L[i * b + k] * X[k * b + j];
      X[i * b + j] = (T(0) - acc) * L[i * b + i];
    }
  }
  __syncthreads();
  // Pinv[i][j] = sum_{k >= max(i, j)} X[k][i] X[k][j]
  const int elems = npiv * bb;
  for (int e = tid; e < elems; e += nt) {
    const int piv = e / bb;
    const int rem = e - piv * bb;
    const int i = rem / b, j = rem - (rem / b) * b;
    const int p = first + piv * step;
    const T* X = Dw + p * bb;
    const int lo = i > j ? i : j;
    T acc = X[lo * b + i] * X[lo * b + j];
    for (int k = lo + 1; k < b; ++k) acc += X[k * b + i] * X[k * b + j];
    Pinv[p * bb + rem] = acc;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
cr_factor_kernel(const T* __restrict__ D, const T* __restrict__ E, T* Pinv,
                 T* Eb, T* Ea, T* Dw, T* Ew, T* Xw, int N, int b) {
  const int tid = threadIdx.x, nt = blockDim.x, bb = b * b;
  const int total = N * bb;
  const int64_t inst = static_cast<int64_t>(blockIdx.x);
  D += inst * total;
  E += inst * (total - bb);
  Pinv += inst * total;
  Eb += inst * total;
  Ea += inst * total;
  Dw += inst * total;
  Ew += inst * total;
  Xw += inst * total;

  // working copies; Ew[q] couples q and q + s at the current level
  for (int e = tid; e < total; e += nt) {
    Dw[e] = D[e];
    Ew[e] = e < total - bb ? E[e] : T(0);
    if (e < bb) {
      Eb[e] = T(0);
      Ea[e] = T(0);
    }
  }
  __syncthreads();

  for (int s = 1; s < N; s <<= 1) {
    const int npiv = (N + s - 1) / (2 * s);
    chol_inv_phase(Dw, Xw, Pinv, npiv, s, 2 * s, b);

    // per odd p: keep its couplings, T = Pinv Eb -> Xw[p],
    // G = Ea Pinv -> Dw[p] (both workspaces are dead after the inverse)
    for (int e = tid; e < npiv * bb; e += nt) {
      const int piv = e / bb;
      const int rem = e - piv * bb;
      const int i = rem / b, j = rem - (rem / b) * b;
      const int p = (2 * piv + 1) * s;
      const T* Pi = Pinv + p * bb;
      const T* eb = Ew + (p - s) * bb;
      const T* ea = Ew + p * bb;
      Eb[p * bb + rem] = eb[rem];
      Ea[p * bb + rem] = ea[rem];
      T t = Pi[i * b] * eb[j];
      T g = ea[i * b] * Pi[j];
      for (int k = 1; k < b; ++k) {
        t += Pi[i * b + k] * eb[k * b + j];
        g += ea[i * b + k] * Pi[k * b + j];
      }
      Xw[p * bb + rem] = t;
      Dw[p * bb + rem] = g;
    }
    __syncthreads();

    // per even q: D[q] -= Eb^T T of its right odd, then Ea Pinv Ea^T of
    // its left odd; the new coupling of q to q + 2s is -Ea T
    const int neven = (N + 2 * s - 1) / (2 * s);
    for (int e = tid; e < neven * bb; e += nt) {
      const int m = e / bb;
      const int rem = e - m * bb;
      const int i = rem / b, j = rem - (rem / b) * b;
      const int q = 2 * s * m;
      T de = Dw[q * bb + rem];
      T enew = T(0);
      const int pr = q + s;
      if (pr < N) {
        const T* eb = Eb + pr * bb;
        const T* t = Xw + pr * bb;
        T acc = eb[i] * t[j];
        for (int k = 1; k < b; ++k) acc += eb[k * b + i] * t[k * b + j];
        de -= acc;
        if (pr + s < N) {
          const T* ea = Ea + pr * bb;
          T a2 = ea[i * b] * t[j];
          for (int k = 1; k < b; ++k) a2 += ea[i * b + k] * t[k * b + j];
          enew = -a2;
        }
      }
      if (q > 0) {
        const T* g = Dw + (q - s) * bb;
        const T* ea = Ea + (q - s) * bb;
        T acc = g[i * b] * ea[j * b];
        for (int k = 1; k < b; ++k) acc += g[i * b + k] * ea[j * b + k];
        de -= acc;
      }
      Dw[q * bb + rem] = de;
      Ew[q * bb + rem] = enew;
    }
    __syncthreads();
  }
  chol_inv_phase(Dw, Xw, Pinv, 1, 0, 1, b);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
cr_solve_kernel(const T* __restrict__ Pinv, const T* __restrict__ Eb,
                const T* __restrict__ Ea, const T* __restrict__ r, T* x,
                T* Rw, T* Gw, int N, int b, int k) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int bb = b * b, bk = b * k;
  const int64_t inst = static_cast<int64_t>(blockIdx.x);
  Pinv += inst * N * bb;
  Eb += inst * N * bb;
  Ea += inst * N * bb;
  r += inst * N * bk;
  x += inst * N * bk;
  Rw += inst * N * bk;
  Gw += inst * N * bk;

  for (int e = tid; e < N * bk; e += nt) Rw[e] = r[e];
  __syncthreads();

  // down-sweep; the odd entries of Rw keep their value at their level
  int top = 0;
  for (int s = 1; s < N; s <<= 1) {
    top = s;
    const int npiv = (N + s - 1) / (2 * s);
    for (int e = tid; e < npiv * bk; e += nt) {
      const int piv = e / bk;
      const int rem = e - piv * bk;
      const int i = rem / k, c = rem - (rem / k) * k;
      const int p = (2 * piv + 1) * s;
      const T* Pi = Pinv + p * bb + i * b;
      const T* R = Rw + p * bk + c;
      T acc = Pi[0] * R[0];
      for (int j = 1; j < b; ++j) acc += Pi[j] * R[j * k];
      Gw[p * bk + rem] = acc;
    }
    __syncthreads();
    const int neven = (N + 2 * s - 1) / (2 * s);
    for (int e = tid; e < neven * bk; e += nt) {
      const int m = e / bk;
      const int rem = e - m * bk;
      const int i = rem / k, c = rem - (rem / k) * k;
      const int q = 2 * s * m;
      T v = Rw[q * bk + rem];
      if (q + s < N) {
        const T* eb = Eb + (q + s) * bb + i;
        const T* g = Gw + (q + s) * bk + c;
        T acc = eb[0] * g[0];
        for (int j = 1; j < b; ++j) acc += eb[j * b] * g[j * k];
        v -= acc;
      }
      if (q > 0) {
        const T* ea = Ea + (q - s) * bb + i * b;
        const T* g = Gw + (q - s) * bk + c;
        T acc = ea[0] * g[0];
        for (int j = 1; j < b; ++j) acc += ea[j] * g[j * k];
        v -= acc;
      }
      Rw[q * bk + rem] = v;
    }
    __syncthreads();
  }

  // root
  for (int e = tid; e < bk; e += nt) {
    const int i = e / k, c = e - (e / k) * k;
    const T* Pi = Pinv + i * b;
    const T* R = Rw + c;
    T acc = Pi[0] * R[0];
    for (int j = 1; j < b; ++j) acc += Pi[j] * R[j * k];
    x[e] = acc;
  }
  __syncthreads();

  // up-sweep
  for (int s = top; s >= 1; s >>= 1) {
    const int npiv = (N + s - 1) / (2 * s);
    for (int e = tid; e < npiv * bk; e += nt) {
      const int piv = e / bk;
      const int rem = e - piv * bk;
      const int i = rem / k, c = rem - (rem / k) * k;
      const int p = (2 * piv + 1) * s;
      T v = Rw[p * bk + rem];
      {
        const T* eb = Eb + p * bb + i * b;
        const T* xl = x + (p - s) * bk + c;
        T acc = eb[0] * xl[0];
        for (int j = 1; j < b; ++j) acc += eb[j] * xl[j * k];
        v -= acc;
      }
      if (p + s < N) {
        const T* ea = Ea + p * bb + i;
        const T* xr = x + (p + s) * bk + c;
        T acc = ea[0] * xr[0];
        for (int j = 1; j < b; ++j) acc += ea[j * b] * xr[j * k];
        v -= acc;
      }
      Gw[p * bk + rem] = v;
    }
    __syncthreads();
    for (int e = tid; e < npiv * bk; e += nt) {
      const int piv = e / bk;
      const int rem = e - piv * bk;
      const int i = rem / k, c = rem - (rem / k) * k;
      const int p = (2 * piv + 1) * s;
      const T* Pi = Pinv + p * bb + i * b;
      const T* g = Gw + p * bk + c;
      T acc = Pi[0] * g[0];
      for (int j = 1; j < b; ++j) acc += Pi[j] * g[j * k];
      x[p * bk + rem] = acc;
    }
    __syncthreads();
  }
}

// Threads for one instance: the widest phase's element count rounded up
// to a warp, at most kMaxThreads.
int threads_for(int64_t elements) {
  int64_t t = (elements + 31) / 32 * 32;
  if (t < 32) t = 32;
  if (t > kMaxThreads) t = kMaxThreads;
  return static_cast<int>(t);
}

template <typename T>
int launch_factor(const T* D, const T* E, T* Pinv, T* Eb, T* Ea, T* Dw,
                  T* Ew, T* Xw, int N, int b, int64_t B,
                  cudaStream_t stream) {
  const int threads = threads_for(static_cast<int64_t>((N + 1) / 2) * b * b);
  cr_factor_kernel<T><<<static_cast<unsigned int>(B), threads, 0, stream>>>(
      D, E, Pinv, Eb, Ea, Dw, Ew, Xw, N, b);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_solve(const T* Pinv, const T* Eb, const T* Ea, const T* r, T* x,
                 T* Rw, T* Gw, int N, int b, int k, int64_t B,
                 cudaStream_t stream) {
  const int threads = threads_for(static_cast<int64_t>((N + 1) / 2) * b * k);
  cr_solve_kernel<T><<<static_cast<unsigned int>(B), threads, 0, stream>>>(
      Pinv, Eb, Ea, r, x, Rw, Gw, N, b, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each launcher enqueues one kernel on `stream` and returns
// cudaGetLastError() (0 on success).  Pointers are device pointers to
// contiguous arrays with the batch axis first: D, Pinv, Eb, Ea and the
// scratch Dw, Ew, Xw are (B, N, b, b); E is (B, N-1, b, b); r, x and the
// scratch Rw, Gw are (B, N, b, k).  The caller guarantees N, b, k, B > 0
// and N * b * max(b, k) < 2^31.
extern "C" {

int ipmzoo_cr_factor_f32(const float* D, const float* E, float* Pinv,
                         float* Eb, float* Ea, float* Dw, float* Ew,
                         float* Xw, int N, int b, long long B,
                         void* stream) {
  return launch_factor<float>(D, E, Pinv, Eb, Ea, Dw, Ew, Xw, N, b, B,
                              static_cast<cudaStream_t>(stream));
}

int ipmzoo_cr_factor_f64(const double* D, const double* E, double* Pinv,
                         double* Eb, double* Ea, double* Dw, double* Ew,
                         double* Xw, int N, int b, long long B,
                         void* stream) {
  return launch_factor<double>(D, E, Pinv, Eb, Ea, Dw, Ew, Xw, N, b, B,
                               static_cast<cudaStream_t>(stream));
}

int ipmzoo_cr_solve_f32(const float* Pinv, const float* Eb, const float* Ea,
                        const float* r, float* x, float* Rw, float* Gw,
                        int N, int b, int k, long long B, void* stream) {
  return launch_solve<float>(Pinv, Eb, Ea, r, x, Rw, Gw, N, b, k, B,
                             static_cast<cudaStream_t>(stream));
}

int ipmzoo_cr_solve_f64(const double* Pinv, const double* Eb,
                        const double* Ea, const double* r, double* x,
                        double* Rw, double* Gw, int N, int b, int k,
                        long long B, void* stream) {
  return launch_solve<double>(Pinv, Eb, Ea, r, x, Rw, Gw, N, b, k, B,
                              static_cast<cudaStream_t>(stream));
}

}  // extern "C"
