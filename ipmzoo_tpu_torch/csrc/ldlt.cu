// Batched LDL^T factor (K2), single right-hand-side solve (K3) and
// multi right-hand-side solve (K4) for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (ipmzoo_tpu_torch/ops/cuda_ldlt.py).
//
// K2 ldlt_factor_kernel replaces the TPU kernel
//     ipmzoo_tpu/ops/pallas_ldlt.py:_factor_kernel
// K3 ldlt_solve_kernel replaces the TPU kernel
//     ipmzoo_tpu/ops/pallas_ldlt.py:_solve_kernel
// K4 ldlt_solve_matrix_kernel replaces the TPU kernel
//     ipmzoo_tpu/ops/pallas_ldlt.py:_solve_matrix_kernel
// Their plain versions are ipmzoo_tpu_torch/ops/ldlt.py:ldlt / solve_ldlt
// / solve_ldlt_matrix.
//
// What bounds them on this card.  The solver factors one small augmented
// KKT system per QP instance and per iteration: at n = 24 that is about
// 2.3 KB of f32 matrix per instance, read once and written once, for
// about 2.3k multiply-adds (n^3/6).  At ~1 FMA per byte moved the work
// sits far below the card's compute ridge, so the kernels are bound by
// memory traffic and, at the batch sizes of the solver's tail stages
// (a few hundred instances), by latency.
//
// Design.  One thread per QP instance, as the TPU kernels put one
// instance on each vector lane.  Matrices are stored structure-of-arrays,
// (n, n, B) with the batch index fastest, so the 32 threads of a warp
// that read element (i, j) of 32 neighbouring instances touch one
// contiguous 128-byte line (f32): every load and store is coalesced, and
// each instance's matrix crosses device memory once in and once out.
// The column loop re-reads finished columns of L, which stay in L1/L2.
// There is no shared-memory staging and no warp-level cooperation yet;
// n is a runtime argument.
//
// Arithmetic is plain IEEE: no fast-math flags.  An exactly-zero pivot,
// and only that, is replaced by pivot_floor, as in the plain version.
//
// K4 solves k right-hand sides against one factor (the Schur-complement
// IPM's H^-1 F^T panel: n = 64, k = 16, B = 512 blocks).  The TPU kernel
// reads each factor once for all k columns from VMEM.  Here the first
// design is one thread per (instance, column): the grid is
// (ceil(B / 128), k), so the threads of one warp are 32 neighbouring
// instances of the same column and every load and store is coalesced;
// the k threads of one instance re-read the same factor, which L1/L2
// serve after the first column (an f32 factor panel of 512 instances at
// n = 64 is 8 MB, far inside the 50 MB L2).  Rhs and solution are SoA
// (n, k, B).  The forward sweep accumulates each row in a register in
// the order of the plain version's column sweep; staging the factor in
// shared memory or wgmma are later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

// Offset of element (i, j) of instance 0 in an (n, n, B) SoA array.
__device__ __forceinline__ int64_t soa(int i, int j, int n, int64_t B) {
  return (static_cast<int64_t>(i) * n + j) * B;
}

template <typename T>
__global__ void ldlt_factor_kernel(const T* __restrict__ A,
                                   T* __restrict__ L, T* __restrict__ D,
                                   int n, int64_t B, T pivot_floor) {
  const int64_t b =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  A += b;
  L += b;
  D += b;
  for (int j = 0; j < n; ++j) {
    // d_j = A_jj - sum_{k<j} L_jk^2 D_k
    T d = A[soa(j, j, n, B)];
    for (int k = 0; k < j; ++k) {
      const T l = L[soa(j, k, n, B)];
      d -= l * (l * D[k * B]);
    }
    if (d == T(0)) d = pivot_floor;
    D[j * B] = d;
    for (int i = 0; i < j; ++i) L[soa(i, j, n, B)] = T(0);
    L[soa(j, j, n, B)] = T(1);
    // L_ij = (A_ij - sum_{k<j} L_ik L_jk D_k) / d_j
    for (int i = j + 1; i < n; ++i) {
      T s = A[soa(i, j, n, B)];
      for (int k = 0; k < j; ++k) {
        s -= L[soa(i, k, n, B)] * (L[soa(j, k, n, B)] * D[k * B]);
      }
      L[soa(i, j, n, B)] = s / d;
    }
  }
}

template <typename T>
__global__ void ldlt_solve_kernel(const T* __restrict__ L,
                                  const T* __restrict__ D,
                                  const T* __restrict__ rhs,
                                  T* __restrict__ x, int n, int64_t B) {
  const int64_t b =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  L += b;
  D += b;
  rhs += b;
  x += b;
  // forward sweep with the unit-lower L: y_i = b_i - sum_{k<i} L_ik y_k
  for (int i = 0; i < n; ++i) {
    T s = rhs[i * B];
    for (int k = 0; k < i; ++k) s -= L[soa(i, k, n, B)] * x[k * B];
    x[i * B] = s;
  }
  for (int i = 0; i < n; ++i) x[i * B] = x[i * B] / D[i * B];
  // backward sweep with L^T: x_i = z_i - sum_{k>i} L_ki x_k
  for (int i = n - 1; i >= 0; --i) {
    T s = x[i * B];
    for (int k = i + 1; k < n; ++k) s -= L[soa(k, i, n, B)] * x[k * B];
    x[i * B] = s;
  }
}

template <typename T>
__global__ void ldlt_solve_matrix_kernel(const T* __restrict__ L,
                                         const T* __restrict__ D,
                                         const T* __restrict__ rhs,
                                         T* __restrict__ x, int n, int k,
                                         int64_t B) {
  const int64_t b =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  // column blockIdx.y of the (n, k, B) rhs; rows are k * B apart
  const int64_t col = static_cast<int64_t>(blockIdx.y) * B;
  const int64_t row = static_cast<int64_t>(k) * B;
  L += b;
  D += b;
  rhs += col + b;
  x += col + b;
  // forward sweep with the unit-lower L: y_i = r_i - sum_{j<i} L_ij y_j,
  // subtracted in increasing j as the column-oriented sweep does
  for (int i = 0; i < n; ++i) {
    T s = rhs[i * row];
    for (int j = 0; j < i; ++j) s -= L[soa(i, j, n, B)] * x[j * row];
    x[i * row] = s;
  }
  for (int i = 0; i < n; ++i) x[i * row] = x[i * row] / D[i * B];
  // backward sweep with L^T: x_i = z_i - sum_{j>i} L_ji x_j
  for (int i = n - 1; i >= 0; --i) {
    T s = x[i * row];
    for (int j = i + 1; j < n; ++j) s -= L[soa(j, i, n, B)] * x[j * row];
    x[i * row] = s;
  }
}

unsigned int grid_for(int64_t B) {
  return static_cast<unsigned int>((B + kThreads - 1) / kThreads);
}

template <typename T>
int launch_factor(const T* A, T* L, T* D, int n, int64_t B, T pivot_floor,
                  cudaStream_t stream) {
  ldlt_factor_kernel<T><<<grid_for(B), kThreads, 0, stream>>>(
      A, L, D, n, B, pivot_floor);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_solve(const T* L, const T* D, const T* rhs, T* x, int n,
                 int64_t B, cudaStream_t stream) {
  ldlt_solve_kernel<T><<<grid_for(B), kThreads, 0, stream>>>(L, D, rhs, x,
                                                             n, B);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_solve_matrix(const T* L, const T* D, const T* rhs, T* x, int n,
                        int k, int64_t B, cudaStream_t stream) {
  const dim3 grid(grid_for(B), static_cast<unsigned int>(k));
  ldlt_solve_matrix_kernel<T><<<grid, kThreads, 0, stream>>>(L, D, rhs, x,
                                                             n, k, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each launcher enqueues one kernel on `stream` and returns
// cudaGetLastError() (0 on success).  Pointers are device pointers to
// contiguous SoA arrays: A, L (n, n, B); D, rhs, x (n, B) for K2/K3, and
// rhs, x (n, k, B) for K4.  The caller guarantees n > 0, B > 0 and
// 0 < k <= 65535.
extern "C" {

int ipmzoo_ldlt_factor_f32(const float* A, float* L, float* D, int n,
                           long long B, float pivot_floor, void* stream) {
  return launch_factor<float>(A, L, D, n, B, pivot_floor,
                              static_cast<cudaStream_t>(stream));
}

int ipmzoo_ldlt_factor_f64(const double* A, double* L, double* D, int n,
                           long long B, double pivot_floor, void* stream) {
  return launch_factor<double>(A, L, D, n, B, pivot_floor,
                               static_cast<cudaStream_t>(stream));
}

int ipmzoo_ldlt_solve_f32(const float* L, const float* D, const float* rhs,
                          float* x, int n, long long B, void* stream) {
  return launch_solve<float>(L, D, rhs, x, n, B,
                             static_cast<cudaStream_t>(stream));
}

int ipmzoo_ldlt_solve_f64(const double* L, const double* D,
                          const double* rhs, double* x, int n, long long B,
                          void* stream) {
  return launch_solve<double>(L, D, rhs, x, n, B,
                              static_cast<cudaStream_t>(stream));
}

int ipmzoo_ldlt_solve_matrix_f32(const float* L, const float* D,
                                 const float* rhs, float* x, int n, int k,
                                 long long B, void* stream) {
  return launch_solve_matrix<float>(L, D, rhs, x, n, k, B,
                                    static_cast<cudaStream_t>(stream));
}

int ipmzoo_ldlt_solve_matrix_f64(const double* L, const double* D,
                                 const double* rhs, double* x, int n, int k,
                                 long long B, void* stream) {
  return launch_solve_matrix<double>(L, D, rhs, x, n, k, B,
                                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
