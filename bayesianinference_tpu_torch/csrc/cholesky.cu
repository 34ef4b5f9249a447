// Batched blocked Cholesky factorization for Hopper (sm_90a).
//
// Replaces: bayesianinference_tpu/ops/gp_kernels.py, `_chol_pallas_kernel`
// (launched by `cholesky_pallas`).
//
//   L[b] = chol(K[b]), lower, with an exactly zero upper triangle.
//
// Only the lower triangle of K is read.  Any n is accepted (the ragged last
// panel is masked; the Pallas kernel needed n % 128 == 0).  A non-positive
// pivot gives sqrt(negative) = NaN (or a zero pivot gives 0/0), and that
// NaN propagates into every later diagonal entry: there is no clamping, no
// early exit and no info flag read back by the host.  The caller turns a
// non-finite diagonal into the log-zero sentinel, as XLA's Cholesky is
// treated in the JAX package.
//
// What bounds it on this card: at the slice's shape (B = 10, n = 512,
// float64) the factorization is n^3 / 3 = 45 Mflop per matrix, 0.45 Gflop
// per call, over 16 panels of width 32 with three dependent launches each,
// so the chain of 48 small launches (launch latency and one wave of tiny
// blocks per stage) bounds it rather than FP64 throughput or bandwidth.
// The Pallas kernel kept the whole matrix resident in VMEM (n up to ~1.4k);
// a block here has at most 227 KB of shared memory, so the matrix lives in
// device memory (in L2 at this size: 21 MB) and each stage stages 32 x 32
// tiles in shared memory.
//
// What the design does about it: right-looking, panel width 32, three
// kernels per panel, each gridded over the batch:
//   1. potrf: one block per matrix factors the 32 x 32 diagonal tile in
//      shared memory by an unblocked column loop;
//   2. trsm: one block per 32-row tile below the diagonal solves
//      X L_jj^T = A_panel by forward substitution against L_jj in shared
//      memory (the Pallas kernel built inv(L_jj)^T and multiplied instead);
//   3. syrk/gemm: one block per lower 32 x 32 tile pair of the trailing
//      matrix subtracts L_i L_k^T, from two shared-memory tiles, with FMA in
//      the working type.  No tensor cores and no TF32.
// All launches go to the caller's stream from one host call; nothing
// synchronizes.  Making it fast (one CTA per matrix for small n, DMMA
// tiles, CUDA graphs for the launch chain) is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kNb = 32;  // panel width and tile edge

__device__ __forceinline__ float sqrt_full(float v) { return sqrtf(v); }
__device__ __forceinline__ double sqrt_full(double v) { return sqrt(v); }

// L = lower(K) with zero upper triangle.
template <typename T>
__global__ void copy_lower_kernel(const T* __restrict__ k, T* __restrict__ l,
                                  int batch, int n) {
  const size_t total = static_cast<size_t>(batch) * n * n;
  for (size_t idx = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       idx < total; idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t rc = idx % (static_cast<size_t>(n) * n);
    const int r = static_cast<int>(rc / n);
    const int c = static_cast<int>(rc % n);
    l[idx] = (c <= r) ? k[idx] : T(0);
  }
}

// Factor the w x w diagonal tile at (c0, c0) of every matrix in place.
template <typename T>
__global__ void __launch_bounds__(kNb * kNb)
potrf_tile_kernel(T* __restrict__ l, int batch, int n, int c0, int w) {
  __shared__ T s[kNb][kNb + 1];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  for (int b = blockIdx.x; b < batch; b += gridDim.x) {
    T* m = l + static_cast<size_t>(b) * n * n;
    s[ty][tx] = (ty < w && tx <= ty)
                    ? m[static_cast<size_t>(c0 + ty) * n + c0 + tx]
                    : T(0);
    __syncthreads();
    for (int j = 0; j < w; ++j) {
      if (ty == j && tx == j) s[j][j] = sqrt_full(s[j][j]);
      __syncthreads();
      if (tx == j && ty > j && ty < w) s[ty][j] = s[ty][j] / s[j][j];
      __syncthreads();
      if (tx > j && tx <= ty && ty < w) s[ty][tx] -= s[ty][j] * s[tx][j];
      __syncthreads();
    }
    if (ty < w && tx <= ty) {
      m[static_cast<size_t>(c0 + ty) * n + c0 + tx] = s[ty][tx];
    }
    __syncthreads();
  }
}

// Rows r >= c0 + w of the panel: L[r, c0:c0+w] = A[r, c0:c0+w] L_jj^-T.
template <typename T>
__global__ void __launch_bounds__(kNb * kNb)
trsm_panel_kernel(T* __restrict__ l, int batch, int n, int c0, int w) {
  __shared__ T d[kNb][kNb + 1];
  __shared__ T p[kNb][kNb + 1];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int row = c0 + w + blockIdx.x * kNb + ty;
  for (int b = blockIdx.y; b < batch; b += gridDim.y) {
    T* m = l + static_cast<size_t>(b) * n * n;
    d[ty][tx] = (ty < w && tx <= ty)
                    ? m[static_cast<size_t>(c0 + ty) * n + c0 + tx]
                    : T(0);
    p[ty][tx] = (row < n && tx < w) ? m[static_cast<size_t>(row) * n + c0 + tx]
                                    : T(0);
    __syncthreads();
    for (int j = 0; j < w; ++j) {
      if (tx == j) p[ty][j] = p[ty][j] / d[j][j];
      __syncthreads();
      if (tx > j && tx < w) p[ty][tx] -= p[ty][j] * d[tx][j];
      __syncthreads();
    }
    if (row < n && tx < w) m[static_cast<size_t>(row) * n + c0 + tx] = p[ty][tx];
    __syncthreads();
  }
}

// Trailing update of the lower triangle below and right of the panel:
// A[i, k] -= sum_j L[i, c0 + j] L[k, c0 + j] for t0 <= k <= i < n.
template <typename T>
__global__ void __launch_bounds__(kNb * kNb)
syrk_trailing_kernel(T* __restrict__ l, int batch, int n, int c0, int w) {
  __shared__ T a[kNb][kNb + 1];
  __shared__ T c[kNb][kNb + 1];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int t0 = c0 + w;
  // blockIdx.x enumerates the lower tile pairs (ti >= tk) row by row
  const int pair = blockIdx.x;
  int ti = static_cast<int>((sqrtf(8.0f * pair + 1.0f) - 1.0f) * 0.5f);
  while ((ti + 1) * (ti + 2) / 2 <= pair) ++ti;
  while (ti * (ti + 1) / 2 > pair) --ti;
  const int tk = pair - ti * (ti + 1) / 2;
  const int i = t0 + ti * kNb + ty;
  const int k = t0 + tk * kNb + tx;
  const int ra = t0 + ti * kNb + ty;  // row staged into a[ty][*]
  const int rc = t0 + tk * kNb + ty;  // row staged into c[ty][*]
  for (int b = blockIdx.y; b < batch; b += gridDim.y) {
    T* m = l + static_cast<size_t>(b) * n * n;
    a[ty][tx] = (ra < n && tx < w) ? m[static_cast<size_t>(ra) * n + c0 + tx] : T(0);
    c[ty][tx] = (rc < n && tx < w) ? m[static_cast<size_t>(rc) * n + c0 + tx] : T(0);
    __syncthreads();
    if (i < n && k <= i) {
      T acc = T(0);
      for (int j = 0; j < w; ++j) acc += a[ty][j] * c[tx][j];
      m[static_cast<size_t>(i) * n + k] -= acc;
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const T* k, T* l, int batch, int n, cudaStream_t stream) {
  if (batch <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const int gb = batch < 65535 ? batch : 65535;
  {
    const size_t total = static_cast<size_t>(batch) * n * n;
    size_t blocks = (total + 255) / 256;
    if (blocks > 65535 * 8) blocks = 65535 * 8;
    copy_lower_kernel<T><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(k, l, batch, n);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 block(kNb, kNb);
  for (int c0 = 0; c0 < n; c0 += kNb) {
    const int w = (n - c0) < kNb ? (n - c0) : kNb;
    potrf_tile_kernel<T><<<gb, block, 0, stream>>>(l, batch, n, c0, w);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const int rest = n - c0 - w;
    if (rest <= 0) break;
    const int tiles = (rest + kNb - 1) / kNb;
    trsm_panel_kernel<T><<<dim3(tiles, gb), block, 0, stream>>>(l, batch, n, c0, w);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const int pairs = tiles * (tiles + 1) / 2;
    syrk_trailing_kernel<T><<<dim3(pairs, gb), block, 0, stream>>>(l, batch, n, c0, w);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaSuccess);
}

}  // namespace

extern "C" int bi_cholesky_f32(const float* k, float* l, int batch, int n,
                               cudaStream_t stream) {
  return launch<float>(k, l, batch, n, stream);
}

extern "C" int bi_cholesky_f64(const double* k, double* l, int batch, int n,
                               cudaStream_t stream) {
  return launch<double>(k, l, batch, n, stream);
}
