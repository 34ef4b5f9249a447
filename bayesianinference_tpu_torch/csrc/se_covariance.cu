// Squared-exponential covariance assembly for Hopper (sm_90a).
//
// Replaces: bayesianinference_tpu/ops/gp_kernels.py, `_se_cov_kernel`
// (launched by `se_covariance_pallas`).
//
//   K[b, i, j] = variance[b] * exp(-0.5 * sum_k (x1[b, i, k] - x2[b, j, k])^2)
//
// Inputs are already divided by the lengthscale (ARD works), so the kernel
// has no lengthscale argument; the nugget is added by the caller, as in the
// JAX package.
//
// What bounds it on this card: writing B * n1 * n2 output elements.  At the
// slice's shape (B = 10, n = 512, d = 3, float64) that is 21 MB per call
// against 2 * B * n * d * 8 = 0.25 MB of input, and 3d + 2 flops per
// element, so the kernel is store-bound (HBM bandwidth), far from any
// arithmetic limit.
//
// What the design does about it: one 32 x 32 output tile per block, the
// block's 32 rows of x1 and 32 rows of x2 staged once in shared memory in
// chunks of 32 features, the distance accumulated in a register, and
// var * exp(...) applied in the epilogue, so each output element is written
// exactly once, coalesced along j, and nothing else touches device memory.
// The Pallas kernel used the MXU Gram identity |a|^2 + |b|^2 - 2 a.b; here
// the direct difference is used instead: it is cheap at small d, avoids the
// identity's cancellation, and keeps K bitwise symmetric when x1 is x2
// (entry (i, j) and (j, i) sum the same squares in the same order of k,
// and (a - b)^2 == (b - a)^2 exactly).  Ragged edges (any n, any d) are
// masked.  No fast-math: full-accuracy exp.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;   // output tile edge, and the feature chunk

__device__ __forceinline__ float exp_full(float v) { return expf(v); }
__device__ __forceinline__ double exp_full(double v) { return exp(v); }

template <typename T>
__global__ void __launch_bounds__(kTile * kTile)
se_covariance_kernel(const T* __restrict__ x1, const T* __restrict__ x2,
                     const T* __restrict__ variance, T* __restrict__ out,
                     int batch, int n1, int n2, int d) {
  __shared__ T s1[kTile][kTile + 1];
  __shared__ T s2[kTile][kTile + 1];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const int i = i0 + ty;
  const int j = j0 + tx;

  for (int b = blockIdx.z; b < batch; b += gridDim.z) {
    const T* a = x1 + static_cast<size_t>(b) * n1 * d;
    const T* c = x2 + static_cast<size_t>(b) * n2 * d;
    T acc = T(0);
    for (int k0 = 0; k0 < d; k0 += kTile) {
      // thread (tx, ty) stages feature k0 + tx of row ty of each side
      const int k = k0 + tx;
      s1[ty][tx] = (i0 + ty < n1 && k < d) ? a[static_cast<size_t>(i0 + ty) * d + k] : T(0);
      s2[ty][tx] = (j0 + ty < n2 && k < d) ? c[static_cast<size_t>(j0 + ty) * d + k] : T(0);
      __syncthreads();
      const int kmax = min(kTile, d - k0);
      for (int kk = 0; kk < kmax; ++kk) {
        const T diff = s1[ty][kk] - s2[tx][kk];
        acc += diff * diff;
      }
      __syncthreads();
    }
    if (i < n1 && j < n2) {
      out[static_cast<size_t>(b) * n1 * n2 + static_cast<size_t>(i) * n2 + j] =
          variance[b] * exp_full(T(-0.5) * acc);
    }
  }
}

template <typename T>
int launch(const T* x1, const T* x2, const T* variance, T* out, int batch,
           int n1, int n2, int d, cudaStream_t stream) {
  if (batch <= 0 || n1 <= 0 || n2 <= 0) return cudaGetLastError();
  dim3 block(kTile, kTile);
  dim3 grid((n2 + kTile - 1) / kTile, (n1 + kTile - 1) / kTile,
            batch < 65535 ? batch : 65535);
  se_covariance_kernel<T><<<grid, block, 0, stream>>>(x1, x2, variance, out,
                                                      batch, n1, n2, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bi_se_covariance_f32(const float* x1, const float* x2,
                                    const float* variance, float* out,
                                    int batch, int n1, int n2, int d,
                                    cudaStream_t stream) {
  return launch<float>(x1, x2, variance, out, batch, n1, n2, d, stream);
}

extern "C" int bi_se_covariance_f64(const double* x1, const double* x2,
                                    const double* variance, double* out,
                                    int batch, int n1, int n2, int d,
                                    cudaStream_t stream) {
  return launch<double>(x1, x2, variance, out, batch, n1, n2, d, stream);
}
