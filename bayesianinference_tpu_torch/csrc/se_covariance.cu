// Squared-exponential covariance assembly for Hopper (sm_90a), one launch
// and one pass over K for the whole assembly.
//
// Replaces: bayesianinference_tpu/ops/gp_kernels.py, `se_covariance_pallas`
// and its kernel `_se_cov_kernel` (scale by the lengthscale, exponentiate,
// add the nugget to the diagonal).
//
//   K[b, i, j] = variance[b] * exp(-0.5 * sum_k ((x1[b,i,k] - x2[b,j,k]) / l[b,k])^2)
//                + [i == j] * nugget[b, i]
//
// x2 == nullptr means "x2 is x1" (the symmetric call; only it takes a
// nugget).  l == nullptr means 1, nugget == nullptr means 0.  The kernel
// takes the lengthscale itself and inverts it once per warp (lane k divides,
// a shuffle hands 1 / l_k round), so that no kernel runs before it.  Every
// operand is read through the strides it is given, so data shared by the
// whole batch (batch stride 0), a scalar lengthscale (feature stride 0) and
// a scalar nugget (row stride 0) are never expanded into copies, and the
// unscaled data goes in once.
//
// What bounds it on this card: writing B * n1 * n2 output elements.  At the
// main path's shape (B = 10, n = 512, d = 3, float64) that is 21 MB per call
// against 12 KB of input and 3d + 3 flops per element: store-bound.  Beside
// the stores, the full-accuracy double-precision exp (some 25 DFMA on 64
// FP64 lanes per SM) is the one stage of comparable length, so the design
// halves it where it can and hides the rest behind the stores.
//
// What the design does about it:
//   * 256-thread blocks (128 for the float32 32 x 32 tile), a register
//     micro-tile per thread whose columns sit in 16-byte groups, so a thread
//     amortizes its row loads and index arithmetic over its entries and
//     writes `double2` / `float4` vectors, 256 contiguous bytes per
//     half-warp.  Scalar stores only on ragged edges and where rows of K are
//     not 16-byte aligned (n2 not a multiple of the vector width).
//   * the tile edge is picked from what the card measured (chip_probe.py).
//     The symmetric call takes 32 x 32 tiles (2 x 2 doubles or 2 x 4 floats
//     per thread): the planned 64 x 64 tile with a 4 x 4 double micro-tile
//     needs 142 registers at d = 3, which leaves one block per SM, and
//     measured slower at every shape (0.0106 against 0.0092 ms at B = 10,
//     n = 512; 0.1708 against 0.1686 ms at B = 1, n = 8192, where the small
//     tile is at 95 % of the bytes bound); in float32 the two edges are
//     level up to thousands of tiles and the 64 x 64 tile wins only far
//     above (0.3339 against 0.3532 ms at n = 16384), so it is taken from
//     128 tiles per SM on.  The two-input call computes every entry, and
//     there the 4 x 4 micro-tile's fewer loads per entry pay as soon as
//     the card is full (0.1148 against 0.1457 ms at B = 10, n = 2048,
//     float64): 64 x 64 from two tiles per SM on, 32 x 32 below, where the
//     finer grain fills the 132 SMs.  Both edges stay reachable (`tile`).
//   * d <= 8 (templated; the main path's d = 3): the thread's rows of x1 and
//     x2 come straight from global memory through the read-only path into
//     registers, with no shared memory and no barrier.  Larger d goes
//     through shared memory in chunks of 16 features (plain loads; the
//     inputs are a few KB and live in L1/L2, so an asynchronous pipeline
//     has nothing to hide).
//   * the symmetric call launches only the tiles on or below the diagonal
//     (a triangular tile index), writes each tile from registers and its
//     transpose through a padded shared-memory tile, so both stores are
//     coalesced: half the differences and half the exp.  K is bitwise
//     symmetric by construction, and a mirrored entry equals, bit for bit,
//     what the two-input call computes there: (a - b)^2 == (b - a)^2 and the
//     same order of k.  Diagonal tiles are computed whole and add the nugget.
//   * direct differences, not the Pallas kernel's Gram identity: no
//     cancellation, cheap at small d.
//   * streaming (evict-first) stores.  The plan was write-back stores, so
//     that the Cholesky finds a 21 MB K in the 50 MB L2; measured, the
//     streaming stores are faster at every size (0.0092 against 0.0107 ms
//     at B = 10, n = 512, float64; 0.3338 against 0.4253 ms at n = 16384,
//     float32) and the covariance-then-Cholesky pair is no slower for them
//     (0.2827 against 0.2841 ms), so the kernel streams;
//     -DSE_WRITE_BACK_STORES builds the other for comparison.  Bulk
//     asynchronous copies of staged tile rows (cp.async.bulk) were tried in
//     their place and are slower (0.0172 against 0.0092 ms).
// Kept: full-accuracy exp (no fast-math), any n and d, any batch (grid-stride
// over b), NaN in gives NaN out, no atomics, one kernel per call.
// (Times: NVIDIA H100 80GB HBM3, 700.00 W; chip_probe.py.)
//
// chip_probe.py builds copies with one stage switched off at a time
// (-DSE_PROBE_NO_EXP, -DSE_PROBE_NO_STORE, -DSE_PROBE_NO_MIRROR; their
// output is wrong, only their time counts), one with write-back stores and
// one with -DSE_BULK_STORE, whose whole 32 x 32 tiles leave shared memory
// by bulk asynchronous copies (its output is right, and the probe checks
// that).

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 16;  // feature chunk of the shared-memory path
// 64 x 64 tiles from this many of them per SM on, else 32 x 32
constexpr int kPerSmFor64TwoInput = 2;
constexpr int kPerSmFor64SymmetricF32 = 128;

template <typename T> struct Vec;
template <> struct Vec<double> { static constexpr int n = 2; };
template <> struct Vec<float> { static constexpr int n = 4; };

__device__ __forceinline__ float exp_full(float v) { return expf(v); }
__device__ __forceinline__ double exp_full(double v) { return exp(v); }

// Stores are streaming (st.global.cs: the line is marked evict-first in L2)
// unless built with -DSE_WRITE_BACK_STORES, the variant chip_probe.py times.
#ifdef SE_WRITE_BACK_STORES
#define SE_STORE(ptr, value) (*(ptr) = (value))
#else
#define SE_STORE(ptr, value) __stcs((ptr), (value))
#endif

// one 16-byte store of Vec<T>::n consecutive entries
__device__ __forceinline__ void store_vec(double* p, const double* v) {
  SE_STORE(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
}
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  SE_STORE(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}

template <typename T>
struct SeArgs {
  const T* x1;
  const T* x2;        // == x1 in the symmetric call
  const T* variance;
  const T* scale;     // the lengthscale; nullptr: 1
  const T* nugget;    // nullptr: 0 (symmetric call only)
  T* out;
  int batch, n1, n2, d;
  long long sx1, sx2, svar, sl_b, sl_k, snug_b, snug_i;  // strides in elements
  int tiles_j;  // tiles along j (two-input call)
  int same;     // x2 is x1: lower-triangle tiles, each mirrored
  int vec;      // rows of K are 16-byte aligned
};

// TS: tile edge.  MR: rows per thread.  CG: 16-byte column groups per thread.
// D: feature count held in registers (1..8), or 0 for the shared-memory path.
template <typename T, int TS, int MR, int CG, int D>
__global__ void __launch_bounds__((TS / MR) * (TS / (Vec<T>::n * CG)))
se_covariance_kernel(const SeArgs<T> a) {
  constexpr int V = Vec<T>::n;
  constexpr int MC = V * CG;            // columns per thread
  constexpr int TX = TS / MC;           // threads along j
  constexpr int TY = TS / MR;           // threads along i
  constexpr int NT = TX * TY;
  constexpr int PITCH = TS + 1;         // of the transposing tile
  constexpr int KP = kChunk + 1;        // of the staged feature chunks
  constexpr int SMEM = (D == 0 && 2 * TS * KP > TS * PITCH) ? 2 * TS * KP : TS * PITCH;
  __shared__ T sm[SMEM];

  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int lane = threadIdx.x % 32;

  int ti, tj;
  if (a.same) {  // blockIdx.x = ti (ti + 1) / 2 + tj, tj <= ti
    const int t = blockIdx.x;
    ti = static_cast<int>((sqrtf(8.0f * static_cast<float>(t) + 1.0f) - 1.0f) * 0.5f);
    while (ti * (ti + 1) / 2 > t) --ti;
    while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
    tj = t - ti * (ti + 1) / 2;
  } else {
    ti = blockIdx.x / a.tiles_j;
    tj = blockIdx.x % a.tiles_j;
  }
  const int i0 = ti * TS;
  const int j0 = tj * TS;
  const int n1 = a.n1, n2 = a.n2, d = a.d;

  // local rows li(r) = ty + TY r; local columns lj(c) = (c / V) V TX + tx V + c % V
  int rows[MR], cols[MC];  // clamped global indices for the loads
#pragma unroll
  for (int r = 0; r < MR; ++r) rows[r] = min(i0 + ty + TY * r, n1 - 1);
#pragma unroll
  for (int c = 0; c < MC; ++c) cols[c] = min(j0 + (c / V) * V * TX + tx * V + c % V, n2 - 1);

  for (int b = blockIdx.y; b < a.batch; b += gridDim.y) {
    const T* xa = a.x1 + static_cast<long long>(b) * a.sx1;
    const T* xb = a.x2 + static_cast<long long>(b) * a.sx2;
    const T* ls = a.scale ? a.scale + static_cast<long long>(b) * a.sl_b : nullptr;
    const T var = a.variance[static_cast<long long>(b) * a.svar];
    T* ob = a.out + static_cast<size_t>(b) * n1 * n2;

    T acc[MR][MC];
#pragma unroll
    for (int r = 0; r < MR; ++r)
#pragma unroll
      for (int c = 0; c < MC; ++c) acc[r][c] = T(0);

    if (D > 0) {
      // lane k inverts l_k; rows straight from global memory (read-only
      // path) into registers
      const T inv = (ls && lane < D) ? T(1) / __ldg(ls + lane * a.sl_k) : T(1);
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const T s = __shfl_sync(0xffffffffu, inv, k);
        T xr[MR], xc[MC];
#pragma unroll
        for (int r = 0; r < MR; ++r) xr[r] = __ldg(xa + static_cast<long long>(rows[r]) * D + k);
#pragma unroll
        for (int c = 0; c < MC; ++c) xc[c] = __ldg(xb + static_cast<long long>(cols[c]) * D + k);
#pragma unroll
        for (int r = 0; r < MR; ++r)
#pragma unroll
          for (int c = 0; c < MC; ++c) {
            const T t = (xr[r] - xc[c]) * s;
            acc[r][c] = fma(t, t, acc[r][c]);
          }
      }
    } else {
      T* s1 = sm;
      T* s2 = sm + TS * KP;
      for (int k0 = 0; k0 < d; k0 += kChunk) {
        for (int idx = threadIdx.x; idx < TS * kChunk; idx += NT) {
          const int row = idx / kChunk, kk = idx % kChunk;
          const bool in_k = k0 + kk < d;
          s1[row * KP + kk] = (in_k && i0 + row < n1) ? xa[static_cast<long long>(i0 + row) * d + k0 + kk] : T(0);
          s2[row * KP + kk] = (in_k && j0 + row < n2) ? xb[static_cast<long long>(j0 + row) * d + k0 + kk] : T(0);
        }
        const T inv = (ls && lane < kChunk && k0 + lane < d) ? T(1) / __ldg(ls + (k0 + lane) * a.sl_k) : T(1);
        __syncthreads();
        const int kmax = min(kChunk, d - k0);
        for (int kk = 0; kk < kmax; ++kk) {
          const T s = __shfl_sync(0xffffffffu, inv, kk);
          T xr[MR], xc[MC];
#pragma unroll
          for (int r = 0; r < MR; ++r) xr[r] = s1[(ty + TY * r) * KP + kk];
#pragma unroll
          for (int c = 0; c < MC; ++c) xc[c] = s2[((c / V) * V * TX + tx * V + c % V) * KP + kk];
#pragma unroll
          for (int r = 0; r < MR; ++r)
#pragma unroll
            for (int c = 0; c < MC; ++c) {
              const T t = (xr[r] - xc[c]) * s;
              acc[r][c] = fma(t, t, acc[r][c]);
            }
        }
        __syncthreads();
      }
    }

#pragma unroll
    for (int r = 0; r < MR; ++r)
#pragma unroll
      for (int c = 0; c < MC; ++c) {
#ifdef SE_PROBE_NO_EXP
        acc[r][c] = var * (T(-0.5) * acc[r][c]);
#else
        acc[r][c] = var * exp_full(T(-0.5) * acc[r][c]);
#endif
      }

    if (a.same && ti == tj && a.nugget) {
      const T* nug = a.nugget + static_cast<long long>(b) * a.snug_b;
#pragma unroll
      for (int r = 0; r < MR; ++r)
#pragma unroll
        for (int c = 0; c < MC; ++c)
          if (ty + TY * r == (c / V) * V * TX + tx * V + c % V)
            acc[r][c] += nug[static_cast<long long>(rows[r]) * a.snug_i];
    }

#ifdef SE_BULK_STORE
    // Variant, for comparison only: a whole tile (and its transpose) is
    // staged in shared memory and leaves as one bulk asynchronous copy per
    // row (cp.async.bulk, no tensor map).  32 x 32 tiles only: two staged
    // 64 x 64 tiles do not fit the static 48 KB.
    constexpr int BP = TS + V;  // row pitch, a multiple of 16 bytes
    constexpr bool kBulkFits = sizeof(T) * (SMEM + 2 * TS * BP) <= 48 * 1024;
    __shared__ __align__(16) T sb[kBulkFits ? 2 * TS * BP : 1];
    if (kBulkFits && a.vec && i0 + TS <= n1 && j0 + TS <= n2) {
      const bool mirror = a.same && ti != tj;
#pragma unroll
      for (int r = 0; r < MR; ++r)
#pragma unroll
        for (int c = 0; c < MC; ++c) {
          const int li = ty + TY * r, lj = (c / V) * V * TX + tx * V + c % V;
          sb[li * BP + lj] = acc[r][c];
          if (mirror) sb[TS * BP + lj * BP + li] = acc[r][c];
        }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
      if (threadIdx.x < TS) {
        const unsigned bytes = TS * sizeof(T);
        const int t = threadIdx.x;
        asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                     :: "l"(ob + static_cast<size_t>(i0 + t) * n2 + j0),
                        "r"(static_cast<unsigned>(__cvta_generic_to_shared(sb + t * BP))), "r"(bytes) : "memory");
        if (mirror)
          asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                       :: "l"(ob + static_cast<size_t>(j0 + t) * n2 + i0),
                          "r"(static_cast<unsigned>(__cvta_generic_to_shared(sb + TS * BP + t * BP))), "r"(bytes)
                       : "memory");
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      }
      __syncthreads();
      continue;
    }
#endif

    // the tile itself, from registers
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      const int i = i0 + ty + TY * r;
      bool live = i < n1;
#ifdef SE_PROBE_NO_STORE
      live = live && acc[r][0] == T(-1);
#endif
      if (live) {
        T* row = ob + static_cast<size_t>(i) * n2 + j0;
#pragma unroll
        for (int g = 0; g < CG; ++g) {
          const int jl = g * V * TX + tx * V;
          if (a.vec && j0 + jl + V <= n2) {
            store_vec(row + jl, &acc[r][g * V]);
          } else {
#pragma unroll
            for (int v = 0; v < V; ++v)
              if (j0 + jl + v < n2) SE_STORE(row + jl + v, acc[r][g * V + v]);
          }
        }
      }
    }

#ifndef SE_PROBE_NO_MIRROR
    // its transpose, through shared memory so that these stores run along rows too
    if (a.same && ti != tj) {
#pragma unroll
      for (int r = 0; r < MR; ++r)
#pragma unroll
        for (int c = 0; c < MC; ++c)
          sm[(ty + TY * r) * PITCH + (c / V) * V * TX + tx * V + c % V] = acc[r][c];
      __syncthreads();
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        const int lr = ty + TY * r;  // row of the mirrored tile = column of this one
        bool live = j0 + lr < n2;
        T* row = ob + static_cast<size_t>(j0 + lr) * n2 + i0;
#pragma unroll
        for (int g = 0; g < CG; ++g) {
          const int cl = g * V * TX + tx * V;
          T tmp[V];
#pragma unroll
          for (int v = 0; v < V; ++v) tmp[v] = sm[(cl + v) * PITCH + lr];
#ifdef SE_PROBE_NO_STORE
          live = live && tmp[0] == T(-1);
#endif
          if (!live) continue;
          if (a.vec && i0 + cl + V <= n1) {
            store_vec(row + cl, tmp);
          } else {
#pragma unroll
            for (int v = 0; v < V; ++v)
              if (i0 + cl + v < n1) SE_STORE(row + cl + v, tmp[v]);
          }
        }
      }
      __syncthreads();
    }
#endif
  }
}

template <typename T, int TS, int MR, int CG>
cudaError_t launch_tiles(SeArgs<T> a, cudaStream_t stream) {
  constexpr int NT = (TS / MR) * (TS / (Vec<T>::n * CG));
  const long long ti = (a.n1 + TS - 1) / TS, tj = (a.n2 + TS - 1) / TS;
  const long long tiles = a.same ? ti * (ti + 1) / 2 : ti * tj;
  if (tiles > 2147483647LL) return cudaErrorInvalidValue;
  a.tiles_j = static_cast<int>(tj);
  const dim3 grid(static_cast<unsigned>(tiles), a.batch < 65535 ? a.batch : 65535);
  switch (a.d) {
#define SE_CASE(D_) \
    case D_: se_covariance_kernel<T, TS, MR, CG, D_><<<grid, NT, 0, stream>>>(a); break;
    SE_CASE(1) SE_CASE(2) SE_CASE(3) SE_CASE(4) SE_CASE(5) SE_CASE(6) SE_CASE(7) SE_CASE(8)
#undef SE_CASE
    default: se_covariance_kernel<T, TS, MR, CG, 0><<<grid, NT, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

// tile: 0 picks the edge (see the header); 32 or 64 forces it.
template <typename T, int CG64>
int launch(const T* x1, const T* x2, const T* variance, const T* scale, const T* nugget, T* out,
           int batch, int n1, int n2, int d, long long sx1, long long sx2, long long svar,
           long long sl_b, long long sl_k, long long snug_b, long long snug_i, int tile,
           cudaStream_t stream) {
  if (batch <= 0 || n1 <= 0 || n2 <= 0) return static_cast<int>(cudaGetLastError());
  if (d < 0 || (nugget && x2) || (tile != 0 && tile != 32 && tile != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  SeArgs<T> a;
  a.x1 = x1;
  a.same = x2 == nullptr;
  a.x2 = a.same ? x1 : x2;
  a.sx2 = a.same ? sx1 : sx2;
  a.variance = variance; a.scale = scale; a.nugget = nugget; a.out = out;
  a.batch = batch; a.n1 = n1; a.n2 = a.same ? n1 : n2; a.d = d;
  a.sx1 = sx1; a.svar = svar; a.sl_b = sl_b; a.sl_k = sl_k; a.snug_b = snug_b; a.snug_i = snug_i;
  a.tiles_j = 0;
  a.vec = a.n2 % Vec<T>::n == 0 && reinterpret_cast<unsigned long long>(out) % 16 == 0;
  if (tile == 0 && a.same && Vec<T>::n == 2) tile = 32;
  if (tile == 0) {
    int device = 0, sms = 132;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    const long long ti = (a.n1 + 63) / 64, tj = (a.n2 + 63) / 64;
    const long long tiles = (a.same ? ti * (ti + 1) / 2 : ti * tj) * batch;
    const long long per_sm = a.same ? kPerSmFor64SymmetricF32 : kPerSmFor64TwoInput;
    tile = tiles >= per_sm * sms ? 64 : 32;
  }
  const cudaError_t err = tile == 64 ? launch_tiles<T, 64, 4, CG64>(a, stream)
                                     : launch_tiles<T, 32, 2, 1>(a, stream);
  return static_cast<int>(err);
}

}  // namespace

// x1, x2 (or null), variance, lengthscale (or null), nugget (or null), out, batch,
// n1, n2, d, the seven strides (elements), tile (0 auto | 32 | 64), stream
extern "C" int bi_se_covariance_f32(const float* x1, const float* x2, const float* variance, const float* lengthscale, const float* nugget, float* out, int batch, int n1, int n2, int d, long long sx1, long long sx2, long long svar, long long sl_b, long long sl_k, long long snug_b, long long snug_i, int tile, cudaStream_t stream) {
  return launch<float, 1>(x1, x2, variance, lengthscale, nugget, out, batch, n1, n2, d, sx1, sx2, svar,
                          sl_b, sl_k, snug_b, snug_i, tile, stream);
}

extern "C" int bi_se_covariance_f64(const double* x1, const double* x2, const double* variance, const double* lengthscale, const double* nugget, double* out, int batch, int n1, int n2, int d, long long sx1, long long sx2, long long svar, long long sl_b, long long sl_k, long long snug_b, long long snug_i, int tile, cudaStream_t stream) {
  return launch<double, 2>(x1, x2, variance, lengthscale, nugget, out, batch, n1, n2, d, sx1, sx2, svar,
                           sl_b, sl_k, snug_b, snug_i, tile, stream);
}
