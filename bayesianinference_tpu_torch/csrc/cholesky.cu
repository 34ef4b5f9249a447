// Batched Cholesky factorization for Hopper (sm_90a), three paths.
//
// Replaces: bayesianinference_tpu/ops/gp_kernels.py, `_chol_pallas_kernel`
// (:500, launched by `cholesky_pallas`).
//
//   L[b] = chol(K[b]), lower, with an exactly zero upper triangle.
//
// Only the lower triangle of K is read.  Any n is accepted (ragged tiles
// are masked; the Pallas kernel needed n % 128 == 0).  A non-positive pivot
// gives sqrt(negative) = NaN (or a zero pivot gives 0/0), and that NaN
// propagates into every later diagonal entry: there is no clamping, no
// early exit and no info flag read back by the host.  No atomics: every
// sum runs in a fixed order, so a factorization repeats bit for bit.
//
// What bounds it on this card (H100 SXM: 3.35 TB/s; 67 TFLOP/s for FP32
// outside the tensor cores and for FP64 through them (DMMA)):
//   * B = 10, n = 512, float64 (the GP slice, every chain step; the
//     Laplace fit at B = 1): the lower triangle read once and the factor
//     written once are 31.5 MB, 9.4 us; the n^3 / 3 = 0.447 Gflop take
//     6.7 us.  Bytes bound it on paper; in practice the chain of 16
//     dependent panels does, so the design removes launches and barriers.
//   * B >= 64, n = 512, float64 (the predictive, the ELBO blocks, SMC):
//     bytes on paper (0.48 ms at B = 512); in practice the work of every
//     panel step, so the batch goes to the blocked path, whose every
//     launch spans it, with its trailing update on the tensor cores.
//   * B = 1, n = 16384, float32 (bench.py's GP logML+grad): n^3 / 3 =
//     1.466 Tflop, 21.9 ms at the FFMA rate; the bytes take 0.48 ms.
//     Operations bound it, so the trailing update runs near the FFMA peak
//     and moves few bytes per flop.  3xTF32 on the tensor cores (165
//     TFLOP/s for its three products) was built and measured: it left the
//     float32 logML 5-8 x further from float64 than FFMA, so float32
//     stays on FFMA (PERF.md, the Cholesky findings).
//
// The wrapper picks the path and its width from (B, n, dtype)
// (`_cholesky_route` in ops/gp_kernels.py, the measured crossovers):
//   B = 1:        n <= 256 fused (8 CTAs); n <= 2048 (float64) or 3072
//                 (float32) grid; blocked above;
//   2 <= B <= 16: n <= 640 fused (8 CTAs); blocked above;
//   B > 16:       n <= 256 fused (2 CTAs to B = 64, 1 above); blocked above.
//
// Fused path ("fused", C CTAs per matrix, C = 1, 2 or 8; "grid", every
// SM on one matrix at a time): ONE launch for the whole batch, right-looking
// with 32-wide panels; the working matrix is the output L in device memory.
// A group of CTAs factors one matrix: a thread-block cluster of C CTAs, or
// the whole grid of a cooperative launch (one CTA per SM).  Per panel:
//   1. every CTA of the group factors the 32 x 32 diagonal tile itself (one
//      warp, rows in registers, multipliers by shuffles).  Redoing it costs
//      each CTA the microseconds that one CTA would take, and spares the
//      barrier that handing it over would need;
//   2. the panel's row blocks below it go round robin over the group's
//      CTAs, up to eight at a time in a CTA: the CTA stages them in shared
//      memory, each warp solves one (a lane a row, in registers), and the
//      CTA writes them and the zeros of their mirrors in the upper triangle;
//   3. group barrier; the group updates the trailing lower triangle in
//      64 x 64 tiles, round robin, the next tile's panel rows and C entries
//      in flight (in registers) while one computes: float32 by 4 x 4 FFMA
//      register tiles, float64 on the FP64 tensor cores (DMMA,
//      mma.m8n8k4.f64: each warp a 16 x 32 block of 8 x 8 accumulators);
//   4. group barrier.
// The group is sized to the batch: 8 CTAs while B x 8 fits the card's
// SMs (the GP slice's B = 10), 2 and then 1 for the small matrices of
// large batches, so that no diagonal tile is factored eight times there;
// at B = 1 the grid takes the whole card to the matrix.  Reads of the working matrix bypass L1
// (`__ldcg`), which is not coherent across SMs, and each barrier follows a
// `__threadfence`.  Columns are scaled by rsqrt(pivot), computed beside
// sqrt(pivot), so the 32-step chains of the tile factor and the solve hold
// no division.
//
// Blocked path ("blocked": large n, and every n > 256 at B > 16, where
// the batch alone fills the card in every launch): right-looking with
// 256-wide panels, each factored as two 128-wide halves, six launches per panel
// (3 n / 128 in all):
//   1. diag: one CTA per matrix factors a half's 128 x 128 diagonal block
//      in shared memory by 32-wide inner panels (warp factor in
//      registers, rows solved in registers, inner update from 4 x 4
//      register tiles);
//   2. trsm: one CTA per 64 rows below solves them against the factored
//      block, 32 columns at a time, and writes the zeros of their mirror;
//   3. syrk, narrow: the first half updates the second half's columns;
//   4-5. diag and trsm of the second half;
//   6. syrk: one CTA per lower tile pair right of the panel subtracts
//      L_i L_k^T over all 256 panel columns, both operand panels streamed
//      through a 3-deep cp.async ring in shared memory, the C tile
//      prefetched into L2.  float64: 64 x 64 tiles on the FP64 tensor
//      cores (DMMA, mma.m8n8k4.f64).  float32: 128 x 128 tiles on FFMA,
//      4 x 16 outputs per thread from 16-byte shared-memory vectors.
// The diag and trsm stages stage their blocks by cp.async too, so their
// loads are in flight together.
// Why 256: a rank-nb update moves each trailing element once in and once
// out (8 B in float32, 16 B in float64) for 2 nb flops, nb / 4 flop/B in
// float32 and nb / 8 in float64.  At 67 TFLOP/s the ridge is 20 flop/B,
// cleared in both at 256 (64 and 32 flop/B).  The
// diagonal block stays 128 wide: 256 x 256 would not fit one CTA's shared
// memory.
//
// Accumulation order.  FFMA paths (float32): each output adds its
// products one panel column at a time, in order.  DMMA (float64 trailing
// updates): one fused step per 4 panel columns, in order (IEEE float64
// products and sums, so the results agree with the FFMA-order ones to a
// few ulps).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <mutex>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;            // every kernel: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;                // fused panel width and tile edge; inner panel width
constexpr int kLdT = kTile + 1;          // row stride of a staged 32 x 32 tile
constexpr int kWide = 64;                // trailing-update tile edge on the fused path
constexpr int kNb = 128;                 // half-panel width of the blocked path: its diagonal block
constexpr int kWidePanel = 2 * kNb;      // panel width of the blocked path's trailing update
constexpr int kTrsmRows = 64;            // panel rows per CTA of the blocked trsm
constexpr int kLd = kNb + 1;             // row stride of the blocked diag / trsm staging

__device__ __forceinline__ float sqrt_full(float v) { return sqrtf(v); }
__device__ __forceinline__ double sqrt_full(double v) { return sqrt(v); }
// 1 / sqrt(v) to about an ulp (float: the hardware estimate and one Newton
// step), computed beside sqrt(v) so that no division sits on the chain.
__device__ __forceinline__ float rsqrt_full(float v) {
  const float r = rsqrtf(v);
  return r * (1.5f - 0.5f * v * r * r);
}
__device__ __forceinline__ double rsqrt_full(double v) { return rsqrt(v); }

// Lower tile pair number t (row by row: (0,0), (1,0), (1,1), ...) -> (i, k).
__device__ __forceinline__ void decode_pair(int t, int& i, int& k) {
  i = static_cast<int>((sqrt(8.0 * t + 1.0) - 1.0) * 0.5);
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  while (i * (i + 1) / 2 > t) --i;
  k = t - i * (i + 1) / 2;
}

// One warp factors the 32 x 32 tile s (row stride ld) in place.  Lane r
// keeps row r in registers.  Column j is scaled by 1 / sqrt(pivot), which
// is also stored in dinv[j] for the solves that follow, and its entries
// reach the other lanes by shuffles (a broadcast through shared memory was
// tried: it slowed the blocked path's diag stage and made the float64
// fused kernel spill).  The square roots of the pivots, off the dependent
// chain, are taken once at the end.
// Reads the lower triangle, writes the factor with an exactly zero upper
// triangle.
template <typename T>
__device__ void factor_tile_warp(T* s, int ld, T* dinv) {
  const int lane = threadIdx.x & 31;
  T a[kTile];
  T piv_mine = T(0), inv_mine = T(0);
#pragma unroll
  for (int c = 0; c < kTile; ++c) a[c] = (c <= lane) ? s[lane * ld + c] : T(0);
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    const T piv = __shfl_sync(0xffffffffu, a[j], j);
    const T inv = rsqrt_full(piv);
    if (lane == j) {
      piv_mine = piv;
      inv_mine = inv;
    }
    a[j] = lane > j ? a[j] * inv : T(0);
#pragma unroll
    for (int k = j + 1; k < kTile; ++k) {
      const T lkj = __shfl_sync(0xffffffffu, a[j], k);
      if (lane >= k) a[k] -= a[j] * lkj;
    }
  }
#pragma unroll
  for (int c = 0; c < kTile; ++c) s[lane * ld + c] = a[c];
  s[lane * ld + lane] = sqrt_full(piv_mine);
  dinv[lane] = inv_mine;
}

// One thread solves x L^T = p for the 32 entries at p (in place), L the
// factored 32 x 32 tile at d (row stride ldd) with reciprocal diagonal
// dinv: forward substitution with x in registers.
template <typename T>
__device__ void solve_row(T* p, const T* d, int ldd, const T* dinv) {
  T x[kTile];
#pragma unroll
  for (int k = 0; k < kTile; ++k) {
    T v = p[k];
#pragma unroll
    for (int j = 0; j < k; ++j) v -= x[j] * d[k * ldd + j];
    x[k] = v * dinv[k];
  }
#pragma unroll
  for (int k = 0; k < kTile; ++k) p[k] = x[k];
}

// out[r][c] -= sum_{k < 32} a[r][k] b[c][k] for r < rows, c < cols (both
// multiples of 4), 4 x 4 outputs per thread summed in registers.  With
// kLower only c <= r is written (and all-upper 4 x 4 blocks are skipped).
template <typename T, bool kLower>
__device__ void update_slab(T* out, int ldo, const T* a, int lda, const T* b, int ldb, int rows, int cols) {
  const int tc = cols / 4;
  for (int t = threadIdx.x; t < (rows / 4) * tc; t += blockDim.x) {
    const int r0 = (t / tc) * 4, c0 = (t % tc) * 4;
    if (kLower && c0 > r0 + 3) continue;
    T acc[4][4] = {};
    for (int k = 0; k < kTile; ++k) {
      T av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a[(r0 + i) * lda + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = b[(c0 + j) * ldb + k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (!kLower || c0 + j <= r0 + i) out[(r0 + i) * ldo + c0 + j] -= acc[i][j];
  }
}

// ---------------------------------------------------------------------------
// Tensor-core tile products
// ---------------------------------------------------------------------------

// d += a b on an 8 x 8 x 4 float64 step: lane holds a = A[lane / 4][lane % 4],
// b = B[lane % 4][lane / 4] and D[lane / 4][2 (lane % 4) + {0, 1}].
__device__ __forceinline__ void dmma_8x8x4(double& d0, double& d1, double a, double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(d0), "+d"(d1)
      : "d"(a), "d"(b));
}

// Output s (0..15) of a thread in a 64 x 64 float64 tile computed on DMMA:
// warp w holds rows 16 (w / 2) + 8 i + g and columns 32 (w % 2) + 8 j + 2 t + e
// (g = lane / 4, t = lane % 4, s = 8 i + 2 j + e).
__device__ __forceinline__ void dmma_pos(int s, int& r, int& c) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  r = 16 * (warp / 2) + 8 * (s / 8) + lane / 4;
  c = 32 * (warp % 2) + 8 * ((s / 2) % 4) + 2 * (lane % 4) + s % 2;
}

// acc[s] += sum_{k < kK} pa[r][k] pb[c][k], (r, c) = dmma_pos(s), on DMMA;
// pa and pb hold the tile's 64 rows and 64 columns with row stride kLd
// (kLd % 16 == 4: the 8 rows x 4 columns of a fragment load fall on
// distinct banks).
template <int kLd, int kK>
__device__ __forceinline__ void dmma_product(const double* pa, const double* pb, double (&acc)[16]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const double* a = pa + (16 * (warp / 2) + lane / 4) * kLd + lane % 4;
  const double* b = pb + (32 * (warp % 2) + lane / 4) * kLd + lane % 4;
#pragma unroll
  for (int k0 = 0; k0 < kK; k0 += 4) {
    const double a0 = a[k0], a1 = a[8 * kLd + k0];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const double bj = b[8 * j * kLd + k0];
      dmma_8x8x4(acc[2 * j], acc[2 * j + 1], a0, bj);
      dmma_8x8x4(acc[8 + 2 * j], acc[9 + 2 * j], a1, bj);
    }
  }
}

// ---------------------------------------------------------------------------
// Fused path: one group of CTAs per matrix (a cluster, or the whole grid),
// one launch per call.
// ---------------------------------------------------------------------------

// The fused path's 64 x 64 trailing tile, 16 outputs per thread: its panel
// rows' row stride in shared memory, each output's place, and the product.
template <typename T> struct Fused;
template <> struct Fused<float> {
  static constexpr int kLdU = kTile + 1;  // a lane reads its own row: 33 spreads them over the banks
  // 4 x 4 FFMA register tile: rows uy + 16 i, columns ux + 16 j (s = 4 i + j)
  __device__ static void pos(int s, int& r, int& c) {
    r = threadIdx.x / 16 + 16 * (s / 4);
    c = threadIdx.x % 16 + 16 * (s % 4);
  }
  __device__ static void product(const float* pa, const float* pb, float (&acc)[16]) {
    const int ux = threadIdx.x % 16, uy = threadIdx.x / 16;
#pragma unroll
    for (int s = 0; s < 16; ++s) acc[s] = 0.0f;
    for (int kk = 0; kk < kTile; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = pa[(uy + 16 * i) * kLdU + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = pb[(ux + 16 * j) * kLdU + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[4 * i + j] += av[i] * bv[j];
    }
  }
};
template <> struct Fused<double> {
  static constexpr int kLdU = kTile + 4;  // DMMA fragment loads
  __device__ static void pos(int s, int& r, int& c) { dmma_pos(s, r, c); }
  __device__ static void product(const double* pa, const double* pb, double (&acc)[16]) {
#pragma unroll
    for (int s = 0; s < 16; ++s) acc[s] = 0.0;
    dmma_product<kLdU, kTile>(pa, pb, acc);
  }
};

// Shared memory of the fused kernel, in elements: the diagonal tile, its
// reciprocal diagonal, and one area that holds a 32 x 32 block per warp in
// stage 2 and the two 64-row panel blocks in stage 3.
template <typename T>
constexpr int fused_smem_elems() {
  constexpr int solve = kWarps * kTile * kLdT, update = 2 * kWide * Fused<T>::kLdU;
  return kTile * kLdT + kTile + (solve > update ? solve : update);
}

template <bool kGrid>
__device__ __forceinline__ void group_sync() {
  __threadfence();
  if constexpr (kGrid) {
    cg::this_grid().sync();
  } else {
    cg::this_cluster().sync();
  }
}

// The group is gridDim.x CTAs: a cluster of that size (kGrid false; the
// batch runs along gridDim.y), or the whole cooperative grid (kGrid true;
// the matrices of the batch one after the other).
template <typename T, bool kGrid>
__global__ void __launch_bounds__(kThreads)
fused_kernel(const T* k, T* l, int batch, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int ldu = Fused<T>::kLdU;
  T* d = reinterpret_cast<T*>(smem_raw);  // kTile x kLdT: the factored diagonal tile
  T* dinv = d + kTile * kLdT;              // kTile: its reciprocal diagonal
  T* work = dinv + kTile;                  // stage 2: a block per warp; stage 3: pa and pb
  T* pa = work;                            // kWide x ldu: panel rows of the output tile's rows
  T* pb = work + kWide * ldu;              // panel rows of its columns
  const int rank = blockIdx.x, group = gridDim.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nt = (n + kTile - 1) / kTile;
  const int px = threadIdx.x % kTile, py = threadIdx.x / kTile;  // moves panel rows py + 8 q, column px
  for (int b = blockIdx.y; b < batch; b += gridDim.y) {
    const T* km = k + static_cast<size_t>(b) * n * n;
    T* lm = l + static_cast<size_t>(b) * n * n;
    for (int p = 0; p < nt; ++p) {
      const int c0 = p * kTile;
      const int w = min(kTile, n - c0);
      const T* src = p == 0 ? km : lm;
      // 1. the diagonal tile (identity past w), factored in every CTA
      for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
        const int r = e / kTile, c = e % kTile;
        d[r * kLdT + c] = (r < w && c < w)
                              ? (c <= r ? __ldcg(src + static_cast<size_t>(c0 + r) * n + c0 + c) : T(0))
                              : (r == c ? T(1) : T(0));
      }
      __syncthreads();
      if (threadIdx.x < kTile) factor_tile_warp(d, kLdT, dinv);
      __syncthreads();
      // 2. the panel's row blocks below the tile, round robin over the
      // group's CTAs, up to one per warp at a time
      for (int base = p + 1 + rank; base < nt; base += group * kWarps) {
        const int blocks = min(kWarps, (nt - base + group - 1) / group);
        for (int e = threadIdx.x; e < blocks * kTile * kTile; e += kThreads) {
          const int q = e / (kTile * kTile), r = (e / kTile) % kTile, c = e % kTile;
          const int r0 = (base + group * q) * kTile;
          work[(q * kTile + r) * kLdT + c] =
              r0 + r < n ? __ldcg(src + static_cast<size_t>(r0 + r) * n + c0 + c) : T(0);
        }
        __syncthreads();
        if (warp < blocks) solve_row(work + (warp * kTile + lane) * kLdT, d, kLdT, dinv);
        __syncthreads();
        for (int e = threadIdx.x; e < blocks * kTile * kTile; e += kThreads) {
          const int q = e / (kTile * kTile), r = (e / kTile) % kTile, c = e % kTile;
          const int r0 = (base + group * q) * kTile;
          if (r0 + r < n) lm[static_cast<size_t>(r0 + r) * n + c0 + c] = work[(q * kTile + r) * kLdT + c];
          if (r0 + c < n) lm[static_cast<size_t>(c0 + r) * n + r0 + c] = T(0);  // the mirrored upper block
        }
        __syncthreads();
      }
      group_sync<kGrid>();
      // 3. rank 0 stores the diagonal tile (nothing reads it in this
      // stage); the trailing lower triangle in 64 x 64 tiles, round robin,
      // software-pipelined: the next tile's panel rows and C entries are
      // in flight (in registers) while this tile computes.
      if (rank == 0) {
        for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
          const int r = e / kTile, c = e % kTile;
          if (r < w && c < w) lm[static_cast<size_t>(c0 + r) * n + c0 + c] = d[r * kLdT + c];
        }
      }
      const int t0 = c0 + kTile;                   // first trailing row
      const int m = (n - t0 + kWide - 1) / kWide;  // tiles per side
      const int ntiles = m > 0 ? m * (m + 1) / 2 : 0;
      T va[kWide / 8], vb[kWide / 8], vc[16];
      auto fetch = [&](int t) {
        int ti, tk;
        decode_pair(t, ti, tk);
        const int r0 = t0 + ti * kWide, q0 = t0 + tk * kWide;
#pragma unroll
        for (int q = 0; q < kWide / 8; ++q) {
          const int r = py + 8 * q;
          va[q] = r0 + r < n ? __ldcg(lm + static_cast<size_t>(r0 + r) * n + c0 + px) : T(0);
          vb[q] = q0 + r < n ? __ldcg(lm + static_cast<size_t>(q0 + r) * n + c0 + px) : T(0);
        }
#pragma unroll
        for (int s = 0; s < 16; ++s) {
          int r, c;
          Fused<T>::pos(s, r, c);
          const bool keep = r0 + r < n && q0 + c < n && (ti != tk || c <= r);
          vc[s] = keep ? __ldcg(src + static_cast<size_t>(r0 + r) * n + q0 + c) : T(0);
        }
      };
      if (rank < ntiles) fetch(rank);
      for (int t = rank; t < ntiles; t += group) {
        int ti, tk;
        decode_pair(t, ti, tk);
        const int r0 = t0 + ti * kWide, q0 = t0 + tk * kWide;
        T cv[16];
#pragma unroll
        for (int q = 0; q < kWide / 8; ++q) {
          pa[(py + 8 * q) * ldu + px] = va[q];
          pb[(py + 8 * q) * ldu + px] = vb[q];
        }
#pragma unroll
        for (int s = 0; s < 16; ++s) cv[s] = vc[s];
        __syncthreads();
        if (t + group < ntiles) fetch(t + group);
        T acc[16];
        Fused<T>::product(pa, pb, acc);
#pragma unroll
        for (int s = 0; s < 16; ++s) {
          int r, c;
          Fused<T>::pos(s, r, c);
          if (r0 + r < n && q0 + c < n && (ti != tk || c <= r))
            lm[static_cast<size_t>(r0 + r) * n + q0 + c] = cv[s] - acc[s];
        }
        __syncthreads();
      }
      group_sync<kGrid>();
    }
  }
}

// ---------------------------------------------------------------------------
// Blocked path: diag, trsm, syrk per 128-wide panel.
// ---------------------------------------------------------------------------

// Copy kBytes from global to shared memory asynchronously; zero-fill
// where !valid (gmem must still be a mapped address).
template <int kBytes>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int size = valid ? kBytes : 0;
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(size));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(gmem), "n"(kBytes), "r"(size));
  }
}

// Start staging the rows x kNb block at g (row stride n) into s (row
// stride kLd) by element-wise cp.async, zero-filling at or past row
// `valid_rows` and column `valid_cols`.  Only the block's lower triangle is
// read afterwards, so its upper part may hold anything.
template <typename T>
__device__ void stage_block(T* s, const T* g, int n, int rows, int valid_rows, int valid_cols) {
  for (int e = threadIdx.x; e < rows * kNb; e += kThreads) {
    const int r = e / kNb, c = e % kNb;
    const bool ok = r < valid_rows && c < valid_cols;
    cp_async<sizeof(T)>(s + r * kLd + c, ok ? g + static_cast<size_t>(r) * n + c : g, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait for this thread's copies, then for the whole block's.
__device__ __forceinline__ void staged() {
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
}

// Factor the diagonal block at (c0, c0), width w = min(kNb, n - c0), of
// every matrix: read from src (K for the first panel, else L), written to
// L with its upper triangle zero.
template <typename T>
__global__ void __launch_bounds__(kThreads)
diag_block_kernel(const T* src, T* l, int batch, int n, int c0) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);  // kNb x kLd: the block
  T* dinv = s + kNb * kLd;                 // kNb: its reciprocal diagonal
  const int w = min(kNb, n - c0);
  for (int b = blockIdx.x; b < batch; b += gridDim.x) {
    const T* sm = src + static_cast<size_t>(b) * n * n;
    T* lm = l + static_cast<size_t>(b) * n * n;
    stage_block(s, sm + static_cast<size_t>(c0) * n + c0, n, kNb, w, w);
    staged();
    if (w < kNb) {  // the ragged last block: identity past w
      for (int e = threadIdx.x; e < kNb * kNb; e += kThreads) {
        const int r = e / kNb, c = e % kNb;
        if (r >= w || c >= w) s[r * kLd + c] = r == c ? T(1) : T(0);
      }
      __syncthreads();
    }
    for (int q0 = 0; q0 < kNb; q0 += kTile) {
      if (threadIdx.x < kTile) factor_tile_warp(s + q0 * kLd + q0, kLd, dinv + q0);
      __syncthreads();
      const int below = kNb - q0 - kTile;
      if (below > 0) {
        T* rows = s + (q0 + kTile) * kLd;
        if (threadIdx.x < below) solve_row(rows + threadIdx.x * kLd + q0, s + q0 * kLd + q0, kLd, dinv + q0);
        __syncthreads();
        update_slab<T, true>(rows + q0 + kTile, kLd, rows + q0, kLd, rows + q0, kLd, below, below);
        __syncthreads();
      }
    }
    for (int e = threadIdx.x; e < w * w; e += kThreads) {
      const int r = e / w, c = e % w;
      lm[static_cast<size_t>(c0 + r) * n + c0 + c] = c <= r ? s[r * kLd + c] : T(0);
    }
    __syncthreads();
  }
}

// Rows c0 + kNb + kTrsmRows * blockIdx.x ... of the panel:
// L[r, c0:c0+kNb] = A[r, c0:c0+kNb] L_jj^-T, A read from src, L_jj from L;
// also the zeros of the mirrored upper block L[c0:c0+kNb, r].
template <typename T>
__global__ void __launch_bounds__(kThreads)
panel_trsm_kernel(const T* src, T* l, int batch, int n, int c0) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* d = reinterpret_cast<T*>(smem_raw);  // kNb x kLd: the factored block
  T* p = d + kNb * kLd;                   // kTrsmRows x kLd: this CTA's rows
  T* dinv = p + kTrsmRows * kLd;          // kNb: the block's reciprocal diagonal
  const int r0 = c0 + kNb + blockIdx.x * kTrsmRows;
  const int h = min(kTrsmRows, n - r0);
  for (int b = blockIdx.y; b < batch; b += gridDim.y) {
    const T* sm = src + static_cast<size_t>(b) * n * n;
    T* lm = l + static_cast<size_t>(b) * n * n;
    stage_block(d, lm + static_cast<size_t>(c0) * n + c0, n, kNb, kNb, kNb);
    stage_block(p, sm + static_cast<size_t>(r0) * n + c0, n, kTrsmRows, h, kNb);
    staged();
    if (threadIdx.x < kNb) dinv[threadIdx.x] = T(1) / d[threadIdx.x * (kLd + 1)];
    __syncthreads();
    for (int q0 = 0; q0 < kNb; q0 += kTile) {
      if (threadIdx.x < kTrsmRows) solve_row(p + threadIdx.x * kLd + q0, d + q0 * kLd + q0, kLd, dinv + q0);
      __syncthreads();
      if (q0 + kTile < kNb) {
        update_slab<T, false>(p + q0 + kTile, kLd, p + q0, kLd, d + (q0 + kTile) * kLd + q0, kLd, kTrsmRows,
                              kNb - q0 - kTile);
        __syncthreads();
      }
    }
    for (int e = threadIdx.x; e < kTrsmRows * kNb; e += kThreads) {
      const int r = e / kNb, c = e % kNb;
      if (r < h) lm[static_cast<size_t>(r0 + r) * n + c0 + c] = p[r * kLd + c];
    }
    for (int e = threadIdx.x; e < kTrsmRows * kNb; e += kThreads) {  // the mirrored upper block
      const int r = e % kTrsmRows, c = e / kTrsmRows;
      if (r < h) lm[static_cast<size_t>(c0 + c) * n + r0 + r] = T(0);
    }
    __syncthreads();
  }
}

// The syrk CTA's tiling: a kBm x kBm output tile, panel columns kBk at a
// time through a kStages-deep ring.  Rows of the staged panels are kBk + 4
// elements apart (kLds): 16-byte aligned for cp.async and vector loads, and
// the fragment loads fall on distinct banks.
template <typename T> struct Syrk;
// float32 on FFMA: a kTy x (256 / kTy) thread grid; thread (ty, tx) owns
// rows ty + kTy i and columns tx + kTx j, both operands read from shared
// memory as 16-byte vectors along k.
template <> struct Syrk<float> {
  static constexpr int kBm = 128;  // output tile edge
  static constexpr int kTy = 32;   // -> 4 rows x 16 columns per thread
  static constexpr int kBk = 32;   // panel columns per stage
  static constexpr int kStages = 3;  // cp.async ring depth
  static constexpr int kLds = kBk + 4;
  using Vec = float4;
  __device__ static void unpack(const Vec& v, float* o) { o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w; }
};
// float64 on DMMA: each warp a 16 x 32 block, kOut outputs per thread
// (placed by pos, summed by product).
template <> struct Syrk<double> {
  static constexpr int kBm = 64, kBk = 16, kStages = 3, kLds = kBk + 4, kOut = 16;
  __device__ static void pos(int s, int& r, int& c) { dmma_pos(s, r, c); }
  __device__ static void product(const double* a, const double* b, double (&acc)[kOut]) {
    dmma_product<kLds, kBk>(a, b, acc);
  }
};

template <typename T>
constexpr int syrk_smem_bytes() {
  return 2 * Syrk<T>::kStages * Syrk<T>::kBm * Syrk<T>::kLds * static_cast<int>(sizeof(T));
}

// Update of the lower triangle from row and column t0 on by the kw panel
// columns at c0: C -= A B^T for the tile pair (ti >= tk) that blockIdx.x
// numbers, A and B the panel rows of the two tiles read from L, C read
// from csrc (K where nothing has written L yet) and written to L.  With
// cols > 0 only the tiles of the first `cols` tile columns, blockIdx.x =
// ti * cols + tk.  The C tile is prefetched into L2 while the panels
// stream through shared memory.  kVec elements per cp.async: 16 / sizeof(T)
// where rows are 16-byte aligned, else 1.  float32 (FFMA register tiles);
// each output sums its products one panel column at a time, and each step
// of a thread's loop issues four independent FFMAs (one per row).
template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads, 2)
syrk_ffma_kernel(const T* csrc, T* l, int batch, int n, int c0, int kw, int t0, int cols) {
  using S = Syrk<T>;
  constexpr int kBm = S::kBm, kBk = S::kBk, kTy = S::kTy, kTx = kThreads / kTy;
  constexpr int kRm = kBm / kTy, kCm = kBm / kTx;          // outputs per thread: rows, columns
  constexpr int kV = 16 / static_cast<int>(sizeof(T));     // elements per shared-memory vector load
  constexpr int kLds = kBk + kV;                           // 16-byte rows, 4-bank skew
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kStages = S::kStages;
  T* as = reinterpret_cast<T*>(smem_raw);  // [kStages][kBm][kLds]
  T* bs = as + kStages * kBm * kLds;
  int ti, tk;
  if (cols > 0) {
    ti = blockIdx.x / cols;
    tk = blockIdx.x % cols;
    if (tk > ti) return;
  } else {
    decode_pair(blockIdx.x, ti, tk);
  }
  const int steps = kw / kBk;
  const int ra = t0 + ti * kBm;  // first row of the output tile
  const int rb = t0 + tk * kBm;  // first column
  const int tx = threadIdx.x % kTx, ty = threadIdx.x / kTx;
  for (int b = blockIdx.y; b < batch; b += gridDim.y) {
    const T* cm = csrc + static_cast<size_t>(b) * n * n;
    T* lm = l + static_cast<size_t>(b) * n * n;
    constexpr int kLines = kBm * static_cast<int>(sizeof(T)) / 128;  // 128-byte lines per tile row
    for (int e = threadIdx.x; e < kBm * kLines; e += kThreads) {
      const int r = ra + e / kLines, c = rb + (e % kLines) * (128 / static_cast<int>(sizeof(T)));
      if (r < n && c < n) asm volatile("prefetch.global.L2 [%0];\n" ::"l"(cm + static_cast<size_t>(r) * n + c));
    }
    auto load_stage = [&](int stage, int k0) {
      constexpr int kPerRow = kBk / kVec;
      for (int e = threadIdx.x; e < kBm * kPerRow; e += kThreads) {
        const int r = e / kPerRow, kk = (e % kPerRow) * kVec;
        const int ga = ra + r, gb = rb + r;
        cp_async<kVec * sizeof(T)>(as + (stage * kBm + r) * kLds + kk,
                                   lm + static_cast<size_t>(min(ga, n - 1)) * n + c0 + k0 + kk, ga < n);
        cp_async<kVec * sizeof(T)>(bs + (stage * kBm + r) * kLds + kk,
                                   lm + static_cast<size_t>(min(gb, n - 1)) * n + c0 + k0 + kk, gb < n);
      }
      asm volatile("cp.async.commit_group;\n" ::);
    };
    T acc[kRm][kCm];
#pragma unroll
    for (int i = 0; i < kRm; ++i)
#pragma unroll
      for (int j = 0; j < kCm; ++j) acc[i][j] = T(0);
    // a ring of kStages buffers, kStages - 1 stages in flight; empty groups
    // past the last stage keep the wait count uniform
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < steps) load_stage(st, st * kBk);
      else asm volatile("cp.async.commit_group;\n" ::);
    }
    for (int step = 0; step < steps; ++step) {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
      __syncthreads();  // stage `step` has landed; stage step - 1 is consumed
      const int next = step + kStages - 1;
      if (next < steps) load_stage(next % kStages, next * kBk);
      else asm volatile("cp.async.commit_group;\n" ::);
      const T* a = as + (step % kStages) * kBm * kLds;
      const T* bm = bs + (step % kStages) * kBm * kLds;
#pragma unroll
      for (int kk = 0; kk < kBk; kk += kV) {
        T av[kRm][kV];
#pragma unroll
        for (int i = 0; i < kRm; ++i)
          S::unpack(*reinterpret_cast<const typename S::Vec*>(a + (ty + kTy * i) * kLds + kk), av[i]);
#pragma unroll
        for (int j = 0; j < kCm; ++j) {
          T bv[kV];
          S::unpack(*reinterpret_cast<const typename S::Vec*>(bm + (tx + kTx * j) * kLds + kk), bv);
#pragma unroll
          for (int v = 0; v < kV; ++v)
#pragma unroll
            for (int i = 0; i < kRm; ++i) acc[i][j] += av[i][v] * bv[v];
        }
      }
    }
    __syncthreads();  // the ring is refilled for the next matrix of the batch
#pragma unroll
    for (int i = 0; i < kRm; ++i) {
      const int r = ra + ty + kTy * i;
#pragma unroll
      for (int j = 0; j < kCm; ++j) {
        const int c = rb + tx + kTx * j;
        if (r < n && c < n && (ti != tk || c <= r)) {
          const size_t at = static_cast<size_t>(r) * n + c;
          lm[at] = cm[at] - acc[i][j];
        }
      }
    }
  }
}

// The float64 update on DMMA: the work of syrk_ffma_kernel, with each
// thread's outputs placed by Syrk<double>::pos and summed by its product.
template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads, 2)
syrk_dmma_kernel(const T* csrc, T* l, int batch, int n, int c0, int kw, int t0, int cols) {
  using S = Syrk<T>;
  constexpr int kBm = S::kBm, kBk = S::kBk, kLds = S::kLds, kStages = S::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* as = reinterpret_cast<T*>(smem_raw);  // [kStages][kBm][kLds]
  T* bs = as + kStages * kBm * kLds;
  int ti, tk;
  if (cols > 0) {
    ti = blockIdx.x / cols;
    tk = blockIdx.x % cols;
    if (tk > ti) return;
  } else {
    decode_pair(blockIdx.x, ti, tk);
  }
  const int steps = kw / kBk;
  const int ra = t0 + ti * kBm;  // first row of the output tile
  const int rb = t0 + tk * kBm;  // first column
  for (int b = blockIdx.y; b < batch; b += gridDim.y) {
    const T* cm = csrc + static_cast<size_t>(b) * n * n;
    T* lm = l + static_cast<size_t>(b) * n * n;
    constexpr int kLines = kBm * static_cast<int>(sizeof(T)) / 128;  // 128-byte lines per tile row
    for (int e = threadIdx.x; e < kBm * kLines; e += kThreads) {
      const int r = ra + e / kLines, c = rb + (e % kLines) * (128 / static_cast<int>(sizeof(T)));
      if (r < n && c < n) asm volatile("prefetch.global.L2 [%0];\n" ::"l"(cm + static_cast<size_t>(r) * n + c));
    }
    auto load_stage = [&](int stage, int k0) {
      constexpr int kPerRow = kBk / kVec;
      for (int e = threadIdx.x; e < kBm * kPerRow; e += kThreads) {
        const int r = e / kPerRow, kk = (e % kPerRow) * kVec;
        const int ga = ra + r, gb = rb + r;
        cp_async<kVec * sizeof(T)>(as + (stage * kBm + r) * kLds + kk,
                                   lm + static_cast<size_t>(min(ga, n - 1)) * n + c0 + k0 + kk, ga < n);
        cp_async<kVec * sizeof(T)>(bs + (stage * kBm + r) * kLds + kk,
                                   lm + static_cast<size_t>(min(gb, n - 1)) * n + c0 + k0 + kk, gb < n);
      }
      asm volatile("cp.async.commit_group;\n" ::);
    };
    T acc[S::kOut];
#pragma unroll
    for (int s = 0; s < S::kOut; ++s) acc[s] = T(0);
    // a ring of kStages buffers, kStages - 1 stages in flight; empty groups
    // past the last stage keep the wait count uniform
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < steps) load_stage(st, st * kBk);
      else asm volatile("cp.async.commit_group;\n" ::);
    }
    for (int step = 0; step < steps; ++step) {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
      __syncthreads();  // stage `step` has landed; stage step - 1 is consumed
      const int next = step + kStages - 1;
      if (next < steps) load_stage(next % kStages, next * kBk);
      else asm volatile("cp.async.commit_group;\n" ::);
      S::product(as + (step % kStages) * kBm * kLds, bs + (step % kStages) * kBm * kLds, acc);
    }
    __syncthreads();  // the ring is refilled for the next matrix of the batch
#pragma unroll
    for (int s = 0; s < S::kOut; ++s) {
      int r, c;
      S::pos(s, r, c);
      if (ra + r < n && rb + c < n && (ti != tk || c <= r)) {
        const size_t at = static_cast<size_t>(ra + r) * n + rb + c;
        lm[at] = cm[at] - acc[s];
      }
    }
  }
}

// The trailing update's kernel for T: float32 on FFMA, float64 on DMMA.
template <typename T, int kVec>
auto syrk_kernel() {
  if constexpr (std::is_same<T, float>::value) {
    return &syrk_ffma_kernel<T, kVec>;
  } else {
    return &syrk_dmma_kernel<T, kVec>;
  }
}

template <typename T>
constexpr size_t diag_smem_bytes() { return (kNb * kLd + kNb) * sizeof(T); }
template <typename T>
constexpr size_t trsm_smem_bytes() { return ((kNb + kTrsmRows) * kLd + kNb) * sizeof(T); }
template <typename T>
constexpr size_t fused_smem_bytes() { return fused_smem_elems<T>() * sizeof(T); }

template <typename T>
int set_smem_limits() {
  const int diag = static_cast<int>(diag_smem_bytes<T>());
  const int trsm = static_cast<int>(trsm_smem_bytes<T>());
  const int fused = static_cast<int>(fused_smem_bytes<T>());
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  cudaFuncSetAttribute(diag_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, diag);
  cudaFuncSetAttribute(panel_trsm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, trsm);
  cudaFuncSetAttribute(syrk_kernel<T, kVec>(), cudaFuncAttributeMaxDynamicSharedMemorySize, syrk_smem_bytes<T>());
  cudaFuncSetAttribute(syrk_kernel<T, 1>(), cudaFuncAttributeMaxDynamicSharedMemorySize, syrk_smem_bytes<T>());
  cudaFuncSetAttribute(fused_kernel<T, false>, cudaFuncAttributeMaxDynamicSharedMemorySize, fused);
  cudaFuncSetAttribute(fused_kernel<T, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, fused);
  return static_cast<int>(cudaGetLastError());
}

// One 128-wide half panel at c0: factor its diagonal block, then solve its
// rows below, to n.
template <typename T>
cudaError_t half_panel(const T* src, T* l, int batch, int gb, int n, int c0, cudaStream_t stream) {
  diag_block_kernel<T><<<gb, kThreads, diag_smem_bytes<T>(), stream>>>(src, l, batch, n, c0);
  cudaError_t e = cudaGetLastError();
  const int rest = n - c0 - kNb;
  if (e != cudaSuccess || rest <= 0) return e;
  panel_trsm_kernel<T><<<dim3((rest + kTrsmRows - 1) / kTrsmRows, gb), kThreads, trsm_smem_bytes<T>(), stream>>>(
      src, l, batch, n, c0);
  return cudaGetLastError();
}

// Update rows and columns from t0 on by the kw panel columns at c0 (see
// syrk_ffma_kernel; cols > 0 limits it to the first cols tile columns).
template <typename T>
cudaError_t trailing(const T* csrc, T* l, int batch, int gb, int n, int c0, int kw, int t0, int cols,
                     cudaStream_t stream) {
  constexpr int kBm = Syrk<T>::kBm;
  const int tiles = (n - t0 + kBm - 1) / kBm;
  const dim3 grid(cols > 0 ? tiles * cols : tiles * (tiles + 1) / 2, gb);
  const auto kernel = (static_cast<size_t>(n) * sizeof(T)) % 16 == 0 ? syrk_kernel<T, 16 / sizeof(T)>()
                                                                    : syrk_kernel<T, 1>();
  kernel<<<grid, kThreads, syrk_smem_bytes<T>(), stream>>>(csrc, l, batch, n, c0, kw, t0, cols);
  return cudaGetLastError();
}

// cudaFuncSetAttribute acts on the current device only: the limits are set
// once per device (and per T), on the first launch there.
constexpr int kMaxDevices = 64;

template <typename T>
int smem_limits_on_current_device() {
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  static std::once_flag once[kMaxDevices];
  static int result[kMaxDevices];
  std::call_once(once[dev], [dev] { result[dev] = set_smem_limits<T>(); });
  return result[dev];
}

// Panels of kWidePanel = 2 kNb columns, each factored as two kNb halves:
// half 1; the update of half 2's columns by half 1; half 2; then one
// rank-kWidePanel update of everything right of the panel.  Six launches
// per panel; each trailing element is read and written once per panel.
template <typename T>
int launch_blocked(const T* k, T* l, int batch, int n, cudaStream_t stream) {
  const int configured = smem_limits_on_current_device<T>();
  if (configured != cudaSuccess) return configured;
  if (batch <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const int gb = batch < 65535 ? batch : 65535;
  constexpr int kHalfCols = kNb / Syrk<T>::kBm;  // tile columns of a half panel
  for (int c0 = 0; c0 < n; c0 += kWidePanel) {
    const T* src = c0 == 0 ? k : l;  // nothing has written L right of c0 before the first panel
    cudaError_t e = half_panel(src, l, batch, gb, n, c0, stream);
    if (e == cudaSuccess && n > c0 + kNb) e = trailing(src, l, batch, gb, n, c0, kNb, c0 + kNb, kHalfCols, stream);
    if (e == cudaSuccess && n > c0 + kNb) e = half_panel<T>(l, l, batch, gb, n, c0 + kNb, stream);
    if (e == cudaSuccess && n > c0 + kWidePanel) {
      e = trailing(src, l, batch, gb, n, c0, kWidePanel, c0 + kWidePanel, 0, stream);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaSuccess);
}

// One cluster of `cluster` CTAs per matrix (1, 2 or 8: the widths the route picks).
template <typename T>
int launch_fused(const T* k, T* l, int batch, int n, int cluster, cudaStream_t stream) {
  if (cluster != 1 && cluster != 2 && cluster != 8) return static_cast<int>(cudaErrorInvalidValue);
  const int configured = smem_limits_on_current_device<T>();
  if (configured != cudaSuccess) return configured;
  if (batch <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, batch < 65535 ? batch : 65535, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = fused_smem_bytes<T>();
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, fused_kernel<T, false>, k, l, batch, n);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The whole card on each matrix in turn: a cooperative launch of one CTA per SM.
template <typename T>
int launch_grid(const T* k, T* l, int batch, int n, cudaStream_t stream) {
  const int configured = smem_limits_on_current_device<T>();
  if (configured != cudaSuccess) return configured;
  if (batch <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(sms, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = fused_smem_bytes<T>();
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, fused_kernel<T, true>, k, l, batch, n);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cluster: CTAs per matrix, 1, 2 or 8 (the wrapper's route names it).
extern "C" int bi_cholesky_fused_f32(const float* k, float* l, int batch, int n, int cluster, cudaStream_t stream) {
  return launch_fused<float>(k, l, batch, n, cluster, stream);
}

extern "C" int bi_cholesky_fused_f64(const double* k, double* l, int batch, int n, int cluster,
                                     cudaStream_t stream) {
  return launch_fused<double>(k, l, batch, n, cluster, stream);
}

extern "C" int bi_cholesky_grid_f32(const float* k, float* l, int batch, int n, cudaStream_t stream) {
  return launch_grid<float>(k, l, batch, n, stream);
}

extern "C" int bi_cholesky_grid_f64(const double* k, double* l, int batch, int n, cudaStream_t stream) {
  return launch_grid<double>(k, l, batch, n, stream);
}

// nb must be the compiled panel width (kWidePanel): the wrapper's route names it.
extern "C" int bi_cholesky_blocked_f32(const float* k, float* l, int batch, int n, int nb, cudaStream_t stream) {
  if (nb != kWidePanel) return static_cast<int>(cudaErrorInvalidValue);
  return launch_blocked<float>(k, l, batch, n, stream);
}

extern "C" int bi_cholesky_blocked_f64(const double* k, double* l, int batch, int n, int nb,
                                       cudaStream_t stream) {
  if (nb != kWidePanel) return static_cast<int>(cudaErrorInvalidValue);
  return launch_blocked<double>(k, l, batch, n, stream);
}
