// int8 GEMM with fused dequantization for Hopper (sm_90a):
//   C[i, j] = f32(sum_k qa[i, k] * qb[k, j]) * (sa[i] * sb[j])
//
// Replaces the Pallas TPU kernel distributedarrays_tpu/ops/pallas_gemm.py
// `_int8_kernel` (built by `_build_int8`, called by `pallas_matmul_int8`).
// That kernel carries an int32 VMEM accumulator across a sequential K grid
// axis and dequantizes in the last step's flush.  Here each block owns one
// output tile, loops over K itself with the int32 accumulators in
// registers, and dequantizes in the tile flush.
//
// Arithmetic: the products run on the int8 tensor cores, so the sum over k
// is an exact int32 sum (no rounding while |acc| < 2^31, i.e. for every K
// <= (2^31-1)/127^2 even with saturated codes).  The flush computes int32
// -> f32 (round to nearest), sa[i] * sb[j] in f32, and their product in
// f32, each rounded once (__fmul_rn, no contraction), which is what the
// plain version and the JAX kernel compute; every route therefore equals
// the plain version bit for bit.  Output f32 or bf16 (one round to nearest
// even).  Ragged m/n/k need no divisibility (the Pallas kernel needs it).
//
// Bound on an H100: 2*m*n*k integer operations over the 1979 TOP/s of the
// dense int8 tensor cores (16384^3: about 4.4 ms).  Two routes, chosen by
// the caller (ops/cuda_gemm.py `int8_gemm_route`) and passed as `route`:
// - ROUTE_WGMMA, K a multiple of 16 and qa 16-byte aligned (TMA's row
//   strides and bases): wgmma.m64n256k32.s32.s8.s8 fed by TMA.  For 8-bit
//   operands wgmma has no transpose bit, so B must be K-major in shared
//   memory: a transpose kernel in this file first writes qb (k, n) as a
//   (n, k) copy into the caller's scratch `ws`, on the same stream (2 n k
//   bytes: 0.16 ms at 16384^2 at 3.35 TB/s).  One producer warp keeps TMA
//   loads of a 128 x 128-byte A box and a 256 x 128-byte B box in flight
//   through a 4-stage ring (48 KB a stage: one 128-byte swizzle row of the
//   contraction dim, four k32 slices), one full/empty mbarrier pair a
//   stage, as gemm_sm90.cuh `wgmma_tile` does for bf16; two consumer
//   warpgroups each run the products of their 64-row half of the 128 x 256
//   tile with 128 s32 accumulators a thread, and flush from those
//   registers.  TMA zero-fills boxes past the edges (zeros add nothing to
//   an integer sum), so ragged M, N and K need no load masks; the flush
//   masks the output.  Tiles are walked GROUP_M tile rows at a time, so a
//   wave of blocks shares its A and B panels in L2; walked row by row,
//   each of the 128 tile rows at 16384^3 reads all 256 MB of B from device
//   memory again (32 GB, about 10 ms at 3.35 TB/s against 4.4 ms of
//   products).  Device time at 16384^3 in turns in one call (H100 80GB
//   HBM3, 700 W, chip_smoke.py's device_ms on trial builds): GROUP_M 1
//   12.32 ms, 8 5.91-5.94 ms, 16 5.79-6.03 ms.
// - ROUTE_MMA, any other shape: mma.sync.m16n8k32.s32.s8.s8 on a 128x128x64
//   tile a block of 8 warps (each warp a 64x32 sub-tile: 4x4 mma tiles),
//   A staged as [m][k] and B transposed to [n][k] in shared memory so every
//   fragment register is one aligned 32-bit load, rows padded to 80 bytes
//   against bank conflicts; 16-byte (A) and 4x4-byte transposed (B) slab
//   loads when K and N are multiples of 16, else byte by byte; zero-padded
//   past the edges.  No pipelining: each slab is loaded, then multiplied.

#include "sm90.cuh"

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 64;
constexpr int LDS = BK + 16;  // shared row stride in bytes (80)
constexpr int THREADS = 256;
constexpr int WM = 64;        // warp tile rows
constexpr int WN = 32;        // warp tile columns
constexpr int MT = WM / 16;   // mma tiles per warp along m
constexpr int NT = WN / 8;    // mma tiles per warp along n

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// two neighbouring columns at once (p 8-byte / 4-byte aligned)
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage the A slab (rows m0.., k0..) as As[m][k] and the B slab as Bs[n][k].
template <bool VEC>
__device__ __forceinline__ void load_slabs(const int8_t* __restrict__ A,
                                           const int8_t* __restrict__ B,
                                           int8_t* As, int8_t* Bs, int M,
                                           int N, int K, int64_t m0,
                                           int64_t n0, int k0) {
  const int tid = threadIdx.x;
  if (VEC) {
    // A: BM rows x BK bytes = 512 chunks of 16 bytes.  K % 16 == 0, so a
    // chunk is wholly inside or wholly outside the matrix.
#pragma unroll
    for (int i = 0; i < BM * BK / 16 / THREADS; ++i) {
      int idx = tid + i * THREADS;
      int r = idx / (BK / 16), c = (idx % (BK / 16)) * 16;
      int64_t gr = m0 + r;
      int gc = k0 + c;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (gr < M && gc < K)
        v = *reinterpret_cast<const uint4*>(A + gr * K + gc);
      *reinterpret_cast<uint4*>(As + r * LDS + c) = v;
    }
    // B: BK rows x BN bytes as 4x4-byte blocks, transposed in registers.
#pragma unroll
    for (int i = 0; i < (BK / 4) * (BN / 4) / THREADS; ++i) {
      int idx = tid + i * THREADS;
      int kr = (idx / (BN / 4)) * 4, nc = (idx % (BN / 4)) * 4;
      int64_t gn = n0 + nc;
      uint32_t r[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        int gk = k0 + kr + q;
        r[q] = (gk < K && gn < N)
                   ? *reinterpret_cast<const uint32_t*>(B + (int64_t)gk * N +
                                                        gn)
                   : 0u;
      }
      uint32_t lo01 = __byte_perm(r[0], r[1], 0x5140);
      uint32_t hi01 = __byte_perm(r[0], r[1], 0x7362);
      uint32_t lo23 = __byte_perm(r[2], r[3], 0x5140);
      uint32_t hi23 = __byte_perm(r[2], r[3], 0x7362);
      uint32_t w[4] = {__byte_perm(lo01, lo23, 0x5410),
                       __byte_perm(lo01, lo23, 0x7632),
                       __byte_perm(hi01, hi23, 0x5410),
                       __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        *reinterpret_cast<uint32_t*>(Bs + (nc + q) * LDS + kr) = w[q];
    }
  } else {
    for (int idx = tid; idx < BM * BK; idx += THREADS) {
      int r = idx / BK, c = idx % BK;
      int64_t gr = m0 + r;
      int gc = k0 + c;
      As[r * LDS + c] = (gr < M && gc < K) ? A[gr * K + gc] : (int8_t)0;
    }
    for (int idx = tid; idx < BK * BN; idx += THREADS) {
      int r = idx / BN, c = idx % BN;
      int gk = k0 + r;
      int64_t gn = n0 + c;
      Bs[c * LDS + r] =
          (gk < K && gn < N) ? B[(int64_t)gk * N + gn] : (int8_t)0;
    }
  }
}

template <bool VEC, typename TOut>
__global__ void __launch_bounds__(THREADS)
gemm_int8_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
                 const float* __restrict__ sa, const float* __restrict__ sb,
                 TOut* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4;  // mma groupID
  const int t = lane % 4;  // mma threadID_in_group
  const int wm = (warp / (BN / WN)) * WM;  // warp tile origin in the block
  const int wn = (warp % (BN / WN)) * WN;
  const int64_t m0 = (int64_t)blockIdx.y * BM;
  const int64_t n0 = (int64_t)blockIdx.x * BN;

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_slabs<VEC>(A, B, As, Bs, M, N, K, m0, n0, k0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[MT][4], bf[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int8_t* p = As + (wm + i * 16 + g) * LDS + kk + t * 4;
        af[i][0] = *reinterpret_cast<const uint32_t*>(p);
        af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
        af[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int8_t* p = Bs + (wn + j * 8 + g) * LDS + kk + t * 4;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();
  }

  // flush: C = f32(acc) * (sa[row] * sb[col]), each product rounded once
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int64_t gr = m0 + wm + i * 16 + g + h * 8;
      if (gr >= M) continue;
      const float ra = sa[gr];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          int64_t gc = n0 + wn + j * 8 + t * 2 + q;
          if (gc < N) {
            float s = __fmul_rn(ra, sb[gc]);
            store(&C[gr * N + gc],
                  __fmul_rn(__int2float_rn(acc[i][j][h * 2 + q]), s));
          }
        }
      }
    }
  }
}


template <bool VEC, typename TOut>
int launch_mma(const void* qa, const void* qb, const float* sa,
               const float* sb, void* c, int m, int n, int k,
               cudaStream_t stream) {
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  gemm_int8_kernel<VEC, TOut><<<grid, THREADS, 0, stream>>>(
      static_cast<const int8_t*>(qa), static_cast<const int8_t*>(qb), sa, sb,
      static_cast<TOut*>(c), m, n, k);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int W_BM = 128;       // tile rows: two consumer warpgroups of 64
constexpr int W_BN = 256;       // tile columns
constexpr int W_BK = 128;       // depth of a stage: one 128-byte swizzle row
constexpr int W_STAGES = 4;
constexpr int W_CONSUMERS = 2;
constexpr int W_THREADS = W_CONSUMERS * 128 + 32;  // + the producer warp
constexpr int A_BYTES = W_BM * W_BK;               // 16 KB
constexpr int STAGE = (W_BM + W_BN) * W_BK;        // 48 KB
// dynamic shared memory, with 1 KB of alignment slack
constexpr size_t W_SMEM = (size_t)W_STAGES * STAGE + 1024;
// tile rows walked together (see the top)
constexpr int GROUP_M = 8;

template <typename TOut>
__global__ void __launch_bounds__(W_THREADS, 1)
gemm_int8_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                       const __grid_constant__ CUtensorMap tb,
                       const float* __restrict__ sa,
                       const float* __restrict__ sb, TOut* __restrict__ C,
                       int M, int N, int K) {
  using namespace da_sm90;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[W_STAGES], empty[W_STAGES];
  uint8_t* smem = align1024(smem_raw);
  // block -> tile, GROUP_M tile rows at a time, down each column first
  const int rows_t = (M + W_BM - 1) / W_BM, cols_t = (N + W_BN - 1) / W_BN;
  const int width = GROUP_M * cols_t;
  const int first = ((int)blockIdx.x / width) * GROUP_M;
  const int in_group = (int)blockIdx.x % width;
  const int group_rows = min(rows_t - first, GROUP_M);
  const int m0 = (first + in_group % group_rows) * W_BM;
  const int n0 = (in_group / group_rows) * W_BN;
  const int nk = (K + W_BK - 1) / W_BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], W_CONSUMERS * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == W_CONSUMERS * 4) {  // the producer warp
    if (lane == 0) {
      for (int it = 0; it < nk; ++it) {
        const int s = it % W_STAGES;
        // stage s is free once the consumers released its previous round
        if (it >= W_STAGES) mbar_wait(&empty[s], ((it / W_STAGES) + 1) & 1);
        uint8_t* a = smem + s * STAGE;
        mbar_expect_tx(&full[s], STAGE);
        tma_load_2d(a, &ta, &full[s], it * W_BK, m0);
        tma_load_2d(a + A_BYTES, &tb, &full[s], it * W_BK, n0);
      }
    }
    return;
  }

  const int wg = warp / 4;  // this consumer's 64-row half
  int acc[W_BN / 2];
#pragma unroll
  for (int i = 0; i < W_BN / 2; ++i) acc[i] = 0;
  for (int it = 0; it < nk; ++it) {
    const int s = it % W_STAGES;
    mbar_wait(&full[s], (it / W_STAGES) & 1);
    const uint8_t* a = smem + s * STAGE + wg * 64 * W_BK;
    const uint8_t* b = smem + s * STAGE + A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < W_BK / 32; ++kk)
      wgmma_s8<W_BN>(acc, sw128_desc(a + 32 * kk, 16, 1024),
                     sw128_desc(b + 32 * kk, 16, 1024), 1);
    wgmma_commit();
    // the previous stage's products are done: release it
    wgmma_wait<1>();
    if (it > 0) mbar_arrive(&empty[(it - 1) % W_STAGES]);
  }
  wgmma_wait<0>();
  reg_fence(acc);

  // flush: d[4 j + 2 h + e] is row 16 (warp % 4) + g + 8 h, column 8 j +
  // 2 t + e of this warpgroup's 64 x 256 part
  const int g = lane / 4, t = lane % 4;
  const int r0 = m0 + wg * 64 + (warp % 4) * 16 + g;
  float ra[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) ra[h] = r0 + 8 * h < M ? sa[r0 + 8 * h] : 0.f;
  const bool pairs = N % 2 == 0;  // both columns of a pair in one store
#pragma unroll
  for (int j = 0; j < W_BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * t;
    if (col >= N) continue;
    const bool two = col + 1 < N;
    const float s0 = sb[col], s1 = two ? sb[col + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t row = r0 + 8 * h;
      if (row >= M) continue;
      const float v0 = __fmul_rn(__int2float_rn(acc[4 * j + 2 * h]),
                                 __fmul_rn(ra[h], s0));
      const float v1 = __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]),
                                 __fmul_rn(ra[h], s1));
      TOut* out = C + row * N + col;
      if (pairs) {
        store2(out, v0, v1);
      } else {
        store(out, v0);
        if (two) store(out + 1, v1);
      }
    }
  }
}

// qb (K x N) -> qt (N x K), int8, through 64 x 64 shared tiles; K is a
// multiple of 4 (the wgmma route's multiple of 16), so each thread writes
// whole 4-byte words of qt.  VEC: N a multiple of 4 and qb 4-byte aligned,
// so the loads are words too.
constexpr int T_TILE = 64;
constexpr int T_LD = T_TILE + 4;  // shared row stride in bytes

template <bool VEC>
__global__ void __launch_bounds__(256)
transpose_s8_kernel(const int8_t* __restrict__ qb, int8_t* __restrict__ qt,
                    int K, int N) {
  __shared__ __align__(16) int8_t tile[T_TILE * T_LD];
  const int64_t n0 = (int64_t)blockIdx.x * T_TILE;
  const int64_t k0 = (int64_t)blockIdx.y * T_TILE;
  // load: rows k0.. of qb, columns n0.., as 64 rows of 16 words
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = threadIdx.x + 256 * i;
    const int r = idx / 16, c = (idx % 16) * 4;
    const int64_t gk = k0 + r, gn = n0 + c;
    uint32_t w = 0;
    if (gk < K) {
      if (VEC) {
        if (gn < N)
          w = *reinterpret_cast<const uint32_t*>(qb + gk * N + gn);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (gn + q < N)
            w |= (uint32_t)(uint8_t)qb[gk * N + gn + q] << (8 * q);
      }
    }
    *reinterpret_cast<uint32_t*>(tile + r * T_LD + c) = w;
  }
  __syncthreads();
  // store: rows n0.. of qt, columns k0.., four k values a word
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = threadIdx.x + 256 * i;
    const int r = idx / 16, c = (idx % 16) * 4;
    const int64_t gn = n0 + r, gk = k0 + c;
    if (gn >= N || gk >= K) continue;
    uint32_t w = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      w |= (uint32_t)(uint8_t)tile[(c + q) * T_LD + r] << (8 * q);
    *reinterpret_cast<uint32_t*>(qt + gn * K + gk) = w;
  }
}

template <typename TOut>
int launch_wgmma(const void* qa, const void* qb, const float* sa,
                 const float* sb, void* c, void* ws, int m, int n, int k,
                 cudaStream_t s) {
  if (k % 16 || !ws || reinterpret_cast<uintptr_t>(qa) % 16 ||
      reinterpret_cast<uintptr_t>(ws) % 16)
    return (int)cudaErrorInvalidValue;
  const dim3 tgrid((n + T_TILE - 1) / T_TILE, (k + T_TILE - 1) / T_TILE);
  const int8_t* b = static_cast<const int8_t*>(qb);
  int8_t* bt = static_cast<int8_t*>(ws);
  if (n % 4 == 0 && reinterpret_cast<uintptr_t>(qb) % 4 == 0)
    transpose_s8_kernel<true><<<tgrid, 256, 0, s>>>(b, bt, k, n);
  else
    transpose_s8_kernel<false><<<tgrid, 256, 0, s>>>(b, bt, k, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // A as (K, M) and the K-major B as (K, N), both in (128, rows) boxes
  CUtensorMap ta, tb;
  const uint64_t da[2] = {(uint64_t)k, (uint64_t)m};
  const uint64_t db[2] = {(uint64_t)k, (uint64_t)n};
  const uint64_t st[1] = {(uint64_t)k};
  const uint32_t ba[2] = {W_BK, W_BM}, bb[2] = {W_BK, W_BN};
  int rc = da_sm90::make_map(&ta, qa, 2, da, st, ba,
                             CU_TENSOR_MAP_DATA_TYPE_UINT8);
  if (!rc)
    rc = da_sm90::make_map(&tb, ws, 2, db, st, bb,
                           CU_TENSOR_MAP_DATA_TYPE_UINT8);
  if (rc) return rc;
  err = cudaFuncSetAttribute(gemm_int8_wgmma_kernel<TOut>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)W_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((m + W_BM - 1) / W_BM) * ((n + W_BN - 1) / W_BN);
  gemm_int8_wgmma_kernel<TOut><<<tiles, W_THREADS, W_SMEM, s>>>(
      ta, tb, sa, sb, static_cast<TOut*>(c), m, n, k);
  return (int)cudaGetLastError();
}

constexpr int ROUTE_MMA = 1;
constexpr int ROUTE_WGMMA = 2;

template <typename TOut>
int launch(int route, const void* qa, const void* qb, const float* sa,
           const float* sb, void* c, void* ws, int m, int n, int k,
           cudaStream_t s) {
  if (route == ROUTE_WGMMA)
    return launch_wgmma<TOut>(qa, qb, sa, sb, c, ws, m, n, k, s);
  if (route != ROUTE_MMA) return (int)cudaErrorInvalidValue;
  const bool vec = (k % 16 == 0) && (n % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(qa) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(qb) % 16 == 0);
  return vec ? launch_mma<true, TOut>(qa, qb, sa, sb, c, m, n, k, s)
             : launch_mma<false, TOut>(qa, qb, sa, sb, c, m, n, k, s);
}

}  // namespace

// qa (m,k) and qb (k,n) int8, row-major; sa (m,) and sb (n,) f32; c (m,n) f32
// or, with out_bf16, bf16.  route: 1 = mma.sync, 2 = wgmma + TMA (k a
// multiple of 16, qa and ws 16-byte aligned; ws holds n * k bytes for the
// K-major copy of qb), refused (cudaErrorInvalidValue) otherwise.
// `device` is the CUDA device of the tensors and the stream.  Returns the
// cudaGetLastError() code of the launches, or 1000 + the CUresult when a
// TMA tensor map cannot be encoded.
extern "C" int da_gemm_int8(const void* qa, const void* qb, const void* sa,
                            const void* sb, void* c, void* ws, int m, int n,
                            int k, int route, int out_bf16, int device,
                            void* stream) {
  if (m <= 0 || n <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fa = static_cast<const float*>(sa);
  const float* fb = static_cast<const float*>(sb);
  return out_bf16
             ? launch<__nv_bfloat16>(route, qa, qb, fa, fb, c, ws, m, n, k, s)
             : launch<float>(route, qa, qb, fa, fb, c, ws, m, n, k, s);
}
