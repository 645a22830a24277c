// The block GEMM's loops for Hopper (sm_90a), used by gemm.cu (K1): one
// block computes one output tile of A[M x K] @ B[K x N] and hands every
// in-range sum to an epilogue functor, epi(row, col, value).
//
// - `wgmma_tile`: bf16 operands on the tensor cores.  One producer warp
//   keeps TMA loads of A (WG_BM x 64, K-major) and B (64 x BN, N-major as
//   it lies in memory) in flight through a ring of WG_STAGES shared-memory
//   stages, one full/empty mbarrier pair per stage; two consumer
//   warpgroups each run wgmma m64nBNk16 on their 64-row half of the
//   128 x BN tile, A and B read straight from the swizzled stages (B with
//   the transpose bit, so it needs no transpose in memory), sums in f32
//   registers.  A consumer keeps one group of products in flight and
//   releases a stage as soon as the products that read it are done.  TMA
//   zero-fills boxes past the edges, so ragged M, N and K need no masking
//   on the load side.  Needs K and N multiples of 8 and 16-byte aligned
//   bases (TMA's 16-byte strides).  bf16 products are exact in f32, so the
//   sums differ from an f32 loop only in their order.
// - `f32_tile`: float32 operands in true FP32 (FMA, no TF32) on the SIMT
//   pipes.  A (128 x 32) and B (32 x 128) slabs stream through F_STAGES
//   stages of cp.async copies, so the next slabs load while this one is
//   multiplied, with one __syncthreads a slab.  A stays row-major as it
//   lies in memory.  Eight warps tile the block 4 x 2, each 32 x 64; a
//   thread keeps an 8 x 8 micro-tile (8 rows, two groups of 4 columns 32
//   apart).  Per 4-deep step a thread reads a float4 of A for each of its
//   rows (a quarter-warp reads one address: a broadcast) and per depth two
//   float4 of B (a quarter-warp reads 128 contiguous bytes): 16 shared
//   loads for 256 FMAs, none conflicting.  Copies are 16 bytes when K and
//   N are multiples of 4 with aligned bases (VEC), else 4 bytes; both
//   zero-fill past the edges.  One block of 256 threads an SM (167
//   registers, 96 KB of stages): held to two blocks ptxas caps a thread at
//   128 registers and spills, and that read 3.57 ms at 4096^3 against
//   3.21-3.34 ms for one block (H100 80GB HBM3, 700 W, chip_smoke.py);
//   each thread's 64 independent FMAs a depth hide the shared loads.

#pragma once

#include "sm90.cuh"

namespace da_sm90 {

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int WG_BM = 128;      // tile rows: two consumer warpgroups of 64
constexpr int WG_BK = 64;       // depth of a stage: one 128-byte row of A
constexpr int WG_STAGES = 4;
constexpr int WG_CONSUMERS = 2;
constexpr int WG_THREADS = WG_CONSUMERS * 128 + 32;  // + the producer warp

template <int BN>
__host__ __device__ constexpr int wg_stage_bytes() {
  return (WG_BM + BN) * WG_BK * 2;
}
// dynamic shared memory of wgmma_tile (with 1 KB of alignment slack)
template <int BN>
__host__ __device__ constexpr size_t wg_smem_bytes() {
  return (size_t)WG_STAGES * wg_stage_bytes<BN>() + 1024;
}

// The 128 x BN tile at (m0, n0).  `ta` maps A as (K, M) with a (64, 128)
// box, `tb` maps B as (N, K) with a (64, 64) box.  Run by all WG_THREADS
// threads of the block; the producer warp returns early, so the caller
// must not synchronise the block afterwards.
template <int BN, typename Epi>
__device__ __forceinline__ void wgmma_tile(const CUtensorMap* ta,
                                           const CUtensorMap* tb, int M,
                                           int N, int K, int m0, int n0,
                                           uint8_t* smem_raw, const Epi& epi) {
  __shared__ __align__(8) uint64_t full[WG_STAGES], empty[WG_STAGES];
  constexpr int A_BYTES = WG_BM * WG_BK * 2;
  constexpr int STAGE = wg_stage_bytes<BN>();
  uint8_t* smem = align1024(smem_raw);
  const int nk = (K + WG_BK - 1) / WG_BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WG_CONSUMERS * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == WG_CONSUMERS * 4) {  // the producer warp
    if (lane == 0) {
      for (int it = 0; it < nk; ++it) {
        const int s = it % WG_STAGES;
        // stage s is free once the consumers released its previous round
        if (it >= WG_STAGES) mbar_wait(&empty[s], ((it / WG_STAGES) + 1) & 1);
        uint8_t* a = smem + s * STAGE;
        uint8_t* b = a + A_BYTES;
        mbar_expect_tx(&full[s], STAGE);
        tma_load_2d(a, ta, &full[s], it * WG_BK, m0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_2d(b + j * 8192, tb, &full[s], n0 + 64 * j, it * WG_BK);
      }
    }
    return;
  }

  const int wg = warp / 4;  // this consumer's 64-row half
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int it = 0; it < nk; ++it) {
    const int s = it % WG_STAGES;
    mbar_wait(&full[s], (it / WG_STAGES) & 1);
    const uint8_t* a = smem + s * STAGE + wg * 64 * 128;
    const uint8_t* b = smem + s * STAGE + A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk)
      wgmma_ss<BN, 1>(acc, sw128_desc(a + 32 * kk, 16, 1024),
                      sw128_desc(b + 2048 * kk, 8192, 1024), 1);
    wgmma_commit();
    // the previous stage's products are done: release it
    wgmma_wait<1>();
    if (it > 0) mbar_arrive(&empty[(it - 1) % WG_STAGES]);
  }
  wgmma_wait<0>();
  reg_fence(acc);

  const int g = lane / 4, t = lane % 4;
  const int rbase = m0 + wg * 64 + (warp % 4) * 16 + g;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = rbase + 8 * (e >> 1);
      const int col = n0 + 8 * j + 2 * t + (e & 1);
      if (row < M && col < N) epi(row, col, acc[4 * j + e]);
    }
}

// Whether A (M x K) and B (K x N), row-major bf16, can be read by TMA.
inline bool wgmma_ok(const void* A, const void* B, int N, int K) {
  return K % 8 == 0 && N % 8 == 0 &&
         reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(B) % 16 == 0;
}

// The two tensor maps of wgmma_tile; returns 0 or an error code.
inline int wgmma_maps(CUtensorMap* ta, CUtensorMap* tb, const void* A,
                      const void* B, int M, int N, int K) {
  const uint64_t da[2] = {(uint64_t)K, (uint64_t)M};
  const uint64_t sa[1] = {(uint64_t)K * 2};
  const uint32_t ba[2] = {WG_BK, WG_BM};
  int rc = make_map(ta, A, 2, da, sa, ba);
  if (rc) return rc;
  const uint64_t db[2] = {(uint64_t)N, (uint64_t)K};
  const uint64_t sb[1] = {(uint64_t)N * 2};
  const uint32_t bb[2] = {64, WG_BK};
  return make_map(tb, B, 2, db, sb, bb);
}

// ---------------------------------------------------------------------------
// f32: a pipelined SIMT loop
// ---------------------------------------------------------------------------

constexpr int F_BM = 128;
constexpr int F_BN = 128;
constexpr int F_BK = 32;
constexpr int F_STAGES = 3;
constexpr int F_THREADS = 256;
// dynamic shared memory of f32_tile: F_STAGES A and B slabs (96 KB)
constexpr size_t F_SMEM = (size_t)F_STAGES * (F_BM * F_BK + F_BK * F_BN) * 4;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Whether the f32 slabs can be copied 16 bytes at a time.
inline bool f32_vec(const void* A, int64_t lda, const void* B, int64_t ldb,
                    int N, int K) {
  return K % 4 == 0 && N % 4 == 0 && lda % 4 == 0 && ldb % 4 == 0 &&
         reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(B) % 16 == 0;
}

// Start the copies of the A slab (rows m0.., cols k0..) into As[m][k] and
// the B slab (rows k0.., cols n0..) into Bs[k][n], zero past the edges.
template <bool VEC>
__device__ __forceinline__ void f32_stage(const float* __restrict__ A,
                                          int64_t lda,
                                          const float* __restrict__ B,
                                          int64_t ldb, int M, int N, int K,
                                          int64_t m0, int64_t n0, int k0,
                                          float* As, float* Bs) {
  const int tid = threadIdx.x;
  if (VEC) {
#pragma unroll
    for (int i = 0; i < F_BM * F_BK / 4 / F_THREADS; ++i) {
      const int idx = tid + i * F_THREADS;
      const int r = idx / (F_BK / 4), c = (idx % (F_BK / 4)) * 4;
      const bool in = m0 + r < M && k0 + c < K;
      cp_async16(As + r * F_BK + c, in ? A + (m0 + r) * lda + k0 + c : A, in);
    }
#pragma unroll
    for (int i = 0; i < F_BK * F_BN / 4 / F_THREADS; ++i) {
      const int idx = tid + i * F_THREADS;
      const int r = idx / (F_BN / 4), c = (idx % (F_BN / 4)) * 4;
      const bool in = k0 + r < K && n0 + c < N;
      cp_async16(Bs + r * F_BN + c,
                 in ? B + (int64_t)(k0 + r) * ldb + n0 + c : B, in);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < F_BM * F_BK / F_THREADS; ++i) {
      const int idx = tid + i * F_THREADS;
      const int r = idx / F_BK, c = idx % F_BK;
      const bool in = m0 + r < M && k0 + c < K;
      cp_async4(As + r * F_BK + c, in ? A + (m0 + r) * lda + k0 + c : A, in);
    }
#pragma unroll 4
    for (int i = 0; i < F_BK * F_BN / F_THREADS; ++i) {
      const int idx = tid + i * F_THREADS;
      const int r = idx / F_BN, c = idx % F_BN;
      const bool in = k0 + r < K && n0 + c < N;
      cp_async4(Bs + r * F_BN + c,
                in ? B + (int64_t)(k0 + r) * ldb + n0 + c : B, in);
    }
  }
}

// The 128 x 128 tile at (m0, n0) of A @ B in f32; lda and ldb are the row
// strides.  `smem` holds F_SMEM bytes.  Run by F_THREADS threads.
template <bool VEC, typename Epi>
__device__ __forceinline__ void f32_tile(const float* __restrict__ A,
                                         int64_t lda,
                                         const float* __restrict__ B,
                                         int64_t ldb, int M, int N, int K,
                                         int64_t m0, int64_t n0, float* smem,
                                         const Epi& epi) {
  float* As = smem;                                // [F_STAGES][F_BM][F_BK]
  float* Bs = smem + F_STAGES * F_BM * F_BK;       // [F_STAGES][F_BK][F_BN]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = (warp % 4) * 32 + (lane / 8) * 8;  // the thread's 8 rows
  const int c0 = (warp / 4) * 64 + (lane % 8) * 4;  // columns c0.. and c0+32..
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nk = (K + F_BK - 1) / F_BK;
#pragma unroll
  for (int s = 0; s < F_STAGES - 1; ++s) {
    if (s < nk)
      f32_stage<VEC>(A, lda, B, ldb, M, N, K, m0, n0, s * F_BK,
                     As + s * F_BM * F_BK, Bs + s * F_BK * F_BN);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<F_STAGES - 2>();  // slab kt has landed
    // ... for every thread, and every thread is done with slab kt - 1,
    // whose stage the next copies refill
    __syncthreads();
    const int nxt = kt + F_STAGES - 1;
    if (nxt < nk)
      f32_stage<VEC>(A, lda, B, ldb, M, N, K, m0, n0, nxt * F_BK,
                     As + (nxt % F_STAGES) * F_BM * F_BK,
                     Bs + (nxt % F_STAGES) * F_BK * F_BN);
    cp_async_commit();
    const float* as = As + (kt % F_STAGES) * F_BM * F_BK;
    const float* bs = Bs + (kt % F_STAGES) * F_BK * F_BN;
#pragma unroll
    for (int kq = 0; kq < F_BK; kq += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(as + (r0 + i) * F_BK + kq);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b0 =
            *reinterpret_cast<const float4*>(bs + (kq + kk) * F_BN + c0);
        const float4 b1 =
            *reinterpret_cast<const float4*>(bs + (kq + kk) * F_BN + c0 + 32);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = reinterpret_cast<const float*>(&a[i])[kk];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t row = m0 + r0 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t col = n0 + c0 + (j < 4 ? j : 28 + j);
      if (col < N) epi(row, col, acc[i][j]);
    }
  }
}

}  // namespace da_sm90
