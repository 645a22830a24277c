// The block GEMM's loops for Hopper (sm_90a), used by gemm.cu (K1) and by
// the ring GEMMs of collectives.cu (K13, K14, K15): one block
// computes one output tile of A[M x K] @ B[K x N] (A's rows lda apart, so
// A may be a column slice of a wider matrix) and hands every in-range sum
// to an epilogue functor, epi(row, col, value).
//
// - `wgmma_tile`: bf16 operands on the tensor cores.  One producer warp
//   keeps TMA loads of A (WG_BM x 64, K-major) and B (64 x BN, N-major as
//   it lies in memory) in flight through a ring of STAGES (WG_STAGES by
//   default) shared-memory stages, one full/empty mbarrier pair per
//   stage; two consumer warpgroups each run wgmma m64nBNk16 on their
//   64-row half of the 128 x BN tile (BN 64, 128 or 256), A and B read
//   straight from the swizzled stages (B with the transpose bit, so it
//   needs no transpose in memory), sums in f32 registers.  A consumer
//   keeps one group of products in flight and releases a stage as soon as
//   the products that read it are done.  TMA zero-fills boxes past the
//   edges, so ragged M, N and K need no masking on the load side.  Needs
//   K, N and lda multiples of 8 and 16-byte aligned bases (TMA's 16-byte
//   strides).  bf16 products are exact in f32, so the sums differ from an
//   f32 loop only in their order.  Two options serve the ring GEMMs:
//   - FWD_A / FWD_B: the block also stores every A (or B) box it loads on
//     to a contiguous copy of that operand through a third tensor map (a
//     TMA store from the same stage, issued by one consumer thread once
//     the box has landed); that thread lets the stage be refilled only
//     after its store has finished reading it.  A ring step's forward of
//     its resident chunk thus rides on the loads its product needs.
//   - TMA_OUT: the bf16 output tile goes out through shared memory and a
//     TMA store over a fourth map, `to`: each thread writes its column
//     pairs, epi(v0, v1, prior), into the tile as the map's 128-byte
//     swizzled boxes lay it out (conflict-free: a warp's eight rows land
//     in eight different 16-byte chunks), and one thread stores the tile,
//     in whole lines, clipped at the edges.  Where epi.accumulate, the
//     producer first loads the prior tile into the same place (after the
//     last operand load, so the load's latency hides behind the last
//     stages' products) and `prior` is that value, else zero.  The prior
//     comes through a fifth map, `tp`, laid out as `to`: by default `to`
//     itself (K14 adds into its output), or another tensor of the same
//     shape (K15 adds the partial it received and stores the sum into the
//     right neighbour's slot).  Those bases must be 16-byte aligned and N
//     a multiple of 8.
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
//   A `Fwd` functor, fwd(k0, As, Bs), sees every slab once it has landed
//   and before its stage is refilled: the ring GEMMs store the resident
//   chunk's slabs on to the neighbour's slot from there.

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
template <int BN, int STAGES = WG_STAGES, bool TMA_OUT = false>
__host__ __device__ constexpr size_t wg_smem_bytes() {
  return (size_t)STAGES * wg_stage_bytes<BN>() +
         (TMA_OUT ? (size_t)WG_BM * BN * 2 : 0) + 1024;
}

// Which operand's boxes wgmma_tile stores on to the forward map.
enum WgFwd { FWD_NONE = 0, FWD_A = 1, FWD_B = 2 };

// The 128 x BN tile at (m0, n0).  `ta` maps A as (K, M) with a (64, 128)
// box, `tb` maps B as (N, K) with a (64, 64) box; `tf` (FWD_A / FWD_B, or
// null for a block that forwards nothing) maps the copy as `ta` or `tb`
// maps the operand (wgmma_fwd_map); `to` (TMA_OUT) maps the bf16 output as
// `ta` maps A (wgmma_out_map), and `tp` (null: `to`) the prior tile it
// adds where epi.accumulate.  Run by all WG_THREADS threads of the
// block, with wg_smem_bytes<BN, STAGES, TMA_OUT>() bytes at `smem_raw`;
// the producer warp returns early, so the caller must not synchronise the
// block afterwards.
template <int BN, typename Epi, int FWD = FWD_NONE, bool TMA_OUT = false,
          int STAGES = WG_STAGES>
__device__ __forceinline__ void wgmma_tile(const CUtensorMap* ta,
                                           const CUtensorMap* tb, int M,
                                           int N, int K, int m0, int n0,
                                           uint8_t* smem_raw, const Epi& epi,
                                           const CUtensorMap* tf = nullptr,
                                           const CUtensorMap* to = nullptr,
                                           const CUtensorMap* tp = nullptr) {
  // full[STAGES]: the output tile's current values (TMA_OUT)
  __shared__ __align__(8) uint64_t full[STAGES + TMA_OUT], empty[STAGES];
  constexpr int A_BYTES = WG_BM * WG_BK * 2;
  constexpr int STAGE = wg_stage_bytes<BN>();
  constexpr int O_BOX = WG_BM * 128;  // a 64-column box of the output tile
  uint8_t* smem = align1024(smem_raw);
  const int nk = (K + WG_BK - 1) / WG_BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WG_CONSUMERS * 128);
    }
    if constexpr (TMA_OUT) mbar_init(&full[STAGES], 1);
    mbar_fence_init();
  }
  __syncthreads();
  // the output tile (TMA_OUT): BN / 64 boxes of 128 rows of 128 bytes
  uint8_t* otile = smem + STAGES * STAGE;

  if (warp == WG_CONSUMERS * 4) {  // the producer warp
    if (lane == 0) {
      for (int it = 0; it < nk; ++it) {
        const int s = it % STAGES;
        // stage s is free once the consumers released its previous round
        if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) + 1) & 1);
        uint8_t* a = smem + s * STAGE;
        uint8_t* b = a + A_BYTES;
        mbar_expect_tx(&full[s], STAGE);
        tma_load_2d(a, ta, &full[s], it * WG_BK, m0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_2d(b + j * 8192, tb, &full[s], n0 + 64 * j, it * WG_BK);
      }
      if constexpr (TMA_OUT) {
        if (epi.accumulate) {
          mbar_expect_tx(&full[STAGES], WG_BM * BN * 2);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load_2d(otile + j * O_BOX, tp ? tp : to, &full[STAGES],
                        n0 + 64 * j, m0);
        }
      }
    }
    return;
  }

  const int wg = warp / 4;  // this consumer's 64-row half
  // the one thread that stores this block's forwarded boxes
  const bool fwd = FWD != FWD_NONE && tf != nullptr && threadIdx.x == 0;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int it = 0; it < nk; ++it) {
    const int s = it % STAGES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    const uint8_t* a = smem + s * STAGE + wg * 64 * 128;
    const uint8_t* b = smem + s * STAGE + A_BYTES;
    if constexpr (FWD != FWD_NONE) {
      if (fwd) {
        if constexpr (FWD == FWD_A) {
          tma_store_2d(tf, smem + s * STAGE, it * WG_BK, m0);
        } else {
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_store_2d(tf, b + j * 8192, n0 + 64 * j, it * WG_BK);
        }
        bulk_commit();
      }
      __syncwarp();
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk)
      wgmma_ss<BN, 1>(acc, sw128_desc(a + 32 * kk, 16, 1024),
                      sw128_desc(b + 2048 * kk, 8192, 1024), 1);
    wgmma_commit();
    // the previous stage's products (and store) are done: release it
    wgmma_wait<1>();
    if constexpr (FWD != FWD_NONE) {
      if (fwd) bulk_wait_read<1>();
    }
    if (it > 0) mbar_arrive(&empty[(it - 1) % STAGES]);
  }
  wgmma_wait<0>();
  reg_fence(acc);
  if constexpr (FWD != FWD_NONE) {
    if (fwd) bulk_wait<0>();  // the stores leave shared memory before exit
  }

  const int g = lane / 4, t = lane % 4;
  const int rbase = m0 + wg * 64 + (warp % 4) * 16 + g;
  if constexpr (TMA_OUT) {
    if (epi.accumulate) mbar_wait(&full[STAGES], 0);
    // row r = wg * 64 + (warp % 4) * 16 + g + 8 h of the tile, so r % 8 = g
    uint8_t* rows = otile + (wg * 64 + (warp % 4) * 16 + g) * 128 + 4 * t;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(
            rows + (j / 8) * O_BOX + h * 1024 + (((j % 8) ^ g) * 16));
        const __nv_bfloat162 prior =
            epi.accumulate ? *q : __floats2bfloat162_rn(0.f, 0.f);
        *q = epi(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], prior);
      }
    fence_proxy_async();  // the tile's writes, visible to the TMA store
    named_sync(1, WG_CONSUMERS * 128);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int j = 0; j < BN / 64; ++j)
        tma_store_2d(to, otile + j * O_BOX, n0 + 64 * j, m0);
      bulk_commit();
      bulk_wait<0>();
    }
  } else {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = rbase + 8 * (e >> 1);
        const int col = n0 + 8 * j + 2 * t + (e & 1);
        if (row < M && col < N) epi(row, col, acc[4 * j + e]);
      }
  }
}

// Whether A (M x K, rows lda apart) and B (K x N), row-major bf16, can be
// read by TMA.
inline bool wgmma_ok(const void* A, int64_t lda, const void* B, int N,
                     int K) {
  return K % 8 == 0 && N % 8 == 0 && lda % 8 == 0 &&
         reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(B) % 16 == 0;
}

// The two tensor maps of wgmma_tile; returns 0 or an error code.
inline int wgmma_maps(CUtensorMap* ta, CUtensorMap* tb, const void* A,
                      int64_t lda, const void* B, int M, int N, int K) {
  const uint64_t da[2] = {(uint64_t)K, (uint64_t)M};
  const uint64_t sa[1] = {(uint64_t)lda * 2};
  const uint32_t ba[2] = {WG_BK, WG_BM};
  int rc = make_map(ta, A, 2, da, sa, ba);
  if (rc) return rc;
  const uint64_t db[2] = {(uint64_t)N, (uint64_t)K};
  const uint64_t sb[1] = {(uint64_t)N * 2};
  const uint32_t bb[2] = {64, WG_BK};
  return make_map(tb, B, 2, db, sb, bb);
}

// The output (or prior) map of wgmma_tile<..., TMA_OUT>: `out`, a
// contiguous M x N bf16 matrix, in (64, 128) boxes.
inline int wgmma_out_map(CUtensorMap* to, void* out, int M, int N) {
  const uint64_t d[2] = {(uint64_t)N, (uint64_t)M};
  const uint64_t st[1] = {(uint64_t)N * 2};
  const uint32_t box[2] = {64, WG_BM};
  return make_map(to, out, 2, d, st, box);
}

// The forward map of wgmma_tile: `dst` a contiguous M x K copy of A
// (FWD_A) or K x N copy of B (FWD_B), in the operand's boxes.
inline int wgmma_fwd_map(CUtensorMap* tf, void* dst, int fwd, int M, int N,
                         int K) {
  const bool a = fwd == FWD_A;
  const uint64_t d[2] = {(uint64_t)(a ? K : N), (uint64_t)(a ? M : K)};
  const uint64_t st[1] = {(uint64_t)(a ? K : N) * 2};
  const uint32_t box[2] = {a ? (uint32_t)WG_BK : 64u,
                           a ? (uint32_t)WG_BM : (uint32_t)WG_BK};
  return make_map(tf, dst, 2, d, st, box);
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

// f32_tile's default slab hook: nothing.
struct NoFwd {
  __device__ __forceinline__ void operator()(int, const float*,
                                             const float*) const {}
};

// The 128 x 128 tile at (m0, n0) of A @ B in f32; lda and ldb are the row
// strides.  `smem` holds F_SMEM bytes.  Run by F_THREADS threads.
// fwd(k0, As, Bs) runs on every thread once the slabs of depth k0.. have
// landed in As ([F_BM][F_BK]) and Bs ([F_BK][F_BN]).
template <bool VEC, typename Epi, typename Fwd = NoFwd>
__device__ __forceinline__ void f32_tile(const float* __restrict__ A,
                                         int64_t lda,
                                         const float* __restrict__ B,
                                         int64_t ldb, int M, int N, int K,
                                         int64_t m0, int64_t n0, float* smem,
                                         const Epi& epi,
                                         const Fwd& fwd = Fwd()) {
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
    fwd(kt * F_BK, as, bs);
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
