// The bf16 mma.sync tile loop, shared by the block GEMM (gemm.cu) and the
// three ring GEMMs (collectives.cu) for bf16 operands that TMA cannot read.
//
// One block of THREADS threads accumulates the 128x128 output tile at
// (m0, n0) of A[M x K] @ B[K x N] on the tensor cores (mma.sync.m16n8k16,
// f32 accumulators): 8 warps, each a 64x32 sub-tile of 4x4 mma tiles.  The
// row strides lda and ldb let A be a column slice of a wider matrix.  A is
// staged as [m][k] and B as [k][n], as they lie in memory, through a
// two-stage cp.async pipeline (the next BK slab is copied while this one is
// multiplied); the fragments come out of ldmatrix (A) and ldmatrix .trans
// (B, so the col-major B operand needs no transpose in memory).  Rows are
// padded by 8 bf16 so each 8-row ldmatrix phase hits 32 distinct banks.
// The 16-byte copies need K and N to be multiples of 8 with aligned rows
// (VEC); otherwise the slabs are staged element by element.  Ragged edges
// are zero-padded in shared memory, so no dimension has to divide the
// tile.  bf16 products are exact in f32, so the sums differ from an f32
// loop only in their order.
//
// `gemm_tile` hands every in-range element of the tile's f32 sums to an
// epilogue functor, epi(row, col, value).  The f32 GEMMs run
// gemm_sm90.cuh's `f32_tile` instead.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace da_tile {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int LDA_S = BK + 8;   // bf16 per staged A row (80 bytes)
constexpr int LDB_S = BN + 8;   // bf16 per staged B row (272 bytes)
constexpr int WM = 64;          // warp tile rows
constexpr int WN = 32;          // warp tile columns
constexpr int MT = WM / 16;     // mma tiles per warp along m
constexpr int NT = WN / 8;      // mma tiles per warp along n

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One 16-byte cp.async, zero-filled when `in` is false.
__device__ __forceinline__ void cp16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(in ? 16 : 0));
}

// Stage the A slab (rows m0.., cols k0..) as As[m][k] and the B slab (rows
// k0.., cols n0..) as Bs[k][n], zero past the edges.
template <bool VEC>
__device__ __forceinline__ void stage_slabs(
    const __nv_bfloat16* __restrict__ A, int64_t lda,
    const __nv_bfloat16* __restrict__ B, int64_t ldb, int M, int N, int K,
    int64_t m0, int64_t n0, int k0, __nv_bfloat16* As, __nv_bfloat16* Bs) {
  const int tid = threadIdx.x;
  if (VEC) {
#pragma unroll
    for (int i = 0; i < BM * BK / 8 / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / (BK / 8), c = (idx % (BK / 8)) * 8;
      const bool in = m0 + r < M && k0 + c < K;
      cp16(As + r * LDA_S + c, in ? A + (m0 + r) * lda + k0 + c : A, in);
    }
#pragma unroll
    for (int i = 0; i < BK * BN / 8 / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / (BN / 8), c = (idx % (BN / 8)) * 8;
      const bool in = k0 + r < K && n0 + c < N;
      cp16(Bs + r * LDB_S + c, in ? B + (int64_t)(k0 + r) * ldb + n0 + c : B,
           in);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  } else {
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
    for (int idx = tid; idx < BM * BK; idx += THREADS) {
      const int r = idx / BK, c = idx % BK;
      As[r * LDA_S + c] =
          m0 + r < M && k0 + c < K ? A[(m0 + r) * lda + k0 + c] : zero;
    }
    for (int idx = tid; idx < BK * BN; idx += THREADS) {
      const int r = idx / BN, c = idx % BN;
      Bs[r * LDB_S + c] = k0 + r < K && n0 + c < N
                              ? B[(int64_t)(k0 + r) * ldb + n0 + c]
                              : zero;
    }
  }
}

// The 128x128 tile at (m0, n0) of A[M x K] @ B[K x N], bf16 in, f32 sums:
// thread (warp, lane) holds acc[i][j][h * 2 + q] for row m0 + wm + 16 i + g
// + 8 h and column n0 + wn + 8 j + 2 t + q (g = lane / 4, t = lane % 4).
template <bool VEC>
__device__ __forceinline__ void mma_loop(const __nv_bfloat16* __restrict__ A,
                                         int64_t lda,
                                         const __nv_bfloat16* __restrict__ B,
                                         int64_t ldb, int M, int N, int K,
                                         int64_t m0, int64_t n0,
                                         float (&acc)[MT][NT][4]) {
  __shared__ __align__(16) __nv_bfloat16 As[2][BM * LDA_S];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][BK * LDB_S];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = (warp / (BN / WN)) * WM;
  const int wn = (warp % (BN / WN)) * WN;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  const int nk = (K + BK - 1) / BK;
  if (nk > 0) stage_slabs<VEC>(A, lda, B, ldb, M, N, K, m0, n0, 0, As[0], Bs[0]);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % 2;
    if (kt + 1 < nk) {
      stage_slabs<VEC>(A, lda, B, ldb, M, N, K, m0, n0, (kt + 1) * BK,
                       As[1 - s], Bs[1 - s]);
      if (VEC) asm volatile("cp.async.wait_group 1;\n" ::);
    } else if (VEC) {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MT][4], bfr[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const __nv_bfloat16* p =
            &As[s][(wm + i * 16 + lane % 16) * LDA_S + kk + (lane / 16) * 8];
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
            : "=r"(af[i][0]), "=r"(af[i][1]), "=r"(af[i][2]), "=r"(af[i][3])
            : "r"(smem_addr(p)));
      }
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        const __nv_bfloat16* p =
            &Bs[s][(kk + lane % 16) * LDB_S + wn + j * 8 + (lane / 16) * 8];
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
            "{%0,%1,%2,%3}, [%4];\n"
            : "=r"(bfr[j][0]), "=r"(bfr[j][1]), "=r"(bfr[j + 1][0]),
              "=r"(bfr[j + 1][1])
            : "r"(smem_addr(p)));
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma16816(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    }
    __syncthreads();
  }
}

// Whether the bf16 slabs can be staged with 16-byte copies.
inline bool mma_vec(const void* A, int64_t lda, const void* B, int64_t ldb,
                    int N, int K) {
  return K % 8 == 0 && N % 8 == 0 && lda % 8 == 0 && ldb % 8 == 0 &&
         reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(B) % 16 == 0;
}

// The tile at (m0, n0) of A @ B on the tensor cores (VEC as mma_vec
// says); epi(row, col, sum) for each in-range element.
template <bool VEC, typename Epi>
__device__ __forceinline__ void gemm_tile(const __nv_bfloat16* __restrict__ A,
                                          int64_t lda,
                                          const __nv_bfloat16* __restrict__ B,
                                          int64_t ldb, int M, int N, int K,
                                          int64_t m0, int64_t n0,
                                          const Epi& epi) {
  float acc[MT][NT][4];
  mma_loop<VEC>(A, lda, B, ldb, M, N, K, m0, n0, acc);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int64_t rbase = m0 + (warp / (BN / WN)) * WM + lane / 4;
  const int64_t cbase = n0 + (warp % (BN / WN)) * WN + 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t gr = rbase + i * 16 + h * 8;
      if (gr >= M) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int64_t gc = cbase + j * 8 + q;
          if (gc < N) epi(gr, gc, acc[i][j][h * 2 + q]);
        }
    }
}

}  // namespace da_tile
