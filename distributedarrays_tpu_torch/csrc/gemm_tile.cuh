// The block GEMM's tile loop, shared by the block GEMM (gemm.cu) and the
// ring all-gather GEMM (collectives.cu).
//
// One block of THREADS threads accumulates the 128x128 output tile at
// (m0, n0) of A[M x K] @ B[K x N] in registers: A and B slabs of depth BK
// are staged in shared memory (A stored transposed so both operands are
// read as float4 along the output tile) and each thread keeps an 8x8
// micro-tile, 64 FMAs per 16 shared-memory floats read.  The row strides
// lda and ldb let A be a column slice of a wider matrix.  Ragged edges are
// zero-padded in shared memory, so no dimension has to divide the tile.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace da_tile {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int TM = 8;
constexpr int TN = 8;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int APAD = 4;  // keeps float4 alignment of the transposed A rows

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Thread tid's micro-tile covers rows m0 + row0(tid) + [0, TM) and columns
// n0 + col0(tid) + [0, TN) of the output tile.
__device__ __forceinline__ int row0(int tid) { return (tid / (BN / TN)) * TM; }
__device__ __forceinline__ int col0(int tid) { return (tid % (BN / TN)) * TN; }

template <typename TIn>
__device__ __forceinline__ void tile_loop(const TIn* __restrict__ A,
                                          int64_t lda,
                                          const TIn* __restrict__ B,
                                          int64_t ldb, int M, int N, int K,
                                          int64_t m0, int64_t n0,
                                          float (&acc)[TM][TN]) {
  __shared__ __align__(16) float As[BK][BM + APAD];  // A slab, transposed
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // column group
  const int ty = tid / (BN / TN);  // row group

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A slab (BM x BK): consecutive threads read consecutive k of one row.
#pragma unroll
    for (int i = 0; i < BM * BK / THREADS; ++i) {
      int idx = tid + i * THREADS;
      int r = idx / BK, c = idx % BK;
      int64_t gr = m0 + r;
      int gc = k0 + c;
      As[c][r] = (gr < M && gc < K) ? to_f(A[gr * lda + gc]) : 0.f;
    }
    // B slab (BK x BN): consecutive threads read consecutive n of one row.
#pragma unroll
    for (int i = 0; i < BK * BN / THREADS; ++i) {
      int idx = tid + i * THREADS;
      int r = idx / BN, c = idx % BN;
      int gr = k0 + r;
      int64_t gc = n0 + c;
      Bs[r][c] = (gr < K && gc < N) ? to_f(B[(int64_t)gr * ldb + gc]) : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
      const float4* ap = reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4* bp = reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      float4 a0 = ap[0], a1 = ap[1], b0 = bp[0], b1 = bp[1];
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

}  // namespace da_tile
