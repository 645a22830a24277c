// Block GEMM for Hopper (sm_90a): C = A @ B with a float32 accumulator.
//
// Replaces the Pallas TPU kernel distributedarrays_tpu/ops/pallas_gemm.py
// `_kernel` (built by `_build`, called by `pallas_matmul`).  That kernel walks
// a sequential (M/bm, N/bn, K/bk) grid with the K axis innermost and carries
// an f32 VMEM accumulator across the K steps of one output tile.  On Hopper
// the blocks run in parallel, so each block owns one 128x128 output tile and
// loops over K itself, with the accumulator in registers.
//
// Types: f32 x f32 in true FP32 FMA (no TF32), or bf16 x bf16 with f32
// accumulation; the output is f32 or bf16.  Ragged edges are masked here, so
// unlike the Pallas kernel no dimension has to divide the tile.
//
// The tile loop lives in gemm_tile.cuh (shared with the ring all-gather
// GEMM in collectives.cu).
//
// Bound on an H100: 2*m*n*k operations.  In f32 that is the 67 TFLOP/s of the
// FP32 (non-tensor) pipes; in bf16 the tensor cores' 989 TFLOP/s, which this
// kernel does not use.  Design: a 128x128x32 tile per block of 256 threads,
// A and B slabs staged in shared memory (A stored transposed so both operands
// are read as float4 along the output tile), and an 8x8 register micro-tile
// per thread: 64 FMAs per 16 shared-memory floats read.  No cp.async/TMA
// pipelining and no tensor cores yet: correct and simple first.

#include "gemm_tile.cuh"

namespace {

using namespace da_tile;

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const TIn* __restrict__ A, const TIn* __restrict__ B,
            TOut* __restrict__ C, int M, int N, int K) {
  const int64_t m0 = (int64_t)blockIdx.y * BM;
  const int64_t n0 = (int64_t)blockIdx.x * BN;
  float acc[TM][TN];
  tile_loop<TIn>(A, K, B, N, M, N, K, m0, n0, acc);

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    int64_t gr = m0 + row0(threadIdx.x) + i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      int64_t gc = n0 + col0(threadIdx.x) + j;
      if (gc < N) store(&C[gr * N + gc], acc[i][j]);
    }
  }
}

template <typename TIn, typename TOut>
int launch(const void* a, const void* b, void* c, int m, int n, int k,
           cudaStream_t stream) {
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  gemm_kernel<TIn, TOut><<<grid, THREADS, 0, stream>>>(
      static_cast<const TIn*>(a), static_cast<const TIn*>(b),
      static_cast<TOut*>(c), m, n, k);
  return (int)cudaGetLastError();
}

}  // namespace

// in_bf16: A and B are bf16 (else f32).  out_bf16: C is bf16 (else f32).
// `device` is the CUDA device index of the tensors and the stream.
// Returns the cudaGetLastError() code of the launch (0 = cudaSuccess).
extern "C" int da_gemm(const void* a, const void* b, void* c, int m, int n,
                       int k, int in_bf16, int out_bf16, int device,
                       void* stream) {
  if (m <= 0 || n <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    return out_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(a, b, c, m, n, k, s)
                    : launch<__nv_bfloat16, float>(a, b, c, m, n, k, s);
  }
  return out_bf16 ? launch<float, __nv_bfloat16>(a, b, c, m, n, k, s)
                  : launch<float, float>(a, b, c, m, n, k, s);
}
