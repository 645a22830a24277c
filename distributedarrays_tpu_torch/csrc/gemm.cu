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
// Bound on an H100: 2*m*n*k operations.  In f32 that is the 67 TFLOP/s of the
// FP32 (non-tensor) pipes; in bf16 the tensor cores' 989 TFLOP/s, which this
// kernel does not use.  Design: a 128x128x32 tile per block of 256 threads,
// A and B slabs staged in shared memory (A stored transposed so both operands
// are read as float4 along the output tile), and an 8x8 register micro-tile
// per thread: 64 FMAs per 16 shared-memory floats read.  No cp.async/TMA
// pipelining and no tensor cores yet: correct and simple first.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const TIn* __restrict__ A, const TIn* __restrict__ B,
            TOut* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(16) float As[BK][BM + APAD];  // A slab, transposed
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // column group
  const int ty = tid / (BN / TN);  // row group
  const int64_t m0 = (int64_t)blockIdx.y * BM;
  const int64_t n0 = (int64_t)blockIdx.x * BN;

  float acc[TM][TN];
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
      As[c][r] = (gr < M && gc < K) ? to_f(A[gr * K + gc]) : 0.f;
    }
    // B slab (BK x BN): consecutive threads read consecutive n of one row.
#pragma unroll
    for (int i = 0; i < BK * BN / THREADS; ++i) {
      int idx = tid + i * THREADS;
      int r = idx / BN, c = idx % BN;
      int gr = k0 + r;
      int64_t gc = n0 + c;
      Bs[r][c] = (gr < K && gc < N) ? to_f(B[(int64_t)gr * N + gc]) : 0.f;
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

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    int64_t gr = m0 + ty * TM + i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      int64_t gc = n0 + tx * TN + j;
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
