// Block GEMM for Hopper (sm_90a): C = A @ B with a float32 accumulator.
//
// Replaces the Pallas TPU kernel distributedarrays_tpu/ops/pallas_gemm.py
// `_kernel` (built by `_build`, called by `pallas_matmul`).  That kernel walks
// a sequential (M/bm, N/bn, K/bk) grid with the K axis innermost and carries
// an f32 VMEM accumulator across the K steps of one output tile.  On Hopper
// the blocks run in parallel, so each block owns one output tile and loops
// over K itself, with the accumulator in registers.
//
// Three routes, chosen by the caller (ops/cuda_gemm.py `gemm_route`, by
// dtype and shape) and passed in as `route`; each raises through its return
// code rather than falling back to another:
// - ROUTE_WGMMA, bf16 x bf16 with K and N multiples of 8 and 16-byte
//   aligned bases: gemm_sm90.cuh `wgmma_tile`, a 128 x 256 tile on wgmma
//   fed by TMA through a 4-stage mbarrier ring, one producer warp and two
//   consumer warpgroups.  Bound: 2*m*n*k operations at the tensor cores'
//   989 TFLOP/s.
// - ROUTE_MMA, any other bf16 shape: gemm_tile.cuh's 128 x 128 tensor-core
//   tile (mma.sync, slabs staged element by element), the tile the ring
//   GEMMs use.
// - ROUTE_F32, f32 x f32 in true FP32 FMA (no TF32): gemm_sm90.cuh
//   `f32_tile`, a 128 x 128 tile whose slabs stream through three cp.async
//   stages.  Bound: 2*m*n*k operations at the FP32 pipes' 67 TFLOP/s.
// The output is f32 or bf16 on every route.  Ragged edges are masked here,
// so unlike the Pallas kernel no dimension has to divide the tile.  The
// TMA tensor maps are encoded on the host at each call (microseconds).

#include "gemm_sm90.cuh"
#include "gemm_tile.cuh"

namespace {

using bf = __nv_bfloat16;

constexpr int ROUTE_F32 = 0;
constexpr int ROUTE_MMA = 1;
constexpr int ROUTE_WGMMA = 2;
// the wgmma route's tile width: 128 x 256 tiles read 0.2505 ms at 4096^3
// against 0.2878 ms for 128 x 128 (H100 80GB HBM3, 700 W, chip_smoke.py)
constexpr int WG_BN = 256;

template <typename TOut>
struct Store {
  TOut* c;
  int64_t ldc;
  __device__ void operator()(int64_t r, int64_t col, float v) const {
    da_tile::store(&c[r * ldc + col], v);
  }
};

template <int BN, typename TOut>
__global__ void __launch_bounds__(da_sm90::WG_THREADS, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                  const __grid_constant__ CUtensorMap tb, TOut* __restrict__ C,
                  int M, int N, int K) {
  extern __shared__ uint8_t smem[];
  da_sm90::wgmma_tile<BN>(&ta, &tb, M, N, K, blockIdx.y * da_sm90::WG_BM,
                          blockIdx.x * BN, smem, Store<TOut>{C, N});
}

template <bool VEC, typename TOut>
__global__ void __launch_bounds__(da_tile::THREADS)
gemm_mma_kernel(const bf* __restrict__ A, const bf* __restrict__ B,
                TOut* __restrict__ C, int M, int N, int K) {
  da_tile::gemm_tile<VEC>(A, K, B, N, M, N, K,
                          (int64_t)blockIdx.y * da_tile::BM,
                          (int64_t)blockIdx.x * da_tile::BN,
                          Store<TOut>{C, N});
}

template <bool VEC, typename TOut>
__global__ void __launch_bounds__(da_sm90::F_THREADS, 1)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                TOut* __restrict__ C, int M, int N, int K) {
  extern __shared__ float4 smem_f[];
  da_sm90::f32_tile<VEC>(A, K, B, N, M, N, K,
                         (int64_t)blockIdx.y * da_sm90::F_BM,
                         (int64_t)blockIdx.x * da_sm90::F_BN,
                         reinterpret_cast<float*>(smem_f), Store<TOut>{C, N});
}

template <typename K>
cudaError_t fit_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename TOut>
int launch_wgmma(const void* a, const void* b, void* c, int m, int n, int k,
                 cudaStream_t s) {
  if (!da_sm90::wgmma_ok(a, k, b, n, k)) return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  int rc = da_sm90::wgmma_maps(&ta, &tb, a, k, b, m, n, k);
  if (rc) return rc;
  const size_t sm = da_sm90::wg_smem_bytes<WG_BN>();
  cudaError_t err = fit_smem(gemm_wgmma_kernel<WG_BN, TOut>, sm);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + WG_BN - 1) / WG_BN, (m + da_sm90::WG_BM - 1) / da_sm90::WG_BM);
  gemm_wgmma_kernel<WG_BN, TOut><<<grid, da_sm90::WG_THREADS, sm, s>>>(
      ta, tb, static_cast<TOut*>(c), m, n, k);
  return (int)cudaGetLastError();
}

template <typename TOut>
int launch_mma(const void* a, const void* b, void* c, int m, int n, int k,
               cudaStream_t s) {
  dim3 grid((n + da_tile::BN - 1) / da_tile::BN,
            (m + da_tile::BM - 1) / da_tile::BM);
  const bf* A = static_cast<const bf*>(a);
  const bf* B = static_cast<const bf*>(b);
  if (da_tile::mma_vec(a, k, b, n, n, k))
    gemm_mma_kernel<true, TOut><<<grid, da_tile::THREADS, 0, s>>>(
        A, B, static_cast<TOut*>(c), m, n, k);
  else
    gemm_mma_kernel<false, TOut><<<grid, da_tile::THREADS, 0, s>>>(
        A, B, static_cast<TOut*>(c), m, n, k);
  return (int)cudaGetLastError();
}

template <bool VEC, typename TOut>
int launch_f32_as(const float* A, const float* B, void* c, int m, int n,
                  int k, cudaStream_t s) {
  cudaError_t err = fit_smem(gemm_f32_kernel<VEC, TOut>, da_sm90::F_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + da_sm90::F_BN - 1) / da_sm90::F_BN,
            (m + da_sm90::F_BM - 1) / da_sm90::F_BM);
  gemm_f32_kernel<VEC, TOut>
      <<<grid, da_sm90::F_THREADS, da_sm90::F_SMEM, s>>>(
          A, B, static_cast<TOut*>(c), m, n, k);
  return (int)cudaGetLastError();
}

template <typename TOut>
int launch_f32(const void* a, const void* b, void* c, int m, int n, int k,
               cudaStream_t s) {
  const float* A = static_cast<const float*>(a);
  const float* B = static_cast<const float*>(b);
  return da_sm90::f32_vec(a, k, b, n, n, k)
             ? launch_f32_as<true, TOut>(A, B, c, m, n, k, s)
             : launch_f32_as<false, TOut>(A, B, c, m, n, k, s);
}

template <typename TOut>
int launch(int route, const void* a, const void* b, void* c, int m, int n,
           int k, cudaStream_t s) {
  switch (route) {
    case ROUTE_WGMMA: return launch_wgmma<TOut>(a, b, c, m, n, k, s);
    case ROUTE_MMA: return launch_mma<TOut>(a, b, c, m, n, k, s);
    case ROUTE_F32: return launch_f32<TOut>(a, b, c, m, n, k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// route: 0 = f32 operands (cp.async-pipelined SIMT loop), 1 = bf16 on
// mma.sync, 2 = bf16 on wgmma + TMA (K and N multiples of 8, 16-byte
// aligned bases).  out_bf16: C is bf16 (else f32).  `device` is the CUDA
// device index of the tensors and the stream.  Returns the
// cudaGetLastError() code of the launch (0 = cudaSuccess), or 1000 + the
// CUresult of the TMA tensor-map encoding when it fails.
extern "C" int da_gemm(const void* a, const void* b, void* c, int m, int n,
                       int k, int route, int out_bf16, int device,
                       void* stream) {
  if (m <= 0 || n <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_bf16 ? launch<bf>(route, a, b, c, m, n, k, s)
                  : launch<float>(route, a, b, c, m, n, k, s);
}
