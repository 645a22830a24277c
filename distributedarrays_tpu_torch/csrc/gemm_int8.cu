// int8 GEMM with fused dequantization for Hopper (sm_90a):
//   C[i, j] = f32(sum_k qa[i, k] * qb[k, j]) * (sa[i] * sb[j])
//
// Replaces the Pallas TPU kernel distributedarrays_tpu/ops/pallas_gemm.py
// `_int8_kernel` (built by `_build_int8`, called by `pallas_matmul_int8`).
// That kernel carries an int32 VMEM accumulator across a sequential K grid
// axis and dequantizes in the last step's flush.  Here each block owns one
// 128x128 output tile, loops over K itself with the int32 accumulators in
// registers, and dequantizes in the tile flush.
//
// Arithmetic: the products run on the tensor cores through
// mma.sync.m16n8k32.s32.s8.s8.s32, so the sum over k is an exact int32 sum
// (no rounding while |acc| < 2^31, i.e. for every K <= (2^31-1)/127^2 even
// with saturated codes).  The flush computes int32 -> f32 (round to
// nearest), sa[i] * sb[j] in f32, and their product in f32, each rounded
// once (__fmul_rn, no contraction), which is what the plain version and the
// JAX kernel compute; the kernel therefore equals the plain version bit for
// bit.  Output f32 or bf16 (one round to nearest even).
//
// Bound on an H100: 2*m*n*k integer operations over the 1979 TOP/s of the
// dense int8 tensor cores (16384^3: about 4.4 ms).  Design, simple first: a
// 128x128x64 tile per block of 8 warps (each warp a 64x32 sub-tile: 4x4
// mma tiles), A staged as [m][k] and B transposed to [n][k] in shared memory
// so every mma fragment register is one aligned 32-bit load, rows padded to
// 80 bytes so those loads are free of bank conflicts.  When K and N are
// multiples of 16 the slabs load as 16-byte (A) and 4x4-byte transposed (B)
// vectors; otherwise byte by byte.  Ragged m/n/k are zero-padded in shared
// memory, so no dimension has to divide the tile (the Pallas kernel needs
// divisibility).  No cp.async/TMA pipelining and no wgmma yet.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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
int launch(const void* qa, const void* qb, const float* sa, const float* sb,
           void* c, int m, int n, int k, cudaStream_t stream) {
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  gemm_int8_kernel<VEC, TOut><<<grid, THREADS, 0, stream>>>(
      static_cast<const int8_t*>(qa), static_cast<const int8_t*>(qb), sa, sb,
      static_cast<TOut*>(c), m, n, k);
  return (int)cudaGetLastError();
}

}  // namespace

// qa (m,k) and qb (k,n) int8, row-major; sa (m,) and sb (n,) f32; c (m,n) f32
// or, with out_bf16, bf16.  `device` is the CUDA device of the tensors and
// the stream.  Returns the cudaGetLastError() code of the launch.
extern "C" int da_gemm_int8(const void* qa, const void* qb, const void* sa,
                            const void* sb, void* c, int m, int n, int k,
                            int out_bf16, int device, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fa = static_cast<const float*>(sa);
  const float* fb = static_cast<const float*>(sb);
  const bool vec = (k % 16 == 0) && (n % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(qa) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(qb) % 16 == 0);
  if (vec)
    return out_bf16 ? launch<true, __nv_bfloat16>(qa, qb, fa, fb, c, m, n, k, s)
                    : launch<true, float>(qa, qb, fa, fb, c, m, n, k, s);
  return out_bf16 ? launch<false, __nv_bfloat16>(qa, qb, fa, fb, c, m, n, k, s)
                  : launch<false, float>(qa, qb, fa, fb, c, m, n, k, s);
}
