// Collective data movement and the ring GEMMs for Hopper (sm_90a).
//
// Replaces six Pallas TPU RDMA kernels of
// distributedarrays_tpu/ops/pallas_collectives.py:
//
// - `_ag_call` (ring_all_gather, K10) and `_a2a_call` (ring_all_to_all,
//   K11).  On the TPU each rank DMAs blocks or pieces around the ICI ring
//   into its neighbours' outputs, with send/receive semaphores and staging
//   chunks sized to VMEM.  On Hopper a remote DMA becomes a load through
//   another rank's device pointer (the same card, or a peer card after
//   cudaDeviceEnablePeerAccess, over NVLink/NVSwitch).  The design pulls:
//   one launch per card copies every source's block or piece straight to
//   its final offset in each of that card's destination outputs, so there
//   is no staging, no ring order and no semaphore.  `da_copy_pieces` is
//   that launch: up to COPY_MAXP strided source boxes (3 outer dims and
//   one contiguous run, all in bytes), each with the list of destinations
//   it goes to (COPY_MAXP copies in all; the wrapper's `copy_launches`
//   groups them).  COPY_MAXP is 64 where the toolkit takes kernel
//   parameters above 4 KB (CUDA 12.1 on sm_70 and later; the plan is
//   7.2 KB), so an all-to-all of 8 ranks on one card is one launch; else
//   MAXP (32).  `da_copy_maxp` reports it.  A warp copies one unit of 32 lanes x COPY_UNROLL accesses of
//   16, 4 or 1 bytes, whichever the source and all its destinations allow:
//   each lane issues its COPY_UNROLL loads (ld.global.nc) before any store,
//   then stores the unit to every destination, so an all-gather reads each
//   source once for all the card's destinations.  The grid has a warp per
//   unit, the launch's units numbered source by source, so the blocks in
//   flight cover one contiguous stretch of each box; a warp finds its
//   source among the launch's by their first units, unit and row indices
//   are 32-bit, and a box that is one contiguous run skips the row
//   arithmetic.  (A persistent grid of the card's resident blocks, and
//   more loads in flight a lane, measured slower: PERF.md §6.)
//   Bound: each source byte read once and each destination byte written
//   once, over 3.35 TB/s (one card); across cards the peer's bytes cross
//   NVLink by the same plain loads and stores.
//   Across controller processes (a DArray that spans the processes of a
//   multi-process job, `multihost.gather_global`) the same launch reads
//   the peer processes' chunks through CUDA IPC pointers (da_ipc_handle /
//   da_ipc_open at the end of this file): one launch a process writes its
//   own whole copy of the array.
//
// - `_rs_call` (ring_reduce_scatter, K12).  On the TPU the partial for
//   destination d seeds at rank d+1 and travels the ring, each hop adding
//   its own piece (recv + own, rounded to the type), through VMEM receive
//   slots gated by credits.  `da_reduce_pieces` pulls instead: one launch
//   per destination rank reads piece d of every rank through device
//   pointers and writes the left fold over ranks d+1, d+2, ..., d+p (mod
//   p), each add rounded to the type, which is the TPU ring's arrival
//   order: bit-exact against the plain fold, with no partial ever stored.
//   Bound: the bytes moved, each piece read once and each output written
//   once, over 3.35 TB/s (one card).  A piece that is one contiguous run
//   is read as 16-byte vectors.
//
// - The three ring GEMMs, `_ag_mm_call` (ring_allgather_matmul, K13),
//   `_ag_mm_rhs_call` (ring_allgather_matmul_rhs, K14) and `_mm_rs_call`
//   (ring_matmul_reducescatter, K15).  On the TPU each starts the next
//   chunk's (or partial's) RDMA before the resident block's dot and waits
//   after it, through VMEM slots gated by semaphores.  Here one launch per
//   rank per ring step does both halves of that step:
//
//   K13 `da_ring_ag_mm_a_step`: all_gather(x) @ w with x's row chunks
//   travelling.  The launch forwards the resident chunk into the left
//   neighbour's free slot of its two-slot buffer (read by that neighbour
//   only at the next step, so nothing races: the GPU form of "start the
//   DMA before the dot, wait after it") and computes the chunk's product
//   with w, written, cast once from f32 to the output type, into the
//   chunk's own row block of out (each row block written once).
//
//   K14 `da_ring_ag_mm_step`: a @ all_gather(b) with b's row chunks
//   travelling; forwarding as K13, and the chunk's product with its column
//   slice of a, cast to the output type, is written at step 0 and added
//   (rounded to the type) after, the JAX kernel's step order and rounding.
//
//   K13, K14 and K15 take one of three routes, chosen by the caller
//   (ops/cuda_collectives.py `ring_gemm_route`) and refused here when the
//   operands cannot take it, never swapped for another:
//   - ROUTE_WGMMA, bf16 that TMA can read (K, N and a's row stride
//     multiples of 8, 16-byte aligned bases): gemm_sm90.cuh `wgmma_tile`
//     on 128 x BN tiles, BN chosen by the caller from the shape
//     (`ring_tile_n` in the wrapper gives the measured choice), each as
//     many stages deep as fit beside the output tile.  The forward rides
//     on the loads: the blocks of output column tile 0 (K13) load every
//     box of the chunk, which is A there, and the blocks of output row
//     tile 0 (K14, where the chunk is B) likewise, so those blocks store
//     each box on to the neighbour's slot by TMA from the stage it landed
//     in.  The chunk is read from device memory once and
//     no block only copies: a copy block would hold an SM's shared memory.
//     ROUTE_WGMMA_PEER, for a slot on another card, forwards by a separate
//     copy launch instead (a TMA store into a peer card's memory has not
//     been run).  The output tile leaves through shared memory by a TMA
//     store; K14's tile is first loaded by TMA behind the last operand
//     loads, so its add reads shared memory.  At these shapes a step's
//     fixed cost (launch, first loads, epilogue) is as large as its
//     products: see PERF.md.
//   - ROUTE_MMA, any other bf16: gemm_tile.cuh's mma.sync tile, with
//     RING_COPY_BLOCKS extra blocks of the launch copying the chunk (K13,
//     K14).
//   - ROUTE_F32: gemm_sm90.cuh `f32_tile` (cp.async-pipelined SIMT loop,
//     96 KB of shared memory); the blocks of column (K13) or row (K14)
//     tile 0 store each slab of the chunk they stage on to the slot.
//
//   K15 `da_ring_mm_rs_step`: reduce_scatter(x @ w).  At each step the
//   launch computes one destination's block x[d rows] @ w, casts it to the
//   type, adds the partial that arrived from the left (recv + block, in
//   the type, as the JAX kernel's `recv + tmp`) and writes the sum straight
//   into the right neighbour's receive slot, or into out at the last step:
//   the partial's forward is the epilogue's store, so no block copies.
//   Its routes are K13's, chosen the same way (below); on ROUTE_WGMMA the
//   received partial's tile is loaded by TMA behind the last operand loads
//   (through a map of its own: it lies in recv, the sum goes to dst) and
//   the sum leaves by a TMA store; ROUTE_WGMMA_PEER, for a dst on another
//   card, keeps the same products with an element-by-element epilogue
//   (plain loads of recv, plain stores over NVLink).  Bound: as a GEMM,
//   2*m*n*k operations a step.
//
//   Ring steps are ordered by stream order on one card and by event waits
//   across cards, never by flags spun on inside a kernel.

#include <cstring>

#include "gemm_sm90.cuh"
#include "gemm_tile.cuh"

namespace {

using bf = __nv_bfloat16;

constexpr int MAXP = 32;
#if CUDART_VERSION >= 12010
constexpr int COPY_MAXP = 64;
#else
constexpr int COPY_MAXP = MAXP;
#endif
constexpr int COPY_THREADS = 256;
constexpr int RING_COPY_BLOCKS = 32;

constexpr int COPY_UNROLL = 4;  // loads in flight a lane before its stores

// One source box of a copy launch and the destinations it goes to.
struct CopySrc {
  const char* src;
  long long stride[3];  // bytes, outer dims
  long long row_bytes;  // contiguous run
  long long first;      // its first unit's index in the launch
  int size[3];          // outer extents
  int segs;             // units a run
  int units;            // size[0] * size[1] * size[2] * segs
  int dst0, ndst;       // its destinations: d[dst0 .. dst0 + ndst)
  int vec;              // 16, 4 or 1: bytes an access
};

struct CopyDst {
  char* dst;
  long long stride[3];
};

struct CopyPlan {
  CopySrc s[COPY_MAXP];
  CopyDst d[COPY_MAXP];
  int nsrc;
};

// Unit u of source s: lane's COPY_UNROLL loads, then its stores to each of
// the source's destinations.
template <typename V>
__device__ __forceinline__ void copy_unit(const CopyPlan& p, const CopySrc& s,
                                          int u, int lane) {
  int i0 = 0, i1 = 0, i2 = 0, seg = u;
  if (s.units != s.segs) {  // several runs: this unit's run and segment
    const int run = u / s.segs;
    seg = u - run * s.segs;
    const int t = run / s.size[2];
    i2 = run - t * s.size[2];
    i0 = t / s.size[1];
    i1 = t - i0 * s.size[1];
  }
  const long long n = s.row_bytes / (long long)sizeof(V);
  const long long e = (long long)seg * (32 * COPY_UNROLL) + lane;
  const V* src = reinterpret_cast<const V*>(
      s.src + i0 * s.stride[0] + i1 * s.stride[1] + i2 * s.stride[2]);
  V r[COPY_UNROLL];
#pragma unroll
  for (int j = 0; j < COPY_UNROLL; ++j)
    if (e + 32 * j < n) r[j] = __ldg(src + e + 32 * j);
  for (int q = 0; q < s.ndst; ++q) {
    const CopyDst& d = p.d[s.dst0 + q];
    V* dst = reinterpret_cast<V*>(d.dst + i0 * d.stride[0] +
                                  i1 * d.stride[1] + i2 * d.stride[2]);
#pragma unroll
    for (int j = 0; j < COPY_UNROLL; ++j)
      if (e + 32 * j < n) dst[e + 32 * j] = r[j];
  }
}

// A warp per unit: unit g of the launch is unit g - first of the source
// whose units start at or before it.
__global__ void __launch_bounds__(COPY_THREADS) copy_kernel(const CopyPlan p) {
  const long long g =
      (long long)blockIdx.x * (COPY_THREADS / 32) + threadIdx.x / 32;
  int q = 0;
  while (q + 1 < p.nsrc && g >= p.s[q + 1].first) ++q;
  const CopySrc& s = p.s[q];
  if (g - s.first >= s.units) return;  // the last block's spare warps
  const int u = (int)(g - s.first), lane = threadIdx.x % 32;
  if (s.vec == 16)
    copy_unit<uint4>(p, s, u, lane);
  else if (s.vec == 4)
    copy_unit<uint32_t>(p, s, u, lane);
  else
    copy_unit<unsigned char>(p, s, u, lane);
}

// Blocks [0, ncopy) copy the contiguous `elems` elements of src into dst:
// a ring step's forward of its resident chunk.
template <typename T>
__device__ __forceinline__ void forward_copy(const T* __restrict__ src,
                                             T* __restrict__ dst,
                                             int64_t elems, int ncopy) {
  const int64_t bytes = elems * (int64_t)sizeof(T);
  const int64_t tid = (int64_t)blockIdx.x * da_tile::THREADS + threadIdx.x;
  const int64_t stride = (int64_t)ncopy * da_tile::THREADS;
  if (bytes % 16 == 0 && (uintptr_t)src % 16 == 0 && (uintptr_t)dst % 16 == 0) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (int64_t i = tid; i < bytes / 16; i += stride) d[i] = s[i];
  } else {
    for (int64_t i = tid; i < elems; i += stride) dst[i] = src[i];
  }
}

// The output tile of a ring GEMM launch after its ncopy copy blocks.
__device__ __forceinline__ void tile_origin(int ncopy, int N, int64_t& m0,
                                            int64_t& n0) {
  const int tile = blockIdx.x - ncopy;
  const int ntn = (N + da_tile::BN - 1) / da_tile::BN;
  m0 = (int64_t)(tile / ntn) * da_tile::BM;
  n0 = (int64_t)(tile % ntn) * da_tile::BN;
}

// out[r, c] = the sum, cast to T
template <typename T>
struct StoreEpi {
  T* out;
  int64_t ld;
  __device__ void operator()(int64_t r, int64_t c, float v) const {
    da_tile::store(&out[r * ld + c], v);
  }
};

// part = the sum cast to T; out[r, c] = part (first) or out + part in T
template <typename T>
struct AccumEpi {
  T* out;
  int64_t ld;
  int first;
  __device__ void operator()(int64_t r, int64_t c, float v) const {
    T part;
    da_tile::store(&part, v);  // the f32 product cast to the output type
    T* o = &out[r * ld + c];
    if (first)
      *o = part;
    else
      da_tile::store(o, __fadd_rn(da_tile::to_f(*o), da_tile::to_f(part)));
  }
};

// part = the sum cast to T; dst[r, c] = recv + part in T (part alone
// without recv)
template <typename T>
struct ReduceEpi {
  const T* recv;
  T* dst;
  int64_t ld;
  __device__ void operator()(int64_t r, int64_t c, float v) const {
    T part;
    da_tile::store(&part, v);
    const int64_t o = r * ld + c;
    if (recv)
      da_tile::store(&dst[o],
                     __fadd_rn(da_tile::to_f(recv[o]), da_tile::to_f(part)));
    else
      dst[o] = part;
  }
};

// K14's step on mma.sync: blocks [0, ncopy) forward `chunk` (K x N) to
// `fwd`, the others compute one 128x128 tile of a[:, koff:koff+K] @ chunk
// and add it into out.
template <bool VEC>
__global__ void __launch_bounds__(da_tile::THREADS)
ring_ag_mm_kernel(const bf* __restrict__ a, const bf* __restrict__ chunk,
                  bf* __restrict__ out, bf* __restrict__ fwd, int M, int N,
                  int K, int64_t lda, int64_t koff, int first, int ncopy) {
  if ((int)blockIdx.x < ncopy) {
    forward_copy(chunk, fwd, (int64_t)K * N, ncopy);
    return;
  }
  int64_t m0, n0;
  tile_origin(ncopy, N, m0, n0);
  da_tile::gemm_tile<VEC>(a + koff, lda, chunk, N, M, N, K, m0, n0,
                          AccumEpi<bf>{out, N, first});
}

// K13's step on mma.sync: blocks [0, ncopy) forward `chunk` (M x K) to
// `fwd`, the others compute one tile of chunk @ w (K x N) into the row
// block `out` (M x N).
template <bool VEC>
__global__ void __launch_bounds__(da_tile::THREADS)
ring_ag_mm_a_kernel(const bf* __restrict__ chunk, const bf* __restrict__ w,
                    bf* __restrict__ out, bf* __restrict__ fwd, int M, int N,
                    int K, int ncopy) {
  if ((int)blockIdx.x < ncopy) {
    forward_copy(chunk, fwd, (int64_t)M * K, ncopy);
    return;
  }
  int64_t m0, n0;
  tile_origin(ncopy, N, m0, n0);
  da_tile::gemm_tile<VEC>(chunk, K, w, N, M, N, K, m0, n0,
                          StoreEpi<bf>{out, N});
}

// the chunk alone to `fwd`: the peer route's forward launch
template <typename T>
__global__ void __launch_bounds__(da_tile::THREADS)
forward_kernel(const T* __restrict__ src, T* __restrict__ dst,
               int64_t elems) {
  forward_copy(src, dst, elems, gridDim.x);
}

// K13's output pairs: the sums cast to bf16
struct CastPairs {
  bool accumulate = false;
  __device__ __nv_bfloat162 operator()(float v0, float v1,
                                       __nv_bfloat162) const {
    return __floats2bfloat162_rn(v0, v1);
  }
};

// K14's output pairs: part = the sums cast to bf16; part at the first
// step, else prior + part rounded to bf16, as AccumEpi element by element
struct AccumPairs {
  bool accumulate;  // not the first step
  __device__ __nv_bfloat162 operator()(float v0, float v1,
                                       __nv_bfloat162 prior) const {
    const __nv_bfloat162 part = __floats2bfloat162_rn(v0, v1);
    if (!accumulate) return part;
    const float2 x = __bfloat1622float2(prior), y = __bfloat1622float2(part);
    return __floats2bfloat162_rn(__fadd_rn(x.x, y.x), __fadd_rn(x.y, y.y));
  }
};

// Stages of a wgmma ring step: as many as fit in a block's shared memory
// beside the output tile (8 at BN = 64, 6 at BN = 128).
template <int BN>
__host__ __device__ constexpr int ring_stages() {
  return (227 * 1024 - 2048 - da_sm90::WG_BM * BN * 2) /
         da_sm90::wg_stage_bytes<BN>();
}

// K13's step on wgmma: one 128 x BN tile of chunk (ta: M x K) @ w (tb:
// K x N) into the row block `to` maps (M x N); with `forward`, the blocks
// of column tile 0 store the chunk's boxes on to the slot tf maps.
template <int BN>
__global__ void __launch_bounds__(da_sm90::WG_THREADS, 1)
ring_ag_mm_a_wgmma(const __grid_constant__ CUtensorMap ta,
                   const __grid_constant__ CUtensorMap tb,
                   const __grid_constant__ CUtensorMap tf,
                   const __grid_constant__ CUtensorMap to, int M, int N,
                   int K, int forward) {
  extern __shared__ uint8_t smem[];
  const int ntn = (N + BN - 1) / BN;
  const int m0 = blockIdx.x / ntn * da_sm90::WG_BM;
  const int n0 = blockIdx.x % ntn * BN;
  da_sm90::wgmma_tile<BN, CastPairs, da_sm90::FWD_A, true,
                      ring_stages<BN>()>(
      &ta, &tb, M, N, K, m0, n0, smem, CastPairs{},
      forward && n0 == 0 ? &tf : nullptr, &to);
}

// K14's step on wgmma: one 128 x BN tile of a[:, koff:koff+K] (ta) @ chunk
// (tb: K x N) added into out (`to`, M x N); with `forward`, the blocks of
// row tile 0 store the chunk's boxes on to the slot tf maps.
template <int BN>
__global__ void __launch_bounds__(da_sm90::WG_THREADS, 1)
ring_ag_mm_wgmma(const __grid_constant__ CUtensorMap ta,
                 const __grid_constant__ CUtensorMap tb,
                 const __grid_constant__ CUtensorMap tf,
                 const __grid_constant__ CUtensorMap to, int M, int N, int K,
                 int first, int forward) {
  extern __shared__ uint8_t smem[];
  const int ntn = (N + BN - 1) / BN;
  const int m0 = blockIdx.x / ntn * da_sm90::WG_BM;
  const int n0 = blockIdx.x % ntn * BN;
  da_sm90::wgmma_tile<BN, AccumPairs, da_sm90::FWD_B, true,
                      ring_stages<BN>()>(
      &ta, &tb, M, N, K, m0, n0, smem, AccumPairs{!first},
      forward && m0 == 0 ? &tf : nullptr, &to);
}

// The f32 route's forward: a block whose `dst` is set stores the in-range
// part of each slab of the chunk it stages, A's (IS_A: F_BM x F_BK at rows
// `fixed`.., columns k0..) or B's (F_BK x F_BN at rows k0.., columns
// `fixed`..), on to dst, a contiguous rows x cols matrix.  VEC: cols a
// multiple of 4 and dst 16-byte aligned.
template <bool VEC, bool IS_A>
struct FwdSlab {
  float* dst;
  int rows, cols;
  int64_t fixed;
  __device__ __forceinline__ void operator()(int k0, const float* as,
                                             const float* bs) const {
    if (!dst) return;
    constexpr int R = IS_A ? da_sm90::F_BM : da_sm90::F_BK;
    constexpr int C = IS_A ? da_sm90::F_BK : da_sm90::F_BN;
    constexpr int V = VEC ? 4 : 1;
    const float* src = IS_A ? as : bs;
    const int64_t r0 = IS_A ? fixed : k0, c0 = IS_A ? k0 : fixed;
    for (int i = threadIdx.x; i < R * C / V; i += da_sm90::F_THREADS) {
      const int r = i / (C / V), c = (i % (C / V)) * V;
      if (r0 + r >= rows || c0 + c >= cols) continue;
      float* d = dst + (r0 + r) * cols + c0 + c;
      if constexpr (VEC)
        *reinterpret_cast<float4*>(d) =
            *reinterpret_cast<const float4*>(src + r * C + c);
      else
        *d = src[r * C + c];
    }
  }
};

// K13's step in f32: one 128 x 128 tile of chunk (M x K) @ w (K x N) into
// out; the blocks of column tile 0 forward the chunk's slabs to fwd.
template <bool VEC>
__global__ void __launch_bounds__(da_sm90::F_THREADS, 1)
ring_ag_mm_a_f32(const float* __restrict__ chunk, const float* __restrict__ w,
                 float* __restrict__ out, float* __restrict__ fwd, int M,
                 int N, int K) {
  extern __shared__ float4 smem_f[];
  const int ntn = (N + da_sm90::F_BN - 1) / da_sm90::F_BN;
  const int64_t m0 = (int64_t)(blockIdx.x / ntn) * da_sm90::F_BM;
  const int64_t n0 = (int64_t)(blockIdx.x % ntn) * da_sm90::F_BN;
  da_sm90::f32_tile<VEC>(chunk, K, w, N, M, N, K, m0, n0,
                         reinterpret_cast<float*>(smem_f),
                         StoreEpi<float>{out, N},
                         FwdSlab<VEC, true>{n0 == 0 ? fwd : nullptr, M, K,
                                            m0});
}

// K14's step in f32: one 128 x 128 tile of a[:, koff:koff+K] (`a` points
// at the slice, rows lda apart) @ chunk (K x N) added into out; the blocks
// of row tile 0 forward the chunk's slabs to fwd.
template <bool VEC>
__global__ void __launch_bounds__(da_sm90::F_THREADS, 1)
ring_ag_mm_f32(const float* __restrict__ a, const float* __restrict__ chunk,
               float* __restrict__ out, float* __restrict__ fwd, int M,
               int N, int K, int64_t lda, int first) {
  extern __shared__ float4 smem_f[];
  const int ntn = (N + da_sm90::F_BN - 1) / da_sm90::F_BN;
  const int64_t m0 = (int64_t)(blockIdx.x / ntn) * da_sm90::F_BM;
  const int64_t n0 = (int64_t)(blockIdx.x % ntn) * da_sm90::F_BN;
  da_sm90::f32_tile<VEC>(a, lda, chunk, N, M, N, K, m0, n0,
                         reinterpret_cast<float*>(smem_f),
                         AccumEpi<float>{out, N, first},
                         FwdSlab<VEC, false>{m0 == 0 ? fwd : nullptr, K, N,
                                             n0});
}

// K15's step on mma.sync: one tile of x (M x K) @ w (K x N), cast to bf16,
// plus recv (M x N, or null), written to dst (M x N).
template <bool VEC>
__global__ void __launch_bounds__(da_tile::THREADS)
ring_mm_rs_kernel(const bf* __restrict__ x, const bf* __restrict__ w,
                  const bf* __restrict__ recv, bf* __restrict__ dst, int M,
                  int N, int K) {
  int64_t m0, n0;
  tile_origin(0, N, m0, n0);
  da_tile::gemm_tile<VEC>(x, K, w, N, M, N, K, m0, n0,
                          ReduceEpi<bf>{recv, dst, N});
}

// K15's step on wgmma: one 128 x BN tile of x's row block (ta: M x K) @ w
// (tb: K x N), cast to bf16 and, after the first step, added in bf16 to
// the received partial's tile (tp, M x N), into dst (`to`, M x N).
template <int BN>
__global__ void __launch_bounds__(da_sm90::WG_THREADS, 1)
ring_mm_rs_wgmma(const __grid_constant__ CUtensorMap ta,
                 const __grid_constant__ CUtensorMap tb,
                 const __grid_constant__ CUtensorMap tp,
                 const __grid_constant__ CUtensorMap to, int M, int N, int K,
                 int first) {
  extern __shared__ uint8_t smem[];
  const int ntn = (N + BN - 1) / BN;
  const int m0 = blockIdx.x / ntn * da_sm90::WG_BM;
  const int n0 = blockIdx.x % ntn * BN;
  da_sm90::wgmma_tile<BN, AccumPairs, da_sm90::FWD_NONE, true,
                      ring_stages<BN>()>(&ta, &tb, M, N, K, m0, n0, smem,
                                         AccumPairs{!first}, nullptr, &to,
                                         &tp);
}

// K15's step on wgmma with dst on another card: the same tile, each sum
// stored by the thread that holds it (ReduceEpi: recv read and dst written
// element by element, dst over NVLink).
template <int BN>
__global__ void __launch_bounds__(da_sm90::WG_THREADS, 1)
ring_mm_rs_wgmma_peer(const __grid_constant__ CUtensorMap ta,
                      const __grid_constant__ CUtensorMap tb,
                      const bf* recv, bf* dst, int M, int N, int K) {
  extern __shared__ uint8_t smem[];
  const int ntn = (N + BN - 1) / BN;
  const int m0 = blockIdx.x / ntn * da_sm90::WG_BM;
  const int n0 = blockIdx.x % ntn * BN;
  da_sm90::wgmma_tile<BN, ReduceEpi<bf>, da_sm90::FWD_NONE, false,
                      ring_stages<BN>()>(&ta, &tb, M, N, K, m0, n0, smem,
                                         ReduceEpi<bf>{recv, dst, N});
}

// K15's step in f32: one 128 x 128 tile of x (M x K) @ w (K x N) plus recv
// (M x N, or null) into dst, as ReduceEpi.
template <bool VEC>
__global__ void __launch_bounds__(da_sm90::F_THREADS, 1)
ring_mm_rs_f32(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ recv, float* __restrict__ dst,
               int M, int N, int K) {
  extern __shared__ float4 smem_f[];
  const int ntn = (N + da_sm90::F_BN - 1) / da_sm90::F_BN;
  const int64_t m0 = (int64_t)(blockIdx.x / ntn) * da_sm90::F_BM;
  const int64_t n0 = (int64_t)(blockIdx.x % ntn) * da_sm90::F_BN;
  da_sm90::f32_tile<VEC>(x, K, w, N, M, N, K, m0, n0,
                         reinterpret_cast<float*>(smem_f),
                         ReduceEpi<float>{recv, dst, N});
}

int gemm_tiles(int m, int n) {
  return ((m + da_tile::BM - 1) / da_tile::BM) *
         ((n + da_tile::BN - 1) / da_tile::BN);
}

// The pieces of one destination, in fold order, and the box they share
// (element strides, outer dims then a contiguous run).  out is contiguous
// in the box's order.
struct Pieces {
  const void* src[MAXP];
  int n;
  long long size[3];
  long long stride[3];
  long long run;
};

// acc + x, rounded to T
template <typename T>
__device__ __forceinline__ float add_t(float acc, float x) {
  const float sum = __fadd_rn(acc, x);
  return sizeof(T) == 2 ? __bfloat162float(__float2bfloat16_rn(sum)) : sum;
}

// the fold of the n pieces' element at offset `off`
template <typename T>
__device__ __forceinline__ float fold_at(const Pieces& ps, long long off) {
  using da_tile::to_f;
  float acc = to_f(static_cast<const T*>(ps.src[0])[off]);
  for (int s = 1; s < ps.n; ++s)
    acc = add_t<T>(acc, to_f(static_cast<const T*>(ps.src[s])[off]));
  return acc;
}

// any box: one element a thread per step
template <typename T>
__global__ void __launch_bounds__(COPY_THREADS)
reduce_pieces_kernel(const Pieces ps, T* __restrict__ out, long long total) {
  for (long long i = (long long)blockIdx.x * COPY_THREADS + threadIdx.x;
       i < total; i += (long long)gridDim.x * COPY_THREADS) {
    long long o = i / ps.run;
    const long long r = i - o * ps.run;
    const long long i2 = o % ps.size[2];
    o /= ps.size[2];
    const long long i1 = o % ps.size[1];
    const long long i0 = o / ps.size[1];
    const long long off =
        i0 * ps.stride[0] + i1 * ps.stride[1] + i2 * ps.stride[2] + r;
    da_tile::store(out + i, fold_at<T>(ps, off));
  }
}

// one contiguous run, every pointer 16-byte aligned: 16 bytes a thread
template <typename T>
__global__ void __launch_bounds__(COPY_THREADS)
reduce_run_kernel(const Pieces ps, T* __restrict__ out, long long vecs) {
  constexpr int V = 16 / sizeof(T);
  for (long long i = (long long)blockIdx.x * COPY_THREADS + threadIdx.x;
       i < vecs; i += (long long)gridDim.x * COPY_THREADS) {
    float acc[V];
    const uint4 u0 = static_cast<const uint4*>(ps.src[0])[i];
    const T* x0 = reinterpret_cast<const T*>(&u0);
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = da_tile::to_f(x0[e]);
    for (int s = 1; s < ps.n; ++s) {
      const uint4 u = static_cast<const uint4*>(ps.src[s])[i];
      const T* x = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = add_t<T>(acc[e], da_tile::to_f(x[e]));
    }
    uint4 res;
    T* rx = reinterpret_cast<T*>(&res);
#pragma unroll
    for (int e = 0; e < V; ++e) da_tile::store(&rx[e], acc[e]);
    reinterpret_cast<uint4*>(out)[i] = res;
  }
}

template <typename T>
int reduce_pieces(const Pieces& ps, void* out, cudaStream_t s) {
  const long long total = ps.size[0] * ps.size[1] * ps.size[2] * ps.run;
  if (total == 0) return 0;
  constexpr int V = 16 / sizeof(T);
  bool vec = ps.size[0] * ps.size[1] * ps.size[2] == 1 && total % V == 0 &&
             (uintptr_t)out % 16 == 0;
  for (int q = 0; q < ps.n; ++q) vec = vec && (uintptr_t)ps.src[q] % 16 == 0;
  const long long units = vec ? total / V : total;
  long long grid = (units + COPY_THREADS - 1) / COPY_THREADS;
  if (grid > 132 * 16) grid = 132 * 16;
  if (vec)
    reduce_run_kernel<T><<<(unsigned)grid, COPY_THREADS, 0, s>>>(
        ps, static_cast<T*>(out), units);
  else
    reduce_pieces_kernel<T><<<(unsigned)grid, COPY_THREADS, 0, s>>>(
        ps, static_cast<T*>(out), units);
  return (int)cudaGetLastError();
}

}  // namespace

// K12, one destination: out (contiguous, the box's shape) = the left fold
// of the `n` pieces src[0], src[1], ... (device pointers, possibly of peer
// devices; one box of outer `sizes` and `strides` and a contiguous `run`,
// in elements), each add rounded to the type: bf16 != 0 for bfloat16,
// else float32.  Returns the cudaGetLastError() code of the launch, or
// cudaErrorInvalidValue for more than MAXP pieces.
extern "C" int da_reduce_pieces(int n, const void* const* src,
                                const long long* sizes,
                                const long long* strides, long long run,
                                void* out, int bf16, int device,
                                void* stream) {
  if (n <= 0 || n > MAXP) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Pieces ps;
  ps.n = n;
  for (int q = 0; q < n; ++q) ps.src[q] = src[q];
  for (int d = 0; d < 3; ++d) {
    ps.size[d] = sizes[d];
    ps.stride[d] = strides[d];
  }
  ps.run = run;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? reduce_pieces<__nv_bfloat16>(ps, out, s)
              : reduce_pieces<float>(ps, out, s);
}

// One copy launch on `device`'s `stream`: `nsrc` source boxes, source q
// at src[q] with outer strides src_strides[3q..3q+2] (bytes) and sizes
// sizes[3q..3q+2], a contiguous run of row_bytes[q] bytes, copied to its
// ndst[q] destinations (the next ndst[q] of dst / dst_strides, in order)
// with accesses of vec[q] bytes.  Pointers may be of peer devices.  Returns
// the cudaGetLastError() code of the launch, or cudaErrorInvalidValue for
// more than COPY_MAXP sources or destinations, a vec the addresses do not
// allow, or a box too large for 32-bit unit indices.
extern "C" int da_copy_pieces(int nsrc, const void* const* src,
                              const long long* src_strides,
                              const long long* sizes,
                              const long long* row_bytes, const int* ndst,
                              const int* vec, void* const* dst,
                              const long long* dst_strides, int device,
                              void* stream) {
  if (nsrc <= 0) return 0;
  if (nsrc > COPY_MAXP) return (int)cudaErrorInvalidValue;
  CopyPlan plan;
  plan.nsrc = 0;
  long long total = 0;
  int nd = 0;
  for (int q = 0; q < nsrc; ++q) {
    if (ndst[q] < 1 || nd + ndst[q] > COPY_MAXP)
      return (int)cudaErrorInvalidValue;
    const long long v = vec[q];
    if (v != 16 && v != 4 && v != 1) return (int)cudaErrorInvalidValue;
    long long acc = (long long)(uintptr_t)src[q] | row_bytes[q];
    long long rows = 1;
    for (int d = 0; d < 3; ++d) {
      acc |= src_strides[3 * q + d];
      if (sizes[3 * q + d] < 1 || sizes[3 * q + d] > (1LL << 30))
        return (int)cudaErrorInvalidValue;
      rows *= sizes[3 * q + d];
      if (rows > (1LL << 30)) return (int)cudaErrorInvalidValue;
    }
    for (int t = nd; t < nd + ndst[q]; ++t) {
      acc |= (long long)(uintptr_t)dst[t];
      for (int d = 0; d < 3; ++d) acc |= dst_strides[3 * t + d];
    }
    if (acc % v) return (int)cudaErrorInvalidValue;
    const long long unit = 32LL * COPY_UNROLL * v;
    const long long segs = (row_bytes[q] + unit - 1) / unit;
    if (row_bytes[q] <= 0 || rows * segs > (1LL << 30))
      return (int)cudaErrorInvalidValue;
    CopySrc& s = plan.s[plan.nsrc++];
    s.src = static_cast<const char*>(src[q]);
    for (int d = 0; d < 3; ++d) {
      s.stride[d] = src_strides[3 * q + d];
      s.size[d] = (int)sizes[3 * q + d];
    }
    s.row_bytes = row_bytes[q];
    s.first = total;
    s.segs = (int)segs;
    s.units = (int)(rows * segs);
    s.dst0 = nd;
    s.ndst = ndst[q];
    s.vec = (int)v;
    for (int t = nd; t < nd + ndst[q]; ++t) {
      plan.d[t].dst = static_cast<char*>(dst[t]);
      for (int d = 0; d < 3; ++d) plan.d[t].stride[d] = dst_strides[3 * t + d];
    }
    nd += ndst[q];
    total += s.units;
  }
  if (total > (1LL << 30)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long grid = (total + COPY_THREADS / 32 - 1) / (COPY_THREADS / 32);
  if (grid == 0) return 0;
  copy_kernel<<<(unsigned)grid, COPY_THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(plan);
  return (int)cudaGetLastError();
}

// The most copies (sources, and destinations in all) one da_copy_pieces
// launch takes.
extern "C" int da_copy_maxp() { return COPY_MAXP; }

namespace {

// the ring all-gather GEMMs' route codes (kbuild.RING_ROUTES)
constexpr int ROUTE_F32 = 0;
constexpr int ROUTE_MMA = 1;
constexpr int ROUTE_WGMMA = 2;
constexpr int ROUTE_WGMMA_PEER = 3;

// Raise a kernel's dynamic shared-memory limit to `bytes`.
int fit_smem(const void* kern, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

int wg_tiles(int m, int n, int bn) {
  return ((m + da_sm90::WG_BM - 1) / da_sm90::WG_BM) * ((n + bn - 1) / bn);
}

int f32_tiles(int m, int n) {
  return ((m + da_sm90::F_BM - 1) / da_sm90::F_BM) *
         ((n + da_sm90::F_BN - 1) / da_sm90::F_BN);
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

// Launch one wgmma step kernel (128 x BN tiles) over the M x N tiles; the
// peer route first copies `chunk` (elems elements) to fwd by a launch of
// its own.
template <int BN, typename... Params, typename... Args>
int launch_wgmma(void (*kern)(Params...), int m, int n, cudaStream_t s,
                 const void* chunk, void* fwd, int64_t elems, bool peer,
                 Args... args) {
  const size_t sm = da_sm90::wg_smem_bytes<BN, ring_stages<BN>(), true>();
  int rc = fit_smem((const void*)kern, sm);
  if (rc) return rc;
  if (fwd && peer) {
    forward_kernel<bf><<<RING_COPY_BLOCKS, da_tile::THREADS, 0, s>>>(
        static_cast<const bf*>(chunk), static_cast<bf*>(fwd), elems);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  kern<<<wg_tiles(m, n, BN), da_sm90::WG_THREADS, sm, s>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// One ring step of a @ all_gather(b) for one rank (K14): out (M x N) +=
// a[:, koff:koff+K] @ chunk (K x N), with a's row stride lda; `first`
// writes instead of adding; fwd (null at the last step) receives a copy of
// chunk.  route (kbuild.RING_ROUTES): 0 f32 operands, 1 bf16 on mma.sync,
// 2 bf16 on wgmma + TMA (K, N, lda multiples of 8; a + koff, chunk, out
// and fwd 16-byte aligned), 3 as 2 with the forward by a separate copy
// launch (fwd on another card).  tile_n: the wgmma routes' tile width, 64
// or 128.  Returns the cudaGetLastError() code of the launch,
// cudaErrorInvalidValue for a route or tile the operands cannot take, or
// 1000 + the CUresult of a failed TMA tensor-map encoding.
extern "C" int da_ring_ag_mm_step(const void* a, const void* chunk,
                                  void* out, void* fwd, int m, int n, int k,
                                  long long lda, long long koff, int first,
                                  int route, int tile_n, int device,
                                  void* stream) {
  if (m <= 0 || n <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == ROUTE_F32) {
    const float* pa = static_cast<const float*>(a) + koff;
    auto kern = da_sm90::f32_vec(pa, lda, chunk, n, n, k) && aligned16(fwd)
                    ? ring_ag_mm_f32<true>
                    : ring_ag_mm_f32<false>;
    int rc = fit_smem((const void*)kern, da_sm90::F_SMEM);
    if (rc) return rc;
    kern<<<f32_tiles(m, n), da_sm90::F_THREADS, da_sm90::F_SMEM, s>>>(
        pa, static_cast<const float*>(chunk), static_cast<float*>(out),
        static_cast<float*>(fwd), m, n, k, (int64_t)lda, first);
    return (int)cudaGetLastError();
  }
  if (route == ROUTE_MMA) {
    const int ncopy = fwd ? RING_COPY_BLOCKS : 0;
    const bf* pa = static_cast<const bf*>(a) + koff;
    auto kern = da_tile::mma_vec(pa, lda, chunk, n, n, k)
                    ? ring_ag_mm_kernel<true>
                    : ring_ag_mm_kernel<false>;
    kern<<<ncopy + gemm_tiles(m, n), da_tile::THREADS, 0, s>>>(
        static_cast<const bf*>(a), static_cast<const bf*>(chunk),
        static_cast<bf*>(out), static_cast<bf*>(fwd), m, n, k, lda, koff,
        first, ncopy);
    return (int)cudaGetLastError();
  }
  if (route != ROUTE_WGMMA && route != ROUTE_WGMMA_PEER)
    return (int)cudaErrorInvalidValue;
  const bf* pa = static_cast<const bf*>(a) + koff;
  if (!da_sm90::wgmma_ok(pa, lda, chunk, n, k) || !aligned16(out) ||
      !aligned16(fwd))
    return (int)cudaErrorInvalidValue;
  const bool peer = route == ROUTE_WGMMA_PEER;
  CUtensorMap ta, tb, tf = {}, to;
  int rc = da_sm90::wgmma_maps(&ta, &tb, pa, lda, chunk, m, n, k);
  if (!rc) rc = da_sm90::wgmma_out_map(&to, out, m, n);
  if (!rc && fwd && !peer)
    rc = da_sm90::wgmma_fwd_map(&tf, fwd, da_sm90::FWD_B, m, n, k);
  if (rc) return rc;
  const int forward = fwd && !peer;
  const int64_t elems = (int64_t)k * n;
  if (tile_n == 64)
    return launch_wgmma<64>(ring_ag_mm_wgmma<64>, m, n, s, chunk, fwd, elems,
                            peer, ta, tb, tf, to, m, n, k, first, forward);
  if (tile_n == 128)
    return launch_wgmma<128>(ring_ag_mm_wgmma<128>, m, n, s, chunk, fwd,
                             elems, peer, ta, tb, tf, to, m, n, k, first,
                             forward);
  return (int)cudaErrorInvalidValue;
}

// One ring step of all_gather(x) @ w for one rank (K13): out (M x N, the
// resident chunk's row block of the gathered product) = chunk (M x K) @ w
// (K x N), cast once to the type; fwd (null at the last step) receives a
// copy of chunk.  All contiguous; route and tile_n as da_ring_ag_mm_step's
// (wgmma: K, N multiples of 8, chunk, w, out and fwd 16-byte aligned).
extern "C" int da_ring_ag_mm_a_step(const void* chunk, const void* w,
                                    void* out, void* fwd, int m, int n,
                                    int k, int route, int tile_n,
                                    int device, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == ROUTE_F32) {
    auto kern = da_sm90::f32_vec(chunk, k, w, n, n, k) && aligned16(fwd)
                    ? ring_ag_mm_a_f32<true>
                    : ring_ag_mm_a_f32<false>;
    int rc = fit_smem((const void*)kern, da_sm90::F_SMEM);
    if (rc) return rc;
    kern<<<f32_tiles(m, n), da_sm90::F_THREADS, da_sm90::F_SMEM, s>>>(
        static_cast<const float*>(chunk), static_cast<const float*>(w),
        static_cast<float*>(out), static_cast<float*>(fwd), m, n, k);
    return (int)cudaGetLastError();
  }
  if (route == ROUTE_MMA) {
    const int ncopy = fwd ? RING_COPY_BLOCKS : 0;
    auto kern = da_tile::mma_vec(chunk, k, w, n, n, k)
                    ? ring_ag_mm_a_kernel<true>
                    : ring_ag_mm_a_kernel<false>;
    kern<<<ncopy + gemm_tiles(m, n), da_tile::THREADS, 0, s>>>(
        static_cast<const bf*>(chunk), static_cast<const bf*>(w),
        static_cast<bf*>(out), static_cast<bf*>(fwd), m, n, k, ncopy);
    return (int)cudaGetLastError();
  }
  if (route != ROUTE_WGMMA && route != ROUTE_WGMMA_PEER)
    return (int)cudaErrorInvalidValue;
  if (!da_sm90::wgmma_ok(chunk, k, w, n, k) || !aligned16(out) ||
      !aligned16(fwd))
    return (int)cudaErrorInvalidValue;
  const bool peer = route == ROUTE_WGMMA_PEER;
  CUtensorMap ta, tb, tf = {}, to;
  int rc = da_sm90::wgmma_maps(&ta, &tb, chunk, k, w, m, n, k);
  if (!rc) rc = da_sm90::wgmma_out_map(&to, out, m, n);
  if (!rc && fwd && !peer)
    rc = da_sm90::wgmma_fwd_map(&tf, fwd, da_sm90::FWD_A, m, n, k);
  if (rc) return rc;
  const int forward = fwd && !peer;
  const int64_t elems = (int64_t)m * k;
  if (tile_n == 64)
    return launch_wgmma<64>(ring_ag_mm_a_wgmma<64>, m, n, s, chunk, fwd,
                            elems, peer, ta, tb, tf, to, m, n, k, forward);
  if (tile_n == 128)
    return launch_wgmma<128>(ring_ag_mm_a_wgmma<128>, m, n, s, chunk, fwd,
                             elems, peer, ta, tb, tf, to, m, n, k, forward);
  return (int)cudaErrorInvalidValue;
}

// One ring step of reduce_scatter(x @ w) for one rank (K15): dst (M x N) =
// recv + x (M x K, this step's destination row block) @ w (K x N), the
// product cast to the type before the add, which rounds to the type; recv
// null (the first step) writes the product alone.  dst is the right
// neighbour's receive slot, or the rank's output at the last step.  All
// contiguous.  route (kbuild.RING_ROUTES): 0 f32 operands, 1 bf16 on
// mma.sync, 2 bf16 on wgmma + TMA (K and N multiples of 8; x, w, recv and
// dst 16-byte aligned), 3 as 2 with the sum stored element by element (dst
// on another card).  tile_n: the wgmma routes' tile width, 64 or 128.
// Returns the cudaGetLastError() code of the launch, cudaErrorInvalidValue
// for a route or tile the operands cannot take, or 1000 + the CUresult of a
// failed TMA tensor-map encoding.
extern "C" int da_ring_mm_rs_step(const void* x, const void* w,
                                  const void* recv, void* dst, int m, int n,
                                  int k, int route, int tile_n, int device,
                                  void* stream) {
  if (m <= 0 || n <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == ROUTE_F32) {
    auto kern = da_sm90::f32_vec(x, k, w, n, n, k) ? ring_mm_rs_f32<true>
                                                   : ring_mm_rs_f32<false>;
    int rc = fit_smem((const void*)kern, da_sm90::F_SMEM);
    if (rc) return rc;
    kern<<<f32_tiles(m, n), da_sm90::F_THREADS, da_sm90::F_SMEM, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(recv), static_cast<float*>(dst), m, n, k);
    return (int)cudaGetLastError();
  }
  if (route == ROUTE_MMA) {
    auto kern = da_tile::mma_vec(x, k, w, n, n, k) ? ring_mm_rs_kernel<true>
                                                   : ring_mm_rs_kernel<false>;
    kern<<<gemm_tiles(m, n), da_tile::THREADS, 0, s>>>(
        static_cast<const bf*>(x), static_cast<const bf*>(w),
        static_cast<const bf*>(recv), static_cast<bf*>(dst), m, n, k);
    return (int)cudaGetLastError();
  }
  if ((route != ROUTE_WGMMA && route != ROUTE_WGMMA_PEER) ||
      (tile_n != 64 && tile_n != 128))
    return (int)cudaErrorInvalidValue;
  if (!da_sm90::wgmma_ok(x, k, w, n, k) || !aligned16(recv) ||
      !aligned16(dst))
    return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb, tp = {}, to;
  int rc = da_sm90::wgmma_maps(&ta, &tb, x, k, w, m, n, k);
  if (rc) return rc;
  if (route == ROUTE_WGMMA_PEER) {
    const bf* pr = static_cast<const bf*>(recv);
    bf* pd = static_cast<bf*>(dst);
    return tile_n == 64
               ? launch_wgmma<64>(ring_mm_rs_wgmma_peer<64>, m, n, s, nullptr,
                                  nullptr, 0, false, ta, tb, pr, pd, m, n, k)
               : launch_wgmma<128>(ring_mm_rs_wgmma_peer<128>, m, n, s,
                                   nullptr, nullptr, 0, false, ta, tb, pr, pd,
                                   m, n, k);
  }
  rc = da_sm90::wgmma_out_map(&to, dst, m, n);
  if (!rc && recv)
    rc = da_sm90::wgmma_out_map(&tp, const_cast<void*>(recv), m, n);
  if (rc) return rc;
  const int first = recv == nullptr;
  return tile_n == 64
             ? launch_wgmma<64>(ring_mm_rs_wgmma<64>, m, n, s, nullptr,
                                nullptr, 0, false, ta, tb, tp, to, m, n, k,
                                first)
             : launch_wgmma<128>(ring_mm_rs_wgmma<128>, m, n, s, nullptr,
                                 nullptr, 0, false, ta, tb, tp, to, m, n, k,
                                 first);
}

// Let `device` read and write `peer`'s memory (no-op when they are the same
// device or access is already on).  Returns a CUDA error code; 1000 when the
// pair cannot reach each other at all.
extern "C" int da_enable_peer(int device, int peer) {
  if (device == peer) return 0;
  int can = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, device, peer);
  if (err != cudaSuccess) return (int)err;
  if (!can) return 1000;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear the sticky-free error state
    return 0;
  }
  return (int)err;
}

// ---------------------------------------------------------------------------
// CUDA IPC: K10's copy kernel across controller processes
// ---------------------------------------------------------------------------
//
// A process-spanning DArray's gather (`gather_global`) makes one
// da_copy_pieces launch a process that reads the peer processes' chunks
// through pointers into their memory.  A peer exports the allocation that
// holds its chunk (cudaIpcGetMemHandle takes the allocation's base, and
// PyTorch's caching allocator hands out pieces of larger cudaMalloc
// blocks, so the chunk's offset in the block travels with the handle) and
// every other process maps it once (cudaIpcOpenMemHandle).  A process
// never opens its own handle: its chunks take their own pointers.

namespace {

using AddressRangeFn = CUresult (*)(CUdeviceptr*, size_t*, CUdeviceptr);

AddressRangeFn address_range() {
  static AddressRangeFn fn = []() -> AddressRangeFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuMemGetAddressRange", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuMemGetAddressRange", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<AddressRangeFn>(p);
  }();
  return fn;
}

}  // namespace

// The size of the handle da_ipc_handle writes.
extern "C" int da_ipc_handle_size() { return (int)sizeof(cudaIpcMemHandle_t); }

// Export the allocation holding `ptr` on `device`: its IPC handle into
// `handle` (da_ipc_handle_size() bytes) and `ptr`'s byte offset from the
// allocation's base into `offset`.  Returns a CUDA runtime error code,
// or IPC_RANGE_ERROR + the driver's CUresult when the base cannot be
// found.
constexpr int IPC_RANGE_ERROR = 3000;

extern "C" int da_ipc_handle(const void* ptr, void* handle,
                             long long* offset, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  AddressRangeFn range = address_range();
  if (range == nullptr) return IPC_RANGE_ERROR;
  CUdeviceptr base = 0;
  size_t size = 0;
  CUresult r = range(&base, &size, (CUdeviceptr)(uintptr_t)ptr);
  if (r != CUDA_SUCCESS) return IPC_RANGE_ERROR + (int)r;
  cudaIpcMemHandle_t h;
  err = cudaIpcGetMemHandle(&h, (void*)(uintptr_t)base);
  if (err != cudaSuccess) return (int)err;
  memcpy(handle, &h, sizeof(h));
  *offset = (long long)((uintptr_t)ptr - (uintptr_t)base);
  return 0;
}

// Map a peer process's allocation (`handle` from da_ipc_handle) into this
// process on `device`; its base address goes to `base`.  Returns a CUDA
// runtime error code.
extern "C" int da_ipc_open(const void* handle, int device, void** base) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  err = cudaIpcOpenMemHandle(base, h, cudaIpcMemLazyEnablePeerAccess);
  return (int)err;
}

// Unmap an allocation da_ipc_open mapped.
extern "C" int da_ipc_close(void* base) {
  return (int)cudaIpcCloseMemHandle(base);
}
