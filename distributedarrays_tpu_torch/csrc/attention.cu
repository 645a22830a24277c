// Attention kernels for Hopper (sm_90a): bf16 on the wgmma + TMA loop of
// attn_sm90.cuh where TMA can read the operands, other bf16 and f32 on the
// tile loops of attn_tile.cuh.
//
// - K5 `da_flash_attention` replaces distributedarrays_tpu/ops/
//   pallas_attention.py `_kernel` (pallas_call in `_build`): exact
//   attention over (S, H, D) without the S x S score matrix, writing o and
//   the per-row logsumexp (H, S) f32.  The Pallas grid (heads, S/bq, S/bk)
//   carries (m, l, acc) across its sequential K axis in VMEM; here one
//   block owns 64 query rows of one head (128 on the wgmma route, 64 for
//   each of its two consumer warpgroups) and loops over the keys itself,
//   stopping at its last visible key tile.  Causal grids are walked
//   heaviest query tile first, so the long rows do not start last.  Ragged
//   S is masked in the kernel (the Pallas kernel needs S to divide its
//   blocks).  Three routes, chosen by the caller (`route`): bf16 whose q,
//   k, v and o views TMA can read (head dim a multiple of 8, strides
//   multiples of 16 bytes, 16-byte aligned bases) on wgmma + TMA
//   (attn_sm90.cuh `attend_wgmma` in its FLASH numerics, each of q, k and v
//   mapped from its own strides), other bf16 on mma.sync (attn_tile.cuh
//   `attend_mma`), f32 on the SIMT loop.
// - K8 `da_flash_hop` replaces `_carry_kernel` (pallas_call in
//   `_build_carry`): K5's loops with (m, l, acc) read at the start and
//   written at the end, in place (each block reads and writes only its own
//   rows).  The global offsets qoff/koff enter the causal test and the
//   skip, so a hop whose keys all lie after its queries copies the carry
//   through.  Routes as K5's, on the hop's (B, H, D) views of its (H, B, D)
//   blocks: bf16 that TMA can read on wgmma + TMA (`attend_wgmma` in its
//   FLASH numerics, with NWG = `groups` consumer warpgroups a block, chosen
//   by the caller from the grid's size), other bf16 on mma.sync, f32 on the
//   SIMT loop.
// - K9 `da_ring_attn_step` replaces distributedarrays_tpu/models/
//   ring_attention.py `_rdma_attn_call` (its pallas_call): one launch per
//   rank per ring step.  The first blocks forward the resident K/V pair
//   into the right neighbour's free slot of its two-slot buffer (the TPU
//   kernel's remote copy to device_id=right, started before the accumulate
//   and waited after it); that slot is read by the neighbour only at the
//   next step.  The other blocks accumulate the q block against the
//   resident pair with the carry in device memory, in K9's own numerics
//   (f32 products, q scaled in the input type, p not rounded); the last
//   step normalises and writes o in (b, h, dh).  A causal step whose
//   resident block lies wholly after the q block (`compute` = 0, the
//   caller's ring_step_plan) launches only the forward blocks, or at the
//   first or last step blocks that only start or finish the carry; in
//   the other causal steps each query tile stops at its last visible key
//   tile.  Both skips are exact: a wholly masked tile leaves m, l and acc
//   bit for bit as they were.  Steps are ordered by stream order on one
//   card and by event waits across cards; no flag is spun on.  Routes as
//   K5's: bf16 with dh a multiple of 8 and 16-byte aligned q/k/v on wgmma
//   + TMA (`attend_wgmma` in its RING numerics), other bf16 on mma.sync,
//   f32 on the SIMT loop.
//
// Bound on an H100: operations on each visible (query, key) pair.  In bf16
// all three take their products on the tensor cores at 989 TFLOP/s:
// K5/K8 round p to bf16 as the TPU kernel does, 4*D operations a pair; K9
// splits its f32 p into three bf16 terms, so every product stays exact and
// the result is K9's f32 one, at 8*D a pair (one QK^T and three PV
// products a tile).  In f32 all three run the SIMT loop on the f32 FMA
// pipes (attend), 4*D a pair at 67 TFLOP/s, since TF32 tensor cores would
// round the products.  On the wgmma route K5, K8 and K9 stream K and V by
// TMA into wgmma, so no thread spends instructions on the copies; K8 adds
// its carry, 2 (h b + h b dh) f32 words read and written a hop.

#include "attn_sm90.cuh"
#include "attn_tile.cuh"

namespace {

using da_attn::Args;
using da_attn::THREADS;

// K5/K8 in f32
template <int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const Args a) {
  extern __shared__ float smem[];
  const int nq = (a.sq + da_attn::BQ - 1) / da_attn::BQ;
  const int n = blockIdx.x % a.hall;
  int qt = blockIdx.x / a.hall;
  if (a.causal) qt = nq - 1 - qt;  // heaviest query tiles first
  da_attn::attend<false, DMAX>(a, n, qt, smem);
}

// K5/K8 in bf16: the same walk over (head, query tile) on the tensor cores
template <int DMAX>
__global__ void __launch_bounds__(da_attn::MMA_THREADS)
flash_mma_kernel(const Args a) {
  extern __shared__ uint4 smem_v[];
  const int nq = (a.sq + da_attn::BQ - 1) / da_attn::BQ;
  const int n = blockIdx.x % a.hall;
  int qt = blockIdx.x / a.hall;
  if (a.causal) qt = nq - 1 - qt;
  da_attn::attend_mma<DMAX, false>(a, n, qt,
                                   reinterpret_cast<__nv_bfloat16*>(smem_v));
}

// Forward `count` elements of kc/vc into fk/fv with the first `ncopy`
// blocks of NT threads (16-byte copies when aligned).
template <typename T, int NT>
__device__ __forceinline__ void forward_pair(const T* __restrict__ kc,
                                             const T* __restrict__ vc,
                                             T* __restrict__ fk,
                                             T* __restrict__ fv,
                                             int64_t count, int ncopy) {
  const int64_t tid = (int64_t)blockIdx.x * NT + threadIdx.x;
  const int64_t stride = (int64_t)ncopy * NT;
  const int64_t bytes = count * (int64_t)sizeof(T);
  if (bytes % 16 == 0 && ((uintptr_t)kc | (uintptr_t)vc | (uintptr_t)fk |
                          (uintptr_t)fv) % 16 == 0) {
    const uint4* sk = reinterpret_cast<const uint4*>(kc);
    const uint4* sv = reinterpret_cast<const uint4*>(vc);
    uint4* dk = reinterpret_cast<uint4*>(fk);
    uint4* dv = reinterpret_cast<uint4*>(fv);
    for (int64_t i = tid; i < bytes / 16; i += stride) {
      dk[i] = sk[i];
      dv[i] = sv[i];
    }
  } else {
    for (int64_t i = tid; i < count; i += stride) {
      fk[i] = kc[i];
      fv[i] = vc[i];
    }
  }
}

// K9 in bf16: forward blocks, then the RING loop on the tensor cores
template <int DMAX>
__global__ void __launch_bounds__(da_attn::MMA_THREADS)
ring_step_mma_kernel(const Args a, const __nv_bfloat16* __restrict__ kc,
                     const __nv_bfloat16* __restrict__ vc,
                     __nv_bfloat16* __restrict__ fk,
                     __nv_bfloat16* __restrict__ fv, int64_t count,
                     int ncopy) {
  extern __shared__ uint4 smem_v[];
  if ((int)blockIdx.x < ncopy) {
    forward_pair<__nv_bfloat16, da_attn::MMA_THREADS>(kc, vc, fk, fv, count,
                                                      ncopy);
    return;
  }
  const int b = blockIdx.x - ncopy;
  da_attn::attend_mma<DMAX, true>(a, b % a.hall, b / a.hall,
                                  reinterpret_cast<__nv_bfloat16*>(smem_v));
}

// K9 in f32
template <int DMAX>
__global__ void __launch_bounds__(THREADS)
ring_step_kernel(const Args a, const float* __restrict__ kc,
                 const float* __restrict__ vc, float* __restrict__ fk,
                 float* __restrict__ fv, int64_t count, int ncopy) {
  extern __shared__ float smem[];
  if ((int)blockIdx.x < ncopy) {
    forward_pair<float, THREADS>(kc, vc, fk, fv, count, ncopy);
    return;
  }
  const int b = blockIdx.x - ncopy;
  da_attn::attend<true, DMAX>(a, b % a.hall, b / a.hall, smem);
}

// K9 in bf16 on wgmma + TMA: forward blocks, then one query tile a block.
// At DMAX 64 it is held to three blocks an SM (128 registers, about 100
// bytes of spills): the S = 8192 causal ring then read 1.28 ms of device
// time against 1.70 ms at two blocks (189 registers), in one call (H100
// 80GB HBM3, 700 W, chip_smoke.py); the softmax of one block overlaps the
// products of the others.  At DMAX 128 (o and P V alone take 128
// registers a thread) it keeps one.
template <int DMAX>
__global__ void __launch_bounds__(128 + 32, DMAX > 64 ? 1 : 3)
ring_step_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const da_sm90::AttnArgs a,
                       const __nv_bfloat16* __restrict__ kc,
                       const __nv_bfloat16* __restrict__ vc,
                       __nv_bfloat16* __restrict__ fk,
                       __nv_bfloat16* __restrict__ fv, int64_t count,
                       int ncopy) {
  extern __shared__ uint8_t smem_b[];
  if ((int)blockIdx.x < ncopy) {
    forward_pair<__nv_bfloat16, 128 + 32>(kc, vc, fk, fv, count, ncopy);
    return;
  }
  const int b = blockIdx.x - ncopy;
  da_sm90::attend_wgmma<DMAX, false, 1, true>(&tq, &tk, &tv, a, b % a.h,
                                              b / a.h, smem_b);
}

// K5 and K8 in bf16 on wgmma + TMA: NWG consumer warpgroups of 64 query
// rows a block, sharing every K/V stage, so that one's softmax overlaps
// another's products; heaviest query tiles first.  K5 takes two
// warpgroups (96 registers at DMAX 64, two blocks an SM): 0.131 ms at
// (2048, 64, 64) bf16 causal against 0.145 ms for one (108 registers,
// three blocks an SM, K9's layout), in turns in one call (H100 80GB HBM3,
// 700 W, chip_smoke.py --time-attn).  K8 takes the count its caller
// chooses (cuda_attention.py `hop_groups`) and CARRY, which K5 leaves out:
// compiled into K5, the carry's load held K5 at 96 registers with 20 bytes
// of spills and read 0.140-0.145 ms of device time at (2048, 64, 64)
// against the parent's 0.127-0.129 (H100 80GB HBM3, 700 W, chip_smoke.py
// --time-k4-k8, in turns).
constexpr int K5_GROUPS = 2;

template <int DMAX, int NWG, bool CARRY>
__global__ void __launch_bounds__(128 * NWG + 32,
                                  DMAX > 64 ? 1 : (NWG == 1 ? 3 : 2))
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const da_sm90::AttnArgs a) {
  extern __shared__ uint8_t smem_b[];
  const int rows = NWG * da_sm90::AW_ROWS;
  const int nq = (a.b + rows - 1) / rows;
  const int n = blockIdx.x % a.h;
  int qt = blockIdx.x / a.h;
  if (a.causal) qt = nq - 1 - qt;  // heaviest query tiles first
  da_sm90::attend_wgmma<DMAX, true, NWG, CARRY>(&tq, &tk, &tv, a, n, qt,
                                                smem_b);
}

// K9 at a step with nothing to accumulate: only the forward blocks
template <typename T>
__global__ void __launch_bounds__(THREADS)
forward_kernel(const T* __restrict__ kc, const T* __restrict__ vc,
               T* __restrict__ fk, T* __restrict__ fv, int64_t count) {
  forward_pair<T, THREADS>(kc, vc, fk, fv, count, gridDim.x);
}

template <typename K>
cudaError_t fit_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int DMAX>
int launch_flash(const Args& a, cudaStream_t s) {
  const size_t sm = da_attn::smem_bytes(a.d);
  cudaError_t err = fit_smem(flash_kernel<DMAX>, sm);
  if (err != cudaSuccess) return (int)err;
  const int nq = (a.sq + da_attn::BQ - 1) / da_attn::BQ;
  flash_kernel<DMAX><<<nq * a.hall, THREADS, sm, s>>>(a);
  return (int)cudaGetLastError();
}

template <int DMAX>
int launch_flash_mma(const Args& a, cudaStream_t s) {
  const size_t sm = da_attn::mma_smem_bytes(a.d);
  cudaError_t err = fit_smem(flash_mma_kernel<DMAX>, sm);
  if (err != cudaSuccess) return (int)err;
  const int nq = (a.sq + da_attn::BQ - 1) / da_attn::BQ;
  flash_mma_kernel<DMAX><<<nq * a.hall, da_attn::MMA_THREADS, sm, s>>>(a);
  return (int)cudaGetLastError();
}

template <int DMAX>
int launch_ring_mma(const Args& a, const void* kc, const void* vc, void* fk,
                    void* fv, int ncopy, cudaStream_t s) {
  using bf = __nv_bfloat16;
  const size_t sm = da_attn::mma_smem_bytes(a.d);
  cudaError_t err = fit_smem(ring_step_mma_kernel<DMAX>, sm);
  if (err != cudaSuccess) return (int)err;
  const int nq = (a.sq + da_attn::BQ - 1) / da_attn::BQ;
  const int64_t count = (int64_t)a.sq * a.hall * a.d;  // the b rows
  ring_step_mma_kernel<DMAX>
      <<<ncopy + nq * a.hall, da_attn::MMA_THREADS, sm, s>>>(
          a, static_cast<const bf*>(kc), static_cast<const bf*>(vc),
          static_cast<bf*>(fk), static_cast<bf*>(fv), count, ncopy);
  return (int)cudaGetLastError();
}

template <int DMAX>
int launch_ring(const Args& a, const void* kc, const void* vc, void* fk,
                void* fv, int ncopy, cudaStream_t s) {
  const size_t sm = da_attn::smem_bytes(a.d);
  cudaError_t err = fit_smem(ring_step_kernel<DMAX>, sm);
  if (err != cudaSuccess) return (int)err;
  const int nq = (a.sq + da_attn::BQ - 1) / da_attn::BQ;
  const int64_t count = (int64_t)a.sq * a.hall * a.d;  // the b rows
  ring_step_kernel<DMAX><<<ncopy + nq * a.hall, THREADS, sm, s>>>(
      a, static_cast<const float*>(kc), static_cast<const float*>(vc),
      static_cast<float*>(fk), static_cast<float*>(fv), count, ncopy);
  return (int)cudaGetLastError();
}

template <int DMAX>
int launch_ring_wgmma(const Args& a, const void* q, const void* kc,
                      const void* vc, void* fk, void* fv, int ncopy,
                      cudaStream_t s) {
  da_sm90::AttnArgs r;
  r.m = a.m;
  r.l = a.l;
  r.acc = a.acc;
  r.o = static_cast<__nv_bfloat16*>(a.o.p);
  r.oss = (int64_t)a.hall * a.d;
  r.osb = 0;
  r.osh = a.d;
  r.lse = nullptr;
  r.b = a.sq;
  r.h = a.hall;
  r.dh = a.d;
  r.nh = a.hall;
  r.sk = a.sk;
  r.qoff = a.qoff;
  r.koff = a.koff;
  r.causal = a.causal;
  r.init = a.init;
  r.finalize = a.finalize;
  r.scale = a.scale;
  CUtensorMap tq, tk, tv;
  const int64_t hd = (int64_t)a.hall * a.d;
  int rc = da_sm90::view_map(&tq, &r.qpos, q, a.sq, a.hall, hd, 0, a.d,
                             a.hall, a.d);
  if (!rc)
    rc = da_sm90::view_map(&tk, &r.kpos, kc, a.sq, a.hall, hd, 0, a.d, a.hall,
                           a.d);
  if (!rc)
    rc = da_sm90::view_map(&tv, &r.vpos, vc, a.sq, a.hall, hd, 0, a.d, a.hall,
                           a.d);
  if (rc) return rc;
  const size_t sm = da_sm90::aw_smem_bytes<DMAX, 1>();
  cudaError_t err = cudaFuncSetAttribute(
      ring_step_wgmma_kernel<DMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm);
  if (err != cudaSuccess) return (int)err;
  using bf = __nv_bfloat16;
  const int nq = (a.sq + da_sm90::AW_ROWS - 1) / da_sm90::AW_ROWS;
  const int64_t count = (int64_t)a.sq * a.hall * a.d;  // the b rows
  ring_step_wgmma_kernel<DMAX>
      <<<ncopy + nq * a.hall, 128 + 32, sm, s>>>(
          tq, tk, tv, r, static_cast<const bf*>(kc),
          static_cast<const bf*>(vc), static_cast<bf*>(fk),
          static_cast<bf*>(fv), count, ncopy);
  return (int)cudaGetLastError();
}

// K5 (init and finalize: o and lse; CARRY false) or K8 (neither: the carry
// read and written in place; CARRY true) on wgmma + TMA over the strided
// views of `a`, NWG consumer warpgroups a block
template <int DMAX, int NWG, bool CARRY>
int launch_flash_wgmma(const Args& a, cudaStream_t s) {
  da_sm90::AttnArgs r;
  r.m = a.m;
  r.l = a.l;
  r.acc = a.acc;
  r.o = static_cast<__nv_bfloat16*>(a.o.p);
  r.oss = a.o.ss;
  r.osb = a.o.sb;
  r.osh = a.o.sh;
  r.lse = a.lse;
  r.b = a.sq;
  r.h = a.hall;
  r.dh = a.d;
  r.nh = a.q.nh;
  r.sk = a.sk;
  r.qoff = a.qoff;
  r.koff = a.koff;
  r.causal = a.causal;
  r.init = a.init;
  r.finalize = a.finalize;
  r.scale = a.scale;
  CUtensorMap tm[3];
  const da_attn::View<const void>* v[3] = {&a.q, &a.k, &a.v};
  uint32_t* pos[3] = {&r.qpos, &r.kpos, &r.vpos};
  for (int i = 0; i < 3; ++i) {
    const int rc = da_sm90::view_map(&tm[i], pos[i], v[i]->p, i ? a.sk : a.sq,
                                     a.hall, v[i]->ss, v[i]->sb, v[i]->sh,
                                     v[i]->nh, a.d);
    if (rc) return rc;
  }
  const size_t sm = da_sm90::aw_smem_bytes<DMAX, NWG>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<DMAX, NWG, CARRY>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm);
  if (err != cudaSuccess) return (int)err;
  const int rows = NWG * da_sm90::AW_ROWS;
  const int nq = (a.sq + rows - 1) / rows;
  flash_wgmma_kernel<DMAX, NWG, CARRY>
      <<<nq * a.hall, 128 * NWG + 32, sm, s>>>(tm[0], tm[1], tm[2], r);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_forward(const void* kc, const void* vc, void* fk, void* fv,
                   int64_t count, int ncopy, cudaStream_t s) {
  forward_kernel<T><<<ncopy, THREADS, 0, s>>>(
      static_cast<const T*>(kc), static_cast<const T*>(vc),
      static_cast<T*>(fk), static_cast<T*>(fv), count);
  return (int)cudaGetLastError();
}

// meta: for q, k, v, o in turn the row stride, the two head strides (nb
// and nh parts) and nh, all in elements.
Args make_args(const void* q, const void* k, const void* v, void* o,
               float* lse, float* m, float* l, float* acc,
               const long long* meta, int sq, int sk, int d, int hall,
               long long qoff, long long koff, int causal, int init,
               int finalize, float scale) {
  Args a;
  const void* in[3] = {q, k, v};
  da_attn::View<const void>* views[3] = {&a.q, &a.k, &a.v};
  for (int t = 0; t < 3; ++t) {
    *views[t] = {in[t], meta[4 * t], meta[4 * t + 1], meta[4 * t + 2],
                 (int)meta[4 * t + 3]};
  }
  a.o = {o, meta[12], meta[13], meta[14], (int)(meta[15] > 0 ? meta[15] : 1)};
  a.lse = lse;
  a.m = m;
  a.l = l;
  a.acc = acc;
  a.sq = sq;
  a.sk = sk;
  a.d = d;
  a.hall = hall;
  a.qoff = qoff;
  a.koff = koff;
  a.causal = causal;
  a.init = init;
  a.finalize = finalize;
  a.scale = scale;
  return a;
}

// route: 0 = f32 (SIMT), 1 = bf16 on mma.sync, 2 = bf16 on wgmma + TMA:
// K5 (a.init) with K5_GROUPS consumer warpgroups a block, K8 with `groups`
// (1 or 2)
int flash(const Args& a, int route, int groups, int device, void* stream) {
  if (a.sq <= 0 || a.hall <= 0) return 0;
  if (a.d <= 0 || a.d > 128 || route < 0 || route > 2 ||
      (route == 2 && groups != 1 && groups != 2))
    return (int)cudaErrorInvalidValue;
  if (route == 2 && !da_sm90::views_tma_ok(a.hall, a.d, a.q.nh, a.q, a.k, a.v,
                                            a.o))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (route) {
    case 2:
      if (a.init)
        return a.d <= 64 ? launch_flash_wgmma<64, K5_GROUPS, false>(a, s)
                         : launch_flash_wgmma<128, K5_GROUPS, false>(a, s);
      if (groups == 1)
        return a.d <= 64 ? launch_flash_wgmma<64, 1, true>(a, s)
                         : launch_flash_wgmma<128, 1, true>(a, s);
      return a.d <= 64 ? launch_flash_wgmma<64, 2, true>(a, s)
                       : launch_flash_wgmma<128, 2, true>(a, s);
    case 1:
      return a.d <= 64 ? launch_flash_mma<64>(a, s) : launch_flash_mma<128>(a, s);
    default:
      return a.d <= 64 ? launch_flash<64>(a, s) : launch_flash<128>(a, s);
  }
}

}  // namespace

// K5: o and lse of attention over q (sq rows), k and v (sk rows), hall
// heads of dim d, laid out as `meta` says; o in the operand type, lse
// (hall, sq) f32 (null only off the wgmma route).  route: 0 = f32 (SIMT),
// 1 = bf16 on mma.sync, 2 = bf16 on wgmma + TMA, refused
// (cudaErrorInvalidValue) unless every view is one TMA can read.  Returns the cudaGetLastError() code of the
// launch, or 1000 + the CUresult when a TMA tensor map cannot be encoded.
extern "C" int da_flash_attention(const void* q, const void* k, const void* v,
                                  void* o, void* lse, const long long* meta,
                                  int sq, int sk, int d, int hall, int causal,
                                  float scale, int route, int device,
                                  void* stream) {
  Args a = make_args(q, k, v, o, static_cast<float*>(lse), nullptr, nullptr,
                     nullptr, meta, sq, sk, d, hall, 0, 0, causal, 1, 1,
                     scale);
  return flash(a, route, K5_GROUPS, device, stream);
}

// K8: one hop.  The carry m, l (hall, sq) and acc (hall, sq, d) f32 is
// read and then overwritten in place; qoff and koff are the global
// positions of the first query and key row; `meta` as K5's (o's entries
// repeat q's).  route: 0 = f32 (SIMT), 1 = bf16 on mma.sync, 2 = bf16 on
// wgmma + TMA with `groups` (1 or 2) consumer warpgroups a block, refused
// (cudaErrorInvalidValue) unless every view is one TMA can read.  Returns
// the cudaGetLastError() code of the launch, or 1000 + the CUresult when a
// TMA tensor map cannot be encoded.
extern "C" int da_flash_hop(const void* q, const void* k, const void* v,
                            void* m, void* l, void* acc,
                            const long long* meta, int sq, int sk, int d,
                            int hall, long long qoff, long long koff,
                            int causal, float scale, int route, int groups,
                            int device, void* stream) {
  Args a = make_args(q, k, v, nullptr, nullptr, static_cast<float*>(m),
                     static_cast<float*>(l), static_cast<float*>(acc), meta,
                     sq, sk, d, hall, qoff, koff, causal, 0, 0, scale);
  return flash(a, route, groups, device, stream);
}

// K9: step `first`..`last` of the ring for one rank.  q (b, h, dh) and the
// resident pair kc, vc (b, h, dh) in the operand type; the carry m, l
// (h, b) and acc (h, b, dh) f32 is started afresh when `first` and
// replaced by o (b, h, dh) when `last`; fk/fv (null at the last step)
// receive copies of kc/vc.  qoff, koff: global positions of the q block
// and of the resident block.  compute = 0: the resident block is masked
// for every query row, so the carry is only started or finished.  route:
// 0 = f32 (SIMT), 1 = bf16 on mma.sync, 2 = bf16 on wgmma + TMA (dh a
// multiple of 8, 16-byte aligned q, kc, vc).  Returns the
// cudaGetLastError() code of the launch, or 1000 + the CUresult
// when a TMA tensor map cannot be encoded.
extern "C" int da_ring_attn_step(const void* q, const void* kc,
                                 const void* vc, void* o, void* m, void* l,
                                 void* acc, void* fk, void* fv, int b, int h,
                                 int dh, long long qoff, long long koff,
                                 int causal, int first, int last,
                                 int compute, float scale, int route,
                                 int device, void* stream) {
  if (b <= 0 || h <= 0) return 0;
  if (dh <= 0 || dh > 128 || route < 0 || route > 2)
    return (int)cudaErrorInvalidValue;
  if (route == 2 && (dh % 8 || ((uintptr_t)q | (uintptr_t)kc |
                                (uintptr_t)vc) % 16))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int ncopy = fk ? 32 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!compute && !first && !last) {  // nothing but the forward
    if (!ncopy) return 0;
    const int64_t count = (int64_t)b * h * dh;
    return route ? launch_forward<__nv_bfloat16>(kc, vc, fk, fv, count,
                                                 ncopy, s)
                 : launch_forward<float>(kc, vc, fk, fv, count, ncopy, s);
  }
  const long long hd = (long long)h * dh;
  const long long meta[16] = {hd, 0, dh, h, hd, 0, dh, h,
                              hd, 0, dh, h, hd, 0, dh, h};
  Args a = make_args(q, kc, vc, o, nullptr, static_cast<float*>(m),
                     static_cast<float*>(l), static_cast<float*>(acc), meta, b,
                     compute ? b : 0, dh, h, qoff, koff, causal, first, last,
                     scale);
  switch (route) {
    case 2:
      return dh <= 64 ? launch_ring_wgmma<64>(a, q, kc, vc, fk, fv, ncopy, s)
                      : launch_ring_wgmma<128>(a, q, kc, vc, fk, fv, ncopy, s);
    case 1:
      return dh <= 64 ? launch_ring_mma<64>(a, kc, vc, fk, fv, ncopy, s)
                      : launch_ring_mma<128>(a, kc, vc, fk, fv, ncopy, s);
    default:
      return dh <= 64 ? launch_ring<64>(a, kc, vc, fk, fv, ncopy, s)
                      : launch_ring<128>(a, kc, vc, fk, fv, ncopy, s);
  }
}
