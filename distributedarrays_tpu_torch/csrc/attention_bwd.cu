// The FlashAttention-2 backward for Hopper (sm_90a): two kernels that
// recompute P from the forward's logsumexp and never hold an S x S matrix.
//
// - K6 `da_flash_bwd_dq` replaces distributedarrays_tpu/ops/
//   pallas_attention.py `_bwd_dq_kernel` (the dq pallas_call of
//   `_build_bwd`): a block owns a tile of query rows of one head, loops
//   over the key tiles up to its causal limit, judged in global positions
//   (qoff/koff), and writes dq once.  The Pallas grid carries the dq
//   accumulator across its sequential K axis in VMEM; here it stays in
//   registers for the whole loop, so no block shares an output row and no
//   atomics are needed.
// - K7 `da_flash_bwd_dkv` replaces `_bwd_dkv_kernel` (the dk/dv
//   pallas_call): one block per (head, 64-key tile) loops over the query
//   tiles from its causal start and accumulates dk and dv in f32.
// Both take one of three routes, chosen by the caller (`route`) and
// refused here when the views cannot take it: bf16 whose views TMA can read
// (head dim a multiple of 8, strides multiples of 16 bytes, 16-byte aligned
// bases) on wgmma + TMA (attn_bwd_sm90.cuh `dq_wgmma`, `dkv_wgmma`), other
// bf16 on mma.sync, f32 on the SIMT loops.
//
// Numerics are the TPU kernels': s = q.k as f32 sums of products of the
// input values, times the scale, then masked; p = exp(s - lse), 0 where
// masked; dp = do.v; ds = p * (dp - dd) * scale; dq = round(ds).k,
// dk = round(ds)^T.q and dv = round(p)^T.do, where round() rounds to the
// input type and every product sums in f32.  dd = rowsum(do * o) and lse
// are (H_all, Sq) f32.  A ragged S is masked in the kernel (the JAX model
// pads S instead).  Operands are the strided (S, H, D) / (S, B, H, D) /
// (H, B, D) views of attn_tile.cuh's View, so the transformer's fused QKV
// views need no copy; the outputs are views too, in the operand type or
// f32 (the ring hop's contributions).
//
// Bound on an H100: operations.  Per visible (query, key) pair K6 does
// 6*D (QK^T, dO V^T, dS K) and K7 8*D (QK^T, dO V^T, P^T dO, dS^T Q).
// f32 runs on the FMA pipes (SIMT, 67 TFLOP/s): four threads per row as in
// attn_tile.cuh's `attend`.  bf16 runs on the tensor cores with
// mma.sync.m16n8k16 (989 TFLOP/s): the S and dP accumulators of two
// neighbouring 8-column tiles are the A fragment of P or dS for a 16-wide
// chunk, rounded to bf16 in registers, and the B fragments of K (for dq),
// dO and Q (for dv, dk) come transposed out of ldmatrix.trans; the tiles
// stream through a two-stage cp.async pipeline.  On that route each of
// K7's 4 warps reads the whole Q and dO tile from shared memory for its S^T
// and dP^T fragments and issues two ldmatrix.trans per (16-query chunk,
// 8-column tile), 16 KB and 64 ldmatrix a warp a tile; the wgmma routes
// feed the tensor cores straight from the TMA-written tiles instead.

#include "attn_bwd_sm90.cuh"
#include "attn_tile.cuh"

namespace {

using bf = __nv_bfloat16;
using da_attn::BQ;
using da_attn::View;
using da_attn::finite;

struct BwdArgs {
  View<const void> q, k, v, dout;
  View<void> dq, dk, dv;
  const float* lse;  // (hall, sq) f32
  const float* dd;   // (hall, sq) f32: rowsum(do * o)
  int sq, sk, d, hall;
  int64_t qoff, koff;  // global positions of query row 0 and key row 0
  int causal;
  float scale;
  int out_f32;  // outputs in f32 (else in the operand type)
};

// element `off` of a bf16 kernel's output view, in f32 or in bf16
__device__ __forceinline__ void st(void* base, int64_t off, float x, int f32) {
  if (f32)
    static_cast<float*>(base)[off] = x;
  else
    static_cast<bf*>(base)[off] = __float2bfloat16_rn(x);
}

// the keys [0, kend) a query tile starting at row q0 can see
__device__ __forceinline__ int key_end(const BwdArgs& a, int q0, int rows) {
  if (!a.causal) return a.sk;
  const int64_t last = a.qoff + q0 + rows - a.koff;
  return (int)(last < 0 ? 0 : (last < a.sk ? last : a.sk));
}

// the first query row that can see a key tile starting at key k0
__device__ __forceinline__ int query_start(const BwdArgs& a, int k0) {
  if (!a.causal) return 0;
  const int64_t first = a.koff + k0 - a.qoff;
  return (int)(first < 0 ? 0 : (first < a.sq ? first : a.sq));
}

// ---------------------------------------------------------------------------
// SIMT loops (f32)
// ---------------------------------------------------------------------------

constexpr int TPR = 4;               // threads per row
constexpr int THREADS = BQ * TPR;    // 256
constexpr int BK = 32;               // K6: key rows per shared tile
constexpr int BKEY = 64;             // K7: key rows per block
constexpr int BQT = 32;              // K7: query rows per shared tile
constexpr int NPT = 8;               // scores per thread per tile

inline size_t dq_smem_bytes(int d) {
  return sizeof(float) * ((size_t)2 * BQ * (d + 1) + (size_t)2 * BK * (d + 1) +
                          (size_t)BQ * (BK + 1));
}

inline size_t dkv_smem_bytes(int d) {
  return sizeof(float) *
         ((size_t)2 * BKEY * (d + 1) + (size_t)2 * BQT * (d + 1) +
          (size_t)2 * BKEY * (BQT + 1) + 2 * BQT);
}

// K6, SIMT: thread (r, j) owns query row r of the tile, the keys j + 4c of
// each key tile and the head-dim columns j + 4i of dq.
template <int DMAX>
__global__ void __launch_bounds__(THREADS) bwd_dq_kernel(const BwdArgs a) {
  extern __shared__ float smem[];
  const int D = a.d;
  const int nq = (a.sq + BQ - 1) / BQ;
  const int n = blockIdx.x % a.hall;
  int qt = blockIdx.x / a.hall;
  if (a.causal) qt = nq - 1 - qt;  // heaviest query tiles first
  const int tid = threadIdx.x, r = tid / TPR, j = tid % TPR;
  float* Qs = smem;                 // [BQ][D+1]
  float* Os = Qs + BQ * (D + 1);    // dO [BQ][D+1]
  float* Ks = Os + BQ * (D + 1);    // [BK][D+1]
  float* Vs = Ks + BK * (D + 1);    // [BK][D+1]
  float* Ss = Vs + BK * (D + 1);    // dS [BQ][BK+1]
  const float* q = static_cast<const float*>(a.q.p) + a.q.head(n);
  const float* k = static_cast<const float*>(a.k.p) + a.k.head(n);
  const float* v = static_cast<const float*>(a.v.p) + a.v.head(n);
  const float* o = static_cast<const float*>(a.dout.p) + a.dout.head(n);
  const int q0 = qt * BQ;
  const int row = q0 + r;
  const bool row_ok = row < a.sq;
  for (int i = tid; i < BQ * D; i += THREADS) {
    const int rr = i / D, dd = i % D;
    const bool in = q0 + rr < a.sq;
    Qs[rr * (D + 1) + dd] = in ? q[(int64_t)(q0 + rr) * a.q.ss + dd] : 0.f;
    Os[rr * (D + 1) + dd] =
        in ? o[(int64_t)(q0 + rr) * a.dout.ss + dd] : 0.f;
  }
  const int64_t crow = (int64_t)n * a.sq + row;
  const float lse = row_ok ? a.lse[crow] : 0.f;
  const float ddr = row_ok ? a.dd[crow] : 0.f;
  const int64_t qpos = a.qoff + row;
  const int kend = key_end(a, q0, BQ);

  constexpr int NA = DMAX / TPR;
  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile's Ks/Ss are consumed
    for (int i = tid; i < BK * D; i += THREADS) {
      const int kk = i / D, dd = i % D;
      const bool in = k0 + kk < a.sk;
      Ks[kk * (D + 1) + dd] = in ? k[(int64_t)(k0 + kk) * a.k.ss + dd] : 0.f;
      Vs[kk * (D + 1) + dd] = in ? v[(int64_t)(k0 + kk) * a.v.ss + dd] : 0.f;
    }
    __syncthreads();
    float s[NPT], dp[NPT];
#pragma unroll
    for (int c = 0; c < NPT; ++c) s[c] = dp[c] = 0.f;
    const float* qr = Qs + r * (D + 1);
    const float* orow = Os + r * (D + 1);
    for (int dd = 0; dd < D; ++dd) {
      const float qd = qr[dd], od = orow[dd];
#pragma unroll
      for (int c = 0; c < NPT; ++c) {
        s[c] = fmaf(qd, Ks[(j + TPR * c) * (D + 1) + dd], s[c]);
        dp[c] = fmaf(od, Vs[(j + TPR * c) * (D + 1) + dd], dp[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < NPT; ++c) {
      const int key = k0 + j + TPR * c;
      bool live = key < a.sk;
      if (a.causal) live = live && (a.koff + key <= qpos);
      const float p = live ? expf(s[c] * a.scale - lse) : 0.f;
      Ss[r * (BK + 1) + j + TPR * c] = p * (dp[c] - ddr) * a.scale;
    }
    __syncthreads();
    const float* sr = Ss + r * (BK + 1);
    for (int kk = 0; kk < BK; ++kk) {
      const float ds = sr[kk];
      const float* kr = Ks + kk * (D + 1);
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const int dd = j + TPR * i;
        if (dd < D) acc[i] = fmaf(ds, kr[dd], acc[i]);
      }
    }
  }
  if (!row_ok) return;
  const int64_t base = a.dq.head(n) + (int64_t)row * a.dq.ss;
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int dd = j + TPR * i;
    if (dd < D) static_cast<float*>(a.dq.p)[base + dd] = acc[i];
  }
}

// K7, SIMT: thread (r, j) owns key row r of the block's 64, the queries
// j + 4c of each query tile and the head-dim columns j + 4i of dk and dv.
template <int DMAX>
__global__ void __launch_bounds__(THREADS) bwd_dkv_kernel(const BwdArgs a) {
  extern __shared__ float smem[];
  const int D = a.d;
  const int n = blockIdx.x % a.hall;
  const int k0 = (blockIdx.x / a.hall) * BKEY;  // heaviest (earliest) first
  const int tid = threadIdx.x, r = tid / TPR, j = tid % TPR;
  float* Ks = smem;                    // [BKEY][D+1]
  float* Vs = Ks + BKEY * (D + 1);     // [BKEY][D+1]
  float* Qs = Vs + BKEY * (D + 1);     // [BQT][D+1]
  float* Os = Qs + BQT * (D + 1);      // dO [BQT][D+1]
  float* Ps = Os + BQT * (D + 1);      // p [BKEY][BQT+1]
  float* Ss = Ps + BKEY * (BQT + 1);   // dS [BKEY][BQT+1]
  float* Ls = Ss + BKEY * (BQT + 1);   // lse [BQT]
  float* Ds = Ls + BQT;                // dd [BQT]
  const float* q = static_cast<const float*>(a.q.p) + a.q.head(n);
  const float* k = static_cast<const float*>(a.k.p) + a.k.head(n);
  const float* v = static_cast<const float*>(a.v.p) + a.v.head(n);
  const float* o = static_cast<const float*>(a.dout.p) + a.dout.head(n);
  for (int i = tid; i < BKEY * D; i += THREADS) {
    const int kk = i / D, dd = i % D;
    const bool in = k0 + kk < a.sk;
    Ks[kk * (D + 1) + dd] = in ? k[(int64_t)(k0 + kk) * a.k.ss + dd] : 0.f;
    Vs[kk * (D + 1) + dd] = in ? v[(int64_t)(k0 + kk) * a.v.ss + dd] : 0.f;
  }
  const int key = k0 + r;
  const int64_t kpos = a.koff + key;
  const int qstart = query_start(a, k0) / BQT * BQT;

  constexpr int NA = DMAX / TPR;
  float dk[NA], dv[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) dk[i] = dv[i] = 0.f;
  for (int q0 = qstart; q0 < a.sq; q0 += BQT) {
    __syncthreads();  // Ks/Vs staged; the previous tile's Qs/Ps consumed
    for (int i = tid; i < BQT * D; i += THREADS) {
      const int rr = i / D, dd = i % D;
      const bool in = q0 + rr < a.sq;
      Qs[rr * (D + 1) + dd] = in ? q[(int64_t)(q0 + rr) * a.q.ss + dd] : 0.f;
      Os[rr * (D + 1) + dd] =
          in ? o[(int64_t)(q0 + rr) * a.dout.ss + dd] : 0.f;
    }
    if (tid < BQT) {
      const bool in = q0 + tid < a.sq;
      Ls[tid] = in ? a.lse[(int64_t)n * a.sq + q0 + tid] : 0.f;
      Ds[tid] = in ? a.dd[(int64_t)n * a.sq + q0 + tid] : 0.f;
    }
    __syncthreads();
    float s[NPT], dp[NPT];
#pragma unroll
    for (int c = 0; c < NPT; ++c) s[c] = dp[c] = 0.f;
    const float* kr = Ks + r * (D + 1);
    const float* vr = Vs + r * (D + 1);
    for (int dd = 0; dd < D; ++dd) {
      const float kd = kr[dd], vd = vr[dd];
#pragma unroll
      for (int c = 0; c < NPT; ++c) {
        s[c] = fmaf(Qs[(j + TPR * c) * (D + 1) + dd], kd, s[c]);
        dp[c] = fmaf(Os[(j + TPR * c) * (D + 1) + dd], vd, dp[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < NPT; ++c) {
      const int qi = j + TPR * c;
      bool live = q0 + qi < a.sq;
      if (a.causal) live = live && (kpos <= a.qoff + q0 + qi);
      const float p = live ? expf(s[c] * a.scale - Ls[qi]) : 0.f;
      Ps[r * (BQT + 1) + qi] = p;
      Ss[r * (BQT + 1) + qi] = p * (dp[c] - Ds[qi]) * a.scale;
    }
    __syncthreads();
    const float* pr = Ps + r * (BQT + 1);
    const float* sr = Ss + r * (BQT + 1);
    for (int qq = 0; qq < BQT; ++qq) {
      const float p = pr[qq], ds = sr[qq];
      const float* orow = Os + qq * (D + 1);
      const float* qrow = Qs + qq * (D + 1);
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const int dd = j + TPR * i;
        if (dd < D) {
          dv[i] = fmaf(p, orow[dd], dv[i]);
          dk[i] = fmaf(ds, qrow[dd], dk[i]);
        }
      }
    }
  }
  if (key >= a.sk) return;
  const int64_t bk = a.dk.head(n) + (int64_t)key * a.dk.ss;
  const int64_t bv = a.dv.head(n) + (int64_t)key * a.dv.ss;
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int dd = j + TPR * i;
    if (dd < D) {
      static_cast<float*>(a.dk.p)[bk + dd] = dk[i];
      static_cast<float*>(a.dv.p)[bv + dd] = dv[i];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (mma.sync.m16n8k16, f32 accumulators)
// ---------------------------------------------------------------------------

using da_attn::MMA_PAD;
using da_attn::MMA_THREADS;
using da_attn::cp_async_commit;
using da_attn::cp_async_wait;
using da_attn::ld32;
using da_attn::ldmatrix_v;
using da_attn::mma_bf16;
using da_attn::pack_bf16;
using da_attn::pad16;

constexpr int MT = 64;  // rows of the streamed tiles (keys in K6, queries in K7)

// the A fragment of rows [row0, row0 + 16) and head-dim chunk kc of a
// [rows][ld] bf16 tile
__device__ __forceinline__ void frag_a(const bf* s, int ld, int row0, int kc,
                                       int g, int t, uint32_t (&f)[4]) {
  const bf* p = s + (row0 + g) * ld + kc * 16 + 2 * t;
  f[0] = ld32(p);
  f[1] = ld32(p + 8 * ld);
  f[2] = ld32(p + 8);
  f[3] = ld32(p + 8 * ld + 8);
}

// the A fragment of a 16-wide chunk from the accumulators of its two
// 8-wide column tiles, rounded to bf16
__device__ __forceinline__ void acc_to_a(const float (&x)[4],
                                         const float (&y)[4],
                                         uint32_t (&f)[4]) {
  f[0] = pack_bf16(x[0], x[1]);
  f[1] = pack_bf16(x[2], x[3]);
  f[2] = pack_bf16(y[0], y[1]);
  f[3] = pack_bf16(y[2], y[3]);
}

// Shared memory of the tensor-core kernels: two resident [64][ld] tiles
// and two stages of two streamed [MT][ld] tiles, plus (K7) two stages of
// the streamed rows' lse and dd.
inline size_t mma_smem_bytes(int d) {
  return sizeof(bf) * (size_t)(2 * BQ + 4 * MT) * (pad16(d) + MMA_PAD) +
         sizeof(float) * 4 * MT;
}

// K6 on the tensor cores: a block of 4 warps owns 64 query rows (16 a
// warp), holds their Q and dO A fragments in registers, and streams K and
// V tiles of MT keys.
template <int DMAX>
__global__ void __launch_bounds__(MMA_THREADS) bwd_dq_mma_kernel(const BwdArgs a) {
  extern __shared__ uint4 smem_v[];
  bf* sm = reinterpret_cast<bf*>(smem_v);
  const int D = a.d, dp = pad16(D), ldt = dp + MMA_PAD;
  bf* Qs = sm;               // [BQ][ldt]
  bf* Os = Qs + BQ * ldt;    // dO [BQ][ldt]
  bf* KV = Os + BQ * ldt;    // two stages of [K tile][V tile], [MT][ldt] each
  const int nq = (a.sq + BQ - 1) / BQ;
  const int n = blockIdx.x % a.hall;
  int qt = blockIdx.x / a.hall;
  if (a.causal) qt = nq - 1 - qt;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const bf* q = static_cast<const bf*>(a.q.p) + a.q.head(n);
  const bf* k = static_cast<const bf*>(a.k.p) + a.k.head(n);
  const bf* v = static_cast<const bf*>(a.v.p) + a.v.head(n);
  const bf* o = static_cast<const bf*>(a.dout.p) + a.dout.head(n);
  const int q0 = qt * BQ;
  da_attn::stage<false>(q, a.q.ss, q0, a.sq, BQ, D, dp, Qs, ldt);
  da_attn::stage<false>(o, a.dout.ss, q0, a.sq, BQ, D, dp, Os, ldt);
  const int ntiles = (key_end(a, q0, BQ) + MT - 1) / MT;
  auto issue = [&](int it) {
    bf* Ks = KV + (it % 2) * 2 * MT * ldt;
    da_attn::stage<true>(k, a.k.ss, it * MT, a.sk, MT, D, dp, Ks, ldt);
    da_attn::stage<true>(v, a.v.ss, it * MT, a.sk, MT, D, dp, Ks + MT * ldt, ldt);
    cp_async_commit();
  };
  if (ntiles > 0) issue(0);
  __syncthreads();
  constexpr int KC = DMAX / 16, ND = DMAX / 8;
  const int kcs = dp / 16, nds = dp / 8;
  uint32_t qa[KC][4], oa[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
    if (kc < kcs) {
      frag_a(Qs, ldt, warp * 16, kc, g, t, qa[kc]);
      frag_a(Os, ldt, warp * 16, kc, g, t, oa[kc]);
    }
  int row[2];
  float lse[2], ddr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = q0 + warp * 16 + g + 8 * h;
    const bool in = row[h] < a.sq;
    lse[h] = in ? a.lse[(int64_t)n * a.sq + row[h]] : 0.f;
    ddr[h] = in ? a.dd[(int64_t)n * a.sq + row[h]] : 0.f;
  }
  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) issue(it + 1);
    cp_async_wait(it + 1 < ntiles ? 1 : 0);
    __syncthreads();
    const int k0 = it * MT;
    const bf* Ks = KV + (it % 2) * 2 * MT * ldt;
    const bf* Vs = Ks + MT * ldt;
    float s[MT / 8][4], dpv[MT / 8][4];
#pragma unroll
    for (int jt = 0; jt < MT / 8; ++jt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[jt][e] = dpv[jt][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        if (kc < kcs) {
          const bf* kb = Ks + (jt * 8 + g) * ldt + kc * 16 + 2 * t;
          mma_bf16(s[jt], qa[kc], ld32(kb), ld32(kb + 8));
          const bf* vb = Vs + (jt * 8 + g) * ldt + kc * 16 + 2 * t;
          mma_bf16(dpv[jt], oa[kc], ld32(vb), ld32(vb + 8));
        }
    }
#pragma unroll
    for (int jt = 0; jt < MT / 8; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int key = k0 + jt * 8 + 2 * t + (e & 1);
        bool live = key < a.sk;
        if (a.causal) live = live && (a.koff + key <= a.qoff + row[h]);
        const float p = live ? expf(s[jt][e] * a.scale - lse[h]) : 0.f;
        s[jt][e] = p * (dpv[jt][e] - ddr[h]) * a.scale;  // dS
      }
    // dq += round(dS) K, K's B fragments transposed out of [key][d]
#pragma unroll
    for (int c = 0; c < MT / 16; ++c) {
      uint32_t da[4];
      acc_to_a(s[2 * c], s[2 * c + 1], da);
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
        if (nd < nds) {
          uint32_t b0, b1;
          ldmatrix_v(Ks, ldt, c * 16, nd * 8, lane, b0, b1);
          mma_bf16(acc[nd], da, b0, b1);
        }
    }
    __syncthreads();  // this stage is read; the next issue refills it
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= a.sq) continue;
    const int64_t base = a.dq.head(n) + (int64_t)row[h] * a.dq.ss;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int dd = nd * 8 + 2 * t + e;
        if (dd < D) st(a.dq.p, base + dd, acc[nd][2 * h + e], a.out_f32);
      }
  }
}

// K7 on the tensor cores: a block of 4 warps owns 64 keys (16 a warp),
// holds their K and V A fragments in registers and streams Q and dO tiles
// of MT queries; S^T = K Q^T and dP^T = V dO^T come out with the keys as
// rows, so P^T and dS^T are A fragments for dv += P^T dO and dk += dS^T Q.
template <int DMAX>
__global__ void __launch_bounds__(MMA_THREADS) bwd_dkv_mma_kernel(const BwdArgs a) {
  extern __shared__ uint4 smem_v[];
  bf* sm = reinterpret_cast<bf*>(smem_v);
  const int D = a.d, dp = pad16(D), ldt = dp + MMA_PAD;
  bf* Ks = sm;               // [BQ][ldt] (64 keys)
  bf* Vs = Ks + BQ * ldt;
  bf* QO = Vs + BQ * ldt;    // two stages of [Q tile][dO tile], [MT][ldt] each
  float* LD = reinterpret_cast<float*>(QO + 4 * MT * ldt);  // [2][lse, dd][MT]
  const int n = blockIdx.x % a.hall;
  const int k0 = (blockIdx.x / a.hall) * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const bf* q = static_cast<const bf*>(a.q.p) + a.q.head(n);
  const bf* k = static_cast<const bf*>(a.k.p) + a.k.head(n);
  const bf* v = static_cast<const bf*>(a.v.p) + a.v.head(n);
  const bf* o = static_cast<const bf*>(a.dout.p) + a.dout.head(n);
  da_attn::stage<false>(k, a.k.ss, k0, a.sk, BQ, D, dp, Ks, ldt);
  da_attn::stage<false>(v, a.v.ss, k0, a.sk, BQ, D, dp, Vs, ldt);
  const int it0 = query_start(a, k0) / MT;
  const int ntiles = (a.sq + MT - 1) / MT;
  auto issue = [&](int it) {
    bf* Qt = QO + (it % 2) * 2 * MT * ldt;
    da_attn::stage<true>(q, a.q.ss, it * MT, a.sq, MT, D, dp, Qt, ldt);
    da_attn::stage<true>(o, a.dout.ss, it * MT, a.sq, MT, D, dp, Qt + MT * ldt,
                         ldt);
    cp_async_commit();
    float* L = LD + (it % 2) * 2 * MT;
    for (int i = threadIdx.x; i < MT; i += MMA_THREADS) {
      const bool in = it * MT + i < a.sq;
      const int64_t c = (int64_t)n * a.sq + it * MT + i;
      L[i] = in ? a.lse[c] : 0.f;
      L[MT + i] = in ? a.dd[c] : 0.f;
    }
  };
  if (it0 < ntiles) issue(it0);
  __syncthreads();
  constexpr int KC = DMAX / 16, ND = DMAX / 8;
  const int kcs = dp / 16, nds = dp / 8;
  uint32_t ka[KC][4], va[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
    if (kc < kcs) {
      frag_a(Ks, ldt, warp * 16, kc, g, t, ka[kc]);
      frag_a(Vs, ldt, warp * 16, kc, g, t, va[kc]);
    }
  int64_t kpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) kpos[h] = a.koff + k0 + warp * 16 + g + 8 * h;
  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nd][e] = dv[nd][e] = 0.f;

  for (int it = it0; it < ntiles; ++it) {
    if (it + 1 < ntiles) issue(it + 1);
    cp_async_wait(it + 1 < ntiles ? 1 : 0);
    __syncthreads();
    const int q0 = it * MT;
    const bf* Qt = QO + (it % 2) * 2 * MT * ldt;
    const bf* Ot = Qt + MT * ldt;
    const float* L = LD + (it % 2) * 2 * MT;
    float s[MT / 8][4], dpv[MT / 8][4];
#pragma unroll
    for (int jt = 0; jt < MT / 8; ++jt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[jt][e] = dpv[jt][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        if (kc < kcs) {
          const bf* qb = Qt + (jt * 8 + g) * ldt + kc * 16 + 2 * t;
          mma_bf16(s[jt], ka[kc], ld32(qb), ld32(qb + 8));
          const bf* ob = Ot + (jt * 8 + g) * ldt + kc * 16 + 2 * t;
          mma_bf16(dpv[jt], va[kc], ld32(ob), ld32(ob + 8));
        }
    }
#pragma unroll
    for (int jt = 0; jt < MT / 8; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int qi = jt * 8 + 2 * t + (e & 1);
        bool live = q0 + qi < a.sq;
        if (a.causal) live = live && (kpos[h] <= a.qoff + q0 + qi);
        const float p = live ? expf(s[jt][e] * a.scale - L[qi]) : 0.f;
        s[jt][e] = p;                                         // P^T
        dpv[jt][e] = p * (dpv[jt][e] - L[MT + qi]) * a.scale;  // dS^T
      }
    // dv += round(P^T) dO and dk += round(dS^T) Q, with dO's and Q's B
    // fragments transposed out of [query][d]
#pragma unroll
    for (int c = 0; c < MT / 16; ++c) {
      uint32_t pa[4], da[4];
      acc_to_a(s[2 * c], s[2 * c + 1], pa);
      acc_to_a(dpv[2 * c], dpv[2 * c + 1], da);
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
        if (nd < nds) {
          uint32_t b0, b1;
          ldmatrix_v(Ot, ldt, c * 16, nd * 8, lane, b0, b1);
          mma_bf16(dv[nd], pa, b0, b1);
          ldmatrix_v(Qt, ldt, c * 16, nd * 8, lane, b0, b1);
          mma_bf16(dk[nd], da, b0, b1);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + warp * 16 + g + 8 * h;
    if (key >= a.sk) continue;
    const int64_t bk = a.dk.head(n) + (int64_t)key * a.dk.ss;
    const int64_t bv = a.dv.head(n) + (int64_t)key * a.dv.ss;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int dd = nd * 8 + 2 * t + e;
        if (dd < D) {
          st(a.dk.p, bk + dd, dk[nd][2 * h + e], a.out_f32);
          st(a.dv.p, bv + dd, dv[nd][2 * h + e], a.out_f32);
        }
      }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t fit_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename K>
int launch(K kernel, int blocks, int threads, size_t smem, const BwdArgs& a,
           cudaStream_t s) {
  cudaError_t err = fit_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, threads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// K6 on mma.sync (bf16 != 0) or the SIMT loop
template <int DMAX>
int launch_dq(const BwdArgs& a, int bf16, cudaStream_t s) {
  const int blocks = (a.sq + BQ - 1) / BQ * a.hall;
  if (bf16)
    return launch(bwd_dq_mma_kernel<DMAX>, blocks, MMA_THREADS,
                  mma_smem_bytes(a.d), a, s);
  return launch(bwd_dq_kernel<DMAX>, blocks, THREADS,
                dq_smem_bytes(a.d), a, s);
}

template <int DMAX>
int launch_dkv(const BwdArgs& a, int bf16, cudaStream_t s) {
  const int blocks = (a.sk + BQ - 1) / BQ * a.hall;
  if (bf16)
    return launch(bwd_dkv_mma_kernel<DMAX>, blocks, MMA_THREADS,
                  mma_smem_bytes(a.d), a, s);
  return launch(bwd_dkv_kernel<DMAX>, blocks, THREADS,
                dkv_smem_bytes(a.d), a, s);
}

// K7 in bf16 on wgmma + TMA: one consumer warpgroup of 64 keys a block,
// the earliest (heaviest causal) key tiles first, held to two blocks an SM
// at DMAX 64 (dk, dv, S^T and dP^T take 128 of a thread's registers).
template <int DMAX>
__global__ void __launch_bounds__(da_sm90::BW_THREADS, DMAX > 64 ? 1 : 2)
bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const da_sm90::DkvArgs a) {
  extern __shared__ uint8_t smem_b[];
  da_sm90::dkv_wgmma<DMAX>(&tq, &tk, &tv, &tdo, a, blockIdx.x % a.h,
                           blockIdx.x / a.h, smem_b);
}

template <int DMAX>
int launch_dkv_wgmma(const BwdArgs& a, cudaStream_t s) {
  da_sm90::DkvArgs r;
  r.lse = a.lse;
  r.dd = a.dd;
  r.dk = a.dk.p;
  r.dv = a.dv.p;
  r.kss = a.dk.ss;
  r.ksb = a.dk.sb;
  r.ksh = a.dk.sh;
  r.vss = a.dv.ss;
  r.vsb = a.dv.sb;
  r.vsh = a.dv.sh;
  r.sq = a.sq;
  r.sk = a.sk;
  r.h = a.hall;
  r.dh = a.d;
  r.nh = a.q.nh;
  r.qoff = a.qoff;
  r.koff = a.koff;
  r.causal = a.causal;
  r.out_f32 = a.out_f32;
  r.scale = a.scale;
  CUtensorMap tm[4];
  const View<const void>* v[4] = {&a.q, &a.k, &a.v, &a.dout};
  uint32_t* pos[4] = {&r.qpos, &r.kpos, &r.vpos, &r.opos};
  for (int i = 0; i < 4; ++i) {
    const int rows = i == 1 || i == 2 ? a.sk : a.sq;
    const int rc = da_sm90::view_map(&tm[i], pos[i], v[i]->p, rows, a.hall,
                                     v[i]->ss, v[i]->sb, v[i]->sh, v[i]->nh,
                                     a.d);
    if (rc) return rc;
  }
  const size_t sm = da_sm90::bw_smem_bytes<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkv_wgmma_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sm);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (a.sk + da_sm90::BW_KEYS - 1) / da_sm90::BW_KEYS * a.hall;
  bwd_dkv_wgmma_kernel<DMAX><<<blocks, da_sm90::BW_THREADS, sm, s>>>(
      tm[0], tm[1], tm[2], tm[3], r);
  return (int)cudaGetLastError();
}

// K6 in bf16 on wgmma + TMA: one consumer warpgroup of 64 queries a
// block, the latest (heaviest causal) query tiles first, held to three
// blocks an SM at DMAX 64 (attn_bwd_sm90.cuh gives the layouts timed).
template <int DMAX>
__global__ void __launch_bounds__(da_sm90::BW_THREADS, DMAX > 64 ? 1 : 3)
bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const da_sm90::DqArgs a) {
  extern __shared__ uint8_t smem_b[];
  const int nq = (a.sq + da_sm90::AW_ROWS - 1) / da_sm90::AW_ROWS;
  const int n = blockIdx.x % a.h;
  int qt = blockIdx.x / a.h;
  if (a.causal) qt = nq - 1 - qt;
  da_sm90::dq_wgmma<DMAX>(&tq, &tk, &tv, &tdo, a, n, qt, smem_b);
}

template <int DMAX>
int launch_dq_wgmma(const BwdArgs& a, cudaStream_t s) {
  da_sm90::DqArgs r;
  r.lse = a.lse;
  r.dd = a.dd;
  r.dq = a.dq.p;
  r.qss = a.dq.ss;
  r.qsb = a.dq.sb;
  r.qsh = a.dq.sh;
  r.sq = a.sq;
  r.sk = a.sk;
  r.h = a.hall;
  r.dh = a.d;
  r.nh = a.q.nh;
  r.qoff = a.qoff;
  r.koff = a.koff;
  r.causal = a.causal;
  r.out_f32 = a.out_f32;
  r.scale = a.scale;
  CUtensorMap tm[4];
  const View<const void>* v[4] = {&a.q, &a.k, &a.v, &a.dout};
  uint32_t* pos[4] = {&r.qpos, &r.kpos, &r.vpos, &r.opos};
  for (int i = 0; i < 4; ++i) {
    const int rows = i == 1 || i == 2 ? a.sk : a.sq;
    const int rc = da_sm90::view_map(&tm[i], pos[i], v[i]->p, rows, a.hall,
                                     v[i]->ss, v[i]->sb, v[i]->sh, v[i]->nh,
                                     a.d);
    if (rc) return rc;
  }
  const size_t sm = da_sm90::dq_smem_bytes<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dq_wgmma_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sm);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (a.sq + da_sm90::AW_ROWS - 1) / da_sm90::AW_ROWS * a.hall;
  bwd_dq_wgmma_kernel<DMAX><<<blocks, da_sm90::BW_THREADS, sm, s>>>(
      tm[0], tm[1], tm[2], tm[3], r);
  return (int)cudaGetLastError();
}

// meta: for q, k, v, do, dq, dk, dv in turn the row stride, the two head
// strides (nb and nh parts) and nh, all in elements.
BwdArgs make_args(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* dd, void* dq,
                  void* dk, void* dv, const long long* meta, int sq, int sk,
                  int d, int hall, long long qoff, long long koff, int causal,
                  float scale, int out_f32) {
  BwdArgs a;
  const void* in[4] = {q, k, v, dout};
  View<const void>* iv[4] = {&a.q, &a.k, &a.v, &a.dout};
  for (int i = 0; i < 4; ++i)
    *iv[i] = {in[i], meta[4 * i], meta[4 * i + 1], meta[4 * i + 2],
              (int)meta[4 * i + 3]};
  void* out[3] = {dq, dk, dv};
  View<void>* ov[3] = {&a.dq, &a.dk, &a.dv};
  for (int i = 0; i < 3; ++i) {
    const long long* m = meta + 16 + 4 * i;
    *ov[i] = {out[i], m[0], m[1], m[2], (int)(m[3] > 0 ? m[3] : 1)};
  }
  a.lse = static_cast<const float*>(lse);
  a.dd = static_cast<const float*>(dd);
  a.sq = sq;
  a.sk = sk;
  a.d = d;
  a.hall = hall;
  a.qoff = qoff;
  a.koff = koff;
  a.causal = causal;
  a.scale = scale;
  a.out_f32 = out_f32;
  return a;
}

int prepare(const BwdArgs& a, int device) {
  if (a.d <= 0 || a.d > 128) return (int)cudaErrorInvalidValue;
  return (int)cudaSetDevice(device);
}

}  // namespace

// K6: dq (sq rows) of attention over q, k, v, do with the forward's lse
// and dd = rowsum(do * o), both (hall, sq) f32, laid out as `meta` says;
// dq in the operand type or (out_f32) f32.  route: 0 = f32 (SIMT), 1 =
// bf16 on mma.sync, 2 = bf16 on wgmma + TMA, refused
// (cudaErrorInvalidValue) unless every view is one TMA can read.  dk/dv
// are not touched (may be null).  Returns the cudaGetLastError() code of
// the launch, or 1000 + the CUresult when a TMA tensor map cannot be
// encoded.
extern "C" int da_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* dd, void* dq, const long long* meta,
                               int sq, int sk, int d, int hall, long long qoff,
                               long long koff, int causal, float scale,
                               int route, int out_f32, int device,
                               void* stream) {
  if (sq <= 0 || hall <= 0) return 0;
  BwdArgs a = make_args(q, k, v, dout, lse, dd, dq, nullptr, nullptr, meta,
                        sq, sk, d, hall, qoff, koff, causal, scale, out_f32);
  if (route < 0 || route > 2 ||
      (route == 2 && !da_sm90::views_tma_ok(a.hall, d, a.q.nh, a.q, a.k, a.v,
                                            a.dout, a.dq)))
    return (int)cudaErrorInvalidValue;
  const int rc = prepare(a, device);
  if (rc) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 2)
    return d <= 64 ? launch_dq_wgmma<64>(a, s) : launch_dq_wgmma<128>(a, s);
  return d <= 64 ? launch_dq<64>(a, route, s) : launch_dq<128>(a, route, s);
}

// K7: dk and dv (sk rows); arguments and routes as K6's.  Returns the
// cudaGetLastError() code of the launch, or 1000 + the CUresult when a TMA
// tensor map cannot be encoded.
extern "C" int da_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* dd, void* dk, void* dv,
                                const long long* meta, int sq, int sk, int d,
                                int hall, long long qoff, long long koff,
                                int causal, float scale, int route,
                                int out_f32, int device, void* stream) {
  if (sk <= 0 || hall <= 0) return 0;
  BwdArgs a = make_args(q, k, v, dout, lse, dd, nullptr, dk, dv, meta, sq, sk,
                        d, hall, qoff, koff, causal, scale, out_f32);
  if (route < 0 || route > 2 ||
      (route == 2 && !da_sm90::views_tma_ok(a.hall, d, a.q.nh, a.q, a.k, a.v,
                                            a.dout, a.dk, a.dv)))
    return (int)cudaErrorInvalidValue;
  const int rc = prepare(a, device);
  if (rc) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 2)
    return d <= 64 ? launch_dkv_wgmma<64>(a, s) : launch_dkv_wgmma<128>(a, s);
  return d <= 64 ? launch_dkv<64>(a, route, s) : launch_dkv<128>(a, route, s);
}
