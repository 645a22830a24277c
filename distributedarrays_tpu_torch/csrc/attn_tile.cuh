// The online-softmax tile loops shared by the three attention kernels of
// attention.cu: flash attention (K5), one ring-attention hop with carried
// state (K8) and one step of the fused ring attention (K9).
//
// A block owns BQ = 64 query rows of one head, loops over the key/value
// rows in shared-memory tiles, and keeps the running max m, normaliser l
// and accumulator acc of its rows in registers (read from and written to
// device memory when a hop or ring step carries them).  The Pallas
// kernels carry the same state across a sequential K grid axis in VMEM
// scratch; Hopper blocks run in no order, so the loop over K lives inside
// the block.  Two loops:
// - `attend`, f32 operands on the f32 FMA pipes (SIMT): four threads per
//   query row, each holding the row's m and l and every fourth column of
//   acc; shared rows padded by one float so a warp's quads hit distinct
//   banks.
// - `attend_mma`, bf16 operands on the tensor cores (mma.sync), below.
//
// Operands are addressed through strides, so a kernel reads (S, H, D),
// (S, B, H, D) views of a fused QKV product or (H, B, D) blocks alike
// without a transpose copy: head n of H_all = nb * nh is (n / nh, n % nh)
// and its row s sits at base + s*ss + (n/nh)*sb + (n%nh)*sh; the last dim
// is contiguous.
//
// Two numerics, chosen by the RING template flag:
// - FLASH (RING = false, K5/K8; pallas_attention.py:_kernel and
//   _carry_kernel): both products take the input type with f32 sums, the
//   scale is applied after the QK product and p is rounded to the input
//   type before the PV product.
// - RING (RING = true, K9; ring_attention.py:_rdma_attn_call): q is
//   scaled in the input type and then converted to f32, K/V are converted
//   to f32, both products and the softmax are f32 and p is not rounded.
// Both skip a causal key tile wholly after the block's last query row.
// Both guard fully masked rows as the TPU kernels do: m_safe = 0 where m
// is -inf, p = 0 where s is -inf, alpha = 0 where the old m is -inf.
//
// Bound on an H100: attention at D = 64 does 4*D operations per (query,
// key) pair against 2*D*2 bytes of K/V per key row, so it is
// operations-bound (989 TFLOP/s bf16 tensor cores, 67 TFLOP/s f32).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace da_attn {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 32;       // key rows per shared-memory tile
constexpr int TPR = 4;       // threads per query row
constexpr int THREADS = BQ * TPR;  // 256
constexpr int KPT = BK / TPR;      // scores per thread per tile (8)

// false for +-inf and NaN
__device__ __forceinline__ bool finite(float x) { return fabsf(x) < INFINITY; }
// x rounded to bf16 and back
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// One operand: base pointer and strides (elements) of a (rows, heads, D)
// view whose head index n splits as (n / nh, n % nh).
template <typename P>
struct View {
  P* p;
  int64_t ss, sb, sh;
  int nh;
  __device__ __forceinline__ int64_t head(int n) const {
    return (int64_t)(n / nh) * sb + (int64_t)(n % nh) * sh;
  }
};

struct Args {
  View<const void> q, k, v;
  View<void> o;     // written when finalize (may be null otherwise)
  float* lse;       // (H_all, Sq) f32, written when finalize, may be null
  float* m;         // carry (H_all, Sq) f32; read unless init, written
  float* l;         //   unless finalize; null when init and finalize
  float* acc;       // carry (H_all, Sq, D) f32
  int sq, sk, d;    // query rows, key rows, head dim
  int hall;         // heads
  int64_t qoff, koff;  // global positions of query row 0 and key row 0
  int causal, init, finalize;
  float scale;
};

// Dynamic shared memory for head dim d, in bytes.
inline size_t smem_bytes(int d) {
  return sizeof(float) *
         ((size_t)BQ * (d + 1) + (size_t)BK * (d + 1) + (size_t)BK * d +
          (size_t)BQ * (BK + 1));
}

// The f32 tile loop for query tile qt of head n.  DMAX bounds the head
// dim (acc holds DMAX / TPR columns per thread).
template <bool RING, int DMAX>
__device__ void attend(const Args& a, int n, int qt, float* smem) {
  const int D = a.d;
  const int tid = threadIdx.x;
  const int r = tid / TPR;       // query row in the tile
  const int j = tid % TPR;       // the thread's quarter of the row
  float* Qs = smem;                          // [BQ][D+1]
  float* Ks = Qs + BQ * (D + 1);             // [BK][D+1]
  float* Vs = Ks + BK * (D + 1);             // [BK][D]
  float* Ps = Vs + BK * D;                   // [BQ][BK+1]

  const float* q = static_cast<const float*>(a.q.p) + a.q.head(n);
  const float* k = static_cast<const float*>(a.k.p) + a.k.head(n);
  const float* v = static_cast<const float*>(a.v.p) + a.v.head(n);
  const int q0 = qt * BQ;
  const int row = q0 + r;
  const bool row_ok = row < a.sq;

  // query tile: FLASH keeps the input values, RING scales them first
  for (int i = tid; i < BQ * D; i += THREADS) {
    const int rr = i / D, dd = i % D;
    float x = 0.f;
    if (q0 + rr < a.sq) {
      x = q[(int64_t)(q0 + rr) * a.q.ss + dd];
      if (RING) x *= a.scale;
    }
    Qs[rr * (D + 1) + dd] = x;
  }

  constexpr int NA = DMAX / TPR;
  float m_i, l_i, acc[NA];
  const int64_t crow = (int64_t)n * a.sq + row;
  if (a.init || !row_ok) {
    m_i = -INFINITY;
    l_i = 0.f;
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] = 0.f;
  } else {
    m_i = a.m[crow];
    l_i = a.l[crow];
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int dd = j + TPR * i;
      acc[i] = dd < D ? a.acc[crow * D + dd] : 0.f;
    }
  }

  const int64_t qpos = a.qoff + row;
  for (int k0 = 0; k0 < a.sk; k0 += BK) {
    // a causal tile wholly after the block's last row is skipped, and so
    // is every later one (exact: it is masked for every row)
    if (a.causal && a.koff + k0 > a.qoff + q0 + BQ - 1) break;
    __syncthreads();  // the previous tile's Ks/Vs/Ps are consumed
    for (int i = tid; i < BK * D; i += THREADS) {
      const int kk = i / D, dd = i % D;
      float kx = 0.f, vx = 0.f;
      if (k0 + kk < a.sk) {
        kx = k[(int64_t)(k0 + kk) * a.k.ss + dd];
        vx = v[(int64_t)(k0 + kk) * a.v.ss + dd];
      }
      Ks[kk * (D + 1) + dd] = kx;
      Vs[kk * D + dd] = vx;
    }
    __syncthreads();

    // scores of keys j + TPR*c, c < KPT
    float s[KPT];
#pragma unroll
    for (int c = 0; c < KPT; ++c) s[c] = 0.f;
    const float* qr = Qs + r * (D + 1);
    for (int dd = 0; dd < D; ++dd) {
      const float qd = qr[dd];
#pragma unroll
      for (int c = 0; c < KPT; ++c)
        s[c] = fmaf(qd, Ks[(j + TPR * c) * (D + 1) + dd], s[c]);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < KPT; ++c) {
      const int key = k0 + j + TPR * c;
      if (!RING) s[c] = s[c] * a.scale;
      bool live = key < a.sk;
      if (a.causal) live = live && (a.koff + key <= qpos);
      if (!live) s[c] = -INFINITY;
      mx = fmaxf(mx, s[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_i, mx);
    const float m_safe = finite(m_new) ? m_new : 0.f;
    const float alpha = finite(m_i) ? expf(m_i - m_safe) : 0.f;
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < KPT; ++c) {
      const float p = finite(s[c]) ? expf(s[c] - m_safe) : 0.f;
      psum += p;
      Ps[r * (BK + 1) + j + TPR * c] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l_i = l_i * alpha + psum;
    m_i = m_new;
    __syncthreads();

    float pv[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) pv[i] = 0.f;
    const float* pr = Ps + r * (BK + 1);
    for (int kk = 0; kk < BK; ++kk) {
      const float p = pr[kk];
      const float* vr = Vs + kk * D;
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const int dd = j + TPR * i;
        if (dd < D) pv[i] = fmaf(p, vr[dd], pv[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] = acc[i] * alpha + pv[i];
  }

  if (!row_ok) return;
  if (a.finalize) {
    const float ln = l_i == 0.f ? 1.f : l_i;
    float* o = static_cast<float*>(a.o.p) + a.o.head(n) +
               (int64_t)row * a.o.ss;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int dd = j + TPR * i;
      if (dd < D) o[dd] = acc[i] / ln;
    }
    if (a.lse && j == 0) {
      const float m_fin = finite(m_i) ? m_i : 0.f;
      a.lse[crow] = m_fin + logf(ln);
    }
  } else {
    if (j == 0) {
      a.m[crow] = m_i;
      a.l[crow] = l_i;
    }
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int dd = j + TPR * i;
      if (dd < D) a.acc[crow * D + dd] = acc[i];
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 loop on the tensor cores (K5/K8 and K9 in bf16).
//
// FLASH: f32 sums of exact bf16 products, scale after the QK product, p
// rounded to bf16 before the PV product, the causal skip, with both
// products as mma.sync.m16n8k16
// bf16 -> f32; RING: K9's numerics (see attend_mma).  Each key tile's P V
// is summed afresh and then folded in as acc * alpha + P V in f32, as the
// TPU kernels do: adding small products straight into a large running
// accumulator inside the tensor core loses low bits.  A block of 4 warps
// owns BQ = 64 query rows, 16 per warp; key tiles are MMA_BK = 64 rows.
// Q is staged once and held in registers as A fragments; K and V are
// staged as [key][d] through a two-stage cp.async pipeline (the next
// tile is copied while this one is multiplied).  K is the col-major B
// operand of Q K^T as it stands; V's B fragments for P V come transposed
// out of ldmatrix .trans.  The S
// accumulators of two neighbouring 8-key tiles are exactly the A fragment
// of P for a 16-key chunk, so p never leaves registers.  Each thread holds
// two query rows (g and g + 8 of its warp's 16), reduced over the four
// threads of a quad.  Shared rows are padded by 8 bf16 (16 bytes) so the
// fragment loads of a warp hit 32 distinct banks.  The head dim is padded
// with zeros to a multiple of 16 in shared memory.  No TMA and no wgmma
// yet.
// ---------------------------------------------------------------------------

constexpr int MMA_BK = 64;
constexpr int MMA_THREADS = 128;
constexpr int MMA_PAD = 8;

__host__ __device__ inline int pad16(int d) { return (d + 15) & ~15; }

// Dynamic shared memory of the tensor-core loop for head dim d, in bytes:
// the Q tile and two stages of K and V tiles.
inline size_t mma_smem_bytes(int d) {
  return sizeof(__nv_bfloat16) * (size_t)(BQ + 4 * MMA_BK) *
         (pad16(d) + MMA_PAD);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Term `term` of p split into bf16 terms: p itself, then what rounding p
// to bf16 leaves, then what rounding that leaves (each difference exact)
__device__ __forceinline__ float split_term(float p, int term) {
  for (int i = 0; i < term; ++i) p -= round_bf16(p);
  return p;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Stage rows [row0, row0 + R) of a (rows, D) operand with row stride ss
// into dst[r * ld + c] (c < dp; rows past `rows` and columns past D are
// zero).  When the operand allows 16-byte copies and ASYNC is set they are
// cp.async copies (zero-filled past the edge) that the caller waits for;
// otherwise plain loads and stores.
template <bool ASYNC>
__device__ __forceinline__ void stage(const __nv_bfloat16* __restrict__ src,
                                      int64_t ss, int row0, int rows, int R,
                                      int D, int dp, __nv_bfloat16* dst,
                                      int ld) {
  const bool vec = D % 8 == 0 && ss % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0;
  if (vec) {
    const int cpr = dp / 8;
    for (int i = threadIdx.x; i < R * cpr; i += MMA_THREADS) {
      const int r = i / cpr, c = (i % cpr) * 8;
      const bool in = row0 + r < rows && c < D;
      const __nv_bfloat16* from = in ? src + (int64_t)(row0 + r) * ss + c : src;
      __nv_bfloat16* to = dst + r * ld + c;
      if (ASYNC) {
        const uint32_t sa =
            static_cast<uint32_t>(__cvta_generic_to_shared(to));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     ::"r"(sa), "l"(from), "r"(in ? 16 : 0));
      } else {
        *reinterpret_cast<uint4*>(to) =
            in ? *reinterpret_cast<const uint4*>(from) : make_uint4(0, 0, 0, 0);
      }
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
    for (int i = threadIdx.x; i < R * dp; i += MMA_THREADS) {
      const int r = i / dp, c = i % dp;
      dst[r * ld + c] = row0 + r < rows && c < D
                            ? src[(int64_t)(row0 + r) * ss + c]
                            : zero;
    }
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most `pending` (0 or 1) committed groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending)
    asm volatile("cp.async.wait_group 1;\n" ::);
  else
    asm volatile("cp.async.wait_group 0;\n" ::);
}

// The B fragment of P V for keys [k, k + 16) and head-dim columns
// [c, c + 8) from V staged as [key][d]: ldmatrix with .trans hands thread
// (g, t) V[k + 2t + {0,1}][c + g] and V[k + 8 + 2t + {0,1}][c + g].
__device__ __forceinline__ void ldmatrix_v(const __nv_bfloat16* Vs, int ld,
                                           int k, int c, int lane,
                                           uint32_t& b0, uint32_t& b1) {
  const uint32_t sa = static_cast<uint32_t>(
      __cvta_generic_to_shared(Vs + (k + (lane & 15)) * ld + c));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(b0), "=r"(b1)
      : "r"(sa));
}

// The tile loop for query tile qt of head n on the tensor cores.  RING
// (K9 in bf16) keeps K9's numerics: q is scaled in bf16 while it is
// staged, and p stays f32 for the PV product, which is
// taken as P1 V + P2 V + P3 V with p = P1 + P2 + P3 split into three bf16
// terms (each term holds the next 8 bits of p's 24), so every product is
// exact and the sum matches f32 products to within 2^-24 of p.
template <int DMAX, bool RING>
__device__ void attend_mma(const Args& a, int n, int qt, __nv_bfloat16* sm) {
  using bf = __nv_bfloat16;
  const int D = a.d, dp = pad16(D);
  const int ldq = dp + MMA_PAD;
  bf* Qs = sm;                       // [BQ][ldq]
  // two stages of [K tile][V tile], each [MMA_BK][ldq]
  bf* KV = Qs + BQ * ldq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const bf* q = static_cast<const bf*>(a.q.p) + a.q.head(n);
  const bf* k = static_cast<const bf*>(a.k.p) + a.k.head(n);
  const bf* v = static_cast<const bf*>(a.v.p) + a.v.head(n);
  const int q0 = qt * BQ;

  stage<false>(q, a.q.ss, q0, a.sq, BQ, D, dp, Qs, ldq);
  // the keys to visit: the causal tiles wholly after the block's last
  // query row (and every later one) are skipped
  int64_t kend = a.sk;
  if (a.causal) {
    const int64_t last = a.qoff + q0 + BQ - a.koff;  // keys before it
    kend = last < 0 ? 0 : (last < kend ? last : kend);
  }
  const int ntiles = (int)((kend + MMA_BK - 1) / MMA_BK);
  auto issue = [&](int it) {  // tile `it` into stage it % 2
    bf* Ks = KV + (it % 2) * 2 * MMA_BK * ldq;
    stage<true>(k, a.k.ss, it * MMA_BK, a.sk, MMA_BK, D, dp, Ks, ldq);
    stage<true>(v, a.v.ss, it * MMA_BK, a.sk, MMA_BK, D, dp,
                Ks + MMA_BK * ldq, ldq);
    cp_async_commit();
  };
  if (ntiles > 0) issue(0);
  __syncthreads();
  if (RING) {  // q * scale rounded to bf16, in place
    const float sc_t = round_bf16(a.scale);
    for (int i = threadIdx.x; i < BQ * ldq; i += MMA_THREADS)
      Qs[i] = __float2bfloat16_rn(__bfloat162float(Qs[i]) * sc_t);
    __syncthreads();
  }
  constexpr int KC = DMAX / 16;  // 16-wide chunks of the head dim
  constexpr int ND = DMAX / 8;   // 8-wide output column tiles
  const int kcs = dp / 16, nds = dp / 8;
  uint32_t qa[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    if (kc < kcs) {
      const bf* p = Qs + (warp * 16 + g) * ldq + kc * 16 + 2 * t;
      qa[kc][0] = ld32(p);
      qa[kc][1] = ld32(p + 8 * ldq);
      qa[kc][2] = ld32(p + 8);
      qa[kc][3] = ld32(p + 8 * ldq + 8);
    }
  }

  // rows g and g + 8 of the warp's 16; columns 8*nd + 2t + {0, 1}
  int row[2];
  float m_i[2], l_i[2], o[ND][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = q0 + warp * 16 + g + 8 * h;
    const int64_t crow = (int64_t)n * a.sq + row[h];
    const bool load = !a.init && row[h] < a.sq;
    m_i[h] = load ? a.m[crow] : -INFINITY;
    l_i[h] = load ? a.l[crow] : 0.f;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int dd = nd * 8 + 2 * t + e;
        o[nd][2 * h + e] = load && dd < D ? a.acc[crow * D + dd] : 0.f;
      }
  }

  for (int it = 0; it < ntiles; ++it) {
    // copy the next tile while this one is multiplied
    if (it + 1 < ntiles) issue(it + 1);
    cp_async_wait(it + 1 < ntiles ? 1 : 0);
    __syncthreads();
    const int k0 = it * MMA_BK;
    const bf* Ks = KV + (it % 2) * 2 * MMA_BK * ldq;
    const bf* Vs = Ks + MMA_BK * ldq;

    float s[MMA_BK / 8][4];
#pragma unroll
    for (int j = 0; j < MMA_BK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        if (kc < kcs) {
          const bf* p = Ks + (j * 8 + g) * ldq + kc * 16 + 2 * t;
          mma_bf16(s[j], qa[kc], ld32(p), ld32(p + 8));
        }
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < MMA_BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        bool live = key < a.sk;
        if (a.causal) live = live && (a.koff + key <= a.qoff + row[h]);
        s[j][e] = live ? (RING ? s[j][e] : s[j][e] * a.scale) : -INFINITY;
        mx[h] = fmaxf(mx[h], s[j][e]);
      }
    float alpha[2], m_safe[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_i[h], mx[h]);
      m_safe[h] = finite(m_new) ? m_new : 0.f;
      alpha[h] = finite(m_i[h]) ? expf(m_i[h] - m_safe[h]) : 0.f;
      m_i[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < MMA_BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float p = finite(s[j][e]) ? expf(s[j][e] - m_safe[h]) : 0.f;
        psum[h] += p;
        s[j][e] = p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], 1);
      psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], 2);
      l_i[h] = l_i[h] * alpha[h] + psum[h];
    }
    // acc = acc * alpha + P V, with P V summed afresh for this tile (in
    // halves of the head dim at DMAX 128, to bound the registers).
    // FLASH: p rounded to bf16; RING: p as three bf16 terms.
    constexpr int NH = DMAX > 64 ? 2 : 1;
    constexpr int NDH = ND / NH;
#pragma unroll
    for (int hf = 0; hf < NH; ++hf) {
      float pv[NDH][4];
#pragma unroll
      for (int i = 0; i < NDH; ++i)
        pv[i][0] = pv[i][1] = pv[i][2] = pv[i][3] = 0.f;
#pragma unroll
      for (int term = 0; term < (RING ? 3 : 1); ++term) {
#pragma unroll
        for (int c = 0; c < MMA_BK / 16; ++c) {
          // the A fragment of keys [16c, 16c + 16)
          float x[2][4];
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              x[u][e] = split_term(s[2 * c + u][e], term);
          const uint32_t pa[4] = {pack_bf16(x[0][0], x[0][1]),
                                  pack_bf16(x[0][2], x[0][3]),
                                  pack_bf16(x[1][0], x[1][1]),
                                  pack_bf16(x[1][2], x[1][3])};
#pragma unroll
          for (int i = 0; i < NDH; ++i) {
            const int nd = hf * NDH + i;
            if (nd < nds) {
              uint32_t b0, b1;
              ldmatrix_v(Vs, ldq, c * 16, nd * 8, lane, b0, b1);
              mma_bf16(pv[i], pa, b0, b1);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < NDH; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[hf * NDH + i][e] = o[hf * NDH + i][e] * alpha[e >> 1] + pv[i][e];
    }
    __syncthreads();  // this stage is read; the next issue refills it
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= a.sq) continue;
    const int64_t crow = (int64_t)n * a.sq + row[h];
    if (a.finalize) {
      const float ln = l_i[h] == 0.f ? 1.f : l_i[h];
      bf* out = static_cast<bf*>(a.o.p) + a.o.head(n) +
                (int64_t)row[h] * a.o.ss;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int dd = nd * 8 + 2 * t + e;
          if (dd < D) out[dd] = __float2bfloat16_rn(o[nd][2 * h + e] / ln);
        }
      if (a.lse && t == 0)
        a.lse[crow] = (finite(m_i[h]) ? m_i[h] : 0.f) + logf(ln);
    } else {
      if (t == 0) {
        a.m[crow] = m_i[h];
        a.l[crow] = l_i[h];
      }
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int dd = nd * 8 + 2 * t + e;
          if (dd < D) a.acc[crow * D + dd] = o[nd][2 * h + e];
        }
    }
  }
}

}  // namespace da_attn
