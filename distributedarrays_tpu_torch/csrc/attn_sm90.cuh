// The fused ring-attention step's accumulate loop on wgmma + TMA (K9 in
// bf16, attention.cu `da_ring_attn_step`), in K9's numerics: q scaled in
// bf16 (q * bf16(scale) rounded once), f32 products and softmax, p not
// rounded.
//
// A block owns RA_BQ = 64 query rows of one head: one consumer warpgroup
// and one producer warp.  The producer loads the q tile once and then
// streams 64-key K and V tiles through a ring of stages, all by TMA with
// one full/empty mbarrier pair per stage.  Q, K and V are (rows, heads,
// dh) with a row stride of heads * dh, so each is mapped as a 3-D tensor
// (dh, heads, rows) and a tile is the box (64, 1, 64): 64 rows of 64 head-
// dim values, 128 bytes, which is the 128-byte swizzle's row (dh = 128 is
// two boxes; a dh below a multiple of 64 reads zeros past its end, which
// add nothing to the products).  Rows past the block's end read as zeros
// too, so the loop masks keys past `sk` itself.
//
// Per key tile: S = Q K^T is wgmma with Q and K both K-major from shared
// memory (K needs no transpose); the mask (only on a tile that holds a
// masked pair), the running max and p = exp(s - m) stay in the f32
// accumulator registers (exp as ex2.approx of (s - m) log2 e, within a few
// f32 ulps, far below the bf16 output's resolution); p is split into three
// bf16 terms (p, what rounding p leaves, what rounding that leaves: each
// difference exact), and P V is three register-A wgmma passes over V read
// MN-major (the transpose bit), so every product is exact and P V matches
// f32 products to within 2^-24 of p.  The accumulator layout of the S
// product is the A-fragment layout of the next k16 chunk, so p needs no
// shuffle.  Each tile's P V is summed afresh and folded in as acc * alpha +
// P V in f32, as the TPU kernel does.  The carry (m, l, acc) is read once
// at the start and written once at the end (or o, at the last step).
// Rows with no visible key keep the TPU kernel's isfinite guards: m_safe =
// 0 where m is -inf, p = 0 where s is -inf, alpha = 0 where the old m is
// -inf.  A causal step stops each query tile at its last visible key tile:
// every tile after it is masked for all 64 rows, and skipping it leaves
// m, l and acc bit for bit as they were.

#pragma once

#include <math.h>

#include "sm90.cuh"

namespace da_sm90 {

constexpr int RA_BQ = 64;              // query rows of a block
constexpr int RA_BK = 64;              // keys of a tile
constexpr int RA_THREADS = 128 + 32;   // the consumer warpgroup + producer warp

template <int DMAX>
__host__ __device__ constexpr int ra_stages() {
  return DMAX > 64 ? 2 : 3;
}
// bytes of one 64-row tile of Q, K or V (DMAX / 64 boxes of 8 KB)
template <int DMAX>
__host__ __device__ constexpr int ra_tile_bytes() {
  return RA_BK * DMAX * 2;
}
// dynamic shared memory of ring_attend_wgmma (with 1 KB of alignment slack)
template <int DMAX>
__host__ __device__ constexpr size_t ra_smem_bytes() {
  return (size_t)(1 + 2 * ra_stages<DMAX>()) * ra_tile_bytes<DMAX>() + 1024;
}

struct RingArgs {
  float* m;             // carry (h, b) f32
  float* l;             // carry (h, b) f32
  float* acc;           // carry (h, b, dh) f32
  __nv_bfloat16* o;     // (b, h, dh), written at the last step
  int b, h, dh;         // rows (queries and keys), heads, head dim
  int sk;               // keys to visit: b, or 0 to only start/finish the carry
  int64_t qoff, koff;   // global positions of the q block and the K/V block
  int causal, init, finalize;
  float scale;
};

__device__ __forceinline__ bool ra_finite(float x) { return fabsf(x) < INFINITY; }
__device__ __forceinline__ float ra_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
// two floats rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t ra_pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Create the (dh, h, b) map of one (b, h, dh) bf16 operand; 0 or an error.
inline int ring_map(CUtensorMap* map, const void* base, int b, int h, int dh) {
  const uint64_t dims[3] = {(uint64_t)dh, (uint64_t)h, (uint64_t)b};
  const uint64_t strides[2] = {(uint64_t)dh * 2, (uint64_t)h * dh * 2};
  const uint32_t box[3] = {64, 1, RA_BK};
  return make_map(map, base, 3, dims, strides, box);
}

// Query tile qt of head n against the resident K/V block.  Run by all
// RA_THREADS threads; the producer warp returns early.
template <int DMAX>
__device__ __forceinline__ void ring_attend_wgmma(const CUtensorMap* tq,
                                                  const CUtensorMap* tk,
                                                  const CUtensorMap* tv,
                                                  const RingArgs& a, int n,
                                                  int qt, uint8_t* smem_raw) {
  using bf = __nv_bfloat16;
  constexpr int ST = ra_stages<DMAX>();
  constexpr int TILE = ra_tile_bytes<DMAX>();
  constexpr int KC = DMAX / 16;  // 16-deep slices of the head dim
  constexpr int ND = DMAX / 8;   // 8-wide output column tiles
  __shared__ __align__(8) uint64_t full[ST], empty[ST], qbar;
  uint8_t* smem = align1024(smem_raw);
  uint8_t* Qs = smem;
  uint8_t* KV = smem + TILE;  // stage s: K at KV + 2 s TILE, V after it
  const int q0 = qt * RA_BQ;
  // the keys to visit: a causal tile wholly after the block's last query
  // row (and every later one) is masked for all of its rows
  int64_t kend = a.sk;
  if (a.causal) {
    const int64_t last = a.qoff + q0 + RA_BQ - a.koff;  // keys before it
    kend = last < 0 ? 0 : (last < kend ? last : kend);
  }
  const int ntiles = (int)((kend + RA_BK - 1) / RA_BK);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    mbar_init(&qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {  // the producer warp
    if (lane == 0 && ntiles > 0) {
      mbar_expect_tx(&qbar, TILE);
#pragma unroll
      for (int j = 0; j < DMAX / 64; ++j)
        tma_load_3d(Qs + j * 8192, tq, &qbar, 64 * j, n, q0);
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % ST;
        if (it >= ST) mbar_wait(&empty[s], ((it / ST) + 1) & 1);
        uint8_t* ks = KV + 2 * s * TILE;
        mbar_expect_tx(&full[s], 2 * TILE);
#pragma unroll
        for (int j = 0; j < DMAX / 64; ++j) {
          tma_load_3d(ks + j * 8192, tk, &full[s], 64 * j, n, it * RA_BK);
          tma_load_3d(ks + TILE + j * 8192, tv, &full[s], 64 * j, n,
                      it * RA_BK);
        }
      }
    }
    return;
  }

  const int g = lane / 4, t = lane % 4;
  if (ntiles > 0) {
    // q * bf16(scale), rounded to bf16, in place (the swizzle does not
    // matter to an elementwise scale); then hand the tile to wgmma
    mbar_wait(&qbar, 0);
    const float sc = ra_round(a.scale);
    __nv_bfloat162* q2 = reinterpret_cast<__nv_bfloat162*>(Qs);
    for (int i = threadIdx.x; i < TILE / 4; i += 128) {
      const float2 x = __bfloat1622float2(q2[i]);
      q2[i] = __floats2bfloat162_rn(x.x * sc, x.y * sc);
    }
    fence_proxy_async();
    named_sync(1, 128);
  }

  // rows g and g + 8 of this warp's 16; columns 8 j + 2 t + {0, 1}
  int row[2];
  float m_i[2], l_i[2], o[DMAX / 2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = q0 + warp * 16 + g + 8 * h;
    const int64_t crow = (int64_t)n * a.b + row[h];
    const bool load = !a.init && row[h] < a.b;
    m_i[h] = load ? a.m[crow] : -INFINITY;
    l_i[h] = load ? a.l[crow] : 0.f;
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int dd = 8 * j + 2 * t + e;
        o[4 * j + 2 * h + e] = load && dd < a.dh ? a.acc[crow * a.dh + dd] : 0.f;
      }
  }

  for (int it = 0; it < ntiles; ++it) {
    const int s = it % ST;
    mbar_wait(&full[s], (it / ST) & 1);
    const uint8_t* ks = KV + 2 * s * TILE;
    const uint8_t* vs = ks + TILE;
    const int k0 = it * RA_BK;

    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      const int off = (kc / 4) * 8192 + (kc % 4) * 32;
      wgmma_ss<64, 0>(sc, sw128_desc(Qs + off, 16, 1024),
                      sw128_desc(ks + off, 16, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(sc);

    // only a tile that reaches past the block's first query row or past
    // the last key can hold a masked pair
    const bool edge = k0 + RA_BK > a.sk ||
                      (a.causal && a.koff + k0 + RA_BK - 1 > a.qoff + q0);
    if (edge) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          bool live = key < a.sk;
          if (a.causal) live = live && (a.koff + key <= a.qoff + row[e >> 1]);
          if (!live) sc[4 * j + e] = -INFINITY;
        }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float alpha[2], m_safe[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_i[h], mx[h]);
      m_safe[h] = ra_finite(m_new) ? m_new : 0.f;
      alpha[h] = ra_finite(m_i[h]) ? __expf(m_i[h] - m_safe[h]) : 0.f;
      m_i[h] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      const float p = ra_finite(sc[i]) ? __expf(sc[i] - m_safe[h]) : 0.f;
      psum[h] += p;
      sc[i] = p;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], 1);
      psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], 2);
      l_i[h] = l_i[h] * alpha[h] + psum[h];
    }

    // P as three bf16 terms, each the A fragments of the 4 16-key chunks:
    // a pair rounds to bf16 in one conversion, and the two rounded values
    // come back out of its halves exactly
    uint32_t pa[3][4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float x0 = sc[4 * (2 * c + u) + 2 * hh];
          float x1 = sc[4 * (2 * c + u) + 2 * hh + 1];
#pragma unroll
          for (int term = 0; term < 3; ++term) {
            const uint32_t pk = ra_pack(x0, x1);
            pa[term][c][2 * u + hh] = pk;
            x0 -= __uint_as_float(pk << 16);
            x1 -= __uint_as_float(pk & 0xffff0000u);
          }
        }
    float pv[DMAX / 2];
#pragma unroll
    for (int i = 0; i < DMAX / 2; ++i) pv[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int term = 0; term < 3; ++term)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        wgmma_rs<DMAX, 1>(pv, pa[term][c], sw128_desc(vs + c * 2048, 8192, 1024),
                          1);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(pv);
    mbar_arrive(&empty[s]);  // this stage's K and V are read
#pragma unroll
    for (int i = 0; i < DMAX / 2; ++i) o[i] = o[i] * alpha[(i >> 1) & 1] + pv[i];
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= a.b) continue;
    const int64_t crow = (int64_t)n * a.b + row[h];
    if (a.finalize) {
      const float ln = l_i[h] == 0.f ? 1.f : l_i[h];
      bf* out = a.o + (int64_t)row[h] * a.h * a.dh + (int64_t)n * a.dh;
#pragma unroll
      for (int j = 0; j < ND; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int dd = 8 * j + 2 * t + e;
          if (dd < a.dh) out[dd] = __float2bfloat16_rn(o[4 * j + 2 * h + e] / ln);
        }
    } else {
      if (t == 0) {
        a.m[crow] = m_i[h];
        a.l[crow] = l_i[h];
      }
#pragma unroll
      for (int j = 0; j < ND; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int dd = 8 * j + 2 * t + e;
          if (dd < a.dh) a.acc[crow * a.dh + dd] = o[4 * j + 2 * h + e];
        }
    }
  }
}

}  // namespace da_sm90
