// The online-softmax loop of the bf16 attention kernels on wgmma + TMA
// (attention.cu): flash attention (K5, `da_flash_attention`), one ring hop
// (K8, `da_flash_hop`) and the fused ring-attention step (K9,
// `da_ring_attn_step`), in the two numerics of attn_tile.cuh, chosen by the
// FLASH template flag:
// - FLASH (K5 and K8; pallas_attention.py `_kernel` and `_carry_kernel`):
//   s = (q.k) * scale in f32 (the scale after the product), masked, p =
//   exp(s - m_safe) in f32; l sums the unrounded p; p is rounded to bf16
//   once, and acc = acc * alpha + round(p) V is one register-A wgmma pass
//   accumulating into acc, which stays in registers from the first key
//   tile to the last.  K5 starts afresh (init) and at the end writes o =
//   acc / l in bf16 and lse = m + log l into (H_all, S) f32 (finalize); K8
//   reads the carry (m, l, acc) at the start and writes it back at the end,
//   as RING does.
// - RING (K9; ring_attention.py `_rdma_attn_call`): q scaled in bf16 (q *
//   bf16(scale) rounded once), f32 products and softmax, p not rounded: p is
//   split into three bf16 terms (p, what rounding p leaves, what rounding
//   that leaves: each difference exact) and P V is three register-A wgmma
//   passes, summed afresh per tile and folded in as acc * alpha + P V in
//   f32, so every product is exact and P V matches f32 products to within
//   2^-24 of p.  The carry (m, l, acc) is read once at the start and written
//   once at the end (or o, at the last step).
//
// A block owns NWG * 64 query rows of one head: NWG consumer warpgroups of
// 64 rows each and one producer warp.  The producer loads the block's q rows
// once and then streams 64-key K and V tiles through a ring of stages that
// the warpgroups share, all by TMA with one full/empty mbarrier pair per
// stage.  Every operand is a (rows, heads, dh) view with the head dim
// contiguous (head n is (n / nh, n % nh), as attn_tile.cuh's View): the
// (S, H, D) and (S, B, H, D) views of K5, K9's (b, h, dh) blocks.  Each is
// mapped as a TMA tensor from its own strides (view_map) and a tile is the
// box of 64 rows of 64 head-dim values, 128 bytes, which is the 128-byte
// swizzle's row (dh = 128 is two boxes; a dh below a multiple of 64 reads
// zeros past its end, which add nothing to the products).  Rows past the
// end read as zeros too, so the loop masks keys past `sk` itself.
//
// Per key tile: S = Q K^T is wgmma with Q and K both K-major from shared
// memory (K needs no transpose); the mask (only on a tile that holds a
// masked pair), the running max and p stay in the f32 accumulator registers
// (exp as ex2.approx of s log2 e - m log2 e, one FMA and the SFU's 2^x,
// within a few f32 ulps, far below the bf16 output's resolution).  The
// accumulator layout of the S product is the A-fragment layout of the next
// k16 chunk, so p needs no shuffle; V is read MN-major (the transpose bit).
// Rows with no visible key keep the TPU kernels' isfinite guards: m_safe =
// 0 where m is -inf, p = 0 where s is -inf, alpha = 0 where the old m is
// -inf.  A causal block stops each warpgroup at its last visible key tile:
// every tile after it is masked for all of its 64 rows, and skipping it
// leaves m, l and acc bit for bit as they were (a warpgroup that is done
// before the block's last tile still waits for and releases each stage, so
// the stages' phases stay in step).  A block with no visible key tile at
// all (a hop whose keys all lie after its queries) loads nothing and
// writes the carry back exactly as it read it.

#pragma once

#include <math.h>

#include "sm90.cuh"

namespace da_sm90 {

constexpr int AW_ROWS = 64;  // query rows of a consumer warpgroup
constexpr int AW_BK = 64;    // keys of a tile
constexpr float LOG2E = 1.4426950408889634f;

template <int DMAX>
__host__ __device__ constexpr int aw_stages() {
  return DMAX > 64 ? 2 : 3;
}
// bytes of one 64-row tile (DMAX / 64 boxes of 8 KB)
template <int DMAX>
__host__ __device__ constexpr int aw_tile_bytes() {
  return AW_BK * DMAX * 2;
}
// dynamic shared memory of attend_wgmma (with 1 KB of alignment slack)
template <int DMAX, int NWG>
__host__ __device__ constexpr size_t aw_smem_bytes() {
  return (size_t)(NWG + 2 * aw_stages<DMAX>()) * aw_tile_bytes<DMAX>() + 1024;
}

struct AttnArgs {
  float* m;             // the carry (CARRY): m and l (h, b) and acc
  float* l;             //   (h, b, dh) f32, read unless init and
  float* acc;           //   written unless finalize
  __nv_bfloat16* o;     // written when finalize, through its view:
  int64_t oss, osb, osh;  //   row, outer-head and inner-head strides
  float* lse;           // FLASH: (h, b) f32, or null
  int b, h, dh, nh;     // query rows, heads, head dim, inner head count
  int sk;               // keys to visit (0: only start/finish the carry)
  int64_t qoff, koff;   // global positions of query row 0 and key row 0
  int causal, init, finalize;
  float scale;
  uint32_t qpos, kpos, vpos;  // view_map roles of the q, k and v maps
};

__device__ __forceinline__ bool aw_finite(float x) { return fabsf(x) < INFINITY; }
// 2^x on the SFU
__device__ __forceinline__ float aw_ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// two floats rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t aw_pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// roles of a view map's dims 1..3 (dim 0 is the head dim)
constexpr uint32_t ROLE_ROW = 1, ROLE_HI = 2, ROLE_HO = 3;

// Create the TMA map of a (rows, heads, dh) bf16 view (strides ss, sb, sh
// in elements, inner head count nh) and its `pos`: the role of each of the
// map's dims 1..3, 2 bits each, 0 past its rank.  The row dim and each head
// dim of extent above 1 become dims of the map in the order of their
// strides, so the map's strides rise as a packed tensor's do; a tile is the
// box (64 head-dim values, 64 rows, one head).  Returns 0 or an error code.
inline int view_map(CUtensorMap* map, uint32_t* pos, const void* base,
                    int rows, int heads, int64_t ss, int64_t sb, int64_t sh,
                    int nh, int dh) {
  struct Dim {
    uint64_t n;
    int64_t s;
    uint32_t role;
  } d[3];
  int k = 0;
  d[k++] = {(uint64_t)rows, ss, ROLE_ROW};
  if (nh > 1) d[k++] = {(uint64_t)nh, sh, ROLE_HI};
  if (heads / nh > 1) d[k++] = {(uint64_t)(heads / nh), sb, ROLE_HO};
  for (int i = 1; i < k; ++i)
    for (int j = i; j > 0 && d[j].s < d[j - 1].s; --j) {
      const Dim t = d[j];
      d[j] = d[j - 1];
      d[j - 1] = t;
    }
  uint64_t dims[4] = {(uint64_t)dh}, strides[3];
  uint32_t box[4] = {64};
  *pos = 0;
  for (int i = 0; i < k; ++i) {
    dims[i + 1] = d[i].n;
    strides[i] = (uint64_t)d[i].s * 2;
    box[i + 1] = d[i].role == ROLE_ROW ? AW_BK : 1;
    *pos |= d[i].role << (2 * i);
  }
  return make_map(map, base, k + 1, dims, strides, box);
}

// True when TMA can read the view `v` (any struct with p, ss, sb, sh, nh)
// of a tensor with `heads` heads: inner head count nh, a 16-byte aligned
// base, and a row stride and the head strides of head dims above 1 that are
// positive multiples of 8 elements.
template <typename V>
inline bool view_tma_ok(const V& v, int heads, int nh) {
  const auto ok = [](int64_t s) { return s > 0 && s % 8 == 0; };
  return v.nh == nh && (uintptr_t)v.p % 16 == 0 && ok(v.ss) &&
         (nh <= 1 || ok(v.sh)) && (heads / nh <= 1 || ok(v.sb));
}

// True when the wgmma routes (K5, K6, K7) can take `views`: a head dim
// that is a multiple of 8, and every view as view_tma_ok with inner head
// count nh.  The rule flash_attention_route applies on the host.
template <typename... V>
inline bool views_tma_ok(int heads, int dh, int nh, const V&... views) {
  return dh % 8 == 0 && (view_tma_ok(views, heads, nh) && ...);
}

__device__ __forceinline__ int view_coord(uint32_t role, int row, int hi,
                                          int ho) {
  return role == ROLE_ROW ? row : role == ROLE_HI ? hi : ho;
}

// Load the box at head-dim column `col` and row `row` of head n of a
// view_map map (roles `pos`, inner head count nh).
__device__ __forceinline__ void tma_load_view(void* dst, const CUtensorMap* m,
                                              uint64_t* bar, uint32_t pos,
                                              int col, int row, int n,
                                              int nh) {
  const int hi = n % nh, ho = n / nh;
  const uint32_t r1 = pos & 3, r2 = (pos >> 2) & 3, r3 = (pos >> 4) & 3;
  const int c1 = view_coord(r1, row, hi, ho);
  if (r3)
    tma_load_4d(dst, m, bar, col, c1, view_coord(r2, row, hi, ho),
                view_coord(r3, row, hi, ho));
  else if (r2)
    tma_load_3d(dst, m, bar, col, c1, view_coord(r2, row, hi, ho));
  else
    tma_load_2d(dst, m, bar, col, c1);
}

// Query tile qt (NWG * 64 rows) of head n.  Run by all 128 NWG + 32
// threads; the producer warp returns early.  CARRY: the block may read the
// carry (m, l, acc) unless a.init and write it back unless a.finalize (K8,
// K9); without it the block starts afresh and finalizes (K5), with no
// carry code compiled in.
template <int DMAX, bool FLASH, int NWG, bool CARRY>
__device__ __forceinline__ void attend_wgmma(const CUtensorMap* tq,
                                             const CUtensorMap* tk,
                                             const CUtensorMap* tv,
                                             const AttnArgs& a, int n, int qt,
                                             uint8_t* smem_raw) {
  using bf = __nv_bfloat16;
  constexpr int ST = aw_stages<DMAX>();
  constexpr int TILE = aw_tile_bytes<DMAX>();
  constexpr int KC = DMAX / 16;  // 16-deep slices of the head dim
  constexpr int ND = DMAX / 8;   // 8-wide output column tiles
  __shared__ __align__(8) uint64_t full[ST], empty[ST], qbar;
  uint8_t* smem = align1024(smem_raw);
  uint8_t* KV = smem + NWG * TILE;  // stage s: K at KV + 2 s TILE, V after it
  const int q0 = qt * NWG * AW_ROWS;
  // the key tiles the 64 rows from r0 need: a causal tile wholly after the
  // last of them (and every later one) is masked for all of them
  auto tiles_of = [&](int r0) {
    int64_t kend = a.sk;
    if (a.causal) {
      const int64_t last = a.qoff + r0 + AW_ROWS - a.koff;  // keys before it
      kend = last < 0 ? 0 : (last < kend ? last : kend);
    }
    return (int)((kend + AW_BK - 1) / AW_BK);
  };
  const int ntiles = tiles_of(q0 + (NWG - 1) * AW_ROWS);  // the most
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * NWG);
    }
    mbar_init(&qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * NWG) {  // the producer warp
    if (lane == 0 && ntiles > 0) {
      mbar_expect_tx(&qbar, NWG * TILE);
#pragma unroll
      for (int w = 0; w < NWG; ++w)
#pragma unroll
        for (int j = 0; j < DMAX / 64; ++j)
          tma_load_view(smem + w * TILE + j * 8192, tq, &qbar, a.qpos, 64 * j,
                        q0 + w * AW_ROWS, n, a.nh);
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % ST;
        if (it >= ST) mbar_wait(&empty[s], ((it / ST) + 1) & 1);
        uint8_t* ks = KV + 2 * s * TILE;
        mbar_expect_tx(&full[s], 2 * TILE);
#pragma unroll
        for (int j = 0; j < DMAX / 64; ++j) {
          tma_load_view(ks + j * 8192, tk, &full[s], a.kpos, 64 * j,
                        it * AW_BK, n, a.nh);
          tma_load_view(ks + TILE + j * 8192, tv, &full[s], a.vpos, 64 * j,
                        it * AW_BK, n, a.nh);
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128, wq = warp % 4;  // warpgroup, its warp
  const int g = lane / 4, t = lane % 4;
  const int r0 = q0 + wg * AW_ROWS;
  uint8_t* Qs = smem + wg * TILE;
  const int mine = tiles_of(r0);
  if (mine > 0) {
    mbar_wait(&qbar, 0);
    if (!FLASH) {
      // q * bf16(scale), rounded to bf16, in place (the swizzle does not
      // matter to an elementwise scale); then hand the tile to wgmma
      const float sc = __bfloat162float(__float2bfloat16_rn(a.scale));
      __nv_bfloat162* q2 = reinterpret_cast<__nv_bfloat162*>(Qs);
      for (int i = threadIdx.x % 128; i < TILE / 4; i += 128) {
        const float2 x = __bfloat1622float2(q2[i]);
        q2[i] = __floats2bfloat162_rn(x.x * sc, x.y * sc);
      }
      fence_proxy_async();
      named_sync(1 + wg, 128);
    }
  }

  // rows g and g + 8 of this warp's 16; columns 8 j + 2 t + {0, 1}
  int row[2];
  float m_i[2], l_i[2], o[DMAX / 2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = r0 + wq * 16 + g + 8 * h;
    const int64_t crow = (int64_t)n * a.b + row[h];
    const bool load = CARRY && !a.init && row[h] < a.b;
    m_i[h] = load ? a.m[crow] : -INFINITY;
    l_i[h] = load ? a.l[crow] : 0.f;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int dd = 8 * j + 2 * t;  // dh is a multiple of 8
      const float2 c = load && dd < a.dh
          ? *reinterpret_cast<const float2*>(a.acc + crow * a.dh + dd)
          : make_float2(0.f, 0.f);
      o[4 * j + 2 * h] = c.x;
      o[4 * j + 2 * h + 1] = c.y;
    }
  }

  for (int it = 0; it < ntiles; ++it) {
    const int s = it % ST;
    mbar_wait(&full[s], (it / ST) & 1);
    if (it >= mine) {  // masked for all of this warpgroup's rows
      mbar_arrive(&empty[s]);
      continue;
    }
    const uint8_t* ks = KV + 2 * s * TILE;
    const uint8_t* vs = ks + TILE;
    const int k0 = it * AW_BK;

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

    if (FLASH) {
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] *= a.scale;
    }
    // only a tile that reaches past the warpgroup's first query row or past
    // the last key can hold a masked pair
    const bool edge = k0 + AW_BK > a.sk ||
                      (a.causal && a.koff + k0 + AW_BK - 1 > a.qoff + r0);
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
    float alpha[2], ml[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_i[h], mx[h]);
      const float m_safe = aw_finite(m_new) ? m_new : 0.f;
      ml[h] = m_safe * LOG2E;
      alpha[h] = aw_finite(m_i[h]) ? aw_ex2((m_i[h] - m_safe) * LOG2E) : 0.f;
      m_i[h] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      const float p = aw_finite(sc[i]) ? aw_ex2(fmaf(sc[i], LOG2E, -ml[h])) : 0.f;
      psum[h] += p;
      sc[i] = p;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], 1);
      psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], 2);
      l_i[h] = l_i[h] * alpha[h] + psum[h];
    }

    // P as bf16 terms, each the A fragments of the 4 16-key chunks: a pair
    // rounds to bf16 in one conversion, and the two rounded values come back
    // out of its halves exactly (FLASH keeps only the first term)
    constexpr int TERMS = FLASH ? 1 : 3;
    uint32_t pa[TERMS][4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float x0 = sc[4 * (2 * c + u) + 2 * hh];
          float x1 = sc[4 * (2 * c + u) + 2 * hh + 1];
#pragma unroll
          for (int term = 0; term < TERMS; ++term) {
            const uint32_t pk = aw_pack(x0, x1);
            pa[term][c][2 * u + hh] = pk;
            x0 -= __uint_as_float(pk << 16);
            x1 -= __uint_as_float(pk & 0xffff0000u);
          }
        }
    if (FLASH) {
      // acc = acc * alpha + round(P) V, the product accumulated into acc
#pragma unroll
      for (int i = 0; i < DMAX / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < 4; ++c)
        wgmma_rs<DMAX, 1>(o, pa[0][c], sw128_desc(vs + c * 2048, 8192, 1024),
                          1);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(o);
      mbar_arrive(&empty[s]);  // this stage's K and V are read
    } else {
      float pv[DMAX / 2];
#pragma unroll
      for (int i = 0; i < DMAX / 2; ++i) pv[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int term = 0; term < TERMS; ++term)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          wgmma_rs<DMAX, 1>(pv, pa[term][c],
                            sw128_desc(vs + c * 2048, 8192, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(pv);
      mbar_arrive(&empty[s]);  // this stage's K and V are read
#pragma unroll
      for (int i = 0; i < DMAX / 2; ++i) o[i] = o[i] * alpha[(i >> 1) & 1] + pv[i];
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= a.b) continue;
    const int64_t crow = (int64_t)n * a.b + row[h];
    if (a.finalize) {
      const float ln = l_i[h] == 0.f ? 1.f : l_i[h];
      bf* out = a.o + (int64_t)(n / a.nh) * a.osb + (int64_t)(n % a.nh) * a.osh +
                (int64_t)row[h] * a.oss;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const int dd = 8 * j + 2 * t;  // dh is a multiple of 8
        if (dd < a.dh)
          *reinterpret_cast<__nv_bfloat162*>(out + dd) = __floats2bfloat162_rn(
              o[4 * j + 2 * h] / ln, o[4 * j + 2 * h + 1] / ln);
      }
      if (FLASH && a.lse && t == 0)
        a.lse[crow] = (aw_finite(m_i[h]) ? m_i[h] : 0.f) + logf(ln);
    } else if (CARRY) {
      if (t == 0) {
        a.m[crow] = m_i[h];
        a.l[crow] = l_i[h];
      }
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const int dd = 8 * j + 2 * t;
        if (dd < a.dh)
          *reinterpret_cast<float2*>(a.acc + crow * a.dh + dd) =
              make_float2(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
      }
    }
  }
}

}  // namespace da_sm90
