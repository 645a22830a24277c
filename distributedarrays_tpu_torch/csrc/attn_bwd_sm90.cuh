// The FlashAttention-2 backward's bf16 loops on wgmma + TMA (attention_bwd.cu):
// the dq pass (K6, `da_flash_bwd_dq`, `dq_wgmma`) and the dk/dv pass (K7,
// `da_flash_bwd_dkv`, `dkv_wgmma`), in the numerics of the mma.sync and
// SIMT loops beside them: s = q.k as f32 sums of exact bf16 products, p =
// exp(s * scale - lse) (0 where masked), ds = p * (dp - dd) * scale with
// dp = do.v, and dq = round(ds) k, dv = round(p)^T do, dk = round(ds)^T q,
// p and ds rounded to bf16 once.  The operands are the strided views of
// attn_sm90.cuh's view_map, and the products take the forms of its loop:
// a score product (S = Q K^T, dP = dO V^T, or their transposes) is wgmma
// with both operands K-major from shared memory, the head dim contiguous;
// p and ds stay in the f32 accumulator registers (exp as ex2.approx of s
// (scale log2 e) - lse log2 e: one FMA and the SFU's 2^x); and a product
// of p or ds is a register-A wgmma, the score accumulators being the A
// fragments, against the 128-byte-swizzled tile that fed the score product
// read MN-major (the transpose bit).  The mask is applied only on edge
// tiles (a ragged end, or a tile that reaches past the causal diagonal of
// the block's first row), in global positions qoff/koff.  The outputs stay
// in registers to the end and are stored once through their views, in
// bf16 or f32 (out_f32: the ring hop's contributions).
//
// - `dq_wgmma` (K6): a block owns 64 queries of one head: one consumer
//   warpgroup and one producer warp.  The producer loads the block's Q and
//   dO tiles once, then streams 64-key K and V tiles through a ring of
//   stages, by TMA with one full/empty mbarrier pair per stage.  Per key
//   tile the warpgroup runs S = Q K^T and dP = dO V^T, then P and dS = P
//   (dP - dd) scale with each thread's rows' lse and dd held in registers
//   for the whole block (the accumulator's row is the query), and dQ +=
//   round(dS) K.  A causal block stops at its last visible key tile, and a
//   block that sees no key (a fully masked ring hop) stores zeros.  One
//   warpgroup a block, three blocks an SM at DMAX 64 (128 registers, no
//   spills), read 0.1687 / 0.1654 ms of device time at (2048, 64, 64) bf16
//   causal against 0.1966 / 0.1927 at two blocks an SM (142 registers),
//   0.2008 / 0.1993 for two warpgroups sharing each K/V stage at one block
//   an SM, and 0.2992 / 0.2995 at two (96 registers, 468 bytes of
//   spills), in turns in one call (H100 80GB HBM3, 700 W, chip_smoke.py's
//   time_ms and device_ms on a build whose C entry took the layout).
// - `dkv_wgmma` (K7): a block owns 64 keys of one head: one consumer
//   warpgroup and one producer warp.  The producer loads the block's K and
//   V rows once, then streams 64-query Q and dO tiles through a ring of
//   stages; its 32 lanes also copy each tile's 64 lse values (times log2 e)
//   and 64 dd values into the stage with plain loads, and each lane's
//   arrival on the full barrier publishes its own copies.  Per query tile
//   it runs S^T = K Q^T and dP^T = V dO^T, P^T and dS^T with lse and dd
//   indexed by the accumulator's column (the query), then dV += round(P^T)
//   dO and dK += round(dS^T) Q.  The block starts at its first visible
//   query tile.  Two consumer warpgroups a block (128 keys sharing each
//   Q/dO stage) read 0.272 ms at (2048, 64, 64) bf16 causal against 0.270
//   ms for one, in turns in one call (H100 80GB HBM3, 700 W, chip_smoke.py
//   --time-attn), so a block keeps one, two blocks an SM.

#pragma once

#include "attn_sm90.cuh"

namespace da_sm90 {

constexpr int BW_KEYS = 64;  // keys of a block
constexpr int BW_BQ = 64;    // queries of a streamed tile
constexpr int BW_THREADS = 128 + 32;  // the consumer warpgroup + producer warp

template <int DMAX>
__host__ __device__ constexpr int bw_stages() {
  return DMAX > 64 ? 2 : 3;
}
// dynamic shared memory of dkv_wgmma: the K and V tiles, the stages' Q and
// dO tiles, the stages' lse and dd values, and 1 KB of alignment slack
template <int DMAX>
__host__ __device__ constexpr size_t bw_smem_bytes() {
  return (size_t)(2 + 2 * bw_stages<DMAX>()) * aw_tile_bytes<DMAX>() +
         (size_t)bw_stages<DMAX>() * 2 * BW_BQ * sizeof(float) + 1024;
}

struct DkvArgs {
  const float* lse;     // (h, sq) f32
  const float* dd;      // (h, sq) f32: rowsum(do * o)
  void* dk;             // outputs (sk rows) through their views:
  void* dv;
  int64_t kss, ksb, ksh, vss, vsb, vsh;  //   row, outer and inner head strides
  int sq, sk, h, dh, nh;  // query rows, key rows, heads, head dim, inner heads
  int64_t qoff, koff;   // global positions of query row 0 and key row 0
  int causal, out_f32;
  float scale;
  uint32_t qpos, kpos, vpos, opos;  // view_map roles of the q, k, v, do maps
};

// x and y into elements off and off + 1 of an output, in f32 or bf16
__device__ __forceinline__ void bw_store2(void* base, int64_t off, float x,
                                          float y, int f32) {
  if (f32)
    *reinterpret_cast<float2*>(static_cast<float*>(base) + off) =
        make_float2(x, y);
  else
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(base) +
                                       off) = __floats2bfloat162_rn(x, y);
}

// dynamic shared memory of dq_wgmma: the Q and dO tiles, the stages' K
// and V tiles (as many stages as dkv_wgmma's), and 1 KB of alignment slack
template <int DMAX>
__host__ __device__ constexpr size_t dq_smem_bytes() {
  return (size_t)(2 + 2 * bw_stages<DMAX>()) * aw_tile_bytes<DMAX>() + 1024;
}

struct DqArgs {
  const float* lse;     // (h, sq) f32
  const float* dd;      // (h, sq) f32: rowsum(do * o)
  void* dq;             // output (sq rows) through its view:
  int64_t qss, qsb, qsh;  //   row, outer and inner head strides
  int sq, sk, h, dh, nh;  // query rows, key rows, heads, head dim, inner heads
  int64_t qoff, koff;   // global positions of query row 0 and key row 0
  int causal, out_f32;
  float scale;
  uint32_t qpos, kpos, vpos, opos;  // view_map roles of the q, k, v, do maps
};

// Query tile qt (64 queries) of head n.  Run by all BW_THREADS threads;
// the producer warp returns early.
template <int DMAX>
__device__ __forceinline__ void dq_wgmma(const CUtensorMap* tq,
                                         const CUtensorMap* tk,
                                         const CUtensorMap* tv,
                                         const CUtensorMap* tdo,
                                         const DqArgs& a, int n, int qt,
                                         uint8_t* smem_raw) {
  constexpr int ST = bw_stages<DMAX>();
  constexpr int TILE = aw_tile_bytes<DMAX>();
  constexpr int KC = DMAX / 16;  // 16-deep slices of the head dim
  constexpr int ND = DMAX / 8;   // 8-wide output column tiles
  __shared__ __align__(8) uint64_t full[ST], empty[ST], qbar;
  uint8_t* smem = align1024(smem_raw);
  // the Q tile at smem, the dO tile after it; stage s: K at KV + 2 s TILE,
  // V after it
  uint8_t* KV = smem + 2 * TILE;
  const int q0 = qt * AW_ROWS;
  // the key tiles the block's rows need: a causal tile wholly after the
  // last of them (and every later one) is masked for all of them
  int64_t kend = a.sk;
  if (a.causal) {
    const int64_t last = a.qoff + q0 + AW_ROWS - a.koff;  // keys before it
    kend = last < 0 ? 0 : (last < kend ? last : kend);
  }
  const int ntiles = (int)((kend + AW_BK - 1) / AW_BK);
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
      mbar_expect_tx(&qbar, 2 * TILE);
#pragma unroll
      for (int j = 0; j < DMAX / 64; ++j) {
        tma_load_view(smem + j * 8192, tq, &qbar, a.qpos, 64 * j, q0, n,
                      a.nh);
        tma_load_view(smem + TILE + j * 8192, tdo, &qbar, a.opos, 64 * j, q0,
                      n, a.nh);
      }
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

  const int g = lane / 4, t = lane % 4;
  const uint8_t* Qs = smem;
  const uint8_t* Os = smem + TILE;
  if (ntiles > 0) mbar_wait(&qbar, 0);
  // rows g and g + 8 of this warp's 16, with their lse (times log2 e) and
  // dd; the accumulators' columns 8 j + 2 t + {0, 1} are keys of the tile
  // (S, dP) or head-dim columns (dQ)
  int row[2];
  float lse2[2], ddr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = q0 + warp * 16 + g + 8 * h;
    const bool in = row[h] < a.sq;
    const int64_t c = (int64_t)n * a.sq + row[h];
    lse2[h] = in ? a.lse[c] * LOG2E : 0.f;
    ddr[h] = in ? a.dd[c] : 0.f;
  }
  const float sl = a.scale * LOG2E;
  float dq[DMAX / 2];
#pragma unroll
  for (int i = 0; i < DMAX / 2; ++i) dq[i] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int s = it % ST;
    mbar_wait(&full[s], (it / ST) & 1);
    const uint8_t* ks = KV + 2 * s * TILE;
    const uint8_t* vs = ks + TILE;
    const int k0 = it * AW_BK;

    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      const int off = (kc / 4) * 8192 + (kc % 4) * 32;
      wgmma_ss<64, 0>(sc, sw128_desc(Qs + off, 16, 1024),
                      sw128_desc(ks + off, 16, 1024), 1);
    }
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      const int off = (kc / 4) * 8192 + (kc % 4) * 32;
      wgmma_ss<64, 0>(dp, sw128_desc(Os + off, 16, 1024),
                      sw128_desc(vs + off, 16, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(sc);
    reg_fence(dp);

    // only a tile that reaches past the block's first query row or past
    // the last key can hold a masked pair
    const bool edge = k0 + AW_BK > a.sk ||
                      (a.causal && a.koff + k0 + AW_BK - 1 > a.qoff + q0);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float p = aw_ex2(fmaf(sc[4 * j + e], sl, -lse2[h]));
        if (edge) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          bool live = key < a.sk;
          if (a.causal) live = live && (a.koff + key <= a.qoff + row[h]);
          if (!live) p = 0.f;
        }
        dp[4 * j + e] = p * (dp[4 * j + e] - ddr[h]) * a.scale;  // dS
      }
    // dS rounded to bf16 as the A fragments of the 4 16-key chunks
    uint32_t da[4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int x = 4 * (2 * c + u) + 2 * hh;
          da[c][2 * u + hh] = aw_pack(dp[x], dp[x + 1]);
        }
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < 4; ++c)
      wgmma_rs<DMAX, 1>(dq, da[c], sw128_desc(ks + c * 2048, 8192, 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dq);
    mbar_arrive(&empty[s]);  // this stage's K and V are read
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= a.sq) continue;
    const int64_t base = (int64_t)(n / a.nh) * a.qsb +
                         (int64_t)(n % a.nh) * a.qsh + (int64_t)row[h] * a.qss;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int dd = 8 * j + 2 * t;  // dh is a multiple of 8
      if (dd < a.dh)
        bw_store2(a.dq, base + dd, dq[4 * j + 2 * h], dq[4 * j + 2 * h + 1],
                  a.out_f32);
    }
  }
}

// Key tile kt (64 keys) of head n.  Run by all BW_THREADS threads; the
// producer warp returns early.
template <int DMAX>
__device__ __forceinline__ void dkv_wgmma(const CUtensorMap* tq,
                                          const CUtensorMap* tk,
                                          const CUtensorMap* tv,
                                          const CUtensorMap* tdo,
                                          const DkvArgs& a, int n, int kt,
                                          uint8_t* smem_raw) {
  constexpr int ST = bw_stages<DMAX>();
  constexpr int TILE = aw_tile_bytes<DMAX>();
  constexpr int KC = DMAX / 16;  // 16-deep slices of the head dim
  constexpr int ND = DMAX / 8;   // 8-wide output column tiles
  __shared__ __align__(8) uint64_t full[ST], empty[ST], kvbar;
  uint8_t* smem = align1024(smem_raw);
  // the K tile at smem, the V tile after it; stage s: Q at QO + 2 s TILE,
  // dO after it, lse (times log2 e) at LD + 2 s BW_BQ, dd after it
  const uint8_t* Ks = smem;
  const uint8_t* Vs = smem + TILE;
  uint8_t* QO = smem + 2 * TILE;
  float* LD = reinterpret_cast<float*>(QO + 2 * ST * TILE);
  const int k0 = kt * BW_KEYS;
  const int nq = (a.sq + BW_BQ - 1) / BW_BQ;
  int it0 = 0;  // the first query tile that can see one of the keys
  if (a.causal) {
    const int64_t f = a.koff + k0 - a.qoff;
    it0 = (int)((f < 0 ? 0 : (f < a.sq ? f : a.sq)) / BW_BQ);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 128);
    }
    mbar_init(&kvbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {  // the producer warp
    if (it0 >= nq) return;
    if (lane == 0) {
      mbar_expect_tx(&kvbar, 2 * TILE);
#pragma unroll
      for (int j = 0; j < DMAX / 64; ++j) {
        tma_load_view(smem + j * 8192, tk, &kvbar, a.kpos, 64 * j, k0, n,
                      a.nh);
        tma_load_view(smem + TILE + j * 8192, tv, &kvbar, a.vpos, 64 * j, k0,
                      n, a.nh);
      }
    }
    const float* lse = a.lse + (int64_t)n * a.sq;
    const float* dd = a.dd + (int64_t)n * a.sq;
    for (int it = it0; it < nq; ++it) {
      const int i = it - it0, s = i % ST;
      if (i >= ST) mbar_wait(&empty[s], ((i / ST) + 1) & 1);
      float* L = LD + 2 * s * BW_BQ;
      for (int r = lane; r < BW_BQ; r += 32) {
        const int q = it * BW_BQ + r;
        L[r] = q < a.sq ? lse[q] * LOG2E : 0.f;
        L[BW_BQ + r] = q < a.sq ? dd[q] : 0.f;
      }
      if (lane == 0) {
        uint8_t* qs = QO + 2 * s * TILE;
        mbar_expect_tx(&full[s], 2 * TILE);  // lane 0's arrival
#pragma unroll
        for (int j = 0; j < DMAX / 64; ++j) {
          tma_load_view(qs + j * 8192, tq, &full[s], a.qpos, 64 * j,
                        it * BW_BQ, n, a.nh);
          tma_load_view(qs + TILE + j * 8192, tdo, &full[s], a.opos, 64 * j,
                        it * BW_BQ, n, a.nh);
        }
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  const int g = lane / 4, t = lane % 4;
  if (it0 < nq) mbar_wait(&kvbar, 0);
  // keys g and g + 8 of this warp's 16 (the rows); the accumulator's
  // columns 8 j + 2 t + {0, 1} are queries of the tile (S^T, dP^T) or
  // head-dim columns (dK, dV)
  int64_t kpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) kpos[h] = a.koff + k0 + warp * 16 + g + 8 * h;
  const float sl = a.scale * LOG2E;
  float dk[DMAX / 2], dv[DMAX / 2];
#pragma unroll
  for (int i = 0; i < DMAX / 2; ++i) dk[i] = dv[i] = 0.f;

  for (int it = it0; it < nq; ++it) {
    const int i = it - it0, s = i % ST;
    mbar_wait(&full[s], (i / ST) & 1);
    const uint8_t* Qt = QO + 2 * s * TILE;
    const uint8_t* Ot = Qt + TILE;
    const float* L = LD + 2 * s * BW_BQ;
    const int q0 = it * BW_BQ;

    float st[32], dp[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) st[j] = dp[j] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      const int off = (kc / 4) * 8192 + (kc % 4) * 32;
      wgmma_ss<64, 0>(st, sw128_desc(Ks + off, 16, 1024),
                      sw128_desc(Qt + off, 16, 1024), 1);
    }
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      const int off = (kc / 4) * 8192 + (kc % 4) * 32;
      wgmma_ss<64, 0>(dp, sw128_desc(Vs + off, 16, 1024),
                      sw128_desc(Ot + off, 16, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(st);
    reg_fence(dp);

    const bool edge = q0 + BW_BQ > a.sq ||
                      (a.causal && a.koff + k0 + BW_KEYS - 1 > a.qoff + q0);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * j + 2 * t + (e & 1);
        float p = aw_ex2(fmaf(st[4 * j + e], sl, -L[qi]));
        if (edge) {
          bool live = q0 + qi < a.sq;
          if (a.causal) live = live && (kpos[e >> 1] <= a.qoff + q0 + qi);
          if (!live) p = 0.f;
        }
        st[4 * j + e] = p;                                          // P^T
        dp[4 * j + e] = p * (dp[4 * j + e] - L[BW_BQ + qi]) * a.scale;  // dS^T
      }
    // P^T and dS^T rounded to bf16 as the A fragments of the 4 16-query
    // chunks
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int x = 4 * (2 * c + u) + 2 * hh;
          pa[c][2 * u + hh] = aw_pack(st[x], st[x + 1]);
          da[c][2 * u + hh] = aw_pack(dp[x], dp[x + 1]);
        }
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < 4; ++c)
      wgmma_rs<DMAX, 1>(dv, pa[c], sw128_desc(Ot + c * 2048, 8192, 1024), 1);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      wgmma_rs<DMAX, 1>(dk, da[c], sw128_desc(Qt + c * 2048, 8192, 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dv);
    reg_fence(dk);
    mbar_arrive(&empty[s]);  // this stage's Q, dO, lse and dd are read
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + warp * 16 + g + 8 * h;
    if (key >= a.sk) continue;
    const int64_t hb = n / a.nh, hi = n % a.nh;
    const int64_t bk = hb * a.ksb + hi * a.ksh + (int64_t)key * a.kss;
    const int64_t bv = hb * a.vsb + hi * a.vsh + (int64_t)key * a.vss;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int dd = 8 * j + 2 * t;  // dh is a multiple of 8
      if (dd < a.dh) {
        bw_store2(a.dk, bk + dd, dk[4 * j + 2 * h], dk[4 * j + 2 * h + 1],
                  a.out_f32);
        bw_store2(a.dv, bv + dd, dv[4 * j + 2 * h], dv[4 * j + 2 * h + 1],
                  a.out_f32);
      }
    }
  }
}

}  // namespace da_sm90
