// Weighted 3x3 stencil kernels for Hopper (sm_90a), float32.
//
//   out[i,j] = sum_ab w[a][b] * x[i-1+a, j-1+b]
//
// with the rows beyond the block taken from the halo rows `lo` (above) and
// `hi` (below), and a zero column edge.  Taps are summed in the order of the
// plain version (`_apply3x3` in ops/cuda_stencil.py: rows top to bottom, then
// columns left to right), zero weights skipped, unit weights not multiplied,
// and with contraction into FMA turned off (__fmul_rn/__fadd_rn), so a cell
// comes out bit for bit as the plain version computes it.
//
// da_stencil_step replaces the Pallas TPU kernel
// distributedarrays_tpu/ops/pallas_stencil.py `_kernel` (built by `_build`,
// called by `stencil3x3_block`).  One step reads the grid once and writes it
// once, so on an H100 it is bound by bytes: 8 bytes per cell over 3.35 TB/s.
// Design: one thread per output cell, 32x8 threads per block, neighbours read
// straight from global memory and reused through L1; the weights arrive as
// kernel arguments.  The TPU kernel's precomputed boundary-row arrays are not
// needed: a thread reads `lo`/`hi` itself when its neighbour row lies beyond
// the block.
//
// da_stencil_multistep replaces `_kernel_multi` (built by `_build_multi`,
// called by `stencil3x3_multistep`): k steps in one launch, temporal blocking
// by the trapezoid argument of pallas_stencil.py.  Each block holds a 128x128
// window of the extended array [lo; x; hi] (k halo rows each) and writes the
// (128-2k)x(128-2k) output tile at its centre (WH x WW and (WH-2k) x (WW-2k)
// below).  Every step updates the whole
// window; a window cell whose neighbour lies outside the window reads zero,
// so garbage moves inward one cell per step and after k steps exactly the
// tile is right.  Two rules keep the boundary as the TPU kernel has it:
//   - columns: the TPU kernel holds whole rows, so its column edge is zero at
//     every step.  Here interior column ghosts come from the neighbouring
//     tile's data, and only cells beyond the global column edge are re-zeroed
//     after each step.
//   - rows: rows beyond the domain are re-zeroed after each step only when
//     the top_dirichlet / bot_dirichlet flag says this block edge is the
//     global boundary; otherwise they evolve from the step-0 halo.  The test
//     is on the global extended row, so it holds however m and k compare
//     with the window.
// The window lives in registers, not in shared memory: a block is 8 warps
// stacked top to bottom, a warp spans the window's 128 columns (4 a lane)
// and 16 rows, so a thread holds 16x4 cells.  Vertical taps and the
// horizontal taps inside a lane's 4 columns read registers; the columns of
// the lanes either side come by warp shuffles; only the first and last row
// of each warp cross to the warps above and below, through two small
// shared-memory exchange buffers (ping-pong, so one barrier a step; rows
// padded with zeros and read as float4, conflict-free).  The main path's
// 5-point weights (zero corners, unit edges) take a specialisation with the
// taps known at compile time: 4 adds and 1 multiply a cell.  Other weights
// take the generic taps, each weight tested for 0 and 1 once for a row of
// a thread's four cells.
// Bounds: one read of x, lo and hi and one write of the output per launch
// (1/k of the single-step kernel's traffic per step); the window costs
// 128^2/(128-2k)^2 redundant cell updates (1.31x at k=8), paid in
// registers and issue slots.  The shared-memory traffic is the exchange
// rows, 2 stores and 2 loads of 16 bytes a thread a step, and the shuffles
// (2 a row for the 5-point taps), which PERF.md counts as a second bound.
// k is limited to MAX_K=16 (a 96x96 tile).  The launch grid comes from the
// wrapper's plan (`multistep_plan` in ops/cuda_stencil.py), which the entry
// checks covers the block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct W9 {
  float w[9];
};

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int MAX_K = 16;

// One weighted step at a cell whose 3x3 neighbourhood is given by `at`.
template <typename F>
__device__ __forceinline__ float apply3x3(const W9& w, F at) {
  float acc = 0.f;
  bool first = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      float wv = w.w[a * 3 + b];
      if (wv == 0.f) continue;
      float v = at(a - 1, b - 1);
      float term = (wv == 1.f) ? v : __fmul_rn(wv, v);
      acc = first ? term : __fadd_rn(acc, term);
      first = false;
    }
  }
  return acc;
}

__global__ void step_kernel(const float* __restrict__ x,
                            const float* __restrict__ lo,
                            const float* __restrict__ hi,
                            float* __restrict__ out, int m, int n, W9 w) {
  const int c = blockIdx.x * TX + threadIdx.x;
  const int r = blockIdx.y * TY + threadIdx.y;
  if (r >= m || c >= n) return;
  float v = apply3x3(w, [&](int dr, int dc) -> float {
    int rr = r + dr, cc = c + dc;
    if (cc < 0 || cc >= n) return 0.f;
    if (rr < 0) return lo[cc];
    if (rr >= m) return hi[cc];
    return x[(int64_t)rr * n + cc];
  });
  out[(int64_t)r * n + c] = v;
}

namespace ms {
constexpr int LANES = 32;
constexpr int CW = 4;               // window columns a lane holds
constexpr int WW = LANES * CW;      // window width: one warp across
constexpr int V = 16;               // window rows a thread holds
constexpr int NW = 8;               // warps a block, stacked
constexpr int WH = NW * V;          // window height
constexpr int THREADS = NW * LANES;
constexpr int PAD = 4;              // zero floats either side of a row
constexpr int XS = WW + 2 * PAD;    // exchange row stride (floats)
constexpr unsigned FULL = 0xffffffffu;
}  // namespace ms

// One step of a thread's 16x4 cells in place.  `up`/`dn` are the rows
// above and below (from the warps either side), `upl`/`upr`/`dnl`/`dnr`
// their columns beyond the lane's four (generic taps only); rows of
// `rmask` and columns of `cmask` not set are re-zeroed.
template <bool FIVE>
__device__ __forceinline__ void step_cells(float (&v)[ms::V][ms::CW],
                                           const float (&up)[ms::CW],
                                           const float (&dn)[ms::CW],
                                           float upl, float upr, float dnl,
                                           float dnr, int lane,
                                           unsigned rmask, unsigned cmask,
                                           bool interior, const W9& w) {
  using namespace ms;
  float pr[CW];
#pragma unroll
  for (int c = 0; c < CW; ++c) pr[c] = up[c];
  float pl = upl, prr = upr;  // columns beyond the lane of the row above
  float cl = __shfl_up_sync(FULL, v[0][CW - 1], 1);
  float cr = __shfl_down_sync(FULL, v[0][0], 1);
  if (lane == 0) cl = 0.f;
  if (lane == LANES - 1) cr = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    float nx[CW];
#pragma unroll
    for (int c = 0; c < CW; ++c) nx[c] = i + 1 < V ? v[i + 1][c] : dn[c];
    float nl = dnl, nr = dnr;
    if (!FIVE && i + 1 < V) {
      nl = __shfl_up_sync(FULL, v[i + 1][CW - 1], 1);
      nr = __shfl_down_sync(FULL, v[i + 1][0], 1);
      if (lane == 0) nl = 0.f;
      if (lane == LANES - 1) nr = 0.f;
    }
    float nw[CW];
    if (FIVE) {
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        // taps (0,1), (1,0), (1,1), (1,2), (2,1): the plain order
        float acc = __fadd_rn(pr[c], c ? v[i][c - 1] : cl);
        acc = __fadd_rn(acc, __fmul_rn(w.w[4], v[i][c]));
        acc = __fadd_rn(acc, c + 1 < CW ? v[i][c + 1] : cr);
        nw[c] = __fadd_rn(acc, nx[c]);
      }
    } else {
      // apply3x3's taps and order, each weight tested once for the row's
      // cells; (a, j) are constants once unrolled, so every read is a
      // register: row a of the three, column j of -1 .. CW
      auto at = [&](int a, int j) -> float {
        if (a == 0) return j < 0 ? pl : j >= CW ? prr : pr[j];
        if (a == 1) return j < 0 ? cl : j >= CW ? cr : v[i][j];
        return j < 0 ? nl : j >= CW ? nr : nx[j];
      };
      bool started = false;
#pragma unroll
      for (int c = 0; c < CW; ++c) nw[c] = 0.f;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          const float wv = w.w[a * 3 + b];
          if (wv == 0.f) continue;
#pragma unroll
          for (int c = 0; c < CW; ++c) {
            const float x = at(a, c + b - 1);
            const float term = wv == 1.f ? x : __fmul_rn(wv, x);
            nw[c] = started ? __fadd_rn(nw[c], term) : term;
          }
          started = true;
        }
      }
    }
    if (!interior) {
#pragma unroll
      for (int c = 0; c < CW; ++c)
        if (!((rmask >> i) & (cmask >> c) & 1u)) nw[c] = 0.f;
    }
    if (FIVE && i + 1 < V) {
      cl = __shfl_up_sync(FULL, v[i + 1][CW - 1], 1);
      cr = __shfl_down_sync(FULL, v[i + 1][0], 1);
      if (lane == 0) cl = 0.f;
      if (lane == LANES - 1) cr = 0.f;
    }
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      pr[c] = v[i][c];
      v[i][c] = nw[c];
    }
    if (!FIVE) {
      pl = cl;
      prr = cr;
      cl = nl;
      cr = nr;
    }
  }
}

// grid (tiles across, tiles down) from the wrapper's plan; `vec` != 0 when
// n is a multiple of 4 and every base is 16-byte aligned (float4 rows).
template <bool FIVE>
__global__ void __launch_bounds__(ms::THREADS, 2)
multistep_kernel(const float* __restrict__ x, const float* __restrict__ lo,
                 const float* __restrict__ hi, float* __restrict__ out, int m,
                 int n, int k, int top_d, int bot_d, int vec, W9 w) {
  using namespace ms;
  __shared__ __align__(16) float xch[2][2][NW][XS];  // [buf][top/bottom]
  const int lane = threadIdx.x % LANES, wp = threadIdx.x / LANES;
  // window cell (i, j) <-> extended row r0 + i (extended rows 0..k-1 are lo,
  // k..m+k-1 are x, m+k..m+2k-1 are hi) and global column cw0 + j
  const int r0 = blockIdx.y * (WH - 2 * k);
  const int cw0 = blockIdx.x * (WW - 2 * k) - k;
  const int mext = m + 2 * k;
  const int C0 = cw0 + CW * lane;  // this thread's first column
  const int R0 = r0 + V * wp;      // and first extended row
  const bool v4 = vec && (cw0 & 3) == 0;

  for (int i = threadIdx.x; i < 2 * 2 * NW * XS; i += THREADS)
    (&xch[0][0][0][0])[i] = 0.f;

  unsigned cmask = 0, rmask = 0;
#pragma unroll
  for (int c = 0; c < CW; ++c)
    if (C0 + c >= 0 && C0 + c < n) cmask |= 1u << c;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int R = R0 + i;
    if (!(R >= mext || (top_d && R < k) || (bot_d && R >= m + k)))
      rmask |= 1u << i;
  }
  const bool interior = rmask == (1u << V) - 1 && cmask == (1u << CW) - 1;

  float v[V][CW];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int R = R0 + i;
    const float* row = R < k       ? lo + (int64_t)R * n
                       : R < m + k ? x + (int64_t)(R - k) * n
                                   : hi + (int64_t)(R - m - k) * n;
    if (R < mext && v4 && cmask == 0xfu) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(row + C0));
      v[i][0] = t.x;
      v[i][1] = t.y;
      v[i][2] = t.z;
      v[i][3] = t.w;
    } else {
#pragma unroll
      for (int c = 0; c < CW; ++c)
        v[i][c] = R < mext && ((cmask >> c) & 1u) ? __ldg(row + C0 + c) : 0.f;
    }
  }
  __syncthreads();  // the exchange buffers are zeroed

#pragma unroll 1
  for (int s = 0; s < k; ++s) {
    float (*top)[XS] = xch[s & 1][0];
    float (*bot)[XS] = xch[s & 1][1];
    const int x0 = PAD + CW * lane;
    *reinterpret_cast<float4*>(&top[wp][x0]) =
        make_float4(v[0][0], v[0][1], v[0][2], v[0][3]);
    *reinterpret_cast<float4*>(&bot[wp][x0]) =
        make_float4(v[V - 1][0], v[V - 1][1], v[V - 1][2], v[V - 1][3]);
    __syncthreads();
    float up[CW], dn[CW];
    float upl = 0.f, upr = 0.f, dnl = 0.f, dnr = 0.f;
    if (wp > 0) {
      const float4 t = *reinterpret_cast<const float4*>(&bot[wp - 1][x0]);
      up[0] = t.x;
      up[1] = t.y;
      up[2] = t.z;
      up[3] = t.w;
      if (!FIVE) {
        upl = bot[wp - 1][x0 - 1];
        upr = bot[wp - 1][x0 + CW];
      }
    } else {
#pragma unroll
      for (int c = 0; c < CW; ++c) up[c] = 0.f;
    }
    if (wp + 1 < NW) {
      const float4 t = *reinterpret_cast<const float4*>(&top[wp + 1][x0]);
      dn[0] = t.x;
      dn[1] = t.y;
      dn[2] = t.z;
      dn[3] = t.w;
      if (!FIVE) {
        dnl = top[wp + 1][x0 - 1];
        dnr = top[wp + 1][x0 + CW];
      }
    } else {
#pragma unroll
      for (int c = 0; c < CW; ++c) dn[c] = 0.f;
    }
    step_cells<FIVE>(v, up, dn, upl, upr, dnl, dnr, lane, rmask, cmask,
                     interior, w);
  }

  // the tile: window rows and columns k .. 127-k, inside the block
  const int j0 = CW * lane;
  const bool cols_in = j0 >= k && j0 + CW <= WW - k && C0 + CW <= n;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int iw = V * wp + i;
    const int r = r0 + iw - k;
    if (iw < k || iw >= WH - k || r >= m) continue;
    float* orow = out + (int64_t)r * n;
    if (v4 && cols_in) {
      *reinterpret_cast<float4*>(orow + C0) =
          make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
    } else {
#pragma unroll
      for (int c = 0; c < CW; ++c)
        if (j0 + c >= k && j0 + c < WW - k && C0 + c < n)
          orow[C0 + c] = v[i][c];
    }
  }
}

W9 pack(const float* w9) {
  W9 w;
  for (int i = 0; i < 9; ++i) w.w[i] = w9[i];
  return w;
}

}  // namespace

// `w9` is a host array of the 9 weights, row-major; `device` is the CUDA
// device index of the tensors and the stream.  Each returns the
// cudaGetLastError() code of the launch (0 = cudaSuccess).
extern "C" int da_stencil_step(const float* x, const float* lo,
                               const float* hi, float* out, int m, int n,
                               const float* w9, int device, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  dim3 block(TX, TY);
  dim3 grid((n + TX - 1) / TX, (m + TY - 1) / TY);
  step_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      x, lo, hi, out, m, n, pack(w9));
  return (int)cudaGetLastError();
}

// The multistep kernel's routes (kbuild.STENCIL_ROUTES): the generic taps,
// and the 5-point weights (zero corners, unit edges, a nonzero centre).
constexpr int ROUTE_GENERIC = 0;
constexpr int ROUTE_FIVE = 1;

// `route` and the grid (`tiles_x` x `tiles_y` blocks of (WH-2k) x (WW-2k)
// tiles) come from the wrapper's plan; a grid that does not cover the block
// exactly, or the 5-point route for other weights, is refused
// (cudaErrorInvalidValue).
extern "C" int da_stencil_multistep(const float* x, const float* lo,
                                    const float* hi, float* out, int m, int n,
                                    int k, int top_d, int bot_d,
                                    const float* w9, int route, int tiles_x,
                                    int tiles_y, int device, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (k < 1 || k > MAX_K) return (int)cudaErrorInvalidValue;
  const long long tw = ms::WW - 2 * k, th = ms::WH - 2 * k;
  if (tiles_x < 1 || tiles_y < 1 || tiles_y > 65535 || tiles_x * tw < n ||
      tiles_y * th < m || (tiles_x - 1) * tw >= n || (tiles_y - 1) * th >= m)
    return (int)cudaErrorInvalidValue;
  const W9 w = pack(w9);
  const bool five = w.w[0] == 0.f && w.w[2] == 0.f && w.w[6] == 0.f &&
                    w.w[8] == 0.f && w.w[1] == 1.f && w.w[3] == 1.f &&
                    w.w[5] == 1.f && w.w[7] == 1.f && w.w[4] != 0.f;
  if (route != ROUTE_GENERIC && (route != ROUTE_FIVE || !five))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int vec = n % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                  (uintptr_t)lo % 16 == 0 && (uintptr_t)hi % 16 == 0 &&
                  (uintptr_t)out % 16 == 0;
  dim3 grid(tiles_x, tiles_y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == ROUTE_FIVE)
    multistep_kernel<true><<<grid, ms::THREADS, 0, s>>>(
        x, lo, hi, out, m, n, k, top_d, bot_d, vec, w);
  else
    multistep_kernel<false><<<grid, ms::THREADS, 0, s>>>(
        x, lo, hi, out, m, n, k, top_d, bot_d, vec, w);
  return (int)cudaGetLastError();
}
