// Weighted 3x3 stencil kernels for Hopper (sm_90a), for float32, float16,
// bfloat16 and int32 grids (a DArray narrows 64-bit types to these).
//
//   out[i,j] = sum_ab w[a][b] * x[i-1+a, j-1+b]
//
// with the rows beyond the block taken from the halo rows `lo` (above) and
// `hi` (below), and a zero column edge.  Taps are summed in the order of the
// plain version (`_apply3x3` in ops/cuda_stencil.py: rows top to bottom, then
// columns left to right), zero weights skipped, and with contraction into FMA
// turned off (__fmul_rn/__fadd_rn), so a cell comes out bit for bit as the
// plain version computes it.  Where the plain version adds a unit weight's
// tap unmultiplied, the generic taps multiply by one, which is exact in every
// type (only a NaN's payload may differ), so that the compiler needs no
// select a tap.  Each kernel is a template on the element type T (`Ty<T>`
// below): every product and every sum is rounded to T as a PyTorch op on a
// tensor of T rounds it (float16 and bfloat16 computed in float32 and
// rounded to the type, which equals the correctly rounded op since float32
// holds 2p + 2 bits of their p; integers wrap).  The weights come already
// cast to T (`Taps`), with the plain version's zero test made on the weights
// before the cast (the mask `skip`).  A lane reads its four columns with one
// access of 4 x sizeof(T) bytes.
//
// da_stencil_step replaces the Pallas TPU kernel
// distributedarrays_tpu/ops/pallas_stencil.py `_kernel` (built by `_build`,
// called by `stencil3x3_block`).  One step reads the grid once and writes it
// once, so on an H100 it is bound by bytes: 8 bytes per cell over 3.35 TB/s.
// Design: a register strip a thread (`st` below).  A warp spans 128 columns
// (4 a lane) and each thread walks R = 8 rows (DA_STENCIL_STEP_ROWS, passed
// by the build) down its four columns, reading the R + 2 rows it needs (one
// above and one below the strip, from `lo`/`hi` at the block edge) as one
// vector load a row, all ten issued ahead of the arithmetic, so in float32
// 160 bytes a thread are in flight at 64-80 registers (three to four blocks
// an SM).  Taller strips read fewer rows
// twice but hold more registers and fewer warps an SM, and ran slower
// (PERF.md §6).  The columns of the lanes either side come by warp
// shuffles, and the warp's two outer columns by one scalar load a row
// (lanes 0 and 31).  No shared memory, no barrier; vector stores.  The
// TPU kernel's precomputed boundary-row arrays are not needed.  The same
// two routes as the multistep kernel: the 5-point taps compiled in, or the
// generic taps with each weight tested once for a row of a thread's cells.
// A scalar path takes shapes the vector accesses cannot read (n not a
// multiple of 4, a base not aligned to 4 elements).
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
// padded with zeros and read as one vector a lane, conflict-free).  The
// main path's 5-point weights (zero corners, unit edges) take a
// specialisation with the taps known at compile time: 4 adds and 1 multiply
// a cell.  Other weights take the generic taps, each weight tested for 0
// once for a row of a thread's four cells.
// Bounds: one read of x, lo and hi and one write of the output per launch
// (1/k of the single-step kernel's traffic per step); the window costs
// 128^2/(128-2k)^2 redundant cell updates (1.31x at k=8), paid in
// registers and issue slots.  The shared-memory traffic is the exchange
// rows, 2 stores and 2 loads of 16 bytes a thread a step, and the shuffles
// (2 a row for the 5-point taps), which PERF.md counts as a second bound.
// k is limited to MAX_K=16 (a 96x96 tile).  The launch grid comes from the
// wrapper's plan (`multistep_plan` in ops/cuda_stencil.py), which the entry
// checks covers the block.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#ifndef DA_STENCIL_STEP_ROWS
#error "build with -DDA_STENCIL_STEP_ROWS=<rows a thread> (utils/kbuild.py)"
#endif

namespace {

constexpr int MAX_K = 16;
constexpr unsigned FULL = 0xffffffffu;
constexpr int LANES = 32;
constexpr int CW = 4;               // columns a lane

// The element types: a value's bits `B`, and the two operations of a tap,
// each rounded to the type as PyTorch rounds `w * t` and `acc + term`.
template <class T>
struct Ty;
template <>
struct Ty<float> {
  using B = unsigned;
  static __device__ __forceinline__ float from(B b) {
    return __uint_as_float(b);
  }
  static __device__ __forceinline__ B bits(float v) {
    return __float_as_uint(v);
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
};
template <>
struct Ty<__half> {
  using B = unsigned short;
  static __device__ __forceinline__ __half from(B b) {
    return __ushort_as_half(b);
  }
  static __device__ __forceinline__ B bits(__half v) {
    return __half_as_ushort(v);
  }
  static __device__ __forceinline__ __half add(__half a, __half b) {
    return __float2half_rn(__fadd_rn(__half2float(a), __half2float(b)));
  }
  static __device__ __forceinline__ __half mul(__half a, __half b) {
    return __float2half_rn(__fmul_rn(__half2float(a), __half2float(b)));
  }
};
template <>
struct Ty<__nv_bfloat16> {
  using B = unsigned short;
  static __device__ __forceinline__ __nv_bfloat16 from(B b) {
    return __ushort_as_bfloat16(b);
  }
  static __device__ __forceinline__ B bits(__nv_bfloat16 v) {
    return __bfloat16_as_ushort(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 add(__nv_bfloat16 a,
                                                      __nv_bfloat16 b) {
    return __float2bfloat16_rn(
        __fadd_rn(__bfloat162float(a), __bfloat162float(b)));
  }
  static __device__ __forceinline__ __nv_bfloat16 mul(__nv_bfloat16 a,
                                                      __nv_bfloat16 b) {
    return __float2bfloat16_rn(
        __fmul_rn(__bfloat162float(a), __bfloat162float(b)));
  }
};
template <>
struct Ty<int32_t> {
  using B = unsigned;
  static __device__ __forceinline__ int32_t from(B b) { return (int32_t)b; }
  static __device__ __forceinline__ B bits(int32_t v) { return (B)v; }
  static __device__ __forceinline__ int32_t add(int32_t a, int32_t b) {
    return (int32_t)((B)a + (B)b);
  }
  static __device__ __forceinline__ int32_t mul(int32_t a, int32_t b) {
    return (int32_t)((B)a * (B)b);
  }
};
template <class T>
__device__ __forceinline__ T zero() {
  return Ty<T>::from(0);
}

// The 9 weights, row-major, already cast to T (as bits), and the plain
// version's zero test made on them before the cast: bit a*3+b of `skip` for
// a zero weight (a weight such as 0.5 that an integer type truncates to 0 is
// still multiplied, as the plain version multiplies it).
template <class T>
struct Taps {
  typename Ty<T>::B w[9];
  unsigned skip;
};

// A lane's four columns at `p` (aligned to 4 elements) in one access;
// through the read-only path (`__ldg`) when NC.
template <bool NC, class V>
__device__ __forceinline__ V ldv(const V* p) {
  if constexpr (NC) return __ldg(p);
  else return *p;
}

template <bool NC, class T>
__device__ __forceinline__ void ld4(const T* p, T (&v)[CW]) {
  using Y = Ty<T>;
  if constexpr (sizeof(T) == 2) {
    const uint2 u = ldv<NC>(reinterpret_cast<const uint2*>(p));
    v[0] = Y::from(u.x & 0xffffu);
    v[1] = Y::from(u.x >> 16);
    v[2] = Y::from(u.y & 0xffffu);
    v[3] = Y::from(u.y >> 16);
  } else {
    static_assert(sizeof(T) == 4, "2- and 4-byte types");
    const uint4 u = ldv<NC>(reinterpret_cast<const uint4*>(p));
    v[0] = Y::from(u.x);
    v[1] = Y::from(u.y);
    v[2] = Y::from(u.z);
    v[3] = Y::from(u.w);
  }
}

template <class T>
__device__ __forceinline__ void st4(T* p, const T (&v)[CW]) {
  using Y = Ty<T>;
  if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(Y::bits(v[0]) | (unsigned)Y::bits(v[1]) << 16,
                   Y::bits(v[2]) | (unsigned)Y::bits(v[3]) << 16);
  } else {
    *reinterpret_cast<uint4*>(p) = make_uint4(Y::bits(v[0]), Y::bits(v[1]),
                                              Y::bits(v[2]), Y::bits(v[3]));
  }
}

// One element through the read-only path.
template <class T>
__device__ __forceinline__ T ldg1(const T* p) {
  return Ty<T>::from(__ldg(reinterpret_cast<const typename Ty<T>::B*>(p)));
}

// The value of the lane `d` below (__shfl_up_sync) or above (down).
template <class T>
__device__ __forceinline__ T shfl_up(T v, int d) {
  using Y = Ty<T>;
  return Y::from((typename Y::B)__shfl_up_sync(FULL, (unsigned)Y::bits(v), d));
}
template <class T>
__device__ __forceinline__ T shfl_down(T v, int d) {
  using Y = Ty<T>;
  return Y::from(
      (typename Y::B)__shfl_down_sync(FULL, (unsigned)Y::bits(v), d));
}

// One row of a thread's four cells into `o`, from its rows above (`u`), at
// (`c`) and below (`d`), each with its columns beyond the lane's four
// (`*l`, `*r`; the 5-point taps read only the centre row's): the plain
// version's taps in its order.  The 5-point weights (zero corners, unit
// edges) have their taps compiled in; other weights are each tested once
// for the row's four cells.  Every index is a constant once unrolled, so
// every read is a register.
template <class T, bool FIVE>
__device__ __forceinline__ void row_taps(const T (&u)[CW], T ul, T ur,
                                         const T (&c)[CW], T cl, T cr,
                                         const T (&d)[CW], T dl, T dr,
                                         const Taps<T>& w, T (&o)[CW]) {
  using Y = Ty<T>;
  if (FIVE) {
    const T w4 = Y::from(w.w[4]);
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      // taps (0,1), (1,0), (1,1), (1,2), (2,1): the plain order
      T acc = Y::add(u[j], j ? c[j - 1] : cl);
      acc = Y::add(acc, Y::mul(w4, c[j]));
      acc = Y::add(acc, j + 1 < CW ? c[j + 1] : cr);
      o[j] = Y::add(acc, d[j]);
    }
    return;
  }
  // row a of the three, column j of -1 .. CW
  auto at = [&](int a, int j) -> T {
    if (a == 0) return j < 0 ? ul : j >= CW ? ur : u[j];
    if (a == 1) return j < 0 ? cl : j >= CW ? cr : c[j];
    return j < 0 ? dl : j >= CW ? dr : d[j];
  };
  bool started = false;
#pragma unroll
  for (int j = 0; j < CW; ++j) o[j] = zero<T>();
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const int i = a * 3 + b;
      if ((w.skip >> i) & 1u) continue;
      const T wv = Y::from(w.w[i]);
#pragma unroll
      for (int j = 0; j < CW; ++j) {
        const T term = Y::mul(wv, at(a, j + b - 1));
        o[j] = started ? Y::add(o[j], term) : term;
      }
      started = true;
    }
  }
}

// The single-step kernel's strip: 8 warps stacked, each 128 columns (4 a
// lane) by R rows.
namespace st {
constexpr int TW = LANES * CW;      // tile width: one warp across
constexpr int R = DA_STENCIL_STEP_ROWS;  // rows a thread
constexpr int NW = 8;               // warps a block, stacked
constexpr int TH = NW * R;          // tile height
constexpr int THREADS = NW * LANES;
}  // namespace st

// Row `rr` of the extended block [lo; x; hi] at a lane's four columns from
// c0 into `v`, and into `e` the column beside them that only the warp's
// edge lanes read: c0 - 1 for lane 0, c0 + 4 for lane 31.  Columns outside
// 0 .. n-1 read zero, and so do rows beyond the halo row below (rr > m),
// which no output row needs.
template <class T, bool VEC>
__device__ __forceinline__ void load_row(const T* __restrict__ x,
                                         const T* __restrict__ lo,
                                         const T* __restrict__ hi, int m,
                                         int n, int rr, int c0, int lane,
                                         T (&v)[CW], T& e) {
  const bool live = rr <= m;
  const T* row = rr < 0 ? lo : rr < m ? x + (int64_t)rr * n : hi;
  if (VEC) {
    if (live && c0 < n) {
      ld4<true>(row + c0, v);
    } else {
#pragma unroll
      for (int c = 0; c < CW; ++c) v[c] = zero<T>();
    }
  } else {
#pragma unroll
    for (int c = 0; c < CW; ++c)
      v[c] = live && c0 + c < n ? ldg1(row + c0 + c) : zero<T>();
  }
  const int ce = lane == 0 ? c0 - 1 : c0 + CW;
  e = live && (lane == 0 || lane == LANES - 1) && ce >= 0 && ce < n
          ? ldg1(row + ce)
          : zero<T>();
}

// A row's columns c0 - 1 and c0 + 4: from the lanes either side by
// shuffles, at the warp's edge from `e`.
template <class T>
__device__ __forceinline__ void edges(const T (&v)[CW], T e, int lane, T& l,
                                      T& r) {
  l = shfl_up(v[CW - 1], 1);
  r = shfl_down(v[0], 1);
  if (lane == 0) l = e;
  if (lane == LANES - 1) r = e;
}

// grid (tiles across, tiles down) of TW x TH tiles from the wrapper's plan;
// VEC when n is a multiple of 4 and every base is aligned (`vec_ok`).
template <class T, bool FIVE, bool VEC>
__global__ void __launch_bounds__(st::THREADS)
step_kernel(const T* __restrict__ x, const T* __restrict__ lo,
            const T* __restrict__ hi, T* __restrict__ out, int m, int n,
            Taps<T> w) {
  using namespace st;
  const int lane = threadIdx.x % LANES, wp = threadIdx.x / LANES;
  const int r0 = (blockIdx.y * NW + wp) * R;  // the strip's first row
  if (r0 >= m) return;                        // the whole warp
  const int c0 = blockIdx.x * TW + CW * lane;
  // rows r0 - 1 .. r0 + R as k = 0 .. R + 1, all R + 2 loads issued before
  // the arithmetic; every index is a constant once unrolled, so the rows
  // live in registers.  A row's shuffles wait for its load, so they come
  // only where the row is first read.
  T v[R + 2][CW], e[R + 2], l[R + 2], r[R + 2];
#pragma unroll
  for (int k = 0; k < R + 2; ++k)
    load_row<T, VEC>(x, lo, hi, m, n, r0 - 1 + k, c0, lane, v[k], e[k]);
  edges(v[0], e[0], lane, l[0], r[0]);
  edges(v[1], e[1], lane, l[1], r[1]);
#pragma unroll
  for (int i = 1; i <= R; ++i) {
    // output row r0 - 1 + i reads rows i - 1, i, i + 1
    edges(v[i + 1], e[i + 1], lane, l[i + 1], r[i + 1]);
    const int rr = r0 - 1 + i;
    T o[CW];
    row_taps<T, FIVE>(v[i - 1], l[i - 1], r[i - 1], v[i], l[i], r[i],
                      v[i + 1], l[i + 1], r[i + 1], w, o);
    if (rr >= m) continue;
    T* orow = out + (int64_t)rr * n;
    if (VEC) {
      if (c0 < n) st4(orow + c0, o);
    } else {
#pragma unroll
      for (int c = 0; c < CW; ++c)
        if (c0 + c < n) orow[c0 + c] = o[c];
    }
  }
}

namespace ms {
constexpr int WW = LANES * CW;      // window width: one warp across
constexpr int V = 16;               // window rows a thread holds
constexpr int NW = 8;               // warps a block, stacked
constexpr int WH = NW * V;          // window height
constexpr int THREADS = NW * LANES;
constexpr int PAD = 4;              // zero elements either side of a row
constexpr int XS = WW + 2 * PAD;    // exchange row stride (elements)
}  // namespace ms

// One step of a thread's 16x4 cells in place.  `up`/`dn` are the rows
// above and below (from the warps either side), `upl`/`upr`/`dnl`/`dnr`
// their columns beyond the lane's four (generic taps only); rows of
// `rmask` and columns of `cmask` not set are re-zeroed.
template <class T, bool FIVE>
__device__ __forceinline__ void step_cells(T (&v)[ms::V][CW],
                                           const T (&up)[CW],
                                           const T (&dn)[CW], T upl, T upr,
                                           T dnl, T dnr, int lane,
                                           unsigned rmask, unsigned cmask,
                                           bool interior, const Taps<T>& w) {
  using namespace ms;
  T pr[CW];
#pragma unroll
  for (int c = 0; c < CW; ++c) pr[c] = up[c];
  T pl = upl, prr = upr;  // columns beyond the lane of the row above
  T cl = shfl_up(v[0][CW - 1], 1);
  T cr = shfl_down(v[0][0], 1);
  if (lane == 0) cl = zero<T>();
  if (lane == LANES - 1) cr = zero<T>();
#pragma unroll
  for (int i = 0; i < V; ++i) {
    T nx[CW];
#pragma unroll
    for (int c = 0; c < CW; ++c) nx[c] = i + 1 < V ? v[i + 1][c] : dn[c];
    T nl = dnl, nr = dnr;
    if (!FIVE && i + 1 < V) {
      nl = shfl_up(v[i + 1][CW - 1], 1);
      nr = shfl_down(v[i + 1][0], 1);
      if (lane == 0) nl = zero<T>();
      if (lane == LANES - 1) nr = zero<T>();
    }
    T nw[CW];
    row_taps<T, FIVE>(pr, pl, prr, v[i], cl, cr, nx, nl, nr, w, nw);
    if (!interior) {
#pragma unroll
      for (int c = 0; c < CW; ++c)
        if (!((rmask >> i) & (cmask >> c) & 1u)) nw[c] = zero<T>();
    }
    if (FIVE && i + 1 < V) {
      cl = shfl_up(v[i + 1][CW - 1], 1);
      cr = shfl_down(v[i + 1][0], 1);
      if (lane == 0) cl = zero<T>();
      if (lane == LANES - 1) cr = zero<T>();
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
// n is a multiple of 4 and every base is aligned (`vec_ok`).
template <class T, bool FIVE>
__global__ void __launch_bounds__(ms::THREADS, 2)
multistep_kernel(const T* __restrict__ x, const T* __restrict__ lo,
                 const T* __restrict__ hi, T* __restrict__ out, int m, int n,
                 int k, int top_d, int bot_d, int vec, Taps<T> w) {
  using namespace ms;
  using B = typename Ty<T>::B;
  __shared__ __align__(16) B xch[2][2][NW][XS];  // [buf][top/bottom]
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
    (&xch[0][0][0][0])[i] = 0;

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

  T v[V][CW];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int R = R0 + i;
    const T* row = R < k       ? lo + (int64_t)R * n
                   : R < m + k ? x + (int64_t)(R - k) * n
                               : hi + (int64_t)(R - m - k) * n;
    if (R < mext && v4 && cmask == 0xfu) {
      ld4<true>(row + C0, v[i]);
    } else {
#pragma unroll
      for (int c = 0; c < CW; ++c)
        v[i][c] = R < mext && ((cmask >> c) & 1u) ? ldg1(row + C0 + c)
                                                   : zero<T>();
    }
  }
  __syncthreads();  // the exchange buffers are zeroed

#pragma unroll 1
  for (int s = 0; s < k; ++s) {
    T(*top)[XS] = reinterpret_cast<T(*)[XS]>(xch[s & 1][0]);
    T(*bot)[XS] = reinterpret_cast<T(*)[XS]>(xch[s & 1][1]);
    const int x0 = PAD + CW * lane;
    st4(&top[wp][x0], v[0]);
    st4(&bot[wp][x0], v[V - 1]);
    __syncthreads();
    T up[CW], dn[CW];
    T upl = zero<T>(), upr = zero<T>(), dnl = zero<T>(), dnr = zero<T>();
    if (wp > 0) {
      ld4<false>(&bot[wp - 1][x0], up);
      if (!FIVE) {
        upl = bot[wp - 1][x0 - 1];
        upr = bot[wp - 1][x0 + CW];
      }
    } else {
#pragma unroll
      for (int c = 0; c < CW; ++c) up[c] = zero<T>();
    }
    if (wp + 1 < NW) {
      ld4<false>(&top[wp + 1][x0], dn);
      if (!FIVE) {
        dnl = top[wp + 1][x0 - 1];
        dnr = top[wp + 1][x0 + CW];
      }
    } else {
#pragma unroll
      for (int c = 0; c < CW; ++c) dn[c] = zero<T>();
    }
    step_cells<T, FIVE>(v, up, dn, upl, upr, dnl, dnr, lane, rmask, cmask,
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
    T* orow = out + (int64_t)r * n;
    if (v4 && cols_in) {
      st4(orow + C0, v[i]);
    } else {
#pragma unroll
      for (int c = 0; c < CW; ++c)
        if (j0 + c >= k && j0 + c < WW - k && C0 + c < n)
          orow[C0 + c] = v[i][c];
    }
  }
}

// The stencils' routes (kbuild.STENCIL_ROUTES): the generic taps, and the
// 5-point weights (zero corners, unit edges, a nonzero centre).
constexpr int ROUTE_GENERIC = 0;
constexpr int ROUTE_FIVE = 1;

// The route's weights, from the zero and unit masks: the 5-point route
// takes zero corners (bits 0, 2, 6, 8), unit edges (1, 3, 5, 7) and a
// centre that is not zero (4).
bool route_ok(int route, unsigned skip, unsigned unit) {
  const bool five = (skip & 0x145u) == 0x145u && (unit & 0xaau) == 0xaau &&
                    !(skip & 0x10u);
  return route == ROUTE_GENERIC || (route == ROUTE_FIVE && five);
}

// `tiles` tiles of `t` cover `len` cells, none wholly outside them.
bool covers(long long tiles, long long t, long long len) {
  return tiles >= 1 && tiles * t >= len && (tiles - 1) * t < len;
}

// Vector rows: n a multiple of 4 and every base aligned to 4 elements.
template <class T>
bool vec_ok(int n, const void* x, const void* lo, const void* hi,
            const void* out) {
  const uintptr_t a = 4 * sizeof(T);
  return n % 4 == 0 && (uintptr_t)x % a == 0 && (uintptr_t)lo % a == 0 &&
         (uintptr_t)hi % a == 0 && (uintptr_t)out % a == 0;
}

template <class T>
Taps<T> pack(const void* w9, unsigned skip) {
  Taps<T> w;
  memcpy(w.w, w9, sizeof(w.w));
  w.skip = skip;
  return w;
}

template <class T>
int launch_step(dim3 grid, cudaStream_t s, const void* x, const void* lo,
                const void* hi, void* out, int m, int n, const void* w9,
                unsigned skip, int route) {
  const Taps<T> w = pack<T>(w9, skip);
  const bool vec = vec_ok<T>(n, x, lo, hi, out);
  const T *xt = static_cast<const T*>(x), *lt = static_cast<const T*>(lo),
          *ht = static_cast<const T*>(hi);
  T* ot = static_cast<T*>(out);
  if (route == ROUTE_FIVE) {
    if (vec)
      step_kernel<T, true, true><<<grid, st::THREADS, 0, s>>>(xt, lt, ht, ot,
                                                              m, n, w);
    else
      step_kernel<T, true, false><<<grid, st::THREADS, 0, s>>>(
          xt, lt, ht, ot, m, n, w);
  } else {
    if (vec)
      step_kernel<T, false, true><<<grid, st::THREADS, 0, s>>>(
          xt, lt, ht, ot, m, n, w);
    else
      step_kernel<T, false, false><<<grid, st::THREADS, 0, s>>>(
          xt, lt, ht, ot, m, n, w);
  }
  return (int)cudaGetLastError();
}

template <class T>
int launch_multistep(dim3 grid, cudaStream_t s, const void* x,
                     const void* lo, const void* hi, void* out, int m, int n,
                     int k, int top_d, int bot_d, const void* w9,
                     unsigned skip, int route) {
  const Taps<T> w = pack<T>(w9, skip);
  const int vec = vec_ok<T>(n, x, lo, hi, out);
  const T *xt = static_cast<const T*>(x), *lt = static_cast<const T*>(lo),
          *ht = static_cast<const T*>(hi);
  T* ot = static_cast<T*>(out);
  if (route == ROUTE_FIVE)
    multistep_kernel<T, true><<<grid, ms::THREADS, 0, s>>>(
        xt, lt, ht, ot, m, n, k, top_d, bot_d, vec, w);
  else
    multistep_kernel<T, false><<<grid, ms::THREADS, 0, s>>>(
        xt, lt, ht, ot, m, n, k, top_d, bot_d, vec, w);
  return (int)cudaGetLastError();
}

}  // namespace

// `x`, `lo`, `hi` and `out` are device arrays of the element type `dtype`,
// a code of ops/cuda_stencil.py KERNEL_DTYPES (float32, float16, bfloat16,
// int32); `w9` is a host array of the 9 weights in that type, row-major,
// with `skip` and `unit` their zero and unit masks (bit a*3+b; `unit` only
// for the route's check); `route` and the grid (`tiles_x` x `tiles_y`
// blocks) come from the wrapper's plan and route; a grid that does not
// cover the block exactly, the 5-point route for other weights, or an
// unknown dtype is refused (cudaErrorInvalidValue).  `device` is the CUDA
// device index of the tensors and the stream.  Each returns the
// cudaGetLastError() code of the launch (0 = cudaSuccess).
extern "C" int da_stencil_step(const void* x, const void* lo, const void* hi,
                               void* out, int m, int n, int dtype,
                               const void* w9, unsigned skip, unsigned unit,
                               int route, int tiles_x, int tiles_y,
                               int device, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (!covers(tiles_x, st::TW, n) || !covers(tiles_y, st::TH, m) ||
      tiles_y > 65535 || dtype < 0 || dtype > 3 ||
      !route_ok(route, skip, unit))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(tiles_x, tiles_y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_step<float>(grid, s, x, lo, hi, out, m, n, w9, skip,
                                route);
    case 1:
      return launch_step<__half>(grid, s, x, lo, hi, out, m, n, w9, skip,
                                 route);
    case 2:
      return launch_step<__nv_bfloat16>(grid, s, x, lo, hi, out, m, n, w9,
                                        skip, route);
    default:
      return launch_step<int32_t>(grid, s, x, lo, hi, out, m, n, w9, skip,
                                  route);
  }
}

// The grid's blocks are (WH-2k) x (WW-2k) tiles.
extern "C" int da_stencil_multistep(const void* x, const void* lo,
                                    const void* hi, void* out, int m, int n,
                                    int k, int top_d, int bot_d, int dtype,
                                    const void* w9, unsigned skip,
                                    unsigned unit, int route, int tiles_x,
                                    int tiles_y, int device, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (k < 1 || k > MAX_K) return (int)cudaErrorInvalidValue;
  if (!covers(tiles_x, ms::WW - 2 * k, n) ||
      !covers(tiles_y, ms::WH - 2 * k, m) || tiles_y > 65535 || dtype < 0 ||
      dtype > 3 || !route_ok(route, skip, unit))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(tiles_x, tiles_y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_multistep<float>(grid, s, x, lo, hi, out, m, n, k, top_d,
                                     bot_d, w9, skip, route);
    case 1:
      return launch_multistep<__half>(grid, s, x, lo, hi, out, m, n, k,
                                      top_d, bot_d, w9, skip, route);
    case 2:
      return launch_multistep<__nv_bfloat16>(grid, s, x, lo, hi, out, m, n,
                                             k, top_d, bot_d, w9, skip, route);
    default:
      return launch_multistep<int32_t>(grid, s, x, lo, hi, out, m, n, k,
                                       top_d, bot_d, w9, skip, route);
  }
}
