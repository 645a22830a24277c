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
// by the trapezoid argument of pallas_stencil.py.  Each block owns a 32x32
// output tile and holds a (32+2k)x(32+2k) window in shared memory: the tile
// plus a k-deep apron of ghost cells on all four sides, loaded from the
// extended array [lo; x; hi] (k halo rows each).  Every step updates the whole
// window; a window cell whose neighbour lies outside the window reads zero (a
// ring of zeros around each buffer, so the taps need no bounds checks), so
// garbage moves inward one cell per step and after k steps exactly the tile
// is right.  Two rules keep the boundary as the TPU kernel has it:
//   - columns: the TPU kernel holds whole rows, so its column edge is zero at
//     every step.  Here interior column ghosts come from the neighbouring
//     tile's data, and only cells beyond the global column edge are re-zeroed
//     after each step.
//   - rows: rows beyond the domain are re-zeroed after each step only when
//     the top_dirichlet / bot_dirichlet flag says this block edge is the
//     global boundary; otherwise they evolve from the step-0 halo.
// Bound: one read of x, lo and hi and one write of the output per launch, so
// 1/k of the single-step kernel's traffic per step.  The window costs
// (32+2k)^2/32^2 redundant cell updates (2.25x at k=8), paid in shared memory
// and arithmetic, which the bytes bound leaves room for.  k is limited to
// MAX_K=16 so the two buffers ((34+2k)^2 floats each) fit the 48 KB a block
// gets without opting in to more.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct W9 {
  float w[9];
};

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int TILE = 32;
constexpr int MAX_K = 16;
constexpr int MTX = 16;  // multistep block: 16x16 threads
constexpr int MTY = 16;

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

__global__ void multistep_kernel(const float* __restrict__ x,
                                 const float* __restrict__ lo,
                                 const float* __restrict__ hi,
                                 float* __restrict__ out, int m, int n, int k,
                                 int top_d, int bot_d, W9 w) {
  // Two (E+2)x(E+2) buffers: the E x E window plus a ring of zeros, so a
  // window cell reads its neighbours with no bounds checks.
  extern __shared__ float smem[];
  const int E = TILE + 2 * k;
  const int S = E + 2;  // buffer row stride
  float* cur = smem;
  float* nxt = smem + S * S;
  // window cell (i, j) <-> extended row R = r0 + i (extended rows 0..k-1 are
  // lo, k..m+k-1 are x, m+k..m+2k-1 are hi) and global column C = c0 - k + j
  const int r0 = blockIdx.y * TILE;
  const int c0 = blockIdx.x * TILE;
  const int mext = m + 2 * k;
  const int tx = threadIdx.x, ty = threadIdx.y;

  for (int i = ty; i < S; i += MTY) {
    for (int j = tx; j < S; j += MTX) {
      int R = r0 + i - 1, C = c0 - k + j - 1;
      float v = 0.f;
      if (i > 0 && i <= E && j > 0 && j <= E && R < mext && C >= 0 && C < n) {
        if (R < k) v = lo[(int64_t)R * n + C];
        else if (R < m + k) v = x[(int64_t)(R - k) * n + C];
        else v = hi[(int64_t)(R - m - k) * n + C];
      }
      cur[i * S + j] = v;
      nxt[i * S + j] = 0.f;
    }
  }
  __syncthreads();

  for (int s = 0; s < k; ++s) {
    for (int i = ty; i < E; i += MTY) {
      const int R = r0 + i;
      const bool row_zero =
          R >= mext || (top_d && R < k) || (bot_d && R >= m + k);
      for (int j = tx; j < E; j += MTX) {
        const int C = c0 - k + j;
        float v = 0.f;
        if (!row_zero && C >= 0 && C < n) {
          const float* c = cur + (i + 1) * S + (j + 1);
          v = apply3x3(w, [&](int di, int dj) -> float {
            return c[di * S + dj];
          });
        }
        nxt[(i + 1) * S + (j + 1)] = v;
      }
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }

  for (int i = ty; i < TILE; i += MTY) {
    for (int j = tx; j < TILE; j += MTX) {
      int r = r0 + i, C = c0 + j;
      if (r < m && C < n)
        out[(int64_t)r * n + C] = cur[(i + k + 1) * S + (j + k + 1)];
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

extern "C" int da_stencil_multistep(const float* x, const float* lo,
                                    const float* hi, float* out, int m, int n,
                                    int k, int top_d, int bot_d,
                                    const float* w9, int device,
                                    void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (k < 1 || k > MAX_K) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int S = TILE + 2 * k + 2;
  dim3 block(MTX, MTY);
  dim3 grid((n + TILE - 1) / TILE, (m + TILE - 1) / TILE);
  size_t smem = 2 * (size_t)S * S * sizeof(float);
  multistep_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      x, lo, hi, out, m, n, k, top_d, bot_d, pack(w9));
  return (int)cudaGetLastError();
}
