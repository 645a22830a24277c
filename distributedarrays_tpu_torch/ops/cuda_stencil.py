"""Weighted 3x3 stencil: the hand-written CUDA kernels (``csrc/stencil.cu``)
and their plain versions.

PyTorch counterpart of ``distributedarrays_tpu/ops/pallas_stencil.py``:

- ``stencil3x3_block`` / ``stencil5_block``: one step on a local (m, n)
  block with (1, n) halo rows ``lo``/``hi`` and a zero column edge (the
  single-step kernel);
- ``stencil3x3_multistep`` / ``stencil5_multistep``: ``k`` steps in one
  launch from (k, n) step-0 halo slabs, with the Dirichlet flags saying
  whether this block's top/bottom edge is the global zero boundary (the
  temporal-blocked kernel).

Each wrapper launches its kernel for CUDA tensors (float32 only, contiguous,
one device) and takes the plain version for CPU tensors; it never falls
back from one to the other.  The kernels sum the taps in the plain
version's order without FMA contraction, so on one device the two agree
bit for bit.  The multistep kernel takes at most ``MAX_K`` steps per launch:
each block holds a ``WINDOW_ROWS`` x ``WINDOW_COLS`` window in registers
and writes its centre, a tile of ``WINDOW_ROWS - 2k`` x ``WINDOW_COLS -
2k`` (96 x 96 at k = 16), so the TPU kernel's VMEM tiling limits do not
apply.  ``multistep_plan`` gives a
launch's grid, tile and shared memory; ``multistep_route`` its route
(``kbuild.STENCIL_ROUTES``): the 5-point weights (zero corners, unit
edges, a nonzero centre) take a specialisation with those taps compiled
in, other weights the generic taps.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ..utils import kbuild

__all__ = ["stencil3x3_block", "stencil5_block", "stencil3x3_multistep",
           "stencil5_multistep", "multistep_plan", "multistep_route",
           "LAPLACIAN_3X3", "MAX_K", "WINDOW_ROWS", "WINDOW_COLS"]

# the 5-point Laplacian as a 3x3 stencil
LAPLACIAN_3X3 = ((0.0, 1.0, 0.0), (1.0, -4.0, 1.0), (0.0, 1.0, 0.0))

MAX_K = 16
# the multistep kernel's window (stencil.cu `ms`): 8 warps of 16 rows, 32
# lanes of 4 columns; its shared memory is two exchange buffers of a top
# and a bottom row per warp, each row padded by 4 zero floats either side
_WARPS = 8
WINDOW_ROWS = 16 * _WARPS
WINDOW_COLS = 32 * 4


@dataclass(frozen=True)
class MultistepPlan:
    """A multistep launch: ``grid`` (tiles across, tiles down) of
    ``tile_rows`` x ``tile_cols`` output tiles, and the shared memory a
    block uses."""
    tile_rows: int
    tile_cols: int
    grid: tuple
    smem_bytes: int


def multistep_plan(m: int, n: int, k: int) -> MultistepPlan:
    """The launch of ``k`` steps on an (m, n) block: tiles of
    ``WINDOW_ROWS - 2k`` x ``WINDOW_COLS - 2k`` covering the block, none
    wholly outside it."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the multistep kernel takes 1 <= k <= {MAX_K}; "
                         f"got {k}")
    th, tw = WINDOW_ROWS - 2 * k, WINDOW_COLS - 2 * k
    grid = (max(1, -(-n // tw)), max(1, -(-m // th)))
    if grid[1] > 65535:
        raise ValueError(f"a block of {m} rows needs {grid[1]} tile rows; "
                         "the kernel's grid takes at most 65535")
    smem = 2 * 2 * _WARPS * (WINDOW_COLS + 8) * 4
    return MultistepPlan(th, tw, grid, smem)


def multistep_route(weights) -> str:
    """``"five_point"`` for zero corners, unit edges and a nonzero centre
    (the Laplacian's shape), else ``"generic"``."""
    w = _canon_weights(weights)
    five = (w[0][0] == w[0][2] == w[2][0] == w[2][2] == 0.0
            and w[0][1] == w[1][0] == w[1][2] == w[2][1] == 1.0
            and w[1][1] != 0.0)
    return "five_point" if five else "generic"


def _canon_weights(weights) -> tuple:
    """Validate and canonicalize 3x3 weights to a tuple of float rows."""
    w = np.asarray(weights, dtype=np.float64)
    if w.shape != (3, 3):
        raise ValueError(f"stencil weights must be 3x3; got {w.shape}")
    return tuple(tuple(float(v) for v in row) for row in w)


def _apply3x3(ext: torch.Tensor, w) -> torch.Tensor:
    """The plain step on row-extended ``ext`` ((r + 2, n): one neighbour row
    above and below the r output rows), zero column edge.  Zero weights are
    skipped and unit weights not multiplied, as in the JAX version."""
    bands = (ext[:-2], ext[1:-1], ext[2:])              # rows i-1, i, i+1
    acc = None
    for bi in range(3):
        band = bands[bi]
        zc = torch.zeros_like(band[:, :1])
        for ci, wv in enumerate(w[bi]):
            if wv == 0.0:
                continue
            if ci == 0:      # column j-1
                t = torch.cat([zc, band[:, :-1]], dim=1)
            elif ci == 2:    # column j+1
                t = torch.cat([band[:, 1:], zc], dim=1)
            else:
                t = band
            term = t if wv == 1.0 else wv * t
            acc = term if acc is None else acc + term
    if acc is None:
        acc = torch.zeros_like(ext[1:-1])
    return acc


def _multistep_plain(block, lo, hi, k, top_d, bot_d, w):
    """k plain steps on the extended block [lo; block; hi], re-zeroing the
    rows beyond the domain after each step when its Dirichlet flag is set."""
    m = block.shape[0]
    x = torch.cat([lo, block, hi], dim=0)               # (m + 2k, n)
    rows = torch.arange(m + 2 * k, device=x.device)[:, None]
    ghost = ((rows < k) & bool(top_d)) | ((rows >= m + k) & bool(bot_d))
    keep = torch.where(ghost, 0, 1).to(x.dtype)
    for _ in range(k):
        zr = torch.zeros_like(x[:1])
        x = _apply3x3(torch.cat([zr, x, zr], dim=0), w) * keep
    return x[k:k + m]


def _check_kernel_args(block, *halos):
    for t in (block,) + halos:
        if t.device != block.device:
            raise ValueError("block and halos must share one device")
        if t.dtype != torch.float32:
            raise TypeError(f"the stencil kernels take float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the stencil kernels need contiguous tensors")
    if block.device.type != "cuda":
        raise ValueError(f"the stencil kernels run on CUDA, not "
                         f"{block.device}")


def _weights_arg(w):
    return (ctypes.c_float * 9)(*[v for row in w for v in row])


_fns: dict[str, object] = {}


def _fn(name: str, nints: int):
    f = _fns.get(name)
    if f is None:
        f = getattr(kbuild.load("stencil"), name)
        f.restype = ctypes.c_int
        # the multistep entry takes its route and grid after the weights
        tail = [ctypes.c_int] * 3 if name == "da_stencil_multistep" else []
        f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * nints + \
            [ctypes.POINTER(ctypes.c_float)] + tail + \
            [ctypes.c_int, ctypes.c_void_p]
        _fns[name] = f
    return f


def stencil3x3_block(block: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                     weights=LAPLACIAN_3X3) -> torch.Tensor:
    """One weighted 3x3 step on a local (m, n) block:
    ``out[i,j] = sum_ab w[a][b] * x[i-1+a, j-1+b]``, with the (1, n) halo
    rows ``lo``/``hi`` beyond the block and a zero column edge."""
    w = _canon_weights(weights)
    m, n = block.shape
    if tuple(lo.shape) != (1, n) or tuple(hi.shape) != (1, n):
        raise ValueError(f"halo rows must be (1, {n}); got "
                         f"{tuple(lo.shape)}, {tuple(hi.shape)}")
    if block.device.type == "cpu":
        return _apply3x3(torch.cat([lo, block, hi], dim=0), w)
    _check_kernel_args(block, lo, hi)
    out = torch.empty_like(block)
    if out.numel() == 0:
        return out
    rc = _fn("da_stencil_step", 2)(
        block.data_ptr(), lo.data_ptr(), hi.data_ptr(), out.data_ptr(), m, n,
        _weights_arg(w), block.device.index,
        torch.cuda.current_stream(block.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"stencil kernel launch failed: CUDA error {rc}")
    kbuild.count("stencil_step")
    return out


def stencil5_block(block, lo, hi):
    """One 5-point Laplacian step (``stencil3x3_block`` with the Laplacian)."""
    return stencil3x3_block(block, lo, hi, LAPLACIAN_3X3)


def stencil3x3_multistep(block: torch.Tensor, lo: torch.Tensor,
                         hi: torch.Tensor, k: int, top_dirichlet,
                         bot_dirichlet, weights=LAPLACIAN_3X3) -> torch.Tensor:
    """``k`` weighted 3x3 steps on a local (m, n) block in one launch.

    ``lo``/``hi``: the (k, n) step-0 halo slabs from the neighbouring ranks
    (zeros at the global edge).  ``top_dirichlet``/``bot_dirichlet``: true
    when this block's top/bottom edge is the global zero boundary."""
    w = _canon_weights(weights)
    m, n = block.shape
    k = int(k)
    if k < 1:
        raise ValueError(f"k must be >= 1; got {k}")
    if tuple(lo.shape) != (k, n) or tuple(hi.shape) != (k, n):
        raise ValueError(f"halo slabs must be ({k}, {n}); got "
                         f"{tuple(lo.shape)}, {tuple(hi.shape)}")
    if block.device.type == "cpu":
        return _multistep_plain(block, lo, hi, k, top_dirichlet,
                                bot_dirichlet, w)
    _check_kernel_args(block, lo, hi)
    plan = multistep_plan(m, n, k)
    out = torch.empty_like(block)
    if out.numel() == 0:
        return out
    route = multistep_route(w)
    rc = _fn("da_stencil_multistep", 5)(
        block.data_ptr(), lo.data_ptr(), hi.data_ptr(), out.data_ptr(), m, n,
        k, int(bool(top_dirichlet)), int(bool(bot_dirichlet)),
        _weights_arg(w), kbuild.STENCIL_ROUTES.index(route), *plan.grid,
        block.device.index,
        torch.cuda.current_stream(block.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"stencil kernel launch failed: CUDA error {rc}")
    kbuild.count("stencil_multistep", route)
    return out


def stencil5_multistep(block, lo, hi, k: int, top_dirichlet, bot_dirichlet):
    """``k`` 5-point Laplacian steps in one launch."""
    return stencil3x3_multistep(block, lo, hi, k, top_dirichlet,
                                bot_dirichlet, LAPLACIAN_3X3)
