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

Each wrapper launches its kernel for CUDA tensors and takes the plain
version for CPU tensors; it never falls back from one to the other.  The
kernels take the dtypes of ``KERNEL_DTYPES`` (``supports``: float32,
float16, bfloat16, int32, int8, uint8, int16, uint16, uint32 and bool,
every DArray dtype the TPU kernel takes; a DArray narrows float64 and
int64 to float32 and int32; complex64, which the TPU kernel refuses too,
is left out), contiguous, on one device; the plain versions take any
dtype.  Both cast each weight to the block's dtype first, as the JAX
version does (so a negative weight raises numpy's ``OverflowError`` for
an unsigned type, in both packages), and skip a weight that is 0 before
the cast.  The kernels sum the taps in the plain version's order without
FMA contraction, rounding each product and sum to the dtype as a PyTorch
op does (integers wrap; bool multiplies as *and* and adds as *or*), so on
one device the two agree bit for bit (a unit weight, which the plain
version adds unmultiplied, the generic kernel taps multiply by one:
exact, bar a NaN's payload).  The plain versions compute uint16 and
uint32, which torch does not add, in the next wider signed type and wrap
back.

The single-step kernel gives each thread a strip of ``STEP_ROWS`` rows by
four columns, a warp 128 columns; ``step_plan`` gives its grid.  The strip
height is a compile-time constant of the kernel, which ``kbuild.DEFINES``
passes to the build and this module reads.  The multistep kernel takes
at most ``MAX_K`` steps per launch: each block holds a ``WINDOW_ROWS`` x
``WINDOW_COLS`` window in registers and writes its centre, a tile of
``WINDOW_ROWS - 2k`` x ``WINDOW_COLS - 2k`` (96 x 96 at k = 16), so the
TPU kernel's VMEM tiling limits do not apply;
``multistep_plan`` gives its grid and shared memory.  Both kernels take
the route ``multistep_route`` picks (``kbuild.STENCIL_ROUTES``): the
5-point weights (zero corners, unit edges, a nonzero centre) take a
specialisation with those taps compiled in, other weights the generic
taps.  The Laplacian's centre of -4 does not cast to an unsigned type,
but any nonzero centre takes the 5-point route: an unsigned grid reaches
it with weights such as ``((0, 1, 0), (1, 2, 1), (0, 1, 0))``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ..utils import kbuild
from .broadcast import _WIDE

__all__ = ["stencil3x3_block", "stencil5_block", "stencil3x3_multistep",
           "stencil5_multistep", "step_plan", "multistep_plan",
           "multistep_route", "supports", "LAPLACIAN_3X3", "MAX_K",
           "STEP_ROWS", "WINDOW_ROWS", "WINDOW_COLS", "KERNEL_DTYPES"]

# the 5-point Laplacian as a 3x3 stencil
LAPLACIAN_3X3 = ((0.0, 1.0, 0.0), (1.0, -4.0, 1.0), (0.0, 1.0, 0.0))

MAX_K = 16
# the kernels' element types, in the order of the C entries' dtype codes
KERNEL_DTYPES = (torch.float32, torch.float16, torch.bfloat16, torch.int32,
                 torch.int8, torch.uint8, torch.int16, torch.uint16,
                 torch.uint32, torch.bool)

# the multistep kernel's window (stencil.cu `ms`): 8 warps of 16 rows, 32
# lanes of 4 columns; its shared memory is two exchange buffers of a top
# and a bottom row per warp, each row padded by 4 zero elements either side
_WARPS = 8
WINDOW_ROWS = 16 * _WARPS
WINDOW_COLS = 32 * 4
# the single-step kernel (stencil.cu `st`): 8 warps stacked, each a strip
# of STEP_ROWS rows by 128 columns (4 a lane); the build passes it to the
# kernel
STEP_ROWS = kbuild.DEFINES["stencil"]["DA_STENCIL_STEP_ROWS"]


@dataclass(frozen=True)
class StencilPlan:
    """A stencil launch: ``grid`` (tiles across, tiles down) of
    ``tile_rows`` x ``tile_cols`` output tiles, and the shared memory a
    block uses."""
    tile_rows: int
    tile_cols: int
    grid: tuple
    smem_bytes: int


def _plan(m: int, n: int, th: int, tw: int, smem: int) -> StencilPlan:
    """Tiles of ``th`` x ``tw`` covering an (m, n) block, none wholly
    outside it."""
    grid = (max(1, -(-n // tw)), max(1, -(-m // th)))
    if grid[1] > 65535:
        raise ValueError(f"a block of {m} rows needs {grid[1]} tile rows; "
                         "the kernel's grid takes at most 65535")
    return StencilPlan(th, tw, grid, smem)


def step_plan(m: int, n: int) -> StencilPlan:
    """The single-step launch on an (m, n) block: tiles of ``STEP_ROWS *
    8`` x 128, no shared memory."""
    return _plan(m, n, STEP_ROWS * _WARPS, WINDOW_COLS, 0)


def multistep_plan(m: int, n: int, k: int, itemsize: int = 4) -> StencilPlan:
    """The launch of ``k`` steps on an (m, n) block of ``itemsize``-byte
    elements: tiles of ``WINDOW_ROWS - 2k`` x ``WINDOW_COLS - 2k``."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the multistep kernel takes 1 <= k <= {MAX_K}; "
                         f"got {k}")
    return _plan(m, n, WINDOW_ROWS - 2 * k, WINDOW_COLS - 2 * k,
                 2 * 2 * _WARPS * (WINDOW_COLS + 8) * itemsize)


def supports(dtype) -> bool:
    """Whether the kernels take blocks of ``dtype`` (``KERNEL_DTYPES``):
    every DArray dtype that the TPU kernel takes.  complex64 is not one
    (the Pallas kernel raises ``NotImplementedError`` for it), and
    ``models/stencil.py`` refuses it on the card."""
    return dtype in KERNEL_DTYPES


def _masks(w) -> tuple[int, int]:
    """The zero and unit masks of canonical weights ``w`` (bit a*3+b), from
    the weights before any cast, as the plain version tests them."""
    flat = [v for row in w for v in row]
    return (sum(1 << i for i, v in enumerate(flat) if v == 0.0),
            sum(1 << i for i, v in enumerate(flat) if v == 1.0))


def multistep_route(weights) -> str:
    """The route of both kernels: ``"five_point"`` for zero corners, unit
    edges and a nonzero centre (the Laplacian's shape), else
    ``"generic"``.  Decided from the zero and unit masks (``_masks``),
    which the wrappers pass to the C entries and which the entries test
    the route against, so the two always agree."""
    skip, unit = _masks(_canon_weights(weights))
    five = ((skip & 0x145) == 0x145 and (unit & 0xaa) == 0xaa
            and not skip & 0x10)
    return "five_point" if five else "generic"


def _canon_weights(weights) -> tuple:
    """Validate and canonicalize 3x3 weights to a tuple of float rows."""
    w = np.asarray(weights, dtype=np.float64)
    if w.shape != (3, 3):
        raise ValueError(f"stencil weights must be 3x3; got {w.shape}")
    return tuple(tuple(float(v) for v in row) for row in w)


def _typed(wv: float, dtype: torch.dtype):
    """The weight ``wv`` in ``dtype``, as numpy's ``dtype.type(wv)`` gives
    it: rounded once to a float type, truncated toward zero for an integer
    type; as a Python number, so that ``wv * t`` keeps ``t``'s dtype."""
    if dtype == torch.bfloat16:      # numpy has no bfloat16
        return torch.tensor(wv, dtype=dtype).item()
    return torch.empty(0, dtype=dtype).numpy().dtype.type(wv).item()


def _apply3x3(ext: torch.Tensor, w) -> torch.Tensor:
    """The plain step on row-extended ``ext`` ((r + 2, n): one neighbour row
    above and below the r output rows), zero column edge.  Zero weights are
    skipped and unit weights not multiplied, as in the JAX version, which
    also casts each other weight to ``ext``'s dtype before it multiplies
    (``ext.dtype.type(wv) * t``).  uint16 and uint32, which torch does not
    add, are computed in the next wider signed type (``broadcast._WIDE``)
    and wrapped back, as JAX's arithmetic wraps them."""
    dt = ext.dtype
    wide = _WIDE.get(dt)
    if wide is None:
        return _taps(ext, w, dt)
    return _taps(ext.to(wide), w, dt).to(dt)


def _taps(ext: torch.Tensor, w, dt: torch.dtype) -> torch.Tensor:
    """``_apply3x3`` in ``ext``'s dtype with the weights cast to ``dt``."""
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
            term = t if wv == 1.0 else _typed(wv, dt) * t
            acc = term if acc is None else acc + term
    if acc is None:
        acc = torch.zeros_like(ext[1:-1])
    return acc


def _multistep_plain(block, lo, hi, k, top_d, bot_d, w):
    """k plain steps on the extended block [lo; block; hi], re-zeroing the
    rows beyond the domain after each step when its Dirichlet flag is set.
    uint16 and uint32 take the k steps in the wider type and wrap once at
    the end (wrapping is a ring map: the same as after every step)."""
    m, dt = block.shape[0], block.dtype
    x = torch.cat([lo, block, hi], dim=0)               # (m + 2k, n)
    x = x.to(_WIDE.get(dt, dt))
    rows = torch.arange(m + 2 * k, device=x.device)[:, None]
    ghost = ((rows < k) & bool(top_d)) | ((rows >= m + k) & bool(bot_d))
    keep = torch.where(ghost, 0, 1).to(x.dtype)
    for _ in range(k):
        zr = torch.zeros_like(x[:1])
        x = _taps(torch.cat([zr, x, zr], dim=0), w, dt) * keep
    return x[k:k + m].to(dt)


def _check_kernel_args(block, *halos):
    if not supports(block.dtype):
        raise TypeError(f"the stencil kernels take {_names()}, got "
                        f"{block.dtype}")
    for t in (block,) + halos:
        if t.device != block.device:
            raise ValueError("block and halos must share one device")
        if t.dtype != block.dtype:
            raise TypeError(f"block and halos must share one dtype; got "
                            f"{block.dtype} and {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the stencil kernels need contiguous tensors")
    if block.device.type != "cuda":
        raise ValueError(f"the stencil kernels run on CUDA, not "
                         f"{block.device}")


def _names() -> str:
    return ", ".join(str(d).removeprefix("torch.") for d in KERNEL_DTYPES)


def _weights_arg(w, dtype: torch.dtype) -> torch.Tensor:
    """The 9 weights row-major in ``dtype``, as the plain version casts
    them (``_typed``), on the host for the C entry to copy."""
    return torch.tensor([_typed(v, dtype) for row in w for v in row],
                        dtype=dtype)


_fns: dict[str, object] = {}


def _fn(name: str, nints: int):
    f = _fns.get(name)
    if f is None:
        f = getattr(kbuild.load("stencil"), name)
        f.restype = ctypes.c_int
        # the tensors, ``nints`` ints ending in the dtype code, the weights
        # and their zero and unit masks; then the route, the grid, the
        # device and stream
        f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * nints + \
            [ctypes.c_void_p] + [ctypes.c_uint] * 2 + [ctypes.c_int] * 4 + \
            [ctypes.c_void_p]
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
    plan = step_plan(m, n)
    out = torch.empty_like(block)
    if out.numel() == 0:
        return out
    route = multistep_route(w)
    wt = _weights_arg(w, block.dtype)
    rc = _fn("da_stencil_step", 3)(
        block.data_ptr(), lo.data_ptr(), hi.data_ptr(), out.data_ptr(), m, n,
        KERNEL_DTYPES.index(block.dtype), wt.data_ptr(), *_masks(w),
        kbuild.STENCIL_ROUTES.index(route), *plan.grid,
        block.device.index,
        torch.cuda.current_stream(block.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"stencil kernel launch failed: CUDA error {rc}")
    kbuild.count("stencil_step", route)
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
    plan = multistep_plan(m, n, k, block.element_size())
    out = torch.empty_like(block)
    if out.numel() == 0:
        return out
    route = multistep_route(w)
    wt = _weights_arg(w, block.dtype)
    rc = _fn("da_stencil_multistep", 6)(
        block.data_ptr(), lo.data_ptr(), hi.data_ptr(), out.data_ptr(), m, n,
        k, int(bool(top_dirichlet)), int(bool(bot_dirichlet)),
        KERNEL_DTYPES.index(block.dtype), wt.data_ptr(), *_masks(w),
        kbuild.STENCIL_ROUTES.index(route), *plan.grid,
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
