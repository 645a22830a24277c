"""Halo-exchange stencil programs on a row-distributed DArray, and the
Game of Life.

PyTorch counterpart of ``stencil3x3``/``stencil5``/``stencil5_step`` and
``life``/``life_step``/``life2d`` in
``distributedarrays_tpu/models/stencil.py``.  The grid is row-distributed
over a (p, 1) rank grid; every step exchanges halo rows between the rank
tensors (``parallel.collectives.halo_exchange``) and updates each rank's
block.  Where the JAX package rolls the steps into one ``lax.scan`` inside
``shard_map``, here the steps are a Python loop over eager per-rank calls.

``use_kernel`` picks the hand-written CUDA kernels (``ops/cuda_stencil``)
or the plain formulation.  By default the kernels run for CUDA tensors and
the plain steps for CPU tensors.  The kernels take float32, float16,
bfloat16, int32, int8, uint8, int16, uint16, uint32 and bool
(``cuda_stencil.supports``), as the JAX package's Pallas kernel takes any
dtype but complex64 (for which it raises ``NotImplementedError``: there
is no TPU kernel to port); CUDA tensors of complex64 raise ``TypeError``
unless the caller asks for the plain steps with ``use_kernel=False``.  The
choice is made from the device and dtype before any launch.  Each weight
is cast to the grid's dtype, so the Laplacian (``stencil5``) raises
numpy's ``OverflowError`` on an unsigned grid, as in the JAX package; an
unsigned grid takes nonnegative weights, on either route.  uint16 and
uint32, which torch does not add, take the plain steps and the Life rule
in the next wider signed type, wrapped back as JAX wraps.  With the
kernels, ``iters > 1`` runs temporal blocking: ``temporal`` steps per
launch with ``temporal``-deep halos.  The auto depth is the JAX
package's rule, ``min(iters, 8, m_local)``, engaged only when it reaches
3; an explicit depth must be at most ``m_local`` and at most the kernel's
``MAX_K``.  The kernels sum each
cell's taps in the plain order, so temporal blocking returns exactly the
per-step result.
"""

from __future__ import annotations

import numpy as np
import torch

from ..darray import DArray
from ..ops.broadcast import _WIDE
from ..ops.cuda_stencil import (LAPLACIAN_3X3, MAX_K, _apply3x3,
                                _canon_weights, stencil3x3_block,
                                stencil3x3_multistep, supports)
from ..parallel.collectives import halo_exchange, halo_exchange_2d, run_spmd

__all__ = ["stencil5_step", "stencil5", "stencil3x3", "life", "life_step",
           "life2d"]


def _row_blocks(d: DArray) -> list[torch.Tensor]:
    n = d.pids.size
    if d.pids.ndim != 2 or d.pids.shape[1] != 1 or d.dims[0] % n != 0:
        raise ValueError(
            "stencil programs need a row-sharded even layout: "
            f"dist=({n},1) with rows divisible; got grid {d.pids.shape} "
            f"for dims {d.dims}")
    return [d.part((r, 0)) for r in range(n)]


def _step(blocks, w, use_kernel):
    halos = halo_exchange(blocks, halo=1, dim=0, wrap=False)
    if use_kernel:
        return [stencil3x3_block(b, lo, hi, w)
                for b, (lo, hi) in zip(blocks, halos)]
    return [_apply3x3(torch.cat([lo, b, hi], dim=0), w)
            for b, (lo, hi) in zip(blocks, halos)]


def _multistep(blocks, k, w):
    halos = halo_exchange(blocks, halo=k, dim=0, wrap=False)
    nr = len(blocks)
    return [stencil3x3_multistep(b, lo, hi, k, r == 0, r == nr - 1, w)
            for r, (b, (lo, hi)) in enumerate(zip(blocks, halos))]


def _use_kernel(device_type: str, dtype, use_kernel) -> bool:
    """Whether blocks on ``device_type`` of ``dtype`` take the kernels:
    ``use_kernel`` if given, else CUDA tensors.  CUDA tensors of a dtype the
    kernels do not take raise ``TypeError`` unless ``use_kernel`` is
    False; on CPU tensors the wrappers take their plain versions, which
    take any dtype."""
    on_card = device_type == "cuda" if use_kernel is None else use_kernel
    if on_card and device_type == "cuda" and not supports(dtype):
        raise TypeError(f"the stencil kernels do not take {dtype} (nor does "
                        "the TPU kernel they port); pass use_kernel=False "
                        "for the plain steps")
    return bool(on_card)


def _depth(iters, m_local, temporal):
    if temporal is None:
        kt = min(iters, 8, m_local)
        return kt if kt > 2 else 1
    kt = max(1, min(int(temporal), iters))
    if kt > 1 and (kt > m_local or kt > MAX_K):
        raise ValueError(
            f"temporal={temporal} unsupported for this layout (local block "
            f"of {m_local} rows; the kernel takes at most {MAX_K} steps)")
    return kt


def stencil3x3(d: DArray, weights, iters: int = 1,
               use_kernel: bool | None = None,
               temporal: int | None = None) -> DArray:
    """``iters`` weighted 3x3 steps with zero boundary:
    ``out[i,j] = sum_ab w[a][b] * x[i-1+a, j-1+b]``, each weight cast to
    ``d``'s dtype first.  The result has ``d``'s layout and dtype.  On the
    card the kernels run for the dtypes they take and other dtypes raise
    ``TypeError`` unless ``use_kernel=False`` (see the module docstring)."""
    w = _canon_weights(weights)
    iters = int(iters)
    blocks = _row_blocks(d)
    use_kernel = _use_kernel(blocks[0].device.type, d.dtype, use_kernel)
    kt = 1
    if use_kernel and iters > 1:
        kt = _depth(iters, d.dims[0] // d.pids.size, temporal)
    if kt > 1:
        nfull, rem = divmod(iters, kt)
        for _ in range(nfull):
            blocks = _multistep(blocks, kt, w)
        # a 1-step remainder takes the single-step kernel
        if rem == 1:
            blocks = _step(blocks, w, True)
        elif rem:
            blocks = _multistep(blocks, rem, w)
    else:
        for _ in range(iters):
            blocks = _step(blocks, w, use_kernel)
    if iters == 0:
        blocks = [b.clone() for b in blocks]
    parts = np.empty(d.grid, dtype=object)
    for r, b in enumerate(blocks):
        parts[r, 0] = b
    return d.with_parts(parts)


def stencil5(d: DArray, iters: int = 1, use_kernel: bool | None = None,
             temporal: int | None = None) -> DArray:
    """``iters`` 5-point Laplacian steps with zero boundary (``stencil3x3``
    with the Laplacian weights)."""
    return stencil3x3(d, LAPLACIAN_3X3, iters, use_kernel, temporal)


def stencil5_step(d: DArray) -> DArray:
    """One 5-point Laplacian step with zero boundary."""
    return stencil5(d, iters=1)


# ---------------------------------------------------------------------------
# Game of Life (the reference's distributed demo)
# ---------------------------------------------------------------------------


def _life_rule(xp: torch.Tensor, dtype) -> torch.Tensor:
    """One generation of the (m, n) centre of the halo-padded block ``xp``
    ((m + 2, n + 2)): the eight neighbours summed in the block's dtype,
    born on 3, surviving on 2 or 3 (JAX ``_life_jit`` :192).  uint16 and
    uint32 are summed in the wider type (``broadcast._WIDE``) and wrapped
    back to the block's, as JAX's sum wraps."""
    wide = _WIDE.get(dtype)
    if wide is not None:
        xp = xp.to(wide)
    neigh = (xp[:-2, :-2] + xp[:-2, 1:-1] + xp[:-2, 2:] +
             xp[1:-1, :-2] + xp[1:-1, 2:] +
             xp[2:, :-2] + xp[2:, 1:-1] + xp[2:, 2:])
    if wide is not None:
        neigh = neigh.to(dtype).to(wide)
    alive = xp[1:-1, 1:-1]
    born = (alive == 0) & (neigh == 3)
    survive = (alive == 1) & ((neigh == 2) | (neigh == 3))
    return (born | survive).to(dtype)


def _life_rows(blocks: list[torch.Tensor]) -> list[torch.Tensor]:
    """One generation over a (p, 1) mesh: halo rows from the neighbours,
    zero columns at the lateral edges (JAX ``_life_jit`` :192)."""
    out = []
    for b, (lo, hi) in zip(blocks, halo_exchange(blocks, halo=1, dim=0,
                                                 wrap=False)):
        x = torch.nn.functional.pad(torch.cat([lo, b, hi], dim=0), (1, 1))
        out.append(_life_rule(x, b.dtype))
    return out


def _life_grid(grid: list[list[torch.Tensor]]) -> list[list[torch.Tensor]]:
    """One generation over a 2-D mesh through the two-phase 2-D halo (JAX
    ``_life2d_jit`` :221)."""
    padded = halo_exchange_2d(grid, halo=1, wrap=False)
    return [[_life_rule(xp, b.dtype) for xp, b in zip(prow, brow)]
            for prow, brow in zip(padded, grid)]


def life(d: DArray, iters: int = 1) -> DArray:
    """Conway's Game of Life with a dead boundary on a row-sharded even
    layout, ``iters`` generations (JAX ``models/stencil.py:265``).  Each
    generation exchanges halo rows and updates each rank's block with
    plain torch on its device; the result has ``d``'s layout and dtype."""
    _row_blocks(d)

    def many(rows):
        blocks = [r[0] for r in rows]
        for _ in range(int(iters)):
            blocks = _life_rows(blocks)
        return blocks

    parts = np.empty(d.grid, dtype=object)
    for r, b in enumerate(run_spmd(many, d.pids.tolist(), d)):
        parts[r, 0] = b if iters else b.clone()
    return d.with_parts(parts)


def life_step(d: DArray) -> DArray:
    """One generation of ``life`` (JAX ``models/stencil.py:261``)."""
    return life(d, iters=1)


def life2d(d: DArray, iters: int = 1) -> DArray:
    """The Game of Life on a grid sharded along both dims: the corners come
    through the two-phase 2-D halo (JAX ``models/stencil.py:245``).  The
    layout must be even (``ValueError`` otherwise, as in JAX)."""
    if d.ndim != 2:
        raise ValueError(f"life2d needs a 2-D grid; got dims {d.dims}")
    g0, g1 = d.grid
    if d.dims[0] % g0 or d.dims[1] % g1:
        raise ValueError(
            f"life2d needs an even layout; got grid {d.pids.shape} for "
            f"dims {d.dims}")

    def many(grid):
        for _ in range(int(iters)):
            grid = _life_grid(grid)
        return grid

    out = run_spmd(many, d.pids.tolist(), d)
    parts = np.empty(d.grid, dtype=object)
    for ci in np.ndindex(*d.grid):
        b = out[ci[0]][ci[1]]
        parts[ci] = b if iters else b.clone()
    return d.with_parts(parts)
