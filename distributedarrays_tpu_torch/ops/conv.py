"""Distributed 2-D convolution: a halo exchange, then one local conv a
rank.

PyTorch counterpart of ``distributedarrays_tpu/ops/conv.py``
(``dconv2d``), with its rules.  Each rank fetches ``kh // 2`` boundary
rows from its neighbours along the height with the rank-list
``halo_exchange`` (zeros at the global edges), then ``kw // 2`` columns
along the width from the row-extended blocks, so the corners arrive (JAX
``_conv_shm_jit``).  Each rank then runs one ``F.conv2d`` on its extended
block and drops the halo.  JAX's per-rank conv is
``lax.conv_general_dilated``, outside any Pallas kernel, so
``F.conv2d`` is its counterpart.

``dconv2d`` takes a ``(H, W)`` DArray with a ``(kh, kw)`` kernel, or an
NHWC ``(N, H, W, C)`` DArray with a ``(kh, kw, Cin, Cout)`` kernel (the
output keeps the grid, with Cout for C).  The conv is JAX's
``_dense_conv``: cross-correlation (no kernel flip), SAME zero padding
(``lo = (k - 1) // 2``, ``hi = k // 2`` for even k, XLA's split),
accumulated in ``promote(x, k, float32)`` (complex input keeps its
imaginary part: a complex conv is taken as real convs of the real and
imaginary parts), the result in x's dtype.  Layouts as JAX's: even,
sharded along N, height and/or width, each halo no wider than the local
block; anything else warns once, gathers the array onto its home device
(the first rank's) and convolves it there, as JAX gathers and convolves on
its default device.  float32 convs run with TF32 off, as the JAX CPU
reference computes.

In a job of several controller processes the halo exchange is the
cross-process ``halo_exchange`` (one exchange a phase, zeros at the
global edges) and each process convolves its own ranks' blocks; the
other cells of the result are placeholders.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..darray import DArray, as_tensor, darray_from_cuts, from_global
from ..parallel.collectives import _halo_lines
from ..utils.debug import warn_once
from .broadcast import result_dtype
from .mapreduce import _even_shared_layout

__all__ = ["dconv2d"]


def _conv_real(x: torch.Tensor, w: torch.Tensor, pads) -> torch.Tensor:
    """``F.conv2d`` of NCHW ``x`` and OIHW ``w`` after zero padding
    ``pads`` (F.pad order), TF32 off."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        return F.conv2d(F.pad(x, pads), w)
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _dense_conv(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The SAME zero-padded conv of a whole ``(H, W)`` or ``(N, H, W, C)``
    tensor (JAX ``_dense_conv``), on ``x``'s device."""
    acc = result_dtype(x, k, torch.empty((), dtype=torch.float32))
    # read on the kernel's own device: x may be a placeholder in a job
    kimag = acc.is_complex and bool(k.to(acc).imag.any())
    k = k.to(x.device)
    if x.ndim == 2:
        xi, w = x[None, None], k[None, None]
    else:
        xi, w = x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1)
    kh, kw = w.shape[2], w.shape[3]
    pads = ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2)
    if acc.is_complex:
        real = acc.to_real()
        xr, xim = xi.to(acc).real.to(real), xi.to(acc).imag.to(real)
        wc = w.to(acc)
        wr, wim = wc.real.to(real), wc.imag.to(real)
        re = _conv_real(xr, wr, pads)
        im = _conv_real(xim, wr, pads)
        if kimag:
            re = re - _conv_real(xim, wim, pads)
            im = im + _conv_real(xr, wim, pads)
        out = torch.complex(re, im)
    else:
        out = _conv_real(xi.to(acc), w.to(acc), pads)
    out = out[0, 0] if x.ndim == 2 else out.permute(0, 2, 3, 1)
    return out.to(x.dtype).contiguous()


def _exchange(blocks: dict, grid, gdim: int, halo: int) -> dict:
    """Every cell's block extended by ``halo`` slabs of its neighbours
    along grid dim ``gdim`` (the same array dim), zeros at the edges: a
    ``halo_exchange`` along each line of cells of that dim (in a job, one
    exchange for all the lines)."""
    out = {}
    lines: dict = {}
    for ci in np.ndindex(*grid):
        lines.setdefault(ci[:gdim] + ci[gdim + 1:], []).append(ci)
    lines = list(lines.values())
    got = _halo_lines([[blocks[ci] for ci in cells] for cells in lines],
                      halo, gdim, False)
    for cells, pairs in zip(lines, got):
        for ci, (lo, hi) in zip(cells, pairs):
            out[ci] = torch.cat([lo, blocks[ci], hi], dim=gdim)
    return out


def dconv2d(d: DArray, kernel) -> DArray:
    """SAME zero-padded 2-D convolution of a DArray (see the module
    docstring for the shapes it takes); the output keeps ``d``'s layout
    and dims, with Cout for C in the NHWC case."""
    if not isinstance(d, DArray):
        raise TypeError(f"expected DArray, got {type(d).__name__}")
    k = as_tensor(kernel)
    if d.ndim == 2:
        if k.ndim != 2:
            raise ValueError(f"(H, W) input needs a (kh, kw) kernel, "
                             f"got {tuple(k.shape)}")
        hdim = 0
    elif d.ndim == 4:
        if k.ndim != 4:
            raise ValueError(f"(N, H, W, C) input needs a (kh, kw, Cin, "
                             f"Cout) kernel, got {tuple(k.shape)}")
        if k.shape[2] != d.dims[3]:
            raise ValueError(f"kernel Cin {k.shape[2]} != input C "
                             f"{d.dims[3]}")
        hdim = 1
    else:
        raise ValueError(f"dconv2d expects a 2-D or 4-D (NHWC) DArray, "
                         f"got ndim {d.ndim}")
    d._check_open()
    hh, hw = int(k.shape[0]) // 2, int(k.shape[1]) // 2
    wdim = hdim + 1
    grid = d.grid
    p, pw = grid[hdim], grid[wdim]
    sharded = {i for i, g in enumerate(grid) if g > 1}
    free = {0, hdim, wdim} if d.ndim == 4 else {hdim, wdim}
    eligible = (_even_shared_layout((d,)) and sharded <= free
                and (p == 1 or d.dims[hdim] // p >= hh)
                and (pw == 1 or d.dims[wdim] // pw >= hw))
    if eligible:
        # in a job another process's cells are placeholders: shapes only
        blocks = {ci: d._parts[ci] for ci in d.cells()}
        if p > 1 and hh:
            blocks = _exchange(blocks, grid, hdim, hh)
        if pw > 1 and hw:
            blocks = _exchange(blocks, grid, wdim, hw)
        parts = np.empty(grid, dtype=object)
        for ci, xp in blocks.items():
            y = _dense_conv(xp, k)
            if p > 1 and hh:
                y = y.narrow(hdim, hh, y.shape[hdim] - 2 * hh)
            if pw > 1 and hw:
                y = y.narrow(wdim, hw, y.shape[wdim] - 2 * hw)
            parts[ci] = y.contiguous()
        cuts = [list(c) for c in d.cuts]
        if d.ndim == 4:
            cuts[3] = [0, int(k.shape[3])]
        return DArray(parts, d.pids.copy(), cuts)
    warn_once(f"dconv2d-host-{grid}-{d.ndim}",
              f"dconv2d: layout (grid {grid}) is not eligible for "
              "the halo-exchange path (needs an even layout sharded only "
              "along N/height/width, with each halo fitting the local "
              "block); gathering onto the first rank's device for a dense "
              "conv")
    res = _dense_conv(d.full(), k)
    procs = [int(q) for q in d.pids.flat]
    if tuple(res.shape) == d.dims:
        return darray_from_cuts(res, procs, d.cuts)
    return from_global(res, procs, list(grid))
