"""Distributed FFTs on DArrays by the all-to-all transpose algorithm.

PyTorch counterpart of ``distributedarrays_tpu/ops/fft.py`` (``dfft``,
``difft``, ``dfft2``, ``difft2``), with its layout rules.  An FFT along a
dim each rank holds whole is one local ``torch.fft`` per rank (JAX's
``jnp.fft`` runs outside any Pallas kernel, so cuFFT through
``torch.fft`` is its counterpart).  An FFT along the sharded dim of a
matrix is an all-to-all that makes the transform dim whole on every
rank, the local FFT, and an all-to-all back (JAX ``_fft_shm_jit``).  A
sharded DVector whose length n is divisible by p**2 takes the four-step
(Bailey) decomposition with three all-to-alls (JAX ``_fft1d_shm_jit``).

Every all-to-all is ``ops/cuda_collectives.ring_all_to_all``: on CUDA
tensors the K11 copy kernel, one launch a card, which raises rather than
fall back; on CPU tensors its plain version.  The blocks are complex64.
In a job of several controller processes each all-to-all is its
cross-process form (one exchange, a copy launch a process on the card),
each process transforms its own ranks' blocks, and the host path reads
the array by ``multihost.fetch_regions``.

The compiled path takes the layouts JAX's ``_fft_impl`` takes: an even
layout sharded on at most one dim, and, when the transform dim is the
sharded one, the first other dim divisible by p (a matrix) or n % p**2
== 0 with n < 2**31 (a DVector).  Any other layout warns once and
transforms on the host with numpy, keeping the input's cuts.  Results
are complex64, as JAX's with 64-bit types off.

The four-step twiddle ``exp(-+2 pi i k1 j2 / n)`` takes its phases in
float64 from exact integer products (JAX forms the phase from an int32
product and a float32 divide) for two small tables, whose complex64
entries multiply into the data (``_twiddle``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..darray import DArray, darray_from_cuts
from ..utils.debug import warn_once
from .cuda_collectives import ring_all_to_all
from .mapreduce import _even_shared_layout

__all__ = ["dfft", "difft", "dfft2", "difft2"]


def _sharded_dim(d: DArray):
    """The one grid dim with more than one chunk, or None; raises
    ``ValueError`` for a grid split along several dims."""
    dims = [i for i, g in enumerate(d.grid) if g > 1]
    if len(dims) > 1:
        raise ValueError("multi-dim grid")
    return dims[0] if dims else None


def _eligible(d: DArray, ax: int):
    """``(eligible, sharded dim)`` by JAX's ``_fft_impl`` rules."""
    try:
        shard_dim = _sharded_dim(d)
    except ValueError:
        return False, None
    ok = _even_shared_layout((d,))
    if ok and shard_dim is not None and ax == shard_dim:
        p = d.pids.size
        if d.ndim == 1:
            ok = d.dims[0] % (p * p) == 0 and d.dims[0] < 2 ** 31
        else:
            other = next(i for i in range(d.ndim) if i != ax)
            ok = d.dims[other] % p == 0
    return ok, shard_dim


def _fft_sharded(blocks, ax: int, op) -> list:
    """The FFT along the sharded dim ``ax`` of a matrix: all-to-all so that
    ``ax`` is whole on every rank (split along the first other dim), the
    local FFT, and the all-to-all back."""
    other = next(i for i in range(blocks[0].ndim) if i != ax)
    y = ring_all_to_all(blocks, other, ax)
    y = [op(t, dim=ax).contiguous() for t in y]
    return ring_all_to_all(y, ax, other)


def _phases(k1: int, js: torch.Tensor, n: int, inverse: bool):
    """``exp(-+2 pi i k1 j / n)`` for the int64 ``js`` as complex64, the
    phase in float64 from the exact product ``k1 j`` reduced mod n."""
    ph = ((k1 * js) % n).to(torch.float64) * (
        (2 if inverse else -2) * math.pi / n)
    return torch.polar(torch.ones_like(ph), ph).to(torch.complex64)


def _twiddle(k1: int, n2: int, n: int, inverse: bool, dev):
    """The twiddle ``exp(-+2 pi i k1 j2 / n)``, j2 < n2, as two tables
    ``(hi, lo)`` with ``tw[a * B + b] = hi[a] * lo[b]`` (B the largest
    power of two up to 4096 dividing n2): small tables whose phases are
    exact in float64, multiplied into the data in complex64 instead of a
    whole-length table (one more rounding: within 2.5e-7 of the float64
    twiddle)."""
    b = math.gcd(n2, 1 << 12)
    a = torch.arange(n2 // b, dtype=torch.int64, device=dev)
    lo = torch.arange(b, dtype=torch.int64, device=dev)
    return _phases(k1, a * b, n, inverse), _phases(k1, lo, n, inverse)


def _fft_four_step(blocks, n: int, inverse: bool, op) -> list:
    """The four-step FFT of a DVector of length n over the p ranks' blocks
    (n % p**2 == 0): the vector as a row-major (p, n/p) matrix whose row r
    is rank r's block; a length-p FFT down the columns (all-to-all in,
    FFT, all-to-all back), the twiddle, a length-n/p FFT along the rows,
    and the transpose shuffle (one more all-to-all and a local
    transpose).  Three all-to-alls."""
    p = len(blocks)
    n2 = n // p
    a = [b.reshape(1, n2) for b in blocks]
    b = ring_all_to_all(a, 1, 0)                          # (p, n2/p)
    b = [op(t, dim=0).contiguous() for t in b]
    b = ring_all_to_all(b, 0, 1)                          # (1, n2)
    c = []
    for r, t in enumerate(b):
        hi, lo = _twiddle(r, n2, n, inverse, t.device)
        tw = t.view(hi.shape[0], lo.shape[0]) * hi[:, None] * lo[None, :]
        c.append(op(tw.view(1, n2), dim=1).contiguous())
    e = ring_all_to_all(c, 1, 0)                          # (p, n2/p)
    return [t.t().reshape(n2).contiguous() for t in e]


def _fft_impl(d: DArray, ax: int, inverse: bool) -> DArray:
    if not isinstance(d, DArray):
        raise TypeError(f"expected DArray, got {type(d).__name__}")
    ax = ax + d.ndim if ax < 0 else ax
    if not 0 <= ax < d.ndim:
        raise ValueError(f"axis out of range for ndim {d.ndim}")
    d._check_open()
    op = torch.fft.ifft if inverse else torch.fft.fft
    ok, shard_dim = _eligible(d, ax)
    if ok:
        cells = d.cells()
        # in a job another process's cells are placeholders: shapes only
        blocks = [d._parts[ci].to(torch.complex64).contiguous()
                  for ci in cells]
        if shard_dim is None or ax != shard_dim:
            out = [op(b, dim=ax) for b in blocks]
        elif d.ndim == 1:
            out = _fft_four_step(blocks, d.dims[0], inverse, op)
        else:
            out = _fft_sharded(blocks, ax, op)
        parts = np.empty(d.grid, dtype=object)
        for ci, t in zip(cells, out):
            parts[ci] = t.contiguous()
        return DArray(parts, d.pids.copy(), d.cuts)
    rule = ("a length divisible by p**2 for the four-step path"
            if d.ndim == 1 else
            "the repartition dim divisible by the shard count")
    warn_once(f"dfft-host-{d.grid}-{d.ndim}-{ax}",
              f"dfft: layout (grid {d.grid}, dims {d.dims}, "
              f"axis {ax}) is not eligible for the compiled all_to_all "
              f"path (needs an even layout, a single sharded dim, and "
              f"{rule}); gathering to host for a numpy FFT")
    full = np.asarray(d)
    res = (np.fft.ifft if inverse else np.fft.fft)(full, axis=ax)
    # numpy's complex128, held to complex64 as JAX holds it with x64 off
    return darray_from_cuts(res.astype(np.complex64),
                            [int(q) for q in d.pids.flat], d.cuts)


def dfft(d: DArray, axis: int = -1) -> DArray:
    """Distributed 1-D FFT along ``axis`` (complex64, same layout): a
    resident axis is one local FFT a rank; a sharded matrix axis two
    all-to-alls around it; a sharded DVector the four-step decomposition
    (three all-to-alls) when ``len(d) % p**2 == 0``."""
    return _fft_impl(d, axis, inverse=False)


def difft(d: DArray, axis: int = -1) -> DArray:
    """Distributed inverse 1-D FFT along ``axis`` (see ``dfft``)."""
    return _fft_impl(d, axis, inverse=True)


def dfft2(d: DArray) -> DArray:
    """Distributed 2-D FFT of a matrix DArray: along dim 1, then dim 0."""
    if d.ndim != 2:
        raise ValueError(f"dfft2 needs a 2-D DArray, got ndim {d.ndim}")
    return _twice(d, 1, 0, inverse=False)


def difft2(d: DArray) -> DArray:
    """Distributed 2-D inverse FFT (see ``dfft2``)."""
    if d.ndim != 2:
        raise ValueError(f"difft2 needs a 2-D DArray, got ndim {d.ndim}")
    return _twice(d, 0, 1, inverse=True)


def _twice(d: DArray, first: int, second: int, inverse: bool) -> DArray:
    """The FFT along ``first`` and then along ``second``; the intermediate
    DArray is closed."""
    mid = _fft_impl(d, first, inverse)
    try:
        return _fft_impl(mid, second, inverse)
    finally:
        mid.close()
