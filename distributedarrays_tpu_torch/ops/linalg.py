"""Distributed GEMM and transpose over DArrays.

PyTorch counterpart of ``matmul``/``mul_into``, ``dtranspose``/``DArray.T``,
``_gemm_layout``, ``_impl_choice`` and ``tune_matmul_impl`` in
``distributedarrays_tpu/ops/linalg.py``.

- The result layout and the ``out=`` row-cuts contract are the JAX
  package's (which follow the reference ``linalg.jl``).
- On one rank, the product is ``torch.matmul`` by default, as the JAX
  default is XLA's.  When the tuning registry says ``"pallas"`` for the
  shape (the JAX registry's name for the hand-written kernel), a float
  GEMM goes to the CUDA block GEMM kernel (``ops/cuda_gemm``).
  ``tune_matmul_impl`` times both and records the winner.
- On several ranks, each rank computes its output chunk from the A row
  panel and the B column panel, assembled on its device, with
  ``torch.matmul`` (a plain product outside any kernel).  The JAX
  package's ring, SUMMA and Cannon schedules are not ported yet.

float32 products run in true float32: TF32 is switched off around every
``torch.matmul`` here, as the JAX CPU reference computes.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from .. import layout as L
from ..darray import (DArray, SubDArray, as_tensor, distribute,
                      from_global, resolve_layout)
from ..utils import autotune
from .cuda_gemm import cuda_matmul

__all__ = ["matmul", "mul_into", "dtranspose", "tune_matmul_impl"]


@contextlib.contextmanager
def _true_f32():
    """float32 products in float32, not TF32."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _torch_matmul(a, b):
    with _true_f32():
        return torch.matmul(a, b)


# ---------------------------------------------------------------------------
# transpose
# ---------------------------------------------------------------------------


def dtranspose(d: DArray) -> DArray:
    """Materialized transpose with the reversed layout: rank ``pids[i, j]``
    of ``d`` holds cell ``(j, i)`` of the result."""
    if d.ndim != 2:
        raise ValueError("dtranspose expects a 2-D DArray")
    procs = [int(p) for p in d.pids.T.flat]
    dist = list(reversed(d.grid))
    _, pids, cuts = resolve_layout(tuple(reversed(d.dims)), procs, dist)
    if cuts == [d.cuts[1], d.cuts[0]]:
        parts = np.empty(pids.shape, dtype=object)
        for i, j in np.ndindex(*pids.shape):
            parts[i, j] = d.part((j, i)).t().contiguous()
        return DArray(parts, pids, cuts)
    return from_global(d.full().t(), procs, dist)


DArray.T = property(dtranspose)


# ---------------------------------------------------------------------------
# GEMM
# ---------------------------------------------------------------------------


def _gemm_layout(A: DArray, B):
    """Result grid of C = A*B: C's row chunking follows A's row grid and its
    column chunking B's column grid, clipped to the available ranks."""
    ra = A.grid[0]
    cb = B.grid[1] if isinstance(B, DArray) and B.ndim == 2 else 1
    procs = [int(p) for p in A.pids.flat]
    procs = procs + [p for p in L.all_ranks() if p not in procs]
    while ra * cb > len(procs) and cb > 1:
        cb -= 1
    while ra * cb > len(procs) and ra > 1:
        ra -= 1
    return procs, (ra, cb)


def _impl_key(m, n, k, a_dtype, b_dtype):
    return autotune.device_key_for(m, n, k, str(a_dtype), str(b_dtype))


def _impl_choice(m, n, k, a_dtype, b_dtype) -> str:
    """The registry's GEMM implementation for this shape: ``"pallas"`` (the
    hand-written kernel) or ``"torch"`` (the default)."""
    return autotune.get("matmul_impl",
                        _impl_key(m, n, k, a_dtype, b_dtype)) or "torch"


def _default_impl_timer(op, a, b):
    """Best of 3 wall-clock runs after a warm-up, synchronised."""
    sync = torch.cuda.synchronize if a.is_cuda else (lambda: None)
    op(a, b)
    sync()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        op(a, b)
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


def tune_matmul_impl(m, n, k, dtype=torch.float32, timer=None):
    """Time ``torch.matmul`` against the CUDA GEMM kernel for an (m,k)x(k,n)
    product on rank 0's device and record the winner under
    ``matmul_impl``.  ``timer(op, a, b) -> seconds`` is injectable.
    Returns ``(winner, {impl: seconds})``."""
    dev = L.device_of(0)
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((m, k), generator=g, device=dev).to(dtype)
    b = torch.randn((k, n), generator=g, device=dev).to(dtype)
    timer = timer or _default_impl_timer
    results = {}
    for name, op in (("torch", _torch_matmul), ("pallas", cuda_matmul)):
        results[name] = timer(op, a, b)
    winner = min(results, key=results.get)
    autotune.record("matmul_impl", _impl_key(m, n, k, a.dtype, b.dtype),
                    winner)
    return winner, results


def _panel(d: DArray, bounds, dev) -> torch.Tensor:
    """Region ``bounds`` of ``d`` on ``dev``: a view of the chunk when one
    chunk on ``dev`` holds it all, else an assembled copy."""
    ci = d.locate(*[lo for lo, _ in bounds]) if all(
        lo < hi for lo, hi in bounds) else None
    if ci is not None:
        part = d.part(ci)
        starts = [c[j] for c, j in zip(d.cuts, ci)]
        if part.device == dev and all(
                hi <= c[j + 1] for (lo, hi), c, j in zip(bounds, d.cuts, ci)):
            return part[tuple(slice(lo - s, hi - s)
                              for (lo, hi), s in zip(bounds, starts))]
    return d.region(bounds, dev)


def matmul(A, B, out: DArray | None = None, alpha=1.0, beta=0.0):
    """``C = alpha*A*B [+ beta*C]``: distributed GEMM or matvec.

    Without ``out`` the result takes ``_gemm_layout``'s grid.  With
    ``out`` the reference's contract holds (``out``'s row cuts must equal
    A's) and ``out``'s chunks are overwritten in place."""
    if isinstance(A, SubDArray):
        A = A.copy()
    if not isinstance(A, DArray):
        A = distribute(A)
    if isinstance(B, DArray):
        bshape, bt = B.dims, None
    else:
        bt = B.materialize() if isinstance(B, SubDArray) else as_tensor(B)
        bshape = tuple(bt.shape)
    if A.ndim != 2 or len(bshape) not in (1, 2):
        raise ValueError(
            f"matmul expects 2-D A and 1/2-D B, got {A.dims} @ {bshape}")
    if A.dims[1] != bshape[0]:
        raise ValueError(f"matmul dim mismatch: {A.dims} @ {bshape}")
    vec = len(bshape) == 1
    m, k = A.dims
    n = 1 if vec else bshape[1]
    b_dtype = B.dtype if bt is None else bt.dtype

    if out is not None:
        want = (m,) if vec else (m, n)
        if out.dims != want:
            raise ValueError(f"out dims {out.dims} != result dims {want}")
        if out.cuts[0] != A.cuts[0]:
            raise ValueError(
                "mul_into: out's row cuts must equal A's row cuts "
                "(reference linalg.jl:201)")
        out_dtype, pids, cuts = out.dtype, out.pids, out.cuts
    else:
        out_dtype = torch.promote_types(A.dtype, b_dtype)
        if vec:
            procs, dist = [int(p) for p in A.pids.flat], [A.grid[0]]
        else:
            procs, dist = _gemm_layout(A, B)
        _, pids, cuts = resolve_layout((m,) if vec else (m, n), procs, dist)
    if beta != 0.0 and out is None:
        raise ValueError("beta accumulation requires out=")
    plain = alpha == 1.0 and beta == 0.0
    use_kernel = (plain and not vec and pids.size == 1
                  and A.dtype in (torch.float32, torch.bfloat16)
                  and b_dtype in (torch.float32, torch.bfloat16)
                  and _impl_choice(m, n, k, A.dtype, b_dtype) == "pallas")

    results = {}
    for ci in np.ndindex(*pids.shape):
        dev = L.device_of(int(pids[ci]))
        r0, r1 = cuts[0][ci[0]], cuts[0][ci[0] + 1]
        a = _panel(A, [(r0, r1), (0, k)], dev)
        if vec:
            b = bt.to(dev) if bt is not None else B.full(dev)
        else:
            c0, c1 = cuts[1][ci[1]], cuts[1][ci[1] + 1]
            b = (bt[:, c0:c1].to(dev) if bt is not None
                 else _panel(B, [(0, k), (c0, c1)], dev))
        if use_kernel:
            res = cuda_matmul(a.contiguous(), b.contiguous())
        else:
            res = _torch_matmul(a.to(out_dtype), b.to(out_dtype))
            if not plain:
                res = alpha * res
                if beta != 0.0:
                    res = res + beta * out.part(ci)
        results[ci] = res.to(out_dtype)
    if out is not None:
        for ci, res in results.items():
            out.part(ci).copy_(res)
        return out
    parts = np.empty(pids.shape, dtype=object)
    for ci, res in results.items():
        parts[ci] = res.contiguous()
    return DArray(parts, pids, cuts)


def mul_into(C: DArray, A, B, alpha=1.0, beta=0.0) -> DArray:
    """In-place ``mul!``: ``C = alpha*A*B + beta*C``."""
    return matmul(A, B, out=C, alpha=alpha, beta=beta)


def _darray_matmul(self, other):
    if isinstance(other, (DArray, SubDArray, np.ndarray, torch.Tensor)):
        return matmul(self, other)
    return NotImplemented


def _darray_rmatmul(self, other):
    if isinstance(other, (np.ndarray, torch.Tensor)):
        return matmul(distribute(other), self)
    return NotImplemented


DArray.__matmul__ = _darray_matmul
DArray.__rmatmul__ = _darray_rmatmul
