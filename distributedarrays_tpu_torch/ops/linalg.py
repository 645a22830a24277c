"""Distributed dense linear algebra over DArrays.

PyTorch counterpart of ``distributedarrays_tpu/ops/linalg.py``: BLAS-1
(``axpy_``, ``ddot``, ``dnorm``, ``rmul_``/``lmul_`` and the diagonal
scalings), ``dtranspose``/``dadjoint``, ``matmul``/``mul_into``, the
owned-schedule dispatch with its tuners, and ``dmatmul_int8``.

- The result layout and the ``out=`` row-cuts contract are the JAX
  package's (which follow the reference ``linalg.jl``).
- On one rank, the product is ``torch.matmul`` by default, as the JAX
  default is XLA's.  When the tuning registry says ``"pallas"`` for the
  shape (the JAX registry's name for the hand-written kernel), a float
  GEMM goes to the CUDA block GEMM kernel (``ops/cuda_gemm``).
- Across controller processes (``parallel.multihost``) each process
  computes only its own result cells on the default schedule: one region
  call (``multihost.fetch_regions``, one copy launch a process on the
  card) brings the A row panels and B column panels its cells need that
  no local chunk holds, then the same per-cell ``torch.matmul`` runs (the
  JAX package's multi-process GEMM is XLA's SUMMA, no Pallas kernel).
  The ring and Cannon/SUMMA schedules stay within one process.
- On several ranks, the registry ``matmul_impl_dist`` picks an owned
  schedule as in JAX, with the JAX eligibility rules: ``"ring_ag"`` runs
  a (p,1) x (p,1) product as the ring all-gather GEMM (the K14 kernel),
  ``"summa"`` a product of two operands on one (r,c) grid as Cannon's
  double ring (square grids) or SUMMA panels; the default ``"torch"``
  computes each rank's output chunk from the A row panel and the B column
  panel, assembled on its device, with ``torch.matmul``.  A B panel that
  is the whole of a B chunked along one dim on the result's ranks is
  gathered once by the all-gather kernel (``reshard.allgather``), which is
  what GSPMD's default does.  The JAX package's silent fallback from its
  RDMA ring to the XLA ring has no counterpart: the ring runs its kernel
  on the card or raises.

float32 products run in true float32: TF32 is switched off around every
``torch.matmul`` here, as the JAX CPU reference computes.
"""

from __future__ import annotations

import contextlib
import math
import time

import numpy as np
import torch

from .. import layout as L
from .. import telemetry as _tm
from ..darray import (DArray, SubDArray, as_tensor, distribute, from_global,
                      resolve_layout)
from ..parallel import multihost
from ..parallel.reshard import allgather, plan_allgather
from ..utils import autotune
from . import collective_matmul as cm
from .broadcast import _pieces, elementwise, promote, result_dtype
from .cuda_gemm import cuda_matmul, quantized_matmul, torch_matmul
from .mapreduce import acc_dtype

__all__ = [
    "axpy_", "ddot", "dnorm", "rmul_", "lmul_", "lmul_diag", "rmul_diag",
    "matmul", "mul_into", "dtranspose", "dadjoint", "tune_matmul_impl",
    "tune_matmul_impl_dist", "tune_matmul_impl_summa", "dmatmul_int8",
]


def _shape_of(x) -> tuple:
    if isinstance(x, (DArray, SubDArray)):
        return tuple(x.shape)
    return tuple(np.shape(x))


def _host(x) -> torch.Tensor:
    """A non-DArray operand (or a whole DArray) as one tensor."""
    if isinstance(x, DArray):
        return x.full()
    if isinstance(x, SubDArray):
        return x.materialize()
    return as_tensor(x)


# ---------------------------------------------------------------------------
# BLAS-1
# ---------------------------------------------------------------------------


def axpy_(a, x, y: DArray) -> DArray:
    """``y <- a*x + y`` in place (reference ``axpy!``); the scalar takes
    ``y``'s dtype first, as in the JAX package."""
    if _shape_of(x) != tuple(y.dims):
        raise ValueError(f"axpy_: x dims {_shape_of(x)} != y dims {y.dims}")
    s = torch.tensor(a, dtype=y.dtype)

    def axpy(xv, yv):
        # each op promoted as JAX promotes a*x + y with a strong 0-d a
        ax = s.to(yv.device, result_dtype(s, xv)) * xv.to(
            result_dtype(s, xv))
        dt = result_dtype(ax, yv)
        return ax.to(dt) + yv.to(dt)
    return elementwise(axpy, x, y, out=y)


def _cell_partials(x, y, fn) -> list:
    """``fn(x piece, y piece)`` for each cell of the first DArray among
    ``x`` and ``y`` (the other aligned to its layout through the reshard
    planner), in row-major order, each on its cell's device and then moved
    to the DArray's ``home()``; one ``fn`` of the whole operands when
    neither is a DArray.  In a job each process computes its own cells'
    partials and every process gets all of them
    (``multihost.cell_values``), so the fold is one process's."""
    d = x if isinstance(x, DArray) else y if isinstance(y, DArray) else None
    if d is None:
        return [fn(_host(x), _host(y))]
    dims = tuple(d.dims)
    gx = _pieces(x, d.pids, d.cuts, dims)
    gy = _pieces(y, d.pids, d.cuts, dims)

    def part(ci):
        bounds = [(c[j], c[j + 1]) for c, j in zip(d.cuts, ci)]
        dev = L.device_of(int(d.pids[ci]))
        return fn(gx(ci, dev, bounds), gy(ci, dev, bounds))
    home = d.home()
    return [v.to(home) for v in multihost.cell_values(d, part)]


def _dot_part(a: torch.Tensor, b: torch.Tensor, dt: torch.dtype):
    """One rank's ``vdot`` of ``a`` and ``b`` in ``dt``'s accumulation
    type: any of the ANDs for bool, an int64 sum for integers (wrapped
    into ``dt`` at the end), a float32 sum for float16 and bfloat16."""
    a, b = a.reshape(-1).to(dt), b.reshape(-1).to(dt)
    if dt == torch.bool:
        return (a & b).any()
    acc = acc_dtype(dt)
    if acc == torch.int64:
        return (a.to(acc) * b.to(acc)).sum()
    return torch.vdot(a.to(acc), b.to(acc))


def ddot(x, y):
    """Distributed dot product ``sum(conj(x) * y)`` (reference ``dot``):
    per-rank partial dots, summed on the first rank's device.  The result
    takes the operands' promoted type, as ``jnp.vdot``: an integer dot
    wraps in it, and a float16 or bfloat16 dot is summed in float32 and
    rounded once.  In a job of several processes every process gets the
    same value, folded from every process's partials in cell order."""
    if _shape_of(x) != _shape_of(y):
        raise ValueError(f"ddot: dims {_shape_of(x)} != {_shape_of(y)}")
    dt = result_dtype(x, y)
    parts = _cell_partials(x, y, lambda a, b: _dot_part(a, b, dt))
    total = torch.stack(parts)
    return (total.any() if dt == torch.bool else total.sum()).to(dt)


def dnorm(x, p=2):
    """Vector ``p``-norm of the flattened array (reference ``norm``: per-rank
    partials, combined on the first rank's device; for ``p == 0`` the
    count of nonzeros).  Computed as ``jnp.linalg.norm`` computes it, so
    the result matches JAX's, overflow included: integers and bool become
    float32; the squares (``p == 2``) and powers are taken in the input
    type, and their sum is carried in float32 for float16 and bfloat16 and
    rounded once to the type before the root.  A float16 2-norm is
    therefore ``inf`` once the sum of squares passes 65504, as in JAX,
    where ``torch.linalg.vector_norm`` would scale and return a finite
    value.  In a job of several processes each process computes its own
    cells' partials and every process folds all of them in cell order."""
    dt = x.dtype if isinstance(x, DArray) else _host(x).dtype
    if not (dt.is_floating_point or dt.is_complex):
        dt = torch.float32
    real = torch.empty(0, dtype=dt).abs().dtype
    acc = acc_dtype(real)

    def partials(f):
        """``f`` of each cell's values (flattened, in the norm's type), in
        cell order on ``home()``; cells with no elements add nothing
        unless all are empty."""
        if not isinstance(x, DArray):
            return [f(_host(x).reshape(-1).to(dt))]
        live = [ci for ci in x.cells() if x._parts[ci].numel()] or \
            x.cells()[:1]
        vals = multihost.cell_values(x, lambda ci: f(
            x.part(ci).reshape(-1).to(dt)) if ci in live else None)
        return [v.to(x.home()) for v in vals if v is not None]
    if p in (np.inf, -np.inf):
        f = torch.amax if p > 0 else torch.amin
        return f(torch.stack(partials(lambda t: f(t.abs()))))

    def total(f):
        return torch.stack(partials(lambda t: f(t).to(acc).sum())).sum()
    if p == 0:
        return total(lambda t: t != 0).to(real)
    if p == 1:
        return total(torch.abs).to(real)
    if p == 2:
        return torch.sqrt(total(lambda t: (t * t.conj()).real).to(real))
    # the exponents are constants of the type, as jnp.linalg.norm makes them
    e, inv = (torch.tensor(v, dtype=real).item() for v in (p, 1.0 / p))
    return total(lambda t: t.abs() ** e).to(real) ** inv


def _scale_into(d: DArray, a, b) -> DArray:
    """``d`` rebound to ``a * b``, promoted as JAX's ``jnp.multiply`` (so
    an int32 ``d`` scaled by 2.5 becomes float32, as in JAX)."""
    f, args = promote("mul", torch.mul, (a, b))
    return elementwise(f, *args, out=d)


def rmul_(d: DArray, s) -> DArray:
    """``d <- d * s`` in place (reference ``rmul!``)."""
    return _scale_into(d, d, s)


def lmul_(s, d: DArray) -> DArray:
    """``d <- s * d`` in place (reference ``lmul!``)."""
    return _scale_into(d, s, d)


def lmul_diag(diag, d: DArray) -> DArray:
    """``d <- Diagonal(diag) * d`` in place: row i scaled by ``diag[i]``."""
    v = _host(diag)
    if tuple(v.shape) != (d.dims[0],):
        raise ValueError(f"diag length {tuple(v.shape)} != rows {d.dims[0]}")
    return _scale_into(d, v.reshape(-1, 1), d)


def rmul_diag(d: DArray, diag) -> DArray:
    """``d <- d * Diagonal(diag)`` in place: column j scaled by
    ``diag[j]``."""
    v = _host(diag)
    if tuple(v.shape) != (d.dims[-1],):
        raise ValueError(f"diag length {tuple(v.shape)} != cols {d.dims[-1]}")
    return _scale_into(d, d, v.reshape(1, -1))


# ---------------------------------------------------------------------------
# transpose / adjoint
# ---------------------------------------------------------------------------


def _transpose(d: DArray, conj: bool, name: str) -> DArray:
    """On matching cuts each rank flips its own cell (rank ``pids[i, j]``
    of ``d`` holds cell ``(j, i)`` of the result), with no exchange even
    across processes (another process's placeholder flips to one); on
    other cuts the whole array comes to every process (``full``) and each
    keeps its own chunks."""
    if d.ndim != 2:
        raise ValueError(f"{name} expects a 2-D DArray")
    d._check_open()

    def flip(t):
        t = t.t()
        return (t.conj() if conj else t).contiguous().resolve_conj()

    procs = [int(p) for p in d.pids.T.flat]
    dist = list(reversed(d.grid))
    _, pids, cuts = resolve_layout(tuple(reversed(d.dims)), procs, dist)
    if cuts == [d.cuts[1], d.cuts[0]]:
        parts = np.empty(pids.shape, dtype=object)
        for i, j in np.ndindex(*pids.shape):
            parts[i, j] = flip(d._parts[j, i])
        return DArray(parts, pids, cuts)
    return from_global(flip(d.full()), procs, dist)


def dtranspose(d: DArray) -> DArray:
    """Materialized transpose with the reversed layout: rank ``pids[i, j]``
    of ``d`` holds cell ``(j, i)`` of the result."""
    return _transpose(d, False, "dtranspose")


def dadjoint(d: DArray) -> DArray:
    """Materialized conjugate transpose, laid out as ``dtranspose``."""
    return _transpose(d, True, "dadjoint")


DArray.T = property(dtranspose)


# ---------------------------------------------------------------------------
# GEMM dispatch
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


def _impl_key(*parts):
    return autotune.device_key_for(*(str(p) for p in parts))


def _impl_choice(m, n, k, a_dtype, b_dtype) -> str:
    """The registry's one-rank GEMM: ``"pallas"`` (the hand-written kernel)
    or ``"torch"`` (the default)."""
    return autotune.get("matmul_impl",
                        _impl_key(m, n, k, a_dtype, b_dtype)) or "torch"


def _dist_impl_choice(m, n, k, p, a_dtype, b_dtype) -> str:
    """The registry's (p,1) x (p,1) GEMM: ``"ring_ag"`` (the ring kernel) or
    ``"torch"`` (the default)."""
    return autotune.get("matmul_impl_dist",
                        _impl_key(m, n, k, p, a_dtype, b_dtype)) or "torch"


def _summa_impl_choice(m, n, k, r, c, a_dtype, b_dtype) -> str:
    """The registry's 2-D-grid GEMM: ``"summa"`` (Cannon on square grids,
    SUMMA panels otherwise) or ``"torch"``; the ``rxc`` grid tag keeps it
    apart from the (p,1) entries of the same registry."""
    return autotune.get("matmul_impl_dist", _impl_key(
        m, n, k, f"{r}x{c}", a_dtype, b_dtype)) or "torch"


def _even(d: DArray) -> bool:
    return all(len({hi - lo for lo, hi in zip(c, c[1:])}) <= 1
               for c in d.cuts)


def _ring_ag_eligible(A: DArray, B, procs, dist) -> bool:
    """The 1-D shape the ring serves: A row-chunked on a (p,1) grid, B
    contraction-chunked on the same (p,1) rank list, the result row-chunked
    like A, every chunk even.  The kernel takes one float32 or bfloat16
    dtype (the JAX ring's RDMA arm has the same dtype rule).  Not in a job
    of several controller processes: the ring runs within one process
    (across processes the default schedule fetches its panels)."""
    if not isinstance(B, DArray) or A.ndim != 2 or B.ndim != 2 or \
            L.process_count() > 1:
        return False
    p = A.grid[0]
    if p < 2 or A.grid != (p, 1) or B.grid != (p, 1):
        return False
    aprocs = [int(q) for q in A.pids.flat]
    if [int(q) for q in B.pids.flat] != aprocs:
        return False
    if list(dist) != [p, 1] or [int(q) for q in procs[:p]] != aprocs:
        return False
    if A.dtype != B.dtype or A.dtype not in (torch.float32, torch.bfloat16):
        return False
    m, k = A.dims
    return m % p == 0 and k % p == 0 and _even(A) and _even(B)


def _grid2d_ok(A: DArray, B):
    """Both operands DArrays on the same ``(r, c)`` rank grid (same flat
    rank order, ``r * c >= 2``), every chunk even.  Returns ``(r, c)`` or
    None."""
    if not isinstance(B, DArray) or A.ndim != 2 or B.ndim != 2:
        return None
    r, c = A.grid
    if r * c < 2 or B.grid != (r, c):
        return None
    if [int(q) for q in B.pids.flat] != [int(q) for q in A.pids.flat]:
        return None
    if not (_even(A) and _even(B)):
        return None
    return r, c


def _square_grid_ok(A: DArray, B):
    """``_grid2d_ok`` on a square ``(g, g)`` grid, ``g >= 2``: ``g`` or
    None."""
    rc = _grid2d_ok(A, B)
    if rc is None or rc[0] != rc[1] or rc[0] < 2:
        return None
    return rc[0]


def _summa_eligible(A: DArray, B, procs, dist):
    """A and B on one ``(r, c)`` grid with ``r, c >= 2``, the result on that
    grid too, ``m % r == n % c == k % lcm(r, c) == 0``: ``(r, c)`` or
    None.  None in a job of several controller processes: Cannon and
    SUMMA run within one process."""
    rc = _grid2d_ok(A, B)
    if rc is None or L.process_count() > 1:
        return None
    r, c = rc
    if r < 2 or c < 2:
        return None
    aprocs = [int(q) for q in A.pids.flat]
    if list(dist) != [r, c] or [int(q) for q in procs[:r * c]] != aprocs:
        return None
    m, k = A.dims
    n = B.dims[1]
    if m % r or n % c or k % math.lcm(r, c):
        return None
    return rc


def _cells(d: DArray) -> list[torch.Tensor]:
    return [d.part(ci) for ci in d.cells()]


def _ring_ag_gemm(A: DArray, B: DArray, out_dtype) -> list[torch.Tensor]:
    """Rank r's output row block of the eligible (p,1) x (p,1) product, by
    the ring all-gather GEMM (the ``matmul.ring_ag`` span: ``dispatch`` is
    ``rdma`` for the ring kernel on the card, JAX's name for its remote-DMA
    ring, ``plain`` for the plain ring)."""
    cells = _cells(A)
    with (_tm.span("matmul.ring_ag", **_ring_ag_labels(A, B, out_dtype,
                                                       cells[0].is_cuda))
          if _tm.enabled() else contextlib.nullcontext()):
        return [x.to(out_dtype) for x in cm.allgather_matmul_rhs(
            cells, _cells(B))]


def _ring_ag_labels(A: DArray, B: DArray, out_dtype, on_card: bool) -> dict:
    """The ``matmul.ring_ag`` span's labels and cost stamp: B's chunks
    forwarded p - 1 hops, overlapped with the chunk products."""
    from ..telemetry import perf as _perf
    p = A.grid[0]
    m, k = A.dims
    n = B.dims[1]
    isz = A.dtype.itemsize
    return dict(ranks=p, dispatch="rdma" if on_card else "plain",
                dispatch_key=None, dispatch_source="default",
                shape=[m, k, n], dtype=str(A.dtype),
                **_perf.gemm_cost(m, n, k, isz,
                                  out_itemsize=out_dtype.itemsize,
                                  bytes_ici=(p - 1) * k * n * isz))


def _summa_gemm(A: DArray, B: DArray, out_dtype) -> list[torch.Tensor]:
    """Every rank's output block of the eligible 2-D-grid product: Cannon
    on square grids, SUMMA panels otherwise (the ``matmul.summa``
    span)."""
    r, c = A.grid
    with (_tm.span("matmul.summa", **_summa_labels(A, B, out_dtype))
          if _tm.enabled() else contextlib.nullcontext()):
        if r == c:
            res = cm.cannon_matmul(_cells(A), _cells(B), r)
        else:
            res = cm.summa_matmul(_cells(A), _cells(B), r, c)
        return [x.to(out_dtype) for x in res]


def _summa_labels(A: DArray, B: DArray, out_dtype) -> dict:
    """The ``matmul.summa`` span's labels and cost stamp: the panel moves
    carry each operand to the rest of its grid row or column."""
    from ..telemetry import perf as _perf
    r, c = A.grid
    m, k = A.dims
    n = B.dims[1]
    isz = A.dtype.itemsize
    return dict(grid=f"{r}x{c}", ranks=r * c,
                **_perf.gemm_cost(m, n, k, isz,
                                  out_itemsize=out_dtype.itemsize,
                                  bytes_ici=m * k * isz * (c - 1) // c
                                  + k * n * isz * (r - 1) // r))


def _panel(d: DArray, bounds, dev) -> torch.Tensor:
    """Region ``bounds`` of ``d`` on ``dev``: a view of the chunk when one
    chunk on ``dev`` holds it all, else an assembled copy."""
    v = _local_view(d, bounds, dev)
    return v if v is not None else d.region(bounds, dev)


def _job_panels(A: DArray, B, bt, pids, cuts, vec, k):
    """``get(cell, device)`` of each of this process's result cells' A row
    panel and B column panel (B whole for a matvec) in a job of several
    processes: every panel that no local chunk on the cell's device holds
    whole comes by one region call (``multihost.fetch_regions``, A's and
    B's panels together); a host B is cut on each process."""
    cells = list(np.ndindex(*pids.shape))
    wants = []
    for ci in cells:
        dev = L.device_of(int(pids[ci]))     # meta: another process's cell
        wants.append((A, [(cuts[0][ci[0]], cuts[0][ci[0] + 1]), (0, k)], dev))
        if bt is None:
            wants.append((B, None if vec else [
                (0, k), (cuts[1][ci[1]], cuts[1][ci[1] + 1])], dev))
    # a panel that one local chunk on its device holds is a view of it
    views = [_local_view(*w) for w in wants]
    got = multihost.fetch_regions(
        [(d, b, torch.device("meta") if v is not None else dev)
         for (d, b, dev), v in zip(wants, views)])
    have = [g if v is None else v for v, g in zip(views, got)]
    per = len(wants) // len(cells)
    panels = {ci: have[n * per:(n + 1) * per] for n, ci in enumerate(cells)}

    def get(ci, dev):
        if bt is None:
            return tuple(panels[ci])
        b = bt if vec else bt[:, cuts[1][ci[1]]:cuts[1][ci[1] + 1]]
        return panels[ci][0], b.to(dev)
    return get


def _local_view(d: DArray, bounds, dev):
    """The view of the box ``bounds`` of ``d`` in one chunk on ``dev``
    (one that this process holds), or None."""
    if dev.type == "meta" or bounds is None:
        return None
    if not all(lo < hi for lo, hi in bounds):
        return None
    ci = d.locate(*[lo for lo, _ in bounds])
    part = d._parts[ci]
    starts = [c[j] for c, j in zip(d.cuts, ci)]
    if part.device != dev or not all(
            hi <= c[j + 1] for (lo, hi), c, j in zip(bounds, d.cuts, ci)):
        return None
    return part[tuple(slice(lo - s, hi - s)
                      for (lo, hi), s in zip(bounds, starts))]


def _default_gemm(A: DArray, B, bt, pids, cuts, vec, out_dtype, use_kernel,
                  alpha=1.0, beta=0.0, out=None) -> dict:
    """Each of this process's result cells from A's row panel and B's
    column panel on its rank's device; a B that every cell needs whole and
    that is chunked along one dim on the result's ranks is gathered once
    by the all-gather kernel.  In a job of several processes the panels
    come by one region call (``_job_panels``) and each process computes
    only its own cells."""
    m, k = A.dims
    n = 1 if vec else (B.dims[1] if bt is None else bt.shape[1])
    plain = alpha == 1.0 and beta == 0.0
    if L.process_count() > 1:
        get = _job_panels(A, B, bt, pids, cuts, vec, k)
    else:
        whole = None
        ranks = sorted({int(p) for p in pids.flat})
        if bt is None and (vec or list(cuts[1]) == [0, n]) and \
                B.size > 0 and len(ranks) > 1 and \
                plan_allgather(B, ranks).strategy == "all_gather":
            whole = dict(zip(ranks, allgather(B, ranks)))

        def get(ci, dev):
            r0, r1 = cuts[0][ci[0]], cuts[0][ci[0] + 1]
            a = _panel(A, [(r0, r1), (0, k)], dev)
            if whole is not None:
                return a, whole[int(pids[ci])]
            if vec:
                return a, (bt.to(dev) if bt is not None else B.full(dev))
            c0, c1 = cuts[1][ci[1]], cuts[1][ci[1] + 1]
            return a, (bt[:, c0:c1].to(dev) if bt is not None
                       else _panel(B, [(0, k), (c0, c1)], dev))
    results = {}
    for ci in np.ndindex(*pids.shape):
        rank = int(pids[ci])
        if not L.is_local(rank):
            continue                    # another process computes it
        dev = L.device_of(rank)
        a, b = get(ci, dev)
        if use_kernel:
            res = cuda_matmul(a.contiguous(), b.contiguous())
        else:
            res = torch_matmul(a.to(out_dtype), b.to(out_dtype))
            if not plain:
                res = alpha * res
                if beta != 0.0:
                    res = res + beta * out.part(ci)
        results[ci] = res.to(out_dtype)
    return results


@_tm.traced(name="matmul")
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
    if A.dtype == torch.bool and b_dtype == torch.bool and \
            alpha == 1.0 and beta == 0.0:
        return _bool_matmul(A, B if bt is None else bt, out)

    if out is not None:
        want = (m,) if vec else (m, n)
        if out.dims != want:
            raise ValueError(f"out dims {out.dims} != result dims {want}")
        if out.cuts[0] != A.cuts[0]:
            raise ValueError(
                "mul_into: out's row cuts must equal A's row cuts "
                "(reference linalg.jl:201)")
        out_dtype, pids, cuts = out.dtype, out.pids, out.cuts
        procs, dist = [int(p) for p in out.pids.flat], list(out.grid)
    else:
        out_dtype = torch.promote_types(A.dtype, b_dtype)
        if vec:
            procs, dist = [int(p) for p in A.pids.flat], [A.grid[0]]
        else:
            procs, dist = _gemm_layout(A, B)
        _, pids, cuts = resolve_layout((m,) if vec else (m, n), procs, dist)
    if beta != 0.0 and out is None:
        raise ValueError("beta accumulation requires out=")
    if _tm.enabled():
        # the cross-rank volume of the block GEMM on an (r, c) result grid
        # (each rank assembles its A row panel and B column panel), an
        # estimate, and the cost stamp of the traced matmul span, as JAX's
        # (``ops/linalg.py:759``)
        r = int(dist[0]) if dist else 1
        c = int(dist[1]) if len(dist) > 1 else 1
        a_bytes = m * k * A.dtype.itemsize
        b_bytes = _tm.nbytes_of(B if bt is None else bt)
        _tm.count("op.matmul")
        ici_est = a_bytes * (c - 1) + b_bytes * (r - 1)
        _tm.annotate(flops=2 * m * n * k,
                     bytes_hbm=a_bytes + b_bytes + m * n * out_dtype.itemsize,
                     bytes_ici=ici_est, grid=f"{r}x{c}")
        _tm.record_comm("collective", ici_est, op="matmul", grid=f"{r}x{c}",
                        shape=[m, k, n])
    plain = alpha == 1.0 and beta == 0.0

    blocks = None
    if plain and not vec and _ring_ag_eligible(A, B, procs, dist) and \
            _dist_impl_choice(m, n, k, A.grid[0], A.dtype,
                              B.dtype) == "ring_ag":
        blocks = _ring_ag_gemm(A, B, out_dtype)
    elif plain and not vec and \
            (rc := _summa_eligible(A, B, procs, dist)) is not None and \
            _summa_impl_choice(m, n, k, rc[0], rc[1], A.dtype,
                               B.dtype) == "summa":
        blocks = _summa_gemm(A, B, out_dtype)
    if blocks is not None:
        results = dict(zip(np.ndindex(*pids.shape), blocks))
    else:
        use_kernel = (plain and not vec and pids.size == 1
                      and A.dtype in (torch.float32, torch.bfloat16)
                      and b_dtype in (torch.float32, torch.bfloat16)
                      and _impl_choice(m, n, k, A.dtype, b_dtype) == "pallas")
        results = _default_gemm(A, B, bt, pids, cuts, vec, out_dtype,
                                use_kernel, alpha, beta, out)
    if out is not None:
        for ci, res in results.items():
            out.part(ci).copy_(res)
        out._relabel("rebind")        # JAX's C._rebind(res)
        return out
    parts = np.empty(pids.shape, dtype=object)
    for ci in np.ndindex(*pids.shape):
        res = results.get(ci)
        # another process's cell: a placeholder of its shape
        parts[ci] = res.contiguous() if res is not None else torch.empty(
            [c[j + 1] - c[j] for c, j in zip(cuts, ci)], dtype=out_dtype,
            device=L.device_of(int(pids[ci])))
    return DArray(parts, pids, cuts)


def _bool_matmul(A: DArray, B, out: DArray | None) -> DArray:
    """The boolean product ``A @ B`` (numpy's and JAX's ``bool @ bool``):
    the operands cast to float32 through the port's float32 route (the
    owned schedules and the registry's kernel apply as for any float32
    product), then ``!= 0``.  That is exact at any inner dim: every term
    is 0 or 1, and a float32 sum of non-negative terms that holds a 1
    never rounds back to 0, in any order or split.  ``out`` keeps its
    dtype (``copyto_``)."""
    from ..darray import copyto_
    a = A.astype(torch.float32)
    b = B.astype(torch.float32) if isinstance(B, DArray) else B.float()
    r = matmul(a, b)
    res = elementwise(lambda t: t != 0, r)
    for x in (a, b, r):
        if isinstance(x, DArray):
            x.close()
    if out is None:
        return res
    copyto_(out, res)
    res.close()
    return out


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


# ---------------------------------------------------------------------------
# tuners
# ---------------------------------------------------------------------------


def _default_impl_timer(op, a, b):
    """Best of 3 wall-clock runs after a warm-up, synchronised."""
    sync = (torch.cuda.synchronize if L.device_of(0).type == "cuda"
            else (lambda: None))
    op(a, b)
    sync()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        op(a, b)
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


def _tune_impls(kernel, key, candidates, a, b, timer):
    """Time every candidate ``op(a, b)`` with ``timer`` and record the
    fastest under ``kernel``/``key``.  A candidate that raises is an error,
    not a loss: nothing here hides a failing kernel.  Returns ``(winner,
    {impl: seconds})``.  The registry lives in memory (nothing persists)."""
    results = {name: timer(op, a, b) for name, op in candidates.items()}
    winner = min(results, key=results.get)
    autotune.record(kernel, key, winner)
    return winner, results


def tune_matmul_impl(m, n, k, dtype=torch.float32, timer=None):
    """Time ``torch.matmul`` against the CUDA GEMM kernel for an (m,k)x(k,n)
    product on rank 0's device and record the winner under
    ``matmul_impl``.  ``timer(op, a, b) -> seconds`` is injectable.
    Returns ``(winner, {impl: seconds})``."""
    dev = L.device_of(0)
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((m, k), generator=g, device=dev).to(dtype)
    b = torch.randn((k, n), generator=g, device=dev).to(dtype)
    return _tune_impls("matmul_impl", _impl_key(m, n, k, a.dtype, b.dtype),
                       {"torch": torch_matmul, "pallas": cuda_matmul}, a, b,
                       timer or _default_impl_timer)


def _tune_operands(m, n, k, procs, dist, dtype):
    g = torch.Generator().manual_seed(0)
    a = torch.randn((m, k), generator=g).to(dtype)
    b = torch.randn((k, n), generator=g).to(dtype)
    return distribute(a, procs, dist), distribute(b, procs, dist)


def _timed_default(A, B):
    _, pids, cuts = resolve_layout((A.dims[0], B.dims[1]),
                                   [int(p) for p in A.pids.flat], A.grid)
    return _default_gemm(A, B, None, pids, cuts, False,
                         torch.promote_types(A.dtype, B.dtype), False)


def tune_matmul_impl_dist(m, n, k, p=None, dtype=torch.float32, timer=None):
    """Time the default multi-rank GEMM against the ring all-gather GEMM for
    A row-chunked and B contraction-chunked over ``p`` ranks (default: all)
    and record the winner under ``matmul_impl_dist``.  Needs ``p >= 2`` and
    ``m % p == k % p == 0``."""
    p = L.nranks() if p is None else int(p)
    if p < 2:
        raise ValueError("tune_matmul_impl_dist needs >= 2 ranks (devices)")
    if m % p or k % p:
        raise ValueError(f"m ({m}) and k ({k}) must be divisible by p ({p})")
    A, B = _tune_operands(m, n, k, range(p), (p, 1), dtype)
    try:
        return _tune_impls(
            "matmul_impl_dist", _impl_key(m, n, k, p, A.dtype, B.dtype),
            {"torch": _timed_default,
             "ring_ag": lambda x, y: _ring_ag_gemm(x, y, x.dtype)},
            A, B, timer or _default_impl_timer)
    finally:
        A.close()
        B.close()


def tune_matmul_impl_summa(m, n, k, g=None, dtype=torch.float32, timer=None):
    """Time the default multi-rank GEMM against the owned 2-D schedule
    (Cannon on square grids, SUMMA panels on rectangular ones) for A and B
    on one ``(r, c)`` grid and record the winner under ``matmul_impl_dist``
    with an ``rxc`` grid tag.  ``g``: an int (square grid) or ``(r, c)``;
    default the largest square grid the ranks allow.  Needs ``m % r == n %
    c == k % lcm(r, c) == 0``."""
    if g is None:
        g = int(math.isqrt(L.nranks()))
    r, c = (g, g) if isinstance(g, int) else (int(g[0]), int(g[1]))
    if r < 2 or c < 2:
        raise ValueError("tune_matmul_impl_summa needs a >= 2x2 grid "
                         "(>= 4 ranks for the default square)")
    if m % r or n % c or k % math.lcm(r, c):
        raise ValueError(
            f"m ({m}), n ({n}), k ({k}) must be divisible by r ({r}), "
            f"c ({c}), lcm(r, c) ({math.lcm(r, c)}) respectively")
    A, B = _tune_operands(m, n, k, range(r * c), (r, c), dtype)
    try:
        return _tune_impls(
            "matmul_impl_dist",
            _impl_key(m, n, k, f"{r}x{c}", A.dtype, B.dtype),
            {"torch": _timed_default,
             "summa": lambda x, y: _summa_gemm(x, y, x.dtype)},
            A, B, timer or _default_impl_timer)
    finally:
        A.close()
        B.close()


# ---------------------------------------------------------------------------
# int8 GEMM
# ---------------------------------------------------------------------------


def dmatmul_int8(A, B, out_dtype=torch.float32) -> DArray:
    """Distributed dynamic-quantization GEMM: float DArrays in, float out,
    int8 products (per-row A / per-column B symmetric codes, exact int32
    sums, fused dequantization; relative error about 1e-2 on Gaussian
    data).  Layouts: A on one rank; A row-chunked on an even ``(p, 1)`` grid
    with B whole (each rank quantizes its own rows); or A and B on the same
    even square ``(g, g)`` grid (int8 panels and their scales ride Cannon's
    double ring).  Anything else raises.  In a job of several controller
    processes each process quantizes and multiplies its own ranks' cells
    (Cannon's rings are cross-process exchanges); the result's other
    cells are placeholders."""
    if isinstance(A, SubDArray):
        A = A.materialize()
    if not isinstance(A, DArray):
        at = as_tensor(A)
        ndev = L.nranks()
        if at.ndim == 2 and ndev > 1 and at.shape[0] % ndev == 0:
            A = distribute(at, procs=range(ndev), dist=(ndev, 1))
        else:
            A = distribute(at, procs=[0], dist=(1,) * max(at.ndim, 1))
    bshape = _shape_of(B)
    if A.ndim != 2 or len(bshape) != 2:
        raise ValueError(f"dmatmul_int8 expects 2-D operands, got "
                         f"{A.dims} @ {bshape}")
    m, k = A.dims
    if bshape[0] != k:
        raise ValueError(f"dim mismatch: {A.dims} @ {bshape}")
    procs = [int(q) for q in A.pids.flat]
    p = len(procs)
    # in a job another process's cells are placeholders: their products
    # are placeholders of the product's shape
    A._check_open()
    if p == 1:
        dev = L.device_of(procs[0])
        res = quantized_matmul(A._parts[0, 0], _host(B).to(dev), out_dtype)
        parts = np.empty((1, 1), dtype=object)
        parts[0, 0] = res
        return DArray(parts, A.pids.copy(), [A.cuts[0], [0, bshape[1]]])
    g = _square_grid_ok(A, B) if isinstance(B, DArray) else None
    if g is not None:
        B._check_open()
        res = cm.cannon_matmul_int8([A._parts[ci] for ci in A.cells()],
                                    [B._parts[ci] for ci in B.cells()], g,
                                    out_dtype)
        _, pids, cuts = resolve_layout((m, bshape[1]), procs, (g, g))
        parts = np.empty((g, g), dtype=object)
        for x, ci in enumerate(np.ndindex(g, g)):
            parts[ci] = res[x]
        return DArray(parts, pids, cuts)
    if A.grid != (p, 1) or not _even(A) or m % p:
        raise ValueError(
            "dmatmul_int8 needs A on one device, A row-chunked on an even "
            "(p, 1) grid with B resident/replicated, or A and B both on "
            "the SAME even square (g, g) grid (matching rank order, no "
            f"padding); got grid {A.grid}, dims {A.dims}")
    if isinstance(B, DArray) and not _even(B):
        raise ValueError("dmatmul_int8 needs an even (or resident) B")
    if isinstance(B, DArray) and plan_allgather(B, procs).strategy == \
            "all_gather":
        bs = allgather(B, procs)
    else:
        bt = _host(B)
        bs = [bt.to(L.device_of(r)) for r in procs]
    parts = np.empty((p, 1), dtype=object)
    for i, (r, b) in enumerate(zip(procs, bs)):
        parts[i, 0] = quantized_matmul(A._parts[i, 0], b, out_dtype)
    return DArray(parts, A.pids.copy(), [A.cuts[0], [0, bshape[1]]])

