"""Distributed matrix-free operators for the iterative solvers.

PyTorch counterpart of ``distributedarrays_tpu/solvers/operators.py`` (its
whole ``__all__``).  A :class:`LinearOperator` maps a row-distributed
vector DArray to a row-distributed vector DArray (``apply``); each
concrete operator is its own communication schedule:

- :class:`DenseOperator`: the port's ``ops.linalg.matmul`` matvec of a
  (p, 1) row-distributed matrix.
- :class:`SparseOperator`: built from host COO triples or a DArray through
  the port's ``ops.sparse.ddata_bcoo``.  Each rank holds a *diagonal*
  block (the columns it owns) and a *halo* block (the columns within ``h``
  rows of its range, in the coordinates of its vector block extended by
  ``h`` rows each side).  ``apply`` is the diagonal SpMV, then
  ``parallel.collectives.halo_exchange`` of the vector blocks and the
  halo SpMV over the extended block, each a plain ``torch.mv`` on a
  sparse COO tensor on the rank's device: JAX computes these products
  outside any Pallas kernel too (``jax.experimental.sparse`` BCOO).
- :class:`StencilOperator`: the 2-D Poisson (5-point) operator, whose
  apply is ``models.stencil.stencil3x3(x, weights, iters=1)``: on the card
  one launch of the hand-written stencil kernel K2 a rank
  (``csrc/stencil.cu`` ``step_kernel``; the Poisson weights, whose edges
  are ``-scale``, take its generic route).  "Vectors" are the row-sharded
  2-D grids themselves.  ``use_kernel=False`` applies it with the plain
  step instead (``stencil3x3``'s own option), to hold the kernel against
  it on the solver's shapes.

The sparse and stencil ``apply`` run in a ``solver.spmv`` span stamped
with the operator's cost (``apply_cost``, ``telemetry.perf.spmv_cost``),
as in JAX; the dense one opens none (its ``apply_cost`` is
``gemm_cost``).  ``prepare(live_ranks)`` re-derives the partition for a
new live rank set, so a solve survives an elastic shrink.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .. import layout as L
from .. import telemetry as _tm
from ..darray import DArray, distribute, dzeros
from ..ops.mapreduce import samedist
from ..telemetry import perf as _perf

__all__ = ["LinearOperator", "DenseOperator", "SparseOperator",
           "StencilOperator", "POISSON_WEIGHTS", "poisson2d_dense"]


POISSON_WEIGHTS = ((0.0, -1.0, 0.0), (-1.0, 4.0, -1.0), (0.0, -1.0, 0.0))


def poisson2d_dense(nx: int, ny: int, scale: float = 1.0) -> np.ndarray:
    """Dense (nx*ny, nx*ny) float32 matrix of the 5-point Poisson operator
    with zero Dirichlet boundary, ``scale * (kron(Tx, I) + kron(I, Ty))``:
    the oracle of :class:`StencilOperator` (JAX ``operators.py:54``)."""
    def trid(n):
        return (2.0 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1))
    A = np.kron(trid(nx), np.eye(ny)) + np.kron(np.eye(nx), trid(ny))
    return (scale * A).astype(np.float32)


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty(0, dtype=dtype).element_size()


def _largest_divisor(n: int, cap: int) -> int:
    """The largest ``p <= cap`` dividing ``n`` (JAX ``operators.py:160``)."""
    for p in range(min(n, cap), 0, -1):
        if n % p == 0:
            return p
    return 1


class LinearOperator:
    """The solver-facing protocol (JAX ``operators.py:64``): ``shape`` and
    ``dtype`` of the square system, ``apply``, ``vector_layout()`` (the
    ``(procs, dist)`` its operands live on), ``prepare(live_ranks)``."""

    shape: tuple[int, ...]
    dtype = torch.float32

    def apply(self, x: DArray) -> DArray:
        raise NotImplementedError

    def prepare(self, live_ranks: list[int]) -> None:  # noqa: ARG002
        """Adapt to the live rank set (default: nothing to rebuild)."""

    def vector_layout(self) -> tuple[list[int], tuple[int, ...]]:
        raise NotImplementedError

    def apply_cost(self) -> dict:
        """Analytic stamp of one ``apply`` (``telemetry.perf``)."""
        return {"flops": 0, "bytes_hbm": 0, "bytes_ici": 0}

    def new_vector(self) -> DArray:
        """A zeroed vector on the operator's layout."""
        procs, dist = self.vector_layout()
        return dzeros(self._vector_dims(), dtype=self.dtype, procs=procs,
                      dist=list(dist))

    def _vector_dims(self) -> tuple[int, ...]:
        return (self.shape[0],)

    def align(self, x: DArray) -> DArray:
        """A copy of ``x`` on the operator's layout (``x`` untouched),
        through ``samedist`` and so the reshard planner."""
        like = self.new_vector()
        try:
            return samedist(x, like)
        finally:
            like.close()


# ---------------------------------------------------------------------------
# dense: one distributed matvec
# ---------------------------------------------------------------------------


class DenseOperator(LinearOperator):
    """Row-distributed dense operator (JAX ``operators.py:122``): ``apply``
    is ``ops.linalg.matmul``'s matvec.  ``A`` is a host array (distributed
    here over ``p`` ranks, the largest count dividing its rows) or a
    DArray (borrowed: the caller keeps it)."""

    def __init__(self, A, *, procs=None):
        if isinstance(A, DArray):
            self._A, self._owned = A, False
        else:
            A = np.asarray(A, dtype=np.float32)
            n = len(procs) if procs is not None else L.nranks()
            p = _largest_divisor(A.shape[0], n)
            use = list(procs)[:p] if procs is not None else \
                L.all_ranks()[:p]
            self._A = distribute(A, procs=use, dist=[p, 1])
            self._owned = True
        if self._A.ndim != 2 or self._A.dims[0] != self._A.dims[1]:
            raise ValueError(f"square operator required, got {self._A.dims}")
        self.shape = self._A.dims
        self.dtype = self._A.dtype

    def apply(self, x: DArray) -> DArray:
        from ..ops.linalg import matmul
        return matmul(self._A, x)

    def vector_layout(self):
        procs = [int(p) for p in self._A.pids.flat]
        return procs, (self._A.pids.shape[0],)

    def apply_cost(self):
        n = self.shape[0]
        return _perf.gemm_cost(n, 1, n, _itemsize(self.dtype))

    def close(self):
        if self._owned:
            self._A.close()


# ---------------------------------------------------------------------------
# sparse: COO SpMV with a halo exchange of the vector blocks
# ---------------------------------------------------------------------------


def _to_coo(A):
    """Host COO triples and shape of a dense or scipy matrix."""
    try:
        import scipy.sparse as sps
    except Exception:  # pragma: no cover - scipy is installed
        sps = None
    if sps is not None and sps.issparse(A):
        coo = A.tocoo()
        return (np.asarray(coo.row), np.asarray(coo.col),
                np.asarray(coo.data, dtype=np.float32), A.shape)
    A = np.asarray(A, dtype=np.float32)
    r, c = np.nonzero(A)
    return r, c, A[r, c], A.shape


def _coo_from_darray(A: DArray):
    """``A``'s nonzeros as global host COO triples, read through
    ``ops.sparse.ddata_bcoo`` (each rank's chunk as a sparse tensor with
    chunk-local indices; the chunk's cuts give the offsets)."""
    from ..ops.sparse import ddata_bcoo
    parts = ddata_bcoo(A)
    try:
        rows, cols, vals = [], [], []
        for gidx in np.ndindex(*A.pids.shape):
            part = parts.localpart(int(A.pids[gidx]))
            idx = part.indices().cpu().numpy()
            r0 = int(A.cuts[0][gidx[0]])
            c0 = int(A.cuts[1][gidx[1]]) if A.pids.ndim > 1 else 0
            rows.append(idx[0] + r0)
            cols.append(idx[1] + c0)
            vals.append(part.values().to(torch.float32).cpu().numpy())
        return (np.concatenate(rows), np.concatenate(cols),
                np.concatenate(vals), A.dims)
    finally:
        parts.close()


def _sparse_block(triple, shape, device) -> torch.Tensor:
    rr, cc, vv = triple
    idx = torch.from_numpy(np.stack([rr, cc]).astype(np.int64))
    return torch.sparse_coo_tensor(
        idx, torch.from_numpy(np.asarray(vv, dtype=np.float32)), shape,
        device=device, check_invariants=False).coalesce()


class SparseOperator(LinearOperator):
    """Row-distributed COO SpMV (JAX ``operators.py:213``).  A DArray
    operand is read through ``ops.sparse.ddata_bcoo``; the host COO triples
    are kept so ``prepare`` can re-partition onto survivors.  Columns must
    reach at most the adjacent rank's block (banded systems): the
    partition coarsens until they do, and raises when one rank is not
    enough."""

    def __init__(self, A, *, procs=None):
        self._coo = _coo_from_darray(A) if isinstance(A, DArray) \
            else _to_coo(A)
        r, c, v, shp = self._coo
        if len(shp) != 2 or shp[0] != shp[1]:
            raise ValueError(f"square operator required, got {shp}")
        keep = v != 0
        self._coo = (r[keep], c[keep], v[keep], shp)
        self.shape = tuple(int(s) for s in shp)
        self.dtype = torch.float32
        self.nnz = int(keep.sum())
        self._procs_hint = list(procs) if procs is not None else None
        self._lock = threading.Lock()
        self._ranks: tuple[int, ...] | None = None
        self._partition(self._procs_hint or L.all_ranks())

    # -- partitioning ------------------------------------------------------

    def _partition(self, ranks: list[int]) -> None:
        n = self.shape[0]
        rows, cols, vals, _ = self._coo
        reach = int(np.max(np.abs(rows - cols))) if len(rows) else 0
        p = _largest_divisor(n, len(ranks))
        m = n // p
        while p > 1 and reach > m:
            # bandwidth wider than a block: coarsen until each halo reaches
            # the adjacent block at most
            p = _largest_divisor(n, p - 1)
            m = n // p
        if reach > m:
            raise ValueError(
                f"bandwidth {reach} exceeds rows-per-rank {m}: halo SpMV "
                "exchanges with adjacent ranks only")
        self._p, self._m, self._h = p, m, max(reach, 0)
        self._pids = [int(x) for x in ranks[:p]]
        order = np.argsort(rows, kind="stable")
        rows, cols, vals = rows[order], cols[order], vals[order]
        bounds = np.searchsorted(rows, np.arange(0, n + 1, m))
        self._diag, self._halo = [], []
        for k in range(p):
            lo, hi = bounds[k], bounds[k + 1]
            rr = rows[lo:hi] - k * m
            cc = cols[lo:hi]
            vv = vals[lo:hi]
            local = (cc >= k * m) & (cc < (k + 1) * m)
            dev = L.device_of(self._pids[k])
            self._diag.append(_sparse_block(
                (rr[local], cc[local] - k * m, vv[local]), (m, m), dev))
            # the halo part in extended coordinates [0, m + 2h): the slab
            # from the previous rank occupies [0, h)
            self._halo.append(_sparse_block(
                (rr[~local], cc[~local] - k * m + self._h, vv[~local]),
                (m, m + 2 * self._h), dev))
        self._ranks = tuple(ranks)

    def prepare(self, live_ranks: list[int]) -> None:
        with self._lock:
            live = [int(r) for r in live_ranks]
            if self._procs_hint is not None:
                live = [r for r in self._procs_hint if r in live] or live
            if tuple(live) != self._ranks:
                self._partition(live)

    def vector_layout(self):
        return list(self._pids), (self._p,)

    def apply_cost(self):
        itemsize = _itemsize(self.dtype)
        return _perf.spmv_cost(
            self.nnz, self.shape[0], itemsize,
            bytes_ici=(2 * (self._p - 1) * self._h * itemsize
                       if self._p > 1 else 0))

    # -- apply -------------------------------------------------------------

    def apply(self, x: DArray) -> DArray:
        from ..parallel.collectives import halo_exchange
        n, p, h = self.shape[0], self._p, self._h
        owned = None
        if [int(q) for q in x.pids.flat] != self._pids or x.pids.size != p:
            owned = x = self.align(x)
        try:
            with _tm.span("solver.spmv", op="bcoo", n=n, ranks=p,
                          **self.apply_cost()):
                xs = [x.part((k,)).to(torch.float32) for k in range(p)]
                ys = [torch.mv(self._diag[k], xs[k]) for k in range(p)]
                if h:
                    halos = halo_exchange(xs, halo=h, dim=0, wrap=False) \
                        if p > 1 else [(xs[0].new_zeros(h),
                                        xs[0].new_zeros(h))]
                    for k, (lo, hi) in enumerate(halos):
                        ext = torch.cat([lo, xs[k], hi])
                        ys[k] = ys[k] + torch.mv(self._halo[k], ext)
                parts = np.empty((p,), dtype=object)
                for k in range(p):
                    parts[k] = ys[k]
                pids = np.asarray(self._pids, dtype=np.int64)
                return DArray(parts, pids,
                              [list(range(0, n + 1, self._m))])
        finally:
            if owned is not None:
                owned.close()


# ---------------------------------------------------------------------------
# stencil: the 2-D Poisson operator through models.stencil
# ---------------------------------------------------------------------------


class StencilOperator(LinearOperator):
    """5-point Poisson operator ``A x = scale * (4x - sum of neighbours)``
    with zero Dirichlet boundary (JAX ``operators.py:387``), applied as one
    ``models.stencil.stencil3x3(x, weights, iters=1)``: the halo exchange
    and, on the card, one K2 launch a rank.  Vectors are the (p, 1)
    row-distributed grids; the dense oracle is :func:`poisson2d_dense` on
    the flattened grid.  ``use_kernel`` is passed on to ``stencil3x3``
    (by the apply and by :class:`~.multigrid.Multigrid`'s sweeps)."""

    def __init__(self, grid: tuple[int, int], *, scale: float = 1.0,
                 procs=None, use_kernel: bool | None = None):
        nx, ny = int(grid[0]), int(grid[1])
        self.grid = (nx, ny)
        self.shape = (nx * ny, nx * ny)
        self.scale = float(scale)
        self.dtype = torch.float32
        self.use_kernel = use_kernel
        self._procs_hint = list(procs) if procs is not None else None
        self._pids: list[int] = []
        self.prepare(self._procs_hint or L.all_ranks())

    @property
    def weights(self):
        s = self.scale
        return tuple(tuple(s * w for w in row) for row in POISSON_WEIGHTS)

    def prepare(self, live_ranks: list[int]) -> None:
        live = [int(r) for r in live_ranks]
        if self._procs_hint is not None:
            live = [r for r in self._procs_hint if r in live] or live
        p = _largest_divisor(self.grid[0], len(live))
        self._pids = live[:p]

    def vector_layout(self):
        return list(self._pids), (len(self._pids), 1)

    def apply_cost(self):
        nx, ny = self.grid
        itemsize = _itemsize(self.dtype)
        p = len(self._pids)
        return _perf.spmv_cost(
            5 * nx * ny, nx * ny, itemsize, index_itemsize=0,
            bytes_ici=2 * (p - 1) * ny * itemsize if p > 1 else 0)

    def _vector_dims(self):
        return self.grid

    def apply(self, x: DArray) -> DArray:
        from ..models.stencil import stencil3x3
        owned = None
        if ([int(q) for q in x.pids.flat] != self._pids
                or tuple(x.dims) != self.grid):
            owned = x = self.align(x)
        try:
            nx, ny = self.grid
            with _tm.span("solver.spmv", op="stencil", n=nx * ny,
                          ranks=len(self._pids), **self.apply_cost()):
                return stencil3x3(x, self.weights, iters=1,
                                  use_kernel=self.use_kernel)
        finally:
            if owned is not None:
                owned.close()
