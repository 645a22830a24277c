"""Geometric multigrid V-cycle preconditioner for the stencil operator.

PyTorch counterpart of ``distributedarrays_tpu/solvers/multigrid.py``.  One
V-cycle approximately inverts the 5-point Poisson operator on a (p, 1)
row-distributed grid:

- smoother: weighted Jacobi ``x += (omega / diag)(b - A x)``, whose matvec
  is ``models.stencil.stencil3x3`` (on the card one K2 launch a rank a
  sweep, as the operator's apply);
- restriction (2x2 block mean) and prolongation (2x piecewise-constant
  ``repeat_interleave``): per-rank torch ops on each rank's device, which
  keep every level on the same ranks (each rank's rows are even while
  ``nx % (2 p) == 0``);
- coarse operator ``scale / 2`` a level, the Galerkin product ``R A P`` of
  this pair, so the V-cycle is symmetric and serves as CG's preconditioner;
- coarse solve: below ``coarse_cells`` unknowns, or once the grid stops
  dividing over the ranks, the residual goes to the host and is multiplied
  by the cached float64 inverse of the coarse operator, as JAX does
  (``multigrid.py:122-127``).

``apply(r) -> z`` (``cg(..., M=Multigrid(op))``) reads the partition from
its operand, so it keeps working after an elastic shrink.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import telemetry as _tm
from ..darray import DArray, distribute
from ..ops.linalg import axpy_, rmul_
from .operators import POISSON_WEIGHTS, StencilOperator, poisson2d_dense

__all__ = ["Multigrid"]


@functools.lru_cache(maxsize=16)
def _coarse_solver(nx: int, ny: int, scale: float) -> np.ndarray:
    """The cached float64 inverse of the coarse Poisson operator; the
    coarse solve is one host matvec against it."""
    A = poisson2d_dense(nx, ny, scale).astype(np.float64)
    return np.linalg.inv(A)


def _per_rank(d: DArray, fn, dims) -> DArray:
    """``fn`` on each rank's block of the (p, 1) grid ``d``, giving the
    blocks of a (p, 1) grid of ``dims`` on the same ranks."""
    p = d.pids.size
    parts = np.empty((p, 1), dtype=object)
    for k in range(p):
        parts[k, 0] = fn(d.part((k, 0)))
    rows = dims[0] // p
    return DArray(parts, d.pids.copy(),
                  [[k * rows for k in range(p + 1)], [0, dims[1]]])


class Multigrid:
    """V-cycle preconditioner for :class:`StencilOperator` (JAX
    ``multigrid.py:54``)."""

    def __init__(self, op: StencilOperator, *, omega: float = 0.8,
                 presmooth: int = 2, postsmooth: int = 2,
                 coarse_cells: int = 256, max_levels: int = 16):
        if not isinstance(op, StencilOperator):
            raise TypeError("Multigrid preconditions the stencil Poisson "
                            f"operator, got {type(op).__name__}")
        self.op = op
        self.omega = float(omega)
        self.presmooth = int(presmooth)
        self.postsmooth = int(postsmooth)
        self.coarse_cells = int(coarse_cells)
        self.max_levels = int(max_levels)

    # -- level ops ---------------------------------------------------------

    def _matvec(self, x: DArray, scale: float) -> DArray:
        from ..models.stencil import stencil3x3
        w = tuple(tuple(scale * v for v in row) for row in POISSON_WEIGHTS)
        return stencil3x3(x, w, iters=1, use_kernel=self.op.use_kernel)

    def _smooth(self, x: DArray, b: DArray, scale: float, sweeps: int):
        damp = self.omega / (4.0 * scale)
        for _ in range(sweeps):
            Ax = self._matvec(x, scale)
            rmul_(Ax, -1.0)
            axpy_(1.0, b, Ax)          # Ax now holds the residual
            axpy_(damp, Ax, x)
            Ax.close()

    def _residual(self, x: DArray, b: DArray, scale: float) -> DArray:
        r = b.copy()
        Ax = self._matvec(x, scale)
        axpy_(-1.0, Ax, r)
        Ax.close()
        return r

    def _restrict(self, r: DArray) -> DArray:
        def mean(t):
            m, n = t.shape
            return t.reshape(m // 2, 2, n // 2, 2).mean(dim=(1, 3))
        return _per_rank(r, mean, (r.dims[0] // 2, r.dims[1] // 2))

    def _prolong(self, e: DArray) -> DArray:
        def repeat(t):
            return t.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
        return _per_rank(e, repeat, (e.dims[0] * 2, e.dims[1] * 2))

    def _coarse_solve(self, b: DArray, scale: float) -> DArray:
        nx, ny = b.dims
        inv = _coarse_solver(nx, ny, round(scale, 12))
        host = b.full().cpu().numpy().astype(np.float64).reshape(-1)
        x = (inv @ host).astype(np.float32).reshape(nx, ny)
        return distribute(torch.from_numpy(x), like=b)

    # -- the cycle ---------------------------------------------------------

    def _coarsest(self, nx: int, ny: int, p: int, depth: int) -> bool:
        """Whether the (nx, ny) grid on ``p`` ranks is solved directly."""
        return (depth >= self.max_levels or nx * ny <= self.coarse_cells
                or nx % (2 * p) or ny % 2 or nx // 2 < p)

    def levels(self, grid: tuple[int, int], p: int) -> int:
        """The levels a V-cycle on ``grid`` over ``p`` ranks smooths (each
        ``presmooth + postsmooth`` sweeps and one residual, a stencil apply
        each) before its coarse solve."""
        nx, ny = grid
        depth = 0
        while not self._coarsest(nx, ny, p, depth):
            nx, ny, depth = nx // 2, ny // 2, depth + 1
        return depth

    def _vcycle(self, b: DArray, scale: float, depth: int) -> DArray:
        nx, ny = b.dims
        if self._coarsest(nx, ny, b.pids.size, depth):
            return self._coarse_solve(b, scale)
        x = b.copy()
        x.fill_(0)
        self._smooth(x, b, scale, self.presmooth)
        r = self._residual(x, b, scale)
        rc = self._restrict(r)
        r.close()
        # the Galerkin coarse operator of this pair: scale / 2
        ec = self._vcycle(rc, scale / 2.0, depth + 1)
        rc.close()
        e = self._prolong(ec)
        ec.close()
        axpy_(1.0, e, x)
        e.close()
        self._smooth(x, b, scale, self.postsmooth)
        return x

    def apply(self, r: DArray) -> DArray:
        """One V-cycle: ``z ~ A^-1 r`` (a new DArray; the caller closes)."""
        with _tm.span("solver.mg_vcycle", n=r.dims[0] * r.dims[1]):
            return self._vcycle(r, self.op.scale, 0)
