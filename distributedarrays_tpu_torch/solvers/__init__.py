"""Distributed iterative solvers: matrix-free operators (:mod:`.operators`),
Krylov loops with typed outcomes and device-loss recovery (:mod:`.krylov`)
and a geometric multigrid preconditioner (:mod:`.multigrid`).

PyTorch counterpart of ``distributedarrays_tpu/solvers``.  The streaming
``SolverService``/``SolveStream`` of its ``service.py`` come with the
port's ``serve/`` (ROADMAP queue A).
"""

from .operators import (DenseOperator, LinearOperator, SparseOperator,
                        StencilOperator, poisson2d_dense)
from .krylov import SOLVERS, SolveResult, bicgstab, cg, gmres
from .multigrid import Multigrid

__all__ = [
    "LinearOperator", "DenseOperator", "SparseOperator", "StencilOperator",
    "poisson2d_dense", "SolveResult", "cg", "bicgstab", "gmres",
    "Multigrid", "SOLVERS",
]
