"""Distributed iterative solvers: matrix-free operators (:mod:`.operators`),
Krylov loops with typed outcomes and device-loss recovery (:mod:`.krylov`)
and a geometric multigrid preconditioner (:mod:`.multigrid`).

PyTorch counterpart of ``distributedarrays_tpu/solvers``, with the
streaming solve service (:mod:`.service`: ``SolverService`` and
``SolveStream`` on the port's ``serve.Server``).
"""

from .operators import (DenseOperator, LinearOperator, SparseOperator,
                        StencilOperator, poisson2d_dense)
from .krylov import SOLVERS, SolveResult, bicgstab, cg, gmres
from .multigrid import Multigrid
from .service import SolverService, SolveStream

__all__ = [
    "LinearOperator", "DenseOperator", "SparseOperator", "StencilOperator",
    "poisson2d_dense", "SolveResult", "cg", "bicgstab", "gmres",
    "Multigrid", "SOLVERS", "SolverService", "SolveStream",
]
