"""The true residual of the JAX reference's float32 CG on ``bench.py``'s
``cg_poisson`` system, on the CPU: the witness for how far a float32 CG's
recurrence residual drifts from ``||b - A x||`` over thousands of
iterations, independent of the PyTorch port.

    python tools/cg_residual_witness.py [N]

Solves ``StencilOperator((N, N))`` with ``b`` from ``default_rng(7)`` by
``distributedarrays_tpu.solvers.cg(tol=1e-6, maxiter=6000)`` on one CPU
device, then again stopped at a half, a quarter and an eighth of the
iterations the first solve took (what a solve that quit early would
leave).  For each it prints the iterations, the solver's residual and the
true one, ``A x`` recomputed in float64 with numpy, both relative to
``||b||``.  N defaults to 1024.  The run at 1024 takes about two minutes.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import _cpu_harness  # noqa: E402

_cpu_harness.force_cpu_mesh(1)

import numpy as np  # noqa: E402

import distributedarrays_tpu as dat  # noqa: E402
from distributedarrays_tpu import solvers  # noqa: E402


def poisson64(x: np.ndarray) -> np.ndarray:
    """The 5-point Poisson operator with zero boundary, in float64."""
    p = np.pad(x.astype(np.float64), 1)
    return (4.0 * p[1:-1, 1:-1] - p[:-2, 1:-1] - p[2:, 1:-1]
            - p[1:-1, :-2] - p[1:-1, 2:])


def main(n: int) -> None:
    rhs = np.random.default_rng(7).standard_normal((n, n)).astype(np.float32)
    op = solvers.StencilOperator((n, n))
    procs, dist = op.vector_layout()
    b = dat.distribute(rhs, procs=procs, dist=list(dist))
    nb = float(np.linalg.norm(rhs.astype(np.float64)))
    full = 6000
    for what, part in (("full", 1), ("half", 2), ("quarter", 4),
                       ("eighth", 8)):
        res = solvers.cg(op, b, tol=1e-6, maxiter=full // part)
        x = np.asarray(res.x.garray)
        true = np.linalg.norm(rhs - poisson64(x)) / nb
        print(f"jax float32 cg {n}^2 ({what}): {res.outcome} in "
              f"{res.iterations} iterations, residual "
              f"{res.residual / nb:.6e} of ||b||, true {true:.6e}")
        if part == 1:
            full = res.iterations
        res.x.close()
    b.close()


if __name__ == "__main__":
    main(int(sys.argv[1]) if sys.argv[1:] else 1024)
