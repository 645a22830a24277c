"""Host time of the port's CG loop on the card: 300 iterations of
``solvers.cg`` on ``bench.py``'s ``cg_poisson`` system (1024², one rank,
``b`` from ``default_rng(7)``), timed five times on the host clock after
two warm runs, then once under ``cProfile``.

    python tools/cg_host_profile.py [TREE] [MODE]

``TREE`` is the checkout whose ``distributedarrays_tpu_torch`` is
imported (default: this one), so a parent commit unpacked beside it can
be timed in the same call.  ``MODE`` is ``on`` (telemetry on, the
default), ``noledger`` (telemetry on, the memory ledger's ``track``,
``untrack`` and ``relabel`` made no-ops) or ``off`` (telemetry off).  It
prints the five wall times in ms and writes the profile's 80 costliest
functions by own time to ``chiprun_out/ab/prof_<tree>_<mode>.txt``.
Needs a CUDA device and builds the stencil kernel.
"""

import cProfile
import io
import os
import pstats
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ROOT)
    mode = sys.argv[2] if len(sys.argv) > 2 else "on"
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    import distributedarrays_tpu_torch as tdat
    from distributedarrays_tpu_torch import telemetry as tm
    from distributedarrays_tpu_torch.utils import kbuild
    assert tdat.__file__.startswith(tree), tdat.__file__
    kbuild.build(["stencil"])
    M = getattr(tm, "memory", None)          # absent before the ledger
    if mode == "noledger" and M is not None:
        M.track = lambda *a, **k: None
        M.untrack = lambda *a, **k: None
        if hasattr(M, "relabel"):
            M.relabel = lambda *a, **k: None
    if mode == "off":
        tm.disable()
    tdat.init()
    S = tdat.solvers
    n = 1024
    op = S.StencilOperator((n, n))
    procs, dist = op.vector_layout()
    rhs = np.random.default_rng(7).standard_normal((n, n)).astype(
        np.float32)
    b = tdat.distribute(rhs, procs=procs, dist=list(dist))

    def fixed():
        S.cg(op, b, tol=1e-30, maxiter=300).x.close()
        torch.cuda.synchronize()
    fixed()
    fixed()
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        fixed()
        ts.append((time.perf_counter() - t0) * 1e3)
    pr = cProfile.Profile()
    pr.enable()
    fixed()
    pr.disable()
    s = io.StringIO()
    pstats.Stats(pr, stream=s).sort_stats("tottime").print_stats(80)
    name = f"{os.path.basename(tree)}_{mode}"
    out = os.path.join(ROOT, "chiprun_out", "ab")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"prof_{name}.txt"), "w") as f:
        f.write(s.getvalue())
    print(f"{name}: cg 300 iterations wall ms {sorted(ts)} "
          f"(min {min(ts):.1f})")


if __name__ == "__main__":
    main()
