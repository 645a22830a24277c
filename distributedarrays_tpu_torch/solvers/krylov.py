"""Krylov solvers over distributed DArrays: CG, BiCGStab, restarted GMRES(m).

PyTorch counterpart of ``distributedarrays_tpu/solvers/krylov.py`` (its
whole ``__all__``), the same host loops over the port's BLAS-1 steps
(``ops.linalg.ddot`` / ``dnorm`` / ``axpy_`` / ``rmul_``: one small launch
or two a rank each) and the operator's ``apply`` (on the card, one K2
launch a rank for the stencil operator).  Each ``float(ddot(...))`` or
``float(dnorm(...))`` syncs the host with the device, as JAX's scalar
fetches do.

Fault tolerance: every solve segment runs under
``resilience.recovery.run_with_recovery`` with ``solver.iterate`` as the
fault site.  A device loss shrinks the registered operands onto the
survivors (``elastic.shrink``, through the reshard); the retry re-derives
the operator's partition for the live ranks (``A.prepare``), re-seats
``x``/``b`` on its layout and rebuilds the Krylov space from the current
iterate.

Outcomes are typed (:class:`SolveResult.outcome`): ``converged``,
``maxiter``, ``breakdown`` or ``cancelled`` (``should_stop`` fired).  The
solve span ``solver.solve`` carries the aggregate cost stamp.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import telemetry as _tm
from ..darray import DArray
from ..ops.linalg import axpy_, ddot, dnorm, rmul_
from ..resilience import elastic, faults as _fl, recovery
from .operators import LinearOperator

__all__ = ["SolveResult", "cg", "bicgstab", "gmres", "SOLVERS"]


@dataclasses.dataclass
class SolveResult:
    """Typed solve outcome.  ``x`` is live (caller closes); ``history``
    holds one residual norm per accepted iteration, across recoveries."""

    outcome: str                 # converged | maxiter | breakdown | cancelled
    x: DArray
    iterations: int
    residual: float
    history: list[float]
    solver: str
    recoveries: int = 0
    detail: str = ""

    @property
    def converged(self) -> bool:
        return self.outcome == "converged"


_TINY = 1e-30


def _close_all(*arrs):
    for a in arrs:
        if a is not None:
            a.close()


class _Solve:
    """Shared per-solve state: the persistent iterate, convergence
    target, residual history, and the recovery re-seat step."""

    def __init__(self, name, A, b, x0, tol, atol, maxiter, M, callback,
                 should_stop):
        self.name = name
        self.A = A
        self.M = M
        self.callback = callback
        self.should_stop = should_stop
        self.maxiter = int(maxiter if maxiter is not None
                           else 10 * A.shape[0])
        self.b = b
        self.b_owned: DArray | None = None
        self.x = x0.copy() if x0 is not None else A.align(b)
        if x0 is None:
            self.x.fill_(0)
        nb = float(dnorm(b))
        self.target = max(float(tol) * nb, float(atol))
        self.history: list[float] = []
        self.iterations = 0
        self.attempts = 0

    def reseat(self, devices) -> tuple[DArray, DArray]:
        """Entry of every recovery attempt: re-derive the operator
        partition for the live ranks and move ``x``/``b`` onto its
        layout (free when already aligned)."""
        self.attempts += 1
        devs = devices if devices is not None else elastic.manager()
        self.A.prepare(devs.live_ranks())
        procs, _ = self.A.vector_layout()
        if [int(q) for q in self.x.pids.flat] != procs:
            old = self.x
            self.x = self.A.align(old)
            old.close()
        src = self.b_owned if self.b_owned is not None else self.b
        if [int(q) for q in src.pids.flat] != procs:
            moved = self.A.align(src)
            _close_all(self.b_owned)
            self.b_owned = moved
        return self.x, (self.b_owned if self.b_owned is not None
                        else self.b)

    def step(self, res: float) -> str | None:
        """Record one accepted iteration; returns a terminal outcome or
        None to continue."""
        self.history.append(res)
        self.iterations += 1
        _tm.count("solver.iterations", solver=self.name)
        if self.callback is not None:
            self.callback(self.iterations, res)
        if res <= self.target or not math.isfinite(res):
            return "converged" if math.isfinite(res) else "breakdown"
        if self.iterations >= self.maxiter:
            return "maxiter"
        return None

    def check_faults(self):
        _fl.check("solver.iterate", solver=self.name)
        if self.should_stop is not None and self.should_stop():
            return "cancelled"
        return None

    def finish(self, outcome: str, detail: str = "") -> SolveResult:
        _close_all(self.b_owned)
        self.b_owned = None
        res = self.history[-1] if self.history else float(dnorm(self.b))
        _tm.count("solver.solves", solver=self.name, outcome=outcome)
        return SolveResult(outcome=outcome, x=self.x,
                           iterations=self.iterations, residual=float(res),
                           history=self.history, solver=self.name,
                           recoveries=self.attempts - 1, detail=detail)


def _run(st: _Solve, segment, policy, devices) -> SolveResult:
    with _tm.span("solver.solve", solver=st.name, n=st.A.shape[0]):
        try:
            outcome, detail = recovery.run_with_recovery(
                segment, policy=policy, devices=devices)
        except BaseException:
            _close_all(st.x, st.b_owned)
            raise
        if _tm.enabled():
            # aggregate stamp on the solve span: per-matvec cost times
            # the iterations run, plus ~10 whole-vector BLAS-1 passes
            # per iteration — a stamped parent covers its subtree, so
            # the doctor's coverage never opens a gap under a solve
            per = st.A.apply_cost()
            iters = max(st.iterations, 1)
            vec = 10 * st.A.shape[0] * torch.empty(
                0, dtype=st.A.dtype).element_size()
            _tm.annotate(flops=per["flops"] * iters,
                         bytes_hbm=(per["bytes_hbm"] + vec) * iters,
                         bytes_ici=per["bytes_ici"] * iters)
        return st.finish(outcome, detail)


def _residual(A: LinearOperator, x: DArray, b: DArray) -> DArray:
    r = b.copy()
    Ax = A.apply(x)
    axpy_(-1.0, Ax, r)
    Ax.close()
    return r


# ---------------------------------------------------------------------------
# CG
# ---------------------------------------------------------------------------


def cg(A: LinearOperator, b: DArray, *, x0: DArray | None = None,
       tol: float = 1e-6, atol: float = 0.0, maxiter: int | None = None,
       M=None, callback=None, should_stop=None,
       policy: recovery.RetryPolicy | None = None, devices=None
       ) -> SolveResult:
    """Preconditioned conjugate gradients for SPD systems.  ``M`` is an
    optional preconditioner applied as ``z = M.apply(r)`` (e.g.
    ``solvers.multigrid.Multigrid``); convergence is
    ``||r|| <= max(tol*||b||, atol)``."""
    st = _Solve("cg", A, b, x0, tol, atol, maxiter, M, callback,
                should_stop)

    def segment():
        x, bb = st.reseat(devices)
        r = _residual(st.A, x, bb)
        z = st.M.apply(r) if st.M is not None else None
        p = (z if z is not None else r).copy()
        try:
            rz = float(ddot(r, z if z is not None else r))
            while True:
                stop = st.check_faults()
                if stop is not None:
                    return stop, ""
                Ap = st.A.apply(p)
                try:
                    pAp = float(ddot(p, Ap))
                    if pAp <= _TINY:
                        return "breakdown", f"non-positive curvature {pAp:g}"
                    alpha = rz / pAp
                    axpy_(alpha, p, x)
                    axpy_(-alpha, Ap, r)
                finally:
                    Ap.close()
                outcome = st.step(float(dnorm(r)))
                if outcome is not None:  # dalint: disable=DAL010 — the norm/dot is folded from every process's cell partials (multihost.cell_values), the same value on every process
                    return outcome, ""
                if st.M is not None:
                    znew = st.M.apply(r)
                    z.close()
                    z = znew
                rz_new = float(ddot(r, z if z is not None else r))
                beta = rz_new / rz
                rmul_(p, beta)
                axpy_(1.0, z if z is not None else r, p)
                rz = rz_new
        finally:
            _close_all(r, p, z)

    return _run(st, segment, policy, devices)


# ---------------------------------------------------------------------------
# BiCGStab
# ---------------------------------------------------------------------------


def bicgstab(A: LinearOperator, b: DArray, *, x0: DArray | None = None,
             tol: float = 1e-6, atol: float = 0.0,
             maxiter: int | None = None, M=None, callback=None,
             should_stop=None, policy: recovery.RetryPolicy | None = None,
             devices=None) -> SolveResult:
    """BiCGStab for general (nonsymmetric) systems, optionally
    right-preconditioned (``M.apply`` maps search directions)."""
    st = _Solve("bicgstab", A, b, x0, tol, atol, maxiter, M, callback,
                should_stop)

    def segment():
        x, bb = st.reseat(devices)
        r = _residual(st.A, x, bb)
        rhat = r.copy()
        p = r.copy()
        v = phat = shat = t = None
        try:
            rho = float(ddot(rhat, r))
            while True:
                stop = st.check_faults()
                if stop is not None:
                    return stop, ""
                if abs(rho) <= _TINY:
                    return "breakdown", f"rho underflow {rho:g}"
                phat = st.M.apply(p) if st.M is not None else p
                vn = st.A.apply(phat)
                _close_all(v)
                v = vn
                denom = float(ddot(rhat, v))
                if abs(denom) <= _TINY:
                    return "breakdown", f"(rhat, Ap) underflow {denom:g}"
                alpha = rho / denom
                axpy_(-alpha, v, r)              # r becomes s
                res_s = float(dnorm(r))
                if res_s <= st.target:  # dalint: disable=DAL010 — the norm/dot is folded from every process's cell partials (multihost.cell_values), the same value on every process
                    axpy_(alpha, phat, x)
                    outcome = st.step(res_s)
                    return outcome or "converged", ""
                shat = st.M.apply(r) if st.M is not None else r
                tn = st.A.apply(shat)
                _close_all(t)
                t = tn
                tt = float(ddot(t, t))
                if tt <= _TINY:
                    return "breakdown", f"(t, t) underflow {tt:g}"
                omega = float(ddot(t, r)) / tt
                if abs(omega) <= _TINY:
                    return "breakdown", f"omega underflow {omega:g}"
                axpy_(alpha, phat, x)
                axpy_(omega, shat, x)
                axpy_(-omega, t, r)
                if st.M is not None:
                    _close_all(phat, shat)
                phat = shat = None
                outcome = st.step(float(dnorm(r)))
                if outcome is not None:  # dalint: disable=DAL010 — the norm/dot is folded from every process's cell partials (multihost.cell_values), the same value on every process
                    return outcome, ""
                rho_new = float(ddot(rhat, r))
                beta = (rho_new / rho) * (alpha / omega)
                axpy_(-omega, v, p)
                rmul_(p, beta)
                axpy_(1.0, r, p)
                rho = rho_new
        finally:
            if st.M is not None:
                _close_all(phat, shat)
            _close_all(r, rhat, p, v, t)

    return _run(st, segment, policy, devices)


# ---------------------------------------------------------------------------
# restarted GMRES(m)
# ---------------------------------------------------------------------------


def gmres(A: LinearOperator, b: DArray, *, x0: DArray | None = None,
          tol: float = 1e-6, atol: float = 0.0, maxiter: int | None = None,
          restart: int = 30, M=None, callback=None, should_stop=None,
          policy: recovery.RetryPolicy | None = None, devices=None
          ) -> SolveResult:
    """Restarted GMRES(m): modified Gram-Schmidt Arnoldi over DArrays,
    Givens-rotated Hessenberg on the host, optional right preconditioner.
    A restart (every ``restart`` iterations) discards the basis — which
    is also what makes recovery free: the device-loss retry simply
    restarts from the current ``x``."""
    st = _Solve("gmres", A, b, x0, tol, atol, maxiter, M, callback,
                should_stop)
    m = max(1, int(restart))

    def segment():
        while True:
            x, bb = st.reseat(devices)
            r = _residual(st.A, x, bb)
            beta = float(dnorm(r))
            if beta <= st.target:  # dalint: disable=DAL010 — the norm/dot is folded from every process's cell partials (multihost.cell_values), the same value on every process
                r.close()
                if not st.history:
                    st.history.append(beta)
                return "converged", ""
            V: list[DArray] = [rmul_(r, 1.0 / beta)]   # r consumed into V
            Z: list[DArray] = []
            H = np.zeros((m + 1, m), dtype=np.float64)
            cs = np.zeros(m)
            sn = np.zeros(m)
            g = np.zeros(m + 1)
            g[0] = beta
            outcome = None
            try:
                j = 0
                for j in range(m):
                    stop = st.check_faults()
                    if stop is not None:
                        return stop, ""
                    zj = (st.M.apply(V[j]) if st.M is not None else V[j])
                    if st.M is not None:
                        Z.append(zj)
                    w = st.A.apply(zj)
                    for i in range(j + 1):
                        H[i, j] = float(ddot(V[i], w))
                        axpy_(-H[i, j], V[i], w)
                    H[j + 1, j] = float(dnorm(w))
                    lucky = H[j + 1, j] <= _TINY
                    if not lucky:  # dalint: disable=DAL010 — the norm/dot is folded from every process's cell partials (multihost.cell_values), the same value on every process
                        V.append(rmul_(w, 1.0 / H[j + 1, j]))
                    else:
                        w.close()
                    for i in range(j):                 # apply stored Givens
                        h0 = cs[i] * H[i, j] + sn[i] * H[i + 1, j]
                        H[i + 1, j] = -sn[i] * H[i, j] + cs[i] * H[i + 1, j]
                        H[i, j] = h0
                    d = math.hypot(H[j, j], H[j + 1, j])
                    cs[j], sn[j] = ((1.0, 0.0) if d <= _TINY
                                    else (H[j, j] / d, H[j + 1, j] / d))
                    H[j, j] = d
                    H[j + 1, j] = 0.0
                    g[j + 1] = -sn[j] * g[j]
                    g[j] = cs[j] * g[j]
                    res = abs(g[j + 1])
                    outcome = st.step(res)
                    if outcome is None and lucky:
                        outcome = "breakdown"
                    if outcome is not None:
                        break
                k = j + 1
                y = np.linalg.lstsq(H[:k, :k], g[:k], rcond=None)[0]
                basis = Z if st.M is not None else V
                for i in range(k):  # dalint: disable=DAL012 — k counts Arnoldi steps taken while a folded norm stayed above the target: the same on every process
                    axpy_(float(y[i]), basis[i], x)
            finally:
                _close_all(*V, *Z)
            if outcome in ("converged", "maxiter", "breakdown"):
                return outcome, ""
            # else: restart with a fresh Krylov space from the updated x

    return _run(st, segment, policy, devices)


SOLVERS = {"cg": cg, "bicgstab": bicgstab, "gmres": gmres}
