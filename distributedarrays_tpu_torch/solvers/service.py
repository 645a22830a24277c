"""Streaming solve service: the serving layer beyond token generation.

PyTorch counterpart of ``distributedarrays_tpu/solvers/service.py`` (its
whole ``__all__``), on the port's ``serve.Server``: a system's operands
are built inside the dispatch (the right-hand side through the port's
``distribute``), so a Poisson system's applies run K2 and a dense one's
matvecs gather the vector with K10 on the card.  A dense or sparse system
whose right-hand side has the wrong length frees its operator before the
typed failure (JAX's ``_build`` leaves it open).

``SolverService`` registers a long-lived ``solve`` endpoint on a
``serve.Server``.  ``submit`` admits one linear system and returns a
:class:`SolveStream` — the solver analog of the decode engine's
``TokenStream``: iterate for ``(iter, residual)`` tuples as iterations
land, ``result()`` for the final :class:`~.krylov.SolveResult` summary,
``cancel()`` to abandon mid-solve.  Cancellation is checked between
iterations (``should_stop``); the dispatch's ``finally`` closes every
operand DArray, so cancel frees the system's HBM residency immediately
and the stream resolves with :class:`serve.errors.Cancelled`.

Systems are submitted as host-side specs (the operands are *built* —
and owned — inside the dispatch, so their residency is exactly the
request's lifetime):

- ``{"kind": "poisson", "grid": (nx, ny), "b": <(nx, ny) array>}``
- ``{"kind": "dense",  "A": <(n, n) array>, "b": <(n,) array>}``
- ``{"kind": "sparse", "A": <dense/scipy matrix>, "b": <(n,) array>}``

plus ``method`` (``cg`` | ``bicgstab`` | ``gmres``), ``tol`` /
``maxiter``, and ``precond="multigrid"`` (Poisson systems only).
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Callable

import numpy as np

from .. import telemetry as _tm
from ..darray import distribute
from ..serve import errors
from ..serve.server import Server
from . import krylov
from .multigrid import Multigrid
from .operators import DenseOperator, SparseOperator, StencilOperator

__all__ = ["SolveStream", "SolverService"]


class SolveStream:
    """Streaming handle for one solve: ``(iter, residual)`` tuples as
    they land, a final summary via ``result()``, ``cancel()`` to
    abandon (operand residency frees before the stream resolves)."""

    def __init__(self, req_id: int, tenant: str):
        self.req_id = int(req_id)
        self.tenant = tenant
        self._cv = threading.Condition()
        self._updates: list[tuple[int, float]] = []
        self._cancelled = threading.Event()
        self._done = False
        self._error: BaseException | None = None
        self._summary: dict | None = None
        self._listeners: list[Callable[[str, Any], None]] = []

    # engine side ----------------------------------------------------------

    def _push(self, it: int, residual: float) -> None:
        with self._cv:
            if self._done:
                return
            self._updates.append((int(it), float(residual)))
            self._cv.notify_all()
            for fn in self._listeners:
                fn("iter", self._updates[-1])

    def _finish(self, summary: dict | None = None,
                error: BaseException | None = None) -> None:
        with self._cv:
            if self._done:
                return
            self._done = True
            self._summary = summary
            self._error = error
            self._cv.notify_all()
            for fn in self._listeners:
                fn("done", error)
            self._listeners.clear()

    # client side ----------------------------------------------------------

    def add_listener(self, fn: Callable[[str, Any], None]) -> None:
        with self._cv:
            for u in self._updates:
                fn("iter", u)
            if self._done:
                fn("done", self._error)
            else:
                self._listeners.append(fn)

    def cancel(self) -> bool:
        """Abandon the solve: the loop stops at its next iteration check
        and the dispatch frees the system's operand residency."""
        self._cancelled.set()
        return True

    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    def done(self) -> bool:
        with self._cv:
            return self._done

    def error(self) -> BaseException | None:
        with self._cv:
            return self._error

    @property
    def updates(self) -> list[tuple[int, float]]:
        with self._cv:
            return list(self._updates)

    def __iter__(self):
        i = 0
        while True:
            with self._cv:
                while i >= len(self._updates) and not self._done:
                    self._cv.wait(0.05)
                if i < len(self._updates):
                    u = self._updates[i]
                    i += 1
                else:
                    if self._error is not None:
                        raise self._error
                    return
            yield u

    def result(self, timeout: float | None = None) -> dict:
        """Block for the final summary (outcome, iterations, residual,
        x as a host array); raises the solve's typed error."""
        with self._cv:
            if not self._cv.wait_for(lambda: self._done, timeout):
                raise TimeoutError("solve still running")
            if self._error is not None:
                raise self._error
            return self._summary


class SolverService:
    """Owns (or attaches to) a ``serve.Server`` and registers the
    ``solve`` endpoint.  Solves run one-per-dispatch (``max_batch=1`` —
    a solve is minutes of iterations, not a coalescable micro-op) under
    the server's recovery/chaos discipline."""

    def __init__(self, server: Server | None = None, *,
                 endpoint: str = "solve", **server_kw):
        self._own = server is None
        self.server = server if server is not None else Server(**server_kw)
        self.endpoint = endpoint
        self.server.register(endpoint, self._dispatch, max_batch=1)
        self._seq = itertools.count(1)

    # -- client ------------------------------------------------------------

    def submit(self, system: dict, *, method: str = "cg",
               tol: float = 1e-6, maxiter: int | None = None,
               precond: str | None = None, tenant: str = "default",
               deadline_s: float | None = None) -> SolveStream:
        if method not in krylov.SOLVERS:
            raise ValueError(f"unknown method {method!r}: "
                             f"{sorted(krylov.SOLVERS)}")
        stream = SolveStream(next(self._seq), tenant)
        payload = {"system": system, "method": method, "tol": float(tol),
                   "maxiter": maxiter, "precond": precond,
                   "stream": stream}
        try:
            future = self.server.submit(self.endpoint, payload,
                                        tenant=tenant,
                                        deadline_s=deadline_s)
        except errors.ServeError as e:
            stream._finish(error=e)
            raise
        stream.future = future

        def _relay(f):
            # terminal failure (recovery retries exhausted, rejection,
            # expiry) resolves the stream; success/cancel already did
            try:
                f.result()
            except BaseException as e:  # noqa: BLE001 — relayed, not handled
                stream._finish(error=e)
        future.add_done_callback(_relay)
        _tm.count("solver.serve.submitted", method=method)
        return stream

    def close(self, **kw):
        if self._own:
            self.server.close(**kw)

    # -- dispatch ----------------------------------------------------------

    def _dispatch(self, payloads: list) -> list:
        return [self._solve_one(pl) for pl in payloads]

    def _solve_one(self, pl: dict) -> dict:
        stream: SolveStream = pl["stream"]
        A = b = M = None
        res = None
        try:
            A, b = self._build(pl["system"])
            if pl.get("precond") == "multigrid":
                if not isinstance(A, StencilOperator):
                    raise errors.RequestFailed(
                        "multigrid preconditions poisson systems only")
                M = Multigrid(A)
            solve = krylov.SOLVERS[pl["method"]]
            res = solve(A, b, tol=pl["tol"], maxiter=pl.get("maxiter"),
                        M=M, callback=stream._push,
                        should_stop=stream.cancelled)
            summary = {
                "outcome": res.outcome,
                "iterations": res.iterations,
                "residual": res.residual,
                "history": list(res.history),
                "recoveries": res.recoveries,
                "x": np.asarray(res.x),
            }
            if res.outcome == "cancelled":
                # the future resolves with the summary (the dispatch did
                # not fail — raising here would read as transient to the
                # recovery loop and re-run a solve nobody wants); the
                # stream carries the typed cancellation
                _tm.count("solver.serve.cancelled")
                stream._finish(error=errors.Cancelled(
                    f"solve cancelled after {res.iterations} iterations"))
            else:
                _tm.count("solver.serve.completed", outcome=res.outcome)
                stream._finish(summary=summary)
            return summary
        finally:
            # operand residency is the request's lifetime: converged,
            # failed or cancelled, the system's DArrays close here
            if res is not None:
                res.x.close()
            if b is not None:
                b.close()
            if A is not None and hasattr(A, "close"):
                A.close()

    @staticmethod
    def _build(system: dict):
        kind = system.get("kind", "poisson")
        if kind == "poisson":
            nx, ny = system["grid"]
            op = StencilOperator((int(nx), int(ny)))
            rhs = np.asarray(system["b"], dtype=np.float32)
            if rhs.shape != op.grid:
                raise errors.RequestFailed(
                    f"rhs shape {rhs.shape} != grid {op.grid}")
            procs, dist = op.vector_layout()
            b = distribute(rhs, procs=procs, dist=list(dist))
            return op, b
        if kind in ("dense", "sparse"):
            op = (DenseOperator(system["A"]) if kind == "dense"
                  else SparseOperator(system["A"]))
            rhs = np.asarray(system["b"], dtype=np.float32).reshape(-1)
            if rhs.shape[0] != op.shape[0]:
                # the operator holds the matrix's DArray: free it here,
                # since the caller's cleanup never sees it (JAX leaks it)
                if hasattr(op, "close"):
                    op.close()
                raise errors.RequestFailed(
                    f"rhs length {rhs.shape[0]} != n {op.shape[0]}")
            procs, dist = op.vector_layout()
            b = distribute(rhs, procs=procs, dist=list(dist))
            return op, b
        raise errors.RequestFailed(f"unknown system kind {kind!r}")
