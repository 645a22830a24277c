"""The port's streaming solve service (``solvers/service.py``) against the
JAX package's, on the three service cases of ``tests/test_solvers.py``
(8 CPU ranks, the same seeded systems through both): the streamed
``(iteration, residual)`` pairs number 1..n with n within 2 of JAX's, the
first residuals within 1e-4 relative and the history equal to the stream,
the answers within the solve tolerance of JAX's and of the float64
oracle (the tolerances ``tests/test_torch_solvers.py`` uses); the dense
system, the refused method and the malformed systems (where JAX leaves a
failed dense system's operator open and the port closes it); cancel
resolves the stream ``Cancelled``,
the dispatch's summary ``cancelled``, and frees the system's residency
(the registry empty, the ledger at 0)."""

import numpy as np
import pytest

import distributedarrays_tpu as dat
import distributedarrays_tpu_torch as tdat
from distributedarrays_tpu import serve as JSV
from distributedarrays_tpu import solvers as JS
from distributedarrays_tpu import telemetry as JT
from distributedarrays_tpu.resilience import elastic as JE
from distributedarrays_tpu.resilience import faults as JF
from distributedarrays_tpu.telemetry import memory as JM
from distributedarrays_tpu_torch import serve as TSV
from distributedarrays_tpu_torch import solvers as TS
from distributedarrays_tpu_torch import telemetry as TT
from distributedarrays_tpu_torch.resilience import elastic as TE
from distributedarrays_tpu_torch.resilience import faults as TF
from distributedarrays_tpu_torch.telemetry import memory as TM

from _torch_port import (jax_plan_cache, jax_process_state,  # noqa: F401
                         port_ranks)

# (solvers, serve, telemetry, memory, package)
J = (JS, JSV, JT, JM, dat)
T = (TS, TSV, TT, TM, tdat)
ITERS = 2


@pytest.fixture(autouse=True)
def clean(port_ranks):
    for F, E in ((JF, JE), (TF, TE)):
        F.clear()
        E.manager().reset()
    for tm in (JT, TT):
        tm.enable()
        tm.reset()
    yield
    TF.clear()
    TE.manager().reset()
    TT.reset()


def _banded(n):
    return (3.0 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)).astype(
        np.float32)


def _poisson(pkg, rhs, **kw):
    svc = pkg[0].SolverService()
    try:
        stream = svc.submit({"kind": "poisson", "grid": rhs.shape, "b": rhs},
                            **kw)
        updates = list(stream)
        summary = stream.result(timeout=120)
        svc.server.drain(timeout=60)
    finally:
        svc.close()
    assert pkg[3].live_bytes() == 0             # residency freed
    assert pkg[4].live_ids() == []
    return updates, summary


@pytest.mark.parametrize("n", [16, 24])
def test_service_streams_iterations_and_result_like_jax(n):
    rhs = np.random.default_rng(n).standard_normal((n, n)).astype(np.float32)
    (ju, js), (tu, ts) = (_poisson(pkg, rhs, tol=1e-6) for pkg in (J, T))
    assert ts["outcome"] == js["outcome"] == "converged"
    it = ts["iterations"]
    assert abs(it - js["iterations"]) <= ITERS
    assert [i for i, _ in tu] == list(range(1, it + 1)) and it > 5
    assert tu[-1][1] < tu[0][1]
    assert ts["history"] == [r for _, r in tu]
    np.testing.assert_allclose([r for _, r in tu[:5]],
                               [r for _, r in ju[:5]], rtol=1e-4)
    assert ts["x"].shape == js["x"].shape == (n, n)
    oracle = np.linalg.solve(JS.poisson2d_dense(n, n).astype(np.float64),
                             rhs.ravel().astype(np.float64))
    np.testing.assert_allclose(ts["x"].ravel(), oracle, atol=5e-4)
    np.testing.assert_allclose(ts["x"], js["x"], atol=5e-4)
    assert ts["recoveries"] == js["recoveries"] == 0
    assert TT.counter_value("solver.serve.submitted", method="cg") == 1
    assert TT.counter_value("solver.serve.completed",
                            outcome="converged") == 1


def test_service_dense_system_and_bad_method_like_jax():
    n = 32
    A = _banded(n)
    b = np.random.default_rng(5).standard_normal(n).astype(np.float32)
    out = {}
    for pkg in (J, T):
        svc = pkg[0].SolverService()
        try:
            with pytest.raises(ValueError, match="unknown method"):
                svc.submit({"kind": "dense", "A": A, "b": b}, method="qr")
            summary = svc.submit({"kind": "dense", "A": A, "b": b},
                                 tol=1e-7).result(timeout=120)
            bad = svc.submit({"kind": "nope"})
            with pytest.raises(pkg[1].RequestFailed, match="unknown system"):
                bad.result(timeout=60)
            short = svc.submit({"kind": "dense", "A": A, "b": b[:5]})
            with pytest.raises(pkg[1].RequestFailed, match="rhs length"):
                short.result(timeout=60)
            svc.server.drain(timeout=60)
        finally:
            svc.close()
        # JAX's _build leaves the failed system's DenseOperator open (its
        # 32 x 32 f32 matrix); the port closes it
        assert pkg[3].live_bytes() == (4096 if pkg is J else 0)
        out[pkg] = summary
    oracle = np.linalg.solve(A.astype(np.float64), b.astype(np.float64))
    np.testing.assert_allclose(out[T]["x"], oracle, atol=1e-3)
    np.testing.assert_allclose(out[T]["x"], out[J]["x"], atol=1e-5)
    assert abs(out[T]["iterations"] - out[J]["iterations"]) <= ITERS


def _cancel(pkg):
    rhs = np.random.default_rng(9).standard_normal((32, 32)).astype(
        np.float32)
    svc = pkg[0].SolverService()
    try:
        stream = svc.submit({"kind": "poisson", "grid": (32, 32),
                             "b": rhs}, precond="multigrid", tol=1e-30,
                            maxiter=100_000)
        with pytest.raises(pkg[1].Cancelled):
            for it, _res in stream:
                if it >= 3:
                    stream.cancel()
        assert stream.cancelled() and stream.done()
        summary = stream.future.result(timeout=60)
        svc.server.drain(timeout=60)
    finally:
        svc.close()
    assert pkg[3].live_bytes() == 0 and pkg[4].live_ids() == []
    return summary


def test_service_cancel_frees_residency_like_jax():
    ts, js = _cancel(T), _cancel(J)
    assert ts["outcome"] == js["outcome"] == "cancelled"
    assert 3 <= ts["iterations"] < 100_000
    assert TT.counter_value("solver.serve.cancelled") == 1


def test_service_multigrid_on_a_dense_system_fails_typed():
    svc = TS.SolverService()
    try:
        s = svc.submit({"kind": "dense", "A": _banded(8),
                        "b": np.ones(8, np.float32)}, precond="multigrid")
        with pytest.raises(TSV.RequestFailed, match="multigrid"):
            s.result(timeout=60)
    finally:
        svc.close()
    assert TM.live_bytes() == 0


def test_service_on_a_shared_server_and_listener_replay():
    srv = TSV.Server()
    svc = TS.SolverService(srv, endpoint="solve2")
    try:
        rhs = np.ones((8, 8), np.float32)
        st = svc.submit({"kind": "poisson", "grid": (8, 8), "b": rhs})
        summary = st.result(timeout=60)
        seen = []
        st.add_listener(lambda kind, v: seen.append((kind, v)))
        assert seen[:-1] == [("iter", u) for u in st.updates]
        assert seen[-1] == ("done", None)
        assert summary["iterations"] == len(st.updates)
        svc.close()                      # a borrowed server stays open
        assert not srv.stats()["closed"]
    finally:
        srv.close()
    assert TM.live_bytes() == 0
