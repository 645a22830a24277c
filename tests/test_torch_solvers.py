"""The port's solvers (``solvers/operators.py``, ``krylov.py``,
``multigrid.py``) against the JAX package's, on the cases of
``tests/test_solvers.py``: the same seeded inputs through both.  The
operators' applies agree with JAX's in float32 to rtol 1e-5 / atol 1e-6
(the per-rank sums run in another order) and with the dense oracles; the
partitions and layouts are equal.  CG, BiCGStab and GMRES (restarts and
warm starts included) take JAX's iteration counts or within 2 of them,
and their solutions agree with JAX's and the dense oracle to the solve
tolerance.  Typed outcomes, multigrid, the ``solver.spmv`` spans and the
chaos device loss mid-CG follow JAX."""

import json

import numpy as np
import pytest
import scipy.sparse as sps

import distributedarrays_tpu as dat
import distributedarrays_tpu_torch as tdat
from distributedarrays_tpu import solvers as JS
from distributedarrays_tpu import telemetry as JT
from distributedarrays_tpu.resilience import elastic as JE
from distributedarrays_tpu.resilience import faults as JF
from distributedarrays_tpu.telemetry import perf as JP
from distributedarrays_tpu_torch import solvers as TS
from distributedarrays_tpu_torch import telemetry as TT
from distributedarrays_tpu_torch.resilience import elastic as TE
from distributedarrays_tpu_torch.resilience import faults as TF
from distributedarrays_tpu_torch.telemetry import perf as TP

from _torch_port import (jax_plan_cache, jax_process_state,  # noqa: F401
                         port_ranks)

APPLY = dict(rtol=1e-5, atol=1e-6)
ITERS = 2          # iteration counts within 2 of JAX's


@pytest.fixture(autouse=True)
def clean(port_ranks):
    for F, E in ((JF, JE), (TF, TE)):
        F.clear()
        E.manager().reset()
    TT.reset()
    yield
    TF.clear()
    TE.manager().reset()


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def _vec(pkg, op, arr):
    procs, dist = op.vector_layout()
    return pkg.distribute(np.asarray(arr, dtype=np.float32), procs=procs,
                          dist=list(dist))


def _host(pkg, d):
    return np.asarray(pkg.gather(d))


def _banded(n, *, sym=False):
    lower = 0.5 if not sym else -1.0
    return (3.0 * np.eye(n) - np.eye(n, k=1)
            + lower * np.eye(n, k=-1)).astype(np.float32)


def both(kind, *args, **kw):
    return getattr(JS, kind)(*args, **kw), getattr(TS, kind)(*args, **kw)


def apply_both(jop, top, x):
    jx, tx = _vec(dat, jop, x), _vec(tdat, top, x)
    jy, ty = jop.apply(jx), top.apply(tx)
    j, t = _host(dat, jy), _host(tdat, ty)
    for d in (jx, jy):
        d.close()
    return j, t


# ---------------------------------------------------------------------------
# cost model, dense oracle, operators
# ---------------------------------------------------------------------------


def test_spmv_cost_and_poisson_oracle_equal_jax():
    assert TP.spmv_cost(100, 10, 4, index_itemsize=4, bytes_ici=64) == \
        JP.spmv_cost(100, 10, 4, index_itemsize=4, bytes_ici=64) == \
        {"flops": 200, "bytes_hbm": 100 * 8 + 2 * 10 * 4, "bytes_ici": 64}
    for nx, ny, s in ((4, 5, 1.0), (8, 8, 0.5), (3, 7, 2.0)):
        np.testing.assert_array_equal(TS.poisson2d_dense(nx, ny, s),
                                      JS.poisson2d_dense(nx, ny, s))
    A = TS.poisson2d_dense(4, 5)
    assert np.linalg.eigvalsh(A.astype(np.float64)).min() > 0


def test_dense_operator_matches_jax(rng):
    n = 32
    A = rng.standard_normal((n, n)).astype(np.float32)
    jop, top = both("DenseOperator", A)
    assert top.vector_layout() == jop.vector_layout()
    assert len(top.vector_layout()[0]) > 1
    assert top.apply_cost() == jop.apply_cost()
    x = rng.standard_normal(n).astype(np.float32)
    j, t = apply_both(jop, top, x)
    np.testing.assert_allclose(t, j, **APPLY)
    np.testing.assert_allclose(t, A @ x, rtol=2e-5, atol=2e-5)
    jop.close()
    top.close()


@pytest.mark.parametrize("form", ["dense", "csr", "darray"])
def test_sparse_operator_matches_jax(rng, form):
    n = 64
    A = _banded(n)
    if form == "dense":
        jop, top = both("SparseOperator", A)
    elif form == "csr":
        jop, top = both("SparseOperator", sps.csr_matrix(A))
    else:
        jA, tA = dat.distribute(A), tdat.distribute(A)
        jop, top = JS.SparseOperator(jA), TS.SparseOperator(tA)
        jA.close()
        tA.close()
    assert top.nnz == jop.nnz == int(np.count_nonzero(A))
    assert (top._p, top._m, top._h) == (jop._p, jop._m, jop._h)
    assert top._p > 1                          # the halo path
    assert top.vector_layout() == jop.vector_layout()
    assert top.apply_cost() == jop.apply_cost()
    x = rng.standard_normal(n).astype(np.float32)
    j, t = apply_both(jop, top, x)
    np.testing.assert_allclose(t, j, **APPLY)
    np.testing.assert_allclose(t, A @ x, rtol=2e-5, atol=2e-5)


def test_sparse_partition_coarsens_like_jax(rng):
    n = 64
    A = _banded(n)
    A[0, 40] = 2.0
    jop, top = both("SparseOperator", A)
    assert top._p == jop._p == 1
    x = rng.standard_normal(n).astype(np.float32)
    j, t = apply_both(jop, top, x)
    np.testing.assert_allclose(t, j, **APPLY)
    # re-partitioning onto a live subset follows JAX too
    for op in (jop, top):
        op.prepare([0, 2, 4, 6])
    assert top.vector_layout() == jop.vector_layout()
    B = _banded(64)
    jop, top = both("SparseOperator", B, procs=[1, 3, 5, 7])
    for op in (jop, top):
        op.prepare([1, 5, 7])
    assert top.vector_layout() == jop.vector_layout() == ([1, 5], (2,))


@pytest.mark.parametrize("grid,scale", [((8, 8), 0.5), ((16, 12), 1.0),
                                        ((12, 8), 2.0)])
def test_stencil_operator_matches_jax(rng, grid, scale):
    jop = JS.StencilOperator(grid, scale=scale)
    top = TS.StencilOperator(grid, scale=scale)
    assert top.vector_layout() == jop.vector_layout()
    assert top.weights == jop.weights
    assert top.apply_cost() == jop.apply_cost()
    x = rng.standard_normal(grid).astype(np.float32)
    j, t = apply_both(jop, top, x)
    np.testing.assert_allclose(t, j, **APPLY)
    dense = TS.poisson2d_dense(*grid, scale=scale)
    np.testing.assert_allclose(t, (dense @ x.ravel()).reshape(grid),
                               rtol=2e-5, atol=2e-5)


def test_operator_align_accepts_foreign_layout(rng):
    x = rng.standard_normal((8, 8)).astype(np.float32)
    outs = []
    for pkg, S in ((dat, JS), (tdat, TS)):
        op = S.StencilOperator((8, 8))
        xd = pkg.distribute(x, procs=[0, 1], dist=[1, 2])
        y = op.apply(xd)
        outs.append(_host(pkg, y))
        np.testing.assert_array_equal(_host(pkg, xd), x)   # untouched
        y.close()
        xd.close()
    np.testing.assert_allclose(outs[1], outs[0], **APPLY)


# ---------------------------------------------------------------------------
# Krylov convergence
# ---------------------------------------------------------------------------


def solve_both(solver, jop, top, b, **kw):
    jb, tb = _vec(dat, jop, b), _vec(tdat, top, b)
    jr = getattr(JS, solver)(jop, jb, **kw)
    tr = getattr(TS, solver)(top, tb, **kw)
    jx, tx = _host(dat, jr.x), _host(tdat, tr.x)
    jr.x.close()
    jb.close()
    return jr, tr, jx, tx, tb


def test_cg_poisson_matches_jax_and_the_oracle(rng):
    nx, ny = 16, 16
    b = rng.standard_normal((nx, ny)).astype(np.float32)
    jr, tr, jx, tx, tb = solve_both("cg", JS.StencilOperator((nx, ny)),
                                    TS.StencilOperator((nx, ny)), b,
                                    tol=1e-6)
    assert tr.converged and tr.outcome == jr.outcome == "converged"
    assert abs(tr.iterations - jr.iterations) <= ITERS
    assert len(tr.history) == tr.iterations > 1
    assert len(set(int(p) for p in tr.x.pids.flat)) >= 2
    assert tr.residual <= 1e-6 * np.linalg.norm(b)
    oracle = np.linalg.solve(TS.poisson2d_dense(nx, ny).astype(np.float64),
                             b.ravel().astype(np.float64))
    np.testing.assert_allclose(tx.ravel(), oracle, atol=5e-4)
    np.testing.assert_allclose(tx, jx, atol=5e-4)
    np.testing.assert_allclose(tr.history[:5], jr.history[:5], rtol=1e-4)
    tr.x.close()
    tb.close()


@pytest.mark.parametrize("kind", ["DenseOperator", "SparseOperator"])
def test_cg_dense_and_sparse_operators(rng, kind):
    n = 40
    A = _banded(n, sym=True)
    b = rng.standard_normal(n).astype(np.float32)
    oracle = np.linalg.solve(A.astype(np.float64), b.astype(np.float64))
    arg = A if kind == "DenseOperator" else sps.csr_matrix(A)
    jop, top = both(kind, arg)
    jr, tr, jx, tx, tb = solve_both("cg", jop, top, b, tol=1e-7)
    assert tr.converged and jr.converged
    assert abs(tr.iterations - jr.iterations) <= ITERS
    np.testing.assert_allclose(tx, oracle, atol=1e-3)
    np.testing.assert_allclose(tx, jx, atol=1e-3)
    tr.x.close()
    tb.close()
    for op in (jop, top):
        if hasattr(op, "close"):
            op.close()


def test_cg_maxiter_typed_outcome(rng):
    b = rng.standard_normal((16, 16))
    jr, tr, _, _, tb = solve_both("cg", JS.StencilOperator((16, 16)),
                                  TS.StencilOperator((16, 16)), b,
                                  tol=1e-12, maxiter=3)
    assert tr.outcome == jr.outcome == "maxiter" and not tr.converged
    assert tr.iterations == 3 and len(tr.history) == 3
    np.testing.assert_allclose(tr.history, jr.history, rtol=1e-5)
    tr.x.close()
    tb.close()


def test_cg_breakdown_and_cancelled_outcomes(rng):
    b = rng.standard_normal(16).astype(np.float32)
    neg = -np.eye(16, dtype=np.float32)
    jr, tr, _, _, tb = solve_both("cg", *both("DenseOperator", neg), b)
    assert tr.outcome == jr.outcome == "breakdown"
    assert "curvature" in tr.detail
    tr.x.close()
    tb.close()
    stops = iter([False, False, True])
    top = TS.StencilOperator((16, 16))
    tb = _vec(tdat, top, rng.standard_normal((16, 16)))
    tr = TS.cg(top, tb, tol=1e-12, should_stop=lambda: next(stops))
    assert tr.outcome == "cancelled" and tr.iterations == 2
    tr.x.close()
    tb.close()


def test_bicgstab_and_gmres_nonsymmetric(rng):
    n = 48
    A = _banded(n)
    b = rng.standard_normal(n).astype(np.float32)
    oracle = np.linalg.solve(A.astype(np.float64), b.astype(np.float64))
    for solver in ("bicgstab", "gmres"):
        jr, tr, jx, tx, tb = solve_both(solver, *both("SparseOperator", A),
                                        b, tol=1e-7)
        assert tr.converged, (solver, tr.outcome, tr.detail)
        assert tr.solver == jr.solver == solver
        assert abs(tr.iterations - jr.iterations) <= ITERS, solver
        np.testing.assert_allclose(tx, oracle, atol=1e-3, err_msg=solver)
        np.testing.assert_allclose(tx, jx, atol=1e-3, err_msg=solver)
        tr.x.close()
        tb.close()


def test_gmres_restart_and_warm_start(rng):
    nx, ny = 16, 16
    b = rng.standard_normal((nx, ny)).astype(np.float32)
    out = []
    for pkg, S in ((dat, JS), (tdat, TS)):
        op = S.StencilOperator((nx, ny))
        bd = _vec(pkg, op, b)
        res = S.gmres(op, bd, tol=1e-6, restart=5)
        assert res.converged and res.iterations > 5
        res2 = S.gmres(op, bd, x0=res.x, tol=1e-5)
        assert res2.converged and res2.iterations == 0
        assert len(res2.history) == 1
        out.append((res.iterations, _host(pkg, res.x)))
        for d in (res2.x, res.x, bd):
            d.close()
    assert abs(out[1][0] - out[0][0]) <= ITERS
    np.testing.assert_allclose(out[1][1], out[0][1], atol=5e-4)


def test_mgcg_converges_in_far_fewer_iterations(rng):
    nx, ny = 32, 32
    b = rng.standard_normal((nx, ny)).astype(np.float32)
    out = []
    for pkg, S in ((dat, JS), (tdat, TS)):
        op = S.StencilOperator((nx, ny))
        bd = _vec(pkg, op, b)
        plain = S.cg(op, bd, tol=1e-6)
        mg = S.cg(op, bd, tol=1e-6, M=S.Multigrid(op))
        assert plain.converged and mg.converged
        assert mg.iterations < plain.iterations / 2
        out.append((plain.iterations, mg.iterations, _host(pkg, mg.x),
                    _host(pkg, plain.x)))
        for d in (plain.x, mg.x, bd):
            d.close()
    (jp, jm, jx, _), (tp, tm, tx, tpx) = out
    assert abs(tp - jp) <= ITERS and abs(tm - jm) <= ITERS
    np.testing.assert_allclose(tx, jx, atol=1e-3)
    np.testing.assert_allclose(tx, tpx, atol=1e-3)


def test_multigrid_vcycle_matches_jax(rng):
    r = rng.standard_normal((32, 32)).astype(np.float32)
    outs = []
    for pkg, S in ((dat, JS), (tdat, TS)):
        op = S.StencilOperator((32, 32), scale=0.7)
        rd = _vec(pkg, op, r)
        z = S.Multigrid(op).apply(rd)
        outs.append(_host(pkg, z))
        z.close()
        rd.close()
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-4, atol=1e-5)


def test_multigrid_requires_stencil_operator():
    with pytest.raises(TypeError):
        TS.Multigrid(TS.DenseOperator(np.eye(8, dtype=np.float32)))


@pytest.mark.parametrize("use_kernel", [True, False])
def test_stencil_operator_use_kernel_reaches_every_step(rng, monkeypatch,
                                                        use_kernel):
    """``StencilOperator(use_kernel=)`` reaches the stencil step of its apply
    and of every V-cycle sweep, and a V-cycle runs ``presmooth +
    postsmooth + 1`` steps on each of ``Multigrid.levels`` levels (on CPU
    tensors both choices take the plain step: the same values)."""
    from distributedarrays_tpu_torch.models import stencil as MS
    seen = []
    step = MS._step

    def spy(blocks, w, uk):
        seen.append(uk)
        return step(blocks, w, uk)
    monkeypatch.setattr(MS, "_step", spy)
    grid = (64, 64)
    op = TS.StencilOperator(grid, use_kernel=use_kernel)
    ref = TS.StencilOperator(grid)
    x = _vec(tdat, op, rng.standard_normal(grid))
    y, yr = op.apply(x), ref.apply(x)
    assert seen == [use_kernel, False]
    np.testing.assert_array_equal(_host(tdat, y), _host(tdat, yr))
    mg = TS.Multigrid(op)
    levels = mg.levels(grid, x.pids.size)
    assert (x.pids.size, levels) == (8, 2)
    seen.clear()
    z = mg.apply(x)
    assert seen == [use_kernel] * (levels * (mg.presmooth + mg.postsmooth
                                             + 1))
    zr = TS.Multigrid(ref).apply(x)
    np.testing.assert_array_equal(_host(tdat, z), _host(tdat, zr))
    for d in (x, y, yr, z, zr):
        d.close()


# ---------------------------------------------------------------------------
# observability
# ---------------------------------------------------------------------------


def test_spmv_spans_and_solve_stamp_like_jax(rng):
    b = rng.standard_normal((16, 16)).astype(np.float32)
    v = np.ones(64, dtype=np.float32)
    seen = []
    for pkg, S, T in ((dat, JS, JT), (tdat, TS, TT)):
        T.enable()
        T.reset()
        op = S.StencilOperator((16, 16))
        bd = _vec(pkg, op, b)
        res = S.cg(op, bd, tol=1e-12, maxiter=5)
        res.x.close()
        bd.close()
        sop = S.SparseOperator(_banded(64))
        vd = _vec(pkg, sop, v)
        sop.apply(vd).close()
        vd.close()
        spans = T.spans("solver.spmv")
        solve = T.spans("solver.solve")[-1]["labels"]
        seen.append(([s["labels"] for s in spans], solve,
                     T.counter_value("solver.iterations", solver="cg"),
                     T.counter_value("solver.solves", solver="cg",
                                     outcome="maxiter")))
    assert seen[1] == seen[0]
    labels, solve, iters, solves = seen[1]
    assert len(labels) == 5 + 1 + 1     # one apply an iteration, the
    assert iters == 5 and solves == 1   # initial residual, the SpMV
    assert {s["op"] for s in labels} == {"stencil", "bcoo"}
    assert float(solve["bytes_hbm"]) > 0


# ---------------------------------------------------------------------------
# chaos: device loss mid-CG
# ---------------------------------------------------------------------------


def test_chaos_device_loss_mid_cg_converges_on_survivors(rng, monkeypatch):
    nx, ny = 16, 16
    b = rng.standard_normal((nx, ny)).astype(np.float32)
    plan = [{"site": "solver.iterate", "action": "device_loss", "at": 4,
             "count": 1, "device": 5}]
    out = []
    for pkg, S, F, E, T in ((dat, JS, JF, JE, JT), (tdat, TS, TF, TE, TT)):
        op = S.StencilOperator((nx, ny))
        bd = _vec(pkg, op, b)
        free = S.cg(op, bd, tol=1e-6)
        assert free.converged and free.recoveries == 0
        x_free = _host(pkg, free.x)
        free.x.close()
        monkeypatch.setenv("DA_TPU_FAULT_PLAN", json.dumps(plan))
        monkeypatch.setenv("DA_TPU_FAULT_SEED", "1234")
        F.configure()
        retries0 = T.counter_value("recovery.retries", verdict="device_loss")
        res = S.cg(S.StencilOperator((nx, ny)), bd, tol=1e-6)
        assert res.converged, (res.outcome, res.detail)
        assert [h["action"] for h in F.history()] == ["device_loss"]
        assert T.counter_value("recovery.retries",
                               verdict="device_loss") > retries0
        assert 5 not in E.manager().live_ranks()
        assert 5 not in {int(p) for p in res.x.pids.flat}
        x = _host(pkg, res.x)
        np.testing.assert_allclose(x, x_free, atol=5e-4)
        out.append((res.recoveries, res.iterations, x,
                    [int(p) for p in res.x.pids.flat], bd.cuts))
        res.x.close()
        bd.close()
        F.clear()
        monkeypatch.delenv("DA_TPU_FAULT_PLAN")
    (jrec, jit, jx, jp, jc), (trec, tit, tx, tp, tc) = out
    assert trec == jrec == 1
    assert abs(tit - jit) <= ITERS
    assert tp == jp and tc == jc              # the survivors' layouts
    np.testing.assert_allclose(tx, jx, atol=5e-4)
