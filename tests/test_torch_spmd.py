"""SPMD mode of the port against the JAX package: the cases of
``tests/test_spmd.py`` on both backends, each held against the JAX
package's ``spmd`` on the same inputs where the result is deterministic;
the copy of tensor payloads at the send; and the static collectives
(``halo_exchange_2d``, ``pbcast``, ``pbarrier``, ``axis_rank``) against
JAX's ``run_spmd`` over a (4,2) mesh."""

import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import distributedarrays_tpu as dat
import distributedarrays_tpu_torch as tdat
from distributedarrays_tpu import telemetry as JT
from distributedarrays_tpu.parallel import collectives as JC
from distributedarrays_tpu.parallel import spmd_mode as JS
from distributedarrays_tpu_torch.parallel import collectives as TC
from distributedarrays_tpu_torch.parallel import spmd_mode as TS
from distributedarrays_tpu_torch.parallel import spmd_process as TP

from _torch_port import port_ranks  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _quiet_jax_telemetry():
    # the JAX package's telemetry keeps one bounded event buffer (8192
    # events) per process, which its own tests read by offset; the calls
    # these parity tests make into the JAX package stay out of it
    was = JT.enabled()
    JT.disable()
    yield
    if was:
        JT.enable()

BACKENDS = ["thread", "process"]
needs_fork = pytest.mark.skipif(not hasattr(os, "fork"),
                                reason="the process backend forks")


def both(prog, backend, **kw):
    """``prog(M)``'s program run by the JAX package (``M`` its spmd_mode)
    and by the port, on one backend; returns both result lists."""
    j = JS.spmd(prog(JS), backend=backend, **kw)
    t = TS.spmd(prog(TS), backend=backend, **kw)
    return j, t


def ring(M, n=4):
    def f():
        me = M.myid()
        M.sendto((me + 1) % n, ("hello", me))
        kind, frm = M.recvfrom((me - 1) % n)
        assert kind == "hello"
        M.barrier()
        return frm
    return f


def tagged(M):
    def f():
        me = M.myid()
        if me == 0:
            M.sendto(1, "second", tag="b")
            M.sendto(1, "first", tag="a")
            return None
        return (M.recvfrom(0, tag="a"), M.recvfrom(0, tag="b"))
    return f


def from_any(M):
    def f():
        if M.myid() == 0:
            return M.recvfrom_any()
        M.sendto(0, M.myid() * 2)
        return None
    return f


def collectives(M):
    def f():
        me = M.myid()
        v = M.bcast("payload" if me == 2 else None, root=2)
        part = M.scatter(list(range(16)) if me == 0 else None, root=0)
        got = M.gather_spmd(me * me, root=1)
        M.barrier()
        M.barrier()
        return (v, part, got, M.nprocs())
    return f


def ids(M):
    return lambda: M.myid() * 10


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", ["ring", "tagged", "any", "collectives",
                                  "subset"])
def test_programs_like_jax(case, backend):
    if backend == "process" and not hasattr(os, "fork"):
        pytest.skip("the process backend forks")
    prog, kw = {"ring": (ring, {"pids": range(4)}),
                "tagged": (tagged, {"pids": [0, 1]}),
                "any": (from_any, {"pids": [0, 3]}),
                "collectives": (collectives, {}),
                "subset": (ids, {"pids": [1, 3, 5]})}[case]
    j, t = both(prog, backend, **kw)
    assert t == j
    if case == "ring":
        assert t == [3, 0, 1, 2]
    if case == "collectives":
        assert t[1] == ("payload", [2, 3], [i * i for i in range(8)], 8)


def test_barrier_orders_phases():
    for M in (JS, TS):
        log = []

        def prog():
            me = M.myid()
            M.barrier()
            log.append(("a", me))
            M.barrier()
            log.append(("b", me))
            M.barrier()
            return True

        assert all(M.spmd(prog))
        assert [p for p, _ in log].index("b") >= 8


@pytest.mark.parametrize("backend", BACKENDS)
def test_scatter_indivisible_raises_like_jax(backend):
    def prog(M):
        return lambda: M.scatter(list(range(9)) if M.myid() == 0 else None,
                                 root=0)
    for M in (JS, TS):
        with pytest.raises(RuntimeError) as ei:
            M.spmd(prog(M), pids=[0, 1], backend=backend)
        assert "divisible" in str(ei.value.__cause__ or ei.value)


@pytest.mark.parametrize("backend", BACKENDS)
def test_failure_propagates_and_aborts_peers(backend):
    def prog(M):
        def f():
            if M.myid() == 1:
                raise ValueError("boom")
            M.recvfrom(1, timeout=30)
        return f
    for M in (JS, TS):
        with pytest.raises(RuntimeError, match="rank 1 failed"):
            M.spmd(prog(M), pids=[0, 1, 2], backend=backend)


@pytest.mark.parametrize("backend", BACKENDS)
def test_root_validation_like_jax(backend):
    for M in (JS, TS):
        with pytest.raises(RuntimeError) as ei:
            M.spmd(lambda: M.bcast("x", root=7), pids=[0, 1],
                   backend=backend)
        assert "root 7" in str(ei.value.__cause__ or ei.value)


@pytest.mark.parametrize("backend", BACKENDS)
def test_context_storage_persists_like_jax(backend):
    out = {}
    for M in (JS, TS):
        ctx = M.context(pids=range(4))
        try:
            def first():
                M.context_local_storage()["x"] = M.myid() + 100
                return True

            assert all(M.spmd(first, context=ctx, backend=backend))
            get = lambda: M.context_local_storage().get("x")
            out[M] = (M.spmd(get, context=ctx, backend=backend),
                      M.spmd(get, context=ctx))
        finally:
            M.close_context(ctx)
    assert out[TS] == out[JS] == ([100, 101, 102, 103],) * 2


def test_implicit_context_is_cleared():
    def prog():
        TS.context_local_storage()["y"] = 1
        return True
    assert all(TS.spmd(prog))
    assert not any(TS.spmd(lambda: "y" in TS.context_local_storage()))


def test_explicit_context_survives_failed_run():
    for M in (JS, TS):
        ctx = M.context([0, 1, 2])

        def bad():
            M.sendto((M.myid() + 1) % 3, "stale")
            if M.myid() == 1:
                raise ValueError("boom")
            M.barrier(timeout=10)

        with pytest.raises(RuntimeError):
            M.spmd(bad, context=ctx)

        def good():
            M.barrier()
            return M.myid()

        assert M.spmd(good, context=ctx) == [0, 1, 2]
        M.close_context(ctx)


@needs_fork
def test_process_backend_message_survives_across_runs():
    ctx = TS.context(pids=range(2))
    try:
        def send_only():
            if TS.myid() == 0:
                TS.sendto(1, np.arange(250_000, dtype=np.float32), tag="x")
            return True

        def recv_only():
            if TS.myid() == 1:
                return float(TS.recvfrom(0, tag="x", timeout=10).sum())
            return None

        assert all(TS.spmd(send_only, context=ctx, backend="process"))
        out = TS.spmd(recv_only, context=ctx, backend="process")
        assert out[1] == float(np.arange(250_000, dtype=np.float32).sum())
    finally:
        TS.close_context(ctx)


@needs_fork
def test_process_backend_runs_in_other_processes():
    parent = os.getpid()
    pids = TS.spmd(lambda: os.getpid(), pids=range(4), backend="process")
    assert parent not in pids and len(set(pids)) == 4


def test_unknown_backend_and_outside_run():
    with pytest.raises(ValueError, match="backend"):
        TS.spmd(lambda: 0, pids=range(2), backend="gondola")
    with pytest.raises(RuntimeError, match="spmd"):
        TS.sendto(0, "x")
    with pytest.raises(RuntimeError, match="spmd"):
        TS.barrier()


def test_timeout_default_from_env(monkeypatch):
    monkeypatch.setenv("DA_TPU_SPMD_TIMEOUT", "0.2")
    assert TS._default_timeout() == JS._default_timeout() == 0.2

    def prog():
        if TS.myid() == 0:
            TS.recvfrom(1)
        return True

    with pytest.raises(RuntimeError) as ei:
        TS.spmd(prog, pids=[0, 1])
    assert isinstance(ei.value.__cause__, TimeoutError)
    assert "DA_TPU_SPMD_TIMEOUT=0.2" in str(ei.value.__cause__)


def test_spmd_async_like_spmd():
    fut = TS.spmd_async(ring(TS), pids=range(4))
    assert fut.result(timeout=60) == JS.spmd(ring(JS), pids=range(4))


# ---------------------------------------------------------------------------
# DArrays inside rank tasks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_localpart_resolves_per_rank_like_jax(backend):
    # the JAX package runs its ranks on threads here: its process backend
    # must not touch device state in a rank
    A = np.random.default_rng(5).standard_normal((64, 8)).astype(np.float32)
    jd = dat.distribute(A, procs=range(8), dist=(8, 1))
    td = tdat.distribute(A, procs=range(8), dist=(8, 1))

    def prog(d, M):
        def f():
            lp = np.asarray(d.localpart())
            assert lp.shape == np.asarray(d.lp).shape
            return (M.myid(), float(lp.sum()))
        return f

    assert TS.spmd(prog(td, TS), backend=backend) == JS.spmd(prog(jd, JS))
    assert TS.spmd(lambda: tdat.current_rank(), backend=backend) == \
        list(range(8))
    assert tdat.current_rank() == 0
    dat.d_closeall()


def test_concurrent_set_localpart_all_land():
    A = np.zeros((64, 4), np.float32)
    d = tdat.distribute(A, procs=range(8), dist=(8, 1))

    def prog():
        me = TS.myid()
        d.set_localpart(np.full((8, 4), float(me), np.float32))
        d.lp += 1.0
        return True

    assert all(TS.spmd(prog))
    got = tdat.gather(d)
    for r in range(8):
        assert np.all(got[8 * r:8 * (r + 1)] == r + 1)


@needs_fork
def test_process_backend_refuses_cuda_data(monkeypatch):
    d = tdat.distribute(np.zeros((8, 2), np.float32), procs=range(4),
                        dist=(4, 1))
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    # a CPU DArray is host data: the run goes on
    out = TS.spmd(lambda x: tuple(x.dims), d, pids=range(2),
                  backend="process")
    assert out == [(8, 2), (8, 2)]
    monkeypatch.setattr(TP, "_on_card", lambda x, depth=0: True)
    with pytest.raises(RuntimeError, match="cannot take CUDA data"):
        TS.spmd(lambda x: 0, d, pids=range(2), backend="process")


# ---------------------------------------------------------------------------
# payloads are copied at the send
# ---------------------------------------------------------------------------


def test_write_after_sendto_does_not_reach_the_receiver():
    def prog():
        if TS.myid() == 0:
            t = torch.zeros(4)
            a = np.zeros(3)
            TS.sendto(1, t)
            TS.sendto(1, [t, {"k": t, "a": a}, (t,)], tag="c")
            t.fill_(7.0)
            a.fill(7.0)
            TS.sendto(1, None, tag="written")
            return t.tolist()
        TS.recvfrom(0, tag="written")      # rank 0's writes are done
        x = TS.recvfrom(0)
        c = TS.recvfrom(0, tag="c")
        return (x.tolist(), c[0].tolist(), c[1]["k"].tolist(),
                c[1]["a"].tolist(), c[2][0].tolist())

    out = TS.spmd(prog, pids=[0, 1])
    assert out[0] == [7.0] * 4
    assert out[1] == ([0.0] * 4,) * 3 + ([0.0] * 3, [0.0] * 4)


def test_bcast_receivers_get_their_own_copy():
    def prog():
        me = TS.myid()
        t = TS.bcast(torch.arange(4.0) if me == 0 else None, root=0)
        t.mul_(1.0 - 2.0 * (me == 1))        # rank 1 negates its copy
        TS.barrier()
        part = TS.scatter(torch.arange(8.0) if me == 0 else None, root=0)
        part.mul_(1.0 - 2.0 * (me == 2))     # rank 2 negates its part
        TS.barrier()
        return t.tolist(), part.tolist()

    out = TS.spmd(prog, pids=range(4))
    assert out[1][0] == [0.0, -1.0, -2.0, -3.0]
    assert all(o[0] == [0.0, 1.0, 2.0, 3.0] for k, o in enumerate(out)
               if k != 1)
    assert [o[1] for o in out] == [[0.0, 1.0], [2.0, 3.0], [-4.0, -5.0],
                                   [6.0, 7.0]]


# ---------------------------------------------------------------------------
# the static collectives against JAX's run_spmd
# ---------------------------------------------------------------------------


def _mesh42():
    return Mesh(np.asarray(jax.devices()[:8]).reshape(4, 2), ("a", "b"))


def _grid(x, g0, g1):
    return [[torch.from_numpy(np.ascontiguousarray(c))
             for c in np.split(r, g1, axis=1)]
            for r in np.split(x, g0, axis=0)]


@pytest.mark.parametrize("halo,wrap", [(1, False), (1, True), (2, False),
                                       (3, True)])
def test_halo_exchange_2d_like_jax(halo, wrap):
    x = np.random.default_rng(halo).integers(-9, 9, (24, 16)).astype(
        np.float32)
    jy = np.asarray(JC.run_spmd(
        lambda b: JC.halo_exchange_2d(b, ("a", "b"), halo=halo, wrap=wrap),
        _mesh42(), (P("a", "b"),), P("a", "b"))(x))
    got = TC.run_spmd(
        lambda g: TC.halo_exchange_2d(g, halo=halo, wrap=wrap),
        [[0, 1], [2, 3], [4, 5], [6, 7]], _grid(x, 4, 2))
    want = _grid(jy, 4, 2)
    for a in range(4):
        for b in range(2):
            assert got[a][b].device == tdat.device_of(2 * a + b)
            np.testing.assert_array_equal(got[a][b].numpy(),
                                          want[a][b].numpy())


@pytest.mark.parametrize("root", [0, 3, 7])
def test_pbcast_like_jax(root):
    x = np.random.default_rng(root).integers(-9, 9, (16, 3)).astype(
        np.float32)
    jy = np.asarray(JC.run_spmd(lambda b: JC.pbcast(b, "p", root=root),
                                JC.spmd_mesh(8), (P("p", None),),
                                P("p", None))(x))
    got = TC.run_spmd(lambda bs: TC.pbcast(bs, root), TC.spmd_mesh(8),
                      list(np.split(x, 8)))
    np.testing.assert_array_equal(torch.cat(got).numpy(), jy)
    with pytest.raises(ValueError, match="root"):
        TC.pbcast(got, 8)


def test_pbarrier_and_axis_rank_like_jax():
    x = np.ones((8, 2), np.float32)
    jy = np.asarray(JC.run_spmd(lambda b: b * JC.pbarrier("p"),
                                JC.spmd_mesh(8), (P("p", None),),
                                P("p", None))(x))
    got = TC.run_spmd(lambda bs: [b * n for b, n in zip(bs, TC.pbarrier(bs))],
                      TC.spmd_mesh(8), list(np.split(x, 8)))
    np.testing.assert_array_equal(torch.cat(got).numpy(), jy)
    z = np.zeros((8, 4), np.float32)
    jr = np.asarray(JC.run_spmd(
        lambda b: b + 10 * JC.axis_rank("a") + JC.axis_rank("b")
        + 100 * JC.axis_size("a") + 1000 * JC.axis_size("b"),
        _mesh42(), (P("a", "b"),), P("a", "b"))(z))

    def body(g):
        r0, r1 = TC.axis_rank(g, 0), TC.axis_rank(g, 1)
        n = 100 * TC.axis_size(g, 0) + 1000 * TC.axis_size(g, 1)
        return [[b + 10 * r0[a][c] + r1[a][c] + n for c, b in enumerate(row)]
                for a, row in enumerate(g)]

    got = body(_grid(z, 4, 2))
    np.testing.assert_array_equal(
        torch.cat([torch.cat(row, 1) for row in got]).numpy(), jr)
    assert TC.spmd_mesh() == list(range(8)) and TC.spmd_mesh(3) == [0, 1, 2]
    with pytest.raises(ValueError):
        TC.spmd_mesh(9)


def test_run_spmd_takes_a_darray():
    x = np.arange(48.0, dtype=np.float32).reshape(8, 6)
    d = tdat.distribute(x, procs=range(8), dist=(4, 2))
    got = TC.run_spmd(lambda g: [[b * 2 for b in row] for row in g],
                      d.pids.tolist(), d)
    for ci in d.cells():
        np.testing.assert_array_equal(got[ci[0]][ci[1]].numpy(),
                                      d.part(ci).numpy() * 2)
    with pytest.raises(ValueError, match="passed to a program"):
        TC.run_spmd(lambda g: g, [[0, 1]], d)
