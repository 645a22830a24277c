"""The telemetry, divergence and fault wiring of the port's ``spmd_mode``,
``spmd_process``, ``reshard`` and ``utils/debug.py`` against the JAX
package's: the same SPMD programs and reshards give JAX's counters, comm
records, span names and labels, fault-site hits and flight bundles.  All
comparisons are exact; the port's ``reshard`` span leaves out JAX's
XLA/RDMA dispatch labels (the module docstring says why)."""

import json

import numpy as np
import pytest

import distributedarrays_tpu as dat
import distributedarrays_tpu_torch as tdat
from distributedarrays_tpu import telemetry as JT
from distributedarrays_tpu.parallel import reshard as JR
from distributedarrays_tpu.parallel import spmd_mode as JS
from distributedarrays_tpu.resilience import faults as JF
from distributedarrays_tpu.utils import debug as JDBG
from distributedarrays_tpu_torch import telemetry as TT
from distributedarrays_tpu_torch.parallel import reshard as TR
from distributedarrays_tpu_torch.parallel import spmd_mode as TS
from distributedarrays_tpu_torch.resilience import faults as TF
from distributedarrays_tpu_torch.utils import debug as TDBG

from _torch_port import (jax_plan_cache, jax_process_state,  # noqa: F401
                         port_ranks)

PORT = (tdat, TS, TF, TT, TR)
JAX = (dat, JS, JF, JT, JR)
# the JAX span labels that name its XLA/RDMA dispatch, which the port has not
DISPATCH = ("dispatch", "rdma_chunks", "rdma_chunks_source", "autotune_key",
            "dispatch_key", "dispatch_source")


@pytest.fixture(autouse=True)
def clean(monkeypatch, port_ranks):
    for var in ("DA_TPU_FAULT_PLAN", "DA_TPU_CHECK_DIVERGENCE"):
        monkeypatch.delenv(var, raising=False)
    for _, _, F, T, R in (JAX, PORT):
        F.clear()
        T.enable()
        T.reset()
        R._plan_cached.cache_clear()
    yield
    TF.clear()
    TT.reset()


def program(S):
    """Every mailbox primitive and eager collective once or twice."""
    def f():
        me = S.myid()
        n = S.nprocs()
        S.sendto((me + 1) % n, np.full(8, me, dtype=np.float32), tag="ring")
        got = S.recvfrom((me - 1) % n, tag="ring")
        S.barrier()
        root = S.bcast(np.arange(4, dtype=np.int32) if me == 0 else None, 0)
        part = S.scatter(np.arange(8, dtype=np.float64), 1)
        g = S.gather_spmd(np.ones(2, dtype=np.float32) * me, 2)
        S.sendto(0, b"hi", tag="any")
        if me == 0:
            for _ in range(n):
                S.recvfrom_any(tag="any")
        S.barrier()
        return float(got[0]), int(root.sum()), float(part.sum()), \
            None if g is None else len(g)
    return f


def observed(T, spans=("spmd.run", "spmd.step")):
    rep = T.report()
    return (rep["counters"], rep["comm"],
            sorted((s["name"], sorted(s.get("labels", {}).items()))
                   for s in T.spans() if s["name"] in spans),
            {k: v["count"] for k, v in T.span_stats().items()},
            sorted((e["cat"], e.get("name")) for e in T.events()
                   if e["cat"] in ("spmd", "comm", "faults")))


@pytest.mark.parametrize("backend", ["thread", "process"])
def test_spmd_program_telemetry_like_jax(backend):
    seen = []
    for _, S, _, T, _ in (JAX, PORT):
        out = S.spmd(program(S), pids=[0, 1, 2, 3], backend=backend)
        seen.append((out, observed(T)))
    assert seen[1] == seen[0]
    counters = seen[1][1][0]
    assert counters[f"spmd.runs{{backend={backend}}}"] == 1
    if backend == "thread":
        assert counters["spmd.recv"] == 4 + 4
        assert counters["spmd.barrier"] == 8
        assert seen[1][1][3]["spmd.mailbox.drain"] > 0
    assert seen[1][1][2].count(("spmd.run", [("backend", backend),
                                             ("ranks", 4)])) == 1
    assert len([s for s in seen[1][1][2] if s[0] == "spmd.step"]) == 4


def test_spmd_collective_fault_site_like_jax():
    plan = [{"site": "spmd.collective", "match": {"op": "barrier", "rank": 2},
             "action": "raise", "at": 2}]
    seen = []
    for _, S, F, T, _ in (JAX, PORT):
        F.configure(plan, seed=3)
        n0 = T.flight.crash_bundle_count()
        with pytest.raises(RuntimeError) as ei:
            S.spmd(program(S), pids=[0, 1, 2, 3])
        cause = ei.value.__cause__
        assert isinstance(cause, F.InjectedFault)
        seen.append((F.history(), type(cause).__name__,
                     T.flight.crash_bundle_count() - n0,
                     T.counter_value("faults.fired",
                                     site="spmd.collective", action="raise"),
                     [e["name"] for e in T.events("faults")]))
    assert seen[1] == seen[0]
    assert seen[1][2] == 1                    # one bundle for the run


@pytest.mark.parametrize("backend", ["thread", "process"])
def test_spmd_rank_fault_site_like_jax(backend):
    plan = [{"site": "spmd.rank", "match": {"rank": 1},
             "action": "device_loss", "at": 2}]
    seen = []
    for _, S, F, T, _ in (JAX, PORT):
        F.configure(plan, seed=1)
        assert S.spmd(lambda: S.myid(), pids=[0, 1, 2],
                      backend=backend) == [0, 1, 2]
        with pytest.raises(RuntimeError) as ei:
            S.spmd(lambda: S.myid(), pids=[0, 1, 2], backend=backend)
        assert "InjectedDeviceLoss" in repr(ei.value.__cause__) + \
            str(ei.value)
        steps = sorted((dict(s["labels"])["rank"], s.get("labels", {}).get(
            "backend"), bool(s.get("error"))) for s in T.spans("spmd.step"))
        seen.append((F.history(), F.simulated_down(), steps))
    assert seen[1] == seen[0]
    assert [h["labels"] for h in seen[1][0]] == [
        {"rank": 1, "backend": backend}]


def test_divergence_unchecked_on_process_backend_like_jax(monkeypatch):
    monkeypatch.setenv("DA_TPU_CHECK_DIVERGENCE", "1")
    for D in (JDBG, TDBG):
        D._warned.discard("divergence:process-backend")
    seen = []
    for _, S, _, T, _ in (JAX, PORT):
        with pytest.warns(RuntimeWarning, match="not instrumented"):
            S.spmd(lambda: S.myid(), pids=[0, 1], backend="process")
        seen.append((T.counter_value("analysis.divergence_unchecked",
                                     backend="process"),
                     [e["name"] for e in T.events("divergence")],
                     T.counter_value("fallback.hits",
                                     key="divergence:process-backend")))
    assert seen[1] == seen[0] == (1, ["unchecked_backend"], 1)


def test_warn_once_counts_and_journals_like_jax():
    seen = []
    for D, T in ((JDBG, JT), (TDBG, TT)):
        D._warned.discard("wiring:test")
        with pytest.warns(RuntimeWarning, match="host path"):
            D.warn_once("wiring:test", "took the host path")
        D.warn_once("wiring:test", "took the host path")
        seen.append((T.counter_value("fallback.hits", key="wiring:test"),
                     [(e["name"], e["message"])
                      for e in T.events("fallback")]))
    assert seen[1] == seen[0] == (2, [("wiring:test", "took the host path")])


# even layout pairs (JAX moves ceil-uneven DArrays through its blocked
# padding, which the port has no use for): an all-to-all, the mesh-axis
# transpose chain, moves onto fewer ranks
MOVES = [((64, 32), (8, 1), (1, 8)), ((48, 48), (4, 2), (2, 4)),
         ((64, 64), (2, 2), (4, 1)), ((32, 32), (8, 1), (2, 2))]


def _samedist(pkg, x, src, dst):
    d = pkg.distribute(x, dist=list(src))
    like = pkg.dzeros(x.shape, dist=list(dst))
    out = pkg.samedist(d, like)
    return d, like, out


@pytest.mark.parametrize("dims,src,dst", MOVES)
def test_reshard_span_counters_and_comm_like_jax(dims, src, dst):
    x = np.random.default_rng(5).standard_normal(dims).astype(np.float32)
    seen = []
    for pkg, _, _, T, _ in (JAX, PORT):
        made = _samedist(pkg, x, src, dst)
        np.testing.assert_array_equal(np.asarray(pkg.gather(made[2])), x)
        labels = [{k: v for k, v in s["labels"].items() if k not in DISPATCH}
                  for s in T.spans("reshard")]
        counters = {k: v for k, v in T.report()["counters"].items()
                    if k.startswith("reshard.")}
        comm = [{k: e[k] for k in ("name", "bytes", "op", "strategy",
                                   "shape")}
                for e in T.events("comm") if e["name"] == "reshard"]
        plans = [{k: v for k, v in e.items() if k not in
                  ("t", "wall", "tid", "pid", "seq", "span_id")}
                 for e in T.events("reshard")]
        seen.append((labels, counters, comm, plans,
                     T.comm_bytes("reshard")))
        for d in made:
            d.close()
    assert seen[1] == seen[0]
    assert len(seen[1][0]) == 1 and seen[1][0][0]["op"] == "samedist"
    assert {"intra_bytes", "cross_bytes", "flops", "bytes_hbm",
            "bytes_ici"} <= set(seen[1][0][0])


def test_reshard_chunk_fault_site_like_jax():
    plan = [{"site": "reshard.chunk", "match": {"strategy": "chain"},
             "action": "raise", "at": 1}]
    x = np.arange(48 * 48, dtype=np.float32).reshape(48, 48)
    seen = []
    for pkg, _, F, T, _ in (JAX, PORT):
        F.configure(plan, seed=0)
        d = pkg.distribute(x, dist=[4, 2])
        like = pkg.dzeros((48, 48), dist=[2, 4])
        with pytest.raises(F.InjectedFault):
            pkg.samedist(d, like)
        np.testing.assert_array_equal(np.asarray(pkg.gather(d)), x)
        out = pkg.samedist(d, like)          # the plan fired once
        np.testing.assert_array_equal(np.asarray(pkg.gather(out)), x)
        errs = [bool(e.get("error")) for e in T.events("span")
                if e["name"] == "reshard"]
        seen.append((F.history(), errs,
                     T.counter_value("faults.fired", site="reshard.chunk",
                                     action="raise"),
                     T.comm_bytes("reshard")))
        for a in (d, like, out):
            a.close()
    assert seen[1] == seen[0]
    assert seen[1][1] == [True, False]


def test_allgather_and_chain_reshard_spans_on_the_port():
    """The port's gathers run in a ``reshard`` span like its reshards (JAX
    gathers by a reshard onto a replicated layout)."""
    d = tdat.drand((48, 48), dist=[4, 2])
    outs = TR.allgather(d, [0, 1, 2])
    assert len(outs) == 3
    TR.reshard(d, np.arange(8).reshape(2, 4), [[0, 24, 48],
                                               [0, 12, 24, 36, 48]])
    sp = [(s["labels"]["op"], s["labels"]["strategy"], s["labels"]["nsteps"])
          for s in TT.spans("reshard")]
    assert sp[0][:2] == ("allgather", "gather_put")
    assert sp[1][:2] == ("reshard", "chain") and sp[1][2] > 1
    assert TT.counter_value("reshard.plan_requests") == 2
    assert TT.comm_bytes("reshard") > 0
    ev = TT.events("reshard")
    assert {e["strategy"] for e in ev} >= {"chain"}
    json.dumps(TT.report())                   # the report stays JSON
