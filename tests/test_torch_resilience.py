"""The port's resilience cores (``resilience/faults.py``, ``elastic.py``,
``recovery.py``) and the divergence checker (``analysis/divergence.py``)
against the JAX package's: the same fault plan and seed give the same
decisions (``history()``), simulated-down sets, jitter, slow-link delays
and corrupted bytes over a few hundred site calls; ``RetryPolicy.delay``
and ``classify`` agree; ``run_with_recovery`` makes the same attempts
with the same outcomes and counters under injected faults; elastic
``mark_down`` -> ``shrink`` -> ``grow`` gives JAX's pids and cuts with the
values intact; the divergence checker raises on the same mismatched
program.  All comparisons are exact."""

import json

import numpy as np
import pytest
import torch

import distributedarrays_tpu as dat
import distributedarrays_tpu_torch as tdat
from distributedarrays_tpu import telemetry as JT
from distributedarrays_tpu.analysis import divergence as JDV
from distributedarrays_tpu.parallel import spmd_mode as JS
from distributedarrays_tpu.resilience import domains as JD
from distributedarrays_tpu.resilience import elastic as JE
from distributedarrays_tpu.resilience import faults as JF
from distributedarrays_tpu.resilience import recovery as JR
from distributedarrays_tpu_torch import telemetry as TT
from distributedarrays_tpu_torch.analysis import divergence as TDV
from distributedarrays_tpu_torch.parallel import spmd_mode as TS
from distributedarrays_tpu_torch.resilience import domains as TD
from distributedarrays_tpu_torch.resilience import elastic as TE
from distributedarrays_tpu_torch.resilience import faults as TF
from distributedarrays_tpu_torch.resilience import recovery as TR

from _torch_port import (jax_plan_cache, jax_process_state,  # noqa: F401
                         port_ranks)

PKGS = [(JF, JE, JR, JT), (TF, TE, TR, TT)]


@pytest.fixture(autouse=True)
def clean(monkeypatch, port_ranks):
    for var in ("DA_TPU_FAULT_PLAN", "DA_TPU_FAULT_SEED", "DA_TPU_DOMAINS",
                "DA_TPU_CHECK_DIVERGENCE"):
        monkeypatch.delenv(var, raising=False)
    for f, e, _, t in PKGS:
        f.clear()
        e.manager().reset()
        t.enable()
        t.reset()
    JD.reset()
    TD.reset()
    yield
    TF.clear()
    TE.manager().reset()
    TD.reset()
    TT.reset()


PLAN = [
    {"site": "spmd.rank", "match": {"rank": 2}, "action": "device_loss",
     "at": 2, "count": 2, "device": 2, "revive_after": 3},
    {"site": "spmd.collective", "match": {"op": "barrier"}, "action": "raise",
     "at": 5, "count": -1, "p": 0.3},
    {"site": "reshard.chunk", "action": "slow_link", "at": 1, "count": 4,
     "hang_s": 0.0},
    {"site": "solver.iterate", "action": "hang", "at": 3, "count": 2,
     "device": 6, "hang_s": 0.0, "revive_after": 1},
    {"site": "checkpoint.read", "action": "corrupt", "at": 1, "count": 3,
     "flips": 5},
    {"site": "spmd.rank", "match": {"rank": 0}, "action": "partition",
     "at": 9, "count": 1, "groups": [[0, 1, 2, 3, 4], [5, 6, 7]],
     "observer": 0, "revive_after": 2},
    {"site": "solver.iterate", "action": "raise", "p": 0.5, "at": 1,
     "count": 50},
]

SITES = [("spmd.rank", {"backend": "thread"}, "rank"),
         ("spmd.collective", {"op": "barrier"}, "rank"),
         ("spmd.collective", {"op": "bcast"}, "rank"),
         ("reshard.chunk", {"strategy": "chain", "op": "reshard"}, None),
         ("solver.iterate", {"solver": "cg"}, None),
         ("checkpoint.read", {"store": "local"}, None)]


def drive(F, seed):
    """A few hundred site calls, probe ticks, jitter draws, delays and
    corruptions; everything the injector decides, in order."""
    F.configure(json.dumps(PLAN), seed=seed)
    trace = []
    payload = {"a": np.arange(16, dtype=np.float32),
               "b": np.arange(6, dtype=np.int64)}
    for i in range(320):
        site, labels, ranked = SITES[i % len(SITES)]
        labels = dict(labels)
        if ranked:
            labels["rank"] = (i // len(SITES)) % 4
        spec = F.decide(site, **labels)
        trace.append(None if spec is None else (spec.index, spec.action))
        if spec is not None and spec.action == "slow_link":
            trace.append(("delay", F.slow_link_delay(spec)))
        if spec is not None and spec.action == "corrupt":
            bad = F.corrupt_arrays(spec, payload)
            trace.append(("corrupt", {k: v.tobytes() for k, v in
                                      bad.items()}))
        if i % 17 == 0:
            trace.append(("tick", sorted(F.probe_tick())))
            trace.append(("part", F.partition_state()))
        if i % 23 == 0:
            trace.append(("jitter", F.jitter(0.5)))
        if i == 200:
            F.revive(2)
            F.heal_partition()
    trace.append(("down", sorted(F.simulated_down())))
    return F.history(), trace


@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_fault_decisions_equal_jax(seed):
    jh, jt = drive(JF, seed)
    th, tt = drive(TF, seed)
    assert len(jh) > 40
    assert th == jh
    assert tt == jt
    actions = {h["action"] for h in th}
    assert actions >= {"device_loss", "raise", "slow_link", "hang", "corrupt",
                       "partition"}


def test_env_plan_and_check_act_like_jax(monkeypatch, tmp_path):
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(PLAN))
    monkeypatch.setenv("DA_TPU_FAULT_PLAN", str(path))
    monkeypatch.setenv("DA_TPU_FAULT_SEED", "99")
    outcomes = []
    for F in (JF, TF):
        F.configure()
        got = []
        for i in range(12):
            try:
                F.check("spmd.rank", rank=2, backend="thread")
                got.append("ok")
            except F.InjectedFault as e:
                got.append((type(e).__name__, e.labels))
        outcomes.append((got, F.history(), F.active()))
    assert outcomes[0] == outcomes[1]
    assert outcomes[1][0][1][0] == "InjectedDeviceLoss"
    for F in (JF, TF):
        with pytest.raises(ValueError):
            F.configure([{"site": "x", "action": "nope"}])
        with pytest.raises(ValueError):
            F.configure([{"site": "x", "bogus": 1}])


def test_corrupt_arrays_on_tensors_matches_numpy():
    payload = {"w": np.arange(24, dtype=np.float32).reshape(4, 6),
               "i": np.arange(5, dtype=np.int32)}
    plan = [{"site": "checkpoint.read", "action": "corrupt", "at": 1,
             "count": 4, "flips": 7}]
    for F in (JF, TF):
        F.configure(plan, seed=5)
    for _ in range(4):
        js, ts = JF.decide("checkpoint.read"), TF.decide("checkpoint.read")
        jb = JF.corrupt_arrays(js, payload)
        tb = TF.corrupt_arrays(ts, {k: torch.from_numpy(v)
                                    for k, v in payload.items()})
        for k in payload:
            assert isinstance(tb[k], torch.Tensor)
            assert tb[k].numpy().tobytes() == np.asarray(jb[k]).tobytes()
    assert TT.counter_value("faults.corruptions") == 4
    # the caller's buffers are never mutated
    assert payload["i"].tolist() == [0, 1, 2, 3, 4]


@pytest.mark.parametrize("seed", [None, 3])
def test_retry_delay_equal_jax(seed):
    if seed is not None:
        for F in (JF, TF):
            F.configure([{"site": "never", "action": "raise"}], seed=seed)
    for pol in (dict(), dict(base_delay=0.1, backoff=3.0, max_delay=1.0,
                             jitter=0.25)):
        jp, tp = JR.RetryPolicy(**pol), TR.RetryPolicy(**pol)
        for i in range(8):
            jd, td = jp.delay(i), tp.delay(i)
            if seed is None:           # genuinely random jitter
                base = min(jp.base_delay * jp.backoff ** i, jp.max_delay)
                assert base <= td < base * (1 + tp.jitter)
            else:
                assert td == jd
            # a budget clamps the sleep (one draw each, streams in step)
            assert tp.delay(i, remaining_s=0.001) <= 0.001
            jp.delay(i, remaining_s=0.001)


def _exceptions(pkg):
    F, DV = pkg
    spec = F.FaultSpec(site="s", action="raise")
    part = F.FaultSpec(site="s", action="partition", groups=[[0, 1], [2]])

    def chained(inner):
        try:
            try:
                raise inner
            except Exception as e:
                raise RuntimeError("spmd task on rank 1 failed") from e
        except RuntimeError as outer:
            return outer
    return [
        F.InjectedFault(spec, {}), F.InjectedDeviceLoss(spec, {"rank": 3}),
        F.InjectedPartition(part, {}), DV.CollectiveDivergenceError("x"),
        TimeoutError("slow"), RuntimeError("receive timed out after 1s"),
        RuntimeError("DATA_LOSS: device lost"), RuntimeError("unreachable"),
        RuntimeError("network partition seen"), ValueError("bad"),
        RuntimeError("child: InjectedDeviceLoss: at spmd.rank"),
        RuntimeError("CollectiveDivergenceError in rank 2"),
        chained(F.InjectedDeviceLoss(spec, {})),
        chained(TimeoutError()), chained(DV.CollectiveDivergenceError("y")),
        chained(ValueError("plain")),
    ]


def test_classify_equal_jax():
    j = [JR.classify(e) for e in _exceptions((JF, JDV))]
    t = [TR.classify(e) for e in _exceptions((TF, TDV))]
    assert t == j
    assert set(t) == set(JR.VERDICTS)


def run_recovering(pkg, plan, *, policy=None, calls=None):
    """``run_with_recovery`` of a function that hits one fault site and
    returns how often it ran; the outcome, attempts and recovery
    counters."""
    F, E, R, T = pkg
    F.configure(plan, seed=11)
    n = [0]

    def work():
        n[0] += 1
        F.check("solver.iterate", solver="cg")
        return n[0]
    pol = policy or R.RetryPolicy(base_delay=0.0, max_delay=0.0)
    try:
        out = ("ok", R.run_with_recovery(work, policy=pol))
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        out = ("raised", type(e).__name__, getattr(e, "side", None))
    counters = {k: v for k, v in T.report()["counters"].items()
                if k.startswith(("recovery.", "elastic.", "faults.",
                                 "multihost."))}
    return out, n[0], counters, F.history(), sorted(E.manager().down_ranks())


PLANS = {
    "transient twice": [{"site": "solver.iterate", "action": "raise",
                         "at": 1, "count": 2}],
    "gives up": [{"site": "solver.iterate", "action": "raise", "count": -1}],
    "device loss": [{"site": "solver.iterate", "action": "device_loss",
                     "at": 1, "count": 1, "device": 5}],
    "partition quorum": [{"site": "solver.iterate", "action": "partition",
                          "groups": [[0, 1, 2, 3, 4], [5, 6, 7]],
                          "observer": 1}],
    "partition minority": [{"site": "solver.iterate", "action": "partition",
                            "groups": [[0, 1, 2, 3, 4], [5, 6, 7]],
                            "observer": 6}],
    "seeded p": [{"site": "solver.iterate", "action": "raise", "p": 0.6,
                  "count": -1}],
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_run_with_recovery_like_jax(name):
    j = run_recovering(PKGS[0], PLANS[name])
    t = run_recovering(PKGS[1], PLANS[name])
    assert t == j
    if name == "gives up":
        assert t[0][0] == "raised" and t[1] == 4          # 1 + 3 retries
    if name == "partition minority":
        assert t[0] == ("raised", "MinorityPartitionExit", [5, 6, 7])


def test_timeout_retried_once_like_jax():
    outs = []
    for F, E, R, T in PKGS:
        n = [0]

        def stuck():
            n[0] += 1
            raise TimeoutError("SPMD receive timed out")
        with pytest.raises(TimeoutError):
            R.run_with_recovery(stuck, policy=R.RetryPolicy(base_delay=0.0))
        outs.append((n[0], T.counter_value("recovery.fresh_mesh"),
                     T.counter_value("recovery.giveups", verdict="timeout")))
    assert outs[0] == outs[1] == (2, 1, 1)


@pytest.mark.parametrize("message", [
    "CUDA kernel build failed: stencil.cu", "nvcc not found: the CUDA",
    "CUDA error: an illegal memory access was encountered"])
def test_kernel_failures_retry_with_the_kernel_then_raise(message):
    """A kernel build or launch error is ``transient`` as in JAX: every
    attempt runs the call that launches the kernel again, and once the
    retries are spent the error re-raises; no attempt returns without
    it."""
    seen = []
    for R, T in ((JR, JT), (TR, TT)):
        n = [0]

        def launch():
            n[0] += 1
            raise RuntimeError(message)
        with pytest.raises(RuntimeError, match=message.split(":")[0]):
            R.run_with_recovery(launch, policy=R.RetryPolicy(base_delay=0.0))
        seen.append((R.classify(RuntimeError(message)), n[0],
                     T.counter_value("recovery.giveups", verdict="transient")))
    assert seen[1] == seen[0] == ("transient", 4, 1)


def test_resilient_decorator_and_checkpoint_restore():
    class Store:                       # duck-typed like a checkpoint manager
        def __init__(self):
            self.saved = {"w": 1}
            self.calls = 0

        def restore(self):
            self.calls += 1
            return dict(self.saved)

        def steps(self):
            return [0]
    store, seen = Store(), []
    TF.configure([{"site": "solver.iterate", "action": "raise",
                   "count": 2}])

    @TR.resilient(policy=TR.RetryPolicy(base_delay=0.0), checkpoints=store,
                  restore_fn=seen.append)
    def step(x):
        TF.check("solver.iterate")
        return x * 2
    assert step(21) == 42
    assert store.calls == 2 and seen == [{"w": 1}, {"w": 1}]
    assert TT.counter_value("recovery.restores") == 2


LAYOUTS = [((32, 8), (8, 1)), ((32, 8), (4, 2)), ((50, 8), (4, 2))]


@pytest.mark.parametrize("dims,dist", LAYOUTS)
def test_elastic_shrink_and_grow_like_jax(dims, dist):
    x = np.random.default_rng(3).standard_normal(dims).astype(np.float32)
    jd = dat.distribute(x, dist=list(dist))
    td = tdat.distribute(x, dist=list(dist))
    seen = []
    for E, d in ((JE, jd), (TE, td)):
        m = E.manager()
        m.mark_down(5)
        m.mark_down(2)
        s = m.shrink()
        after_shrink = (np.asarray(d.pids).tolist(), d.cuts, s["moved"],
                        s["failed"], s["live"])
        m.mark_up(2)
        g1 = m.grow()
        partial = (np.asarray(d.pids).tolist(), d.cuts, g1["moved"])
        m.mark_up(5)
        g2 = m.grow()
        seen.append((after_shrink, partial,
                     (np.asarray(d.pids).tolist(), d.cuts, g2["moved"]),
                     m.live_ranks()))
        np.testing.assert_array_equal(np.asarray(dat.gather(d)) if E is JE
                                      else tdat.gather(d), x)
    assert seen[1] == seen[0]
    assert seen[1][0][0] != np.asarray(td.pids).tolist() or dist == (8, 1)
    assert td.id in {a.id for a in tdat.live_arrays()}   # the same array
    for ci in td.cells():
        assert td.part(ci).device == tdat.device_of(int(td.pids[ci]))
    jd.close()


def test_shrink_moves_through_the_planner(monkeypatch):
    """A shrink onto an uneven survivor layout gathers through
    ``reshard.allgather`` (the planner's ``gather_put``: K10/K11 on the
    card) and each survivor keeps its window; an even one is the planned
    reshard (here ``device_put``, as JAX plans it)."""
    from distributedarrays_tpu_torch.parallel import reshard as R
    calls = []
    real_ag, real_rp = R.allgather, R.relayout_parts
    monkeypatch.setattr(R, "allgather", lambda d, r, **k: (
        calls.append(("allgather", R.plan_allgather(d, r).strategy)),
        real_ag(d, r, **k))[1])
    monkeypatch.setattr(R, "relayout_parts", lambda d, p, c, **k: (
        calls.append(("relayout", R.plan_reshard(d, p, c).strategy)),
        real_rp(d, p, c, **k))[1])
    x = np.arange(256, dtype=np.float32).reshape(16, 16)
    d = tdat.distribute(x, dist=[8, 1])
    m = TE.manager()
    for r in (4, 5, 6, 7):
        m.mark_down(r)
    m.shrink()                                 # 4 survivors: (2, 2), even
    assert [int(p) for p in d.pids.flat] == [0, 1, 2, 3]
    m.mark_down(3)
    m.shrink()                                 # 3 survivors: (3, 1), uneven
    assert calls == [("relayout", "device_put"), ("allgather", "gather_put")]
    assert d.cuts == [[0, 6, 11, 16], [0, 16]]
    np.testing.assert_array_equal(tdat.gather(d), x)
    assert [(s["labels"]["op"], s["labels"]["strategy"])
            for s in TT.spans("reshard")] == [("elastic", "device_put"),
                                               ("elastic", "gather_put")]
    assert TT.counter_value("elastic.relayouts") == 2


def test_probe_revives_simulated_devices_like_jax(monkeypatch):
    monkeypatch.setenv("DA_TPU_ELASTIC_HW_PROBE", "0")
    plan = [{"site": "spmd.rank", "action": "device_loss", "device": 3,
             "revive_after": 2}]
    seen = []
    for F, E, _, T in PKGS:
        F.configure(plan)
        with pytest.raises(F.InjectedDeviceLoss):
            F.check("spmd.rank", rank=0)
        m = E.manager()
        probes = [m.probe() for _ in range(3)]
        seen.append(([(p["live"], p["down"], p["changed"],
                       p["partition"]["verdict"]) for p in probes],
                     T.counter_value("elastic.probes"),
                     T.counter_value("multihost.quorum_checks",
                                     verdict="healthy"),
                     T.gauge_value("elastic.live_devices")))
    assert seen[1] == seen[0]


def test_hardware_probe_reads_the_card_count(monkeypatch):
    m = TE.manager()
    assert m._hw_probe() == set()                # CPU ranks never go down
    tdat.init(nranks=4, device="cuda:1")         # a table on a second card
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert m._hw_probe() == {0, 1, 2, 3}         # that card is gone
    monkeypatch.setenv("DA_TPU_ELASTIC_HW_PROBE", "0")
    assert m._hw_probe() == set()
    tdat.init(nranks=8, device="cpu")


def _mismatched():
    def prog(S):
        if S.myid() == 2:  # dalint: disable=DAL010 — seeded divergence: the checker must raise
            S.bcast(None, 0)
        else:
            S.barrier()
        return S.myid()
    return prog


def test_divergence_checker_raises_like_jax(monkeypatch):
    monkeypatch.setenv("DA_TPU_CHECK_DIVERGENCE", "1")
    errs = []
    for S, DV, T in ((JS, JDV, JT), (TS, TDV, TT)):
        assert DV.checking()
        prog = _mismatched()
        n0 = T.flight.crash_bundle_count()
        with pytest.raises(DV.CollectiveDivergenceError) as ei:
            S.spmd(prog, S, pids=[0, 1, 2, 3], timeout=30)
        errs.append(str(ei.value).splitlines()[0])
        assert T.flight.crash_bundle_count() == n0 + 1
        assert [e["name"] for e in T.events("divergence")] == ["mismatch"]
        # a matching program passes the checker
        assert S.spmd(lambda: (S.barrier(), S.gather_spmd(
            np.zeros(3), 0), S.myid())[2], pids=[0, 1, 2]) == [0, 1, 2]
    assert errs[1] == errs[0]


def test_divergence_checker_units_like_jax():
    for DV in (JDV, TDV):
        ck = DV.DivergenceChecker([0, 1])
        ck.record(0, "barrier", "tag=None")
        ck.record(1, "barrier", "tag=None")
        ck.finish(0)
        with pytest.raises(DV.CollectiveDivergenceError,
                           match="already finished"):
            ck.record(1, "bcast", "root=0")
    assert TDV.payload_signature(torch.zeros(2, 3)) == \
        "Tensor(2, 3):torch.float32@cpu"
    assert TDV.payload_signature([1, 2]) == JDV.payload_signature([1, 2])
    assert TDV.payload_signature(np.zeros(4, np.int8)) == \
        JDV.payload_signature(np.zeros(4, np.int8))


def test_domains_configure_event_and_buddy_map_live_ranks():
    for D, T in ((JD, JT), (TD, TT)):
        D.configure("5,3")
    assert [{k: v for k, v in e.items() if k in ("cat", "name", "domains",
                                                 "ranks", "sizes")}
            for e in TT.events("domains")] == \
        [{k: v for k, v in e.items() if k in ("cat", "name", "domains",
                                              "ranks", "sizes")}
         for e in JT.events("domains")]
    for E in (JE, TE):
        E.manager().mark_down(6)
    assert TD.buddy_map() == JD.buddy_map()
    assert 6 not in TD.buddy_map()
