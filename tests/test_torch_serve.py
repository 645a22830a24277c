"""The port's serving layer (``serve/errors.py``, ``admission.py``,
``batching.py``, ``server.py``) against the JAX package's, on the
deterministic cases of ``tests/test_serve.py``, 8 CPU ranks: each
scenario runs through both packages and gives equal typed outcomes (error
class, ``reason``, ``stage``, ``tenant``, whether ``retry_after`` is
positive) and equal batch sizes.

Where a JAX case rests on wall-clock margins, the port's case is
event-driven instead: an endpoint blocks on an ``Event`` until the test
has queued what it needs, so batch sizes and queue depths do not depend
on timing; the two cases that must wait out a deadline or a backoff give
margins of 6x and more."""

import signal
import threading
import time

import numpy as np
import pytest
import torch

import distributedarrays_tpu as dat
import distributedarrays_tpu_torch as tdat
from distributedarrays_tpu import serve as JSV
from distributedarrays_tpu import telemetry as JT
from distributedarrays_tpu.resilience import elastic as JE
from distributedarrays_tpu.resilience import faults as JF
from distributedarrays_tpu.resilience import recovery as JR
from distributedarrays_tpu.telemetry import memory as JM
from distributedarrays_tpu_torch import serve as TSV
from distributedarrays_tpu_torch import telemetry as TT
from distributedarrays_tpu_torch.resilience import elastic as TE
from distributedarrays_tpu_torch.resilience import faults as TF
from distributedarrays_tpu_torch.resilience import recovery as TR
from distributedarrays_tpu_torch.telemetry import memory as TM

from _torch_port import (jax_plan_cache, jax_process_state,  # noqa: F401
                         port_ranks)

# (serve, telemetry, memory, faults, elastic, recovery, package)
J = (JSV, JT, JM, JF, JE, JR, dat)
T = (TSV, TT, TM, TF, TE, TR, tdat)


@pytest.fixture(autouse=True)
def clean(port_ranks):
    for sv, tm, m, f, e, r, p in (J, T):
        f.clear()
        e.manager().reset()
        tm.enable()
        tm.reset()
    yield
    for sv, tm, m, f, e, r, p in (J, T):
        f.clear()
        e.manager().reset()
    TT.reset()


def _cfg(pkg, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("flush_s", 0.005)
    kw.setdefault("max_queue", 32)
    kw.setdefault("tenant_rate", 10_000.0)
    kw.setdefault("tenant_burst", 10_000.0)
    return pkg[0].ServeConfig(**kw)


def _policy(pkg, **kw):
    kw.setdefault("base_delay", 0.005)
    kw.setdefault("max_delay", 0.02)
    return pkg[5].RetryPolicy(**kw)


def typed(e) -> tuple:
    """A typed outcome, comparable across the packages."""
    ra = getattr(e, "retry_after", None)
    return (type(e).__name__, getattr(e, "reason", None),
            getattr(e, "stage", None), getattr(e, "tenant", None),
            None if ra is None else ra > 0)


class Gate:
    """An endpoint that records its batches and blocks its first call
    until ``open()``: everything submitted meanwhile stays queued."""

    def __init__(self, fn=lambda xs: list(xs)):
        self.fn = fn
        self.batches = []
        self.entered = threading.Event()
        self.release = threading.Event()

    def __call__(self, xs):
        self.batches.append(list(xs))
        if not self.entered.is_set():
            self.entered.set()
            assert self.release.wait(30)
        return self.fn(xs)

    def hold(self, srv, ep, first):
        fut = srv.submit(ep, first)
        assert self.entered.wait(30)
        return fut

    def open(self):
        self.release.set()


# ---------------------------------------------------------------------------
# futures, batching, payload keys
# ---------------------------------------------------------------------------


def test_submit_resolves_results_in_order():
    with TSV.Server(_cfg(T)) as srv:
        srv.register("double", lambda xs: [x * 2 for x in xs])
        futs = [srv.submit("double", torch.full((3,), i)) for i in range(12)]
        for i, f in enumerate(futs):
            assert torch.equal(f.result(timeout=10), torch.full((3,), 2 * i))


def _batches(pkg, payloads, **cfg):
    """The batch sizes (and payload shapes) dispatched for ``payloads``,
    all queued behind a held first batch."""
    gate = Gate()
    with pkg[0].Server(_cfg(pkg, flush_s=0.0, **cfg)) as srv:
        srv.register("ep", gate)
        f0 = gate.hold(srv, "ep", payloads[0])
        futs = [srv.submit("ep", p) for p in payloads[1:]]
        gate.open()
        for f in [f0] + futs:
            f.result(timeout=10)
    return [[tuple(np.shape(x)) for x in b] for b in gate.batches]


def test_requests_coalesce_into_batches_like_jax():
    payloads = [np.zeros(2, np.float32) for _ in range(10)]
    got = _batches(T, payloads)
    assert got == _batches(J, payloads)
    assert [len(b) for b in got] == [1, 4, 4, 1]


def test_incompatible_shapes_never_share_a_batch_like_jax():
    payloads = [np.ones((2,)) if i % 2 else np.ones((3,)) for i in range(9)]
    got = _batches(T, payloads)
    assert got == _batches(J, payloads)
    assert all(len(set(b)) == 1 for b in got)
    tensors = [torch.ones(2) if i % 2 else torch.ones(3) for i in range(9)]
    assert _batches(T, tensors) == got


def test_payload_keys_equal_jax():
    cases = [np.zeros((2, 3)), np.ones((3, 2)), np.zeros(2, np.float32),
             np.zeros(2, np.float64), {"a": np.zeros(2), "b": 1}, (1, "x"),
             [1], (1,), {1: "a", "b": 2}, [1, 2], [1, 2, 3], 7, 2.5, None,
             "s", b"b", np.int32(3)]
    for c in cases:
        assert TSV.payload_key(c) == JSV.payload_key(c), c
    a = np.empty(2, dtype=object)
    a[0], a[1] = [1, 2], [3, 4, 5]
    assert TSV.payload_key(a) == JSV.payload_key(a)
    k = TSV.payload_key
    assert k(x for x in [1]) == k(x for x in [2, 3])
    # tensors and DArrays key as JAX's arrays and DArrays of their shape
    assert k(torch.zeros(2, 3)) == JSV.payload_key(np.zeros((2, 3),
                                                            np.float32))
    assert k(torch.zeros(2, dtype=torch.bfloat16)) == \
        ("array", (2,), "bfloat16")
    td = tdat.dzeros((6, 4))
    jd = dat.dzeros((6, 4))
    assert k(td) == JSV.payload_key(jd) == ("array", (6, 4), "float32")
    td.close()
    jd.close()


def _per_endpoint(pkg):
    gates = {"bulk": Gate(), "small": Gate()}
    with pkg[0].Server(_cfg(pkg, max_batch=2, flush_s=0.0)) as srv:
        srv.register("bulk", gates["bulk"], max_batch=6)
        srv.register("small", gates["small"], max_batch=2)
        f0 = gates["bulk"].hold(srv, "bulk", np.zeros(1))
        futs = [srv.submit("bulk", np.zeros(1)) for _ in range(12)]
        futs += [srv.submit("small", np.zeros(1)) for _ in range(4)]
        gates["small"].open()
        gates["bulk"].open()
        for f in [f0] + futs:
            f.result(timeout=10)
    return {n: [len(b) for b in g.batches] for n, g in gates.items()}


def test_per_endpoint_batch_limits_like_jax():
    got = _per_endpoint(T)
    assert got == _per_endpoint(J)
    assert max(got["bulk"]) == 6 and max(got["small"]) == 2


def test_ragged_prompts_batch_safely():
    def ep(xs):
        return [int(r.sum()) for r in np.stack([np.asarray(x) for x in xs])]

    with TSV.Server(_cfg(T, flush_s=0.02, max_batch=8)) as srv:
        srv.register("sum", ep)
        prompts = [[1] * (2 + i % 3) for i in range(12)]
        futs = [srv.submit("sum", p) for p in prompts]
        for p, f in zip(prompts, futs):
            assert f.result(timeout=10) == sum(p)


# ---------------------------------------------------------------------------
# typed outcomes
# ---------------------------------------------------------------------------


def _typed_basics(pkg):
    sv = pkg[0]
    out = []
    with sv.Server(_cfg(pkg, max_batch=1)) as srv:
        srv.register("known", lambda xs: xs)
        srv.register("bad", lambda xs: [])
        for call in (lambda: srv.submit("nope", 1),
                     lambda: srv.submit("known", 1, deadline_s=0.0)):
            try:
                call()
            except sv.ServeError as e:
                out.append(typed(e))
        try:
            srv.submit("bad", np.zeros(1)).result(timeout=10)
        except sv.RequestFailed as e:
            out.append(typed(e) + ("returned 0 results" in str(e),))
        srv.set_quota("greedy", rate=5.0, burst=1.0)
        out.append(srv.submit("known", 1, tenant="greedy").result(10))
        try:
            srv.submit("known", 2, tenant="greedy")
        except sv.QuotaExceeded as e:
            out.append(typed(e))
        out.append(srv.submit("known", 3, tenant="polite").result(10))
    try:
        srv.submit("known", 4)
    except sv.Draining as e:
        out.append(typed(e))
    out.append(pkg[1].counter_value("serve.shed", reason="quota",
                                    tenant="greedy"))
    out.append(pkg[1].counter_value("serve.expired", stage="enqueue"))
    return out


def test_typed_outcomes_equal_jax():
    assert _typed_basics(T) == _typed_basics(J) == [
        ("ServeError", None, None, None, None),
        ("DeadlineExceeded", None, "enqueue", None, None),
        ("RequestFailed", None, None, None, None, True), 1,
        ("QuotaExceeded", "quota", None, "greedy", True), 3,
        ("Draining", "draining", None, "default", None), 1, 1]


def _queue_bound(pkg):
    gate = Gate()
    srv = pkg[0].Server(_cfg(pkg, max_batch=1, flush_s=0.0, max_queue=4))
    try:
        srv.register("slow", gate)
        futs = [gate.hold(srv, "slow", 0)]
        out = []
        for i in range(1, 12):
            try:
                futs.append(srv.submit("slow", i))
            except pkg[0].Overloaded as e:
                out.append(typed(e))
        out.append(srv.stats()["queue_depth"])
        gate.open()
        out.append([f.result(timeout=10) for f in futs])
    finally:
        gate.open()
        srv.close()
    return out


def test_bounded_queue_sheds_typed_like_jax():
    got = _queue_bound(T)
    assert got == _queue_bound(J)
    assert got[:7] == [("Overloaded", "queue", None, "default", True)] * 7
    assert got[7] == 4 and got[8] == [0, 1, 2, 3, 4]


def _hbm_shed(pkg, budget):
    d = pkg[6].distribute(np.random.default_rng(3).standard_normal(
        (16, 16)).astype(np.float32))
    try:
        assert pkg[2].live_bytes() == 1024
        with pkg[0].Server(_cfg(pkg, hbm_budget_bytes=budget)) as srv:
            srv.register("echo", lambda xs: xs)
            try:
                return srv.submit("echo", 1).result(timeout=10)
            except pkg[0].Overloaded as e:
                return typed(e) + (str(e).split(";")[0],)
    finally:
        d.close()


@pytest.mark.parametrize("budget,shed", [(1, True), (1100, True),
                                         (1200, False)])
def test_hbm_shed_against_a_budget_like_jax(budget, shed):
    """Shed when the ledger's live bytes reach 0.9 of the budget: 1024 B
    live sheds at 1100 B (bound 990) and passes at 1200 (bound 1080)."""
    got = _hbm_shed(T, budget)
    assert got == _hbm_shed(J, budget)
    if shed:
        assert got[:5] == ("Overloaded", "hbm", None, "default", True)
        assert got[5].startswith("HBM live bytes 1024 over 90% of budget")
    else:
        assert got == 1


def test_hbm_budget_from_the_environment(monkeypatch):
    monkeypatch.setenv("DA_TPU_SERVE_HBM_BUDGET_MB", "1.5")
    assert TSV.ServeConfig().resolved_hbm_budget() == \
        JSV.ServeConfig().resolved_hbm_budget() == int(1.5 * (1 << 20))
    monkeypatch.setenv("DA_TPU_SERVE_HBM_BUDGET_MB", "junk")
    assert TSV.ServeConfig().resolved_hbm_budget() is None
    monkeypatch.delenv("DA_TPU_SERVE_HBM_BUDGET_MB")
    assert TSV.ServeConfig().resolved_hbm_budget() is None
    assert TSV.ServeConfig(hbm_budget_bytes=7).resolved_hbm_budget() == 7


def _retry_after_reclaimable(pkg):
    d = pkg[6].distribute(np.ones((16, 16), np.float32))
    try:
        live = pkg[2].live_bytes()

        def ctl(**kw):
            c = pkg[0].AdmissionController(
                max_queue=64, tenant_rate=1e6, tenant_burst=1e6,
                hbm_budget_bytes=live, hbm_shed_fraction=0.5, max_batch=1,
                **kw)
            for _ in range(8):
                c.latency.record(2.0)
            return c
        out = []
        for kw in ({}, {"reclaimable_fn": lambda: live},
                   {"reclaimable_fn": lambda: 1 / 0}):
            c = ctl(**kw)
            try:
                c.admit("t", queue_depth=2)
            except pkg[0].Overloaded as e:
                out.append((e.reason, e.retry_after,
                            "reclaimable by eviction" in str(e)))
        return out
    finally:
        d.close()


def test_hbm_shed_retry_after_accounts_reclaimable_like_jax():
    got = _retry_after_reclaimable(T)
    assert got == _retry_after_reclaimable(J)
    assert got[0][1] > 0.05 and got[1] == ("hbm", 0.05, True)
    assert got[2] == got[0]


def test_rolling_p99_sheds_and_token_bucket_like_jax():
    for sv in (JSV, TSV):
        ctl = sv.AdmissionController(max_queue=64, tenant_rate=1e6,
                                     tenant_burst=1e6, p99_shed_s=0.05,
                                     max_batch=4)
        for _ in range(16):
            ctl.latency.record(0.2)
        with pytest.raises(sv.Overloaded) as ei:
            ctl.admit("t", queue_depth=1)
        assert ei.value.reason == "latency" and ei.value.retry_after > 0
    w = TSV.LatencyWindow(maxlen=4)
    for v in (1.0,) * 4 + (0.1,) * 4:
        w.record(v)
    assert w.p99() == pytest.approx(0.1) and w.count() == 4
    b = TSV.TokenBucket(rate=100.0, burst=2.0)
    assert b.try_take() == 0.0 and b.try_take() == 0.0
    assert 0.0 < b.try_take() <= 0.011
    with pytest.raises(ValueError):
        TSV.TokenBucket(rate=0, burst=1)


# ---------------------------------------------------------------------------
# deadlines, drain, close, SIGTERM
# ---------------------------------------------------------------------------


def test_expired_queued_request_never_dispatched():
    gate = Gate()
    srv = TSV.Server(_cfg(T, max_batch=1, flush_s=0.0))
    try:
        srv.register("slow", gate)
        f1 = gate.hold(srv, "slow", "first")
        f2 = srv.submit("slow", "second", deadline_s=0.05)
        time.sleep(0.3)                  # 6x the budget, while queued
        gate.open()
        assert f1.result(timeout=10) == "first"
        with pytest.raises(TSV.DeadlineExceeded) as ei:
            f2.result(timeout=10)
        assert ei.value.stage in ("batch", "dispatch")
        assert gate.batches == [["first"]]
    finally:
        gate.open()
        srv.close()
    assert TT.counter_value("serve.expired", stage=ei.value.stage) == 1


def _drain(pkg):
    gate = Gate()
    srv = pkg[0].Server(_cfg(pkg, max_batch=2, flush_s=0.0))
    srv.register("work", gate)
    futs = [gate.hold(srv, "work", 0)]
    futs += [srv.submit("work", i) for i in range(1, 6)]
    gate.open()
    out = [srv.drain(timeout=10)]
    try:
        srv.submit("work", 99)
    except pkg[0].Draining as e:
        out.append(typed(e))
    out.append([f.result(timeout=10) for f in futs])
    srv.close()
    out.append([len(b) for b in gate.batches])
    out.append(pkg[1].counter_value("serve.shed", reason="draining",
                                    tenant="default"))
    return out


def test_drain_flushes_then_rejects_typed_like_jax():
    got = _drain(T)
    assert got == _drain(J)
    assert got[0] is True and got[2] == [0, 1, 2, 3, 4, 5]


def _close_without_drain(pkg):
    gate = Gate()
    srv = pkg[0].Server(_cfg(pkg, max_batch=1, flush_s=0.0))
    srv.register("stuck", gate)
    f1 = gate.hold(srv, "stuck", "inflight")
    f2 = srv.submit("stuck", "queued")
    srv.close(drain=True, timeout=0.2)
    out = []
    try:
        f2.result(timeout=10)
    except pkg[0].Draining as e:
        out.append(typed(e))
    gate.open()
    out.append(f1.result(timeout=10))
    return out


def test_close_fails_queued_typed_like_jax():
    got = _close_without_drain(T)
    assert got == _close_without_drain(J)
    assert got == [("Draining", "draining", None, "", None), "inflight"]


def test_close_with_closeall_releases_port_arrays():
    d = tdat.distribute(np.random.default_rng(1).standard_normal((8, 8)))
    srv = TSV.Server(_cfg(T))
    srv.register("echo", lambda xs: xs)
    assert srv.submit("echo", 5).result(timeout=10) == 5
    assert TM.live_bytes() == 256
    srv.close(closeall=True)
    assert tdat.live_ids() == [] and d._closed
    assert TM.live_bytes() == 0


def test_drain_wakes_sleeping_retry_backoff():
    def ep(xs):
        raise ValueError("always transient")

    srv = TSV.Server(_cfg(T, max_batch=1, flush_s=0.0),
                     policy=TR.RetryPolicy(base_delay=30.0, max_delay=30.0))
    srv.register("fail", ep)
    fut = srv.submit("fail", 1)
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline and not (
            TT.counter_value("recovery.attempts") >= 1
            and srv.stats()["inflight"] >= 1):
        time.sleep(0.005)
    t0 = time.monotonic()
    assert srv.drain(timeout=10)
    assert time.monotonic() - t0 < 10.0        # the backoff is 30 s
    with pytest.raises(TSV.RequestFailed) as ei:
        fut.result(timeout=10)
    assert isinstance(ei.value.__cause__, ValueError)
    srv.close()
    assert TT.counter_value("recovery.interrupted", verdict="transient") >= 1


def test_install_sigterm_drains_and_chains():
    chained = []
    srv = TSV.Server(_cfg(T))
    srv.register("echo", lambda xs: xs)
    assert srv.submit("echo", 1).result(timeout=10) == 1
    prev = signal.getsignal(signal.SIGTERM)
    try:
        signal.signal(signal.SIGTERM, lambda s, f: chained.append(s))
        assert TSV.install_sigterm(srv, closeall=False)
        signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
        assert srv.stats()["closed"] and chained == [signal.SIGTERM]
    finally:
        signal.signal(signal.SIGTERM, prev)
    with pytest.raises(TSV.Draining):
        srv.submit("echo", 2)


# ---------------------------------------------------------------------------
# recovery on an injected serve.dispatch fault
# ---------------------------------------------------------------------------


def _chaos(pkg):
    """A device loss mid-batch at ``serve.dispatch``: recovery shrinks the
    resident DArray off rank 3 and retries; every request resolves."""
    pkg[3].configure([{"site": "serve.dispatch", "action": "device_loss",
                       "at": 2, "count": 1, "device": 3,
                       "revive_after": 3}], seed=1234)
    base = np.arange(64, dtype=np.float32).reshape(8, 8) / 7
    d = pkg[6].distribute(base)
    retries0 = pkg[1].counter_value("recovery.retries",
                                    verdict="device_loss")

    def ep(xs):
        resident = np.asarray(pkg[6].gather(d))
        return [float(resident.sum() + np.sum(x)) for x in xs]
    gates = []
    srv = pkg[0].Server(_cfg(pkg, max_batch=4, flush_s=0.0),
                        policy=_policy(pkg))
    out = []
    try:
        srv.register("score", ep)
        for wave in range(2):
            gate = Gate(ep)
            gates.append(gate)
            srv.register("score", gate)
            futs = [gate.hold(srv, "score", np.full((2,), 0.0))]
            futs += [srv.submit("score", np.full((2,), float(i)))
                     for i in range(1, 4)]
            gate.open()
            out.append([round(f.result(timeout=30), 3) for f in futs])
        srv.set_quota("greedy", rate=1.0, burst=1.0)
        out.append(round(srv.submit("score", np.zeros(2),
                                    tenant="greedy").result(30), 3))
        try:
            srv.submit("score", np.zeros(2), tenant="greedy")
        except pkg[0].Overloaded as e:
            out.append(typed(e))
        out.append(srv.drain(timeout=10))
    finally:
        srv.close()
    out.append([h["action"] for h in pkg[3].history()])
    out.append(pkg[1].counter_value("recovery.retries",
                                    verdict="device_loss") > retries0)
    out.append(sorted({int(p) for p in d.pids.flat}))
    out.append(pkg[1].counter_value("serve.completed", endpoint="score"))
    d.close()
    return out


def test_dispatch_device_loss_recovers_like_jax():
    got = _chaos(T)
    assert got == _chaos(J)
    s = round(float((np.arange(64) / 7).astype(np.float32).sum()), 3)
    assert got[0][0] == pytest.approx(s, abs=1e-3)
    assert got[3] == ("QuotaExceeded", "quota", None, "greedy", True)
    assert got[4] is True
    assert got[5] == ["device_loss"] and got[6] is True
    assert 3 not in got[7] and got[8] == 9


def _unretryable(pkg):
    pkg[3].configure([{"site": "serve.dispatch", "action": "raise",
                       "at": 1, "count": -1}], seed=7)
    srv = pkg[0].Server(_cfg(pkg, max_batch=2, flush_s=0.0),
                        policy=_policy(pkg, max_retries=1))
    out = []
    try:
        srv.register("echo", lambda xs: xs)
        for f in [srv.submit("echo", i) for i in range(4)]:
            try:
                f.result(timeout=30)
            except pkg[0].RequestFailed as e:
                out.append((typed(e), type(e.__cause__).__name__))
    finally:
        srv.close()
    out.append(pkg[1].counter_value("serve.failed", endpoint="echo"))
    return out


def test_unretryable_dispatch_fault_fails_typed_like_jax():
    got = _unretryable(T)
    assert got == _unretryable(J)
    assert got[:4] == [(("RequestFailed", None, None, None, None),
                        "InjectedFault")] * 4 and got[4] == 4


def test_run_with_recovery_stop_event_pre_set():
    ev = threading.Event()
    ev.set()
    calls = []

    def fn():
        calls.append(1)
        raise ValueError("boom")
    with pytest.raises(ValueError):
        TR.run_with_recovery(fn, policy=_policy(T, max_retries=5),
                             stop_event=ev)
    assert calls == [1]


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------


def _metrics(pkg):
    with pkg[0].Server(_cfg(pkg, endpoint_latency_windows={"fast": 4})) \
            as srv:
        srv.register("echo", lambda xs: xs)
        srv.register("fast", lambda xs: xs)
        srv.register("slow", lambda xs: xs, latency_window=8)
        for i in range(6):
            for ep in ("echo", "fast", "slow"):
                assert srv.submit(ep, i).result(timeout=10) == i
        adm = srv._admission
        wins = [adm.endpoint_latency(e)._samples.maxlen
                for e in ("fast", "slow", "other")]
        count = adm.endpoint_latency("fast").count()
    tm = pkg[1]
    return [tm.counter_value("serve.admitted", tenant="default"),
            tm.counter_value("serve.submitted", tenant="default"),
            tm.counter_value("serve.completed", endpoint="fast"),
            tm.gauge_value("serve.queue_depth"), "serve.dispatch" in
            tm.span_stats(), "serve.submit" in tm.span_stats(),
            wins, count,
            tm.gauge_value("serve.request_p99_s", endpoint="fast") >= 0]


def test_metrics_and_spans_like_jax():
    got = _metrics(T)
    assert got == _metrics(J)
    assert got == [18, 18, 6, 0, True, True, [4, 8, 256], 4, True]
