"""The port's paged KV cache and decode engine (``serve/kvcache.py``,
``serve/decode.py``) against the JAX package's, on the cases of
``tests/test_decode.py``, 8 CPU ranks.

- ``TinyLM(seed=...)`` holds JAX's tables exactly, and its torch rows are
  the numpy rows bit for bit.
- The same prompts and ``DecodeConfig`` through both engines give equal
  token streams, on the dense prefill and on the ring (8 ranks); the
  prefill's attention output is within 1e-5 relative of JAX's, on
  ``reference_attention`` and on the ring over 4 ranks with a padded
  prompt (66 rows); so are the first-token logits, and their argmax is
  equal.  (JAX's decode attention computes in float64, since numpy
  promotes its float64 scale; the port's in float32.  On these prompts no
  near-tie flips a token.)
- The cache's allocation, LRU eviction, pinning, typed exhaustion,
  budget eviction and block reaping give JAX's outcomes and byte counts;
  the WFQ order is JAX's.
- Within the port: eviction and re-prefill give the unevicted run's
  streams; cancel frees the pages at once; ``serve.decode`` and
  ``serve.prefill`` device losses recover to the fault-free streams; a
  live cache shrinks from 4 ranks to 3 with its bytes moved rank by rank.
"""

import asyncio

import numpy as np
import pytest
import torch

import distributedarrays_tpu_torch as tdat
from distributedarrays_tpu import serve as JSV
from distributedarrays_tpu import telemetry as JT
from distributedarrays_tpu.models import ring_attention as JRA
from distributedarrays_tpu.resilience import domains as JD
from distributedarrays_tpu.resilience import elastic as JE
from distributedarrays_tpu.resilience import faults as JF
from distributedarrays_tpu.resilience import recovery as JR
from distributedarrays_tpu.telemetry import memory as JM
from distributedarrays_tpu_torch import serve as TSV
from distributedarrays_tpu_torch import telemetry as TT
from distributedarrays_tpu_torch.models import ring_attention as TRA
from distributedarrays_tpu_torch.resilience import domains as TD
from distributedarrays_tpu_torch.resilience import elastic as TE
from distributedarrays_tpu_torch.resilience import faults as TF
from distributedarrays_tpu_torch.resilience import recovery as TR
from distributedarrays_tpu_torch.serve import decode as TDEC
from distributedarrays_tpu_torch.telemetry import memory as TM

from _torch_port import (jax_plan_cache, jax_process_state,  # noqa: F401
                         port_ranks)

# (serve, telemetry, memory, faults, elastic, recovery, domains)
J = (JSV, JT, JM, JF, JE, JR, JD)
T = (TSV, TT, TM, TF, TE, TR, TD)
REL = 1e-5


@pytest.fixture(autouse=True)
def clean(port_ranks):
    for sv, tm, m, f, e, r, d in (J, T):
        f.clear()
        e.manager().reset()
        d.reset()
        tm.enable()
        tm.reset()
    yield
    for sv, tm, m, f, e, r, d in (J, T):
        f.clear()
        e.manager().reset()
        d.reset()
    tdat.d_closeall()
    TT.reset()


def _policy(pkg, **kw):
    kw.setdefault("base_delay", 0.005)
    kw.setdefault("max_delay", 0.02)
    return pkg[5].RetryPolicy(**kw)


def _model(pkg, **kw):
    kw.setdefault("vocab", 32)
    kw.setdefault("heads", 2)
    kw.setdefault("head_dim", 4)
    kw.setdefault("max_pos", 512)
    kw.setdefault("seed", 3)
    return pkg[0].TinyLM(**kw)


def _kv(pkg, **kw):
    kw.setdefault("page_tokens", 4)
    kw.setdefault("heads", 2)
    kw.setdefault("head_dim", 4)
    kw.setdefault("block_pages", 2)
    kw.setdefault("max_pages", 64)
    return pkg[0].PagedKVCache(pkg[0].KVCacheConfig(**kw))


def _engine(pkg, model=None, cache_kw=None, **kw):
    model = model or _model(pkg)
    ck = dict(cache_kw or {})
    ck.setdefault("heads", model.heads)
    ck.setdefault("head_dim", model.head_dim)
    kw.setdefault("poll_s", 0.002)
    kw.setdefault("use_ring_prefill", False)
    return pkg[0].DecodeEngine(model, _kv(pkg, **ck),
                               pkg[0].DecodeConfig(**kw),
                               policy=_policy(pkg))


def _run(pkg, prompts, *, model_kw=None, **kw):
    """The prompts' token streams through one engine of ``pkg``."""
    with _engine(pkg, _model(pkg, **(model_kw or {})), **kw) as eng:
        streams = [eng.submit(p) for p in prompts]
        out = [s.result(timeout=60) for s in streams]
    assert pkg[2].live_bytes() == 0
    return out


PROMPTS = [[5, 3, 7, 2, 9, 1, 4], [8, 8, 1], [30, 2, 17, 11]]


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, {"vocab": 64, "heads": 4, "head_dim": 8,
                                     "max_pos": 4096, "seed": 0}])
def test_tinylm_tables_and_rows_equal_jax(kw):
    jm, tm = _model(J, **kw), _model(T, **kw)
    for name in ("emb", "pos", "wq", "wk", "wv"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name))
    toks = [3, 1, 4, 1, 5, 9, 2, 6]
    for a, b, c in zip(jm.qkv(toks, 5), tm.qkv(toks, 5),
                       tm.qkv(toks, 5, torch.device("cpu"))):
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(c.numpy(), a)     # torch rows exact
    out = np.random.default_rng(0).standard_normal(
        (tm.heads, tm.head_dim)).astype(np.float32)
    np.testing.assert_allclose(tm.logits(torch.from_numpy(out)).numpy(),
                               jm.logits(out), rtol=REL, atol=1e-6)
    with pytest.raises(TSV.ServeError):
        tm.qkv([1] * 3, tm.max_pos - 1)


# ---------------------------------------------------------------------------
# the paged KV cache
# ---------------------------------------------------------------------------


def test_kvcache_write_read_roundtrip_equals_jax():
    rows = np.arange(10 * 2 * 4, dtype=np.float32).reshape(10, 2, 4)
    got = {}
    for pkg in (J, T):
        with _kv(pkg) as kv:
            kv.ensure(1, 10)
            kv.write(1, 0, rows[:6], rows[:6] * 2)      # page-straddling
            kv.write(1, 6, rows[6:], rows[6:] * 2)
            k, v = kv.read(1)
            got[pkg] = (np.asarray(k), np.asarray(v), kv.ntok(1),
                        kv.stats())
            kv.release(1)
            assert kv.stats()["pages_live"] == 0 and not kv.has(1)
        assert pkg[2].live_bytes() == 0
    np.testing.assert_array_equal(got[T][0], rows)
    np.testing.assert_array_equal(got[T][1], rows * 2)
    assert got[T][2:] == got[J][2:]


def test_kvcache_read_gathers_owner_rows_on_first_owner_device():
    """``read`` takes each page from its owner rank's tensor (a view when
    the page lies in one chunk) and concatenates on the first page's
    owner's device."""
    with _kv(T, block_pages=4) as kv:
        kv.ensure(7, 13)
        k = torch.arange(13 * 8, dtype=torch.float32).reshape(13, 2, 4)
        kv.write(7, 0, k, -k)
        blk = next(iter(kv._blocks.values())).d
        assert blk.grid == (4, 1, 1, 1, 1)           # a page a rank
        bid, slot = kv._seqs[7].pages[0]
        page = kv._page(kv._blocks[bid], slot)
        owner = blk.part(blk.locate(slot, 0, 0, 0, 0))
        assert page.data_ptr() == owner[0].data_ptr()   # a view, no copy
        kr, vr = kv.read(7)
        assert torch.equal(kr, k) and torch.equal(vr, -k)
        assert kr.device == tdat.device_of(int(blk.pids[
            blk.locate(slot, 0, 0, 0, 0)]))


def test_kvcache_ledger_attribution_and_block_reap():
    out = {}
    for pkg in (J, T):
        sv, tm, m = pkg[:3]
        kv = _kv(pkg, block_pages=2)
        kv.ensure(1, 8, tenant="t0")          # 2 pages -> 1 block
        sp = [s for s in tm.spans() if s["name"] == "serve.kv"]
        seq = [m.live_bytes(), m.tracked_count(), sp[0]["labels"]["op"],
               tm.counter_value("serve.kv.blocks_created")]
        kv.release(1)
        seq += [m.live_bytes(), tm.counter_value("serve.kv.blocks_reaped")]
        kv.close()
        out[pkg] = seq
    assert out[T] == out[J] == [512, 1, "alloc_block", 1, 0, 1]


def _cache_script(pkg):
    """Eviction order, pinning, typed exhaustion, oversized rejection and
    budget eviction: the outcomes in order."""
    sv, m = pkg[0], pkg[2]
    out = []
    with _kv(pkg, max_pages=4, block_pages=2) as kv:
        for sid in (1, 2, 3, 4):
            kv.ensure(sid, 1)
        kv.ensure(1, 1)
        out += [kv.ensure(5, 1), kv.has(1), kv.has(2),
                kv.stats()["evictions"]]
    with _kv(pkg, max_pages=2, block_pages=2) as kv:
        kv.ensure(1, 1)
        kv.ensure(2, 1)
        kv.pin(1)
        kv.pin(2)
        try:
            kv.ensure(3, 1, tenant="t")
        except sv.Overloaded as e:
            out += [type(e).__name__, e.reason, e.retry_after, e.tenant]
        kv.unpin(1)
        out += [kv.ensure(3, 1), kv.has(2)]
        try:
            kv.ensure(9, 1000)
        except sv.Rejected as e:
            out += [type(e).__name__, e.reason, kv.has(3)]
    kv = _kv(pkg, max_pages=16, block_pages=2, hbm_budget_bytes=2048,
             hbm_evict_fraction=0.5)
    kv.ensure(1, 8)
    kv.ensure(2, 8)
    out += [kv.page_nbytes, m.live_bytes(), kv.idle_evictable_bytes()]
    kv.pin(1)
    out += [kv.idle_evictable_bytes(), kv.maybe_evict(), m.live_bytes()]
    kv.unpin(1)
    kv.close()
    out.append(m.live_bytes())
    return out


def test_kvcache_policy_outcomes_equal_jax():
    assert _cache_script(T) == _cache_script(J) == [
        [2], True, False, 1, "Overloaded", "kv", 0.05, "t", [1], True,
        "Rejected", "kv", True, 256, 1024, 1024, 512, [2], 512, 0]


def test_kvcache_torch_dtype():
    with _kv(T, dtype=torch.bfloat16) as kv:
        assert kv.page_nbytes == 2 * 4 * 2 * 4 * 2
        kv.ensure(1, 3)
        kv.write(1, 0, np.ones((3, 2, 4), np.float32),
                 np.zeros((3, 2, 4), np.float32))
        k, v = kv.read(1)
        assert k.dtype == torch.bfloat16 and torch.all(k == 1)
        assert TM.live_bytes() == 2 * kv.page_nbytes


# ---------------------------------------------------------------------------
# weighted-fair queuing
# ---------------------------------------------------------------------------


def _wfq(pkg):
    q = pkg[0].WeightedFairQueue()
    for i in range(3):
        q.push(("a", i), tenant="a", cost=1.0, weight=1.0)
        q.push(("b", i), tenant="b", cost=1.0, weight=3.0)
    order = [q.pop() for _ in range(6)]
    q.push(("late", 0), tenant="a", cost=1.0, weight=0.001, priority=-1)
    q.push(("bulk", 0), tenant="b", cost=1.0, weight=100.0)
    return order + [q.pop(), len(q)]


def test_wfq_order_equals_jax():
    got = _wfq(T)
    assert got == _wfq(J)
    assert [t for t, _ in got[:4]].count("b") == 3
    assert got[6] == ("late", 0)


def _engine_wfq(pkg):
    eng = _engine(pkg, max_new_tokens=1, max_prefill_seqs=1)
    eng._stop.set()                   # manual rounds
    order: list[str] = []
    try:
        eng.set_weight("b", 3.0)
        streams = []
        for i in range(3):
            for t in ("a", "b"):
                s = eng.submit([3 + i, 7, 2, 9, 1, 4, 8, 5], tenant=t)
                s.add_listener(lambda kind, _v, t=t: order.append(t)
                               if kind == "done" else None)
                streams.append(s)
        urgent = eng.submit([9] * 8, tenant="a", priority=-1)
        urgent.add_listener(lambda kind, _v: order.append("urgent")
                            if kind == "done" else None)
        for _ in range(40):
            if all(s.done() for s in streams) and urgent.done():
                break
            eng._round()
        assert urgent.done() and all(s.done() for s in streams)
        toks = [s.tokens for s in streams] + [urgent.tokens]
    finally:
        eng.close(drain=False)
    assert pkg[2].live_bytes() == 0
    return order, toks


def test_engine_wfq_and_priority_equal_jax():
    got = _engine_wfq(T)
    assert got == _engine_wfq(J)
    assert got[0][0] == "urgent" and got[0][1:5].count("b") == 3


# ---------------------------------------------------------------------------
# decode parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ring", [False, True])
def test_token_streams_equal_jax(ring):
    rng = np.random.default_rng(7)
    prompts = PROMPTS + [rng.integers(0, 32, size=n).tolist()
                         for n in (20, 37)]
    kw = dict(max_new_tokens=6, use_ring_prefill=ring)
    got = _run(T, prompts, **kw)
    assert got == _run(J, prompts, **kw)
    assert all(len(g) == 6 for g in got)
    assert len({t for g in got for t in g}) > 3     # the streams wander


def test_stream_iterates_and_listener_replays():
    with _engine(T, max_new_tokens=4) as eng:
        s = eng.submit([5, 3, 7, 2])
        want = s.result(timeout=30)
        assert list(s) == want and s.tokens == want and s.error() is None
        got = []
        s.add_listener(lambda kind, v: got.append((kind, v)))
        assert got == [("token", t) for t in want] + [("done", None)]
        st = eng.stats()
        assert st["sequences"] == 0 and st["cache"]["pages_live"] == 0
    assert TT.counter_value("serve.decode.completed", tenant="default") == 1
    assert TT.counter_value("serve.decode.tokens", tenant="default") == 4


@pytest.mark.parametrize("ntok", [66, 64])
def test_prefill_and_first_logits_equal_jax(ntok):
    """The prefill's attention output and the first token's logits against
    JAX's, on the dense oracle and on the ring over 4 ranks (66 rows pad
    to 68)."""
    jm, tm = _model(J, max_pos=1024), _model(T, max_pos=1024)
    prompt = np.random.default_rng(ntok).integers(0, 32, ntok).tolist()
    q, k, v = jm.qkv(prompt, 0)
    procs = [0, 1, 2, 3]
    jref = JRA.reference_attention(q, k, v, True)
    jring = JRA.ring_attention_prefill(q, k, v, causal=True, procs=procs,
                                       min_ring_tokens=64)
    tref = TRA.reference_attention(q, k, v, True)
    np.testing.assert_array_equal(tref, jref)        # the same numpy code
    qt, kt, vt = tm.qkv(prompt, 0, torch.device("cpu"))
    outs = {"ring numpy": TRA.ring_attention_prefill(
                q, k, v, causal=True, procs=procs, min_ring_tokens=64),
            "ring torch": TRA.ring_attention_prefill(
                qt, kt, vt, causal=True, procs=procs,
                min_ring_tokens=64).numpy(),
            "dense torch": TRA.reference_attention(qt, kt, vt,
                                                   True).numpy()}
    for what, o in outs.items():
        assert o.shape == (ntok, 2, 4), what
        for ref in (jref, jring):
            rel = np.linalg.norm(o - ref) / np.linalg.norm(ref)
            assert rel <= REL, (what, rel)
        jl = jm.logits(jring[-1])
        tl = tm.logits(torch.from_numpy(o[-1])).numpy()
        np.testing.assert_allclose(tl, jl, rtol=REL, atol=1e-5)
        assert int(np.argmax(tl)) == int(np.argmax(jl)), what


def test_ring_engine_launches_the_ring_on_long_prompts(monkeypatch):
    """The engine's prefill goes through ``ring_attention_prefill`` with the
    live ranks, and through the ring for a prompt at or above
    ``min_ring_tokens``."""
    calls = []
    real = TRA.ring_attention

    def spy(*a, **kw):
        calls.append(a[0].pids.size)
        return real(*a, **kw)
    monkeypatch.setattr(TRA, "ring_attention", spy)
    prompt = np.random.default_rng(3).integers(0, 32, 67).tolist()
    short = [1, 2, 3]
    got = _run(T, [prompt, short], max_new_tokens=3, use_ring_prefill=True,
               min_ring_tokens=64)
    assert calls == [8]                  # the long prompt only, 8 ranks
    assert got == _run(J, [prompt, short], max_new_tokens=3,
                       use_ring_prefill=True, min_ring_tokens=64)


def test_eviction_reprefill_bit_identical_to_unevicted_run():
    prompts = [[5, 3, 7, 2, 9, 1], [8, 8, 1, 30, 2, 17]]
    results, evictions, steps = {}, {}, {}
    real = TDEC._decode_attention
    for label, pages in (("tight", 4), ("roomy", 64)):
        seen = {}

        def rec(q, K, V, seen=seen):
            o = real(q, K, V)
            seen[(int(K.shape[0]), float(K[0, 0, 0]))] = o.clone()
            return o
        TDEC._decode_attention = rec
        try:
            with _engine(T, cache_kw={"max_pages": pages},
                         max_new_tokens=8) as eng:
                streams = [eng.submit(p) for p in prompts]
                results[label] = [s.result(timeout=60) for s in streams]
                evictions[label] = eng.cache.stats()["evictions"]
        finally:
            TDEC._decode_attention = real
        steps[label] = seen
    assert evictions["tight"] > 0 and evictions["roomy"] == 0
    assert results["tight"] == results["roomy"]
    assert set(steps["tight"]) == set(steps["roomy"])
    for key, o in steps["roomy"].items():    # the rebuilt cache, bit for bit
        assert torch.equal(steps["tight"][key], o)
    assert results["roomy"] == _run(J, prompts, max_new_tokens=8)
    assert TT.counter_value("serve.decode.evicted", tenant="default") > 0
    assert TM.live_bytes() == 0


# ---------------------------------------------------------------------------
# cancellation, deadlines, admission bounds, drain
# ---------------------------------------------------------------------------


def test_cancel_mid_flight_frees_pages_at_once():
    # 240 new tokens (61 of the 64 pages): far more than the two read
    with _engine(T, max_new_tokens=240, poll_s=0.001) as eng:
        s = eng.submit([5, 3, 7, 2])
        it = iter(s)
        next(it)
        next(it)
        assert eng.cache.stats()["pages_live"] > 0 and TM.live_bytes() > 0
        assert s.cancel() is True
        assert eng.cache.stats()["pages_live"] == 0
        assert TM.live_bytes() == 0
        assert isinstance(s.error(), TSV.Cancelled)
        with pytest.raises(TSV.Cancelled):
            s.result(timeout=5)
        with pytest.raises(TSV.Cancelled):
            list(it)
        assert s.cancel() is False
    assert TT.counter_value("serve.decode.cancelled", tenant="default") == 1


def _typed_script(pkg):
    sv = pkg[0]
    out = []
    with _engine(pkg) as eng:
        s = eng.submit([1, 2, 3], deadline_s=0.0)
        try:
            s.result(timeout=10)
        except sv.DeadlineExceeded as e:
            out += [type(e).__name__, e.stage]
    with _engine(pkg, max_sequences=2, max_new_tokens=240,
                 poll_s=0.001) as eng:
        a = eng.submit([1, 2, 3])
        b = eng.submit([4, 5, 6])
        for p in ([7, 8, 9], list(range(10_000)), []):
            try:
                eng.submit(p)
            except sv.ServeError as e:
                out += [type(e).__name__, getattr(e, "reason", None),
                        getattr(e, "retry_after", None)]
        a.cancel()
        b.cancel()
    eng = _engine(pkg, max_new_tokens=2)
    s = eng.submit([5, 3, 7])
    out.append(eng.drain(timeout=30))
    out += [s.done(), s.error()]
    try:
        eng.submit([1, 2])
    except sv.Draining as e:
        out += [type(e).__name__, e.reason]
    eng.close()
    eng.close()
    out.append(pkg[2].live_bytes())
    return out


def test_typed_outcomes_equal_jax():
    assert _typed_script(T) == _typed_script(J) == [
        "DeadlineExceeded", "prefill", "Overloaded", "queue", 0.05,
        "Rejected", "kv", None, "ServeError", None, None, True, True, None,
        "Draining", "draining", 0]


# ---------------------------------------------------------------------------
# server integration and the asyncio bridge
# ---------------------------------------------------------------------------


def _srv_cfg(pkg, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("flush_s", 0.005)
    kw.setdefault("max_queue", 32)
    kw.setdefault("tenant_rate", 10_000.0)
    kw.setdefault("tenant_burst", 10_000.0)
    return pkg[0].ServeConfig(**kw)


def _attached(pkg):
    eng = _engine(pkg, _model(pkg), max_new_tokens=5)
    srv = pkg[0].Server(_srv_cfg(pkg))
    try:
        eng.attach(srv, "decode")
        assert srv._admission.reclaimable_fn == \
            eng.cache.idle_evictable_bytes
        st = srv.submit("decode", [5, 3, 7, 2]).result(timeout=30)
        assert isinstance(st, pkg[0].TokenStream)
        s2 = srv.submit("decode", {"prompt": [8, 8, 1], "tenant": "t2",
                                   "max_new_tokens": 2}).result(timeout=30)
        out = [st.result(timeout=30), s2.result(timeout=30), s2.tenant]
    finally:
        srv.close()
        eng.close()
    assert pkg[2].live_bytes() == 0
    return out


def test_attach_server_roundtrip_equals_jax():
    assert _attached(T) == _attached(J)


def test_aio_generate_streams_and_cancels_on_exit():
    eng = _engine(T, _model(T), max_new_tokens=6, poll_s=0.001)
    srv = TSV.Server(_srv_cfg(T))
    try:
        eng.attach(srv, "decode")

        async def full():
            return [t async for t in TSV.aio.generate(
                srv, [5, 3, 7, 2], tenant="aio")]
        assert asyncio.run(full()) == _run(J, [[5, 3, 7, 2]],
                                           max_new_tokens=6)[0]

        async def partial():
            # 240 new tokens (61 of the pool's 64 pages): the stream cannot
            # finish before the client walks away after two
            handle = await TSV.aio.submit(
                srv, "decode", {"prompt": [9, 1, 4], "max_new_tokens": 240})
            got = []
            async for t in TSV.aio.stream_tokens(handle):
                got.append(t)
                if len(got) == 2:
                    break
            return handle, got
        handle, got = asyncio.run(partial())
        assert len(got) == 2
        assert handle.done() and isinstance(handle.error(), TSV.Cancelled)
        assert eng.cache.stats()["pages_live"] == 0

        async def not_a_stream():
            async for _ in TSV.aio.generate(srv, 1, endpoint="echo"):
                pass
        srv.register("echo", lambda xs: xs)
        with pytest.raises(TypeError):
            asyncio.run(not_a_stream())
    finally:
        srv.close()
        eng.close()
    assert TM.live_bytes() == 0


# ---------------------------------------------------------------------------
# faults and recovery; a shrink of a live cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("site,device", [("serve.decode", 3),
                                         ("serve.prefill", 2)])
def test_device_loss_recovers_to_the_fault_free_stream(site, device):
    prompt = [5, 3, 7, 2, 9, 1]
    free = _run(J, [prompt], max_new_tokens=8)
    TF.configure([{"site": site, "action": "device_loss", "at": 2,
                   "count": 1, "device": device}], seed=1234)
    retries0 = TT.counter_value("recovery.retries", verdict="device_loss")
    with _engine(T, max_new_tokens=8, poll_s=0.001) as eng:
        s = eng.submit(prompt)
        s2 = eng.submit([8, 8, 1], max_new_tokens=2)
        assert s.result(timeout=60) == free[0]
        s2.result(timeout=60)
        pids = {int(p) for b in eng.cache._blocks.values()
                for p in b.d.pids.flat}
        assert device not in pids
    assert [h["action"] for h in TF.history()] == ["device_loss"]
    assert TT.counter_value("recovery.retries",
                            verdict="device_loss") > retries0
    assert device not in TE.manager().live_ranks()
    assert TM.live_bytes() == 0


def test_unretryable_fault_fails_the_stream_typed():
    TF.configure([{"site": "serve.prefill", "action": "raise", "at": 1,
                   "count": -1}], seed=7)
    eng = TSV.DecodeEngine(_model(T), _kv(T), TSV.DecodeConfig(
        max_new_tokens=3, poll_s=0.002, use_ring_prefill=False),
        policy=_policy(T, max_retries=1))
    try:
        s = eng.submit([1, 2, 3])
        with pytest.raises(TSV.RequestFailed) as ei:
            s.result(timeout=30)
        assert isinstance(ei.value.__cause__, TF.InjectedFault)
    finally:
        eng.close(drain=False)
    assert TM.live_bytes() == 0


def test_minority_partition_drains_typed():
    split = [[0, 1, 2, 3, 4], [5, 6, 7]]
    TD.configure(split)
    TF.configure([{"site": "serve.decode", "action": "partition", "at": 1,
                   "groups": split, "observer": 6}], seed=1234)
    eng = _engine(T, max_new_tokens=10, poll_s=0.001)
    try:
        streams = [eng.submit([5, 3, 7, 2]), eng.submit([8, 8, 1])]
        for s in streams:
            with pytest.raises(TSV.Draining) as ei:
                s.result(timeout=60)
            assert isinstance(ei.value.__cause__, TR.MinorityPartitionExit)
        assert eng.stats()["draining"] is True
        with pytest.raises(TSV.Draining):
            eng.submit([1, 2])
    finally:
        eng.close(drain=False)
    assert TM.live_bytes() == 0


def test_shrink_live_cache_from_four_ranks_to_three():
    """A live cache on ranks 0-3 re-laid onto 0-2 by the elastic shrink:
    every block keeps its owner and its bytes, now on ranks 0-2 only (the
    ``elastic`` site), the device total unchanged; the rows read back."""
    mgr = TE.manager()
    for r in (4, 5, 6, 7):
        mgr.mark_down(r)
    kv = _kv(T, block_pages=8, max_pages=64)
    try:
        rows = torch.arange(40 * 8, dtype=torch.float32).reshape(40, 2, 4)
        kv.ensure(1, 40)
        kv.write(1, 0, rows, rows + 0.5)
        blocks = [b.d for b in kv._blocks.values()]
        assert {int(p) for d in blocks for p in d.pids.flat} == {0, 1, 2, 3}
        before = TM.live_bytes()
        dev = TM.live_bytes_by_device()
        assert TM.live_bytes_by_rank() == {r: before // 4 for r in range(4)}
        mgr.mark_down(3)
        moved = mgr.shrink()
        assert moved["moved"] == len(blocks) and not moved["failed"]
        assert {int(p) for d in blocks for p in d.pids.flat} == {0, 1, 2}
        assert TM.live_bytes() == before
        assert TM.live_bytes_by_device() == dev
        by_rank = TM.live_bytes_by_rank()
        assert set(by_rank) == {0, 1, 2} and 3 not in by_rank
        assert by_rank == {r: sum(t.nbytes for d in blocks
                                  for ci, t in np.ndenumerate(d._parts)
                                  if int(d.pids[ci]) == r)
                           for r in (0, 1, 2)}
        assert {e["site"] for e in TM.entries()} == {"elastic"}
        assert sorted(tuple(e["owners"][0]) for e in TM.entries()) == \
            sorted(d.id for d in blocks)
        k, v = kv.read(1)
        assert torch.equal(k, rows) and torch.equal(v, rows + 0.5)
    finally:
        kv.close()
        mgr.reset()
    assert TM.live_bytes() == 0
