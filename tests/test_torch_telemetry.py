"""The port's telemetry core (``telemetry/core.py``, ``tracing.py``,
``flight.py``, the cost stamps of ``perf.py``) against the JAX package's:
one sequence of calls into both gives equal ``report()`` counters, gauges,
histograms and comm totals, equal journal events with the timestamps and
ids masked, and equal span names, labels and nesting; the cost stamps are
equal dicts over a grid of shapes.  The port alone: ``DA_TPU_TELEMETRY=0``,
the journal's round trip and size cap, ``nbytes_of`` on tensors and
DArrays, and the flight recorder's bundle with its memory census."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import distributedarrays_tpu as dat
import distributedarrays_tpu_torch as tdat
from distributedarrays_tpu import telemetry as JT
from distributedarrays_tpu.telemetry import perf as JP
from distributedarrays_tpu_torch import telemetry as TT
from distributedarrays_tpu_torch.telemetry import perf as TP

from _torch_port import (jax_plan_cache, jax_process_state,  # noqa: F401
                         port_ranks)

# per-process fields of an event or span that differ between the packages
MASKED = ("t", "wall", "tid", "pid", "span_id", "parent_id", "start", "dur",
          "incident", "tname")


@pytest.fixture(autouse=True)
def fresh_telemetry():
    for tm in (JT, TT):
        tm.enable()
        tm.configure(None)
        tm.reset()
    yield
    TT.enable()
    TT.configure(None)
    TT.reset()


def workload(tm):
    """One sequence of calls, made the same way into either package."""
    tm.count("ops")
    tm.count("ops", 2)
    tm.count("hits", site="a", kind=3)
    tm.set_gauge("depth", 4)
    tm.set_gauge("live", 7, journal=True, pool="x")
    for v in (0.5, 2.0, 9.0, 40.0):
        tm.observe("lat", v, buckets=(1.0, 10.0))
    tm.observe("plain", 3.0)
    tm.event("phase", "start", step=1, tags=["a", "b"], cfg={"k": 2})
    tm.event("phase", "dedup", once_key="k1")
    tm.event("phase", "dedup", once_key="k1")
    inc = tm.begin_incident("device_loss")
    assert inc is not None and tm.current_incident() == inc
    tm.event("recovery", "retry", attempt=1)
    tm.end_incident("recovered")
    with tm.trace_ctx("req-1", "req-2"):
        with tm.span("outer", grid="2x2") as sp:
            assert sp is not None
            tm.record_comm("reshard", 1024, op="move", axis="x")
            with tm.span("inner", k=1):
                tm.record_comm("spmd_send", 64, op="sendto",
                               once_key="s:0->1", src=0, dst=1)
                tm.record_comm("spmd_send", 64, op="sendto",
                               once_key="s:0->1", src=0, dst=1)
                tm.annotate(flops=10, extra="y")
            with tm.span("quiet", _journal=False):
                tm.record_comm("h2d", 8, journal=False)
        try:
            with tm.span("failing"):
                raise ValueError("boom")
        except ValueError:
            pass

    @tm.traced(name="deco", mode="t")
    def f(x):
        return x + 1

    assert f(1) == 2
    tm.tracing.record_external_span("spmd.step", 0.5, 0.25,
                                    labels={"rank": 3, "backend": "process"})


def masked_events(tm):
    return [{k: v for k, v in e.items() if k not in MASKED}
            for e in tm.events()]


def span_tree(tm):
    """Each finished span as (name, labels, parent's name), in order."""
    sps = tm.spans()
    name_of = {s["span_id"]: s["name"] for s in sps}
    return [(s["name"], s.get("labels"), name_of.get(s["parent_id"]),
             s["bytes"], s["child_bytes"], s.get("trace_id")) for s in sps]


def test_report_counters_gauges_and_comm_equal_jax():
    workload(JT)
    workload(TT)
    jr, tr = JT.report(), TT.report()
    for key in ("enabled", "counters", "gauges", "comm", "incident"):
        assert tr[key] == jr[key], key
    assert tr["histograms"] == jr["histograms"]
    for key in ("recorded", "buffered", "by_category", "journal_path",
                "journal_capped", "journal_rotations"):
        assert tr["events"][key] == jr["events"][key], key
    jsp, tsp = jr["spans"], tr["spans"]
    assert tsp["finished"] == jsp["finished"]
    strip = ("total_s", "self_s")
    assert {k: {f: v for f, v in d.items() if f not in strip}
            for k, d in tsp["by_name"].items()} == \
        {k: {f: v for f, v in d.items() if f not in strip}
         for k, d in jsp["by_name"].items()}
    assert TT.comm_bytes() == JT.comm_bytes() == 1024 + 128 + 8
    assert TT.comm_bytes("spmd_send") == JT.comm_bytes("spmd_send")
    assert TT.counter_value("hits", site="a", kind=3) == 1
    assert TT.gauge_value("live", pool="x") == JT.gauge_value(
        "live", pool="x") == 7


def test_events_equal_jax_with_times_and_ids_masked():
    workload(JT)
    workload(TT)
    assert masked_events(TT) == masked_events(JT)
    # the masked ids still link the same way: events inside a span carry
    # the id of the nearest journaled span
    t_spans = {s["span_id"]: s["name"] for s in TT.spans()}
    stamped = [(e["name"], t_spans.get(e["span_id"])) for e in TT.events()
               if e["cat"] == "comm" and "span_id" in e]
    j_spans = {s["span_id"]: s["name"] for s in JT.spans()}
    assert stamped == [(e["name"], j_spans.get(e["span_id"]))
                       for e in JT.events()
                       if e["cat"] == "comm" and "span_id" in e]
    incs = [e for e in TT.events() if e["cat"] in ("incident", "recovery")]
    assert len({e["incident"] for e in incs}) == 1


def test_span_names_labels_and_nesting_equal_jax():
    workload(JT)
    workload(TT)
    tree = span_tree(TT)
    assert tree == span_tree(JT)
    names = [t[0] for t in tree]
    assert names == ["inner", "outer", "failing", "deco", "spmd.step"]
    assert tree[0][2] == "outer"                 # inner nests in outer
    assert tree[0][1] == {"k": 1, "flops": 10, "extra": "y"}
    assert TT.span_stats()["quiet"]["count"] == 1   # aggregate-only
    assert TT.span_stats()["quiet"]["bytes"] == 8
    assert [s["name"] for s in TT.spans()].count("quiet") == 0
    err = [e for e in TT.events() if e.get("name") == "failing"]
    assert err and err[0]["error"] is True
    assert TT.open_spans() == [] and TT.current_span() is None
    with TT.span("open") as sp:
        assert [s["name"] for s in TT.open_spans()] == ["open"]
        assert TT.current_span_id() == sp.span_id
        assert TT.current_trace_ids() == ()


def test_disabled_switch_turns_everything_off(tmp_path):
    journal = tmp_path / "j.jsonl"
    code = (
        "import distributedarrays_tpu_torch.telemetry as t, sys\n"
        "t.count('a'); t.set_gauge('g', 1); t.observe('h', 1.0)\n"
        "t.event('c', 'n'); t.record_comm('k', 10)\n"
        "with t.span('s') as sp: assert sp is None\n"
        "assert t.begin_incident() is None\n"
        "r = t.report()\n"
        "assert not r['enabled'] and not r['counters'] and not r['gauges']\n"
        "assert not r['histograms'] and r['events']['recorded'] == 0\n"
        "assert r['comm']['total_ops'] == 0 and t.spans() == []\n"
        "assert t.flight.postmortem('x') is None\n"
        "print('off')\n")
    env = dict(os.environ, DA_TPU_TELEMETRY="0",
               DA_TPU_TELEMETRY_JOURNAL=str(journal))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "off"
    assert not journal.exists()                  # never touched the disk


def test_disable_at_run_time_keeps_what_was_recorded():
    TT.count("x")
    TT.disable()
    assert not TT.enabled()
    TT.count("x")
    with TT.span("s") as sp:
        assert sp is None
    assert TT.counter_value("x") == 1
    TT.enable()
    TT.count("x")
    assert TT.counter_value("x") == 2


def test_journal_round_trips(tmp_path):
    path = tmp_path / "sub" / "run.jsonl"
    TT.configure(str(path))
    workload(TT)
    TT.configure(None)                           # closes the file
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert lines == TT.events()
    assert TT.report()["events"]["journal_path"] is None
    # appends on reopen, never truncates
    TT.configure(str(path))
    TT.event("more", "x")
    TT.configure(None)
    assert len(path.read_text().splitlines()) == len(lines) + 1


def test_journal_cap_rotates_and_holds(tmp_path, monkeypatch):
    monkeypatch.setenv("DA_TPU_TELEMETRY_JOURNAL_MAX_MB", "0.002")
    cap = int(0.002 * 1024 * 1024)
    path = tmp_path / "run.jsonl"
    TT.configure(str(path))
    for i in range(200):
        TT.event("soak", "tick", i=i, pad="x" * 40)
    rot = TT.report()["events"]["journal_rotations"]
    TT.configure(None)
    assert rot >= 3
    line = max(len(x) + 1 for x in path.read_text().splitlines())
    for p in (path, tmp_path / "run.jsonl.1"):
        assert p.stat().st_size < cap + line     # each file within the cap
    first = json.loads(path.read_text().splitlines()[0])
    assert (first["cat"], first["name"]) == ("journal", "rotated")
    assert first["rotation"] == rot
    # the last event is the last line of the live file
    last = json.loads(path.read_text().splitlines()[-1])
    assert last["i"] == 199


def test_incident_joins_and_closes():
    a = TT.begin_incident("x")
    assert TT.begin_incident("y") == a           # re-entrant: one episode
    TT.end_incident("gave_up")
    assert TT.current_incident() is None
    b = TT.begin_incident("z")
    assert b != a
    TT.end_incident()
    evs = [(e["name"], e.get("kind"), e.get("resolution"))
           for e in TT.events("incident")]
    assert evs == [("begin", "x", None), ("end", None, "gave_up"),
                   ("begin", "z", None), ("end", None, "resolved")]


def test_nbytes_of_tensors_arrays_darrays_and_containers():
    t = torch.zeros((3, 5), dtype=torch.bfloat16)
    a = np.zeros((4, 2), dtype=np.float64)
    d = tdat.dzeros((10, 6), dtype=torch.int32, procs=[0, 1], dist=[2, 1])
    assert TT.nbytes_of(t) == 30 == JT.nbytes_of(np.zeros((3, 5), np.int16))
    assert TT.nbytes_of(a) == 64 == JT.nbytes_of(a)
    assert TT.nbytes_of(d) == 240
    jd = dat.dzeros((10, 6), dtype=np.int32, procs=[0, 1], dist=[2, 1])
    assert TT.nbytes_of(d) == JT.nbytes_of(jd)
    jd.close()
    assert TT.nbytes_of([t, (a, {"k": d})]) == 30 + 64 + 240
    assert TT.nbytes_of(b"abc") == JT.nbytes_of(b"abc") == 3
    assert TT.nbytes_of(object()) == JT.nbytes_of(object()) == 0
    assert TT.nbytes_of(3.5) == 0


SHAPES = [(1, 1, 1), (7, 3, 5), (128, 64, 32), (4096, 4096, 4096),
          (1000, 1, 999)]


@pytest.mark.parametrize("m,n,k", SHAPES)
@pytest.mark.parametrize("itemsize", [1, 2, 4, 8])
def test_cost_stamps_equal_jax(m, n, k, itemsize):
    assert TP.gemm_cost(m, n, k, itemsize) == JP.gemm_cost(m, n, k, itemsize)
    assert TP.gemm_cost(m, n, k, itemsize, out_itemsize=4, bytes_ici=m) == \
        JP.gemm_cost(m, n, k, itemsize, out_itemsize=4, bytes_ici=m)
    assert TP.reshard_cost(m * n * itemsize, k) == \
        JP.reshard_cost(m * n * itemsize, k)
    assert TP.transfer_cost(m * k) == JP.transfer_cost(m * k)
    for p in (1, 4):
        for causal in (False, True):
            assert TP.attention_cost(m, n, k, itemsize, p=p,
                                     causal=causal) == \
                JP.attention_cost(m, n, k, itemsize, p=p, causal=causal)
    for idx in (0, 4, 8):
        assert TP.spmv_cost(m * 5, n, itemsize, index_itemsize=idx,
                            bytes_ici=k) == \
            JP.spmv_cost(m * 5, n, itemsize, index_itemsize=idx,
                         bytes_ici=k)


def test_flight_bundle_without_memory_census(tmp_path, monkeypatch):
    """A crash bundle: written once, deduped, with the open spans and the
    registry census.  The ``memory_census`` placeholder that said the port
    had no ledger is gone: the bundle carries the ledger, its entries and
    the leak census instead."""
    monkeypatch.setenv("DA_TPU_FLIGHT_DIR", str(tmp_path))
    d = tdat.dzeros((4, 4))
    with TT.span("in-progress"):
        err = RuntimeError("rank died")
        n0 = TT.flight.crash_bundle_count()
        path = TT.record_crash(err, where="test")
        assert TT.record_crash(err, where="test") is None   # deduped
    assert TT.flight.crash_bundle_count() == n0 + 1
    bundle = json.loads(open(path).read())
    assert bundle == json.loads(json.dumps(TT.flight.last_bundle()))
    assert bundle["kind"] == "da_tpu_postmortem"
    assert bundle["exception"]["type"] == "RuntimeError"
    assert bundle["classification"] == "transient"   # recovery's classifier
    assert [s["name"] for s in bundle["open_spans"]] == ["in-progress"]
    assert bundle["registry_census"]["live"] == 1
    assert bundle["registry_census"]["arrays"][0]["dims"] == [4, 4]
    # the bundle carries the memory ledger as JAX's does
    assert bundle["ledger"]["live_bytes"] == 4 * 4 * 4
    assert [e["site"] for e in bundle["ledger_entries"]] == ["ctor"]
    assert bundle["leak_census"]["deleted_but_registered"]["count"] == 0
    assert "memory_census" not in bundle
    assert bundle["stream"] == {"armed": False}
    assert [e["name"] for e in TT.events("flight")] == ["postmortem"]
    d.close()


def test_flight_bundle_census_matches_the_ledger():
    """After a few constructors and closes, a bundle's ledger section and
    leak census agree with the ledger: every live DArray's rank tensors
    tracked, none stale."""
    a = tdat.drand((37, 11))
    b = tdat.dzeros((50, 8), dist=(4, 2))
    c = tdat.dones((16,), dtype=torch.int32)
    b.close()
    e = tdat.distribute(np.arange(12.0).reshape(3, 4))
    c.close()
    bundle = TT.flight.snapshot_bundle("census")
    want = sum(t.nbytes for d in (a, e) for t in d._parts.flat)
    assert TT.memory.live_bytes() == want
    assert bundle["ledger"] == TT.memory.snapshot()
    assert bundle["ledger"]["live_bytes"] == want
    assert bundle["ledger"]["tracked_arrays"] == 2
    assert sorted(x["nbytes"] for x in bundle["ledger_entries"]) == \
        sorted(sum(t.nbytes for t in d._parts.flat) for d in (a, e))
    census = bundle["leak_census"]
    assert census["ledger_tracked"] == {
        "bytes": want, "count": a._parts.size + e._parts.size}
    assert census["deleted_but_registered"] == {"bytes": 0, "count": 0}
    assert census["jax_live_arrays"] >= census["ledger_tracked"]["count"]
    a.close()
    e.close()
    assert TT.flight.snapshot_bundle("after")["ledger"]["live_bytes"] == 0


def test_dump_writes_the_report(tmp_path):
    workload(TT)
    path = TT.dump(str(tmp_path / "out" / "report.json"))
    assert json.loads(open(path).read()) == json.loads(json.dumps(
        TT.report(), sort_keys=True))
    assert not (tmp_path / "out" / "report.json.tmp").exists()


def test_sigusr1_dumps_a_bundle(tmp_path):
    code = (
        "import os, signal\n"
        "import distributedarrays_tpu_torch.telemetry as t\n"
        "t.count('before')\n"
        "os.kill(os.getpid(), signal.SIGUSR1)\n"
        "print(t.flight.last_bundle()['reason'])\n")
    env = dict(os.environ, DA_TPU_FLIGHT_DIR=str(tmp_path))
    env.pop("DA_TPU_TELEMETRY", None)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "sigusr1"
    bundles = list(tmp_path.glob("postmortem-*.json"))
    assert len(bundles) == 1
    assert json.loads(bundles[0].read_text())["reason"] == "sigusr1"
