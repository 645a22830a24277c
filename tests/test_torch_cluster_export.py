"""The port's offline telemetry readers (``telemetry/summarize.py``,
``export.py``, ``cluster.py``) against the JAX package's.

The same event lists go through both packages' functions and must give
equal outputs: hand-built journals with skewed clocks and
``multihost/clock`` events (the cases of ``tests/test_cluster.py`` that
need none of the modules still queued), a two-host partition story, flight
bundles on disk, journals recorded by the port's telemetry, and registry
reports of both packages.  ``format_summary`` differs in one line only:
the port names its incident reconstruction where JAX names its command
line.
"""

import importlib
import io
import json

import pytest

from distributedarrays_tpu import telemetry as JT
from distributedarrays_tpu.telemetry import cluster as JCL
from distributedarrays_tpu.telemetry import export as JEX
from distributedarrays_tpu.telemetry import flight as JFL

from distributedarrays_tpu_torch import telemetry as TT
from distributedarrays_tpu_torch.telemetry import cluster as TCL
from distributedarrays_tpu_torch.telemetry import export as TEX
from distributedarrays_tpu_torch.telemetry import flight as TFL

from _torch_port import (jax_plan_cache, jax_process_state,  # noqa: F401
                         port_ranks)

# the packages re-export the function ``summarize`` over the module's name
JSM = importlib.import_module("distributedarrays_tpu.telemetry.summarize")
TSM = importlib.import_module(
    "distributedarrays_tpu_torch.telemetry.summarize")


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


def _ev(host, pid, seq, t, cat, name, wall=None, **fields):
    e = {"host": host, "pid": pid, "seq": seq, "t": t, "cat": cat,
         "name": name, "tid": 1}
    if wall is not None:
        e["wall"] = wall
    e.update(fields)
    return e


def _write_journal(path, events):
    with open(path, "w") as f:
        for e in events:
            f.write(json.dumps(e) + "\n")


# ---------------------------------------------------------------------------
# merge_journals: the three alignment tiers, dedup, rotation
# ---------------------------------------------------------------------------


def _clock_edge():
    a = [_ev("hostA", 1, 0, 1.0, "train", "step", wall=101.0),
         _ev("hostA", 1, 1, 5.0, "train", "step", wall=105.0),
         _ev("hostA", 1, 2, 6.0, "multihost", "clock", wall=106.0,
             offsets={"1": {"offset_s": 8.0, "host": "hostB"}})]
    b = [_ev("hostB", 2, 0, 2.0, "train", "step", wall=112.0)]
    return [a, b]


def _wall_anchor():
    a = [_ev("hostA", 1, 0, 1.0, "train", "step", wall=101.0),
         _ev("hostA", 1, 1, 5.0, "train", "step", wall=105.0)]
    b = [_ev("hostB", 2, 0, 2.0, "train", "step", wall=112.0)]
    return [a, b]


def _common_event():
    plan = {"seed": 7, "sites": 1}
    a = [_ev("hostA", 1, 0, 0.5, "train", "step", wall=100.5),
         _ev("hostA", 1, 1, 3.0, "faults", "configure", wall=103.0, **plan)]
    b = [_ev("hostB", 2, 0, 9.0, "faults", "configure", wall=119.0, **plan),
         _ev("hostB", 2, 1, 10.0, "train", "step", wall=120.0)]
    return [a, b]


def _no_wall():
    a = [_ev("hostA", 1, 0, 2.0, "domains", "configure", domains=2, ranks=8,
             sizes=[5, 3]),
         _ev("hostA", 1, 1, 4.0, "train", "step")]
    b = [_ev("hostB", 2, 0, 7.0, "domains", "configure", domains=2, ranks=8,
             sizes=[5, 3]),
         _ev("hostB", 2, 1, 8.0, "train", "step")]
    return [a, b]


def _dedup():
    a = [_ev("hostA", 1, 0, 1.0, "train", "step", wall=101.0),
         _ev("hostA", 1, 1, 2.0, "train", "step", wall=102.0)]
    return [a, list(a)]


def _four_processes():
    # four processes of one host (the chip phase's layout), each with a
    # clock event naming the others, and markers around one barrier
    out = []
    for p in range(4):
        base = 10.0 * p
        offs = {str(q): {"offset_s": 0.001 * (p - q), "host": "h"}
                for q in range(4) if q != p}
        out.append([
            _ev("h", 100 + p, 0, base + 1.0, "multihost", "clock",
                wall=1000.0 + 1.0 + 0.01 * p, process_index=p,
                offsets=offs),
            _ev("h", 100 + p, 1, base + 2.0, "smoke", "before_barrier",
                wall=1002.0 + 0.01 * p),
            _ev("h", 100 + p, 2, base + 3.0, "smoke", "after_barrier",
                wall=1003.0 + 0.01 * p)])
    return out


MERGES = {"clock_edge": _clock_edge, "wall_anchor": _wall_anchor,
          "common_event": _common_event, "no_wall": _no_wall,
          "dedup": _dedup, "four_processes": _four_processes}


@pytest.mark.parametrize("case", list(MERGES))
def test_merge_journals_parity(case):
    inputs = MERGES[case]()
    got = TCL.merge_journals(inputs)
    assert got == JCL.merge_journals(MERGES[case]())
    ts = [e["t"] for e in got]
    assert ts == sorted(ts)
    if case == "clock_edge":
        steps = {e["host"]: e for e in got
                 if e["name"] == "step" and e["seq"] == 0}
        assert steps["hostB"]["t"] == pytest.approx(19.0)
        assert steps["hostB"]["t_local"] == pytest.approx(2.0)
    if case == "dedup":
        assert [e["seq"] for e in got] == [0, 1]
    if case == "four_processes":
        assert len({(e["host"], e["pid"]) for e in got}) == 4
        before = [e["t"] for e in got if e["name"] == "before_barrier"]
        after = [e["t"] for e in got if e["name"] == "after_barrier"]
        assert max(before) <= min(after)


def test_merge_reads_rotated_sibling(tmp_path):
    p = tmp_path / "j.jsonl"
    _write_journal(str(p) + ".1",
                   [_ev("h", 1, 0, 1.0, "train", "step", wall=101.0)])
    _write_journal(str(p),
                   [_ev("h", 1, 1, 2.0, "train", "step", wall=102.0)])
    got = TCL.merge_journals([str(p)])
    assert got == JCL.merge_journals([str(p)])
    assert [e["seq"] for e in got] == [0, 1]


# ---------------------------------------------------------------------------
# reconstruct_incidents, bundles, the incident trace
# ---------------------------------------------------------------------------

_I1 = "inc-hostA-1-1"
_I2 = "inc-hostB-2-1"


def _partition_story():
    return [
        _ev("hostA", 1, 0, 10.0, "faults", "fire", wall=1000.0,
            action="partition", site="train.step"),
        _ev("hostA", 1, 1, 10.2, "multihost", "quorum", wall=1000.2,
            verdict="quorum", side=[0, 1, 2, 3, 4], lost=[5, 6, 7],
            incident=_I1),
        _ev("hostA", 1, 2, 10.3, "incident", "begin", wall=1000.3,
            kind="partition", incident=_I1),
        _ev("hostA", 1, 3, 10.4, "recovery", "failure", wall=1000.4,
            attempt=1, verdict="partition", retrying=True, incident=_I1),
        _ev("hostA", 1, 4, 10.5, "checkpoint", "restore_peer",
            wall=1000.5, step=4, incident=_I1),
        _ev("hostA", 1, 5, 10.6, "elastic", "shrink", wall=1000.6,
            live=5, moved=3, incident=_I1),
        _ev("hostA", 1, 6, 10.9, "recovery", "recovered", wall=1000.9,
            attempts=1, incident=_I1),
        _ev("hostA", 1, 7, 11.0, "incident", "end", wall=1001.0,
            resolution="recovered", incident=_I1),
        _ev("hostB", 2, 0, 10.35, "incident", "begin", wall=1000.35,
            kind="partition", incident=_I2),
        _ev("hostB", 2, 1, 10.45, "multihost", "quorum", wall=1000.45,
            verdict="minority", side=[5, 6, 7], lost=[0, 1, 2, 3, 4],
            incident=_I2),
        _ev("hostB", 2, 2, 10.55, "recovery", "minority_exit",
            wall=1000.55, side=[5, 6, 7], lost=[0, 1, 2, 3, 4],
            incident=_I2),
        _ev("hostB", 2, 3, 10.65, "incident", "end", wall=1000.65,
            resolution="minority_exit", incident=_I2),
        _ev("hostB", 2, 4, 10.75, "serve", "partition_drain",
            wall=1000.75, side=[5, 6, 7], lost=[0, 1, 2, 3, 4],
            endpoint="echo"),
    ]


def _late():
    return [_ev("hostA", 1, 10, 500.0, "incident", "begin", wall=1490.0,
                kind="device_loss", incident="inc-hostA-1-9"),
            _ev("hostA", 1, 11, 500.5, "incident", "end", wall=1490.5,
                resolution="recovered", incident="inc-hostA-1-9")]


def _orphan():
    return [_ev("hostA", 1, 20, 900.0, "recovery", "failure", wall=1900.0,
                attempt=1, verdict="oom", retrying=False)]


STORIES = {"one_episode": lambda: _partition_story(),
           "two_windows": lambda: _partition_story() + _late(),
           "orphan_recovery": lambda: _partition_story() + _orphan(),
           "merged_hosts": lambda: JCL.merge_journals(
               [_partition_story()[:8], _partition_story()[8:]])}


@pytest.mark.parametrize("story", list(STORIES))
def test_reconstruct_incidents_parity(story):
    got = TCL.reconstruct_incidents(STORIES[story]())
    assert got == JCL.reconstruct_incidents(STORIES[story]())
    if story == "one_episode":
        ep, = got["incidents"]
        assert sorted(ep["ids"]) == [_I1, _I2]
        assert ep["resolutions"] == {_I1: "recovered",
                                     _I2: "minority_exit"}
    if story == "orphan_recovery":
        assert got["unattributed_recovery_events"] == 1


@pytest.mark.parametrize("story", list(STORIES))
def test_format_incidents_and_trace_parity(story):
    rep = TCL.reconstruct_incidents(STORIES[story]())
    out_t, out_j = io.StringIO(), io.StringIO()
    TCL.format_incidents(rep, out_t)
    JCL.format_incidents(rep, out_j)
    assert out_t.getvalue() == out_j.getvalue()
    assert TCL.incident_trace(STORIES[story](), rep) == \
        JCL.incident_trace(STORIES[story](), rep)
    assert TCL.incident_trace(STORIES[story]()) == \
        JCL.incident_trace(STORIES[story]())


def _bundle(path, *, incident=None, wall=1000.7, version=2,
            kind="da_tpu_postmortem"):
    b = {"kind": kind, "reason": "crash", "classification": "partition",
         "host": "hostB", "pid": 2, "wall": wall}
    if version is not None:
        b["schema_version"] = version
    if incident is not None:
        b["incident"] = incident
    with open(path, "w") as f:
        json.dump(b, f)


def test_bundles_attribution_parity(tmp_path):
    assert TFL.SCHEMA_VERSION == JFL.SCHEMA_VERSION
    _bundle(tmp_path / "by_id.json", incident=_I2)
    _bundle(tmp_path / "by_window.json")
    _bundle(tmp_path / "orphan.json", wall=5000.0)
    _bundle(tmp_path / "v1.json", version=None)
    (tmp_path / "other.json").write_text('{"kind": "other"}')
    (tmp_path / "garbage.json").write_text("not json")
    got = TCL.load_bundles([str(tmp_path)])
    assert got == JCL.load_bundles([str(tmp_path)])
    assert len(got) == 4
    rep = TCL.reconstruct_incidents(_partition_story(), got)
    assert rep == JCL.reconstruct_incidents(_partition_story(), got)
    assert rep["bundles_attributed"] == 3


def test_bundles_newer_schema_refused(tmp_path):
    _bundle(tmp_path / "v99.json", version=99)
    with pytest.raises(ValueError, match="schema_version 99"):
        TCL.load_bundles([str(tmp_path)])
    with pytest.raises(ValueError, match="schema_version 99"):
        JCL.load_bundles([str(tmp_path)])


# ---------------------------------------------------------------------------
# summarize / format_summary / read_journal
# ---------------------------------------------------------------------------


def _recorded_journal(tmp_path):
    """A journal the port's telemetry wrote: spans, comm records, events,
    a counter and a journaled gauge."""
    path = str(tmp_path / "port.jsonl")
    TT.configure(path)
    with TT.span("outer", step=1):
        TT.record_comm("reshard", 256, op="x")
        with TT.span("inner"):
            TT.record_comm("h2d", 1024, op="device_put")
        TT.event("jit", "build", fn="f")
    TT.set_gauge("elastic.live_devices", 4, journal=True)
    TT.event("multihost", "clock", process_index=0,
             offsets={"1": {"offset_s": 0.002, "host": "h"}})
    TT.configure(None)
    return path


SUMMARY_INPUTS = {
    "story": lambda tmp: _partition_story(),
    "merged": lambda tmp: JCL.merge_journals(_four_processes()),
    "recorded": lambda tmp: TSM.read_journal(_recorded_journal(tmp)),
}


@pytest.mark.parametrize("what", list(SUMMARY_INPUTS))
def test_summarize_parity(tmp_path, what):
    evs = SUMMARY_INPUTS[what](tmp_path)
    got = TSM.summarize(evs)
    assert got == JSM.summarize(evs)
    out_t, out_j = io.StringIO(), io.StringIO()
    TSM.format_summary(got, out_t)
    JSM.format_summary(got, out_j)
    lt, lj = out_t.getvalue().splitlines(), out_j.getvalue().splitlines()
    assert len(lt) == len(lj)
    differ = [(a, b) for a, b in zip(lt, lj) if a != b]
    assert all("(reconstruct:" in a and "(reconstruct:" in b
               for a, b in differ), differ
    assert all("reconstruct_incidents" in a for a, _ in differ)
    if what == "story":
        assert len(differ) == 1


def test_read_journal_tolerates_torn_line(tmp_path):
    p = tmp_path / "j.jsonl"
    p.write_text('{"cat": "comm", "name": "h2d", "bytes": 4, "t": 0.1}\n'
                 '{"cat": "comm", "na')
    evs = TSM.read_journal(str(p))
    assert evs == JSM.read_journal(str(p))
    s = TSM.summarize(evs)
    assert s == JSM.summarize(evs)
    assert s["comm"]["total_bytes"] == 4
    assert s["by_category"]["_journal"] == 1


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pid", [0, 7])
def test_to_perfetto_parity_on_a_recorded_journal(tmp_path, pid):
    evs = TSM.read_journal(_recorded_journal(tmp_path))
    got = TEX.to_perfetto(evs, pid=pid)
    assert got == JEX.to_perfetto(evs, pid=pid)
    names = {e["name"] for e in got["traceEvents"]}
    assert {"outer", "inner", "comm/reshard"} <= names
    for e in got["traceEvents"]:
        for key in ("ph", "ts", "dur", "pid", "tid"):
            assert key in e, (key, e)


def test_to_perfetto_parity_on_merged_processes():
    merged = JCL.merge_journals(_four_processes())
    assert TT.to_perfetto(merged) == JT.to_perfetto(merged)
    assert TEX.to_perfetto(_partition_story()) == \
        JEX.to_perfetto(_partition_story())


def _registry_workload(tm):
    tm.count("op.matmul", 3)
    tm.count("fallback.hits", key="dfft-host-(2, 2)-2-(0, 1)")
    tm.count("multi", a="x,y", kernel="k")
    tm.count("multihost.quorum_checks", verdict="healthy")
    tm.set_gauge("pool.size", 7)
    tm.observe("optimer.step", 0.5)
    tm.observe("optimer.step", 1.5)
    tm.observe("lat", 3.0, buckets=(1.0, 10.0))
    tm.record_comm("reshard", 1024, op="x")
    tm.record_comm("multihost_gather", 4096, op="gather_global")
    with tm.span("phase"):
        tm.record_comm("h2d", 10)


@pytest.mark.parametrize("source", ["port", "jax"])
def test_to_prometheus_parity(source):
    tm = TT if source == "port" else JT
    _registry_workload(tm)
    rep = tm.report()
    text = TEX.to_prometheus(rep)
    assert text == JEX.to_prometheus(rep)
    assert "da_tpu_op_matmul_total 3" in text
    assert ('da_tpu_fallback_hits_total'
            '{key="dfft-host-(2, 2)-2-(0, 1)"} 1') in text
    assert 'da_tpu_multi_total{a="x,y",kernel="k"} 1' in text
    assert 'da_tpu_comm_bytes_total{kind="multihost_gather"} 4096' in text
    assert 'da_tpu_span_bytes_total{span="phase"} 10' in text


def test_to_prometheus_default_registry_is_the_port_report():
    _registry_workload(TT)
    assert TT.to_prometheus() == JEX.to_prometheus(TT.report())
