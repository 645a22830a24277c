"""The port's tuning advisor (``distributedarrays_tpu_torch/telemetry/
advisor.py`` and the command line's ``advise``) against the JAX package's.

- The cases of ``tests/test_advisor.py`` on the port: the decision table
  on hand-built journals, provenance and undo, the guarded apply with
  injected probes (keep, roll back, measure-or-revert, re-sweep, no-op),
  the ``autotune_regressed`` alert, the tuning table and the CLI.
- Both packages' ``advise`` on the same doctor report give the same
  actions under the mapping of the port's docstring: ``rdma_chunks``
  decided alike (and skipped by the port's ``apply``: no knob of the port
  reads it), JAX's ``rdma_dispatch`` ``xla``/``rdma`` as
  ``matmul_impl_dist`` ``torch``/``ring_ag``, JAX's ``pallas_matmul``
  block re-sweep as a ``matmul_impl`` sweep over ``pallas``/``torch``.
- Each mapped action reaches the knob the port reads: the ring and default
  routes of a (p,1) GEMM stamp one ``dispatch_key``, the key K1's span
  stamps is the key ``_impl_choice`` reads, and the default probes run
  those paths on the CPU, also from the command line in a fresh process;
  an ``rdma_chunks`` entry reaches no reshard plan.
"""

import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import distributedarrays_tpu_torch as tdat
from distributedarrays_tpu.telemetry import advisor as JADV
from distributedarrays_tpu.telemetry import perf as JP
from distributedarrays_tpu.utils import autotune as JAT
from distributedarrays_tpu_torch.ops import cuda_gemm, linalg
from distributedarrays_tpu_torch.parallel import reshard as TR
from distributedarrays_tpu_torch.telemetry import __main__ as TCLI
from distributedarrays_tpu_torch.telemetry import advisor, alerts, perf, regress
from distributedarrays_tpu_torch.telemetry.fixtures import (  # noqa: F401
    telemetry_capture)
from distributedarrays_tpu_torch.telemetry.summarize import (
    format_summary, read_journal, summarize)
from distributedarrays_tpu_torch.utils import autotune

from _torch_port import jax_process_state, port_ranks  # noqa: F401

# synthetic platform: every peak 100 units/s makes the roofline math
# hand-computable (bytes_ici=100 over 1s == exactly the ICI peak)
PEAKS = {"flops": 100.0, "hbm": 100.0, "ici": 100.0, "platform": "t"}

A2A_KEY = "a2a|8|64|float32|8|t|t"
DISPATCH_KEY = "64|16|32|4|torch.float32|torch.float32|t|t"
GEMM_KEY = "512|512|512|torch.float32|torch.float32|t|t"


@pytest.fixture
def clean_autotune(monkeypatch):
    """Empty registries (both packages') that never lazily reload a cache
    file."""
    for at in (autotune, JAT):
        at.clear()
        monkeypatch.setattr(at, "_LOADED_ENV", True)
    yield autotune
    for at in (autotune, JAT):
        at.clear()


def _sp(sid, name, start, dur, labels=None, parent=None):
    return {"cat": "span", "name": name, "span_id": sid,
            "parent_id": parent, "start": float(start),
            "dur": float(dur), "tid": 1, "labels": dict(labels or {})}


def _rdma_reshard_span(sid=1, *, dur=1.0, chunks=4, start=0.0):
    """A reshard span whose ICI stamp fills its whole duration with zero
    compute to hide behind -> unoverlapped_comm, severity == dur."""
    return _sp(sid, "reshard", start, dur, labels={
        "bytes_ici": 100.0 * dur, "dispatch": "rdma",
        "autotune_key": A2A_KEY, "rdma_chunks": chunks, "shape": [64, 64],
        "dtype": "float32", "src_dim": 0, "dst_dim": 1, "nparts": 8})


def _ring_span(sid=1, *, dur=1.0, start=0.0):
    """The K14 ring's span of a (4,1) x (4,1) product."""
    return _sp(sid, "matmul.ring_ag", start, dur, labels={
        "bytes_ici": 100.0 * dur, "dispatch": "rdma",
        "dispatch_key": DISPATCH_KEY, "shape": [64, 32, 16],
        "dtype": "torch.float32", "ranks": 4})


def _torch_span(sid=2, *, dur=0.4, start=10.0, disp="torch"):
    """The default route's ``matmul`` span of the same product."""
    return _sp(sid, "matmul", start, dur, labels={
        "bytes_ici": 10.0, "dispatch": disp, "dispatch_key": DISPATCH_KEY,
        "shape": [64, 32, 16], "dtype": "torch.float32", "ranks": 4})


def _gemm_span(sid=3, *, dur=1.0, flops=30.0, start=20.0):
    """flops=30 over 1s against a 100-peak -> 30% roofline -> finding."""
    return _sp(sid, "pallas.matmul", start, dur, labels={
        "flops": flops, "autotune_key": GEMM_KEY,
        "shape": [512, 512, 512],
        "dtype": ["torch.float32", "torch.float32"]})


# ---------------------------------------------------------------------------
# the doctor's hints and the decision table
# ---------------------------------------------------------------------------


def test_findings_carry_action_hints():
    evs = [_rdma_reshard_span(1), _ring_span(2, start=5.0), _gemm_span(3)]
    analysis = perf.analyze(evs, peaks=PEAKS)
    assert analysis["findings"] == JP.analyze(evs, peaks=PEAKS)["findings"]
    hints = {f["action"]["kernel"]: f["action"]
             for f in analysis["findings"] if f.get("action")}
    rc = hints["rdma_chunks"]
    assert rc["key"] == A2A_KEY
    assert rc["direction"] == "increase" and rc["current"] == 4
    assert hints["rdma_dispatch"]["key"] == DISPATCH_KEY
    lr = hints["pallas_matmul"]
    assert lr["key"] == GEMM_KEY and lr["direction"] == "resweep"
    assert lr["shape"] == [512, 512, 512]


def test_action_hint_torch_span_suggests_dispatch_compare():
    hint = perf._action_hint("unoverlapped_comm", "matmul",
                             {"dispatch": "torch",
                              "dispatch_key": DISPATCH_KEY})
    assert hint == {"kernel": "rdma_dispatch", "key": DISPATCH_KEY,
                    "param": "dispatch", "direction": "compare",
                    "current": "torch"}
    assert perf._action_hint("unoverlapped_comm", "reshard", {}) is None
    assert perf._action_hint("low_roofline", "other.op",
                             {"autotune_key": GEMM_KEY}) is None


def test_advise_unoverlapped_rdma_doubles_chunks(clean_autotune):
    analysis = perf.analyze([_rdma_reshard_span(chunks=4)], peaks=PEAKS)
    actions = {a.kind: a for a in advisor.advise(analysis)}
    a = actions["rdma_chunks"]
    assert a.kernel == "rdma_chunks" and a.key == A2A_KEY
    assert a.proposed == [8]
    assert a.finding == "unoverlapped_comm"
    assert a.evidence["chunks"] == 4
    assert a.evidence["overlap_frac"] == 0.0
    assert a.probe["op"] == "reshard" and a.probe["shape"] == [64, 64]


def test_advise_chunk_depth_edge_cases(clean_autotune):
    one = perf.analyze([_rdma_reshard_span(chunks=1)], peaks=PEAKS)
    acts = [a for a in advisor.advise(one) if a.kind == "rdma_chunks"]
    assert acts and acts[0].proposed == [2]
    capped = perf.analyze([_rdma_reshard_span(chunks=advisor.MAX_CHUNKS)],
                          peaks=PEAKS)
    assert not [a for a in advisor.advise(capped)
                if a.kind == "rdma_chunks"]
    near = perf.analyze([_rdma_reshard_span(chunks=48)], peaks=PEAKS)
    acts = [a for a in advisor.advise(near) if a.kind == "rdma_chunks"]
    assert acts and acts[0].proposed == [advisor.MAX_CHUNKS]


def test_dispatch_deltas_need_both_sides(clean_autotune):
    only_ring = perf.analyze([_ring_span()], peaks=PEAKS)
    assert advisor.dispatch_deltas(only_ring) == []
    # JAX's "xla" class is not a port dispatch: no comparison
    xla = perf.analyze([_ring_span(), _torch_span(disp="xla")], peaks=PEAKS)
    assert advisor.dispatch_deltas(xla) == []
    both = perf.analyze([_ring_span(dur=1.0), _torch_span(dur=0.4)],
                        peaks=PEAKS)
    deltas = advisor.dispatch_deltas(both)
    assert len(deltas) == 1
    d = deltas[0]
    assert d["key"] == DISPATCH_KEY and d["faster"] == "torch"
    assert d["rdma_s"] == pytest.approx(1.0)
    assert d["torch_s"] == pytest.approx(0.4)
    assert d["delta_frac"] == pytest.approx(0.6)
    assert d["n_rdma"] == d["n_torch"] == 1


def test_advise_pins_faster_dispatch(clean_autotune):
    analysis = perf.analyze([_ring_span(dur=1.0), _torch_span(dur=0.4)],
                            peaks=PEAKS)
    acts = [a for a in advisor.advise(analysis) if a.kind == "dispatch"]
    assert len(acts) == 1
    a = acts[0]
    assert a.kernel == "matmul_impl_dist" and a.key == DISPATCH_KEY
    assert a.proposed == "torch" and a.current is None
    assert a.evidence["delta_frac"] == pytest.approx(0.6)
    assert a.probe["op"] == "matmul" and a.probe["ranks"] == 4
    autotune.record("matmul_impl_dist", DISPATCH_KEY, "torch")
    assert not [x for x in advisor.advise(analysis) if x.kind == "dispatch"]
    # the ring measured faster -> "ring_ag"
    ring = perf.analyze([_ring_span(dur=0.3), _torch_span(dur=1.0)],
                        peaks=PEAKS)
    acts = [a for a in advisor.advise(ring) if a.kind == "dispatch"]
    assert acts[0].proposed == "ring_ag" and acts[0].current == "torch"
    assert acts[0].probe["op"] == "matmul.ring_ag"


def test_advise_dispatch_jitter_gate(clean_autotune):
    analysis = perf.analyze([_ring_span(dur=1.0), _torch_span(dur=0.95)],
                            peaks=PEAKS)
    assert not [a for a in advisor.advise(analysis)
                if a.kind == "dispatch"]


def test_advise_low_roofline_resweep(clean_autotune):
    autotune.record("matmul_impl", GEMM_KEY, "pallas")
    analysis = perf.analyze([_gemm_span()], peaks=PEAKS)
    acts = [a for a in advisor.advise(analysis) if a.kind == "resweep"]
    assert len(acts) == 1
    a = acts[0]
    assert a.kernel == "matmul_impl" and a.key == GEMM_KEY
    assert a.current == "pallas" and a.proposed is None
    assert a.candidates == ["pallas", "torch"]
    assert a.probe == {"op": "pallas.matmul", "shape": [512, 512, 512],
                       "dtype": ["torch.float32", "torch.float32"]}
    assert a.evidence["roofline_frac"] == pytest.approx(0.3)


def test_advise_dedups_per_registry_address(clean_autotune):
    evs = [_rdma_reshard_span(1, start=0.0),
           _rdma_reshard_span(2, start=5.0),
           _gemm_span(3), _gemm_span(4, start=30.0)]
    actions = advisor.advise(perf.analyze(evs, peaks=PEAKS))
    addrs = [(a.kernel, a.key) for a in actions]
    assert len(addrs) == len(set(addrs))
    assert set(a.kind for a in actions) == {"rdma_chunks", "resweep"}


def _jax_form(ev):
    """The JAX package's journal form of a port span: its non-RDMA
    dispatch class is ``xla``, its GEMM keys name numpy dtypes."""
    ev = json.loads(json.dumps(ev).replace("torch.float32", "float32"))
    if ev["labels"].get("dispatch") == "torch":
        ev["labels"]["dispatch"] = "xla"
    return ev


@pytest.mark.parametrize("case", ["chunks", "dispatch_torch",
                                  "dispatch_ring", "resweep", "all"])
def test_both_advisors_map_one_report(clean_autotune, jax_process_state,
                                      case):
    evs = {"chunks": [_rdma_reshard_span(chunks=4)],
           "dispatch_torch": [_ring_span(dur=1.0), _torch_span(dur=0.4)],
           "dispatch_ring": [_ring_span(dur=0.2), _torch_span(dur=1.0)],
           "resweep": [_gemm_span()],
           "all": [_rdma_reshard_span(1, chunks=48),
                   _ring_span(2, dur=1.0, start=3.0),
                   _torch_span(4, dur=0.5), _gemm_span(5)]}[case]
    jax_acts = JADV.advise(JP.analyze([_jax_form(e) for e in evs],
                                      peaks=PEAKS))
    port_acts = advisor.advise(perf.analyze(evs, peaks=PEAKS))
    to_port = {"rdma_chunks": "rdma_chunks", "rdma_dispatch":
               "matmul_impl_dist", "pallas_matmul": "matmul_impl"}
    value = {"xla": "torch", "rdma": "ring_ag"}

    def mapped(a):
        prop = value.get(a.proposed, a.proposed) if a.kind == "dispatch" \
            else a.proposed
        return (a.kind, to_port[a.kernel], prop, a.finding)

    assert [mapped(a) for a in jax_acts] == [
        (a.kind, a.kernel, a.proposed, a.finding) for a in port_acts]
    assert port_acts
    for j, t in zip(jax_acts, port_acts):
        if t.kind == "resweep":
            assert t.candidates == list(advisor.GEMM_ROUTES)
            assert j.candidates and all(
                512 % x == 0 for c in j.candidates for x in c)
        if t.kind == "rdma_chunks":
            assert t.key == j.key
        assert t.evidence.get("severity_s") == j.evidence.get("severity_s")


# ---------------------------------------------------------------------------
# provenance round-trip + undo
# ---------------------------------------------------------------------------


def test_provenance_roundtrip_and_undo(clean_autotune, tmp_path):
    K, KEY = "matmul_impl_dist", DISPATCH_KEY
    autotune.record(K, KEY, "torch")
    assert autotune.provenance_for(K, KEY) is None
    stamp = {"source": "advisor", "finding": "dispatch_delta",
             "evidence": {"before_s": [0.01]}, "previous": "torch"}
    autotune.record(K, KEY, "ring_ag", provenance=stamp)
    assert autotune.get(K, KEY) == "ring_ag"
    assert autotune.provenance_for(K, KEY)["source"] == "advisor"
    path = tmp_path / "cache.json"
    autotune.save(str(path))
    doc = json.loads(path.read_text())
    assert doc[K][KEY] == "ring_ag"
    assert doc["__provenance__"][K][KEY]["finding"] == "dispatch_delta"
    autotune.clear()
    autotune.load(str(path))
    assert autotune.get(K, KEY) == "ring_ag"
    assert autotune.get("__provenance__", KEY) is None
    assert autotune.provenance_for(K, KEY)["source"] == "advisor"
    autotune.record(K, KEY, "summa", provenance=stamp)
    assert autotune.undo(K, KEY) is True
    assert autotune.get(K, KEY) == "ring_ag"
    assert autotune.undo(K, KEY) is False


def test_undo_restores_deletion(clean_autotune):
    assert autotune.get("matmul_impl_dist", DISPATCH_KEY) is None
    autotune.record("matmul_impl_dist", DISPATCH_KEY, "torch",
                    provenance={"source": "advisor"})
    assert autotune.undo("matmul_impl_dist", DISPATCH_KEY) is True
    assert autotune.get("matmul_impl_dist", DISPATCH_KEY) is None
    assert DISPATCH_KEY not in autotune._REGISTRY.get("matmul_impl_dist", {})


def test_undo_journal_is_bounded(clean_autotune):
    for i in range(autotune._UNDO_LIMIT + 10):
        autotune.record("k", f"key{i}", [i], provenance={"i": i})
    assert len(autotune.undo_log()) == autotune._UNDO_LIMIT


# ---------------------------------------------------------------------------
# guarded apply
# ---------------------------------------------------------------------------


def _chunk_action(current=None, proposed=None):
    """JAX's ``rdma_chunks`` action, which no knob of the port reads."""
    return advisor.TuningAction(
        kind="rdma_chunks", kernel="rdma_chunks", key=A2A_KEY,
        current=current, proposed=proposed or [2],
        finding="unoverlapped_comm", evidence={"severity_s": 1.0},
        probe={"op": "reshard", "shape": [64, 64]})


def _dispatch_action(current=None, proposed="ring_ag"):
    return advisor.TuningAction(
        kind="dispatch", kernel="matmul_impl_dist", key=DISPATCH_KEY,
        current=current, proposed=proposed, finding="dispatch_delta",
        evidence={"severity_s": 1.0},
        probe={"op": "matmul", "shape": [64, 32, 16],
               "dtype": "torch.float32", "ranks": 4})


def _registry_probe(slow_on, fast=0.01, slow=0.02):
    """Deterministic probe reading the registry as a real workload would:
    the configs in ``slow_on`` measure ``slow`` seconds."""
    def probe(action, config=None):
        cur = autotune.get(action.kernel, action.key)
        return slow if cur in slow_on else fast
    return probe


def test_apply_keeps_an_improving_tune(clean_autotune, telemetry_capture):
    autotune.record("matmul_impl_dist", DISPATCH_KEY, "torch")
    action = _dispatch_action(current="torch", proposed="ring_ag")
    results = advisor.apply([action], probe=_registry_probe(["torch"]),
                            repeats=3, evaluate_alerts=False)
    assert [r["status"] for r in results] == ["applied"]
    assert autotune.get("matmul_impl_dist", DISPATCH_KEY) == "ring_ag"
    prov = autotune.provenance_for("matmul_impl_dist", DISPATCH_KEY)
    assert prov["source"] == "advisor"
    assert prov["finding"] == "dispatch_delta"
    assert prov["previous"] == "torch"
    assert prov["evidence"]["before_s"] == [0.02, 0.02, 0.02]
    assert telemetry_capture.counter_value(
        "autotune.advisor_applies", kind="dispatch") == 1
    assert telemetry_capture.counter_value(
        "autotune.advisor_writes", kind="dispatch") == 1


def test_apply_rolls_back_a_regressing_tune(clean_autotune,
                                            telemetry_capture):
    autotune.record("matmul_impl_dist", DISPATCH_KEY, "torch")
    action = _dispatch_action(current="torch", proposed="ring_ag")
    results = advisor.apply([action],
                            probe=_registry_probe(["ring_ag"], slow=0.02),
                            repeats=3, evaluate_alerts=False)
    r = results[0]
    assert r["status"] == "rolled_back"
    assert "micro-probe regressed" in r["reason"]
    assert autotune.get("matmul_impl_dist", DISPATCH_KEY) == "torch"
    assert autotune.provenance_for("matmul_impl_dist", DISPATCH_KEY) is None
    assert autotune.undo_log() == []
    assert telemetry_capture.counter_value(
        "autotune.advisor_rollbacks", kind="dispatch") == 1
    assert telemetry_capture.counter_value(
        "autotune.undo", kernel="matmul_impl_dist") == 1


def test_apply_measure_or_revert_contract(clean_autotune,
                                          telemetry_capture):
    autotune.record("matmul_impl_dist", DISPATCH_KEY, "torch")
    calls = {"n": 0}

    def probe(action, config=None):
        calls["n"] += 1
        if calls["n"] > 4:            # warmup + 3 before; after dies
            raise RuntimeError("tunnel dropped")
        return 0.01

    results = advisor.apply([_dispatch_action(current="torch")],
                            probe=probe, repeats=3, evaluate_alerts=False)
    assert results[0]["status"] == "rolled_back"
    assert "after-probe failed" in results[0]["reason"]
    assert autotune.get("matmul_impl_dist", DISPATCH_KEY) == "torch"

    def dead(action, config=None):
        raise RuntimeError("no devices")
    results = advisor.apply([_dispatch_action(current="torch",
                                              proposed="summa")],
                            probe=dead, repeats=3, evaluate_alerts=False)
    assert results[0]["status"] == "skipped"
    assert autotune.get("matmul_impl_dist", DISPATCH_KEY) == "torch"
    assert telemetry_capture.counter_value(
        "autotune.advisor_skips", kind="dispatch") == 1


def test_apply_resweep_records_sweep_winner(clean_autotune,
                                            telemetry_capture):
    autotune.record("matmul_impl", GEMM_KEY, "pallas")
    action = advisor.TuningAction(
        kind="resweep", kernel="matmul_impl", key=GEMM_KEY,
        current="pallas", proposed=None, finding="low_roofline",
        evidence={"severity_s": 0.7},
        probe={"op": "pallas.matmul", "shape": [512, 512, 512],
               "dtype": ["torch.float32", "torch.float32"]},
        candidates=list(advisor.GEMM_ROUTES))

    def probe(act, config=None):
        if config is not None:
            return {"pallas": 0.03, "torch": 0.01}[config]
        return 0.01 if autotune.get(act.kernel, act.key) == "torch" \
            else 0.03

    results = advisor.apply([action], probe=probe, repeats=3,
                            evaluate_alerts=False)
    r = results[0]
    assert r["status"] == "applied"
    assert r["proposed"] == "torch"
    assert r["sweep_candidates"] == 2
    assert autotune.get("matmul_impl", GEMM_KEY) == "torch"
    assert autotune.provenance_for(
        "matmul_impl", GEMM_KEY)["finding"] == "low_roofline"


def test_apply_skips_noop_proposal(clean_autotune, telemetry_capture):
    autotune.record("matmul_impl_dist", DISPATCH_KEY, "ring_ag")
    results = advisor.apply([_dispatch_action(current="ring_ag")],
                            probe=lambda a, c=None: 0.01,
                            evaluate_alerts=False)
    assert results[0]["status"] == "skipped"
    assert results[0]["reason"] == "already at proposal"
    assert autotune.provenance_for("matmul_impl_dist", DISPATCH_KEY) is None


def test_apply_skips_an_action_without_a_port_knob(clean_autotune,
                                                   telemetry_capture):
    # JAX's rdma_chunks action: no knob of the port reads the entry, so it
    # is skipped with that reason, unprobed and unwritten
    probed = []
    results = advisor.apply([_chunk_action(current=None, proposed=[8])],
                            probe=lambda a, c=None: probed.append(a) or 0.01,
                            evaluate_alerts=False)
    assert results[0]["status"] == "skipped"
    assert results[0]["reason"] == advisor.NO_PORT_KNOB["rdma_chunks"]
    assert results[0]["reason"].startswith("no port knob")
    assert probed == []
    assert autotune.get("rdma_chunks", A2A_KEY) is None
    assert autotune.undo_log() == []
    assert telemetry_capture.counter_value(
        "autotune.advisor_skips", kind="rdma_chunks") == 1
    assert telemetry_capture.counter_value(
        "autotune.advisor_writes", kind="rdma_chunks") == 0
    with pytest.raises(ValueError, match="no port knob"):
        advisor.default_probe(_chunk_action())
    # the human rendering says so with or without apply's results
    for res in (results, None):
        out = io.StringIO()
        advisor.format_results([_chunk_action(proposed=[8])], res, out)
        assert out.getvalue().startswith("SKIPPED ")
        assert advisor.NO_PORT_KNOB["rdma_chunks"] in out.getvalue()


# ---------------------------------------------------------------------------
# the autotune_regressed alert
# ---------------------------------------------------------------------------


def test_autotune_regressed_fires_once_and_clears(clean_autotune,
                                                  telemetry_capture):
    autotune.record("matmul_impl_dist", DISPATCH_KEY, "torch")
    mgr = alerts.AlertManager()
    t0 = 1000.0
    alerts.ensure_autotune_rule(mgr)
    assert alerts.ensure_autotune_rule(mgr) is mgr.rules()[0]
    mgr.evaluate(t0 - 30.0)
    assert mgr.firing() == []
    advisor.apply([_dispatch_action(current="torch")],
                  probe=_registry_probe(["ring_ag"]), repeats=3,
                  manager=mgr, now=t0)
    assert mgr.firing() == ["autotune_regressed"]
    mgr.evaluate(t0 + 120.0)
    assert mgr.firing() == []
    transitions = [e for e in telemetry_capture.events()
                   if e.get("cat") == "alert"
                   and e.get("name") == "autotune_regressed"]
    assert [e["state"] for e in transitions] == ["firing", "cleared"]
    assert telemetry_capture.counter_value(
        "alerts.transitions", alert="autotune_regressed",
        state="firing") == 1


def test_applied_tune_never_pages(clean_autotune, telemetry_capture):
    autotune.record("matmul_impl_dist", DISPATCH_KEY, "torch")
    mgr = alerts.AlertManager()
    advisor.apply([_dispatch_action(current="torch")],
                  probe=_registry_probe(["torch"]), repeats=3,
                  manager=mgr, now=500.0)
    assert mgr.firing() == []


# ---------------------------------------------------------------------------
# journal, summarize, rendering
# ---------------------------------------------------------------------------


def test_summarize_renders_tuning_table(clean_autotune, telemetry_capture):
    autotune.record("matmul_impl_dist", DISPATCH_KEY, "torch")
    advisor.apply([_dispatch_action(current="torch")],
                  probe=_registry_probe(["ring_ag"]), repeats=3,
                  evaluate_alerts=False)
    s = summarize(read_journal(telemetry_capture.journal_path()))
    assert len(s["tuning"]) == 2          # the advise verdict + the undo
    adv = [t for t in s["tuning"] if t["name"] == "advise"][0]
    assert adv["kernel"] == "matmul_impl_dist" and adv["key"] == DISPATCH_KEY
    assert adv["status"] == "rolled_back"
    assert adv["old"] == "torch" and adv["new"] == "ring_ag"
    out = io.StringIO()
    format_summary(s, out)
    assert "tuning provenance (advisor writes):" in out.getvalue()
    assert "ROLLED_BACK" in out.getvalue()
    assert DISPATCH_KEY in out.getvalue()


def test_format_results_renders_outcomes(clean_autotune, jax_process_state):
    action = _dispatch_action(current="torch")
    results = [dict(action.to_dict(), status="applied",
                    before_s=[0.02], after_s=[0.01])]
    out = io.StringIO()
    advisor.format_results([action], results, out)
    text = out.getvalue()
    assert "APPLIED" in text and DISPATCH_KEY in text
    assert "severity_s=1" in text and "before median 0.02s" in text
    # the same rendering as JAX's on the same action
    jout = io.StringIO()
    JADV.format_results([JADV.TuningAction(**action.to_dict())], results,
                        jout)
    assert text == jout.getvalue()
    out = io.StringIO()
    advisor.format_results([], None, out)
    assert "no tuning actions" in out.getvalue()


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def _cli(argv) -> tuple:
    import contextlib
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = TCLI.main(argv)
    return rc, out.getvalue(), err.getvalue()


def _journal(tmp_path, evs):
    path = tmp_path / "run.jsonl"
    path.write_text("".join(json.dumps(e) + "\n" for e in evs))
    return str(path)


def test_advise_cli_json(tmp_path, monkeypatch, clean_autotune):
    cache = tmp_path / "cache.json"
    cache.write_text(json.dumps({"matmul_impl_dist":
                                 {DISPATCH_KEY: "ring_ag"}}))
    monkeypatch.setenv("DAT_TORCH_AUTOTUNE_CACHE", str(cache))
    monkeypatch.setattr(autotune, "_LOADED_ENV", False)
    monkeypatch.setenv("DA_TPU_PEAKS", json.dumps(
        {"cpu": {k: v for k, v in PEAKS.items() if k != "platform"}}))
    path = _journal(tmp_path, [_rdma_reshard_span(1), _ring_span(2),
                               _torch_span(3)])
    rc, out, err = _cli(["advise", path, "--json", "--platform", "cpu"])
    assert rc == 0, err
    doc = json.loads(out)
    assert {a["kind"] for a in doc["actions"]} == {"rdma_chunks",
                                                   "dispatch"}
    assert doc["results"] is None
    chunk = [a for a in doc["actions"] if a["kind"] == "rdma_chunks"][0]
    # JAX's decision: doubling the depth the span ran with (4)
    assert chunk["key"] == A2A_KEY and chunk["proposed"] == [8]
    assert chunk["current"] is None
    disp = [a for a in doc["actions"] if a["kind"] == "dispatch"][0]
    # the cache file was read: the entry the dispatch action would replace
    assert disp["current"] == "ring_ag" and disp["proposed"] == "torch"
    rc, _, err = _cli(["advise", path, "--platform", "cpu",
                       "--min-actions", "3"])
    assert rc == 2 and "required at least 3" in err


def test_advise_cli_apply_rolls_back_and_fires(tmp_path, monkeypatch,
                                               clean_autotune,
                                               telemetry_capture):
    # --apply on a journal: the resweep is kept, the dispatch action
    # measures slower after its write and is rolled back, the alert fires,
    # JAX's chunk action is skipped (no port knob) and the port's cache
    # file (a temporary path here) holds the result
    cache = tmp_path / "cache.json"
    monkeypatch.setenv("DAT_TORCH_AUTOTUNE_CACHE", str(cache))
    monkeypatch.setenv("DA_TPU_PEAKS", json.dumps(
        {"cpu": {k: v for k, v in PEAKS.items() if k != "platform"}}))
    monkeypatch.setattr(advisor, "default_probe",
                        _registry_probe(["torch"]))
    alerts.default_manager().reset()
    path = _journal(tmp_path, [_rdma_reshard_span(1), _ring_span(2),
                               _torch_span(3), _gemm_span(4)])
    try:
        rc, out, err = _cli(["advise", path, "--json", "--apply",
                             "--platform", "cpu"])
        assert rc == 0, err
        res = {r["kind"]: r for r in json.loads(out)["results"]}
        assert res["dispatch"]["status"] == "rolled_back"
        assert res["resweep"]["status"] == "applied"
        assert res["rdma_chunks"]["status"] == "skipped"
        assert res["rdma_chunks"]["reason"] == \
            advisor.NO_PORT_KNOB["rdma_chunks"]
        assert autotune.get("matmul_impl_dist", DISPATCH_KEY) is None
        assert autotune.get("matmul_impl", GEMM_KEY) == "pallas"
        assert autotune.get("rdma_chunks", A2A_KEY) is None
        assert "autotune_regressed" in alerts.default_manager().firing()
        saved = json.loads(cache.read_text())
        assert saved["matmul_impl"][GEMM_KEY] == "pallas"
        assert DISPATCH_KEY not in saved.get("matmul_impl_dist", {})
        assert "rdma_chunks" not in saved
        assert telemetry_capture.counter_value(
            "autotune.advisor_rollbacks", kind="dispatch") == 1
    finally:
        alerts.default_manager().reset()


def test_advise_cli_apply_default_probes_in_a_fresh_process(tmp_path):
    # the command as a user runs it: a new process with no rank table, the
    # default probes, a journal of a 4-rank (4,1) GEMM on both routes and
    # a one-rank K1 span; the command builds the 4-rank table the dispatch
    # probe needs, so no action is skipped for a failed probe
    cache = tmp_path / "cache.json"
    path = _journal(tmp_path, [_rdma_reshard_span(1), _ring_span(2),
                               _torch_span(3), _gemm_span(4)])
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, DAT_TORCH_AUTOTUNE_CACHE=str(cache),
               DA_TPU_PEAKS=json.dumps({"cpu": {
                   k: v for k, v in PEAKS.items() if k != "platform"}}),
               PYTHONPATH=root + os.pathsep + os.environ.get(
                   "PYTHONPATH", ""))
    run = subprocess.run(
        [sys.executable, "-m", "distributedarrays_tpu_torch.telemetry",
         "advise", path, "--json", "--apply", "--device", "cpu",
         "--platform", "cpu", "--repeats", "1"],
        capture_output=True, text=True, cwd=str(tmp_path), env=env,
        timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    res = {r["kind"]: r for r in json.loads(run.stdout)["results"]}
    assert set(res) == {"dispatch", "resweep", "rdma_chunks"}
    for r in res.values():
        assert not str(r.get("reason") or "").startswith("probe failed"), r
    assert res["rdma_chunks"]["status"] == "skipped"
    for kind in ("dispatch", "resweep"):
        assert res[kind]["status"] in ("applied", "rolled_back"), res[kind]
        assert len(res[kind]["before_s"]) == len(res[kind]["after_s"]) == 1
    assert res["resweep"]["sweep_candidates"] == 2


def test_cmd_probe_sees_the_port_cache(tmp_path, monkeypatch,
                                       clean_autotune):
    cache = tmp_path / "port_cache.json"
    seen = tmp_path / "seen.txt"
    monkeypatch.setenv("DAT_TORCH_AUTOTUNE_CACHE", str(cache))
    monkeypatch.setenv(advisor.PROBE_CMD_ENV,
                       f'echo "$DA_TPU_ADVISE_KERNEL $DA_TPU_ADVISE_KEY '
                       f'$DAT_TORCH_AUTOTUNE_CACHE" >> {seen}')
    t = advisor.default_probe(_dispatch_action())
    assert t > 0
    assert seen.read_text().split() == ["matmul_impl_dist", DISPATCH_KEY,
                                        str(cache)]


def test_regress_explain_cli(tmp_path):
    base = tmp_path / "BENCH_r1.json"
    fresh = tmp_path / "fresh.json"
    base.write_text(json.dumps({"parsed": {"metric": "gemm_s",
                                           "value": 1.0}}))
    fresh.write_text(json.dumps({"metric": "gemm_s", "value": 2.0}))
    rc, out, _ = _cli(["regress", str(fresh), "--baseline", str(tmp_path),
                       "--explain"])
    assert rc == 1
    assert "REGRESSION" in out and "baseline: median 1" in out
    assert "lower is better" in out
    assert "conservative 50% of |median|" in out


def test_regress_explain_library():
    results = regress.compare({"x_s": 2.0}, {"x_s": [1.0, 1.0, 1.0]})
    assert results[0]["direction"] == "lower_is_better"
    out = io.StringIO()
    regress.format_results(results, out, explain=True)
    assert "max(mad_k*1.4826*MAD, rel_floor*|median|)" in out.getvalue()


# ---------------------------------------------------------------------------
# each action reaches the port's knob
# ---------------------------------------------------------------------------


def test_k1_span_key_is_the_key_impl_choice_reads(clean_autotune,
                                                  telemetry_capture):
    # the key K1's span stamps (tensor dtypes) and the key the one-rank
    # dispatch reads (DArray dtypes) print alike, so a resweep write
    # reaches dispatch
    m, k, n = 24, 16, 8
    for dt in (torch.float32, torch.bfloat16):
        a, b = torch.ones(m, k, dtype=dt), torch.ones(k, n, dtype=dt)
        cuda_gemm.cuda_matmul(a, b)
        key = telemetry_capture.spans("pallas.matmul")[-1]["labels"][
            "autotune_key"]
        A = tdat.distribute(a, procs=[0])
        B = tdat.distribute(b, procs=[0])
        assert key == linalg._impl_key(m, n, k, A.dtype, B.dtype)
        seen = []
        real = autotune.get

        def spy(kernel, key_, default=None):
            seen.append((kernel, key_))
            return real(kernel, key_, default)
        autotune.get = spy
        try:
            A @ B
        finally:
            autotune.get = real
        assert ("matmul_impl", key) in seen
        A.close()
        B.close()


def test_ring_and_torch_routes_stamp_one_dispatch_key(clean_autotune,
                                                      telemetry_capture):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((64, 32), dtype=np.float32))
    y = torch.from_numpy(rng.standard_normal((32, 16), dtype=np.float32))
    A = tdat.distribute(x, procs=range(4), dist=(4, 1))
    B = tdat.distribute(y, procs=range(4), dist=(4, 1))
    key = autotune.device_key_for(64, 16, 32, 4, torch.float32,
                                  torch.float32)
    c0 = A @ B                                  # default: torch
    autotune.record("matmul_impl_dist", key, "ring_ag")
    c1 = A @ B                                  # the ring
    torch.testing.assert_close(tdat.gather(c1), tdat.gather(c0))
    torch_span = [s for s in telemetry_capture.spans("matmul")
                  if s["labels"].get("dispatch") == "torch"]
    ring_span = telemetry_capture.spans("matmul.ring_ag")
    assert len(torch_span) == 1 and len(ring_span) == 1
    for s in (torch_span[0], ring_span[0]):
        assert s["labels"]["dispatch_key"] == key
        assert s["labels"]["ranks"] == 4
        assert s["labels"]["shape"] == [64, 32, 16]
    assert torch_span[0]["labels"]["dispatch_source"] == "default"
    assert ring_span[0]["labels"]["dispatch_source"] == "autotune"
    # on the CPU the ring runs its plain version
    assert ring_span[0]["labels"]["dispatch"] == "plain"
    # a (4,2) product is not ring-eligible: no dispatch labels
    C = tdat.distribute(x, procs=range(8), dist=(4, 2))
    C @ tdat.distribute(y, procs=range(8), dist=(4, 2))
    assert "dispatch" not in telemetry_capture.spans("matmul")[-1]["labels"]


def test_rdma_chunks_entry_reaches_no_plan(clean_autotune, monkeypatch,
                                          telemetry_capture):
    # no knob of the port reads an rdma_chunks entry: the all_to_all plan's
    # piece count is derived from the chunk target alone, and the reshard
    # span names its dispatch and nothing the advisor could tune
    monkeypatch.setenv("DA_TPU_RESHARD_CHUNK_MB", "0.001")
    TR._plan_cached.cache_clear()
    x = torch.arange(64 * 64, dtype=torch.float32).reshape(64, 64)
    E = tdat.distribute(x, procs=range(8), dist=(8, 1))
    pids = np.arange(8).reshape(1, 8)
    cuts = [[0, 64], list(range(0, 65, 8))]
    derived = TR.plan_reshard(E, pids, cuts)
    assert derived.strategy == "all_to_all" and derived.nchunks == 2
    autotune.record("rdma_chunks", autotune.device_key_for(
        "a2a", 8, 64, "float32", 8), [8])
    assert TR.plan_reshard(E, pids, cuts) is derived
    F = tdat.dzeros((64, 64), procs=range(8), dist=(1, 8))
    tdat.copyto_(F, E)
    np.testing.assert_array_equal(np.asarray(tdat.gather(F)), x.numpy())
    lab = telemetry_capture.spans("reshard")[-1]["labels"]
    assert lab["strategy"] == "all_to_all" and lab["dispatch"] == "plain"
    assert not {"rdma_chunks", "rdma_chunks_source", "autotune_key",
                "dispatch_key"} & set(lab)
    assert perf._action_hint("unoverlapped_comm", "reshard", lab) is None
    TR._plan_cached.cache_clear()


def test_default_probes_run_the_port_paths(clean_autotune, monkeypatch):
    calls = []
    real = cuda_gemm.cuda_matmul
    monkeypatch.setattr(cuda_gemm, "cuda_matmul",
                        lambda a, b: calls.append(tuple(a.shape)) or
                        real(a, b))
    gemm = advisor.TuningAction(
        kind="resweep", kernel="matmul_impl", key=GEMM_KEY, current=None,
        proposed=None, finding="low_roofline", evidence={},
        probe={"op": "pallas.matmul", "shape": [32, 16, 8],
               "dtype": ["torch.float32", "torch.float32"]},
        candidates=list(advisor.GEMM_ROUTES))
    assert advisor.default_probe(gemm, "torch") > 0 and calls == []
    assert advisor.default_probe(gemm, "pallas") > 0
    assert calls == [(32, 16)]
    # no config: the registry's route at K1's key
    key = autotune.device_key_for(32, 8, 16, torch.float32, torch.float32)
    autotune.record("matmul_impl", key, "pallas")
    advisor.default_probe(gemm)
    assert len(calls) == 2
    ring = advisor.TuningAction(
        kind="dispatch", kernel="matmul_impl_dist", key=DISPATCH_KEY,
        current=None, proposed="ring_ag", finding="dispatch_delta",
        evidence={}, probe={"op": "matmul.ring_ag", "shape": [64, 32, 16],
                            "dtype": "torch.float32", "ranks": 4})
    seen = []
    monkeypatch.setattr(linalg, "_ring_ag_gemm",
                        lambda *a, _r=linalg._ring_ag_gemm:
                        seen.append(1) or _r(*a))
    advisor.default_probe(ring)
    assert seen == []
    autotune.record("matmul_impl_dist", autotune.device_key_for(
        64, 16, 32, 4, torch.float32, torch.float32), "ring_ag")
    advisor.default_probe(ring)
    assert seen == [1]
    # JAX's rdma_chunks action has no probe: no knob of the port reads it
    with pytest.raises(ValueError, match="no port knob"):
        advisor.default_probe(_chunk_action())
    assert tdat.live_ids() == []
