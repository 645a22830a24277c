"""The port's ``telemetry/regress.py``, ``alerts.py``, ``stream.py``,
``agg.py``, ``fixtures.py`` and package exports against the JAX
package's.

- ``regress.compare`` gives equal verdicts (and ``format_results`` the
  same text) on the same series, ``load_rows``/``load_baseline`` the same
  rows from the same files.
- ``AlertManager`` fires and clears the same alerts, with the same burn
  rates, on the same gauge sequence; ``default_rules`` builds the same
  rules; the health sampler starts and stops.
- The port's exporter's frames are accepted by JAX's ``Aggregator``, and
  JAX's by the port's, through each package's HTTP server.
- ``parallel.multihost.advertise_exporter`` registers an armed exporter
  in the job's store.
- ``distributedarrays_tpu_torch.telemetry`` exports JAX's names,
  ``advisor`` included.

Every thread and server a test starts is stopped by its end (both
packages' exporters, samplers and aggregators).
"""

import io
import json
import time
import types

import pytest

from distributedarrays_tpu import telemetry as JT
from distributedarrays_tpu.telemetry import agg as JA
from distributedarrays_tpu.telemetry import alerts as JAL
from distributedarrays_tpu.telemetry import regress as JR
from distributedarrays_tpu.telemetry import stream as JS

from distributedarrays_tpu_torch import telemetry as TT
from distributedarrays_tpu_torch.parallel import multihost as TMH
from distributedarrays_tpu_torch.telemetry import agg as TA
from distributedarrays_tpu_torch.telemetry import alerts as TAL
from distributedarrays_tpu_torch.telemetry import regress as TR
from distributedarrays_tpu_torch.telemetry import stream as TS
from distributedarrays_tpu_torch.telemetry.fixtures import (  # noqa: F401
    telemetry_capture)

from _torch_port import jax_process_state  # noqa: F401


@pytest.fixture(autouse=True)
def _stop_live_plane():
    """Both packages' exporters and samplers stopped, and their default
    alert managers reset, after every test."""
    yield
    for stream, alerts in ((JS, JAL), (TS, TAL)):
        stream._reset()
        alerts.stop_sampler()
        alerts.default_manager().reset()


def test_exports_are_jax_names():
    assert sorted(TT.__all__) == sorted(JT.__all__)
    for name in TT.__all__:
        assert getattr(TT, name) is not None, name
    assert TT.advisor.__name__ == "distributedarrays_tpu_torch.telemetry.advisor"
    assert sorted(TT.advisor.__all__) == sorted(
        JT.advisor.__all__ + ["GEMM_ROUTES", "NO_PORT_KNOB"])


# ---------------------------------------------------------------------------
# regress
# ---------------------------------------------------------------------------


SERIES = {
    "step_s": [1.00, 1.02, 0.99, 1.01, 1.03],
    "train_tokens_per_s": [900.0, 910.0, 905.0],
    "decode_p99_s": [0.2, 0.21],
    "gemm_gflops": [50.0, 52.0, 51.0, 49.5],
    "mystery_metric": [1.0, 2.0, 3.0],
}
FRESH = {"step_s": 1.4, "train_tokens_per_s": 950.0, "decode_p99_s": 0.4,
         "gemm_gflops": 50.5, "mystery_metric": 9.0, "unbanked_s": 3.0}


@pytest.mark.parametrize("kw", [{}, {"mad_k": 1.0}, {"rel_floor": 0.5},
                                {"min_points": 2}])
def test_regress_verdicts_match_jax(kw):
    want = JR.compare(dict(FRESH), {k: list(v) for k, v in SERIES.items()},
                      **kw)
    got = TR.compare(dict(FRESH), {k: list(v) for k, v in SERIES.items()},
                     **kw)
    assert got == want
    assert {r["status"] for r in got} >= {"regression", "ok"}
    for explain in (False, True):
        a, b = io.StringIO(), io.StringIO()
        JR.format_results(want, a, explain=explain)
        TR.format_results(got, b, explain=explain)
        assert b.getvalue() == a.getvalue()


def test_regress_reads_the_same_rows(tmp_path):
    for i, v in enumerate((1.0, 1.1, 0.9)):
        (tmp_path / f"BENCH_r{i:02d}.json").write_text(json.dumps(
            {"parsed": {"metric": "step_s", "value": v}}))
    (tmp_path / "BENCH_DETAILS.json").write_text(json.dumps(
        {"gemm_gflops": 12.5, "note": "text"}))
    row = tmp_path / "row.json"
    row.write_text(json.dumps({"metric": "step_s", "value": 2.0,
                               "replayed": True}))
    for path in (str(tmp_path / "BENCH_r01.json"),
                 str(tmp_path / "BENCH_DETAILS.json"), str(row)):
        assert TR.load_rows(path) == JR.load_rows(path)
    paths = [str(tmp_path), str(tmp_path / "BENCH_DETAILS.json")]
    assert TR.load_baseline(paths) == JR.load_baseline(paths)


# ---------------------------------------------------------------------------
# alerts
# ---------------------------------------------------------------------------


GAUGES = [2.0, 2.0, 0.01, 0.01, 3.0, None, 0.2, 0.01, 0.01, 0.01]


def _alert_run(pkg) -> list:
    core = pkg.core
    rules = [pkg.alerts.AlertRule(
        "serve_p99", lambda: core.gauge_value("serve.request_p99_s"),
        threshold=0.5, fast_window_s=1.0, slow_window_s=4.0),
        pkg.alerts.AlertRule(
            "live_devices", lambda: core.gauge_value("elastic.live_devices"),
            threshold=6, op="<", fast_window_s=1.0, slow_window_s=2.0)]
    mgr = pkg.alerts.AlertManager(rules)
    states = []
    for i, g in enumerate(GAUGES):
        if g is not None:
            core.set_gauge("serve.request_p99_s", g)
            core.set_gauge("elastic.live_devices", 8 if g < 1 else 4)
        states.append(mgr.evaluate(now=10.0 + 0.4 * i))
    evs = [{k: e[k] for k in ("name", "state", "burn_fast", "burn_slow")
            if k in e} for e in core.events("alert")]
    return states, evs, mgr.firing(), core.gauge_value(
        "alert.active", alert="serve_p99")


def test_alert_manager_fires_what_jax_fires(telemetry_capture):
    JT.core.reset()
    JT.core.enable()
    want = _alert_run(JT)
    got = _alert_run(TT)
    assert got == want
    assert any(s["serve_p99"] for s in got[0])
    assert [e["state"] for e in got[1]].count("firing") >= 2


def test_default_rules_match_jax():
    kw = dict(step_time_slo_s=1.0, hbm_budget_bytes=1 << 30,
              min_live_devices=6)
    for args in ({}, kw):
        want, got = JAL.default_rules(**args), TAL.default_rules(**args)
        assert [(r.name, r.threshold, r.op, r.fast_window_s,
                 r.slow_window_s) for r in got] == \
            [(r.name, r.threshold, r.op, r.fast_window_s,
              r.slow_window_s) for r in want]
    rule = TAL.ensure_autotune_rule()
    assert rule is TAL.ensure_autotune_rule()
    assert rule.name == "autotune_regressed"


def test_health_sampler_starts_ticks_and_stops(telemetry_capture,
                                               monkeypatch):
    monkeypatch.delenv(TAL.SAMPLE_ENV, raising=False)
    assert TAL.start_sampler() is False          # no interval: stays off
    assert TAL.start_sampler(0.05) is True
    assert TAL.start_sampler(0.05) is True and TAL.sampler_running()
    deadline = time.monotonic() + 5
    while telemetry_capture.gauge_value("health.hbm_live_bytes") is None:
        assert time.monotonic() < deadline, "the sampler never ticked"
        time.sleep(0.02)
    TAL.stop_sampler()
    assert not TAL.sampler_running()


# ---------------------------------------------------------------------------
# the exporter and the aggregator, across the two packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_exporter_frames_cross_packages(direction, telemetry_capture):
    src, agg_mod = (TT, JA) if direction == "port_to_jax" else (JT, TA)
    JT.core.reset()
    JT.core.enable()
    with agg_mod.AggServer(port=0) as srv:
        exp = src.stream.StreamExporter(srv.url, interval_s=60.0,
                                        heartbeat_every=1)
        try:
            src.count("x.y", 3)
            src.set_gauge("elastic.live_devices", 8)
            src.event("soak", "one")
            with src.span("work"):
                pass
            exp.add_note("serve.request_p99_s", 0.012, {})
            exp.tick()
            src.count("x.y", 2)
            exp.tick()
        finally:
            exp.stop()
        agg = srv.agg
        assert agg.frames_ingested >= 2
        (hs,) = agg._states()
        assert hs.counters.get("x.y") == 5.0
        assert agg.gauge("elastic.live_devices") == 8.0
        assert agg.gauge("serve.request_p99_s") == 0.012
        names = [e.get("name") for e in agg.merged_events()]
        assert "one" in names and "work" in names
        snap = agg.snapshot()
        assert len(snap["hosts"]) == 1


def test_stream_start_arms_and_advertise_registers(telemetry_capture,
                                                   monkeypatch):
    # single process: nothing to register; in a job (a stand-in store),
    # an armed exporter is registered under dat/telemetry/exporter/<i>
    assert TMH.advertise_exporter() is False
    store = {}
    fake = types.SimpleNamespace(
        store=types.SimpleNamespace(set=store.__setitem__), index=1,
        count=2)
    monkeypatch.setattr(TMH, "_job", fake)
    assert TMH.advertise_exporter() is False      # not armed
    with TA.AggServer(port=0) as srv:
        exp = TS.start(srv.url, interval_s=0.05)
        assert exp is not None and TS.armed() and TS.start() is exp
        assert TMH.advertise_exporter() is True
        host, when = store["dat/telemetry/exporter/1"].split()
        assert ":" in host and float(when) > 0
        TS.note("serve.request_p99_s", 0.3)
        TS.poke()
        deadline = time.monotonic() + 5
        while srv.agg.gauge("serve.request_p99_s") is None:
            assert time.monotonic() < deadline, "no frame reached the agg"
            time.sleep(0.02)
        TS.stop()
    assert not TS.armed() and TS.stats() == {"armed": False}


def test_fixture_restores_the_journal(tmp_path):
    from distributedarrays_tpu_torch.telemetry import fixtures
    assert callable(fixtures.TelemetryCapture)
    prev = TT.journal_path()
    TT.configure(None)
    try:
        gen = fixtures.telemetry_capture.__wrapped__(tmp_path)
        cap = next(gen)
        assert TT.journal_path() == str(tmp_path / "journal.jsonl")
        with cap.span("probe"):
            pass
        cap.assert_span("probe")
        with pytest.raises(StopIteration):
            next(gen)
        assert TT.journal_path() is None
    finally:
        TT.configure(prev)
