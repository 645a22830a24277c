"""Pytest fixture for telemetry-aware tests.

The port's copy of ``distributedarrays_tpu/telemetry/fixtures.py``.

Import into a ``conftest.py`` (or straight into a test module)::

    from distributedarrays_tpu_torch.telemetry.fixtures import telemetry_capture

``telemetry_capture`` gives the test a clean, ENABLED telemetry state
with a tmp-dir journal, and restores the process's prior state (enabled
flag + journal path) afterwards — so telemetry tests cannot leak
configuration into the rest of the suite, and the rest of the suite
cannot pollute a telemetry assertion.

The yielded object proxies the ``telemetry`` module facade and adds
span-coverage helpers, so an op test can assert instrumentation without
parsing the journal::

    def test_my_op_is_traced(telemetry_capture):
        my_op(...)
        telemetry_capture.assert_span("my_op")
        assert telemetry_capture.spans("my_op")[0]["bytes"] > 0
"""

from __future__ import annotations

import pytest

from . import core, memory, tracing


class TelemetryCapture:
    """Module facade plus test-assertion helpers.  Every ``telemetry``
    attribute (``count``, ``events``, ``report``, ...) resolves through
    the proxy unchanged."""

    def __init__(self, module):
        self._module = module

    def __getattr__(self, name):
        return getattr(self._module, name)

    def spans(self, name: str | None = None) -> list[dict]:
        """Finished spans (optionally filtered by name) — see
        ``tracing.spans``."""
        return tracing.spans(name)

    def assert_span(self, name: str, min_count: int = 1) -> list[dict]:
        """Assert at least ``min_count`` spans named ``name`` finished;
        returns the buffered ones (aggregate-only spans count but carry
        no buffered dicts).  Counts come from ``span_stats`` so neither
        buffer eviction nor ``_journal=False`` can hide real coverage;
        the failure message lists what DID run, so a renamed phase is a
        one-glance fix."""
        stats = tracing.span_stats()
        got = stats.get(name, {}).get("count", 0)
        if got < min_count:
            raise AssertionError(
                f"expected >= {min_count} span(s) named {name!r}, "
                f"got {got}; finished span names: {sorted(stats)}")
        return tracing.spans(name)

    def assert_counter(self, name: str, min_count: float = 1,
                       **labels) -> float:
        """Assert counter ``name`` (with optional labels) reached at
        least ``min_count``; returns the observed value.  The failure
        message lists the recorded counter keys, so a renamed metric is
        a one-glance fix — replaces hand-rolled ``counter_value``
        polling in tests."""
        got = core.counter_value(name, **labels)
        if got < min_count:
            with core._LOCK:
                keys = sorted(core._counters)
            raise AssertionError(
                f"expected counter {core._key(name, labels)!r} >= "
                f"{min_count}, got {got}; recorded counters: {keys}")
        return got

    def mem(self) -> dict:
        """Snapshot of the HBM ledger (the ``memory`` report section)."""
        return memory.snapshot()


@pytest.fixture
def telemetry_capture(tmp_path):
    """Clean enabled telemetry with a journal at ``tmp_path/journal.jsonl``.

    Yields a :class:`TelemetryCapture` proxying the ``telemetry`` module
    facade (plus ``spans()`` / ``assert_span()``); the journal path is
    ``telemetry.journal_path()``.
    """
    from . import stream
    prev_enabled = core.enabled()
    prev_path = core.journal_path()
    # stream._reset joins the exporter thread, which may itself be
    # waiting on core._LOCK — so it must run OUTSIDE core.reset's hook
    # list (reset hooks run under the lock), here in plain teardown
    stream._reset()
    core.reset()
    core.configure(str(tmp_path / "journal.jsonl"))
    core.enable()
    try:
        from distributedarrays_tpu_torch import telemetry
        yield TelemetryCapture(telemetry)
    finally:
        stream._reset()
        core.reset()
        core.configure(prev_path)
        if prev_enabled:
            core.enable()
        else:
            core.disable()
