"""Framework-wide telemetry: counters, communication byte accounting, spans,
a structured event journal and the postmortem flight recorder.

PyTorch counterpart of ``distributedarrays_tpu/telemetry`` (its
``__init__.py:38-62``), with the pieces ported so far: ``core``,
``tracing``, ``flight``, ``memory`` (the device memory ledger), the cost
stamps of ``perf`` and the serving calls of ``stream``.  Every
instrumented site of the port reports here under the JAX package's names
and labels::

    from distributedarrays_tpu_torch import telemetry

    telemetry.configure("run.jsonl")      # optional JSON-lines journal
    with telemetry.span("phase", step=i):
        ...                               # comm and events carry span_id
    print(telemetry.report())             # nested dict
    telemetry.dump("telemetry.json")

``DA_TPU_TELEMETRY=0`` (or :func:`disable`) turns every recording call into
one boolean check: no journal file is created and :func:`report` stays
empty.  Not ported yet (ROADMAP queue A): the peak table and doctor of
``perf``, ``summarize``, ``export``, ``regress``, ``cluster``, ``alerts``,
``advisor``, ``stream``'s exporter and ``agg``.
"""

from .core import (begin_incident, comm_bytes, configure, count,
                   counter_value, current_incident, disable, dump, enable,
                   enabled, end_incident, event, events, gauge_value,
                   journal_path, nbytes_of, observe, record_comm, report,
                   reset, set_gauge)
from .tracing import (Span, annotate, bind_trace_ids, current_span,
                      current_span_id, current_trace_ids, open_spans,
                      record_external_span, span, span_stats, spans,
                      trace_ctx, traced)
from . import core, flight, memory, perf, stream, tracing
from .flight import postmortem, record_crash
from .memory import leak_census

__all__ = [
    "enabled", "enable", "disable", "configure", "reset", "count",
    "set_gauge", "observe", "event", "record_comm", "counter_value",
    "gauge_value", "comm_bytes", "events", "journal_path", "nbytes_of",
    "report", "dump", "begin_incident", "current_incident", "end_incident",
    "Span", "span", "traced", "current_span", "current_span_id", "spans",
    "span_stats", "open_spans", "annotate", "trace_ctx",
    "current_trace_ids", "bind_trace_ids", "record_external_span",
    "core", "tracing", "flight", "memory", "perf", "stream",
    "leak_census", "postmortem", "record_crash",
]
