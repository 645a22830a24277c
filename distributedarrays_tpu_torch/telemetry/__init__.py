"""Framework-wide telemetry: counters, communication byte accounting, spans,
a structured event journal, the postmortem flight recorder, the roofline
doctor, alerting and the live plane.

PyTorch counterpart of ``distributedarrays_tpu/telemetry`` (its
``__init__.py:38-90``): ``core``, ``tracing``, ``flight``, ``memory`` (the
device memory ledger), ``perf`` (the cost stamps, the peak table with the
H100's rates and the doctor), ``regress`` (the bench regression
sentinel), ``alerts`` (burn-rate rules and the health sampler),
``stream`` (the live exporter) and ``agg`` (its aggregator), the offline
readers ``summarize``, ``export`` and ``cluster`` (the per-process
journals of a multi-process run merged onto one timeline), the pytest
fixture ``fixtures.telemetry_capture`` and the command line
(``python -m distributedarrays_tpu_torch.telemetry``).  Every
instrumented site of the port reports here under the JAX package's names
and labels::

    from distributedarrays_tpu_torch import telemetry

    telemetry.configure("run.jsonl")      # optional JSON-lines journal
    with telemetry.span("phase", step=i):
        ...                               # comm and events carry span_id
    print(telemetry.report())             # nested dict
    telemetry.dump("telemetry.json")

    # offline: python -m distributedarrays_tpu_torch.telemetry doctor run.jsonl

``DA_TPU_TELEMETRY=0`` (or :func:`disable`) turns every recording call into
one boolean check: no journal file is created and :func:`report` stays
empty.  Importing the package arms the health sampler when
``DA_TPU_TELEMETRY_SAMPLE_S`` is set and the exporter when
``DA_TPU_STREAM_AGG`` is set, as JAX's does.  ``advisor`` (the command
line's ``advise``) maps the doctor's findings onto the port's own tuning
knobs.
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
from .summarize import format_summary, read_journal, summarize
from .export import to_perfetto, to_prometheus
from . import (advisor, agg, alerts, cluster, core, flight, memory, perf,
               regress, stream, tracing)
from .cluster import merge_journals, reconstruct_incidents
from .flight import postmortem, record_crash
from .memory import leak_census
from .alerts import (AlertManager, AlertRule, default_rules, start_sampler,
                     stop_sampler)

__all__ = [
    "enabled", "enable", "disable", "configure", "reset", "count",
    "set_gauge", "observe", "event", "record_comm", "counter_value",
    "gauge_value", "comm_bytes", "events", "journal_path", "nbytes_of",
    "report", "dump", "begin_incident", "current_incident", "end_incident",
    "read_journal", "summarize", "format_summary",
    "Span", "span", "traced", "current_span", "current_span_id", "spans",
    "span_stats", "open_spans", "annotate", "trace_ctx",
    "current_trace_ids", "bind_trace_ids", "record_external_span",
    "to_perfetto", "to_prometheus",
    "memory", "flight", "perf", "regress", "tracing", "cluster", "alerts",
    "advisor", "stream", "agg",
    "leak_census", "postmortem", "record_crash",
    "merge_journals", "reconstruct_incidents",
    "AlertRule", "AlertManager", "default_rules",
    "start_sampler", "stop_sampler",
]

# arm the health sampler when DA_TPU_TELEMETRY_SAMPLE_S is set, and the
# live-plane exporter when DA_TPU_STREAM_AGG is set; no-ops otherwise or
# with telemetry disabled
alerts._maybe_autostart()
stream._maybe_autostart()
