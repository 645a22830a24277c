"""Exporters: the journal/registry in the two lingua-franca formats.

- :func:`to_perfetto` — Chrome trace-event JSON (open at ui.perfetto.dev
  or chrome://tracing): spans as complete ("X") slices, one track per
  recording thread; every other journal event (comm, fallback, autotune,
  ...) as a thread-scoped instant ("i") on the same timeline.
- :func:`to_prometheus` — the metrics registry (a :func:`core.report`
  dict) in Prometheus text exposition format, ``da_tpu_``-prefixed.

Both are pure functions over plain dicts (stdlib only), so a journal
pulled off a worker converts on any machine.  PyTorch counterpart of
``distributedarrays_tpu/telemetry/export.py`` (its whole ``__all__``),
kept as the port's own copy: the same journal or registry gives the same
trace and the same exposition text through either package, and the
Prometheus families keep JAX's ``da_tpu_`` names, so dashboards carry
over.
"""

from __future__ import annotations

import re

__all__ = ["to_perfetto", "to_prometheus"]

# journal bookkeeping keys that are not user "args" of an event
_EVENT_META = ("seq", "t", "wall", "cat", "name", "tid", "host", "pid")

# spans labeled rank=N render on synthetic per-rank tracks (tid = base +
# rank) instead of whatever thread happened to run them
_RANK_TRACK_BASE = 1 << 20


def _us(seconds) -> float:
    return round(float(seconds) * 1e6, 3)


def to_perfetto(events, spans=None, pid: int = 0) -> dict:
    """Convert journal ``events`` (list of dicts, e.g. from
    ``summarize.read_journal``) to a trace-event JSON dict.

    ``spans`` defaults to the events with category ``"span"`` (the
    journal mirror of every finished span); pass ``tracing.spans()``
    explicitly to include spans that skipped the journal.  Span ``ts``
    is the span *start*; all other events are instants at their record
    time — the shared monotonic origin makes the two line up.  Every
    entry carries ``ph/ts/dur/pid/tid`` so strict viewers need no
    defaulting.

    Events from more than one ``(host, pid)`` — a merged multihost
    journal (``cluster.merge_journals``) — render as separate process
    tracks: each recorder gets its own trace pid (``pid`` is the base)
    and a ``process_name`` metadata entry, so one trace shows the whole
    cluster with per-host timelines.
    """
    if spans is None:
        spans = [e for e in events if e.get("cat") == "span"]
    rest = [e for e in events if e.get("cat") != "span"]
    trace = []
    threads: dict[tuple[int, int], str] = {}
    procs: dict[tuple[str, int], int] = {}

    def _pid(e) -> int:
        key = (str(e.get("host", "")), int(e.get("pid") or 0))
        p = procs.get(key)
        if p is None:
            p = procs[key] = pid + len(procs)
        return p
    # request flows: spans carrying the same trace id chain together with
    # Chrome flow events (s/t/f), so a serve request's journey — submit,
    # batch dispatch, retries, rank steps — draws as one arrowed path
    flows: dict[str, list] = {}
    for s in spans:
        if s.get("dur") is None:
            continue                       # still-open span snapshot
        spid = _pid(s)
        tid = int(s.get("tid") or 0)
        labels = s.get("labels") or {}
        rank = labels.get("rank")
        if rank is not None:
            # per-rank timelines get their own tracks: SPMD rank spans
            # would otherwise interleave on whatever thread/process tid
            # happened to run them (thread tids are reused across runs;
            # process-backend spans are recorded parent-side)
            try:
                tid = _RANK_TRACK_BASE + int(rank)
                threads.setdefault((spid, tid), f"rank {int(rank)}")
            except (TypeError, ValueError):
                pass
        elif s.get("tname"):
            threads.setdefault((spid, tid), str(s["tname"]))
        args = {k: s[k] for k in ("span_id", "parent_id", "bytes",
                                  "child_bytes", "trace_id")
                if s.get(k) is not None}
        args.update(labels)
        entry = {"name": str(s.get("name", "?")), "cat": "span",
                 "ph": "X", "ts": _us(s.get("start", 0.0)),
                 "dur": _us(s["dur"]), "pid": spid, "tid": tid,
                 "args": args}
        trace.append(entry)
        for t in (s.get("trace_id") or ()):
            flows.setdefault(str(t), []).append(entry)
    # counter-track state: each "C" event's args define ALL series values
    # at that timestamp, so the missing series must be carried forward or
    # the renderer drops its line to zero between samples (per process —
    # merged journals keep one HBM line per host)
    hbm_state: dict[int, list] = {}
    for e in rest:
        epid = _pid(e)
        tid = int(e.get("tid") or 0)
        cat = str(e.get("cat", "?"))
        name = e.get("name")
        args = {k: v for k, v in e.items()
                if k not in _EVENT_META and v is not None}
        if cat == "gauge" and e.get("value") is not None:
            # journaled gauges (serve queue depth, admission token
            # levels, elastic live devices, ...) reconstruct as counter
            # ("C") tracks — one track per gauge name + label set (the
            # span/trace stamps a gauge event happens to carry are
            # provenance, not series identity)
            cname = str(name or "gauge")
            labels = {k: v for k, v in args.items()
                      if k not in ("value", "span_id", "trace_id",
                                   "incident", "t_local")}
            if labels:
                cname += "{" + ",".join(
                    f"{k}={labels[k]}" for k in sorted(labels)) + "}"
            trace.append({"name": cname, "cat": "gauge", "ph": "C",
                          "ts": _us(e.get("t", 0.0)), "dur": 0,
                          "pid": epid, "tid": 0,
                          "args": {"value": e["value"]}})
            continue
        trace.append({"name": f"{cat}/{name}" if name is not None else cat,
                      "cat": cat, "ph": "i", "s": "t",
                      "ts": _us(e.get("t", 0.0)), "dur": 0,
                      "pid": epid, "tid": tid, "args": args})
        if cat == "hbm":
            # counter ("C") track: the HBM ledger as a line under the
            # span timeline — ledger live bytes and transient staging
            # are two series on one counter
            if e.get("live") is not None or \
                    e.get("staging_live") is not None:
                state = hbm_state.setdefault(epid, [0, 0])
                if e.get("live") is not None:
                    state[0] = e["live"]
                if e.get("staging_live") is not None:
                    state[1] = e["staging_live"]
                trace.append({"name": "hbm_bytes", "cat": "hbm",
                              "ph": "C", "ts": _us(e.get("t", 0.0)),
                              "dur": 0, "pid": epid, "tid": 0,
                              "args": {"live": state[0],
                                       "staging": state[1]}})
    for flow_n, (tid_key, entries) in enumerate(sorted(flows.items())):
        if len(entries) < 2:
            continue                  # a flow needs two ends
        entries.sort(key=lambda e: e["ts"])
        for i, entry in enumerate(entries):
            ph = "s" if i == 0 else ("f" if i == len(entries) - 1 else "t")
            ev = {"name": "request", "cat": "trace", "ph": ph,
                  "id": flow_n + 1, "ts": entry["ts"], "dur": 0,
                  "pid": entry["pid"], "tid": entry["tid"],
                  "args": {"trace_id": tid_key}}
            if ph == "f":
                ev["bp"] = "e"        # bind the finish to the slice start
            trace.append(ev)
    for (tpid, tid), tname in sorted(threads.items()):
        trace.append({"name": "thread_name", "ph": "M", "ts": 0, "dur": 0,
                      "pid": tpid, "tid": tid, "args": {"name": tname}})
    if len(procs) > 1:
        # merged multihost journal: name each process track after its
        # recorder so the per-host timelines are identifiable in the UI
        for (host, opid), tpid in sorted(procs.items(),
                                         key=lambda kv: kv[1]):
            trace.append({"name": "process_name", "ph": "M", "ts": 0,
                          "dur": 0, "pid": tpid, "tid": 0,
                          "args": {"name": f"{host or 'host'}:{opid}"}})
    return {"traceEvents": trace, "displayTimeUnit": "ms"}


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------


# DOTALL: a label VALUE may contain a literal newline (core._key does
# not escape), and a non-matching key would leak the raw newline into
# the metric name and the HELP line — invalid exposition
_KEY_RE = re.compile(r"^(?P<name>[^{]+)(?:\{(?P<labels>.*)\})?$",
                     re.DOTALL)


# label-list splitter: core._key joins "k=v" pairs with "," WITHOUT
# escaping values, so a value may itself contain commas (e.g. fallback
# keys built from tuple reprs: "dfft-host-(2, 2)-...").  Split only on
# commas that start a new "ident=" pair; other commas stay in the value.
_LABEL_SEP_RE = re.compile(r",(?=[a-zA-Z_][a-zA-Z0-9_.]*=)")


def _split_key(key: str) -> tuple[str, dict]:
    """Invert core._key: ``name{k=v,...}`` -> (name, labels)."""
    m = _KEY_RE.match(key)
    if m is None:
        return key, {}
    labels = {}
    raw = m.group("labels")
    if raw:
        for part in _LABEL_SEP_RE.split(raw):
            k, _, v = part.partition("=")
            labels[k] = v
    return m.group("name"), labels


def _metric_name(name: str) -> str:
    return "da_tpu_" + re.sub(r"[^a-zA-Z0-9_:]", "_", name)


def _esc(v) -> str:
    return (str(v).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _labels_str(labels: dict) -> str:
    if not labels:
        return ""
    return ("{" + ",".join(f'{re.sub(r"[^a-zA-Z0-9_]", "_", k)}="{_esc(v)}"'
                           for k, v in sorted(labels.items())) + "}")


def _num(v) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


class _Family:
    def __init__(self, name: str, mtype: str, help_: str):
        self.name, self.mtype, self.help = name, mtype, help_
        self.samples: list[tuple[str, dict, float]] = []

    def add(self, labels: dict, value, suffix: str = ""):
        self.samples.append((suffix, labels, value))

    def lines(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} {self.mtype}"]
        for suffix, labels, value in self.samples:
            out.append(f"{self.name}{suffix}{_labels_str(labels)} "
                       f"{_num(value)}")
        return out


def to_prometheus(registry: dict | None = None) -> str:
    """Render a :func:`core.report` dict (default: the live registry) in
    Prometheus text exposition format.

    Counters become ``da_tpu_<name>_total``, gauges ``da_tpu_<name>``,
    histograms summaries (``_count``/``_sum`` plus ``_min``/``_max``
    gauges); comm accounting and span aggregates get dedicated families
    labeled by kind/span name.  Label sets round-trip from the
    registry's ``name{k=v,...}`` keys.
    """
    if registry is None:
        from . import core
        registry = core.report()
    fams: dict[str, _Family] = {}

    def fam(name, mtype, help_):
        f = fams.get(name)
        if f is None:
            f = fams[name] = _Family(name, mtype, help_)
        return f

    for key, value in sorted(registry.get("counters", {}).items()):
        name, labels = _split_key(key)
        fam(_metric_name(name) + "_total", "counter",
            f"counter {name}").add(labels, value)
    for key, value in sorted(registry.get("gauges", {}).items()):
        name, labels = _split_key(key)
        fam(_metric_name(name), "gauge", f"gauge {name}").add(labels, value)
    for key, h in sorted(registry.get("histograms", {}).items()):
        name, labels = _split_key(key)
        base = _metric_name(name)
        if "buckets" in h:
            # bucketed entry (core.observe(..., buckets=...)): a real
            # Prometheus histogram — cumulative le series + count/sum.
            # The serving SLO families (da_tpu_serve_slo_*) land here.
            f = fam(base, "histogram", f"histogram {name}")
            bounds = sorted(float(b) for b in h.get(
                "bounds", [float(k) for k in h["buckets"] if k != "+Inf"]))
            cum = 0
            for b in bounds:
                cum += int(h["buckets"].get(str(float(b)), 0))
                f.add({**labels, "le": f"{b:g}"}, cum, "_bucket")
            f.add({**labels, "le": "+Inf"}, h.get("count", 0), "_bucket")
            f.add(labels, h.get("count", 0), "_count")
            f.add(labels, h.get("total", 0.0), "_sum")
            continue
        f = fam(base, "summary", f"summary {name}")
        f.add(labels, h.get("count", 0), "_count")
        f.add(labels, h.get("total", 0.0), "_sum")
        fam(base + "_min", "gauge", f"min of {name}").add(
            labels, h.get("min", 0.0))
        fam(base + "_max", "gauge", f"max of {name}").add(
            labels, h.get("max", 0.0))
    comm = registry.get("comm", {})
    for kind, c in sorted(comm.get("by_kind", {}).items()):
        fam("da_tpu_comm_ops_total", "counter",
            "communication operations by kind").add({"kind": kind},
                                                    c.get("ops", 0))
        fam("da_tpu_comm_bytes_total", "counter",
            "estimated communication bytes by kind").add({"kind": kind},
                                                         c.get("bytes", 0))
    for sname, st in sorted(registry.get("spans", {})
                            .get("by_name", {}).items()):
        lbl = {"span": sname}
        fam("da_tpu_span_count_total", "counter",
            "finished spans by name").add(lbl, st.get("count", 0))
        fam("da_tpu_span_seconds_total", "counter",
            "total span wall seconds by name").add(lbl, st.get("total_s", 0))
        fam("da_tpu_span_self_seconds_total", "counter",
            "span self (minus children) seconds by name").add(
                lbl, st.get("self_s", 0))
        fam("da_tpu_span_bytes_total", "counter",
            "comm bytes attributed to spans by name").add(
                lbl, st.get("bytes", 0))
    mem = registry.get("memory", {})
    if mem:
        fam("da_tpu_hbm_live_bytes", "gauge",
            "HBM ledger live bytes").add({"device": "all"},
                                         mem.get("live_bytes", 0))
        fam("da_tpu_hbm_peak_bytes", "gauge",
            "HBM ledger peak bytes").add({"device": "all"},
                                         mem.get("peak_bytes", 0))
        for dev, d in sorted(mem.get("by_device", {}).items()):
            fam("da_tpu_hbm_live_bytes", "gauge",
                "HBM ledger live bytes").add({"device": dev},
                                             d.get("live_bytes", 0))
            fam("da_tpu_hbm_peak_bytes", "gauge",
                "HBM ledger peak bytes").add({"device": dev},
                                             d.get("peak_bytes", 0))
        fam("da_tpu_hbm_tracked_arrays", "gauge",
            "arrays tracked by the HBM ledger").add(
                {}, mem.get("tracked_arrays", 0))
        st = mem.get("staging", {})
        fam("da_tpu_hbm_staging_peak_bytes", "gauge",
            "peak transient staging bytes").add(
                {"tag": "all"}, st.get("peak_bytes", 0))
        for tag, v in sorted(st.get("peak_by_tag", {}).items()):
            fam("da_tpu_hbm_staging_peak_bytes", "gauge",
                "peak transient staging bytes").add({"tag": tag}, v)
    ev = registry.get("events", {})
    if ev:
        fam("da_tpu_events_recorded_total", "counter",
            "journal events recorded").add({}, ev.get("recorded", 0))
    lines: list[str] = []
    for name in sorted(fams):
        lines.extend(fams[name].lines())
    return "\n".join(lines) + "\n" if lines else ""
