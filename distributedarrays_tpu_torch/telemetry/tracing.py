"""Hierarchical span tracing: where time and bytes go.

PyTorch counterpart of ``distributedarrays_tpu/telemetry/tracing.py`` (its
whole ``__all__``), the same stdlib code.  A span is a named, labeled
interval with a ``span_id``/``parent_id`` pair; spans nest through a
contextvar, so every :func:`core.event` and :func:`core.record_comm` made
while a span is open carries its ``span_id``, and comm bytes roll up into
it.

- :class:`span` (``with span("reshard", op=...):``) and :func:`traced`
  (the decorator form); :func:`annotate` adds labels to the innermost open
  span; :class:`trace_ctx` / :func:`bind_trace_ids` carry request trace
  ids, :func:`record_external_span` records an interval measured
  elsewhere (a forked SPMD rank's step).
- Start times share the journal's monotonic origin (``core._T0``).
- Disabled telemetry: entering a span is one boolean check.

Spans are host intervals: the host wall clock around the call, as in JAX.
A span never synchronizes the device, so around asynchronous CUDA launches
it measures the host's issue time, not the kernels' run time (a sync per
span would change the launch pattern it observes); the device time of a
phase comes from CUDA events or the profiler.

Finished spans land in a bounded buffer (:func:`spans`), per-name
aggregates (:func:`span_stats`: count, total, self time, own and child
bytes), one ``span`` journal event each (``_journal=False`` keeps a
high-frequency span aggregate-only), and the ``"spans"`` section of
:func:`core.report`.
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
from collections import deque

from . import core

__all__ = ["Span", "span", "traced", "current_span", "current_span_id",
           "spans", "span_stats", "open_spans", "annotate", "trace_ctx",
           "current_trace_ids", "bind_trace_ids", "record_external_span"]

_SPAN_BUFFER_MAX = 8192
_ids = itertools.count(1)        # CPython-atomic; no lock needed
_finished: deque = deque(maxlen=_SPAN_BUFFER_MAX)
_finished_total = 0
# name -> {count, total_s, self_s, bytes, child_bytes}
_stats: dict[str, dict] = {}
# span_id -> Span, for every span currently OPEN on any thread — the
# flight recorder's "what was in progress when we crashed" snapshot
_open: dict[int, "Span"] = {}


class Span:
    """One open (then finished) traced interval.  Created by :class:`span`
    — not directly.  ``bytes`` accumulates every ``record_comm`` issued
    while this span is innermost; ``child_s``/``child_bytes`` roll up
    from directly nested spans as they finish."""

    __slots__ = ("name", "labels", "span_id", "parent_id", "parent",
                 "start", "_t0", "dur", "bytes", "child_s", "child_bytes",
                 "tid", "tname", "journaled", "trace")

    def __init__(self, name: str, labels: dict, parent: "Span | None",
                 journaled: bool = True):
        self.name = name
        self.labels = labels
        # request-scoped trace ids: every span opened while a trace
        # context is set carries them — submit-to-resolve journeys
        # reconstruct from the journal (and export as Perfetto flows)
        self.trace = core._TRACE_CTX.get()
        self.span_id = next(_ids)
        self.parent = parent
        self.parent_id = parent.span_id if parent is not None else None
        self.journaled = journaled
        self._t0 = time.monotonic()
        self.start = self._t0 - core._T0
        self.dur = None           # None while open
        self.bytes = 0
        self.child_s = 0.0
        self.child_bytes = 0
        t = threading.current_thread()
        self.tid = t.ident or 0
        self.tname = t.name

    @property
    def self_s(self) -> float:
        return (self.dur or 0.0) - self.child_s

    def to_dict(self) -> dict:
        d = {"name": self.name, "span_id": self.span_id,
             "parent_id": self.parent_id,
             "start": round(self.start, 6),
             "dur": round(self.dur, 6) if self.dur is not None else None,
             "bytes": self.bytes, "child_bytes": self.child_bytes,
             "tid": self.tid, "tname": self.tname}
        if self.labels:
            d["labels"] = dict(self.labels)
        if self.trace:
            d["trace_id"] = list(self.trace)
        return d

    def __repr__(self):
        state = f"dur={self.dur:.6f}s" if self.dur is not None else "open"
        return f"<Span {self.name!r} id={self.span_id} {state}>"


class span:
    """Context manager opening a :class:`Span` named ``name`` with
    ``labels``.  Yields the Span (or ``None`` when telemetry is
    disabled).  ``_journal=False`` makes the span aggregate-only: it
    updates :func:`span_stats` (and parent rollups) but skips BOTH the
    journal and the bounded :func:`spans` buffer — for phases that fire
    thousands of times per run (e.g. the SPMD mailbox drain), which
    would otherwise evict every other span from the buffer."""

    __slots__ = ("_name", "_labels", "_journal", "_sp", "_tok")

    def __init__(self, name: str, _journal: bool = True, **labels):
        self._name = name
        self._labels = labels
        self._journal = _journal
        self._sp = None

    def __enter__(self):
        if not core._ENABLED:        # the single-boolean disabled path
            return None
        parent = core._CURRENT_SPAN.get()
        sp = Span(self._name, self._labels, parent, self._journal)
        self._tok = core._CURRENT_SPAN.set(sp)
        self._sp = sp
        with core._LOCK:
            _open[sp.span_id] = sp
        return sp

    def __exit__(self, exc_type, exc, tb):
        sp = self._sp
        if sp is None:
            return False
        self._sp = None
        core._CURRENT_SPAN.reset(self._tok)
        _finish(sp, self._journal, error=exc_type is not None)
        return False


def _finish(sp: Span, journal: bool, error: bool = False) -> None:
    global _finished_total
    sp.dur = time.monotonic() - sp._t0
    with core._LOCK:
        _open.pop(sp.span_id, None)
        parent = sp.parent
        if parent is not None and parent.dur is None:
            # parent still open on this stack: roll this span's time and
            # byte totals (own + descendants) up one level
            parent.child_s += sp.dur
            parent.child_bytes += sp.bytes + sp.child_bytes
        if journal:
            _finished.append(sp.to_dict())
        _finished_total += 1
        st = _stats.get(sp.name)
        if st is None:
            _stats[sp.name] = {"count": 1, "total_s": sp.dur,
                               "self_s": sp.self_s, "bytes": sp.bytes,
                               "child_bytes": sp.child_bytes}
        else:
            st["count"] += 1
            st["total_s"] += sp.dur
            st["self_s"] += sp.self_s
            st["bytes"] += sp.bytes
            st["child_bytes"] += sp.child_bytes
    if journal:
        # the journal only sees journaled spans, so its parent link must
        # skip aggregate-only ancestors or offline tools dangle; bytes
        # carry the child rollup too — descendant comm may have landed on
        # aggregate-only children that never reach the journal
        parent = sp.parent
        while parent is not None and not parent.journaled:
            parent = parent.parent
        fields = {"span_id": sp.span_id,
                  "parent_id": parent.span_id if parent is not None else None,
                  "start": round(sp.start, 6), "dur": round(sp.dur, 6),
                  "bytes": sp.bytes, "child_bytes": sp.child_bytes,
                  "tid": sp.tid, "tname": sp.tname}
        if sp.labels:
            fields["labels"] = sp.labels
        if sp.trace:
            fields["trace_id"] = list(sp.trace)
        if error:
            fields["error"] = True
        core.event("span", sp.name, **fields)


def traced(fn=None, *, name: str | None = None, _journal: bool = True,
           **labels):
    """Decorator running the function body inside a span.

    Bare (``@traced``) the span is named after the function's qualname;
    ``@traced(name="matmul", grid="2x2")`` overrides name and attaches
    labels.  Disabled telemetry short-circuits to a direct call.
    """
    def deco(f):
        sname = name or f.__qualname__

        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            if not core._ENABLED:
                return f(*args, **kwargs)
            with span(sname, _journal=_journal, **labels):
                return f(*args, **kwargs)
        return wrapper
    if fn is not None:
        return deco(fn)
    return deco


def current_span() -> Span | None:
    """The innermost open span on this thread/context, or None."""
    return core._CURRENT_SPAN.get()


def annotate(**labels) -> None:
    """Merge ``labels`` into the innermost open span — for call sites
    whose interesting labels (shapes, analytic cost stamps) only exist
    after the span opened (e.g. a ``@traced`` function that derives its
    operand shapes in its body).  No-op when telemetry is disabled or no
    span is open."""
    if not core._ENABLED:
        return
    sp = core._CURRENT_SPAN.get()
    if sp is None:
        return
    with core._LOCK:
        # fresh dict: the span CM may share its labels dict across
        # re-entries of the same context-manager object
        sp.labels = {**sp.labels, **labels}


class trace_ctx:
    """Context manager binding one or more request trace ids to the
    current context: every span opened (and journal event recorded)
    inside carries them.  Nesting unions the ids (a batch dispatch holds
    every member request's id).  Single boolean check when disabled."""

    __slots__ = ("_ids", "_tok")

    def __init__(self, *ids):
        self._ids = tuple(str(i) for i in ids if i)
        self._tok = None

    def __enter__(self):
        if not core._ENABLED or not self._ids:
            return None
        cur = core._TRACE_CTX.get() or ()
        merged = cur + tuple(i for i in self._ids if i not in cur)
        self._tok = core._TRACE_CTX.set(merged)
        return merged

    def __exit__(self, exc_type, exc, tb):
        if self._tok is not None:
            core._TRACE_CTX.reset(self._tok)
            self._tok = None
        return False


def current_trace_ids() -> tuple:
    """The trace ids bound to the current context (empty tuple when
    none) — capture these before handing work to another thread and
    rebind there with :class:`trace_ctx` or :func:`bind_trace_ids`
    (contextvars do not cross thread starts)."""
    return core._TRACE_CTX.get() or ()


def bind_trace_ids(ids) -> None:
    """Bind ``ids`` to THIS context with no reset token — for the entry
    point of a worker thread whose context dies with it (SPMD rank
    tasks).  Use :class:`trace_ctx` anywhere the context outlives the
    work."""
    if ids and core._ENABLED:
        core._TRACE_CTX.set(tuple(str(i) for i in ids))


def record_external_span(name: str, start: float, dur: float, *,
                         labels: dict | None = None, tid: int = 0,
                         tname: str = "", error: bool = False) -> None:
    """Record a span measured OUTSIDE this process's tracing machinery —
    e.g. a forked SPMD rank child measures its own step and ships the
    interval home; the parent records it here so both backends produce
    rank-labeled ``spmd.step`` spans.  ``start`` is seconds relative to
    the telemetry origin (``core._T0`` — inherited across fork), ``dur``
    in seconds.  Stamped with the caller's trace context."""
    global _finished_total
    if not core._ENABLED:
        return
    # a root span, like the thread backend's rank steps (fresh threads
    # have no contextvar parent): concurrent rank durations must not
    # roll up into one parent's child time and drive its self time
    # negative
    sp = Span(name, dict(labels or {}), None)
    sp.start = float(start)
    sp.dur = float(dur)
    if tid:
        sp.tid = tid
    if tname:
        sp.tname = tname
    with core._LOCK:
        _finished.append(sp.to_dict())
        _finished_total += 1
        st = _stats.get(sp.name)
        if st is None:
            _stats[sp.name] = {"count": 1, "total_s": sp.dur,
                               "self_s": sp.dur, "bytes": 0,
                               "child_bytes": 0}
        else:
            st["count"] += 1
            st["total_s"] += sp.dur
            st["self_s"] += sp.dur
    fields = {"span_id": sp.span_id, "parent_id": sp.parent_id,
              "start": round(sp.start, 6), "dur": round(sp.dur, 6),
              "bytes": 0, "child_bytes": 0, "tid": sp.tid,
              "tname": sp.tname}
    if sp.labels:
        fields["labels"] = sp.labels
    if sp.trace:
        fields["trace_id"] = list(sp.trace)
    if error:
        fields["error"] = True
    core.event("span", sp.name, **fields)


def current_span_id() -> int | None:
    sp = core._CURRENT_SPAN.get()
    return sp.span_id if sp is not None else None


def spans(name: str | None = None) -> list[dict]:
    """Snapshot of finished spans (most recent ``_SPAN_BUFFER_MAX``),
    optionally filtered by name.  Aggregate-only spans
    (``_journal=False``) are not buffered — see :func:`span_stats` for
    the complete per-name totals."""
    with core._LOCK:
        out = list(_finished)
    if name is None:
        return out
    return [s for s in out if s["name"] == name]


def open_spans() -> list[dict]:
    """Every span currently open on any thread (oldest first) — the
    flight recorder's in-progress stack.  ``dur`` is None on each."""
    with core._LOCK:
        sps = sorted(_open.values(), key=lambda s: s.span_id)
        return [s.to_dict() for s in sps]


def span_stats() -> dict[str, dict]:
    """Per-name aggregates over every finished span: count, total wall
    time, self time (total minus directly-nested child time), own comm
    bytes, and rolled-up child bytes."""
    with core._LOCK:
        return {k: dict(v) for k, v in _stats.items()}


def _report_section(top_n: int = 10) -> dict:
    """The ``"spans"`` section of :func:`core.report`: per-name rollups
    plus top-N rankings by self-time and by total-time."""
    with core._LOCK:
        by_name = {k: dict(v) for k, v in _stats.items()}
        finished = _finished_total
    def _round(d):
        return {**d, "total_s": round(d["total_s"], 6),
                "self_s": round(d["self_s"], 6)}
    return {
        "finished": finished,
        "by_name": {k: _round(v) for k, v in sorted(by_name.items())},
        "top_by_self_s": [
            [k, round(v["self_s"], 6)] for k, v in sorted(
                by_name.items(), key=lambda kv: -kv[1]["self_s"])[:top_n]],
        "top_by_total_s": [
            [k, round(v["total_s"], 6)] for k, v in sorted(
                by_name.items(), key=lambda kv: -kv[1]["total_s"])[:top_n]],
    }


def _reset() -> None:
    global _finished_total
    with core._LOCK:
        _finished.clear()
        _stats.clear()
        _open.clear()
        _finished_total = 0


core.register_report_section("spans", _report_section)
core.register_reset_hook(_reset)
