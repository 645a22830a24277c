"""Telemetry core: the process-wide metrics registry and event journal.

PyTorch counterpart of ``distributedarrays_tpu/telemetry/core.py`` (its
whole ``__all__``), the same stdlib code with the same names, keys, labels
and journal schema, so one sequence of calls gives the same ``report()``
in both packages:

- **metrics registry**: thread-safe counters, gauges and summary
  histograms (optionally bucketed), keyed by name plus sorted labels.
  With telemetry disabled (``DA_TPU_TELEMETRY=0`` or :func:`disable`)
  every recording call is one boolean check and a return.
- **communication accounting**: :func:`record_comm` is the one funnel of
  every instrumented transfer (reshards, SPMD mailbox sends, ...): per-kind
  op and byte counters and one ``comm`` journal event.
- **event journal**: a bounded in-memory buffer of structured events with
  monotonic timestamps, mirrored to an append-only JSON-lines file when a
  path is configured (``DA_TPU_TELEMETRY_JOURNAL`` or :func:`configure`),
  opened on the first event and rotated to ``<path>.1`` at
  ``DA_TPU_TELEMETRY_JOURNAL_MAX_MB`` (64 by default).
- **incidents**: :func:`begin_incident` / :func:`end_incident` stamp every
  event of one failure episode with its id.

Byte numbers are payload estimates at the recording site.
:func:`nbytes_of` sizes torch tensors, numpy arrays, DArrays (the sum of
their rank tensors) and lists, tuples and dicts of them (summed; JAX's
sizes a container as 0).  The module imports nothing of the rest of the
package, so every layer can import it.
"""

from __future__ import annotations

import contextvars
import json
import os
import threading
import time
from collections import deque

__all__ = [
    "enabled", "enable", "disable", "configure", "reset",
    "count", "set_gauge", "observe", "event", "record_comm",
    "counter_value", "gauge_value", "comm_bytes", "events",
    "journal_path", "nbytes_of", "report", "dump",
    "register_report_section", "register_reset_hook",
    "begin_incident", "current_incident", "end_incident",
]

_FALSY = ("0", "false", "off", "no")


def _env_enabled() -> bool:
    v = os.environ.get("DA_TPU_TELEMETRY")
    return v is None or v.strip().lower() not in _FALSY


_LOCK = threading.RLock()
_ENABLED: bool = _env_enabled()

_counters: dict[str, float] = {}
_gauges: dict[str, float] = {}
_hists: dict[str, dict] = {}
# comm accounting: kind -> {"ops": n, "bytes": b}
_comm: dict[str, dict] = {}

_EVENT_BUFFER_MAX = 8192
_events: deque = deque(maxlen=_EVENT_BUFFER_MAX)
_events_total = 0          # includes events evicted from the buffer
_once_keys: set = set()    # journal dedup for high-frequency sites

_journal_path: str | None = os.environ.get("DA_TPU_TELEMETRY_JOURNAL") or None
_journal_file = None       # lazily opened append handle
_journal_bytes = 0         # bytes written (or pre-existing) at the path
_journal_max = 0           # size cap, sampled from env at file open
_journal_capped = False    # True only if rotation itself failed (fallback)
_journal_rotations = 0     # completed .1 rotations at the current path

# the process-wide open incident, if any: failure handling spans threads
# (recovery retries, SPMD rank tasks), so this
# is plain lock-guarded module state rather than a ContextVar.  Minted at
# the first classified failure and carried through retries the same way
# request trace ids ride through dispatch.
_incident_id: str | None = None
_incident_seq = 0

# one monotonic origin per process so every event timestamp is comparable
_T0 = time.monotonic()

# the process id stamped on every journal event, read once (and again in
# a forked child): os.getpid() is a system call, and on some hosts one is
# slow enough to show in a host-bound solver loop
_PID = os.getpid()


def _refresh_pid() -> None:
    global _PID
    _PID = os.getpid()


os.register_at_fork(after_in_child=_refresh_pid)

# host identity stamped on every journal event (and postmortem bundle) so
# journals of several hosts can be merged and re-grouped per host offline;
# DA_TPU_TELEMETRY_HOST overrides it for simulated multi-host runs
_HOST = os.environ.get("DA_TPU_TELEMETRY_HOST") or ""
if not _HOST:
    try:
        import socket as _socket
        _HOST = _socket.gethostname() or "unknown"
    except Exception:  # pragma: no cover
        _HOST = "unknown"

# the innermost open tracing span (telemetry/tracing.py) on this
# thread/context — read here so events and comm records are stamped with
# the span they happened under.  A ContextVar, not thread-local: tasks
# inherit it, and fresh threads start clean (no cross-thread parents).
_CURRENT_SPAN: contextvars.ContextVar = contextvars.ContextVar(
    "da_tpu_current_span", default=None)

# the request-scoped trace ids bound to this context (a tuple of strings,
# or None) — written by telemetry/tracing.trace_ctx, read here so journal
# events (and Spans) are stamped with the requests they belong to.  Lives
# in core for the same reason _CURRENT_SPAN does: event() needs it and
# core cannot import tracing.
_TRACE_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "da_tpu_trace_ctx", default=None)

# extension points so sibling modules (tracing) can plug into report() /
# reset() without core importing them (core stays stdlib-only, cycle-free)
_report_sections: dict = {}
_reset_hooks: list = []


def register_report_section(name: str, fn) -> None:
    """Add ``name: fn()`` to every :func:`report` (telemetry-internal)."""
    _report_sections[name] = fn


def register_reset_hook(fn) -> None:
    """Run ``fn()`` on every :func:`reset` (telemetry-internal)."""
    _reset_hooks.append(fn)


def _journal_max_bytes() -> int:
    """Journal file size cap (``DA_TPU_TELEMETRY_JOURNAL_MAX_MB``, default
    64): at the cap the file rotates to ``<path>.1`` (one generation kept)
    and mirroring continues into a fresh file opened with a single
    ``journal.rotated`` marker event — long soaks with the health sampler
    armed keep a bounded recent window instead of going blind.  Sampled
    once per file open (not per write) — reconfigure() to pick up a
    changed value."""
    try:
        mb = float(os.environ.get("DA_TPU_TELEMETRY_JOURNAL_MAX_MB", "64"))
    except ValueError:
        mb = 64.0
    return max(int(mb * 1024 * 1024), 1)


def _key(name: str, labels: dict) -> str:
    """Canonical metric key: ``name`` or ``name{k=v,...}`` (sorted)."""
    if not labels:
        return name
    return name + "{" + ",".join(
        f"{k}={labels[k]}" for k in sorted(labels)) + "}"


# ---------------------------------------------------------------------------
# enable / disable / configure
# ---------------------------------------------------------------------------


def enabled() -> bool:
    """Whether telemetry is recording (env ``DA_TPU_TELEMETRY``, default
    on; overridable at runtime with :func:`enable` / :func:`disable`)."""
    return _ENABLED


def enable() -> None:
    global _ENABLED
    with _LOCK:
        _ENABLED = True


def disable() -> None:
    """Stop recording.  Already-recorded state stays queryable; the
    journal file handle (if open) is closed."""
    global _ENABLED
    with _LOCK:
        _ENABLED = False
        _close_journal_locked()


def configure(journal_path: str | None) -> None:
    """Set (or clear, with ``None``) the JSONL journal path.  The file is
    opened lazily on the next recorded event, in append mode.  Clears any
    size-cap/rotation state from a previous path."""
    global _journal_path, _journal_bytes, _journal_capped, _journal_rotations
    with _LOCK:
        _close_journal_locked()
        _journal_path = journal_path
        _journal_bytes = 0
        _journal_capped = False
        _journal_rotations = 0


def journal_path() -> str | None:
    return _journal_path


def reset() -> None:
    """Clear every metric, the event buffer, and journal dedup state.
    The enabled flag and the configured journal path are kept; an open
    journal file handle is closed (the file itself is left in place)."""
    global _events_total, _journal_bytes, _journal_capped, \
        _journal_rotations, _incident_id
    with _LOCK:
        _counters.clear()
        _gauges.clear()
        _hists.clear()
        _comm.clear()
        _events.clear()
        _once_keys.clear()
        _events_total = 0
        _journal_bytes = 0
        _journal_capped = False
        _journal_rotations = 0
        _incident_id = None
        _close_journal_locked()
        for hook in _reset_hooks:
            hook()


def _close_journal_locked() -> None:
    global _journal_file
    if _journal_file is not None:
        try:
            _journal_file.close()
        except Exception:
            pass
        _journal_file = None


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def count(name: str, n: float = 1, **labels) -> None:
    """Increment counter ``name`` (with optional labels) by ``n``."""
    if not _ENABLED:
        return
    k = _key(name, labels)
    with _LOCK:
        _counters[k] = _counters.get(k, 0) + n


def set_gauge(name: str, value: float, *, journal: bool = False,
              **labels) -> None:
    """Set gauge ``name`` to ``value``.  ``journal=True`` additionally
    records a ``gauge`` journal event — opt in at sites whose *history*
    matters (elastic live devices, queue depths): a timeline export
    rebuilds counter tracks from these events, where the registry alone
    only keeps the last value."""
    if not _ENABLED:
        return
    k = _key(name, labels)
    with _LOCK:
        _gauges[k] = value
    if journal:
        event("gauge", name, value=value, **labels)


def observe(name: str, value: float, *, buckets=None, **labels) -> None:
    """Record ``value`` into summary histogram ``name`` (count / total /
    min / max; mean derived at report time).

    ``buckets`` (a sorted sequence of upper bounds) upgrades the entry to
    a bucketed histogram: the value lands in the smallest bucket whose
    bound covers it (``+Inf`` above the last).  Bucket counts are stored
    non-cumulative (an exporter renders the cumulative series)."""
    if not _ENABLED:
        return
    k = _key(name, labels)
    with _LOCK:
        h = _hists.get(k)
        if h is None:
            h = _hists[k] = {"count": 1, "total": value,
                             "min": value, "max": value}
        else:
            h["count"] += 1
            h["total"] += value
            if value < h["min"]:
                h["min"] = value
            if value > h["max"]:
                h["max"] = value
        if buckets is not None:
            bk = h.setdefault("buckets", {})
            for b in buckets:
                if value <= b:
                    key = str(float(b))
                    break
            else:
                key = "+Inf"
            bk[key] = bk.get(key, 0) + 1
            if "bounds" not in h:
                h["bounds"] = [float(b) for b in buckets]


def counter_value(name: str, **labels) -> float:
    with _LOCK:
        return _counters.get(_key(name, labels), 0)


def gauge_value(name: str, default=None, **labels):
    with _LOCK:
        return _gauges.get(_key(name, labels), default)


# ---------------------------------------------------------------------------
# journal
# ---------------------------------------------------------------------------


def event(category: str, name: str | None = None, *,
          once_key: str | None = None, **fields) -> None:
    """Append a structured event to the journal.

    ``t`` is seconds since the process's telemetry origin (monotonic —
    safe to order and subtract); ``wall`` is the epoch time for humans.
    ``once_key`` dedups high-frequency sites: only the FIRST event with a
    given key is journaled (counters still see every occurrence).

    Events recorded while a tracing span is open carry its ``span_id``
    (unless the caller already set one) — the nearest *journaled*
    ancestor's, so a journal's span_id references always resolve to a
    span event in the same journal (aggregate-only spans never reach
    it).  Every event also carries the recording thread's ``tid`` — the
    per-thread track key of a timeline export."""
    if not _ENABLED:
        return
    global _events_total
    sp = _CURRENT_SPAN.get()
    while sp is not None and not getattr(sp, "journaled", True):
        sp = sp.parent
    with _LOCK:
        if once_key is not None:
            if once_key in _once_keys:
                return
            _once_keys.add(once_key)
        rec = {"seq": _events_total,
               "t": round(time.monotonic() - _T0, 6),
               "wall": round(time.time(), 3),
               "cat": category,
               "tid": threading.get_ident(),
               "host": _HOST,
               "pid": _PID}
        if name is not None:
            rec["name"] = name
        if sp is not None and "span_id" not in fields:
            rec["span_id"] = sp.span_id
        tr = _TRACE_CTX.get()
        if tr and "trace_id" not in fields:
            rec["trace_id"] = list(tr)
        if _incident_id is not None and "incident" not in fields:
            rec["incident"] = _incident_id
        for k, v in fields.items():
            rec[k] = _jsonable(v)
        _events_total += 1
        _events.append(rec)
        _write_journal_locked(rec)


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return str(v)


def begin_incident(kind: str = "failure") -> str | None:
    """Open (or join) the process-wide incident and return its id.

    Minted at the first classified failure (``inc-<host>-<pid>-<n>``);
    while open, every journal event and flight bundle is stamped with the
    id, so retries, quorum verdicts, restores, shrinks, drains and
    bundles from one causal episode correlate across hosts — the same
    discipline as request trace ids.  Re-entrant: a second classified
    failure inside an open incident joins it (one ``incident/begin``
    event per episode).  Returns ``None`` when telemetry is disabled."""
    global _incident_id, _incident_seq
    if not _ENABLED:
        return None
    with _LOCK:
        if _incident_id is not None:
            return _incident_id
        _incident_seq += 1
        _incident_id = f"inc-{_HOST}-{os.getpid()}-{_incident_seq}"
        inc = _incident_id
    event("incident", "begin", kind=kind)
    return inc


def current_incident() -> str | None:
    """The open incident id, or ``None``."""
    return _incident_id


def end_incident(resolution: str = "resolved") -> None:
    """Close the open incident (no-op if none): one ``incident/end``
    event carrying the id and ``resolution`` (``recovered`` /
    ``minority_exit`` / ``gave_up`` / ...), then stop stamping."""
    global _incident_id
    if _incident_id is None:
        return
    event("incident", "end", resolution=resolution)
    with _LOCK:
        _incident_id = None


def _write_journal_locked(rec: dict) -> None:
    global _journal_file, _journal_bytes, _journal_max, _journal_capped, \
        _events_total, _journal_rotations
    if _journal_path is None or _journal_capped:
        return
    try:
        if _journal_file is None:
            parent = os.path.dirname(_journal_path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            try:
                _journal_bytes = os.path.getsize(_journal_path)
            except OSError:
                _journal_bytes = 0
            _journal_max = _journal_max_bytes()
            _journal_file = open(_journal_path, "a")
        line = json.dumps(rec) + "\n"
        _journal_file.write(line)
        _journal_file.flush()
        _journal_bytes += len(line)
        if _journal_bytes >= _journal_max:
            # size cap reached: rotate the full file to <path>.1 (one
            # generation kept — the previous .1, if any, is replaced) and
            # continue mirroring into a fresh file whose first line is a
            # single journal.rotated marker, so long sampler-armed soaks
            # keep a bounded recent window instead of going blind
            rotated = _journal_bytes
            _close_journal_locked()
            try:
                os.replace(_journal_path, _journal_path + ".1")
            except OSError:
                # rotation impossible (e.g. cross-device, permissions):
                # fall back to the pre-rotation latch — marker in the
                # buffer, file mirroring stops, counters keep recording
                cap = {"seq": _events_total,
                       "t": round(time.monotonic() - _T0, 6),
                       "wall": round(time.time(), 3),
                       "cat": "journal", "name": "capped",
                       "host": _HOST, "pid": _PID,
                       "bytes_written": rotated,
                       "max_bytes": _journal_max}
                _events_total += 1
                _events.append(cap)
                _journal_capped = True
                return
            _journal_rotations += 1
            _journal_bytes = 0
            _journal_file = open(_journal_path, "a")
            marker = {"seq": _events_total,
                      "t": round(time.monotonic() - _T0, 6),
                      "wall": round(time.time(), 3),
                      "cat": "journal", "name": "rotated",
                      "host": _HOST, "pid": _PID,
                      "rotated_to": _journal_path + ".1",
                      "rotation": _journal_rotations,
                      "bytes_rotated": rotated,
                      "max_bytes": _journal_max}
            _events_total += 1
            _events.append(marker)
            mline = json.dumps(marker) + "\n"
            _journal_file.write(mline)
            _journal_file.flush()
            _journal_bytes += len(mline)
    except OSError:
        # telemetry must never take down the workload it observes
        _journal_file = None


def events(category: str | None = None) -> list[dict]:
    """Snapshot of the buffered events (most recent ``_EVENT_BUFFER_MAX``),
    optionally filtered by category."""
    with _LOCK:
        evs = list(_events)
    if category is None:
        return evs
    return [e for e in evs if e.get("cat") == category]


# ---------------------------------------------------------------------------
# communication accounting
# ---------------------------------------------------------------------------


def _itemsize(dtype) -> int:
    try:
        import numpy as _np
        return int(_np.dtype(dtype).itemsize)
    except TypeError:
        import torch as _torch
        if isinstance(dtype, _torch.dtype):
            return _torch.empty(0, dtype=dtype).element_size()
        raise


def nbytes_of(x) -> int:
    """Best-effort payload size in bytes: torch tensors and numpy arrays
    (``nbytes``), anything with a ``shape`` and a numpy or torch ``dtype``
    (a DArray: its global size), bytes-like payloads, and lists, tuples
    and dicts of these (summed); 0 for anything else."""
    try:
        if isinstance(x, (list, tuple)):
            return sum(nbytes_of(v) for v in x)
        if isinstance(x, dict):
            return sum(nbytes_of(v) for v in x.values())
        nb = getattr(x, "nbytes", None)
        if isinstance(nb, (int, float)):
            return int(nb)
        shape = getattr(x, "shape", None)
        dtype = getattr(x, "dtype", None)
        if shape is not None and dtype is not None:
            n = 1
            for s in shape:
                n *= int(s)
            return n * _itemsize(dtype)
        if isinstance(x, (bytes, bytearray, memoryview)):
            return len(x)
    except Exception:
        pass
    return 0


def record_comm(kind: str, nbytes: int, *, axis=None, op: str | None = None,
                journal: bool = True, once_key: str | None = None,
                **fields) -> None:
    """Account one communication: ``kind`` (reshard / h2d / d2h /
    collective / replicate / spmd_send / ...),
    estimated payload ``nbytes``, optional mesh ``axis`` and originating
    ``op``.  Feeds ``comm.ops``/``comm.bytes`` per kind and (unless
    ``journal=False``) one journal event under category ``"comm"``.

    When a tracing span is open, the bytes are also attributed to it
    (the span's own-bytes tally; parents see them via child rollups at
    span close) and the journal event carries its ``span_id``."""
    if not _ENABLED:
        return
    nbytes = int(nbytes)
    sp = _CURRENT_SPAN.get()
    with _LOCK:
        c = _comm.get(kind)
        if c is None:
            _comm[kind] = {"ops": 1, "bytes": nbytes}
        else:
            c["ops"] += 1
            c["bytes"] += nbytes
        if sp is not None:
            sp.bytes += nbytes
    if journal:
        ev = dict(fields)
        if axis is not None:
            ev["axis"] = axis
        if op is not None:
            ev["op"] = op
        event("comm", kind, once_key=once_key, bytes=nbytes, **ev)


def comm_bytes(kind: str | None = None) -> int:
    """Total estimated bytes moved (optionally for one kind)."""
    with _LOCK:
        if kind is not None:
            c = _comm.get(kind)
            return int(c["bytes"]) if c else 0
        return int(sum(c["bytes"] for c in _comm.values()))


# ---------------------------------------------------------------------------
# reporting
# ---------------------------------------------------------------------------


def report() -> dict:
    """Nested snapshot of everything recorded so far."""
    with _LOCK:
        by_cat: dict[str, int] = {}
        for e in _events:
            by_cat[e["cat"]] = by_cat.get(e["cat"], 0) + 1
        out = {
            "enabled": _ENABLED,
            "counters": dict(_counters),
            "gauges": dict(_gauges),
            "histograms": {
                k: {**h, "mean": h["total"] / h["count"],
                    **({"buckets": dict(h["buckets"])}
                       if "buckets" in h else {})}
                for k, h in _hists.items()
            },
            "comm": {
                "total_bytes": int(sum(c["bytes"] for c in _comm.values())),
                "total_ops": int(sum(c["ops"] for c in _comm.values())),
                "by_kind": {k: dict(v) for k, v in _comm.items()},
            },
            "events": {
                "recorded": _events_total,
                "buffered": len(_events),
                "by_category": by_cat,
                "journal_path": _journal_path,
                "journal_capped": _journal_capped,
                "journal_rotations": _journal_rotations,
            },
            "incident": _incident_id,
        }
    # outside _LOCK: section providers take it themselves (RLock would
    # allow reentry, but holding it across foreign code invites deadlock)
    for name, fn in _report_sections.items():
        try:
            out[name] = fn()
        except Exception:
            out[name] = {"error": "report section failed"}
    return out


def dump(path: str) -> str:
    """Write :func:`report` as indented JSON to ``path``; returns the
    path.  Atomic (tmp + replace), same discipline as autotune.save."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(report(), f, indent=2, sort_keys=True)
    os.replace(tmp, path)
    return path
