"""Live telemetry plane, host side: the streaming exporter.

The port's copy of ``distributedarrays_tpu/telemetry/stream.py``: the
same frames, endpoints, counters and environment switches
(``DA_TPU_STREAM_AGG``, ``DA_TPU_STREAM_INTERVAL_S``, ``DA_TPU_FLAME_HZ``,
``DA_TPU_STREAM_RING``), so either package's exporter streams to either
package's aggregator.  In a job of several controller processes
``parallel.multihost.advertise_exporter`` registers an armed exporter in
the job's store.

Everything built before this module is post-hoc — journals are merged
and analyzed after the run exits.  This module makes the same telemetry
*streamable while the workload runs*: a per-host exporter assembles
bounded **delta frames** (changed counters/gauges, the journal-event
tail, HBM-ledger gauges, flame-profile deltas) on its own daemon thread
and ships them to an aggregator (:mod:`telemetry.agg`) over plain HTTP.

Design rules, in order of importance:

1. **The hot path is never touched.**  Recording calls (``count`` /
   ``set_gauge`` / ``event`` / span close) do no streaming work; the
   exporter *pulls* snapshots under ``core._LOCK`` on its own thread.
   The only streaming calls that may appear on warm paths —
   :func:`note` and :func:`poke` — are a single ``is None`` check when
   no exporter is armed (and when telemetry is disabled an exporter can
   never be armed, so ``DA_TPU_TELEMETRY=0`` keeps the one-boolean-check
   discipline).
2. **Streaming never stalls and never backpressures.**  Frames land in
   a bounded ring; a lagging or dead aggregator makes the ring lap and
   the overwritten frames are *counted* (``frames_dropped``), never
   waited on.  Sends use short socket timeouts and a cold-down between
   reconnect attempts.
3. **Drop accounting is explicit.**  Every frame carries the exporter's
   cumulative ``frames_dropped`` / ``events_dropped`` counters, the
   aggregator re-exports them as ``da_tpu_stream_dropped_frames``, and
   :mod:`telemetry.flight` bundles capture them at crash time.

Event tails come from the in-memory ring (same process) or from a
:class:`JournalTailer` following another process's JSONL journal — the
tailer survives size-cap rotation (``journal.rotated``): it drains the
renamed file to EOF before re-opening the fresh one and dedups on the
globally monotonic ``seq``, so rotation mid-stream neither double-ships
nor gaps events.

Continuous profiling rides the same plane: :class:`FlameProfiler`
samples :func:`tracing.open_spans` at a configurable Hz into
collapsed-stack (Brendan Gregg) format; deltas ship in frames and
``python -m distributedarrays_tpu_torch.telemetry flame`` renders them — or
builds the same format post-hoc from a journal's span records
(:func:`collapsed_from_events`).

Arming: :func:`start` explicitly, or export ``DA_TPU_STREAM_AGG=host:port``
before import (the same auto-install pattern as the health sampler) —
the aggregator URL may also come from the multihost coordination KV
(:func:`parallel.multihost.aggregator_endpoint`).
"""

from __future__ import annotations

import http.client
import json
import os
import threading
import time

from . import core, tracing

__all__ = [
    "StreamExporter", "JournalTailer", "FlameProfiler",
    "start", "stop", "armed", "stats", "note", "note_health", "poke",
    "collapsed_from_events", "AGG_ENV",
]

AGG_ENV = "DA_TPU_STREAM_AGG"
FRAME_VERSION = 1

# per-frame bounds: a frame is a bounded delta, never "everything since
# the epoch" — a consumer that lagged gets the counters' absolute values
# (self-healing) and an event gap that is COUNTED, not silently absorbed
MAX_EVENTS_PER_FRAME = 2000


def _now_wall() -> float:
    return time.time()


# ---------------------------------------------------------------------------
# frame ring
# ---------------------------------------------------------------------------


class _Ring:
    """Bounded frame ring with explicit drop accounting.

    Single-threaded by design (the exporter thread both pushes assembled
    frames and drains them toward the aggregator), so no lock is needed:
    the ring's job is not cross-thread handoff but *bounded retention* —
    frames the aggregator could not take yet wait here, and when the
    writer laps the reader the oldest frame is overwritten and
    ``dropped`` incremented instead of anyone blocking."""

    def __init__(self, capacity: int):
        self.capacity = max(2, int(capacity))
        self._slots: list = [None] * self.capacity
        self._head = 0          # next write position (monotonic)
        self._tail = 0          # next read position (monotonic)
        self.dropped = 0

    def push(self, frame: dict) -> None:
        if self._head - self._tail >= self.capacity:
            # consumer lagged a full lap: drop the oldest, count it
            self._tail += 1
            self.dropped += 1
        self._slots[self._head % self.capacity] = frame
        self._head += 1

    def peek(self):
        if self._tail >= self._head:
            return None
        return self._slots[self._tail % self.capacity]

    def pop(self) -> None:
        if self._tail < self._head:
            self._slots[self._tail % self.capacity] = None
            self._tail += 1

    def __len__(self) -> int:
        return self._head - self._tail


# ---------------------------------------------------------------------------
# journal tailer (rotation-safe)
# ---------------------------------------------------------------------------


class JournalTailer:
    """Follow a JSONL journal file across size-cap rotations.

    Reads complete lines only (a line the writer is mid-way through is
    left for the next poll), dedups on the journal's globally monotonic
    ``seq``, and handles rotation without double-shipping or gapping:
    when the path's inode no longer matches the open handle (the writer
    renamed the full file to ``<path>.1`` and opened a fresh one), the
    old handle is first drained to EOF — those events exist nowhere else
    once ``.1`` is itself replaced — and only then is the fresh file
    opened from offset 0.  The fresh file begins with the
    ``journal.rotated`` marker whose ``seq`` continues the same sequence,
    so the seq dedup proves continuity; a genuinely missed record (e.g.
    the tailer started late) surfaces as a counted gap in ``dropped``."""

    def __init__(self, path: str, *, from_start: bool = True):
        self.path = str(path)
        self._f = None
        self._ino = None
        self.last_seq = -1
        self.rotations = 0
        self.dropped = 0
        self._from_start = from_start

    def _open(self) -> bool:
        try:
            f = open(self.path, "r")
        except OSError:
            return False
        self._f = f
        try:
            self._ino = os.fstat(f.fileno()).st_ino
        except OSError:
            self._ino = None
        if not self._from_start:
            # intentional skip, not a drop — but seed last_seq from the
            # file's tail so gap accounting stays exact from here on (a
            # record evicted between this open and the first poll counts)
            self._seed_seq_from_tail(f)
            f.seek(0, os.SEEK_END)
            self._from_start = True   # only the very first open skips
        return True

    def _seed_seq_from_tail(self, f) -> None:
        try:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(size - 65536, 0))
            last = None
            for line in f:
                if not line.endswith("\n"):
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict) and isinstance(rec.get("seq"),
                                                        int):
                    last = rec["seq"]
            if last is not None:
                self.last_seq = last
        except (OSError, ValueError):
            pass

    def _rotated(self) -> bool:
        """True when ``path`` now names a different file than the open
        handle (the writer rotated)."""
        if self._ino is None:
            return False
        try:
            return os.stat(self.path).st_ino != self._ino
        except OSError:
            return False

    def _read_lines(self, limit: int) -> list[dict]:
        out: list[dict] = []
        f = self._f
        while len(out) < limit:
            pos = f.tell()
            line = f.readline()
            if not line:
                break
            if not line.endswith("\n"):
                # writer mid-line: rewind, retry next poll
                f.seek(pos)
                break
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if not isinstance(rec, dict):
                continue
            seq = rec.get("seq")
            if isinstance(seq, int):
                if seq <= self.last_seq:
                    continue              # overlap (rotation/re-open): dedup
                if self.last_seq >= 0 and seq > self.last_seq + 1:
                    self.dropped += seq - self.last_seq - 1
                self.last_seq = seq
            out.append(rec)
        return out

    def poll(self, max_events: int = MAX_EVENTS_PER_FRAME) -> list[dict]:
        """New complete journal records since the last poll (bounded)."""
        if self._f is None and not self._open():
            return []
        out = self._read_lines(max_events)
        if len(out) < max_events and self._rotated():
            # drain what is left of the renamed generation, then switch
            out.extend(self._read_lines(max_events - len(out)))
            try:
                self._f.close()
            except OSError:
                pass
            self._f = None
            self.rotations += 1
            if self._open():
                out.extend(self._read_lines(max_events - len(out)))
        return out

    def close(self) -> None:
        if self._f is not None:
            try:
                self._f.close()
            except OSError:
                pass
            self._f = None


# ---------------------------------------------------------------------------
# continuous profiling: sampling over open spans
# ---------------------------------------------------------------------------


def _stack_of(sp: dict, by_id: dict) -> str:
    names = [str(sp.get("name", "?"))]
    seen = {sp.get("span_id")}
    parent = by_id.get(sp.get("parent_id"))
    while parent is not None and parent.get("span_id") not in seen:
        seen.add(parent.get("span_id"))
        names.append(str(parent.get("name", "?")))
        parent = by_id.get(parent.get("parent_id"))
    return ";".join(reversed(names))


class FlameProfiler(threading.Thread):
    """Sampling profiler over :func:`tracing.open_spans`.

    At each tick (``hz`` samples/second) every *leaf* open span — one
    with no open child — contributes one sample to its root→leaf stack.
    Samples accumulate as ``{collapsed_stack: count}``; ticks with no
    open span are counted separately (``idle``), so attribution math is
    honest about uninstrumented time.  Zero cost to the sampled threads
    beyond the shared ``core._LOCK`` snapshot."""

    def __init__(self, hz: float = 20.0):
        super().__init__(name="da-tpu-flame", daemon=True)
        self.hz = max(0.5, float(hz))
        self._counts: dict[str, int] = {}
        self._delta: dict[str, int] = {}
        self._lock = threading.Lock()
        self._halt = threading.Event()
        self.samples = 0
        self.idle = 0

    def sample_once(self) -> None:
        sps = tracing.open_spans()
        if not sps:
            self.idle += 1
            return
        by_id = {s.get("span_id"): s for s in sps}
        parents = {s.get("parent_id") for s in sps
                   if s.get("parent_id") in by_id}
        leaves = [s for s in sps if s.get("span_id") not in parents]
        with self._lock:
            for leaf in leaves:
                stack = _stack_of(leaf, by_id)
                self._counts[stack] = self._counts.get(stack, 0) + 1
                self._delta[stack] = self._delta.get(stack, 0) + 1
            self.samples += 1

    def run(self) -> None:  # pragma: no cover — exercised via sample_once
        period = 1.0 / self.hz
        while not self._halt.wait(period):
            try:
                self.sample_once()
            except Exception:
                pass                  # profiling must never kill anything

    def stop(self) -> None:
        self._halt.set()

    def counts(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def take_delta(self) -> dict[str, int]:
        """Samples accumulated since the last take (ships in frames)."""
        with self._lock:
            d, self._delta = self._delta, {}
            return d

    def collapsed(self) -> str:
        """The accumulated profile in collapsed-stack format
        (``frame;frame;frame count`` per line)."""
        return collapsed_lines(self.counts())


def collapsed_lines(counts: dict) -> str:
    return "\n".join(f"{stack} {int(n)}"
                     for stack, n in sorted(counts.items()) if int(n) > 0)


def collapsed_from_events(events, *, unit_ms: bool = True):
    """Post-hoc flame profile from a journal's finished-span records.

    Returns ``(counts, stats)``: ``counts`` maps each root→leaf stack to
    its **self time in milliseconds** (wall attribution, not samples) —
    a span's self time is its duration minus its journaled children's;
    ``stats`` reports ``attributed_s`` (sum of root-span durations),
    ``wall_s`` (first to last event timestamp) and their ratio, the
    number the live-plane acceptance gate checks (≥90% of wall time
    attributed when the workload runs under spans)."""
    spans = [e for e in events
             if e.get("cat") == "span" and e.get("dur") is not None
             and e.get("span_id") is not None]
    by_id = {s["span_id"]: s for s in spans}
    child_dur: dict = {}
    for s in spans:
        p = s.get("parent_id")
        if p in by_id:
            child_dur[p] = child_dur.get(p, 0.0) + float(s["dur"])
    counts: dict[str, float] = {}
    attributed = 0.0
    for s in spans:
        self_s = max(float(s["dur"]) - child_dur.get(s["span_id"], 0.0),
                     0.0)
        stack = _stack_of(s, by_id)
        counts[stack] = counts.get(stack, 0.0) + \
            (self_s * 1000.0 if unit_ms else self_s)
        if s.get("parent_id") not in by_id:
            attributed += float(s["dur"])
    # a span record's ``t`` is its END stamp; the wall window must open
    # at the earliest span START (t - dur) or the ratio overshoots
    starts, ends = [], []
    for e in events:
        t = e.get("t")
        if not isinstance(t, (int, float)):
            continue
        ends.append(float(t))
        dur = e.get("dur") if e.get("cat") == "span" else None
        starts.append(float(t) - float(dur)
                      if isinstance(dur, (int, float)) else float(t))
    wall = (max(ends) - min(starts)) if starts else 0.0
    stats = {"spans": len(spans), "attributed_s": round(attributed, 6),
             "wall_s": round(wall, 6),
             "attributed_frac": round(attributed / wall, 4) if wall else
             (1.0 if attributed else 0.0)}
    out = {k: int(round(v)) for k, v in counts.items() if round(v) >= 1}
    return out, stats


# ---------------------------------------------------------------------------
# the exporter
# ---------------------------------------------------------------------------


def _parse_url(url: str) -> tuple[str, int, str]:
    """``[http://]host:port[/base]`` -> (host, port, base_path)."""
    u = str(url)
    if "://" in u:
        u = u.split("://", 1)[1]
    base = ""
    if "/" in u:
        u, rest = u.split("/", 1)
        base = "/" + rest.rstrip("/")
    host, _, port = u.rpartition(":")
    return host or "127.0.0.1", int(port), base


class StreamExporter(threading.Thread):
    """Per-host streaming exporter (one daemon thread).

    Every ``interval_s`` it assembles one bounded delta frame — changed
    counters/gauges (absolute values, so a lost frame self-heals),
    eagerly :func:`note`-d gauge points with wall timestamps, the
    journal-event tail (in-memory ring or :class:`JournalTailer`), HBM
    ledger gauges, flame-profile deltas, and its own drop/lag counters —
    pushes it into the bounded ring, and drains the ring toward the
    aggregator with short-timeout POSTs.  A dead aggregator costs
    nothing but counted drops; a revived one gets frames again within
    one reconnect interval."""

    def __init__(self, agg_url: str, *, interval_s: float = 0.5,
                 ring_frames: int = 256, journal: str | None = None,
                 flame_hz: float | None = None,
                 send_timeout_s: float = 1.0,
                 reconnect_s: float = 1.0,
                 heartbeat_every: int = 10):
        super().__init__(name="da-tpu-stream", daemon=True)
        self.agg_host, self.agg_port, self.agg_base = _parse_url(agg_url)
        self.interval_s = max(0.01, float(interval_s))
        self.ring = _Ring(ring_frames)
        self.tailer = JournalTailer(journal) if journal else None
        self.profiler = FlameProfiler(flame_hz) if flame_hz else None
        self.send_timeout_s = float(send_timeout_s)
        self.reconnect_s = float(reconnect_s)
        self.heartbeat_every = max(1, int(heartbeat_every))
        self._halt = threading.Event()
        self._flush = threading.Event()
        self._conn = None
        self._next_try = 0.0
        self._last_counters: dict = {}
        self._last_gauges: dict = {}
        self._last_seq = -1
        self._notes_lock = threading.Lock()
        self._tick_lock = threading.Lock()
        self._notes: list = []
        self._health: dict | None = None
        # cumulative, all monotonic non-decreasing
        self.frame_seq = 0
        self.frames_sent = 0
        self.frames_dropped = 0
        self.events_shipped = 0
        self.events_dropped = 0
        self.send_errors = 0
        self.connected = False
        self._ticks = 0

    # -- hot-path-adjacent entry points (single check when unarmed lives
    # in the module-level wrappers; these are already off the hot path)

    def add_note(self, name: str, value: float, labels: dict) -> None:
        key = core._key(name, labels) if labels else name
        with self._notes_lock:
            self._notes.append([key, float(value), _now_wall()])

    def add_health(self, payload: dict) -> None:
        with self._notes_lock:
            self._health = dict(payload)

    def request_flush(self) -> None:
        self._flush.set()

    # -- frame assembly ----------------------------------------------------

    def _tail_events(self) -> list[dict]:
        if self.tailer is not None:
            evs = self.tailer.poll(MAX_EVENTS_PER_FRAME)
            self.events_dropped = self.tailer.dropped
            return evs
        with core._LOCK:
            # the pending events are a SUFFIX of the ring (seq is
            # globally monotonic): walk from the right and stop at the
            # first already-shipped one, so the lock is held O(pending),
            # not O(ring capacity), per tick
            pending = []
            for e in reversed(core._events):
                if e.get("seq", -1) <= self._last_seq:
                    break
                pending.append(dict(e))
            pending.reverse()
        out = pending[:MAX_EVENTS_PER_FRAME]
        if out:
            first = out[0].get("seq", self._last_seq + 1)
            if self._last_seq >= 0 and first > self._last_seq + 1:
                # the bounded in-memory ring evicted events before we
                # tailed them: a counted gap, never a silent one
                self.events_dropped += first - self._last_seq - 1
            self._last_seq = out[-1].get("seq", self._last_seq)
        return out

    def assemble_frame(self) -> dict | None:
        """One bounded delta frame; None when there is nothing to say
        (a heartbeat frame still goes out every ``heartbeat_every``
        ticks so the aggregator can tell silence from death)."""
        with core._LOCK:
            counters = dict(core._counters)
            gauges = dict(core._gauges)
        c_delta = {k: v for k, v in counters.items()
                   if self._last_counters.get(k) != v}
        g_delta = {k: v for k, v in gauges.items()
                   if self._last_gauges.get(k) != v}
        self._last_counters = counters
        self._last_gauges = gauges
        events = self._tail_events()
        with self._notes_lock:
            points, self._notes = self._notes, []
            health, self._health = self._health, None
        flame = self.profiler.take_delta() if self.profiler else {}
        mem = {}
        try:
            from . import memory as _mem
            mem = {"live_bytes": _mem.live_bytes(),
                   "peak_bytes": _mem.peak_bytes(),
                   "by_device": {str(d): int(v) for d, v in
                                 _mem.live_bytes_by_device().items()}}
        except Exception:
            pass
        self._ticks += 1
        empty = not (c_delta or g_delta or events or points or flame
                     or health)
        if empty and self._ticks % self.heartbeat_every:
            return None
        self.events_shipped += len(events)
        frame = {
            "v": FRAME_VERSION,
            "host": core._HOST,
            "pid": os.getpid(),
            "frame_seq": self.frame_seq,
            "wall": round(_now_wall(), 3),
            "t": round(time.monotonic() - core._T0, 6),
            "counters": c_delta,
            "gauges": g_delta,
            "points": points,
            "events": events,
            "memory": mem,
            "flame": flame,
            "stream": {
                "frames_dropped": self.ring.dropped,
                "events_dropped": self.events_dropped,
                "frames_sent": self.frames_sent,
                "send_errors": self.send_errors,
                "lag_frames": len(self.ring),
            },
        }
        if health:
            frame["health"] = health
        self.frame_seq += 1
        return frame

    # -- transport ---------------------------------------------------------

    def _send(self, frame: dict) -> bool:
        try:
            if self._conn is None:
                self._conn = http.client.HTTPConnection(
                    self.agg_host, self.agg_port,
                    timeout=self.send_timeout_s)
            body = json.dumps(frame).encode()
            self._conn.request("POST", self.agg_base + "/ingest", body,
                               {"Content-Type": "application/json"})
            resp = self._conn.getresponse()
            resp.read()
            ok = 200 <= resp.status < 300
            if not ok:
                raise OSError(f"aggregator returned {resp.status}")
            return True
        except Exception:
            self.send_errors += 1
            self.connected = False
            if self._conn is not None:
                try:
                    self._conn.close()
                except Exception:
                    pass
                self._conn = None
            self._next_try = time.monotonic() + self.reconnect_s
            return False

    def _drain(self) -> None:
        if time.monotonic() < self._next_try:
            return
        while True:
            frame = self.ring.peek()
            if frame is None:
                return
            if not self._send(frame):
                return
            self.connected = True
            self.ring.pop()
            self.frames_sent += 1

    # -- lifecycle ---------------------------------------------------------

    def tick(self) -> None:
        """One assemble+drain cycle (the run loop's body; callable
        directly from tests for determinism).  Serialized against the
        background thread: a manual tick racing the run loop would
        interleave two HTTP requests on the one keep-alive connection
        and corrupt the stream."""
        with self._tick_lock:
            frame = self.assemble_frame()
            if frame is not None:
                self.ring.push(frame)
            self.frames_dropped = self.ring.dropped
            self._drain()

    def run(self) -> None:  # pragma: no cover — exercised via tick()
        if self.profiler is not None:
            self.profiler.start()
        while not self._halt.is_set():
            self._flush.wait(self.interval_s)
            self._flush.clear()
            if self._halt.is_set():
                break
            try:
                self.tick()
            except Exception:
                pass              # streaming must never kill the workload
        # final best-effort flush so short-lived processes still land
        try:
            self.tick()
        except Exception:
            pass
        if self.profiler is not None:
            self.profiler.stop()
        if self.tailer is not None:
            self.tailer.close()
        if self._conn is not None:
            try:
                self._conn.close()
            except Exception:
                pass

    def stop(self, join_s: float = 2.0) -> None:
        self._halt.set()
        self._flush.set()
        if self.is_alive():
            self.join(join_s)

    def stats_dict(self) -> dict:
        return {
            "armed": True,
            "agg": f"{self.agg_host}:{self.agg_port}",
            "connected": self.connected,
            "frames_sent": self.frames_sent,
            "frames_dropped": self.ring.dropped,
            "events_shipped": self.events_shipped,
            "events_dropped": self.events_dropped,
            "send_errors": self.send_errors,
            "lag_frames": len(self.ring),
            "flame_samples": self.profiler.samples if self.profiler else 0,
        }


# ---------------------------------------------------------------------------
# module-level plane control
# ---------------------------------------------------------------------------


_EXPORTER: StreamExporter | None = None
_ARM_LOCK = threading.Lock()


def armed() -> bool:
    """True when a streaming exporter is running in this process."""
    return _EXPORTER is not None


def start(agg_url: str | None = None, *, interval_s: float | None = None,
          journal: str | None = None, flame_hz: float | None = None,
          ring_frames: int | None = None) -> StreamExporter | None:
    """Arm the per-host exporter (idempotent; returns the exporter, or
    ``None`` when telemetry is disabled or no aggregator is known).

    ``agg_url`` defaults to ``DA_TPU_STREAM_AGG``, else the multihost
    coordination KV advertisement (:func:`parallel.multihost.
    aggregator_endpoint`).  ``flame_hz`` defaults to
    ``DA_TPU_FLAME_HZ`` (unset/0 = no continuous profiler)."""
    global _EXPORTER
    if not core.enabled():
        return None
    with _ARM_LOCK:
        if _EXPORTER is not None:
            return _EXPORTER
        if agg_url is None:
            agg_url = os.environ.get(AGG_ENV) or None
        if agg_url is None:
            try:
                from ..parallel import multihost as _mh
                agg_url = _mh.aggregator_endpoint()
            except Exception:
                agg_url = None
        if not agg_url:
            return None
        if interval_s is None:
            interval_s = float(os.environ.get(
                "DA_TPU_STREAM_INTERVAL_S", "0.5"))
        if flame_hz is None:
            try:
                flame_hz = float(os.environ.get("DA_TPU_FLAME_HZ", "0"))
            except ValueError:
                flame_hz = 0.0
        if ring_frames is None:
            ring_frames = int(os.environ.get("DA_TPU_STREAM_RING", "256"))
        exp = StreamExporter(agg_url, interval_s=interval_s,
                             journal=journal,
                             flame_hz=flame_hz or None,
                             ring_frames=ring_frames)
        exp.start()
        _EXPORTER = exp
        core.event("stream", "armed", agg=f"{exp.agg_host}:{exp.agg_port}",
                   interval_s=exp.interval_s,
                   flame_hz=flame_hz or 0)
        return exp


def stop() -> None:
    """Disarm the exporter (no-op when not armed)."""
    global _EXPORTER
    with _ARM_LOCK:
        exp, _EXPORTER = _EXPORTER, None
    if exp is not None:
        exp.stop()


def stats() -> dict:
    """The exporter's live drop/lag counters (``{"armed": False}`` when
    no exporter runs) — captured into flight bundles so a postmortem
    shows whether live telemetry was degraded at crash time."""
    exp = _EXPORTER
    if exp is None:
        return {"armed": False}
    return exp.stats_dict()


def note(name: str, value: float, **labels) -> None:
    """Eagerly publish one gauge point to the live plane.

    Unlike the exporter's tick-sampled registry diff, a note carries its
    own wall timestamp and every update is delivered (not just the last
    value per tick) — the aggregator's burn-rate windows see the full
    history.  Serve and train call this next to their SLO gauges.  A
    single ``is None`` check when no exporter is armed."""
    exp = _EXPORTER
    if exp is None:
        return
    exp.add_note(name, value, labels)


def note_health(payload: dict) -> None:
    """Publish one health-sampler tick to the live plane (the sampler
    calls this so one sampler feeds journal, alerts, AND the stream).
    Single check when unarmed."""
    exp = _EXPORTER
    if exp is None:
        return
    exp.add_health(payload)
    exp.request_flush()


def poke() -> None:
    """Request an immediate frame flush (single check when unarmed)."""
    exp = _EXPORTER
    if exp is None:
        return
    exp.request_flush()


def _maybe_autostart() -> None:
    """Arm at import when ``DA_TPU_STREAM_AGG`` is set (same pattern as
    the health sampler's autostart).  No-op otherwise."""
    if not core.enabled():
        return
    if os.environ.get(AGG_ENV):
        try:
            start()
        except Exception:
            pass


def _reset() -> None:
    """Test hook: disarm and drop module state (joins the exporter, so
    never call from under ``core._LOCK`` — fixtures call it from
    teardown, not from a ``core.reset`` hook)."""
    stop()
