"""Live telemetry plane, cluster side: the aggregator service.

The port's copy of ``distributedarrays_tpu/telemetry/agg.py``: the same
frames, endpoints and metrics, bound to ``127.0.0.1`` by default, so it
takes either package's exporter frames.

Ingests the per-host delta frames published by :mod:`telemetry.stream`
exporters and turns them into one *live* cluster view:

- **one timeline** — per-host event tails are aligned in real time with
  the SAME three-tier clock-offset machinery the post-hoc merge uses
  (:func:`telemetry.cluster.merge_journals` accepts already-parsed event
  lists), so the live ordering matches what an offline
  ``telemetry incident`` merge of the journals would produce;
- **live alerting** — an :class:`alerts.AlertManager` is driven from
  the streamed signals (gauge points with their original wall
  timestamps, counter deltas) instead of the dead journal: the stock
  SLO burn rules fire *while the workload runs* and clear with the same
  hysteresis;
- **scrapeable metrics** — a real Prometheus ``/metrics`` endpoint
  re-exports every host's registry with a ``host`` label plus the
  stream's own health (``da_tpu_stream_dropped_frames`` et al.), and
  ``/healthz`` answers liveness probes;
- **live traces and flames** — ``/trace`` serves the merged timeline as
  a chunked Perfetto download and ``/flame`` the merged collapsed-stack
  profile; ``/snapshot`` feeds the ``telemetry top`` dashboard.

Everything is stdlib (``http.server``); run it in-process
(:func:`serve`) or as a service::

    python -m distributedarrays_tpu_torch.telemetry agg --port 9300

With ``DA_TPU_TELEMETRY=0`` the endpoints refuse cleanly (503) — an
aggregator without telemetry is a contradiction, and the refusal is the
documented, tested behavior rather than an accident.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from . import alerts, cluster, core, export

__all__ = ["Aggregator", "AggServer", "serve", "live_default_rules"]

# events retained per host stream: bounds aggregator memory; old events
# age out of the live timeline exactly like the exporter's ring drops —
# post-hoc analysis still has the full journals
MAX_EVENTS_PER_HOST = 50_000
# a host with no frame for this long shows as stale in /healthz and top
STALE_AFTER_S = 10.0


class _HostState:
    """Everything the aggregator knows about one ``(host, pid)``."""

    def __init__(self, host: str, pid: int):
        self.host = host
        self.pid = int(pid)
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        # gauge key -> (wall, value) history points (notes + tick diffs)
        self.points: deque = deque(maxlen=4096)
        self.events: deque = deque(maxlen=MAX_EVENTS_PER_HOST)
        self.flame: dict[str, int] = {}
        self.memory: dict = {}
        self.stream: dict = {}
        self.health: dict | None = None
        self.frames = 0
        self.lost_frames = 0          # transport gaps seen by US
        self.last_frame_seq = -1
        self.last_wall = 0.0

    def key(self) -> str:
        return f"{self.host}:{self.pid}"


class Aggregator:
    """Frame sink + live cluster state.  Thread-safe."""

    def __init__(self, *, rules=None, p99_slo_s: float = 0.5,
                 fast_window_s: float = 60.0, slow_window_s: float = 300.0,
                 step_time_slo_s: float | None = None):
        self._lock = threading.Lock()
        self._hosts: dict[tuple, _HostState] = {}
        self.started_wall = time.time()
        self.frames_ingested = 0
        self.manager = alerts.AlertManager(
            rules if rules is not None else live_default_rules(
                self, p99_slo_s=p99_slo_s, fast_window_s=fast_window_s,
                slow_window_s=slow_window_s,
                step_time_slo_s=step_time_slo_s))

    # -- ingest ------------------------------------------------------------

    def ingest(self, frame: dict) -> dict:
        """Apply one exporter frame; returns a small ack dict."""
        host = str(frame.get("host", "?"))
        pid = int(frame.get("pid", 0))
        key = (host, pid)
        with self._lock:
            hs = self._hosts.get(key)
            if hs is None:
                hs = self._hosts[key] = _HostState(host, pid)
            seq = frame.get("frame_seq")
            if isinstance(seq, int):
                if hs.last_frame_seq >= 0 and seq > hs.last_frame_seq + 1:
                    hs.lost_frames += seq - hs.last_frame_seq - 1
                if seq > hs.last_frame_seq:
                    hs.last_frame_seq = seq
            hs.counters.update(frame.get("counters") or {})
            gauges = frame.get("gauges") or {}
            hs.gauges.update(gauges)
            wall = float(frame.get("wall") or time.time())
            for k, v in gauges.items():
                hs.points.append((wall, k, float(v)))
            for p in frame.get("points") or ():
                try:
                    k, v, w = p[0], float(p[1]), float(p[2])
                except (TypeError, ValueError, IndexError):
                    continue
                hs.points.append((w, k, v))
                hs.gauges[k] = v     # a note is also the latest value
            for e in frame.get("events") or ():
                if isinstance(e, dict):
                    hs.events.append(e)
            for stack, n in (frame.get("flame") or {}).items():
                try:
                    hs.flame[stack] = hs.flame.get(stack, 0) + int(n)
                except (TypeError, ValueError):
                    continue
            if frame.get("memory"):
                hs.memory = frame["memory"]
            if frame.get("stream"):
                hs.stream = frame["stream"]
            if frame.get("health"):
                hs.health = frame["health"]
            hs.frames += 1
            hs.last_wall = wall
            self.frames_ingested += 1
        return {"ok": True, "host": hs.key(), "frames": hs.frames}

    # -- live signal reads (alert rules + dashboard) -----------------------

    def _states(self) -> list[_HostState]:
        with self._lock:
            return list(self._hosts.values())

    def gauge(self, name: str, *, agg: str = "max") -> float | None:
        """The gauge across hosts: ``max`` (worst host, the alerting
        default), ``min``, or ``sum``."""
        vals = []
        for hs in self._states():
            v = hs.gauges.get(name)
            if isinstance(v, (int, float)):
                vals.append(float(v))
        if not vals:
            return None
        if agg == "min":
            return min(vals)
        if agg == "sum":
            return float(sum(vals))
        return max(vals)

    def counter_total(self, name: str) -> float:
        """Sum a counter over all hosts and label sets."""
        prefix = name + "{"
        total = 0.0
        for hs in self._states():
            for k, v in hs.counters.items():
                if k == name or k.startswith(prefix):
                    total += float(v)
        return total

    def recent_points(self, name: str, *, horizon_s: float = 120.0) -> list:
        """``(wall, value)`` points for gauge ``name`` across hosts
        inside the horizon — the burn-window feed."""
        cut = time.time() - horizon_s
        prefix = name + "{"
        out = []
        for hs in self._states():
            for w, k, v in hs.points:
                if w >= cut and (k == name or k.startswith(prefix)):
                    out.append((w, v))
        out.sort()
        return out

    def evaluate(self, now: float | None = None) -> dict:
        """Drive the alert manager on the live stream."""
        return self.manager.evaluate(now)

    # -- merged views ------------------------------------------------------

    def merged_events(self, *, slack_s: float | None = None) -> list[dict]:
        """The live cluster timeline: every host's streamed event tail
        through the SAME three-tier alignment as the post-hoc merge."""
        streams = [list(hs.events) for hs in self._states() if hs.events]
        if not streams:
            return []
        kw = {} if slack_s is None else {"slack_s": slack_s}
        return cluster.merge_journals(streams, **kw)

    def flame_counts(self) -> dict[str, int]:
        merged: dict[str, int] = {}
        for hs in self._states():
            for stack, n in hs.flame.items():
                merged[stack] = merged.get(stack, 0) + n
        return merged

    def open_incidents(self) -> list[str]:
        """Incident ids seen on the stream with a begin and no end."""
        state: dict[str, bool] = {}
        for hs in self._states():
            for e in hs.events:
                if e.get("cat") != "incident":
                    continue
                inc = e.get("incident")
                if not inc:
                    continue
                if e.get("name") == "begin":
                    state.setdefault(inc, True)
                elif e.get("name") == "end":
                    state[inc] = False
        return sorted(i for i, open_ in state.items() if open_)

    # -- exports -----------------------------------------------------------

    def prometheus(self) -> str:
        """The whole cluster in Prometheus text exposition: every host's
        counters/gauges with a ``host`` label, the stream-health gauges
        (``da_tpu_stream_dropped_frames`` ...), and the aggregator's own
        alert gauges."""
        reg: dict = {"counters": {}, "gauges": {}, "histograms": {}}

        def _label(key: str, hs: _HostState) -> str:
            name, _, rest = key.partition("{")
            inner = rest[:-1] if rest.endswith("}") else rest
            parts = [p for p in (inner,) if p]
            parts.append(f"host={hs.key()}")
            return name + "{" + ",".join(parts) + "}"

        states = self._states()
        for hs in states:
            for k, v in hs.counters.items():
                reg["counters"][_label(k, hs)] = v
            for k, v in hs.gauges.items():
                reg["gauges"][_label(k, hs)] = v
            hk = f"host={hs.key()}"
            reg["gauges"][f"stream.dropped_frames{{{hk}}}"] = \
                float(hs.stream.get("frames_dropped", 0) or 0)
            reg["gauges"][f"stream.dropped_events{{{hk}}}"] = \
                float(hs.stream.get("events_dropped", 0) or 0)
            reg["gauges"][f"stream.lost_frames{{{hk}}}"] = \
                float(hs.lost_frames)
            reg["counters"][f"stream.frames{{{hk}}}"] = float(hs.frames)
            mem = hs.memory or {}
            if mem:
                reg["gauges"][f"hbm.live_bytes{{{hk}}}"] = \
                    float(mem.get("live_bytes", 0) or 0)
                reg["gauges"][f"hbm.peak_bytes{{{hk}}}"] = \
                    float(mem.get("peak_bytes", 0) or 0)
        # aggregator-local: firing alerts + totals (no host label)
        for name in self.manager.firing():
            reg["gauges"][f"alert.active{{alert={name}}}"] = 1.0
        reg["gauges"]["agg.hosts"] = float(len(states))
        reg["counters"]["agg.frames_ingested"] = float(self.frames_ingested)
        return export.to_prometheus(reg)

    def snapshot(self) -> dict:
        """The ``telemetry top`` payload: one dict per host plus the
        cluster-level alert/incident state."""
        now = time.time()
        hosts = {}
        for hs in self._states():
            mem = hs.memory or {}
            hosts[hs.key()] = {
                "host": hs.host,
                "pid": hs.pid,
                "age_s": round(max(now - hs.last_wall, 0.0), 3)
                if hs.last_wall else None,
                "stale": bool(hs.last_wall
                              and now - hs.last_wall > STALE_AFTER_S),
                "frames": hs.frames,
                "events": len(hs.events),
                "hbm_live_bytes": mem.get("live_bytes", 0),
                "hbm_peak_bytes": mem.get("peak_bytes", 0),
                "live_devices": hs.gauges.get("elastic.live_devices"),
                "serve_p99_s": hs.gauges.get("serve.request_p99_s"),
                "shed_fraction": self._shed_fraction(hs),
                "train_step_s": hs.gauges.get("train.step_s"),
                "dropped_frames": hs.stream.get("frames_dropped", 0),
                "dropped_events": hs.stream.get("events_dropped", 0),
                "lost_frames": hs.lost_frames,
                "lag_frames": hs.stream.get("lag_frames", 0),
            }
        return {
            "wall": round(now, 3),
            "uptime_s": round(now - self.started_wall, 1),
            "frames_ingested": self.frames_ingested,
            "hosts": hosts,
            "alerts": self.manager.firing(),
            "incidents": self.open_incidents(),
        }

    @staticmethod
    def _shed_fraction(hs: _HostState) -> float | None:
        shed = sub = 0.0
        for k, v in hs.counters.items():
            if k == "serve.shed" or k.startswith("serve.shed{"):
                shed += float(v)
            elif k == "serve.submitted" or \
                    k.startswith("serve.submitted{"):
                sub += float(v)
        if sub <= 0:
            return None
        return round(shed / sub, 4)


def live_default_rules(agg: Aggregator, *, p99_slo_s: float = 0.5,
                       shed_slo: float = 0.1,
                       step_time_slo_s: float | None = None,
                       hbm_budget_bytes: int | None = None,
                       hbm_slo: float = 0.9,
                       min_live_devices: int | None = None,
                       fast_window_s: float = 60.0,
                       slow_window_s: float = 300.0) -> list:
    """:func:`alerts.default_rules` re-aimed at the live stream: the
    same names, thresholds, burn windows and hysteresis, but every
    signal reads the aggregator's merged cross-host state instead of the
    local registry — plus a ``stream_drops`` rule that fires when any
    exporter is losing frames, so degraded observability is itself
    observable."""
    win = {"fast_window_s": fast_window_s, "slow_window_s": slow_window_s}

    def _shed_signal():
        last = {"shed": 0.0, "sub": 0.0}

        def signal():
            shed = agg.counter_total("serve.shed")
            sub = agg.counter_total("serve.submitted")
            d_shed, d_sub = shed - last["shed"], sub - last["sub"]
            last["shed"], last["sub"] = shed, sub
            if d_sub <= 0:
                return None
            return max(d_shed, 0.0) / d_sub
        return signal

    def _drops_signal():
        last = {"n": 0.0}

        def signal():
            total = 0.0
            for hs in agg._states():
                total += float(hs.stream.get("frames_dropped", 0) or 0)
                total += float(hs.lost_frames)
            delta = total - last["n"]
            last["n"] = total
            return max(delta, 0.0)
        return signal

    rules = [
        alerts.AlertRule("serve_p99",
                         lambda: agg.gauge("serve.request_p99_s"),
                         threshold=p99_slo_s, **win,
                         description=f"serve admitted p99 > {p99_slo_s}s "
                                     "on some host (live stream)"),
        alerts.AlertRule("serve_shed", _shed_signal(),
                         threshold=shed_slo, **win,
                         description=f"shed fraction > {shed_slo:.0%} "
                                     "(live stream)"),
        alerts.AlertRule("stream_drops", _drops_signal(),
                         threshold=0.0, **win,
                         description="exporter frames dropped or lost "
                                     "in transit"),
    ]
    if step_time_slo_s is not None:
        rules.append(alerts.AlertRule(
            "train_step_time", lambda: agg.gauge("train.step_s"),
            threshold=step_time_slo_s, **win,
            description=f"train step time > {step_time_slo_s}s "
                        "(live stream)"))
    if hbm_budget_bytes:
        bound = float(hbm_budget_bytes) * hbm_slo

        def _hbm():
            vals = [float((hs.memory or {}).get("live_bytes", 0) or 0)
                    for hs in agg._states()]
            return max(vals) if vals else None
        rules.append(alerts.AlertRule(
            "hbm_live", _hbm, threshold=bound, **win,
            description=f"HBM live bytes > {hbm_slo:.0%} of budget "
                        "on some host"))
    if min_live_devices is not None:
        rules.append(alerts.AlertRule(
            "live_devices",
            lambda: agg.gauge("elastic.live_devices", agg="min"),
            threshold=float(min_live_devices), op="<", **win,
            description=f"live devices < {min_live_devices} "
                        "on some host"))
    return rules


# ---------------------------------------------------------------------------
# HTTP service
# ---------------------------------------------------------------------------


_CHUNK = 64 * 1024


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "da-tpu-agg/1"

    # class attribute injected by AggServer
    agg: Aggregator = None  # type: ignore[assignment]

    def log_message(self, *a):  # noqa: D102 — silence per-request spam
        pass

    def setup(self):
        # track live keep-alive connections on the server so close()
        # can sever them: shutdown() only stops the accept loop, and an
        # exporter holding an HTTP/1.1 connection would otherwise keep
        # feeding a "closed" aggregator through its zombie handler
        super().setup()
        conns = getattr(self.server, "_live_conns", None)
        if conns is not None:
            conns.add(self.connection)

    def finish(self):
        conns = getattr(self.server, "_live_conns", None)
        if conns is not None:
            conns.discard(self.connection)
        super().finish()

    def _refuse_if_disabled(self) -> bool:
        if core.enabled():
            return False
        body = b"telemetry disabled (DA_TPU_TELEMETRY=0)\n"
        self.send_response(503)
        self.send_header("Content-Type", "text/plain")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)
        return True

    def _reply(self, code: int, body: bytes, ctype: str) -> None:
        try:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass              # client hung up mid-reply: not our problem

    def do_POST(self):  # noqa: N802 — http.server API
        if self._refuse_if_disabled():
            return
        if self.path.rstrip("/") != "/ingest":
            self._reply(404, b"unknown endpoint\n", "text/plain")
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            frame = json.loads(self.rfile.read(n))
            if not isinstance(frame, dict):
                raise ValueError("frame must be an object")
            ack = self.agg.ingest(frame)
        except (ValueError, KeyError, TypeError) as e:
            self._reply(400, f"bad frame: {e}\n".encode(), "text/plain")
            return
        self._reply(200, json.dumps(ack).encode() + b"\n",
                    "application/json")

    def do_GET(self):  # noqa: N802 — http.server API
        if self._refuse_if_disabled():
            return
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        if path == "/metrics":
            self._reply(200, self.agg.prometheus().encode(),
                        "text/plain; version=0.0.4")
        elif path == "/healthz":
            snap = self.agg.snapshot()
            body = json.dumps({
                "status": "ok",
                "hosts": len(snap["hosts"]),
                "stale_hosts": sorted(
                    k for k, h in snap["hosts"].items() if h["stale"]),
                "frames_ingested": snap["frames_ingested"],
                "alerts": snap["alerts"],
                "uptime_s": snap["uptime_s"],
            }).encode() + b"\n"
            self._reply(200, body, "application/json")
        elif path == "/snapshot":
            self._reply(200, json.dumps(self.agg.snapshot()).encode()
                        + b"\n", "application/json")
        elif path == "/flame":
            from . import stream as _stream
            body = _stream.collapsed_lines(self.agg.flame_counts())
            self._reply(200, body.encode() + b"\n", "text/plain")
        elif path == "/trace":
            self._send_trace()
        else:
            self._reply(404, b"unknown endpoint\n", "text/plain")

    def _send_trace(self) -> None:
        """The merged live timeline as a *chunked* Perfetto download —
        the trace can be large and is serialized piecewise, so the
        response starts immediately and no Content-Length is needed."""
        trace = export.to_perfetto(self.agg.merged_events())
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        buf = json.dumps(trace).encode()
        for i in range(0, len(buf), _CHUNK):
            chunk = buf[i:i + _CHUNK]
            self.wfile.write(b"%x\r\n" % len(chunk))
            self.wfile.write(chunk)
            self.wfile.write(b"\r\n")
        self.wfile.write(b"0\r\n\r\n")


class AggServer:
    """The aggregator behind a threading HTTP server plus its alert
    evaluation loop.  ``port=0`` binds an ephemeral port (tests)."""

    def __init__(self, aggregator: Aggregator | None = None, *,
                 host: str = "127.0.0.1", port: int = 0,
                 eval_interval_s: float = 0.5, **agg_kwargs):
        self.agg = aggregator or Aggregator(**agg_kwargs)
        handler = type("_BoundHandler", (_Handler,), {"agg": self.agg})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self._httpd._live_conns = set()
        self.host, self.port = self._httpd.server_address[:2]
        self.url = f"http://{self.host}:{self.port}"
        self._stop = threading.Event()
        self._eval_interval_s = max(0.05, float(eval_interval_s))
        self._threads = [
            threading.Thread(target=self._httpd.serve_forever,
                             name="da-tpu-agg-http", daemon=True),
            threading.Thread(target=self._eval_loop,
                             name="da-tpu-agg-eval", daemon=True),
        ]

    def _eval_loop(self) -> None:
        while not self._stop.wait(self._eval_interval_s):
            try:
                self.agg.evaluate()
            except Exception:
                pass

    def start(self) -> "AggServer":
        for t in self._threads:
            t.start()
        return self

    def close(self) -> None:
        self._stop.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        # sever lingering keep-alive connections so exporters observe
        # the death (and start counting drops) instead of feeding a
        # zombie handler thread
        import socket as _socket
        for conn in list(self._httpd._live_conns):
            try:
                conn.shutdown(_socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        self._httpd._live_conns.clear()

    def __enter__(self) -> "AggServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


def serve(*, host: str = "127.0.0.1", port: int = 0, advertise: bool = True,
          **kwargs) -> AggServer:
    """Start an :class:`AggServer` (returned running).  With
    ``advertise`` the URL is published to the multihost coordination KV
    so exporters on other hosts of the same job can discover it without
    per-host configuration."""
    srv = AggServer(host=host, port=port, **kwargs).start()
    if advertise:
        try:
            from ..parallel import multihost as _mh
            _mh.advertise_aggregator(srv.url)
        except Exception:
            pass
    return srv
