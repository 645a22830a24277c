"""Journal summarization: turn a JSONL event journal into a compact
human/machine summary.

PyTorch counterpart of ``distributedarrays_tpu/telemetry/summarize.py``
(its whole ``__all__``), kept as the port's own copy: pure stdlib, so a
journal pulled off a worker summarizes on any machine, and the same
journal gives the same summary through either package.  The one line
that differs names the port's incident reconstruction
(``telemetry.cluster``) where JAX's names its command-line front end,
which the port does not have yet.
"""

from __future__ import annotations

import json
from typing import Iterable, TextIO

__all__ = ["read_journal", "summarize", "format_summary"]


def read_journal(path_or_file) -> list[dict]:
    """Parse a JSONL journal.  Malformed lines are skipped and counted
    (a process killed mid-write leaves a torn final line; that must not
    make the whole journal unreadable)."""
    if hasattr(path_or_file, "read"):
        lines: Iterable[str] = path_or_file
    else:
        with open(path_or_file) as f:
            lines = f.readlines()
    events, skipped = [], 0
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            ev = json.loads(line)
        except ValueError:
            skipped += 1
            continue
        if isinstance(ev, dict):
            events.append(ev)
        else:
            skipped += 1
    if skipped:
        events.append({"cat": "_journal", "name": "malformed_lines",
                       "count": skipped})
    return events


def summarize(events: list[dict]) -> dict:
    """Aggregate a journal event list into the summary dict the CLI
    prints: counts by category and by (category, name), communication
    bytes/ops by kind — split into trace-time (``traced: true``) vs
    eager records — fallback hits by key, tracing-span rollups, and the
    monotonic time span covered."""
    by_cat: dict[str, int] = {}
    by_name: dict[str, int] = {}
    comm: dict[str, dict] = {}
    fallbacks: dict[str, int] = {}
    spans: dict[str, dict] = {}
    incidents: set = set()
    alerts: dict[str, int] = {}
    tuning: list[dict] = []
    # per-host rollups: multihost journals are merged by concatenation
    # (every event carries host/pid), so the summary re-groups them
    by_host: dict[str, dict] = {}
    tmin = tmax = None
    for e in events:
        cat = str(e.get("cat", "?"))
        by_cat[cat] = by_cat.get(cat, 0) + 1
        host = e.get("host")
        if host is not None:
            h = by_host.setdefault(str(host), {"events": 0, "comm_bytes": 0,
                                               "by_category": {}})
            h["events"] += 1
            h["by_category"][cat] = h["by_category"].get(cat, 0) + 1
            if cat == "comm":
                h["comm_bytes"] += int(e.get("bytes", 0) or 0)
        name = e.get("name")
        if name is not None:
            k = f"{cat}/{name}"
            by_name[k] = by_name.get(k, 0) + 1
        inc = e.get("incident")
        if inc:
            incidents.add(str(inc))
        if cat == "alert" and name is not None:
            ak = f"{name}:{e.get('state', '?')}"
            alerts[ak] = alerts.get(ak, 0) + 1
        if cat == "autotune" and name in ("advise", "undo"):
            # the advisor's provenance trail: what was written, from
            # which finding, and whether the micro-probe kept it
            tuning.append({k: e.get(k) for k in
                           ("name", "kernel", "key", "kind", "finding",
                            "old", "new", "status", "reason")
                           if e.get(k) is not None})
        if cat == "comm":
            kind = str(name)
            c = comm.setdefault(kind, {"ops": 0, "bytes": 0,
                                       "traced_ops": 0, "traced_bytes": 0,
                                       "eager_ops": 0, "eager_bytes": 0})
            b = int(e.get("bytes", 0) or 0)
            c["ops"] += 1
            c["bytes"] += b
            leg = "traced" if e.get("traced") else "eager"
            c[leg + "_ops"] += 1
            c[leg + "_bytes"] += b
        elif cat == "fallback" and name is not None:
            fallbacks[str(name)] = fallbacks.get(str(name), 0) + 1
        elif cat == "span" and name is not None:
            s = spans.setdefault(str(name),
                                 {"count": 0, "total_s": 0.0, "bytes": 0})
            s["count"] += 1
            s["total_s"] += float(e.get("dur", 0.0) or 0.0)
            # own + rolled-up child bytes: descendant comm may have landed
            # on aggregate-only child spans that never reach the journal
            s["bytes"] += int(e.get("bytes", 0) or 0) + \
                int(e.get("child_bytes", 0) or 0)
        t = e.get("t")
        if isinstance(t, (int, float)):
            tmin = t if tmin is None else min(tmin, t)
            tmax = t if tmax is None else max(tmax, t)
    for s in spans.values():
        s["total_s"] = round(s["total_s"], 6)
    return {
        "events": len(events),
        "hosts": sorted(by_host),
        "by_host": dict(sorted(by_host.items())),
        "span_s": round(tmax - tmin, 6) if tmin is not None else 0.0,
        "by_category": dict(sorted(by_cat.items())),
        "by_name": dict(sorted(by_name.items())),
        "comm": {
            "total_bytes": sum(c["bytes"] for c in comm.values()),
            "total_ops": sum(c["ops"] for c in comm.values()),
            "traced_bytes": sum(c["traced_bytes"] for c in comm.values()),
            "eager_bytes": sum(c["eager_bytes"] for c in comm.values()),
            "by_kind": dict(sorted(comm.items())),
        },
        "fallbacks": dict(sorted(fallbacks.items(),
                                 key=lambda kv: (-kv[1], kv[0]))),
        "spans": dict(sorted(spans.items())),
        "incidents": sorted(incidents),
        "alerts": dict(sorted(alerts.items())),
        "tuning": tuning,
    }


def _fmt_bytes(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{n} B"
        n /= 1024
    return f"{n} B"  # pragma: no cover


def format_summary(summary: dict, out: TextIO) -> None:
    """Render :func:`summarize`'s dict as an aligned text table."""
    out.write(f"events: {summary['events']}  "
              f"(span {summary['span_s']:.3f}s)\n")
    hosts = summary.get("hosts") or []
    if len(hosts) > 1:
        # merged multihost journal: group the tables per host first
        out.write(f"\nhosts ({len(hosts)}):\n")
        for host in hosts:
            h = summary["by_host"][host]
            cats = ", ".join(f"{c}={n}" for c, n in
                             sorted(h["by_category"].items()))
            out.write(f"  {host:<24} {h['events']:>7} events  "
                      f"{_fmt_bytes(h['comm_bytes'])} comm  [{cats}]\n")
    incidents = summary.get("incidents") or []
    if incidents:
        out.write(f"\nincidents ({len(incidents)}): "
                  f"{', '.join(incidents)}\n")
        out.write("  (reconstruct: telemetry.cluster.reconstruct_incidents"
                  "(merge_journals([journal, ...])))\n")
    alerts = summary.get("alerts") or {}
    if alerts:
        out.write("\nalert transitions:\n")
        for key, n in alerts.items():
            out.write(f"  {key:<40} {n}\n")
    tuning = summary.get("tuning") or []
    if tuning:
        out.write("\ntuning provenance (advisor writes):\n")
        for t in tuning:
            label = t.get("status") or t.get("name") or "?"
            out.write(f"  {label.upper():<12} "
                      f"{t.get('kernel', '?')}[{t.get('key', '?')}]: "
                      f"{t.get('old')} -> {t.get('new')}"
                      + (f"  ({t['finding']})" if t.get("finding")
                         else "") + "\n")
            if t.get("reason"):
                out.write(f"               {t['reason']}\n")
    out.write("\nby category:\n")
    for cat, n in summary["by_category"].items():
        out.write(f"  {cat:<16} {n}\n")
    comm = summary["comm"]
    out.write(f"\ncommunication (estimated): "
              f"{_fmt_bytes(comm['total_bytes'])} over "
              f"{comm['total_ops']} ops")
    if comm.get("traced_bytes") or comm.get("eager_bytes"):
        out.write(f"  (eager {_fmt_bytes(comm.get('eager_bytes', 0))}, "
                  f"traced {_fmt_bytes(comm.get('traced_bytes', 0))})")
    out.write("\n")
    for kind, c in comm["by_kind"].items():
        out.write(f"  {kind:<20} {c['ops']:>6} ops  "
                  f"{_fmt_bytes(c['bytes'])}")
        if "eager_bytes" in c:
            out.write(f"  [eager {_fmt_bytes(c['eager_bytes'])}, "
                      f"traced {_fmt_bytes(c['traced_bytes'])}]")
        out.write("\n")
    spans = summary.get("spans") or {}
    if spans:
        out.write("\nspans (journaled):\n")
        top_spans = sorted(spans.items(),
                           key=lambda kv: -kv[1]["total_s"])[:20]
        for name, s in top_spans:
            out.write(f"  {name:<28} {s['count']:>6} x  "
                      f"{s['total_s']:>10.4f}s  {_fmt_bytes(s['bytes'])}\n")
    fallbacks = summary.get("fallbacks") or {}
    if fallbacks:
        out.write("\ntop fallback keys:\n")
        for key, n in list(fallbacks.items())[:5]:
            out.write(f"  {key:<40} {n}\n")
    out.write("\ntop events:\n")
    top = sorted(summary["by_name"].items(), key=lambda kv: -kv[1])[:20]
    for name, n in top:
        out.write(f"  {name:<40} {n}\n")
