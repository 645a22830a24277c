"""CLI: summarize or export a telemetry journal / report / bundle.

The port's copy of ``distributedarrays_tpu/telemetry/__main__.py``: every
subcommand prints what JAX's prints on the same input, but ``advise``,
which exits 2 naming its ROADMAP entry (the advisor is not ported).

Usage::

    python -m distributedarrays_tpu_torch.telemetry summarize RUN.jsonl [--json]
    python -m distributedarrays_tpu_torch.telemetry trace RUN.jsonl [-o out.json]
    python -m distributedarrays_tpu_torch.telemetry prom REPORT.json [-o out.prom]
    python -m distributedarrays_tpu_torch.telemetry mem RUN.jsonl|REPORT.json [--json]
    python -m distributedarrays_tpu_torch.telemetry postmortem BUNDLE.json [--json]
    python -m distributedarrays_tpu_torch.telemetry doctor RUN.jsonl [--platform P]
        [--min-findings N] [--json]
    python -m distributedarrays_tpu_torch.telemetry regress FRESH.json
        [--baseline DIR_OR_FILE ...] [--json] [--strict] [--explain]
    python -m distributedarrays_tpu_torch.telemetry advise RUN.jsonl
        [--apply] [--json] [--platform P] [--min-actions N]
    python -m distributedarrays_tpu_torch.telemetry incident RUN.jsonl [RUN2.jsonl
        ...] [--bundles DIR_OR_FILE ...] [--json] [--trace OUT.json]
        [--strict-bundles]
    python -m distributedarrays_tpu_torch.telemetry flame RUN.jsonl [--min-frac F]
    python -m distributedarrays_tpu_torch.telemetry flame --url http://AGG:PORT
    python -m distributedarrays_tpu_torch.telemetry top --url http://AGG:PORT
        [--interval S] [--once] [--json]
    python -m distributedarrays_tpu_torch.telemetry agg [--port 9900]
        [--p99-slo S] [--duration S]
    python -m distributedarrays_tpu_torch.telemetry stream RUN.jsonl
        --agg http://AGG:PORT [--interval S] [--duration S]
    python -m distributedarrays_tpu_torch.telemetry RUN.jsonl [--json]   # legacy

``summarize`` prints event counts by category (grouped per host when the
journal spans more than one), communication bytes by kind (eager vs
traced), span rollups, and top fallback keys; ``trace`` converts a
journal to Perfetto/Chrome trace-event JSON (open at ui.perfetto.dev) —
including an ``hbm_bytes`` counter track; ``prom`` renders a
``telemetry.dump()`` report — or, given a journal, the registry
reconstructed from it — in Prometheus text exposition format; ``mem``
renders the HBM-ledger view (live/peak bytes, per-device when given a
report, the alloc/free timeline reconstruction when given a journal);
``postmortem`` renders a flight-recorder bundle; ``doctor`` runs the
performance observatory (roofline classification of cost-stamped spans,
comm/compute overlap, the critical path, ranked findings — see
``telemetry/perf.py``); ``regress`` judges a fresh bench run against the
banked ``BENCH_r*`` trajectory with noise-aware thresholds and exits 1
on a significant slowdown (``telemetry/regress.py``); ``incident``
merges one or more per-host journals onto a single timeline and
reconstructs ordered incident reports from them plus any flight bundles
(``telemetry/cluster.py``) — ``--trace`` additionally writes the merged
Perfetto trace with incident flow arrows, and ``--strict-bundles``
exits 1 if any bundle or recovery attempt could not be attributed (the
CI orphan gate).  The live-plane commands (``docs/telemetry.md``):
``flame`` renders collapsed-stack flame format (Brendan Gregg style,
feed to flamegraph.pl or speedscope) from a journal's span self-times —
or, with ``--url``, the continuous sampling profile of a live
aggregator; ``top`` is the real-time cluster dashboard refreshing from
an aggregator's ``/snapshot``; ``agg`` runs the streaming aggregator
(POST ``/ingest``, Prometheus ``/metrics``, ``/healthz``,
``/snapshot``, ``/flame``, chunked Perfetto ``/trace``); ``stream`` is
the out-of-process exporter, tailing a journal file (rotation-aware)
and shipping bounded delta frames to an aggregator.  ``-`` reads
stdin.  The first form without a subcommand is the original interface and
behaves exactly like ``summarize``.

A missing or empty journal exits with a one-line message and status 2
instead of a traceback.  At the size cap journals now ROTATE to
``<path>.1`` (the ``incident``/``summarize`` readers pick the sibling up
automatically); a legacy ``journal.capped`` latch from an older writer
still exits 2 with the truncation details.

The converters (``summarize.py``, ``export.py``, ``memory.py``) are pure
stdlib; running via ``-m`` imports the parent package (PyTorch present),
so on a machine without it import those modules directly instead.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys

from .export import to_perfetto, to_prometheus
from .summarize import read_journal, summarize, format_summary, _fmt_bytes


def _read_events(path: str) -> list[dict]:
    if path == "-":
        return read_journal(sys.stdin)
    events: list[dict] = []
    if os.path.exists(path + ".1"):
        # rotated sibling from the size cap: oldest generation first so
        # the timeline reads in order
        events.extend(read_journal(path + ".1"))
    events.extend(read_journal(path))
    return events


class _JournalUnusable(Exception):
    """One-line diagnostic; the CLI prints it and exits 2."""


def _check_events(events: list[dict], path: str) -> list[dict]:
    if not events:
        raise _JournalUnusable(f"journal is empty: {path}")
    cap = next((e for e in events
                if e.get("cat") == "journal" and e.get("name") == "capped"),
               None)
    if cap is not None:
        # legacy latch (pre-rotation writers, or a writer whose rotation
        # os.replace failed): the file is truncated, not rotated
        raise _JournalUnusable(
            f"journal is cap-truncated: {path} stopped at "
            f"{cap.get('bytes_written', '?')} bytes "
            f"(max {cap.get('max_bytes', '?')}; journal.capped at "
            f"t={cap.get('t', '?')}) — raise "
            f"DA_TPU_TELEMETRY_JOURNAL_MAX_MB and rerun "
            f"(current writers rotate to {path}.1 instead)")
    return events


def _read_events_checked(path: str) -> list[dict]:
    return _check_events(_read_events(path), path)


def _write_out(text: str, out_path: str | None) -> None:
    if out_path and out_path != "-":
        with open(out_path, "w") as f:
            f.write(text)
    else:
        sys.stdout.write(text)


def _cmd_summarize(args) -> int:
    s = summarize(_read_events_checked(args.journal))
    if args.json:
        json.dump(s, sys.stdout, indent=2, sort_keys=True)
        sys.stdout.write("\n")
    else:
        format_summary(s, sys.stdout)
    return 0


def _cmd_trace(args) -> int:
    trace = to_perfetto(_read_events_checked(args.journal))
    _write_out(json.dumps(trace, indent=None if args.out else 2) + "\n",
               args.out)
    return 0


def _registry_from_journal(events: list[dict]) -> dict:
    """Rebuild a report-shaped registry from a journal so ``prom`` works
    on either input: comm kinds and span rollups survive; counters that
    never hit the journal (hot-path increments) do not."""
    s = summarize(events)
    return {
        "counters": {f"journal.events{{cat={c}}}": n
                     for c, n in s["by_category"].items()},
        "gauges": {}, "histograms": {},
        "comm": {"total_bytes": s["comm"]["total_bytes"],
                 "total_ops": s["comm"]["total_ops"],
                 "by_kind": s["comm"]["by_kind"]},
        "spans": {"by_name": {k: {"count": v["count"],
                                  "total_s": v["total_s"],
                                  "self_s": 0.0, "bytes": v["bytes"]}
                              for k, v in s["spans"].items()}},
        "memory": _mem_from_journal(events),
        "events": {"recorded": s["events"]},
    }


def _cmd_prom(args) -> int:
    raw = sys.stdin.read() if args.report == "-" else \
        open(args.report).read()
    try:
        doc = json.loads(raw)
    except ValueError:
        doc = None
    if isinstance(doc, dict) and "counters" in doc:
        registry = doc                      # a telemetry.dump() report
    else:                                   # a JSONL journal
        events = _check_events(read_journal(io.StringIO(raw)), args.report)
        registry = _registry_from_journal(events)
    _write_out(to_prometheus(registry), args.out)
    return 0


# ---------------------------------------------------------------------------
# mem: the HBM-ledger view
# ---------------------------------------------------------------------------


def _mem_from_journal(events: list[dict]) -> dict:
    """Reconstruct the ledger timeline from a journal's ``hbm`` events:
    final/peak live bytes, alloc/free counts, staging peaks per tag,
    and top allocation sites by bytes allocated."""
    live = peak = allocs = frees = 0
    staging_peak = 0
    staging_tags: dict[str, int] = {}
    sites: dict[str, dict] = {}
    for e in events:
        if e.get("cat") != "hbm":
            continue
        name = e.get("name")
        if e.get("live") is not None:
            live = int(e["live"])
            peak = max(peak, live)
        if name == "alloc":
            allocs += 1
            site = str(e.get("site") or "?")
            s = sites.setdefault(site, {"bytes": 0, "count": 0})
            s["bytes"] += int(e.get("bytes", 0) or 0)
            s["count"] += 1
        elif name == "free":
            frees += 1
        elif name == "staging":
            sl = int(e.get("staging_live", 0) or 0)
            staging_peak = max(staging_peak, sl)
            tag = str(e.get("tag") or "?")
            staging_tags[tag] = max(staging_tags.get(tag, 0), sl)
    return {
        "live_bytes": live, "peak_bytes": peak,
        "allocs": allocs, "frees": frees,
        "staging": {"peak_bytes": staging_peak,
                    "peak_by_tag": dict(sorted(staging_tags.items()))},
        "top_sites": sorted(([k, v["bytes"], v["count"]]
                             for k, v in sites.items()),
                            key=lambda kv: -kv[1])[:10],
    }


def _format_mem(mem: dict, out) -> None:
    out.write(f"hbm live:  {_fmt_bytes(mem.get('live_bytes', 0))}\n")
    out.write(f"hbm peak:  {_fmt_bytes(mem.get('peak_bytes', 0))}\n")
    if "tracked_arrays" in mem:
        out.write(f"tracked arrays: {mem['tracked_arrays']}\n")
    if "allocs" in mem:
        out.write(f"allocs/frees:   {mem['allocs']}/{mem['frees']}\n")
    by_dev = mem.get("by_device") or {}
    if by_dev:
        out.write("per device:\n")
        for dev, d in sorted(by_dev.items()):
            out.write(f"  dev {dev:<6} live {_fmt_bytes(d['live_bytes']):>12}"
                      f"  peak {_fmt_bytes(d['peak_bytes']):>12}\n")
    st = mem.get("staging") or {}
    if st:
        out.write(f"staging peak: {_fmt_bytes(st.get('peak_bytes', 0))}\n")
        for tag, v in (st.get("peak_by_tag") or {}).items():
            out.write(f"  {tag:<28} {_fmt_bytes(v)}\n")
    sites = mem.get("top_sites") or []
    if sites:
        out.write("top allocation sites:\n")
        for site, b, n in sites:
            out.write(f"  {site:<28} {n:>5} x  {_fmt_bytes(b)}\n")


def _cmd_mem(args) -> int:
    raw = sys.stdin.read() if args.input == "-" else open(args.input).read()
    try:
        doc = json.loads(raw)
    except ValueError:
        doc = None
    if isinstance(doc, dict) and "memory" in doc:
        mem = doc["memory"]                  # a telemetry.dump() report
    elif isinstance(doc, dict) and "live_bytes" in doc:
        mem = doc                            # a bare memory section
    else:                                    # a JSONL journal
        events = _check_events(read_journal(io.StringIO(raw)), args.input)
        mem = _mem_from_journal(events)
    if args.json:
        json.dump(mem, sys.stdout, indent=2, sort_keys=True)
        sys.stdout.write("\n")
    else:
        _format_mem(mem, sys.stdout)
    return 0


# ---------------------------------------------------------------------------
# doctor: the performance observatory
# ---------------------------------------------------------------------------


def _cmd_doctor(args) -> int:
    from . import perf
    events = _read_events_checked(args.journal)
    analysis = perf.analyze(events, platform=args.platform)
    if args.json:
        json.dump(analysis, sys.stdout, indent=2, sort_keys=True)
        sys.stdout.write("\n")
    else:
        perf.format_analysis(analysis, sys.stdout)
    if args.min_findings and len(analysis["findings"]) < args.min_findings:
        print(f"doctor: {len(analysis['findings'])} finding(s), "
              f"required at least {args.min_findings}", file=sys.stderr)
        return 2
    return 0


# ---------------------------------------------------------------------------
# regress: the bench regression sentinel
# ---------------------------------------------------------------------------


def _cmd_regress(args) -> int:
    from . import regress as rg
    try:
        with open(args.fresh) as f:
            fresh_doc = json.load(f)
    except ValueError:
        print(f"regress: not JSON: {args.fresh}", file=sys.stderr)
        return 2
    row = fresh_doc.get("parsed") if isinstance(fresh_doc, dict) and \
        isinstance(fresh_doc.get("parsed"), dict) else fresh_doc
    if isinstance(row, dict) and rg.is_replay(row):
        # a replay is the OLD number wearing a new timestamp — judging it
        # would always pass; say so loudly and judge nothing
        print(f"SKIPPED: {args.fresh} is a replayed row, not a fresh "
              "measurement — nothing to judge", file=sys.stdout)
        return 2 if args.strict else 0
    fresh = rg.load_rows(args.fresh)
    if not fresh:
        print(f"regress: no judgeable metrics in {args.fresh}",
              file=sys.stderr)
        return 2
    baseline = rg.load_baseline(args.baseline or ["."])
    if not any(baseline.values()):
        # an empty or all-replay bank is not a baseline: every banked row
        # was itself a replay of an older number, so there is no live
        # trajectory to judge drift against
        print("NO_LIVE_TRAJECTORY: banked baseline has no live "
              "measurements (empty or all replays) — nothing to judge "
              "against", file=sys.stdout)
        return 2 if args.strict else 0
    results = rg.compare(fresh, baseline, mad_k=args.mad_k,
                         rel_floor=args.rel_floor)
    if args.json:
        json.dump({"results": results}, sys.stdout, indent=2,
                  sort_keys=True)
        sys.stdout.write("\n")
    else:
        rg.format_results(results, sys.stdout, explain=args.explain)
    judged = [r for r in results if r["status"] != "skipped"]
    if not judged:
        print("regress: no metric had a banked baseline to judge "
              "against", file=sys.stderr)
        return 2 if args.strict else 0
    if any(r["status"] == "regression" for r in judged):
        return 1
    return 0


# ---------------------------------------------------------------------------
# advise: doctor findings -> guarded autotune writes
# ---------------------------------------------------------------------------


def _cmd_advise(args) -> int:
    print("advise: the tuning advisor is not ported yet; its knobs (the "
          "GEMM block, rdma_chunks, rdma_dispatch) have no counterpart in "
          "the port's kernels (ROADMAP.md queue A, \"telemetry/advisor.py "
          "and the command line's advise\")", file=sys.stderr)
    return 2


# ---------------------------------------------------------------------------
# incident: cross-host merge + causal incident reconstruction
# ---------------------------------------------------------------------------


def _cmd_incident(args) -> int:
    from . import cluster
    per_host: list[list[dict]] = []
    for path in args.journals:
        evs = _check_events(_read_events(path), path)
        per_host.append(evs)
    merged = cluster.merge_journals(per_host, slack_s=args.slack)
    try:
        bundles = cluster.load_bundles(args.bundles or [])
    except ValueError as e:
        print(f"incident: {e}", file=sys.stderr)
        return 2
    report = cluster.reconstruct_incidents(merged, bundles,
                                           slack_s=args.slack)
    if args.trace:
        trace = cluster.incident_trace(merged, report)
        with open(args.trace, "w") as f:
            json.dump(trace, f)
        print(f"merged trace with incident flows -> {args.trace}",
              file=sys.stderr)
    if args.json:
        json.dump(report, sys.stdout, indent=2, sort_keys=True)
        sys.stdout.write("\n")
    else:
        cluster.format_incidents(report, sys.stdout)
    if args.strict_bundles and (report["bundles_unattributed"]
                                or report["unattributed_recovery_events"]):
        print(f"incident: {len(report['bundles_unattributed'])} orphaned "
              f"bundle(s), {report['unattributed_recovery_events']} "
              f"unattributed recovery event(s) — reconstruction is "
              f"incomplete", file=sys.stderr)
        return 1
    return 0


# ---------------------------------------------------------------------------
# postmortem: render a flight-recorder bundle
# ---------------------------------------------------------------------------


def _cmd_postmortem(args) -> int:
    raw = sys.stdin.read() if args.bundle == "-" else open(args.bundle).read()
    try:
        b = json.loads(raw)
    except ValueError:
        print(f"not a postmortem bundle (invalid JSON): {args.bundle}",
              file=sys.stderr)
        return 2
    if not isinstance(b, dict) or b.get("kind") != "da_tpu_postmortem":
        print(f"not a postmortem bundle: {args.bundle}", file=sys.stderr)
        return 2
    if args.json:
        json.dump(b, sys.stdout, indent=2, sort_keys=True)
        sys.stdout.write("\n")
        return 0
    out = sys.stdout
    out.write(f"postmortem: {b.get('reason')}  "
              f"(host {b.get('host')}, pid {b.get('pid')}, "
              f"t={b.get('t')}s)\n")
    exc = b.get("exception")
    if exc:
        out.write(f"exception: {exc.get('type')}: "
                  f"{str(exc.get('message', ''))[:500]}\n")
    opens = b.get("open_spans") or []
    out.write(f"\nopen spans at crash ({len(opens)}):\n")
    for s in opens:
        out.write(f"  {s.get('name'):<28} id={s.get('span_id')} "
                  f"tname={s.get('tname')}\n")
    _format_mem(b.get("ledger") or {}, out)
    census = b.get("registry_census") or {}
    out.write(f"\nregistry census: {census.get('live', '?')} live arrays\n")
    leak = b.get("leak_census") or {}
    for klass in ("ledger_tracked", "untracked_foreign",
                  "deleted_but_registered"):
        c = leak.get(klass) or {}
        out.write(f"  {klass:<24} {c.get('count', 0):>5} x  "
                  f"{_fmt_bytes(c.get('bytes', 0))}\n")
    div = b.get("divergence") or []
    if div:
        out.write(f"\ndivergence events ({len(div)}):\n")
        for e in div[-5:]:
            out.write(f"  t={e.get('t')} {e.get('why', '')[:120]}\n")
    ring = b.get("ring") or []
    out.write(f"\nevent ring tail ({len(ring)} events, last 10):\n")
    for e in ring[-10:]:
        out.write(f"  t={e.get('t')} {e.get('cat')}/{e.get('name')}\n")
    return 0


# ---------------------------------------------------------------------------
# live plane: flame / top / agg / stream
# ---------------------------------------------------------------------------


def _http_get(url: str, path: str, timeout: float = 5.0) -> bytes:
    import urllib.request
    base = url.rstrip("/")
    if not base.startswith("http://") and not base.startswith("https://"):
        base = "http://" + base
    with urllib.request.urlopen(base + path, timeout=timeout) as r:
        return r.read()


def _cmd_flame(args) -> int:
    from . import stream as _stream
    if args.url:
        try:
            text = _http_get(args.url, "/flame").decode()
        except OSError as e:
            print(f"cannot reach aggregator {args.url}: {e}",
                  file=sys.stderr)
            return 2
        _write_out(text if text.endswith("\n") or not text else text + "\n",
                   args.out)
        return 0
    if not args.journal:
        print("flame: need a journal path or --url", file=sys.stderr)
        return 2
    events = _read_events_checked(args.journal)
    counts, stats = _stream.collapsed_from_events(events)
    if args.json:
        _write_out(json.dumps({"counts": counts, "stats": stats},
                              indent=2, sort_keys=True) + "\n", args.out)
    else:
        text = _stream.collapsed_lines(counts)
        _write_out(text + "\n" if text else "", args.out)
        print(f"flame: {stats['spans']} spans, "
              f"{stats['attributed_s']:.3f}s attributed / "
              f"{stats['wall_s']:.3f}s wall "
              f"({stats['attributed_frac']:.1%})", file=sys.stderr)
    if args.min_frac and stats["attributed_frac"] < args.min_frac:
        print(f"flame attribution {stats['attributed_frac']:.1%} below "
              f"--min-frac {args.min_frac:.1%}", file=sys.stderr)
        return 2
    return 0


def _fmt_ms(v) -> str:
    return "-" if v is None else f"{float(v) * 1e3:8.1f}"


def _render_top(snap: dict) -> str:
    out = io.StringIO()
    hosts = snap.get("hosts") or {}
    out.write(f"da-tpu top — {len(hosts)} host(s), "
              f"uptime {snap.get('uptime_s', 0)}s, "
              f"{snap.get('frames_ingested', 0)} frames ingested\n\n")
    hdr = (f"{'HOST':<20} {'AGE':>5} {'HBM LIVE':>10} {'PEAK':>10} "
           f"{'DEV':>4} {'P99 ms':>8} {'SHED':>6} {'STEP s':>8} "
           f"{'DROP':>5} {'EVTS':>7}")
    out.write(hdr + "\n")
    for key in sorted(hosts):
        h = hosts[key]
        age = h.get("age_s")
        age_s = "-" if age is None else f"{age:.1f}"
        if h.get("stale"):
            age_s += "!"
        shed = h.get("shed_fraction")
        step = h.get("train_step_s")
        dev = h.get("live_devices")
        drops = (int(h.get("dropped_frames") or 0)
                 + int(h.get("lost_frames") or 0))
        shed_s = f"{shed:.1%}" if shed is not None else "-"
        step_s = f"{step:.3f}" if step is not None else "-"
        dev_s = str(dev) if dev is not None else "-"
        out.write(
            f"{key:<20} {age_s:>5} "
            f"{_fmt_bytes(h.get('hbm_live_bytes') or 0):>10} "
            f"{_fmt_bytes(h.get('hbm_peak_bytes') or 0):>10} "
            f"{dev_s:>4} {_fmt_ms(h.get('serve_p99_s')):>8} "
            f"{shed_s:>6} {step_s:>8} "
            f"{drops:>5} {h.get('events', 0):>7}\n")
    alerts = snap.get("alerts") or []
    out.write(f"\nalerts firing: "
              f"{', '.join(sorted(alerts)) if alerts else 'none'}\n")
    incidents = snap.get("incidents") or []
    if incidents:
        out.write(f"open incidents: {', '.join(incidents)}\n")
    return out.getvalue()


def _cmd_top(args) -> int:
    import time as _time

    def _snap():
        return json.loads(_http_get(args.url, "/snapshot").decode())

    try:
        snap = _snap()
    except OSError as e:
        print(f"cannot reach aggregator {args.url}: {e}", file=sys.stderr)
        return 2
    except ValueError:
        print(f"aggregator {args.url} returned non-JSON snapshot "
              f"(telemetry disabled on the aggregator?)", file=sys.stderr)
        return 2
    if args.json:
        json.dump(snap, sys.stdout, indent=2, sort_keys=True)
        sys.stdout.write("\n")
        return 0
    if args.once:
        sys.stdout.write(_render_top(snap))
        return 0
    try:
        while True:
            # home + clear-to-end keeps the repaint flicker-free without
            # pulling in curses
            sys.stdout.write("\x1b[H\x1b[2J" + _render_top(snap))
            sys.stdout.flush()
            _time.sleep(max(0.1, args.interval))
            try:
                snap = _snap()
            except (OSError, ValueError):
                sys.stdout.write("\n(aggregator unreachable — retrying)\n")
                sys.stdout.flush()
    except KeyboardInterrupt:
        return 0


def _cmd_agg(args) -> int:
    import time as _time
    from . import core as _core
    from . import agg as _agg
    if not _core.enabled():
        print("telemetry is disabled (DA_TPU_TELEMETRY=0): "
              "aggregator refusing to start", file=sys.stderr)
        return 2
    srv = _agg.serve(host=args.host, port=args.port,
                     advertise=not args.no_advertise,
                     eval_interval_s=args.eval_interval,
                     p99_slo_s=args.p99_slo)
    print(f"aggregator listening on {srv.url}", file=sys.stderr)
    print(f"  POST {srv.url}/ingest     (exporter frames)", file=sys.stderr)
    print(f"  GET  {srv.url}/metrics    (Prometheus scrape)",
          file=sys.stderr)
    print(f"  GET  {srv.url}/healthz /snapshot /flame /trace",
          file=sys.stderr)
    try:
        if args.duration:
            _time.sleep(args.duration)
        else:
            while True:
                _time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        srv.close()
    return 0


def _cmd_stream(args) -> int:
    import time as _time
    from . import core as _core
    from . import stream as _stream
    if not _core.enabled():
        print("telemetry is disabled (DA_TPU_TELEMETRY=0): "
              "exporter refusing to start", file=sys.stderr)
        return 2
    if not os.path.exists(args.journal):
        print(f"cannot read journal: {args.journal}", file=sys.stderr)
        return 2
    exp = _stream.StreamExporter(args.agg, interval_s=args.interval,
                                 ring_frames=args.ring,
                                 journal=args.journal)
    exp.start()
    print(f"streaming {args.journal} -> {args.agg} "
          f"every {args.interval}s (ring {args.ring} frames)",
          file=sys.stderr)
    try:
        if args.duration:
            _time.sleep(args.duration)
        else:
            while True:
                _time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        exp.stop()
    st = exp.stats_dict()
    print(f"stream: {st['frames_sent']} frames sent, "
          f"{st['frames_dropped']} dropped, "
          f"{st['events_shipped']} events shipped, "
          f"{st['events_dropped']} events dropped, "
          f"{st['send_errors']} send errors", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in ("summarize", "trace", "prom", "mem",
                            "postmortem", "doctor", "regress", "incident",
                            "advise", "flame", "top", "agg", "stream"):
        ap = argparse.ArgumentParser(
            prog="python -m distributedarrays_tpu_torch.telemetry",
            description="Summarize or export a telemetry journal/report.")
        sub = ap.add_subparsers(dest="cmd", required=True)
        p = sub.add_parser("summarize", help="journal -> text/JSON summary")
        p.add_argument("journal", help="JSONL journal path ('-' = stdin)")
        p.add_argument("--json", action="store_true",
                       help="emit the summary as JSON")
        p.set_defaults(fn=_cmd_summarize)
        p = sub.add_parser("trace",
                           help="journal -> Perfetto trace-event JSON")
        p.add_argument("journal", help="JSONL journal path ('-' = stdin)")
        p.add_argument("-o", "--out", default=None,
                       help="output path (default stdout)")
        p.set_defaults(fn=_cmd_trace)
        p = sub.add_parser("prom",
                           help="report JSON (telemetry.dump) or journal "
                                "-> Prometheus text exposition")
        p.add_argument("report", help="report/journal path ('-' = stdin)")
        p.add_argument("-o", "--out", default=None,
                       help="output path (default stdout)")
        p.set_defaults(fn=_cmd_prom)
        p = sub.add_parser("mem",
                           help="HBM ledger view of a journal or report")
        p.add_argument("input", help="journal/report path ('-' = stdin)")
        p.add_argument("--json", action="store_true",
                       help="emit the memory section as JSON")
        p.set_defaults(fn=_cmd_mem)
        p = sub.add_parser("postmortem",
                           help="render a flight-recorder bundle")
        p.add_argument("bundle", help="bundle path ('-' = stdin)")
        p.add_argument("--json", action="store_true",
                       help="re-emit the bundle as JSON")
        p.set_defaults(fn=_cmd_postmortem)
        p = sub.add_parser("doctor",
                           help="journal -> roofline/overlap/critical-path"
                                " findings")
        p.add_argument("journal", help="JSONL journal path ('-' = stdin)")
        p.add_argument("--platform", default=None,
                       help="peak-table platform (v5e/v5p/cpu; default "
                            "cpu, DA_TPU_PEAKS overrides values)")
        p.add_argument("--min-findings", type=int, default=0,
                       help="exit 2 unless at least N findings (CI gate)")
        p.add_argument("--json", action="store_true",
                       help="emit the full analysis as JSON")
        p.set_defaults(fn=_cmd_doctor)
        p = sub.add_parser("regress",
                           help="judge a fresh bench row/table against "
                                "the banked BENCH_r* trajectory")
        p.add_argument("fresh", help="fresh bench row / BENCH_r wrapper / "
                                     "details table (JSON)")
        p.add_argument("--baseline", action="append", default=None,
                       help="baseline dir (BENCH_r*.json scanned) or "
                            "file; repeatable; default '.'")
        p.add_argument("--mad-k", type=float, default=3.0,
                       help="MAD multiplier for the noise threshold")
        p.add_argument("--rel-floor", type=float, default=0.15,
                       help="relative degradation floor")
        p.add_argument("--strict", action="store_true",
                       help="exit 2 when nothing could be judged")
        p.add_argument("--explain", action="store_true",
                       help="print the per-metric median/MAD baseline "
                            "and direction next to each verdict")
        p.add_argument("--json", action="store_true",
                       help="emit results as JSON")
        p.set_defaults(fn=_cmd_regress)
        p = sub.add_parser("advise",
                           help="doctor findings -> tuning actions; "
                                "--apply executes them under the "
                                "micro-probe rollback guard")
        p.add_argument("journal", help="JSONL journal path ('-' = stdin)")
        p.add_argument("--platform", default=None,
                       help="peak-table platform for the doctor pass")
        p.add_argument("--apply", action="store_true",
                       help="write the proposals (provenance-stamped), "
                            "micro-probe before/after, auto-roll-back "
                            "regressions")
        p.add_argument("--repeats", type=int, default=3,
                       help="micro-probe samples per side (default 3)")
        p.add_argument("--mad-k", type=float, default=3.0,
                       help="MAD multiplier for the rollback threshold")
        p.add_argument("--rel-floor", type=float, default=0.15,
                       help="relative regression floor for rollback")
        p.add_argument("--max-actions", type=int, default=0,
                       help="cap the number of actions taken (0 = all)")
        p.add_argument("--min-actions", type=int, default=0,
                       help="exit 2 unless at least N actions (CI gate)")
        p.add_argument("--no-persist", action="store_true",
                       help="keep applied tunes in-process only (default "
                            "persists to the autotune cache file)")
        p.add_argument("--json", action="store_true",
                       help="emit actions + apply results as JSON")
        p.set_defaults(fn=_cmd_advise)
        p = sub.add_parser("incident",
                           help="merge per-host journals and reconstruct "
                                "ordered incident reports")
        p.add_argument("journals", nargs="+",
                       help="per-host JSONL journal paths ('-' = stdin); "
                            "rotated <path>.1 siblings read automatically")
        p.add_argument("--bundles", action="append", default=None,
                       help="flight-bundle file or directory (scanned for "
                            "*.json postmortems); repeatable")
        p.add_argument("--trace", default=None, metavar="OUT.json",
                       help="also write the merged Perfetto trace with "
                            "incident flow arrows")
        p.add_argument("--slack", type=float, default=5.0,
                       help="seconds of window slack for attributing "
                            "unstamped events/bundles (default 5)")
        p.add_argument("--strict-bundles", action="store_true",
                       help="exit 1 if any bundle or recovery attempt "
                            "is unattributed (CI orphan gate)")
        p.add_argument("--json", action="store_true",
                       help="emit the incident report as JSON")
        p.set_defaults(fn=_cmd_incident)
        p = sub.add_parser("flame",
                           help="journal (or live aggregator) -> "
                                "collapsed-stack flame format")
        p.add_argument("journal", nargs="?", default=None,
                       help="JSONL journal path ('-' = stdin); omit "
                            "with --url")
        p.add_argument("--url", default=None,
                       help="fetch the live flame profile from an "
                            "aggregator instead of a journal")
        p.add_argument("-o", "--out", default=None,
                       help="output path (default stdout)")
        p.add_argument("--min-frac", type=float, default=0.0,
                       help="exit 2 unless at least this fraction of "
                            "wall time is attributed (CI gate; journal "
                            "mode only)")
        p.add_argument("--json", action="store_true",
                       help="emit counts + attribution stats as JSON")
        p.set_defaults(fn=_cmd_flame)
        p = sub.add_parser("top",
                           help="live terminal dashboard refreshing "
                                "from an aggregator")
        p.add_argument("--url", required=True,
                       help="aggregator base URL (telemetry agg prints "
                            "it)")
        p.add_argument("--interval", type=float, default=1.0,
                       help="refresh interval seconds (default 1)")
        p.add_argument("--once", action="store_true",
                       help="render one frame and exit (no screen "
                            "clearing; scripts/tests)")
        p.add_argument("--json", action="store_true",
                       help="dump the raw snapshot JSON once and exit")
        p.set_defaults(fn=_cmd_top)
        p = sub.add_parser("agg",
                           help="run the streaming aggregator "
                                "(ingest/metrics/healthz/flame/trace)")
        p.add_argument("--host", default="127.0.0.1",
                       help="bind address (default 127.0.0.1)")
        p.add_argument("--port", type=int, default=9900,
                       help="bind port (default 9900; 0 = ephemeral)")
        p.add_argument("--p99-slo", type=float, default=0.5,
                       help="serve p99 SLO seconds for the live alert "
                            "rules (default 0.5)")
        p.add_argument("--eval-interval", type=float, default=0.5,
                       help="alert evaluation interval seconds")
        p.add_argument("--duration", type=float, default=0.0,
                       help="exit after N seconds (0 = run until ^C)")
        p.add_argument("--no-advertise", action="store_true",
                       help="skip publishing the URL to the multihost "
                            "coordination KV")
        p.set_defaults(fn=_cmd_agg)
        p = sub.add_parser("stream",
                           help="external exporter: tail a journal file "
                                "and stream frames to an aggregator")
        p.add_argument("journal", help="JSONL journal path to tail")
        p.add_argument("--agg", required=True,
                       help="aggregator base URL")
        p.add_argument("--interval", type=float, default=0.5,
                       help="frame interval seconds (default 0.5)")
        p.add_argument("--ring", type=int, default=256,
                       help="bounded frame-ring capacity (default 256)")
        p.add_argument("--duration", type=float, default=0.0,
                       help="exit after N seconds (0 = run until ^C)")
        p.set_defaults(fn=_cmd_stream)
        args = ap.parse_args(argv)
        try:
            return args.fn(args)
        except _JournalUnusable as e:
            print(str(e), file=sys.stderr)
            return 2
        except OSError as e:
            print(f"cannot read input: {e}", file=sys.stderr)
            return 2
    # legacy interface: bare journal path == `summarize`
    ap = argparse.ArgumentParser(
        prog="python -m distributedarrays_tpu_torch.telemetry",
        description="Summarize a telemetry journal (JSONL).")
    ap.add_argument("journal", help="path to the JSONL journal "
                                    "(or '-' for stdin)")
    ap.add_argument("--json", action="store_true",
                    help="emit the summary as JSON")
    args = ap.parse_args(argv)
    try:
        return _cmd_summarize(args)
    except _JournalUnusable as e:
        print(str(e), file=sys.stderr)
        return 2
    except OSError as e:
        print(f"cannot read journal: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
