"""Cluster observatory: cross-host journal merge + causal incident
reconstruction.

The interesting failures are *distributed*: a partition incident
leaves its story scattered across per-host journals, flight bundles,
fault history, quorum verdicts, and recovery counters.  This module
reassembles it:

- :func:`merge_journals` aligns per-host journals onto ONE timeline
  (heartbeat-exchange clock offsets from ``parallel/multihost.py`` when
  present as ``multihost/clock`` events, else wall-clock anchors, else a
  first-common-event match), deduplicates shared events, and returns a
  list that ``summarize``/``to_perfetto`` consume directly — a multihost
  run renders as one trace with per-host process tracks.
- :func:`reconstruct_incidents` stitches flight bundles, fault
  injections, ``quorum_assess`` verdicts, recovery attempts, elastic
  shrink/grow epochs, checkpoint restore-source decisions, serve drain
  events and alert transitions into ordered incident reports ("partition
  injected at t=… → minority drained typed → quorum side restored step 4
  peer-first → shrank → retried → converged"), keyed by the incident ids
  the recovery executor mints (``core.begin_incident``) and grouped into
  cross-host episodes when windows overlap.
- :func:`incident_trace` re-exports the merged timeline as Perfetto JSON
  with flow events threading each incident's steps into one arrowed path.

Pure stdlib over plain dicts (like ``summarize``/``export``): journals
pulled off workers reconstruct on any machine.  PyTorch counterpart of
``distributedarrays_tpu/telemetry/cluster.py`` (its whole ``__all__``),
kept as the port's own copy.  The ``multihost/clock`` events it aligns
by are what the port's ``parallel.multihost.exchange_clock_offsets``
journals; the flight bundles it loads are the port's ``telemetry.flight``
bundles (the same ``da_tpu_postmortem`` kind and schema version).
"""

from __future__ import annotations

import json
import os

# direct from-imports: the package re-exports `summarize`/`to_perfetto`
# FUNCTIONS that shadow the module attributes of the same names
from .export import to_perfetto as _to_perfetto
from .summarize import read_journal as _read_journal

__all__ = ["merge_journals", "reconstruct_incidents", "load_bundles",
           "format_incidents", "incident_trace"]

# events these categories emit are part of an incident's causal story
# even when recorded before the incident id was minted (the injection
# itself, quorum checks) — time-window attribution picks them up
_INCIDENT_CATS = ("faults", "multihost", "recovery", "elastic",
                  "checkpoint", "serve", "train", "incident", "alert",
                  "domains")

# seconds of timeline slack around an incident's [begin, end] window for
# attributing unstamped events and bundles (the injection fires just
# before the first classified failure mints the id)
_WINDOW_SLACK_S = 5.0


def _stream_key(e: dict) -> tuple:
    return (str(e.get("host", "")), int(e.get("pid") or 0))


def _wall_anchor(evs: list[dict]) -> float | None:
    """Median of ``wall - t`` over a stream: the epoch time of the
    stream's monotonic origin.  Median, not mean — a single event whose
    wall was recorded across an NTP step must not skew the anchor."""
    deltas = sorted(e["wall"] - e["t"] for e in evs
                    if isinstance(e.get("wall"), (int, float))
                    and isinstance(e.get("t"), (int, float)))
    if not deltas:
        return None
    return deltas[len(deltas) // 2]


def _clock_skews(events: list[dict]) -> dict[tuple[str, str], float]:
    """Directed skew edges from ``multihost/clock`` events:
    ``(recorder_host, peer_host) -> offset_s`` where ``offset_s`` is the
    recorder's wall minus the peer's (recorder ahead by that much).  The
    latest estimate per edge wins."""
    skews: dict[tuple[str, str], float] = {}
    for e in events:
        if e.get("cat") != "multihost" or e.get("name") != "clock":
            continue
        rec_host = str(e.get("host", ""))
        offsets = e.get("offsets")
        if not isinstance(offsets, dict):
            continue
        for info in offsets.values():
            if not isinstance(info, dict):
                continue
            peer = info.get("host")
            off = info.get("offset_s")
            if peer is None or not isinstance(off, (int, float)):
                continue
            skews[(rec_host, str(peer))] = float(off)
    return skews


def _event_fingerprint(e: dict) -> tuple | None:
    """Identity of an event ACROSS hosts, for first-common-event
    alignment: category, name, and the non-meta payload.  Only
    configuration-like events are shared-fate enough to match (two hosts
    journal the same fault plan / domain topology at the same moment)."""
    if (e.get("cat"), e.get("name")) not in (
            ("faults", "configure"), ("domains", "configure"),
            ("multihost", "initialize")):
        return None
    skip = ("seq", "t", "wall", "tid", "host", "pid", "span_id",
            "trace_id", "incident")
    payload = {k: v for k, v in e.items() if k not in skip}
    try:
        return (json.dumps(payload, sort_keys=True, default=str),)
    except (TypeError, ValueError):
        return None


def merge_journals(paths_or_events, *, slack_s: float = _WINDOW_SLACK_S) \
        -> list[dict]:
    """Merge per-host JSONL journals onto one timeline.

    ``paths_or_events``: journal paths (rotated ``<path>.1`` siblings are
    read automatically, oldest first) and/or already-parsed event lists.
    Events are grouped into per-``(host, pid)`` streams, deduplicated on
    ``(host, pid, seq)`` (the same event mirrored into two files — e.g. a
    copied journal — appears once), and each stream's monotonic clock is
    re-based onto the reference stream's (the first stream seen):

    1. **clock offsets** — ``multihost/clock`` events (published by the
       heartbeat exchange, :func:`parallel.multihost.
       exchange_clock_offsets`) give direct skew edges between hosts;
    2. **wall anchors** — otherwise each stream's median ``wall - t``
       places its monotonic origin on the (NTP-disciplined) epoch
       timeline;
    3. **first common event** — with neither (or to refine hosts with no
       clock edge), the earliest configuration event shared by two
       streams (same fault plan / topology payload) is assumed
       simultaneous.

    Returns events sorted by merged ``t`` (seconds from the merged
    origin, the earliest event overall); every event keeps its original
    monotonic stamp as ``t_local``.  The result feeds
    :func:`summarize.summarize` and :func:`export.to_perfetto` (which
    renders one process track per ``(host, pid)``) unchanged.
    """
    streams: dict[tuple, list[dict]] = {}
    seen: set[tuple] = set()
    order: list[tuple] = []
    for src in paths_or_events:
        if isinstance(src, (list, tuple)):
            evs = list(src)
        else:
            evs = []
            rotated = str(src) + ".1"
            if os.path.exists(rotated):
                evs.extend(_read_journal(rotated))
            evs.extend(_read_journal(src))
        for e in evs:
            if not isinstance(e, dict):
                continue
            key = _stream_key(e)
            seq = e.get("seq")
            if seq is not None:
                dk = key + (int(seq),)
                if dk in seen:
                    continue
                seen.add(dk)
            if key not in streams:
                streams[key] = []
                order.append(key)
            streams[key].append(e)
    if not streams:
        return []

    ref = order[0]
    skews = _clock_skews([e for evs in streams.values() for e in evs])
    anchors = {key: _wall_anchor(evs) for key, evs in streams.items()}
    fingerprints: dict[tuple, dict[tuple, float]] = {}
    for key, evs in streams.items():
        fps: dict[tuple, float] = {}
        for e in evs:
            fp = _event_fingerprint(e)
            if fp is not None and isinstance(e.get("t"), (int, float)):
                fps.setdefault(fp, float(e["t"]))
        fingerprints[key] = fps

    ref_host = ref[0]
    ref_anchor = anchors.get(ref) or 0.0

    def _shift(key: tuple) -> float:
        """Seconds to ADD to stream ``key``'s local t to land it on the
        reference stream's local-t scale."""
        if key == ref:
            return 0.0
        host = key[0]
        anchor = anchors.get(key)
        # epoch-based shift first: place both monotonic origins on the
        # wall timeline, then correct the wall clocks' relative skew
        # from a direct clock edge when one exists
        if anchor is not None:
            shift = anchor - ref_anchor
            if host != ref_host:
                if (ref_host, host) in skews:
                    # ref ahead of host by off: host wall + off = ref wall
                    shift += skews[(ref_host, host)]
                elif (host, ref_host) in skews:
                    shift -= skews[(host, ref_host)]
                else:
                    # no clock edge: refine with the earliest shared
                    # configuration event, assumed simultaneous
                    common = set(fingerprints[key]) & \
                        set(fingerprints[ref])
                    if common:
                        fp = min(common,
                                 key=lambda f: fingerprints[ref][f])
                        shift = fingerprints[ref][fp] - \
                            fingerprints[key][fp]
            return shift
        # no wall stamps at all: first-common-event or give up at 0
        common = set(fingerprints[key]) & set(fingerprints[ref])
        if common:
            fp = min(common, key=lambda f: fingerprints[ref][f])
            return fingerprints[ref][fp] - fingerprints[key][fp]
        return 0.0

    shifts = {key: _shift(key) for key in streams}
    merged: list[dict] = []
    for key, evs in streams.items():
        shift = shifts[key]
        for e in evs:
            t = e.get("t")
            if isinstance(t, (int, float)):
                out = dict(e)
                out["t_local"] = t
                out["t"] = round(float(t) + shift, 6)
                merged.append(out)
            else:
                merged.append(dict(e))
    # re-base so the merged origin is the earliest event (negative
    # timestamps confuse trace viewers), then order the timeline
    ts = [e["t"] for e in merged if isinstance(e.get("t"), (int, float))]
    if ts:
        t0 = min(ts)
        if t0 != 0.0:
            for e in merged:
                if isinstance(e.get("t"), (int, float)):
                    e["t"] = round(e["t"] - t0, 6)
    merged.sort(key=lambda e: (e.get("t") if isinstance(
        e.get("t"), (int, float)) else float("inf"),
        str(e.get("host", "")), e.get("seq") or 0))
    return merged


# ---------------------------------------------------------------------------
# incident reconstruction
# ---------------------------------------------------------------------------


def _phrase(e: dict) -> str | None:
    """One human line per causal step; None for events that are not
    steps (spans, comm, gauges...)."""
    cat, name = e.get("cat"), e.get("name")
    if cat == "faults" and name == "fire":
        action = e.get("action", "?")
        site = e.get("site", "?")
        if action == "partition":
            return f"partition injected at {site}"
        return f"fault fired: {action} at {site}"
    if cat == "multihost" and name == "quorum":
        return (f"quorum verdict {e.get('verdict', '?')} "
                f"(side {e.get('side', '?')}, lost {e.get('lost', '?')}) "
                f"on {e.get('host', '?')}")
    if cat == "incident" and name == "begin":
        return f"incident opened ({e.get('kind', '?')})"
    if cat == "incident" and name == "end":
        return f"incident closed: {e.get('resolution', '?')}"
    if cat == "recovery" and name == "failure":
        tail = "retrying" if e.get("retrying") else "not retrying"
        return (f"attempt {e.get('attempt', '?')} failed "
                f"({e.get('verdict', '?')}; {tail})")
    if cat == "recovery" and name == "minority_exit":
        return (f"minority side {e.get('side')} exiting typed "
                f"(lost contact with {e.get('lost')})")
    if cat == "recovery" and name == "recovered":
        return f"recovered after {e.get('attempts', '?')} attempts"
    if cat == "checkpoint" and name == "restore_peer":
        return (f"restored step {e.get('step', '?')} from peer replicas "
                f"(zero disk reads)")
    if cat == "checkpoint" and name == "restore_disk":
        return f"restored step {e.get('step', '?')} from disk"
    if cat == "checkpoint" and name in ("restore_fallback",
                                        "replica_fallback"):
        return f"checkpoint fallback: {name}"
    if cat == "elastic" and name == "shrink":
        dom = f" (domain {e.get('domain')})" if e.get("domain") else ""
        return (f"shrank to {e.get('live', '?')} live devices, moved "
                f"{e.get('moved', '?')} arrays{dom}")
    if cat == "elastic" and name == "grow":
        return f"grew to {e.get('live', '?')} live devices"
    if cat == "elastic" and name == "probe":
        return (f"elastic probe: {e.get('live', '?')} live / "
                f"{e.get('down', '?')} down")
    if cat == "serve" and name == "partition_drain":
        ep = f" [{e.get('endpoint')}]" if e.get("endpoint") else ""
        return f"server drained typed (partition minority){ep}"
    if cat == "serve" and name == "drain":
        return f"server drained ({e.get('depth', 0)} queued)"
    if cat == "train" and name == "reseat":
        return f"trainer re-seated state at step {e.get('step', '?')}"
    if cat == "alert":
        return f"alert {name} {e.get('state', '?')}"
    if cat == "journal" and name == "rotated":
        return None
    return None


def load_bundles(paths) -> list[dict]:
    """Load flight bundles from files and/or directories (every
    ``*.json`` whose ``kind`` is ``da_tpu_postmortem``).  Each bundle
    gains a ``path`` key.  Raises :class:`ValueError` on a bundle whose
    ``schema_version`` is newer than this reader understands — refusing
    a shape we would silently misread beats guessing (missing version =
    v1, still readable)."""
    from . import flight as _flight
    files: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            files.extend(sorted(
                os.path.join(p, f) for f in os.listdir(p)
                if f.endswith(".json")))
        else:
            files.append(p)
    bundles = []
    for f in files:
        try:
            with open(f) as fh:
                b = json.load(fh)
        except (OSError, ValueError):
            continue
        if not isinstance(b, dict) or \
                b.get("kind") != "da_tpu_postmortem":
            continue
        version = b.get("schema_version", 1)
        if not isinstance(version, int) or \
                version > _flight.SCHEMA_VERSION:
            raise ValueError(
                f"flight bundle {f} has schema_version {version!r}; this "
                f"reader understands <= {_flight.SCHEMA_VERSION} — "
                f"upgrade distributedarrays_tpu_torch to reconstruct it")
        b["path"] = f
        bundles.append(b)
    return bundles


def reconstruct_incidents(events: list[dict], bundles=(), *,
                          slack_s: float = _WINDOW_SLACK_S) -> dict:
    """Stitch a merged timeline (:func:`merge_journals`) and flight
    bundles into ordered incident reports.

    Incident ids (``inc-<host>-<pid>-<n>``) are per-process; one
    cluster-wide episode (a partition) opens one per side.  Ids whose
    ``[begin, end]`` windows overlap (padded by ``slack_s``) merge into
    one episode; events from incident-relevant categories recorded
    *without* an id inside a window (the injection itself, quorum
    verdicts, drains after the id closed) attach by time + category, and
    bundles attach by their stamped ``incident`` field, else by
    host/pid + wall-clock proximity.

    Returns ``{"incidents": [...], "bundles_total", "bundles_attributed",
    "bundles_unattributed": [...], "unattributed_recovery_events"}`` —
    the last two are the orphan witnesses the CI gate fails on.
    """
    # pass 1: per-id windows from stamped events
    by_id: dict[str, dict] = {}
    for e in events:
        inc = e.get("incident")
        t = e.get("t")
        if not inc or not isinstance(t, (int, float)):
            continue
        w = by_id.setdefault(str(inc), {
            "id": str(inc), "t0": t, "t1": t, "kind": None,
            "resolution": None, "hosts": set(), "events": []})
        w["t0"] = min(w["t0"], t)
        w["t1"] = max(w["t1"], t)
        if e.get("host") is not None:
            w["hosts"].add(str(e["host"]))
        if e.get("cat") == "incident":
            if e.get("name") == "begin" and w["kind"] is None:
                w["kind"] = e.get("kind")
            if e.get("name") == "end":
                w["resolution"] = e.get("resolution")
        w["events"].append(e)

    # pass 2: merge overlapping windows into episodes
    episodes: list[dict] = []
    for w in sorted(by_id.values(), key=lambda w: w["t0"]):
        for ep in episodes:
            if w["t0"] <= ep["t1"] + slack_s and \
                    w["t1"] >= ep["t0"] - slack_s:
                ep["ids"].append(w["id"])
                ep["t0"] = min(ep["t0"], w["t0"])
                ep["t1"] = max(ep["t1"], w["t1"])
                ep["hosts"] |= w["hosts"]
                ep["events"].extend(w["events"])
                if w["kind"]:
                    ep["kinds"].add(w["kind"])
                if w["resolution"]:
                    ep["resolutions"][w["id"]] = w["resolution"]
                break
        else:
            episodes.append({
                "ids": [w["id"]], "t0": w["t0"], "t1": w["t1"],
                "hosts": set(w["hosts"]),
                "kinds": {w["kind"]} if w["kind"] else set(),
                "resolutions": ({w["id"]: w["resolution"]}
                                if w["resolution"] else {}),
                "events": list(w["events"])})

    # pass 3: attach unstamped incident-category events by time window
    claimed = {id(e) for ep in episodes for e in ep["events"]}
    for e in events:
        if id(e) in claimed or e.get("incident"):
            continue
        if e.get("cat") not in _INCIDENT_CATS:
            continue
        t = e.get("t")
        if not isinstance(t, (int, float)):
            continue
        for ep in episodes:
            if ep["t0"] - slack_s <= t <= ep["t1"] + slack_s:
                ep["events"].append(e)
                if e.get("host") is not None:
                    ep["hosts"].add(str(e["host"]))
                break

    # pass 4: attach bundles — stamped incident id first, then
    # host/pid + wall proximity against the episode's own wall range
    bundles = list(bundles)
    unattributed: list[dict] = []
    for b in bundles:
        target = None
        binc = b.get("incident")
        if binc:
            for ep in episodes:
                if str(binc) in ep["ids"]:
                    target = ep
                    break
        if target is None and isinstance(b.get("wall"), (int, float)):
            bkey = (str(b.get("host", "")), int(b.get("pid") or 0))
            for ep in episodes:
                walls = [e["wall"] for e in ep["events"]
                         if isinstance(e.get("wall"), (int, float))
                         and _stream_key(e) == bkey]
                if not walls:
                    walls = [e["wall"] for e in ep["events"]
                             if isinstance(e.get("wall"), (int, float))]
                if walls and min(walls) - slack_s <= b["wall"] \
                        <= max(walls) + slack_s:
                    target = ep
                    break
        if target is not None:
            target.setdefault("bundles", []).append(b)
        else:
            unattributed.append(b)

    # pass 5: render each episode's ordered step list
    out_eps = []
    unattributed_recovery = 0
    for ep in episodes:
        ep["events"].sort(key=lambda e: (
            e.get("t") if isinstance(e.get("t"), (int, float)) else 0.0,
            e.get("seq") or 0))
        steps = []
        for e in ep["events"]:
            phrase = _phrase(e)
            if phrase is None:
                continue
            steps.append({"t": e.get("t"), "host": e.get("host"),
                          "incident": e.get("incident"),
                          "cat": e.get("cat"), "name": e.get("name"),
                          "what": phrase})
        eb = ep.get("bundles", [])
        out_eps.append({
            "ids": ep["ids"],
            "kinds": sorted(k for k in ep["kinds"] if k),
            "t0": round(ep["t0"], 6), "t1": round(ep["t1"], 6),
            "duration_s": round(ep["t1"] - ep["t0"], 6),
            "hosts": sorted(ep["hosts"]),
            "resolutions": dict(ep["resolutions"]),
            "steps": steps,
            "bundles": [{"path": b.get("path"),
                         "reason": b.get("reason"),
                         "classification": b.get("classification"),
                         "host": b.get("host"), "pid": b.get("pid"),
                         "incident": b.get("incident"),
                         "schema_version": b.get("schema_version", 1)}
                        for b in eb],
        })
    # recovery attempts outside any episode are unattributed — with the
    # executor minting ids at the first classified failure this should
    # never happen; a nonzero count means lost correlation
    for e in events:
        if e.get("cat") == "recovery" and e.get("name") == "failure" \
                and not e.get("incident"):
            t = e.get("t")
            inside = any(isinstance(t, (int, float))
                         and ep["t0"] - slack_s <= t <= ep["t1"] + slack_s
                         for ep in episodes)
            if not inside:
                unattributed_recovery += 1
    return {
        "incidents": out_eps,
        "bundles_total": len(bundles),
        "bundles_attributed": len(bundles) - len(unattributed),
        "bundles_unattributed": [b.get("path") or "<in-memory>"
                                 for b in unattributed],
        "unattributed_recovery_events": unattributed_recovery,
        "events_total": len(events),
    }


def format_incidents(report: dict, out) -> None:
    """Render :func:`reconstruct_incidents` as readable text."""
    eps = report.get("incidents", [])
    out.write(f"{len(eps)} incident(s) over {report.get('events_total', 0)}"
              f" events; bundles {report.get('bundles_attributed', 0)}"
              f"/{report.get('bundles_total', 0)} attributed\n")
    for i, ep in enumerate(eps):
        ids = ", ".join(ep["ids"])
        kinds = "/".join(ep["kinds"]) or "?"
        out.write(f"\nincident {i + 1}: {kinds}  [{ids}]\n")
        out.write(f"  window: t={ep['t0']:.3f}s .. {ep['t1']:.3f}s "
                  f"({ep['duration_s']:.3f}s)  "
                  f"hosts: {', '.join(ep['hosts'])}\n")
        if ep["resolutions"]:
            res = ", ".join(f"{k}={v}"
                            for k, v in sorted(ep["resolutions"].items()))
            out.write(f"  resolution: {res}\n")
        for s in ep["steps"]:
            t = s.get("t")
            ts = f"{t:9.3f}s" if isinstance(t, (int, float)) else "        ?"
            out.write(f"  {ts}  [{s.get('host', '?')}] {s['what']}\n")
        for b in ep.get("bundles", []):
            out.write(f"  bundle: {b.get('path')} "
                      f"({b.get('classification')}, host {b.get('host')})\n")
    orphans = report.get("bundles_unattributed", [])
    if orphans:
        out.write(f"\nWARNING: {len(orphans)} orphaned bundle(s): "
                  f"{', '.join(orphans)}\n")
    if report.get("unattributed_recovery_events"):
        out.write(f"WARNING: {report['unattributed_recovery_events']} "
                  f"recovery attempt(s) outside any incident window\n")


def incident_trace(events: list[dict], report: dict | None = None) -> dict:
    """Perfetto JSON for a merged timeline with incident flow events:
    each episode's steps chain together with Chrome flow arrows (one
    flow id per episode), on top of :func:`export.to_perfetto`'s
    per-host process tracks."""
    if report is None:
        report = reconstruct_incidents(events)
    trace = _to_perfetto(events)
    entries = trace["traceEvents"]
    # map (host, pid) -> trace pid the exporter assigned, recomputed the
    # same way (insertion order over the event list)
    procs: dict[tuple, int] = {}
    for e in events:
        key = _stream_key(e)
        if key not in procs:
            procs[key] = len(procs)
    flow_id = 1 << 16         # clear of the request-flow id range
    for ep in report.get("incidents", []):
        steps = [s for s in ep.get("steps", [])
                 if isinstance(s.get("t"), (int, float))]
        if len(steps) < 2:
            continue
        for i, s in enumerate(steps):
            ph = "s" if i == 0 else ("f" if i == len(steps) - 1 else "t")
            key = (str(s.get("host", "")), 0)
            pid = procs.get(key)
            if pid is None:
                # steps carry host but not pid; fall back to the first
                # stream from that host
                pid = next((p for (h, _), p in procs.items()
                            if h == key[0]), 0)
            ev = {"name": "incident", "cat": "incident", "ph": ph,
                  "id": flow_id, "ts": round(s["t"] * 1e6, 3), "dur": 0,
                  "pid": pid, "tid": 0,
                  "args": {"what": s["what"],
                           "ids": ",".join(ep["ids"])}}
            if ph == "f":
                ev["bp"] = "e"
            entries.append(ev)
        flow_id += 1
    return trace
