"""Postmortem flight recorder: the bundle a crashed run leaves behind.

PyTorch counterpart of ``distributedarrays_tpu/telemetry/flight.py`` (its
whole ``__all__``).  :func:`postmortem` snapshots the journal's in-memory
ring, the open spans, the span aggregates, the live-DArray registry census
(provided by the package's ``core`` through
:func:`register_census_provider`), the memory ledger (its snapshot, its
largest entries and :func:`memory.leak_census`) and the divergence events
into one JSON bundle, stamped with the retry verdict of the classifier
that ``resilience.recovery`` registers.

Triggers: :func:`record_crash` on the failure paths of ``spmd()``, the
divergence checker and the recovery loop (one bundle per exception
object, at most ``DA_TPU_FLIGHT_MAX`` a process); :func:`postmortem` on
demand; SIGUSR1 (:func:`install_sigusr1`, installed on import in the main
thread unless ``DA_TPU_FLIGHT_SIGUSR1=0``).  Bundles are written to
``DA_TPU_FLIGHT_DIR``, else beside the configured journal, else kept in
memory only (:func:`last_bundle`).  The live plane's ``stream`` stats
are ``{"armed": False}`` until its exporter is ported.
"""

from __future__ import annotations

import json
import os
import threading
import time
import weakref

from . import core, memory, stream, tracing

__all__ = ["postmortem", "record_crash", "last_bundle",
           "install_sigusr1", "register_census_provider",
           "register_classifier", "crash_bundle_count",
           "SCHEMA_VERSION"]

# bundle schema version, stamped on every bundle so offline readers (the
# incident CLI, external tooling) can refuse shapes they don't
# understand.  v1: unversioned bundles (pre-incident era); v2 adds
# schema_version + the open incident id.
SCHEMA_VERSION = 2

_RING_MAX_ENV = "DA_TPU_FLIGHT_RING"       # bundle ring tail length
_MAX_ENV = "DA_TPU_FLIGHT_MAX"             # bundles per process

_lock = threading.Lock()
# already-bundled errors, keyed by id() with a validator so a dead
# exception's recycled id cannot suppress a new error's bundle, and
# nothing strong-references the exception (pinning its traceback frames
# — and whatever arrays they hold — for the life of the process).
# Python-defined exceptions validate by weakref identity; builtin
# exception types reject weakrefs, so those fall back to a
# (type, message) fingerprint.  Size-bounded by pruning.
_bundled_excs: dict[int, object] = {}   # id -> weakref.ref | fingerprint
_bundles_written = 0
_crash_bundles = 0                      # record_crash attempts that bundled
_last_bundle: dict | None = None
_last_path: str | None = None
_census_provider = None
_classifier = None
_sig_installed = False


def register_census_provider(fn) -> None:
    """Install the lifecycle-registry census callable (``() -> dict``).
    Registered by the package's ``core`` at import so the bundle
    can include the live-DArray census without this module importing the
    package (telemetry stays stdlib-only / cycle-free)."""
    global _census_provider
    _census_provider = fn


def register_classifier(fn) -> None:
    """Install the failure classifier (``(exc) -> str`` verdict).
    Registered by ``resilience.recovery`` (same injection pattern as the
    census provider) so every bundle is stamped with the retry verdict
    the recovery executor would act on — the bundle drives the retry
    decision, and offline readers see the same triage."""
    global _classifier
    _classifier = fn


def crash_bundle_count() -> int:
    """Crash bundles assembled so far this process (dedup'd per
    exception object) — the chaos suite's exactly-one-bundle witness."""
    with _lock:
        return _crash_bundles


def _int_env(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, str(default)))
    except ValueError:
        return default


def _flight_dir() -> str | None:
    d = os.environ.get("DA_TPU_FLIGHT_DIR")
    if d:
        return d
    jp = core.journal_path()
    if jp:
        return os.path.dirname(jp) or "."
    return None


def _exc_info(exc) -> dict | None:
    if exc is None:
        return None
    return {"type": type(exc).__name__,
            "message": str(exc)[:8000],
            "cause": type(exc.__cause__).__name__
            if exc.__cause__ is not None else None}


def snapshot_bundle(reason: str, exc=None) -> dict:
    """Assemble (but do not write) a postmortem bundle."""
    ring = core.events()
    tail = _int_env(_RING_MAX_ENV, 512)
    if len(ring) > tail:
        ring = ring[-tail:]
    try:
        census = _census_provider() if _census_provider is not None else None
    except Exception:
        census = {"error": "census provider failed"}
    try:
        leak = memory.leak_census()
    except Exception:
        leak = {"error": "leak census failed"}
    verdict = None
    if exc is not None and _classifier is not None:
        try:
            verdict = _classifier(exc)
        except Exception:
            verdict = None               # the recorder must never re-crash
    return {
        "kind": "da_tpu_postmortem",
        "schema_version": SCHEMA_VERSION,
        "incident": core.current_incident(),
        "reason": reason,
        "classification": verdict,
        "host": core._HOST,
        "pid": os.getpid(),
        "wall": round(time.time(), 3),
        "t": round(time.monotonic() - core._T0, 6),
        "exception": _exc_info(exc),
        "ring": ring,
        "open_spans": tracing.open_spans(),
        "span_stats": tracing.span_stats(),
        "ledger": memory.snapshot(),
        "ledger_entries": memory.entries(limit=100),
        "registry_census": census,
        "leak_census": leak,
        "divergence": [e for e in ring if e.get("cat") == "divergence"],
        "journal_path": core.journal_path(),
        "stream": stream.stats(),
    }


def postmortem(reason: str = "on_demand", exc=None,
               path: str | None = None) -> str | None:
    """Snapshot a bundle and write it as JSON.

    Returns the written path, or ``None`` when telemetry is disabled or
    no destination exists (bundle still kept — :func:`last_bundle`).
    """
    global _bundles_written, _last_bundle, _last_path
    if not core._ENABLED:
        return None
    bundle = snapshot_bundle(reason, exc)
    with _lock:
        _last_bundle = bundle
        if path is None:
            d = _flight_dir()
            if d is not None:
                # reserve the slot under the lock: two threads crashing
                # concurrently must not compute the same bundle path and
                # clobber each other's evidence
                path = os.path.join(
                    d, f"postmortem-{os.getpid()}-{_bundles_written}.json")
                _bundles_written += 1
    if path is None:
        return None
    try:
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(bundle, f, indent=2, sort_keys=True, default=str)
        os.replace(tmp, path)
    except OSError:
        return None                  # the recorder must never crash a crash
    with _lock:
        _last_path = path
    core.event("flight", "postmortem", reason=reason, path=path)
    return path


def record_crash(exc, where: str) -> str | None:
    """Crash-path trigger: one bundle per exception object, at most
    ``DA_TPU_FLIGHT_MAX`` (default 8) per process — counted per crash
    *assembly*, so the cap holds in memory-only mode too (no flight dir
    configured).  Exceptions chained from an already-bundled root cause
    are not re-bundled."""
    global _crash_bundles
    if not core._ENABLED:
        return None

    def _fingerprint(e):
        return (type(e).__name__, str(e)[:200])

    def _seen_locked(e) -> bool:
        if e is None:
            return False
        v = _bundled_excs.get(id(e))
        if v is None:
            return False
        if isinstance(v, weakref.ref):
            if v() is e:
                return True
        elif v == _fingerprint(e):
            return True
        del _bundled_excs[id(e)]     # dead entry whose id got recycled
        return False

    with _lock:
        if _crash_bundles >= _int_env(_MAX_ENV, 8):
            return None
        if _seen_locked(exc) or _seen_locked(exc.__cause__):
            return None
        _crash_bundles += 1
        if len(_bundled_excs) > 64:  # bound the dict: dead refs, then FIFO
            for k in [k for k, v in _bundled_excs.items()
                      if isinstance(v, weakref.ref) and v() is None]:
                del _bundled_excs[k]
            while len(_bundled_excs) > 64:
                del _bundled_excs[next(iter(_bundled_excs))]
        try:
            _bundled_excs[id(exc)] = weakref.ref(exc)
        except TypeError:
            _bundled_excs[id(exc)] = _fingerprint(exc)
    return postmortem(f"exception:{where}", exc)


def last_bundle() -> dict | None:
    """The most recent bundle (written or in-memory-only)."""
    with _lock:
        return _last_bundle


def install_sigusr1() -> bool:
    """Install a SIGUSR1 handler dumping a postmortem bundle.  Main
    thread only; returns True when installed.  Chained onto any existing
    non-default handler."""
    global _sig_installed
    if _sig_installed:
        return True
    try:
        import signal
        if threading.current_thread() is not threading.main_thread():
            return False
        sig = getattr(signal, "SIGUSR1", None)
        if sig is None:
            return False
        prev = signal.getsignal(sig)

        def _handler(signum, frame):
            # a signal interrupts the main thread at an arbitrary
            # bytecode — possibly INSIDE a flight._lock critical section
            # (non-reentrant: dumping would self-deadlock) or INSIDE
            # core._LOCK (reentrant, worse: re-entry would interleave a
            # journal line into a half-written one, or snapshot the
            # ledger mid-update).  Skipping the dump is the safe failure
            # mode for both.
            core_owned = getattr(core._LOCK, "_is_owned", lambda: False)()
            if not core_owned and _lock.acquire(blocking=False):
                _lock.release()
                postmortem("sigusr1")
            if callable(prev) and prev not in (signal.SIG_IGN,
                                               signal.SIG_DFL):
                prev(signum, frame)

        signal.signal(sig, _handler)
        _sig_installed = True
        return True
    except Exception:
        return False


def _sigusr1_wanted() -> bool:
    v = os.environ.get("DA_TPU_FLIGHT_SIGUSR1")
    return v is None or v.strip().lower() not in core._FALSY


def _reset() -> None:
    global _bundles_written, _crash_bundles, _last_bundle, _last_path
    with _lock:
        _bundled_excs.clear()
        _bundles_written = 0
        _crash_bundles = 0
        _last_bundle = None
        _last_path = None


core.register_reset_hook(_reset)

if core._ENABLED and _sigusr1_wanted():
    install_sigusr1()
