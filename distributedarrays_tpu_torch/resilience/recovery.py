"""Retrying executor: bounded retry with postmortem-driven verdicts.

PyTorch counterpart of ``distributedarrays_tpu/resilience/recovery.py``
(its whole ``__all__``), the same decision table:

=================  =========================================================
``divergence``     a ``CollectiveDivergenceError``: the program is wrong,
                   never retried.
``device_loss``    a rank became unreachable: probe health, restore the
                   latest checkpoint (``checkpoints=``/``restore_fn=``),
                   shrink the live set through ``elastic``, retry.
``timeout``        a stuck receive: retried once after :func:`fresh_mesh`.
``partition``      the quorum rule decides: the majority side shrinks and
                   retries like device loss, the minority side exits with
                   a typed :class:`MinorityPartitionExit`, never retried.
``transient``      anything else: bounded retry with exponential backoff
                   and seeded jitter (``faults.jitter``).
=================  =========================================================

``checkpoints=`` is duck-typed as in JAX: anything with ``restore()``
(raising ``FileNotFoundError`` when nothing is saved) and optionally
``steps()``.

A kernel build failure or a CUDA error classifies ``transient``, as in
JAX: each retry runs the same call, kernel included (the port has no path
without it), and the error re-raises once the retries are spent.
Telemetry: the JAX counters
``recovery.attempts`` / ``failures`` / ``retries`` / ``restores`` /
``giveups`` / ``recovered`` and one ``recovery`` journal event per
decision.
"""

from __future__ import annotations

import dataclasses
import functools
import time

from .. import telemetry as _tm
from . import elastic, faults

__all__ = ["RetryPolicy", "MinorityPartitionExit", "classify",
           "run_with_recovery", "resilient", "fresh_mesh"]

VERDICTS = ("divergence", "device_loss", "partition", "timeout",
            "transient")

# message fingerprints for failures that arrive as text (the process
# backend ships child tracebacks as strings; real runtimes stringify
# their device-loss errors)
_DEVICE_LOSS_MARKS = ("InjectedDeviceLoss", "DATA_LOSS", "device lost",
                      "unreachable", "failed to connect")
_DIVERGENCE_MARKS = ("CollectiveDivergenceError",)
_PARTITION_MARKS = ("InjectedPartition", "network partition")
_TIMEOUT_MARKS = ("timed out", "TimeoutError")

class MinorityPartitionExit(RuntimeError):
    """The clean minority-side exit: this controller's partition side
    lost quorum, so the retry loop stops — re-running cannot win a
    quorum back, and a minority that keeps computing risks split-brain
    state.  Raised once per partition (exactly one flight bundle),
    never retried; a process runner should treat it as an orderly
    shutdown, not a crash."""

    def __init__(self, message: str, *, side: list[int] | None = None,
                 lost: list[int] | None = None,
                 incident: str | None = None):
        super().__init__(message)
        self.side = list(side or [])
        self.lost = list(lost or [])
        # the incident id the adjudication happened under, so downstream
        # handlers (the serve drain path) can stamp their own events with
        # it after the recovery loop has closed the incident
        self.incident = incident


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounds for the retry loop.  ``max_retries`` counts *retries* (total
    attempts = max_retries + 1); ``timeout_retries`` caps the
    fresh-mesh path separately (default: once, per the decision table).

    ``max_elapsed_s`` is a *wall-clock* budget over the whole
    ``run_with_recovery`` call (attempts + restores + backoff): once it
    is spent, the pending failure re-raises instead of retrying, and a
    backoff sleep is always clamped to the remaining budget — a retry
    loop under a per-step deadline (the trainer's, or a serve dispatch
    SLO) never sleeps past it.  The budget is checked *between*
    attempts; a single attempt that overruns it is not preempted (use
    the caller's own timeout machinery for that)."""

    max_retries: int = 3
    timeout_retries: int = 1
    base_delay: float = 0.05
    backoff: float = 2.0
    max_delay: float = 2.0
    jitter: float = 0.5          # fraction of the delay added as jitter
    max_elapsed_s: float | None = None   # wall-clock budget for the loop

    def delay(self, retry_index: int, remaining_s: float | None = None) \
            -> float:
        d = min(self.base_delay * self.backoff ** retry_index,
                self.max_delay)
        d = d * (1.0 + faults.jitter(self.jitter))
        if remaining_s is not None:
            d = min(d, max(remaining_s, 0.0))
        return d


def _chain(exc: BaseException):
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        yield exc
        exc = exc.__cause__ or exc.__context__


def classify(exc: BaseException) -> str:
    """Verdict for one failure (see the module decision table).  Walks
    the cause/context chain so the root cause — not the spmd driver's
    wrapping RuntimeError — decides."""
    from ..analysis.divergence import CollectiveDivergenceError
    texts = []
    for e in _chain(exc):
        if isinstance(e, CollectiveDivergenceError):
            return "divergence"
        if isinstance(e, faults.InjectedPartition):
            # before the device-loss check: InjectedPartition IS an
            # InjectedFault that downs ranks, but the verdict must route
            # through the quorum rule, not the per-device path
            return "partition"
        if isinstance(e, faults.InjectedDeviceLoss):
            return "device_loss"
        texts.append(f"{type(e).__name__}: {e}")
    blob = " | ".join(texts)
    if any(m in blob for m in _DIVERGENCE_MARKS):
        return "divergence"
    if any(m in blob for m in _PARTITION_MARKS):
        return "partition"
    if any(m in blob for m in _DEVICE_LOSS_MARKS):
        return "device_loss"
    for e in _chain(exc):
        if isinstance(e, TimeoutError):
            return "timeout"
    if any(m in blob for m in _TIMEOUT_MARKS):
        return "timeout"
    return "transient"


def _partition_quorum(exc: BaseException) -> dict:
    """Adjudicate a partition failure: which side is THIS controller on?
    An :class:`faults.InjectedPartition` in the cause chain carries the
    split's groups and observer directly (the deterministic-chaos path);
    otherwise the multihost heartbeat census decides
    (``parallel.multihost.quorum_assess``, JAX ``recovery.py:166``)."""
    from . import domains as _dom
    for e in _chain(exc):
        if isinstance(e, faults.InjectedPartition):
            expected = _dom.topology().ranks()
            q = _dom.majority_side(e.groups, e.observer,
                                   expected_total=len(expected))
            if _tm.enabled():
                # mirror quorum_assess's journal witness so a merged
                # cross-host timeline shows the verdict from BOTH sides
                # of the split, whichever adjudication path ran
                _tm.event("multihost", "quorum", verdict=q["verdict"],
                          side=q["side"], lost=q["lost"],
                          reason="injected partition (fault plan)")
            return {**q, "reason": "injected partition (fault plan)"}
    from ..parallel import multihost as _mh
    return _mh.quorum_assess()


# the flight recorder stamps every postmortem bundle with this verdict
# ("classification") so the bundle itself drives the retry decision —
# and offline bundle readers see the same triage the executor acted on
_tm.flight.register_classifier(classify)


def _bundle_verdict(exc: BaseException, bundle: dict | None,
                    fresh: bool) -> str:
    """Prefer the postmortem bundle's stamped classification when the
    bundle demonstrably belongs to this failure: either it was assembled
    for it just now (``fresh``), or its recorded exception matches one
    in the cause chain by type AND message prefix (the spmd driver
    records the ROOT-cause exception; ``exc`` is usually its wrapper).
    A type-only match is not enough — ``last_bundle()`` can be a stale
    bundle from an unrelated earlier crash (dedup hit, or the
    DA_TPU_FLIGHT_MAX cap), and generic wrapper types collide.  The
    bundle's ring-derived ``divergence`` section is deliberately NOT
    consulted: the ring is process-wide, so an earlier, already-handled
    divergence would poison every later verdict."""
    if bundle and bundle.get("classification"):
        binfo = bundle.get("exception") or {}
        if fresh or any(binfo.get("type") == type(e).__name__
                        and str(binfo.get("message", ""))[:200]
                        == str(e)[:200]
                        for e in _chain(exc)):
            return bundle["classification"]
    return classify(exc)


def fresh_mesh() -> None:
    """Drop the layout-derived caches so the next attempt plans its
    collectives from scratch: the "retry once with a fresh mesh" arm of
    the timeout verdict.  The port's one such cache is the reshard plan
    cache (JAX also drops its meshes and compiled programs)."""
    from ..parallel import reshard as _rs
    _rs._plan_cached.cache_clear()
    _tm.count("recovery.fresh_mesh")


# the branch a job's recovery takes when its controller processes
# classified one failure apart: the first of these that any process
# reached.  A partition and a device loss probe, restore and shrink; a
# timeout drops the plan cache (``fresh_mesh``) and restores; a transient
# failure restores.  A timeout that any process reached beside a device
# loss or a partition still drops the cache and counts toward
# ``timeout_retries`` (``_agreed``'s ``timed_out``).
_PRECEDENCE = ("partition", "device_loss", "timeout", "transient")


def _alone(decision: tuple) -> list:
    """The decisions of a run with no peer processes: its own."""
    return [decision]


def _agreed(every: list, own: str) -> tuple[str, bool, bool]:
    """Merge every process's ``(verdict, retryable, minority)`` into the
    job's one decision ``(verdict, retryable, timed_out)``: the job retries
    only if every process would and none leaves on a partition's minority
    side, under the first of ``_PRECEDENCE`` that any process reached
    (else ``own``); ``timed_out`` when any process reached a timeout."""
    seen = {v for v, _, _ in every}
    verdict = next((v for v in _PRECEDENCE if v in seen), own)
    return (verdict, all(r and not m for _, r, m in every),
            "timeout" in seen)


def _minority_exit(exc: BaseException, q: dict, verdict: str):
    """Raise the typed clean exit of a partition's minority side."""
    _tm.count("recovery.giveups", verdict=verdict)
    _tm.count("recovery.minority_exits")
    if _tm.enabled():
        # cold path: one event per partition exit
        _tm.event("recovery", "minority_exit", side=q["side"],
                  lost=q["lost"], reason=q.get("reason", ""))
    inc = _tm.current_incident()
    _tm.end_incident("minority_exit")
    raise MinorityPartitionExit(
        f"partition minority side {q['side']} lost quorum (lost contact "
        f"with {q['lost']}): exiting cleanly", side=q["side"],
        lost=q["lost"], incident=inc) from exc


def run_with_recovery(fn, *args, policy: RetryPolicy | None = None,
                      checkpoints=None, restore_fn=None, devices=None,
                      stop_event=None, **kwargs):
    """Run ``fn(*args, **kwargs)`` under the retry discipline.

    ``checkpoints``: a checkpoint manager (``restore()``, ``steps()``) to
    restore the latest
    complete step from before each retry; ``restore_fn`` receives the
    restored tree (re-seat your model/arrays there).  ``devices``: the
    elastic set to probe/shrink on device loss (default:
    ``elastic.manager()``); where it has ``exchange(decision)`` (a job of
    several controller processes: every process's decision, in one
    exchange), every process's ``(verdict, retryable, minority)`` is merged
    into one decision that every process takes (``_agreed``).

    ``stop_event``: an optional ``threading.Event`` that makes the retry
    loop *interruptible* — backoff sleeps wait on it instead of
    ``time.sleep``, so a draining server (which sets the event) never
    blocks on a sleeping retry.  Once set, no further retry is attempted:
    the pending failure re-raises immediately (typed by the caller), and
    ``recovery.interrupted`` counts the abort.
    """
    pol = policy or RetryPolicy()
    devs = devices if devices is not None else elastic.manager()
    t_start = time.monotonic()

    def _remaining():
        if pol.max_elapsed_s is None:
            return None
        return pol.max_elapsed_s - (time.monotonic() - t_start)

    timeout_retries = 0
    attempt = 0
    while True:
        attempt += 1
        _tm.count("recovery.attempts")
        try:
            out = fn(*args, **kwargs)
        except (KeyboardInterrupt, SystemExit, GeneratorExit):
            # interpreter-control exceptions are not failures to retry:
            # a Ctrl-C must stop the workload NOW, not burn max_retries
            # more attempts (and bundles) re-running it
            raise
        except Exception as e:  # noqa: BLE001 — verdict decides below
            if any(isinstance(x, MinorityPartitionExit) for x in _chain(e)):
                # already adjudicated (a nested recovery loop raised the
                # typed exit): pass through with no second bundle, no
                # retry — "exactly one flight bundle" is the contract
                raise
            # one postmortem per failure: spmd already bundled the
            # root cause on their crash path; this dedups against it and
            # only bundles failures that never passed through them.
            # Freshness is witnessed by the crash-bundle counter, not the
            # return value (memory-only mode returns None even when a
            # bundle WAS assembled).
            # mint (or join) the incident at the first classified
            # failure — BEFORE the postmortem is assembled, so the
            # bundle itself carries the id: from here until resolution
            # every journal event and bundle correlates across hosts
            # offline.  begin_incident is re-entrant, so the possibly
            # bundle-refined verdict below never re-mints.
            _tm.begin_incident(classify(e))
            n0 = _tm.flight.crash_bundle_count()
            _tm.flight.record_crash(e, where="recovery")
            fresh = _tm.flight.crash_bundle_count() > n0
            verdict = _bundle_verdict(e, _tm.flight.last_bundle(), fresh)
            _tm.count("recovery.failures", verdict=verdict)
            # in a job of several controller processes every process
            # takes one decision at each branch below (one exchange a
            # decision), so every process makes the same collective
            # probe, restore and shrink
            exchange = getattr(devs, "exchange", _alone)
            minority = None
            if verdict == "partition":
                # the quorum rule decides: a minority side can never win
                # quorum back by re-running, and continuing risks
                # split-brain state — typed clean exit, never retried.
                # With no peer processes the majority side falls through
                # to the device-loss discipline (probe → restore →
                # shrink to surviving domains → retry).  In a job, a
                # partition that puts any process on the minority side
                # ends the run on every process: that process is still a
                # member of the job's gloo group, so the majority cannot
                # shrink past it.
                q = _partition_quorum(e)
                if q["verdict"] == "minority":
                    minority = q
            retries_used = attempt - 1
            interrupted = stop_event is not None and stop_event.is_set()
            remaining = _remaining()
            deadline_spent = remaining is not None and remaining <= 0
            retryable = (not interrupted
                         and not deadline_spent
                         and verdict != "divergence"
                         and retries_used < pol.max_retries
                         and not (verdict == "timeout"
                                  and timeout_retries
                                  >= pol.timeout_retries))
            verdict, retryable, timed_out = _agreed(
                exchange((verdict, retryable, minority is not None)),
                verdict)
            if minority is not None:
                _minority_exit(e, minority, verdict)
            if interrupted:
                _tm.count("recovery.interrupted", verdict=verdict)
            if deadline_spent:
                _tm.count("recovery.deadline_exceeded", verdict=verdict)
            if _tm.enabled():
                # cold path: one event per failed attempt
                _tm.event("recovery", "failure", verdict=verdict,
                          attempt=attempt, retrying=retryable,
                          error=f"{type(e).__name__}: {str(e)[:300]}")
            if not retryable:
                _tm.count("recovery.giveups", verdict=verdict)
                _tm.end_incident("gave_up")
                raise
            if timed_out:
                timeout_retries += 1
                fresh_mesh()
            if verdict in ("device_loss", "partition"):
                devs.probe()
            if checkpoints is not None and restore_fn is not None:
                try:
                    state = checkpoints.restore()
                except FileNotFoundError as fe:
                    # distinguish "nothing saved yet" (a failure before
                    # the first save() completes — retry from live
                    # state) from "steps exist(ed) but NONE loads" (the
                    # unreadable-checkpoint condition must surface, not
                    # silently degrade to live-state retry).  A chained
                    # cause means restore FOUND steps and every load
                    # failed — that check must come first, because the
                    # integrity layer QUARANTINES corrupt steps as it
                    # goes, so by the time we look, steps() can already
                    # be empty for an every-step-corrupt store
                    steps = getattr(checkpoints, "steps", None)
                    if fe.__cause__ is not None or \
                            (steps is not None and steps()):
                        raise
                    _tm.count("recovery.restore_skipped")
                    state = None
                if state is not None:
                    restore_fn(state)
                    _tm.count("recovery.restores")
            if verdict in ("device_loss", "partition"):
                # shrink AFTER the restore so freshly restored arrays
                # land on survivors too; for a partition this is the
                # quorum side shrinking to its surviving domains
                devs.shrink()
            # restore/shrink themselves take wall time: re-check the
            # budget before launching a fresh attempt, or a slow
            # restore would let the attempt start arbitrarily far past
            # the deadline the caller set
            remaining = _remaining()
            spent = remaining is not None and remaining <= 0
            if pol.max_elapsed_s is not None:
                spent = not _agreed(exchange((verdict, not spent, False)),
                                    verdict)[1]
            if spent:
                _tm.count("recovery.deadline_exceeded", verdict=verdict)
                _tm.count("recovery.giveups", verdict=verdict)
                _tm.end_incident("gave_up")
                raise
            # interruptible backoff: a drain/shutdown signal wakes the
            # sleep promptly and abandons the retry with the pending
            # failure — a draining server must never sit out an
            # exponential delay before it can finish.  Under a
            # max_elapsed_s budget the sleep is clamped to what remains
            # (restore/shrink above may have consumed some of it).
            delay = pol.delay(retries_used, remaining)
            if stop_event is None:
                time.sleep(delay)
            elif stop_event.wait(delay):
                _tm.count("recovery.interrupted", verdict=verdict)
                _tm.count("recovery.giveups", verdict=verdict)
                _tm.end_incident("gave_up")
                raise
            _tm.count("recovery.retries", verdict=verdict)
            continue
        if attempt > 1:
            _tm.count("recovery.recovered")
            if _tm.enabled():
                # cold path: one event per recovered run
                _tm.event("recovery", "recovered", attempts=attempt)
            _tm.end_incident("recovered")
        return out


def resilient(*, policy: RetryPolicy | None = None, checkpoints=None,
              restore_fn=None, devices=None, stop_event=None):
    """Decorator form of :func:`run_with_recovery`::

        @resilient(checkpoints=mgr, restore_fn=reseat)
        def train_step(...): ...
    """
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return run_with_recovery(
                fn, *args, policy=policy, checkpoints=checkpoints,
                restore_fn=restore_fn, devices=devices,
                stop_event=stop_event, **kwargs)
        return wrapped
    return deco
