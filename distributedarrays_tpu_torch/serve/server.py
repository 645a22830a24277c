"""Multi-tenant async serving executor over resident sharded model state.

PyTorch counterpart of ``distributedarrays_tpu/serve/server.py`` (its whole
``__all__``): dispatch runs through the port's
``resilience.recovery.run_with_recovery`` at the ``serve.dispatch`` fault
site, the HBM shed reads the port's memory ledger, and ``close(closeall=
True)`` runs the port's ``core.d_closeall``.  Endpoints run on the
dispatch worker threads; an endpoint that launches CUDA work on another
card than the first sets its own current device.

The layer between ``spmd()``/``djit`` and a user: callers
submit requests against named *endpoints* (closures over resident sharded
state — a transformer's params, a MoE's experts, a ring-attention cache)
and get back futures; dispatch workers run an async loop that forms
continuously-batched device dispatches, executes them under the
resilience stack's retry discipline, and resolves every future with a
result or a typed error.  Nothing hangs and nothing grows unboundedly:

- **admission control** at submit (per-tenant token buckets, bounded
  queue, HBM + rolling-p99 backpressure) — see ``admission.py``;
- **continuous batching** (coalesce compatible requests, flush on
  batch-full or deadline) — see ``batching.py``;
- **deadline propagation** — budgets enforced at enqueue, batch
  formation, and dispatch; expired work is never dispatched;
- **fault tolerance** — each batch dispatch runs under
  ``resilience.recovery.run_with_recovery``: a device loss mid-batch
  restores/shrinks/retries per the recovery verdict table, and a batch the
  executor gives up on fails every member future with a typed
  :class:`~.errors.RequestFailed` carrying the cause;
- **graceful drain** — ``drain()``/``close()`` (and the SIGTERM hook)
  stop admission, flush queued batches, wake any sleeping retry
  backoff, then optionally ``d_closeall()``.

Telemetry: ``serve.submitted/admitted/shed{reason}/expired{stage}/
completed/failed/batches`` counters, the ``serve.queue_depth`` gauge,
``serve.batch_size``/``serve.batch_latency_s``/``serve.request_latency_s``
histograms, and a ``serve.dispatch`` span per batch (so Perfetto shows
the dispatch timeline per worker thread).
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import signal
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable

from .. import core
from .. import telemetry as _tm
from ..telemetry import stream as _tstream
from ..resilience import elastic, faults as _fl, recovery
from .admission import AdmissionController
from .batching import BatchQueue, Request, payload_key
from .errors import DeadlineExceeded, Draining, RequestFailed, ServeError

__all__ = ["ServeConfig", "Endpoint", "Server", "install_sigterm"]

# request trace ids: pid-scoped monotonic counter — unique within the
# process, readable in a journal ("req-<pid>-<n>"), deterministic in
# tests.  Minted at submit(), carried on every span to resolve.
_REQ_IDS = itertools.count(1)

# SLO histogram bucket bounds (seconds) for the per-endpoint
# ``serve.slo.request_s`` family (da_tpu_serve_slo_* in Prometheus)
_SLO_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


@dataclasses.dataclass
class ServeConfig:
    """Serving knobs (the JAX package's docs/serving.md walks through the
    policy).

    ``hbm_budget_bytes=None`` reads ``DA_TPU_SERVE_HBM_BUDGET_MB`` (unset
    → the HBM shed signal is off); ``p99_shed_s=None`` disables the
    latency shed signal."""

    max_batch: int = 8
    flush_s: float = 0.005            # straggler wait past the head arrival
    max_queue: int = 64               # bounded queue depth (all endpoints)
    default_deadline_s: float = 30.0
    tenant_rate: float = 100.0        # default per-tenant tokens/second
    tenant_burst: float = 200.0
    hbm_budget_bytes: int | None = None
    hbm_shed_fraction: float = 0.9
    p99_shed_s: float | None = None
    latency_window: int = 256
    # per-endpoint p99 window-size overrides ({endpoint: maxlen}); an
    # endpoint absent here uses latency_window (register(...,
    # latency_window=) overrides both)
    endpoint_latency_windows: dict[str, int] | None = None
    workers: int = 1                  # dispatch loop threads
    drain_timeout_s: float = 30.0

    def resolved_hbm_budget(self) -> int | None:
        if self.hbm_budget_bytes is not None:
            return int(self.hbm_budget_bytes)
        mb = os.environ.get("DA_TPU_SERVE_HBM_BUDGET_MB")
        if not mb:
            return None
        try:
            return int(float(mb) * (1 << 20))
        except ValueError:
            return None


@dataclasses.dataclass
class Endpoint:
    """A named batched entry point over resident state.

    ``fn(payloads: list) -> list`` receives the coalesced batch (same
    compatibility key throughout) and must return one result per payload,
    in order.  ``key_fn`` overrides the default payload signature."""

    name: str
    fn: Callable[[list], list]
    max_batch: int
    flush_s: float
    key_fn: Callable[[Any], Any] = payload_key


class Server:
    """The async serving executor.  Use as a context manager, or call
    :meth:`close` explicitly; dispatch workers are daemon threads started
    lazily on the first submit."""

    def __init__(self, config: ServeConfig | None = None, *,
                 policy: recovery.RetryPolicy | None = None,
                 checkpoints=None, restore_fn=None, devices=None):
        self.config = config or ServeConfig()
        self._admission = AdmissionController(
            max_queue=self.config.max_queue,
            tenant_rate=self.config.tenant_rate,
            tenant_burst=self.config.tenant_burst,
            hbm_budget_bytes=self.config.resolved_hbm_budget(),
            hbm_shed_fraction=self.config.hbm_shed_fraction,
            p99_shed_s=self.config.p99_shed_s,
            max_batch=self.config.max_batch,
            window=self.config.latency_window,
            endpoint_windows=self.config.endpoint_latency_windows)
        self._queue = BatchQueue()
        self._endpoints: dict[str, Endpoint] = {}
        self._policy = policy
        self._checkpoints = checkpoints
        self._restore_fn = restore_fn
        self._devices = devices if devices is not None else elastic.manager()
        # reentrant: the SIGTERM handler runs close() on whatever thread
        # the signal lands on — possibly one already inside submit()'s
        # locked section; a plain Lock would self-deadlock the shutdown
        self._lock = threading.RLock()
        self._workers: list[threading.Thread] = []
        self._started = False
        self._draining = False
        self._closed = False
        # drain wakes sleeping recovery backoffs promptly (the
        # interruptible-backoff contract: a draining server never blocks
        # on a retry sleeping out its exponential delay)
        self._drain_wake = threading.Event()
        self._inflight = 0
        self._inflight_cv = threading.Condition()

    # -- endpoints ---------------------------------------------------------

    def register(self, name: str, fn: Callable[[list], list], *,
                 max_batch: int | None = None, flush_s: float | None = None,
                 key_fn: Callable[[Any], Any] | None = None,
                 latency_window: int | None = None) -> Endpoint:
        """Register a batched endpoint.  ``fn`` takes the list of
        coalesced payloads and returns one result per payload.
        ``latency_window`` overrides the endpoint's rolling-p99 window
        size (else ``ServeConfig.endpoint_latency_windows``, else the
        global ``latency_window``)."""
        ep = Endpoint(
            name=name, fn=fn,
            max_batch=int(max_batch if max_batch is not None
                          else self.config.max_batch),
            flush_s=float(flush_s if flush_s is not None
                          else self.config.flush_s),
            key_fn=key_fn or payload_key)
        if latency_window is not None:
            self._admission.set_endpoint_window(name, latency_window)
        with self._lock:
            if self._closed:
                raise ServeError("server is closed")
            self._endpoints[name] = ep
        return ep

    def set_quota(self, tenant: str, rate: float, burst: float) -> None:
        self._admission.set_quota(tenant, rate, burst)

    def set_reclaimable(self, fn: Callable[[], int] | None) -> None:
        """Wire a reclaimable-bytes signal (e.g. the decode engine's
        ``PagedKVCache.idle_evictable_bytes``) into admission: an HBM
        shed whose pressure eviction can clear ships the clamp-floor
        ``retry_after`` instead of the queue drain estimate."""
        self._admission.reclaimable_fn = fn

    # -- submission --------------------------------------------------------

    def submit(self, endpoint: str, payload: Any, *, tenant: str = "default",
               deadline_s: float | None = None, key: Any = None,
               trace_id: str | None = None) -> Future:
        """Admit one request; returns its future, or raises a typed
        rejection (:class:`Draining`, :class:`DeadlineExceeded`,
        :class:`QuotaExceeded`, :class:`Overloaded`) without enqueueing.
        The future resolves to the endpoint's result for this payload, or
        raises the typed error the request ended with.

        Every request gets a trace id (``trace_id`` to propagate a
        caller-supplied one, else minted here): the ``serve.submit``
        span, the batch's ``serve.dispatch``/``serve.resolve`` spans,
        recovery retries, and SPMD rank steps under the dispatch all
        carry it — the submit-to-resolve journey reconstructs from the
        journal and exports as a Perfetto flow."""
        tid = trace_id or f"req-{_tm.core._PID}-{next(_REQ_IDS)}"
        _tm.count("serve.submitted", tenant=tenant)
        with _tm.trace_ctx(tid), \
                _tm.span("serve.submit", endpoint=endpoint, tenant=tenant,
                         bytes_hbm=_tm.nbytes_of(payload)):
            # ONE locked section from the draining check through the
            # enqueue: a request is admitted iff it is enqueued before
            # drain() flips _draining (so the flush is guaranteed to
            # cover it), and the queue-depth bound is checked atomically
            # with the put (so concurrent submitters cannot overshoot
            # max_queue)
            with self._lock:
                # partition health gate: a minority-side server must
                # drain typed, not time requests out — the quorum verdict
                # rides the elastic manager's probe epochs
                part = getattr(self._devices, "partition_verdict",
                               lambda: None)()
                if part is not None and part.get("verdict") == "minority" \
                        and not self._draining:
                    self._draining = True
                    self._drain_wake.set()
                    _tm.count("serve.partition_drains")
                    if _tm.enabled():
                        # cold path: one event per partition drain
                        _tm.event("serve", "partition_drain",
                                  side=part.get("side", []),
                                  lost=part.get("lost", []))
                if self._draining or self._closed:
                    _tm.count("serve.shed", reason="draining",
                              tenant=tenant)
                    raise Draining(tenant=tenant)
                ep = self._endpoints.get(endpoint)
                if ep is None:
                    raise ServeError(
                        f"unknown endpoint {endpoint!r} "
                        f"(registered: {sorted(self._endpoints)})")
                budget = (self.config.default_deadline_s
                          if deadline_s is None else float(deadline_s))
                now = time.monotonic()
                if budget <= 0:
                    _tm.count("serve.expired", stage="enqueue")
                    raise DeadlineExceeded(
                        f"request arrived with no budget "
                        f"(deadline_s={budget:g})", stage="enqueue")
                # the admission gate: queue bound -> HBM -> p99 -> quota
                # (the consuming token bucket last; see admission.admit)
                self._admission.admit(tenant, self._queue.depth())
                req = Request(endpoint=endpoint, payload=payload,
                              tenant=tenant, key=ep.key_fn(payload),
                              deadline=now + budget, enqueued=now,
                              trace_id=tid)
                self._ensure_started()
                try:
                    # put only appends and notifies under the queue's own
                    # condition (never waits); depth is bounded at admission
                    self._queue.put(req)  # dalint: disable=DAL008 — BatchQueue.put only appends and notifies under its own condition (never waits); depth is bounded at admission
                except RuntimeError:
                    # close() raced this submit: typed, never bare
                    _tm.count("serve.shed", reason="draining",
                              tenant=tenant)
                    raise Draining(tenant=tenant) from None
        _tm.count("serve.admitted", tenant=tenant)
        if _tm.enabled():
            # journaled AFTER self._lock drops (the write is file I/O;
            # doing it under the lock would serialize all submitters on
            # the journal disk): per-tenant token-level history
            # reconstructs as a Perfetto counter track next to queue
            # depth
            _tm.set_gauge("serve.tokens",
                          self._admission.token_level(tenant),
                          tenant=tenant, journal=True)
        return req.future

    # -- dispatch loop -----------------------------------------------------

    def _ensure_started(self) -> None:
        with self._lock:
            if self._started or self._closed:
                return
            self._started = True
            for i in range(max(1, int(self.config.workers))):
                t = threading.Thread(target=self._worker, daemon=True,
                                     name=f"serve-dispatch-{i}")
                self._workers.append(t)
                t.start()

    def _worker(self) -> None:
        while True:
            batch = self._queue.next_batch(self._limits)
            if batch is None:
                if self._draining and self._queue.depth() == 0:
                    return
                if self._closed:
                    return
                continue
            with self._inflight_cv:
                self._inflight += 1
            try:
                self._dispatch(batch)
            finally:
                with self._inflight_cv:
                    self._inflight -= 1
                    self._inflight_cv.notify_all()
                self._queue.task_done()

    def _limits(self, endpoint: str) -> tuple[int, float]:
        """Per-endpoint (max_batch, flush_s) for the batcher, resolved
        from the head request's endpoint so every endpoint gets exactly
        the bounds it registered with."""
        ep = self._endpoints.get(endpoint)
        if ep is None:   # pragma: no cover — endpoints are never removed
            return self.config.max_batch, self.config.flush_s
        return ep.max_batch, ep.flush_s

    def _dispatch(self, batch: list[Request]) -> None:
        ep = self._endpoints[batch[0].endpoint]
        # dispatch gate: expired work is never dispatched
        now = time.monotonic()
        live = [r for r in batch if r.deadline > now]
        for r in batch:
            if r.deadline <= now:
                r.expire("dispatch")
        if not live:
            return
        # the batch's trace context: every member request's id, so the
        # dispatch span, recovery retries, and any SPMD rank spans under
        # the endpoint body carry the submit-minted ids end to end
        with _tm.trace_ctx(*(r.trace_id for r in live)):
            self._dispatch_traced(ep, live)

    def _record_latency(self, dt: float,
                        endpoint: str | None = None) -> None:
        self._admission.record_latency(dt, endpoint)
        # rolling p99 as a gauge: the alerts module's serve_p99 burn-rate
        # rule (and any scraper) samples it without reaching into the
        # admission controller.  The unlabeled gauge is the global shed
        # signal; the labeled one is the per-endpoint window (its own
        # maxlen per ServeConfig/register)
        p99 = self._admission.latency.p99()
        _tm.set_gauge("serve.request_p99_s", p99)
        # live plane: every p99 update reaches the aggregator's burn
        # windows with its own wall stamp, not just the last value per
        # exporter tick (a single is-None check when no exporter is armed)
        _tstream.note("serve.request_p99_s", p99)
        if endpoint is not None:
            _tm.set_gauge(
                "serve.request_p99_s",
                self._admission.endpoint_latency(endpoint).p99(),
                endpoint=endpoint)

    def _dispatch_traced(self, ep: Endpoint, live: list[Request]) -> None:
        payloads = [r.payload for r in live]
        t0 = time.monotonic()
        _tm.count("serve.batches", endpoint=ep.name)
        try:
            with _tm.span("serve.dispatch", endpoint=ep.name,
                          size=len(live),
                          bytes_hbm=sum(_tm.nbytes_of(p)
                                        for p in payloads)):
                def _run():
                    # chaos site: a fault plan can kill a device mid-batch
                    # here; recovery re-invokes this closure on retry
                    _fl.check("serve.dispatch", endpoint=ep.name)
                    return ep.fn(payloads)
                results = recovery.run_with_recovery(
                    _run, policy=self._policy,
                    checkpoints=self._checkpoints,
                    restore_fn=self._restore_fn, devices=self._devices,
                    stop_event=self._drain_wake)
        except recovery.MinorityPartitionExit as e:
            # this controller lost quorum mid-dispatch: initiate the
            # typed drain (admission closes, workers flush and stop) and
            # fail the batch Draining — the client-visible story is
            # "server going away", not a generic dispatch failure
            dt = time.monotonic() - t0
            self._record_latency(dt, ep.name)
            with self._lock:
                self._draining = True
            self._drain_wake.set()
            _tm.count("serve.partition_drains")
            _tm.count("serve.failed", n=len(live), endpoint=ep.name)
            if _tm.enabled():
                # cold path: one event per partition drain; the exit
                # carries the (already-closed) incident id so the drain
                # attributes to the episode without window guessing
                extra = {"incident": e.incident} if e.incident else {}
                _tm.event("serve", "partition_drain", side=e.side,
                          lost=e.lost, endpoint=ep.name, **extra)
            err = Draining("server lost partition quorum; draining")
            err.__cause__ = e
            for r in live:
                r.fail(err)
            return
        except Exception as e:  # noqa: BLE001 — typed and shipped to futures
            dt = time.monotonic() - t0
            self._record_latency(dt, ep.name)
            err = e if isinstance(e, ServeError) else RequestFailed(
                f"batch dispatch failed after recovery gave up "
                f"(endpoint={ep.name}, size={len(live)}): "
                f"{type(e).__name__}: {e}")
            if err is not e:
                err.__cause__ = e
            _tm.count("serve.failed", n=len(live), endpoint=ep.name)
            for r in live:
                r.fail(err)
            return
        dt = time.monotonic() - t0
        self._record_latency(dt, ep.name)
        _tm.observe("serve.batch_latency_s", dt, endpoint=ep.name)
        _tm.observe("serve.batch_size", len(live), endpoint=ep.name)
        if not isinstance(results, (list, tuple)) or \
                len(results) != len(live):
            got = (len(results) if isinstance(results, (list, tuple))
                   else type(results).__name__)
            err = RequestFailed(
                f"endpoint {ep.name!r} returned {got} results for "
                f"{len(live)} requests (contract: one per payload, "
                "in order)")
            _tm.count("serve.failed", n=len(live), endpoint=ep.name)
            for r in live:
                r.fail(err)
            return
        with _tm.span("serve.resolve", endpoint=ep.name, size=len(live)):
            done = time.monotonic()
            for r, v in zip(live, results):
                r.resolve(v)
                _tm.observe("serve.request_latency_s", done - r.enqueued,
                            endpoint=ep.name)
                # per-endpoint SLO histogram: submit-to-resolve latency
                # into fixed buckets -> da_tpu_serve_slo_request_s_bucket
                _tm.observe("serve.slo.request_s", done - r.enqueued,
                            buckets=_SLO_BUCKETS, endpoint=ep.name)
            _tm.count("serve.completed", n=len(live), endpoint=ep.name)

    # -- lifecycle ---------------------------------------------------------

    def drain(self, timeout: float | None = None) -> bool:
        """Graceful drain: stop admitting (submits now raise
        :class:`Draining`), wake any sleeping retry backoff, flush every
        queued batch, and wait for in-flight dispatches.  Returns True
        when the queue and in-flight set emptied within ``timeout``."""
        with self._lock:
            if self._closed and not self._started:
                return True
            self._draining = True
        if _tm.enabled():
            # cold path: one event per drain
            _tm.event("serve", "drain", depth=self._queue.depth())
        self._drain_wake.set()
        self._queue.wake()
        deadline = time.monotonic() + (self.config.drain_timeout_s
                                       if timeout is None else timeout)
        # idle() counts claimed-but-not-yet-dispatched batches under the
        # queue's own lock, so "queue empty" can never race a batch that
        # left the queue but hasn't reached its dispatcher yet
        while time.monotonic() < deadline:
            if self._queue.idle() and self._inflight == 0:
                return True
            with self._inflight_cv:
                self._inflight_cv.wait(0.02)
        return self._queue.idle() and self._inflight == 0

    def close(self, *, drain: bool = True, timeout: float | None = None,
              closeall: bool = False) -> None:
        """Shut down: optionally drain first, stop workers, and (with
        ``closeall=True`` — the SIGTERM path) release every registered
        DArray via ``d_closeall``.  Requests still queued after the drain
        timeout fail typed, never silently."""
        drained = self.drain(timeout) if drain else False
        with self._lock:
            self._closed = True
        self._queue.close()
        if not drained:
            # whatever is still queued resolves typed — never a hang
            while True:
                batch = self._queue.next_batch(
                    lambda _e: (1 << 30, 0.0), wait_s=0.0)
                if not batch:
                    break
                for r in batch:
                    r.fail(Draining("server closed before this request "
                                    "could be dispatched"))
                self._queue.task_done()
        for t in self._workers:
            t.join(2.0)
        if closeall:
            core.d_closeall()
        if _tm.enabled():
            # cold path: one event per close
            _tm.event("serve", "close", drained=drained)

    def __enter__(self) -> "Server":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- introspection -----------------------------------------------------

    def stats(self) -> dict:
        """Live snapshot for dashboards/tests: queue depth, rolling
        latency percentiles, in-flight batches, drain state."""
        return {
            "queue_depth": self._queue.depth(),
            "inflight": self._inflight,
            "draining": self._draining,
            "closed": self._closed,
            "latency_p50_s": self._admission.latency.p50(),
            "latency_p99_s": self._admission.latency.p99(),
            "latency_samples": self._admission.latency.count(),
            "endpoints": sorted(self._endpoints),
        }


def install_sigterm(server: Server, *, closeall: bool = True) -> bool:
    """Install a SIGTERM handler that gracefully drains ``server`` (stop
    admitting → flush batches → ``d_closeall`` when ``closeall``) and
    then honors the previous disposition: a callable prior handler is
    chained; ``SIG_DFL`` is restored and the signal re-delivered, so the
    process still terminates after the drain (a k8s/systemd stop must
    not leave a drained-but-running zombie sitting out its grace
    period).  Main thread only (signal module restriction); returns
    False when not installable."""
    if threading.current_thread() is not threading.main_thread():
        return False
    prev = signal.getsignal(signal.SIGTERM)

    def _handler(signum, frame):
        server.close(drain=True, closeall=closeall)
        if callable(prev):
            prev(signum, frame)
        elif prev == signal.SIG_DFL or prev is None:
            # None = a disposition installed by non-Python code we cannot
            # re-invoke; default-terminate is the only no-zombie choice
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)

    signal.signal(signal.SIGTERM, _handler)
    return True
