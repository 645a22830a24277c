"""Admission control and backpressure signals for the serving layer.

PyTorch counterpart of ``distributedarrays_tpu/serve/admission.py``; the
HBM shed reads the port's memory ledger (``telemetry.memory.live_bytes``:
the bytes of every tracked DArray's rank tensors, on all devices).

Three gates decide whether a request is admitted.  The server-capacity
gates run first; the per-tenant token bucket runs LAST because it
consumes a token on success — a request the server's own capacity
refuses must not drain the tenant's allowance:

1. **Bounded queue depth** — the queue never grows past
   ``max_queue``; excess requests get :class:`~.errors.Overloaded` with a
   ``retry_after`` derived from the measured drain rate.
2. **Live backpressure signals**: the memory ledger's live-byte gauge
   against a configured budget, and the
   rolling p99 of dispatch latency (:class:`LatencyWindow` over the
   ``serve.dispatch`` span durations).  Either signal over threshold
   sheds with a typed ``Overloaded`` instead of letting the queue (and
   HBM) grow unboundedly.
3. **Per-tenant token bucket** (:class:`TokenBucket`) — sustained
   request-rate quotas with a burst allowance.  An empty bucket rejects
   with :class:`~.errors.QuotaExceeded` carrying the exact refill time.

Every rejection is counted (``serve.shed{reason=}``) so the Prometheus
export shows shed rate next to queue depth and admitted throughput.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from .. import telemetry as _tm
from .errors import Overloaded, QuotaExceeded

__all__ = ["TokenBucket", "LatencyWindow", "AdmissionController"]


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/second refill, ``burst``
    capacity.  ``try_take`` returns 0.0 on success, else the seconds
    until one token is available (the ``retry_after`` the caller ships)."""

    def __init__(self, rate: float, burst: float):
        if rate <= 0 or burst <= 0:
            raise ValueError(f"rate ({rate}) and burst ({burst}) must be "
                             "positive")
        self.rate = float(rate)
        self.burst = float(burst)
        self._tokens = float(burst)
        self._stamp = time.monotonic()
        self._lock = threading.Lock()

    def try_take(self, n: float = 1.0) -> float:
        now = time.monotonic()
        with self._lock:
            self._tokens = min(self.burst,
                               self._tokens + (now - self._stamp) * self.rate)
            self._stamp = now
            if self._tokens >= n:
                self._tokens -= n
                return 0.0
            return (n - self._tokens) / self.rate

    def level(self) -> float:
        """Tokens remaining as of the last refill (no refill applied —
        an observability read, not an admission decision)."""
        with self._lock:
            return self._tokens


class LatencyWindow:
    """Rolling window of recent latencies with percentile queries — the
    *rolling* complement of ``telemetry.span_stats`` (which aggregates
    since process start and can never recover from a slow past).  Feeds
    both the p99 shed signal and the drain-rate ``retry_after`` estimate."""

    def __init__(self, maxlen: int = 256):
        self._samples: deque = deque(maxlen=maxlen)
        self._lock = threading.Lock()

    def record(self, seconds: float) -> None:
        with self._lock:
            self._samples.append(float(seconds))

    def count(self) -> int:
        with self._lock:
            return len(self._samples)

    def mean(self) -> float:
        with self._lock:
            return (sum(self._samples) / len(self._samples)
                    if self._samples else 0.0)

    def percentile(self, q: float) -> float:
        """q in [0, 100]; 0.0 with no samples."""
        with self._lock:
            if not self._samples:
                return 0.0
            s = sorted(self._samples)
        idx = min(len(s) - 1, max(0, int(round((q / 100.0) * (len(s) - 1)))))
        return s[idx]

    def p50(self) -> float:
        return self.percentile(50)

    def p99(self) -> float:
        return self.percentile(99)


class AdmissionController:
    """The submit-time gatekeeper.  Owns the per-tenant buckets and the
    rolling dispatch-latency window; the server calls :meth:`admit` with
    the current queue depth and either returns (admitted) or receives a
    typed rejection to raise."""

    def __init__(self, *, max_queue: int, tenant_rate: float,
                 tenant_burst: float, hbm_budget_bytes: int | None = None,
                 hbm_shed_fraction: float = 0.9,
                 p99_shed_s: float | None = None,
                 max_batch: int = 8, window: int = 256,
                 endpoint_windows: dict[str, int] | None = None,
                 reclaimable_fn=None,
                 min_retry_after: float = 0.05,
                 max_retry_after: float = 5.0):
        self.max_queue = int(max_queue)
        self.tenant_rate = float(tenant_rate)
        self.tenant_burst = float(tenant_burst)
        self.hbm_budget_bytes = hbm_budget_bytes
        self.hbm_shed_fraction = float(hbm_shed_fraction)
        self.p99_shed_s = p99_shed_s
        self.max_batch = int(max_batch)
        self.min_retry_after = float(min_retry_after)
        self.max_retry_after = float(max_retry_after)
        self.window = int(window)
        self.latency = LatencyWindow(maxlen=window)
        # bytes an HBM shed could reclaim right now (idle-evictable KV
        # pages); set by the owner of reclaimable state (decode engine)
        self.reclaimable_fn = reclaimable_fn
        self._endpoint_windows = dict(endpoint_windows or {})
        self._ep_latency: dict[str, LatencyWindow] = {}
        self._buckets: dict[str, TokenBucket] = {}
        self._bucket_overrides: dict[str, tuple[float, float]] = {}
        self._lock = threading.Lock()

    # -- quotas ------------------------------------------------------------

    def set_quota(self, tenant: str, rate: float, burst: float) -> None:
        """Per-tenant override of the default (rate, burst) quota."""
        with self._lock:
            self._bucket_overrides[tenant] = (float(rate), float(burst))
            self._buckets.pop(tenant, None)   # rebuilt with the new quota

    def _bucket(self, tenant: str) -> TokenBucket:
        with self._lock:
            b = self._buckets.get(tenant)
            if b is None:
                rate, burst = self._bucket_overrides.get(
                    tenant, (self.tenant_rate, self.tenant_burst))
                b = self._buckets[tenant] = TokenBucket(rate, burst)
            return b

    def token_level(self, tenant: str) -> float:
        """Remaining quota tokens for ``tenant`` — an observability
        read (no refill applied), for the server's per-tenant token
        gauge."""
        return self._bucket(tenant).level()

    # -- per-endpoint latency windows --------------------------------------

    def set_endpoint_window(self, endpoint: str, maxlen: int) -> None:
        """Per-endpoint p99 window size override (a cheap endpoint with
        high request rates wants a larger window than a heavy one —
        otherwise the percentile flaps on a handful of samples).  Drops
        any window already accumulated for ``endpoint``."""
        with self._lock:
            self._endpoint_windows[endpoint] = int(maxlen)
            self._ep_latency.pop(endpoint, None)

    def endpoint_latency(self, endpoint: str) -> LatencyWindow:
        """The rolling window for ``endpoint``, created lazily at its
        configured size (``endpoint_windows`` override, else the global
        ``window``)."""
        with self._lock:
            w = self._ep_latency.get(endpoint)
            if w is None:
                size = self._endpoint_windows.get(endpoint, self.window)
                w = self._ep_latency[endpoint] = LatencyWindow(maxlen=size)
            return w

    def record_latency(self, seconds: float,
                       endpoint: str | None = None) -> None:
        """Record one dispatch latency into the global window (the shed
        signal) and, when named, the endpoint's own window (the
        per-endpoint p99 gauge)."""
        self.latency.record(seconds)
        if endpoint is not None:
            self.endpoint_latency(endpoint).record(seconds)

    # -- retry_after estimation --------------------------------------------

    def _clamp(self, s: float) -> float:
        return min(self.max_retry_after, max(self.min_retry_after, s))

    def drain_estimate(self, queue_depth: int) -> float:
        """Seconds until the current backlog drains: depth over measured
        throughput (max_batch requests per mean batch latency).  With no
        latency samples yet, the clamp floor is the honest answer."""
        mean = self.latency.mean()
        if mean <= 0:
            return self.min_retry_after
        per_req = mean / max(1, self.max_batch)
        return self._clamp(queue_depth * per_req)

    # -- the gate ----------------------------------------------------------

    def admit(self, tenant: str, queue_depth: int) -> None:
        """Raise a typed rejection, or return on admission.  Order:
        queue depth, HBM budget, rolling p99, then quota — the token
        bucket CONSUMES on success, so it must be the last gate: a
        request shed by an earlier gate never drains the tenant's
        bucket (it was the server's capacity that refused, not the
        tenant's allowance, and the shipped retry_after must reflect
        the real reason)."""
        if queue_depth >= self.max_queue:
            ra = self.drain_estimate(queue_depth)
            _tm.count("serve.shed", reason="queue", tenant=tenant)
            raise Overloaded(
                f"queue depth {queue_depth} at bound {self.max_queue}; "
                f"retry in {ra:.3f}s", retry_after=ra, reason="queue",
                tenant=tenant)
        if self.hbm_budget_bytes is not None:
            live = _tm.memory.live_bytes()
            bound = self.hbm_shed_fraction * self.hbm_budget_bytes
            if live >= bound:
                # retry_after must not over-estimate when the pressure
                # is reclaimable: idle-evictable KV pages free at the
                # next eviction sweep, not at queue-drain pace
                reclaim = 0
                if self.reclaimable_fn is not None:
                    try:
                        reclaim = int(self.reclaimable_fn())
                    except Exception:   # noqa: BLE001 — advisory signal
                        reclaim = 0
                if live - reclaim < bound:
                    ra = self.min_retry_after
                else:
                    ra = self.drain_estimate(max(queue_depth, 1))
                _tm.count("serve.shed", reason="hbm", tenant=tenant)
                raise Overloaded(
                    f"HBM live bytes {live} over "
                    f"{self.hbm_shed_fraction:.0%} of budget "
                    f"{self.hbm_budget_bytes}"
                    + (f" ({reclaim} reclaimable by eviction)"
                       if reclaim else "")
                    + f"; retry in {ra:.3f}s",
                    retry_after=ra, reason="hbm", tenant=tenant)
        if self.p99_shed_s is not None and self.latency.count() >= 8:
            p99 = self.latency.p99()
            if p99 >= self.p99_shed_s:
                ra = self.drain_estimate(max(queue_depth, 1))
                _tm.count("serve.shed", reason="latency", tenant=tenant)
                raise Overloaded(
                    f"rolling dispatch p99 {p99:.3f}s over shed threshold "
                    f"{self.p99_shed_s:.3f}s; retry in {ra:.3f}s",
                    retry_after=ra, reason="latency", tenant=tenant)
        wait = self._bucket(tenant).try_take()
        if wait > 0:
            _tm.count("serve.shed", reason="quota", tenant=tenant)
            # unclamped: retry_after here is the EXACT token refill time
            # (the clamp is for the capacity gates' drain estimates); a
            # clamped value would tell a slow-quota client to retry
            # before its bucket can possibly hold a token
            raise QuotaExceeded(
                f"tenant {tenant!r} quota exhausted "
                f"(rate={self._bucket(tenant).rate:g}/s, "
                f"burst={self._bucket(tenant).burst:g}); "
                f"retry in {wait:.3f}s",
                retry_after=wait, tenant=tenant)
