"""Typed serving errors: every request resolves to a result or one of these.

PyTorch counterpart of ``distributedarrays_tpu/serve/errors.py`` (the same
classes and fields: ``reason``, ``tenant``, ``retry_after``, ``stage``).

The serving layer's core robustness contract is that nothing is ever
silent: an inadmissible request is *rejected at submit time* with a typed
exception the caller can act on (``retry_after`` for backoff, ``reason``
for dashboards), and an admitted request's future always resolves — a
correct result, a :class:`DeadlineExceeded`, or a :class:`RequestFailed`
wrapping the root cause after the recovery executor gave up.  A client
should never need to string-match error text to decide whether to retry.

Hierarchy::

    ServeError
    ├── Rejected            (refused at admission — never enqueued)
    │   ├── Overloaded      (backpressure: queue/HBM/latency; retry_after)
    │   │   └── QuotaExceeded  (per-tenant token bucket; retry_after)
    │   └── Draining        (server is shutting down; do not retry here)
    ├── DeadlineExceeded    (budget expired at enqueue/batch/dispatch)
    ├── Cancelled           (client cancelled a streaming sequence;
    │                        its pages were freed immediately)
    └── RequestFailed       (dispatch failed after recovery gave up;
                             __cause__ carries the root failure)
"""

from __future__ import annotations

__all__ = ["ServeError", "Rejected", "Overloaded", "QuotaExceeded",
           "Draining", "DeadlineExceeded", "Cancelled", "RequestFailed"]


class ServeError(RuntimeError):
    """Base class for every typed serving-layer error."""


class Rejected(ServeError):
    """Refused at admission — the request was never enqueued.

    ``reason`` is a stable machine-readable slug (``"queue"``, ``"hbm"``,
    ``"latency"``, ``"quota"``, ``"draining"``); ``tenant`` the submitting
    tenant."""

    def __init__(self, message: str, *, reason: str, tenant: str = ""):
        super().__init__(message)
        self.reason = reason
        self.tenant = tenant


class Overloaded(Rejected):
    """Backpressure rejection: the server is shedding load instead of
    growing its queue or HBM footprint without bound.

    ``retry_after`` (seconds) is the server's drain-rate estimate of when
    capacity returns — clients should back off at least that long."""

    def __init__(self, message: str, *, retry_after: float,
                 reason: str = "overloaded", tenant: str = ""):
        super().__init__(message, reason=reason, tenant=tenant)
        self.retry_after = float(retry_after)


class QuotaExceeded(Overloaded):
    """The tenant's token bucket is empty; ``retry_after`` is the refill
    time for one token.  A subclass of :class:`Overloaded` so generic
    back-off handling catches both."""

    def __init__(self, message: str, *, retry_after: float,
                 tenant: str = ""):
        super().__init__(message, retry_after=retry_after, reason="quota",
                         tenant=tenant)


class Draining(Rejected):
    """The server is draining (shutdown/SIGTERM): admission is closed,
    in-flight and queued work still completes.  Retrying against this
    instance is pointless — failover elsewhere."""

    def __init__(self, message: str = "server is draining; "
                 "admission closed", *, tenant: str = ""):
        super().__init__(message, reason="draining", tenant=tenant)


class DeadlineExceeded(ServeError):
    """The request's deadline budget expired — at enqueue (already dead on
    arrival), at batch formation, or at dispatch.  Expired work is never
    dispatched; ``stage`` says which gate tripped."""

    def __init__(self, message: str, *, stage: str = "enqueue"):
        super().__init__(message)
        self.stage = stage


class Cancelled(ServeError):
    """The client cancelled a streaming sequence (``TokenStream.cancel``).
    Cancellation is immediate on the resource side — the sequence's KV
    pages return to the pool before this surfaces to any waiter."""


class RequestFailed(ServeError):
    """Dispatch failed and the recovery executor gave up (or was
    interrupted by drain).  ``__cause__`` carries the root failure —
    classification, retries, shrink/restore already happened per the
    resilience decision table before this surfaced."""
