"""Continuous batching: coalesce compatible requests into one dispatch.

PyTorch counterpart of ``distributedarrays_tpu/serve/batching.py``.  A
torch tensor or a port ``DArray`` payload keys like JAX's numpy or jax
array: by shape and dtype, the dtype named as numpy names it
(``torch.float32`` keys as ``float32``), so the same payloads give the
same keys in both packages.

The unit of device work is a *batch*: the oldest queued request picks the
batch's compatibility key (endpoint + payload signature), and the batcher
collects up to ``max_batch`` same-key requests, waiting at most
``flush_s`` past the head request's arrival for stragglers — flush on
batch-full OR deadline, whichever first.  Requests with other keys stay
queued in arrival order for the next batch, so one hot shape cannot
starve another endpoint forever (each pass re-starts from the current
head).

Deadline discipline: a request whose budget expires while queued is
resolved with :class:`~.errors.DeadlineExceeded` *at batch formation* and
never dispatched; the server applies the same check once more immediately
before dispatch.  Futures are resolved exactly once — late outcomes
(e.g. a batch result arriving after the request was expired) are dropped.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Any

import numpy as np

from .. import telemetry as _tm
from .errors import DeadlineExceeded

__all__ = ["Request", "payload_key", "BatchQueue"]


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def payload_key(payload: Any) -> Any:
    """Default batch-compatibility signature of a payload: arrays, tensors
    and DArrays by (shape, dtype); tuples/lists elementwise; everything
    else by type.
    Two requests coalesce only when their keys match — stacking
    mixed-shape payloads into one device program would retrace per
    batch instead of reusing one compilation."""
    if hasattr(payload, "shape") and hasattr(payload, "dtype"):
        if str(payload.dtype) == "object":
            # ragged container: (shape, dtype) says nothing about the
            # elements — two object arrays holding different-length
            # prompts must NOT coalesce (stacking them crashes at
            # dispatch); key elementwise like a sequence
            return ("array_obj", tuple(payload.shape),
                    tuple(payload_key(p) for p in np.asarray(payload).flat))
        return ("array", tuple(payload.shape), _dtype_name(payload.dtype))
    if isinstance(payload, (tuple, list)):
        return ("seq", type(payload).__name__,
                tuple(payload_key(p) for p in payload))
    if isinstance(payload, dict):
        # sort by repr so mixed-type keys (a legal JSON-ish payload)
        # cannot raise an untyped TypeError out of submit()
        return ("map", tuple(sorted(((repr(k), payload_key(v))
                                     for k, v in payload.items()))))
    if isinstance(payload, (int, float, complex, bool, str, bytes,
                            np.generic)) or payload is None:
        return ("scalar", type(payload).__name__)
    return ("obj", type(payload).__name__)


@dataclasses.dataclass
class Request:
    """One admitted request: payload plus routing/budget metadata and the
    future the caller holds.  ``deadline``/``enqueued`` are monotonic
    seconds (``time.monotonic``).  ``trace_id`` is the request-scoped
    trace id minted at submit — every span from submit through batch
    dispatch, recovery retries, and rank steps carries it."""

    endpoint: str
    payload: Any
    tenant: str
    key: Any
    deadline: float
    enqueued: float
    trace_id: str = ""
    future: Future = dataclasses.field(default_factory=Future)

    def remaining(self, now: float | None = None) -> float:
        return self.deadline - (time.monotonic() if now is None else now)

    def resolve(self, value: Any) -> bool:
        """Resolve the future with a result; False if already resolved."""
        if self.future.set_running_or_notify_cancel():
            self.future.set_result(value)
            return True
        return False   # pragma: no cover — cancelled future

    def fail(self, exc: BaseException) -> bool:
        """Resolve the future with a typed error; False if already done."""
        if self.future.set_running_or_notify_cancel():
            self.future.set_exception(exc)
            return True
        return False   # pragma: no cover — cancelled future

    def expire(self, stage: str) -> None:
        """Resolve with DeadlineExceeded at gate ``stage`` and count it."""
        _tm.count("serve.expired", stage=stage)
        self.fail(DeadlineExceeded(
            f"request deadline expired at {stage} "
            f"(budget overrun {-self.remaining():.3f}s, "
            f"endpoint={self.endpoint}, tenant={self.tenant})",
            stage=stage))


class BatchQueue:
    """Bounded FIFO of admitted requests with key-coalescing batch
    extraction.  Thread-safe; multiple dispatch workers may call
    :meth:`next_batch` concurrently."""

    def __init__(self):
        self._q: list[Request] = []
        self._cond = threading.Condition()
        self._closed = False
        # batches handed out by next_batch but not yet task_done()'d:
        # counted under the SAME lock as the removal, so an emptiness
        # check can never observe "queue empty" while a claimed batch
        # has not yet reached its dispatcher (the drain TOCTOU)
        self._claimed = 0
        # set under the condition when the queue shrinks; the journaled
        # depth gauge (file I/O) is emitted only after the lock drops
        self._depth_dirty = False

    def depth(self) -> int:
        with self._cond:
            return len(self._q)

    def idle(self) -> bool:
        """True iff nothing is queued AND nothing is claimed-in-flight —
        the drain/close emptiness predicate."""
        with self._cond:
            return not self._q and self._claimed == 0

    def task_done(self) -> None:
        """The dispatcher finished (or typed-failed) a claimed batch."""
        with self._cond:
            self._claimed -= 1
            self._cond.notify_all()

    def put(self, req: Request) -> None:
        with self._cond:
            if self._closed:
                raise RuntimeError("queue closed")   # server gates earlier
            self._q.append(req)
            depth = len(self._q)
            self._cond.notify_all()
        # journaled gauge OUTSIDE the condition (the queue-depth history
        # reconstructs as a Perfetto counter track): the journal write is
        # file I/O and must never serialize producers on the queue lock
        _tm.set_gauge("serve.queue_depth", depth, journal=True)

    def close(self) -> None:
        """Stop waits: next_batch drains what is queued, then returns
        None forever.  put() after close is a server bug, not a client
        error — the server rejects at admission first."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def wake(self) -> None:
        with self._cond:
            self._cond.notify_all()

    def _reap_expired_locked(self, now: float, dead: list) -> None:
        expired = [r for r in self._q if r.deadline <= now]
        if expired:
            self._q = [r for r in self._q if r.deadline > now]
            self._depth_dirty = True     # gauge emitted after unlock
            dead.extend(expired)

    def next_batch(self, limits, wait_s: float = 0.2) -> \
            list[Request] | None:
        """Form the next batch, blocking up to ``wait_s`` for work.

        ``limits(endpoint) -> (max_batch, flush_s)`` resolves the head
        request's per-endpoint bounds once its endpoint is known — the
        queue itself is endpoint-agnostic.  Returns None on a
        (momentarily) empty queue — the caller loops, checking its own
        stop condition — and None immediately once closed AND empty.
        Otherwise returns 1..max_batch same-key requests, all with
        unexpired deadlines, counted as claimed until the caller's
        :meth:`task_done`.
        """
        dead: list[Request] = []
        try:
            return self._form_batch(limits, wait_s, dead)
        finally:
            # futures resolve OUTSIDE the queue lock: Future callbacks
            # are user code and must not run with internal locks held —
            # and the journaled depth gauge (file I/O) flushes here for
            # the same reason
            if self._depth_dirty:
                with self._cond:
                    self._depth_dirty = False
                    depth = len(self._q)
                _tm.set_gauge("serve.queue_depth", depth, journal=True)
            for r in dead:
                r.expire("batch")

    def _form_batch(self, limits, wait_s: float,
                    dead: list) -> list[Request] | None:
        deadline = time.monotonic() + wait_s
        with self._cond:
            while True:
                self._reap_expired_locked(time.monotonic(), dead)
                if self._q:
                    break
                if self._closed:
                    return None
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._cond.wait(min(remaining, 0.05))
            head = self._q[0]
            key = (head.endpoint, head.key)
            max_batch, flush_s = limits(head.endpoint)
            flush_at = head.enqueued + flush_s
            while True:
                now = time.monotonic()
                self._reap_expired_locked(now, dead)
                matching = [r for r in self._q
                            if (r.endpoint, r.key) == key]
                if not matching:
                    # every candidate expired while we waited: start over
                    return None
                if (len(matching) >= max_batch or now >= flush_at
                        or self._closed):
                    batch = matching[:max_batch]
                    taken = set(map(id, batch))
                    self._q = [r for r in self._q if id(r) not in taken]
                    self._claimed += 1     # atomic with the removal
                    self._depth_dirty = True
                    return batch
                self._cond.wait(min(flush_at - now, 0.05))
