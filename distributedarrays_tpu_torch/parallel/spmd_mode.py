"""MPI-style SPMD mode: the dynamic half of the reference's layer L5.

PyTorch counterpart of ``distributedarrays_tpu/parallel/spmd_mode.py`` (its
whole ``__all__``), itself the counterpart of the reference's ``spmd.jl``.
``spmd(f, ...)`` runs ``f`` once per rank, each rank a Python thread of the
controller (``backend="thread"``) or a forked process
(``backend="process"``, ``parallel/spmd_process.py``).  Ranks exchange
messages through in-memory mailboxes with the reference's semantics:
tagged matching with out-of-order buffering, contexts that isolate traffic
and carry context-local storage, barrier generations, and collectives
(``barrier``, ``bcast``, ``scatter``, ``gather_spmd``) built from sends.
A rank that fails sets the run's failure flag, which aborts its peers'
receives; a failed run on an explicit context drains its mailboxes and
resynchronizes its barrier generations.  Receives time out after
``DA_TPU_SPMD_TIMEOUT`` seconds (60 by default), read on every call.

Inside a rank task ``core.current_rank()`` is the task's rank (it is
thread-local), so ``localpart(d)``, ``d.lp`` and ``set_localpart`` address
that rank's chunk, and on the thread backend each task's current CUDA
device is its rank's device (``layout.device_of``), so a task that
launches on the card launches on its own.

The reference serializes every message, so a receiver always gets a copy.
Torch tensors are mutable, so ``sendto`` and the collectives copy tensor
and numpy payloads (and lists, tuples and dicts of them) when they send:
a write by the sender after the send, or by one receiver of a ``bcast``,
never shows at another rank.  DArrays and other objects are passed by
reference, as in the JAX package.

Telemetry, divergence checking and fault sites as in JAX: the ``spmd.run``
trace, the per-rank ``spmd.step`` span and the aggregate-only
``spmd.mailbox.drain`` span, the ``spmd.runs``/``spmd.recv``/
``spmd.barrier`` counters, ``record_comm("spmd_send")`` per send, one
flight-recorder bundle per failed run, the collective-divergence checker
(``DA_TPU_CHECK_DIVERGENCE=1``, thread backend) and the ``spmd.rank`` /
``spmd.collective`` fault sites.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from .. import core
from .. import layout as L
from .. import telemetry as _tm
from ..analysis import divergence as _dv
from ..resilience import faults as _fl

__all__ = [
    "spmd", "spmd_async", "sendto", "recvfrom", "recvfrom_any", "barrier",
    "bcast", "scatter", "gather_spmd", "context", "context_local_storage",
    "myid", "nprocs", "SPMDContext", "close_context",
]

_TIMEOUT_ENV = "DA_TPU_SPMD_TIMEOUT"
_DEFAULT_TIMEOUT = 60.0


def _default_timeout() -> float:
    """The receive timeout: ``DA_TPU_SPMD_TIMEOUT`` seconds when set, else
    60, read on every call (JAX ``spmd_mode.py:54``)."""
    try:
        return float(os.environ.get(_TIMEOUT_ENV, _DEFAULT_TIMEOUT))
    except ValueError:
        return _DEFAULT_TIMEOUT


_PEER_ABORT = "SPMD peer task failed; aborting receive"


def _record_crash(exc) -> None:
    """One flight-recorder bundle for a failed run (JAX
    ``spmd_mode.py:65``); the recorder never masks the real error."""
    if _tm.enabled():
        try:
            _tm.flight.record_crash(exc, where="spmd")
        except Exception:
            pass


def _copied(data: Any) -> Any:
    """A copy of a message payload as the receiver must see it: tensors
    cloned, numpy arrays copied, lists, tuples and dicts rebuilt around
    their copied items; anything else (a DArray included) as it is."""
    if isinstance(data, torch.Tensor):
        return data.clone()
    if isinstance(data, np.ndarray):
        return data.copy()
    if isinstance(data, (list, tuple)):
        items = [_copied(x) for x in data]
        if isinstance(data, tuple):
            return type(data)(*items) if hasattr(data, "_fields") \
                else tuple(items)
        return items
    if isinstance(data, dict):
        return {k: _copied(v) for k, v in data.items()}
    return data


def _scan_stash(msgs: list, match: Callable[[tuple], bool]):
    """Pop and return the first stashed message satisfying ``match`` (the
    reference's out-of-order buffering), else None."""
    for i, m in enumerate(msgs):
        if match(m):
            return msgs.pop(i)
    return None


def _timeout_source(timeout: float) -> str:
    """Where the effective receive timeout came from (JAX
    ``spmd_mode.py:91``)."""
    configured = os.environ.get(_TIMEOUT_ENV)
    if configured is not None:
        try:
            if float(configured) == timeout:
                return f"{_TIMEOUT_ENV}={configured}"
        except ValueError:
            if timeout == _DEFAULT_TIMEOUT:
                return (f"{_TIMEOUT_ENV}={configured!r} invalid, using "
                        f"default {_DEFAULT_TIMEOUT:g}s")
        return "explicit timeout argument"
    if timeout == _DEFAULT_TIMEOUT:
        return f"default {_DEFAULT_TIMEOUT:g}s; set {_TIMEOUT_ENV}"
    return "explicit timeout argument"


def _receive_timeout(timeout: float, msgs: list,
                     tag: Any = None) -> TimeoutError:
    return TimeoutError(
        f"SPMD receive timed out after {timeout}s "
        f"({_timeout_source(timeout)}) blocked on tag={tag!r} "
        f"(pending: {[(m[0], m[1], m[3]) for m in msgs[:8]]})")


class _Mailbox:
    """One (context, rank) message store with tag, type and source
    matching and out-of-order buffering (JAX ``spmd_mode.py:119``)."""

    def __init__(self):
        self._msgs: list[tuple] = []          # (typ, from_pid, data, tag)
        self._cond = threading.Condition()

    def put(self, msg: tuple):
        with self._cond:
            self._msgs.append(msg)
            self._cond.notify_all()

    def take(self, match: Callable[[tuple], bool], failed: threading.Event,
             timeout: float, tag: Any = None):
        # the blocked time, aggregate-only: a chatty ring would flood the
        # journal
        with _tm.span("spmd.mailbox.drain", _journal=False):
            deadline = time.monotonic() + timeout
            with self._cond:
                while True:
                    m = _scan_stash(self._msgs, match)
                    if m is not None:
                        return m
                    if failed.is_set():
                        raise RuntimeError(_PEER_ABORT)
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise _receive_timeout(timeout, self._msgs, tag)
                    self._cond.wait(min(remaining, 0.1))


class SPMDContext:
    """An execution context: isolated message traffic and per-rank local
    storage (JAX ``spmd_mode.py:153``, the reference's ``SPMDContext``)."""

    def __init__(self, pids: Sequence[int] | None = None):
        self.id = core.next_did()
        self.pids = [int(p) for p in (pids if pids is not None
                                      else L.all_ranks())]
        self.store: dict[int, dict] = {p: {} for p in self.pids}
        self._mailboxes = {p: _Mailbox() for p in self.pids}
        self._barrier_gen: dict[int, int] = {p: 0 for p in self.pids}
        self._failed = threading.Event()
        self._proc_state = None   # the process backend's leftover messages
        # the run's divergence checker, set and cleared by spmd()
        self._divergence = None

    def mailbox(self, pid: int) -> _Mailbox:
        try:
            return self._mailboxes[pid]
        except KeyError:
            raise ValueError(f"rank {pid} is not in context {self.id} "
                             f"(pids={self.pids})") from None

    def close(self):
        """Free the message state and the storage."""
        self._mailboxes = {p: _Mailbox() for p in self.pids}
        self.store = {p: {} for p in self.pids}
        self._proc_state = None

    def _reset_comm(self):
        """Drain in-flight messages and resynchronize the barrier
        generations after a failed run, keeping the storage."""
        self._mailboxes = {p: _Mailbox() for p in self.pids}
        self._barrier_gen = {p: 0 for p in self.pids}
        self._failed = threading.Event()
        self._proc_state = None


_CONTEXTS_LOCK = threading.Lock()
_CONTEXTS: dict = {}

_tls = threading.local()


def context(pids: Sequence[int] | None = None) -> SPMDContext:
    """An explicit SPMD context (JAX ``spmd_mode.py:207``)."""
    c = SPMDContext(pids)
    with _CONTEXTS_LOCK:
        _CONTEXTS[c.id] = c
    return c


def close_context(c: SPMDContext):
    """Forget and clear an explicit context (JAX ``spmd_mode.py:215``)."""
    with _CONTEXTS_LOCK:
        _CONTEXTS.pop(c.id, None)
    c.close()


def _current():
    ctx = getattr(_tls, "ctxt", None)
    if ctx is None:
        raise RuntimeError(
            "not inside an spmd() run: sendto/recvfrom/barrier/... are only "
            "meaningful within spmd(f, ...)")
    return ctx, core.current_rank()


def myid() -> int:
    """The calling task's rank (JAX ``spmd_mode.py:230``, the reference's
    ``myid()``)."""
    return core.current_rank()


def nprocs() -> int:
    """The run's rank count, or the table's outside a run (JAX
    ``spmd_mode.py:235``)."""
    ctx = getattr(_tls, "ctxt", None)
    return len(ctx.pids) if ctx is not None else L.nranks()


def context_local_storage() -> dict:
    """This rank's dict in the run's context, kept across runs on an
    explicit context (JAX ``spmd_mode.py:240``)."""
    ctx, rank = _current()
    return ctx.store[rank]


# ---------------------------------------------------------------------------
# point to point
# ---------------------------------------------------------------------------


def sendto(pid: int, data: Any, tag: Any = None):
    """Send ``data`` to rank ``pid`` without waiting; tensors and arrays
    are copied at the send (JAX ``spmd_mode.py:252``)."""
    ctx, rank = _current()
    if _tm.enabled():
        _tm.record_comm("spmd_send", _tm.nbytes_of(data), op="sendto",
                        once_key=f"spmd_send:{rank}->{pid}",
                        src=rank, dst=pid)
    ctx.mailbox(pid).put(("sendto", rank, _copied(data), tag))


def recvfrom(pid: int, tag: Any = None, timeout: float | None = None):
    """Wait for a message from ``pid`` with ``tag``; messages that arrive
    out of order stay buffered (JAX ``spmd_mode.py:267``)."""
    ctx, rank = _current()
    if timeout is None:
        timeout = _default_timeout()
    m = ctx.mailbox(rank).take(
        lambda m: m[0] == "sendto" and m[1] == pid and m[3] == tag,
        ctx._failed, timeout, tag=tag)
    _tm.count("spmd.recv")
    return m[2]


def recvfrom_any(tag: Any = None, timeout: float | None = None):
    """``(from_pid, data)`` of the first message with ``tag`` from any rank
    (JAX ``spmd_mode.py:282``)."""
    ctx, rank = _current()
    if timeout is None:
        timeout = _default_timeout()
    m = ctx.mailbox(rank).take(
        lambda m: m[0] == "sendto" and m[3] == tag, ctx._failed, timeout,
        tag=tag)
    _tm.count("spmd.recv")
    return m[1], m[2]


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _dv_note(ctx, rank: int, op: str, detail: str) -> None:
    """Record a collective with the run's divergence checker, if any (JAX
    ``spmd_mode.py:297``); raises ``CollectiveDivergenceError`` in the
    issuing rank on a mismatch."""
    ck = getattr(ctx, "_divergence", None)
    if ck is not None:
        ck.record(rank, op, detail)


def barrier(tag: Any = None, timeout: float | None = None):
    """Every rank waits for all; per-rank generation counters keep two
    barriers in a row apart (JAX ``spmd_mode.py:311``)."""
    ctx, rank = _current()
    _fl.check("spmd.collective", op="barrier", rank=rank)
    _dv_note(ctx, rank, "barrier", f"tag={tag!r}")
    _tm.count("spmd.barrier")
    if timeout is None:
        timeout = _default_timeout()
    gen = ctx._barrier_gen[rank]
    ctx._barrier_gen[rank] = gen + 1
    btag = ("barrier", gen, tag)
    for p in ctx.pids:
        ctx.mailbox(p).put(("barrier", rank, None, btag))
    for p in ctx.pids:
        ctx.mailbox(rank).take(
            lambda m, p=p: m[0] == "barrier" and m[1] == p and m[3] == btag,
            ctx._failed, timeout, tag=btag)


def _check_root(ctx, root):
    if root not in ctx.pids:
        raise ValueError(f"root {root} is not in context pids {ctx.pids}")


def bcast(data: Any, root: int, tag: Any = None,
          timeout: float | None = None):
    """``root``'s ``data`` on every rank, a copy on each other rank (JAX
    ``spmd_mode.py:336``)."""
    ctx, rank = _current()
    _check_root(ctx, root)
    _fl.check("spmd.collective", op="bcast", rank=rank)
    if timeout is None:
        timeout = _default_timeout()
    # no payload signature: only root's data takes part
    _dv_note(ctx, rank, "bcast", f"root={root}, tag={tag!r}")
    btag = ("bcast", tag)
    if rank == root:
        if _tm.enabled():
            _tm.record_comm("spmd_send",
                            _tm.nbytes_of(data) * (len(ctx.pids) - 1),
                            op="bcast", once_key=f"spmd_send:bcast:{root}",
                            src=root)
        for p in ctx.pids:
            if p != root:
                ctx.mailbox(p).put(("sendto", root, _copied(data), btag))
        return data
    m = ctx.mailbox(rank).take(
        lambda m: m[0] == "sendto" and m[1] == root and m[3] == btag,
        ctx._failed, timeout, tag=btag)
    return m[2]


def scatter(x, root: int, tag: Any = None, timeout: float | None = None):
    """Split ``x`` evenly over the ranks from ``root``; the length must
    divide (JAX ``spmd_mode.py:365``)."""
    ctx, rank = _current()
    _check_root(ctx, root)
    _fl.check("spmd.collective", op="scatter", rank=rank)
    if timeout is None:
        timeout = _default_timeout()
    _dv_note(ctx, rank, "scatter", f"root={root}, tag={tag!r}")
    stag = ("scatter", tag)
    if rank == root:
        n = len(x)
        if n % len(ctx.pids) != 0:
            raise ValueError(
                f"scatter: length {n} not divisible by {len(ctx.pids)} ranks")
        per = n // len(ctx.pids)
        if _tm.enabled():
            _tm.record_comm("spmd_send", _tm.nbytes_of(x), op="scatter",
                            once_key=f"spmd_send:scatter:{root}", src=root)
        mine = None
        for i, p in enumerate(ctx.pids):
            part = x[i * per:(i + 1) * per]
            if p == rank:
                mine = part
            else:
                ctx.mailbox(p).put(("sendto", root, _copied(part), stag))
        return mine
    m = ctx.mailbox(rank).take(
        lambda m: m[0] == "sendto" and m[1] == root and m[3] == stag,
        ctx._failed, timeout, tag=stag)
    return m[2]


def gather_spmd(x, root: int, tag: Any = None,
                timeout: float | None = None):
    """One value per rank at ``root``, in pid order; None elsewhere (JAX
    ``spmd_mode.py:399``)."""
    ctx, rank = _current()
    _check_root(ctx, root)
    _fl.check("spmd.collective", op="gather_spmd", rank=rank)
    if timeout is None:
        timeout = _default_timeout()
    _dv_note(ctx, rank, "gather_spmd",
             f"root={root}, tag={tag!r}, "
             f"payload={_dv.payload_signature(x)}")
    gtag = ("gather", tag)
    if rank != root:
        if _tm.enabled():
            _tm.record_comm("spmd_send", _tm.nbytes_of(x), op="gather",
                            once_key=f"spmd_send:gather:{rank}->{root}",
                            src=rank, dst=root)
        ctx.mailbox(root).put(("sendto", rank, _copied(x), gtag))
        return None
    out = {rank: x}
    for p in ctx.pids:
        if p == root:
            continue
        m = ctx.mailbox(rank).take(
            lambda m, p=p: m[0] == "sendto" and m[1] == p and m[3] == gtag,
            ctx._failed, timeout, tag=gtag)
        out[p] = m[2]
    return [out[p] for p in ctx.pids]


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


@_tm.traced(name="spmd.run")
def spmd(f: Callable, *args, pids: Sequence[int] | None = None,
         context: SPMDContext | None = None, timeout: float = 300.0,
         backend: str = "thread"):
    """Run ``f(*args)`` once per rank, concurrently, and return the ranks'
    results in pid order (JAX ``spmd_mode.py:437``).

    Each task runs with ``myid()`` set and in a fresh implicit context
    unless ``context`` is given (implicit contexts are cleared after the
    run).  ``backend="process"`` forks one process per rank
    (``parallel/spmd_process.py``): host-side work only, and messages,
    results and storage must pickle."""
    implicit = context is None
    ctx = SPMDContext(pids) if implicit else context
    if pids is not None and not implicit and list(pids) != ctx.pids:
        raise ValueError("pids disagree with explicit context's pids")
    _tm.count("spmd.runs", backend=backend)
    if _tm.enabled():
        _tm.annotate(backend=backend, ranks=len(ctx.pids))
        _tm.event("spmd", "run", backend=backend, ranks=len(ctx.pids),
                  once_key=f"spmd:run:{backend}:{len(ctx.pids)}")
    checker = None
    if _dv.checking():
        if backend == "thread":
            checker = _dv.DivergenceChecker(ctx.pids,
                                            on_mismatch=ctx._failed.set)
        else:
            # the process backend is not instrumented: say so once
            _tm.count("analysis.divergence_unchecked", backend=backend)
            if _tm.enabled():
                _tm.event("divergence", "unchecked_backend",
                          backend=backend, ranks=len(ctx.pids),
                          once_key=f"divergence:unchecked:{backend}")
            from ..utils.debug import warn_once
            warn_once("divergence:process-backend",
                      "DA_TPU_CHECK_DIVERGENCE is set but the process "
                      "backend is not instrumented; collective-divergence "
                      "checking only covers backend='thread'")
    ctx._divergence = checker
    if backend == "process":
        from .spmd_process import run_spmd_process
        try:
            res = run_spmd_process(f, args, ctx, timeout)
        except BaseException as e:
            _record_crash(e)
            if not implicit:
                ctx._reset_comm()
            raise
        finally:
            if implicit:
                ctx.close()
        return [res[p] for p in ctx.pids]
    if backend != "thread":
        raise ValueError(f"unknown spmd backend {backend!r} "
                         "(expected 'thread' or 'process')")
    dirty = False
    try:
        results = _fanout_thread_ranks(ctx, f, args, timeout, checker)
    except BaseException:
        dirty = True
        raise
    finally:
        ctx._divergence = None
        if implicit:
            ctx.close()
        elif dirty:
            ctx._reset_comm()
    return [results[p] for p in ctx.pids]


def _rank_device(rank: int):
    """The CUDA device of ``rank`` when it has one in the table, else
    None."""
    if 0 <= rank < L.nranks():
        dev = L.device_of(rank)
        if dev.type == "cuda":
            return dev
    return None


def _fanout_thread_ranks(ctx: SPMDContext, f: Callable, args: tuple,
                         timeout: float, checker=None) -> dict[int, Any]:
    """One daemon thread per rank, one deadline for the run, peer aborts,
    and the root cause raised before secondary failures, after one
    flight-recorder bundle (JAX ``spmd_mode.py:520``)."""
    results: dict[int, Any] = {}
    errors: dict[int, BaseException] = {}
    devices = {p: _rank_device(p) for p in ctx.pids}
    # contextvars do not cross thread starts: rebind the caller's trace
    # ids in each rank task
    trace_ids = _tm.current_trace_ids()

    def run(rank: int):
        core._rank_tls.rank = rank
        _tls.ctxt = ctx
        if trace_ids:
            _tm.tracing.bind_trace_ids(trace_ids)
        try:
            if devices[rank] is not None:
                torch.cuda.set_device(devices[rank])
            _fl.check("spmd.rank", rank=rank, backend="thread")
            # a fresh thread has no parent span: each rank's step is a root
            with _tm.span("spmd.step", rank=rank):
                results[rank] = f(*args)
            if checker is not None:
                # peers inside a collective past this rank's last can never
                # be matched: fail them now
                checker.finish(rank)
        except BaseException as e:  # noqa: BLE001 - raised by spmd()
            errors[rank] = e
            ctx._failed.set()
        finally:
            core._rank_tls.rank = 0
            _tls.ctxt = None

    threads = [threading.Thread(target=run, args=(p,), name=f"spmd-{p}",
                                daemon=True) for p in ctx.pids]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
        if t.is_alive():
            ctx._failed.set()
            for t2 in threads:
                t2.join(5)
            err = TimeoutError(
                f"spmd task {t.name} did not finish in {timeout}s")
            _record_crash(err)
            raise err
    if errors:
        def _secondary(e):
            # consequences, not causes: peer aborts, receive timeouts and
            # the divergence error itself
            return ((isinstance(e, RuntimeError)
                     and "peer task failed" in str(e))
                    or isinstance(e, (TimeoutError,
                                      _dv.CollectiveDivergenceError)))
        if (checker is not None and checker.error is not None
                and all(_secondary(e) for e in errors.values())):
            # the divergence is the root cause: raise it unwrapped
            _record_crash(checker.error)
            raise checker.error
        primary = [(r, e) for r, e in sorted(errors.items())
                   if not (isinstance(e, RuntimeError)
                           and "peer task failed" in str(e))]
        rank, err = primary[0] if primary else sorted(errors.items())[0]
        _record_crash(err)
        raise RuntimeError(
            f"spmd task on rank {rank} failed ({len(errors)} total failures)"
        ) from err
    if checker is not None:
        checker.verify()   # the backstop: identical sequences end to end
    return results


# ---------------------------------------------------------------------------
# async dispatch
# ---------------------------------------------------------------------------

_DISPATCHERS_ENV = "DA_TPU_SPMD_DISPATCHERS"
_dispatch_pool = None
_dispatch_lock = threading.Lock()


def _dispatcher():
    """The shared dispatch pool, ``DA_TPU_SPMD_DISPATCHERS`` threads (4 by
    default), made on first use (JAX ``spmd_mode.py:617``)."""
    global _dispatch_pool
    if _dispatch_pool is None:
        from concurrent.futures import ThreadPoolExecutor
        with _dispatch_lock:
            if _dispatch_pool is None:
                try:
                    n = int(os.environ.get(_DISPATCHERS_ENV, "4"))
                except ValueError:
                    n = 4
                _dispatch_pool = ThreadPoolExecutor(
                    max_workers=max(1, n),
                    thread_name_prefix="spmd-dispatch")
    return _dispatch_pool


def spmd_async(f: Callable, *args, pids: Sequence[int] | None = None,
               context: SPMDContext | None = None, timeout: float = 300.0,
               backend: str = "thread"):
    """``spmd`` on the shared dispatch pool: a ``concurrent.futures.Future``
    of the pid-ordered results, or of what ``spmd`` raises (JAX
    ``spmd_mode.py:636``)."""
    return _dispatcher().submit(
        lambda: spmd(f, *args, pids=pids, context=context, timeout=timeout,
                     backend=backend))
