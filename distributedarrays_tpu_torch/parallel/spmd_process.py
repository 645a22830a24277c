"""The process backend of SPMD mode: ``spmd(f, ..., backend="process")``.

PyTorch counterpart of ``distributedarrays_tpu/parallel/spmd_process.py``.
Each rank runs in a forked OS process, the single-host form of the
reference's ``addprocs`` workers, with ``spmd_mode``'s thread semantics:

- one fork per run: the children inherit ``f``, its closure and the
  context's storage without pickling; results, messages and the storage
  written back cross the process boundary and must pickle;
- per-rank ``multiprocessing.Queue`` inboxes plus a rank-local stash give
  the tagged matching with out-of-order buffering; messages sent but not
  received in a run come back with the results and are parked in the
  parent, per rank, for the next run on the same context (a pipe is
  bounded, so parking them in a queue would wedge the sender);
- a shared ``multiprocessing.Event`` carries a rank's failure to its peers'
  receives;
- each child sends its rank's storage dict back with its result and the
  parent merges it into the context, also when a peer failed.

Host-side work only.  A forked child cannot use a CUDA context that its
parent has created, so a rank must not touch CUDA tensors or launch on the
card; where the parent has initialised CUDA, a DArray or tensor argument
on a CUDA device raises ``RuntimeError`` before the fork.  Requires the
``fork`` start method (POSIX).  Left out with the telemetry and resilience
cores: the JAX module's span records, counters and fault decisions.
"""

from __future__ import annotations

import os
import time
import traceback
from typing import Any, Callable

import torch

__all__ = ["run_spmd_process"]


class _QueueMailbox:
    """A child's view of one rank's inbox: the shared queue and the
    rank-local stash (JAX ``spmd_process.py:47``)."""

    def __init__(self, queue, stash: list):
        self._q = queue
        self._stash = stash

    def put(self, msg: tuple):
        self._q.put(msg)

    def take(self, match: Callable[[tuple], bool], failed, timeout: float,
             tag=None):
        import queue as queue_mod
        from .spmd_mode import _PEER_ABORT, _receive_timeout, _scan_stash
        deadline = time.monotonic() + timeout
        while True:
            m = _scan_stash(self._stash, match)
            if m is not None:
                return m
            if failed.is_set():
                raise RuntimeError(_PEER_ABORT)
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise _receive_timeout(timeout, self._stash, tag)
            try:
                self._stash.append(self._q.get(timeout=min(remaining, 0.1)))
            except queue_mod.Empty:
                pass


class _RunContext:
    """A child's stand-in for ``SPMDContext``: the attributes that sendto,
    recvfrom and the collectives touch (JAX ``spmd_process.py:78``)."""

    def __init__(self, ctx_id, pids, queues, store, failed, stash):
        self.id = ctx_id
        self.pids = list(pids)
        self.store = store
        self._queues = queues
        self._stash: list[tuple] = stash
        self._barrier_gen = {p: 0 for p in self.pids}
        self._failed = failed

    def mailbox(self, pid: int) -> _QueueMailbox:
        try:
            return _QueueMailbox(self._queues[pid], self._stash)
        except KeyError:
            raise ValueError(f"rank {pid} is not in context {self.id} "
                             f"(pids={self.pids})") from None


def _on_card(x, depth: int = 0) -> bool:
    """Whether ``x`` is, or holds, a DArray or tensor on a CUDA device."""
    from ..darray import DArray
    if isinstance(x, torch.Tensor):
        return x.device.type == "cuda"
    if isinstance(x, DArray):
        return any(x.part(ci).device.type == "cuda" for ci in x.cells())
    if depth < 4 and isinstance(x, (list, tuple)):
        return any(_on_card(v, depth + 1) for v in x)
    if depth < 4 and isinstance(x, dict):
        return any(_on_card(v, depth + 1) for v in x.values())
    return False


def run_spmd_process(f: Callable, args: tuple, ctx, timeout: float):
    """One ``spmd()`` run on the process backend (JAX
    ``spmd_process.py:100``): ``ctx``'s pids and a snapshot of its storage
    go to the children, each rank's storage is merged back, and the
    result is ``{rank: result}``, or the root-cause failure raised as
    ``RuntimeError`` with the child's traceback."""
    import multiprocessing as mp

    if torch.cuda.is_initialized() and any(_on_card(a) for a in args):
        raise RuntimeError(
            "spmd(backend='process') cannot take CUDA data: this process "
            "has initialised CUDA, and a forked rank cannot use that CUDA "
            "context; use backend='thread' for work on the card")
    try:
        mpctx = mp.get_context("fork")
    except ValueError:  # pragma: no cover - non-POSIX
        raise RuntimeError(
            "backend='process' needs the fork start method (POSIX only); "
            "use the default thread backend") from None

    if ctx._proc_state is None:
        ctx._proc_state = {"leftover": {p: [] for p in ctx.pids}}
    leftover = ctx._proc_state["leftover"]
    queues = {p: mpctx.Queue() for p in ctx.pids}
    result_q = mpctx.Queue()
    failed = mpctx.Event()

    from .. import core
    from . import spmd_mode

    def child(rank: int):
        rctx = _RunContext(ctx.id, ctx.pids, queues, ctx.store, failed,
                           list(leftover[rank]))
        core._rank_tls.rank = rank
        spmd_mode._tls.ctxt = rctx
        import signal

        def _on_sigterm(signum, frame):
            raise RuntimeError(
                f"SPMD worker rank {rank} received SIGTERM: draining and "
                "reporting before exit")

        try:
            signal.signal(signal.SIGTERM, _on_sigterm)
        except (ValueError, OSError):  # pragma: no cover
            pass
        try:
            try:
                r = f(*args)
                status = (rank, "ok", r, rctx.store.get(rank, {}))
            except BaseException as e:  # noqa: BLE001 - sent to the parent
                failed.set()
                secondary = (isinstance(e, RuntimeError)
                             and str(e) == spmd_mode._PEER_ABORT)
                status = (rank, "err", (secondary,
                          f"{type(e).__name__}: {e}\n"
                          f"{''.join(traceback.format_exception(e))}"),
                          None)
            # unconsumed messages ride home with the result
            import queue as queue_mod
            try:
                while True:
                    rctx._stash.append(queues[rank].get_nowait())
            except queue_mod.Empty:
                pass
            result_q.put(status + (rctx._stash,))
        finally:
            # flush every queue this child wrote before the hard exit
            for q in list(queues.values()) + [result_q]:
                q.close()
                q.join_thread()
            os._exit(0)

    procs = [mpctx.Process(target=child, args=(p,), name=f"spmd-{p}",
                           daemon=True) for p in ctx.pids]
    import warnings
    with warnings.catch_warnings():
        # forking a multithreaded process: the ranks do host work only
        warnings.filterwarnings(
            "ignore", message=".*fork.*", category=DeprecationWarning)
        warnings.filterwarnings(
            "ignore", message=".*fork.*", category=RuntimeWarning)
        for p in procs:
            p.start()

    import signal
    import threading as _threading
    _prev_sigterm = None
    _sigterm_installed = False

    def _forward_sigterm(signum, frame):
        for pr in procs:
            if pr.is_alive() and pr.pid:
                try:
                    os.kill(pr.pid, signal.SIGTERM)
                except ProcessLookupError:  # pragma: no cover
                    pass
        if callable(_prev_sigterm):
            _prev_sigterm(signum, frame)

    if _threading.current_thread() is _threading.main_thread():
        try:
            _prev_sigterm = signal.signal(signal.SIGTERM, _forward_sigterm)
            _sigterm_installed = True
        except (ValueError, OSError):  # pragma: no cover
            pass

    import queue as queue_mod
    results: dict[int, Any] = {}
    stores: dict[int, dict] = {}
    errors: dict[int, tuple] = {}

    def drain(ranks, bound_s: float = 5.0):
        # late sends from exited ranks' inboxes into the parked leftovers,
        # in a helper thread: a partial frame can block the read
        ranks = [p for p in ranks if not queues[p].empty()]
        if not ranks:
            return

        def _pull():
            for p in ranks:
                try:
                    while True:
                        leftover[p].append(queues[p].get_nowait())
                except queue_mod.Empty:
                    pass

        t = _threading.Thread(target=_pull, daemon=True)
        t.start()
        t.join(bound_s)

    deadline = time.monotonic() + timeout
    try:
        while len(results) + len(errors) < len(ctx.pids):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                failed.set()
                raise TimeoutError(
                    f"spmd process run did not finish in {timeout}s "
                    f"(completed ranks: {sorted(results)})")
            try:
                rank, status, payload, store, stash = result_q.get(
                    timeout=min(remaining, 0.2))
            except queue_mod.Empty:
                drain(set(results) | set(errors))
                dead = [p for p, pr in zip(ctx.pids, procs)
                        if not pr.is_alive() and p not in results
                        and p not in errors]
                if dead and result_q.empty():
                    failed.set()
                    raise RuntimeError(
                        f"spmd process rank(s) {dead} died without "
                        "reporting (non-picklable result/storage, or the "
                        "child crashed)")
                continue
            leftover[rank] = list(stash)
            if status == "ok":
                results[rank] = payload
                stores[rank] = store
            else:
                errors[rank] = payload
    finally:
        if _sigterm_installed:
            try:
                signal.signal(signal.SIGTERM,
                              _prev_sigterm if _prev_sigterm is not None
                              else signal.SIG_DFL)
            except (ValueError, OSError, TypeError):  # pragma: no cover
                pass
        drain(ctx.pids)
        for pr in procs:
            pr.join(5)
        drain(ctx.pids)
        for pr in procs:
            if pr.is_alive():  # pragma: no cover - a stuck child
                pr.terminate()
        for q in list(queues.values()) + [result_q]:
            q.close()
            q.cancel_join_thread()
        for rank, st in stores.items():
            ctx.store[rank] = st

    if errors:
        primary = [(r, t) for r, (sec, t) in sorted(errors.items())
                   if not sec]
        rank, err = (primary if primary
                     else [(r, t) for r, (_, t) in sorted(errors.items())])[0]
        raise RuntimeError(
            f"spmd task on rank {rank} failed ({len(errors)} total "
            f"failures); child traceback:\n{err}")
    return results
