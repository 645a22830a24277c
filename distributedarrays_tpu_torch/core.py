"""Object lifecycle: ids, the live-array registry, close, and the scalar guard.

PyTorch counterpart of ``distributedarrays_tpu/core.py``.  The controller
owns every rank's tensor, so lifecycle is Python refcounting plus an eager
``close`` that drops the tensors (and with them the device memory held by
PyTorch's caching allocator).  The registry is this package's own: the
JAX package keeps a separate one, and the two never mix.
"""

from __future__ import annotations

import threading
import weakref

from . import telemetry as _tm
from .telemetry import flight as _flight

__all__ = ["next_did", "d_closeall", "close", "registry", "live_ids",
           "live_arrays", "procs", "current_rank", "allowscalar"]

_id_next = 1
_id_lock = threading.Lock()

# id -> weakref.ref(DArray)
_registry: dict[tuple[int, int], "weakref.ref"] = {}
_registry_lock = threading.RLock()


def next_did() -> tuple[int, int]:
    """Fresh DArray id ``(controller_pid, seq)``; the controller is pid 0."""
    global _id_next
    with _id_lock:
        _id_next += 1
        return (0, _id_next - 1)


def did_mark() -> int:
    """The ``seq`` the next id takes."""
    with _id_lock:
        return _id_next


def did_advance(seq: int) -> None:
    """Let the next id's ``seq`` be at least ``seq``: the processes of a
    job that made different numbers of arrays (one failed a restore the
    others finished) meet on ``max`` of their marks, so the arrays they
    make next share their ids again."""
    global _id_next
    with _id_lock:
        _id_next = max(_id_next, int(seq))


def register(d) -> None:
    with _registry_lock:
        _registry[d.id] = weakref.ref(d)


def unregister(did) -> None:
    with _registry_lock:
        _registry.pop(did, None)


def registry() -> dict:
    """Snapshot of the live registry (for tests and leak checks)."""
    with _registry_lock:
        return {k: v for k, v in _registry.items() if v() is not None}


def live_ids() -> list[tuple[int, int]]:
    return sorted(registry().keys())


def live_arrays() -> list:
    """Strong references to every live registered DArray and ``DData``, in
    id order (JAX ``core.py:80``)."""
    snap = registry()
    return [d for d in (snap[k]() for k in sorted(snap)) if d is not None]


# the calling SPMD task's rank: 0 on the controller, set per task by
# parallel.spmd_mode.spmd (and in each forked rank by spmd_process)
_rank_tls = threading.local()


def current_rank() -> int:
    """The calling rank (JAX ``core.py:38``, the reference's ``myid()``):
    the task's rank inside ``spmd(f, ...)``, 0 on the controller."""
    return getattr(_rank_tls, "rank", 0)


def _registry_census() -> dict:
    """The live registry for flight-recorder bundles: how many arrays were
    open at crash time, and which (JAX ``core.py:132``)."""
    snap = registry()
    items = []
    for did in sorted(snap):
        d = snap[did]()
        if d is None:
            continue
        items.append({"id": list(did), "type": type(d).__name__,
                      "dims": [int(x) for x in getattr(d, "dims", ()) or ()],
                      "closed": bool(getattr(d, "_closed", False))})
    return {"live": len(items), "arrays": items[:200]}


# telemetry imports nothing of the package: the census is handed to it
_flight.register_census_provider(_registry_census)


def procs(d):
    """``d``'s rank grid (JAX ``core.py:127``)."""
    return d.pids


def close(d) -> None:
    """Release ``d``'s rank tensors now."""
    d._close()


def d_closeall() -> None:
    """Close every live DArray.  The registry is cleared first; every array
    is closed even if one close raises, and the first error is re-raised;
    the sweep is journaled as one ``lifecycle``/``closeall`` event with the
    closed count and the bytes the memory ledger saw drain (JAX
    ``core.py:95``)."""
    with _registry_lock:
        refs = list(_registry.values())
        _registry.clear()
    live0 = _tm.memory.live_bytes() if _tm.enabled() else 0
    first: BaseException | None = None
    closed = failed = 0
    for r in refs:
        d = r()
        if d is None:
            continue
        try:
            d._close(_unregister=False)
            closed += 1
        except BaseException as e:  # noqa: BLE001 — re-raised below
            failed += 1
            if first is None:
                first = e
    if _tm.enabled():
        _tm.event("lifecycle", "closeall", closed=closed, errors=failed,
                  freed_bytes=max(live0 - _tm.memory.live_bytes(), 0))
    if first is not None:
        raise first


# ---------------------------------------------------------------------------
# Scalar-indexing guard
# ---------------------------------------------------------------------------

_allowscalar = threading.local()


def allowscalar(flag: bool | None = None):
    """Get, or set as a context manager, whether scalar indexing of a
    DArray is allowed (each scalar read copies one element to the host)::

        with allowscalar(True):
            x = d[3, 4]
    """
    if flag is None:
        return getattr(_allowscalar, "flag", False)
    return _AllowScalar(flag)


class _AllowScalar:
    def __init__(self, flag: bool):
        self._prev = getattr(_allowscalar, "flag", False)
        _allowscalar.flag = bool(flag)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        _allowscalar.flag = self._prev
        return False

    def __bool__(self):
        return getattr(_allowscalar, "flag", False)


def _scalar_indexing_allowed():
    if not getattr(_allowscalar, "flag", False):
        raise RuntimeError(
            "scalar indexing of a DArray is disabled; it copies one element "
            "per call from the device. Use allowscalar(True) (context "
            "manager) to permit it explicitly.")
