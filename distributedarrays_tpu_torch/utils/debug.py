"""Invariant checking and the warnings for the documented host degradations.

PyTorch counterpart of ``distributedarrays_tpu/utils/debug.py`` (and the
``_fn_site`` of its ``ops/mapreduce.py``):

- ``warn_once(key, msg)``: JAX's telemetry; every call counts
  ``fallback.hits{key}`` and the first of each key is journaled as a
  ``fallback`` event.
- ``validate(d)``: the port's DArray layout contract, raising
  ``AssertionError`` with a precise message: the array is open and
  registered; each cut vector starts at 0, ends at its dim, is monotone
  and has one entry more than its grid dim; ``indices`` and every rank's
  ``localindices`` agree with the cuts; every pid is a rank of the table,
  and no rank holds two cells; each rank tensor has its cell's shape, the
  array's dtype and its rank's device (``meta`` for a rank of another
  controller process).
- ``check_all()``: ``validate`` over every live DArray of the registry.
"""

from __future__ import annotations

import os
import threading
import warnings

import numpy as np

from .. import core
from .. import layout as L
from .. import telemetry

__all__ = ["warn_once", "fn_site", "validate", "check_all"]

_warned: set = set()
_warned_lock = threading.Lock()


def warn_once(key: str, msg: str, stacklevel: int = 3) -> None:
    """Emit ``msg`` as a RuntimeWarning the first time ``key`` is seen in
    this process: an op that takes its documented host path says so once
    instead of silently costing time.  Every call counts
    ``fallback.hits`` under its key; the first is journaled."""
    telemetry.count("fallback.hits", key=key)
    with _warned_lock:
        if key in _warned:
            return
        _warned.add(key)
    telemetry.event("fallback", key, message=msg)
    warnings.warn(msg, RuntimeWarning, stacklevel=stacklevel)


def fn_site(fn) -> str:
    """A callable's name and definition site, so two lambdas never share
    one ``warn_once`` key."""
    name = getattr(fn, "__name__", None) or repr(fn)
    code = getattr(fn, "__code__", None)
    if code is not None:
        return (f"{name}@{os.path.basename(code.co_filename)}:"
                f"{code.co_firstlineno}")
    return name


def _check(cond: bool, msg: str) -> None:
    # an explicit raise, not ``assert``: the checker still works under
    # ``python -O``
    if not cond:
        raise AssertionError(msg)


def validate(d) -> None:
    """Raise ``AssertionError`` naming the first broken layout invariant of
    the DArray ``d`` (the module docstring lists them)."""
    _check(not d._closed, f"{d.id}: closed DArray")
    _check(d.id in core.registry(), f"{d.id}: missing from registry")
    nd = len(d.dims)
    grid = tuple(d.pids.shape)
    _check(len(d.cuts) == nd, f"{d.id}: {len(d.cuts)} cut vectors, {nd} dims")
    for dim, c in enumerate(d.cuts):
        _check(c[0] == 0 and c[-1] == d.dims[dim],
               f"{d.id}: cuts[{dim}]={c} do not span [0, {d.dims[dim]}]")
        _check(all(a <= b for a, b in zip(c, c[1:])),
               f"{d.id}: cuts[{dim}]={c} not monotone")
        _check(len(c) == grid[dim] + 1,
               f"{d.id}: cuts[{dim}] has {len(c)} entries for "
               f"{grid[dim]} chunks")
    _check(d.indices.shape == grid,
           f"{d.id}: indices grid {d.indices.shape} != pid grid {grid}")
    _check(d._parts.shape == grid,
           f"{d.id}: tensor grid {d._parts.shape} != pid grid {grid}")
    navail = L.nranks()
    pids = [int(p) for p in d.pids.flat]
    for p in pids:
        _check(0 <= p < navail, f"{d.id}: rank {p} out of range")
    _check(len(set(pids)) == len(pids),
           f"{d.id}: a rank holds two cells ({sorted(pids)})")
    for ci in np.ndindex(*grid):
        idx = d.indices[ci]
        want = [range(d.cuts[dim][ci[dim]], d.cuts[dim][ci[dim] + 1])
                for dim in range(nd)]
        for dim in range(nd):
            _check(idx[dim] == want[dim],
                   f"{d.id}: indices[{ci}][{dim}]={idx[dim]} != "
                   f"cuts-derived {want[dim]}")
        rank = int(d.pids[ci])
        _check(tuple(d.localindices(rank)) == tuple(want),
               f"{d.id}: localindices({rank})={d.localindices(rank)} != "
               f"cell {ci}'s {tuple(want)}")
        t = d._parts[ci]
        shape = tuple(len(r) for r in want)
        _check(tuple(t.shape) == shape,
               f"{d.id}: rank {rank}'s tensor is {tuple(t.shape)}, its cell "
               f"{ci} is {shape}")
        _check(t.dtype == d.dtype,
               f"{d.id}: rank {rank}'s tensor is {t.dtype}, the array "
               f"{d.dtype}")
        dev = L.device_of(rank)
        _check(t.device == dev,
               f"{d.id}: rank {rank}'s tensor is on {t.device}, the rank on "
               f"{dev}")


def check_all() -> int:
    """Validate every live DArray; returns how many were checked."""
    from ..darray import DArray
    n = 0
    for d in core.live_arrays():
        if isinstance(d, DArray) and not d._closed:
            validate(d)
            n += 1
    return n
