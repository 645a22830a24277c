"""Map/reduce over DArrays: a local reduce per rank, then a combine.

PyTorch counterpart of ``dreduce``/``dmapreduce``/``dsum``/``dprod``/
``dmaximum``/``dminimum``/``dmean``/``dvar``/``dstd`` in
``distributedarrays_tpu/ops/mapreduce.py``.  The reference reduces each
worker's chunk and then the partials; XLA emits the same two phases for a
reduction over a sharded array.  Here each rank reduces its chunk on its
device, and the partials are combined in grid (row-major) order on the
device of the first rank of each result cell.  Means and variances carry
``(count, mean, M2)`` partials combined by Chan's formula.

In a job of several controller processes (``parallel.multihost``) each
process computes the partials of its own cells, the partials travel over
the job's process group, and every process folds all of them in the same
grid order as one process would: the result is bit for bit the
single-process port's on the same layout, and every process holds it (a
0-d tensor on its own device, or a DArray whose local chunks it holds).
The scans exchange each chunk's last slab the same way and fold the
carries in cell order; ``samedist``, ``mapslices`` and ``ppeval`` move
their data through the cross-process reshard, and ``f`` runs on each
process's own cells (on another process's placeholders it only infers
the shapes).

``dims=`` reductions keep the reduced dims with size 1, and the result
keeps the source's pid grid with the reduced grid dims collapsed, as in the
JAX package.  Whole-array reductions return a 0-d tensor.  dtypes follow
JAX with 64-bit types off: a sum or product of bool or signed integers is
int32, of unsigned integers uint32 (partials in int64, wrapped once at the
end); a float16 or bfloat16 sum or product keeps its type but carries
float32 partials, merged in float32 and rounded once, as JAX upcasts
them; an integer mean/variance is float32, the mean of an integer or bool
array from exact int64 sums and counts divided once at the end, so it is
correctly rounded as JAX's is (float means carry Chan's ``(count, mean)``
partials).

Also here, as in the JAX module: ``dall``/``dany``/``dcount``/
``dextrema``; the scans ``dcumsum``/``dcumprod``/``dcummax``/``dcummin``
(each rank scans its own chunk and takes the running total of the chunks
before it along the scan dim: JAX's ``_scan_shm_jit``);
``map_localparts`` (``f`` on each rank's chunk, on its device);
``samedist`` (a relayout, so a one-axis repartition of equal width runs
the all-to-all kernel); ``mapslices`` (the data first moved so the slice
dims are whole on each rank, as the reference does, then
``torch.func.vmap`` over each rank's slices); and ``ppeval`` (each rank
maps ``f`` over its run of the slice dim with ``torch.func.vmap``).  The
scans keep the dtype, as ``jnp.cumsum`` does (int8, uint8 and int32 wrap),
except that a bool sum or product is int32.
"""

from __future__ import annotations

import functools
import inspect
from typing import Callable

import numpy as np
import torch

from ..darray import (DArray, SubDArray, _assemble, as_tensor, copyto_,
                      from_global, resolve_layout)
from .. import layout as L
from .. import telemetry as _tm
from ..darray import _scatter
from ..layout import all_ranks, defaultdist, defaultdist_1d, device_of
from ..parallel.reshard import relayout, relayout_parts
from .broadcast import _WIDE, _arg_shape, call_user

__all__ = [
    "dreduce", "dmapreduce", "dsum", "dprod", "dmaximum", "dminimum",
    "dmean", "dstd", "dvar", "dall", "dany", "dcount", "dextrema",
    "dcumsum", "dcumprod", "dcummax", "dcummin",
    "map_localparts", "map_localparts_into", "samedist", "mapslices",
    "ppeval",
]


def _is_exact(dtype) -> bool:
    return dtype == torch.bool or not (dtype.is_floating_point
                                       or dtype.is_complex)


_HALF = (torch.float16, torch.bfloat16)
_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32, torch.uint64)


def sum_dtype(dtype) -> torch.dtype:
    """The dtype of a sum or product of ``dtype`` (``jnp.sum``'s rule with
    64-bit types off): int32 for bool and signed integers, uint32 for
    unsigned ones; floats keep theirs."""
    if not _is_exact(dtype):
        return dtype
    return torch.uint32 if dtype in _UNSIGNED else torch.int32


def acc_dtype(dtype) -> torch.dtype:
    """The dtype partial sums and products of ``dtype`` are carried in:
    int64 for exact types, float32 for float16 and bfloat16."""
    if _is_exact(dtype):
        return torch.int64
    return torch.float32 if dtype in _HALF else dtype


def _reduce_dims(x: torch.Tensor, fn, axes) -> torch.Tensor:
    """``fn(x, dim=a, keepdim=True)`` over each of ``axes``."""
    for a in sorted(axes, reverse=True):
        x = fn(x, dim=a, keepdim=True)
    return x


def _lex_pick(a: torch.Tensor, b: torch.Tensor, largest: bool):
    """The larger (``largest``) or smaller of complex ``a`` and ``b``,
    element by element, in JAX's lexicographic order: the real parts
    first, then the imaginary parts."""
    if not largest:
        a, b = -a, -b
    take = (b.real > a.real) | ((b.real == a.real) & (b.imag > a.imag))
    r = torch.where(take, b, a)
    return r if largest else -r


def _lex_extreme(x: torch.Tensor, axes, largest: bool) -> torch.Tensor:
    """``amax``/``amin`` of complex ``x`` over ``axes`` (kept, size 1) in
    the lexicographic order: the extreme real part, then the extreme
    imaginary part among the elements that tie on it."""
    keep = [i for i in range(x.ndim) if i not in axes]
    y = x.permute(keep + list(axes)).reshape(
        [x.shape[i] for i in keep] + [-1])
    f = torch.amax if largest else torch.amin
    re = f(y.real, dim=-1, keepdim=True)
    fill = float("-inf") if largest else float("inf")
    im = f(torch.where(y.real == re, y.imag, fill), dim=-1)
    out = torch.complex(re.squeeze(-1), im)
    for a in sorted(axes):
        out = out.unsqueeze(a)
    return out


class _Reducer:
    """Local partial, pairwise merge and finish for one named reduction."""

    def __init__(self, name: str, ddof: int = 1):
        self.name = name
        self.ddof = ddof

    def local(self, x: torch.Tensor, axes):
        name = self.name
        n = int(np.prod([x.shape[a] for a in axes]))
        if name in ("sum", "prod"):
            return _reduce_dims(x.to(acc_dtype(x.dtype)),
                                torch.sum if name == "sum" else torch.prod,
                                axes)
        if name in ("max", "min"):
            if x.is_complex():
                return _lex_extreme(x, axes, name == "max")
            x = x.to(_WIDE.get(x.dtype, x.dtype))
            return _reduce_dims(x, torch.amax if name == "max"
                                else torch.amin, axes)
        if name in ("all", "any"):
            x = x.to(torch.bool)
            return _reduce_dims(x, torch.all if name == "all" else torch.any,
                                axes)
        if name == "mean" and _is_exact(x.dtype):
            # exact partials: an int64 sum, divided once in finish
            return (n, _reduce_dims(x.to(torch.int64), torch.sum, axes))
        x = x.to(torch.float32) if (_is_exact(x.dtype)
                                    or x.element_size() < 4) else x
        mean = _reduce_dims(x, torch.mean, axes)
        if name == "mean":
            return (n, mean)
        m2 = _reduce_dims((x - mean).abs() ** 2, torch.sum, axes)
        return (n, mean, m2)

    def merge(self, a, b):
        name = self.name
        if name == "sum":
            return a + b
        if name == "prod":
            return a * b
        if name in ("max", "min"):
            if a.is_complex():
                return _lex_pick(a, b, name == "max")
            return (torch.maximum if name == "max" else torch.minimum)(a, b)
        if name == "all":
            return a & b
        if name == "any":
            return a | b
        na, nb = a[0], b[0]
        n = na + nb
        if name == "mean" and not b[1].is_floating_point() and \
                not b[1].is_complex():
            return (n, a[1] + b[1])               # exact sums
        delta = b[1] - a[1]
        mean = a[1] + delta * (nb / n)
        if name == "mean":
            return (n, mean)
        return (n, mean,
                a[2] + b[2] + delta.abs() ** 2 * (na * nb / n))

    def finish(self, s, dtype):
        name = self.name
        if name in ("sum", "prod"):
            return s.to(sum_dtype(dtype))
        if name in ("max", "min"):
            return s.to(dtype)       # uint16/uint32 back from their wide type
        if name in ("all", "any"):
            return s
        out_dtype = torch.float32 if _is_exact(dtype) else dtype
        if name == "mean":
            if _is_exact(dtype):
                # one division of the exact sum, rounded once to float32
                # (float64 first: exact for sums below 2**53, and one
                # rounding for counts below 2**28)
                return (s[1].to(torch.float64) / s[0]).to(out_dtype)
            return s[1].to(out_dtype)
        # the variance of complex values is real: the mean of |x - mean|^2
        var = s[2] / (s[0] - self.ddof)
        return (var if name == "var" else torch.sqrt(var)).to(
            out_dtype.to_real())

    def to(self, s, dev):
        if isinstance(s, tuple):
            return (s[0],) + tuple(t.to(dev) for t in s[1:])
        return s.to(dev)


def _norm_dims(dims, ndim):
    if dims is None:
        return None
    if isinstance(dims, (int, np.integer)):
        dims = (int(dims),)
    return tuple(sorted(int(a) % ndim for a in dims))


def _fit_dist(shape, dist):
    return [min(c, s) if s > 0 else 1 for c, s in zip(dist, shape)]


def _as_darray(d):
    if isinstance(d, DArray):
        return d, False
    if isinstance(d, SubDArray):
        return from_global(d.materialize(), procs=[int(
            d.parent.pids.flat[0])], dist=[1] * d.ndim), True
    t = as_tensor(d)
    return from_global(t, procs=[0], dist=[1] * t.ndim), True


def _two_phase(d: DArray, axes, local: Callable, merge: Callable,
               finish: Callable, move: Callable):
    """Local partials per cell, merged in grid order along the reduced
    grid axes, finished on the first cell's device of each result cell.
    Returns a 0-d tensor (``axes`` None) or the result DArray."""
    ndim = d.ndim
    red = tuple(range(ndim)) if axes is None else axes
    groups: dict[tuple, list] = {}
    for ci in d.cells():
        key = tuple(0 if k in red else j for k, j in enumerate(ci))
        groups.setdefault(key, []).append(ci)
    if L.process_count() > 1:
        return _two_phase_processes(d, axes, red, groups, local, merge,
                                    finish, move)
    blocks = {}
    for key, cells in groups.items():
        dev = device_of(int(d.pids[key]))
        state = None
        for ci in _live_cells(d, red, cells):
            s = move(local(d.part(ci), red), dev)
            state = s if state is None else merge(state, s)
        blocks[key] = finish(state)
    if axes is None:
        return blocks[(0,) * ndim].reshape(())
    grid = tuple(1 if k in red else g for k, g in enumerate(d.grid))
    parts = np.empty(grid, dtype=object)
    for key, b in blocks.items():
        parts[key] = b
    pids = np.asarray([d.pids[key] for key in np.ndindex(*grid)],
                      dtype=np.int64).reshape(grid)
    cuts = [[0, 1] if k in red else list(c) for k, c in enumerate(d.cuts)]
    tmp = DArray(parts, pids, cuts)
    shape = tuple(tmp.dims)
    dist = _fit_dist(shape, [1 if k in red else c
                             for k, c in enumerate(d.grid)])
    _, tpids, tcuts = resolve_layout(shape, [int(p) for p in d.pids.flat],
                                     dist)
    res = relayout(tmp, tpids, tcuts)
    tmp.close()
    return res


def _live_cells(d: DArray, red, cells) -> list:
    """The cells of a group that hold elements along every reduced axis: a
    cell empty along one contributes nothing, unless all are (then the
    first one's reduction of an empty extent decides the result)."""
    live = [ci for ci in cells
            if all(d.cuts[a][ci[a] + 1] > d.cuts[a][ci[a]] for a in red)]
    return live or cells[:1]


def _two_phase_processes(d: DArray, axes, red, groups, local, merge,
                         finish, move):
    """``_two_phase`` across controller processes: each process computes
    its own cells' partials, the partials are all-gathered over the job's
    process group as CPU tensors, and every process folds every group in
    grid order on its own device.  A ``dims`` result is placed on the
    layout ``relayout`` would give, each process keeping its own
    chunks."""
    from ..parallel import multihost
    cpu = torch.device("cpu")
    mine = {}
    for cells in groups.values():
        for ci in _live_cells(d, red, cells):
            if L.is_local(int(d.pids[ci])):
                mine[ci] = move(local(d._parts[ci], red), cpu)
    if not mine:
        # no chunk here: one placeholder (on the meta device) fixes the
        # result's type, which ``finish`` reads from ``local``
        cells = next(iter(groups.values()))
        local(d._parts[_live_cells(d, red, cells)[0]], red)
    every = {}
    for part in multihost._all_gather_objects(mine):
        every.update(part)
    dev = L.local_device()
    blocks = {}
    for key, cells in groups.items():
        state = None
        for ci in _live_cells(d, red, cells):
            s = move(every[ci], dev)
            state = s if state is None else merge(state, s)
        blocks[key] = finish(state)
    ndim = d.ndim
    if axes is None:
        return blocks[(0,) * ndim].reshape(())
    grid = tuple(1 if k in red else g for k, g in enumerate(d.grid))
    cuts = [[0, 1] if k in red else list(c) for k, c in enumerate(d.cuts)]
    first = blocks[(0,) * ndim]
    whole = torch.empty([c[-1] for c in cuts], dtype=first.dtype, device=dev)
    for key, b in blocks.items():
        whole[tuple(slice(c[j], c[j + 1]) for c, j in zip(cuts, key))] = b
    dist = _fit_dist(tuple(whole.shape), list(grid))
    _, tpids, tcuts = resolve_layout(tuple(whole.shape),
                                     [int(p) for p in d.pids.flat], dist)
    return DArray(_scatter(whole, tpids, tcuts), tpids, tcuts)


def _reduce(d, mapper, reducer: _Reducer, dims):
    d, tmp = _as_darray(d)
    try:
        axes = _norm_dims(dims, d.ndim)
        dtype = None

        def local(x, red):
            nonlocal dtype
            x = call_user(mapper, x) if mapper is not None else x
            dtype = x.dtype
            return reducer.local(x, red)
        return _two_phase(d, axes, local, reducer.merge,
                          lambda s: reducer.finish(s, dtype), reducer.to)
    finally:
        if tmp:
            d.close()


_NAMES = ("sum", "prod", "max", "min", "all", "any", "mean", "std", "var")
_FN_NAMES = {torch.sum: "sum", torch.prod: "prod", torch.amax: "max",
             torch.max: "max", torch.amin: "min", torch.min: "min",
             torch.all: "all", torch.any: "any", torch.mean: "mean",
             torch.std: "std", torch.var: "var"}


def _is_binary_op(fn) -> bool:
    """True for a plain binary operator ``op(a, b)``."""
    if isinstance(fn, np.ufunc):
        return fn.nin == 2
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    params = list(sig.parameters.values())
    if any(p.name in ("axis", "dim", "dims") for p in params):
        return False
    required = [p for p in params
                if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
                and p.default is p.empty]
    return len(required) == 2


def _tree_fold(op, v: torch.Tensor) -> torch.Tensor:
    """Order-preserving pairwise fold of ``op`` over dim 0 (adjacent
    elements combine, so an associative non-commutative op matches a left
    fold), as the JAX package folds."""
    while v.shape[0] > 1:
        k = v.shape[0] // 2
        head = op(v[0:2 * k:2], v[1:2 * k:2])
        v = head if v.shape[0] % 2 == 0 else torch.cat([head, v[2 * k:]])
    return v[0]


def _binary_reduce(d, mapper, op, dims):
    d, tmp = _as_darray(d)
    try:
        axes = _norm_dims(dims, d.ndim)
        red = tuple(range(d.ndim)) if axes is None else axes
        if int(np.prod([d.dims[a] for a in red])) == 0:
            raise ValueError("reduce of empty DArray with no init value")

        def fold(x, red):
            x = mapper(x) if mapper is not None else x
            keep = tuple(i for i in range(x.ndim) if i not in red)
            v = x.permute(red + keep).reshape(
                (-1,) + tuple(x.shape[i] for i in keep))
            r = _tree_fold(op, v)
            for a in red:
                r = r.unsqueeze(a)
            return r
        # the map, the local fold and the merge of partials run ``op`` as
        # JAX's does (``call_user``)
        return _two_phase(d, axes, lambda x, red: call_user(fold, x, red),
                          lambda a, b: call_user(op, a, b), lambda s: s,
                          lambda s, dev: s.to(dev))
    finally:
        if tmp:
            d.close()


def dmapreduce(f: Callable | None, op_name_or_fn, d, dims=None):
    """``mapreduce(f, op, d)``: ``op`` is a name from {sum, prod, max, min,
    all, any, mean, std, var}, the matching torch reduction
    (``torch.sum``, ``torch.amax``, ...), or a plain two-argument callable
    folded pairwise within each chunk and then across chunks.  The
    ``mapreduce`` span carries ``perf.reduce_cost``, as JAX's."""
    _tm.count("op.mapreduce")
    with _tm.span("mapreduce"):
        if _tm.enabled():
            from ..telemetry import perf as _perf
            # cost stamp: about 1 flop and one read through HBM an element
            # (the map's cost is unknown: this floor classifies the sweep
            # as bound by memory, which a reduction is)
            try:
                n_elems = int(np.prod(d.dims))
                isz = d.dtype.itemsize
            except (AttributeError, TypeError):
                n_elems, isz = _tm.nbytes_of(d), 1
            _tm.annotate(**_perf.reduce_cost(n_elems, isz))
        return _dmapreduce(f, op_name_or_fn, d, dims)


def _dmapreduce(f, op_name_or_fn, d, dims):
    if isinstance(op_name_or_fn, str):
        if op_name_or_fn not in _NAMES:
            raise ValueError(f"unknown reduction {op_name_or_fn!r}")
        return _reduce(d, f, _Reducer(op_name_or_fn), dims)
    name = _FN_NAMES.get(op_name_or_fn)
    if name is not None:
        return _reduce(d, f, _Reducer(name), dims)
    if callable(op_name_or_fn) and _is_binary_op(op_name_or_fn):
        return _binary_reduce(d, f, op_name_or_fn, dims)
    raise TypeError(
        f"unsupported reduction {op_name_or_fn!r}: pass a name, a torch "
        "reduction or a two-argument operator")


def dreduce(op_name_or_fn, d, dims=None):
    return dmapreduce(None, op_name_or_fn, d, dims=dims)


def _named(name):
    def f(d, dims=None):
        return _reduce(d, None, _Reducer(name), dims)
    f.__name__ = "d" + name
    f.__doc__ = f"Distributed {name}; ``dims=`` keeps the reduced dims."
    return f


dsum = _named("sum")
dprod = _named("prod")
dmaximum = _named("max")
dminimum = _named("min")
dmean = _named("mean")
dall = _named("all")
dany = _named("any")


def dvar(d, dims=None, ddof=1):
    """Corrected (ddof=1) variance, Julia's ``Statistics.var`` default."""
    return _reduce(d, None, _Reducer("var", ddof), dims)


def dstd(d, dims=None, ddof=1):
    """Corrected (ddof=1) standard deviation."""
    return _reduce(d, None, _Reducer("std", ddof), dims)


def dcount(pred: Callable, d, dims=None):
    """The number of elements where ``pred`` holds, int32 (JAX
    ``ops/mapreduce.py:283``); ``pred`` runs as ``dmap``'s function does
    (``call_user``)."""
    return _reduce(d, lambda a: pred(a).to(torch.int32), _Reducer("sum"),
                   dims)


def _moved(tmp: DArray, pids, cuts) -> DArray:
    """``tmp``'s values on the layout ``(pids, cuts)``; ``tmp`` is a
    temporary and is closed (its tensors are reused when the layouts
    agree)."""
    try:
        return DArray(relayout_parts(tmp, pids, cuts),
                      np.array(pids, dtype=np.int64), cuts)
    finally:
        tmp.close()


def _on_default(x: DArray) -> DArray:
    _, pids, cuts = resolve_layout(x.dims)
    return _moved(x, pids, cuts)


def dextrema(d, dims=None):
    """``(min, max)`` (JAX ``ops/mapreduce.py:299``): 0-d tensors, or with
    ``dims`` two DArrays on the default layout, as JAX wraps them."""
    lo, hi = dminimum(d, dims), dmaximum(d, dims)
    if dims is None:
        return lo, hi
    return _on_default(lo), _on_default(hi)


# ---------------------------------------------------------------------------
# Scans
# ---------------------------------------------------------------------------


def _lex_scan(x: torch.Tensor, ax: int, largest: bool) -> torch.Tensor:
    """The running maximum (``largest``) or minimum of complex ``x`` along
    ``ax`` in the lexicographic order, as a doubling scan: step s folds
    each element with the one s before it."""
    n, s = x.shape[ax], 1
    while s < n:
        head = x.narrow(ax, 0, s)
        x = torch.cat([head, _lex_pick(x.narrow(ax, s, n - s),
                                       x.narrow(ax, 0, n - s), largest)], ax)
        s *= 2
    return x


def _scan_local(kind: str, x: torch.Tensor, ax: int) -> torch.Tensor:
    dt = x.dtype
    if dt in _WIDE:
        # uint16/uint32: in the wider signed type, wrapped back
        return _scan_local(kind, x.to(_WIDE[dt]), ax).to(dt)
    if x.is_complex() and kind in ("max", "min"):
        return _lex_scan(x, ax, kind == "max")
    if kind in ("sum", "prod"):
        # torch widens integer and bool scans to int64 unless told; JAX
        # keeps the type, and makes bool int32
        dt = torch.int32 if x.dtype == torch.bool else x.dtype
        return (torch.cumsum if kind == "sum" else torch.cumprod)(
            x, ax, dtype=dt)
    op = torch.cummax if kind == "max" else torch.cummin
    if x.dtype == torch.bool:
        # through int8 and back, as JAX does (lax.cummax rejects bool)
        return op(x.to(torch.int8), ax).values.to(torch.bool)
    return op(x, ax).values


_SCAN_MERGE = {"sum": torch.add, "prod": torch.mul, "max": torch.maximum,
               "min": torch.minimum}


def _scan_merge(kind: str) -> Callable:
    """The carry's fold into a scanned chunk: uint16/uint32 in their wider
    signed type (wrapped back), complex extremes in the lexicographic
    order."""
    plain = _SCAN_MERGE[kind]

    def merge(x, prev):
        if x.dtype in _WIDE:
            w = _WIDE[x.dtype]
            return plain(x.to(w), prev.to(w)).to(x.dtype)
        if x.is_complex() and kind in ("max", "min"):
            return _lex_pick(x, prev, kind == "max")
        return plain(x, prev)
    return merge


def _scan(d: DArray, axis: int, kind: str) -> DArray:
    """Inclusive scan along ``axis`` on ``d``'s layout (JAX
    ``ops/mapreduce.py:314``): each rank scans its own chunk, then merges
    in the running total that the chunks before it along ``axis`` hand
    on (their last slice, a slab one element thick).  The carries are
    folded in cell order from each chunk's own last slab, which is the
    last slab of the merged chunk; in a job of several processes each
    process scans its own chunks, the slabs travel over the job's group
    (``multihost.cell_values``) and every process folds the same carries,
    so the result is bit-equal to one process's."""
    from ..parallel import multihost
    if not isinstance(d, DArray):
        raise TypeError(f"expected DArray, got {type(d).__name__}")
    ax = axis + d.ndim if axis < 0 else axis
    if not 0 <= ax < d.ndim:
        raise ValueError(f"axis {axis} out of range for ndim {d.ndim}")
    merge = _scan_merge(kind)
    scanned = {}

    def tail(ci):
        x = scanned[ci] = _scan_local(kind, d.part(ci), ax)
        n = x.shape[ax]
        return x.narrow(ax, n - 1, 1) if n else None
    tails = multihost.cell_values(d, tail)
    parts = np.empty(d.grid, dtype=object)
    carry = {}          # per line of cells along ax: the total so far
    for ci, t in zip(d.cells(), tails):  # row-major: each line in order
        line = ci[:ax] + ci[ax + 1:]
        prev = carry.get(line)
        x = scanned.get(ci)
        if x is None:                    # another process's cell
            x = _scan_local(kind, d._parts[ci], ax)
        elif prev is not None:
            x = merge(x, prev.to(x.device))
        if t is not None:
            t = t.to(x.device if x.device.type != "meta"
                     else L.local_device())
            carry[line] = t if prev is None else merge(t, prev.to(t.device))
        parts[ci] = x
    return DArray(parts, d.pids.copy(), d.cuts)


def dcumsum(d: DArray, axis: int = 0) -> DArray:
    """Cumulative sum along ``axis``, same layout (JAX
    ``ops/mapreduce.py:446``)."""
    return _scan(d, axis, "sum")


def dcumprod(d: DArray, axis: int = 0) -> DArray:
    """Cumulative product along ``axis``, same layout (JAX
    ``ops/mapreduce.py:453``)."""
    return _scan(d, axis, "prod")


def dcummax(d: DArray, axis: int = 0) -> DArray:
    """Running maximum along ``axis``, same layout (JAX
    ``ops/mapreduce.py:459``)."""
    return _scan(d, axis, "max")


def dcummin(d: DArray, axis: int = 0) -> DArray:
    """Running minimum along ``axis``, same layout (JAX
    ``ops/mapreduce.py:465``)."""
    return _scan(d, axis, "min")


# ---------------------------------------------------------------------------
# map_localparts, samedist, mapslices, ppeval
# ---------------------------------------------------------------------------


def _own(r, args, dev) -> torch.Tensor:
    """``f``'s result as a tensor on ``dev`` that shares no memory with an
    argument it was given (so the new DArray owns it)."""
    t = as_tensor(r if isinstance(r, torch.Tensor)
                  else torch.as_tensor(np.asarray(r))).to(dev)
    base = t.untyped_storage().data_ptr()
    if any(isinstance(a, torch.Tensor)
           and a.untyped_storage().data_ptr() == base for a in args):
        t = t.clone()
    return t.contiguous()


def map_localparts(f: Callable, *ds, procs=None) -> DArray:
    """``f`` on each rank's chunk, on its device (JAX
    ``ops/mapreduce.py:471``).  DArray arguments of another layout are
    cut to the first DArray's; other arguments pass as they are.  Chunk
    shapes may change: the result's cuts come from the chunks' sizes, as
    ``from_chunks`` builds them.  ``procs`` is accepted for the JAX
    signature and, as there, unused."""
    d0 = next((a for a in ds if isinstance(a, DArray)), None)
    if d0 is None:
        raise TypeError("map_localparts needs a DArray argument")
    for a in ds:
        if isinstance(a, DArray) and a.dims != d0.dims:
            raise ValueError(f"map_localparts args must share global dims: "
                             f"{a.dims} vs {d0.dims}")
    pieces = [relayout_parts(a, d0.pids, d0.cuts)
              if isinstance(a, DArray) else None for a in ds]
    out = np.empty(d0.grid, dtype=object)
    for ci in d0.cells():
        args = [a if p is None else p[ci] for a, p in zip(ds, pieces)]
        out[ci] = _own(call_user(f, *args), args,
                       device_of(int(d0.pids[ci])))
    return _assemble(out, d0.pids.copy())


def map_localparts_into(f: Callable, dest: DArray, *ds) -> DArray:
    """``map_localparts`` written into ``dest`` in place (JAX
    ``ops/mapreduce.py:525``): ``dest`` keeps its layout and takes the
    result's dtype, as JAX's ``dest._rebind``."""
    res = map_localparts(f, *ds)
    try:
        if res.dtype == dest.dtype:
            return copyto_(dest, res)
        parts = relayout_parts(res, dest.pids, dest.cuts)
    finally:
        res.close()
    dest._rebind(parts)
    return dest


def _even_shared_layout(ds) -> bool:
    """True when the DArrays among ``ds`` share one layout whose chunks are
    all equal and non-empty in every dim (JAX ``ops/mapreduce.py:533``):
    the layouts the compiled FFT and convolution paths take."""
    arrs = [a for a in ds if isinstance(a, DArray)]
    if not arrs:
        return False
    d0 = arrs[0]
    if not all(np.array_equal(a.pids, d0.pids) and a.cuts == d0.cuts
               for a in arrs):
        return False
    for cuts in d0.cuts:
        sizes = set(np.diff(cuts).tolist())
        if len(sizes) > 1 or 0 in sizes:
            return False
    return True


def samedist(d: DArray, like: DArray) -> DArray:
    """``d``'s values on ``like``'s layout (JAX ``ops/mapreduce.py:549``),
    through ``relayout``: the all-to-all kernel for a one-axis
    repartition of equal width, a copy when the layouts already agree
    (JAX shares the buffer there, which only immutable arrays allow)."""
    if d.dims != like.dims:
        raise ValueError(f"dims mismatch: {d.dims} vs {like.dims}")
    return relayout(d, like.pids, like.cuts, op="samedist")


def _slices(f: Callable, x: torch.Tensor, batch: tuple, dims: tuple):
    """``f`` vmapped over every slice of ``x`` spanning ``dims``; the result
    keeps the batch dims in place and ``f``'s output at ``dims``."""
    perm = batch + dims
    xt = x.permute(perm)
    bshape = tuple(xt.shape[:len(batch)])
    sshape = tuple(xt.shape[len(batch):])
    nb = int(np.prod(bshape))
    flat = xt.reshape((nb,) + sshape)
    # an empty chunk still needs f's output shape: map one zero slice
    res = call_user(torch.func.vmap(f),
                    flat if nb else flat.new_zeros((1,) + sshape))
    if res.ndim - 1 != len(dims):
        raise ValueError(
            f"mapslices: f must keep the slice rank ({len(dims)}), got "
            f"result rank {res.ndim - 1}")
    res = res[:nb].reshape(bshape + tuple(res.shape[1:]))
    return res.permute(tuple(int(i) for i in np.argsort(perm)))


def mapslices(f: Callable, d: DArray, dims) -> DArray:
    """``f`` on each slice of ``d`` spanning ``dims`` (JAX
    ``ops/mapreduce.py:607``); ``f`` must keep the slice rank and may
    change its extents.  As the reference (mapreduce.jl:195-203), the data
    first moves so the slice dims are whole on each rank (the batch dims
    split by ``defaultdist`` over ``d``'s ranks; a one-axis repartition
    of equal width runs the all-to-all kernel), then each rank maps ``f``
    over its slices with ``torch.func.vmap``.  The result takes the
    default layout over ``d``'s ranks, as JAX's."""
    if not isinstance(d, DArray):
        raise TypeError(f"expected DArray, got {type(d).__name__}")
    dims = _norm_dims(dims, d.ndim)
    batch = tuple(i for i in range(d.ndim) if i not in dims)
    procs = [int(p) for p in d.pids.flat]
    src = d
    if any(d.grid[i] > 1 for i in dims):
        dist = [1] * d.ndim
        for i, c in zip(batch, defaultdist([d.dims[i] for i in batch],
                                           procs) if batch else []):
            dist[i] = c
        _, pids, cuts = resolve_layout(d.dims, procs, dist)
        src = relayout(d, pids, cuts)
    try:
        out = np.empty(src.grid, dtype=object)
        for ci in src.cells():
            # another process's cell: f on its placeholder gives the shape
            x = src._parts[ci]
            out[ci] = _own(_slices(f, x, batch, dims), [x], x.device)
        tmp = _assemble(out, src.pids.copy())
    finally:
        if src is not d:
            src.close()
    _, pids, cuts = resolve_layout(tmp.dims, procs)
    return _moved(tmp, pids, cuts)


def ppeval(f: Callable, *ds, dim: int | None = None) -> DArray:
    """``f`` on each slice along ``dim`` (default: each argument's last),
    the results stacked along a new last dim (JAX
    ``ops/mapreduce.py:653``).  The slice dim is split over the first
    DArray's ranks (all ranks without one); each DArray argument moves so
    its run of slices is whole on that rank, other arguments are cut on
    the host side, and each rank maps ``f`` over its run with
    ``torch.func.vmap``.  The result takes the default layout, as JAX's."""
    shapes = [_arg_shape(a) for a in ds]
    axes = [(len(s) - 1 if dim is None else dim) % len(s) for s in shapes]
    n = {int(s[ax]) for s, ax in zip(shapes, axes)}
    if len(n) != 1:
        raise ValueError(f"slice-dim extents differ: {sorted(n)} "
                         "(reference mapreduce.jl:300-313)")
    n = n.pop()
    d0 = next((a for a in ds if isinstance(a, DArray)), None)
    procs = [int(p) for p in d0.pids.flat] if d0 is not None else all_ranks()
    p = max(1, min(len(procs), n))
    cuts = defaultdist_1d(n, p)
    pieces = []
    for a, ax in zip(ds, axes):
        if isinstance(a, DArray):
            dist = [p if i == ax else 1 for i in range(a.ndim)]
            _, pids, acuts = resolve_layout(a.dims, procs, dist)
            pieces.append(list(relayout_parts(a, pids, acuts).flat))
        else:
            t = a.materialize() if isinstance(a, SubDArray) else as_tensor(a)
            pieces.append([t.narrow(ax, cuts[k], cuts[k + 1] - cuts[k]).to(
                device_of(procs[k])) for k in range(p)])
    run = torch.func.vmap(f, in_dims=tuple(axes), out_dims=-1)
    out = None
    for k in range(p):
        args = [pc[k] for pc in pieces]
        r = _own(call_user(run, *args), args, device_of(procs[k]))
        if out is None:
            out = np.empty((1,) * (r.ndim - 1) + (p,), dtype=object)
        out[(0,) * (r.ndim - 1) + (k,)] = r
    tmp = _assemble(out, np.asarray(procs[:p], dtype=np.int64).reshape(
        out.shape))
    return _on_default(tmp)


# numpy-style reduction methods on DArray and SubDArray (Julia semantics:
# ``dims=`` keeps reduced dims, std/var default to ddof=1)
_METHODS = {"sum": dsum, "mean": dmean, "std": dstd, "var": dvar,
            "min": dminimum, "max": dmaximum, "prod": dprod,
            "all": dall, "any": dany}


def _method(fn):
    @functools.wraps(fn)
    def m(self, dims=None, **kw):
        return fn(self, dims=dims, **kw)
    return m


for _mname, _fn in _METHODS.items():
    setattr(DArray, _mname, _method(_fn))
    setattr(SubDArray, _mname, _method(_fn))
