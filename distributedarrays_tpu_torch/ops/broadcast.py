"""Elementwise / broadcasting over DArrays, owner-computes per rank.

PyTorch counterpart of ``distributedarrays_tpu/ops/broadcast.py``.  The JAX
package compiles one XLA program over the sharded global arrays; here each
rank applies the function to its own chunk on its own device.  The result
takes the layout of ``out``, else of the first DArray argument with the
result's shape, else the default layout.  Arguments on another layout are
aligned to it through ``parallel.reshard``; numpy arrays, tensors and
DArrays of a smaller (broadcast) shape are sliced per chunk under numpy's
broadcasting rules; scalars stay scalars.

The function sees torch tensors: ``dmap(torch.sin, A)``.  Broadcast and
reductions have no hand-written kernel in the JAX package (XLA fuses
them), so they stay plain torch ops here.
"""

from __future__ import annotations

import numbers
import operator
from typing import Callable

import numpy as np
import torch

from ..darray import DArray, SubDArray, as_tensor, resolve_layout
from ..layout import device_of
from ..parallel.reshard import relayout_parts

__all__ = ["elementwise", "dmap", "dmap_into", "broadcasted"]

_SCALARS = (numbers.Number, np.generic)


def _arg_shape(a):
    if isinstance(a, (DArray, SubDArray)):
        return tuple(a.shape)
    if isinstance(a, _SCALARS):
        return ()
    return tuple(np.shape(a))


def _slicer(shape, ndim):
    """Per-chunk slice of a broadcast operand of ``shape`` for a chunk with
    global ``bounds`` of an ``ndim``-d result (numpy rules: right-aligned,
    size-1 dims broadcast)."""
    off = ndim - len(shape)

    def sl(bounds):
        return tuple(slice(None) if s == 1 else slice(*bounds[i + off])
                     for i, s in enumerate(shape))
    return sl


def _pieces(arg, pids, cuts, dims):
    """A function from grid cell to ``arg``'s piece for that cell."""
    if isinstance(arg, _SCALARS):
        return lambda ci, dev, bounds: arg
    if isinstance(arg, DArray) and arg.dims == dims:
        parts = relayout_parts(arg, pids, cuts)
        return lambda ci, dev, bounds: parts[ci]
    if isinstance(arg, DArray):
        t = arg.full()
    elif isinstance(arg, SubDArray):
        t = arg.materialize()
    else:
        t = as_tensor(arg)
    sl = _slicer(tuple(t.shape), len(dims))
    return lambda ci, dev, bounds: t[sl(bounds)].to(dev)


def elementwise(fn: Callable, *args, out: DArray | None = None):
    """Apply ``fn`` elementwise over the (numpy-broadcast) arguments, each
    rank on its own chunk.  With ``out`` the result is written into
    ``out``'s chunks in place and ``out`` is returned."""
    shapes = [_arg_shape(a) for a in args]
    dims = tuple(np.broadcast_shapes(*shapes)) if shapes else ()
    if out is not None:
        out._check_open()
        if out.dims != dims:
            raise ValueError(
                f"broadcast result shape {dims} != out dims {out.dims}")
        template = out
    else:
        template = next((a for a in args
                         if isinstance(a, DArray) and a.dims == dims), None)
    if template is None:
        if not dims:
            # 0-d result from 0-d/scalar arguments: one plain call
            return fn(*[as_tensor(a) if not isinstance(a, _SCALARS) else a
                        for a in args])
        dims, pids, cuts = resolve_layout(dims)
    else:
        pids, cuts = template.pids, template.cuts
    getters = [_pieces(a, pids, cuts, dims) for a in args]
    parts = np.empty(tuple(pids.shape), dtype=object)
    for ci in np.ndindex(*pids.shape):
        bounds = [(c[j], c[j + 1]) for c, j in zip(cuts, ci)]
        dev = device_of(int(pids[ci]))
        r = fn(*[g(ci, dev, bounds) for g in getters])
        if not isinstance(r, torch.Tensor):
            r = torch.as_tensor(r, device=dev)
        shape = tuple(h - l for l, h in bounds)
        if out is not None:
            out.part(ci).copy_(r.expand(shape))
        else:
            parts[ci] = r.expand(shape).contiguous()
    if out is not None:
        return out
    return DArray(parts, np.array(pids, copy=True), cuts)


def dmap(fn: Callable, *ds, out: DArray | None = None):
    """Elementwise map over distributed arrays (reference ``map(f, d...)``)."""
    return elementwise(fn, *ds, out=out)


def dmap_into(fn: Callable, dest: DArray, *srcs):
    """In-place elementwise map into ``dest`` (reference ``map!``)."""
    return elementwise(fn, *srcs, out=dest)


def broadcasted(fn: Callable, *args):
    """Alias of ``elementwise``, named as in the reference."""
    return elementwise(fn, *args)


# ---------------------------------------------------------------------------
# Operator wiring on DArray / SubDArray
# ---------------------------------------------------------------------------

_OPERANDS = (DArray, SubDArray, np.ndarray, torch.Tensor) + _SCALARS


def _binop(fn, swap=False):
    def op(self, other):
        if not isinstance(other, _OPERANDS):
            return NotImplemented
        return elementwise(fn, other, self) if swap else \
            elementwise(fn, self, other)
    return op


def _unop(fn):
    def op(self):
        return elementwise(fn, self)
    return op


# the operator module's functions accept a Python scalar on either side
_BINOPS = {
    "add": operator.add, "sub": operator.sub, "mul": operator.mul,
    "truediv": operator.truediv, "floordiv": operator.floordiv,
    "mod": operator.mod, "pow": operator.pow,
    "and": operator.and_, "or": operator.or_, "xor": operator.xor,
    "lshift": operator.lshift, "rshift": operator.rshift,
}
_COMPARE = {"lt": operator.lt, "le": operator.le, "gt": operator.gt,
            "ge": operator.ge}

for _cls in (DArray, SubDArray):
    for _name, _fn in _BINOPS.items():
        setattr(_cls, f"__{_name}__", _binop(_fn))
        setattr(_cls, f"__r{_name}__", _binop(_fn, swap=True))
    for _name, _fn in _COMPARE.items():
        setattr(_cls, f"__{_name}__", _binop(_fn))
    _cls.__neg__ = _unop(operator.neg)
    _cls.__pos__ = _unop(operator.pos)
    _cls.__abs__ = _unop(operator.abs)
    _cls.__invert__ = _unop(operator.invert)
