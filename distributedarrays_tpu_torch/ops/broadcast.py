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

``djit(fn)`` is the counterpart of JAX's one compiled program over the
global arrays: ``fn``, written over torch tensors, runs once on the whole
arrays on the first DArray argument's home device, and each array result
is distributed on the layout of the first DArray argument of its shape.

Across controller processes (``parallel.multihost``) the operators,
``dmap`` and ``dmap_into`` run on each process's own chunks: a cell
another process holds is a placeholder on the ``meta`` device, where
``fn`` only infers the result cell's shape and dtype.  An argument on
another layout comes through the cross-process reshard (each process
fetches its own cells' pieces), whole-array ``==`` folds every process's
cell answers, and ``djit`` takes the whole inputs onto every process's
device by one region call.

``a == b`` on a DArray or SubDArray is the reference's whole-array
equality, one Python bool, as in the JAX package; ``<``, ``<=``, ``>``
and ``>=`` are elementwise.

The operators on DArrays (``+``, ``-``, ``*``, ``/``, ``//``, ``%``,
``**``, the bitwise ones and the comparisons) promote their operands as
JAX does with 64-bit types off before the torch op runs (``promote``):
the least upper bound in JAX's promotion lattice, where a Python int,
float or complex is weakly typed and a Python bool is a bool; ``/`` takes
a float of it, ``//``, ``%``, the shifts and ``**`` an int32 for bool.  A
Python scalar is rounded or wrapped into the promoted type first, as JAX
converts it, and ``x ** n`` for a Python integer ``n`` keeps the type of
``x`` (int32 for bool) and multiplies by squaring, as ``lax.integer_pow``
does, so integer powers wrap.
"""

from __future__ import annotations

import functools
import numbers
import operator
from typing import Callable

import numpy as np
import torch

from .. import telemetry as _tm
from ..darray import (DArray, SubDArray, _scatter, as_tensor, canon_dtype,
                      from_global, resolve_layout)
from ..layout import device_of
from ..parallel import multihost
from ..parallel.reshard import relayout_parts

__all__ = ["elementwise", "dmap", "dmap_into", "broadcasted", "djit",
           "promote", "result_dtype"]

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
    if isinstance(arg, _SCALARS):  # dalint: disable=DAL010 — arg's type is the caller's, the same on every process
        return lambda ci, dev, bounds: arg
    if isinstance(arg, DArray) and arg.dims == dims:  # dalint: disable=DAL010 — arg's type and dims are the same on every process
        parts = relayout_parts(arg, pids, cuts)
        return lambda ci, dev, bounds: parts[ci]
    if isinstance(arg, DArray):  # dalint: disable=DAL010 — arg's type is the same on every process
        t = arg.full()
    elif isinstance(arg, SubDArray):  # dalint: disable=DAL010 — arg's type is the same on every process
        t = arg.materialize()
    else:
        t = as_tensor(arg)
    if _tm.enabled():
        # an operand that does not take the result's layout reaches every
        # rank whole or in broadcast pieces: JAX's replicated placement
        # (``broadcast.py:110``), counted and not journaled
        _tm.record_comm("replicate", _tm.nbytes_of(t), op="broadcast_align",
                        journal=False)
    sl = _slicer(tuple(t.shape), len(dims))
    return lambda ci, dev, bounds: t[sl(bounds)].to(dev)


def _storage(t: torch.Tensor) -> tuple:
    """A key of the memory that ``t`` views (empty tensors own none)."""
    if not t.numel():
        return ()
    return (t.device, t.untyped_storage().data_ptr())


def elementwise(fn: Callable, *args, out: DArray | None = None):
    """Apply ``fn`` elementwise over the (numpy-broadcast) arguments, each
    rank on its own chunk.  With ``out``, ``out`` is rebound to the result
    and returned, as JAX's ``out._rebind(res)`` (``broadcast.py:215``): it
    takes the result's dtype.  When that is ``out``'s own dtype, the
    result is written into ``out``'s tensors in place."""
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
    if template is None:  # dalint: disable=DAL010 — template (the first DArray argument) is the same on every process
        if not dims:
            # 0-d result from 0-d/scalar arguments: one plain call
            return fn(*[as_tensor(a) if not isinstance(a, _SCALARS) else a
                        for a in args])
        dims, pids, cuts = resolve_layout(dims)
    else:
        pids, cuts = template.pids, template.cuts
    getters = [_pieces(a, pids, cuts, dims) for a in args]
    parts = np.empty(tuple(pids.shape), dtype=object)
    inputs = set()    # storages of the pieces fn was given
    for ci in np.ndindex(*pids.shape):
        bounds = [(c[j], c[j + 1]) for c, j in zip(cuts, ci)]
        dev = device_of(int(pids[ci]))
        pieces = [g(ci, dev, bounds) for g in getters]
        inputs.update(_storage(t) for t in pieces
                      if isinstance(t, torch.Tensor))
        r = fn(*pieces)
        if not isinstance(r, torch.Tensor):
            r = torch.as_tensor(r, device=dev)
        want = canon_dtype(r.dtype)
        if r.dtype != want:
            # a 64-bit result is stored in its 32-bit type, as JAX's
            r = r.to(want)
        parts[ci] = r.expand(tuple(h - l for l, h in bounds))
    if out is None or parts.flat[0].dtype != out.dtype:
        # the new tensors are the result's own: a part that fn returned
        # from its arguments (``lambda x: x``, ``x.float()`` of a float32
        # chunk) is copied
        for ci in np.ndindex(*pids.shape):
            t = parts[ci].contiguous()
            parts[ci] = t.clone() if _storage(t) in inputs else t
    if out is None:
        return DArray(parts, np.array(pids, copy=True), cuts)
    if parts.flat[0].dtype != out.dtype:
        out._rebind(parts)
    else:
        for ci in np.ndindex(*pids.shape):
            # a placeholder of another process's cell copies nothing
            out._parts[ci].copy_(parts[ci])
        out._relabel("rebind")        # JAX's out._rebind(res)
    return out


def dmap(fn: Callable, *ds, out: DArray | None = None):
    """Elementwise map over distributed arrays (reference ``map(f, d...)``)."""
    return elementwise(fn, *ds, out=out)


def dmap_into(fn: Callable, dest: DArray, *srcs):
    """In-place elementwise map into ``dest`` (reference ``map!``)."""
    return elementwise(fn, *srcs, out=dest)


def broadcasted(fn: Callable, *args):
    """Alias of ``elementwise``, named as in the reference."""
    return elementwise(fn, *args)


def djit(fn: Callable) -> Callable:
    """``fn`` over DArrays as one call on the global tensors (JAX
    ``ops/broadcast.py:245``).

    Each DArray argument enters as ``full()`` on the first DArray
    argument's home device, each SubDArray materialized and each numpy
    array as a tensor there (JAX's jit takes numpy arrays as arrays);
    ``fn`` uses torch ops.  Each array result of ndim >= 1 is distributed
    on the layout of the first DArray argument of its shape, else on the
    default layout (JAX ``broadcast.py:272-283``); other results come back
    as they are.  In a job of several processes every process takes the
    whole inputs onto its own device by one region call
    (``multihost.fetch_regions``), runs ``fn`` and keeps its own chunks of
    each array result; a 0-d or non-array result is the same on every
    process (JAX runs ``fn`` once under SPMD; the values and layouts
    agree)."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        d_args = [a for a in args if isinstance(a, DArray)]
        dev = d_args[0].home() if d_args else device_of(0)
        # the whole inputs, by one region call in a job
        fulls = multihost.fetch_regions([(a, None, dev) for a in d_args])
        whole = dict(zip(map(id, d_args), fulls))
        raw = [whole[id(a)] if isinstance(a, DArray) else
               a.materialize().to(dev) if isinstance(a, SubDArray) else
               as_tensor(a).to(dev) if isinstance(a, np.ndarray) else a
               for a in args]

        def wrap(r):
            if not isinstance(r, torch.Tensor) or r.ndim == 0:
                return r
            r = as_tensor(r)
            for a in d_args:
                if a.dims == tuple(r.shape):
                    return DArray(_scatter(r, a.pids, a.cuts),
                                  a.pids.copy(), a.cuts)
            return from_global(r)
        res = fn(*raw, **kwargs)
        if isinstance(res, (tuple, list)):
            return type(res)(wrap(r) for r in res)
        if isinstance(res, dict):
            return {k: wrap(r) for k, r in res.items()}
        return wrap(res)
    return wrapper


# ---------------------------------------------------------------------------
# JAX's type promotion (jax._src.dtypes, 64-bit types off)
# ---------------------------------------------------------------------------

# the promotion lattice: each type's immediate upper bounds; "i*", "f*" and
# "c*" are the weak types of Python int, float and complex scalars
_LATTICE = {
    torch.bool: ("i*",),
    "i*": (torch.uint8, torch.int8),
    torch.uint8: (torch.int16, torch.uint16),
    torch.uint16: (torch.int32, torch.uint32),
    torch.uint32: (torch.int64, torch.uint64),
    torch.uint64: ("f*",),
    torch.int8: (torch.int16,),
    torch.int16: (torch.int32,),
    torch.int32: (torch.int64,),
    torch.int64: ("f*",),
    "f*": ("c*", torch.bfloat16, torch.float16),
    torch.bfloat16: (torch.float32,),
    torch.float16: (torch.float32,),
    torch.float32: (torch.float64, torch.complex64),
    torch.float64: (torch.complex128,),
    "c*": (torch.complex64,),
    torch.complex64: (torch.complex128,),
    torch.complex128: (),
}
# a weak result's dtype, and the 32-bit counterparts of 64-bit types
_DEFAULT = {"i*": torch.int32, "f*": torch.float32, "c*": torch.complex64,
            torch.int64: torch.int32, torch.uint64: torch.uint32,
            torch.float64: torch.float32, torch.complex128: torch.complex64}


def _upper(t) -> set:
    out, todo = {t}, [t]
    while todo:
        for u in _LATTICE[todo.pop()]:
            if u not in out:
                out.add(u)
                todo.append(u)
    return out


def _jax_type(a):
    """An operand's node in the lattice: Python bool is bool, Python int,
    float and complex are weak, anything else its (32-bit) dtype."""
    if isinstance(a, bool):
        return torch.bool
    if isinstance(a, (int, float, complex)) and not isinstance(a,
                                                               np.generic):
        return "i*" if isinstance(a, int) else \
            "f*" if isinstance(a, float) else "c*"
    if isinstance(a, (DArray, SubDArray, torch.Tensor)):
        dt = a.dtype
    else:
        dt = canon_dtype(np.asarray(a).dtype)
    return _DEFAULT.get(dt, dt)


def _join(*types) -> torch.dtype:
    """The least upper bound of lattice nodes, as a 32-bit dtype."""
    common = set.intersection(*[_upper(t) for t in types])
    lub = next(u for u in common if common <= _upper(u))
    return _DEFAULT.get(lub, lub)


def result_dtype(*operands) -> torch.dtype:
    """The dtype JAX gives an arithmetic result of ``operands`` (DArrays,
    tensors, arrays or Python scalars)."""
    return _join(*[_jax_type(a) for a in operands])


def _numeric(dt: torch.dtype) -> torch.dtype:
    return torch.int32 if dt == torch.bool else dt


def _inexact(dt: torch.dtype) -> torch.dtype:
    return dt if dt.is_floating_point or dt.is_complex else torch.float32


def _scalar_as(v, dt: torch.dtype):
    """A Python scalar converted to ``dt`` as JAX converts it (rounded to a
    float type, wrapped into an integer type), kept a Python scalar."""
    if dt == torch.bool:
        return bool(v)
    if dt.is_floating_point or dt.is_complex:
        return torch.tensor(v, dtype=dt).item()
    return torch.tensor(int(v)).to(dt).item()


def _integer_pow(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x ** n`` by squaring in ``x``'s type, ``lax.integer_pow``'s
    order of products (integer types wrap)."""
    if n == 0:
        return torch.ones_like(x)
    if n < 0 and not (x.is_floating_point() or x.is_complex()):
        raise ValueError("integers to negative integer powers are not "
                         "defined")
    acc, m = None, abs(n)
    while m:
        if m & 1:
            acc = x if acc is None else acc * x
        m >>= 1
        if m:
            x = x * x
    return 1 / acc if n < 0 else acc


def _is_index(a) -> bool:
    return isinstance(a, (int, np.integer))


_NUMERIC_OPS = ("floordiv", "mod", "lshift", "rshift")

# uint16 and uint32 compute in the next wider signed type, the integer
# result wrapped back (modulo 2**16 or 2**32, as JAX's wrap): torch has
# few kernels for them (on the CPU add, the orderings and abs raise)
_WIDE = {torch.uint16: torch.int32, torch.uint32: torch.int64}


def widened(fn: Callable, dt: torch.dtype) -> Callable:
    """``fn`` with its tensor arguments (of type ``dt``) taken in ``dt``'s
    wider signed type and an integer result cast back to ``dt``; ``fn``
    itself for other types."""
    wide = _WIDE.get(dt)
    if wide is None:
        return fn

    def run(*xs):
        r = fn(*[x.to(wide) if isinstance(x, torch.Tensor) else x
                 for x in xs])
        return r.to(dt) if r.dtype == wide else r
    return run


def _lex_compare(name: str) -> Callable:
    """The ordering ``name`` of complex values in numpy's (and JAX's)
    lexicographic order: the real parts, then the imaginary parts."""
    strict = name in ("lt", "gt")

    def parts(x):
        x = x if isinstance(x, torch.Tensor) else complex(x)
        return x.real, x.imag

    def cmp(a, b):
        if name in ("gt", "ge"):
            a, b = b, a
        (ar, ai), (br, bi) = parts(a), parts(b)
        return (ar < br) | ((ar == br) & ((ai < bi) if strict
                                          else (ai <= bi)))
    return cmp


def promote(name: str, fn: Callable, args: tuple):
    """``(fn', args')``: the operator ``name`` (a key of ``_BINOPS`` or
    ``_COMPARE``) applied as JAX applies it: tensors cast to the promoted
    type, Python scalars converted to it."""
    if name == "pow" and _is_index(args[1]):
        dt = _numeric(_join(_jax_type(args[0])))
        n = int(args[1])
        return (lambda x: _integer_pow(x.to(dt), n)), args[:1]
    dt = result_dtype(*args)
    if name == "truediv":
        dt = _inexact(dt)
    elif name in _NUMERIC_OPS or name == "pow":
        dt = _numeric(dt)
    args = tuple(_scalar_as(a, dt) if isinstance(a, (bool, int, float,
                                                     complex)) else a
                 for a in args)
    if name in _COMPARE and dt.is_complex:
        fn = _lex_compare(name)
    fn = widened(fn, dt)

    def cast(x):
        return x.to(dt) if isinstance(x, torch.Tensor) else x
    return (lambda *xs: fn(*[cast(x) for x in xs])), args


# ---------------------------------------------------------------------------
# Operator wiring on DArray / SubDArray
# ---------------------------------------------------------------------------

_OPERANDS = (DArray, SubDArray, np.ndarray, torch.Tensor) + _SCALARS


def _binop(name, fn, swap=False):
    def op(self, other):
        if not isinstance(other, _OPERANDS):
            return NotImplemented
        f, args = promote(name, fn, (other, self) if swap else (self, other))
        return elementwise(f, *args)
    return op


def _unop(fn):
    def op(self):
        return elementwise(widened(fn, self.dtype), self)
    return op


def _array_equal(a, b):
    """Whole-array equality of a DArray or SubDArray ``a`` with ``b`` (JAX
    ``darray.py:853-885``, :1007): one Python bool, False when the shapes
    differ, NotImplemented when ``b`` is not a DArray, SubDArray, ndarray
    or tensor; NaN is unequal to NaN.  Both sides are cast to JAX's
    result type first and compared on the device, piece by piece on
    ``a``'s layout (a SubDArray ``a`` is materialized on its parent's home
    device)."""
    if not isinstance(b, (DArray, SubDArray, np.ndarray, torch.Tensor)):
        return NotImplemented
    shape = tuple(a.shape)
    if _arg_shape(b) != shape:
        return False
    dt = result_dtype(a, b)
    if isinstance(a, SubDArray):
        if isinstance(b, DArray):
            return _array_equal(b, a)
        t = a.materialize()
        other = b.materialize() if isinstance(b, SubDArray) else as_tensor(b)
        return torch.equal(t.to(dt), other.to(t.device, dt))
    a._check_open()
    piece = _pieces(b, a.pids, a.cuts, a.dims)

    def same(ci):
        x = a.part(ci)
        bounds = [(c[j], c[j + 1]) for c, j in zip(a.cuts, ci)]
        y = piece(ci, x.device, bounds)
        return torch.equal(x.to(dt), y.to(x.device, dt))
    # in a job each process compares its own cells and every process
    # gets every cell's answer
    return all(multihost.cell_values(a, same))


def _not_equal(a, b):
    r = _array_equal(a, b)
    return NotImplemented if r is NotImplemented else not r


def _pos(x):
    # a copy: +x of a bool is the bool, as in JAX (torch has no bool pos),
    # and torch's +x of other types is x itself, not a new tensor
    return x.clone()


def _abs(x):
    # abs of a bool is the bool, as in JAX (torch has no bool abs)
    return x if x.dtype == torch.bool else operator.abs(x)


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
        setattr(_cls, f"__{_name}__", _binop(_name, _fn))
        setattr(_cls, f"__r{_name}__", _binop(_name, _fn, swap=True))
    for _name, _fn in _COMPARE.items():
        setattr(_cls, f"__{_name}__", _binop(_name, _fn))
    _cls.__eq__ = _array_equal
    _cls.__ne__ = _not_equal
    _cls.__neg__ = _unop(operator.neg)
    _cls.__pos__ = _unop(_pos)
    _cls.__abs__ = _unop(_abs)
    _cls.__invert__ = _unop(operator.invert)
