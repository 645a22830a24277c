"""The DArray: a global-view distributed array made of per-rank tensors.

PyTorch counterpart of ``distributedarrays_tpu/darray.py``: the
constructors, layout queries, indexing and region writes, the in-place
mutations, ``DData`` and ``gather``.

A ``DArray`` keeps the reference's layout fields: ``dims`` (global shape),
``pids`` (N-D grid of owning ranks), ``indices`` (per-chunk global index
ranges) and ``cuts`` (per-dimension cut vectors), uneven chunks included.
Its payload is a pid-grid of tensors, one exact-size chunk per rank, each
on its rank's ``torch.device`` (see ``layout.init``).  The JAX package's
blocked padding was a constraint of XLA sharding and has no counterpart
here; ``localpart``/``localindices`` return what the JAX package returns.

dtypes follow the JAX package, which runs with 64-bit types off: a float64
or int64 (or complex128) input is stored as float32 or int32 (complex64),
so results match the reference.

Random constructors draw from one ``torch.Generator`` per rank, reset by
``seed``.  JAX's random streams cannot be reproduced, so random arrays
agree with the JAX package in layout and distribution only.

Tensors are mutable where JAX arrays are not, so every DArray owns its
tensors: a constructor, ``copy``, ``astype``, ``reshape`` or ``similar``
never hands out a tensor another DArray holds, and a write (``d[k] = v``,
``fill_``, ``copyto_``, ``set_localpart``) changes the owner ranks' tensors
in place and nothing else.  ``localpart`` is the exception on purpose: it
returns the rank's own tensor, as the reference's ``localpart`` is the
worker's array, so writes to it show through the DArray.

The memory ledger (``telemetry.memory``) tracks every DArray's rank
tensors where they are allocated: ``ctor`` at construction, ``rebind``
when the tensors are replaced; ``close`` and the finalizer release them.
A write in place (``set_localpart``, a region write's ``mutate``,
``fill_``, ``rand_``, ``copyto_``'s ``rebind``) keeps the tensors and
their bytes, and only relabels the entry with its call site's label.

**Across controller processes** (``parallel.multihost``): after
``multihost.initialize`` the rank table spans the job's processes, and a
DArray's cells on another process's ranks are placeholders on the
``meta`` device that know their shape and dtype.  The constructors take
the same arguments (the same host array) on every process and place only
the local chunks; ``drand`` and its kin draw a rank's chunk from the
rank's own generator, so the values do not depend on which process holds
the rank.  ``localpart`` of another process's rank raises; ``region`` is
collective (``multihost.fetch_regions``: each process gets its box from
wherever the pieces live, by one copy launch a process on the card), and
with it ``gather``/``full``/``np.asarray``, ``distribute`` of a DArray,
``reshape``, ``dcat`` and the advanced keys; an element (``d[i, j]``
under ``allowscalar``, ``dfetch``) comes from its owner to every
process.  Operators and ``dmap`` run on the local chunks, and the memory
ledger counts the local tensors only.  ``part`` of a remote cell raises
``NotImplementedError``, so an op that reads another process's chunk
without a cross-process form fails instead of gathering quietly.
"""

from __future__ import annotations

import itertools
import weakref
from typing import Callable, Sequence

import numpy as np
import torch

from . import core
from . import layout as L
from .core import allowscalar, current_rank, _scalar_indexing_allowed
from . import telemetry as _tm

__all__ = [
    "DArray",
    "SubDArray",
    "SubOrDArray",
    "DData",
    "ddata",
    "darray",
    "darray_like",
    "dfromfunction",
    "from_chunks",
    "darray_from_cuts",
    "dzeros",
    "dones",
    "dfill",
    "drand",
    "drandn",
    "drandint",
    "dsample",
    "distribute",
    "copyto_",
    "dcat",
    "dfetch",
    "isassigned",
    "gather",
    "localpart",
    "localindices",
    "locate",
    "makelocal",
    "allowscalar",
    "seed",
]


# 64-bit types become their 32-bit counterparts, as under JAX with x64 off
_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32,
           torch.uint64: torch.uint32, torch.complex128: torch.complex64}


def canon_dtype(dtype) -> torch.dtype:
    """The dtype a DArray stores for ``dtype`` (torch or numpy)."""
    if not isinstance(dtype, torch.dtype):
        dtype = torch.from_numpy(np.zeros(0, dtype=np.dtype(dtype))).dtype
    return _NARROW.get(dtype, dtype)


def as_tensor(x) -> torch.Tensor:
    """``x`` (tensor, ndarray, scalar or nested list) as a tensor with the
    stored dtype; a tensor keeps its device."""
    if isinstance(x, DArray):
        raise TypeError("as_tensor expects host data, not a DArray")
    if isinstance(x, torch.Tensor):
        t = x
    else:
        a = np.asarray(x)
        # torch wants writable memory (numpy views of JAX arrays are not)
        t = torch.as_tensor(a if a.flags.writeable else a.copy())
    want = canon_dtype(t.dtype)
    return t if t.dtype == want else t.to(want)


# ---------------------------------------------------------------------------
# Per-rank random generators
# ---------------------------------------------------------------------------

_seed = 1234
_gens: dict[int, torch.Generator] = {}


def seed(n: int) -> None:
    """Reset every rank's generator; rank ``r`` draws from a stream derived
    from ``(n, r)``."""
    global _seed
    _seed = int(n)
    _gens.clear()


def _gen(rank: int) -> torch.Generator | None:
    """Rank ``rank``'s generator; None for another process's rank, whose
    placeholder is drawn on the ``meta`` device and holds no values."""
    dev = L.device_of(rank)
    if dev.type == "meta":
        return None
    g = _gens.get(rank)
    if g is None or g.device != dev:
        s = int(np.random.SeedSequence([_seed, rank]).generate_state(1)[0])
        g = torch.Generator(device=dev).manual_seed(s)
        _gens[rank] = g
    return g


# ---------------------------------------------------------------------------
# DArray
# ---------------------------------------------------------------------------

# the queue entry of the ops' cross-process forms
_CROSS_PROCESS_QUEUE = "ROADMAP.md queue A, 'Cross-process forms'"


def _finalize(did):
    """Finalizer: the registry and the ledger stay tidy when a DArray is
    collected without a close."""
    core.unregister(did)
    try:
        _tm.memory.untrack(did)
    except Exception:  # pragma: no cover — interpreter-shutdown safety
        pass


class DArray:
    """Global-view distributed array: ``dims``, ``pids``, ``indices`` and
    ``cuts`` as in the reference, and one tensor per grid cell."""

    __slots__ = ("id", "dims", "pids", "indices", "cuts", "_parts", "_dtype",
                 "_closed", "__weakref__")

    # numpy operands defer to the DArray's reflected operators
    __array_ufunc__ = None

    def __init__(self, parts: np.ndarray, pids: np.ndarray,
                 cuts: Sequence[Sequence[int]], did=None):
        cuts = [[int(x) for x in c] for c in cuts]
        grid = tuple(len(c) - 1 for c in cuts)
        if tuple(pids.shape) != grid or tuple(parts.shape) != grid:
            raise ValueError(
                f"pid grid {pids.shape} / parts {parts.shape} do not match "
                f"the chunk grid {grid}")
        indices = L.idxs_from_cuts(cuts, grid)
        dtype = None
        for ci in np.ndindex(*grid):
            t = parts[ci]
            want = tuple(len(r) for r in indices[ci])
            dev = L.device_of(int(pids[ci]))
            if tuple(t.shape) != want or t.device != dev:
                raise ValueError(
                    f"chunk {ci} is {tuple(t.shape)} on {t.device}; expected "
                    f"{want} on {dev}")
            if dtype is None:
                dtype = t.dtype
            elif t.dtype != dtype:
                raise TypeError(f"chunk dtypes differ: {dtype} vs {t.dtype}")
        self.id = did if did is not None else core.next_did()
        self.dims = tuple(c[-1] for c in cuts)
        self.pids = pids
        self.indices = indices
        self.cuts = cuts
        self._parts = parts
        self._dtype = dtype
        self._closed = False
        core.register(self)
        self._track("ctor")
        weakref.finalize(self, _finalize, self.id)

    # -- basic protocol ----------------------------------------------------

    @property
    def shape(self):
        return self.dims

    @property
    def ndim(self):
        return len(self.dims)

    @property
    def dtype(self) -> torch.dtype:
        return self._dtype

    @property
    def size(self):
        return int(np.prod(self.dims)) if self.dims else 1

    @property
    def grid(self) -> tuple:
        return tuple(self.pids.shape)

    def part(self, ci) -> torch.Tensor:
        """The tensor of grid cell ``ci``; ``NotImplementedError`` for a
        cell that another controller process holds (the op asking for it
        has no cross-process form yet)."""
        self._check_open()
        t = self._parts[tuple(ci)]
        if t.device.type == "meta":
            r = int(self.pids[tuple(ci)])
            raise NotImplementedError(
                f"rank {r}'s chunk of {self!r} lives in controller process "
                f"{L.process_of(r)}: this op has no cross-process form yet "
                f"({_CROSS_PROCESS_QUEUE})")
        return t

    def cells(self):
        """Grid coordinates of every chunk, row-major."""
        return list(np.ndindex(*self.grid))

    def __len__(self):
        if not self.dims:
            raise TypeError("len() of 0-d DArray")
        return self.dims[0]

    def __repr__(self):
        grid = "x".join(str(s) for s in self.grid) or "1"
        return (f"DArray(id={self.id}, dims={self.dims}, dtype={self.dtype}, "
                f"chunks={grid}, ranks={sorted(int(p) for p in set(self.pids.flat))})")

    def __hash__(self):
        # by id, as the reference (darray.jl:72); set here because ``==``
        # (wired in ops/broadcast.py) compares whole arrays
        return hash(self.id)

    def __array__(self, dtype=None, copy=None):
        a = _to_numpy(self._gather_host())
        return a if dtype is None else a.astype(dtype, copy=False)

    @_tm.traced(name="gather")
    def _gather_host(self) -> torch.Tensor:
        """The whole array on the host (JAX ``darray.py:645``); in a job
        of several processes the collective gather, whose region copy
        keeps its own comm record."""
        if _tm.enabled() and L.process_count() == 1:
            from .telemetry import perf as _perf
            nb = _tm.nbytes_of(self)
            # cost stamp on the traced gather span: the payload through
            # HBM once (d2h transfer)
            _tm.annotate(**_perf.transfer_cost(nb))
            _tm.record_comm("d2h", nb, op="gather", shape=list(self.dims))
        return self.region(None, torch.device("cpu"))

    def _item(self):
        return self.region(None, torch.device("cpu")).reshape(()).item()

    def __bool__(self):
        """Only a size-1 DArray has a truth value (JAX ``darray.py:460``)."""
        if self.size != 1:
            raise ValueError(
                "truth value of a multi-element DArray is ambiguous; use "
                "dall()/dany()")
        return bool(self._item())

    def __iter__(self):
        """Rows on the host, behind the scalar guard (JAX
        ``darray.py:468``): iterating gathers."""
        _scalar_indexing_allowed()
        return iter(np.asarray(self))

    def __float__(self):
        """The value of a size-1 DArray (JAX ``darray.py:473``)."""
        if self.size != 1:
            raise TypeError("only size-1 DArray converts to float")
        return float(self._item())

    # -- lifecycle ---------------------------------------------------------

    def _check_open(self):
        if self._closed:
            raise RuntimeError(f"DArray {self.id} is closed")

    def _close(self, _unregister=True):
        if not self._closed:
            self._closed = True
            # always, so the ledger drains after a mid-run disable()
            _tm.memory.untrack(self.id)
            self._parts = None
            if _unregister:
                core.unregister(self.id)

    def _track(self, site: str) -> None:
        """(Re)attribute the rank tensors to this DArray in the memory
        ledger under ``site`` (JAX tracks only while telemetry is on)."""
        if _tm.enabled():
            _tm.memory.track(self.id, self._parts, site=site,
                             ranks=self.pids)

    def _relabel(self, site: str) -> None:
        """Label the ledger entry with the in-place write ``site``; the
        tensors and their bytes are unchanged."""
        if _tm.enabled():
            _tm.memory.relabel(self.id, site)

    def close(self):
        """Release the rank tensors now."""
        self._close()

    # -- layout queries ----------------------------------------------------

    def localpartindex(self, pid: int | None = None) -> tuple | None:
        """Grid coordinates of the chunk owned by ``pid`` (default: the
        calling rank, ``current_rank()``); None if ``pid`` holds none."""
        pid = current_rank() if pid is None else pid
        hits = np.argwhere(self.pids == pid)
        if hits.size == 0:
            return None
        return tuple(int(x) for x in hits[0])

    def localindices(self, pid: int | None = None) -> tuple:
        """Global index ranges of rank ``pid``'s chunk (default: the calling
        rank's)."""
        ci = self.localpartindex(pid)
        if ci is None:
            return tuple(range(0, 0) for _ in self.dims)
        return self.indices[ci]

    def localpart(self, pid: int | None = None) -> torch.Tensor:
        """Rank ``pid``'s chunk (default: the calling rank's, so inside
        ``spmd`` each task reads its own): the stored tensor itself, no
        copy, so a write to it is a write to the DArray (the reference's
        ``localpart`` is the worker's array); an empty tensor when ``pid``
        holds none."""
        self._check_open()
        ci = self.localpartindex(pid)
        if ci is None:
            return torch.empty((0,) * max(self.ndim, 1), dtype=self.dtype)
        t = self._parts[ci]
        if t.device.type == "meta":
            r = int(self.pids[ci])
            raise RuntimeError(
                f"rank {r}'s chunk lives in controller process "
                f"{L.process_of(r)}; this process holds ranks "
                f"{L.local_ranks()} (use multihost.host_local_slice)")
        return t

    @property
    def lp(self) -> torch.Tensor:
        """The calling rank's ``localpart`` (JAX ``darray.py:595``)."""
        return self.localpart(current_rank())

    @lp.setter
    def lp(self, value):
        self.set_localpart(value)

    def set_localpart(self, value, pid: int | None = None) -> None:
        """Overwrite rank ``pid``'s chunk in place with ``value`` cast to
        the DArray's dtype (JAX ``darray.py:605``)."""
        self._check_open()
        pid = current_rank() if pid is None else pid
        ci = self.localpartindex(pid)
        if ci is None:
            raise ValueError(f"rank {pid} holds no chunk of {self!r}")
        v = as_tensor(value)
        want = tuple(len(r) for r in self.indices[ci])
        if tuple(v.shape) != want:
            raise ValueError(f"localpart shape {tuple(v.shape)} != chunk "
                             f"shape {want}")
        self.localpart(pid).copy_(v)
        self._relabel("set_localpart")

    def locate(self, *I: int) -> tuple:
        """Chunk-grid coordinates owning global index ``I``."""
        return L.locate(self.cuts, *I)

    def chunk(self, pid: int) -> torch.Tensor:
        """Rank ``pid``'s chunk (JAX ``darray.py:636``)."""
        return self.localpart(pid)

    def procs(self) -> np.ndarray:
        """The rank grid (JAX ``darray.py:640``)."""
        return self.pids

    def home(self) -> torch.device:
        """Device of the first rank in the grid: where whole-array results
        (reductions, gathered regions) are placed.  When another process
        holds that rank, this process's own device (``layout
        .local_device``), where its copy of such a result goes."""
        dev = L.device_of(int(self.pids.flat[0]))
        return L.local_device() if dev.type == "meta" else dev

    # -- data movement -----------------------------------------------------

    def region(self, bounds, device) -> torch.Tensor:
        """A new tensor on ``device`` holding the global region ``bounds``
        (one ``(lo, hi)`` per dim; None for the whole array), copied from
        the chunks that intersect it.  In a job of several controller
        processes it is collective (``multihost.fetch_regions``): every
        process calls it, each process's box comes from wherever its
        pieces live, and a ``meta`` device (another process's cell) asks
        for nothing and gets a placeholder."""
        self._check_open()
        if L.process_count() > 1:
            from .parallel import multihost
            return multihost.fetch_regions([(self, bounds, device)])[0]
        if bounds is None:
            bounds = [(0, n) for n in self.dims]
        out = torch.empty([h - l for l, h in bounds], dtype=self.dtype,
                          device=device)
        if out.numel() == 0:
            return out
        for ci, src, dst in L.box_pieces(self.cuts, bounds):
            # straight from the piece into its view of the output: no
            # temporary on the target device
            out[dst].copy_(self._parts[ci][src])  # dalint: disable=DAL007 — DArray.region is the region read itself (the one-process form of multihost.fetch_regions): assembling a box on the caller's device is what it is for
        return out

    def full(self, device=None) -> torch.Tensor:
        """The whole array as one tensor on ``device`` (default: ``home``)."""
        return self.region(None, self.home() if device is None else device)

    def _rebind(self, parts: np.ndarray) -> None:
        """Take ``parts`` (this layout's cell tensors, of one dtype, owned by
        no other DArray) as the data, in place of the old tensors (JAX
        ``darray.py`` ``_rebind``)."""
        self._check_open()
        new = np.empty(self.grid, dtype=object)
        for ci in self.cells():
            t, old = parts[ci], self._parts[ci]
            if t.shape != old.shape or t.device != old.device:
                raise ValueError(f"rebind of chunk {ci}: {tuple(t.shape)} on "
                                 f"{t.device}, expected {tuple(old.shape)} "
                                 f"on {old.device}")
            new[ci] = t.contiguous()
        self._parts = new
        self._dtype = new.flat[0].dtype
        self._track("rebind")

    def with_parts(self, parts: np.ndarray) -> "DArray":
        """New DArray with this layout and the given cell tensors."""
        return DArray(parts, self.pids.copy(), self.cuts)

    # -- indexing ----------------------------------------------------------

    def __getitem__(self, key):
        self._check_open()
        key = _normalize_key(key, self.dims)
        if all(isinstance(k, int) for k in key):
            _scalar_indexing_allowed()
            return self._element(key)
        return SubDArray(self, key)

    def _element(self, key) -> torch.Tensor:
        """The element at the int ``key``, a 0-d tensor on ``home()``: a
        copy of the one-element region, which in a job of several
        processes comes from its owner by one region call, so every
        process gets the same value (JAX's ``d.garray[i]``)."""
        return self.region([(k, k + 1) for k in key],
                           self.home()).reshape(())

    def __setitem__(self, key, value):
        """``d[key] = value`` (JAX ``darray.py:807``): int and slice keys,
        and integer-array, list and boolean-mask keys under numpy's
        advanced-indexing rules; the scalar guard when every key is an
        int.  ``value`` (a scalar, array, tensor, DArray of any layout or
        SubDArray) is broadcast to the selection and cast to ``d.dtype``;
        only the ranks owning a selected element write, each into its own
        tensor in place."""
        self._check_open()
        key = _normalize_key(key, self.dims)
        if all(isinstance(k, int) for k in key):
            _scalar_indexing_allowed()
        self._write(key, value)

    def _write(self, key, value, site: str | None = None) -> None:
        """Write ``value`` into the region of the normalized ``key``: one
        in-place slice assignment per owner chunk, fed from the matching
        box of ``value`` (a DArray value of the region's shape gives each
        owner its box through ``region``, on the owner's device).  The
        ledger entry takes the label ``site``, ``mutate`` by default."""
        if _advanced(key):
            self._write_selected(key, value)
            self._relabel(site or "mutate")
            return
        spans = [_spans(k, n, c) for k, n, c in zip(key, self.dims, self.cuts)]
        if not all(spans):
            return                                   # empty region
        lens = [1 if isinstance(k, int) else len(range(*k.indices(n)))
                for k, n in zip(key, self.dims)]
        sliced = [d for d, k in enumerate(key) if not isinstance(k, int)]
        ints = [d for d, k in enumerate(key) if isinstance(k, int)]
        if isinstance(value, DArray) and value.dims == tuple(
                lens[d] for d in sliced):
            def box(bounds, dev):
                t = value.region([bounds[d] for d in sliced], dev)
                return t.reshape([h - l for l, h in bounds]).to(self.dtype)
        else:
            if isinstance(value, DArray):
                t = value.full()
            elif isinstance(value, SubDArray):
                t = value.materialize()
            else:
                t = as_tensor(value)
            t = t.to(self.dtype)
            if t.ndim:           # a 0-d value broadcasts in the assignment
                t = t.broadcast_to([lens[d] for d in sliced])
                for d in ints:
                    t = t.unsqueeze(d)

            def box(bounds, dev):
                return (t[tuple(slice(l, h) for l, h in bounds)] if t.ndim
                        else t).to(dev)
        for combo in itertools.product(*spans):
            part = self._parts[tuple(c[0] for c in combo)]
            v = box([c[2] for c in combo], part.device)
            flips = [d for d, c in enumerate(combo) if c[3]]
            if flips and v.ndim:
                v = v.flip(flips)
            part[tuple(c[1] for c in combo)] = v
        self._relabel(site or "mutate")

    def _by_owner(self, coords):
        """The selected elements grouped by the chunk that holds them: for
        each grid cell that holds some, ``(cell, positions, local index)``
        where ``positions`` are the elements' flat positions in the
        selection and ``local index`` one int64 array a dim into the
        cell's tensor."""
        flat = [c.reshape(-1) for c in coords]
        if not flat[0].size:
            return []
        js = [np.searchsorted(c, x, side="right") - 1
              for c, x in zip(self.cuts, flat)]
        cell = np.ravel_multi_index(js, self.grid)
        order = np.argsort(cell, kind="stable")
        bounds = np.flatnonzero(np.diff(cell[order])) + 1
        out = []
        for pos in np.split(order, bounds):
            ci = tuple(int(j[pos[0]]) for j in js)
            local = [x[pos] - c[j] for x, c, j in zip(flat, self.cuts, ci)]
            out.append((ci, pos, local))
        return out

    def _read_selected(self, key) -> torch.Tensor:
        """The elements an advanced ``key`` selects, in numpy's result
        shape, on ``home()``: each owner chunk gives its elements.  In a
        job of several processes each owner chunk's bounding box of its
        selected elements comes to every process by one region call, and
        the elements are picked from those boxes."""
        from .parallel import multihost
        shape, coords = _coords(key, self.dims)
        home = self.home()
        out = torch.empty(shape, dtype=self.dtype, device=home)
        flat = out.view(-1)
        owned = self._by_owner(coords)
        boxes = [[(int(x.min()) + c[j], int(x.max()) + 1 + c[j])
                  for x, c, j in zip(local, self.cuts, ci)]
                 for ci, _, local in owned]
        got = multihost.fetch_regions([(self, b, home) for b in boxes])
        for t, b, (ci, pos, local) in zip(got, boxes, owned):
            idx = tuple(torch.from_numpy(x - lo + c[j]).to(home) for
                        x, (lo, _), c, j in zip(local, b, self.cuts, ci))
            flat[torch.from_numpy(pos).to(home)] = t[idx]
        return out

    def _write_selected(self, key, value) -> None:
        """``value`` broadcast to the selection of an advanced ``key`` and
        cast to the dtype, each element written by its owner rank into its
        own tensor."""
        shape, coords = _coords(key, self.dims)
        if isinstance(value, DArray):
            t = value.full()
        elif isinstance(value, SubDArray):
            t = value.materialize()
        else:
            t = as_tensor(value)
        t = t.to(self.dtype).broadcast_to(shape).reshape(-1)
        for ci, pos, local in self._by_owner(coords):
            part = self._parts[ci]
            idx = tuple(torch.from_numpy(x).to(part.device) for x in local)
            part[idx] = t[torch.from_numpy(pos).to(t.device)].to(part.device)

    def makelocal(self, *I) -> torch.Tensor:
        """The region ``I`` as one dense tensor on ``home()``."""
        self._check_open()
        if not I:
            return self.full()
        key = _normalize_key(tuple(I) if len(I) > 1 else I[0], self.dims)
        key = tuple(slice(k, k + 1) if isinstance(k, int) else k for k in key)
        return SubDArray(self, key).materialize()

    # -- conveniences ------------------------------------------------------

    def _map_parts(self, fn) -> "DArray":
        """``fn`` of each cell (another process's placeholders on the
        ``meta`` device, where ``fn`` only infers the shape and dtype)."""
        self._check_open()
        parts = np.empty(self.grid, dtype=object)
        for ci in self.cells():
            parts[ci] = fn(self._parts[ci])
        return self.with_parts(parts)

    def copy(self) -> "DArray":
        """Independent copy with the same layout."""
        return self._map_parts(torch.clone)

    def __deepcopy__(self, memo):
        """``copy.deepcopy`` is ``copy`` (JAX ``darray.py:836``)."""
        c = memo.get(id(self))
        if c is None:
            memo[id(self)] = c = self.copy()
        return c

    def similar(self, dtype=None, dims=None) -> "DArray":
        """Zeros like ``d`` (JAX ``darray.py:842``): the same layout when
        ``dims`` match, else the default layout of ``dims`` over ``d``'s
        ranks."""
        dtype = self.dtype if dtype is None else canon_dtype(dtype)
        if dims is None or tuple(dims) == self.dims:
            return self._map_parts(lambda p: torch.zeros_like(p, dtype=dtype))
        return dzeros(tuple(dims), dtype=dtype,
                      procs=[int(p) for p in self.pids.flat])

    def reshape(self, *dims) -> "DArray":
        """A reshaped copy on the default layout of the new dims over
        ``d``'s ranks in sorted order (JAX ``darray.py:887``)."""
        if len(dims) == 1 and isinstance(dims[0], (tuple, list)):
            dims = tuple(dims[0])
        dims = tuple(int(d) for d in dims)
        if int(np.prod(dims)) != self.size:
            raise ValueError(f"cannot reshape size {self.size} into {dims}")
        pids = sorted(set(int(p) for p in self.pids.flat))
        # from_global copies each chunk out of the reshaped whole
        return from_global(self.full().reshape(dims), procs=pids)

    def astype(self, dtype) -> "DArray":
        """A copy in ``dtype`` on the same layout (JAX ``darray.py:898``),
        a copy even when the dtype is already ``dtype``."""
        dtype = canon_dtype(dtype)
        return self._map_parts(lambda p: p.to(dtype, copy=True))

    def fill_(self, x) -> "DArray":
        """Set every element to ``x`` cast to the dtype, in place (JAX
        ``darray.py:902``)."""
        self._check_open()
        v = as_tensor(x).to(self.dtype).item()
        for ci in self.cells():
            self._parts[ci].fill_(v)
        self._relabel("fill_")
        return self

    def rand_(self) -> "DArray":
        """Refill with uniform [0, 1) in place, each rank from its own
        generator (JAX ``darray.py:921``)."""
        self._check_open()
        for ci in self.cells():
            self._parts[ci].uniform_(generator=_gen(int(self.pids[ci])))
        self._relabel("rand_")
        return self


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    x = x.detach().cpu()
    # numpy has no bfloat16: it comes back as float32
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


# ---------------------------------------------------------------------------
# SubDArray: a lazy view
# ---------------------------------------------------------------------------


class SubDArray:
    """A lazy view of a region of a DArray; ``materialize()`` copies the
    region out of the chunks that hold it.  An advanced key (integer
    arrays, lists, boolean masks) selects under numpy's rules
    (``_result_shape``), as JAX's SubDArray does."""

    __slots__ = ("parent", "key")

    def __init__(self, parent: DArray, key: tuple):
        self.parent = parent
        self.key = key

    @property
    def shape(self):
        return _result_shape(self.key, self.parent.dims)

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def dtype(self):
        return self.parent.dtype

    @property
    def size(self):
        return int(np.prod(self.shape)) if self.shape else 1

    def materialize(self) -> torch.Tensor:
        """Dense tensor of the viewed region, on the parent's home device."""
        if _advanced(self.key):
            return self.parent._read_selected(self.key)
        bounds, sel, flips = [], [], []
        for k, n in zip(self.key, self.parent.dims):
            if isinstance(k, int):
                bounds.append((k, k + 1))
                sel.append(0)
                continue
            r = range(*k.indices(n))
            lo = min(r[0], r[-1]) if r else 0
            hi = max(r[0], r[-1]) + 1 if r else 0
            bounds.append((lo, hi))
            # torch slices only step forward: take the ascending run from
            # the bounding box, then flip the dims whose step was negative
            sel.append(slice(None, None, abs(r.step)))
            if r.step < 0:
                flips.append(sum(not isinstance(s, int) for s in sel) - 1)
        t = self.parent.region(bounds, self.parent.home())[tuple(sel)]
        return t.flip(flips) if flips else t

    def __array__(self, dtype=None, copy=None):
        a = _to_numpy(self.materialize())
        return a if dtype is None else a.astype(dtype, copy=False)

    def copy(self) -> DArray:
        """Distribute the viewed region as a fresh DArray."""
        return distribute(self.materialize())

    def __getitem__(self, key):
        """Index the materialized view (JAX ``darray.py:1004``)."""
        return self.materialize()[key]

    def __hash__(self):
        # by identity, as the JAX package's SubDArray; set here because
        # ``==`` (wired in ops/broadcast.py) compares whole arrays
        return id(self)

    def __repr__(self):
        return (f"SubDArray(parent={self.parent.id}, key={self.key}, "
                f"shape={self.shape})")


SubOrDArray = (DArray, SubDArray)


def _spans(k, n: int, cuts) -> list[tuple]:
    """The chunks of one dim that the normalized index ``k`` meets, as
    ``(chunk, local slice, (i0, i1), descending)``: the chunk's elements
    ``k`` selects, ascending, and the run ``[i0, i1)`` of ``k``'s own
    positions they are (taken in reverse when ``descending``)."""
    if isinstance(k, int):
        j = L.locate([cuts], k)[0]
        return [(j, slice(k - cuts[j], k - cuts[j] + 1), (0, 1), False)]
    a, stop, s = k.indices(n)
    m = len(range(a, stop, s))
    out = []
    for j in range(len(cuts) - 1):
        lo, hi = cuts[j], cuts[j + 1]
        if s > 0:     # positions a + i*s in [lo, hi)
            i0, i1 = max(0, -((a - lo) // s)), min(m, -((a - hi) // s))
        else:
            i0, i1 = max(0, (a - hi) // -s + 1), min(m, (a - lo) // -s + 1)
        if i0 >= i1:
            continue
        first, last = sorted((a + i0 * s, a + (i1 - 1) * s))
        out.append((j, slice(first - lo, last - lo + 1, abs(s)), (i0, i1),
                    s < 0))
    return out


def _index_array(k) -> np.ndarray:
    """An advanced index (list, array or tensor) as a numpy bool or int64
    array."""
    a = np.asarray(k.detach().cpu() if isinstance(k, torch.Tensor) else k)
    if a.dtype == np.bool_:
        if a.ndim == 0:
            raise IndexError("a 0-d boolean DArray index is not supported")
        return a
    if a.size == 0:
        return a.astype(np.int64)
    if not np.issubdtype(a.dtype, np.integer):
        raise IndexError(f"unsupported DArray index {k!r}: index arrays hold "
                         "integers or booleans")
    return a.astype(np.int64)


def _normalize_key(key, dims):
    """One entry a dim: an int, a slice, or an int64 array (a list, an
    integer array or tensor, or one array a dim of a boolean mask's
    ``nonzero()``, as numpy and JAX's ``jnp.asarray(k)`` take them),
    negative entries wrapped and every entry bounds-checked."""
    if not isinstance(key, tuple):
        key = (key,)
    key = [k if k is Ellipsis or isinstance(k, (int, np.integer, slice, range))
           else _index_array(k) for k in key]

    def width(k):         # the dims an entry consumes
        if k is Ellipsis:
            return 0
        return k.ndim if isinstance(k, np.ndarray) and k.dtype == np.bool_ \
            else 1
    used = sum(width(k) for k in key)
    ell = [i for i, k in enumerate(key) if k is Ellipsis]
    if ell:
        i = ell[0]
        key = key[:i] + [slice(None)] * (len(dims) - used) + key[i + 1:]
    elif used < len(dims):
        key = key + [slice(None)] * (len(dims) - used)
    if sum(width(k) for k in key) > len(dims):
        raise IndexError(f"too many indices for {len(dims)}-d DArray")
    out = []
    for k in key:
        d = len(out)
        if isinstance(k, np.ndarray) and k.dtype == np.bool_:
            if tuple(k.shape) != tuple(dims[d:d + k.ndim]):
                raise IndexError(f"boolean index of shape {k.shape} does not "
                                 f"match dims {tuple(dims[d:d + k.ndim])}")
            out.extend(ix.astype(np.int64) for ix in np.nonzero(k))
            continue
        n = dims[d]
        if isinstance(k, np.ndarray):
            k = np.where(k < 0, k + n, k)
            if k.size and (k.min() < 0 or k.max() >= n):
                raise IndexError(f"index out of bounds for dim {d} (size {n})")
            out.append(k)
        elif isinstance(k, (int, np.integer)):
            k = int(k)
            if k < 0:
                k += n
            if not 0 <= k < n:
                raise IndexError(
                    f"index {k} out of bounds for dim {d} (size {n})")
            out.append(k)
        elif isinstance(k, slice):
            start, stop, step = k.indices(n)
            # a descending run to the front ends at stop -1, which would
            # read as "from the end" when the slice is applied again
            out.append(slice(start, None if stop < 0 else stop, step))
        else:
            out.append(slice(k.start, k.stop, k.step))
    return tuple(out)


def _advanced(key) -> bool:
    return any(isinstance(k, np.ndarray) for k in key)


def _placement(key, dims):
    """``(adv, block, together, shape)`` of a normalized advanced key
    under numpy's rules (JAX ``darray.py:1107``): the positions of its
    ints and index arrays, which broadcast into one ``block`` of dims,
    placed where the first of them stands when they are consecutive
    (``together``), else in front; and the result ``shape``."""
    adv = [i for i, k in enumerate(key) if not isinstance(k, slice)]
    block = tuple(np.broadcast_shapes(*[np.shape(key[i]) for i in adv]))
    together = adv == list(range(adv[0], adv[0] + len(adv)))
    shape = [] if together else list(block)
    for d, k in enumerate(key):
        if isinstance(k, slice):
            shape.append(len(range(*k.indices(dims[d]))))
        elif together and d == adv[0]:
            shape.extend(block)
    return adv, block, together, tuple(shape)


def _result_shape(key, dims) -> tuple:
    """The shape of ``d[key]`` for a normalized key: ints drop their dims,
    index arrays place their block as ``_placement`` says."""
    if not _advanced(key):
        return tuple(len(range(*k.indices(n)))
                     for k, n in zip(key, dims) if isinstance(k, slice))
    return _placement(key, dims)[3]


def _coords(key, dims):
    """``(shape, coords)`` of an advanced key: the result shape and, a dim,
    the int64 global index of every result element (broadcast to
    ``shape``)."""
    adv, block, together, shape = _placement(key, dims)
    axis = 0 if together else len(block)
    first = 0
    coords = []
    for d, k in enumerate(key):
        sh = [1] * len(shape)
        if isinstance(k, slice):
            v = np.arange(*k.indices(dims[d]), dtype=np.int64)
            sh[axis] = v.size
            axis += 1
        else:
            if together and d == adv[0]:
                first = axis
                axis += len(block)
            v = np.broadcast_to(np.asarray(k, np.int64), block)
            sh[first:first + len(block)] = block
        coords.append(np.broadcast_to(v.reshape(sh), shape))
    return shape, coords


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------


def resolve_layout(dims, procs=None, dist=None):
    """``(dims, pids, cuts)`` for a default or explicit layout of ``dims``
    over the ranks ``procs`` (all ranks by default)."""
    dims = tuple(int(d) for d in dims)
    procs = L.all_ranks() if procs is None else [int(p) for p in procs]
    if dist is None:
        dist = L.defaultdist(dims, procs)
    dist = [int(c) for c in dist]
    if len(dist) != len(dims):
        raise ValueError(f"dist {dist} rank != dims {dims} rank")
    n = int(np.prod(dist)) if dist else 1
    if n > len(procs):
        raise ValueError(f"layout {dist} needs {n} ranks, have {len(procs)}")
    for p in procs[:n]:
        L.device_of(p)                       # validates the rank id
    _, cuts = L.chunk_idxs(dims, dist)
    pids = np.asarray(procs[:n], dtype=np.int64).reshape(tuple(dist))
    return dims, pids, cuts


def _scatter(t: torch.Tensor, pids: np.ndarray, cuts) -> np.ndarray:
    """Copy each chunk of the global tensor ``t`` to its rank's device (a
    fresh contiguous tensor per chunk, never a view of ``t``); another
    process's rank gets its placeholder on the ``meta`` device, so every
    process passes the same ``t`` and places only its own chunks (JAX
    ``_put_global_impl``, ``darray.py:1205``)."""
    grid = tuple(pids.shape)
    parts = np.empty(grid, dtype=object)
    for ci in np.ndindex(*grid):
        sl = tuple(slice(c[j], c[j + 1]) for c, j in zip(cuts, ci))
        src = t[sl]
        dst = torch.empty(src.shape, dtype=t.dtype,
                          device=L.device_of(int(pids[ci])))
        parts[ci] = dst.copy_(src)
    return parts


def from_global(t: torch.Tensor, procs=None, dist=None) -> DArray:
    """Distribute the global tensor ``t`` over a default (or given)
    layout."""
    _, pids, cuts = resolve_layout(t.shape, procs, dist)
    return DArray(_scatter(t, pids, cuts), pids, cuts)


def _fill_cells(dims, procs, dist, make: Callable,
                starts: bool = False) -> DArray:
    """``make(shape, rank, device)`` per cell of the layout, and the
    chunk's global start per dim after them when ``starts``."""
    dims, pids, cuts = resolve_layout(dims, procs, dist)
    grid = tuple(pids.shape)
    parts = np.empty(grid, dtype=object)
    for ci in np.ndindex(*grid):
        shape = tuple(c[j + 1] - c[j] for c, j in zip(cuts, ci))
        rank = int(pids[ci])
        extra = ([c[j] for c, j in zip(cuts, ci)],) if starts else ()
        parts[ci] = make(shape, rank, L.device_of(rank), *extra)
    return DArray(parts, pids, cuts)


def _as_dims(dims):
    if isinstance(dims, (int, np.integer)):
        return (int(dims),)
    return tuple(int(d) for d in dims)


def dzeros(dims, dtype=torch.float32, procs=None, dist=None) -> DArray:
    """Distributed zeros."""
    dtype = canon_dtype(dtype)
    return _fill_cells(_as_dims(dims), procs, dist,
                       lambda s, r, dev: torch.zeros(s, dtype=dtype,
                                                     device=dev))


def dones(dims, dtype=torch.float32, procs=None, dist=None) -> DArray:
    """Distributed ones."""
    dtype = canon_dtype(dtype)
    return _fill_cells(_as_dims(dims), procs, dist,
                       lambda s, r, dev: torch.ones(s, dtype=dtype,
                                                    device=dev))


def dfill(v, dims, procs=None, dist=None) -> DArray:
    """Distributed fill; the dtype follows ``v`` (a Python float fills
    float32, an int int32)."""
    val = as_tensor(v)
    return _fill_cells(_as_dims(dims), procs, dist,
                       lambda s, r, dev: torch.full(s, val.item(),
                                                    dtype=val.dtype,
                                                    device=dev))


def drand(dims, dtype=torch.float32, procs=None, dist=None) -> DArray:
    """Distributed uniform [0, 1), each chunk drawn on its own device from
    its rank's generator."""
    dtype = canon_dtype(dtype)
    return _fill_cells(_as_dims(dims), procs, dist,
                       lambda s, r, dev: torch.rand(s, generator=_gen(r),
                                                    dtype=dtype, device=dev))


def drandint(low, high, dims, dtype=torch.int32, procs=None,
             dist=None) -> DArray:
    """Distributed uniform integers in ``[low, high)``, drawn per rank like
    ``drand`` (JAX ``darray.py:1470``)."""
    dtype = canon_dtype(dtype)
    return _fill_cells(_as_dims(dims), procs, dist,
                       lambda s, r, dev: torch.randint(
                           int(low), int(high), s, generator=_gen(r),
                           dtype=dtype, device=dev))


def dsample(values, dims, procs=None, dist=None) -> DArray:
    """Distributed draws from the value set ``values``, drawn per rank
    like ``drand`` (JAX ``darray.py:1488``)."""
    vals = as_tensor(values).reshape(-1)
    if vals.numel() == 0:
        raise ValueError("dsample: empty value set")

    def make(s, r, dev):
        idx = torch.randint(0, vals.numel(), s, generator=_gen(r),
                            device=dev)
        return vals.to(dev)[idx]
    return _fill_cells(_as_dims(dims), procs, dist, make)


def drandn(dims, dtype=torch.float32, procs=None, dist=None) -> DArray:
    """Distributed standard normal, drawn per rank like ``drand``."""
    dtype = canon_dtype(dtype)
    return _fill_cells(_as_dims(dims), procs, dist,
                       lambda s, r, dev: torch.randn(s, generator=_gen(r),
                                                     dtype=dtype, device=dev))


@_tm.traced(name="distribute")
def distribute(A, procs=None, dist=None, like: DArray | None = None) -> DArray:
    """Distribute a host or device array: each rank receives a copy of its
    own chunk.  ``like`` takes another DArray's rank grid."""
    _tm.count("op.distribute")
    if isinstance(A, DArray):  # dalint: disable=DAL010 — A's type is the caller's, the same on every process (SubDArray.materialize gives every process the whole region)
        A = A.full()
    elif isinstance(A, SubDArray):
        A = A.materialize()
    t = as_tensor(A)
    if _tm.enabled():
        from .telemetry import perf as _perf
        # cost stamp on the traced distribute span: the payload through
        # HBM once (the h2d scatter)
        nb = _tm.nbytes_of(t)
        _tm.annotate(**_perf.transfer_cost(nb))
        _tm.record_comm("h2d", nb, op="device_put", shape=list(t.shape))
    if like is not None:
        procs, dist = [int(p) for p in like.pids.flat], list(like.grid)
    return from_global(t, procs, dist)


def darray(init: Callable, dims, procs=None, dist=None) -> DArray:
    """Build a DArray by calling ``init(index_ranges)`` once per chunk; every
    chunk must come back with the chunk's shape and one common dtype."""
    dims, pids, cuts = resolve_layout(_as_dims(dims), procs, dist)
    idxs = L.idxs_from_cuts(cuts, pids.shape)
    parts = np.empty(pids.shape, dtype=object)
    dtype = None
    for ci in np.ndindex(*pids.shape):
        p = as_tensor(init(idxs[ci]))
        want = tuple(len(r) for r in idxs[ci])
        if tuple(p.shape) != want:
            raise ValueError(
                f"init returned shape {tuple(p.shape)} for chunk {ci}, "
                f"expected {want}")
        if dtype is None:
            dtype = p.dtype
        elif p.dtype != dtype:
            raise TypeError(f"chunk dtypes differ: {dtype} vs {p.dtype}")
        parts[ci] = torch.empty(want, dtype=dtype, device=L.device_of(
            int(pids[ci]))).copy_(p)
    return DArray(parts, pids, cuts)


def darray_like(init: Callable, d: DArray) -> DArray:
    """``darray(init, ...)`` on ``d``'s layout (JAX ``darray.py:1323``)."""
    return darray(init, d.dims, [int(p) for p in d.pids.flat], list(d.grid))


def dfromfunction(f: Callable, dims, procs=None, dist=None,
                  compiled: bool = True) -> DArray:
    """A DArray of ``f`` over global indices, ``np.fromfunction``'s
    convention: ``f`` gets one index grid per dim (JAX
    ``darray.py:1329``).

    By default each rank builds only its own chunk's int32 grids, offset
    by the chunk's start, on its own device, and calls ``f`` on them with
    torch ops, so nothing is shipped from the host (JAX's compiled path).
    ``compiled=False`` evaluates ``f`` per chunk on numpy grids on the
    host, for an ``f`` that torch tensors cannot go through (JAX's eager
    path, which it also takes when ``f`` cannot be traced)."""
    dims = _as_dims(dims)
    if not compiled:
        return darray(
            lambda idx: np.fromfunction(
                lambda *gs: f(*[g + r.start for g, r in zip(gs, idx)]),
                tuple(len(r) for r in idx), dtype=int),
            dims, procs, dist)

    def make(shape, rank, dev, starts):
        axes = [torch.arange(s0, s0 + n, dtype=torch.int32, device=dev)
                for s0, n in zip(starts, shape)]
        r = f(*torch.meshgrid(*axes, indexing="ij")) if axes else f()
        r = as_tensor(r if isinstance(r, torch.Tensor)
                      else torch.as_tensor(r, device=dev))
        if tuple(r.shape) != shape:
            raise ValueError(f"f returned shape {tuple(r.shape)} for a "
                             f"chunk of shape {shape}")
        return r.to(dev)
    return _fill_cells(dims, procs, dist, make, starts=True)


def from_chunks(chunks, procs=None) -> DArray:
    """Assemble a DArray from an object grid of chunks (arrays or tensors),
    reconstructing the cuts from the chunk sizes; uneven and empty chunks
    are kept.  Chunks are copied to their ranks and promoted to one common
    dtype."""
    if isinstance(chunks, (list, tuple)):
        seq = list(chunks)
        chunks = np.empty(len(seq), dtype=object)
        for i, c in enumerate(seq):
            chunks[i] = c
    else:
        chunks = np.asarray(chunks, dtype=object)
    grid = chunks.shape
    procs = L.all_ranks() if procs is None else [int(p) for p in procs]
    n = int(np.prod(grid)) if grid else 1
    if n > len(procs):
        raise ValueError(f"layout {grid} needs {n} ranks, have {len(procs)}")
    pids = np.asarray(procs[:n], dtype=np.int64).reshape(grid)
    parts = np.empty(grid, dtype=object)
    for ci in np.ndindex(*grid):
        t = as_tensor(chunks[ci])
        parts[ci] = torch.empty(t.shape, dtype=t.dtype, device=L.device_of(
            int(pids[ci]))).copy_(t)
    return _assemble(parts, pids)


def _assemble(parts: np.ndarray, pids: np.ndarray) -> DArray:
    """A DArray of the object grid ``parts`` of tensors, each already on
    its rank's device and owned by no other DArray: the cuts come from
    the chunk sizes, and the chunks are promoted to one common dtype."""
    grid = parts.shape
    nd = parts.flat[0].ndim if parts.size else 0
    if len(grid) != nd:
        raise ValueError(
            f"chunk grid rank {len(grid)} must equal chunk ndim {nd}")
    cuts = []
    for d in range(nd):
        c = [0]
        for j in range(grid[d]):
            sel = [0] * len(grid)
            sel[d] = j
            c.append(c[-1] + int(parts[tuple(sel)].shape[d]))
        cuts.append(c)
    dtype = parts.flat[0].dtype
    for t in parts.flat:
        dtype = torch.promote_types(dtype, t.dtype)
    out = np.empty(grid, dtype=object)
    for ci in np.ndindex(*grid):
        out[ci] = parts[ci].to(dtype)
    return DArray(out, pids, cuts)


def darray_from_cuts(host, procs, cuts) -> DArray:
    """Distribute the whole array ``host`` (array or tensor) on the explicit
    cut layout ``cuts`` over the first ranks of ``procs`` (JAX
    ``darray.py:1412``)."""
    cuts = [[int(x) for x in c] for c in cuts]
    dims = tuple(c[-1] for c in cuts)
    t = as_tensor(host)
    if tuple(t.shape) != dims:
        raise ValueError(f"host shape {tuple(t.shape)} != cuts dims {dims}")
    grid = tuple(len(c) - 1 for c in cuts)
    n = int(np.prod(grid)) if grid else 1
    procs = [int(p) for p in procs]
    if len(procs) < n:
        raise ValueError(f"layout {grid} needs {n} ranks, got {len(procs)}")
    pids = np.asarray(procs[:n], dtype=np.int64).reshape(grid)
    return DArray(_scatter(t, pids, cuts), pids, cuts)


# ---------------------------------------------------------------------------
# DData: per-rank Python objects
# ---------------------------------------------------------------------------


class DData:
    """Arbitrary per-rank Python objects (JAX ``darray.py:1587``, the
    reference's ``ddata``).  Registered like a DArray and closed by
    ``d_closeall``; a tensor placed in it goes to its owner rank's
    device."""

    __slots__ = ("id", "pids", "_parts", "_closed", "__weakref__")

    def __init__(self, parts: dict, pids):
        self.id = core.next_did()
        self.pids = np.asarray(pids, dtype=np.int64)
        self._parts = {p: _placed(v, p) for p, v in parts.items()}
        self._closed = False
        core.register(self)
        weakref.finalize(self, _finalize, self.id)

    @property
    def dims(self):
        return (len(self.pids),)

    def localpart(self, pid: int | None = None):
        pid = current_rank() if pid is None else pid
        if pid not in self._parts:
            raise KeyError(f"rank {pid} holds no part of this ddata")
        return self._parts[pid]

    def set_localpart(self, v, pid: int | None = None) -> None:
        pid = current_rank() if pid is None else pid
        self._parts[pid] = _placed(v, pid)

    def gather(self) -> list:
        """Every part in pid order (JAX ``darray.py:1630``)."""
        return [self._parts[int(p)] for p in self.pids]

    def close(self):
        self._close()

    def _close(self, _unregister=True):
        self._closed = True
        self._parts = {}
        if _unregister:
            core.unregister(self.id)

    def __len__(self):
        return len(self.pids)

    def __repr__(self):
        return f"DData(id={self.id}, ranks={[int(p) for p in self.pids]})"


def _placed(v, pid: int):
    return v.to(L.device_of(pid)) if isinstance(v, torch.Tensor) else v


def ddata(*, init: Callable | None = None, pids=None,
          data=None) -> DData:
    """Per-rank values (JAX ``darray.py:1643``): ``init(i)`` for the
    ``i``-th rank, or ``data`` split evenly over the ranks (one item a
    rank is the item, several a list), or None."""
    pids = L.all_ranks() if pids is None else [int(p) for p in pids]
    parts = {}
    if data is not None:
        n = len(data)
        if n % len(pids) != 0:
            raise ValueError(f"data length {n} not divisible by {len(pids)} "
                             "ranks")
        per = n // len(pids)
        for i, p in enumerate(pids):
            chunk = data[i * per:(i + 1) * per]
            parts[p] = chunk[0] if per == 1 else list(chunk)
    else:
        for i, p in enumerate(pids):
            parts[p] = None if init is None else init(i)
    return DData(parts, pids)


# ---------------------------------------------------------------------------
# Module-level parity functions
# ---------------------------------------------------------------------------


def _shape_of(x) -> tuple:
    if isinstance(x, (DArray, SubDArray)):
        return tuple(x.shape)
    return tuple(x.shape) if isinstance(x, torch.Tensor) else np.shape(x)


def copyto_(dest, src):
    """Copy ``src`` into ``dest`` (a DArray or a SubDArray) in place (JAX
    ``darray.py:1711``): each owner rank writes its own tensor; a DArray
    ``src`` reaches ``dest``'s layout through ``relayout_parts``."""
    if isinstance(dest, SubDArray):
        if _shape_of(src) != tuple(dest.shape):
            raise ValueError(f"copyto_: src shape {_shape_of(src)} != view "
                             f"shape {tuple(dest.shape)}")
        dest.parent._check_open()
        dest.parent._write(dest.key, src)
        return dest
    if not isinstance(dest, DArray):
        raise TypeError("copyto_ expects a DArray or SubDArray destination")
    if _shape_of(src) != dest.dims:
        raise ValueError(f"copyto_: src shape {_shape_of(src)} != dest dims "
                         f"{dest.dims}")
    dest._check_open()
    if isinstance(src, DArray):
        from .parallel.reshard import relayout_parts
        pieces = relayout_parts(src, dest.pids, dest.cuts)
        for ci in dest.cells():
            # a placeholder of another process's cell copies nothing
            dest._parts[ci].copy_(pieces[ci])
        dest._relabel("rebind")
    else:
        dest._write(_normalize_key((), dest.dims), src, site="rebind")
    return dest


def dcat(dim: int, *ds) -> DArray:
    """Concatenate along ``dim`` onto the default layout over the first
    DArray's ranks (JAX ``darray.py:1739``), on that DArray's home device;
    the dtype promotes as ``jnp.concatenate``'s."""
    from .ops.broadcast import result_dtype
    first = next((x for x in ds if isinstance(x, DArray)), None)
    dev = first.home() if first is not None else L.device_of(0)
    dt = result_dtype(*ds)
    vals = [(x.full(dev) if isinstance(x, DArray) else x.materialize()
             if isinstance(x, SubDArray) else as_tensor(x)).to(dev, dt)
            for x in ds]
    procs = [int(p) for p in first.pids.flat] if first is not None else None
    return from_global(torch.cat(vals, dim), procs)


def dfetch(d, *i):
    """One element without the scalar guard (JAX ``darray.py:1751``, the
    reference's ``fetch(d, i)``), read from its owner: a 0-d tensor of a
    DArray or SubDArray, the part of a ``DData``."""
    if isinstance(d, DData):
        return d.gather()[i[0]]
    if isinstance(d, SubDArray):
        return d.materialize()[tuple(i)]
    d._check_open()
    return d._element(_normalize_key(tuple(int(k) for k in i), d.dims))


def isassigned(d, *i) -> bool:
    """True iff ``d[i...]`` is in bounds and holds a value (JAX
    ``darray.py:1757``): a bounds check for a DArray or SubDArray, and for
    a ``DData`` also that the rank's part exists."""
    if isinstance(d, DData):
        if len(i) != 1:
            return False
        k = int(i[0])
        return 0 <= k < len(d.pids) and int(d.pids[k]) in d._parts
    if isinstance(d, SubDArray):
        if len(i) != len(d.shape):
            return False
        try:
            return all(-n <= int(k) < n for k, n in zip(i, d.shape))
        except (TypeError, ValueError):
            return False
    if not isinstance(d, DArray):
        raise TypeError(f"isassigned expects a DArray/SubDArray/DData, got "
                        f"{type(d).__name__}")
    d._check_open()
    if len(i) != len(d.dims):
        return False
    try:
        _normalize_key(tuple(int(k) for k in i), d.dims)
    except IndexError:
        return False
    return True


def localpart(d, pid: int | None = None):
    """Chunk of ``d`` owned by ``pid`` (default: the calling rank); a plain
    array is its own localpart."""
    if isinstance(d, (DArray, DData)):
        return d.localpart(pid)
    if isinstance(d, SubDArray):
        return d.materialize()
    return d


def localindices(d, pid: int | None = None):
    if isinstance(d, DArray):
        return d.localindices(pid)
    return tuple(range(0, s) for s in np.shape(d))


def locate(d: DArray, *I):
    return d.locate(*I)


def makelocal(d, *I):
    if isinstance(d, DArray):
        return d.makelocal(*I)
    t = as_tensor(d)
    return t[tuple(I)] if I else t


def gather(d):
    """Gather a DArray or SubDArray to the controller as a numpy array
    (bfloat16 comes back as float32: numpy has no bfloat16), a ``DData``
    as the list of its parts in pid order."""
    if isinstance(d, DData):
        return d.gather()
    if isinstance(d, (DArray, SubDArray)):
        return np.asarray(d)
    return d
