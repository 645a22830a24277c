"""The DArray: a global-view distributed array made of per-rank tensors.

PyTorch counterpart of ``distributedarrays_tpu/darray.py``, restricted to
the constructors, layout queries, ``gather`` and the scalar guard.

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
"""

from __future__ import annotations

import itertools
import weakref
from typing import Callable, Sequence

import numpy as np
import torch

from . import core
from . import layout as L
from .core import allowscalar, _scalar_indexing_allowed

__all__ = [
    "DArray",
    "SubDArray",
    "darray",
    "from_chunks",
    "dzeros",
    "dones",
    "dfill",
    "drand",
    "drandn",
    "distribute",
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
           torch.complex128: torch.complex64}


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


def _gen(rank: int) -> torch.Generator:
    dev = L.device_of(rank)
    g = _gens.get(rank)
    if g is None or g.device != dev:
        s = int(np.random.SeedSequence([_seed, rank]).generate_state(1)[0])
        g = torch.Generator(device=dev).manual_seed(s)
        _gens[rank] = g
    return g


# ---------------------------------------------------------------------------
# DArray
# ---------------------------------------------------------------------------


def _finalize(did):
    core.unregister(did)


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
        """The tensor of grid cell ``ci``."""
        self._check_open()
        return self._parts[tuple(ci)]

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
        return hash(self.id)

    def __array__(self, dtype=None, copy=None):
        a = _to_numpy(self.region(None, torch.device("cpu")))
        return a if dtype is None else a.astype(dtype, copy=False)

    # -- lifecycle ---------------------------------------------------------

    def _check_open(self):
        if self._closed:
            raise RuntimeError(f"DArray {self.id} is closed")

    def _close(self, _unregister=True):
        if not self._closed:
            self._closed = True
            self._parts = None
            if _unregister:
                core.unregister(self.id)

    def close(self):
        """Release the rank tensors now."""
        self._close()

    # -- layout queries ----------------------------------------------------

    def localpartindex(self, pid: int = 0) -> tuple | None:
        """Grid coordinates of the chunk owned by ``pid``; None if ``pid``
        holds none."""
        hits = np.argwhere(self.pids == pid)
        if hits.size == 0:
            return None
        return tuple(int(x) for x in hits[0])

    def localindices(self, pid: int = 0) -> tuple:
        """Global index ranges of rank ``pid``'s chunk."""
        ci = self.localpartindex(pid)
        if ci is None:
            return tuple(range(0, 0) for _ in self.dims)
        return self.indices[ci]

    def localpart(self, pid: int = 0) -> torch.Tensor:
        """Rank ``pid``'s chunk (the stored tensor itself, no copy); an empty
        tensor when ``pid`` holds none."""
        self._check_open()
        ci = self.localpartindex(pid)
        if ci is None:
            return torch.empty((0,) * max(self.ndim, 1), dtype=self.dtype)
        return self._parts[ci]

    def locate(self, *I: int) -> tuple:
        """Chunk-grid coordinates owning global index ``I``."""
        return L.locate(self.cuts, *I)

    def home(self) -> torch.device:
        """Device of the first rank in the grid: where whole-array results
        (reductions, gathered regions) are placed."""
        return L.device_of(int(self.pids.flat[0]))

    # -- data movement -----------------------------------------------------

    def region(self, bounds, device) -> torch.Tensor:
        """A new tensor on ``device`` holding the global region ``bounds``
        (one ``(lo, hi)`` per dim; None for the whole array), copied from
        the chunks that intersect it."""
        self._check_open()
        if bounds is None:
            bounds = [(0, n) for n in self.dims]
        out = torch.empty([h - l for l, h in bounds], dtype=self.dtype,
                          device=device)
        if out.numel() == 0:
            return out
        per_dim = []
        for c, (lo, hi) in zip(self.cuts, bounds):
            per_dim.append([(j, max(c[j], lo), min(c[j + 1], hi))
                            for j in range(len(c) - 1)
                            if max(c[j], lo) < min(c[j + 1], hi)])
        for combo in itertools.product(*per_dim):
            ci = tuple(j for j, _, _ in combo)
            src = tuple(slice(a - self.cuts[d][j], b - self.cuts[d][j])
                        for d, (j, a, b) in enumerate(combo))
            dst = tuple(slice(a - bounds[d][0], b - bounds[d][0])
                        for d, (_, a, b) in enumerate(combo))
            out[dst] = self._parts[ci][src].to(device)
        return out

    def full(self, device=None) -> torch.Tensor:
        """The whole array as one tensor on ``device`` (default: ``home``)."""
        return self.region(None, self.home() if device is None else device)

    def with_parts(self, parts: np.ndarray) -> "DArray":
        """New DArray with this layout and the given cell tensors."""
        return DArray(parts, self.pids.copy(), self.cuts)

    # -- indexing ----------------------------------------------------------

    def __getitem__(self, key):
        self._check_open()
        key = _normalize_key(key, self.dims)
        if all(isinstance(k, int) for k in key):
            _scalar_indexing_allowed()
            ci = self.locate(*key)
            local = tuple(k - r.start for k, r in zip(key, self.indices[ci]))
            return self._parts[ci][local]
        return SubDArray(self, key)

    def makelocal(self, *I) -> torch.Tensor:
        """The region ``I`` as one dense tensor on ``home()``."""
        self._check_open()
        if not I:
            return self.full()
        key = _normalize_key(tuple(I) if len(I) > 1 else I[0], self.dims)
        key = tuple(slice(k, k + 1) if isinstance(k, int) else k for k in key)
        return SubDArray(self, key).materialize()

    # -- conveniences ------------------------------------------------------

    def copy(self) -> "DArray":
        """Independent copy with the same layout."""
        parts = np.empty(self.grid, dtype=object)
        for ci in self.cells():
            parts[ci] = self.part(ci).clone()
        return self.with_parts(parts)


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    x = x.detach().cpu()
    # numpy has no bfloat16: it comes back as float32
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


# ---------------------------------------------------------------------------
# SubDArray: a lazy view
# ---------------------------------------------------------------------------


class SubDArray:
    """A lazy view of a region of a DArray; ``materialize()`` copies the
    region out of the chunks that hold it."""

    __slots__ = ("parent", "key")

    def __init__(self, parent: DArray, key: tuple):
        self.parent = parent
        self.key = key

    @property
    def shape(self):
        return tuple(len(range(*k.indices(n)))
                     for k, n in zip(self.key, self.parent.dims)
                     if isinstance(k, slice))

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

    def __repr__(self):
        return (f"SubDArray(parent={self.parent.id}, key={self.key}, "
                f"shape={self.shape})")


def _normalize_key(key, dims):
    if not isinstance(key, tuple):
        key = (key,)
    if any(k is Ellipsis for k in key):
        i = key.index(Ellipsis)
        key = key[:i] + (slice(None),) * (len(dims) - len(key) + 1) + key[i + 1:]
    if len(key) < len(dims):
        key = key + (slice(None),) * (len(dims) - len(key))
    if len(key) > len(dims):
        raise IndexError(f"too many indices for {len(dims)}-d DArray")
    out = []
    for d, k in enumerate(key):
        n = dims[d]
        if isinstance(k, (int, np.integer)):
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
        elif isinstance(k, range):
            out.append(slice(k.start, k.stop, k.step))
        else:
            raise TypeError(f"unsupported DArray index {k!r}: use ints and "
                            "slices")
    return tuple(out)


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
    fresh contiguous tensor per chunk, never a view of ``t``)."""
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


def _fill_cells(dims, procs, dist, make: Callable) -> DArray:
    dims, pids, cuts = resolve_layout(dims, procs, dist)
    grid = tuple(pids.shape)
    parts = np.empty(grid, dtype=object)
    for ci in np.ndindex(*grid):
        shape = tuple(c[j + 1] - c[j] for c, j in zip(cuts, ci))
        rank = int(pids[ci])
        parts[ci] = make(shape, rank, L.device_of(rank))
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


def drandn(dims, dtype=torch.float32, procs=None, dist=None) -> DArray:
    """Distributed standard normal, drawn per rank like ``drand``."""
    dtype = canon_dtype(dtype)
    return _fill_cells(_as_dims(dims), procs, dist,
                       lambda s, r, dev: torch.randn(s, generator=_gen(r),
                                                     dtype=dtype, device=dev))


def distribute(A, procs=None, dist=None, like: DArray | None = None) -> DArray:
    """Distribute a host or device array: each rank receives a copy of its
    own chunk.  ``like`` takes another DArray's rank grid."""
    if isinstance(A, DArray):
        A = A.full()
    elif isinstance(A, SubDArray):
        A = A.materialize()
    t = as_tensor(A)
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


def from_chunks(chunks, procs=None) -> DArray:
    """Assemble a DArray from an object grid of chunks (arrays or tensors),
    reconstructing the cuts from the chunk sizes; uneven and empty chunks
    are kept.  Chunks are promoted to one common dtype."""
    if isinstance(chunks, (list, tuple)):
        seq = list(chunks)
        chunks = np.empty(len(seq), dtype=object)
        for i, c in enumerate(seq):
            chunks[i] = c
    else:
        chunks = np.asarray(chunks, dtype=object)
    grid = chunks.shape
    tens = np.empty(grid, dtype=object)
    for ci in np.ndindex(*grid):
        tens[ci] = as_tensor(chunks[ci])
    nd = tens.flat[0].ndim if tens.size else 0
    if len(grid) != nd:
        raise ValueError(
            f"chunk grid rank {len(grid)} must equal chunk ndim {nd}")
    cuts = []
    for d in range(nd):
        c = [0]
        for j in range(grid[d]):
            sel = [0] * len(grid)
            sel[d] = j
            c.append(c[-1] + int(tens[tuple(sel)].shape[d]))
        cuts.append(c)
    procs = L.all_ranks() if procs is None else [int(p) for p in procs]
    n = int(np.prod(grid)) if grid else 1
    if n > len(procs):
        raise ValueError(f"layout {grid} needs {n} ranks, have {len(procs)}")
    pids = np.asarray(procs[:n], dtype=np.int64).reshape(grid)
    dtype = tens.flat[0].dtype
    for t in tens.flat:
        dtype = torch.promote_types(dtype, t.dtype)
    parts = np.empty(grid, dtype=object)
    for ci in np.ndindex(*grid):
        t = tens[ci]
        parts[ci] = torch.empty(t.shape, dtype=dtype, device=L.device_of(
            int(pids[ci]))).copy_(t)
    return DArray(parts, pids, cuts)


# ---------------------------------------------------------------------------
# Module-level parity functions
# ---------------------------------------------------------------------------


def localpart(d, pid: int = 0):
    """Chunk of ``d`` owned by ``pid``; a plain array is its own localpart."""
    if isinstance(d, DArray):
        return d.localpart(pid)
    if isinstance(d, SubDArray):
        return d.materialize()
    return d


def localindices(d, pid: int = 0):
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
    (bfloat16 comes back as float32: numpy has no bfloat16)."""
    if isinstance(d, (DArray, SubDArray)):
        return np.asarray(d)
    return d
