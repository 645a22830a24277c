"""Collectives over rank tensors, written in plain torch: the static half
of SPMD mode.

PyTorch counterpart of ``distributedarrays_tpu/parallel/collectives.py``
(``spmd_mesh``, ``run_spmd``, ``axis_rank``, ``axis_size``, ``pshift``,
``halo_exchange``, ``halo_exchange_2d``, ``pbarrier``, ``pbcast``,
``pgather``, ``preduce``, ``pall_to_all``), and of ``lax.psum_scatter`` as
``psum_scatter``.  There each is a ``lax`` collective inside a
``shard_map``; here the controller holds every rank's tensor, so a
collective takes the list of the ranks' tensors in ring order (one per
``axis_index``; a list of rows for a 2-D mesh) and returns a list, each
result on its rank's device, moved with ``.to(device)`` copies.  These are
the plain versions that the hand-written collective kernels
(``ops/cuda_collectives``) are held against, and the steps the plain ring
schedules are written with.  Only the tiled forms exist: ``pgather`` and
``pall_to_all`` concatenate, as ``tiled=True`` does in JAX.

``run_spmd`` is how a JAX ``shard_map`` program maps onto this form: the
program's per-rank body, whose collectives name a mesh axis, becomes one
function over the lists of all ranks' blocks, whose collectives take those
lists (see its docstring).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from .. import layout as L
from ..darray import DArray

__all__ = ["spmd_mesh", "run_spmd", "axis_rank", "axis_size",
           "halo_exchange", "halo_exchange_2d", "pshift", "pbarrier",
           "pbcast", "pgather", "preduce", "pall_to_all", "psum_scatter"]


def spmd_mesh(n: int | None = None) -> list[int]:
    """The first ``n`` ranks (default: all), the 1-D mesh of a
    ``run_spmd`` program (JAX ``collectives.py:84``)."""
    n = L.nranks() if n is None else int(n)
    if not 1 <= n <= L.nranks():
        raise ValueError(f"a mesh of {n} ranks; the table has "
                         f"{L.nranks()}")
    return list(range(n))


def _nested_map(fn, ranks, *trees):
    """``fn(rank, *leaves)`` over the nesting of ``ranks`` (a list, or a
    list of rows), returning the same nesting."""
    if isinstance(ranks, (list, tuple)):
        return [_nested_map(fn, r, *(t[k] for t in trees))
                for k, r in enumerate(ranks)]
    return fn(int(ranks), *trees)


def run_spmd(f: Callable, ranks, *args):
    """Run the SPMD program ``f`` once over the ranks ``ranks`` (JAX
    ``collectives.py:91``, ``jit`` of a ``shard_map`` over a mesh).

    JAX's ``f`` is one rank's body: it sees its own shard, and a
    collective names a mesh axis.  Here ``f`` is the body of all ranks at
    once: ``ranks`` is the mesh (a list of ranks, or a list of rows of
    ranks for a 2-D mesh, as ``spmd_mesh`` or a DArray's ``pids.tolist()``
    gives), each argument is the ranks' blocks in the same nesting (JAX's
    ``in_specs`` split the global array into them), and each collective
    takes the list of blocks along its axis: a row or column of a 2-D
    mesh for ``halo_exchange``, the whole grid for ``halo_exchange_2d``.
    A DArray argument passes its cells in the order of its ``pids``, which
    must equal ``ranks``; any other argument's blocks are moved to their
    rank's device.  ``f``'s return value (the counterpart of JAX's
    ``out_specs``, one block per rank) is returned as it is."""
    grid = np.asarray(ranks, dtype=np.int64)
    conv = []
    for a in args:
        if isinstance(a, DArray):
            if not np.array_equal(a.pids, grid):
                raise ValueError(f"a DArray on ranks {a.pids.tolist()} "
                                 f"passed to a program on {grid.tolist()}")
            cells = np.empty(grid.shape, dtype=object)
            for ci in np.ndindex(*grid.shape):
                cells[ci] = a.part(ci)
            conv.append(cells.tolist())
        else:
            conv.append(_nested_map(
                lambda r, b: torch.as_tensor(b).to(L.device_of(r)),
                ranks, a))
    return f(*conv)


def axis_size(blocks, axis: int = 0) -> int:
    """The number of ranks along ``axis`` of the mesh of ``blocks`` (a
    list, or a list of rows; JAX ``collectives.py:113``)."""
    return len(blocks) if axis == 0 else len(blocks[0])


def axis_rank(blocks, axis: int = 0):
    """Each rank's index along ``axis``, in the nesting of ``blocks``
    (JAX ``collectives.py:108``, ``lax.axis_index``)."""
    if not blocks or not isinstance(blocks[0], (list, tuple)):
        if axis:
            raise ValueError("a 1-D mesh has only axis 0")
        return list(range(len(blocks)))
    return [[(a, b)[axis] for b in range(len(row))]
            for a, row in enumerate(blocks)]


def halo_exchange(blocks: Sequence[torch.Tensor], halo: int = 1, dim: int = 0,
                  wrap: bool = False) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """``(lo, hi)`` for every rank of a 1-D rank ring: ``lo`` is the last
    ``halo`` slabs (along ``dim``) of the previous rank's block, ``hi`` the
    first ``halo`` slabs of the next rank's block, each on the receiving
    rank's device.  With ``wrap=False`` the outer edges receive zeros."""
    n = len(blocks)
    out = []
    for r, b in enumerate(blocks):
        def slab(src: torch.Tensor, first: bool) -> torch.Tensor:
            size = src.shape[dim]
            if halo > size:
                raise ValueError(
                    f"halo {halo} exceeds the neighbour's extent {size}")
            s = src.narrow(dim, 0 if first else size - halo, halo)
            return s.to(b.device).contiguous()

        shape = list(b.shape)
        shape[dim] = halo
        if r > 0 or wrap:
            lo = slab(blocks[(r - 1) % n], first=False)
        else:
            lo = torch.zeros(shape, dtype=b.dtype, device=b.device)
        if r < n - 1 or wrap:
            hi = slab(blocks[(r + 1) % n], first=True)
        else:
            hi = torch.zeros(shape, dtype=b.dtype, device=b.device)
        out.append((lo, hi))
    return out


def halo_exchange_2d(blocks_2d, halo: int = 1,
                     wrap: bool = False) -> list[list[torch.Tensor]]:
    """Every rank's block of a 2-D mesh (``blocks_2d[a][b]``, each (m, n))
    padded with its neighbours' boundaries to (m + 2h, n + 2h), zeros at
    the global edge unless ``wrap`` (JAX ``collectives.py:161``).  Two
    phases: rows along mesh axis 0 (each column of the grid), then columns
    of the row-extended blocks along mesh axis 1 (each row), so that the
    corners arrive."""
    g0, g1 = len(blocks_2d), len(blocks_2d[0])
    ext = [[None] * g1 for _ in range(g0)]
    for b in range(g1):
        col = [blocks_2d[a][b] for a in range(g0)]
        for a, (x, (lo, hi)) in enumerate(zip(col, halo_exchange(
                col, halo=halo, dim=0, wrap=wrap))):
            ext[a][b] = torch.cat([lo, x, hi], dim=0)
    out = [[None] * g1 for _ in range(g0)]
    for a in range(g0):
        for b, (x, (lo, hi)) in enumerate(zip(ext[a], halo_exchange(
                ext[a], halo=halo, dim=1, wrap=wrap))):
            out[a][b] = torch.cat([lo, x, hi], dim=1)
    return out


def pbarrier(blocks) -> list[torch.Tensor]:
    """A synchronization point (JAX ``collectives.py:181``, a psum of 1):
    waits for the work queued on every rank's CUDA device and returns the
    rank count as an int32 scalar on each rank's device, in the nesting of
    ``blocks``."""
    nested = bool(blocks) and isinstance(blocks[0], (list, tuple))
    flat = [b for row in blocks for b in row] if nested else list(blocks)
    for dev in {b.device for b in flat if b.device.type == "cuda"}:
        torch.cuda.synchronize(dev)

    def count(b):
        return torch.tensor(len(flat), dtype=torch.int32, device=b.device)

    if nested:
        return [[count(b) for b in row] for row in blocks]
    return [count(b) for b in blocks]


def pbcast(blocks: Sequence[torch.Tensor],
           root: int = 0) -> list[torch.Tensor]:
    """Every rank gets a copy of rank ``root``'s block on its own device
    (JAX ``collectives.py:189``)."""
    if not 0 <= root < len(blocks):
        raise ValueError(f"root {root} is not one of the {len(blocks)} "
                         "ranks")
    return [blocks[root].to(b.device, copy=True) for b in blocks]


def pshift(blocks: Sequence[torch.Tensor], shift: int = 1,
           wrap: bool = True) -> list[torch.Tensor]:
    """Ring shift: rank ``i`` receives rank ``i - shift``'s block on its own
    device.  With ``wrap=False`` ranks with no sender receive zeros."""
    n = len(blocks)
    out = []
    for i, b in enumerate(blocks):
        j = i - shift
        if wrap or 0 <= j < n:
            out.append(blocks[j % n].to(b.device))
        else:
            out.append(torch.zeros_like(b))
    return out


def pgather(blocks: Sequence[torch.Tensor], dim: int = 0) -> list[torch.Tensor]:
    """Every rank gets all blocks concatenated along ``dim`` in rank order,
    on its own device."""
    return [torch.cat([x.to(b.device) for x in blocks], dim) for b in blocks]


_FOLDS = {"sum": torch.add, "mean": torch.add, "max": torch.maximum,
          "min": torch.minimum}


def preduce(blocks: Sequence[torch.Tensor],
            op: str = "sum") -> list[torch.Tensor]:
    """All-reduce (``lax.psum``/``pmax``/``pmin``/``pmean``): the ranks'
    blocks folded in rank order on rank 0's device (``mean`` divides the
    sum by the rank count), the one result copied to every rank's device,
    so every rank holds the same bits."""
    if op not in _FOLDS:
        raise ValueError(f"unknown reduction {op!r}: use one of "
                         f"{sorted(_FOLDS)}")
    acc = blocks[0]
    for b in blocks[1:]:
        acc = _FOLDS[op](acc, b.to(acc.device))
    if op == "mean":
        acc = acc / len(blocks)
    return [acc.to(b.device, copy=True) for b in blocks]


def pall_to_all(blocks: Sequence[torch.Tensor], split_dim: int,
                concat_dim: int) -> list[torch.Tensor]:
    """All-to-all: rank ``r``'s block splits along ``split_dim`` into one
    piece per rank; rank ``q`` gets piece ``q`` of every rank, concatenated
    along ``concat_dim`` in rank order, on its own device."""
    p = len(blocks)
    for b in blocks:
        if b.shape[split_dim] % p:
            raise ValueError(f"split extent {b.shape[split_dim]} is not "
                             f"divisible by the {p} ranks")
    pieces = [b.tensor_split(p, split_dim) for b in blocks]
    return [torch.cat([pieces[r][q].to(b.device) for r in range(p)],
                      concat_dim) for q, b in enumerate(blocks)]


def psum_scatter(blocks: Sequence[torch.Tensor],
                 dim: int = 0) -> list[torch.Tensor]:
    """Reduce-scatter (``lax.psum_scatter(..., tiled=True)``): every rank's
    block splits along ``dim`` into one piece per rank, and rank ``d`` gets
    the sum of every rank's piece ``d`` on its own device.  The sum is the
    TPU ring's arrival order: the left fold over ranks d+1, d+2, ..., d+p
    (mod p), each add rounded to the blocks' type."""
    p = len(blocks)
    for b in blocks:
        if b.shape[dim] % p:
            raise ValueError(f"scatter extent {b.shape[dim]} is not "
                             f"divisible by the {p} ranks")
    pieces = [b.tensor_split(p, dim) for b in blocks]
    out = []
    for d, b in enumerate(blocks):
        acc = pieces[(d + 1) % p][d].to(b.device, copy=True)
        for k in range(2, p + 1):
            acc = acc + pieces[(d + k) % p][d].to(b.device)
        out.append(acc.contiguous())
    return out
