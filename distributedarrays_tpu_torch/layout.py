"""Block-layout math and the rank table.

PyTorch counterpart of ``distributedarrays_tpu/layout.py``.  The layout
algebra (``defaultdist``, ``chunk_idxs``, ``locate``, ``cut_intersections``,
...) is the same 0-based port of the reference's layout machinery, copied
here so the package stands on its own.

Where the JAX package maps a chunk grid onto a ``jax.sharding.Mesh`` over
``jax.devices()``, this package keeps a *rank table*: logical rank ``r``
lives on ``torch.device`` ``device_of(r)``.  ``init()`` builds it:

- ``init()`` maps one rank to each visible CUDA device (one H100 gives one
  rank, as JAX sees one device on one chip);
- ``init(nranks=4)`` puts four ranks round-robin on the visible CUDA
  devices (all four on the one card of a single-GPU host);
- ``init(nranks=8, device="cpu")`` is what the CPU tests use, mirroring the
  8 virtual XLA devices of the JAX test harness.

Entry points that need the table build the default one on first use; with
no CUDA device that raises instead of carrying on quietly on the CPU.

**Several controller processes.**  After ``parallel.multihost.initialize``
joins a job of several processes, every process calls ``init`` (the same
program on every process) and ``nranks``/``device`` describe its own
ranks.  The call is collective: the processes publish their local rank
counts through the job's store and build one *global* table, whose rank
ids run in process order, as ``jax.devices()`` orders a multi-controller
job's devices (process 0's ranks first).  A rank of another process maps
to the ``meta`` device here: a DArray's cell on such a rank is a
placeholder that knows its shape and dtype and holds no data.
``local_ranks()``, ``process_of(rank)`` and the process-independent
``spans_processes(pids)`` (JAX ``darray.py:1180`` ``_spans_processes``)
answer where data lives; every branch that leads to a collective must be
taken the same way by every process, so such branches test
``process_count()`` or ``spans_processes``, never what this process
happens to hold.  A single-process table behaves exactly as before.
"""

from __future__ import annotations

import itertools
from typing import Sequence

import numpy as np
import torch

__all__ = [
    "init",
    "nranks",
    "all_ranks",
    "device_of",
    "local_ranks",
    "local_device",
    "is_local",
    "process_of",
    "process_index",
    "process_count",
    "spans_processes",
    "defaultdist",
    "defaultdist_1d",
    "chunk_idxs",
    "locate",
    "prime_factors",
    "cut_intersections",
    "chunk_span",
    "even_cuts",
    "box_pieces",
]


# ---------------------------------------------------------------------------
# Rank table
# ---------------------------------------------------------------------------

_table: tuple[torch.device, ...] | None = None
# the controller process of each rank, and this process's index
_owner: tuple[int, ...] | None = None
_me = 0
# set by parallel.multihost.initialize in a job of several processes: a
# collective that takes this process's local devices and returns
# ``(global devices, owner of each rank, this process's index)``
_exchange = None


def init(nranks: int | None = None, device=None) -> tuple[torch.device, ...]:
    """Build the rank table and return it (rank ``r`` -> ``torch.device``).

    ``device=None`` uses the visible CUDA devices, round-robin, one rank per
    device by default; it raises ``RuntimeError`` when no CUDA device is
    present.  ``device="cpu"`` (or any explicit device) puts every rank on
    that device, one rank by default.  When the ranks span several cards,
    every card is given access to every other's memory (the collective
    kernels read and write peer ranks' tensors).

    In a job of several controller processes (``multihost.initialize``)
    the arguments describe this process's ranks, every process must call
    ``init``, and the returned table is the global one, a rank of another
    process on the ``meta`` device."""
    global _table, _owner, _me
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; call init(device='cpu') to run "
                "the ranks on the CPU")
        ndev = torch.cuda.device_count()
        n = ndev if nranks is None else int(nranks)
        devs = tuple(torch.device("cuda", r % ndev) for r in range(n))
        used = sorted({d.index for d in devs})
        if len(used) > 1:
            from .utils import kbuild
            for a in used:
                for b in used:
                    kbuild.enable_peer_access(a, b)
    else:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", 0)
        n = 1 if nranks is None else int(nranks)
        devs = (dev,) * n
    if n < 1:
        raise ValueError(f"need at least one rank, got {n}")
    if _exchange is not None:
        devs, owner, me = _exchange(devs)
    else:
        owner, me = (0,) * len(devs), 0
    _table, _owner, _me = tuple(devs), tuple(owner), me
    _journal_platform(devs[owner.index(me)] if me in owner else devs[0])
    return _table


def _journal_platform(dev: torch.device) -> None:
    """Journal the device kind the ranks run on (``device``/``platform``:
    ``torch.cuda.get_device_name()`` or ``cpu``), the platform the
    roofline doctor reads its peaks by (``telemetry.perf``), once a
    journal while one is configured."""
    from .telemetry import core as _tmc
    if _tmc.journal_path() is None:
        return
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else dev.type
    _tmc.event("device", "platform", platform=kind,
               once_key=f"device.platform:{kind}")


def _ranks() -> tuple[torch.device, ...]:
    return _table if _table is not None else init()


def _owners() -> tuple[int, ...]:
    _ranks()
    return _owner


def nranks() -> int:
    """Number of ranks in the table (reference: ``nworkers()``)."""
    return len(_ranks())


def all_ranks() -> list[int]:
    """All ranks (reference: ``workers()``)."""
    return list(range(len(_ranks())))


def device_of(rank: int) -> torch.device:
    """The ``torch.device`` that holds rank ``rank``'s tensors."""
    devs = _ranks()
    if not 0 <= int(rank) < len(devs):
        raise ValueError(
            f"rank id {rank} out of range: only {len(devs)} ranks in the "
            "table")
    return devs[int(rank)]


def process_index() -> int:
    """This controller process's index (0 in a single-process job)."""
    _ranks()
    return _me


def process_count() -> int:
    """The number of controller processes whose ranks the table holds."""
    return max(_owners()) + 1


def process_of(rank: int) -> int:
    """The controller process that holds rank ``rank``'s tensors."""
    device_of(rank)                      # validates the rank id
    return _owners()[int(rank)]


def is_local(rank: int) -> bool:
    """True when this process holds rank ``rank``'s tensors."""
    return process_of(rank) == process_index()


def local_ranks() -> list[int]:
    """The ranks this process holds, ascending."""
    me = process_index()
    return [r for r, p in enumerate(_owners()) if p == me]


def local_device() -> torch.device:
    """The device of this process's first rank: where a process places a
    whole-array result that every process holds (a gathered array, a
    reduction of a process-spanning DArray)."""
    return device_of(local_ranks()[0])


def spans_processes(pids) -> bool:
    """True when the ranks ``pids`` belong to more than one controller
    process.  The same answer on every process (JAX ``darray.py:1180``):
    a branch into a collective may test it."""
    own = _owners()
    return len({own[int(p)] for p in np.asarray(pids).flat}) > 1


# ---------------------------------------------------------------------------
# Layout algebra (same results as the JAX package, exactly)
# ---------------------------------------------------------------------------


def prime_factors(n: int) -> list[int]:
    """Prime factorization of ``n`` (ascending, with multiplicity)."""
    if n < 1:
        raise ValueError(f"cannot factorize {n}")
    out: list[int] = []
    d = 2
    while d * d <= n:
        while n % d == 0:
            out.append(d)
            n //= d
        d += 1
    if n > 1:
        out.append(n)
    return out


def defaultdist(dims: Sequence[int], pids: Sequence[int]) -> list[int]:
    """Chunks per dimension: the largest prime factors of the rank count go
    greedily to the dimensions with the most remaining extent; a factor
    that fits no dimension is dropped (those ranks stay unused)."""
    dims = list(dims)
    chunks = [1] * len(dims)
    if len(pids) == 0:
        raise ValueError("no processes")
    if len(dims) == 0:
        return chunks
    remaining = list(dims)
    for fac in sorted(prime_factors(len(pids)), reverse=True):
        order = sorted(range(len(dims)), key=lambda i: remaining[i],
                       reverse=True)
        for i in order:
            if remaining[i] >= fac:
                remaining[i] //= fac
                chunks[i] *= fac
                break
    return chunks


def defaultdist_1d(sz: int, nc: int) -> list[int]:
    """0-based cut points splitting ``sz`` into ``nc`` chunks, remainder on
    the leading chunks (``defaultdist_1d(50, 4) == [0, 13, 26, 38, 50]``).
    With ``sz < nc`` the first ``sz`` chunks hold one element each."""
    if nc <= 0:
        raise ValueError(f"need at least one chunk, got {nc}")
    if sz >= nc:
        base, rem = divmod(sz, nc)
        cuts = [0]
        for i in range(nc):
            cuts.append(cuts[-1] + base + (1 if i < rem else 0))
        return cuts
    return [min(i, sz) for i in range(nc + 1)]


def chunk_idxs(dims: Sequence[int], chunks: Sequence[int]):
    """``(idxs, cuts)``: ``cuts[d]`` is dimension ``d``'s cut vector and
    ``idxs`` an object ndarray of shape ``chunks`` whose entries are the
    tuples of ``range`` objects addressing each chunk."""
    dims = tuple(dims)
    chunks = tuple(chunks)
    if len(dims) != len(chunks):
        raise ValueError(f"dims {dims} and chunks {chunks} rank mismatch")
    cuts = [defaultdist_1d(d, c) for d, c in zip(dims, chunks)]
    return idxs_from_cuts(cuts, chunks), cuts


def idxs_from_cuts(cuts, grid) -> np.ndarray:
    """Object grid of per-chunk global index-range tuples from cut vectors."""
    idxs = np.empty(tuple(grid), dtype=object)
    for ci in np.ndindex(*grid):
        idxs[ci] = tuple(range(cuts[d][ci[d]], cuts[d][ci[d] + 1])
                         for d in range(len(cuts)))
    return idxs


def locate(cuts: Sequence[Sequence[int]], *I: int) -> tuple[int, ...]:
    """Chunk-grid coordinates of global index ``I`` (0-based)."""
    out = []
    for d, i in enumerate(I):
        c = cuts[d]
        if i < 0 or i >= c[-1]:
            raise IndexError(
                f"index {i} out of bounds for dim {d} (size {c[-1]})")
        j = int(np.searchsorted(np.asarray(c), i, side="right")) - 1
        while c[j + 1] == c[j]:  # land past empty chunks
            j += 1
        out.append(j)
    return tuple(out)


def cut_intersections(a_cuts: Sequence[int],
                      b_cuts: Sequence[int]) -> list[tuple[int, int, int, int]]:
    """``[(ai, bi, lo, hi), ...]``: the interval ``[lo, hi)`` lies in chunk
    ``ai`` of ``a_cuts`` and chunk ``bi`` of ``b_cuts``; empty chunks give
    no entries.  The 1-D kernel of the chunk-intersection transfer plan."""
    if a_cuts[-1] != b_cuts[-1]:
        raise ValueError(
            f"cut vectors cover different extents: {a_cuts[-1]} vs "
            f"{b_cuts[-1]}")
    out: list[tuple[int, int, int, int]] = []
    ai = bi = 0
    na, nb = len(a_cuts) - 1, len(b_cuts) - 1
    while ai < na and bi < nb:
        lo = max(a_cuts[ai], b_cuts[bi])
        hi = min(a_cuts[ai + 1], b_cuts[bi + 1])
        if lo < hi:
            out.append((ai, bi, int(lo), int(hi)))
        ae, be = a_cuts[ai + 1], b_cuts[bi + 1]
        if ae <= be:
            ai += 1
        if be <= ae:
            bi += 1
    return out


def chunk_span(cuts: Sequence[int], lo: int, hi: int) -> tuple[int, int]:
    """``(first, last)`` (inclusive) non-empty chunks of ``cuts`` meeting
    ``[lo, hi)``; ``(0, -1)`` for an empty interval."""
    if hi <= lo:
        return (0, -1)
    return (locate([cuts], lo)[0], locate([cuts], hi - 1)[0])


def box_pieces(cuts: Sequence[Sequence[int]], bounds) -> list[tuple]:
    """The chunks of the layout ``cuts`` that meet the global box
    ``bounds`` (one ``(lo, hi)`` a dim), row-major: ``(cell, slices into
    the chunk, slices into the box)`` for each one's share of the box."""
    per_dim = []
    for c, (lo, hi) in zip(cuts, bounds):
        per_dim.append([(j, max(c[j], lo), min(c[j + 1], hi))
                        for j in range(len(c) - 1)
                        if max(c[j], lo) < min(c[j + 1], hi)])
    out = []
    for combo in itertools.product(*per_dim):
        ci = tuple(j for j, _, _ in combo)
        src = tuple(slice(a - cuts[d][j], b - cuts[d][j])
                    for d, (j, a, b) in enumerate(combo))
        dst = tuple(slice(a - bounds[d][0], b - bounds[d][0])
                    for d, (_, a, b) in enumerate(combo))
        out.append((ci, src, dst))
    return out


def even_cuts(dims: Sequence[int], grid: Sequence[int]) -> list[list[int]]:
    """Cut vectors of an exactly-even chunk grid; raises when a dim does
    not divide."""
    cuts = []
    for d, g in zip(dims, grid):
        g = max(int(g), 1)
        if d % g:
            raise ValueError(f"extent {d} not divisible by {g} chunks")
        step = d // g
        cuts.append([step * i for i in range(g + 1)])
    return cuts
