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

In a job of several controller processes (``multihost.initialize``) a
process holds only its own ranks' tensors: another process's ranks are
``meta`` placeholders of the right shape and dtype in the lists, and the
body runs on every process over the whole nesting (torch's ``meta``
device carries shapes through ordinary ops without touching data).
Every collective is then a collective call of every process of the job,
entered with lists of the same shapes in the same order (the SPMD
discipline): each process fills its own ranks' results by one
``multihost.exchange``, a copy launch of K10's copy kernel over CUDA IPC
on the card (counted as ``all_gather``, or ``all_to_all`` for
``pall_to_all``; on the ``cross_process_region`` route), the gloo route
off it; the other ranks' results are placeholders.  ``preduce`` and
``psum_scatter`` bring every rank's operand to the process and fold it
in the single-process order, so a job's result is bit-equal to one
process's on the same ranks.  ``pshifts`` hands several shifts to one
exchange, ``preduces`` several reductions, ``pconcat`` several gathers
onto one device.  ``pshift`` and ``pshifts`` are differentiable in a job
as ``.to(device)`` is in one process (the backward shifts the gradients
back, one exchange).  A process enters a shift's backward exchange only
when its own loss reaches that shift, so a plain ring built on them
trains across processes when every process holds a rank of the ring and
each process's loss reaches every rotation: the zigzag ring attention's
does (each rank works at every step), and the causal contiguous ring
(``models.ring_attention.ring_attention_kernel``), whose plan skips a
rank's later steps, ties its outputs to its last rotation.  A process
that misses an exchange leaves its peers waiting until the job's store
timeout, which raises.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from .. import layout as L
from .. import telemetry as _tm
from ..darray import DArray
from . import multihost

__all__ = ["spmd_mesh", "run_spmd", "axis_rank", "axis_size",
           "halo_exchange", "halo_exchange_2d", "pshift", "pshifts",
           "pbarrier", "pbcast", "pgather", "preduce", "preduces",
           "pconcat", "pall_to_all", "psum_scatter"]


# ---------------------------------------------------------------------------
# the cross-process forms: each collective's plan over one exchange
# ---------------------------------------------------------------------------


def _rec(kind: str, x, **fields) -> None:
    """The comm record of a rank-list collective, as JAX's ``_rec``
    (``collectives.py:71``): the per-rank block's bytes, once a distinct
    call signature (JAX records once a trace), over the axis ``ranks``.
    Each site calls it only while telemetry is enabled, so that a disabled
    site costs its one check."""
    _tm.record_comm(kind, _tm.nbytes_of(x), axis="ranks", traced=True,  # dalint: disable=DAL003 — every caller of _rec tests telemetry.enabled() first
                    once_key=f"collective:{kind}:ranks:{fields}", **fields)


def _real(t: torch.Tensor) -> bool:
    """Whether this process holds the rank's tensor (another process's
    is a ``meta`` placeholder)."""
    return t.device.type != "meta"


def _whole(t: torch.Tensor) -> list[tuple[int, int]]:
    return [(0, n) for n in t.shape]


def _along(t: torch.Tensor, dim: int, lo: int, hi: int):
    """The box of ``t``'s slabs ``lo:hi`` along ``dim``."""
    box = _whole(t)
    box[dim % t.ndim] = (lo, hi)
    return box


def _job_call(plans, kernel: str = "all_gather"):
    """Run ``plans`` (``(blocks, plan)``: ``plan(a, blocks)`` returns the
    wants on rank list ``a`` of this process's ranks and a ``finish()``
    that returns the result once they are filled) as one
    ``multihost.exchange``; the results in order."""
    lists, wants, finish = [], [], []
    for blocks, plan in plans:
        lists.append(list(blocks))
        w, fin = plan(len(lists) - 1, lists[-1])
        wants += w
        finish.append(fin)
    multihost.exchange(lists, wants, kernel,
                       op="all_to_all" if kernel == "all_to_all"
                       else "collective")
    return [fin() for fin in finish]


def _shift_plan(shift: int, wrap: bool):
    def plan(a, blocks):
        n, outs, wants = len(blocks), [], []
        for i, b in enumerate(blocks):
            j = i - shift
            if not (wrap or 0 <= j < n):
                outs.append(torch.zeros_like(b))
                continue
            src = blocks[j % n]
            t = torch.empty(src.shape, dtype=src.dtype, device=b.device)
            if _real(b):
                wants.append((a, j % n, _whole(src), t))
            outs.append(t)
        return wants, lambda: outs
    return plan


def _halo_plan(halo: int, dim: int, wrap: bool):
    def plan(a, blocks):
        n, outs, wants = len(blocks), [], []
        for r, b in enumerate(blocks):
            pair = []
            for nb, first in ((r - 1, False), (r + 1, True)):
                shape = list(b.shape)
                shape[dim] = halo
                if not (wrap or 0 <= nb < n):
                    pair.append(torch.zeros(shape, dtype=b.dtype,
                                            device=b.device))
                    continue
                src = blocks[nb % n]
                size = src.shape[dim]
                lo = 0 if first else size - halo
                shape = list(src.shape)
                shape[dim] = halo
                t = torch.empty(shape, dtype=src.dtype, device=b.device)
                if _real(b):
                    wants.append((a, nb % n, _along(src, dim, lo, lo + halo),
                                  t))
                pair.append(t)
            outs.append(tuple(pair))
        return wants, lambda: outs
    return plan


def _fetch_all(a, blocks, need: bool, box=_whole):
    """Wants that bring ``box(b)`` of every rank's block ``b`` another
    process holds onto this process's device (when ``need``), and the
    operands: a held block's box in place, a fetched one's tensor."""
    wants, vals = [], []
    for r, b in enumerate(blocks):
        bx = box(b)
        if _real(b) or not need:
            vals.append(b[tuple(slice(lo, hi) for lo, hi in bx)])
            continue
        t = torch.empty([hi - lo for lo, hi in bx], dtype=b.dtype,
                        device=L.local_device())
        wants.append((a, r, bx, t))
        vals.append(t)
    return wants, vals


def _reduce_plan(op: str):
    def plan(a, blocks):
        need = any(_real(b) for b in blocks)
        wants, vals = _fetch_all(a, blocks, need)

        def finish():
            acc = _fold(vals, op)
            return [acc.to(b.device, copy=True) if _real(b) else
                    torch.empty(acc.shape, dtype=acc.dtype, device=b.device)
                    for b in blocks]
        return wants, finish
    return plan


def _scatter_plan(dim: int):
    def plan(a, blocks):
        p, wants, parts = len(blocks), [], []
        for d, b in enumerate(blocks):
            ext = b.shape[dim] // p

            def box(x, d=d, ext=ext):
                return _along(x, dim, d * ext, (d + 1) * ext)
            w, vals = _fetch_all(a, blocks, _real(b), box)
            wants += w
            parts.append(vals)

        def finish():
            return [_scatter_fold(parts[d], d, b.device)
                    for d, b in enumerate(blocks)]
        return wants, finish
    return plan


def _a2a_plan(split_dim: int, concat_dim: int):
    def plan(a, blocks):
        p, outs, wants = len(blocks), [], []
        shape_of = [b.tensor_split(p, split_dim) for b in
                    (x.to("meta") for x in blocks)]
        for q, b in enumerate(blocks):
            o = torch.empty(torch.cat([shape_of[r][q] for r in range(p)],
                                      concat_dim).shape,
                            dtype=b.dtype, device=b.device)
            if _real(b):
                off = 0
                for r, x in enumerate(blocks):
                    ext = x.shape[split_dim] // p
                    n = shape_of[r][q].shape[concat_dim]
                    wants.append((a, r, _along(x, split_dim, q * ext,
                                               (q + 1) * ext),
                                  o.narrow(concat_dim, off, n)))
                    off += n
            outs.append(o)
        return wants, lambda: outs
    return plan


def _gather_plan(dim: int):
    def plan(a, blocks):
        outs, wants = [], []
        shape = torch.cat([x.to("meta") for x in blocks], dim).shape
        for b in blocks:
            o = torch.empty(shape, dtype=b.dtype, device=b.device)
            if _real(b):
                off = 0
                for r, x in enumerate(blocks):
                    n = x.shape[dim]
                    wants.append((a, r, _whole(x), o.narrow(dim, off, n)))
                    off += n
            outs.append(o)
        return wants, lambda: outs
    return plan


def _concat_plan(dim: int | None):
    def plan(a, blocks):
        parts, d = (blocks[:1], 0) if dim is None else (blocks, dim)
        t = torch.empty(torch.cat([b.to("meta") for b in parts], d).shape,
                        dtype=blocks[0].dtype, device=L.local_device())
        wants, off = [], 0
        for r, b in enumerate(parts):
            wants.append((a, r, _whole(b), t.narrow(d, off, b.shape[d])))
            off += b.shape[d]
        return wants, lambda: t
    return plan


def _bcast_plan(root: int):
    def plan(a, blocks):
        src, outs, wants = blocks[root], [], []
        for b in blocks:
            o = torch.empty(src.shape, dtype=src.dtype, device=b.device)
            if _real(b):
                wants.append((a, root, _whole(src), o))
            outs.append(o)
        return wants, lambda: outs
    return plan


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
    ``out_specs``, one block per rank) is returned as it is.

    In a job of several controller processes ``f`` runs on every process
    over the whole nesting: a DArray argument passes its cells, this
    process's ranks' tensors and ``meta`` placeholders for the others; any
    other argument's blocks are moved to this process's ranks only (the
    others become placeholders); and the collectives inside are the
    cross-process forms (see the module docstring), which every process
    enters in the same order.  A body may read another rank's values only
    through a collective: ``.item()`` or a host copy of a placeholder
    raises, and a branch on data would leave the processes' calls out of
    step.  The result holds real tensors for this process's ranks and
    placeholders for the others."""
    _tm.count("op.run_spmd")
    grid = np.asarray(ranks, dtype=np.int64)
    conv = []
    for a in args:
        if isinstance(a, DArray):
            if not np.array_equal(a.pids, grid):
                raise ValueError(f"a DArray on ranks {a.pids.tolist()} "
                                 f"passed to a program on {grid.tolist()}")
            cells = np.empty(grid.shape, dtype=object)
            a._check_open()
            for ci in np.ndindex(*grid.shape):
                cells[ci] = a._parts[ci]
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
    if multihost.in_job():
        _check_halo([blocks], halo, dim)
        return _job_call([(blocks, _halo_plan(halo, dim, wrap))])[0]
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
    corners arrive.  In a job each phase is one exchange."""
    g0, g1 = len(blocks_2d), len(blocks_2d[0])
    cols = [[blocks_2d[a][b] for a in range(g0)] for b in range(g1)]
    ext = [[None] * g1 for _ in range(g0)]
    for b, got in enumerate(_halo_lines(cols, halo, 0, wrap)):
        for a, (x, (lo, hi)) in enumerate(zip(cols[b], got)):
            ext[a][b] = torch.cat([lo, x, hi], dim=0)
    out = [[None] * g1 for _ in range(g0)]
    for a, got in enumerate(_halo_lines(ext, halo, 1, wrap)):
        for b, (x, (lo, hi)) in enumerate(zip(ext[a], got)):
            out[a][b] = torch.cat([lo, x, hi], dim=1)
    return out


def _halo_lines(lines, halo: int, dim: int, wrap: bool) -> list:
    """``halo_exchange`` of each line of blocks; in a job, one exchange for
    all of them."""
    if multihost.in_job():
        _check_halo(lines, halo, dim)
        return _job_call([(ln, _halo_plan(halo, dim, wrap))
                          for ln in lines])
    return [halo_exchange(ln, halo=halo, dim=dim, wrap=wrap)
            for ln in lines]


def _check_halo(lines, halo: int, dim: int) -> None:
    for ln in lines:
        for b in ln:
            if halo > b.shape[dim]:
                raise ValueError(
                    f"halo {halo} exceeds the neighbour's extent "
                    f"{b.shape[dim]}")


def pbarrier(blocks) -> list[torch.Tensor]:
    """A synchronization point (JAX ``collectives.py:181``, a psum of 1):
    waits for the work queued on every rank's CUDA device (in a job, this
    process's, then every process at ``multihost.sync_hosts``) and returns
    the rank count as an int32 scalar on each rank's device, in the nesting of
    ``blocks``."""
    if _tm.enabled():
        _rec("psum", torch.ones((), dtype=torch.int32), op="pbarrier")
    nested = bool(blocks) and isinstance(blocks[0], (list, tuple))
    flat = [b for row in blocks for b in row] if nested else list(blocks)
    for dev in {b.device for b in flat if b.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    if multihost.in_job():
        multihost.sync_hosts("pbarrier")

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
    if _tm.enabled():
        _rec("psum", blocks[root], op="pbcast", root=root)
    if multihost.in_job():
        return _job_call([(blocks, _bcast_plan(root))])[0]
    return [blocks[root].to(b.device, copy=True) for b in blocks]


def _split(flat, sizes) -> list[list]:
    """``flat`` cut into consecutive lists of ``sizes``."""
    out, k = [], 0
    for n in sizes:
        out.append(list(flat[k:k + n]))
        k += n
    return out


def _shifted(lists, shifts, wrap: bool) -> list[torch.Tensor]:
    """Every list of ``lists`` shifted, in one exchange, flat."""
    return [t for res in _job_call([(b, _shift_plan(s, wrap))
                                    for b, s in zip(lists, shifts)])
            for t in res]


class _JobShifts(torch.autograd.Function):
    """``pshifts`` in a job, one exchange, differentiable as the copies of
    one process are: the backward shifts the gradients back (by
    ``-shift``), one exchange again, which every process enters at the
    same point of the backward (``models._autodiff.value_and_grad``)
    provided its loss reaches this node (see the module docstring)."""

    @staticmethod
    def forward(ctx, sizes, shifts, wrap, *flat):
        ctx.sizes, ctx.shifts, ctx.wrap = sizes, shifts, wrap
        out = _shifted(_split(flat, sizes), shifts, wrap)
        ctx.mark_non_differentiable(*[
            t for t in out if not (t.is_floating_point() or t.is_complex())])
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, None, *_shifted(
            _split(grads, ctx.sizes), [-s for s in ctx.shifts], ctx.wrap))


def _job_shifts(lists, shifts, wrap: bool) -> list[list]:
    sizes = tuple(len(b) for b in lists)
    return _split(_JobShifts.apply(sizes, tuple(shifts), wrap,
                                   *[t for b in lists for t in b]), sizes)


def pshift(blocks: Sequence[torch.Tensor], shift: int = 1,
           wrap: bool = True) -> list[torch.Tensor]:
    """Ring shift: rank ``i`` receives rank ``i - shift``'s block on its own
    device.  With ``wrap=False`` ranks with no sender receive zeros."""
    if _tm.enabled() and blocks:
        _rec("ppermute", blocks[0], op="pshift", shift=shift)
    if multihost.in_job():
        return _job_shifts([blocks], [shift], wrap)[0]
    n = len(blocks)
    out = []
    for i, b in enumerate(blocks):
        j = i - shift
        if wrap or 0 <= j < n:
            out.append(blocks[j % n].to(b.device))
        else:
            out.append(torch.zeros_like(b))
    return out


def pshifts(lists, shift=1, wrap: bool = True) -> list[list]:
    """``pshift`` of each rank list of ``lists`` (the K and V blocks of a
    ring, the lines of a grid), by ``shift`` (an int, or one a list); in a
    job, one exchange for all of them."""
    shifts = [shift] * len(lists) if isinstance(shift, int) else list(shift)
    if multihost.in_job():
        return _job_shifts(lists, shifts, wrap)
    return [pshift(b, s, wrap) for b, s in zip(lists, shifts)]


def pgather(blocks: Sequence[torch.Tensor], dim: int = 0) -> list[torch.Tensor]:
    """Every rank gets all blocks concatenated along ``dim`` in rank order,
    on its own device."""
    if _tm.enabled() and blocks:
        _rec("all_gather", blocks[0], op="pgather")
    if multihost.in_job():
        return _job_call([(blocks, _gather_plan(dim))])[0]
    return [torch.cat([x.to(b.device) for x in blocks], dim) for b in blocks]


_FOLDS = {"sum": torch.add, "mean": torch.add, "max": torch.maximum,
          "min": torch.minimum}


def preduce(blocks: Sequence[torch.Tensor],
            op: str = "sum") -> list[torch.Tensor]:
    """All-reduce (``lax.psum``/``pmax``/``pmin``/``pmean``): the ranks'
    blocks folded in rank order on rank 0's device (``mean`` divides the
    sum by the rank count), the one result copied to every rank's device,
    so every rank holds the same bits."""
    return preduces([blocks], op)[0]


def preduces(lists, op: str = "sum") -> list[list[torch.Tensor]]:
    """``preduce`` of each rank list of ``lists`` (the replicated
    parameters' gradients of a model); in a job, one exchange for all of
    them."""
    if op not in _FOLDS:
        raise ValueError(f"unknown reduction {op!r}: use one of "
                         f"{sorted(_FOLDS)}")
    if _tm.enabled():
        for blocks in lists:
            if blocks:
                _rec("psum" if op in ("sum", "mean") else f"p{op}",
                     blocks[0], op="preduce")
    if multihost.in_job():
        return _job_call([(b, _reduce_plan(op)) for b in lists])
    out = []
    for blocks in lists:
        acc = _fold(blocks, op)
        out.append([acc.to(b.device, copy=True) for b in blocks])
    return out


def pconcat(lists, dims) -> list[torch.Tensor]:
    """Each rank list of ``lists`` as one whole tensor on this process's
    first rank's device (rank 0's in one process): its blocks concatenated
    along ``dims[i]`` in rank order, or rank 0's block where ``dims[i]`` is
    None (a replicated value, handed back as it is in one process).  In a
    job every process gets the whole tensors, by one exchange for all the
    lists."""
    lists = [list(b) for b in lists]
    if not multihost.in_job():
        dev = lists[0][0].device
        return [b[0] if d is None else torch.cat([x.to(dev) for x in b], d)
                for b, d in zip(lists, dims)]
    return _job_call([(b, _concat_plan(d)) for b, d in zip(lists, dims)])


def _fold(blocks, op: str) -> torch.Tensor:
    """The blocks folded in rank order on the first one's device."""
    acc = blocks[0]
    for b in blocks[1:]:
        acc = _FOLDS[op](acc, b.to(acc.device))
    if op == "mean":
        acc = acc / len(blocks)
    return acc


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
    if _tm.enabled() and blocks:
        _rec("all_to_all", blocks[0], op="pall_to_all")
    if multihost.in_job():
        return _job_call([(blocks, _a2a_plan(split_dim, concat_dim))],
                         "all_to_all")[0]
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
    if multihost.in_job():
        return _job_call([(blocks, _scatter_plan(dim))], "all_to_all")[0]
    pieces = [b.tensor_split(p, dim) for b in blocks]
    return [_scatter_fold([x[d] for x in pieces], d, b.device)
            for d, b in enumerate(blocks)]


def _scatter_fold(pieces, d: int, device) -> torch.Tensor:
    """Rank ``d``'s reduce-scatter sum of every rank's piece ``pieces[r]``:
    the left fold over ranks d+1, d+2, ..., d+p (mod p) on ``device``."""
    p = len(pieces)
    acc = pieces[(d + 1) % p].to(device, copy=True)
    for k in range(2, p + 1):
        acc = acc + pieces[(d + k) % p].to(device)
    return acc.contiguous()
