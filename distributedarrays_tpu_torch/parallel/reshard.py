"""Relayout between two layouts of one global array: plan by chunk
intersection, classify, and lower one-collective repartitions to kernels.

PyTorch counterpart of ``plan_reshard`` and the single-axis half of
``_build_plan`` and ``_collective_jit`` in
``distributedarrays_tpu/parallel/reshard.py``.  The transfer plan is the
cross product of the per-dimension ``layout.cut_intersections`` lists and
carries the JAX plan's ``strategy``:

- ``noop``: the layouts agree;
- ``all_to_all``: one sharded dim ``i`` becomes one sharded dim ``j != i``
  of the same width on the same ranks in the same order, every cut even.
  ``relayout_parts`` lowers it to the all-to-all kernel
  (``ops/cuda_collectives.ring_all_to_all``, split along ``j``, concatenated
  along ``i``);
- ``device_put``: everything else (``reason`` says why), copied region by
  region with ``.to(device)``.

The JAX ``all_gather`` plan (sharded to replicated) has no DArray layout
here, where each rank holds one exact-size chunk; its counterpart is
``allgather(d, ranks)``, which returns the whole of ``d`` on each of the
given ranks' devices, through the all-gather kernel
(``ring_all_gather``) when ``d`` is chunked along at most one dim on
exactly those ranks (``plan_allgather`` says which).  Not ported yet: the
multi-axis ``chain``/``pad_chain``/``gather_put`` plans and the chunked
staging bounded by ``DA_TPU_RESHARD_CHUNK_MB``.  The JAX package's silent
fallback from its RDMA kernels to XLA collectives, and its ``DA_TPU_RDMA``
switch, have no counterpart: a planned collective runs its kernel on the
card or raises.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from .. import layout as L
from ..darray import DArray
from ..ops.cuda_collectives import ring_all_gather, ring_all_to_all

__all__ = ["ReshardPlan", "plan_reshard", "relayout", "relayout_parts",
           "plan_allgather", "allgather"]


@dataclasses.dataclass(frozen=True)
class ReshardPlan:
    """The chunk-intersection transfer plan between two layouts.

    ``regions`` holds ``(src_cell, dst_cell, bounds)`` for every non-empty
    intersection, ``bounds`` being one global ``(lo, hi)`` per dim.
    ``moved_bytes`` counts the bytes whose source and destination ranks
    differ (summed over receiving ranks); ``total_bytes`` is the array's
    size.  ``strategy`` is ``noop``, ``all_to_all``, ``all_gather`` (only
    from ``plan_allgather``) or ``device_put`` (``reason`` says why);
    a collective plan also names its source and destination dims, its
    width ``nparts`` and the ranks in ring order."""

    regions: tuple
    moved_bytes: int
    total_bytes: int
    strategy: str = "device_put"
    src_dim: int | None = None
    dst_dim: int | None = None
    nparts: int = 1
    ranks: tuple = ()
    reason: str = ""


def _uniform(cuts) -> bool:
    return len({hi - lo for lo, hi in zip(cuts, cuts[1:])}) <= 1


def _ring_order(pids: np.ndarray, dim: int) -> tuple:
    """The ranks of a layout sharded on ``dim`` only, in chunk order."""
    return tuple(int(x) for x in np.moveaxis(pids, dim, 0).reshape(
        pids.shape[dim], -1)[:, 0])


def _classify(d: DArray, pids: np.ndarray, cuts) -> dict:
    """The JAX planner's single-axis classification for two DArray layouts
    (one rank per cell, so no replicated blocks)."""
    if same_layout(d, pids, cuts):
        return {"strategy": "noop"}
    if set(int(x) for x in d.pids.flat) != set(int(x) for x in pids.flat):
        return {"reason": "device sets differ"}
    if not all(_uniform(c) for c in d.cuts):
        return {"reason": "uneven source shards"}
    if not all(_uniform(c) for c in cuts):
        return {"reason": "uneven destination shards"}
    s_grid, d_grid = d.grid, tuple(pids.shape)
    s_sh = [k for k, g in enumerate(s_grid) if g > 1]
    d_sh = [k for k, g in enumerate(d_grid) if g > 1]
    if len(s_sh) > 1 or len(d_sh) > 1:
        return {"reason": "multi-dim chunk grid"}
    if not (s_sh and d_sh):
        # one cell on each side on one rank, or different rank counts
        # (caught above): only a placement change is left
        return {"reason": "no sharded dims on either side"}
    i, j = s_sh[0], d_sh[0]
    p = s_grid[i]
    if i == j or d_grid[j] != p:
        return {"reason": "incompatible repartition widths"}
    order = _ring_order(d.pids, i)
    if order != _ring_order(pids, j):
        return {"reason": "rank order differs"}
    return {"strategy": "all_to_all", "src_dim": i, "dst_dim": j,
            "nparts": p, "ranks": order}


def plan_reshard(d: DArray, pids: np.ndarray, cuts) -> ReshardPlan:
    """Plan moving ``d`` onto the layout ``(pids, cuts)``."""
    d._check_open()
    itemsize = torch.empty(0, dtype=d.dtype).element_size()
    per_dim = [L.cut_intersections(sc, dc) for sc, dc in zip(d.cuts, cuts)]
    regions, moved = [], 0
    for combo in itertools.product(*per_dim):
        src = tuple(c[0] for c in combo)
        dst = tuple(c[1] for c in combo)
        bounds = tuple((c[2], c[3]) for c in combo)
        regions.append((src, dst, bounds))
        if int(d.pids[src]) != int(pids[dst]):
            moved += int(np.prod([h - l for l, h in bounds])) * itemsize
    return ReshardPlan(tuple(regions), moved, d.size * itemsize,
                       **_classify(d, np.asarray(pids), cuts))


def same_layout(d: DArray, pids: np.ndarray, cuts) -> bool:
    return (d.cuts == [list(c) for c in cuts]
            and np.array_equal(d.pids, pids))


def _cell(ndim: int, dim: int, k: int) -> tuple:
    return tuple(k if x == dim else 0 for x in range(ndim))


def relayout_parts(d: DArray, pids: np.ndarray, cuts) -> np.ndarray:
    """``d``'s cells on the layout ``(pids, cuts)``.  Returns ``d``'s own
    tensors when the layouts already agree (callers only read them), runs
    the all-to-all kernel for an ``all_to_all`` plan, and otherwise fills
    fresh tensors region by region from the plan."""
    d._check_open()
    if same_layout(d, pids, cuts):
        return d._parts
    plan = plan_reshard(d, pids, cuts)
    parts = np.empty(tuple(pids.shape), dtype=object)
    if plan.strategy == "all_to_all":
        i, j, p = plan.src_dim, plan.dst_dim, plan.nparts
        outs = ring_all_to_all([d.part(_cell(d.ndim, i, k)) for k in range(p)],
                               split_dim=j, concat_dim=i)
        for q, t in enumerate(outs):
            parts[_cell(d.ndim, j, q)] = t
        return parts
    for ci in np.ndindex(*pids.shape):
        shape = tuple(c[j + 1] - c[j] for c, j in zip(cuts, ci))
        parts[ci] = torch.empty(shape, dtype=d.dtype,
                                device=L.device_of(int(pids[ci])))
    for src, dst, bounds in plan.regions:
        s = tuple(slice(lo - d.cuts[k][j], hi - d.cuts[k][j])
                  for k, (j, (lo, hi)) in enumerate(zip(src, bounds)))
        t = tuple(slice(lo - cuts[k][j], hi - cuts[k][j])
                  for k, (j, (lo, hi)) in enumerate(zip(dst, bounds)))
        out = parts[dst]
        out[t] = d.part(src)[s].to(out.device)
    return parts


def relayout(d: DArray, pids: np.ndarray, cuts) -> DArray:
    """A new DArray holding ``d``'s values on the layout ``(pids, cuts)``
    (a copy even when the layouts agree)."""
    if same_layout(d, pids, cuts):
        return d.copy()
    return DArray(relayout_parts(d, pids, cuts),
                  np.asarray(pids, dtype=np.int64), [list(c) for c in cuts])


def plan_allgather(d: DArray, ranks) -> ReshardPlan:
    """Plan putting the whole of ``d`` on each rank of ``ranks``:
    ``all_gather`` when ``d`` is chunked along at most one dim on exactly
    those ranks (the ring is ``d``'s chunks in order), else ``device_put``.
    ``moved_bytes`` counts, per receiving rank, the bytes it does not hold
    yet; ``regions`` is empty (every rank receives every chunk)."""
    d._check_open()
    ranks = [int(r) for r in ranks]
    if len(set(ranks)) != len(ranks):
        raise ValueError(f"allgather ranks repeat: {ranks}")
    itemsize = torch.empty(0, dtype=d.dtype).element_size()
    total = d.size * itemsize
    own = {}
    for ci in d.cells():
        own[int(d.pids[ci])] = int(np.prod([c[j + 1] - c[j]
                                            for c, j in zip(d.cuts, ci)]))
    moved = sum(total - own.get(r, 0) * itemsize for r in ranks)
    sharded = [k for k, g in enumerate(d.grid) if g > 1]
    if set(own) != set(ranks):
        kw = {"reason": "device sets differ"}
    elif len(sharded) > 1:
        kw = {"reason": "multi-dim chunk grid"}
    else:
        dim = sharded[0] if sharded else 0
        kw = {"strategy": "all_gather", "src_dim": dim,
              "nparts": d.grid[dim] if d.ndim else 1,
              "ranks": _ring_order(d.pids, dim) if d.ndim else tuple(own)}
    return ReshardPlan((), moved, total, **kw)


def allgather(d: DArray, ranks=None) -> list[torch.Tensor]:
    """The whole of ``d`` on each rank of ``ranks`` (default: ``d``'s own
    ranks, row-major), one tensor per rank on its device, in the order of
    ``ranks``: through the all-gather kernel when ``plan_allgather`` says
    ``all_gather``, else assembled region by region."""
    ranks = ([int(p) for p in d.pids.flat] if ranks is None
             else [int(r) for r in ranks])
    plan = plan_allgather(d, ranks)
    if plan.strategy != "all_gather" or d.ndim == 0:
        return [d.full(L.device_of(r)) for r in ranks]
    dim = plan.src_dim
    outs = ring_all_gather([d.part(_cell(d.ndim, dim, k))
                            for k in range(plan.nparts)], dim)
    whole = dict(zip(plan.ranks, outs))
    return [whole[r] for r in ranks]
