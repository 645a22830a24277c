"""Relayout between two layouts of one global array, planned by chunk
intersection.

PyTorch counterpart of the metadata half of
``distributedarrays_tpu/parallel/reshard.py``: the transfer plan is the
cross product of the per-dimension ``layout.cut_intersections`` lists, and
the relayout copies each intersecting sub-block from the source rank's
tensor into the destination rank's tensor.  This is what aligns operands
that sit on different layouts (broadcast, matmul's result layout).  The
JAX package's chunked staging, multi-axis collective chains and ring
dispatch are not ported yet.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from .. import layout as L
from ..darray import DArray

__all__ = ["ReshardPlan", "plan_reshard", "relayout"]


@dataclasses.dataclass(frozen=True)
class ReshardPlan:
    """The chunk-intersection transfer plan between two layouts.

    ``regions`` holds ``(src_cell, dst_cell, bounds)`` for every non-empty
    intersection, ``bounds`` being one global ``(lo, hi)`` per dim.
    ``moved_bytes`` counts the bytes whose source and destination ranks
    differ; ``total_bytes`` is the array's size."""

    regions: tuple
    moved_bytes: int
    total_bytes: int


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
    return ReshardPlan(tuple(regions), moved, d.size * itemsize)


def same_layout(d: DArray, pids: np.ndarray, cuts) -> bool:
    return (d.cuts == [list(c) for c in cuts]
            and np.array_equal(d.pids, pids))


def relayout_parts(d: DArray, pids: np.ndarray, cuts) -> np.ndarray:
    """``d``'s cells on the layout ``(pids, cuts)``.  Returns ``d``'s own
    tensors when the layouts already agree (callers only read them), else
    fresh tensors filled region by region from the plan."""
    d._check_open()
    if same_layout(d, pids, cuts):
        return d._parts
    parts = np.empty(tuple(pids.shape), dtype=object)
    for ci in np.ndindex(*pids.shape):
        shape = tuple(c[j + 1] - c[j] for c, j in zip(cuts, ci))
        parts[ci] = torch.empty(shape, dtype=d.dtype,
                                device=L.device_of(int(pids[ci])))
    for src, dst, bounds in plan_reshard(d, pids, cuts).regions:
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
