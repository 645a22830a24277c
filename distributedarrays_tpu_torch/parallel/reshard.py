"""Relayout between two layouts of one global array: the reshard planner
and its lowering onto the copy kernel that K10 and K11 share.

PyTorch counterpart of ``distributedarrays_tpu/parallel/reshard.py``.  The
planner (``_moved_elems`` through ``_build_plan``, ``reshard.py:178-649``)
is the port's own copy of the JAX functions: they take the same layouts
``(cuts, owners)`` (per-dim cut vectors and a dict from block coordinates
to the sorted tuple of ranks holding the block) and return the same plans.
A DArray has one rank per cell, so ``layout_of`` builds its owners as
``{cell: (pid,)}``, the port's counterpart of ``layout_of_sharding``.
The strategies:

- ``noop``: the layouts agree;
- ``all_to_all``: one sharded dim ``i`` becomes one sharded dim ``j != i``
  of the same width on the same ranks in the same order, every cut even.
  Lowered to the all-to-all kernel (``ops/cuda_collectives.ring_all_to_all``,
  K11);
- ``chain``: any other move whose two layouts share a mixed-radix
  refinement of their rank grids: multi-axis repartitions, mesh-axis
  transposes, 3-D grids.  The refinement's digits are the axes of a mesh
  (``mesh_shape``) over the canonical rank order ``ranks``; ``steps`` is a
  schedule of per-axis ops, ``a2a`` (an all-to-all within each group of
  ranks that differ only in that digit), ``gather`` (an all-gather along
  ``src_dim`` within each group) and ``slice`` (a local narrow, which moves
  nothing).  Ceil-uneven layouts whose pads agree run the chain of their
  even analog ``pad_shape`` (JAX's ``_try_pad_chain``; the strategy is
  still ``chain``);
- ``all_gather`` and ``gather_put`` come from ``plan_allgather``: the whole
  array onto every rank of a one-dim grid (K10), or the chain toward the
  replicated layout, kept on a proper subset of the source ranks;
- ``device_put``: the rest (``reason`` says why), copied region by region
  (``relayout_plain``).

JAX's ``local_slice`` (replicated to sharded) has no DArray source here,
where nothing is replicated.

**Lowering.**  Every ``chain`` step but ``slice`` is one call of
``cuda_collectives.chain_step``: one ``copy_kernel`` launch a card for all
the step's groups (``copy_launches`` splits them above ``MAXP`` copies),
each piece copied straight to its final offset in its rank's output.  A
rank's output is only the window that the slices right after the step keep
and that lies inside the array, so no step allocates more than its output
and pads are neither allocated nor moved (ceil cuts put every pad element
on the trailing cell).  ``chunk_axis``, ``nchunks`` and ``staging_bytes``
are planned exactly as in JAX, so the plans compare equal, but they split
no launch: nothing is staged beyond a step's output, as JAX's RDMA path
notes for itself (``reshard.py:1155-1160``).

**Plan cache.**  Plans are cached on the shape, the itemsize, both layouts,
the chunk target (``DA_TPU_RESHARD_CHUNK_MB``, read on every call) and the
failure-domain topology (``resilience.domains``): a plan's
``intra_bytes``/``cross_bytes`` depend on it.  ``plan_stats()`` reports
hits, misses and size.

**Across controller processes** (a job of ``parallel.multihost``) the
plan is made as above, the same on every process (the cache, the span and
the accounting included), and every plan is lowered as the one-pass
region copy that ``relayout_plain`` makes: each process fills its own
target cells (``allgather``: its own ranks' whole arrays) by one
``multihost.fetch_regions`` call, one copy launch a process on the card
(a cross-process relayout is an all-to-all, an all-gather or any other
move alike); another process's target cells are placeholders.

A planned collective runs its kernel on the card or raises: JAX's fallback
from a failed lowering to ``device_put`` (``reshard.py:1172-1182``) and its
``DA_TPU_RDMA`` switch have no counterpart.

**Telemetry and faults** (JAX ``reshard.py:638-642``, ``:776``,
``:1116-1190``): every move of ``relayout_parts`` and ``allgather`` runs in
a ``reshard`` span labeled with ``op``, the strategy, shape, dtype,
``src_dim``/``dst_dim``, ``nparts``, ``nsteps``, the plan's
``intra_bytes``/``cross_bytes`` and ``perf.reshard_cost``; a collective
plan passes the ``reshard.chunk`` fault site before any byte moves;
``record_comm("reshard", moved_bytes)`` accounts each move; a
``device_put`` plan that moves bytes counts
``reshard.collective_fallbacks{reason}``.  ``plan_reshard`` and
``plan_allgather`` count ``reshard.plan_requests``, a cache miss
``reshard.plan_builds`` and one ``reshard``/``plan`` journal event.  The
span also carries JAX's ``dispatch`` label: ``"rdma"`` when a collective
plan runs the copy kernel on the card, ``"plain"`` otherwise.  It carries
none of JAX's ``rdma_chunks``, ``autotune_key`` or ``dispatch_key``: the
copy kernel writes every piece at its final offset in one launch, so no
piece count is read that a tuned entry could set (the tuning advisor skips
JAX's ``rdma_chunks`` action for that reason), and the port's reshard has
one route.  Nor has the port JAX's ``jit.builds`` counters of XLA program
builds.  The
memory ledger's ``reshard.chain`` staging gauge counts the bytes a chain
really holds between its steps (each intermediate step's outputs, until
the next step has read them); an ``all_to_all`` writes its outputs
straight into the new cells and stages nothing.  JAX's gauge instead
counts its XLA dispatch's planned chunk piece.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import math
import os

import numpy as np
import torch

from .. import layout as L
from .. import telemetry as _tm
from ..darray import DArray
from ..ops.cuda_collectives import (chain_step, ring_all_gather,
                                    ring_all_to_all)
from ..resilience import domains as _dom
from ..resilience import faults as _fl
from ..telemetry import perf as _perf

__all__ = ["ReshardPlan", "plan_reshard", "reshard", "relayout",
           "relayout_parts", "relayout_plain", "plan_allgather", "allgather",
           "plan_stats", "layout_of"]

_CHUNK_MB_ENV = "DA_TPU_RESHARD_CHUNK_MB"

# cross-product cap of _moved_elems: a plan is metadata, not a workload
_MAX_PLAN_REGIONS = 65536


def _chunk_target_bytes() -> int:
    """The staging target in bytes, from ``DA_TPU_RESHARD_CHUNK_MB`` (64 by
    default), read on every call (JAX ``reshard.py:96``)."""
    try:
        mb = float(os.environ.get(_CHUNK_MB_ENV, "64"))
    except ValueError:
        mb = 64.0
    return max(int(mb * 1024 * 1024), 1)


# ---------------------------------------------------------------------------
# plan metadata
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ReshardPlan:
    """The transfer plan between two layouts (JAX ``reshard.py:110``), with
    the JAX fields and the port's ``regions``.

    ``moved_bytes`` counts the bytes that must cross a rank boundary
    (summed over receiving ranks), ``total_bytes`` the array's size.  A
    single-collective plan names its ``src_dim``/``dst_dim``, its width
    ``nparts`` and its ranks in ring order.  A ``chain`` or ``gather_put``
    plan carries ``mesh_shape`` (the refined mesh, major to minor over the
    canonical rank order ``ranks``), ``src_comp``/``dst_comp`` (per array
    dim, the mesh axes sharding it, major to minor), ``steps`` (each
    ``(kind, axis, q, src_dim, dst_dim, chunk_axis, nchunks,
    moved_bytes)``), ``pad_shape`` (the even analog of ceil-uneven
    layouts), ``staging_bytes`` (the worst step's staging piece) and the
    topology split ``intra_bytes``/``cross_bytes``.  ``regions`` holds
    ``(src_cell, dst_cell, bounds)`` for every non-empty intersection of
    the two layouts' cells."""

    strategy: str
    shape: tuple
    itemsize: int
    moved_bytes: int
    total_bytes: int
    src_dim: int | None = None
    dst_dim: int | None = None
    nparts: int = 1
    ranks: tuple = ()
    chunk_axis: int | None = None
    nchunks: int = 1
    reason: str = ""
    steps: tuple = ()
    mesh_shape: tuple = ()
    src_comp: tuple = ()
    dst_comp: tuple = ()
    pad_shape: tuple = ()
    staging_bytes: int = 0
    intra_bytes: int = 0
    cross_bytes: int = 0
    regions: tuple = ()

    @property
    def collective(self) -> bool:
        return self.strategy in ("all_to_all", "all_gather", "local_slice",
                                 "chain", "gather_put")


def layout_of(pids, cuts) -> tuple[list, dict]:
    """The ``(cuts, owners)`` layout of a DArray layout ``(pids, cuts)``:
    one rank per cell (JAX ``layout_of_sharding``, ``reshard.py:159``)."""
    pids = np.asarray(pids)
    return ([[int(x) for x in c] for c in cuts],
            {tuple(int(k) for k in ci): (int(pids[ci]),)
             for ci in np.ndindex(*pids.shape)})


def _moved_elems(shape, src_cuts, src_owners, dst_cuts, dst_owners) -> int:
    """Elements that must cross a rank boundary: every region of the N-D
    chunk-intersection grid, once per destination rank that does not hold
    it yet (JAX ``reshard.py:178``)."""
    per_dim = [L.cut_intersections(sc, dc)
               for sc, dc in zip(src_cuts, dst_cuts)]
    nregions = math.prod(len(o) for o in per_dim) if per_dim else 1
    if nregions > _MAX_PLAN_REGIONS:
        raise ValueError(f"plan too large: {nregions} regions")
    moved = 0
    for combo in itertools.product(*per_dim):
        n = 1
        for (_ai, _bi, lo, hi) in combo:
            n *= (hi - lo)
        sci = tuple(c[0] for c in combo)
        dci = tuple(c[1] for c in combo)
        sown = src_owners.get(sci, ())
        for dv in dst_owners.get(dci, ()):
            if dv not in sown:
                moved += n
    return moved


def _grid_of(cuts) -> tuple[int, ...]:
    """The chunk grid of per-dim cut vectors (JAX ``reshard.py:201``)."""
    return tuple(len(c) - 1 for c in cuts)


def _uniform(cuts) -> bool:
    """Whether every chunk of a cut vector has one size (JAX
    ``reshard.py:205``)."""
    sizes = np.diff(np.asarray(cuts, dtype=np.int64))
    return sizes.size == 0 or len(set(sizes.tolist())) == 1


def _singleton_rank_order(owners, grid, dim):
    """The owner ranks of a layout sharded on ``dim`` only, in block order;
    None if a block has several owners (JAX ``reshard.py:210``)."""
    order = []
    for k in range(grid[dim]):
        ci = tuple(k if d == dim else 0 for d in range(len(grid)))
        own = owners.get(ci, ())
        if len(own) != 1:
            return None
        order.append(own[0])
    return tuple(order)


def _smallest_divisor_at_least(n: int, k: int) -> int:
    """Smallest divisor of ``n`` that is >= ``k`` (JAX
    ``reshard.py:223``)."""
    if k <= 1:
        return 1
    for d in range(k, n + 1):
        if n % d == 0:
            return d
    return n


def _pick_chunking(shape, itemsize, src_dim, dst_dim, p, strategy,
                   chunk_target):
    """``(chunk_axis, nchunks)`` of a single-collective plan: the largest
    eligible axis, cut so one piece stays under ``chunk_target`` bytes a
    rank (JAX ``reshard.py:233``)."""
    local_bytes = math.prod(shape) * itemsize // max(p, 1)
    want = -(-local_bytes // chunk_target)
    if want <= 1:
        return None, 1
    cands = []
    for d in range(len(shape)):
        if d == src_dim:
            continue
        if d == dst_dim:
            if strategy != "all_to_all":
                continue
            units = shape[d] // p
        else:
            units = shape[d]
        if units > 1:
            cands.append((units, d))
    if not cands:
        return None, 1
    units, axis = max(cands)
    return axis, _smallest_divisor_at_least(units, min(want, units))


# ---------------------------------------------------------------------------
# the general case: mixed-radix refinement -> per-axis collective chain
# ---------------------------------------------------------------------------

_MAX_CHAIN_RANKS = 4096


def _linear_weight(vals):
    """The weight w when ``vals`` is v -> v*w (w may be 0), else None (JAX
    ``reshard.py:280``)."""
    w = vals[1] if len(vals) > 1 else 0
    return w if all(v == k * w for k, v in enumerate(vals)) else None


def _side_coords(own, pos, nranks):
    """Per-rank block coordinates in canonical order; None unless every
    rank owns exactly one block (JAX ``reshard.py:286``)."""
    out = [None] * nranks
    for ci, ranks in own.items():
        for r in ranks:
            c = pos.get(r)
            if c is None or out[c] is not None:
                return None
            out[c] = ci
    return None if any(v is None for v in out) else out


def _digitize(ndim, s_grid, s_own, d_grid, d_own):
    """``(canon_ranks, digit_sizes, strides, src_comp, dst_comp)``, the
    common mixed-radix refinement of the two owner maps, or None when
    there is none (JAX ``reshard.py:299``)."""
    ranks = sorted({r for o in s_own.values() for r in o})
    nr = len(ranks)
    if nr > _MAX_CHAIN_RANKS or nr < 2:
        return None
    ps = math.prod(s_grid) if s_grid else 1
    pd = math.prod(d_grid) if d_grid else 1
    if ps == nr:
        canon_grid, canon_own = s_grid, s_own
    elif pd == nr:
        canon_grid, canon_own = d_grid, d_own
    else:
        return None
    canon = []
    for coords in itertools.product(*(range(g) for g in canon_grid)):
        o = canon_own.get(coords, ())
        if len(o) != 1:
            return None
        canon.append(o[0])
    pos = {r: i for i, r in enumerate(canon)}
    if len(pos) != nr:
        return None
    scoord = _side_coords(s_own, pos, nr)
    dcoord = _side_coords(d_own, pos, nr)
    if scoord is None or dcoord is None:
        return None
    if any(scoord[0]) or any(dcoord[0]):     # not start-aligned
        return None
    digits = []                              # (size, stride), major->minor
    stride = nr
    for g in canon_grid:
        stride //= g
        if g > 1:
            digits.append((g, stride))
    for coord in (scoord, dcoord):
        for d in range(ndim):
            k = 0
            while k < len(digits):
                q, t = digits[k]
                vals = [coord[v * t][d] for v in range(q)]
                if _linear_weight(vals) is not None:
                    k += 1
                    continue
                for a in range(2, q):        # split into (q//a, a)
                    if q % a:
                        continue
                    if all(vals[v] == vals[(v // a) * a] + vals[v % a]
                           for v in range(q)):
                        digits[k:k + 1] = [(q // a, t * a), (a, t)]
                        break
                else:
                    return None
    comps = []
    for coord in (scoord, dcoord):
        wmap = {}                            # digit -> (dim, weight)
        for m, (q, t) in enumerate(digits):
            hot = [d for d in range(ndim) if coord[t][d]]
            if len(hot) > 1:
                return None
            if hot:
                wmap[m] = (hot[0], coord[t][hot[0]])
        comp = []
        for d in range(ndim):
            mine = sorted((w, m) for m, (dd, w) in wmap.items() if dd == d)
            exp = 1
            for w, m in mine:                # minor -> major: exact radix
                if w != exp:
                    return None
                exp *= digits[m][0]
            comp.append(tuple(m for _w, m in reversed(mine)))
        for c in range(nr):
            for d in range(ndim):
                v = sum(((c // digits[m][1]) % digits[m][0]) * wmap[m][1]
                        for m in comp[d])
                if v != coord[c][d]:
                    return None
        comps.append(tuple(comp))
    sizes = tuple(q for q, _t in digits)
    strides = tuple(t for _q, t in digits)
    return tuple(canon), sizes, strides, comps[0], comps[1]


def _digit_cross_domain(canon, q, t):
    """True when some group along this digit spans failure domains
    (``resilience.domains``; JAX ``reshard.py:385``)."""
    topo = _dom.topology()

    def dom(r):
        try:
            return topo.domain_of(r)
        except KeyError:
            return ("uncovered", r)

    nr = len(canon)
    for base in range(nr):
        if (base // t) % q:
            continue                         # not a group anchor
        if len({dom(canon[base + v * t]) for v in range(q)}) > 1:
            return True
    return False


def _schedule_chain(sizes, src_comp, dst_comp, cross):
    """Ordered ``(kind, digit, src_dim, dst_dim)`` ops turning the source
    composites into the destination composites, intra-domain exchanges
    first when several are legal (JAX ``reshard.py:409``)."""
    state = [list(c) for c in src_comp]
    target = [list(c) for c in dst_comp]
    loc = {m: (j, k) for j, c in enumerate(dst_comp)
           for k, m in enumerate(c)}
    ops = []
    for _ in range(4 * len(sizes) + 4):
        if state == target:
            return ops
        cands = []
        for i, st in enumerate(state):
            if not st:
                continue
            m = st[-1]
            at = loc.get(m)
            if at is not None:
                j, k = at
                if j != i and len(state[j]) == k and \
                        state[j] == target[j][:k]:
                    cands.append((cross.get(m, False), i,
                                  ("a2a", m, i, j)))
        if cands:
            op = min(cands)[2]
            _kind, m, i, j = op
            state[i].pop()
            state[j].append(m)
            ops.append(op)
            continue
        placed = {m for st in state for m in st}
        progressed = False
        for j, tg in enumerate(target):
            k = len(state[j])
            if k < len(tg) and state[j] == tg[:k] and tg[k] not in placed:
                ops.append(("slice", tg[k], None, j))
                state[j].append(tg[k])
                progressed = True
                break
        if progressed:
            continue
        # gathering dim j's extra tail digits first lets a digit a2a into
        # j (gather + a2a beats gather + gather for a mesh-axis transpose)
        for i, st in enumerate(state):
            if not st:
                continue
            at = loc.get(st[-1])
            if at is None:
                continue
            j, k = at
            if j != i and len(state[j]) > k and \
                    state[j][:k] == target[j][:k]:
                ops.append(("gather", state[j][-1], j, None))
                state[j].pop()
                progressed = True
                break
        if progressed:
            continue
        for i, st in enumerate(state):
            if st and st != target[i][:len(st)]:
                ops.append(("gather", st[-1], i, None))
                st.pop()
                progressed = True
                break
        if not progressed:
            return None
    return None


def _pick_step_chunking(local, itemsize, concat_dim, split_dim, q,
                        chunk_target):
    """``(chunk_axis, nchunks)`` of one chain step over its local shape;
    -1 = unchunked (JAX ``reshard.py:483``)."""
    lbytes = math.prod(local) * itemsize
    want = -(-lbytes // chunk_target)
    if want <= 1:
        return -1, 1
    cands = []
    for d in range(len(local)):
        if d == concat_dim:
            continue
        units = local[d] // q if d == split_dim else local[d]
        if units > 1:
            cands.append((units, d))
    if not cands:
        return -1, 1
    units, axis = max(cands)
    return axis, _smallest_divisor_at_least(units, min(want, units))


def _chain_steps(shape, itemsize, sizes, strides, src_comp, ops, canon,
                 cross, chunk_target):
    """The scheduled ops as steps with their chunking and moved bytes,
    the staging high-water and the intra/cross split (JAX
    ``reshard.py:504``)."""
    nr = len(canon)
    local = [shape[d] // math.prod([sizes[m] for m in src_comp[d]] or [1])
             for d in range(len(shape))]
    steps = []
    moved = staging = intra = crossb = 0
    for kind, m, i, j in ops:
        q = sizes[m]
        lelems = math.prod(local) if local else 1
        ca, nc, mstep, stg = -1, 1, 0, 0
        if kind == "a2a":
            ca, nc = _pick_step_chunking(local, itemsize, i, j, q,
                                         chunk_target)
            mstep = nr * (lelems - lelems // q) * itemsize
            local[i] *= q
            local[j] //= q
            stg = -(-(lelems * itemsize) // max(nc, 1))
        elif kind == "gather":
            local[i] *= q
            ca, nc = _pick_step_chunking(local, itemsize, i, None, q,
                                         chunk_target)
            mstep = nr * lelems * (q - 1) * itemsize
            stg = -(-(lelems * q * itemsize) // max(nc, 1))
        else:                                # slice: no comm, no staging
            local[j] //= q
        moved += mstep
        staging = max(staging, stg)
        if cross.get(m, False) and kind != "slice":
            crossb += mstep
        else:
            intra += mstep
        steps.append((kind, m, q, -1 if i is None else i,
                      -1 if j is None else j, ca, nc, mstep))
    return tuple(steps), moved, staging, intra, crossb


def _try_chain(shape, itemsize, s_grid, s_own, d_grid, d_own, total,
               chunk_target, pad_shape=()):
    """A ``chain`` plan for the even general case (on ``pad_shape`` for
    ceil-uneven layouts), or None (JAX ``reshard.py:547``)."""
    work = tuple(pad_shape) or tuple(shape)
    dig = _digitize(len(work), s_grid, s_own, d_grid, d_own)
    if dig is None:
        return None
    canon, sizes, strides, src_comp, dst_comp = dig
    if not sizes:
        return None
    for comp in (src_comp, dst_comp):
        for d in range(len(work)):
            if work[d] % math.prod([sizes[m] for m in comp[d]] or [1]):
                return None
    cross = {m: _digit_cross_domain(canon, sizes[m], strides[m])
             for m in range(len(sizes))}
    ops = _schedule_chain(sizes, src_comp, dst_comp, cross)
    if not ops:
        return None
    steps, moved, staging, intra, crossb = _chain_steps(
        work, itemsize, sizes, strides, src_comp, ops, canon, cross,
        chunk_target)
    return ReshardPlan("chain", tuple(shape), itemsize, moved, total,
                       nparts=len(canon), ranks=canon,
                       nchunks=max(s[6] for s in steps),
                       steps=steps, mesh_shape=sizes, src_comp=src_comp,
                       dst_comp=dst_comp,
                       pad_shape=tuple(pad_shape)
                       if tuple(pad_shape) != tuple(shape) else (),
                       staging_bytes=staging, intra_bytes=intra,
                       cross_bytes=crossb)


def _try_pad_chain(shape, itemsize, s_cuts, s_own, d_cuts, d_own, total,
                   chunk_target):
    """Start-aligned ceil-uneven layouts whose per-dim pads agree: the
    chain of the padded even analog (JAX ``reshard.py:582``)."""
    pad = []
    for d, n in enumerate(shape):
        need = None
        for cuts in (s_cuts[d], d_cuts[d]):
            g = len(cuts) - 1
            if g <= 1:
                continue
            c = cuts[1] - cuts[0]
            if c <= 0 or list(cuts) != [min(k * c, n) for k in range(g + 1)]:
                return None                  # not start-aligned ceil cuts
            want = g * c
            if need is None:
                need = want
            elif need != want:
                return None                  # the sides' pads disagree
        pad.append(need if need is not None else n)
    if tuple(pad) == tuple(shape):
        return None
    return _try_chain(shape, itemsize, _grid_of(s_cuts), s_own,
                      _grid_of(d_cuts), d_own, total, chunk_target,
                      pad_shape=tuple(pad))


def _try_gather_put(shape, itemsize, s_grid, s_own, d_own, total,
                    chunk_target):
    """A replicated destination on a proper subset of the source ranks:
    the chain toward the layout replicated on every source rank, then the
    subset keeps its copies (JAX ``reshard.py:610``)."""
    s_ranks = sorted({r for o in s_own.values() for r in o})
    d_ranks = {r for o in d_own.values() for r in o}
    if not d_ranks < set(s_ranks):
        return None
    if len(d_own) >= len(d_ranks):
        return None
    ndim = len(shape)
    rep_own = {tuple([0] * ndim): tuple(s_ranks)}
    plan = _try_chain(shape, itemsize, s_grid, s_own,
                      tuple([1] * ndim), rep_own, total, chunk_target)
    if plan is None:
        return None
    return dataclasses.replace(plan, strategy="gather_put")


def _build_plan(shape, itemsize, src, dst, chunk_target) -> ReshardPlan:
    """The plan between the layouts ``src`` and ``dst``, each ``(cuts,
    owners)`` (JAX ``reshard.py:649``, which takes shardings and reads
    their layouts first)."""
    total = math.prod(shape) * itemsize if shape else itemsize

    def fallback(reason, moved=None):
        return ReshardPlan("device_put", shape, itemsize,
                           total if moved is None else moved, total,
                           reason=reason)

    if src == dst:
        return ReshardPlan("noop", shape, itemsize, 0, total)
    s_cuts, s_own = src
    d_cuts, d_own = dst
    try:
        moved = _moved_elems(shape, s_cuts, s_own, d_cuts, d_own) * itemsize
    except ValueError as e:
        return fallback(f"opaque layouts ({type(e).__name__})")
    s_ranks_all = {r for own in s_own.values() for r in own}
    d_ranks_all = {r for own in d_own.values() for r in own}
    s_grid, d_grid = _grid_of(s_cuts), _grid_of(d_cuts)
    even = all(_uniform(c) for c in s_cuts) and \
        all(_uniform(c) for c in d_cuts)
    if s_ranks_all != d_ranks_all:
        if even and d_ranks_all < s_ranks_all:
            gp = _try_gather_put(shape, itemsize, s_grid, s_own, d_own,
                                 total, chunk_target)
            if gp is not None:
                return gp
        return fallback("device sets differ", moved)
    if not even:
        pc = _try_pad_chain(shape, itemsize, s_cuts, s_own, d_cuts, d_own,
                            total, chunk_target)
        if pc is not None:
            return pc
        if any(not _uniform(c) for c in s_cuts):
            return fallback("uneven source shards", moved)
        return fallback("uneven destination shards", moved)
    s_sh = [d for d, g in enumerate(s_grid) if g > 1]
    d_sh = [d for d, g in enumerate(d_grid) if g > 1]

    why = None
    if len(s_sh) > 1 or len(d_sh) > 1:
        why = "multi-dim chunk grid"
    elif s_sh and d_sh:
        i, j = s_sh[0], d_sh[0]
        p = s_grid[i]
        if i == j or d_grid[j] != p:
            why = "incompatible repartition widths"
        else:
            src_order = _singleton_rank_order(s_own, s_grid, i)
            dst_order = _singleton_rank_order(d_own, d_grid, j)
            if src_order is None or dst_order is None or \
                    src_order != dst_order:
                why = "replicated blocks or rank order differs"
            else:
                ca, nc = _pick_chunking(shape, itemsize, i, j, p,
                                        "all_to_all", chunk_target)
                return ReshardPlan("all_to_all", shape, itemsize, moved,
                                   total, src_dim=i, dst_dim=j, nparts=p,
                                   ranks=src_order, chunk_axis=ca,
                                   nchunks=nc)
    elif s_sh:
        i = s_sh[0]
        p = s_grid[i]
        src_order = _singleton_rank_order(s_own, s_grid, i)
        if src_order is None:
            why = "replicated source blocks"
        else:
            ca, nc = _pick_chunking(shape, itemsize, i, None, p,
                                    "all_gather", chunk_target)
            return ReshardPlan("all_gather", shape, itemsize, moved, total,
                               src_dim=i, dst_dim=None, nparts=p,
                               ranks=src_order, chunk_axis=ca, nchunks=nc)
    elif d_sh:
        j = d_sh[0]
        p = d_grid[j]
        dst_order = _singleton_rank_order(d_own, d_grid, j)
        if dst_order is None:
            why = "replicated destination blocks"
        else:
            src_everywhere = all(set(dst_order) <= set(own)
                                 for own in s_own.values())
            if not src_everywhere:
                why = "source not replicated on dst devices"
            else:
                return ReshardPlan("local_slice", shape, itemsize, 0,
                                   total, src_dim=None, dst_dim=j,
                                   nparts=p, ranks=dst_order)
    elif moved == 0:
        return fallback("placement-equal", moved=0)
    else:
        why = "no sharded dims on either side"
    ch = _try_chain(shape, itemsize, s_grid, s_own, d_grid, d_own, total,
                    chunk_target)
    if ch is not None:
        return ch
    return fallback(why, moved)


def _fallback_reason(reason: str) -> str:
    """The canonical class of a ``device_put`` plan's reason: uneven,
    device_set, dtype, multi_axis or shape (JAX ``reshard.py:1031``)."""
    r = reason.lower()
    if "uneven" in r or "divisible" in r:
        return "uneven"
    if "device set" in r or "not replicated on dst" in r:
        return "device_set"
    if "dtype" in r:
        return "dtype"
    if "multi-dim" in r or "incompatible" in r or "rank order" in r \
            or "replicated" in r:
        return "multi_axis"
    return "shape"


# ---------------------------------------------------------------------------
# the plan cache
# ---------------------------------------------------------------------------


def _key(layout) -> tuple:
    cuts, owners = layout
    return (tuple(tuple(c) for c in cuts), tuple(sorted(owners.items())))


def _regions(src_cuts, dst_cuts) -> tuple:
    per_dim = [L.cut_intersections(sc, dc)
               for sc, dc in zip(src_cuts, dst_cuts)]
    return tuple((tuple(c[0] for c in combo), tuple(c[1] for c in combo),
                  tuple((c[2], c[3]) for c in combo))
                 for combo in itertools.product(*per_dim))


@functools.lru_cache(maxsize=512)
def _plan_cached(shape, itemsize, src_key, dst_key, chunk_target,
                 topology_key) -> ReshardPlan:
    """The cached plan (JAX ``_plan_cached``, ``reshard.py:634``).
    ``topology_key`` is part of the key because the chain's
    ``intra_bytes``/``cross_bytes`` read the topology, which the JAX cache
    leaves out (ROADMAP C6)."""
    del topology_key
    # the miss body: once per distinct layout pair
    _tm.count("reshard.plan_builds")
    src = ([list(c) for c in src_key[0]], dict(src_key[1]))
    dst = ([list(c) for c in dst_key[0]], dict(dst_key[1]))
    plan = dataclasses.replace(
        _build_plan(shape, itemsize, src, dst, chunk_target),
        regions=_regions(src[0], dst[0]))
    if _tm.enabled():
        _tm.event("reshard", "plan", strategy=plan.strategy,
                  shape=list(shape), moved_bytes=plan.moved_bytes,
                  total_bytes=plan.total_bytes, nparts=plan.nparts,
                  nchunks=plan.nchunks, reason=plan.reason)
    return plan


def _plan(shape, itemsize, src, dst) -> ReshardPlan:
    return _plan_cached(tuple(int(s) for s in shape), int(itemsize),
                        _key(src), _key(dst), _chunk_target_bytes(),
                        _dom.topology().key())


def plan_stats() -> dict:
    """Plan-cache statistics: hits, misses and size (JAX
    ``reshard.py:781``)."""
    ci = _plan_cached.cache_info()
    return {"hits": ci.hits, "misses": ci.misses, "size": ci.currsize}


def _itemsize(d: DArray) -> int:
    return torch.empty(0, dtype=d.dtype).element_size()


def plan_reshard(d: DArray, pids, cuts) -> ReshardPlan:
    """Plan moving ``d`` onto the layout ``(pids, cuts)`` (JAX
    ``reshard.py:754``); cached, and nothing moves."""
    d._check_open()
    _tm.count("reshard.plan_requests")
    return _plan(d.dims, _itemsize(d), layout_of(d.pids, d.cuts),
                 layout_of(pids, cuts))


def same_layout(d: DArray, pids, cuts) -> bool:
    return (d.cuts == [list(c) for c in cuts]
            and np.array_equal(d.pids, pids))


# ---------------------------------------------------------------------------
# lowering
# ---------------------------------------------------------------------------


def _cell(ndim: int, dim: int, k: int) -> tuple:
    return tuple(k if x == dim else 0 for x in range(ndim))


def relayout_plain(d: DArray, pids, cuts) -> np.ndarray:
    """``d``'s cells on the layout ``(pids, cuts)``, filled region by
    region from the chunk intersections with ``.to(device)`` copies: the
    ``device_put`` lowering (JAX ``_device_put_path``, ``reshard.py:1016``),
    and the plain version that the collective lowerings are held
    against."""
    pids = np.asarray(pids)
    parts = np.empty(tuple(pids.shape), dtype=object)
    for ci in np.ndindex(*pids.shape):
        shape = tuple(c[j + 1] - c[j] for c, j in zip(cuts, ci))
        parts[ci] = torch.empty(shape, dtype=d.dtype,
                                device=L.device_of(int(pids[ci])))
    for src, dst, bounds in _regions(d.cuts, cuts):
        s = tuple(slice(lo - d.cuts[k][j], hi - d.cuts[k][j])
                  for k, (j, (lo, hi)) in enumerate(zip(src, bounds)))
        t = tuple(slice(lo - cuts[k][j], hi - cuts[k][j])
                  for k, (j, (lo, hi)) in enumerate(zip(dst, bounds)))
        out = parts[dst]
        out[t] = d.part(src)[s].to(out.device)
    return parts


def _boxes(plan: ReshardPlan, comp) -> list[list[tuple[int, int]]]:
    """Each canonical rank's global box ``[(lo, hi), ...]`` under the
    per-dim mesh-axis composites ``comp``, on the plan's even shape."""
    work = plan.pad_shape or plan.shape
    sizes = plan.mesh_shape
    strides = [math.prod(sizes[m + 1:]) for m in range(len(sizes))]
    out = []
    for c in range(len(plan.ranks)):
        box = []
        for d, n in enumerate(work):
            idx = 0
            for m in comp[d]:
                idx = idx * sizes[m] + (c // strides[m]) % sizes[m]
            blk = n // math.prod([sizes[m] for m in comp[d]] or [1])
            box.append((idx * blk, (idx + 1) * blk))
        out.append(box)
    return out


def _stages(plan: ReshardPlan) -> list[list[list[int]]]:
    """The composites before the first step and after each step."""
    state = [list(c) for c in plan.src_comp]
    stages = [[list(c) for c in state]]
    for kind, m, _q, i, j, *_ in plan.steps:
        if kind in ("a2a", "gather"):
            if state[i][-1] != m:
                raise AssertionError(f"step {kind} on digit {m} does not "
                                     f"leave dim {i} minor-first")
            state[i].pop()
        if kind in ("a2a", "slice"):
            state[j].append(m)
        stages.append([list(c) for c in state])
    if [tuple(c) for c in state] != [tuple(c) for c in plan.dst_comp]:
        raise AssertionError("the chain's steps do not reach dst_comp")
    return stages


def _window(box, within, shape) -> tuple:
    """``box`` clipped to the array, in coordinates local to the box
    ``within`` (whose tensor holds ``within`` clipped to the array)."""
    return tuple((min(lo, n) - min(w0, n), min(hi, n) - min(w0, n))
                 for (lo, hi), (w0, _), n in zip(box, within, shape))


def _groups(plan: ReshardPlan, m: int) -> list[list[int]]:
    """The canonical ranks that differ only in digit ``m``, each group in
    digit order."""
    sizes = plan.mesh_shape
    t = math.prod(sizes[m + 1:])
    q = sizes[m]
    return [[base + v * t for v in range(q)]
            for base in range(len(plan.ranks)) if not (base // t) % q]


def _run_chain(plan: ReshardPlan, blocks: list[torch.Tensor],
               keep=None) -> list:
    """Run a ``chain``/``gather_put`` plan over the canonical ranks'
    source tensors ``blocks`` (JAX ``_chain_jit`` and ``_run_chain``,
    ``reshard.py:915``, ``:985``; the windows stand for the pad and
    slice-back of ``_pad_jit`` :966 and ``_slice_back_jit`` :977).
    Returns each canonical rank's destination tensor (None for ranks
    outside ``keep``, a set of canonical indices whose outputs the last
    step writes; None = all).  Each intermediate step's outputs are in
    the memory ledger's ``reshard.chain`` staging gauge until the next
    step has read them."""
    shape = plan.shape
    stages = _stages(plan)
    nsteps = len(plan.steps)
    cur = list(blocks)
    staged = None
    # a chain from one-rank-a-cell sources starts with a collective: a
    # slice only follows the gather of its digit
    k = 0
    try:
        while k < nsteps:  # dalint: disable=DAL012 — the plan is computed from the two layouts alone, the same on every process
            kind, m, _q, i, j = plan.steps[k][:5]
            nxt = k + 1
            while nxt < nsteps and plan.steps[nxt][0] == "slice":
                nxt += 1
            inb = _boxes(plan, stages[k])
            outb = _boxes(plan, stages[k + 1])
            winb = _boxes(plan, stages[nxt])
            last = nxt == nsteps
            wins = [None if last and keep is not None and c not in keep
                    else _window(w, o, shape)
                    for c, (w, o) in enumerate(zip(winb, outb))]
            full = [hi - lo for lo, hi in inb[0]]
            cur = chain_step(kind, cur, _groups(plan, m), i,
                             j if j >= 0 else None, full, wins)
            if staged is not None:             # the step's inputs are read
                staged.__exit__(None, None, None)
                staged = None
            if not last:
                staged = _tm.memory.staging(
                    "reshard.chain",
                    sum(t.nbytes for t in cur if t is not None))
                staged.__enter__()
            k = nxt
    finally:
        if staged is not None:
            staged.__exit__(None, None, None)
    return cur


def _check_sources(plan: ReshardPlan, d: DArray) -> list[torch.Tensor]:
    """``d``'s tensors in the plan's canonical rank order, each checked to
    hold the box the plan's source composites give its rank."""
    cell_of = {int(d.pids[ci]): ci for ci in d.cells()}
    boxes = _boxes(plan, plan.src_comp)
    out = []
    for c, r in enumerate(plan.ranks):
        ci = cell_of[r]
        want = [(min(lo, n), min(hi, n))
                for (lo, hi), n in zip(boxes[c], d.dims)]
        have = [(cu[x], cu[x + 1]) for cu, x in zip(d.cuts, ci)]
        if want != have:
            raise AssertionError(f"rank {r} holds {have}, the plan reads "
                                 f"{want}")
        out.append(d.part(ci))
    return out


@contextlib.contextmanager
def _moving(d: DArray, plan: ReshardPlan, op: str):
    """The ``reshard`` span around one planned move, the ``reshard.chunk``
    fault site of a collective plan (before any byte moves, so the source
    is intact for a retry), and the move's accounting (JAX
    ``reshard.py:1116-1190``).  In a job of several processes every plan
    is lowered as one region copy (``_fetched``): the span says so
    (``strategy="region"``, one step, the planned kind under ``plan``),
    no fallback is counted, and the bytes are recorded once, by
    ``multihost.fetch_regions``."""
    job = L.process_count() > 1
    on_card = plan.collective and \
        L.device_of(int(d.pids.flat[0])).type == "cuda"
    with _tm.span("reshard", op=op,
                  strategy="region" if job else plan.strategy,
                  **({"plan": plan.strategy} if job else {}),
                  dispatch="rdma" if on_card else "plain",
                  shape=list(plan.shape),
                  dtype=str(d.dtype).removeprefix("torch."),
                  src_dim=plan.src_dim, dst_dim=plan.dst_dim,
                  nparts=plan.nparts, nsteps=1 if job else len(plan.steps),
                  intra_bytes=plan.intra_bytes, cross_bytes=plan.cross_bytes,
                  **_perf.reshard_cost(plan.total_bytes, plan.moved_bytes)):
        if plan.collective:
            _fl.check("reshard.chunk", strategy=plan.strategy, op=op)
        elif plan.strategy == "device_put" and plan.moved_bytes and not job:
            _tm.count("reshard.collective_fallbacks",
                      reason=_fallback_reason(plan.reason))
        yield
        if _tm.enabled() and not job:
            _tm.record_comm("reshard", plan.moved_bytes, op=op,
                            strategy=(plan.strategy if plan.collective
                                      else "device_put"),
                            shape=list(plan.shape))


def relayout_parts(d: DArray, pids, cuts, *,
                   plan: ReshardPlan | None = None,
                   op: str = "reshard") -> np.ndarray:
    """``d``'s cells on the layout ``(pids, cuts)``.  Returns ``d``'s own
    tensors when the layouts already agree (callers only read them), runs
    the all-to-all kernel for an ``all_to_all`` plan and the chain's steps
    (``chain_step``) for a ``chain`` plan, padded or not; a ``device_put``
    plan is copied region by region (``relayout_plain``).  ``op`` names
    the caller in the ``reshard`` span and the comm record."""
    d._check_open()
    pids = np.asarray(pids)
    if same_layout(d, pids, cuts):  # dalint: disable=DAL010 — same_layout compares two layouts, the same on every process
        return d._parts
    if plan is None:
        plan = plan_reshard(d, pids, cuts)
    with _moving(d, plan, op):
        if L.process_count() > 1:
            return _fetched(d, pids, cuts)
        return _lower(d, pids, cuts, plan)


def _fetched(d: DArray, pids: np.ndarray, cuts) -> np.ndarray:
    """The cross-process lowering of any plan: the one-pass region copy
    of ``relayout_plain``, each process filling its own target cells by
    one ``multihost.fetch_regions`` call (one copy launch a process on
    the card); another process's cells are placeholders."""
    from . import multihost
    cells = list(np.ndindex(*pids.shape))
    got = multihost.fetch_regions(
        [(d, [(c[j], c[j + 1]) for c, j in zip(cuts, ci)],
          L.device_of(int(pids[ci]))) for ci in cells])
    parts = np.empty(tuple(pids.shape), dtype=object)
    for ci, t in zip(cells, got):
        parts[ci] = t
    return parts


def _lower(d: DArray, pids: np.ndarray, cuts, plan: ReshardPlan):
    parts = np.empty(tuple(pids.shape), dtype=object)
    if plan.strategy == "all_to_all":  # dalint: disable=DAL010 — the plan is computed from the two layouts alone, the same on every process
        i, j, p = plan.src_dim, plan.dst_dim, plan.nparts
        outs = ring_all_to_all([d.part(_cell(d.ndim, i, k)) for k in range(p)],
                               split_dim=j, concat_dim=i)
        for q, t in enumerate(outs):
            parts[_cell(d.ndim, j, q)] = t
        return parts
    if plan.strategy == "chain":  # dalint: disable=DAL010 — the plan is computed from the two layouts alone, the same on every process
        outs = _run_chain(plan, _check_sources(plan, d))
        pos = {r: c for c, r in enumerate(plan.ranks)}
        for ci in np.ndindex(*pids.shape):
            parts[ci] = outs[pos[int(pids[ci])]]
        return parts
    return relayout_plain(d, pids, cuts)


def reshard(d: DArray, pids, cuts, *, op: str = "reshard",
            plan: ReshardPlan | None = None) -> DArray:
    """Move ``d`` onto the layout ``(pids, cuts)`` by the planned strategy
    (JAX ``reshard.py:1048``): ``d`` itself for a ``noop`` plan, else a new
    DArray whose tensors share nothing with ``d``."""
    pids = np.asarray(pids, dtype=np.int64)
    if plan is None:
        plan = plan_reshard(d, pids, cuts)
    if plan.strategy == "noop":
        return d
    return DArray(relayout_parts(d, pids, cuts, plan=plan, op=op), pids,
                  [list(c) for c in cuts])


def relayout(d: DArray, pids, cuts, *, op: str = "reshard") -> DArray:
    """A new DArray holding ``d``'s values on the layout ``(pids, cuts)``
    (a copy even when the layouts agree)."""
    if same_layout(d, pids, cuts):
        return d.copy()
    return reshard(d, pids, cuts, op=op)


# ---------------------------------------------------------------------------
# the whole array on a list of ranks
# ---------------------------------------------------------------------------


def _replicated(d: DArray, ranks) -> tuple[list, dict]:
    return ([[0, n] for n in d.dims],
            {tuple([0] * d.ndim): tuple(sorted(int(r) for r in ranks))})


def plan_allgather(d: DArray, ranks) -> ReshardPlan:
    """Plan putting the whole of ``d`` on each rank of ``ranks``: the JAX
    planner's plan for the layout replicated on ``ranks``.  That is
    ``all_gather`` for a grid chunked along one dim onto its own ranks,
    ``chain`` (gathers only, padded for ceil cuts) for a grid chunked along
    several, ``gather_put`` for a proper subset of an even grid's ranks,
    else ``device_put``.  Where JAX plans ``device_put`` the port goes
    further: a proper subset of the source ranks that JAX leaves alone (a
    single rank, or a ceil-uneven grid) is ``gather_put`` on the chain
    toward all the source ranks, and a grid chunked along at most one dim
    onto some of its own ranks is ``all_gather`` even when its chunks are
    uneven (the kernel takes blocks of any size).  ``moved_bytes`` is the
    plan's: per receiving rank, the bytes it does not hold yet."""
    d._check_open()
    ranks = [int(r) for r in ranks]
    if len(set(ranks)) != len(ranks):
        raise ValueError(f"allgather ranks repeat: {ranks}")
    _tm.count("reshard.plan_requests")
    src = layout_of(d.pids, d.cuts)
    plan = _plan(d.dims, _itemsize(d), src, _replicated(d, ranks))
    sharded = [k for k, g in enumerate(d.grid) if g > 1]
    own = {int(p) for p in d.pids.flat}
    if plan.strategy == "device_put" and set(ranks) < own:
        # JAX leaves one rank, or a ceil-uneven grid, to device_put
        whole = _plan(d.dims, _itemsize(d), src, _replicated(d, own))
        if whole.strategy == "chain":
            plan = dataclasses.replace(whole, strategy="gather_put")
    if set(ranks) <= own and len(sharded) <= 1 and d.ndim and \
            plan.strategy not in ("all_gather", "noop", "gather_put"):
        dim = sharded[0] if sharded else 0
        plan = dataclasses.replace(
            plan, strategy="all_gather", reason="", src_dim=dim,
            nparts=d.grid[dim],
            ranks=tuple(int(d.pids[_cell(d.ndim, dim, k)])
                        for k in range(d.grid[dim])))
    return plan


def allgather(d: DArray, ranks=None, *,
              op: str = "allgather") -> list[torch.Tensor]:
    """The whole of ``d`` on each rank of ``ranks`` (default: ``d``'s own
    ranks, row-major), one tensor per rank on its device, in the order of
    ``ranks``: the all-gather kernel for an ``all_gather`` plan, the
    chain's steps for ``chain`` and ``gather_put`` (the last step writes
    only the ranks asked for), else assembled region by region.  Moves run
    in a ``reshard`` span named by ``op``, as JAX's gathers (a reshard
    onto a replicated layout) do."""
    ranks = ([int(p) for p in d.pids.flat] if ranks is None
             else [int(r) for r in ranks])
    plan = plan_allgather(d, ranks)
    if L.process_count() > 1:
        from . import multihost
        with _moving(d, plan, op):
            return multihost.fetch_regions(
                [(d, None, L.device_of(r)) for r in ranks])
    if plan.strategy == "noop":  # dalint: disable=DAL010 — the plan is computed from the two layouts alone, the same on every process
        return [d.part(next(iter(d.cells()))).clone()]
    with _moving(d, plan, op):
        return _gather(d, ranks, plan)


def _gather(d: DArray, ranks: list, plan: ReshardPlan) -> list:
    if plan.strategy == "all_gather":  # dalint: disable=DAL010 — the plan is computed from the two layouts alone, the same on every process
        dim = plan.src_dim
        outs = ring_all_gather([d.part(_cell(d.ndim, dim, k))
                                for k in range(plan.nparts)], dim)
        whole = dict(zip(plan.ranks, outs))
        return [whole[r] for r in ranks]
    if plan.strategy in ("chain", "gather_put"):  # dalint: disable=DAL010 — the plan is computed from the two layouts alone, the same on every process
        pos = {r: c for c, r in enumerate(plan.ranks)}
        outs = _run_chain(plan, _check_sources(plan, d),
                          keep={pos[r] for r in ranks})
        return [outs[pos[r]] for r in ranks]
    return [d.full(L.device_of(r)) for r in ranks]
