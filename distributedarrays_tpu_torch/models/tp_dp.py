"""The GSPMD tp/dp layouts of the JAX models as rank-list programs.

The JAX models lay their parameters out over a ``('dp', 'tp')`` mesh
(``distributedarrays_tpu/models/mlp.py:32`` ``make_mesh``, :54
``shard_params``, :70 ``shard_batch``; ``models/transformer.py:89``
``shard_params``) and let GSPMD insert the collectives.  The port runs a
single controller over rank lists, so it writes those collectives out, in
Megatron's form:

- ``Mesh``: the grid of global ranks, ``dp`` rows by ``tp`` columns, in
  ``multihost.global_mesh``'s rank order, so a mesh spans the processes of
  a job.  A value laid out on it is a list with one entry per rank, in
  ``mesh.flat`` order (row-major), on that rank's device; in a job another
  process's ranks hold placeholders on the ``meta`` device.
- ``allreduce``: the sum of a group's blocks on every rank of the group,
  K12 ``ring_reduce_scatter`` of the flattened blocks followed by K10
  ``ring_all_gather`` (``ops/cuda_collectives.py``), the pattern of the
  ``Trainer``'s step: the kernels on CUDA tensors (their cross-process
  routes in a job), their plain versions on CPU tensors.
- ``reduce_tp`` (GSPMD's psum of a row-parallel product: all-reduce
  forward, identity backward), ``copy_tp`` (a replicated activation entering
  a column-parallel product: identity forward, all-reduce backward) and
  ``gather_tp`` (a column-parallel output made whole: K10 forward, each
  rank's own slice backward), each over every tp group of the mesh.
- ``value_and_grads``: each rank's partial loss differentiated with the
  rank's own parameters, then the parameter gradients summed over dp
  (``allreduce`` of one flat buffer a rank, per tp column).

Each tp rank computes its loss from its own copy of the replicated values,
and the backward seeds every rank's copy with 1: under the three
derivatives above each rank then holds the exact gradient of its shard,
and the replicated parameters' gradients are the same bits on every tp
rank.  Plain products stay ``torch.matmul``: JAX computes them outside any
Pallas kernel.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from .. import layout as L
from ..ops.cuda_collectives import ring_all_gather, ring_reduce_scatter
from ..parallel import multihost
from ._autodiff import value_and_grad

__all__ = ["Mesh", "make_mesh", "ShardedParams", "per_rank", "allreduce",
           "reduce_tp", "copy_tp", "gather_tp", "split_rows", "dp_sum", "dp_total",
           "value_and_grads", "check_divides"]


class Mesh:
    """A ``('dp', 'tp')`` grid of global ranks: ``ranks`` is the (dp, tp)
    rank array, ``shape`` maps the axis names to their sizes, as a JAX
    ``Mesh``'s does."""

    axis_names = ("dp", "tp")

    def __init__(self, ranks):
        self.ranks = np.asarray(ranks, dtype=np.int64)
        if self.ranks.ndim != 2:
            raise ValueError(f"a ('dp', 'tp') mesh is 2-D, got "
                             f"{self.ranks.shape}")
        self.dp, self.tp = (int(s) for s in self.ranks.shape)
        self.shape = {"dp": self.dp, "tp": self.tp}
        self.flat = [int(r) for r in self.ranks.reshape(-1)]

    @property
    def size(self) -> int:
        return len(self.flat)

    def tp_groups(self) -> list[list[int]]:
        """Each dp row's indices into ``flat`` (the ranks of a tp group)."""
        return [[d * self.tp + t for t in range(self.tp)]
                for d in range(self.dp)]

    def dp_groups(self) -> list[list[int]]:
        """Each tp column's indices into ``flat``."""
        return [[d * self.tp + t for d in range(self.dp)]
                for t in range(self.tp)]

    def held(self) -> list[int]:
        """The indices into ``flat`` of this process's ranks."""
        return [i for i, r in enumerate(self.flat) if L.is_local(r)]

    def __repr__(self) -> str:
        return f"Mesh(dp={self.dp}, tp={self.tp}, ranks={self.flat})"


def make_mesh(n_devices: int | None = None) -> Mesh:
    """A ``('dp', 'tp')`` mesh over the first ``n_devices`` global ranks
    (default all), tp = 2 when the count is even, as JAX's ``make_mesh``
    takes it over ``jax.devices()``."""
    total = L.nranks()
    n = total if n_devices is None else int(n_devices)
    if not 1 <= n <= total:
        raise ValueError(f"a mesh of {n} ranks from a table of {total}")
    tp = 2 if n % 2 == 0 and n >= 2 else 1
    order = np.asarray(multihost.global_mesh((total,), ("ranks",)))[:n]
    return Mesh(order.reshape(n // tp, tp))


def check_divides(what: dict[str, int], by: int, axis: str) -> None:
    """Raise ``ValueError`` naming the first extent of ``what`` that the
    ``axis`` size ``by`` does not divide."""
    for name, n in what.items():
        if n % by:
            raise ValueError(f"{name} {n} does not divide over {axis} = {by}")


class ShardedParams:
    """A model's parameters laid out over ``mesh``: ``per_rank[i]`` is the
    parameter set of rank ``mesh.flat[i]`` on its device (another process's
    rank: a placeholder set on ``meta``); ``leaves(i)`` lists its tensors
    in a fixed order; ``whole()`` is the JAX-shaped pytree of whole tensors
    (what ``utils.save`` writes, as JAX writes its sharded pytree).
    ``cfg`` is the transformer's ``Config`` (None for the MLP)."""

    def __init__(self, mesh: Mesh, per_rank: list, leaves: Callable,
                 whole: Callable, cfg=None):
        self.mesh, self.per_rank, self.cfg = mesh, per_rank, cfg
        self._leaves, self._whole = leaves, whole

    def leaves(self, i: int) -> list[torch.Tensor]:
        return self._leaves(self.per_rank[i])

    def whole(self):
        return self._whole(self)

    def __len__(self) -> int:
        return len(self.per_rank)


def per_rank(mesh: Mesh, fn: Callable, *lists) -> list:
    """``fn`` of each of this process's ranks' entries of ``lists``; another
    process's ranks get a ``meta`` placeholder of the result's shape (every
    rank's result has one shape on a mesh)."""
    out: list = [None] * mesh.size
    held = mesh.held()
    for i in held:
        out[i] = fn(*(x[i] for x in lists))
    ref = out[held[0]]
    return [o if o is not None else
            torch.empty(ref.shape, dtype=ref.dtype, device="meta")
            for o in out]


# ---------------------------------------------------------------------------
# the collectives over groups of the mesh
# ---------------------------------------------------------------------------


def allreduce(blocks: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The sum of one group's equal-shaped blocks, on every rank of the
    group, the same bits everywhere: the blocks flattened (padded with
    zeros to a multiple of the group), reduce-scattered by K12 and
    all-gathered by K10.  In a job every process calls it for every group,
    in the same order (placeholders for the ranks it does not hold)."""
    blocks = list(blocks)
    p = len(blocks)
    if p == 1:  # dalint: disable=DAL010 — a group's size is the mesh's, the same on every process
        return blocks
    shape, n = blocks[0].shape, blocks[0].numel()
    pad = -n % p

    def flat(b):
        f = b.contiguous().reshape(-1)
        return f if not pad else torch.cat([f, f.new_zeros(pad)])
    whole = ring_all_gather(ring_reduce_scatter([flat(b) for b in blocks],
                                                0), 0)
    return [w.narrow(0, 0, n).view(shape) for w in whole]


def _over(groups, values, fn) -> list:
    """``fn`` of each group's entries of ``values`` (indices into the
    mesh's flat order), written back in place of them."""
    out = list(values)
    for idx in groups:
        for i, r in zip(idx, fn([values[i] for i in idx])):
            out[i] = r
    return out


class _ReduceTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, groups, *xs):
        return tuple(_over(groups, xs, allreduce))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *grads)


class _CopyTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, groups, *xs):
        ctx.groups = groups
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *_over(ctx.groups, grads, allreduce))


class _GatherTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, groups, dim, *xs):
        ctx.groups, ctx.dim, ctx.width = groups, dim, xs[0].shape[dim]
        return tuple(_over(groups, xs, lambda b: ring_all_gather(b, dim)))

    @staticmethod
    def backward(ctx, *grads):
        out = list(grads)
        w = ctx.width
        for idx in ctx.groups:
            for j, i in enumerate(idx):
                out[i] = grads[i].narrow(ctx.dim, j * w, w)
        return (None, None, *out)


def reduce_tp(mesh: Mesh, xs: Sequence[torch.Tensor]) -> list:
    """Each tp group's row-parallel partial sums all-reduced (the backward
    hands each rank its own gradient)."""
    if mesh.tp == 1:
        return list(xs)
    return list(_ReduceTP.apply(mesh.tp_groups(), *xs))


def copy_tp(mesh: Mesh, xs: Sequence[torch.Tensor]) -> list:
    """A replicated activation entering column-parallel products: the same
    tensors forward, the tp group's gradients all-reduced backward."""
    if mesh.tp == 1:
        return list(xs)
    return list(_CopyTP.apply(mesh.tp_groups(), *xs))


def gather_tp(mesh: Mesh, xs: Sequence[torch.Tensor], dim: int) -> list:
    """Each tp group's column-parallel outputs concatenated along ``dim`` on
    every rank of it (K10); the backward hands each rank its own slice."""
    if mesh.tp == 1:
        return list(xs)
    return list(_GatherTP.apply(mesh.tp_groups(), dim % xs[0].ndim, *xs))


# ---------------------------------------------------------------------------
# batches and gradients
# ---------------------------------------------------------------------------


def split_rows(mesh: Mesh, x, what: str = "batch") -> list[torch.Tensor]:
    """A whole host or device array as its dp row blocks, one entry a rank
    (replicated over tp) on the rank's device; a rank list (already split)
    is returned as it is."""
    if isinstance(x, (list, tuple)):
        if len(x) != mesh.size:
            raise ValueError(f"{len(x)} {what} blocks for a mesh of "
                             f"{mesh.size} ranks")
        return list(x)
    x = torch.as_tensor(x)
    check_divides({f"{what} rows": x.shape[0]}, mesh.dp, "dp")
    rows = x.tensor_split(mesh.dp, 0)
    return [rows[i // mesh.tp].to(L.device_of(r))
            for i, r in enumerate(mesh.flat)]


def dp_sum(mesh: Mesh, per_rank: list[list[torch.Tensor]]) -> list[list]:
    """Each rank's tensors summed over its tp column's dp ranks: one flat
    buffer a rank and dtype, one ``allreduce`` a column and dtype."""
    if mesh.dp == 1:
        return per_rank
    held = set(mesh.held())
    ref = per_rank[min(held)]
    out = [None if ts is None else list(ts) for ts in per_rank]
    for dt in dict.fromkeys(t.dtype for t in ref):  # dalint: disable=DAL012 — the parameters' dtypes are the same on every rank and process
        pos = [j for j, t in enumerate(ref) if t.dtype == dt]
        total = sum(ref[j].numel() for j in pos)
        flats = [torch.cat([per_rank[i][j].reshape(-1) for j in pos])
                 if i in held else torch.empty(total, dtype=dt, device="meta")
                 for i in range(mesh.size)]
        summed = _over(mesh.dp_groups(), flats, allreduce)
        for i in held:
            for j, piece in zip(pos, summed[i].split(
                    [ref[j].numel() for j in pos])):
                out[i][j] = piece.view(ref[j].shape)
    return out


def value_and_grads(sp: ShardedParams, shares: Callable[[], list]):
    """``(loss, grads)``: ``shares()`` gives each rank's partial loss (its
    dp row's part of the global mean, the same on the ranks of a tp group);
    their sum over this process's ranks is differentiated with respect to
    its ranks' parameters, the gradients summed over dp (``dp_sum``), and
    the loss is the partials summed over dp (``allreduce``, the same bits
    on every rank).  ``grads[i]`` follows ``sp.leaves(i)`` (None for
    another process's rank)."""
    mesh = sp.mesh
    own = mesh.held()
    if multihost.in_job():
        idle = set(range(L.process_count())) - {L.process_of(r)
                                                 for r in mesh.flat}
        if idle:
            raise ValueError(f"processes {sorted(idle)} hold no rank of the "
                             "mesh: in a job every process takes part in "
                             "the step with a rank of its own")
    leaves = [t for i in own for t in sp.leaves(i)]
    parts: list = []

    def total():
        parts.extend(shares())
        acc = parts[own[0]]
        for i in own[1:]:
            acc = acc + parts[i].to(acc.device)
        return acc

    _, flat = value_and_grad(total, leaves)
    n = len(sp.leaves(own[0]))
    grads: list = [None] * mesh.size
    for j, i in enumerate(own):
        grads[i] = list(flat[j * n:(j + 1) * n])
    return dp_total(mesh, [p.detach() for p in parts]), dp_sum(mesh, grads)


def dp_total(mesh: Mesh, shares: list) -> torch.Tensor:
    """The ranks' partial losses summed over dp (``allreduce`` a tp
    column): the loss, the same bits on every rank, as this process's
    first rank holds it."""
    return _over(mesh.dp_groups(), [x.reshape(1) for x in shares],
                 allreduce)[mesh.held()[0]].reshape(())
