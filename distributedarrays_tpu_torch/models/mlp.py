"""The demonstrator MLP: parameters, forward, loss and one SGD step.

PyTorch counterpart of ``init_params``, ``forward``, ``loss_fn`` and
``train_step`` in ``distributedarrays_tpu/models/mlp.py``.  Parameters
keep the JAX pytree: a list of ``{"w": (in, out), "b": (out,)}`` dicts of
tensors.  The activation between layers is GELU with the tanh
approximation (``jax.nn.gelu``'s default).  ``init_params`` draws from a
``torch.Generator``, whose stream differs from ``jax.random``'s.
``train_step`` updates the parameters in place (the JAX step donates its
buffers and returns new ones).

The tp/dp layouts: ``make_mesh`` gives a ``('dp', 'tp')`` mesh of global
ranks (``models.tp_dp``), ``shard_params`` lays the layers out
Megatron-style (even layers column-parallel, ``w`` and ``b`` split on the
output features; odd layers row-parallel, ``w`` split on the input
features and ``b`` replicated, added once after the tp all-reduce), and
``shard_batch`` splits the rows over dp.  ``forward``, ``loss_fn`` and
``train_step`` take the sharded parameters and the sharded (or whole)
batch: each tp rank computes its own shard, the row-parallel partial sums
are all-reduced over tp and the gradients over dp (K12 + K10 on the card),
and a column-parallel last layer's output is gathered (K10).  ``unshard``
gives back the whole pytree.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

from .. import layout as L
from ..parallel.collectives import pconcat
from ._autodiff import sgd_, value_and_grad
from .tp_dp import (Mesh, ShardedParams, check_divides, copy_tp, dp_total,
                    gather_tp, make_mesh, per_rank, reduce_tp, split_rows,
                    value_and_grads)

__all__ = ["init_params", "forward", "loss_fn", "train_step", "make_mesh",
           "shard_params", "shard_batch", "unshard"]


def init_params(generator: torch.Generator | None, sizes: Sequence[int],
                dtype=torch.bfloat16, device=None) -> list[dict]:
    """Layer weights (in, out), drawn ``normal * sqrt(2 / in)`` in
    ``dtype``, and zero biases, on ``device`` (default: the generator's)."""
    if device is None:
        device = generator.device if generator is not None else "cpu"
    params = []
    for a, b in zip(sizes, sizes[1:]):
        w = torch.randn((a, b), generator=generator, device=device)
        w = w.to(dtype) * torch.tensor(math.sqrt(2.0 / a), dtype=dtype,
                                       device=device)
        params.append({"w": w, "b": torch.zeros(b, dtype=dtype,
                                                device=device)})
    return params


def _leaves(params) -> list[torch.Tensor]:
    return [t for layer in params for t in (layer["b"], layer["w"])]


def shard_params(params, mesh: Mesh) -> ShardedParams:
    """Tensor-parallel layout (JAX ``models/mlp.py:54``): even layers split
    ``w``'s output features and ``b`` over tp, odd layers ``w``'s input
    features with ``b`` replicated; every layer replicated over dp.  One
    layer list a rank, on its device (another process's rank: placeholders
    on ``meta``).  Raises ``ValueError`` naming the width that tp does not
    divide."""
    tp = mesh.tp
    for i, layer in enumerate(params):
        col = i % 2 == 0
        check_divides({f"layer {i} {'output' if col else 'input'} "
                       f"features": layer["w"].shape[1 if col else 0]},
                      tp, "tp")
    out = []
    for j, r in enumerate(mesh.flat):
        dev, t = L.device_of(r), j % tp

        def place(x):
            return torch.empty(x.shape, dtype=x.dtype, device=dev) \
                if dev.type == "meta" else x.to(dev, copy=True).contiguous()
        layers = []
        for i, layer in enumerate(params):
            w, b = layer["w"], layer["b"]
            if i % 2 == 0:
                w, b = w.tensor_split(tp, 1)[t], b.tensor_split(tp, 0)[t]
            else:
                w = w.tensor_split(tp, 0)[t]
            layers.append({"w": place(w), "b": place(b)})
        out.append(layers)
    return ShardedParams(mesh, out, _leaves, unshard)


def shard_batch(x, y, mesh: Mesh):
    """The batch's rows split over dp, replicated over tp: two rank lists
    (JAX ``models/mlp.py:70``)."""
    return split_rows(mesh, x), split_rows(mesh, y)


def unshard(sharded: ShardedParams) -> list[dict]:
    """The whole layer list, bit for bit, on this process's first rank's
    device (in a job on every process, by one exchange)."""
    row = sharded.per_rank[:sharded.mesh.tp]
    lists, dims = [], []
    for i in range(len(row[0])):
        col = i % 2 == 0
        lists += [[r[i]["w"] for r in row], [r[i]["b"] for r in row]]
        dims += [1 if col else 0, 0 if col else None]
    whole = pconcat(lists, dims)
    dev = L.local_device()
    return [{"w": whole[2 * i].to(dev), "b": whole[2 * i + 1].to(dev)}
            for i in range(len(row[0]))]


def _tp_forward(sp: ShardedParams, xs: list) -> list:
    """Each rank's whole prediction for its dp row's inputs."""
    mesh, ps = sp.mesh, sp.per_rank
    n = len(ps[mesh.held()[0]])
    h = xs
    for i in range(n):
        if i % 2 == 0:                       # column-parallel
            h = per_rank(mesh, lambda x, p: x @ p[i]["w"] + p[i]["b"],
                         copy_tp(mesh, h), ps)
        else:                                # row-parallel, b added once
            h = per_rank(mesh, lambda x, p: x + p[i]["b"], reduce_tp(
                mesh, per_rank(mesh, lambda x, p: x @ p[i]["w"], h, ps)), ps)
        if i < n - 1:
            h = per_rank(mesh, lambda x: F.gelu(x, approximate="tanh"), h)
    return gather_tp(mesh, h, -1) if n % 2 else h


def _tp_shares(sp: ShardedParams, x, y) -> list:
    """Each rank's part of the mean squared error: its dp row's total over
    the global count."""
    mesh = sp.mesh
    xs, ys = split_rows(mesh, x), split_rows(mesh, y)
    pred = _tp_forward(sp, xs)
    ref = ys[mesh.held()[0]]
    count = float(ref.shape[0] * mesh.dp * ref[0].numel())
    return per_rank(mesh, lambda p, t: torch.square(
        p.float() - t.float()).sum() / count, pred, ys)


def forward(params, x) -> torch.Tensor:
    """The MLP's output; on the tp/dp layout of a whole or ``shard_batch``
    input, whole on this process's first rank's device."""
    if isinstance(params, ShardedParams):
        mesh = params.mesh
        pred = _tp_forward(params, split_rows(mesh, x))
        return pconcat([[pred[i] for i in mesh.dp_groups()[0]]], [0])[0]
    h = x
    for i, layer in enumerate(params):
        h = h @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            h = F.gelu(h, approximate="tanh")
    return h


def loss_fn(params, x, y) -> torch.Tensor:
    if isinstance(params, ShardedParams):
        with torch.no_grad():
            return dp_total(params.mesh, _tp_shares(params, x, y))
    pred = forward(params, x)
    return torch.mean(torch.square(pred.float() - y.float()))


def train_step(params, x, y, lr: float = 1e-3):
    """One SGD step with f32 update arithmetic, written into the
    parameters in place.  Returns ``(params, loss)``.  On the tp/dp layout
    each rank updates its own shard with its gradient summed over dp."""
    if isinstance(params, ShardedParams):
        loss, grads = value_and_grads(params,
                                      lambda: _tp_shares(params, x, y))
        for i in params.mesh.held():
            sgd_(params.leaves(i), grads[i], lr)
        return params, loss
    leaves = _leaves(params)
    loss, grads = value_and_grad(lambda: loss_fn(params, x, y), leaves)
    sgd_(leaves, grads, lr)
    return params, loss
