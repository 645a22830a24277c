"""Pipeline parallelism: microbatches through stages on a rank list.

PyTorch counterpart of ``distributedarrays_tpu/models/pipeline.py``
(``init_pipeline_params``, ``make_pp_mesh``, ``pipeline_forward``,
``pipeline_train_step``, ``pipeline_train_step_1f1b``,
``reference_forward``), written in rank-list form: the JAX module runs one
``shard_map`` program over the ``pp`` axis, the port's controller runs the
same tick schedule over the ranks of ``mesh`` (a rank list,
``make_pp_mesh``).  Stage ``s`` is rank ``mesh[s]``; its ``(L, H, H)``
weights and ``(L, H)`` biases live on that rank's device, so the port's
parameters are ``{"W": [W_0, ..., W_{P-1}], "b": [b_0, ...]}``
(``params_from_reference`` turns the JAX dict of ``(S, L, H, H)`` /
``(S, L, H)`` arrays into them, ``params_to_reference`` back; the old
``(H, H)`` / ``(H,)`` per-stage shapes are read as L = 1 and a step
returns the shape it was given).

The schedule is JAX's:

- forward: ``T = M + P - 1`` ticks; at tick ``t`` stage ``s`` runs
  microbatch ``t - s``; bubble ticks compute on zeros and are masked, only
  the last stage banks outputs, and activations move one stage with
  ``pshift(..., wrap=False)`` (``.to`` of the next rank's device), except
  on the final tick.  The result is the replicated ``(M, B, H)`` stack,
  returned on ``mesh[0]``'s device.
- GPipe (``pipeline_train_step``): autograd through the whole forward
  schedule (``pshift`` is differentiable), loss ``mean((out - tgt)^2)``.
- 1F1B (``pipeline_train_step_1f1b``): ``T = M + 2P - 2`` ticks; stage
  ``s`` keeps at most ``S = min(M, 2P - 1)`` saved stage *inputs* in a
  slot ring and, for microbatch ``t - (2P - 2 - s)``, recomputes its
  forward and takes the vector-Jacobian product with ``torch.func.vjp``
  (JAX's ``jax.vjp``); cotangents flow back with ``pshift(..., -1)``.  The
  loss denominator is JAX's ``1 / (M B H)``.  A half whose microbatch is
  out of range contributes zero in JAX (its cotangent or input is masked
  to zero); the port skips its arithmetic and sends the same zeros.

On one card ``pshift`` hands a rank the sender's own tensor (``.to`` of
the same device is a no-op), so no received block and no slot of the
ring is ever written in place.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..layout import device_of
from ..parallel.collectives import pshift, spmd_mesh

__all__ = ["pipeline_forward", "pipeline_train_step",
           "pipeline_train_step_1f1b", "init_pipeline_params",
           "make_pp_mesh", "reference_forward", "params_from_reference",
           "params_to_reference"]


def make_pp_mesh(n_stages: int) -> list[int]:
    """The first ``n_stages`` ranks: stage ``s`` is rank ``s``."""
    return spmd_mesh(n_stages)


def init_pipeline_params(generator: torch.Generator | None, n_stages: int,
                         hidden: int, n_layers: int = 1,
                         dtype=torch.float32, ranks=None) -> dict:
    """``n_layers`` (hidden, hidden) dense layers and zero biases a stage,
    weights ``normal * sqrt(1 / hidden)``, stage ``s`` on rank
    ``ranks[s]``'s device (default: the first ``n_stages`` ranks).  The
    draws are ``generator``'s (on its device, moved to each stage's)."""
    ranks = make_pp_mesh(n_stages) if ranks is None else list(ranks)
    gdev = generator.device if generator is not None else "cpu"
    sc = math.sqrt(1.0 / hidden)
    W, b = [], []
    for s in range(n_stages):
        dev = device_of(ranks[s])
        w = torch.randn((n_layers, hidden, hidden), generator=generator,
                        device=gdev)
        W.append((w.to(dtype) * torch.tensor(sc, dtype=dtype)).to(dev))
        b.append(torch.zeros((n_layers, hidden), dtype=dtype, device=dev))
    return {"W": W, "b": b}


def params_from_reference(np_params: dict, ranks) -> dict:
    """The JAX parameter dict (numpy ``(S, L, H, H)`` / ``(S, L, H)``, or
    the old ``(S, H, H)`` / ``(S, H)``) as the port's per-stage tensors on
    ``ranks``."""
    W, b = np.asarray(np_params["W"]), np.asarray(np_params["b"])
    return {"W": [torch.from_numpy(np.array(W[s])).to(device_of(r))
                  for s, r in enumerate(ranks)],
            "b": [torch.from_numpy(np.array(b[s])).to(device_of(r))
                  for s, r in enumerate(ranks)]}


def params_to_reference(params: dict) -> dict:
    """The port's per-stage tensors as the JAX parameter dict (numpy)."""
    return {k: np.stack([t.detach().cpu().numpy() for t in params[k]])
            for k in ("W", "b")}


def _norm_params(params) -> tuple[list, list]:
    """Per-stage ``(L, H, H)`` weights and ``(L, H)`` biases; the old
    ``(H, H)`` stage shape reads as L = 1 (JAX ``pipeline.py:67``)."""
    W, b = list(params["W"]), list(params["b"])
    if W and W[0].ndim == 2:
        W, b = [w[None] for w in W], [x[None] for x in b]
    return W, b


def _stage_fn(x, Ws, bs):
    """One stage: its layers ``h = gelu(h @ W + b)`` in order (JAX's
    ``jax.nn.gelu``: the tanh approximation).  ``Ws`` and ``bs`` are the
    ``(L, H, H)`` / ``(L, H)`` stacks or sequences of the layers."""
    h = x
    for w, c in zip(Ws, bs):
        h = F.gelu(h @ w + c, approximate="tanh")
    return h


def _as_stack(mb) -> torch.Tensor:
    return mb if isinstance(mb, torch.Tensor) else \
        torch.from_numpy(np.asarray(mb))


def _check(W, mb, mesh):
    if mb.ndim != 3:
        raise ValueError(f"microbatches must be (M, B, H), got "
                         f"{tuple(mb.shape)}")
    if len(W) != len(mesh):
        raise ValueError(f"params have {len(W)} stages, mesh has "
                         f"{len(mesh)}")


def _forward(W, b, mb, mesh) -> torch.Tensor:
    """The forward tick schedule (JAX ``pipeline.py:95-124``); the banked
    ``(M, B, H)`` stack on ``mesh[0]``'s device."""
    P = len(mesh)
    M, B, H = mb.shape
    T = M + P - 1
    devs = [W[s][0].device for s in range(P)]
    mb0 = mb.to(devs[0])
    zero0 = torch.zeros((B, H), dtype=mb.dtype, device=devs[0])
    recv = [torch.zeros((B, H), dtype=mb.dtype, device=d) for d in devs]
    banked = []
    for t in range(T):
        ys = []
        for s in range(P):
            # stage 0 injects microbatch t (zeros on drain ticks)
            x = (mb0[t] if t < M else zero0) if s == 0 else recv[s]
            ys.append(_stage_fn(x, W[s], b[s]))
        if t - P + 1 >= 0:
            banked.append(ys[P - 1])
        if t < T - 1:
            recv = pshift(ys, 1, wrap=False)
    return torch.stack(banked).to(devs[0])


def pipeline_forward(params, mb, mesh) -> torch.Tensor:
    """Run the ``(M, B, H)`` microbatch stack through the pipeline on the
    ranks ``mesh``; the ``(M, B, H)`` outputs on ``mesh[0]``'s device."""
    mb = _as_stack(mb)
    W, b = _norm_params(params)
    _check(W, mb, mesh)
    return _forward(W, b, mb, mesh)


def _shaped_like(params, W, b) -> dict:
    if params["W"][0].ndim == 2:
        W, b = [w[0] for w in W], [x[0] for x in b]
    return {"W": W, "b": b}


def _gpipe_grads(W, b, mb, tgt, mesh):
    """GPipe: autograd through the forward ticks.  ``(dW, db, loss)``, the
    gradients on their stages' devices, the loss on ``mesh[0]``'s.  Each
    layer's weight is a leaf of its own, so a use of it adds an ``(H, H)``
    gradient and not a zero-filled ``(L, H, H)`` one."""
    Wl = [[w.detach().requires_grad_(True) for w in ws] for ws in W]
    bl = [[c.detach().requires_grad_(True) for c in cs] for cs in b]
    leaves = [x for ws in Wl + bl for x in ws]
    with torch.enable_grad():
        out = _forward(Wl, bl, mb, mesh)
        loss = torch.mean(torch.square(out - tgt.to(out.device)))
        grads = iter(torch.autograd.grad(loss, leaves))
    dW = [torch.stack([next(grads) for _ in ws]) for ws in Wl]
    db = [torch.stack([next(grads) for _ in cs]) for cs in bl]
    return dW, db, loss.detach()


@torch.no_grad()
def _1f1b_grads(W, b, mb, tgt, mesh):
    """The 1F1B interleave (JAX ``pipeline.py:177-263``): ``(dW, db,
    loss)`` as ``_gpipe_grads`` gives them.  The vector-Jacobian products
    are taken with respect to each layer's weight and bias, and added into
    the stage's gradient stacks in place."""
    P = len(mesh)
    M, B, H = mb.shape
    S = min(M, 2 * P - 1)
    T = M + 2 * P - 2
    L = W[0].shape[0]
    denom = 1.0 / (M * B * H)
    devs = [w.device for w in W]
    mb0, tgtl = mb.to(devs[0]), tgt.to(devs[-1])
    zeros = [torch.zeros((B, H), dtype=mb.dtype, device=d) for d in devs]
    recv_x, recv_g = list(zeros), list(zeros)
    saved = [[None] * S for _ in range(P)]
    dW = [torch.zeros_like(w) for w in W]
    db = [torch.zeros_like(x) for x in b]
    loss = torch.zeros((), dtype=torch.float32, device=devs[-1])

    def stage(x, *wb):
        return _stage_fn(x, wb[:L], wb[L:])

    for t in range(T):
        ys, dxs = [], []
        for s in range(P):
            # forward half: microbatch t - s; its input banked in slot
            # mf % S for the backward half (the slot is replaced, never
            # written into)
            mf = t - s
            if 0 <= mf < M:
                x_in = mb0[mf] if s == 0 else recv_x[s]
                saved[s][mf % S] = x_in
                ys.append(_stage_fn(x_in, W[s], b[s]))
            else:
                ys.append(zeros[s])
            # backward half: microbatch t - (2P - 2 - s), its forward
            # recomputed from the saved input
            mk = t - (2 * P - 2 - s)
            if not 0 <= mk < M:
                dxs.append(zeros[s])
                continue
            y2, vjp = torch.func.vjp(stage, saved[s][mk % S],
                                     *W[s].unbind(0), *b[s].unbind(0))
            if s == P - 1:
                diff = y2 - tgtl[mk]
                dy = (2.0 * diff * denom).to(y2.dtype)
                loss = loss + torch.sum(torch.square(diff)) * denom
            else:
                dy = recv_g[s]
            dx, *g = vjp(dy)
            for l in range(L):
                dW[s][l].add_(g[l])
                db[s][l].add_(g[L + l])
            dxs.append(dx)
        if t < T - 1:
            recv_x = pshift(ys, 1, wrap=False)
            recv_g = pshift(dxs, -1, wrap=False)
    return dW, db, loss.to(devs[0])


def _step(grads_fn, params, mb, tgt, mesh, lr):
    mb, tgt = _as_stack(mb), _as_stack(tgt)
    W, b = _norm_params(params)
    _check(W, mb, mesh)
    dW, db, loss = grads_fn(W, b, mb, tgt, mesh)
    with torch.no_grad():
        newW = [w.detach() - lr * g for w, g in zip(W, dW)]
        newb = [x.detach() - lr * g for x, g in zip(b, db)]
    return _shaped_like(params, newW, newb), loss


def pipeline_train_step(params, mb, tgt, mesh, lr: float = 1e-2):
    """One SGD step through the GPipe schedule (autograd through the
    forward ticks): ``(new params, loss)``, the loss a 0-d tensor on
    ``mesh[0]``'s device."""
    return _step(_gpipe_grads, params, mb, tgt, mesh, lr)


def pipeline_train_step_1f1b(params, mb, tgt, mesh, lr: float = 1e-2):
    """One SGD step under the 1F1B interleave: the same gradients and loss
    as ``pipeline_train_step``, with at most ``min(M, 2P - 1)`` saved stage
    inputs a stage."""
    return _step(_1f1b_grads, params, mb, tgt, mesh, lr)


def reference_forward(params, mb) -> torch.Tensor:
    """Sequential oracle: every stage's layers in order, on stage 0's
    device."""
    W, b = _norm_params(params)
    dev = W[0].device
    x = _as_stack(mb).to(dev)
    for s in range(len(W)):
        x = _stage_fn(x, W[s].to(dev), b[s].to(dev))
    return x
