"""Gradients with respect to tensors that do not require them, the
in-place SGD update, and optimizer steps in f32 master arithmetic: what
``jax.value_and_grad``, the donated-buffer ``tree_map`` update and
``transformer._optax_f32_step``/``_optax_f32_init`` do in the JAX
models' train steps.  optax is JAX, so the optimizer is the port's
``train.optim.Optimizer``."""

from __future__ import annotations

from typing import Callable, Sequence

import torch

__all__ = ["value_and_grad", "sgd_", "f32_opt_init", "f32_opt_update_"]


def value_and_grad(fn: Callable[[], torch.Tensor],
                   leaves: Sequence[torch.Tensor]):
    """``(fn(), d fn() / d leaves)``.  The leaves are leaf tensors; they are
    switched to ``requires_grad`` for the call and back after, so a model
    whose parameters serve without a graph trains all the same."""
    flags = [t.requires_grad for t in leaves]
    try:
        for t in leaves:
            t.requires_grad_(True)
        with torch.enable_grad():
            value = fn()
            grads = torch.autograd.grad(value, leaves)
    finally:
        for t, f in zip(leaves, flags):
            t.requires_grad_(f)
    return value.detach(), grads


@torch.no_grad()
def sgd_(leaves: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
         lr: float) -> None:
    """``p = (p.f32 - lr * g.f32)`` in p's type, in place."""
    for p, g in zip(leaves, grads):
        p.copy_((p.float() - lr * g.float()).to(p.dtype))


def f32_opt_init(opt, leaves: Sequence[torch.Tensor]) -> dict:
    """Optimizer state for ``leaves``, as ``tx.init`` of their f32 copies:
    step 0 and, per leaf, ``opt.nslots`` f32 moments of its shape."""
    return {"t": 0, "slots": [
        tuple(s.view(p.shape) for s in opt.init_slots(p.numel(), p.device))
        for p in leaves]}


@torch.no_grad()
def f32_opt_update_(opt, state: dict, leaves: Sequence[torch.Tensor],
                    grads: Sequence[torch.Tensor]) -> dict:
    """One optimizer step in f32 master arithmetic: each leaf and its
    gradient upcast to f32, ``opt.update`` on them, the result cast back to
    the leaf's type and written in place (bf16 alone would round Adam-size
    updates away).  Returns the new state."""
    t = state["t"] + 1
    slots = []
    for p, g, sl in zip(leaves, grads, state["slots"]):
        new, *moments = opt.update(t, p.float(), g.float(), sl)
        p.copy_(new.to(p.dtype))
        slots.append(tuple(moments))
    return {"t": t, "slots": slots}
