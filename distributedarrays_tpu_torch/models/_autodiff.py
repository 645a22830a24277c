"""Gradients with respect to tensors that do not require them, and the
in-place SGD update: what ``jax.value_and_grad`` and the donated-buffer
``tree_map`` update do in the JAX models' ``train_step``."""

from __future__ import annotations

from typing import Callable, Sequence

import torch

__all__ = ["value_and_grad", "sgd_"]


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
