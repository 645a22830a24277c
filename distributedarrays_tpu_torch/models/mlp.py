"""The demonstrator MLP: parameters, forward, loss and one SGD step.

PyTorch counterpart of ``init_params``, ``forward``, ``loss_fn`` and
``train_step`` in ``distributedarrays_tpu/models/mlp.py``.  Parameters
keep the JAX pytree: a list of ``{"w": (in, out), "b": (out,)}`` dicts of
tensors.  The activation between layers is GELU with the tanh
approximation (``jax.nn.gelu``'s default).  ``init_params`` draws from a
``torch.Generator``, whose stream differs from ``jax.random``'s.
``train_step`` updates the parameters in place (the JAX step donates its
buffers and returns new ones).  The tp/dp layouts (``make_mesh``,
``shard_params``, ``shard_batch``) are not ported yet.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

from ._autodiff import sgd_, value_and_grad

__all__ = ["init_params", "forward", "loss_fn", "train_step"]


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


def forward(params, x: torch.Tensor) -> torch.Tensor:
    h = x
    for i, layer in enumerate(params):
        h = h @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            h = F.gelu(h, approximate="tanh")
    return h


def loss_fn(params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    pred = forward(params, x)
    return torch.mean(torch.square(pred.float() - y.float()))


def train_step(params, x: torch.Tensor, y: torch.Tensor, lr: float = 1e-3):
    """One SGD step with f32 update arithmetic, written into the
    parameters in place.  Returns ``(params, loss)``."""
    leaves = [t for layer in params for t in (layer["b"], layer["w"])]
    loss, grads = value_and_grad(lambda: loss_fn(params, x, y), leaves)
    sgd_(leaves, grads, lr)
    return params, loss
