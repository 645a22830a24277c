"""Flat-vector optimizers for the data-parallel trainer.

PyTorch counterpart of ``distributedarrays_tpu/train/optim.py``.  The
trainer keeps the model as one flat f32 vector split over the ranks, each
rank updating only its slice of the parameters and of every optimizer
moment, so an update is elementwise: the same code is right on a whole
vector, a slice or a padded slice (a zero gradient leaves a zero-moment
element where it is, for every member).  The arithmetic is f32 throughout,
scalars included, as in the JAX update: Adam's step ``t`` is 1-based and
its bias corrections take ``pow`` in f32.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["Optimizer", "sgd", "adam"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """One optimizer spec: ``kind`` in {"sgd", "adam"} plus hyperparameters.
    ``nslots`` moment vectors ride beside the parameter vector: 0 for plain
    SGD, 1 for momentum SGD, 2 for Adam."""

    kind: str = "adam"
    lr: float = 1e-3
    momentum: float = 0.0        # sgd only
    b1: float = 0.9              # adam
    b2: float = 0.999            # adam
    eps: float = 1e-8            # adam

    def __post_init__(self):
        if self.kind not in ("sgd", "adam"):
            raise ValueError(f"unknown optimizer kind {self.kind!r} "
                             "(use 'sgd' or 'adam')")

    @property
    def nslots(self) -> int:
        if self.kind == "adam":
            return 2
        return 1 if self.momentum else 0

    def init_slots(self, n: int, device=None) -> tuple:
        """Zero moment vectors for an ``n``-element parameter slice."""
        return tuple(torch.zeros(n, dtype=torch.float32, device=device)
                     for _ in range(self.nslots))

    def update(self, t: int, p: torch.Tensor, g: torch.Tensor,
               slots: tuple) -> tuple:
        """One elementwise step: ``(p, *slots), g -> (p', *slots')``, with
        ``t`` the 1-based step number."""
        f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=p.device)
        lr = f32(self.lr)
        if self.kind == "sgd":
            if not self.momentum:
                return (p - lr * g,)
            (m,) = slots
            m2 = f32(self.momentum) * m + g
            return p - lr * m2, m2
        m, v = slots
        b1, b2, tt = f32(self.b1), f32(self.b2), f32(t)
        m2 = b1 * m + (1.0 - b1) * g
        v2 = b2 * v + (1.0 - b2) * torch.square(g)
        mhat = m2 / (1.0 - torch.pow(b1, tt))
        vhat = v2 / (1.0 - torch.pow(b2, tt))
        return (p - lr * mhat / (torch.sqrt(vhat) + f32(self.eps)), m2, v2)


def sgd(lr: float = 1e-2, momentum: float = 0.0) -> Optimizer:
    """Plain (or momentum) SGD over the flat parameter vector."""
    return Optimizer(kind="sgd", lr=lr, momentum=momentum)


def adam(lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    """Adam with bias correction; two moment vectors."""
    return Optimizer(kind="adam", lr=lr, b1=b1, b2=b2, eps=eps)
