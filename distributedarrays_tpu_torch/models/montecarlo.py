"""Monte-Carlo estimation: draws on the device, a local reduce per batch.

PyTorch counterpart of ``distributedarrays_tpu/models/montecarlo.py``
(``pi_estimate``, ``expectation``).  The draws come from a
``torch.Generator`` on rank 0's device seeded by ``seed``, never from the
host; JAX's threefry streams cannot be reproduced, so the estimates agree
with JAX's statistically (within their standard errors), not bit for bit.
``expectation``'s standard error uses the population std, as ``jnp.std``
does (``correction=0``).
"""

from __future__ import annotations

import math

import torch

from ..layout import device_of

__all__ = ["pi_estimate", "expectation"]


def _generator(seed: int) -> torch.Generator:
    return torch.Generator(device=device_of(0)).manual_seed(int(seed))


def pi_estimate(n: int, seed: int = 0, batches: int = 1) -> float:
    """Estimate π from ``n`` uniform draws in the unit square, in
    ``batches`` draws of ``n // batches`` points each (the remainder is not
    drawn, as in JAX)."""
    if batches <= 0 or n < batches:
        raise ValueError(f"need 1 <= batches <= n, got n={n}, "
                         f"batches={batches}")
    per = n // batches
    gen = _generator(seed)
    hits = 0
    for _ in range(batches):
        xy = torch.rand((per, 2), generator=gen, device=gen.device)
        hits += int(torch.count_nonzero(
            xy[:, 0] * xy[:, 0] + xy[:, 1] * xy[:, 1] <= 1.0))
        del xy
    return 4.0 * hits / (per * batches)


def expectation(f, n: int, seed: int = 0):
    """E[f(X)], X ~ N(0, 1), from ``n`` f32 draws: ``(estimate, standard
    error)``.  ``f`` maps a tensor to a tensor of the same length."""
    gen = _generator(seed)
    x = torch.randn(int(n), generator=gen, device=gen.device)
    v = f(x)
    est = torch.mean(v)
    se = torch.std(v, correction=0) / math.sqrt(int(n))
    return float(est), float(se)
