"""Ulysses-style all-to-all sequence parallelism.

PyTorch counterpart of ``distributedarrays_tpu/models/ulysses.py``.  Tokens
are sequence-sharded over a 1-D rank grid; one all-to-all (K11,
``ops.cuda_collectives.ring_all_to_all``) turns each rank's (S/P, H, D)
block into the full sequence for H/P heads, every rank runs complete
attention for its heads (flash attention K5, or the plain dense attention
with ``use_flash=False``), and a second all-to-all restores sequence
sharding.  The JAX function's flash block and head-fold lookups choose TPU
tiling knobs only and have no counterpart (see ``ops/cuda_attention``).

In a job of several controller processes both all-to-alls are their
cross-process form (one exchange each, a copy launch a process on the
card, counted as K11) and each process runs K5 on its own ranks' heads;
the result's other cells are placeholders.
"""

from __future__ import annotations

import math

import numpy as np

import torch

from ..darray import DArray
from ..ops.cuda_attention import flash_attention, flash_attention_plain
from ..ops.cuda_collectives import ring_all_to_all
from ..parallel.reshard import relayout_parts

__all__ = ["ulysses_attention"]


def ulysses_attention(q: DArray, k: DArray, v: DArray,
                      causal: bool = False,
                      use_flash: bool = True) -> DArray:
    """Exact attention over sequence-sharded (seq, heads, d) DArrays via a
    head-scatter all-to-all; heads must divide by the rank count.  The
    result has q's layout."""
    for name, a in (("q", q), ("k", k), ("v", v)):
        if a.ndim != 3:
            raise ValueError(f"{name} must be (seq, heads, head_dim), "
                             f"got {a.dims}")
        if a.dims != q.dims:
            raise ValueError("q, k, v dims must match")
    n = q.pids.size
    S, H, D = q.dims
    if q.pids.shape[0] != n or S % n:
        raise ValueError(
            f"ulysses needs the sequence dim sharded evenly over a 1-D "
            f"grid; got grid {q.pids.shape} for dims {q.dims}")
    if H % n:
        raise ValueError(f"heads {H} must be divisible by {n} ranks")
    scale = 1.0 / math.sqrt(D)
    attend = flash_attention if use_flash else flash_attention_plain
    # (S/P, H, D) -> (S, H/P, D): gather the sequence, scatter the heads
    heads = [ring_all_to_all([relayout_parts(a, q.pids, q.cuts)[r, 0, 0]
                              for r in range(n)], 1, 0) for a in (q, k, v)]
    # another process's ranks (a job) are placeholders of q's shape
    oh = [torch.empty_like(qh) if qh.device.type == "meta" else
          attend(qh, kh, vh, causal, scale) for qh, kh, vh in zip(*heads)]
    # (S, H/P, D) -> (S/P, H, D): scatter the sequence, gather the heads
    outs = ring_all_to_all(oh, 0, 1)
    parts = np.empty(q.grid, dtype=object)
    for r, t in enumerate(outs):
        parts[r, 0, 0] = t
    return q.with_parts(parts)
