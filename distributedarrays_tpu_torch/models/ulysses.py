"""Ulysses-style all-to-all sequence parallelism.

PyTorch counterpart of ``distributedarrays_tpu/models/ulysses.py``.  Tokens
are sequence-sharded over a 1-D rank grid; one all-to-all (K11,
``ops.cuda_collectives.ring_all_to_all``) turns each rank's (S/P, H, D)
block into the full sequence for H/P heads, every rank runs complete
attention for its heads (flash attention K5, or the plain dense attention
with ``use_flash=False``), and a second all-to-all restores sequence
sharding.  The JAX function's flash block and head-fold lookups choose TPU
tiling knobs only and have no counterpart (see ``ops/cuda_attention``).
"""

from __future__ import annotations

import math

import numpy as np

from ..darray import DArray, cross_process_unported
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
    cross_process_unported("Ulysses attention", q, k, v)
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
    oh = [attend(qh, kh, vh, causal, scale) for qh, kh, vh in zip(*heads)]
    # (S, H/P, D) -> (S/P, H, D): scatter the sequence, gather the heads
    outs = ring_all_to_all(oh, 0, 1)
    parts = np.empty(q.grid, dtype=object)
    for r, t in enumerate(outs):
        parts[r, 0, 0] = t
    return q.with_parts(parts)
