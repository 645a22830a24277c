"""Collectives over rank tensors, written in plain torch.

PyTorch counterpart of ``halo_exchange``, ``pshift``, ``pgather``,
``preduce`` and ``pall_to_all`` in
``distributedarrays_tpu/parallel/collectives.py``, and of
``lax.psum_scatter`` as ``psum_scatter``.
There each is a ``lax`` collective inside a ``shard_map``; here the
controller holds every rank's tensor, so a collective takes the list of the
ranks' tensors in ring order (one per ``axis_index``) and returns a list,
each result on its rank's device, moved with ``.to(device)`` copies.  These
are the plain versions that the hand-written collective kernels
(``ops/cuda_collectives``) are held against, and the steps the plain ring
schedules are written with.  Only the tiled forms exist: ``pgather`` and
``pall_to_all`` concatenate, as ``tiled=True`` does in JAX.
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["halo_exchange", "pshift", "pgather", "preduce", "pall_to_all",
           "psum_scatter"]


def halo_exchange(blocks: Sequence[torch.Tensor], halo: int = 1, dim: int = 0,
                  wrap: bool = False) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """``(lo, hi)`` for every rank of a 1-D rank ring: ``lo`` is the last
    ``halo`` slabs (along ``dim``) of the previous rank's block, ``hi`` the
    first ``halo`` slabs of the next rank's block, each on the receiving
    rank's device.  With ``wrap=False`` the outer edges receive zeros."""
    n = len(blocks)
    out = []
    for r, b in enumerate(blocks):
        def slab(src: torch.Tensor, first: bool) -> torch.Tensor:
            size = src.shape[dim]
            if halo > size:
                raise ValueError(
                    f"halo {halo} exceeds the neighbour's extent {size}")
            s = src.narrow(dim, 0 if first else size - halo, halo)
            return s.to(b.device).contiguous()

        shape = list(b.shape)
        shape[dim] = halo
        if r > 0 or wrap:
            lo = slab(blocks[(r - 1) % n], first=False)
        else:
            lo = torch.zeros(shape, dtype=b.dtype, device=b.device)
        if r < n - 1 or wrap:
            hi = slab(blocks[(r + 1) % n], first=True)
        else:
            hi = torch.zeros(shape, dtype=b.dtype, device=b.device)
        out.append((lo, hi))
    return out


def pshift(blocks: Sequence[torch.Tensor], shift: int = 1,
           wrap: bool = True) -> list[torch.Tensor]:
    """Ring shift: rank ``i`` receives rank ``i - shift``'s block on its own
    device.  With ``wrap=False`` ranks with no sender receive zeros."""
    n = len(blocks)
    out = []
    for i, b in enumerate(blocks):
        j = i - shift
        if wrap or 0 <= j < n:
            out.append(blocks[j % n].to(b.device))
        else:
            out.append(torch.zeros_like(b))
    return out


def pgather(blocks: Sequence[torch.Tensor], dim: int = 0) -> list[torch.Tensor]:
    """Every rank gets all blocks concatenated along ``dim`` in rank order,
    on its own device."""
    return [torch.cat([x.to(b.device) for x in blocks], dim) for b in blocks]


_FOLDS = {"sum": torch.add, "mean": torch.add, "max": torch.maximum,
          "min": torch.minimum}


def preduce(blocks: Sequence[torch.Tensor],
            op: str = "sum") -> list[torch.Tensor]:
    """All-reduce (``lax.psum``/``pmax``/``pmin``/``pmean``): the ranks'
    blocks folded in rank order on rank 0's device (``mean`` divides the
    sum by the rank count), the one result copied to every rank's device,
    so every rank holds the same bits."""
    if op not in _FOLDS:
        raise ValueError(f"unknown reduction {op!r}: use one of "
                         f"{sorted(_FOLDS)}")
    acc = blocks[0]
    for b in blocks[1:]:
        acc = _FOLDS[op](acc, b.to(acc.device))
    if op == "mean":
        acc = acc / len(blocks)
    return [acc.to(b.device, copy=True) for b in blocks]


def pall_to_all(blocks: Sequence[torch.Tensor], split_dim: int,
                concat_dim: int) -> list[torch.Tensor]:
    """All-to-all: rank ``r``'s block splits along ``split_dim`` into one
    piece per rank; rank ``q`` gets piece ``q`` of every rank, concatenated
    along ``concat_dim`` in rank order, on its own device."""
    p = len(blocks)
    for b in blocks:
        if b.shape[split_dim] % p:
            raise ValueError(f"split extent {b.shape[split_dim]} is not "
                             f"divisible by the {p} ranks")
    pieces = [b.tensor_split(p, split_dim) for b in blocks]
    return [torch.cat([pieces[r][q].to(b.device) for r in range(p)],
                      concat_dim) for q, b in enumerate(blocks)]


def psum_scatter(blocks: Sequence[torch.Tensor],
                 dim: int = 0) -> list[torch.Tensor]:
    """Reduce-scatter (``lax.psum_scatter(..., tiled=True)``): every rank's
    block splits along ``dim`` into one piece per rank, and rank ``d`` gets
    the sum of every rank's piece ``d`` on its own device.  The sum is the
    TPU ring's arrival order: the left fold over ranks d+1, d+2, ..., d+p
    (mod p), each add rounded to the blocks' type."""
    p = len(blocks)
    for b in blocks:
        if b.shape[dim] % p:
            raise ValueError(f"scatter extent {b.shape[dim]} is not "
                             f"divisible by the {p} ranks")
    pieces = [b.tensor_split(p, dim) for b in blocks]
    out = []
    for d, b in enumerate(blocks):
        acc = pieces[(d + 1) % p][d].to(b.device, copy=True)
        for k in range(2, p + 1):
            acc = acc + pieces[(d + k) % p][d].to(b.device)
        out.append(acc.contiguous())
    return out
