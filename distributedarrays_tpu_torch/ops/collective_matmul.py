"""Owned distributed-GEMM schedules over rank tensors: the three ring
GEMMs and the tensor-parallel FFN built on two of them, Cannon, SUMMA and
Cannon with int8 panels.

PyTorch counterpart of ``allgather_matmul``, ``allgather_matmul_rhs``,
``matmul_reducescatter``, ``tp_ffn``, ``cannon_matmul``, ``summa_matmul``
and ``cannon_matmul_int8`` in
``distributedarrays_tpu/ops/collective_matmul.py``.  There each schedule
runs inside a ``shard_map`` with mesh axes; here it takes the ranks'
blocks as a list (a 2-D grid flattened row-major, rank ``(i, j)`` at
``i * c + j``) and returns one result block per rank, on that rank's
device.  The panel moves of Cannon and SUMMA are plain ``.to(device)``
copies (``lax.ppermute``/``psum`` in JAX, no Pallas kernel there either)
and their per-rank products are ``torch.matmul`` with TF32 off, as the
JAX package leaves them to XLA.  The ring GEMMs run their kernels on the
card (``cuda_collectives``: K13 ``ring_allgather_matmul``, K14
``ring_allgather_matmul_rhs``, K15 ``ring_matmul_reducescatter``) and
Cannon with int8 panels the K4 kernel per hop.

``allgather_matmul`` and ``matmul_reducescatter`` are differentiable, and
their gradients are ring GEMMs again, the same functions as the VJP of the
JAX ``lax`` rings (whose transposed ``pshift`` loops move the chunks round
the ring once more; nothing gathered is saved):

- h_r = AG(x) @ w_r:  dx = RS(dh_r @ w_r^T) (K15) and
  dw_r = (dh_r^T @ AG(x))^T (K14);
- y = RS(a_r @ w_r):  da_r = AG(dy) @ w_r^T (K13) and
  dw_r = a_r^T @ AG(dy) (K14),

with the transposes taken as contiguous copies.

In a job of several controller processes (``parallel.multihost``)
another process's blocks are ``meta`` placeholders: each ring GEMM
launches its kernel for this process's ranks only, storing the forwarded
chunk or partial into the neighbour process's slot through a CUDA IPC
mapping (``cuda_collectives._Ring``), or runs its plain ring on the
cross-process ``pshift`` off the card; the results of another process's
ranks are placeholders.  Each ring, forward or backward, is a call of
every process, so ``allgather_matmul``, ``matmul_reducescatter`` and
``tp_ffn`` are too; their backward rings run inside the two Functions'
``backward`` (in a fixed order), which the autograd graph orders the same
on every process (see ``models.ring_attention``).  The panel moves of
Cannon (``_rotate``) are one ``pshifts`` exchange each.  In the JAX package
``tp_ffn`` calls its two GEMMs without ``rdma=True``: their ``lax`` rings,
overlapped by XLA, and K13/K15 only when a caller arms them, forward-only.
The port has no XLA to overlap a hop with a product, so the fused kernels
are the path for CUDA tensors, forward and backward; the ``rdma`` flag,
``interpret`` and ``mesh_axes`` have no counterpart.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

from ..parallel.collectives import pshifts
from .cuda_collectives import (ring_allgather_matmul,
                               ring_allgather_matmul_rhs,
                               ring_matmul_reducescatter)
from .cuda_gemm import (cuda_matmul_int8, quantize_rows, quantized_matmul,
                        torch_matmul)

__all__ = ["allgather_matmul", "allgather_matmul_rhs",
           "matmul_reducescatter", "tp_ffn", "cannon_matmul",
           "summa_matmul", "cannon_matmul_int8"]


def _rotate(groups, g: int) -> list[list[torch.Tensor]]:
    """Each ``(blocks, axis, shifts)`` of ``groups`` (the g x g grid's
    blocks in row-major order) with line ``i`` of ``axis`` (the grid's
    rows for axis 1, columns for axis 0) shifted by ``shifts[i]``
    (``pshift``'s sense): every line of every group in one ``pshifts``,
    so in a job one exchange moves them all.  Cannon's skew (JAX
    ``_cannon_skew_perms``) is line ``i`` shifted by ``-i``, its hop every
    line by ``-1``."""
    lines, where = [], []
    for blocks, axis, shifts in groups:
        for i, s in enumerate(shifts):
            idx = [i * g + j if axis == 1 else j * g + i for j in range(g)]
            lines.append([blocks[q] for q in idx])
            where.append(idx)
    got = pshifts(lines, [s for _, _, sh in groups for s in sh])
    out, k = [], 0
    for blocks, _, shifts in groups:
        res = list(blocks)
        for _ in shifts:
            for q, x in zip(where[k], got[k]):
                res[q] = x
            k += 1
        out.append(res)
    return out


def _t(blocks) -> list[torch.Tensor]:
    """Each rank's matrix transposed, as a contiguous copy."""
    return [b.t().contiguous() for b in blocks]


def _promoted(x_blocks, w_blocks):
    dt = torch.promote_types(x_blocks[0].dtype, w_blocks[0].dtype)
    return [x.to(dt) for x in x_blocks], [w.to(dt) for w in w_blocks]


class _AllGatherMatmul(torch.autograd.Function):
    """h_r = all_gather(x) @ w_r over rank lists (K13 forward; K15 and K14
    backward)."""

    @staticmethod
    def forward(ctx, p, *blocks):
        xs, ws = blocks[:p], blocks[p:]
        ctx.p = p
        ctx.save_for_backward(*xs, *ws)
        return tuple(ring_allgather_matmul(xs, ws))

    @staticmethod
    def backward(ctx, *dh):
        p = ctx.p
        xs, ws = ctx.saved_tensors[:p], ctx.saved_tensors[p:]
        dh = [g.contiguous() for g in dh]
        dx = dw = [None] * p
        if any(ctx.needs_input_grad[1:p + 1]):
            dx = ring_matmul_reducescatter(dh, _t(ws))
        if any(ctx.needs_input_grad[p + 1:]):
            dw = _t(ring_allgather_matmul_rhs(_t(dh), xs))
        return (None, *dx, *dw)


class _MatmulReduceScatter(torch.autograd.Function):
    """y = reduce_scatter(a_r @ w_r) over rank lists (K15 forward; K13 and
    K14 backward)."""

    @staticmethod
    def forward(ctx, p, *blocks):
        xs, ws = blocks[:p], blocks[p:]
        ctx.p = p
        ctx.save_for_backward(*xs, *ws)
        return tuple(ring_matmul_reducescatter(xs, ws))

    @staticmethod
    def backward(ctx, *dy):
        p = ctx.p
        xs, ws = ctx.saved_tensors[:p], ctx.saved_tensors[p:]
        dy = [g.contiguous() for g in dy]
        dx = dw = [None] * p
        if any(ctx.needs_input_grad[1:p + 1]):
            dx = ring_allgather_matmul(dy, _t(ws))
        if any(ctx.needs_input_grad[p + 1:]):
            dw = ring_allgather_matmul_rhs(_t(xs), dy)
        return (None, *dx, *dw)


def allgather_matmul(x_blocks: Sequence[torch.Tensor],
                     w_blocks: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """``all_gather(x) @ w_r`` for every rank r of a 1-D ring: ``x_r`` is
    rank r's ``(m_loc, k)`` row chunk of the gathered operand and ``w_r``
    its resident ``(k, n_loc)`` shard; rank r gets ``(p * m_loc, n_loc)``,
    its column shard of ``all_gather(x) @ W`` in tensor parallelism.  The
    K13 kernel on the card, the plain ring on the CPU; mixed dtypes are
    promoted first.  Differentiable in x and w."""
    xs, ws = _promoted(list(x_blocks), list(w_blocks))
    return list(_AllGatherMatmul.apply(len(xs), *xs, *ws))


def matmul_reducescatter(x_blocks: Sequence[torch.Tensor],
                         w_blocks: Sequence[torch.Tensor]
                         ) -> list[torch.Tensor]:
    """``reduce_scatter(x_r @ w_r)`` over a 1-D ring: ``x_r`` is rank r's
    ``(m, k_loc)`` contraction shard, ``w_r`` its ``(k_loc, n)`` shard, and
    rank r gets row block r of ``sum_q x_q @ w_q``, ``(m / p, n)``.  The K15
    kernel on the card, the plain ring on the CPU; mixed dtypes are
    promoted first.  Differentiable in x and w."""
    xs, ws = _promoted(list(x_blocks), list(w_blocks))
    if xs and xs[0].shape[0] % len(xs):
        raise ValueError(f"rows {xs[0].shape[0]} must be divisible by the "
                         f"{len(xs)} ranks")
    return list(_MatmulReduceScatter.apply(len(xs), *xs, *ws))


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def tp_ffn(x_blocks: Sequence[torch.Tensor], w1_blocks: Sequence[torch.Tensor],
           w2_blocks: Sequence[torch.Tensor], act=None) -> list[torch.Tensor]:
    """The Megatron sequence-parallel FFN over rank lists,
    ``reduce_scatter(act(all_gather(x) @ W1) @ W2)``: ``x_r`` is rank r's
    ``(s_loc, e)`` sequence shard, ``w1_r`` its ``(e, f_loc)`` column shard
    and ``w2_r`` its ``(f_loc, e)`` row shard; rank r gets its ``(s_loc,
    e)`` shard of the output, and the ``(s, f_loc)`` activation is 1/p of
    the whole.  ``act`` defaults to GELU with the tanh approximation
    (``jax.nn.gelu``'s default).  Differentiable; in a job, a call of every
    process (another process's shards placeholders)."""
    act = _gelu if act is None else act
    h = allgather_matmul(x_blocks, w1_blocks)          # (s, f_loc) per rank
    return matmul_reducescatter([act(x) for x in h], w2_blocks)


def allgather_matmul_rhs(a_blocks: Sequence[torch.Tensor],
                         b_blocks: Sequence[torch.Tensor]
                         ) -> list[torch.Tensor]:
    """``a_r @ all_gather(b)`` for every rank r of a 1-D ring: ``a_r`` is
    rank r's resident ``(m_loc, k)`` row block, ``b_r`` its ``(k_loc, n)``
    chunk of the gathered operand, ``k = p * k_loc``.  The ring GEMM kernel
    on the card, the plain ring on the CPU; mixed dtypes are promoted
    first."""
    return ring_allgather_matmul_rhs(*_promoted(a_blocks, b_blocks))


def cannon_matmul(a_blocks: Sequence[torch.Tensor],
                  b_blocks: Sequence[torch.Tensor],
                  g: int) -> list[torch.Tensor]:
    """2-D-grid GEMM on a square ``(g, g)`` grid: ``a_blocks[i*g+j]`` is the
    ``(m/g, k/g)`` block of A, ``b_blocks[i*g+j]`` the ``(k/g, n/g)`` block
    of B; returns every rank's block of ``A @ B`` (C never moves).  One
    pre-skew, then g local products, each followed by a one-hop rotation
    (A left along the grid row, B up along the grid column); the products
    are cast to the output type and summed in step order."""
    if len(a_blocks) != g * g or len(b_blocks) != g * g:
        raise ValueError(f"cannon_matmul needs {g}x{g} blocks per operand")
    out_dtype = torch.promote_types(a_blocks[0].dtype, b_blocks[0].dtype)

    def step(a, b):
        return torch_matmul(a.to(out_dtype), b.to(out_dtype)).to(out_dtype)

    if g == 1:
        return [step(a_blocks[0], b_blocks[0])]
    # A's row i rotates left by i, B's column j up by j (the skew)
    skew = [-i for i in range(g)]
    a, b = _rotate([(a_blocks, 1, skew), (b_blocks, 0, skew)], g)
    acc = [step(x, y) for x, y in zip(a, b)]
    hop = [-1] * g
    for _ in range(1, g):
        # A from grid column j+1, B from grid row i+1
        a, b = _rotate([(a, 1, hop), (b, 0, hop)], g)
        acc = [s + step(x, y) for s, x, y in zip(acc, a, b)]
    return acc


def summa_matmul(a_blocks: Sequence[torch.Tensor],
                 b_blocks: Sequence[torch.Tensor], r: int,
                 c: int) -> list[torch.Tensor]:
    """2-D-grid GEMM on any ``(r, c)`` grid (the SUMMA panel schedule):
    ``a_blocks[i*c+j]`` is the ``(m/r, k/c)`` block of A and
    ``b_blocks[i*c+j]`` the ``(k/r, n/c)`` block of B.  The contraction
    splits into ``L = lcm(r, c)`` panels of width ``k/L``; panel ``q`` of A
    lives on grid column ``q // (L/c)`` and of B on grid row ``q // (L/r)``,
    and each step copies both panels along their grid row / column and
    adds one local product, in panel order."""
    if len(a_blocks) != r * c or len(b_blocks) != r * c:
        raise ValueError(f"summa_matmul needs {r}x{c} blocks per operand")
    out_dtype = torch.promote_types(a_blocks[0].dtype, b_blocks[0].dtype)
    if r == 1 and c == 1:
        return [torch_matmul(a_blocks[0].to(out_dtype),
                             b_blocks[0].to(out_dtype))]
    L = math.lcm(r, c)
    k_loc_a = a_blocks[0].shape[1]           # k/c
    k_loc_b = b_blocks[0].shape[0]           # k/r
    if k_loc_a % (L // c) or k_loc_b % (L // r):
        raise ValueError(f"summa_matmul needs k divisible by lcm(r, c) = {L}")
    kp = k_loc_a // (L // c)
    acc = [None] * (r * c)
    for q in range(L):
        ca, oa = divmod(q, L // c)           # A panel q: grid col, local slot
        rb, ob = divmod(q, L // r)           # B panel q: grid row, local slot
        for i in range(r):
            for j in range(c):
                dev = a_blocks[i * c + j].device
                a_pan = a_blocks[i * c + ca][:, oa * kp:(oa + 1) * kp].to(dev)
                b_pan = b_blocks[rb * c + j][ob * kp:(ob + 1) * kp].to(dev)
                part = torch_matmul(a_pan.to(out_dtype),
                                    b_pan.to(out_dtype)).to(out_dtype)
                x = i * c + j
                acc[x] = part if acc[x] is None else acc[x] + part
    return acc


def cannon_matmul_int8(a_blocks: Sequence[torch.Tensor],
                       b_blocks: Sequence[torch.Tensor], g: int,
                       out_dtype=torch.float32) -> list[torch.Tensor]:
    """``cannon_matmul`` with int8 panels: each rank quantizes its blocks
    once (per-row A / per-column B codes and scales), codes and scales ride
    the skew and the hops, every hop runs the int8 GEMM (exact int32 sums,
    fused dequantization) and the hops' f32 products are summed in hop
    order.  Square grids only.  The skew and each hop move the codes and
    scales of both operands as one ``_rotate`` (in a job of several
    controller processes, one exchange; another process's ranks are
    placeholders, whose products are placeholders)."""
    if len(a_blocks) != g * g or len(b_blocks) != g * g:
        raise ValueError(f"cannon_matmul_int8 needs {g}x{g} blocks per "
                         "operand")
    if g == 1:
        return [quantized_matmul(a_blocks[0], b_blocks[0], out_dtype)]
    qa, sa = zip(*[quantize_rows(a, 1) for a in a_blocks])
    qb, sb = zip(*[quantize_rows(b, 0) for b in b_blocks])
    # A's row i rotates left by i, B's column j up by j (the skew)
    skew = [-i for i in range(g)]
    qa, sa, qb, sb = _rotate([(qa, 1, skew), (sa, 1, skew), (qb, 0, skew),
                              (sb, 0, skew)], g)

    def step(x):
        return cuda_matmul_int8(qa[x], qb[x], sa[x], sb[x], torch.float32)

    acc = [step(x) for x in range(g * g)]
    hop = [-1] * g
    for _ in range(1, g):
        qa, sa, qb, sb = _rotate([(qa, 1, hop), (sa, 1, hop), (qb, 0, hop),
                                  (sb, 0, hop)], g)
        acc = [acc[x] + step(x) for x in range(g * g)]
    return [x.to(out_dtype) for x in acc]
