"""Ring attention: sequence-parallel exact attention over rank tensors.

PyTorch counterpart of the forward half of ``distributedarrays_tpu/models/
ring_attention.py``.  Q, K and V are sequence-sharded over a 1-D rank grid:
rank r holds rows ``[r*b, (r+1)*b)`` as a (b, heads, d) block.  In p steps
every rank accumulates its q block against the K/V block currently
resident with an online softmax (running max m, normaliser l, accumulator
o), and the K/V blocks move one rank to the right between steps.

- ``ring_attention_kernel(q_blocks, k_blocks, v_blocks, causal, scale)``:
  the plain ring over a rank list, ``pshift`` rotating K/V, with the
  numerics of the JAX ``_online_accumulate`` (q scaled in its own type,
  then f32; f32 products and softmax).  It is the plain version of K9.
- ``ring_attention_rdma(...)``: the same ring as the CUDA kernel K9
  (``csrc/attention.cu`` ``da_ring_attn_step``): one launch per rank per
  step forwards the resident pair into the right neighbour's free slot
  and accumulates in the same f32 numerics, with the carry in device
  memory.  The plain ring for CPU tensors.
- ``ring_attention(q, k, v, causal)`` on DArrays runs K9;
  ``ring_flash_attention(q, k, v, causal)`` runs K8 hops
  (``ops.cuda_attention.flash_attention_hop``) with the K/V rotation by
  ``pshift`` (a plain copy between ranks, as ``lax.ppermute`` is no Pallas
  kernel); ``ring_attention_prefill`` is the decode service's prefill
  entry; ``reference_attention`` is the dense numpy oracle.

Two behaviours of the JAX package are not carried over.  Its
``ring_attention`` falls back from the RDMA kernel to the XLA ring when
the kernel raises (``try``/``except``), and ``ring_attention_rdma_kernel``
takes the XLA ring when its VMEM budget gate says the blocks do not fit.
Here a kernel that fails raises, and there is no VMEM: the blocks and the
carry stay in device memory, so every size the card holds runs the
kernel.  Zigzag layouts and the ring backward are not ported yet.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from .. import layout as L
from ..darray import DArray, distribute
from ..ops.cuda_attention import (MAX_HEAD_DIM, flash_attention_hop,
                                  flash_carry_finalize, flash_carry_init,
                                  ring_attn_step)
from ..ops.cuda_collectives import _Order
from ..parallel.collectives import pshift
from ..parallel.reshard import relayout_parts

__all__ = ["ring_attention", "ring_attention_kernel", "ring_attention_rdma",
           "ring_attention_prefill", "ring_flash_attention",
           "reference_attention"]


def reference_attention(q, k, v, causal: bool = False):
    """Dense O(seq^2) numpy oracle over (seq, heads, d) arrays."""
    q, k, v = (np.asarray(x, np.float32) for x in (q, k, v))
    s = np.einsum("qhd,khd->hqk", q / np.sqrt(q.shape[-1]), k)
    if causal:
        qi = np.arange(q.shape[0])[:, None]
        ki = np.arange(k.shape[0])[None, :]
        s = np.where((ki <= qi)[None], s, -np.inf)
    s = s - s.max(axis=-1, keepdims=True)
    p = np.exp(s)
    p = p / p.sum(axis=-1, keepdims=True)
    o = np.einsum("hqk,khd->hqd", p, v)
    return np.transpose(o, (1, 0, 2))


def _online_accumulate(m, l, o, qf, kc, vc, mask=None):
    """One online-softmax block accumulate: m, l (h, bq) and o (h, bq, d)
    f32; qf the scaled f32 (bq, h, d) query rows; kc/vc (bk, h, d); mask
    bool (bq, bk), True = attend.  Fully masked rows contribute nothing."""
    s = torch.einsum("qhd,khd->hqk", qf, kc.float())
    if mask is not None:
        s = torch.where(mask[None], s, -math.inf)
    m_new = torch.maximum(m, s.amax(-1))
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.exp(s - m_safe[:, :, None])
    p = torch.where(torch.isfinite(s), p, 0.0)
    alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
    l_new = l * alpha + p.sum(-1)
    o_new = o * alpha[:, :, None] + torch.einsum("hqk,khd->hqd", p,
                                                 vc.float())
    return m_new, l_new, o_new


def _check_blocks(q_blocks, k_blocks, v_blocks):
    p = len(q_blocks)
    if p == 0 or len(k_blocks) != p or len(v_blocks) != p:
        raise ValueError(f"{len(q_blocks)}, {len(k_blocks)} and "
                         f"{len(v_blocks)} q/k/v blocks: need one each per "
                         "rank")
    shape = q_blocks[0].shape
    if len(shape) != 3 or any(x.shape != shape for x in
                              [*q_blocks, *k_blocks, *v_blocks]):
        raise ValueError(f"ring attention blocks must share one (block, "
                         f"heads, d) shape, got {tuple(shape)} and others")
    return p, shape


def ring_attention_kernel(q_blocks: Sequence[torch.Tensor],
                          k_blocks: Sequence[torch.Tensor],
                          v_blocks: Sequence[torch.Tensor],
                          causal: bool = False, scale: float | None = None
                          ) -> list[torch.Tensor]:
    """The plain ring: rank r's output (b, h, d) for rank r's q block, the
    K/V blocks moving one rank to the right (``pshift``) after each
    step."""
    p, (b, h, dh) = _check_blocks(q_blocks, k_blocks, v_blocks)
    sc = 1.0 / math.sqrt(dh) if scale is None else float(scale)
    qf, m, l, o = [], [], [], []
    for q in q_blocks:
        qf.append((q * torch.tensor(sc, dtype=q.dtype, device=q.device))
                  .float())
        m.append(torch.full((h, b), -math.inf, device=q.device))
        l.append(torch.zeros((h, b), device=q.device))
        o.append(torch.zeros((h, b, dh), device=q.device))
    kc, vc = list(k_blocks), list(v_blocks)
    rows = torch.arange(b)
    for step in range(p):
        for r in range(p):
            mask = None
            if causal:
                src = (r - step) % p         # the resident block's origin
                mask = ((src * b + rows[None, :]) <= (r * b + rows[:, None])
                        ).to(qf[r].device)
            m[r], l[r], o[r] = _online_accumulate(m[r], l[r], o[r], qf[r],
                                                  kc[r], vc[r], mask)
        if step < p - 1:
            kc, vc = pshift(kc, 1), pshift(vc, 1)
    outs = []
    for q, lr, orr in zip(q_blocks, l, o):
        lr = torch.where(lr == 0.0, 1.0, lr)
        outs.append((orr / lr[:, :, None]).to(q.dtype).transpose(0, 1)
                    .contiguous())
    return outs


def ring_attention_rdma(q_blocks: Sequence[torch.Tensor],
                        k_blocks: Sequence[torch.Tensor],
                        v_blocks: Sequence[torch.Tensor],
                        causal: bool = False, scale: float | None = None
                        ) -> list[torch.Tensor]:
    """The fused ring (K9): the CUDA kernel for CUDA tensors, the plain
    ring (``ring_attention_kernel``) for CPU tensors.  Rank r's q, k and v
    blocks share a device; ranks may share one card or sit on several
    (peer access)."""
    q_blocks, k_blocks, v_blocks = (list(x) for x in (q_blocks, k_blocks,
                                                      v_blocks))
    p, (b, h, dh) = _check_blocks(q_blocks, k_blocks, v_blocks)
    every = q_blocks + k_blocks + v_blocks
    kinds = {t.device.type for t in every}
    if kinds == {"cpu"}:
        return ring_attention_kernel(q_blocks, k_blocks, v_blocks, causal,
                                     scale)
    if kinds != {"cuda"}:
        raise ValueError(f"ring attention blocks on {sorted(kinds)}: the "
                         "kernel needs all of them on CUDA devices")
    dtype = q_blocks[0].dtype
    if dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != dtype for t in every):
        raise TypeError("the ring attention kernel takes float32 or bfloat16 "
                        "q/k/v of one dtype")
    if any(not t.is_contiguous() for t in every):
        raise ValueError("the ring attention kernel needs contiguous blocks")
    if any(q.device != k.device or q.device != v.device
           for q, k, v in zip(q_blocks, k_blocks, v_blocks)):
        raise ValueError("rank r's q, k and v blocks must share a device")
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"the ring attention kernel takes head dims up to "
                         f"{MAX_HEAD_DIM}, got {dh}")
    sc = 1.0 / math.sqrt(dh) if scale is None else float(scale)
    devs = [q.device for q in q_blocks]
    order = _Order(devs)
    outs = [torch.empty_like(q) for q in q_blocks]
    carry = [(torch.empty((h, b), device=d), torch.empty((h, b), device=d),
              torch.empty((h, b, dh), device=d)) for d in devs]
    bufs = [torch.empty((2, 2, b, h, dh), dtype=dtype, device=d)
            for d in devs] if p > 1 else []
    done = [order.mark(d) for d in devs]     # buffers allocated
    for t in range(p):
        prev, done = done, []
        for r, dev in enumerate(devs):
            left, right = (r - 1) % p, (r + 1) % p
            # the left neighbour finished writing this rank's resident
            # slot, the right one finished reading the slot written here
            order.wait(dev, [prev[left], prev[right]])
            kc, vc = ((k_blocks[r], v_blocks[r]) if t == 0
                      else tuple(bufs[r][t % 2]))
            fk, fv = (tuple(bufs[right][(t + 1) % 2]) if t < p - 1
                      else (None, None))
            ring_attn_step(q_blocks[r], kc, vc, outs[r], *carry[r], fk, fv,
                           r * b, ((r - t) % p) * b, causal, t == 0,
                           t == p - 1, sc)
            done.append(order.mark(dev))
    return outs


def _seq_blocks(q: DArray, k: DArray, v: DArray):
    """Validate sequence-sharded (seq, heads, d) DArrays over a 1-D grid
    and return their rank blocks (k and v brought onto q's layout)."""
    for name, a in (("q", q), ("k", k), ("v", v)):
        if a.ndim != 3:
            raise ValueError(f"{name} must be (seq, heads, head_dim), "
                             f"got {a.dims}")
        if a.dims != q.dims:
            raise ValueError("q, k, v dims must match")
    n = q.pids.size
    if q.pids.shape[0] != n or q.dims[0] % n != 0:
        raise ValueError(
            "ring attention needs the sequence dim sharded evenly over a "
            f"1-D grid; got grid {q.pids.shape} for dims {q.dims}")
    blocks = []
    for a in (q, k, v):
        parts = relayout_parts(a, q.pids, q.cuts)
        blocks.append([parts[r, 0, 0] for r in range(n)])
    return blocks


def _like(q: DArray, outs) -> DArray:
    parts = np.empty(q.grid, dtype=object)
    for r, t in enumerate(outs):
        parts[r, 0, 0] = t
    return q.with_parts(parts)


def ring_attention(q: DArray, k: DArray, v: DArray,
                   causal: bool = False) -> DArray:
    """Exact attention over sequence-sharded (seq, heads, d) DArrays through
    the fused ring (K9 on CUDA ranks); the result has q's layout."""
    qb, kb, vb = _seq_blocks(q, k, v)
    return _like(q, ring_attention_rdma(qb, kb, vb, causal))


def ring_flash_attention(q: DArray, k: DArray, v: DArray,
                         causal: bool = False) -> DArray:
    """Exact attention over sequence-sharded (seq, heads, d) DArrays as p
    flash hops per rank (K8 on CUDA ranks) with the (m, l, acc) carry
    resident and the K/V blocks rotating by ``pshift``."""
    qb, kb, vb = _seq_blocks(q, k, v)
    p = len(qb)
    b, h, dh = qb[0].shape
    qh, kc, vc = ([x.transpose(0, 1).contiguous() for x in xs]
                  for xs in (qb, kb, vb))
    carry = [flash_carry_init(h, b, dh, device=x.device) for x in qh]
    for step in range(p):
        for r in range(p):
            flash_attention_hop(qh[r], kc[r], vc[r], *carry[r], r * b,
                                ((r - step) % p) * b, causal)
        if step < p - 1:
            kc, vc = pshift(kc, 1), pshift(vc, 1)
    outs = [flash_carry_finalize(*c, q.dtype)[0].transpose(0, 1).contiguous()
            for c in carry]
    return _like(q, outs)


def ring_attention_prefill(q, k, v, *, causal: bool = True,
                           procs: list[int] | None = None,
                           min_ring_tokens: int | None = None) -> np.ndarray:
    """Prefill entry of the decode service: exact attention over host
    (ntok, heads, head_dim) q/k/v rows (as float32), returning a host
    (ntok, heads, head_dim) float32 array.

    Long causal prompts ride the ring: the rows are end-padded with zeros
    to a multiple of the rank count (safe under the causal mask: no real
    query row attends to a later padded key), distributed, run through
    ``ring_attention``, gathered and trimmed, and the scratch DArrays are
    closed.  Short prompts (below ``min_ring_tokens``, default twice the
    rank count), non-causal calls and single ranks take the dense
    ``reference_attention`` oracle."""
    q, k, v = (np.asarray(x, np.float32) for x in (q, k, v))
    if q.ndim != 3:
        raise ValueError(f"q must be (ntok, heads, head_dim), got {q.shape}")
    ntok = q.shape[0]
    pids = [int(p) for p in (procs if procs is not None else L.all_ranks())]
    n = max(1, len(pids))
    floor = 2 * n if min_ring_tokens is None else int(min_ring_tokens)
    if not causal or n < 2 or ntok < max(floor, n):
        return reference_attention(q, k, v, causal)
    pad = (-ntok) % n
    if pad:
        z = np.zeros((pad,) + q.shape[1:], q.dtype)
        q, k, v = (np.concatenate([a, z]) for a in (q, k, v))
    made = []
    try:
        for a in (q, k, v):
            made.append(distribute(a, procs=pids, dist=[n, 1, 1]))
        made.append(ring_attention(*made[:3], causal=True))
        return np.asarray(made[3])[:ntok]
    finally:
        for d in made:
            d.close()
