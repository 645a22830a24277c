"""Ring attention: sequence-parallel exact attention over rank tensors.

PyTorch counterpart of ``distributedarrays_tpu/models/ring_attention.py``.  Q, K and V are sequence-sharded over a 1-D rank grid:
rank r holds rows ``[r*b, (r+1)*b)`` as a (b, heads, d) block.  In p steps
every rank accumulates its q block against the K/V block currently
resident with an online softmax (running max m, normaliser l, accumulator
o), and the K/V blocks move one rank to the right between steps.

- ``ring_attention_kernel(q_blocks, k_blocks, v_blocks, causal, scale)``:
  the plain ring over a rank list, ``pshifts`` rotating K/V, with the
  numerics of the JAX ``_online_accumulate`` (q scaled in its own type,
  then f32; f32 products and softmax).  It is the plain version of K9.
- ``ring_step_plan(p, b, rank, step, causal)``: which block rank ``rank``
  holds at ring step ``step`` and whether it accumulates against it.  A
  causal step whose resident block lies wholly after the rank's q block
  is masked for every query row; the JAX kernel runs it through its
  ``isfinite`` guards, which leave m, l and o bit for bit as they were, so
  both rings here skip it (causal on 4 ranks: 10 of the 16 steps
  accumulate).
- ``ring_attention_rdma(...)``: the same ring as the CUDA kernel K9
  (``csrc/attention.cu`` ``da_ring_attn_step``): one launch per rank per
  step forwards the resident pair into the right neighbour's free slot
  and accumulates in the same f32 numerics, with the carry in device
  memory; a step the plan skips only forwards.  The plain ring for CPU
  tensors.
- ``ring_flash_attention_kernel(q_blocks, k_blocks, v_blocks, causal,
  scale)``: the ring as p flash hops per rank (K8,
  ``ops.cuda_attention.flash_attention_hop``) with the (m, l, acc) carry
  resident and the K and V blocks rotating together by one ``pshifts`` a
  step (a plain copy between ranks, as ``lax.ppermute`` is no Pallas
  kernel).  Differentiable: the FlashAttention-2 ring backward
  (``_ring_flash_core``'s VJP) runs p hops of K6 + K7
  (``flash_attention_hop_bwd``) from the saved output and lse; dq
  accumulates on its rank, the f32 dk/dv accumulators travel with their
  K/V blocks (K, V, dK and dV in one ``pshifts`` a step), and one extra
  rotation brings them home.
- The zigzag layout (``zigzag_order``, ``zigzag_shard``,
  ``zigzag_unshard``): rank i holds sequence chunks i and 2p-1-i, so causal
  work is balanced.  ``zigzag_ring_attention_kernel`` is the plain
  quadrant ring on ``_online_accumulate``;
  ``zigzag_ring_flash_attention_kernel`` runs each quadrant a step needs
  as one K8 half-block hop (cross quadrants maskless, diagonals causal at
  the global chunk offsets) and is differentiable, its backward re-running
  the quadrants as K6 + K7 hops.  The JAX ``lax.switch`` on
  sign(src - me) is a Python branch per rank and step.
- ``ring_attention(q, k, v, causal)`` on DArrays runs K9;
  ``ring_flash_attention(q, k, v, causal)`` the flash ring (K8);
  ``zigzag_ring_attention`` and ``zigzag_ring_flash_attention`` the two
  zigzag rings on zigzag-ordered DArrays; ``ring_attention_prefill`` is
  the decode service's prefill entry; ``reference_attention`` is the dense
  numpy oracle.

In a job of several controller processes (``parallel.multihost``)
another process's blocks are ``meta`` placeholders.  ``ring_attention``
runs K9 on each process's own ranks (``_ring_rdma_job``): each process
publishes the CUDA IPC handles of its ranks' two-slot K/V buffers once a
call, maps its right neighbour's when that rank is another process's,
and passes the mapped slot's address as the step's forward target; the
steps are ordered across processes by a stream sync and a store barrier
after each (``multihost.sync_hosts``), and the mappings close before the
call's closing barrier.  Off the card the plain ring runs on the
cross-process ``pshifts``.  The flash rings take their hops (K8 forward,
K6 + K7 backward) for this process's ranks only, another process's carry,
outputs and gradients being placeholders, and their rotations are the
cross-process ``pshifts`` (one exchange a step: one K10 launch a process
on the card); the plain zigzag ring skips the placeholder ranks and runs
on the same ``pshifts``, which are differentiable in a job (the backward
shifts the gradients back).

Every process must enter those exchanges in the same order.  Forward,
the program order fixes it.  Backward, every collective sits inside
``_FlashRing.backward`` (or a ``pshifts`` node of a plain ring, or the
ring GEMMs' Functions in ``ops.collective_matmul``), and every process's
loss reaches every such node: the flash rings are one Function, each rank
of the zigzag ring works at every step, and the causal contiguous plain
ring, whose plan leaves rank 0 nothing after step 0, ties each output to
the blocks of its last rotation (``_Tie``).  Each such node needs
the gradients of all its outputs, which come through the nodes of the
layers after it, so in a model the ring nodes form one chain and run in
the same order everywhere; and the model train steps run the backward on
the calling thread (``models._autodiff.value_and_grad``), where the
engine takes the ready nodes by their sequence numbers (the order in
which the forward made them), the same on every process, since each
builds the same graph (placeholders stand in for the other processes'
tensors).

Two behaviours of the JAX package are not carried over.  Its
``ring_attention`` falls back from the RDMA kernel to the XLA ring when
the kernel raises (``try``/``except``), and ``ring_attention_rdma_kernel``
takes the XLA ring when its VMEM budget gate says the blocks do not fit.
Here a kernel that fails raises, and there is no VMEM: the blocks and the
carry stay in device memory, so every size the card holds runs the
kernel.  The TPU hop knobs ``block_q``, ``block_k``, ``head_fold`` and
``interpret`` and their autotune lookup have no counterpart (see
``ops.cuda_attention``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .. import layout as L
from ..darray import DArray, distribute
from ..ops.cuda_attention import (MAX_HEAD_DIM, flash_attention_hop,
                                  flash_attention_hop_bwd,
                                  flash_carry_finalize, flash_carry_init,
                                  ring_attn_step)
from ..ops import cuda_collectives as CC
from ..ops import ring_schedules as _rs
from ..ops.cuda_collectives import _Order
from ..parallel import multihost
from ..parallel.collectives import pshifts
from ..utils import kbuild
from ..parallel.reshard import relayout_parts

__all__ = ["ring_attention", "ring_attention_kernel", "ring_attention_rdma",
           "ring_step_plan", "RingStep", "ring_attention_prefill",
           "ring_flash_attention",
           "ring_flash_attention_kernel", "zigzag_order", "zigzag_shard",
           "zigzag_unshard", "zigzag_ring_attention_kernel",
           "zigzag_ring_flash_attention_kernel", "zigzag_ring_attention",
           "zigzag_ring_flash_attention", "reference_attention"]


def reference_attention(q, k, v, causal: bool = False):
    """Dense O(seq^2) oracle over (seq, heads, d) arrays: numpy on the host
    for arrays (JAX's numerics: the float64 scale promotes the scores to
    float64), and float32 torch on q's device for tensors (the decode
    engine's plain prefill on the card)."""
    if isinstance(q, torch.Tensor):
        q, k, v = (torch.as_tensor(x).float().to(q.device)
                   for x in (q, k, v))
        s = torch.einsum("qhd,khd->hqk", q / math.sqrt(q.shape[-1]), k)
        if causal:
            qi = torch.arange(q.shape[0], device=q.device)[:, None]
            ki = torch.arange(k.shape[0], device=q.device)[None, :]
            s = s.masked_fill(~(ki <= qi)[None], -math.inf)
        s = s - s.amax(-1, keepdim=True)
        p = torch.exp(s)
        p = p / p.sum(-1, keepdim=True)
        return torch.einsum("hqk,khd->qhd", p, v)
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


class RingStep(NamedTuple):
    src: int          # the rank whose K/V block is resident
    compute: bool     # whether any of the rank's query rows sees a key of it


def ring_step_plan(p: int, b: int, rank: int, step: int,
                   causal: bool) -> RingStep:
    """Rank ``rank``'s work at step ``step`` of a ring of ``p`` ranks with
    ``b`` rows each: the resident block comes from ``src = (rank - step)
    mod p``; a causal step accumulates only when ``src <= rank``, since a
    later block's first key lies after the rank's last query row."""
    src = (rank - step) % p
    return RingStep(src, b > 0 and (not causal or src <= rank))


def ring_attention_kernel(q_blocks: Sequence[torch.Tensor],
                          k_blocks: Sequence[torch.Tensor],
                          v_blocks: Sequence[torch.Tensor],
                          causal: bool = False, scale: float | None = None
                          ) -> list[torch.Tensor]:
    """The plain ring: rank r's output (b, h, d) for rank r's q block, the
    K/V blocks moving one rank to the right (``pshifts``) after each step;
    the steps ``ring_step_plan`` skips are not accumulated."""
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
            src, compute = ring_step_plan(p, b, r, step, causal)
            if not compute:
                continue
            mask = None
            if causal:
                mask = ((src * b + rows[None, :]) <= (r * b + rows[:, None])
                        ).to(qf[r].device)
            m[r], l[r], o[r] = _online_accumulate(m[r], l[r], o[r], qf[r],
                                                  kc[r], vc[r], mask)
        if step < p - 1:
            kc, vc = pshifts([kc, vc], 1)
    outs = []
    for q, lr, orr, kr, vr in zip(q_blocks, l, o, kc, vc):
        lr = torch.where(lr == 0.0, 1.0, lr)
        out = (orr / lr[:, :, None]).to(q.dtype).transpose(0, 1).contiguous()
        if out.requires_grad:
            out = _Tie.apply(out, kr, vr)
        outs.append(out)
    return outs


class _Tie(torch.autograd.Function):
    """``out`` unchanged, hung on the K/V blocks resident at the ring's
    last step with no gradient to them.  A causal plan skips every step
    after the first on rank 0, so without it a process holding only rank 0
    would leave the later rotations out of its graph: in a job it would
    not enter their backward exchanges (its peers would wait out the
    store timeout) and would miss the other ranks' dK/dV.  With it every
    process's loss reaches every rotation; in one process it changes no
    gradient."""

    @staticmethod
    def forward(ctx, out, *deps):
        ctx.ndeps = len(deps)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, grad):
        return (grad, *[None] * ctx.ndeps)


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
    # in a job another process's blocks are placeholders
    kinds = {t.device.type for t in every} - {"meta"}
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
    if multihost.in_job():
        return _ring_rdma_job(q_blocks, k_blocks, v_blocks, causal, sc)
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
            src, compute = ring_step_plan(p, b, r, t, causal)
            ring_attn_step(q_blocks[r], kc, vc, outs[r], *carry[r], fk, fv,
                           r * b, src * b, causal, t == 0, t == p - 1, sc,
                           compute)
            done.append(order.mark(dev))
    return outs


class _Peer:
    """A forward slot in another controller process's memory, mapped into
    this one: its device address, all ``ring_attn_step`` reads of it."""

    def __init__(self, ptr: int):
        self.ptr = ptr

    def data_ptr(self) -> int:
        return self.ptr


def _ring_rdma_job(q_blocks, k_blocks, v_blocks, causal: bool,
                   sc: float) -> list[torch.Tensor]:
    """K9's ring in a job of several controller processes, each launching
    the steps of its own ranks (another process's blocks are placeholders,
    and so are their outputs).  Each process allocates its ranks' two-slot
    K/V buffers and publishes their CUDA IPC handles once a call (through
    the job's store); a rank whose right neighbour belongs to another
    process forwards into that neighbour's slot through the mapping, a
    pointer passed to ``ring_attn_step`` as its ``fk``/``fv``.  The step
    order across processes is a stream sync and a store barrier after
    each step (``multihost.sync_hosts``): no rank reads a slot before its
    left neighbour's previous step has written it, nor overwrites one its
    right neighbour still reads.  The call is a ``peer_call``
    (``ops.cuda_collectives``): the mappings close after the last step's
    sync and before the call's closing barrier."""
    p, (b, h, dh) = _check_blocks(q_blocks, k_blocks, v_blocks)
    dtype = q_blocks[0].dtype
    mine = [r for r in range(p) if q_blocks[r].device.type != "meta"]
    devs = {q_blocks[r].device for r in mine}
    outs = [torch.empty_like(q) for q in q_blocks]
    carry = {r: tuple(torch.empty(s, device=q_blocks[r].device)
                      for s in ((h, b), (h, b), (h, b, dh))) for r in mine}
    bufs = {r: torch.empty((2, 2, b, h, dh), dtype=dtype,
                           device=q_blocks[r].device) for r in mine}
    slot = b * h * dh * q_blocks[0].element_size()    # bytes of one K or V
    meta = torch.empty(0, device="meta")
    with CC.peer_call(
            [[bufs[r] if r in bufs and p > 1 else meta for r in range(p)]],
            lambda obj: multihost._all_gather_json("ring_attention", obj),
            lambda: multihost.sync_hosts("ring_attention"),
            devs) as (every, mapped):
        theirs = {k: v for part in every for k, v in part.items()}

        def forward_slots(r: int, s: int):
            right = (r + 1) % p
            if right in bufs:
                return tuple(bufs[right][s])
            hd, off, _ = theirs[f"0/{right}"]
            base = mapped.base(bytes.fromhex(hd), q_blocks[r].device) + \
                int(off) + 2 * s * slot
            return _Peer(base), _Peer(base + slot)
        for t in range(p):
            for r in mine:
                kc, vc = ((k_blocks[r], v_blocks[r]) if t == 0
                          else tuple(bufs[r][t % 2]))
                fk, fv = (forward_slots(r, (t + 1) % 2) if t < p - 1
                          else (None, None))
                src, compute = ring_step_plan(p, b, r, t, causal)
                ring_attn_step(q_blocks[r], kc, vc, outs[r], *carry[r], fk,
                               fv, r * b, src * b, causal, t == 0,
                               t == p - 1, sc, compute)
                if isinstance(fk, _Peer):
                    kbuild.count_route("ring_attention_forward",
                                       "cross_process")
            for dev in devs:
                torch.cuda.synchronize(dev)
                _rs.record("sync")
            if t < p - 1:
                multihost.sync_hosts("ring_attention_step")
    return outs


def _seq_blocks(q: DArray, k: DArray, v: DArray):
    """Validate sequence-sharded (seq, heads, d) DArrays over a 1-D grid
    and return their rank blocks (k and v brought onto q's layout; in a
    job another process's blocks are placeholders)."""
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


def _heads_first(blocks) -> list[torch.Tensor]:
    """(b, h, d) rank blocks as contiguous (h, b, d) copies."""
    return [x.transpose(0, 1).contiguous() for x in blocks]


def _rows_first(blocks, dtype) -> list[torch.Tensor]:
    """(h, b, d) rank blocks as contiguous (b, h, d) blocks of ``dtype``."""
    return [x.transpose(0, 1).to(dtype).contiguous() for x in blocks]


def _bwd_inputs(gs, ohs, dtype):
    """Per rank: dd = rowsum(g * o) (h, b) in f32 from the full-precision
    cotangent, and the cotangent as the kernels' (h, b, d) operand in q's
    type."""
    dd, gh = [], []
    for g, oh in zip(gs, ohs):
        gf = g.transpose(0, 1).float()
        dd.append((gf * oh.float()).sum(-1).contiguous())
        gh.append(gf.to(dtype).contiguous())
    return dd, gh


def _real(t: torch.Tensor) -> bool:
    """Whether this process holds the rank's tensor (in a job another
    process's ranks are ``meta`` placeholders)."""
    return t.device.type != "meta"


class _FlashRing(torch.autograd.Function):
    """A ring of flash hops over rank lists, differentiable: K8 hops
    forward, K6 + K7 hops backward (``_ring_flash_core`` and
    ``_zigzag_flash_core`` with their VJPs in the JAX package).  Each rank's
    blocks are cut into ``parts`` equal row parts; ``hops(p, b, r, src)``
    lists the hops rank r takes against the K/V block from rank ``src`` as
    ``(q part, k part, q offset, k offset, causal)``, in order.  The f32
    (m, l, acc) carry of each q part stays on its rank and the K and V
    blocks move one rank right after each step, together in one
    ``pshifts``; backward, dq accumulates on its rank, the f32 dk/dv
    accumulators travel with their blocks (K, V, dK and dV in one
    ``pshifts`` a step) and one more rotation of dK and dV after the last
    step brings them home.  Only the ranks this process holds take hops;
    another process's carry, outputs and gradients are placeholders."""

    @staticmethod
    def forward(ctx, hops, parts, scale, *blocks):
        p = len(blocks) // 3
        qs, ks, vs = blocks[:p], blocks[p:2 * p], blocks[2 * p:]
        b, h, dh = qs[0].shape
        m = b // parts
        part = lambda x, i: x[:, i * m:(i + 1) * m]
        qh, kh, vh = _heads_first(qs), _heads_first(ks), _heads_first(vs)
        mine = [r for r in range(p) if _real(qh[r])]
        kc, vc = kh, vh
        carry = {r: [flash_carry_init(h, m, dh, device=qh[r].device)
                     for _ in range(parts)] for r in mine}
        for step in range(p):
            for r in mine:
                for qi, ki, qoff, koff, causal in hops(p, b, r,
                                                       (r - step) % p):
                    flash_attention_hop(part(qh[r], qi), part(kc[r], ki),
                                        part(vc[r], ki), *carry[r][qi], qoff,
                                        koff, causal, scale)
            if step < p - 1:
                kc, vc = pshifts([kc, vc], 1)
        dt = qs[0].dtype
        ohs, lses = [], []
        for r, x in enumerate(qh):
            if r not in carry:
                ohs.append(torch.empty(x.shape, dtype=dt, device=x.device))
                lses.append(torch.empty((h, b), device=x.device))
                continue
            fin = [flash_carry_finalize(*c, dt) for c in carry[r]]
            ohs.append(torch.cat([o for o, _ in fin], dim=1))
            lses.append(torch.cat([lse for _, lse in fin], dim=1))
        ctx.hops, ctx.parts, ctx.scale = hops, parts, scale
        ctx.save_for_backward(*qh, *kh, *vh, *ohs, *lses)
        return tuple(_rows_first(ohs, dt))

    @staticmethod
    def backward(ctx, *gs):
        p, parts = len(gs), ctx.parts
        sv = ctx.saved_tensors
        qh, kc, vc, ohs, lse = (list(sv[i * p:(i + 1) * p]) for i in range(5))
        h, b, dh = qh[0].shape
        m = b // parts
        part = lambda x, i: x[:, i * m:(i + 1) * m]
        mine = [r for r in range(p) if _real(qh[r])]
        dd, gh = _bwd_inputs(gs, ohs, qh[0].dtype)
        # the kernels take each part's lse and dd rows contiguous
        dd = [[part(x, i).contiguous() for i in range(parts)] for x in dd]
        lse = [[part(x, i).contiguous() for i in range(parts)] for x in lse]
        dq = [torch.zeros((h, b, dh), device=x.device) for x in qh]
        dk = [torch.zeros_like(x) for x in dq]
        dv = [torch.zeros_like(x) for x in dq]
        for step in range(p):
            for r in mine:
                for qi, ki, qoff, koff, causal in ctx.hops(p, b, r,
                                                           (r - step) % p):
                    c = flash_attention_hop_bwd(
                        part(qh[r], qi), part(kc[r], ki), part(vc[r], ki),
                        part(gh[r], qi), lse[r][qi], dd[r][qi], qoff, koff,
                        causal, ctx.scale)
                    part(dq[r], qi).add_(c[0])
                    part(dk[r], ki).add_(c[1])
                    part(dv[r], ki).add_(c[2])
            if step < p - 1:
                kc, vc, dk, dv = pshifts([kc, vc, dk, dv], 1)
            else:
                dk, dv = pshifts([dk, dv], 1)
        dt = qh[0].dtype
        return (None, None, None, *_rows_first(dq, dt), *_rows_first(dk, dt),
                *_rows_first(dv, dt))


def _ring_hops(causal: bool):
    """The contiguous ring's schedule: one hop of the whole block."""
    def hops(p, b, r, src):
        return [(0, 0, r * b, src * b, causal)]
    return hops


def ring_flash_attention_kernel(q_blocks: Sequence[torch.Tensor],
                                k_blocks: Sequence[torch.Tensor],
                                v_blocks: Sequence[torch.Tensor],
                                causal: bool = False,
                                scale: float | None = None
                                ) -> list[torch.Tensor]:
    """The flash ring: rank r's (b, h, d) output for its q block, as p K8
    hops per rank with the K/V blocks moving one rank to the right
    (``pshifts``) after each; differentiable in q, k and v (the FA2 ring
    backward on K6 + K7 hops).  The plain hops for CPU tensors; in a job,
    this process's ranks' hops, another process's outputs placeholders."""
    qs, ks, vs = list(q_blocks), list(k_blocks), list(v_blocks)
    _check_blocks(qs, ks, vs)
    return list(_FlashRing.apply(_ring_hops(bool(causal)), 1, scale, *qs,
                                 *ks, *vs))


def ring_flash_attention(q: DArray, k: DArray, v: DArray,
                         causal: bool = False) -> DArray:
    """Exact attention over sequence-sharded (seq, heads, d) DArrays as p
    flash hops per rank (K8 on CUDA ranks) with the (m, l, acc) carry
    resident and the K/V blocks rotating by ``pshifts``."""
    qb, kb, vb = _seq_blocks(q, k, v)
    return _like(q, ring_flash_attention_kernel(qb, kb, vb, causal))


# ---------------------------------------------------------------------------
# zigzag (load-balanced causal) ring attention
#
# Rank i holds the chunk pair (i, 2p-1-i) of 2p equal chunks.  Local
# (q1, q2) = chunks (me, 2p-1-me); visiting (k1, k2) from src:
#   q1 x k2: always fully masked    -> never computed
#   q2 x k1: always fully unmasked  -> computed maskless
#   q1 x k1: unmasked iff src < me, diagonal iff src == me
#   q2 x k2: unmasked iff src > me, diagonal iff src == me
# so each rank computes about 2 of 4 quadrants a hop, evenly balanced.
# ---------------------------------------------------------------------------


def zigzag_order(S: int, nranks: int) -> np.ndarray:
    """Permutation taking a natural-order sequence to zigzag-shard order:
    rank i's rows are [chunk i, chunk 2p-1-i] of 2p equal chunks."""
    if S % (2 * nranks):
        raise ValueError(f"sequence length {S} must divide 2*nranks "
                         f"({2 * nranks})")
    half = S // (2 * nranks)
    chunks = np.arange(S).reshape(2 * nranks, half)
    order = [c for i in range(nranks)
             for c in (chunks[i], chunks[2 * nranks - 1 - i])]
    return np.concatenate(order)


def zigzag_shard(x, nranks: int) -> torch.Tensor:
    """Reorder dim 0 of ``x`` (length S, natural order) into zigzag-shard
    order.  Apply before distributing over the ring."""
    x = torch.as_tensor(x)
    idx = torch.from_numpy(zigzag_order(x.shape[0], nranks)).to(x.device)
    return x[idx]


def zigzag_unshard(x, nranks: int) -> torch.Tensor:
    """Inverse of ``zigzag_shard``."""
    x = torch.as_tensor(x)
    inv = np.argsort(zigzag_order(x.shape[0], nranks))
    return x[torch.from_numpy(inv).to(x.device)]


def _zigzag_half(b: int) -> int:
    if b % 2:
        raise ValueError(f"zigzag needs an even local block; got {b}")
    return b // 2


def _quadrants(me: int, src: int):
    """The quadrants rank ``me`` computes against the K/V pair from rank
    ``src``, in the JAX schedule's order: ``(q half, k half, causal)`` with
    halves 0 (chunk me / src) and 1 (chunk 2p-1-me / 2p-1-src)."""
    quads = [(1, 0, False)]                 # q2 x k1: always unmasked
    if src < me:
        quads.append((0, 0, False))
    elif src == me:
        quads += [(0, 0, True), (1, 1, True)]
    else:
        quads.append((1, 1, False))
    return quads


def _chunk_off(rank: int, which: int, p: int, half: int) -> int:
    """Global position of rank ``rank``'s chunk ``which`` (0 or 1)."""
    return (rank if which == 0 else 2 * p - 1 - rank) * half


def zigzag_ring_attention_kernel(q_blocks: Sequence[torch.Tensor],
                                 k_blocks: Sequence[torch.Tensor],
                                 v_blocks: Sequence[torch.Tensor],
                                 scale: float | None = None
                                 ) -> list[torch.Tensor]:
    """The plain causal zigzag ring: rank r's (b, h, d) output for its
    zigzag pair, computing only the quadrants that can attend, with the
    JAX ``_online_accumulate`` numerics (q scaled in its own type, then
    f32).  In a job, this process's ranks' quadrants, another process's
    outputs placeholders; differentiable through ``pshifts``."""
    p, (b, h, dh) = _check_blocks(q_blocks, k_blocks, v_blocks)
    half = _zigzag_half(b)
    sc = 1.0 / math.sqrt(dh) if scale is None else float(scale)
    diag = torch.tril(torch.ones((half, half), dtype=torch.bool))
    mine = [r for r in range(p) if _real(q_blocks[r])]
    qf, carry = {}, {}
    for r in mine:
        q = q_blocks[r]
        f = (q * torch.tensor(sc, dtype=q.dtype, device=q.device)).float()
        qf[r] = (f[:half], f[half:])
        carry[r] = [[torch.full((h, half), -math.inf, device=q.device),
                     torch.zeros((h, half), device=q.device),
                     torch.zeros((h, half, dh), device=q.device)]
                    for _ in range(2)]
    kc, vc = list(k_blocks), list(v_blocks)
    for step in range(p):
        for r in mine:
            src = (r - step) % p
            for qi, ki, causal in _quadrants(r, src):
                ks = slice(ki * half, (ki + 1) * half)
                carry[r][qi] = list(_online_accumulate(
                    *carry[r][qi], qf[r][qi], kc[r][ks], vc[r][ks],
                    diag.to(qf[r][qi].device) if causal else None))
        if step < p - 1:
            kc, vc = pshifts([kc, vc], 1)
    outs = []
    for r, q in enumerate(q_blocks):
        if r not in carry:
            outs.append(torch.empty_like(q))
            continue
        halves = []
        for _, l, o in carry[r]:
            l = torch.where(l == 0.0, 1.0, l)
            halves.append((o / l[:, :, None]).to(q.dtype))
        outs.append(torch.cat(halves, dim=1).transpose(0, 1).contiguous())
    return outs


def _zigzag_hops(p, b, r, src):
    """The zigzag ring's schedule: the quadrants ``_quadrants`` picks, on
    half blocks at their chunks' global offsets."""
    half = b // 2
    return [(qi, ki, _chunk_off(r, qi, p, half), _chunk_off(src, ki, p, half),
             causal) for qi, ki, causal in _quadrants(r, src)]


def zigzag_ring_flash_attention_kernel(q_blocks: Sequence[torch.Tensor],
                                       k_blocks: Sequence[torch.Tensor],
                                       v_blocks: Sequence[torch.Tensor],
                                       scale: float | None = None
                                       ) -> list[torch.Tensor]:
    """The fused zigzag ring: the quadrant schedule of
    ``zigzag_ring_attention_kernel`` with each computed quadrant one K8
    hop on half blocks (cross quadrants maskless, diagonals causal at the
    global chunk offsets); differentiable in q, k and v, the backward
    re-running the quadrants as K6 + K7 hops.  The plain hops for CPU
    tensors."""
    qs, ks, vs = list(q_blocks), list(k_blocks), list(v_blocks)
    _, (b, _, _) = _check_blocks(qs, ks, vs)
    _zigzag_half(b)
    return list(_FlashRing.apply(_zigzag_hops, 2, scale, *qs, *ks, *vs))


def _zigzag_blocks(q: DArray, k: DArray, v: DArray):
    """Validate zigzag-ordered sequence-sharded DArrays (the sequence
    divisible by twice the rank count) and return their rank blocks."""
    for name, a in (("q", q), ("k", k), ("v", v)):
        if a.ndim != 3:
            raise ValueError(f"{name} must be (seq, heads, head_dim), "
                             f"got {a.dims}")
        if a.dims != q.dims:
            raise ValueError("q, k, v dims must match")
    n = q.pids.size
    if q.pids.shape[0] != n or q.dims[0] % (2 * n) != 0:
        raise ValueError(
            "zigzag ring attention needs the sequence dim divisible by "
            f"2*nranks over a 1-D grid; got grid {q.pids.shape} for dims "
            f"{q.dims}")
    return _seq_blocks(q, k, v)


def zigzag_ring_flash_attention(q: DArray, k: DArray, v: DArray) -> DArray:
    """Causal zigzag ring attention over zigzag-ordered sequence-sharded
    (seq, heads, d) DArrays as K8 half-block hops (the fast path of
    ``zigzag_ring_attention``); the output is zigzag-ordered."""
    return _like(q, zigzag_ring_flash_attention_kernel(
        *_zigzag_blocks(q, k, v)))


def zigzag_ring_attention(q: DArray, k: DArray, v: DArray) -> DArray:
    """Load-balanced causal ring attention over sequence-sharded (seq,
    heads, d) DArrays whose rows are already in zigzag order
    (``zigzag_shard``), on the plain quadrant ring.  Returns
    zigzag-ordered output: ``zigzag_unshard`` recovers natural order."""
    return _like(q, zigzag_ring_attention_kernel(*_zigzag_blocks(q, k, v)))


def ring_attention_prefill(q, k, v, *, causal: bool = True,
                           procs: list[int] | None = None,
                           min_ring_tokens: int | None = None):
    """Prefill entry of the decode service: exact attention over
    (ntok, heads, head_dim) q/k/v rows as float32, returning the
    (ntok, heads, head_dim) float32 output: a host array for host arrays,
    a tensor on q's device for tensors.

    Long causal prompts ride the ring: the rows are end-padded with zeros
    to a multiple of the rank count (safe under the causal mask: no real
    query row attends to a later padded key), distributed, run through
    ``ring_attention`` (K9 on CUDA ranks), gathered and trimmed, and the
    scratch DArrays are closed.  Short prompts (below ``min_ring_tokens``,
    default twice the rank count), non-causal calls and single ranks take
    the dense ``reference_attention`` oracle."""
    if isinstance(q, torch.Tensor):
        q, k, v = (torch.as_tensor(x).float().to(q.device)
                   for x in (q, k, v))
    else:
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
    host = not isinstance(q, torch.Tensor)
    if pad:
        if host:
            z = np.zeros((pad,) + q.shape[1:], q.dtype)
            q, k, v = (np.concatenate([a, z]) for a in (q, k, v))
        else:
            z = q.new_zeros((pad,) + tuple(q.shape[1:]))
            q, k, v = (torch.cat([a, z]) for a in (q, k, v))
    made = []
    try:
        for a in (q, k, v):
            made.append(distribute(a, procs=pids, dist=[n, 1, 1]))  # dalint: disable=DAL006 — the three inputs and the result are closed in the finally below
        made.append(ring_attention(*made[:3], causal=True))
        if host:
            return np.asarray(made[3])[:ntok]
        return made[3].region([(0, ntok), (0, q.shape[1]),
                               (0, q.shape[2])], q.device)
    finally:
        for d in made:
            d.close()
