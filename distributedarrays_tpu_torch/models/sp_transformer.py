"""Sequence-parallel transformer: long-context training over rank lists.

PyTorch counterpart of ``distributedarrays_tpu/models/sp_transformer.py``.
The JAX module runs one ``shard_map`` program per step; the port runs a
single controller, so the program becomes a function over rank lists (one
tensor per rank, on that rank's device) and one autograd graph spans all
ranks.  Activations stay sequence-sharded ``(b, s_loc, e)`` end to end:

- attention: ``ring_flash_attention_kernel`` (K8 hops forward, K6 + K7
  hops backward), or with ``cfg.zigzag`` the load-balanced
  ``zigzag_ring_flash_attention_kernel`` (rank i holds the chunk pair
  ``(i, 2p-1-i)``; feed tokens permuted by ``ring_attention.zigzag_order``);
- FFN: ``tp_ffn`` (ring all-gather GEMM K13 -> gelu -> GEMM +
  reduce-scatter K15, Megatron sequence-parallel layout; its gradients run
  K15, K13 and K14);
- loss: next-token cross-entropy, the shift crossing rank boundaries by
  ``pshift`` of the first token column, masked at the global end.

The JAX program runs over any mesh, one that spans processes included.
In a job of several controller processes (``parallel.multihost``) every
process calls the same functions with the same tokens: ``shard_params``
builds its own ranks' parameter sets (placeholders on the ``meta`` device
for the other processes' ranks), the rings launch their kernels for its
own ranks, each process differentiates its own ranks' partial losses
(``make_grad_fn`` says why the processes' collectives stay in step), the
loss and the replicated gradients come out the same bits as one process
gives on the same ranks, and ``unshard`` gathers the whole dicts on every
process.

The batch folds into the heads for attention and into the rows for the
FFN, as in the JAX model.  The gradient of the sum of the ranks' partial
losses with respect to each rank's own parameter copy is the per-rank
gradient of JAX's ``value_and_grad`` under ``shard_map(check=False)``; the
replicated parameters' gradients are then summed over ranks (``preduce``),
as ``_grad_program`` does, and the FFN shards' stay.

The TPU knobs ``block_q``, ``block_k``, ``head_fold`` and ``interpret``
and ``_resolve_cfg``'s autotune lookup have no counterpart: they only pick
the Pallas hops' tiles, and the CUDA hops' tiles are fixed for the card
(``ops.cuda_attention``).  Where JAX takes the mesh, the port takes the
rank list; the per-rank parameters come from ``shard_params``, and from the
JAX pytree through ``interop.params_from_reference`` then
``shard_params``.  optax is JAX: ``make_optax_train_step`` takes a
``train.optim.Optimizer``.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .. import layout as L
from ..layout import device_of
from ..ops.collective_matmul import tp_ffn
from ..parallel import multihost
from ..parallel.collectives import pconcat, preduce, preduces, pshift
from ._autodiff import f32_opt_init, f32_opt_update_, sgd_, value_and_grad
from .ring_attention import (ring_flash_attention_kernel,
                             zigzag_ring_flash_attention_kernel)
from .transformer import Config, Transformer, _rmsnorm
from .transformer import init_params as _transformer_init_params

__all__ = ["SPConfig", "init_params", "param_specs", "shard_params",
           "unshard", "forward_local", "loss_local", "make_grad_fn",
           "make_train_step", "make_optax_train_step"]


class SPConfig(Config):
    """``transformer.Config`` plus ``zigzag``: the load-balanced causal
    layout (rank i holds sequence chunks ``(i, 2p-1-i)``)."""

    def __init__(self, vocab=256, dim=128, heads=4, layers=2, ffn_mult=4,
                 max_seq=128, dtype=torch.bfloat16, zigzag=False):
        super().__init__(vocab, dim, heads, layers, ffn_mult, max_seq, dtype)
        self.zigzag = bool(zigzag)

    def _key(self):
        return super()._key() + (self.zigzag,)


def init_params(cfg: SPConfig, generator: torch.Generator | None = None,
                device=None) -> Transformer:
    """The transformer's parameters (the same pytree and init scheme);
    ``shard_params`` lays them out over the ranks."""
    return _transformer_init_params(cfg, generator, device)


def param_specs(cfg: SPConfig) -> dict[str, int | None]:
    """Parameter name -> the dim sharded over the ranks, or None for a
    replicated parameter: w1 on its columns (1), w2 on its rows (0), the
    Megatron layout ``tp_ffn`` expects."""
    specs = dict.fromkeys(("embed", "pos", "ln_f", "head"))
    for i in range(cfg.layers):
        for name in ("ln1", "qkv", "proj", "ln2"):
            specs[f"blocks.{i}.{name}"] = None
        specs[f"blocks.{i}.w1"] = 1
        specs[f"blocks.{i}.w2"] = 0
    return specs


def _held(m: Transformer) -> bool:
    """Whether this process holds the rank's parameters (in a job another
    process's rank has a placeholder set on the ``meta`` device)."""
    return m.embed.device.type != "meta"


def shard_params(model: Transformer, ranks: Sequence[int]
                 ) -> list[Transformer]:
    """One parameter set per rank, on that rank's device: the replicated
    parameters copied, w1's columns and w2's rows split in rank order.  In
    a job of several controller processes another process's rank gets a
    placeholder set of the shard's shapes on the ``meta`` device."""
    ranks = list(ranks)
    cfg, p = model.cfg, len(ranks)
    specs = param_specs(cfg)
    full = dict(model.named_parameters())
    out = []
    for i, r in enumerate(ranks):
        shard = Transformer(cfg, device_of(r), ffn_shards=p)
        if _held(shard):
            with torch.no_grad():
                for name, t in shard.named_parameters():
                    src = full[name]
                    if specs[name] is not None:
                        src = src.tensor_split(p, specs[name])[i]
                    t.copy_(src)
        out.append(shard)
    return out


def unshard(per_rank: Sequence[dict], cfg: SPConfig) -> dict:
    """Per-rank ``{name: tensor}`` dicts (parameters or gradients) as one
    dict of whole tensors on rank 0's device: the sharded ones concatenated
    in rank order, the replicated ones rank 0's (``pconcat``).  In a job of
    several controller processes (another process's ranks' tensors are
    placeholders) every process gets the whole dict on its own device, by
    one exchange."""
    specs = param_specs(cfg)
    return dict(zip(specs, pconcat([[d[name] for d in per_rank]
                                    for name in specs], specs.values())))


def _positions(r: int, p: int, s_loc: int, zigzag: bool, device):
    """Rank r's global positions: a contiguous chunk, or the zigzag chunk
    pair ``(r, 2p-1-r)``."""
    if not zigzag:
        return torch.arange(r * s_loc, (r + 1) * s_loc, device=device)
    if s_loc % 2:
        raise ValueError(f"zigzag needs an even per-rank length, got {s_loc}")
    c2 = s_loc // 2
    ar = torch.arange(c2, device=device)
    return torch.cat([r * c2 + ar, (2 * p - 1 - r) * c2 + ar])


def _local_tokens(rank_params, tokens_loc):
    return [torch.as_tensor(t, device=m.embed.device).long()
            for t, m in zip(tokens_loc, rank_params)]


def forward_local(rank_params: Sequence[Transformer], tokens_loc,
                  cfg: SPConfig) -> list[torch.Tensor]:
    """The ranks' forward: ``tokens_loc[r]`` is rank r's ``(b, s_loc)``
    chunk (contiguous, or the zigzag pair with ``cfg.zigzag``); returns
    each rank's ``(b, s_loc, vocab)`` f32 logits, in its chunk's order."""
    p = len(rank_params)
    toks = _local_tokens(rank_params, tokens_loc)
    B, S_loc = toks[0].shape
    if S_loc * p > cfg.max_seq:
        raise ValueError(f"global sequence length {S_loc * p} exceeds "
                         f"max_seq {cfg.max_seq}")
    H, E = cfg.heads, cfg.dim
    D = E // H
    xs = [m.embed[t] + m.pos[_positions(r, p, S_loc, cfg.zigzag,
                                        t.device)][None]
          for r, (m, t) in enumerate(zip(rank_params, toks))]

    def fold(t):
        # (b, s_loc, e) -> (s_loc, b*h, d): the batch folds into the heads
        return t.reshape(B, S_loc, H, D).transpose(0, 1).reshape(
            S_loc, B * H, D)

    for i in range(cfg.layers):
        blks = [m.blocks[i] for m in rank_params]
        qkv = [[fold(t) for t in (_rmsnorm(x, blk.ln1) @ blk.qkv).split(E, -1)]
               for x, blk in zip(xs, blks)]
        q, k, v = ([t[j] for t in qkv] for j in range(3))
        if cfg.zigzag:
            o = zigzag_ring_flash_attention_kernel(q, k, v)
        else:
            o = ring_flash_attention_kernel(q, k, v, causal=True)
        xs = [x + oo.reshape(S_loc, B, H, D).transpose(0, 1).reshape(
            B, S_loc, E) @ blk.proj for x, oo, blk in zip(xs, o, blks)]
        # the batch folds into the rows: the AG -> RS ring returns each
        # rank's rows to it
        f = tp_ffn([_rmsnorm(x, blk.ln2).reshape(B * S_loc, E)
                    for x, blk in zip(xs, blks)],
                   [blk.w1 for blk in blks], [blk.w2 for blk in blks])
        xs = [x + ff.reshape(B, S_loc, E) for x, ff in zip(xs, f)]
    return [(_rmsnorm(x, m.ln_f) @ m.head).float()
            for x, m in zip(xs, rank_params)]


def _loss_partial(rank_params, tokens_loc, cfg: SPConfig
                  ) -> list[torch.Tensor]:
    """Each rank's share of the next-token CE: its masked total over the
    global valid count, so the shares sum to the global mean.  Contiguous:
    rank i's tail target is rank i+1's first token, rank p-1's the global
    end (masked).  Zigzag: chunk i's successor is rank i+1's first chunk
    (rank p-1's: its own second chunk), chunk 2p-1-i's is rank i-1's second
    chunk (rank 0's: the global end, masked)."""
    p = len(rank_params)
    logits = forward_local(rank_params, tokens_loc, cfg)
    toks = _local_tokens(rank_params, tokens_loc)
    B, S_loc = toks[0].shape
    if cfg.zigzag:
        c2 = S_loc // 2
        ta, tb = [t[:, :c2] for t in toks], [t[:, c2:] for t in toks]
        nxt_a = pshift([a[:, :1] for a in ta], -1)   # rank i+1's chunk-a head
        nxt_a[p - 1] = tb[p - 1][:, :1]
        nxt_b = pshift([b[:, :1] for b in tb], 1)    # rank i-1's chunk-b head
        targets = [torch.cat([a[:, 1:], na, b[:, 1:], nb], 1)
                   for a, na, b, nb in zip(ta, nxt_a, tb, nxt_b)]
        end_rank = 0                                 # chunk 2p-1 is rank 0's
    else:
        nxt = pshift([t[:, :1] for t in toks], -1)
        targets = [torch.cat([t[:, 1:], n], 1) for t, n in zip(toks, nxt)]
        end_rank = p - 1
    count = float(B * S_loc * p - B)
    parts = []
    for r, (lg, tg) in enumerate(zip(logits, targets)):
        ll = torch.log_softmax(lg, -1).gather(-1, tg[..., None])[..., 0]
        valid = torch.ones((B, S_loc), device=lg.device)
        if r == end_rank:
            valid[:, -1] = 0.0
        parts.append((-ll * valid).sum() / count)
    return parts


def loss_local(rank_params: Sequence[Transformer], tokens_loc,
               cfg: SPConfig) -> list[torch.Tensor]:
    """The global mean next-token CE on every rank (the shares summed by
    ``preduce``).  For training, differentiate the shares' sum, as
    ``make_grad_fn`` does."""
    return preduce(_loss_partial(rank_params, tokens_loc, cfg))


def _split_tokens(tokens, ranks: Sequence[int]) -> list[torch.Tensor]:
    """A ``(b, s)`` token array as p ``(b, s/p)`` chunks on the ranks'
    devices (in a job, a placeholder for another process's rank)."""
    tokens = torch.as_tensor(tokens)
    p = len(ranks)
    if tokens.ndim != 2 or tokens.shape[1] % p:
        raise ValueError(f"tokens {tuple(tokens.shape)} do not split into "
                         f"{p} equal sequence chunks")
    return [c.to(device_of(r)) for c, r in
            zip(tokens.tensor_split(p, dim=1), ranks)]


def make_grad_fn(ranks: Sequence[int], cfg: SPConfig):
    """``grad_fn(rank_params, tokens) -> (loss, grads)``: tokens ``(b, s)``
    split into ``s/p`` chunks over ``ranks``; ``grads[r]`` is rank r's
    ``{name: gradient}``, the replicated parameters' summed over ranks
    (``preduces``: every rank the same bits, one exchange in a job), the
    FFN shards' its own.

    In a job of several controller processes every process calls it with
    the same tokens and ``shard_params``' sets (placeholders for the other
    processes' ranks).  Each process differentiates the sum of its own
    ranks' partial losses with respect to its own ranks' parameters; the
    collectives inside the graph are those of the ring Functions
    (``ring_attention._FlashRing``, ``collective_matmul``'s GEMMs), which
    form one chain through the layers, forward and backward, and the
    backward runs on the calling thread (``value_and_grad``), so every
    process enters them in the same order.  The loss is the ranks' partials
    folded in rank order (``preduce``), the bits of one process's sum;
    another process's ranks' gradients are placeholders."""
    ranks = list(ranks)
    specs = param_specs(cfg)
    if multihost.in_job():
        idle = set(range(L.process_count())) - {L.process_of(r)
                                                 for r in ranks}
        if idle:
            raise ValueError(f"processes {sorted(idle)} hold no rank of "
                             f"{ranks}: in a job every process takes part in "
                             "the step with a rank of its own")

    def grad_fn(rank_params, tokens):
        if len(rank_params) != len(ranks):
            raise ValueError(f"{len(rank_params)} parameter sets for "
                             f"{len(ranks)} ranks")
        toks = _split_tokens(tokens, ranks)
        names = [n for n, _ in rank_params[0].named_parameters()]
        own = [i for i, m in enumerate(rank_params) if _held(m)]
        leaves = [t for i in own for t in rank_params[i].parameters()]
        parts = []

        def total():
            parts.extend(_loss_partial(rank_params, toks, cfg))
            acc = parts[own[0]]
            for i in own[1:]:
                acc = acc + parts[i].to(acc.device)
            return acc

        _, flat = value_and_grad(total, leaves)
        # the ranks' partials folded in rank order, as one process adds
        loss = preduce([x.detach().reshape(1) for x in parts])[
            own[0]].reshape(())
        n = len(names)
        grads, j = [], 0
        for m in rank_params:
            if _held(m):
                grads.append(dict(zip(names, flat[j * n:(j + 1) * n])))
                j += 1
            else:
                grads.append({name: torch.empty_like(t)
                              for name, t in m.named_parameters()})
        shared = [name for name in names if specs[name] is None]
        for name, s in zip(shared, preduces([[g[name] for g in grads]
                                             for name in shared])):
            for g, x in zip(grads, s):
                g[name] = x
        return loss, grads

    return grad_fn


def _leaves_and_grads(model, grads):
    names, leaves = zip(*model.named_parameters())
    return list(leaves), [grads[n] for n in names]


def make_train_step(ranks: Sequence[int], cfg: SPConfig):
    """One SGD step over ``ranks``: ``step(rank_params, tokens, lr) ->
    (rank_params, loss)``, each parameter updated in place as
    ``(p.f32 - lr * g.f32)`` cast back to its type."""
    grad_fn = make_grad_fn(ranks, cfg)

    def step(rank_params, tokens, lr):
        loss, grads = grad_fn(rank_params, tokens)
        for m, g in zip(rank_params, grads):
            if _held(m):
                sgd_(*_leaves_and_grads(m, g), lr)
        return rank_params, loss

    return step


def make_optax_train_step(ranks: Sequence[int], cfg: SPConfig, opt):
    """Training with an optimizer (``train.optim.Optimizer``) in f32 master
    arithmetic (``_autodiff.f32_opt_update_``, shared with
    ``transformer.make_optax_train_step``); the FFN shards' moments stay
    with their shards.  Returns ``(step, init)``: ``state =
    init(rank_params)``, then ``step(rank_params, state, tokens) ->
    (rank_params, state, loss)``."""
    grad_fn = make_grad_fn(ranks, cfg)

    def init(rank_params):
        return [f32_opt_init(opt, list(m.parameters())) if _held(m) else None
                for m in rank_params]

    def step(rank_params, state, tokens):
        loss, grads = grad_fn(rank_params, tokens)
        state = [f32_opt_update_(opt, st, *_leaves_and_grads(m, g))
                 if _held(m) else st
                 for m, st, g in zip(rank_params, state, grads)]
        return rank_params, state, loss

    return step, init
