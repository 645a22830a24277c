"""Flagship model: a GPT-style transformer on the port's kernels.

PyTorch counterpart of the forward, decode and SGD training step of
``distributedarrays_tpu/models/transformer.py``:

- ``Config`` and ``Transformer`` (an ``nn.Module`` whose parameters keep
  the JAX names: ``embed``, ``pos``, ``ln_f``, ``head`` and
  ``blocks.{i}.{ln1,qkv,proj,ln2,w1,w2}``), ``init_params``;
- ``forward(params, tokens, cfg)``: (B, S) tokens -> (B, S, vocab) f32
  logits.  Attention is one flash-attention call (K5) per layer with the
  batch folded into the heads, as the JAX model folds it; the kernel reads
  q, k and v straight out of the fused QKV product through strides and
  writes o in (B, S, H, D) order, so the fold costs no copy.  The JAX
  model pads S to a block multiple first; the kernel masks a ragged S
  itself, so nothing is padded (padded keys were causally hidden and
  padded rows cut, so the logits are the same).  ``forward`` is
  differentiable: its attention's backward is the FlashAttention-2 pair
  K6 + K7.  The parameters are built with ``requires_grad=False``, so
  serving builds no autograd graph; ``loss_fn`` and ``train_step``
  differentiate with respect to them all the same.
- ``loss_fn(params, tokens, cfg)``: next-token cross-entropy;
  ``train_step(params, tokens, lr, cfg)`` -> ``(params, loss)``: one SGD
  step with f32 update arithmetic.  JAX donates the parameter buffers and
  returns new ones; the port updates the parameters in place.
  ``make_optax_train_step(cfg, opt)`` -> ``(step, init)``: any
  ``train.optim.Optimizer`` (optax is JAX) in f32 master arithmetic, as
  ``_optax_f32_step`` does: state from f32 moments, gradients and
  parameters upcast for the update, the result cast back.
- ``generate(params, prompt, n_new, cfg, temperature, generator)``: the
  prompt is teacher-forced through the same decode step that generates,
  with the stacked (L, B, max_seq, H, D) KV cache, and each step attends
  over the whole cache with a position mask (``_decode_attn``), in plain
  torch as in the JAX package.  The cache is updated in place (JAX
  returns a new one).  Greedy decoding (``temperature`` 0) matches the JAX
  package; sampling draws from a ``torch.Generator``, whose stream differs
  from ``jax.random``'s.

The activation is GELU with the tanh approximation (``jax.nn.gelu``'s
default), RMSNorm computes in f32 and casts back, the embedding sum is
taken in the parameter type and the logits are cast to f32 last, all as
in the JAX model.

The GSPMD tp/dp layout (``make_mesh``, ``shard_params``, ``unshard``;
``models.tp_dp``): ``shard_params`` lays the parameters out Megatron-style
over a ``('dp', 'tp')`` mesh of global ranks, qkv (by heads), w1 and head
column-parallel, proj and w2 row-parallel, embeddings and norms
replicated, each a ``Transformer`` shard on its rank's device.
``forward``, ``loss_fn``, ``train_step``, ``make_optax_train_step`` and
``generate`` take that layout as JAX's take the sharded pytree: each tp
rank attends over its own heads (K5; K6/K7 backward), the row-parallel
partial sums are all-reduced over tp and the gradients over dp (K12 +
K10 on the card, their plain versions on the CPU), the vocab-split
logits are gathered (K10), and in a job of several controller processes
every process calls them alike (another process's ranks hold
placeholders).  ``unshard`` gives back the whole parameters bit for bit;
the weights carried from JAX enter through
``interop.params_from_reference`` then ``shard_params``.  The
sequence-parallel layout of the same parameters is
``sp_transformer.shard_params``.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from .. import layout as L
from ..ops.cuda_attention import flash_attention_lse
from ..ops.cuda_collectives import ring_all_gather
from ..parallel import multihost
from ..parallel.collectives import pconcat
from ._autodiff import f32_opt_init, f32_opt_update_, sgd_, value_and_grad
from .tp_dp import (Mesh, ShardedParams, _over, allreduce, check_divides,
                    copy_tp, dp_total, gather_tp, make_mesh, per_rank,
                    reduce_tp, split_rows, value_and_grads)

__all__ = ["Config", "Transformer", "init_params", "forward", "loss_fn",
           "train_step", "make_optax_train_step", "generate",
           "shard_params", "unshard", "make_mesh"]


class Config:
    def __init__(self, vocab=256, dim=128, heads=4, layers=2, ffn_mult=4,
                 max_seq=128, dtype=torch.bfloat16):
        if dim % heads:
            raise ValueError(f"dim {dim} must be divisible by heads {heads}")
        self.vocab, self.dim, self.heads = vocab, dim, heads
        self.layers, self.ffn_mult, self.max_seq = layers, ffn_mult, max_seq
        self.dtype = dtype

    def _key(self):
        return (self.vocab, self.dim, self.heads, self.layers,
                self.ffn_mult, self.max_seq, str(self.dtype))

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return isinstance(other, Config) and self._key() == other._key()


class Block(nn.Module):
    def __init__(self, E: int, F_: int, dtype, device, tp: int = 1):
        super().__init__()
        mk = lambda *s: nn.Parameter(torch.empty(s, dtype=dtype,
                                                 device=device),
                                     requires_grad=False)
        self.ln1, self.qkv = mk(E), mk(E, 3 * E // tp)
        self.proj = mk(E // tp, E)
        self.ln2, self.w1, self.w2 = mk(E), mk(E, F_), mk(F_, E)


class Transformer(nn.Module):
    """The flagship transformer's parameters; ``forward``/``generate`` (or
    ``model(tokens)``) run it.  ``ffn_shards`` > 1 holds one rank's shard
    of the FFN (w1's columns and w2's rows split that many ways), as
    ``sp_transformer.shard_params`` lays it out; ``tp`` > 1 one tp rank's
    Megatron shard (``shard_params``): its heads' q, k and v columns and
    proj rows, its FFN shard and its vocab columns of ``head``."""

    def __init__(self, cfg: Config, device=None, ffn_shards: int = 1,
                 tp: int = 1):
        super().__init__()
        self.cfg = cfg
        E, dt = cfg.dim, cfg.dtype
        ffn_shards *= tp
        if (E * cfg.ffn_mult) % ffn_shards:
            raise ValueError(f"FFN width {E * cfg.ffn_mult} does not split "
                             f"into {ffn_shards} shards")
        mk = lambda *s: nn.Parameter(torch.empty(s, dtype=dt, device=device),
                                     requires_grad=False)
        self.embed, self.pos = mk(cfg.vocab, E), mk(cfg.max_seq, E)
        self.ln_f, self.head = mk(E), mk(E, cfg.vocab // tp)
        self.blocks = nn.ModuleList(
            Block(E, E * cfg.ffn_mult // ffn_shards, dt, device, tp)
            for _ in range(cfg.layers))

    def forward(self, tokens):
        return forward(self, tokens, self.cfg)


def init_params(cfg: Config, generator: torch.Generator | None = None,
                device=None) -> Transformer:
    """Random parameters as the JAX ``init_params`` draws them: each matrix
    ``normal * sqrt(1 / fan_in)`` in the parameter type, norms at 1.  The
    stream is ``generator``'s (on ``device``: default this process's first
    rank's device, rank 0's in one process), not JAX's."""
    if device is None:
        from ..layout import local_device
        device = local_device()
    model = Transformer(cfg, device)
    dt = cfg.dtype

    def dense(p: torch.Tensor, fan_in: int):
        x = torch.randn(p.shape, generator=generator, device=p.device)
        p.copy_(x.to(dt) * torch.tensor(math.sqrt(1.0 / fan_in), dtype=dt,
                                        device=p.device))

    E = cfg.dim
    with torch.no_grad():
        dense(model.embed, E)
        dense(model.pos, E)
        model.ln_f.fill_(1)
        dense(model.head, E)
        for b in model.blocks:
            b.ln1.fill_(1)
            dense(b.qkv, E)
            dense(b.proj, E)
            b.ln2.fill_(1)
            dense(b.w1, E)
            dense(b.w2, E * cfg.ffn_mult)
    return model


def _rmsnorm(x, scale):
    x32 = x.float()
    n = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + 1e-6)
    return (n * scale.float()).to(x.dtype)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _attention(x, blk, heads: int, attend):
    """Attention over ``heads`` heads of width ``W / heads``, W the width of
    q in ``blk.qkv`` (E, or a tp rank's E / tp): the output projection of
    a tp shard is its partial sum."""
    B, S, _ = x.shape
    W = blk.qkv.shape[1] // 3
    D = W // heads
    qkv = x @ blk.qkv                                     # (B, S, 3W)
    # (S, B, H, D) views of q, k and v: batch folded into the heads
    q, k, v = (t.view(B, S, heads, D).transpose(0, 1)
               for t in qkv.split(W, dim=-1))
    if attend is None:
        o = flash_attention_lse(q, k, v, causal=True)[0]  # (B, S, H, D) storage
    else:
        o = attend(q, k, v, causal=True).reshape(S, B, heads, D)
    return o.transpose(0, 1).reshape(B, S, W) @ blk.proj


def forward(params, tokens, cfg: Config, _attend=None) -> torch.Tensor:
    """tokens (B, S) int -> logits (B, S, vocab) f32, differentiable in the
    parameters.  ``params`` is a ``Transformer`` or ``shard_params``' tp/dp
    layout (tokens whole, or a rank list of dp row blocks; the logits come
    back whole on this process's first rank's device).  ``_attend`` is for
    checks only: an attention over (S, B, H, D) views, such as
    ``flash_attention_plain``, that replaces the kernel."""
    if isinstance(params, ShardedParams):
        mesh = params.mesh
        logits = _tp_logits(params, tokens, cfg, _attend)
        return pconcat([[logits[i] for i in mesh.dp_groups()[0]]], [0])[0]
    tokens = torch.as_tensor(tokens, device=params.embed.device)
    B, S = tokens.shape
    if S > cfg.max_seq:
        raise ValueError(f"sequence length {S} exceeds max_seq "
                         f"{cfg.max_seq}")
    x = params.embed[tokens.long()] + params.pos[:S][None]
    for blk in params.blocks:
        x = x + _attention(_rmsnorm(x, blk.ln1), blk, cfg.heads, _attend)
        h = _rmsnorm(x, blk.ln2)
        x = x + _gelu(h @ blk.w1) @ blk.w2
    return (_rmsnorm(x, params.ln_f) @ params.head).float()


def loss_fn(params, tokens, cfg: Config, _attend=None) -> torch.Tensor:
    """Next-token cross-entropy of (B, S + 1) tokens (``params`` and
    ``_attend`` as in ``forward``)."""
    if isinstance(params, ShardedParams):
        with torch.no_grad():
            return dp_total(params.mesh,
                            _tp_shares(params, tokens, cfg, _attend))
    tokens = torch.as_tensor(tokens, device=params.embed.device).long()
    logits = forward(params, tokens[:, :-1], cfg, _attend)
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, tokens[:, 1:, None]).mean()


def train_step(params, tokens, lr: float, cfg: Config, _attend=None):
    """One SGD step: the gradient of ``loss_fn`` and an f32 update
    ``(p.f32 - lr * g.f32)`` cast back to the parameter type, written into
    the parameters in place (the JAX step donates its buffers).  Returns
    ``(params, loss)``.  On the tp/dp layout each rank updates its own
    shard with its gradient summed over dp."""
    if isinstance(params, ShardedParams):
        loss, grads = value_and_grads(params, lambda: _tp_shares(
            params, tokens, cfg, _attend))
        for i in params.mesh.held():
            sgd_(params.leaves(i), grads[i], lr)
        return params, loss
    leaves = list(params.parameters())
    loss, grads = value_and_grad(lambda: loss_fn(params, tokens, cfg,
                                                 _attend), leaves)
    sgd_(leaves, grads, lr)
    return params, loss


def make_optax_train_step(cfg: Config, opt):
    """Training with an optimizer (``train.optim.Optimizer``) in f32 master
    arithmetic.  Returns ``(step, init)``: ``state = init(params)``, then
    ``step(params, state, tokens) -> (params, state, loss)``, the
    parameters updated in place.  On the tp/dp layout the state is one per
    rank, each moment shaped like the rank's shard (None for another
    process's rank), as XLA lays JAX's out like the parameters."""
    def init(params) -> dict | list:
        if isinstance(params, ShardedParams):
            return [f32_opt_init(opt, params.leaves(i))
                    if i in params.mesh.held() else None
                    for i in range(len(params))]
        return f32_opt_init(opt, list(params.parameters()))

    def step(params, state, tokens):
        if isinstance(params, ShardedParams):
            loss, grads = value_and_grads(params, lambda: _tp_shares(
                params, tokens, cfg))
            state = [f32_opt_update_(opt, st, params.leaves(i), grads[i])
                     if st is not None else st
                     for i, st in enumerate(state)]
            return params, state, loss
        leaves = list(params.parameters())
        loss, grads = value_and_grad(lambda: loss_fn(params, tokens, cfg),
                                     leaves)
        return params, f32_opt_update_(opt, state, leaves, grads), loss

    return step, init


def _decode_attn(h, blk, heads: int, kc, vc, i: int, t: int, max_seq: int):
    """One decode position through layer ``i``'s attention: writes this
    position's k/v into the stacked (L, B, max_seq, H, D) caches in place
    at ``t`` and attends over the whole cache with a position mask."""
    B = h.shape[0]
    W = blk.qkv.shape[1] // 3           # E, or a tp rank's E / tp
    D = W // heads
    q, k, v = (h @ blk.qkv).split(W, dim=-1)
    q = q.reshape(B, heads, D).float()
    kc[i, :, t] = k.reshape(B, heads, D).to(kc.dtype)
    vc[i, :, t] = v.reshape(B, heads, D).to(vc.dtype)
    s = torch.einsum("bhd,bkhd->bhk", q / math.sqrt(D), kc[i].float())
    mask = torch.arange(max_seq, device=h.device) <= t
    s = torch.where(mask[None, None], s, -math.inf)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhk,bkhd->bhd", p, vc[i].float())
    return o.reshape(B, 1, W).to(h.dtype) @ blk.proj


def generate(params, prompt, n_new: int, cfg: Config,
             temperature: float = 0.0,
             generator: torch.Generator | None = None,
             return_logits: bool = False):
    """``n_new`` tokens appended to ``prompt`` (B, S0) int, returned as
    (B, S0 + n_new).  ``temperature`` 0 is greedy argmax; above 0 each
    token is drawn from ``softmax(logits / temperature)`` with
    ``generator`` (required, on the parameters' device).  With
    ``return_logits`` also the (B, n_new, vocab) f32 logits each new token
    was taken from.

    On ``shard_params``' tp/dp layout each rank keeps the KV cache of its
    own heads for its dp row's prompts; the row-parallel partial sums are
    all-reduced over tp (K12 + K10) and the vocab-split logits gathered
    (K10) on every rank of the row; the tokens and logits come back whole.
    Sampling there draws once a row and step, from the row's first rank's
    logits; in a job of several processes only greedy decoding is
    supported."""
    if temperature > 0.0 and generator is None:
        raise ValueError("sampling (temperature > 0) needs a torch.Generator")
    sharded = isinstance(params, ShardedParams)
    if sharded:
        mesh, models = params.mesh, params.per_rank
        if temperature > 0.0 and multihost.in_job():
            raise NotImplementedError("sampling on the tp/dp layout in a job "
                                      "of several processes")
        prompts = split_rows(mesh, prompt, "prompt")
        own = mesh.held()
        each = functools.partial(per_rank, mesh)
    else:
        mesh, models = None, [params]
        prompts = [torch.as_tensor(prompt, device=params.embed.device)]
        own = [0]
        each = (lambda fn, *ls: [fn(*(x[0] for x in ls))])
    B, S0 = prompts[own[0]].shape
    if S0 + n_new > cfg.max_seq:
        raise ValueError(f"prompt {S0} + n_new {n_new} exceeds max_seq "
                         f"{cfg.max_seq}")
    tp = mesh.tp if sharded else 1
    H, D = cfg.heads // tp, cfg.dim // cfg.heads
    toks = {i: [prompts[i][:, 0]] for i in own}
    steps = []
    with torch.no_grad():
        kcs = each(lambda m: torch.zeros((cfg.layers, B, cfg.max_seq, H, D),
                                         dtype=cfg.dtype,
                                         device=m.embed.device), models)
        vcs = each(torch.zeros_like, kcs)
        for t in range(S0 + n_new - 1):
            xs = each(lambda m, i: (m.embed[toks[i][-1].long()][:, None]
                                    + m.pos[t][None, None]).to(cfg.dtype),
                      models, range(len(models)))
            for i in range(cfg.layers):
                a = _tp_sum(mesh, each(lambda m, x, kc, vc: _decode_attn(
                    _rmsnorm(x, m.blocks[i].ln1), m.blocks[i], H, kc, vc, i,
                    t, cfg.max_seq), models, xs, kcs, vcs))
                xs = each(torch.add, xs, a)
                f = _tp_sum(mesh, each(lambda m, x: _gelu(
                    _rmsnorm(x, m.blocks[i].ln2) @ m.blocks[i].w1)
                    @ m.blocks[i].w2, models, xs))
                xs = each(torch.add, xs, f)
            if t + 1 < S0:                   # teacher-forced prompt
                for i in own:
                    toks[i].append(prompts[i][:, t + 1])
                continue
            logits = each(lambda m, x: (_rmsnorm(x[:, 0], m.ln_f)
                                        @ m.head).float(), models, xs)
            if tp > 1:
                logits = _over(mesh.tp_groups(), logits,
                               lambda b: ring_all_gather(b, -1))
            nxt = _next_tokens(own, mesh, logits, temperature, generator)
            for i in own:
                toks[i].append(nxt[i].to(prompts[i].dtype))
            if return_logits:
                steps.append(logits)
    out = each(lambda i: torch.stack(toks[i], dim=1), range(len(models)))
    lists = [out] + [each(lambda x: x[:, None], lg) for lg in steps]
    if sharded:
        rows = mesh.dp_groups()[0]
        whole = pconcat([[x[i] for i in rows] for x in lists],
                        [0] * len(lists))
    else:
        whole = [x[0] for x in lists]
    if not return_logits:
        return whole[0]
    logits = torch.cat(whole[1:], 1) if steps else torch.empty(
        (whole[0].shape[0], 0, cfg.vocab), device=whole[0].device)
    return whole[0], logits


def _tp_sum(mesh, xs: list) -> list:
    """A decode step's row-parallel partial sums all-reduced over each tp
    group (no autograd: ``generate`` runs under ``no_grad``)."""
    if mesh is None or mesh.tp == 1:
        return xs
    return _over(mesh.tp_groups(), xs, allreduce)


def _next_tokens(own: list, mesh, logits: list, temperature: float,
                 generator) -> dict:
    """The next tokens of each of ``own`` (indices into ``logits``): the
    argmax of its row's logits (the same on every rank of the row), or one
    draw a row from the row's first held rank's logits, handed to the
    row's other ranks."""
    if temperature <= 0.0:
        return {i: logits[i].argmax(-1) for i in own}
    out = {}
    for idx in (mesh.tp_groups() if mesh is not None else [[0]]):
        mine = [i for i in idx if i in own]
        if not mine:
            continue
        draw = torch.multinomial(torch.softmax(
            logits[mine[0]] / temperature, dim=-1), 1,
            generator=generator)[:, 0]
        for i in mine:
            out[i] = draw.to(logits[i].device)
    return out


# ---------------------------------------------------------------------------
# the GSPMD tp/dp layout: JAX's shard_params and the sharded pytree
# ---------------------------------------------------------------------------

_ROWS = ("proj", "w2")               # row-parallel: input features split
_COLS = ("qkv", "w1", "head")        # column-parallel: output features split


def _kind(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def _tp_dim(name: str) -> int | None:
    """The dim of a parameter that tp splits (None: replicated)."""
    k = _kind(name)
    return 0 if k in _ROWS else 1 if k in _COLS else None


def _shard_of(name: str, x: torch.Tensor, t: int, tp: int, E: int):
    """Tp rank t's shard of the whole parameter ``x``; q, k and v each
    split by heads (JAX's contiguous split of qkv's 3E columns would hand
    a rank all of q and half of k; GSPMD makes that right, the port's
    per-rank attention needs whole heads)."""
    if _kind(name) == "qkv":
        return x.reshape(E, 3, tp, E // tp)[:, :, t].reshape(E, 3 * E // tp)
    d = _tp_dim(name)
    return x if d is None else x.tensor_split(tp, d)[t]


def shard_params(params: Transformer, mesh: Mesh) -> ShardedParams:
    """Megatron layout (JAX ``models/transformer.py:89``): qkv, w1 and head
    column-parallel over tp (qkv by heads), proj and w2 row-parallel,
    embeddings and norms replicated; every parameter replicated over dp.
    One ``Transformer`` shard a rank on its device (another process's
    rank: a placeholder set on ``meta``).  Raises ``ValueError`` naming
    the extent that tp does not divide."""
    cfg, tp = params.cfg, mesh.tp
    check_divides({"heads": cfg.heads,
                   "FFN width (dim * ffn_mult)": cfg.dim * cfg.ffn_mult,
                   "vocab": cfg.vocab}, tp, "tp")
    full = dict(params.named_parameters())
    out = []
    for i, r in enumerate(mesh.flat):
        shard = Transformer(cfg, L.device_of(r), tp=tp)
        if shard.embed.device.type != "meta":
            with torch.no_grad():
                for name, p in shard.named_parameters():
                    p.copy_(_shard_of(name, full[name], i % tp, tp, cfg.dim))
        out.append(shard)
    return ShardedParams(mesh, out, lambda m: list(m.parameters()),
                         lambda sp: _pytree(unshard(sp)), cfg)


def _pytree(model: Transformer) -> dict:
    """The JAX parameter pytree of ``model``'s tensors (not copies)."""
    tree = {n: getattr(model, n) for n in ("embed", "pos", "ln_f", "head")}
    tree["blocks"] = [{n: getattr(b, n) for n in ("ln1", "qkv", "proj",
                                                  "ln2", "w1", "w2")}
                      for b in model.blocks]
    return tree


def unshard(sharded: ShardedParams) -> Transformer:
    """The whole JAX-shaped parameters, bit for bit, on this process's first
    rank's device: dp row 0's shards concatenated (qkv's q, k and v
    columns put back in order), the replicated ones rank (0, 0)'s.  In a
    job every process gets them, by one exchange."""
    mesh, cfg = sharded.mesh, sharded.cfg
    row = [dict(m.named_parameters()) for m in sharded.per_rank[:mesh.tp]]
    names = list(row[0])
    whole = pconcat([[r[n] for r in row] for n in names],
                    [_tp_dim(n) for n in names])
    model = Transformer(cfg, L.local_device())
    E, tp = cfg.dim, mesh.tp
    with torch.no_grad():
        for (name, p), x in zip(model.named_parameters(), whole):
            if _kind(name) == "qkv":
                x = x.reshape(E, tp, 3, E // tp).transpose(1, 2).reshape(
                    E, 3 * E)
            p.copy_(x)
    return model


def _tp_logits(sp: ShardedParams, tokens, cfg: Config, attend) -> list:
    """Each rank's whole (b, S, vocab) f32 logits of its dp row's tokens:
    attention on the rank's own heads (K5; K6/K7 backward), each
    row-parallel product's partial sum all-reduced over tp, the vocab
    shards gathered (K10)."""
    mesh, ms = sp.mesh, sp.per_rank
    toks = [t.long() for t in split_rows(mesh, tokens, "token")]
    S = toks[mesh.held()[0]].shape[1]
    if S > cfg.max_seq:
        raise ValueError(f"sequence length {S} exceeds max_seq "
                         f"{cfg.max_seq}")
    H = cfg.heads // mesh.tp
    xs = per_rank(mesh, lambda m, t: m.embed[t] + m.pos[:S][None], ms, toks)
    for i in range(cfg.layers):
        h = copy_tp(mesh, per_rank(mesh, lambda m, x: _rmsnorm(
            x, m.blocks[i].ln1), ms, xs))
        a = reduce_tp(mesh, per_rank(mesh, lambda m, x: _attention(
            x, m.blocks[i], H, attend), ms, h))
        xs = per_rank(mesh, torch.add, xs, a)
        h = copy_tp(mesh, per_rank(mesh, lambda m, x: _rmsnorm(
            x, m.blocks[i].ln2), ms, xs))
        f = reduce_tp(mesh, per_rank(mesh, lambda m, x: _gelu(
            x @ m.blocks[i].w1) @ m.blocks[i].w2, ms, h))
        xs = per_rank(mesh, torch.add, xs, f)
    h = copy_tp(mesh, per_rank(mesh, lambda m, x: _rmsnorm(x, m.ln_f),
                               ms, xs))
    return gather_tp(mesh, per_rank(mesh, lambda m, x: (x @ m.head).float(),
                                    ms, h), -1)


def _tp_shares(sp: ShardedParams, tokens, cfg: Config, attend=None) -> list:
    """Each rank's part of the next-token CE of (B, S + 1) tokens: its dp
    row's total over the global count (the same on a row's tp ranks)."""
    mesh = sp.mesh
    toks = split_rows(mesh, tokens, "token")
    logits = _tp_logits(sp, [t[:, :-1] for t in toks], cfg, attend)
    b, s1 = toks[mesh.held()[0]].shape
    count = float(b * mesh.dp * (s1 - 1))

    def share(lg, t):
        logp = torch.log_softmax(lg, dim=-1)
        return -logp.gather(-1, t[:, 1:, None].long()).sum() / count
    return per_rank(mesh, share, logits, toks)
