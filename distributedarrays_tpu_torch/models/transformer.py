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
in the JAX model.  The GSPMD tp layout (``shard_params``) waits for the
port's tp/dp layouts, with the MLP's ``make_mesh``/``shard_params``/
``shard_batch``; the sequence-parallel layout of the same parameters is
``sp_transformer.shard_params``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cuda_attention import flash_attention_lse
from ._autodiff import f32_opt_init, f32_opt_update_, sgd_, value_and_grad

__all__ = ["Config", "Transformer", "init_params", "forward", "loss_fn",
           "train_step", "make_optax_train_step", "generate"]


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
    def __init__(self, E: int, F_: int, dtype, device):
        super().__init__()
        mk = lambda *s: nn.Parameter(torch.empty(s, dtype=dtype,
                                                 device=device),
                                     requires_grad=False)
        self.ln1, self.qkv, self.proj = mk(E), mk(E, 3 * E), mk(E, E)
        self.ln2, self.w1, self.w2 = mk(E), mk(E, F_), mk(F_, E)


class Transformer(nn.Module):
    """The flagship transformer's parameters; ``forward``/``generate`` (or
    ``model(tokens)``) run it.  ``ffn_shards`` > 1 holds one rank's shard
    of the FFN (w1's columns and w2's rows split that many ways), as
    ``sp_transformer.shard_params`` lays it out."""

    def __init__(self, cfg: Config, device=None, ffn_shards: int = 1):
        super().__init__()
        self.cfg = cfg
        E, dt = cfg.dim, cfg.dtype
        if (E * cfg.ffn_mult) % ffn_shards:
            raise ValueError(f"FFN width {E * cfg.ffn_mult} does not split "
                             f"into {ffn_shards} shards")
        mk = lambda *s: nn.Parameter(torch.empty(s, dtype=dt, device=device),
                                     requires_grad=False)
        self.embed, self.pos = mk(cfg.vocab, E), mk(cfg.max_seq, E)
        self.ln_f, self.head = mk(E), mk(E, cfg.vocab)
        self.blocks = nn.ModuleList(
            Block(E, E * cfg.ffn_mult // ffn_shards, dt, device)
            for _ in range(cfg.layers))

    def forward(self, tokens):
        return forward(self, tokens, self.cfg)


def init_params(cfg: Config, generator: torch.Generator | None = None,
                device=None) -> Transformer:
    """Random parameters as the JAX ``init_params`` draws them: each matrix
    ``normal * sqrt(1 / fan_in)`` in the parameter type, norms at 1.  The
    stream is ``generator``'s (on ``device``), not JAX's."""
    if device is None:
        from ..layout import device_of
        device = device_of(0)
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
    B, S, E = x.shape
    D = E // heads
    qkv = x @ blk.qkv                                     # (B, S, 3E)
    # (S, B, H, D) views of q, k and v: batch folded into the heads
    q, k, v = (t.view(B, S, heads, D).transpose(0, 1)
               for t in qkv.split(E, dim=-1))
    if attend is None:
        o = flash_attention_lse(q, k, v, causal=True)[0]  # (B, S, H, D) storage
    else:
        o = attend(q, k, v, causal=True).reshape(S, B, heads, D)
    return o.transpose(0, 1).reshape(B, S, E) @ blk.proj


def forward(params: Transformer, tokens, cfg: Config,
            _attend=None) -> torch.Tensor:
    """tokens (B, S) int -> logits (B, S, vocab) f32, differentiable in the
    parameters.  ``_attend`` is for checks only: an attention over
    (S, B, H, D) views, such as ``flash_attention_plain``, that replaces
    the kernel."""
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


def loss_fn(params: Transformer, tokens, cfg: Config,
            _attend=None) -> torch.Tensor:
    """Next-token cross-entropy of (B, S + 1) tokens (``_attend`` as in
    ``forward``)."""
    tokens = torch.as_tensor(tokens, device=params.embed.device).long()
    logits = forward(params, tokens[:, :-1], cfg, _attend)
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, tokens[:, 1:, None]).mean()


def train_step(params: Transformer, tokens, lr: float, cfg: Config):
    """One SGD step: the gradient of ``loss_fn`` and an f32 update
    ``(p.f32 - lr * g.f32)`` cast back to the parameter type, written into
    the parameters in place (the JAX step donates its buffers).  Returns
    ``(params, loss)``."""
    leaves = list(params.parameters())
    loss, grads = value_and_grad(lambda: loss_fn(params, tokens, cfg),
                                 leaves)
    sgd_(leaves, grads, lr)
    return params, loss


def make_optax_train_step(cfg: Config, opt):
    """Training with an optimizer (``train.optim.Optimizer``) in f32 master
    arithmetic.  Returns ``(step, init)``: ``state = init(params)``, then
    ``step(params, state, tokens) -> (params, state, loss)``, the
    parameters updated in place."""
    def init(params: Transformer) -> dict:
        return f32_opt_init(opt, list(params.parameters()))

    def step(params: Transformer, state: dict, tokens):
        leaves = list(params.parameters())
        loss, grads = value_and_grad(lambda: loss_fn(params, tokens, cfg),
                                     leaves)
        return params, f32_opt_update_(opt, state, leaves, grads), loss

    return step, init


def _decode_attn(h, blk, heads: int, kc, vc, i: int, t: int, max_seq: int):
    """One decode position through layer ``i``'s attention: writes this
    position's k/v into the stacked (L, B, max_seq, H, D) caches in place
    at ``t`` and attends over the whole cache with a position mask."""
    B, _, E = h.shape
    D = E // heads
    q, k, v = (h @ blk.qkv).split(E, dim=-1)
    q = q.reshape(B, heads, D).float()
    kc[i, :, t] = k.reshape(B, heads, D).to(kc.dtype)
    vc[i, :, t] = v.reshape(B, heads, D).to(vc.dtype)
    s = torch.einsum("bhd,bkhd->bhk", q / math.sqrt(D), kc[i].float())
    mask = torch.arange(max_seq, device=h.device) <= t
    s = torch.where(mask[None, None], s, -math.inf)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhk,bkhd->bhd", p, vc[i].float())
    return o.reshape(B, 1, E).to(h.dtype) @ blk.proj


def generate(params: Transformer, prompt, n_new: int, cfg: Config,
             temperature: float = 0.0,
             generator: torch.Generator | None = None) -> torch.Tensor:
    """``n_new`` tokens appended to ``prompt`` (B, S0) int, returned as
    (B, S0 + n_new).  ``temperature`` 0 is greedy argmax; above 0 each
    token is drawn from ``softmax(logits / temperature)`` with
    ``generator`` (required, on the parameters' device)."""
    dev = params.embed.device
    prompt = torch.as_tensor(prompt, device=dev)
    B, S0 = prompt.shape
    total = S0 + n_new
    if total > cfg.max_seq:
        raise ValueError(f"prompt {S0} + n_new {n_new} exceeds max_seq "
                         f"{cfg.max_seq}")
    if temperature > 0.0 and generator is None:
        raise ValueError("sampling (temperature > 0) needs a torch.Generator")
    H, D = cfg.heads, cfg.dim // cfg.heads
    toks = [prompt[:, 0]]
    with torch.no_grad():
        kc = torch.zeros((cfg.layers, B, cfg.max_seq, H, D), dtype=cfg.dtype,
                         device=dev)
        vc = torch.zeros_like(kc)
        for t in range(total - 1):
            x = (params.embed[toks[-1].long()][:, None]
                 + params.pos[t][None, None]).to(cfg.dtype)
            for i, blk in enumerate(params.blocks):
                x = x + _decode_attn(_rmsnorm(x, blk.ln1), blk, H, kc, vc, i,
                                     t, cfg.max_seq)
                h2 = _rmsnorm(x, blk.ln2)
                x = x + _gelu(h2 @ blk.w1) @ blk.w2
            if t + 1 < S0:                   # teacher-forced prompt
                toks.append(prompt[:, t + 1])
                continue
            logits = (_rmsnorm(x[:, 0], params.ln_f) @ params.head).float()
            if temperature > 0.0:
                nxt = torch.multinomial(
                    torch.softmax(logits / temperature, dim=-1), 1,
                    generator=generator)[:, 0]
            else:
                nxt = logits.argmax(-1)
            toks.append(nxt.to(prompt.dtype))
    return torch.stack(toks, dim=1)
