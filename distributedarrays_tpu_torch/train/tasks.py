"""Training tasks: the model-side contract the trainer drives.

PyTorch counterpart of ``distributedarrays_tpu/train/tasks.py``.  A
:class:`TrainTask` bundles

- ``init_params(generator) -> pytree`` of f32 tensors, in the JAX task's
  nested dict/list shape (the trainer flattens it in ``jax.tree_util``'s
  leaf order);
- ``loss_sum(params, batch, w) -> scalar``: the weighted sum of
  per-example losses over one rank's batch shard (``w`` is 1 for real
  examples and 0 for the rows that pad the global batch to a multiple of
  the rank count);
- ``batch(step) -> tuple of numpy arrays``: the deterministic data
  pipeline, from the same integer-mixed numpy generator as the JAX tasks,
  so the two packages see identical batches;
- ``step_flops(batch_size)``: analytic forward+backward flops.

:func:`mlp_task` trains :mod:`..models.mlp` on a fixed random teacher;
:func:`transformer_task` trains :mod:`..models.transformer` on
next-token prediction, mapping the parameter tensors onto a
``Transformer`` with ``torch.func.functional_call``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

__all__ = ["TrainTask", "mlp_task", "transformer_task"]


@dataclasses.dataclass(frozen=True)
class TrainTask:
    """The trainer's model-side contract (see module docstring)."""

    name: str
    batch_size: int
    init_params: Callable         # (torch.Generator) -> pytree of tensors
    loss_sum: Callable            # (params, batch_tuple, w) -> scalar sum
    batch: Callable               # (step) -> tuple of host np arrays
    step_flops: Callable = lambda batch_size: 0.0


def _mix_rng(seed: int, step: int) -> np.random.Generator:
    """Per-(task-seed, step) host RNG, integer-mixed as in the JAX tasks."""
    return np.random.default_rng((seed * 1_000_003 + step * 8_191)
                                 & 0x7FFFFFFF)


def mlp_task(sizes: Sequence[int] = (16, 32, 32, 4),
             batch_size: int = 56, seed: int = 0) -> TrainTask:
    """Regression on a fixed random teacher with :mod:`..models.mlp`."""
    from ..models import mlp
    sizes = tuple(int(s) for s in sizes)
    teacher = np.random.default_rng(seed + 7).standard_normal(
        (sizes[0], sizes[-1])).astype(np.float32) / np.sqrt(sizes[0])

    def init_params(generator):
        return mlp.init_params(generator, sizes, dtype=torch.float32)

    def loss_sum(params, batch, w):
        x, y = batch
        pred = mlp.forward(params, x)
        per_ex = torch.mean(torch.square(pred - y), dim=-1)  # (B_local,)
        return torch.sum(per_ex * w)

    def batch(step):
        rng = _mix_rng(seed, step)
        x = rng.standard_normal((batch_size, sizes[0])).astype(np.float32)
        y = np.tanh(x @ teacher).astype(np.float32)
        return x, y

    def step_flops(bsz):
        fwd = sum(2.0 * bsz * a * b for a, b in zip(sizes, sizes[1:]))
        return 3.0 * fwd

    return TrainTask(name=f"mlp{ 'x'.join(map(str, sizes)) }",
                     batch_size=batch_size, init_params=init_params,
                     loss_sum=loss_sum, batch=batch, step_flops=step_flops)


def transformer_task(vocab: int = 64, dim: int = 32, heads: int = 2,
                     layers: int = 1, seq: int = 16,
                     batch_size: int = 56, seed: int = 0) -> TrainTask:
    """Next-token prediction with :mod:`..models.transformer` in f32 (the
    trainer's flat vector is f32), with a per-example token-mean
    cross-entropy so padding rows carry zero weight."""
    from ..interop import _BLOCK_KEYS
    from ..models import transformer as tr
    cfg = tr.Config(vocab=vocab, dim=dim, heads=heads, layers=layers,
                    max_seq=seq, dtype=torch.float32)
    skeleton = tr.Transformer(cfg, device="meta")   # names only

    def init_params(generator):
        m = tr.init_params(cfg, generator, generator.device)
        tree = {n: getattr(m, n).detach() for n in ("embed", "pos", "ln_f",
                                                    "head")}
        tree["blocks"] = [{n: getattr(b, n).detach() for n in _BLOCK_KEYS}
                          for b in m.blocks]
        return tree

    def named(params):
        out = {n: params[n] for n in ("embed", "pos", "ln_f", "head")}
        for i, b in enumerate(params["blocks"]):
            out.update({f"blocks.{i}.{n}": t for n, t in b.items()})
        return out

    def loss_sum(params, batch, w):
        (tokens,) = batch
        tokens = tokens.long()
        logits = torch.func.functional_call(skeleton, named(params),
                                            (tokens[:, :-1],))
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, tokens[:, 1:, None])[..., 0]
        per_ex = nll.mean(-1)                               # (B_local,)
        return torch.sum(per_ex * w)

    def batch(step):
        # modular counting sequences from a random offset, as the JAX task
        rng = _mix_rng(seed, step)
        offs = rng.integers(0, vocab, size=(batch_size, 1), dtype=np.int64)
        toks = (offs + np.arange(seq + 1)) % vocab
        return (toks.astype(np.int32),)

    def step_flops(bsz):
        per_tok = layers * (8.0 * dim * dim + 16.0 * dim * dim) \
            + 2.0 * dim * vocab
        return 3.0 * bsz * seq * per_tok

    return TrainTask(name=f"transformer_d{dim}", batch_size=batch_size,
                     init_params=init_params, loss_sum=loss_sum,
                     batch=batch, step_flops=step_flops)
