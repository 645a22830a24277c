"""Data-parallel trainer over DArrays, with its gradient sync on the
collective kernels.

PyTorch counterpart of the training arc of ``distributedarrays_tpu/train/
trainer.py`` (``Trainer``, ``StragglerDetector``, ``fit_result``):

- The parameters are one flat f32 vector in ``jax.tree_util``'s leaf order
  (dict keys sorted, lists in order), so it equals the JAX trainer's
  element for element.  It is padded to ``ppad``, a multiple of the rank
  count p, and split evenly into ``ppad / p`` shards, one per rank: the
  ZeRO-1 layout, every optimizer moment split the same way.  The state
  lives in DArrays (``pflat``, ``m0``, ``m1``) whose cuts are those shards
  cut back to the vector's length; the JAX trainer's DArray keeps the
  default cuts and pads its global array instead, and the two differ when
  p does not divide the parameter count.
- One step: K10 all-gathers the shards (``ring_all_gather``, one launch
  per rank); each rank computes its loss and the gradient of it with
  autograd on its shard of the batch, padded with weight-0 rows to a
  multiple of p, which stay inert; K12 reduce-scatters the full-length
  gradients (``ring_reduce_scatter``, one launch per rank); each rank's
  slice is divided by the real batch size and updated elementwise by the
  optimizer; the slices are written back into the DArrays.  The loss is
  the f32 sum of the ranks' weighted sums over the real batch size.

Left out of the signature (the runtime tier; passing one fails):
``ckpt_dir``, ``save_every``, ``policy``, ``step_deadline_s``,
``async_save``, ``max_to_keep`` and ``peer_replicas``, and with them
recovery, the elastic relayout, the fault sites, the straggler probe and
the telemetry spans.  The ``StragglerDetector`` is fed each step's time
after the first (which builds the kernels), and ``stragglers`` counts the
steps that exceeded its budget.
"""

from __future__ import annotations

import collections
import math
import time
from typing import Sequence

import numpy as np
import torch

from ..darray import from_chunks
from ..layout import all_ranks, device_of
from ..ops.cuda_collectives import ring_all_gather, ring_reduce_scatter
from .optim import Optimizer, adam
from .tasks import TrainTask

__all__ = ["Trainer", "StragglerDetector", "fit_result"]


class StragglerDetector:
    """Rolling p99-derived per-step wall-clock budget.  ``observe(dur)``
    returns True when ``dur`` exceeded the budget in force before this
    step, then folds the duration into the window; no budget exists until
    ``warmup`` steps have completed."""

    def __init__(self, factor: float = 3.0, min_budget_s: float = 0.25,
                 warmup: int = 4, window: int = 64):
        self.factor = float(factor)
        self.min_budget_s = float(min_budget_s)
        self.warmup = int(warmup)
        self._durs: collections.deque = collections.deque(maxlen=window)

    def budget(self) -> float | None:
        """The current budget in seconds, or None during warmup."""
        if len(self._durs) < self.warmup:
            return None
        s = sorted(self._durs)
        p99 = s[min(len(s) - 1, math.ceil(0.99 * len(s)) - 1)]
        return max(self.min_budget_s, self.factor * p99)

    def observe(self, dur_s: float) -> bool:
        b = self.budget()
        exceeded = b is not None and dur_s > b
        self._durs.append(float(dur_s))
        return exceeded


def tree_leaves(tree) -> list:
    """The leaves of a nested dict/list/tuple pytree in ``jax.tree_util``'s
    order: dict keys sorted, sequences in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def _rebuild(tree, leaves):
    """``tree``'s structure holding the next items of the ``leaves``
    iterator, taken in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        built = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: built[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(t, leaves) for t in tree)
    return next(leaves)


class Trainer:
    """Data-parallel trainer over DArrays (module docstring).  ``ranks``
    pins the rank set (default: every rank of the table); ``seed`` seeds
    the ``torch.Generator`` that ``task.init_params`` draws from."""

    def __init__(self, task: TrainTask, optimizer: Optimizer | None = None,
                 straggler: StragglerDetector | None = None,
                 ranks: Sequence[int] | None = None, seed: int = 0):
        self.task = task
        self.opt = optimizer or adam()
        self.straggler = straggler or StragglerDetector()
        self.stragglers = 0
        self._ranks = [int(r) for r in ranks] if ranks else all_ranks()
        self.seed = int(seed)
        self._step = 0
        self._losses: dict[int, float] = {}
        self._state: dict | None = None       # name -> DArray
        self._spec = None                     # (index tree, shapes, n)
        self._timed = False
        self._closed = False

    # -- flat parameter vector ---------------------------------------------

    def _flatten_init(self) -> torch.Tensor:
        params = self.task.init_params(torch.Generator().manual_seed(self.seed))
        leaves = tree_leaves(params)
        shapes = [tuple(lf.shape) for lf in leaves]
        flat = torch.cat([lf.detach().to("cpu", torch.float32).reshape(-1)
                          for lf in leaves]) if leaves else torch.zeros(0)
        self._spec = (_rebuild(params, iter(range(len(leaves)))), shapes,
                      int(flat.numel()))
        return flat

    def _leaves_of(self, flat: torch.Tensor) -> list[torch.Tensor]:
        """The parameter leaves as views of ``flat``, in leaf order."""
        views, off = [], 0
        for shp in self._spec[1]:
            k = math.prod(shp)
            views.append(flat[off:off + k].view(shp))
            off += k
        return views

    # -- state ---------------------------------------------------------------

    def _state_names(self) -> list[str]:
        return ["pflat"] + [f"m{i}" for i in range(self.opt.nslots)]

    def _shard_len(self) -> int:
        return -(-self._spec[2] // len(self._ranks))

    def _ensure_state(self):
        if self._state is not None:
            return
        flat = self._flatten_init()
        n, s = flat.numel(), self._shard_len()
        cuts = [min(r * s, n) for r in range(len(self._ranks) + 1)]
        pieces = lambda x: [x[a:b] for a, b in zip(cuts, cuts[1:])]
        self._state = {"pflat": from_chunks(pieces(flat), procs=self._ranks)}
        for i, slot in enumerate(self.opt.init_slots(n)):
            self._state[f"m{i}"] = from_chunks(pieces(slot),
                                               procs=self._ranks)

    def _shard(self, name: str, r: int) -> torch.Tensor:
        """Rank ``r``'s shard of a state vector, padded with zeros."""
        local = self._state[name].localpart(self._ranks[r])
        pad = self._shard_len() - local.numel()
        return local if pad == 0 else torch.cat([local, local.new_zeros(pad)])

    def flat_params(self) -> torch.Tensor:
        """The flat parameter vector on the host (f32)."""
        self._ensure_state()
        return self._state["pflat"].full(torch.device("cpu"))

    # -- one step ------------------------------------------------------------

    def _batch_for(self, step: int):
        """The step's batch padded to a multiple of the rank count with
        weight-0 rows, as one ``(leaves, w)`` pair per rank on its device,
        and the real batch size."""
        p = len(self._ranks)
        leaves = [np.asarray(x) for x in self.task.batch(step)]
        b = int(leaves[0].shape[0])
        bpad = -(-b // p) * p
        leaves = [np.concatenate([x, np.zeros((bpad - b,) + x.shape[1:],
                                              x.dtype)]) for x in leaves]
        w = np.zeros(bpad, np.float32)
        w[:b] = 1.0
        rows = bpad // p
        per_rank = []
        for r, rank in enumerate(self._ranks):
            dev = device_of(rank)
            sl = slice(r * rows, (r + 1) * rows)
            shard = tuple(torch.from_numpy(x[sl]).to(dev) for x in leaves)
            per_rank.append((shard, torch.from_numpy(w[sl]).to(dev)))
        return per_rank, b

    def _attempt_step(self) -> float:
        n = self._step
        t0 = time.monotonic()
        p = len(self._ranks)
        n_params = self._spec[2]
        batches, b_real = self._batch_for(n)
        full = ring_all_gather([self._shard("pflat", r) for r in range(p)], 0)
        index = self._spec[0]
        grads, lsums = [], []
        for r in range(p):
            # one leaf per parameter: the gradient of a slice of one flat
            # leaf would add a zero-filled full-length tensor per parameter
            leaves = [x.requires_grad_(True)
                      for x in self._leaves_of(full[r].detach())]
            with torch.enable_grad():
                loss = self.task.loss_sum(_rebuild(index, iter(leaves)),
                                          *batches[r])
                gl = torch.autograd.grad(loss, leaves, allow_unused=True)
            g = torch.empty_like(full[r])
            g[n_params:].zero_()
            torch.cat([(torch.zeros_like(x) if d is None else d).reshape(-1)
                       for x, d in zip(leaves, gl)], out=g[:n_params])
            grads.append(g)
            lsums.append(float(loss.detach()))
        del full
        gs = ring_reduce_scatter(grads, 0)
        del grads
        names = self._state_names()
        for r, rank in enumerate(self._ranks):
            g = gs[r] / torch.tensor(float(b_real), dtype=torch.float32,
                                     device=gs[r].device)
            outs = self.opt.update(n + 1, self._shard("pflat", r), g,
                                   tuple(self._shard(m, r)
                                         for m in names[1:]))
            for name, new in zip(names, outs):
                local = self._state[name].localpart(rank)
                local.copy_(new[:local.numel()])
        loss = float(np.asarray(lsums, np.float32).sum() / np.float32(b_real))
        dur = time.monotonic() - t0
        if self._timed and self.straggler.observe(dur):
            self.stragglers += 1
        self._timed = True
        self._losses[n] = loss
        self._step = n + 1
        return loss

    # -- public API ----------------------------------------------------------

    def fit(self, steps: int) -> dict:
        """Train to ``steps`` total optimizer steps.  Returns ``{"losses",
        "start", "steps", "resumed_from"}``: ``losses[i]`` is the loss of
        step ``start + i``."""
        if self._closed:
            raise RuntimeError("trainer is closed")
        self._ensure_state()
        first = self._step
        while self._step < int(steps):
            self._attempt_step()
        start = min(self._losses) if self._losses else int(steps)
        return {"losses": [self._losses[i] for i in range(start, int(steps))],
                "start": start, "steps": self._step, "resumed_from": first}

    def step_once(self) -> float:
        """One step; its loss."""
        if self._closed:
            raise RuntimeError("trainer is closed")
        self._ensure_state()
        return self._attempt_step()

    @property
    def step(self) -> int:
        return self._step

    def losses(self) -> dict:
        """Per-step loss record."""
        return dict(self._losses)

    def close(self):
        if self._closed:
            return
        self._closed = True
        if self._state:
            for d in self._state.values():
                d.close()
        self._state = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def fit_result(losses: list, from_step: int = 0) -> list:
    """The loss trajectory from a resume point (test/bench helper)."""
    return list(losses[from_step:])
