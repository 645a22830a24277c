"""Chaos-survivable data-parallel trainer over DArrays, with its gradient
sync on the collective kernels.

PyTorch counterpart of ``distributedarrays_tpu/train/trainer.py``
(``Trainer``, ``StragglerDetector``, ``DeadRankError``, ``fit_result``):

- The parameters are one flat f32 vector in ``jax.tree_util``'s leaf order
  (dict keys sorted, lists in order), so it equals the JAX trainer's
  element for element.  It is padded to ``ppad``, a multiple of the rank
  count p, and split evenly into ``ppad / p`` shards, one per rank: the
  ZeRO-1 layout, every optimizer moment split the same way.  The state
  lives in DArrays (``pflat``, ``m0``, ``m1``) whose cuts are those shards
  cut back to the vector's length (the shard cuts); the JAX trainer's
  DArray keeps the default cuts and pads its global array instead, and the
  two differ when p does not divide the parameter count.
- One step: K10 all-gathers the shards (``ring_all_gather``, one launch
  a card); each rank computes its loss and the gradient of it with
  autograd on its shard of the batch, padded with weight-0 rows to a
  multiple of p, which stay inert; K12 reduce-scatters the full-length
  gradients (``ring_reduce_scatter``, one launch per rank); each rank's
  slice is divided by the real batch size and updated elementwise by the
  optimizer; the slices are written back into the DArrays.  The loss is
  the f32 sum of the ranks' weighted sums over the real batch size.
- The rank set is ``elastic.manager().live_ranks()``, or the live ranks of
  the pinned ``ranks`` (none live raises: a pinned run never moves onto
  ranks the caller left out).  Before each step every state DArray that is
  not on the shard cuts of the step's ranks is re-laid onto them in place
  with ``elastic.relayout(d, ranks, cuts)`` (the reshard planner's
  all-to-all or chain where the cuts divide the vector evenly, else
  ``gather_put`` onto the ranks and each keeping its window; K10/K11 on
  the card).  That is what a resume onto another rank set, a restore
  (which comes back on the saved cuts) and an ``elastic.shrink()`` (which
  leaves the default cuts over the survivors) all need.
- With ``ckpt_dir`` a ``CheckpointManager`` publishes ``{"step", "pflat",
  "m0", ...}`` every ``save_every`` steps (``peer_replicas``: also into
  buddy-rank memory); a new trainer on the directory resumes from the
  latest verified step.  Each step runs under
  ``recovery.run_with_recovery`` (``policy``; ``step_deadline_s`` is the
  per-step ``max_elapsed_s``); a device loss restores the last step
  (``_adopt``: a checkpoint missing an optimizer slot fails diagnosably
  after closing what was restored, surplus slots are closed, later steps
  are discarded), shrinks onto the survivors and recomputes.
- Straggler probe: the step's wall time (the card synchronized) feeds a
  rolling p99 budget (``StragglerDetector``); the first step on a rank set
  or batch shape, and a step that built a kernel, neither feed nor are
  judged.  An exceeded budget probes the elastic set, and a dead rank of
  the step raises :class:`DeadRankError` (a device loss) before the
  update is written, so a retried step is never applied twice.
- Fault sites ``train.step`` (the top of a step) and ``grad.sync``
  (between the per-rank gradients and the K10/K12 sync); spans
  ``train.step`` (stamped with ``perf.train_step_cost``), ``train.grad``
  and ``train.sync``; the ``train.step_s`` gauge and stream point.
- In a job of several controller processes (``parallel.multihost``; the
  JAX trainer's one ``shard_map`` program over a mesh that spans
  processes) every process runs ``fit``/``step_once`` together: each
  builds the batches, gradients and updates of its own ranks (another
  process's ranks are ``meta`` placeholders), K10 and K12 take their
  cross-process routes (``ring_all_gather``'s one exchange,
  ``ring_reduce_scatter``'s launch a rank over CUDA IPC, gloo off the
  card), and one host exchange carries every rank's loss sum, the slowest
  process's step time and whether any process's step was fresh, so every
  process returns the same loss, bit-equal to one process on the same
  ranks, and takes the straggler gate's branch together (a confirmed dead
  rank is the union of the processes' probes, each probe after a
  barrier, which proves every peer process alive whatever its heartbeat's
  age).  The step's rank set is ``live_ranks()``, the same on
  every process: the recovery's shrink agrees on the union of the
  processes' down sets, and ``elastic`` holds it until the next shrink or
  grow.  A failure at the ``train.step`` site that one process sees
  reaches every process before the step's first collective (one
  exchange; the others raise :class:`PeerFault` with its message).  The
  recovery loop then takes one decision for the job at each branch: one
  exchange of the processes' verdicts and retry decisions, so a process
  that classified the failure apart, or would give up, does not leave
  its peers in calls it never makes (``_JobDevices.exchange``,
  ``recovery._agreed``).  The
  checkpoints are chunked (``store="chunks"``) in the ``ckpt_dir`` that
  every process shares: a save writes each process's own cells and
  gathers nothing.  A recovery runs on every process together: the
  restore of the newest step every process verified (each process reads
  its own cells), the shrink onto the agreed survivors and ``_relay_state``
  (``elastic.relayout``'s region copies, K10's ``cross_process_region``
  route on the card; a process left with no rank takes part in every
  exchange with placeholders).  A plan at ``grad.sync`` in a job must be
  armed on every process.  ``flat_params`` gathers on every process.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Sequence

import numpy as np
import torch

from .. import telemetry as _tm
from ..darray import from_chunks
from ..layout import device_of, is_local
from ..ops.cuda_collectives import ring_all_gather, ring_reduce_scatter
from ..parallel import multihost
from ..resilience import elastic, faults, recovery
from ..telemetry import stream as _tstream
from ..utils import kbuild
from .optim import Optimizer, adam
from .tasks import TrainTask

__all__ = ["Trainer", "StragglerDetector", "DeadRankError", "PeerFault",
           "fit_result"]


class DeadRankError(RuntimeError):
    """A straggler probe confirmed a rank's device is gone.  The message
    carries the ``device lost`` fingerprint, so ``recovery.classify``
    reaches the ``device_loss`` verdict (restore, shrink, retry)."""

    def __init__(self, ranks, budget_s: float, dur_s: float):
        self.ranks = sorted(int(r) for r in ranks)
        super().__init__(
            f"straggler probe confirmed rank(s) {self.ranks} device lost "
            f"(step took {dur_s:.3f}s against a {budget_s:.3f}s rolling "
            f"p99 budget)")


class PeerFault(RuntimeError):
    """Another process of the job failed the top of this step (a fault
    only it saw): every process raises before the step's first
    collective.  The message carries the peer's error, so
    ``recovery.classify`` reaches the same verdict on every process."""


def _shared_fault(err: BaseException | None) -> None:
    """The top of a step in a job: one exchange of every process's failure
    there; this process's own error re-raises, another's raises
    :class:`PeerFault`, so every process takes the recovery together."""
    every = multihost._all_gather_objects(
        None if err is None else f"{type(err).__name__}: {err}")
    if err is not None:
        raise err
    for q, e in enumerate(every):
        if e is not None:
            raise PeerFault(f"process {q} failed at the top of the step: "
                            f"{e}")


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


def _close_all(ds) -> None:
    for d in ds:
        try:
            d.close()
        except Exception:  # noqa: BLE001 — already closed is fine
            pass


class Trainer:
    """Data-parallel trainer over DArrays (module docstring).

    ``ckpt_dir=None`` trains without durable state (recovery retries from
    live state).  ``async_save`` defaults to False: the chaos runs need the
    set of published steps at a fault to depend on the step index alone.
    ``ranks`` pins the rank set (intersected with the elastic live set
    each attempt); ``seed`` seeds the ``torch.Generator`` that
    ``task.init_params`` draws from."""

    def __init__(self, task: TrainTask, optimizer: Optimizer | None = None,
                 ckpt_dir=None, save_every: int = 0,
                 step_deadline_s: float | None = None,
                 policy: recovery.RetryPolicy | None = None,
                 straggler: StragglerDetector | None = None,
                 ranks: Sequence[int] | None = None,
                 seed: int = 0, async_save: bool = False,
                 max_to_keep: int | None = None,
                 peer_replicas: bool = False):
        self.task = task
        self.opt = optimizer or adam()
        self.save_every = int(save_every)
        self.step_deadline_s = step_deadline_s
        self.straggler = straggler or StragglerDetector()
        self.stragglers = 0
        self._policy = policy
        self._pin_ranks = [int(r) for r in ranks] if ranks else None
        self.seed = int(seed)
        self._mgr = None
        if ckpt_dir is not None:
            from ..utils.checkpoint import CheckpointManager, \
                PeerReplicaStore
            # in a job the steps are chunked, one directory for every
            # process; one process keeps JAX's npz format
            self._mgr = CheckpointManager(
                ckpt_dir, async_save=async_save, max_to_keep=max_to_keep,
                replicas=PeerReplicaStore() if peer_replicas else None,
                store="chunks" if multihost.in_job() else "npz")
        self._step = 0
        self._losses: dict[int, float] = {}
        self._state: dict | None = None       # name -> DArray
        self._spec = None                     # (index tree, shapes, n)
        self._seen: set = set()               # (ranks, batch shapes) run
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

    # -- rank set / state ------------------------------------------------------

    def _ranks_now(self) -> list[int]:
        # in a job every process reads the same set: a loss one process
        # saw is every process's from the shrink that handled it on
        live = elastic.manager().live_ranks()
        if self._pin_ranks is not None:
            pinned = [r for r in self._pin_ranks if r in live]
            if not pinned:
                # the pin is a hard boundary: never move onto ranks the
                # caller left out
                raise RuntimeError(
                    f"trainer: no pinned rank of {self._pin_ranks} is "
                    f"live (live set: {live})")
            return pinned
        if not live:
            raise RuntimeError("trainer: no live devices remain")
        return live

    def _state_names(self) -> list[str]:
        return ["pflat"] + [f"m{i}" for i in range(self.opt.nslots)]

    def _shard_cuts(self, p: int) -> list[int]:
        n = self._spec[2]
        s = -(-n // p)
        return [min(r * s, n) for r in range(p + 1)]

    def _ensure_state(self):
        if self._state is not None:
            return
        if self._mgr is not None and self._mgr.steps():
            # resume from the latest verified step (a corrupt one is
            # quarantined and passed over inside restore())
            self._adopt(self._mgr.restore())
            return
        flat = self._flatten_init()
        ranks = self._ranks_now()
        cuts = self._shard_cuts(len(ranks))

        def pieces(x):
            return [x[a:b] for a, b in zip(cuts, cuts[1:])]
        self._state = {"pflat": from_chunks(pieces(flat), procs=ranks)}
        for i, slot in enumerate(self.opt.init_slots(flat.numel())):
            self._state[f"m{i}"] = from_chunks(pieces(slot), procs=ranks)  # dalint: disable=DAL006 — long-lived optimizer state, closed by _close_state()

    def _adopt(self, tree: dict):
        """Re-seat the state from a restored checkpoint tree (recovery's
        ``restore_fn`` and the resume path): close the current DArrays,
        take the restored ones, rewind the step and the loss record, and
        discard the later checkpoints of the abandoned timeline."""
        if self._spec is None:
            self._flatten_init()
        names = self._state_names()
        missing = [k for k in names if k not in tree]
        extra = [k for k in tree
                 if k not in names and k != "step" and hasattr(tree[k],
                                                               "close")]
        if missing:
            # written with another optimizer: close what was restored
            # first, then fail diagnosably
            _close_all(v for v in tree.values() if hasattr(v, "close"))
            raise ValueError(
                f"checkpoint step {tree.get('step')} is missing optimizer "
                f"state {missing} (this trainer expects {names}); it was "
                f"written with a different optimizer configuration")
        self._close_state()
        self._state = {k: tree[k] for k in names}
        _close_all(tree[k] for k in extra)
        self._step = int(tree["step"])
        self._losses = {k: v for k, v in self._losses.items()
                        if k < self._step}
        if self._mgr is not None:  # dalint: disable=DAL010 — every process builds the trainer with the same ckpt_dir argument
            self._mgr.discard_from(self._step + 1)
        _tm.count("train.reseats")
        if _tm.enabled():
            # cold path: one re-seat a recovery
            _tm.event("train", "reseat", step=self._step)

    def _close_state(self):
        if self._state:
            _close_all(self._state.values())
        self._state = None

    def _relay_state(self, ranks: list[int]) -> None:
        """Every state DArray onto the shard cuts of ``ranks`` (in a job a
        call of every process: each move is the reshard's region copy)."""
        cuts = [self._shard_cuts(len(ranks))]
        for d in self._state.values():
            if [int(x) for x in d.pids.flat] != ranks or d.cuts != cuts:
                elastic.relayout(d, ranks, cuts)

    def _shard(self, name: str, rank: int, slen: int) -> torch.Tensor:
        """Rank ``rank``'s shard of a state vector, padded with zeros to
        ``slen`` (another process's rank: a ``meta`` placeholder)."""
        if not is_local(rank):
            return torch.empty(slen, device="meta")
        local = self._state[name].localpart(rank)
        pad = slen - local.numel()
        return local if pad == 0 else torch.cat([local, local.new_zeros(pad)])

    def flat_params(self) -> torch.Tensor:
        """The flat parameter vector on the host (f32)."""
        self._ensure_state()
        return self._state["pflat"].full(torch.device("cpu"))

    # -- one recoverable step ------------------------------------------------

    def _batch_for(self, step: int, ranks: list[int]):
        """The step's batch padded to a multiple of the rank count with
        weight-0 rows, as one ``(leaves, w)`` pair per rank on its device
        (None for another process's rank: every process draws the same
        host leaves from the step), and the real batch size."""
        p = len(ranks)
        leaves = [np.asarray(x) for x in self.task.batch(step)]
        b = int(leaves[0].shape[0])
        bpad = -(-b // p) * p
        leaves = [np.concatenate([x, np.zeros((bpad - b,) + x.shape[1:],
                                              x.dtype)]) for x in leaves]
        w = np.zeros(bpad, np.float32)
        w[:b] = 1.0
        rows = bpad // p
        per_rank = []
        for r, rank in enumerate(ranks):
            if not is_local(rank):
                per_rank.append(None)
                continue
            dev = device_of(rank)
            sl = slice(r * rows, (r + 1) * rows)
            shard = tuple(torch.from_numpy(x[sl]).to(dev) for x in leaves)
            per_rank.append((shard, torch.from_numpy(w[sl]).to(dev)))
        return per_rank, b, leaves

    def _grads(self, ranks, slen, batches):
        """K10 all-gathers the parameter shards; each rank's full-length
        gradient and its weighted loss sum (another process's rank: a
        placeholder gradient and no sum)."""
        n_params = self._spec[2]
        full = ring_all_gather([self._shard("pflat", r, slen)
                                for r in ranks], 0)
        index = self._spec[0]
        grads, lsums = [], []
        for r in range(len(ranks)):
            if batches[r] is None:
                grads.append(full[r])
                lsums.append(None)
                continue
            # one leaf a parameter: the gradient of a slice of one flat
            # leaf would add a zero-filled full-length tensor a parameter
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
            lsums.append(loss.detach())
        return grads, lsums

    def _sync(self, n, ranks, slen, grads, b_real):
        """K12 reduce-scatters the gradients; each rank's updated parameter
        and moment shards (not yet written back)."""
        gs = ring_reduce_scatter(grads, 0)
        names = self._state_names()
        outs = []
        for r, rank in enumerate(ranks):
            if not is_local(rank):
                outs.append(None)
                continue
            g = gs[r] / torch.tensor(float(b_real), dtype=torch.float32,
                                     device=gs[r].device)
            outs.append(self.opt.update(
                n + 1, self._shard("pflat", rank, slen), g,
                tuple(self._shard(m, rank, slen) for m in names[1:])))
        return outs

    def _attempt_step(self) -> float:
        n = self._step
        ranks = self._ranks_now()
        self._relay_state(ranks)
        p = len(ranks)
        slen = -(-self._spec[2] // p)
        batches, b_real, host = self._batch_for(n, ranks)
        key = (tuple(ranks), tuple(x.shape for x in host),
               tuple(str(x.dtype) for x in host))
        fresh = key not in self._seen
        built0 = len(kbuild._libs)
        epoch = n // self.save_every if self.save_every else 0
        with _tm.span("train.step", step=n, ranks=p):
            if _tm.enabled():
                from ..telemetry import perf as _perf
                _tm.annotate(**_perf.train_step_cost(
                    n_params=slen * p, p=p,
                    flops=float(self.task.step_flops(host[0].shape[0])),
                    batch_bytes=sum(int(x.nbytes) for x in host),
                    nslots=self.opt.nslots))
            t0 = time.monotonic()
            job = multihost.in_job()
            # chaos site: the top of every step (a hang here counts
            # against the straggler budget: the clock is running); in a
            # job a failure any process sees is every process's before
            # the step's first collective
            try:
                faults.check("train.step", step=n, epoch=epoch)
            except Exception as e:  # noqa: BLE001 — shared, then re-raised
                if not job:
                    raise
                _shared_fault(e)
            if job:
                _shared_fault(None)
            with _tm.span("train.grad", step=n, kind="compute"):
                grads, lsums = self._grads(ranks, slen, batches)
                lsum = {r: float(x) for r, x in zip(ranks, lsums)
                        if x is not None}
            # chaos site: between the per-rank gradients and the sync
            faults.check("grad.sync", step=n)
            with _tm.span("train.sync", step=n, kind="comm"):
                outs = self._sync(n, ranks, slen, grads, b_real)
                del grads
                for dev in {device_of(r) for r in ranks}:
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
            dur = time.monotonic() - t0
            _tm.set_gauge("train.step_s", round(dur, 6))
            _tstream.note("train.step_s", round(dur, 6))
            # the straggler gate comes before the update is written: a
            # confirmed dead rank aborts the step, and the retry recomputes
            # it.  A step that built kernels (or is the first on its rank
            # set and shapes) neither feeds nor is judged by the window
            fresh = fresh or len(kbuild._libs) != built0
            self._seen.add(key)
            if job:
                # every process must take the gate's branch: one exchange
                # carries the ranks' loss sums, the slowest process's step
                # time and whether any process's step was fresh
                every = multihost._all_gather_objects((lsum, dur, fresh))
                lsum = {r: x for e in every for r, x in e[0].items()}
                dur = max(e[1] for e in every)
                fresh = any(e[2] for e in every)
            if not fresh and self.straggler.observe(dur):
                self.stragglers += 1
                _tm.count("train.stragglers")
                if _tm.enabled():
                    # cold path: an exceeded budget is exceptional
                    _tm.event("train", "straggler", step=n,
                              dur=round(dur, 6))
                probe = _probe()
                dead = set(probe["down"]) & set(ranks)
                if job:
                    # each process probes its own census: the union
                    dead = set().union(
                        *multihost._all_gather_objects(sorted(dead)))
                if dead:
                    raise DeadRankError(dead, self.straggler.budget()
                                        or 0.0, dur)
            loss = float(np.asarray([lsum[r] for r in ranks], np.float32)
                         .sum() / np.float32(b_real))
            for rank, new in zip(ranks, outs):
                if new is None:
                    continue
                for name, t in zip(self._state_names(), new):
                    local = self._state[name].localpart(rank)
                    local.copy_(t[:local.numel()])
        self._losses[n] = loss
        self._step = n + 1
        if self._mgr is not None and self.save_every and \
                self._step % self.save_every == 0:
            self._mgr.save(self._step, self._ckpt_tree())
        return loss

    def _ckpt_tree(self):
        return {"step": self._step,
                **{k: self._state[k] for k in self._state_names()}}

    def _step_policy(self) -> recovery.RetryPolicy:
        pol = self._policy if self._policy is not None \
            else recovery.RetryPolicy()
        if self.step_deadline_s is not None and pol.max_elapsed_s is None:
            pol = dataclasses.replace(pol, max_elapsed_s=self.step_deadline_s)
        return pol

    def _recovered_step(self) -> float:
        return recovery.run_with_recovery(
            self._attempt_step, policy=self._step_policy(),
            checkpoints=self._mgr,
            restore_fn=self._adopt if self._mgr is not None else None,
            devices=_JobDevices() if multihost.in_job() else None)

    # -- public API ----------------------------------------------------------

    def fit(self, steps: int) -> dict:
        """Train to ``steps`` total optimizer steps (resuming from the
        current or restored step), each step under the recovery executor.
        Returns ``{"losses", "start", "steps", "resumed_from"}``:
        ``losses[i]`` is the final loss of step ``start + i``; ``start`` is
        0 for a fresh run and the restored step for a resumed one."""
        if self._closed:
            raise RuntimeError("trainer is closed")
        self._ensure_state()
        first = self._step
        while self._step < int(steps):
            self._recovered_step()
        if self._mgr is not None:
            self._mgr.wait()
        start = min(self._losses) if self._losses else int(steps)
        return {"losses": [self._losses[i] for i in range(start, int(steps))],
                "start": start, "steps": self._step, "resumed_from": first}

    def step_once(self) -> float:
        """One recovered step; its loss."""
        if self._closed:
            raise RuntimeError("trainer is closed")
        self._ensure_state()
        return self._recovered_step()

    @property
    def step(self) -> int:
        return self._step

    def losses(self) -> dict:
        """Per-step final loss record (recomputed values win)."""
        return dict(self._losses)

    def close(self):
        if self._closed:
            return
        self._closed = True
        self._close_state()
        if self._mgr is not None:
            self._mgr.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _probe() -> dict:
    """One elastic probe.  In a job every process first publishes its
    heartbeat and meets the others at a barrier (a call of every
    process).  Every peer process met this one there, so the probe counts
    none of them down by the age of its heartbeat: a process that came
    late to the barrier would otherwise read the heartbeats its peers
    published before their wait as stale, and reach alone a verdict that
    its peers do not."""
    if multihost.in_job():
        multihost.heartbeat()
        multihost.sync_hosts("trainer_probe")
        return elastic.manager().probe(peers_met=True)
    return elastic.manager().probe()


class _JobDevices:
    """The elastic set as a step's recovery sees it in a job of several
    controller processes, every process taking the recovery together:
    one exchange of every process's decision a branch (``exchange``; the
    recovery loop merges them), the probe after a barrier (``_probe``),
    and the shrink, which re-lays every registered DArray onto the ranks
    that every process agrees are live (the union of their down sets) by
    the reshard's region copies."""

    def exchange(self, decision: tuple) -> list:
        """Every process's ``decision`` of the recovery loop, in process
        order, in one exchange."""
        return multihost._all_gather_objects(decision)

    def probe(self) -> dict:
        return _probe()

    def shrink(self, domain: int | None = None) -> dict:
        return elastic.manager().shrink(domain)


def fit_result(losses: list, from_step: int = 0) -> list:
    """The loss trajectory from a resume point (test/bench helper)."""
    return list(losses[from_step:])
