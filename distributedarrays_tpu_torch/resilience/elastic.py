"""Elastic device sets: shrink onto survivors, grow back on revival.

PyTorch counterpart of ``distributedarrays_tpu/resilience/elastic.py``
(its whole ``__all__``): a health ledger over the ranks of the rank table,
and a re-layout engine that moves every registered DArray
(``core.live_arrays()``) onto the live ranks through the port's reshard.

- :func:`manager` is the process-wide :class:`ElasticDeviceSet`;
  ``mark_down`` / ``mark_up`` are explicit health edits.
- ``probe()`` is one health epoch: the real signal (a rank is down when the
  CUDA device it sits on is no longer enumerated by torch, or every CUDA
  rank when torch cannot count the devices; in a multi-process job, every
  rank of a peer process whose heartbeat went stale; ``DA_TPU_ELASTIC_HW_
  PROBE=0`` turns this half off, ``DA_TPU_ELASTIC_ACTIVE_PROBE=1`` adds a
  one-element round trip per local device), merged with the manual marks
  and the fault harness's simulated-down set (``faults.probe_tick``, where
  simulated devices revive), the ``elastic.live_devices`` gauge and the
  quorum verdict (``parallel.multihost.quorum_assess``).
- ``shrink()`` re-lays every registered DArray that touches a down rank
  onto the survivors, in place: the same id and registry entry, new
  ``pids``/``indices``/``cuts`` and tensors it owns.  The target is JAX's:
  the default layout of the array over the live ranks.  Where that layout
  divides every dim, the move is ``reshard.relayout_parts`` (the planner's
  ``all_to_all``, ``chain`` or ``device_put``); where it does not (JAX's
  ``sharding_for`` replicates such a dim, and its planner then takes
  ``gather_put``), the whole array is gathered onto the survivors by
  ``reshard.allgather`` (``gather_put``, ``all_gather`` or ``chain``) and
  each keeps its window.  On the card both run on K10/K11's copy kernel.
  In a job of several controller processes ``shrink()`` is a call of
  every process: one exchange gives every process the union of the
  processes' down sets and the arrays they all hold, and every move is the
  reshard's region copy (each new cell fetches its own region, K10's
  ``cross_process_region`` route on the card); a process left with no
  rank takes part with placeholders.  Every process keeps that union
  down until the next agreement (``shrink``/``grow``), so ``live_ranks()``
  gives the same set on every process between them, also where only one
  process saw the loss or only one sees the revival.
- ``grow()`` moves back only the arrays ``shrink()`` displaced (in a job,
  on the same agreed rank set).

A simulated-down rank still answers reads, so ``shrink`` keeps the data.
The multi-process half is ``parallel.multihost``'s: each probe publishes
this process's heartbeat and clock sample, journals the clock offsets
(the ``multihost/clock`` events the journal merge aligns by), and marks
down the ranks of every peer process whose heartbeat is stale (JAX
``elastic.py:238-253``); a single-process run has no peers, so nothing is
stale.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import torch

from .. import core
from .. import layout as L
from .. import telemetry as _tm
from ..ops import ring_schedules as _sched
from . import faults

__all__ = ["ElasticDeviceSet", "manager", "relayout"]


def _moved_parts(d, pids: np.ndarray, cuts) -> np.ndarray:
    """``d``'s cells on the layout ``(pids, cuts)``, tensors ``d`` does not
    share: the planned reshard when the layout divides every dim, else the
    gather onto its ranks and each rank's window.  In a job of several
    processes every move is the reshard's region copy (each target cell
    fetches its own region, never the whole array)."""
    from ..parallel import reshard as _rs
    if L.process_count() > 1 or \
            all((c[-1] % (len(c) - 1)) == 0 for c in cuts):
        return _rs.relayout_parts(d, pids, cuts, op="elastic")
    use = [int(p) for p in pids.flat]
    whole = dict(zip(use, _rs.allgather(d, use, op="elastic")))
    parts = np.empty(tuple(pids.shape), dtype=object)
    for ci in np.ndindex(*pids.shape):
        sl = tuple(slice(c[j], c[j + 1]) for c, j in zip(cuts, ci))
        parts[ci] = whole[int(pids[ci])][sl].clone()
    return parts


def relayout(d, ranks: list[int], cuts=None) -> bool:
    """Re-lay DArray ``d`` onto ``ranks`` in place (JAX ``elastic.py:67``):
    on its default layout there, or on the cut vectors ``cuts`` over the
    first ranks (the trainer's shard cuts).  Returns True when it moved,
    False when it already has that layout.  The new tensors are built
    before any metadata changes, so a failed move leaves ``d`` as it
    was."""
    ranks = [int(r) for r in ranks]
    if not ranks:
        raise ValueError("cannot re-lay-out onto an empty device set")
    dims = tuple(d.dims)
    if cuts is None:
        grid = tuple(int(c) for c in L.defaultdist(dims, ranks))
        idxs, cuts = L.chunk_idxs(dims, grid)
    else:
        grid = tuple(len(c) - 1 for c in cuts)
        idxs = L.idxs_from_cuts(cuts, grid)
    need = int(np.prod(grid)) if grid else 1
    if need > len(ranks):
        raise ValueError(f"layout {grid} needs {need} ranks, got "
                         f"{len(ranks)}")
    use = ranks[:need]
    cuts = [[int(x) for x in c] for c in cuts]
    if list(use) == [int(p) for p in d.pids.flat] and cuts == d.cuts:
        return False
    d._check_open()
    pids = np.asarray(use, dtype=np.int64).reshape(grid)
    with _tm.span("elastic.relayout", id=str(d.id)):
        parts = _moved_parts(d, pids, cuts)
        d.pids = pids
        d.indices = idxs
        d.cuts = cuts
        d._parts = parts
        # the relaid tensors stay the same owner's in the ledger
        d._track("elastic")
    _tm.count("elastic.relayouts")
    return True


def _arrays() -> list:
    """The live registered DArrays (a ``DData`` has no layout to move)."""
    from ..darray import DArray
    return [d for d in core.live_arrays() if isinstance(d, DArray)]


def _agreed(down: set, arrays: list, tag: str) -> tuple[set, list]:
    """In a job of several controller processes: the union of every
    process's own down set and the arrays that every process holds (by id,
    in id order), in one exchange, so the shrink and the grow are the same
    collective moves on every process.  One process: as given."""
    from ..parallel import multihost as _mh
    if not _mh.in_job():
        return down, arrays
    _sched.record("publish", tag)
    every = _mh._all_gather_objects((sorted(down),
                                     [tuple(d.id) for d in arrays]))
    ids = set(every[0][1]).intersection(*(set(e[1]) for e in every[1:]))
    return (set().union(*(set(e[0]) for e in every)),
            [d for d in arrays if tuple(d.id) in ids])


class ElasticDeviceSet:
    """Health ledger over the device ranks plus the re-layout engine."""

    def __init__(self):
        self._lock = threading.RLock()
        self._manual_down: dict[int, float] = {}    # rank -> since (mono)
        self._sim_down: set[int] = set()
        self._hw_down: set[int] = set()             # REAL-signal probe
        # in a job: the union of every process's down set at the last
        # shrink/grow, held until the next one, so every process reads
        # one live set between them
        self._peer_down: set[int] = set()
        # array ids shrink() re-laid-out — the ONLY ids grow() touches:
        # an array the failure never displaced keeps whatever layout its
        # owner chose (growing everything would destroy deliberate
        # non-default distributions)
        self._shrunk: set = set()
        # last quorum assessment from probe() — what serve/ reads to
        # decide a typed drain instead of timing requests out
        self._partition: dict | None = None

    # -- health ------------------------------------------------------------

    def _expected_ranks(self) -> list[int]:
        # the rank table is the baseline: init() sets it, and a lost card
        # does not shrink it (the hardware probe downs that card's ranks).
        # With no table and no card there are no ranks to report on.
        try:
            return L.all_ranks()
        except RuntimeError:
            return []

    def all_ranks(self) -> list[int]:
        return self._expected_ranks()

    def _own_down(self) -> set[int]:
        with self._lock:
            return (set(self._manual_down) | set(self._sim_down)
                    | set(self._hw_down))

    def down_ranks(self) -> set[int]:
        with self._lock:
            return self._own_down() | set(self._peer_down)

    def live_ranks(self) -> list[int]:
        down = self.down_ranks()
        return [r for r in self._expected_ranks() if r not in down]

    def _agree(self, tag: str) -> tuple[set, list]:
        """The down set and the arrays of a shrink or grow (``_agreed``
        over this process's own marks); in a job the union is held as
        :attr:`_peer_down` until the next agreement."""
        down, arrays = _agreed(self._own_down(), _arrays(), tag)
        from ..parallel import multihost as _mh
        if _mh.in_job():
            with self._lock:
                self._peer_down = set(down)
            self._update_gauge()
        return down, arrays

    def mark_down(self, rank: int, reason: str = "manual") -> None:
        with self._lock:
            fresh = int(rank) not in self._manual_down
            self._manual_down.setdefault(int(rank), time.monotonic())
        if fresh:
            _tm.count("elastic.marked_down")
            if _tm.enabled():
                # cold path: a device transition is an exceptional event
                _tm.event("elastic", "down", rank=int(rank),
                          reason=reason)
        self._update_gauge()

    def mark_up(self, rank: int) -> None:
        # also revives a plan-downed device whose spec had no
        # revive_after countdown (down-until-mark_up semantics); the
        # next probe() epoch re-merges the shrunken simulated set.
        # The hw mark clears too — mark_up is the operator override, and
        # a still-dead device simply re-enters _hw_down on the next probe
        faults.revive(int(rank))
        with self._lock:
            self._sim_down.discard(int(rank))
            self._hw_down.discard(int(rank))
            was = self._manual_down.pop(int(rank), None)
        if was is not None and _tm.enabled():
            # cold path: a device transition is an exceptional event
            _tm.event("elastic", "up", rank=int(rank))
        self._update_gauge()

    def _hw_probe(self) -> set[int]:
        """One real-signal reading (JAX ``elastic.py:191``): a CUDA rank is
        down when its device index is no longer below
        ``torch.cuda.device_count()`` (every CUDA rank when torch cannot
        count); ``DA_TPU_ELASTIC_ACTIVE_PROBE=1`` adds a one-element round
        trip to each rank's device.  CPU ranks never go down here.  In a
        multi-process job the multihost heartbeat rides along: publish
        this process's, journal the clock offsets, and down every rank of
        a peer process whose heartbeat is stale (JAX ``elastic.py:238``).
        ``DA_TPU_ELASTIC_HW_PROBE=0`` disables it."""
        if os.environ.get("DA_TPU_ELASTIC_HW_PROBE", "1") == "0":
            return set()
        expected = self._expected_ranks()
        down = self._peer_probe(expected)
        cuda = {r: L.device_of(r) for r in expected
                if L.device_of(r).type == "cuda"}
        if not cuda:
            return down
        try:
            count = torch.cuda.device_count()
        except Exception:
            return down | set(cuda)
        down |= {r for r, dev in cuda.items() if dev.index >= count}
        if os.environ.get("DA_TPU_ELASTIC_ACTIVE_PROBE") == "1":
            for r, dev in cuda.items():  # pragma: no cover - opt-in
                if r in down:
                    continue
                try:
                    torch.zeros(1, device=dev).cpu()
                except Exception:
                    down.add(r)
        return down

    @staticmethod
    def _peer_probe(expected) -> set[int]:
        """The ranks of stale peer processes, after this process's
        heartbeat and clock-offset exchange; empty single-process."""
        from ..parallel import multihost as _mh
        try:
            _mh.heartbeat()
            # the clock samples the heartbeats published become the
            # multihost/clock events telemetry.cluster aligns journals by
            _mh.exchange_clock_offsets()
            stale = _mh.down_peer_processes()
        except Exception:  # the heartbeat must not kill the probe
            return set()
        return {r for r in expected if L.process_of(r) in stale}

    def probe(self) -> dict:
        """One health epoch: read the REAL device signals
        (:meth:`_hw_probe`), advance the fault harness's revive clocks
        and merge its simulated-down set (the deterministic-test
        fallback) with the manual marks, and report
        ``{"live": [...], "down": [...], "changed": bool,
        "partition": {...}}``.  The partition entry is the multihost
        quorum verdict (``quorum_assess``), cached for
        :meth:`partition_verdict` — the health signal serve/ reads to
        drain typed on the minority side."""
        hw = self._hw_probe()
        sim = faults.probe_tick()
        try:
            from ..parallel import multihost as _mh
            part = _mh.quorum_assess()
        except Exception:  # pragma: no cover — quorum must not kill probes
            part = None
        with self._lock:
            changed = sim != self._sim_down or hw != self._hw_down
            self._sim_down = set(int(r) for r in sim)
            self._hw_down = set(int(r) for r in hw)
            if part is not None:
                self._partition = part
        self._update_gauge()
        live, down = self.live_ranks(), sorted(self.down_ranks())
        _tm.count("elastic.probes")
        if changed and _tm.enabled():
            # cold path: only journaled on a health transition
            _tm.event("elastic", "probe", live=len(live),
                      down=down, hw=sorted(hw), sim=sorted(sim))
        out = {"live": live, "down": down, "changed": changed}
        if part is not None:
            out["partition"] = dict(part)
        return out

    def partition_verdict(self) -> dict:
        """The last probe epoch's quorum assessment (healthy until a
        probe has run) — ``{"verdict": "healthy"|"quorum"|"minority",
        "side", "lost", "reason"}``."""
        with self._lock:
            if self._partition is not None:
                return dict(self._partition)
        return {"verdict": "healthy", "side": self.live_ranks(),
                "lost": [], "reason": "no probe epoch yet"}

    def _update_gauge(self) -> None:
        if _tm.enabled():
            # journaled: the device-count history stays in the journal
            _tm.set_gauge("elastic.live_devices", len(self.live_ranks()),
                          journal=True)
            _tm.set_gauge("elastic.down_devices", len(self.down_ranks()),
                          journal=True)

    # -- re-layout ---------------------------------------------------------

    def shrink(self, domain: int | None = None) -> dict:
        """Re-lay-out every registered DArray touching a down rank onto
        the survivors.  Arrays whose data cannot be read (a REAL device
        loss) are left for the checkpoint-restore path and reported in
        ``"failed"``.

        ``domain``: first mark every rank of that failure domain down
        (``resilience.domains`` topology) and then shrink — the
        whole-host/whole-domain loss operation.  Survivor placement
        therefore excludes the dying domain entirely: re-layout can never
        seat a chunk (or, upstream, a peer replica) on a rank inside it.
        """
        if domain is not None:
            from . import domains as _dm
            for r in _dm.topology().domains()[int(domain)]:
                self.mark_down(r, reason=f"domain:{int(domain)}")
        down, arrays = self._agree("elastic_shrink")
        live = [r for r in self._expected_ranks() if r not in down]
        if not live:
            raise RuntimeError("elastic shrink: no live devices remain")
        moved, failed = 0, []
        if down:
            for d in arrays:
                if not ({int(p) for p in d.pids.flat} & down):
                    continue
                try:
                    if relayout(d, live):
                        moved += 1
                        with self._lock:
                            self._shrunk.add(d.id)
                except Exception as e:  # noqa: BLE001 — reported, not fatal
                    failed.append({"id": list(d.id),
                                   "error": f"{type(e).__name__}: {e}"})
        _tm.count("elastic.shrinks")
        if _tm.enabled():
            # cold path: one event per shrink epoch
            _tm.event("elastic", "shrink", live=len(live),
                      down=sorted(down), moved=moved, failed=len(failed))
            _tm.memory.sample("elastic.shrink")
        return {"live": live, "moved": moved, "failed": failed}

    def grow(self, domain: int | None = None) -> dict:
        """After revival: re-lay-out the arrays ``shrink()`` displaced
        back onto the (recovered) live set — and ONLY those.  Arrays the
        failure never touched keep the layout their owner chose.  A
        failed move is reported like shrink's, and the array stays
        marked so a later grow epoch retries it.

        ``domain``: first mark every rank of that failure domain back up
        (the inverse of ``shrink(domain=...)``), then grow."""
        if domain is not None:
            from . import domains as _dm
            for r in _dm.topology().domains()[int(domain)]:
                self.mark_up(r)
        down, arrays = self._agree("elastic_grow")
        live = [r for r in self._expected_ranks() if r not in down]
        # the shrink mark clears only once NO device is down: a grow
        # epoch during a partial revival (or with the device still down)
        # moves the array to the current live set but must keep it
        # marked, or the final revival would never re-grow it
        fully_recovered = not down
        with self._lock:
            shrunk = set(self._shrunk)
        moved, failed = 0, []
        for d in arrays:
            if d.id not in shrunk:
                continue
            try:
                if relayout(d, live):
                    moved += 1
                if fully_recovered:
                    with self._lock:
                        self._shrunk.discard(d.id)
            except Exception as e:  # noqa: BLE001 — reported, not fatal
                failed.append({"id": list(d.id),
                               "error": f"{type(e).__name__}: {e}"})
        # ids whose arrays died since the shrink have nothing to grow
        with self._lock:
            self._shrunk &= {d.id for d in _arrays()}
        _tm.count("elastic.grows")
        if _tm.enabled():
            # cold path: one event per grow epoch
            _tm.event("elastic", "grow", live=len(live),
                      moved=moved, failed=len(failed))
            _tm.memory.sample("elastic.grow")
        return {"live": live, "moved": moved, "failed": failed}

    def reset(self) -> None:
        """Forget every health mark and shrink record (tests / fresh
        sessions)."""
        with self._lock:
            self._manual_down.clear()
            self._sim_down.clear()
            self._hw_down.clear()
            self._peer_down.clear()
            self._shrunk.clear()
            self._partition = None
        self._update_gauge()


_manager: ElasticDeviceSet | None = None
_manager_lock = threading.Lock()


def manager() -> ElasticDeviceSet:
    """The process-wide elastic device-set manager."""
    global _manager
    if _manager is None:
        with _manager_lock:
            if _manager is None:
                _manager = ElasticDeviceSet()
    return _manager
