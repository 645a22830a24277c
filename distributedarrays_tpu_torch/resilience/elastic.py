"""Elastic device sets: shrink onto survivors, grow back on revival.

PyTorch counterpart of ``distributedarrays_tpu/resilience/elastic.py``
(its whole ``__all__``): a health ledger over the ranks of the rank table,
and a re-layout engine that moves every registered DArray
(``core.live_arrays()``) onto the live ranks through the port's reshard.

- :func:`manager` is the process-wide :class:`ElasticDeviceSet`;
  ``mark_down`` / ``mark_up`` are explicit health edits.
- ``probe()`` is one health epoch: the real signal (a rank is down when the
  CUDA device it sits on is no longer enumerated by torch, or every CUDA
  rank when torch cannot count the devices; ``DA_TPU_ELASTIC_HW_PROBE=0``
  turns this half off, ``DA_TPU_ELASTIC_ACTIVE_PROBE=1`` adds a one-element
  round trip per device), merged with the manual marks and the fault
  harness's simulated-down set (``faults.probe_tick``, where simulated
  devices revive), the ``elastic.live_devices`` gauge and the quorum
  verdict (:func:`quorum_assess`).
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
- ``grow()`` moves back only the arrays ``shrink()`` displaced.

A simulated-down rank still answers reads, so ``shrink`` keeps the data.
The multi-host half (peer heartbeats, the heartbeat census of the quorum
rule) waits for ``parallel/multihost.py``; until then the port behaves as
JAX does when multihost was never initialised: no peer is stale.
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
from . import faults

__all__ = ["ElasticDeviceSet", "manager", "relayout", "quorum_assess"]


def _moved_parts(d, pids: np.ndarray, cuts) -> np.ndarray:
    """``d``'s cells on the layout ``(pids, cuts)``, tensors ``d`` does not
    share: the planned reshard when the layout divides every dim, else the
    gather onto its ranks and each rank's window."""
    from ..parallel import reshard as _rs
    if all((c[-1] % (len(c) - 1)) == 0 for c in cuts):
        return _rs.relayout_parts(d, pids, cuts, op="elastic")
    use = [int(p) for p in pids.flat]
    whole = dict(zip(use, _rs.allgather(d, use, op="elastic")))
    parts = np.empty(tuple(pids.shape), dtype=object)
    for ci in np.ndindex(*pids.shape):
        sl = tuple(slice(c[j], c[j + 1]) for c, j in zip(cuts, ci))
        parts[ci] = whole[int(pids[ci])][sl].clone()
    return parts


def relayout(d, ranks: list[int]) -> bool:
    """Re-lay DArray ``d`` onto ``ranks`` (its default layout there) in
    place (JAX ``elastic.py:67``).  Returns True when it moved, False when
    it already has that layout.  The new tensors are built before any
    metadata changes, so a failed move leaves ``d`` as it was."""
    ranks = [int(r) for r in ranks]
    if not ranks:
        raise ValueError("cannot re-lay-out onto an empty device set")
    dims = tuple(d.dims)
    grid = tuple(int(c) for c in L.defaultdist(dims, ranks))
    need = int(np.prod(grid)) if grid else 1
    use = ranks[:need]
    idxs, cuts = L.chunk_idxs(dims, grid)
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


def quorum_assess() -> dict:
    """This controller's partition verdict (JAX ``multihost.quorum_assess``,
    its single-controller half): an armed ``partition`` fault's state
    decides through ``domains.majority_side``; without one there is no
    partition evidence (no peer heartbeats yet) and the verdict is
    healthy."""
    from . import domains as _dom
    expected = _dom.topology().ranks()
    st = faults.partition_state()
    if st is not None:
        q = _dom.majority_side(st["groups"], st["observer"],
                               expected_total=len(expected))
        out = {**q, "reason": "injected partition (fault plan)"}
    else:
        out = {"verdict": "healthy", "side": list(expected), "lost": [],
               "reason": "no partition evidence"}
    _tm.count("multihost.quorum_checks", verdict=out["verdict"])
    if out["verdict"] != "healthy" and _tm.enabled():
        # cold path: only journaled while partitioned
        _tm.event("multihost", "quorum", verdict=out["verdict"],
                  side=len(out["side"]), lost=len(out["lost"]),
                  reason=out["reason"])
    return out


class ElasticDeviceSet:
    """Health ledger over the device ranks plus the re-layout engine."""

    def __init__(self):
        self._lock = threading.RLock()
        self._manual_down: dict[int, float] = {}    # rank -> since (mono)
        self._sim_down: set[int] = set()
        self._hw_down: set[int] = set()             # REAL-signal probe
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

    def down_ranks(self) -> set[int]:
        with self._lock:
            return (set(self._manual_down) | set(self._sim_down)
                    | set(self._hw_down))

    def live_ranks(self) -> list[int]:
        down = self.down_ranks()
        return [r for r in self._expected_ranks() if r not in down]

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
        trip to each rank's device.  CPU ranks never go down here.
        ``DA_TPU_ELASTIC_HW_PROBE=0`` disables it."""
        if os.environ.get("DA_TPU_ELASTIC_HW_PROBE", "1") == "0":
            return set()
        expected = self._expected_ranks()
        cuda = {r: L.device_of(r) for r in expected
                if L.device_of(r).type == "cuda"}
        if not cuda:
            return set()
        try:
            count = torch.cuda.device_count()
        except Exception:
            return set(cuda)
        down = {r for r, dev in cuda.items() if dev.index >= count}
        if os.environ.get("DA_TPU_ELASTIC_ACTIVE_PROBE") == "1":
            for r, dev in cuda.items():  # pragma: no cover - opt-in
                if r in down:
                    continue
                try:
                    torch.zeros(1, device=dev).cpu()
                except Exception:
                    down.add(r)
        return down

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
            part = quorum_assess()
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
        down = self.down_ranks()
        live = self.live_ranks()
        if not live:
            raise RuntimeError("elastic shrink: no live devices remain")
        moved, failed = 0, []
        if down:
            for d in _arrays():
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
        live = self.live_ranks()
        # the shrink mark clears only once NO device is down: a grow
        # epoch during a partial revival (or with the device still down)
        # moves the array to the current live set but must keep it
        # marked, or the final revival would never re-grow it
        fully_recovered = not self.down_ranks()
        with self._lock:
            shrunk = set(self._shrunk)
        moved, failed = 0, []
        for d in _arrays():
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
