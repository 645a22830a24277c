"""Declarative per-process programs of the port's cross-process protocols.

PyTorch counterpart of ``distributedarrays_tpu/ops/ring_schedules.py``.
JAX's schedules describe Pallas RDMA kernels (DMA starts, semaphores,
credits); the port has none of those.  Its calls across controller
processes are host-driven launches that read or write peer processes'
allocations through CUDA IPC, ordered by stream syncs and the job store's
barriers.  This module describes each such protocol as pure data, one
straight-line program per process (a process holds one rank), over these
events:

- ``Launch``: an asynchronous kernel launch that reads and writes regions
  (a buffer of a process, and a slot of it); it completes some time
  before the launching process's next ``Sync``;
- ``Sync``: a stream sync (``torch.cuda.synchronize``): every launch of
  the process has completed;
- ``Publish``: the handle publication (``multihost._all_gather_json``):
  the process publishes its buffers' IPC handles and waits until every
  process has published under the same tag;
- ``Map``/``Unmap``: a peer allocation mapped (``cuda_collectives._Mapped.
  base``) and every mapping of the call closed (``_Mapped.close``);
- ``Barrier``: the store barrier ``multihost.sync_hosts(name)``, matched
  across processes by its name and the count of that name so far, as the
  store keys it; ``closing`` marks a call's last barrier;
- ``Free``: the buffer freed or rewritten by the caller after the call.

Instructions marked ``ctx`` are the context of a call (the launch that
wrote its input before it, the frees after it), not events of the call
itself.  ``events(schedule, proc)`` is a program in the vocabulary that
the code reports at run time (``record``, the hook): ``sync``,
``publish:<tag>``, ``map``, ``launch``, ``unmap``, ``barrier:<name>``.
``analysis.protocol`` explores every interleaving of the programs.

The protocols (``SCHEDULES``):

- ``region_copy``: ``cuda_collectives.process_regions`` (K10/K11 across
  processes: the GEMM's panels, the reshard, ``gather_global``, the
  rank-list collectives in a job), a ``peer_call``;
- ``reduce_scatter``: K12's ``cross_process`` route
  (``cuda_collectives._reduce_scatter_job``), a ``peer_call``;
- ``ring_allgather_matmul`` and ``ring_allgather_matmul_rhs`` (K13, K14:
  ``_Ring`` with ``to = -1``), ``ring_matmul_reducescatter`` (K15,
  ``to = +1``) and ``ring_attention`` (K9, ``models/ring_attention.py``
  ``_ring_rdma_job``): two slots a rank, each step's forward stored into
  the neighbour process's slot, a stream sync and a step barrier after
  each step but the last;
- ``tp_allreduce``: the tp/dp step's all-reduce (``models.tp_dp.
  allreduce``), a K12 call whose output a K10 call then publishes; the
  step adds no other ordering.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

__all__ = ["Launch", "Sync", "Publish", "Map", "Unmap", "Barrier", "Free",
           "Schedule", "SCHEDULES", "build", "events", "call_events",
           "CALL_SCHEDULES", "conform", "EVENT_KINDS", "record", "set_hook",
           "recording"]

@dataclasses.dataclass(frozen=True)
class Launch:
    """A kernel launch: ``reads`` are ``(region, expected token)`` pairs,
    ``writes`` ``(region, token)`` pairs; a region is ``(owner process,
    buffer name, slot)``."""
    kernel: str
    reads: tuple = ()
    writes: tuple = ()
    ctx: bool = False


@dataclasses.dataclass(frozen=True)
class Sync:
    ctx: bool = False


@dataclasses.dataclass(frozen=True)
class Publish:
    tag: str
    bufs: tuple = ()
    ctx: bool = False


@dataclasses.dataclass(frozen=True)
class Map:
    owner: int
    buf: str
    ctx: bool = False


@dataclasses.dataclass(frozen=True)
class Unmap:
    ctx: bool = False


@dataclasses.dataclass(frozen=True)
class Barrier:
    name: str
    closing: bool = False
    ctx: bool = False


@dataclasses.dataclass(frozen=True)
class Free:
    buf: str
    ctx: bool = True


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A protocol on ``p`` processes: ``programs[q]`` is process q's
    instructions."""
    name: str
    p: int
    programs: tuple


# ---------------------------------------------------------------------------
# the schedules
# ---------------------------------------------------------------------------


def _peer_call(me: int, p: int, tag: str, src: str, dst: str,
               kernel: str) -> list:
    """One ``peer_call`` whose launch reads every process q's ``src`` (its
    own included; a piece of it) into this process's ``dst``: the entry
    sync, the publication, a mapping a peer, the launch, the exit sync,
    the unmap and the closing barrier."""
    prog: list = [Sync(), Publish(tag, (src,))]
    prog += [Map(q, src) for q in range(p) if q != me]
    prog.append(Launch(kernel, tuple(((q, src, 0), (src, q))
                                     for q in range(p)),
                       (((me, dst, 0), (dst, me)),)))
    prog += [Sync(), Unmap(), Barrier(tag, closing=True)]
    return prog


def region_copy_schedule(p: int) -> Schedule:
    """``process_regions``: every process's chunk (written by the launch
    before the call) copied into every process's destination."""
    progs = []
    for me in range(p):
        progs.append(tuple(
            [Launch("produce", (), (((me, "src", 0), ("src", me)),),
                    ctx=True)]
            + _peer_call(me, p, "region", "src", "dst", "all_gather")
            + [Free("src")]))
    return Schedule("region_copy", p, tuple(progs))


def reduce_scatter_schedule(p: int) -> Schedule:
    """K12 across processes: process d's launch folds piece d of every
    process's block."""
    progs = []
    for me in range(p):
        progs.append(tuple(
            [Launch("produce", (), (((me, "block", 0), ("block", me)),),
                    ctx=True)]
            + _peer_call(me, p, "reduce_scatter", "block", "out",
                         "reduce_scatter")
            + [Free("block")]))
    return Schedule("reduce_scatter", p, tuple(progs))


def tp_allreduce_schedule(p: int) -> Schedule:
    """``tp_dp.allreduce`` across processes: K12's call, then K10's on its
    outputs (the launch that wrote a process's piece is synced before its
    handle is published)."""
    progs = []
    for me in range(p):
        k12 = _peer_call(me, p, "reduce_scatter", "block", "piece",
                         "reduce_scatter")
        k10 = _peer_call(me, p, "region", "piece", "whole", "all_gather")
        # K10 reads the pieces K12 wrote: their token is ("piece", q)
        progs.append(tuple(
            [Launch("produce", (), (((me, "block", 0), ("block", me)),),
                    ctx=True)] + k12 + k10 + [Free("block"), Free("piece")]))
    return Schedule("tp_allreduce", p, tuple(progs))


def ring_schedule(name: str, p: int, to: int, tag: str,
                  out: bool = False) -> Schedule:
    """A two-slot ring (``_Ring``, K9): process r's step t reads its input
    (t = 0) or its own slot t % 2, and stores the chunk it forwards into
    slot (t + 1) % 2 of process r + ``to`` (t < p - 1); with ``out`` the
    last step writes the process's own output instead (K15's partial).
    A stream sync after every step, the step barrier after every step but
    the last, then ``peer_call``'s exit: sync, unmap, closing barrier."""
    progs = []
    for me in range(p):
        nb = (me + to) % p
        prog: list = [
            Launch("produce", (), (((me, "x", 0), ("x", me, 0)),), ctx=True),
            Sync(), Publish(tag, ("slots",))]
        for t in range(p):
            held = (me - to * t) % p       # the chunk it holds at step t
            reads = (((me, "x", 0), ("x", me, 0)),) if t == 0 else \
                (((me, "slots", t % 2), ("x", held, t)),)
            if t < p - 1:
                if t == 0:
                    prog.append(Map(nb, "slots"))
                writes = (((nb, "slots", (t + 1) % 2), ("x", held, t + 1)),)
            else:
                writes = (((me, "out", 0), ("out", me)),) if out else ()
            prog += [Launch(f"step {t}", reads, writes), Sync()]
            if t < p - 1:
                prog.append(Barrier(f"{tag}_step"))
        prog += [Sync(), Unmap(), Barrier(tag, closing=True), Free("slots")]
        progs.append(tuple(prog))
    return Schedule(name, p, tuple(progs))


SCHEDULES: dict[str, Callable[[int], Schedule]] = {
    "region_copy": region_copy_schedule,
    "reduce_scatter": reduce_scatter_schedule,
    "ring_allgather_matmul": lambda p: ring_schedule(
        "ring_allgather_matmul", p, -1, "ring_gemm"),
    "ring_allgather_matmul_rhs": lambda p: ring_schedule(
        "ring_allgather_matmul_rhs", p, -1, "ring_gemm"),
    "ring_matmul_reducescatter": lambda p: ring_schedule(
        "ring_matmul_reducescatter", p, 1, "ring_gemm", out=True),
    "ring_attention": lambda p: ring_schedule(
        "ring_attention", p, 1, "ring_attention", out=True),
    "tp_allreduce": tp_allreduce_schedule,
}


def build(name: str, p: int) -> Schedule:
    """The named protocol's schedule on ``p`` processes."""
    return SCHEDULES[name](p)


# ---------------------------------------------------------------------------
# the events the code reports, and the hook
# ---------------------------------------------------------------------------

EVENT_KINDS = ("sync", "publish", "map", "launch", "unmap", "barrier")


def _event(ins) -> str | None:
    if getattr(ins, "ctx", False):
        return None
    if isinstance(ins, Sync):
        return "sync"
    if isinstance(ins, Publish):
        return f"publish:{ins.tag}"
    if isinstance(ins, Map):
        return "map"
    if isinstance(ins, Launch):
        return "launch"
    if isinstance(ins, Unmap):
        return "unmap"
    if isinstance(ins, Barrier):
        return f"barrier:{ins.name}"
    return None


def call_events(seq, idle: bool = False) -> list[str]:
    """An event sequence in the form the checks compare: consecutive maps
    as one ``map`` (the code maps an allocation once however many chunks
    it holds) and consecutive launches as one (a copy call of many pieces
    may take several launches); with ``idle`` without the maps, launches
    and stream syncs (a process that holds no rank of a call publishes
    and passes the barriers only)."""
    out: list[str] = []
    for e in seq:
        if idle and e in ("map", "launch", "sync"):
            continue
        if e in ("map", "launch") and out and out[-1] == e:
            continue
        out.append(e)
    return out


def events(sched: Schedule, proc: int, idle: bool = False) -> list[str]:
    """Process ``proc``'s program as the events the code reports: the
    call's instructions, not its context (``call_events``' form)."""
    return call_events([e for e in map(_event, sched.programs[proc])
                        if e is not None], idle)


# the protocol of a call, by its publication's tag
CALL_SCHEDULES = {"region": "region_copy",
                  "reduce_scatter": "reduce_scatter",
                  "ring_gemm": "ring_allgather_matmul",
                  "ring_attention": "ring_attention"}


def conform(recorded: list[str], p: int) -> list[str]:
    """The mismatches between a process's recorded events (``recording``)
    and the schedules: the sequence cut into calls at their closing
    barriers, each call held against its schedule's program at ``p``
    processes (by its publication's tag), in full, or in the idle form
    where the call launched and mapped nothing.  Events outside any call
    (other barriers) are skipped."""
    bad: list[str] = []
    call: list[str] = []
    for e in recorded:
        call.append(e)
        kind, _, name = e.partition(":")
        if kind != "barrier" or name not in CALL_SCHEDULES:
            continue
        tags = [x.partition(":")[2] for x in call if x.startswith("publish")]
        if name not in tags:
            bad.append(f"closing barrier {name} without its publication")
            call = []
            continue
        start = max(i for i, x in enumerate(call) if x == f"publish:{name}")
        # the call's entry syncs come just before its publication
        while start and call[start - 1] == "sync":
            start -= 1
        seg = call[start:]
        sched = build(CALL_SCHEDULES[name], p)
        # a call with no launch and no mapping is a process's idle part
        idle = not any(x in ("launch", "map") for x in seg)
        if call_events(seg, idle) != events(sched, 0, idle):
            bad.append(f"{name} call {call_events(seg)} != schedule "
                       f"{sched.name} {events(sched, 0, idle)}")
        call = []
    return bad


_hook: Callable[[str], None] | None = None


def set_hook(fn: Callable[[str], None] | None) -> None:
    """Install (or with None remove) the function that receives every
    protocol event the code reports."""
    global _hook
    _hook = fn


def record(kind: str, name: str = "") -> None:
    """Report one event (``EVENT_KINDS``; ``name`` the publication tag or
    the barrier's name) to the hook; nothing when none is set."""
    if _hook is not None:
        _hook(f"{kind}:{name}" if name else kind)


class recording:
    """``with recording() as seen:`` collects the events reported inside
    the block into the list ``seen``."""

    def __enter__(self) -> list[str]:
        self.seen: list[str] = []
        self._prev = _hook
        set_hook(self.seen.append)
        return self.seen

    def __exit__(self, *exc) -> None:
        set_hook(self._prev)
