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
- ``Free``: the buffer freed or rewritten by the caller after the call;
- ``Write``: a checkpoint file of the process written and closed (a
  region ``(process, buffer, step)`` of the shared directory);
- ``Mark``: process 0 writes a step's metadata, the publish marker, which
  names every process's cell files of that step;
- ``Verify``: the process reads its own cell files of a step and checks
  their CRCs (``ok`` False: one of them is corrupt);
- ``Restore``: the process loads the newest step it verified that no
  verdict it knows of holds bad.

A ``Publish`` with ``verdicts`` is an exchange of the processes' verify
verdicts: passing it, every process knows every bad step.

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
  step adds no other ordering;
- ``tp_sample``: ``generate``'s sampling on the tp/dp layout in a job
  (``models.transformer._row_logits``): each decode step's row logits,
  which the tp all-gather wrote, copied by one region call
  (``multihost.exchange``, K10 across processes) from the process holding
  each row's first rank onto every process, which then draws every row
  from its copy; the call reports a region copy's events;
- ``chunked_publish``: a chunked checkpoint's save in a job
  (``utils.checkpoint._write_chunks``): each process writes its cell
  files, one exchange of their CRCs, process 0 writes the marker, a
  closing exchange;
- ``job_restore``: a restore in a job (``CheckpointManager.restore``
  and ``load``): the agreement on the steps every process lists, each
  process verifying its own cells of the newest, the verdicts exchanged,
  and the next step after a bad verdict (``job_restore`` has a corrupt
  cell of the newest step on the last process, ``job_restore_clean``
  none);
- ``job_shrink``: the Trainer's device-loss shrink in a job
  (``elastic.shrink``): the exchange of the down sets, then the region
  copy onto the survivors, the last process (whose rank was lost) holding
  no target and taking part in the publication and barriers only.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

__all__ = ["Launch", "Sync", "Publish", "Map", "Unmap", "Barrier", "Free",
           "Schedule", "SCHEDULES", "build", "events", "call_events",
           "CALL_SCHEDULES", "conform", "EVENT_KINDS", "record", "set_hook",
           "recording", "Write", "Mark", "Verify", "Restore"]

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
    verdicts: bool = False


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
class Write:
    """A file of the process, ``(process, buf, step)``, written and
    closed."""
    buf: str
    step: int
    ctx: bool = False


@dataclasses.dataclass(frozen=True)
class Mark:
    """Process 0's marker of ``step``: it names every process's ``buf``
    files of that step."""
    buf: str
    step: int
    ctx: bool = False


@dataclasses.dataclass(frozen=True)
class Verify:
    step: int
    ok: bool = True
    ctx: bool = False


@dataclasses.dataclass(frozen=True)
class Restore:
    """Load the newest of ``steps`` that the process verified and knows of
    no bad verdict for."""
    steps: tuple
    ctx: bool = False


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


def tp_sample_schedule(p: int) -> Schedule:
    """``generate``'s draw on the tp/dp layout across processes: the row
    logits (written by the launch before the call) copied into every
    process's rows, which its draws read after the call."""
    progs = []
    for me in range(p):
        progs.append(tuple(
            [Launch("produce", (), (((me, "logits", 0), ("logits", me)),),
                    ctx=True)]
            + _peer_call(me, p, "region", "logits", "rows", "all_gather")
            + [Launch("draw", (((me, "rows", 0), ("rows", me)),), ctx=True),
               Free("logits"), Free("rows")]))
    return Schedule("tp_sample", p, tuple(progs))


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


def chunked_publish_schedule(p: int) -> Schedule:
    """A chunked save in a job: every process writes its cells of step 1,
    the CRC exchange, process 0's marker, the closing exchange (modeled
    as the closing barrier)."""
    progs = []
    for me in range(p):
        prog: list = [Write("cells", 1), Publish("checkpoint")]
        if me == 0:
            prog.append(Mark("cells", 1))
        prog.append(Barrier("checkpoint", closing=True))
        progs.append(tuple(prog))
    return Schedule("chunked_publish", p, tuple(progs))


def job_restore_schedule(p: int, corrupt: bool = True) -> Schedule:
    """A restore in a job over steps 0 and 1, both published (the
    context): the step agreement, each process verifying its own cells of
    step 1 (the last process's corrupt when ``corrupt``), the verdict
    exchange, then (after a bad verdict, which process 0 quarantines
    behind a barrier) the same for step 0, the load and the closing
    barrier."""
    progs = []
    for me in range(p):
        prog: list = [Write("cells", 0, ctx=True), Write("cells", 1, ctx=True),
                      Barrier("saved", ctx=True)]
        if me == 0:
            prog += [Mark("cells", 0, ctx=True), Mark("cells", 1, ctx=True)]
        prog += [Barrier("published", ctx=True), Publish("checkpoint_restore"),
                 Verify(1, ok=not (corrupt and me == p - 1)),
                 Publish("checkpoint_verdict", verdicts=True)]
        if corrupt:
            prog += [Barrier("checkpoint_quarantine"), Verify(0),
                     Publish("checkpoint_verdict", verdicts=True)]
        prog += [Restore((1, 0)), Barrier("checkpoint_restore", closing=True)]
        progs.append(tuple(prog))
    return Schedule("job_restore" if corrupt else "job_restore_clean", p,
                    tuple(progs))


def job_shrink_schedule(p: int) -> Schedule:
    """The device-loss shrink in a job: the down-set exchange, then one
    region copy of the state onto the survivors (every process's cells,
    the lost rank's included, are read; the last process holds no target
    cell: it publishes its cells and passes the barrier only)."""
    progs = []
    for me in range(p):
        prog: list = [
            Launch("produce", (), (((me, "src", 0), ("src", me)),), ctx=True),
            Publish("elastic_shrink")]
        if me < p - 1:
            prog += _peer_call(me, p, "region", "src", "dst", "all_gather")
        else:
            prog += [Sync(), Publish("region", ("src",)), Sync(), Unmap(),
                     Barrier("region", closing=True)]
        progs.append(tuple(prog + [Free("src")]))
    return Schedule("job_shrink", p, tuple(progs))


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
    "tp_sample": tp_sample_schedule,
    "chunked_publish": chunked_publish_schedule,
    "job_restore": job_restore_schedule,
    "job_restore_clean": lambda p: job_restore_schedule(p, corrupt=False),
    "job_shrink": job_shrink_schedule,
}


def build(name: str, p: int) -> Schedule:
    """The named protocol's schedule on ``p`` processes."""
    return SCHEDULES[name](p)


# ---------------------------------------------------------------------------
# the events the code reports, and the hook
# ---------------------------------------------------------------------------

EVENT_KINDS = ("sync", "publish", "map", "launch", "unmap", "barrier",
               "write", "mark", "verify", "restore")


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
    if isinstance(ins, (Write, Mark, Verify, Restore)):
        return type(ins).__name__.lower()
    return None


def call_events(seq, idle: bool = False) -> list[str]:
    """An event sequence in the form the checks compare: consecutive maps
    as one ``map`` (the code maps an allocation once however many chunks
    it holds), consecutive launches as one (a copy call of many pieces
    may take several launches) and consecutive file writes as one; with
    ``idle`` without the maps, launches, writes and stream syncs (a
    process that holds no rank of a call publishes and passes the
    barriers only)."""
    out: list[str] = []
    for e in seq:
        if idle and e in _BUSY:
            continue
        if e in ("map", "launch", "write") and out and out[-1] == e:
            continue
        out.append(e)
    return out


def events(sched: Schedule, proc: int, idle: bool = False) -> list[str]:
    """Process ``proc``'s program as the events the code reports: the
    call's instructions, not its context (``call_events``' form)."""
    return call_events([e for e in map(_event, sched.programs[proc])
                        if e is not None], idle)


# what a process that holds no rank of a call does not do
_BUSY = ("map", "launch", "sync", "write")

# the protocol of a call, by its publication's tag
CALL_SCHEDULES = {"region": "region_copy",
                  "reduce_scatter": "reduce_scatter",
                  "ring_gemm": "ring_allgather_matmul",
                  "ring_attention": "ring_attention",
                  "checkpoint": "chunked_publish",
                  "checkpoint_restore": "job_restore_clean"}
# a call that may also follow another schedule: a restore that met a
# corrupt step and took the one before it
CALL_ALTERNATIVES = {"checkpoint_restore": ("job_restore",)}


def conform(recorded: list[str], p: int, proc: int = 0) -> list[str]:
    """The mismatches between process ``proc``'s recorded events
    (``recording``) and the schedules: the sequence cut into calls at
    their closing barriers, each call held against its schedule's program
    of ``proc`` at ``p`` processes (by its publication's tag), in full,
    or in the idle form where the call launched, mapped and wrote
    nothing.  Events outside any call (other barriers) are skipped."""
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
        # the call's entry syncs (and a save's file writes) come just
        # before its publication
        while start and call[start - 1] in ("sync", "write"):
            start -= 1
        seg = call[start:]
        sched = build(CALL_SCHEDULES[name], p)
        # a call with no launch, mapping or write is a process's idle part
        idle = not any(x in ("launch", "map", "write") for x in seg)
        if all(call_events(seg, idle) != events(build(alt, p), proc, idle)
               for alt in (sched.name,) + CALL_ALTERNATIVES.get(name, ())):
            bad.append(f"{name} call {call_events(seg)} != schedule "
                       f"{sched.name} {events(sched, proc, idle)}")
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
