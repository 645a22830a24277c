"""Explicit-state model checker for the port's cross-process protocols.

PyTorch counterpart of ``distributedarrays_tpu/analysis/protocol.py``.  JAX
checks its Pallas RDMA schedules (semaphores, credits); the port's calls
across controller processes are host-driven instead: launches that read
or write peer allocations through CUDA IPC, stream syncs, the handle
publication and the job store's barriers (``ops/ring_schedules.py``
describes each protocol as one program a process).  This module runs the
programs under every interleaving of the processes and proves, for each
schedule:

- **(a) mappings**: every mapping is closed before the call's closing
  barrier, no launch reads or writes a peer allocation that its process
  has not mapped or has already unmapped while the launch runs, and no
  mapping is open when a process's program ends;
- **(b) slots**: no launch reads a region before the store into it has
  completed (the token it expects is there) and no launch reads or
  writes a region while another process's launch stores into it, nor
  overwrites one another process's launch may still read (the two-slot
  reuse);
- **(c) barriers**: every process passes the same barriers (a barrier is
  matched by its name and the count of that name so far, as the store
  keys it), so no reachable state leaves a process waiting on a barrier
  or publication that the others never reach (a deadlock is reported);
- **(d) publication**: a process publishes a buffer's handle only after a
  stream sync of every launch that writes it;
- **(e) lifetime**: no process frees or rewrites a buffer while a peer
  may still have it mapped or a peer's launch may still read it, and no
  launch or mapping touches a freed buffer.

Semantics.  A launch completes at some point before its process's next
stream sync; the checker completes it at that sync (or at the program's
end), the latest point, which keeps its window in flight longest: a
violation that an earlier completion would show is shown by the latest
one as well.  The launches of one process run in stream order, so a
launch sees its own process's earlier stores.  Barriers and publications
pass when every process has arrived at the same instance.

Exploration.  Depth-first over the processes' steps with memoized
states.  A process's next step is taken alone (a persistent set) when
it touches nothing that any other process can touch before that other
process's next barrier or publication, which it cannot pass until this
process arrives there too; otherwise every process's next step is a
branch.  A run that visits more than ``max_states`` distinct states is a
failure (``state-budget``), never a pass.

The **mutation harness** (``MUTATIONS``, ``mutate``) seeds one bug class
each invariant exists for, and ``verify_protocols`` requires the checker
to refute every applicable mutant with a printed interleaving
counterexample.
"""

from __future__ import annotations

import dataclasses
import sys

from ..ops import ring_schedules as _rs

__all__ = ["CheckResult", "check_schedule", "mutate", "MUTATIONS",
           "verify_protocols", "format_report", "KERNEL_NAMES",
           "DEFAULT_PS", "DEFAULT_MAX_STATES", "INVARIANTS"]

KERNEL_NAMES = tuple(_rs.SCHEDULES)
DEFAULT_PS = (2, 3, 4, 8)
DEFAULT_MAX_STATES = 200_000
MUTANT_P = 4

# violation kind -> the invariant it breaks
INVARIANTS = {"mapping": "a", "slot": "b", "barrier": "c",
              "publication": "d", "lifetime": "e"}


@dataclasses.dataclass
class CheckResult:
    """One schedule's verdict at ``p`` processes.  ``ok`` means every
    interleaving kept every invariant; otherwise ``kind``/``detail`` name
    the violation and ``counterexample`` is the interleaving that reached
    it, one line a step.  ``states`` counts the distinct states."""

    name: str
    p: int
    ok: bool
    kind: str | None = None
    detail: str = ""
    counterexample: list = dataclasses.field(default_factory=list)
    states: int = 0
    mutation: str | None = None


class _Violation(Exception):
    def __init__(self, kind: str, detail: str):
        super().__init__(detail)
        self.kind, self.detail = kind, detail


class _Budget(Exception):
    pass


def _fmt_region(r) -> str:
    return f"p{r[0]}.{r[1]}[{r[2]}]"


def _fmt(q: int, ins) -> str:
    if isinstance(ins, _rs.Launch):
        rd = ", ".join(_fmt_region(r) for r, _ in ins.reads) or "-"
        wr = ", ".join(_fmt_region(r) for r, _ in ins.writes) or "-"
        return f"process {q}: launch {ins.kernel} (reads {rd}; writes {wr})"
    if isinstance(ins, _rs.Sync):
        return f"process {q}: stream sync"
    if isinstance(ins, _rs.Publish):
        return f"process {q}: publish {ins.tag} {list(ins.bufs)}"
    if isinstance(ins, _rs.Map):
        return f"process {q}: map p{ins.owner}.{ins.buf}"
    if isinstance(ins, _rs.Unmap):
        return f"process {q}: unmap"
    if isinstance(ins, _rs.Barrier):
        return f"process {q}: barrier {ins.name}"
    if isinstance(ins, _rs.Free):
        return f"process {q}: free {ins.buf}"
    return f"process {q}: {ins}"


def _collective(ins) -> bool:
    return isinstance(ins, (_rs.Barrier, _rs.Publish))


class _Model:
    """The programs of one schedule and the static data the search
    reads: each collective's instance key, and each process's footprint
    from a position to its next collective."""

    def __init__(self, sched: _rs.Schedule):
        self.p = sched.p
        self.progs = sched.programs
        self.keys = []
        for prog in self.progs:
            seen: dict = {}
            keys = []
            for ins in prog:
                if _collective(ins):
                    k = (type(ins).__name__,
                         ins.name if isinstance(ins, _rs.Barrier)
                         else ins.tag)
                    keys.append(k + (seen.get(k, 0),))
                    seen[k] = seen.get(k, 0) + 1
                else:
                    keys.append(None)
            self.keys.append(keys)

    # -- footprints -------------------------------------------------------

    def atoms(self, q: int, ins, pend, maps) -> set:
        """The shared objects instruction ``ins`` of process ``q`` touches
        (``pend``: its launches in flight, ``maps``: its mappings)."""
        out: set = set()
        if isinstance(ins, _rs.Launch):
            for r, _ in ins.reads:
                out.add(("r", r))
                out.add(("b", r[0], r[1]))
            for r, _ in ins.writes:
                out.add(("w", r))
                out.add(("b", r[0], r[1]))
        elif isinstance(ins, _rs.Sync):
            for pc in pend:
                out |= self.atoms(q, self.progs[q][pc], (), ())
        elif isinstance(ins, _rs.Map):
            out.add(("m", ins.owner, ins.buf))
        elif isinstance(ins, _rs.Unmap):
            out |= {("m", o, b) for o, b in maps}
        elif isinstance(ins, _rs.Free):
            out.add(("f", q, ins.buf))
        return out

    def lookahead(self, q: int, pc: int, pend, maps) -> set:
        """Everything process ``q`` can touch from ``pc`` before its next
        collective."""
        out: set = set()
        pend, maps = list(pend), set(maps)
        prog = self.progs[q]
        while pc < len(prog) and not _collective(prog[pc]):
            ins = prog[pc]
            out |= self.atoms(q, ins, pend, maps)
            if isinstance(ins, _rs.Launch):
                pend.append(pc)
            elif isinstance(ins, _rs.Sync):
                pend = []
            elif isinstance(ins, _rs.Map):
                maps.add((ins.owner, ins.buf))
            pc += 1
        if pc >= len(prog):            # the end completes what is in flight
            for x in pend:
                out |= self.atoms(q, prog[x], (), ())
        return out


_CONFLICTS = {"w": ("w", "r"), "r": ("w",), "b": ("f",), "f": ("b", "m"),
              "m": ("f",)}


def _conflict(a: set, b: set) -> bool:
    for atom in a:
        for other in _CONFLICTS[atom[0]]:
            if (other,) + atom[1:] in b:
                return True
    return False


class _State:
    __slots__ = ("pcs", "pend", "tok", "freed", "maps")

    def __init__(self, p):
        self.pcs = [0] * p
        self.pend = [()] * p
        self.tok: dict = {}
        self.freed: frozenset = frozenset()
        self.maps = [frozenset()] * p

    def copy(self):
        s = _State.__new__(_State)
        s.pcs, s.pend, s.tok = list(self.pcs), list(self.pend), dict(self.tok)
        s.freed, s.maps = self.freed, list(self.maps)
        return s

    def key(self):
        return (tuple(self.pcs), tuple(self.pend),
                frozenset(self.tok.items()), self.freed, tuple(self.maps))


def _explore(model: _Model, max_states: int, por: bool) -> int:
    """Search every interleaving (with ``por``, one process's step alone
    where it is a persistent set); returns the state count, raises
    ``_Violation`` (with the path in its ``trace``) or ``_Budget``."""
    progs, p = model.progs, model.p
    seen: set = set()
    path: list[str] = []

    def launch_checks(s, q, ins):
        for r, expect in ins.reads:
            _access(s, q, r, "read")
            for j in range(p):
                if j != q and any(r in dict(progs[j][x].writes)
                                  for x in s.pend[j]):
                    raise _Violation("slot", f"process {q} reads "
                                     f"{_fmt_region(r)} while process {j}'s "
                                     f"store into it is in flight")
            got = s.tok.get(r)
            for x in s.pend[q]:          # its own stores, in stream order
                got = dict(progs[q][x].writes).get(r, got)
            if got != expect:
                raise _Violation("slot", f"process {q} reads "
                                 f"{_fmt_region(r)} holding "
                                 f"{got or '<unwritten>'}, expects {expect}"
                                 " (read before the store into it landed)")
        for r, _ in ins.writes:
            _access(s, q, r, "write")
            for j in range(p):
                if j == q:
                    continue
                for x in s.pend[j]:
                    other = progs[j][x]
                    if r in dict(other.reads):
                        raise _Violation("slot", f"process {q} overwrites "
                                         f"{_fmt_region(r)} while process "
                                         f"{j} may still read it")
                    if r in dict(other.writes):
                        raise _Violation("slot", f"processes {q} and {j} "
                                         f"store into {_fmt_region(r)} at "
                                         "once")

    def _access(s, q, r, how):
        owner, buf = r[0], r[1]
        if (owner, buf) in s.freed:
            raise _Violation("lifetime", f"process {q} {how}s "
                             f"{_fmt_region(r)} after process {owner} "
                             "freed it")
        if owner != q and (owner, buf) not in s.maps[q]:
            raise _Violation("mapping", f"process {q} {how}s "
                             f"{_fmt_region(r)} through no open mapping")

    def land(s, q):
        for x in s.pend[q]:
            for r, t in progs[q][x].writes:
                s.tok[r] = t
        s.pend[q] = ()

    def arrive(s, q):
        """The checks of process q reaching its next instruction."""
        prog = progs[q]
        pc = s.pcs[q]
        if pc >= len(prog):
            land(s, q)
            if s.maps[q]:
                raise _Violation("mapping", f"process {q} ends with "
                                 f"{sorted(s.maps[q])} still mapped")
            return
        ins = prog[pc]
        if isinstance(ins, _rs.Barrier) and ins.closing and s.maps[q]:
            raise _Violation("mapping", f"process {q} reaches the closing "
                             f"barrier {ins.name} with "
                             f"{sorted(s.maps[q])} still mapped")
        if isinstance(ins, _rs.Publish):
            for x in s.pend[q]:
                for r, _ in progs[q][x].writes:
                    if r[0] == q and r[1] in ins.bufs:
                        raise _Violation(
                            "publication", f"process {q} publishes "
                            f"{r[1]} while its launch "
                            f"{progs[q][x].kernel} writing it is in flight "
                            "(no stream sync before the publication)")

    def step(s, q):
        ins = progs[q][s.pcs[q]]
        if isinstance(ins, _rs.Launch):
            launch_checks(s, q, ins)
            s.pend[q] = s.pend[q] + (s.pcs[q],)
        elif isinstance(ins, _rs.Sync):
            land(s, q)
        elif isinstance(ins, _rs.Map):
            if (ins.owner, ins.buf) in s.freed:
                raise _Violation("lifetime", f"process {q} maps "
                                 f"p{ins.owner}.{ins.buf} after it was freed")
            s.maps[q] = s.maps[q] | {(ins.owner, ins.buf)}
        elif isinstance(ins, _rs.Unmap):
            for x in s.pend[q]:
                l = progs[q][x]
                for r, _ in l.reads + l.writes:
                    if r[0] != q:
                        raise _Violation("mapping", f"process {q} unmaps "
                                         f"p{r[0]}.{r[1]} while its launch "
                                         f"{l.kernel} through it is in "
                                         "flight")
            s.maps[q] = frozenset()
        elif isinstance(ins, _rs.Free):
            for j in range(p):
                if j == q:
                    continue
                if (q, ins.buf) in s.maps[j]:
                    raise _Violation("lifetime", f"process {q} frees "
                                     f"{ins.buf} while process {j} still "
                                     "maps it")
                for x in s.pend[j]:
                    l = progs[j][x]
                    if any(r[0] == q and r[1] == ins.buf
                           for r, _ in l.reads + l.writes):
                        raise _Violation("lifetime", f"process {q} frees "
                                         f"{ins.buf} while process {j}'s "
                                         f"launch {l.kernel} may still "
                                         "read it")
            s.freed = s.freed | {(q, ins.buf)}
        s.pcs[q] += 1
        arrive(s, q)

    def successors(s):
        runnable = [q for q in range(p) if s.pcs[q] < len(progs[q])
                    and not _collective(progs[q][s.pcs[q]])]
        if not runnable:
            return None
        if por and len(runnable) > 1:
            look = {j: model.lookahead(j, s.pcs[j], s.pend[j], s.maps[j])
                    for j in range(p) if s.pcs[j] < len(progs[j])}
            for q in runnable:
                mine = model.atoms(q, progs[q][s.pcs[q]], s.pend[q],
                                   s.maps[q])
                if not any(_conflict(mine, a) for j, a in look.items()
                           if j != q):
                    return [q]
        return runnable

    def visit(s):
        k = s.key()
        if k in seen:
            return
        seen.add(k)
        if len(seen) > max_states:
            raise _Budget
        qs = successors(s)
        if qs is None:
            live = [q for q in range(p) if s.pcs[q] < len(progs[q])]
            if not live:
                return
            keys = {model.keys[q][s.pcs[q]] for q in range(p)
                    if s.pcs[q] < len(progs[q])}
            if len(live) == p and len(keys) == 1:
                key = keys.pop()
                path.append(f"all processes pass {key[0].lower()} "
                            f"{key[1]} #{key[2]}")
                t = s.copy()
                for q in range(p):
                    t.pcs[q] += 1
                try:
                    for q in range(p):
                        arrive(t, q)
                    visit(t)
                except _Violation as v:
                    _trace(v)
                    raise
                finally:
                    path.pop()
                return
            waits = "; ".join(
                f"process {q} " + (
                    f"at {model.keys[q][s.pcs[q]][0].lower()} "
                    f"{model.keys[q][s.pcs[q]][1]} "
                    f"#{model.keys[q][s.pcs[q]][2]}"
                    if s.pcs[q] < len(progs[q]) else "finished")
                for q in range(p))
            raise _Violation("barrier", f"deadlock: {waits}")
        for q in qs:
            t = s.copy()
            path.append(_fmt(q, progs[q][s.pcs[q]]))
            try:
                step(t, q)
                visit(t)
            except _Violation as v:
                _trace(v)
                raise
            finally:
                path.pop()

    def _trace(v):
        # the path to the violating step, taken before the unwinding pops
        if not hasattr(v, "trace"):
            v.trace = list(path)

    s0 = _State(p)
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 20000))
    try:
        for q in range(p):
            arrive(s0, q)
        visit(s0)
    except _Violation as v:
        _trace(v)
        v.states = len(seen)
        raise
    finally:
        sys.setrecursionlimit(old)
    return len(seen)


def check_schedule(sched: _rs.Schedule,
                   max_states: int = DEFAULT_MAX_STATES,
                   por: bool = True) -> CheckResult:
    """Every interleaving of ``sched``'s programs against invariants
    (a)-(e); ``por=False`` branches on every process's step everywhere
    (the reduction's check)."""
    model = _Model(sched)
    try:
        states = _explore(model, max_states, por)
    except _Violation as v:
        return CheckResult(sched.name, sched.p, False, v.kind, v.detail,
                           v.trace, v.states)
    except _Budget:
        return CheckResult(sched.name, sched.p, False, "state-budget",
                           f"more than {max_states} states; raise "
                           "--max-states", [], max_states)
    return CheckResult(sched.name, sched.p, True, states=states)


# ---------------------------------------------------------------------------
# the mutation harness
# ---------------------------------------------------------------------------

# each mutation seeds the bug class one invariant exists for; ``mutate``
# returns None where the schedule has nothing to mutate
MUTATIONS = {
    "drop-step-barrier": "b",          # a ring step with no barrier after
    "drop-sync-before-barrier": "b",   # the barrier passes before the store
    "unmap-after-closing-barrier": "a",
    "forward-into-read-slot": "b",     # t % 2 for (t + 1) % 2
    "short-process": "c",              # one process runs p - 1 steps
    "publish-before-sync": "d",
    "free-before-closing-barrier": "e",
}


def _first(prog, pred):
    return next((i for i, ins in enumerate(prog) if pred(ins)), None)


def _mutate_prog(prog: tuple, q: int, mutation: str):
    prog = list(prog)
    if mutation == "drop-step-barrier":
        i = _first(prog, lambda x: isinstance(x, _rs.Barrier)
                   and not x.closing)
        if i is None:
            return None
        del prog[i]
    elif mutation == "drop-sync-before-barrier":
        b = _first(prog, lambda x: isinstance(x, _rs.Barrier))
        i = max((j for j in range(b) if isinstance(prog[j], _rs.Sync)
                 and not prog[j].ctx), default=None) if b else None
        if i is None:
            return None
        del prog[i]
    elif mutation == "unmap-after-closing-barrier":
        i = _first(prog, lambda x: isinstance(x, _rs.Unmap))
        b = _first(prog, lambda x: isinstance(x, _rs.Barrier) and x.closing)
        if i is None or b is None:
            return None
        prog.insert(b, prog.pop(i))      # now after the closing barrier
    elif mutation == "forward-into-read-slot":
        hit = False
        for i, ins in enumerate(prog):
            if isinstance(ins, _rs.Launch) and ins.kernel.startswith(
                    "step ") and any(r[1] == "slots" for r, _ in ins.writes):
                t = int(ins.kernel.split()[1])
                ws = tuple(((r[0], r[1], t % 2), tok) if r[1] == "slots"
                           else (r, tok) for r, tok in ins.writes)
                prog[i] = dataclasses.replace(ins, writes=ws)
                hit = True
        if not hit:
            return None
    elif mutation == "short-process":
        if q != 0:
            return prog
        steps = [i for i, ins in enumerate(prog)
                 if isinstance(ins, _rs.Launch) and ins.kernel.startswith(
                     "step ")]
        if len(steps) < 2:
            return None
        # the last step (its launch and sync) and the barrier before it
        last = steps[-1]
        drop = {last, last + 1, last - 1}
        prog = [ins for i, ins in enumerate(prog) if i not in drop]
    elif mutation == "publish-before-sync":
        # only where a launch before the publication writes a published
        # buffer (a ring's fresh slot buffers have no such launch)
        i = _first(prog, lambda x: isinstance(x, _rs.Publish))
        if i is None or not i or not isinstance(prog[i - 1], _rs.Sync) or \
                not any(isinstance(x, _rs.Launch) and any(
                    r[0] == q and r[1] in prog[i].bufs for r, _ in x.writes)
                    for x in prog[:i]):
            return None
        del prog[i - 1]
    elif mutation == "free-before-closing-barrier":
        f = _first(prog, lambda x: isinstance(x, _rs.Free))
        b = _first(prog, lambda x: isinstance(x, _rs.Barrier) and x.closing)
        if f is None or b is None or f < b:
            return None
        prog.insert(b, prog.pop(f))      # before the first closing barrier
    else:
        raise ValueError(f"unknown mutation {mutation!r}")
    return prog


def mutate(sched: _rs.Schedule, mutation: str) -> _rs.Schedule | None:
    """``sched`` with the bug class ``mutation`` seeded (on every process,
    or on process 0 for ``short-process``); None where the schedule has
    nothing of that kind.  The checker must refute every non-None
    mutant."""
    if mutation not in MUTATIONS:
        raise ValueError(f"unknown mutation {mutation!r}")
    progs = []
    for q, prog in enumerate(sched.programs):
        m = _mutate_prog(prog, q, mutation)
        if m is None:
            return None
        progs.append(tuple(m))
    return dataclasses.replace(sched, name=f"{sched.name}!{mutation}",
                               programs=tuple(progs))


# ---------------------------------------------------------------------------
# every schedule, every mutant
# ---------------------------------------------------------------------------


def verify_protocols(ps=DEFAULT_PS, *, mutants: bool = True,
                     mutant_p: int = MUTANT_P,
                     max_states: int = DEFAULT_MAX_STATES) -> dict:
    """Check every shipped schedule at each p of ``ps``, then require the
    checker to refute every applicable mutant (seeded at ``mutant_p``)
    with a counterexample.  ``ok`` is True iff every schedule verifies
    and every mutant is caught (a budget-exhausted run counts as
    neither)."""
    kernels = [check_schedule(_rs.build(name, p), max_states=max_states)
               for name in KERNEL_NAMES for p in ps]
    mutant_results: list[CheckResult] = []
    if mutants:
        for name in KERNEL_NAMES:
            sched = _rs.build(name, mutant_p)
            for mutation in MUTATIONS:
                m = mutate(sched, mutation)
                if m is None:
                    continue
                res = check_schedule(m, max_states=max_states)
                res.mutation = mutation
                mutant_results.append(res)
    ok = (all(r.ok for r in kernels)
          and all(not r.ok and r.kind != "state-budget" and
                  r.counterexample for r in mutant_results))
    return {"ok": ok, "kernels": kernels, "mutants": mutant_results}


def format_report(report: dict, *, verbose_counterexamples: bool = True,
                  max_trace_lines: int = 40) -> str:
    """One line per verdict; a caught mutant prints the invariant it broke
    and (optionally) the interleaving that broke it."""
    lines = []
    for r in report["kernels"]:
        tag = "OK " if r.ok else "FAIL"
        lines.append(f"{tag} {r.name} p={r.p} ({r.states} states)")
        if not r.ok:
            lines.append(f"     {r.kind}: {r.detail}")
            for t in r.counterexample[-max_trace_lines:]:
                lines.append(f"     | {t}")
    for r in report["mutants"]:
        caught = not r.ok and r.kind != "state-budget" and r.counterexample
        tag = "CAUGHT " if caught else "MISSED "
        inv = INVARIANTS.get(r.kind, "?")
        lines.append(f"{tag} {r.name} p={r.p} ({r.states} states)")
        if caught:
            lines.append(f"     ({inv}) {r.kind}: {r.detail}")
            if verbose_counterexamples:
                trace = r.counterexample
                if len(trace) > max_trace_lines:
                    lines.append(f"     | ... ({len(trace) - max_trace_lines}"
                                 " earlier step(s) elided)")
                    trace = trace[-max_trace_lines:]
                for t in trace:
                    lines.append(f"     | {t}")
    lines.append("protocol verification: "
                 + ("OK" if report["ok"] else "FAILED")
                 + f" ({len(report['kernels'])} schedule(s), "
                 f"{len(report['mutants'])} mutant(s))")
    return "\n".join(lines)
