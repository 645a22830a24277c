"""The port's protocol model (``ops/ring_schedules.py``,
``analysis/protocol.py``), the twin of ``tests/test_protocol.py`` where a
case applies.

The checker must prove every shipped schedule over every interleaving of
the processes (invariants (a) mappings, (b) slots, (c) barriers, (d)
publication, (e) lifetime) and refute every seeded mutant with a printed
interleaving; hand-built miniature programs trigger each invariant alone.
The schedules' programs replayed through the code's event hook give the
events the schedules say, and ``conform`` holds a recorded sequence
against them.  JAX's model checks Pallas RDMA semaphores and credits,
which the port does not have, so its fixtures (credits, DMA semaphores,
mesh sub-rings) have no twin here."""

import subprocess
import sys
from pathlib import Path

import pytest

from distributedarrays_tpu_torch.analysis import protocol
from distributedarrays_tpu_torch.analysis.__main__ import main as tmain
from distributedarrays_tpu_torch.ops import ring_schedules as rs

REPO = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# the shipped schedules verify
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", protocol.KERNEL_NAMES)
@pytest.mark.parametrize("p", [2, 3, 4, 8])
def test_shipped_schedules_verify(name, p):
    res = protocol.check_schedule(rs.build(name, p))
    assert res.ok, f"{name} p={p}: {res.kind}: {res.detail}"
    assert res.states >= 1


def test_schedules_cover_every_cross_process_protocol():
    # peer_call's region copy (K10/K11), K12's cross-process route, the
    # rings of K13/K14 (to -1), K15 and K9 (to +1), the tp/dp all-reduce,
    # the tp/dp sampling's row exchange, the chunked checkpoint's publish
    # and restore and the Trainer's cross-process shrink
    assert set(protocol.KERNEL_NAMES) == {
        "region_copy", "reduce_scatter", "ring_allgather_matmul",
        "ring_allgather_matmul_rhs", "ring_matmul_reducescatter",
        "ring_attention", "tp_allreduce", "tp_sample", "chunked_publish",
        "job_restore", "job_restore_clean", "job_shrink"}
    assert set(rs.CALL_SCHEDULES.values()) <= set(protocol.KERNEL_NAMES)


def test_schedules_are_pure_data():
    a = rs.build("ring_matmul_reducescatter", 4)
    b = rs.build("ring_matmul_reducescatter", 4)
    assert a == b and hash(a.programs) == hash(b.programs)
    assert a != rs.build("ring_matmul_reducescatter", 3)
    assert a != rs.build("ring_allgather_matmul", 4)


@pytest.mark.parametrize("name", protocol.KERNEL_NAMES)
@pytest.mark.parametrize("p", [2, 3])
def test_reduced_search_agrees_with_every_interleaving(name, p):
    # the persistent-set reduction keeps every verdict of the full search,
    # on the schedules and on each of their mutants
    scheds = [rs.build(name, p)] + [
        m for m in (protocol.mutate(rs.build(name, p), k)
                    for k in protocol.MUTATIONS) if m is not None]
    for s in scheds:
        a = protocol.check_schedule(s)
        b = protocol.check_schedule(s, por=False)
        assert (a.ok, a.kind) == (b.ok, b.kind), s.name
        if a.ok:
            assert b.states >= a.states


# ---------------------------------------------------------------------------
# the mutation harness
# ---------------------------------------------------------------------------


def test_verify_protocols_end_to_end():
    rep = protocol.verify_protocols()
    assert rep["ok"]
    assert all(r.ok for r in rep["kernels"])
    assert {r.p for r in rep["kernels"]} == set(protocol.DEFAULT_PS)
    assert rep["mutants"], "mutation harness produced no mutants"
    for m in rep["mutants"]:
        assert not m.ok, f"MISSED mutant {m.name}"
        assert m.kind != "state-budget"
        assert m.counterexample, "refutation must carry an interleaving"
        assert m.mutation in protocol.MUTATIONS


def test_every_invariant_has_a_refuted_mutant():
    rep = protocol.verify_protocols(ps=(2,))
    kinds = {protocol.INVARIANTS[m.kind] for m in rep["mutants"]}
    assert kinds == {"a", "b", "c", "d", "e", "f", "g"}
    got = {m.mutation for m in rep["mutants"]}
    assert got == set(protocol.MUTATIONS)


@pytest.mark.parametrize("name,mutation,kind", [
    ("ring_allgather_matmul", "drop-step-barrier", "slot"),
    ("ring_matmul_reducescatter", "drop-sync-before-barrier", "slot"),
    ("ring_attention", "forward-into-read-slot", "slot"),
    ("ring_allgather_matmul_rhs", "short-process", "barrier"),
    ("region_copy", "unmap-after-closing-barrier", "mapping"),
    ("reduce_scatter", "publish-before-sync", "publication"),
    ("tp_allreduce", "free-before-closing-barrier", "lifetime"),
])
def test_mutant_counterexample_is_a_readable_interleaving(name, mutation,
                                                          kind):
    m = protocol.mutate(rs.build(name, 4), mutation)
    res = protocol.check_schedule(m)
    assert not res.ok and res.kind == kind
    trace = "\n".join(res.counterexample)
    assert "process " in trace
    if kind != "publication":      # caught at process 0's first publication
        assert "launch" in trace or "pass" in trace
    text = protocol.format_report({"ok": False, "kernels": [],
                                   "mutants": [res]})
    assert text.startswith("CAUGHT") and f"({protocol.INVARIANTS[kind]})" \
        in text


def test_mutate_returns_none_when_not_applicable():
    # a region copy has no step barrier, no slot, no ring steps
    copy = rs.build("region_copy", 4)
    for mutation in ("drop-step-barrier", "forward-into-read-slot",
                     "short-process"):
        assert protocol.mutate(copy, mutation) is None
    # a ring's fresh slot buffers have no write before their publication
    assert protocol.mutate(rs.build("ring_attention", 4),
                           "publish-before-sync") is None
    with pytest.raises(ValueError):
        protocol.mutate(copy, "no-such")


def test_format_report_prints_verdicts():
    rep = protocol.verify_protocols(ps=(2, 8), mutants=False)
    text = protocol.format_report(rep)
    assert "OK " in text and "protocol verification: OK" in text
    assert "ring_attention p=8" in text


def test_state_budget_is_a_failure_not_a_pass():
    res = protocol.check_schedule(rs.build("ring_allgather_matmul", 4),
                                  max_states=3)
    assert not res.ok and res.kind == "state-budget"
    # and a budgeted-out mutant does NOT count as caught
    rep = {"ok": None, "kernels": [], "mutants": [res]}
    assert "MISSED" in protocol.format_report(rep)
    rep = protocol.verify_protocols(ps=(4,), max_states=3)
    assert not rep["ok"]


# ---------------------------------------------------------------------------
# one miniature program for each invariant
# ---------------------------------------------------------------------------


def _mini(*programs):
    return rs.Schedule("mini", len(programs),
                       tuple(tuple(p) for p in programs))


def _launch(reads=(), writes=()):
    return rs.Launch("k", tuple(reads), tuple(writes))


def test_invariant_a_mapping_open_at_the_closing_barrier():
    res = protocol.check_schedule(_mini(
        [rs.Map(1, "b"), rs.Barrier("call", closing=True)],
        [rs.Barrier("call", closing=True)]))
    assert not res.ok and res.kind == "mapping"
    assert "closing barrier" in res.detail
    # and a peer's buffer read with no mapping
    res = protocol.check_schedule(_mini(
        [_launch(reads=[((1, "b", 0), None)]), rs.Sync()], []))
    assert not res.ok and res.kind == "mapping"
    assert "no open mapping" in res.detail


def test_invariant_b_slot_read_before_its_store_landed():
    store = _launch(writes=[((1, "s", 0), "v")])
    res = protocol.check_schedule(_mini(
        [rs.Map(1, "s"), store, rs.Barrier("step"), rs.Sync(), rs.Unmap()],
        [rs.Barrier("step"), _launch(reads=[((1, "s", 0), "v")]),
         rs.Sync()]))
    assert not res.ok and res.kind == "slot"
    ok = protocol.check_schedule(_mini(
        [rs.Map(1, "s"), store, rs.Sync(), rs.Unmap(), rs.Barrier("step")],
        [rs.Barrier("step"), _launch(reads=[((1, "s", 0), "v")]),
         rs.Sync()]))
    assert ok.ok, ok.detail


def test_invariant_c_barrier_that_a_process_never_reaches():
    res = protocol.check_schedule(_mini(
        [rs.Barrier("step"), rs.Barrier("step")], [rs.Barrier("step")]))
    assert not res.ok and res.kind == "barrier"
    assert "deadlock" in res.detail and "finished" in res.detail


def test_invariant_d_publication_before_the_sync():
    res = protocol.check_schedule(_mini(
        [_launch(writes=[((0, "b", 0), "v")]), rs.Publish("t", ("b",)),
         rs.Sync()],
        [rs.Publish("t", ("c",))]))
    assert not res.ok and res.kind == "publication"


def test_invariant_e_free_while_a_peer_maps_it():
    res = protocol.check_schedule(_mini(
        [rs.Free("b")],
        [rs.Map(0, "b"), _launch(reads=[((0, "b", 0), None)]), rs.Sync(),
         rs.Unmap()]))
    assert not res.ok and res.kind == "lifetime"


# ---------------------------------------------------------------------------
# the event hook and conformance
# ---------------------------------------------------------------------------


def _replay(sched, proc):
    """A schedule's program reported through the code's hook vocabulary,
    as the launch sites, syncs, mappings and the store report it."""
    for ins in sched.programs[proc]:
        if getattr(ins, "ctx", False):
            continue
        if isinstance(ins, rs.Sync):
            rs.record("sync")
        elif isinstance(ins, rs.Publish):
            rs.record("publish", ins.tag)
        elif isinstance(ins, rs.Map):
            rs.record("map")
        elif isinstance(ins, rs.Launch):
            rs.record("launch")
        elif isinstance(ins, rs.Unmap):
            rs.record("unmap")
        elif isinstance(ins, rs.Barrier):
            rs.record("barrier", ins.name)
        elif isinstance(ins, (rs.Write, rs.Mark, rs.Verify, rs.Restore)):
            rs.record(type(ins).__name__.lower())


@pytest.mark.parametrize("name", protocol.KERNEL_NAMES)
@pytest.mark.parametrize("p", [2, 4])
def test_replayed_programs_give_their_schedules_events(name, p):
    sched = rs.build(name, p)
    for proc in range(p):
        with rs.recording() as seen:
            _replay(sched, proc)
        assert {e.partition(":")[0] for e in seen} <= set(rs.EVENT_KINDS)
        assert rs.call_events(seen) == rs.events(sched, proc)
        assert rs.conform(seen, p, proc) == []


def test_hook_does_nothing_when_unset():
    rs.set_hook(None)
    rs.record("sync")                    # no hook: nothing happens
    with rs.recording() as seen:
        rs.record("barrier", "x")
    assert seen == ["barrier:x"]
    rs.record("launch")
    assert seen == ["barrier:x"]


def test_conform_refuses_a_call_that_departs_from_its_schedule():
    sched = rs.build("ring_allgather_matmul", 4)
    good = rs.events(sched, 0)
    assert rs.conform(good, 4) == []
    no_sync = list(good)
    no_sync.remove("sync")               # the entry sync
    assert rs.conform(no_sync, 4)
    short = [e for i, e in enumerate(good)
             if i != good.index("barrier:ring_gemm_step")]
    assert rs.conform(short, 4)
    late_unmap = good[:-2] + [good[-1], "unmap"]
    assert rs.conform(late_unmap, 4)
    # a process holding no rank of a call publishes and passes barriers
    idle = ["publish:region", "unmap", "barrier:region"]
    assert rs.conform(idle, 4) == []
    # calls in a row, and barriers of no call in between, are cut apart
    region = rs.events(rs.build("region_copy", 4), 1)
    assert rs.conform(region + ["barrier:done"] + good + region, 4) == []


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def test_cli_verify_protocols_roundtrip():
    r = subprocess.run(
        [sys.executable, "-m", "distributedarrays_tpu_torch.analysis",
         "verify-protocols", "--ps", "2,3", "--quiet"],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "protocol verification: OK" in r.stdout
    assert "CAUGHT" in r.stdout and "MISSED" not in r.stdout


def test_cli_verify_protocols_fails_closed_on_budget(capsys):
    assert tmain(["verify-protocols", "--ps", "4", "--max-states", "5",
                  "--no-mutants", "--quiet"]) == 1
    out = capsys.readouterr().out
    assert "state-budget" in out and "FAILED" in out


def test_cli_verify_protocols_exits_2_when_it_cannot_run(capsys):
    assert tmain(["verify-protocols", "--ps", "two"]) == 2
    assert tmain(["verify-protocols", "--ps", "1"]) == 2
    assert "verify-protocols" in capsys.readouterr().err
