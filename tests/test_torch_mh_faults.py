"""Faults that split a job's controller processes, and the Trainer's
recovery across them (ROADMAP.md C34).

A 2-process job of ``tests/_torch_multihost_child.py`` runs the legs of
``tests/_torch_mh_legs.py`` ``fault_legs``: the transformer's device loss
with process 0 held at the probe's barrier past the heartbeat census's
staleness, the same loss with process 0's top of the step failing with a
transient fault (the processes classify the failure apart), a leg that
raises on process 1 only, and the MLP's device loss after it.  Each
recovery is held bit for bit against the port in one process on the same
8 ranks (``recovery_legs``); the leg that raised fails on every process,
each with its own error, and the leg after it is judged on its own.  The
rules they rest on (the probe after a barrier reads no peer's heartbeat
age, one agreed decision a branch of the recovery loop) are also checked
in one process.
"""

import os
import sys

import numpy as np
import pytest

import distributedarrays_tpu_torch as tdat
from distributedarrays_tpu_torch import layout as L
from distributedarrays_tpu_torch.parallel import multihost as MH
from distributedarrays_tpu_torch.resilience import elastic, faults, recovery
from distributedarrays_tpu_torch.train import trainer as TR

import _torch_mh_legs as LEGS
from _torch_port import port_ranks, run_job  # noqa: F401

_CHILD = os.path.join(os.path.dirname(__file__), "_torch_multihost_child.py")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_JOB_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
            "DA_TPU_DOMAINS", "DA_TPU_TELEMETRY", "DA_TPU_MH_INIT_TIMEOUT_S")


def _env() -> dict:
    env = {k: v for k, v in os.environ.items() if k not in _JOB_ENV}
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.fixture(scope="module")
def faults_job(tmp_path_factory):
    import pickle
    out = tmp_path_factory.mktemp("port_mh_faults")
    store = str(out / "store")
    done = run_job([[sys.executable, _CHILD, store, str(i), "2", str(out),
                     "3.0", "faults"] for i in range(2)], str(out), _env(),
                   store)
    for i, (rc, log) in enumerate(done):
        assert rc == 0 and f"MULTIHOST_OK proc={i}" in log, log
    res = []
    for i in range(2):
        with open(out / f"result_{i}.pkl", "rb") as f:
            res.append(pickle.load(f))
    return res


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The port in one process on the job's 8 ranks: the legs the fault
    legs must equal."""
    tdat.init(nranks=8, device="cpu")
    legs = dict(LEGS.recovery_legs(
        tdat, 8, str(tmp_path_factory.mktemp("port_mh_faults_ref"))))
    out = {name: legs[name]() for name in ("trainer_loss_transformer",
                                           "trainer_loss_mlp")}
    tdat.d_closeall()
    return out


def _assert_bit_equal(got: dict, want: dict, what: str) -> None:
    for key, w in want.items():
        g = got[key]
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype and \
                np.array_equal(g, w), (what, key)
        else:
            assert g == w, (what, key, g, w)


def test_late_process_at_the_probe_recovers_bit_equal_to_one_process(
        faults_job, reference):
    # process 0 comes to the probe's barrier LATE_S after its heartbeat,
    # with the census at LATE_STALE_S: the probe read every peer's
    # heartbeat as stale, and the job shrank off a live process's ranks
    # (ranks [0, 1, 2, 3], losses off in the last digits); the peers met
    # at the barrier, so none is down
    want = reference["trainer_loss_transformer"]
    for r in faults_job:
        assert "late_probe" not in r["errors"], r["errors"]["late_probe"]
        _assert_bit_equal(r["faults"]["late_probe"], want, "late_probe")
    assert want["ranks"] == [x for x in range(8) if x != LEGS.LOSS_RANK]


def test_split_verdicts_recover_together_bit_equal_to_one_process(
        faults_job, reference):
    # process 0 saw a transient fault, process 1 the device loss: each
    # took its own verdict's branch (restore alone; probe, restore and
    # shrink) and the job timed out in calls the other never made; one
    # agreed verdict now takes both through the device loss's branch
    for r in faults_job:
        assert "split_verdict" not in r["errors"], \
            r["errors"]["split_verdict"]
        _assert_bit_equal(r["faults"]["split_verdict"],
                          reference["trainer_loss_transformer"],
                          "split_verdict")


def test_leg_raising_on_one_process_fails_on_every_process(faults_job):
    # process 1 raises at the checkpoint manager's exchange, which process
    # 0 enters and leaves by the gloo group's timeout: the leg fails on
    # both, each with its own error
    own, peer = (r["errors"].get("one_process_raise") for r in
                 (faults_job[1], faults_job[0]))
    assert own == "RuntimeError: raised on process 1 only", own
    assert peer is not None and "raised on process 1 only" not in peer, peer
    assert all("one_process_raise" not in r["faults"] for r in faults_job)


def test_leg_after_a_one_process_failure_recovers_bit_equal_to_one_process(
        faults_job, reference):
    # the gloo pairs that the timeout closed failed every later exchange
    # ("Application timeout caused pair closure"); the job agrees on each
    # leg's outcome and realigns after a failure, so the next leg passes
    for r in faults_job:
        assert "after_raise" not in r["errors"], r["errors"]["after_raise"]
        _assert_bit_equal(r["faults"]["after_raise"],
                          reference["trainer_loss_mlp"], "after_raise")


# ---------------------------------------------------------------------------
# the rules in one process
# ---------------------------------------------------------------------------


def test_probe_after_a_barrier_counts_no_peer_down_by_heartbeat_age(
        monkeypatch):
    # process 1's heartbeat is 100 s old (the census's 30 s staleness
    # downs its ranks 4..7); after the trainer's barrier it met this
    # process, so the probe downs none of them and reads no partition
    monkeypatch.setattr(L, "process_of", lambda r: int(r) // 4)
    monkeypatch.setattr(MH, "down_peer_processes",
                        lambda stale_s=30.0: {1} if stale_s < 100 else set())
    m = elastic.manager()
    try:
        assert m.probe()["down"] == [4, 5, 6, 7]
        m.reset()
        met = m.probe(peers_met=True)
        assert met["down"] == [] and met["live"] == list(range(8))
        assert met["partition"]["verdict"] == "healthy"
    finally:
        m.reset()


@pytest.mark.parametrize("every,want", [
    ([("transient", True, False), ("device_loss", True, False)],
     ("device_loss", True, False)),
    ([("timeout", True, False), ("transient", True, False)],
     ("timeout", True, True)),
    ([("device_loss", True, False), ("partition", True, False)],
     ("partition", True, False)),
    ([("device_loss", True, False), ("device_loss", False, False)],
     ("device_loss", False, False)),
    ([("partition", True, True), ("partition", True, False)],
     ("partition", False, False)),
    ([("divergence", False, False), ("transient", True, False)],
     ("transient", False, False)),
    ([("timeout", True, False), ("device_loss", True, False)],
     ("device_loss", True, True)),
])
def test_job_devices_agree_on_one_branch(monkeypatch, every, want):
    # every process's (verdict, retryable, minority) in one exchange: the
    # job retries only if every process would and none leaves on a
    # minority side, under the first verdict of recovery's precedence that
    # any process reached, and drops the plan cache if any timed out
    monkeypatch.setattr(MH, "_all_gather_objects", lambda obj: every)
    got = TR._JobDevices().exchange(every[0])
    assert recovery._agreed(got, every[0][0]) == want


class _Devices:
    """An elastic set whose ``exchange`` answers as the job's processes
    would, recording the branch the loop took."""

    def __init__(self, every):
        self.every, self.calls = every, []

    def exchange(self, decision):
        self.calls.append(("exchange",) + decision)
        return self.every

    def probe(self):
        self.calls.append("probe")

    def shrink(self):
        self.calls.append("shrink")


def test_recovery_loop_takes_the_agreed_verdicts_branch():
    # a transient failure here, a device loss on a peer: this process
    # probes and shrinks with the others before its retry
    devs = _Devices([("transient", True, False),
                     ("device_loss", True, False)])
    attempts = []

    def step():
        attempts.append(1)
        if len(attempts) == 1:
            raise RuntimeError("transient here")
        return "done"
    pol = recovery.RetryPolicy(base_delay=0.0, jitter=0.0)
    assert recovery.run_with_recovery(step, policy=pol,
                                      devices=devs) == "done"
    assert devs.calls == [("exchange", "transient", True, False), "probe",
                          "shrink"]


def test_recovery_loop_gives_up_when_a_peer_does():
    # this process would retry; a peer's verdict is not retryable: every
    # process raises its own error, and none probes, restores or shrinks
    devs = _Devices([("transient", True, False),
                     ("transient", False, False)])

    def step():
        raise RuntimeError("transient here")
    with pytest.raises(RuntimeError, match="transient here"):
        recovery.run_with_recovery(step, devices=devs)
    assert devs.calls == [("exchange", "transient", True, False)]


def test_recovery_loop_agrees_on_the_deadline_after_the_restore():
    # under a wall-clock budget the check after the restore is agreed too:
    # a peer whose budget ran out stops every process
    devs = _Devices(None)
    answers = iter([[("transient", True, False)] * 2,
                    [("transient", True, False), ("transient", False,
                                                  False)]])
    devs.exchange = lambda d: (devs.calls.append(("exchange",) + d),
                               next(answers))[1]

    def step():
        raise RuntimeError("transient here")
    pol = recovery.RetryPolicy(max_elapsed_s=60.0)
    with pytest.raises(RuntimeError, match="transient here"):
        recovery.run_with_recovery(step, policy=pol, devices=devs)
    assert [c[0] if isinstance(c, tuple) else c for c in devs.calls] == \
        ["exchange", "exchange"]


def test_injected_partition_in_a_job_exits_the_minority_after_the_exchange(
        monkeypatch):
    # a partition's minority side still exits cleanly, once the job has
    # heard of it in the exchange (its peers then give up too)
    faults.configure(plan=[{"site": "x", "action": "partition",
                            "groups": [[0, 1, 2, 3, 4], [5, 6, 7]],
                            "observer": 6}], seed=1)
    devs = _Devices([("partition", True, True),
                     ("partition", True, False)])
    try:
        def step():
            faults.check("x")
        with pytest.raises(recovery.MinorityPartitionExit):
            recovery.run_with_recovery(step, devices=devs)
        assert devs.calls == [("exchange", "partition", True, True)]
    finally:
        faults.clear()
        elastic.manager().reset()


def test_recovery_loop_drops_the_plan_cache_when_a_peer_timed_out(
        monkeypatch):
    # a device loss here, a timeout on a peer: the job takes the device
    # loss's branch, and every process also drops its reshard plan cache
    # and counts the timeout, so a second timeout past the policy's
    # timeout_retries gives up on every process alike
    fresh = []
    monkeypatch.setattr(recovery, "fresh_mesh", lambda: fresh.append(1))
    devs = _Devices([("device_loss", True, False),
                     ("timeout", True, False)])
    attempts = []

    def step():
        attempts.append(1)
        if len(attempts) == 1:
            raise RuntimeError("device lost here")
        return "done"
    pol = recovery.RetryPolicy(base_delay=0.0, jitter=0.0)
    assert recovery.run_with_recovery(step, policy=pol,
                                      devices=devs) == "done"
    assert fresh == [1]
    assert devs.calls[1:] == ["probe", "shrink"]
