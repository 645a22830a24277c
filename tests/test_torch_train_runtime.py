"""The trainer's runtime tier in the PyTorch port (``train/trainer.py``
with ``utils/checkpoint.py``, ``resilience/*``): the runtime cases of
``tests/test_train.py`` run against the port on 8 CPU ranks, and the
port's losses against the JAX trainer's.

Resume, recovery and the chaos soak are held bit for bit inside the port:
a resumed or recovered run and a fault-free run restarted from the same
verified step see the same state and batches.  Against the JAX trainer
the losses are held at rtol 1e-5, as in ``tests/test_torch_train.py``.
The straggler case uses a 1 s budget floor and a 2.5 s hang, not JAX's
0.3 s and 0.6 s, so a loaded test machine does not trip it early.
"""

import dataclasses
import os
import shutil
import time

import numpy as np
import pytest
import torch

import jax

import distributedarrays_tpu_torch as tdat
from distributedarrays_tpu.resilience import elastic as jelastic
from distributedarrays_tpu.resilience import faults as jfaults
from distributedarrays_tpu.telemetry import flight as jflight
from distributedarrays_tpu.train import optim as JO
from distributedarrays_tpu.train import tasks as JTasks
from distributedarrays_tpu.train import trainer as JTrainer
from distributedarrays_tpu_torch import telemetry as tm
from distributedarrays_tpu_torch.resilience import elastic, faults, recovery
from distributedarrays_tpu_torch.telemetry import flight
from distributedarrays_tpu_torch.train import (DeadRankError,
                                               StragglerDetector, Trainer,
                                               adam, mlp_task, sgd)
from distributedarrays_tpu_torch.train import tasks as TTasks

from _torch_port import jax_plan_cache, jax_process_state, port_ranks  # noqa: F401


@pytest.fixture(autouse=True)
def _clean_chaos(monkeypatch, port_ranks):
    """Both packages' fault plans disarmed, elastic sets pristine and the
    flight recorders reset around every test."""
    for var in ("DA_TPU_FAULT_PLAN", "DA_TPU_FAULT_SEED"):
        monkeypatch.delenv(var, raising=False)
    for f, e, fl in ((faults, elastic, flight),
                     (jfaults, jelastic, jflight)):
        f.clear()
        e.manager().reset()
        fl._reset()
    tm.enable()
    yield
    for f, e, fl in ((faults, elastic, flight),
                     (jfaults, jelastic, jflight)):
        f.clear()
        e.manager().reset()
        fl._reset()


def _fast_policy(**kw):
    kw.setdefault("base_delay", 0.005)
    kw.setdefault("max_delay", 0.02)
    return recovery.RetryPolicy(**kw)


def _trainer(tmp_path=None, task=None, save_every=2, **kw):
    kw.setdefault("policy", _fast_policy())
    kw.setdefault("seed", 0)
    return Trainer(task or mlp_task(batch_size=56),
                   ckpt_dir=None if tmp_path is None else tmp_path,
                   save_every=save_every, **kw)


# ---------------------------------------------------------------------------
# against the JAX trainer
# ---------------------------------------------------------------------------


def _jax_init_task(jtask, ptask):
    ref = jax.tree_util.tree_map(np.asarray,
                                 jtask.init_params(jax.random.PRNGKey(0)))
    return dataclasses.replace(ptask, init_params=lambda gen: jax.tree_util
                               .tree_map(lambda x: torch.from_numpy(
                                   np.array(x, np.float32)), ref))


def test_checkpointed_run_matches_the_jax_trainer(tmp_path):
    # both trainers on all 8 ranks, checkpointing every 2 steps; the port
    # resumes from its step 4 and must continue JAX's trajectory
    jt = JTrainer.Trainer(JTasks.mlp_task(batch_size=56),
                          optimizer=JO.adam(1e-2), ckpt_dir=tmp_path / "j",
                          save_every=2, seed=0)
    with jt:
        jres = jt.fit(6)
    task = _jax_init_task(JTasks.mlp_task(batch_size=56),
                          mlp_task(batch_size=56))
    with _trainer(tmp_path / "p", task=task, optimizer=adam(1e-2)) as t:
        res = t.fit(4)
    with _trainer(tmp_path / "p", task=task, optimizer=adam(1e-2)) as t:
        res2 = t.fit(6)
    assert res2["start"] == res2["resumed_from"] == 4
    np.testing.assert_allclose(res["losses"] + res2["losses"],
                               jres["losses"], rtol=1e-5)


def test_port_resumes_a_jax_written_trainer_checkpoint(tmp_path):
    # the JAX trainer's checkpoint (default cuts over 8 ranks) resumed by
    # the port, which re-lays it onto its shard cuts
    jt = JTrainer.Trainer(JTasks.mlp_task(batch_size=56),
                          optimizer=JO.adam(1e-2), ckpt_dir=tmp_path,
                          save_every=2, seed=0)
    with jt:
        jres = jt.fit(4)
    for p in sorted(os.listdir(tmp_path)):
        if p.startswith("step_") and int(p[5:]) > 2:
            shutil.rmtree(tmp_path / p)
    with _trainer(tmp_path, optimizer=adam(1e-2), save_every=100) as t:
        res = t.fit(4)
        n = t._spec[2]
        assert t._state["pflat"].cuts == [
            [min(r * -(-n // 8), n) for r in range(9)]]
    assert res["start"] == 2
    np.testing.assert_allclose(res["losses"], jres["losses"][2:], rtol=1e-5)


# ---------------------------------------------------------------------------
# resume and re-seat
# ---------------------------------------------------------------------------


def test_checkpoint_resume_matches_uninterrupted(tmp_path):
    with _trainer(tmp_path / "a", save_every=2) as t:
        full = t.fit(6)["losses"]
    with _trainer(tmp_path / "b", save_every=2) as t1:
        t1.fit(4)
    with _trainer(tmp_path / "b", save_every=2) as t2:
        res = t2.fit(6)
    assert res["start"] == 4
    assert res["losses"] == full[4:]          # bitwise


def test_resume_onto_other_ranks_and_async_peer_checkpoints(tmp_path):
    # saved on 8 ranks, resumed pinned onto 3: the state is re-laid onto
    # the shard cuts of the 3 ranks, and the trajectory continues
    with _trainer(tmp_path / "a", async_save=True, peer_replicas=True,
                  max_to_keep=2) as t:
        full = t.fit(6)["losses"]
        assert t._mgr.steps() == [4, 6]
    with _trainer(tmp_path / "b") as t1:
        t1.fit(4)
    with _trainer(tmp_path / "b", ranks=[5, 1, 2]) as t2:
        res = t2.fit(6)
        assert [int(p) for p in t2._state["m0"].pids.flat] == [5, 1, 2]
    np.testing.assert_allclose(res["losses"], full[4:], rtol=1e-6)
    assert tdat.live_ids() == []


def test_resume_with_different_optimizer_is_safe(tmp_path):
    with _trainer(tmp_path / "s", optimizer=sgd(lr=1e-2)) as t:
        t.fit(2)
    t2 = _trainer(tmp_path / "s", optimizer=adam(lr=1e-2))
    with pytest.raises(ValueError, match="different optimizer"):
        t2.fit(4)
    t2.close()
    assert tdat.live_ids() == []
    with _trainer(tmp_path / "a", optimizer=adam(lr=1e-2)) as t3:
        t3.fit(2)
    with _trainer(tmp_path / "a", optimizer=sgd(lr=1e-2)) as t4:
        res = t4.fit(4)
    assert res["start"] == 2 and len(res["losses"]) == 2
    assert tdat.live_ids() == []


# ---------------------------------------------------------------------------
# straggler probe, pinned ranks, deadlines
# ---------------------------------------------------------------------------


def test_straggler_probe_confirms_dead_rank_and_recovers(tmp_path):
    s0 = tm.counter_value("train.stragglers")
    r0 = tm.counter_value("recovery.retries", verdict="device_loss")
    faults.configure(plan=[
        {"site": "train.step", "match": {"step": 6}, "action": "hang",
         "hang_s": 2.5, "at": 1, "count": 1, "device": 2}], seed=7)
    det = StragglerDetector(factor=3.0, min_budget_s=1.0, warmup=3)
    with _trainer(tmp_path, straggler=det) as t:
        res = t.fit(8)
        assert t.stragglers == 1
    assert tm.counter_value("train.stragglers") == s0 + 1
    assert tm.counter_value("recovery.retries",
                            verdict="device_loss") == r0 + 1
    assert 2 not in elastic.manager().live_ranks()
    assert len(res["losses"]) == 8
    assert tdat.live_ids() == []


def test_first_step_on_a_rank_set_is_not_judged():
    det = StragglerDetector(factor=1.0, min_budget_s=0.0, warmup=0)
    with _trainer(straggler=det) as t:
        t.fit(1)
    assert len(det._durs) == 0


def test_closed_trainer_and_pinned_ranks():
    t = _trainer()
    t.fit(1)
    t.close()
    with pytest.raises(RuntimeError, match="closed"):
        t.fit(2)
    with pytest.raises(RuntimeError, match="closed"):
        t.step_once()
    assert tdat.live_ids() == []
    with _trainer(ranks=[2, 3]) as t2:
        elastic.manager().mark_down(2)
        elastic.manager().mark_down(3)
        with pytest.raises(RuntimeError, match="no pinned rank"):
            t2.fit(1)
    # one pinned rank down: the run continues on the other, never on an
    # unpinned rank
    elastic.manager().reset()
    with _trainer(ranks=[2, 3]) as t3:
        t3.fit(1)
        elastic.manager().mark_down(3)
        t3.fit(2)
        assert [int(p) for p in t3._state["pflat"].pids.flat] == [2]


def test_dead_rank_error_classifies_device_loss():
    e = DeadRankError([3], budget_s=0.5, dur_s=2.0)
    assert recovery.classify(e) == "device_loss"
    assert "device lost" in str(e) and "[3]" in str(e)


def test_trainer_step_deadline_bounds_recovery(tmp_path):
    faults.configure(plan=[
        {"site": "grad.sync", "action": "raise", "at": 1, "count": -1}],
        seed=3)
    with _trainer(tmp_path, step_deadline_s=0.5,
                  policy=_fast_policy(max_retries=10_000)) as t:
        t0 = time.monotonic()
        with pytest.raises(faults.InjectedFault):
            t.fit(2)
        assert time.monotonic() - t0 < 30.0


# ---------------------------------------------------------------------------
# fault sites
# ---------------------------------------------------------------------------


def test_train_step_fault_site_device_loss_recovers(tmp_path):
    r0 = tm.counter_value("recovery.retries", verdict="device_loss")
    faults.configure(plan=[
        {"site": "train.step", "match": {"step": 3}, "action":
         "device_loss", "at": 1, "count": 1, "device": 1}], seed=5)
    with _trainer(tmp_path, peer_replicas=True) as t:
        disk0 = tm.counter_value("checkpoint.disk_reads")
        res = t.fit(5)
        assert tm.counter_value("checkpoint.disk_reads") == disk0
        assert [int(p) for p in t._state["pflat"].pids.flat] == \
            [0, 2, 3, 4, 5, 6, 7]
    assert tm.counter_value("recovery.retries",
                            verdict="device_loss") == r0 + 1
    assert 1 not in elastic.manager().live_ranks()
    assert len(res["losses"]) == 5


def test_grad_sync_fault_site_fires_between_the_gradients_and_the_sync(
        tmp_path):
    hist0 = len(faults.history())
    faults.configure(plan=[
        {"site": "grad.sync", "match": {"step": 1}, "action": "raise",
         "at": 1, "count": 1}], seed=5)
    with _trainer(tmp_path) as t:
        t.fit(3)
    fired = faults.history()[hist0:]
    assert [f["site"] for f in fired] == ["grad.sync"]
    assert fired[0]["labels"] == {"step": 1}


# ---------------------------------------------------------------------------
# the chaos soak
# ---------------------------------------------------------------------------


_PLAN = [
    {"site": "train.step", "match": {"step": 5},
     "action": "device_loss", "at": 1, "count": 1, "device": 3},
    {"site": "checkpoint.read", "action": "corrupt", "at": 1, "count": 1},
]


def _soak(tmp_path, plan, seed, **kw):
    faults.clear()
    elastic.manager().reset()
    if plan is not None:
        faults.configure(plan=plan, seed=seed)
    t = _trainer(tmp_path, save_every=2, **kw)
    try:
        return t.fit(8), elastic.manager().live_ranks()
    finally:
        t.close()


def test_chaos_soak_device_kill_plus_corrupt_shard(tmp_path):
    b0 = flight.crash_bundle_count()
    r0 = tm.counter_value("recovery.retries", verdict="device_loss")
    k0 = tm.counter_value("elastic.shrinks")
    q0 = tm.counter_value("checkpoint.quarantines")
    f0 = tm.counter_value("checkpoint.restore_fallbacks")
    res, survivors = _soak(tmp_path / "chaos", _PLAN, seed=42)
    assert survivors == [0, 1, 2, 4, 5, 6, 7]
    assert len(res["losses"]) == 8
    assert flight.crash_bundle_count() - b0 == 1
    assert tm.counter_value("recovery.retries",
                            verdict="device_loss") == r0 + 1
    assert tm.counter_value("elastic.shrinks") == k0 + 1
    assert tm.counter_value("checkpoint.quarantines") == q0 + 1
    assert tm.counter_value("checkpoint.restore_fallbacks") == f0 + 1
    assert (tmp_path / "chaos" / ".quarantine_step_00000004").exists()
    # a fault-free run restarted from the same verified step (2) on the
    # same survivors: the same losses, bit for bit
    faults.clear()
    src, dst = tmp_path / "chaos", tmp_path / "clean"
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns(".quarantine*"))
    for p in sorted(os.listdir(dst)):
        if p.startswith("step_") and int(p[5:]) > 2:
            shutil.rmtree(dst / p)
    with _trainer(dst, save_every=1000, ranks=survivors) as t2:
        res2 = t2.fit(8)
    assert res2["start"] == 2
    assert res2["losses"] == res["losses"][2:]
    assert tdat.live_ids() == []
    assert tm.memory.live_bytes() == 0


def test_chaos_soak_replay_is_deterministic(tmp_path):
    def history():
        return [dict(f, labels={k: v for k, v in f["labels"].items()
                                if k != "path"})
                for f in faults.history()]
    res1, _ = _soak(tmp_path / "a", _PLAN, seed=42)
    h1 = history()
    res2, _ = _soak(tmp_path / "b", _PLAN, seed=42)
    h2 = history()
    assert res1["losses"] == res2["losses"]
    assert h1 == h2 and len(h1) == 2


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------


def test_train_step_spans_are_stamped():
    ev0 = len(tm.events())
    with _trainer() as t:
        t.fit(3)
    events = tm.events()[ev0:]
    spans = [e for e in events if e.get("cat") == "span"]
    steps = [e for e in spans if e.get("name") == "train.step"]
    assert len(steps) == 3
    for e in steps:
        labels = e.get("labels") or {}
        assert float(labels.get("bytes_ici", 0)) > 0
        assert float(labels.get("flops", 0)) > 0
        assert labels.get("ranks") == 8
    for name in ("train.grad", "train.sync"):
        assert len([e for e in spans if e.get("name") == name]) == 3
    assert tm.gauge_value("train.step_s") > 0
    cost = tm.perf.train_step_cost(n_params=100, p=4, flops=7.0,
                                   batch_bytes=10, nslots=2)
    assert cost == {"flops": 7.0, "bytes_hbm": 7 * 400 + 10,
                    "bytes_ici": 2 * 3 * 400}


def test_transformer_task_runtime_matches_one_uninterrupted_run(tmp_path):
    task = TTasks.transformer_task(vocab=32, dim=16, heads=2, layers=1,
                                   seq=8, batch_size=16)
    with _trainer(tmp_path / "a", task=task, optimizer=adam(3e-3),
                  ranks=[0, 1, 2, 3]) as t:
        full = t.fit(4)["losses"]
    with _trainer(tmp_path / "b", task=task, optimizer=adam(3e-3),
                  ranks=[0, 1, 2, 3]) as t:
        t.fit(2)
    with _trainer(tmp_path / "b", task=task, optimizer=adam(3e-3),
                  ranks=[0, 1, 2, 3]) as t:
        res = t.fit(4)
    assert res["losses"] == full[2:]
    assert full[-1] < full[0]
