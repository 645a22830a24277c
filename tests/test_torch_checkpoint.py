"""Checkpoints of the PyTorch port (``utils/checkpoint.py``) against the
JAX package: the on-disk format is JAX's, so each package restores what
the other wrote (DArrays on their exact, uneven cuts; bfloat16 leaves as
raw bytes with ``mldtype``), and the manager's integrity, rotation, async,
quarantine and peer-replica behaviour follows ``tests/test_train.py``'s
checkpoint cases.
"""

import json
import zipfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ml_dtypes

import distributedarrays_tpu as dat
from distributedarrays_tpu.darray import darray_from_cuts as jax_darray_from_cuts
import distributedarrays_tpu_torch as tdat
from distributedarrays_tpu.utils import checkpoint as JC
from distributedarrays_tpu_torch import telemetry as tm
from distributedarrays_tpu_torch.resilience import elastic, faults, recovery
from distributedarrays_tpu_torch.utils import checkpoint as TC

from _torch_port import (jax_plan_cache, jax_process_state, port_ranks,  # noqa: F401
                         same_layout)


@pytest.fixture(autouse=True)
def clean(monkeypatch, port_ranks):
    for var in ("DA_TPU_FAULT_PLAN", "DA_TPU_FAULT_SEED"):
        monkeypatch.delenv(var, raising=False)
    faults.clear()
    elastic.manager().reset()
    tm.enable()
    yield
    faults.clear()
    elastic.manager().reset()


def _uneven(seed=0):
    """A (37, 11) array and the uneven cuts it is laid on over 6 ranks."""
    a = np.random.default_rng(seed).standard_normal((37, 11)).astype(
        np.float32)
    return a, [1, 3, 5, 0, 2, 4], [[0, 5, 20, 37], [0, 7, 11]]


def _bf16_bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


# ---------------------------------------------------------------------------
# save / load: every tag
# ---------------------------------------------------------------------------


def test_round_trip_of_every_tag(tmp_path):
    a, procs, cuts = _uneven()
    d = tdat.darray_from_cuts(torch.from_numpy(a), procs, cuts)
    dd = tdat.ddata(init=lambda i: {"i": i, "t": torch.full((2,), float(i))},
                    pids=[0, 1, 2])
    bf = torch.linspace(-3, 3, 10).to(torch.bfloat16).reshape(2, 5)
    tree = {"d": d, "dd": dd, "bf": bf, "i8": torch.arange(6).to(torch.int8),
            "np": np.arange(5, dtype=np.int64), "s": np.float32(2.5),
            "b": np.bool_(True), "t": (1, "x", None), "l": [1.5, True],
            "k": {3: "three", (1, 2): [4]}, "nested": {"__dartpu__": 1}}
    TC.save(tmp_path / "c", tree)
    out = TC.load(tmp_path / "c")
    assert isinstance(out["d"], tdat.DArray)
    assert out["d"].cuts == cuts and \
        [int(p) for p in out["d"].pids.flat] == procs
    np.testing.assert_array_equal(tdat.gather(out["d"]), a)
    assert isinstance(out["dd"], tdat.DData)
    assert [p["i"] for p in out["dd"].gather()] == [0, 1, 2]
    assert torch.equal(out["dd"].gather()[2]["t"], torch.full((2,), 2.0))
    assert out["bf"].dtype == torch.bfloat16 and torch.equal(out["bf"], bf)
    assert out["i8"].dtype == torch.int8
    assert isinstance(out["np"], np.ndarray) and out["np"].dtype == np.int64
    assert type(out["s"]) is np.float32 and out["s"] == 2.5
    assert type(out["b"]) is np.bool_
    assert out["t"] == (1, "x", None) and out["l"] == [1.5, True]
    assert out["k"] == {3: "three", (1, 2): [4]}
    assert out["nested"] == {"__dartpu__": 1}
    # the metadata is JAX's: tags, store, CRC32 of every payload
    meta = json.loads((tmp_path / "c" / "dartpu_meta.json").read_text())
    assert meta["__dartpu_store__"] == "npz"
    assert meta["tree"]["d"]["__dartpu__"] == "DArray"
    bf_entry = dict(meta["tree"]["bf"])
    assert bf_entry.pop("key") in meta["integrity"]["crc32"]
    assert bf_entry == {"__dartpu__": "ndarray", "jax": True,
                        "mldtype": "bfloat16", "shape": [2, 5]}
    # d, dd's three tensors, bf, i8, np
    assert set(meta["integrity"]["crc32"]) == {f"a{i}" for i in range(7)}


def test_jax_written_checkpoint_restores_in_the_port(tmp_path):
    a, procs, cuts = _uneven(1)
    jd = jax_darray_from_cuts(a, procs, cuts)
    bf = np.linspace(-2, 2, 12).astype(ml_dtypes.bfloat16).reshape(3, 4)
    JC.save(tmp_path / "j", {
        "d": jd, "x": jnp.arange(6, dtype=jnp.float32), "bf": jnp.asarray(bf),
        "nbf": bf, "n": np.arange(3), "s": np.int32(7), "t": (1, 2),
        "k": {1: "a"}, "step": 4})
    out = TC.load(tmp_path / "j")
    same_layout(jd, out["d"])
    np.testing.assert_array_equal(tdat.gather(out["d"]), a)
    assert isinstance(out["x"], torch.Tensor) and \
        out["x"].device == tdat.device_of(0)
    assert out["bf"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bf16_bits(out["bf"]), _bf16_bits(bf))
    # a numpy bf16 leaf has no numpy form without ml_dtypes: a CPU tensor
    assert out["nbf"].dtype == torch.bfloat16 and \
        out["nbf"].device.type == "cpu"
    np.testing.assert_array_equal(_bf16_bits(out["nbf"]), _bf16_bits(bf))
    np.testing.assert_array_equal(out["n"], np.arange(3))
    assert type(out["s"]) is np.int32 and out["t"] == (1, 2)
    assert out["k"] == {1: "a"} and out["step"] == 4


def test_port_written_checkpoint_restores_in_jax(tmp_path):
    a, procs, cuts = _uneven(2)
    d = tdat.darray_from_cuts(torch.from_numpy(a), procs, cuts)
    bf = torch.linspace(-1, 1, 8).to(torch.bfloat16)
    TC.save(tmp_path / "p", {"d": d, "x": torch.ones(3, 2), "bf": bf,
                             "n": np.arange(4, dtype=np.int16),
                             "dd": tdat.ddata(init=lambda i: i, pids=[0, 1]),
                             "k": {2.5: (1,)}})
    out = JC.load(tmp_path / "p")
    same_layout(out["d"], d)
    np.testing.assert_array_equal(np.asarray(out["d"]), a)
    np.testing.assert_array_equal(np.asarray(out["x"]), np.ones((3, 2)))
    assert out["bf"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(_bf16_bits(out["bf"]), _bf16_bits(bf))
    assert out["n"].dtype == np.int16
    assert out["dd"].gather() == [0, 1] and out["k"] == {2.5: (1,)}
    out["d"].close()
    out["dd"].close()


def test_bf16_darray_round_trips_in_the_port(tmp_path):
    # JAX's own bf16 DArray checkpoint does not load back (ROADMAP C); the
    # port stores the payload's raw bytes with mldtype and restores it
    d = tdat.drandn((9, 4), dist=(3, 1)).astype(torch.bfloat16)
    TC.save(tmp_path / "b", {"d": d})
    out = TC.load(tmp_path / "b")["d"]
    assert out.dtype == torch.bfloat16 and out.cuts == d.cuts
    assert torch.equal(out.full(), d.full())


def test_restore_onto_a_smaller_rank_table_warns_and_takes_the_default(
        tmp_path):
    a = np.arange(40, dtype=np.float32).reshape(8, 5)
    TC.save(tmp_path / "c", {"d": tdat.distribute(a, dist=(8, 1))})
    tdat.init(nranks=4, device="cpu")
    with pytest.warns(UserWarning, match="default"):
        out = TC.load(tmp_path / "c")["d"]
    assert out.cuts == [[0, 4, 8], [0, 3, 5]]
    np.testing.assert_array_equal(tdat.gather(out), a)


def test_orbax_and_unknown_stores_and_dtypes_are_refused(tmp_path):
    with pytest.raises(ValueError, match="Orbax"):
        TC.save(tmp_path / "o", {"x": 1}, store="orbax")
    with pytest.raises(ValueError, match="unknown store"):
        TC.save(tmp_path / "o", {"x": 1}, store="zarr")
    assert not (tmp_path / "o").exists()
    with pytest.raises(ValueError, match="Orbax"):
        TC.CheckpointManager(tmp_path / "m").save(0, {}, store="orbax")
    TC.save(tmp_path / "c", {"bf": torch.ones(2, dtype=torch.bfloat16)})
    meta_p = tmp_path / "c" / "dartpu_meta.json"
    meta = json.loads(meta_p.read_text())
    meta["tree"]["bf"]["mldtype"] = "float4_e2m1fn_x2_not_a_dtype"
    meta_p.write_text(json.dumps(meta))
    with pytest.raises(TypeError, match="float4"):
        TC.load(tmp_path / "c")
    with pytest.raises(TypeError, match="cannot checkpoint"):
        TC.save(tmp_path / "x", {"f": object()})


# ---------------------------------------------------------------------------
# integrity: CRC, quarantine, fallback
# ---------------------------------------------------------------------------


def test_corrupt_restore_quarantines_and_falls_back(tmp_path):
    A = np.arange(64, dtype=np.float32).reshape(8, 8)
    mgr = TC.CheckpointManager(tmp_path, async_save=False)
    d = tdat.distribute(A.copy())
    mgr.save(0, {"x": d, "tag": "old"})
    mgr.save(1, {"x": d, "tag": "new"})
    d.close()
    q0 = tm.counter_value("checkpoint.quarantines")
    f0 = tm.counter_value("checkpoint.restore_fallbacks")
    faults.configure(plan=[
        {"site": "checkpoint.read", "action": "corrupt", "at": 1,
         "count": 1}], seed=11)
    out = mgr.restore()
    assert out["tag"] == "old"
    np.testing.assert_array_equal(tdat.gather(out["x"]), A)
    assert tm.counter_value("checkpoint.quarantines") == q0 + 1
    assert tm.counter_value("checkpoint.restore_fallbacks") == f0 + 1
    assert mgr.steps() == [0]
    assert (tmp_path / ".quarantine_step_00000001").exists()
    mgr.close()


def test_explicit_step_stays_strict_and_disk_rot_is_caught(tmp_path):
    mgr = TC.CheckpointManager(tmp_path / "m", async_save=False)
    mgr.save(3, {"v": np.arange(6)})
    faults.configure(plan=[
        {"site": "checkpoint.read", "action": "corrupt", "at": 1,
         "count": 1}], seed=2)
    with pytest.raises(TC.CheckpointIntegrityError):
        mgr.restore(3)
    mgr.close()
    faults.clear()
    TC.save(tmp_path / "c", {"v": np.arange(100, dtype=np.int64)})
    npz = tmp_path / "c" / "arrays.npz"
    raw = bytearray(npz.read_bytes())
    raw[400] ^= 0xFF
    npz.write_bytes(bytes(raw))
    with pytest.raises((TC.CheckpointIntegrityError, zipfile.BadZipFile,
                        OSError)):
        TC.load(tmp_path / "c")
    # metadata with no integrity section restores unverified
    TC.save(tmp_path / "o", {"v": np.arange(4)})
    meta = json.loads((tmp_path / "o" / "dartpu_meta.json").read_text())
    del meta["integrity"]
    (tmp_path / "o" / "dartpu_meta.json").write_text(json.dumps(meta))
    np.testing.assert_array_equal(TC.load(tmp_path / "o")["v"], np.arange(4))


def test_all_corrupt_store_surfaces_through_recovery(tmp_path):
    mgr = TC.CheckpointManager(tmp_path, async_save=False, max_to_keep=None)
    mgr.save(1, {"v": np.arange(8)})
    mgr.save(2, {"v": np.arange(8)})
    faults.configure(plan=[
        {"site": "checkpoint.read", "action": "corrupt", "at": 1,
         "count": -1}], seed=4)

    def boom():
        raise ValueError("flaky")

    with pytest.raises(FileNotFoundError, match="no restorable"):
        recovery.run_with_recovery(
            boom, policy=recovery.RetryPolicy(base_delay=0.005,
                                              max_delay=0.02),
            checkpoints=mgr, restore_fn=lambda tree: None)
    assert mgr.steps() == []
    mgr.close()


def test_interrupted_write_is_not_published(tmp_path):
    mgr = TC.CheckpointManager(tmp_path, async_save=False)
    mgr.save(1, {"v": np.arange(3)})
    faults.configure(plan=[
        {"site": "checkpoint.write", "action": "raise", "at": 1,
         "count": 1}], seed=0)
    with pytest.raises(faults.InjectedFault):
        mgr.save(2, {"v": np.arange(3) + 1})
    assert mgr.steps() == [1]
    np.testing.assert_array_equal(mgr.restore()["v"], np.arange(3))
    mgr.close()


# ---------------------------------------------------------------------------
# the manager: rotation, async, rewind
# ---------------------------------------------------------------------------


def test_rotation_keeps_the_newest_steps(tmp_path):
    mgr = TC.CheckpointManager(tmp_path, max_to_keep=2, async_save=False)
    for s in range(4):
        mgr.save(s, {"s": s})
    assert mgr.steps() == [2, 3] and mgr.latest_step() == 3
    assert mgr.restore()["s"] == 3
    with pytest.raises(ValueError, match="already exists"):
        mgr.save(3, {"s": 3})
    with pytest.raises(ValueError, match="max_to_keep"):
        TC.CheckpointManager(tmp_path / "x", max_to_keep=0)
    assert mgr.discard_from(3) == [3] and mgr.steps() == [2]
    mgr.close()


def test_async_save_snapshots_inside_save(tmp_path):
    d = tdat.distribute(np.arange(16, dtype=np.float32), dist=(4,))
    t = torch.arange(3.0)
    n = np.arange(4)
    with TC.CheckpointManager(tmp_path, async_save=True) as mgr:
        mgr.save(1, {"d": d, "t": t, "n": n})
        # the caller may write its buffers at once: the snapshot is taken
        d.fill_(-1.0)
        t.fill_(-1.0)
        n[:] = -1
        mgr.wait()
        assert mgr.steps() == [1]
        out = mgr.restore()
    np.testing.assert_array_equal(tdat.gather(out["d"]), np.arange(16))
    assert torch.equal(out["t"], torch.arange(3.0))
    np.testing.assert_array_equal(out["n"], np.arange(4))


# ---------------------------------------------------------------------------
# peer replicas
# ---------------------------------------------------------------------------


def test_peer_replica_restore_reads_nothing_from_disk(tmp_path):
    a = np.arange(64, dtype=np.float32).reshape(16, 4)
    d = tdat.distribute(a, procs=[0, 1, 2, 3], dist=(4, 1))
    store = TC.PeerReplicaStore()
    mgr = TC.CheckpointManager(tmp_path, async_save=False, replicas=store)
    mgr.save(2, {"d": d, "step": 2})
    assert store.steps() == [2]
    elastic.manager().mark_down(3)
    disk0 = tm.counter_value("checkpoint.disk_reads")
    peer0 = tm.counter_value("checkpoint.restore_source", source="peer")
    fetch0 = tm.counter_value("checkpoint.peer_fetches")
    out = mgr.restore()
    assert tm.counter_value("checkpoint.disk_reads") == disk0
    assert tm.counter_value("checkpoint.restore_source",
                            source="peer") == peer0 + 1
    # rank 3's chunk came from its buddy
    assert tm.counter_value("checkpoint.peer_fetches") == fetch0 + 1
    np.testing.assert_array_equal(tdat.gather(out["d"]), a)
    assert out["d"].cuts == d.cuts
    # the rewind drops the replica tier too
    assert mgr.discard_from(2) == [2] and store.steps() == []
    mgr.close()


def test_peer_replica_unavailable_falls_back_to_disk(tmp_path):
    from distributedarrays_tpu_torch.resilience import domains
    a = np.arange(32, dtype=np.float32)
    d = tdat.distribute(a, procs=[0, 1, 2, 3], dist=(4,))
    store = TC.PeerReplicaStore()
    info = store.put(5, TC._encode({"d": d}, arrays := {}), arrays)
    assert info["chunks"] == 4 and info["bytes"] == a.nbytes
    bmap = domains.buddy_map(list(range(8)))
    owner = 1
    dead = [owner, bmap[owner]]
    with pytest.raises(TC.PeerReplicaUnavailable, match="both down"):
        store.fetch(5, live_ranks=[r for r in range(8) if r not in dead])
    with pytest.raises(KeyError):
        store.fetch(6)
    mgr = TC.CheckpointManager(tmp_path, async_save=False, replicas=store)
    mgr.save(7, {"d": d})
    for r in dead:
        elastic.manager().mark_down(r)
    disk0 = tm.counter_value("checkpoint.disk_reads")
    fb0 = tm.counter_value("checkpoint.replica_fallbacks")
    out = mgr.restore()
    assert tm.counter_value("checkpoint.replica_fallbacks") == fb0 + 1
    assert tm.counter_value("checkpoint.disk_reads") == disk0 + 1
    np.testing.assert_array_equal(tdat.gather(out["d"]), a)
    mgr.close()


def test_corrupt_replica_chunk_is_dropped(tmp_path):
    d = tdat.distribute(np.arange(8, dtype=np.float32), procs=[0, 1],
                        dist=(2,))
    store = TC.PeerReplicaStore()
    mgr = TC.CheckpointManager(tmp_path, async_save=False, replicas=store)
    mgr.save(1, {"d": d})
    ch = store._steps[1]["chunks"][("a0", 0)]
    ch["data"] = bytes([ch["data"][0] ^ 0xFF]) + ch["data"][1:]
    with pytest.raises(TC.CheckpointIntegrityError):
        store.fetch(1)
    out = mgr.restore()                      # falls back to disk
    np.testing.assert_array_equal(tdat.gather(out["d"]), np.arange(8))
    assert store.steps() == []
    mgr.close()


# ---------------------------------------------------------------------------
# the persisted tuning registry (utils/autotune.py)
# ---------------------------------------------------------------------------


@pytest.fixture
def tune_cache(tmp_path, monkeypatch):
    from distributedarrays_tpu.utils import autotune as JA
    from distributedarrays_tpu_torch.utils import autotune as TA
    path = tmp_path / "cache.json"
    monkeypatch.setenv("DAT_TORCH_AUTOTUNE_CACHE", str(path))
    # the JAX registry is process-wide, and its own tests read its lazily
    # loaded seed: put back its entries and its loaded flag
    saved = ({k: dict(v) for k, v in JA._REGISTRY.items()},
             {k: dict(v) for k, v in JA._PROVENANCE.items()}, list(JA._UNDO),
             JA._LOADED_ENV, TA._LOADED_ENV)
    TA.clear()
    yield TA, JA, path
    TA.clear()
    JA.clear()
    JA._REGISTRY.update(saved[0])
    JA._PROVENANCE.update(saved[1])
    JA._UNDO.extend(saved[2])
    JA._LOADED_ENV, TA._LOADED_ENV = saved[3], saved[4]


def test_autotune_sweep_persist_and_lazy_load(tune_cache):
    TA, JA, path = tune_cache
    times = {(64, 64): 3.0, (128, 64): 1.0, (128, 128): 2.0}

    def timer(cfg):
        if cfg == (256, 256):
            raise ValueError("does not fit")
        return times[cfg]
    key = TA.device_key_for(1024, "f32")
    assert key.endswith("|cpu|cpu")
    best, res = TA.sweep("blocks", key, [(64, 64), (256, 256), (128, 64),
                                         (128, 128)], timer, persist=True)
    assert best == (128, 64) and set(res) == set(times)
    assert TA.get("blocks", key) == (128, 64)
    # the file is the JAX registry's format: JAX reads it
    JA.clear()
    JA.load(str(path))
    assert tuple(JA.get("blocks", key)) == (128, 64)
    # a new process reads it lazily on its first lookup
    TA.clear()
    TA._LOADED_ENV = False
    assert TA.get("blocks", key) == [128, 64]
    assert TA.valid_ints(TA.get("blocks", key), (2,)) == (128, 64)
    assert TA.valid_ints("12", (2,)) is None
    assert TA.valid_ints([0, 4], (2,)) is None
    assert TA.default_cache_path() == str(path)
    with pytest.raises(ValueError, match="does not fit"):
        TA.sweep("blocks", key, [(256, 256)], timer)


def test_autotune_provenance_and_undo_like_jax(tune_cache, tmp_path):
    TA, JA, _ = tune_cache
    for A in (TA, JA):
        A.clear()
        A.record("impl", "k", "xla")
        A.record("impl", "k", "pallas", provenance={"source": "advisor",
                                                    "evidence": {"ms": 2}})
        A.record("impl", "k2", 3, provenance={"source": "advisor"})
    assert TA.provenance_for("impl", "k") == JA.provenance_for("impl", "k")
    assert TA.provenance_table() == JA.provenance_table()
    assert len(TA.undo_log()) == len(JA.undo_log()) == 2
    for A in (TA, JA):
        assert A.undo("impl", "k") is True
        assert A.get("impl", "k") == "xla"
        assert A.provenance_for("impl", "k") is None
        assert A.undo("impl", "k2") is True
        assert A.get("impl", "k2") is None
        assert A.undo("impl", "k") is False
    # a stamp survives save and load in either package
    TA.record("impl", "k3", "ring", provenance={"source": "sweep"})
    TA.save(str(tmp_path / "t.json"))
    JA.clear()
    JA.load(str(tmp_path / "t.json"))
    assert JA.provenance_for("impl", "k3") == {"source": "sweep"}
    JA.record("impl", "k4", [8, 8], provenance={"source": "jax"})
    JA.save(str(tmp_path / "j.json"))
    TA.clear()
    TA.load(str(tmp_path / "j.json"))
    assert TA.get("impl", "k4") == [8, 8]
    assert TA.provenance_for("impl", "k4") == {"source": "jax"}
    (tmp_path / "bad.json").write_text("[1, 2]")
    with pytest.raises(ValueError, match="not a JSON object"):
        TA.load(str(tmp_path / "bad.json"))
