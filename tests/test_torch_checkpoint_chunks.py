"""The port's chunked checkpoint store (``store="chunks"``) against the JAX
package's chunked tier (``store="orbax"``).

Orbax is a JAX library, so the port writes a store of its own: one raw
file a cell of a DArray's grid (``chunks/<key>.<j>.bin``), one ``.npy`` a
other array leaf, and JAX's ``dartpu_meta.json`` with one CRC32 a file.
The same host inputs go through JAX's ``save(store="orbax")`` -> ``load``
and the port's ``save(store="chunks")`` -> ``load``; the restored values
(bit for bit) and layouts (``procs``, ``dist``, ``cuts``) must agree on
five layouts and seven dtypes.  The manager's cases (interrupted write,
corrupt read, rotation, rewind, quarantine, async snapshot) follow
``tests/test_torch_checkpoint.py``'s on the npz store.
"""

import json

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import distributedarrays_tpu as dat
from distributedarrays_tpu.utils import checkpoint as JC
import distributedarrays_tpu_torch as tdat
from distributedarrays_tpu_torch import telemetry as tm
from distributedarrays_tpu_torch.resilience import elastic, faults
from distributedarrays_tpu_torch.utils import checkpoint as TC

from _torch_port import jax_plan_cache, jax_process_state, port_ranks  # noqa: F401


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


# (shape, procs, dist): the layouts of the probes, uneven cuts included
LAYOUTS = {"37x11_4x2": ((37, 11), range(8), (4, 2)),
           "37x11_3ranks": ((37, 11), range(3), None),
           "50x8_4x2": ((50, 8), range(8), (4, 2)),
           "9x13_2x4": ((9, 13), range(8), (2, 4)),
           "8229": ((8229,), range(8), None)}
DTYPES = ["float32", "float16", "bfloat16", "int8", "uint8", "bool",
          "complex64"]


def _host(shape, dtype: str, seed: int = 0) -> np.ndarray:
    """Seeded host values of ``dtype`` (bfloat16 as ml_dtypes)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * 20
    if dtype == "bool":
        return x > 0
    if dtype == "complex64":
        return (x + 1j * rng.standard_normal(shape)).astype(np.complex64)
    if dtype == "bfloat16":
        return x.astype(np.float32).astype(ml_dtypes.bfloat16)
    if dtype in ("int8", "uint8"):
        return np.clip(x, -100, 100).astype(np.int16).astype(dtype)
    return x.astype(dtype)


def _port_tensor(host: np.ndarray) -> torch.Tensor:
    if host.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(host.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(host.copy())


def _bits(x) -> np.ndarray:
    """The raw bytes of a restored array, for a bit-for-bit comparison."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return x.reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def _layout(d) -> dict:
    return {"procs": [int(p) for p in np.asarray(d.pids).flat],
            "dist": list(np.asarray(d.pids).shape),
            "cuts": [list(map(int, c)) for c in d.cuts]}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_chunks_round_trip_matches_jax_orbax(tmp_path, layout, dtype):
    shape, procs, dist = LAYOUTS[layout]
    host = _host(shape, dtype)
    jd = dat.distribute(jnp.asarray(host), procs=procs, dist=dist)
    JC.save(tmp_path / "jax", {"d": jd, "step": 5}, store="orbax")
    jback = JC.load(tmp_path / "jax")
    pd = tdat.distribute(_port_tensor(host), procs=procs, dist=dist)
    TC.save(tmp_path / "port", {"d": pd, "step": 5}, store="chunks")
    pback = TC.load(tmp_path / "port")
    assert pback["step"] == jback["step"] == 5
    assert _layout(pback["d"]) == _layout(jback["d"]) == _layout(pd)
    want = np.asarray(jback["d"])
    got = pback["d"].full(torch.device("cpu"))
    assert str(pback["d"].dtype).removeprefix("torch.") == \
        str(want.dtype).replace("bool_", "bool")
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # one file a cell, each holding exactly its box's bytes
    files = sorted((tmp_path / "port" / "chunks").glob("a0.*.bin"))
    assert len(files) == len(_layout(pd)["procs"])
    for ci in pd.cells():
        j = int(np.ravel_multi_index(ci, pd.pids.shape)) if ci else 0
        raw = (tmp_path / "port" / "chunks" / f"a0.{j}.bin").read_bytes()
        assert raw == bytes(_bits(pd.part(ci)))


def test_chunks_layout_on_disk_and_leaves(tmp_path):
    a = _host((37, 11), "float32")
    d = tdat.distribute(torch.from_numpy(a), procs=range(8), dist=(4, 2))
    bf = torch.linspace(-3, 3, 10).to(torch.bfloat16).reshape(2, 5)
    dd = tdat.ddata(init=lambda i: {"i": i, "t": torch.full((2,), float(i))},
                    pids=[0, 1, 2])
    tree = {"d": d, "bf": bf, "np": np.arange(5, dtype=np.int64),
            "s": np.float32(2.5), "t": (1, "x", None), "dd": dd,
            "k": {3: "three"}}
    TC.save(tmp_path / "c", tree, store="chunks")
    meta = json.loads((tmp_path / "c" / "dartpu_meta.json").read_text())
    assert meta["__dartpu_store__"] == "chunks"
    ent = meta["tree"]["d"]
    assert ent["dtype"] == "float32" and ent["shape"] == [37, 11]
    assert ent["procs"] == list(range(8)) and ent["dist"] == [4, 2]
    names = sorted(p.name for p in (tmp_path / "c" / "chunks").iterdir())
    crcs = meta["integrity"]["crc32"]
    assert sorted(crcs) == sorted(n.rsplit(".", 1)[0] for n in names)
    assert not (tmp_path / "c" / "arrays.npz").exists()
    out = TC.load(tmp_path / "c")
    np.testing.assert_array_equal(tdat.gather(out["d"]), a)
    assert out["bf"].dtype == torch.bfloat16 and torch.equal(out["bf"], bf)
    np.testing.assert_array_equal(out["np"], np.arange(5))
    assert out["s"] == np.float32(2.5) and out["t"] == (1, "x", None)
    assert [p["i"] for p in out["dd"].gather()] == [0, 1, 2]
    assert out["k"] == {3: "three"}


def test_chunks_restore_onto_a_smaller_rank_table(tmp_path):
    # the default layout over the smaller table, each new cell read from
    # the saved cells that hold its region
    a = _host((37, 11), "float32")
    TC.save(tmp_path / "c", {"d": tdat.distribute(
        torch.from_numpy(a), procs=range(8), dist=(4, 2))}, store="chunks")
    tdat.init(nranks=3, device="cpu")
    with pytest.warns(UserWarning, match="default"):
        out = TC.load(tmp_path / "c")["d"]
    assert out.cuts == dat.distribute(a, procs=range(3)).cuts
    np.testing.assert_array_equal(tdat.gather(out), a)


def test_orbax_refused_naming_chunks(tmp_path):
    with pytest.raises(ValueError, match="Orbax.*chunks"):
        TC.save(tmp_path / "o", {"x": 1}, store="orbax")
    # a directory JAX's Orbax tier wrote: the port refuses it the same way
    JC.save(tmp_path / "j", {"x": jnp.arange(4.0)}, store="orbax")
    with pytest.raises(ValueError, match="Orbax.*chunks"):
        TC.load(tmp_path / "j")
    with pytest.raises(ValueError, match="unknown store"):
        TC.CheckpointManager(tmp_path / "m", store="zarr")


def test_chunks_corrupt_read_raises_integrity_error(tmp_path):
    d = tdat.distribute(torch.arange(64.0).reshape(8, 8))
    TC.save(tmp_path / "c", {"d": d, "v": np.arange(6)}, store="chunks")
    faults.configure(plan=[{"site": "checkpoint.read", "action": "corrupt",
                            "at": 1, "count": 1}], seed=3)
    f0 = tm.counter_value("checkpoint.integrity_failures")
    with pytest.raises(TC.CheckpointIntegrityError):
        TC.load(tmp_path / "c")
    assert tm.counter_value("checkpoint.integrity_failures") == f0 + 1
    faults.clear()
    # disk rot in one cell file is caught by its CRC; a missing file too
    cell = tmp_path / "c" / "chunks" / "a0.3.bin"
    raw = bytearray(cell.read_bytes())
    raw[5] ^= 0xFF
    cell.write_bytes(bytes(raw))
    with pytest.raises(TC.CheckpointIntegrityError, match="a0.3"):
        TC.load(tmp_path / "c")
    cell.unlink()
    with pytest.raises(TC.CheckpointIntegrityError, match="a0.3"):
        TC.load(tmp_path / "c")


def test_chunks_interrupted_write_is_not_published(tmp_path):
    mgr = TC.CheckpointManager(tmp_path, async_save=False, store="chunks")
    mgr.save(1, {"v": np.arange(3), "d": tdat.distribute(torch.ones(9))})
    faults.configure(plan=[{"site": "checkpoint.write", "action": "raise",
                            "at": 1, "count": 1}], seed=0)
    with pytest.raises(faults.InjectedFault):
        mgr.save(2, {"v": np.arange(3) + 1,
                     "d": tdat.distribute(torch.zeros(9))})
    assert mgr.steps() == [1]
    back = mgr.restore()
    np.testing.assert_array_equal(back["v"], np.arange(3))
    np.testing.assert_array_equal(tdat.gather(back["d"]), np.ones(9))
    mgr.close()


def test_chunks_manager_rotation_rewind_and_quarantine(tmp_path):
    mgr = TC.CheckpointManager(tmp_path, max_to_keep=3, async_save=False,
                               store="chunks")
    A = np.arange(64, dtype=np.float32).reshape(8, 8)
    for s in range(5):
        d = tdat.distribute(A + s)
        mgr.save(s, {"x": d, "s": s})
        d.close()
    assert mgr.steps() == [2, 3, 4]
    assert mgr.discard_from(4) == [4] and mgr.steps() == [2, 3]
    q0 = tm.counter_value("checkpoint.quarantines")
    faults.configure(plan=[{"site": "checkpoint.read", "action": "corrupt",
                            "at": 1, "count": 1}], seed=11)
    out = mgr.restore()
    assert out["s"] == 2
    np.testing.assert_array_equal(tdat.gather(out["x"]), A + 2)
    assert tm.counter_value("checkpoint.quarantines") == q0 + 1
    assert mgr.steps() == [2]
    assert (tmp_path / ".quarantine_step_00000003").exists()
    with pytest.raises(ValueError, match="already exists"):
        mgr.save(2, {"s": 2})
    mgr.close()


def test_chunks_async_save_snapshots_inside_save(tmp_path):
    d = tdat.distribute(np.arange(16, dtype=np.float32), dist=(4,))
    t = torch.arange(4.0)
    with TC.CheckpointManager(tmp_path, async_save=True,
                              store="chunks") as mgr:
        mgr.save(0, {"d": d, "t": t})
        for r in range(4):
            d.localpart(r).fill_(-1.0)
        t.fill_(-1.0)
        mgr.wait()
        back = mgr.restore(0)
    np.testing.assert_array_equal(tdat.gather(back["d"]),
                                  np.arange(16, dtype=np.float32))
    np.testing.assert_array_equal(back["t"].numpy(), np.arange(4.0))
