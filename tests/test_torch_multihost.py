"""The port's ``parallel/multihost.py`` against the JAX package's.

The control plane's pure parts (``_init_timeout_kw``, ``global_mesh``,
the single-process no-ops) are compared call for call.  The cross-process
half only exists with several processes, so the port's side runs real
jobs: 2 (and 3) OS processes of ``tests/_torch_multihost_child.py``, 4 CPU
ranks each, joined through a ``FileStore`` in a temporary directory.  What
they saw is held against the JAX package run single-controller on its
8-device CPU mesh (values to 1e-6 relative, layouts exactly: the
reference's multi-process results are its single-process ones) and
against the port run in one process on the same number of ranks (bit for
bit: the reductions fold the same partials in the same order).  Every
child is bounded by a timeout, so nothing can hang the suite.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import distributedarrays_tpu as dat
from distributedarrays_tpu.parallel import multihost as JM
from distributedarrays_tpu.telemetry import cluster as JCL

import distributedarrays_tpu_torch as tdat
from distributedarrays_tpu_torch.parallel import multihost as TM
from distributedarrays_tpu_torch.telemetry import cluster as TCL

from _torch_port import (emulated_copies, jax_plan_cache,  # noqa: F401
                         jax_process_state, port_ranks)

_CHILD = os.path.join(os.path.dirname(__file__), "_torch_multihost_child.py")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STALE_S = 3.0
JOB_TIMEOUT_S = 150
_JOB_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
            "DA_TPU_DOMAINS", "DA_TPU_TELEMETRY", "DA_TPU_MH_INIT_TIMEOUT_S")


def _env() -> dict:
    env = {k: v for k, v in os.environ.items() if k not in _JOB_ENV}
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _run_job(out_dir, nprocs: int) -> list[dict]:
    store = os.path.join(out_dir, "store")
    procs = [subprocess.Popen(
        [sys.executable, _CHILD, store, str(i), str(nprocs), str(out_dir),
         str(STALE_S)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=_env()) for i in range(nprocs)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=JOB_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"port multi-process children hung; output so far: "
                    f"{outs}")
    for i, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode == 4 and "MULTIHOST_STARTUP_FAILED" in out:
            pytest.fail(f"job formation failed (process {i}, bounded "
                        f"init timeout):\n{out}")
        assert p.returncode == 0, f"process {i} failed:\n{out}"
        assert f"MULTIHOST_OK proc={i}" in out, out
    res = []
    for i in range(nprocs):
        with open(os.path.join(out_dir, f"result_{i}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    for i in range(nprocs):
        res[i]["journal"] = os.path.join(out_dir, f"journal_{i}.jsonl")
    return res


@pytest.fixture(scope="module")
def job2(tmp_path_factory):
    return _run_job(tmp_path_factory.mktemp("port_mh2"), 2)


@pytest.fixture(scope="module")
def job3(tmp_path_factory):
    return _run_job(tmp_path_factory.mktemp("port_mh3"), 3)


def _layout(d) -> dict:
    return {"cuts": [list(c) for c in d.cuts], "pids": d.pids.tolist()}


X = np.linspace(-1.0, 1.0, 64, dtype=np.float32).reshape(16, 4)
Y = np.cos(np.arange(64, dtype=np.float32)).reshape(16, 4)
U = np.arange(50.0 * 8, dtype=np.float32).reshape(50, 8)


def _port_chain():
    """The children's ``chain`` on the single-process port's table."""
    dx, dy = tdat.distribute(X), tdat.distribute(Y)
    return dx, tdat.dmap(torch.sin, dx) + dy * dx


# ---------------------------------------------------------------------------
# the control plane, single-process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arg,env", [
    (None, None), (5, None), (None, "7"), (None, "2.5"), (None, "bad"),
    (0, None), (3, "9"), (None, "")])
def test_init_timeout_kw_parity(monkeypatch, arg, env):
    if env is None:
        monkeypatch.delenv("DA_TPU_MH_INIT_TIMEOUT_S", raising=False)
    else:
        monkeypatch.setenv("DA_TPU_MH_INIT_TIMEOUT_S", env)
    assert TM._init_timeout_kw(arg) == JM._init_timeout_kw(arg)


def test_initialize_no_cluster_degrades_to_single_process():
    # a fresh process: initialize() with nothing configured is a no-op,
    # then the KV helpers are the no-ops JAX's are single-process, and
    # gather_global is gather; a partial torchrun environment raises
    prog = (
        "import os\n"
        "import numpy as np\n"
        "import distributedarrays_tpu_torch as tdat\n"
        "from distributedarrays_tpu_torch.parallel import multihost as M\n"
        "os.environ['WORLD_SIZE'] = '2'\n"
        "try:\n"
        "    M.initialize()\n"
        "except ValueError as e:\n"
        "    assert 'MASTER_ADDR' in str(e), e\n"
        "else:\n"
        "    raise AssertionError('a partial environment must raise')\n"
        "del os.environ['WORLD_SIZE']\n"
        "M.initialize()\n"
        "tdat.init(nranks=8, device='cpu')\n"
        "info = M.process_info()\n"
        "assert info == {'process_index': 0, 'process_count': 1,\n"
        "                'local_devices': 8, 'global_devices': 8}, info\n"
        "d = tdat.drand((50, 8), dist=(4, 2))\n"
        "assert np.array_equal(M.gather_global(d), tdat.gather(d))\n"
        "M.sync_hosts('x')\n"
        "print('SINGLE', M.heartbeat(), sorted(M.down_peer_processes()),\n"
        "      M.quorum_assess()['verdict'], M.exchange_clock_offsets(),\n"
        "      M.advertise_aggregator('u'), M.aggregator_endpoint(),\n"
        "      M.advertise_exporter())\n")
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       text=True, timeout=120, env=_env())
    assert r.returncode == 0, r.stdout + r.stderr
    jax_said = ("SINGLE", JM.heartbeat(), sorted(JM.down_peer_processes()),
                JM.quorum_assess()["verdict"], JM.exchange_clock_offsets(),
                JM.advertise_aggregator("u"), JM.aggregator_endpoint(),
                JM.advertise_exporter())
    assert r.stdout.strip().splitlines()[-1] == " ".join(
        str(x) for x in jax_said)


@pytest.mark.parametrize("args", [(), ("file:///nonexistent/store", 2, 0)])
def test_initialize_with_live_table_raises(args):
    # the fixture built the rank table: joining a job now would leave it
    # describing one process, so initialize refuses before touching a
    # store (JAX: test_initialize_backend_already_live_raises)
    with pytest.raises(RuntimeError, match="rank table"):
        TM.initialize(*args)


@pytest.mark.parametrize("shape", [(8,), (2, 4), (4, 2), (1, 8), (2, 2, 2)])
def test_global_mesh_parity(shape):
    names = tuple("abc"[:len(shape)])
    ids = np.vectorize(lambda dev: dev.id)(
        JM.global_mesh(shape, names).devices)
    assert np.array_equal(np.asarray(TM.global_mesh(shape, names)), ids)


@pytest.mark.parametrize("shape", [(3,), (16,), (3, 3)])
def test_global_mesh_size_mismatch_raises(shape):
    names = tuple("ab"[:len(shape)])
    with pytest.raises(ValueError):
        JM.global_mesh(shape, names)
    with pytest.raises(ValueError, match="global ranks"):
        TM.global_mesh(shape, names)


def test_single_process_table_queries():
    assert tdat.layout.process_count() == 1
    assert tdat.layout.local_ranks() == list(range(8))
    assert not tdat.layout.spans_processes(np.arange(8))
    assert [tdat.layout.process_of(r) for r in range(8)] == [0] * 8
    d = tdat.distribute(X)
    assert [p for p, _ in TM.host_local_slice(d)] == list(range(8))
    jd = dat.distribute(X)
    assert [p for p, _ in JM.host_local_slice(jd)] == list(range(8))


# ---------------------------------------------------------------------------
# the kernel route's copies, replayed on the host
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", [
    ("float32", (64, 16), (8, 1)), ("float32", (50, 8), (4, 2)),
    ("bfloat16", (37, 11), (2, 4)), ("int32", (9, 7, 5), (2, 2, 2))])
def test_process_copies_replayed_on_the_host(monkeypatch, case):
    # the cross-process gather's copies on a pretend two-process table:
    # ranks 4-7 belong to process 1, whose "IPC handles" carry their
    # tensors' addresses here; the copy kernel's semantics replayed with
    # memmove must rebuild the whole array
    from distributedarrays_tpu_torch import layout as L
    from distributedarrays_tpu_torch.ops import cuda_collectives as CC
    dt, shape, dist = case
    host = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(
        shape).to(getattr(torch, dt))
    d = tdat.distribute(host, dist=dist)
    monkeypatch.setattr(L, "process_of", lambda r: int(r) // 4)
    monkeypatch.setattr(L, "is_local", lambda r: int(r) < 4)
    monkeypatch.setattr(CC, "ipc_handle", lambda t: (
        t.data_ptr().to_bytes(8, "little"), 0))
    monkeypatch.setattr(CC, "_ipc_base",
                        lambda h, dev: int.from_bytes(h, "little"))
    mine = CC.process_handles(d)
    # process 1's own handles, as it would publish them
    monkeypatch.setattr(L, "is_local", lambda r: int(r) >= 4)
    theirs = CC.process_handles(d)
    monkeypatch.setattr(L, "is_local", lambda r: int(r) < 4)
    assert set(mine).isdisjoint(theirs)
    out = torch.empty(shape, dtype=host.dtype)
    copies = CC.process_copies(d, out, [mine, theirs])
    calls = []
    emulated_copies(calls)(copies, out.device, "all_gather")
    assert calls == [("all_gather", 1)]
    assert torch.equal(out, host)


# ---------------------------------------------------------------------------
# a two-process job: 2 x 4 CPU ranks
# ---------------------------------------------------------------------------


def test_job_layout_and_sum(job2):
    A = np.arange(16.0, dtype=np.float32)
    jd = dat.distribute(A)
    td = tdat.distribute(A)
    for r in job2:
        assert r["A"] == _layout(jd) == _layout(td)
        assert float(r["A_sum"]) == float(dat.dsum(jd))
        assert r["A_sum"].tobytes() == tdat.dsum(td).numpy().tobytes()


def test_job_local_slices(job2):
    A = np.arange(16.0, dtype=np.float32)
    for p, r in enumerate(job2):
        assert r["local_pids"] == list(range(4 * p, 4 * p + 4))
        for k, part in enumerate(r["local_parts"]):
            rank = 4 * p + k
            assert np.array_equal(part, A[2 * rank:2 * rank + 2])
        assert r["remote_localpart"] == "raised"


def test_job_gather_global(job2):
    A = np.arange(16.0, dtype=np.float32)
    for r in job2:
        assert np.array_equal(r["A_gather"], A)
        assert np.array_equal(r["A_asarray"], A)
        assert np.array_equal(r["A_full"], A)


def test_job_memory_ledger_counts_local_chunks(job2):
    # each process tracks its own 4 chunks of 2 float32s, the
    # single-process port all 8
    d = tdat.distribute(np.arange(16.0, dtype=np.float32))
    assert tdat.telemetry.memory.live_bytes() == 64
    del d
    for r in job2:
        assert r["A_live_bytes"] == 32
        assert r["live_after_close"] == 0


@pytest.mark.parametrize("what", ["ew", "chain", "into"])
def test_job_operators(job2, what):
    jx, jy = dat.distribute(X), dat.distribute(Y)
    jfn = {"ew": lambda a, b: jnp.sin(a) * 2 + 1,
           "chain": lambda a, b: jnp.sin(a) + b * a,
           "into": lambda a, b: jnp.cos(a)}[what]
    ref = np.asarray(dat.djit(jfn)(jx, jy))
    dx, chain = _port_chain()
    port = {"ew": tdat.dmap(torch.sin, dx) * 2 + 1, "chain": chain,
            "into": tdat.dmap(torch.cos, dx)}[what]
    for r in job2:
        np.testing.assert_allclose(r[what], ref, rtol=1e-6, atol=1e-6)
        assert np.array_equal(r[what], np.asarray(port))
    assert job2[0]["ew_layout"] == _layout(dat.distribute(X))


REDUCERS = {"sum": (dat.dsum, tdat.dsum), "prod": (dat.dprod, tdat.dprod),
            "max": (dat.dmaximum, tdat.dmaximum),
            "min": (dat.dminimum, tdat.dminimum),
            "mean": (dat.dmean, tdat.dmean)}


@pytest.mark.parametrize("dims", [None, 0, 1])
@pytest.mark.parametrize("name", list(REDUCERS))
def test_job_reductions(job2, name, dims):
    jfn, tfn = REDUCERS[name]
    jchain = dat.djit(lambda a, b: jnp.sin(a) + b * a)(
        dat.distribute(X), dat.distribute(Y))
    _, chain = _port_chain()
    key = name if dims is None else f"{name}_{dims}"
    jr, tr = jfn(jchain, dims=dims), tfn(chain, dims=dims)
    for r in job2:
        got = r["reductions"][key]
        if dims is None:
            np.testing.assert_allclose(got, np.asarray(jr), rtol=1e-6,
                                       atol=1e-7)
            assert got.tobytes() == tr.numpy().tobytes()
        else:
            vals, lay = got
            np.testing.assert_allclose(vals, np.asarray(jr), rtol=1e-6,
                                       atol=1e-7)
            assert np.array_equal(vals, np.asarray(tr))
            assert lay == _layout(jr) == _layout(tr)


def test_job_mapreduce(job2):
    jx, jy = dat.distribute(X), dat.distribute(Y)
    jchain = dat.djit(lambda a, b: jnp.sin(a) + b * a)(jx, jy)
    dx, chain = _port_chain()
    j0 = float(dat.dmapreduce(jnp.square, "sum", jchain))
    j1 = np.asarray(dat.dmapreduce(jnp.square, "sum", jchain, dims=1))
    t0 = tdat.dmapreduce(torch.square, "sum", chain)
    t1 = np.asarray(tdat.dmapreduce(torch.square, "sum", chain, dims=1))
    tAA = tdat.dsum(dx * dx)
    for r in job2:
        red = r["reductions"]
        np.testing.assert_allclose(red["mapreduce"], j0, rtol=1e-6)
        np.testing.assert_allclose(red["mapreduce_1"], j1, rtol=1e-6)
        assert red["mapreduce"].tobytes() == t0.numpy().tobytes()
        assert np.array_equal(red["mapreduce_1"], t1)
        assert red["sum_AA"].tobytes() == tAA.numpy().tobytes()


def test_job_uneven(job2):
    jd = dat.distribute(U, procs=range(8), dist=(4, 2))
    td = tdat.distribute(U, procs=range(8), dist=(4, 2))
    assert [list(map(int, np.diff(jd.cuts[0])))] == [[13, 13, 12, 12]]
    j0 = np.asarray(dat.dsum(jd, dims=0))
    for r in job2:
        assert r["U"] == _layout(jd) == _layout(td)
        assert np.array_equal(r["U_gather"], U)
        assert np.array_equal(r["U2"], U * 2)
        np.testing.assert_allclose(r["U_sum0"], j0, rtol=1e-6)
        assert np.array_equal(r["U_sum0"], np.asarray(tdat.dsum(td, dims=0)))


def test_job_array_on_one_process(job2):
    # ranks 0-3 are process 0's: process 1 holds only placeholders, yet
    # takes part in the reduction and the gather and gets their results
    jd = dat.distribute(X, procs=range(4))
    td = tdat.distribute(X, procs=range(4))
    for r in job2:
        sub = r["subset"]
        assert sub["layout"] == _layout(jd) == _layout(td)
        assert np.array_equal(sub["gather"], X)
        np.testing.assert_allclose(sub["sum"], float(dat.dsum(jd)),
                                   rtol=1e-6)
        assert sub["sum"].tobytes() == tdat.dsum(td).numpy().tobytes()
        assert np.array_equal(sub["sum_0"], np.asarray(tdat.dsum(td, dims=0)))


def test_job_drand_values_follow_the_rank(job2):
    # rank r draws from its own generator, whichever process holds it
    tdat.seed(99)
    ref = np.asarray(tdat.drand((16, 4)))
    for r in job2:
        assert np.array_equal(r["drand"], ref)


CTORS = ["dzeros", "dones", "dfill", "drandn", "drandint", "dfromfunction",
         "darray"]


@pytest.mark.parametrize("name", CTORS)
def test_job_constructors(job2, name):
    # each process fills its own ranks; the drawn ones from the rank's
    # generator, so they equal one process's draws bit for bit
    tdat.seed(5)
    port = {
        "dzeros": lambda: tdat.dzeros((16, 4)),
        "dones": lambda: tdat.dones((16, 4), dtype=torch.int32),
        "dfill": lambda: tdat.dfill(2.5, (16, 4)),
        "drandn": lambda: tdat.drandn((16, 4)),
        "drandint": lambda: tdat.drandint(0, 9, (16, 4)),
        "dfromfunction": lambda: tdat.dfromfunction(
            lambda i, j: i * 10 + j, (16, 4)),
        "darray": lambda: tdat.darray(lambda idx: np.full(
            [len(r) for r in idx], idx[0].start, np.float32), (16, 4)),
    }
    made = {k: f() for k, f in port.items()}      # the children's order
    ref = made[name]
    jax_ref = {
        "dzeros": lambda: dat.dzeros((16, 4)),
        "dones": lambda: dat.dones((16, 4), dtype=jnp.int32),
        "dfill": lambda: dat.dfill(2.5, (16, 4)),
        "dfromfunction": lambda: dat.dfromfunction(
            lambda i, j: i * 10 + j, (16, 4)),
    }.get(name)
    for r in job2:
        vals, lay, dt = r["ctors"][name]
        assert np.array_equal(vals, np.asarray(ref))
        assert lay == _layout(ref) and dt == str(ref.dtype)
        if jax_ref is not None:
            jd = jax_ref()
            assert np.array_equal(vals, np.asarray(jd))
            assert lay == _layout(jd)


def test_job_aggregator_url_through_the_kv(job2):
    assert job2[0]["advertised"] is True
    for r in job2:
        assert r["aggregator"] == "http://agg:9100"
        # the port has no streaming exporter to register yet
        assert r["exporter"] is False


@pytest.mark.parametrize("op", ["djit", "matmul", "dcumsum", "dsort", "dfft",
                                "reshard", "run_spmd", "reshape",
                                "distribute", "dcat", "dtranspose",
                                "dconv2d", "ring_attention"])
def test_job_unported_ops_raise(job2, op):
    for r in job2:
        assert r["unported"][op] == "NotImplementedError"


def test_job_checkpoint_round_trip(job2):
    ck = np.random.default_rng(7).standard_normal((16, 4)).astype(np.float32)
    for r in job2:
        c = r["ckpt"]
        assert c["step"] == 3
        assert np.array_equal(c["w"], ck)
        assert c["layout"] == c["saved"] == _layout(dat.distribute(ck))


def test_job_heartbeat_census(job2):
    for r in job2:
        assert r["census_fresh"] == ([], "healthy")
    c0, c1 = job2[0]["census"], job2[1]["census"]
    assert c0["down"] == [1]
    assert c0["verdict"] == "quorum"
    assert (c0["side"], c0["lost"]) == ([0, 1, 2, 3], [4, 5, 6, 7])
    assert c0["probe_down"] == [4, 5, 6, 7]
    assert c0["probe_verdict"] == "quorum"
    assert c1["verdict"] == "minority"
    assert (c1["side"], c1["lost"]) == ([4, 5, 6, 7], [0, 1, 2, 3])
    # seen within the child's deadline (its heartbeat ages stale_s from
    # just before the first barrier)
    assert c0["latency_s"] < 10 * STALE_S


def test_job_domains_one_per_process(job2):
    for r in job2:
        assert r["domains"] == {0: [0, 1, 2, 3], 1: [4, 5, 6, 7]}
    # single-process: one domain of every rank, as JAX's single controller
    from distributedarrays_tpu.resilience import domains as JD
    from distributedarrays_tpu_torch.resilience import domains as TD
    assert TD.topology().domains() == JD.topology().domains()


def test_job_journals_merge(job2):
    paths = [r["journal"] for r in job2]
    merged = TCL.merge_journals(paths)
    assert merged == JCL.merge_journals(paths)
    streams = {(e.get("host"), e.get("pid")) for e in merged}
    assert len(streams) == 2
    clock = [e for e in merged
             if (e.get("cat"), e.get("name")) == ("multihost", "clock")]
    assert {e["process_index"] for e in clock} == {0, 1}
    before = [e["t"] for e in merged if e.get("name") == "before_barrier"]
    after = [e["t"] for e in merged if e.get("name") == "after_barrier"]
    assert len(before) == len(after) == 2
    assert max(before) <= min(after)
    ts = [e["t"] for e in merged]
    assert ts == sorted(ts)


# ---------------------------------------------------------------------------
# a three-process job: 3 x 4 CPU ranks (distinct ring neighbours; 50 rows
# over 6 row-ranks chunk unevenly)
# ---------------------------------------------------------------------------


def test_job3_layouts_and_gathers(job3):
    tdat.init(nranks=12, device="cpu")
    A = np.arange(24.0, dtype=np.float32)
    td = tdat.distribute(A)
    tu = tdat.distribute(U, procs=range(12), dist=(6, 2))
    for r in job3:
        assert r["A"] == _layout(td)
        assert np.array_equal(r["A_gather"], A)
        assert r["U"] == _layout(tu)
        assert np.array_equal(r["U2"], U * 2)
        assert r["A_sum"].tobytes() == tdat.dsum(td).numpy().tobytes()


@pytest.mark.parametrize("dims", [None, 0, 1])
def test_job3_reductions_bit_equal(job3, dims):
    tdat.init(nranks=12, device="cpu")
    _, chain = _port_chain()
    for name, (_, tfn) in REDUCERS.items():
        key = name if dims is None else f"{name}_{dims}"
        ref = tfn(chain, dims=dims)
        for r in job3:
            got = r["reductions"][key]
            if dims is None:
                assert got.tobytes() == ref.numpy().tobytes(), name
            else:
                assert np.array_equal(got[0], np.asarray(ref)), name
                assert got[1] == _layout(ref)


def test_job3_heartbeat_census(job3):
    for p in (0, 1):
        c = job3[p]["census"]
        assert c["down"] == [2]
        assert c["verdict"] == "quorum"
        assert c["side"] == list(range(8))
    c = job3[2]["census"]
    assert c["verdict"] == "minority"
    assert c["side"] == [8, 9, 10, 11]


def test_job3_journals_merge(job3):
    merged = TCL.merge_journals([r["journal"] for r in job3])
    assert len({(e.get("host"), e.get("pid")) for e in merged}) == 3
    before = [e["t"] for e in merged if e.get("name") == "before_barrier"]
    after = [e["t"] for e in merged if e.get("name") == "after_barrier"]
    assert len(before) == 3 and max(before) <= min(after)
