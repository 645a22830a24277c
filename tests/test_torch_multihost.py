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
bit: the reductions fold the same partials in the same order).  The ops
that run across processes (``tests/_torch_mh_legs.py``: the GEMM forms,
the transposes, the reshard and what rests on it, the element reads,
``djit``, the scans, ``run_spmd`` with the rank-list collectives,
``dsort``, the FFTs, ``dconv2d``, ring and Ulysses attention, k-means and
``dmatmul_int8``) are held leg by leg against numpy, against the port in
one process bit for bit, and in the 2-process job against JAX.  The
region copy's kernel route, for DArray boxes and for rank lists, is
replayed on the host.  Every child is
bounded by a timeout, so nothing can hang the suite.
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
from distributedarrays_tpu.models import ring_attention as JRA
from distributedarrays_tpu.telemetry import cluster as JCL

import distributedarrays_tpu_torch as tdat
from distributedarrays_tpu_torch.parallel import multihost as TM
from distributedarrays_tpu_torch.telemetry import cluster as TCL

import _torch_mh_legs as LEGS
from _torch_port import (emulated_copies, jax_plan_cache,  # noqa: F401
                         jax_process_state, port_ranks, run_job)

_CHILD = os.path.join(os.path.dirname(__file__), "_torch_multihost_child.py")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STALE_S = 3.0
_JOB_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
            "DA_TPU_DOMAINS", "DA_TPU_TELEMETRY", "DA_TPU_MH_INIT_TIMEOUT_S")


def _env() -> dict:
    env = {k: v for k, v in os.environ.items() if k not in _JOB_ENV}
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _run_job(out_dir, nprocs: int) -> list[dict]:
    store = os.path.join(out_dir, "store")
    done = run_job([[sys.executable, _CHILD, store, str(i), str(nprocs),
                     str(out_dir), str(STALE_S)] for i in range(nprocs)],
                   out_dir, _env(), store)
    for i, (rc, out) in enumerate(done):
        if rc == 4 and "MULTIHOST_STARTUP_FAILED" in out:
            pytest.fail(f"job formation failed (process {i}, bounded "
                        f"init timeout):\n{out}")
        assert rc == 0, f"process {i} failed:\n{out}"
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


# boxes of each case's array: the whole array, boxes across chunk edges,
# one element, and an empty box
REPLAY_CASES = [
    ("float32", (64, 16), (8, 1), [None, [(5, 29), (3, 16)], [(63, 64),
                                                              (0, 1)]]),
    ("float32", (50, 8), (4, 2), [None, [(12, 40), (2, 7)], [(13, 13),
                                                             (0, 8)]]),
    ("bfloat16", (37, 11), (2, 4), [None, [(0, 37), (2, 9)], [(18, 20),
                                                              (5, 6)]]),
    ("int32", (9, 7, 5), (2, 2, 2), [None, [(3, 7), (1, 6), (2, 4)]]),
    ("bool", (33, 17), (4, 2), [[(7, 30), (8, 10)], None]),
    ("complex64", (20, 6), (2, 4), [[(9, 11), (0, 6)]]),
    ("uint8", (130,), (8,), [[(15, 118)], None]),
]


@pytest.mark.parametrize("case", REPLAY_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in REPLAY_CASES])
def test_process_copies_replayed_on_the_host(monkeypatch, case):
    # the cross-process region copy on a pretend two-process table: ranks
    # 4-7 belong to process 1, whose "IPC handles" carry their tensors'
    # addresses here; the whole kernel route (``process_regions``: the
    # handle exchange, the copy list, the per-call mappings, the launch)
    # runs with the copy kernel's semantics replayed by memmove, and every
    # box must come back as the host array's box, each peer allocation
    # mapped once and all of them closed by the call's end
    from distributedarrays_tpu_torch import layout as L
    from distributedarrays_tpu_torch.ops import cuda_collectives as CC
    dt, shape, dist, boxes = case
    host = (torch.arange(int(np.prod(shape))).reshape(shape) % 251).to(
        getattr(torch, dt))
    d = tdat.distribute(host, dist=dist)
    other = tdat.distribute(host * 0, dist=dist)    # a second array
    monkeypatch.setattr(L, "process_of", lambda r: int(r) // 4)
    monkeypatch.setattr(L, "is_local", lambda r: int(r) < 4)
    monkeypatch.setattr(CC, "ipc_handle", lambda t: (
        t.data_ptr().to_bytes(8, "little"), 0))
    opened, closed = [], []
    monkeypatch.setattr(CC, "_ipc_open", lambda h, dev: opened.append(h) or
                        int.from_bytes(h, "little"))
    monkeypatch.setattr(CC, "_ipc_close", closed.append)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {
                            "synchronize": lambda self: None})())
    calls = []
    monkeypatch.setattr(CC, "_copy_on_card", emulated_copies(calls))
    arrays = [other, d]
    # process 1's own handles, as it would publish them
    monkeypatch.setattr(L, "is_local", lambda r: int(r) >= 4)
    theirs = CC.region_handles(arrays)
    monkeypatch.setattr(L, "is_local", lambda r: int(r) < 4)
    outs, wants = [], []
    for b in boxes:
        b = [(0, n) for n in shape] if b is None else b
        out = torch.zeros([hi - lo for lo, hi in b], dtype=host.dtype)
        outs.append((b, out))
        wants.append((1, b, out))
    barriers = []
    CC.process_regions(arrays, wants, lambda mine: [mine, theirs],
                       lambda: barriers.append(CC.open_mappings()))
    assert calls == [("all_gather", 1)]
    for b, out in outs:
        assert torch.equal(out, host[tuple(slice(lo, hi) for lo, hi in b)])
    # mapped once a peer allocation, all closed before the barrier
    assert len(opened) == len(set(opened)) > 0
    assert sorted(closed) == sorted(int.from_bytes(h, "little")
                                    for h in opened)
    assert barriers == [0] and CC.open_mappings() == 0


def _pretend_peer(monkeypatch):
    """A pretend two-process table for the replay tests: ranks 4-7 are
    process 1's, whose "IPC handles" carry their tensors' addresses."""
    from distributedarrays_tpu_torch import layout as L
    from distributedarrays_tpu_torch.ops import cuda_collectives as CC
    monkeypatch.setattr(L, "process_of", lambda r: int(r) // 4)
    monkeypatch.setattr(CC, "ipc_handle", lambda t: (
        t.data_ptr().to_bytes(8, "little"), 0))
    opened, closed = [], []
    monkeypatch.setattr(CC, "_ipc_open", lambda h, dev: opened.append(h) or
                        int.from_bytes(h, "little"))
    monkeypatch.setattr(CC, "_ipc_close", closed.append)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {
                            "synchronize": lambda self: None})())
    return opened, closed


@pytest.mark.parametrize("dt", ["float32", "bfloat16", "int32"])
def test_rank_list_copies_replayed_on_the_host(monkeypatch, dt):
    # the rank-list exchange's kernel route on a pretend two-process
    # table: process 0 holds ranks 0-3 of two rank lists (ranks 4-7 are
    # meta placeholders there) and asks for a pshift's, a halo's and an
    # all-to-all's pieces of both; process 1's tensors are read through
    # its "IPC handles" by the replayed copy kernel, each allocation
    # mapped once and closed before the barrier, in one launch
    from distributedarrays_tpu_torch.ops import cuda_collectives as CC
    opened, closed = _pretend_peer(monkeypatch)
    typ = getattr(torch, dt)
    real = [[(torch.arange(24).reshape(4, 6) * (r + 1) + 100 * a).to(typ)
             for r in range(8)] for a in range(2)]
    theirs = CC.region_handles([[t if r >= 4 else t.to("meta")
                                 for r, t in enumerate(x)] for x in real])
    lists = [[t if r < 4 else t.to("meta") for r, t in enumerate(x)]
             for x in real]
    outs, wants = [], []
    for a in range(2):
        for r in range(4):
            src = (r - 1) % 8                         # pshift(+1)
            o = torch.zeros(4, 6, dtype=typ)
            wants.append((a, src, [(0, 4), (0, 6)], o))
            outs.append((o, real[a][src]))
        h = torch.zeros(2, 6, dtype=typ)              # the halo from 4
        wants.append((a, 4, [(0, 2), (0, 6)], h))
        outs.append((h, real[a][4][:2]))
        c = torch.zeros(4, 12, dtype=typ)             # an a2a's pieces
        for k, r in enumerate((5, 2)):
            wants.append((a, r, [(0, 4), (3, 6)], c[:, 6 * k + 3:6 * k + 6]))
        outs.append((c[:, 3:6], real[a][5][:, 3:6]))
        outs.append((c[:, 9:12], real[a][2][:, 3:6]))
    calls, barriers = [], []
    monkeypatch.setattr(CC, "_copy_on_card", emulated_copies(calls))
    CC.process_regions(lists, wants, lambda mine: [mine, theirs],
                       lambda: barriers.append(CC.open_mappings()),
                       "all_to_all")
    assert calls == [("all_to_all", 1)]
    for got, want in outs:
        assert torch.equal(got, want)
    # ranks 7 (the shift), 4 (the halo) and 5 (the all-to-all) of each list
    assert len(opened) == len(set(opened)) == 2 * 3
    assert sorted(closed) == sorted(int.from_bytes(h, "little")
                                    for h in opened)
    assert barriers == [0] and CC.open_mappings() == 0


def _replayed_reduce(typ, isz):
    """K12's ``da_reduce_pieces`` replayed on the host: the left fold of
    the ``p`` pieces at ``ptrs``, in pointer order, each read as the
    kernel reads it (3 outer sizes and element strides, a contiguous run)
    and the fold written to ``out`` contiguous."""
    import ctypes

    def read(ptr, sizes, strides, run):
        rows = []
        for i in range(sizes[0]):
            for j in range(sizes[1]):
                for k in range(sizes[2]):
                    at = ptr + (i * strides[0] + j * strides[1]
                                + k * strides[2]) * isz
                    buf = (ctypes.c_char * (run * isz)).from_address(at)
                    rows.append(torch.frombuffer(bytearray(buf), dtype=typ))
        return torch.cat(rows)

    def kernel(p, ptrs, sizes, strides, run, out, bf16, dev, stream):
        acc = None
        for i in range(p):
            x = read(ptrs[i], list(sizes), list(strides), run)
            acc = x.clone() if acc is None else acc + x
        ctypes.memmove(out, acc.data_ptr(), acc.numel() * isz)
        return 0
    return kernel


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_reduce_scatter_job_replayed_on_the_host(monkeypatch, dt):
    # K12's job route on a pretend two-process table: process 0 holds
    # ranks 0-3 of 8 (4-7 are meta placeholders) and launches once a rank,
    # the pointer array holding process 1's pieces at the "mapping" of
    # their blocks; the replayed kernel folds them in the arrival order
    # (d + k) % p, bit-equal to the one-process plain version; every
    # mapping is closed before the closing barrier
    from distributedarrays_tpu_torch.ops import cuda_collectives as CC
    from distributedarrays_tpu_torch.utils import kbuild
    opened, closed = _pretend_peer(monkeypatch)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {
                            "synchronize": lambda self: None,
                            "cuda_stream": 0})())
    typ = getattr(torch, dt)
    real = [((torch.arange(64.0) * (r + 1)) % 13 / 7 + r).to(typ)
            for r in range(8)]
    theirs = CC.region_handles([[t if r >= 4 else t.to("meta")
                                 for r, t in enumerate(real)]])
    blocks = [t if r < 4 else t.to("meta") for r, t in enumerate(real)]
    kernel = _replayed_reduce(typ, real[0].element_size())
    want = CC.reduce_scatter_plain(real, 0)        # one process
    barriers = []
    monkeypatch.setattr(CC, "_fn", lambda name: kernel)
    monkeypatch.setattr(CC, "_on_cuda", lambda ts: True)
    monkeypatch.setattr(CC.multihost, "in_job", lambda: True)
    monkeypatch.setattr(CC.multihost, "_kernel_route", lambda: True)
    monkeypatch.setattr(CC.multihost, "_all_gather_json",
                        lambda tag, obj: [obj, theirs])
    monkeypatch.setattr(CC.multihost, "sync_hosts",
                        lambda tag: barriers.append((tag,
                                                     CC.open_mappings())))
    monkeypatch.setattr(CC.L, "local_device", lambda: torch.device("cpu"))
    kbuild.reset_launches()
    got = CC.ring_reduce_scatter(blocks, 0)
    for r in range(4):
        assert torch.equal(got[r], want[r]), r
    assert all(g.device.type == "meta" for g in got[4:])
    assert kbuild.launch_counts()["reduce_scatter"] == 4
    assert kbuild.route_counts()["reduce_scatter"]["cross_process"] == 4
    assert len(opened) == len(set(opened)) == 4
    assert sorted(closed) == sorted(int.from_bytes(h, "little")
                                    for h in opened)
    assert barriers == [("reduce_scatter", 0)] and CC.open_mappings() == 0
    kbuild.reset_launches()


@pytest.mark.parametrize("dt,dim", [("float32", 0), ("bfloat16", 0),
                                    ("float32", 1)])
def test_reduce_scatter_fetched_replayed_on_the_host(monkeypatch, dt, dim):
    # K12 on the card in a job whose peers cannot be mapped (the job spans
    # hosts, or a peer computes on the CPU): process 0 holds ranks 0-3 of
    # 8 on its "card"; the pieces it needs from process 1 come over the
    # job's exchange (here filled from process 1's blocks), and then one
    # replayed launch a rank folds them in the arrival order (d + k) % p,
    # bit-equal to the one-process plain version; the plain fold is never
    # taken
    from distributedarrays_tpu_torch.ops import cuda_collectives as CC
    from distributedarrays_tpu_torch.utils import kbuild
    typ = getattr(torch, dt)
    real = [((torch.arange(128.0).reshape(8, 16) * (r + 1)) % 13 / 7
             + r).to(typ) for r in range(8)]
    blocks = [t if r < 4 else t.to("meta") for r, t in enumerate(real)]
    asked = []

    def exchange(sources, wants, kernel="all_gather", op="exchange"):
        assert sources == [blocks]
        for a, k, bounds, dst in wants:
            assert a == 0 and k >= 4           # only process 1's pieces
            asked.append(k)
            dst.copy_(real[k][tuple(slice(lo, hi) for lo, hi in bounds)])
    kernel = _replayed_reduce(typ, real[0].element_size())
    want = CC.reduce_scatter_plain(real, dim)      # one process
    monkeypatch.setattr(CC, "_fn", lambda name: kernel)
    monkeypatch.setattr(CC, "_on_cuda", lambda ts: True)
    monkeypatch.setattr(CC, "psum_scatter", None)
    monkeypatch.setattr(CC.multihost, "in_job", lambda: True)
    monkeypatch.setattr(CC.multihost, "_kernel_route", lambda: False)
    monkeypatch.setattr(CC.multihost, "exchange", exchange)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0})())
    kbuild.reset_launches()
    got = CC.ring_reduce_scatter(blocks, dim)
    for r in range(4):
        assert torch.equal(got[r], want[r]), r
    assert all(g.device.type == "meta" for g in got[4:])
    assert sorted(asked) == sorted(list(range(4, 8)) * 4)
    assert kbuild.launch_counts()["reduce_scatter"] == 4
    assert kbuild.route_counts()["reduce_scatter"] == {
        "cross_process": 0, "cross_process_fetched": 4}
    kbuild.reset_launches()


def test_rank_list_exchange_raises_and_never_takes_gloo(monkeypatch):
    # a handle that will not open fails the kernel route's call (its
    # mappings closed, no barrier passed), and multihost.exchange raises
    # that error instead of handing the work to the gloo route
    from distributedarrays_tpu_torch.ops import cuda_collectives as CC
    opened, closed = _pretend_peer(monkeypatch)
    real = [torch.arange(8.0) + r for r in range(8)]
    theirs = CC.region_handles([[t if r >= 4 else t.to("meta")
                                 for r, t in enumerate(real)]])
    lists = [[t if r < 4 else t.to("meta") for r, t in enumerate(real)]]
    monkeypatch.setattr(CC, "_copy_on_card", emulated_copies([]))

    def refuse(h, dev):
        if opened:
            raise RuntimeError("cudaIpcOpenMemHandle refused a peer "
                               "process's allocation on cpu: CUDA error 1")
        opened.append(h)
        return int.from_bytes(h, "little")
    monkeypatch.setattr(CC, "_ipc_open", refuse)
    barriers, plain = [], []
    wants = [(0, r, [(0, 8)], torch.zeros(8)) for r in (4, 5)]
    monkeypatch.setattr(TM, "_job", type("J", (), {"group": None})())
    monkeypatch.setattr(TM, "_kernel_route", lambda: True)
    monkeypatch.setattr(TM, "_all_gather_json", lambda tag, obj: [obj,
                                                                  theirs])
    monkeypatch.setattr(TM, "sync_hosts", barriers.append)
    monkeypatch.setattr(CC, "process_regions_plain",
                        lambda *a: plain.append(a))
    with pytest.raises(RuntimeError, match="cudaIpcOpenMemHandle"):
        TM.exchange(lists, wants, "all_gather")
    assert plain == [] and barriers == []
    assert closed == [int.from_bytes(opened[0], "little")]
    assert CC.open_mappings() == 0


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


# the ops that raised across processes before they were ported, each with
# the legs that hold it (tests/_torch_mh_legs.py)
PORTED = {"djit": ["djit", "djit_scalar"],
          "matmul": ["gemm", "gemm_wide", "matvec", "mul_into"],
          "dcumsum": ["dcumsum", "dcumsum_1", "dcumsum_uneven"],
          "reshard": ["relayout_a2a", "relayout_chain", "relayout_uneven"],
          "reshape": ["reshape"], "distribute": ["distribute"],
          "dcat": ["dcat", "dcat_layouts"],
          "dtranspose": ["dtranspose", "dtranspose_cuts"]}
# the ops ported on the rank-list exchange, each with its legs
ON_RANK_LISTS = {
    "run_spmd": [n for n in LEGS.NAMES if n.startswith("spmd_")],
    "dsort": [n for n in LEGS.NAMES if n.startswith("dsort")],
    "dfft": ["dfft", "dfft_1", "dfft_vec", "difft_vec", "dfft2", "difft2",
             "dfft_host"],
    "dconv2d": [n for n in LEGS.NAMES if n.startswith("dconv2d")],
    "ring_attention": ["ring_attention", "ring_attention_causal"],
    "ulysses_attention": ["ulysses", "ulysses_causal"],
    "kmeans": ["kmeans", "kmeans_cols"],
    "dmatmul_int8": ["int8_rows", "int8_cannon"]}
# sequence-parallel training on the rank lists with placeholders: the ops
# that raised NotImplementedError (the flash and zigzag rings) or the
# untyped ValueError of the kernel wrappers (C25) in a job, and their legs
ON_TRAIN = {
    "ring_flash_attention": ["ring_flash_attention", "ring_flash_grads"],
    "zigzag_ring_flash_attention": ["zigzag_ring_flash_attention",
                                    "zigzag_flash_grads"],
    "zigzag_ring_attention": ["zigzag_ring_attention", "zigzag_ring_grads"],
    "tp_ffn": ["tp_ffn"],
    "sp_make_grad_fn": ["sp_grad", "sp_grad_zigzag"],
    "sp_make_train_step": ["sp_sgd", "sp_sgd_zigzag"],
    "sp_make_optax_train_step": ["sp_adam"]}
PORTED.update(ON_RANK_LISTS)
PORTED.update(ON_TRAIN)


@pytest.mark.parametrize("op", list(PORTED))
def test_job_ported_ops_match(job2, op):
    # an op that raised NotImplementedError across processes now gives
    # every process the single-process port's result on 8 ranks
    ref = _port_legs(8)
    for r in job2:
        assert r["errors"] == {}, r["errors"]
        for leg in PORTED[op]:
            _same(r["ported"][leg], ref[leg], leg)


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


# ---------------------------------------------------------------------------
# the ops across processes (tests/_torch_mh_legs.py), in both jobs
# ---------------------------------------------------------------------------

_PORT_LEGS: dict = {}


def _port_legs(n: int) -> dict:
    """Every leg's summary from the single-process port on ``n`` ranks
    (computed once a module; the fixture re-inits 8 ranks after)."""
    if n not in _PORT_LEGS:
        tdat.init(nranks=n, device="cpu")
        _PORT_LEGS[n] = {name: LEGS.summary(tdat, tdat.gather, thunk())[0]
                         for name, thunk in LEGS.legs(tdat, n)
                         + LEGS.train_legs(tdat, n)}
        tdat.d_closeall()
    return _PORT_LEGS[n]


def _same(got, ref, what):
    """Bit for bit: values (bytes and dtype), layouts, dtype names."""
    if isinstance(ref, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == ref.dtype, what
        assert got.shape == ref.shape and got.tobytes() == ref.tobytes(), \
            what
    elif isinstance(ref, (tuple, list)):
        assert len(got) == len(ref), what
        for g, r in zip(got, ref):
            _same(g, r, what)
    elif isinstance(ref, dict):
        assert set(got) <= set(ref), what
        for k in got:
            _same(got[k], ref[k], what)
    else:
        assert got == ref, what


def _values(got):
    """A leg's compared value (a DArray's gathered array)."""
    if isinstance(got, tuple) and len(got) == 3 and isinstance(got[1], dict):
        return got[0]
    return got


def _close(a, b, tol, what):
    if isinstance(b, tuple) and any(np.ndim(x) for x in b):
        # a tuple of arrays (k-means' centroids and shifts)
        assert len(a) == len(b), what
        for x, y in zip(a, b):
            _close(x, y, tol, what)
        return
    if tol is None:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, what
        np.testing.assert_array_equal(a, b, err_msg=what)   # NaN == NaN
    else:
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                                   atol=tol, err_msg=what)


GEMM_TOL = 1e-4        # the JAX child's GEMM tolerance (rtol = atol)
SCAN_TOL = 1e-5


def _oracles(N):
    """numpy's value of each leg and its tolerance (None: exact)."""
    D = LEGS.data(N)
    X, Y, Am, Bm = D["X"], D["Y"], D["Am"], D["Bm"]
    B8, I, Z = D["B8"], D["I"], D["Z"]
    f32 = np.float32
    return {
        "gemm": (Am @ Bm, GEMM_TOL), "gemm_wide": (D["W"] @ D["V"], GEMM_TOL),
        "matvec_host": (Am @ D["v"], GEMM_TOL),
        "matvec": (Am @ D["v"], GEMM_TOL), "gemm_host": (Am @ Bm, GEMM_TOL),
        "gemm_sub": (Am @ Bm[:, 0:5], GEMM_TOL),
        "rmatmul": (D["Cm"] @ (Am @ Bm), GEMM_TOL),
        "mul_into": (2 * (Am @ Bm) + 0.5 * D["C0"], GEMM_TOL),
        "bool_gemm": ((Am > 0.3) @ (Bm > 0.2), None),
        "dtranspose": (Am.T, None), "dadjoint": (D["G"].conj().T, None),
        "dtranspose_cuts": (D["H"].T, None),
        "relayout_a2a": (D["R"], None), "relayout_chain": (X, None),
        "relayout_uneven": (D["U"], None), "relayout_ranks": (X, None),
        "ops_mismatch": (X + Y, None), "distribute": (X, None),
        "reshape": (X.reshape(4, 16), None),
        "dcat": (np.concatenate([X, Y], 0), None),
        "dcat_layouts": (np.concatenate([X, Y], 1), None),
        "samedist": (Y, None),
        "mapslices": (X * 2 + X.sum(1, keepdims=True), SCAN_TOL),
        "ppeval": (X * 3 - 1, SCAN_TOL),
        "eq": ((True, False, True, True, True, False), None),
        "dnnz": ((int(np.count_nonzero(Z)),), None),
        "adv_rows": (X[[1, 3, 5, 14]], None), "adv_mask": (X[X > 0.5], None),
        "adv_mixed": (X[[0, 2], 1:3], None),
        "ddot": (f32((B8 * B8).sum()), None),
        "ddot_layouts": (f32((Y.astype(np.float64) ** 2).sum()), SCAN_TOL),
        "ddot_int": ((I * I).sum(dtype=np.int32), None),
        "dnorm": (f32(np.linalg.norm(X)), SCAN_TOL),
        "dnorm1": (f32(np.abs(X).sum()), SCAN_TOL),
        "dnorm_inf": (f32(np.abs(X).max()), None),
        "dnorm0": (f32(np.count_nonzero(Z)), None),
        "dfetch": (B8[12, 3], None), "dfetch_first": (B8[0, 0], None),
        "scalar": ((float(B8[12, 3]), float(B8[15, 7]), float(B8[0, 0])),
                   None),
        # correctly rounded float32 means (C22)
        "dmean_bool": (f32((B8 > 3).mean()), None),
        "dmean_int": (f32(I.astype(np.float64).mean()), None),
        "dmean_int_0": (I.astype(np.float64).mean(0, keepdims=True)
                        .astype(f32), None),
        "djit": (np.sin(X) + Y * X, SCAN_TOL),
        "djit_scalar": (f32((X * X).sum()), SCAN_TOL),
        "dcumsum": (np.cumsum(D["S"], 0), SCAN_TOL),
        "dcumsum_1": (np.cumsum(Y, 1), SCAN_TOL),
        "dcumprod": (np.cumprod(X * f32(0.1) + 1, 0), SCAN_TOL),
        "dcummax": (np.maximum.accumulate(Y, 0), None),
        "dcummin_1": (np.minimum.accumulate(Y, 1), None),
        "dcumsum_uneven": (np.cumsum(D["su"]), SCAN_TOL),
        **_rank_list_oracles(N, D),
    }


FFT_TOL = 1e-3         # the JAX child's dfft tolerance
ATTN_TOL = 2e-3        # the JAX child's ring attention tolerance


def _conv_np(x, k):
    """SAME zero-padded cross-correlation of (H, W) ``x`` and (kh, kw)
    ``k`` (XLA's split: the larger pad after), in float64."""
    kh, kw = k.shape
    xp = np.pad(x.astype(np.float64), (((kh - 1) // 2, kh // 2),
                                       ((kw - 1) // 2, kw // 2)))
    out = np.zeros(x.shape)
    for i in range(kh):
        for j in range(kw):
            out += k[i, j] * xp[i:i + x.shape[0], j:j + x.shape[1]]
    return out


def _attn_np(q, k, v, causal):
    s = np.einsum("qhd,khd->hqk", q / np.sqrt(q.shape[-1]), k)
    if causal:
        s = np.where(np.tril(np.ones(s.shape[1:], bool))[None], s, -np.inf)
    w = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("hqk,khd->qhd", w / w.sum(-1, keepdims=True), v)


def _q8(x, axis):
    """numpy's symmetric int8 codes and scales along ``axis``."""
    s = np.abs(x).max(axis=axis, keepdims=True) / np.float32(127)
    q = np.where(s > 0, np.round(x / np.where(s > 0, s, 1)), 0)
    return q, s


def _int8_np(a, b, g=1):
    """The int8 GEMM's value with each (g x g) block of a and b quantized
    on its own (per row of A's block, per column of B's), in float64."""
    m, k = a.shape
    n = b.shape[1]
    bm, bk, bn = m // g, k // g, n // g
    out = np.zeros((m, n))
    for i in range(g):
        for j in range(g):
            for t in range(g):
                qa, sa = _q8(a[i * bm:(i + 1) * bm, t * bk:(t + 1) * bk], 1)
                qb, sb = _q8(b[t * bk:(t + 1) * bk, j * bn:(j + 1) * bn], 0)
                out[i * bm:(i + 1) * bm, j * bn:(j + 1) * bn] += \
                    (qa @ qb) * sa * sb
    return out


def _lloyd_np(X, C, iters):
    """Lloyd's iterations in float64 from ``C``: the centroids and the
    shifts."""
    X, C, shifts = X.astype(np.float64), C.astype(np.float64), []
    for _ in range(iters):
        a = np.argmin(((X[:, None] - C[None]) ** 2).sum(-1), 1)
        new = C.copy()
        for j in range(C.shape[0]):
            if (a == j).any():
                new[j] = X[a == j].mean(0)
        shifts.append(((new - C) ** 2).sum())
        C = new
    return C, np.asarray(shifts)


_RANK_LIST_ORACLES: dict = {}


def _rank_list_oracles(N, D):
    """numpy's value of each leg on the rank-list exchange (computed once
    a rank count): a list of every rank's block where the leg returns
    rank tensors."""
    if N not in _RANK_LIST_ORACLES:
        _RANK_LIST_ORACLES[N] = _make_rank_list_oracles(N, D)
    return _RANK_LIST_ORACLES[N]


def _make_rank_list_oracles(N, D):
    from distributedarrays_tpu_torch.models import kmeans as TK
    P = D["P"].reshape(N, 2 * N)
    Q = D["Q"]
    blocks = list(P)
    sv, si, sn = D["sv"], D["si"], D["sn"]
    F1 = D["F1"]
    k64 = {"k3": D["k3"].astype(np.float64), "k5": D["k5"].astype(np.float64)}
    nh = np.stack([np.stack([sum(_conv_np(D["nh"][b, :, :, c],
                                          D["kn"][:, :, c, o])
                                 for c in range(3)) for o in range(4)], -1)
                   for b in range(2)])
    tdat.init(nranks=N, device="cpu")
    km = {}
    for key, grid in (("kmeans", (N, 1)), ("kmeans_cols", (N // 2, 2))):
        C0 = TK._kmeanspp_init(tdat.distribute(D["km"], procs=range(N),
                                               dist=grid), 3, 1)
        km[key] = (_lloyd_np(D["km"], C0, 4), SCAN_TOL)
    tdat.d_closeall()
    g, _ = LEGS.cannon_grid(N)

    def halo(r, wrap):
        lo = blocks[r - 1][-3:] if r or wrap else np.zeros(3, np.float32)
        hi = blocks[(r + 1) % N][:3] if r < N - 1 or wrap else \
            np.zeros(3, np.float32)
        return np.concatenate([lo, blocks[r], hi])

    def halo2d(r):
        # (N/2, 2) blocks of 8 x 3, each with a ring of its neighbours
        whole = np.pad(Q, 1)
        i, j = divmod(r, 2)
        return whole[8 * i:8 * i + 10, 3 * j:3 * j + 5]
    gathered = P.reshape(-1)
    return {
        "spmd_pshift": ([blocks[r - 1] for r in range(N)], None),
        "spmd_pshift_back": ([blocks[r + 2] if r + 2 < N else
                              np.zeros(2 * N, np.float32)
                              for r in range(N)], None),
        "spmd_host": ([np.full((2, 3), (r - 2) % N, np.float32)
                       for r in range(N)], None),
        "spmd_pshifts": ([np.concatenate([blocks[r - 1],
                                          2 * blocks[(r + 3) % N]])
                          for r in range(N)], None),
        "spmd_pgather": ([gathered] * N, None),
        "spmd_preduce": ([sum(b * (r + 1) for r, b in enumerate(blocks))]
                         * N, SCAN_TOL),
        "spmd_pmax": ([np.max([np.roll(b, r) for r, b in enumerate(blocks)],
                              0)] * N, None),
        "spmd_pmean": ([P.mean(0)] * N, SCAN_TOL),
        "spmd_psum_scatter": ([N * gathered[2 * N * d:2 * N * (d + 1)]
                               for d in range(N)], SCAN_TOL),
        "spmd_pall_to_all": ([np.concatenate(
            [blocks[r].reshape(N, 2)[q:q + 1] + r for r in range(N)], 1)
            for q in range(N)], None),
        "spmd_pbcast": ([blocks[N - 1]] * N, None),
        "spmd_halo": ([halo(r, False) for r in range(N)], None),
        "spmd_halo_wrap": ([halo(r, True) for r in range(N)], None),
        "spmd_halo_2d": ([halo2d(r) for r in range(N)], None),
        "spmd_pbarrier": ([np.int32(N)] * N, None),
        "spmd_subset": ([D["P"][:8].reshape(4, 2)[r - 1] for r in range(4)],
                        None),
        "dsort": (np.sort(sv), None),
        "dsort_int_rev": (np.sort(si)[::-1], None),
        "dsort_nan_minmax": (np.sort(sn), None),
        "dsort_by": (sv[np.argsort(np.abs(sv), kind="stable")], None),
        "dsort_one_key": (np.sort(D["s1"]), None),
        "dsort_whole": (np.array([1.0, 2.0, 3.0], np.float32), None),
        "dsort_host_by": (np.asarray(sorted(si, key=lambda x: (abs(x), x)),
                                     np.int32), None),
        "dsort_subset": (np.sort(sv), None),
        "dfft": (np.fft.fft(F1, axis=0), FFT_TOL),
        "dfft_1": (np.fft.fft(F1, axis=1), FFT_TOL),
        "dfft_vec": (np.fft.fft(D["fv"]), FFT_TOL),
        "difft_vec": (np.fft.ifft(D["fv"]), FFT_TOL),
        "dfft2": (np.fft.fft2(F1), FFT_TOL),
        "difft2": (np.fft.ifft2(F1), FFT_TOL),
        "dfft_host": (np.fft.fft(F1, axis=0), FFT_TOL),
        "dconv2d": (_conv_np(D["im"], k64["k3"]), SCAN_TOL),
        "dconv2d_5": (_conv_np(D["im"], k64["k5"]), SCAN_TOL),
        "dconv2d_nhwc": (nh, SCAN_TOL),
        "dconv2d_host": (_conv_np(D["im"][:, :4], k64["k5"]), SCAN_TOL),
        "ring_attention": (_attn_np(*D["qkv"], False), ATTN_TOL),
        "ring_attention_causal": (_attn_np(*D["qkv"], True), ATTN_TOL),
        "ulysses": (_attn_np(*D["uqkv"], False), ATTN_TOL),
        "ulysses_causal": (_attn_np(*D["uqkv"], True), ATTN_TOL),
        **km,
        "int8_rows": (_int8_np(D["ia"], D["ib"]), SCAN_TOL),
        "int8_cannon": (_int8_np(D["ca"], D["cb"], g), SCAN_TOL),
    }


def _jax_legs():
    """The JAX package's value of each leg it has on its 8-device CPU mesh
    (the reference's multi-process results are its single-process ones),
    with JAX's DArray layouts where the result is one."""
    D = LEGS.data(8)
    J = dat
    dx, dy = J.distribute(D["X"]), J.distribute(D["Y"])
    d2 = J.distribute(D["Y"], procs=range(8), dist=(4, 2))
    da = J.distribute(D["Am"], procs=range(8), dist=(2, 4))
    db = J.distribute(D["Bm"], procs=range(8), dist=(4, 2))
    d8, dz = J.distribute(D["B8"]), J.distribute(D["Z"])
    di = J.distribute(D["I"])
    calls = {
        "gemm": lambda: da @ db,
        "gemm_wide": lambda: J.distribute(D["W"], procs=range(8),
                                          dist=(4, 2)) @ J.distribute(
            D["V"], procs=range(8), dist=(2, 4)),
        "matvec_host": lambda: da @ D["v"],
        "matvec": lambda: da @ J.distribute(D["v"]),
        "gemm_host": lambda: da @ jnp.asarray(D["Bm"]),
        "bool_gemm": lambda: (da > 0.3) @ (db > 0.2),
        "dtranspose": lambda: J.dtranspose(da),
        "dadjoint": lambda: J.dadjoint(J.distribute(
            D["G"], procs=range(8), dist=(2, 4))),
        "distribute": lambda: J.distribute(dx, dist=(4, 2)),
        "reshape": lambda: dx.reshape(4, 16),
        "dcat": lambda: J.dcat(0, dx, dy),
        "samedist": lambda: J.samedist(d2, dx),
        "mapslices": lambda: J.mapslices(lambda c: c * 2 + c.sum(), dx, 1),
        "ppeval": lambda: J.ppeval(lambda c: c * 3 - 1, dx),
        "eq": lambda: (dx == J.distribute(D["X"]), dx == dy, dx == D["X"],
                       d2 == J.distribute(D["Y"]), dx[0:8] == D["X"][0:8],
                       dx == D["X"] + 1),
        "dnnz": lambda: (J.dnnz(dz),),
        "adv_rows": lambda: dx[[1, 3, 5, 14]],
        "adv_mixed": lambda: dx[[0, 2], 1:3],
        "ddot": lambda: J.ddot(d8, d8),
        "ddot_int": lambda: J.ddot(di, di),
        "dnorm": lambda: J.dnorm(dx), "dnorm1": lambda: J.dnorm(dx, 1),
        "dnorm_inf": lambda: J.dnorm(dx, np.inf),
        "dnorm0": lambda: J.dnorm(dz, 0),
        "dfetch": lambda: J.dfetch(d8, 12, 3),
        "dmean_bool": lambda: J.dmean(J.distribute(D["B8"] > 3)),
        "dmean_int": lambda: J.dmean(di),
        "dmean_int_0": lambda: J.dmean(di, dims=0),
        "djit": lambda: J.djit(lambda a, b: jnp.sin(a) + b * a)(dx, dy),
        "djit_scalar": lambda: J.djit(lambda a: (a * a).sum())(dx),
        "dcumsum": lambda: J.dcumsum(J.distribute(D["S"]), axis=0),
        "dcummax": lambda: J.dcummax(dy, axis=0),
        "dcumsum_uneven": lambda: J.dcumsum(J.distribute(D["su"])),
        # the JAX child's legs of the ops on the rank-list exchange
        "dfft": lambda: J.dfft(J.distribute(D["F1"], procs=range(8),
                                            dist=(8, 1)), axis=0),
        "dsort": lambda: J.dsort(J.distribute(D["sv"])),
        "spmd_pshift": _jax_ring_hop,
        "ring_attention": lambda: JRA.ring_attention(
            *(J.distribute(x, procs=range(8), dist=(8, 1, 1))
              for x in D["qkv"])),
    }
    out = {}
    for name, call in calls.items():
        v = call()
        if isinstance(v, dat.DArray):
            out[name] = (np.asarray(v), _layout(v))
        elif isinstance(v, dat.SubDArray):
            out[name] = (np.asarray(v), None)
        elif isinstance(v, tuple):
            out[name] = (v, None)
        else:
            out[name] = (np.asarray(v), None)
    return out


def _jax_ring_hop():
    """The JAX child's ``run_spmd`` + ``pshift(+1)`` over all 8 ranks, on
    the legs' blocks (2N a rank)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    import jax
    from distributedarrays_tpu.parallel import collectives as JC
    mesh = JC.spmd_mesh(8, "x")
    ring = JC.run_spmd(lambda x: JC.pshift(x, "x", 1), mesh,
                       in_specs=P("x"), out_specs=P("x"))
    x = LEGS.data(8)["P"]
    arr = jax.make_array_from_callback(x.shape, NamedSharding(mesh, P("x")),
                                       lambda idx: x[idx])
    return np.asarray(ring(arr)).reshape(8, 16)


_JAX_LEGS: dict = {}


def _check_leg(results, name, N, jax_ref=None):
    """One leg on every process of a job: no meta tensor handed out,
    numpy's values at the leg's tolerance, the single-process port on
    ``N`` ranks bit for bit (layouts too), and JAX's value and layout
    where given."""
    ref = _port_legs(N)[name]
    for r in results:
        got = r["ported"][name]
        assert name not in r["meta"], r["meta"]
        if name == "allgather":
            # the whole array on each listed rank this process holds
            ranks = [0, N - 1, 5]
            assert sorted(got) == [i for i, q in enumerate(ranks)
                                   if q // 4 == r["proc"]]
            for t in got.values():
                assert np.array_equal(t, LEGS.data(N)["X"])
            continue
        if name == "ddata_bcoo":
            count, parts = got
            assert count == int(np.count_nonzero(LEGS.data(N)["Z"]))
            assert sorted(parts) == list(range(4 * r["proc"],
                                               4 * r["proc"] + 4))
            _same(parts, ref[1], name)
            continue
        _same(got, ref, name)
        want, tol = _oracles(N)[name]
        if isinstance(got, dict):
            # a list of rank tensors: this process's ranks' (4 a process;
            # each leg's mesh lists the ranks in order from rank 0)
            assert sorted(got) == [i for i, _ in enumerate(want)
                                   if i // 4 == r["proc"]], (name, sorted(got))
            for i, t in got.items():
                _close(t, want[i], tol, f"{name}[{i}]")
        else:
            _close(_values(got), want, tol, name)
        if jax_ref is not None and name in jax_ref:
            jv, jlay = jax_ref[name]
            if isinstance(got, dict):
                _close(np.stack([got[i] for i in sorted(got)]),
                       np.asarray(jv)[sorted(got)], tol, name)
                continue
            _close(_values(got), jv, tol, name)
            if jlay is not None:
                assert got[1] == jlay, name


@pytest.mark.parametrize("name", LEGS.NAMES)
def test_job_legs(job2, name):
    if not _JAX_LEGS:
        _JAX_LEGS.update(_jax_legs())
    _check_leg(job2, name, 8, _JAX_LEGS)


@pytest.mark.parametrize("name", LEGS.NAMES)
def test_job3_legs(job3, name):
    _check_leg(job3, name, 12)


def test_job_region_calls_leave_no_mapping_open(job2, job3):
    # the mappings a region call opens are its own (CUDA IPC only; the CPU
    # jobs take the gloo route, where the count stays 0 too)
    for r in job2 + job3:
        assert r["open_mappings"] == 0
        assert r["meta"] == {}


SKIP_TIMEOUT_S = 5


def test_job_skipped_exchange_fails_within_the_store_timeout(tmp_path):
    # a process that enters a region call its peer skips raises within
    # the job's timeout instead of hanging
    _skipped_call_raises(tmp_path, "region")


def test_job_skipped_rank_list_collective_fails_within_the_store_timeout(
        tmp_path):
    # the same for a rank-list collective: a pshift in run_spmd that one
    # process enters and the other skips
    _skipped_call_raises(tmp_path, "pshift")


def test_job_skipped_ring_gemm_step_fails_within_the_store_timeout(
        tmp_path):
    # the same for one step of a ring GEMM: both processes enter K13's
    # ring (its plain form over gloo, a step's hop one exchange), and
    # process 1 skips the second step
    _skipped_call_raises(tmp_path, "ring_gemm")


def _skipped_call_raises(tmp_path, what: str) -> None:
    child = os.path.join(os.path.dirname(__file__), "_torch_mh_skip_child.py")
    store = str(tmp_path / "store")
    done = run_job([[sys.executable, child, store, str(i),
                     str(SKIP_TIMEOUT_S), what] for i in range(2)],
                   str(tmp_path), _env(), store)
    outs = [out for _, out in done]
    assert [rc for rc, _ in done] == [0, 0], outs
    line = [ln for ln in outs[0].splitlines()
            if ln.startswith("SKIPPED_EXCHANGE_")]
    assert line and line[0].startswith("SKIPPED_EXCHANGE_RAISED"), outs[0]
    assert float(line[0].split()[1]) < SKIP_TIMEOUT_S + 5, line


def test_c20_ddot_and_dnorm_same_on_every_process(job2):
    # C20: ddot of process-spanning DArrays raised torch's meta-tensor
    # error; dnorm raised NotImplementedError through DArray.part
    ref = _port_legs(8)
    B8 = LEGS.data(8)["B8"]
    for r in job2:
        for leg in ("ddot", "ddot_layouts", "ddot_int", "dnorm", "dnorm1",
                    "dnorm_inf", "dnorm0"):
            got = r["ported"][leg]
            assert isinstance(got, np.ndarray) and got.shape == (), leg
            _same(got, ref[leg], leg)
        assert r["ported"]["ddot"] == np.float32((B8 * B8).sum())
        assert r["ported"]["ddot"].dtype == np.float32


def test_c21_dfetch_from_the_owner_on_every_process(job2):
    # C21: dfetch of an element another process holds returned a meta
    # tensor; now every process gets the owner's value
    B8 = LEGS.data(8)["B8"]
    for r in job2:
        assert r["ported"]["dfetch"] == B8[12, 3]
        assert r["ported"]["dfetch_first"] == B8[0, 0]
        assert r["ported"]["dfetch"].dtype == np.float32


def test_c23_scalar_index_same_on_every_process(job2):
    # C23: d[i, j] under allowscalar(True) returned on the owner and
    # raised on the other processes
    B8 = LEGS.data(8)["B8"]
    want = (float(B8[12, 3]), float(B8[15, 7]), float(B8[0, 0]))
    for r in job2:
        assert r["ported"]["scalar"] == want


@pytest.mark.parametrize("case", ["bool", "int_whole", "int_dims0",
                                  "int_dims1", "uint8", "int8_3d"])
def test_c22_integer_and_bool_mean_correctly_rounded(case):
    # C22: the integer and bool dmean rounded at every Chan merge; on 8
    # ranks it now equals the correctly rounded float32 mean and JAX's
    rng = np.random.default_rng(1)
    B = np.arange(128, dtype=np.float32).reshape(16, 8) > 3
    A = rng.integers(-50, 50, (64, 64)).astype(np.int32)
    host, dims = {
        "bool": (B, None), "int_whole": (A, None), "int_dims0": (A, 0),
        "int_dims1": (A, 1),
        "uint8": (rng.integers(0, 255, (37, 11)).astype(np.uint8), 0),
        "int8_3d": (rng.integers(-128, 127, (9, 7, 5)).astype(np.int8),
                    (0, 2)),
    }[case]
    exact = host.astype(np.float64).mean(
        axis=dims, keepdims=dims is not None).astype(np.float32)
    got = tdat.dmean(tdat.distribute(host), dims=dims)
    got = np.asarray(got) if dims is not None else got.numpy()
    assert got.dtype == np.float32
    assert got.tobytes() == exact.tobytes()
    jax_got = np.asarray(dat.dmean(dat.distribute(host), dims=dims))
    if case in ("uint8", "int8_3d"):
        # JAX's mean over 37 and 45 elements is within one ulp of the
        # correctly rounded value, not always on it
        np.testing.assert_array_max_ulp(jax_got, exact, 1)
    else:
        assert jax_got.tobytes() == exact.tobytes()


def test_job3_ported_and_train_legs_match_one_process(job3):
    # the ops ported on the rank-list exchange, and the flash and zigzag
    # rings, tp_ffn and the SP model's steps, give every process the
    # single-process port's result on 12 ranks (pshift's direction at
    # p = 12, K/V blocks passing through ranks that are not their owner's
    # neighbours); none raises
    ref = _port_legs(12)
    for r in job3:
        assert r["errors"] == {}, r["errors"]
        for op, legs in {**ON_RANK_LISTS, **ON_TRAIN}.items():
            for leg in legs:
                _same(r["ported"][leg], ref[leg], leg)


# ---------------------------------------------------------------------------
# sequence-parallel training across processes (tests/_torch_mh_legs.py
# train_legs): the flash and zigzag rings, tp_ffn, the SP model's steps
# ---------------------------------------------------------------------------

TRAIN_TOL = dict(rtol=1e-4, atol=1e-5)   # f32 rings against float64 numpy


def _attn_grads_np(q, k, v, g, causal):
    """Softmax attention over (S, heads, d) arrays in float64: the output
    and the gradients of ``<out, g>`` with respect to q, k and v."""
    q, k, v, g = (x.astype(np.float64) for x in (q, k, v, g))
    sc = 1.0 / np.sqrt(q.shape[-1])
    s = np.einsum("qhd,khd->hqk", q, k) * sc
    if causal:
        s = np.where(np.tril(np.ones(s.shape[1:], bool))[None], s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    out = np.einsum("hqk,khd->qhd", p, v)
    dp = np.einsum("qhd,khd->hqk", g, v)
    ds = p * (dp - (dp * p).sum(-1, keepdims=True)) * sc
    return (out, np.einsum("hqk,khd->qhd", ds, k),
            np.einsum("hqk,qhd->khd", ds, q), np.einsum("hqk,qhd->khd", p, g))


def _gelu_np(x):
    c = np.sqrt(2 / np.pi)
    t = np.tanh(c * (x + 0.044715 * x ** 3))
    return 0.5 * x * (1 + t), 0.5 * (1 + t) + 0.5 * x * (1 - t * t) * c * (
        1 + 3 * 0.044715 * x * x)


def _train_oracles(N) -> dict:
    """numpy's value of each training leg but the SP model's (held against
    JAX in the 2-process job): a DArray leg's whole output, a rank-list
    leg's ``{"out", "d0", ...}`` as whole arrays (rank r's block is its
    rows, or w1's columns)."""
    D = LEGS.train_data(N)
    order = JRA.zigzag_order(4 * N, N)
    q, k, v = D["qkv"]
    out, dq, dk, dv = _attn_grads_np(q, k, v, D["g"], True)
    nat = D["g"][np.argsort(order)]            # the zigzag legs' cotangent
    zo, zq, zk, zv = (x[order] for x in _attn_grads_np(q, k, v, nat, True))
    n = 4 * (N - LEGS.SUB_RING_FIRST)          # the sub-ring's rows
    sub = dict(zip(("out", "d0", "d1", "d2"), _attn_grads_np(
        q[:n], k[:n], v[:n], D["g"][:n], True)))
    X, dY = D["x"].reshape(-1, 8), D["gy"].reshape(-1, 8)
    W1 = np.concatenate(list(D["w1"]), 1).astype(np.float64)
    W2 = np.concatenate(list(D["w2"]), 0).astype(np.float64)
    H = X @ W1
    G, dG = _gelu_np(H)
    dH = dY @ W2.T * dG
    return {
        "ring_flash_attention": out, "zigzag_ring_flash_attention": zo,
        "zigzag_ring_attention": zo,
        "ring_flash_grads": {"out": out, "d0": dq, "d1": dk, "d2": dv},
        "zigzag_flash_grads": {"out": zo, "d0": zq, "d1": zk, "d2": zv},
        "zigzag_ring_grads": {"out": zo, "d0": zq, "d1": zk, "d2": zv},
        "ring_causal_grads": sub,
        "tp_ffn": {"out": G @ W2, "d0": dH @ W1.T, "d1": X.T @ dH,
                   "d2": G.T @ dY}}


def _check_train_leg(results, name, N) -> None:
    """One training leg on every process of a job: nothing raised, no meta
    tensor handed out, the single-process port on ``N`` ranks bit for bit
    (layouts, each rank's tensors and the SP model's whole dicts), and
    numpy's values where the leg has them."""
    ref = _port_legs(N)[name]
    for r in results:
        assert r["errors"] == {}, r["errors"]
        assert name not in r["meta"], r["meta"]
        got = r["ported"][name]
        _same(got, ref, name)
        if name.startswith("trainer_"):
            # every process holds the whole flat vector and the losses
            assert len(got["losses"]) == (3 if "adam" in name else 2), name
            if "adam" in name:
                assert got["resumed_from"] == 3 and len(got["resumed"]) == 1
            continue
        if name.startswith("sp_"):
            # every process holds the whole dict, its own ranks' shards
            assert set(got["whole"]) == set(ref["whole"]), name
            for n, ranks in got["ranks"].items():
                assert sorted(ranks) == [i for i in range(N)
                                         if i // 4 == r["proc"]], n
            assert np.isfinite(got["loss"]), name
            continue
        want = _train_oracles(N)[name]
        if not isinstance(want, dict):
            np.testing.assert_allclose(_values(got), want, **TRAIN_TOL,
                                       err_msg=name)
            continue
        first = LEGS.SUB_RING_FIRST if name == "ring_causal_grads" else 0
        for key, w in want.items():
            # list index i is rank first + i
            assert sorted(got[key]) == [i for i in range(N - first)
                                        if (first + i) // 4 == r["proc"]], key
            for i, t in got[key].items():
                if name == "tp_ffn" and key == "d1":
                    wi = w[:, 4 * i:4 * i + 4]           # w1's columns
                else:
                    rows = len(w) // (N - first)
                    wi = w[i * rows:(i + 1) * rows]
                np.testing.assert_allclose(t, wi, **TRAIN_TOL,
                                           err_msg=f"{name} {key}[{i}]")


@pytest.mark.parametrize("name", LEGS.TRAIN_NAMES)
def test_job_train_legs(job2, name):
    _check_train_leg(job2, name, 8)


@pytest.mark.parametrize("name", LEGS.TRAIN_NAMES)
def test_job3_train_legs(job3, name):
    _check_train_leg(job3, name, 12)


def test_c25_rank_list_kernels_take_placeholders(job2, job3):
    # C25: in a job another process's ranks are meta placeholders in the
    # rank lists, and the kernel wrappers refused them with an untyped
    # ValueError ("rank tensors on ['cpu', 'meta']", "operands on
    # ['cpu', 'meta']"): the flash ring's hops, tp_ffn's ring GEMMs and
    # with them the SP model's steps; now they run on this process's
    # ranks, bit-equal to one process
    for results, n in ((job2, 8), (job3, 12)):
        ref = _port_legs(n)
        for r in results:
            for leg in ("ring_flash_grads", "tp_ffn", "sp_grad"):
                assert leg not in r["errors"], r["errors"][leg]
                _same(r["ported"][leg], ref[leg], leg)


def _jax_tree(params) -> dict:
    """A JAX parameter pytree as {port parameter name: numpy}."""
    out = {k: np.asarray(params[k]) for k in ("embed", "pos", "ln_f", "head")}
    for i, blk in enumerate(params["blocks"]):
        out.update({f"blocks.{i}.{k}": np.asarray(v) for k, v in blk.items()})
    return out


def test_job_sp_loss_and_gradients_match_jax(job2):
    # the 2-process job's SP loss and gradients (weights through
    # interop.params_from_reference and shard_params) against JAX's
    # make_grad_fn on its 8-device CPU mesh, at tests/test_torch_sp_
    # transformer.py's tolerances
    import jax
    from distributedarrays_tpu.models import sp_transformer as JSP
    from distributedarrays_tpu.parallel.collectives import spmd_mesh
    D = LEGS.train_data(8)
    jcfg = JSP.SPConfig(**LEGS.sp_cfg(8), dtype=jnp.float32, block_q=4,
                        block_k=4, interpret=True)
    init = JSP.init_params(jax.random.key(0), jcfg)
    assert jax.tree_util.tree_structure(init) == \
        jax.tree_util.tree_structure(D["params"])
    assert {k: v.shape for k, v in _jax_tree(init).items()} == \
        {k: v.shape for k, v in _jax_tree(D["params"]).items()}
    jloss, jg = jax.jit(JSP.make_grad_fn(spmd_mesh(8), jcfg))(
        D["params"], D["tokens"])
    want = _jax_tree(jg)
    for r in job2:
        got = r["ported"]["sp_grad"]
        np.testing.assert_allclose(got["loss"], float(jloss), rtol=1e-5)
        assert set(got["whole"]) == set(want)
        for name, w in want.items():
            np.testing.assert_allclose(got["whole"][name], w, rtol=1e-4,
                                       atol=1e-5, err_msg=name)


# ---------------------------------------------------------------------------
# the data-parallel Trainer across processes (tests/_torch_mh_legs.py
# trainer_legs, trainer_straggler)
# ---------------------------------------------------------------------------


def _jax_trainer(name: str, N: int) -> dict:
    """JAX's ``Trainer`` on N devices for the trainer leg ``name``, from
    the port task's initial parameters (the port's ``init_params`` with
    the trainer's seed 0, as numpy): the Adam legs' losses of 4 steps and
    the flat vectors after 3 and 4, the SGD legs' 2 losses and flat."""
    import dataclasses
    import jax
    from distributedarrays_tpu.resilience import elastic as jelastic
    from distributedarrays_tpu.resilience import faults as jfaults
    from distributedarrays_tpu.train import optim as JO
    from distributedarrays_tpu.train import tasks as JTasks
    from distributedarrays_tpu.train import trainer as JTrainer
    kind = "mlp" if "mlp" in name else "transformer"
    init = jax.tree_util.tree_map(lambda t: t.numpy(), LEGS.trainer_task(
        kind, N, tdat.train).init_params(torch.Generator().manual_seed(0)))
    jtask = dataclasses.replace(LEGS.trainer_task(kind, N, JTasks),
                                init_params=lambda key: init)
    adam = "adam" in name
    opt = JO.Optimizer(**(LEGS.TRAINER_ADAM if adam else LEGS.TRAINER_SGD))
    jfaults.clear()
    jelastic.manager().reset()
    with JTrainer.Trainer(jtask, optimizer=opt, ranks=list(range(N)),
                          seed=0) as jt:
        res = jt.fit(3 if adam else 2)
        out = {"losses": res["losses"],
               "flat": np.asarray(jt._state["pflat"])}
        if adam:
            more = jt.fit(4)
            out.update(resumed=more["losses"][3:],
                       resumed_flat=np.asarray(jt._state["pflat"]))
    return out


@pytest.mark.parametrize("name", LEGS.TRAINER_NAMES)
def test_job_trainer_matches_jax(job2, name):
    # the 2-process job's Trainer (8 ranks) against JAX's Trainer on its
    # 8-device CPU mesh from the same initial parameters, at
    # tests/test_torch_train.py's tolerances (losses rtol 1e-5 for the
    # MLP and 1e-4 for the transformer task, flat rtol 1e-4 / atol 1e-6)
    want = _jax_trainer(name, 8)
    rtol = 1e-5 if "mlp" in name else 1e-4
    for r in job2:
        got = r["ported"][name]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=rtol)
        assert got["losses"][-1] < got["losses"][0], name
        np.testing.assert_allclose(got["flat"], want["flat"], rtol=1e-4,
                                   atol=1e-6)
        if "adam" in name:
            np.testing.assert_allclose(got["resumed"], want["resumed"],
                                       rtol=rtol)
            np.testing.assert_allclose(got["resumed_flat"],
                                       want["resumed_flat"], rtol=1e-4,
                                       atol=1e-6)


def test_job_trainer_straggler_abort_leaves_every_process_at_one_step(
        job2, job3):
    # the last process hangs at the top of a step and finds its rank
    # down; the others' own step times are theirs, but the gate reads the
    # shared (slowest) time, so every process aborts the same step after
    # K12, none waits for another, and all shrink off the dead rank
    # together and finish the run with the same losses
    for results in (job2, job3):
        dead = 4 * (len(results) - 1)
        seen = [r["straggler"] for r in results]
        for s in seen:
            assert s["error"] is None, s
            assert s["step"] == LEGS.STRAGGLER_STEP + 2, s
            assert s["stragglers"] == 1, s
            assert s["losses"] == seen[0]["losses"], s
            assert len(s["losses"]) == LEGS.STRAGGLER_STEP + 2
            assert np.isfinite(s["losses"]).all(), s
            assert s["ranks"] == [r for r in range(4 * len(results))
                                  if r != dead], s


# ---------------------------------------------------------------------------
# the chunked checkpoint store and the Trainer's recovery across processes
# (tests/_torch_mh_legs.py ckpt_chunks, ckpt_agreement, relayout_regions,
# recovery_legs)
# ---------------------------------------------------------------------------

_PORT_RECOVERY: dict = {}


def _port_recovery(n: int, tmp_path_factory) -> dict:
    """The single-process port's chunked-store and recovery legs on ``n``
    ranks (computed once a module)."""
    if n not in _PORT_RECOVERY:
        tdat.init(nranks=n, device="cpu")
        root = str(tmp_path_factory.mktemp(f"port_recovery{n}"))
        out = {"ckpt_chunks": LEGS.ckpt_chunks(tdat, n, root),
               "ckpt_agreement": LEGS.ckpt_agreement(tdat, n, root),
               "relayout_regions": LEGS.relayout_regions(tdat, n)}
        out.update({name: thunk() for name, thunk in
                    LEGS.recovery_legs(tdat, n, root)})
        tdat.d_closeall()
        tdat.init(nranks=8, device="cpu")
        _PORT_RECOVERY[n] = out
    return _PORT_RECOVERY[n]


def _jobs(job2, job3):
    return {"job2": job2, "job3": job3}


def _bits_equal(got, want) -> bool:
    if isinstance(want, np.ndarray):
        return isinstance(got, np.ndarray) and got.dtype == want.dtype and \
            np.array_equal(got, want)
    return got == want


def _brief(v) -> str:
    """A value in a line: an array's first elements with full digits."""
    if isinstance(v, np.ndarray):
        return np.array2string(v.ravel()[:3], precision=9) + \
            ("..." if v.size > 3 else "")
    return repr(v)


def _fresh_recovery(n: int, tmp_path_factory) -> dict:
    """``recovery_legs`` on ``n`` ranks in a fresh process: the value this
    worker's reference is held against when a job's result differs from
    it."""
    out = tmp_path_factory.mktemp(f"fresh_recovery{n}")
    prog = (
        "import pickle, sys\n"
        "import distributedarrays_tpu_torch as tdat\n"
        "import _torch_mh_legs as LEGS\n"
        f"tdat.init(nranks={n}, device='cpu')\n"
        f"res = {{k: f() for k, f in LEGS.recovery_legs(tdat, {n}, "
        f"{str(out)!r})}}\n"
        f"pickle.dump(res, open({str(out / 'res.pkl')!r}, 'wb'))\n")
    env = _env()
    env["PYTHONPATH"] = os.path.dirname(__file__) + os.pathsep + \
        env["PYTHONPATH"]
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    with open(out / "res.pkl", "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("job", ["job2", "job3"])
def test_job_chunked_checkpoint_written_by_owners(job, job2, job3,
                                                  tmp_path_factory):
    # one shared directory: each cell file written by the process that
    # holds its rank only, every cell written once, no region exchange
    # (K10 on the card) on save or on load, the load bit-equal to what
    # was saved and to one process; a corrupt read on one process raises
    # CheckpointIntegrityError on every process
    results = _jobs(job2, job3)[job]
    n = 4 * len(results)
    ref = _port_recovery(n, tmp_path_factory)["ckpt_chunks"]
    names = []
    for q, r in enumerate(results):
        got = r["ckpt_chunks"]
        assert all(rank // 4 == q for _, rank in got["written"]), got
        names += [name for name, _ in got["written"]]
        assert got["save_exchanges"] == got["load_exchanges"] == 0, got
        assert got["corrupt"] == "CheckpointIntegrityError", got
        assert got["step"] == 7
        np.testing.assert_array_equal(got["np"], np.arange(6.0))
        np.testing.assert_array_equal(got["t"], np.arange(5))
        for k, (vals, layout, dt) in got["d"].items():
            want = got["want"][k]
            assert (layout, dt) == (want[1], want[2]) == \
                (ref["d"][k][1], ref["d"][k][2]), k
            assert vals.dtype == want[0].dtype and \
                np.array_equal(vals, want[0]), k
            assert np.array_equal(vals, ref["d"][k][0]), k
    assert sorted(names) == sorted(n for n, _ in ref["written"])
    assert len(set(names)) == len(names)


@pytest.mark.parametrize("job", ["job2", "job3"])
def test_job_chunked_manager_rotates_replicas_on_every_process(
        job, job2, job3, tmp_path_factory):
    # max_to_keep=1 with peer replicas over three saves: process 0 rotates
    # the shared directory, and every process rotates its own replica tier
    # (each holds whole arrays), as one process does
    results = _jobs(job2, job3)[job]
    ref = _port_recovery(4 * len(results),
                         tmp_path_factory)["ckpt_agreement"]
    assert ref["rotated"] == {"steps": [3], "replicas": [3]}
    for r in results:
        assert r["ckpt_agreement"]["rotated"] == ref["rotated"]


@pytest.mark.parametrize("job", ["job2", "job3"])
def test_job_chunked_save_refuses_a_directory_of_each_process(
        job, job2, job3):
    # a direct chunked save with a path of each process's own: every
    # process raises ValueError before any marker is written
    for r in _jobs(job2, job3)[job]:
        got = r["ckpt_agreement"]
        assert got["own_dir"] == "ValueError", got
        assert got["own_marker"] is False


@pytest.mark.parametrize("job", ["job2", "job3"])
def test_job_chunked_restore_failure_after_the_crc_check_is_shared(
        job, job2, job3, tmp_path_factory):
    # a decode that fails on the last process only (after the CRC check):
    # a direct load raises on every process, and the manager's restore
    # falls back to the step before on every process, as one process
    # does, leaving the failed step in place (it is not corrupt)
    results = _jobs(job2, job3)[job]
    ref = _port_recovery(4 * len(results),
                         tmp_path_factory)["ckpt_agreement"]
    assert ref["load_error"] == "CUDA out of memory (simulated)"
    assert ref["restored"]["step"] == 1
    assert ref["restored"]["steps"] == [1, 2]
    for r in results:
        got = r["ckpt_agreement"]
        assert got["load_error"] == ref["load_error"], got
        assert got["restored"]["step"] == 1
        assert got["restored"]["steps"] == [1, 2]
        assert np.array_equal(got["restored"]["x"], ref["restored"]["x"])


def test_c31_relayout_fetches_regions_not_the_whole_array(
        job2, job3, tmp_path_factory):
    # C31: elastic.relayout onto cuts that do not divide the array gathered
    # the whole array onto every target rank in a job; each new cell now
    # fetches its own region (bit-equal to one process)
    for results in (job2, job3):
        n = 4 * len(results)
        ref = _port_recovery(n, tmp_path_factory)["relayout_regions"]
        for r in results:
            got = r["relayout_regions"]
            assert got["moved"] and got["asked"] == got["own"], got
            assert got["layout"] == ref["layout"]
            assert np.array_equal(got["values"], ref["values"])


def test_job_elastic_shrink_and_grow_agree_on_every_process(
        job2, job3, tmp_path_factory):
    # a rank marked down on its own process only: every process shrinks
    # off it and grows back onto it together, as one process does
    for results in (job2, job3):
        n = 4 * len(results)
        ref = _port_recovery(n, tmp_path_factory)["relayout_regions"]
        x = np.arange(1732, dtype=np.float32) * 0.5
        for r in results:
            got = r["relayout_regions"]
            assert got["shrunk"] == ref["shrunk"]
            assert n - 1 not in np.asarray(got["shrunk"]["pids"]).flat
            assert got["grown"] == ref["grown"] == got["before"]
            assert np.array_equal(got["grown_values"], x)


def test_c30_tensor_leaf_restores_on_every_process(job2):
    # C30: a tensor leaf of a checkpoint came back on rank 0's device, a
    # meta placeholder on every other process; JAX restores it on each
    # process's default device
    for r in job2:
        assert r["ckpt"]["t_device"] == "cpu", r["ckpt"]["t_device"]
        np.testing.assert_array_equal(r["ckpt"]["t"], np.arange(4.0))


@pytest.mark.parametrize("job", ["job2", "job3"])
@pytest.mark.parametrize("name", LEGS.RECOVERY_NAMES)
def test_job_trainer_recovers_bit_equal_to_one_process(
        job, name, job2, job3, tmp_path_factory):
    # a device loss (the plan armed on every process, or on the lost
    # rank's process only), a whole process's ranks lost, a resume onto
    # another pinned rank set: every process recovers together, and its
    # losses, flat parameters and final ranks are one process's on the
    # same ranks with the same plan, bit for bit
    results = _jobs(job2, job3)[job]
    n = 4 * len(results)
    ref = _port_recovery(n, tmp_path_factory)[name]
    for q, r in enumerate(results):
        assert name not in r["errors"], \
            f"{job} process {q}: {r['errors'][name]}"
        got = r["recovery"][name]
        moved = [key for key, want in ref.items()
                 if not _bits_equal(got[key], want)]
        if moved:
            # which side moved: the job, or this worker's reference (held
            # against the same legs in a fresh process)
            fresh = _fresh_recovery(n, tmp_path_factory)[name]
            side = "reference" if any(not _bits_equal(ref[k], fresh[k])
                                      for k in moved) else "job"
            k = moved[0]
            pytest.fail(f"the {side} moved: {job} process {q} {moved}; "
                        f"{k} job {_brief(got[k])} reference "
                        f"{_brief(ref[k])} fresh {_brief(fresh[k])}")
    if name == "trainer_loss_replicas":
        assert ref["peer_restores"] == 1     # from buddy-rank memory
    if name == "trainer_process_down":
        assert ref["ranks"] == list(range(n - 4))
    elif name == "trainer_resume_pinned":
        assert ref["ranks"] == list(range(n - 3))
        assert ref["resumed_from"] == 2
    else:
        assert ref["ranks"] == [x for x in range(n) if x != LEGS.LOSS_RANK]


def _jax_recovery(name: str, N: int, root) -> dict:
    """JAX's ``Trainer`` on N devices for the recovery leg ``name``, with
    the same plan, checkpoint cadence and pinned ranks, from the port
    task's initial parameters."""
    import dataclasses
    import jax
    from distributedarrays_tpu.resilience import elastic as jelastic
    from distributedarrays_tpu.resilience import faults as jfaults
    from distributedarrays_tpu.train import optim as JO
    from distributedarrays_tpu.train import tasks as JTasks
    from distributedarrays_tpu.train import trainer as JTrainer
    kind = "transformer" if "transformer" in name else "mlp"
    init = jax.tree_util.tree_map(lambda t: t.numpy(), LEGS.trainer_task(
        kind, N, tdat.train).init_params(torch.Generator().manual_seed(0)))
    jtask = dataclasses.replace(LEGS.trainer_task(kind, N, JTasks),
                                init_params=lambda key: init)
    adam = name in ("trainer_loss_mlp", "trainer_resume_pinned",
                    "trainer_loss_replicas")
    opt = (LEGS.TRAINER_ADAM if adam else LEGS.TRAINER_SGD)
    where = str(root / name)
    plan = None if name == "trainer_resume_pinned" else LEGS.loss_plan(
        N, "process" if name == "trainer_process_down" else "rank")
    jfaults.clear()
    jelastic.manager().reset()
    if plan:
        jfaults.configure(plan=plan, seed=6)
    try:
        with JTrainer.Trainer(jtask, optimizer=JO.Optimizer(**opt),
                              ckpt_dir=where,
                              save_every=LEGS.RECOVERY_SAVE_EVERY,
                              ranks=list(range(N)), seed=0,
                              peer_replicas="replicas" in name) as jt:
            res = jt.fit(2 if plan is None else LEGS.RECOVERY_STEPS)
            out = {"losses": np.asarray(res["losses"]),
                   "flat": np.asarray(jt._state["pflat"])}
        if plan is None:
            with JTrainer.Trainer(jtask, optimizer=JO.Optimizer(**opt),
                                  ckpt_dir=where, ranks=list(range(N - 3)),
                                  seed=0) as jt:
                more = jt.fit(4)
                out.update(resumed=np.asarray(more["losses"]),
                           flat=np.asarray(jt._state["pflat"]))
    finally:
        jfaults.clear()
        jelastic.manager().reset()
    return out


@pytest.mark.parametrize("name", LEGS.RECOVERY_NAMES)
def test_job_trainer_recovery_matches_jax(job2, name, tmp_path):
    # the 2-process job's recoveries against JAX's Trainer with the same
    # plan on its 8-device CPU mesh, at tests/test_torch_train.py's
    # tolerances (losses rtol 1e-5 for the MLP and 1e-4 for the
    # transformer task, flat rtol 1e-4 / atol 1e-6)
    want = _jax_recovery(name, 8, tmp_path)
    rtol = 1e-4 if "transformer" in name else 1e-5
    for r in job2:
        got = r["recovery"][name]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=rtol)
        n = got["flat"].size
        np.testing.assert_allclose(got["flat"], want["flat"][:n], rtol=1e-4,
                                   atol=1e-6)
        if "resumed" in want:
            np.testing.assert_allclose(got["resumed"], want["resumed"],
                                       rtol=rtol)
