"""Child program of the port's multi-process tests
(``tests/test_torch_multihost.py``), the port's form of
``tests/_multihost_child.py``'s smoke stage.

Run as: python tests/_torch_multihost_child.py <store_file> <process_id> \
            <num_processes> <out_dir> <stale_s> [tp_dp | faults]

With ``tp_dp`` it runs only the GSPMD tp/dp legs
(``tests/_torch_mh_legs.py`` ``tp_dp_legs``, for
``tests/test_torch_tp_dp.py``); with ``faults`` only the legs whose
faults split the processes (``_torch_mh_legs.fault_legs``, for
``tests/test_torch_mh_faults.py``), under a store and gloo timeout of
``FAULTS_TIMEOUT_S``, so that a peer of a process that raised alone
leaves the call it waits in soon.

Each process holds 4 CPU ranks; ``num_processes`` of them join one job
through a ``FileStore`` at ``store_file`` (no port to race for) and build
one ``4 * num_processes``-rank table.  The program drives the
process-spanning DArray through construction, ``dsum``,
``host_local_slice``/``localpart`` and ``gather_global``; the operators;
the reductions with ``dims`` None, 0 and 1 and ``dmapreduce``; an uneven
50 x 8 layout and ``d + d``; the other constructors; the live-telemetry
URLs in the job's KV; the ops that run across the processes
(``tests/_torch_mh_legs.py``: the distributed GEMM forms, the
transposes, the reshard and what rests on it, the element reads, ``djit``,
the scans, ``run_spmd`` with the rank-list collectives, ``dsort``, the
FFTs, ``dconv2d``, ring and Ulysses attention, k-means and
``dmatmul_int8``); sequence-parallel training (the flash and zigzag
rings with their gradients, ``tp_ffn``, the SP model's grad function and
train steps) and the data-parallel ``Trainer``
(``_torch_mh_legs.train_legs``), with a step that the straggler gate
aborts and the job recovers (``_torch_mh_legs.trainer_straggler``); the
chunked checkpoint store in one shared directory, ``elastic.relayout``'s
regions and the Trainer's recoveries (``_torch_mh_legs.ckpt_chunks``,
``ckpt_agreement``, ``relayout_regions``, ``recovery_legs``); an npz checkpoint round trip; the
heartbeat census with the last process stale; and a journal with markers
around a ``sync_hosts`` barrier.  It writes what it saw to
``<out_dir>/result_<process_id>.pkl`` for the parent to hold against the
JAX package and the single-process port, and exits 4 with
``MULTIHOST_STARTUP_FAILED`` when the job cannot form in time.
"""

import os
import pickle
import sys
import time

store_file, proc_id = sys.argv[1], int(sys.argv[2])
nprocs, out_dir, stale_s = int(sys.argv[3]), sys.argv[4], float(sys.argv[5])
stage = sys.argv[6] if len(sys.argv) > 6 else None
FAULTS_TIMEOUT_S = 20

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

import distributedarrays_tpu_torch as tdat  # noqa: E402
from distributedarrays_tpu_torch import telemetry  # noqa: E402
from distributedarrays_tpu_torch.parallel import multihost  # noqa: E402
from distributedarrays_tpu_torch.resilience import (  # noqa: E402
    domains, elastic)

try:
    multihost.initialize(f"file://{store_file}", nprocs, proc_id,
                         initialization_timeout_s=FAULTS_TIMEOUT_S
                         if stage == "faults" else 60)
except Exception as e:  # noqa: BLE001 — marker protocol for the parent
    print(f"MULTIHOST_STARTUP_FAILED: {type(e).__name__}: {e}", flush=True)
    sys.exit(4)

telemetry.configure(os.path.join(out_dir, f"journal_{proc_id}.jsonl"))
tdat.init(nranks=4, device="cpu")
N = 4 * nprocs
mine = list(range(4 * proc_id, 4 * proc_id + 4))
res = {"proc": proc_id}

info = multihost.process_info()
assert info == {"process_index": proc_id, "process_count": nprocs,
                "local_devices": 4, "global_devices": N}, info
assert tdat.layout.local_ranks() == mine
assert multihost.global_mesh((N,), ("x",)) == list(range(N))
res["domains"] = domains.topology().domains()
multihost.heartbeat()
multihost.sync_hosts("clock")
res["clock"] = multihost.exchange_clock_offsets()


def layout(d):
    return {"cuts": [list(c) for c in d.cuts], "pids": d.pids.tolist()}


def finish():
    multihost.sync_hosts("done")
    multihost.shutdown()
    with open(os.path.join(out_dir, f"result_{proc_id}.pkl"), "wb") as f:
        pickle.dump(res, f)
    print(f"MULTIHOST_OK proc={proc_id}", flush=True)


if stage == "tp_dp":
    # the tp/dp stage alone (tests/test_torch_tp_dp.py): the legs of
    # _torch_mh_legs.tp_dp_legs, every process the whole results
    import _torch_mh_legs  # noqa: E402
    res["tp_dp"] = {}
    for name, thunk in _torch_mh_legs.tp_dp_legs(tdat, N):
        _torch_mh_legs.progress(f"tp_dp/{name}")
        res["tp_dp"][name] = _torch_mh_legs.summary(
            tdat, multihost.gather_global, thunk())[0]
    finish()
    sys.exit(0)

if stage == "faults":
    # the legs whose faults split the processes (tests/test_torch_mh_
    # faults.py), each judged on its own: a leg that raises on any process
    # is agreed on through the store and the job realigns before the next
    import _torch_mh_legs  # noqa: E402
    res["faults"], res["errors"] = _torch_mh_legs.run_legs(
        tdat, _torch_mh_legs.fault_legs(tdat, N, out_dir), "faults")
    finish()
    sys.exit(0)


def bits(t):
    """A 0-d result's exact value, as a float64-free numpy scalar."""
    return t.detach().cpu().numpy()


# --- construction, dsum, host-local slices, the gather ------------------
A = np.arange(2.0 * N, dtype=np.float32)
d = tdat.distribute(A)                     # default layout spans processes
assert tdat.layout.spans_processes(d.pids)
res["A"] = layout(d)
res["A_sum"] = bits(tdat.dsum(d))
local = multihost.host_local_slice(d)
res["local_pids"] = [p for p, _ in local]
res["local_parts"] = [lp.numpy().copy() for _, lp in local]
other = (mine[-1] + 1) % N
try:
    d.localpart(other)
    res["remote_localpart"] = "returned"
except RuntimeError:
    res["remote_localpart"] = "raised"
res["A_gather"] = multihost.gather_global(d)
res["A_asarray"] = np.asarray(d)
res["A_full"] = d.full().numpy()
res["A_live_bytes"] = telemetry.memory.live_bytes()

# --- operators and dmap, per local rank ---------------------------------
X = np.linspace(-1.0, 1.0, 64, dtype=np.float32).reshape(16, 4)
Y = np.cos(np.arange(64, dtype=np.float32)).reshape(16, 4)
dx, dy = tdat.distribute(X), tdat.distribute(Y)
ew = tdat.dmap(torch.sin, dx) * 2 + 1
chain = tdat.dmap(torch.sin, dx) + dy * dx
res["ew"] = multihost.gather_global(ew)
res["ew_layout"] = layout(ew)
res["chain"] = multihost.gather_global(chain)
into = tdat.dzeros((16, 4))
tdat.dmap_into(torch.cos, into, dx)
res["into"] = multihost.gather_global(into)

# --- reductions: dims None, 0 and 1, and dmapreduce ---------------------
red = {}
for name, fn in (("sum", tdat.dsum), ("prod", tdat.dprod),
                 ("max", tdat.dmaximum), ("min", tdat.dminimum),
                 ("mean", tdat.dmean)):
    red[name] = bits(fn(chain))
    for dims in (0, 1):
        r = fn(chain, dims=dims)
        red[f"{name}_{dims}"] = (multihost.gather_global(r), layout(r))
red["mapreduce"] = bits(tdat.dmapreduce(torch.square, "sum", chain))
red["mapreduce_1"] = multihost.gather_global(
    tdat.dmapreduce(torch.square, "sum", chain, dims=1))
red["sum_AA"] = bits(tdat.dsum(dx * dx))
res["reductions"] = red

# --- uneven: 50 x 8 on (N/2, 2) -----------------------------------------
U = np.arange(50.0 * 8, dtype=np.float32).reshape(50, 8)
du = tdat.distribute(U, procs=range(N), dist=(N // 2, 2))
res["U"] = layout(du)
res["U_gather"] = multihost.gather_global(du)
res["U2"] = multihost.gather_global(du + du)
res["U_sum0"] = multihost.gather_global(tdat.dsum(du, dims=0))

# --- a DArray on process 0's ranks only: the others hold placeholders ---
sub = tdat.distribute(X, procs=range(4))
res["subset"] = {"layout": layout(sub), "sum": bits(tdat.dsum(sub)),
                 "sum_0": multihost.gather_global(tdat.dsum(sub, dims=0)),
                 "gather": multihost.gather_global(sub)}

# --- random constructors: a rank's values do not depend on its process --
tdat.seed(99)
R = tdat.drand((16, 4))
res["drand"] = multihost.gather_global(R)

# --- the other constructors: each process fills its own ranks ----------
tdat.seed(5)
ctors = {
    "dzeros": tdat.dzeros((16, 4)),
    "dones": tdat.dones((16, 4), dtype=torch.int32),
    "dfill": tdat.dfill(2.5, (16, 4)),
    "drandn": tdat.drandn((16, 4)),
    "drandint": tdat.drandint(0, 9, (16, 4)),
    "dfromfunction": tdat.dfromfunction(lambda i, j: i * 10 + j, (16, 4)),
    "darray": tdat.darray(lambda idx: np.full(
        [len(r) for r in idx], idx[0].start, np.float32), (16, 4)),
}
res["ctors"] = {k: (multihost.gather_global(v), layout(v), str(v.dtype))
                for k, v in ctors.items()}

# --- the live-telemetry URLs in the job's KV ----------------------------
if proc_id == 0:
    res["advertised"] = multihost.advertise_aggregator("http://agg:9100")
multihost.sync_hosts("aggregator")
res["aggregator"] = multihost.aggregator_endpoint()
res["exporter"] = multihost.advertise_exporter()

# --- the ops with a cross-process form (tests/_torch_mh_legs.py) --------
# each leg's result, and every meta tensor a caller was handed; the
# mappings a region call opens are closed by its end
import _torch_mh_legs  # noqa: E402
from distributedarrays_tpu_torch.ops import cuda_collectives  # noqa: E402

res["ported"], res["meta"] = {}, {}
for name, thunk in _torch_mh_legs.legs(tdat, N):
    _torch_mh_legs.progress(f"ported/{name}")
    got, meta = _torch_mh_legs.summary(tdat, multihost.gather_global,
                                       thunk())
    res["ported"][name] = got
    if meta:
        res["meta"][name] = meta
res["open_mappings"] = cuda_collectives.open_mappings()

# --- sequence-parallel training across the processes ---------------------
# (the flash and zigzag rings, tp_ffn, the SP model's steps); a leg that
# raises is recorded, so the tests name the error, and the next leg runs
# from the same state on every process (_torch_mh_legs.run_legs)
trained, res["errors"] = _torch_mh_legs.run_legs(
    tdat, _torch_mh_legs.train_legs(tdat, N), "train",
    lambda thunk: _torch_mh_legs.summary(tdat, multihost.gather_global,
                                         thunk()))
for name, (got, meta) in trained.items():
    res["ported"][name] = got
    if meta:
        res["meta"][name] = meta
res["open_mappings"] = max(res["open_mappings"],
                           cuda_collectives.open_mappings())

# --- the Trainer: a step that the straggler gate aborts, then recovers --
_torch_mh_legs.progress("straggler")
res["straggler"] = _torch_mh_legs.trainer_straggler(tdat, N, proc_id, nprocs)

# --- the chunked store, the relayout's regions, the Trainer's recovery --
_torch_mh_legs.progress("ckpt_chunks")
res["ckpt_chunks"] = _torch_mh_legs.ckpt_chunks(tdat, N, out_dir)
_torch_mh_legs.progress("ckpt_agreement")
res["ckpt_agreement"] = _torch_mh_legs.ckpt_agreement(tdat, N, out_dir)
_torch_mh_legs.progress("relayout_regions")
res["relayout_regions"] = _torch_mh_legs.relayout_regions(tdat, N)
res["recovery"], errors = _torch_mh_legs.run_legs(
    tdat, _torch_mh_legs.recovery_legs(tdat, N, out_dir), "recovery")
res["errors"].update(errors)

# --- checkpoint round trip ----------------------------------------------
ck = np.random.default_rng(7).standard_normal((16, 4)).astype(np.float32)
dck = tdat.distribute(ck)
path = os.path.join(out_dir, f"ck_proc{proc_id}")
tdat.checkpoint.save(path, {"w": dck, "step": 3, "t": torch.arange(4.0)})
back = tdat.checkpoint.load(path)
res["ckpt"] = {"step": back["step"], "w": multihost.gather_global(back["w"]),
               "layout": layout(back["w"]), "saved": layout(dck),
               "t_device": back["t"].device.type,
               "t": None if back["t"].device.type == "meta"
               else back["t"].numpy()}

# --- heartbeat census: the last process stops heartbeating --------------
last = nprocs - 1
multihost.heartbeat()
multihost.sync_hosts("census0")
res["census_fresh"] = (sorted(multihost.down_peer_processes(stale_s)),
                       multihost.quorum_assess(stale_s)["verdict"])
multihost.sync_hosts("census1")
t0 = time.monotonic()
deadline = t0 + 10 * stale_s
census = {}
if proc_id != last:
    down = set()
    while down != {last}:
        assert time.monotonic() < deadline, f"census never saw {last}: {down}"
        multihost.heartbeat()
        down = multihost.down_peer_processes(stale_s)
        time.sleep(0.05)
    census["latency_s"] = time.monotonic() - t0
    census["down"] = sorted(down)
    q = multihost.quorum_assess(stale_s)
    # the elastic manager's probe reads the same census at its default
    # staleness; the test sets that default to the census's
    multihost.down_peer_processes.__defaults__ = (stale_s,)
    multihost.quorum_assess.__defaults__ = (stale_s,)
    probe = elastic.manager().probe()
    census["probe_down"] = probe["down"]
    census["probe_verdict"] = probe["partition"]["verdict"]
else:
    q = multihost.quorum_assess(stale_s)
    while q["verdict"] == "healthy":
        assert time.monotonic() < deadline, "own heartbeat never went stale"
        time.sleep(0.05)
        q = multihost.quorum_assess(stale_s)
    census["latency_s"] = time.monotonic() - t0
census.update(verdict=q["verdict"], side=q["side"], lost=q["lost"],
              reason=q["reason"])
res["census"] = census
multihost.sync_hosts("census2")

# --- the journal: markers around a barrier ------------------------------
telemetry.event("smoke", "before_barrier", process=proc_id)
multihost.sync_hosts("journal")
telemetry.event("smoke", "after_barrier", process=proc_id)

tdat.d_closeall()
res["live_after_close"] = telemetry.memory.live_bytes()
finish()
