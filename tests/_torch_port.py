"""Shared set-up of the parity tests between the JAX package and its
PyTorch port (``tests/test_torch_*.py``).

The port runs on 8 CPU ranks, mirroring the 8 virtual XLA devices of the
JAX harness; inputs are made with seeded numpy and handed to both packages.
The port keeps its own DArray registry, which the conftest leak gate does
not read, so the fixture closes what each test made and checks that the
port's registry is empty afterwards.
"""

import collections
import copy
import importlib

import numpy as np
import pytest
import torch

import distributedarrays_tpu_torch as tdat


@pytest.fixture(autouse=True)
def port_ranks():
    # tier-1 runs several pytest workers: keep each to one intra-op thread
    torch.set_num_threads(1)
    tdat.init(nranks=8, device="cpu")
    tdat.seed(1234)
    tdat.autotune.clear()
    yield
    tdat.autotune.clear()
    tdat.d_closeall()
    assert tdat.live_ids() == []


# the JAX package's process-wide state that a port test can touch through
# the JAX calls it compares against: warn-once keys, the fault plan, the
# telemetry registry, spans, flight bundles, the memory ledger's peaks
# and the domain topology.  Its own tests read that state (a warning that
# fires once, counters, events by offset), so a port test leaves it as it
# found it.
_JAX_STATE = {
    "distributedarrays_tpu.utils.debug": ("_warned",),
    "distributedarrays_tpu.resilience.faults": ("_injector", "_env_checked"),
    "distributedarrays_tpu.resilience.domains": ("_topo",),
    "distributedarrays_tpu.telemetry.core": (
        "_ENABLED", "_counters", "_gauges", "_hists", "_comm", "_events",
        "_events_total", "_once_keys", "_incident_id", "_incident_seq"),
    "distributedarrays_tpu.telemetry.tracing": (
        "_finished", "_finished_total", "_stats", "_open"),
    "distributedarrays_tpu.telemetry.flight": (
        "_bundled_excs", "_bundles_written", "_crash_bundles",
        "_last_bundle", "_last_path"),
    # peaks only: the live totals drain as the test's arrays close
    "distributedarrays_tpu.telemetry.memory": (
        "_peak_total", "_peak_dev", "_staging_peak", "_staging_peak_tag"),
}
_ELASTIC_MARKS = ("_manual_down", "_sim_down", "_hw_down", "_shrunk",
                  "_expected", "_partition")


def _snapshot(v):
    if isinstance(v, collections.deque):
        return collections.deque(copy.deepcopy(list(v)), maxlen=v.maxlen)
    if isinstance(v, (dict, set, list)):
        try:
            return copy.deepcopy(v)
        except TypeError:             # values that hold locks or weakrefs
            return copy.copy(v)
    return v


def _restore(obj, name, saved):
    cur = getattr(obj, name)
    if cur is not saved and type(cur) is type(saved) and \
            isinstance(cur, (dict, set, list, collections.deque)):
        cur.clear()                   # in place: other modules hold it
        if isinstance(cur, dict):
            cur.update(saved)
        elif isinstance(cur, set):
            cur.update(saved)
        else:
            cur.extend(saved)
    else:
        setattr(obj, name, saved)


@pytest.fixture(autouse=True)
def jax_process_state():
    """Snapshot the JAX package's process-wide state before the test and
    put it back after, whatever the test did through JAX calls."""
    mods = {m: importlib.import_module(m) for m in _JAX_STATE}
    saved = {(m, a): _snapshot(getattr(mods[m], a))
             for m, attrs in _JAX_STATE.items() for a in attrs}
    from distributedarrays_tpu.resilience import elastic as JE
    mgr = JE._manager
    marks = {a: _snapshot(getattr(mgr, a)) for a in _ELASTIC_MARKS} \
        if mgr is not None else None
    yield
    for (m, a), v in saved.items():
        _restore(mods[m], a, v)
    if mgr is None:
        JE._manager = None
    else:
        JE._manager = mgr
        for a, v in marks.items():
            _restore(mgr, a, v)


@pytest.fixture(autouse=True, scope="module")
def jax_plan_cache():
    """Empty the JAX reshard planner's cache when the module ends: its key
    leaves out the domain topology (ROADMAP C6), so a plan that a port
    file's JAX calls built must not reach a later test on the worker."""
    yield
    from distributedarrays_tpu.parallel import reshard as JR
    JR._plan_cached.cache_clear()


def state_of(d) -> dict:
    """A JAX DArray's state in the form ``interop.from_reference`` takes."""
    return {"array": np.asarray(d), "cuts": d.cuts, "pids": d.pids}


def same_layout(jd, td) -> None:
    """Assert that a JAX DArray and a port DArray have one layout."""
    assert tuple(td.dims) == tuple(jd.dims)
    assert [list(c) for c in td.cuts] == [list(c) for c in jd.cuts]
    np.testing.assert_array_equal(td.pids, jd.pids)


# the dtypes and shapes of the dtype parity cases (ROADMAP.md C1-C5)
TYPED_DTYPES = ["float16", "bfloat16", "uint8", "int8", "bool"]
TYPED_SHAPES = [(37, 11), (50, 8), (13,), (9, 7, 5)]


def typed_inputs(dtype: str, shape, seed: int, lo=-100.0, hi=100.0):
    """The same seeded values as a numpy array for the JAX package (bfloat16
    as ``ml_dtypes.bfloat16``) and as a tensor for the port: integers over
    the type's range, bools at random, floats uniform in [lo, hi) rounded
    once to the type."""
    import ml_dtypes
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        a = rng.integers(0, 2, shape).astype(bool)
    elif dtype in ("uint8", "int8"):
        info = np.iinfo(dtype)
        a = rng.integers(info.min, info.max + 1, shape).astype(dtype)
    else:
        f = rng.uniform(lo, hi, shape).astype(np.float32)
        if dtype == "bfloat16":
            return f.astype(ml_dtypes.bfloat16), torch.from_numpy(f).bfloat16()
        a = f.astype(dtype)
    return a, torch.from_numpy(a)


def typed_result(x) -> tuple:
    """A JAX or port result (array, tensor or DArray) as its dtype's name
    and its values in float64 (bool kept)."""
    if isinstance(x, tdat.DArray):
        x = x.full()
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).removeprefix("torch.")
        v = x if x.dtype == torch.bool else x.to(torch.float64)
        return name, v.numpy()
    a = np.asarray(x)
    return a.dtype.name, a if a.dtype == bool else a.astype(np.float64)


def assert_typed_equal(port, jax_result, rtol: float = 0.0) -> None:
    """Same dtype and the same values: bit for bit (infs included), or to
    ``rtol`` where the caller states why."""
    (pn, pv), (jn, jv) = typed_result(port), typed_result(jax_result)
    assert pn == jn, f"dtype {pn} != JAX's {jn}"
    if rtol:
        np.testing.assert_allclose(pv, jv, rtol=rtol)
    else:
        np.testing.assert_array_equal(pv, jv)


def emulated_copies(calls):
    """A stand-in for ``cuda_collectives._copy_on_card`` that runs the copy
    kernel's semantics on host memory (each copy's boxes moved row by row
    with ``memmove``) and records ``(kernel, launches)``: with ``_on_cuda``
    stubbed to True, the CUDA path of a collective runs on CPU tensors."""
    import ctypes
    import itertools

    from distributedarrays_tpu_torch.ops import cuda_collectives as C

    def run(copies, dev, kernel, route=None):
        launches = C.copy_launches(copies)
        calls.append((kernel, len(launches)))
        for launch in launches:
            for src, (sizes, sstr, run_b), part in launch:
                for dst, dstr in part:
                    for i, j, k in itertools.product(*map(range, sizes)):
                        ctypes.memmove(
                            dst + i * dstr[0] + j * dstr[1] + k * dstr[2],
                            src + i * sstr[0] + j * sstr[1] + k * sstr[2],
                            run_b)
    return run


# a job of several child processes is hung when neither its store (which
# the port's barriers and keyed exchanges write) nor any child's output
# (a child prints a line at the start and the end of every leg,
# _torch_mh_legs.progress, since gloo's own exchanges write neither) has
# grown for JOB_STALL_S: twice the children's own store and gloo timeout,
# past which a call that waits for a peer raises in the child.  JOB_CAP_S
# bounds the job whatever it writes.
JOB_STALL_S = 120
JOB_CAP_S = 600


def run_job(argvs, out_dir, env, store, stall_s: float = JOB_STALL_S,
            cap_s: float = JOB_CAP_S) -> list:
    """Run one child process a command of ``argvs`` until every one has
    exited, each writing its output to ``out_dir/out_<i>.txt`` (a pipe
    that nothing drains would block a child that writes much while the
    others wait for it); ``[(returncode, output)]`` in order.  A job that
    makes no progress (``store`` and the outputs unchanged for
    ``stall_s``) or outlives ``cap_s`` is killed, and the test fails with
    every child's output."""
    import os
    import subprocess
    import time
    paths = [os.path.join(out_dir, f"out_{i}.txt") for i in range(len(argvs))]
    logs = [open(p, "w") for p in paths]
    procs = [subprocess.Popen(argv, stdout=log, stderr=subprocess.STDOUT,
                              env=env) for argv, log in zip(argvs, logs)]

    def size(path):
        try:
            return os.path.getsize(path)
        except OSError:
            return -1
    start = last = time.monotonic()
    seen = None
    why = None
    try:
        while any(p.poll() is None for p in procs):
            now = time.monotonic()
            sig = (size(store), *map(size, paths))
            if sig != seen:
                seen, last = sig, now
            if now - last > stall_s:
                why = f"made no progress for {stall_s} s"
            elif now - start > cap_s:
                why = f"ran past {cap_s} s"
            if why:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    outs = [open(p, errors="replace").read() for p in paths]
    if why:
        pytest.fail(f"port multi-process children: the job {why}; "
                    f"output: " + "\n".join(
                        f"[process {i}] {out[-4000:]}"
                        for i, out in enumerate(outs)))
    return [(p.returncode, out) for p, out in zip(procs, outs)]
