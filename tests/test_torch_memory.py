"""The port's memory ledger (``telemetry/memory.py``) against the JAX
package's: one sequence of constructors, region writes, ``fill_``,
``rand_``, ``set_localpart``, ``copyto_``, shares and closes through both
gives equal live bytes, per-rank bytes (JAX's per-device map: its device
ids are its ranks), peaks and tracked counts on even layouts, exactly.

Site labels: the port labels an entry with the call that last allocated
or wrote its tensors, one label per call site.  JAX allocates a new
buffer for every write; on a layout it pads the write keeps its own label
(``fill_``, ``rand_``, ``mutate``, ``set_localpart``), so the labels are
equal; on an even layout it goes through ``_rebind`` and takes that label
(``as_jax`` maps the port's labels to JAX's).  The port's in-place writes
journal no ``hbm`` event, where JAX's journal an ``alloc``.

Where JAX pads (a dim whose chunks differ in size, e.g. (50, 8) over
(4, 2)), its blocks cost it the padded bytes; the port's exact-size rank
tensors cost their own ``nbytes``.  Those cases hold each package to its
own layout (the port to the sum of its rank tensors, JAX to its padded
blocks).  JAX's aligned ``samedist`` shares its buffer (counted once); the
port's copies (it owns the copy): that case holds the port to twice the
bytes.  Staging: JAX's gauge counts its XLA dispatch's planned chunk
piece, the port's the bytes its chain really holds between steps; each
is held to its own rule."""

import gc
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import distributedarrays_tpu as dat
import distributedarrays_tpu_torch as tdat
from distributedarrays_tpu import telemetry as JT
from distributedarrays_tpu.telemetry import memory as JM
from distributedarrays_tpu_torch import telemetry as TT
from distributedarrays_tpu_torch.telemetry import memory as TM

from _torch_port import (jax_plan_cache, jax_process_state,  # noqa: F401
                         port_ranks)

PKGS = [(dat, JT, JM), (tdat, TT, TM)]
# the port's labels of in-place writes
IN_PLACE = {"fill_", "rand_", "mutate", "set_localpart"}


def as_jax(site: str, padded: bool = False) -> str:
    """The label JAX's ledger gives the buffer of a port entry labelled
    ``site``: an in-place write on an even layout goes through JAX's
    ``_rebind``; on a layout JAX pads it keeps its own label."""
    return "rebind" if site in IN_PLACE and not padded else site


@pytest.fixture(autouse=True)
def ledgers(port_ranks):
    for pkg, tm, _ in PKGS:
        pkg.d_closeall()
        tm.enable()
        tm.reset()
    yield
    tdat.d_closeall()
    TT.enable()
    TT.reset()


def per_rank(M):
    """Live bytes by rank: the port's ``live_bytes_by_rank``; JAX's
    ``live_bytes_by_device`` (its device ids are the ranks)."""
    return (M.live_bytes_by_rank() if M is TM
            else {int(k): v for k, v in M.live_bytes_by_device().items()})


def state(M):
    """The ledger's state, with the port's site labels as JAX gives them
    on even layouts."""
    return {"live": M.live_bytes(), "by_rank": per_rank(M),
            "peak": M.peak_bytes(), "count": M.tracked_count(),
            "sites": sorted(as_jax(e["site"]) if M is TM else e["site"]
                            for e in M.entries())}


def rank_bytes(*ds) -> int:
    """The exact bytes of the port DArrays' rank tensors."""
    return sum(t.nbytes for d in ds for t in d._parts.flat)


def script(pkg, M, rng_seed: int = 5):
    """Constructors, writes, fills, copies and closes on even layouts; the
    ledger's state after each step."""
    rng = np.random.default_rng(rng_seed)
    out = []
    a = pkg.dzeros((64, 64))
    out.append(state(M))
    b = pkg.drand((48, 16), dist=(4, 2))
    out.append(state(M))
    c = pkg.dones((32,), procs=[0, 1, 2, 3])
    out.append(state(M))
    b.fill_(2.0)
    out.append(state(M))
    b.rand_()
    out.append(state(M))
    a[3:9, :] = 1.0
    out.append(state(M))
    c.set_localpart(np.full(8, 7.0, np.float32), 1)
    out.append(state(M))
    e = pkg.distribute(rng.standard_normal((16, 40)).astype(np.float32),
                       procs=[2, 3, 4, 5], dist=(2, 2))
    out.append(state(M))
    pkg.copyto_(a, rng.standard_normal((64, 64)).astype(np.float32))
    out.append(state(M))
    b.close()
    out.append(state(M))
    f = pkg.dfill(3, (24, 24))
    out.append(state(M))
    f2 = f.copy()
    out.append(state(M))
    for d in (c, f):
        d.close()
    out.append(state(M))
    pkg.d_closeall()
    out.append(state(M))
    del a, e, f2
    return out


def test_ledger_sequence_equals_jax():
    got = {}
    for pkg, _, M in PKGS:
        M.reset_peak()
        got[M] = script(pkg, M)
    assert got[TM] == got[JM]
    assert got[TM][-1]["live"] == 0 and got[TM][-1]["count"] == 0
    assert max(s["peak"] for s in got[TM]) > 0


def test_every_step_counts_the_rank_tensors():
    a = tdat.drand((37, 11), dist=(4, 2))
    b = tdat.dzeros((5, 6, 7), dtype=torch.int8)
    c = tdat.drand((100,), dtype=torch.bfloat16, procs=[3, 1])
    want = rank_bytes(a, b, c)
    assert TM.live_bytes() == want
    assert TM.live_bytes(torch.device("cpu")) == want
    assert TM.live_bytes_by_device() == {torch.device("cpu"): want}
    by_rank = TM.live_bytes_by_rank()
    for r in range(8):
        assert by_rank.get(r, 0) == sum(
            t.nbytes for d in (a, b, c) for ci, t in np.ndenumerate(d._parts)
            if int(d.pids[ci]) == r)
        assert TM.live_bytes(r) == by_rank.get(r, 0)
    a.close()
    assert TM.live_bytes() == rank_bytes(b, c)
    tdat.d_closeall()
    assert TM.live_bytes() == 0 and TM.tracked_count() == 0


def write_sequence(pkg, M, dims, dist) -> tuple[list, object]:
    """``fill_``, ``rand_``, a region write and ``set_localpart`` on a new
    DArray: the entry's site label after each step, and the DArray."""
    d = pkg.drand(dims, dist=dist)
    seq = [M.entries()[0]["site"]]
    d.fill_(1.5)
    seq.append(M.entries()[0]["site"])
    d.rand_()
    seq.append(M.entries()[0]["site"])
    d[(slice(1, 4),) + (slice(None),) * (len(dims) - 1)] = 0.5
    seq.append(M.entries()[0]["site"])
    ci = (0,) * len(dims)
    shape = tuple(len(r) for r in d.indices[ci])
    d.set_localpart(np.ones(shape, np.float32), int(d.pids[ci]))
    seq.append(M.entries()[0]["site"])
    return seq, d


CALL_SITES = ["ctor", "fill_", "rand_", "mutate", "set_localpart"]


@pytest.mark.parametrize("dims,dist", [((50, 8), (4, 2)), ((37, 11), None),
                                       ((13,), None), ((9, 7, 5), None)])
def test_padded_layouts_each_to_its_own_bytes(dims, dist):
    """JAX pads these blocks, the port does not: JAX counts its padded
    shards, the port its exact rank tensors; the site labels agree,
    ``fill_``/``rand_``/``set_localpart``/``mutate`` included."""
    sites = {}
    for pkg, _, M in PKGS:
        sites[M], d = write_sequence(pkg, M, dims, dist)
        if M is TM:
            assert TM.live_bytes() == rank_bytes(d)
        else:
            padded = int(np.prod(d._data.shape)) * 4   # the blocked buffer
            assert JM.live_bytes() == padded > int(np.prod(dims)) * 4
        d.close()
        assert M.live_bytes() == 0
    assert sites[TM] == sites[JM] == CALL_SITES
    assert [as_jax(s, padded=True) for s in sites[TM]] == sites[JM]


@pytest.mark.parametrize("dims,dist", [((48, 16), (4, 2)), ((64,), None)])
def test_even_layout_labels_map_to_jax(dims, dist):
    """On an even layout JAX's writes go through ``_rebind``; the port keeps
    each call site's label, the same bytes and one entry throughout."""
    sites = {}
    for pkg, _, M in PKGS:
        sites[M], d = write_sequence(pkg, M, dims, dist)
        assert M.live_bytes() == int(np.prod(dims)) * 4
        assert M.tracked_count() == 1
        d.close()
    assert sites[TM] == CALL_SITES
    assert sites[JM] == ["ctor"] + ["rebind"] * 4
    assert [as_jax(s) for s in sites[TM]] == sites[JM]


def test_share_counts_once_like_jax():
    """``share`` (JAX's ``_BufShare`` join) on two arrays of the same size:
    the shared bytes are counted once and freed by the last owner."""
    out = {}
    for pkg, _, M in PKGS:
        a = pkg.dzeros((32, 32))
        b = pkg.dzeros((32, 32))
        seq = [M.live_bytes()]
        M.share(a.id, b.id)
        seq += [M.live_bytes(), M.tracked_count()]
        M.untrack(a.id)
        seq += [M.live_bytes(), M.tracked_count()]
        M.untrack(b.id)
        seq += [M.live_bytes(), M.tracked_count()]
        out[M] = seq
        for d in (a, b):
            d.close()
    assert out[TM] == out[JM] == [8192, 4096, 1, 4096, 1, 0, 0]


def test_aligned_samedist_port_owns_its_copy():
    """JAX's aligned ``samedist`` shares the buffer (one entry); the port's
    result owns a copy, so it holds twice the bytes in two entries."""
    ja = dat.drand((32, 16))
    jb = dat.samedist(ja, ja)
    assert JM.live_bytes() == 32 * 16 * 4 and JM.tracked_count() == 1
    ta = tdat.drand((32, 16))
    tb = tdat.samedist(ta, ta)
    assert TM.live_bytes() == 2 * 32 * 16 * 4 == rank_bytes(ta, tb)
    assert TM.tracked_count() == 2
    for d in (ja, jb, ta, tb):
        d.close()
    assert JM.live_bytes() == TM.live_bytes() == 0


def jax_staging_piece(plan) -> int:
    """The piece JAX's gauge counts for a collective plan (its XLA
    dispatch, ``reshard.py:1140-1161``): a chain's worst step piece, else
    one chunk of the local shard."""
    if plan.staging_bytes:
        return plan.staging_bytes
    local = plan.total_bytes // max(plan.nparts, 1)
    return -(-local // max(plan.nchunks, 1))


@pytest.mark.parametrize("src,dst", [((4, 1), (1, 4)), ((4, 2), (2, 4)),
                                     ((8, 1), (2, 4))])
def test_reshard_staging_peak_each_to_its_own_rule(src, dst, monkeypatch):
    """JAX's staging peak is its planned piece for the port's plan (the two
    planners agree); the port's is the most bytes its chain held between
    two steps (an all-to-all stages nothing).  The gauges drain."""
    from distributedarrays_tpu_torch.parallel import reshard as TR
    steps = []
    real = TR.chain_step

    def counted(*a, **kw):
        out = real(*a, **kw)
        steps.append(sum(t.nbytes for t in out if t is not None))
        return out
    monkeypatch.setattr(TR, "chain_step", counted)
    peaks, plans = {}, {}
    for pkg, _, M in PKGS:
        M.reset_peak()
        x = pkg.drand((64, 64), dist=src)
        like = pkg.dzeros((64, 64), dist=dst)
        if M is TM:
            plans[M] = TR.plan_reshard(x, like.pids, like.cuts)
        y = pkg.samedist(x, like)
        peaks[M] = {t: M.staging_peak(t) for t in
                    ("reshard.all_to_all", "reshard.chain")}
        assert M.snapshot()["staging"]["live_bytes"] == 0
        for d in (x, like, y):
            d.close()
    plan = plans[TM]
    tag = f"reshard.{plan.strategy}"
    assert peaks[JM] == {t: (jax_staging_piece(plan) if t == tag else 0)
                         for t in peaks[JM]}
    # the last step's outputs are the result, not staging
    assert peaks[TM] == {"reshard.all_to_all": 0,
                         "reshard.chain": max(steps[:-1], default=0)}
    assert plan.strategy == "all_to_all" or len(steps) > 1
    assert (peaks[TM]["reshard.chain"] > 0) == (plan.strategy == "chain")


def test_d_closeall_drains_and_journals_like_jax():
    ev = {}
    for pkg, tm, M in PKGS:
        keep = [pkg.dzeros((64, 64)), pkg.drand((16, 40), procs=[1, 2])]
        assert M.live_bytes() == 64 * 64 * 4 + 16 * 40 * 4
        pkg.d_closeall()
        assert all(d._closed for d in keep)
        assert M.live_bytes() == 0 and M.tracked_count() == 0
        e = [x for x in tm.events("lifecycle") if x["name"] == "closeall"]
        ev[M] = {k: e[-1][k] for k in ("closed", "errors", "freed_bytes")}
    assert ev[TM] == ev[JM] == {"closed": 2, "errors": 0,
                                "freed_bytes": 64 * 64 * 4 + 16 * 40 * 4}


def test_hbm_events_equal_jax():
    """The journal's ``hbm`` alloc/free events carry the same bytes, live
    totals and sites (through ``as_jax``), but for the ``alloc`` JAX's
    ``fill_`` journals for its new buffer: the port writes in place."""
    out = {}
    for pkg, tm, M in PKGS:
        a = pkg.dzeros((16, 16))
        b = pkg.dones((8, 8), procs=[0, 1])
        a.fill_(1.0)
        a.close()
        b.close()
        out[M] = [(e["name"], e["bytes"], e["live"],
                   as_jax(e["site"]) if M is TM else e["site"])
                  for e in tm.events("hbm")]
    assert out[JM][2] == ("alloc", 1024, 1024 + 256, "rebind")
    assert out[TM] == out[JM][:2] + out[JM][3:]
    assert [n for n, *_ in out[TM]] == ["alloc", "alloc", "free", "free"]


def test_finalizer_releases_the_entry():
    d = tdat.dzeros((32, 32))
    assert TM.live_bytes() == 4096
    del d
    gc.collect()
    assert TM.live_bytes() == 0 and TM.tracked_count() == 0


def test_disable_midway_still_drains():
    d = tdat.dzeros((16, 16))
    TT.disable()
    try:
        e = tdat.dzeros((16, 16))            # not tracked while disabled
        assert TM.tracked_count() == 1
        d.close()
        e.close()
        assert TM.live_bytes() == 0
    finally:
        TT.enable()


def test_reset_peak_and_snapshot_sections():
    a = tdat.dzeros((64, 64))
    b = tdat.dzeros((64, 64))
    b.close()
    assert TM.peak_bytes() == 2 * 16384
    assert TM.peak_bytes(0) == 2 * 16384 // 8
    TM.reset_peak()
    assert TM.peak_bytes() == TM.live_bytes() == 16384
    snap = TT.report()["memory"]
    assert snap["live_bytes"] == 16384 and snap["tracked_arrays"] == 1
    assert snap["by_device"] == {"cpu": {"live_bytes": 16384,
                                         "peak_bytes": 16384}}
    assert sum(v["live_bytes"] for v in snap["by_rank"].values()) == 16384
    assert snap["top_sites"] == [["ctor", 16384, 1]]
    json.dumps(TT.report())
    a.close()


def test_span_attribution():
    with TT.span("my.alloc"):
        d = tdat.dzeros((8, 8))
    e = TM.entries()[0]
    assert e["span"] == "my.alloc" and e["site"] == "ctor"
    assert e["stack"] and TM.snapshot()["top_sites"][0][0] == "my.alloc"
    d.close()


def test_leak_census_classifies_three_ways():
    d = tdat.drand((16, 8))
    foreign = torch.zeros(100)                       # no ledger entry
    held = np.empty(1, dtype=object)
    held[0] = torch.zeros(10)
    TM.track(("test", 1), held)                      # dropped, never freed
    del held
    gc.collect()
    c = TM.leak_census()
    assert c["ledger_tracked"] == {"bytes": rank_bytes(d),
                                   "count": d._parts.size}
    assert c["untracked_foreign"]["bytes"] >= foreign.nbytes
    assert c["deleted_but_registered"] == {"bytes": 40, "count": 1}
    assert c["jax_live_arrays"] == (c["ledger_tracked"]["count"]
                                    + c["untracked_foreign"]["count"])
    TM.untrack(("test", 1))
    d.close()


def test_elastic_relayout_keeps_the_owner():
    """A shrink re-lays a DArray onto the survivors: the same owner, the
    ``elastic`` site, the bytes on the survivors' ranks only."""
    from distributedarrays_tpu_torch.resilience import elastic as TE
    d = tdat.drand((64, 16), procs=[0, 1, 2, 3])
    before = TM.live_bytes()
    mgr = TE.manager()
    try:
        for r in (3, 4, 5, 6, 7):
            mgr.mark_down(r)
        mgr.shrink()
        assert [int(p) for p in d.pids.flat] == [0, 1, 2]
        assert TM.live_bytes() == before == rank_bytes(d)
        assert set(TM.live_bytes_by_rank()) == {0, 1, 2}
        assert [e["site"] for e in TM.entries()] == ["elastic"]
        assert TM.entries()[0]["owners"] == [list(d.id)]
        assert [e["tag"] for e in TT.events("hbm")
                if e["name"] == "sample"] == ["elastic.shrink"]
    finally:
        mgr.reset()
    d.close()


def test_import_leaves_jax_out():
    """The serving stack, the solve service and the ledger import no JAX."""
    code = ("import sys\n"
            "import distributedarrays_tpu_torch.serve\n"
            "import distributedarrays_tpu_torch.solvers.service\n"
            "import distributedarrays_tpu_torch.telemetry.memory\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "'jax.') or m == 'distributedarrays_tpu' or m.startswith("
            "'distributedarrays_tpu.')]\n"
            "print(bad)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    env.pop("PYTHONSTARTUP", None)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=root, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_concurrent_tracking_loses_no_update():
    """Threads creating, writing and closing DArrays at once (more threads
    than cores, a short switch interval): every byte the ledger counted is
    released, no entry is lost or left, the peak stays within what can be
    live at once."""
    import threading
    n_threads, rounds = 2 * (os.cpu_count() or 2) + 2, 25
    errors = []
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            try:
                for r in range(rounds):
                    d = tdat.dzeros((8, 8 + i % 3), procs=[i % 8])
                    d.fill_(float(r))
                    d[0, :] = 1.0
                    d.close()
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)
        ts = [threading.Thread(target=work, args=(i,))
              for i in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(120)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(prev)
    assert errors == []
    assert TM.live_bytes() == 0 and TM.tracked_count() == 0
    assert TM.live_bytes_by_rank() == {} and TM.live_bytes_by_device() == {}
    assert 0 < TM.peak_bytes() <= n_threads * 8 * 10 * 4
