"""The port's multi-axis reshard against the JAX package's planner.

Planner functions: each copied function (``_digitize``, ``_schedule_chain``,
``_chain_steps``, ``_try_chain``, ``_try_pad_chain``, ``_try_gather_put``,
``_build_plan``) is given the same cut lists and owner dicts as its JAX
namesake and must return the same value (plans field by field).  Whole
plans: the port's ``plan_reshard`` of two DArray layouts against JAX's
shape-form ``plan_reshard`` of the same layouts as NamedShardings, and, for
the uneven pairs that JAX cannot place, against JAX's ``_build_plan`` on a
cut-list stand-in for a sharding (``_FakeSharding``, as in
``tests/test_reshard.py``).  Values: the port's ``reshard``/``relayout``
against the JAX package's ``reshard`` (the padded pairs against numpy),
bit for bit, also through the kernel path's copies run on the host.
"""

import ctypes
import itertools

import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import distributedarrays_tpu_torch as tdat
from distributedarrays_tpu import telemetry as JT
from distributedarrays_tpu import layout as JL
from distributedarrays_tpu.parallel import reshard as JR
from distributedarrays_tpu.resilience import domains as JD
from distributedarrays_tpu_torch.ops import cuda_collectives as C
from distributedarrays_tpu_torch.parallel import reshard as TR
from distributedarrays_tpu_torch.resilience import domains as TD

from _torch_port import port_ranks  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _quiet_jax_telemetry():
    # the JAX package's telemetry keeps one bounded event buffer (8192
    # events) per process, which its own tests read by offset; the calls
    # these parity tests make into the JAX package stay out of it
    was = JT.enabled()
    JT.disable()
    yield
    if was:
        JT.enable()
    # and no plan of these layouts stays in the JAX planner's cache, whose
    # key leaves out the domain topology (ROADMAP C6): a later test in
    # this process that plans one of them under a topology would read it
    JR._plan_cached.cache_clear()

FIELDS = ("strategy", "shape", "itemsize", "moved_bytes", "total_bytes",
          "src_dim", "dst_dim", "nparts", "ranks", "chunk_axis", "nchunks",
          "reason", "steps", "mesh_shape", "src_comp", "dst_comp",
          "pad_shape", "staging_bytes", "intra_bytes", "cross_bytes")


def same_plan(tp, jp):
    for f in FIELDS:
        a, b = getattr(tp, f), getattr(jp, f)
        if f in ("ranks", "shape", "mesh_shape", "pad_shape"):
            a, b = tuple(a), tuple(b)
        assert a == b, (f, a, b)


class _FakeDev:
    def __init__(self, i):
        self.id = i


class _FakeSharding:
    """A cut-list stand-in for a sharding (``tests/test_reshard.py``'s):
    one rank per block, blocks in row-major grid order; ``owners`` maps
    blocks to several ranks for a replicated layout."""

    def __init__(self, cuts_per_dim, ranks):
        self.cuts = cuts_per_dim
        self.ranks = ranks

    def devices_indices_map(self, shape):
        grids = [len(c) - 1 for c in self.cuts]
        out = {}
        for r, coord in zip(self.ranks,
                            itertools.product(*[range(g) for g in grids])):
            out[_FakeDev(r)] = tuple(
                slice(self.cuts[d][coord[d]], self.cuts[d][coord[d] + 1])
                for d in range(len(grids)))
        return out


def _ceil_cuts(n, g):
    c = -(-n // g)
    return [min(k * c, n) for k in range(g + 1)]


def _even_cuts(n, g):
    return [n // g * k for k in range(g + 1)]


def _default_cuts(n, g):
    return tdat.defaultdist_1d(n, g)


def _pids(grid, order):
    return np.asarray(order, dtype=np.int64).reshape(grid)


R8 = list(range(8))
T42 = [0, 2, 4, 6, 1, 3, 5, 7]      # the (4,2) mesh transposed: (2,4)

# (name, shape, src (cuts fn, grid, ranks), dst (cuts fn, grid, ranks))
PAIRS = [
    ("8x1-4x2", (48, 48), (_even_cuts, (8, 1), R8),
     (_even_cuts, (4, 2), R8)),
    ("4x2-2x4", (48, 48), (_even_cuts, (4, 2), R8),
     (_even_cuts, (2, 4), R8)),
    ("4x2-8x1", (48, 48), (_even_cuts, (4, 2), R8),
     (_even_cuts, (8, 1), R8)),
    ("1x8-4x2", (48, 48), (_even_cuts, (1, 8), R8),
     (_even_cuts, (4, 2), R8)),
    ("transpose-4x2", (48, 48), (_even_cuts, (4, 2), R8),
     (_even_cuts, (2, 4), T42)),
    ("transpose-2x2", (16, 24), (_even_cuts, (2, 2), [0, 1, 2, 3]),
     (_even_cuts, (2, 2), [0, 2, 1, 3])),
    ("3d-2x2x2-2x4x1", (8, 8, 8), (_even_cuts, (2, 2, 2), R8),
     (_even_cuts, (2, 4, 1), R8)),
    ("8x1-1x8-a2a", (48, 48), (_even_cuts, (8, 1), R8),
     (_even_cuts, (1, 8), R8)),
    ("4x1-2x2", (16, 16), (_even_cuts, (4, 1), [0, 1, 2, 3]),
     (_even_cuts, (2, 2), [0, 1, 2, 3])),
    ("reversed-order", (48, 48), (_even_cuts, (8, 1), R8[::-1]),
     (_even_cuts, (4, 2), R8)),
    ("ceil-14x8", (14, 8), (_ceil_cuts, (8, 1), R8),
     (_ceil_cuts, (4, 2), R8)),
    ("ceil-51x8", (51, 8), (_ceil_cuts, (4, 1), [0, 1, 2, 3]),
     (_ceil_cuts, (2, 2), [0, 1, 2, 3])),
    ("pads-disagree-50x2", (50, 2), (_ceil_cuts, (4, 1), [0, 1, 2, 3]),
     (_ceil_cuts, (2, 2), [0, 1, 2, 3])),
    ("default-uneven-50x8", (50, 8), (_default_cuts, (4, 2), R8),
     (_default_cuts, (8, 1), R8)),
    ("non-ceil-16", (16,), (lambda n, g: [0, 3, 16], (2,), [0, 1]),
     (lambda n, g: [0, 8, 16], (2,), [0, 1])),
]
UNEVEN = ["ceil-14x8", "ceil-51x8", "pads-disagree-50x2",
          "default-uneven-50x8", "non-ceil-16"]
EVEN = [p[0] for p in PAIRS if p[0] not in UNEVEN]
PAIR = {p[0]: p for p in PAIRS}


def _side(shape, spec):
    fn, grid, ranks = spec
    cuts = [fn(n, g) for n, g in zip(shape, grid)]
    return cuts, _pids(grid, ranks)


def _layouts(name):
    """Both sides' ``(cuts, owners)`` and ``(cuts, pids)``."""
    _, shape, s, d = PAIR[name]
    (sc, sp), (dc, dp) = _side(shape, s), _side(shape, d)
    return shape, TR.layout_of(sp, sc), TR.layout_of(dp, dc), (sc, sp), \
        (dc, dp)


def _fake(cuts, pids):
    return _FakeSharding(cuts, [int(x) for x in pids.flat])


def _replicated(shape, ranks):
    return ([[0, n] for n in shape],
            {tuple([0] * len(shape)): tuple(sorted(ranks))})


TARGETS = [64 << 20, 1024, 100]


# ---------------------------------------------------------------------------
# the planner functions, one by one
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", [p[0] for p in PAIRS])
def test_digitize_like_jax(name):
    shape, (sc, so), (dc, do), _, _ = _layouts(name)
    args = (len(shape), JR._grid_of(sc), so, JR._grid_of(dc), do)
    assert TR._digitize(*args) == JR._digitize(*args)


def _digits(name):
    shape, (sc, so), (dc, do), _, _ = _layouts(name)
    return shape, JR._digitize(len(shape), JR._grid_of(sc), so,
                               JR._grid_of(dc), do)


CHAINABLE = ["8x1-4x2", "4x2-2x4", "4x2-8x1", "1x8-4x2", "transpose-4x2",
             "transpose-2x2", "3d-2x2x2-2x4x1", "4x1-2x2"]


@pytest.mark.parametrize("cross_axis", [None, 0, 1])
@pytest.mark.parametrize("name", CHAINABLE)
def test_schedule_chain_like_jax(name, cross_axis):
    _, (canon, sizes, strides, sc, dc) = _digits(name)
    cross = {m: m == cross_axis for m in range(len(sizes))}
    assert TR._schedule_chain(sizes, sc, dc, cross) == \
        JR._schedule_chain(sizes, sc, dc, cross)


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("name", CHAINABLE)
def test_chain_steps_like_jax(name, target):
    shape, (canon, sizes, strides, sc, dc) = _digits(name)
    cross = {m: m == 0 for m in range(len(sizes))}
    ops = JR._schedule_chain(sizes, sc, dc, cross)
    args = (shape, 4, sizes, strides, sc, ops, canon, cross, target)
    assert TR._chain_steps(*args) == JR._chain_steps(*args)


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("name", [p[0] for p in PAIRS])
def test_try_chain_like_jax(name, target):
    shape, (sc, so), (dc, do), _, _ = _layouts(name)
    total = int(np.prod(shape)) * 4
    args = (shape, 4, JR._grid_of(sc), so, JR._grid_of(dc), do, total,
            target)
    tp, jp = TR._try_chain(*args), JR._try_chain(*args)
    assert (tp is None) == (jp is None)
    if jp is not None:
        same_plan(tp, jp)


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("name", [p[0] for p in PAIRS])
def test_try_pad_chain_like_jax(name, target):
    shape, (sc, so), (dc, do), _, _ = _layouts(name)
    total = int(np.prod(shape)) * 2
    args = (shape, 2, sc, so, dc, do, total, target)
    tp, jp = TR._try_pad_chain(*args), JR._try_pad_chain(*args)
    assert (tp is None) == (jp is None)
    if jp is not None:
        same_plan(tp, jp)


GATHER_PUTS = [("8x1-4x2", [0, 1, 2, 3, 4, 5]), ("4x2-8x1", [0, 1]),
               ("transpose-4x2", [3, 5, 6]), ("3d-2x2x2-2x4x1", [7]),
               ("4x1-2x2", [0, 1]), ("4x1-2x2", [0, 1, 2, 3])]


@pytest.mark.parametrize("target", TARGETS[:2])
@pytest.mark.parametrize("name,ranks", GATHER_PUTS)
def test_try_gather_put_like_jax(name, ranks, target):
    shape, (sc, so), _, _, _ = _layouts(name)
    _, d_own = _replicated(shape, ranks)
    total = int(np.prod(shape))
    args = (shape, 1, JR._grid_of(sc), so, d_own, total, target)
    tp, jp = TR._try_gather_put(*args), JR._try_gather_put(*args)
    assert (tp is None) == (jp is None)
    if jp is not None:
        same_plan(tp, jp)


@pytest.mark.parametrize("target", TARGETS[:2])
@pytest.mark.parametrize("name", [p[0] for p in PAIRS])
def test_build_plan_like_jax(name, target):
    shape, src, dst, (sc, sp), (dc, dp) = _layouts(name)
    tp = TR._build_plan(shape, 4, src, dst, target)
    jp = JR._build_plan(shape, 4, _fake(sc, sp), _fake(dc, dp), target)
    same_plan(tp, jp)


def test_build_plan_expected_strategies():
    tgt = JR._chunk_target_bytes()
    plans = {}
    for n in PAIR:
        shape, src, dst, _, _ = _layouts(n)
        plans[n] = TR._build_plan(shape, 4, src, dst, tgt)
    assert plans["ceil-14x8"].strategy == "chain"
    assert plans["ceil-14x8"].pad_shape == (16, 8)
    assert plans["ceil-51x8"].pad_shape == (52, 8)
    assert [s[0] for s in plans["ceil-51x8"].steps] == ["a2a"]
    for n in ("pads-disagree-50x2", "default-uneven-50x8", "non-ceil-16"):
        assert plans[n].strategy == "device_put"
        assert TR._fallback_reason(plans[n].reason) == "uneven"
    assert [s[0] for s in plans["transpose-4x2"].steps] == \
        ["gather", "a2a", "slice"]
    assert plans["8x1-1x8-a2a"].strategy == "all_to_all"


@pytest.mark.parametrize("reason", [
    "uneven source shards", "dst dim not divisible", "device sets differ",
    "source not replicated on dst devices", "extended dtype",
    "multi-dim chunk grid", "replicated blocks or rank order differs",
    "opaque layouts (ValueError)"])
def test_fallback_reason_like_jax(reason):
    assert TR._fallback_reason(reason) == JR._fallback_reason(reason)


# ---------------------------------------------------------------------------
# whole plans from DArrays
# ---------------------------------------------------------------------------


def _darray(x, name, side=0):
    shape, _, _, s, d = _layouts(name)
    cuts, pids = (s, d)[side]
    return tdat.darray_from_cuts(x, [int(p) for p in pids.flat], cuts)


def _named(name, side):
    """The NamedSharding of an even side: the identity rank order on its
    own grid, or the (4,2)/(2,2) mesh transposed."""
    _, shape, s, d = PAIR[name]
    fn, grid, ranks = (s, d)[side]
    if name.startswith("transpose") and side == 1:
        g = grid[::-1]
        mesh = JL.mesh_for(list(range(int(np.prod(g)))), g)
        return NamedSharding(mesh, P("d1", "d0"))
    return JL.sharding_for(list(ranks), grid, shape)


@pytest.mark.parametrize("chunk_mb", [None, "0.001"])
@pytest.mark.parametrize("name", [n for n in EVEN if n != "reversed-order"])
def test_plan_reshard_like_jax(name, chunk_mb, monkeypatch):
    if chunk_mb:
        monkeypatch.setenv("DA_TPU_RESHARD_CHUNK_MB", chunk_mb)
    shape, _, _, _, (dc, dp) = _layouts(name)
    x = np.zeros(shape, np.float32)
    d = _darray(x, name)
    jp = JR.plan_reshard(shape, _named(name, 1),
                         src_sharding=_named(name, 0), itemsize=4)
    tp = TR.plan_reshard(d, dp, dc)
    same_plan(tp, jp)
    if chunk_mb and shape == (48, 48) and tp.strategy == "chain":
        assert tp.nchunks > 1


@pytest.mark.parametrize("chunk_mb", [None, "0.001"])
@pytest.mark.parametrize("name", UNEVEN + ["reversed-order"])
def test_plan_reshard_uneven_like_jax(name, chunk_mb, monkeypatch):
    if chunk_mb:
        monkeypatch.setenv("DA_TPU_RESHARD_CHUNK_MB", chunk_mb)
    shape, _, _, (sc, sp), (dc, dp) = _layouts(name)
    d = _darray(np.zeros(shape, np.float32), name)
    tp = TR.plan_reshard(d, dp, dc)
    jp = JR._build_plan(shape, 4, _fake(sc, sp), _fake(dc, dp),
                        JR._chunk_target_bytes())
    same_plan(tp, jp)


def test_plan_cache_hits_and_chunk_target_read_per_call(monkeypatch):
    # a shape no other test plans, so the first plan is a miss
    shape = (64, 40)
    d = tdat.distribute(np.zeros(shape, np.float32), procs=R8, dist=(8, 1))
    dp, dc = _pids((4, 2), R8), [_even_cuts(64, 4), _even_cuts(40, 2)]
    s0 = TR.plan_stats()
    a = TR.plan_reshard(d, dp, dc)
    b = TR.plan_reshard(d, dp, dc)
    s1 = TR.plan_stats()
    assert a is b and s1["hits"] >= s0["hits"] + 1
    monkeypatch.setenv("DA_TPU_RESHARD_CHUNK_MB", "0.001")
    c = TR.plan_reshard(d, dp, dc)
    assert TR.plan_stats()["misses"] == s1["misses"] + 1
    assert a.nchunks == 1 and c.nchunks > 1


# ---------------------------------------------------------------------------
# values
# ---------------------------------------------------------------------------

DTYPES = ["float32", "bfloat16", "int8", "bool"]


def _values(shape, dtype, seed=7):
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        a = rng.integers(0, 2, shape).astype(bool)
        return a, torch.from_numpy(a)
    if dtype == "int8":
        a = rng.integers(-128, 128, shape).astype(np.int8)
        return a, torch.from_numpy(a)
    f = rng.standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        return f.astype(ml_dtypes.bfloat16), torch.from_numpy(f).bfloat16()
    return f, torch.from_numpy(f)


def _as_np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["8x1-4x2", "4x2-2x4", "4x2-8x1",
                                  "transpose-4x2", "3d-2x2x2-2x4x1",
                                  "1x8-4x2"])
def test_reshard_values_like_jax(name, dtype):
    import jax
    shape, _, _, _, (dc, dp) = _layouts(name)
    a, t = _values(shape, dtype)
    d = _darray(t, name)
    jy = JR.reshard(jax.device_put(a, _named(name, 0)), _named(name, 1))
    r = TR.reshard(d, dp, dc)
    assert r.dtype == t.dtype
    shards = {s.device.id: np.asarray(s.data) for s in jy.addressable_shards}
    for ci in np.ndindex(*dp.shape):
        want = shards[int(dp[ci])]
        if dtype == "bfloat16":
            want = want.astype(np.float32)
        np.testing.assert_array_equal(_as_np(r.part(ci)), want)
    np.testing.assert_array_equal(_as_np(TR.relayout(d, dp, dc).full()),
                                  _as_np(t))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("name", ["ceil-14x8", "ceil-51x8"])
def test_padded_chain_values_like_numpy(name, dtype):
    shape, _, _, _, (dc, dp) = _layouts(name)
    a, t = _values(shape, dtype)
    d = _darray(t, name)
    plan = TR.plan_reshard(d, dp, dc)
    assert plan.strategy == "chain" and plan.pad_shape
    r = TR.reshard(d, dp, dc)
    for ci in np.ndindex(*dp.shape):
        sl = tuple(slice(c[k], c[k + 1]) for c, k in zip(dc, ci))
        np.testing.assert_array_equal(r.part(ci).numpy(), a[sl])


def _emulated_copies(calls):
    """The copy kernel's semantics on host memory, for stubbed launches:
    each copy's boxes moved row by row with ``memmove``."""
    def run(copies, dev, kernel):
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


@pytest.mark.parametrize("name", ["8x1-4x2", "4x2-2x4", "transpose-4x2",
                                  "3d-2x2x2-2x4x1", "ceil-14x8",
                                  "ceil-51x8", "transpose-2x2"])
def test_kernel_path_copies_match_the_plain_chain(name, monkeypatch):
    # the CUDA path of chain_step on host tensors, its launches stubbed by
    # a host copy of the same boxes: one launch per step on the one
    # "card", values equal to the plain version's
    shape, _, _, _, (dc, dp) = _layouts(name)
    a, t = _values(shape, "float32", seed=3)
    d = _darray(t, name)
    plan = TR.plan_reshard(d, dp, dc)
    want = TR.relayout_plain(d, dp, dc)
    calls = []
    monkeypatch.setattr(C, "_on_cuda", lambda ts: True)
    monkeypatch.setattr(C, "_copy_on_card", _emulated_copies(calls))
    got = TR.relayout_parts(d, dp, dc)
    for ci in np.ndindex(*dp.shape):
        np.testing.assert_array_equal(got[ci].numpy(), want[ci].numpy())
    kinds = {"a2a": "all_to_all", "gather": "all_gather"}
    assert calls == [(kinds[s[0]], 1) for s in plan.steps
                     if s[0] != "slice"]


def test_chain_result_does_not_alias_the_source():
    shape, _, _, _, (dc, dp) = _layouts("transpose-4x2")
    a, t = _values(shape, "float32")
    d = _darray(t, "transpose-4x2")
    r = TR.relayout(d, dp, dc)
    for ci in np.ndindex(*dp.shape):
        r.part(ci).fill_(99.0)
    np.testing.assert_array_equal(d.full().numpy(), a)
    r2 = TR.reshard(d, dp, dc)
    assert all(r2.part(ci).untyped_storage().data_ptr() !=
               d.part(cj).untyped_storage().data_ptr()
               for ci in np.ndindex(*dp.shape) for cj in d.cells())


def test_reshard_noop_returns_the_darray():
    shape, _, _, (sc, sp), _ = _layouts("8x1-4x2")
    d = _darray(np.zeros(shape, np.float32), "8x1-4x2")
    assert TR.reshard(d, sp, sc) is d
    c = TR.relayout(d, sp, sc)
    assert c is not d and c.part((0, 0)).data_ptr() != d.part((0, 0)).data_ptr()


# ---------------------------------------------------------------------------
# allgather: the multi-axis chain and gather_put
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ranks", [None, [0, 1], [5, 2, 7], [3]])
@pytest.mark.parametrize("name", ["4x2-8x1", "3d-2x2x2-2x4x1", "ceil-14x8"])
def test_allgather_multi_axis_and_subsets(name, ranks, monkeypatch):
    shape, _, _, _, _ = _layouts(name)
    side = 1 if name == "ceil-14x8" else 0   # (4,2) ceil grid
    a, t = _values(shape, "float32")
    d = _darray(t, name, side)
    want = ranks if ranks is not None else [int(p) for p in d.pids.flat]
    plan = TR.plan_allgather(d, want)
    if ranks is not None and side == 0:
        # JAX's plan for the layout replicated on the subset
        # (None for one rank, which the port gathers all the same)
        _, own = TR.layout_of(d.pids, d.cuts)
        jp = JR._try_gather_put(
            shape, 4, JR._grid_of(d.cuts), own, _replicated(shape, want)[1],
            a.nbytes, JR._chunk_target_bytes())
        if len(want) > 1:
            same_plan(plan, jp)
    assert plan.strategy == ("chain" if ranks is None else "gather_put")
    assert all(s[0] == "gather" for s in plan.steps)
    monkeypatch.setattr(tdat.DArray, "full", lambda *a, **k: 1 / 0)
    outs = TR.allgather(d, ranks)
    assert len(outs) == len(want)
    for r, o in zip(want, outs):
        assert o.device == tdat.device_of(r)
        np.testing.assert_array_equal(o.numpy(), a)


def test_allgather_plan_of_a_4x2_grid_like_jax():
    shape = (48, 48)
    d = _darray(np.zeros(shape, np.float32), "4x2-8x1")
    mesh = JL.mesh_for(R8, (8,))
    jp = JR.plan_reshard(shape, NamedSharding(mesh, P()),
                         src_sharding=_named("4x2-8x1", 0), itemsize=4)
    same_plan(TR.plan_allgather(d, R8), jp)
    assert [s[0] for s in jp.steps] == ["gather", "gather"]


# ---------------------------------------------------------------------------
# C6: the plan cache keys on the domain topology
# ---------------------------------------------------------------------------


def test_plan_cache_keys_on_the_domain_topology(monkeypatch):
    monkeypatch.delenv("DA_TPU_DOMAINS", raising=False)
    TD.reset()
    shape, _, _, _, (dc, dp) = _layouts("transpose-4x2")
    d = _darray(np.zeros(shape, np.float32), "transpose-4x2")
    try:
        first = TR.plan_reshard(d, dp, dc)
        assert first.cross_bytes == 0
        misses = TR.plan_stats()["misses"]
        TD.configure("4,4")
        second = TR.plan_reshard(d, dp, dc)
        assert TR.plan_stats()["misses"] == misses + 1
        assert second.cross_bytes == 13824
        assert second.intra_bytes + second.cross_bytes == \
            second.moved_bytes
        # what JAX gives when it plans the pair fresh under the topology
        JD.configure("4,4")
        jp = JR._build_plan(shape, 4, _named("transpose-4x2", 0),
                            _named("transpose-4x2", 1),
                            JR._chunk_target_bytes())
        same_plan(second, jp)
        TD.reset()
        assert TR.plan_reshard(d, dp, dc) is first
    finally:
        TD.reset()
        JD.reset()
