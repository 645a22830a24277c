"""The collectives of the PyTorch port (the rank-list ``pshift``/``pgather``/
``pall_to_all``, the plain versions of the CUDA kernels K10 and K11) and the
relayout planner against the JAX package.

The JAX side runs its Pallas RDMA ring kernels in interpret mode, as
``tests/test_pallas_collectives.py`` does.  All-gather and all-to-all are
pure data movement, so the port must equal them exactly.  The reshard
strategy must equal the JAX planner's for the same pair of DArray layouts:
a single collective, a no-op, a multi-axis chain or a device_put
(``tests/test_torch_reshard_chain.py`` holds the chain's plans field by
field).
"""

import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

import distributedarrays_tpu as dat
import distributedarrays_tpu_torch as tdat
from distributedarrays_tpu import layout as JL
from distributedarrays_tpu.ops import pallas_collectives as PC
from distributedarrays_tpu.parallel import reshard as JR
from distributedarrays_tpu.parallel.collectives import run_spmd, spmd_mesh
from distributedarrays_tpu_torch.darray import resolve_layout
from distributedarrays_tpu_torch.ops import cuda_collectives as C
from distributedarrays_tpu_torch.parallel import reshard as TR

from _torch_port import port_ranks, same_layout, state_of  # noqa: F401


def _ints(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).integers(-8, 8, shape).astype(dtype)


def _split(x, p, dim=0):
    return [torch.from_numpy(np.ascontiguousarray(c))
            for c in np.split(x, p, axis=dim)]


@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("dim,dtype", [(0, np.float32), (1, np.float32),
                                       (0, np.int32)])
def test_all_gather_matches_pallas_ring(p, dim, dtype):
    x = _ints((p * 4, 2 * 128), p, dtype)
    jy = run_spmd(lambda a: PC.ring_all_gather(a, "p", dim=dim,
                                               interpret=True),
                  spmd_mesh(p), (P("p", None),), P(None, None))(x)
    outs = C.ring_all_gather(_split(x, p), dim)
    assert len(outs) == p
    for o in outs:
        np.testing.assert_array_equal(o.numpy(), np.asarray(jy))


@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("split_dim,concat_dim", [(1, 0), (0, 1)])
def test_all_to_all_matches_pallas_ring(p, split_dim, concat_dim):
    x = _ints((p * p, p * 12), 10 + p)
    jy = np.asarray(run_spmd(lambda a: PC.ring_all_to_all(
        a, "p", split_dim=split_dim, concat_dim=concat_dim, interpret=True),
        spmd_mesh(p), (P("p", None),), P("p", None))(x))
    outs = C.ring_all_to_all(_split(x, p), split_dim, concat_dim)
    rows = jy.shape[0] // p
    for q, o in enumerate(outs):
        np.testing.assert_array_equal(o.numpy(), jy[q * rows:(q + 1) * rows])


def test_all_to_all_3d_bf16_matches_lax():
    p = 4
    x = _ints((p * 2, 8, 3 * p), 20)
    jy = np.asarray(run_spmd(lambda a: lax.all_to_all(
        a, "p", split_axis=2, concat_axis=1, tiled=True),
        spmd_mesh(p), (P("p", None, None),), P("p", None, None))(x))
    outs = C.ring_all_to_all([b.bfloat16() for b in _split(x, p)], 2, 1)
    for q, o in enumerate(outs):
        assert o.dtype == torch.bfloat16
        np.testing.assert_array_equal(o.float().numpy(),
                                      jy[q * 2:(q + 1) * 2])


def test_pshift_matches_lax_ppermute():
    p = 8
    x = _ints((p * 3, 5), 21)
    from distributedarrays_tpu.parallel.collectives import pshift as jshift
    for shift, wrap in ((1, True), (-1, True), (2, False), (-3, False)):
        jy = np.asarray(run_spmd(lambda a: jshift(a, "p", shift, wrap),
                                 spmd_mesh(p), (P("p", None),),
                                 P("p", None))(x))
        outs = tdat.pshift(_split(x, p), shift, wrap)
        np.testing.assert_array_equal(torch.cat(outs).numpy(), jy)


def test_uneven_all_gather_and_errors():
    blocks = [torch.arange(n * 3, dtype=torch.float32).reshape(n, 3)
              for n in (2, 0, 5)]
    for o in C.ring_all_gather(blocks, 0):
        np.testing.assert_array_equal(o.numpy(), torch.cat(blocks).numpy())
    with pytest.raises(ValueError, match="divisible"):
        C.ring_all_to_all([torch.zeros(3, 4)] * 2, 0, 1)
    with pytest.raises(ValueError, match="CUDA devices or all on the CPU"):
        C.ring_all_gather([torch.zeros(2), torch.zeros(2, device="meta")])
    assert tdat.kbuild.launch_counts()["all_gather"] == 0


def test_copy_box_geometry():
    # the strided boxes the kernel takes: at most 3 outer dims + one run
    out = torch.empty(4, 6, 8)
    src = torch.empty(4, 3, 8)
    sizes, ss, ds, run = C._box(src, out.narrow(1, 3, 3))
    assert (sizes, run) == ([1, 1, 4], 3 * 8 * 4)
    assert ss[-1] == 3 * 8 * 4 and ds[-1] == 6 * 8 * 4
    x = torch.empty(8, 12)
    sizes, ss, ds, run = C._box(x.narrow(1, 3, 3), torch.empty(8, 3))
    assert (sizes, run) == ([1, 1, 8], 12) and (ss[-1], ds[-1]) == (48, 12)
    with pytest.raises(ValueError, match="cannot copy"):
        C._box(x.t(), torch.empty(12, 8))


@pytest.mark.parametrize("shape", [(19, 1), (5, 3, 1), (1, 1)])
def test_copy_box_one_wide_inner_dim(shape):
    # a box whose innermost dim is one element wide (a column of a chunk
    # copied into a column of another) is runs of one element, not an
    # error: the outer strides carry the rest
    src = torch.empty(shape[:-1] + (3,)).narrow(-1, 1, 1)
    dst = torch.empty(shape[:-1] + (7,)).narrow(-1, 4, 1)
    n = int(np.prod(shape))
    want = ([1, 1, 1], [0, 0, 0], [0, 0, 0]) if n == 1 else \
        ([1, 1, n], [0, 0, 12], [0, 0, 28])
    assert C._box(src, dst) == want + (4,)


def _gather_copies(p, rows=8, cols=16, dim=0, dtype=torch.float32):
    """The (dest, src, dst) copies the all-gather makes for p ranks."""
    blocks = [torch.empty(rows, cols, dtype=dtype) for _ in range(p)]
    e = blocks[0].shape[dim]
    shape = [rows, cols]
    shape[dim] *= p
    outs = [torch.empty(shape, dtype=dtype) for _ in range(p)]
    return [C.view_copy(q, b, out.narrow(dim, r * e, e))
            for q, out in enumerate(outs) for r, b in enumerate(blocks)]


@pytest.mark.parametrize("p", [1, 4, 8, 33])
def test_copy_launches_read_each_source_once_per_launch(p):
    copies = _gather_copies(p)
    launches = C.copy_launches(copies)
    flat = [(src, d) for launch in launches for src, _, part in launch
            for d, _ in part]
    # every copy once, at most MAXP copies and one group per source a launch
    assert sorted(flat) == sorted((s, d) for _, s, d, _ in copies)
    for launch in launches:
        assert sum(len(part) for _, _, part in launch) <= C.MAXP
        srcs = [src for src, _, _ in launch]
        assert len(srcs) == len(set(srcs)) <= C.MAXP
    # four ranks on one card: one launch, each source to all four
    if p == 4:
        assert len(launches) == 1
        assert [len(part) for _, _, part in launches[0]] == [4] * 4


@pytest.mark.parametrize("case", ["gather0", "gather1", "uneven",
                                  "a2a10", "a2a01"])
def test_kernel_copies_are_the_views_they_stand_for(monkeypatch, case):
    # the CUDA path's copies, made on CPU tensors with the launch stubbed:
    # addresses and boxes computed once per source or call must be those
    # of the narrowed views, for every destination
    got = []
    monkeypatch.setattr(C, "_on_cuda", lambda ts: True)
    monkeypatch.setattr(C, "_copy_on_card",
                        lambda copies, dev, kernel: got.extend(copies))
    if case.startswith("a2a"):
        sd, cd = int(case[3]), int(case[4])
        blocks = [torch.empty(8, 12, dtype=torch.bfloat16) for _ in range(4)]
        outs = C.ring_all_to_all(blocks, sd, cd)
        sb, ce = blocks[0].shape[sd] // 4, blocks[0].shape[cd]
        want = [C.view_copy(q, b.narrow(sd, q * sb, sb),
                            out.narrow(cd, r * ce, ce))
                for q, out in enumerate(outs) for r, b in enumerate(blocks)]
    else:
        dim = 1 if case == "gather1" else 0
        rows = (3, 0, 5, 2) if case == "uneven" else (4,) * 4
        blocks = [torch.empty((n, 6) if dim == 0 else (6, n))
                  for n in rows]
        outs = C.ring_all_gather(blocks, dim)
        offs = np.cumsum((0,) + rows)
        want = [C.view_copy(q, b, out.narrow(dim, int(o), n))
                for q, out in enumerate(outs)
                for b, o, n in zip(blocks, offs, rows) if n]
    assert got == want


def test_copy_launches_all_to_all_and_widths():
    blocks = [torch.empty(64, 100, dtype=torch.bfloat16) for _ in range(4)]
    outs = [torch.empty(256, 25, dtype=torch.bfloat16) for _ in range(4)]
    copies = [C.view_copy(q, b.narrow(1, q * 25, 25),
                          out.narrow(0, r * 64, 64))
              for q, out in enumerate(outs) for r, b in enumerate(blocks)]
    (launch,) = C.copy_launches(copies)
    assert [len(part) for _, _, part in launch] == [1] * 16
    # 50-byte runs: byte accesses; whole f32 blocks: 16 bytes; bf16 rows of
    # 6 elements at 12-byte offsets: 4 bytes
    assert {C.copy_width(*g) for g in launch} == {1}
    (launch,) = C.copy_launches(_gather_copies(4, 8, 16))
    assert {C.copy_width(*g) for g in launch} == {16}
    (launch,) = C.copy_launches(_gather_copies(4, 5, 6, 1, torch.bfloat16))
    assert {C.copy_width(*g) for g in launch} == {4}
    assert C.copy_launches([]) == []


# ---------------------------------------------------------------------------
# reshard planning and lowering
# ---------------------------------------------------------------------------

PAIRS = [
    ((16, 24), (4, 1), range(4), (1, 4), range(4)),     # all_to_all
    ((16, 24), (1, 4), range(4), (4, 1), range(4)),     # all_to_all
    ((16, 24), (8, 1), range(8), (1, 8), range(8)),     # all_to_all
    ((16, 24), (4, 1), range(4), (4, 1), range(4)),     # noop
    ((16, 24), (4, 1), range(4), (2, 2), range(4)),     # chain
    ((16, 24), (2, 2), range(4), (4, 1), range(4)),     # chain
    ((16, 24), (4, 1), range(4), (1, 4), [3, 2, 1, 0]),  # rank order
    ((16, 24), (1, 1), [0], (4, 1), range(4)),          # device sets
    ((8, 6, 4), (1, 2, 1), range(2), (2, 1, 1), range(2)),  # 3-D a2a
]


@pytest.mark.parametrize("dims,sd,sp,dd,dp", PAIRS)
def test_plan_strategy_matches_jax_planner(dims, sd, sp, dd, dp):
    x = _ints(dims, 30)
    js = dat.distribute(x, procs=list(sp), dist=sd)
    jd = dat.distribute(x, procs=list(dp), dist=dd)
    jplan = JR.plan_reshard(js.garray, jd.garray.sharding)
    ts = tdat.from_reference(state_of(js))
    td = tdat.from_reference(state_of(jd))
    tplan = TR.plan_reshard(ts, td.pids, td.cuts)
    want = jplan.strategy
    assert tplan.strategy == want, (jplan.strategy, jplan.reason)
    assert tplan.moved_bytes == jplan.moved_bytes
    assert tplan.total_bytes == jplan.total_bytes
    if want == "chain":
        assert tplan.steps == jplan.steps
        assert tplan.ranks == tuple(jplan.ranks)
    if want == "all_to_all":
        assert (tplan.src_dim, tplan.dst_dim, tplan.nparts) == \
            (jplan.src_dim, jplan.dst_dim, jplan.nparts)
        assert tplan.ranks == tuple(jplan.ranks)
    # the relayout itself: values and layout metadata
    r = TR.relayout(ts, td.pids, td.cuts)
    same_layout(jd, r)
    np.testing.assert_array_equal(np.asarray(r), x)
    dat.d_closeall()


def test_row_to_column_relayout_reports_all_to_all():
    x = np.arange(16 * 24, dtype=np.float32).reshape(16, 24)
    d = tdat.distribute(x, procs=range(4), dist=(4, 1))
    _, pids, cuts = resolve_layout((16, 24), range(4), (1, 4))
    plan = TR.plan_reshard(d, pids, cuts)
    assert plan.strategy == "all_to_all"
    # moved bytes as the region plan counts them: 3/4 of every column block
    moved = sum(int(np.prod([h - lo for lo, h in b])) * 4
                for s, t, b in plan.regions
                if int(d.pids[s]) != int(pids[t]))
    assert plan.moved_bytes == moved == 16 * 24 * 4 * 3 // 4
    parts = TR.relayout_parts(d, pids, cuts)
    for j in range(4):
        np.testing.assert_array_equal(parts[0, j].numpy(),
                                      x[:, 6 * j:6 * (j + 1)])


def test_broadcast_across_layouts_goes_through_all_to_all(monkeypatch):
    x = _ints((16, 24), 31)
    y = _ints((16, 24), 32)
    calls = []
    orig = TR.ring_all_to_all
    monkeypatch.setattr(TR, "ring_all_to_all",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    tx = tdat.distribute(x, procs=range(4), dist=(4, 1))
    ty = tdat.distribute(y, procs=range(4), dist=(1, 4))
    tr = tx + ty
    assert calls
    jr = dat.distribute(x, procs=range(4), dist=(4, 1)) + \
        dat.distribute(y, procs=range(4), dist=(1, 4))
    same_layout(jr, tr)
    np.testing.assert_array_equal(np.asarray(tr), np.asarray(jr))
    dat.d_closeall()


@pytest.mark.parametrize("dims,dist,procs", [
    ((16, 24), (4, 1), range(4)), ((16, 24), (1, 8), range(8)),
    ((16, 24), (2, 2), range(4)), ((18, 5), (4, 1), range(4))])
def test_allgather_plan_matches_jax_and_values(dims, dist, procs):
    x = _ints(dims, 33)
    jd = dat.distribute(x, procs=list(procs), dist=dist)
    td = tdat.from_reference(state_of(jd))
    ranks = [int(q) for q in jd.pids.flat]
    plan = TR.plan_allgather(td, ranks)
    mesh = JL.mesh_for(ranks, (len(ranks),))
    jplan = JR.plan_reshard(jd.garray, NamedSharding(mesh, P()))
    even = all(dd % g == 0 for dd, g in zip(dims, dist))
    if even:
        assert plan.strategy == jplan.strategy, (jplan.strategy,
                                                 jplan.reason)
        assert plan.moved_bytes == jplan.moved_bytes
        assert plan.steps == jplan.steps
    else:
        # uneven chunks: the kernel gathers them as torch.cat does
        assert plan.strategy == "all_gather"
    outs = TR.allgather(td, ranks[::-1])
    assert len(outs) == len(ranks)
    for o in outs:
        np.testing.assert_array_equal(o.numpy(), x)
    dat.d_closeall()
