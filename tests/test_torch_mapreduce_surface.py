"""The rest of the map/reduce layer (L4b) of the PyTorch port against the
JAX package: ``dall``/``dany``/``dcount``/``dextrema``, the scans,
``map_localparts``, ``samedist``, ``mapslices``, ``ppeval`` and ``djit``.
Seeded numpy inputs go through both packages; values and layouts are
compared, exactly for data movement, integers, bools and extrema, and to
``1e-5 * max|ref|`` for float32 sums and scans."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributedarrays_tpu as dat
import distributedarrays_tpu_torch as tdat

from _torch_port import (TYPED_DTYPES, assert_typed_equal, port_ranks,  # noqa: F401
                         same_layout, typed_inputs, typed_result)

N1 = 4096 * 2 + 37
LAYOUTS = [((16, 8), (8, 1), None), ((16, 8), (4, 2), None),
           ((16, 8), (2, 4), None), ((50, 8), (4, 2), None),
           ((37, 11), None, None), ((N1,), None, None),
           ((37, 11), None, [0, 1, 2]), ((50, 8), None, [1, 2, 3, 4, 5, 6, 7])]
LAYOUT_IDS = ["16x8_8x1", "16x8_4x2", "16x8_2x4", "50x8_4x2", "37x11",
              "1d_uneven", "37x11_p3", "50x8_p7"]
TOL_F32 = 1e-5


def pair(dims, dist=None, procs=None, seed=0, x=None):
    if x is None:
        x = np.random.default_rng(seed).standard_normal(dims).astype(
            np.float32)
    jd = dat.distribute(x, procs=procs, dist=dist)
    td = tdat.distribute(x, procs=procs, dist=dist)
    same_layout(jd, td)
    return x, jd, td


def assert_same(jd, td):
    same_layout(jd, td)
    np.testing.assert_array_equal(np.asarray(td), np.asarray(jd))


def assert_close(jd, td, tol=TOL_F32):
    """Same layout; values within ``tol * max|ref|``."""
    same_layout(jd, td)
    ref = np.asarray(jd).astype(np.float64)
    err = np.abs(np.asarray(td).astype(np.float64) - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1.0), err


# ---------------------------------------------------------------------------
# dall, dany, dcount, dextrema
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dims,dist,procs", LAYOUTS, ids=LAYOUT_IDS)
def test_all_any_count_extrema_like_jax(dims, dist, procs):
    x, jd, td = pair(dims, dist, procs, seed=1)
    xb = x > -1.5
    tb, jb = tdat.distribute(xb, procs=procs, dist=dist), dat.distribute(
        xb, procs=procs, dist=dist)
    for f in ("dall", "dany"):
        for d_t, d_j in ((td, jd), (tb, jb)):
            assert_typed_equal(getattr(tdat, f)(d_t), getattr(dat, f)(d_j))
            for ax in range(len(dims)):
                r_t, r_j = getattr(tdat, f)(d_t, dims=ax), getattr(dat, f)(
                    d_j, dims=ax)
                same_layout(r_j, r_t)
                assert_typed_equal(r_t, r_j)
    assert_typed_equal(tb.all(), jb.all())
    assert_typed_equal(tb.any(dims=0), jb.any(dims=0))
    for pred in (lambda a: a > 0.5, lambda a: a != a):
        assert_typed_equal(tdat.dcount(pred, td), dat.dcount(pred, jd))
        for ax in range(len(dims)):
            r_t, r_j = tdat.dcount(pred, td, dims=ax), dat.dcount(pred, jd,
                                                                  dims=ax)
            same_layout(r_j, r_t)
            assert_typed_equal(r_t, r_j)
    lo_t, hi_t = tdat.dextrema(td)
    lo_j, hi_j = dat.dextrema(jd)
    assert_typed_equal(lo_t, lo_j)
    assert_typed_equal(hi_t, hi_j)
    for ax in range(len(dims)):
        (lo_t, hi_t), (lo_j, hi_j) = tdat.dextrema(td, dims=ax), \
            dat.dextrema(jd, dims=ax)
        for a, b in ((lo_t, lo_j), (hi_t, hi_j)):
            same_layout(b, a)
            assert_typed_equal(a, b)


@pytest.mark.parametrize("dtype", TYPED_DTYPES + ["int32", "float32"])
def test_reductions_typed_like_jax(dtype):
    a, t = typed_inputs(dtype, (37, 11), seed=2)
    jd, td = dat.distribute(a), tdat.distribute(t)
    for f in ("dall", "dany"):
        assert_typed_equal(getattr(tdat, f)(td), getattr(dat, f)(jd))
        assert_typed_equal(getattr(tdat, f)(td, dims=1),
                           getattr(dat, f)(jd, dims=1))
    pred = (lambda v: v) if dtype == "bool" else (lambda v: v > 0)
    assert_typed_equal(tdat.dcount(pred, td), dat.dcount(pred, jd))
    assert_typed_equal(tdat.dcount(pred, td, dims=0),
                       dat.dcount(pred, jd, dims=0))
    for ax in (None, 0):
        for got, want in zip(tdat.dextrema(td, dims=ax),
                             dat.dextrema(jd, dims=ax)):
            assert_typed_equal(got, want)


# ---------------------------------------------------------------------------
# Scans
# ---------------------------------------------------------------------------

SCANS = ["dcumsum", "dcumprod", "dcummax", "dcummin"]


@pytest.mark.parametrize("dims,dist,procs", LAYOUTS, ids=LAYOUT_IDS)
@pytest.mark.parametrize("scan", SCANS)
def test_scans_float32_like_jax(scan, dims, dist, procs):
    rng = np.random.default_rng(3)
    if scan == "dcumprod":      # near 1, so products neither die nor blow up
        x = rng.uniform(0.9, 1.1, dims).astype(np.float32)
    else:
        x = rng.standard_normal(dims).astype(np.float32)
    _, jd, td = pair(dims, dist, procs, x=x)
    for ax in list(range(len(dims))) + [-1]:
        got, want = getattr(tdat, scan)(td, ax), getattr(dat, scan)(jd, ax)
        assert got.dtype == torch.float32
        if scan in ("dcummax", "dcummin"):
            assert_same(want, got)
        else:
            assert_close(want, got)


def _ulp(dtype: str, m: float) -> float:
    mant = {"float16": 10, "bfloat16": 7}[dtype]
    return 2.0 ** (np.floor(np.log2(m)) - mant) if m > 0 else 0.0


@pytest.mark.parametrize("dtype", TYPED_DTYPES + ["int32"])
@pytest.mark.parametrize("scan", SCANS)
def test_scans_typed_like_jax(scan, dtype):
    # torch widens integer and bool scans unless told: the port keeps
    # int8/uint8/int32 (wrapping), makes bool int32 for sum and product
    # and keeps bool for max and min, as ``jnp.cumsum`` and friends do.
    # The JAX package's own int8/uint8 sums and products come back
    # int32/uint32, partly unwrapped, when the scan dim is split over
    # ranks (ROADMAP queue C): the values are held against its scan on one
    # rank, the layout against its scan on the same layout
    want_dtype = {"bool": "int32" if scan in ("dcumsum", "dcumprod")
                  else "bool"}.get(dtype, dtype)
    lo, hi = (0.5, 1.5) if scan == "dcumprod" else (-100.0, 100.0)
    for shape, dist in (((37, 11), (4, 2)), ((13,), None), ((50, 8), None)):
        a, t = typed_inputs(dtype, shape, seed=4, lo=lo, hi=hi)
        jd = dat.distribute(a, dist=dist)
        j1 = dat.distribute(a, procs=[0], dist=[1] * len(shape))
        td = tdat.distribute(t, dist=dist)
        for ax in range(len(shape)):
            got = getattr(tdat, scan)(td, ax)
            same_layout(getattr(dat, scan)(jd, ax), got)
            want = getattr(dat, scan)(j1, ax)
            name, _ = typed_result(got)
            assert name == typed_result(want)[0] == want_dtype
            if dtype not in ("float16", "bfloat16") or scan in (
                    "dcummax", "dcummin"):
                assert_typed_equal(got, want)
                if dtype not in ("int8", "uint8"):
                    assert_typed_equal(got, getattr(dat, scan)(jd, ax))
                continue
            # torch accumulates half types in float32, JAX does not: both
            # against the float64 scan, the port no worse than JAX by more
            # than one ulp at the largest magnitude
            x64 = np.asarray(a).astype(np.float64)
            ref = (np.cumsum if scan == "dcumsum" else np.cumprod)(x64,
                                                                   axis=ax)
            err_p = np.abs(typed_result(got)[1] - ref).max()
            err_j = np.abs(typed_result(want)[1] - ref).max()
            assert err_p <= err_j + _ulp(dtype, np.abs(ref).max()), (
                err_p, err_j)


def test_scan_bad_arguments():
    td = tdat.distribute(np.ones((4, 3), np.float32))
    jd = dat.distribute(np.ones((4, 3), np.float32))
    for m, d in ((tdat, td), (dat, jd)):
        with pytest.raises(ValueError, match="out of range"):
            m.dcumsum(d, 2)
        with pytest.raises(TypeError, match="expected DArray"):
            m.dcumsum(np.ones(3), 0)


def test_scan_with_empty_chunks():
    # 3 rows over 8 ranks: five chunks are empty along the scan dim
    x = np.arange(3 * 4, dtype=np.int32).reshape(3, 4) - 5
    jd = dat.distribute(x, dist=(8, 1))
    td = tdat.distribute(x, dist=(8, 1))
    for scan in SCANS:
        assert_same(getattr(dat, scan)(jd, 0), getattr(tdat, scan)(td, 0))
        np.testing.assert_array_equal(
            np.asarray(getattr(tdat, scan)(td, 0)),
            {"dcumsum": np.cumsum, "dcumprod": np.cumprod,
             "dcummax": np.maximum.accumulate,
             "dcummin": np.minimum.accumulate}[scan](x, axis=0))


# ---------------------------------------------------------------------------
# map_localparts, samedist
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dims,dist,procs", LAYOUTS, ids=LAYOUT_IDS)
def test_map_localparts_like_jax(dims, dist, procs):
    x, jd, td = pair(dims, dist, procs, seed=5)
    y = np.random.default_rng(6).standard_normal(dims).astype(np.float32)
    # same-layout second argument, and one cut from another layout
    ty, jy = tdat.distribute(y, procs=procs, dist=dist), dat.distribute(
        y, procs=procs, dist=dist)
    assert_same(dat.map_localparts(lambda a, b: a * 2 + b, jd, jy),
                tdat.map_localparts(lambda a, b: a * 2 + b, td, ty))
    # (the JAX package raises "incompatible devices" for an argument on
    # another device set: its reference takes the same values on jd's)
    t2 = tdat.distribute(y, dist=[2] + [1] * (len(dims) - 1))
    assert_same(dat.map_localparts(lambda a, b: a - b, jd, jy),
                tdat.map_localparts(lambda a, b: a - b, td, t2))
    # a shape-changing f: the cuts follow the chunk sizes
    tm = tdat.map_localparts(lambda a: a[:1] + 1, td)
    jm = dat.map_localparts(lambda a: a[:1] + 1, jd)
    assert_same(jm, tm)
    # a non-DArray argument passes whole
    assert_same(dat.map_localparts(lambda a, s: a * s, jd, 3.0),
                tdat.map_localparts(lambda a, s: a * s, td, 3.0))
    # map_localparts_into writes dest in place
    dest_t = tdat.dzeros(dims, procs=procs, dist=dist)
    dest_j = dat.dzeros(dims, procs=procs, dist=dist)
    ptrs = [dest_t.part(ci).data_ptr() for ci in dest_t.cells()]
    assert tdat.map_localparts_into(torch.sin, dest_t, td) is dest_t
    dat.map_localparts_into(jnp.sin, dest_j, jd)
    assert [dest_t.part(ci).data_ptr() for ci in dest_t.cells()] == ptrs
    assert_close(dest_j, dest_t)
    with pytest.raises(ValueError, match="share global dims"):
        tdat.map_localparts(lambda a, b: a, td, tdat.dzeros((3,)))


def test_map_localparts_result_owns_its_tensors():
    x, _, td = pair((50, 8), (4, 2), seed=7)
    same = tdat.map_localparts(lambda a: a, td)
    view = tdat.map_localparts(lambda a: a[:, :], td)
    td.fill_(0.0)
    np.testing.assert_array_equal(np.asarray(same), x)
    np.testing.assert_array_equal(np.asarray(view), x)
    assert tdat.map_localparts(lambda a: a.double(), td).dtype == \
        torch.float32


LAYOUT_PAIRS = [((16, 8), (8, 1), (1, 8)), ((16, 8), (4, 2), (2, 4)),
                ((50, 8), (4, 2), (8, 1)), ((37, 11), (4, 2), (1, 8)),
                ((N1,), (8,), (3,)), ((16, 8), (4, 1), (4, 1))]


@pytest.mark.parametrize("dims,src,dst", LAYOUT_PAIRS)
def test_samedist_like_jax(dims, src, dst):
    x, jd, td = pair(dims, src, seed=8)
    like_t, like_j = tdat.dzeros(dims, dist=dst), dat.dzeros(dims, dist=dst)
    got, want = tdat.samedist(td, like_t), dat.samedist(jd, like_j)
    assert_same(want, got)
    np.testing.assert_array_equal(np.asarray(got), x)
    # a copy, also when the layouts agree: writes to td do not show
    td.fill_(5.0)
    np.testing.assert_array_equal(np.asarray(got), x)
    for m, a in ((tdat, td), (dat, jd)):
        b = m.dzeros((3,))
        with pytest.raises(ValueError, match="dims mismatch"):
            m.samedist(a, b)


def test_samedist_plans_the_all_to_all():
    # a one-axis repartition of equal width is the all-to-all plan (the
    # kernel K11 on the card; its plain version on the CPU)
    x = np.random.default_rng(9).standard_normal((16, 8)).astype(np.float32)
    td = tdat.distribute(x, procs=[0, 1, 2, 3], dist=(4, 1))
    like = tdat.dzeros((16, 8), procs=[0, 1, 2, 3], dist=(1, 4))
    assert tdat.reshard.plan_reshard(td, like.pids, like.cuts).strategy == \
        "all_to_all"
    tdat.kbuild.reset_launches()
    got = tdat.samedist(td, like)
    np.testing.assert_array_equal(np.asarray(got), x)
    assert tdat.kbuild.launch_counts()["all_to_all"] == 0   # CPU tensors


# ---------------------------------------------------------------------------
# mapslices, ppeval, djit
# ---------------------------------------------------------------------------


def _colnorm(c):
    # a population std by hand: torch's std and jnp's differ in ddof
    dev = c - c.mean()
    return dev / ((dev * dev).mean() ** 0.5 + 1.0)


@pytest.mark.parametrize("dims,dist,procs", LAYOUTS, ids=LAYOUT_IDS)
def test_mapslices_like_jax(dims, dist, procs):
    x, jd, td = pair(dims, dist, procs, seed=10)
    for sd in range(len(dims)):
        assert_close(dat.mapslices(_colnorm, jd, sd),
                     tdat.mapslices(_colnorm, td, sd))
    # f changes the slice extent: the first three entries of each slice
    for sd in range(len(dims)):
        assert_same(dat.mapslices(lambda c: c[:3] * 2, jd, sd),
                    tdat.mapslices(lambda c: c[:3] * 2, td, sd))
    if len(dims) == 2:
        assert_close(dat.mapslices(lambda s: s / (s.sum() + 50.0), jd,
                                   (0, 1)),
                     tdat.mapslices(lambda s: s / (s.sum() + 50.0), td,
                                    (0, 1)))
    for m, d in ((tdat, td), (dat, jd)):
        with pytest.raises(ValueError, match="f must keep the slice rank"):
            m.mapslices(lambda c: c.sum(), d, 0)


def test_mapslices_moves_the_slice_dim_whole():
    # (1,4) split along the slice dim: one all-to-all to (4,1), then f per
    # rank; the result takes the default layout over the same ranks
    x = np.random.default_rng(11).standard_normal((16, 8)).astype(np.float32)
    td = tdat.distribute(x, procs=[0, 1, 2, 3], dist=(1, 4))
    jd = dat.distribute(x, procs=[0, 1, 2, 3], dist=(1, 4))
    like = tdat.dzeros((16, 8), procs=[0, 1, 2, 3], dist=(4, 1))
    assert tdat.reshard.plan_reshard(td, like.pids, like.cuts).strategy == \
        "all_to_all"
    assert_close(dat.mapslices(_colnorm, jd, 1),
                 tdat.mapslices(_colnorm, td, 1))
    # an empty chunk along the batch dims still gets f's output extent
    x3 = np.random.default_rng(12).standard_normal((3, 8)).astype(np.float32)
    assert_close(dat.mapslices(lambda r: r[:5], dat.distribute(
        x3, dist=(1, 8)), 1), tdat.mapslices(lambda r: r[:5], tdat.distribute(
            x3, dist=(1, 8)), 1))


@pytest.mark.parametrize("dims,dist,procs", LAYOUTS[:5] + LAYOUTS[6:],
                         ids=LAYOUT_IDS[:5] + LAYOUT_IDS[6:])
def test_ppeval_like_jax(dims, dist, procs):
    x, jd, td = pair(dims, dist, procs, seed=13)
    y = np.random.default_rng(14).standard_normal(dims[:1]).astype(
        np.float32)
    assert_close(dat.ppeval(lambda s: s * 2 + 1, jd),
                 tdat.ppeval(lambda s: s * 2 + 1, td))
    assert_close(dat.ppeval(lambda s: s.sum(), jd, dim=0),
                 tdat.ppeval(lambda s: s.sum(), td, dim=0))
    # a DArray and a host vector sliced along dim 0 together
    assert_close(dat.ppeval(lambda s, v: s * v, jd, y, dim=0),
                 tdat.ppeval(lambda s, v: s * v, td, y, dim=0))
    for m, d in ((tdat, td), (dat, jd)):
        with pytest.raises(ValueError, match="slice-dim extents differ"):
            m.ppeval(lambda a, b: a, d, np.ones(dims[0] + 1, np.float32),
                     dim=0)


@pytest.mark.parametrize("dims,dist,procs", LAYOUTS, ids=LAYOUT_IDS)
def test_djit_like_jax(dims, dist, procs):
    x, jd, td = pair(dims, dist, procs, seed=15)
    rng = np.random.default_rng(16)
    y, z = (rng.standard_normal(dims).astype(np.float32) for _ in range(2))
    ty, jy = tdat.distribute(y, dist=[1] * (len(dims) - 1) + [2]), \
        dat.distribute(y, dist=[1] * (len(dims) - 1) + [2])
    t_fn = tdat.djit(lambda a, b, c: torch.sin(a) + b * c)
    j_fn = dat.djit(lambda a, b, c: jnp.sin(a) + b * c)
    got = t_fn(td, ty, z)
    assert_close(j_fn(jd, np.asarray(jy), z), got)
    # bit for bit against the owner-computes chain on the same layout
    ref = tdat.dmap(torch.sin, td) + ty * z
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    # several results: a reduction stays a tensor, a shape-changed array
    # takes the default layout, the first argument's shape its layout
    t_two = tdat.djit(lambda a: (a.sum(), a[:2] * 2, a * 3))(td)
    j_two = dat.djit(lambda a: (a.sum(), a[:2] * 2, a * 3))(jd)
    assert isinstance(t_two, tuple) and t_two[0].ndim == 0
    np.testing.assert_allclose(float(t_two[0]), float(j_two[0]), rtol=1e-5)
    assert_same(j_two[1], t_two[1])
    assert_same(j_two[2], t_two[2])
    # a SubDArray argument enters materialized
    assert_same(dat.djit(lambda a, b: a + b)(jd[1:3], 1.0),
                tdat.djit(lambda a, b: a + b)(td[1:3], 1.0))
