"""The rest of the reference's DArray surface in the PyTorch port against
the JAX package: whole-array ``==``, ``bool``/``float``/``iter``, region
writes and in-place mutation, copies and views, constructors, ``DData``,
``dcat`` and the ``core`` helpers.  Seeded numpy inputs go through both
packages; values and layouts are compared exactly."""

import copy
import sys

import numpy as np
import pytest
import torch

import distributedarrays_tpu as dat
import distributedarrays_tpu_torch as tdat

from _torch_port import port_ranks, same_layout  # noqa: F401

jdarray = sys.modules["distributedarrays_tpu.darray"]

N1 = 4096 * 2 + 37
# (dims, dist, procs): even (8,1), (4,2), (2,4); uneven (50, 8) on (4,2),
# (37, 11), a 1-D 4096*2 + 37 over 8 ranks; procs lists of 3 and 7 ranks
LAYOUTS = [((16, 8), (8, 1), None), ((16, 8), (4, 2), None),
           ((16, 8), (2, 4), None), ((50, 8), (4, 2), None),
           ((37, 11), None, None), ((N1,), None, None),
           ((37, 11), None, [0, 1, 2]), ((50, 8), None, [1, 2, 3, 4, 5, 6, 7])]
LAYOUT_IDS = ["16x8_8x1", "16x8_4x2", "16x8_2x4", "50x8_4x2", "37x11",
              "1d_uneven", "37x11_p3", "50x8_p7"]


def pair(dims, dist=None, procs=None, seed=0, x=None):
    if x is None:
        x = np.random.default_rng(seed).standard_normal(dims).astype(
            np.float32)
    jd = dat.distribute(x, procs=procs, dist=dist)
    td = tdat.distribute(x, procs=procs, dist=dist)
    same_layout(jd, td)
    return x, jd, td


def assert_same(jd, td):
    """Same layout and bit-identical values."""
    same_layout(jd, td)
    np.testing.assert_array_equal(np.asarray(td), np.asarray(jd))


# ---------------------------------------------------------------------------
# C9-C12: ==, bool, float, iter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dims,dist,procs", LAYOUTS, ids=LAYOUT_IDS)
def test_eq_whole_array_like_jax(dims, dist, procs):
    # C9: the port compared identities, so every one of these was False
    x = np.arange(int(np.prod(dims)), dtype=np.float32).reshape(dims)
    _, jd, td = pair(dims, dist, procs, x=x)
    cases = [(lambda d, m: d == d.copy()),
             (lambda d, m: d == np.asarray(d)),
             (lambda d, m: d[2:4] == d[2:4]),
             (lambda d, m: d != d.copy()),
             (lambda d, m: d == m.distribute(x, dist=None)),
             (lambda d, m: d[1:3] == np.asarray(d)[1:3])]
    for case in cases:
        got, want = case(td, tdat), case(jd, dat)
        assert type(got) is bool and got is want
    assert [c(td, tdat) for c in cases] == [True, True, True, False, True,
                                            True]


def test_eq_c9_table_case():
    x = np.arange(400, dtype=np.float32).reshape(50, 8)
    _, jd, td = pair((50, 8), (4, 2), x=x)
    assert (td == td.copy(), td == np.asarray(td), td[2:4] == td[2:4]) == \
        (jd == jd.copy(), jd == np.asarray(jd), jd[2:4] == jd[2:4]) == \
        (True, True, True)
    assert (td != td.copy()) is False


def test_eq_false_cases_like_jax():
    x = np.arange(400, dtype=np.float32).reshape(50, 8)
    _, jd, td = pair((50, 8), (4, 2), x=x)
    y = x.copy()
    y[37, 5] = -1
    for other in (y, x[:49], x.astype(np.int32), x.reshape(8, 50)):
        assert (td == other) is (jd == other)
        assert (td != other) is (jd != other)
    # a non-array operand: NotImplemented, so Python gives False
    assert (td == 3) is (jd == 3) is False
    assert (td != 3) is (jd != 3) is True
    assert (td == "a") is False and (td == None) is False  # noqa: E711
    # another layout: compared on the device, piece by piece
    t24 = tdat.distribute(y, dist=(2, 4))
    j24 = dat.distribute(y, dist=(2, 4))
    assert (td == t24) is (jd == j24) is False
    assert (td[37:38] == t24[37:38]) is (jd[37:38] == j24[37:38]) is False
    assert (t24[37:38] == td[37:38]) is False
    assert (td[2:3] == t24[2:3]) is (jd[2:3] == j24[2:3]) is True


def test_eq_promotes_and_nan():
    # JAX's array_equal of int32 and float32 arange is True
    xi = np.arange(24, dtype=np.int32).reshape(6, 4)
    ti, ji = tdat.distribute(xi), dat.distribute(xi)
    tf, jf = tdat.distribute(xi.astype(np.float32)), dat.distribute(
        xi.astype(np.float32))
    assert (ti == tf) is (ji == jf) is True
    assert (ti == xi.astype(np.float32)) is (ji == xi.astype(np.float32))
    assert (ti == torch.arange(24).reshape(6, 4)) is True
    # NaN is unequal to NaN
    xn = np.array([1.0, np.nan, 3.0], np.float32)
    tn, jn = tdat.distribute(xn), dat.distribute(xn)
    assert (tn == tn.copy()) is (jn == jn.copy()) is False
    xb = np.array([True, False, True])
    tb, jb = tdat.distribute(xb), dat.distribute(xb)
    assert (tb == xb.astype(np.int32)) is (jb == xb.astype(np.int32)) is True


def test_hash_by_id_and_dict_key():
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    a, b = tdat.distribute(x), tdat.distribute(x)
    assert a == b and hash(a) != hash(b) and hash(a) == hash(a.id)
    table = {a: "a", b: "b"}
    assert table[a] == "a" and table[b] == "b" and len(table) == 2
    s = a[1:3]
    assert hash(s) == id(s) and {s: 1}[s] == 1


def test_bool_like_jax():
    # C10: any DArray whose first dim was nonzero was truthy
    x = np.arange(400, dtype=np.float32).reshape(50, 8)
    _, jd, td = pair((50, 8), (4, 2), x=x)
    for d in (td, jd):
        with pytest.raises(ValueError, match="truth value of a multi-element"
                           " DArray is ambiguous; use dall"):
            bool(d)
    assert bool(tdat.dzeros((1,))) is bool(dat.dzeros((1,))) is False
    assert bool(tdat.dones((1, 1))) is bool(dat.dones((1, 1))) is True
    assert bool(tdat.distribute(np.array([0], np.int8))) is False


def test_float_like_jax():
    # C11: float() of a size-1 DArray raised TypeError
    one_t, one_j = tdat.distribute([2.5]), dat.distribute([2.5])
    assert float(one_t) == float(one_j) == 2.5
    assert float(tdat.distribute(np.array([[7]], np.int32))) == 7.0
    x = np.arange(400, dtype=np.float32).reshape(50, 8)
    _, jd, td = pair((50, 8), (4, 2), x=x)
    for d in (td, jd):
        with pytest.raises(TypeError, match="only size-1 DArray converts "
                           "to float"):
            float(d)


def test_iter_guarded_like_jax():
    # C12: list(a) returned the rows with no guard
    x = np.arange(400, dtype=np.float32).reshape(50, 8)
    _, jd, td = pair((50, 8), (4, 2), x=x)
    for d in (td, jd):
        with pytest.raises(RuntimeError, match="scalar indexing"):
            list(d)
    with tdat.allowscalar(True), dat.allowscalar(True):
        rows_t, rows_j = list(td), list(jd)
    assert len(rows_t) == len(rows_j) == 50
    for rt, rj in zip(rows_t, rows_j):
        np.testing.assert_array_equal(rt, np.asarray(rj))


# ---------------------------------------------------------------------------
# Region writes
# ---------------------------------------------------------------------------

SET_KEYS = [(slice(2, 9), slice(None)), (slice(1, 30, 3), slice(0, 8, 2)),
            (slice(None), slice(1, 3)), (slice(5, 6),)]


@pytest.mark.parametrize("dims,dist,procs", LAYOUTS, ids=LAYOUT_IDS)
def test_setitem_values_like_jax(dims, dist, procs):
    x, jd, td = pair(dims, dist, procs, seed=1)
    rng = np.random.default_rng(2)
    keys = SET_KEYS if len(dims) == 2 else [
        (slice(N1 // 8, N1 // 8 + 4096),), (slice(3, N1, 7),)]
    for key in keys:
        shape = x[key].shape
        host = rng.standard_normal(shape).astype(np.float32)
        for value in (2.5, host, torch.from_numpy(host),
                      host[-1:] if len(shape) == 2 else host[:1]):
            td[key] = value
            jd[key] = value if not isinstance(value, torch.Tensor) \
                else value.numpy()
            assert_same(jd, td)
        # a DArray value on another layout, and a SubDArray value
        src = rng.standard_normal(x.shape).astype(np.float32)
        tsrc = tdat.distribute(src[key], dist=[1] * (len(shape) - 1) + [
            min(4, shape[-1])])
        jsrc = dat.distribute(src[key], dist=[1] * (len(shape) - 1) + [
            min(4, shape[-1])])
        # the JAX package raises "incompatible devices" for a DArray value
        # on another device set than the target (ROADMAP queue C): it
        # takes the value's host copy, the port the DArray
        td[key] = tsrc
        jd[key] = np.asarray(jsrc)
        assert_same(jd, td)
        tfull, jfull = tdat.distribute(src), dat.distribute(src)
        td[key] = tfull[key]
        jd[key] = np.asarray(jfull[key])
        assert_same(jd, td)


def test_setitem_int_keys_cast_and_guard():
    x, jd, td = pair((50, 8), (4, 2), seed=3)
    for d in (td, jd):
        with pytest.raises(RuntimeError, match="scalar indexing"):
            d[1, 2] = 5.0
    with tdat.allowscalar(True), dat.allowscalar(True):
        td[13, -1] = 5.0
        jd[13, -1] = 5.0
    td[7, 2:6] = [1, 2, 3, 4]
    jd[7, 2:6] = [1, 2, 3, 4]
    assert_same(jd, td)
    # an int key after a slice with a scalar value raises in the JAX
    # package on an uneven layout (expand_dims of a 0-d value, ROADMAP
    # queue C): numpy is the reference
    x = np.asarray(td).copy()
    td[20:40, 3] = 9
    x[20:40, 3] = 9
    np.testing.assert_array_equal(np.asarray(td), x)
    with pytest.raises(ValueError, match="out of bounds"):
        jd[20:40, 3] = 9
    # cast to the DArray's dtype as .at[].set casts
    xi = np.arange(40, dtype=np.int32).reshape(8, 5)
    ti, ji = tdat.distribute(xi), dat.distribute(xi)
    ti[2:5, 1:4] = 2.75
    ji[2:5, 1:4] = 2.75
    ti[0] = np.full(5, -3.5, np.float32)
    ji[0] = np.full(5, -3.5, np.float32)
    assert ti.dtype == torch.int32
    assert_same(ji, ti)
    with pytest.raises(RuntimeError):
        ti[0:2] = np.ones((3, 5), np.int32)


def test_setitem_descending_slices_follow_numpy():
    # the JAX package drops a descending run to the front (ROADMAP
    # "Matched on this tree"): numpy is the reference here, and JAX where
    # its slice does not run to the front
    x, jd, td = pair((50, 8), (4, 2), seed=4)
    v = np.arange(7 * 8, dtype=np.float32).reshape(7, 8)
    key = (slice(45, 5, -6), slice(None, None, -1))
    td[key] = v
    x[key] = v
    np.testing.assert_array_equal(np.asarray(td), x)
    key = (slice(40, 2, -3), slice(6, 1, -2))
    w = np.arange(13 * 3, dtype=np.float32).reshape(13, 3)
    td[key] = w
    jd[:] = x
    jd[key] = w
    x[key] = w
    np.testing.assert_array_equal(np.asarray(td), x)
    np.testing.assert_array_equal(np.asarray(jd), x)
    tv = tdat.distribute(w, dist=(4, 1))
    td[key] = tv * 2
    x[key] = w * 2
    np.testing.assert_array_equal(np.asarray(td), x)
    # a scalar into a descending run, and a row broadcast into one
    td[::-3, 1::-1] = 1.5
    x[::-3, 1::-1] = 1.5
    td[30:3:-9, ::-2] = np.arange(4, dtype=np.float32)
    x[30:3:-9, ::-2] = np.arange(4)
    np.testing.assert_array_equal(np.asarray(td), x)


def test_setitem_touches_only_owner_ranks():
    # bench.py's reshard_mutate shape, cut: an uneven 1-D layout over 8
    # ranks and a window inside two chunks
    x = np.zeros(N1, np.float32)
    td = tdat.distribute(x)
    lo = N1 // 8 - 100
    owners = {int(p) for p in td.pids.flat
              if td.localindices(int(p))[0].start < lo + 300
              and td.localindices(int(p))[0].stop > lo}
    assert len(owners) == 2
    before = {r: (td.localpart(r).data_ptr(), td.localpart(r).clone())
              for r in range(8)}
    td[lo:lo + 300] = np.full(300, 5.0, np.float32)
    x[lo:lo + 300] = 5.0
    for r in range(8):
        ptr, val = before[r]
        assert td.localpart(r).data_ptr() == ptr          # in place
        if r not in owners:
            assert torch.equal(td.localpart(r), val)
        else:
            assert not torch.equal(td.localpart(r), val)
    np.testing.assert_array_equal(np.asarray(td), x)
    # a DArray value of another layout reaches the owners alone too
    v = tdat.distribute(np.arange(300, dtype=np.float32), dist=(3,))
    td[lo:lo + 300] = v
    for r in range(8):
        assert td.localpart(r).data_ptr() == before[r][0]
        if r not in owners:
            assert torch.equal(td.localpart(r), before[r][1])
    x[lo:lo + 300] = np.arange(300)
    np.testing.assert_array_equal(np.asarray(td), x)


# ---------------------------------------------------------------------------
# In-place mutation: localparts, fill_, rand_, copyto_
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dims,dist,procs", LAYOUTS[3:5] + LAYOUTS[6:7],
                         ids=["50x8_4x2", "37x11", "37x11_p3"])
def test_set_localpart_lp_chunk_procs(dims, dist, procs):
    x, jd, td = pair(dims, dist, procs, seed=5)
    for pid in {int(p) for p in td.pids.flat}:
        shape = tuple(len(r) for r in td.localindices(pid))
        v = np.full(shape, float(pid) + 0.5, np.float32)
        td.set_localpart(v, pid)
        jd.set_localpart(v, pid)
        np.testing.assert_array_equal(td.chunk(pid).numpy(),
                                      np.asarray(jd.chunk(pid)))
    assert_same(jd, td)
    shape0 = tuple(len(r) for r in td.localindices(0))
    td.lp = np.ones(shape0, np.float32) * 3
    jd.lp = np.ones(shape0, np.float32) * 3
    np.testing.assert_array_equal(td.lp.numpy(), np.asarray(jd.lp))
    assert_same(jd, td)
    # localpart is the rank's own tensor: a write shows through
    td.localpart(0).fill_(-1.0)
    assert float(np.asarray(td)[0, 0]) == -1.0
    for d, m in ((td, tdat), (jd, dat)):
        with pytest.raises(ValueError, match="localpart shape"):
            d.set_localpart(np.ones((1, 1), np.float32), 0)
    if procs is not None:
        with pytest.raises(ValueError, match="holds no chunk"):
            td.set_localpart(np.ones(shape0, np.float32), 7)
        with pytest.raises(ValueError, match="holds no chunk"):
            jd.set_localpart(np.ones(shape0, np.float32), 7)
    np.testing.assert_array_equal(td.procs(), jd.procs())
    np.testing.assert_array_equal(tdat.procs(td), dat.procs(jd))


@pytest.mark.parametrize("dims,dist,procs", LAYOUTS, ids=LAYOUT_IDS)
def test_fill_rand_like_jax(dims, dist, procs):
    x, jd, td = pair(dims, dist, procs, seed=6)
    assert td.fill_(3.0) is td
    jd.fill_(3.0)
    assert_same(jd, td)
    ptrs = [td.part(ci).data_ptr() for ci in td.cells()]
    assert td.rand_() is td
    jd.rand_()
    same_layout(jd, td)
    v = np.asarray(td)
    assert ((v >= 0) & (v < 1)).all() and len(np.unique(v)) > v.size // 2
    assert [td.part(ci).data_ptr() for ci in td.cells()] == ptrs
    tdat.seed(9)
    a = np.asarray(td.rand_())
    tdat.seed(9)
    np.testing.assert_array_equal(np.asarray(td.rand_()), a)


def test_fill_casts_like_jax():
    xi = np.arange(12, dtype=np.int32).reshape(4, 3)
    for v in (2.75, -1.5, True, np.float32(4.5)):
        ti, ji = tdat.distribute(xi), dat.distribute(xi)
        ti.fill_(v)
        ji.fill_(v)
        assert_same(ji, ti)
    tb, jb = tdat.distribute(xi > 3), dat.distribute(xi > 3)
    tb.fill_(2)
    jb.fill_(2)
    assert_same(jb, tb)


@pytest.mark.parametrize("dims,dist,procs", LAYOUTS, ids=LAYOUT_IDS)
def test_copyto_like_jax(dims, dist, procs):
    x, jd, td = pair(dims, dist, procs, seed=7)
    rng = np.random.default_rng(8)
    host = rng.standard_normal(dims).astype(np.float32)
    assert tdat.copyto_(td, host) is td
    dat.copyto_(jd, host)
    assert_same(jd, td)
    # from a DArray of another layout (bench.py's reshard_uneven repad)
    other = rng.standard_normal(dims).astype(np.float32)
    t2 = tdat.distribute(other, dist=[1] * (len(dims) - 1) + [2])
    j2 = dat.distribute(other, dist=[1] * (len(dims) - 1) + [2])
    tdat.copyto_(td, t2)
    dat.copyto_(jd, np.asarray(j2))     # JAX: another device set raises
    assert_same(jd, td)
    # into a view
    key = (slice(1, 5),) + (slice(None),) * (len(dims) - 1)
    v = np.full(x[key].shape, 7.0, np.float32)
    sv = td[key]
    assert tdat.copyto_(sv, v) is sv
    dat.copyto_(jd[key], v)
    assert_same(jd, td)
    tdat.copyto_(td[key], t2[key])
    dat.copyto_(jd[key], np.asarray(j2[key]))
    assert_same(jd, td)
    for d, m in ((td, tdat), (jd, dat)):
        with pytest.raises(ValueError, match="copyto_: src shape"):
            m.copyto_(d, host[:1])
        with pytest.raises(ValueError, match="copyto_: src shape"):
            m.copyto_(d[key], host)
        with pytest.raises(TypeError, match="expects a DArray or SubDArray"):
            m.copyto_(host, d)


# ---------------------------------------------------------------------------
# Copies and views
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dims,dist,procs", LAYOUTS, ids=LAYOUT_IDS)
def test_similar_reshape_astype_deepcopy(dims, dist, procs):
    x, jd, td = pair(dims, dist, procs, seed=10)
    assert_same(jd.similar(), td.similar())
    for dt, tdt in ((np.int32, torch.int32), (np.float16, torch.float16)):
        ts, js = td.similar(dtype=dt), jd.similar(dtype=dt)
        assert ts.dtype == tdt
        assert_same(js, ts)
        assert_same(jd.astype(dt), td.astype(dt))
    assert_same(jd.astype(np.float64), td.astype(np.float64))
    assert td.astype(np.float64).dtype == torch.float32
    n = int(np.prod(dims))
    new = (n,) if len(dims) > 1 else (3, n // 3)
    assert_same(jd.similar(dims=new), td.similar(dims=new))
    assert_same(jd.reshape(new), td.reshape(new))
    assert_same(jd.reshape(*new), td.reshape(*new))
    for d in (td, jd):
        with pytest.raises(ValueError, match="cannot reshape"):
            d.reshape(n + 1)
    tc, jc = copy.deepcopy(td), copy.deepcopy(jd)
    assert_same(jc, tc)
    assert tc is not td and tc.id != td.id
    memo = {}
    assert copy.deepcopy([td, td], memo)[1] is memo[id(td)]


def test_astype_float_to_int_and_bool_like_jax():
    x = np.array([[-2.7, -0.5, 0.0], [0.5, 1.5, 3.9]], np.float32)
    td, jd = tdat.distribute(x), dat.distribute(x)
    for dt in (np.int32, np.int8, np.bool_, np.uint8):
        if dt is np.uint8:
            xp = np.abs(x)
            assert_same(dat.distribute(xp).astype(dt),
                        tdat.distribute(xp).astype(dt))
            continue
        assert_same(jd.astype(dt), td.astype(dt))


def test_no_write_shows_through_another_darray():
    x = np.arange(50 * 8, dtype=np.float32).reshape(50, 8)
    a = tdat.distribute(x, dist=(4, 2))
    others = {
        "copy": a.copy(), "astype": a.astype(a.dtype),
        "reshape": a.reshape(8, 50), "samedist": tdat.samedist(a, a),
        "darray_like": tdat.darray_like(lambda idx: a.makelocal(*[
            slice(r.start, r.stop) for r in idx]), a),
        "subdarray": a[3:40].copy(), "deepcopy": copy.deepcopy(a),
        "materialized": a[3:40].materialize(), "region": a.full(),
        "map_localparts": tdat.map_localparts(lambda t: t, a),
        "mapslices": tdat.mapslices(lambda c: c, a, 0),
        "djit": tdat.djit(lambda t: t)(a),
        "distribute": tdat.distribute(a),
    }
    snap = {k: (np.asarray(v) if isinstance(v, tdat.DArray)
                else v.clone().numpy()) for k, v in others.items()}
    a.fill_(-1.0)
    a[0:10] = 7.0
    tdat.copyto_(a, np.zeros((50, 8), np.float32))
    a.set_localpart(np.ones((13, 4), np.float32), 0)
    for k, v in others.items():
        now = np.asarray(v) if isinstance(v, tdat.DArray) else v.numpy()
        np.testing.assert_array_equal(now, snap[k], err_msg=k)


# ---------------------------------------------------------------------------
# Constructors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dims,dist,procs", LAYOUTS, ids=LAYOUT_IDS)
def test_darray_like_and_dfromfunction(dims, dist, procs):
    _, jd, td = pair(dims, dist, procs, seed=11)

    def init(idx):
        return np.add.outer(np.arange(idx[0].start, idx[0].stop) * 100.0,
                            np.arange(idx[-1].start, idx[-1].stop)).astype(
            np.float32) if len(idx) == 2 else np.arange(
                idx[0].start, idx[0].stop, dtype=np.float32)
    assert_same(dat.darray_like(init, jd), tdat.darray_like(init, td))
    if len(dims) == 2:
        def f(i, j):
            return 10 * i + j
    else:
        def f(i):
            return 3 * i - 7
    tf = tdat.dfromfunction(f, dims, procs=procs, dist=dist)
    jf = dat.dfromfunction(f, dims, procs=procs, dist=dist)
    assert tf.dtype == torch.int32
    assert_same(jf, tf)
    tn = tdat.dfromfunction(f, dims, procs=procs, dist=dist, compiled=False)
    jn = dat.dfromfunction(f, dims, procs=procs, dist=dist, compiled=False)
    assert tn.dtype == torch.int32
    assert_same(jn, tn)


def test_dfromfunction_float_and_shape_check():
    def f(i, j):
        return i * 0.5 + j / 4
    assert_same(dat.dfromfunction(f, (9, 6), dist=(4, 2)),
                tdat.dfromfunction(f, (9, 6), dist=(4, 2)))
    with pytest.raises(ValueError, match="f returned shape"):
        tdat.dfromfunction(lambda i, j: i[:1], (9, 6))


@pytest.mark.parametrize("cuts,procs", [
    ([[0, 3, 10, 16], [0, 8]], [2, 0, 5]),
    ([[0, 16], [0, 1, 2, 8]], [0, 1, 2, 3]),
    ([[0, 5, 5, 16], [0, 4, 8]], list(range(8)))])
def test_darray_from_cuts(cuts, procs):
    x = np.random.default_rng(12).standard_normal((16, 8)).astype(np.float32)
    td = tdat.darray_from_cuts(x, procs, cuts)
    jd = jdarray.darray_from_cuts(x, procs, cuts)
    assert_same(jd, td)
    with pytest.raises(ValueError, match="host shape"):
        tdat.darray_from_cuts(x[:3], procs, cuts)
    with pytest.raises(ValueError, match="needs"):
        tdat.darray_from_cuts(x, procs[:1], [[0, 8, 16], [0, 8]])


@pytest.mark.parametrize("dims,dist,procs", LAYOUTS, ids=LAYOUT_IDS)
def test_drandint_dsample_layout_range_seed(dims, dist, procs):
    tdat.seed(21)
    td = tdat.drandint(-3, 5, dims, procs=procs, dist=dist)
    jd = dat.drandint(-3, 5, dims, procs=procs, dist=dist)
    same_layout(jd, td)
    assert td.dtype == torch.int32 and np.asarray(jd).dtype == np.int32
    v = np.asarray(td)
    assert v.min() >= -3 and v.max() < 5 and set(np.unique(v)) == set(
        range(-3, 5))
    tdat.seed(21)
    np.testing.assert_array_equal(np.asarray(tdat.drandint(
        -3, 5, dims, procs=procs, dist=dist)), v)
    cells = td.cells()
    a, b = td.part(cells[0]), td.part(cells[1])
    k = min(a.numel(), b.numel())
    assert not torch.equal(a.reshape(-1)[:k], b.reshape(-1)[:k])
    t8 = tdat.drandint(0, 100, dims, dtype=np.int8, procs=procs, dist=dist)
    assert t8.dtype == torch.int8
    vals = np.array([1.5, -2.0, 7.25], np.float32)
    ts = tdat.dsample(vals, dims, procs=procs, dist=dist)
    js = dat.dsample(vals, dims, procs=procs, dist=dist)
    same_layout(js, ts)
    assert ts.dtype == torch.float32
    assert set(np.unique(np.asarray(ts))) == set(vals.tolist())
    tdat.seed(4)
    s1 = np.asarray(tdat.dsample(vals, dims, procs=procs, dist=dist))
    tdat.seed(4)
    np.testing.assert_array_equal(
        np.asarray(tdat.dsample(vals, dims, procs=procs, dist=dist)), s1)
    assert tdat.dsample([3, 4], (6,)).dtype == torch.int32
    for m in (tdat, dat):
        with pytest.raises(ValueError, match="empty value set"):
            m.dsample([], dims)


# ---------------------------------------------------------------------------
# DData, dfetch, isassigned, gather, dcat, core
# ---------------------------------------------------------------------------


def test_ddata_like_jax():
    for kw in ({"init": lambda i: {"rank": i}},
               {"data": list(range(16))}, {"data": list("abcdefgh")},
               {"init": lambda i: i * i, "pids": [5, 2, 7]}, {}):
        tdd, jdd = tdat.ddata(**kw), dat.ddata(**kw)
        assert tdat.gather(tdd) == dat.gather(jdd)
        np.testing.assert_array_equal(tdd.pids, jdd.pids)
        assert tdd.dims == jdd.dims and len(tdd) == len(jdd)
        for k in range(len(tdd) + 1):
            assert tdat.isassigned(tdd, k) == dat.isassigned(jdd, k)
        assert tdat.isassigned(tdd, 0, 0) == dat.isassigned(jdd, 0, 0)
    with pytest.raises(ValueError, match="not divisible"):
        tdat.ddata(data=list(range(9)))
    tdd = tdat.ddata(init=lambda i: torch.full((2,), float(i)))
    assert tdd.localpart(3).device == tdat.device_of(3)
    tdd.set_localpart("x", 1)
    jdd = dat.ddata(init=lambda i: i)
    jdd.set_localpart("x", 1)
    assert tdd.localpart(1) == jdd.localpart(1) == "x"
    assert tdat.dfetch(tdd, 1) == "x"
    with pytest.raises(KeyError):
        tdat.ddata(pids=[1]).localpart(0)
    # registered and closed like a DArray
    assert tdd.id in tdat.live_ids()
    assert any(d is tdd for d in tdat.live_arrays())
    tdat.d_closeall()
    assert tdat.live_ids() == [] and tdd._closed


@pytest.mark.parametrize("dims,dist,procs", LAYOUTS, ids=LAYOUT_IDS)
def test_dfetch_isassigned_like_jax(dims, dist, procs):
    x, jd, td = pair(dims, dist, procs, seed=13)
    idxs = [(0,) * len(dims), tuple(n - 1 for n in dims),
            tuple(n // 3 for n in dims), tuple(-1 for _ in dims)]
    for idx in idxs:
        got = tdat.dfetch(td, *idx)
        assert got.shape == () and float(got) == float(dat.dfetch(jd, *idx))
    for idx in idxs + [tuple(n for n in dims), (0,) * (len(dims) + 1),
                       tuple(-n - 1 for n in dims), (0,) * (len(dims) - 1)]:
        assert tdat.isassigned(td, *idx) == dat.isassigned(jd, *idx)
    key = (slice(1, 4),) + (slice(None),) * (len(dims) - 1)
    for idx in [(0,) * len(dims), (2,) + (0,) * (len(dims) - 1),
                (3,) + (0,) * (len(dims) - 1), (-3,) + (0,) * (len(dims) - 1),
                (0,)]:
        assert tdat.isassigned(td[key], *idx) == dat.isassigned(jd[key], *idx)
    assert float(tdat.dfetch(td[key], *(0,) * len(dims))) == float(
        x[key][(0,) * len(dims)])
    for m in (tdat, dat):
        with pytest.raises(TypeError, match="isassigned expects"):
            m.isassigned(x, 0)
    td.close()
    with pytest.raises(RuntimeError, match="closed"):
        tdat.isassigned(td, *idxs[0])


@pytest.mark.parametrize("dims,dist,procs", LAYOUTS, ids=LAYOUT_IDS)
def test_dcat_like_jax(dims, dist, procs):
    x, jd, td = pair(dims, dist, procs, seed=14)
    y = np.random.default_rng(15).standard_normal(dims).astype(np.float32)
    t2, j2 = tdat.distribute(y, dist=[2] + [1] * (len(dims) - 1)), \
        dat.distribute(y, dist=[2] + [1] * (len(dims) - 1))
    # the JAX package takes j2 as host data: another device set raises
    for dim in range(len(dims)):
        assert_same(dat.dcat(dim, jd, np.asarray(j2), y),
                    tdat.dcat(dim, td, t2, y))
    key = (slice(0, 3),) + (slice(None),) * (len(dims) - 1)
    assert_same(dat.dcat(0, np.asarray(j2[key]), jd),
                tdat.dcat(0, t2[key], td))
    xi = np.arange(int(np.prod(dims)), dtype=np.int8).reshape(dims)
    tc = tdat.dcat(0, td, xi)
    assert_same(dat.dcat(0, jd, xi), tc)
    assert tc.dtype == torch.float32


def test_dcat_without_darray_and_promotion():
    a = np.arange(6, dtype=np.int8).reshape(2, 3)
    b = np.arange(6, dtype=np.uint8).reshape(2, 3)
    tc, jc = tdat.dcat(1, a, b), dat.dcat(1, a, b)
    assert str(tc.dtype).removeprefix("torch.") == np.asarray(jc).dtype.name
    assert_same(jc, tc)


def test_core_helpers_like_jax():
    assert tdat.current_rank() == dat.current_rank() == 0
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    a, b = tdat.distribute(x), tdat.distribute(x, procs=[3, 1])
    live = tdat.live_arrays()
    assert [d.id for d in live[-2:]] == [a.id, b.id]
    assert all(isinstance(d, tdat.DArray) for d in live)
    assert [d.id for d in live] == sorted(d.id for d in live)
    np.testing.assert_array_equal(tdat.procs(b), dat.procs(
        dat.distribute(x, procs=[3, 1])))
    assert tdat.SubOrDArray == (tdat.DArray, tdat.SubDArray)
    assert isinstance(a[1:2], tdat.SubOrDArray)
    a.close()
    assert a.id not in [d.id for d in tdat.live_arrays()]


@pytest.mark.parametrize("key,sub", [
    ((slice(3, 40), slice(1, 7)), (slice(2, 9), 3)),
    ((slice(0, 50, 2), slice(None)), (-1,)),
    ((slice(10, 20), slice(2, 6)), (slice(None), slice(None, None, 2)))])
def test_subdarray_getitem_like_jax(key, sub):
    x, jd, td = pair((50, 8), (4, 2), seed=16)
    got = td[key][sub]
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jd[key][sub]))
    np.testing.assert_array_equal(got.numpy(), x[key][sub])
