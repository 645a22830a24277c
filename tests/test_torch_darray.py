"""DArray construction, layout queries, gather and lifecycle of the PyTorch
port against the JAX package: layouts and values exactly equal."""

import numpy as np
import pytest
import torch

import distributedarrays_tpu as dat
import distributedarrays_tpu_torch as tdat

from _torch_port import port_ranks, same_layout, state_of  # noqa: F401

LAYOUTS = [((16, 8), (4, 2)), ((16, 8), (8, 1)), ((50, 8), None),
           ((50, 8), (4, 2)), ((7,), None), ((3,), None), ((5, 6, 4), None)]


@pytest.mark.parametrize("dims,dist", LAYOUTS)
def test_distribute_layout_localparts_gather(dims, dist):
    x = np.random.default_rng(0).standard_normal(dims).astype(np.float32)
    jd = dat.distribute(x, dist=dist)
    td = tdat.distribute(x, dist=dist)
    same_layout(jd, td)
    for r in range(8):
        assert td.localindices(r) == jd.localindices(r)
        np.testing.assert_array_equal(td.localpart(r).numpy(),
                                      np.asarray(jd.localpart(r)))
    np.testing.assert_array_equal(tdat.gather(td), np.asarray(dat.gather(jd)))


@pytest.mark.parametrize("src,want", [(np.float64, torch.float32),
                                      (np.int64, torch.int32),
                                      (np.float32, torch.float32),
                                      (np.bool_, torch.bool)])
def test_distribute_narrows_64bit_like_jax(src, want):
    x = (np.arange(24).reshape(6, 4) % 3).astype(src)
    td = tdat.distribute(x)
    jd = dat.distribute(x)
    assert td.dtype == want
    assert np.asarray(td).dtype == np.asarray(jd).dtype
    np.testing.assert_array_equal(np.asarray(td), np.asarray(jd))


@pytest.mark.parametrize("ctor", ["dzeros", "dones", "drand", "drandn"])
def test_constructors_layout_and_values(ctor):
    jd = getattr(dat, ctor)((50, 8), dist=(4, 2))
    td = getattr(tdat, ctor)((50, 8), dist=(4, 2))
    same_layout(jd, td)
    assert td.dtype == torch.float32
    v = np.asarray(td)
    if ctor == "dzeros":
        assert (v == 0).all()
    elif ctor == "dones":
        assert (v == 1).all()
    elif ctor == "drand":
        assert ((v >= 0) & (v < 1)).all() and 0.3 < v.mean() < 0.7
    else:
        assert abs(v.mean()) < 0.3 and 0.7 < v.std() < 1.3


def test_dfill_and_seed():
    jd = dat.dfill(2.5, (9, 4))
    td = tdat.dfill(2.5, (9, 4))
    same_layout(jd, td)
    np.testing.assert_array_equal(np.asarray(td), np.asarray(jd))
    assert tdat.dfill(3, (4,)).dtype == torch.int32
    tdat.seed(7)
    a = np.asarray(tdat.drand((16, 4)))
    tdat.seed(7)
    np.testing.assert_array_equal(a, np.asarray(tdat.drand((16, 4))))
    # every rank draws its own stream
    assert not np.array_equal(a[:2], a[2:4])


def test_darray_init_and_from_chunks():
    def init(idx):
        return np.add.outer(np.arange(idx[0].start, idx[0].stop) * 10.0,
                            np.arange(idx[1].start, idx[1].stop)
                            ).astype(np.float32)
    jd = dat.darray(init, (13, 6), dist=(4, 2))
    td = tdat.darray(init, (13, 6), dist=(4, 2))
    same_layout(jd, td)
    np.testing.assert_array_equal(np.asarray(td), np.asarray(jd))
    chunks = np.empty((3, 1), dtype=object)
    for i, n in enumerate((2, 0, 5)):
        chunks[i, 0] = np.full((n, 3), i, dtype=np.float32)
    jc = dat.from_chunks(chunks)
    tc = tdat.from_chunks(chunks)
    same_layout(jc, tc)
    np.testing.assert_array_equal(np.asarray(tc), np.asarray(jc))


def test_makelocal_subdarray_and_locate():
    x = np.arange(50 * 8, dtype=np.float32).reshape(50, 8)
    jd, td = dat.distribute(x, dist=(4, 2)), tdat.distribute(x, dist=(4, 2))
    for key in [(slice(3, 40), slice(1, 7)), (7, slice(None)),
                (slice(45, 5, -2), slice(0, 8, 3))]:
        np.testing.assert_array_equal(np.asarray(td[key]), x[key])
        np.testing.assert_array_equal(np.asarray(td[key]),
                                      np.asarray(jd[key]))
    # a descending slice that runs to the front: the port follows numpy
    # (the JAX package's SubDArray comes back empty here)
    key = (slice(None, None, -3), 2)
    np.testing.assert_array_equal(np.asarray(td[key]), x[key])
    np.testing.assert_array_equal(
        td.makelocal(slice(10, 30), slice(2, 5)).numpy(),
        np.asarray(jd.makelocal(slice(10, 30), slice(2, 5))))
    for idx in [(0, 0), (13, 4), (49, 7), (26, 3)]:
        assert tdat.locate(td, *idx) == dat.locate(jd, *idx)
    np.testing.assert_array_equal(np.asarray(td[5:9].copy()), x[5:9])


def test_scalar_indexing_guard():
    td = tdat.distribute(np.arange(12, dtype=np.float32).reshape(4, 3))
    with pytest.raises(RuntimeError, match="scalar indexing"):
        td[1, 2]
    with tdat.allowscalar(True):
        assert float(td[1, 2]) == 5.0
        assert float(td[-1, -1]) == 11.0
    with pytest.raises(RuntimeError):
        td[0, 0]
    with pytest.raises(IndexError):
        with tdat.allowscalar(True):
            td[4, 0]


def test_lifecycle_closeall_and_use_after_close():
    a = tdat.dzeros((8, 8))
    b = tdat.dones((4,))
    assert set(tdat.live_ids()) >= {a.id, b.id}
    a.close()
    assert a.id not in tdat.live_ids()
    with pytest.raises(RuntimeError, match="closed"):
        a.localpart(0)
    with pytest.raises(RuntimeError, match="closed"):
        np.asarray(a)
    tdat.d_closeall()
    assert tdat.live_ids() == []
    with pytest.raises(RuntimeError, match="closed"):
        b + 1.0


@pytest.mark.parametrize("dims,dist", [((50, 8), (4, 2)), ((13,), None),
                                       ((16, 16), (2, 4))])
def test_from_reference_round_trip(dims, dist):
    x = np.random.default_rng(3).standard_normal(dims)      # float64
    jd = dat.distribute(x, dist=dist)
    td = tdat.from_reference(state_of(jd))
    same_layout(jd, td)
    for r in range(8):
        np.testing.assert_array_equal(td.localpart(r).numpy(),
                                      np.asarray(jd.localpart(r)))
    back = tdat.to_reference(td)
    np.testing.assert_array_equal(back["array"], np.asarray(jd))
    assert back["cuts"] == jd.cuts
    np.testing.assert_array_equal(back["pids"], jd.pids)


def test_layout_errors_match():
    with pytest.raises(ValueError):
        dat.distribute(np.zeros((4, 4)), dist=(3, 3))
    with pytest.raises(ValueError):
        tdat.distribute(np.zeros((4, 4)), dist=(3, 3))
    with pytest.raises(ValueError):
        tdat.distribute(np.zeros((4, 4)), dist=(2,))
    with pytest.raises(ValueError):
        tdat.distribute(np.zeros((4, 4)), procs=[0, 9], dist=(2, 1))
