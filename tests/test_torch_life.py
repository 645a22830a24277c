"""The port's Game of Life (``life``, ``life_step``, ``life2d``) against the
JAX package's on the same seeded grids, bit for bit, and the layouts both
refuse."""

import numpy as np
import pytest

import distributedarrays_tpu as dat
import distributedarrays_tpu_torch as tdat
from distributedarrays_tpu import telemetry as JT
from distributedarrays_tpu.models import stencil as JS

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


def _grid(shape, seed, dtype, p=0.4):
    return (np.random.default_rng(seed).random(shape) < p).astype(dtype)


def _same(jd, td):
    a, b = np.asarray(jd), tdat.gather(td)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(b, a)
    assert td.pids.tolist() == jd.pids.tolist()
    assert [list(c) for c in td.cuts] == [list(c) for c in jd.cuts]


@pytest.mark.parametrize("dtype", ["int32", "uint8", "float32"])
@pytest.mark.parametrize("iters", [0, 1, 4, 9])
@pytest.mark.parametrize("p", [8, 4, 2])
def test_life_like_jax(p, iters, dtype):
    A = _grid((32, 24), 10 * p + iters, dtype)
    jd = dat.distribute(A, procs=range(p), dist=(p, 1))
    td = tdat.distribute(A, procs=range(p), dist=(p, 1))
    _same(JS.life(jd, iters=iters), tdat.life(td, iters=iters))


@pytest.mark.parametrize("dtype", ["int32", "uint8"])
@pytest.mark.parametrize("dist", [(4, 2), (2, 4), (2, 2), (1, 8), (8, 1)])
def test_life2d_like_jax(dist, dtype):
    A = _grid((32, 24), sum(dist), dtype)
    n = dist[0] * dist[1]
    jd = dat.distribute(A, procs=range(n), dist=dist)
    td = tdat.distribute(A, procs=range(n), dist=dist)
    _same(JS.life2d(jd, iters=5), tdat.life2d(td, iters=5))


def test_life_step_like_jax():
    A = _grid((40, 16), 3, "int32")
    jd = dat.distribute(A, procs=range(8), dist=(8, 1))
    td = tdat.distribute(A, procs=range(8), dist=(8, 1))
    _same(JS.life_step(jd), tdat.life_step(td))
    _same(JS.life(jd), tdat.life_step(td))


def test_life2d_glider_crosses_the_corner():
    A = np.zeros((32, 32), np.int32)
    glider = np.array([[0, 1, 0], [0, 0, 1], [1, 1, 1]], np.int32)
    A[11:14, 11:14] = glider
    d = tdat.distribute(A, procs=range(4), dist=(2, 2))
    got = tdat.gather(tdat.life2d(d, iters=20))
    want = np.zeros_like(A)
    want[16:19, 16:19] = glider
    np.testing.assert_array_equal(got, want)


def test_life_result_is_a_new_darray():
    A = _grid((16, 8), 1, "int32")
    d = tdat.distribute(A, procs=range(4), dist=(4, 1))
    for r in (tdat.life(d, 0), tdat.life(d, 2), tdat.life2d(
            tdat.distribute(A, procs=range(4), dist=(2, 2)), 0)):
        for ci in r.cells():
            r.part(ci).fill_(7)
    np.testing.assert_array_equal(tdat.gather(d), A)


@pytest.mark.parametrize("dims,dist", [((33, 24), (4, 2)), ((32, 25), (2, 2)),
                                       ((7, 8), (2, 1))])
def test_life2d_uneven_raises_like_jax(dims, dist):
    A = _grid(dims, 2, "int32")
    n = dist[0] * dist[1]
    for m in (dat, tdat):
        d = m.distribute(A, procs=range(n), dist=dist)
        life2d = JS.life2d if m is dat else tdat.life2d
        with pytest.raises(ValueError, match="even layout"):
            life2d(d)


@pytest.mark.parametrize("dims,dist", [((50, 8), (4, 1)), ((16, 16), (2, 2))])
def test_life_needs_a_row_layout_like_jax(dims, dist):
    A = _grid(dims, 4, "int32")
    for m, fn in ((dat, JS.life), (tdat, tdat.life)):
        d = m.distribute(A, procs=range(4), dist=dist)
        with pytest.raises(ValueError, match="row-sharded"):
            fn(d)
