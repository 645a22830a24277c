"""``dconv2d`` of the PyTorch port against the JAX package, on the cases of
``tests/test_conv.py`` (the same seeded inputs, kernels and layouts): the
values, the dtype, the cuts and the pids, and which path each layout takes
(the halo exchange on the ranks, or the host path behind one warning).
Float32 results match JAX's to rtol 1e-4 / atol 1e-5 (the per-rank conv
sums in another order than XLA's), integer inputs with integer kernels
bit for bit (exact float32 sums)."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributedarrays_tpu as dat
import distributedarrays_tpu_torch as tdat
from distributedarrays_tpu.ops.conv import _dense_conv
from distributedarrays_tpu_torch.ops import conv as TC
from distributedarrays_tpu_torch.utils import debug

from _torch_port import (jax_plan_cache, jax_process_state,  # noqa: F401
                         port_ranks, same_layout, typed_inputs)

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def fresh_warnings():
    debug._warned.clear()
    yield


def _r(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def run_both(x, k, procs, dist, compiled=True):
    jd = dat.distribute(x, procs=procs, dist=dist)
    td = tdat.distribute(x, procs=procs, dist=dist)
    if compiled:
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            tr = tdat.dconv2d(td, k)
    else:
        with pytest.warns(RuntimeWarning, match="gathering"):
            tr = tdat.dconv2d(td, k)
    jr = dat.dconv2d(jd, k)
    same_layout(jr, tr)
    return np.asarray(jr), tr


@pytest.mark.parametrize("kshape", [(3, 3), (5, 3), (1, 5), (4, 3), (2, 2)])
@pytest.mark.parametrize("dist", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_dconv2d_matches_jax(kshape, dist):
    # test_dconv2d_matches_dense and test_dconv2d_2d_grid_compiled: even
    # kernels take XLA's SAME split (lo = (k-1)//2, hi = k//2) on every
    # layout
    A, K = _r((64, 32), 0), _r(kshape, 1)
    want, tr = run_both(A, K, range(8), dist)
    assert tr.dtype == torch.float32
    np.testing.assert_allclose(np.asarray(tr), want, **TOL)
    dense = np.asarray(_dense_conv(jnp.asarray(A), jnp.asarray(K)))
    np.testing.assert_allclose(np.asarray(tr), dense, **TOL)


def test_dconv2d_nhwc_cout_change():
    X, K = _r((2, 32, 16, 3), 2), _r((3, 3, 3, 5), 3)
    want, tr = run_both(X, K, range(4), (1, 4, 1, 1))
    assert tr.dims == (2, 32, 16, 5)
    np.testing.assert_allclose(np.asarray(tr), want, **TOL)


@pytest.mark.parametrize("dist", [(1, 2, 2, 1), (2, 2, 1, 1), (4, 1, 2, 1)])
def test_dconv2d_nhwc_grids(dist):
    X, K = _r((4, 16, 8, 3), 4), _r((3, 5, 3, 2), 5)
    want, tr = run_both(X, K, range(8), dist)
    np.testing.assert_allclose(np.asarray(tr), want, **TOL)


def test_dconv2d_ineligible_warns_and_matches():
    A, K = _r((50, 32), 6), _r((3, 3), 7)
    want, tr = run_both(A, K, range(4), (4, 1), compiled=False)
    assert tr.cuts == [[0, 13, 26, 38, 50], [0, 32]]
    np.testing.assert_allclose(np.asarray(tr), want, **TOL)


@pytest.mark.parametrize("dist", [(4, 1), (1, 1, 1, 4)])
def test_dconv2d_host_path_computes_on_home(dist, monkeypatch):
    # the host path gathers onto the array's home device and convolves
    # there, never on the host behind the ranks' backs: home is stubbed to
    # a device object of its own, and the gather and the conv must use it
    home = torch.device("cpu", 0)
    monkeypatch.setattr(tdat.DArray, "home", lambda self: home)
    gathered, convolved = [], []
    region, dense = tdat.DArray.region, TC._dense_conv

    def spy_region(self, bounds, device):
        gathered.append(device)
        return region(self, bounds, device)

    def spy_dense(x, k):
        convolved.append(tuple(x.shape))
        return dense(x, k)
    monkeypatch.setattr(tdat.DArray, "region", spy_region)
    monkeypatch.setattr(TC, "_dense_conv", spy_dense)
    if len(dist) == 2:
        x, k = _r((50, 32), 6), _r((3, 3), 7)
    else:
        x, k = _r((2, 8, 8, 4), 12), _r((3, 3, 4, 2), 13)
    want, tr = run_both(x, k, range(4), dist, compiled=False)
    assert gathered == [home]
    assert convolved == [x.shape]    # one conv, of the whole array
    np.testing.assert_allclose(np.asarray(tr), want, **TOL)


def test_dconv2d_halo_fits_exactly():
    # 8 rows a rank and a halo of 4 (kh = 9): still the halo exchange
    want, tr = run_both(_r((64, 16), 8), _r((9, 3), 9), range(8), (8, 1))
    np.testing.assert_allclose(np.asarray(tr), want, **TOL)


@pytest.mark.parametrize("case", ["halo_too_wide", "channel_sharded"])
def test_dconv2d_other_ineligible_layouts(case):
    if case == "halo_too_wide":
        # 4 rows a rank and a halo of 5 (kh = 11)
        x, k, procs, dist = _r((32, 16), 10), _r((11, 3), 11), range(8), \
            (8, 1)
    else:
        x, k, procs, dist = _r((2, 8, 8, 4), 12), _r((3, 3, 4, 2), 13), \
            range(4), (1, 1, 1, 4)
    want, tr = run_both(x, k, procs, dist, compiled=False)
    np.testing.assert_allclose(np.asarray(tr), want, **TOL)


def test_dconv2d_batch_sharded_and_complex():
    X, K = _r((8, 16, 8, 2), 13), _r((3, 3, 2, 2), 14)
    want, tr = run_both(X, K, range(8), (8, 1, 1, 1))
    np.testing.assert_allclose(np.asarray(tr), want, **TOL)
    rng = np.random.default_rng(15)
    C = (rng.standard_normal((32, 8)) + 1j * rng.standard_normal((32, 8))
         ).astype(np.complex64)
    Kc = _r((3, 3), 16)
    want, tr = run_both(C, Kc, range(4), (4, 1))
    assert tr.dtype == torch.complex64
    np.testing.assert_allclose(np.asarray(tr), want, **TOL)


def test_dconv2d_complex_kernel():
    # a complex kernel: four real convs, against the dense complex conv
    rng = np.random.default_rng(17)
    C = (rng.standard_normal((32, 8)) + 1j * rng.standard_normal((32, 8))
         ).astype(np.complex64)
    Kc = (rng.standard_normal((3, 3)) + 1j * rng.standard_normal((3, 3))
          ).astype(np.complex64)
    want, tr = run_both(C, Kc, range(4), (4, 1))
    np.testing.assert_allclose(np.asarray(tr), want, **TOL)


@pytest.mark.parametrize("dtype", ["int32", "int8", "float16", "bfloat16"])
def test_dconv2d_dtypes_like_jax(dtype):
    # float32 accumulation, the result in x's dtype; small integers and an
    # integer kernel give exact sums, so integer results match bit for bit
    if dtype.startswith("int"):
        x = np.random.default_rng(18).integers(-5, 5, (64, 32)).astype(dtype)
        t = torch.from_numpy(x)
        k = np.random.default_rng(19).integers(-2, 3, (3, 3)).astype(
            np.float32)
    else:
        x, t = typed_inputs(dtype, (64, 32), seed=18, lo=-2.0, hi=2.0)
        k = _r((3, 3), 19)
    jd = dat.distribute(x, procs=range(8), dist=(8, 1))
    td = tdat.distribute(t, procs=range(8), dist=(8, 1))
    jr, tr = dat.dconv2d(jd, k), tdat.dconv2d(td, k)
    same_layout(jr, tr)
    assert str(tr.dtype).removeprefix("torch.") == dtype
    got = tr.full().float().numpy()
    want = np.asarray(jr).astype(np.float32)
    if dtype.startswith("int"):
        np.testing.assert_array_equal(got, want)
    else:
        # one rounding of each float32 sum to the half type
        np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)


def test_dconv2d_validation():
    with pytest.raises(TypeError, match="DArray"):
        tdat.dconv2d(np.zeros((4, 4)), np.zeros((3, 3)))
    d3 = tdat.dzeros((8, 8, 8), procs=range(4), dist=(4, 1, 1))
    with pytest.raises(ValueError, match="2-D or 4-D"):
        tdat.dconv2d(d3, np.zeros((3, 3)))
    d2 = tdat.dzeros((8, 8), procs=range(4), dist=(4, 1))
    with pytest.raises(ValueError, match="kh, kw"):
        tdat.dconv2d(d2, np.zeros((3, 3, 1, 1)))
    d4 = tdat.dzeros((2, 8, 8, 3), procs=range(4), dist=(1, 4, 1, 1))
    with pytest.raises(ValueError, match="Cin"):
        tdat.dconv2d(d4, np.zeros((3, 3, 2, 4)))


def test_dense_conv_even_kernel_split():
    # XLA's SAME split for an even kernel: one row of zeros above, two below
    x = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    k = torch.zeros(4, 1)
    k[0, 0] = 1.0                       # picks the row one above the centre
    got = TC._dense_conv(x, k)
    want = torch.cat([torch.zeros(1, 4), x[:3]])
    assert torch.equal(got, want)
