"""``dfft``/``difft``/``dfft2``/``difft2`` of the PyTorch port against the
JAX package, on the cases of ``tests/test_fft.py`` (the same seeded inputs
and layouts): the values, the complex64 dtype, the cuts and the pids, and
which path each layout takes (the compiled all-to-all path or the host
path behind one warning).  Both packages and numpy's float64 FFT agree to
rtol/atol 1e-4 on these sizes (float32 transforms of a few hundred
points; the four-step twiddle and the sums round differently)."""

import warnings

import numpy as np
import pytest
import torch

import distributedarrays_tpu as dat
import distributedarrays_tpu_torch as tdat
from distributedarrays_tpu_torch.ops import cuda_collectives as C
from distributedarrays_tpu_torch.ops import fft as TF
from distributedarrays_tpu_torch.utils import debug

from _torch_port import (emulated_copies, port_ranks, same_layout,  # noqa: F401
                         typed_inputs)

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def fresh_warnings():
    # every test sees the host path's first warning
    debug._warned.clear()
    yield


@pytest.fixture
def a2a_calls(monkeypatch):
    """The all-to-alls the compiled path makes (the K11 kernel on CUDA
    tensors), counted."""
    calls = []
    real = TF.ring_all_to_all

    def counting(blocks, split_dim, concat_dim):
        calls.append((split_dim, concat_dim))
        return real(blocks, split_dim, concat_dim)
    monkeypatch.setattr(TF, "ring_all_to_all", counting)
    return calls


def both(x, procs=range(8), dist=None):
    jd = dat.distribute(x, procs=procs, dist=dist)
    td = tdat.distribute(x, procs=procs, dist=dist)
    return jd, td


def assert_like_jax(jr, tr, ref=None):
    same_layout(jr, tr)
    assert tr.dtype == torch.complex64
    got = np.asarray(tr)
    np.testing.assert_allclose(got, np.asarray(jr), **TOL)
    if ref is not None:
        np.testing.assert_allclose(got, ref, **TOL)


def _a(shape=(32, 16), seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("axis,calls", [(1, 0), (0, 2), (-1, 0)],
                         ids=["resident", "sharded", "last"])
def test_dfft_axes_8x1(axis, calls, a2a_calls):
    # test_dfft_resident_axis, test_dfft_sharded_axis_all_to_all
    A = _a()
    jd, td = both(A, dist=(8, 1))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tr = tdat.dfft(td, axis=axis)
    assert_like_jax(dat.dfft(jd, axis=axis), tr, np.fft.fft(A, axis=axis))
    assert len(a2a_calls) == calls


def test_dfft_sharded_axis_of_1x8_grid(a2a_calls):
    A = _a((16, 32))
    jd, td = both(A, dist=(1, 8))
    assert_like_jax(dat.dfft(jd, axis=1), tdat.dfft(td, axis=1),
                    np.fft.fft(A, axis=1))
    assert a2a_calls == [(0, 1), (1, 0)]


def test_dfft2_roundtrip_keeps_layout(a2a_calls):
    A = _a()
    jd, td = both(A, dist=(8, 1))
    jf, tf = dat.dfft2(jd), tdat.dfft2(td)
    same_layout(jf, tf)
    np.testing.assert_allclose(np.asarray(tf), np.asarray(jf), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(np.asarray(tf), np.fft.fft2(A), rtol=1e-3,
                               atol=1e-3)
    jb, tb = dat.difft2(jf), tdat.difft2(tf)
    assert_like_jax(jb, tb, A)
    assert tb.cuts == td.cuts
    assert len(a2a_calls) == 4          # two a transform along dim 0


def test_dfft_uneven_host_path_keeps_cuts():
    V = np.random.default_rng(1).standard_normal(50).astype(np.float32)
    jd, td = both(V, procs=range(4))
    with pytest.warns(RuntimeWarning, match="gathering"):
        tr = tdat.dfft(td)
    assert_like_jax(dat.dfft(jd), tr, np.fft.fft(V))
    assert tr.cuts == td.cuts
    back = tdat.difft(tr)
    np.testing.assert_allclose(np.asarray(back).real, V, **TOL)
    same_layout(dat.difft(dat.dfft(jd)), back)


def test_dfft_2d_grid_host_path(a2a_calls):
    A = _a()
    jd, td = both(A, dist=(4, 2))
    with pytest.warns(RuntimeWarning, match="gathering"):
        tr = tdat.dfft(td, axis=0)
    assert_like_jax(dat.dfft(jd, axis=0), tr, np.fft.fft(A, axis=0))
    assert a2a_calls == []


def test_dfft_validation():
    d = tdat.dzeros((8, 8), procs=range(4), dist=(4, 1))
    with pytest.raises(ValueError, match="axis"):
        tdat.dfft(d, axis=3)
    with pytest.raises(TypeError, match="DArray"):
        tdat.dfft(np.zeros(4))
    with pytest.raises(ValueError, match="2-D"):
        tdat.dfft2(tdat.dzeros((8,), procs=range(4)))
    with pytest.raises(ValueError, match="2-D"):
        tdat.difft2(tdat.dzeros((8,), procs=range(4)))


def test_dfft_resident_axis_non_divisible_stays_compiled(a2a_calls):
    A = _a((32, 10))
    jd, td = both(A, dist=(8, 1))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tr = tdat.dfft(td, axis=1)
    assert_like_jax(dat.dfft(jd, axis=1), tr, np.fft.fft(A, axis=1))
    with pytest.warns(RuntimeWarning, match="gathering"):
        tr0 = tdat.dfft(td, axis=0)
    assert_like_jax(dat.dfft(jd, axis=0), tr0, np.fft.fft(A, axis=0))
    assert a2a_calls == []


@pytest.mark.parametrize("inverse", [False, True], ids=["fft", "ifft"])
def test_dfft_1d_compiled_four_step(inverse, a2a_calls):
    x = np.random.default_rng(2).standard_normal(256).astype(np.float32)
    jd, td = both(x)
    fn, jfn = (tdat.difft, dat.difft) if inverse else (tdat.dfft, dat.dfft)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tr = fn(td)
    ref = np.fft.ifft(x) if inverse else np.fft.fft(x)
    assert_like_jax(jfn(jd), tr, ref)
    assert len(a2a_calls) == 3
    back = (tdat.dfft if inverse else tdat.difft)(tr)
    np.testing.assert_allclose(np.asarray(back).real, x, **TOL)
    assert back.cuts == td.cuts


@pytest.mark.parametrize("n,p", [(128, 4), (1024, 8), (4096, 8)])
def test_dfft_1d_complex_input_compiled(n, p, a2a_calls):
    rng = np.random.default_rng(3)
    z = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    jd, td = both(z, procs=range(p))
    assert_like_jax(dat.dfft(jd), tdat.dfft(td), np.fft.fft(z))
    assert len(a2a_calls) == 3


def test_dfft_1d_not_p_squared_divisible_host_path(a2a_calls):
    x = np.random.default_rng(4).standard_normal(72).astype(np.float32)
    jd, td = both(x)
    with pytest.warns(RuntimeWarning, match="gathering"):
        tr = tdat.dfft(td)
    assert_like_jax(dat.dfft(jd), tr, np.fft.fft(x))
    assert a2a_calls == []


@pytest.mark.parametrize("dtype", ["float16", "bfloat16", "int8", "bool"])
@pytest.mark.parametrize("axis", [0, 1])
def test_dfft_input_dtypes_promote_like_jax(dtype, axis):
    # every input type gives complex64, as jnp.fft with 64-bit types off
    h, t = typed_inputs(dtype, (32, 16), seed=5, lo=-4.0, hi=4.0)
    jd = dat.distribute(h, dist=(8, 1))
    td = tdat.distribute(t, dist=(8, 1))
    tr = tdat.dfft(td, axis=axis)
    assert_like_jax(dat.dfft(jd, axis=axis), tr)


@pytest.mark.parametrize("k1,n2,n,inverse", [
    (7, 1 << 17, 1 << 20, False), (3, 1 << 17, 1 << 20, True),
    (5, 72, 576, False), (2, 97 * 4, 97 * 16, True)],
    ids=["pow2", "pow2_inverse", "72", "odd_factor"])
def test_four_step_twiddle_against_float64(k1, n2, n, inverse):
    # each table's phase is exact in float64 and rounded once to complex64;
    # their product in complex64 adds one more rounding: 2.5e-7
    hi, lo = TF._twiddle(k1, n2, n, inverse, torch.device("cpu"))
    assert hi.dtype == lo.dtype == torch.complex64
    tw = (hi[:, None] * lo[None, :]).reshape(-1).numpy()
    sign = 2j if inverse else -2j
    ref = np.exp(sign * np.pi * (k1 * np.arange(n2)) / n)
    np.testing.assert_allclose(tw, ref, rtol=0, atol=2.5e-7)


@pytest.mark.parametrize("case", ["sharded_2d", "four_step", "inverse_2d",
                                  "four_step_inverse"])
def test_kernel_path_complex64_blocks(case, monkeypatch):
    # the CUDA branch of ring_all_to_all on host complex64 blocks, its copy
    # launches emulated: one K11 launch an all-to-all on 4 ranks (16
    # pieces), 2 a sharded-axis transform and 3 a four-step one, and the
    # values equal to the plain path's bit for bit
    inverse = case.endswith("inverse") or case.startswith("inverse")
    fn = tdat.difft if inverse else tdat.dfft
    if case.endswith("2d"):
        x, dist, want_calls = _a((32, 16), 6), (4, 1), 2
    else:
        x, dist, want_calls = _a((256,), 7), None, 3
    d = tdat.distribute(x, procs=range(4), dist=dist)
    want = fn(d, axis=0)
    calls = []
    monkeypatch.setattr(C, "_on_cuda", lambda ts: True)
    monkeypatch.setattr(C, "_copy_on_card", emulated_copies(calls))
    got = fn(d, axis=0)
    for ci in d.cells():
        assert torch.equal(got.part(ci), want.part(ci))
    assert calls == [("all_to_all", 1)] * want_calls
