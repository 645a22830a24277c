"""Faults C13-C18 of the PyTorch port, each held against the JAX package
(and numpy) on the same seeded inputs: advanced index keys (C13), ``out=``
taking the promoted dtype (C14), the complex variance (C15), the complex
extrema (C16), ``bool @ bool`` (C17) and unary ``+`` of a bool DArray
(C18).  Exact types and values are compared bit for bit; the complex
variance and the float GEMMs pinned by dtype to a stated rtol."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributedarrays_tpu as dat
import distributedarrays_tpu_torch as tdat

from _torch_port import assert_typed_equal, port_ranks, same_layout  # noqa: F401

SHAPE = (37, 11)


def host(seed=0, shape=SHAPE):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def mask_rows(x):
    return x[:, 0] > 0


# ---------------------------------------------------------------------------
# C13: integer-array, list and boolean-mask keys
# ---------------------------------------------------------------------------

# each key as a function of the host array (the mask needs the values)
KEYS = {
    "list": lambda x: [1, 3, 5],
    "ndarray": lambda x: np.array([1, 3, 5]),
    "mask_rows": lambda x: mask_rows(x),
    "mixed_list_slice": lambda x: ([0, 2], slice(3, 7)),
    "negative_list": lambda x: [-1, -3, 4],
    "int_and_list": lambda x: (3, [1, 2, 9]),
    "two_lists": lambda x: ([1, 2, 30], [3, 4, 10]),
    "slice_and_list": lambda x: (slice(None), [1, 2]),
    "nested_list_step": lambda x: ([[1, 2], [36, 0]], slice(9, 2, -2)),
    "desc_to_front": lambda x: ([[1, 2], [36, 0]], slice(None, None, -2)),
    "mask_2d": lambda x: x > 0.5,
    "tensor": lambda x: torch.tensor([2, 20, 35]),
}
LAYOUTS = {"default": None, "8x1": (8, 1), "2x4": (2, 4)}
# held against numpy only (ROADMAP.md "Open on the JAX side"): a
# descending slice that runs to the front selects nothing in JAX, and a
# boolean mask over two dims raises IndexError there
NUMPY_ONLY = {"desc_to_front", "mask_2d"}


def _jax_key(k):
    return np.asarray(k) if isinstance(k, torch.Tensor) else k


@pytest.mark.parametrize("dist", list(LAYOUTS.values()), ids=list(LAYOUTS))
@pytest.mark.parametrize("name", list(KEYS))
def test_getitem_advanced_keys_match_jax_and_numpy(name, dist):
    # C13: the parent raised TypeError "unsupported DArray index"
    x = host()
    key = KEYS[name](x)
    jd = dat.distribute(x, dist=dist)
    td = tdat.distribute(x, dist=dist)
    want = x[_jax_key(key)]
    sub = td[key]
    assert isinstance(sub, tdat.SubDArray)
    assert sub.shape == want.shape
    got = np.asarray(sub)
    np.testing.assert_array_equal(got, want)
    if name not in NUMPY_ONLY:
        np.testing.assert_array_equal(got, np.asarray(jd[_jax_key(key)]))
    np.testing.assert_array_equal(np.asarray(sub.copy()), want)


@pytest.mark.parametrize("dist", list(LAYOUTS.values()), ids=list(LAYOUTS))
@pytest.mark.parametrize("name", list(KEYS))
def test_setitem_advanced_keys_match_jax_and_numpy(name, dist):
    # C13: d[k] = v writes the selected elements only, on their owners
    x = host()
    key = KEYS[name](x)
    shape = x[_jax_key(key)].shape
    for value in (0.0, np.random.default_rng(1).standard_normal(
            shape).astype(np.float32)):
        td = tdat.distribute(x, dist=dist)
        td[key] = value
        want = x.copy()
        want[_jax_key(key)] = value
        np.testing.assert_array_equal(np.asarray(td), want)
        if name not in NUMPY_ONLY:
            jd = dat.distribute(x, dist=dist)
            jd[_jax_key(key)] = value
            np.testing.assert_array_equal(np.asarray(td), np.asarray(jd))
            same_layout(jd, td)


def test_setitem_rows_touches_owner_ranks_only():
    # rows 1, 3, 5 of (37, 11) on (8, 1) live on ranks 0 and 1 (5 rows a
    # rank): every other rank's tensor keeps its storage and its bits
    x = host()
    td = tdat.distribute(x, dist=(8, 1))
    before = {ci: (td.part(ci).data_ptr(), td.part(ci).clone())
              for ci in td.cells()}
    td[[1, 3, 5]] = 0.0
    for ci in td.cells():
        assert td.part(ci).data_ptr() == before[ci][0]
        if ci[0] > 1:
            assert torch.equal(td.part(ci), before[ci][1])
    want = x.copy()
    want[[1, 3, 5]] = 0.0
    np.testing.assert_array_equal(np.asarray(td), want)


def test_boolean_mask_shape_follows_numpy():
    # JAX's SubDArray.shape of a boolean mask is the mask's own shape
    # ((37, 11)) while its values have numpy's (nnz, 11); the port's shape
    # is numpy's
    x = host()
    m = mask_rows(x)
    jsub = dat.distribute(x)[m]
    tsub = tdat.distribute(x)[m]
    assert tsub.shape == x[m].shape == np.asarray(jsub).shape
    assert jsub.shape == SHAPE


@pytest.mark.parametrize("key", [[0, 37], [-38], np.array([[1.5]]),
                                 np.zeros(36, bool)],
                         ids=["past_end", "before_start", "float", "mask"])
def test_advanced_key_errors(key):
    td = tdat.distribute(host())
    with pytest.raises(IndexError):
        td[key]


# ---------------------------------------------------------------------------
# C14: out= takes the promoted dtype (JAX rebinds out)
# ---------------------------------------------------------------------------

def _ints(seed=2):
    return np.random.default_rng(seed).integers(-50, 50, SHAPE).astype(
        np.int32)


def _f32(seed=3):
    return np.random.default_rng(seed).uniform(-4, 4, SHAPE).astype(
        np.float32)


C14_CASES = {
    "rmul_": (lambda P, d, f: P.rmul_(d, 2.5)),
    "lmul_": (lambda P, d, f: P.lmul_(2.5, d)),
    "axpy_": (lambda P, d, f: P.axpy_(2, f, d)),
    "lmul_diag": (lambda P, d, f: P.lmul_diag(
        np.linspace(0.5, 2.0, SHAPE[0], dtype=np.float32), d)),
    "rmul_diag": (lambda P, d, f: P.rmul_diag(
        d, np.linspace(0.5, 2.0, SHAPE[1], dtype=np.float32))),
    "dmap_out": (lambda P, d, f: P.dmap(_sin(P), f, out=d)),
    "dmap_into": (lambda P, d, f: P.dmap_into(_sin(P), d, f)),
}


def _sin(P):
    return torch.sin if P is tdat else jnp.sin


@pytest.mark.parametrize("name", list(C14_CASES))
def test_out_takes_promoted_dtype_like_jax(name):
    # C14: the parent copied into out, casting to int32 (max error 0.5)
    op = C14_CASES[name]
    i, f = _ints(), _f32()
    jd, jf = dat.distribute(i), dat.distribute(f)
    td, tf = tdat.distribute(i), tdat.distribute(f)
    jr, tr = op(dat, jd, jf), op(tdat, td, tf)
    assert tr is td
    assert td.dtype == torch.float32
    assert np.asarray(jr).dtype == np.float32
    same_layout(jd, td)
    # float32 elementwise ops in one order: bit for bit, but sin (the
    # platforms' libm may differ in the last ulp)
    rtol = 1e-6 if name.startswith("dmap") else 0.0
    assert_typed_equal(td, np.asarray(jr), rtol=rtol)


def test_out_same_dtype_writes_in_place():
    # when the promoted dtype is out's own, the result is written into
    # out's tensors in place (a localpart held by the caller sees it)
    f = _f32()
    td = tdat.distribute(f)
    lp = td.localpart(0)
    tdat.rmul_(td, 2.0)
    assert td.localpart(0) is lp
    np.testing.assert_array_equal(np.asarray(td), f * 2)


def test_copyto_keeps_destination_dtype():
    i, f = _ints(), _f32()
    jd, td = dat.distribute(i), tdat.distribute(i)
    dat.copyto_(jd, dat.distribute(f))
    tdat.copyto_(td, tdat.distribute(f))
    assert td.dtype == torch.int32
    assert_typed_equal(td, np.asarray(jd))


def test_setitem_keeps_destination_dtype():
    i, f = _ints(), _f32()
    jd, td = dat.distribute(i), tdat.distribute(i)
    jd[2:9, 1:5] = f[2:9, 1:5]
    td[2:9, 1:5] = f[2:9, 1:5]
    assert td.dtype == torch.int32
    assert_typed_equal(td, np.asarray(jd))


def test_matmul_out_keeps_destination_dtype():
    # integer-valued float32 operands: the products are exact in float32,
    # so both packages give the same float16 bits
    rng = np.random.default_rng(4)
    a = rng.integers(-4, 5, (37, 11)).astype(np.float32)
    b = rng.integers(-4, 5, (11, 13)).astype(np.float32)
    jc = dat.dzeros((37, 13), dtype=np.float16)
    tc = tdat.dzeros((37, 13), dtype=torch.float16)
    dat.matmul(dat.distribute(a), dat.distribute(b), out=jc)
    tdat.matmul(tdat.distribute(a), tdat.distribute(b), out=tc)
    assert tc.dtype == torch.float16
    assert_typed_equal(tc, np.asarray(jc))


@pytest.mark.parametrize("case", ["dmap_out_rebind", "dmap_into_rebind",
                                  "dmap_new"])
def test_elementwise_result_owns_its_tensors(case):
    # a result part that fn returned from its own arguments is copied:
    # writing to the source afterwards leaves the result unchanged (out
    # rebound to a's own tensors would be a view of a)
    f = _f32()
    a = tdat.distribute(f)
    if case == "dmap_new":
        r = tdat.dmap(lambda x: x, a)
    else:
        r = tdat.distribute(_ints())
        if case == "dmap_out_rebind":
            assert tdat.dmap(lambda x: x.float(), a, out=r) is r
        else:
            assert tdat.dmap_into(lambda x: x.float(), r, a) is r
        assert r.dtype == torch.float32
    for ci in a.cells():
        a.part(ci).fill_(99.0)
    np.testing.assert_array_equal(np.asarray(r), f)


# ---------------------------------------------------------------------------
# C15: complex dvar/dstd are real
# ---------------------------------------------------------------------------

def _complex(shape, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)


@pytest.mark.parametrize("ddof", [0, 1])
@pytest.mark.parametrize("dims", [None, 0, 1], ids=["all", "d0", "d1"])
@pytest.mark.parametrize("shape", [(5, 3), (37, 11)], ids=["5x3", "37x11"])
@pytest.mark.parametrize("fn", ["dvar", "dstd"])
def test_complex_variance_is_real_like_jax(fn, shape, dims, ddof):
    # C15: the parent squared x - mean without the modulus (0+40j for the
    # variance of arange(15)*(1+1j)) and kept complex64.  Float32 partials
    # merged in another order than XLA's: rtol 1e-5
    z = _complex(shape)
    jr = getattr(dat, fn)(dat.distribute(z), dims=dims, ddof=ddof)
    tr = getattr(tdat, fn)(tdat.distribute(z), dims=dims, ddof=ddof)
    assert_typed_equal(tr, np.asarray(jr), rtol=1e-5)


def test_complex_variance_repro():
    z = (np.arange(15) * (1 + 1j)).astype(np.complex64)
    assert_typed_equal(tdat.dvar(tdat.distribute(z)),
                       np.asarray(dat.dvar(dat.distribute(z))), rtol=1e-6)
    assert_typed_equal(tdat.dstd(tdat.distribute(z)),
                       np.asarray(dat.dstd(dat.distribute(z))), rtol=1e-6)
    np.testing.assert_allclose(float(tdat.dvar(tdat.distribute(z))), 40.0,
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# C16: complex extrema in JAX's lexicographic order
# ---------------------------------------------------------------------------

def _c16_inputs():
    a = (np.arange(15) + 1j * np.arange(15)[::-1]).astype(np.complex64)
    b = (np.arange(15) * (1 + 1j)).astype(np.complex64)
    # ties on the real part, decided by the imaginary part
    c = (np.repeat(np.arange(5), 3) + 1j * np.tile([2, -1, 5], 5)).astype(
        np.complex64)
    return {"a": a, "b": b, "c_ties": c}


@pytest.mark.parametrize("dims", [None, 0, 1], ids=["all", "d0", "d1"])
@pytest.mark.parametrize("name", ["a", "b", "c_ties"])
@pytest.mark.parametrize("fn", ["dmaximum", "dminimum"])
def test_complex_extrema_like_jax(fn, name, dims):
    # C16: the parent raised NotImplementedError (amax of complex)
    z = _c16_inputs()[name]
    if dims is not None:
        z = z.reshape(5, 3)
    jr = getattr(dat, fn)(dat.distribute(z), dims=dims)
    tr = getattr(tdat, fn)(tdat.distribute(z), dims=dims)
    assert_complex_equal(tr, np.asarray(jr))


def test_complex_extrema_repros():
    a = _c16_inputs()["a"]
    assert complex(tdat.dmaximum(tdat.distribute(a))) == 14 + 0j
    assert complex(tdat.dminimum(tdat.distribute(a))) == 14j
    b = _c16_inputs()["b"].reshape(5, 3)
    lo, hi = tdat.dextrema(tdat.distribute(b))
    jlo, jhi = dat.dextrema(dat.distribute(b))
    assert complex(lo) == complex(jlo) == 0j
    assert complex(hi) == complex(jhi) == 14 + 14j
    for dims in (0, 1):
        tl, th = tdat.dextrema(tdat.distribute(b), dims=dims)
        jl, jh = dat.dextrema(dat.distribute(b), dims=dims)
        assert_complex_equal(tl, np.asarray(jl))
        assert_complex_equal(th, np.asarray(jh))


def assert_complex_equal(port, want):
    got = port.full() if isinstance(port, tdat.DArray) else port
    assert got.dtype == torch.complex64
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# C17: bool @ bool
# ---------------------------------------------------------------------------

def _bools(shape, seed):
    return np.random.default_rng(seed).integers(0, 2, shape).astype(bool)


@pytest.mark.parametrize("case", ["default", "2x4_4x2", "host_b", "matvec",
                                  "matvec_host"])
def test_bool_matmul_like_jax(case):
    # C17: the parent raised NotImplementedError (addmm of Bool)
    a, b = _bools((37, 11), 6), _bools((11, 13), 7)
    da = db = None
    if case == "2x4_4x2":
        da, db = (2, 4), (4, 2)
    ja = dat.distribute(a, dist=da)
    ta = tdat.distribute(a, dist=da)
    if case.startswith("matvec"):
        b = b[:, 0]
    if case in ("host_b", "matvec_host"):
        jr, tr = ja @ b, ta @ b
    else:
        jr = ja @ dat.distribute(b, dist=db)
        tr = ta @ tdat.distribute(b, dist=db)
    same_layout(jr, tr)
    assert_typed_equal(tr, np.asarray(jr))
    np.testing.assert_array_equal(np.asarray(tr), a @ b)


def test_bool_matmul_out_keeps_dtype():
    a, b = _bools((37, 11), 8), _bools((11, 13), 9)
    jc = dat.dzeros((37, 13), dtype=np.float32)
    tc = tdat.dzeros((37, 13), dtype=torch.float32)
    dat.matmul(dat.distribute(a), dat.distribute(b), out=jc)
    tdat.matmul(tdat.distribute(a), tdat.distribute(b), out=tc)
    assert_typed_equal(tc, np.asarray(jc))


# ---------------------------------------------------------------------------
# C18: unary + of a bool DArray
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bool", "int8", "float32"])
def test_unary_plus_like_jax(dtype):
    # C18: the parent raised RuntimeError for bool
    x = np.random.default_rng(10).integers(-3, 3, SHAPE).astype(dtype)
    jd, td = dat.distribute(x), tdat.distribute(x)
    r = +td
    assert_typed_equal(r, np.asarray(+jd))
    r.part((0, 0))[0, 0] = not bool(r.part((0, 0))[0, 0])
    np.testing.assert_array_equal(np.asarray(td), x)    # a copy, not a view
