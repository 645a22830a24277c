"""Broadcast and reductions of the PyTorch port against the JAX package.

Elementwise results agree to float32 rounding.  Reductions agree to
rtol 1e-5: both packages reduce each chunk and then combine, but the order
of the float32 sums inside a chunk differs between XLA and torch.

The dtype cases (float16, bfloat16, uint8, int8 and bool over four shapes)
hold the port to JAX's dtype and value exactly: integer sums and products
are exact (then wrapped into int32 or uint32), and a float16 or bfloat16
sum or product is one float32 sum rounded once to the type in both
packages, so only its order differs, far below the type's spacing.
"""

import operator

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributedarrays_tpu as dat
import distributedarrays_tpu_torch as tdat

from _torch_port import (TYPED_DTYPES, TYPED_SHAPES,  # noqa: F401
                         assert_typed_equal, port_ranks, same_layout,
                         typed_inputs)

RTOL = 1e-5


def _data(shape, seed=0, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def test_chain_across_mismatched_layouts():
    x, y, z = (_data((16, 12), s) for s in range(3))
    jr = dat.dmap(jnp.sin, dat.distribute(x, dist=(4, 2))) + \
        dat.distribute(y, dist=(8, 1)) * dat.distribute(z, dist=(2, 4))
    tr = tdat.dmap(torch.sin, tdat.distribute(x, dist=(4, 2))) + \
        tdat.distribute(y, dist=(8, 1)) * tdat.distribute(z, dist=(2, 4))
    same_layout(jr, tr)
    np.testing.assert_allclose(np.asarray(tr), np.asarray(jr), rtol=RTOL,
                               atol=1e-6)


def test_chain_across_disjoint_rank_sets():
    x, y = _data((12, 10), 4), _data((12, 10), 5)
    ja = dat.distribute(x, procs=[0, 1, 2, 3], dist=(4, 1))
    jb = dat.distribute(y, procs=[4, 5, 6, 7], dist=(2, 2))
    ta = tdat.distribute(x, procs=[0, 1, 2, 3], dist=(4, 1))
    tb = tdat.distribute(y, procs=[4, 5, 6, 7], dist=(2, 2))
    jr, tr = jb - ja * 3.0, tb - ta * 3.0
    same_layout(jr, tr)
    np.testing.assert_allclose(np.asarray(tr), np.asarray(jr), rtol=RTOL)


@pytest.mark.parametrize("case", ["row", "col", "scalar_left", "pow", "neg",
                                  "abs", "div", "lt", "floordiv"])
def test_operators_and_broadcasting(case):
    x = _data((16, 12), 6)
    row = np.arange(12, dtype=np.float32)
    col = np.arange(16, dtype=np.float32)[:, None]
    ops = {
        "row": lambda a: a + row * 2.0,
        "col": lambda a: a * col,
        "scalar_left": lambda a: 2.0 - a,
        "pow": lambda a: a ** 2,
        "neg": lambda a: -a,
        "abs": lambda a: abs(a),
        "div": lambda a: a / 3,
        "lt": lambda a: a < 0.25,
        "floordiv": lambda a: (a * 10.0) // 3.0,
    }
    jd, td = dat.distribute(x, dist=(4, 2)), tdat.distribute(x, dist=(4, 2))
    jr, tr = ops[case](jd), ops[case](td)
    same_layout(jr, tr)
    jv, tv = np.asarray(jr), np.asarray(tr)
    assert tv.dtype == jv.dtype
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=1e-6)


def test_result_takes_default_layout_without_template():
    x = _data((16, 1), 7)
    row = _data((12,), 8)
    jr = dat.distribute(x, dist=(4, 1)) + row
    tr = tdat.distribute(x, dist=(4, 1)) + row
    same_layout(jr, tr)
    np.testing.assert_allclose(np.asarray(tr), np.asarray(jr), rtol=RTOL)


def test_dmap_into_and_broadcasted():
    x, y = _data((10, 6), 9), _data((10, 6), 10)
    jo = dat.dzeros((10, 6), dist=(2, 1))
    to = tdat.dzeros((10, 6), dist=(2, 1))
    dat.dmap_into(lambda a, b: a * b + 1, jo, dat.distribute(x),
                  dat.distribute(y))
    r = tdat.dmap_into(lambda a, b: a * b + 1, to, tdat.distribute(x),
                       tdat.distribute(y))
    assert r is to
    np.testing.assert_allclose(np.asarray(to), np.asarray(jo), rtol=RTOL)
    tb = tdat.broadcasted(torch.maximum, tdat.distribute(x),
                          tdat.distribute(y))
    np.testing.assert_array_equal(np.asarray(tb), np.maximum(x, y))
    with pytest.raises(ValueError):
        tdat.dmap_into(torch.neg, tdat.dzeros((3, 3)), tdat.distribute(x))


REDUCERS = ["dsum", "dprod", "dmaximum", "dminimum", "dmean", "dvar", "dstd"]


@pytest.mark.parametrize("fn", REDUCERS)
@pytest.mark.parametrize("dims", [None, 0, 1, (0, 1)])
def test_reductions_uneven_layout(fn, dims):
    x = _data((50, 8), 11, 0.97, 1.03)
    jd = dat.distribute(x, dist=(4, 2))
    td = tdat.distribute(x, dist=(4, 2))
    jr = getattr(dat, fn)(jd, dims=dims)
    tr = getattr(tdat, fn)(td, dims=dims)
    if dims is None:
        assert isinstance(tr, torch.Tensor) and tr.ndim == 0
        np.testing.assert_allclose(float(tr), float(jr), rtol=RTOL)
    else:
        same_layout(jr, tr)
        np.testing.assert_allclose(np.asarray(tr), np.asarray(jr), rtol=RTOL)


@pytest.mark.parametrize("dims", [None, (0, 2), 1])
def test_reductions_3d(dims):
    x = _data((6, 10, 4), 12)
    jd, td = dat.distribute(x), tdat.distribute(x)
    for fn in ("dsum", "dmean", "dstd"):
        jr = getattr(dat, fn)(jd, dims=dims)
        tr = getattr(tdat, fn)(td, dims=dims)
        if dims is not None:
            same_layout(jr, tr)
        np.testing.assert_allclose(np.asarray(tr), np.asarray(jr), rtol=RTOL,
                                   atol=1e-6)


@pytest.mark.parametrize("dims", [None, 0, 1])
def test_dmapreduce_named_and_binary(dims):
    x = _data((13, 6), 13)
    jd, td = dat.distribute(x, dist=(4, 2)), tdat.distribute(x, dist=(4, 2))
    jr = dat.dmapreduce(jnp.square, "sum", jd, dims=dims)
    tr = tdat.dmapreduce(torch.square, "sum", td, dims=dims)
    np.testing.assert_allclose(np.asarray(tr), np.asarray(jr), rtol=RTOL)
    jb = dat.dmapreduce(jnp.abs, operator.add, jd, dims=dims)
    tb = tdat.dmapreduce(torch.abs, operator.add, td, dims=dims)
    if dims is not None:
        same_layout(jb, tb)
    np.testing.assert_allclose(np.asarray(tb), np.asarray(jb), rtol=RTOL)
    tm = tdat.dmapreduce(None, torch.amax, td, dims=dims)
    np.testing.assert_array_equal(np.asarray(tm),
                                  np.asarray(dat.dmaximum(jd, dims=dims)))


def test_integer_reductions_keep_jax_dtypes():
    x = np.arange(40, dtype=np.int32).reshape(8, 5)
    jd, td = dat.distribute(x), tdat.distribute(x)
    for fn in ("dsum", "dmaximum", "dmean"):
        jr, tr = getattr(dat, fn)(jd), getattr(tdat, fn)(td)
        assert tr.numpy().dtype == np.asarray(jr).dtype
        assert float(tr) == pytest.approx(float(jr))
    assert bool(tdat.dreduce("all", tdat.distribute(x >= 0)))
    assert tdat.distribute(x).sum(dims=0).dims == (1, 5)


@pytest.mark.parametrize("dims", [None, 0])
@pytest.mark.parametrize("fn", ["dsum", "dprod"])
@pytest.mark.parametrize("shape", TYPED_SHAPES)
@pytest.mark.parametrize("dtype", TYPED_DTYPES)
def test_sum_and_prod_follow_jax_dtypes(dtype, shape, fn, dims):
    # products of floats near 1 stay finite; sums over +-100 are where a
    # float16 partial rounded per rank would show
    lo, hi = (0.9, 1.1) if fn == "dprod" else (-100.0, 100.0)
    a, t = typed_inputs(dtype, shape, 21, lo, hi)
    jr = getattr(dat, fn)(dat.distribute(a), dims=dims)
    tr = getattr(tdat, fn)(tdat.distribute(t), dims=dims)
    if dims is not None:
        same_layout(jr, tr)
    assert_typed_equal(tr, jr)
    dat.d_closeall()


# the bool and integer operator cases where torch's own rules differ from
# JAX's weakly typed Python scalars; x is a DArray of the case's dtype
OPERATOR_CASES = {
    "bool * 2": ("bool", lambda b: b * 2),
    "bool + 2": ("bool", lambda b: b + 2),
    "bool // 2": ("bool", lambda b: b // 2),
    "bool % 2": ("bool", lambda b: b % 2),
    "bool ** 2": ("bool", lambda b: b ** 2),
    "bool ** True": ("bool", lambda b: b ** True),
    "bool - 2": ("bool", lambda b: b - 2),
    "bool - 2.5": ("bool", lambda b: b - 2.5),
    "2 - bool": ("bool", lambda b: 2 - b),
    "bool // True": ("bool", lambda b: b // True),
    "bool % True": ("bool", lambda b: b % True),
    "bool / 2": ("bool", lambda b: b / 2),
    "int8 - True": ("int8", lambda x: x - True),
    "uint8 - True": ("uint8", lambda x: x - True),
    "float16 - True": ("float16", lambda x: x - True),
    "bfloat16 - True": ("bfloat16", lambda x: x - True),
    "int8 ** 300": ("int8", lambda x: x ** 300),
    "uint8 ** 300": ("uint8", lambda x: x ** 300),
    "int8 + 300": ("int8", lambda x: x + 300),
    "int8 * 2.5": ("int8", lambda x: x * 2.5),
    "float16 * 0.1": ("float16", lambda x: x * 0.1),
    "bfloat16 * 0.1": ("bfloat16", lambda x: x * 0.1),
}


@pytest.mark.parametrize("shape", TYPED_SHAPES)
@pytest.mark.parametrize("case", list(OPERATOR_CASES))
def test_operators_follow_jax_promotion(case, shape):
    dtype, op = OPERATOR_CASES[case]
    a, t = typed_inputs(dtype, shape, 22)
    jr, tr = op(dat.distribute(a)), op(tdat.distribute(t))
    same_layout(jr, tr)
    assert_typed_equal(tr, jr)
    dat.d_closeall()
