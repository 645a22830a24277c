"""Faults C32-C33 of the PyTorch port, each held against the JAX package on
the same seeded numpy inputs: the uint16 and uint32 stencils and Life
(C32: the plain steps and the Life rule added the unsigned tensors, which
torch does not add), and ``dnnz``, ``dcount`` and ``dmap`` on uint16 and
uint32 DArrays (C33: torch counts, orders and adds neither type).  A (32,
24) grid on a (4,1) layout of 4 ranks, and a (2,2) layout for ``life2d``;
dtypes and values are compared bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributedarrays_tpu as dat
import distributedarrays_tpu_torch as tdat
from distributedarrays_tpu.models import stencil as jstencil

from _torch_port import (assert_typed_equal, jax_plan_cache,  # noqa: F401
                         jax_process_state, port_ranks, same_layout)

UNSIGNED = ["uint16", "uint32"]
SHAPE = (32, 24)
ROWS = {"procs": [0, 1, 2, 3], "dist": (4, 1)}

# nonnegative weights: a negative one raises numpy's OverflowError in the
# cast to an unsigned type, in both packages (``test_torch_stencil.py``)
WEIGHTS = {"ones": ((1, 1, 1), (1, 1, 1), (1, 1, 1)),
           "five_point_2": ((0, 1, 0), (1, 2, 1), (0, 1, 0))}


def _grid(dtype: str, seed: int) -> np.ndarray:
    """Values over the whole range of ``dtype``, so that sums wrap."""
    return np.random.default_rng(seed).integers(
        0, np.iinfo(dtype).max, SHAPE, dtype=np.uint64,
        endpoint=True).astype(dtype)


def _cells(dtype: str, seed: int) -> np.ndarray:
    """A Life board: mostly dead (0) and alive (1) cells, and some of the
    type's largest value, whose neighbour sums wrap past 0 to 2 or 3."""
    top = np.iinfo(dtype).max
    return np.random.default_rng(seed).choice(
        np.array([0, 0, 1, 1, top, top - 1], dtype=dtype), SHAPE)


def both(a: np.ndarray, **kw):
    jd, td = dat.distribute(a, **kw), tdat.distribute(a, **kw)
    same_layout(jd, td)
    return jd, td


# ---------------------------------------------------------------------------
# C32: uint16 and uint32 stencils and Life
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("iters", [1, 3])
@pytest.mark.parametrize("weights", sorted(WEIGHTS))
@pytest.mark.parametrize("dtype", UNSIGNED)
def test_c32_unsigned_stencil3x3_follows_jax(dtype, weights, iters):
    # C32: the plain step added the unsigned tensors ("add_stub" not
    # implemented for 'UInt16'); it now sums in the wider signed type and
    # wraps back, as JAX wraps
    jd, td = both(_grid(dtype, 5), **ROWS)
    w = WEIGHTS[weights]
    jr, tr = jstencil.stencil3x3(jd, w, iters), tdat.stencil3x3(td, w, iters)
    same_layout(jr, tr)
    assert_typed_equal(tr, jr)


@pytest.mark.parametrize("iters", [1, 3])
@pytest.mark.parametrize("dtype", UNSIGNED)
def test_c32_unsigned_life_follows_jax(dtype, iters):
    jd, td = both(_cells(dtype, 6), **ROWS)
    jr, tr = jstencil.life(jd, iters), tdat.life(td, iters)
    same_layout(jr, tr)
    assert_typed_equal(tr, jr)
    assert_typed_equal(tdat.life_step(td), jstencil.life_step(jd))


@pytest.mark.parametrize("dist", [(4, 1), (2, 2)])
@pytest.mark.parametrize("dtype", UNSIGNED)
def test_c32_unsigned_life2d_follows_jax(dtype, dist):
    jd, td = both(_cells(dtype, 7), procs=[0, 1, 2, 3], dist=dist)
    jr, tr = jstencil.life2d(jd, 2), tdat.life2d(td, 2)
    same_layout(jr, tr)
    assert_typed_equal(tr, jr)


# ---------------------------------------------------------------------------
# C33: dnnz, dcount and dmap on uint16 and uint32
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", UNSIGNED)
def test_c33_unsigned_dnnz_follows_jax(dtype):
    # C33: torch has no uint16/uint32 count_nonzero ("nonzero_count_cpu"
    # not implemented); the port counts the widened chunk
    a = _cells(dtype, 8)
    jd, td = both(a, **ROWS)
    got = tdat.dnnz(td)
    assert got == int(dat.dnnz(jd)) == int(np.count_nonzero(a))


@pytest.mark.parametrize("dtype", UNSIGNED)
def test_c33_unsigned_dcount_follows_jax(dtype):
    # C33: ``x > 1`` raised ("gt_cpu" not implemented); the type's
    # largest value plus 2 wraps to 1
    a = _cells(dtype, 9)
    jd, td = both(a, **ROWS)
    assert_typed_equal(tdat.dcount(lambda x: x > 1, td),
                       dat.dcount(lambda x: x > 1, jd))
    got = tdat.dcount(lambda x: x + 2 == 1, td, dims=0)
    assert_typed_equal(got, dat.dcount(lambda x: x + 2 == 1, jd, dims=0))
    assert got.full().sum() == (a == np.iinfo(dtype).max).sum() > 0


# the function in each package, and the result type JAX gives it; the
# sums before a cast wrap in the input type first, as JAX's do
DMAP_CASES = {
    "add": (lambda x: x + x, lambda x: x + x, "same"),
    "gt": (lambda x: x > 1, lambda x: x > 1, "bool"),
    "int32": (lambda x: (x + x).to(torch.int32) - 7,
              lambda x: (x + x).astype(jnp.int32) - 7, "int32"),
    "half": (lambda x: (x + 1) * 0.5, lambda x: (x + 1) * 0.5, "float32"),
}


@pytest.mark.parametrize("case", sorted(DMAP_CASES))
@pytest.mark.parametrize("dtype", UNSIGNED)
def test_c33_unsigned_dmap_result_types_follow_jax(dtype, case):
    # C33: dmap handed torch the unsigned chunk, on which ``x + x`` and
    # ``x > 1`` raise; each op now runs on it widened, and its result takes
    # the type the op gives the unwidened chunk: uint16 for ``x + x``
    # (wrapped), bool for ``x > 1``, int32 for an explicit cast, float32
    # for ``x * 0.5``
    tf, jf, kind = DMAP_CASES[case]
    jd, td = both(_grid(dtype, 10), **ROWS)
    tr, jr = tdat.dmap(tf, td), dat.dmap(jf, jd)
    assert str(tr.dtype).removeprefix("torch.") == \
        (dtype if kind == "same" else kind)
    same_layout(jr, tr)
    assert_typed_equal(tr, jr)
