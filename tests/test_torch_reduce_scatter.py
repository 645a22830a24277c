"""The reduce-scatter of the PyTorch port (``ring_reduce_scatter``, K12's
plain version on the CPU, and the rank-list ``psum_scatter``) against the
JAX package's Pallas ring kernel ``ring_reduce_scatter``, run in interpret
mode under ``run_spmd`` as ``tests/test_pallas_collectives.py`` runs it.

The port sums in the TPU ring's arrival order (the partial for rank d
seeds at rank d+1 and every hop adds its own piece, rounded to the type),
so it must equal the JAX kernel bit for bit, on random f32 values and in
bf16 alike.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

import distributedarrays_tpu_torch as tdat
from distributedarrays_tpu.ops import pallas_collectives as PC
from distributedarrays_tpu.parallel.collectives import run_spmd, spmd_mesh
from distributedarrays_tpu_torch.ops import cuda_collectives as C

from _torch_port import port_ranks  # noqa: F401


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jax_rs(x, p, dim, dtype=jnp.float32):
    spec = P("p", *([None] * (x.ndim - 1)))
    y = run_spmd(lambda a: PC.ring_reduce_scatter(a, "p", dim=dim,
                                                  interpret=True),
                 spmd_mesh(p), (spec,), spec)(jnp.asarray(x, dtype))
    return np.asarray(y.astype(jnp.float32))


def _blocks(x, p, dtype=torch.float32):
    return [torch.from_numpy(np.ascontiguousarray(c)).to(dtype)
            for c in np.split(x, p, axis=0)]


def _per_rank(jy, p):
    rows = jy.shape[0] // p
    return [jy[q * rows:(q + 1) * rows] for q in range(p)]


@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("dim", [0, 1])
def test_reduce_scatter_matches_pallas_ring_f32(p, dim):
    x = _x((p * p * 2, p * 6), 100 + p + dim)
    want = _per_rank(_jax_rs(x, p, dim), p)
    outs = C.ring_reduce_scatter(_blocks(x, p), dim)
    assert len(outs) == p
    for o, w in zip(outs, want):
        assert o.dtype == torch.float32 and o.is_contiguous()
        np.testing.assert_array_equal(o.numpy(), w)


@pytest.mark.parametrize("p", [2, 4, 8])
def test_reduce_scatter_matches_pallas_ring_bf16(p):
    x = _x((p * p, 3, 8), 200 + p)
    want = _per_rank(_jax_rs(x, p, 0, jnp.bfloat16), p)
    outs = C.ring_reduce_scatter(_blocks(x, p, torch.bfloat16), 0)
    for o, w in zip(outs, want):
        assert o.dtype == torch.bfloat16
        np.testing.assert_array_equal(o.float().numpy(), w)


def test_reduce_scatter_3d_dim1_bf16_matches_pallas_ring():
    p = 4
    x = _x((p * 2, p * 3, 8), 300)
    want = _per_rank(_jax_rs(x, p, 1, jnp.bfloat16), p)
    outs = C.ring_reduce_scatter(_blocks(x, p, torch.bfloat16), 1)
    for o, w in zip(outs, want):
        assert o.shape == (2, 3, 8)
        np.testing.assert_array_equal(o.float().numpy(), w)


def test_psum_scatter_is_the_plain_version_and_sums_like_lax():
    # integer-valued data: every summation order is exact, so the ring
    # order must equal XLA's psum_scatter too
    p = 4
    x = np.random.default_rng(7).integers(-8, 8, (p * 8, 5)).astype(
        np.float32)
    want = _per_rank(np.asarray(run_spmd(
        lambda a: lax.psum_scatter(a, "p", scatter_dimension=0, tiled=True),
        spmd_mesh(p), (P("p", None),), P("p", None))(x)), p)
    a = tdat.psum_scatter(_blocks(x, p), 0)
    b = C.reduce_scatter_plain(_blocks(x, p), 0)
    for u, v, w in zip(a, b, want):
        assert torch.equal(u, v)
        np.testing.assert_array_equal(u.numpy(), w)


def test_reduce_scatter_one_rank_copies():
    t = torch.arange(6.0)
    (o,) = C.ring_reduce_scatter([t], 0)
    assert torch.equal(o, t) and o.data_ptr() != t.data_ptr()


def test_reduce_scatter_validation():
    a = torch.zeros(8, 4)
    with pytest.raises(ValueError, match="divisible"):
        C.ring_reduce_scatter([a, a, a], 0)
    with pytest.raises(ValueError, match="agree"):
        C.ring_reduce_scatter([a, torch.zeros(8, 2)], 0)
    meta = torch.zeros(8, 4, device="meta")
    with pytest.raises(ValueError, match="CUDA devices or all on the CPU"):
        C.ring_reduce_scatter([a, meta], 0)
    assert C.ring_reduce_scatter([], 0) == []
    assert tdat.kbuild.launch_counts()["reduce_scatter"] == 0
