"""The owned distributed-GEMM schedules of the PyTorch port (the plain
version of the ring all-gather GEMM kernel K14, Cannon, SUMMA and Cannon
with int8 panels) against the JAX package's ``collective_matmul``.

The JAX ring runs its fused Pallas RDMA kernel in interpret mode.  Both
sides take the same steps in the same order with float32 products, so
they agree to a relative Frobenius error of 1e-6: only the summation order
inside one product differs, which moves single elements near zero by a few
ulps (so no elementwise rtol).  Cannon and SUMMA agree to rtol 1e-5 (XLA's
and torch's CPU GEMMs block the inner sum differently).  Cannon with int8
panels runs the same quantization and exact int32 products on both sides;
the f32 sum over hops can still differ in the last bit where XLA contracts
a multiply and an add into one FMA, hence relative Frobenius error 1e-6.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distributedarrays_tpu import layout as JL
from distributedarrays_tpu.ops import collective_matmul as JCM
from distributedarrays_tpu.parallel.collectives import (run_spmd,
                                                        shard_map_compat,
                                                        spmd_mesh)
from distributedarrays_tpu_torch.ops import collective_matmul as CM
from distributedarrays_tpu_torch.ops import cuda_collectives as C

from _torch_port import port_ranks  # noqa: F401


def _gauss(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _rows(x, p):
    return [torch.from_numpy(np.ascontiguousarray(c))
            for c in np.split(x, p, axis=0)]


def _grid_blocks(x, r, c):
    return [torch.from_numpy(np.ascontiguousarray(b))
            for rows in np.split(x, r, axis=0)
            for b in np.split(rows, c, axis=1)]


def _rel(x, ref):
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


def _assemble(blocks, r, c):
    return np.block([[blocks[i * c + j].float().numpy() for j in range(c)]
                     for i in range(r)])


@pytest.mark.parametrize("p", [2, 4, 8])
def test_ring_allgather_matmul_rhs_matches_pallas_ring(p):
    a = _gauss((p * 8, p * 8), p)
    b = _gauss((p * 8, 16), 100 + p)
    jy = np.asarray(run_spmd(lambda aa, bb: JCM.allgather_matmul_rhs(
        aa, bb, "p", rdma=True, interpret=True), spmd_mesh(p),
        (P("p", None), P("p", None)), P("p", None))(a, b))
    outs = C.ring_allgather_matmul_rhs(_rows(a, p), _rows(b, p))
    assert _rel(np.concatenate([o.numpy() for o in outs]), jy) <= 1e-6


def test_ring_allgather_matmul_rhs_bf16_and_one_rank():
    p = 4
    a = _gauss((p * 8, p * 8), 7)
    b = _gauss((p * 8, 16), 8)
    ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    jy = np.asarray(run_spmd(lambda aa, bb: JCM.allgather_matmul_rhs(
        aa, bb, "p", rdma=True, interpret=True), spmd_mesh(p),
        (P("p", None), P("p", None)), P("p", None))(ja, jb).astype(
            jnp.float32))
    outs = C.ring_allgather_matmul_rhs([x.bfloat16() for x in _rows(a, p)],
                                       [x.bfloat16() for x in _rows(b, p)])
    assert outs[0].dtype == torch.bfloat16
    # both round each step's product to bf16 and add in bf16
    np.testing.assert_allclose(
        np.concatenate([o.float().numpy() for o in outs]), jy, rtol=1e-2,
        atol=1e-2)
    one = C.ring_allgather_matmul_rhs([torch.from_numpy(a[:8])],
                                      [torch.from_numpy(b[:p * 8])])
    np.testing.assert_allclose(one[0].numpy(), a[:8] @ b, rtol=1e-5,
                               atol=1e-5)


def test_ring_allgather_matmul_rhs_promotes_and_validates():
    a = _gauss((16, 8), 9)
    b = _gauss((8, 4), 10)
    outs = CM.allgather_matmul_rhs([x.bfloat16() for x in _rows(a, 2)],
                                   _rows(b, 2))
    assert outs[0].dtype == torch.float32
    with pytest.raises(ValueError, match="ring GEMM shapes"):
        C.ring_allgather_matmul_rhs(_rows(a, 2), _rows(b[:6], 2))


def _jax_grid_program(fn, r, c):
    mesh = JL.mesh_for(list(range(r * c)), (r, c))
    ax_r, ax_c = mesh.axis_names
    spec = P(ax_r, ax_c)
    return jax.jit(shard_map_compat(lambda a, b: fn(a, b, ax_r, ax_c),
                                    mesh=mesh, in_specs=(spec, spec),
                                    out_specs=spec, check=False))


@pytest.mark.parametrize("g", [2, 3, 4])
def test_cannon_skew_perms_match_jax(g):
    assert CM._cannon_skew_perms(g) == JCM._cannon_skew_perms(g)


@pytest.mark.parametrize("dims", [(16, 24, 8), (8, 8, 8)])
def test_cannon_matmul_matches_jax(dims):
    g = 2
    m, k, n = dims
    a, b = _gauss((m, k), 11), _gauss((k, n), 12)
    jy = np.asarray(_jax_grid_program(JCM.cannon_matmul, g, g)(a, b))
    outs = CM.cannon_matmul(_grid_blocks(a, g, g), _grid_blocks(b, g, g), g)
    np.testing.assert_allclose(_assemble(outs, g, g), jy, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_assemble(outs, g, g), a @ b, rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("r,c", [(2, 4), (4, 2)])
def test_summa_matmul_matches_jax(r, c):
    L = math.lcm(r, c)
    m, k, n = 4 * r, 2 * L, 4 * c
    a, b = _gauss((m, k), 13), _gauss((k, n), 14)
    jy = np.asarray(_jax_grid_program(JCM.summa_matmul, r, c)(a, b))
    outs = CM.summa_matmul(_grid_blocks(a, r, c), _grid_blocks(b, r, c), r,
                           c)
    np.testing.assert_allclose(_assemble(outs, r, c), jy, rtol=1e-5,
                               atol=1e-5)


def test_cannon_matmul_int8_matches_jax():
    g = 2
    a, b = _gauss((64, 64), 15), _gauss((64, 64), 16)
    jy = np.asarray(_jax_grid_program(
        lambda x, y, ar, ac: JCM.cannon_matmul_int8(x, y, ar, ac,
                                                    interpret=True),
        g, g)(a, b))
    outs = CM.cannon_matmul_int8(_grid_blocks(a, g, g), _grid_blocks(b, g, g),
                                 g)
    assert _rel(_assemble(outs, g, g), jy) <= 1e-6
    ref = a @ b
    assert np.abs(_assemble(outs, g, g) - ref).max() / np.abs(ref).max() \
        < 3e-2


def test_grid_shift_helper():
    blocks = [torch.tensor([float(x)]) for x in range(6)]     # (2, 3) grid
    left = CM._shift(blocks, 2, 3, axis=1, shift=-1)
    assert [int(t) for t in left] == [1, 2, 0, 4, 5, 3]
    up = CM._shift(blocks, 2, 3, axis=0, shift=-1)
    assert [int(t) for t in up] == [3, 4, 5, 0, 1, 2]
