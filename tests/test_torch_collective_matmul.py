"""The owned distributed-GEMM schedules of the PyTorch port (the plain
versions of the ring GEMM kernels K13, K14 and K15, the differentiable
``tp_ffn``, Cannon, SUMMA and Cannon with int8 panels) against the JAX
package's ``collective_matmul``.

The JAX rings run their fused Pallas RDMA kernels in interpret mode.
Integer-valued f32 operands make every product and sum exact, so K13's and
K15's plain versions must equal the Pallas kernels bit for bit there, as
``tests/test_pallas_collectives.py`` holds the JAX kernels; random f32
operands agree to rtol 1e-5 (the order inside one product).  ``tp_ffn``
and its gradients agree with ``jax.grad`` through the ``lax`` rings to
rtol 1e-4 / atol 1e-5 (the transposed rings sum in another order).  Both
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
from distributedarrays_tpu.parallel import collectives as JC
from distributedarrays_tpu.parallel.collectives import (run_spmd,
                                                        shard_map_compat,
                                                        spmd_mesh)
from distributedarrays_tpu_torch.ops import collective_matmul as CM
from distributedarrays_tpu_torch.ops import cuda_collectives as C
from distributedarrays_tpu_torch.parallel import collectives as TC

from _torch_port import port_ranks  # noqa: F401


def _gauss(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _rows(x, p):
    return [torch.from_numpy(np.ascontiguousarray(c))
            for c in np.split(x, p, axis=0)]


def _cols(x, p):
    return [torch.from_numpy(np.ascontiguousarray(c))
            for c in np.split(x, p, axis=1)]


def _data(shape, seed, integer):
    """Gaussian f32, or small integers held exactly in f32."""
    if integer:
        return np.random.default_rng(seed).integers(
            -4, 5, shape).astype(np.float32)
    return _gauss(shape, seed)


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
    # the port's skew (row i of A by -i, column j of B by -j) moves every
    # block as JAX's (source, destination) permutations do
    blocks = [torch.tensor([float(x)]) for x in range(g * g)]
    skew = [-i for i in range(g)]
    a, b = CM._rotate([(blocks, 1, skew), (blocks, 0, skew)], g)
    perm_a, perm_b = JCM._cannon_skew_perms(g)
    assert sorted(d for _, d in perm_a) == list(range(g * g))
    assert all(int(a[d]) == s for s, d in perm_a)
    assert all(int(b[d]) == s for s, d in perm_b)


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
    blocks = [torch.tensor([float(x)]) for x in range(9)]     # (3, 3) grid
    left, up = CM._rotate([(blocks, 1, [-1] * 3), (blocks, 0, [-1] * 3)], 3)
    assert [int(t) for t in left] == [1, 2, 0, 4, 5, 3, 7, 8, 6]
    assert [int(t) for t in up] == [3, 4, 5, 6, 7, 8, 0, 1, 2]
    # a shift a line, in pshift's sense
    (rows,) = CM._rotate([(blocks, 1, [0, 1, -2])], 3)
    assert [int(t) for t in rows] == [0, 1, 2, 5, 3, 4, 8, 6, 7]


# ---------------------------------------------------------------------------
# K13 and K15: the ring all-gather GEMM and the GEMM + reduce-scatter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("p", [2, 4, 8])
def test_ring_allgather_matmul_matches_pallas_ring(p, integer):
    x = _data((p * 8, 24), p, integer)
    w = _data((24, p * 8), 50 + p, integer)
    jy = np.asarray(run_spmd(lambda xx, ww: JCM.allgather_matmul(
        xx, ww, "p", rdma=True, interpret=True), spmd_mesh(p),
        (P("p", None), P(None, "p")), P(None, "p"))(x, w))
    outs = C.ring_allgather_matmul(_rows(x, p), _cols(w, p))
    assert all(o.shape == (p * 8, 8) for o in outs)
    got = np.concatenate([o.numpy() for o in outs], axis=1)
    if integer:
        np.testing.assert_array_equal(got, jy)
    else:
        np.testing.assert_allclose(got, jy, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, x @ w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("p", [2, 4, 8])
def test_ring_matmul_reducescatter_matches_pallas_ring(p, integer):
    x = _data((p * 4, p * 8), 10 + p, integer)
    w = _data((p * 8, 16), 60 + p, integer)
    jy = np.asarray(run_spmd(lambda xx, ww: JCM.matmul_reducescatter(
        xx, ww, "p", rdma=True, interpret=True), spmd_mesh(p),
        (P(None, "p"), P("p", None)), P("p", None))(x, w))
    outs = C.ring_matmul_reducescatter(_cols(x, p), _rows(w, p))
    assert all(o.shape == (4, 16) for o in outs)
    got = np.concatenate([o.numpy() for o in outs])
    if integer:
        np.testing.assert_array_equal(got, jy)
    else:
        np.testing.assert_allclose(got, jy, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, x @ w, rtol=1e-4, atol=1e-4)


def test_ring_gemms_bf16_round_per_step_and_one_rank():
    # K15 in bf16: each block product is cast to bf16 and each add rounds
    # to bf16, as the lax ring; K13 casts each block once
    p = 4
    x = _gauss((p * 4, p * 8), 3)
    w = _gauss((p * 8, 16), 4)
    xs, ws = [c.bfloat16() for c in _cols(x, p)], [c.bfloat16()
                                                  for c in _rows(w, p)]
    outs = C.ring_matmul_reducescatter(xs, ws)
    assert outs[0].dtype == torch.bfloat16
    for d in range(p):
        acc = None
        for r in [(d + k) % p for k in range(1, p + 1)]:
            blk = (xs[r][d * 4:(d + 1) * 4].float() @ ws[r].float()
                   ).bfloat16()
            acc = blk if acc is None else acc + blk
        assert torch.equal(outs[d], acc)
    ag = C.ring_allgather_matmul(_rows(x[:, :8], p)[:1] * 1,
                                 [torch.from_numpy(w[:8])])
    np.testing.assert_allclose(ag[0].numpy(), x[:4, :8] @ w[:8], rtol=1e-5,
                               atol=1e-5)
    one = C.ring_matmul_reducescatter([torch.from_numpy(x)],
                                      [torch.from_numpy(w)])
    np.testing.assert_allclose(one[0].numpy(), x @ w, rtol=1e-5, atol=1e-5)


def test_ring_gemm_validation():
    x, w = _gauss((12, 8), 5), _gauss((8, 6), 6)
    with pytest.raises(ValueError, match="rows 12 must be divisible"):
        C.ring_matmul_reducescatter(_cols(x, 8)[:8], _rows(w, 8))
    with pytest.raises(ValueError, match="do not contract"):
        C.ring_allgather_matmul(_rows(x, 2), [torch.zeros(5, 3)] * 2)
    with pytest.raises(ValueError, match="one each per rank"):
        C.ring_allgather_matmul(_rows(x, 2), [torch.zeros(8, 3)])
    meta = [torch.zeros(4, 8, device="meta")] * 2
    with pytest.raises(ValueError, match="CUDA devices"):
        C.ring_matmul_reducescatter(meta, [torch.zeros(8, 3,
                                                       device="meta")] * 2)
    with pytest.raises(ValueError, match="divisible"):
        CM.matmul_reducescatter(_cols(x, 8)[:8], _rows(w, 8))


def test_allgather_matmul_promotes_mixed_dtypes():
    x, w = _gauss((8, 8), 7), _gauss((8, 4), 8)
    outs = CM.allgather_matmul([t.bfloat16() for t in _rows(x, 2)],
                               _cols(w, 2))
    assert outs[0].dtype == torch.float32 and outs[0].shape == (8, 2)
    outs = CM.matmul_reducescatter([t.bfloat16() for t in _cols(x, 2)],
                                   _rows(w, 2))
    assert outs[0].dtype == torch.float32 and outs[0].shape == (4, 4)


@pytest.mark.parametrize("p", [2, 4])
def test_tp_ffn_and_gradients_match_jax(p):
    S, E, Fw = 8 * p, 16, 8 * p
    x, w1, w2 = _gauss((S, E), 20 + p), _gauss((E, Fw), 21), _gauss((Fw, E), 22)
    g = _gauss((S, E), 23)
    f = run_spmd(lambda xs, a, b: JCM.tp_ffn(xs, a, b, "p"), spmd_mesh(p),
                 (P("p", None), P(None, "p"), P("p", None)), P("p", None))
    jy, vjp = jax.vjp(f, x, w1, w2)
    jgx, jg1, jg2 = vjp(jnp.asarray(g))
    xs = [t.requires_grad_() for t in _rows(x, p)]
    w1s = [t.requires_grad_() for t in _cols(w1, p)]
    w2s = [t.requires_grad_() for t in _rows(w2, p)]
    ys = CM.tp_ffn(xs, w1s, w2s)
    torch.autograd.backward(ys, _rows(g, p))
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(torch.cat(ys).detach().numpy(), jy, **tol)
    np.testing.assert_allclose(torch.cat([t.grad for t in xs]).numpy(), jgx,
                               **tol)
    np.testing.assert_allclose(
        torch.cat([t.grad for t in w1s], 1).numpy(), jg1, **tol)
    np.testing.assert_allclose(torch.cat([t.grad for t in w2s]).numpy(),
                               jg2, **tol)


def test_tp_ffn_custom_activation_and_weight_only_grads():
    p = 2
    x, w1, w2 = _gauss((8, 4), 30), _gauss((4, 8), 31), _gauss((8, 4), 32)
    w1s = [t.requires_grad_() for t in _cols(w1, p)]
    ys = CM.tp_ffn(_rows(x, p), w1s, _rows(w2, p), act=torch.relu)
    want = np.maximum(x @ w1, 0) @ w2
    np.testing.assert_allclose(torch.cat(ys).detach().numpy(), want,
                               rtol=1e-5, atol=1e-5)
    sum(y.sum() for y in ys).backward()
    dw1 = x.T @ ((x @ w1 > 0) * (np.ones((8, 4), np.float32) @ w2.T))
    np.testing.assert_allclose(torch.cat([t.grad for t in w1s], 1).numpy(),
                               dw1, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("op", ["sum", "max", "min", "mean"])
def test_preduce_matches_jax(op):
    p = 4
    x = _gauss((p * 6,), 40)
    jy = np.asarray(run_spmd(lambda a: JC.preduce(a, "p", op), spmd_mesh(p),
                             P("p"), P("p"))(x))
    outs = TC.preduce(_rows(x, p), op)
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o.numpy(), jy[r * 6:(r + 1) * 6],
                                   rtol=1e-6, atol=1e-6)
        assert torch.equal(o, outs[0])
    assert len({id(o) for o in outs}) == p      # a copy for every rank
    with pytest.raises(ValueError, match="unknown reduction"):
        TC.preduce(_rows(x, p), "prod")
