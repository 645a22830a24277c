"""The block GEMM (plain version of the CUDA kernel) and the distributed
``matmul`` of the PyTorch port against the JAX package.

float32 agrees to rtol 1e-5 (summation order); bf16 operands are compared
in float32 at rtol 1e-2 (each package rounds its bf16 output once).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import distributedarrays_tpu as dat
import distributedarrays_tpu_torch as tdat
from distributedarrays_tpu.ops.pallas_gemm import pallas_matmul
from distributedarrays_tpu_torch.ops.cuda_gemm import cuda_matmul

from _torch_port import port_ranks, same_layout  # noqa: F401


def _pair(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32))


def _jax_gelu(x):
    return jax.nn.gelu(x)              # tanh approximation by default


def _torch_gelu(x):
    return F.gelu(x, approximate="tanh")


@pytest.mark.parametrize("shape", [(64, 128, 96), (128, 256, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("epilogue", [False, True])
def test_kernel_plain_version_matches_pallas(shape, dtype, epilogue):
    a, b = _pair(*shape)
    ja, jb = jnp.asarray(a, dtype), jnp.asarray(b, dtype)
    tdt = getattr(torch, dtype)
    ta, tb = torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt)
    jr = pallas_matmul(ja, jb, epilogue=_jax_gelu if epilogue else None,
                       interpret=True)
    tr = cuda_matmul(ta, tb, epilogue=_torch_gelu if epilogue else None)
    assert tr.dtype == tdt
    rtol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(tr.float().numpy(),
                               np.asarray(jr.astype(jnp.float32)),
                               rtol=rtol, atol=rtol)


def test_kernel_plain_version_matches_pallas_at_a_tma_shape():
    # K and N multiples of 8 but not of 64: the wgmma + TMA route's shapes
    # whose boxes run past the edge (zero-filled on the card)
    a, b = _pair(48, 200, 104, 2)
    jr = pallas_matmul(jnp.asarray(a, jnp.bfloat16),
                       jnp.asarray(b, jnp.bfloat16), interpret=True)
    ta, tb = (torch.from_numpy(x).bfloat16() for x in (a, b))
    assert tdat.cuda_gemm.gemm_route(ta.dtype, 104, 200, 0, 0) == "wgmma"
    tr = cuda_matmul(ta, tb)
    assert tr.dtype == torch.bfloat16
    np.testing.assert_allclose(tr.float().numpy(),
                               np.asarray(jr.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [4096, 776, 777])
@pytest.mark.parametrize("n", [4096, 1496, 1500])
@pytest.mark.parametrize("a_off,b_off", [(0, 0), (2, 0), (0, 8)])
def test_gemm_route_choice(dtype, k, n, a_off, b_off):
    # wgmma needs TMA's 16-byte row strides (K, N multiples of 8 in bf16)
    # and 16-byte aligned bases; other bf16 operands take mma.sync
    dt = getattr(torch, dtype)
    base = 1 << 20
    route = tdat.cuda_gemm.gemm_route(dt, n, k, base + a_off, base + b_off)
    if dt == torch.float32:
        want = "f32"
    elif k % 8 or n % 8 or a_off or b_off:
        want = "mma"
    else:
        want = "wgmma"
    assert route == want
    assert route in tdat.kbuild.ROUTES


def test_gemm_route_refuses_other_dtypes():
    with pytest.raises(TypeError):
        tdat.cuda_gemm.gemm_route(torch.float16, 8, 8, 0, 0)


def test_kernel_plain_version_mixed_and_ragged():
    a, b = _pair(37, 50, 23, 1)
    ta = torch.from_numpy(a).bfloat16()
    tr = cuda_matmul(ta, torch.from_numpy(b))
    assert tr.dtype == torch.float32
    ref = np.asarray(jnp.matmul(jnp.asarray(a, jnp.bfloat16),
                                jnp.asarray(b)))
    np.testing.assert_allclose(tr.numpy(), ref, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        cuda_matmul(ta, torch.from_numpy(b).T)
    with pytest.raises(TypeError):
        cuda_matmul(torch.ones(2, 2, dtype=torch.int32),
                    torch.ones(2, 2, dtype=torch.int32))
    assert tdat.kbuild.launch_counts()["gemm"] == 0


LAYOUTS = [((1, 1), (1, 1)), ((2, 2), (2, 2)), ((4, 1), (4, 1)),
           ((4, 2), (2, 4)), ((8, 1), None)]


@pytest.mark.parametrize("adist,bdist", LAYOUTS)
def test_matmul_layouts(adist, bdist):
    a, b = _pair(24, 16, 20, 2)
    ja, jb = dat.distribute(a, dist=adist), dat.distribute(b, dist=bdist)
    ta, tb = tdat.distribute(a, dist=adist), tdat.distribute(b, dist=bdist)
    jr, tr = ja @ jb, ta @ tb
    same_layout(jr, tr)
    np.testing.assert_allclose(np.asarray(tr), np.asarray(jr), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dist", [(1, 1), (2, 2), (4, 1)])
def test_mul_into_alpha_beta(dist):
    a, b = _pair(24, 16, 20, 3)
    c = np.random.default_rng(4).standard_normal((24, 20)).astype(np.float32)
    jc = dat.distribute(c, dist=dist)
    tc = tdat.distribute(c, dist=dist)
    ja, jb = dat.distribute(a, dist=dist), dat.distribute(b, dist=dist)
    ta, tb = tdat.distribute(a, dist=dist), tdat.distribute(b, dist=dist)
    dat.mul_into(jc, ja, jb, alpha=0.5, beta=-2.0)
    r = tdat.mul_into(tc, ta, tb, alpha=0.5, beta=-2.0)
    assert r is tc
    np.testing.assert_allclose(np.asarray(tc), np.asarray(jc), rtol=1e-5,
                               atol=1e-5)
    jr = dat.matmul(ja, jb, alpha=3.0)
    tr = tdat.matmul(ta, tb, alpha=3.0)
    same_layout(jr, tr)
    np.testing.assert_allclose(np.asarray(tr), np.asarray(jr), rtol=1e-5,
                               atol=1e-5)


def test_matmul_contract_errors_and_matvec():
    a, b = _pair(24, 16, 20, 5)
    ta, tb = tdat.distribute(a, dist=(4, 1)), tdat.distribute(b)
    with pytest.raises(ValueError, match="row cuts"):
        tdat.mul_into(tdat.dzeros((24, 20), dist=(2, 1)), ta, tb)
    with pytest.raises(ValueError, match="beta"):
        tdat.matmul(ta, tb, beta=1.0)
    with pytest.raises(ValueError, match="mismatch"):
        tdat.matmul(ta, ta)
    v = np.arange(16, dtype=np.float32)
    jr = dat.matmul(dat.distribute(a, dist=(4, 1)), v)
    tr = tdat.matmul(ta, v)
    same_layout(jr, tr)
    np.testing.assert_allclose(np.asarray(tr), np.asarray(jr), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(a @ tdat.distribute(b)), a @ b,
                               rtol=1e-5, atol=1e-5)


def test_registry_routes_single_rank_gemm_to_kernel():
    a, b = _pair(32, 24, 16, 6)
    ta = tdat.distribute(a, procs=[0], dist=(1, 1))
    tb = tdat.distribute(b, procs=[0], dist=(1, 1))
    default = np.asarray(ta @ tb)
    assert tdat.linalg._impl_choice(32, 16, 24, torch.float32,
                                    torch.float32) == "torch"
    winner, times = tdat.tune_matmul_impl(
        32, 16, 24, timer=lambda op, x, y: 0.0 if op is cuda_matmul else 1.0)
    assert winner == "pallas" and times == {"torch": 1.0, "pallas": 0.0}
    assert tdat.linalg._impl_choice(32, 16, 24, torch.float32,
                                    torch.float32) == "pallas"
    routed = np.asarray(ta @ tb)
    np.testing.assert_allclose(routed, default, rtol=1e-5, atol=1e-5)
    jr = dat.distribute(a, procs=[0], dist=(1, 1)) @ \
        dat.distribute(b, procs=[0], dist=(1, 1))
    np.testing.assert_allclose(routed, np.asarray(jr), rtol=1e-5, atol=1e-5)
    # CPU tensors take the plain version: the kernel never launched
    assert tdat.kbuild.launch_counts()["gemm"] == 0


@pytest.mark.parametrize("dims,dist", [((24, 16), (4, 2)), ((13, 7), None),
                                       ((8, 8), (1, 8))])
def test_dtranspose(dims, dist):
    x = np.random.default_rng(7).standard_normal(dims).astype(np.float32)
    jt = dat.distribute(x, dist=dist).T
    tt = tdat.distribute(x, dist=dist).T
    same_layout(jt, tt)
    np.testing.assert_array_equal(np.asarray(tt), np.asarray(jt))
