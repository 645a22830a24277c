"""The int8 GEMM of the PyTorch port (plain version of the CUDA kernel K4,
``quantize_rows``, ``quantized_matmul``, ``dmatmul_int8``) against the JAX
package.

Codes and scales of ``quantize_rows`` must equal the JAX ones exactly: both
divide in IEEE float32 and round half to even.  The plain int8 product must
equal ``pallas_matmul_int8`` in interpret mode to rtol 1e-6 (both are an
exact integer sum followed by the same two f32 multiplies, so they are
expected to agree bit for bit).  DArray results are compared with the JAX
package's at rtol 1e-6 where both quantize the same slices, and with the
float product at the JAX tests' quantization bound (max error / max |ref|
< 3e-2) where they cannot (host operands on 8 ranks).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributedarrays_tpu as dat
import distributedarrays_tpu_torch as tdat
from distributedarrays_tpu.ops import pallas_gemm as PG
from distributedarrays_tpu_torch.ops import cuda_gemm as G

from _torch_port import port_ranks, same_layout  # noqa: F401


def _gauss(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("kind", ["gauss", "halves", "zero_rows"])
def test_quantize_rows_matches_jax_exactly(axis, kind):
    x = _gauss((24, 40), 1)
    if kind == "halves":
        # values on .5 code boundaries: the round-half-to-even cases
        amax = 127.0
        x = (np.random.default_rng(2).integers(-254, 255, (24, 40)) / 2.0
             ).astype(np.float32)
        x[:, 0] = amax
        x[0, :] = amax
    elif kind == "zero_rows":
        x[3] = 0.0
        x[:, 5] = 0.0
    jq, js = PG.quantize_rows(jnp.asarray(x), axis)
    tq, ts = G.quantize_rows(torch.from_numpy(x), axis)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert np.isfinite(ts.numpy()).all()


@pytest.mark.parametrize("shape", [(64, 128, 128), (128, 256, 256)])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_int8_plain_matches_pallas_interpret(shape, out_dtype):
    m, k, n = shape
    rng = np.random.default_rng(3)
    qa = rng.integers(-127, 128, (m, k)).astype(np.int8)
    qb = rng.integers(-127, 128, (k, n)).astype(np.int8)
    sa = rng.uniform(0.001, 0.1, m).astype(np.float32)
    sb = rng.uniform(0.001, 0.1, n).astype(np.float32)
    jr = PG.pallas_matmul_int8(qa, qb, sa, sb, out_dtype=getattr(
        jnp, out_dtype), interpret=True)
    tr = G.cuda_matmul_int8(*(torch.from_numpy(v) for v in (qa, qb, sa, sb)),
                            out_dtype=getattr(torch, out_dtype))
    assert tr.dtype == getattr(torch, out_dtype)
    np.testing.assert_allclose(tr.float().numpy(),
                               np.asarray(jr.astype(jnp.float32)), rtol=1e-6,
                               atol=0)


def test_quantized_matmul_matches_jax_and_float_product():
    a, b = _gauss((64, 128), 4), _gauss((128, 64), 5)
    jr = np.asarray(PG.quantized_matmul(a, b, interpret=True))
    tr = G.quantized_matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(tr, jr, rtol=1e-6, atol=1e-6)
    ref = a @ b
    assert np.abs(tr - ref).max() / np.abs(ref).max() < 3e-2


def test_int8_wrapper_validation_and_overflow_warning():
    q = torch.zeros((4, 4), dtype=torch.int8)
    s = torch.ones(4)
    with pytest.raises(ValueError, match="int8"):
        G.cuda_matmul_int8(q.float(), q, s, s)
    with pytest.raises(ValueError, match="mismatch"):
        G.cuda_matmul_int8(q, torch.zeros((5, 4), dtype=torch.int8), s, s)
    with pytest.raises(ValueError, match="scales"):
        G.cuda_matmul_int8(q, q, torch.ones(3), s)
    k = G.SAFE_K + 1
    with pytest.warns(RuntimeWarning, match=f"K={k}"):
        r = G.cuda_matmul_int8(torch.zeros((1, k), dtype=torch.int8),
                               torch.zeros((k, 1), dtype=torch.int8),
                               torch.ones(1), torch.ones(1))
    assert float(r) == 0.0
    # the CPU tensors took the plain version
    assert tdat.kbuild.launch_counts()["matmul_int8"] == 0


def _codes(shape, offset=0):
    """Contiguous int8 codes whose base lies ``offset`` bytes past a
    16-byte aligned buffer's start."""
    n = int(np.prod(shape))
    buf = torch.zeros(n + offset, dtype=torch.int8)
    assert buf.data_ptr() % 16 == 0
    return buf[offset:].view(shape)


@pytest.mark.parametrize("m,k,n,want", [
    (16384, 16384, 16384, "wgmma"),      # the one-rank distributed product
    (4096, 16384, 16384, "wgmma"),       # a (4,1) row block
    (1000, 784, 1500, "wgmma"),          # ragged m, n; k ragged to 128
    (100, 48, 40, "wgmma"),              # smaller than one tile
    (7, 16, 3, "wgmma"),
    (1000, 777, 1500, "mma"),            # k no multiple of 16
    (64, 8, 64, "mma"),
    (64, 24, 64, "mma")])
def test_int8_route_on_contiguous_codes(m, k, n, want):
    # only the strides and bases decide: meta tensors carry no data
    qa = torch.empty((m, k), dtype=torch.int8, device="meta")
    qb = torch.empty((k, n), dtype=torch.int8, device="meta")
    if m * k <= 1 << 22:
        qa, qb = _codes((m, k)), _codes((k, n))
    assert G.int8_gemm_route(qa, qb) == want


@pytest.mark.parametrize("a_off,b_off,want", [(0, 0, "wgmma"),
                                              (16, 0, "wgmma"),
                                              (0, 1, "wgmma"),
                                              (0, 3, "wgmma"),
                                              (1, 0, "mma"),
                                              (8, 0, "mma"),
                                              (4, 4, "mma")])
def test_int8_route_on_misaligned_bases(a_off, b_off, want):
    # TMA reads qa and the kernel's own K-major copy of qb; qb itself is
    # read by the transpose kernel, which takes any base
    qa, qb = _codes((64, 32), a_off), _codes((32, 48), b_off)
    assert qa.data_ptr() % 16 == a_off % 16
    assert G.int8_gemm_route(qa, qb) == want


def test_int8_route_counts_and_cpu_calls():
    kb = tdat.kbuild
    kb.reset_launches()
    assert kb.route_counts()["matmul_int8"] == dict.fromkeys(
        kb.INT8_ROUTES, 0)
    assert set(kb.INT8_ROUTES) == {"wgmma", "mma"}
    # the route codes the C entry takes are those of ROUTES
    assert [kb.ROUTES.index(r) for r in kb.INT8_ROUTES] == [1, 2]
    qa, qb = _codes((16, 32)), _codes((32, 8))
    qa.copy_(torch.arange(16 * 32).remainder(255).sub(127).view(16, 32))
    qb.copy_(torch.arange(32 * 8).remainder(253).sub(126).view(32, 8))
    r = G.cuda_matmul_int8(qa, qb, torch.ones(16), torch.ones(8))
    assert torch.equal(r, (qa.int() @ qb.int()).float())
    assert kb.launch_counts()["matmul_int8"] == 0
    assert kb.route_counts()["matmul_int8"] == dict.fromkeys(
        kb.INT8_ROUTES, 0)
    kb.count("matmul_int8", "wgmma")
    assert kb.route_counts()["matmul_int8"]["wgmma"] == 1
    assert kb.launch_counts()["matmul_int8"] == 1
    kb.reset_launches()
    assert kb.route_counts()["matmul_int8"]["wgmma"] == 0


def test_plain_int8_is_exact_at_saturation():
    # saturated codes at the largest safe K: the int32 sum is exact
    k = 4096
    qa = torch.full((2, k), 127, dtype=torch.int8)
    qb = torch.full((k, 3), -127, dtype=torch.int8)
    r = G.matmul_int8_plain(qa, qb, torch.ones(2), torch.ones(3))
    assert torch.equal(r, torch.full((2, 3), float(-127 * 127 * k)))


def _state(d):
    return {"array": np.asarray(d), "cuts": d.cuts, "pids": d.pids}


@pytest.mark.parametrize("layout", ["one", "rows", "square"])
def test_dmatmul_int8_layouts_match_jax(layout):
    a, b = _gauss((128, 64), 6), _gauss((64, 96), 7)
    if layout == "one":
        ja = dat.distribute(a, procs=[0], dist=(1, 1))
        jb = b
    elif layout == "rows":
        ja = dat.distribute(a, procs=range(4), dist=(4, 1))
        jb = dat.distribute(b)
    else:
        ja = dat.distribute(a, procs=range(4), dist=(2, 2))
        jb = dat.distribute(b, procs=range(4), dist=(2, 2))
    jr = dat.dmatmul_int8(ja, jb)
    ta = tdat.from_reference(_state(ja))
    tb = tdat.from_reference(_state(jb)) if layout != "one" else b
    tr = tdat.dmatmul_int8(ta, tb)
    same_layout(jr, tr)
    assert tr.dtype == torch.float32
    np.testing.assert_allclose(np.asarray(tr), np.asarray(jr), rtol=1e-6,
                               atol=1e-5)
    ref = a @ b
    assert np.abs(np.asarray(tr) - ref).max() / np.abs(ref).max() < 3e-2
    dat.d_closeall()


def test_dmatmul_int8_bf16_out_and_rows_kernel_path():
    a, b = _gauss((64, 32), 8), _gauss((32, 16), 9)
    ta = tdat.distribute(a, procs=range(4), dist=(4, 1))
    tr = tdat.dmatmul_int8(ta, tdat.distribute(b, procs=range(4),
                                               dist=(4, 1)),
                           out_dtype=torch.bfloat16)
    assert tr.dtype == torch.bfloat16 and tr.grid == (4, 1)
    one = tdat.dmatmul_int8(tdat.distribute(a, procs=[0], dist=(1, 1)), b,
                            out_dtype=torch.bfloat16)
    # per-row scales are local, so the row-chunked result is the one-rank one
    np.testing.assert_array_equal(np.asarray(tr), np.asarray(one))


def test_dmatmul_int8_validation():
    rng = np.random.default_rng(10)
    a = rng.standard_normal((50, 64)).astype(np.float32)   # uneven rows
    with pytest.raises(ValueError, match="even"):
        tdat.dmatmul_int8(tdat.distribute(a, procs=range(4), dist=(4, 1)),
                          np.zeros((64, 8), np.float32))
    with pytest.raises(ValueError, match="grid"):
        tdat.dmatmul_int8(
            tdat.distribute(rng.standard_normal((16, 64)).astype(np.float32),
                            procs=range(8), dist=(2, 4)),
            tdat.distribute(rng.standard_normal((64, 32)).astype(np.float32),
                            procs=range(8), dist=(2, 4)))
    with pytest.raises(ValueError, match="mismatch"):
        tdat.dmatmul_int8(tdat.distribute(a, procs=[0], dist=(1, 1)),
                          np.zeros((8, 8), np.float32))
    with pytest.raises(ValueError, match="2-D"):
        tdat.dmatmul_int8(tdat.distribute(a, procs=[0], dist=(1, 1)),
                          np.zeros(64, np.float32))
    with pytest.raises(ValueError, match="even"):
        tdat.dmatmul_int8(
            tdat.distribute(rng.standard_normal((16, 10)).astype(np.float32),
                            procs=range(4), dist=(4, 1)),
            tdat.distribute(rng.standard_normal((10, 8)).astype(np.float32),
                            procs=range(4), dist=(4, 1)))


def test_dmatmul_int8_host_array_lhs():
    rng = np.random.default_rng(11)
    a = rng.standard_normal((128, 64)).astype(np.float32)   # 128 % 8 == 0
    b = rng.standard_normal((64, 96)).astype(np.float32)
    tr = tdat.dmatmul_int8(a, b)
    assert tr.grid == (8, 1)
    np.testing.assert_allclose(np.asarray(tr), np.asarray(dat.dmatmul_int8(
        a, b)), rtol=1e-6, atol=1e-5)
    a2 = rng.standard_normal((51, 64)).astype(np.float32)   # indivisible
    tr2 = tdat.dmatmul_int8(a2, b)
    assert tr2.grid == (1, 1)
    ref = a2 @ b
    assert np.abs(np.asarray(tr2) - ref).max() / np.abs(ref).max() < 3e-2
    dat.d_closeall()
