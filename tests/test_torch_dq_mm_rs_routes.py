"""The routes of the GEMM + reduce-scatter ring K15
(``cuda_collectives.ring_matmul_reducescatter``) and of the backward's dq
pass K6 (``cuda_attention`` through ``flash_attention_route``) in the
PyTorch port, their route counts, and their plain versions against the JAX
package's Pallas kernels.

The routes are chosen on the host from dtypes, shapes and device
addresses, so they are tested here on CPU tensors (whose addresses stand
in for the card's) and on made-up addresses; the kernels behind them run
only on the card (``chip_smoke.py``).  The JAX kernels run in interpret
mode.  K15 in bf16: both sides cast each block's f32 product to bf16 and
add the partials in bf16, in the same ring order, but sum inside a product
in another order, so a few outputs land on the neighbouring bf16 value:
relative Frobenius error <= 5e-4, the card's tolerance for the same
comparison; the f32 product of the same bf16 values, never rounded, must
land above it.  K6 as ``tests/test_torch_attention_bwd.py``: f32 rtol 1e-4
/ atol 1e-5 (summation order only), bf16 relative Frobenius error 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import distributedarrays_tpu_torch as tdat
from distributedarrays_tpu.ops import pallas_attention as PA
from distributedarrays_tpu.ops import pallas_collectives as PC
from distributedarrays_tpu.parallel.collectives import run_spmd, spmd_mesh
from distributedarrays_tpu_torch.ops import cuda_attention as CA
from distributedarrays_tpu_torch.ops import cuda_collectives as C

from _torch_port import port_ranks  # noqa: F401

BF16 = torch.bfloat16
TOL_BF16 = 5e-4
BASE = 1 << 20


def _gauss(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _rel(x, ref):
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


def _at(n, offset, dtype):
    """A 1-D view of ``n`` elements whose base lies ``offset`` bytes past a
    16-byte aligned buffer's start."""
    isz = torch.empty(0, dtype=dtype).element_size()
    buf = torch.zeros(n * isz + 16, dtype=torch.uint8)
    assert buf.data_ptr() % 16 == 0
    return buf[offset:offset + n * isz].view(dtype)


def _mm_rs_operands(p, m_loc, k_loc, n, dtype, x_offset=0):
    """Rank lists as ``ring_matmul_reducescatter`` holds them on the card:
    x blocks (p m_loc, k_loc) (the first ``x_offset`` bytes off 16-byte
    alignment), w blocks (k_loc, n), (2, m_loc, n) receive buffers and
    (m_loc, n) outputs."""
    xs = [_at(p * m_loc * k_loc, x_offset if r == 0 else 0, dtype)
          .view(p * m_loc, k_loc) for r in range(p)]
    ws = [torch.zeros(k_loc, n, dtype=dtype) for _ in range(p)]
    bufs = [torch.zeros(2, m_loc, n, dtype=dtype) for _ in range(p)]
    outs = [torch.zeros(m_loc, n, dtype=dtype) for _ in range(p)]
    return xs, ws, bufs, outs


# ---------------------------------------------------------------------------
# K15: routes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("k_loc", [1024, 776, 777, 100])
@pytest.mark.parametrize("n", [1024, 1496, 300])
def test_mm_rs_route_by_dtype_and_shape(dtype, k_loc, n):
    # wgmma needs TMA's 16-byte row strides: k_loc and n multiples of 8 in
    # bf16; other bf16 takes mma.sync, f32 the FP32 tile
    xs, ws, bufs, outs = _mm_rs_operands(4, 40, k_loc, n, dtype)
    route, rows = C._mm_rs_route(xs, ws, bufs, outs)
    if dtype == torch.float32:
        want = "f32"
    elif k_loc % 8 or n % 8:
        want = "mma"
    else:
        want = "wgmma"
    assert route == want
    assert route in tdat.kbuild.RING_ROUTES


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("m_loc", [40, 1000, 7])
def test_mm_rs_route_reads_every_x_row_block(p, m_loc):
    # rank r's step for destination d reads x_r's row block d, d m_loc
    # k_loc elements past x_r: every one is a TMA address of the call
    k_loc, n = 200, 104
    xs, ws, bufs, outs = _mm_rs_operands(p, m_loc, k_loc, n, BF16)
    route, rows = C._mm_rs_route(xs, ws, bufs, outs)
    assert route == "wgmma"
    for x, r in zip(xs, rows):
        assert r == [x[d * m_loc:].data_ptr() for d in range(p)]
        assert all(a % 16 == 0 for a in r)
    # rank 0's x 8 bytes off alignment: each of its row blocks is too
    xs8, *rest = _mm_rs_operands(p, m_loc, k_loc, n, BF16, x_offset=8)
    route8, rows8 = C._mm_rs_route(xs8, *rest)
    assert route8 == "mma"
    assert all(a % 16 == 8 for a in rows8[0])
    assert C._mm_rs_route(*_mm_rs_operands(p, m_loc, k_loc, n,
                                           torch.float32, x_offset=4)
                          )[0] == "f32"


def test_mm_rs_route_counts_the_slots_and_outputs():
    xs, ws, bufs, outs = _mm_rs_operands(4, 40, 200, 104, BF16)
    assert C._mm_rs_route(xs, ws, bufs, outs)[0] == "wgmma"
    bad_out = [outs[0]] + [_at(40 * 104, 2, BF16).view(40, 104)] + outs[2:]
    assert C._mm_rs_route(xs, ws, bufs, bad_out)[0] == "mma"
    bad_w = ws[:3] + [_at(200 * 104, 4, BF16).view(200, 104)]
    assert C._mm_rs_route(xs, bad_w, bufs, outs)[0] == "mma"
    # one rank: no receive buffers, as the wrapper allocates none
    one = _mm_rs_operands(1, 40, 200, 104, BF16)
    assert C._mm_rs_route(one[0], one[1], [], one[3])[0] == "wgmma"


@pytest.mark.parametrize("route", ["wgmma", "mma", "f32"])
def test_mm_rs_peer_routes_look_right_not_left(route):
    # four ranks on two cards: K15 writes into the RIGHT neighbour's slot,
    # K13 and K14 forward into the LEFT one's, so the ranks that need the
    # peer route differ
    devs = [torch.device("cuda", i) for i in (0, 0, 1, 1)]
    right = C._step_routes(route, devs, to=1)
    left = C._step_routes(route, devs)
    if route == "wgmma":
        assert right == ["wgmma", "wgmma_peer", "wgmma", "wgmma_peer"]
        assert left == ["wgmma_peer", "wgmma", "wgmma_peer", "wgmma"]
    else:
        assert right == left == [route] * 4
    assert all(r in tdat.kbuild.RING_ROUTES for r in right)
    one = [torch.device("cuda", 0)] * 4
    assert C._step_routes(route, one, to=1) == [route] * 4


def test_route_counts_include_the_reduce_scatter_gemm():
    kb = tdat.kbuild
    kb.reset_launches()
    counts = kb.route_counts()
    assert counts["matmul_reducescatter"] == dict.fromkeys(kb.RING_ROUTES, 0)
    kb.count("matmul_reducescatter", "wgmma_peer")
    kb.count("matmul_reducescatter", "wgmma")
    assert kb.route_counts()["matmul_reducescatter"]["wgmma_peer"] == 1
    assert kb.launch_counts()["matmul_reducescatter"] == 2
    kb.reset_launches()
    assert kb.route_counts()["matmul_reducescatter"] == dict.fromkeys(
        kb.RING_ROUTES, 0)


# ---------------------------------------------------------------------------
# K6: routes
# ---------------------------------------------------------------------------


def _fused_qkv(B, S, H, D, dtype=BF16, seed=0):
    """q, k, v as ``transformer._attention`` makes them: (S, B, H, D) views
    of one (B, S, 3 H D) product."""
    E = H * D
    qkv = torch.from_numpy(_gauss((B, S, 3 * E), seed)).to(dtype)
    return tuple(t.view(B, S, H, D).transpose(0, 1)
                 for t in qkv.split(E, dim=-1))


def test_route_counts_include_the_dq_backward():
    kb = tdat.kbuild
    kb.reset_launches()
    assert kb.route_counts()["flash_attention_bwd_dq"] == dict.fromkeys(
        kb.ROUTES, 0)
    kb.count("flash_attention_bwd_dq", "wgmma")
    assert kb.route_counts()["flash_attention_bwd_dq"]["wgmma"] == 1
    assert kb.route_counts()["flash_attention_bwd_dkv"]["wgmma"] == 0
    assert kb.launch_counts()["flash_attention_bwd_dq"] == 1
    kb.reset_launches()
    assert kb.route_counts()["flash_attention_bwd_dq"]["wgmma"] == 0


@pytest.mark.parametrize("B,S,H,D,want", [(4, 128, 16, 64, "wgmma"),
                                          (2, 100, 4, 128, "wgmma"),
                                          (2, 64, 4, 8, "wgmma"),
                                          (2, 64, 4, 36, "mma")])
def test_dq_route_on_the_fused_qkv_views(B, S, H, D, want):
    # K6 of train_step: q, k, v the forward's fused views, do the
    # cotangent, dq a fresh (S, B, H, D) tensor as flash_attention_bwd
    # allocates it
    q, k, v = _fused_qkv(B, S, H, D)
    do = torch.zeros(q.shape, dtype=BF16)
    dq = torch.empty(q.shape, dtype=BF16)
    assert CA.flash_attention_route(BF16, D, q, k, v, do, dq) == want
    f32 = [x.float() for x in (q, k, v, do, dq)]
    assert CA.flash_attention_route(torch.float32, D, *f32) == "f32"


@pytest.mark.parametrize("H,B,D,want", [(4, 96, 64, "wgmma"),
                                        (16, 2048, 64, "wgmma"),
                                        (4, 97, 36, "mma")])
def test_dq_route_on_the_hop_backwards_transposed_blocks(H, B, D, want):
    # K6 of a ring hop: (B, H, D) views of (H, B, D) bf16 blocks, dq an f32
    # contribution laid out the same way
    q, k, v, do = (torch.zeros(H, B, D, dtype=BF16).transpose(0, 1)
                   for _ in range(4))
    dq = torch.empty(H, B, D).transpose(0, 1)
    assert CA.flash_attention_route(BF16, D, q, k, v, do, dq) == want


def test_dq_route_refuses_a_dq_tma_cannot_write():
    q = torch.zeros(128, 4, 64, dtype=BF16)
    dq = _at(128 * 4 * 64, 2, BF16).view(128, 4, 64)
    assert CA.flash_attention_route(BF16, 64, q, q, q, q, dq) == "mma"


# ---------------------------------------------------------------------------
# no launches on the CPU
# ---------------------------------------------------------------------------


def test_cpu_calls_of_k6_and_k15_count_no_launch_and_no_route():
    kb = tdat.kbuild
    kb.reset_launches()
    x, w = _gauss((16, 32), 1), _gauss((32, 16), 2)
    for dt in (torch.float32, BF16):
        C.ring_matmul_reducescatter(
            [torch.from_numpy(np.ascontiguousarray(c)).to(dt)
             for c in np.split(x, 4, axis=1)],
            [torch.from_numpy(np.ascontiguousarray(c)).to(dt)
             for c in np.split(w, 4, axis=0)])
    q, k, v = _fused_qkv(2, 32, 2, 8)
    o, lse = CA.flash_attention_lse(q, k, v, True)
    CA.flash_attention_bwd(q, k, v, o, torch.ones_like(o), lse, True)
    qh = torch.from_numpy(_gauss((2, 16, 8), 3)).to(BF16)
    CA.flash_attention_hop_bwd(qh, qh, qh, qh, torch.zeros(2, 16),
                               torch.zeros(2, 16), 16, 0, True)
    counts, routes = kb.launch_counts(), kb.route_counts()
    for name in ("matmul_reducescatter", "flash_attention_bwd_dq"):
        assert counts[name] == 0
        assert sum(routes[name].values()) == 0


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------


M_LOC, K_LOC, N = 40, 200, 104      # m_loc off 128, n off 64: ragged tiles


@pytest.mark.parametrize("p", [2, 4])
def test_mm_rs_bf16_plain_matches_pallas_ring(p):
    # K15's plain ring in bf16 at a ragged shape against the Pallas ring:
    # each block's f32 product cast to bf16, each add rounded to bf16
    x = _gauss((p * M_LOC, p * K_LOC), 70 + p)
    w = _gauss((p * K_LOC, N), 80 + p)
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    jy = np.asarray(run_spmd(lambda xx, ww: PC.ring_matmul_reducescatter(
        xx, ww, "p", interpret=True), spmd_mesh(p),
        (P(None, "p"), P("p", None)), P("p", None))(jx, jw).astype(
            jnp.float32))
    xs = [torch.from_numpy(np.ascontiguousarray(c)).to(BF16)
          for c in np.split(x, p, axis=1)]
    ws = [torch.from_numpy(np.ascontiguousarray(c)).to(BF16)
          for c in np.split(w, p, axis=0)]
    bufs = [torch.empty(2, M_LOC, N, dtype=BF16) for _ in range(p)]
    outs = C.ring_matmul_reducescatter(xs, ws)
    assert C._mm_rs_route(xs, ws, bufs, outs)[0] == "wgmma"
    assert all(o.dtype == BF16 and o.shape == (M_LOC, N) for o in outs)
    got = np.concatenate([o.float().numpy() for o in outs])
    assert _rel(got, jy) <= TOL_BF16
    ctl = np.asarray(jx.astype(jnp.float32) @ jw.astype(jnp.float32))
    assert _rel(ctl, jy) > TOL_BF16


def _jax_dq(q, k, v, g, causal, dtype):
    f = lambda q, k, v: PA.flash_attention(q, k, v, causal=causal,
                                           block_q=16, block_k=16,
                                           interpret=True)
    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    _, vjp = jax.vjp(f, *args)
    return np.asarray(vjp(jnp.asarray(g, dtype))[0].astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_dq_on_fused_qkv_views_matches_pallas_backward(causal, dtype):
    # the train_step's (S, B, H, D) views through the plain K6 against the
    # Pallas backward on the same values with the batch folded into heads
    B, S, H, D = 2, 64, 2, 16
    tdt = getattr(torch, dtype)
    q, k, v = _fused_qkv(B, S, H, D, tdt, seed=5)
    g = torch.from_numpy(_gauss((S, B, H, D), 6)).to(tdt)
    o, lse = CA.flash_attention_lse(q, k, v, causal)
    dq = CA.flash_attention_bwd(q, k, v, o, g, lse, causal)[0]
    assert dq.shape == (S, B, H, D) and dq.dtype == tdt
    fold = lambda x: np.ascontiguousarray(
        x.float().reshape(S, B * H, D).numpy())
    want = _jax_dq(*map(fold, (q, k, v, g)), causal,
                   jnp.float32 if dtype == "float32" else jnp.bfloat16)
    got = fold(dq)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    else:
        assert _rel(got, want) <= 2e-2
