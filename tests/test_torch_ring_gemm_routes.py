"""The routes of the ring all-gather GEMMs K13 and K14 in the PyTorch port
(``cuda_collectives.ring_gemm_route``, ``ring_tile_n``, the route counts)
and their plain versions in bf16 against the JAX package's Pallas rings.

The routes are chosen on the host from dtypes, shapes and device addresses,
so they are tested here with made-up addresses; the kernels behind them run
only on the card (``chip_smoke.py``).  The bf16 shapes are ones the wgmma
route takes (k, n multiples of 8) whose TMA boxes (64 deep, 128 rows, 64
columns) run past every edge.  The JAX rings run their Pallas kernels in
interpret mode.  Both sides multiply the same bf16 values exactly in f32,
sum in another order and round to bf16 (per block for K13; per step, then
an add rounded to bf16, for K14), so a few outputs land on the
neighbouring bf16 value: relative Frobenius error <= 5e-4, the card's
tolerance for the same comparison.  The f32 product of the same bf16
values, never rounded, must land above it (about 3e-3).
"""

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
import jax.numpy as jnp

from distributedarrays_tpu.ops import collective_matmul as JCM
from distributedarrays_tpu.parallel.collectives import run_spmd, spmd_mesh
import distributedarrays_tpu_torch as tdat
from distributedarrays_tpu_torch.ops import cuda_collectives as C

from _torch_port import port_ranks  # noqa: F401

TOL_BF16 = 5e-4
BASE = 1 << 20


def _gauss(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _bf16_blocks(x, p, axis):
    return [torch.from_numpy(np.ascontiguousarray(c)).bfloat16()
            for c in np.split(x, p, axis=axis)]


def _rel(x, ref):
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1024, 776, 777])
@pytest.mark.parametrize("n", [1024, 296, 300])
@pytest.mark.parametrize("offs", [(0, 0, 0), (2, 0, 0), (0, 8, 0),
                                  (0, 0, 4)])
def test_ring_gemm_route_choice(dtype, k, n, offs):
    # wgmma needs TMA's 16-byte row strides (k, n multiples of 8 in bf16)
    # and 16-byte aligned A, B and forward slots; other bf16 takes mma.sync
    dt = getattr(torch, dtype)
    route = C.ring_gemm_route(dt, n, k, [BASE + o for o in offs])
    if dt == torch.float32:
        want = "f32"
    elif k % 8 or n % 8 or any(offs):
        want = "mma"
    else:
        want = "wgmma"
    assert route == want
    assert route in tdat.kbuild.ROUTES


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("k_loc", [776, 200, 777, 100])
@pytest.mark.parametrize("extra", [0, 8, 4])
def test_ring_gemm_route_k14_column_slices(p, k_loc, extra):
    # K14's A is the column slice a[:, koff:koff+k_loc] of a (m, lda)
    # matrix, lda = p k_loc + extra: TMA reads it at a + koff with a row
    # stride of lda, so every koff and lda must keep 16-byte alignment
    lda = p * k_loc + extra
    ptrs = [BASE + 2 * q * k_loc for q in range(p)]
    route = C.ring_gemm_route(torch.bfloat16, 104, k_loc, ptrs, lda=lda)
    aligned = k_loc % 8 == 0 and lda % 8 == 0
    assert route == ("wgmma" if aligned else "mma")
    # the same slices in f32 take the FP32 tile whatever their alignment
    assert C.ring_gemm_route(torch.float32, 104, k_loc, ptrs,
                             lda=lda) == "f32"


def test_ring_gemm_route_edges_and_other_dtypes():
    assert C.ring_gemm_route(torch.bfloat16, 8, 0, [BASE]) == "mma"
    assert C.ring_gemm_route(torch.bfloat16, 8, 8, []) == "wgmma"
    for dt in (torch.float16, torch.int8, torch.float64):
        with pytest.raises(TypeError):
            C.ring_gemm_route(dt, 8, 8, [BASE])


@pytest.mark.parametrize("m,n,sms,want", [
    (2048, 1024, 132, 128),    # K13's step: 128 tiles of 128 x 128
    (1024, 1024, 132, 64),     # K14's weight gradient: 64 tiles
    (4096, 16384, 132, 128),   # K14 at 16384^2 on 4 ranks
    (1024, 1024, 64, 128),     # as many SMs as tiles
    (1000, 296, 132, 64)])
def test_ring_tile_n(m, n, sms, want):
    assert C.ring_tile_n(m, n, sms) == want


def test_step_routes_forward_to_other_cards_by_copy():
    # four ranks on two cards: a rank whose left neighbour's slot lies on
    # the other card forwards by a copy launch (wgmma_peer)
    devs = [torch.device("cuda", i) for i in (0, 0, 1, 1)]
    assert C._step_routes("wgmma", devs) == ["wgmma_peer", "wgmma",
                                             "wgmma_peer", "wgmma"]
    assert C._step_routes("mma", devs) == ["mma"] * 4
    one = [torch.device("cuda", 0)] * 3
    assert C._step_routes("wgmma", one) == ["wgmma"] * 3
    assert all(r in tdat.kbuild.RING_ROUTES
               for r in C._step_routes("wgmma", devs))


def test_route_counts_include_the_ring_gemms():
    kb = tdat.kbuild
    kb.reset_launches()
    counts = kb.route_counts()
    for name in ("allgather_matmul", "allgather_matmul_rhs"):
        assert counts[name] == dict.fromkeys(kb.RING_ROUTES, 0)
    assert kb.RING_ROUTES[:len(kb.ROUTES)] == kb.ROUTES
    assert set(counts) >= {"gemm", "ring_attention"}
    kb.count("allgather_matmul_rhs", "wgmma")
    assert kb.route_counts()["allgather_matmul_rhs"]["wgmma"] == 1
    assert kb.launch_counts()["allgather_matmul_rhs"] == 1
    kb.reset_launches()
    assert kb.route_counts()["allgather_matmul_rhs"]["wgmma"] == 0


def test_plain_rings_count_no_launches():
    kb = tdat.kbuild
    kb.reset_launches()
    x, w = _gauss((16, 24), 1), _gauss((24, 16), 2)
    C.ring_allgather_matmul(_bf16_blocks(x, 2, 0), _bf16_blocks(w, 2, 1))
    C.ring_allgather_matmul_rhs(_bf16_blocks(x, 2, 0),
                                _bf16_blocks(w[:, :8], 2, 0))
    assert kb.launch_counts()["allgather_matmul"] == 0
    assert kb.launch_counts()["allgather_matmul_rhs"] == 0
    assert sum(kb.route_counts()["allgather_matmul"].values()) == 0


M_LOC, K, N = 40, 200, 104


@pytest.mark.parametrize("p", [2, 4])
def test_allgather_matmul_bf16_matches_pallas_ring(p):
    # K13: all_gather(x) @ w_r, each resident block's f32 product cast once
    x = _gauss((p * M_LOC, K), 20 + p)
    w = _gauss((K, p * N), 30 + p)
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    jy = np.asarray(run_spmd(lambda xx, ww: JCM.allgather_matmul(
        xx, ww, "p", rdma=True, interpret=True), spmd_mesh(p),
        (P("p", None), P(None, "p")), P(None, "p"))(jx, jw).astype(
            jnp.float32))
    xs, ws = _bf16_blocks(x, p, 0), _bf16_blocks(w, p, 1)
    assert C.ring_gemm_route(torch.bfloat16, N, K, [BASE]) == "wgmma"
    outs = C.ring_allgather_matmul(xs, ws)
    assert all(o.dtype == torch.bfloat16 and o.shape == (p * M_LOC, N)
               for o in outs)
    got = np.concatenate([o.float().numpy() for o in outs], axis=1)
    assert _rel(got, jy) <= TOL_BF16
    ctl = np.asarray(jx.astype(jnp.float32) @ jw.astype(jnp.float32))
    assert _rel(ctl, jy) > TOL_BF16


@pytest.mark.parametrize("p", [2, 4])
def test_allgather_matmul_rhs_bf16_matches_pallas_ring(p):
    # K14: a_r @ all_gather(b), each step's product cast to bf16 and added
    # in bf16, at column slices a[:, koff:koff + K] that TMA can read
    a = _gauss((p * M_LOC, p * K), 40 + p)
    b = _gauss((p * K, N), 50 + p)
    ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    jy = np.asarray(run_spmd(lambda aa, bb: JCM.allgather_matmul_rhs(
        aa, bb, "p", rdma=True, interpret=True), spmd_mesh(p),
        (P("p", None), P("p", None)), P("p", None))(ja, jb).astype(
            jnp.float32))
    as_, bs = _bf16_blocks(a, p, 0), _bf16_blocks(b, p, 0)
    ptrs = [BASE + 2 * q * K for q in range(p)]
    assert C.ring_gemm_route(torch.bfloat16, N, K, ptrs,
                             lda=p * K) == "wgmma"
    outs = C.ring_allgather_matmul_rhs(as_, bs)
    assert all(o.dtype == torch.bfloat16 and o.shape == (M_LOC, N)
               for o in outs)
    got = np.concatenate([o.float().numpy() for o in outs])
    assert _rel(got, jy) <= TOL_BF16
    ctl = np.asarray(ja.astype(jnp.float32) @ jb.astype(jnp.float32))
    assert _rel(ctl, jy) > TOL_BF16
