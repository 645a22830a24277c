"""The routes of flash attention (K5), the ring hop (K8) and the dk/dv
backward (K7) in the PyTorch port (``cuda_attention.flash_attention_route``,
``hop_groups``, the route counts)
and their plain versions on the layouts the routes see, against the JAX
package's Pallas kernels.

The route is chosen on the host from the dtype, the head dim and each
operand's base address and strides, so it is tested here on CPU tensors
that have the card's layouts: contiguous (S, H, D) tensors, the
transformer's (S, B, H, D) views of one fused QKV product, the ring hop
backward's (B, H, D) views of (H, B, D) blocks with f32 outputs, and views
made with ``as_strided`` at chosen offsets and strides; the kernels behind
the routes run only on the card (``chip_smoke.py``).  The JAX kernels run
in interpret mode.  Tolerances as ``tests/test_torch_attention.py`` and
``tests/test_torch_attention_bwd.py``: f32 rtol 1e-4 / atol 1e-5
(summation order only); bf16 outputs 2e-2 absolute (forward) and 2e-2
relative Frobenius (backward): the TPU kernels round p to bf16 against a
blockwise running max, the plain versions round at other places.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import distributedarrays_tpu_torch as tdat
from distributedarrays_tpu.ops import pallas_attention as PA
from distributedarrays_tpu_torch.ops import cuda_attention as CA

from _torch_port import port_ranks  # noqa: F401

ROUTE = CA.flash_attention_route
BF16 = torch.bfloat16


def _gauss(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _rel(x, ref):
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


def _fused_qkv(B, S, H, D, dtype=BF16, seed=0):
    """q, k, v as ``transformer._attention`` makes them: (S, B, H, D) views
    of one (B, S, 3 H D) product."""
    E = H * D
    qkv = torch.from_numpy(_gauss((B, S, 3 * E), seed)).to(dtype)
    return tuple(t.view(B, S, H, D).transpose(0, 1)
                 for t in qkv.split(E, dim=-1))


def _at(shape, strides, offset, dtype=BF16):
    """A view of a fresh buffer with the given strides (elements) whose base
    lies ``offset`` elements past the buffer's (16-byte aligned) start."""
    n = offset + 1 + sum((s - 1) * st for s, st in zip(shape, strides))
    buf = torch.zeros(n, dtype=dtype)
    assert buf.data_ptr() % 16 == 0
    return torch.as_strided(buf, shape, strides, offset)


@pytest.mark.parametrize("D,want", [(64, "wgmma"), (128, "wgmma"),
                                    (32, "wgmma"), (8, "wgmma"),
                                    (36, "mma"), (100, "mma"), (4, "mma")])
def test_route_on_contiguous_tensors(D, want):
    q, k, v = (torch.zeros(256, 16, D, dtype=BF16) for _ in range(3))
    o = torch.empty_like(q)
    assert ROUTE(BF16, D, q, k, v, o) == want
    f = q.float()
    assert ROUTE(torch.float32, D, f, f, f) == "f32"
    assert ROUTE(BF16, D, q, k, v, o) in tdat.kbuild.ROUTES


def test_route_beyond_the_kernels_head_dim_and_other_dtypes():
    q = torch.zeros(64, 2, 136, dtype=BF16)
    assert ROUTE(BF16, 136, q) == "mma"
    for dt in (torch.float16, torch.float64, torch.int8):
        with pytest.raises(TypeError):
            ROUTE(dt, 64, q.to(dt))


@pytest.mark.parametrize("B,S,H,D,want", [(4, 128, 16, 64, "wgmma"),
                                          (2, 100, 4, 128, "wgmma"),
                                          (2, 64, 4, 8, "wgmma"),
                                          (2, 64, 4, 36, "mma")])
def test_route_on_the_transformers_fused_qkv_views(B, S, H, D, want):
    # row stride 3E, batch stride S 3E, head stride D, bases E apart
    q, k, v = _fused_qkv(B, S, H, D)
    assert q.stride() == (3 * H * D, S * 3 * H * D, D, 1)
    # the forward's o: (S, B, H, D) view of (B, S, H, D) storage
    o = torch.empty((B, S, H, D), dtype=BF16).transpose(0, 1)
    assert ROUTE(BF16, D, q, k, v, o) == want


@pytest.mark.parametrize("out_dtype", [torch.float32, BF16])
def test_route_on_the_hop_backwards_transposed_blocks(out_dtype):
    # K7 of a ring hop: (B, H, D) views of (H, B, D) blocks, f32 outputs
    H, B, D = 4, 96, 64
    q, k, v, do = (torch.zeros(H, B, D, dtype=BF16).transpose(0, 1)
                   for _ in range(4))
    dk, dv = (torch.empty(H, B, D, dtype=out_dtype).transpose(0, 1)
              for _ in range(2))
    assert ROUTE(BF16, D, q, k, v, do, dk, dv) == "wgmma"
    # a block whose row count leaves the head stride off 16 bytes
    odd = torch.zeros(H, 97, 36, dtype=BF16).transpose(0, 1)
    assert ROUTE(BF16, 36, odd, odd, odd, odd) == "mma"


@pytest.mark.parametrize("H,B,D,want", [(16, 2048, 64, "wgmma"),
                                        (16, 1024, 128, "wgmma"),
                                        (4, 100, 8, "wgmma"),
                                        (4, 97, 36, "mma"),
                                        (4, 96, 36, "mma")])
def test_route_on_the_hops_transposed_blocks(H, B, D, want):
    # K8 reads its contiguous (H, B, D) blocks as (B, H, D) views: rows D
    # apart, heads B * D apart
    q, k, v = (torch.zeros(H, B, D, dtype=BF16).transpose(0, 1)
               for _ in range(3))
    assert ROUTE(BF16, D, q, k, v) == want
    assert ROUTE(torch.float32, D, *(x.float() for x in (q, k, v))) == "f32"


@pytest.mark.parametrize("b,D,want", [(2048, 64, "wgmma"),
                                      (96, 16, "wgmma"),
                                      (2 * 97, 8, "wgmma"),
                                      (2 * 97, 12, "mma")])
@pytest.mark.parametrize("i", [0, 1])
def test_route_on_zigzag_parts(b, D, want, i):
    # models/ring_attention.py hands K8 the row halves x[:, i*m:(i+1)*m]
    # of (h, b, d) blocks: base i*m*d elements in, rows d apart, heads b*d
    H, m = 4, b // 2
    blocks = [torch.zeros(H, b, D, dtype=BF16) for _ in range(3)]
    parts = [x[:, i * m:(i + 1) * m].transpose(0, 1) for x in blocks]
    assert not parts[0].is_contiguous()
    assert parts[0].data_ptr() - blocks[0].data_ptr() == i * m * D * 2
    assert ROUTE(BF16, D, *parts) == want


@pytest.mark.parametrize("rows,heads,want", [(2048, 16, 2), (1024, 16, 1),
                                             (1024, 64, 2), (64, 1, 1),
                                             (8192, 4, 2)])
def test_hop_groups_keeps_every_sm_busy(rows, heads, want):
    # two warpgroups a block while that grid has a block for each of the
    # 132 SMs, else one (three smaller blocks an SM)
    assert CA.hop_groups(rows, heads, 132) == want


def test_cpu_hop_calls_count_no_launch_or_route():
    kb = tdat.kbuild
    kb.reset_launches()
    H, B, D = 2, 32, 8
    q = torch.from_numpy(_gauss((H, B, D), 5)).to(BF16)
    for x in (q, q.float()):
        m, l, acc = CA.flash_carry_init(H, B // 2, D)
        CA.flash_attention_hop(x[:, B // 2:], x[:, :B // 2], x[:, :B // 2],
                               m, l, acc, B // 2, 0, True)
        assert torch.isfinite(m).all() and l.gt(0).all()
    assert kb.launch_counts()["flash_attention_hop"] == 0
    assert kb.route_counts()["flash_attention_hop"] == dict.fromkeys(
        kb.ROUTES, 0)


@pytest.mark.parametrize("offset,want", [(0, "wgmma"), (8, "wgmma"),
                                         (1, "mma"), (4, "mma"),
                                         (64, "wgmma")])
def test_route_on_misaligned_bases(offset, want):
    good = torch.zeros(128, 4, 64, dtype=BF16)
    x = _at((128, 4, 64), (256, 64, 1), offset)
    assert ROUTE(BF16, 64, good, x, good) == want
    assert ROUTE(BF16, 64, x) == want


@pytest.mark.parametrize("strides,want", [
    ((272, 68, 1), "mma"),       # head stride 136 bytes
    ((260, 64, 1), "mma"),       # row stride 520 bytes
    ((512, 128, 1), "wgmma"),    # padded rows and heads, 16-byte multiples
    ((64, 128 * 64, 1), "wgmma")])  # head-major storage, rows first
def test_route_on_strides(strides, want):
    x = _at((128, 4, 64), strides, 0)
    assert ROUTE(BF16, 64, x, x, x) == want


def test_route_ignores_the_strides_of_dims_of_one():
    # one head: its stride never addresses anything
    x = _at((128, 1, 64), (64, 3, 1), 0)
    assert ROUTE(BF16, 64, x) == "wgmma"
    y = _at((128, 2, 64), (64, 3, 1), 0)
    assert ROUTE(BF16, 64, y) == "mma"


def test_route_counts_include_flash_attention_and_the_dkv_backward():
    kb = tdat.kbuild
    kb.reset_launches()
    counts = kb.route_counts()
    for name in ("flash_attention", "flash_attention_bwd_dkv"):
        assert counts[name] == dict.fromkeys(kb.ROUTES, 0)
    assert set(counts) >= {"gemm", "ring_attention", "allgather_matmul"}
    # K6 and the ring hop K8 take K7's routes
    assert counts["flash_attention_bwd_dq"] == dict.fromkeys(kb.ROUTES, 0)
    assert counts["flash_attention_hop"] == dict.fromkeys(kb.ROUTES, 0)
    kb.count("flash_attention", "wgmma")
    kb.count("flash_attention_bwd_dkv", "mma")
    assert kb.route_counts()["flash_attention"]["wgmma"] == 1
    assert kb.route_counts()["flash_attention_bwd_dkv"]["mma"] == 1
    assert kb.launch_counts()["flash_attention"] == 1
    kb.reset_launches()
    assert kb.route_counts()["flash_attention"]["wgmma"] == 0
    assert kb.route_counts()["flash_attention_bwd_dkv"]["mma"] == 0
    assert kb.launch_counts()["flash_attention_bwd_dkv"] == 0


def test_cpu_calls_take_the_plain_path_and_count_no_route():
    kb = tdat.kbuild
    kb.reset_launches()
    q, k, v = _fused_qkv(2, 32, 2, 8)
    o, lse = CA.flash_attention_lse(q, k, v, True)
    g = torch.from_numpy(_gauss(tuple(q.shape), 9)).to(BF16)
    CA.flash_attention_bwd(q, k, v, o, g, lse, True)
    qh = torch.from_numpy(_gauss((2, 16, 8), 3)).to(BF16)
    CA.flash_attention_hop_bwd(qh, qh, qh, qh, torch.zeros(2, 16),
                               torch.zeros(2, 16), 16, 0, True)
    assert sum(kb.launch_counts().values()) == 0
    assert all(c == 0 for r in kb.route_counts().values()
               for c in r.values())


@pytest.mark.parametrize("causal", [False, True])
def test_fused_qkv_views_match_pallas_flash(causal):
    # the serving forward's (S, B, H, D) views against the Pallas kernel on
    # the same values with the batch folded into the heads
    B, S, H, D = 2, 64, 2, 16
    q, k, v = _fused_qkv(B, S, H, D, torch.float32, seed=4)
    o, lse = CA.flash_attention_lse(q, k, v, causal)
    assert o.shape == (S, B, H, D)
    folded = [np.ascontiguousarray(x.reshape(S, B * H, D).numpy())
              for x in (q, k, v)]
    want = np.asarray(PA.flash_attention(*folded, causal=causal, block_q=16,
                                         block_k=16))
    np.testing.assert_allclose(o.reshape(S, B * H, D).numpy(), want,
                               rtol=1e-4, atol=1e-5)
    bf = [jnp.asarray(x, jnp.bfloat16) for x in folded]
    want16 = np.asarray(PA.flash_attention(*bf, causal=causal, block_q=16,
                                           block_k=16).astype(jnp.float32))
    o16, _ = CA.flash_attention_lse(*(x.to(BF16) for x in (q, k, v)),
                                    causal)
    np.testing.assert_allclose(o16.reshape(S, B * H, D).float().numpy(),
                               want16, atol=2e-2)


@pytest.mark.parametrize("koff,nonzero", [(0, True), (32, True),
                                          (64, False)])
def test_hop_backward_on_transposed_blocks_matches_pallas(koff, nonzero):
    # one hop's f32 contributions at qoff 32 from (H, B, D) bf16 blocks,
    # as the sequence-parallel backward hands them to K6/K7
    H, B, D = 2, 32, 16
    q, k, v, do = (_gauss((H, B, D), 10 + i) for i in range(4))
    lse = _gauss((H, B), 20) + 4.0
    dd = _gauss((H, B), 21)
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do)]
    lane = lambda x: jnp.broadcast_to(jnp.asarray(x)[:, :, None], (H, B, 128))
    want = PA.flash_attention_hop_bwd(*jb, lane(lse), lane(dd), 32, koff,
                                      causal=True, block_q=8, block_k=8,
                                      interpret=True)
    got = CA.flash_attention_hop_bwd(
        *(torch.from_numpy(x).to(BF16) for x in (q, k, v, do)),
        torch.from_numpy(lse), torch.from_numpy(dd), 32, koff, True)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (H, B, D)
        w = np.asarray(w)
        if nonzero:
            assert _rel(g.numpy(), w) <= 2e-2
        else:
            assert not g.any() and not w.any()
