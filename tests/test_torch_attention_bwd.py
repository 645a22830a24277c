"""The FlashAttention-2 backward of the PyTorch port (K6 and K7's plain
versions behind ``flash_attention``'s autograd, and the ring hop's
``flash_attention_hop_bwd``) against the JAX package's Pallas backward
kernels, run in interpret mode on the CPU as
``tests/test_pallas_attention.py`` runs them.

The same random inputs and the same random cotangent go to both.
Tolerances: f32 rtol 1e-4 / atol 1e-5, the JAX package's own for its
kernels (summation order only).  bf16 relative Frobenius error 2e-2: both
round p and dS to bf16 before their products and the gradients to bf16 at
the end, but the bf16 forward output o that enters dd = rowsum(do * o)
rounds against a running max that depends on the JAX block size, and the
f32 sums run in other orders, so roundings a bf16 ulp (3.9e-3 relative)
apart move later ones.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import distributedarrays_tpu_torch as tdat
from distributedarrays_tpu.ops import pallas_attention as PA
from distributedarrays_tpu_torch.ops import cuda_attention as CA

from _torch_port import port_ranks  # noqa: F401

F32 = dict(rtol=1e-4, atol=1e-5)


def _arrays(shape, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _jax_grads(q, k, v, g, causal, block, dtype=jnp.float32, scale=None):
    f = lambda q, k, v: PA.flash_attention(q, k, v, causal=causal,
                                           scale=scale, block_q=block,
                                           block_k=block)
    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    _, vjp = jax.vjp(f, *args)
    return [np.asarray(x.astype(jnp.float32))
            for x in vjp(jnp.asarray(g, dtype))]


def _port_grads(q, k, v, g, causal, dtype=torch.float32, scale=None):
    ts = [torch.from_numpy(x).to(dtype).requires_grad_(True)
          for x in (q, k, v)]
    o = CA.flash_attention(*ts, causal=causal, scale=scale)
    o.backward(torch.from_numpy(g).to(dtype))
    return [t.grad for t in ts]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S,H,D,block", [(64, 2, 16, 32), (48, 2, 8, 16)])
def test_flash_backward_matches_jax_f32(S, H, D, block, causal):
    q, k, v, g = _arrays((S, H, D), 4, S + D)
    want = _jax_grads(q, k, v, g, causal, block)
    got = _port_grads(q, k, v, g, causal)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == (S, H, D)
        np.testing.assert_allclose(a.numpy(), b, **F32)


def test_flash_backward_custom_scale_matches_jax():
    q, k, v, g = _arrays((32, 2, 8), 4, 3)
    want = _jax_grads(q, k, v, g, True, 16, scale=0.3)
    got = _port_grads(q, k, v, g, True, scale=0.3)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, **F32)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_backward_matches_jax_bf16(causal):
    q, k, v, g = _arrays((64, 2, 16), 4, 77)
    want = _jax_grads(q, k, v, g, causal, 32, jnp.bfloat16)
    got = _port_grads(q, k, v, g, causal, torch.bfloat16)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        a = a.float().numpy()
        assert np.linalg.norm(a - b) / np.linalg.norm(b) <= 2e-2


def test_folded_batch_views_backward_matches_per_batch():
    # the transformer's use: (S, B, H, D) strided views of a fused QKV
    # product, the gradient flowing back into the product
    B, S, H, D = 2, 24, 2, 8
    x = torch.from_numpy(_arrays((B, S, 3 * H * D), 1, 5)[0])
    g = torch.from_numpy(_arrays((S, B, H, D), 1, 6)[0])
    xr = x.clone().requires_grad_(True)
    q, k, v = (t.view(B, S, H, D).transpose(0, 1)
               for t in xr.split(H * D, dim=-1))
    o, lse = CA.flash_attention_lse(q, k, v, causal=True)
    assert lse.shape == (B * H, S) and not lse.requires_grad
    o.backward(g)
    for b in range(B):
        qb, kb, vb = (torch.from_numpy(np.ascontiguousarray(
            x[b, :, i * H * D:(i + 1) * H * D].view(S, H, D).numpy()))
            for i in range(3))
        want = _jax_grads(qb.numpy(), kb.numpy(), vb.numpy(),
                          np.ascontiguousarray(g[:, b].numpy()), True, 8)
        got = [xr.grad[b, :, i * H * D:(i + 1) * H * D].reshape(S, H, D)
               for i in range(3)]
        for a, w in zip(got, want):
            np.testing.assert_allclose(a.numpy(), w, **F32)


def test_backward_wrapper_is_the_plain_version_on_head_major_blocks():
    # flash_attention_bwd computes dd = rowsum(g * o) and hands (H, S, D)
    # views to the plain version (the kernels' numerics) on the CPU
    q, k, v, g = (torch.from_numpy(x) for x in _arrays((32, 2, 8), 4, 9))
    o, lse = CA.flash_attention_lse(q, k, v, True)
    got = CA.flash_attention_bwd(q, k, v, o, g, lse, True)
    dd = (g * o).sum(-1).t().contiguous()
    want = CA.flash_attention_bwd_plain(
        *(x.transpose(0, 1) for x in (q, k, v, g)), lse, dd, 0, 0, True)
    for x, y in zip(got, want):
        assert torch.equal(x, y.transpose(0, 1))


# ---------------------------------------------------------------------------
# one ring hop's backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case,qoff,koff", [("visible", 64, 0),
                                            ("diagonal", 32, 32),
                                            ("masked", 0, 64)])
def test_hop_backward_matches_jax(case, qoff, koff):
    H, B, D = 2, 32, 16
    q, k, v, do = _arrays((H, B, D), 4, 91)
    rng = np.random.default_rng(92)
    lse = (rng.standard_normal((H, B)) + 3.0).astype(np.float32)
    dd = rng.standard_normal((H, B)).astype(np.float32)
    lane = lambda x: np.broadcast_to(x[..., None], (H, B, 128))
    want = PA.flash_attention_hop_bwd(q, k, v, do, lane(lse), lane(dd), qoff,
                                      koff, causal=True, block_q=16,
                                      block_k=16)
    got = CA.flash_attention_hop_bwd(
        *(torch.from_numpy(x) for x in (q, k, v, do, lse, dd)), qoff, koff,
        True)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == (H, B, D)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32)
    if case == "masked":
        assert not any(a.any() for a in got)


def test_hop_backward_of_a_whole_ring_sums_to_the_flash_gradient():
    # the contributions of every (q block, k block) pair of a causal
    # sequence, summed, are the gradient of flash attention over it
    p, B, H, D = 4, 8, 2, 8
    q, k, v, g = (torch.from_numpy(x) for x in _arrays((p * B, H, D), 4, 93))
    o, lse = CA.flash_attention_lse(q, k, v, True)
    dd = (g * o).sum(-1).t().contiguous()
    want = CA.flash_attention_bwd(q, k, v, o, g, lse, True)
    hb = lambda x, r: x[r * B:(r + 1) * B].transpose(0, 1).contiguous()
    dq, dk, dv = (torch.zeros(H, p * B, D) for _ in range(3))
    for r in range(p):
        for s in range(p):
            a, b, c = CA.flash_attention_hop_bwd(
                hb(q, r), hb(k, s), hb(v, s), hb(g, r),
                lse[:, r * B:(r + 1) * B].contiguous(),
                dd[:, r * B:(r + 1) * B].contiguous(), r * B, s * B, True)
            dq[:, r * B:(r + 1) * B] += a
            dk[:, s * B:(s + 1) * B] += b
            dv[:, s * B:(s + 1) * B] += c
    for a, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(a.transpose(0, 1).numpy(), w.numpy(),
                                   **F32)


def test_hop_backward_validation():
    q, k, v, do = (torch.zeros(2, 8, 4) for _ in range(4))
    lse = dd = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="share"):
        CA.flash_attention_hop_bwd(q, k[:, :4], v, do, lse, dd, 0, 0)
    meta = torch.zeros(2, 8, 4, device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        CA.flash_attention_hop_bwd(meta, meta, meta, meta, lse, dd, 0, 0)
    assert tdat.kbuild.launch_counts()["flash_attention_bwd_dq"] == 0
