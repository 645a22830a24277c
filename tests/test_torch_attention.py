"""Flash attention (K5) and the ring hop (K8) of the PyTorch port against
the JAX package's Pallas kernels, run in interpret mode on the CPU as
``tests/test_pallas_attention.py`` runs them.

On the CPU the port's wrappers take their plain versions: the dense f32
softmax for ``flash_attention`` and the one-tile hop for
``flash_attention_hop``.  Tolerances: f32 rtol 1e-4 / atol 1e-5, the JAX
package's own for its kernels (summation order only).  bf16 compares to
2e-2 absolute on unit-scale outputs: the TPU kernel rounds p to bf16
against a running max that depends on its block size, the dense plain
version does not round p, and both round o to bf16 (one bf16 ulp at 1 is
7.8e-3).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import distributedarrays_tpu_torch as tdat
from distributedarrays_tpu.ops import pallas_attention as PA
from distributedarrays_tpu_torch.ops import cuda_attention as CA

from _torch_port import port_ranks  # noqa: F401

F32 = dict(rtol=1e-4, atol=1e-5)


def _qkv(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(dtype) for _ in range(3))


def _t(*xs, dtype=None):
    out = tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in xs)
    return out if dtype is None else tuple(x.to(dtype) for x in out)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S,H,D", [(128, 2, 16), (96, 4, 32), (100, 3, 8)])
def test_flash_matches_jax_f32(S, H, D, causal):
    q, k, v = _qkv((S, H, D), S + H)
    want = np.asarray(PA.flash_attention(q, k, v, causal=causal, block_q=32,
                                         block_k=32))
    got = tdat.flash_attention(*_t(q, k, v), causal=causal)
    assert got.shape == (S, H, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_matches_jax_bf16(causal):
    q, k, v = _qkv((128, 2, 32), 7)
    want = np.asarray(PA.flash_attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), causal=causal,
        block_q=64, block_k=64).astype(jnp.float32))
    got = tdat.flash_attention(*_t(q, k, v, dtype=torch.bfloat16),
                               causal=causal)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2)


def test_flash_custom_scale_matches_jax():
    q, k, v = _qkv((64, 2, 16), 3)
    want = np.asarray(PA.flash_attention(q, k, v, causal=True, scale=0.5))
    got = CA.flash_attention(*_t(q, k, v), causal=True, scale=0.5)
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_lse_matches_jax(causal):
    S, H, D = 128, 2, 16
    q, k, v = _qkv((S, H, D), 11)
    sc = 1.0 / np.sqrt(D)
    jo, res = PA._flash_fwd(q, k, v, causal, sc, 32, 32, True)
    o, lse = CA.flash_attention_lse(*_t(q, k, v), causal=causal)
    assert lse.shape == (H, S) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(res[4]), **F32)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **F32)


def test_flash_folded_batch_view_and_out():
    # (S, B, H, D) strided views of a fused QKV product, the output folded
    # back to (B, S, H, D): the transformer's use
    B, S, H, D = 2, 48, 2, 8
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (B, S, 3 * H * D)).astype(np.float32))
    q, k, v = (t.view(B, S, H, D).transpose(0, 1)
               for t in x.split(H * D, dim=-1))
    got, lse = CA.flash_attention_lse(q, k, v, causal=True)
    assert got.shape == (S, B, H, D) and lse.shape == (B * H, S)
    o = got.transpose(0, 1)
    fold = lambda t: t.reshape(S, B * H, D).numpy()
    want = np.asarray(PA.flash_attention(fold(q), fold(k), fold(v),
                                         causal=True, block_q=16,
                                         block_k=16))
    np.testing.assert_allclose(o.transpose(0, 1).reshape(S, B * H, D)
                               .numpy(), want, **F32)


def test_flash_validation():
    q, k, v = _t(*_qkv((32, 2, 8), 1))
    with pytest.raises(ValueError, match="share"):
        tdat.flash_attention(q, k[:16], v)
    with pytest.raises(ValueError, match="share"):
        tdat.flash_attention(q[None], k[None], v[None])
    with pytest.raises(TypeError):                # no out= view
        CA.flash_attention_lse(q, k, v, out=torch.empty(32, 2, 8))
    meta = torch.zeros(32, 2, 8, device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        tdat.flash_attention(meta, meta, meta)


def test_flash_block_size_matches_jax():
    for S in (1, 96, 100, 128, 1000, 4096, 6144):
        for cap in (64, 512):
            assert CA.flash_block_size(S, cap) == PA.flash_block_size(S, cap)


# ---------------------------------------------------------------------------
# K8: one hop with carried state
# ---------------------------------------------------------------------------


def _jax_hop(q, k, v, carry, qoff, koff, causal, dtype=None):
    if dtype is not None:
        q, k, v = (jnp.asarray(x, dtype) for x in (q, k, v))
    return PA.flash_attention_hop(q, k, v, *carry, qoff, koff, causal=causal,
                                  block_q=16, block_k=16)


def _assert_carry(jc, tc, **tol):
    jm, jl, ja = (np.asarray(x) for x in jc)
    tm, tl, ta = (x.numpy() for x in tc)
    # the JAX carry keeps m and l lane-broadcast: compare lane 0
    np.testing.assert_array_equal(np.isfinite(tm), np.isfinite(jm[..., 0]))
    fin = np.isfinite(tm)
    np.testing.assert_allclose(tm[fin], jm[..., 0][fin], **tol)
    np.testing.assert_allclose(tl, jl[..., 0], **tol)
    np.testing.assert_allclose(ta, ja, **tol)


@pytest.mark.parametrize("case,qoff,koff", [("visible", 64, 0),
                                            ("diagonal", 32, 32),
                                            ("masked", 0, 64)])
def test_hop_matches_jax_from_a_live_carry(case, qoff, koff):
    H, B, D = 2, 32, 16
    q, k, v = _qkv((H, B, D), 21)
    k0, v0 = _qkv((H, B, D), 22)[:2]
    # a carry with one hop already in it (the block at offset 0)
    jc = _jax_hop(q, k0, v0, PA.flash_carry_init(H, B, D), qoff, 0, True)
    tc = CA.flash_carry_init(H, B, D)
    CA.flash_attention_hop(*_t(q, k0, v0), *tc, qoff, 0, True)
    before = [x.clone() for x in tc]
    jc = _jax_hop(q, k, v, jc, qoff, koff, True)
    out = CA.flash_attention_hop(*_t(q, k, v), *tc, qoff, koff, True)
    assert all(a is b for a, b in zip(out, tc))         # updated in place
    _assert_carry(jc, tc, **F32)
    if case == "masked":                                # copy-through
        for a, b in zip(before, tc):
            assert torch.equal(a, b)


def test_hop_bf16_matches_jax():
    H, B, D = 2, 32, 16
    q, k, v = _qkv((H, B, D), 31)
    jc = _jax_hop(q, k, v, PA.flash_carry_init(H, B, D), 32, 16, True,
                  jnp.bfloat16)
    tc = CA.flash_carry_init(H, B, D)
    CA.flash_attention_hop(*_t(q, k, v, dtype=torch.bfloat16), *tc, 32, 16,
                           True)
    # same rounding of p to bf16 against a running max that depends on the
    # block size: a bf16 ulp of the partial sums
    _assert_carry(jc, tc, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case,qi,ki,koff", [("visible", 1, 0, 16),
                                             ("diagonal", 1, 1, 96),
                                             ("masked", 0, 1, 96)])
def test_hop_on_zigzag_parts_matches_jax(dtype, case, qi, ki, koff):
    # models/ring_attention.py hands K8 row halves x[:, i*m:(i+1)*m] of
    # (h, b, d) blocks: strided views whose base lies i*m*d elements in.
    # With 4 ranks of b = 32 rows in the zigzag layout, rank 1 holds chunks
    # 1 and 6 of m = 16 rows: part 0 starts at global row 16, part 1 at 96.
    # The k part lies wholly before the q part (visible), on its rows
    # (diagonal) or wholly after it (masked).
    H, b, D = 2, 32, 16
    m = b // 2
    q, k, v = _qkv((H, b, D), 71)
    k0, v0 = _qkv((H, b, D), 72)[:2]
    qoff = 96 if qi == 1 else 16
    jdt = None if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    part = lambda x, i: x[:, i * m:(i + 1) * m]
    npart = lambda x, i: np.ascontiguousarray(x[:, i * m:(i + 1) * m])
    # a live carry: the q part's own diagonal block first
    jc = _jax_hop(npart(q, qi), npart(k0, qi), npart(v0, qi),
                  PA.flash_carry_init(H, m, D), qoff, qoff, True, jdt)
    tq, tk, tv, tk0, tv0 = _t(q, k, v, k0, v0, dtype=tdt)
    tc = CA.flash_carry_init(H, m, D)
    CA.flash_attention_hop(part(tq, qi), part(tk0, qi), part(tv0, qi), *tc,
                           qoff, qoff, True)
    before = [x.clone() for x in tc]
    assert not part(tq, qi).is_contiguous()
    jc = _jax_hop(npart(q, qi), npart(k, ki), npart(v, ki), jc, qoff, koff,
                  True, jdt)
    CA.flash_attention_hop(part(tq, qi), part(tk, ki), part(tv, ki), *tc,
                           qoff, koff, True)
    if dtype == "float32":
        _assert_carry(jc, tc, **F32)
    else:
        _assert_carry(jc, tc, rtol=2e-2, atol=2e-2)
    if case == "masked":                                # copy-through
        for a, b_ in zip(before, tc):
            assert torch.equal(a, b_)


def test_fully_masked_hop_from_init_finalizes_to_zero():
    H, B, D = 2, 16, 8
    q, k, v = _qkv((H, B, D), 41)
    tc = CA.flash_carry_init(H, B, D)
    CA.flash_attention_hop(*_t(q, k, v), *tc, 0, 16, True)
    out, lse = CA.flash_carry_finalize(*tc, torch.float32)
    jc = _jax_hop(q, k, v, PA.flash_carry_init(H, B, D), 0, 16, True)
    jout, jlse = PA.flash_carry_finalize(*jc, jnp.float32)
    assert not out.any() and not lse.any()
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(lse.numpy(), np.asarray(jlse))


@pytest.mark.parametrize("causal", [False, True])
def test_ring_of_hops_finalizes_like_jax(causal):
    # a whole sequence as p = 4 hops of 16 rows, finalized, against the
    # JAX hops + flash_carry_finalize and against flash_attention
    p, B, H, D = 4, 16, 2, 8
    q, k, v = _qkv((p * B, H, D), 51)
    hb = lambda x, r: np.ascontiguousarray(
        np.transpose(x[r * B:(r + 1) * B], (1, 0, 2)))
    for r in range(p):
        jc = PA.flash_carry_init(H, B, D)
        tc = CA.flash_carry_init(H, B, D)
        for s in range(p):
            src = (r - s) % p
            jc = _jax_hop(hb(q, r), hb(k, src), hb(v, src), jc, r * B,
                          src * B, causal)
            CA.flash_attention_hop(*_t(hb(q, r), hb(k, src), hb(v, src)),
                                   *tc, r * B, src * B, causal)
        jout, jlse = PA.flash_carry_finalize(*jc, jnp.float32)
        out, lse = CA.flash_carry_finalize(*tc, torch.float32)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **F32)
        np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **F32)
        whole = CA.flash_attention(*_t(q, k, v), causal=causal)
        np.testing.assert_allclose(out.transpose(0, 1).numpy(),
                                   whole[r * B:(r + 1) * B].numpy(), **F32)


def test_hop_validation():
    H, B, D = 2, 8, 4
    q, k, v = _t(*_qkv((H, B, D), 61))
    m, l, acc = CA.flash_carry_init(H, B, D)
    with pytest.raises(ValueError, match="carry m"):
        CA.flash_attention_hop(q, k, v, m[:, :4], l, acc, 0, 0)
    with pytest.raises(ValueError, match="carry acc"):
        CA.flash_attention_hop(q, k, v, m, l, acc.double(), 0, 0)
    with pytest.raises(ValueError, match="share"):
        CA.flash_attention_hop(q, k[:, :4], v, m, l, acc, 0, 0)
