"""Sequence-parallel attention of the PyTorch port against the JAX package:
the plain ring (K9's plain version) against the fused RDMA kernel in
interpret mode, as ``tests/test_pallas_collectives.py`` runs it; and
``ring_attention``, ``ring_flash_attention``, ``ulysses_attention`` and
``ring_attention_prefill`` on 8 CPU ranks against their JAX counterparts;
the differentiable flash ring and the zigzag family against the JAX
kernels under ``shard_map`` (Pallas hops in interpret mode), forward and
``jax.vjp``.

Tolerances: the ring against the RDMA kernel atol 1e-5 (both f32 with the
same steps, summation order only; the JAX package holds its two rings to
the same); the DArray entries rtol 1e-4 / atol 1e-5 (the flash hops'
order); the flash rings' outputs and gradients rtol 1e-4 / atol 1e-5
(the hop and the FA2 backward in one tile here, in 8-row blocks in the
Pallas kernels); everything against the dense oracle atol 1e-4.
"""

import jax
import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import distributedarrays_tpu as dat
import distributedarrays_tpu_torch as tdat
from distributedarrays_tpu.models import ring_attention as JRA
from distributedarrays_tpu.models import ulysses as JU
from distributedarrays_tpu.parallel.collectives import run_spmd, spmd_mesh
from distributedarrays_tpu_torch.models import ring_attention as TRA

from _torch_port import port_ranks, same_layout  # noqa: F401

F32 = dict(rtol=1e-4, atol=1e-5)


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for _ in range(3))


def _blocks(x, p, dtype=torch.float32):
    return [torch.from_numpy(np.ascontiguousarray(c)).to(dtype)
            for c in np.split(x, p)]


def _both(arrays, p):
    ds = dict(procs=list(range(p)), dist=[p, 1, 1])
    return ([dat.distribute(a, **ds) for a in arrays],
            [tdat.distribute(a, **ds) for a in arrays])


@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_rdma_kernel(p, causal):
    b, h, dh = 16, 2, 32
    q, k, v = _qkv((p * b, h, dh), 100 + p)
    spec = P("p", None, None)
    want = np.asarray(run_spmd(lambda a, bb, c: JRA.ring_attention_rdma_kernel(
        a, bb, c, "p", causal=causal, interpret=True),
        spmd_mesh(p), (spec,) * 3, spec)(q, k, v))
    outs = TRA.ring_attention_rdma(_blocks(q, p), _blocks(k, p),
                                   _blocks(v, p), causal=causal)
    got = torch.cat(outs).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, JRA.reference_attention(q, k, v, causal),
                               atol=1e-4)


@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b", [16, 13])
def test_ring_step_plan_skips_exactly_the_masked_steps(p, causal, b,
                                                       monkeypatch):
    rows = torch.arange(b)
    kept = 0
    for step in range(p):
        for r in range(p):
            src, compute = TRA.ring_step_plan(p, b, r, step, causal)
            assert src == (r - step) % p
            mask = ((src * b + rows[None, :]) <= (r * b + rows[:, None])
                    if causal else torch.ones(b, b, dtype=torch.bool))
            # skipped exactly when no query row sees a key of the block
            assert compute == bool(mask.any())
            if compute:
                # and every query row of a kept step sees one
                assert bool(mask.any(dim=1).all())
                kept += 1
    assert kept == (p * (p + 1) // 2 if causal else p * p)
    # the ring that honours the plan is the full ring, bit for bit, and
    # the JAX RDMA kernel's
    h, dh = 2, 32
    q, k, v = _qkv((p * b, h, dh), 200 + p + b)
    blocks = [_blocks(x, p) for x in (q, k, v)]
    skipped = TRA.ring_attention_kernel(*blocks, causal=causal)
    with monkeypatch.context() as mp:   # a plan that skips nothing
        mp.setattr(TRA, "ring_step_plan", lambda p, b, r, step, causal:
                   TRA.RingStep((r - step) % p, True))
        full = TRA.ring_attention_kernel(*blocks, causal=causal)
    for x, y in zip(skipped, full):
        assert torch.equal(x, y)
    spec = P("p", None, None)
    want = np.asarray(run_spmd(lambda a, bb, c: JRA.ring_attention_rdma_kernel(
        a, bb, c, "p", causal=causal, interpret=True),
        spmd_mesh(p), (spec,) * 3, spec)(q, k, v))
    np.testing.assert_allclose(torch.cat(skipped).numpy(), want, atol=1e-5)


def test_ring_step_plan_counts_compute_steps():
    # causal on 4 ranks: 16 steps, 10 of them accumulate
    plan = [TRA.ring_step_plan(4, 2048, r, t, True)
            for t in range(4) for r in range(4)]
    assert len(plan) == 16 and sum(s.compute for s in plan) == 10
    assert not TRA.ring_step_plan(4, 0, 0, 0, False).compute


def test_ring_bf16_matches_lax_ring():
    # bf16 blocks: q is scaled in bf16, then everything runs in f32
    p, b, h, dh = 4, 8, 2, 16
    q, k, v = _qkv((p * b, h, dh), 7)
    spec = P("p", None, None)
    want = np.asarray(run_spmd(lambda a, bb, c: JRA.ring_attention_kernel(
        a, bb, c, "p", causal=True), spmd_mesh(p), (spec,) * 3, spec)(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))).astype(
        jnp.float32))
    outs = TRA.ring_attention_kernel(
        *(_blocks(x, p, torch.bfloat16) for x in (q, k, v)), causal=True)
    assert outs[0].dtype == torch.bfloat16
    # f32 results rounded once to bf16: at most one bf16 ulp apart
    np.testing.assert_allclose(torch.cat(outs).float().numpy(), want,
                               rtol=8e-3, atol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_darray_matches_jax(causal):
    arrays = _qkv((64, 4, 16), 3)
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, 8)
    jo = JRA.ring_attention(jq, jk, jv, causal=causal)
    to = tdat.ring_attention(tq, tk, tv, causal=causal)
    same_layout(jo, to)
    assert to.dtype == torch.float32
    np.testing.assert_allclose(np.asarray(to), np.asarray(jo), atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_flash_attention_matches_jax(causal):
    arrays = _qkv((64, 2, 16), 4)
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, 4)
    jo = JRA.ring_flash_attention(jq, jk, jv, causal=causal)
    to = tdat.ring_flash_attention(tq, tk, tv, causal=causal)
    same_layout(jo, to)
    np.testing.assert_allclose(np.asarray(to), np.asarray(jo), **F32)
    np.testing.assert_allclose(np.asarray(to),
                               JRA.reference_attention(*arrays, causal),
                               atol=1e-4)


@pytest.mark.parametrize("use_flash", [True, False])
@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_jax(causal, use_flash):
    arrays = _qkv((64, 8, 16), 5)
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, 8)
    jo = JU.ulysses_attention(jq, jk, jv, causal=causal, use_flash=use_flash)
    to = tdat.ulysses_attention(tq, tk, tv, causal=causal,
                                use_flash=use_flash)
    same_layout(jo, to)
    np.testing.assert_allclose(np.asarray(to), np.asarray(jo), **F32)


def test_ring_attention_takes_k_v_on_other_layouts():
    q, k, v = _qkv((32, 2, 8), 6)
    tq = tdat.distribute(q, procs=range(4), dist=[4, 1, 1])
    tk = tdat.distribute(k, procs=range(8), dist=[8, 1, 1])
    tv = tdat.distribute(v, procs=range(2), dist=[2, 1, 1])
    to = tdat.ring_attention(tq, tk, tv, causal=True)
    assert to.grid == (4, 1, 1)
    np.testing.assert_allclose(np.asarray(to),
                               JRA.reference_attention(q, k, v, True),
                               atol=1e-4)


@pytest.mark.parametrize("fn", ["ring_attention", "ring_flash_attention",
                                "ulysses_attention"])
def test_validation_errors_match_jax(fn):
    x = np.zeros((16, 4, 8), np.float32)
    td = tdat.distribute(x, procs=range(8), dist=[8, 1, 1])
    jd = dat.distribute(x, procs=range(8), dist=[8, 1, 1])
    cases = [
        # not (seq, heads, head_dim)
        ((np.zeros((16, 32), np.float32), dict(dist=[8, 1])), "head_dim"),
        # dims differ
        ((np.zeros((16, 4, 4), np.float32), dict(dist=[8, 1, 1])), "match"),
        # a 2-D rank grid
        ((x, dict(dist=[4, 2, 1])), "1-D grid"),
        # a sequence the ranks do not divide
        ((np.zeros((12, 4, 8), np.float32), dict(dist=[8, 1, 1])),
         "1-D grid"),
    ]
    for (arr, kw), msg in cases:
        tbad = tdat.distribute(arr, procs=range(8), **kw)
        jbad = dat.distribute(arr, procs=range(8), **kw)
        args_t = (tbad, tbad, tbad) if msg != "match" else (td, tbad, td)
        args_j = (jbad, jbad, jbad) if msg != "match" else (jd, jbad, jd)
        with pytest.raises(ValueError, match=msg):
            getattr(tdat, fn)(*args_t)
        jfn = getattr(JU if fn == "ulysses_attention" else JRA, fn)
        with pytest.raises(ValueError, match=msg):
            jfn(*args_j)


def test_ulysses_head_divisibility():
    x = np.zeros((16, 3, 8), np.float32)
    td = tdat.distribute(x, procs=range(8), dist=[8, 1, 1])
    with pytest.raises(ValueError, match="divisible"):
        tdat.ulysses_attention(td, td, td)


def test_ring_step_validation():
    q = [torch.zeros(4, 2, 8)] * 2
    with pytest.raises(ValueError, match="one each per rank"):
        TRA.ring_attention_rdma(q, q[:1], q)
    with pytest.raises(ValueError, match="share one"):
        TRA.ring_attention_rdma(q, [torch.zeros(4, 2, 4)] * 2, q)
    meta = [torch.zeros(4, 2, 8, device="meta")] * 2
    with pytest.raises(ValueError, match="CUDA devices"):
        TRA.ring_attention_rdma(meta, meta, meta)


@pytest.mark.parametrize("ntok", [29, 64])
def test_prefill_matches_jax(ntok):
    q, k, v = _qkv((ntok, 2, 8), ntok)
    want = JRA.ring_attention_prefill(q, k, v)
    got = tdat.ring_attention_prefill(q, k, v)
    assert got.shape == (ntok, 2, 8) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, JRA.reference_attention(q, k, v, True),
                               atol=1e-4)
    assert tdat.live_ids() == []                # scratch DArrays closed


def test_prefill_short_prompt_takes_the_oracle():
    q, k, v = _qkv((9, 2, 8), 9)
    got = tdat.ring_attention_prefill(q, k, v)  # 9 < 2 * 8 ranks
    want = JRA.ring_attention_prefill(q, k, v)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(
        tdat.ring_attention_prefill(q, k, v, causal=False),
        JRA.reference_attention(q, k, v, False), atol=0)
    np.testing.assert_allclose(
        tdat.ring_attention_prefill(q, k, v, procs=[0, 1, 2],
                                    min_ring_tokens=3),
        JRA.ring_attention_prefill(q, k, v, procs=[0, 1, 2],
                                   min_ring_tokens=3), atol=1e-5)


# ---------------------------------------------------------------------------
# the differentiable flash ring and the zigzag family
# ---------------------------------------------------------------------------


def _jax_vjp(fn, p, arrays, g):
    """Output and (dq, dk, dv) of a JAX ring kernel under shard_map."""
    spec = P("p", None, None)
    f = run_spmd(fn, spmd_mesh(p), (spec,) * 3, spec)
    out, vjp = jax.vjp(f, *arrays)
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _port_vjp(fn, p, arrays, g):
    blocks = [[t.requires_grad_() for t in _blocks(x, p)] for x in arrays]
    outs = fn(*blocks)
    torch.autograd.backward(outs, _blocks(g, p))
    return (torch.cat(outs).detach().numpy(),
            [torch.cat([t.grad for t in bl]).numpy() for bl in blocks])


@pytest.mark.parametrize("causal", [False, True])
def test_ring_flash_kernel_gradients_match_jax(causal):
    p, b, h, dh = 4, 8, 2, 16
    arrays = _qkv((p * b, h, dh), 11)
    g = _qkv((p * b, h, dh), 12)[0]
    jo, jg = _jax_vjp(lambda q, k, v: JRA.ring_flash_attention_kernel(
        q, k, v, "p", causal=causal, block_q=8, block_k=8, interpret=True),
        p, arrays, g)
    to, tg = _port_vjp(lambda q, k, v: TRA.ring_flash_attention_kernel(
        q, k, v, causal), p, arrays, g)
    np.testing.assert_allclose(to, jo, **F32)
    for a, b_ in zip(tg, jg):
        np.testing.assert_allclose(a, b_, **F32)


@pytest.mark.parametrize("S,p", [(32, 4), (48, 3), (16, 8)])
def test_zigzag_order_shard_unshard_match_jax(S, p):
    np.testing.assert_array_equal(TRA.zigzag_order(S, p),
                                  JRA.zigzag_order(S, p))
    x = np.arange(S * 3, dtype=np.float32).reshape(S, 3)
    z = TRA.zigzag_shard(torch.from_numpy(x), p)
    np.testing.assert_array_equal(z.numpy(),
                                  np.asarray(JRA.zigzag_shard(x, p)))
    np.testing.assert_array_equal(TRA.zigzag_unshard(z, p).numpy(), x)
    with pytest.raises(ValueError, match="must divide"):
        TRA.zigzag_order(S + 1, p)


def test_zigzag_flash_forward_and_backward_match_jax():
    p, b, h, dh = 4, 16, 2, 16
    arrays = _qkv((p * b, h, dh), 13)
    g = _qkv((p * b, h, dh), 14)[0]
    jo, jg = _jax_vjp(lambda q, k, v: JRA.zigzag_ring_flash_attention_kernel(
        q, k, v, "p", block_q=8, block_k=8, interpret=True), p, arrays, g)
    to, tg = _port_vjp(TRA.zigzag_ring_flash_attention_kernel, p, arrays, g)
    np.testing.assert_allclose(to, jo, **F32)
    for a, b_ in zip(tg, jg):
        np.testing.assert_allclose(a, b_, **F32)
    # zigzag-ordered rows in, zigzag-ordered rows out: the dense oracle
    inv = np.argsort(TRA.zigzag_order(p * b, p))
    np.testing.assert_allclose(
        to[inv], JRA.reference_attention(*(x[inv] for x in arrays), True),
        atol=1e-4)


def test_zigzag_plain_ring_matches_jax():
    p, b, h, dh = 4, 8, 2, 8
    arrays = _qkv((p * b, h, dh), 15)
    spec = P("p", None, None)
    want = np.asarray(run_spmd(lambda q, k, v: JRA.zigzag_ring_attention_kernel(
        q, k, v, "p"), spmd_mesh(p), (spec,) * 3, spec)(*arrays))
    outs = TRA.zigzag_ring_attention_kernel(*(_blocks(x, p) for x in arrays))
    np.testing.assert_allclose(torch.cat(outs).numpy(), want, atol=1e-5)
    with pytest.raises(ValueError, match="even local block"):
        TRA.zigzag_ring_attention_kernel(*(_blocks(x[:28], 4)
                                           for x in arrays))


@pytest.mark.parametrize("fn", ["zigzag_ring_attention",
                                "zigzag_ring_flash_attention"])
def test_zigzag_darray_entries_match_jax(fn):
    arrays = _qkv((64, 2, 8), 16)
    zz = [np.asarray(JRA.zigzag_shard(x, 4)) for x in arrays]
    (jq, jk, jv), (tq, tk, tv) = _both(zz, 4)
    jo = getattr(JRA, fn)(jq, jk, jv)
    to = getattr(tdat, fn)(tq, tk, tv)
    same_layout(jo, to)
    np.testing.assert_allclose(np.asarray(to), np.asarray(jo), **F32)
    bad = tdat.distribute(np.zeros((36, 2, 8), np.float32), procs=range(4),
                          dist=[4, 1, 1])
    with pytest.raises(ValueError, match="2\\*nranks"):
        getattr(tdat, fn)(bad, bad, bad)
