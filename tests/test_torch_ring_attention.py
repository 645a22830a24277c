"""Sequence-parallel attention of the PyTorch port against the JAX package:
the plain ring (K9's plain version) against the fused RDMA kernel in
interpret mode, as ``tests/test_pallas_collectives.py`` runs it; and
``ring_attention``, ``ring_flash_attention``, ``ulysses_attention`` and
``ring_attention_prefill`` on 8 CPU ranks against their JAX counterparts.

Tolerances: the ring against the RDMA kernel atol 1e-5 (both f32 with the
same steps, summation order only; the JAX package holds its two rings to
the same); the DArray entries rtol 1e-4 / atol 1e-5 (the flash hops'
order); everything against the dense oracle atol 1e-4.
"""

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
