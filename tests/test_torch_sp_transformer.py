"""The sequence-parallel transformer of the PyTorch port against the JAX
package's ``models/sp_transformer.py``, at the size of
``tests/test_transformer.py``'s ``sp_setup``: p = 4, ``SPConfig(vocab=64,
dim=32, heads=4, layers=2, max_seq=32)``, f32, tokens (2, 32).  The JAX
side runs its shard_map programs with the Pallas hops in interpret mode;
the weights cross through ``params_from_reference`` and ``shard_params``.

Tolerances: logits rtol 1e-4 / atol 1e-5 and the loss rtol 1e-5 (f32,
summation order of the products and the flash hops); gradients and the
parameters after SGD or Adam steps rtol 1e-4 / atol 1e-5 (the ring
backward sums its hops' contributions in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import distributedarrays_tpu_torch as tdat
from distributedarrays_tpu.models import ring_attention as JRA
from distributedarrays_tpu.models import sp_transformer as JSP
from distributedarrays_tpu.parallel.collectives import (shard_map_compat,
                                                        spmd_mesh)
from distributedarrays_tpu_torch.models import sp_transformer as TSP

from _torch_port import port_ranks  # noqa: F401

P4 = 4
SMALL = dict(vocab=64, dim=32, heads=4, layers=2, max_seq=32)
TOL = dict(rtol=1e-4, atol=1e-5)
RANKS = list(range(P4))


def _jcfg(**kw):
    return JSP.SPConfig(**SMALL, dtype=jnp.float32, block_q=8, block_k=8,
                        interpret=True, **kw)


def _tcfg(**kw):
    return TSP.SPConfig(**SMALL, dtype=torch.float32, **kw)


@pytest.fixture(scope="module")
def ref():
    """The JAX mesh, parameters (numpy pytree) and tokens."""
    params = JSP.init_params(jax.random.key(0), _jcfg())
    tokens = np.random.default_rng(1).integers(0, SMALL["vocab"], (2, 32),
                                               dtype=np.int32)
    return (spmd_mesh(P4), jax.tree_util.tree_map(np.asarray, params),
            tokens)


def _shards(np_params, cfg):
    return TSP.shard_params(tdat.params_from_reference(np_params, cfg),
                            RANKS)


def _flat(tree, leaf=np.asarray) -> dict:
    """The JAX pytree as {port parameter name: leaf(value)}."""
    out = {k: leaf(tree[k]) for k in ("embed", "pos", "ln_f", "head")}
    for i, blk in enumerate(tree["blocks"]):
        out.update({f"blocks.{i}.{k}": leaf(v) for k, v in blk.items()})
    return out


def _assert_trees(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), w, **TOL,
                                   err_msg=name)


def _params_of(shards, cfg) -> dict:
    return TSP.unshard([dict(m.named_parameters()) for m in shards], cfg)


def test_param_specs_and_shards_match_jax(ref):
    _, np_params, _ = ref
    jspecs = _flat(JSP.param_specs(_jcfg(), "p"), tuple)
    for name, dim in TSP.param_specs(_tcfg()).items():
        spec = jspecs[name]
        assert dim == (spec.index("p") if "p" in spec else None), name
    shards = _shards(np_params, _tcfg())
    assert shards[2].blocks[1].w1.shape == (32, 32)
    assert shards[2].blocks[1].w2.shape == (32, 32)
    np.testing.assert_array_equal(shards[2].blocks[1].w1.numpy(),
                                  np_params["blocks"][1]["w1"][:, 64:96])
    _assert_trees(_params_of(shards, _tcfg()), _flat(np_params))


@pytest.mark.parametrize("zigzag", [False, True])
def test_forward_local_matches_jax(ref, zigzag):
    mesh, np_params, tokens = ref
    jcfg, tcfg = _jcfg(zigzag=zigzag), _tcfg(zigzag=zigzag)
    if zigzag:
        tokens = tokens[:, JRA.zigzag_order(32, P4)]
    fwd = jax.jit(shard_map_compat(
        lambda pr, t: JSP.forward_local(pr, t, jcfg, "p"), mesh=mesh,
        in_specs=(JSP.param_specs(jcfg, "p"), P(None, "p")),
        out_specs=P(None, "p"), check=False))
    want = np.asarray(fwd(np_params, tokens))
    got = TSP.forward_local(_shards(np_params, tcfg),
                            TSP._split_tokens(tokens, RANKS), tcfg)
    assert all(g.shape == (2, 8, SMALL["vocab"]) and g.dtype == torch.float32
               for g in got)
    np.testing.assert_allclose(torch.cat(got, 1).numpy(), want, **TOL)


@pytest.mark.parametrize("zigzag", [False, True])
def test_loss_and_gradients_match_jax(ref, zigzag):
    mesh, np_params, tokens = ref
    jcfg, tcfg = _jcfg(zigzag=zigzag), _tcfg(zigzag=zigzag)
    if zigzag:
        tokens = tokens[:, JRA.zigzag_order(32, P4)]
    jloss, jg = jax.jit(JSP.make_grad_fn(mesh, jcfg))(np_params, tokens)
    shards = _shards(np_params, tcfg)
    loss, grads = TSP.make_grad_fn(RANKS, tcfg)(shards, tokens)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _assert_trees(TSP.unshard(grads, tcfg), _flat(jg))
    # replicated gradients are the same bits on every rank; shards differ
    for name, dim in TSP.param_specs(tcfg).items():
        if dim is None:
            assert all(torch.equal(g[name], grads[0][name]) for g in grads)
    loss_r = TSP.loss_local(shards, TSP._split_tokens(tokens, RANKS), tcfg)
    assert all(torch.equal(x, loss_r[0]) for x in loss_r)
    np.testing.assert_allclose(float(loss_r[0]), float(jloss), rtol=1e-5)


def test_three_sgd_steps_match_jax(ref):
    mesh, np_params, tokens = ref
    jstep = JSP.make_train_step(mesh, _jcfg())
    tstep = TSP.make_train_step(RANKS, _tcfg())
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    shards = _shards(np_params, _tcfg())
    for _ in range(3):
        jp, jl = jstep(jp, tokens, jnp.float32(0.5))
        shards, tl = tstep(shards, tokens, 0.5)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _assert_trees(_params_of(shards, _tcfg()), _flat(jp))
    # the replicated parameters' copies stay bit-identical across ranks
    for name, dim in TSP.param_specs(_tcfg()).items():
        if dim is None:
            vals = [dict(m.named_parameters())[name] for m in shards]
            assert all(torch.equal(v, vals[0]) for v in vals), name
    assert all(not t.requires_grad for m in shards for t in m.parameters())


def test_two_adam_steps_match_optax(ref):
    # eps 1e-3: Adam's first steps move each weight by about lr *
    # g / (|g| + eps), which for |g| near a small eps turns the gradients'
    # last-bit differences into visible parameter differences
    mesh, np_params, tokens = ref
    jstep, jinit = JSP.make_optax_train_step(mesh, _jcfg(),
                                             optax.adam(1e-2, eps=1e-3))
    tstep, tinit = TSP.make_optax_train_step(
        RANKS, _tcfg(), tdat.train.adam(1e-2, eps=1e-3))
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    jstate = jinit(jp)
    shards = _shards(np_params, _tcfg())
    state = tinit(shards)
    for _ in range(2):
        jp, jstate, jl = jstep(jp, jstate, tokens)
        shards, state, tl = tstep(shards, state, tokens)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _assert_trees(_params_of(shards, _tcfg()), _flat(jp))
    assert state[0]["t"] == 2
    assert state[1]["slots"][0][0].dtype == torch.float32


def test_bf16_step_keeps_bf16_parameters_with_f32_update(ref):
    _, np_params, tokens = ref
    cfg = TSP.SPConfig(**SMALL, dtype=torch.bfloat16)
    shards = _shards(np_params, cfg)
    before = [[t.detach().clone() for t in m.parameters()] for m in shards]
    loss, grads = TSP.make_grad_fn(RANKS, cfg)(shards, tokens)
    _, loss2 = TSP.make_train_step(RANKS, cfg)(shards, tokens, 2.0)
    assert float(loss2) == float(loss)
    for m, b0, g in zip(shards, before, grads):
        for (name, t), t0 in zip(m.named_parameters(), b0):
            assert t.dtype == torch.bfloat16
            assert torch.equal(t, (t0.float() - 2.0 * g[name].float())
                               .bfloat16()), name


def test_guards(ref):
    _, np_params, tokens = ref
    small = TSP.SPConfig(**{**SMALL, "max_seq": 16}, dtype=torch.float32)
    shards = _shards({**np_params, "pos": np_params["pos"][:16]}, small)
    with pytest.raises(ValueError, match="max_seq"):
        TSP.forward_local(shards, TSP._split_tokens(tokens, RANKS), small)
    zz = _tcfg(zigzag=True)
    with pytest.raises(ValueError, match="even per-rank length"):
        TSP.forward_local(_shards(np_params, zz),
                          TSP._split_tokens(tokens[:, :28], RANKS), zz)
    with pytest.raises(ValueError, match="4 equal sequence chunks"):
        TSP.make_grad_fn(RANKS, _tcfg())(_shards(np_params, _tcfg()),
                                         tokens[:, :30])
    with pytest.raises(ValueError, match="does not split"):
        tdat.transformer.Transformer(_tcfg(), ffn_shards=3)
