"""The flagship transformer's serving half in the PyTorch port against the
JAX package, at the size ``__graft_entry__.dryrun_multichip`` uses:
``Config(vocab=64, dim=32, heads=4, layers=2, max_seq=16)``.  Both take the
same weights: the JAX ``init_params`` pytree as numpy, loaded into the
port with ``params_from_reference``.

Tolerances: float32 logits rtol 1e-4 / atol 1e-4 (summation order of the
matrix products and the attention); bfloat16 logits relative Frobenius
error 3e-2 (both round every product and the residual stream to bf16, in
other orders: a few bf16 ulps, 3.9e-3 each, through two layers).  Greedy
decoding in float32 must give the same tokens.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import distributedarrays_tpu_torch as tdat
from distributedarrays_tpu.models import transformer as JT
from distributedarrays_tpu_torch.models import transformer as TT
from distributedarrays_tpu_torch.models._autodiff import value_and_grad
from distributedarrays_tpu_torch.ops.cuda_attention import (
    flash_attention_plain)

from _torch_port import port_ranks  # noqa: F401

SMALL = dict(vocab=64, dim=32, heads=4, layers=2, max_seq=16)


def _pair(dtype):
    jcfg = JT.Config(**SMALL, dtype=jnp.float32 if dtype == torch.float32
                     else jnp.bfloat16)
    tcfg = TT.Config(**SMALL, dtype=dtype)
    jp = JT.init_params(jax.random.key(0), jcfg)
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, tcfg, jp, tdat.params_from_reference(np_params, tcfg)


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, SMALL["vocab"], shape,
                                                dtype=np.int32)


def test_params_round_trip_keeps_names_and_values():
    _, tcfg, jp, model = _pair(torch.bfloat16)
    names = {n for n, _ in model.named_parameters()}
    assert {"embed", "pos", "ln_f", "head", "blocks.1.qkv",
            "blocks.0.w2"} <= names and len(names) == 4 + 6 * 2
    back = tdat.params_to_reference(model)
    ref = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), jp)
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    flat_r, tree_r = jax.tree_util.tree_flatten(ref)
    assert tree_b == tree_r
    for a, b in zip(flat_b, flat_r):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="blocks"):
        tdat.params_from_reference({**back, "blocks": back["blocks"][:1]},
                                   tcfg)


@pytest.mark.parametrize("S", [16, 11])
def test_forward_f32_matches_jax(S):
    jcfg, tcfg, jp, model = _pair(torch.float32)
    tok = _tokens((3, S), S)
    want = np.asarray(JT.forward(jp, tok, jcfg))
    got = TT.forward(model, tok, tcfg)
    assert got.shape == (3, S, SMALL["vocab"]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    # the module call and the plain dense attention agree with the kernel
    np.testing.assert_array_equal(model(torch.from_numpy(tok)).numpy(),
                                  got.numpy())
    np.testing.assert_allclose(
        TT.forward(model, tok, tcfg,
                   _attend=flash_attention_plain).numpy(), got.numpy(),
        rtol=1e-5, atol=1e-5)


def test_forward_bf16_matches_jax():
    jcfg, tcfg, jp, model = _pair(torch.bfloat16)
    tok = _tokens((2, 16), 3)
    want = np.asarray(JT.forward(jp, tok, jcfg))
    got = TT.forward(model, tok, tcfg).numpy()
    assert got.dtype == np.float32
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 3e-2


def test_forward_rejects_long_sequences():
    _, tcfg, _, model = _pair(torch.float32)
    with pytest.raises(ValueError, match="max_seq"):
        TT.forward(model, _tokens((1, 17), 0), tcfg)


@pytest.mark.parametrize("S0,n_new", [(5, 8), (1, 15)])
def test_greedy_generate_matches_jax_f32(S0, n_new):
    jcfg, tcfg, jp, model = _pair(torch.float32)
    prompt = _tokens((2, S0), 10 + S0)
    want = np.asarray(JT.generate(jp, prompt, n_new, jcfg))
    got = TT.generate(model, prompt, n_new, tcfg)
    assert got.shape == (2, S0 + n_new) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # greedy tokens are the argmax of the full forward over the sequence
    logits = TT.forward(model, got[:, :-1], tcfg)
    np.testing.assert_array_equal(logits.argmax(-1)[:, S0 - 1:].numpy(),
                                  got[:, S0:].numpy())


def test_generate_errors():
    _, tcfg, _, model = _pair(torch.float32)
    prompt = _tokens((2, 6), 0)
    with pytest.raises(ValueError, match="exceeds max_seq"):
        TT.generate(model, prompt, 11, tcfg)
    with pytest.raises(ValueError, match="Generator"):
        TT.generate(model, prompt, 4, tcfg, temperature=1.0)


def test_sampling_is_in_range_and_deterministic():
    _, tcfg, _, model = _pair(torch.float32)
    prompt = _tokens((3, 4), 1)
    draw = lambda s: TT.generate(model, prompt, 10, tcfg, temperature=0.8,
                                 generator=torch.Generator().manual_seed(s))
    a, b, c = draw(0), draw(0), draw(1)
    assert a.shape == (3, 14)
    assert int(a.min()) >= 0 and int(a.max()) < SMALL["vocab"]
    np.testing.assert_array_equal(a[:, :4].numpy(), prompt)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_init_params_shapes_scales_and_seed():
    cfg = TT.Config(**SMALL, dtype=torch.bfloat16)
    a = TT.init_params(cfg, torch.Generator().manual_seed(0))
    b = TT.init_params(cfg, torch.Generator().manual_seed(0))
    for (na, pa), (nb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb and torch.equal(pa, pb) and pa.dtype == torch.bfloat16
    assert a.embed.shape == (64, 32) and a.blocks[0].w1.shape == (32, 128)
    assert torch.equal(a.ln_f, torch.ones(32, dtype=torch.bfloat16))
    # normal * sqrt(1/fan_in): std about fan_in ** -0.5
    assert abs(float(a.blocks[0].w2.float().std()) - 128 ** -0.5) < 0.02
    logits = TT.forward(a, _tokens((2, 16), 2), cfg)
    assert torch.isfinite(logits).all()


# ---------------------------------------------------------------------------
# training: loss_fn and train_step
# ---------------------------------------------------------------------------


def test_loss_fn_matches_jax_and_serving_builds_no_graph():
    jcfg, tcfg, jp, model = _pair(torch.float32)
    tok = _tokens((3, 12), 20)
    want = float(JT.loss_fn(jp, tok, jcfg))
    got = TT.loss_fn(model, tok, tcfg)
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    # the parameters serve without a graph: forward's logits need no grad
    assert not got.requires_grad
    assert not TT.forward(model, tok, tcfg).requires_grad


def test_train_step_matches_jax_f32():
    jcfg, tcfg, jp, model = _pair(torch.float32)
    for step in range(3):
        tok = _tokens((2, 13), 30 + step)
        jp, jl = JT.train_step(jp, tok, 0.5, jcfg)
        model2, tl = TT.train_step(model, tok, 0.5, tcfg)
        assert model2 is model and not tl.requires_grad
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert all(not p.requires_grad for p in model.parameters())
    back = tdat.params_to_reference(model)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), rtol=1e-4,
                                   atol=1e-5)


def test_train_step_bf16_updates_in_f32_arithmetic():
    # bf16 parameters: the update is computed in f32 and rounded once
    jcfg, tcfg, jp, model = _pair(torch.bfloat16)
    tok = _tokens((2, 9), 40)
    before = [p.detach().clone() for p in model.parameters()]
    ps = list(model.parameters())
    loss, grads = value_and_grad(lambda: TT.loss_fn(model, tok, tcfg), ps)
    _, tl = TT.train_step(model, tok, 2.0, tcfg)
    assert float(tl) == float(loss)
    for p, p0, g in zip(model.parameters(), before, grads):
        assert p.dtype == torch.bfloat16
        assert torch.equal(p, (p0.float() - 2.0 * g.float()).bfloat16())
    _, jl = JT.train_step(jp, tok, 2.0, jcfg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=3e-2)


def test_optax_train_step_matches_jax_adam():
    # eps 1e-3 keeps Adam's first steps, about lr * g / (|g| + eps), from
    # magnifying the gradients' last-bit differences where |g| is near eps
    optax = pytest.importorskip("optax")
    jcfg, tcfg, jp, model = _pair(torch.float32)
    jstep, jinit = JT.make_optax_train_step(jcfg, optax.adam(1e-2, eps=1e-3))
    tstep, tinit = TT.make_optax_train_step(tcfg,
                                            tdat.train.adam(1e-2, eps=1e-3))
    jstate, state = jinit(jp), tinit(model)
    for step in range(2):
        tok = _tokens((2, 13), 50 + step)
        jp, jstate, jl = jstep(jp, jstate, tok)
        model2, state, tl = tstep(model, state, tok)
        assert model2 is model and not tl.requires_grad
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert state["t"] == 2
    back = tdat.params_to_reference(model)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)


def test_optax_train_step_bf16_updates_in_f32_arithmetic():
    # bf16 parameters: the Adam step runs on f32 copies of the parameters
    # and gradients, from f32 moments, and is rounded once to bf16
    _, tcfg, _, model = _pair(torch.bfloat16)
    opt = tdat.train.adam(1e-2)
    step, init = TT.make_optax_train_step(tcfg, opt)
    tok = _tokens((2, 9), 60)
    ps = list(model.parameters())
    before = [p.detach().clone() for p in ps]
    loss, grads = value_and_grad(lambda: TT.loss_fn(model, tok, tcfg), ps)
    state = init(model)
    assert all(s.dtype == torch.float32 for sl in state["slots"] for s in sl)
    _, state, tl = step(model, state, tok)
    assert float(tl) == float(loss)
    for p, p0, g, sl in zip(model.parameters(), before, grads,
                            init(model)["slots"]):
        new, m, v = opt.update(1, p0.float(), g.float(), sl)
        assert p.dtype == torch.bfloat16 and torch.equal(p, new.bfloat16())
