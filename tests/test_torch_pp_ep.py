"""The pipeline (``models/pipeline.py``) and expert-parallel MoE
(``models/moe.py``) of the PyTorch port against the JAX package: each
case of ``tests/test_pp_ep.py``, with the JAX function and the port fed the
same numpy weights and inputs (JAX's initial parameters, crossed with
``params_from_reference``).

Tolerances: forward and gradients 1e-5 absolute against JAX in f32 (the
same products in another order); multi-layer stages 2e-4 as the JAX test
holds its own; MoE 1e-5 against JAX's output and 2e-4 against
``reference_moe`` (top-2 sums two gated FFNs).  On the CPU the MoE
exchanges run the plain all-to-all; ``test_moe_exchange_goes_through_
ring_all_to_all`` checks that the forward calls ``ring_all_to_all`` (K11
on CUDA tensors) exactly twice.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributedarrays_tpu.models import moe as JM
from distributedarrays_tpu.models import pipeline as JP
from distributedarrays_tpu_torch.models import moe as TM
from distributedarrays_tpu_torch.models import pipeline as TP

from _torch_port import jax_plan_cache, jax_process_state, port_ranks  # noqa: F401

_JAX = {}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _pp_params(key, stages, hidden, n_layers=1):
    jp = _np(JP.init_pipeline_params(jax.random.key(key), stages, hidden,
                                     n_layers=n_layers))
    return jp, TP.params_from_reference(jp, list(range(stages)))


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stages,hidden,shape,n_layers", [
    (4, 32, (6, 8, 32), 1),          # test_pipeline_matches_sequential
    (8, 16, (1, 4, 16), 1),          # ..._eight_stages_single_microbatch
    (4, 16, (5, 2, 16), 3),          # ..._multilayer_stages_match_sequential
])
def test_pipeline_forward_matches_jax_and_sequential(stages, hidden, shape,
                                                     n_layers):
    jp, tp = _pp_params(stages, stages, hidden, n_layers)
    mb = _normal(stages + hidden, shape)
    want = np.asarray(JP.pipeline_forward(jp, mb, JP.make_pp_mesh(stages)))
    mesh = TP.make_pp_mesh(stages)
    got = TP.pipeline_forward(tp, _t(mb), mesh)
    assert got.shape == shape and got.dtype == torch.float32
    tol = 1e-5 if n_layers == 1 else 2e-4
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    np.testing.assert_allclose(got.numpy(),
                               TP.reference_forward(tp, mb).numpy(),
                               rtol=0, atol=tol)
    assert [tuple(w.shape) for w in tp["W"]] == \
        [(n_layers, hidden, hidden)] * stages


def _jax_grads(jp, mb, tgt, mesh):
    def loss(p):
        return jnp.mean((JP.pipeline_forward(p, mb, mesh) - tgt) ** 2)
    return _np(jax.grad(loss)(jp))


def test_pipeline_gradients_match_jax_and_sequential():
    jp, tp = _pp_params(0, 4, 16)
    mb, tgt = _normal(1, (4, 8, 16)), _normal(2, (4, 8, 16))
    want = _jax_grads(jp, mb, tgt, JP.make_pp_mesh(4))
    mesh = TP.make_pp_mesh(4)
    leaves = [x.requires_grad_(True) for x in tp["W"] + tp["b"]]
    loss = torch.mean((TP.pipeline_forward(tp, _t(mb), mesh) - _t(tgt)) ** 2)
    g = torch.autograd.grad(loss, leaves)
    ref = torch.mean((TP.reference_forward(tp, mb) - _t(tgt)) ** 2)
    gr = torch.autograd.grad(ref, leaves)
    for name, got, seq in (("W", g[:4], gr[:4]), ("b", g[4:], gr[4:])):
        got = np.stack([x.numpy() for x in got])
        np.testing.assert_allclose(got, want[name], rtol=0, atol=1e-5)
        np.testing.assert_allclose(got, np.stack([x.numpy() for x in seq]),
                                   rtol=0, atol=1e-6)


def _jax_steps(key, stages, hidden, n_layers, shape, lr):
    """JAX's GPipe and 1F1B steps from one initial state, cached."""
    ck = (key, stages, hidden, n_layers, shape, lr)
    if ck not in _JAX:
        jp, _ = _pp_params(key, stages, hidden, n_layers)
        mb = _normal(key + 1, shape)
        tgt = _normal(key + 2, shape)
        mesh = JP.make_pp_mesh(stages)
        pg, lg = JP.pipeline_train_step(jp, mb, tgt, mesh, lr=lr)
        pf, lf = JP.pipeline_train_step_1f1b(jp, mb, tgt, mesh, lr=lr)
        _JAX[ck] = (jp, mb, tgt, (_np(pg), float(lg)), (_np(pf), float(lf)))
    return _JAX[ck]


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
@pytest.mark.parametrize("key,stages,hidden,n_layers,shape,lr", [
    (0, 4, 16, 2, (6, 3, 16), 0.05),   # test_1f1b_matches_gpipe_gradients
    (3, 2, 8, 1, (9, 2, 8), 0.1),      # test_1f1b_more_microbatches_than_ring
])
def test_train_steps_match_jax(schedule, key, stages, hidden, n_layers,
                               shape, lr):
    jp, mb, tgt, jg, jf = _jax_steps(key, stages, hidden, n_layers, shape,
                                     lr)
    tp = TP.params_from_reference(jp, list(range(stages)))
    step = TP.pipeline_train_step if schedule == "gpipe" else \
        TP.pipeline_train_step_1f1b
    new, loss = step(tp, _t(mb), _t(tgt), TP.make_pp_mesh(stages), lr=lr)
    out = TP.params_to_reference(new)
    for want_p, want_l in (jg, jf):
        np.testing.assert_allclose(float(loss), want_l, rtol=1e-5, atol=1e-6)
        for name in ("W", "b"):
            # the step's change, lr * gradient, against JAX's within 1e-5
            np.testing.assert_allclose((jp[name] - out[name]) / lr,
                                       (jp[name] - want_p[name]) / lr,
                                       rtol=0, atol=1e-5)
    assert all(not t.requires_grad for t in new["W"] + new["b"])


def test_1f1b_equals_gpipe_and_keeps_the_old_shape():
    # the (S, H, H) stage shape reads as L = 1 and comes back as it went
    jp, tp = _pp_params(5, 3, 8)
    old = {"W": [w[0] for w in tp["W"]], "b": [b[0] for b in tp["b"]]}
    mb, tgt = _t(_normal(6, (7, 2, 8))), _t(_normal(7, (7, 2, 8)))
    mesh = TP.make_pp_mesh(3)
    pg, lg = TP.pipeline_train_step(old, mb, tgt, mesh, lr=0.1)
    pf, lf = TP.pipeline_train_step_1f1b(old, mb, tgt, mesh, lr=0.1)
    assert [tuple(w.shape) for w in pf["W"]] == [(8, 8)] * 3
    assert [tuple(b.shape) for b in pg["b"]] == [(8,)] * 3
    np.testing.assert_allclose(float(lf), float(lg), rtol=1e-6)
    for a, b in zip(pf["W"] + pf["b"], pg["W"] + pg["b"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pipeline_training_decreases_loss(schedule):
    # test_pipeline_train_step_decreases_loss (GPipe: one layer a stage, a
    # zero target, 25 steps) and test_1f1b_training_decreases_loss (two
    # layers, tanh target, 30 steps, monotone)
    # JAX's initial weights and microbatches (the same keys), so the port
    # trains from the JAX test's starting point
    if schedule == "gpipe":
        _, tp = _pp_params(3, 4, 16)
        mb = _t(np.asarray(jax.random.normal(jax.random.key(4), (4, 8, 16))))
        tgt, step, lr, n = torch.zeros_like(mb), TP.pipeline_train_step, \
            0.1, 25
    else:
        _, tp = _pp_params(7, 4, 16, n_layers=2)
        mb = _t(np.asarray(jax.random.normal(jax.random.key(8), (4, 4, 16))))
        tgt, step, lr, n = torch.tanh(mb), TP.pipeline_train_step_1f1b, \
            0.5, 30
    mesh = TP.make_pp_mesh(4)
    losses = []
    for _ in range(n):
        tp, loss = step(tp, mb, tgt, mesh, lr=lr)
        losses.append(float(loss))
    if schedule == "gpipe":
        assert losses[-1] < losses[0] * 0.5, losses[:3] + losses[-3:]
    else:
        assert losses[-1] < losses[0], losses
        assert all(b <= a + 1e-6 for a, b in zip(losses, losses[1:]))


def test_pipeline_validation():
    mesh = TP.make_pp_mesh(4)
    tp = TP.init_pipeline_params(torch.Generator().manual_seed(0), 2, 8)
    with pytest.raises(ValueError, match="stages"):
        TP.pipeline_forward(tp, torch.zeros(2, 2, 8), mesh)
    tp4 = TP.init_pipeline_params(torch.Generator().manual_seed(0), 4, 8)
    with pytest.raises(ValueError, match="microbatches"):
        TP.pipeline_forward(tp4, torch.zeros(2, 8), mesh)
    with pytest.raises(ValueError, match="stages"):
        TP.pipeline_train_step_1f1b(tp, torch.zeros(2, 2, 8),
                                    torch.zeros(2, 2, 8), mesh)


def test_init_pipeline_params_scale_and_placement():
    tp = TP.init_pipeline_params(torch.Generator().manual_seed(1), 4, 64,
                                 n_layers=2)
    W = torch.stack(tp["W"])
    assert W.shape == (4, 2, 64, 64) and not torch.stack(tp["b"]).any()
    assert abs(float(W.std()) - (1 / 64) ** 0.5) < 0.01


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def _moe_params(key, E=4, H=16, F=32):
    jp = _np(JM.init_moe_params(jax.random.key(key), E, H, F))
    return jp, TM.params_from_reference(jp, list(range(E)))


@pytest.mark.parametrize("key,xkey,capacity,k,cf", [
    (0, 1, 8, 1, None),      # test_moe_no_drop_matches_oracle
    (0, 1, 1, 1, None),      # test_moe_capacity_overflow_passthrough
    (0, 1, 8, 2, None),      # test_moe_top2_matches_oracle
    (2, 3, 1, 2, None),      # test_moe_top2_capacity_overflow
    (6, 7, None, 1, 8.0),    # test_moe_capacity_factor_default
])
def test_moe_matches_jax_and_reference(key, xkey, capacity, k, cf):
    jp, tp = _moe_params(key)
    x = _normal(100 + xkey, (32, 16))
    kw = dict(capacity=capacity, k=k)
    if cf is not None:
        kw["capacity_factor"] = cf
    want, jaux = JM.moe_forward(jp, x, JM.make_ep_mesh(4), return_aux=True,
                                **kw)
    got, aux = TM.moe_forward(tp, _t(x), TM.make_ep_mesh(4), return_aux=True,
                              **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    cap = 8 if capacity is None else capacity   # cf 8: ceil(8*8/4) = 16
    ref = TM.reference_moe(tp, x, cap, 4, k=k)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-4,
                               atol=2e-4)
    if capacity == 1:
        # some tokens MUST pass through unchanged
        assert np.any(np.all(got.numpy() == x, axis=1))


def test_moe_exchange_goes_through_ring_all_to_all(monkeypatch):
    calls = []
    real = TM.ring_all_to_all

    def spy(blocks, split_dim, concat_dim):
        calls.append((len(blocks), tuple(blocks[0].shape), split_dim,
                      concat_dim))
        return real(blocks, split_dim, concat_dim)
    monkeypatch.setattr(TM, "ring_all_to_all", spy)
    _, tp = _moe_params(0)
    TM.moe_forward(tp, _t(_normal(5, (32, 16))), TM.make_ep_mesh(4), k=2)
    # capacity ceil(2 * 2 * 8 / 4) = 8: two (E, C, H) exchanges over dim 0
    assert calls == [(4, (4, 8, 16), 0, 0)] * 2


def test_moe_aux_loss_matches_dense_and_uniform_router():
    jp, tp = _moe_params(4)
    x = _normal(105, (32, 16))
    _, aux = TM.moe_forward(tp, _t(x), TM.make_ep_mesh(4), capacity=8, k=2,
                            return_aux=True)
    E, n_local = 4, 8
    auxes = []
    for r in range(E):
        xs = x[r * n_local:(r + 1) * n_local]
        logits = xs @ jp["Wg"]
        pz = np.exp(logits - logits.max(-1, keepdims=True))
        pz = pz / pz.sum(-1, keepdims=True)
        f = np.bincount(pz.argmax(-1), minlength=E) / n_local
        auxes.append(E * float((f * pz.mean(0)).sum()))
    np.testing.assert_allclose(float(aux), np.mean(auxes), rtol=1e-4,
                               atol=1e-5)
    # uniform router -> aux 1 (the balanced minimum)
    tu = dict(tp, Wg=[torch.zeros_like(w) for w in tp["Wg"]])
    _, aux_u = TM.moe_forward(tu, _t(x), TM.make_ep_mesh(4), return_aux=True)
    np.testing.assert_allclose(float(aux_u), 1.0, rtol=1e-5)


def test_moe_bf16_router_ties_take_the_lower_expert():
    # a router whose bf16 probabilities tie between six of eight experts:
    # lax.top_k picks the lowest indices first (0, then 1); torch.topk
    # does not promise that (on the CPU it returns 6 before 0 here)
    E, H = 8, 8
    gen = torch.Generator().manual_seed(11)
    tp = TM.init_moe_params(gen, E, H, 16, dtype=torch.bfloat16)
    wg = torch.zeros(H, E, dtype=torch.bfloat16)
    wg[0, [0, 1, 3, 4, 6, 7]] = 1.0
    wg[0, 2] = 0.5
    tp["Wg"] = [wg.clone() for _ in range(E)]
    x = torch.randn(4 * E, H, generator=gen).to(torch.bfloat16)
    x[:, 0] = x[:, 0].abs() + 1.0
    probs = torch.softmax(x @ wg, dim=-1)
    gate, eidx = TM._top_k(probs, 2)
    assert (eidx[:, 0] == 0).all() and (eidx[:, 1] == 1).all()
    assert torch.equal(gate[:, 0], gate[:, 1])
    jx = jax.lax.top_k(jnp.asarray(probs.float().numpy(), jnp.bfloat16), 2)
    np.testing.assert_array_equal(eidx.numpy(), np.asarray(jx[1]))
    out = TM.moe_forward(tp, x, TM.make_ep_mesh(E), k=2, capacity=4 * E)
    want = TM.reference_moe(tp, x.float(), 4 * E, E, k=2)
    np.testing.assert_allclose(out.float().numpy(), want.numpy(), rtol=5e-2,
                               atol=5e-2)


def test_moe_validation():
    mesh = TM.make_ep_mesh(4)
    gen = torch.Generator().manual_seed(0)
    p2 = TM.init_moe_params(gen, 2, 16, 32)
    with pytest.raises(ValueError, match="experts"):
        TM.moe_forward(p2, torch.zeros(8, 16), mesh)
    p4 = TM.init_moe_params(gen, 4, 16, 32)
    with pytest.raises(ValueError, match="divisible"):
        TM.moe_forward(p4, torch.zeros(9, 16), mesh)
    with pytest.raises(ValueError, match="capacity"):
        TM.moe_forward(p4, torch.zeros(8, 16), mesh, capacity=0)
    with pytest.raises(ValueError, match="k must be"):
        TM.moe_forward(p4, torch.zeros(8, 16), mesh, k=5)


def test_moe_params_round_trip_and_init():
    jp, tp = _moe_params(9)
    back = TM.params_to_reference(tp)
    for name in ("Wg", "W1", "W2"):
        np.testing.assert_array_equal(back[name], jp[name])
    ti = TM.init_moe_params(torch.Generator().manual_seed(0), 4, 64, 128)
    assert len(ti["Wg"]) == 4 and ti["W1"][0].shape == (64, 128)
    assert abs(float(torch.stack(ti["W1"]).std()) - (2 / 64) ** 0.5) < 0.02
