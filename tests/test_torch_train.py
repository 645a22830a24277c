"""The training half of the PyTorch port against the JAX package: the MLP
(``models/mlp.py``), the flat-vector optimizers, the training tasks and
the data-parallel ``Trainer`` (K10 all-gather and K12 reduce-scatter,
their plain versions on the CPU).

Both trainers start from the same weights (the JAX task's initial pytree,
handed to the port's task as tensors) and see identical batches (the same
numpy generator).  Tolerances: losses rtol 1e-5 for the MLP and 1e-4 for
the transformer task in f32 (matrix products and reductions summed in
other orders, through a few steps of training); the flat parameters rtol
1e-4 / atol 1e-6.  The port's reduce-scatter sums in the TPU ring's order
and the JAX trainer's off-TPU fallback in XLA's, another rounding-level
difference.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import distributedarrays_tpu_torch as tdat
from distributedarrays_tpu.models import mlp as JM
from distributedarrays_tpu.resilience import elastic, faults
from distributedarrays_tpu.telemetry import flight
from distributedarrays_tpu.train import optim as JO
from distributedarrays_tpu.train import tasks as JTasks
from distributedarrays_tpu.train import trainer as JTrainer
from distributedarrays_tpu_torch.models import mlp as TM
from distributedarrays_tpu_torch.train import optim as TO
from distributedarrays_tpu_torch.train import tasks as TTasks

from _torch_port import port_ranks  # noqa: F401


@pytest.fixture(autouse=True)
def _clean_chaos():
    """The JAX trainer's process-wide singletons, pristine around every
    test (as in tests/test_train.py)."""
    faults.clear()
    elastic.manager().reset()
    flight._reset()
    yield
    faults.clear()
    elastic.manager().reset()
    flight._reset()


def _tensors(tree):
    return jax.tree_util.tree_map(
        lambda x: torch.from_numpy(np.array(x, np.float32)), tree)


def _jax_init(jtask, seed=0):
    return jax.tree_util.tree_map(np.asarray,
                                  jtask.init_params(jax.random.PRNGKey(seed)))


def _same_init(ptask, jtask):
    ref = _jax_init(jtask)
    return dataclasses.replace(ptask, init_params=lambda gen: _tensors(ref))


# ---------------------------------------------------------------------------
# models/mlp.py
# ---------------------------------------------------------------------------


def _mlp_data(seed, b=12, sizes=(6, 10, 4)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sizes[0])).astype(np.float32),
            rng.standard_normal((b, sizes[-1])).astype(np.float32))


def test_mlp_forward_loss_and_train_step_match_jax():
    sizes = (6, 10, 4)
    jp = JM.init_params(jax.random.PRNGKey(3), sizes, dtype=jnp.float32)
    tp = _tensors(jax.tree_util.tree_map(np.asarray, jp))
    x, y = _mlp_data(1)
    np.testing.assert_allclose(
        TM.forward(tp, torch.from_numpy(x)).numpy(),
        np.asarray(JM.forward(jp, x)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        float(TM.loss_fn(tp, torch.from_numpy(x), torch.from_numpy(y))),
        float(JM.loss_fn(jp, x, y)), rtol=1e-5)
    for step in range(3):
        x, y = _mlp_data(10 + step)
        jp, jl = JM.train_step(jp, x, y, lr=5e-2)
        tp, tl = TM.train_step(tp, torch.from_numpy(x), torch.from_numpy(y),
                               lr=5e-2)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for a, b in zip(tdat.train.tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        assert not a.requires_grad
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)


def test_mlp_init_params_shapes_scale_and_seed():
    a = TM.init_params(torch.Generator().manual_seed(0), (64, 32, 8))
    b = TM.init_params(torch.Generator().manual_seed(0), (64, 32, 8))
    assert [tuple(l["w"].shape) for l in a] == [(64, 32), (32, 8)]
    assert all(l["w"].dtype == torch.bfloat16 for l in a)
    assert all(torch.equal(u["w"], v["w"]) for u, v in zip(a, b))
    assert not a[0]["b"].any()
    assert abs(float(a[0]["w"].float().std()) - (2 / 64) ** 0.5) < 0.03


# ---------------------------------------------------------------------------
# train/optim.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("opt", [dict(kind="sgd", lr=0.1),
                                 dict(kind="sgd", lr=0.1, momentum=0.9),
                                 dict(kind="adam", lr=1e-2)])
def test_optimizer_updates_match_jax(opt):
    jo, to = JO.Optimizer(**opt), TO.Optimizer(**opt)
    assert to.nslots == jo.nslots
    rng = np.random.default_rng(4)
    p = rng.standard_normal(37).astype(np.float32)
    jst = (p,) + tuple(np.asarray(s) for s in jo.init_slots(37))
    tst = (torch.from_numpy(p),) + to.init_slots(37)
    for t in (1, 2, 3):
        g = rng.standard_normal(37).astype(np.float32)
        jst = jo.update(jnp.int32(t), jst[0], g, jst[1:])
        tst = to.update(t, tst[0], torch.from_numpy(g), tst[1:])
        for a, b in zip(tst, jst):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)


def test_optimizer_zero_gradient_is_a_fixed_point_and_kinds_validate():
    for o in (TO.sgd(0.1), TO.sgd(0.1, 0.9), TO.adam(1e-2)):
        p = torch.zeros(4)
        out = o.update(1, p, torch.zeros(4), o.init_slots(4))
        assert all(not x.any() for x in out)
    with pytest.raises(ValueError, match="unknown optimizer"):
        TO.Optimizer(kind="lamb")


# ---------------------------------------------------------------------------
# train/tasks.py and the flat leaf order
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("make", ["mlp_task", "transformer_task"])
def test_task_batches_and_leaf_order_match_jax(make):
    kw = dict(batch_size=10) if make == "mlp_task" else dict(
        vocab=32, dim=16, heads=2, layers=2, seq=8, batch_size=6)
    jt, tt = getattr(JTasks, make)(**kw), getattr(TTasks, make)(**kw)
    assert tt.name == jt.name and tt.step_flops(4) == jt.step_flops(4)
    for step in range(3):
        for a, b in zip(tt.batch(step), jt.batch(step)):
            np.testing.assert_array_equal(a, b)
    # the port's tree has the JAX tree's structure, leaves in its order
    ref = _jax_init(jt)
    mine = tt.init_params(torch.Generator().manual_seed(0))
    flat_ref, tree_ref = jax.tree_util.tree_flatten(ref)
    flat_mine, tree_mine = jax.tree_util.tree_flatten(
        jax.tree_util.tree_map(lambda t: t.numpy(), mine))
    assert tree_mine == tree_ref
    assert [a.shape for a in flat_mine] == [a.shape for a in flat_ref]
    assert all(a is b for a, b in zip(tdat.train.tree_leaves(ref), flat_ref))


def test_transformer_task_loss_sum_matches_jax():
    kw = dict(vocab=32, dim=16, heads=2, layers=1, seq=8, batch_size=5)
    jt, tt = JTasks.transformer_task(**kw), TTasks.transformer_task(**kw)
    ref = _jax_init(jt)
    (tok,) = jt.batch(0)
    w = np.array([1, 1, 0.5, 0, 1], np.float32)
    want = float(jt.loss_sum(ref, (tok,), w))
    got = float(tt.loss_sum(_tensors(ref), (torch.from_numpy(tok),),
                            torch.from_numpy(w)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


# ---------------------------------------------------------------------------
# train/trainer.py
# ---------------------------------------------------------------------------


def _pair(jtask, ptask, opt, ranks, steps):
    jopt = JO.Optimizer(**opt)
    with JTrainer.Trainer(jtask, optimizer=jopt, ranks=ranks, seed=0) as jt:
        jres = jt.fit(steps)
        jflat = np.asarray(jt._state["pflat"])
    with tdat.Trainer(_same_init(ptask, jtask), TO.Optimizer(**opt),
                      ranks=ranks) as t:
        res = t.fit(steps)
        flat = t.flat_params().numpy()
    return jres, jflat, res, flat


@pytest.mark.parametrize("opt", [dict(kind="sgd", lr=5e-2),
                                 dict(kind="sgd", lr=5e-2, momentum=0.9),
                                 dict(kind="adam", lr=1e-2)])
def test_trainer_mlp_matches_jax_on_4_ranks(opt):
    jres, jflat, res, flat = _pair(JTasks.mlp_task(batch_size=56),
                                   TTasks.mlp_task(batch_size=56), opt,
                                   [0, 1, 2, 3], 5)
    assert res["start"] == jres["start"] == 0 and res["steps"] == 5
    np.testing.assert_allclose(res["losses"], jres["losses"], rtol=1e-5)
    assert res["losses"][-1] < res["losses"][0]
    np.testing.assert_allclose(flat, jflat, rtol=1e-4, atol=1e-6)


def test_trainer_transformer_task_matches_jax_f32():
    kw = dict(vocab=32, dim=16, heads=2, layers=1, seq=8, batch_size=16)
    jres, jflat, res, flat = _pair(JTasks.transformer_task(**kw),
                                   TTasks.transformer_task(**kw),
                                   dict(kind="adam", lr=3e-3), [0, 1, 2, 3],
                                   3)
    np.testing.assert_allclose(res["losses"], jres["losses"], rtol=1e-4)
    assert res["losses"][-1] < res["losses"][0]
    np.testing.assert_allclose(flat, jflat, rtol=1e-4, atol=1e-6)


def test_trainer_uneven_batch_and_params_match_one_rank_and_jax():
    # batch 30 over 4 ranks pads to 32 with weight-0 rows; the 66-element
    # flat vector pads to 68 (shards of 17; the DArray's cuts end at 66)
    kw = dict(sizes=(5, 7, 3), batch_size=30)
    jtask, ptask = JTasks.mlp_task(**kw), TTasks.mlp_task(**kw)
    opt = dict(kind="adam", lr=1e-2)
    jres, jflat, res4, flat4 = _pair(jtask, ptask, opt, [0, 1, 2, 3], 3)
    with tdat.Trainer(_same_init(ptask, jtask), TO.Optimizer(**opt),
                      ranks=[0]) as t1:
        res1 = t1.fit(3)
        flat1 = t1.flat_params().numpy()
    assert flat4.shape == (66,)
    np.testing.assert_allclose(res4["losses"], res1["losses"], rtol=1e-5)
    np.testing.assert_allclose(flat4, flat1, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(res4["losses"], jres["losses"], rtol=1e-5)
    np.testing.assert_allclose(flat4, jflat, rtol=1e-4, atol=1e-6)


def test_trainer_is_bitwise_deterministic_and_closes():
    def run():
        with tdat.Trainer(TTasks.mlp_task(batch_size=24), TO.adam(1e-2),
                          ranks=[0, 1, 2]) as t:
            res = t.fit(3)
            assert t.step == 3 and sorted(t.losses()) == [0, 1, 2]
            assert t.step_once() == t.losses()[3]
            return res["losses"], t.flat_params()
    (la, fa), (lb, fb) = run(), run()
    assert la == lb and torch.equal(fa, fb)
    assert tdat.live_ids() == []
    t = tdat.Trainer(TTasks.mlp_task(batch_size=8), ranks=[0, 1])
    t.close()
    with pytest.raises(RuntimeError, match="closed"):
        t.fit(1)
    with pytest.raises(RuntimeError, match="closed"):
        t.step_once()
    # the runtime tier's arguments are part of the signature; one the JAX
    # trainer does not take is refused
    with pytest.raises(TypeError):
        tdat.Trainer(TTasks.mlp_task(), store="orbax")


def test_straggler_detector_and_fit_result():
    det = tdat.train.StragglerDetector(factor=2.0, min_budget_s=0.1,
                                       warmup=3)
    assert det.budget() is None and det.observe(5.0) is False
    for _ in range(3):
        det.observe(0.01)
    assert det.budget() == pytest.approx(10.0)
    assert det.observe(11.0) is True and det.observe(0.01) is False
    assert tdat.train.fit_result([3, 2, 1], 1) == [2, 1]
