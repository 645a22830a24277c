"""The GSPMD tp/dp layouts of the JAX models on the PyTorch port
(``models/tp_dp.py``, ``models/mlp.py``, ``models/transformer.py``),
held against the JAX package on the same numpy parameters and batches.

Meshes: ``make_mesh(8)`` (4, 2), ``make_mesh(4)`` (2, 2) and an (8, 1)
mesh, on 8 CPU ranks.  Tolerances: f32 losses, logits, gradients and
parameters ``atol 1e-5`` (the tp partial sums and the dp sums fold in
another order than XLA's); bf16 parameters within 2 ulp of the
parameter's scale (``BF16_ULPS``); greedy tokens and layout round trips
exact.  The JAX flash kernel runs as ``tests/test_transformer.py`` runs it
on the CPU.  A 2-process job of 4 ranks each (``_torch_multihost_child.py``
with its ``tp_dp`` stage) is bit-equal to one process on 8 ranks."""

import copy
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import distributedarrays_tpu as dat
from distributedarrays_tpu.models import mlp as JM
from distributedarrays_tpu.models import transformer as JT
import distributedarrays_tpu_torch as tdat
from distributedarrays_tpu_torch import interop
from distributedarrays_tpu_torch.models import mlp as TM
from distributedarrays_tpu_torch.models import tp_dp
from distributedarrays_tpu_torch.models import transformer as TT

import _torch_mh_legs as LEGS
from _torch_port import (jax_plan_cache, jax_process_state,  # noqa: F401
                         port_ranks, run_job)

ATOL = 1e-5
BF16_ULPS = 2
MESHES = {"4x2": (4, 2), "2x2": (2, 2), "8x1": (8, 1)}
TF_CFG = dict(vocab=32, dim=64, heads=4, layers=2, max_seq=32)


def meshes(shape):
    """The JAX mesh and the port's mesh of one (dp, tp) shape: JAX's and
    the port's ``make_mesh`` where it gives that shape."""
    dp, tp = shape
    n = dp * tp
    if tp == (2 if n % 2 == 0 and n >= 2 else 1):
        return JM.make_mesh(n), TM.make_mesh(n)
    return (JaxMesh(np.asarray(jax.devices()[:n]).reshape(dp, tp),
                    ("dp", "tp")),
            tp_dp.Mesh(np.arange(n).reshape(dp, tp)))


def mlp_params(sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((a, b)) * np.sqrt(2 / a)).astype(
                 np.float32),
             "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
            for a, b in zip(sizes, sizes[1:])]


def bf16_scale_ulps(got: np.ndarray, want: np.ndarray) -> float:
    """The largest difference in units of the bf16 spacing at the
    parameter's scale (its largest magnitude)."""
    scale = float(np.abs(want).max())
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7) if scale else 2.0 ** -133
    return float(np.abs(got - want).max() / ulp)


# ---------------------------------------------------------------------------
# the surface
# ---------------------------------------------------------------------------


def test_exports_cover_jax_all():
    assert set(JM.__all__) <= set(TM.__all__)
    assert set(JT.__all__) <= set(TT.__all__)
    assert TT.make_mesh is TM.make_mesh is tp_dp.make_mesh


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_make_mesh_shape_like_jax(n):
    jm, tm = JM.make_mesh(n), TM.make_mesh(n)
    assert dict(jm.shape) == tm.shape
    assert tm.axis_names == tuple(jm.axis_names) == ("dp", "tp")
    assert tm.flat == [d.id for d in jm.devices.flat]


# ---------------------------------------------------------------------------
# the MLP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("sizes", [[32, 64, 16], [32, 64, 64, 16]],
                         ids=["3_layers", "4_layers"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_train_steps_match_jax(dtype, sizes, mesh):
    jmesh, tmesh = meshes(MESHES[mesh])
    ps = mlp_params(sizes)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((32, sizes[0])).astype(np.float32)
    y = rng.standard_normal((32, sizes[-1])).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    jp = JM.shard_params([{k: jnp.asarray(v, jdt) for k, v in layer.items()}
                          for layer in ps], jmesh)
    tp = TM.shard_params([{k: torch.from_numpy(v).to(tdt)
                           for k, v in layer.items()} for layer in ps], tmesh)
    jx, jy = JM.shard_batch(jnp.asarray(x, jdt), jnp.asarray(y, jdt), jmesh)
    tx, ty = TM.shard_batch(torch.from_numpy(x).to(tdt),
                            torch.from_numpy(y).to(tdt), tmesh)
    np.testing.assert_allclose(
        np.asarray(JM.forward(jp, jx), np.float32),
        TM.forward(tp, tx).float().numpy(),
        atol=ATOL if dtype == "float32" else 5e-2)
    for _ in range(5):
        jp, jl = JM.train_step(jp, jx, jy, lr=1e-2)
        tp, tl = TM.train_step(tp, tx, ty, lr=1e-2)
        np.testing.assert_allclose(float(tl), float(jl),
                                   atol=ATOL if dtype == "float32" else 1e-2)
    got = TM.unshard(tp)
    for i, layer in enumerate(jp):
        for k in "wb":
            g = got[i][k].float().numpy()
            w = np.asarray(layer[k], np.float32)
            if dtype == "float32":
                np.testing.assert_allclose(g, w, atol=ATOL)
            else:
                assert bf16_scale_ulps(g, w) <= BF16_ULPS, (i, k)


def test_mlp_bf16_loss_falls_like_jax_test():
    # the port's twin of tests/test_models.py::
    # test_mlp_train_step_loss_decreases (bf16, make_mesh(8), 20 steps)
    mesh = TM.make_mesh(8)
    gen = torch.Generator().manual_seed(0)
    params = TM.shard_params(TM.init_params(gen, [32, 64, 16]), mesh)
    x = torch.randn((32, 32), generator=gen).bfloat16()
    y = torch.randn((32, 16), generator=gen).bfloat16()
    x, y = TM.shard_batch(x, y, mesh)
    losses = [float(TM.train_step(params, x, y, lr=1e-2)[1])
              for _ in range(20)]
    assert losses[-1] < losses[0] * 0.9, losses[:3] + losses[-3:]


# ---------------------------------------------------------------------------
# the transformer
# ---------------------------------------------------------------------------


def tf_setup(shape, dtype="float32"):
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    jcfg = JT.Config(**TF_CFG, dtype=jdt)
    tcfg = TT.Config(**TF_CFG, dtype=tdt)
    np_params = jax.tree_util.tree_map(
        np.asarray, JT.init_params(jax.random.key(0), jcfg))
    jmesh, tmesh = meshes(shape)
    jp = JT.shard_params(jax.tree_util.tree_map(jnp.asarray, np_params),
                         jmesh)
    tp = TT.shard_params(interop.params_from_reference(np_params, tcfg),
                         tmesh)
    start = np.random.default_rng(1).integers(0, 32, (16, 1))
    tokens = ((start + np.arange(17)[None]) % 32).astype(np.int32)
    return jcfg, tcfg, jp, tp, tokens


def unshard_grads(sp, grads):
    """The per-rank gradients as one JAX-shaped pytree (float32 numpy)."""
    held = copy.deepcopy(sp)
    for i in held.mesh.held():
        with torch.no_grad():
            for p, g in zip(held.leaves(i), grads[i]):
                p.copy_(g)
    return interop.params_to_reference(TT.unshard(held))


def assert_tree_close(got: dict, want, atol: float = ATOL) -> None:
    want = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), want)
    for k in ("embed", "pos", "ln_f", "head"):
        np.testing.assert_allclose(got[k], want[k], atol=atol, err_msg=k)
    for i, (g, w) in enumerate(zip(got["blocks"], want["blocks"])):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], atol=atol,
                                       err_msg=f"blocks.{i}.{k}")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_transformer_forward_loss_and_grads_match_jax(mesh):
    jcfg, tcfg, jp, tp, tokens = tf_setup(MESHES[mesh])
    np.testing.assert_allclose(
        TT.forward(tp, tokens[:, :-1], tcfg).numpy(),
        np.asarray(JT.forward(jp, jnp.asarray(tokens[:, :-1]), jcfg)),
        atol=ATOL)
    jloss, jg = jax.value_and_grad(JT.loss_fn)(jp, jnp.asarray(tokens), jcfg)
    np.testing.assert_allclose(float(TT.loss_fn(tp, tokens, tcfg)),
                               float(jloss), atol=ATOL)
    loss, grads = tp_dp.value_and_grads(
        tp, lambda: TT._tp_shares(tp, tokens, tcfg))
    np.testing.assert_allclose(float(loss), float(jloss), atol=ATOL)
    assert_tree_close(unshard_grads(tp, grads), jg)
    # every dp rank of a tp column holds the same summed gradient, and the
    # replicated parameters' gradients are the same bits on every rank
    m = tp.mesh
    for col in m.dp_groups():
        for i in col[1:]:
            for a, b in zip(grads[col[0]], grads[i]):
                assert torch.equal(a, b)
    names = [n for n, _ in tp.per_rank[0].named_parameters()]
    for j, n in enumerate(names):
        if TT._tp_dim(n) is None:
            for i in range(m.size):
                assert torch.equal(grads[i][j], grads[0][j]), n


@pytest.mark.parametrize("mesh", list(MESHES))
def test_transformer_train_steps_and_generate_match_jax(mesh):
    jcfg, tcfg, jp, tp, tokens = tf_setup(MESHES[mesh])
    for _ in range(3):
        jp, jl = JT.train_step(jp, jnp.asarray(tokens), jnp.float32(0.05),
                               jcfg)
        tp, tl = TT.train_step(tp, tokens, 0.05, tcfg)
        np.testing.assert_allclose(float(tl), float(jl), atol=ATOL)
    assert_tree_close(interop.params_to_reference(TT.unshard(tp)), jp)
    prompt = tokens[:, :5]
    want = np.asarray(JT.generate(jp, jnp.asarray(prompt), 8, jcfg))
    got = TT.generate(tp, prompt, 8, tcfg)
    np.testing.assert_array_equal(got.numpy(), want)
    # the same tokens as the one-rank generate on the unsharded parameters
    whole = TT.unshard(tp)
    toks, lg = TT.generate(whole, prompt, 8, tcfg, return_logits=True)
    np.testing.assert_array_equal(got.numpy(), toks.numpy())
    toks_tp, lg_tp = TT.generate(tp, prompt, 8, tcfg, return_logits=True)
    np.testing.assert_array_equal(toks_tp.numpy(), toks.numpy())
    assert lg_tp.shape == lg.shape == (16, 8, 32)
    np.testing.assert_allclose(lg_tp.numpy(), lg.numpy(), atol=ATOL)


def test_transformer_sampling_on_the_tp_layout():
    _, tcfg, _, tp, tokens = tf_setup((4, 2))
    a = TT.generate(tp, tokens[:, :3], 5, tcfg, temperature=1.0,
                    generator=torch.Generator().manual_seed(3))
    b = TT.generate(tp, tokens[:, :3], 5, tcfg, temperature=1.0,
                    generator=torch.Generator().manual_seed(3))
    assert a.shape == (16, 8) and torch.equal(a, b)
    assert torch.equal(a[:, :3], torch.from_numpy(tokens[:, :3]))
    assert int(a.max()) < 32 and int(a.min()) >= 0
    with pytest.raises(ValueError, match="Generator"):
        TT.generate(tp, tokens[:, :3], 5, tcfg, temperature=1.0)


def counting_tokens(n, seed=1):
    start = np.random.default_rng(seed).integers(0, 32, (n, 1))
    return ((start + np.arange(32)[None]) % 32).astype(np.int64)


def test_transformer_bf16_learns_counting():
    # the port's twin of tests/test_transformer.py::
    # test_transformer_learns_counting (bf16, make_mesh(8), 60 SGD steps)
    cfg = TT.Config(**TF_CFG)
    assert cfg.dtype == torch.bfloat16
    mesh = TT.make_mesh(8)
    params = TT.shard_params(
        TT.init_params(cfg, torch.Generator().manual_seed(0)), mesh)
    tokens = counting_tokens(16)
    losses = [float(TT.train_step(params, tokens, 0.05, cfg)[1])
              for _ in range(60)]
    assert losses[-1] < 0.3 * losses[0], losses[::10]
    logits = TT.forward(params, tokens[:, :-1], cfg)
    acc = (logits.argmax(-1).numpy() == tokens[:, 1:]).mean()
    assert acc > 0.8, acc


def test_transformer_bf16_adam_moments_have_their_shards_shapes():
    # the twin of test_transformer_optax_adamw_sharded_moments: Adam in
    # f32 master arithmetic at bf16 converges, and each rank's moments
    # have its shard's shape (JAX checks that mu_w1 has w1's tp axes)
    cfg = TT.Config(**TF_CFG)
    mesh = TT.make_mesh(8)
    params = TT.shard_params(
        TT.init_params(cfg, torch.Generator().manual_seed(0)), mesh)
    tokens = counting_tokens(8)
    step, init = TT.make_optax_train_step(cfg, tdat.train.adam(3e-3))
    state = init(params)
    losses = []
    for _ in range(10):
        params, state, loss = step(params, state, tokens)
        losses.append(float(loss))
    assert losses[-1] < 0.8 * losses[0], losses
    names = [n for n, _ in params.per_rank[0].named_parameters()]
    w1 = names.index("blocks.0.w1")
    for i in range(mesh.size):
        leaves = params.leaves(i)
        assert leaves[w1].dtype == torch.bfloat16
        assert tuple(leaves[w1].shape) == (64, 256 // mesh.tp)
        for leaf, moments in zip(leaves, state[i]["slots"]):
            for mom in moments:
                assert mom.dtype == torch.float32
                assert mom.shape == leaf.shape


# ---------------------------------------------------------------------------
# layouts and errors
# ---------------------------------------------------------------------------

TP_MESHES = {1: (8, 1), 2: (4, 2), 4: (2, 4)}


@pytest.mark.parametrize("tp", list(TP_MESHES))
def test_unshard_of_shard_params_is_exact(tp):
    mesh = tp_dp.Mesh(np.arange(8).reshape(TP_MESHES[tp]))
    cfg = TT.Config(**TF_CFG, dtype=torch.float32)
    model = TT.init_params(cfg, torch.Generator().manual_seed(2))
    sp = TT.shard_params(model, mesh)
    # each rank holds whole heads: its q, k and v columns, its proj rows
    E, H = cfg.dim, cfg.heads
    for i in range(mesh.size):
        t = i % tp
        blk, whole = sp.per_rank[i].blocks[0], model.blocks[0]
        q = whole.qkv[:, :E].tensor_split(tp, 1)[t]
        assert torch.equal(blk.qkv[:, :E // tp], q)
        assert tuple(blk.proj.shape) == (E // tp, E)
        assert H % tp == 0
    back = TT.unshard(sp)
    for (n, a), (_, b) in zip(back.named_parameters(),
                              model.named_parameters()):
        assert torch.equal(a, b), n
    ps = [{k: torch.from_numpy(v) for k, v in layer.items()}
          for layer in mlp_params([16, 32, 64, 8])]
    for a, b in zip(TM.unshard(TM.shard_params(ps, mesh)), ps):
        assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])


@pytest.mark.parametrize("case,match", [
    ("heads", "heads 6 does not divide over tp = 4"),
    ("vocab", "vocab 30 does not divide over tp = 4"),
    ("mlp_col", "layer 0 output features 6"),
    ("mlp_row", "layer 1 input features 6"),
    ("batch", "batch rows 6 does not divide over dp = 4"),
    ("tokens", "token rows 6 does not divide over dp = 4"),
])
def test_divisibility_errors_name_the_extent(case, match):
    mesh4 = tp_dp.Mesh(np.arange(8).reshape(2, 4))
    mesh42 = TM.make_mesh(8)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match=match):
        if case == "heads":
            TT.shard_params(TT.init_params(TT.Config(
                vocab=32, dim=48, heads=6, max_seq=8), gen), mesh4)
        elif case == "vocab":
            TT.shard_params(TT.init_params(TT.Config(
                vocab=30, dim=32, heads=4, max_seq=8), gen), mesh4)
        elif case == "mlp_col":
            TM.shard_params(TM.init_params(gen, [8, 6, 8]), mesh4)
        elif case == "mlp_row":
            TM.shard_params(TM.init_params(gen, [8, 8]) +
                            TM.init_params(gen, [6, 8]), mesh4)
        elif case == "batch":
            TM.shard_batch(np.zeros((6, 8), np.float32),
                           np.zeros((6, 8), np.float32), mesh42)
        else:
            cfg = TT.Config(vocab=32, dim=32, heads=4, max_seq=8)
            TT.loss_fn(TT.shard_params(TT.init_params(cfg, gen), mesh42),
                       np.zeros((6, 5), np.int64), cfg)


# ---------------------------------------------------------------------------
# checkpoints: the sharded pytree written as JAX writes it
# ---------------------------------------------------------------------------


def test_sharded_mlp_checkpoint_reads_across_packages(tmp_path):
    ps = mlp_params([32, 64, 16])
    jp = JM.shard_params([{k: jnp.asarray(v) for k, v in layer.items()}
                          for layer in ps], JM.make_mesh(8))
    tp = TM.shard_params([{k: torch.from_numpy(v) for k, v in layer.items()}
                          for layer in ps], TM.make_mesh(8))
    tdat.utils.save(tmp_path / "port", {"params": tp, "step": 5})
    dat.utils.save(tmp_path / "jax", {"params": jp, "step": 5})
    for path in ("port", "jax"):
        for back in (dat.utils.load(tmp_path / path),
                     tdat.utils.load(tmp_path / path)):
            assert back["step"] == 5
            for layer, want in zip(back["params"], ps):
                for k in "wb":
                    got = layer[k]
                    got = got.numpy() if isinstance(got, torch.Tensor) \
                        else np.asarray(got)
                    np.testing.assert_array_equal(got, want[k])
    # the same metadata as JAX writes: whole arrays tagged "jax": true
    import json
    trees = [json.loads((tmp_path / p / "dartpu_meta.json").read_text())
             ["tree"] for p in ("port", "jax")]
    assert trees[0] == trees[1]
    assert trees[0]["params"][0]["w"]["__dartpu__"] == "ndarray"
    assert trees[0]["params"][0]["w"]["jax"] is True


# ---------------------------------------------------------------------------
# a job of two controller processes
# ---------------------------------------------------------------------------

_CHILD = os.path.join(os.path.dirname(__file__), "_torch_multihost_child.py")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same(got, ref, what):
    if isinstance(ref, dict):
        assert set(got) == set(ref), what
        for k in ref:
            _same(got[k], ref[k], f"{what}.{k}")
    else:
        assert isinstance(got, np.ndarray) and got.dtype == ref.dtype, what
        assert got.shape == ref.shape and got.tobytes() == ref.tobytes(), \
            what


def test_job_of_two_processes_is_bit_equal_to_one(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    store = str(tmp_path / "store")
    done = run_job([[sys.executable, _CHILD, store, str(i), "2",
                     str(tmp_path), "3.0", "tp_dp"] for i in range(2)],
                   str(tmp_path), env, store)
    for i, (rc, out) in enumerate(done):
        assert rc == 0 and f"MULTIHOST_OK proc={i}" in out, out
    res = []
    for i in range(2):
        with open(tmp_path / f"result_{i}.pkl", "rb") as f:
            res.append(pickle.load(f)["tp_dp"])
    ref = {name: LEGS.summary(tdat, tdat.gather, thunk())[0]
           for name, thunk in LEGS.tp_dp_legs(tdat, 8)}
    assert set(ref) == set(LEGS.TP_DP_NAMES)
    for r in res:
        for name in LEGS.TP_DP_NAMES:
            _same(r[name], ref[name], name)
    # and the one-process legs are the JAX-checked functions: the loss fell
    for name in ("tp_mlp_odd", "tp_mlp_even", "tp_sgd", "tp_adam"):
        assert ref[name]["losses"][-1] < ref[name]["losses"][0], name
    # sampling: every process drew one process's tokens in both calls, and
    # the second call drew from where the first left the generator
    sample = ref["tp_sample"]
    assert sample["first"].shape == (16, 10)
    assert sample["first"].tobytes() != sample["second"].tobytes()
