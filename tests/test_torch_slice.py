"""The slice as a whole: the README quickstart chain, a stencil and gather on
8 ranks against the JAX package; the port's independence from JAX; its
refusal to run quietly on the CPU; and that CPU tensors never launch a
kernel."""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributedarrays_tpu as dat
import distributedarrays_tpu_torch as tdat
from distributedarrays_tpu.models import stencil as jstencil
from distributedarrays_tpu_torch.models import ring_attention as RA

from _torch_port import port_ranks, same_layout  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


def test_quickstart_chain_stencil_gather():
    x = np.random.default_rng(0).uniform(0, 1, (64, 64)).astype(np.float32)
    jd, td = dat.distribute(x), tdat.distribute(x)
    same_layout(jd, td)
    jr = dat.dmap(jnp.sin, jd) + jd * 2.0
    tr = tdat.dmap(torch.sin, td) + td * 2.0
    same_layout(jr, tr)
    np.testing.assert_allclose(float(tdat.dsum(tr)), float(dat.dsum(jr)),
                               rtol=1e-5)
    tc = td @ tr.T
    # the JAX package's `jd @ jr.T` refuses this pair of layouts (its two
    # operands land on differently ordered device lists), so the reference
    # product is jnp.matmul on the gathered operands
    jc = jnp.matmul(np.asarray(jd), np.asarray(jr).T)
    assert tc.grid == (4, 2)
    np.testing.assert_allclose(np.asarray(tc), np.asarray(jc), rtol=1e-5,
                               atol=1e-4)
    # onto a row layout for the halo stencil, then back to the host
    js = jstencil.stencil5(dat.distribute(jc, dist=(8, 1)), iters=3)
    ts = tdat.stencil5(tdat.distribute(tc, dist=(8, 1)), iters=3,
                       use_kernel=True)
    same_layout(js, ts)
    out = tdat.gather(ts)
    assert out.shape == (64, 64) and np.isfinite(out).all()
    ref = np.asarray(dat.gather(js))
    assert np.linalg.norm(out - ref) / np.linalg.norm(ref) <= 1e-5


_BLOCKER = """
import importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "distributedarrays_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import numpy as np
import distributedarrays_tpu_torch as tdat
for m in pkgutil.walk_packages(tdat.__path__, "distributedarrays_tpu_torch."):
    __import__(m.name)
assert not [n for n in sys.modules
            if n.split(".")[0] in ("jax", "distributedarrays_tpu")]
tdat.init(nranks=2, device="cpu")
d = tdat.distribute(np.arange(12.0).reshape(4, 3))
assert float(tdat.dsum(d * 2.0)) == 132.0
print("ok")
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    r = subprocess.run([sys.executable, "-c", _BLOCKER], capture_output=True,
                       text=True, cwd=str(REPO), env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")


def test_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tdat.layout, "_table", None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdat.dzeros((4, 4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdat.distribute(np.ones((4, 4)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdat.init()
    tdat.init(device="cpu")
    assert tdat.nranks() == 1 and tdat.device_of(0).type == "cpu"


def test_cpu_tensors_leave_kernel_counts_at_zero():
    tdat.kbuild.reset_launches()
    x = np.random.default_rng(1).standard_normal((32, 16)).astype(np.float32)
    a = tdat.distribute(x, procs=[0], dist=(1, 1))
    key = tdat.autotune.device_key_for(32, 32, 16, torch.float32,
                                       torch.float32)
    tdat.autotune.record("matmul_impl", key, "pallas")
    _ = a @ a.T
    _ = tdat.stencil5(tdat.distribute(x, dist=(4, 1)), iters=7,
                      use_kernel=True)
    _ = tdat.stencil5(tdat.distribute(x, dist=(4, 1)), iters=1,
                      use_kernel=True)
    t = torch.from_numpy(x)
    tdat.cuda_gemm.cuda_matmul(t, t.T.contiguous())
    tdat.cuda_stencil.stencil5_block(t, t[:1], t[-1:])
    tdat.cuda_stencil.stencil5_multistep(t, t[:3], t[-3:], 3, True, False)
    qkv = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (3, 16, 2, 8)).astype(np.float32))
    tdat.flash_attention(*qkv, causal=True)
    tdat.cuda_attention.flash_attention_hop(
        *(x.transpose(0, 1).contiguous() for x in qkv),
        *tdat.cuda_attention.flash_carry_init(2, 16, 8), 0, 0, True)
    d = tdat.distribute(qkv[0].numpy(), dist=(4, 1, 1))
    tdat.ring_attention(d, d, d, causal=True)
    q = qkv[0].clone().requires_grad_(True)
    tdat.flash_attention(q, qkv[1], qkv[2], causal=True).sum().backward()
    tdat.cuda_collectives.ring_reduce_scatter([t, t], 0)
    w = [t[:16].clone().requires_grad_(True) for _ in range(2)]
    ys = tdat.collective_matmul.tp_ffn([t, t], w, [x.t() for x in w])
    sum(y.sum() for y in ys).backward()
    blocks = [qkv[0].clone().requires_grad_(True) for _ in range(2)]
    o = RA.zigzag_ring_flash_attention_kernel(blocks, blocks, blocks)
    sum(x.sum() for x in o).backward()
    assert tdat.kbuild.launch_counts() == {
        "gemm": 0, "stencil_step": 0, "stencil_multistep": 0,
        "matmul_int8": 0, "all_gather": 0, "all_to_all": 0,
        "reduce_scatter": 0, "allgather_matmul": 0,
        "allgather_matmul_rhs": 0, "matmul_reducescatter": 0,
        "flash_attention": 0, "flash_attention_hop": 0, "ring_attention": 0,
        "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0}


def test_kernel_wrappers_refuse_unsupported_devices():
    t = torch.zeros(4, 4)
    meta = torch.zeros(4, 4, device="meta")
    with pytest.raises(ValueError):
        tdat.cuda_gemm.cuda_matmul(meta, meta)
    with pytest.raises(ValueError):
        tdat.cuda_stencil.stencil5_block(meta, meta[:1], meta[:1])
    with pytest.raises(ValueError):
        tdat.cuda_gemm.cuda_matmul(t, meta)
