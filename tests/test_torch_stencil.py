"""Stencils of the PyTorch port against the JAX package: the plain versions
of the single-step and multistep CUDA kernels against the Pallas kernels in
interpret mode, and ``stencil5``/``stencil3x3`` on a (4,1) layout against
the JAX programs.  Single steps agree to rtol 1e-5: the float32 sums per
cell are the same taps in the same order, but XLA may contract them into
FMAs.  Iterated stencils amplify those last-bit differences in cells whose
taps cancel, so they are held to a relative Frobenius error of 1e-5.
"""

import numpy as np
import pytest
import torch

import distributedarrays_tpu as dat
import distributedarrays_tpu_torch as tdat
from distributedarrays_tpu.models import stencil as jstencil
from distributedarrays_tpu.ops import pallas_stencil as jps
from distributedarrays_tpu_torch.ops import cuda_stencil as tcs

from _torch_port import port_ranks, same_layout  # noqa: F401

RTOL, ATOL = 1e-5, 1e-5


def assert_fro(actual, desired, tol=1e-5):
    a, d = np.asarray(actual, np.float64), np.asarray(desired, np.float64)
    err = np.linalg.norm(a - d) / np.linalg.norm(d)
    assert err <= tol, f"relative Frobenius error {err:.3e} > {tol}"


def _weights(seed=0):
    return tuple(tuple(float(v) for v in row) for row in
                 np.random.default_rng(seed).uniform(-1, 1, (3, 3)))


def _arr(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("weights", ["laplacian", "random"])
def test_single_step_plain_matches_pallas(weights):
    w = jps.LAPLACIAN_3X3 if weights == "laplacian" else _weights(1)
    x, lo, hi = _arr((16, 24), 2), _arr((1, 24), 3), _arr((1, 24), 4)
    jr = jps.stencil3x3_block(x, lo, hi, w, interpret=True)
    tr = tcs.stencil3x3_block(torch.from_numpy(x), torch.from_numpy(lo),
                              torch.from_numpy(hi), w)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("top,bot", [(False, False), (True, True),
                                     (True, False), (False, True)])
def test_multistep_plain_matches_pallas(top, bot):
    k, w = 3, _weights(5)
    x, lo, hi = _arr((16, 24), 6), _arr((k, 24), 7), _arr((k, 24), 8)
    jr = jps.stencil3x3_multistep(x, lo, hi, k, top, bot, w, interpret=True)
    tr = tcs.stencil3x3_multistep(torch.from_numpy(x), torch.from_numpy(lo),
                                  torch.from_numpy(hi), k, top, bot, w)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("m,n,k,top,bot", [(13, 21, 4, True, False),
                                           (5, 9, 8, False, True),
                                           (130, 131, 8, True, False)])
def test_multistep_plain_ragged_mixed_flags_matches_pallas(m, n, k, top, bot):
    # one Dirichlet edge, a ragged block, and (5, 9) with k past the block
    w = _weights(9)
    x, lo, hi = _arr((m, n), 10), _arr((k, n), 11), _arr((k, n), 12)
    jr = jps.stencil3x3_multistep(x, lo, hi, k, top, bot, w, interpret=True)
    tr = tcs.stencil3x3_multistep(torch.from_numpy(x), torch.from_numpy(lo),
                                  torch.from_numpy(hi), k, top, bot, w)
    assert_fro(tr.numpy(), np.asarray(jr))


@pytest.mark.parametrize("k", range(1, tcs.MAX_K + 1))
def test_multistep_plan_fits_and_covers(k):
    plan = tcs.multistep_plan(8192, 8192, k)
    assert plan.smem_bytes <= 232448    # what a Hopper block can opt in to
    assert (plan.tile_rows, plan.tile_cols) == (tcs.WINDOW_ROWS - 2 * k,
                                               tcs.WINDOW_COLS - 2 * k)
    for m, n in ((8192, 8192), (1000, 777), (7, 8193), (1, 1), (97, 96)):
        plan = tcs.multistep_plan(m, n, k)
        gx, gy = plan.grid
        # every cell in a tile, no tile wholly outside the block
        assert gx * plan.tile_cols >= n > (gx - 1) * plan.tile_cols
        assert gy * plan.tile_rows >= m > (gy - 1) * plan.tile_rows


def test_multistep_plan_and_route_refuse_and_choose():
    for k in (0, tcs.MAX_K + 1):
        with pytest.raises(ValueError, match="1 <= k"):
            tcs.multistep_plan(64, 64, k)
    with pytest.raises(ValueError, match="65535"):
        tcs.multistep_plan(65536 * 112, 8, 8)
    assert tcs.multistep_route(tcs.LAPLACIAN_3X3) == "five_point"
    # unit edges and zero corners with any nonzero centre; else generic
    assert tcs.multistep_route(((0, 1, 0), (1, 1, 1), (0, 1, 0))) == \
        "five_point"
    for w in (_weights(3), ((0, 1, 0), (1, 0, 1), (0, 1, 0)),
              ((0, 2, 0), (1, -4, 1), (0, 1, 0)),
              ((0.5, 1, 0), (1, -4, 1), (0, 1, 0))):
        assert tcs.multistep_route(w) == "generic"


def test_kernel_wrappers_validate_shapes():
    x = torch.zeros(8, 6)
    with pytest.raises(ValueError, match="halo rows"):
        tcs.stencil5_block(x, torch.zeros(2, 6), torch.zeros(1, 6))
    with pytest.raises(ValueError, match="halo slabs"):
        tcs.stencil5_multistep(x, torch.zeros(1, 6), torch.zeros(1, 6), 3,
                               True, True)
    with pytest.raises(ValueError, match="k must be"):
        tcs.stencil5_multistep(x, torch.zeros(0, 6), torch.zeros(0, 6), 0,
                               True, True)
    with pytest.raises(ValueError, match="3x3"):
        tcs.stencil3x3_block(x, torch.zeros(1, 6), torch.zeros(1, 6),
                             [[1.0, 2.0]])


@pytest.mark.parametrize("iters", [1, 3, 7])
@pytest.mark.parametrize("kernel", [True, False])
def test_stencil5_row_layout(iters, kernel):
    x = _arr((32, 24), 9)
    jd = dat.distribute(x, procs=[0, 1, 2, 3], dist=(4, 1))
    td = tdat.distribute(x, procs=[0, 1, 2, 3], dist=(4, 1))
    jr = jstencil.stencil5(jd, iters=iters, use_pallas=kernel)
    tr = tdat.stencil5(td, iters=iters, use_kernel=kernel)
    same_layout(jr, tr)
    assert_fro(tr, jr)


@pytest.mark.parametrize("iters,temporal", [(5, 3), (4, 1), (9, None)])
def test_stencil3x3_weights_and_temporal(iters, temporal):
    w = _weights(10)
    x = _arr((32, 16), 11)
    jd = dat.distribute(x, procs=[0, 1, 2, 3], dist=(4, 1))
    td = tdat.distribute(x, procs=[0, 1, 2, 3], dist=(4, 1))
    jr = jstencil.stencil3x3(jd, w, iters=iters, use_pallas=True,
                             temporal=temporal)
    tr = tdat.stencil3x3(td, w, iters=iters, use_kernel=True,
                         temporal=temporal)
    plain = tdat.stencil3x3(td, w, iters=iters, use_kernel=False)
    assert_fro(tr, jr)
    # temporal blocking changes no cell's arithmetic: exact against the
    # per-step plain formulation
    np.testing.assert_array_equal(np.asarray(tr), np.asarray(plain))


def test_stencil_needs_row_layout_and_valid_depth():
    x = _arr((16, 16), 12)
    for bad in ((2, 2), (1, 4)):
        with pytest.raises(ValueError, match="row-sharded"):
            jstencil.stencil5(dat.distribute(x, dist=bad))
        with pytest.raises(ValueError, match="row-sharded"):
            tdat.stencil5(tdat.distribute(x, dist=bad))
    with pytest.raises(ValueError, match="row-sharded"):
        tdat.stencil5(tdat.distribute(_arr((18, 4), 13), dist=(4, 1)))
    td = tdat.distribute(x, procs=[0, 1, 2, 3], dist=(4, 1))
    with pytest.raises(ValueError, match="temporal"):
        tdat.stencil5(td, iters=8, use_kernel=True, temporal=5)


def test_stencil_auto_depth_rule():
    assert tdat.stencil._depth(16, 2048, None) == 8
    assert tdat.stencil._depth(7, 2048, None) == 7
    assert tdat.stencil._depth(2, 2048, None) == 1
    assert tdat.stencil._depth(16, 2, None) == 1
    assert tdat.stencil._depth(16, 4, None) == 4
    assert tdat.stencil._depth(16, 64, 12) == 12
    with pytest.raises(ValueError):
        tdat.stencil._depth(40, 64, tcs.MAX_K + 1)


def test_halo_exchange():
    blocks = [torch.full((3, 2), float(r)) for r in range(4)]
    halos = tdat.halo_exchange(blocks, halo=2, wrap=False)
    assert torch.equal(halos[0][0], torch.zeros(2, 2))
    assert torch.equal(halos[0][1], torch.full((2, 2), 1.0))
    assert torch.equal(halos[2][0], torch.full((2, 2), 1.0))
    assert torch.equal(halos[3][1], torch.zeros(2, 2))
    wrapped = tdat.halo_exchange(blocks, halo=1, wrap=True)
    assert torch.equal(wrapped[0][0], torch.full((1, 2), 3.0))
    assert torch.equal(wrapped[3][1], torch.full((1, 2), 0.0))
    with pytest.raises(ValueError):
        tdat.halo_exchange(blocks, halo=4)
