"""Stencils of the PyTorch port against the JAX package: the plain versions
of the single-step and multistep CUDA kernels against the Pallas kernels in
interpret mode, and ``stencil5``/``stencil3x3`` on a (4,1) layout against
the JAX programs.  Single steps agree to rtol 1e-5: the float32 sums per
cell are the same taps in the same order, but XLA may contract them into
FMAs.  Iterated stencils amplify those last-bit differences in cells whose
taps cancel, so they are held to a relative Frobenius error of 1e-5.
Other dtypes follow JAX exactly, each weight cast to the block's dtype
first (float16 with non-unit weights to a few ulps: see
``test_stencil_dtypes_follow_jax``).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import distributedarrays_tpu as dat
import distributedarrays_tpu_torch as tdat
from distributedarrays_tpu.models import stencil as jstencil
from distributedarrays_tpu.ops import pallas_stencil as jps
from distributedarrays_tpu_torch.ops import cuda_stencil as tcs

from _torch_port import (assert_typed_equal, port_ranks,  # noqa: F401
                         same_layout, typed_inputs, typed_result)

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


# the dtypes besides float32 that both packages keep (JAX, without 64-bit
# types, turns float64 and int64 into float32 and int32)
OTHER_DTYPES = ["float16", "bfloat16", "int32", "int8", "uint8", "int16",
                "uint16", "uint32", "bool"]
# the kernels' types since their extension to every type the TPU kernel
# takes
NEW_DTYPES = ["int8", "uint8", "int16", "uint16", "uint32", "bool"]
UNSIGNED = ("uint8", "uint16", "uint32")
# the 5-point route's shape with a centre that an unsigned type takes
FIVE_POINT_2 = ((0.0, 1.0, 0.0), (1.0, 2.0, 1.0), (0.0, 1.0, 0.0))


def _typed_grid(dtype: str, shape, seed: int):
    """Seeded values for both packages: small integers for int32, the whole
    range of the narrower integer types (so that sums wrap), bools at
    random, else uniform in [-2, 2) rounded once to the type."""
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        a = rng.integers(-20, 20, shape).astype(np.int32)
        return a, torch.from_numpy(a)
    if dtype in ("int16", "uint16", "uint32"):
        info = np.iinfo(dtype)
        a = rng.integers(info.min, info.max, shape, endpoint=True).astype(
            dtype)
        return a, torch.from_numpy(a)
    return typed_inputs(dtype, shape, seed, -2.0, 2.0)


def _dtype_weights(dtype: str, kind: str, seed: int = 2):
    """The weights of a dtype case: the Laplacian (``FIVE_POINT_2`` for an
    unsigned type, which cannot take its -4) or random ones in [-3, 3)
    (their magnitudes for an unsigned type), so that the integer types keep
    nonzero ones after the cast."""
    if kind == "laplacian":
        return FIVE_POINT_2 if dtype in UNSIGNED else tcs.LAPLACIAN_3X3
    w = np.random.default_rng(seed).uniform(-3, 3, (3, 3))
    if dtype in UNSIGNED:
        w = np.abs(w)
    return tuple(tuple(float(v) for v in row) for row in w)


@pytest.mark.parametrize("iters", [1, 3])
@pytest.mark.parametrize("weights", ["laplacian", "random"])
@pytest.mark.parametrize("dtype", OTHER_DTYPES)
def test_stencil_dtypes_follow_jax(dtype, weights, iters):
    # each weight is cast to the block's dtype before it multiplies (the
    # integer types truncate toward zero and wrap, bool takes a weight that
    # is not zero as true), as the JAX step does
    w = _dtype_weights(dtype, weights)
    a, t = _typed_grid(dtype, (32, 24), 3)
    jd = dat.distribute(a, procs=[0, 1, 2, 3], dist=(4, 1))
    td = tdat.distribute(t, procs=[0, 1, 2, 3], dist=(4, 1))
    if w == tcs.LAPLACIAN_3X3:
        jr, tr = jstencil.stencil5(jd, iters), tdat.stencil5(td, iters)
    else:
        jr = jstencil.stencil3x3(jd, w, iters)
        tr = tdat.stencil3x3(td, w, iters)
    same_layout(jr, tr)
    if dtype == "float16" and weights == "random":
        # XLA on the CPU keeps float32 between the fused taps of a step and
        # rounds once, where the port rounds every product and sum to
        # float16, as the JAX step is written; so the values agree to 2
        # float16 ulps of the largest one (they read 1), the dtype exactly
        (pn, pv), (jn, jv) = typed_result(tr), typed_result(jr)
        assert pn == jn == "float16"
        ulp = 2.0 ** (np.floor(np.log2(np.abs(jv).max())) - 10)
        np.testing.assert_allclose(pv, jv, rtol=0, atol=2 * ulp)
    else:
        assert_typed_equal(tr, jr)


def test_kernel_dtype_gate():
    # the kernels take every DArray dtype the TPU kernel takes: the four of
    # PR 12 and, since their extension, the 8- and 16-bit integers, uint32
    # and bool; complex64, which the Pallas kernel refuses as well, is the
    # one the card refuses
    gate = tdat.stencil._use_kernel
    assert tcs.KERNEL_DTYPES == (
        torch.float32, torch.float16, torch.bfloat16, torch.int32,
        torch.int8, torch.uint8, torch.int16, torch.uint16, torch.uint32,
        torch.bool)
    for dt in tcs.KERNEL_DTYPES:
        assert tcs.supports(dt)
        # the auto choice: the kernels on the card, the plain steps on the CPU
        assert gate("cuda", dt, None) is True
        assert gate("cpu", dt, None) is False
        assert gate("cuda", dt, False) is False
    for dt in (torch.complex64,):
        assert not tcs.supports(dt)
        # the card refuses what the kernels do not take, unless asked for
        # the plain steps
        for choice in (None, True):
            with pytest.raises(TypeError, match="do not take"):
                gate("cuda", dt, choice)
        assert gate("cuda", dt, False) is False
        assert gate("cpu", dt, None) is False
        # on CPU tensors the wrappers' plain versions take any dtype
        assert gate("cpu", dt, True) is True
    # the kernels' own wrappers refuse what they do not take
    x = torch.zeros(4, 8, dtype=torch.complex64, device="meta")
    with pytest.raises(TypeError, match="take float32, float16"):
        tcs.stencil5_block(x, x[:1], x[:1])
    x = torch.zeros(4, 8, dtype=torch.float16, device="meta")
    with pytest.raises(TypeError, match="share one dtype"):
        tcs.stencil5_block(x, x[:1].float(), x[:1])


@pytest.mark.parametrize("dtype", UNSIGNED)
def test_unsigned_laplacian_overflows_in_both_packages(dtype):
    # the Laplacian's -4 does not cast to an unsigned type: numpy's
    # OverflowError in both packages, before any step; nonnegative weights
    # take either route
    a, t = _typed_grid(dtype, (32, 24), 4)
    jd = dat.distribute(a, procs=[0, 1, 2, 3], dist=(4, 1))
    td = tdat.distribute(t, procs=[0, 1, 2, 3], dist=(4, 1))
    with pytest.raises(OverflowError):
        jstencil.stencil5(jd)
    with pytest.raises(OverflowError):
        tdat.stencil5(td)
    with pytest.raises(OverflowError):
        tcs._weights_arg(tcs.LAPLACIAN_3X3, getattr(torch, dtype))
    assert tcs.multistep_route(FIVE_POINT_2) == "five_point"
    assert tcs.multistep_route(_dtype_weights(dtype, "random")) == "generic"


def _block_inputs(dtype: str, m: int, n: int, k: int, seed: int):
    """A block and its (k, n) halo slabs in ``dtype``, as numpy for the
    Pallas kernels and as tensors for the port."""
    return [_typed_grid(dtype, shape, seed + i)
            for i, shape in enumerate(((m, n), (k, n), (k, n)))]


@pytest.mark.parametrize("weights", ["laplacian", "random"])
@pytest.mark.parametrize("dtype", NEW_DTYPES)
def test_new_dtype_single_step_plain_matches_pallas(dtype, weights):
    # the plain block function against the Pallas kernel in interpret mode,
    # exactly: integers wrap and bool is or/and in both
    w = _dtype_weights(dtype, weights, 11)
    (x, tx), (lo, tlo), (hi, thi) = _block_inputs(dtype, 16, 24, 1, 12)
    jr = jps.stencil3x3_block(x, lo, hi, w, interpret=True)
    tr = tcs.stencil3x3_block(tx, tlo, thi, w)
    assert_typed_equal(tr, jr)


@pytest.mark.parametrize("k,top,bot", [(1, True, False), (3, False, True),
                                       (8, True, False)])
@pytest.mark.parametrize("dtype", NEW_DTYPES)
def test_new_dtype_multistep_plain_matches_pallas(dtype, k, top, bot):
    # k steps with one Dirichlet edge, both routes' weights, exactly
    (x, tx), (lo, tlo), (hi, thi) = _block_inputs(dtype, 16, 24, k, 13)
    for kind in ("laplacian", "random"):
        w = _dtype_weights(dtype, kind, 14)
        jr = jps.stencil3x3_multistep(x, lo, hi, k, top, bot, w,
                                      interpret=True)
        tr = tcs.stencil3x3_multistep(tx, tlo, thi, k, top, bot, w)
        assert_typed_equal(tr, jr)


@pytest.mark.parametrize("m,n", [(8192, 8192), (1000, 777), (7, 8193),
                                 (1, 8192), (1, 1), (129, 128), (128, 129)])
def test_step_plan_covers(m, n):
    plan = tcs.step_plan(m, n)
    assert (plan.tile_rows, plan.tile_cols) == (8 * tcs.STEP_ROWS,
                                               tcs.WINDOW_COLS)
    assert plan.smem_bytes == 0
    gx, gy = plan.grid
    # every cell in a tile, no tile wholly outside the block
    assert gx * plan.tile_cols >= n > (gx - 1) * plan.tile_cols
    assert gy * plan.tile_rows >= m > (gy - 1) * plan.tile_rows


def test_stencil_route_counts_have_both_routes():
    kb = tdat.kbuild
    kb.reset_launches()
    for name in ("stencil_step", "stencil_multistep"):
        assert kb.route_counts()[name] == dict.fromkeys(kb.STENCIL_ROUTES, 0)
    assert set(kb.STENCIL_ROUTES) == {"generic", "five_point"}
    # the C entries' route codes: generic 0, five_point 1
    assert kb.STENCIL_ROUTES.index("five_point") == 1


def _fake_launches(monkeypatch):
    """Stand-ins for the C entries: each call's arguments, with the weights
    read back from the host pointer the wrapper passes."""
    calls = []

    def entry(*args):
        calls.append(args)
        return 0
    monkeypatch.setattr(tcs, "_check_kernel_args", lambda *a: None)
    monkeypatch.setattr(tcs, "_fn", lambda name, nints: entry)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: SimpleNamespace(cuda_stream=0))
    made = []
    real = tcs._weights_arg

    def weights_arg(w, dtype):
        made.append(real(w, dtype))
        return made[-1]
    monkeypatch.setattr(tcs, "_weights_arg", weights_arg)
    return calls, made


@pytest.mark.parametrize("dtype", tcs.KERNEL_DTYPES,
                         ids=lambda d: str(d).removeprefix("torch."))
@pytest.mark.parametrize("weights", ["laplacian", "random"])
def test_kernel_wrappers_pass_route_and_plan(monkeypatch, weights, dtype):
    # a launch faked on meta tensors: each wrapper hands its C entry the
    # dtype's code, the weights cast as the plain version casts them, their
    # zero and unit masks, the route multistep_route picks and its plan's
    # grid, and counts that route
    name = str(dtype).removeprefix("torch.")
    w = _dtype_weights(name, weights, 4)
    route = tcs.multistep_route(w)
    calls, made = _fake_launches(monkeypatch)
    kb = tdat.kbuild
    kb.reset_launches()
    m, n, k = 1000, 777, 3
    x = torch.zeros(m, n, dtype=dtype, device="meta")
    tcs.stencil3x3_block(x, x[:1], x[:1], w)
    tcs.stencil3x3_multistep(x, x[:k], x[:k], k, True, False, w)
    code = kb.STENCIL_ROUTES.index(route)
    dcode = tcs.KERNEL_DTYPES.index(dtype)
    skip, unit = tcs._masks(tcs._canon_weights(w))
    # (x, lo, hi, out, m, n, [k, top, bot,] dtype, w9, skip, unit, route,
    #  tiles_x, tiles_y, device, stream)
    assert calls[0][6] == calls[1][9] == dcode
    assert calls[0][7] == made[0].data_ptr()
    assert calls[1][10] == made[1].data_ptr()
    assert calls[0][8:13] == (skip, unit, code, *tcs.step_plan(m, n).grid)
    assert calls[1][11:16] == (skip, unit, code,
                               *tcs.multistep_plan(m, n, k).grid)
    for wt in made:
        assert wt.dtype == dtype and wt.device.type == "cpu"
        assert wt.tolist() == [tcs._typed(v, dtype) for row in w for v in row]
    for name in ("stencil_step", "stencil_multistep"):
        assert kb.route_counts()[name] == {
            r: int(r == route) for r in kb.STENCIL_ROUTES}
    kb.reset_launches()


def test_route_and_masks_come_from_the_weights_before_the_cast():
    # the 5-point route needs zero corners, unit edges and a centre that is
    # not zero before the cast: a centre of 1e-50 rounds to 0 in float32
    # and is still multiplied (by 0), as the plain version multiplies it
    tiny = ((0.0, 1.0, 0.0), (1.0, 1e-50, 1.0), (0.0, 1.0, 0.0))
    assert tcs.multistep_route(tiny) == "five_point"
    skip, unit = tcs._masks(tcs._canon_weights(tiny))
    assert (skip, unit) == (0x145, 0xaa)
    assert tcs._weights_arg(tiny, torch.float32)[4].item() == 0.0
    x = torch.tensor([[float("inf"), 1.0]])
    z = torch.zeros(1, 2)
    assert torch.isnan(tcs.stencil3x3_block(x, z, z, tiny)[0, 0])
    # a weight that truncates to 0 as int32 is multiplied, not skipped
    half = ((0.0, 0.5, 0.0), (0.0, 2.0, 0.0), (0.0, 0.0, 0.0))
    skip, unit = tcs._masks(tcs._canon_weights(half))
    assert not skip & 0x2 and not unit & 0x2
    assert tcs.multistep_route(half) == "generic"
    assert tcs._weights_arg(half, torch.int32).tolist() == [0, 0, 0, 0, 2, 0,
                                                            0, 0, 0]
    xi = torch.arange(12, dtype=torch.int32).view(3, 4)
    zi = torch.zeros(1, 4, dtype=torch.int32)
    got = tcs.stencil3x3_block(xi, zi, zi, half)
    assert got.dtype == torch.int32 and torch.equal(got, 2 * xi)
    # and the weights in each dtype are what the plain version multiplies by
    for dt in tcs.KERNEL_DTYPES:
        wt = tcs._weights_arg(_weights(7), dt)
        assert wt.dtype == dt
        assert wt.tolist() == [tcs._typed(v, dt) for row in _weights(7)
                               for v in row]


@pytest.mark.parametrize("dtype", tcs.KERNEL_DTYPES,
                         ids=lambda d: str(d).removeprefix("torch."))
def test_multistep_plan_shared_memory_per_dtype(dtype):
    # the exchange buffers are static shared memory: 48 KiB at most, which
    # an 8-byte type would still fit
    size = torch.empty(0, dtype=dtype).element_size()
    plan = tcs.multistep_plan(8192, 8192, 8, size)
    assert plan.smem_bytes == 2 * 2 * 8 * (tcs.WINDOW_COLS + 8) * size
    assert plan.smem_bytes <= 48 * 1024
    assert plan.grid == tcs.multistep_plan(8192, 8192, 8).grid
