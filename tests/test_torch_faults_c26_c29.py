"""Faults C26-C29 of the PyTorch port, each held against the JAX package on
the same seeded numpy inputs: the ``utils`` package's exports (C26), the
unsigned types wider than uint8 (C27), the orderings of complex values
(C28) and ``dmap``'s 64-bit result types (C29).  Each case runs over five
layouts: (37, 11) on the default (4, 2) grid of 8 ranks and on 3 ranks,
(50, 8) on (4, 2), (9, 13) on (2, 4), and a 1-D 8229; dtypes and values
are compared bit for bit.

Held against numpy instead (ROADMAP.md "Open on the JAX side"): JAX's
uint16 ``dcumsum``/``dcumprod`` come back uint32 where the scan dim is
split, while the port keeps the input type, as numpy's ``cumsum(x,
dtype=x.dtype)`` and JAX's own unsplit scans do."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributedarrays_tpu as dat
import distributedarrays_tpu_torch as tdat

from _torch_port import (assert_typed_equal, jax_plan_cache,  # noqa: F401
                         jax_process_state, port_ranks, same_layout)

# shape, procs, dist
LAYOUTS = {
    "37x11_4x2": ((37, 11), None, None),
    "37x11_3ranks": ((37, 11), [0, 1, 2], None),
    "50x8_4x2": ((50, 8), None, (4, 2)),
    "9x13_2x4": ((9, 13), None, (2, 4)),
    "8229": ((8229,), None, None),
}


def both(x, layout):
    shape, procs, dist = LAYOUTS[layout]
    kw = {k: v for k, v in (("procs", procs), ("dist", dist))
          if v is not None}
    jd, td = dat.distribute(x, **kw), tdat.distribute(x, **kw)
    same_layout(jd, td)
    return jd, td


def ints(dtype: str, shape, seed: int = 0, hi=None) -> np.ndarray:
    top = np.iinfo(dtype).max if dtype != "uint64" else 2 ** 40
    return np.random.default_rng(seed).integers(
        0, top if hi is None else hi, shape, dtype=np.uint64).astype(dtype)


# ---------------------------------------------------------------------------
# C26: the utils package's exports
# ---------------------------------------------------------------------------


def test_c26_utils_packages_expose_the_same_names():
    # C26: the port's utils/__init__.py held only a docstring, so
    # ``from distributedarrays_tpu_torch.utils import save`` raised
    import distributedarrays_tpu.utils as JU
    import distributedarrays_tpu_torch.utils as TU
    from distributedarrays_tpu_torch.utils import (  # noqa: F401
        OpTimer, annotate, load, save, trace)

    def public(mod):
        return {n for n in vars(mod) if not n.startswith("_")}
    # the port's kbuild and autotune are submodules that other modules
    # import (JAX's autotune is one too once imported); nothing else differs
    assert public(JU) - {"autotune"} == public(TU) - {"autotune", "kbuild"}
    for name in ("save", "load", "OpTimer", "annotate", "trace",
                 "checkpoint", "debug", "native", "profiling"):
        assert hasattr(TU, name), name
    assert TU.save is TU.checkpoint.save and TU.trace is TU.profiling.trace


def test_c26_utils_save_load_round_trip_like_jax(tmp_path):
    x = np.random.default_rng(3).standard_normal((6, 5)).astype(np.float32)
    import distributedarrays_tpu.utils as JU
    import distributedarrays_tpu_torch.utils as TU
    TU.save(tmp_path / "t.npz", {"w": torch.from_numpy(x), "n": 3})
    back = JU.load(tmp_path / "t.npz")
    np.testing.assert_array_equal(np.asarray(back["w"]), x)
    JU.save(tmp_path / "j.npz", {"w": jnp.asarray(x)})
    np.testing.assert_array_equal(TU.load(tmp_path / "j.npz")["w"].numpy(),
                                  x)


# ---------------------------------------------------------------------------
# C27: uint16, uint32 and uint64
# ---------------------------------------------------------------------------

UNSIGNED = ["uint16", "uint32", "uint64"]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_c27_uint64_is_stored_as_uint32_like_jax(layout):
    # C27: the port stored uint64 where JAX stores uint32
    x = ints("uint64", LAYOUTS[layout][0])
    jd, td = both(x, layout)
    assert td.dtype == torch.uint32
    assert_typed_equal(td, np.asarray(jd))
    z = tdat.dzeros(LAYOUTS[layout][0], dtype=torch.uint64)
    assert z.dtype == torch.uint32


OPERATORS = {
    "add": lambda d: d + 1,
    "add_self": lambda d: d + d,
    "sub": lambda d: d - 3,
    "sub_self": lambda d: d - d,
    "rsub": lambda d: 5 - d,
    "floordiv": lambda d: d // 7,
    "mod": lambda d: d % 5,
    "lt": lambda d: d < 30000,
    "le": lambda d: d <= 30000,
    "gt": lambda d: d > 30000,
    "ge": lambda d: d >= 30000,
    "lt_self": lambda d: d < d // 2,
    "neg": lambda d: -d,
    "abs": lambda d: abs(d),
    "invert": lambda d: ~d,
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("op", list(OPERATORS))
@pytest.mark.parametrize("dtype", UNSIGNED)
def test_c27_unsigned_operators_match_jax(dtype, op, layout):
    # C27: torch's CPU kernels raise for uint16/32/64 ("add_stub" not
    # implemented for 'UInt16'); the port computes in the next wider
    # signed type and wraps back, as JAX's results wrap
    x = ints(dtype, LAYOUTS[layout][0])
    jd, td = both(x, layout)
    assert_typed_equal(OPERATORS[op](td), OPERATORS[op](jd))


@pytest.mark.parametrize("layout", [k for k, v in LAYOUTS.items()
                                    if len(v[0]) == 2])
@pytest.mark.parametrize("dtype", UNSIGNED)
def test_c27_unsigned_matmul_matches_jax(dtype, layout):
    shape, procs, _ = LAYOUTS[layout]
    x = ints(dtype, shape)
    y = ints(dtype, (shape[1], 6), seed=1)
    jd, td = both(x, layout)
    kw = {} if procs is None else {"procs": procs}
    assert_typed_equal(td @ tdat.distribute(y, **kw),
                       jd @ dat.distribute(y, **kw))


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("dtype", UNSIGNED)
def test_c27_unsigned_extrema_match_jax(dtype, layout):
    x = ints(dtype, LAYOUTS[layout][0])
    jd, td = both(x, layout)
    for dims in [None] + list(range(x.ndim)):
        assert_typed_equal(tdat.dmaximum(td, dims), dat.dmaximum(jd, dims))
        assert_typed_equal(tdat.dminimum(td, dims), dat.dminimum(jd, dims))
        (tlo, thi), (jlo, jhi) = tdat.dextrema(td, dims), dat.dextrema(jd,
                                                                       dims)
        assert_typed_equal(tlo, jlo)
        assert_typed_equal(thi, jhi)


SCANS = ["dcumsum", "dcumprod", "dcummax", "dcummin"]
NUMPY_SCANS = {"dcumsum": np.cumsum, "dcumprod": np.cumprod}


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("scan", SCANS)
@pytest.mark.parametrize("dtype", UNSIGNED)
def test_c27_unsigned_scans_match_jax(dtype, scan, layout):
    x = ints(dtype, LAYOUTS[layout][0])
    jd, td = both(x, layout)
    for ax in range(x.ndim):
        got = getattr(tdat, scan)(td, ax)
        if dtype == "uint16" and scan in NUMPY_SCANS:
            # JAX widens a split uint16 sum or product scan to uint32
            # (module docstring); numpy keeps the type, as the port does
            assert_typed_equal(got, NUMPY_SCANS[scan](x, ax, dtype=x.dtype))
        else:
            assert_typed_equal(got, getattr(dat, scan)(jd, ax))


def test_c27_repro_uint16_plus_one():
    x = np.arange(407, dtype=np.uint16).reshape(37, 11)
    got = tdat.distribute(x) + 1
    assert got.dtype == torch.uint16
    np.testing.assert_array_equal(got.full().to(torch.int32).numpy(),
                                  x.astype(np.int32) + 1)


# ---------------------------------------------------------------------------
# C28: complex orderings
# ---------------------------------------------------------------------------


def complex_host(shape, seed=0) -> np.ndarray:
    # few distinct real parts, so the imaginary parts often decide
    rng = np.random.default_rng(seed)
    return (rng.integers(-2, 3, shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)


ORDERINGS = {
    "lt": lambda d, e: d < 1,
    "le": lambda d, e: d <= 1,
    "gt": lambda d, e: d > 0,
    "ge": lambda d, e: d >= 0,
    "lt_array": lambda d, e: d < e,
    "le_array": lambda d, e: d <= e,
    "gt_array": lambda d, e: d > e,
    "ge_array": lambda d, e: d >= e,
    "lt_complex_scalar": lambda d, e: d < 1 + 0.5j,
    "rgt": lambda d, e: 1 > d,
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("op", list(ORDERINGS))
def test_c28_complex_orderings_match_jax_and_numpy(op, layout):
    # C28: "lt_cpu" not implemented for 'ComplexFloat'; numpy and JAX
    # order complex values by the real parts, then the imaginary parts
    shape = LAYOUTS[layout][0]
    x, y = complex_host(shape), complex_host(shape, seed=1)
    y[::3] = x[::3]                      # exact ties
    jd, td = both(x, layout)
    je, te = both(y, layout)
    got = ORDERINGS[op](td, te)
    assert_typed_equal(got, ORDERINGS[op](jd, je))
    assert_typed_equal(got, ORDERINGS[op](x, y))


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("scan", ["dcummax", "dcummin"])
def test_c28_complex_running_extrema_match_jax_and_numpy(scan, layout):
    x = complex_host(LAYOUTS[layout][0])
    jd, td = both(x, layout)
    ufunc = np.maximum if scan == "dcummax" else np.minimum
    for ax in range(x.ndim):
        got = getattr(tdat, scan)(td, ax)
        assert_complex_equal(got, getattr(dat, scan)(jd, ax))
        assert_complex_equal(got, ufunc.accumulate(x, ax))


def assert_complex_equal(got, want) -> None:
    g = got.full().numpy()
    w = np.asarray(want)
    assert g.dtype == w.dtype == np.complex64
    np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# C29: dmap's result types
# ---------------------------------------------------------------------------

# (input dtype, the port's fn, JAX's fn)
MAPS = {
    "bool_times_3": ("bool", lambda a: a * 3, lambda a: a * 3),
    "to_float64": ("float32", lambda a: a.to(torch.float64) * 2,
                   lambda a: a.astype(jnp.float64) * 2),
    "to_int64": ("int32", lambda a: a.to(torch.int64) + 1,
                 lambda a: a.astype(jnp.int64) + 1),
    "to_complex128": ("float32", lambda a: a.to(torch.complex128),
                      lambda a: a.astype(jnp.complex128)),
    "to_uint64": ("int32", lambda a: abs(a).to(torch.uint64),
                  lambda a: abs(a).astype(jnp.uint64)),
}


def map_host(dtype: str, shape) -> np.ndarray:
    rng = np.random.default_rng(5)
    if dtype == "bool":
        return rng.integers(0, 2, shape).astype(bool)
    if dtype == "int32":
        return rng.integers(-1000, 1000, shape).astype(np.int32)
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("case", list(MAPS))
def test_c29_dmap_narrows_64_bit_results_like_jax(case, layout):
    # C29: elementwise stored fn's result type as torch gave it (int64 for
    # ``bool * 3``, float64 for ``.double()``)
    dtype, tfn, jfn = MAPS[case]
    x = map_host(dtype, LAYOUTS[layout][0])
    jd, td = both(x, layout)
    want = np.asarray(dat.dmap(jfn, jd))
    out = tdat.distribute(np.zeros(x.shape, np.float32),
                          **{k: v for k, v in zip(
                              ("procs", "dist"), LAYOUTS[layout][1:])
                             if v is not None})
    for got in (tdat.dmap(tfn, td), tdat.broadcasted(tfn, td),
                tdat.dmap_into(tfn, out, td)):
        g = got.full()
        assert str(g.dtype).removeprefix("torch.") == want.dtype.name
        np.testing.assert_array_equal(g.numpy(), want)


def test_c29_repro_bool_dmap_is_int32():
    d = tdat.distribute(np.ones((4, 4), bool))
    assert tdat.dmap(lambda a: a * 3, d).dtype == torch.int32
