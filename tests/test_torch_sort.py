"""``dsort`` of the PyTorch port against the JAX package, on the cases of
``tests/test_sort.py`` (the same seeded inputs, layouts, ``by``, ``rev``
and ``sample`` strategies): the sorted values bit for bit (NaNs in place),
and the result's cuts and pids, which the pivots decide, equal to JAX's.
The exchange's kernel path (the K11 copy launches of
``ring_all_to_allv``) runs on host memory with its launches emulated."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributedarrays_tpu as dat
import distributedarrays_tpu_torch as tdat
from distributedarrays_tpu_torch.ops import cuda_collectives as C
from distributedarrays_tpu_torch.ops import sort as TS
from distributedarrays_tpu_torch.utils import debug

from _torch_port import (emulated_copies, jax_plan_cache,  # noqa: F401
                         jax_process_state, port_ranks, same_layout,
                         typed_inputs)


@pytest.fixture(autouse=True)
def fresh_warnings():
    debug._warned.clear()
    yield


@pytest.fixture
def no_whole_sort(monkeypatch):
    """Any fall back to the whole-vector sort fails the test."""
    def boom(*a, **k):
        raise AssertionError("fell back to the whole-vector sort; PSRS "
                             "expected")
    monkeypatch.setattr(TS, "_whole_sort", boom)


@pytest.fixture
def exchanges(monkeypatch):
    """The PSRS exchanges made, counted."""
    calls = []
    real = TS.ring_all_to_allv

    def counting(arrays, counts):
        calls.append(np.asarray(counts))
        return real(arrays, counts)
    monkeypatch.setattr(TS, "ring_all_to_allv", counting)
    return calls


def both(x, procs=None, dist=None, jby=None, tby=None, **kw):
    """The JAX and port sorts of ``x`` on one layout: same values (NaNs in
    place), same cuts and pids.  Returns the port's result."""
    jr = dat.dsort(dat.distribute(x, procs=procs, dist=dist), by=jby, **kw)
    tr = tdat.dsort(tdat.distribute(x, procs=procs, dist=dist), by=tby, **kw)
    same_layout(jr, tr)
    np.testing.assert_array_equal(np.asarray(tr), np.asarray(jr))
    return tr


def _n(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def test_psrs_matches_numpy(exchanges):
    x = _n(4096)
    s = both(x, alg="psrs")
    np.testing.assert_array_equal(np.asarray(s), np.sort(x))
    assert s.dims == (4096,)
    assert len(exchanges) == 1 and exchanges[0].sum() == 4096


def test_psrs_result_distribution_changes():
    rng = np.random.default_rng(1)
    x = np.concatenate([np.zeros(3000, np.float32),
                        rng.standard_normal(1096).astype(np.float32)])
    rng.shuffle(x)
    s = both(x, alg="psrs")
    np.testing.assert_array_equal(np.asarray(s), np.sort(x))
    assert len(s.cuts[0]) - 1 < 8           # empty ranks dropped


def test_sort_rev():
    x = _n(1024, 2)
    s = both(x, rev=True)
    np.testing.assert_array_equal(np.asarray(s), np.sort(x)[::-1])


def test_sort_by_key():
    x = _n(512, 3)
    s = both(x, jby=jnp.abs, tby=torch.abs)
    np.testing.assert_array_equal(
        np.asarray(s), x[np.argsort(np.abs(x), kind="stable")])


def test_sort_int_dtype():
    x = np.random.default_rng(4).integers(-1000, 1000, 2048).astype(np.int32)
    s = both(x, alg="psrs")
    np.testing.assert_array_equal(np.asarray(s), np.sort(x))


def test_sort_uneven_length_stays_distributed(no_whole_sort):
    x = _n(1001, 5)
    np.testing.assert_array_equal(np.asarray(both(x)), np.sort(x))


@pytest.mark.parametrize("sample", [True, False, (-3.0, 3.0)],
                         ids=["true", "false", "tuple"])
def test_sort_sample_kwarg_parity(sample):
    x = _n(512, 6)
    np.testing.assert_array_equal(np.asarray(both(x, sample=sample)),
                                  np.sort(x))


@pytest.mark.parametrize("n", [1, 2, 7, 10, 100])
def test_sort_tiny_sizes(n):
    x = _n(n, 7)
    np.testing.assert_array_equal(np.asarray(both(x)), np.sort(x))


def test_sort_2d_raises():
    with pytest.raises(ValueError, match="1-D"):
        tdat.dsort(tdat.dzeros((4, 4)))


def test_psrs_ineligible_raises():
    x = _n(64, 8)
    with pytest.raises(ValueError, match="psrs"):
        tdat.dsort(tdat.distribute(x, procs=[0], dist=[1]), alg="psrs")


def test_psrs_handles_nan(no_whole_sort):
    x = _n(64, 9)
    x[[3, 17, 40]] = np.nan
    s = both(x, alg="psrs")
    np.testing.assert_array_equal(np.asarray(s), np.sort(x))


def test_psrs_nan_rev():
    x = _n(32, 10)
    x[5] = np.nan
    s = both(x, alg="psrs", rev=True)
    np.testing.assert_array_equal(np.asarray(s), np.sort(x)[::-1])


def test_psrs_by_traceable(no_whole_sort):
    x = _n(64, 11)
    s = both(x, alg="psrs", jby=jnp.abs, tby=torch.abs)
    np.testing.assert_array_equal(
        np.asarray(s), x[np.argsort(np.abs(x), kind="stable")])


def test_psrs_by_traceable_int_keys():
    x = np.random.default_rng(12).integers(-100, 100, 64).astype(np.int32)
    mod7 = (lambda v: v % 7)
    s = both(x, alg="psrs", jby=mod7, tby=mod7)
    np.testing.assert_array_equal(np.asarray(s),
                                  x[np.argsort(x % 7, kind="stable")])


def test_sort_by_untraceable_host_fallback():
    x = np.array([3.0, -1.0, 2.0, -4.0, 0.5, -0.5, 9.0, -9.0],
                 dtype=np.float32)
    by = (lambda v: abs(float(v)))
    with pytest.warns(RuntimeWarning, match="gathering"):
        s = both(x, jby=by, tby=by)
    want = np.asarray(sorted(x.tolist(), key=abs), dtype=np.float32)
    np.testing.assert_array_equal(np.asarray(s), want)


def test_psrs_drops_empty_chunks():
    x = np.zeros(64, dtype=np.float32)
    x[0] = 1.0
    s = both(x, procs=range(8), dist=[8], alg="psrs")
    np.testing.assert_array_equal(np.asarray(s), np.sort(x))
    sizes = list(np.diff(s.cuts[0]))
    assert all(n > 0 for n in sizes) and len(sizes) <= 8


def test_psrs_uniform_keeps_all_ranks():
    x = _n(80, 13)
    s = both(x, procs=range(8), dist=[8], alg="psrs")
    np.testing.assert_array_equal(np.asarray(s), np.sort(x))
    assert all(n > 0 for n in np.diff(s.cuts[0]))


def test_psrs_int_max_values_survive():
    M = np.iinfo(np.int32).max
    x = np.array([0, 1, 2, 3, M, M, M, M], dtype=np.int32)
    x = x[np.random.default_rng(0).permutation(8)]
    s = both(x, procs=range(2), dist=[2], alg="psrs")
    np.testing.assert_array_equal(np.asarray(s), np.sort(x))


def test_psrs_uint_max_values_survive():
    M = np.iinfo(np.uint32).max
    x = np.array([5, M, 1, M, 2, M, 0, M], dtype=np.uint32)
    s = both(x, procs=range(4), dist=[4], alg="psrs")
    assert s.dtype == torch.uint32
    np.testing.assert_array_equal(np.asarray(s), np.sort(x))


def test_psrs_rev_stable_ties():
    x = np.array([1, -1, 2, -2, 3, -3, 4, -4], dtype=np.float32)
    s = both(x, procs=range(2), dist=[2], alg="psrs", jby=jnp.abs,
             tby=torch.abs, rev=True)
    want = np.asarray(sorted(x.tolist(), key=abs, reverse=True),
                      dtype=np.float32)
    np.testing.assert_array_equal(np.asarray(s), want)


def test_psrs_rev_int():
    x = np.array([7, -3, 11, 0, -3, 7, 2, -9], dtype=np.int32)
    s = both(x, procs=range(4), dist=[4], alg="psrs", rev=True)
    np.testing.assert_array_equal(np.asarray(s), np.sort(x)[::-1])


def test_psrs_prime_length(no_whole_sort):
    x = _n(1009, 14)
    np.testing.assert_array_equal(np.asarray(both(x, alg="psrs")),
                                  np.sort(x))


def test_psrs_prime_length_nan_rev_by(no_whole_sort):
    x = _n(101, 15)
    s = both(x, alg="psrs", jby=jnp.abs, tby=torch.abs, rev=True)
    want = np.asarray(sorted(x.tolist(), key=abs, reverse=True), np.float32)
    np.testing.assert_array_equal(np.asarray(s), want)


def test_psrs_bool_dtype(no_whole_sort):
    x = np.array([True, False] * 16)
    np.testing.assert_array_equal(np.asarray(both(x, alg="psrs")),
                                  np.sort(x))


def test_sample_false_uniform_pivots(no_whole_sort):
    x = np.random.default_rng(16).uniform(-5, 5, 512).astype(np.float32)
    s = both(x, sample=False)
    np.testing.assert_array_equal(np.asarray(s), np.sort(x))
    assert len(np.diff(s.cuts[0])) == 8


def test_sample_tuple_pivots():
    x = np.random.default_rng(17).uniform(0, 1, 256).astype(np.float32)
    s = both(x, sample=(0.0, 1.0))
    sizes = np.diff(s.cuts[0])
    assert sizes.sum() == 256 and all(sizes > 0)


def test_sample_tuple_skewed_distribution_shows():
    x = np.random.default_rng(18).uniform(0, 0.1, 256).astype(np.float32)
    s = both(x, sample=(0.0, 1.0))
    assert len(np.diff(s.cuts[0])) == 1


def test_sample_tuple_int_keys():
    x = np.random.default_rng(19).integers(-100, 100, 128).astype(np.int32)
    np.testing.assert_array_equal(np.asarray(both(x, sample=(-100, 100))),
                                  np.sort(x))


def test_sample_array_strategy():
    rng = np.random.default_rng(20)
    x = rng.standard_normal(512).astype(np.float32)
    samp = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(both(x, sample=samp)),
                                  np.sort(x))


def test_sample_array_with_by():
    rng = np.random.default_rng(21)
    x = rng.standard_normal(256).astype(np.float32)
    samp = np.abs(rng.standard_normal(32)).astype(np.float32)
    s = both(x, sample=samp, jby=jnp.abs, tby=torch.abs)
    np.testing.assert_array_equal(
        np.asarray(s), x[np.argsort(np.abs(x), kind="stable")])


@pytest.mark.parametrize("sample,match", [
    ("bogus", "sample"), ((3.0, -3.0), "min <= max"),
    ((-np.inf, np.inf), "finite"), (np.array([1.0, 2.0]), "elements"),
    ((1.0, 2.0, 3.0), "\\(min, max\\)")],
    ids=["bogus", "reversed", "infinite", "short_array", "triple"])
def test_sample_invalid_values_raise(sample, match):
    d = tdat.distribute(_n(64, 22))
    with pytest.raises(ValueError, match=match):
        tdat.dsort(d, sample=sample)


def test_sample_strategy_single_rank_validates_and_proceeds():
    x = _n(64, 23)
    for sample in [(0.0, 1.0), False, np.sort(x)[::8]]:
        s = both(x, procs=[0], dist=[1], sample=sample)
        np.testing.assert_array_equal(np.asarray(s), np.sort(x))
    d1 = tdat.distribute(x, procs=[0], dist=[1])
    with pytest.raises(ValueError, match="min <= max"):
        tdat.dsort(d1, sample=(3.0, -3.0))
    with pytest.raises(ValueError, match="sample"):
        tdat.dsort(d1, sample="bogus")
    with pytest.raises(ValueError, match="torch tensors"):
        tdat.dsort(tdat.distribute(x), sample=(0.0, 1.0),
                   by=lambda v: hash(v))


def test_sample_false_rev():
    x = _n(128, 24)
    np.testing.assert_array_equal(np.asarray(both(x, sample=False, rev=True)),
                                  np.sort(x)[::-1])


def test_unknown_alg_raises():
    with pytest.raises(ValueError, match="unknown alg"):
        tdat.dsort(tdat.distribute(_n(64, 25)), alg="PSRS")


# ---------------------------------------------------------------------------
# the total-order keys, the dtypes, the exchange's kernel path
# ---------------------------------------------------------------------------

EDGES = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0, 3e38,
                  -3e38, 1e-45, -1e-45, np.nan, 0.0, -0.0, 2.5, -2.5],
                 dtype=np.float32)


@pytest.mark.parametrize("rev", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("p", [1, 2, 4])
def test_float_edge_values_like_jax(p, rev):
    # +-0.0 (-0.0 first, as JAX's bit order), +-inf, NaNs last, denormals
    s = both(EDGES, procs=range(p), rev=rev)
    got = np.asarray(s)
    assert np.array_equal(np.signbit(got), np.signbit(np.asarray(
        dat.dsort(dat.distribute(EDGES, procs=range(p)), rev=rev))))
    want = np.sort(EDGES)[::-1] if rev else np.sort(EDGES)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["int8", "int16", "uint8", "uint16",
                                   "int32", "uint32"])
@pytest.mark.parametrize("rev", [False, True], ids=["fwd", "rev"])
def test_integer_extremes_like_jax(dtype, rev):
    info = np.iinfo(dtype)
    rng = np.random.default_rng(26)
    x = np.concatenate([[info.min, info.max, info.min, info.max, 0, 1],
                        rng.integers(info.min, info.max, 58, endpoint=True)]
                       ).astype(dtype)
    s = both(x, procs=range(4), rev=rev)
    want = np.sort(x)[::-1] if rev else np.sort(x)
    np.testing.assert_array_equal(np.asarray(s), want)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16", "bool"])
def test_other_dtypes_like_jax(dtype):
    h, t = typed_inputs(dtype, (512,), seed=27, lo=-3.0, hi=3.0)
    if dtype != "bool":
        h[[5, 77]] = np.nan
        t[[5, 77]] = float("nan")
    jr = dat.dsort(dat.distribute(h))
    tr = tdat.dsort(tdat.distribute(t))
    same_layout(jr, tr)
    assert tr.dtype == t.dtype
    np.testing.assert_array_equal(np.asarray(tr),
                                  np.asarray(jr).astype(np.asarray(tr).dtype))


def test_subdarray_and_host_inputs():
    x = _n(300, 28)
    d = tdat.distribute(x)
    np.testing.assert_array_equal(np.asarray(tdat.dsort(d[10:290])),
                                  np.sort(x[10:290]))
    np.testing.assert_array_equal(np.asarray(tdat.dsort(x)), np.sort(x))


@pytest.mark.parametrize("n,procs", [(4096, 4), (1001, 4), (64, 8)])
def test_exchange_kernel_path_one_launch_a_card(n, procs, monkeypatch):
    # the CUDA branch of the exchange on host tensors, its copy launches
    # emulated: one all_to_all launch for keys and values of p <= 4 ranks
    # (2 p**2 <= 32 pieces; 8 ranks need up to 4), and the result equal to
    # the plain exchange's
    x = _n(n, 29)
    want = tdat.dsort(tdat.distribute(x, procs=range(procs)))
    calls = []
    monkeypatch.setattr(C, "_on_cuda", lambda ts: True)
    monkeypatch.setattr(C, "_copy_on_card", emulated_copies(calls))
    got = tdat.dsort(tdat.distribute(x, procs=range(procs)))
    assert got.cuts == want.cuts
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert len(calls) == 1 and calls[0][0] == "all_to_all"
    assert calls[0][1] == 1 if procs <= 4 else 1 <= calls[0][1] <= 4


def test_all_to_allv_plain_and_kernel_path_agree(monkeypatch):
    rng = np.random.default_rng(30)
    counts = rng.integers(0, 5, (4, 4))
    keys = [torch.from_numpy(rng.integers(-9, 9, counts[r].sum() + 2)
                             .astype(np.int64)) for r in range(4)]
    vals = [torch.from_numpy(rng.standard_normal(counts[r].sum() + 2)
                             .astype(np.float32)) for r in range(4)]
    plain = C.all_to_allv_plain([keys, vals], counts)
    calls = []
    monkeypatch.setattr(C, "_on_cuda", lambda ts: True)
    monkeypatch.setattr(C, "_copy_on_card", emulated_copies(calls))
    got = C.ring_all_to_allv([keys, vals], counts)
    for a, b in zip(got, plain):
        for t, u in zip(a, b):
            assert t.dtype == u.dtype and torch.equal(t, u)
    assert calls == [("all_to_all", 1)]
