"""k-means (``models/kmeans.py``) and the Monte-Carlo estimators
(``models/montecarlo.py``) of the PyTorch port against the JAX package.

The same seeded numpy points go into both packages' DArrays.  The
k-means++ seeding is the same numpy code over the same sample rows, so its
``C0`` is bit-equal; Lloyd's centroids agree within 1e-5 (the per-rank
one-hot sums are folded over ranks in another order than GSPMD's
all-reduce) and the labels exactly.  JAX's threefry draws cannot be
reproduced by a ``torch.Generator``, so the Monte-Carlo estimates are held
within 5 standard errors of the truth and of JAX's estimate.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import distributedarrays_tpu as dat
import distributedarrays_tpu_torch as tdat
from distributedarrays_tpu.models import kmeans as JK
from distributedarrays_tpu.models import montecarlo as JMC
from distributedarrays_tpu_torch.models import kmeans as TK
from distributedarrays_tpu_torch.models import montecarlo as TMC

from _torch_port import (jax_plan_cache, jax_process_state, port_ranks,  # noqa: F401
                         same_layout)


def _clusters(seed, n_per, centers, noise=0.3):
    rng = np.random.default_rng(seed)
    pts = np.concatenate([
        c + noise * rng.standard_normal((n_per, len(c))).astype(np.float32)
        for c in np.asarray(centers, np.float32)])
    rng.shuffle(pts)
    return pts.astype(np.float32)


def _pair(pts, dist=None):
    jd = dat.distribute(pts, dist=dist) if dist else dat.distribute(pts)
    td = tdat.distribute(pts, dist=dist) if dist else tdat.distribute(pts)
    return jd, td


# ---------------------------------------------------------------------------
# k-means
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,dim,dist,k,seed", [
    (192, 2, None, 3, 0),            # the JAX test's shape, sample = all
    (5003, 4, (4, 2), 7, 3),         # sample of 4096 rows, 2-D grid
    (37, 3, (8, 1), 5, 1),           # uneven row blocks
])
def test_kmeanspp_init_is_bit_equal(n, dim, dist, k, seed):
    pts = np.random.default_rng(n).standard_normal((n, dim)).astype(
        np.float32)
    jd, td = _pair(pts, dist)
    want = JK._kmeanspp_init(jd, k, seed)
    got = TK._kmeanspp_init(td, k, seed)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_kmeans_matches_jax_and_recovers_clusters():
    # tests/test_models.py::test_kmeans_recovers_clusters
    centers = np.array([[-5, -5], [5, 5], [5, -5]], np.float32)
    pts = _clusters(0, 64, centers)
    jd, td = _pair(pts)
    JC, jshifts = JK.kmeans(jd, 3, iters=15)
    C, shifts = TK.kmeans(td, 3, iters=15)
    assert isinstance(C, torch.Tensor) and C.shape == (3, 2)
    assert isinstance(shifts, np.ndarray) and shifts.shape == (15,)
    np.testing.assert_allclose(C.numpy(), np.asarray(JC), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(shifts, jshifts, rtol=1e-4, atol=1e-6)
    for c in centers:
        assert np.min(np.linalg.norm(C.numpy() - c, axis=1)) < 0.5
    assert shifts[-1] < 1e-3
    labels = TK.assign(td, C)
    np.testing.assert_array_equal(tdat.gather(labels),
                                  np.asarray(JK.assign(jd, JC)))
    assert len(np.unique(tdat.gather(labels))) == 3


@pytest.mark.parametrize("dist", [(4, 2), (8, 1)])
def test_kmeans_on_grids_matches_jax(dist):
    pts = _clusters(5, 50, np.random.default_rng(9).uniform(
        -8, 8, (6, 5)))
    jd, td = _pair(pts, dist)
    JC, _ = JK.kmeans(jd, 6, iters=6, seed=2)
    C, _ = TK.kmeans(td, 6, iters=6, seed=2)
    np.testing.assert_allclose(C.numpy(), np.asarray(JC), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(tdat.gather(TK.assign(td, C)),
                                  np.asarray(JK.assign(jd, JC)))


def test_assign_dtype_and_layout_follow_the_row_owners():
    pts = _clusters(1, 13, [[0, 0, 0], [4, 4, 4], [-4, 4, 0]])   # 39 rows
    C = np.array([[0, 0, 0], [4, 4, 4], [-4, 4, 0]], np.float32)
    for dist in ((4, 2), (8, 1)):
        jd, td = _pair(pts, dist)
        jl, tl = JK.assign(jd, C), TK.assign(td, C)
        assert tl.dtype == torch.int32 and np.asarray(jl).dtype == np.int32
        same_layout(jl, tl)
        np.testing.assert_array_equal(tdat.gather(tl), np.asarray(jl))
    # a DArray on explicit uneven cuts: the labels take the default cuts
    td = tdat.darray_from_cuts(torch.from_numpy(pts), [0, 1, 2],
                               [[0, 5, 30, 39], [0, 3]])
    tl = TK.assign(td, torch.from_numpy(C))
    assert tl.cuts == [[0, 13, 26, 39]]
    assert [int(p) for p in tl.pids.flat] == [0, 1, 2]


def test_kmeans_validation():
    with pytest.raises(ValueError, match="expects"):
        TK.kmeans(tdat.dzeros((8,)), 2)
    with pytest.raises(ValueError, match="0 < k"):
        TK.kmeans(tdat.dzeros((4, 2)), 10)
    with pytest.raises(ValueError, match="0 < k"):
        TK.kmeans(tdat.dzeros((4, 2)), 0)


def test_kmeans_duplicate_points_fall_back_to_uniform_picks():
    # every point equal: k-means++ has no distance mass left, as in JAX
    pts = np.ones((16, 2), np.float32)
    jd, td = _pair(pts)
    np.testing.assert_array_equal(TK._kmeanspp_init(td, 3, 0),
                                  JK._kmeanspp_init(jd, 3, 0))
    C, shifts = TK.kmeans(td, 3, iters=2)
    assert torch.equal(C, torch.ones(3, 2)) and not shifts.any()


# ---------------------------------------------------------------------------
# Monte Carlo
# ---------------------------------------------------------------------------


def test_pi_estimate_within_5_sigma_of_pi_and_of_jax():
    n = 200_000
    sigma = math.sqrt(math.pi * (4 - math.pi) / n)
    est = TMC.pi_estimate(n, seed=0)
    jest = JMC.pi_estimate(n, seed=0)
    assert abs(est - math.pi) < 5 * sigma
    assert abs(est - jest) < 5 * math.sqrt(2) * sigma
    # batches: n // batches draws each; the same seed gives the same value
    assert TMC.pi_estimate(n, seed=1, batches=4) == \
        TMC.pi_estimate(n, seed=1, batches=4)
    assert abs(TMC.pi_estimate(n + 3, seed=1, batches=4) - math.pi) < \
        5 * sigma


def _abs_fn(x):
    return jnp.abs(x)


def test_expectation_within_5_se_of_truth_and_of_jax():
    n = 200_000
    est, se = TMC.expectation(torch.abs, n)
    jest, jse = JMC.expectation(_abs_fn, n)
    truth = math.sqrt(2 / math.pi)
    assert abs(est - truth) < 5 * se
    assert abs(est - jest) < 5 * math.hypot(se, jse)
    # se * sqrt(n) is the std of |X|: sqrt(1 - 2 / pi)
    np.testing.assert_allclose(se * math.sqrt(n),
                               math.sqrt(1 - 2 / math.pi), rtol=1e-2)
    np.testing.assert_allclose(se, jse, rtol=1e-2)


def test_expectation_uses_the_population_std():
    # f ignores the draws: the estimate is the mean of 0..9 and the error
    # the population std (correction 0, as jnp.std) over sqrt(n)
    est, se = TMC.expectation(lambda v: v * 0 + torch.arange(10.0), 10)
    assert est == pytest.approx(4.5)
    assert se == pytest.approx(math.sqrt(8.25) / math.sqrt(10))


def test_montecarlo_validation():
    with pytest.raises(ValueError, match="batches"):
        TMC.pi_estimate(10, batches=0)
    with pytest.raises(ValueError, match="batches"):
        TMC.pi_estimate(3, batches=4)
