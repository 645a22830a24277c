"""Linear algebra of the PyTorch port beyond the block GEMM: the owned
distributed-GEMM dispatch (``matmul_impl_dist``: the ring all-gather GEMM
and Cannon/SUMMA), its tuners, BLAS-1, the diagonal scalings and
``dadjoint``, against the JAX package (mirroring ``tests/test_linalg.py``).

float32 results agree to rtol 1e-5 (summation order), values that only
move data exactly.  ``ddot`` and ``dnorm`` over float16, bfloat16, uint8,
int8 and bool agree with JAX in dtype and value: exactly for integer dots
(wrapped in the input type) and for half-precision dots and norms (one
float32 sum rounded once to the type; a float16 2-norm overflows to inf as
in JAX), to rtol 1e-6 for the float32 norms of integers (sum order).
"""

import numpy as np
import pytest
import torch

import distributedarrays_tpu as dat
import distributedarrays_tpu_torch as tdat
from distributedarrays_tpu_torch.ops import linalg as la
from distributedarrays_tpu_torch.parallel import reshard as TR

from _torch_port import (TYPED_DTYPES, TYPED_SHAPES,  # noqa: F401
                         assert_typed_equal, port_ranks, same_layout,
                         typed_inputs)


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _spy(monkeypatch, name):
    called = []
    orig = getattr(la, name)
    monkeypatch.setattr(la, name, lambda *a: called.append(1) or orig(*a))
    return called


def test_matmul_ring_allgather_dispatch(rng, monkeypatch):
    A = rng.standard_normal((16, 32)).astype(np.float32)
    B = rng.standard_normal((32, 12)).astype(np.float32)
    da = tdat.distribute(A, procs=range(4), dist=(4, 1))
    db = tdat.distribute(B, procs=range(4), dist=(4, 1))
    called = _spy(monkeypatch, "_ring_ag_gemm")
    gathered = []
    orig = la.allgather
    monkeypatch.setattr(la, "allgather",
                        lambda *a: gathered.append(1) or orig(*a))
    # default: each rank multiplies with the all-gathered B
    C0 = da @ db
    assert not called and gathered
    np.testing.assert_allclose(np.asarray(C0), A @ B, rtol=1e-5, atol=1e-5)
    jr = dat.distribute(A, procs=range(4), dist=(4, 1)) @ \
        dat.distribute(B, procs=range(4), dist=(4, 1))
    same_layout(jr, C0)
    # promoted: the ring, out-of-place and mul_into
    tdat.autotune.record("matmul_impl_dist",
                         la._impl_key(16, 12, 32, 4, da.dtype, db.dtype),
                         "ring_ag")
    C1 = da @ db
    assert called
    np.testing.assert_allclose(np.asarray(C1), A @ B, rtol=1e-5, atol=1e-5)
    same_layout(jr, C1)
    called.clear()
    C2 = tdat.dzeros((16, 12), procs=range(4), dist=(4, 1))
    assert la.mul_into(C2, da, db) is C2
    assert called
    np.testing.assert_allclose(np.asarray(C2), A @ B, rtol=1e-5, atol=1e-5)
    # alpha/beta stays off the ring
    called.clear()
    C3 = tdat.dzeros((16, 12), procs=range(4), dist=(4, 1))
    la.mul_into(C3, da, db, alpha=2.0)
    assert not called
    np.testing.assert_allclose(np.asarray(C3), 2 * (A @ B), rtol=1e-5,
                               atol=1e-5)
    dat.d_closeall()


def test_ring_ag_eligibility_rules(rng):
    A = rng.standard_normal((16, 32)).astype(np.float32)
    B = rng.standard_normal((32, 12)).astype(np.float32)
    da = tdat.distribute(A, procs=range(4), dist=(4, 1))
    db = tdat.distribute(B, procs=range(4), dist=(4, 1))
    procs = list(range(8))
    assert la._ring_ag_eligible(da, db, procs, [4, 1])
    assert not la._ring_ag_eligible(da, db, procs, [2, 1])
    assert not la._ring_ag_eligible(da, B, procs, [4, 1])
    assert not la._ring_ag_eligible(
        da, tdat.distribute(B, procs=[3, 2, 1, 0], dist=(4, 1)),
        procs, [4, 1])
    # uneven chunks stay off the ring
    du = tdat.distribute(rng.standard_normal((18, 32)).astype(np.float32),
                         procs=range(4), dist=(4, 1))
    assert not la._ring_ag_eligible(du, db, procs, [4, 1])


def test_matmul_summa_dispatch(rng, monkeypatch):
    A = rng.standard_normal((16, 24)).astype(np.float32)
    B = rng.standard_normal((24, 8)).astype(np.float32)
    da = tdat.distribute(A, procs=range(4), dist=(2, 2))
    db = tdat.distribute(B, procs=range(4), dist=(2, 2))
    called = _spy(monkeypatch, "_summa_gemm")
    C0 = da @ db
    assert not called
    np.testing.assert_allclose(np.asarray(C0), A @ B, rtol=1e-5, atol=1e-5)
    tdat.autotune.record("matmul_impl_dist",
                         la._impl_key(16, 8, 24, "2x2", da.dtype, db.dtype),
                         "summa")
    C1 = da @ db
    assert called
    np.testing.assert_allclose(np.asarray(C1), A @ B, rtol=1e-5, atol=1e-5)
    assert C1.grid == (2, 2) and C1.cuts[0] == da.cuts[0]
    called.clear()
    C2 = tdat.dzeros((16, 8), procs=range(4), dist=(2, 2))
    la.mul_into(C2, da, db)
    assert called
    np.testing.assert_allclose(np.asarray(C2), A @ B, rtol=1e-5, atol=1e-5)
    called.clear()
    C3 = tdat.dzeros((16, 8), procs=range(4), dist=(2, 2))
    la.mul_into(C3, da, db, alpha=2.0)
    assert not called
    np.testing.assert_allclose(np.asarray(C3), 2 * (A @ B), rtol=1e-5,
                               atol=1e-5)
    # mismatched grids are not eligible, even with a registry entry
    da2 = tdat.distribute(A, procs=range(8), dist=(2, 4))
    db2 = tdat.distribute(B, procs=range(8), dist=(4, 2))
    tdat.autotune.record("matmul_impl_dist",
                         la._impl_key(16, 8, 24, "2x4", da2.dtype, db2.dtype),
                         "summa")
    called.clear()
    C4 = da2 @ db2
    assert not called
    np.testing.assert_allclose(np.asarray(C4), A @ B, rtol=1e-5, atol=1e-5)


def test_matmul_summa_rectangular_dispatch(rng, monkeypatch):
    A = rng.standard_normal((16, 24)).astype(np.float32)
    B = rng.standard_normal((24, 8)).astype(np.float32)
    da = tdat.distribute(A, procs=range(8), dist=(2, 4))
    db = tdat.distribute(B, procs=range(8), dist=(2, 4))
    called = _spy(monkeypatch, "_summa_gemm")
    tdat.autotune.record("matmul_impl_dist",
                         la._impl_key(16, 8, 24, "2x4", da.dtype, db.dtype),
                         "summa")
    C1 = da @ db
    assert called and C1.grid == (2, 4)
    np.testing.assert_allclose(np.asarray(C1), A @ B, rtol=1e-5, atol=1e-5)
    jr = dat.distribute(A, procs=range(8), dist=(2, 4)) @ \
        dat.distribute(B, procs=range(8), dist=(2, 4))
    same_layout(jr, C1)
    np.testing.assert_allclose(np.asarray(C1), np.asarray(jr), rtol=1e-5,
                               atol=1e-5)
    dat.d_closeall()


def test_tune_matmul_impl_dist_banks_winner():
    times = {"torch": 1.0, "ring_ag": 0.5}
    seen = []

    def timer(op, a, b):
        assert a.shape == (64, 32) and b.shape == (32, 16)
        assert a.grid == (4, 1) and b.grid == (4, 1)
        name = "torch" if not seen else "ring_ag"
        seen.append(name)
        return times[name]

    winner, results = tdat.tune_matmul_impl_dist(64, 16, 32, p=4,
                                                 timer=timer)
    assert winner == "ring_ag" and results == times
    assert la._dist_impl_choice(64, 16, 32, 4, torch.float32,
                                torch.float32) == "ring_ag"
    with pytest.raises(ValueError, match="ranks"):
        tdat.tune_matmul_impl_dist(64, 16, 32, p=1, timer=timer)
    with pytest.raises(ValueError, match="divisible"):
        tdat.tune_matmul_impl_dist(63, 16, 32, p=4, timer=timer)
    # the default timer runs both candidates for real
    winner, results = tdat.tune_matmul_impl_dist(16, 8, 8, p=4)
    assert set(results) == {"torch", "ring_ag"}
    assert all(t >= 0 for t in results.values())


def test_tune_matmul_impl_summa_banks_winner():
    times = {"torch": 1.0, "summa": 0.5}
    seen = []

    def timer(op, a, b):
        assert a.shape == (16, 24) and b.shape == (24, 8)
        name = "torch" if not seen else "summa"
        seen.append(name)
        return times[name]

    winner, results = tdat.tune_matmul_impl_summa(16, 8, 24, g=2,
                                                  timer=timer)
    assert winner == "summa" and results == times
    assert la._summa_impl_choice(16, 8, 24, 2, 2, torch.float32,
                                 torch.float32) == "summa"
    with pytest.raises(ValueError, match="divisible"):
        tdat.tune_matmul_impl_summa(15, 8, 24, g=2, timer=timer)
    with pytest.raises(ValueError, match="2x2"):
        tdat.tune_matmul_impl_summa(16, 8, 24, g=(1, 4), timer=timer)
    winner, results = tdat.tune_matmul_impl_summa(
        16, 8, 24, g=(2, 4), timer=lambda op, a, b: 1.0)
    assert set(results) == {"torch", "summa"}
    assert la._summa_impl_choice(16, 8, 24, 2, 4, torch.float32,
                                 torch.float32) is not None


def test_matvec_gathers_a_chunked_vector(rng, monkeypatch):
    A = rng.standard_normal((16, 8)).astype(np.float32)
    v = rng.standard_normal(8).astype(np.float32)
    gathered = []
    orig = TR.ring_all_gather
    monkeypatch.setattr(TR, "ring_all_gather",
                        lambda *a: gathered.append(1) or orig(*a))
    da = tdat.distribute(A, procs=range(4), dist=(4, 1))
    r = tdat.matmul(da, tdat.distribute(v, procs=range(4), dist=(4,)))
    assert gathered
    jr = dat.matmul(dat.distribute(A, procs=range(4), dist=(4, 1)),
                    dat.distribute(v, procs=range(4), dist=(4,)))
    same_layout(jr, r)
    np.testing.assert_allclose(np.asarray(r), np.asarray(jr), rtol=1e-5,
                               atol=1e-5)
    dat.d_closeall()


# ---------------------------------------------------------------------------
# BLAS-1, diagonal scalings, adjoint
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("xdist,ydist", [((4, 1), (4, 1)), ((2, 2), (4, 1)),
                                         (None, (1, 4))])
def test_axpy_matches_jax(rng, xdist, ydist):
    x = rng.standard_normal((16, 12)).astype(np.float32)
    y = rng.standard_normal((16, 12)).astype(np.float32)
    jy = dat.distribute(y, dist=ydist)
    ty = tdat.distribute(y, dist=ydist)
    jx = x if xdist is None else dat.distribute(x, dist=xdist)
    tx = x if xdist is None else tdat.distribute(x, dist=xdist)
    assert tdat.axpy_(0.3, tx, ty) is ty
    dat.axpy_(0.3, jx, jy)
    same_layout(jy, ty)
    np.testing.assert_allclose(np.asarray(ty), np.asarray(jy), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(ValueError, match="axpy_"):
        tdat.axpy_(1.0, np.zeros((3, 3), np.float32), ty)
    dat.d_closeall()


@pytest.mark.parametrize("dist", [(4, 1), (2, 4), None])
def test_ddot_and_dnorm_match_jax(rng, dist):
    x = rng.standard_normal((16, 12)).astype(np.float32)
    y = rng.standard_normal((16, 12)).astype(np.float32)
    # y on another layout of the same ranks (JAX refuses mixed device sets)
    ydist = (1, 4) if dist == (4, 1) else (8, 1)
    jx, jy = dat.distribute(x, dist=dist), dat.distribute(y, dist=ydist)
    tx, ty = tdat.distribute(x, dist=dist), tdat.distribute(y, dist=ydist)
    np.testing.assert_allclose(float(tdat.ddot(tx, ty)),
                               float(dat.ddot(jx, jy)), rtol=1e-5)
    np.testing.assert_allclose(float(tdat.ddot(tx, y)), float(np.vdot(x, y)),
                               rtol=1e-5)
    for p in (2, 1, np.inf, -np.inf, 3, 0):
        np.testing.assert_allclose(float(tdat.dnorm(tx, p)),
                                   float(dat.dnorm(jx, p)), rtol=1e-5)
    with pytest.raises(ValueError, match="ddot"):
        tdat.ddot(tx, np.zeros(3, np.float32))
    dat.d_closeall()


def test_rmul_lmul_and_diagonal_scalings_match_jax(rng):
    x = rng.standard_normal((16, 12)).astype(np.float32)
    dr = rng.standard_normal(16).astype(np.float32)
    dc = rng.standard_normal(12).astype(np.float32)
    jd, td = dat.distribute(x, dist=(4, 2)), tdat.distribute(x, dist=(4, 2))
    for jop, top in ((lambda d: dat.rmul_(d, 2.5),
                      lambda d: tdat.rmul_(d, 2.5)),
                     (lambda d: dat.lmul_(-0.5, d),
                      lambda d: tdat.lmul_(-0.5, d)),
                     (lambda d: dat.lmul_diag(dr, d),
                      lambda d: tdat.lmul_diag(dr, d)),
                     (lambda d: dat.rmul_diag(d, dc),
                      lambda d: tdat.rmul_diag(d, dc)),
                     (lambda d: dat.lmul_diag(dat.distribute(dr), d),
                      lambda d: tdat.lmul_diag(tdat.distribute(dr), d))):
        jop(jd)
        assert top(td) is td
        np.testing.assert_array_equal(np.asarray(td), np.asarray(jd))
    same_layout(jd, td)
    with pytest.raises(ValueError, match="diag length"):
        tdat.lmul_diag(dc, td)
    with pytest.raises(ValueError, match="diag length"):
        tdat.rmul_diag(td, dr)
    dat.d_closeall()


@pytest.mark.parametrize("dims,dist", [((16, 12), (4, 2)), ((13, 7), None)])
def test_dadjoint_matches_jax(rng, dims, dist):
    x = (rng.standard_normal(dims) + 1j * rng.standard_normal(dims)).astype(
        np.complex64)
    ja = dat.dadjoint(dat.distribute(x, dist=dist))
    ta = tdat.dadjoint(tdat.distribute(x, dist=dist))
    same_layout(ja, ta)
    assert ta.dtype == torch.complex64
    np.testing.assert_array_equal(np.asarray(ta), np.asarray(ja))
    np.testing.assert_array_equal(np.asarray(ta), x.conj().T)
    real = rng.standard_normal(dims).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(tdat.dadjoint(tdat.distribute(real, dist=dist))), real.T)
    with pytest.raises(ValueError, match="dadjoint"):
        tdat.dadjoint(tdat.distribute(np.zeros(8, np.float32)))
    dat.d_closeall()


@pytest.mark.parametrize("shape", TYPED_SHAPES)
@pytest.mark.parametrize("dtype", TYPED_DTYPES)
def test_ddot_follows_jax_dtypes(dtype, shape):
    (a, ta), (b, tb) = (typed_inputs(dtype, shape, s, -30.0, 30.0)
                        for s in (23, 24))
    jr = dat.ddot(dat.distribute(a), dat.distribute(b))
    assert_typed_equal(tdat.ddot(tdat.distribute(ta), tdat.distribute(tb)),
                       jr)
    # a host operand on one side: the same promoted type and value
    assert_typed_equal(tdat.ddot(tdat.distribute(ta), tb), jr)
    dat.d_closeall()


@pytest.mark.parametrize("shape", TYPED_SHAPES)
@pytest.mark.parametrize("dtype", TYPED_DTYPES)
def test_dnorm_follows_jax_dtypes(dtype, shape):
    a, t = typed_inputs(dtype, shape, 25)
    jd, td = dat.distribute(a), tdat.distribute(t)
    # integers and bool become float32, whose sums differ in order between
    # the packages by a few float32 spacings; half types round one float32
    # sum once and agree exactly
    rtol = 1e-6 if dtype in ("uint8", "int8", "bool") else 0.0
    for p in (2, 1, np.inf, -np.inf, 0, 3):
        assert_typed_equal(tdat.dnorm(td, p), dat.dnorm(jd, p), rtol)
    dat.d_closeall()
