"""``dnnz`` and ``ddata_bcoo`` of the PyTorch port against the JAX package
(``tests/test_extensions.py``'s sparse cases, the same seeded inputs):
counts are exact integers, compared exactly."""

import numpy as np
import pytest
import torch

import distributedarrays_tpu as dat
import distributedarrays_tpu_torch as tdat

from _torch_port import port_ranks  # noqa: F401

# (shape, dist, procs, threshold): test_dnnz_dense and test_dnnz_bcoo's
# inputs, and uneven and 1-D layouts
CASES = {
    "dense_32x32": ((32, 32), None, None, 0.5),
    "bcoo_16x16_4x1": ((16, 16), (4, 1), range(4), 1.0),
    "uneven_37x11": ((37, 11), None, None, 0.0),
    "uneven_50x8_4x2": ((50, 8), (4, 2), None, 1.0),
    "vector_1001": ((1001,), None, None, 0.3),
}


def _sparse_input(shape, threshold, seed=0):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    a[np.abs(a) < threshold] = 0
    return a


@pytest.mark.parametrize("name", list(CASES))
def test_dnnz_dense_like_jax(name):
    shape, dist, procs, thr = CASES[name]
    a = _sparse_input(shape, thr)
    jd = dat.distribute(a, procs=procs, dist=dist)
    td = tdat.distribute(a, procs=procs, dist=dist)
    got = tdat.dnnz(td)
    assert isinstance(got, int)
    assert got == dat.dnnz(jd) == int(np.count_nonzero(a))


@pytest.mark.parametrize("name", [n for n in CASES if len(CASES[n][0]) == 2])
def test_ddata_bcoo_like_jax(name):
    shape, dist, procs, thr = CASES[name]
    a = _sparse_input(shape, thr)
    jd = dat.distribute(a, procs=procs, dist=dist)
    td = tdat.distribute(a, procs=procs, dist=dist)
    jdd, tdd = dat.ddata_bcoo(jd), tdat.ddata_bcoo(td)
    assert isinstance(tdd, tdat.DData)
    assert tdat.dnnz(tdd) == dat.dnnz(jdd) == int(np.count_nonzero(a))
    assert [int(p) for p in tdd.pids] == [int(p) for p in jdd.pids]
    for pid, jpart, tpart in zip(tdd.pids, jdd.gather(), tdd.gather()):
        # one coalesced COO tensor a rank, on its device, holding that
        # rank's chunk; JAX's BCOO part holds the same entries
        assert tpart.layout == torch.sparse_coo and tpart.is_coalesced()
        assert tpart.device == tdat.device_of(int(pid))
        np.testing.assert_array_equal(tpart.to_dense().numpy(),
                                      np.asarray(jpart.todense()))
        np.testing.assert_array_equal(tpart.to_dense().numpy(),
                                      td.localpart(int(pid)).numpy())
        assert tpart._nnz() == int(jpart.nse)


def test_dnnz_of_mixed_ddata_and_host():
    # dense DData parts count their nonzeros; a host array is one part
    a = _sparse_input((16, 16), 1.0)
    dd = tdat.ddata(init=lambda i: torch.from_numpy(a[4 * i:4 * i + 4]),
                    pids=range(4))
    assert tdat.dnnz(dd) == int(np.count_nonzero(a))
    assert tdat.dnnz(a) == int(np.count_nonzero(a))
