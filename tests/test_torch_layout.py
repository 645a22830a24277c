"""Layout algebra of the PyTorch port against the JAX package: exact."""

import numpy as np
import pytest

import distributedarrays_tpu.layout as JL
import distributedarrays_tpu_torch.layout as TL

from _torch_port import port_ranks  # noqa: F401  (autouse fixture)


@pytest.mark.parametrize("dims,nprocs", [
    ((50, 8), 8), ((8192, 8192), 8), ((3,), 8), ((7, 5, 3), 12),
    ((100,), 7), ((2, 2), 1), ((50, 4), 4), ((1, 9), 6)])
def test_defaultdist(dims, nprocs):
    assert TL.defaultdist(dims, range(nprocs)) == \
        JL.defaultdist(dims, range(nprocs))


@pytest.mark.parametrize("sz,nc", [(50, 4), (3, 8), (0, 3), (100, 7),
                                   (8, 8)])
def test_defaultdist_1d(sz, nc):
    assert TL.defaultdist_1d(sz, nc) == JL.defaultdist_1d(sz, nc)


def test_defaultdist_1d_reference_value():
    assert TL.defaultdist_1d(50, 4) == [0, 13, 26, 38, 50]


@pytest.mark.parametrize("dims,chunks", [((50, 8), (4, 2)), ((10,), (3,)),
                                         ((5, 6, 7), (2, 3, 1)),
                                         ((3, 4), (4, 1))])
def test_chunk_idxs(dims, chunks):
    ti, tc = TL.chunk_idxs(dims, chunks)
    ji, jc = JL.chunk_idxs(dims, chunks)
    assert tc == jc
    assert ti.shape == ji.shape
    for ci in np.ndindex(*ji.shape):
        assert ti[ci] == ji[ci]


def test_locate():
    rng = np.random.default_rng(0)
    _, cuts = JL.chunk_idxs((50, 8), (4, 2))
    _, ecuts = JL.chunk_idxs((3, 5), (8, 1))        # empty trailing chunks
    for c, dims in ((cuts, (50, 8)), (ecuts, (3, 5))):
        for _ in range(50):
            idx = tuple(int(rng.integers(0, n)) for n in dims)
            assert TL.locate(c, *idx) == JL.locate(c, *idx)
    with pytest.raises(IndexError):
        TL.locate(cuts, 50, 0)


def test_cut_intersections_and_spans():
    rng = np.random.default_rng(1)
    for _ in range(40):
        n = int(rng.integers(1, 60))
        a = sorted({0, n, *rng.integers(0, n, 4).tolist()})
        b = sorted({0, n, *rng.integers(0, n, 5).tolist()})
        assert TL.cut_intersections(a, b) == JL.cut_intersections(a, b)
        lo, hi = sorted(rng.integers(0, n + 1, 2).tolist())
        assert TL.chunk_span(a, lo, hi) == JL.chunk_span(a, lo, hi)
    assert TL.even_cuts((12, 8), (3, 2)) == JL.even_cuts((12, 8), (3, 2))
    with pytest.raises(ValueError):
        TL.even_cuts((10,), (3,))


def test_rank_table():
    devs = TL.init(nranks=3, device="cpu")
    assert len(devs) == 3 and TL.nranks() == 3
    assert TL.all_ranks() == [0, 1, 2]
    assert TL.device_of(2).type == "cpu"
    with pytest.raises(ValueError):
        TL.device_of(3)
    with pytest.raises(ValueError):
        TL.init(nranks=0, device="cpu")
