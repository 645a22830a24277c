"""Shared set-up of the parity tests between the JAX package and its
PyTorch port (``tests/test_torch_*.py``).

The port runs on 8 CPU ranks, mirroring the 8 virtual XLA devices of the
JAX harness; inputs are made with seeded numpy and handed to both packages.
The port keeps its own DArray registry, which the conftest leak gate does
not read, so the fixture closes what each test made and checks that the
port's registry is empty afterwards.
"""

import numpy as np
import pytest
import torch

import distributedarrays_tpu_torch as tdat


@pytest.fixture(autouse=True)
def port_ranks():
    # tier-1 runs several pytest workers: keep each to one intra-op thread
    torch.set_num_threads(1)
    tdat.init(nranks=8, device="cpu")
    tdat.seed(1234)
    tdat.autotune.clear()
    yield
    tdat.autotune.clear()
    tdat.d_closeall()
    assert tdat.live_ids() == []


def state_of(d) -> dict:
    """A JAX DArray's state in the form ``interop.from_reference`` takes."""
    return {"array": np.asarray(d), "cuts": d.cuts, "pids": d.pids}


def same_layout(jd, td) -> None:
    """Assert that a JAX DArray and a port DArray have one layout."""
    assert tuple(td.dims) == tuple(jd.dims)
    assert [list(c) for c in td.cuts] == [list(c) for c in jd.cuts]
    np.testing.assert_array_equal(td.pids, jd.pids)
