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


# the dtypes and shapes of the dtype parity cases (ROADMAP.md C1-C5)
TYPED_DTYPES = ["float16", "bfloat16", "uint8", "int8", "bool"]
TYPED_SHAPES = [(37, 11), (50, 8), (13,), (9, 7, 5)]


def typed_inputs(dtype: str, shape, seed: int, lo=-100.0, hi=100.0):
    """The same seeded values as a numpy array for the JAX package (bfloat16
    as ``ml_dtypes.bfloat16``) and as a tensor for the port: integers over
    the type's range, bools at random, floats uniform in [lo, hi) rounded
    once to the type."""
    import ml_dtypes
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        a = rng.integers(0, 2, shape).astype(bool)
    elif dtype in ("uint8", "int8"):
        info = np.iinfo(dtype)
        a = rng.integers(info.min, info.max + 1, shape).astype(dtype)
    else:
        f = rng.uniform(lo, hi, shape).astype(np.float32)
        if dtype == "bfloat16":
            return f.astype(ml_dtypes.bfloat16), torch.from_numpy(f).bfloat16()
        a = f.astype(dtype)
    return a, torch.from_numpy(a)


def typed_result(x) -> tuple:
    """A JAX or port result (array, tensor or DArray) as its dtype's name
    and its values in float64 (bool kept)."""
    if isinstance(x, tdat.DArray):
        x = x.full()
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).removeprefix("torch.")
        v = x if x.dtype == torch.bool else x.to(torch.float64)
        return name, v.numpy()
    a = np.asarray(x)
    return a.dtype.name, a if a.dtype == bool else a.astype(np.float64)


def assert_typed_equal(port, jax_result, rtol: float = 0.0) -> None:
    """Same dtype and the same values: bit for bit (infs included), or to
    ``rtol`` where the caller states why."""
    (pn, pv), (jn, jv) = typed_result(port), typed_result(jax_result)
    assert pn == jn, f"dtype {pn} != JAX's {jn}"
    if rtol:
        np.testing.assert_allclose(pv, jv, rtol=rtol)
    else:
        np.testing.assert_array_equal(pv, jv)


def emulated_copies(calls):
    """A stand-in for ``cuda_collectives._copy_on_card`` that runs the copy
    kernel's semantics on host memory (each copy's boxes moved row by row
    with ``memmove``) and records ``(kernel, launches)``: with ``_on_cuda``
    stubbed to True, the CUDA path of a collective runs on CPU tensors."""
    import ctypes
    import itertools

    from distributedarrays_tpu_torch.ops import cuda_collectives as C

    def run(copies, dev, kernel):
        launches = C.copy_launches(copies)
        calls.append((kernel, len(launches)))
        for launch in launches:
            for src, (sizes, sstr, run_b), part in launch:
                for dst, dstr in part:
                    for i, j, k in itertools.product(*map(range, sizes)):
                        ctypes.memmove(
                            dst + i * dstr[0] + j * dstr[1] + k * dstr[2],
                            src + i * sstr[0] + j * sstr[1] + k * sstr[2],
                            run_b)
    return run
