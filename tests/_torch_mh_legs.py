"""The cross-process legs of the port's multi-process tests.

``legs(tdat, N)`` lists the ops that a process-spanning DArray now runs
across controller processes (the distributed GEMM forms, the transposes,
the reshard and what rests on it, the element reads, ``djit`` and the
scans), as ``(name, thunk)`` in the order every process runs them.  The
child program (``tests/_torch_multihost_child.py``) runs them in a job of
``N // 4`` processes; ``tests/test_torch_multihost.py`` runs the same
thunks in one process on ``N`` ranks and holds the job's results against
them bit for bit, against numpy and, for the 8-rank job, against the JAX
package.  ``summary(tdat, gather, value)`` turns a result into what the
tests compare (``gather`` is ``multihost.gather_global`` in the job), and
lists the tensors a caller was handed on the ``meta`` device.
"""

import numpy as np
import torch


def data(N: int) -> dict:
    """The legs' inputs, the same on every process (seeded numpy)."""
    rng = np.random.default_rng(21)
    X = np.linspace(-1.0, 1.0, 64, dtype=np.float32).reshape(16, 4)
    Y = np.cos(np.arange(64, dtype=np.float32)).reshape(16, 4)
    return {
        "X": X, "Y": Y,
        # the JAX child's GEMM operands (tests/_multihost_child.py)
        "Am": np.arange(32.0 * 4 * N, dtype=np.float32).reshape(
            32, 4 * N) / 100,
        "Bm": np.arange(4.0 * N * 8, dtype=np.float32).reshape(4 * N, 8) / 100,
        "W": rng.standard_normal((4 * N, 12)).astype(np.float32),
        "V": rng.standard_normal((12, 2 * N)).astype(np.float32),
        "v": rng.standard_normal(4 * N).astype(np.float32),
        "Cm": rng.standard_normal((5, 32)).astype(np.float32),
        "C0": rng.standard_normal((32, 8)).astype(np.float32),
        "G": (rng.standard_normal((12, 10)) +
              1j * rng.standard_normal((12, 10))).astype(np.complex64),
        "H": rng.standard_normal((10, 6)).astype(np.float32),
        "R": np.arange(16.0 * 2 * N, dtype=np.float32).reshape(16, 2 * N),
        "U": np.arange(50.0 * 8, dtype=np.float32).reshape(50, 8),
        "Z": np.where(X > 0.2, X, 0).astype(np.float32),
        "S": np.arange(64.0, dtype=np.float32).reshape(16, 4) / 7,
        "su": np.arange(50.0, dtype=np.float32) / 9,
        "B8": np.arange(128, dtype=np.float32).reshape(16, 8),
        "I": rng.integers(-50, 50, (16, 8)).astype(np.int32),
    }


def legs(tdat, N: int) -> list:
    """``(name, thunk)`` of every leg, in the order the processes run
    them; each thunk returns a DArray, a tensor, a list of rank tensors,
    or a tuple of Python values."""
    D = data(N)
    RS = tdat.reshard
    dx, dy = tdat.distribute(D["X"]), tdat.distribute(D["Y"])
    d2 = tdat.distribute(D["Y"], procs=range(N), dist=(N // 2, 2))
    da = tdat.distribute(D["Am"], procs=range(N), dist=(2, N // 2))
    db = tdat.distribute(D["Bm"], procs=range(N), dist=(N // 2, 2))
    dw = tdat.distribute(D["W"], procs=range(N), dist=(N // 2, 2))
    dv = tdat.distribute(D["V"], procs=range(N), dist=(2, N // 2))
    d8 = tdat.distribute(D["B8"])
    dz = tdat.distribute(D["Z"])
    ds = tdat.distribute(D["S"])
    di = tdat.distribute(D["I"])
    dR = tdat.distribute(D["R"], procs=range(N), dist=(N, 1))
    dU = tdat.distribute(D["U"], procs=range(N), dist=(N // 2, 2))
    # a layout whose transpose's default cuts differ, over both processes
    dH = tdat.darray_from_cuts(D["H"], [0, N - 1, 1, N - 2],
                               [[0, 3, 10], [0, 2, 6]])

    def mul_into():
        C = tdat.distribute(D["C0"], procs=range(N), dist=(2, 2))
        return tdat.mul_into(C, da, db, alpha=2.0, beta=0.5)

    def relayout(d, grid):
        cuts = tdat.layout.chunk_idxs(d.dims, grid)[1]
        return RS.reshard(d, np.arange(N).reshape(grid), cuts)

    def relayout_to(d, pids, cuts):
        return RS.relayout(d, np.asarray(pids), cuts)

    def eq():
        same = tdat.distribute(D["X"])
        return (dx == same, dx == dy, dx == D["X"], d2 == tdat.distribute(
            D["Y"]), dx[0:8] == D["X"][0:8], dx == D["X"] + 1)

    def bcoo():
        b = tdat.ddata_bcoo(dz)
        parts = {p: v.to_dense().numpy() for p, v in b._parts.items()
                 if tdat.layout.is_local(p)}
        return (tdat.dnnz(b), parts)

    def scalar():
        with tdat.allowscalar(True):
            return (float(d8[12, 3]), float(d8[15, 7]), float(d8[0, 0]))

    out = [
        # the distributed GEMM forms
        ("gemm", lambda: da @ db),
        ("gemm_wide", lambda: dw @ dv),
        ("matvec_host", lambda: da @ D["v"]),
        ("matvec", lambda: da @ tdat.distribute(D["v"])),
        ("gemm_host", lambda: da @ torch.from_numpy(D["Bm"])),
        ("gemm_sub", lambda: da @ db[:, 0:5]),
        ("rmatmul", lambda: D["Cm"] @ (da @ db)),
        ("mul_into", mul_into),
        ("bool_gemm", lambda: (da > 0.3) @ (db > 0.2)),
        # the transposes
        ("dtranspose", lambda: tdat.dtranspose(da)),
        ("dadjoint", lambda: tdat.dadjoint(tdat.distribute(
            D["G"], procs=range(N), dist=(2, N // 2)))),
        ("dtranspose_cuts", lambda: tdat.dtranspose(dH)),
        # the reshard and what rests on it
        ("relayout_a2a", lambda: relayout(dR, (1, N))),
        ("relayout_chain", lambda: relayout(dx, (N // 2, 2))),
        ("relayout_uneven", lambda: relayout(dU, (2, N // 2))),
        ("relayout_ranks", lambda: relayout_to(dx, [[N - 1], [0]],
                                               [[0, 8, 16], [0, 4]])),
        ("allgather", lambda: RS.allgather(dx, [0, N - 1, 5])),
        ("ops_mismatch", lambda: dx + d2),
        ("distribute", lambda: tdat.distribute(dx, dist=(N // 2, 2))),
        ("reshape", lambda: dx.reshape(4, 16)),
        ("dcat", lambda: tdat.dcat(0, dx, dy)),
        ("dcat_layouts", lambda: tdat.dcat(1, dx, d2)),
        ("samedist", lambda: tdat.samedist(d2, dx)),
        ("mapslices", lambda: tdat.mapslices(lambda c: c * 2 + c.sum(),
                                             dx, 1)),
        ("ppeval", lambda: tdat.ppeval(lambda c: c * 3 - 1, dx)),
        # element reads
        ("eq", eq),
        ("dnnz", lambda: (tdat.dnnz(dz),)),
        ("ddata_bcoo", bcoo),
        ("adv_rows", lambda: dx[[1, 3, 5, 14]]),
        ("adv_mask", lambda: dx[D["X"] > 0.5]),
        ("adv_mixed", lambda: dx[[0, 2], 1:3]),
        ("ddot", lambda: tdat.ddot(d8, d8)),
        ("ddot_layouts", lambda: tdat.ddot(dy, d2)),
        ("ddot_int", lambda: tdat.ddot(di, di)),
        ("dnorm", lambda: tdat.dnorm(dx)),
        ("dnorm1", lambda: tdat.dnorm(dx, 1)),
        ("dnorm_inf", lambda: tdat.dnorm(dx, np.inf)),
        ("dnorm0", lambda: tdat.dnorm(dz, 0)),
        ("dfetch", lambda: tdat.dfetch(d8, 12, 3)),
        ("dfetch_first", lambda: tdat.dfetch(d8, 0, 0)),
        ("scalar", scalar),
        ("dmean_bool", lambda: tdat.dmean(tdat.distribute(D["B8"] > 3))),
        ("dmean_int", lambda: tdat.dmean(di)),
        ("dmean_int_0", lambda: tdat.dmean(di, dims=0)),
        # djit
        ("djit", lambda: tdat.djit(lambda a, b: torch.sin(a) + b * a)(
            dx, dy)),
        ("djit_scalar", lambda: tdat.djit(lambda a: (a * a).sum())(dx)),
        # the scans
        ("dcumsum", lambda: tdat.dcumsum(ds, axis=0)),
        ("dcumsum_1", lambda: tdat.dcumsum(d2, axis=1)),
        ("dcumprod", lambda: tdat.dcumprod(dx * 0.1 + 1, axis=0)),
        ("dcummax", lambda: tdat.dcummax(dy, axis=0)),
        ("dcummin_1", lambda: tdat.dcummin(d2, axis=1)),
        ("dcumsum_uneven", lambda: tdat.dcumsum(tdat.distribute(D["su"]))),
    ]
    assert [name for name, _ in out] == NAMES
    return out


NAMES = [
    "gemm", "gemm_wide", "matvec_host", "matvec", "gemm_host", "gemm_sub",
    "rmatmul", "mul_into", "bool_gemm", "dtranspose", "dadjoint",
    "dtranspose_cuts", "relayout_a2a", "relayout_chain", "relayout_uneven",
    "relayout_ranks", "allgather", "ops_mismatch", "distribute", "reshape",
    "dcat", "dcat_layouts", "samedist", "mapslices", "ppeval", "eq", "dnnz",
    "ddata_bcoo", "adv_rows", "adv_mask", "adv_mixed", "ddot",
    "ddot_layouts", "ddot_int", "dnorm", "dnorm1", "dnorm_inf", "dnorm0",
    "dfetch", "dfetch_first", "scalar", "dmean_bool", "dmean_int",
    "dmean_int_0", "djit", "djit_scalar", "dcumsum", "dcumsum_1", "dcumprod",
    "dcummax", "dcummin_1", "dcumsum_uneven"]


def _layout(d) -> dict:
    return {"cuts": [list(c) for c in d.cuts], "pids": d.pids.tolist()}


def summary(tdat, gather, value):
    """``(what the tests compare, [kinds of meta tensors handed out])``:
    a DArray as its gathered values, layout and dtype (its local chunks
    checked); a SubDArray materialized; a tensor as numpy; a list of rank tensors as this process's
    ``{index: numpy}``; other values as they are."""
    meta = []
    if isinstance(value, tdat.SubDArray):
        value = value.materialize()
    if isinstance(value, tdat.DArray):
        for ci in value.cells():
            rank = int(value.pids[ci])
            if tdat.layout.is_local(rank) and \
                    value._parts[ci].device.type == "meta":
                meta.append(f"rank {rank}'s chunk")
        return (gather(value), _layout(value), str(value.dtype)), meta
    if isinstance(value, torch.Tensor):
        if value.device.type == "meta":
            meta.append("tensor")
            return None, meta
        return value.detach().cpu().numpy(), meta
    if isinstance(value, list):
        out = {}
        for i, t in enumerate(value):
            if t.device.type != "meta":
                out[i] = t.cpu().numpy()
        return out, meta
    return value, meta
