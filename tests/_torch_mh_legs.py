"""The cross-process legs of the port's multi-process tests.

``legs(tdat, N)`` lists the ops that a process-spanning DArray now runs
across controller processes (the distributed GEMM forms, the transposes,
the reshard and what rests on it, the element reads, ``djit``, the scans,
``run_spmd`` with the rank-list collectives, ``dsort``, the FFTs,
``dconv2d``, ring and Ulysses attention, k-means and ``dmatmul_int8``),
as ``(name, thunk)`` in the order every process runs them.  The
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
        # the rank-list collectives' blocks: 2N a rank, and a 2-D grid
        "P": (np.arange(2.0 * N * N, dtype=np.float32) % 23) / 7,
        "Q": rng.standard_normal((4 * N, 6)).astype(np.float32),
        # dsort: the JAX child's vector (tests/_multihost_child.py), ints
        # with ties, floats with NaNs, and a vector of one repeated key
        "sv": np.random.default_rng(7).standard_normal(8 * N).astype(
            np.float32),
        "si": rng.integers(-5, 5, 6 * N).astype(np.int32),
        "sn": np.where(rng.random(5 * N) < 0.2, np.nan,
                       rng.standard_normal(5 * N)).astype(np.float32),
        "s1": np.where(np.arange(4 * N) == 3, 2.0, 1.0).astype(np.float32),
        # the FFTs: the JAX child's matrix, a DVector of n % p^2 == 0
        "F1": np.sin(np.arange(4.0 * N * N, dtype=np.float32)).reshape(
            4 * N, N),
        "fv": np.cos(np.arange(2.0 * N * N, dtype=np.float32) / 3),
        # dconv2d: an image, an NHWC batch and their kernels
        "im": rng.standard_normal((4 * N, 12)).astype(np.float32),
        "k3": rng.standard_normal((3, 3)).astype(np.float32),
        "k5": rng.standard_normal((5, 5)).astype(np.float32),
        "nh": rng.standard_normal((2, 2 * N, 6, 3)).astype(np.float32),
        "kn": rng.standard_normal((3, 3, 3, 4)).astype(np.float32),
        # attention: the JAX child's (4N, 2, 8) ring, Ulysses' N heads
        "qkv": [rng.standard_normal((4 * N, 2, 8)).astype(np.float32)
                for _ in range(3)],
        "uqkv": [rng.standard_normal((4 * N, N, 4)).astype(np.float32)
                 for _ in range(3)],
        # k-means: three clusters in 3-D
        "km": (rng.standard_normal((16 * N, 3)) * 0.3 + np.repeat(
            np.eye(3) * 4, [6 * N, 5 * N, 5 * N], axis=0)).astype(
            np.float32),
        # dmatmul_int8's operands
        "ia": rng.standard_normal((4 * N, 16)).astype(np.float32),
        "ib": rng.standard_normal((16, 8)).astype(np.float32),
        "ca": rng.standard_normal((12, 12)).astype(np.float32),
        "cb": rng.standard_normal((12, 12)).astype(np.float32),
    }


def cannon_grid(N: int) -> tuple[int, list[int]]:
    """``dmatmul_int8``'s square grid and its ranks: 3 x 3 over 9 ranks
    of 3 processes where the job has them, else 2 x 2 over ranks of two
    processes."""
    if N >= 9:
        return 3, list(range(9))
    return 2, [0, N // 2, 1, N // 2 + 1]


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
    ] + _rank_list_legs(tdat, N, D)
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
    "dcummax", "dcummin_1", "dcumsum_uneven",
    "spmd_pshift", "spmd_pshift_back", "spmd_host", "spmd_pshifts",
    "spmd_pgather", "spmd_preduce", "spmd_pmax", "spmd_pmean",
    "spmd_psum_scatter", "spmd_pall_to_all", "spmd_pbcast", "spmd_halo",
    "spmd_halo_wrap", "spmd_halo_2d", "spmd_pbarrier", "spmd_subset",
    "dsort", "dsort_int_rev", "dsort_nan_minmax", "dsort_by",
    "dsort_one_key", "dsort_whole", "dsort_host_by", "dsort_subset",
    "dfft", "dfft_1",
    "dfft_vec", "difft_vec", "dfft2", "difft2", "dfft_host", "dconv2d",
    "dconv2d_5", "dconv2d_nhwc", "dconv2d_host", "ring_attention",
    "ring_attention_causal", "ulysses", "ulysses_causal", "kmeans",
    "kmeans_cols", "int8_rows", "int8_cannon"]


def _rank_list_legs(tdat, N: int, D: dict) -> list:
    """The legs of the ops on the rank-list collectives: ``run_spmd`` with
    every collective, ``dsort``, the FFTs, ``dconv2d``, ring and Ulysses
    attention, k-means and ``dmatmul_int8``."""
    ring = list(range(N))
    dp = tdat.distribute(D["P"])                       # 2N a rank
    dq = tdat.distribute(D["Q"], procs=range(N), dist=(N // 2, 2))

    def spmd(f, d=dp, ranks=None):
        return lambda: tdat.run_spmd(f, d.pids.tolist() if ranks is None
                                     else ranks, d)

    def flat(out):
        return [t for row in out for t in row]

    def pshifts(b):
        k, v = tdat.pshifts([b, [x * 2 for x in b]], [1, -3])
        return [torch.cat([x, y]) for x, y in zip(k, v)]

    def halo(wrap):
        def f(b):
            return [torch.cat([lo, x, hi]) for x, (lo, hi) in zip(
                b, tdat.halo_exchange(b, halo=3, wrap=wrap))]
        return spmd(f)

    def host():
        blocks = [np.full((2, 3), r, np.float32) for r in ring]
        return tdat.run_spmd(lambda b: tdat.pshift(b, 2), ring, blocks)

    def dist(x, grid=None, procs=None):
        return tdat.distribute(x, procs=range(N) if procs is None else procs,
                               dist=grid)

    def ulysses(causal):
        return lambda: tdat.ulysses_attention(
            *(dist(x, (N, 1, 1)) for x in D["uqkv"]), causal=causal,
            use_flash=True)

    def kmeans(grid):
        def run():
            C, shifts = tdat.kmeans.kmeans(dist(D["km"], grid), 3, iters=4,
                                           seed=1)
            return (C.cpu().numpy(), shifts)
        return run

    def cannon():
        g, procs = cannon_grid(N)
        A = dist(D["ca"], (g, g), procs)
        B = dist(D["cb"], (g, g), procs)
        return tdat.dmatmul_int8(A, B)

    sub = tdat.darray_from_cuts(np.array([3.0, 1.0, 2.0], np.float32),
                                [0, N - 1, 1, N - 2], [[0, 1, 1, 2, 3]])
    return [
        # run_spmd and the rank-list collectives (the JAX child's ring hop
        # first: at p >= 3 the +1 shift is direction-sensitive)
        ("spmd_pshift", spmd(lambda b: tdat.pshift(b, 1))),
        ("spmd_pshift_back", spmd(lambda b: tdat.pshift(b, -2, wrap=False))),
        ("spmd_host", host),
        ("spmd_pshifts", spmd(pshifts)),
        ("spmd_pgather", spmd(lambda b: tdat.pgather(b))),
        ("spmd_preduce", spmd(lambda b: tdat.preduce(
            [x * (r + 1) for r, x in enumerate(b)]))),
        ("spmd_pmax", spmd(lambda b: tdat.preduce(
            [torch.roll(x, r) for r, x in enumerate(b)], "max"))),
        ("spmd_pmean", spmd(lambda b: tdat.preduce(b, "mean"))),
        ("spmd_psum_scatter", spmd(lambda b: tdat.psum_scatter(
            tdat.pgather(b)))),
        ("spmd_pall_to_all", spmd(lambda b: tdat.pall_to_all(
            [x.reshape(N, 2) + r for r, x in enumerate(b)], 0, 1))),
        ("spmd_pbcast", spmd(lambda b: tdat.pbcast(b, N - 1))),
        ("spmd_halo", halo(False)),
        ("spmd_halo_wrap", halo(True)),
        ("spmd_halo_2d", spmd(lambda b: flat(tdat.halo_exchange_2d(
            b, halo=1)), dq)),
        ("spmd_pbarrier", spmd(lambda b: flat(tdat.pbarrier(b)), dq)),
        # a mesh of ranks of one process: the others take part with
        # placeholders
        ("spmd_subset", spmd(lambda b: tdat.pshift(b, 1),
                             tdat.distribute(D["P"][:8], procs=range(4)))),
        # dsort: PSRS across processes, the minmax pivots, a key function,
        # empty ranks dropped, the whole-vector and host paths
        ("dsort", lambda: tdat.dsort(tdat.distribute(D["sv"]))),
        ("dsort_int_rev", lambda: tdat.dsort(tdat.distribute(D["si"]),
                                             rev=True)),
        ("dsort_nan_minmax", lambda: tdat.dsort(tdat.distribute(D["sn"]),
                                                sample=False)),
        ("dsort_by", lambda: tdat.dsort(tdat.distribute(D["sv"]),
                                        by=torch.abs)),
        ("dsort_one_key", lambda: tdat.dsort(tdat.distribute(D["s1"]))),
        ("dsort_whole", lambda: tdat.dsort(sub)),
        ("dsort_host_by", lambda: tdat.dsort(
            tdat.distribute(D["si"]), by=lambda x: (abs(x), x))),
        # a vector on one process's ranks: the others hold no cell
        ("dsort_subset", lambda: tdat.dsort(tdat.distribute(
            D["sv"], procs=range(4)))),
        # the FFTs: sharded matrix axis (the JAX child's), a resident
        # axis, the four-step DVector, both 2-D forms, the host path
        ("dfft", lambda: tdat.dfft(dist(D["F1"], (N, 1)), axis=0)),
        ("dfft_1", lambda: tdat.dfft(dist(D["F1"], (N, 1)), axis=1)),
        ("dfft_vec", lambda: tdat.dfft(tdat.distribute(D["fv"]))),
        ("difft_vec", lambda: tdat.difft(tdat.distribute(D["fv"]))),
        ("dfft2", lambda: tdat.dfft2(dist(D["F1"], (N, 1)))),
        ("difft2", lambda: tdat.difft2(dist(D["F1"], (N, 1)))),
        ("dfft_host", lambda: tdat.dfft(dist(D["F1"], (N // 2, 2)), axis=0)),
        # dconv2d: halos along both dims, a 5 x 5 kernel, NHWC, the host
        # path
        ("dconv2d", lambda: tdat.dconv2d(dist(D["im"], (N // 2, 2)),
                                         D["k3"])),
        ("dconv2d_5", lambda: tdat.dconv2d(dist(D["im"], (N, 1)), D["k5"])),
        ("dconv2d_nhwc", lambda: tdat.dconv2d(
            dist(D["nh"], (1, N // 2, 2, 1)), D["kn"])),
        ("dconv2d_host", lambda: tdat.dconv2d(dist(D["im"][:, :4], (1, N)),
                                              D["k5"])),
        # ring attention (the JAX child's leg, then causal) and Ulysses
        ("ring_attention", lambda: tdat.ring_attention(
            *(dist(x, (N, 1, 1)) for x in D["qkv"]))),
        ("ring_attention_causal", lambda: tdat.ring_attention(
            *(dist(x, (N, 1, 1)) for x in D["qkv"]), causal=True)),
        ("ulysses", ulysses(False)),
        ("ulysses_causal", ulysses(True)),
        # k-means on one column of blocks, and on two (joined by a region
        # call)
        ("kmeans", kmeans((N, 1))),
        ("kmeans_cols", kmeans((N // 2, 2))),
        # dmatmul_int8: the (p, 1) rows with B whole, Cannon's double ring
        ("int8_rows", lambda: tdat.dmatmul_int8(dist(D["ia"], (N, 1)),
                                                D["ib"])),
        ("int8_cannon", cannon),
    ]


def _layout(d) -> dict:
    return {"cuts": [list(c) for c in d.cuts], "pids": d.pids.tolist()}


def summary(tdat, gather, value):
    """``(what the tests compare, [kinds of meta tensors handed out])``:
    a DArray as its gathered values, layout and dtype (its local chunks
    checked); a SubDArray materialized; a tensor as numpy; a list of rank
    tensors as this process's ``{index: numpy}``; a dict key by key; other
    values as they are."""
    meta = []
    if isinstance(value, dict):
        out = {}
        for k, v in value.items():
            out[k], m = summary(tdat, gather, v)
            meta += m
        return out, meta
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


# ---------------------------------------------------------------------------
# sequence-parallel training across processes: the flash and zigzag rings,
# tp_ffn's ring GEMMs and the SP model's step
# ---------------------------------------------------------------------------

SP_LR = 0.5


def sp_cfg(N: int) -> dict:
    """The SP model's configuration on N ranks: ``SPConfig(vocab=64,
    dim=32, heads=2, layers=2, ffn_mult=4, max_seq=64)`` on 8, the FFN 24
    wide a rank on 12 (its width must split over the ranks)."""
    return dict(vocab=64, dim=32, heads=2, layers=2, ffn_mult=N // 2,
                max_seq=64)


TRAINER_NAMES = ["trainer_mlp_adam", "trainer_mlp_sgd",
                 "trainer_transformer_adam", "trainer_transformer_sgd"]
TRAIN_NAMES = [
    "ring_flash_attention", "ring_flash_grads", "zigzag_ring_flash_attention",
    "zigzag_flash_grads", "zigzag_ring_attention", "zigzag_ring_grads",
    "ring_causal_grads", "tp_ffn", "sp_grad", "sp_grad_zigzag", "sp_sgd",
    "sp_sgd_zigzag", "sp_adam"] + TRAINER_NAMES
# the plain causal ring's leg runs on ranks SUB_RING_FIRST.. N-1, so that
# process 0 holds only the ring's first rank, which the causal plan skips
# after step 0
SUB_RING_FIRST = 3


def train_data(N: int) -> dict:
    """The training legs' inputs, the same on every process: attention
    blocks of 4 rows a rank (2 heads of 8), tp_ffn's operands, and the SP
    model's numpy parameter pytree (the JAX package's layout, drawn as its
    ``init_params`` draws: normal * sqrt(1 / fan_in), norms at 1) and
    tokens (2, 4N)."""
    rng = np.random.default_rng(23)
    f32 = np.float32
    cfg = sp_cfg(N)
    E, V, S = cfg["dim"], cfg["vocab"], cfg["max_seq"]
    F = E * cfg["ffn_mult"]

    def dense(*shape):
        return (rng.standard_normal(shape) * np.sqrt(1.0 / shape[0])
                ).astype(f32)
    params = {"embed": dense(V, E), "pos": dense(S, E),
              "ln_f": np.ones(E, f32), "head": dense(E, V),
              "blocks": [{"ln1": np.ones(E, f32), "qkv": dense(E, 3 * E),
                          "proj": dense(E, E), "ln2": np.ones(E, f32),
                          "w1": dense(E, F), "w2": dense(F, E)}
                         for _ in range(cfg["layers"])]}
    return {
        "qkv": [rng.standard_normal((4 * N, 2, 8)).astype(f32)
                for _ in range(3)],
        "g": rng.standard_normal((4 * N, 2, 8)).astype(f32),
        "x": rng.standard_normal((N, 2, 8)).astype(f32),
        "w1": rng.standard_normal((N, 8, 4)).astype(f32) / 3,
        "w2": rng.standard_normal((N, 4, 8)).astype(f32) / 2,
        "gy": rng.standard_normal((N, 2, 8)).astype(f32),
        "params": params,
        "tokens": rng.integers(0, V, (2, 4 * N)).astype(np.int32),
    }


def _with_grads(tdat, fn, blocks, cot):
    """``fn(*blocks)`` (rank lists in, a rank list out) and the gradients
    of ``sum_r <out_r, cot_r>`` over this process's ranks with respect to
    every rank list of ``blocks``, as ``{"out": ..., "d0": ..., ...}`` (rank
    lists; another process's ranks placeholders)."""
    from distributedarrays_tpu_torch.models._autodiff import value_and_grad
    own = [r for r, c in enumerate(cot) if c.device.type != "meta"]
    leaves = [b[r] for b in blocks for r in own]
    got = {}

    def loss():
        got["out"] = fn(*blocks)
        acc = None
        for r in own:
            term = (got["out"][r].float() * cot[r]).sum()
            acc = term if acc is None else acc + term
        return acc
    _, grads = value_and_grad(loss, leaves)
    got["out"] = [o.detach() for o in got["out"]]
    for i, b in enumerate(blocks):
        d = [torch.empty_like(x) for x in b]
        for j, r in enumerate(own):
            d[r] = grads[i * len(own) + j]
        got[f"d{i}"] = d
    return got


def train_legs(tdat, N: int) -> list:
    """The legs of sequence-parallel training (``TRAIN_NAMES``): the three
    flash/zigzag rings on DArrays, forward, and on rank lists with the
    gradients of a fixed cotangent through ``torch.autograd``; the plain
    causal ring's gradients on ranks ``SUB_RING_FIRST``.. N-1; ``tp_ffn``
    with its gradients; the SP model's grad function, SGD step (contiguous
    and zigzag) and one Adam step, its weights entering through
    ``interop.params_from_reference`` and ``shard_params``."""
    SP = tdat.sp_transformer
    D = train_data(N)
    ring = list(range(N))

    def dist(x):
        return tdat.distribute(x, procs=ring, dist=(N, 1, 1))

    def zig(x):
        return tdat.zigzag_shard(torch.from_numpy(x), N).numpy()

    def blocks(x, ranks=ring):
        """The host array's first chunks of N (rank r's on its device),
        one a rank of ``ranks``."""
        return [torch.from_numpy(c.copy()).to(tdat.layout.device_of(r))
                for r, c in zip(ranks, np.split(x, N))]

    def grads(kernel, zigzag=False, ranks=ring):
        def run():
            q, k, v = (blocks(zig(x) if zigzag else x, ranks)
                       for x in D["qkv"])
            return _with_grads(tdat, kernel, [q, k, v], blocks(D["g"], ranks))
        return run

    def ffn():
        xs, w1, w2 = (blocks(D[k].reshape(-1, D[k].shape[-1]))
                      for k in ("x", "w1", "w2"))
        return _with_grads(tdat, tdat.collective_matmul.tp_ffn,
                           [xs, w1, w2], blocks(D["gy"].reshape(-1, 8)))

    def model(zigzag):
        cfg = SP.SPConfig(**sp_cfg(N), dtype=torch.float32, zigzag=zigzag)
        shards = SP.shard_params(
            tdat.params_from_reference(D["params"], cfg), ring)
        toks = D["tokens"]
        if zigzag:
            toks = toks[:, tdat.zigzag_order(toks.shape[1], N)]
        return cfg, shards, toks

    def named(cfg, per_rank):
        return {"ranks": {n: [d[n] for d in per_rank]
                          for n in SP.param_specs(cfg)},
                "whole": SP.unshard(per_rank, cfg)}

    def sp_grad(zigzag):
        def run():
            cfg, shards, toks = model(zigzag)
            loss, g = SP.make_grad_fn(ring, cfg)(shards, toks)
            return {"loss": loss, **named(cfg, g)}
        return run

    def params(cfg, shards):
        return named(cfg, [dict(m.named_parameters()) for m in shards])

    def sp_sgd(zigzag):
        def run():
            cfg, shards, toks = model(zigzag)
            shards, loss = SP.make_train_step(ring, cfg)(shards, toks, SP_LR)
            return {"loss": loss, **params(cfg, shards)}
        return run

    def sp_adam():
        cfg, shards, toks = model(False)
        step, init = SP.make_optax_train_step(
            ring, cfg, tdat.train.adam(1e-2, eps=1e-3))
        shards, _, loss = step(shards, init(shards), toks)
        return {"loss": loss, **params(cfg, shards)}

    from distributedarrays_tpu_torch.models import ring_attention as ra
    out = [
        ("ring_flash_attention", lambda: tdat.ring_flash_attention(
            *(dist(x) for x in D["qkv"]), causal=True)),
        ("ring_flash_grads", grads(
            lambda q, k, v: ra.ring_flash_attention_kernel(q, k, v, True))),
        ("zigzag_ring_flash_attention", lambda: tdat.zigzag_ring_flash_attention(
            *(dist(zig(x)) for x in D["qkv"]))),
        ("zigzag_flash_grads", grads(ra.zigzag_ring_flash_attention_kernel,
                                     True)),
        ("zigzag_ring_attention", lambda: tdat.zigzag_ring_attention(
            *(dist(zig(x)) for x in D["qkv"]))),
        ("zigzag_ring_grads", grads(ra.zigzag_ring_attention_kernel, True)),
        ("ring_causal_grads", grads(
            lambda q, k, v: ra.ring_attention_kernel(q, k, v, True),
            ranks=ring[SUB_RING_FIRST:])),
        ("tp_ffn", ffn),
        ("sp_grad", sp_grad(False)),
        ("sp_grad_zigzag", sp_grad(True)),
        ("sp_sgd", sp_sgd(False)),
        ("sp_sgd_zigzag", sp_sgd(True)),
        ("sp_adam", sp_adam),
    ]
    out += trainer_legs(tdat, N)
    assert [name for name, _ in out] == TRAIN_NAMES
    return out


# ---------------------------------------------------------------------------
# the data-parallel Trainer across processes: K10 gathers the parameter
# shards, K12 reduce-scatters the gradients
# ---------------------------------------------------------------------------

TRAINER_ADAM = dict(kind="adam", lr=1e-2)
TRAINER_SGD = dict(kind="sgd", lr=5e-2)


def trainer_task(kind: str, N: int, tasks):
    """The trainer legs' task on N ranks (``tasks``: either package's
    ``train.tasks``): the MLP of ``mlp_task``'s default sizes (1732
    parameters, padded to a multiple of N) on a batch of 3N - 2, or a
    one-layer transformer (vocab 32, dim 16, 2 heads, seq 8) on 2N - 4
    sequences, so the batch pads too."""
    if kind == "mlp":
        return tasks.mlp_task(batch_size=3 * N - 2)
    return tasks.transformer_task(vocab=32, dim=16, heads=2, layers=1,
                                  seq=8, batch_size=2 * N - 4)


def trainer_legs(tdat, N: int) -> list:
    """``TRAINER_NAMES``: the port's ``Trainer`` on every rank, for the
    MLP and the transformer task: 3 Adam steps published by a checkpoint
    manager, then a new trainer resuming from the published step to 4;
    and 2 SGD steps by ``step_once``.  Each returns its losses and the
    flat parameters (every process gathers them), the losses as a float64
    array (the floats the trainer returned); in a job the processes
    publish chunked checkpoints into one directory that they share."""
    import shutil
    import tempfile
    from distributedarrays_tpu_torch.layout import process_index
    from distributedarrays_tpu_torch.parallel import multihost
    T = tdat.train
    ring = list(range(N))

    def shared_tempdir():
        where = tempfile.mkdtemp(prefix="trainer_legs_") \
            if process_index() == 0 else None
        return multihost._all_gather_objects(where)[0] \
            if multihost.in_job() else where

    def adam(kind):
        def run():
            task = trainer_task(kind, N, T)
            where = shared_tempdir()
            try:
                with T.Trainer(task, T.Optimizer(**TRAINER_ADAM),
                               ckpt_dir=where, save_every=3,
                               ranks=ring) as t:
                    res = t.fit(3)
                    flat = t.flat_params().numpy()
                with T.Trainer(task, T.Optimizer(**TRAINER_ADAM),
                               ckpt_dir=where, ranks=ring) as t2:
                    more = t2.fit(4)
                    flat2 = t2.flat_params().numpy()
            finally:
                multihost.sync_hosts("trainer_legs")
                if process_index() == 0:
                    shutil.rmtree(where, ignore_errors=True)
            return {"losses": np.asarray(res["losses"]), "flat": flat,
                    "resumed_from": more["resumed_from"],
                    "resumed": np.asarray(more["losses"]),
                    "resumed_flat": flat2}
        return run

    def sgd(kind):
        def run():
            with T.Trainer(trainer_task(kind, N, T),
                           T.Optimizer(**TRAINER_SGD), ranks=ring) as t:
                losses = [t.step_once(), t.step_once()]
                return {"losses": np.asarray(losses),
                        "flat": t.flat_params().numpy(),
                        "step": t.step}
        return run

    return [("trainer_mlp_adam", adam("mlp")), ("trainer_mlp_sgd", sgd("mlp")),
            ("trainer_transformer_adam", adam("transformer")),
            ("trainer_transformer_sgd", sgd("transformer"))]


STRAGGLER_STEP = 3


def trainer_straggler(tdat, N: int, proc: int, nprocs: int) -> dict:
    """A step that the straggler gate aborts in a job: the last process
    hangs 2 s at the top of step ``STRAGGLER_STEP`` and its next probe
    finds its first rank down (a fault plan on that process only); every
    process must take the gate's branch from the shared step time, raise
    ``DeadRankError`` after K12, shrink onto the other ranks together and
    finish the run there.  Returns what each process saw (its losses, the
    straggler count and the ranks the run ended on); the fault plan and
    the elastic set are reset after."""
    from distributedarrays_tpu_torch.parallel import multihost
    from distributedarrays_tpu_torch.resilience import elastic, faults
    T = tdat.train
    if proc == nprocs - 1:
        faults.configure(plan=[
            {"site": "train.step", "match": {"step": STRAGGLER_STEP},
             "action": "hang", "hang_s": 2.0, "at": 1, "count": 1,
             "device": 4 * proc}], seed=3)
    multihost.heartbeat()
    det = T.StragglerDetector(factor=3.0, min_budget_s=0.5, warmup=2)
    out = {}
    try:
        with T.Trainer(trainer_task("mlp", N, T), T.Optimizer(**TRAINER_SGD),
                       ranks=list(range(N)), straggler=det) as t:
            try:
                t.fit(STRAGGLER_STEP + 2)
                out["error"] = None
            except Exception as e:  # noqa: BLE001 — reported to the parent
                out["error"] = f"{type(e).__name__}: {e}"
                ctx = e.__context__
                out["cause"] = None if ctx is None else type(ctx).__name__
            out.update(step=t.step, stragglers=t.stragglers,
                       losses=[t.losses()[i] for i in sorted(t.losses())],
                       ranks=[int(r) for r in t._state["pflat"].pids.flat])
    finally:
        faults.clear()
        elastic.manager().reset()
        multihost.sync_hosts("trainer_straggler")
    return out


# ---------------------------------------------------------------------------
# the chunked checkpoint store in one shared directory, and the Trainer's
# recovery across processes: a device loss (by a fault plan armed on every
# process or on the lost rank's process only), a whole process's ranks
# lost, and a resume onto another pinned rank set
# ---------------------------------------------------------------------------

RECOVERY_NAMES = ["trainer_loss_mlp", "trainer_loss_transformer",
                  "trainer_process_down", "trainer_resume_pinned",
                  "trainer_loss_replicas"]
LOSS_STEP = 3        # the step whose top loses a rank
LOSS_RANK = 5
RECOVERY_STEPS = 5
RECOVERY_SAVE_EVERY = 2


def shared_dir(root: str, name: str) -> str:
    """A fresh directory ``root/name`` that every process of a job names
    the same: process 0 empties it, a barrier follows (a no-op in one
    process)."""
    import os
    import shutil
    from distributedarrays_tpu_torch.layout import process_index
    from distributedarrays_tpu_torch.parallel import multihost
    path = os.path.join(root, name)
    if process_index() == 0:
        shutil.rmtree(path, ignore_errors=True)
        os.makedirs(path)
    multihost.sync_hosts(f"shared_dir/{name}")
    return path


def ckpt_tree(tdat, N: int) -> dict:
    """The chunked-store leg's tree: DArrays on five layouts and four
    dtypes (one on ranks 0-2 only, so a process may hold no cell of it),
    a numpy array, a tensor and plain values."""
    rng = np.random.default_rng(31)
    f32 = np.float32
    return {
        "d": {"f": tdat.distribute(rng.standard_normal((37, 11)).astype(f32)),
              "g": tdat.distribute(rng.standard_normal((50, 8)).astype(f32),
                                   procs=range(N), dist=(N // 2, 2)),
              "h": tdat.distribute(torch.from_numpy(
                  rng.standard_normal((9, 13)).astype(f32)).bfloat16(),
                  procs=range(N), dist=(2, N // 2)),
              "v": tdat.distribute(rng.standard_normal(8229).astype(f32)),
              "sub": tdat.distribute(rng.integers(-9, 9, (37, 11)).astype(
                  np.int8), procs=range(3)),
              "b": tdat.distribute(rng.standard_normal((16, 4)) > 0)},
        "np": np.arange(6.0), "t": torch.arange(5), "step": 7}


def ckpt_chunks(tdat, N: int, root: str) -> dict:
    """A chunked save and load of ``ckpt_tree`` in one shared directory:
    the cell files this process wrote (each with its cell's rank), the
    region exchanges (K10 on the card) the save and the load made, the
    restored values and layouts; then a ``corrupt`` plan at
    ``checkpoint.read`` armed on the last process only, and the error each
    process raised."""
    from distributedarrays_tpu_torch.layout import process_count
    from distributedarrays_tpu_torch.parallel import multihost
    from distributedarrays_tpu_torch.resilience import faults
    from distributedarrays_tpu_torch.utils import checkpoint as CK
    tree = ckpt_tree(tdat, N)
    path = shared_dir(root, "ckpt_chunks")
    written, exchanges = [], [0]
    write, exchange = CK._write_chunks, multihost.exchange

    def spy_write(path_, meta, arrays, cells, commit=None):
        procs = {k: e["procs"] for k, e in CK._darray_entries(meta).items()}
        written.extend((f"{k}.{j}", procs[k][j])
                       for k, got in cells.items() for j, _ in got)
        return write(path_, meta, arrays, cells, commit)

    def spy_exchange(*a, **kw):
        exchanges[0] += 1
        return exchange(*a, **kw)
    CK._write_chunks, multihost.exchange = spy_write, spy_exchange
    try:
        CK.save(path, tree, store="chunks")
        saved = exchanges[0]
        back = CK.load(path)
        loaded = exchanges[0] - saved
    finally:
        CK._write_chunks, multihost.exchange = write, exchange
    out = {"written": sorted(written), "save_exchanges": saved,
           "load_exchanges": loaded,
           "np": back["np"], "t": back["t"].numpy(), "step": back["step"],
           "d": {k: (multihost.gather_global(v).view(np.uint8)
                     if v.dtype == torch.bfloat16 else
                     multihost.gather_global(v), _layout(v), str(v.dtype))
                 for k, v in back["d"].items()},
           "want": {k: (multihost.gather_global(v).view(np.uint8)
                        if v.dtype == torch.bfloat16 else
                        multihost.gather_global(v), _layout(v),
                        str(v.dtype)) for k, v in tree["d"].items()}}
    if tdat.layout.process_index() == process_count() - 1:
        faults.configure(plan=[{"site": "checkpoint.read",
                                "action": "corrupt", "at": 1, "count": 1}],
                         seed=4)
    try:
        CK.load(path)
        out["corrupt"] = None
    except Exception as e:  # noqa: BLE001 — reported to the parent
        out["corrupt"] = type(e).__name__
    finally:
        faults.clear()
    multihost.sync_hosts("ckpt_chunks_done")
    tdat.d_closeall()
    return out


def ckpt_agreement(tdat, N: int, root: str) -> dict:
    """What every process of a job must agree on around the chunked
    store: a ``CheckpointManager`` with peer replicas and ``max_to_keep=1``
    after three saves (its disk steps and its replica steps); a direct
    chunked ``save`` into a directory of each process's own (the error,
    and whether a marker was written); then a decode that fails after the
    CRC check on the last process only (a device copy running out of
    memory): a direct ``load`` (the error each process raised) and a
    manager ``restore()`` with that failure once (the step every process
    came back with, and the steps left)."""
    import os
    from distributedarrays_tpu_torch.layout import (process_count,
                                                    process_index)
    from distributedarrays_tpu_torch.parallel import multihost
    from distributedarrays_tpu_torch.utils import checkpoint as CK
    x = np.arange(96, dtype=np.float32).reshape(24, 4)
    out: dict = {}
    reps = CK.PeerReplicaStore()
    with CK.CheckpointManager(shared_dir(root, "ckpt_rot"), max_to_keep=1,
                              replicas=reps, store="chunks") as mgr:
        for s in (1, 2, 3):
            mgr.save(s, {"x": tdat.distribute(x + s), "step": s})
        mgr.wait()
        out["rotated"] = {"steps": mgr.steps(), "replicas": reps.steps()}
    own = os.path.join(root, f"ckpt_own_{process_index()}")
    try:
        CK.save(own, {"x": tdat.distribute(x), "step": 0}, store="chunks")
        out["own_dir"] = None
    except ValueError as e:
        out["own_dir"] = type(e).__name__
    out["own_marker"] = os.path.exists(os.path.join(own, CK._META))
    mgr = CK.CheckpointManager(shared_dir(root, "ckpt_fail"),
                               max_to_keep=None, async_save=False,
                               store="chunks")
    for s in (1, 2):
        mgr.save(s, {"x": tdat.distribute(x + s), "step": s})
    decode, fails = CK._decode, [0]

    def failing(meta, arrays):
        if fails[0] > 0:
            fails[0] -= 1
            raise RuntimeError("CUDA out of memory (simulated)")
        return decode(meta, arrays)
    last = process_index() == process_count() - 1
    CK._decode = failing
    try:
        fails[0] = int(last)
        try:
            CK.load(mgr._step_dir(2))
            out["load_error"] = None
        except RuntimeError as e:
            out["load_error"] = str(e).split(":")[-1].strip()
        fails[0] = int(last)
        back = mgr.restore()
        out["restored"] = {"step": back["step"], "steps": mgr.steps(),
                           "x": multihost.gather_global(back["x"])}
    finally:
        CK._decode = decode
    mgr.close()
    tdat.d_closeall()
    return out


def relayout_regions(tdat, N: int) -> dict:
    """``elastic.relayout`` of a vector of 1732 onto the shard cuts of
    ranks 0..N-2 (cuts that do not divide it), with the elements each
    process's region exchanges asked for: in a job each new cell fetches
    its own region, never the whole vector.  Then ``shrink()`` off rank
    N-1 (marked down on its process only) and ``grow()`` back, with the
    layouts and the values after."""
    from distributedarrays_tpu_torch.parallel import multihost
    from distributedarrays_tpu_torch.resilience import elastic
    x = np.arange(1732, dtype=np.float32) * 0.5
    d = tdat.distribute(x)
    ranks = list(range(N - 1))
    s = -(-1732 // len(ranks))
    cuts = [[min(r * s, 1732) for r in range(len(ranks) + 1)]]
    asked, exchange = [0], multihost.exchange

    def spy(sources, wants, *a, **kw):
        asked[0] += sum(int(w[-1].numel()) for w in wants)
        return exchange(sources, wants, *a, **kw)
    multihost.exchange = spy
    try:
        moved = elastic.relayout(d, ranks, cuts)
    finally:
        multihost.exchange = exchange
    own = sum(hi - lo for r, (lo, hi) in zip(ranks, zip(cuts[0],
                                                         cuts[0][1:]))
              if tdat.layout.is_local(r))
    out = {"moved": moved, "asked": asked[0], "own": own,
           "values": multihost.gather_global(d), "layout": _layout(d)}
    d.close()
    # the elastic manager's shrink and grow, the loss marked on the lost
    # rank's process only
    e = tdat.distribute(x)
    out["before"] = _layout(e)
    m = elastic.manager()
    mine = tdat.layout.is_local(N - 1)
    if mine:
        m.mark_down(N - 1)
    m.shrink()
    out["shrunk"] = _layout(e)
    if mine:
        m.mark_up(N - 1)
    m.grow()
    out.update(grown=_layout(e), grown_values=multihost.gather_global(e))
    m.reset()
    e.close()
    return out


def loss_plan(N: int, kind: str) -> list:
    """The recovery legs' fault plans: a ``device_loss`` of ``LOSS_RANK``
    at the top of ``LOSS_STEP``, or (``process``) a partition that takes
    the last 4 ranks (the last process's, in a job) at once."""
    if kind == "process":
        return [{"site": "train.step", "match": {"step": LOSS_STEP},
                 "action": "partition", "at": 1, "count": 1,
                 "groups": [list(range(N - 4)), list(range(N - 4, N))],
                 "observer": 0}]
    return [{"site": "train.step", "match": {"step": LOSS_STEP},
             "action": "device_loss", "at": 1, "count": 1,
             "device": LOSS_RANK}]


def recovery_legs(tdat, N: int, root: str) -> list:
    """``RECOVERY_NAMES``: the port's ``Trainer`` on every rank with a
    chunked checkpoint every ``RECOVERY_SAVE_EVERY`` steps in one shared
    directory: ``LOSS_RANK`` lost at the top of ``LOSS_STEP`` (the MLP with
    Adam, the plan armed on every process; the transformer with SGD, the
    plan armed on the lost rank's process only), the last 4 ranks lost at
    once (a whole process's, in a job), and a resume from step 2 onto ranks
    0..N-4 (``_relay_state``); and the MLP's loss with peer replicas,
    restored from buddy-rank memory.  Each returns the losses (the floats
    the trainer returned), the flat parameters and the final rank set."""
    from distributedarrays_tpu_torch.layout import process_of
    from distributedarrays_tpu_torch.resilience import elastic, faults
    T = tdat.train
    ring = list(range(N))

    def fit(name, kind, opt, plan, armed=True, ranks=ring, steps=None,
            replicas=False):
        where = shared_dir(root, name)
        if plan and armed:
            faults.configure(plan=plan, seed=6)
        peer = tdat.telemetry.counter_value("checkpoint.restore_source",
                                            source="peer")
        try:
            with T.Trainer(trainer_task(kind, N, T), T.Optimizer(**opt),
                           ckpt_dir=where, save_every=RECOVERY_SAVE_EVERY,
                           ranks=ranks, peer_replicas=replicas) as t:
                res = t.fit(steps or RECOVERY_STEPS)
                out = {"losses": np.asarray(res["losses"]),
                       "flat": t.flat_params().numpy(),
                       "ranks": [int(r) for r in t._state["pflat"].pids.flat],
                       "steps": t.step}
            if replicas:
                out["peer_restores"] = tdat.telemetry.counter_value(
                    "checkpoint.restore_source", source="peer") - peer
        finally:
            faults.clear()
            elastic.manager().reset()
        return out, where

    def loss(kind, opt, everywhere):
        def run():
            armed = everywhere or \
                process_of(LOSS_RANK) == tdat.layout.process_index()
            return fit(f"loss_{kind}", kind, opt, loss_plan(N, "rank"),
                       armed)[0]
        return run

    def process_down():
        return fit("process_down", "mlp", TRAINER_SGD,
                   loss_plan(N, "process"))[0]

    def resume_pinned():
        first, where = fit("resume", "mlp", TRAINER_ADAM, None, steps=2)
        with T.Trainer(trainer_task("mlp", N, T),
                       T.Optimizer(**TRAINER_ADAM), ckpt_dir=where,
                       ranks=list(range(N - 3))) as t:
            more = t.fit(4)
            return {"losses": np.asarray(first["losses"]),
                    "resumed": np.asarray(more["losses"]),
                    "resumed_from": more["resumed_from"],
                    "flat": t.flat_params().numpy(),
                    "ranks": [int(r) for r in t._state["pflat"].pids.flat]}

    return [("trainer_loss_mlp", loss("mlp", TRAINER_ADAM, True)),
            ("trainer_loss_transformer", loss("transformer", TRAINER_SGD,
                                              False)),
            ("trainer_process_down", process_down),
            ("trainer_resume_pinned", resume_pinned),
            ("trainer_loss_replicas", lambda: fit(
                "loss_replicas", "mlp", TRAINER_ADAM, loss_plan(N, "rank"),
                replicas=True)[0])]


# ---------------------------------------------------------------------------
# running legs in a job: one leg's failure does not fail the next ones
# ---------------------------------------------------------------------------

_JOB_BASE: dict = {}      # the job's own store, before any realignment


def _base_store():
    from distributedarrays_tpu_torch.parallel import multihost
    return _JOB_BASE.setdefault("store", multihost._job.store)


def _meet(key: str, value: str, timeout_s: float) -> list[str]:
    """Every process's ``value`` under ``key`` in the job's own store (keys
    of the caller's own, so no call that a failed leg left unmatched can
    pair with them)."""
    from datetime import timedelta
    from distributedarrays_tpu_torch.parallel import multihost
    store, job = _base_store(), multihost._job
    store.set(f"{key}/{job.index}", value)
    keys = [f"{key}/{q}" for q in range(job.count)]
    store.wait(keys, timedelta(seconds=timeout_s))
    return [store.get(k).decode() for k in keys]


def _realign(tdat, tag: str) -> None:
    """After a leg that raised on some process: every process clears its
    fault plan and elastic marks, closes its DArrays, meets the others'
    DArray id counter, and re-forms the job's gloo group and store
    namespace (a collective that one process skipped has closed the gloo
    pairs, and its barriers' sequence numbers differ between processes)."""
    import torch.distributed as dist
    from distributedarrays_tpu_torch import core
    from distributedarrays_tpu_torch.parallel import multihost
    from distributedarrays_tpu_torch.resilience import elastic, faults
    job, base = multihost._job, _base_store()
    faults.clear()
    elastic.manager().reset()
    tdat.d_closeall()
    marks = _meet(f"realign/{tag}/ids", str(core.did_mark()),
                  job.timeout.total_seconds())
    core.did_advance(max(int(m) for m in marks))
    dist.destroy_process_group()
    dist.init_process_group("gloo", store=dist.PrefixStore(
        f"realign/{tag}/gloo/", base), rank=job.index,
        world_size=job.count, timeout=job.timeout)
    job.group = dist.group.WORLD
    job.store = dist.PrefixStore(f"realign/{tag}/kv/", base)
    job._seq = {}


def progress(what: str) -> None:
    """A line on a job child's output: the runner of the job
    (``_torch_port.run_job``) reads a child whose output or store grows as
    making progress, and gloo's own exchanges write to neither."""
    print(f"PROGRESS {what}", flush=True)


def run_legs(tdat, legs: list, tag: str, run=None) -> tuple[dict, dict]:
    """``run(thunk)`` (default: ``thunk()``) for each ``(name, thunk)``:
    ``({name: value}, {name: "Type: message"})``.  In a job every process
    agrees on each leg's outcome through the store before the next leg,
    and after a leg that raised on any process every process realigns
    (``_realign``), so the next leg starts on every process at the same
    barrier and exchange sequence and is judged on its own merit; the
    failed leg keeps each process's own error, and a process on which it
    did not raise records its peers' errors."""
    from distributedarrays_tpu_torch.parallel import multihost
    run = run or (lambda thunk: thunk())
    values, errors = {}, {}
    for name, thunk in legs:
        err = None
        progress(f"{tag}/{name}")
        try:
            values[name] = run(thunk)
        except Exception as e:  # noqa: BLE001 — reported to the parent
            err = errors[name] = f"{type(e).__name__}: {e}"
        progress(f"{tag}/{name} {'raised' if err else 'done'}")
        if not multihost.in_job():
            continue
        # a peer still blocked in a call this process skipped leaves it by
        # the store's or the gloo group's timeout, each call at most once
        job = multihost._job
        seen = _meet(f"legs/{tag}/{name}", err or "",
                     4 * job.timeout.total_seconds())
        failed = [f"process {q}: {e}" for q, e in enumerate(seen) if e]
        if failed:
            if err is None:
                values.pop(name, None)
                errors[name] = "a peer raised: " + "; ".join(failed)
            _realign(tdat, f"{tag}/{name}")
    return values, errors


# ---------------------------------------------------------------------------
# faults that split a job's processes: one process late to the probe's
# barrier, two processes classifying one step's failure apart, and a leg
# that raises on one process only
# ---------------------------------------------------------------------------

LATE_S = 2.0          # how long process 0 is held at the probe's barrier
LATE_STALE_S = 1.0    # the heartbeat census's staleness in that leg
RAISE_AT = 1          # the exchange of the leg at which process 1 raises


def fault_legs(tdat, N: int, root: str) -> list:
    """The legs of the child's ``faults`` stage, in a job (each process
    runs them; they must equal ``recovery_legs``' ``trainer_loss_transformer``
    and ``trainer_loss_mlp`` in one process):

    - ``late_probe``: ``trainer_loss_transformer`` with the heartbeat
      census at ``LATE_STALE_S`` and process 0 held ``LATE_S`` at the
      probe's barrier, after its heartbeat: every process then reads
      heartbeats older than the staleness;
    - ``split_verdict``: ``trainer_loss_transformer`` with process 0's
      top of the step failing with a transient fault as the lost rank's
      process loses ``LOSS_RANK``: the two classify the step's failure
      apart;
    - ``one_process_raise``: ``trainer_loss_mlp`` in which process 1
      raises at its ``RAISE_AT``-th exchange (the checkpoint manager's
      check of its directory), which the others enter;
    - ``after_raise``: ``trainer_loss_mlp`` again."""
    from distributedarrays_tpu_torch.layout import process_index
    from distributedarrays_tpu_torch.parallel import multihost
    from distributedarrays_tpu_torch.resilience import faults
    legs = dict(recovery_legs(tdat, N, root))
    me = process_index()

    def late_probe():
        sync, census = multihost.sync_hosts, \
            multihost.down_peer_processes.__defaults__

        def held(name="sync"):
            if name == "trainer_probe" and me == 0:
                import time
                time.sleep(LATE_S)
            return sync(name)
        multihost.sync_hosts = held
        multihost.down_peer_processes.__defaults__ = (LATE_STALE_S,)
        try:
            return legs["trainer_loss_transformer"]()
        finally:
            multihost.sync_hosts = sync
            multihost.down_peer_processes.__defaults__ = census

    def split_verdict():
        # the leg arms its device loss on the lost rank's process only
        if me == 0:
            faults.configure(plan=[{"site": "train.step", "action": "raise",
                                    "match": {"step": LOSS_STEP}}], seed=6)
        return legs["trainer_loss_transformer"]()

    def one_process_raise():
        gather, calls = multihost._all_gather_objects, [0]

        def raising(obj):
            calls[0] += 1
            if me == 1 and calls[0] == RAISE_AT:
                raise RuntimeError("raised on process 1 only")
            return gather(obj)
        multihost._all_gather_objects = raising
        try:
            return legs["trainer_loss_mlp"]()
        finally:
            multihost._all_gather_objects = gather

    return [("late_probe", late_probe), ("split_verdict", split_verdict),
            ("one_process_raise", one_process_raise),
            ("after_raise", legs["trainer_loss_mlp"])]


# ---------------------------------------------------------------------------
# the GSPMD tp/dp layouts across processes (models.tp_dp): the MLP and the
# transformer on make_mesh(N), K12 + K10 all-reduces over tp and dp
# ---------------------------------------------------------------------------

TP_DP_NAMES = ["tp_mlp_odd", "tp_mlp_even", "tp_forward", "tp_sgd",
               "tp_adam", "tp_generate", "tp_sample"]
TP_SAMPLE_SEED = 43
TP_DP_STEPS = 2


def tp_dp_data(N: int) -> dict:
    """Seeded numpy inputs of the tp/dp legs: two MLPs (3 layers: a
    column-parallel last layer, gathered; 4 layers: a row-parallel one),
    their batch of 2N rows, the transformer's JAX-shaped parameters and a
    counting batch of 2N sequences."""
    rng = np.random.default_rng(41)

    def mlp(sizes):
        return [{"w": (rng.standard_normal((a, b)) * np.sqrt(2 / a)
                       ).astype(np.float32),
                 "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
                for a, b in zip(sizes, sizes[1:])]
    cfg = tp_cfg()
    E, F, V = cfg["dim"], cfg["dim"] * 4, cfg["vocab"]

    def dense(shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)
    params = {"embed": dense((V, E), E), "pos": dense((cfg["max_seq"], E), E),
              "ln_f": (1 + 0.1 * rng.standard_normal(E)).astype(np.float32),
              "head": dense((E, V), E),
              "blocks": [{"ln1": np.ones(E, np.float32),
                          "qkv": dense((E, 3 * E), E),
                          "proj": dense((E, E), E),
                          "ln2": np.ones(E, np.float32),
                          "w1": dense((E, F), E), "w2": dense((F, E), F)}
                         for _ in range(cfg["layers"])]}
    start = rng.integers(0, V, (2 * N, 1))
    return {"mlp3": mlp([16, 32, 8, 8]), "mlp4": mlp([16, 32, 32, 16, 8]),
            "x": rng.standard_normal((2 * N, 16)).astype(np.float32),
            "y": rng.standard_normal((2 * N, 8)).astype(np.float32),
            "params": params,
            "tokens": ((start + np.arange(13)[None]) % V).astype(np.int64)}


def tp_cfg() -> dict:
    return dict(vocab=32, dim=32, heads=4, layers=2, max_seq=16)


def tp_dp_legs(tdat, N: int) -> list:
    """``TP_DP_NAMES`` on ``make_mesh(N)``: each MLP's ``TP_DP_STEPS`` SGD
    steps (losses, unsharded parameters), the transformer's logits and
    loss, its SGD and Adam steps, greedy ``generate``, and two sampling
    calls at ``temperature=1.0`` with one generator seeded
    ``TP_SAMPLE_SEED`` (the second call starts from the state the first
    left); every result a whole array on every process."""
    from distributedarrays_tpu_torch.models import mlp as M
    from distributedarrays_tpu_torch.models import transformer as T
    D = tp_dp_data(N)
    cfg = T.Config(**tp_cfg(), dtype=torch.float32)

    def mlp_leg(key):
        def run():
            mesh = M.make_mesh(N)
            sp = M.shard_params([{k: torch.from_numpy(v) for k, v in l.items()}
                                 for l in D[key]], mesh)
            x, y = M.shard_batch(D["x"], D["y"], mesh)
            losses = [M.train_step(sp, x, y, lr=0.05)[1]
                      for _ in range(TP_DP_STEPS)]
            return {"losses": torch.stack(losses),
                    "params": {f"{k}{i}": v for i, l in
                               enumerate(M.unshard(sp)) for k, v in l.items()}}
        return run

    def model():
        return T.shard_params(tdat.params_from_reference(D["params"], cfg),
                              T.make_mesh(N))

    def whole(sp):
        return {n: p.detach() for n, p in T.unshard(sp).named_parameters()}

    def forward():
        sp = model()
        return {"logits": T.forward(sp, D["tokens"][:, :-1], cfg),
                "loss": T.loss_fn(sp, D["tokens"], cfg)}

    def sgd():
        sp = model()
        losses = [T.train_step(sp, D["tokens"], 0.1, cfg)[1]
                  for _ in range(TP_DP_STEPS)]
        return {"losses": torch.stack(losses), "params": whole(sp)}

    def adam():
        sp = model()
        step, init = T.make_optax_train_step(cfg, tdat.train.adam(1e-2))
        state = init(sp)
        losses = []
        for _ in range(TP_DP_STEPS):
            sp, state, loss = step(sp, state, D["tokens"])
            losses.append(loss)
        return {"losses": torch.stack(losses), "params": whole(sp)}

    def sample():
        sp = model()
        gen = torch.Generator().manual_seed(TP_SAMPLE_SEED)
        return {call: T.generate(sp, D["tokens"][:, :4], 6, cfg,
                                 temperature=1.0, generator=gen)
                for call in ("first", "second")}

    out = [("tp_mlp_odd", mlp_leg("mlp3")), ("tp_mlp_even", mlp_leg("mlp4")),
           ("tp_forward", forward), ("tp_sgd", sgd), ("tp_adam", adam),
           ("tp_generate", lambda: T.generate(model(), D["tokens"][:, :4], 6,
                                              cfg)),
           ("tp_sample", sample)]
    assert [name for name, _ in out] == TP_DP_NAMES
    return out
