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
    array (the floats the trainer returned); a process writes its
    own checkpoint copy in a directory of its own."""
    import shutil
    import tempfile
    T = tdat.train
    ring = list(range(N))

    def adam(kind):
        def run():
            task = trainer_task(kind, N, T)
            where = tempfile.mkdtemp(prefix="trainer_legs_")
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
    ``DeadRankError`` after K12, and then meet the device-loss shrink,
    which raises ``NotImplementedError`` across processes.  Returns what
    each process saw; the fault plan and the elastic set are reset after."""
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
                       losses=[t.losses()[i] for i in sorted(t.losses())])
    finally:
        faults.clear()
        elastic.manager().reset()
        multihost.sync_hosts("trainer_straggler")
    return out


# ---------------------------------------------------------------------------
# the GSPMD tp/dp layouts across processes (models.tp_dp): the MLP and the
# transformer on make_mesh(N), K12 + K10 all-reduces over tp and dp
# ---------------------------------------------------------------------------

TP_DP_NAMES = ["tp_mlp_odd", "tp_mlp_even", "tp_forward", "tp_sgd",
               "tp_adam", "tp_generate"]
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
    loss, its SGD and Adam steps, and greedy ``generate``; every result a
    whole array on every process."""
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

    out = [("tp_mlp_odd", mlp_leg("mlp3")), ("tp_mlp_even", mlp_leg("mlp4")),
           ("tp_forward", forward), ("tp_sgd", sgd), ("tp_adam", adam),
           ("tp_generate", lambda: T.generate(model(), D["tokens"][:, :4], 6,
                                              cfg))]
    assert [name for name, _ in out] == TP_DP_NAMES
    return out
