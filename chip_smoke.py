"""Drive the PyTorch/CUDA port (distributedarrays_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit and the torch version, and
   builds the hand-written CUDA kernels from ``distributedarrays_tpu_torch/
   csrc`` (nvcc, sm_90a) into ``build/torch_kernels/``.
2. Holds each kernel against its plain PyTorch version on the card, at the
   main path's shapes:
   - block GEMM: 4096^2 f32, 4096^2 bf16 and a ragged 1000x777 @ 777x1500
     f32 product; relative Frobenius error <= 1e-5 in f32 (summation order
     only) and <= 1e-2 in bf16 (the kernel's bf16 output rounding against
     the plain bf16-in/f32-accumulate product cast to bf16);
   - single-step stencil: 8192^2 f32, random weights, nonzero halo rows;
   - multistep stencil: k = 8, both Dirichlet flag settings.
   Stencils: relative Frobenius error <= 1e-5 (the kernels sum in the
   plain order without FMA contraction, so they are expected to agree
   exactly).
3. Runs the five BASELINE.md configurations through the public API on one
   rank, with every kernel's launch count set to 0 just before and read
   just after; each result is checked against plain torch on the card, and
   the run fails if a kernel of the path was not launched:
   distribute/drand 4096^2; ``A @ B`` under the default (torch.matmul) and
   with the tuning registry set to the kernel; ``dsum(A*A)``; the 8192^2
   broadcast chain ``sin(A) + B*C``; ``dmapreduce(abs2, +)``, ``dmean`` and
   ``dstd`` on a 1e8-element DVector; a 16384^2 f32 ``A @ B`` through the
   kernel; ``stencil5`` on 8192^2 with ``iters=16`` (multistep kernel,
   auto depth 8) and ``iters=1`` (single-step kernel); ``gather``.
   The same phase holds the kernels of the distributed GEMM tier against
   their plain versions: the int8 GEMM at 16384^3 and 1000x777x1500
   (bit-exact: exact int32 sums and the same two f32 multiplies); the
   all-gather and all-to-all on a 16384^2 f32 array over 4 ranks on the
   one card (bit-exact: pure data movement); the ring all-gather GEMM at
   16384^2 (4,1)x(4,1), relative Frobenius error <= 1e-5 in f32 and
   <= 1e-2 in bf16 (per-step product order and rounding).
4. Runs a (4,1) stencil and a (2,2)x(2,2) GEMM with four ranks on the one
   card and compares them with the one-rank results.
5. Distributed GEMM at BASELINE config 3's size (16384^2 f32) with four
   ranks on the one card, launch counts set to 0 just before and read just
   after: ``A @ B`` on (2,2)x(2,2) under the default and under
   ``matmul_impl_dist = "summa"`` (Cannon); (4,1)x(4,1) under the default
   (all-gather kernel + torch.matmul), under ``"ring_ag"`` (ring GEMM
   kernel) and ``mul_into`` on the ring; ``dmatmul_int8`` on one rank, on
   (4,1) and on (2,2) (int8 kernel); the broadcast ``X + Y`` with X on (4,1)
   and Y on (1,4) (all-to-all kernel).  Float products are checked against
   ``torch.matmul`` on the card (relative Frobenius error <= 1e-5), int8
   products against it by the quantization bound (max error / max |ref| <=
   3e-2) and the (4,1) int8 result against the one-rank one bit for bit;
   the run fails if one of the four kernels was not launched.
6. With two or more cards, one rank per card with peer access: the
   all-gather, all-to-all and ring GEMM kernels against their plain
   versions on a 16384^2 f32 array, and their times.  With one card it
   prints why it did not run.  ``python3 chip_smoke.py --across-cards``
   builds the kernels and runs this phase alone.
7. Times each kernel with CUDA events (warm-up, then the median of 10
   runs) beside its bound, its plain version and a library yardstick
   (torch.matmul for the GEMMs, F.conv2d with TF32 off for the stencils,
   torch._int_mm and the dequantizing multiply for the int8 GEMM,
   torch.cat of the same pieces for the all-gather and all-to-all,
   torch.cat then torch.matmul for the ring GEMM), and prints them as one
   JSON line.

The last line is ``{"ok": true, "device": {...}}``; any failing phase raises
and the script exits non-zero.  Without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM data-sheet peaks (dense): HBM bytes/s and float32 FLOP/s outside
# the tensor cores; bf16 tensor-core FLOP/s; int8 tensor-core OP/s
HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12

TOL_F32 = 1e-5
TOL_BF16 = 1e-2
TOL_STENCIL = 1e-5
TOL_STATS = 1e-4      # mean/std of 1e8 f32 values: summation order differs
TOL_QUANT = 3e-2      # int8 products against f32: two quantization steps


def rel_err(x: torch.Tensor, ref: torch.Tensor) -> float:
    x, ref = x.float(), ref.float()
    return float((x - ref).norm() / ref.norm().clamp_min(1e-30))


def max_abs(x: torch.Tensor, ref: torch.Tensor) -> float:
    return float((x.float() - ref.float()).abs().max())


def quant_err(x: torch.Tensor, ref: torch.Tensor) -> float:
    """Max error over max |ref|: the JAX tests' quantization metric."""
    return float((x.float() - ref).abs().max() / ref.abs().max())


def exact(what: str, got, ref) -> float:
    """Assert bit equality of two tensors (or lists); the max abs error."""
    got = got if isinstance(got, (list, tuple)) else [got]
    ref = ref if isinstance(ref, (list, tuple)) else [ref]
    torch.cuda.synchronize()
    same = len(got) == len(ref) and all(
        g.dtype == r.dtype and g.device == r.device and torch.equal(g, r)
        for g, r in zip(got, ref))
    err = max(max_abs(g, r) for g, r in zip(got, ref))
    print(f"  {what}: bit-exact={same} max_abs_err={err}")
    if not same:
        raise AssertionError(f"{what}: kernel and plain version differ")
    return err


def check(what: str, err: float, tol: float) -> None:
    print(f"  {what}: rel_err={err:.3e} (tol {tol:g})")
    if not err <= tol:
        raise AssertionError(f"{what}: relative error {err} exceeds {tol}")


def bound(nbytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the bytes
    over the memory rate and the operations over the peak rate."""
    tb, to = nbytes / HBM_BYTES_S, ops / peak_ops
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def stencil_ops(w) -> int:
    """Operations per cell and step: an add per nonzero tap after the first,
    a multiply per nonzero tap whose weight is not 1."""
    taps = [v for row in w for v in row if v != 0.0]
    return max(len(taps) - 1, 0) + sum(v != 1.0 for v in taps)


def time_ms(fn, reps: int = 10) -> float:
    """Median of ``reps`` CUDA-event timings after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def across_cards(tdat, cuda_collectives) -> None:
    """Phase 6: one rank per card (at most 4) with peer access; the
    all-gather, all-to-all and ring GEMM kernels on a 16384^2 f32 array
    against their plain versions, and their times (host clock around work
    that ends in a synchronize of every card, median of 10)."""
    ncards = torch.cuda.device_count()
    if ncards < 2:
        print(f"phase across cards: not run ({ncards} CUDA device; it needs "
              "at least 2)")
        return
    p = min(ncards, 4)
    print(f"phase across cards ({p} cards, peer access)")
    devs = tdat.init(nranks=p)
    n = 16384
    blocks = [torch.randn(n // p, n, generator=torch.Generator(
        device=d).manual_seed(i), device=d) for i, d in enumerate(devs)]
    b_bl = [torch.randn(n // p, n, generator=torch.Generator(
        device=d).manual_seed(10 + i), device=d) for i, d in enumerate(devs)]

    def sync():
        for d in devs:
            torch.cuda.synchronize(d)

    def wall_ms(fn) -> float:
        fn()
        sync()
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            fn()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    cases = {
        "all_gather": (lambda: cuda_collectives.ring_all_gather(blocks, 0),
                       lambda: cuda_collectives.all_gather_plain(blocks, 0)),
        "all_to_all": (lambda: cuda_collectives.ring_all_to_all(blocks, 1, 0),
                       lambda: cuda_collectives.all_to_all_plain(blocks, 1,
                                                                 0)),
        "allgather_matmul_rhs": (
            lambda: cuda_collectives.ring_allgather_matmul_rhs(blocks, b_bl),
            lambda: cuda_collectives.allgather_matmul_rhs_plain(blocks,
                                                                b_bl))}
    times = {}
    for name, (kern, plain) in cases.items():
        got, ref = kern(), plain()
        sync()
        if name == "allgather_matmul_rhs":
            check(f"{name} across {p} cards",
                  max(rel_err(g, r) for g, r in zip(got, ref)), TOL_F32)
        else:
            exact(f"{name} across {p} cards", got, ref)
        del got, ref
        times[name] = {"ms": wall_ms(kern), "plain_ms": wall_ms(plain)}
    print(json.dumps({"across_cards": times, "cards": p,
                      "shape": f"{n}x{n} f32 in {p} row blocks"}))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    import distributedarrays_tpu_torch as tdat
    from distributedarrays_tpu_torch.ops import (cuda_collectives,
                                                 cuda_gemm, cuda_stencil)
    from distributedarrays_tpu_torch.ops.cuda_stencil import (
        LAPLACIAN_3X3, _apply3x3, _multistep_plain)
    from distributedarrays_tpu_torch.utils import autotune, kbuild

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    kbuild.build()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    for stem, log in sorted(kbuild.build_log.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {stem}: {line.strip()}")

    tdat.init()
    dev = tdat.device_of(0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    errs = {k: 0.0 for k in kbuild.KERNELS}

    # -- 2. kernels against their plain versions ---------------------------
    print("phase kernels")
    for m, k, n, dt, tol in ((4096, 4096, 4096, torch.float32, TOL_F32),
                             (4096, 4096, 4096, torch.bfloat16, TOL_BF16),
                             (1000, 777, 1500, torch.float32, TOL_F32)):
        a, b = randn(m, k, dtype=dt), randn(k, n, dtype=dt)
        got = cuda_gemm.cuda_matmul(a, b)
        ref = cuda_gemm.matmul_plain(a, b)
        torch.cuda.synchronize()
        check(f"gemm {m}x{k}x{n} {dt}", rel_err(got, ref), tol)
        errs["gemm"] = max(errs["gemm"], max_abs(got, ref))
    ms, ns = 8192, 8192
    wts = tuple(tuple(float(v) for v in row)
                for row in np.random.default_rng(1).uniform(-1, 1, (3, 3)))
    x = randn(ms, ns)
    lo1, hi1 = randn(1, ns), randn(1, ns)
    got = cuda_stencil.stencil3x3_block(x, lo1, hi1, wts)
    ref = _apply3x3(torch.cat([lo1, x, hi1]), wts)
    torch.cuda.synchronize()
    check("stencil step 8192^2", rel_err(got, ref), TOL_STENCIL)
    errs["stencil_step"] = max_abs(got, ref)
    K = 8
    lok, hik = randn(K, ns), randn(K, ns)
    for flags in ((False, False), (True, True)):
        got = cuda_stencil.stencil3x3_multistep(x, lok, hik, K, *flags, wts)
        ref = _multistep_plain(x, lok, hik, K, *flags, wts)
        torch.cuda.synchronize()
        check(f"stencil multistep k={K} dirichlet={flags}", rel_err(got, ref),
              TOL_STENCIL)
        errs["stencil_multistep"] = max(errs["stencil_multistep"],
                                        max_abs(got, ref))
    del x, got, ref

    n16 = 16384
    for m, k, n in ((n16, n16, n16), (1000, 777, 1500)):
        qa = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.int8)
        qb = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.int8)
        sa = torch.rand(m, generator=gen, device=dev) / 127
        sb = torch.rand(n, generator=gen, device=dev) / 127
        for od in (torch.float32, torch.bfloat16):
            errs["matmul_int8"] = max(errs["matmul_int8"], exact(
                f"int8 gemm {m}x{k}x{n} -> {od}",
                cuda_gemm.cuda_matmul_int8(qa, qb, sa, sb, od),
                cuda_gemm.matmul_int8_plain(qa, qb, sa, sb, od)))
    del qa, qb
    P4 = 4
    blocks = [randn(n16 // P4, n16) for _ in range(P4)]
    for dim in (0, 1):
        errs["all_gather"] = max(errs["all_gather"], exact(
            f"all_gather 4 x {tuple(blocks[0].shape)} dim {dim}",
            cuda_collectives.ring_all_gather(blocks, dim),
            cuda_collectives.all_gather_plain(blocks, dim)))
    for sd, cd in ((1, 0), (0, 1)):
        errs["all_to_all"] = max(errs["all_to_all"], exact(
            f"all_to_all 4 x {tuple(blocks[0].shape)} split {sd} concat {cd}",
            cuda_collectives.ring_all_to_all(blocks, sd, cd),
            cuda_collectives.all_to_all_plain(blocks, sd, cd)))
    for dt, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
        a_bl = [x.to(dt) for x in blocks]
        b_bl = [randn(n16 // P4, n16, dtype=dt) for _ in range(P4)]
        got = cuda_collectives.ring_allgather_matmul_rhs(a_bl, b_bl)
        ref = cuda_collectives.allgather_matmul_rhs_plain(a_bl, b_bl)
        torch.cuda.synchronize()
        check(f"ring allgather GEMM 16384^2 (4,1)x(4,1) {dt}",
              max(rel_err(g, r) for g, r in zip(got, ref)), tol)
        errs["allgather_matmul_rhs"] = max(
            errs["allgather_matmul_rhs"],
            max(max_abs(g, r) for g, r in zip(got, ref)))
    del blocks, a_bl, b_bl, got, ref
    torch.cuda.empty_cache()

    # -- 3. the main path at BASELINE size, one rank ------------------------
    print("phase main path (1 rank)")
    kbuild.reset_launches()
    t_main = time.perf_counter()
    rng = np.random.default_rng(2)
    a_host = rng.standard_normal((4096, 4096), dtype=np.float32)
    A = tdat.distribute(a_host)
    B = tdat.drand((4096, 4096))
    At, Bt = A.full(), B.full()
    C0 = A @ B
    check("A @ B (torch.matmul)", rel_err(C0.full(), At @ Bt), TOL_F32)
    key = autotune.device_key_for(4096, 4096, 4096, torch.float32,
                                  torch.float32)
    autotune.record("matmul_impl", key, "pallas")
    C1 = A @ B
    check("A @ B (kernel)", rel_err(C1.full(), At @ Bt), TOL_F32)
    s = tdat.dsum(A * A)
    check("dsum(A*A)", rel_err(s, (At * At).sum()), TOL_F32)
    X, Y, Z = (tdat.drand((8192, 8192)) for _ in range(3))
    R = tdat.dmap(torch.sin, X) + Y * Z
    check("sin(A) + B*C 8192^2",
          rel_err(R.full(), torch.sin(X.full()) + Y.full() * Z.full()),
          TOL_F32)
    del X, Y, Z, R
    V = tdat.drand(10 ** 8)
    Vt = V.full()
    check("dmapreduce(abs2, +)",
          rel_err(tdat.dmapreduce(torch.square, "sum", V),
                  torch.square(Vt).sum()), TOL_STATS)
    check("dmean", rel_err(tdat.dmean(V), Vt.mean()), TOL_STATS)
    check("dstd", rel_err(tdat.dstd(V), Vt.std()), TOL_STATS)
    del V, Vt
    A16, B16 = tdat.drand((16384, 16384)), tdat.drand((16384, 16384))
    autotune.record("matmul_impl", autotune.device_key_for(
        16384, 16384, 16384, torch.float32, torch.float32), "pallas")
    C16 = A16 @ B16
    check("A @ B 16384^2 (kernel)",
          rel_err(C16.full(), A16.full() @ B16.full()), TOL_F32)
    del A16, B16, C16
    G = tdat.drandn((8192, 8192))
    S16 = tdat.stencil5(G, iters=16)
    check("stencil5 iters=16 (multistep)",
          rel_err(S16.full(), tdat.stencil5(G, 16, use_kernel=False).full()),
          TOL_STENCIL)
    S1 = tdat.stencil5(G, iters=1)
    check("stencil5 iters=1 (step)",
          rel_err(S1.full(), tdat.stencil5(G, 1, use_kernel=False).full()),
          TOL_STENCIL)
    g = tdat.gather(S1)
    if g.shape != (8192, 8192) or not np.isfinite(g).all() or \
            not np.array_equal(g, S1.full().cpu().numpy()):
        raise AssertionError("gather(S1) is not S1")
    torch.cuda.synchronize()
    counts = tdat.kbuild.launch_counts()
    print(f"  main path {time.perf_counter() - t_main:.1f} s, launches "
          f"{counts}")
    counts_main = ("gemm", "stencil_step", "stencil_multistep")
    missing = [k for k in counts_main if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")

    # -- 4. four ranks on the one card --------------------------------------
    print("phase 4 ranks")
    tdat.init(nranks=4)
    G4 = tdat.distribute(G.full(), dist=(4, 1))
    check("stencil5 (4,1) iters=16 vs 1 rank",
          rel_err(tdat.stencil5(G4, iters=16).full(), S16.full()),
          TOL_STENCIL)
    check("stencil5 (4,1) iters=1 vs 1 rank",
          rel_err(tdat.stencil5(G4, iters=1).full(), S1.full()), TOL_STENCIL)
    A4 = tdat.distribute(a_host, dist=(2, 2))
    B4 = tdat.distribute(Bt, dist=(2, 2))
    check("A @ B (2,2)x(2,2) vs 1 rank", rel_err((A4 @ B4).full(),
                                                  C0.full()), TOL_F32)
    tdat.d_closeall()
    del G, S16, S1, G4, A4, B4, C0, C1, A, B, At, Bt
    torch.cuda.empty_cache()

    # -- 5. distributed GEMM tier, 16384^2 f32 on 4 ranks --------------------
    print("phase distributed GEMM (4 ranks on one card, 16384^2 f32)")
    tdat.init(nranks=4)
    f32 = torch.float32
    At, Bt = randn(n16, n16), randn(n16, n16)
    Cref = cuda_gemm.torch_matmul(At, Bt)
    kbuild.reset_launches()
    t_dist = time.perf_counter()
    A22 = tdat.distribute(At, dist=(2, 2))
    B22 = tdat.distribute(Bt, dist=(2, 2))
    check("A @ B (2,2)x(2,2) default", rel_err((A22 @ B22).full(), Cref),
          TOL_F32)
    autotune.record("matmul_impl_dist", autotune.device_key_for(
        n16, n16, n16, "2x2", f32, f32), "summa")
    check("A @ B (2,2)x(2,2) Cannon", rel_err((A22 @ B22).full(), Cref),
          TOL_F32)
    A41 = tdat.distribute(At, dist=(4, 1))
    B41 = tdat.distribute(Bt, dist=(4, 1))
    check("A @ B (4,1)x(4,1) default (all-gather + torch.matmul)",
          rel_err((A41 @ B41).full(), Cref), TOL_F32)
    autotune.record("matmul_impl_dist", autotune.device_key_for(
        n16, n16, n16, 4, f32, f32), "ring_ag")
    check("A @ B (4,1)x(4,1) ring GEMM", rel_err((A41 @ B41).full(), Cref),
          TOL_F32)
    Cout = tdat.dzeros((n16, n16), dist=(4, 1))
    tdat.mul_into(Cout, A41, B41)
    check("mul_into (4,1) ring GEMM", rel_err(Cout.full(), Cref), TOL_F32)
    del Cout
    Q1 = tdat.dmatmul_int8(tdat.distribute(At, procs=[0], dist=(1, 1)), Bt)
    check("dmatmul_int8 1 rank", quant_err(Q1.full(), Cref), TOL_QUANT)
    Q41 = tdat.dmatmul_int8(A41, B41)
    exact("dmatmul_int8 (4,1) vs 1 rank", Q41.full(), Q1.full())
    Q22 = tdat.dmatmul_int8(A22, B22)
    check("dmatmul_int8 (2,2) Cannon", quant_err(Q22.full(), Cref), TOL_QUANT)
    del Q1, Q41, Q22, A22, B22
    Y14 = tdat.distribute(Bt, dist=(1, 4))
    exact("X + Y, X on (4,1), Y on (1,4)", (A41 + Y14).full(), At + Bt)
    torch.cuda.synchronize()
    counts_dist = kbuild.launch_counts()
    print(f"  distributed GEMM {time.perf_counter() - t_dist:.1f} s, "
          f"launches {counts_dist}")
    missing = [k for k in ("matmul_int8", "all_gather", "all_to_all",
                           "allgather_matmul_rhs") if counts_dist[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the distributed "
                             f"GEMM path: {missing}")
    tdat.d_closeall()
    del A41, B41, Y14, At, Bt, Cref
    torch.cuda.empty_cache()

    # -- 6. ranks on several cards ------------------------------------------
    across_cards(tdat, cuda_collectives)
    tdat.init()

    # -- 5. timings ---------------------------------------------------------
    print("phase timings")

    def conv_input(lo, x, hi):
        return torch.cat([lo, x, hi])[None, None]

    wk = torch.tensor(LAPLACIAN_3X3, device=dev)[None, None]
    kernels = []
    n4 = 4096
    a, b = randn(n4, n4), randn(n4, n4)
    bms, bby = bound(3 * n4 * n4 * 4, 2 * n4 ** 3, F32_FLOPS)
    kernels.append({
        "name": "gemm", "route": "cuda",
        "source": "distributedarrays_tpu_torch/csrc/gemm.cu",
        "replaces": "distributedarrays_tpu/ops/pallas_gemm.py:218",
        "shape": "4096x4096x4096 f32",
        "ms": time_ms(lambda: cuda_gemm.cuda_matmul(a, b)),
        "plain_ms": time_ms(lambda: cuda_gemm.matmul_plain(a, b)),
        "bound_ms": bms, "bound_by": bby,
        "library_ms": time_ms(lambda: torch.matmul(a, b))})
    extra = {}
    ab, bb = a.bfloat16(), b.bfloat16()
    extra["gemm 4096^3 bf16"] = {
        "ms": time_ms(lambda: cuda_gemm.cuda_matmul(ab, bb)),
        "plain_ms": time_ms(lambda: cuda_gemm.matmul_plain(ab, bb)),
        "library_ms": time_ms(lambda: torch.matmul(ab, bb)),
        "bound_ms": bound(3 * n4 * n4 * 2, 2 * n4 ** 3, BF16_FLOPS)[0]}
    del a, b, ab, bb
    n16 = 16384
    a, b = randn(n16, n16), randn(n16, n16)
    extra["gemm 16384^3 f32"] = {
        "ms": time_ms(lambda: cuda_gemm.cuda_matmul(a, b)),
        "library_ms": time_ms(lambda: torch.matmul(a, b)),
        "bound_ms": bound(3 * n16 * n16 * 4, 2 * n16 ** 3, F32_FLOPS)[0]}
    del a, b
    x = randn(ms, ns)
    lo1, hi1 = torch.zeros(1, ns, device=dev), torch.zeros(1, ns, device=dev)
    xin = conv_input(lo1, x, hi1)
    cells = ms * ns
    lap_ops = stencil_ops(LAPLACIAN_3X3)
    bms, bby = bound((2 * cells + 2 * ns) * 4, cells * lap_ops, F32_FLOPS)
    kernels.append({
        "name": "stencil_step", "route": "cuda",
        "source": "distributedarrays_tpu_torch/csrc/stencil.cu",
        "replaces": "distributedarrays_tpu/ops/pallas_stencil.py:112",
        "shape": "8192x8192 f32, 5-point Laplacian",
        "ms": time_ms(lambda: cuda_stencil.stencil3x3_block(
            x, lo1, hi1, LAPLACIAN_3X3)),
        "plain_ms": time_ms(lambda: _apply3x3(torch.cat([lo1, x, hi1]),
                                              LAPLACIAN_3X3)),
        "bound_ms": bms, "bound_by": bby,
        "library_ms": time_ms(lambda: F.conv2d(xin, wk, padding=(0, 1)))})
    lok, hik = torch.zeros(K, ns, device=dev), torch.zeros(K, ns, device=dev)
    x4 = x[None, None]

    def conv_k():
        y = x4
        for _ in range(K):
            y = F.conv2d(y, wk, padding=1)
        return y
    bms, bby = bound((2 * cells + 2 * K * ns) * 4, K * cells * lap_ops,
                     F32_FLOPS)
    kernels.append({
        "name": "stencil_multistep", "route": "cuda",
        "source": "distributedarrays_tpu_torch/csrc/stencil.cu",
        "replaces": "distributedarrays_tpu/ops/pallas_stencil.py:213",
        "shape": f"8192x8192 f32, k={K}, 5-point Laplacian, Dirichlet",
        "ms": time_ms(lambda: cuda_stencil.stencil3x3_multistep(
            x, lok, hik, K, True, True, LAPLACIAN_3X3)),
        "plain_ms": time_ms(lambda: _multistep_plain(
            x, lok, hik, K, True, True, LAPLACIAN_3X3)),
        "bound_ms": bms, "bound_by": bby,
        "library_ms": time_ms(conv_k)})
    qa = torch.randint(-127, 128, (n16, n16), generator=gen, device=dev,
                       dtype=torch.int32).to(torch.int8)
    qb = torch.randint(-127, 128, (n16, n16), generator=gen, device=dev,
                       dtype=torch.int32).to(torch.int8)
    sa = torch.rand(n16, generator=gen, device=dev) / 127
    sb = torch.rand(n16, generator=gen, device=dev) / 127
    bms, bby = bound(2 * n16 * n16 + 8 * n16 + 4 * n16 * n16,
                     2 * n16 ** 3, INT8_OPS)
    kernels.append({
        "name": "matmul_int8", "route": "cuda",
        "source": "distributedarrays_tpu_torch/csrc/gemm_int8.cu",
        "replaces": "distributedarrays_tpu/ops/pallas_gemm.py:330",
        "shape": "16384x16384x16384 int8 -> f32",
        "ms": time_ms(lambda: cuda_gemm.cuda_matmul_int8(qa, qb, sa, sb)),
        "plain_ms": time_ms(lambda: cuda_gemm.matmul_int8_plain(
            qa, qb, sa, sb)),
        "bound_ms": bms, "bound_by": bby,
        "library_ms": time_ms(lambda: torch._int_mm(qa, qb).float() * (
            sa[:, None] * sb[None, :]))})
    del qa, qb, sa, sb
    blocks = [randn(n16 // P4, n16) for _ in range(P4)]
    blk_bytes = blocks[0].numel() * 4
    bms, bby = bound(2 * P4 * P4 * blk_bytes, 0, F32_FLOPS)
    kernels.append({
        "name": "all_gather", "route": "cuda",
        "source": "distributedarrays_tpu_torch/csrc/collectives.cu",
        "replaces": "distributedarrays_tpu/ops/pallas_collectives.py:404",
        "shape": "16384x16384 f32 as 4 row blocks on one card, dim 0",
        "ms": time_ms(lambda: cuda_collectives.ring_all_gather(blocks, 0)),
        "plain_ms": time_ms(lambda: cuda_collectives.all_gather_plain(
            blocks, 0)),
        "bound_ms": bms, "bound_by": bby,
        "library_ms": time_ms(lambda: [torch.cat(blocks) for _ in blocks])})
    bms, bby = bound(2 * P4 * blk_bytes, 0, F32_FLOPS)
    w = n16 // P4
    kernels.append({
        "name": "all_to_all", "route": "cuda",
        "source": "distributedarrays_tpu_torch/csrc/collectives.cu",
        "replaces": "distributedarrays_tpu/ops/pallas_collectives.py:469",
        "shape": "16384x16384 f32, 4 row blocks -> 4 column blocks",
        "ms": time_ms(lambda: cuda_collectives.ring_all_to_all(blocks, 1, 0)),
        "plain_ms": time_ms(lambda: cuda_collectives.all_to_all_plain(
            blocks, 1, 0)),
        "bound_ms": bms, "bound_by": bby,
        "library_ms": time_ms(lambda: [torch.cat(
            [x[:, q * w:(q + 1) * w] for x in blocks]) for q in range(P4)])})
    b_bl = [randn(n16 // P4, n16) for _ in range(P4)]
    bms, bby = bound(3 * n16 * n16 * 4, 2 * n16 ** 3, F32_FLOPS)
    kernels.append({
        "name": "allgather_matmul_rhs", "route": "cuda",
        "source": "distributedarrays_tpu_torch/csrc/collectives.cu",
        "replaces": "distributedarrays_tpu/ops/pallas_collectives.py:775",
        "shape": "16384^2 f32 (4,1)x(4,1) on one card",
        "ms": time_ms(lambda: cuda_collectives.ring_allgather_matmul_rhs(
            blocks, b_bl)),
        "plain_ms": time_ms(lambda: cuda_collectives
                            .allgather_matmul_rhs_plain(blocks, b_bl)),
        "bound_ms": bms, "bound_by": bby,
        "library_ms": time_ms(lambda: [torch.matmul(x, torch.cat(b_bl))
                                       for x in blocks])})
    del blocks, b_bl
    for kern in kernels:
        name = kern["name"]
        kern["launches"] = (counts if name in counts_main else
                            counts_dist)[name]
        kern["max_abs_err"] = errs[name]
    print(json.dumps({"timings_extra": extra, "gpu": smi}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def across_cards_only() -> int:
    """``--across-cards``: build the kernels and run phase 6 alone (for a
    machine with several cards)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import distributedarrays_tpu_torch as tdat
    from distributedarrays_tpu_torch.ops import cuda_collectives
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi)
    tdat.kbuild.build(["collectives"])
    across_cards(tdat, cuda_collectives)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(across_cards_only() if sys.argv[1:] == ["--across-cards"]
             else main())
