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
6. Attention (the serving path):
   - the kernels against their plain versions: flash attention (K5) at
     (2048, 64, 64) bf16 and f32 causal and at a ragged (1000, 16, 64) f32;
     one ring hop (K8) at (16, 2048, 64) bf16 from a live carry with keys
     fully visible, on the diagonal and fully masked (a bit-exact
     copy-through); the fused ring (K9) at S = 8192, 16 heads of 64, four
     ranks on the card, bf16 causal and not, and f32 causal.  Relative
     Frobenius error <= 1e-5 in f32 (summation order), <= 1e-2 for K5/K8
     in bf16 (p rounded to bf16 by the kernel only, and the bf16 output),
     <= 2.5e-4 for K9 in bf16 (it computes in f32; the bf16 output
     rounding of two results 1e-6 apart differs by an ulp in a few
     elements), and the hop's running max m <= 1e-5.  A control, the plain
     ring with p rounded to bf16, must exceed K9's bf16 tolerance;
   - serving at the full width of ``Config(8192, 1024, 16, 8, 4, 2048,
     bf16)`` on one rank, launch counts set to 0 before and read after:
     ``forward`` on (4, 2048) tokens must launch K5 once per layer (8) and
     agree with the same forward on the plain attention (relative error
     <= 5e-2: the bf16 residual stream is re-rounded after every layer);
     ``generate`` from an (8, 16) prompt for 240 new tokens (the
     configuration's 2016 cut to 240 for the time limit); in an f32 copy,
     the greedy tokens must equal the argmax of the K5 forward over the
     generated sequence except where the top two logits lie within 1e-4.
     Prints ms per forward, prefill and decode tokens/s;
   - sequence parallel with four ranks on the card, S = 8192, 16 heads of
     64, bf16, causal: ``ring_attention`` (16 K9 launches),
     ``ring_flash_attention`` (16 K8 launches) and ``ulysses_attention``
     (K11 + 4 K5 launches) against dense f32 attention on the card (<=
     1e-2), and ``ring_attention_prefill`` on a 3001-row f32 host prompt,
     padded to 3004 (<= 1e-5).
7. With two or more cards, one rank per card with peer access: the
   all-gather, all-to-all and ring GEMM kernels against their plain
   versions on a 16384^2 f32 array, and K9 at S = 8192 bf16, and their
   times.  With one card it prints why it did not run.
   ``python3 chip_smoke.py --across-cards`` builds the kernels and runs
   this phase alone.
8. Times each kernel with CUDA events (warm-up, then the median of 10
   batches of back-to-back calls, each batch about 5 ms long, divided by
   its count) beside its bound, its plain version and a library yardstick
   (torch.matmul for the GEMMs, F.conv2d with TF32 off for the stencils,
   torch._int_mm and the dequantizing multiply for the int8 GEMM,
   torch.cat of the same pieces for the all-gather and all-to-all,
   torch.cat then torch.matmul for the ring GEMM,
   F.scaled_dot_product_attention at the same shape for K5 and over the
   whole sequence for K9; K8 has none), and prints them as one JSON
   line.

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
# K9 in bf16: two f32 results within ~1e-6 of each other, each rounded once
# to bf16, differ by one bf16 ulp (3.9e-3) in a few elements; sound runs
# read 6e-5 to 7e-5.  A ring that rounds p to bf16 (K8's numerics) must
# land above it: chip_smoke checks that control too.
TOL_RING_BF16 = 2.5e-4
# full-width bf16 forward, K5 against the plain dense attention: the
# residual stream is re-rounded to bf16 after each of the 8 layers, so an
# attention output one ulp apart moves later roundings too
TOL_SERVE_BF16 = 5e-2
# bf16 q/k/v through the ring, the hops or ulysses against dense f32
# attention on the same values: q scaled in bf16 (K9), p rounded to bf16
# (K5/K8) and the bf16 output
TOL_SP_BF16 = 1e-2


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


def time_ms(fn, reps: int = 10, batch_ms: float = 5.0) -> float:
    """Device ms per call: the median of ``reps`` CUDA-event timings, each
    around ``n`` back-to-back calls and divided by ``n``.  ``n`` is chosen
    from a first timed call so that a batch lasts about ``batch_ms``: the
    calls queue behind each other on the stream, so the wrapper's host work
    before each launch overlaps the previous call's device time instead of
    landing inside the sample."""
    def batch(n: int) -> float:
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(n):
            fn()
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1) / n

    fn()
    torch.cuda.synchronize()
    n = max(1, min(50, int(batch_ms / max(batch(1), 1e-3))))
    return statistics.median(batch(n) for _ in range(reps))


def ring_bf16_p_plain(q_blocks, k_blocks, v_blocks, causal: bool):
    """The ring in K8's numerics (p rounded to bf16 before the PV product):
    for each rank, the plain hop over every key block in ring order, then
    finalised.  Blocks are (b, h, dh) per rank as K9 takes them."""
    from distributedarrays_tpu_torch.ops import cuda_attention as CA
    P = len(q_blocks)
    b, h, dh = q_blocks[0].shape
    out = []
    for r in range(P):
        q = q_blocks[r].transpose(0, 1)
        carry = CA.flash_carry_init(h, b, dh, q.device)
        for s in range(P):
            j = (r - s) % P
            carry = CA.flash_attention_hop_plain(
                q, k_blocks[j].transpose(0, 1), v_blocks[j].transpose(0, 1),
                *carry, r * b, j * b, causal)
        out.append(CA.flash_carry_finalize(*carry, q.dtype)[0]
                   .transpose(0, 1))
    return out


def attention_kernels(randn, errs) -> None:
    """Phase 6a: K5, K8 and K9 against their plain versions at the serving
    and sequence-parallel paths' shapes."""
    from distributedarrays_tpu_torch.models import ring_attention as RA
    from distributedarrays_tpu_torch.ops import cuda_attention as CA
    bf16, f32 = torch.bfloat16, torch.float32
    print("phase attention kernels")
    for (S, H, D), dt, causal, tol in (
            ((2048, 64, 64), bf16, True, TOL_BF16),
            ((2048, 64, 64), f32, True, TOL_F32),
            ((1000, 16, 64), f32, False, TOL_F32)):
        q, k, v = (randn(S, H, D, dtype=dt) for _ in range(3))
        o, lse = CA.flash_attention_lse(q, k, v, causal)
        po, plse = CA.flash_attention_lse_plain(q, k, v, causal)
        torch.cuda.synchronize()
        what = f"flash attention ({S}, {H}, {D}) {dt} causal={causal}"
        check(what, rel_err(o, po), tol)
        check(what + " lse", rel_err(lse, plse), TOL_F32)
        errs["flash_attention"] = max(errs["flash_attention"], max_abs(o, po))
    # one hop at (16, 2048, 64) on rank 2 of 4 (qoff 4096) from a live
    # carry (the keys at 2048): visible, diagonal, fully masked
    H, B, D = 16, 2048, 64
    q, k, v, k0, v0 = (randn(H, B, D, dtype=bf16) for _ in range(5))
    c0 = CA.flash_attention_hop_plain(
        q, k0, v0, *CA.flash_carry_init(H, B, D, q.device), 4096, 2048, True)
    for case, koff in (("visible", 0), ("diagonal", 4096), ("masked", 6144)):
        got = [x.clone() for x in c0]
        CA.flash_attention_hop(q, k, v, *got, 4096, koff, True)
        ref = CA.flash_attention_hop_plain(q, k, v, *c0, 4096, koff, True)
        torch.cuda.synchronize()
        if case == "masked":
            exact("flash hop (16, 2048, 64) bf16 masked: copy-through of m, "
                  "l, acc", got, list(c0))
            continue
        check(f"flash hop (16, 2048, 64) bf16 {case}: acc",
              rel_err(got[2], ref[2]), TOL_BF16)
        check(f"flash hop (16, 2048, 64) bf16 {case}: l",
              rel_err(got[1], ref[1]), TOL_BF16)
        # the running max takes no rounded p: exact bf16 products summed in
        # f32 in another order
        check(f"flash hop (16, 2048, 64) bf16 {case}: m",
              rel_err(got[0], ref[0]), TOL_F32)
        errs["flash_attention_hop"] = max(errs["flash_attention_hop"],
                                          max_abs(got[2], ref[2]))
    # the whole K9 ring: S = 8192, 16 heads of 64, 4 ranks on the card
    for dt, causal, tol in ((bf16, True, TOL_RING_BF16),
                            (bf16, False, TOL_RING_BF16),
                            (f32, True, TOL_F32)):
        blocks = [[randn(2048, 16, 64, dtype=dt) for _ in range(4)]
                  for _ in range(3)]
        got = RA.ring_attention_rdma(*blocks, causal)
        ref = RA.ring_attention_kernel(*blocks, causal)
        torch.cuda.synchronize()
        check(f"ring attention S=8192 4 ranks {dt} causal={causal}",
              max(rel_err(g, r) for g, r in zip(got, ref)), tol)
        errs["ring_attention"] = max(errs["ring_attention"], max(
            max_abs(g, r) for g, r in zip(got, ref)))
        if dt == bf16:
            # the lower-precision control: the same ring with p rounded to
            # bf16 must fail K9's tolerance, or the check cannot tell them
            ctl = max(rel_err(g, r) for g, r in zip(
                ring_bf16_p_plain(*blocks, causal), ref))
            print(f"  control, ring with p rounded to bf16: rel_err="
                  f"{ctl:.3e} (must exceed {TOL_RING_BF16:g})")
            if not ctl > TOL_RING_BF16:
                raise AssertionError("K9's bf16 tolerance does not separate "
                                     "a ring that rounds p to bf16")
    del q, k, v, o, po, got, ref, blocks
    torch.cuda.empty_cache()


def serving(tdat, dev) -> dict:
    """Phase 6b: the flagship transformer at full width on one rank:
    ``forward`` on (4, 2048) tokens (K5 once per layer) against the same
    forward with the plain attention, and KV-cache ``generate``; greedy
    tokens of an f32 copy against the argmax of its K5 forward."""
    T = tdat.transformer
    print("phase serving (1 rank, Config(8192, 1024, 16, 8, 4, 2048, bf16))")
    tdat.init()
    cfg = T.Config(8192, 1024, 16, 8, 4, 2048, torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(3)
    model = T.init_params(cfg, gen, dev)
    tokens = torch.randint(0, cfg.vocab, (4, 2048), generator=gen,
                           device=dev, dtype=torch.int32)
    prompt = torch.randint(0, cfg.vocab, (8, 16), generator=gen, device=dev,
                           dtype=torch.int32)
    n_new = 240
    kbuild = tdat.kbuild
    kbuild.reset_launches()
    logits = T.forward(model, tokens, cfg)
    out = T.generate(model, prompt, n_new, cfg)
    torch.cuda.synchronize()
    counts = kbuild.launch_counts()
    print(f"  launches {counts}")
    if counts["flash_attention"] != cfg.layers:
        raise AssertionError(f"forward launched flash attention "
                             f"{counts['flash_attention']} times, expected "
                             f"{cfg.layers}")
    if logits.shape != (4, 2048, cfg.vocab) or logits.dtype != torch.float32 \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"forward logits {tuple(logits.shape)} "
                             f"{logits.dtype} not finite f32 (4, 2048, V)")
    from distributedarrays_tpu_torch.ops.cuda_attention import (
        flash_attention_plain)
    ref = T.forward(model, tokens, cfg, _attend=flash_attention_plain)
    check("forward (4, 2048) bf16 vs plain attention", rel_err(logits, ref),
          TOL_SERVE_BF16)
    if out.shape != (8, 16 + n_new) or not torch.equal(out[:, :16], prompt) \
            or int(out.min()) < 0 or int(out.max()) >= cfg.vocab:
        raise AssertionError(f"generate gave {tuple(out.shape)}, tokens in "
                             f"[{int(out.min())}, {int(out.max())}]")
    del logits, ref
    # greedy decoding of an f32 copy against its K5 forward's argmax
    cfg32 = T.Config(8192, 1024, 16, 8, 4, 2048, torch.float32)
    m32 = T.Transformer(cfg32, dev)
    m32.load_state_dict({k: v.float() for k, v in model.state_dict().items()})
    g32 = T.generate(m32, prompt, n_new, cfg32)
    lg = T.forward(m32, g32[:, :-1], cfg32)[:, 15:]     # predicts 16..
    top2 = lg.topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) < 1e-4
    wrong = (lg.argmax(-1) != g32[:, 16:]) & ~near
    print(f"  f32 greedy: {int(near.sum())} of {near.numel()} positions "
          f"with a top-two logit gap under 1e-4, {int(wrong.sum())} "
          f"mismatches elsewhere")
    if wrong.any():
        raise AssertionError("greedy tokens differ from the argmax of the "
                             "K5 forward")
    del m32, g32, lg
    # ms per forward and decode tokens/s (host clock around synchronized
    # work, median of 3 after the calls above)
    fwd_ms = statistics.median(
        wall_ms(lambda: T.forward(model, tokens, cfg)) for _ in range(3))
    gen_s = statistics.median(
        wall_ms(lambda: T.generate(model, prompt, n_new, cfg)) / 1e3
        for _ in range(3))
    metrics = {"forward_ms": fwd_ms,
               "prefill_tokens_per_s": 4 * 2048 / (fwd_ms / 1e3),
               "generate_s": gen_s,
               "decode_tokens_per_s": 8 * n_new / gen_s,
               "shape": "forward (4, 2048); generate (8, 16) + 240, bf16"}
    print(json.dumps({"serving": metrics}))
    del model
    torch.cuda.empty_cache()
    return counts


def wall_ms(fn) -> float:
    """One call of ``fn`` on the host clock, ended by a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def sequence_parallel(tdat) -> dict:
    """Phase 6c: 4 ranks on the one card, S = 8192, 16 heads of 64, bf16,
    causal: ``ring_attention`` (K9), ``ring_flash_attention`` (K8),
    ``ulysses_attention`` (K11 + K5) against dense f32 attention on the
    card, and ``ring_attention_prefill`` on a host prompt that the ranks do
    not divide (the padding path)."""
    from distributedarrays_tpu_torch.ops import cuda_attention as CA
    print("phase sequence parallel (4 ranks on one card, S=8192, 16x64 "
          "bf16, causal)")
    tdat.init(nranks=4)
    tdat.seed(5)
    kbuild = tdat.kbuild
    q, k, v = (tdat.drandn((8192, 16, 64), dtype=torch.bfloat16,
                           dist=(4, 1, 1)) for _ in range(3))
    ref = CA.flash_attention_plain(q.full().float(), k.full().float(),
                                   v.full().float(), causal=True)
    kbuild.reset_launches()
    t_sp = time.perf_counter()
    steps = {"ring_attention": ("ring_attention", 16),
             "ring_flash_attention": ("flash_attention_hop", 16),
             "ulysses_attention": ("flash_attention", 4)}
    for fn, (kernel, want) in steps.items():
        before = kbuild.launch_counts()[kernel]
        o = getattr(tdat, fn)(q, k, v, causal=True)
        torch.cuda.synchronize()
        n = kbuild.launch_counts()[kernel] - before
        check(f"{fn} vs dense f32 ({n} {kernel} launches)",
              rel_err(o.full(), ref), TOL_SP_BF16)
        if n != want:
            raise AssertionError(f"{fn} launched {kernel} {n} times, "
                                 f"expected {want}")
        o.close()
    rng = np.random.default_rng(6)
    hq, hk, hv = (rng.standard_normal((3001, 16, 64), dtype=np.float32)
                  for _ in range(3))
    got = tdat.ring_attention_prefill(hq, hk, hv)
    dref = CA.flash_attention_plain(
        *(torch.from_numpy(x).to(tdat.device_of(0)) for x in (hq, hk, hv)),
        causal=True)
    if got.shape != (3001, 16, 64) or not np.isfinite(got).all():
        raise AssertionError(f"prefill gave {got.shape}")
    check("ring_attention_prefill 3001 rows f32 (padded to 3004)",
          rel_err(torch.from_numpy(got).to(dref.device), dref), TOL_F32)
    torch.cuda.synchronize()
    counts = kbuild.launch_counts()
    print(f"  sequence parallel {time.perf_counter() - t_sp:.1f} s, "
          f"launches {counts}")
    missing = [kn for kn in ("ring_attention", "flash_attention_hop",
                             "flash_attention", "all_to_all")
               if counts[kn] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the sequence-parallel "
                             f"path: {missing}")
    tdat.d_closeall()
    del q, k, v, ref, dref
    torch.cuda.empty_cache()
    return counts


def attention_timings(randn) -> list[dict]:
    """Timing rows of K5, K8 and K9 at the paths' shapes.  Bounds count the
    causal pairs each call needs (4*D operations a pair for K5/K8, 8*D for
    K9's exact products) and each input read once and each output written
    once."""
    import torch.nn.functional as F
    from distributedarrays_tpu_torch.models import ring_attention as RA
    from distributedarrays_tpu_torch.ops import cuda_attention as CA
    bf16 = torch.bfloat16
    rows = []
    S, H, D = 2048, 64, 64
    q, k, v = (randn(S, H, D, dtype=bf16) for _ in range(3))
    qs, ks, vs = (x.transpose(0, 1)[None] for x in (q, k, v))
    pairs = S * (S + 1) // 2
    bms, bby = bound(4 * S * H * D * 2 + H * S * 4, 4 * D * pairs * H,
                     BF16_FLOPS)
    rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": "distributedarrays_tpu_torch/csrc/attention.cu",
        "replaces": "distributedarrays_tpu/ops/pallas_attention.py:75",
        "shape": "(2048, 64, 64) bf16 causal (the forward's 4 x 16 heads)",
        "ms": time_ms(lambda: CA.flash_attention_lse(q, k, v, True)),
        "plain_ms": time_ms(lambda: CA.flash_attention_lse_plain(
            q, k, v, True)),
        "bound_ms": bms, "bound_by": bby,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True))})
    H, B, D = 16, 2048, 64
    q, k, v = (randn(H, B, D, dtype=bf16) for _ in range(3))
    carry = CA.flash_attention_hop_plain(
        q, k, v, *CA.flash_carry_init(H, B, D, q.device), 4096, 2048, True)
    # a fully visible hop (rank 2's q block against rank 0's keys), in
    # place on a copy of a live carry; the carry is read and written in f32
    bms, bby = bound(3 * H * B * D * 2 + 2 * (2 * H * B + H * B * D) * 4,
                     4 * D * B * B * H, BF16_FLOPS)
    live = [x.clone() for x in carry]
    rows.append({
        "name": "flash_attention_hop", "route": "cuda",
        "source": "distributedarrays_tpu_torch/csrc/attention.cu",
        "replaces": "distributedarrays_tpu/ops/pallas_attention.py:348",
        "shape": "(16, 2048, 64) bf16, one fully visible causal hop",
        "ms": time_ms(lambda: CA.flash_attention_hop(q, k, v, *live, 4096, 0,
                                                     True)),
        "plain_ms": time_ms(lambda: CA.flash_attention_hop_plain(
            q, k, v, *carry, 4096, 0, True)),
        "bound_ms": bms, "bound_by": bby,
        # no one PyTorch call updates an online-softmax carry
        "library_ms": None})
    blocks = [[randn(2048, 16, 64, dtype=bf16) for _ in range(4)]
              for _ in range(3)]
    S = 8192
    whole = [torch.cat(b).transpose(0, 1)[None] for b in blocks]
    # K9 in bf16 keeps f32 numerics on the bf16 tensor cores: one QK^T
    # product (bf16 q and k, exact) and three PV products (p split into
    # three bf16 terms), 8*D operations a causal pair at the bf16 rate
    bms, bby = bound(4 * S * 16 * 64 * 2, 8 * 64 * (S * (S + 1) // 2) * 16,
                     BF16_FLOPS)
    rows.append({
        "name": "ring_attention", "route": "cuda",
        "source": "distributedarrays_tpu_torch/csrc/attention.cu",
        "replaces": "distributedarrays_tpu/models/ring_attention.py:146",
        "shape": "S=8192, 16 heads of 64, bf16 causal, 4 ranks on one card "
                 "(16 launches)",
        "ms": time_ms(lambda: RA.ring_attention_rdma(*blocks, True)),
        "plain_ms": time_ms(lambda: RA.ring_attention_kernel(*blocks, True)),
        "bound_ms": bms, "bound_by": bby,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            *whole, is_causal=True))})
    return rows


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
    # K9: S = 8192 over the cards, 16 heads of 64, bf16, causal
    from distributedarrays_tpu_torch.models import ring_attention as RA
    qkv = [[torch.randn(8192 // p, 16, 64, generator=torch.Generator(
        device=d).manual_seed(20 + 3 * i + j), device=d).bfloat16()
        for i, d in enumerate(devs)] for j in range(3)]

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
                                                                b_bl)),
        "ring_attention": (
            lambda: RA.ring_attention_rdma(*qkv, True),
            lambda: RA.ring_attention_kernel(*qkv, True))}
    times = {}
    for name, (kern, plain) in cases.items():
        got, ref = kern(), plain()
        sync()
        if name in ("allgather_matmul_rhs", "ring_attention"):
            check(f"{name} across {p} cards",
                  max(rel_err(g, r) for g, r in zip(got, ref)),
                  TOL_F32 if name != "ring_attention" else TOL_RING_BF16)
        else:
            exact(f"{name} across {p} cards", got, ref)
        del got, ref
        times[name] = {"ms": wall_ms(kern), "plain_ms": wall_ms(plain)}
    print(json.dumps({"across_cards": times, "cards": p,
                      "shape": f"{n}x{n} f32 in {p} row blocks; ring "
                               "attention S=8192, 16x64 bf16 causal"}))


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

    # -- 6. attention: kernels, serving, sequence parallel -----------------
    attention_kernels(randn, errs)
    counts_serve = serving(tdat, dev)
    counts_sp = sequence_parallel(tdat)

    # -- 7. ranks on several cards ------------------------------------------
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
    kernels += attention_timings(randn)
    for kern in kernels:
        name = kern["name"]
        kern["launches"] = (
            counts if name in counts_main else counts_serve
            if name == "flash_attention" else counts_sp
            if name in ("flash_attention_hop", "ring_attention")
            else counts_dist)[name]
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
    tdat.kbuild.build(["collectives", "attention"])
    across_cards(tdat, cuda_collectives)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(across_cards_only() if sys.argv[1:] == ["--across-cards"]
             else main())
