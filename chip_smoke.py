"""Drive the PyTorch/CUDA port (distributedarrays_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit and the torch version, and
   builds the hand-written CUDA kernels from ``distributedarrays_tpu_torch/
   csrc`` (nvcc, sm_90a) into ``build/torch_kernels/``.
2. Holds each kernel against its plain PyTorch version on the card, at the
   main path's shapes:
   - block GEMM on each of its routes, each call moving its own route's
     count and no other: bf16 on wgmma + TMA at 4096^3, at a ragged
     1000x776 @ 776x1496 and at 100x24 @ 24x40 (smaller than a TMA box),
     bf16 on mma.sync at 1000x777 @ 777x1500 (which
     TMA cannot stride), f32 at 4096^3 and 1000x777 @ 777x1500.  f32
     results, and the bf16 routes' f32 output taken from the C entry, at
     relative Frobenius error <= 1e-5 (exact bf16 products, summation order
     only); the bf16 output bit for bit the f32 output rounded, and within
     one bf16 ulp of the plain product rounded in at most 1 % of the
     elements (except where the order error exceeds a bf16 spacing, next
     to zero);
   - single-step stencil: 8192^2 f32, random weights, nonzero halo rows;
   - multistep stencil: 8192^2, 1000x777 (m not a multiple of a tile, n
     odd) and 7x8193 (m below the tile height and below k), each at k =
     1, 8 and 16, all four Dirichlet flag settings, random weights on the
     generic route and the Laplacian on the 5-point route, every call on
     the route ``multistep_route`` picks;
   - both stencils in float16, bfloat16 and int32 (``TYPED_SHAPES``, K2
     also at 1x8192 and off its alignment; float16 K3 at k = 1 and 8).
   Stencils bit for bit (``exact``: the kernels sum in the plain order
   without FMA contraction).
3. Runs the five BASELINE.md configurations through the public API on one
   rank, with every kernel's launch count set to 0 just before and read
   just after; each result is checked against plain torch on the card, and
   the run fails if a kernel of the path was not launched:
   distribute/drand 4096^2; ``A @ B`` under the default (torch.matmul) and
   with the tuning registry set to the kernel; ``dsum(A*A)``; the 8192^2
   broadcast chain ``sin(A) + B*C``; ``dmapreduce(abs2, +)``, ``dmean`` and
   ``dstd`` on a 1e8-element DVector; a 16384^2 f32 ``A @ B`` through the
   kernel; ``stencil5`` on 8192^2 with ``iters=16`` (multistep kernel,
   auto depth 8: two launches, both on the 5-point route) and ``iters=1``
   (single-step kernel), each bit for bit against the plain steps;
   ``gather``.
   The same phase holds the kernels of the distributed GEMM tier against
   their plain versions: the int8 GEMM on each route, each call moving
   its own route's count and no other (``INT8_CASES``: wgmma + TMA at
   16384^3, at a ragged 1000x784x1500 and at 100x48x40, smaller than one
   tile; mma.sync at 1000x777x1500), f32 and bf16 out, bit-exact (exact
   int32 sums and the same two f32 multiplies); the
   all-gather and all-to-all on a 16384^2 f32 array over 4 ranks on the
   one card and on bf16 blocks of odd width (4 x (4096, 1001) gathered
   along dims 0 and 1, 4 x (4096, 1004) all-to-all both ways), whose
   copies must take the 16-, 4- and 1-byte accesses between them
   (bit-exact: pure data movement); the ring all-gather GEMM at
   16384^2 (4,1)x(4,1), relative Frobenius error <= 1e-5 in f32 and
   <= 1e-2 in bf16 (per-step product order and rounding).
4. Runs a (4,1) stencil and a (2,2)x(2,2) GEMM with four ranks on the one
   card and compares them with the one-rank results; then ``stencil5`` of
   8192^2 (4,1) DArrays in float16, bfloat16 and int32 through K2 and K3,
   bit for bit against the plain steps on the card and on the host, and
   an int8 one refused with ``TypeError`` (``stencil_dtypes``).
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
   the run fails if one of the four kernels was not launched, or if the
   int8 GEMM's 13 launches (1 x 16384^3, 4 x 4096x16384x16384, 8 x
   8192^3) did not all take its wgmma route.
   Then the reference surface (``reference_surface``): on one rank at
   8192^2 f32 whole-array ``==`` (True against a copy, False after one
   element is set), ``fill_``, ``rand_``, ``dcumsum``/``dcummax`` along
   each axis (against float64 / bit for bit), ``dextrema``, ``dcount``,
   ``dall``/``dany``, ``mapslices`` of a column normalisation and ``djit``
   bit for bit against the owner-computes chain; on 4 ranks ``bench.py``'s
   reshard_uneven/reshard_mutate shapes (``fill_``, ``copyto_``, a region
   write that must leave the non-owner ranks' tensors untouched),
   ``samedist`` (4,1) -> (1,4) at 16384^2 (exactly one all-to-all
   launch, bit for bit against the plain all-to-all), ``mapslices`` over
   the split dim of a (1,4) DArray (must launch the all-to-all) and
   ``dcumsum`` of a (4,1) 16384^2 DArray against one rank.  Each call is
   timed once by CUDA events.
   Then the reshard chain and SPMD mode (``reshard_spmd``), four ranks on
   the card: the moves (4,1) -> (2,2) at 16384^2 f32 (``chain``, one a2a),
   the mesh-axis transpose of a (2,2) 16384^2 f32 DArray (gather, a2a,
   slice), the padded chain of 16383 x 16384 f32 on ceil cuts, and the
   multi-axis ``allgather`` onto its 4 ranks and ``gather_put`` onto 2
   (gather, gather), each with its plan printed, bit for bit against the
   plain region-by-region relayout, exactly one copy launch per card for
   each non-slice step (counts set to 0 before, read after), the peak
   memory within the source shards plus the largest step's input and
   output (+64 MiB for the allocator), and its ms beside the plain
   relayout's and the bound; ``spmd`` on 4 thread tasks (a ring of CUDA
   localparts, barrier, bcast, scatter, gather_spmd); ``life2d`` on a
   (2,2) and ``life`` on a (4,1) 16384^2 uint8 grid, 8 generations, bit for
   bit against the plain whole-grid generations on one device.
   Then sort, FFT and conv (``sort_fft_conv``), four ranks on the card:
   K11 in complex64 and int64 and the exact-size exchange
   ``ring_all_to_allv`` bit for bit against the plain all-to-all, K11's
   complex64 time at 8192^2 beside its bound; ``dfft`` along the sharded
   axis of an 8192^2 complex64 (4,1) DArray (2 K11 launches),
   ``dfft2``/``difft2`` (2 each) and the four-step ``dfft``/``difft`` of a
   2**26 complex64 DVector (3 each) against whole-array ``torch.fft``
   (relative Frobenius error <= 1e-5); ``dsort`` of bench.py's 1e7 vector
   and a 1e8 DVector (1 K11 launch each), bit for bit against
   ``torch.sort``, sorted and a permutation of the input; ``dconv2d`` of
   an 8192^2 f32 (4,1) image (3x3, 5x5) and a batch-sharded NHWC (8, 512,
   512, 64) x (3, 3, 64, 64) against ``F.conv2d`` with TF32 off (<= 1e-5,
   no K11 launch); each op's ms by CUDA events and device ms beside its
   library call's.
6. Attention (the serving path):
   - the kernels against their plain versions: flash attention (K5) on
     each route, every call's launch on the route
     ``flash_attention_route`` picks (``kbuild.route_counts()``): bf16 on
     wgmma + TMA at (2048, 64, 64) causal and not, on the serving forward's
     fused-QKV (S, B, H, D) views (2048, 4, 16, 64), at head dim 128 and at
     a ragged S = 1000, bf16 on mma.sync at head dim 36, f32 at (2048, 64,
     64) causal and a ragged (1000, 16, 64), lse within 1e-5; one ring hop
     (K8) from a live carry with keys fully visible, on the diagonal and
     fully masked (a bit-exact copy-through), every call on its expected
     route: wgmma + TMA at (16, 2048, 64) and (16, 1024, 128) bf16 and on
     a zigzag part ((16, 1024, 64) row halves of (16, 2048, 64) blocks),
     mma.sync at (16, 1000, 36) bf16, f32 at (16, 1024, 64); the fused
     ring (K9) at S = 8192, 16 heads of 64, four
     ranks on the card, bf16 causal and not, and f32 causal, a ragged bf16
     ring (4 x 1000 rows), bf16 rings at head dims 128 and 32 (4 x 512
     rows, 4 heads) and a bf16 ring on the mma.sync route (head dim 36),
     each 16 launches with 10 (causal) or 16 compute steps on the expected
     route.  Relative
     Frobenius error <= 1e-5 in f32 (summation order), <= 1e-2 for K5/K8
     in bf16 (p rounded to bf16 against another running max, and the
     bf16 output),
     <= 2.5e-4 for K9 in bf16 (it computes in f32; the bf16 output
     rounding of two results 1e-6 apart differs by an ulp in a few
     elements), and the hop's running max m <= 1e-5.  A control, the plain
     ring with p rounded to bf16, must exceed K9's bf16 tolerance;
   - serving at the full width of ``Config(8192, 1024, 16, 8, 4, 2048,
     bf16)`` on one rank, launch counts set to 0 before and read after:
     ``forward`` on (4, 2048) tokens must launch K5 once per layer (8), all
     on the wgmma route, and no K6 or K7, and agree with the same forward
     on the plain attention (relative error <= 5e-2: the bf16 residual
     stream is re-rounded after every layer);
     ``generate`` from an (8, 16) prompt for 240 new tokens (the
     configuration's 2016 cut to 240 for the time limit); in an f32 copy,
     the greedy tokens must equal the argmax of the K5 forward over the
     generated sequence except where the top two logits lie within 1e-4.
     Prints ms per forward, prefill and decode tokens/s;
   - sequence parallel with four ranks on the card, S = 8192, 16 heads of
     64, bf16, causal: ``ring_attention`` (16 K9 launches),
     ``ring_flash_attention`` (16 K8 launches, all on the wgmma route)
     and ``ulysses_attention``
     (K11 + 4 K5 launches) against dense f32 attention on the card (<=
     1e-2), and ``ring_attention_prefill`` on a 3001-row f32 host prompt,
     padded to 3004 (<= 1e-5).
7. Training:
   - the kernels against their plain versions: the FlashAttention-2
     backward, dq (K6) and dk/dv (K7), every K6 and K7 launch on its
     expected route: bf16 on wgmma + TMA at (2048, 64, 64) causal and not,
     on ``train_step``'s fused-QKV views (2048, 4, 16, 64), at head dims 8,
     32, 96 and 128 and at a ragged (1000, 16, 64), bf16 on mma.sync at
     head dim 36, f32 at (2048, 64, 64) causal and at a ragged (1000, 16,
     64), causal and not; one ring hop's backward at (16, 2048, 64) bf16
     with f32 contributions (K6 and K7 on wgmma), visible, diagonal and
     fully masked (zero contributions, bit-exact); the reduce-scatter (K12)
     over
     4 ranks on the card at the trainer's gradient length (119555072 f32)
     and on a (16, 384, 64) bf16 block along dim 1, bit-exact.  Relative
     Frobenius error <= 1e-5 in f32 (summation order), <= 5e-4 in bf16
     (p and dS rounded to bf16 at the same places, f32 sums in another
     order, the bf16 output).  A control, the plain backward with p and dS
     left in f32, must exceed the bf16 tolerance;
   - ``train_step`` at the full width of ``Config(8192, 1024, 16, 8, 4,
     2048, bf16)`` on one rank with (4, 2049) tokens: one step's
     gradients against the same step with the plain attention backward,
     per parameter (<= 5e-2: the bf16 residual stream and its gradient are
     re-rounded after every layer); then five SGD steps (lr 0.3) on the
     fixed batch, launch counts read around each: 8 K5, 8 K6 and 8 K7 a
     step, every K5, K6 and K7 launch on the wgmma route, and the last loss
     below the first.  Prints ms per step and
     training tokens/s;
   - the data-parallel ``Trainer`` with four ranks on the card on
     ``transformer_task(8192, 1024, 16, 8, seq 2048, batch 8)`` (f32):
     three Adam steps, each launching 1 K10 (one launch for the card's
     four destinations), 4 K12 and 32 K5, K6 and K7
     (8 a rank), every K5, K6 and K7 launch on the f32 route; two SGD steps
     on 4 ranks against the same two on one rank (losses to 1e-4, flat
     parameters <= 1e-5).  Prints ms per step and
     the peak device memory;
   - the ring GEMMs against their plain versions with four ranks on the
     card: K13 (4 x (2048, 1024) @ (1024, 1024)), K15 (4 x (8192, 1024) @
     (1024, 1024)) and K14 at its weight-gradient shape (4 x (1024, 8192)
     with (2048, 1024) chunks), in bf16 (relative Frobenius error <= 5e-4,
     held against a control, the plain ring with f32 products and sums,
     that must read above it) and f32 (<= 1e-5), and at ragged f32 shapes
     (m_loc 1000, k 768, n 300; K15 also at k 770, n 302, which its 16-byte
     copies cannot take); in bf16 also at a ragged shape TMA can read (m_loc
     1000, k 776, n 296; K15 n 1496) and one it cannot (k 777, n 300), each
     call's 16 launches on its expected route (``kbuild.route_counts()``:
     wgmma, mma or f32), the sequence-parallel bf16 shapes with each wgmma
     tile width;
   - sequence-parallel training at the full width of ``SPConfig(8192,
     1024, 16, 8, 4, 8192, bf16)`` with four ranks on the card, tokens (1,
     8192): a gradient step must launch 128 each of K8, K6 and K7 and 256
     each of K13, K14 and K15 (no K5, no K9), every K8, K6, K7, K13, K14
     and K15 launch on the wgmma route, and its loss and gradients
     agree with the dense flagship ``transformer.loss_fn`` on one rank (loss
     <= 1e-2, every gradient <= 5e-2, the w1/w2 shards joined); the zigzag
     layout (288 hops of each attention kernel) against the contiguous
     step alike; three SGD steps (lr 0.3, the loss must fall, counts read
     around each) and two Adam steps (lr 1e-3, the loss must fall).  Prints
     ms per step, training tokens/s and the peak device memory.
8. With two or more cards, one rank per card with peer access: the
   all-gather, all-to-all and ring GEMM kernels against their plain
   versions on a 16384^2 f32 array, K13, K14 and K15 in bf16 at the
   sequence-parallel shapes on their ``wgmma_peer`` route, and K9 at S =
   8192 bf16, and their times.  With one card it prints why it did not
   run.
   ``python3 chip_smoke.py --across-cards`` builds the kernels and runs
   this phase alone.
9. Times each kernel with CUDA events (warm-up, then the median of 10
   batches of back-to-back calls, each batch about 5 ms long, divided by
   its count) beside its bound, its plain version and a library yardstick
   (torch.matmul for the GEMMs, F.conv2d with TF32 off for the stencils,
   torch._int_mm and the dequantizing multiply for the int8 GEMM,
   torch.cat of the same pieces for the all-gather and all-to-all,
   torch.cat then torch.matmul for the ring GEMMs K13 and K14 and one
   torch.matmul per rank then torch.stack(...).sum(0) per destination for
   K15 (whose rows also give their launches' device time and the host's
   microseconds a launch),
   F.scaled_dot_product_attention at the same shape for K5 and over the
   whole sequence for K9 (whose row also gives the device time of its 16
   launches alone, from a torch.profiler trace), its backward for K6 and
   K7; K8 has none;
   torch.stack(...).sum(0) per destination for K12), and prints them as
   one JSON line; the all-gather and all-to-all rows also carry the
   launches of the reference surface and the reshard chain phases
   (``surface_launches``, ``reshard_spmd_launches``), and the all-to-all
   row those of the sort, FFT and conv phase (``sort_fft_conv_launches``)
   and its complex64 timing (``complex64``).

``python3 chip_smoke.py --k1-k9`` builds the GEMM and attention kernels
alone, checks K1 on every route and the K9 rings, and times both;
``python3 chip_smoke.py --time-k1-k9 [DIR]`` times K1 and K9 (per call, and
the K9 ring's device time alone from a ``torch.profiler`` trace) through
the package under DIR, so an unpacked older commit and this one can be
timed in turns on one card; ``python3 chip_smoke.py --time-ring-gemms
[DIR]`` does the same for K13, K14 and K15 in bf16 and f32 (per call,
device time, host microseconds a launch, and each wgmma tile width).

``python3 chip_smoke.py --time-attn [DIR]`` times K5, K6, K7 and K9 (per
call and device time), the scaled_dot_product_attention forward and
backward, ``forward`` and ``train_step`` through the package under DIR,
for a parent and a change timed in turns on one card.

``python3 chip_smoke.py --time-k4-k8 [DIR]`` times K4 (16384^3 and one
Cannon step, 8192^3), K8 (the visible (16, 2048, 64) hop and a zigzag
part's, with each consumer warpgroup count), K10 against ``torch.cat`` in
turns, and the sequence-parallel SGD step's K8 device time, through the
package under DIR, for a parent and a change timed in turns on one card.

``python3 chip_smoke.py --time-k3-k10 [DIR]`` times K3 (8192^2, k = 8,
both Dirichlet settings, both routes) beside ``F.conv2d`` x 8, K2, K10
(16384^2 f32 on 4 ranks, dims 0 and 1) beside ``torch.cat`` per rank and
K11 beside ``torch.cat`` of its pieces, through the package under DIR,
for a parent and a change timed in turns on one card; ``python3
chip_smoke.py --k3-k10`` builds the stencil and collective kernels alone
and holds K2, K3, K10 and K11 to phase 2's checks.

``python3 chip_smoke.py --surface`` builds the collective kernels alone
and runs the reference surface phase of step 5; ``python3 chip_smoke.py
--reshard-spmd`` and ``python3 chip_smoke.py --sort-fft-conv`` do the same
for the reshard chain and SPMD phase and for the sort, FFT and conv
phase.

``python3 chip_smoke.py --profile`` runs one full-width ``train_step``, one
4-rank ``Trainer`` step and one sequence-parallel step under
``torch.profiler`` instead, and prints their device time by kernel and by
kind and the device's idle share.  ``python3 chip_smoke.py --ring-gemms``
builds the collectives alone and checks and times K13, K14 and K15.

The last line is ``{"ok": true, "device": {...}}``; any failing phase raises
and the script exits non-zero.  Without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import itertools
import json
import os
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
# K1 with bf16 output against the plain product rounded once to bf16: the
# f32 sums differ in order only (about 4e-6 of the result's rms at K =
# 4096), so an element rounds to the neighbouring bf16 value only near a
# rounding boundary (about 2e-3 of them): at most one ulp, in at most this
# share of the elements.  Elements so near zero that one bf16 spacing is
# below TOL_F32 of the rms are exempt: the order moves them by many spacings
GEMM_BF16_FLIPS = 1e-2
# full-width bf16 forward, K5 against the plain dense attention: the
# residual stream is re-rounded to bf16 after each of the 8 layers, so an
# attention output one ulp apart moves later roundings too
TOL_SERVE_BF16 = 5e-2
# bf16 q/k/v through the ring, the hops or ulysses against dense f32
# attention on the same values: q scaled in bf16 (K9), p rounded to bf16
# (K5/K8) and the bf16 output
TOL_SP_BF16 = 1e-2
# full-width bf16 training step, gradients with the K6/K7 backward against
# the same step with the plain attention backward: the forward's tolerance,
# since the bf16 residual stream and its gradient are re-rounded per layer
TOL_TRAIN_BF16 = 5e-2
# K6/K7 in bf16 against the plain backward: p and dS rounded to bf16 at the
# same places, f32 sums in another order, each output rounded once to bf16.
# A control, the plain backward that leaves the rounding of p and dS out,
# must land above it: chip_smoke checks that control too.
TOL_BWD_BF16 = 5e-4
TRAIN_LR = 0.3        # SGD on one fixed batch of random tokens
# the sequence-parallel transformer: bench.py's sp_train entry, bf16, on
# (1, 8192) tokens, 4 ranks on one card
SP_CFG = (8192, 1024, 16, 8, 4, 8192)
SP_LR = 0.3           # SGD on one fixed batch, as the flagship's train_step
SP_ADAM_LR = 1e-3
# the sequence-parallel step against the dense flagship on one rank: the same
# bf16 parameters and tokens through other kernels (K8 hops and ring GEMMs
# against K5 and torch.matmul), each rounding the bf16 residual stream and
# its gradient in its own order; the train_step check's TOL_TRAIN_BF16
TOL_SP_LOSS = 1e-2
TOL_SP_GRAD = 5e-2
TRAIN_CFG = (8192, 1024, 16, 8, 4, 2048)     # the flagship, bf16
# the 4-rank trainer against the 1-rank trainer on the same two SGD steps:
# the same per-rank arithmetic, the gradient summed over ranks in the ring
# order instead of over one batch
TOL_TRAINER_LOSS = 1e-4
TOL_TRAINER_PARAMS = 1e-5


def rel_err(x: torch.Tensor, ref: torch.Tensor) -> float:
    x, ref = x.float(), ref.float()
    return float((x - ref).norm() / ref.norm().clamp_min(1e-30))


def max_abs(x: torch.Tensor, ref: torch.Tensor) -> float:
    if x.is_complex():
        return float((x - ref).abs().max())
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


# the sequence-parallel FFN's ring GEMMs at their training shapes (4 ranks,
# s = 8192, e = 1024, f = 4096): (name, x block, w block) per rank
RING_GEMM_SHAPES = (("allgather_matmul", (2048, 1024), (1024, 1024)),
                    ("matmul_reducescatter", (8192, 1024), (1024, 1024)),
                    ("allgather_matmul_rhs", (1024, 8192), (2048, 1024)))
# bf16 ring GEMMs against their plain versions: the same bf16 products
# (exact in f32) summed in f32 in another order, so a few outputs round to
# the neighbouring bf16 value.  A control, the plain ring with every product
# and partial sum left in f32 and rounded once at the end (for K13, whose
# blocks are each rounded once already, not rounded at all), must land
# above it.
TOL_RING_GEMM_BF16 = 5e-4


def ring_gemm_fns(name: str):
    """(kernel, plain) of one ring GEMM over rank lists."""
    from distributedarrays_tpu_torch.ops import cuda_collectives as CC
    return {"allgather_matmul": (CC.ring_allgather_matmul,
                                 CC.allgather_matmul_plain),
            "matmul_reducescatter": (CC.ring_matmul_reducescatter,
                                     CC.matmul_reducescatter_plain),
            "allgather_matmul_rhs": (CC.ring_allgather_matmul_rhs,
                                     CC.allgather_matmul_rhs_plain)}[name]


def ring_gemm_control(name: str, xs, ws) -> list[torch.Tensor]:
    """The bf16 control: every rank's result with f32 products and sums,
    rounded once to bf16 (K14, K15) or left in f32 (K13)."""
    p = len(xs)
    if name == "allgather_matmul":
        whole = torch.cat(xs).float()
        return [whole @ w.float() for w in ws]
    if name == "allgather_matmul_rhs":
        whole = torch.cat(ws).float()
        return [(x.float() @ whole).bfloat16() for x in xs]
    m = xs[0].shape[0] // p
    return [sum(x[d * m:(d + 1) * m].float() @ w.float()
                for x, w in zip(xs, ws)).bfloat16() for d in range(p)]


# K13, K14 and K15 on each route: (name, x block, w block, dtype, route)
# with 4 ranks.  The sequence-parallel shapes; a ragged bf16 shape that TMA
# can read (K and N multiples of 8, boxes running past every edge; for K15
# m_loc 1000 and n 1496, a multiple of 8 but not of 64); a bf16 shape it
# cannot (K and N odd or not multiples of 8), which takes mma.sync; f32 at
# the sequence-parallel and ragged shapes, K15's also where its 16-byte
# copies cannot run (k and n not multiples of 4).
RING_GEMM_CASES = (
    ("allgather_matmul", (2048, 1024), (1024, 1024), torch.bfloat16, "wgmma"),
    ("allgather_matmul", (1000, 776), (776, 296), torch.bfloat16, "wgmma"),
    ("allgather_matmul", (1000, 777), (777, 300), torch.bfloat16, "mma"),
    ("allgather_matmul", (2048, 1024), (1024, 1024), torch.float32, "f32"),
    ("allgather_matmul", (1000, 768), (768, 300), torch.float32, "f32"),
    ("allgather_matmul_rhs", (1024, 8192), (2048, 1024), torch.bfloat16,
     "wgmma"),
    ("allgather_matmul_rhs", (1000, 4 * 776), (776, 296), torch.bfloat16,
     "wgmma"),
    ("allgather_matmul_rhs", (1000, 4 * 777), (777, 300), torch.bfloat16,
     "mma"),
    ("allgather_matmul_rhs", (1024, 8192), (2048, 1024), torch.float32,
     "f32"),
    ("allgather_matmul_rhs", (1000, 4 * 192), (192, 300), torch.float32,
     "f32"),
    ("matmul_reducescatter", (8192, 1024), (1024, 1024), torch.bfloat16,
     "wgmma"),
    ("matmul_reducescatter", (4 * 1000, 776), (776, 1496), torch.bfloat16,
     "wgmma"),
    ("matmul_reducescatter", (4 * 1000, 777), (777, 300), torch.bfloat16,
     "mma"),
    ("matmul_reducescatter", (8192, 1024), (1024, 1024), torch.float32,
     "f32"),
    ("matmul_reducescatter", (4000, 768), (768, 300), torch.float32, "f32"),
    ("matmul_reducescatter", (4000, 770), (770, 302), torch.float32, "f32"))


# the wgmma route's tile widths
RING_TILES = (64, 128)


class forced_tile:
    """Within the block, the wgmma route of K13, K14 and K15 takes 128 x
    ``tile_n`` tiles whatever ``ring_tile_n`` would choose (None: its own
    choice)."""

    def __init__(self, CC, tile_n: int | None):
        self.CC, self.tile_n = CC, tile_n

    def __enter__(self):
        self.saved = self.CC.ring_tile_n
        if self.tile_n:
            self.CC.ring_tile_n = lambda m, n, sms: self.tile_n

    def __exit__(self, *exc):
        self.CC.ring_tile_n = self.saved


def ring_gemm_kernels(randn, errs) -> None:
    """K13, K14 and K15 against their plain versions with 4 ranks on the
    card (``RING_GEMM_CASES``).  Every call must move its route's count by
    its 16 launches and no other route's; the sequence-parallel bf16 shapes
    also run with each wgmma tile width (128 x 64 and 128 x 128).  bf16
    within TOL_RING_GEMM_BF16, held against its f32 control, f32 within
    TOL_F32."""
    from distributedarrays_tpu_torch.ops import cuda_collectives as CC
    from distributedarrays_tpu_torch.utils import kbuild
    bf16 = torch.bfloat16
    print("phase ring GEMM kernels (4 ranks on one card)")
    for name, xs_, ws_, dt, route in RING_GEMM_CASES:
        kern, plain = ring_gemm_fns(name)
        xs = [randn(*xs_, dtype=dt) for _ in range(4)]
        ws = [randn(*ws_, dtype=dt) / 32 for _ in range(4)]
        ref = plain(xs, ws)
        sp = route == "wgmma" and (name, xs_, ws_) in RING_GEMM_SHAPES
        for tile in ((None,) + RING_TILES if sp else (None,)):
            with forced_tile(CC, tile):
                before = kbuild.route_counts()[name]
                got = kern(xs, ws)
                torch.cuda.synchronize()
            what = f"{name} 4 x {xs_} @ {ws_} {dt} on {route}"
            if tile:
                what += f", 128 x {tile} tiles"
            moved = {r: c - before[r]
                     for r, c in kbuild.route_counts()[name].items()}
            if moved != {r: 16 * (r == route) for r in moved}:
                raise AssertionError(f"{what}: route counts moved {moved}")
            err = max(rel_err(g, r) for g, r in zip(got, ref))
            check(what, err, TOL_RING_GEMM_BF16 if dt == bf16 else TOL_F32)
            errs[name] = max(errs[name], max(max_abs(g, r)
                                             for g, r in zip(got, ref)))
            del got
        if dt == bf16:
            ctl = max(rel_err(c, r) for c, r in zip(
                ring_gemm_control(name, xs, ws), ref))
            print(f"  control, {name} with f32 products and sums: "
                  f"rel_err={ctl:.3e} (must exceed {TOL_RING_GEMM_BF16:g})")
            if not ctl > TOL_RING_GEMM_BF16:
                raise AssertionError(f"{name}'s bf16 tolerance does not "
                                     "separate the f32 control")
        del xs, ws, ref
    torch.cuda.empty_cache()


def host_us_per_launch(fn, launches: int, calls: int = 20) -> float:
    """Host microseconds a launch of ``fn`` (``launches`` launches a call),
    timed with synchronisation off: the host clock around ``calls``
    back-to-back calls, which only enqueue work, over their launches."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / calls / launches * 1e6


def ring_gemm_timings(randn, extra: dict) -> list[dict]:
    """Timing rows of K13 and K15 at the sequence-parallel FFN's bf16
    shapes, 4 ranks on one card, and into ``extra`` their f32 times and
    K14's at its bf16 and f32 weight-gradient shape.  Bound: 2*m*n*k
    operations over all ranks and steps at the type's peak rate, against
    the bytes of each input read once and each output written once.
    Library: the same products as one ``torch.matmul`` per rank on the
    gathered operand (K13, K14), or per rank and then
    ``torch.stack(...).sum(0)`` per destination (K15).  Each also gives the
    device time of its 16 launches alone (``device_ms``) and the host's
    microseconds a launch with synchronisation off."""
    rows = []
    lines = {"allgather_matmul": 735, "matmul_reducescatter": 886}
    for (name, xshape, wshape), dt in (
            (RING_GEMM_SHAPES[0], torch.bfloat16),
            (RING_GEMM_SHAPES[1], torch.bfloat16),
            (RING_GEMM_SHAPES[2], torch.bfloat16),
            (RING_GEMM_SHAPES[0], torch.float32),
            (RING_GEMM_SHAPES[1], torch.float32),
            (RING_GEMM_SHAPES[2], torch.float32)):
        kern, plain = ring_gemm_fns(name)
        xs = [randn(*xshape, dtype=dt) for _ in range(4)]
        ws = [randn(*wshape, dtype=dt) / 32 for _ in range(4)]
        if name == "allgather_matmul":
            out_elems = 4 * 4 * xshape[0] * wshape[1]
            flops = 2 * 4 * 4 * xshape[0] * xshape[1] * wshape[1]

            def library():
                whole = torch.cat(xs)
                return [whole @ w for w in ws]
        elif name == "allgather_matmul_rhs":
            out_elems = 4 * xshape[0] * wshape[1]
            flops = 2 * 4 * xshape[0] * xshape[1] * wshape[1]

            def library():
                whole = torch.cat(ws)
                return [x @ whole for x in xs]
        else:
            m = xshape[0] // 4
            out_elems = 4 * m * wshape[1]
            flops = 2 * 4 * xshape[0] * xshape[1] * wshape[1]

            def library():
                parts = [x @ w for x, w in zip(xs, ws)]
                return [torch.stack([pt[d * m:(d + 1) * m] for pt in parts])
                        .sum(0) for d in range(4)]
        isz = xs[0].element_size()
        nbytes = isz * (4 * xs[0].numel() + 4 * ws[0].numel() + out_elems)
        bms, bby = bound(nbytes, flops,
                         BF16_FLOPS if dt == torch.bfloat16 else F32_FLOPS)
        row = {"ms": time_ms(lambda: kern(xs, ws)),
               "plain_ms": time_ms(lambda: plain(xs, ws)),
               "bound_ms": bms, "bound_by": bby,
               "library_ms": time_ms(library)}
        row["device_ms"] = device_ms(lambda: kern(xs, ws))
        row["host_us_per_launch"] = host_us_per_launch(lambda: kern(xs, ws),
                                                       16)
        shape = f"4 ranks x ({xshape} @ {wshape}) {dt} on one card"
        if name in lines and dt == torch.bfloat16:
            rows.append({
                "name": name, "route": "cuda",
                "source": "distributedarrays_tpu_torch/csrc/collectives.cu",
                "replaces": f"distributedarrays_tpu/ops/pallas_collectives.py:"
                            f"{lines[name]}",
                "shape": shape + " (the sequence-parallel FFN, s 8192, e "
                                 "1024, f 4096)", **row})
        else:
            extra[f"{name} {shape}"] = row
        del xs, ws
    torch.cuda.empty_cache()
    return rows


def ring_gemms_only() -> int:
    """``--ring-gemms``: build the collectives and check K13, K14 and K15
    against their plain versions, then time K13 and K15 (a quick kernel
    check on the card)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import distributedarrays_tpu_torch as tdat
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    t0 = time.perf_counter()
    tdat.kbuild.build(["collectives"])
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    for line in tdat.kbuild.build_log.get("collectives", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas collectives: {line.strip()}")
    tdat.init()
    dev = tdat.device_of(0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    errs = {k: 0.0 for k in tdat.kbuild.KERNELS}
    ring_gemm_kernels(randn, errs)
    extra = {}
    rows = ring_gemm_timings(randn, extra)
    print(json.dumps({"timings_extra": extra, "gpu": smi}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def host_ms(fn, reps: int = 10) -> float:
    """The host's ms a call of ``fn``, from an idle device (synchronized
    before each call, the call's own work not waited for): the median of
    ``reps`` after a warm-up call."""
    fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(out)


def device_ms(fn, reps: int = 5) -> float:
    """Device time per call of ``fn``: the durations of the CUDA kernels in
    a ``torch.profiler`` trace of ``reps`` calls (after one warm-up call),
    summed and divided by ``reps``.  The host's work between launches is
    not in it."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) \
        / 1e3 / reps


def print_ptxas(kbuild, stems) -> None:
    """The ptxas lines (each kernel, its registers and spills) of the
    sources just built."""
    for stem in stems:
        for line in kbuild.build_log.get(stem, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas {stem}: {line.strip()}")


def gpu_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def k1_k9_times(root: str | None = None) -> int:
    """``--time-k1-k9 [ROOT]``: time K1 (4096^3 f32 and bf16, 16384^3 f32)
    and K9 (the S = 8192 causal bf16 ring on 4 ranks: per call, and the
    device time of its launches alone) through the public wrappers of the
    package under ROOT (this checkout's by default), so two trees can be
    timed in turns in one call on one card."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if root:
        sys.path.insert(0, os.path.abspath(root))
    import distributedarrays_tpu_torch as tdat
    from distributedarrays_tpu_torch.models import ring_attention as RA
    from distributedarrays_tpu_torch.ops import cuda_gemm as CG
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = gpu_name()
    print(smi)
    tdat.kbuild.build(["gemm", "attention"])
    tdat.init()
    dev = tdat.device_of(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    times = {}
    a, b = (torch.randn(4096, 4096, generator=gen, device=dev)
            for _ in range(2))
    times["gemm 4096^3 f32"] = time_ms(lambda: CG.cuda_matmul(a, b))
    ab, bb = a.bfloat16(), b.bfloat16()
    times["gemm 4096^3 bf16"] = time_ms(lambda: CG.cuda_matmul(ab, bb))
    a, b = (torch.randn(16384, 16384, generator=gen, device=dev)
            for _ in range(2))
    times["gemm 16384^3 f32"] = time_ms(lambda: CG.cuda_matmul(a, b))
    del a, b, ab, bb
    blocks = [[torch.randn(2048, 16, 64, generator=gen, device=dev)
               .bfloat16() for _ in range(4)] for _ in range(3)]
    ring = lambda: RA.ring_attention_rdma(*blocks, True)
    times["ring_attention S=8192 bf16 causal"] = time_ms(ring)
    times["ring_attention S=8192 bf16 causal, device"] = device_ms(ring)
    print(json.dumps({"k1_k9_times": times, "package": tdat.__file__,
                      "gpu": smi}))
    return 0


def ring_gemm_times(root: str | None = None) -> int:
    """``--time-ring-gemms [ROOT]``: time K13, K14 and K15 through the
    public wrappers of the package under ROOT (this checkout's by default),
    4 ranks on one card: bf16 at the sequence-parallel shapes and f32 at
    K13's and K15's and at 16384^2 (4,1)x(4,1) for K14, each per call, in
    the device time of its launches alone and in host microseconds a
    launch.  Where the package has ``ring_tile_n``, the bf16 shapes again
    on each wgmma tile (a package whose K15 takes no tile reads the same
    twice), and K13's and K14's bf16 step device time against its depth.
    Two trees can so be timed in turns in one call on one card."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if root:
        sys.path.insert(0, os.path.abspath(root))
    import distributedarrays_tpu_torch as tdat
    from distributedarrays_tpu_torch.ops import cuda_collectives as CC
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = gpu_name()
    print(smi)
    tdat.kbuild.build(["collectives"])
    tdat.init()
    dev = tdat.device_of(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    k13, k15, k14 = RING_GEMM_SHAPES
    times = {}
    for (name, xshape, wshape), dt in ((k13, bf16), (k14, bf16), (k15, bf16),
                                       (k13, f32), (k15, f32),
                                       (("allgather_matmul_rhs",
                                         (4096, 16384), (4096, 16384)), f32)):
        kern = ring_gemm_fns(name)[0]
        xs = [(torch.randn(xshape, generator=gen, device=dev)).to(dt)
              for _ in range(4)]
        ws = [(torch.randn(wshape, generator=gen, device=dev) / 32).to(dt)
              for _ in range(4)]
        key = f"{name} 4 x {xshape} @ {wshape} {dt}"
        call = lambda: kern(xs, ws)
        times[key] = time_ms(call)
        times[key + ", device"] = device_ms(call)
        times[key + ", host us a launch"] = host_us_per_launch(call, 16)
        if dt == bf16 and hasattr(CC, "ring_tile_n"):
            for tile in RING_TILES:
                with forced_tile(CC, tile):
                    tk = f"{key}, 128 x {tile} tiles"
                    times[tk] = time_ms(call)
                    times[tk + ", device"] = device_ms(call)
        del xs, ws
        torch.cuda.empty_cache()
    if hasattr(CC, "ring_tile_n"):
        # a step's fixed cost against its depth: the bf16 steps on their
        # chosen tiles with one (64), 4, 16 and 32 stage loads of depth
        for name, (m, n), ks in (("allgather_matmul", (2048, 1024),
                                  (64, 256, 1024, 2048)),
                                 ("allgather_matmul_rhs", (1024, 1024),
                                  (64, 256, 1024, 2048))):
            kern = ring_gemm_fns(name)[0]
            for k in ks:
                if name == "allgather_matmul":
                    xs = [torch.randn(m, k, generator=gen, device=dev)
                          .to(bf16) for _ in range(4)]
                    ws = [torch.randn(k, n, generator=gen, device=dev)
                          .to(bf16) for _ in range(4)]
                else:
                    xs = [torch.randn(m, 4 * k, generator=gen, device=dev)
                          .to(bf16) for _ in range(4)]
                    ws = [torch.randn(k, n, generator=gen, device=dev)
                          .to(bf16) for _ in range(4)]
                times[f"{name} bf16 step ({m}, {n}) depth {k}, device us "
                      f"a launch"] = device_ms(lambda: kern(xs, ws)) * 1e3 / 16
                del xs, ws
    print(json.dumps({"ring_gemm_times": times, "package": tdat.__file__,
                      "gpu": smi}))
    return 0


def attn_times(root: str | None = None) -> int:
    """``--time-attn [ROOT]``: time K5, K6, K7 and K9 through the package
    under ROOT (this checkout's by default), so two trees can be timed in
    turns in one call on one card: K5 (forward) and K6/K7 (backward) at
    (2048, 64, 64) bf16 causal, K5 also on the serving forward's fused-QKV
    views, each per call and in the device time of its launches alone;
    the scaled_dot_product_attention forward and backward at the same
    shape; the K9 ring at S = 8192 on 4 ranks; ``forward`` on (4, 2048) and
    ``train_step`` on (4, 2049) tokens at ``Config(8192, 1024, 16, 8, 4,
    2048, bf16)`` (host clock around synchronized calls, median of 5).
    Prints the ptxas register and spill lines of the attention kernels
    first."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if root:
        sys.path.insert(0, os.path.abspath(root))
    import torch.nn.functional as F
    import distributedarrays_tpu_torch as tdat
    from distributedarrays_tpu_torch.models import ring_attention as RA
    from distributedarrays_tpu_torch.ops import cuda_attention as CA
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = gpu_name()
    print(smi)
    tdat.kbuild.build(["attention", "attention_bwd"])
    print_ptxas(tdat.kbuild, ("attention", "attention_bwd"))
    tdat.init()
    dev = tdat.device_of(0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    times = {}

    def both(key, fn):
        times[key] = time_ms(fn)
        times[key + ", device"] = device_ms(fn)

    S, H, D = 2048, 64, 64
    q, k, v, g = (randn(S, H, D) for _ in range(4))
    o, lse = CA.flash_attention_lse(q, k, v, True)
    dd = (g.float() * o.float()).sum(-1).t().contiguous()
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    both("K5 (2048, 64, 64) bf16 causal",
         lambda: CA.flash_attention_lse(q, k, v, True))
    both("K5 (2048, 64, 64) bf16 non-causal",
         lambda: CA.flash_attention_lse(q, k, v, False))
    both("K7 (2048, 64, 64) bf16 causal",
         lambda: CA._bwd_launch("flash_attention_bwd_dkv", q, k, v, g, lse,
                                dd, (dk, dv), 0, 0, True, None))
    both("K6 (2048, 64, 64) bf16 causal",
         lambda: CA._bwd_launch("flash_attention_bwd_dq", q, k, v, g, lse,
                                dd, (dq,), 0, 0, True, None))
    fq, fk, fv = fused_qkv(randn, 2048, 4, 16, 64, torch.bfloat16)
    both("K5 (2048, 4, 16, 64) bf16 causal, fused-QKV views",
         lambda: CA.flash_attention_lse(fq, fk, fv, True))
    qs, ks, vs = (x.transpose(0, 1)[None].detach().clone()
                  .requires_grad_(True) for x in (q, k, v))
    times["sdpa forward (2048, 64, 64) bf16 causal"] = time_ms(
        lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True))
    os_ = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    gs = g.transpose(0, 1)[None]
    times["sdpa backward (2048, 64, 64) bf16 causal"] = time_ms(
        lambda: torch.autograd.grad(os_, (qs, ks, vs), gs,
                                    retain_graph=True))
    del qs, ks, vs, os_, q, k, v, g, o, lse, dd, dq, dk, dv, fq, fk, fv
    blocks = [[randn(2048, 16, 64) for _ in range(4)] for _ in range(3)]
    both("K9 ring S=8192 bf16 causal, 4 ranks",
         lambda: RA.ring_attention_rdma(*blocks, True))
    del blocks
    T = tdat.transformer
    cfg = T.Config(*TRAIN_CFG, torch.bfloat16)
    model = T.init_params(cfg, torch.Generator(device=dev).manual_seed(3),
                          dev)
    tokens = torch.randint(0, cfg.vocab, (4, 2049), generator=gen,
                           device=dev, dtype=torch.int32)
    T.forward(model, tokens[:, :-1], cfg)
    times["forward (4, 2048) ms"] = statistics.median(
        wall_ms(lambda: T.forward(model, tokens[:, :-1], cfg))
        for _ in range(5))
    T.train_step(model, tokens, TRAIN_LR, cfg)
    times["train_step (4, 2049) ms"] = statistics.median(
        wall_ms(lambda: T.train_step(model, tokens, TRAIN_LR, cfg))
        for _ in range(5))
    print(json.dumps({"attn_times": times, "package": tdat.__file__,
                      "gpu": smi}))
    return 0


class forced_groups:
    """Within the block, K8's wgmma route takes ``groups`` consumer
    warpgroups a block whatever ``hop_groups`` would choose."""

    def __init__(self, CA, groups: int):
        self.CA, self.groups = CA, groups

    def __enter__(self):
        self.saved = self.CA.hop_groups
        self.CA.hop_groups = lambda rows, heads, sms: self.groups

    def __exit__(self, *exc):
        self.CA.hop_groups = self.saved


def k4_k8_times(root: str | None = None) -> int:
    """``--time-k4-k8 [ROOT]``: time K4 and K8 through the package under
    ROOT (this checkout's by default), so two trees can be timed in turns
    in one call on one card: K4 at 16384^3 and at one Cannon 2 x 2 step
    (8192^3), f32 out; K8's fully visible (16, 2048, 64) bf16 hop and a
    zigzag part's hop ((16, 1024, 64) row halves of (16, 2048, 64)
    blocks), each per call by CUDA events and in device time by
    ``torch.profiler``, K8 also with each consumer warpgroup count of its
    wgmma route where the package has ``hop_groups``; K5 at (2048, 64,
    64) bf16 causal, which runs K8's loop; the all-gather K10
    (16384^2 f32, 4 row blocks) and ``torch.cat`` per rank in three
    turns; and one full-width sequence-parallel SGD step (4 ranks, bf16)
    under the profiler, whose K8 device time is the sum of its ``flash_``
    kernels (the step launches no K5).  Prints the ptxas register and
    spill lines of the int8 and attention kernels first."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if root:
        sys.path.insert(0, os.path.abspath(root))
    from torch.profiler import ProfilerActivity, profile
    import distributedarrays_tpu_torch as tdat
    from distributedarrays_tpu_torch.ops import cuda_attention as CA
    from distributedarrays_tpu_torch.ops import cuda_collectives as CC
    from distributedarrays_tpu_torch.ops import cuda_gemm as CG
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = gpu_name()
    print(smi)
    stems = ("gemm_int8", "attention", "attention_bwd", "collectives")
    tdat.kbuild.build(stems)
    print_ptxas(tdat.kbuild, stems[:2])
    tdat.init()
    dev = tdat.device_of(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    times = {}

    def both(key, fn):
        times[key] = time_ms(fn)
        times[key + ", device"] = device_ms(fn)

    for n, what in ((16384, "16384^3"), (8192, "8192^3 (one Cannon step)")):
        qa, qb = (torch.randint(-127, 128, (n, n), generator=gen, device=dev,
                                dtype=torch.int32).to(torch.int8)
                  for _ in range(2))
        sa, sb = (torch.rand(n, generator=gen, device=dev) / 127
                  for _ in range(2))
        both(f"K4 {what} int8 -> f32",
             lambda: CG.cuda_matmul_int8(qa, qb, sa, sb))
        del qa, qb
    torch.cuda.empty_cache()
    H, B, D = 16, 2048, 64
    q, k, v, k0, v0 = (torch.randn(H, B, D, generator=gen, device=dev)
                       .bfloat16() for _ in range(5))
    carry = CA.flash_attention_hop_plain(
        q, k0, v0, *CA.flash_carry_init(H, B, D, dev), 4096, 2048, True)
    live = [x.clone() for x in carry]
    part = lambda x, i: x[:, i * (B // 2):(i + 1) * (B // 2)]
    zlive = [part(x, 1).contiguous() for x in carry]
    hops = {"K8 (16, 2048, 64) bf16 visible hop": lambda: (
                CA.flash_attention_hop(q, k, v, *live, 4096, 0, True)),
            "K8 zigzag part (16, 1024, 64) of (16, 2048, 64) blocks, bf16 "
            "visible hop": lambda: CA.flash_attention_hop(
                part(q, 1), part(k, 0), part(v, 0), *zlive, 6144, 1024,
                True)}
    for key, fn in hops.items():
        both(key, fn)
        if hasattr(CA, "hop_groups"):
            for g in (1, 2):
                with forced_groups(CA, g):
                    both(f"{key}, {g} consumer warpgroups a block", fn)
    del q, k, v, k0, v0, carry, live, zlive
    # K5 shares K8's loop (without the carry): it must read as in the
    # parent
    q, k, v = (torch.randn(2048, 64, 64, generator=gen, device=dev)
               .bfloat16() for _ in range(3))
    both("K5 (2048, 64, 64) bf16 causal",
         lambda: CA.flash_attention_lse(q, k, v, True))
    del q, k, v
    blocks = [torch.randn(4096, 16384, generator=gen, device=dev)
              for _ in range(4)]
    for turn in range(3):
        times[f"K10 all-gather 16384^2 f32, 4 ranks, turn {turn}"] = \
            time_ms(lambda: CC.ring_all_gather(blocks, 0))
        times[f"torch.cat per rank, turn {turn}"] = time_ms(
            lambda: [torch.cat(blocks) for _ in blocks])
    del blocks
    torch.cuda.empty_cache()
    SP = tdat.sp_transformer
    tdat.init(nranks=4)
    cfg = SP.SPConfig(*SP_CFG, torch.bfloat16)
    shards = SP.shard_params(SP.init_params(cfg, gen, dev), [0, 1, 2, 3])
    tokens = torch.randint(0, cfg.vocab, (1, SP_CFG[5]), generator=gen,
                           device=dev, dtype=torch.int32)
    step = SP.make_train_step([0, 1, 2, 3], cfg)
    sp_step = lambda: step(shards, tokens, SP_LR)
    sp_step()
    times["sequence-parallel SGD step ms"] = statistics.median(
        wall_ms(sp_step) for _ in range(3))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sp_step()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    times["sequence-parallel SGD step, device busy ms"] = sum(
        e.self_device_time_total for e in kern) / 1e3
    times["sequence-parallel SGD step, K8 device ms"] = sum(
        e.self_device_time_total for e in kern if "flash_" in e.key) / 1e3
    print(json.dumps({"k4_k8_times": times, "package": tdat.__file__,
                      "gpu": smi}))
    return 0


def k1_k9_only() -> int:
    """``--k1-k9``: build the GEMM and attention kernels, check K1 on each
    route and K9 against their plain versions, and time both (a quick
    check on the card)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import distributedarrays_tpu_torch as tdat
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = gpu_name()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    tdat.kbuild.build(["gemm", "attention"])
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    print_ptxas(tdat.kbuild, ("gemm", "attention"))
    tdat.init()
    dev = tdat.device_of(0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    errs = {k: 0.0 for k in tdat.kbuild.KERNELS}
    failed = []
    for phase in (gemm_kernels, ring_kernels):
        try:
            phase(randn, errs)
        except AssertionError as e:   # report every phase, fail below
            print(f"FAILED {phase.__name__}: {e}")
            failed.append(phase.__name__)
    k1_k9_times()
    if failed:
        print(f"chip_smoke --k1-k9: failed {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def bf16_ulps(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """|x - ref| in units of the bf16 spacing at the larger of |x| and
    |ref| (2^(e - 8) for a value in [2^(e - 1), 2^e))."""
    x, ref = x.float(), ref.float()
    e = torch.maximum(torch.frexp(x).exponent, torch.frexp(ref).exponent)
    return (x - ref).abs() / torch.ldexp(torch.ones_like(x), e - 8)


# K4 against its plain version on each route: (m, k, n) and the route
# int8_gemm_route must pick.  16384^3 is the one-rank product of the
# distributed phase; 1000 x 784 x 1500 is ragged in m, n and in k against
# the 128-byte stage (784 = 6 * 128 + 16: the last stage's TMA box is
# mostly zero-filled); 100 x 48 x 40 is smaller than one tile and one
# stage; k = 777 is no multiple of 16, which TMA cannot stride.
INT8_CASES = (((16384, 16384, 16384), "wgmma"),
              ((1000, 784, 1500), "wgmma"),
              ((100, 48, 40), "wgmma"),
              ((1000, 777, 1500), "mma"))


def int8_kernels(gen, dev, errs) -> None:
    """K4 on each route (``INT8_CASES``) against its plain version, bit for
    bit (exact int32 sums, the same two f32 multiplies, one rounding to the
    output type), f32 and bf16 out; each call must move its route's count
    by one and no other."""
    from distributedarrays_tpu_torch.ops import cuda_gemm as CG
    for (m, k, n), route in INT8_CASES:
        qa = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.int8)
        qb = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.int8)
        sa = torch.rand(m, generator=gen, device=dev) / 127
        sb = torch.rand(n, generator=gen, device=dev) / 127
        if CG.int8_gemm_route(qa, qb) != route:
            raise AssertionError(f"int8 gemm {m}x{k}x{n}: int8_gemm_route "
                                 f"picks another route than {route}")
        for od in (torch.float32, torch.bfloat16):
            got = on_route("matmul_int8", route, lambda: CG.cuda_matmul_int8(
                qa, qb, sa, sb, od))
            errs["matmul_int8"] = max(errs["matmul_int8"], exact(
                f"int8 gemm {m}x{k}x{n} -> {od} ({route})", got,
                CG.matmul_int8_plain(qa, qb, sa, sb, od)))
        del qa, qb, got
    torch.cuda.empty_cache()


def gemm_kernels(randn, errs) -> None:
    """K1 on each route against its plain version: bf16 on wgmma + TMA at
    4096^3 (f32 output through the C entry at TOL_F32, since bf16 products
    are exact in f32 and only the summation order differs; bf16 output
    within one bf16 ulp of the plain product rounded once, in at most
    GEMM_BF16_FLIPS of the elements), at a ragged TMA-eligible shape and
    at one smaller than a TMA box (100 x 24 @ 24 x 40);
    bf16 on mma.sync at a shape TMA cannot read; f32 on the pipelined SIMT
    loop at 4096^3 and ragged.  Each call must move its route's count and
    no other."""
    from distributedarrays_tpu_torch.ops import cuda_gemm as CG
    from distributedarrays_tpu_torch.utils import kbuild
    bf16, f32 = torch.bfloat16, torch.float32
    for (m, k, n), dt, route in (((4096, 4096, 4096), bf16, "wgmma"),
                                 ((1000, 776, 1496), bf16, "wgmma"),
                                 ((100, 24, 40), bf16, "wgmma"),
                                 ((1000, 777, 1500), bf16, "mma"),
                                 ((4096, 4096, 4096), f32, "f32"),
                                 ((1000, 777, 1500), f32, "f32")):
        a, b = randn(m, k, dtype=dt), randn(k, n, dtype=dt)
        what = f"gemm {m}x{k}x{n} {dt} ({route})"
        if CG.gemm_route(dt, n, k, a.data_ptr(), b.data_ptr()) != route:
            raise AssertionError(f"{what}: gemm_route picks another route")
        ref = CG.matmul_plain(a.float(), b.float())
        before = kbuild.route_counts()["gemm"]
        got = CG.cuda_matmul(a, b)
        torch.cuda.synchronize()
        moved = {r: c - before[r]
                 for r, c in kbuild.route_counts()["gemm"].items()}
        if moved != {r: int(r == route) for r in moved}:
            raise AssertionError(f"{what}: route counts moved {moved}")
        if dt == f32:
            check(what, rel_err(got, ref), TOL_F32)
            errs["gemm"] = max(errs["gemm"], max_abs(got, ref))
            continue
        # f32 output straight from the C entry, on the same route
        c = torch.empty(m, n, device=a.device)
        rc = CG._gemm_fn()(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
                           kbuild.ROUTES.index(route), 0, a.device.index,
                           torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if rc != 0:
            raise AssertionError(f"{what} -> f32: CUDA error {rc}")
        check(what + " -> f32", rel_err(c, ref), TOL_F32)
        errs["gemm"] = max(errs["gemm"], max_abs(c, ref))
        # bf16 output: the same sums rounded once, so bit for bit the f32
        # output rounded ...
        exact(what + " -> bf16 against its f32 output rounded", got,
              c.to(bf16))
        # ... and within one bf16 ulp of the plain product rounded once,
        # wherever one bf16 spacing exceeds what the sums' order can move an
        # element (TOL_F32 of the result's rms)
        refb = ref.to(bf16)
        ulps = bf16_ulps(got, refb)
        spacing = torch.ldexp(torch.ones_like(ref),
                              torch.frexp(ref).exponent - 8)
        near0 = spacing < TOL_F32 * ref.norm() / ref.numel() ** 0.5
        far = ulps[~near0]
        flips = float((ulps > 0).float().mean())
        print(f"  {what} -> bf16 against the plain product rounded: max "
              f"{float(far.max())} ulp away from zero ({int(near0.sum())} "
              f"elements within the order error of zero), {flips:.3e} of "
              f"the elements differ (bound 1 ulp in at most "
              f"{GEMM_BF16_FLIPS:g})")
        if not (float(far.max()) <= 1.0 and flips <= GEMM_BF16_FLIPS):
            raise AssertionError(f"{what}: bf16 output off the plain product")
        del c
    del a, b, got, ref
    torch.cuda.empty_cache()


def ring_kernels(randn, errs) -> None:
    """K9 against the plain ring: S = 8192, 16 heads of 64, four ranks on
    the card, bf16 causal (16 launches, 10 of them accumulating, all on the
    wgmma route) and not, f32 causal, a ragged bf16 ring (4 x 1000 rows),
    bf16 rings at head dims 128 (two TMA boxes a tile) and 32 (half a box)
    and a bf16 ring on the mma.sync route (head dim 36, which TMA cannot
    stride).  A control, the plain ring with p rounded to bf16, must
    exceed the bf16 tolerance."""
    from distributedarrays_tpu_torch.models import ring_attention as RA
    from distributedarrays_tpu_torch.utils import kbuild
    bf16, f32 = torch.bfloat16, torch.float32
    for (b, h, dh), dt, causal, tol, route in (
            ((2048, 16, 64), bf16, True, TOL_RING_BF16, "wgmma"),
            ((2048, 16, 64), bf16, False, TOL_RING_BF16, "wgmma"),
            ((2048, 16, 64), f32, True, TOL_F32, "f32"),
            ((1000, 16, 64), bf16, True, TOL_RING_BF16, "wgmma"),
            ((512, 4, 128), bf16, True, TOL_RING_BF16, "wgmma"),
            ((512, 4, 32), bf16, False, TOL_RING_BF16, "wgmma"),
            ((512, 4, 36), bf16, True, TOL_RING_BF16, "mma")):
        blocks = [[randn(b, h, dh, dtype=dt) for _ in range(4)]
                  for _ in range(3)]
        launches = kbuild.launch_counts()["ring_attention"]
        routes = kbuild.route_counts()["ring_attention"]
        got = RA.ring_attention_rdma(*blocks, causal)
        torch.cuda.synchronize()
        n = kbuild.launch_counts()["ring_attention"] - launches
        moved = {r: c - routes[r]
                 for r, c in kbuild.route_counts()["ring_attention"].items()}
        steps = 10 if causal else 16
        print(f"  ring {b}x{h}x{dh} {dt} causal={causal}: {n} launches, "
              f"compute steps by route {moved}")
        if n != 16 or moved != {r: steps * (r == route) for r in moved}:
            raise AssertionError(f"ring attention: {n} launches and compute "
                                 f"steps {moved}, expected 16 and {steps} on "
                                 f"{route}")
        ref = RA.ring_attention_kernel(*blocks, causal)
        torch.cuda.synchronize()
        check(f"ring attention {4 * b} rows, {h}x{dh} {dt} causal={causal}",
              max(rel_err(g, r) for g, r in zip(got, ref)), tol)
        errs["ring_attention"] = max(errs["ring_attention"], max(
            max_abs(g, r) for g, r in zip(got, ref)))
        if dt == bf16 and b == 2048:
            # the lower-precision control: the same ring with p rounded to
            # bf16 must fail K9's tolerance, or the check cannot tell them
            ctl = max(rel_err(g, r) for g, r in zip(
                ring_bf16_p_plain(*blocks, causal), ref))
            print(f"  control, ring with p rounded to bf16: rel_err="
                  f"{ctl:.3e} (must exceed {TOL_RING_BF16:g})")
            if not ctl > TOL_RING_BF16:
                raise AssertionError("K9's bf16 tolerance does not separate "
                                     "a ring that rounds p to bf16")
    del blocks, got, ref
    torch.cuda.empty_cache()


def on_route(kernel: str, route: str, fn, launches: int = 1):
    """``fn()``, requiring that it launched ``kernel`` ``launches`` times,
    all on ``route`` (``kbuild.route_counts()``)."""
    from distributedarrays_tpu_torch.utils import kbuild
    before = kbuild.route_counts()[kernel]
    out = fn()
    moved = {r: c - before[r]
             for r, c in kbuild.route_counts()[kernel].items()}
    if moved != {r: launches * (r == route) for r in moved}:
        raise AssertionError(f"{kernel}: launches by route {moved}, expected "
                             f"{launches} on {route}")
    return out


def expect_routes(what: str, kernel: str, want: dict) -> None:
    """Require the route counts of ``kernel`` since the last reset."""
    from distributedarrays_tpu_torch.utils import kbuild
    got = kbuild.route_counts()[kernel]
    print(f"  {what}: {kernel} routes {got}")
    if got != {r: want.get(r, 0) for r in got}:
        raise AssertionError(f"{what}: {kernel} routes {got}, expected "
                             f"{want}")


# K5 against its plain version on each route: (S, B, H, D) (B = 0: (S, H,
# D) tensors; else the transformer's fused-QKV views), dtype, causal, the
# route flash_attention_route must pick
K5_CASES = (
    ((2048, 0, 64, 64), torch.bfloat16, True, "wgmma"),
    ((2048, 0, 64, 64), torch.bfloat16, False, "wgmma"),
    ((2048, 4, 16, 64), torch.bfloat16, True, "wgmma"),   # serving's views
    ((1024, 0, 16, 128), torch.bfloat16, True, "wgmma"),
    ((1000, 0, 16, 64), torch.bfloat16, True, "wgmma"),   # ragged S
    # head dims narrower than TMA's 64-wide box (zero-filled past dh), and
    # one that reads the second box of DMAX 128 in part
    ((1024, 0, 16, 8), torch.bfloat16, True, "wgmma"),
    ((1024, 0, 16, 32), torch.bfloat16, False, "wgmma"),
    ((1000, 0, 16, 96), torch.bfloat16, True, "wgmma"),
    ((1000, 0, 16, 36), torch.bfloat16, True, "mma"),     # d TMA cannot read
    ((2048, 0, 64, 64), torch.float32, True, "f32"),
    ((1000, 0, 16, 64), torch.float32, False, "f32"))


def fused_qkv(randn, S: int, B: int, H: int, D: int, dtype):
    """q, k, v as the transformer's forward takes them: (S, B, H, D) views
    of one (B, S, 3 H D) product."""
    E = H * D
    qkv = randn(B, S, 3 * E, dtype=dtype)
    return tuple(t.view(B, S, H, D).transpose(0, 1)
                 for t in qkv.split(E, dim=-1))


def hop_check(CA, what, q, k, v, c0, qoff, koff, route, masked,
              errs) -> None:
    """One K8 hop of q against k, v from the live carry c0, on ``route``,
    against the plain hop: in bf16 acc and l at TOL_BF16 (p rounded to bf16
    against each key tile's running max, the plain version against the
    whole block's), in f32 at TOL_F32; m at TOL_F32 (the products summed
    in f32 in another order); a fully masked hop must hand the carry back
    bit for bit."""
    got = [x.clone() for x in c0]
    on_route("flash_attention_hop", route, lambda: CA.flash_attention_hop(
        q, k, v, *got, qoff, koff, True))
    ref = CA.flash_attention_hop_plain(q, k, v, *c0, qoff, koff, True)
    torch.cuda.synchronize()
    if masked:
        exact(what + ": copy-through of m, l, acc", got, list(c0))
        return
    tol = TOL_F32 if q.dtype == torch.float32 else TOL_BF16
    check(what + ": acc", rel_err(got[2], ref[2]), tol)
    check(what + ": l", rel_err(got[1], ref[1]), tol)
    check(what + ": m", rel_err(got[0], ref[0]), TOL_F32)
    errs["flash_attention_hop"] = max(errs["flash_attention_hop"],
                                      max_abs(got[2], ref[2]))


def attention_kernels(randn, errs) -> None:
    """Phase 6a: K5, K8 and K9 against their plain versions at the serving
    and sequence-parallel paths' shapes, each K5 call on its route."""
    from distributedarrays_tpu_torch.ops import cuda_attention as CA
    bf16 = torch.bfloat16
    print("phase attention kernels")
    for (S, B, H, D), dt, causal, route in K5_CASES:
        if B:
            q, k, v = fused_qkv(randn, S, B, H, D, dt)
        else:
            q, k, v = (randn(S, H, D, dtype=dt) for _ in range(3))
        o, lse = on_route("flash_attention", route,
                          lambda: CA.flash_attention_lse(q, k, v, causal))
        po, plse = CA.flash_attention_lse_plain(q, k, v, causal)
        torch.cuda.synchronize()
        shape = (S, B, H, D) if B else (S, H, D)
        what = f"flash attention {shape} {dt} causal={causal} ({route})"
        check(what, rel_err(o.reshape(S, -1, D), po),
              TOL_F32 if dt == torch.float32 else TOL_BF16)
        check(what + " lse", rel_err(lse, plse), TOL_F32)
        errs["flash_attention"] = max(errs["flash_attention"],
                                      max_abs(o.reshape(S, -1, D), po))
    # one hop on rank 2 of 4 (qoff 2 B) from a live carry (the keys at B):
    # visible, diagonal, fully masked; on the wgmma route at head dims 64
    # and 128, on mma.sync at head dim 36 (which TMA cannot stride), and in
    # f32 on the SIMT loop
    for (H, B, D), dt, route in (((16, 2048, 64), bf16, "wgmma"),
                                 ((16, 1024, 128), bf16, "wgmma"),
                                 ((16, 1000, 36), bf16, "mma"),
                                 ((16, 1024, 64), torch.float32, "f32")):
        q, k, v, k0, v0 = (randn(H, B, D, dtype=dt) for _ in range(5))
        c0 = CA.flash_attention_hop_plain(
            q, k0, v0, *CA.flash_carry_init(H, B, D, q.device), 2 * B, B,
            True)
        for case, koff in (("visible", 0), ("diagonal", 2 * B),
                           ("masked", 3 * B)):
            hop_check(CA, f"flash hop {(H, B, D)} {dt} {case} ({route})", q,
                      k, v, c0, 2 * B, koff, route, case == "masked", errs)
    # a zigzag part: the second row half of rank 1's (16, 2048, 64) blocks
    # (global rows 6 * 1024.., as zigzag_order puts chunk 2p - 1 - r there)
    # against the first half of a block, with its own live carry; strided
    # row parts of (h, b, d) blocks, as models/ring_attention.py hands them
    # to K8
    H, B, D = 16, 2048, 64
    q, k, v, k0, v0 = (randn(H, B, D, dtype=bf16) for _ in range(5))
    part = lambda x, i: x[:, i * (B // 2):(i + 1) * (B // 2)]
    c0 = CA.flash_attention_hop_plain(
        part(q, 1), part(k0, 1), part(v0, 1),
        *CA.flash_carry_init(H, B // 2, D, q.device), 6144, 6144, True)
    for case, koff in (("visible", 1024), ("diagonal", 6144),
                       ("masked", 7168)):
        hop_check(CA, f"flash hop zigzag part (16, 1024, 64) of (16, 2048, "
                  f"64) blocks, bf16 {case} (wgmma)", part(q, 1), part(k, 0),
                  part(v, 0), c0, 6144, koff, "wgmma", case == "masked",
                  errs)
    # the whole K9 ring: S = 8192, 16 heads of 64, 4 ranks on the card
    ring_kernels(randn, errs)
    del q, k, v, o, po, c0
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
    if counts["flash_attention_bwd_dq"] or counts["flash_attention_bwd_dkv"]:
        raise AssertionError("serving launched the attention backward")
    expect_routes("forward", "flash_attention", {"wgmma": cfg.layers})
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


def event_ms(fn):
    """``(result, ms)``: one call of ``fn`` timed by CUDA events."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0.record()
    r = fn()
    t1.record()
    t1.synchronize()
    return r, t0.elapsed_time(t1)


# the reference surface phase's sizes: one rank's square, the
# reshard_uneven/reshard_mutate DVector of bench.py, the samedist square
SURFACE_N, SURFACE_NV, SURFACE_N16 = 8192, 4096 * 2048 + 37, 16384


def colnorm(c: torch.Tensor) -> torch.Tensor:
    return (c - c.mean()) / c.std()


def reference_surface(tdat, cuda_collectives) -> dict:
    """The reference's DArray surface on the card: whole-array ``==``,
    ``fill_``/``rand_``, the scans, the reductions, ``mapslices`` and
    ``djit`` on one rank at 8192^2 f32; then on 4 ranks on the one card
    ``bench.py``'s reshard_uneven and reshard_mutate shapes (``fill_``,
    ``copyto_`` and a region write that must touch only its owner rank),
    ``samedist`` (4,1) -> (1,4) at 16384^2 (one K11 launch, bit-exact
    against the plain all-to-all), ``mapslices`` over the split dim of a
    (1,4) DArray (which must launch K11) and ``dcumsum`` of a (4,1)
    16384^2 DArray against the one-rank result.  Prints each call's ms
    by CUDA events, after a first call that warms it up (kernel loading,
    allocator); returns the K11 launches of the 4-rank samedist."""
    from distributedarrays_tpu_torch.utils import kbuild
    print("phase reference surface (1 rank 8192^2 f32, then 4 ranks on one "
          "card)")
    t_phase = time.perf_counter()
    tdat.init()
    ms = {}

    def timed(name, fn, reset=False):
        fn()
        if reset:
            torch.cuda.synchronize()
            kbuild.reset_launches()
        r, ms[name] = event_ms(fn)
        print(f"  {name}: {ms[name]:.3f} ms")
        return r

    n = SURFACE_N
    X = tdat.drand((n, n))
    Xc = timed("copy", X.copy)
    if timed("== (True)", lambda: X == Xc) is not True:
        raise AssertionError("X == X.copy() is not True")
    with tdat.allowscalar(True):
        X[17, n // 2 - 95] = 2.0
    if timed("== (False)", lambda: X == Xc) is not False:
        raise AssertionError("== missed a changed element")
    del Xc
    timed("fill_", lambda: X.fill_(3.0))
    if not bool((X.part((0, 0)) == 3.0).all()):
        raise AssertionError("fill_(3.0) left other values")
    timed("rand_", X.rand_)
    Xt = X.full()
    if not (0.0 <= float(Xt.min()) and float(Xt.max()) < 1.0
            and abs(float(Xt.mean()) - 0.5) < 1e-2):
        raise AssertionError("rand_ is not uniform [0, 1)")
    for ax in (0, 1):
        C = timed(f"dcumsum axis {ax}", lambda: tdat.dcumsum(X, ax))
        check(f"dcumsum axis {ax} against float64",
              rel_err(C.full(), torch.cumsum(Xt.double(), ax)), TOL_STATS)
        C = timed(f"dcummax axis {ax}", lambda: tdat.dcummax(X, ax))
        exact(f"dcummax axis {ax}", C.full(), torch.cummax(Xt, ax).values)
        del C
    lo, hi = timed("dextrema", lambda: tdat.dextrema(X))
    exact("dextrema", [lo, hi], [Xt.min(), Xt.max()])
    cnt = timed("dcount", lambda: tdat.dcount(lambda t: t > 0.5, X))
    exact("dcount", cnt, (Xt > 0.5).sum().to(torch.int32))
    if not (bool(timed("dall", lambda: tdat.dall(X >= 0.0)))
            and not bool(timed("dany", lambda: tdat.dany(X > 1.0)))):
        raise AssertionError("dall / dany")
    M = timed("mapslices column normalisation",
              lambda: tdat.mapslices(colnorm, X, 0))
    check("mapslices column normalisation", rel_err(
        M.full(), (Xt - Xt.mean(0)) / Xt.std(0)), TOL_STATS)
    del M
    Y, Z = tdat.drand((n, n)), tdat.drand((n, n))
    fused = tdat.djit(lambda a, b, c: torch.sin(a) + b * c)
    R = timed("djit sin(A) + B*C", lambda: fused(X, Y, Z))
    exact("djit against dmap(sin) + Y*Z", R.full(),
          (tdat.dmap(torch.sin, X) + Y * Z).full())
    tdat.d_closeall()
    del X, Y, Z, R, Xt
    torch.cuda.empty_cache()

    tdat.init(nranks=4)
    N = SURFACE_NV
    d = tdat.distribute(np.zeros(N, np.float32), dist=[4])
    timed("fill_ 4 ranks uneven", lambda: d.fill_(3.0))
    if not all(bool((d.part((k,)) == 3.0).all()) for k in range(4)):
        raise AssertionError("fill_ on 4 ranks")
    host = np.ones(N, np.float32)
    timed("copyto_ from host 4 ranks uneven",
          lambda: tdat.copyto_(d, host))
    if not all(bool((d.part((k,)) == 1.0).all()) for k in range(4)):
        raise AssertionError("copyto_ from host on 4 ranks")
    lo = N // 8
    before = [(d.part((k,)).data_ptr(), d.part((k,)).clone())
              for k in range(4)]
    v = np.full(4096, 5.0, np.float32)
    timed("d[lo:lo+4096] = v 4 ranks uneven",
          lambda: d.__setitem__(slice(lo, lo + 4096), v))
    owners = [k for k in range(4)
              if d.cuts[0][k] < lo + 4096 and d.cuts[0][k + 1] > lo]
    for k in range(4):
        t = d.part((k,))
        if t.data_ptr() != before[k][0]:
            raise AssertionError(f"region write replaced rank {k}'s tensor")
        if k not in owners and not torch.equal(t, before[k][1]):
            raise AssertionError(f"region write touched rank {k}")
    want = torch.ones(N, device=d.home())
    want[lo:lo + 4096] = 5.0
    exact("region write against the plain write", d.full(), want)
    print(f"  region write owners {owners} of 4 ranks")
    tdat.d_closeall()
    del d, want, before

    n16 = SURFACE_N16
    A = tdat.drandn((n16, n16), dist=(4, 1))
    like = tdat.dzeros((n16, n16), dist=(1, 4))
    S = timed("samedist (4,1) -> (1,4) 16384^2",
              lambda: tdat.samedist(A, like), reset=True)
    torch.cuda.synchronize()
    k11 = kbuild.launch_counts()["all_to_all"]
    if k11 != 1:
        raise AssertionError(f"samedist launched K11 {k11} times, not once")
    plain = cuda_collectives.all_to_all_plain(
        [A.part((k, 0)) for k in range(4)], 1, 0)
    exact("samedist against all_to_all_plain",
          [S.part((0, k)) for k in range(4)], plain)
    del like, S, plain
    A1 = tdat.distribute(A.full(), procs=[0], dist=(1, 1))
    R4 = timed("dcumsum axis 0 (4,1) 16384^2", lambda: tdat.dcumsum(A, 0))
    tdat.close(A)
    del A
    R1 = tdat.dcumsum(A1, 0)
    check("dcumsum (4,1) against one rank", rel_err(R4.full(), R1.full()),
          TOL_STATS)
    tdat.d_closeall()
    del A1, R4, R1
    torch.cuda.empty_cache()
    B = tdat.drand((n, n), dist=(1, 4))
    M = timed("mapslices over dim 1 of (1,4) 8192^2",
              lambda: tdat.mapslices(colnorm, B, 1), reset=True)
    torch.cuda.synchronize()
    if kbuild.launch_counts()["all_to_all"] < 1:
        raise AssertionError("mapslices over the split dim did not launch "
                             "K11")
    Bt = B.full()
    check("mapslices (1,4) dim 1", rel_err(
        M.full(), (Bt - Bt.mean(1, keepdim=True)) / Bt.std(1, keepdim=True)),
        TOL_STATS)
    tdat.d_closeall()
    del B, M, Bt
    torch.cuda.empty_cache()
    tdat.init()
    print(f"  reference surface {time.perf_counter() - t_phase:.1f} s")
    print(json.dumps({"reference_surface_ms": ms}))
    return {"all_to_all": k11}


# the reshard chain and SPMD phase: 16384^2 f32 moves on 4 ranks, the
# ceil-uneven rows of the padded chain, the Life grid, and the allocator's
# rounding allowed above a move's planned peak
RESHARD_N, RESHARD_ROWS_PADDED = 16384, 16383
LIFE_N, LIFE_ITERS = 16384, 8
PEAK_SLACK = 64 << 20


def chain_step_io(plan) -> list[tuple[str, int, int]]:
    """``(kind, input bytes, output bytes)`` over all ranks for each
    non-slice step of a chain plan, from the plan's local shapes (the
    evolution ``reshard._chain_steps`` plans with)."""
    work = plan.pad_shape or plan.shape
    sizes, nr = plan.mesh_shape, len(plan.ranks)
    local = [n // int(np.prod([sizes[m] for m in comp] or [1]))
             for n, comp in zip(work, plan.src_comp)]
    out = []
    for kind, m, q, i, j, *_ in plan.steps:
        lin = int(np.prod(local)) * plan.itemsize * nr
        if kind == "a2a":
            local[i] *= q
            local[j] //= q
        elif kind == "gather":
            local[i] *= q
        else:
            local[j] //= q
        if kind != "slice":
            out.append((kind, lin,
                        int(np.prod(local)) * plan.itemsize * nr))
    return out


def plain_life(g: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` Life generations of the whole grid on one device, plain
    torch: the eight neighbours of the zero-padded grid summed in its
    dtype, born on 3, surviving on 2 or 3."""
    for _ in range(iters):
        xp = torch.nn.functional.pad(g, (1, 1, 1, 1))
        n = (xp[:-2, :-2] + xp[:-2, 1:-1] + xp[:-2, 2:] + xp[1:-1, :-2] +
             xp[1:-1, 2:] + xp[2:, :-2] + xp[2:, 1:-1] + xp[2:, 2:])
        a = xp[1:-1, 1:-1]
        g = (((a == 0) & (n == 3)) |
             ((a == 1) & ((n == 2) | (n == 3)))).to(g.dtype)
    return g


def reshard_spmd(tdat) -> dict:
    """The multi-axis reshard and SPMD mode with four ranks on the card.

    Moves, each planned as the JAX planner plans it: (4,1) -> (2,2) at
    16384^2 f32 (``chain``, one a2a); the mesh-axis transpose P(d0,d1) ->
    P(d1,d0) of a (2,2) 16384^2 f32 DArray (gather, a2a, slice); the
    padded chain (4,1) -> (2,2) of 16383 x 16384 f32 on ceil cuts
    (``pad_shape`` (16384, 16384), one a2a); the multi-axis ``allgather``
    of a (2,2) 16384^2 f32 DArray onto its 4 ranks (gather, gather) and
    ``gather_put`` onto ranks 0 and 1.  Each: the plan, values bit for bit
    against the plain region-by-region relayout (``d.full()`` per rank for
    the gathers), one ``copy_kernel`` launch per card for each non-slice
    step (counts set to 0 before the call, read after), ms per call by
    CUDA events beside the plain relayout's and the bound (every rank's
    input read once and output written once a non-slice step, the plan's
    local shapes, over the HBM rate), and the peak memory during the move
    against the source shards plus the largest input-plus-output of any
    step (``PEAK_SLACK`` for the allocator's rounding).  Then ``spmd`` on
    4 thread tasks (a ring of each rank's CUDA ``localpart``, barrier,
    bcast, scatter, gather_spmd, and each task's own work on its device)
    and Life: ``life2d`` on a (2,2) 16384^2 uint8 grid and ``life`` on
    (4,1), 8 generations each, against ``plain_life`` of the whole grid on
    one device.  Returns the launches of the moves."""
    from distributedarrays_tpu_torch.darray import resolve_layout
    from distributedarrays_tpu_torch.ops import cuda_collectives as CC
    from distributedarrays_tpu_torch.parallel import reshard as TR
    from distributedarrays_tpu_torch.utils import kbuild
    print("phase reshard chain and SPMD (4 ranks on one card, 16384^2 f32)")
    t_phase = time.perf_counter()
    tdat.init(nranks=4)
    dev = tdat.device_of(0)
    ncards = len({tdat.device_of(r) for r in range(4)})
    n = RESHARD_N
    launches = {"all_gather": 0, "all_to_all": 0}
    rows = []
    # the bytes the copy launches read (each source box once a launch) and
    # write (each destination box), counted around the module's launcher
    copied = []
    on_card = CC._copy_on_card

    def counting(copies, dev_, kernel):
        for launch in CC.copy_launches(copies):
            for _, (sizes, _, run_b), part in launch:
                copied.append(int(np.prod(sizes)) * run_b * (1 + len(part)))
        on_card(copies, dev_, kernel)

    CC._copy_on_card = counting

    def ceil_cuts(m, g):
        c = -(-m // g)
        return [min(k * c, m) for k in range(g + 1)]

    def move(name, src, plan, run, plain, want):
        """Drive one planned move: warm-up, then counts, peak and values
        of one call, then its time and the plain version's."""
        steps = [s[0] for s in plan.steps]
        print(f"  {name}: strategy {plan.strategy} steps {steps} mesh "
              f"{plan.mesh_shape} moved_bytes {plan.moved_bytes} "
              f"staging_bytes {plan.staging_bytes} pad_shape "
              f"{plan.pad_shape}")
        if (plan.strategy, steps) != want:
            raise AssertionError(f"{name}: planned {plan.strategy} {steps}, "
                                 f"not {want}")
        run()                                # warm-up: loads the kernel
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        kbuild.reset_launches()
        copied.clear()
        got = run()
        torch.cuda.synchronize()
        counts = kbuild.launch_counts()
        moved = sum(copied)
        peak = torch.cuda.max_memory_allocated(dev) - before
        io = chain_step_io(plan)
        want_counts = {"all_to_all": ncards * steps.count("a2a"),
                       "all_gather": ncards * steps.count("gather")}
        have = {k: counts[k] for k in want_counts}
        if have != want_counts:
            raise AssertionError(f"{name}: copy_kernel launches {have}, "
                                 f"not {want_counts}")
        for k in launches:
            launches[k] += have[k]
        src_bytes = sum(src.part(ci).numel() for ci in src.cells()) * \
            plan.itemsize
        budget = src_bytes + max(a + b for _, a, b in io) + PEAK_SLACK
        print(f"  {name}: launches {have}; peak during the move "
              f"{src_bytes + peak} bytes (source shards {src_bytes} + "
              f"{peak} allocated), budget {budget} (source + largest step "
              f"in+out {max(a + b for _, a, b in io)} + slack "
              f"{PEAK_SLACK})")
        if src_bytes + peak > budget:
            raise AssertionError(f"{name}: peak {src_bytes + peak} over the "
                                 f"budget {budget}")
        ref = plain()
        exact(f"{name} against the plain relayout", got, ref)
        del got, ref
        ms = time_ms(lambda: run(), reps=5)
        dev_ms = device_ms(lambda: run())
        plain_ms = time_ms(lambda: plain(), reps=5)
        bms = bound(sum(a + b for _, a, b in io), 0, F32_FLOPS)[0]
        cms = bound(moved, 0, F32_FLOPS)[0]
        print(f"  {name}: {ms:.4f} ms, device {dev_ms:.4f} ms (plain "
              f"region copy {plain_ms:.4f} ms, "
              f"bound {bms:.4f} ms over {len(io)} steps; the launches "
              f"read and wrote {moved} bytes, {cms:.4f} ms at the HBM rate)")
        rows.append({"move": name, "strategy": plan.strategy,
                     "steps": steps, "mesh_shape": list(plan.mesh_shape),
                     "moved_bytes": plan.moved_bytes,
                     "staging_bytes": plan.staging_bytes, "ms": ms,
                     "device_ms": dev_ms, "plain_ms": plain_ms,
                     "bound_ms": bms,
                     "copy_bytes": moved, "copy_bound_ms": cms,
                     "launches": have, "peak_bytes": src_bytes + peak,
                     "peak_budget_bytes": budget})

    def parts_of(pids, parts):
        return [parts[ci] for ci in np.ndindex(*pids.shape)]

    def relayout_case(name, src, dist, want, pids=None, cuts=None):
        if cuts is None:
            _, pids, cuts = resolve_layout(src.dims, range(4), dist)
        plan = TR.plan_reshard(src, pids, cuts)
        move(name, src, plan,
             lambda: parts_of(pids, TR.reshard(src, pids, cuts, plan=plan)
                              ._parts),
             lambda: parts_of(pids, TR.relayout_plain(src, pids, cuts)),
             want)

    A = tdat.drandn((n, n), dist=(4, 1))
    relayout_case("(4,1) -> (2,2) 16384^2", A, (2, 2), ("chain", ["a2a"]))
    tdat.close(A)
    B = tdat.drandn((n, n), dist=(2, 2))
    relayout_case("transpose P(d0,d1) -> P(d1,d0) (2,2) 16384^2", B, None,
                  ("chain", ["gather", "a2a", "slice"]),
                  pids=np.array([[0, 2], [1, 3]]), cuts=B.cuts)
    for name, ranks, strategy in (
            ("allgather (2,2) 16384^2 onto its 4 ranks", [0, 1, 2, 3],
             "chain"),
            ("gather_put (2,2) 16384^2 onto ranks 0, 1", [0, 1],
             "gather_put")):
        plan = TR.plan_allgather(B, ranks)
        move(name, B, plan, lambda: TR.allgather(B, ranks),
             lambda: [B.full(tdat.device_of(r)) for r in ranks],
             (strategy, ["gather", "gather"]))
    tdat.close(B)
    del B
    m = RESHARD_ROWS_PADDED
    whole = torch.randn(m, n, device=dev)
    C = tdat.darray_from_cuts(whole, range(4),
                              [ceil_cuts(m, 4), [0, n]])
    del whole
    pcuts = [ceil_cuts(m, 2), ceil_cuts(n, 2)]
    pplan = TR.plan_reshard(C, np.arange(4).reshape(2, 2), pcuts)
    if pplan.pad_shape != (n, n):
        raise AssertionError(f"padded chain pad_shape {pplan.pad_shape}")
    relayout_case("padded chain (4,1) -> (2,2) 16383x16384", C, None,
                  ("chain", ["a2a"]), pids=np.arange(4).reshape(2, 2),
                  cuts=pcuts)
    CC._copy_on_card = on_card
    tdat.d_closeall()
    del C
    torch.cuda.empty_cache()

    # -- SPMD mode: 4 thread tasks on the card ------------------------------
    D = tdat.drandn((n, n), dist=(4, 1))
    host_parts = [D.part((k, 0)) for k in range(4)]
    token = torch.arange(1024.0, device=dev)
    table = torch.arange(4 * 256.0, device=dev).reshape(4, 256)

    def task():
        me = tdat.myid()
        lp = D.localpart()
        if lp.data_ptr() != host_parts[me].data_ptr():
            raise AssertionError(f"rank {me}: localpart is not its chunk")
        tdat.sendto((me + 1) % 4, lp)
        got = tdat.recvfrom((me - 1) % 4)
        ring_ok = torch.equal(got, host_parts[(me - 1) % 4])
        mine = (lp * 2.0).sum()
        tdat.barrier()
        b = tdat.bcast(token if me == 0 else None, root=0)
        part = tdat.scatter(table if me == 0 else None, root=0)
        sums = tdat.gather_spmd(float(mine), root=3)
        tdat.barrier()
        return (ring_ok, torch.equal(b, token),
                torch.equal(part, table[me:me + 1]), sums,
                torch.cuda.current_device())

    out, spmd_ms = event_ms(lambda: tdat.spmd(task, pids=range(4)))
    want_sums = [float((host_parts[k] * 2.0).sum()) for k in range(4)]
    for r, (ring_ok, b_ok, s_ok, sums, cur) in enumerate(out):
        if not (ring_ok and b_ok and s_ok):
            raise AssertionError(f"spmd rank {r}: ring {ring_ok}, bcast "
                                 f"{b_ok}, scatter {s_ok}")
        if cur != tdat.device_of(r).index:
            raise AssertionError(f"spmd rank {r} ran on device {cur}")
    if out[3][3] != want_sums or any(o[3] is not None for o in out[:3]):
        raise AssertionError(f"gather_spmd gave {out[3][3]}")
    print(f"  spmd 4 thread tasks (ring of 4 x (4096, 16384) f32 localparts,"
          f" barrier, bcast, scatter, gather_spmd): all checks passed, "
          f"{spmd_ms:.3f} ms")
    tdat.d_closeall()
    del D, host_parts, out
    torch.cuda.empty_cache()

    # -- Life ----------------------------------------------------------------
    g = (torch.rand(LIFE_N, LIFE_N, device=dev) < 0.3).to(torch.uint8)
    ref, plain_ms = event_ms(lambda: plain_life(g, LIFE_ITERS))
    life_ms = {}
    for name, dist, fn in (("life2d (2,2)", (2, 2), tdat.life2d),
                           ("life (4,1)", (4, 1), tdat.life)):
        G = tdat.distribute(g, dist=dist)
        R, life_ms[name] = event_ms(lambda: fn(G, iters=LIFE_ITERS))
        exact(f"{name} 16384^2 uint8, {LIFE_ITERS} generations, against "
              f"plain_life on one device", R.full(), ref)
        print(f"  {name}: {life_ms[name]:.3f} ms (plain whole grid "
              f"{plain_ms:.3f} ms), {int(R.full().sum())} alive")
        tdat.d_closeall()
        del G, R
    del g, ref
    torch.cuda.empty_cache()
    tdat.init()
    print(f"  reshard chain and SPMD {time.perf_counter() - t_phase:.1f} s")
    print(json.dumps({"reshard_spmd": rows, "spmd_ms": spmd_ms,
                      "life_ms": life_ms, "plain_life_ms": plain_ms}))
    return launches


# the sort, FFT and conv phase's sizes, 4 ranks on one card: an 8192^2
# complex64 (4,1) DArray (512 MiB), a 2**26 complex64 DVector (512 MiB),
# bench.py's cfg_sort vector (1e7 f32) and the main path's 1e8 DVector, an
# 8192^2 f32 image with 3x3 and 5x5 kernels, and a batch-sharded NHWC
# batch with its 3x3 kernel
SFC_N, SFC_NV = 8192, 1 << 26
SFC_SORT = (10 ** 7, 10 ** 8)
SFC_KERNELS = ((3, 3), (5, 5))
SFC_NHWC = ((8, 512, 512, 64), (3, 3, 64, 64))
# FFTs and convolutions of float32 data on the ranks against one
# whole-array cuFFT / cuDNN call (TF32 off): the same sums, split across
# the ranks or ordered otherwise; the four-step's twiddle is rounded once
# to complex64
TOL_FFT = 1e-5
TOL_CONV = 1e-5


def sort_fft_conv(tdat, cuda_collectives) -> dict:
    """``dsort``, ``dfft``/``dfft2`` and ``dconv2d`` on 4 ranks on the one
    card, with every all-to-all on K11's copy kernel: K11 itself in
    complex64 and int64 (and the exact-size exchange ``ring_all_to_allv``
    in int32 and float32) bit for bit against the plain all-to-all; the
    FFT along the sharded axis of an 8192^2 complex64 (4,1) DArray (2 K11
    launches a call), ``dfft2``/``difft2`` (2 each) and the four-step
    ``dfft``/``difft`` of a 2**26 complex64 DVector (3 each) against
    whole-array ``torch.fft`` calls on the card; ``dsort`` of bench.py's
    1e7 vector and of a 1e8 DVector (1 K11 launch a call, the one card's)
    bit for bit against ``torch.sort`` of the whole vector, sorted and a
    permutation of the input (count and float64 sum); ``dconv2d`` of an
    8192^2 f32 (4,1) image with 3x3 and 5x5 kernels and of an NHWC (8,
    512, 512, 64) batch sharded on N with a (3, 3, 64, 64) kernel against
    ``F.conv2d`` of the whole array (no K11 launch).  Each op is called
    once to warm up, then the launch counts are set to 0, one call is
    timed by CUDA events and the counts are read, then its device time is
    read from a ``torch.profiler`` trace of 3 calls; the library call is
    timed by events the same way.  Returns the K11 launches by op and
    K11's complex64 timings."""
    import torch.nn.functional as F

    from distributedarrays_tpu_torch.utils import kbuild
    print("phase sort_fft_conv (4 ranks on one card)")
    t_phase = time.perf_counter()
    tdat.init(nranks=4)
    P = 4
    dev = tdat.device_of(0)
    gen = torch.Generator(device=dev).manual_seed(16)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    ms, k11 = {}, {}

    def run(name, fn, want_k11, lib=None):
        fn()
        torch.cuda.synchronize()
        kbuild.reset_launches()
        r, ms[name] = event_ms(fn)
        torch.cuda.synchronize()
        k11[name] = kbuild.launch_counts()["all_to_all"]
        ms[name + " device"] = device_ms(fn, reps=3)
        line = (f"  {name}: {ms[name]:.3f} ms (device "
                f"{ms[name + ' device']:.3f}), K11 launches {k11[name]}")
        if lib is not None:
            lib()
            ref, ms[name + " library"] = event_ms(lib)
            line += f"; library call {ms[name + ' library']:.3f} ms"
        print(line)
        if k11[name] != want_k11:
            raise AssertionError(f"{name} launched K11 {k11[name]} times, "
                                 f"not {want_k11}")
        return (r, ref) if lib is not None else r

    # K11 in complex64 and int64, and the exact-size exchange
    n = SFC_N
    zc = [torch.complex(randn(n // P, n), randn(n // P, n)) for _ in range(P)]
    for sd, cd in ((1, 0), (0, 1)):
        exact(f"K11 complex64 4 x ({n // P}, {n}) split {sd} concat {cd}",
              cuda_collectives.ring_all_to_all(zc, sd, cd),
              cuda_collectives.all_to_all_plain(zc, sd, cd))
    zi = [torch.randint(-2 ** 62, 2 ** 62, (n // P, n // 2), generator=gen,
                        device=dev, dtype=torch.int64) for _ in range(P)]
    for sd, cd in ((1, 0), (0, 1)):
        exact(f"K11 int64 4 x ({n // P}, {n // 2}) split {sd} concat {cd}",
              cuda_collectives.ring_all_to_all(zi, sd, cd),
              cuda_collectives.all_to_all_plain(zi, sd, cd))
    del zi
    counts = torch.randint(0, 1 << 20, (P, P), generator=gen,
                           device=dev).cpu().numpy()
    keys = [torch.randint(-2 ** 31, 2 ** 31 - 1, (int(counts[r].sum()),),
                          generator=gen, device=dev, dtype=torch.int32)
            for r in range(P)]
    vals = [randn(int(counts[r].sum())) for r in range(P)]
    exact("ring_all_to_allv int32 + float32 against all_to_allv_plain",
          [t for a in cuda_collectives.ring_all_to_allv([keys, vals], counts)
           for t in a],
          [t for a in cuda_collectives.all_to_allv_plain([keys, vals], counts)
           for t in a])
    del keys, vals
    w = n // P
    blk_bytes = zc[0].numel() * zc[0].element_size()
    bms, bby = bound(2 * P * blk_bytes, 0, F32_FLOPS)
    k11_c64 = {
        "shape": f"{n}x{n} complex64, 4 row blocks -> 4 column blocks",
        "ms": time_ms(lambda: cuda_collectives.ring_all_to_all(zc, 1, 0)),
        "plain_ms": time_ms(lambda: cuda_collectives.all_to_all_plain(
            zc, 1, 0)),
        "library_ms": time_ms(lambda: [torch.cat(
            [x[:, q * w:(q + 1) * w] for x in zc]) for q in range(P)]),
        "device_ms": device_ms(lambda: cuda_collectives.ring_all_to_all(
            zc, 1, 0)),
        "bound_ms": bms, "bound_by": bby}
    print(f"  K11 complex64 {n}^2: {json.dumps(k11_c64)}")

    # the FFTs
    Z = tdat.distribute(torch.cat(zc), dist=(P, 1))
    del zc
    Zt = Z.full()
    R, ref = run(f"dfft axis 0 (4,1) {n}^2 complex64",
                 lambda: tdat.dfft(Z, axis=0), 2,
                 lambda: torch.fft.fft(Zt, dim=0))
    check("dfft axis 0 against torch.fft.fft", rel_err_c(R.full(), ref),
          TOL_FFT)
    del R, ref
    F2, ref = run(f"dfft2 (4,1) {n}^2 complex64", lambda: tdat.dfft2(Z), 2,
                  lambda: torch.fft.fft2(Zt))
    check("dfft2 against torch.fft.fft2", rel_err_c(F2.full(), ref), TOL_FFT)
    del ref
    B = run(f"difft2 (4,1) {n}^2 complex64", lambda: tdat.difft2(F2), 2)
    check("difft2(dfft2(Z)) against Z", rel_err_c(B.full(), Zt), TOL_FFT)
    tdat.d_closeall()
    del Z, Zt, F2, B
    torch.cuda.empty_cache()
    V = tdat.distribute(torch.complex(randn(SFC_NV), randn(SFC_NV)))
    Vt = V.full()
    R, ref = run(f"dfft four-step {SFC_NV} complex64", lambda: tdat.dfft(V), 3,
                 lambda: torch.fft.fft(Vt))
    check("dfft four-step against torch.fft.fft", rel_err_c(R.full(), ref),
          TOL_FFT)
    Bv = run(f"difft four-step {SFC_NV} complex64", lambda: tdat.difft(R), 3)
    check("difft(dfft(V)) against V", rel_err_c(Bv.full(), Vt), TOL_FFT)
    tdat.d_closeall()
    del V, Vt, R, ref, Bv
    torch.cuda.empty_cache()

    # dsort of bench.py's cfg_sort vector and of the main path's DVector
    for nv in SFC_SORT:
        X = tdat.drand(nv)
        Xt = X.full()
        S, ref = run(f"dsort drand({nv:.0e})", lambda: tdat.dsort(X), 1,
                     lambda: torch.sort(Xt).values)
        St = S.full()
        exact(f"dsort drand({nv:.0e}) against torch.sort", St, ref)
        if St.numel() != nv or not bool((St[1:] >= St[:-1]).all()):
            raise AssertionError("dsort result is not a sorted vector of "
                                 "the input's length")
        s_in, s_out = float(Xt.double().sum()), float(St.double().sum())
        if abs(s_in - s_out) > 1e-9 * abs(s_in):
            raise AssertionError(f"dsort changed the sum: {s_in} -> {s_out}")
        print(f"  dsort drand({nv:.0e}): chunks {np.diff(S.cuts[0]).tolist()}"
              f" on ranks {S.pids.tolist()}")
        tdat.d_closeall()
        del X, Xt, S, St, ref
        torch.cuda.empty_cache()

    # dconv2d: the (4,1) image and the batch-sharded NHWC batch
    img = randn(n, n)
    G = tdat.distribute(img, dist=(P, 1))
    for kh, kw in SFC_KERNELS:
        k = randn(kh, kw)
        Y, ref = run(f"dconv2d (4,1) {n}^2 f32 {kh}x{kw}",
                     lambda: tdat.dconv2d(G, k), 0,
                     lambda: F.conv2d(img[None, None], k[None, None],
                                      padding=(kh // 2, kw // 2))[0, 0])
        check(f"dconv2d {kh}x{kw} against F.conv2d", rel_err(Y.full(), ref),
              TOL_CONV)
        del Y, ref
    tdat.d_closeall()
    del G, img
    xs, ks = SFC_NHWC
    x, k = randn(*xs), randn(*ks) / 24.0
    Xn = tdat.distribute(x, dist=(P, 1, 1, 1))
    Y, ref = run(f"dconv2d NHWC {xs} x {ks} sharded on N",
                 lambda: tdat.dconv2d(Xn, k), 0,
                 lambda: F.conv2d(x.permute(0, 3, 1, 2),
                                  k.permute(3, 2, 0, 1),
                                  padding=1).permute(0, 2, 3, 1))
    check("dconv2d NHWC against F.conv2d", rel_err(Y.full(), ref), TOL_CONV)
    tdat.d_closeall()
    del Xn, Y, ref, x, k
    torch.cuda.empty_cache()
    tdat.init()
    print(f"  sort_fft_conv {time.perf_counter() - t_phase:.1f} s")
    print(json.dumps({"sort_fft_conv_ms": ms, "k11_launches": k11}))
    return {"k11": k11, "k11_complex64": k11_c64}


def rel_err_c(x: torch.Tensor, ref: torch.Tensor) -> float:
    """``rel_err`` of complex tensors (the Frobenius norm of the
    difference over the reference's)."""
    return float((x - ref).abs().norm() / ref.abs().norm().clamp_min(1e-30))


def sort_fft_conv_only() -> int:
    """``--sort-fft-conv``: build the collective kernels and run the sort,
    FFT and conv phase alone (``sort_fft_conv``)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import distributedarrays_tpu_torch as tdat
    from distributedarrays_tpu_torch.ops import cuda_collectives
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = gpu_name()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    tdat.kbuild.build(["collectives"])
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    res = sort_fft_conv(tdat, cuda_collectives)
    print(json.dumps({"sort_fft_conv": res, "gpu": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


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
    # every K8 hop of ring_flash_attention on the wgmma route
    expect_routes("ring_flash_attention", "flash_attention_hop",
                  {"wgmma": 16})
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
                 "(16 launches, 10 of them accumulating)",
        "ms": time_ms(lambda: RA.ring_attention_rdma(*blocks, True)),
        # the 16 launches' device time alone, without the wrapper's host work
        "device_ms": device_ms(lambda: RA.ring_attention_rdma(*blocks, True)),
        "plain_ms": time_ms(lambda: RA.ring_attention_kernel(*blocks, True)),
        "bound_ms": bms, "bound_by": bby,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            *whole, is_causal=True))})
    return rows


def plain_bwd(q, k, v, o, g, lse, causal: bool, rounded: bool = True):
    """The plain FlashAttention-2 backward of (S, H, D) or (S, B, H, D)
    operands, ``(dq, dk, dv)`` in q's type and layout: dd = rowsum(g * o) in
    f32, then ``flash_attention_bwd_plain`` on (H_all, S, D) views.  With
    ``rounded=False`` p and dS stay f32 before their products (the
    control)."""
    from distributedarrays_tpu_torch.ops import cuda_attention as CA
    S, D = q.shape[0], q.shape[-1]
    dd = (g.float() * o.float()).sum(-1).reshape(S, -1).t().contiguous()
    heads = lambda x: x.reshape(S, -1, D).transpose(0, 1)
    ops = [heads(x) for x in (q, k, v, g.to(q.dtype))]
    if not rounded:
        ops = [x.float() for x in ops]
    grads = CA.flash_attention_bwd_plain(*ops, lse, dd, 0, 0, causal, None,
                                         q.dtype)
    return tuple(x.transpose(0, 1).reshape(q.shape) for x in grads)


# K6 + K7 against the plain backward: (S, B, H, D) as K5_CASES, dtype,
# causal, and the route of both
BWD_CASES = (
    ((2048, 0, 64, 64), torch.bfloat16, True, "wgmma"),
    ((2048, 0, 64, 64), torch.bfloat16, False, "wgmma"),
    ((2048, 4, 16, 64), torch.bfloat16, True, "wgmma"),   # train_step's views
    ((1024, 0, 16, 128), torch.bfloat16, True, "wgmma"),
    ((1024, 2, 16, 128), torch.bfloat16, False, "wgmma"),
    ((1000, 0, 16, 64), torch.bfloat16, True, "wgmma"),   # ragged S
    ((1024, 0, 16, 8), torch.bfloat16, True, "wgmma"),
    ((1024, 0, 16, 32), torch.bfloat16, False, "wgmma"),
    ((1000, 0, 16, 96), torch.bfloat16, True, "wgmma"),
    ((1000, 0, 16, 36), torch.bfloat16, True, "mma"),     # d TMA cannot read
    ((2048, 0, 64, 64), torch.float32, True, "f32"),
    ((1000, 0, 16, 64), torch.float32, True, "f32"),
    ((1000, 0, 16, 64), torch.float32, False, "f32"))


def on_bwd_route(route: str, fn):
    """``fn()``, requiring that it launched K6 and K7 once each, both on
    ``route``."""
    return on_route("flash_attention_bwd_dq", route, lambda: on_route(
        "flash_attention_bwd_dkv", route, fn))


def attention_bwd_kernels(randn, errs) -> None:
    """K6 and K7 against the plain backward at the training paths' shapes,
    each call's K6 and K7 on their route, and one ring hop's backward."""
    from distributedarrays_tpu_torch.ops import cuda_attention as CA
    bf16, f32 = torch.bfloat16, torch.float32
    for (S, B, H, D), dt, causal, route in BWD_CASES:
        if B:
            q, k, v = fused_qkv(randn, S, B, H, D, dt)
        else:
            q, k, v = (randn(S, H, D, dtype=dt) for _ in range(3))
        o, lse = CA.flash_attention_lse(q, k, v, causal)
        g = torch.empty_like(o).copy_(randn(*o.shape, dtype=dt))
        got = on_bwd_route(route, lambda: CA.flash_attention_bwd(
            q, k, v, o, g, lse, causal))
        ref = plain_bwd(q, k, v, o, g, lse, causal)
        torch.cuda.synchronize()
        tol = TOL_F32 if dt == f32 else TOL_BWD_BF16
        shape = (S, B, H, D) if B else (S, H, D)
        for name, a, b in zip(("dq", "dk", "dv"), got, ref):
            check(f"flash backward {name} {shape} {dt} "
                  f"causal={causal} ({route})", rel_err(a, b), tol)
            kern = "flash_attention_bwd_dq" if name == "dq" else \
                "flash_attention_bwd_dkv"
            errs[kern] = max(errs[kern], max_abs(a, b))
        if dt == bf16 and (S, B, H) == (2048, 0, 64):
            # the control: without the rounding of p and dS the backward
            # must fail the bf16 tolerance, or the check cannot tell them
            ctl = plain_bwd(q, k, v, o, g, lse, causal, rounded=False)
            bwd_control(f"flash backward (2048, 64, 64) bf16 causal={causal}",
                        ctl, ref)
    # one hop's backward at (16, 2048, 64) on rank 2 of 4 (qoff 4096), f32
    # contributions; K6 and K7 on the wgmma route over the (B, H, D) views
    H, B, D = 16, 2048, 64
    q, k, v, do = (randn(H, B, D, dtype=bf16) for _ in range(4))
    lse = randn(H, B) + 8.0
    dd = randn(H, B)
    for case, koff in (("visible", 0), ("diagonal", 4096), ("masked", 6144)):
        got = on_bwd_route("wgmma", lambda: CA.flash_attention_hop_bwd(
            q, k, v, do, lse, dd, 4096, koff, True))
        ref = CA.flash_attention_bwd_plain(q, k, v, do, lse, dd, 4096, koff,
                                           True, None, f32)
        torch.cuda.synchronize()
        if case == "masked":
            exact("flash hop backward (16, 2048, 64) bf16 masked: zero "
                  "contributions", list(got), [torch.zeros_like(x)
                                               for x in got])
            continue
        for name, a, b in zip(("dq", "dk", "dv"), got, ref):
            check(f"flash hop backward (16, 2048, 64) bf16 {case}: {name}",
                  rel_err(a, b), TOL_BWD_BF16)
        bwd_control(f"flash hop backward (16, 2048, 64) bf16 {case}",
                    CA.flash_attention_bwd_plain(
                        *(x.float() for x in (q, k, v, do)), lse, dd, 4096,
                        koff, True, None, f32), ref)
    del q, k, v, do, got, ref
    torch.cuda.empty_cache()


def training_kernels(randn, errs) -> None:
    """Phase 7a: K6, K7 and K12 against their plain versions at the
    training paths' shapes."""
    from distributedarrays_tpu_torch.ops import cuda_collectives as CC
    bf16, f32 = torch.bfloat16, torch.float32
    print("phase training kernels")
    attention_bwd_kernels(randn, errs)
    # K12: 4 ranks on the card, the trainer's full gradient length in f32,
    # and a 3-D bf16 case scattered along dim 1
    for shape, dim, dt in (((trainer_params(),), 0, f32),
                           ((16, 4 * 96, 64), 1, bf16)):
        blocks = [randn(*shape, dtype=dt) for _ in range(4)]
        errs["reduce_scatter"] = max(errs["reduce_scatter"], exact(
            f"reduce_scatter 4 x {shape} {dt} dim {dim}",
            CC.ring_reduce_scatter(blocks, dim),
            CC.reduce_scatter_plain(blocks, dim)))
        del blocks
    torch.cuda.empty_cache()


def bwd_control(what: str, ctl, ref) -> None:
    """Require the control (dq, dk, dv) to exceed K6/K7's bf16 tolerance."""
    err = max(rel_err(c, r) for c, r in zip(ctl, ref))
    print(f"  control, {what} without rounding p and dS: rel_err={err:.3e} "
          f"(must exceed {TOL_BWD_BF16:g})")
    if not err > TOL_BWD_BF16:
        raise AssertionError("K6/K7's bf16 tolerance does not separate a "
                             "backward that leaves p and dS unrounded")


class PlainBackwardAttention(torch.autograd.Function):
    """Flash attention with the K5 forward and the plain backward: the
    reference of the ``train_step`` gradient check."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        from distributedarrays_tpu_torch.ops import cuda_attention as CA
        o, lse = CA.flash_attention_lse(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, g):
        return plain_bwd(*ctx.saved_tensors[:4], g, ctx.saved_tensors[4],
                         ctx.causal) + (None,)


def plain_backward_attend(q, k, v, causal):
    return PlainBackwardAttention.apply(q, k, v, causal)


def training(tdat, dev) -> dict:
    """Phase 7b: the flagship's ``train_step`` at full width on one rank,
    ``Config(8192, 1024, 16, 8, 4, 2048, bf16)`` on (4, 2049) tokens: the
    gradients of one step against the same step with the plain attention
    backward, then five SGD steps on the fixed batch (each must launch 8
    K5, 8 K6 and 8 K7, and the loss must fall)."""
    from distributedarrays_tpu_torch.models._autodiff import value_and_grad
    T = tdat.transformer
    S = TRAIN_CFG[5]
    print(f"phase training (1 rank, Config{TRAIN_CFG} bf16, train_step on "
          f"(4, {S + 1}) tokens, lr {TRAIN_LR})")
    tdat.init()
    cfg = T.Config(*TRAIN_CFG, torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(7)
    model = T.init_params(cfg, gen, dev)
    tokens = torch.randint(0, cfg.vocab, (4, S + 1), generator=gen,
                           device=dev, dtype=torch.int32)
    leaves = list(model.parameters())
    kbuild = tdat.kbuild
    loss, grads = value_and_grad(lambda: T.loss_fn(model, tokens, cfg),
                                 leaves)
    _, pgrads = value_and_grad(lambda: T.loss_fn(
        model, tokens, cfg, _attend=plain_backward_attend), leaves)
    torch.cuda.synchronize()
    worst = max((rel_err(a, b), n) for (n, _), a, b in zip(
        model.named_parameters(), grads, pgrads))
    check(f"train_step gradients vs plain attention backward, worst "
          f"parameter {worst[1]}", worst[0], TOL_TRAIN_BF16)
    del grads, pgrads
    want = {"flash_attention": cfg.layers, "flash_attention_bwd_dq":
            cfg.layers, "flash_attention_bwd_dkv": cfg.layers}
    losses, step_ms = [], []
    kbuild.reset_launches()
    for _ in range(5):
        before = kbuild.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, lv = T.train_step(model, tokens, TRAIN_LR, cfg)
        losses.append(float(lv))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        after = kbuild.launch_counts()
        got = {kn: after[kn] - before[kn] for kn in want}
        if got != want:
            raise AssertionError(f"train_step launched {got}, expected "
                                 f"{want}")
    counts = kbuild.launch_counts()
    print(f"  launches (5 steps) {counts}")
    for kn in ("flash_attention", "flash_attention_bwd_dq",
               "flash_attention_bwd_dkv"):
        expect_routes("train_step (5 steps)", kn, {"wgmma": 5 * cfg.layers})
    print(f"  losses {losses} (first step's loss {float(loss)})")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    ms = statistics.median(step_ms[1:])
    metrics = {"train_step_ms": ms, "train_tokens_per_s": 4 * S / (ms / 1e3),
               "step_ms": step_ms, "losses": losses, "lr": TRAIN_LR,
               "shape": f"train_step (4, {S + 1}) tokens, bf16, SGD"}
    print(json.dumps({"training": metrics}))
    del model, leaves
    torch.cuda.empty_cache()
    return counts


def sp_step_launches(layers: int, zigzag: bool) -> dict:
    """Kernel launches of one sequence-parallel gradient step with 4 ranks:
    per layer 16 hops (contiguous) or 36 quadrant hops (zigzag: 2p + 1 per
    rank) of K8 forward and K6 + K7 backward, and 16 launches a call of K13
    and K15 (forward and backward) and of K14 (the two weight gradients)."""
    hops = (36 if zigzag else 16) * layers
    return {"flash_attention_hop": hops, "flash_attention_bwd_dq": hops,
            "flash_attention_bwd_dkv": hops, "allgather_matmul": 32 * layers,
            "matmul_reducescatter": 32 * layers,
            "allgather_matmul_rhs": 32 * layers, "flash_attention": 0,
            "ring_attention": 0}


def expect_launches(what: str, counts: dict, want: dict) -> None:
    got = {k: counts[k] for k in want}
    print(f"  {what} launches {got}")
    if got != want:
        raise AssertionError(f"{what} launched {got}, expected {want}")


def worst_grad(grads: dict, ref: dict) -> tuple[float, str]:
    return max((rel_err(grads[n], ref[n]), n) for n in ref)


def sp_training(tdat, dev) -> dict:
    """Phase 7d: the sequence-parallel transformer at full width, 4 ranks
    on the card (``SPConfig(8192, 1024, 16, 8, 4, 8192, bf16)``, tokens (1,
    8192)): one gradient step's launches and its loss and gradients against
    the dense flagship on one rank; the zigzag layout's step against the
    contiguous one; three SGD steps (the loss must fall) and two Adam
    steps.  Returns the launches of the three SGD steps."""
    from distributedarrays_tpu_torch.models._autodiff import value_and_grad
    SP, T = tdat.sp_transformer, tdat.transformer
    S, L = SP_CFG[5], SP_CFG[3]
    ranks = [0, 1, 2, 3]
    print(f"phase sequence-parallel training (4 ranks on one card, "
          f"SPConfig{SP_CFG} bf16, tokens (1, {S}), lr {SP_LR})")
    tdat.init(nranks=4)
    kbuild = tdat.kbuild
    cfg = SP.SPConfig(*SP_CFG, torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(11)
    model = SP.init_params(cfg, gen, dev)
    tokens = torch.randint(0, cfg.vocab, (1, S), generator=gen, device=dev,
                           dtype=torch.int32)

    def counted(fn):
        torch.cuda.synchronize()
        kbuild.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        return out, kbuild.launch_counts()

    def on_wgmma(what, hops=16):
        """Every K13, K14 and K15 launch since the counts were reset ran on
        the wgmma route, 32 a layer each, and every K8, K6 and K7 launch,
        ``hops`` a layer each."""
        got = {k: kbuild.route_counts()[k]
               for k in ("allgather_matmul", "allgather_matmul_rhs",
                         "matmul_reducescatter")}
        print(f"  {what} ring GEMM routes {got}")
        if any(v != {r: 32 * L * (r == "wgmma") for r in v}
               for v in got.values()):
            raise AssertionError(f"{what}: K13/K14/K15 routes {got}, "
                                 f"expected {32 * L} each on wgmma")
        for kn in ("flash_attention_hop", "flash_attention_bwd_dq",
                   "flash_attention_bwd_dkv"):
            expect_routes(what, kn, {"wgmma": hops * L})

    # one gradient step, against the dense flagship on the same weights
    shards = SP.shard_params(model, ranks)
    (loss, grads), counts = counted(
        lambda: SP.make_grad_fn(ranks, cfg)(shards, tokens))
    expect_launches("sequence-parallel gradient step", counts,
                    sp_step_launches(L, False))
    on_wgmma("sequence-parallel gradient step")
    full = SP.unshard(grads, cfg)
    del grads
    dcfg = T.Config(*SP_CFG, torch.bfloat16)
    names, leaves = zip(*model.named_parameters())
    (dloss, dgrads), dcounts = counted(lambda: value_and_grad(
        lambda: T.loss_fn(model, tokens, dcfg), leaves))
    expect_launches("dense flagship gradient step (1 rank)", dcounts,
                    {"flash_attention": L, "flash_attention_bwd_dq": L,
                     "flash_attention_bwd_dkv": L})
    for kn in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        expect_routes("dense flagship gradient step (1 rank)", kn,
                      {"wgmma": L})
    dense = dict(zip(names, dgrads))
    del dgrads
    print(f"  loss {float(loss)}, dense flagship {float(dloss)}")
    check("sequence-parallel loss vs dense flagship",
          abs(float(loss) - float(dloss)) / abs(float(dloss)), TOL_SP_LOSS)
    err, name = worst_grad(full, dense)
    check(f"sequence-parallel gradients vs dense flagship, worst parameter "
          f"{name}", err, TOL_SP_GRAD)
    del dense
    # the zigzag layout against the contiguous one
    zcfg = SP.SPConfig(*SP_CFG, torch.bfloat16, zigzag=True)
    perm = torch.from_numpy(tdat.zigzag_order(S, 4)).to(dev)
    zshards = SP.shard_params(model, ranks)
    (zloss, zgrads), zcounts = counted(
        lambda: SP.make_grad_fn(ranks, zcfg)(zshards, tokens[:, perm]))
    expect_launches("zigzag gradient step", zcounts, sp_step_launches(L, True))
    on_wgmma("zigzag gradient step", 36)
    check("zigzag loss vs contiguous",
          abs(float(zloss) - float(loss)) / abs(float(loss)), TOL_SP_LOSS)
    err, name = worst_grad(SP.unshard(zgrads, zcfg), full)
    check(f"zigzag gradients vs contiguous, worst parameter {name}", err,
          TOL_SP_GRAD)
    del zshards, zgrads, full
    torch.cuda.empty_cache()
    # three SGD steps on the fixed batch
    step = SP.make_train_step(ranks, cfg)
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, total = [], [], {}
    for _ in range(3):
        t0 = time.perf_counter()
        (_, lv), counts = counted(lambda: step(shards, tokens, SP_LR))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(lv))
        expect_launches("sequence-parallel SGD step", counts,
                        sp_step_launches(L, False))
        on_wgmma("sequence-parallel SGD step")
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  sgd losses {losses}, peak {peak:.2f} GiB")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    del shards
    # two Adam steps
    ashards = SP.shard_params(model, ranks)
    astep, ainit = SP.make_optax_train_step(ranks, cfg,
                                            tdat.train.adam(SP_ADAM_LR))
    state = ainit(ashards)
    adam = []
    for _ in range(2):
        ashards, state, lv = astep(ashards, state, tokens)
        adam.append(float(lv))
    print(f"  adam losses {adam} (lr {SP_ADAM_LR})")
    if not all(np.isfinite(adam)) or not adam[1] < adam[0]:
        raise AssertionError(f"the Adam loss did not fall: {adam}")
    ms = statistics.median(step_ms[1:])
    print(json.dumps({"sp_training": {
        "step_ms": ms, "train_tokens_per_s": S / (ms / 1e3),
        "step_ms_all": step_ms, "peak_gib": peak, "losses": losses,
        "lr": SP_LR, "adam_losses": adam, "adam_lr": SP_ADAM_LR,
        "shape": f"SPConfig{SP_CFG} bf16, tokens (1, {S}), 4 ranks on one "
                 "card, SGD"}}))
    del ashards, state, model
    tdat.d_closeall()
    torch.cuda.empty_cache()
    return total


TRAINER_CFG = dict(vocab=8192, dim=1024, heads=16, layers=8, seq=2048,
                   batch_size=8)


def trainer_params() -> int:
    """The task's flat f32 parameter count (119555072 at full width):
    embed, pos, ln_f and head, and per layer ln1, qkv, proj, ln2, w1, w2."""
    v, e, s, n = (TRAINER_CFG[k] for k in ("vocab", "dim", "seq", "layers"))
    return 2 * v * e + s * e + e + n * (2 * e + 12 * e * e)


def trainer_phase(tdat) -> dict:
    """Phase 7c: the data-parallel ``Trainer`` with four ranks on the card
    on ``transformer_task(8192, 1024, 16, 8, seq 2048, batch 8)`` (f32):
    three Adam steps (each must launch 1 K10 (one launch for the card's
    four destinations), 4 K12 and 8 K5, K6, K7 per rank), then two SGD
    steps against the same two steps on one rank."""
    train = tdat.train
    print(f"phase trainer (4 ranks on one card, transformer_task "
          f"{TRAINER_CFG}, f32)")
    tdat.init(nranks=4)
    task = train.transformer_task(**TRAINER_CFG)
    kbuild = tdat.kbuild
    per_rank = TRAINER_CFG["layers"]
    want = {"all_gather": 1, "reduce_scatter": 4,
            "flash_attention": 4 * per_rank,
            "flash_attention_bwd_dq": 4 * per_rank,
            "flash_attention_bwd_dkv": 4 * per_rank}
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    with train.Trainer(task, train.adam(1e-4)) as t:
        if t.flat_params().numel() != trainer_params():
            raise AssertionError("unexpected parameter count")
        kbuild.reset_launches()
        for _ in range(3):
            before = kbuild.launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(t.step_once())
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            after = kbuild.launch_counts()
            got = {kn: after[kn] - before[kn] for kn in want}
            if got != want:
                raise AssertionError(f"a trainer step launched {got}, "
                                     f"expected {want}")
    counts = kbuild.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  adam losses {losses}, launches (3 steps) {counts}, peak "
          f"{peak:.2f} GiB")
    for kn in ("flash_attention", "flash_attention_bwd_dq",
               "flash_attention_bwd_dkv"):
        expect_routes("trainer (3 steps)", kn, {"f32": 3 * 4 * per_rank})
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite trainer losses {losses}")
    runs = {}
    for ranks in ([0, 1, 2, 3], [0]):
        with train.Trainer(task, train.sgd(0.1), ranks=ranks) as t:
            runs[len(ranks)] = (t.fit(2)["losses"], t.flat_params())
    (l4, f4), (l1, f1) = runs[4], runs[1]
    print(f"  sgd losses 4 ranks {l4}, 1 rank {l1}")
    check("trainer 4 ranks vs 1 rank: losses",
          max(abs(a - b) / abs(b) for a, b in zip(l4, l1)),
          TOL_TRAINER_LOSS)
    check("trainer 4 ranks vs 1 rank: flat parameters", rel_err(f4, f1),
          TOL_TRAINER_PARAMS)
    ms = statistics.median(step_ms[1:])
    print(json.dumps({"trainer": {
        "step_ms": ms, "step_ms_all": step_ms, "peak_gib": peak,
        "tokens_per_s": TRAINER_CFG["batch_size"] * TRAINER_CFG["seq"] /
        (ms / 1e3),
        "shape": "4 ranks on one card, batch 8 x 2049 tokens, f32, adam"}}))
    tdat.d_closeall()
    torch.cuda.empty_cache()
    return counts


def training_timings(randn) -> list[dict]:
    """Timing rows of K6, K7 and K12 at the training paths' shapes.  K6
    does 6*D operations a causal pair, K7 8*D; K12 moves (p + 1) * N * 4
    bytes.  The plain version and the library yardstick compute the whole
    backward (dq, dk and dv) for both attention rows; K6 and K7 also give
    the device time of their launch alone."""
    import torch.nn.functional as F
    from distributedarrays_tpu_torch.ops import cuda_attention as CA
    from distributedarrays_tpu_torch.ops import cuda_collectives as CC
    bf16 = torch.bfloat16
    rows = []
    S, H, D = 2048, 64, 64
    q, k, v, g = (randn(S, H, D, dtype=bf16) for _ in range(4))
    o, lse = CA.flash_attention_lse(q, k, v, True)
    dd = (g.float() * o.float()).sum(-1).t().contiguous()
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    qh, kh, vh, gh = (x.transpose(0, 1) for x in (q, k, v, g))
    plain_ms = time_ms(lambda: CA.flash_attention_bwd_plain(
        qh, kh, vh, gh, lse, dd, 0, 0, True))
    qs, ks, vs = (x.transpose(0, 1)[None].detach().clone()
                  .requires_grad_(True) for x in (q, k, v))
    os_ = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    gs = g.transpose(0, 1)[None]
    lib_ms = time_ms(lambda: torch.autograd.grad(os_, (qs, ks, vs), gs,
                                                 retain_graph=True))
    pairs = S * (S + 1) // 2 * H
    io = S * H * D * 2
    for name, outs, ops, nout, line in (
            ("flash_attention_bwd_dq", (dq,), 6, 1, 179),
            ("flash_attention_bwd_dkv", (dk, dv), 8, 2, 227)):
        bms, bby = bound((4 + nout) * io + 2 * H * S * 4, ops * D * pairs,
                         BF16_FLOPS)
        call = lambda: CA._bwd_launch(name, q, k, v, g, lse, dd, outs, 0, 0,
                                      True, None)
        rows.append({
            "name": name, "route": "cuda",
            "source": "distributedarrays_tpu_torch/csrc/attention_bwd.cu",
            "replaces": f"distributedarrays_tpu/ops/pallas_attention.py:"
                        f"{line}",
            "shape": "(2048, 64, 64) bf16 causal (the training step's 4 x 16 "
                     "heads); plain and library: the whole backward",
            "ms": time_ms(call), "device_ms": device_ms(call),
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby,
            "library_ms": lib_ms})
    del qs, ks, vs, os_
    N, P4 = trainer_params(), 4
    blocks = [randn(N) for _ in range(P4)]
    bms, bby = bound((P4 + 1) * N * 4, 0, F32_FLOPS)
    piece = N // P4
    rows.append({
        "name": "reduce_scatter", "route": "cuda",
        "source": "distributedarrays_tpu_torch/csrc/collectives.cu",
        "replaces": "distributedarrays_tpu/ops/pallas_collectives.py:569",
        "shape": f"4 x {N} f32 on one card (the trainer's gradient)",
        "ms": time_ms(lambda: CC.ring_reduce_scatter(blocks, 0)),
        "plain_ms": time_ms(lambda: CC.reduce_scatter_plain(blocks, 0)),
        "bound_ms": bms, "bound_by": bby,
        "library_ms": time_ms(lambda: [torch.stack(
            [b[d * piece:(d + 1) * piece] for b in blocks]).sum(0)
            for d in range(P4)])})
    del blocks
    torch.cuda.empty_cache()
    return rows


def across_cards(tdat, cuda_collectives) -> None:
    """Phase 6: one rank per card (at most 4) with peer access; the
    all-gather, all-to-all and ring GEMM kernels on a 16384^2 f32 array
    against their plain versions, and their times (host clock around work
    that ends in a synchronize of every card, median of 10); K13, K14 and
    K15 in bf16 at the sequence-parallel shapes, every launch on the
    ``wgmma_peer`` route (K13, K14: the forward to the left neighbour's
    card by a copy launch of its own; K15: the sum stored into the right
    neighbour's card element by element)."""
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
    from distributedarrays_tpu_torch.utils import kbuild
    for name, xshape, wshape in RING_GEMM_SHAPES:
        kern, plain = ring_gemm_fns(name)
        xs = [torch.randn(xshape, generator=torch.Generator(device=d)
                          .manual_seed(40 + i), device=d).bfloat16()
              for i, d in enumerate(devs)]
        ws = [(torch.randn(wshape, generator=torch.Generator(device=d)
                           .manual_seed(50 + i), device=d) / 32).bfloat16()
              for i, d in enumerate(devs)]
        before = kbuild.route_counts()[name]
        got, ref = kern(xs, ws), plain(xs, ws)
        sync()
        moved = {r: c - before[r]
                 for r, c in kbuild.route_counts()[name].items()}
        if moved != {r: p * p * (r == "wgmma_peer") for r in moved}:
            raise AssertionError(f"{name} across cards: routes {moved}")
        check(f"{name} bf16 4 x {xshape} @ {wshape} across {p} cards",
              max(rel_err(g, r) for g, r in zip(got, ref)),
              TOL_RING_GEMM_BF16)
        times[f"{name} bf16"] = {"ms": wall_ms(lambda: kern(xs, ws)),
                                 "plain_ms": wall_ms(lambda: plain(xs, ws))}
        del xs, ws, got, ref
    print(json.dumps({"across_cards": times, "cards": p,
                      "shape": f"{n}x{n} f32 in {p} row blocks; ring "
                               "attention S=8192, 16x64 bf16 causal"}))


# K3 against its plain version: the main path's 8192^2, m not a multiple of
# a tile with an odd n, and m below the tile height and below k; steps a
# launch; each weight set with its route
K3_SHAPES = ((8192, 8192), (1000, 777), (7, 8193))
K3_STEPS = (1, 8, 16)
# the shared-memory pipe of an H100 SXM: 128 bytes a clock an SM, 132 SMs,
# at the 1.98 GHz boost clock (data sheet and architecture white paper)
SMEM_BYTES_S = 132 * 128 * 1.98e9


def k3_smem_bound_ms(CS, m: int, n: int, k: int) -> float:
    """K3's second bound (ms): the bytes its design moves through the
    shared-memory pipe at (m, n, k) over ``SMEM_BYTES_S``.  Per block and
    step each warp stores its top and bottom rows and loads its
    neighbours' (the first warp has none above, the last none below), 16
    bytes a lane each, and each thread shuffles two 4-byte values a row
    on the 5-point route; each block zeroes its exchange buffers once."""
    plan = CS.multistep_plan(m, n, k)
    warps = CS._WARPS
    rows = CS.WINDOW_ROWS // warps
    exchange = (2 * warps + 2 * (warps - 1)) * 32 * 16
    shuffles = warps * rows * 2 * 32 * 4
    blocks = plan.grid[0] * plan.grid[1]
    return blocks * (k * (exchange + shuffles) + plan.smem_bytes) \
        / SMEM_BYTES_S * 1e3


# K2 against its plain version: K3's shapes and a single row
K2_SHAPES = K3_SHAPES + ((1, 8192),)
# K2 and K3 in the other dtypes: a shape on the vector path and K3's two
# others; float16 takes K3 to 8 steps (with its values scaled by 2^-12, so
# that 8 Laplacian steps stay finite)
TYPED_SHAPES = ((1024, 2048), (1000, 777), (7, 8193))


def typed_grid(randn, shape, dt) -> torch.Tensor:
    """Seeded values of ``dt`` on the card: normal floats (float16 scaled
    by 2^-12, part of them subnormal), integers of normal x 1000."""
    x = randn(*shape)
    if dt == torch.float16:
        return (x * 2.0 ** -12).to(dt)
    return x.to(dt) if dt.is_floating_point else (x * 1000).round().to(dt)


def stencil_kernels(randn, errs) -> None:
    """K2 and K3 against their plain versions on the card, bit for bit
    (``exact``): K2 at every ``K2_SHAPES`` with nonzero halo rows, random
    weights on the generic route and the Laplacian on the 5-point route,
    and once on a block whose base is not 16-byte aligned (the scalar
    path); K3 at every ``K3_SHAPES`` x ``K3_STEPS`` with nonzero halo
    slabs, all four Dirichlet settings, both routes.  Then both kernels in
    each other dtype the kernels take, the same checks at ``TYPED_SHAPES``
    (K2 also at (1, 8192) and off its alignment), with the random weights
    x 3 so that int32 keeps nonzero ones.  Every call on the route
    ``multistep_route`` picks."""
    from distributedarrays_tpu_torch.ops import cuda_stencil as CS
    wts = tuple(tuple(float(v) for v in row)
                for row in np.random.default_rng(1).uniform(-1, 1, (3, 3)))
    routes = ((wts, "generic"), (CS.LAPLACIAN_3X3, "five_point"))
    for m, n in K2_SHAPES:
        x, lo1, hi1 = randn(m, n), randn(1, n), randn(1, n)
        got = [on_route("stencil_step", route,
                        lambda: CS.stencil3x3_block(x, lo1, hi1, w))
               for w, route in routes]
        ref = [CS._apply3x3(torch.cat([lo1, x, hi1]), w) for w, _ in routes]
        errs["stencil_step"] = max(errs["stencil_step"], exact(
            f"stencil step {m}x{n}: both routes", got, ref))
    m, n = 1000, 776
    xm = randn(m * n + 1)[1:].view(m, n)
    lo1, hi1 = randn(1, n), randn(1, n)
    if xm.data_ptr() % 16 == 0 or not xm.is_contiguous():
        raise AssertionError("the misaligned case must be contiguous and "
                             "off 16 bytes")
    errs["stencil_step"] = max(errs["stencil_step"], exact(
        f"stencil step {m}x{n}, base off 16 bytes: both routes",
        [on_route("stencil_step", route,
                  lambda: CS.stencil3x3_block(xm, lo1, hi1, w))
         for w, route in routes],
        [CS._apply3x3(torch.cat([lo1, xm, hi1]), w) for w, _ in routes]))
    for m, n in K3_SHAPES:
        x = randn(m, n)
        for k in K3_STEPS:
            lo, hi = randn(k, n), randn(k, n)
            got, ref = [], []
            for w, route in routes:
                for flags in itertools.product((False, True), repeat=2):
                    got.append(on_route(
                        "stencil_multistep", route,
                        lambda: CS.stencil3x3_multistep(x, lo, hi, k, *flags,
                                                        w)))
                    ref.append(CS._multistep_plain(x, lo, hi, k, *flags, w))
            errs["stencil_multistep"] = max(errs["stencil_multistep"], exact(
                f"stencil multistep {m}x{n} k={k}: both routes, all four "
                "Dirichlet settings", got, ref))
    del x, xm, got, ref
    routes = ((tuple(tuple(3 * v for v in row) for row in wts), "generic"),
              (CS.LAPLACIAN_3X3, "five_point"))
    for dt in CS.KERNEL_DTYPES[1:]:
        name = str(dt).removeprefix("torch.")
        for m, n in TYPED_SHAPES + ((1, 8192), (1000, 776)):
            off = int(n == 776)     # the block's base one element on
            x = typed_grid(randn, (m * n + off,), dt)[off:].view(m, n)
            lo1, hi1 = (typed_grid(randn, (1, n), dt) for _ in range(2))
            errs["stencil_step"] = max(errs["stencil_step"], exact(
                f"stencil step {name} {m}x{n}"
                f"{', base off alignment' if off else ''}: both routes",
                [on_route("stencil_step", route,
                          lambda: CS.stencil3x3_block(x, lo1, hi1, w))
                 for w, route in routes],
                [CS._apply3x3(torch.cat([lo1, x, hi1]), w)
                 for w, _ in routes]))
        for m, n in TYPED_SHAPES:
            x = typed_grid(randn, (m, n), dt)
            for k in (1, 8) if dt == torch.float16 else K3_STEPS:
                lo, hi = (typed_grid(randn, (k, n), dt) for _ in range(2))
                got, ref = [], []
                for w, route in routes:
                    for flags in itertools.product((False, True), repeat=2):
                        got.append(on_route(
                            "stencil_multistep", route,
                            lambda: CS.stencil3x3_multistep(x, lo, hi, k,
                                                            *flags, w)))
                        ref.append(CS._multistep_plain(x, lo, hi, k, *flags,
                                                       w))
                errs["stencil_multistep"] = max(
                    errs["stencil_multistep"], exact(
                        f"stencil multistep {name} {m}x{n} k={k}: both "
                        "routes, all four Dirichlet settings", got, ref))
    del x, got, ref


def stencil_dtypes(tdat, randn) -> None:
    """``stencil5`` of 8192^2 DArrays in (4, 1) rows on the card in each
    other dtype the kernels take, one step and three: K2 and K3 launched
    once a rank on the 5-point route, the result of the DArray's dtype and
    bit for bit the plain steps' on the card (``use_kernel=False``) and, on
    rows 1536..2559 (across the first rank boundary), the plain step on the
    host from a copy of the input.  A dtype the kernels do not take (int8)
    raises ``TypeError`` on the card unless the plain steps are asked for."""
    from distributedarrays_tpu_torch.ops import cuda_stencil as CS
    from distributedarrays_tpu_torch.utils import kbuild
    lap = CS.LAPLACIAN_3X3
    r0, r1 = 1536, 2560
    for dt in CS.KERNEL_DTYPES[1:]:
        G = tdat.distribute(typed_grid(randn, (8192, 8192), dt), dist=(4, 1))
        for iters in (1, 3):
            kbuild.reset_launches()
            got = tdat.stencil5(G, iters=iters)
            kernel = "stencil_step" if iters == 1 else "stencil_multistep"
            expect_routes(f"stencil5 {dt} iters={iters}", kernel,
                          {"five_point": 4})
            if got.dtype != dt:
                raise AssertionError(f"stencil5 {dt} returned {got.dtype}")
            full = got.full()
            exact(f"stencil5 {dt} iters={iters} (K2/K3) against the plain "
                  "steps on the card", full,
                  tdat.stencil5(G, iters, use_kernel=False).full())
            if iters == 1:
                x = G.full()[r0 - 1:r1 + 1].cpu()
                exact(f"stencil5 {dt} rows {r0}..{r1 - 1} against the plain "
                      "step on the host", full[r0:r1].cpu(),
                      CS._apply3x3(x, lap))
        del G, got, full
    G = tdat.distribute(typed_grid(randn, (512, 512), torch.int32).to(
        torch.int8), dist=(4, 1))
    for choice in (None, True):
        try:
            tdat.stencil5(G, use_kernel=choice)
        except TypeError as e:
            print(f"  stencil5 int8 use_kernel={choice}: TypeError ({e})")
        else:
            raise AssertionError(f"stencil5 int8 use_kernel={choice} ran")
    kbuild.reset_launches()
    got = tdat.stencil5(G, use_kernel=False)
    if got.dtype != torch.int8 or any(kbuild.launch_counts().values()):
        raise AssertionError("stencil5 int8 use_kernel=False: "
                             f"{got.dtype}, {kbuild.launch_counts()}")
    tdat.d_closeall()


def copy_widths(CC, copies) -> set:
    """The access widths (bytes) of the copy launches the all-gather or
    all-to-all makes for ``copies`` ``(dest, src view, dst view)``."""
    return {CC.copy_width(*g) for launch in CC.copy_launches(
        [CC.view_copy(*c) for c in copies]) for g in launch}


def collective_kernels(randn, errs) -> None:
    """K10 and K11 against their plain versions, bit for bit: a 16384^2
    f32 array in 4 row blocks on the card (gathered along dims 0 and 1;
    all-to-all split 1 concat 0 and split 0 concat 1), and bf16 blocks of
    odd width, 4 x (4096, 1001) gathered along dims 0 and 1 and 4 x (4096,
    1004) all-to-all both ways, whose copies must take the 16-, 4- and
    1-byte accesses between them (read from the launches' plan)."""
    from distributedarrays_tpu_torch.ops import cuda_collectives as CC
    widths = set()
    for shape, dt in (((4096, 16384), torch.float32),
                      ((4096, 1001), torch.bfloat16)):
        blocks = [randn(*shape, dtype=dt) for _ in range(4)]
        for dim in (0, 1):
            outs = CC.ring_all_gather(blocks, dim)
            errs["all_gather"] = max(errs["all_gather"], exact(
                f"all_gather 4 x {shape} {dt} dim {dim}", outs,
                CC.all_gather_plain(blocks, dim)))
            e = shape[dim]
            widths |= copy_widths(CC, [
                (q, b, out.narrow(dim, r * e, e))
                for q, out in enumerate(outs) for r, b in enumerate(blocks)])
    for shape, dt in (((4096, 16384), torch.float32),
                      ((4096, 1004), torch.bfloat16)):
        blocks = [randn(*shape, dtype=dt) for _ in range(4)]
        for sd, cd in ((1, 0), (0, 1)):
            outs = CC.ring_all_to_all(blocks, sd, cd)
            errs["all_to_all"] = max(errs["all_to_all"], exact(
                f"all_to_all 4 x {shape} {dt} split {sd} concat {cd}", outs,
                CC.all_to_all_plain(blocks, sd, cd)))
            sb, ce = shape[sd] // 4, shape[cd]
            widths |= copy_widths(CC, [
                (q, b.narrow(sd, q * sb, sb), out.narrow(cd, r * ce, ce))
                for q, out in enumerate(outs) for r, b in enumerate(blocks)])
    print(f"  all_gather / all_to_all access widths taken: {sorted(widths)}")
    if widths != {1, 4, 16}:
        raise AssertionError(f"copy widths {widths}: the cases must reach "
                             "the 16-, 4- and 1-byte accesses")
    del blocks, outs
    torch.cuda.empty_cache()


class per_destination:
    """Within the block, the all-gather and all-to-all make one launch per
    destination rank (the launch structure before the per-card grouping)
    instead of one per card."""

    def __init__(self, CC):
        self.CC = CC

    def __enter__(self):
        self.saved = orig = self.CC.copy_launches

        def split(copies, maxp=self.CC.MAXP):
            dests = sorted({c[0] for c in copies})
            return [launch for q in dests for launch in orig(
                [c for c in copies if c[0] == q], maxp)]
        self.CC.copy_launches = split

    def __exit__(self, *exc):
        self.CC.copy_launches = self.saved


def k3_k10_times(root: str | None = None) -> int:
    """``--time-k3-k10 [ROOT]``: time K3, K2, K10 and K11 through the
    package under ROOT (this checkout's by default), so two trees can be
    timed in turns in one call on one card, each per call by CUDA events
    and in device time by ``torch.profiler``: K3 at 8192^2, k = 8, the
    Laplacian with both Dirichlet settings and random weights, beside
    ``F.conv2d`` x 8 (TF32 off); K2 at 8192^2 with the Laplacian and
    random weights, beside K3 at k = 1 (K2's other design) on both routes
    and one ``F.conv2d`` step; K2 and K3 (k = 8, the Laplacian) in
    bfloat16, float16 and int32 where the tree's kernels take them; the
    all-gather K10 of a 16384^2 f32 array in 4 row blocks on 4 ranks,
    along dims 0 and 1, beside ``torch.cat`` per rank; the all-to-all K11
    (split 1, concat 0) beside ``torch.cat`` of the pieces; K10 and K11
    also with one launch a destination where the package groups launches
    by card.  The copies (K10, K11 and their ``torch.cat``) also with
    batches of about 10 calls and by the host's ms a call (``host_ms``).
    Prints the ptxas register and spill lines of the stencil and
    collective kernels first."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if root:
        sys.path.insert(0, os.path.abspath(root))
    import torch.nn.functional as F
    import distributedarrays_tpu_torch as tdat
    from distributedarrays_tpu_torch.ops import cuda_collectives as CC
    from distributedarrays_tpu_torch.ops import cuda_stencil as CS
    torch.backends.cudnn.allow_tf32 = False
    smi = gpu_name()
    print(smi)
    stems = ("stencil", "collectives")
    tdat.kbuild.build(stems)
    print_ptxas(tdat.kbuild, stems)
    tdat.init()
    dev = tdat.device_of(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    times = {}

    def both(key, fn):
        times[key] = time_ms(fn)
        times[key + ", device"] = device_ms(fn)

    def copies(key, fn):
        # also with batches of about 10 calls, and the host's ms a call
        both(key, fn)
        times[key + ", 10 a batch"] = time_ms(fn, batch_ms=10 * times[key])
        times[key + ", host"] = host_ms(fn)

    n, K = 8192, 8
    lap = CS.LAPLACIAN_3X3
    wts = tuple(tuple(float(v) for v in row)
                for row in np.random.default_rng(1).uniform(-1, 1, (3, 3)))
    x = torch.randn(n, n, generator=gen, device=dev)
    lok, hik = (torch.zeros(K, n, device=dev) for _ in range(2))
    lo1, hi1 = (torch.zeros(1, n, device=dev) for _ in range(2))
    for flags in ((True, True), (False, False)):
        both(f"K3 8192^2 k=8 Laplacian dirichlet={flags}",
             lambda: CS.stencil3x3_multistep(x, lok, hik, K, *flags, lap))
    both("K3 8192^2 k=8 random weights dirichlet=(True, True)",
         lambda: CS.stencil3x3_multistep(x, lok, hik, K, True, True, wts))
    wk = torch.tensor(lap, device=dev)[None, None]

    def conv_k():
        y = x[None, None]
        for _ in range(K):
            y = F.conv2d(y, wk, padding=1)
        return y
    times["F.conv2d x 8"] = time_ms(conv_k)
    if hasattr(CS, "multistep_plan"):
        times["K3 second bound (shared-memory pipe)"] = k3_smem_bound_ms(
            CS, n, n, K)
    both("K2 8192^2 Laplacian",
         lambda: CS.stencil3x3_block(x, lo1, hi1, lap))
    both("K2 8192^2 random weights",
         lambda: CS.stencil3x3_block(x, lo1, hi1, wts))
    # design (a) of K2: K3's window at k = 1, no Dirichlet rows
    for name, w in (("Laplacian", lap), ("random weights", wts)):
        both(f"K3 8192^2 k=1 {name}",
             lambda: CS.stencil3x3_multistep(x, lo1, hi1, 1, False, False,
                                             w))
    xin = torch.cat([lo1, x, hi1])[None, None]
    times["F.conv2d x 1"] = time_ms(
        lambda: F.conv2d(xin, wk, padding=(0, 1)))
    # the other dtypes' routes, where the tree's kernels take them
    for dt in (torch.bfloat16, torch.float16, torch.int32):
        if not (hasattr(CS, "KERNEL_DTYPES") and CS.supports(dt)):
            continue
        name = str(dt).removeprefix("torch.")
        xt, lt, ht = x.to(dt), lo1.to(dt), hi1.to(dt)
        lkt, hkt = lok.to(dt), hik.to(dt)
        both(f"K2 8192^2 {name} Laplacian",
             lambda: CS.stencil3x3_block(xt, lt, ht, lap))
        both(f"K3 8192^2 {name} k=8 Laplacian dirichlet=(True, True)",
             lambda: CS.stencil3x3_multistep(xt, lkt, hkt, K, True, True,
                                             lap))
        del xt
    del x, xin
    blocks = [torch.randn(4096, 16384, generator=gen, device=dev)
              for _ in range(4)]
    grouped = hasattr(CC, "copy_launches")
    for dim in (0, 1):
        copies(f"K10 16384^2 f32, 4 ranks, dim {dim}",
               lambda: CC.ring_all_gather(blocks, dim))
        if grouped:
            with per_destination(CC):
                copies(f"K10 16384^2 f32, 4 ranks, dim {dim}, one launch a "
                       "destination", lambda: CC.ring_all_gather(blocks, dim))
        copies(f"torch.cat per rank, dim {dim}",
               lambda: [torch.cat(blocks, dim) for _ in blocks])
    copies("K11 16384^2 f32, 4 row blocks -> 4 column blocks",
           lambda: CC.ring_all_to_all(blocks, 1, 0))
    if grouped:
        with per_destination(CC):
            copies("K11 16384^2 f32, one launch a destination",
                   lambda: CC.ring_all_to_all(blocks, 1, 0))
    w = 16384 // 4
    copies("torch.cat of the pieces (K11)", lambda: [torch.cat(
        [b[:, q * w:(q + 1) * w] for b in blocks]) for q in range(4)])
    print(json.dumps({"k3_k10_times": times, "package": tdat.__file__,
                      "gpu": smi}))
    return 0


def surface_only() -> int:
    """``--surface``: build the collective kernels and run the reference
    surface phase alone (``reference_surface``)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import distributedarrays_tpu_torch as tdat
    from distributedarrays_tpu_torch.ops import cuda_collectives
    print(gpu_name())
    t0 = time.perf_counter()
    tdat.kbuild.build(["collectives"])
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    print(json.dumps(reference_surface(tdat, cuda_collectives)))
    return 0


def reshard_spmd_only() -> int:
    """``--reshard-spmd``: build the collective kernels and run the reshard
    chain and SPMD phase alone (``reshard_spmd``)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import distributedarrays_tpu_torch as tdat
    print(gpu_name())
    t0 = time.perf_counter()
    tdat.kbuild.build(["collectives"])
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    print(json.dumps(reshard_spmd(tdat)))
    return 0


def k3_k10_only() -> int:
    """``--k3-k10``: build the stencil and collective kernels, check K2,
    K3, K10 and K11 against their plain versions (phase 2's checks) and
    the main path's ``stencil5`` against its plain steps, bit for bit, and
    ``stencil5`` in the other dtypes (``stencil_dtypes``)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import distributedarrays_tpu_torch as tdat
    smi = gpu_name()
    print(smi)
    stems = ("stencil", "collectives")
    t0 = time.perf_counter()
    tdat.kbuild.build(stems)
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    print_ptxas(tdat.kbuild, stems)
    tdat.init()
    dev = tdat.device_of(0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    errs = {k: 0.0 for k in tdat.kbuild.KERNELS}
    stencil_kernels(randn, errs)
    collective_kernels(randn, errs)
    G = tdat.drandn((8192, 8192))
    tdat.kbuild.reset_launches()
    S16 = tdat.stencil5(G, iters=16)
    S1 = tdat.stencil5(G, iters=1)
    expect_routes("stencil5 iters=16 and 1", "stencil_multistep",
                  {"five_point": 2})
    expect_routes("stencil5 iters=16 and 1", "stencil_step",
                  {"five_point": 1})
    exact("stencil5 iters=16 (multistep) against 16 plain steps", S16.full(),
          tdat.stencil5(G, 16, use_kernel=False).full())
    exact("stencil5 iters=1 (step) against the plain step", S1.full(),
          tdat.stencil5(G, 1, use_kernel=False).full())
    tdat.d_closeall()
    tdat.init(nranks=4)
    stencil_dtypes(tdat, randn)
    print(json.dumps({"errs": {k: errs[k] for k in (
        "stencil_step", "stencil_multistep", "all_gather", "all_to_all")},
        "gpu": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


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
    gemm_kernels(randn, errs)
    stencil_kernels(randn, errs)
    ms, ns = 8192, 8192
    K = 8

    n16 = 16384
    int8_kernels(gen, dev, errs)
    collective_kernels(randn, errs)
    P4 = 4
    blocks = [randn(n16 // P4, n16) for _ in range(P4)]
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
    exact("stencil5 iters=16 (multistep) against 16 plain steps", S16.full(),
          tdat.stencil5(G, 16, use_kernel=False).full())
    S1 = tdat.stencil5(G, iters=1)
    exact("stencil5 iters=1 (step) against the plain step", S1.full(),
          tdat.stencil5(G, 1, use_kernel=False).full())
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
    # stencil5(iters=16) at auto depth 8: two launches of the 5-point route;
    # stencil5(iters=1): one of K2's
    expect_routes("main path", "stencil_multistep", {"five_point": 2})
    expect_routes("main path", "stencil_step", {"five_point": 1})

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
    print("phase stencil dtypes (4 ranks)")
    stencil_dtypes(tdat, randn)
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
    # K4: 1 x 16384^3 (one rank), 4 x 4096 x 16384 x 16384 ((4,1) rows) and
    # 8 x 8192^3 (Cannon 2 x 2), all on the wgmma route
    expect_routes("distributed GEMM", "matmul_int8", {"wgmma": 13})
    tdat.d_closeall()
    del A41, B41, Y14, At, Bt, Cref
    torch.cuda.empty_cache()
    counts_surface = reference_surface(tdat, cuda_collectives)
    counts_reshard = reshard_spmd(tdat)
    sfc = sort_fft_conv(tdat, cuda_collectives)

    # -- 6. attention: kernels, serving, sequence parallel -----------------
    attention_kernels(randn, errs)
    counts_serve = serving(tdat, dev)
    counts_sp = sequence_parallel(tdat)

    # -- 7. training: kernels, train_step, the data-parallel Trainer -------
    training_kernels(randn, errs)
    ring_gemm_kernels(randn, errs)
    counts_train = training(tdat, dev)
    counts_trainer = trainer_phase(tdat)
    counts_sp_train = sp_training(tdat, dev)

    # -- 8. ranks on several cards ------------------------------------------
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
    # the wgmma route with bf16 output (the wrapper's) and with f32 output
    # (the C entry with out_bf16 = 0)
    c32 = torch.empty(n4, n4, device=dev)
    wg = kbuild.ROUTES.index("wgmma")
    extra["gemm 4096^3 bf16"] = {
        "ms": time_ms(lambda: cuda_gemm.cuda_matmul(ab, bb)),
        "ms_f32_out": time_ms(lambda: cuda_gemm._gemm_fn()(
            ab.data_ptr(), bb.data_ptr(), c32.data_ptr(), n4, n4, n4, wg, 0,
            dev.index, torch.cuda.current_stream().cuda_stream)),
        "plain_ms": time_ms(lambda: cuda_gemm.matmul_plain(ab, bb)),
        "library_ms": time_ms(lambda: torch.matmul(ab, bb)),
        "bound_ms": bound(3 * n4 * n4 * 2, 2 * n4 ** 3, BF16_FLOPS)[0],
        "route": "wgmma"}
    del a, b, ab, bb, c32
    n16 = 16384
    a, b = randn(n16, n16), randn(n16, n16)
    extra["gemm 16384^3 f32"] = {
        "ms": time_ms(lambda: cuda_gemm.cuda_matmul(a, b)),
        "plain_ms": time_ms(lambda: cuda_gemm.matmul_plain(a, b)),
        "library_ms": time_ms(lambda: torch.matmul(a, b)),
        "bound_ms": bound(3 * n16 * n16 * 4, 2 * n16 ** 3, F32_FLOPS)[0],
        "route": "f32"}
    del a, b
    x = randn(ms, ns)
    lo1, hi1 = torch.zeros(1, ns, device=dev), torch.zeros(1, ns, device=dev)
    xin = conv_input(lo1, x, hi1)
    cells = ms * ns
    lap_ops = stencil_ops(LAPLACIAN_3X3)
    wts_rand = tuple(tuple(float(v) for v in row) for row in
                     np.random.default_rng(1).uniform(-1, 1, (3, 3)))
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
        "library_ms": time_ms(lambda: F.conv2d(xin, wk, padding=(0, 1))),
        "generic_ms": time_ms(lambda: cuda_stencil.stencil3x3_block(
            x, lo1, hi1, wts_rand))})
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
        "smem_bound_ms": k3_smem_bound_ms(cuda_stencil, ms, ns, K),
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
    # each block read once, each rank's whole array written once
    bms, bby = bound((P4 + P4 * P4) * blk_bytes, 0, F32_FLOPS)
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
                                       for x in blocks]),
        "device_ms": device_ms(lambda: cuda_collectives
                               .ring_allgather_matmul_rhs(blocks, b_bl))})
    del blocks, b_bl
    kernels += attention_timings(randn)
    kernels += training_timings(randn)
    kernels += ring_gemm_timings(randn, extra)
    for kern in kernels:
        name = kern["name"]
        kern["launches"] = (
            counts if name in counts_main else counts_serve
            if name == "flash_attention" else counts_sp
            if name in ("flash_attention_hop", "ring_attention")
            else counts_train if name.startswith("flash_attention_bwd")
            else counts_trainer if name == "reduce_scatter"
            else counts_sp_train if name in ("allgather_matmul",
                                             "matmul_reducescatter")
            else counts_dist)[name]
        kern["max_abs_err"] = errs[name]
        if name in counts_surface:
            kern["surface_launches"] = counts_surface[name]
        if name in counts_reshard:
            kern["reshard_spmd_launches"] = counts_reshard[name]
        if name == "all_to_all":
            kern["sort_fft_conv_launches"] = sum(sfc["k11"].values())
            kern["complex64"] = sfc["k11_complex64"]
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


def device_breakdown(prof, wall_ms: float, prof_ms: float, what: str) -> None:
    """Print the device time of one profiled step by kernel and by kind,
    and the device's idle share of the same step's wall time measured
    without the profiler (``wall_ms``; ``prof_ms`` with it)."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    kinds = {"flash attention forward (K5, K8 hops)": ("flash_kernel",
                                                       "flash_mma_kernel",
                                                       "flash_wgmma_kernel"),
             "attention backward (K6, K7)": ("bwd_dq", "bwd_dkv"),
             "all-gather / reduce-scatter (K10, K12)": (
                 "copy_boxes", "reduce_run", "reduce_pieces"),
             "ring GEMMs (K13, K14, K15)": ("ring_ag_mm", "ring_mm_rs"),
             "GEMMs (cuBLAS)": ("gemm", "cutlass", "xmma", "nvjet"),
             }
    by_kind = dict.fromkeys(list(kinds) + ["other (elementwise, norms, "
                                           "softmax, copies)"], 0.0)
    for e in kernels:
        kind = next((k for k, keys in kinds.items()
                     if any(x in e.key for x in keys)), None) or \
            list(by_kind)[-1]
        by_kind[kind] += e.self_device_time_total / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    print(json.dumps({"profile": what, "wall_ms": wall_ms,
                      "profiled_wall_ms": prof_ms, "device_busy_ms": busy,
                      "idle_share": 1.0 - busy / wall_ms,
                      "by_kind_ms": by_kind,
                      "top_kernels_ms": [[e.key[:90], e.count,
                                          e.self_device_time_total / 1e3]
                                         for e in top]}))


def profile_training() -> int:
    """``--profile``: one full-width ``train_step`` (bf16, one rank), one
    4-rank ``Trainer`` step (f32) and one 4-rank sequence-parallel SGD step
    (bf16), each after warm-up steps, under ``torch.profiler``; prints
    where the device time goes."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile
    import distributedarrays_tpu_torch as tdat
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    tdat.kbuild.build(["attention", "attention_bwd", "collectives"])
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    T = tdat.transformer
    tdat.init()
    dev = tdat.device_of(0)
    cfg = T.Config(*TRAIN_CFG, torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(7)
    model = T.init_params(cfg, gen, dev)
    tokens = torch.randint(0, cfg.vocab, (4, TRAIN_CFG[5] + 1),
                           generator=gen, device=dev, dtype=torch.int32)
    step = lambda: T.train_step(model, tokens, TRAIN_LR, cfg)
    wall = statistics.median(wall_ms(step) for _ in range(3))
    with profile(activities=acts) as prof:
        pwall = wall_ms(step)
    device_breakdown(prof, wall, pwall, "train_step (4, 2049) bf16, 1 rank")
    del model
    torch.cuda.empty_cache()
    tdat.init(nranks=4)
    with tdat.train.Trainer(tdat.train.transformer_task(**TRAINER_CFG),
                            tdat.train.adam(1e-4)) as t:
        wall = statistics.median(wall_ms(t.step_once) for _ in range(3))
        with profile(activities=acts) as prof:
            pwall = wall_ms(t.step_once)
    device_breakdown(prof, wall, pwall,
                     "Trainer step, 4 ranks on one card, f32")
    SP = tdat.sp_transformer
    scfg = SP.SPConfig(*SP_CFG, torch.bfloat16)
    shards = SP.shard_params(SP.init_params(scfg, gen, dev), [0, 1, 2, 3])
    stokens = torch.randint(0, scfg.vocab, (1, SP_CFG[5]), generator=gen,
                            device=dev, dtype=torch.int32)
    sstep = SP.make_train_step([0, 1, 2, 3], scfg)
    sp_step = lambda: sstep(shards, stokens, SP_LR)
    sp_step()
    wall = statistics.median(wall_ms(sp_step) for _ in range(5))
    with profile(activities=acts) as prof:
        pwall = wall_ms(sp_step)
    device_breakdown(prof, wall, pwall, f"sequence-parallel SGD step, "
                     f"SPConfig{SP_CFG} bf16, (1, {SP_CFG[5]}) tokens, 4 "
                     "ranks on one card")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(across_cards_only() if sys.argv[1:] == ["--across-cards"]
             else profile_training() if sys.argv[1:] == ["--profile"]
             else ring_gemms_only() if sys.argv[1:] == ["--ring-gemms"]
             else k1_k9_only() if sys.argv[1:] == ["--k1-k9"]
             else attn_times(*sys.argv[2:3])
             if sys.argv[1:2] == ["--time-attn"]
             else k4_k8_times(*sys.argv[2:3])
             if sys.argv[1:2] == ["--time-k4-k8"]
             else k3_k10_times(*sys.argv[2:3])
             if sys.argv[1:2] == ["--time-k3-k10"]
             else k3_k10_only() if sys.argv[1:] == ["--k3-k10"]
             else surface_only() if sys.argv[1:] == ["--surface"]
             else reshard_spmd_only() if sys.argv[1:] == ["--reshard-spmd"]
             else sort_fft_conv_only() if sys.argv[1:] == ["--sort-fft-conv"]
             else k1_k9_times(*sys.argv[2:3])
             if sys.argv[1:2] == ["--time-k1-k9"]
             else ring_gemm_times(*sys.argv[2:3])
             if sys.argv[1:2] == ["--time-ring-gemms"] else main())
