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
   Then the solvers phase (``solvers_phase``: bench.py's ``cg_poisson``
   row on K2, MG-PCG, the chaos solve, the small solves) and the serving
   phase (``serve_phase``; ``python3 chip_smoke.py --serve`` alone),
   telemetry and the memory ledger on: bench.py's ``serve_decode`` row at
   its size on one rank (``TinyLM()``, pages of 16 tokens in blocks of 4,
   512 pages, 32-token prompts from ``default_rng(7)``, a warm pass, then
   a 3 s open loop at twice the sustainable sequence rate; the row's keys
   and the KV peak from the ledger); the ring prefill through
   ``DecodeEngine.submit`` on 4 ranks of the card at the flagship
   attention's width (``TinyLM(heads=16, head_dim=64, max_pos=8192)``,
   prompts of 7997-8000 tokens, 16 new tokens each): 16 K9 launches a
   fresh prefill (10 on the f32 route), the last prefill row within 1e-5
   of the same engine on ``reference_attention`` (float32 torch on the
   card), every token and every decode step's attention output equal (bit
   for bit), and the same of a pool of two sequences, whose evicted
   sequences re-prefill, against the roomy run; prefill ms a
   sequence, K9's device time and share, the 8016-row KV read's ms;
   bench.py's ``serve_load`` row at its size (a 1024^2 f32 weight,
   ``torch.matmul`` of the stacked batch, 30 unloaded requests, a 3 s open
   loop at twice the sustainable rate); ``SolverService`` with bench.py's
   ``cg_poisson`` system, the streamed iterations and the answer bit for
   bit against a direct ``cg`` (K2 iterations + 1 launches), and a dense
   256-unknown system on 4 ranks (one K10 a matvec); the ledger's live
   bytes on the card against the live DArrays' rank tensors, back to its
   base after each engine and server closes, the allocator's growth over
   the phase at least the ledger's peak, and a flight bundle's memory
   census.
   Then the models phase (``models_phase``; ``python3 chip_smoke.py
   --models`` alone): the MoE layer at Mixtral-8x7B's widths (hidden 4096,
   FFN 14336, 8 experts, top-2, capacity factor 2.0, bf16; the experts are
   the JAX model's two-matrix GELU FFN, not Mixtral's SwiGLU) on 8 ranks
   of the card with 16384 tokens (2048 a rank, capacity 1024): exactly 2
   K11 launches a forward, the output and aux loss bit for bit against the
   same forward with the plain exchanges (``pall_to_all``), a small f32
   shape (8 experts of (64, 128), 256 tokens; top-1, top-2, and top-2 at
   capacity 2) against ``reference_moe`` on the card (<= 1e-4), ms a
   forward, tokens/s and K11 at the dispatch shape against its bound; the
   pipeline, 4 stages on 4 ranks (hidden 8192, 2 layers a stage, 16
   microbatches of 256, f32): ``pipeline_forward`` against
   ``reference_forward`` and 1F1B's loss and gradients against GPipe's
   (<= 1e-5 each), ms a forward and a step, and each step's peak bytes
   (1F1B's must be below GPipe's); k-means on 4 ranks (2^24 x 32 f32 points
   drawn on the card around 64 centres, k = 64, 20 iterations) against a
   whole-array plain Lloyd from the same ``C0`` (centroids <= 1e-4, labels
   equal), ms an iteration; ``pi_estimate(10**9, batches=10)`` within 5
   sigma of pi and ``expectation`` of ``abs`` over 10^8 draws within 5
   standard errors of sqrt(2/pi), draws/s.
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
   - telemetry on the card (``telemetry_phase``; ``python3 chip_smoke.py
     --telemetry`` alone): the main path's calls (``telemetry_workload``)
     twice each with telemetry disabled and with a journal, in turns (the
     wall difference is its cost), one warm 4-rank Trainer step
     journaled, then ``python -m distributedarrays_tpu_torch.telemetry
     doctor --json`` in a subprocess on the journal: the platform must
     read ``h100`` (the journal's ``device``/``platform`` event), every
     ``matmul`` and ``pallas.matmul`` span carry ``flops = 2mnk``, and no
     span that ends at a device synchronization (``train.step``) read
     above 1.05 of a peak uncapped; prints the top findings and every
     stamped span's fraction, capped and uncapped;
   - the tuning advisor on the card (``advise_phase``; ``python3
     chip_smoke.py --advise`` alone): a child process with
     ``CUDA_LAUNCH_BLOCKING=1`` (so each span ends with its kernels;
     ``--advise-journal``) journals K1 through ``matmul_impl = "pallas"``
     at 4096^3 f32 and bf16, the (4,1) 16384^2 f32 ``A @ B`` on
     ``matmul_impl_dist`` ``"torch"`` and ``"ring_ag"`` (K14) under one
     ``dispatch_key``, and a (4,1) -> (1,4) 16384^2 f32 ``copyto_`` (K11,
     which must launch there); then ``python -m
     distributedarrays_tpu_torch.telemetry advise --json`` on the journal,
     and ``advise --json --apply`` in a fresh process on a copy of the
     registry (it builds the 4-rank table its dispatch probe needs: no
     action may be skipped for a failed probe); in this process, the
     doctor, ``advise`` (a ``resweep`` and a ``dispatch`` action, the same
     as the command line's, and no ``rdma_chunks`` action: the port's
     reshard span carries no key for it) and ``apply`` with the default
     probes onto a registry in a temporary file
     (``DAT_TORCH_AUTOTUNE_CACHE``), printing each action's before and
     after probe medians and whether it was kept; K1 and K14 must launch
     during ``apply``; the
     dispatch tune reversed (the route its probes measured slower) must
     be rolled back, its entry and stamp reading exactly as before, with
     ``autotune.advisor_rollbacks`` and the ``autotune_regressed`` alert
     moved; the repo's cache file must be untouched.  Then
     ``profiling.trace`` around one main-path run (``telemetry_workload``)
     must name, among its kernel events, every kernel that ``kbuild``
     counted in it, and the run's wall time with and without the profiler
     (in turns, after a first traced run that starts the profiler);
   - the trainer's runtime tier (``train_runtime_phase``; ``python3
     chip_smoke.py --train-runtime`` alone) on the same task, Adam, 4 ranks
     (a checkpoint is 3 x 478 MB): (a) 4 steps with a checkpoint every 2
     and peer replicas (ms a step with and without a save, save s and GB/s,
     restore s from disk and from the replica, the replica restore with no
     disk read and bit for bit); (b) a trainer stopped after step 2 and a
     new one resuming on its directory to step 4, its losses against (a)'s
     (<= 1e-4, and whether bit-equal); (c) a ``device_loss`` plan at
     ``train.step`` of step 3 on rank 3: step 2 restored from the peer
     replica with ``checkpoint.disk_reads`` unchanged, the shrink onto ranks
     0-2 (``gather_put``, K10), then each step on 3 ranks 1 K10 and 3 K12;
     (d) a ``corrupt`` plan at ``checkpoint.read``: the latest step
     quarantined and step 2 restored;
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
     ms per step, training tokens/s and the peak device memory;
   - the GSPMD tp/dp layouts (``tp_dp_phase``; ``python3 chip_smoke.py
     --tp-dp`` alone): first C27-C29 on 4 ranks of the card (uint16 and
     uint32 operators, ``@``, extrema and scans, complex orderings and
     running extrema, against numpy; ``dmap`` of bool * 3 is int32); then
     the flagship at full width, ``Config(8192, 1024, 16, 8, 4, 2048,
     bf16)``, on ``make_mesh(4)`` (dp 2 x tp 2, 4 ranks of the card),
     tokens (4, 2049): three SGD ``train_step``s (lr 0.3) on
     ``shard_params``' Megatron layout, ``generate`` of 16 tokens after a
     (4, 16) prompt and one MLP step at [1024, 4096, 4096, 1024] bf16 on a
     batch of 8192, every kernel's count set to 0 before and read after
     (K5, K6, K7, K10 and K12 must launch; the loss must fall); the same
     three steps with the plain attention and the plain reduce-scatter and
     all-gather (no kernel launch; each loss within 1e-2, each unsharded
     parameter within 5e-2); generate's logits against one rank's on the
     unsharded parameters over the steps whose tokens agree (5e-2); the MLP
     step against one rank's; the step's wall and device ms beside one
     rank's ``train_step``, and K12's and K10's device ms in it, each line
     with the card's name and power limit.
8. With two or more cards, one rank per card with peer access: the
   all-gather, all-to-all and ring GEMM kernels against their plain
   versions on a 16384^2 f32 array, K13, K14 and K15 in bf16 at the
   sequence-parallel shapes on their ``wgmma_peer`` route, and K9 at S =
   8192 bf16, and their times.  With one card it prints why it did not
   run.
   ``python3 chip_smoke.py --across-cards`` builds the kernels and runs
   this phase alone.
   Then the multi-process phase (``multihost_phase``; ``python3
   chip_smoke.py --multihost`` alone): 4 child processes of the port on
   the one card (``--multihost-child``), one rank each, joined through a
   ``TCPStore`` on a free local port with a bounded start-up; a child that
   fails, or outlives ``MH_TIMEOUT_S``, fails the phase.  Each draws a
   16384^2 f32 DArray on (4, 1) spanning the processes and BASELINE's
   8192^2 chain ``sin(A) + B*C``; ``dsum(chain)`` and ``dsum(A*A)`` must be
   bit-equal to the single-process port's on 4 ranks of one process.
   ``gather_global`` of the 16384^2 array must launch K10's copy kernel
   once a process (``route_counts()["all_gather"]
   ["cross_process_region"]``: ``multihost.fetch_regions``'s region copy),
   reading the peers' chunks through CUDA IPC, bit-equal to the plain
   route (the pieces over gloo) and to one process's array
   (SHA-256); it is timed by CUDA events (the median of 7 batches of 10
   launches) with each process alone and with all four at once, beside
   ``Tensor.copy_`` from the IPC-opened peer chunks (cudaMemcpy, the
   library yardstick) and the plain route (3 calls); the
   bound is the bytes the processes read and write on the card (1 GiB
   read and 1 GiB written each) over 3.35 TB/s.  Then the ops across the
   processes (``multihost_ops``): the distributed GEMM of two 16384^2 f32
   DArrays on (2, 2) (one region launch a process fetches its A row and B
   column panels, no K1 launch; the gathered product bit-equal to one
   process's on 4 ranks, or within 1e-5 of its largest value; the
   panels bit-equal to the plain route; the fetch's launch, each
   process's ``torch.matmul`` and the whole call timed, beside one
   process's call); a relayout of the 16384^2 array from (4, 1) to
   (1, 4) (one launch a process, bit-equal to the plain route and to one
   process's array, beside one process's ``relayout_plain`` and K11);
   ``dtranspose`` on (2, 2) (no launch), ``dcumsum`` along 0 on (4, 1)
   and ``djit(torch.sin)`` (one launch) of 8192^2 arrays, each bit-equal
   to one process's; 50 rounds of fresh 4096^2 relayouts with
   ``torch.cuda.empty_cache()`` in every process between rounds, each
   right, no mapping open between calls and at most 3 open during one;
   and a gather after every process freed its array and allocated a new
   one.  Then the ops on the rank-list exchange (``multihost_legs``), at
   full width: ``run_spmd`` ``pshift(+1)`` of the 16384^2 array, ``dfft``
   along 0 and ``dfft2`` of an 8192^2 complex64 (4, 1) DArray, ``dsort``
   of ``drand(1e7)`` and ``drand(1e8)``, ``dconv2d`` of an 8192^2 f32
   (4, 1) image with 3x3 and 5x5 kernels, ``ring_attention`` and
   ``ulysses_attention`` at S = 8192, 16 heads of 64, bf16, causal,
   k-means on 2^24 x 32 f32 with k = 64 (5 iterations), and
   ``dmatmul_int8`` of a 16384^2 (4, 1) A with B whole.  Each leg's
   launches a process are held (``MH_LEG_LAUNCHES``: the exchanges' K10/
   K11 on the cross-process route and nothing else of them; K9's 4, 3 of
   them storing into the neighbour process's mapped slot and 10 of the
   16 accumulating over the four; K5's and K4's one), its result
   bit-equal to one process on 4 ranks of the card (SHA-256, layouts
   too), which is held against its whole-array library call at the
   leg's stated tolerance (``MH_*_TOL``, the error's Frobenius norm over
   the library result's; the shift and the sorts exactly), six legs also
   bit-equal to the plain gloo route (``MH_PLAIN_LEGS``), no peer
   mapping left open; and read: the whole call's host ms (its first call,
   then a warm one), the leg's largest exchange alone (the others at a
   barrier) and all four at once in one host window, each against its
   own bytes, ring attention's host ms a step.  Then an
   uneven 16383 x
   16384 ``distribute``, ``d + d`` and its gather; a checkpoint of a
   4096^2 process-spanning DArray saved and loaded on its saved cuts; the
   heartbeat census (process 3 stops heartbeating: processes 0-2 must see
   ``down_peer_processes() == {3}``, a ``"quorum"`` verdict on ranks 0-2
   and the elastic probe downing rank 3; process 3 ``"minority"``); and
   the 4 journals merged by ``telemetry.merge_journals`` into one
   timeline (every process's marker before a ``sync_hosts`` barrier ahead
   of every marker after it), written as a Perfetto trace to
   ``build/multihost_trace.json``.  Before the census each process runs
   the data-parallel ``Trainer`` on its one rank
   (``multihost_trainer``): ``transformer_task`` at the trainer phase's
   widths, f32, 3 Adam steps, each launching 1 K10
   (``cross_process_region``), 1 K12 (``cross_process``) and 8 each of
   K5/K6/K7, the losses and flat parameters bit-equal to one process on 4
   ranks (``trainer_reference``), then a save and a resume; it prints
   each process's first and warm step ms, the host ms of every K10 and K12
   call and the peak memory.  Every child's exporter (armed by
   ``DA_TPU_STREAM_AGG``) streams to one aggregator the parent serves on
   localhost; ``advertise_exporter()`` must return True in each child and
   the aggregator's snapshot show 4 hosts.  After the Trainer each child
   runs the GSPMD tp/dp step (``multihost_tp_dp``: ``MH_TP_CFG``, the
   flagship's width at 2 layers and seq 512, bf16, two SGD steps on
   ``make_mesh(4)``), its losses and unsharded parameters bit-equal to one
   process on 4 ranks, with K12 and K10 on their cross-process routes;
   then the protocol model's conformance (``multihost_protocol``): one
   call each of K9, K13, K14, K15, K10 and K12 on bf16 rank lists, and
   the tp/dp step, with their events recorded (``ring_schedules.
   recording``) and every call held against its schedule
   (``ring_schedules.conform``); a departure fails the phase.  The parent
   runs ``python -m distributedarrays_tpu_torch.analysis
   verify-protocols`` before the children start; it must exit 0.
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
   row those of the sort, FFT and conv phase (``sort_fft_conv_launches``),
   its complex64 timing (``complex64``) and the MoE's launches
   (``models_launches``), and the all-gather and reduce-scatter rows those
   of the runtime tier's device-loss run (``train_runtime_launches``).

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


# the solvers phase: bench.py's cg_poisson row (cfg_cg_poisson) at its own
# size, the multigrid solve, the chaos solve
CG_N, CG_TOL, CG_MAXITER = 1024, 1e-6, 6000
MG_N = 4096
CHAOS_N, CHAOS_AT = 1024, 25
CG_PROFILE_ITERS = 300
# a solve's residual recomputed with the plain step against the solver's
# own recurrence, relative to ||b||.  In float32 the recurrence drifts from
# the true residual over thousands of iterations: at 1024^2, stopping at
# 1e-6, the true one reads 2.6e-4 for the port on an H100 and 3.17e-4 for
# the JAX package's float32 CG on the CPU (tools/cg_residual_witness.py),
# whose solve stopped at a quarter of its iterations reads 3.5e-3.  The
# bound sits between the sound readings and that one.
TOL_TRUE_RES = 1e-3
# the chaos solve's answer against the fault-free one (read 1.438e-6 at
# 1024^2 on an H100)
TOL_CHAOS = 1e-4
# the small solves of small_solves: the float64 residual and the answer
# against the float64 oracle (the solves stop at 1e-6; read 3e-7 to 1.2e-6
# on 4 CPU ranks)
TOL_SMALL = 1e-5


def true_residual(tdat, op, x, b) -> float:
    """``||b - A x|| / ||b||`` with ``A x`` by the plain stencil step on the
    card (no kernel)."""
    ax = tdat.stencil3x3(x, op.weights, use_kernel=False)
    r = b - ax
    out = float(tdat.dnorm(r)) / float(tdat.dnorm(b))
    for d in (ax, r):
        d.close()
    return out


def small_solves(tdat, S) -> dict:
    """The other operators and solvers on 4 ranks of the card, each on a
    256-unknown system held against its float64 oracle: CG on the 16^2
    Poisson matrix as a ``DenseOperator`` (its matvec is the port's
    ``matmul``) and as a ``SparseOperator`` (torch sparse blocks, the halo
    exchange), BiCGStab and restarted GMRES on a nonsymmetric banded
    matrix.  Prints what each launched."""
    from distributedarrays_tpu_torch.utils import kbuild
    poisson = S.poisson2d_dense(16, 16)
    n = poisson.shape[0]
    banded = (3.0 * np.eye(n) - np.eye(n, k=1)
              + 0.5 * np.eye(n, k=-1)).astype(np.float32)
    rhs = np.random.default_rng(7).standard_normal(n).astype(np.float32)
    out = {}
    for name, mat, make, solve in (
            ("cg dense", poisson, S.DenseOperator, S.cg),
            ("cg sparse", poisson, S.SparseOperator, S.cg),
            ("bicgstab sparse", banded, S.SparseOperator, S.bicgstab),
            ("gmres(8) dense", banded, S.DenseOperator,
             lambda *a, **k: S.gmres(*a, restart=8, **k))):
        op = make(mat, procs=[0, 1, 2, 3])
        procs, dist = op.vector_layout()
        b = tdat.distribute(rhs, procs=procs, dist=list(dist))
        kbuild.reset_launches()
        res = solve(op, b, tol=CG_TOL, maxiter=1000)
        torch.cuda.synchronize()
        launched = {k: v for k, v in kbuild.launch_counts().items() if v}
        x = res.x.full().double().cpu().numpy()
        a64 = mat.astype(np.float64)
        oracle = np.linalg.solve(a64, rhs.astype(np.float64))
        true = float(np.linalg.norm(rhs - a64 @ x) / np.linalg.norm(rhs))
        print(f"  {name} {n} on ranks {procs}: {res.outcome} in "
              f"{res.iterations} iterations, launches {launched}")
        if not res.converged:
            raise AssertionError(f"{name}: {res.outcome}")
        check(f"{name}: ||b - A x|| / ||b|| in float64", true, TOL_SMALL)
        check(f"{name}: x against the float64 oracle",
              float(np.linalg.norm(x - oracle) / np.linalg.norm(oracle)),
              TOL_SMALL)
        out[name] = {"iterations": res.iterations, "launches": launched}
        res.x.close()
        b.close()
        if hasattr(op, "close"):
            op.close()
    return out


def solvers_phase(tdat, errs: dict) -> dict:
    """``solvers``: the CG Poisson solve of bench.py's ``cg_poisson`` row
    (``StencilOperator((1024, 1024))``, ``b`` from ``default_rng(7)``,
    ``cg(tol=1e-6, maxiter=6000)``) on one rank, whose every operator apply
    is one K2 launch (``stencil_step`` on the Poisson weights, held bit for
    bit against its plain step first); the multigrid-preconditioned CG on
    ``StencilOperator((4096, 4096))`` over 4 ranks of the card (K2 on every
    level whose grid splits); the chaos solve (4 ranks, 1024^2, a
    ``device_loss`` of rank 3 at ``solver.iterate``) that shrinks onto the
    survivors through the reshard (K10/K11) and converges with one
    recovery to the fault-free answer; K2 held bit for bit against the
    plain step on the 4-rank apply, a V-cycle and the survivors' apply;
    the dense, sparse, BiCGStab and GMRES solves of ``small_solves``; and
    a divergence-checked SPMD program on the card next to a divergent one
    that must raise.
    Telemetry is on: the ``solver.spmv`` spans count the applies, the
    shrink's ``reshard`` span carries ``intra_bytes``/``cross_bytes``.
    Returns the phase's launch counts and readings."""
    from distributedarrays_tpu_torch import telemetry as tm
    from distributedarrays_tpu_torch.analysis import divergence
    from distributedarrays_tpu_torch.ops.cuda_stencil import (
        _apply3x3, stencil3x3_block)
    from distributedarrays_tpu_torch.resilience import elastic, faults
    from distributedarrays_tpu_torch.telemetry import perf
    from distributedarrays_tpu_torch.utils import kbuild
    S = tdat.solvers
    print("phase solvers")
    t_phase = time.perf_counter()
    tdat.d_closeall()
    faults.clear()
    elastic.manager().reset()
    tm.enable()
    out = {"launches": {}, "ms": {}}

    # -- 1 rank: the cg_poisson row ----------------------------------------
    tdat.init()
    n = CG_N
    op = S.StencilOperator((n, n))
    procs, dist = op.vector_layout()
    rhs = np.random.default_rng(7).standard_normal((n, n)).astype(
        np.float32)
    b = tdat.distribute(rhs, procs=procs, dist=list(dist))
    blk = b.part((0, 0))
    z = torch.zeros(1, n, device=blk.device)
    errs["stencil_step"] = max(errs["stencil_step"], exact(
        f"K2 {n}^2 on the Poisson weights against its plain step",
        stencil3x3_block(blk, z, z, op.weights),
        _apply3x3(torch.cat([z, blk, z]), op.weights)))

    def solve():
        return S.cg(op, b, tol=CG_TOL, maxiter=CG_MAXITER)
    kbuild.reset_launches()
    tm.reset()
    res = solve()
    torch.cuda.synchronize()
    counts = kbuild.launch_counts()
    applies = res.iterations + 1          # the initial residual, then one
    spmv = tm.span_stats()["solver.spmv"]["count"]
    routes = kbuild.route_counts()["stencil_step"]
    print(f"  cg {n}^2 1 rank: {res.outcome} in {res.iterations} "
          f"iterations, residual {res.residual:.6e}, K2 launches "
          f"{counts['stencil_step']} (routes {routes}), solver.spmv spans "
          f"{spmv}")
    if not res.converged:
        raise AssertionError(f"cg {n}^2: {res.outcome} after "
                             f"{res.iterations} iterations")
    if counts["stencil_step"] != applies or spmv != applies:
        raise AssertionError(f"cg {n}^2: {applies} applies, K2 launched "
                             f"{counts['stencil_step']} times, {spmv} "
                             "solver.spmv spans")
    nb = float(tdat.dnorm(b))
    true = true_residual(tdat, op, res.x, b)
    check(f"cg {n}^2 residual by the plain step against the solver's "
          f"({res.residual / nb:.6e} of ||b||)",
          abs(true - res.residual / nb), TOL_TRUE_RES)
    res.x.close()
    out["cg_iterations"] = res.iterations
    out["cg_residual"] = res.residual
    out["cg_true_residual"] = true
    out["launches"]["cg"] = counts
    # time to tolerance: the second solve, on the host clock
    t_solve = [None]

    def timed():
        r = solve()
        t_solve[0] = r.iterations
        r.x.close()
    out["ms"]["cg_time_to_tolerance"] = wall_ms(timed)
    if t_solve[0] != res.iterations:
        raise AssertionError(f"cg {n}^2: the timed solve took {t_solve[0]} "
                             f"iterations, the first {res.iterations}")
    per_iter = perf.spmv_cost(5 * n * n, n * n, 4,
                              index_itemsize=0)["bytes_hbm"] + 10 * n * n * 4
    out["cg_gbps"] = res.iterations * per_iter / (
        out["ms"]["cg_time_to_tolerance"] / 1e3) / 1e9
    out["cg_bytes_per_iteration"] = per_iter
    # a fixed number of iterations under the profiler: device busy time,
    # kernel launches, host us a launch
    from torch.profiler import ProfilerActivity, profile

    def fixed():
        S.cg(op, b, tol=1e-30, maxiter=CG_PROFILE_ITERS).x.close()
    fixed()
    wall = wall_ms(fixed)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pwall = wall_ms(fixed)
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    nlaunch = sum(e.count for e in kern)
    k2 = sum(e.self_device_time_total for e in kern
             if "step_kernel" in e.key) / 1e3
    out["cg_profile"] = {
        "iterations": CG_PROFILE_ITERS, "wall_ms": wall,
        "profiled_wall_ms": pwall, "device_busy_ms": busy,
        "idle_share": 1.0 - busy / wall, "kernel_launches": nlaunch,
        "launches_per_iteration": nlaunch / CG_PROFILE_ITERS,
        "host_us_per_launch": wall * 1e3 / nlaunch,
        "k2_device_ms_per_apply": k2 / (CG_PROFILE_ITERS + 1),
        "top_kernels_ms": [[e.key[:60], e.count,
                            e.self_device_time_total / 1e3] for e in
                           sorted(kern, key=lambda e:
                                  -e.self_device_time_total)[:8]]}
    print(f"  cg {n}^2: time to tolerance "
          f"{out['ms']['cg_time_to_tolerance']:.1f} ms, "
          f"{out['cg_gbps']:.1f} GB/s; {CG_PROFILE_ITERS} iterations "
          f"{wall:.1f} ms wall, {busy:.1f} ms busy, {nlaunch} launches, "
          f"{wall * 1e3 / nlaunch:.1f} host us a launch")
    b.close()
    del blk, z

    # -- 4 ranks: multigrid-preconditioned CG on 4096^2 ----------------------
    tdat.init(nranks=4)
    P = 4
    nm = MG_N
    op4 = S.StencilOperator((nm, nm))
    procs, dist = op4.vector_layout()
    rhs4 = np.random.default_rng(7).standard_normal((nm, nm)).astype(
        np.float32)
    b4 = tdat.distribute(rhs4, procs=procs, dist=list(dist))
    mgp = S.Multigrid(op4)
    kbuild.reset_launches()
    tm.reset()
    mg, mg_ms = event_ms(lambda: S.cg(op4, b4, tol=CG_TOL,
                                      maxiter=CG_MAXITER, M=mgp))
    torch.cuda.synchronize()
    counts = kbuild.launch_counts()
    levels = mgp.levels((nm, nm), P)
    # the initial residual and one apply an iteration, and a V-cycle an
    # iteration (on each split level the smoothing sweeps and one
    # residual, a K2 launch each), each on every rank
    sweeps = mgp.presmooth + mgp.postsmooth + 1
    want = P * (mg.iterations + 1 + mg.iterations * sweeps * levels)
    print(f"  mg-pcg {nm}^2 4 ranks: {mg.outcome} in {mg.iterations} "
          f"iterations ({mg_ms:.1f} ms) against plain cg {n}^2 "
          f"{res.iterations}; K2 launches {counts['stencil_step']} "
          f"({levels} split levels: {want} expected)")
    if not mg.converged or not mg.iterations < res.iterations / 2:
        raise AssertionError(f"mg-pcg {nm}^2: {mg.outcome} in "
                             f"{mg.iterations} iterations")
    if counts["stencil_step"] != want:
        raise AssertionError(f"mg-pcg: K2 launched {counts['stencil_step']}"
                             f" times, {want} expected")
    true4 = true_residual(tdat, op4, mg.x, b4)
    check(f"mg-pcg {nm}^2 residual by the plain step against the solver's",
          abs(true4 - mg.residual / float(tdat.dnorm(b4))), TOL_TRUE_RES)
    out["mg_iterations"] = mg.iterations
    out["mg_levels"] = levels
    out["ms"]["mg_pcg"] = mg_ms
    out["launches"]["mg_pcg"] = counts
    mg.x.close()
    # K2 on the solver's own shapes, bit for bit against the plain step:
    # one 4-rank apply (1024 x 4096 blocks, live halo rows) and one V-cycle
    # (every split level, down to 8 x 32 blocks)
    op4p = S.StencilOperator((nm, nm), use_kernel=False)
    for what, got, ref in (
            ("apply", op4.apply(b4), op4p.apply(b4)),
            ("V-cycle", mgp.apply(b4), S.Multigrid(op4p).apply(b4))):
        errs["stencil_step"] = max(errs["stencil_step"], exact(
            f"mg {nm}^2 4 ranks: one {what} on K2 against the plain step",
            got.full(), ref.full()))
        got.close()
        ref.close()
    b4.close()
    del rhs4

    # -- 4 ranks: chaos ------------------------------------------------------
    nc = CHAOS_N
    opc = S.StencilOperator((nc, nc))
    procs, dist = opc.vector_layout()
    bc = tdat.distribute(rhs, procs=procs, dist=list(dist))
    free = S.cg(opc, bc, tol=CG_TOL, maxiter=CG_MAXITER)
    if not free.converged or free.recoveries:
        raise AssertionError(f"fault-free cg: {free.outcome}")
    x_free = free.x.full()
    free.x.close()
    faults.configure([{"site": "solver.iterate", "action": "device_loss",
                       "at": CHAOS_AT, "count": 1, "device": 3}], seed=1234)
    kbuild.reset_launches()
    tm.reset()
    opx = S.StencilOperator((nc, nc))
    chaos = S.cg(opx, bc, tol=CG_TOL, maxiter=CG_MAXITER)
    torch.cuda.synchronize()
    counts = kbuild.launch_counts()
    moved = [s["labels"] for s in tm.spans("reshard")
             if s["labels"]["op"] == "elastic"]
    pids = [int(p) for p in chaos.x.pids.flat]
    print(f"  chaos cg {nc}^2 4 ranks: {chaos.outcome} in "
          f"{chaos.iterations} iterations (fault-free {free.iterations}), "
          f"recoveries {chaos.recoveries}, history {faults.history()}, "
          f"x on ranks {pids}, K10 {counts['all_gather']} K11 "
          f"{counts['all_to_all']} launches, shrink moves "
          f"{[(m['strategy'], m['intra_bytes'], m['cross_bytes']) for m in moved]}")
    if not chaos.converged or chaos.recoveries != 1 or 3 in pids:
        raise AssertionError(f"chaos cg: {chaos.outcome}, recoveries "
                             f"{chaos.recoveries}, ranks {pids}")
    if counts["all_gather"] + counts["all_to_all"] == 0 or not moved:
        raise AssertionError("the shrink ran no copy kernel")
    if not all("intra_bytes" in m and "cross_bytes" in m for m in moved):
        raise AssertionError("a reshard span lacks intra/cross bytes")
    truec = true_residual(tdat, opc, chaos.x, bc)
    check("chaos cg residual by the plain step against the solver's",
          abs(truec - chaos.residual / float(tdat.dnorm(bc))), TOL_TRUE_RES)
    # both solves meet the tolerance: the difference of the two answers
    # is within what that residual allows (||A^-1|| ||r||)
    check("chaos cg answer against the fault-free one",
          rel_err(chaos.x.full().to(x_free.device), x_free), TOL_CHAOS)
    out["chaos"] = {"iterations": chaos.iterations,
                    "fault_free_iterations": free.iterations,
                    "recoveries": chaos.recoveries,
                    "ranks_after": pids,
                    "shrink_strategies": [m["strategy"] for m in moved]}
    out["launches"]["chaos"] = counts
    # K2 on the survivors' blocks, bit for bit against the plain step
    errs["stencil_step"] = max(errs["stencil_step"], exact(
        f"chaos {nc}^2 on ranks {pids}: one apply on K2 against the plain "
        "step", opx.apply(chaos.x).full(), S.StencilOperator(
            (nc, nc), procs=pids, use_kernel=False).apply(chaos.x).full()))
    chaos.x.close()
    bc.close()
    faults.clear()
    elastic.manager().reset()
    out["small"] = small_solves(tdat, S)
    out["launches"]["small"] = {
        k: sum(r["launches"].get(k, 0) for r in out["small"].values())
        for k in kbuild.KERNELS}

    # -- divergence checking on the card -------------------------------------
    os.environ["DA_TPU_CHECK_DIVERGENCE"] = "1"
    try:
        def agree():
            me = tdat.myid()
            t = torch.full((4,), float(me), device=tdat.device_of(me))
            tdat.barrier()
            g = tdat.gather_spmd(t, 0)  # dalint: disable=DAL010 — the payload's shape is (4,) on every rank; only its fill value is the rank's
            return None if g is None else float(torch.stack(g).sum())

        def diverge():
            if tdat.myid() == 2:  # dalint: disable=DAL010 — seeded divergence: the runtime checker's fixture on the card must catch it
                tdat.bcast(None, 0)  # dalint: disable=DAL001 — seeded divergence: the runtime checker's fixture on the card must catch it
            else:
                tdat.barrier()  # dalint: disable=DAL001 — seeded divergence: the runtime checker's fixture on the card must catch it
        got = tdat.spmd(agree, pids=[0, 1, 2, 3])
        if got[0] != 4.0 * (0 + 1 + 2 + 3):
            raise AssertionError(f"checked spmd program gave {got}")
        try:
            tdat.spmd(diverge, pids=[0, 1, 2, 3], timeout=60)
        except divergence.CollectiveDivergenceError as e:
            print(f"  divergent program: {str(e).splitlines()[0]}")
        else:
            raise AssertionError("the divergent program was not caught")
    finally:
        del os.environ["DA_TPU_CHECK_DIVERGENCE"]
    tdat.d_closeall()
    torch.cuda.empty_cache()
    tdat.init()
    print(f"  solvers {time.perf_counter() - t_phase:.1f} s")
    print(json.dumps({"solvers": out}))
    return out


def solvers_only() -> int:
    """``--solvers``: build the GEMM, stencil and collective kernels and
    run the solvers phase alone (``solvers_phase``)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import distributedarrays_tpu_torch as tdat
    from distributedarrays_tpu_torch.utils import kbuild
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = gpu_name()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    kbuild.build(["gemm", "stencil", "collectives"])
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    errs = {k: 0.0 for k in kbuild.KERNELS}
    res = solvers_phase(tdat, errs)
    print(json.dumps({"solvers_launches": res["launches"], "gpu": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# the serving phase: bench.py's serve_decode and serve_load rows at their
# sizes, the ring prefill through the decode engine at the flagship
# attention's width, the solve service, and the memory ledger on the card
SERVE_WINDOW_S = 3.0
# the flagship attention's width through TinyLM: 16 heads of 64, prompts of
# 7997..8000 tokens (three of them not a multiple of the 4 ranks, so the
# ring pads them), 16 new tokens each
RING_HEADS, RING_HEAD_DIM, RING_MAX_POS = 16, 64, 8192
RING_PROMPTS = (8000, 7999, 7998, 7997)
RING_NEW = 16
RING_PAGE, RING_BLOCK = 16, 16
# a pool that holds two of the four sequences, so the third and fourth
# evict (and the evicted re-prefill): 63 blocks of 16 pages
RING_TIGHT_PAGES = 1008
# one fresh prefill on 4 ranks: 4 ranks x 4 ring steps, 10 of them
# accumulating (the causal plan skips 6)
K9_PER_PREFILL, K9_STEPS_PER_PREFILL = 16, 10
SERVE_LOAD_N = 1024
SERVICE_DENSE_N = 16          # the 16^2 Poisson matrix as a dense system


def percentile(xs, q: float) -> float:
    """bench.py's index rule: sorted(xs)[int(q * (len - 1))]."""
    xs = sorted(xs)
    return xs[int(q * (len(xs) - 1))] if xs else 0.0


def ledger_matches(tdat, M, dev, what: str) -> int:
    """The ledger's live bytes on ``dev`` against the sum of every live
    DArray's rank tensors' ``nbytes`` there; returns that sum."""
    live = [d for d in tdat.live_arrays() if isinstance(d, tdat.DArray)]
    want = sum(t.nbytes for d in live for t in d._parts.flat
               if t.device == dev)
    got = M.live_bytes(dev)
    print(f"  ledger {what}: {got} B on {dev}, rank tensors {want} B "
          f"({len(live)} DArrays)")
    if got != want:
        raise AssertionError(f"ledger {what}: live_bytes({dev}) {got} != "
                             f"{want}, the live rank tensors' bytes")
    return want


def serve_decode_row(tdat, serve, M) -> dict:
    """bench.py's ``serve_decode`` row at its size on one rank: a warm
    pass (the second sequence's time is the single-stream rate), then a 3
    s open loop at twice the engine's batch-sustainable sequence rate."""
    import threading
    model = serve.TinyLM()
    max_new = 16
    eng = serve.DecodeEngine(
        model,
        serve.PagedKVCache(serve.KVCacheConfig(
            heads=model.heads, head_dim=model.head_dim,
            page_tokens=16, block_pages=4, max_pages=512)),
        serve.DecodeConfig(max_new_tokens=max_new, poll_s=0.001,
                           max_sequences=64, token_budget=512,
                           min_ring_tokens=64, default_deadline_s=120.0))
    rng = np.random.default_rng(7)

    def prompt():
        return rng.integers(0, model.vocab, size=32).tolist()

    lock = threading.Lock()
    ttfts, gaps = [], []
    base = M.live_bytes()
    kv_peak = [0]
    stop = threading.Event()

    def monitor():
        while not stop.is_set():
            kv_peak[0] = max(kv_peak[0], M.live_bytes() - base)
            time.sleep(0.002)

    def tracked():
        t0 = time.monotonic()
        last = [t0]

        def cb(kind, _v):
            if kind != "token":
                return
            now = time.monotonic()
            with lock:
                (ttfts if last[0] == t0 else gaps).append(now - last[0])
                last[0] = now
        s = eng.submit(prompt())
        s.add_listener(cb)
        return s
    try:
        eng.submit(prompt()).result(timeout=120)
        t0 = time.monotonic()
        eng.submit(prompt()).result(timeout=120)
        seq_s = max(time.monotonic() - t0, 1e-4)
        single = max_new / seq_s
        slo_s = 20.0 * (seq_s / max_new)
        interval = 1.0 / (2.0 * eng.config.max_decode_batch / seq_s)
        mon = threading.Thread(target=monitor, daemon=True)
        mon.start()
        streams, shed = [], 0
        t_start = time.monotonic()
        while time.monotonic() - t_start < SERVE_WINDOW_S:
            try:
                streams.append(tracked())
            except serve.Overloaded:
                shed += 1
            time.sleep(interval)
        for s in streams:
            s.result(timeout=120)
        duration = time.monotonic() - t_start
        stop.set()
        mon.join(2.0)
        with lock:
            tt, gp = sorted(ttfts), sorted(gaps)
        delivered = sum(len(s.tokens) for s in streams)
        within = len([g for g in gp if g <= slo_s]) + \
            len([t for t in tt if t <= slo_s])
        offered = len(streams) + shed
        row = {
            "serve_decode_nranks": tdat.nranks(),
            "serve_decode_single_stream_tokens_per_s": single,
            "serve_decode_offered_tokens_per_s":
                offered * (max_new + 1) / duration,
            "serve_decode_tokens_per_s": delivered / duration,
            "serve_decode_slo_s": slo_s,
            "serve_decode_at_slo_tokens_per_s": within / duration,
            "serve_decode_ttft_p50_s": percentile(tt, 0.5),
            "serve_decode_ttft_p99_s": percentile(tt, 0.99),
            "serve_decode_token_p50_s": percentile(gp, 0.5),
            "serve_decode_token_p99_s": percentile(gp, 0.99),
            "serve_decode_shed_frac": shed / max(offered, 1),
            "serve_decode_kv_hbm_peak_bytes": kv_peak[0],
            "serve_decode_evictions": eng.stats()["cache"]["evictions"],
            "admitted_sequences": len(streams),
        }
        if not streams or delivered != len(streams) * max_new:
            raise AssertionError(f"serve_decode: {delivered} tokens for "
                                 f"{len(streams)} sequences")
    finally:
        stop.set()
        eng.close()
    return row


def ring_engine(tdat, serve, prompts, *, ring: bool, max_pages: int):
    """The 4 prompts through a ``DecodeEngine`` on the current ranks at the
    flagship attention's width; returns (token lists, engine stats, every
    decode step's attention output keyed by (context length, the first K
    element): at this width the streams repeat one token, so the outputs
    carry the cache's bit-identity checks)."""
    from distributedarrays_tpu_torch.serve import decode as SD
    model = serve.TinyLM(heads=RING_HEADS, head_dim=RING_HEAD_DIM,
                         max_pos=RING_MAX_POS, seed=0)
    steps = {}
    real = SD._decode_attention

    def rec(q, K, V):
        o = real(q, K, V)
        steps[(int(K.shape[0]), float(K[0, 0, 0]))] = o.clone()
        return o
    eng = serve.DecodeEngine(
        model,
        serve.PagedKVCache(serve.KVCacheConfig(
            heads=RING_HEADS, head_dim=RING_HEAD_DIM,
            page_tokens=RING_PAGE, block_pages=RING_BLOCK,
            max_pages=max_pages)),
        serve.DecodeConfig(max_new_tokens=RING_NEW, poll_s=0.001,
                           max_sequences=8, use_ring_prefill=ring,
                           min_ring_tokens=64, default_deadline_s=600.0))
    SD._decode_attention = rec
    try:
        streams = [eng.submit(p) for p in prompts]
        toks = [s.result(timeout=600) for s in streams]
        stats = eng.stats()
    finally:
        eng.close()
        SD._decode_attention = real
    return toks, stats, steps


def same_steps(what: str, got: dict, ref: dict) -> None:
    """Every decode step's attention output bit for bit."""
    if set(got) != set(ref):
        raise AssertionError(f"{what}: decode steps differ "
                             f"({len(got)} against {len(ref)})")
    exact(f"{what}: {len(ref)} decode steps' attention outputs",
          [got[k] for k in sorted(ref)], [ref[k] for k in sorted(ref)])


def ring_prefill_phase(tdat, serve, M, errs) -> dict:
    """K9 through ``DecodeEngine.submit``: 4 ranks on the card, 4 prompts
    of 7997..8000 tokens, against the same engine on the plain
    ``reference_attention`` (float32 torch on the card), and a run whose
    pool holds two sequences (eviction and re-prefill) against the roomy
    one."""
    from distributedarrays_tpu_torch.models import ring_attention as RA
    from distributedarrays_tpu_torch import telemetry as tm
    from distributedarrays_tpu_torch.utils import kbuild
    from torch.profiler import ProfilerActivity, profile
    tdat.init(nranks=4)
    model = serve.TinyLM(heads=RING_HEADS, head_dim=RING_HEAD_DIM,
                         max_pos=RING_MAX_POS, seed=0)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, model.vocab, size=n).tolist()
               for n in RING_PROMPTS]
    roomy = len(prompts) * model.max_pos // RING_PAGE   # 2048 pages
    outs: dict = {"ring": {}, "plain": {}}
    ring_ms = []
    real_ring, real_ref = RA.ring_attention_prefill, RA.reference_attention

    def rec(which, fn):
        def wrapped(q, k, v, *a, **kw):
            if which == "ring":
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
            o = fn(q, k, v, *a, **kw)
            if which == "ring":
                t1.record()
                t1.synchronize()
                ring_ms.append(t0.elapsed_time(t1))
            outs[which][int(q.shape[0])] = o.clone()   # every row
            return o
        return wrapped
    out = {}
    tm.reset()
    kbuild.reset_launches()
    RA.ring_attention_prefill = rec("ring", real_ring)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            toks_ring, st, steps_ring = ring_engine(
                tdat, serve, prompts, ring=True, max_pages=roomy)
            torch.cuda.synchronize()
    finally:
        RA.ring_attention_prefill = real_ring
    counts = kbuild.launch_counts()
    routes = kbuild.route_counts()["ring_attention"]
    want = K9_PER_PREFILL * len(prompts)
    spans = tm.span_stats().get("serve.prefill", {})
    k9_dev = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and ("ring_step" in e.key
                      or "forward_kernel" in e.key)) / 1e3
    span_ms = spans.get("total_s", 0.0) * 1e3
    print(f"  ring engine 4 ranks: K9 launches {counts['ring_attention']} "
          f"(predicted {want}), routes {routes}, other launches "
          f"{ {k: v for k, v in counts.items() if v and k != 'ring_attention'} }")
    if counts["ring_attention"] != want or \
            routes["f32"] != K9_STEPS_PER_PREFILL * len(prompts):
        raise AssertionError(f"ring engine: K9 launched "
                             f"{counts['ring_attention']} times (routes "
                             f"{routes}), {want} expected")
    out["k9_launches"] = counts["ring_attention"]
    out["launches"] = counts
    out["prefill_span_ms_per_seq"] = span_ms / max(spans.get("count", 1), 1)
    out["ring_call_ms"] = ring_ms
    out["k9_device_ms"] = k9_dev
    out["k9_share_of_prefill"] = k9_dev / span_ms if span_ms else None
    out["stats"] = st["cache"]
    print(f"  prefill {out['prefill_span_ms_per_seq']:.2f} ms a sequence "
          f"(serve.prefill spans, host clock to the first token's device "
          f"sync), ring calls {['%.2f' % x for x in ring_ms]} ms (CUDA "
          f"events), K9 device {k9_dev:.2f} ms for {len(prompts)} "
          f"prefills: {out['k9_share_of_prefill']:.3f} of the spans")
    # the same engine on the plain attention, on the card
    RA.reference_attention = rec("plain", real_ref)
    kbuild.reset_launches()
    try:
        toks_plain, _, steps_plain = ring_engine(
            tdat, serve, prompts, ring=False, max_pages=roomy)
    finally:
        RA.reference_attention = real_ref
    if kbuild.launch_counts()["ring_attention"]:
        raise AssertionError("the reference engine launched K9")
    nr = tdat.nranks()
    for n in RING_PROMPTS:
        o_r, o_p = outs["ring"][n], outs["plain"][n]
        errs["ring_attention"] = max(errs["ring_attention"],
                                     max_abs(o_r, o_p))
        check(f"prefill {n} tokens (last row) K9 ring against the plain "
              f"attention", rel_err(o_r[-1], o_p[-1]), TOL_F32)
        # every row, each rank's query block on its own, so a fault in
        # one block is not diluted by the other three
        blk = -(-n // nr)
        worst = max(rel_err(o_r[i:i + blk], o_p[i:i + blk])
                    for i in range(0, n, blk))
        check(f"prefill {n} tokens (all {n} rows, worst of the {nr} "
              f"ranks' query blocks) K9 ring against the plain attention",
              worst, TOL_F32)
    outs.clear()
    for p, a, b in zip(prompts, toks_ring, toks_plain):
        if a != b:
            raise AssertionError(f"ring and plain engines differ for the "
                                 f"{len(p)}-token prompt: {a} vs {b}")
    print(f"  ring and plain engines: {len(prompts)} streams of {RING_NEW} "
          f"tokens equal, e.g. {toks_ring[0]}")
    same_steps("ring and plain engines", steps_plain, steps_ring)
    # a pool of two sequences: the later prefills evict, the evicted
    # rebuild; the streams must be the roomy run's bit for bit
    kbuild.reset_launches()
    toks_tight, st_tight, steps_tight = ring_engine(
        tdat, serve, prompts, ring=True, max_pages=RING_TIGHT_PAGES)
    ev = st_tight["cache"]["evictions"]
    print(f"  evicting pool ({RING_TIGHT_PAGES} pages): {ev} evictions, "
          f"K9 launches {kbuild.launch_counts()['ring_attention']}")
    if ev == 0 or toks_tight != toks_ring:
        raise AssertionError(f"evicting run: {ev} evictions, streams equal "
                             f"{toks_tight == toks_ring}")
    same_steps("evicting and roomy runs", steps_tight, steps_ring)
    out["evictions"] = ev
    out["evicting_k9_launches"] = kbuild.launch_counts()["ring_attention"]
    # the decode step's gather: one 8000-token sequence's 501 pages
    cache = serve.PagedKVCache(serve.KVCacheConfig(
        heads=RING_HEADS, head_dim=RING_HEAD_DIM, page_tokens=RING_PAGE,
        block_pages=RING_BLOCK, max_pages=roomy))
    try:
        n = RING_PROMPTS[0] + RING_NEW
        cache.ensure(1, n)
        _, kr, vr = model.qkv(prompts[0] + [0] * RING_NEW, 0,
                              tdat.device_of(0))
        cache.write(1, 0, kr, vr)
        k, v = cache.read(1)
        exact("kv read of 8016 rows against the rows written", k, kr)
        out["kv_read_ms"] = wall_ms(lambda: cache.read(1))
        ledger_matches(tdat, M, tdat.device_of(0), "with a 501-page cache")
    finally:
        cache.close()
    print(f"  kv read of {n} rows ({cache.pages_for(n)} pages): "
          f"{out['kv_read_ms']:.2f} ms")
    return out


def serve_load_row(tdat, serve) -> dict:
    """bench.py's ``serve_load`` row at its size on one rank: the endpoint
    stacks the batch and multiplies by a 1024^2 f32 DArray's whole tensor
    (``torch.matmul``), 30 unloaded requests, then a 3 s open loop at
    twice the sustainable rate."""
    import threading
    w = tdat.distribute(np.asarray(np.random.default_rng(5)
                                   .standard_normal((SERVE_LOAD_N,) * 2),
                                   np.float32))
    srv = None
    try:
        g = w.full()

        def ep(xs):
            y = torch.matmul(torch.stack([torch.as_tensor(x) for x in xs])
                             .to(g.device), g)
            return list(y[:, 0].cpu().numpy())
        cfg = serve.ServeConfig(max_batch=8, flush_s=0.002, max_queue=32,
                                tenant_rate=1e9, tenant_burst=1e9)
        srv = serve.Server(cfg)
        srv.register("score", ep)
        x = np.zeros((SERVE_LOAD_N,), np.float32)
        srv.submit("score", x).result(timeout=60)
        lats = []
        for _ in range(30):
            t0 = time.monotonic()
            srv.submit("score", x).result(timeout=60)
            lats.append(time.monotonic() - t0)
        p99_unloaded = percentile(lats, 0.99)
        batch_s = max(srv.stats()["latency_p50_s"], 1e-4)
        interval = 1.0 / (2.0 * cfg.max_batch / batch_s)
        futs, shed, loaded = [], 0, []
        lock = threading.Lock()

        def mark(t0):
            def cb(_f):
                with lock:
                    loaded.append(time.monotonic() - t0)
            return cb
        t_start = time.monotonic()
        while time.monotonic() - t_start < SERVE_WINDOW_S:
            try:
                t0 = time.monotonic()
                f = srv.submit("score", x)
                f.add_done_callback(mark(t0))
                futs.append(f)
            except serve.Overloaded:
                shed += 1
            time.sleep(interval)
        got = [f.result(timeout=60) for f in futs]
        duration = time.monotonic() - t_start
        wn = np.asarray(w)
        want = float((x @ wn)[0])
        if any(v != want for v in got):
            raise AssertionError("serve_load: a result is not x @ w")
        # distinct requests batched together: one-hot row i must come back
        # as w[i, 0] to its own future, whatever the batch order
        rows = list(range(0, SERVE_LOAD_N, SERVE_LOAD_N // 16))
        hots = []
        for i in rows:
            h = np.zeros((SERVE_LOAD_N,), np.float32)
            h[i] = 1.0
            hots.append(srv.submit("score", h))
        mine = [f.result(timeout=60) for f in hots]
        if mine != [float(wn[i, 0]) for i in rows] or \
                len(set(mine)) != len(rows):
            raise AssertionError(f"serve_load: one-hot requests got {mine}, "
                                 f"want {[float(wn[i, 0]) for i in rows]}")
        print(f"  serve_load: {len(rows)} one-hot requests each got its own "
              f"row of w")
        offered = len(futs) + shed
        return {
            "serve_load_nranks": tdat.nranks(),
            "serve_load_offered_rps": offered / duration,
            "serve_load_admitted_rps": len(futs) / duration,
            "serve_load_shed_frac": shed / max(offered, 1),
            "serve_load_p50_s": percentile(loaded, 0.5),
            "serve_load_p99_s": percentile(loaded, 0.99),
            "serve_load_p99_unloaded_s": p99_unloaded,
        }
    finally:
        if srv is not None:
            srv.close()
        w.close()


def solver_service_phase(tdat, M) -> dict:
    """``SolverService`` on the card: bench.py's ``cg_poisson`` system
    (1024^2, ``default_rng(7)``) on one rank, streamed, against a direct
    ``cg`` on the same operator bit for bit (K2: iterations + 1 launches);
    then a 256-unknown dense system on 4 ranks (one K10 a matvec, as the
    solvers phase's ``small_solves`` reads)."""
    from distributedarrays_tpu_torch.utils import kbuild
    S = tdat.solvers
    out = {}
    tdat.init()
    rhs = np.random.default_rng(7).standard_normal((CG_N, CG_N)).astype(
        np.float32)
    svc = S.SolverService()
    try:
        kbuild.reset_launches()
        stream = svc.submit({"kind": "poisson", "grid": (CG_N, CG_N),
                             "b": rhs}, tol=CG_TOL, maxiter=CG_MAXITER)
        updates = list(stream)
        summary = stream.result(timeout=600)
        svc.server.drain(timeout=60)
        torch.cuda.synchronize()
        k2 = kbuild.launch_counts()["stencil_step"]
    finally:
        svc.close()
    op = S.StencilOperator((CG_N, CG_N))
    procs, dist = op.vector_layout()
    b = tdat.distribute(rhs, procs=procs, dist=list(dist))
    res = S.cg(op, b, tol=CG_TOL, maxiter=CG_MAXITER)
    x = np.asarray(res.x)
    res.x.close()
    b.close()
    it = summary["iterations"]
    print(f"  service cg {CG_N}^2: {summary['outcome']} in {it} "
          f"iterations ({len(updates)} streamed), direct cg "
          f"{res.iterations}; K2 launches {k2}")
    if summary["outcome"] != "converged" or it != res.iterations or \
            [u[0] for u in updates] != list(range(1, it + 1)) or \
            k2 != it + 1:
        raise AssertionError(f"service cg: {summary['outcome']}, {it} "
                             f"iterations against {res.iterations}, "
                             f"{len(updates)} updates, K2 {k2}")
    exact("service cg answer against the direct cg",
          torch.from_numpy(summary["x"]), torch.from_numpy(x))
    out["cg_iterations"] = it
    out["k2_launches"] = k2
    tdat.init(nranks=4)
    A = S.poisson2d_dense(SERVICE_DENSE_N, SERVICE_DENSE_N)
    bd = np.random.default_rng(7).standard_normal(A.shape[0]).astype(
        np.float32)
    svc = S.SolverService()
    try:
        kbuild.reset_launches()
        summary = svc.submit({"kind": "dense", "A": A, "b": bd},
                             tol=CG_TOL).result(timeout=120)
        svc.server.drain(timeout=60)
        torch.cuda.synchronize()
        k10 = kbuild.launch_counts()["all_gather"]
    finally:
        svc.close()
    oracle = np.linalg.solve(A.astype(np.float64), bd.astype(np.float64))
    err = float(np.linalg.norm(summary["x"] - oracle) /
                np.linalg.norm(oracle))
    print(f"  service dense {A.shape[0]} on 4 ranks: "
          f"{summary['outcome']} in {summary['iterations']} iterations, "
          f"K10 launches {k10}")
    if summary["outcome"] != "converged" or \
            k10 != summary["iterations"] + 1:
        raise AssertionError(f"service dense: {summary['outcome']}, K10 "
                             f"{k10} for {summary['iterations']} "
                             "iterations")
    check("service dense x against the float64 oracle", err, TOL_SMALL)
    out["dense_iterations"] = summary["iterations"]
    out["k10_launches"] = k10
    if M.live_bytes() != 0:
        raise AssertionError(f"service: {M.live_bytes()} B left in the "
                             "ledger")
    return out


def serve_phase(tdat, errs: dict) -> dict:
    """``serve``: the serving stack on the card (see the module docstring,
    step 6).  Telemetry (and so the ledger) is on."""
    from distributedarrays_tpu_torch import serve
    from distributedarrays_tpu_torch import telemetry as tm
    from distributedarrays_tpu_torch.resilience import elastic, faults
    M = tm.memory
    print("phase serve")
    t_phase = time.perf_counter()
    tdat.d_closeall()
    faults.clear()
    elastic.manager().reset()
    tm.enable()
    tdat.init()
    dev = tdat.device_of(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    alloc0 = torch.cuda.memory_allocated(dev)
    M.reset_peak()
    led0 = M.live_bytes()
    out = {}
    out["serve_decode"] = serve_decode_row(tdat, serve, M)
    print(f"  serve_decode: {json.dumps(out['serve_decode'])}")
    if M.live_bytes() != led0:
        raise AssertionError(f"ledger after eng.close(): {M.live_bytes()} "
                             f"B, {led0} before")
    out["ring"] = ring_prefill_phase(tdat, serve, M, errs)
    tdat.init()
    out["serve_load"] = serve_load_row(tdat, serve)
    print(f"  serve_load: {json.dumps(out['serve_load'])}")
    if M.live_bytes() != led0:
        raise AssertionError(f"ledger after srv.close(): {M.live_bytes()} "
                             f"B, {led0} before")
    out["service"] = solver_service_phase(tdat, M)
    # the ledger against the allocator: the phase's peak device bytes cover
    # the ledger's peak (the allocator also holds temporaries the ledger
    # does not track)
    torch.cuda.synchronize()
    grew = torch.cuda.max_memory_allocated(dev) - alloc0
    peak = M.peak_bytes() - led0
    print(f"  ledger peak {peak} B over its base; allocator grew "
          f"{grew} B")
    if grew < peak or peak <= 0:
        raise AssertionError(f"allocator growth {grew} B below the ledger "
                             f"peak {peak} B")
    d = tdat.drand((1024, 1024))
    bundle = tm.flight.snapshot_bundle("serve phase")
    census = bundle["leak_census"]
    ledger_matches(tdat, M, dev, "with one 1024^2 DArray")
    if census["ledger_tracked"]["bytes"] != M.live_bytes() or \
            census["deleted_but_registered"]["count"] or \
            bundle["ledger"]["live_bytes"] != M.live_bytes():
        raise AssertionError(f"flight bundle census {census}")
    print(f"  flight bundle memory census {census}")
    d.close()
    out["ledger_peak_bytes"] = peak
    out["allocator_growth_bytes"] = grew
    out["launches"] = {
        "ring_attention": out["ring"]["k9_launches"],
        "stencil_step": out["service"]["k2_launches"],
        "all_gather": out["service"]["k10_launches"]}
    tdat.d_closeall()
    torch.cuda.empty_cache()
    tdat.init()
    print(f"  serve {time.perf_counter() - t_phase:.1f} s")
    print(json.dumps({"serve": out}))
    return out


def serve_only() -> int:
    """``--serve``: build the attention, stencil and collective kernels and
    run the serving phase alone (``serve_phase``)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import distributedarrays_tpu_torch as tdat
    from distributedarrays_tpu_torch.utils import kbuild
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = gpu_name()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    kbuild.build(["attention", "stencil", "collectives"])
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    errs = {k: 0.0 for k in kbuild.KERNELS}
    res = serve_phase(tdat, errs)
    print(json.dumps({"serve_launches": res["launches"], "gpu": smi}))
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


# the one-process 4-rank trainer's 3 Adam steps (losses, the flat
# parameters' digest, step ms), filled by ``trainer_phase``
_TRAINER_REF: dict = {}


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
        # what the processes of the multihost phase must reproduce bit
        # for bit (``multihost_trainer``)
        _TRAINER_REF.update(losses=list(losses),
                            flat_sha=_sha256(t.flat_params()),
                            step_ms=list(step_ms))
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
        G.close()
        got.close()
        del full
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


# the models phase: the MoE layer at Mixtral-8x7B's widths (its experts are
# the JAX model's two-matrix GELU FFN, not Mixtral's SwiGLU), the pipeline,
# k-means and the Monte-Carlo estimators, at the sizes PERF.md section 4
# gives
MOE_HIDDEN, MOE_FFN, MOE_EXPERTS, MOE_K, MOE_CF = 4096, 14336, 8, 2, 2.0
MOE_TOKENS = 16384            # 2048 a rank, capacity 1024
MOE_SMALL = (8, 64, 128, 256)         # experts, hidden, ffn, tokens
PP_STAGES, PP_HIDDEN, PP_LAYERS, PP_M, PP_B = 4, 8192, 2, 16, 256
KM_N, KM_DIM, KM_K, KM_ITERS, KM_RANKS = 2 ** 24, 32, 64, 20, 4
# centres uniform in [-4, 4]^32 (about 18 apart), points 0.02 around them,
# all on a grid of 1/8: a cluster's coordinate sums (at most 2^23 in
# eighths) are exact in f32 in any order, so the per-rank one-hot sums and
# the whole-array sums agree bit for bit.  (Off the grid, f32 running sums
# of 262144 near-equal addends round with a bias, and two orders of
# summation differ by about 1e-3.)
KM_SPREAD, KM_NOISE, KM_GRID = 4.0, 0.02, 8.0
MC_PI_N, MC_PI_BATCHES, MC_EXP_N = 10 ** 9, 10, 10 ** 8
# f32 with TF32 off: the pipeline against the sequential forward and
# 1F1B's gradients against GPipe's differ in summation order only
TOL_PP = 1e-5
# k-means: per-rank one-hot sums folded over ranks against one whole-array
# sum, 20 iterations
TOL_KMEANS = 1e-4
# the small MoE against reference_moe on the card, f32: gated sums of two
# FFNs in another order
TOL_MOE_SMALL = 1e-4


def moe_check(tdat, errs: dict) -> dict:
    """MoE at Mixtral-8x7B's layer widths, 8 ranks on the card, bf16."""
    from distributedarrays_tpu_torch.models import moe
    from distributedarrays_tpu_torch.ops import cuda_collectives as CC
    from distributedarrays_tpu_torch.parallel.collectives import pall_to_all
    kbuild = tdat.kbuild
    tdat.init(nranks=MOE_EXPERTS)
    dev = tdat.device_of(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    mesh = moe.make_ep_mesh(MOE_EXPERTS)
    # a small shape against the dense oracle, f32
    E, H, F, N = MOE_SMALL
    small = moe.init_moe_params(gen, E, H, F, ranks=mesh)
    xs = torch.randn(N, H, generator=gen, device=dev)
    for k, cap in ((1, None), (2, None), (2, 2)):
        got = moe.moe_forward(small, xs, mesh, capacity=cap, k=k)
        c = cap if cap is not None else max(1, int(np.ceil(
            MOE_CF * k * (N // E) / E)))
        check(f"moe {E}x({H}, {F}) {N} tokens k={k} capacity={c} vs "
              f"reference_moe", rel_err(got, moe.reference_moe(
                  small, xs, c, E, k=k)), TOL_MOE_SMALL)
    del small, xs
    params = moe.init_moe_params(gen, MOE_EXPERTS, MOE_HIDDEN, MOE_FFN,
                                 dtype=torch.bfloat16, ranks=mesh)
    wbytes = sum(t.numel() * 2 for k in ("W1", "W2") for t in params[k])
    x = torch.randn(MOE_TOKENS, MOE_HIDDEN, generator=gen,
                    device=dev).to(torch.bfloat16)
    n_local = MOE_TOKENS // MOE_EXPERTS
    cap = max(1, int(np.ceil(MOE_CF * MOE_K * n_local / MOE_EXPERTS)))

    def fwd(a2a=None):
        return moe.moe_forward(params, x, mesh, k=MOE_K,
                               capacity_factor=MOE_CF, return_aux=True,
                               _all_to_all=a2a)
    torch.cuda.synchronize()
    kbuild.reset_launches()
    out, aux = fwd()
    torch.cuda.synchronize()
    counts = kbuild.launch_counts()
    expect_launches("moe forward (Mixtral-8x7B widths)", counts,
                    {"all_to_all": 2})
    out_p, aux_p = fwd(pall_to_all)
    err = exact("moe output, K11 exchanges vs the plain ones", out, out_p)
    exact("moe aux loss, K11 exchanges vs the plain ones", aux, aux_p)
    if not torch.isfinite(out).all() or not torch.isfinite(aux):
        raise AssertionError("non-finite MoE output")
    print(f"  moe aux loss {float(aux):.6f}, capacity {cap}, weights "
          f"{wbytes} B")
    ms = statistics.median(event_ms(fwd)[1] for _ in range(5))
    # K11 at this shape: the (E, C, H) bf16 dispatch buffers of 8 ranks
    bufs = [torch.randn(MOE_EXPERTS, cap, MOE_HIDDEN, generator=gen,
                        device=dev).to(torch.bfloat16) for _ in mesh]
    moved = sum(b.numel() * 2 for b in bufs)
    got = CC.ring_all_to_all(bufs, 0, 0)
    errs["all_to_all"] = max(errs["all_to_all"], exact(
        "K11 at the MoE dispatch shape vs the plain all-to-all", got,
        CC.all_to_all_plain(bufs, 0, 0)))
    k11_ms = time_ms(lambda: CC.ring_all_to_all(bufs, 0, 0))
    # a trace that holds no device time (the profiler can miss kernels) is
    # no reading: None, not 0
    k11_dev = device_ms(lambda: CC.ring_all_to_all(bufs, 0, 0)) or None
    k11_plain = time_ms(lambda: CC.all_to_all_plain(bufs, 0, 0))
    k11_lib = time_ms(lambda: [torch.cat([b[q:q + 1] for b in bufs])
                               for q in range(MOE_EXPERTS)])
    k11_bound = bound(2 * moved, 0, BF16_FLOPS)[0]
    del bufs, got, out, out_p, x, params
    torch.cuda.empty_cache()
    res = {"ms_per_forward": ms, "tokens_per_s": MOE_TOKENS / (ms / 1e3),
           "k11_launches_per_forward": counts["all_to_all"],
           "exchange_bytes": moved, "k11_ms": k11_ms,
           "k11_device_ms": k11_dev, "k11_plain_ms": k11_plain,
           "k11_library_ms": k11_lib, "k11_bound_ms": k11_bound,
           "k11_max_abs_err": err, "aux": float(aux_p),
           "shape": f"{MOE_TOKENS} tokens x {MOE_HIDDEN}, {MOE_EXPERTS} "
                    f"experts of ({MOE_HIDDEN}, {MOE_FFN}) gelu FFN, top-"
                    f"{MOE_K}, capacity {cap}, bf16, 8 ranks on one card"}
    print(f"  moe: {json.dumps(res)}")
    return res


def pipeline_check(tdat) -> dict:
    """Pipeline, 4 stages on 4 ranks of the card, f32."""
    from distributedarrays_tpu_torch.models import pipeline as PP
    tdat.init(nranks=PP_STAGES)
    dev = tdat.device_of(0)
    gen = torch.Generator(device=dev).manual_seed(1)
    mesh = PP.make_pp_mesh(PP_STAGES)
    params = PP.init_pipeline_params(gen, PP_STAGES, PP_HIDDEN,
                                     n_layers=PP_LAYERS)
    shape = (PP_M, PP_B, PP_HIDDEN)
    mb = torch.randn(shape, generator=gen, device=dev)
    tgt = torch.randn(shape, generator=gen, device=dev)
    out, fwd_ms = event_ms(lambda: PP.pipeline_forward(params, mb, mesh))
    check("pipeline_forward vs reference_forward", rel_err(
        out, PP.reference_forward(params, mb)), TOL_PP)
    del out
    fwd_ms = min(fwd_ms, event_ms(
        lambda: PP.pipeline_forward(params, mb, mesh))[1])
    W, b = PP._norm_params(params)
    PP._gpipe_grads(W, b, mb, tgt, mesh)          # warm-up, not measured
    res = {}
    for name, fn in (("gpipe", PP._gpipe_grads), ("1f1b", PP._1f1b_grads)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (gw, gb, loss), ms = event_ms(lambda: fn(W, b, mb, tgt, mesh))
        peak = torch.cuda.max_memory_allocated()
        # the gradients leave the card, so both steps start from one base
        res[name] = (([g.cpu() for g in gw], [g.cpu() for g in gb],
                      float(loss)), ms, peak, peak - base)
        del gw, gb
    (gw, gb, lg), g_ms, g_peak, g_over = res["gpipe"]
    (fw, fb, lf), f_ms, f_peak, f_over = res["1f1b"]
    check("1F1B vs GPipe: loss", abs(lf - lg) / abs(lg), TOL_PP)
    check("1F1B vs GPipe: weight gradients", max(
        rel_err(a, r) for a, r in zip(fw, gw)), TOL_PP)
    check("1F1B vs GPipe: bias gradients", max(
        rel_err(a, r) for a, r in zip(fb, gb)), TOL_PP)
    print(f"  peak bytes a step: GPipe {g_peak} ({g_over} over the "
          f"parameters and inputs), 1F1B {f_peak} ({f_over})")
    if not f_peak < g_peak:
        raise AssertionError("1F1B's peak memory is not below GPipe's")
    # whole SGD steps, the public entry points
    _, gstep_ms = event_ms(lambda: PP.pipeline_train_step(
        params, mb, tgt, mesh, lr=1e-2))
    _, fstep_ms = event_ms(lambda: PP.pipeline_train_step_1f1b(
        params, mb, tgt, mesh, lr=1e-2))
    out = {"forward_ms": fwd_ms, "gpipe_grad_ms": g_ms,
           "onef1b_grad_ms": f_ms, "gpipe_step_ms": gstep_ms,
           "onef1b_step_ms": fstep_ms, "gpipe_peak_bytes": g_peak,
           "onef1b_peak_bytes": f_peak, "loss": lg,
           "shape": f"{PP_STAGES} stages x {PP_LAYERS} layers of "
                    f"{PP_HIDDEN}^2, M={PP_M} microbatches of {PP_B}, f32, "
                    f"4 ranks on one card"}
    del res, gw, gb, fw, fb, params, mb, tgt, W, b
    torch.cuda.empty_cache()
    print(f"  pipeline: {json.dumps(out)}")
    return out


def plain_lloyd(X: torch.Tensor, C: torch.Tensor, iters: int):
    """Whole-array Lloyd on one tensor: ``(centroids, labels)``."""
    k = C.shape[0]
    for _ in range(iters):
        d = (X * X).sum(1, keepdim=True) + (C * C).sum(1)[None] \
            - 2.0 * (X @ C.T)
        a = d.argmin(1)
        counts = torch.bincount(a, minlength=k).to(X.dtype)[:, None]
        sums = torch.zeros_like(C).index_add_(0, a, X)
        C = torch.where(counts > 0, sums / counts.clamp(min=1.0), C)
    d = (X * X).sum(1, keepdim=True) + (C * C).sum(1)[None] \
        - 2.0 * (X @ C.T)
    return C, d.argmin(1)


def kmeans_check(tdat) -> dict:
    """k-means on 4 ranks of the card: 2^24 x 32 f32 points around 64
    centres, k = 64, 20 iterations."""
    from distributedarrays_tpu_torch.models import kmeans as KM
    tdat.init(nranks=KM_RANKS)
    dev = tdat.device_of(0)
    gen = torch.Generator(device=dev).manual_seed(2)
    centres = KM_SPREAD * (2 * torch.rand(KM_K, KM_DIM, generator=gen,
                                          device=dev) - 1)
    truth = torch.randint(0, KM_K, (KM_N,), generator=gen, device=dev)
    X = torch.round(KM_GRID * (centres[truth] + KM_NOISE * torch.randn(
        KM_N, KM_DIM, generator=gen, device=dev))) / KM_GRID
    d = tdat.distribute(X, dist=(KM_RANKS, 1))
    del truth
    (C, shifts), ms = event_ms(lambda: KM.kmeans(d, KM_K, iters=KM_ITERS,
                                                 seed=0))
    C0, init_ms = event_ms(lambda: KM._kmeanspp_init(d, KM_K, 0))
    Cp, labels_p = plain_lloyd(X, torch.from_numpy(C0).to(dev), KM_ITERS)
    check("k-means centroids vs whole-array plain Lloyd", rel_err(C, Cp),
          TOL_KMEANS)
    print(f"  k-means centroids bit-equal to the plain Lloyd's: "
          f"{bool(torch.equal(C, Cp))}")
    labels = KM.assign(d, C)
    if labels.dtype != torch.int32 or \
            not torch.equal(labels.full().long(), labels_p):
        raise AssertionError("k-means labels differ from the plain "
                             "Lloyd's")
    print(f"  k-means labels equal ({KM_N} points), last shift "
          f"{float(shifts[-1]):.3e}, {int(torch.unique(labels_p).numel())} "
          "clusters used")
    out = {"ms_per_iteration": (ms - init_ms) / KM_ITERS, "total_ms": ms,
           "init_ms": init_ms, "last_shift": float(shifts[-1]),
           "shape": f"{KM_N} x {KM_DIM} f32 on {KM_RANKS} ranks, "
                    f"k={KM_K}, {KM_ITERS} iterations"}
    d.close()
    labels.close()
    del X, C, Cp, labels_p
    torch.cuda.empty_cache()
    print(f"  kmeans: {json.dumps(out)}")
    return out


def montecarlo_check(tdat) -> dict:
    """pi_estimate(10^9, batches=10) and E|X| over 10^8 draws, one rank."""
    from distributedarrays_tpu_torch.models import montecarlo as MC
    tdat.init()
    est, ms = event_ms(lambda: MC.pi_estimate(MC_PI_N, seed=0,
                                              batches=MC_PI_BATCHES))
    sigma = float(np.sqrt(np.pi * (4 - np.pi) / MC_PI_N))
    print(f"  pi_estimate({MC_PI_N}) = {est!r}, {abs(est - np.pi) / sigma:.2f}"
          " sigma from pi")
    if not abs(est - np.pi) < 5 * sigma:
        raise AssertionError("pi_estimate is more than 5 sigma from pi")
    (e, se), ems = event_ms(lambda: MC.expectation(torch.abs, MC_EXP_N))
    truth = float(np.sqrt(2 / np.pi))
    print(f"  expectation(abs, {MC_EXP_N}) = {e!r} +- {se!r}, "
          f"{abs(e - truth) / se:.2f} SE from sqrt(2/pi)")
    if not abs(e - truth) < 5 * se:
        raise AssertionError("expectation is more than 5 SE from the truth")
    out = {"pi": est, "pi_ms": ms, "pi_points_per_s": MC_PI_N / (ms / 1e3),
           "expectation": e, "se": se, "expectation_ms": ems,
           "expectation_draws_per_s": MC_EXP_N / (ems / 1e3)}
    print(f"  montecarlo: {json.dumps(out)}")
    return out


def models_phase(tdat, errs: dict) -> dict:
    """``models``: MoE, pipeline, k-means and Monte Carlo on the card (see
    the module docstring, step 5)."""
    print("phase models")
    t_phase = time.perf_counter()
    tdat.d_closeall()
    out = {"moe": moe_check(tdat, errs), "pipeline": pipeline_check(tdat),
           "kmeans": kmeans_check(tdat), "montecarlo": montecarlo_check(tdat)}
    out["launches"] = {"all_to_all": out["moe"]["k11_launches_per_forward"]}
    tdat.d_closeall()
    torch.cuda.empty_cache()
    tdat.init()
    print(f"  models {time.perf_counter() - t_phase:.1f} s")
    print(json.dumps({"models": out}))
    return out


def models_only() -> int:
    """``--models``: build the collective kernels and run the models phase
    alone (``models_phase``)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import distributedarrays_tpu_torch as tdat
    from distributedarrays_tpu_torch.utils import kbuild
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = gpu_name()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    kbuild.build(["collectives"])
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    errs = {k: 0.0 for k in kbuild.KERNELS}
    res = models_phase(tdat, errs)
    print(json.dumps({"models_launches": res["launches"], "gpu": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _counting_attempts(trainer, log: list):
    """Record each step attempt's rank count and its K10 and K12 launches
    (the trainer's ``_attempt_step``, wrapped on the instance)."""
    kbuild = sys.modules["distributedarrays_tpu_torch.utils.kbuild"]
    inner = trainer._attempt_step

    def attempt():
        before = kbuild.launch_counts()
        ranks = trainer._ranks_now()
        try:
            return inner()
        finally:
            after = kbuild.launch_counts()
            log.append((len(ranks), after["all_gather"] - before["all_gather"],
                        after["reduce_scatter"] - before["reduce_scatter"]))
    trainer._attempt_step = attempt


def train_runtime_phase(tdat) -> dict:
    """``train-runtime``: the trainer's checkpoint and recovery tier on
    ``transformer_task(8192, 1024, 16, 8, seq 2048, batch 8)`` (f32, Adam),
    4 ranks on the card (see the module docstring, step 7)."""
    import shutil
    import tempfile
    from distributedarrays_tpu_torch import telemetry as tm
    from distributedarrays_tpu_torch.resilience import elastic, faults
    from distributedarrays_tpu_torch.utils import checkpoint as CK
    train, kbuild = tdat.train, tdat.kbuild
    print(f"phase train-runtime (4 ranks on one card, transformer_task "
          f"{TRAINER_CFG}, f32, adam)")
    t_phase = time.perf_counter()
    tdat.d_closeall()
    tdat.init(nranks=4)
    faults.clear()
    elastic.manager().reset()
    tm.enable()
    task = train.transformer_task(**TRAINER_CFG)
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    out = {}
    try:
        def trainer(sub, **kw):
            kw.setdefault("save_every", 2)
            return train.Trainer(task, train.adam(1e-4),
                                 ckpt_dir=os.path.join(root, sub),
                                 max_to_keep=2, **kw)

        # (a) 4 steps, a checkpoint every 2, peer replicas
        step_ms, losses_a = [], []
        with trainer("a", peer_replicas=True) as t:
            for _ in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses_a.append(t.step_once())
                step_ms.append((time.perf_counter() - t0) * 1e3)
            if t.flat_params().numel() != trainer_params():
                raise AssertionError("unexpected parameter count")
            tree = t._ckpt_tree()
            nbytes = sum(int(np.prod(tree[k].dims)) * 4 for k in tree
                         if k != "step")
            t0 = time.perf_counter()
            CK.save(os.path.join(root, "timed"), tree)
            save_s = time.perf_counter() - t0
            disk0 = tm.counter_value("checkpoint.disk_reads")
            t0 = time.perf_counter()
            rep = t._mgr.restore(4)
            torch.cuda.synchronize()
            replica_s = time.perf_counter() - t0
            if tm.counter_value("checkpoint.disk_reads") != disk0:
                raise AssertionError("the replica restore read the disk")
            exact("replica restore of step 4: parameters",
                  rep["pflat"].full(), t._state["pflat"].full())
            for k in ("pflat", "m0", "m1"):
                rep[k].close()
        t0 = time.perf_counter()
        disk = CK.load(os.path.join(root, "timed"))
        torch.cuda.synchronize()
        disk_s = time.perf_counter() - t0
        for k in ("pflat", "m0", "m1"):
            disk[k].close()
        shutil.rmtree(os.path.join(root, "timed"))
        print(f"  (a) losses {losses_a}, step ms {step_ms}")
        if not all(np.isfinite(losses_a)):
            raise AssertionError(f"non-finite losses {losses_a}")
        # steps 2 and 4 each end with a save; step 1 builds the kernels
        out["a"] = {"losses": losses_a, "step_ms": step_ms,
                    "step_ms_no_save": step_ms[2],
                    "step_ms_with_save": statistics.median(
                        [step_ms[1], step_ms[3]]),
                    "checkpoint_bytes": nbytes, "save_s": save_s,
                    "save_gb_per_s": nbytes / save_s / 1e9,
                    "restore_disk_s": disk_s,
                    "restore_replica_s": replica_s}
        # (b) stop after step 2, resume on the same directory, run to 4
        with trainer("b") as t:
            t.fit(2)
        with trainer("b") as t:
            res = t.fit(4)
        if res["start"] != 2:
            raise AssertionError(f"resumed from {res['start']}, not 2")
        bit_equal = res["losses"] == losses_a[2:]
        check("resumed steps 3-4 vs uninterrupted: losses", max(
            abs(a - b) / abs(b) for a, b in zip(res["losses"],
                                                losses_a[2:])),
              TOL_TRAINER_LOSS)
        print(f"  (b) resumed losses {res['losses']}, bit-equal to (a): "
              f"{bit_equal}")
        out["b"] = {"losses": res["losses"], "bit_equal": bit_equal}
        shutil.rmtree(os.path.join(root, "b"))
        # (c) rank 3 lost at the top of step 3: restore step 2 from the peer
        # replica, shrink onto ranks 0-2, finish there
        faults.configure(plan=[
            {"site": "train.step", "match": {"step": 3},
             "action": "device_loss", "at": 1, "count": 1, "device": 3}],
            seed=0)
        log = []
        disk0 = tm.counter_value("checkpoint.disk_reads")
        peer0 = tm.counter_value("checkpoint.restore_source", source="peer")
        with trainer("c", peer_replicas=True) as t:
            _counting_attempts(t, log)
            kbuild.reset_launches()
            t0 = time.perf_counter()
            res = t.fit(4)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            counts = kbuild.launch_counts()
            pids = [int(p) for p in t._state["pflat"].pids.flat]
        faults.clear()
        live = elastic.manager().live_ranks()
        print(f"  (c) attempts (ranks, K10, K12) {log}, live {live}, "
              f"losses {res['losses']}")
        if tm.counter_value("checkpoint.disk_reads") != disk0 or \
                tm.counter_value("checkpoint.restore_source",
                                 source="peer") != peer0 + 1:
            raise AssertionError("the device-loss restore did not come "
                                 "from the peer replica alone")
        if live != [0, 1, 2] or pids != [0, 1, 2]:
            raise AssertionError(f"not shrunk onto ranks 0-2: live {live}, "
                                 f"state on {pids}")
        # steps 1-3 on 4 ranks, step 4 lost at its top, steps 3-4 again on
        # 3 ranks: 1 K10 and a K12 a rank each
        if log != [(4, 1, 4)] * 3 + [(4, 0, 0)] + [(3, 1, 3)] * 2:
            raise AssertionError(f"unexpected attempts {log}")
        # the shrink's moves: gather_put (K10) where 3 does not divide the
        # vector (119555072 = 3 x 39851690 + 2 at full width), else K11
        shrink_k10 = counts["all_gather"] - sum(a[1] for a in log)
        shrink_k11 = counts["all_to_all"]
        print(f"  (c) the shrink launched {shrink_k10} K10 and {shrink_k11} "
              "K11")
        if shrink_k10 + shrink_k11 <= 0:
            raise AssertionError("the shrink launched no copy kernel")
        check("steps 3-4 on 3 ranks vs 4 ranks: losses", max(
            abs(a - b) / abs(b) for a, b in zip(res["losses"][2:],
                                                losses_a[2:])),
              TOL_TRAINER_LOSS)
        out["c"] = {"attempts": log, "shrink_k10_launches": shrink_k10,
                    "shrink_k11_launches": shrink_k11,
                    "losses": res["losses"], "fit_s": fit_s}
        elastic.manager().reset()
        shutil.rmtree(os.path.join(root, "c"))
        # (d) a corrupt read of the latest step: quarantine, fall back
        faults.configure(plan=[
            {"site": "checkpoint.read", "action": "corrupt", "at": 1,
             "count": 1}], seed=1)
        q0 = tm.counter_value("checkpoint.quarantines")
        mgr = CK.CheckpointManager(os.path.join(root, "a"), async_save=False)
        tree = mgr.restore()
        faults.clear()
        for k in ("pflat", "m0", "m1"):
            tree[k].close()
        if tree["step"] != 2 or mgr.steps() != [2] or \
                tm.counter_value("checkpoint.quarantines") != q0 + 1 or \
                not os.path.isdir(os.path.join(
                    root, "a", ".quarantine_step_00000004")):
            raise AssertionError("the corrupt step 4 was not quarantined "
                                 "with a fall back to step 2")
        mgr.close()
        print("  (d) corrupt step 4 quarantined, restored step 2")
        out["d"] = {"restored_step": tree["step"]}
    finally:
        faults.clear()
        elastic.manager().reset()
        shutil.rmtree(root, ignore_errors=True)
    out["launches"] = {
        "all_gather": sum(a[1] for a in out["c"]["attempts"])
        + out["c"]["shrink_k10_launches"],
        "reduce_scatter": sum(a[2] for a in out["c"]["attempts"])}
    tdat.d_closeall()
    torch.cuda.empty_cache()
    tdat.init()
    print(f"  train-runtime {time.perf_counter() - t_phase:.1f} s")
    print(json.dumps({"train_runtime": out}))
    return out


def train_runtime_only() -> int:
    """``--train-runtime``: build the attention and collective kernels and
    run the trainer's runtime phase alone (``train_runtime_phase``)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import distributedarrays_tpu_torch as tdat
    from distributedarrays_tpu_torch.utils import kbuild
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = gpu_name()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    kbuild.build(["attention", "attention_bwd", "collectives"])
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    res = train_runtime_phase(tdat)
    print(json.dumps({"train_runtime_launches": res["launches"],
                      "gpu": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# the multi-process phase: 4 processes of the port on the one card, one
# rank each (the reference refuses fewer than 3 workers; p = 4 gives
# distinct left and right neighbours)
MH_PROCS = 4
MH_N = 16384              # 16384^2 f32, 1 GiB: BASELINE config 3's size
MH_CHAIN_N = 8192         # BASELINE's sin(A) + B*C
MH_UNEVEN = (16383, 16384)
MH_CKPT_N = 4096
MH_STALE_S = 2.0
MH_SEED = 11
MH_TIMEOUT_S = 420
MH_REPS, MH_BATCH = 7, 10
MH_PLAIN_REPS = 3
MH_MM_REPS, MH_MM_BATCH = 3, 2     # the per-process GEMM product's timing
MH_WINDOW_BATCH = 20    # calls a process in an all-four host window
MH_MAP_N, MH_MAP_ROUNDS = 4096, 50  # the mapping-lifetime rounds


def _plain_fetch(MH, CC, wants) -> list:
    """``fetch_regions``'s plain route for ``[(DArray, bounds or None)]``:
    the boxes as CPU tensors, over the job's gloo group."""
    arrays, index, asks, outs = [], {}, [], []
    for d, b in wants:
        if id(d) not in index:
            index[id(d)] = len(arrays)
            arrays.append(d)
        b = [(0, n) for n in d.dims] if b is None else b
        out = torch.empty([hi - lo for lo, hi in b], dtype=d.dtype)
        asks.append((index[id(d)], b, out))
        outs.append(out)
    CC.process_regions_plain(arrays, asks, MH._job.group)
    return outs


def _region_launcher(MH, CC, arrays, wants, tag, kernel="all_gather"):
    """``(copies, launch, close)`` of one region call of ``wants`` (of
    DArrays or rank lists, ``multihost.exchange``'s), built once, for
    timing its launch (counted as ``kernel``) alone: the handles
    exchanged and the peer allocations mapped as ``process_regions`` does;
    ``close`` unmaps them (every process must have finished its launches:
    call it after a barrier)."""
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.synchronize()
    every = MH._all_gather_json(tag, CC.region_handles(arrays))
    mapped = CC._Mapped(dev)
    copies = CC.region_copies(arrays, wants, every, mapped)

    def launch():
        CC._copy_on_card(copies, dev, kernel, "cross_process_region")
    return copies, launch, mapped.close


def _host_ms(MH, fn, tag: str):
    """``(result, ms)``: one collective call's host time, synchronised,
    every process entering it together."""
    MH.sync_hosts(tag)
    return _host_call_ms(fn)


def _bits(t: torch.Tensor) -> str:
    """A 0-d result's exact bits, as hex."""
    return t.detach().cpu().numpy().tobytes().hex()


def _sha256(t: torch.Tensor) -> str:
    """The SHA-256 of a tensor's bytes (any dtype, bf16 included)."""
    import hashlib
    return hashlib.sha256(t.detach().contiguous().reshape(-1).view(
        torch.uint8).cpu().numpy()).hexdigest()


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit equality of two tensors of any dtype."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


class _PeerView:
    """A float32 view of device memory at a raw address (a peer process's
    chunk mapped through CUDA IPC), for ``torch.as_tensor``."""

    def __init__(self, ptr: int, shape):
        self.__cuda_array_interface__ = {
            "shape": tuple(shape), "typestr": "<f4", "data": (ptr, False),
            "version": 2, "strides": None}


def _event_batches(fn, reps: int = MH_REPS, batch: int = MH_BATCH) -> float:
    """Device ms per call: the median of ``reps`` CUDA-event batches of
    ``batch`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(batch):
            fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / batch)
    return statistics.median(times)


def _solo_ms(MH, proc: int, fn, tag: str, reps: int = MH_REPS,
             batch: int = MH_BATCH) -> float:
    """``fn``'s device ms a call on this process with the card to itself:
    the processes take turns, the others waiting at a barrier (a host
    wait: nothing of theirs runs on the card), each timing by CUDA events
    (``_event_batches``)."""
    ms = None
    for q in range(MH_PROCS):
        MH.sync_hosts(tag)
        if q == proc:
            ms = _event_batches(fn, reps, batch)
        MH.sync_hosts(tag + "_done")
    return ms


def _all_four_ms(MH, fn, tag: str, batch: int) -> dict:
    """Every process's ``batch`` calls of ``fn`` at once, timed by one host
    window from a barrier to the next barrier, which no process leaves
    before every process's calls have finished on the card: a call's
    share of the window (``ms``, the median of ``MH_REPS`` windows; the
    largest over the processes is the window that holds all their work),
    and an empty window's (``barrier_ms``, the barriers alone)."""
    def window(n):
        torch.cuda.synchronize()
        MH.sync_hosts(tag)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        MH.sync_hosts(tag + "_done")
        return (time.perf_counter() - t0) * 1e3
    window(1)
    return {"ms": statistics.median(window(batch) / batch
                                    for _ in range(MH_REPS)),
            "barrier_ms": statistics.median(window(0)
                                            for _ in range(MH_REPS))}


def _counts(kbuild) -> dict:
    return {"all_gather": kbuild.launch_counts()["all_gather"],
            "region": kbuild.route_counts()["all_gather"][
                "cross_process_region"],
            "gemm": kbuild.launch_counts()["gemm"]}


def multihost_ops(tdat, MH, CC, kbuild, A, proc: int, out_dir: str) -> dict:
    """The ops that run across the processes (one process of
    ``multihost_phase``): the distributed GEMM, a relayout, ``dtranspose``,
    ``dcumsum``, ``djit``, and the mapping lifetime.  Each region call is
    one K10 launch a process on the ``cross_process_region`` route, bit
    for bit the plain route's; the results' SHA-256 go to the parent,
    which holds them against one process on 4 ranks."""
    from distributedarrays_tpu_torch.ops import linalg as LA
    dev = tdat.layout.local_device()
    out = {}

    # the GEMM: A (2,2) @ B (2,2) at 16384^2 f32 spanning the processes
    tdat.seed(MH_SEED + 1)
    GA = tdat.drand((MH_N, MH_N), dist=(2, 2))
    GB = tdat.drand((MH_N, MH_N), dist=(2, 2))
    kbuild.reset_launches()
    GC, call_ms = _host_ms(MH, lambda: GA @ GB, "gemm")
    out["gemm_launches"] = _counts(kbuild)
    if out["gemm_launches"] != {"all_gather": 1, "region": 1, "gemm": 0}:
        raise AssertionError(f"the GEMM's launches {out['gemm_launches']}: "
                             "one region copy a process expected")
    calls = [call_ms] + [_host_ms(MH, lambda: GA @ GB, "gemm")[1]
                         for _ in range(2)]
    out["gemm_call_ms"] = calls
    C = MH._gather_tensor(GC).cpu()
    out["gemm_sha"] = _sha256(C)
    if proc == 0:
        ref = torch.from_numpy(np.load(os.path.join(out_dir, "gemm_ref.npy")))
        out["gemm_bit_equal"] = _same_bits(C, ref)
        out["gemm_max_abs_err"] = float((C - ref).abs().max())
        out["gemm_max_abs"] = float(ref.abs().max())
        del ref
    del C
    # the fetch alone: this process's panels, as the GEMM asks for them
    ci = next(c for c in GC.cells() if int(GC.pids[c]) == proc)
    rows = (GC.cuts[0][ci[0]], GC.cuts[0][ci[0] + 1])
    cols = (GC.cuts[1][ci[1]], GC.cuts[1][ci[1] + 1])
    pa = torch.empty(rows[1] - rows[0], MH_N, device=dev)
    pb = torch.empty(MH_N, cols[1] - cols[0], device=dev)
    wants = [(0, [rows, (0, MH_N)], pa), (1, [(0, MH_N), cols], pb)]
    _, fetch_ms = _host_ms(MH, lambda: CC.process_regions(
        [GA, GB], wants, lambda o: MH._all_gather_json("fetch", o),
        lambda: MH.sync_hosts("fetch")), "fetch")
    plain = _plain_fetch(MH, CC, [(GA, wants[0][1]), (GB, wants[1][1])])
    out["fetch_plain_equal"] = _same_bits(pa.cpu(), plain[0]) and \
        _same_bits(pb.cpu(), plain[1])
    if not out["fetch_plain_equal"]:
        raise AssertionError("the GEMM's panels differ from the plain route")
    del plain
    _, launch, unmap = _region_launcher(MH, CC, [GA, GB], wants, "gemm_t")
    out["fetch_solo_ms"] = _solo_ms(MH, proc, launch, "fetch_solo")
    out["fetch_all_four"] = _all_four_ms(MH, launch, "fetch_all",
                                         MH_WINDOW_BATCH)
    torch.cuda.synchronize()
    MH.sync_hosts("fetch_timed")
    unmap()
    out["fetch_call_ms"] = fetch_ms
    out["product_solo_ms"] = _solo_ms(
        MH, proc, lambda: LA.torch_matmul(pa, pb), "product",
        MH_MM_REPS, MH_MM_BATCH)
    if not _same_bits(LA.torch_matmul(pa, pb).cpu(), GC.localpart(proc).cpu()):
        raise AssertionError("the GEMM's cell is not its panels' product")
    del pa, pb
    for d in (GA, GB, GC):
        d.close()
    torch.cuda.empty_cache()

    # a relayout of A from (4,1) to (1,4): an all-to-all across processes
    pids = np.arange(MH_PROCS).reshape(1, MH_PROCS)
    cuts = tdat.layout.chunk_idxs(A.dims, (1, MH_PROCS))[1]
    kbuild.reset_launches()
    RB, out["relayout_call_ms"] = _host_ms(
        MH, lambda: tdat.reshard.reshard(A, pids, cuts), "relayout")
    out["relayout_launches"] = _counts(kbuild)
    if out["relayout_launches"] != {"all_gather": 1, "region": 1,
                                    "gemm": 0}:
        raise AssertionError(f"the relayout's launches "
                             f"{out['relayout_launches']}")
    box = [(0, MH_N), (cuts[1][proc], cuts[1][proc + 1])]
    plain = _plain_fetch(MH, CC, [(A, box)])[0]
    if not _same_bits(RB.localpart(proc).cpu(), plain):
        raise AssertionError("the relayout differs from the plain route")
    del plain
    out["relayout_sha"] = _sha256(MH._gather_tensor(RB))
    mine = RB.localpart(proc)
    _, launch, unmap = _region_launcher(MH, CC, [A], [(0, box, mine)],
                                        "relayout_t")
    out["relayout_solo_ms"] = _solo_ms(MH, proc, launch, "relayout_solo")
    out["relayout_all_four"] = _all_four_ms(
        MH, launch, "relayout_all", 4 * MH_WINDOW_BATCH)
    torch.cuda.synchronize()
    MH.sync_hosts("relayout_timed")
    unmap()
    RB.close()

    # dtranspose on (2,2), dcumsum along 0 on (4,1), djit(sin) on the
    # chain's default layout, each gathered
    tdat.seed(MH_SEED + 3)
    T22 = tdat.drand((MH_CHAIN_N, MH_CHAIN_N), dist=(2, 2))
    T41 = tdat.drand((MH_CHAIN_N, MH_CHAIN_N), dist=(MH_PROCS, 1))
    X = tdat.drand((MH_CHAIN_N, MH_CHAIN_N))
    kbuild.reset_launches()
    T = tdat.dtranspose(T22)
    out["transpose_launches"] = _counts(kbuild)
    out["transpose_sha"] = _sha256(MH._gather_tensor(T))
    out["cumsum_sha"] = _sha256(MH._gather_tensor(
        tdat.dcumsum(T41, axis=0)))
    kbuild.reset_launches()
    J = tdat.djit(torch.sin)(X)
    out["djit_launches"] = _counts(kbuild)
    if out["djit_launches"]["region"] != 1:
        raise AssertionError(f"djit's launches {out['djit_launches']}")
    out["djit_sha"] = _sha256(MH._gather_tensor(J))
    for d in (T22, T41, X, T, J):
        d.close()
    torch.cuda.empty_cache()

    # the mapping lifetime: fresh relayouts with the cache emptied in every
    # process between rounds; the mappings open stay those of one call
    n = MH_MAP_N
    pids = np.arange(MH_PROCS).reshape(1, MH_PROCS)
    cuts = tdat.layout.chunk_idxs((n, n), (1, MH_PROCS))[1]
    lo, hi = cuts[1][proc], cuts[1][proc + 1]
    opened, peak = [0], [0]
    ipc_open = CC._ipc_open

    def counting_open(h, d):
        opened[0] += 1
        peak[0] = max(peak[0], len(CC._open_bases) + 1)
        return ipc_open(h, d)
    CC._ipc_open = counting_open
    bad, between = [], 0
    t0 = time.perf_counter()
    try:
        for rnd in range(MH_MAP_ROUNDS):
            host = ((torch.arange(n * n, device=dev) % 9973) + rnd).float() \
                .reshape(n, n)
            src = tdat.distribute(host, dist=(MH_PROCS, 1))
            dst = tdat.reshard.reshard(src, pids, cuts)
            if not torch.equal(dst.localpart(proc), host[:, lo:hi]):
                bad.append(rnd)
            between = max(between, CC.open_mappings())
            src.close()
            dst.close()
            del host
            torch.cuda.empty_cache()
            MH.sync_hosts("round")
    finally:
        CC._ipc_open = ipc_open
    out["map_rounds"] = {"rounds": MH_MAP_ROUNDS, "bad": bad,
                         "opened": opened[0], "peak_open": peak[0],
                         "open_between_calls": between,
                         "s": time.perf_counter() - t0}
    if bad or between or peak[0] > MH_PROCS - 1:
        raise AssertionError(f"mapping rounds {out['map_rounds']}")
    # a gather after a peer frees its array and allocates anew
    hostE = (torch.arange(n * n, device=dev) % 7919).float().reshape(n, n)
    E = tdat.distribute(hostE, dist=(MH_PROCS, 1))
    ok = torch.equal(MH._gather_tensor(E), hostE)
    before = E.localpart(proc).data_ptr()
    E.close()
    torch.cuda.empty_cache()
    MH.sync_hosts("freed")
    hostF = hostE.flip(0).contiguous()
    F = tdat.distribute(hostF, dist=(MH_PROCS, 1))
    out["realloc_same_address"] = F.localpart(proc).data_ptr() == before
    ok = ok and torch.equal(MH._gather_tensor(F), hostF)
    out["realloc_gather_ok"] = bool(ok)
    if not ok:
        raise AssertionError("a gather after a peer reallocated is wrong")
    F.close()
    out["open_mappings_end"] = CC.open_mappings()
    return out


# the ops on the rank-list exchange across the 4 processes, at full width
MH_FFT_N = 8192            # the sort/FFT/conv phase's 8192^2 complex64
MH_SORTS = (10 ** 7, 10 ** 8)   # bench.py cfg_sort's drand(1e7), and 1e8
MH_CONV_N = 8192
MH_ATTN = (8192, 16, 64)   # the flagship attention (PERF.md section 2)
MH_KM = (2 ** 24, 32, 64, 5)    # rows, dim, k, iterations
MH_I8_N = 16384
MH_LEG_REPS, MH_LEG_BATCH = 5, 5
# tolerances against the whole-array library calls, as the error's
# Frobenius norm over the library result's (one process on 4 ranks is held
# bit for bit; these hold the port's numerics; a wrong result reads ~1)
MH_FFT_TOL = 1e-5      # complex64 transforms of 8192 terms (~1.5e-7)
MH_CONV_TOL = 1e-5     # F.conv2d per rank vs whole: another cuDNN order
MH_ATTN_TOL = 1e-2     # bf16 K9/K5 vs SDPA in bf16 (~2e-3; a K/V block
#                        missed by the last quarter of the rows reads 0.13)
MH_I8_TOL = 2.5e-2     # per-row/column int8 codes vs the f32 product (~1.2e-2)


def _leg_inputs(tdat, dev) -> dict:
    """The legs' inputs, the same on one process and on the 4 (each rank
    draws from its own generator; the host tensors from fixed seeds)."""
    S, H, D = MH_ATTN
    n, dim, _, _ = MH_KM
    out = {}
    tdat.seed(MH_SEED + 5)
    F = tdat.drand((MH_FFT_N, MH_FFT_N), dist=(MH_PROCS, 1))
    out["fft"] = F.astype(torch.complex64)
    F.close()
    tdat.seed(MH_SEED + 6)
    out["sort"] = [tdat.drand((m,)) for m in MH_SORTS]
    tdat.seed(MH_SEED + 7)
    out["conv"] = tdat.drand((MH_CONV_N, MH_CONV_N), dist=(MH_PROCS, 1))
    g = torch.Generator().manual_seed(MH_SEED + 7)
    out["k3"], out["k5"] = torch.randn(3, 3, generator=g), \
        torch.randn(5, 5, generator=g)
    tdat.seed(MH_SEED + 8)
    qkv = [tdat.drandn((S, H, D), dist=(MH_PROCS, 1, 1)) for _ in range(3)]
    out["attn"] = [x.astype(torch.bfloat16) for x in qkv]
    for x in qkv:
        x.close()
    tdat.seed(MH_SEED + 9)
    out["km"] = tdat.drand((n, dim), dist=(MH_PROCS, 1))
    tdat.seed(MH_SEED + 10)
    out["i8a"] = tdat.drandn((MH_I8_N, MH_I8_N), dist=(MH_PROCS, 1))
    out["i8b"] = torch.randn(MH_I8_N, MH_I8_N, device=dev,
                             generator=torch.Generator(device=dev)
                             .manual_seed(MH_SEED + 10))
    return out


def _leg_calls(tdat, A, inp) -> list:
    """``(name, call)`` of every leg, in the order every process runs
    them; a call returns a DArray, a list of rank tensors, or the
    k-means pair."""
    S, H, D = MH_ATTN
    _, _, k, iters = MH_KM
    q, kk, v = inp["attn"]
    return [
        ("spmd_pshift", lambda: tdat.run_spmd(
            lambda b: tdat.pshift([x[0] for x in b], 1), A.pids.tolist(),
            A)),
        ("dfft", lambda: tdat.dfft(inp["fft"], axis=0)),
        ("dfft2", lambda: tdat.dfft2(inp["fft"])),
        ("dsort_1e7", lambda: tdat.dsort(inp["sort"][0])),
        ("dsort_1e8", lambda: tdat.dsort(inp["sort"][1])),
        ("dconv2d_3", lambda: tdat.dconv2d(inp["conv"], inp["k3"])),
        ("dconv2d_5", lambda: tdat.dconv2d(inp["conv"], inp["k5"])),
        ("ring_attention", lambda: tdat.ring_attention(q, kk, v,
                                                       causal=True)),
        ("ulysses", lambda: tdat.ulysses_attention(q, kk, v, causal=True)),
        ("kmeans", lambda: tdat.kmeans.kmeans(inp["km"], k, iters=iters,
                                              seed=MH_SEED)),
        ("int8", lambda: tdat.dmatmul_int8(inp["i8a"], inp["i8b"])),
    ]


# each leg's launches a process: (K10, K11) exchanges on the
# cross_process_region route, and the other kernels
MH_LEG_LAUNCHES = {
    "spmd_pshift": {"all_gather": 1, "all_to_all": 0},
    "dfft": {"all_gather": 0, "all_to_all": 2},
    "dfft2": {"all_gather": 0, "all_to_all": 2},
    "dsort_1e7": {"all_gather": 1, "all_to_all": 1},
    "dsort_1e8": {"all_gather": 1, "all_to_all": 1},
    "dconv2d_3": {"all_gather": 1, "all_to_all": 0},
    "dconv2d_5": {"all_gather": 1, "all_to_all": 0},
    "ring_attention": {"all_gather": 0, "all_to_all": 0, "ring_attention": 4,
                       "cross_process_forward": 3},
    "ulysses": {"all_gather": 0, "all_to_all": 4, "flash_attention": 1},
    "kmeans": {"all_gather": 1 + MH_KM[3], "all_to_all": 0},
    "int8": {"all_gather": 0, "all_to_all": 0, "matmul_int8": 1},
}
# the legs also run on the plain gloo route, held bit for bit
MH_PLAIN_LEGS = ("spmd_pshift", "dfft", "dsort_1e7", "dconv2d_3", "ulysses",
                 "kmeans")


def _leg_counts(kbuild, want: dict) -> dict:
    """This process's launches of the kernels in ``want`` since the last
    reset (K10/K11 on the cross-process route, K9's forwards into a peer
    process's slot)."""
    lc, rc = kbuild.launch_counts(), kbuild.route_counts()
    got = {}
    for kname in want:
        if kname == "cross_process_forward":
            got[kname] = rc["ring_attention_forward"]["cross_process"]
        else:
            got[kname] = lc[kname]
            if kname in ("all_gather", "all_to_all") and \
                    rc[kname]["cross_process_region"] != lc[kname]:
                got[kname + "_off_route"] = lc[kname] - \
                    rc[kname]["cross_process_region"]
    if "ring_attention" in want:
        got["k9_compute"] = sum(rc["ring_attention"].values())
    return got


def _leg_digest(MH, value) -> dict:
    """What the parent compares: the SHA-256 of a DArray's gathered value
    (and its layout), of this process's rank tensors, or of the k-means
    centroids."""
    if isinstance(value, list):
        return {"ranks": {str(i): _sha256(t) for i, t in enumerate(value)
                          if t.device.type != "meta"}}
    if isinstance(value, tuple):
        return {"sha": _sha256(value[0]), "shifts": _sha256(
            torch.from_numpy(np.asarray(value[1])))}
    return {"sha": _sha256(MH._gather_tensor(value)),
            "cuts": value.cuts, "pids": value.pids.tolist()}


def _local_parts(value) -> list:
    """This process's tensors of a leg's result, for the plain route's
    comparison."""
    if isinstance(value, list):
        return [t for t in value if t.device.type != "meta"]
    if isinstance(value, tuple):
        return [value[0]]
    return [t for t in value._parts.flat if t.device.type != "meta"]


def multihost_legs(tdat, MH, CC, kbuild, A, proc: int) -> dict:
    """The ops on the rank-list exchange across the processes (one process
    of ``multihost_phase``), each at full width: its launches held, its
    result's digest for the parent (which holds it against one process on
    4 ranks), the plain gloo route's result held bit for bit where the
    work is the same, no mapping left open, and its readings: the whole
    call's host ms (its first call, then a warm one), the exchange's
    launch alone and all four at once against their bytes, ring
    attention's host ms a step."""
    dev = tdat.layout.local_device()
    inp = _leg_inputs(tdat, dev)
    out = {}
    exchange = MH.exchange
    sync_hosts = MH.sync_hosts
    for name, call in _leg_calls(tdat, A, inp):
        t_leg = time.perf_counter()
        want = MH_LEG_LAUNCHES[name]

        def run(tag):
            """One call of the leg, its launches counted alone: the value,
            the host ms, its exchanges and ring attention's steps."""
            rec, steps = [], []

            def recording(sources, wants, kernel="all_gather",
                          op="exchange"):
                rec.append((sources, wants, kernel))
                return exchange(sources, wants, kernel, op)

            def stepping(tag="sync"):
                if tag == "ring_attention_step":
                    steps.append(time.perf_counter())
                return sync_hosts(tag)
            MH.sync_hosts(f"leg_{tag}_{name}")
            torch.cuda.synchronize()
            kbuild.reset_launches()
            MH.exchange, MH.sync_hosts = recording, stepping
            try:
                t0 = time.perf_counter()
                value = call()
                torch.cuda.synchronize()
                call_ms = (time.perf_counter() - t0) * 1e3
            finally:
                MH.exchange, MH.sync_hosts = exchange, sync_hosts
            got = _leg_counts(kbuild, want)
            if any(got.get(k) != v for k, v in want.items()) or \
                    any(k.endswith("_off_route") for k in got):
                raise AssertionError(f"{name} ({tag} call): launches {got}, "
                                     f"expected {want}")
            if name == "ring_attention" and not 1 <= got["k9_compute"] <= 4:
                raise AssertionError(f"{name}: {got['k9_compute']} K9 "
                                     "compute steps on one rank")
            if CC.open_mappings():
                raise AssertionError(f"{name} ({tag} call) left "
                                     f"{CC.open_mappings()} peer mappings "
                                     "open")
            marks = [t0] + steps
            return value, call_ms, got, rec, \
                [(y - x) * 1e3 for x, y in zip(marks, marks[1:])]
        free_gib = torch.cuda.mem_get_info()[0] / 2 ** 30
        value, first_ms, _, _, first_steps = run("first")
        del value
        value, call_ms, got, rec, step_ms = run("warm")
        res = {"launches": got, "call_ms": call_ms, "first_call_ms": first_ms,
               "open_after": CC.open_mappings(), "free_gib": free_gib}
        if name == "ring_attention":
            res["step_ms"], res["first_step_ms"] = step_ms, first_steps
        res.update(_leg_digest(MH, value))
        if name in MH_PLAIN_LEGS:
            # the same call with every exchange on the gloo route
            kernel_route = MH._kernel_route
            MH._kernel_route = lambda: False
            try:
                plain = call()
            finally:
                MH._kernel_route = kernel_route
            res["plain_equal"] = all(
                _same_bits(a, b) for a, b in zip(_local_parts(value),
                                                     _local_parts(plain)))
            if not res["plain_equal"]:
                raise AssertionError(f"{name}: the IPC route differs from "
                                     "the plain gloo route")
            del plain
        if rec:
            # the leg's largest exchange, timed alone and all four at once
            def nbytes(r):
                return sum(w[-1].numel() * w[-1].element_size()
                           for w in r[1])
            sources, wants, kernel = max(rec, key=nbytes)
            _, launch, close = _region_launcher(
                MH, CC, sources, wants, "leg_t_" + name, kernel)
            res["kernel"] = kernel
            # each byte a want fills is read once and written once
            res["bytes"] = 2 * nbytes((sources, wants))
            res["solo_ms"] = _solo_ms(MH, proc, launch, "leg_solo_" + name,
                                      MH_LEG_REPS, MH_LEG_BATCH)
            res["all_four"] = _all_four_ms(MH, launch, "leg_all_" + name,
                                           MH_LEG_BATCH)
            torch.cuda.synchronize()
            MH.sync_hosts("leg_timed_" + name)
            close()
        del value, rec
        res["s"] = time.perf_counter() - t_leg
        out[name] = res
    for v in inp.values():
        for d in (v if isinstance(v, list) else [v]):
            if isinstance(d, tdat.DArray):
                d.close()
    torch.cuda.empty_cache()
    out["open_mappings_end"] = CC.open_mappings()
    return out


def _rel_fro(got, lib) -> float:
    """``||got - lib|| / ||lib||`` in Frobenius norm, in double precision."""
    wide = torch.complex128 if lib.is_complex() else torch.float64
    lib = lib.to(wide)
    return float(torch.linalg.vector_norm(got.to(wide) - lib)
                 / torch.linalg.vector_norm(lib))


def multihost_legs_reference(tdat, A) -> dict:
    """The legs on one process's 4 ranks of the card: each result's digest,
    and each held against its whole-array library call where one exists
    (``torch.fft``, ``torch.sort``, ``F.conv2d``,
    ``scaled_dot_product_attention``, the f32 product for the int8 GEMM)
    at its stated tolerance."""
    import torch.nn.functional as F
    torch.backends.cudnn.allow_tf32 = False     # the port's convs' setting
    dev = tdat.layout.local_device()
    inp = _leg_inputs(tdat, dev)
    ref = {}
    for name, call in _leg_calls(tdat, A, inp):
        value = call()
        torch.cuda.synchronize()
        if isinstance(value, list):
            ref[name] = {"ranks": {str(i): _sha256(t)
                                   for i, t in enumerate(value)}}
            want = [A.localpart((i - 1) % MH_PROCS) for i in range(MH_PROCS)]
            ref[name]["library_err"] = max(float((t - w).abs().max())
                                           for t, w in zip(value, want))
            ref[name]["library_tol"] = 0.0
            if ref[name]["library_err"]:
                raise AssertionError(f"{name}: one process on 4 ranks is not "
                                     "the shifted blocks")
            del value
            continue
        if isinstance(value, tuple):
            ref[name] = {"sha": _sha256(value[0]), "shifts": _sha256(
                torch.from_numpy(np.asarray(value[1]))),
                "library_err": None}
            del value
            continue
        whole = value.full()
        ref[name] = {"sha": _sha256(whole), "cuts": value.cuts,
                     "pids": value.pids.tolist()}
        lib, tol = None, 0.0
        if name == "dfft":
            lib = torch.fft.fft(inp["fft"].full(), dim=0)
            tol = MH_FFT_TOL
        elif name == "dfft2":
            lib = torch.fft.fft2(inp["fft"].full())
            tol = MH_FFT_TOL
        elif name.startswith("dsort"):
            lib = torch.sort(inp["sort"][name == "dsort_1e8"].full()).values
        elif name.startswith("dconv2d"):
            kern = inp["k3" if name == "dconv2d_3" else "k5"].to(dev)
            kh = kern.shape[0] // 2
            lib = F.conv2d(inp["conv"].full()[None, None], kern[None, None],
                           padding=kh)[0, 0]
            tol = MH_CONV_TOL
        elif name in ("ring_attention", "ulysses"):
            q, kk, v = (x.full().transpose(0, 1) for x in inp["attn"])
            lib = F.scaled_dot_product_attention(
                q, kk, v, is_causal=True).transpose(0, 1)
            tol = MH_ATTN_TOL
        elif name == "int8":
            lib = inp["i8a"].full() @ inp["i8b"]
            tol = MH_I8_TOL
        if lib is not None:
            err = _rel_fro(whole, lib) if tol else \
                float((whole.to(lib.dtype) - lib).abs().max().float())
            ref[name]["library_err"] = err
            ref[name]["library_tol"] = tol
            if ref[name]["library_err"] > tol:
                raise AssertionError(f"{name}: one process on 4 ranks is "
                                     f"{ref[name]['library_err']} from the "
                                     f"library call (tolerance {tol})")
        del value, whole, lib
    tdat.d_closeall()
    torch.cuda.empty_cache()
    return ref


def multihost_legs_row(res, ref) -> dict:
    """Each leg's readings across the 4 processes beside its bounds: the
    exchange's launch alone (this process's bytes) and all four at once
    (all four's bytes), the whole call, ring attention's steps."""
    rows = {}
    for name in MH_LEG_LAUNCHES:
        legs = [r["legs"][name] for r in res]
        row = {"launches": [x["launches"] for x in legs],
               "call_ms": [x["call_ms"] for x in legs],
               "first_call_ms": [x["first_call_ms"] for x in legs],
               # the card's free memory as each process entered the leg
               "free_gib": [x["free_gib"] for x in legs],
               "s": [x["s"] for x in legs],
               "library_err": ref[name].get("library_err"),
               "library_tol": ref[name].get("library_tol"),
               "plain_equal": [x.get("plain_equal") for x in legs]}
        if "bytes" in legs[0]:
            row.update({
                "kernel": legs[0]["kernel"],
                "bytes": [x["bytes"] for x in legs],
                "solo_ms": [x["solo_ms"] for x in legs],
                "solo_bound_ms": [bound(x["bytes"], 0, F32_FLOPS)[0]
                                  for x in legs],
                "all_four_ms": max(x["all_four"]["ms"] for x in legs),
                "all_four_barrier_ms": max(x["all_four"]["barrier_ms"]
                                           for x in legs),
                "all_four_bound_ms": bound(sum(x["bytes"] for x in legs), 0,
                                           F32_FLOPS)[0]})
        if name == "ring_attention":
            S, H, D = MH_ATTN
            row["step_ms"] = [x["step_ms"] for x in legs]
            row["first_step_ms"] = [x["first_step_ms"] for x in legs]
            # causal: half of the S^2 scores, 4 S^2 H D / 2 operations
            row["bound_ms"] = bound(4 * S * H * D * 2, 2 * S * S * H * D,
                                    BF16_FLOPS)[0]
        rows[name] = row
    return rows


def _check_legs(res, ref) -> None:
    """Every process's leg results against one process on 4 ranks: the
    same digests (bit for bit) and layouts; a rank-list result rank by
    rank."""
    for r in res:
        for name in MH_LEG_LAUNCHES:
            got, want = r["legs"][name], ref[name]
            if "ranks" in want:
                for i, sha in got["ranks"].items():
                    if sha != want["ranks"][i]:
                        raise AssertionError(f"process {r['process']}: "
                                             f"{name} rank {i} differs from "
                                             "one process's")
                continue
            for k in ("sha", "shifts", "cuts", "pids"):
                if k in want and got.get(k) != want[k]:
                    raise AssertionError(f"process {r['process']}: {name} "
                                         f"{k} differs from one process's")
    # K9: 10 of the 16 causal steps accumulate, over the four processes
    k9 = sum(r["legs"]["ring_attention"]["launches"]["k9_compute"]
             for r in res)
    if k9 != 10:
        raise AssertionError(f"ring attention: {k9} K9 compute steps, not 10")


# --- the multihost phase's sequence-parallel training legs ---------------

MH_FFN = (2048, 1024, 1024)   # tp_ffn a rank: x (s_loc, e), w1 (e, f_loc)
MH_TRAIN_SEED = MH_SEED + 12
MH_FFN_TOL = 1e-2      # bf16 tp_ffn (h and gelu(h) rounded) vs its f32 product


def _rank_blocks(tdat, x: torch.Tensor, dim: int = 0) -> list:
    """``x`` cut into one block a rank along ``dim``: this process's ranks'
    as contiguous tensors on their devices, another process's as ``meta``
    placeholders."""
    out = []
    for r, c in enumerate(x.chunk(tdat.nranks(), dim)):
        dev = tdat.layout.device_of(r)
        out.append(torch.empty(c.shape, dtype=c.dtype, device=dev)
                   if dev.type == "meta" else c.to(dev).contiguous())
    return out


def _with_grads(fn, blocks, cot) -> dict:
    """``fn(*blocks)`` (rank lists in, a rank list out) and the gradients
    of ``sum_r <out_r, cot_r>`` over this process's ranks with respect to
    each rank list of ``blocks`` (``value_and_grad``: in a job the backward
    on the calling thread), as ``{"out": ..., "d0": ..., ...}``."""
    from distributedarrays_tpu_torch.models._autodiff import value_and_grad
    own = [r for r, c in enumerate(cot) if c.device.type != "meta"]
    got = {}

    def loss():
        got["out"] = fn(*blocks)
        acc = None
        for r in own:
            term = (got["out"][r].float() * cot[r].float()).sum()
            acc = term if acc is None else acc + term
        return acc
    _, grads = value_and_grad(loss, [b[r] for b in blocks for r in own])
    got["out"] = [o.detach() for o in got["out"]]
    for i, b in enumerate(blocks):
        d = [torch.empty_like(x) for x in b]
        for j, r in enumerate(own):
            d[r] = grads[i * len(own) + j]
        got[f"d{i}"] = d
    return got


def _train_inputs(tdat, dev) -> dict:
    """The training legs' inputs, the same on one process and on the 4
    (drawn whole from fixed seeds on every process, each process keeping
    its ranks' blocks): q, k, v and the cotangent (S = 8192, 16 x 64 bf16,
    as rank blocks), ``tp_ffn``'s x, w1, w2 and cotangent (``MH_FFN``
    bf16), and the SP model (``SP_CFG`` bf16, phase 7d's weights) with its
    tokens (1, 8192), contiguous and zigzag."""
    SP = tdat.sp_transformer
    S, H, D = MH_ATTN
    s_loc, e, f_loc = MH_FFN
    p = tdat.nranks()
    gen = torch.Generator(device=dev).manual_seed(MH_TRAIN_SEED)

    def whole(*shape):
        return torch.randn(*shape, generator=gen, device=dev).bfloat16()
    inp = {"qkvg": [_rank_blocks(tdat, whole(S, H, D)) for _ in range(4)],
           "ffn": [_rank_blocks(tdat, whole(p * s_loc, e)),
                   _rank_blocks(tdat, whole(e, p * f_loc) / e ** 0.5, 1),
                   _rank_blocks(tdat, whole(p * f_loc, e)
                                / (p * f_loc) ** 0.5),
                   _rank_blocks(tdat, whole(p * s_loc, e))]}
    cfg = SP.SPConfig(*SP_CFG, torch.bfloat16)
    mgen = torch.Generator(device=dev).manual_seed(11)
    inp["model"] = SP.init_params(cfg, mgen, dev)
    inp["tokens"] = torch.randint(0, cfg.vocab, (1, SP_CFG[5]),
                                  generator=mgen, device=dev,
                                  dtype=torch.int32)
    inp["ztokens"] = inp["tokens"][:, torch.from_numpy(
        tdat.zigzag_order(SP_CFG[5], p)).to(dev)]
    return inp


def _train_calls(tdat, inp) -> list:
    """``(name, call)`` of the training legs, in the order every process
    runs them: the flash and zigzag rings (causal) and ``tp_ffn`` forward
    and backward on rank lists, and the SP model: a gradient step
    contiguous and zigzag, and one SGD step, each from the same weights.
    Each call returns ``{key: rank list or 0-d tensor}``."""
    from distributedarrays_tpu_torch.models import ring_attention as RA
    SP = tdat.sp_transformer
    ranks = list(range(tdat.nranks()))
    q, k, v, g = inp["qkvg"]
    x, w1, w2, gy = inp["ffn"]
    cfg = SP.SPConfig(*SP_CFG, torch.bfloat16)
    zcfg = SP.SPConfig(*SP_CFG, torch.bfloat16, zigzag=True)

    def lists(per_rank):
        return {n: [d[n] for d in per_rank] for n in per_rank[0]}

    def grad(c, toks):
        def run():
            loss, grads = SP.make_grad_fn(ranks, c)(
                SP.shard_params(inp["model"], ranks), toks)
            return {"loss": loss, **lists(grads)}
        return run

    def sgd():
        shards, loss = SP.make_train_step(ranks, cfg)(
            SP.shard_params(inp["model"], ranks), inp["tokens"], SP_LR)
        return {"loss": loss, **lists([dict(m.named_parameters())
                                       for m in shards])}
    return [
        ("ring_flash", lambda: _with_grads(
            lambda *b: RA.ring_flash_attention_kernel(*b, True),
            [q, k, v], g)),
        ("zigzag_flash", lambda: _with_grads(
            RA.zigzag_ring_flash_attention_kernel, [q, k, v], g)),
        ("tp_ffn", lambda: _with_grads(tdat.collective_matmul.tp_ffn,
                                       [x, w1, w2], gy)),
        ("sp_grad", grad(cfg, inp["tokens"])),
        ("sp_grad_zigzag", grad(zcfg, inp["ztokens"])),
        ("sp_sgd", sgd),
    ]


def _train_launches(layers: int, maxp: int) -> dict:
    """Each training leg's launches a process (one rank a process of
    ``MH_PROCS``): K8/K6/K7 hops (``sp_step_launches`` over the ranks),
    K13/K14/K15 steps, the K10 exchanges on the cross-process route (the
    flash ring's 3 forward and 4 backward rotations a layer; the loss's
    token shifts (1, zigzag 2) and its ``preduce``; the replicated
    gradients' ``preduces``, one exchange of 4 + 4 ``layers`` names from
    each peer rank, launched ``maxp`` copies at a time), and the ring
    GEMMs' forwards into the neighbour process's slot (3 a call)."""
    hops = {False: 16 // MH_PROCS, True: 36 // MH_PROCS}
    flash = lambda z, n: {"flash_attention_hop": hops[z] * n,
                          "flash_attention_bwd_dq": hops[z] * n,
                          "flash_attention_bwd_dkv": hops[z] * n,
                          "all_gather": 7 * n}
    gemm = lambda n: {k: 8 * n for k in (
        "allgather_matmul", "allgather_matmul_rhs", "matmul_reducescatter")}
    fwd = lambda n: {k + "_forward": 6 * n for k in (
        "allgather_matmul", "allgather_matmul_rhs", "matmul_reducescatter")}
    none = dict.fromkeys([*flash(False, 0), *gemm(0), *fwd(0)], 0)
    shared = -(-(4 + 4 * layers) * (MH_PROCS - 1) // maxp)
    step = lambda z: {**flash(z, layers), **gemm(layers), **fwd(layers),
                      "all_gather": 7 * layers + (3 if z else 2) + shared}
    return {"ring_flash": {**none, **flash(False, 1)},
            "zigzag_flash": {**none, **flash(True, 1)},
            "tp_ffn": {**none, **gemm(1), **fwd(1)},
            "sp_grad": step(False), "sp_grad_zigzag": step(True),
            "sp_sgd": step(False)}


def _train_counts(kbuild) -> dict:
    """This process's launches since the last reset of the kernels in
    ``_train_launches``: the K10 launches off the cross-process route and
    the K8/K6/K7/K13/K14/K15 launches off wgmma counted apart."""
    lc, rc = kbuild.launch_counts(), kbuild.route_counts()
    got = {}
    for k in _train_launches(1, 1)["ring_flash"]:
        if k.endswith("_forward"):
            got[k] = rc[k]["cross_process"]
            continue
        got[k] = lc[k]
        on = rc[k]["cross_process_region" if k == "all_gather" else "wgmma"]
        if on != lc[k]:
            got[k + "_off_route"] = lc[k] - on
    return got


def _train_digest(value) -> dict:
    """The SHA-256 of each rank tensor this process holds (``key/rank``)
    and of each 0-d value (``key``)."""
    out = {}
    for key, v in value.items():
        if isinstance(v, torch.Tensor):
            out[key] = _sha256(v)
            continue
        for r, t in enumerate(v):
            if t.device.type != "meta":
                out[f"{key}/{r}"] = _sha256(t)
    return out


def multihost_train(tdat, MH, CC, kbuild) -> dict:
    """The sequence-parallel training legs across the processes (one
    process of ``multihost_phase``): each called twice (first, then warm),
    its launches held each time (``_train_launches``: this process's
    ranks only, on the wgmma and cross-process routes), no mapping left
    open, the digests of its values for the parent, and its readings: the
    call's host ms and the ring steps' host ms (the gaps between a ring
    GEMM's step barriers, and between the flash rings' exchanges) and the
    host protocol's parts (``host_split``: the IPC opens and closes, the
    store's handle exchanges and barriers)."""
    want_all = _train_launches(SP_CFG[3], CC.copy_maxp())
    out = {}
    exchange, sync_hosts = MH.exchange, MH.sync_hosts
    inp = _train_inputs(tdat, tdat.layout.local_device())
    for name, call in _train_calls(tdat, inp):
        want = want_all[name]

        def run(tag):
            marks = []
            # the host protocol's parts: IPC opens and closes, the store's
            # handle exchanges and barriers (ms, and the count of opens)
            split = dict.fromkeys(("ipc_open", "ipc_close", "handles",
                                   "barriers", "opens"), 0)

            def timed(fn, key):
                def wrapped(*a, **kw):
                    t = time.perf_counter()
                    try:
                        return fn(*a, **kw)
                    finally:
                        split[key] += (time.perf_counter() - t) * 1e3
                        split["opens"] += key == "ipc_open"
                return wrapped

            def rec_exchange(*a, **kw):
                marks.append(("exchange", time.perf_counter()))
                return exchange(*a, **kw)

            def rec_sync(tag="sync"):
                out_ = timed(sync_hosts, "barriers")(tag)
                marks.append((tag, time.perf_counter()))
                return out_
            MH.sync_hosts(f"train_{tag}_{name}")
            torch.cuda.synchronize()
            kbuild.reset_launches()
            saved = (CC._ipc_open, CC._ipc_close, MH._all_gather_json)
            MH.exchange, MH.sync_hosts = rec_exchange, rec_sync
            CC._ipc_open, CC._ipc_close, MH._all_gather_json = (
                timed(f, k) for f, k in zip(saved, ("ipc_open", "ipc_close",
                                                    "handles")))
            try:
                t0 = time.perf_counter()
                value = call()
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
            finally:
                MH.exchange, MH.sync_hosts = exchange, sync_hosts
                CC._ipc_open, CC._ipc_close, MH._all_gather_json = saved
            got = _train_counts(kbuild)
            if got != want:
                raise AssertionError(f"{name} ({tag} call): launches {got}, "
                                     f"expected {want}")
            if CC.open_mappings():
                raise AssertionError(f"{name} ({tag} call) left "
                                     f"{CC.open_mappings()} mappings open")
            gemm = [(b - a) * 1e3 for (ta, a), (tb, b) in zip(marks,
                                                               marks[1:])
                    if ta == "ring_gemm_step" and tb.startswith("ring_gemm")]
            ex = [t for tag_, t in marks if tag_ == "exchange"]
            flash = [(b - a) * 1e3 for a, b in zip(ex, ex[1:])]
            return value, ms, got, gemm, flash, split
        value, first_ms, _, first_gemm, first_flash, first_split = run(
            "first")
        del value
        value, ms, got, gemm, flash, split = run("warm")
        out[name] = {"launches": got, "first_call_ms": first_ms,
                     "call_ms": ms, "gemm_step_ms": gemm,
                     "first_gemm_step_ms": first_gemm,
                     "exchange_gap_ms": flash,
                     "first_exchange_gap_ms": first_flash,
                     "host_split": split, "first_host_split": first_split,
                     "digest": _train_digest(value)}
        del value
        torch.cuda.empty_cache()
    del inp
    torch.cuda.empty_cache()
    out["open_mappings_end"] = CC.open_mappings()
    return out


def multihost_train_reference(tdat) -> dict:
    """The training legs on one process's 4 ranks of the card: each
    result's digests (what the processes must reproduce bit for bit; a
    second call must give the same), the host ms of a first and a second
    call, the flash rings' outputs held against
    ``scaled_dot_product_attention`` and ``tp_ffn``'s against its f32
    product, at ``MH_ATTN_TOL`` and ``MH_FFN_TOL``."""
    import torch.nn.functional as F
    dev = tdat.layout.local_device()
    inp = _train_inputs(tdat, dev)
    ref = {}
    for name, call in _train_calls(tdat, inp):
        value, first_ms = _host_call_ms(call)
        ref[name] = {"digest": _train_digest(value), "first_ms": first_ms}
        del value
        value, ref[name]["ms"] = _host_call_ms(call)
        if _train_digest(value) != ref[name]["digest"]:
            raise AssertionError(f"{name}: a second call on one process "
                                 "gave other bits")
        if name.startswith("sp_"):
            del value
            continue
        got = torch.cat(value["out"])
        if name == "tp_ffn":
            x, w1, w2, _ = (torch.cat(b, d).float() for b, d in zip(
                inp["ffn"], (0, 1, 0, 0)))
            lib, tol = F.gelu(x @ w1, approximate="tanh") @ w2, MH_FFN_TOL
        else:
            q, k, v = (torch.cat(b).transpose(0, 1) for b in inp["qkvg"][:3])
            if name == "zigzag_flash":
                # the blocks hold the sequence in zigzag order
                inv = torch.from_numpy(np.argsort(tdat.zigzag_order(
                    q.shape[1], MH_PROCS))).to(dev)
                q, k, v = (t[:, inv] for t in (q, k, v))
                got = got[inv]
            lib = F.scaled_dot_product_attention(
                q, k, v, is_causal=True).transpose(0, 1)
            tol = MH_ATTN_TOL
        ref[name]["library_err"] = _rel_fro(got, lib)
        ref[name]["library_tol"] = tol
        if not ref[name]["library_err"] <= tol:
            raise AssertionError(f"{name}: one process on 4 ranks is "
                                 f"{ref[name]['library_err']} from the "
                                 f"library call (tolerance {tol})")
        del value, got, lib
    del inp
    tdat.d_closeall()
    torch.cuda.empty_cache()
    return ref


def _check_train(res, ref) -> None:
    """Every process's training digests against one process on 4 ranks,
    bit for bit, rank by rank: each process holds its own rank's tensors
    and the loss."""
    for r in res:
        for name, want in ref.items():
            got = r["train"][name]["digest"]
            mine = {k for k in want["digest"] if "/" not in k or
                    k.endswith(f"/{r['process']}")}
            if set(got) != mine:
                raise AssertionError(f"process {r['process']}: {name} "
                                     f"holds {sorted(got)[:4]}...")
            for k, sha in got.items():
                if sha != want["digest"][k]:
                    raise AssertionError(f"process {r['process']}: {name} "
                                         f"{k} differs from one process's")
        if r["train"]["open_mappings_end"]:
            raise AssertionError(f"process {r['process']} left peer "
                                 "mappings open after the training legs")


def multihost_train_row(res, ref) -> dict:
    """The training legs' readings across the 4 processes beside one
    process on 4 ranks: launches a process, the whole call's host ms
    (first, warm), the ring steps' host ms."""
    rows = {}
    for name, want in ref.items():
        legs = [r["train"][name] for r in res]
        rows[name] = {
            "launches": legs[0]["launches"],
            "bit_equal_one_process": True,
            "call_ms": [x["call_ms"] for x in legs],
            "first_call_ms": [x["first_call_ms"] for x in legs],
            "one_process_ms": want["ms"],
            "one_process_first_ms": want["first_ms"],
            "gemm_step_ms_median": [
                statistics.median(x["gemm_step_ms"])
                if x["gemm_step_ms"] else None for x in legs],
            "exchange_gap_ms_median": [
                statistics.median(x["exchange_gap_ms"])
                if x["exchange_gap_ms"] else None for x in legs],
            "first_gemm_step_ms": legs[0]["first_gemm_step_ms"][:6],
            "host_split": [x["host_split"] for x in legs],
            "first_host_split": [x["first_host_split"] for x in legs],
            "library_err": want.get("library_err"),
            "library_tol": want.get("library_tol")}
    return rows


MH_TRAINER_STEPS = 3


def trainer_reference(tdat) -> dict:
    """The one-process 4-rank trainer's 3 Adam steps on
    ``transformer_task(**TRAINER_CFG)``: ``trainer_phase``'s record when
    it ran in this call, else the same steps run here."""
    if not _TRAINER_REF:
        train = tdat.train
        tdat.init(nranks=MH_PROCS)
        losses = []
        with train.Trainer(train.transformer_task(**TRAINER_CFG),
                           train.adam(1e-4)) as t:
            for _ in range(MH_TRAINER_STEPS):
                losses.append(t.step_once())
            _TRAINER_REF.update(losses=losses,
                                flat_sha=_sha256(t.flat_params()))
        tdat.d_closeall()
        torch.cuda.empty_cache()
    return dict(_TRAINER_REF)


def trainer_step_launches(layers: int) -> dict:
    """A process's launches in one step of the Trainer with one rank a
    process: one K10 (the parameter gather, on the cross-process region
    route), one K12 (its rank's sum, on the cross-process route), and K5,
    K6 and K7 once a layer."""
    return {"all_gather": 1, "reduce_scatter": 1, "flash_attention": layers,
            "flash_attention_bwd_dq": layers,
            "flash_attention_bwd_dkv": layers}


def _trainer_counts(kbuild, want: dict) -> dict:
    counts = kbuild.launch_counts()
    routes = kbuild.route_counts()
    got = {k: counts[k] for k in want}
    got["all_gather_cross_process"] = \
        routes["all_gather"]["cross_process_region"]
    got["reduce_scatter_cross_process"] = \
        routes["reduce_scatter"]["cross_process"]
    return got


def multihost_trainer(tdat, MH, kbuild, proc: int, out_dir: str) -> dict:
    """The data-parallel Trainer across the processes (one process of
    ``multihost_phase``, one rank each): ``transformer_task(**TRAINER_CFG)``
    f32, 3 Adam steps published by a checkpoint manager (each process
    writes its own copy), each step's launches held
    (``trainer_step_launches``), then a new trainer resuming from the
    published step.  Returns the losses and the flat parameters' digest
    (for the parent to hold against one process on 4 ranks), each step's
    host ms and its ``train.step_s`` gauge, the host ms of every K10 and
    K12 call, and the peak memory."""
    import shutil
    from distributedarrays_tpu_torch.train import trainer as TRM
    train = tdat.train
    want = trainer_step_launches(TRAINER_CFG["layers"])
    want_all = dict(want, all_gather_cross_process=1,
                    reduce_scatter_cross_process=1)
    calls = {"k10_ms": [], "k12_ms": []}
    saved = TRM.ring_all_gather, TRM.ring_reduce_scatter

    def timed(fn, key):
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                calls[key].append((time.perf_counter() - t0) * 1e3)
        return wrapped
    TRM.ring_all_gather = timed(saved[0], "k10_ms")
    TRM.ring_reduce_scatter = timed(saved[1], "k12_ms")
    ckpt = os.path.join(out_dir, f"trainer_ckpt_{proc}")
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {"losses": [], "step_ms": [], "step_s_gauge": [],
           "launches": []}
    try:
        task = train.transformer_task(**TRAINER_CFG)
        with train.Trainer(task, train.adam(1e-4), ckpt_dir=ckpt,
                           save_every=MH_TRAINER_STEPS) as t:
            for n in range(MH_TRAINER_STEPS):
                MH.sync_hosts("trainer_step")
                torch.cuda.synchronize()
                kbuild.reset_launches()
                t0 = time.perf_counter()
                out["losses"].append(t.step_once())
                torch.cuda.synchronize()
                out["step_ms"].append((time.perf_counter() - t0) * 1e3)
                out["step_s_gauge"].append(
                    tdat.telemetry.gauge_value("train.step_s"))
                got = _trainer_counts(kbuild, want)
                out["launches"].append(got)
                # the step that publishes the checkpoint also gathers
                # each state vector (pflat and Adam's two moments) for
                # this process's copy: one K10 each
                exp = want_all
                if (n + 1) % MH_TRAINER_STEPS == 0:
                    exp = dict(want_all, all_gather=4,
                               all_gather_cross_process=4)
                if got != exp:
                    raise AssertionError(f"trainer step {n}: launches "
                                         f"{got}, expected {exp}")
            out["flat_sha"] = _sha256(t.flat_params())
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        t0 = time.perf_counter()
        with train.Trainer(task, train.adam(1e-4), ckpt_dir=ckpt) as t2:
            t2.fit(MH_TRAINER_STEPS)
            out["resumed_step"] = t2.step
            out["resumed_flat_sha"] = _sha256(t2.flat_params())
        out["resume_s"] = time.perf_counter() - t0
    finally:
        TRM.ring_all_gather, TRM.ring_reduce_scatter = saved
        shutil.rmtree(ckpt, ignore_errors=True)
    out.update(calls)
    tdat.d_closeall()
    torch.cuda.empty_cache()
    return out


def _check_trainer(res, ref) -> None:
    """Every process's Trainer against one process on 4 ranks, bit for
    bit: the losses and the flat parameters, before and after the resume."""
    for r in res:
        got = r["trainer"]
        if got["losses"] != ref["losses"]:
            raise AssertionError(f"process {r['process']}: trainer losses "
                                 f"{got['losses']} != one process's "
                                 f"{ref['losses']}")
        if got["flat_sha"] != ref["flat_sha"] or \
                got["resumed_flat_sha"] != ref["flat_sha"] or \
                got["resumed_step"] != MH_TRAINER_STEPS:
            raise AssertionError(f"process {r['process']}: trainer flat "
                                 f"parameters differ from one process's "
                                 f"(resumed at step {got['resumed_step']})")


def multihost_trainer_row(res, ref) -> dict:
    """The Trainer's readings across the 4 processes beside one process
    on 4 ranks."""
    tr = [r["trainer"] for r in res]
    return {
        "shape": f"transformer_task {TRAINER_CFG} f32, adam, "
                 f"{MH_PROCS} processes of one rank on one card",
        "bit_equal_one_process": True,
        "losses": tr[0]["losses"],
        "launches_a_step": tr[0]["launches"][0],
        "launches_saving_step": tr[0]["launches"][-1],
        "first_step_ms": [x["step_ms"][0] for x in tr],
        # the warm steps' own time (the gauge the trainer sets before a
        # save), and step 2's wall with its save
        "warm_step_ms": [1e3 * statistics.median(x["step_s_gauge"][1:])
                         for x in tr],
        "step_ms": [x["step_ms"] for x in tr],
        "step_s_gauge": [x["step_s_gauge"] for x in tr],
        "k10_call_ms": [x["k10_ms"] for x in tr],
        "k12_call_ms": [x["k12_ms"] for x in tr],
        "peak_gib": [x["peak_gib"] for x in tr],
        "resume_s": [x["resume_s"] for x in tr],
        "one_process_step_ms": ref.get("step_ms")}


# ---------------------------------------------------------------------------
# the GSPMD tp/dp step across the processes, and the protocol model's
# conformance: each process's recorded events against the schedules
# ---------------------------------------------------------------------------

MH_TP_CFG = (8192, 1024, 16, 2, 4, 512)   # the flagship's width, 2 layers
MH_TP_STEPS = 2
MH_TP_SEED = MH_SEED + 21
# each recorded call's protocol, by the tag of its closing barrier
MH_PROTOCOL_CALLS = {"K9": ("ring_attention", "ring_attention"),
                     "K13": ("allgather_matmul", "ring_gemm"),
                     "K14": ("allgather_matmul_rhs", "ring_gemm"),
                     "K15": ("matmul_reducescatter", "ring_gemm"),
                     "K10": ("all_gather", "region"),
                     "K12": ("reduce_scatter", "reduce_scatter")}


def multihost_tp_dp_run(tdat) -> dict:
    """``MH_TP_STEPS`` SGD ``train_step``s of the transformer at
    ``MH_TP_CFG`` bf16 on ``shard_params``' layout over ``make_mesh`` of
    every rank, from seeded weights and tokens (4, seq + 1): the losses'
    bits and the unsharded parameters' SHA-256 (one process on 4 ranks
    and the 4 processes compute the same)."""
    T = tdat.transformer
    dev = tdat.layout.local_device()
    cfg = T.Config(*MH_TP_CFG, torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(MH_TP_SEED)
    model = T.init_params(cfg, gen, dev)
    tokens = torch.randint(0, cfg.vocab, (4, MH_TP_CFG[5] + 1),
                           generator=gen, device=dev, dtype=torch.int32)
    sp = T.shard_params(model, T.make_mesh(tdat.nranks()))
    losses = [T.train_step(sp, tokens, TRAIN_LR, cfg)[1]
              for _ in range(MH_TP_STEPS)]
    whole = T.unshard(sp)
    return {"losses": [_bits(x) for x in losses],
            "params": {n: _sha256(p) for n, p in whole.named_parameters()}}


def multihost_tp_dp(tdat, MH, kbuild) -> dict:
    """The tp/dp leg in a child: ``multihost_tp_dp_run`` with its events
    recorded (``ring_schedules.recording``) and held against the
    schedules (``conform``), its launches and cross-process routes."""
    from distributedarrays_tpu_torch.ops import ring_schedules as RS
    MH.sync_hosts("tp_dp")
    torch.cuda.synchronize()
    kbuild.reset_launches()
    t0 = time.perf_counter()
    with RS.recording() as seen:
        out = multihost_tp_dp_run(tdat)
    torch.cuda.synchronize()
    out["ms"] = (time.perf_counter() - t0) * 1e3
    counts, routes = kbuild.launch_counts(), kbuild.route_counts()
    out["launches"] = {k: counts[k] for k in TP_DP_KERNELS}
    out["cross_process"] = {
        "reduce_scatter": routes["reduce_scatter"]["cross_process"],
        "all_gather": routes["all_gather"]["cross_process_region"]}
    out["events"] = len(seen)
    out["calls"] = sum(e.startswith("barrier:") and e.partition(":")[2] in
                       RS.CALL_SCHEDULES for e in seen)
    out["conform"] = RS.conform(seen, MH_PROCS)
    torch.cuda.empty_cache()
    return out


def multihost_protocol(tdat, kbuild) -> dict:
    """The schedule conformance leg in a child: one call each of K9, K13,
    K14, K15, K10 and K12 on bf16 rank lists (one block a process), its
    events recorded and held against its schedule (``conform``), and its
    kernel's launches."""
    from distributedarrays_tpu_torch.models import ring_attention as RA
    from distributedarrays_tpu_torch.ops import cuda_collectives as CC
    from distributedarrays_tpu_torch.ops import ring_schedules as RS
    p = MH_PROCS
    dev = tdat.layout.local_device()
    gen = torch.Generator(device=dev).manual_seed(MH_SEED + 22)

    def blocks(*shape, dim=0):
        return _rank_blocks(tdat, torch.randn(
            shape, generator=gen, device=dev).bfloat16(), dim)
    q, k, v = (blocks(p * 256, 8, 64) for _ in range(3))
    x13, w13 = blocks(p * 256, 512), blocks(512, p * 512, dim=1)
    a14, b14 = blocks(p * 256, 512), blocks(512, 512)
    x15, w15 = blocks(512, p * 128, dim=1), blocks(p * 128, 512)
    g10 = blocks(p * 256, 512)
    r12 = blocks(p * p * 64, 512)
    calls = {"K9": lambda: RA.ring_attention_rdma(q, k, v, True),
             "K13": lambda: CC.ring_allgather_matmul(x13, w13),
             "K14": lambda: CC.ring_allgather_matmul_rhs(a14, b14),
             "K15": lambda: CC.ring_matmul_reducescatter(x15, w15),
             "K10": lambda: CC.ring_all_gather(g10, 0),
             "K12": lambda: CC.ring_reduce_scatter(r12, 0)}
    out = {}
    for name, call in calls.items():
        kernel, tag = MH_PROTOCOL_CALLS[name]
        torch.cuda.synchronize()
        kbuild.reset_launches()
        with RS.recording() as seen:
            call()
            torch.cuda.synchronize()
        out[name] = {"events": seen, "conform": RS.conform(seen, p),
                     "launches": kbuild.launch_counts()[kernel],
                     "closed": f"barrier:{tag}" in seen}
    del q, k, v, x13, w13, a14, b14, x15, w15, g10, r12
    torch.cuda.empty_cache()
    return out


def _check_tp_dp_and_protocol(res, ref) -> None:
    """The tp/dp leg bit-equal to one process on 4 ranks, launching K12
    and K10 on their cross-process routes; every recorded call of it and
    of the protocol leg conforming to its schedule."""
    for r in res:
        got = r["tp_dp"]
        if got["losses"] != ref["losses"] or got["params"] != ref["params"]:
            bad = [n for n in ref["params"]
                   if got["params"].get(n) != ref["params"][n]]
            raise AssertionError(f"process {r['process']}: the tp/dp step "
                                 f"differs from one process's (losses "
                                 f"{got['losses']} / {ref['losses']}, "
                                 f"parameters {bad[:4]})")
        if not all(got["cross_process"].values()) or \
                not all(got["launches"].values()):
            raise AssertionError(f"process {r['process']}: tp/dp launches "
                                 f"{got['launches']}, cross-process "
                                 f"{got['cross_process']}")
        if got["conform"] or not got["calls"]:
            raise AssertionError(f"process {r['process']}: the tp/dp step's "
                                 f"{got['calls']} calls depart from the "
                                 f"schedules: {got['conform'][:3]}")
        for name, leg in r["protocol"].items():
            if leg["conform"] or not leg["closed"] or not leg["launches"]:
                raise AssertionError(
                    f"process {r['process']}: {name}'s recorded events "
                    f"{leg['events']} against its schedule: "
                    f"{leg['conform']} (launches {leg['launches']})")


def verify_protocols_run(root: str) -> dict:
    """``python -m distributedarrays_tpu_torch.analysis verify-protocols``
    in a subprocess: it must exit 0 (every schedule proved, every mutant
    refuted)."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m",
                        "distributedarrays_tpu_torch.analysis",
                        "verify-protocols", "--quiet"], capture_output=True,
                       text=True, cwd=root, timeout=600)
    last = r.stdout.strip().splitlines()[-1:] or [r.stderr.strip()]
    print(f"  verify-protocols: exit {r.returncode}, {last[0]}")
    if r.returncode != 0:
        raise AssertionError(f"verify-protocols exited {r.returncode}:\n"
                             f"{r.stdout[-3000:]}{r.stderr[-2000:]}")
    return {"rc": r.returncode, "summary": last[0],
            "s": time.perf_counter() - t0}


def multihost_child(port: int, proc: int, out_dir: str) -> int:
    """One process of ``multihost_phase`` (``--multihost-child PORT P
    DIR``): joins the job on the store at ``localhost:PORT``, runs the
    phase's steps on its one rank and writes ``DIR/result_P.json``."""
    import distributedarrays_tpu_torch as tdat
    from distributedarrays_tpu_torch.ops import cuda_collectives as CC
    from distributedarrays_tpu_torch.parallel import multihost as MH
    from distributedarrays_tpu_torch.resilience import elastic
    from distributedarrays_tpu_torch.utils import kbuild
    torch.backends.cuda.matmul.allow_tf32 = False
    MH.initialize(f"localhost:{port}", MH_PROCS, proc,
                  initialization_timeout_s=120)
    tdat.telemetry.configure(os.path.join(out_dir, f"journal_{proc}.jsonl"))
    tdat.init()                       # this process's one rank on the card
    if tdat.nranks() != MH_PROCS or tdat.layout.local_ranks() != [proc]:
        raise AssertionError(f"rank table {tdat.nranks()} ranks, local "
                             f"{tdat.layout.local_ranks()}")
    dev = tdat.layout.local_device()
    res = {"process": proc}
    # the live plane: the exporter that DA_TPU_STREAM_AGG armed at import
    # streams to the parent's aggregator; register it in the job's store
    res["exporter_armed"] = tdat.telemetry.stream.armed()
    res["exporter_advertised"] = MH.advertise_exporter()
    MH.heartbeat()
    MH.sync_hosts("clock")
    res["clock"] = MH.exchange_clock_offsets()

    # 1. the BASELINE chain and the sums, against one process's 4 ranks
    tdat.seed(MH_SEED)
    A = tdat.drand((MH_N, MH_N), dist=(MH_PROCS, 1))
    if not tdat.layout.spans_processes(A.pids):
        raise AssertionError("A does not span the processes")
    X, Y, Z = (tdat.drand((MH_CHAIN_N, MH_CHAIN_N)) for _ in range(3))
    R = tdat.dmap(torch.sin, X) + Y * Z
    res["sum_chain"] = _bits(tdat.dsum(R))
    AA = A * A
    res["sum_AA"] = _bits(tdat.dsum(AA))
    for d in (X, Y, Z, R, AA):
        d.close()

    # 2. gather_global: one K10 launch a process, bit-equal to the plain
    # route (the pieces over the gloo group)
    kbuild.reset_launches()
    t0 = time.perf_counter()
    g = MH._gather_tensor(A)
    torch.cuda.synchronize()
    res["first_call_ms"] = (time.perf_counter() - t0) * 1e3
    launches = (kbuild.launch_counts()["all_gather"],
                kbuild.route_counts()["all_gather"]["cross_process_region"])
    res["launches"] = launches[1]
    if launches != (1, 1):
        raise AssertionError(f"gather_global launched K10 {launches} times "
                             "(all, cross_process_region); expected once")
    plain = _plain_fetch(MH, CC, [(A, None)])[0]
    if not _same_bits(g.cpu(), plain):
        raise AssertionError("the kernel route's gather differs from the "
                             "plain route's")
    host = MH.gather_global(A)
    if not np.array_equal(host.view(np.int32), plain.numpy().view(np.int32)):
        raise AssertionError("gather_global differs from the plain route")
    res["gather_sha"] = _sha256(plain)
    del plain, host
    # a whole call's host time (handle exchange, mappings, two barriers,
    # the launch), every process entering it together
    res["call_ms"] = statistics.median(
        _host_ms(MH, lambda: MH._gather_tensor(A), "call")[1]
        for _ in range(5))

    # 3. times: the kernel's launch alone, Tensor.copy_ from the
    # IPC-opened peer chunks (cudaMemcpy, the library yardstick), each
    # process alone (the others waiting at a barrier) and all four at
    # once (one host window between barriers); the plain route, all four
    # at once (it is a collective; its events span the host's exchange,
    # which the copies to and from the card synchronize with)
    out = torch.empty_like(g)
    copies, launch, unmap = _region_launcher(
        MH, CC, [A], [(0, [(0, n) for n in A.dims], out)], "timing")
    pairs = [(out[tuple(slice(c[j], c[j + 1]) for c, j in zip(A.cuts, ci))],
              torch.as_tensor(_PeerView(src, A._parts[ci].shape), device=dev))
             for ci, (_, src, _, _) in zip(A.cells(), copies)]

    def library():
        for o, s in pairs:
            o.copy_(s)
    solo = {"ms": _solo_ms(MH, proc, launch, "solo"),
            "library_ms": _solo_ms(MH, proc, library, "solo_library")}
    if not _same_bits(out, g):
        raise AssertionError("the timed launches wrote another array")
    together = _all_four_ms(MH, launch, "together", MH_WINDOW_BATCH)
    together["library_ms"] = _all_four_ms(MH, library, "together_library",
                                          MH_WINDOW_BATCH)["ms"]
    torch.cuda.synchronize()
    MH.sync_hosts("timed")
    unmap()
    plain_ms = []
    for _ in range(MH_PLAIN_REPS):
        MH.sync_hosts("plain")
        _, ms = event_ms(lambda: _plain_fetch(MH, CC, [(A, None)])[0].to(dev))
        plain_ms.append(ms)
    together["plain_ms"] = statistics.median(plain_ms)
    res["solo"], res["together"] = solo, together
    del out, g, pairs, copies

    # 3b. the ops across the processes, each against one process's result
    res["ops"] = multihost_ops(tdat, MH, CC, kbuild, A, proc, out_dir)
    # 3c. the ops on the rank-list exchange, each against one process's
    res["legs"] = multihost_legs(tdat, MH, CC, kbuild, A, proc)
    # 3d. sequence-parallel training, each leg against one process's
    res["train"] = multihost_train(tdat, MH, CC, kbuild)
    A.close()
    torch.cuda.empty_cache()
    # 3e. the data-parallel Trainer, against one process on 4 ranks
    res["trainer"] = multihost_trainer(tdat, MH, kbuild, proc, out_dir)
    # 3f. the GSPMD tp/dp step, against one process on 4 ranks, and each
    # call's recorded events against the protocol model's schedules
    res["tp_dp"] = multihost_tp_dp(tdat, MH, kbuild)
    MH.sync_hosts("protocol")
    res["protocol"] = multihost_protocol(tdat, kbuild)

    # 4. an uneven layout, d + d and its gather
    U = torch.rand(MH_UNEVEN, generator=torch.Generator().manual_seed(
        MH_SEED))
    dU = tdat.distribute(U, dist=(MH_PROCS, 1))
    res["uneven_cuts"] = dU.cuts[0]
    if dU.cuts[0] != tdat.defaultdist_1d(MH_UNEVEN[0], MH_PROCS):
        raise AssertionError(f"uneven cuts {dU.cuts[0]}")
    D2 = dU + dU
    if not _same_bits(MH._gather_tensor(D2).cpu(), U + U):
        raise AssertionError("d + d of the uneven DArray, gathered, is not "
                             "U + U")
    dU.close()
    D2.close()
    del U

    # 5. a checkpoint of a process-spanning DArray, saved and loaded
    C = tdat.drandn((MH_CKPT_N, MH_CKPT_N), dist=(MH_PROCS, 1))
    path = os.path.join(out_dir, f"ckpt_{proc}")
    t0 = time.perf_counter()
    tdat.checkpoint.save(path, {"C": C, "step": 7})
    res["ckpt_save_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = tdat.checkpoint.load(path)
    res["ckpt_load_s"] = time.perf_counter() - t0
    if back["step"] != 7 or back["C"].cuts != C.cuts or \
            back["C"].pids.tolist() != C.pids.tolist():
        raise AssertionError(f"restored layout {back['C'].cuts}")
    if not _same_bits(MH._gather_tensor(back["C"]), MH._gather_tensor(C)):
        raise AssertionError("the restored DArray differs")
    res["ckpt_cuts"] = back["C"].cuts

    # 6. the heartbeat census: the last process stops heartbeating
    last = MH_PROCS - 1
    MH.heartbeat()
    MH.sync_hosts("census0")
    fresh = (sorted(MH.down_peer_processes(MH_STALE_S)),
             MH.quorum_assess(MH_STALE_S)["verdict"])
    if fresh != ([], "healthy"):
        raise AssertionError(f"census before the stop: {fresh}")
    MH.sync_hosts("census1")
    t0 = time.monotonic()
    deadline = t0 + 10 * MH_STALE_S
    census = {}
    if proc != last:
        down = set()
        while down != {last}:
            if time.monotonic() > deadline:
                raise AssertionError(f"the census never saw {last}: {down}")
            MH.heartbeat()
            down = MH.down_peer_processes(MH_STALE_S)
            time.sleep(0.02)
        census["latency_s"] = time.monotonic() - t0
        census["down"] = sorted(down)
        t1 = time.perf_counter()
        q = MH.quorum_assess(MH_STALE_S)
        census["assess_ms"] = (time.perf_counter() - t1) * 1e3
        # the elastic manager's probe, at the census's staleness
        MH.down_peer_processes.__defaults__ = (MH_STALE_S,)
        MH.quorum_assess.__defaults__ = (MH_STALE_S,)
        probe = elastic.manager().probe()
        census["probe_down"] = probe["down"]
        census["probe_verdict"] = probe["partition"]["verdict"]
    else:
        q = MH.quorum_assess(MH_STALE_S)
        while q["verdict"] == "healthy":
            if time.monotonic() > deadline:
                raise AssertionError("the own heartbeat never went stale")
            time.sleep(0.02)
            q = MH.quorum_assess(MH_STALE_S)
        census["latency_s"] = time.monotonic() - t0
    census.update(verdict=q["verdict"], side=q["side"], lost=q["lost"])
    res["census"] = census
    MH.sync_hosts("census2")

    # 7. the journal: markers around a barrier
    tdat.telemetry.event("smoke", "before_barrier", process=proc)
    MH.sync_hosts("journal")
    tdat.telemetry.event("smoke", "after_barrier", process=proc)
    tdat.telemetry.stream.poke()
    tdat.telemetry.stream.stop()
    tdat.telemetry.configure(None)

    tdat.d_closeall()
    MH.sync_hosts("done")
    MH.shutdown()
    with open(os.path.join(out_dir, f"result_{proc}.json"), "w") as f:
        json.dump(res, f)
    print(f"multihost child {proc} ok")
    return 0


def multihost_phase(tdat) -> dict:
    """4 processes of the port on the one card, one rank each (see the
    module docstring); returns K10's cross-process launches and times."""
    import shutil
    import socket
    from distributedarrays_tpu_torch.utils import kbuild
    print(f"phase multihost ({MH_PROCS} processes on one card)")
    t_phase = time.perf_counter()
    # K10/K11, and K9, K5 and K4 for the legs on the rank-list exchange,
    # K8, K6, K7 and K13-K15 for the training legs
    kbuild.build(["collectives", "attention", "attention_bwd", "gemm_int8"])
    # the single-process port on 4 ranks of the card: what the processes
    # must reproduce bit for bit
    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(root, "build", "multihost")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    tdat.init(nranks=MH_PROCS)
    tdat.seed(MH_SEED)
    A = tdat.drand((MH_N, MH_N), dist=(MH_PROCS, 1))
    X, Y, Z = (tdat.drand((MH_CHAIN_N, MH_CHAIN_N)) for _ in range(3))
    R = tdat.dmap(torch.sin, X) + Y * Z
    ref = {"sum_chain": _bits(tdat.dsum(R)), "sum_AA": _bits(tdat.dsum(A * A)),
           "gather_sha": _sha256(A.full())}
    # the relayout (4,1) -> (1,4) in one process: the region copy and K11
    pids = np.arange(MH_PROCS).reshape(1, MH_PROCS)
    cuts = tdat.layout.chunk_idxs(A.dims, (1, MH_PROCS))[1]
    one = {"relayout_plain_ms": time_ms(
        lambda: tdat.reshard.relayout_plain(A, pids, cuts)),
        "relayout_k11_ms": time_ms(
        lambda: tdat.reshard.reshard(A, pids, cuts))}
    # the ops on the rank-list exchange in one process on 4 ranks
    t_ref = time.perf_counter()
    legs_ref = multihost_legs_reference(tdat, A)
    print(f"multihost legs on one process: "
          f"{time.perf_counter() - t_ref:.1f} s")
    t_ref = time.perf_counter()
    train_ref = multihost_train_reference(tdat)
    print(f"multihost training legs on one process: "
          f"{time.perf_counter() - t_ref:.1f} s")
    t_ref = time.perf_counter()
    trainer_ref = trainer_reference(tdat)
    print(f"multihost trainer reference: {time.perf_counter() - t_ref:.1f} "
          f"s")
    t_ref = time.perf_counter()
    tdat.init(nranks=MH_PROCS)
    tp_ref = multihost_tp_dp_run(tdat)
    torch.cuda.empty_cache()
    print(f"multihost tp/dp reference: {time.perf_counter() - t_ref:.1f} s")
    # the protocol model, before the children's conformance leg
    protocols = verify_protocols_run(root)
    tdat.init(nranks=MH_PROCS)
    tdat.d_closeall()
    del X, Y, Z, R
    # the ops across processes, in one process on 4 ranks: the GEMM's
    # result (saved for process 0 to compare), transpose, scan and djit.
    # The children's tuning registries are empty, so the GEMM takes the
    # default schedule there: clear what earlier phases recorded here
    # (the (2,2) grid's Cannon) so one process runs the same per-cell call
    tdat.autotune.clear()
    tdat.seed(MH_SEED + 1)
    GA = tdat.drand((MH_N, MH_N), dist=(2, 2))
    GB = tdat.drand((MH_N, MH_N), dist=(2, 2))
    GC, ms = _host_call_ms(lambda: GA @ GB)
    one["gemm_call_ms"] = [ms] + [_host_call_ms(lambda: GA @ GB)[1]
                                  for _ in range(2)]
    C = GC.full().cpu()
    ref["gemm_sha"] = _sha256(C)
    np.save(os.path.join(out_dir, "gemm_ref.npy"), C.numpy())
    del C
    tdat.d_closeall()
    tdat.seed(MH_SEED + 3)
    T22 = tdat.drand((MH_CHAIN_N, MH_CHAIN_N), dist=(2, 2))
    T41 = tdat.drand((MH_CHAIN_N, MH_CHAIN_N), dist=(MH_PROCS, 1))
    X = tdat.drand((MH_CHAIN_N, MH_CHAIN_N))
    ref["transpose_sha"] = _sha256(tdat.dtranspose(T22).full())
    ref["cumsum_sha"] = _sha256(tdat.dcumsum(T41, axis=0).full())
    ref["djit_sha"] = _sha256(tdat.djit(torch.sin)(X).full())
    ref["relayout_sha"] = ref["gather_sha"]
    tdat.d_closeall()
    del A, GA, GB, GC, T22, T41, X
    torch.cuda.empty_cache()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    # one aggregator here, on localhost, that every child's exporter
    # streams to (armed at import by DA_TPU_STREAM_AGG)
    tdat.telemetry.enable()
    agg = tdat.telemetry.agg.AggServer(port=0).start()
    env["DA_TPU_STREAM_AGG"] = agg.url
    env["DA_TPU_STREAM_INTERVAL_S"] = "1.0"
    parent_free_gib = torch.cuda.mem_get_info()[0] / 2 ** 30
    logs = [open(os.path.join(out_dir, f"child_{p}.log"), "w")
            for p in range(MH_PROCS)]
    t_job = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--multihost-child",
         str(port), str(p), out_dir], stdout=logs[p],
        stderr=subprocess.STDOUT, env=env, cwd=root)
        for p in range(MH_PROCS)]
    deadline = time.monotonic() + MH_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        raise AssertionError(f"multihost children still running after "
                             f"{MH_TIMEOUT_S} s; logs in {out_dir}")
    finally:
        for f in logs:
            f.close()
        snap = agg.agg.snapshot()
        agg.close()
    job_s = time.perf_counter() - t_job
    failed = [i for i, p in enumerate(procs) if p.returncode != 0]
    if failed:
        tails = {i: open(os.path.join(out_dir, f"child_{i}.log")).read()
                 [-3000:] for i in failed}
        raise AssertionError(f"multihost children {failed} failed: {tails}")
    res = [json.load(open(os.path.join(out_dir, f"result_{p}.json")))
           for p in range(MH_PROCS)]

    for r in res:
        for k in ("sum_chain", "sum_AA", "gather_sha"):
            if r[k] != ref[k]:
                raise AssertionError(f"process {r['process']}: {k} {r[k]} "
                                     f"!= one process's {ref[k]}")
        for k in ("relayout_sha", "transpose_sha", "cumsum_sha", "djit_sha"):
            if r["ops"][k] != ref[k]:
                raise AssertionError(f"process {r['process']}: {k} differs "
                                     "from one process's")
    # the GEMM: bit-equal to one process on 4 ranks, where the per-cell
    # torch.matmul is the same call; else within 1e-5 of the largest value
    # (another order of the 16384-term f32 sums: about sqrt(16384) * 2^-24)
    ops0 = res[0]["ops"]
    gemm_equal = all(r["ops"]["gemm_sha"] == ref["gemm_sha"] for r in res)
    if not gemm_equal and not (ops0["gemm_max_abs_err"] <=
                               1e-5 * ops0["gemm_max_abs"]):
        raise AssertionError(f"the GEMM across processes differs from one "
                             f"process's by {ops0['gemm_max_abs_err']}")
    _check_legs(res, legs_ref)
    _check_train(res, train_ref)
    _check_trainer(res, trainer_ref)
    _check_tp_dp_and_protocol(res, tp_ref)
    if not all(r["exporter_armed"] and r["exporter_advertised"]
               for r in res) or len(snap["hosts"]) != MH_PROCS:
        raise AssertionError(
            f"live plane: armed {[r['exporter_armed'] for r in res]}, "
            f"advertised {[r['exporter_advertised'] for r in res]}, "
            f"{len(snap['hosts'])} hosts in the aggregator")
    for r in res:
        if r["legs"]["open_mappings_end"]:
            raise AssertionError(f"process {r['process']} left peer "
                                 "mappings open after the legs")
    last = MH_PROCS - 1
    for r in res[:last]:
        c = r["census"]
        if c["down"] != [last] or c["verdict"] != "quorum" or \
                c["side"] != list(range(last)) or \
                c["probe_down"] != [last] or c["probe_verdict"] != "quorum":
            raise AssertionError(f"process {r['process']} census {c}")
    c = res[last]["census"]
    if c["verdict"] != "minority" or c["side"] != [last]:
        raise AssertionError(f"process {last} census {c}")

    merged = tdat.telemetry.merge_journals(
        [os.path.join(out_dir, f"journal_{p}.jsonl") for p in range(MH_PROCS)])
    streams = {(e.get("host"), e.get("pid")) for e in merged}
    clock = {e.get("process_index") for e in merged
             if (e.get("cat"), e.get("name")) == ("multihost", "clock")}
    before = [e["t"] for e in merged if e.get("name") == "before_barrier"]
    after = [e["t"] for e in merged if e.get("name") == "after_barrier"]
    if len(streams) != MH_PROCS or clock != set(range(MH_PROCS)) or \
            len(before) != MH_PROCS or len(after) != MH_PROCS or \
            max(before) > min(after):
        raise AssertionError(f"merged journal: {len(streams)} streams, clock "
                             f"events of {sorted(clock)}, barrier markers "
                             f"{before} / {after}")
    trace_path = os.path.join(root, "build", "multihost_trace.json")
    with open(trace_path, "w") as f:
        json.dump(tdat.telemetry.to_perfetto(merged), f)

    nbytes = MH_N * MH_N * 4
    row = {
        "shape": f"{MH_N}x{MH_N} f32 on ({MH_PROCS},1), {MH_PROCS} processes "
                 "on one card, each writing its own whole copy",
        # all four processes at once, one host window between barriers
        # (the largest over the processes holds all their launches): each
        # process reads and writes 1 GiB
        "ms": max(r["together"]["ms"] for r in res),
        "barrier_ms": max(r["together"]["barrier_ms"] for r in res),
        "plain_ms": max(r["together"]["plain_ms"] for r in res),
        "library_ms": max(r["together"]["library_ms"] for r in res),
        "bound_ms": bound(MH_PROCS * 2 * nbytes, 0, F32_FLOPS)[0],
        "bound_by": "bytes",
        # one process's launch with the card to itself
        "solo_ms": [r["solo"]["ms"] for r in res],
        "solo_library_ms": [r["solo"]["library_ms"] for r in res],
        "solo_bound_ms": bound(2 * nbytes, 0, F32_FLOPS)[0],
        "call_ms": [r["call_ms"] for r in res],
        "first_call_ms": [r["first_call_ms"] for r in res],
        "census_latency_s": [r["census"]["latency_s"] for r in res],
        "census_assess_ms": [r["census"].get("assess_ms") for r in res],
        "stale_s": MH_STALE_S,
        "ckpt_save_s": [r["ckpt_save_s"] for r in res],
        "ckpt_load_s": [r["ckpt_load_s"] for r in res],
        "job_s": job_s, "phase_s": time.perf_counter() - t_phase,
        "parent_free_gib": parent_free_gib,
        "trace": os.path.relpath(trace_path, root),
        "region": multihost_region_row(res, one, gemm_equal),
        "legs": multihost_legs_row(res, legs_ref),
        "train": multihost_train_row(res, train_ref),
        "trainer": multihost_trainer_row(res, trainer_ref),
        "tp_dp": {"bit_equal_one_process": True,
                  "ms": [r["tp_dp"]["ms"] for r in res],
                  "launches": [r["tp_dp"]["launches"] for r in res],
                  "cross_process": [r["tp_dp"]["cross_process"]
                                    for r in res],
                  "calls_conforming": [r["tp_dp"]["calls"] for r in res],
                  "shape": f"Config{MH_TP_CFG} bf16, {MH_TP_STEPS} SGD "
                           f"steps on make_mesh({MH_PROCS})"},
        "protocol": {"verify_protocols": protocols,
                     "conforming": {n: [r["protocol"][n]["launches"]
                                        for r in res]
                                    for n in MH_PROTOCOL_CALLS}},
        "aggregator": {"hosts": len(snap["hosts"]),
                       "frames": snap.get("frames_ingested")}}
    print(json.dumps({"multihost": row, "gpu": gpu_name()}))
    # each kernel's cross-process launches a process, leg by leg
    kern = {"all_gather": {}, "all_to_all": {}, "ring_attention": {},
            "flash_attention": {}, "matmul_int8": {},
            "flash_attention_hop": {}, "flash_attention_bwd_dq": {},
            "flash_attention_bwd_dkv": {}, "allgather_matmul": {},
            "allgather_matmul_rhs": {}, "matmul_reducescatter": {}}
    for name, leg in row["legs"].items():
        for k in kern:
            counts = [c.get(k, 0) for c in leg["launches"]]
            if any(counts):
                kern[k][name] = counts
    for name in row["train"]:
        # the training legs' launches, the same on every process (held)
        for k in kern:
            counts = [r["train"][name]["launches"].get(k, 0) for r in res]
            if any(counts):
                kern[k]["train_" + name] = counts
    return {"launches": [r["launches"] for r in res], "row": row,
            "legs_kernels": kern,
            # each process's launches a Trainer step (K10 and K12 on their
            # cross-process routes)
            "trainer_launches": {
                k: [r["trainer"]["launches"][0][k] for r in res]
                for k in ("all_gather", "reduce_scatter")},
            # each process's launches in the tp/dp leg's two steps
            "tp_dp_launches": {k: [r["tp_dp"]["launches"][k] for r in res]
                               for k in TP_DP_KERNELS},
            "region_launches": [
                r["launches"] + sum(r["ops"][k]["region"] for k in (
                    "gemm_launches", "relayout_launches", "djit_launches"))
                for r in res]}


def _host_call_ms(fn):
    """``(result, ms)``: one call's host time, synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return r, (time.perf_counter() - t0) * 1e3


def multihost_region_row(res, one, gemm_equal) -> dict:
    """The region copies' readings across the 4 processes, each beside the
    bound of the bytes its timing holds: the GEMM's fetch (each process
    reads its 8192 x 16384 A and 16384 x 8192 B panels and writes them:
    2 GiB a process alone, 8 GiB in the all-four window), its product
    alone, the whole call, the relayout (512 MiB a process alone, 2 GiB
    all four), beside one process on 4 ranks."""
    half = MH_N // 2
    fetch_bytes = 2 * (2 * half * MH_N * 4)
    relayout_bytes = 2 * (MH_N // MH_PROCS) * MH_N * 4
    ops = [r["ops"] for r in res]
    return {
        "gemm": {
            "shape": f"{MH_N}^2 f32, A (2,2) @ B (2,2), {MH_PROCS} processes",
            "bit_equal_one_process": gemm_equal,
            "max_abs_err": ops[0]["gemm_max_abs_err"],
            "launches": [o["gemm_launches"] for o in ops],
            # each process's launch with the card to itself
            "fetch_solo_ms": [o["fetch_solo_ms"] for o in ops],
            "fetch_solo_bound_ms": bound(fetch_bytes, 0, F32_FLOPS)[0],
            # all four at once, one host window between barriers
            "fetch_all_four_ms": max(o["fetch_all_four"]["ms"] for o in ops),
            "fetch_all_four_barrier_ms": max(
                o["fetch_all_four"]["barrier_ms"] for o in ops),
            "fetch_all_four_bound_ms": bound(MH_PROCS * fetch_bytes, 0,
                                             F32_FLOPS)[0],
            "fetch_call_ms": [o["fetch_call_ms"] for o in ops],
            "product_solo_ms": [o["product_solo_ms"] for o in ops],
            "product_bound_ms": bound(0, 2 * half * half * MH_N,
                                      F32_FLOPS)[0],
            "call_ms": [o["gemm_call_ms"] for o in ops],
            "one_process_call_ms": one["gemm_call_ms"]},
        "relayout": {
            "shape": f"{MH_N}^2 f32 (4,1) -> (1,4), {MH_PROCS} processes",
            "launches": [o["relayout_launches"] for o in ops],
            "solo_ms": [o["relayout_solo_ms"] for o in ops],
            "solo_bound_ms": bound(relayout_bytes, 0, F32_FLOPS)[0],
            "all_four_ms": max(o["relayout_all_four"]["ms"] for o in ops),
            "all_four_barrier_ms": max(
                o["relayout_all_four"]["barrier_ms"] for o in ops),
            "all_four_bound_ms": bound(MH_PROCS * relayout_bytes, 0,
                                       F32_FLOPS)[0],
            "call_ms": [o["relayout_call_ms"] for o in ops],
            "one_process_plain_ms": one["relayout_plain_ms"],
            "one_process_k11_ms": one["relayout_k11_ms"]},
        "transpose_launches": [o["transpose_launches"] for o in ops],
        "djit_launches": [o["djit_launches"] for o in ops],
        "map_rounds": [o["map_rounds"] for o in ops],
        "realloc": [(o["realloc_same_address"], o["realloc_gather_ok"])
                    for o in ops],
        "open_mappings_end": [o["open_mappings_end"] for o in ops]}


TM_SYNC_FRAC = 1.05   # the most a synchronized span may read of a peak
TM_REPS = 2           # main-path runs with the journal off, and on


def telemetry_workload(tdat, autotune, sizes=(4096, 8192, 10 ** 8, 16384)):
    """The main path's calls (phase 3) without its checks, at its sizes:
    distribute and drand 4096^2, ``A @ B`` through the kernel (the tuning
    registry set), ``dsum(A*A)``, ``sin(X) + Y*Z`` at 8192^2, the three
    reductions of a 1e8 DVector, a 16384^2 ``A @ B`` through the kernel,
    ``stencil5`` (16 and 1 iterations) and ``gather``; synchronized and
    closed at the end."""
    n, nc, nv, nb = sizes
    f32 = torch.float32
    for m in (n, nb):
        autotune.record("matmul_impl", autotune.device_key_for(
            m, m, m, f32, f32), "pallas")
    A = tdat.distribute(np.random.default_rng(2).standard_normal(
        (n, n), dtype=np.float32))
    B = tdat.drand((n, n))
    A @ B
    tdat.dsum(A * A)
    X, Y, Z = (tdat.drand((nc, nc)) for _ in range(3))
    tdat.dmap(torch.sin, X) + Y * Z
    V = tdat.drand(nv)
    tdat.dmapreduce(torch.square, "sum", V)
    tdat.dmean(V)
    tdat.dstd(V)
    A16, B16 = tdat.drand((nb, nb)), tdat.drand((nb, nb))
    A16 @ B16
    G = tdat.drandn((nc, nc))
    tdat.stencil5(G, iters=16)
    tdat.gather(tdat.stencil5(G, iters=1))
    torch.cuda.synchronize()
    tdat.d_closeall()


def uncapped_frac(ev: dict, peaks: dict) -> float:
    """A span's roofline fraction before ``classify_occurrence``'s cap at
    1: the largest of its stamps' service times at the peaks over its
    duration."""
    lab = ev.get("labels") or {}
    t = max(float(lab.get(k) or 0) / peaks[p] for k, p in (
        ("flops", "flops"), ("bytes_hbm", "hbm"), ("bytes_ici", "ici")))
    return t / ev["dur"] if ev.get("dur") else 0.0


def telemetry_phase(tdat, workload_sizes=(4096, 8192, 10 ** 8, 16384),
                    trainer_cfg=None) -> dict:
    """Telemetry on the card: the main path's calls (``telemetry_workload``)
    run ``TM_REPS`` times each with telemetry disabled and with a journal,
    in turns (the wall-time difference is its cost on the main path); one
    warm step of the 4-rank Trainer journaled; then the doctor
    (``python -m distributedarrays_tpu_torch.telemetry doctor --json``) in
    a subprocess on the journal.  The journal's platform must read
    ``h100``; every ``matmul`` and ``pallas.matmul`` span must carry
    ``flops = 2mnk`` of its shape; no span that ends at a device
    synchronization (``train.step``, ``train.sync``) may read above
    ``TM_SYNC_FRAC`` of a peak, uncapped.  Prints the top findings and
    every classified span's fraction, capped and uncapped."""
    from distributedarrays_tpu_torch.utils import autotune
    tm = tdat.telemetry
    root = os.path.dirname(os.path.abspath(__file__))
    journal = os.path.join(root, "build", "telemetry_journal.jsonl")
    if os.path.exists(journal):
        os.remove(journal)
    print("phase telemetry (main path with the journal off and on, a "
          "trainer step, the doctor)")
    tdat.init()
    tm.configure(None)
    tm.disable()
    telemetry_workload(tdat, autotune, workload_sizes)     # warm-up
    wall = {"off": [], "on": []}
    for _ in range(TM_REPS):
        for mode in ("off", "on"):
            if mode == "on":
                tm.enable()
                tm.configure(journal)
                tdat.init()              # journals the device kind
            else:
                tm.configure(None)
                tm.disable()
            t0 = time.perf_counter()
            telemetry_workload(tdat, autotune, workload_sizes)
            wall[mode].append((time.perf_counter() - t0) * 1e3)
    # one warm trainer step, journaled
    cfg = trainer_cfg or TRAINER_CFG
    tdat.init(nranks=4)
    train = tdat.train
    with train.Trainer(train.transformer_task(**cfg),
                       train.adam(1e-4)) as t:
        tm.configure(None)
        tm.disable()
        t.step_once()                    # the first step, not journaled
        tm.enable()
        tm.configure(journal)
        t.step_once()
    tm.configure(None)
    tdat.d_closeall()
    torch.cuda.empty_cache()
    env = dict(os.environ, PYTHONPATH=root + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "distributedarrays_tpu_torch.telemetry",
         "doctor", journal, "--json"], capture_output=True, text=True,
        cwd=root, env=env, timeout=300)
    doctor_s = time.perf_counter() - t0
    if run.returncode != 0:
        raise AssertionError(f"the doctor exited {run.returncode}: "
                             f"{run.stderr[-2000:]}")
    rep = json.loads(run.stdout)
    if rep["platform"] != "h100":
        raise AssertionError(f"the doctor read platform {rep['platform']!r}")
    peaks = rep["peaks"]
    with open(journal) as f:
        events = [json.loads(ln) for ln in f if ln.strip()]
    spans = [e for e in events if e.get("cat") == "span"]
    mm = [e["labels"] for e in spans if e["name"] == "matmul"]
    pm = [e["labels"] for e in spans if e["name"] == "pallas.matmul"]
    want = {2 * m ** 3 for m in workload_sizes[::3]}
    if {x["flops"] for x in mm} != want or len(mm) != 2 * TM_REPS or \
            len(pm) != 2 * TM_REPS or any(
                x["flops"] != 2 * x["shape"][0] * x["shape"][1] *
                x["shape"][2] for x in pm):
        raise AssertionError(f"matmul spans {mm}, pallas.matmul spans {pm}")
    fracs = {}
    for e in spans:
        if any((e.get("labels") or {}).get(k) for k in (
                "flops", "bytes_hbm", "bytes_ici")) and e.get("dur"):
            fracs.setdefault(e["name"], []).append(uncapped_frac(e, peaks))
    synced = {k: max(v) for k, v in fracs.items()
              if k in ("train.step", "train.sync")}
    if "train.step" not in synced or max(synced.values()) > TM_SYNC_FRAC:
        raise AssertionError(f"synchronized spans read {synced} of a peak")
    print("  doctor findings (top 8):")
    for f_ in rep["findings"][:8]:
        print(f"    [{f_['kind']}] {f_['message']}")
    print("  roofline by span (capped / uncapped, each occurrence):")
    by = rep["by_name"]
    for name, v in sorted(fracs.items()):
        r = by.get(name, {})
        print(f"    {name:<24} {r.get('bound', '-'):<8} capped "
              f"{r.get('roofline_frac')}  uncapped "
              f"{[float(f'{x:.4g}') for x in v]}")
    row = {"wall_ms_off": wall["off"], "wall_ms_on": wall["on"],
           "cost_pct": 100 * (statistics.median(wall["on"]) /
                              statistics.median(wall["off"]) - 1),
           "platform": rep["platform"], "peaks": peaks,
           "coverage": rep["coverage"]["fraction"],
           "findings": len(rep["findings"]),
           "synced_uncapped": synced,
           "uncapped_max": {k: max(v) for k, v in fracs.items()},
           "doctor_s": doctor_s, "journal_events": len(events)}
    print(json.dumps({"telemetry": row, "gpu": gpu_name()}))
    tm.enable()
    return row


# the device symbols of the port's kernels in a profiler trace, by
# kbuild's kernel names (their C entries are the ``da_*`` functions)
KERNEL_SYMBOLS = {
    "gemm": r"gemm_(f32|mma|wgmma)_kernel",
    "stencil_step": r"(?<!multi)step_kernel",
    "stencil_multistep": r"multistep_kernel",
    "all_gather": r"copy_kernel",
    "all_to_all": r"copy_kernel",
    "reduce_scatter": r"reduce_(pieces|run)_kernel",
    "allgather_matmul_rhs": r"ring_ag_mm_(kernel|wgmma|f32)",
}
ADVISE_N, ADVISE_M = 4096, 16384     # K1's shape; the (4,1) GEMM's and
ADVISE_BF16 = (4096, 2048, 8192)     # the reshard's; K1's bf16 (m, k, n)


def advise_journal(journal: str, registry: str) -> int:
    """``--advise-journal JOURNAL REGISTRY``: the advise phase's journaled
    run (started with ``CUDA_LAUNCH_BLOCKING=1``, so a span lasts as long
    as its kernels): K1 through ``matmul_impl = "pallas"`` (4096^3 f32 and
    one bf16 shape), the (4,1) x (4,1) 16384^2 f32 ``A @ B`` under
    ``matmul_impl_dist`` ``"torch"`` then ``"ring_ag"``, and a (4,1) ->
    (1,4) 16384^2 f32 ``copyto_``; each warmed once unjournaled, then
    journaled twice.  The registry it ran under is saved to REGISTRY, the
    run's kernel launches beside it (``REGISTRY.launches.json``)."""
    import distributedarrays_tpu_torch as tdat
    from distributedarrays_tpu_torch.utils import autotune
    tm = tdat.telemetry
    f32, bf16 = torch.float32, torch.bfloat16
    autotune.clear()
    tdat.init()
    dev = tdat.device_of(0)
    gen = torch.Generator(device=dev).manual_seed(25)
    n = ADVISE_N
    m1, k1, n1 = ADVISE_BF16
    one = []
    for (m, k, nn), dt in (((n, n, n), f32), ((m1, k1, n1), bf16)):
        autotune.record("matmul_impl", autotune.device_key_for(
            m, nn, k, dt, dt), "pallas")
        one.append(tuple(tdat.distribute(torch.randn(  # dalint: disable=DAL006 — the four operands live until the d_closeall below
            s, generator=gen, device=dev).to(dt), procs=[0])
            for s in ((m, k), (k, nn))))

    def journaled(fn):
        tm.configure(None)
        tm.disable()
        fn()                           # warm, unjournaled
        tm.enable()
        tm.configure(journal)
        for _ in range(2):
            fn()
        tm.configure(None)

    tm.enable()
    tm.configure(journal)
    tdat.init()                        # journals the device kind
    journaled(lambda: [a @ b for a, b in one])
    tdat.d_closeall()
    tdat.init(nranks=4)
    m = ADVISE_M
    A = tdat.drand((m, m), dist=(4, 1))
    B = tdat.drand((m, m), dist=(4, 1))
    dkey = autotune.device_key_for(m, m, m, 4, f32, f32)
    for route in ("torch", "ring_ag"):
        autotune.record("matmul_impl_dist", dkey, route)
        journaled(lambda: (A @ B).close())
    E = tdat.drand((m, m), dist=(4, 1))
    F = tdat.dzeros((m, m), dist=(1, 4))
    journaled(lambda: tdat.copyto_(F, E))
    torch.cuda.synchronize()
    autotune.save(registry)
    with open(registry + ".launches.json", "w") as f:
        json.dump(tdat.kbuild.launch_counts(), f)
    tdat.d_closeall()
    return 0


def advise_phase(tdat, smi: str) -> dict:
    """The tuning advisor on the card (the module docstring's advise
    bullet).  Returns the row of readings."""
    import re
    import shutil
    import tempfile
    from distributedarrays_tpu_torch.telemetry import advisor, alerts, perf
    from distributedarrays_tpu_torch.telemetry.summarize import read_journal
    from distributedarrays_tpu_torch.utils import autotune, kbuild, profiling
    print("phase advise (journal, doctor, advise, apply, rollback, trace)")
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="advise_", dir=os.path.join(root, "build"))
    journal = os.path.join(tmp, "advise.jsonl")
    registry = os.path.join(tmp, "registry.json")
    old_env = os.environ.get("DAT_TORCH_AUTOTUNE_CACHE")
    os.environ.pop("DAT_TORCH_AUTOTUNE_CACHE", None)
    repo_cache = autotune.default_cache_path()

    def stat(path):
        return os.stat(path).st_mtime_ns if os.path.exists(path) else None
    repo_before = stat(repo_cache)
    os.environ["DAT_TORCH_AUTOTUNE_CACHE"] = registry
    env = dict(os.environ, CUDA_LAUNCH_BLOCKING="1", PYTHONPATH=root +
               os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--advise-journal", journal, registry],
                         capture_output=True, text=True, cwd=root, env=env,
                         timeout=600)
    child_s = time.perf_counter() - t0
    if run.returncode != 0:
        raise AssertionError(f"the journaled run exited {run.returncode}: "
                             f"{run.stderr[-3000:]}")
    cli = subprocess.run(
        [sys.executable, "-m", "distributedarrays_tpu_torch.telemetry",
         "advise", journal, "--json"], capture_output=True, text=True,
        cwd=root, env=dict(env, CUDA_LAUNCH_BLOCKING="0"), timeout=300)
    if cli.returncode != 0:
        raise AssertionError(f"advise exited {cli.returncode}: "
                             f"{cli.stderr[-2000:]}")
    cli_actions = json.loads(cli.stdout)["actions"]
    with open(registry + ".launches.json") as f:
        journal_launches = {k: v for k, v in json.load(f).items() if v}
    if not journal_launches.get("all_to_all"):
        raise AssertionError(f"the journaled copyto_ launched no K11: "
                             f"{journal_launches}")
    # the command as a user runs it, --apply in a fresh process with the
    # default probes, on a copy of the registry
    cli_registry = os.path.join(tmp, "cli_registry.json")
    shutil.copyfile(registry, cli_registry)
    t0 = time.perf_counter()
    cli_apply = subprocess.run(
        [sys.executable, "-m", "distributedarrays_tpu_torch.telemetry",
         "advise", journal, "--json", "--apply"], capture_output=True,
        text=True, cwd=root, timeout=600, env=dict(
            env, CUDA_LAUNCH_BLOCKING="0",
            DAT_TORCH_AUTOTUNE_CACHE=cli_registry))
    cli_apply_s = time.perf_counter() - t0
    if cli_apply.returncode != 0:
        raise AssertionError(f"advise --apply exited "
                             f"{cli_apply.returncode}: "
                             f"{cli_apply.stderr[-2000:]}")
    cli_results = json.loads(cli_apply.stdout)["results"]
    failed = [r for r in cli_results
              if str(r.get("reason") or "").startswith("probe failed")]
    if failed or not cli_results:
        raise AssertionError(f"advise --apply: {failed or cli_results}")
    for r in cli_results:
        print(f"  advise --apply {r['kind']}: {r['kernel']} {r['current']} "
              f"-> {r['proposed']}: {r['status'].upper()} "
              f"({r.get('reason') or ''}; {cli_apply_s:.1f} s; {smi})")
    autotune.clear()
    autotune.load(registry)
    analysis = perf.analyze(read_journal(journal))
    if analysis["platform"] != "h100":
        raise AssertionError(f"the doctor read {analysis['platform']!r}")
    actions = advisor.advise(analysis)
    addr = [(a.kind, a.kernel, a.key, a.proposed) for a in actions]
    if addr != [(a["kind"], a["kernel"], a["key"], a["proposed"])
                for a in cli_actions]:
        raise AssertionError(f"advise in process {addr} and on the command "
                             f"line {cli_actions} disagree")
    kinds = {a.kind for a in actions}
    if not {"resweep", "dispatch"} <= kinds or "rdma_chunks" in kinds:
        raise AssertionError(f"advise proposed {addr}; the phase needs a "
                             "resweep and a dispatch action, and no "
                             "rdma_chunks action")
    for a in actions:
        print(f"  action {a.kind}: {a.kernel}[{a.key}] {a.current} -> "
              f"{a.proposed} ({a.finding}; "
              + ", ".join(f"{k}={v:.6g}" for k, v in a.evidence.items()
                          if isinstance(v, float)) + ")")
    tdat.init(nranks=4)
    mgr = alerts.AlertManager()
    tm = tdat.telemetry
    kbuild.reset_launches()
    t0 = time.perf_counter()
    results = advisor.apply(actions, repeats=3, persist=True, manager=mgr)
    apply_s = time.perf_counter() - t0
    launches = kbuild.launch_counts()
    want = {"gemm": "K1", "allgather_matmul_rhs": "K14"}
    missing = [k for k in want if not launches[k]]
    if missing:
        raise AssertionError(f"apply launched no {missing}: {launches}")
    rows = []
    for r in results:
        med = {k: statistics.median(r[k]) * 1e3 if r.get(k) else None
               for k in ("before_s", "after_s")}
        rows.append({"kind": r["kind"], "kernel": r["kernel"],
                     "key": r["key"], "current": r["current"],
                     "proposed": r["proposed"], "status": r["status"],
                     "before_ms": med["before_s"],
                     "after_ms": med["after_s"],
                     "before_s": r.get("before_s"),
                     "after_s": r.get("after_s")})
        print(f"  apply {r['kind']}: {r['kernel']} {r['current']} -> "
              f"{r['proposed']}: {r['status'].upper()}, probe median "
              f"before {med['before_s']} ms, after {med['after_s']} ms "
              f"({smi})")
    # the rollback: the route the dispatch tune's probes measured slower,
    # proposed back, must not survive (unless apply already rolled the
    # dispatch tune back, which is then the rollback checked)
    disp = next(r for r in results if r["kind"] == "dispatch")
    act = next(a for a in actions if a.kind == "dispatch")
    n_back = tm.counter_value("autotune.advisor_rollbacks", kind="dispatch")
    back_launches = {}
    if disp["status"] == "rolled_back":
        back, prev_entry, prev_stamp = disp, disp["current"], None
        slower, n_back = disp["proposed"], n_back - 1
    else:
        prev_entry = autotune.get(act.kernel, act.key)
        prev_stamp = autotune.provenance_for(act.kernel, act.key)
        slower = "ring_ag" if prev_entry == "torch" else "torch"
        rev = advisor.TuningAction(
            kind="dispatch", kernel=act.kernel, key=act.key,
            current=prev_entry, proposed=slower, finding="dispatch_delta",
            evidence={"reversed": True}, probe=dict(act.probe))
        kbuild.reset_launches()
        back = advisor.apply([rev], repeats=3, persist=True,
                             manager=mgr)[0]
        back_launches = kbuild.launch_counts()
    print(f"  rollback check, dispatch {act.kernel} {prev_entry} -> "
          f"{slower}: {back['status'].upper()}, probe median before "
          f"{statistics.median(back['before_s']) * 1e3} ms, after "
          f"{statistics.median(back['after_s']) * 1e3} ms "
          f"({back.get('reason')}; {smi})")
    if back["status"] != "rolled_back" or \
            autotune.get(act.kernel, act.key) != prev_entry or \
            autotune.provenance_for(act.kernel, act.key) != prev_stamp:
        raise AssertionError(f"the slower tune was not rolled back to "
                             f"{prev_entry!r}: {back}")
    if tm.counter_value("autotune.advisor_rollbacks",
                        kind="dispatch") != n_back + 1 or \
            "autotune_regressed" not in mgr.firing():
        raise AssertionError("the rollback was not counted or did not fire "
                             "autotune_regressed")
    with open(registry) as f:
        saved = json.load(f)
    if saved.get(act.kernel, {}).get(act.key) != prev_entry:
        raise AssertionError("the saved registry does not hold the entry "
                             "as before the reversed tune")
    os.environ.pop("DAT_TORCH_AUTOTUNE_CACHE", None)
    if old_env is not None:
        os.environ["DAT_TORCH_AUTOTUNE_CACHE"] = old_env
    if stat(repo_cache) != repo_before:
        raise AssertionError(f"the repo's cache file {repo_cache} was "
                             "written")
    autotune.clear()
    tdat.d_closeall()
    torch.cuda.empty_cache()
    # profiling.trace around one main-path run, and the run's wall time
    # with the profiler on and off, in turns
    tdat.init()
    telemetry_workload(tdat, autotune)                    # warm
    t0 = time.perf_counter()
    with profiling.trace(os.path.join(tmp, "prof")):      # the profiler's
        telemetry_workload(tdat, autotune)                # first start
    cold_ms = (time.perf_counter() - t0) * 1e3
    wall = {"off": [], "on": []}
    trace_counts = names = None
    for i in range(2):
        for mode in ("off", "on"):
            kbuild.reset_launches()
            t0 = time.perf_counter()
            if mode == "on":
                with profiling.trace(os.path.join(tmp, "prof")) as prof:
                    telemetry_workload(tdat, autotune)
            else:
                telemetry_workload(tdat, autotune)
            wall[mode].append((time.perf_counter() - t0) * 1e3)
            if mode == "on" and i == 0:
                trace_counts = {k: v for k, v in
                                kbuild.launch_counts().items() if v}
                with open(prof.trace_path) as f:
                    names = {e.get("name", "") for e in
                             json.load(f)["traceEvents"]
                             if e.get("cat") == "kernel"}
    absent = [k for k in trace_counts if k not in KERNEL_SYMBOLS or not any(
        re.search(KERNEL_SYMBOLS[k], nm) for nm in names)]
    if not trace_counts or absent:
        raise AssertionError(f"the trace names none of {absent} "
                             f"(counted {trace_counts})")
    port_kernels = sorted({nm for nm in names if any(
        re.search(KERNEL_SYMBOLS[k], nm) for k in trace_counts)})
    print(f"  trace: {len(names)} kernel names, the port's: "
          + "; ".join(nm[:60] for nm in port_kernels))
    print(f"  main path wall ms, profiler off {wall['off']} on "
          f"{wall['on']}, the profiler's first start {cold_ms} ({smi})")
    autotune.clear()
    tdat.d_closeall()
    shutil.rmtree(tmp, ignore_errors=True)
    row = {"actions": [a.to_dict() for a in actions], "results": rows,
           "rollback": {"entry": prev_entry, "proposed": slower,
                        "before_s": back["before_s"],
                        "after_s": back["after_s"],
                        "reason": back.get("reason")},
           "apply_launches": {k: launches[k] for k in want},
           "rollback_launches": {k: back_launches.get(k, 0)
                                 for k in want},
           "journal_launches": journal_launches,
           "cli_apply": [{k: r.get(k) for k in ("kind", "kernel", "current",
                                                "proposed", "status",
                                                "reason", "before_s",
                                                "after_s")}
                         for r in cli_results],
           "cli_apply_s": cli_apply_s,
           "apply_s": apply_s, "child_s": child_s,
           "trace_launches": trace_counts,
           "trace_kernels": port_kernels,
           "wall_ms_profiler_off": wall["off"],
           "wall_ms_profiler_on": wall["on"],
           "wall_ms_profiler_first": cold_ms,
           "profiler_cost_pct": 100 * (statistics.median(wall["on"]) /
                                       statistics.median(wall["off"]) - 1)}
    print(json.dumps({"advise": {k: v for k, v in row.items()
                                 if k not in ("actions",)}, "gpu": smi}))
    return row


def advise_only() -> int:
    """``--advise``: build the kernels the phase runs and run
    ``advise_phase`` alone."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import distributedarrays_tpu_torch as tdat
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = gpu_name()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    tdat.kbuild.build(["gemm", "stencil", "collectives"])
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    row = advise_phase(tdat, smi)
    print(f"  advise phase {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"advise_launches": row["apply_launches"],
                      "gpu": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def telemetry_only() -> int:
    """``--telemetry``: build the kernels the phase runs and run
    ``telemetry_phase`` alone."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import distributedarrays_tpu_torch as tdat
    smi = gpu_name()
    print(smi)
    tdat.kbuild.build(["gemm", "stencil", "collectives", "attention",
                       "attention_bwd"])
    row = telemetry_phase(tdat)
    print(json.dumps({"telemetry_cost_pct": row["cost_pct"], "gpu": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def multihost_only() -> int:
    """``--multihost``: build the collective kernels and run the
    multi-process phase alone (``multihost_phase``)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import distributedarrays_tpu_torch as tdat
    smi = gpu_name()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    res = multihost_phase(tdat)
    print(json.dumps({"multihost_launches": res["launches"], "gpu": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------------------
# the GSPMD tp/dp layouts (phase 7e) and C27-C29 on the card
# ---------------------------------------------------------------------------

TP_DP_RANKS = 4               # make_mesh(4): (dp, tp) = (2, 2) on the card
TP_DP_STEPS = 3
TP_DP_PROMPT, TP_DP_NEW = 16, 16     # generate: a (4, 16) prompt, 16 tokens
TP_DP_MLP = (1024, 4096, 4096, 1024)
TP_DP_MLP_BATCH = 8192
TP_DP_MLP_LR = 1e-2
TP_DP_KERNELS = ("flash_attention", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv", "all_gather", "reduce_scatter")
# generate's logits on the tp layout against one rank's, over the steps
# whose tokens agree: bf16 row-parallel partial sums folded in another
# order (K12 + K10 against one product); the serving check's tolerance
TOL_TP_LOGITS = TOL_SERVE_BF16


def faults_on_card(tdat) -> None:
    """C27-C29 on the card, 4 ranks: uint16 and uint32 operators, product,
    extrema and scans (computed in the wider signed type, wrapped back)
    and complex orderings and running extrema (lexicographic), each
    against numpy on the same values; ``dmap``'s int64 result narrowed to
    int32."""
    rng = np.random.default_rng(3)

    def same(what, got, want):
        g = got.full().cpu() if isinstance(got, tdat.DArray) else got.cpu()
        w = np.asarray(want)
        ok = (g.to(torch.int64).numpy() == w.astype(np.int64)).all() \
            if not g.is_complex() else np.array_equal(g.numpy(), w)
        if g.shape != w.shape or not ok:
            raise AssertionError(f"{what} on the card differs from numpy")
    for dt in (np.uint16, np.uint32):
        x = rng.integers(0, np.iinfo(dt).max, (37, 11),
                         dtype=np.uint64).astype(dt)
        y = rng.integers(0, 1000, (11, 6)).astype(dt)
        d = tdat.distribute(x)
        if d.dtype != getattr(torch, np.dtype(dt).name):
            raise AssertionError(f"{dt} stored as {d.dtype}")
        for what, got, want in (
                ("+", d + 1, x + dt(1)), ("-", d - 3, x - dt(3)),
                ("//", d // 7, x // dt(7)), ("%", d % 5, x % dt(5)),
                ("<", d < 30000, x < 30000), (">=", d >= d // 2,
                                              x >= x // dt(2)),
                ("neg", -d, (-x.astype(np.int64)) % (int(np.iinfo(dt).max)
                                                     + 1)),
                ("abs", abs(d), x), ("~", ~d, ~x),
                ("@", d @ tdat.distribute(y), (x @ y).astype(dt)),
                ("dcumsum", tdat.dcumsum(d, 0), np.cumsum(x, 0, dtype=dt)),
                ("dcumprod", tdat.dcumprod(d, 1),
                 np.cumprod(x, 1, dtype=dt)),
                ("dcummax", tdat.dcummax(d, 0),
                 np.maximum.accumulate(x, 0)),
                ("dcummin", tdat.dcummin(d, 1),
                 np.minimum.accumulate(x, 1))):
            same(f"{np.dtype(dt).name} {what}", got, want)
        same(f"{np.dtype(dt).name} dmaximum", tdat.dmaximum(d),
             np.asarray(x.max()))
        same(f"{np.dtype(dt).name} dminimum dims=0",
             tdat.dminimum(d, 0), x.min(0, keepdims=True))
        tdat.d_closeall()
    if tdat.distribute(np.zeros((3, 4), np.uint64)).dtype != torch.uint32:
        raise AssertionError("uint64 is not stored as uint32")
    c = (rng.integers(-2, 3, (37, 11)) + 1j * rng.standard_normal(
        (37, 11))).astype(np.complex64)
    dc = tdat.distribute(c)
    for what, got, want in (("<", dc < 1, c < 1), (">=", dc >= 0, c >= 0),
                            ("dcummax", tdat.dcummax(dc, 0),
                             np.maximum.accumulate(c, 0)),
                            ("dcummin", tdat.dcummin(dc, 1),
                             np.minimum.accumulate(c, 1))):
        same(f"complex64 {what}", got, want)
    b = tdat.distribute(rng.integers(0, 2, (37, 11)).astype(bool))
    if tdat.dmap(lambda a: a * 3, b).dtype != torch.int32:
        raise AssertionError("dmap of bool * 3 is not int32")
    tdat.d_closeall()
    print("  C27-C29 on the card: uint16/uint32 operators, @, extrema and "
          "scans, complex orderings and running extrema, dmap's int32: "
          "as numpy")


# the device symbols of K10's and K12's kernels alone (``KERNEL_SYMBOLS``'
# ``copy_kernel`` also matches PyTorch's own copy kernels)
COLLECTIVE_SYMBOLS = {"all_gather": r"(^|[\s:])copy_kernel\(",
                      "reduce_scatter": r"reduce_(pieces|run)_kernel<"}


def kernels_device_ms(fn, names) -> dict:
    """The device ms of each kernel of ``names`` (kbuild names, matched by
    ``COLLECTIVE_SYMBOLS``) in one call of ``fn``, after a warm-up call."""
    import re
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names, 0.0)
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for n in names:
            if re.search(COLLECTIVE_SYMBOLS[n], e.key):
                out[n] += e.self_device_time_total / 1e3
    return out


def tp_dp_phase(tdat, smi: str) -> dict:
    """Phase 7e: the GSPMD tp/dp layouts at the flagship's full width,
    ``Config(8192, 1024, 16, 8, 4, 2048, bf16)`` on ``make_mesh(4)``
    (dp 2 x tp 2, 4 ranks of the card), tokens (4, 2049): three SGD
    ``train_step``s on ``shard_params``' Megatron layout (K5 on each tp
    rank's heads, K6/K7 backward, K12 + K10 for every tp and dp
    all-reduce), ``generate`` of 16 tokens and one MLP step at
    [1024, 4096, 4096, 1024] bf16 on a batch of 8192, with every kernel's
    count set to 0 before and read after (K5, K6, K7, K10 and K12 must
    launch); then the same steps with the plain attention and the plain
    reduce-scatter and all-gather (losses and unsharded parameters within
    ``TOL_SP_LOSS`` and ``TOL_TRAIN_BF16``), generate's logits against
    one rank's ``generate`` on the unsharded parameters, the MLP step
    against one rank's, and the step's wall and device ms beside one
    rank's ``train_step`` (and K12's and K10's device ms in it).  C27-C29
    are checked on the card first (``faults_on_card``)."""
    from distributedarrays_tpu_torch.models import mlp as M
    from distributedarrays_tpu_torch.models import tp_dp as TPD
    from distributedarrays_tpu_torch.ops import cuda_attention as CA
    from distributedarrays_tpu_torch.ops import cuda_collectives as CC
    T, kbuild = tdat.transformer, tdat.kbuild
    S = TRAIN_CFG[5]
    print(f"phase tp/dp (make_mesh({TP_DP_RANKS}) on one card, "
          f"Config{TRAIN_CFG} bf16, tokens (4, {S + 1}), lr {TRAIN_LR})")
    t_phase = time.perf_counter()
    kbuild.build(["attention", "attention_bwd", "collectives"])
    tdat.init(nranks=TP_DP_RANKS)
    faults_on_card(tdat)
    dev = tdat.layout.local_device()
    cfg = T.Config(*TRAIN_CFG, torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(7)
    model = T.init_params(cfg, gen, dev)
    tokens = torch.randint(0, cfg.vocab, (4, S + 1), generator=gen,
                           device=dev, dtype=torch.int32)
    prompt = tokens[:, :TP_DP_PROMPT]
    mesh = T.make_mesh(TP_DP_RANKS)
    mgen = torch.Generator(device=dev).manual_seed(9)
    mparams = M.init_params(mgen, TP_DP_MLP, torch.bfloat16, dev)
    x = torch.randn((TP_DP_MLP_BATCH, TP_DP_MLP[0]), generator=mgen,
                    device=dev).bfloat16()
    y = torch.randn((TP_DP_MLP_BATCH, TP_DP_MLP[-1]), generator=mgen,
                    device=dev).bfloat16()

    # the main path, its launches counted
    torch.cuda.synchronize()
    kbuild.reset_launches()
    sp = T.shard_params(model, mesh)
    losses, step_ms = [], []
    for _ in range(TP_DP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, lv = T.train_step(sp, tokens, TRAIN_LR, cfg)
        losses.append(float(lv))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    toks, logits = T.generate(sp, prompt, TP_DP_NEW, cfg, return_logits=True)
    msp = M.shard_params(mparams, mesh)
    xs, ys = M.shard_batch(x, y, mesh)
    _, mloss = M.train_step(msp, xs, ys, lr=TP_DP_MLP_LR)
    torch.cuda.synchronize()
    counts = {k: kbuild.launch_counts()[k] for k in TP_DP_KERNELS}
    print(f"  launches {counts}")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the tp/dp path: "
                             f"{missing}")
    print(f"  losses {losses}, MLP loss {float(mloss)}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0] or \
            not np.isfinite(float(mloss)):
        raise AssertionError(f"the tp/dp loss did not fall: {losses}, MLP "
                             f"{float(mloss)}")

    # the same steps with the plain kernels
    spp = T.shard_params(model, mesh)
    saved = (TPD.ring_reduce_scatter, TPD.ring_all_gather)
    TPD.ring_reduce_scatter = CC.reduce_scatter_plain
    TPD.ring_all_gather = CC.all_gather_plain
    before = kbuild.launch_counts()
    try:
        plosses = [float(T.train_step(
            spp, tokens, TRAIN_LR, cfg,
            _attend=lambda q, k, v, causal: CA.flash_attention_lse_plain(
                q, k, v, causal)[0])[1]) for _ in range(TP_DP_STEPS)]
    finally:
        TPD.ring_reduce_scatter, TPD.ring_all_gather = saved
    after = kbuild.launch_counts()
    if any(after[k] != before[k] for k in TP_DP_KERNELS):
        raise AssertionError("the plain steps launched a kernel")
    for i, (a, b) in enumerate(zip(losses, plosses)):
        check(f"tp/dp step {i} loss vs the plain kernels", abs(a - b) /
              abs(b), TOL_SP_LOSS)
    whole, wplain = T.unshard(sp), T.unshard(spp)
    worst = max((rel_err(a, b), n) for (n, a), (_, b) in zip(
        whole.named_parameters(), wplain.named_parameters()))
    check(f"tp/dp parameters after {TP_DP_STEPS} steps vs the plain "
          f"kernels, worst {worst[1]}", worst[0], TOL_TRAIN_BF16)
    del spp, wplain

    # generate against one rank's on the unsharded parameters
    rtoks, rlogits = T.generate(whole, prompt, TP_DP_NEW, cfg,
                                return_logits=True)
    new, rnew = toks[:, TP_DP_PROMPT:], rtoks[:, TP_DP_PROMPT:]
    diff = (new != rnew).any(0).nonzero()
    agree = int(diff[0]) if len(diff) else TP_DP_NEW
    # the logits of the steps whose inputs agree (the step that picks the
    # first differing token included)
    upto = min(agree + 1, TP_DP_NEW)
    gen_err = float((logits[:, :upto] - rlogits[:, :upto]).abs().max()
                    / rlogits[:, :upto].abs().max())
    check(f"generate on the tp layout vs one rank, logits of the first "
          f"{upto} new tokens ({agree} of {TP_DP_NEW} tokens equal)",
          gen_err, TOL_TP_LOGITS)

    # the MLP step against one rank's
    _, mref = M.train_step(mparams, x, y, lr=TP_DP_MLP_LR)
    check("MLP tp/dp step loss vs one rank", abs(float(mloss) - float(mref))
          / abs(float(mref)), TOL_SP_LOSS)
    mworst = max(rel_err(a[k], b[k]) for a, b in zip(M.unshard(msp),
                                                     mparams) for k in "wb")
    check("MLP tp/dp parameters vs one rank", mworst, TOL_TRAIN_BF16)
    del msp, xs, ys, x, y, mparams

    # times: the tp/dp step against one rank's train_step
    def tp_step():
        T.train_step(sp, tokens, TRAIN_LR, cfg)

    def one_step():
        T.train_step(whole, tokens, TRAIN_LR, cfg)
    wall = statistics.median(step_ms[1:])
    one_wall = []
    for _ in range(TP_DP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        one_wall.append((time.perf_counter() - t0) * 1e3)
    dev_ms = device_ms(tp_step, reps=2)
    one_dev_ms = device_ms(one_step, reps=2)
    coll = kernels_device_ms(tp_step, ("reduce_scatter", "all_gather"))
    row = {"shape": f"Config{TRAIN_CFG} bf16, (4, {S + 1}) tokens, "
                    f"make_mesh({TP_DP_RANKS}) {mesh.shape}",
           "launches": counts, "losses": losses, "plain_losses": plosses,
           "step_ms": step_ms, "wall_ms": wall, "device_ms": dev_ms,
           "one_rank_wall_ms": statistics.median(one_wall[1:]),
           "one_rank_device_ms": one_dev_ms,
           "k12_device_ms": coll["reduce_scatter"],
           "k10_device_ms": coll["all_gather"],
           "generate_tokens_equal": agree, "generate_logits_err": gen_err,
           "params_err": worst[0], "mlp_params_err": mworst,
           "phase_s": time.perf_counter() - t_phase}
    print(f"tp/dp step (make_mesh(4) on one card): wall {wall} ms, device "
          f"{dev_ms} ms; one-rank train_step: wall "
          f"{row['one_rank_wall_ms']} ms, device {one_dev_ms} ms; {smi}")
    print(f"tp/dp step device ms: K12 {coll['reduce_scatter']}, K10 "
          f"{coll['all_gather']}; {smi}")
    print(json.dumps({"tp_dp": row, "gpu": smi}))
    del sp, whole, model, tokens
    tdat.d_closeall()
    torch.cuda.empty_cache()
    return row


def tp_dp_only() -> int:
    """``--tp-dp``: build the kernels the phase runs and run it alone."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import distributedarrays_tpu_torch as tdat
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = gpu_name()
    print(smi)
    row = tp_dp_phase(tdat, smi)
    print(json.dumps({"ok": True, "tp_dp_launches": row["launches"],
                      "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
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
    slv = solvers_phase(tdat, errs)
    srv = serve_phase(tdat, errs)
    mdl = models_phase(tdat, errs)

    # -- 6. attention: kernels, serving, sequence parallel -----------------
    attention_kernels(randn, errs)
    counts_serve = serving(tdat, dev)
    counts_sp = sequence_parallel(tdat)

    # -- 7. training: kernels, train_step, the data-parallel Trainer -------
    training_kernels(randn, errs)
    ring_gemm_kernels(randn, errs)
    counts_train = training(tdat, dev)
    counts_trainer = trainer_phase(tdat)
    tele = telemetry_phase(tdat)
    adv = advise_phase(tdat, smi)
    trt = train_runtime_phase(tdat)
    counts_sp_train = sp_training(tdat, dev)
    tpdp = tp_dp_phase(tdat, smi)

    # -- 8. ranks on several cards ------------------------------------------
    across_cards(tdat, cuda_collectives)

    # -- 8b. several processes on the card -----------------------------------
    mh = multihost_phase(tdat)
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
        if name in ("gemm", "stencil_step", "all_gather", "all_to_all"):
            kern["solvers_launches"] = {
                k: v[name] for k, v in slv["launches"].items()}
        if name in srv["launches"]:
            kern["serve_launches"] = srv["launches"][name]
        if name in mdl["launches"]:
            kern["models_launches"] = mdl["launches"][name]
        if name in trt["launches"]:
            kern["train_runtime_launches"] = trt["launches"][name]
        if name == "all_gather":
            # K10 across the processes: each process's launches in the
            # checked gather_global call (one a call), and its times
            kern["multihost_launches"] = mh["launches"]
            kern["multihost_region_launches"] = mh["region_launches"]
            kern["multihost"] = mh["row"]
        if name in mh["tp_dp_launches"]:
            # the tp/dp step across the 4 processes: a process's launches
            # in its two steps (readings in the multihost row's "tp_dp")
            kern["multihost_tp_dp_launches"] = mh["tp_dp_launches"][name]
        if name in mh["trainer_launches"]:
            # the Trainer across the processes: a process's launches a
            # step (readings in the multihost row's "trainer")
            kern["multihost_trainer_launches"] = mh["trainer_launches"][name]
        if name in adv["apply_launches"]:
            # the advise phase: launches during apply's probes (K1 in the
            # resweep, K14 in the dispatch tune)
            kern["advise_launches"] = adv["apply_launches"][name]
        if name in tpdp["launches"]:
            # the GSPMD tp/dp phase's launches (three train_steps,
            # generate and an MLP step on make_mesh(4))
            kern["tp_dp_launches"] = tpdp["launches"][name]
        if name in mh["legs_kernels"]:
            # the cross-process legs' launches a process (K4-K11, K13-K15),
            # leg by leg; readings in the multihost row's "legs" and
            # "train"
            kern["multihost_legs_launches"] = mh["legs_kernels"][name]
    extra["telemetry"] = tele
    extra["advise"] = {k: v for k, v in adv.items() if k != "actions"}
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
             else tp_dp_only() if sys.argv[1:] == ["--tp-dp"]
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
             else solvers_only() if sys.argv[1:] == ["--solvers"]
             else serve_only() if sys.argv[1:] == ["--serve"]
             else models_only() if sys.argv[1:] == ["--models"]
             else train_runtime_only() if sys.argv[1:] == ["--train-runtime"]
             else multihost_only() if sys.argv[1:] == ["--multihost"]
             else telemetry_only() if sys.argv[1:] == ["--telemetry"]
             else advise_only() if sys.argv[1:] == ["--advise"]
             else advise_journal(sys.argv[2], sys.argv[3])
             if sys.argv[1:2] == ["--advise-journal"]
             else multihost_child(int(sys.argv[2]), int(sys.argv[3]),
                                  sys.argv[4])
             if sys.argv[1:2] == ["--multihost-child"]
             else k1_k9_times(*sys.argv[2:3])
             if sys.argv[1:2] == ["--time-k1-k9"]
             else ring_gemm_times(*sys.argv[2:3])
             if sys.argv[1:2] == ["--time-ring-gemms"] else main())
