"""distributedarrays_tpu_torch: the DArray library on PyTorch and CUDA.

The PyTorch/CUDA port of ``distributedarrays_tpu`` (a JAX rebuild of
DistributedArrays.jl), exporting the ported names under the JAX package's
names::

    import torch
    import distributedarrays_tpu_torch as tdat

    tdat.init()                               # one rank per CUDA device
    d = tdat.drand((8192, 8192))
    r = tdat.dmap(torch.sin, d) + d * 2.0     # owner-computes elementwise
    s = float(tdat.dsum(r))                   # local reduce, then combine
    C = d @ r.T                               # distributed GEMM
    Q = tdat.dmatmul_int8(d, r)               # int8 GEMM, f32 out
    x = tdat.gather(C)                        # numpy on the host
    d[100:200] = 1.0                          # owner ranks write in place
    e = tdat.reshard.reshard(d, pids, cuts)   # K11 / the K10/K11 chain
    ranks = tdat.spmd(lambda: tdat.myid())    # one task per rank
    c = tdat.dcumsum(d, axis=1)               # scans keep the layout
    f = tdat.dfft(d, axis=0)                  # K11 all-to-alls around FFTs
    s = tdat.dsort(tdat.drand(10 ** 7))       # PSRS, one K11 exchange
    y = tdat.dconv2d(d, torch.ones(3, 3))     # halo exchange + F.conv2d
    n = tdat.mapslices(lambda v: v / v.norm(), d, dims=0)
    assert d == d.copy()                      # whole-array equality

    q = k = v = tdat.drandn((8192, 16, 64), dist=(tdat.nranks(), 1, 1))
    o = tdat.ring_attention(q, k, v, causal=True)   # sequence-parallel
    T = tdat.transformer
    cfg = T.Config(8192, 1024, 16, 8, 4, 2048)
    model = T.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    logits = T.forward(model, tokens, cfg)    # (B, S, vocab) f32
    out = T.generate(model, prompt, 64, cfg)  # greedy KV-cache decode
    model, loss = T.train_step(model, batch, 0.5, cfg)   # SGD, in place

    SP = tdat.sp_transformer                  # sequence-parallel training
    tdat.init(nranks=4)
    scfg = SP.SPConfig(8192, 1024, 16, 8, 4, 8192)
    shards = SP.shard_params(SP.init_params(scfg, gen), [0, 1, 2, 3])
    step = SP.make_train_step([0, 1, 2, 3], scfg)
    shards, loss = step(shards, tokens_1x8192, 0.3)  # K8/K6/K7, K13/K14/K15

    eng = tdat.serve.DecodeEngine()           # paged KV cache decode
    srv = tdat.serve.Server()                 # admission, batching
    eng.attach(srv, "decode")                 # prefill on K9 (>= 2 ranks)
    tokens = srv.submit("decode", [1, 2, 3]).result().result()

    S = tdat.solvers                          # Krylov + multigrid
    op = S.StencilOperator((1024, 1024))      # K2 a rank an apply
    res = S.cg(op, b, tol=1e-6, M=S.Multigrid(op))   # res.x, res.iterations
    with tdat.telemetry.span("phase"):        # counters, spans, journal
        ...
    print(tdat.telemetry.report())

    tdat.init(nranks=4)                       # data-parallel training
    task = tdat.train.transformer_task(vocab=8192, dim=1024, heads=16,
                                       layers=8, seq=2048, batch_size=8)
    with tdat.train.Trainer(task, tdat.train.adam(1e-4)) as t:
        losses = t.fit(3)["losses"]
    with tdat.Trainer(task, ckpt_dir="ckpt", save_every=2,
                      peer_replicas=True) as t:   # resume, recovery
        t.fit(4)
    tdat.checkpoint.save("ckpt/x", {"d": d, "step": 3})   # JAX's format
    tree = tdat.checkpoint.load("ckpt/x")

    mesh = tdat.moe.make_ep_mesh(8)           # one expert a rank
    p = tdat.moe.init_moe_params(gen, 8, 4096, 14336, torch.bfloat16)
    y, aux = tdat.moe.moe_forward(p, x, mesh, k=2, return_aux=True)  # K11
    pp = tdat.pipeline.init_pipeline_params(gen, 4, 8192, n_layers=2)
    out = tdat.pipeline.pipeline_forward(pp, mb, tdat.pipeline.make_pp_mesh(4))
    C, shifts = tdat.kmeans.kmeans(tdat.drand((10 ** 6, 32)), 64)
    est = tdat.montecarlo.pi_estimate(10 ** 9, batches=10)

Entry points run on the CUDA devices unless ``init(device="cpu")`` asks for
the CPU; without a CUDA device and without that request they raise.  The
package imports neither JAX nor the JAX package.
"""

from . import core, layout
from .core import (allowscalar, close, current_rank, d_closeall, live_arrays,
                   live_ids, next_did, procs, registry)
from .layout import (all_ranks, chunk_idxs, cut_intersections, defaultdist,
                     defaultdist_1d, device_of, even_cuts, init, nranks)
from .darray import (DArray, DData, SubDArray, SubOrDArray, copyto_, darray,
                     darray_from_cuts, darray_like, dcat, ddata, dfetch, dfill,
                     dfromfunction, distribute, dones, drand, drandint,
                     drandn, dsample, dzeros, from_chunks, gather, isassigned,
                     localindices, localpart, locate, makelocal, seed)
from . import analysis, parallel, resilience, telemetry
from .parallel import collectives, reshard, spmd_mode
from .parallel.collectives import (axis_rank, axis_size, halo_exchange,
                                   halo_exchange_2d, pall_to_all, pbarrier,
                                   pbcast, pconcat, pgather, preduce,
                                   preduces, pshift, pshifts, psum_scatter,
                                   run_spmd, spmd_mesh)
from .parallel.spmd_mode import (SPMDContext, barrier, bcast, close_context,
                                 context, context_local_storage, gather_spmd,
                                 myid, nprocs, recvfrom, recvfrom_any,
                                 scatter, sendto, spmd, spmd_async)
from .ops import (broadcast, collective_matmul, conv, cuda_attention,
                  cuda_collectives, cuda_gemm, cuda_stencil, fft, linalg,
                  mapreduce, sort, sparse)
from .ops.cuda_attention import flash_attention
from .ops.broadcast import broadcasted, djit, dmap, dmap_into, elementwise
from .ops.mapreduce import (dall, dany, dcount, dcummax, dcummin, dcumprod,
                            dcumsum, dextrema, dmapreduce, dmaximum, dmean,
                            dminimum, dprod, dreduce, dstd, dsum, dvar,
                            map_localparts, map_localparts_into, mapslices,
                            ppeval, samedist)
from .ops.conv import dconv2d
from .ops.fft import dfft, dfft2, difft, difft2
from .ops.sort import dsort
from .ops.sparse import ddata_bcoo, dnnz
from .ops.linalg import (axpy_, dadjoint, ddot, dmatmul_int8, dnorm,
                         dtranspose, lmul_, lmul_diag, matmul, mul_into,
                         rmul_, rmul_diag, tune_matmul_impl,
                         tune_matmul_impl_dist, tune_matmul_impl_summa)
from .models import (kmeans, mlp, moe, montecarlo, pipeline, sp_transformer,
                     stencil, transformer, ulysses)
from .models.ring_attention import (reference_attention, ring_attention,
                                    ring_attention_prefill,
                                    ring_flash_attention, zigzag_order,
                                    zigzag_ring_attention,
                                    zigzag_ring_flash_attention,
                                    zigzag_shard, zigzag_unshard)
from .models.stencil import (life, life2d, life_step, stencil3x3, stencil5,
                             stencil5_step)
from .models.ulysses import ulysses_attention
from .interop import (from_reference, params_from_reference,
                      params_to_reference, to_reference)
from .utils import autotune, checkpoint, kbuild
from . import serve, solvers, train
from .train import Trainer

__all__ = [
    "init", "nranks", "all_ranks", "device_of",
    "defaultdist", "defaultdist_1d", "chunk_idxs", "locate",
    "cut_intersections", "even_cuts",
    "next_did", "registry", "live_ids", "live_arrays", "close", "d_closeall",
    "allowscalar", "procs", "current_rank",
    "DArray", "SubDArray", "SubOrDArray", "DData", "ddata", "darray",
    "darray_like", "dfromfunction", "from_chunks", "darray_from_cuts",
    "dzeros", "dones", "dfill", "drand", "drandn", "drandint", "dsample",
    "distribute", "copyto_", "dcat", "dfetch", "isassigned", "gather",
    "localpart", "localindices", "makelocal", "seed",
    "halo_exchange", "halo_exchange_2d", "pshift", "pshifts", "pgather",
    "preduce", "preduces", "pconcat",
    "pall_to_all", "psum_scatter", "pbarrier", "pbcast", "axis_rank",
    "axis_size", "spmd_mesh", "run_spmd",
    "spmd", "spmd_async", "sendto", "recvfrom", "recvfrom_any", "barrier",
    "bcast", "scatter", "gather_spmd", "context", "context_local_storage",
    "myid", "nprocs", "SPMDContext", "close_context",
    "parallel", "resilience", "reshard", "spmd_mode", "telemetry",
    "analysis", "solvers", "serve",
    "elementwise", "dmap", "dmap_into", "broadcasted", "djit",
    "dreduce", "dmapreduce", "dsum", "dprod", "dmaximum", "dminimum",
    "dmean", "dvar", "dstd", "dall", "dany", "dcount", "dextrema",
    "dcumsum", "dcumprod", "dcummax", "dcummin",
    "map_localparts", "map_localparts_into", "samedist", "mapslices",
    "ppeval",
    "axpy_", "ddot", "dnorm", "rmul_", "lmul_", "lmul_diag", "rmul_diag",
    "matmul", "mul_into", "dtranspose", "dadjoint", "tune_matmul_impl",
    "tune_matmul_impl_dist", "tune_matmul_impl_summa", "dmatmul_int8",
    "dconv2d", "dfft", "difft", "dfft2", "difft2", "dsort", "dnnz",
    "ddata_bcoo",
    "stencil3x3", "stencil5", "stencil5_step", "life", "life_step",
    "life2d",
    "flash_attention", "ring_attention", "ring_flash_attention",
    "ring_attention_prefill", "reference_attention", "ulysses_attention",
    "zigzag_order", "zigzag_shard", "zigzag_unshard", "zigzag_ring_attention",
    "zigzag_ring_flash_attention",
    "transformer", "sp_transformer", "mlp", "pipeline", "moe", "kmeans",
    "montecarlo", "train", "Trainer", "checkpoint", "autotune", "kbuild",
    "from_reference", "to_reference", "params_from_reference",
    "params_to_reference",
]
