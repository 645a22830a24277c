"""Collective kernels over rank tensors: the hand-written CUDA kernels
(``csrc/collectives.cu``) and their plain versions.

PyTorch counterpart of ``ring_all_gather``, ``ring_all_to_all``,
``ring_reduce_scatter``, ``ring_allgather_matmul``,
``ring_allgather_matmul_rhs`` and ``ring_matmul_reducescatter`` in
``distributedarrays_tpu/ops/pallas_collectives.py``.  Each function takes the p ranks' tensors in ring
order (as the JAX functions take one shard per ``axis_index``) and returns
one tensor per rank, on that rank's device.  For CPU tensors it takes the
plain version; for CUDA tensors it launches the kernel or raises, with no
fallback.  The ranks may share one card or sit on several cards; across
cards a kernel reads or writes the peer rank's memory through its device
pointer (peer access, ``kbuild.enable_peer_access``), the GPU form of the
TPU's remote DMA.  NCCL, ``torch.distributed`` and ``cudaMemcpyPeer`` are
not used.

- ``ring_all_gather(blocks, dim)``: every rank gets the blocks concatenated
  along ``dim`` (``lax.all_gather(..., tiled=True)``; blocks may differ in
  size along ``dim``, as in ``torch.cat``).
- ``ring_all_to_all(blocks, split_dim, concat_dim)``: rank ``q`` gets piece
  ``q`` of every rank's block split along ``split_dim``, concatenated along
  ``concat_dim`` (``lax.all_to_all(..., tiled=True)``).
- ``ring_all_to_allv(arrays, counts)``: the all-to-all of exact-size
  pieces of 1-D tensors that ``dsort``'s exchange makes (JAX pads every
  piece to a static size and runs ``lax.all_to_all``), on the same copy
  kernel and counted as the all-to-all.

- ``chain_step(kind, blocks, groups, src_dim, dst_dim, full, windows)``:
  one step of the reshard planner's chain (``parallel/reshard.py``), an
  all-to-all (K11) or all-gather (K10) within every group of ranks at once,
  each rank keeping a window of its output; the planner's ``_chain_jit``
  steps (``distributedarrays_tpu/parallel/reshard.py:915``).

- ``process_regions(arrays, wants, all_gather_json, barrier, kernel)``:
  the copy kernel across controller processes, the GPU form of JAX's
  cross-process collectives (its replication program and
  ``process_allgather``, ``parallel/multihost.py:339-382``, the
  resharding XLA runs over the DCN mesh, and the ``shard_map``
  collectives over a process-spanning mesh).  Every process of a
  multi-process job calls it once an op, with the same sources
  ``arrays`` (process-spanning DArrays, and rank lists: one tensor a
  rank, another process's a ``meta`` placeholder) and its own list of
  wants: a global box of a DArray, or a box of one rank's tensor of a
  rank list, and the tensor on its card to fill (``parallel.multihost
  .exchange`` and ``fetch_regions`` build them; the rank-list
  collectives of ``parallel.collectives`` and ``ring_all_to_all(v)``
  in a job are such calls).  Each want is cut at the source chunks'
  cuts; a tensor this process holds is read through its own pointer, a
  peer process's through the CUDA IPC mapping of its allocation plus the
  offset and strides the peer published (handles exchanged through the
  job's store; a rank list's owners are the processes that publish its
  tensors), and the whole list runs as one copy launch on this process's
  card (``copy_launches`` splits a list above ``copy_maxp()`` copies).
  Two barriers order it (``peer_call``, the protocol of every call that
  reads or writes a peer process's memory: this one, K12's, the ring
  GEMMs' and K9's in a job): every process's tensors are written (a
  stream sync) before any peer reads them, and no process frees or
  rewrites one before every peer has read it (a sync after the launch,
  then a barrier).  A handle that will not open, or a launch that fails,
  raises.  Counted as ``kernel`` (``all_gather``, K10, or
  ``all_to_all``, K11) on the ``cross_process_region`` route.  ``process_regions_plain(arrays, wants, group)`` is its plain
  version over the job's gloo group: the wants all-gathered as metadata,
  then one host message from each holder to each wanting process
  (``isend``/``irecv``; gloo has no all-to-all).

  *Peer mappings live for one call.*  CUDA leaves it undefined when an
  exporting process frees an allocation (``cudaFree``, which PyTorch's
  caching allocator issues on ``torch.cuda.empty_cache()`` or to retry a
  failed allocation) that another process still maps; PyTorch's own CUDA
  IPC avoids it by keeping the exporter's block alive with shared
  reference counts.  Here a call maps each peer allocation it reads once,
  and unmaps all of them after its launch has finished and before its
  closing barrier; no process can leave that barrier, and so free
  anything, while a peer still maps its memory.  A block freed and
  allocated anew between calls gets a new handle, which the next call
  maps afresh.  So the mappings open at any time are those of the call in
  progress (``open_mappings()``: 0 between calls), however long the job,
  and a handle is never opened twice in one process.

- ``ring_reduce_scatter(blocks, dim)``: rank ``d`` gets the sum of piece
  ``d`` of every rank's block split along ``dim``
  (``lax.psum_scatter(..., tiled=True)``), summed in the TPU ring's arrival
  order (``parallel.collectives.psum_scatter``).

  All four pull.  The all-gather, all-to-all and chain step make one
  launch per card
  (``copy_launches`` groups the copies: each source with every destination
  on the card that takes it, at most ``copy_maxp()`` copies a launch: 64
  where the toolkit takes kernel parameters above 4 KB, else ``MAXP``),
  which
  copies every source's block or piece straight to its final offset in
  each destination output, reading the source once (pure data movement,
  bit-identical to the plain version).  The reduce-scatter makes one launch
  per destination rank, which reads piece ``d`` of every rank and writes
  their fold in the plain version's order, bit-identical to it too.  The
  JAX kernels' chunk depth (``chunks``, ``_chunk_fit``) and the
  reduce-scatter's VMEM gate (``_rs_vmem_bytes``) only bound the TPU's
  VMEM staging of pieces and travelling partials; nothing is staged here
  and no partial is stored, so there is no chunk argument and no gate.
  float32 or bfloat16 for the reduce-scatter.  In a job of several
  controller processes (another process's blocks are ``meta``
  placeholders) the all-gather is ``pgather``'s one exchange (a copy
  launch a process, ``cross_process_region``) and the reduce-scatter
  makes one launch for each of this process's ranks whose pointer array
  holds the peer processes' pieces through CUDA IPC mappings
  (``_reduce_scatter_job``, counted on the ``cross_process`` route),
  under ``peer_call``'s rules, those of ``process_regions``: the blocks
  written before any peer reads them, the mappings closed after the
  launches and before the closing barrier, which keeps every exporter's
  blocks alive until each peer has read them.  Where the job spans hosts
  or a peer computes on the CPU, a process on the card brings the peers'
  pieces over the job's exchange and folds them with the same launches
  (``_reduce_scatter_fetched``, the ``cross_process_fetched`` route).
  Off the card both take the gloo route.

  Each call counts ``pallas_collectives.dispatch`` (``path`` ``rdma`` for
  the kernel, ``plain`` otherwise) and, on the kernel, a comm record, as
  JAX's ``_record_dispatch``.

- ``ring_allgather_matmul(x_blocks, w_blocks)`` (K13): rank ``r`` gets
  ``all_gather(x) @ w_r``, with x's row chunks travelling the ring: at step
  t the resident chunk came from rank ``(r + t) % p`` and its f32 product
  with ``w_r``, cast once to the output type, fills that chunk's row block.
- ``ring_allgather_matmul_rhs(a_blocks, b_blocks)`` (K14): rank ``r`` gets
  ``a_r @ all_gather(b)``, with b's chunks travelling the ring: at step t
  the resident chunk came from rank ``(r + t) % p``, its f32 product with
  the matching column slice of ``a_r`` is cast to the output type and added
  in that order, as in the JAX kernel.
- ``ring_matmul_reducescatter(x_blocks, w_blocks)`` (K15): rank ``r`` gets
  row block ``r`` of ``sum_q x_q @ w_q``: the partial for destination
  ``(r - 1 - t) % p`` travels right; at step t rank r casts its f32 block
  product to the type and adds it to the partial that arrived from the left
  (in the type), so the sum for destination d runs over ranks d+1, d+2,
  ..., d+p (mod p), add for add as the JAX ring.

  In K13 and K14 one launch per rank per step both forwards the resident
  chunk into the left neighbour's free slot of a two-slot buffer and
  computes the product; in K15 the launch writes its sum straight into the
  right neighbour's receive slot (or the output at the last step).  The TPU
  kernels' VMEM budget gate (``gemm_ring_eligible``) has no counterpart: the
  operands stay in device memory.  float32 or bfloat16 (bf16 on the tensor
  cores), one dtype for both operands.  All three take the route
  ``ring_gemm_route`` picks for the call (``kbuild.route_counts()`` counts
  every step under it): bf16 that TMA can read on wgmma, other bf16 on
  mma.sync, f32 on the pipelined FP32 tile.  On wgmma K13 and K14 forward
  their chunk by TMA stores riding on the product's tile loads, and K15
  loads the received partial and stores its sum by TMA; a step whose slot
  lies on another card (the left neighbour's for K13 and K14, the right
  one's for K15) takes ``wgmma_peer``: the forward by a copy launch of its
  own (K13, K14), or the sum stored element by element (K15).

  In a job of several controller processes (another process's blocks are
  ``meta`` placeholders) each process launches the steps of its own ranks
  (``_Ring``): it publishes the CUDA IPC handles of its ranks' two-slot
  buffers once a call (with the route its operands allow; the least of
  every process's is taken), a step whose slot is another process's
  writes it through the mapping of that allocation (counted as
  ``route_counts()["allgather_matmul_forward" |
  "allgather_matmul_rhs_forward" | "matmul_reducescatter_forward"]
  ["cross_process"]``), a stream sync and a store barrier end each step,
  and the mappings close before the call's closing barrier.  Off the card
  the plain rings run on the cross-process ``pshift``.  Another process's
  results are placeholders.

Steps that depend on each other are ordered by stream order on one card,
by CUDA event waits across cards, and by a store barrier a step across
processes; no kernel waits on a flag set by another.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Callable, Sequence

import numpy as np
import torch

from .. import layout as L
from .. import telemetry as _tm
from ..parallel import multihost
from ..parallel.collectives import pall_to_all, pgather, pshift, psum_scatter
from ..utils import kbuild
from . import ring_schedules as _rs

__all__ = ["ring_all_gather", "ring_all_to_all", "ring_reduce_scatter",
           "ring_allgather_matmul", "ring_allgather_matmul_rhs",
           "ring_matmul_reducescatter", "ring_gemm_route", "ring_tile_n",
           "copy_launches", "copy_width", "view_copy", "chain_step",
           "chain_step_plain", "ring_all_to_allv", "all_to_allv_plain",
           "all_gather_plain", "all_to_all_plain", "reduce_scatter_plain",
           "process_regions", "process_regions_plain", "peer_call",
           "region_handles",
           "region_copies", "ipc_handle", "open_mappings", "close_ipc",
           "allgather_matmul_plain", "allgather_matmul_rhs_plain",
           "matmul_reducescatter_plain"]

MAXP = 32            # sources or copies one launch takes (collectives.cu)
_RING_DTYPES = (torch.float32, torch.bfloat16)


def _on_cuda(tensors: Sequence[torch.Tensor]) -> bool:
    """True for all-CUDA tensors, False for all-CPU ones; raise on a mix."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"rank tensors on {sorted(kinds)}: the collectives need "
                     "all of them on CUDA devices or all on the CPU")


def _record_dispatch(op: str, blocks) -> None:
    """A collective call's dispatch count and, when its kernel runs, its
    comm record, as JAX's ``_record_dispatch``
    (``pallas_collectives.py:230``): ``path`` is ``rdma`` when this
    process's tensors are on the card (the kernel, JAX's name for its
    remote-DMA kernels) and ``plain`` otherwise; the record is the per-rank
    block's bytes with ``bytes_ici`` the (p - 1) hops a ring forwards it,
    once a distinct call signature."""
    if not _tm.enabled():
        return
    held = [b for b in blocks if b.device.type != "meta"]
    path = "rdma" if held and held[0].is_cuda else "plain"
    _tm.count("pallas_collectives.dispatch", op=op, path=path)
    if path == "rdma":
        x, p = held[0], len(blocks)
        labels = {"bytes_ici": (p - 1) * _tm.nbytes_of(x)} if p > 1 else {}
        _tm.record_comm(op, _tm.nbytes_of(x), axis="ranks", traced=True,  # dalint: disable=DAL003 — _record_dispatch returns first while telemetry is disabled
                        dispatch=path,
                        once_key=f"pallas_collectives:{op}:{path}:ranks:"
                                 f"{labels}", **labels)


def _check_contiguous(tensors, what):
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"the {what} kernel needs contiguous rank tensors")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


# the plain all-gather, all-to-all and reduce-scatter are the rank-list
# collectives
all_gather_plain = pgather
all_to_all_plain = pall_to_all
reduce_scatter_plain = psum_scatter


def _f32_product(x, w, dtype):
    """``x @ w`` with f32 products and sums, cast to ``dtype``."""
    return (x.float() @ w.float()).to(dtype)


def allgather_matmul_plain(x_blocks, w_blocks) -> list[torch.Tensor]:
    """The plain ring of K13: ``pshift`` brings rank r+1's chunk each step;
    the resident chunk from rank ``(r + t) % p`` multiplies ``w_r`` in f32
    and, cast to the output type, fills its row block."""
    p = len(x_blocks)
    out_dtype = torch.promote_types(x_blocks[0].dtype, w_blocks[0].dtype)
    m_loc = x_blocks[0].shape[0]
    outs = [torch.empty((p * m_loc, w.shape[1]), dtype=out_dtype,
                        device=w.device) for w in w_blocks]
    cur = list(x_blocks)
    for t in range(p):
        if t:
            cur = pshift(cur, -1)            # fetch rank r+1's chunk
        for r in range(p):
            src = (r + t) % p
            outs[r][src * m_loc:(src + 1) * m_loc] = _f32_product(
                cur[r], w_blocks[r], out_dtype)
    return outs


def allgather_matmul_rhs_plain(a_blocks, b_blocks) -> list[torch.Tensor]:
    """The plain ring of K14: ``pshift`` brings rank r+1's chunk each step;
    the resident chunk from rank ``(r + t) % p`` contracts against its
    column slice of ``a_r`` in f32, is cast to the output type and added."""
    p = len(b_blocks)
    out_dtype = torch.promote_types(a_blocks[0].dtype, b_blocks[0].dtype)
    k_loc = b_blocks[0].shape[0]

    def part(r, src, chunk):
        return _f32_product(a_blocks[r][:, src * k_loc:(src + 1) * k_loc],
                            chunk, out_dtype)

    cur = list(b_blocks)
    acc = [part(r, r, cur[r]) for r in range(p)]
    for t in range(1, p):
        cur = pshift(cur, -1)                # fetch rank r+1's chunk
        acc = [acc[r] + part(r, (r + t) % p, cur[r]) for r in range(p)]
    return acc


def matmul_reducescatter_plain(x_blocks, w_blocks) -> list[torch.Tensor]:
    """The plain ring of K15: rank r seeds the partial for destination
    ``(r - 1) % p``; each step the partials move one rank right
    (``pshift``) and rank r adds its block for destination
    ``(r - 1 - t) % p``, the f32 product cast to the type, in the type."""
    p = len(x_blocks)
    out_dtype = torch.promote_types(x_blocks[0].dtype, w_blocks[0].dtype)
    m_loc = x_blocks[0].shape[0] // p

    def block(r, d):
        return _f32_product(x_blocks[r][d * m_loc:(d + 1) * m_loc],
                            w_blocks[r], out_dtype)

    acc = [block(r, (r - 1) % p) for r in range(p)]
    for t in range(1, p):
        acc = pshift(acc, 1)                 # forward to rank r+1
        acc = [acc[r] + block(r, (r - 1 - t) % p) for r in range(p)]
    return acc


# ---------------------------------------------------------------------------
# launch plumbing
# ---------------------------------------------------------------------------

_fns: dict = {}
_ARGTYPES = {
    "da_copy_pieces": [ctypes.c_int] + [ctypes.c_void_p] * 8 +
    [ctypes.c_int, ctypes.c_void_p],
    "da_copy_maxp": [],
    "da_reduce_pieces": [ctypes.c_int] + [ctypes.c_void_p] * 3 +
    [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p],
    "da_ring_ag_mm_step": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 +
    [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "da_ring_ag_mm_a_step": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 +
    [ctypes.c_void_p],
    "da_ring_mm_rs_step": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 +
    [ctypes.c_void_p],
    "da_ipc_handle_size": [],
    "da_ipc_handle": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int],
    "da_ipc_open": [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
    "da_ipc_close": [ctypes.c_void_p],
}


def _fn(name: str):
    f = _fns.get(name)
    if f is None:
        f = getattr(kbuild.load("collectives"), name)
        f.restype = ctypes.c_int
        f.argtypes = _ARGTYPES[name]
        _fns[name] = f
    return f


def _box(src: torch.Tensor, dst: torch.Tensor):
    """A copy of equal-shaped strided views as (sizes, src strides, dst
    strides) of up to 3 outer dims, in bytes, and a contiguous run."""
    isz = src.element_size()
    dims = [(n, a, b) for n, a, b in zip(src.shape, src.stride(), dst.stride())
            if n != 1]
    if not dims or (src.shape[-1] == 1 and dims[-1][1:] != (1, 1)):
        # the innermost dim is 1 wide (a one-column box): runs of one
        # element
        dims.append((1, 1, 1))
    merged = [list(dims[0])]
    for n, a, b in dims[1:]:
        _, pa, pb = merged[-1]
        if pa == n * a and pb == n * b:      # contiguous in both: one dim
            merged[-1] = [merged[-1][0] * n, a, b]
        else:
            merged.append([n, a, b])
    run, ra, rb = merged.pop()
    if ra != 1 or rb != 1 or len(merged) > 3:
        raise ValueError(f"cannot copy a {tuple(src.shape)} box with strides "
                         f"{src.stride()} -> {dst.stride()}")
    merged = [[1, 0, 0]] * (3 - len(merged)) + merged
    return ([m[0] for m in merged], [m[1] * isz for m in merged],
            [m[2] * isz for m in merged], run * isz)


def copy_width(src: int, box, part) -> int:
    """The widest access (16, 4 or 1 bytes) that a ``copy_launches`` group
    allows: its source's and every destination's address, strides and
    run."""
    _, sstr, run = box
    acc = src | run
    for a in list(sstr) + [x for d, dstr in part for x in (d, *dstr)]:
        acc |= int(a)
    return 16 if acc % 16 == 0 else 4 if acc % 4 == 0 else 1


def copy_launches(copies, maxp: int = MAXP) -> list[list[tuple]]:
    """Group one card's copies ``(dest, src address, dst address, box)``
    (``box``: ``_box``'s sizes, source strides, destination strides and
    run, in bytes) into launches of ``(src address, (sizes, src strides,
    run), [(dst address, dst strides), ...])``: a source goes with every
    destination that takes it with the same source box, so the launch
    reads it once; a launch holds at most ``maxp`` copies, a source's list
    split where it is longer."""
    groups: dict[tuple, tuple] = {}
    for _, src, dst, (sizes, sstr, dstr, run) in copies:
        key = (src, tuple(sizes), tuple(sstr), run)
        groups.setdefault(key, (src, (sizes, sstr, run), []))[2].append(
            (dst, dstr))
    launches, cur, used = [], [], 0
    for src, box, dsts in groups.values():
        for i in range(0, len(dsts), maxp):
            part = dsts[i:i + maxp]
            if used + len(part) > maxp:
                launches.append(cur)
                cur, used = [], 0
            cur.append((src, box, part))
            used += len(part)
    if cur:
        launches.append(cur)
    return launches


def view_copy(dest: int, src: torch.Tensor, dst: torch.Tensor) -> tuple:
    """The ``copy_launches`` copy of view ``src`` into view ``dst``."""
    return (dest, src.data_ptr(), dst.data_ptr(), _box(src, dst))


def _copy_launch(launch, dev: torch.device, kernel: str,
                 route: str | None = None) -> None:
    """One ``da_copy_pieces`` launch on ``dev`` of a ``copy_launches``
    entry."""
    n = len(launch)
    dsts = [d for _, _, part in launch for d in part]
    src, sstr, sizes, runs, ndst, vec = [], [], [], [], [], []
    for s, box, part in launch:
        sz, a, run = box
        src.append(s)
        sstr += a
        sizes += sz
        runs.append(run)
        ndst.append(len(part))
        vec.append(copy_width(s, box, part))
    ll = ctypes.c_longlong
    rc = _fn("da_copy_pieces")(
        n, (ctypes.c_void_p * n)(*src), (ll * (3 * n))(*sstr),
        (ll * (3 * n))(*sizes), (ll * n)(*runs), (ctypes.c_int * n)(*ndst),
        (ctypes.c_int * n)(*vec),
        (ctypes.c_void_p * len(dsts))(*[d for d, _ in dsts]),
        (ll * (3 * len(dsts)))(*[x for _, b in dsts for x in b]),
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")
    kbuild.count(kernel, route)
    _rs.record("launch")


def copy_maxp() -> int:
    """The most copies one copy launch takes: 64 where the kernels were
    built by a toolkit that takes kernel parameters above 4 KB (CUDA 12.1),
    else ``MAXP`` (``collectives.cu`` ``COPY_MAXP``)."""
    return _fn("da_copy_maxp")()


def _copy_on_card(copies, dev: torch.device, kernel: str,
                  route: str | None = None) -> None:
    for launch in copy_launches(copies, copy_maxp()):
        _copy_launch(launch, dev, kernel, route)


class _Order:
    """Cross-card ordering of launches.  A launch that reads or writes
    another card's tensors first waits for the events that card's stream
    recorded, and that card's stream later waits for the launch's event,
    so neither side frees or rewrites the memory while the other still
    uses it.  Nothing to do when every rank is on one card (one stream
    orders everything)."""

    def __init__(self, devices):
        devs = sorted(set(devices), key=lambda d: d.index)
        self.multi = len(devs) > 1
        if self.multi:
            for a in devs:
                for b in devs:
                    kbuild.enable_peer_access(a.index, b.index)

    def mark(self, dev: torch.device):
        """An event recorded on ``dev``'s current stream (None on one
        card)."""
        if not self.multi:
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        return ev

    def wait(self, dev: torch.device, events) -> None:
        """``dev``'s current stream waits for ``events``."""
        if self.multi:
            s = torch.cuda.current_stream(dev)
            for ev in events:
                s.wait_event(ev)


def _pull(devs, shapes, dtype, fill) -> list:
    """An output per rank of ``shapes`` (None: no output for that rank),
    filled card by card by ``fill(dev, [(q, out), ...])`` with that card's
    destination ranks, all free to run at once: each card's launches wait
    for every source card's stream, and every card's stream waits for all
    the launches before it goes on."""
    order = _Order(devs)
    ready = [order.mark(d) for d in devs]
    outs = [None if sh is None else torch.empty(sh, dtype=dtype, device=d)
            for d, sh in zip(devs, shapes)]
    cards: dict = {}
    for q, dev in enumerate(devs):
        if outs[q] is not None:
            cards.setdefault(dev, []).append((q, outs[q]))
    done = []
    for dev, dests in cards.items():
        order.wait(dev, ready)
        fill(dev, dests)
        done.append(order.mark(dev))
    for dev in devs:
        order.wait(dev, done)
    return outs


# ---------------------------------------------------------------------------
# all-gather (K10) and all-to-all (K11)
# ---------------------------------------------------------------------------


def ring_all_gather(blocks: Sequence[torch.Tensor],
                    dim: int = 0) -> list[torch.Tensor]:
    """Every rank gets the blocks concatenated along ``dim``, on its own
    device: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors.  In a job of several controller processes (another
    process's blocks are ``meta`` placeholders) it is ``pgather``'s
    cross-process form: one exchange, a copy launch a process on the card
    that reads the peers' blocks through CUDA IPC (``process_regions``,
    counted as ``all_gather`` on the ``cross_process_region`` route), the
    gloo route off it; another process's outputs are placeholders."""
    blocks = list(blocks)
    if not blocks:  # dalint: disable=DAL010 — a rank list has one entry a rank on every process (another process's ranks are placeholders)
        return []
    _record_dispatch("ring_all_gather", blocks)
    if multihost.in_job():
        # one exchange: a copy launch a process on the card (counted as
        # all_gather on the cross_process_region route), gloo off it
        return pgather(blocks, dim)
    if not _on_cuda(blocks):
        return all_gather_plain(blocks, dim)
    ref = blocks[0]
    dim = dim % ref.ndim
    for b in blocks:
        if b.dtype != ref.dtype or b.ndim != ref.ndim or any(
                b.shape[d] != ref.shape[d] for d in range(ref.ndim)
                if d != dim):
            raise ValueError("all-gather blocks must agree in dtype and in "
                             f"every dim but {dim}")
    _check_contiguous(blocks, "all-gather")
    sizes = [b.shape[dim] for b in blocks]
    offs = [sum(sizes[:s]) for s in range(len(blocks))]
    shape = list(ref.shape)
    shape[dim] = sum(sizes)
    def fill(dev, dests):
        # every output has one layout: a source's box is the same for all,
        # and its offset there is o rows of ``dim``
        out0 = dests[0][1]
        step = out0.stride(dim) * ref.element_size()
        geo = [(b.data_ptr(), o * step, _box(b, out0.narrow(dim, o, n)))
               for b, o, n in zip(blocks, offs, sizes) if b.numel()]
        _copy_on_card([(q, src, out.data_ptr() + off, box)
                       for q, out in dests for src, off, box in geo],
                      dev, "all_gather")

    return _pull([b.device for b in blocks], [shape] * len(blocks),
                 ref.dtype, fill)


def ring_all_to_all(blocks: Sequence[torch.Tensor], split_dim: int,
                    concat_dim: int) -> list[torch.Tensor]:
    """Rank ``q`` gets piece ``q`` of every rank's block (split along
    ``split_dim``), concatenated along ``concat_dim`` in rank order: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors.  In a
    job of several controller processes it is ``pall_to_all``'s
    cross-process form: one exchange, a copy launch a process on the card
    (counted as ``all_to_all`` on the ``cross_process_region`` route)."""
    blocks = list(blocks)
    p = len(blocks)
    if not blocks:  # dalint: disable=DAL010 — a rank list has one entry a rank on every process (another process's ranks are placeholders)
        return []
    _record_dispatch("ring_all_to_all", blocks)
    if multihost.in_job() or not _on_cuda(blocks):
        return all_to_all_plain(blocks, split_dim, concat_dim)
    ref = blocks[0]
    split_dim, concat_dim = split_dim % ref.ndim, concat_dim % ref.ndim
    if any(b.shape != ref.shape or b.dtype != ref.dtype for b in blocks):
        raise ValueError("all-to-all blocks must agree in shape and dtype")
    if ref.shape[split_dim] % p:
        raise ValueError(f"split extent {ref.shape[split_dim]} is not "
                         f"divisible by the {p} ranks")
    _check_contiguous(blocks, "all-to-all")
    sblk = ref.shape[split_dim] // p
    shape = list(ref.shape)
    shape[split_dim] = sblk
    cext = shape[concat_dim]                 # a piece's extent there
    shape[concat_dim] = cext * p
    isz = ref.element_size()

    def fill(dev, dests):
        # every piece has one box: piece q of rank r's block to offset r
        # of output q
        out0 = dests[0][1]
        if not out0.numel():
            return
        box = _box(ref.narrow(split_dim, 0, sblk),
                   out0.narrow(concat_dim, 0, cext))
        sstep = ref.stride(split_dim) * sblk * isz
        dstep = out0.stride(concat_dim) * cext * isz
        _copy_on_card([(q, b.data_ptr() + q * sstep,
                        out.data_ptr() + r * dstep, box)
                       for q, out in dests for r, b in enumerate(blocks)],
                      dev, "all_to_all")

    return _pull([b.device for b in blocks], [shape] * len(blocks),
                 ref.dtype, fill)


def all_to_allv_plain(arrays, counts) -> list[list[torch.Tensor]]:
    """The plain version of ``ring_all_to_allv``: each rank's tensor split
    by its row of ``counts``, every piece moved with ``.to`` and the
    pieces for rank q concatenated in rank order."""
    p = len(counts)
    out = []
    for blocks in arrays:
        pieces = []
        for r, b in enumerate(blocks):
            sizes = [int(c) for c in counts[r]]
            pieces.append(b.narrow(0, 0, sum(sizes)).split(sizes))
        out.append([torch.cat([pieces[r][q].to(blocks[q].device)
                               for r in range(p)]) for q in range(p)])
    return out


def ring_all_to_allv(arrays, counts) -> list[list[torch.Tensor]]:
    """An all-to-all of exact-size pieces of 1-D rank tensors.  ``arrays``
    is a list of arrays, each the p ranks' tensors in ring order (keys and
    values, say, of different dtypes); ``counts[r][q]`` (host ints) is the
    number of elements rank r sends rank q, taken in order from the front
    of each of its tensors.  Rank q gets, for each array, every rank's
    piece concatenated in rank order, on its own device.  For CUDA tensors
    one copy launch a card moves every piece of every array (the K11 copy
    kernel, counted as ``all_to_all``; at most ``copy_maxp()`` pieces a
    launch),
    each read once and stored at its final offset; the plain version for
    CPU tensors.  In a job of several controller processes every process
    passes the whole ``counts`` (exchanged first) and fills its own
    ranks' outputs by one exchange, a copy launch a process on the card
    (``multihost.exchange``, counted as ``all_to_all`` on the
    ``cross_process_region`` route)."""
    arrays = [list(a) for a in arrays]
    flat = [b for a in arrays for b in a]
    if not flat:
        return []
    if multihost.in_job():
        return _all_to_allv_job(arrays, counts)
    if not _on_cuda(flat):
        return all_to_allv_plain(arrays, counts)
    p = len(counts)
    if any(len(a) != p for a in arrays) or any(b.ndim != 1 for b in flat):
        raise ValueError("all_to_allv takes p 1-D tensors an array")
    for a in arrays:
        for r, b in enumerate(a):
            if sum(int(c) for c in counts[r]) > b.shape[0]:
                raise ValueError(f"rank {r} sends more elements than its "
                                 "tensor holds")
    _check_contiguous(flat, "all-to-all")
    devs = [b.device for b in arrays[0]]
    order = _Order(devs)
    ready = [order.mark(d) for d in devs]
    soff = [[sum(int(c) for c in counts[r][:q]) for q in range(p)]
            for r in range(p)]
    doff = [[sum(int(counts[u][q]) for u in range(r)) for q in range(p)]
            for r in range(p)]
    outs = [[torch.empty(sum(int(counts[r][q]) for r in range(p)),
                         dtype=a[q].dtype, device=devs[q])
             for q in range(p)] for a in arrays]
    cards: dict = {}
    for q, dev in enumerate(devs):
        cards.setdefault(dev, []).append(q)
    done = []
    for dev, dests in cards.items():
        order.wait(dev, ready)
        copies = []
        for a, out in zip(arrays, outs):
            for q in dests:
                for r in range(p):
                    n = int(counts[r][q])
                    if n:
                        copies.append(view_copy(
                            q, a[r].narrow(0, soff[r][q], n),
                            out[q].narrow(0, doff[r][q], n)))
        _copy_on_card(copies, dev, "all_to_all")
        done.append(order.mark(dev))
    for dev in devs:
        order.wait(dev, done)
    return outs


def _all_to_allv_job(arrays, counts) -> list[list[torch.Tensor]]:
    """``ring_all_to_allv`` in a job of several processes: every process
    knows every rank's counts (``counts`` is the whole matrix) and so
    every output's size; it fills its own ranks' outputs by one exchange
    (K11's copy launch a process on the card), the others are
    placeholders."""
    p = len(counts)
    outs, wants = [], []
    for a, blocks in enumerate(arrays):
        got = []
        for q, b in enumerate(blocks):
            o = torch.empty(sum(int(counts[r][q]) for r in range(p)),
                            dtype=b.dtype, device=b.device)
            if b.device.type != "meta":
                doff = 0
                for r in range(p):
                    n = int(counts[r][q])
                    soff = sum(int(c) for c in counts[r][:q])
                    wants.append((a, r, [(soff, soff + n)],
                                  o.narrow(0, doff, n)))
                    doff += n
            got.append(o)
        outs.append(got)
    multihost.exchange(arrays, wants, "all_to_all", op="all_to_allv")
    return outs


def _step_piece(kind, full, q, src_dim, dst_dim, pv, pu):
    """Per dim, the offset in member ``pu``'s block, the offset in member
    ``pv``'s output and the extent of the piece ``pu`` sends ``pv`` in one
    chain step, on the padded local shape ``full``."""
    soff, doff, ext = [0] * len(full), [0] * len(full), list(full)
    doff[src_dim] = pu * full[src_dim]
    if kind == "a2a":
        ext[dst_dim] = full[dst_dim] // q
        soff[dst_dim] = pv * ext[dst_dim]
    return soff, doff, ext


def _padded(b: torch.Tensor, full) -> torch.Tensor:
    if list(b.shape) == list(full):
        return b
    z = torch.zeros(full, dtype=b.dtype, device=b.device)
    z[tuple(slice(0, n) for n in b.shape)] = b
    return z


def chain_step_plain(kind: str, blocks, groups, src_dim: int, dst_dim,
                     full, windows) -> list:
    """The plain version of ``chain_step``: each block padded to ``full``
    with zeros, ``pall_to_all`` or ``pgather`` over each group, each
    rank's window kept."""
    out = [None] * len(blocks)
    for g in groups:  # dalint: disable=DAL012 — the groups come from the plan, computed from the layouts alone: the same on every process
        pad = [_padded(blocks[r], full) for r in g]
        res = (pall_to_all(pad, split_dim=dst_dim, concat_dim=src_dim)
               if kind == "a2a" else pgather(pad, src_dim))
        for r, t in zip(g, res):
            if windows[r] is not None:
                out[r] = t[tuple(slice(a, z) for a, z in
                                 windows[r])].contiguous()
    return out


def chain_step(kind: str, blocks: Sequence[torch.Tensor], groups,
               src_dim: int, dst_dim, full, windows) -> list:
    """One step of a reshard chain (``parallel/reshard.py``) over every
    group of ranks at once: ``kind`` ``"a2a"`` is an all-to-all within
    each group (split along ``dst_dim``, concatenated along ``src_dim``),
    ``"gather"`` an all-gather along ``src_dim``.  ``groups`` lists each
    group's indices into ``blocks`` in digit order.  Every block stands
    for a padded local block of shape ``full`` and holds a leading corner
    of it (the rest is pad); ``windows[r]`` is the ``(lo, hi)`` box per
    dim of rank r's padded output that it keeps, inside the part the
    sources fill, or None for no output.  Returns each rank's window, on
    its device: the copy kernel for CUDA tensors, one launch a card for
    all groups (counted as ``all_to_all`` or ``all_gather``), each piece
    read once and stored at its final offset; the plain version for CPU
    tensors."""
    blocks = list(blocks)
    if not _on_cuda(blocks):
        return chain_step_plain(kind, blocks, groups, src_dim, dst_dim,
                                full, windows)
    ref = blocks[0]
    if any(b.dtype != ref.dtype or b.ndim != len(full) for b in blocks):
        raise ValueError("chain step blocks must agree in dtype and rank")
    if kind not in ("a2a", "gather"):
        raise ValueError(f"unknown chain step {kind!r}")
    group_of = {r: g for g in groups for r in g}
    q = len(groups[0])

    def fill(dev, dests):
        copies = []
        for v, out in dests:
            g, win = group_of[v], windows[v]
            for pu, u in enumerate(g):
                soff, doff, ext = _step_piece(kind, full, q, src_dim,
                                              dst_dim, g.index(v), pu)
                sv, dv = blocks[u], out
                for d in range(len(full)):
                    have = min(ext[d], max(0, sv.shape[d] - soff[d]))
                    lo = max(doff[d], win[d][0])
                    hi = min(doff[d] + have, win[d][1])
                    if hi <= lo:
                        break
                    sv = sv.narrow(d, soff[d] + lo - doff[d], hi - lo)
                    dv = dv.narrow(d, lo - win[d][0], hi - lo)
                else:
                    copies.append(view_copy(v, sv, dv))
        _copy_on_card(copies, dev,
                      "all_to_all" if kind == "a2a" else "all_gather")

    return _pull([b.device for b in blocks],
                 [None if w is None else tuple(z - a for a, z in w)
                  for w in windows], ref.dtype, fill)


# ---------------------------------------------------------------------------
# reduce-scatter (K12)
# ---------------------------------------------------------------------------


def ring_reduce_scatter(blocks: Sequence[torch.Tensor],
                        dim: int = 0) -> list[torch.Tensor]:
    """Rank ``d`` gets the sum of piece ``d`` of every rank's block (split
    along ``dim``), on its own device, summed in the TPU ring's arrival
    order: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors.  In a job of several controller processes (another
    process's blocks are ``meta`` placeholders) each process fills its
    own ranks' outputs in the same order, so a job's sums are bit-equal
    to one process's: on the card by one launch a rank whose pointer
    array reads the peer processes' pieces through CUDA IPC
    (``_reduce_scatter_job``, the ``cross_process`` route) or, where the
    job spans hosts or a peer computes on the CPU, from copies of them
    brought over the job's exchange (``_reduce_scatter_fetched``, the
    ``cross_process_fetched`` route); off the card over gloo
    (``psum_scatter``'s job form).  A process that holds no rank follows
    its peers."""
    blocks = list(blocks)
    p = len(blocks)
    if not blocks:  # dalint: disable=DAL010 — a rank list has one entry a rank on every process (another process's ranks are placeholders)
        return []
    ref = blocks[0]
    dim = dim % ref.ndim
    if any(b.shape != ref.shape or b.dtype != ref.dtype for b in blocks):
        raise ValueError("reduce-scatter blocks must agree in shape and dtype")
    if ref.shape[dim] % p:
        raise ValueError(f"scatter extent {ref.shape[dim]} is not divisible "
                         f"by the {p} ranks")
    _record_dispatch("ring_reduce_scatter", blocks)
    job = multihost.in_job()
    held = [b for b in blocks if b.device.type != "meta"] if job else blocks
    if not (_on_cuda(held) if held else multihost._kernel_route()):  # dalint: disable=DAL010 — both arms make one job exchange a call (psum_scatter's, or the card's peer_call / fetched exchange); a job's processes compute on the card or on the CPU alike
        return psum_scatter(blocks, dim) if job else \
            reduce_scatter_plain(blocks, dim)
    if ref.dtype not in _RING_DTYPES:
        raise TypeError(f"the reduce-scatter kernel takes float32 or "
                        f"bfloat16, got {ref.dtype}")
    if p > MAXP:
        raise ValueError(f"the reduce-scatter kernel takes at most {MAXP} "
                         f"ranks, got {p}")
    _check_contiguous(held, "reduce-scatter")
    oblk = ref.shape[dim] // p
    shape = list(ref.shape)
    shape[dim] = oblk
    if job:
        if multihost._kernel_route():
            return _reduce_scatter_job(blocks, dim, oblk, shape)
        return _reduce_scatter_fetched(blocks, dim, oblk, shape)

    def fill(dev, dests):
        for d, out in dests:
            _reduce_launch(d, blocks, dim, oblk, out,
                           [blocks[(d + k) % p].narrow(
                               dim, d * oblk, oblk).data_ptr()
                            for k in range(1, p + 1)], dev)

    return _pull([b.device for b in blocks], [shape] * len(blocks),
                 ref.dtype, fill)


def _reduce_launch(d: int, blocks, dim: int, oblk: int, out, ptrs, dev,
                   route: str | None = None) -> None:
    """One ``da_reduce_pieces`` launch on ``dev``: rank ``d``'s output,
    the fold of the pieces at ``ptrs`` (piece ``d`` of ranks d+1, d+2,
    ..., d+p mod p, in that order), every piece with the geometry of
    piece ``d`` of a contiguous block of ``blocks[d]``'s shape."""
    if out.numel() == 0:
        return
    p, ref = len(blocks), blocks[d]
    isz = ref.element_size()
    sizes, sstr, _, run = _box(_piece(ref, dim, oblk, d), out)
    rc = _fn("da_reduce_pieces")(
        p, (ctypes.c_void_p * p)(*ptrs), (ctypes.c_longlong * 3)(*sizes),
        (ctypes.c_longlong * 3)(*[x // isz for x in sstr]), run // isz,
        out.data_ptr(), int(ref.dtype == torch.bfloat16), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"reduce-scatter kernel launch failed: "
                           f"CUDA error {rc}")
    kbuild.count("reduce_scatter", route)
    _rs.record("launch")


def _piece(ref: torch.Tensor, dim: int, oblk: int, d: int) -> torch.Tensor:
    """Piece ``d`` of a contiguous block of ``ref``'s shape, as a ``meta``
    view: its sizes, strides and offset in the block."""
    return torch.empty(ref.shape, dtype=ref.dtype, device="meta").narrow(
        dim, d * oblk, oblk)


def _reduce_scatter_job(blocks, dim: int, oblk: int, shape) -> list:
    """``ring_reduce_scatter`` on the card in a job of several processes
    on one host: one K12 launch for each of this process's ranks, its
    pointer array holding a peer process's piece at the mapping of that
    block's allocation plus the piece's offset, under ``peer_call``'s
    rules (each exporter's blocks stay alive until every peer has read
    them).  Another process's outputs are placeholders."""
    p = len(blocks)
    mine = [r for r, b in enumerate(blocks) if b.device.type != "meta"]
    outs = [torch.empty(shape, dtype=b.dtype, device=b.device)
            for b in blocks]
    with peer_call([blocks],
                   lambda obj: multihost._all_gather_json("reduce_scatter",
                                                          obj),
                   lambda: multihost.sync_hosts("reduce_scatter"),
                   {blocks[r].device for r in mine}) as (every, mapped):
        theirs = {key: h for m in every for key, h in m.items()}
        for d in mine:
            if not outs[d].numel():
                continue
            dev = blocks[d].device
            # piece d's byte offset in a contiguous block (a peer's block
            # is contiguous: it checked its own)
            at = _piece(blocks[d], dim, oblk, d).storage_offset() * \
                blocks[d].element_size()
            ptrs = []
            for k in range(1, p + 1):
                s = (d + k) % p
                if s in mine:
                    ptrs.append(blocks[s].data_ptr() + at)
                    continue
                h, off, _ = theirs[f"0/{s}"]
                ptrs.append(mapped.base(bytes.fromhex(h), dev) + int(off)
                            + at)
            _reduce_launch(d, blocks, dim, oblk, outs[d], ptrs, dev,
                           "cross_process")
    return outs


def _reduce_scatter_fetched(blocks, dim: int, oblk: int, shape) -> list:
    """``ring_reduce_scatter`` on the card in a job whose peer blocks
    cannot be mapped (it spans hosts, or a peer process computes on the
    CPU): the pieces of this process's ranks that other processes hold
    come over the job's exchange (``multihost.exchange``: one call, as
    ``psum_scatter``'s on a process off the card), each into a buffer of
    the piece's geometry in a whole block on the rank's card, then one
    K12 launch a rank folds them with its own in the arrival order
    (d + k) % p, counted on the ``cross_process_fetched`` route.  Another
    process's outputs are placeholders."""
    p = len(blocks)
    mine = [r for r, b in enumerate(blocks) if b.device.type != "meta"]
    outs = [torch.empty(shape, dtype=b.dtype, device=b.device)
            for b in blocks]
    bufs, wants = {}, []
    for d in mine:
        piece = _piece(blocks[d], dim, oblk, d)
        box = [(0, n) for n in blocks[d].shape]
        box[dim] = (d * oblk, (d + 1) * oblk)
        for s in range(p):
            if s not in mine:
                bufs[s, d] = torch.empty_strided(
                    piece.shape, piece.stride(), dtype=piece.dtype,
                    device=blocks[d].device)
                wants.append((0, s, box, bufs[s, d]))
    multihost.exchange([blocks], wants, "all_to_all", op="all_to_all")
    for d in mine:
        ptrs = [blocks[s].narrow(dim, d * oblk, oblk).data_ptr()
                if s in mine else bufs[s, d].data_ptr()
                for s in ((d + k) % p for k in range(1, p + 1))]
        _reduce_launch(d, blocks, dim, oblk, outs[d], ptrs,
                       blocks[d].device, "cross_process_fetched")
    return outs


# ---------------------------------------------------------------------------
# the ring GEMMs (K13, K14, K15)
# ---------------------------------------------------------------------------


def _ring_gemm_operands(what: str, x_blocks, w_blocks):
    """Common checks of a ring GEMM's rank lists: p > 0 blocks of each, one
    2-D shape per operand; returns ``(x_blocks, w_blocks, on_cuda)``.  In a
    job of several controller processes another process's blocks are
    ``meta`` placeholders: ``on_cuda`` follows this process's blocks, and a
    process that holds none follows its peers (the kernels where the job
    runs on CUDA devices of one host)."""
    x_blocks, w_blocks = list(x_blocks), list(w_blocks)
    p = len(x_blocks)
    if p == 0 or len(w_blocks) != p:
        raise ValueError(f"{what}: {len(x_blocks)} x blocks for "
                         f"{len(w_blocks)} w blocks; need one each per rank")
    x0, w0 = x_blocks[0], w_blocks[0]
    if x0.ndim != 2 or w0.ndim != 2 or any(
            x.shape != x0.shape for x in x_blocks) or any(
            w.shape != w0.shape for w in w_blocks):
        raise ValueError(f"{what} needs one 2-D shape per operand, got "
                         f"{tuple(x0.shape)} and {tuple(w0.shape)} blocks "
                         "and others")
    held = [t for t in x_blocks + w_blocks if t.device.type != "meta"]
    if not held and multihost.in_job():
        return x_blocks, w_blocks, multihost._kernel_route()
    return x_blocks, w_blocks, _on_cuda(held)


def _check_kernel_operands(what: str, x_blocks, w_blocks):
    """The kernels' own checks: one float32 or bfloat16 dtype, rank r's
    operands on one device, contiguous."""
    dtype = x_blocks[0].dtype
    if dtype not in _RING_DTYPES or any(
            t.dtype != dtype for t in x_blocks + w_blocks):
        raise TypeError(f"the {what} kernel takes float32 or bfloat16, one "
                        "dtype for both operands")
    if any(x.device != w.device for x, w in zip(x_blocks, w_blocks)):
        raise ValueError(f"rank r's {what} operands must share a device")
    _check_contiguous(x_blocks + w_blocks, what)


def _launched(rc: int, what: str, kernel: str,
              route: str | None = None) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed"
                           f"{f' ({route} route)' if route else ''}: CUDA "
                           f"error {rc}")
    kbuild.count(kernel, route)
    _rs.record("launch")


def ring_gemm_route(dtype: torch.dtype, n: int, k: int, ptrs,
                    lda: int | None = None) -> str:
    """The kernel route of a ring GEMM (K13, K14, K15) whose steps multiply
    (m, k) @ (k, n) with A's rows ``lda`` elements apart (``k`` by default)
    and whose TMA operands lie at the device addresses ``ptrs`` (every
    step's A, B and output, K14's A at each column offset, K15's x row
    blocks, and the forward or receive slots): ``"wgmma"`` when TMA can read
    and write them all
    (bf16, k > 0 and k, n and lda multiples of 8 so every row stride is a
    multiple of 16 bytes, 16-byte aligned addresses), ``"mma"`` for any
    other bf16 operands, ``"f32"`` for float32."""
    if dtype == torch.float32:
        return "f32"
    if dtype != torch.bfloat16:
        raise TypeError(f"the ring GEMM kernels take float32 or bfloat16, "
                        f"got {dtype}")
    lda = k if lda is None else lda
    if k > 0 and k % 8 == 0 and n % 8 == 0 and lda % 8 == 0 and all(
            p % 16 == 0 for p in ptrs):
        return "wgmma"
    return "mma"


def ring_tile_n(m: int, n: int, sms: int) -> int:
    """The wgmma route's tile width for an (m, n) step output on a card of
    ``sms`` SMs: 128 x 128 tiles, or 128 x 64 where 128 x 128 tiles would
    leave half the SMs idle, as at K14's weight-gradient step (64 tiles).
    The kernel makes each as many stages deep as fit beside its output
    tile (6 and 8).  The device time of the 16 launches of a sequence-parallel call
    on an H100 80GB HBM3 at 700 W (chip_smoke.py --time-ring-gemms): K13
    0.182 ms on 128 x 128 tiles against 0.263 ms on 128 x 64; K14 0.222 ms
    on 128 x 64 tiles against 0.303 ms on 128 x 128."""
    return 64 if -(-m // 128) * -(-n // 128) <= sms // 2 else 128


def _step_routes(route: str, cards, to: int = -1) -> list[str]:
    """Each rank's route, where rank r's step writes a slot of rank
    ``r + to`` (the left neighbour's for K13 and K14, the right one's,
    ``to=1``, for K15) and ``cards[r]`` names rank r's card (its device in
    one process): on another card the wgmma route takes
    ``wgmma_peer``."""
    p = len(cards)
    return [("wgmma_peer" if route == "wgmma" and cards[(r + to) % p] != c
             else route) for r, c in enumerate(cards)]


def _mm_rs_route(x_blocks, w_blocks, bufs, outs, p: int | None = None):
    """K15's route, by ``ring_gemm_route`` over every TMA address of the
    call: each step's x row block (rank r's row block d lies d m_loc k_loc
    elements past x_r), every w, both receive slots of every rank's (2,
    m_loc, n) buffer, and every (m_loc, n) output, over a ring of ``p``
    ranks (default: one block a rank; in a job the lists hold this
    process's ranks' alone).  Returns ``(route, rows)`` with ``rows[i][d]``
    the address of ``x_blocks[i]``'s row block d."""
    p = len(x_blocks) if p is None else p
    (m, k_loc), n = x_blocks[0].shape, w_blocks[0].shape[1]
    m_loc, isz = m // p, x_blocks[0].element_size()
    rows = [[x.data_ptr() + d * m_loc * k_loc * isz for d in range(p)]
            for x in x_blocks]
    route = ring_gemm_route(
        x_blocks[0].dtype, n, k_loc, [a for r in rows for a in r]
        + [w.data_ptr() for w in w_blocks]
        + [b.data_ptr() + q * m_loc * n * isz for b in bufs for q in (0, 1)]
        + [o.data_ptr() for o in outs])
    return route, rows


def _card(dev: torch.device) -> str:
    """The identity of ``dev``'s card across the processes of a host."""
    props = torch.cuda.get_device_properties(dev)
    return str(getattr(props, "uuid", dev.index))


class _Ring:
    """The plumbing of one ring GEMM call (K13, K14, K15) over the ranks on
    ``devs``: each rank's two-slot buffer of ``shape`` (``(2, rows,
    cols)``), the addresses of the slots, the step order and the route.
    Rank r's step writes a slot of rank ``r + to`` (``to`` -1, the left
    neighbour's, for K13 and K14; +1, the right one's, for K15).

    In one process every rank takes its steps here; a launch waits for
    its neighbours' previous steps (stream order on one card, ``_Order``'s
    events across cards).  In a job of several controller processes
    (another process's ranks are ``meta`` devices) only this process's
    ranks have buffers and take steps.  The call is a ``peer_call``:
    each process publishes the CUDA IPC handles of its buffers once a
    call (``agree``), and a step whose slot lies in another process's
    buffer writes it through the mapping of that allocation (a
    cross-process forward, counted as
    ``route_counts()[kernel + "_forward"]["cross_process"]``).  The steps
    are ordered across processes by a stream sync and a store barrier
    after each (``multihost.sync_hosts``): no rank reads a slot before the
    step that writes it has finished, nor overwrites one a neighbour
    still reads.  The mappings close after the last step and before the
    call's closing barrier."""

    def __init__(self, kernel: str, devs, shape, dtype, to: int):
        self.kernel, self.devs, self.to = kernel, list(devs), to
        self.job = multihost.in_job()
        self.mine = [r for r, d in enumerate(self.devs) if d.type != "meta"]
        p = len(self.devs)
        self.bufs = {r: torch.empty(shape, dtype=dtype, device=self.devs[r])
                     for r in self.mine} if p > 1 else {}
        self.nbytes = shape[1] * shape[2] * dtype.itemsize    # a slot
        self.peer: dict[str, list] = {}
        self.mapped: _Mapped | None = None
        self.call = contextlib.ExitStack()    # the job's ``peer_call``

    def own_slots(self) -> list[int]:
        """Both slots' addresses of every buffer this process holds."""
        return [b.data_ptr() + s * self.nbytes for b in self.bufs.values()
                for s in (0, 1)]

    def slot(self, r: int, s: int, writer: int) -> int:
        """The address of rank r's slot s, as rank ``writer``'s step sees
        it."""
        if r in self.bufs:
            return self.bufs[r].data_ptr() + s * self.nbytes
        hd, off, _ = self.peer[f"0/{r}"]
        return self.mapped.base(bytes.fromhex(hd), self.devs[writer]) + \
            int(off) + s * self.nbytes

    def forwarded(self, r: int) -> None:
        """Count a launch that wrote a slot of rank r: a cross-process
        forward when another process holds r."""
        if r not in self.bufs:
            kbuild.count_route(self.kernel + "_forward", "cross_process")

    def agree(self, route: str) -> dict[int, str]:
        """Each of this process's ranks' route from ``route``, the route
        its own operands allow: in a job the least of every process's
        (``kbuild.ROUTES`` order, so one that TMA cannot read anywhere
        takes ``mma`` everywhere), published with the buffers' handles as
        the call's ``peer_call`` opens; on the wgmma route a rank whose
        step writes a slot on another card takes ``wgmma_peer``
        (``_step_routes``)."""
        cards = self.devs
        if self.job:
            meta = torch.empty(0, device="meta")
            every, self.mapped = self.call.enter_context(peer_call(
                [[self.bufs.get(r, meta) for r in range(len(self.devs))]],
                lambda obj: multihost._all_gather_json("ring_gemm", obj),
                lambda: multihost.sync_hosts("ring_gemm"),
                {self.devs[r] for r in self.mine},
                {"route": route, "cards": {str(r): _card(self.devs[r])
                                           for r in self.mine}}))
            route = min((e["route"] for e in every),
                        key=kbuild.ROUTES.index)
            self.peer = {k: v for e in every for k, v in e.items()
                         if "/" in k}
            card = {int(r): c for e in every for r, c in e["cards"].items()}
            cards = [card[r] for r in range(len(self.devs))]
        routes = _step_routes(route, cards, self.to)
        return {r: routes[r] for r in self.mine}

    def steps(self):
        """``(t, r)`` for every step t of the ring and every rank r this
        process holds, in launch order; the caller launches rank r's step
        t in the loop's body."""
        p = len(self.devs)
        if not self.job:
            order = _Order(self.devs)
            done = [order.mark(d) for d in self.devs]   # buffers allocated
            for t in range(p):
                prev, done = done, []
                for r, dev in enumerate(self.devs):
                    # the neighbours' previous steps, which wrote the slot
                    # this step reads and read the one it writes, are done
                    order.wait(dev, [prev[(r - 1) % p], prev[(r + 1) % p]])
                    yield t, r
                    done.append(order.mark(dev))
            return
        devs = {self.devs[r] for r in self.mine}
        with self.call:
            for t in range(p):
                for r in self.mine:
                    yield t, r
                for dev in devs:
                    torch.cuda.synchronize(dev)
                    _rs.record("sync")
                if t < p - 1:
                    multihost.sync_hosts("ring_gemm_step")

    def streams(self) -> dict:
        return {self.devs[r]: torch.cuda.current_stream(
            self.devs[r]).cuda_stream for r in self.mine}

    def tile_n(self, m: int, n: int) -> int:
        return ring_tile_n(m, n, kbuild.sm_count(self.devs[self.mine[0]])) \
            if self.mine else 128


def ring_allgather_matmul(x_blocks: Sequence[torch.Tensor],
                          w_blocks: Sequence[torch.Tensor]
                          ) -> list[torch.Tensor]:
    """``all_gather(x) @ w_r`` for every rank r, x's row chunks travelling
    the ring: the CUDA kernel (K13) for CUDA tensors, the plain version for
    CPU tensors.  ``x_r`` is (m_loc, k) and ``w_r`` (k, n); the result is
    (p m_loc, n).  In a job of several controller processes each process
    launches its own ranks' steps (``_Ring``) and another process's
    results are placeholders."""
    what = "ring all-gather GEMM"
    x_blocks, w_blocks, cuda = _ring_gemm_operands(what, x_blocks, w_blocks)
    _record_dispatch("ring_allgather_matmul", x_blocks)
    p = len(x_blocks)
    (m_loc, k), (kw, n) = x_blocks[0].shape, w_blocks[0].shape
    if k != kw:
        raise ValueError(f"{what}: x blocks ({m_loc}, {k}) do not contract "
                         f"with w blocks ({kw}, {n})")
    if not cuda:
        return allgather_matmul_plain(x_blocks, w_blocks)
    _check_kernel_operands(what, x_blocks, w_blocks)
    dtype = x_blocks[0].dtype
    isz = x_blocks[0].element_size()
    devs = [x.device for x in x_blocks]
    ring = _Ring("allgather_matmul", devs, (2, m_loc, k), dtype, -1)
    outs = [torch.empty((p * m_loc, n), dtype=dtype, device=d) for d in devs]
    xs = {r: x_blocks[r].data_ptr() for r in ring.mine}
    ws = {r: w_blocks[r].data_ptr() for r in ring.mine}
    routes = ring.agree(ring_gemm_route(
        dtype, n, k, [*xs.values(), *ws.values(), *ring.own_slots()]
        + [outs[r].data_ptr() + q * m_loc * n * isz for r in ring.mine
           for q in range(p)]))
    tile_n = ring.tile_n(m_loc, n)
    streams = ring.streams()
    step = _fn("da_ring_ag_mm_a_step")
    for t, r in ring.steps():
        dev = devs[r]
        chunk = xs[r] if t == 0 else ring.slot(r, t % 2, r)
        fwd = ring.slot((r - 1) % p, (t + 1) % 2, r) if t < p - 1 else None
        src = (r + t) % p
        rc = step(chunk, ws[r], outs[r].data_ptr() + src * m_loc * n * isz,
                  fwd, m_loc, n, k, kbuild.RING_ROUTES.index(routes[r]),
                  tile_n, dev.index, streams[dev])
        _launched(rc, what, "allgather_matmul", routes[r])
        if fwd is not None:
            ring.forwarded((r - 1) % p)
    return outs


def ring_allgather_matmul_rhs(a_blocks: Sequence[torch.Tensor],
                              b_blocks: Sequence[torch.Tensor]
                              ) -> list[torch.Tensor]:
    """``a_r @ all_gather(b)`` for every rank r, b's chunks travelling the
    ring: the CUDA kernel (K14) for CUDA tensors, the plain version for CPU
    tensors.  ``a_r`` is (m_loc, k) and ``b_r`` (k_loc, n), k = p k_loc.
    In a job of several controller processes each process launches its own
    ranks' steps (``_Ring``) and another process's results are
    placeholders."""
    what = "ring GEMM"
    a_blocks, b_blocks, cuda = _ring_gemm_operands(what, a_blocks, b_blocks)
    _record_dispatch("ring_allgather_matmul_rhs", b_blocks)
    p = len(b_blocks)
    (m, k), (k_loc, n) = a_blocks[0].shape, b_blocks[0].shape
    if k != p * k_loc:
        raise ValueError(f"ring GEMM shapes: a blocks {(m, k)}, b blocks "
                         f"{(k_loc, n)} over {p} ranks")
    if not cuda:
        return allgather_matmul_rhs_plain(a_blocks, b_blocks)
    _check_kernel_operands(what, a_blocks, b_blocks)
    dtype = a_blocks[0].dtype
    isz = a_blocks[0].element_size()
    devs = [a.device for a in a_blocks]
    ring = _Ring("allgather_matmul_rhs", devs, (2, k_loc, n), dtype, -1)
    outs = [torch.empty((m, n), dtype=dtype, device=d) for d in devs]
    as_ = {r: a_blocks[r].data_ptr() for r in ring.mine}
    bs = {r: b_blocks[r].data_ptr() for r in ring.mine}
    routes = ring.agree(ring_gemm_route(
        dtype, n, k_loc, [a + q * k_loc * isz for a in as_.values()
                          for q in range(p)]
        + [*bs.values(), *ring.own_slots()]
        + [outs[r].data_ptr() for r in ring.mine], lda=k))
    tile_n = ring.tile_n(m, n)
    streams = ring.streams()
    step = _fn("da_ring_ag_mm_step")
    for t, r in ring.steps():
        dev = devs[r]
        chunk = bs[r] if t == 0 else ring.slot(r, t % 2, r)
        fwd = ring.slot((r - 1) % p, (t + 1) % 2, r) if t < p - 1 else None
        rc = step(as_[r], chunk, outs[r].data_ptr(), fwd, m, n, k_loc, k,
                  ((r + t) % p) * k_loc, int(t == 0),
                  kbuild.RING_ROUTES.index(routes[r]), tile_n, dev.index,
                  streams[dev])
        _launched(rc, what, "allgather_matmul_rhs", routes[r])
        if fwd is not None:
            ring.forwarded((r - 1) % p)
    return outs


def ring_matmul_reducescatter(x_blocks: Sequence[torch.Tensor],
                              w_blocks: Sequence[torch.Tensor]
                              ) -> list[torch.Tensor]:
    """Row block ``r`` of ``sum_q x_q @ w_q`` for every rank r, the partials
    travelling the ring: the CUDA kernel (K15) for CUDA tensors, the plain
    version for CPU tensors.  ``x_r`` is (m, k_loc) with p dividing m and
    ``w_r`` (k_loc, n); the result is (m / p, n).  In a job of several
    controller processes each process launches its own ranks' steps
    (``_Ring``; a partial whose next rank is another process's is stored
    into that process's slot) and another process's results are
    placeholders."""
    what = "ring GEMM + reduce-scatter"
    x_blocks, w_blocks, cuda = _ring_gemm_operands(what, x_blocks, w_blocks)
    _record_dispatch("ring_matmul_reducescatter", x_blocks)
    p = len(x_blocks)
    (m, k_loc), (kw, n) = x_blocks[0].shape, w_blocks[0].shape
    if k_loc != kw:
        raise ValueError(f"{what}: x blocks ({m}, {k_loc}) do not contract "
                         f"with w blocks ({kw}, {n})")
    if m % p:
        raise ValueError(f"rows {m} must be divisible by the {p} ranks")
    if not cuda:
        return matmul_reducescatter_plain(x_blocks, w_blocks)
    _check_kernel_operands(what, x_blocks, w_blocks)
    dtype = x_blocks[0].dtype
    m_loc, isz = m // p, x_blocks[0].element_size()
    devs = [x.device for x in x_blocks]
    ring = _Ring("matmul_reducescatter", devs, (2, m_loc, n), dtype, 1)
    outs = [torch.empty((m_loc, n), dtype=dtype, device=d) for d in devs]
    route, xrows = _mm_rs_route(
        [x_blocks[r] for r in ring.mine], [w_blocks[r] for r in ring.mine],
        list(ring.bufs.values()), [outs[r] for r in ring.mine], p)
    routes = ring.agree(route)
    rows = dict(zip(ring.mine, xrows))
    ws = {r: w_blocks[r].data_ptr() for r in ring.mine}
    ops = {r: outs[r].data_ptr() for r in ring.mine}
    tile_n = ring.tile_n(m_loc, n)
    streams = ring.streams()
    step = _fn("da_ring_mm_rs_step")
    for t, r in ring.steps():
        dev = devs[r]
        recv = ring.slot(r, t % 2, r) if t else None
        dst = ops[r] if t == p - 1 else ring.slot((r + 1) % p, (t + 1) % 2,
                                                  r)
        rc = step(rows[r][(r - 1 - t) % p], ws[r], recv, dst, m_loc, n,
                  k_loc, kbuild.RING_ROUTES.index(routes[r]), tile_n,
                  dev.index, streams[dev])
        _launched(rc, what, "matmul_reducescatter", routes[r])
        if t < p - 1:
            ring.forwarded((r + 1) % p)
    return outs


# ---------------------------------------------------------------------------
# region copies across controller processes (K10's copy kernel over CUDA IPC)
# ---------------------------------------------------------------------------

# base addresses of the peer allocations mapped by the calls in progress
_open_bases: set[int] = set()


def ipc_handle(t: torch.Tensor) -> tuple[bytes, int]:
    """``(handle, offset)``: the CUDA IPC handle of the allocation that
    holds CUDA tensor ``t`` and ``t``'s byte offset in it."""
    size = _fn("da_ipc_handle_size")()
    h = ctypes.create_string_buffer(size)
    off = ctypes.c_longlong()
    rc = _fn("da_ipc_handle")(t.data_ptr(), h, ctypes.byref(off),
                              t.device.index)
    if rc != 0:
        raise RuntimeError(f"cannot export the allocation of a "
                           f"{tuple(t.shape)} tensor on {t.device} for "
                           f"CUDA IPC: error {rc}")
    return h.raw, off.value


def _ipc_open(handle: bytes, dev: torch.device) -> int:
    """Map a peer process's allocation on ``dev``: its base address."""
    p = ctypes.c_void_p()
    rc = _fn("da_ipc_open")(handle, dev.index, ctypes.byref(p))
    if rc != 0:
        raise RuntimeError(f"cudaIpcOpenMemHandle refused a peer process's "
                           f"allocation on {dev}: CUDA error {rc}")
    return p.value


def _ipc_close(base: int) -> None:
    rc = _fn("da_ipc_close")(base)
    if rc != 0:
        raise RuntimeError(f"cudaIpcCloseMemHandle failed: CUDA error {rc}")


class _Mapped:
    """The peer allocations that one call reads or writes: each mapped once
    a device (by handle) on the device named, ``dev`` by default, all
    unmapped by ``close``."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.bases: dict[tuple, int] = {}

    def base(self, handle: bytes, dev: torch.device | None = None) -> int:
        dev = self.dev if dev is None else dev
        b = self.bases.get((handle, dev))
        if b is None:
            b = self.bases[handle, dev] = _ipc_open(handle, dev)
            _open_bases.add(b)
            _rs.record("map")
        return b

    def close(self) -> None:
        _rs.record("unmap")
        while self.bases:
            _, b = self.bases.popitem()
            _open_bases.discard(b)
            _ipc_close(b)


@contextlib.contextmanager
def peer_call(arrays, all_gather_json: Callable, barrier: Callable, devs,
              extra: dict | None = None):
    """The protocol of one call whose launches read or write peer
    processes' tensors through CUDA IPC (the module docstring's rules):
    this process's tensors of ``arrays`` are written (a stream sync of
    each card of ``devs``) before their handles (``region_handles``) and
    the entries of ``extra`` are published through ``all_gather_json``;
    the body gets ``(every, mapped)``, each process's publication in
    process order and the ``_Mapped`` to map peer allocations with; when
    it ends its launches are finished (a sync) and the mappings closed
    before ``barrier()``, so that no process frees or rewrites a tensor
    before every peer has read it.  A body that raises closes the
    mappings and passes no barrier."""
    devs = list(devs)
    for dev in devs:
        torch.cuda.current_stream(dev).synchronize()
        _rs.record("sync")
    every = all_gather_json({**region_handles(arrays), **(extra or {})})
    mapped = _Mapped(devs[0] if devs else L.local_device())
    try:
        yield every, mapped
        for dev in devs:
            torch.cuda.current_stream(dev).synchronize()
            _rs.record("sync")
    finally:
        mapped.close()
    barrier()


def open_mappings() -> int:
    """The peer allocations this process has mapped now (0 between
    calls)."""
    return len(_open_bases)


def close_ipc() -> None:
    """Unmap every peer allocation still mapped (after a failed call)."""
    while _open_bases:
        _ipc_close(_open_bases.pop())


def _flat(ci: tuple, grid: tuple) -> int:
    return int(np.ravel_multi_index(ci, grid)) if grid else 0


def _is_list(src) -> bool:
    """A rank-list source (one tensor a rank, in ring order), not a
    DArray."""
    return isinstance(src, (list, tuple))


def _want(w) -> tuple:
    """A want as ``(source, rank, bounds, dst)``: ``(a, bounds, dst)`` is a
    box of DArray ``a`` (rank None); ``(a, k, bounds, dst)`` a box of
    rank ``k``'s tensor of rank list ``a``."""
    return (w[0], None, w[1], w[2]) if len(w) == 3 else tuple(w)


def _src_pieces(a: int, src, k, bounds) -> list:
    """``(key, rank, tensor, slices into it, slices into the box)`` of each
    piece of the box ``bounds``: a DArray's box cut at its chunks' cuts
    (``key`` ``"a/<cell's row-major index>"``, ``rank`` the cell's), or
    rank ``k``'s tensor of a rank list, one piece (``key`` ``"a/k"``,
    ``rank`` None: which process holds it is known from the exchange)."""
    if _is_list(src):
        return [(f"{a}/{k}", None, src[k],
                 tuple(slice(lo, hi) for lo, hi in bounds),
                 tuple(slice(None) for _ in bounds))]
    return [(f"{a}/{_flat(ci, src.grid)}", int(src.pids[ci]), src._parts[ci],
             s, box) for ci, s, box in L.box_pieces(src.cuts, bounds)]


def _local(rank, t: torch.Tensor) -> bool:
    """Whether this process holds a piece's tensor: a DArray cell's by its
    rank, a rank list's by its device (another process's is ``meta``)."""
    return L.is_local(rank) if rank is not None else t.device.type != "meta"


def _held(arrays):
    """``(key, tensor)`` of every chunk or rank-list tensor this process
    holds (a rank list's tensors on the ``meta`` device are other
    processes')."""
    for a, src in enumerate(arrays):
        if _is_list(src):
            for k, t in enumerate(src):
                if t.device.type != "meta":
                    yield f"{a}/{k}", t
            continue
        for ci in src.cells():
            if L.is_local(int(src.pids[ci])):
                yield f"{a}/{_flat(ci, src.grid)}", src._parts[ci]


def region_handles(arrays) -> dict:
    """This process's chunks of the DArrays and rank lists ``arrays`` as
    ``{"a/k": [IPC handle (hex), byte offset, strides]}`` (``a`` the
    source's position, ``k`` a cell's row-major index or a rank list's
    rank), for the peers to map.  The strides are the tensor's own, so a
    peer never relies on its placeholder's."""
    mine = {}
    for key, t in _held(arrays):
        if t.numel():
            h, off = ipc_handle(t)
            mine[key] = [h.hex(), off, list(t.stride())]
    return mine


def region_copies(arrays, wants, every: list, mapped) -> list:
    """The ``copy_launches`` copies of the region call's ``wants``
    (``_want``: a box of a DArray or of one rank's tensor of a rank list,
    and the tensor ``dst`` on this process's card it fills), each want
    cut at the source chunks' cuts: a tensor this process holds read
    through its own pointer, a peer's through ``mapped.base`` of its
    handle in ``every`` (``region_handles`` of each process) plus its
    offset and the piece's offset in it."""
    theirs = {key: h for m in every for key, h in m.items()}
    copies = []
    for w in wants:
        a, k, bounds, dst = _want(w)
        for key, rank, t, src, box in _src_pieces(a, arrays[a], k, bounds):
            out = dst[box]
            if not out.numel():
                continue
            if _local(rank, t):
                copies.append(view_copy(0, t[src], out))
                continue
            h, off, strides = theirs[key]
            view = torch.empty_strided(t.shape, strides, dtype=t.dtype,
                                       device="meta")[src]
            addr = mapped.base(bytes.fromhex(h)) + int(off) + \
                view.storage_offset() * view.element_size()
            copies.append((0, addr, out.data_ptr(), _box(view, out)))
    return copies


def process_regions(arrays, wants, all_gather_json: Callable,
                    barrier: Callable, kernel: str = "all_gather") -> None:
    """Fill this process's ``wants`` (``region_copies``) from the chunks of
    the process-spanning DArrays and rank lists ``arrays``, wherever they
    live, by one copy launch on this process's card (see the module
    docstring), counted as ``kernel`` (K10's ``all_gather``, or K11's
    ``all_to_all`` for the all-to-alls) on the ``cross_process_region``
    route.  Every process of the job calls it with the same ``arrays``,
    each with its own ``wants`` (possibly none).  ``all_gather_json(obj)``
    returns every process's ``obj`` in process order once all have
    published it; ``barrier()`` returns once every process has called
    it."""
    dev = L.local_device()
    with peer_call(arrays, all_gather_json, barrier, [dev]) as (every,
                                                               mapped):
        copies = region_copies(arrays, wants, every, mapped)
        if copies:
            _copy_on_card(copies, dev, kernel, "cross_process_region")


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)


def process_regions_plain(arrays, wants, group) -> None:
    """The plain version of ``process_regions``, over the gloo ``group``:
    every process's wants, and the rank-list tensors it holds, are
    all-gathered as metadata; each process sends each peer, in one
    message, the host bytes of the pieces of its own tensors that the
    peer wants (in the peer's want order), and receives one such message
    from each process that holds pieces of its own wants; pieces of its
    own tensors it copies directly."""
    import torch.distributed as dist
    me, n = dist.get_rank(group), dist.get_world_size(group)
    mine = [_want(w)[:3] for w in wants]
    held = [key for key, _ in _held(arrays)
            if _is_list(arrays[int(key.split("/")[0])])]
    every = [None] * n
    dist.all_gather_object(
        every, ([(a, k, [list(b) for b in bounds]) for a, k, bounds in mine],
                held), group=group)
    owner = {key: p for p, (_, keys) in enumerate(every) for key in keys}

    def pieces(ask, who):
        """``(want, piece, box in the want)`` of the pieces of ``ask``
        that process ``who`` holds, in want order."""
        for i, (a, k, bounds) in enumerate(ask):
            for key, rank, t, s, box in _src_pieces(a, arrays[a], k, bounds):
                p = owner.get(key) if rank is None else L.process_of(rank)
                if p == who:
                    yield i, t[s], box
    works, inbox, outbox = [], {}, []
    for p in range(n):
        if p == me:
            continue
        out = [_bytes(t) for _, t, _ in pieces(every[p][0], me)
               if t.numel()]
        if out:
            outbox.append(torch.cat(out))      # alive until its send ends
            works.append(dist.isend(outbox[-1], p, group=group))
        size = sum(t.numel() * t.element_size()
                   for _, t, _ in pieces(mine, p))
        if size:
            inbox[p] = torch.empty(size, dtype=torch.uint8)
            works.append(dist.irecv(inbox[p], p, group=group))
    for i, t, box in pieces(mine, me):
        dst = _want(wants[i])[3]
        dst[box] = t.to(dst.device)
    for w in works:
        w.wait()
    for p, buf in inbox.items():
        o = 0
        for i, t, box in pieces(mine, p):
            piece = _want(wants[i])[3][box]
            nb = t.numel() * t.element_size()
            if nb:
                piece.copy_(buf[o:o + nb].view(t.dtype).view(piece.shape))
            o += nb
