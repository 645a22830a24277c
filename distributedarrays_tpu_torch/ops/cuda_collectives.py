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

- ``ring_reduce_scatter(blocks, dim)``: rank ``d`` gets the sum of piece
  ``d`` of every rank's block split along ``dim``
  (``lax.psum_scatter(..., tiled=True)``), summed in the TPU ring's arrival
  order (``parallel.collectives.psum_scatter``).

  All four pull.  The all-gather, all-to-all and chain step make one
  launch per card
  (``copy_launches`` groups the copies: each source with every destination
  on the card that takes it, at most ``MAXP`` copies a launch), which
  copies every source's block or piece straight to its final offset in
  each destination output, reading the source once (pure data movement,
  bit-identical to the plain version).  The reduce-scatter makes one launch
  per destination rank, which reads piece ``d`` of every rank and writes
  their fold in the plain version's order, bit-identical to it too.  The
  JAX kernels' chunk depth (``chunks``, ``_chunk_fit``) and the
  reduce-scatter's VMEM gate (``_rs_vmem_bytes``) only bound the TPU's
  VMEM staging of pieces and travelling partials; nothing is staged here
  and no partial is stored, so there is no chunk argument and no gate.
  float32 or bfloat16 for the reduce-scatter.

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

Steps that depend on each other are ordered by stream order on one card and
by CUDA event waits across cards; no kernel waits on a flag set by another.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..parallel.collectives import pall_to_all, pgather, pshift, psum_scatter
from ..utils import kbuild

__all__ = ["ring_all_gather", "ring_all_to_all", "ring_reduce_scatter",
           "ring_allgather_matmul", "ring_allgather_matmul_rhs",
           "ring_matmul_reducescatter", "ring_gemm_route", "ring_tile_n",
           "copy_launches", "copy_width", "view_copy", "chain_step",
           "chain_step_plain", "ring_all_to_allv", "all_to_allv_plain",
           "all_gather_plain", "all_to_all_plain", "reduce_scatter_plain",
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
    "da_reduce_pieces": [ctypes.c_int] + [ctypes.c_void_p] * 3 +
    [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p],
    "da_ring_ag_mm_step": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 +
    [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "da_ring_ag_mm_a_step": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 +
    [ctypes.c_void_p],
    "da_ring_mm_rs_step": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 +
    [ctypes.c_void_p],
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
            if n != 1] or [(1, 1, 1)]
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


def _copy_launch(launch, dev: torch.device, kernel: str) -> None:
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
    kbuild.count(kernel)


def _copy_on_card(copies, dev: torch.device, kernel: str) -> None:
    for launch in copy_launches(copies):
        _copy_launch(launch, dev, kernel)


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
    tensors."""
    blocks = list(blocks)
    if not blocks:
        return []
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
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    blocks = list(blocks)
    p = len(blocks)
    if not blocks:
        return []
    if not _on_cuda(blocks):
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
    kernel, counted as ``all_to_all``; at most ``MAXP`` pieces a launch),
    each read once and stored at its final offset; the plain version for
    CPU tensors."""
    arrays = [list(a) for a in arrays]
    flat = [b for a in arrays for b in a]
    if not flat:
        return []
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
    for g in groups:
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
    tensors."""
    blocks = list(blocks)
    p = len(blocks)
    if not blocks:
        return []
    ref = blocks[0]
    dim = dim % ref.ndim
    if any(b.shape != ref.shape or b.dtype != ref.dtype for b in blocks):
        raise ValueError("reduce-scatter blocks must agree in shape and dtype")
    if ref.shape[dim] % p:
        raise ValueError(f"scatter extent {ref.shape[dim]} is not divisible "
                         f"by the {p} ranks")
    if not _on_cuda(blocks):
        return reduce_scatter_plain(blocks, dim)
    if ref.dtype not in _RING_DTYPES:
        raise TypeError(f"the reduce-scatter kernel takes float32 or "
                        f"bfloat16, got {ref.dtype}")
    if p > MAXP:
        raise ValueError(f"the reduce-scatter kernel takes at most {MAXP} "
                         f"ranks, got {p}")
    _check_contiguous(blocks, "reduce-scatter")
    oblk = ref.shape[dim] // p
    shape = list(ref.shape)
    shape[dim] = oblk
    isz = ref.element_size()

    def fill(dev, dests):
        for d, out in dests:
            srcs = [blocks[(d + k) % p].narrow(dim, d * oblk, oblk)
                    for k in range(1, p + 1)]
            if out.numel() == 0:
                continue
            sizes, sstr, _, run = _box(srcs[0], out)
            rc = _fn("da_reduce_pieces")(
                p, (ctypes.c_void_p * p)(*[s.data_ptr() for s in srcs]),
                (ctypes.c_longlong * 3)(*sizes),
                (ctypes.c_longlong * 3)(*[x // isz for x in sstr]),
                run // isz, out.data_ptr(), int(ref.dtype == torch.bfloat16),
                dev.index, torch.cuda.current_stream(dev).cuda_stream)
            if rc != 0:
                raise RuntimeError(f"reduce-scatter kernel launch failed: "
                                   f"CUDA error {rc}")
            kbuild.count("reduce_scatter")

    return _pull([b.device for b in blocks], [shape] * len(blocks),
                 ref.dtype, fill)


# ---------------------------------------------------------------------------
# the ring GEMMs (K13, K14, K15)
# ---------------------------------------------------------------------------


def _ring_gemm_operands(what: str, x_blocks, w_blocks):
    """Common checks of a ring GEMM's rank lists: p > 0 blocks of each, one
    2-D shape per operand; returns ``(x_blocks, w_blocks, on_cuda)``."""
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
    return x_blocks, w_blocks, _on_cuda(x_blocks + w_blocks)


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


def _step_routes(route: str, devs, to: int = -1) -> list[str]:
    """Each rank's route, where rank r's step writes a slot of rank
    ``r + to`` (the left neighbour's for K13 and K14, the right one's,
    ``to=1``, for K15): on another card the wgmma route takes
    ``wgmma_peer``."""
    p = len(devs)
    return [("wgmma_peer" if route == "wgmma" and devs[(r + to) % p] != dev
             else route) for r, dev in enumerate(devs)]


def ring_allgather_matmul(x_blocks: Sequence[torch.Tensor],
                          w_blocks: Sequence[torch.Tensor]
                          ) -> list[torch.Tensor]:
    """``all_gather(x) @ w_r`` for every rank r, x's row chunks travelling
    the ring: the CUDA kernel (K13) for CUDA tensors, the plain version for
    CPU tensors.  ``x_r`` is (m_loc, k) and ``w_r`` (k, n); the result is
    (p m_loc, n)."""
    what = "ring all-gather GEMM"
    x_blocks, w_blocks, cuda = _ring_gemm_operands(what, x_blocks, w_blocks)
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
    order = _Order(devs)
    outs = [torch.empty((p * m_loc, n), dtype=dtype, device=d) for d in devs]
    bufs = [torch.empty((2, m_loc, k), dtype=dtype, device=d) for d in devs] \
        if p > 1 else []
    slots = [(b.data_ptr(), b.data_ptr() + m_loc * k * isz) for b in bufs]
    xs, ws = [x.data_ptr() for x in x_blocks], [w.data_ptr() for w in w_blocks]
    route = ring_gemm_route(
        dtype, n, k, xs + ws + [q for s in slots for q in s]
        + [o.data_ptr() + q * m_loc * n * isz for o in outs for q in range(p)])
    routes = _step_routes(route, devs)
    codes = [kbuild.RING_ROUTES.index(r) for r in routes]
    tile_n = ring_tile_n(m_loc, n, kbuild.sm_count(devs[0]))
    streams = {d: torch.cuda.current_stream(d).cuda_stream for d in devs}
    done = [order.mark(d) for d in devs]     # buffers allocated
    step = _fn("da_ring_ag_mm_a_step")
    for t in range(p):
        prev, done = done, []
        for r, dev in enumerate(devs):
            left, right = (r - 1) % p, (r + 1) % p
            # the left neighbour finished with the slot written here, and
            # the right one finished writing this rank's resident slot
            order.wait(dev, [prev[left], prev[right]])
            chunk = xs[r] if t == 0 else slots[r][t % 2]
            fwd = slots[left][(t + 1) % 2] if t < p - 1 else None
            src = (r + t) % p
            rc = step(chunk, ws[r],
                      outs[r].data_ptr() + src * m_loc * n * isz, fwd, m_loc,
                      n, k, codes[r], tile_n, dev.index, streams[dev])
            _launched(rc, what, "allgather_matmul", routes[r])
            done.append(order.mark(dev))
    return outs


def ring_allgather_matmul_rhs(a_blocks: Sequence[torch.Tensor],
                              b_blocks: Sequence[torch.Tensor]
                              ) -> list[torch.Tensor]:
    """``a_r @ all_gather(b)`` for every rank r, b's chunks travelling the
    ring: the CUDA kernel (K14) for CUDA tensors, the plain version for CPU
    tensors.  ``a_r`` is (m_loc, k) and ``b_r`` (k_loc, n), k = p k_loc."""
    what = "ring GEMM"
    a_blocks, b_blocks, cuda = _ring_gemm_operands(what, a_blocks, b_blocks)
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
    order = _Order(devs)
    outs = [torch.empty((m, n), dtype=dtype, device=d) for d in devs]
    bufs = [torch.empty((2, k_loc, n), dtype=dtype, device=d) for d in devs]
    slots = [(b.data_ptr(), b.data_ptr() + k_loc * n * isz) for b in bufs]
    as_ = [a.data_ptr() for a in a_blocks]
    bs = [b.data_ptr() for b in b_blocks]
    route = ring_gemm_route(
        dtype, n, k_loc, [a + q * k_loc * isz for a in as_ for q in range(p)]
        + bs + [q for s in slots for q in s] + [o.data_ptr() for o in outs],
        lda=k)
    routes = _step_routes(route, devs)
    codes = [kbuild.RING_ROUTES.index(r) for r in routes]
    tile_n = ring_tile_n(m, n, kbuild.sm_count(devs[0]))
    streams = {d: torch.cuda.current_stream(d).cuda_stream for d in devs}
    done = [order.mark(d) for d in devs]     # buffers allocated
    step = _fn("da_ring_ag_mm_step")
    for t in range(p):
        prev, done = done, []
        for r, dev in enumerate(devs):
            left, right = (r - 1) % p, (r + 1) % p
            # the left neighbour finished with the slot written here, and
            # the right one finished writing this rank's resident slot
            order.wait(dev, [prev[left], prev[right]])
            chunk = bs[r] if t == 0 else slots[r][t % 2]
            fwd = slots[left][(t + 1) % 2] if t < p - 1 else None
            rc = step(as_[r], chunk, outs[r].data_ptr(), fwd, m, n, k_loc, k,
                      ((r + t) % p) * k_loc, int(t == 0), codes[r], tile_n,
                      dev.index, streams[dev])
            _launched(rc, what, "allgather_matmul_rhs", routes[r])
            done.append(order.mark(dev))
    return outs


def _mm_rs_route(x_blocks, w_blocks, bufs, outs):
    """K15's route, by ``ring_gemm_route`` over every TMA address of the
    call: each step's x row block (rank r's row block d lies d m_loc k_loc
    elements past x_r), every w, both receive slots of every rank's (2,
    m_loc, n) buffer, and every (m_loc, n) output.  Returns ``(route,
    rows)`` with ``rows[r][d]`` the address of rank r's row block d."""
    p = len(x_blocks)
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


def ring_matmul_reducescatter(x_blocks: Sequence[torch.Tensor],
                              w_blocks: Sequence[torch.Tensor]
                              ) -> list[torch.Tensor]:
    """Row block ``r`` of ``sum_q x_q @ w_q`` for every rank r, the partials
    travelling the ring: the CUDA kernel (K15) for CUDA tensors, the plain
    version for CPU tensors.  ``x_r`` is (m, k_loc) with p dividing m and
    ``w_r`` (k_loc, n); the result is (m / p, n)."""
    what = "ring GEMM + reduce-scatter"
    x_blocks, w_blocks, cuda = _ring_gemm_operands(what, x_blocks, w_blocks)
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
    m_loc = m // p
    devs = [x.device for x in x_blocks]
    order = _Order(devs)
    outs = [torch.empty((m_loc, n), dtype=dtype, device=d) for d in devs]
    bufs = [torch.empty((2, m_loc, n), dtype=dtype, device=d) for d in devs] \
        if p > 1 else []
    route, xrows = _mm_rs_route(x_blocks, w_blocks, bufs, outs)
    routes = _step_routes(route, devs, to=1)
    codes = [kbuild.RING_ROUTES.index(r) for r in routes]
    tile_n = ring_tile_n(m_loc, n, kbuild.sm_count(devs[0]))
    slot = m_loc * n * x_blocks[0].element_size()
    slots = [(b.data_ptr(), b.data_ptr() + slot) for b in bufs]
    ws, ops = [w.data_ptr() for w in w_blocks], [o.data_ptr() for o in outs]
    streams = {d: torch.cuda.current_stream(d).cuda_stream for d in devs}
    done = [order.mark(d) for d in devs]     # buffers allocated
    step = _fn("da_ring_mm_rs_step")
    for t in range(p):
        prev, done = done, []
        for r, dev in enumerate(devs):
            left, right = (r - 1) % p, (r + 1) % p
            # the left neighbour finished writing this rank's receive slot,
            # the right one finished reading the slot written here
            order.wait(dev, [prev[left], prev[right]])
            recv = slots[r][t % 2] if t else None
            dst = ops[r] if t == p - 1 else slots[right][(t + 1) % 2]
            rc = step(xrows[r][(r - 1 - t) % p], ws[r], recv, dst, m_loc, n,
                      k_loc, codes[r], tile_n, dev.index, streams[dev])
            _launched(rc, what, "matmul_reducescatter", routes[r])
            done.append(order.mark(dev))
    return outs
