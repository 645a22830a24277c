"""Flash attention, its FlashAttention-2 backward and one ring-attention
hop: the hand-written CUDA kernels (``csrc/attention.cu`` and
``csrc/attention_bwd.cu`` on ``csrc/attn_tile.cuh``) and their plain
versions.

PyTorch counterpart of ``distributedarrays_tpu/ops/pallas_attention.py``:

- ``flash_attention(q, k, v, causal, scale)``: exact attention over
  (S, H, D) tensors without the S x S score matrix (K5), differentiable:
  its backward recomputes P from the saved logsumexp in two passes, dq
  (K6) and dk/dv (K7), as the JAX ``custom_vjp`` does (``_flash_bwd``).
  ``flash_attention_lse`` also returns the per-row logsumexp (H, S) f32
  (not differentiable) and takes (S, B, H, D) views too (the batch folded
  into the heads, as the transformer folds it); for those the kernel's o
  comes back as an (S, B, H, D) view of a (B, S, H, D) tensor, so folding
  the batch back costs no copy.  ``FlashAttention`` is the
  ``torch.autograd.Function`` behind both.
- ``flash_attention_bwd(q, k, v, o, g, lse, causal, scale)``: that
  backward by itself: dd = rowsum(g * o) in f32 from the full-precision
  cotangent, do = g in q's type, then K6 and K7 with outputs in q's type.
- ``flash_attention_hop(q, k, v, m, l, acc, qoff, koff, causal, scale)``:
  one ring hop on (H, B, D) blocks with the online-softmax carry
  m, l (H, B) f32 and acc (H, B, D) f32 (K8).  The carry is updated in
  place, on both paths, and returned.
- ``flash_attention_hop_bwd(q, k, v, do, lse, dd, qoff, koff, causal,
  scale)``: one hop's f32 (dq, dk, dv) contributions from the final lse and
  dd (K6 and K7 at the global offsets).
- ``flash_carry_init``, ``flash_carry_finalize``, ``flash_block_size``.

For CPU tensors each wrapper takes its plain version; for CUDA tensors it
launches the kernel or raises, with no fallback.  ``flash_attention_plain``
has the semantics of the JAX package's dense rule ``_dense_attention_shd``
(f32 softmax); ``flash_attention_hop_plain`` computes the hop in the TPU
kernel's numerics over the whole block as one tile (products of the input
values with f32 sums, scale after the QK product, p rounded to v's type
before the PV product); ``flash_attention_bwd_plain`` computes the backward
in the TPU kernels' numerics (products of the input values with f32 sums,
p and dS rounded to the input type before their products).  Where the JAX
functions' results differ only by rounding order, these give the same
result.

What has no counterpart, and why: the TPU tiling knobs ``block_q``,
``block_k``, ``head_fold`` and ``interpret`` (the CUDA kernels' tiles are
fixed for the card: 64 query rows a block, 64 keys a shared-memory tile on
the bf16 tensor cores and 32 on the f32 pipes; there is no interpreter);
the lane-broadcast ``_LANE = 128`` layout of m, l, lse and dd (a TPU
block-shape rule; here they are (H, B) and (H, S)); and the autotune
lookups ``tuned_flash_config`` / ``tuned_hop_blocks_for``, which
only choose those knobs.

K5, K6, K7 and K8 launch on the route ``flash_attention_route`` picks from
the operands: ``"wgmma"`` (bf16 views that TMA can read: wgmma fed by TMA,
``csrc/attn_sm90.cuh`` and ``csrc/attn_bwd_sm90.cuh``; K8 on K5's loop with
its carry read and written, ``hop_groups`` consumer warpgroups a block),
``"mma"`` (other bf16: mma.sync) or ``"f32"`` (the SIMT loops); each launch
also counts under its route (``kbuild.route_counts()["flash_attention" |
"flash_attention_hop" | "flash_attention_bwd_dq" |
"flash_attention_bwd_dkv"]``).  The C entries refuse a wgmma route whose
operands TMA cannot read, and the wrapper raises: nothing falls back.

``ring_attn_step`` launches K9 (``da_ring_attn_step``), the fused ring
attention step that ``models/ring_attention.ring_attention_rdma`` drives,
on the route ``ring_attn_route`` picks: ``"wgmma"`` (bf16, head dim a
multiple of 8, 16-byte aligned q/k/v: wgmma fed by TMA, on K5's loop in
K9's numerics), ``"mma"`` (other bf16: mma.sync) or ``"f32"`` (the SIMT
loop).  Each step counts one ``ring_attention`` launch, and a step that
accumulates also counts under its route
(``kbuild.route_counts()["ring_attention"]``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import telemetry as _tm
from ..utils import kbuild
from . import ring_schedules as _rs

__all__ = ["flash_attention", "flash_attention_lse", "FlashAttention",
           "flash_attention_bwd", "flash_attention_hop",
           "flash_attention_hop_bwd", "flash_attention_plain",
           "flash_attention_lse_plain", "flash_attention_bwd_plain",
           "flash_attention_hop_plain", "flash_carry_init",
           "flash_carry_finalize", "flash_block_size", "ring_attn_step",
           "ring_attn_route", "flash_attention_route", "hop_groups",
           "MAX_HEAD_DIM"]

MAX_HEAD_DIM = 128            # the kernels' register tiles (attention.cu)
_DTYPES = (torch.float32, torch.bfloat16)


def flash_block_size(S: int, cap: int = 512) -> int:
    """Largest power-of-two divisor of ``S``, capped (the JAX package's
    always-valid flash block size)."""
    b = 1
    while b * 2 <= cap and S % (b * 2) == 0:
        b *= 2
    return b


def _scale(d: int, scale) -> float:
    return float(1.0 / math.sqrt(d) if scale is None else scale)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def flash_attention_lse_plain(q, k, v, causal: bool = False, scale=None):
    """Dense attention over (S, H, D) (or (S, B, H, D)) with f32 softmax:
    ``(o, lse)``, o in q's dtype and shape with the heads flattened to
    (S, H_all, D), lse (H_all, S) f32.  Rows that see no key give o = 0 and
    lse = 0, as the kernels do."""
    S, D = q.shape[0], q.shape[-1]
    sc = _scale(D, scale)
    qf, kf, vf = (x.reshape(x.shape[0], -1, D).float() for x in (q, k, v))
    s = torch.einsum("qhd,khd->hqk", qf * sc, kf)
    if causal:
        qi = torch.arange(S, device=q.device)[:, None]
        ki = torch.arange(k.shape[0], device=q.device)[None, :]
        s = torch.where((ki <= qi)[None], s, -math.inf)
    m = s.amax(-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - m_safe)
    lsum = p.sum(-1, keepdim=True)
    l_safe = torch.where(lsum == 0.0, 1.0, lsum)
    o = torch.einsum("hqk,khd->qhd", p / l_safe, vf)
    lse = (m_safe + torch.log(l_safe))[..., 0]
    return o.to(q.dtype), lse


def flash_attention_plain(q, k, v, causal: bool = False, scale=None):
    """The plain version of ``flash_attention`` (S, H, D) -> (S, H, D)."""
    return flash_attention_lse_plain(q, k, v, causal, scale)[0]


def flash_attention_hop_plain(q, k, v, m, l, acc, qoff, koff,
                              causal: bool = False, scale=None):
    """One hop in the TPU kernel's numerics with the whole block as one
    tile; returns new ``(m, l, acc)``."""
    H, B, D = q.shape
    sc = _scale(D, scale)
    s = torch.einsum("hqd,hkd->hqk", q.float(), k.float()) * sc
    if causal:
        qpos = int(qoff) + torch.arange(B, device=q.device)[:, None]
        kpos = int(koff) + torch.arange(k.shape[1], device=q.device)[None, :]
        s = torch.where((kpos <= qpos)[None], s, -math.inf)
    m_new = torch.maximum(m, s.amax(-1))
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isfinite(s), p, 0.0)
    alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
    l_new = l * alpha + p.sum(-1)
    acc_new = acc * alpha[..., None] + torch.einsum(
        "hqk,hkd->hqd", p.to(v.dtype).float(), v.float())
    return m_new, l_new, acc_new


def flash_attention_bwd_plain(q, k, v, do, lse, dd, qoff: int = 0,
                              koff: int = 0, causal: bool = False,
                              scale=None, out_dtype=None):
    """The FlashAttention-2 backward over (H, S, D) blocks in the TPU
    kernels' numerics, with the whole block as one tile: ``(dq, dk, dv)``
    in ``out_dtype`` (default q's).  lse and dd are (H, S) f32; ``qoff`` and
    ``koff`` are the global positions of the q and k blocks' first rows."""
    H, Sq, D = q.shape
    sc = _scale(D, scale)
    rnd = lambda x: x.to(q.dtype).float()     # round to the input type
    s = torch.einsum("hqd,hkd->hqk", q.float(), k.float()) * sc
    if causal:
        qpos = int(qoff) + torch.arange(Sq, device=q.device)[:, None]
        kpos = int(koff) + torch.arange(k.shape[1], device=q.device)[None, :]
        s = torch.where((kpos <= qpos)[None], s, -math.inf)
    p = torch.exp(s - lse[..., None])
    p = torch.where(torch.isfinite(s), p, 0.0)
    dp = torch.einsum("hqd,hkd->hqk", do.float(), v.float())
    ds = rnd(p * (dp - dd[..., None]) * sc)
    dq = torch.einsum("hqk,hkd->hqd", ds, k.float())
    dk = torch.einsum("hqk,hqd->hkd", ds, q.float())
    dv = torch.einsum("hqk,hqd->hkd", rnd(p), do.float())
    od = q.dtype if out_dtype is None else out_dtype
    return dq.to(od), dk.to(od), dv.to(od)


def flash_carry_init(h: int, b: int, d: int, device=None):
    """The initial (m, l, acc) carry of ``flash_attention_hop``."""
    return (torch.full((h, b), -math.inf, device=device),
            torch.zeros((h, b), device=device),
            torch.zeros((h, b, d), device=device))


def flash_carry_finalize(m, l, acc, dtype):
    """A final hop carry as ``(out (h, b, d) in dtype, lse (h, b) f32)``;
    rows that saw no key give out = 0 and lse = 0."""
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = (acc / l_safe[..., None]).to(dtype)
    lse = torch.where(torch.isfinite(m), m, 0.0) + torch.log(l_safe)
    return out, lse


# ---------------------------------------------------------------------------
# launch plumbing
# ---------------------------------------------------------------------------

_fns: dict = {}
_ARGTYPES = {
    "da_flash_attention": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 +
    [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "da_flash_hop": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 +
    [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_float] +
    [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "da_ring_attn_step": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 +
    [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4 +
    [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "da_flash_bwd_dq": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 +
    [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_float] +
    [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "da_flash_bwd_dkv": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 +
    [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_float] +
    [ctypes.c_int] * 3 + [ctypes.c_void_p],
}


def _fn(name: str, kernel: str):
    """The C entry ``name`` of the library that holds ``kernel``."""
    f = _fns.get(name)
    if f is None:
        f = getattr(kbuild.load(kbuild.KERNELS[kernel]), name)
        f.restype = ctypes.c_int
        f.argtypes = _ARGTYPES[name]
        _fns[name] = f
    return f


def _on_cuda(tensors, what: str) -> bool:
    """True for tensors all on one CUDA device, False for all-CPU ones;
    raise otherwise."""
    devs = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devs):
        return False
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"{what}: operands on {sorted(map(str, devs))}; the "
                         "kernel needs all of them on one CUDA device")
    return True


def _check_operands(what: str, *xs: torch.Tensor) -> None:
    dt = xs[0].dtype
    if dt not in _DTYPES or any(x.dtype != dt for x in xs):
        raise TypeError(f"{what} takes float32 or bfloat16 operands of one "
                        f"dtype, got {[str(x.dtype) for x in xs]}")
    if any(x.stride(-1) != 1 for x in xs):
        raise ValueError(f"{what} needs the head dim of every operand "
                         "contiguous")
    if xs[0].shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"{what} takes head dims up to {MAX_HEAD_DIM}, got "
                         f"{xs[0].shape[-1]}")


def _check_carry(what: str, m, l, acc, h: int, b: int, d: int) -> None:
    for name, t, shape in (("m", m, (h, b)), ("l", l, (h, b)),
                           ("acc", acc, (h, b, d))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{what}: carry {name} must be {shape} float32, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: carry {name} must be contiguous")


def _meta(*views: torch.Tensor):
    """Row stride, batch-head stride, head stride and inner head count of
    (S, H, D) or (S, B, H, D) views, as the kernels take them."""
    vals = []
    for x in views:
        if x.ndim == 3:
            vals += [x.stride(0), 0, x.stride(1), x.shape[1]]
        else:
            vals += [x.stride(0), x.stride(1), x.stride(2), x.shape[2]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _launched(rc: int, what: str, kernel: str, route=None) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
    kbuild.count(kernel, route)
    _rs.record("launch")


def flash_attention_route(dtype: torch.dtype, d: int, *views) -> str:
    """K5's, K6's, K7's and K8's route for operands of ``dtype`` with head
    dim ``d`` whose tensors (strided views, the head dim contiguous) are
    ``views``: ``"wgmma"`` when TMA can read them all (bf16, d a multiple of
    8 up to ``MAX_HEAD_DIM``, the row stride and the stride of every head
    dim longer than 1 positive and a multiple of 16 bytes, every base
    16-byte aligned), ``"mma"`` for other bf16, ``"f32"`` for float32."""
    if dtype == torch.float32:
        return "f32"
    if dtype != torch.bfloat16:
        raise TypeError(f"the flash attention kernels take float32 or "
                        f"bfloat16, got {dtype}")
    if d % 8 or d > MAX_HEAD_DIM:
        return "mma"
    for x in views:
        es = x.element_size()
        if x.data_ptr() % 16 or any(
                (i == 0 or n > 1) and (st <= 0 or st * es % 16)
                for i, (n, st) in enumerate(zip(x.shape[:-1],
                                                x.stride()[:-1]))):
            return "mma"
    return "wgmma"


# ---------------------------------------------------------------------------
# K5: flash attention
# ---------------------------------------------------------------------------


def _check_qkv(q, k, v) -> None:
    if q.ndim not in (3, 4) or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q/k/v must share (S, H, D) or (S, B, H, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")


def _flash_forward(q, k, v, causal, scale):
    """K5 or its plain version, outside autograd: ``(o, lse)``."""
    _check_qkv(q, k, v)
    if not _on_cuda([q, k, v], "flash attention"):
        o, lse = flash_attention_lse_plain(q, k, v, causal, scale)
        return o.reshape(q.shape), lse
    _check_operands("flash attention", q, k, v)
    S, D = q.shape[0], q.shape[-1]
    hall = math.prod(q.shape[1:-1])
    if q.ndim == 4:                          # batch-major storage
        o = torch.empty((q.shape[1], S) + q.shape[2:], dtype=q.dtype,
                        device=q.device).transpose(0, 1)
    else:
        o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((hall, S), dtype=torch.float32, device=q.device)
    if q.numel():
        route = flash_attention_route(q.dtype, D, q, k, v, o)
        rc = _fn("da_flash_attention", "flash_attention")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), _meta(q, k, v, o), S, S, D, hall, int(causal),
            _scale(D, scale), kbuild.ROUTES.index(route), q.device.index,
            torch.cuda.current_stream(q.device).cuda_stream)
        _launched(rc, f"flash attention ({route} route)", "flash_attention",
                  route)
    return o, lse


class FlashAttention(torch.autograd.Function):
    """``(o, lse)`` of flash attention with the FlashAttention-2 backward:
    K5 forward, ``flash_attention_bwd`` (K6 then K7) backward.  lse is not
    differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = _flash_forward(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, g, lse, ctx.causal,
                                         ctx.scale)
        return dq, dk, dv, None, None


@_tm.traced(name="pallas.flash_attention")
def flash_attention_lse(q, k, v, causal: bool = False, scale=None):
    """``(o, lse)`` of exact attention: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors; differentiable in q, k and v.  Its
    span keeps JAX's name (``pallas.flash_attention``).

    q, k, v: one shape, (S, H, D) or (S, B, H, D) (batch-major heads, any
    strides with the head dim contiguous).  o has q's shape; lse is
    (H_all, S) f32 with H_all = H or B*H."""
    return FlashAttention.apply(q, k, v, causal, scale)


def flash_attention(q, k, v, causal: bool = False, scale=None):
    """Exact attention over (S, H, D) tensors without the S x S score
    matrix: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors; differentiable in q, k and v."""
    if q.ndim != 3:
        raise ValueError(f"q/k/v must share (S, H, D), got {tuple(q.shape)}")
    return flash_attention_lse(q, k, v, causal, scale)[0]


# ---------------------------------------------------------------------------
# K6, K7: the FlashAttention-2 backward
# ---------------------------------------------------------------------------


def _bwd_launch(kernel: str, q, k, v, do, lse, dd, outs, qoff, koff,
                causal, scale) -> None:
    """Launch K6 (``outs`` = (dq,)) or K7 (``outs`` = (dk, dv)) on (S, H, D)
    or (S, B, H, D) views of one shape (head dim contiguous); lse and dd
    (H_all, S) f32."""
    what = "flash attention backward"
    _check_operands(what, q, k, v, do)
    if any(t.stride(-1) != 1 for t in outs):
        raise ValueError(f"{what} needs the head dim of its outputs "
                         "contiguous")
    S, D = q.shape[0], q.shape[-1]
    hall = math.prod(q.shape[1:-1])
    for name, t in (("lse", lse), ("dd", dd)):
        if tuple(t.shape) != (hall, S) or t.dtype != torch.float32 or \
                not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous "
                             f"({hall}, {S}) float32")
    if not q.numel():
        return
    dq = len(outs) == 1
    views = (q, k, v, do) + ((outs[0], outs[0], outs[0]) if dq
                             else (outs[0], outs[0], outs[1]))
    route = flash_attention_route(q.dtype, D, q, k, v, do, *outs)
    rc = _fn("da_flash_bwd_dq" if dq else "da_flash_bwd_dkv", kernel)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dd.data_ptr(), *(o.data_ptr() for o in outs),
        _meta(*views), S, S, D, hall, int(qoff), int(koff), int(causal),
        _scale(D, scale), kbuild.ROUTES.index(route),
        int(outs[0].dtype == torch.float32), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    _launched(rc, f"{what} {'dq' if dq else 'dk/dv'} ({route} route)",
              kernel, route)


def _bwd_kernels(q, k, v, do, lse, dd, dq, dk, dv, qoff, koff, causal,
                 scale) -> None:
    """K6 into dq, then K7 into dk and dv."""
    _bwd_launch("flash_attention_bwd_dq", q, k, v, do, lse, dd, (dq,), qoff,
                koff, causal, scale)
    _bwd_launch("flash_attention_bwd_dkv", q, k, v, do, lse, dd, (dk, dv),
                qoff, koff, causal, scale)


def flash_attention_bwd(q, k, v, o, g, lse, causal: bool = False,
                        scale=None):
    """``(dq, dk, dv)`` of flash attention, in q's type and shape, from the
    forward's ``o`` and ``lse`` and the cotangent ``g`` of o: dd =
    rowsum(g * o) in f32 from the full-precision g, do = g in q's type,
    then K6 and K7 for CUDA tensors (the plain version for CPU tensors).
    Layouts as ``flash_attention_lse``'s."""
    _check_qkv(q, k, v)
    S, D = q.shape[0], q.shape[-1]
    dd = (g.float() * o.float()).sum(-1).reshape(S, -1).t().contiguous()
    do = g.to(q.dtype)
    if not _on_cuda([q, k, v, o, g, lse], "flash attention backward"):
        heads = lambda x: x.reshape(S, -1, D).transpose(0, 1)
        grads = flash_attention_bwd_plain(*map(heads, (q, k, v, do)), lse, dd,
                                          0, 0, causal, scale)
        return tuple(x.transpose(0, 1).reshape(q.shape) for x in grads)
    if do.stride(-1) != 1:
        do = do.contiguous()
    dq, dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device)
                  for _ in range(3))
    _bwd_kernels(q, k, v, do, lse, dd, dq, dk, dv, 0, 0, causal, scale)
    return dq, dk, dv


def flash_attention_hop_bwd(q, k, v, do, lse, dd, qoff, koff,
                            causal: bool = False, scale=None):
    """Backward of one ring hop: the f32 ``(dq, dk, dv)`` contributions of
    the (H, B, D) q block against the (H, B, D) k/v block, from the final
    lse and dd = rowsum(do * o), both (H, B) f32; ``qoff``/``koff`` are the
    blocks' global positions.  Callers sum the contributions."""
    if q.ndim != 3 or any(x.shape != q.shape for x in (k, v, do)):
        raise ValueError(f"q/k/v/do must share (H, B, D), got "
                         f"{[tuple(x.shape) for x in (q, k, v, do)]}")
    if not _on_cuda([q, k, v, do, lse, dd], "flash hop backward"):
        return flash_attention_bwd_plain(q, k, v, do, lse, dd, qoff, koff,
                                         causal, scale, torch.float32)
    outs = [torch.empty(q.shape, dtype=torch.float32, device=q.device)
            for _ in range(3)]
    # (B, H, D) views, as the kernels take rows first
    _bwd_kernels(*(x.transpose(0, 1) for x in (q, k, v, do)), lse, dd,
                 *(x.transpose(0, 1) for x in outs), qoff, koff, causal,
                 scale)
    return tuple(outs)


# ---------------------------------------------------------------------------
# K8: one ring hop with carried state
# ---------------------------------------------------------------------------


def hop_groups(rows: int, heads: int, sms: int) -> int:
    """Consumer warpgroups of 64 query rows in a block of K8's wgmma route
    for a hop of ``rows`` query rows and ``heads`` heads on a card of
    ``sms`` SMs: two (a block shares each K/V stage between them, K5's
    layout, two blocks an SM) while that grid still has a block for every
    SM, else one (three blocks an SM), so that a short hop, such as a
    zigzag part of half a block, does not leave SMs idle.  Device time on
    an H100 80GB HBM3 at 700 W (chip_smoke.py --time-k4-k8): a visible
    (16, 2048, 64) hop 0.063-0.065 ms on two, 0.068-0.069 on one; a
    (16, 1024, 64) zigzag part's 0.018-0.020 on one, 0.025 on two."""
    return 2 if -(-rows // 128) * heads >= sms else 1


def flash_attention_hop(q, k, v, m, l, acc, qoff, koff,
                        causal: bool = False, scale=None):
    """One hop of flash attention over (H, B, D) blocks with the carry
    ``(m, l, acc)`` (see ``flash_carry_init``), updated in place and
    returned.  ``qoff``/``koff``: the global sequence positions of the q
    and k blocks' first rows.  Finalize with ``flash_carry_finalize``."""
    if q.ndim != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q/k/v must share (H, B, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    H, B, D = q.shape
    _check_carry("flash hop", m, l, acc, H, B, D)
    if not _on_cuda([q, k, v, m, l, acc], "flash hop"):
        mn, ln, an = flash_attention_hop_plain(q, k, v, m, l, acc, qoff,
                                               koff, causal, scale)
        m.copy_(mn)
        l.copy_(ln)
        acc.copy_(an)
        return m, l, acc
    _check_operands("flash hop", q, k, v)
    if q.numel():
        qh, kh, vh = (x.transpose(0, 1) for x in (q, k, v))  # (B, H, D) views
        route = flash_attention_route(q.dtype, D, qh, kh, vh)
        rc = _fn("da_flash_hop", "flash_attention_hop")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), m.data_ptr(),
            l.data_ptr(), acc.data_ptr(), _meta(qh, kh, vh, qh), B, B, D, H,
            int(qoff), int(koff), int(causal), _scale(D, scale),
            kbuild.ROUTES.index(route),
            hop_groups(B, H, kbuild.sm_count(q.device)), q.device.index,
            torch.cuda.current_stream(q.device).cuda_stream)
        _launched(rc, f"flash hop ({route} route)", "flash_attention_hop",
                  route)
    return m, l, acc


# ---------------------------------------------------------------------------
# K9: one step of the fused ring attention
# ---------------------------------------------------------------------------


def ring_attn_route(dtype: torch.dtype, dh: int, *ptrs: int) -> str:
    """K9's route for (b, h, dh) blocks of ``dtype`` whose q, k and v lie at
    the device addresses ``ptrs``: ``"wgmma"`` when TMA can read them (bf16,
    dh a multiple of 8 up to ``MAX_HEAD_DIM`` so the row strides are
    multiples of 16 bytes, 16-byte aligned bases), ``"mma"`` for other
    bf16 blocks, ``"f32"`` for float32."""
    if dtype == torch.float32:
        return "f32"
    if dtype != torch.bfloat16:
        raise TypeError(f"the ring attention kernel takes float32 or "
                        f"bfloat16, got {dtype}")
    if dh % 8 == 0 and dh <= MAX_HEAD_DIM and all(p % 16 == 0 for p in ptrs):
        return "wgmma"
    return "mma"


def ring_attn_step(q, kc, vc, o, m, l, acc, fk, fv, qoff: int, koff: int,
                   causal: bool, first: bool, last: bool, scale: float,
                   compute: bool = True):
    """Launch one rank's ring step (K9) on q's device and stream: forward
    the resident pair ``(kc, vc)`` into ``(fk, fv)`` (None at the last
    step) and accumulate q (b, h, dh) against it into the carry m, l (h, b)
    and acc (h, b, dh) f32, which the first step starts afresh; the last
    step writes o (b, h, dh).  ``compute=False`` (a causal step whose
    resident block is masked for every query row, as
    ``models.ring_attention.ring_step_plan`` decides) leaves the carry as
    it is, but still starts it at the first step and finishes it at the
    last.  Every tensor is contiguous on one card but ``fk``/``fv``, which
    may be a peer card's."""
    b, h, dh = q.shape
    route = ring_attn_route(q.dtype, dh, q.data_ptr(), kc.data_ptr(),
                            vc.data_ptr())
    rc = _fn("da_ring_attn_step", "ring_attention")(
        q.data_ptr(), kc.data_ptr(), vc.data_ptr(), o.data_ptr(),
        m.data_ptr(), l.data_ptr(), acc.data_ptr(),
        None if fk is None else fk.data_ptr(),
        None if fv is None else fv.data_ptr(), b, h, dh, int(qoff),
        int(koff), int(causal), int(first), int(last), int(compute),
        float(scale), kbuild.ROUTES.index(route), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    _launched(rc, f"ring attention ({route} route)", "ring_attention",
              route if compute else None)
