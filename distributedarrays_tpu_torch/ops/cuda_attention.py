"""Flash attention and one ring-attention hop: the hand-written CUDA kernels
(``csrc/attention.cu`` on ``csrc/attn_tile.cuh``) and their plain versions.

PyTorch counterpart of the forward half of ``distributedarrays_tpu/ops/
pallas_attention.py``:

- ``flash_attention(q, k, v, causal, scale)``: exact attention over
  (S, H, D) tensors without the S x S score matrix (K5).
  ``flash_attention_lse`` also returns the per-row logsumexp (H, S) f32,
  which the FlashAttention-2 backward consumes, and takes (S, B, H, D)
  views too (the batch folded into the heads, as the transformer folds it)
  and an ``out`` view to write into.
- ``flash_attention_hop(q, k, v, m, l, acc, qoff, koff, causal, scale)``:
  one ring hop on (H, B, D) blocks with the online-softmax carry
  m, l (H, B) f32 and acc (H, B, D) f32 (K8).  The carry is updated in
  place, on both paths, and returned.
- ``flash_carry_init``, ``flash_carry_finalize``, ``flash_block_size``.

For CPU tensors each wrapper takes its plain version; for CUDA tensors it
launches the kernel or raises, with no fallback.  ``flash_attention_plain``
has the semantics of the JAX package's dense rule ``_dense_attention_shd``
(f32 softmax); ``flash_attention_hop_plain`` computes the hop in the TPU
kernel's numerics over the whole block as one tile (products of the input
values with f32 sums, scale after the QK product, p rounded to v's type
before the PV product).  Where the JAX functions' results differ only by
rounding order, these give the same result.

What has no counterpart, and why: the TPU tiling knobs ``block_q``,
``block_k``, ``head_fold`` and ``interpret`` (the CUDA kernels' tiles are
fixed for the card: 64 query rows a block, 64 keys a shared-memory tile on
the bf16 tensor cores and 32 on the f32 pipes; there is no interpreter);
the lane-broadcast ``_LANE = 128`` layout of m, l and lse (a TPU
block-shape rule; here they are (H, B) and (H, S)); and the autotune
lookups ``tuned_flash_config`` / ``tuned_hop_blocks_for``, which
only choose those knobs.

``ring_attn_step`` launches K9 (``da_ring_attn_step``), the fused ring
attention step that ``models/ring_attention.ring_attention_rdma`` drives.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..utils import kbuild

__all__ = ["flash_attention", "flash_attention_lse", "flash_attention_hop",
           "flash_attention_plain", "flash_attention_lse_plain",
           "flash_attention_hop_plain", "flash_carry_init",
           "flash_carry_finalize", "flash_block_size", "ring_attn_step",
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
    [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_float, ctypes.c_int,
                               ctypes.c_int, ctypes.c_void_p],
    "da_ring_attn_step": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 +
    [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3 +
    [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}


def _fn(name: str):
    f = _fns.get(name)
    if f is None:
        f = getattr(kbuild.load("attention"), name)
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
    return (ctypes.c_longlong * 16)(*vals)


def _launched(rc: int, what: str, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
    kbuild.count(kernel)


# ---------------------------------------------------------------------------
# K5: flash attention
# ---------------------------------------------------------------------------


def flash_attention_lse(q, k, v, causal: bool = False, scale=None, out=None):
    """``(o, lse)`` of exact attention: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors.

    q, k, v: one shape, (S, H, D) or (S, B, H, D) (batch-major heads, any
    strides with the head dim contiguous).  o has q's shape (or is written
    into ``out``, a view of that shape, and returned); lse is
    (H_all, S) f32 with H_all = H or B*H."""
    if q.ndim not in (3, 4) or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q/k/v must share (S, H, D) or (S, B, H, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if out is not None and (out.shape != q.shape or out.dtype != q.dtype):
        raise ValueError(f"out must be {tuple(q.shape)} {q.dtype}, got "
                         f"{tuple(out.shape)} {out.dtype}")
    tensors = [q, k, v] + ([] if out is None else [out])
    if not _on_cuda(tensors, "flash attention"):
        o, lse = flash_attention_lse_plain(q, k, v, causal, scale)
        o = o.reshape(q.shape)
        if out is None:
            return o, lse
        return out.copy_(o), lse
    _check_operands("flash attention", *tensors)
    S, D = q.shape[0], q.shape[-1]
    hall = math.prod(q.shape[1:-1])
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device) \
        if out is None else out
    lse = torch.empty((hall, S), dtype=torch.float32, device=q.device)
    if q.numel():
        rc = _fn("da_flash_attention")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), _meta(q, k, v, o), S, S, D, hall, int(causal),
            _scale(D, scale), int(q.dtype == torch.bfloat16),
            q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
        _launched(rc, "flash attention", "flash_attention")
    return o, lse


def flash_attention(q, k, v, causal: bool = False, scale=None):
    """Exact attention over (S, H, D) tensors without the S x S score
    matrix: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if q.ndim != 3:
        raise ValueError(f"q/k/v must share (S, H, D), got {tuple(q.shape)}")
    return flash_attention_lse(q, k, v, causal, scale)[0]


# ---------------------------------------------------------------------------
# K8: one ring hop with carried state
# ---------------------------------------------------------------------------


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
        rc = _fn("da_flash_hop")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), m.data_ptr(),
            l.data_ptr(), acc.data_ptr(), _meta(qh, kh, vh, qh), B, B, D, H,
            int(qoff), int(koff), int(causal), _scale(D, scale),
            int(q.dtype == torch.bfloat16), q.device.index,
            torch.cuda.current_stream(q.device).cuda_stream)
        _launched(rc, "flash hop", "flash_attention_hop")
    return m, l, acc


# ---------------------------------------------------------------------------
# K9: one step of the fused ring attention
# ---------------------------------------------------------------------------


def ring_attn_step(q, kc, vc, o, m, l, acc, fk, fv, qoff: int, koff: int,
                   causal: bool, first: bool, last: bool, scale: float):
    """Launch one rank's ring step (K9) on q's device and stream: forward
    the resident pair ``(kc, vc)`` into ``(fk, fv)`` (None at the last
    step) and accumulate q (b, h, dh) against it into the carry m, l (h, b)
    and acc (h, b, dh) f32, which the first step starts afresh; the last
    step writes o (b, h, dh).  Every tensor is contiguous on one card but
    ``fk``/``fv``, which may be a peer card's."""
    b, h, dh = q.shape
    rc = _fn("da_ring_attn_step")(
        q.data_ptr(), kc.data_ptr(), vc.data_ptr(), o.data_ptr(),
        m.data_ptr(), l.data_ptr(), acc.data_ptr(),
        None if fk is None else fk.data_ptr(),
        None if fv is None else fv.data_ptr(), b, h, dh, int(qoff),
        int(koff), int(causal), int(first), int(last), float(scale),
        int(q.dtype == torch.bfloat16), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    _launched(rc, "ring attention", "ring_attention")
