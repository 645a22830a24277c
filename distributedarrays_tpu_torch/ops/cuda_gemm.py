"""Block GEMM and int8 GEMM: the hand-written CUDA kernels
(``csrc/gemm.cu``, ``csrc/gemm_int8.cu``) and their plain versions.

PyTorch counterpart of ``pallas_matmul``, ``pallas_matmul_int8``,
``quantize_rows`` and ``quantized_matmul`` in
``distributedarrays_tpu/ops/pallas_gemm.py``.  ``cuda_matmul`` computes
``C = epilogue(A @ B)`` with a float32 accumulator, f32 or bf16 inputs,
output in ``result_type(A, B)``.

``cuda_matmul`` launches the kernel for CUDA tensors and takes the plain
version (``matmul_plain``) for CPU tensors; it never falls back from one to
the other.  A mixed bf16/f32 pair is upcast to f32, which is what the JAX
promotion computes.  The kernel has three routes, which ``gemm_route``
picks from the dtype and shape and each of which counts its own launches
(``kbuild.route_counts()["gemm"]``): ``"wgmma"`` (bf16 with K and N
multiples of 8 and 16-byte aligned bases: wgmma fed by TMA), ``"mma"``
(any other bf16 shape: mma.sync) and ``"f32"`` (a cp.async-pipelined FP32
loop).  A route that cannot launch raises; none stands in for another.
The JAX ``epilogue`` fuses into the tile flush; here the kernel writes f32
when an epilogue is given and the wrapper applies the epilogue to that f32
result before casting, which gives the same numbers.  The epilogue is an
arbitrary Python callable and no caller in the port passes one, so it is
not fused.

``cuda_matmul_int8`` computes ``C = f32(Qa @ Qb) * (sa sb^T)`` from int8
codes with an exact int32 accumulator and the dequantization fused into the
tile flush; it takes any m, n and k (the Pallas kernel needs them to divide
its tiles).  The kernel has two routes, which ``int8_gemm_route`` picks and
each of which counts its own launches (``kbuild.route_counts()
["matmul_int8"]``): ``"wgmma"`` (K a multiple of 16 and qa 16-byte aligned:
wgmma fed by TMA, after a transpose kernel has written qb K-major into a
scratch tensor the wrapper allocates) and ``"mma"`` (any other shape:
mma.sync).  Its plain version ``matmul_int8_plain`` multiplies the codes as
int32 on the CPU and as float64 on a card (which has no integer GEMM in
torch), both exact while the int32 sum cannot overflow, then applies the
same two f32 multiplies: kernel and plain version agree bit for bit.

``torch_matmul`` is the plain large product the distributed GEMMs use
outside any kernel, with TF32 off so float32 products run in float32.
"""

from __future__ import annotations

import contextlib
import ctypes
import warnings
from typing import Callable

import torch

from .. import telemetry as _tm
from ..utils import kbuild

__all__ = ["cuda_matmul", "matmul_plain", "cuda_matmul_int8",
           "matmul_int8_plain", "quantize_rows", "quantized_matmul",
           "torch_matmul", "gemm_route", "int8_gemm_route"]

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


@contextlib.contextmanager
def _true_f32():
    """float32 products in float32, not TF32."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def torch_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.matmul`` with TF32 off."""
    with _true_f32():
        return torch.matmul(a, b)


def matmul_plain(a: torch.Tensor, b: torch.Tensor,
                 epilogue: Callable | None = None) -> torch.Tensor:
    """The plain version: f32 product, then the epilogue, then the cast to
    ``promote_types(a, b)``."""
    out_dtype = torch.promote_types(a.dtype, b.dtype)
    r = a.float() @ b.float()
    if epilogue is not None:
        r = epilogue(r)
    return r.to(out_dtype)


_fn = None


def _gemm_fn():
    global _fn
    if _fn is None:
        f = kbuild.load("gemm").da_gemm
        f.restype = ctypes.c_int
        f.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + \
            [ctypes.c_void_p]
        _fn = f
    return _fn


def gemm_route(dtype: torch.dtype, n: int, k: int, a_ptr: int,
               b_ptr: int) -> str:
    """The kernel route for row-major (m, k) @ (k, n) operands of ``dtype``
    at device addresses ``a_ptr`` and ``b_ptr``: ``"wgmma"`` when TMA can
    read both (bf16, K and N multiples of 8 so every row stride is a
    multiple of 16 bytes, 16-byte aligned bases), ``"mma"`` for any other
    bf16 operands, ``"f32"`` for float32."""
    if dtype == torch.float32:
        return "f32"
    if dtype != torch.bfloat16:
        raise TypeError(f"the GEMM kernel takes float32 or bfloat16, got "
                        f"{dtype}")
    if k % 8 == 0 and n % 8 == 0 and a_ptr % 16 == 0 and b_ptr % 16 == 0:
        return "wgmma"
    return "mma"


@_tm.traced(name="pallas.matmul")
def cuda_matmul(a: torch.Tensor, b: torch.Tensor,
                epilogue: Callable | None = None) -> torch.Tensor:
    """``C = epilogue(A @ B)``: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Its span keeps JAX's name
    (``pallas.matmul``) and cost stamp."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if _tm.enabled():
        # cost stamp on the traced span: one device's GEMM, nothing across
        # ranks; inline as JAX's, since a and b may differ in dtype
        from ..utils import autotune as _at
        m, k = a.shape
        n = b.shape[1]
        ob = torch.promote_types(a.dtype, b.dtype).itemsize
        _tm.annotate(flops=2 * m * n * k,
                     bytes_hbm=m * k * a.element_size()
                     + k * n * b.element_size() + m * n * ob,
                     bytes_ici=0, shape=[m, k, n],
                     dtype=[str(a.dtype), str(b.dtype)],
                     autotune_key=_at.device_key_for(m, n, k, a.dtype,
                                                     b.dtype))
    if not (a.dtype.is_floating_point and b.dtype.is_floating_point):
        raise TypeError(f"cuda_matmul takes float operands, got {a.dtype} "
                        f"and {b.dtype}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_plain(a, b, epilogue)
    if a.device.type != "cuda" or a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}: the kernel "
                         "needs both on one CUDA device")
    out_dtype = torch.promote_types(a.dtype, b.dtype)
    if a.dtype != b.dtype:
        a, b = a.float(), b.float()
    if a.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the GEMM kernel takes float32 or bfloat16, got "
                        f"{a.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("the GEMM kernel needs contiguous operands")
    m, k = a.shape
    n = b.shape[1]
    c_dtype = torch.float32 if epilogue is not None else out_dtype
    c = torch.empty((m, n), dtype=c_dtype, device=a.device)
    if c.numel() == 0 or k == 0:
        c.zero_()                            # nothing to multiply
    else:
        route = gemm_route(a.dtype, n, k, a.data_ptr(), b.data_ptr())
        rc = _gemm_fn()(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
                        kbuild.ROUTES.index(route),
                        int(c_dtype == torch.bfloat16),
                        a.device.index,
                        torch.cuda.current_stream(a.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"GEMM kernel launch failed ({route} route): "
                               f"CUDA error {rc}")
        kbuild.count("gemm", route)
    if epilogue is not None:
        c = epilogue(c).to(out_dtype)
    return c


# ---------------------------------------------------------------------------
# int8 GEMM with fused dequantization
# ---------------------------------------------------------------------------

# above this contraction length saturated codes can overflow the int32 sum
SAFE_K = (2 ** 31 - 1) // (127 * 127)
_INT8_OUT = (torch.float32, torch.bfloat16)


def quantize_rows(x: torch.Tensor, axis: int):
    """Symmetric per-slice int8 quantization along ``axis`` (the contraction
    axis): ``(q_int8, scale_f32)`` with ``x ~ q * scale`` broadcast over
    ``axis``; the scale is ``amax / 127``, codes round half to even, and an
    all-zero slice gets scale 0 (codes 0), not NaN."""
    x = x.float()
    scale = x.abs().amax(dim=axis, keepdim=True) / 127.0
    pos = scale > 0
    q = torch.where(pos, torch.round(x / torch.where(pos, scale, 1.0)), 0.0)
    return q.to(torch.int8), scale.squeeze(axis)


def _int8_args(qa, qb, sa, sb, out_dtype):
    if qa.dtype != torch.int8 or qb.dtype != torch.int8:
        raise ValueError(f"operands must be int8, got {qa.dtype} x {qb.dtype} "
                         "(use quantized_matmul for float inputs)")
    if qa.ndim != 2 or qb.ndim != 2 or qa.shape[1] != qb.shape[0]:
        raise ValueError(f"matmul dim mismatch {tuple(qa.shape)} @ "
                         f"{tuple(qb.shape)}")
    m, k = qa.shape
    n = qb.shape[1]
    sa = sa.to(torch.float32).reshape(-1)
    sb = sb.to(torch.float32).reshape(-1)
    if sa.numel() != m or sb.numel() != n:
        raise ValueError(f"scales {tuple(sa.shape)}, {tuple(sb.shape)} do not "
                         f"match the ({m}, {n}) output")
    if k > SAFE_K:
        # worst-case saturated codes overflow the int32 sum above this K;
        # real data rarely saturates, so warn (once per K), don't refuse
        warnings.warn(f"matmul_int8: K={k} exceeds the worst-case int32-exact "
                      f"bound (K <= {SAFE_K}); saturated operands may wrap. "
                      "Split the contraction if inputs can saturate.",
                      RuntimeWarning, stacklevel=3)
    return sa, sb, out_dtype


def matmul_int8_plain(qa: torch.Tensor, qb: torch.Tensor, sa: torch.Tensor,
                      sb: torch.Tensor, out_dtype=torch.float32):
    """The plain version: the exact integer product, converted to f32 once,
    times ``sa[i] * sb[j]`` in f32."""
    sa, sb, out_dtype = _int8_args(qa, qb, sa, sb, out_dtype)
    if qa.device.type == "cpu":
        acc = (qa.to(torch.int32) @ qb.to(torch.int32)).float()
    else:
        # no integer GEMM on the card: float64 holds every partial sum of
        # int8 products exactly while |acc| < 2**53
        acc = (qa.double() @ qb.double()).float()
    return (acc * (sa[:, None] * sb[None, :])).to(out_dtype)


_fn_int8 = None


def _int8_fn():
    global _fn_int8
    if _fn_int8 is None:
        f = kbuild.load("gemm_int8").da_gemm_int8
        f.restype = ctypes.c_int
        f.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + \
            [ctypes.c_void_p]
        _fn_int8 = f
    return _fn_int8


def int8_gemm_route(qa: torch.Tensor, qb: torch.Tensor) -> str:
    """The int8 kernel's route for contiguous (m, k) @ (k, n) codes:
    ``"wgmma"`` when TMA can read A and the K-major copy of B (k a multiple
    of 16, so every row is a multiple of 16 bytes, and qa 16-byte aligned;
    the copy is the wrapper's own allocation and qb is read by the
    transpose kernel at any alignment), ``"mma"`` otherwise."""
    k = qa.shape[1]
    return "wgmma" if k % 16 == 0 and qa.data_ptr() % 16 == 0 else "mma"


@_tm.traced(name="pallas.matmul_int8")
def cuda_matmul_int8(qa: torch.Tensor, qb: torch.Tensor, sa: torch.Tensor,
                     sb: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """``C = f32(Qa @ Qb) * (sa sb^T)``: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors, a ``meta`` placeholder of the product
    for ``meta`` operands.  ``qa`` (m,k) and ``qb`` (k,n) int8, ``sa``
    (m,) and ``sb`` (n,) scales; output float32 or bfloat16.  Its span
    keeps JAX's name (``pallas.matmul_int8``) and cost stamp."""
    tensors = (qa, qb, sa, sb)
    if _tm.enabled() and qa.ndim == 2 and qb.ndim == 2:
        # cost stamp: int8 operands, the dequantized output through HBM
        from ..telemetry import perf as _perf
        _tm.annotate(shape=[qa.shape[0], qa.shape[1], qb.shape[1]],
                     **_perf.gemm_cost(qa.shape[0], qb.shape[1], qa.shape[1],
                                       1, out_itemsize=out_dtype.itemsize))
    if all(t.device.type == "cpu" for t in tensors):
        return matmul_int8_plain(qa, qb, sa, sb, out_dtype)
    if all(t.device.type == "meta" for t in tensors):
        # another controller process's rank in a job: the product's
        # placeholder
        sa, sb, out_dtype = _int8_args(qa, qb, sa, sb, out_dtype)
        return torch.empty((qa.shape[0], qb.shape[1]), dtype=out_dtype,
                           device="meta")
    dev = qa.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("the int8 GEMM kernel needs every operand on one "
                         f"CUDA device, got {[str(t.device) for t in tensors]}")
    sa, sb, out_dtype = _int8_args(qa, qb, sa, sb, out_dtype)
    if out_dtype not in _INT8_OUT:
        raise TypeError(f"the int8 GEMM kernel writes float32 or bfloat16, "
                        f"not {out_dtype}")
    if not (qa.is_contiguous() and qb.is_contiguous()):
        raise ValueError("the int8 GEMM kernel needs contiguous operands")
    sa, sb = sa.contiguous(), sb.contiguous()
    m, k = qa.shape
    n = qb.shape[1]
    c = torch.empty((m, n), dtype=out_dtype, device=dev)
    if c.numel() == 0 or k == 0:
        return c.zero_()                     # nothing to multiply
    route = int8_gemm_route(qa, qb)
    # the wgmma route's K-major copy of qb, written by the kernel's own
    # transpose on the same stream
    ws = torch.empty((n, k), dtype=torch.int8, device=dev) \
        if route == "wgmma" else None
    rc = _int8_fn()(qa.data_ptr(), qb.data_ptr(), sa.data_ptr(), sb.data_ptr(),
                    c.data_ptr(), None if ws is None else ws.data_ptr(),
                    m, n, k, kbuild.ROUTES.index(route),
                    int(out_dtype == torch.bfloat16), dev.index,
                    torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8 GEMM kernel launch failed ({route} route): "
                           f"CUDA error {rc}")
    kbuild.count("matmul_int8", route)
    return c


def quantized_matmul(a: torch.Tensor, b: torch.Tensor,
                     out_dtype=torch.float32) -> torch.Tensor:
    """Dynamic-quantization GEMM: float in, float out, int8 products.
    Per-row (A) / per-column (B) symmetric int8 codes, exact int32 sums and
    fused dequantization; the relative error is that of the two
    quantization steps (about 1e-2 on Gaussian data)."""
    qa, sa = quantize_rows(a, 1)
    qb, sb = quantize_rows(b, 0)
    return cuda_matmul_int8(qa, qb, sa, sb, out_dtype)
