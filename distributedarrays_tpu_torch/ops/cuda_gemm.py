"""Block GEMM: the hand-written CUDA kernel (``csrc/gemm.cu``) and its plain
version.

PyTorch counterpart of ``pallas_matmul`` in
``distributedarrays_tpu/ops/pallas_gemm.py``: ``C = epilogue(A @ B)`` with a
float32 accumulator, f32 or bf16 inputs, output in ``result_type(A, B)``.

``cuda_matmul`` launches the kernel for CUDA tensors and takes the plain
version (``matmul_plain``) for CPU tensors; it never falls back from one to
the other.  A mixed bf16/f32 pair is upcast to f32, which is what the JAX
promotion computes.  The JAX ``epilogue`` fuses into the tile flush; here
the kernel writes f32 when an epilogue is given and the wrapper applies the
epilogue to that f32 result before casting, which gives the same numbers
(fusing it is still to do).
"""

from __future__ import annotations

import ctypes
from typing import Callable

import torch

from ..utils import kbuild

__all__ = ["cuda_matmul", "matmul_plain"]

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


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


def cuda_matmul(a: torch.Tensor, b: torch.Tensor,
                epilogue: Callable | None = None) -> torch.Tensor:
    """``C = epilogue(A @ B)``: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul shapes {tuple(a.shape)} @ {tuple(b.shape)}")
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
        rc = _gemm_fn()(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
                        int(a.dtype == torch.bfloat16),
                        int(c_dtype == torch.bfloat16), a.device.index,
                        torch.cuda.current_stream(a.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"GEMM kernel launch failed: CUDA error {rc}")
        kbuild.count("gemm")
    if epilogue is not None:
        c = epilogue(c).to(out_dtype)
    return c
