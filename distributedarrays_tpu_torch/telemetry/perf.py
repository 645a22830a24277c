"""Analytic cost stamps: flops and bytes computed from shapes at a call site.

The port's copy of the cost stamps of
``distributedarrays_tpu/telemetry/perf.py:131-210`` (``gemm_cost``,
``reshard_cost``, ``transfer_cost``, ``attention_cost``,
``decode_step_cost``, ``spmv_cost``, and ``train_step_cost`` of :223):
pure arithmetic giving the same dicts as JAX's, stamped as span labels
(``flops``, ``bytes_hbm``, ``bytes_ici``; ``bytes_ici`` is the bytes that
cross a rank boundary, whatever the link).  The peak table and the
roofline doctor that read them are not ported yet; when the peak table
comes it holds the H100's rates.
"""

from __future__ import annotations

__all__ = ["gemm_cost", "reshard_cost", "transfer_cost", "attention_cost",
           "decode_step_cost", "spmv_cost", "train_step_cost"]


def gemm_cost(m: int, n: int, k: int, itemsize: int = 4, *,
              out_itemsize: int | None = None,
              bytes_ici: int = 0) -> dict:
    """Roofline stamp for an ``(m, k) @ (k, n)`` GEMM: ``2mnk`` flops,
    operands read + result written once through HBM, and whatever cross-rank
    volume the caller's collective plan implies."""
    oi = itemsize if out_itemsize is None else int(out_itemsize)
    return {
        "flops": 2 * int(m) * int(n) * int(k),
        "bytes_hbm": (int(m) * int(k) + int(k) * int(n)) * int(itemsize)
        + int(m) * int(n) * oi,
        "bytes_ici": int(bytes_ici),
    }


def reshard_cost(total_bytes: int, moved_bytes: int) -> dict:
    """Stamp for a reshard: every byte read and rewritten through HBM,
    the plan's *moved* bytes crossing a device boundary, zero flops."""
    return {"flops": 0, "bytes_hbm": 2 * int(total_bytes),
            "bytes_ici": int(moved_bytes)}


def transfer_cost(nbytes: int) -> dict:
    """Stamp for a host<->device transfer (distribute / gather): the
    payload through HBM once; no flops, nothing across ranks."""
    return {"flops": 0, "bytes_hbm": int(nbytes), "bytes_ici": 0}


def attention_cost(s: int, h: int, d: int, itemsize: int = 4, *,
                   p: int = 1, causal: bool = False) -> dict:
    """Stamp for exact attention over a ``(s, h, d)`` q/k/v triple
    sharded over ``p`` ranks: two ``s x s x d`` GEMMs per head (halved
    causal), q/k/v/o through HBM once, and the k/v chunks rotating
    ``p - 1`` ring steps between ranks."""
    fl = 4 * int(s) * int(s) * int(h) * int(d)
    if causal:
        fl //= 2
    kv = 2 * int(s) * int(h) * int(d) * int(itemsize)
    return {
        "flops": fl,
        "bytes_hbm": 4 * int(s) * int(h) * int(d) * int(itemsize),
        "bytes_ici": (int(p) - 1) * kv if p > 1 else 0,
    }


def decode_step_cost(ctx_tokens: int, h: int, d: int,
                     itemsize: int = 4, *, new_tokens: int = 1) -> dict:
    """Stamp for one continuous-batching decode step: ``ctx_tokens``
    resident context rows across the batch attended by ``new_tokens``
    single-row queries: two row-by-context GEMVs a head (``4 ctx h d``
    flops) against the whole K/V working set read once, and the new rows
    written back (about 0.5 flop a byte in f32: bound by memory, where
    prefill's ``attention_cost`` is bound by operations)."""
    e = int(h) * int(d)
    return {
        "flops": 4 * int(ctx_tokens) * e,
        "bytes_hbm": (2 * int(ctx_tokens) + 3 * int(new_tokens)) * e
        * int(itemsize),
        "bytes_ici": 0,
    }


def spmv_cost(nnz: int, rows: int, itemsize: int = 4, *,
              index_itemsize: int = 4, bytes_ici: int = 0) -> dict:
    """Stamp for a sparse (or stencil) matvec: 2 flops per stored
    nonzero against the nonzeros (values + column indices) streamed
    from HBM once, plus the vector read and result written back.
    Arithmetic intensity ~0.25 flop/byte at f32+int32 — far under any
    ridge point, so SpMV is bound by memory, or by the halo exchange
    (``bytes_ici``) once that dominates.  Stencil
    callers pass ``index_itemsize=0`` (the pattern compiles into the
    kernel; only values move)."""
    return {
        "flops": 2 * int(nnz),
        "bytes_hbm": int(nnz) * (int(itemsize) + int(index_itemsize))
        + 2 * int(rows) * int(itemsize),
        "bytes_ici": int(bytes_ici),
    }


def train_step_cost(n_params: int, p: int, *, flops: float = 0.0,
                    batch_bytes: int = 0, itemsize: int = 4,
                    nslots: int = 2) -> dict:
    """Stamp for one data-parallel ZeRO-1 training step over ``p`` ranks:
    one all-gather of the parameter shards and one reduce-scatter of the
    full gradients (``2 (p - 1) n_params itemsize`` across ranks), and
    ``3 + 2 nslots`` parameter-vector passes through HBM (read parameters,
    gradients and each optimizer moment; write parameters and each moment)
    plus the batch read once.  ``flops`` is the task's forward + backward
    estimate."""
    n = int(n_params) * int(itemsize)
    return {
        "flops": float(flops),
        "bytes_hbm": (3 + 2 * int(nslots)) * n + int(batch_bytes),
        "bytes_ici": 2 * (int(p) - 1) * n if p > 1 else 0,
    }
