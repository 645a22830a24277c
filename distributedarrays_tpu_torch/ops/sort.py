"""Distributed sort of DVectors: ``dsort``.

PyTorch counterpart of ``distributedarrays_tpu/ops/sort.py`` (the
reference's ``src/sort.jl``).  PSRS, parallel sorting by regular
sampling, on each rank's tensor (JAX ``_psrs_mesh_jit``):

1. each rank sorts the total-order keys of its chunk, stably, and permutes
   its values the same way;
2. p regular samples of each rank's sorted keys are gathered and sorted,
   and every p-th of them is a pivot (p - 1 pivots), unless ``sample``
   gives the pivots;
3. the pivots cut each rank's sorted keys into p buckets (the bucket of a
   key is ``searchsorted(pivots, key, right=True)``, JAX's rule);
4. the p x p bucket counts come to the host once, and one all-to-all of
   exact-size pieces moves every bucket, keys and values, to its rank:
   ``ops/cuda_collectives.ring_all_to_allv``, one K11 copy launch a card
   on CUDA tensors (JAX pads every bucket to the chunk size because XLA
   needs static shapes, which would move p times the bytes);
5. each rank merges what it received with a stable sort of the keys,
   whose input is in source-rank order: key first, then source rank, then
   position, the order JAX's ``lexsort((is_pad, krecv))`` gives.

As in the reference, the result drops the ranks that received nothing
and takes the uneven layout of the chunk sizes (``_assemble``), each
merged chunk staying on its rank's device.

In a job of several controller processes (``parallel.multihost``) each
process sorts and samples its own cells (another process's are ``meta``
placeholders, whose shapes the same code carries), the samples travel by
the cross-process ``pgather`` so that every process picks the same
pivots, the rows of the count matrix are exchanged as JSON, and
``ring_all_to_allv`` moves the buckets by one exchange (one copy launch a
process on the card).  Every process then builds the same result layout,
the empty ranks dropped.  The whole-vector and host paths read the vector
by ``multihost.fetch_regions``.

Keys are a total order in the signed integer type of the key's width
(JAX ``_to_total_order``/``_sort_keys``, shifted by 2**(w-1) so that no
unsigned tensor op is needed): a float's bits with the negative ones
complemented and every NaN mapped to one key above +inf, so NaNs sort
last, as in numpy; signed integers as they are; bools as 0/1; unsigned
integers with the sign bit flipped.  ``rev`` complements the keys, a
reversal that keeps ties in their order, as ``sorted(reverse=True)``
does.  ``by`` is a function on torch tensors (``torch.abs``); when a
probe call on a one-element tensor raises or does not return a
one-element tensor, ``dsort`` takes the exact host ``sorted(key=by)``
with a warning, as JAX does for a ``by`` it cannot trace.  With one rank,
or fewer elements than ranks, the whole vector is sorted on the first
rank's device with the same keys.

``sample`` chooses the pivots, so only the balance of the result:
``True`` (regular sampling), ``False`` (uniform between the keys' min and
max), ``(lo, hi)`` (uniform between the bounds, rounded for integer
keys) or an array (a pre-drawn sample whose evenly spaced order
statistics are the pivots).  Invalid values raise, as JAX's
``_explicit_pivots`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import layout as L
from ..darray import DArray, SubDArray, _assemble, as_tensor, distribute, \
    from_global
from ..parallel import multihost
from ..parallel.collectives import pgather
from ..utils.debug import fn_site, warn_once
from .cuda_collectives import ring_all_to_allv

__all__ = ["dsort"]

_SIGNED = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32, torch.uint64)
# the positive quiet NaN's bits (JAX's canonical NaN) by float width
_NAN_BITS = {torch.float16: 0x7E00, torch.bfloat16: 0x7FC0,
             torch.float32: 0x7FC00000, torch.float64: 0x7FF8000000000000}


def _sort_keys(k: torch.Tensor, rev: bool) -> torch.Tensor:
    """The total-order keys of ``k`` in the signed type of its width."""
    if k.dtype == torch.bool:
        kt = k.to(torch.int8)
    elif k.dtype.is_floating_point:
        st = _SIGNED[k.element_size()]
        b = k.view(st)
        low = torch.iinfo(st).min
        # negative floats: complement, then flip the sign bit (the unsigned
        # transform ~b shifted by 2**(w-1)); non-negative ones stay
        kt = torch.where(b < 0, (~b) ^ low, b)
        kt = torch.where(torch.isnan(k), torch.tensor(
            _NAN_BITS[k.dtype], dtype=st, device=k.device), kt)
    elif k.dtype in _UNSIGNED:
        st = _SIGNED[k.element_size()]
        kt = k.view(st) ^ torch.iinfo(st).min
    elif k.dtype.is_complex:
        raise TypeError("dsort: complex keys have no order")
    else:
        kt = k
    return ~kt if rev else kt


def _key_dtype(d: DArray, by):
    """The dtype of the sort keys, or None when ``by`` does not work on
    torch tensors: a probe call on a one-element tensor of ``d``'s dtype
    must give a one-element tensor."""
    if by is None:
        return d.dtype
    x = torch.zeros(1, dtype=d.dtype, device=d.home())
    try:
        r = by(x)
    except Exception:                     # any failure: not a tensor function
        return None
    ok = isinstance(r, torch.Tensor) and tuple(r.shape) == (1,)
    return r.dtype if ok else None


def _key_minmax(d: DArray, by):
    """The smallest and largest key over every rank, NaNs left out (each
    process its own cells' in a job)."""
    def minmax(ci):
        x = d.part(ci)
        k = x if by is None else by(x)
        if k.dtype.is_floating_point:
            k = k[~torch.isnan(k)]
        return (float(k.min()), float(k.max())) if k.numel() else None
    got = [v for v in multihost.cell_values(d, minmax) if v is not None]
    return min(v[0] for v in got), max(v[1] for v in got)


def _typed(vals, dtype: torch.dtype) -> torch.Tensor:
    return torch.as_tensor(np.asarray(vals)).to(dtype)


def _explicit_pivots(d: DArray, sample, by, key_dtype, rev: bool, p: int,
                     validate_only: bool = False):
    """The sample strategy (reference sort.jl:110-135, JAX
    ``_explicit_pivots``) as sorted total-order pivot keys on the host's
    CPU, or None for ``sample=True``; invalid values raise."""
    if sample is True:
        return None
    if sample is False:
        if validate_only:
            return None
        lo, hi = _key_minmax(d, by)
        return _explicit_pivots(d, (lo, hi), by, key_dtype, rev, p)
    if isinstance(sample, tuple):
        if len(sample) != 2:
            raise ValueError(f"sample tuple must be (min, max), got "
                             f"{sample!r}")
        lo, hi = float(sample[0]), float(sample[1])
        if not lo <= hi:
            raise ValueError(f"sample bounds must satisfy min <= max, got "
                             f"({lo}, {hi})")
        part = (hi - lo) / p
        if np.isnan(part) or np.isinf(part):
            raise ValueError("sample bounds must be finite")
        if validate_only:
            return None
        vals = lo + np.arange(1, p) * part
        if not (key_dtype.is_floating_point or key_dtype.is_complex):
            vals = np.round(vals)
        return torch.sort(_sort_keys(_typed(vals, key_dtype), rev)).values
    arr = np.asarray(sample) if not isinstance(sample, (bool, int, float)) \
        else None
    if arr is not None and arr.ndim >= 1:
        if arr.size < p:
            raise ValueError(
                f"sample array needs >= {p} elements for {p} ranks, got "
                f"{arr.size}")
        if validate_only:
            return None
        kt = torch.sort(_sort_keys(_typed(arr.reshape(-1), key_dtype),
                                   rev)).values
        return kt[np.arange(1, p) * (arr.size // p)]
    raise ValueError(
        "keyword arg `sample` must be a bool, a (min, max) tuple, or an "
        f"actual sample of the data; got {sample!r}")


def _psrs_sort(d: DArray, rev: bool, by, pivots) -> DArray:
    pids = [int(q) for q in d.pids.flat]
    p = len(pids)
    job = multihost.in_job()
    xs, ks = [], []
    for ci in d.cells():
        # another process's cell is a placeholder: shapes only
        x = d._parts[ci]
        kt = _sort_keys(x if by is None else by(x), rev)
        order = torch.sort(kt, stable=True).indices
        ks.append(kt[order])
        xs.append(x[order])
    # a process that holds no cell takes part in the collectives with its
    # placeholders and sorts nothing
    mine = [r for r, q in enumerate(pids) if L.is_local(q)]
    dev0 = ks[mine[0]].device if mine else L.local_device()
    if pivots is None:  # dalint: disable=DAL010 — pivots is given or not by the same call on every process
        top = torch.iinfo(ks[0].dtype).max
        samp = []
        for k in ks:
            v = k.shape[0]
            # an empty chunk samples the top key, as JAX's pad sentinel
            samp.append(k[(torch.arange(p, device=k.device) * v) // p]
                        if v else
                        torch.full((p,), top, dtype=k.dtype, device=k.device))
        if job:
            # every process gets every rank's samples, in rank order
            samp = pgather(samp)[mine[0] if mine else 0]
        else:
            samp = torch.cat([x.to(dev0) for x in samp])
        allsamp = torch.sort(samp).values
        pivots = allsamp[torch.arange(1, p, device=allsamp.device) * p]
    # bucket q of rank r: the keys with q pivots at or below them (this
    # process's ranks; every rank in one process)
    starts = torch.stack([torch.searchsorted(ks[r], pivots.to(ks[r].device),
                                             right=False).to(dev0)
                          for r in mine]).cpu().tolist() if mine else []
    counts = {}
    for r, st in zip(mine, starts):
        edges = [0] + st + [ks[r].shape[0]]
        counts[r] = [edges[q + 1] - edges[q] for q in range(p)]
    if job:
        for part in multihost._all_gather_json(
                "dsort", {str(r): c for r, c in counts.items()}):
            counts.update({int(r): c for r, c in part.items()})
    counts = [counts[r] for r in range(p)]
    krecv, vrecv = ring_all_to_allv([ks, xs], counts)
    kept = []
    for q in range(p):
        if krecv[q].shape[0]:
            order = torch.sort(krecv[q], stable=True).indices
            kept.append((pids[q], vrecv[q][order]))
    parts = np.empty(len(kept), dtype=object)
    for i, (_, t) in enumerate(kept):
        parts[i] = t
    return _assemble(parts, np.asarray([q for q, _ in kept], dtype=np.int64))


def _whole_sort(d: DArray, rev: bool, by, pids) -> DArray:
    """The whole vector sorted on the first rank's device with the PSRS
    keys (stable, so ties keep their order under ``rev`` too)."""
    x = d.full()
    kt = _sort_keys(x if by is None else by(x), rev)
    return from_global(x[torch.sort(kt, stable=True).indices], procs=pids)


def dsort(d, sample=True, by=None, rev: bool = False,
          alg: str | None = None) -> DArray:
    """Sort a distributed vector (reference ``Base.sort(::DVector)``,
    sort.jl:103; JAX ``ops/sort.py:302``).

    - ``alg="psrs"`` requires PSRS (a 1-D DArray on more than one rank
      with at least one element a rank, and a ``by`` that works on torch
      tensors) and raises otherwise; ``alg=None`` takes PSRS where it
      applies, else the whole-vector sort, else (a ``by`` that does not
      work on tensors) the exact host ``sorted(key=by)``.
    - ``sample`` picks the pivot strategy (see the module docstring);
      invalid values raise.
    - ``by`` and ``rev`` are the reference's keywords; NaNs sort last."""
    if alg not in (None, "psrs"):
        raise ValueError(f"unknown alg {alg!r}; expected 'psrs' or None")
    if isinstance(d, SubDArray):
        d = d.copy()
    if not isinstance(d, DArray):
        d = distribute(as_tensor(d).reshape(-1))
    if d.ndim != 1:
        raise ValueError("dsort expects a 1-D DArray (DVector)")
    d._check_open()
    pids = [int(q) for q in d.pids.flat]
    p = len(pids)
    eligible = p > 1 and d.dims[0] >= p
    if alg == "psrs" and not eligible:
        raise ValueError(
            f"psrs requires a 1-D layout with >= 1 element per rank on > 1 "
            f"rank (n={d.dims[0]}, ranks={p})")
    key_dtype = _key_dtype(d, by)
    if key_dtype is None and alg == "psrs":
        raise ValueError(
            "psrs requires a `by` that works on torch tensors (omit alg= "
            "to use the exact host sorted(key=by))")
    if eligible and key_dtype is not None:  # dalint: disable=DAL010 — the key dtype comes from a probe call of by on a one-element tensor: the same dtype on every process
        pivots = _explicit_pivots(d, sample, by, key_dtype, rev, p)
        return _psrs_sort(d, rev, by, pivots)
    if key_dtype is not None:  # dalint: disable=DAL010 — the key dtype comes from a probe call of by on a one-element tensor: the same dtype on every process
        # one rank or a tiny vector: the pivots only balance the result,
        # so a valid strategy is checked and then has nothing to do
        _explicit_pivots(d, sample, by, key_dtype, rev, p,
                         validate_only=True)
        return _whole_sort(d, rev, by, pids)
    if sample is not True:
        raise ValueError(
            f"sample={sample!r} selects a distributed pivot strategy, but "
            "the given `by` is not a function on torch tensors, so the "
            "strategy can be neither applied nor validated; use "
            "sample=True")
    warn_once(f"dsort-host-{fn_site(by)}",
              f"dsort: `by` {fn_site(by)} does not work on torch tensors; "
              "gathering to host for an exact sorted(key=by)")
    vals = list(np.asarray(d))
    vals.sort(key=by, reverse=rev)
    host = torch.as_tensor(np.asarray(vals)).to(d.dtype) if vals else \
        torch.empty(0, dtype=d.dtype)
    return distribute(host, procs=pids)
