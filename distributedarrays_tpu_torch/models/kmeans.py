"""Distributed k-means: Lloyd's algorithm over a row-distributed DArray.

PyTorch counterpart of ``distributedarrays_tpu/models/kmeans.py``
(``kmeans``, ``assign``, ``_kmeanspp_init``).  Each row block of the
``(n, dim)`` DArray is worked on by its row owner (the first rank of its
row of the pid grid; a block split over columns is first joined there):

- the nearest centroid by the distance expansion
  ``|x|^2 + |c|^2 - 2 <x, c>`` and ``argmin`` (first index on ties, as
  ``jnp.argmin``);
- the one-hot counts and sums ``onehot.T @ X`` of its rows;
- the ``(k, dim)`` sums and the counts are folded over the row owners with
  ``preduce``, the all-reduce GSPMD inserts in the JAX program.

Lloyd runs ``iters`` fixed steps with no early exit (JAX's ``lax.scan``).
The k-means++ seeding is JAX's numpy code call for call over the same
sample rows, so one ``seed`` gives a bit-equal ``C0`` in both packages.

In a job of several controller processes each process works on the row
blocks it owns (another process's are placeholders), the sample rows of
the seeding come from their owners by one cross-process ``pgather``, and
``preduce`` folds the sums and counts in rank order on every process, so
every process returns the same centroids, bit-equal to one process on
the same ranks.  Each process must own a row block.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import layout as L
from ..darray import DArray, darray_from_cuts, from_chunks
from ..layout import defaultdist_1d, device_of
from ..parallel import multihost
from ..parallel.collectives import pgather, preduce

__all__ = ["kmeans", "assign"]


def _nearest(X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Index of each row's nearest centroid (JAX ``kmeans.py:27``)."""
    x2 = torch.sum(X * X, dim=1, keepdim=True)
    c2 = torch.sum(C * C, dim=1)[None, :]
    return torch.argmin(x2 + c2 - 2.0 * (X @ C.T), dim=1)


def _row_blocks(d: DArray) -> list[tuple[int, torch.Tensor]]:
    """``(owner, rows)`` per row block of ``d``: the owner's own tensor when
    the grid has one column, else the block's columns joined on it (one
    ``fetch_regions`` call; in a job another process's blocks are
    placeholders)."""
    d._check_open()
    owners = [int(p) for p in d.pids.reshape(d.pids.shape[0], -1)[:, 0]]
    if d.pids.shape[1] == 1:
        return [(p, d._parts[i, 0]) for i, p in enumerate(owners)]
    c = d.cuts[0]
    return list(zip(owners, multihost.fetch_regions(
        [(d, ((c[i], c[i + 1]), (0, d.dims[1])), device_of(p))
         for i, p in enumerate(owners)])))


def _lloyd_step(blocks, C, k: int):
    """One Lloyd iteration over the row blocks; ``C`` on rank 0's device.
    Returns ``(C_new, shift)`` there."""
    parts = []
    for p, X in blocks:
        Cp = C.to(X.device)
        a = _nearest(X, Cp)
        onehot = F.one_hot(a, k).to(X.dtype)
        parts.append(torch.cat([onehot.T @ X,
                                torch.sum(onehot, dim=0)[:, None]], 1))
    acc = next(t for t in preduce(parts) if t.device.type != "meta") \
        .to(C.device)
    sums, counts = acc[:, :-1], acc[:, -1:]
    C_new = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0), C)
    return C_new, torch.sum((C_new - C) ** 2)


def kmeans(d: DArray, k: int, iters: int = 20, seed: int = 0):
    """Lloyd's algorithm on an ``(n, dim)`` DArray: ``(centroids (k, dim)
    tensor on rank 0's device (in a job, on this process's device), shifts
    per iteration as numpy)``.  The
    initial centroids are k-means++ picks from a sample of at most 4096
    rows drawn by ``seed``."""
    if d.ndim != 2:
        raise ValueError("kmeans expects an (n, dim) DArray")
    n = d.dims[0]
    if not (0 < k <= n):
        raise ValueError(f"need 0 < k <= n, got k={k}, n={n}")
    home = device_of(0)
    if home.type == "meta":
        home = L.local_device()
    if multihost.in_job() and not any(
            L.is_local(int(p)) for p in d.pids[:, 0]):
        raise ValueError("k-means in a job needs a row block of the DArray "
                         "on every process")
    C = torch.from_numpy(_kmeanspp_init(d, k, seed)).to(home, d.dtype)
    blocks = _row_blocks(d)
    shifts = []
    for _ in range(int(iters)):
        C, shift = _lloyd_step(blocks, C, k)
        shifts.append(shift)
    out = torch.stack(shifts).float().cpu().numpy() if shifts \
        else np.zeros(0, np.float32)
    return C, out


def _sample_rows(d: DArray, sel: np.ndarray) -> np.ndarray:
    """Rows ``sel`` (sorted) of ``d`` as float32 numpy, read from the row
    blocks that hold them (JAX: ``d.garray[sel]``) by one ``pgather``, so
    that in a job every process gets every owner's rows."""
    c = d.cuts[0]
    rows = []
    for i, (_, X) in enumerate(_row_blocks(d)):
        lo, hi = np.searchsorted(sel, [c[i], c[i + 1]])
        idx = torch.from_numpy(sel[lo:hi] - c[i]).to(X.device)
        rows.append(X.index_select(0, idx).float())
    # each owner's rows to every rank (in a job, every process), in block
    # order
    whole = next(t for t in pgather(rows) if t.device.type != "meta")
    return whole.cpu().numpy()


def _kmeanspp_init(d: DArray, k: int, seed: int) -> np.ndarray:
    """k-means++ seeding on a host sample of at most 4096 rows (JAX
    ``kmeans.py:75``, the same numpy calls in the same order)."""
    n = d.dims[0]
    rng = np.random.default_rng(seed)
    m = min(n, 4096)
    sel = np.sort(rng.choice(n, size=m, replace=False)) if m < n \
        else np.arange(n)
    S = np.asarray(_sample_rows(d, sel), np.float32)
    C = np.empty((k, S.shape[1]), np.float32)
    C[0] = S[rng.integers(m)]
    d2 = np.sum((S - C[0]) ** 2, axis=1)
    for j in range(1, k):
        s = float(d2.sum())
        if s > 0:
            C[j] = S[rng.choice(m, p=d2 / s)]
        else:
            # every remaining sample point coincides with a centroid
            C[j] = S[rng.integers(m)]
        d2 = np.minimum(d2, np.sum((S - C[j]) ** 2, axis=1))
    return C


def assign(d: DArray, centroids) -> DArray:
    """Nearest-centroid labels (int32) on the row owners, ``dist =
    [row blocks]`` on the default cuts over them (JAX ``kmeans.py:105``)."""
    C = torch.as_tensor(np.asarray(centroids)) \
        if not isinstance(centroids, torch.Tensor) else centroids
    blocks = _row_blocks(d)
    owners = [p for p, _ in blocks]
    labels = []
    for p, X in blocks:
        dt = torch.promote_types(X.dtype, C.dtype)
        labels.append(_nearest(X.to(dt), C.to(X.device, dt)).to(torch.int32))
    cuts = defaultdist_1d(d.dims[0], len(owners))
    if list(d.cuts[0]) == cuts:
        return from_chunks(labels, procs=owners)
    whole = torch.cat([x.to(device_of(owners[0])) for x in labels])
    return darray_from_cuts(whole, owners, [cuts])
