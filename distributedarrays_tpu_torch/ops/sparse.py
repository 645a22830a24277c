"""Sparse extension: ``dnnz`` and ``ddata_bcoo``.

PyTorch counterpart of ``distributedarrays_tpu/ops/sparse.py`` (the
reference's ``ext/SparseArraysExt.jl``).  ``dnnz`` of a DArray is a
``count_nonzero`` on each rank's device, summed on the host, the
reference's ``nnz``: the sum of every worker's ``nnz(localpart)``.
``ddata_bcoo`` holds each rank's chunk as a coalesced torch sparse COO
tensor on that rank's device, in a ``DData``: the counterpart of the JAX
package's one BCOO matrix a rank.  ``dnnz`` of such a ``DData`` sums its
parts' stored entries.  In a job of several controller processes each
process counts its own chunks (or parts) and the counts are summed over
the job, so every process gets the whole count; ``ddata_bcoo`` holds the
sparse parts of this process's ranks.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import layout as L
from ..darray import DArray, DData, SubDArray, as_tensor
from ..parallel import multihost

__all__ = ["dnnz", "ddata_bcoo"]


def _count(part) -> int:
    if isinstance(part, torch.Tensor):
        if part.layout == torch.sparse_coo:
            return int(part._nnz())
        return int(torch.count_nonzero(part))
    return int(np.count_nonzero(np.asarray(part)))


def dnnz(d) -> int:
    """The number of stored or nonzero entries: each rank's
    ``count_nonzero`` summed on the host for a DArray; each part's stored
    entries (``_nnz()`` of a sparse part, the nonzeros of a dense one)
    for a ``DData``."""
    if isinstance(d, DData):
        if L.spans_processes(d.pids):
            mine = sum(_count(v) for p, v in d._parts.items()
                       if L.is_local(p))
            return sum(multihost._all_gather_objects(mine))
        return sum(_count(part) for part in d.gather())
    if isinstance(d, DArray):
        d._check_open()
        return sum(multihost.cell_values(d, lambda ci: _count(d.part(ci))))
    if isinstance(d, SubDArray):
        return _count(d.materialize())
    return _count(d if isinstance(d, torch.Tensor) else as_tensor(d))


def ddata_bcoo(d: DArray) -> DData:
    """Each rank's chunk as a coalesced sparse COO tensor on its device,
    held in a ``DData`` over ``d``'s ranks."""
    pids = [int(p) for p in d.pids.flat]
    parts = {p: d.localpart(p).to_sparse().coalesce() for p in pids
             if L.is_local(p)}
    return DData(parts, pids)
