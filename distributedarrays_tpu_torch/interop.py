"""Carry a DArray's state across from, and back to, the JAX package.

A distributed-array library has no weights; what crosses between the two
packages is an array with its layout.  The state is plain numpy and
Python, so neither package imports the other::

    {"array": ndarray, "cuts": [[...], ...], "pids": ndarray}

A test builds it from a JAX ``DArray`` as
``{"array": np.asarray(d), "cuts": d.cuts, "pids": d.pids}``.
"""

from __future__ import annotations

import numpy as np

from .darray import DArray, _scatter, as_tensor

__all__ = ["from_reference", "to_reference"]


def from_reference(state: dict) -> DArray:
    """A DArray with exactly the given layout (cuts and rank grid) holding
    ``state["array"]`` (64-bit types narrowed as ``distribute`` does)."""
    t = as_tensor(np.ascontiguousarray(state["array"]))
    cuts = [[int(x) for x in c] for c in state["cuts"]]
    pids = np.asarray(state["pids"], dtype=np.int64)
    if tuple(t.shape) != tuple(c[-1] for c in cuts):
        raise ValueError(f"array shape {tuple(t.shape)} does not match the "
                         f"cuts' extents {[c[-1] for c in cuts]}")
    return DArray(_scatter(t, pids, cuts), pids, cuts)


def to_reference(d: DArray) -> dict:
    """The state of ``d``: its gathered values, cuts and rank grid."""
    return {"array": np.asarray(d), "cuts": [list(c) for c in d.cuts],
            "pids": d.pids.copy()}
