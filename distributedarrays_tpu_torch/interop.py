"""Carry a DArray's state across from, and back to, the JAX package.

A distributed-array library has no weights; what crosses between the two
packages is an array with its layout.  The state is plain numpy and
Python, so neither package imports the other::

    {"array": ndarray, "cuts": [[...], ...], "pids": ndarray}

A test builds it from a JAX ``DArray`` as
``{"array": np.asarray(d), "cuts": d.cuts, "pids": d.pids}``.

The flagship transformer's weights cross the same way, as the JAX
parameter pytree turned into numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``): ``params_from_reference``
builds the port's ``Transformer`` from it and ``params_to_reference`` gives
it back (float32 arrays, which hold bfloat16 values exactly; numpy has no
bfloat16).  The sequence-parallel transformer's parameters are the same
pytree: they cross through ``params_from_reference`` followed by
``sp_transformer.shard_params``.

A trainer's initial parameters cross the same way: ``train.Trainer`` draws
them from ``task.init_params(generator)``, so a test replaces a port
task's ``init_params`` (``dataclasses.replace``) with one that returns the
JAX task's initial pytree as tensors.
"""

from __future__ import annotations

import numpy as np

import torch

from .darray import DArray, _scatter, as_tensor

__all__ = ["from_reference", "to_reference", "params_from_reference",
           "params_to_reference"]

_BLOCK_KEYS = ("ln1", "qkv", "proj", "ln2", "w1", "w2")


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


def params_from_reference(np_params: dict, cfg, device=None):
    """The port's ``Transformer`` for ``cfg`` holding the JAX parameter
    pytree ``np_params`` (numpy arrays of any float type), cast to
    ``cfg.dtype`` on ``device`` (default: rank 0's device)."""
    from .models.transformer import Transformer
    if device is None:
        from .layout import device_of
        device = device_of(0)
    model = Transformer(cfg, device)
    if len(np_params["blocks"]) != cfg.layers:
        raise ValueError(f"{len(np_params['blocks'])} blocks for a config of "
                         f"{cfg.layers} layers")

    def put(p: torch.Tensor, x) -> None:
        x = np.array(x, np.float32)          # a writable copy
        if x.shape != tuple(p.shape):
            raise ValueError(f"parameter shape {x.shape}, expected "
                             f"{tuple(p.shape)}")
        p.copy_(torch.from_numpy(x).to(p.dtype))

    with torch.no_grad():
        for name in ("embed", "pos", "ln_f", "head"):
            put(getattr(model, name), np_params[name])
        for blk, ref in zip(model.blocks, np_params["blocks"]):
            for name in _BLOCK_KEYS:
                put(getattr(blk, name), ref[name])
    return model


def params_to_reference(model) -> dict:
    """The JAX parameter pytree layout of ``model``'s weights, as float32
    numpy arrays."""
    def arr(p: torch.Tensor) -> np.ndarray:
        return p.detach().float().cpu().numpy()

    out = {name: arr(getattr(model, name))
           for name in ("embed", "pos", "ln_f", "head")}
    out["blocks"] = [{name: arr(getattr(b, name)) for name in _BLOCK_KEYS}
                     for b in model.blocks]
    return out
