"""In-memory tuning registry: kernel -> key -> chosen configuration.

PyTorch counterpart of ``key_for``/``device_key_for``/``get``/``record`` in
``distributedarrays_tpu/utils/autotune.py``.  The table is this package's
own and lives in memory only; nothing is seeded from the JAX package's
``AUTOTUNE_SEED.json``, whose keys name TPU devices.  Keys end with the
device of rank 0 (``cuda|NVIDIA H100 80GB HBM3``, or ``cpu|cpu``) so a
winner measured on one device never drives dispatch on another.
"""

from __future__ import annotations

import threading

import torch

__all__ = ["key_for", "device_key_for", "get", "record", "clear"]

_LOCK = threading.Lock()
_REGISTRY: dict[str, dict[str, object]] = {}


def key_for(*parts) -> str:
    """Canonical string key from shape/dtype/flag parts."""
    return "|".join(str(p) for p in parts)


def device_key_for(*parts) -> str:
    """``key_for`` with rank 0's device type and name appended."""
    from ..layout import device_of
    dev = device_of(0)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
    return key_for(*parts, dev.type, name)


def get(kernel: str, key: str, default=None):
    """The configuration recorded for ``(kernel, key)``, or ``default``."""
    with _LOCK:
        return _REGISTRY.get(kernel, {}).get(key, default)


def record(kernel: str, key: str, config) -> None:
    """Store ``config`` for ``(kernel, key)``."""
    with _LOCK:
        _REGISTRY.setdefault(kernel, {})[key] = config


def clear() -> None:
    """Forget every recorded configuration."""
    with _LOCK:
        _REGISTRY.clear()
