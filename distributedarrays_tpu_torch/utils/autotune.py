"""Tuning registry: kernel -> key -> chosen configuration, with sweeps,
persistence, provenance and undo.

PyTorch counterpart of ``distributedarrays_tpu/utils/autotune.py``
(``key_for``, ``device_key_for``, ``get``, ``record``, ``clear``,
``sweep``, ``save``, ``load``, ``default_cache_path``, ``save_default``,
``valid_ints``, ``provenance_for``, ``provenance_table``, ``undo``,
``undo_log``):

- the registry maps ``(kernel, key) -> config``; keys made by
  ``device_key_for`` end with rank 0's device type and name (``cuda|NVIDIA
  H100 80GB HBM3``, or ``cpu|cpu``), so a winner measured on one device
  never drives dispatch on another;
- ``sweep`` times candidates with an injectable timer and records the
  best so far after every candidate (``persist=True`` also writes the
  cache file each time it improves);
- the cache file is this package's own: ``DAT_TORCH_AUTOTUNE_CACHE``, else
  ``AUTOTUNE_CACHE_TORCH.json`` beside the package, loaded lazily on the
  first lookup and written only by ``save``/``save_default``/``sweep(...,
  persist=True)``.  Nothing is seeded from the JAX package's
  ``AUTOTUNE_SEED.json``: its keys name TPU devices;
- a write with ``provenance`` is stamped in a sidecar (persisted under
  ``__provenance__``) and journaled in a bounded undo log, which ``undo``
  rolls back exactly.

Lookups count ``autotune.hit`` / ``autotune.miss`` by kernel, as in JAX.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Callable, Iterable, Mapping

import torch

from .. import telemetry as _tm

__all__ = ["key_for", "device_key_for", "get", "record", "clear", "sweep",
           "save", "load", "default_cache_path", "save_default",
           "valid_ints", "provenance_for", "provenance_table", "undo",
           "undo_log"]

_LOCK = threading.RLock()
_REGISTRY: dict[str, dict[str, Any]] = {}
_LOADED_ENV = False
_PROV_KEY = "__provenance__"
_PROVENANCE: dict[str, dict[str, dict]] = {}
_UNDO_LIMIT = 64
_UNDO: list[dict] = []


def key_for(*parts) -> str:
    """Canonical string key from shape/dtype/flag parts."""
    return "|".join(str(p) for p in parts)


def device_key_for(*parts) -> str:
    """``key_for`` with rank 0's device type and name appended."""
    from ..layout import device_of
    dev = device_of(0)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
    return key_for(*parts, dev.type, name)


def valid_ints(entry, lengths: tuple[int, ...]):
    """``entry`` as a tuple of positive ints of an accepted length, or None
    (a stale or hand-edited entry falls back to the caller's default)."""
    if not isinstance(entry, (list, tuple)):
        return None
    try:
        vals = [int(x) for x in entry]
        if len(vals) in lengths and all(v > 0 for v in vals):
            return tuple(vals)
    except Exception:  # noqa: BLE001 — a malformed entry is no entry
        pass
    return None


def default_cache_path() -> str:
    """``DAT_TORCH_AUTOTUNE_CACHE`` if set, else
    ``AUTOTUNE_CACHE_TORCH.json`` in the directory that holds the
    package."""
    env = os.environ.get("DAT_TORCH_AUTOTUNE_CACHE")
    if env:
        return env
    return os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "AUTOTUNE_CACHE_TORCH.json")


def save_default() -> str:
    """Persist the registry to ``default_cache_path()``; returns the path."""
    path = default_cache_path()
    save(path)
    return path


def _maybe_load_env():
    global _LOADED_ENV
    if _LOADED_ENV:
        return
    _LOADED_ENV = True
    path = default_cache_path()
    if os.path.exists(path):
        try:
            load(path)
        except Exception:  # noqa: BLE001 — a bad cache never breaks dispatch
            pass


_MISS = object()


def get(kernel: str, key: str, default=None):
    """The configuration recorded for ``(kernel, key)``, or ``default``."""
    with _LOCK:
        _maybe_load_env()
        entry = _REGISTRY.get(kernel, {}).get(key, _MISS)
    if entry is _MISS:
        _tm.count("autotune.miss", kernel=kernel)
        if _tm.enabled():
            _tm.event("autotune", "miss", kernel=kernel, key=key,
                      once_key=f"autotune:miss:{kernel}:{key}")
        return default
    _tm.count("autotune.hit", kernel=kernel)
    return entry


def record(kernel: str, key: str, config, *,
           provenance: Mapping | None = None) -> None:
    """Store ``config`` for ``(kernel, key)``.  With ``provenance`` the
    write is stamped and journaled for :func:`undo`; a plain write drops a
    stale stamp."""
    with _LOCK:
        _maybe_load_env()
        entries = _REGISTRY.setdefault(kernel, {})
        if provenance is not None:
            _UNDO.append({
                "kernel": kernel, "key": key,
                "had_prev": key in entries,
                "prev": entries.get(key),
                "prev_provenance": _PROVENANCE.get(kernel, {}).get(key),
                "config": config,
                "provenance": dict(provenance),
            })
            del _UNDO[:-_UNDO_LIMIT]
            _PROVENANCE.setdefault(kernel, {})[key] = dict(provenance)
        else:
            _PROVENANCE.get(kernel, {}).pop(key, None)
        entries[key] = config


def provenance_for(kernel: str, key: str) -> dict | None:
    """The provenance stamp of ``(kernel, key)``, or None."""
    with _LOCK:
        _maybe_load_env()
        prov = _PROVENANCE.get(kernel, {}).get(key)
        return dict(prov) if prov is not None else None


def provenance_table() -> dict[str, dict[str, dict]]:
    """Every provenance stamp (kernel -> key -> stamp)."""
    with _LOCK:
        _maybe_load_env()
        return {k: {key: dict(p) for key, p in v.items()}
                for k, v in _PROVENANCE.items() if v}


def undo_log() -> list[dict]:
    """The bounded undo journal, oldest first."""
    with _LOCK:
        return [dict(e) for e in _UNDO]


def undo(kernel: str, key: str) -> bool:
    """Roll back the latest provenance-stamped write of ``(kernel, key)``
    to the exact state before it (no entry, when there was none).  False
    when the journal holds no such write."""
    with _LOCK:
        _maybe_load_env()
        for i in range(len(_UNDO) - 1, -1, -1):
            e = _UNDO[i]
            if e["kernel"] != kernel or e["key"] != key:
                continue
            del _UNDO[i]
            entries = _REGISTRY.setdefault(kernel, {})
            if e["had_prev"]:
                entries[key] = e["prev"]
            else:
                entries.pop(key, None)
            if e["prev_provenance"] is not None:
                _PROVENANCE.setdefault(kernel, {})[key] = \
                    dict(e["prev_provenance"])
            else:
                _PROVENANCE.get(kernel, {}).pop(key, None)
            restored = e["prev"] if e["had_prev"] else None
            break
        else:
            return False
    _tm.count("autotune.undo", kernel=kernel)
    if _tm.enabled():
        _tm.event("autotune", "undo", kernel=kernel, key=key,
                  restored=restored)
    return True


def clear() -> None:
    """Forget every recorded configuration, stamp and undo entry."""
    with _LOCK:
        _REGISTRY.clear()
        _PROVENANCE.clear()
        del _UNDO[:]


def save(path: str) -> None:
    """Write the registry (and the provenance sidecar) to ``path`` as
    JSON, atomically."""
    with _LOCK:
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        data: dict[str, Any] = dict(_REGISTRY)
        prov = {k: v for k, v in _PROVENANCE.items() if v}
        if prov:
            data[_PROV_KEY] = prov
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=2, sort_keys=True)
        os.replace(tmp, path)


def load(path: str) -> None:
    """Merge the registry saved at ``path`` into this one."""
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict):
        raise ValueError(f"autotune cache {path} is not a JSON object")
    with _LOCK:
        prov = data.pop(_PROV_KEY, None)
        if isinstance(prov, dict):
            for kernel, stamps in prov.items():
                if isinstance(stamps, dict):
                    _PROVENANCE.setdefault(kernel, {}).update(
                        {k: dict(v) for k, v in stamps.items()
                         if isinstance(v, dict)})
        for kernel, entries in data.items():
            if kernel.startswith("__"):
                continue   # reserved sidecar namespaces, never entries
            _REGISTRY.setdefault(kernel, {}).update(entries)


def sweep(kernel: str, key: str, candidates: Iterable,
          timer: Callable[[Any], float], record_best: bool = True,
          persist: bool = False) -> tuple[Any, Mapping[Any, float]]:
    """Time every candidate with ``timer(config) -> seconds`` (lower is
    better), record the best so far after every candidate (and with
    ``persist`` write the cache file when it improves), and return
    ``(best, {config: seconds})``.  A candidate whose timer raises is
    skipped; when all do, the last exception propagates."""
    results: dict[Any, float] = {}
    last_exc = None
    best = None
    with _tm.span("autotune.sweep", kernel=kernel):
        for cfg in candidates:
            try:
                with _tm.span("autotune.candidate", _journal=False):
                    results[cfg] = float(timer(cfg))
            except Exception as e:  # noqa: BLE001 — an invalid candidate
                last_exc = e
                continue
            if best is None or results[cfg] < results[best]:
                best = cfg
                if record_best:
                    record(kernel, key, best)
                    if persist:
                        save_default()
        if not results:
            raise last_exc if last_exc is not None else \
                ValueError("sweep got no candidates")
        _tm.count("autotune.sweeps", kernel=kernel)
        _tm.event("autotune", "sweep", kernel=kernel, key=key,
                  candidates=len(results), best=best,
                  best_s=results[best])
    return best, results
