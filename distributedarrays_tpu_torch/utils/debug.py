"""Warnings for the documented host degradations.

The port's own copy of ``warn_once`` and ``_fn_site`` from
``distributedarrays_tpu/utils/debug.py`` and ``ops/mapreduce.py``, with
JAX's telemetry: every call counts ``fallback.hits{key}`` and the first of
each key is journaled as a ``fallback`` event (``debug.py:46-51``).
"""

from __future__ import annotations

import os
import threading
import warnings

from .. import telemetry

__all__ = ["warn_once", "fn_site"]

_warned: set = set()
_warned_lock = threading.Lock()


def warn_once(key: str, msg: str, stacklevel: int = 3) -> None:
    """Emit ``msg`` as a RuntimeWarning the first time ``key`` is seen in
    this process: an op that takes its documented host path says so once
    instead of silently costing time.  Every call counts
    ``fallback.hits`` under its key; the first is journaled."""
    telemetry.count("fallback.hits", key=key)
    with _warned_lock:
        if key in _warned:
            return
        _warned.add(key)
    telemetry.event("fallback", key, message=msg)
    warnings.warn(msg, RuntimeWarning, stacklevel=stacklevel)


def fn_site(fn) -> str:
    """A callable's name and definition site, so two lambdas never share
    one ``warn_once`` key."""
    name = getattr(fn, "__name__", None) or repr(fn)
    code = getattr(fn, "__code__", None)
    if code is not None:
        return (f"{name}@{os.path.basename(code.co_filename)}:"
                f"{code.co_firstlineno}")
    return name
