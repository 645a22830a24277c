"""The live telemetry plane: the calls that serving and training make.

PyTorch counterpart of the publishing calls of
``distributedarrays_tpu/telemetry/stream.py``: :func:`note` (its :745),
:func:`note_health`, :func:`poke` and :func:`stats`.  Each is a single
``is None`` check on the module's exporter hook, as in JAX, so a caller
pays nothing while no exporter is armed.

The exporter itself (JAX's ``StreamExporter``, which pushes frames to an
aggregator), ``start``/``stop`` and the ``DA_TPU_STREAM_AGG`` autostart are
not ported yet: they wait for the rest of ``telemetry/`` (ROADMAP queue A,
the runtime tier), so the hook stays ``None`` and every call returns at
once.
"""

from __future__ import annotations

__all__ = ["note", "note_health", "poke", "stats"]

# the armed exporter (an object with add_note/add_health/request_flush/
# stats_dict), None while nothing streams
_EXPORTER = None


def stats() -> dict:
    """The exporter's drop and lag counters, ``{"armed": False}`` when no
    exporter runs (a flight bundle carries it)."""
    exp = _EXPORTER
    if exp is None:
        return {"armed": False}
    return exp.stats_dict()


def note(name: str, value: float, **labels) -> None:
    """Publish one gauge point to the live plane with its own timestamp
    (every update, not the last a tick).  One check when unarmed."""
    exp = _EXPORTER
    if exp is None:
        return
    exp.add_note(name, value, labels)


def note_health(payload: dict) -> None:
    """Publish one health-sampler tick to the live plane.  One check when
    unarmed."""
    exp = _EXPORTER
    if exp is None:
        return
    exp.add_health(payload)
    exp.request_flush()


def poke() -> None:
    """Ask for an immediate frame flush.  One check when unarmed."""
    exp = _EXPORTER
    if exp is None:
        return
    exp.request_flush()
