"""Runtime SPMD collective-divergence checker.

PyTorch counterpart of ``distributedarrays_tpu/analysis/divergence.py``
(its whole ``__all__``).  With ``DA_TPU_CHECK_DIVERGENCE=1`` each rank task
of a thread-backend ``spmd`` run records the eager collectives it issues
(op, participation metadata, payload signature), and every record is held
against the other ranks' records at the same index.  The first mismatch
(another op at the same slot, or a rank finishing while a peer is still
inside collective #k) aborts the run with a
:class:`CollectiveDivergenceError` carrying every rank's sequence, instead
of waiting out the receive timeout; it is also journaled
(``divergence``/``mismatch``) and bundled by the flight recorder.

Scope: the eager collectives of ``parallel.spmd_mode`` (``barrier``,
``bcast``, ``scatter``, ``gather_spmd``).  The rank-list collectives of
``parallel.collectives`` run once for all ranks on the controller and
cannot diverge.  The process backend is not instrumented.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Sequence

from .. import telemetry as _tm

__all__ = ["CollectiveDivergenceError", "DivergenceChecker", "checking",
           "payload_signature"]

_MAX_SHOWN = 16   # sequence entries displayed per rank in the error


def checking() -> bool:
    """Is divergence checking requested (``DA_TPU_CHECK_DIVERGENCE``)?

    Read per spmd() run, so tests can flip it with ``monkeypatch.setenv``.
    """
    val = os.environ.get("DA_TPU_CHECK_DIVERGENCE", "0").strip().lower()
    return val not in ("", "0", "false", "off")


class CollectiveDivergenceError(RuntimeError):
    """Ranks of one spmd() run issued non-identical collective sequences."""


def payload_signature(x) -> str:
    """Stable, cheap signature of a collective payload: a tensor gives
    ``Tensor(shape):dtype@device-type``, an array ``type(shape):dtype``;
    containers and scalars give the type name only (lengths left out:
    per-rank gather payloads may differ in size)."""
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        dev = getattr(getattr(x, "device", None), "type", None)
        where = f"@{dev}" if isinstance(dev, str) else ""
        return f"{type(x).__name__}{tuple(shape)}:{dtype}{where}"
    return type(x).__name__


class DivergenceChecker:
    """Per-run cross-rank collective sequence validator.

    Thread-safe: rank tasks call :meth:`record` as they issue collectives
    and :meth:`finish` on clean completion.  The first inconsistency
    raises in the offending thread, stores the error (``.error``) for the
    driver, and fires ``on_mismatch`` so blocked peers wake instead of
    waiting out their receive timeout.
    """

    def __init__(self, pids: Sequence[int],
                 on_mismatch: Callable[[], None] | None = None):
        self.pids = list(pids)
        self._lock = threading.Lock()
        self._seqs: dict[int, list[tuple[str, str]]] = {
            p: [] for p in self.pids}
        self._done: dict[int, int] = {}
        self._on_mismatch = on_mismatch
        self.error: CollectiveDivergenceError | None = None

    # -- recording ----------------------------------------------------------

    def record(self, rank: int, op: str, detail: str) -> None:
        """Rank ``rank`` is issuing collective ``op`` (``detail`` carries
        root/tag/shape metadata that must agree across ranks)."""
        entry = (op, detail)
        with self._lock:
            if self.error is not None:
                raise self.error
            seq = self._seqs[rank]
            idx = len(seq)
            seq.append(entry)
            for p, final in self._done.items():
                if p != rank and final <= idx:
                    self._fail(idx,
                               f"rank {rank} issued collective #{idx} "
                               f"({op}) but rank {p} already finished "
                               f"after {final} collective(s)")
            for p in self.pids:
                if p == rank:
                    continue
                other = self._seqs[p]
                if len(other) > idx and other[idx] != entry:
                    self._fail(idx,
                               f"rank {rank} issued {entry} at collective "
                               f"#{idx} where rank {p} issued "
                               f"{other[idx]}")

    def finish(self, rank: int) -> None:
        """Rank ``rank`` completed its program without error."""
        with self._lock:
            if self.error is not None:
                return   # a mismatch is already being reported
            final = len(self._seqs[rank])
            self._done[rank] = final
            for p in self.pids:
                if p != rank and len(self._seqs[p]) > final:
                    self._fail(final,
                               f"rank {rank} finished after {final} "
                               f"collective(s) but rank {p} already "
                               f"issued collective #{final} "
                               f"({self._seqs[p][final][0]})")

    def verify(self) -> None:
        """End-of-run backstop: all ranks' full sequences must be equal."""
        with self._lock:
            if self.error is not None:
                raise self.error
            ref_rank = self.pids[0]
            ref = self._seqs[ref_rank]
            for p in self.pids[1:]:
                if self._seqs[p] != ref:
                    i = next((k for k, (a, b) in
                              enumerate(zip(ref, self._seqs[p])) if a != b),
                             min(len(ref), len(self._seqs[p])))
                    self._fail(i, f"rank {p}'s collective sequence differs "
                                  f"from rank {ref_rank}'s")

    # -- failure path -------------------------------------------------------

    def _format_sequences(self) -> str:
        out = []
        for p in self.pids:
            seq = self._seqs[p]
            shown = seq[-_MAX_SHOWN:]
            skipped = len(seq) - len(shown)
            items = "; ".join(
                f"#{i + skipped} {op}({detail})"
                for i, (op, detail) in enumerate(shown)) or "(none)"
            head = f"... {skipped} earlier ...; " if skipped else ""
            state = (f"finished, {self._done[p]} total"
                     if p in self._done else "running")
            out.append(f"  rank {p} [{state}]: {head}{items}")
        return "\n".join(out)

    def _fail(self, index: int, why: str) -> None:
        # lock already held by the caller
        msg = (f"SPMD collective divergence at collective #{index}: {why}\n"
               f"per-rank collective sequences:\n{self._format_sequences()}\n"
               f"Every rank must issue the identical collective sequence — "
               f"on several controllers this program deadlocks. "
               f"(DA_TPU_CHECK_DIVERGENCE=0 disables this check.)")
        self.error = CollectiveDivergenceError(msg)
        if _tm.enabled():
            # telemetry instant: the mismatch shows up in Perfetto exports
            # at the moment of divergence (error path — cost irrelevant)
            _tm.event("divergence", "mismatch", index=index, why=why,
                      ranks=len(self.pids))
            # and the flight recorder dumps ONE postmortem bundle the
            # moment the divergence is detected — even if the caller
            # swallows the error before the spmd driver re-raises it
            # (record_crash dedups on the exception object, so the
            # driver's own crash hook won't bundle it twice)
            try:
                _tm.flight.record_crash(self.error, where="divergence")
            except Exception:
                pass
        if self._on_mismatch is not None:
            self._on_mismatch()
        raise self.error
