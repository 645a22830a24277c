"""Tracing and profiling utilities.

PyTorch counterpart of ``distributedarrays_tpu/utils/profiling.py``:

- ``trace(dir)``: a context manager capturing a ``torch.profiler`` trace
  (CPU activity, and CUDA activity where a card is visible) of the
  enclosed block, written to ``dir`` as a Chrome trace
  (``trace_<pid>_<n>.json``, viewable in Perfetto or ``chrome://tracing``);
  the capture is journaled (``profile``/``trace_start``,
  ``trace_stop`` with the file) so a telemetry report names the trace that
  covers it.  The trace holds every kernel launch by name, the port's own
  ``da_*`` kernels among them.
- ``annotate(name)``: one named span on every timeline: a telemetry span,
  a ``torch.profiler.record_function`` range and, on the card, an NVTX
  range.
- ``OpTimer``: accumulating wall-clock accounting of host phases, each a
  telemetry span; the device is synchronized before each clock read, so a
  phase's time includes the kernels it launched.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from collections import defaultdict

import torch

from .. import telemetry as _tm

__all__ = ["trace", "annotate", "OpTimer"]

_seq = itertools.count()


def _activities() -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the enclosed block into
    ``log_dir`` as a Chrome trace; yields the profiler (its
    ``key_averages()`` and ``events()`` are readable after the block).
    The path of the written file is the profiler's ``trace_path``
    attribute."""
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{next(_seq)}.json")
    if _tm.enabled():
        _tm.event("profile", "trace_start", dir=str(log_dir))
    prof = torch.profiler.profile(activities=_activities())
    prof.trace_path = path
    with prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    if _tm.enabled():
        _tm.event("profile", "trace_stop", dir=str(log_dir), path=path)


@contextlib.contextmanager
def annotate(name: str):
    """A named range on every timeline: the telemetry journal (a span; comm
    and events inside are attributed to it), the ``torch.profiler`` trace
    (``record_function``) and, with a card, NVTX."""
    nvtx = torch.cuda.is_available()
    with _tm.span(name, src="annotate"):
        with torch.profiler.record_function(name):
            if nvtx:
                torch.cuda.nvtx.range_push(name)
            try:
                yield
            finally:
                if nvtx:
                    torch.cuda.nvtx.range_pop()


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class OpTimer:
    """Accumulating wall-clock timer for host phases, each timed to the
    completion of the device work it queued.

    >>> t = OpTimer()
    >>> with t("distribute"): d = distribute(A)
    >>> t.report()
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str):
        _sync()
        t0 = time.perf_counter()
        try:
            # a real telemetry span: the phase nests under whatever span is
            # open, shows in the Perfetto export and owns its comm bytes
            with _tm.span(name, src="optimer"):
                yield
                _sync()
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            _tm.observe(f"optimer.{name}", dt)

    def report(self) -> dict:
        return {k: {"total_s": self.totals[k], "calls": self.counts[k],
                    "mean_s": self.totals[k] / self.counts[k]}
                for k in sorted(self.totals)}
