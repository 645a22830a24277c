"""The host cost of the port's memory ledger: what tracking a
DArray's rank tensors adds to the host-bound loops (the CG iteration, the
decode step) that construct and write DArrays.

    python tools/ledger_cost.py [cpu|cuda]

On one rank (of the CPU by default, or of the card) with a 64x64 float32
DArray it prints the best of five ``timeit`` rounds, in microseconds a
call, of the system calls and clocks a journal event reads
(``os.getpid``, ``time.time``, ``time.monotonic``), ``memory.track`` with
its ``untrack`` (a construction and a close), ``memory.relabel`` (an
in-place write), the bare ``hbm`` journal event, a ``with_parts``
construction and close with telemetry on and off, and ``fill_`` with
telemetry on and off.  These are host times, not device numbers.
"""

import os
import sys
import time
import timeit
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import distributedarrays_tpu_torch as tdat  # noqa: E402
from distributedarrays_tpu_torch import telemetry as tm  # noqa: E402
from distributedarrays_tpu_torch.telemetry import core, memory  # noqa: E402


def best_us(fn, n: int = 20000) -> float:
    return min(timeit.repeat(fn, number=n, repeat=5)) / n * 1e6


def main() -> None:
    device = sys.argv[1] if len(sys.argv) > 1 else "cpu"
    if device == "cpu":
        tdat.init(nranks=1, device="cpu")
    else:
        tdat.init(nranks=1)
    x = tdat.dzeros((64, 64))
    parts, pids = x._parts, x.pids
    owner = ("ledger_cost", 1)

    def track_untrack():
        memory.track(owner, parts, site="ctor", ranks=pids)
        memory.untrack(owner)

    rows = {"os.getpid": best_us(os.getpid),
            "time.time": best_us(time.time),
            "time.monotonic": best_us(time.monotonic)}
    tm.enable()
    rows["track + untrack"] = best_us(track_untrack)
    rows["relabel"] = best_us(lambda: memory.relabel(x.id, "fill_"))
    rows["hbm event"] = best_us(lambda: core.event(
        "hbm", "alloc", owner=str(owner), bytes=1, live=1, site="ctor"))
    for on in (True, False):
        (tm.enable if on else tm.disable)()
        state = "on" if on else "off"
        rows[f"construct + close, telemetry {state}"] = best_us(
            lambda: x.with_parts(parts).close())
        rows[f"fill_, telemetry {state}"] = best_us(lambda: x.fill_(1.0))
    tm.enable()
    x.close()
    for k, v in rows.items():
        print(f"{k}: {v:.2f} us")


if __name__ == "__main__":
    main()
