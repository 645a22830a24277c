"""Child program of ``tests/test_torch_multihost.py``'s skipped-exchange
test: two processes of 4 CPU ranks each join a job whose store and gloo
group wait at most ``<timeout_s>``; process 0 enters a collective call
that process 1 skips: a region call (``DArray.full`` of a DArray spanning
both processes; ``<what>`` ``region``, the default), a rank-list
collective (a ``pshift`` inside ``run_spmd`` over every rank; ``<what>``
``pshift``), or one step of a ring GEMM (``allgather_matmul`` over every
rank, whose steps are one exchange each; ``<what>`` ``ring_gemm``: process
1 takes the first step and skips the second).  The call must raise within
the timeout, not hang.

Run as: python tests/_torch_mh_skip_child.py <store_file> <process_id> \
            <timeout_s> [<what>]

Process 0 prints ``SKIPPED_EXCHANGE_RAISED <seconds> <error type>`` (or
``SKIPPED_EXCHANGE_RETURNED``) and writes ``<store_file>.done``; process 1
waits for that file (at most 60 s) and exits.  Both leave without the
job's closing barrier.
"""

import os
import sys
import time

store_file, proc_id, timeout_s = sys.argv[1], int(sys.argv[2]), \
    int(sys.argv[3])
what = sys.argv[4] if len(sys.argv) > 4 else "region"

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

import distributedarrays_tpu_torch as tdat  # noqa: E402
from distributedarrays_tpu_torch.parallel import multihost  # noqa: E402

multihost.initialize(f"file://{store_file}", 2, proc_id,
                     initialization_timeout_s=timeout_s)
tdat.init(nranks=4, device="cpu")
d = tdat.distribute(np.arange(64, dtype=np.float32).reshape(16, 4))
assert tdat.layout.spans_processes(d.pids)


def ring_gemm(d):
    """K13's ring (the plain one over gloo) on the cells of ``d``: each
    step's hop is one exchange."""
    def body(cells):
        b = [row[0] for row in cells]            # the (8, 1) grid's cells
        return tdat.collective_matmul.allgather_matmul(
            [x[:2] for x in b], [x.t() @ x for x in b])
    tdat.run_spmd(body, d.pids.tolist(), d)


multihost.sync_hosts("before")
if proc_id == 0:
    t0 = time.monotonic()
    try:
        if what == "pshift":
            tdat.run_spmd(lambda b: tdat.pshift(b, 1), d.pids.tolist(), d)
        elif what == "ring_gemm":
            ring_gemm(d)
        else:
            d.full()
        print("SKIPPED_EXCHANGE_RETURNED", flush=True)
    except Exception as e:  # noqa: BLE001 — reported to the parent
        print(f"SKIPPED_EXCHANGE_RAISED {time.monotonic() - t0:.3f} "
              f"{type(e).__name__}", flush=True)
    with open(store_file + ".done", "w"):
        pass
else:
    if what == "ring_gemm":
        # take the ring's first step, then skip the second step's exchange
        class Skipped(Exception):
            pass
        calls, exchange = [], multihost.exchange

        def once(*a, **k):
            calls.append(1)
            if len(calls) > 1:
                raise Skipped
            return exchange(*a, **k)
        multihost.exchange = once
        try:
            ring_gemm(d)
        except Skipped:
            pass
    deadline = time.monotonic() + 60
    while not os.path.exists(store_file + ".done") and \
            time.monotonic() < deadline:
        time.sleep(0.05)
os._exit(0)
