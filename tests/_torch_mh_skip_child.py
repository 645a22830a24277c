"""Child program of ``tests/test_torch_multihost.py``'s skipped-exchange
test: two processes of 4 CPU ranks each join a job whose store and gloo
group wait at most ``<timeout_s>``; process 0 enters a region call
(``DArray.full`` of a DArray spanning both processes) that process 1
skips.  The call must raise within the timeout, not hang.

Run as: python tests/_torch_mh_skip_child.py <store_file> <process_id> \
            <timeout_s>

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
multihost.sync_hosts("before")
if proc_id == 0:
    t0 = time.monotonic()
    try:
        d.full()
        print("SKIPPED_EXCHANGE_RETURNED", flush=True)
    except Exception as e:  # noqa: BLE001 — reported to the parent
        print(f"SKIPPED_EXCHANGE_RAISED {time.monotonic() - t0:.3f} "
              f"{type(e).__name__}", flush=True)
    with open(store_file + ".done", "w"):
        pass
else:
    deadline = time.monotonic() + 60
    while not os.path.exists(store_file + ".done") and \
            time.monotonic() < deadline:
        time.sleep(0.05)
os._exit(0)
