"""Time the host cost of the PyTorch port's elementwise entry points on the
CPU: ``dmap(lambda a, b: a * b + a, A, B)`` and the operator chain
``A + B * C`` on float32 DArrays of 8 CPU ranks, each call timed on its
own, and the median of each printed.  Every call runs the port's
user-function layer (``ops/broadcast.py`` ``call_user``) once a rank, so
this is its cost on the main path's dtype.

Run from the repo root, with ROOT the checkout to import (this one by
default), so that two trees can be timed in turns::

    python3 tools/host_cost_user_fn.py [ROOT] [--n 64] [--calls 2000]

Prints one JSON line: the medians in microseconds a call.
"""

import argparse
import json
import os
import statistics
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--calls", type=int, default=2000)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    import distributedarrays_tpu_torch as tdat
    torch.set_num_threads(1)
    tdat.init(nranks=8, device="cpu")
    gen = torch.Generator().manual_seed(0)
    A, B, C = (tdat.distribute(torch.rand((args.n, args.n), generator=gen))
               for _ in range(3))

    def fma(a, b):
        return a * b + a

    def timed(call) -> float:
        """The median microseconds of ``call``, which returns the DArrays it
        made (closed after the clock stops)."""
        out = []
        for _ in range(args.calls):
            t0 = time.perf_counter()
            made = call()
            out.append(time.perf_counter() - t0)
            for d in made:
                d.close()
        return statistics.median(out) * 1e6

    def chain():
        t = B * C
        return t, A + t
    timed(lambda: [tdat.dmap(fma, A, B)])          # warm
    res = {"root": os.path.abspath(args.root), "n": args.n,
           "calls": args.calls,
           "dmap_us": timed(lambda: [tdat.dmap(fma, A, B)]),
           "chain_us": timed(chain)}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
