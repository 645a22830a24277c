"""Time three ways of stitching a DArray's rank pieces on the card into one
host tensor, the copy ``DArray.region`` makes for ``gather``,
``np.asarray`` and ``full("cpu")`` in the PyTorch port:

- ``loop``: each piece brought to the host, then copied into the output
  (``out[dst] = piece.to("cpu")``);
- ``copy_``: each piece copied from the card straight into its view of
  the output (``out[dst].copy_(piece)``);
- ``native``: every piece brought to the host, then stitched by the native
  host copier's threads (``utils/native.assemble``).

Each call allocates its output, as ``region`` does.  The ways run in turns,
after one warm call each, and must give the same bits.

Run on a machine with a CUDA card, from the repo root::

    python3 tools/host_gather_torch.py [--n 16384] [--reps 5]

Prints the card's name and power limit, then one JSON line of the
milliseconds of each way, per layout.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("host_gather_torch: no CUDA device", file=sys.stderr)
        return 1
    import distributedarrays_tpu_torch as tdat
    from distributedarrays_tpu_torch import layout as L
    from distributedarrays_tpu_torch.utils import native
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"native library available: {native.available()}, "
          f"{os.cpu_count()} host cores")
    tdat.init(nranks=4)
    n = args.n

    def pieces(d):
        return L.box_pieces(d.cuts, [(0, s) for s in d.dims])

    def loop(d):
        out = torch.empty(d.dims, dtype=d.dtype)
        for ci, src, dst in pieces(d):
            out[dst] = d._parts[ci][src].to("cpu")
        return out

    def copy_(d):
        out = torch.empty(d.dims, dtype=d.dtype)
        for ci, src, dst in pieces(d):
            out[dst].copy_(d._parts[ci][src])
        return out

    def assemble(d):
        out = torch.empty(d.dims, dtype=d.dtype)
        ps = pieces(d)
        native.assemble(out.numpy(), [
            d._parts[ci][src].to("cpu").contiguous().numpy()
            for ci, src, _ in ps],
            [tuple(s.start for s in dst) for _, _, dst in ps])
        return out

    ways = {"loop": loop, "copy_": copy_, "native": assemble}
    row = {}
    for dist in ((4, 1), (1, 4)):
        d = tdat.drand((n, n), dist=dist)
        ref = None
        for name, fn in ways.items():          # warm, and the same bits
            got = fn(d)
            if ref is None:
                ref = got
            elif not torch.equal(got, ref):
                raise AssertionError(f"{name} on {dist} disagrees")
        del ref, got
        times = {name: [] for name in ways}
        for _ in range(args.reps):
            for name, fn in ways.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(d)
                times[name].append((time.perf_counter() - t0) * 1e3)
                del out
        d.close()
        key = f"{dist[0]}x{dist[1]}"
        row[key] = {name: {"median_ms": statistics.median(ts), "ms": ts}
                    for name, ts in times.items()}
        print(f"{key} f32 {n}^2 to the host, median ms: " + ", ".join(
            f"{name} {statistics.median(ts)}" for name, ts in times.items())
            + f" ({smi})")
    print(json.dumps({"host_gather": row, "n": n, "dtype": "float32",
                      "gpu": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
