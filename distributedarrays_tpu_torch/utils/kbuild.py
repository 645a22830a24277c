"""Build and load the hand-written CUDA kernels, and count their launches.

Counterpart of the lazy native build in ``distributedarrays_tpu/utils/
native.py``.  At first use each ``csrc/<name>.cu`` is compiled by ``nvcc``
for Hopper (``sm_90a``) into a shared library with a plain C interface
under ``build/torch_kernels/`` and loaded with ``ctypes``.  The library's
file name carries a hash of the sources and flags, so editing a source
rebuilds it.  A failed build raises; nothing is downloaded and no library
kernel stands in.  Sources compile in parallel, one ``nvcc`` per file.
A source's compile-time constants that its Python wrapper also plans with
(``DEFINES``) are passed as ``-D`` flags, so each has one owner.

Each kernel wrapper calls ``count(name)`` exactly where it launches its
kernel, so a run can show that its main path went through the kernels.
A kernel with several routes also names the route it launched
(``count(name, route)``), counted apart in ``route_counts()``: the block
GEMM's, flash attention's (K5), the ring hop's (K8) and the backward's dq
(K6) and dk/dv (K7) ``wgmma``/``mma``/``f32``, the int8 GEMM's (K4)
``wgmma``/``mma`` (``INT8_ROUTES``), the single-step (K2) and multistep
(K3) stencils' ``generic``/``five_point`` (``STENCIL_ROUTES``), the fused
ring attention step's compute steps by route (a ring step that only
forwards its K/V pair, or only starts or finishes the carry, counts as a
launch and under no route), and every step of the ring GEMMs K13, K14 and
K15 by route (``RING_ROUTES``: those three and ``wgmma_peer``, wgmma with
the slot the step writes on another card).

``sm_count(device)`` is a card's SM count (cached), which the wrappers
use to size their grids.

``enable_peer_access(device, peer)`` lets one card read and write another's
memory (``cudaDeviceEnablePeerAccess``), which the collective kernels need
when ranks span several cards; ``layout.init`` calls it for every pair of
cards it maps ranks to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["build", "load", "count", "reset_launches", "launch_counts",
           "route_counts", "enable_peer_access", "sm_count", "KERNELS",
           "ROUTES", "RING_ROUTES", "INT8_ROUTES", "STENCIL_ROUTES",
           "NVCC_FLAGS", "DEFINES"]

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
_BUILD = _PKG.parent / "build" / "torch_kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

# compile-time constants a source takes from its wrapper, as -D flags: the
# single-step stencil's rows a thread, from which ops/cuda_stencil.py plans
# its grid
DEFINES = {"stencil": {"DA_STENCIL_STEP_ROWS": 8}}

# kernel name -> source file stem
KERNELS = {"gemm": "gemm", "stencil_step": "stencil",
           "stencil_multistep": "stencil", "matmul_int8": "gemm_int8",
           "all_gather": "collectives", "all_to_all": "collectives",
           "reduce_scatter": "collectives",
           "allgather_matmul": "collectives",
           "allgather_matmul_rhs": "collectives",
           "matmul_reducescatter": "collectives",
           "flash_attention": "attention", "flash_attention_hop": "attention",
           "ring_attention": "attention",
           "flash_attention_bwd_dq": "attention_bwd",
           "flash_attention_bwd_dkv": "attention_bwd"}

# the routes of the kernels that have several (see count), in the order of
# their C entries' route codes
ROUTES = ("f32", "mma", "wgmma")
# the ring all-gather GEMMs' routes, in the order of their route codes
RING_ROUTES = ROUTES + ("wgmma_peer",)
# the int8 GEMM's routes (codes as in ROUTES: it has no f32 route)
INT8_ROUTES = ("mma", "wgmma")
# the stencils' routes: generic taps, the 5-point specialisation
STENCIL_ROUTES = ("generic", "five_point")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_launches = {k: 0 for k in KERNELS}
_routes = {k: dict.fromkeys(ROUTES, 0)
           for k in ("gemm", "ring_attention", "flash_attention",
                     "flash_attention_hop", "flash_attention_bwd_dq",
                     "flash_attention_bwd_dkv")}
_routes["matmul_int8"] = dict.fromkeys(INT8_ROUTES, 0)
_routes.update({k: dict.fromkeys(STENCIL_ROUTES, 0)
                for k in ("stencil_step", "stencil_multistep")})
_routes.update({k: dict.fromkeys(RING_ROUTES, 0)
                for k in ("allgather_matmul", "allgather_matmul_rhs",
                          "matmul_reducescatter")})
_peers: set[tuple[int, int]] = set()
_sms: dict[int, int] = {}
build_log: dict[str, str] = {}


def count(kernel: str, route: str | None = None) -> None:
    """Add one launch of ``kernel``, and one of its ``route`` if given."""
    with _lock:
        _launches[kernel] += 1
        if route is not None:
            _routes[kernel][route] += 1


def reset_launches() -> None:
    with _lock:
        for k in _launches:
            _launches[k] = 0
        for r in _routes.values():
            for k in r:
                r[k] = 0


def launch_counts() -> dict[str, int]:
    with _lock:
        return dict(_launches)


def route_counts() -> dict[str, dict[str, int]]:
    """Launches of each route of the block GEMM, the int8 GEMM, the two
    stencils, flash attention, the ring hop, the backward's dq
    and dk/dv passes, the ring attention step and the ring GEMMs."""
    with _lock:
        return {k: dict(v) for k, v in _routes.items()}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def _flags(stem: str) -> list[str]:
    return NVCC_FLAGS + [f"-D{k}={v}"
                         for k, v in sorted(DEFINES.get(stem, {}).items())]


def _so_path(stem: str) -> Path:
    h = hashlib.sha256(" ".join(_flags(stem)).encode())
    for f in sorted(_CSRC.glob("*.cuh")) + [_CSRC / f"{stem}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return _BUILD / f"lib{stem}-{h.hexdigest()[:16]}.so"


def build(stems=None) -> dict[str, Path]:
    """Compile the given source stems (all by default) that are not built
    yet, all ``nvcc`` processes at once; raise on any failure."""
    stems = sorted(set(KERNELS.values()) if stems is None else set(stems))
    todo = {s: _so_path(s) for s in stems}
    procs = {}
    for s, so in todo.items():
        if so.exists():
            continue
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp.so")
        procs[s] = (subprocess.Popen(
            [_nvcc(), *_flags(s), "-o", str(tmp), str(_CSRC / f"{s}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, so)
    failed = []
    for s, (p, tmp, so) in procs.items():
        out, _ = p.communicate()
        build_log[s] = out
        if p.returncode != 0:
            failed.append(f"{s}.cu (nvcc exit {p.returncode}):\n{out}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return todo


def load(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(stem)
    if lib is None:
        so = build([stem])[stem]
        lib = ctypes.CDLL(str(so))
        with _lock:
            _libs[stem] = lib
    return lib


def sm_count(device) -> int:
    """The number of SMs of CUDA device ``device`` (a torch.device)."""
    n = _sms.get(device.index)
    if n is None:
        import torch
        n = _sms[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def enable_peer_access(device: int, peer: int) -> None:
    """Let CUDA device ``device`` access ``peer``'s memory; raise when the
    two cards cannot reach each other."""
    device, peer = int(device), int(peer)
    if device == peer:
        return
    with _lock:
        if (device, peer) in _peers:
            return
    fn = load("collectives").da_enable_peer
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    rc = fn(device, peer)
    if rc != 0:
        raise RuntimeError(f"cannot enable peer access from cuda:{device} to "
                           f"cuda:{peer}: CUDA error {rc}")
    with _lock:
        _peers.add((device, peer))
