"""ctypes bindings for the native host copier (``csrc/chunkcopy.cpp``).

PyTorch counterpart of ``distributedarrays_tpu/utils/native.py``, with the
port's own copy of ``native/chunkcopy.cpp`` beside its kernel sources.  The
C++ side copies per-rank chunks into one row-major host array (and back)
with one thread a chunk; the port calls it where it stitches chunks that
are already on the host into one numpy array: the checkpoint's peer-replica
restore.  This is a host copy, not a device kernel.  ``DArray.region`` onto
the CPU (``gather``, ``np.asarray``, ``full(cpu)``) does not use it: each
piece is copied from its rank's device straight into its view of the
output, which on an H100 80GB HBM3 at 700 W read 447 ms for a 16384² f32
(4,1) array against 681 ms through this copier (every piece brought to the
host first) and 663 ms for a copy through a host temporary
(``tools/host_gather_torch.py``, medians of 5).

The library is compiled by ``g++`` at first use into
``build/native_torch/`` (the file name carries a hash of the source, so an
edit rebuilds it) and bound with ``ctypes``.  Every caller keeps the numpy
path: without ``g++`` (or when the build fails) the copy is numpy slicing,
said once through ``warn_once``; ``worth_using`` engages the native path
only where thread-parallel copies can win.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from .debug import warn_once

__all__ = ["available", "assemble", "scatter_chunks", "worth_using",
           "MIN_BYTES"]

_PKG = Path(__file__).resolve().parents[1]
_SRC = _PKG / "csrc" / "chunkcopy.cpp"
_BUILD = _PKG.parent / "build" / "native_torch"
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

# the least bytes a copy must move for the threads to beat numpy's serial
# memcpy (JAX's threshold)
MIN_BYTES = 32 * 1024 * 1024

_lock = threading.Lock()
_lib = None
_tried = False


def _so_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode())
    return _BUILD / f"libchunkcopy_{h.hexdigest()[:16]}.so"


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        gxx = shutil.which("g++")
        if gxx is None:
            warn_once("native:no_gxx", "native: no g++ on PATH; host chunk "
                      "copies take the numpy path")
            return None
        try:
            so = _so_path()
            if not so.exists():
                _BUILD.mkdir(parents=True, exist_ok=True)
                # a process-unique temporary name renamed into place, so
                # concurrent processes never load a half-written library
                tmp = so.with_suffix(f".{os.getpid()}.tmp.so")
                subprocess.run(  # dalint: disable=DAL008 — one-shot native build: the lock exists to make every caller wait for the library
                    [gxx, *_FLAGS, "-o", str(tmp), str(_SRC)],
                    check=True, capture_output=True, timeout=120)
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
            lib.chunk_copy.restype = ctypes.c_int
            lib.chunk_copy.argtypes = [
                ctypes.c_char_p,                      # dst
                ctypes.POINTER(ctypes.c_int64),       # dst_dims
                ctypes.c_int,                         # ndim
                ctypes.POINTER(ctypes.c_char_p),      # chunks
                ctypes.POINTER(ctypes.c_int64),       # shapes
                ctypes.POINTER(ctypes.c_int64),       # offsets
                ctypes.c_int64,                       # n_chunks
                ctypes.c_int64,                       # itemsize
                ctypes.c_int,                         # scatter
                ctypes.c_int,                         # n_threads
            ]
            _lib = lib
        except Exception as e:  # noqa: BLE001 — the numpy path stands in
            warn_once("native:build_failed", f"native: building "
                      f"{_SRC.name} failed ({type(e).__name__}: {e}); host "
                      f"chunk copies take the numpy path")
            _lib = None
        return _lib


def available() -> bool:
    """True when the native library is built and loaded (building it on
    the first call)."""
    return _load() is not None


def worth_using(total_bytes: int, n_chunks: int) -> bool:
    """Engage the native path only where thread-parallel copies can win:
    a multi-core host moving at least ``MIN_BYTES`` in several chunks.
    The size is tested first, so a small copy never builds the library."""
    return (n_chunks > 1 and total_bytes >= MIN_BYTES
            and (os.cpu_count() or 1) > 1 and available())


def _call(dst: np.ndarray, chunks, offsets, scatter: bool,
          n_threads: int | None) -> bool:
    lib = _load()
    if lib is None:
        return False
    if not dst.flags.c_contiguous or dst.dtype.hasobject:
        return False
    for c, o in zip(chunks, offsets):
        if not (isinstance(c, np.ndarray) and c.flags.c_contiguous
                and c.dtype == dst.dtype and c.ndim == dst.ndim):
            return False
        # the C side copies blindly: a bad region must fail as the numpy
        # path does, not corrupt the heap
        for d in range(dst.ndim):
            if o[d] < 0 or o[d] + c.shape[d] > dst.shape[d]:
                raise ValueError(
                    f"chunk at offset {tuple(o)} with shape {c.shape} "
                    f"exceeds destination dims {dst.shape}")
    n = len(chunks)
    if n == 0:
        return True
    nd = dst.ndim
    dims_arr = (ctypes.c_int64 * max(nd, 1))(*(dst.shape or (1,)))
    ptr_arr = (ctypes.c_char_p * n)()
    for i, c in enumerate(chunks):
        ptr_arr[i] = ctypes.cast(ctypes.c_void_p(c.ctypes.data),
                                 ctypes.c_char_p)
    shp = (ctypes.c_int64 * (n * max(nd, 1)))()
    off = (ctypes.c_int64 * (n * max(nd, 1)))()
    for i, (c, o) in enumerate(zip(chunks, offsets)):
        for d in range(nd):
            shp[i * nd + d] = c.shape[d]
            off[i * nd + d] = o[d]
    if n_threads is None:
        n_threads = min(n, os.cpu_count() or 1)
    rc = lib.chunk_copy(
        dst.ctypes.data_as(ctypes.c_char_p), dims_arr, nd,
        ptr_arr, shp, off, n, dst.dtype.itemsize, int(scatter),
        int(n_threads))
    return rc == 0


def assemble(dst: np.ndarray, chunks, offsets, n_threads=None) -> np.ndarray:
    """Copy contiguous row-major ``chunks`` into ``dst`` at elementwise
    ``offsets`` (one origin tuple a chunk).  Numpy slicing when the native
    library is unavailable or an input is not contiguous."""
    if not _call(dst, list(chunks), list(offsets), scatter=False,
                 n_threads=n_threads):
        for c, o in zip(chunks, offsets):
            sl = tuple(slice(o[d], o[d] + c.shape[d]) for d in range(dst.ndim))
            dst[sl] = c
    return dst


def scatter_chunks(src: np.ndarray, shapes, offsets, n_threads=None) -> list:
    """Slice ``src`` into new contiguous chunks of the given shapes at the
    given origins (the inverse of :func:`assemble`)."""
    chunks = [np.empty(tuple(s), dtype=src.dtype) for s in shapes]
    if not _call(src, chunks, list(offsets), scatter=True,
                 n_threads=n_threads):
        for c, o in zip(chunks, offsets):
            sl = tuple(slice(o[d], o[d] + c.shape[d]) for d in range(src.ndim))
            c[...] = src[sl]
    return chunks
