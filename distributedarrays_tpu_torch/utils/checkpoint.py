"""Checkpoint and resume for DArrays, on the JAX package's on-disk format.

PyTorch counterpart of ``distributedarrays_tpu/utils/checkpoint.py``
(``save``, ``load``, ``CheckpointManager``, ``CheckpointIntegrityError``,
``PeerReplicaStore``, ``PeerReplicaUnavailable``), with JAX's counters,
journal events and fault sites.

**Format.**  A checkpoint directory holds ``dartpu_meta.json`` (the tree
with its leaves replaced by tagged placeholders, the store name, and the
CRC32 of every payload array) and ``arrays.npz`` (the payloads); the
metadata file is written last and is the publish marker.  The tags are
JAX's ``__dartpu__`` tags: ``DArray`` (``key``, ``procs``, ``dist``,
``cuts``), ``DData``, ``ndarray`` (``key``, ``jax``), ``npscalar``,
``dict`` (a dict with non-string keys, as item pairs) and ``tuple``.  A
``torch.Tensor`` leaf is written as ``ndarray`` with ``"jax": true`` and
restored as a tensor on rank 0's device, so a checkpoint either package
writes, the other restores.  A leaf of a type numpy cannot hold (bfloat16,
float8) is stored as its raw bytes with ``"mldtype"`` (the type's name)
and its ``shape``, JAX's encoding of ``ml_dtypes`` leaves; the port views
the bytes as the torch dtype of that name with torch alone (no
``ml_dtypes``), restores a ``"jax": false`` such leaf as a CPU tensor
(numpy has no such type), and raises ``TypeError`` on a name it cannot
view.  A bfloat16 DArray's payload is stored the same way.

A DArray restores on its exact cuts through ``darray_from_cuts``; when its
``procs`` exceed the rank table it warns and takes the default layout.

``CheckpointManager`` publishes each step atomically (a hidden temp
directory renamed into place), takes the host snapshot inside ``save()``
(``.cpu()`` copies, so the caller may write its tensors at once) and with
``async_save`` writes on one background thread, rotates steps by
``max_to_keep``, and on ``restore()`` treats a step that fails its CRC
check like a half-written one: it quarantines the directory
(``.quarantine_step_*``), journals ``restore_fallback`` and falls back to
the previous verified step.  With ``replicas=PeerReplicaStore()`` every
published step is also kept chunk by chunk in the memory of each chunk
owner's buddy rank (``resilience.domains.buddy_map``), and a restore tries
that replica first: a device-loss restore reads nothing from disk
(``checkpoint.disk_reads`` against ``checkpoint.restore_source``).

Fault sites: ``checkpoint.write`` (payload written, marker not yet) and
``checkpoint.read`` (a ``corrupt`` spec flips payload bytes through
``faults.corrupt_arrays`` before the CRC check).

A DArray that spans the processes of a multi-process job
(``parallel.multihost``) is assembled through
``multihost.gather_global``, so every process must call ``save`` (each
writes its own checkpoint, as JAX's multi-controller ``_encode`` does,
``checkpoint.py:126-132``), and ``load`` restores it onto its saved
``procs`` and cuts, each process placing only its own chunks.

Not ported: ``store="orbax"`` raises ``ValueError`` (Orbax is a JAX
library).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import warnings
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any

import numpy as np
import torch

from .. import telemetry as _tm
from ..darray import DArray, DData, darray_from_cuts, distribute
from ..layout import device_of, nranks, process_count
from . import native as _native

__all__ = ["save", "load", "CheckpointManager", "CheckpointIntegrityError",
           "PeerReplicaStore", "PeerReplicaUnavailable"]

_META = "dartpu_meta.json"
_ARRS = "arrays.npz"


class CheckpointIntegrityError(RuntimeError):
    """A checkpoint payload array failed its recorded CRC32 check.
    ``path`` is the checkpoint directory, ``keys`` the failing payload
    keys."""

    def __init__(self, path, keys: list):
        self.path = str(path)
        self.keys = list(keys)
        super().__init__(
            f"checkpoint {self.path} failed integrity verification: "
            f"payload CRC32 mismatch on {self.keys}")


def _check_store(store: str) -> None:
    if store == "orbax":
        raise ValueError("store='orbax' is not ported: Orbax is a JAX "
                         "library; use store='npz'")
    if store != "npz":
        raise ValueError(f"unknown store {store!r} (use 'npz')")


def _crc(arr: np.ndarray) -> int:
    return int(zlib.crc32(np.ascontiguousarray(arr).tobytes()))


def _crc_map(arrays: dict) -> dict:
    """CRC32 of every payload array's host bytes."""
    return {k: _crc(v) for k, v in arrays.items()}


def _verify_integrity(path, meta_doc: dict, arrays: dict) -> None:
    """Check every payload array against the CRC32s recorded at save time.
    Metadata without an ``integrity`` section passes unverified; a
    recorded key missing from the payload counts as a mismatch."""
    integ = meta_doc.get("integrity") if isinstance(meta_doc, dict) else None
    if not integ or not isinstance(integ.get("crc32"), dict):
        return
    bad = [key for key, want in integ["crc32"].items()
           if key not in arrays or _crc(arrays[key]) != int(want)]
    if bad:
        _tm.count("checkpoint.integrity_failures")
        if _tm.enabled():
            # cold path: a corrupt checkpoint is exceptional
            _tm.event("checkpoint", "integrity_failure", path=str(path),
                      keys=",".join(sorted(bad)[:8]))
        raise CheckpointIntegrityError(path, sorted(bad))


def _raw(t: torch.Tensor) -> tuple[np.ndarray, dict]:
    """A host tensor as numpy: itself when numpy has its dtype, else its
    raw bytes and the ``mldtype``/``shape`` fields that re-view them."""
    t = t.contiguous()
    try:
        return t.numpy(), {}
    except TypeError:
        name = str(t.dtype).removeprefix("torch.")
        return t.reshape(-1).view(torch.uint8).numpy(), {
            "mldtype": name, "shape": list(t.shape)}


def _viewed(host: np.ndarray, entry: dict) -> torch.Tensor:
    """The tensor an ``mldtype`` entry's raw bytes hold."""
    dt = getattr(torch, str(entry["mldtype"]), None)
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"checkpoint leaf of dtype {entry['mldtype']!r}: "
                        "torch has no such dtype to view its bytes as")
    raw = torch.from_numpy(np.frombuffer(host.tobytes(), np.uint8).copy())
    return raw.view(dt).reshape(entry["shape"])


def _encode(tree, arrays: dict, copy: bool = False):
    """``tree`` with its array leaves replaced by tagged placeholders, the
    payloads (host numpy) added to ``arrays``.  ``copy=True`` makes every
    payload independent of the caller's buffers (async saves)."""
    if isinstance(tree, DArray):
        key = f"a{len(arrays)}"
        if process_count() > 1:
            # multi-controller: every process assembles the array through
            # the cross-process gather (SPMD: each is inside this save)
            from ..parallel.multihost import _gather_tensor
            whole = _gather_tensor(tree).cpu()
        else:
            whole = tree.full(torch.device("cpu"))
        host, extra = _raw(whole)
        arrays[key] = host
        return {"__dartpu__": "DArray", "key": key,
                "procs": [int(p) for p in tree.pids.flat],
                "dist": list(tree.pids.shape),
                "cuts": [list(c) for c in tree.cuts], **extra}
    if isinstance(tree, DData):
        return {"__dartpu__": "DData",
                "parts": [_encode(p, arrays, copy) for p in tree.gather()],
                "pids": [int(p) for p in tree.pids]}
    if isinstance(tree, torch.Tensor):
        key = f"a{len(arrays)}"
        host = tree.detach().cpu()
        if copy and host.data_ptr() == tree.data_ptr():
            host = host.clone()
        host, extra = _raw(host)
        arrays[key] = host
        return {"__dartpu__": "ndarray", "key": key, "jax": True, **extra}
    if isinstance(tree, np.ndarray):
        key = f"a{len(arrays)}"
        host = tree.copy() if copy else tree
        entry = {"__dartpu__": "ndarray", "key": key, "jax": False}
        if host.dtype.kind == "V" and host.dtype.names is None and \
                isinstance(getattr(torch, host.dtype.name, None),
                           torch.dtype):
            # an ml_dtypes array: npz cannot carry it, its bytes can
            entry["mldtype"] = host.dtype.name
            entry["shape"] = list(host.shape)
            host = np.frombuffer(host.tobytes(), dtype=np.uint8)
        arrays[key] = host
        return entry
    if isinstance(tree, dict):
        if all(isinstance(k, str) for k in tree) and \
                not any(k in ("__dartpu__", "__dartpu_store__")
                        for k in tree):
            return {k: _encode(v, arrays, copy) for k, v in tree.items()}
        return {"__dartpu__": "dict",
                "items": [[_encode(k, arrays, copy),
                           _encode(v, arrays, copy)]
                          for k, v in tree.items()]}
    if isinstance(tree, (list, tuple)):
        enc = [_encode(v, arrays, copy) for v in tree]
        return {"__dartpu__": "tuple", "items": enc} \
            if isinstance(tree, tuple) else enc
    if isinstance(tree, bool) or tree is None or isinstance(tree, str):
        return tree
    if isinstance(tree, np.generic):
        return {"__dartpu__": "npscalar", "dtype": str(tree.dtype),
                "v": tree.item()}
    if isinstance(tree, (int, float)):
        return tree
    from ..models.tp_dp import ShardedParams
    if isinstance(tree, ShardedParams):
        # the tp/dp layout is written as JAX writes its sharded pytree:
        # whole arrays
        return _encode(tree.whole(), arrays, copy)
    raise TypeError(f"cannot checkpoint leaf of type {type(tree)}")


def _restore_darray(tree, arrays):
    host = arrays[tree["key"]]
    host = _viewed(host, tree) if "mldtype" in tree else \
        torch.from_numpy(host)
    procs, dist = tree["procs"], tree["dist"]
    if any(int(p) >= nranks() for p in procs):
        warnings.warn(
            f"checkpoint was written on {max(procs) + 1}+ ranks but only "
            f"{nranks()} are in the rank table; restoring with the default "
            "layout")
        return distribute(host)
    cuts = tree.get("cuts")
    if cuts is not None:
        return darray_from_cuts(host, procs, cuts)
    return distribute(host, procs=procs, dist=dist)


def _decode(tree, arrays):
    if isinstance(tree, dict):
        tag = tree.get("__dartpu__")
        if tag == "DArray":
            return _restore_darray(tree, arrays)
        if tag == "npscalar":
            return np.dtype(tree["dtype"]).type(tree["v"])
        if tag == "dict":
            return {_decode(k, arrays): _decode(v, arrays)
                    for k, v in tree["items"]}
        if tag == "ndarray":
            host = arrays[tree["key"]]
            if "mldtype" in tree:
                t = _viewed(host, tree)
                return t.to(device_of(0)) if tree["jax"] else t
            return torch.from_numpy(host).to(device_of(0)) \
                if tree["jax"] else host
        if tag == "DData":
            parts = [_decode(p, arrays) for p in tree["parts"]]
            return DData(dict(zip(tree["pids"], parts)), tree["pids"])
        if tag == "tuple":
            return tuple(_decode(v, arrays) for v in tree["items"])
        return {k: _decode(v, arrays) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_decode(v, arrays) for v in tree]
    return tree


def _payload_bytes(arrays: dict) -> int:
    return int(sum(a.nbytes for a in arrays.values()))


def _read_faults(path, store: str, arrays: dict) -> dict:
    """The ``checkpoint.read`` site: a fired ``corrupt`` spec flips payload
    bytes; any other action runs as a failing storage read would."""
    from ..resilience import faults as _fl
    spec = _fl.decide("checkpoint.read", store=store, path=str(path))
    if spec is None:
        return arrays
    if spec.action == "corrupt":
        return _fl.corrupt_arrays(spec, arrays)
    _fl.act(spec, {"store": store, "path": str(path)})
    return arrays


def save(path: str | os.PathLike, tree: Any, store: str = "npz") -> None:
    """Checkpoint a tree of DArrays, DDatas, tensors, numpy arrays and plain
    Python values into the directory ``path`` (DArrays keep their
    layout)."""
    _check_store(store)
    with _tm.span("checkpoint.save", store=store):
        # cold path: checkpoint I/O dominates the event cost
        if _tm.enabled():
            _tm.event("checkpoint", "save_start", path=str(path),
                      store=store)
        arrays: dict[str, np.ndarray] = {}
        with _tm.span("checkpoint.save.encode", _journal=False):
            meta = _encode(tree, arrays)
        if _tm.enabled():
            from ..telemetry import perf as _perf
            _tm.annotate(**_perf.transfer_cost(_payload_bytes(arrays)))
        with _tm.span("checkpoint.save.write", _journal=False):
            _write_store(Path(path), meta, arrays, store)
        _tm.count("checkpoint.saves")
        if _tm.enabled():
            _tm.event("checkpoint", "save_end", path=str(path), store=store,
                      arrays=len(arrays), bytes=_payload_bytes(arrays))
        _tm.memory.sample("checkpoint.save")


def load(path: str | os.PathLike) -> Any:
    """Restore a checkpoint directory written by either package; DArrays
    come back on their saved layout (the default one, with a warning, when
    the rank table is smaller than at save time)."""
    path = Path(path)
    with _tm.span("checkpoint.restore"):
        # the zero-disk-reads witness of replica restores: every read from
        # disk counts here, a replica fetch never does
        _tm.count("checkpoint.disk_reads")
        if _tm.enabled():
            _tm.event("checkpoint", "restore_start", path=str(path))
        meta_doc = json.loads((path / _META).read_text())
        if isinstance(meta_doc, dict) and "__dartpu_store__" in meta_doc:
            store, meta = meta_doc["__dartpu_store__"], meta_doc["tree"]
        else:                                  # metadata without a store
            store, meta = "npz", meta_doc
        _check_store(store)
        with _tm.span("checkpoint.restore.read", _journal=False):
            with np.load(path / _ARRS) as z:
                arrays = {k: z[k] for k in z.files}
        # chaos site: byte flips land before the CRC check, which is what
        # catches them, as it would catch real disk rot
        arrays = _read_faults(path, store, arrays)
        _verify_integrity(path, meta_doc, arrays)
        with _tm.span("checkpoint.restore.decode", _journal=False):
            out = _decode(meta, arrays)
        if _tm.enabled():
            from ..telemetry import perf as _perf
            _tm.annotate(**_perf.transfer_cost(_payload_bytes(arrays)))
        _tm.count("checkpoint.restores")
        if _tm.enabled():
            _tm.event("checkpoint", "restore_end", path=str(path),
                      store=store, arrays=len(arrays),
                      bytes=_payload_bytes(arrays))
        _tm.memory.sample("checkpoint.restore")
        return out


def _write_store(path: Path, meta, arrays, store: str) -> None:
    """Write one encoded checkpoint into ``path``; the metadata file last
    (the publish marker), so an interrupted write leaves a partial
    directory that ``CheckpointManager`` skips."""
    path.mkdir(parents=True, exist_ok=True)
    np.savez(path / _ARRS, **arrays)
    # chaos site: payload on disk, publish marker absent
    from ..resilience import faults as _fl
    _fl.check("checkpoint.write", store=store)
    (path / _META).write_text(
        json.dumps({"__dartpu_store__": store, "tree": meta,
                    "integrity": {"algo": "crc32",
                                  "crc32": _crc_map(arrays)}}))


class PeerReplicaUnavailable(RuntimeError):
    """No live rank holds a needed replica chunk: both its owner and its
    buddy holder are down.  The restore falls back to disk past this."""

    def __init__(self, step: int, key: str, chunk: int,
                 owner: int, holder: int):
        self.step, self.key, self.chunk = int(step), str(key), int(chunk)
        super().__init__(
            f"peer replica for step {step} chunk {key}[{chunk}] is gone: "
            f"owner rank {owner} and holder rank {holder} are both down")


def _darray_entries(meta) -> dict:
    """Every encoded DArray placeholder of a checkpoint tree, by key."""
    out: dict = {}

    def walk(t):
        if isinstance(t, dict):
            if t.get("__dartpu__") == "DArray":
                out[t["key"]] = t
                return
            for v in t.values():
                walk(v)
        elif isinstance(t, list):
            for v in t:
                walk(v)
    walk(meta)
    return out


def _chunk_slices(entry: dict) -> list:
    """``(owner_rank, index_slices)`` per block of one encoded DArray, in
    the block grid's row-major order: the bytes that rank held."""
    grid = tuple(int(x) for x in entry["dist"])
    procs = [int(p) for p in entry["procs"]]
    cuts = entry["cuts"]
    out = []
    for j, owner in enumerate(procs):
        coords = np.unravel_index(j, grid) if grid else ()
        sl = tuple(slice(int(cuts[d][c]), int(cuts[d][c + 1]))
                   for d, c in enumerate(coords))
        out.append((owner, sl))
    return out


class PeerReplicaStore:
    """In-memory replicas of checkpoint payloads, placed by failure domain
    (JAX ``checkpoint.py:466``).

    At publish time every payload chunk is copied to its owner rank's
    buddy (``resilience.domains.buddy_map``: another failure domain
    whenever two are live), CRC-stamped a chunk.  :meth:`fetch` rebuilds a
    step from chunks whose owner is live ("local") or whose holder is
    ("peer"); only when both sides of a chunk are down does the restore
    go to disk.  A raw-bytes payload (a bfloat16 DArray's) is one chunk
    owned by the array's first rank."""

    def __init__(self):
        self._lock = threading.Lock()
        self._steps: dict[int, dict] = {}

    def put(self, step: int, meta, arrays: dict,
            live_ranks=None) -> dict:
        """Replicate one encoded checkpoint.  Returns ``{"chunks",
        "bytes", "cross_domain"}``."""
        from ..resilience import domains as _dm
        if live_ranks is None:
            from ..resilience import elastic as _el
            live_ranks = _el.manager().live_ranks()
        live = sorted({int(r) for r in live_ranks})
        bmap = _dm.buddy_map(live)
        dents = _darray_entries(meta)
        chunks: dict = {}
        keys: dict = {}
        total = 0
        for key, arr in arrays.items():
            host = np.ascontiguousarray(arr)
            keys[key] = (tuple(host.shape), host.dtype.str)
            ent = dents.get(key)
            if ent is not None and "mldtype" not in ent:
                parts = _chunk_slices(ent)
            else:
                owner = int(ent["procs"][0]) if ent is not None else \
                    (live[0] if live else 0)
                parts = [(owner, tuple(slice(0, n) for n in host.shape))]
            for j, (owner, sl) in enumerate(parts):
                data = host[sl].tobytes()
                total += len(data)
                chunks[(key, j)] = {
                    "owner": int(owner),
                    "holder": int(bmap.get(int(owner), int(owner))),
                    "data": data,
                    "crc": int(zlib.crc32(data)),
                    "slices": [(s.start, s.stop) for s in sl],
                }
        rec = {"meta": json.loads(json.dumps(meta)), "keys": keys,
               "chunks": chunks}
        with self._lock:
            self._steps[int(step)] = rec
        _tm.count("checkpoint.replications")
        if _tm.enabled():
            # cold path: one event per replicated step
            _tm.event("checkpoint", "replicate", step=int(step),
                      chunks=len(chunks), bytes=total,
                      cross_domain=_dm.is_cross_domain(bmap))
        return {"chunks": len(chunks), "bytes": total,
                "cross_domain": _dm.is_cross_domain(bmap)}

    def fetch(self, step: int, live_ranks=None):
        """``(meta, arrays, info)`` of ``step`` from the chunks reachable
        through live ranks.  Raises ``KeyError`` for a step never
        replicated, :class:`PeerReplicaUnavailable` when a chunk's owner
        and holder are both down, and :class:`CheckpointIntegrityError`
        on a chunk's CRC mismatch."""
        with self._lock:
            rec = self._steps.get(int(step))
            if rec is None:
                raise KeyError(f"no peer replica for step {step}")
        if live_ranks is None:
            from ..resilience import elastic as _el
            live_ranks = _el.manager().live_ranks()
        live = {int(r) for r in live_ranks}
        arrays = {key: np.empty(shape, dtype=np.dtype(dstr))
                  for key, (shape, dstr) in rec["keys"].items()}
        n_local = n_peer = 0
        bad: list[str] = []
        pieces: dict[str, list] = {key: [] for key in arrays}
        for (key, j), ch in rec["chunks"].items():
            if ch["owner"] in live:
                n_local += 1
            elif ch["holder"] in live:
                n_peer += 1
            else:
                raise PeerReplicaUnavailable(step, key, j, ch["owner"],
                                             ch["holder"])
            if int(zlib.crc32(ch["data"])) != ch["crc"]:
                bad.append(key)
                continue
            pieces[key].append((np.frombuffer(
                ch["data"], dtype=arrays[key].dtype).reshape(
                    tuple(b - a for a, b in ch["slices"])),
                tuple(a for a, _ in ch["slices"])))
        if bad:
            _tm.count("checkpoint.integrity_failures")
            raise CheckpointIntegrityError(f"<peer replica step {step}>",
                                           sorted(set(bad)))
        for key, got in pieces.items():
            # each array stitched from its chunks, by the native copier's
            # threads where the size pays for them, else numpy slicing
            dst = arrays[key]
            if _native.worth_using(dst.nbytes, len(got)):
                _native.assemble(dst, [c for c, _ in got],
                                 [o for _, o in got])
            else:
                for c, o in got:
                    dst[tuple(slice(a, a + n) for a, n in
                              zip(o, c.shape))] = c
        if n_peer:
            _tm.count("checkpoint.peer_fetches", n=n_peer)
        info = {"local_chunks": n_local, "peer_chunks": n_peer}
        if _tm.enabled():
            # cold path: one event per replica restore
            _tm.event("checkpoint", "replica_fetch", step=int(step),
                      **info)
        return rec["meta"], arrays, info

    def steps(self) -> list[int]:
        with self._lock:
            return sorted(self._steps)

    def drop(self, step: int) -> None:
        with self._lock:
            self._steps.pop(int(step), None)

    def drop_from(self, step: int) -> list[int]:
        with self._lock:
            dropped = sorted(s for s in self._steps if s >= int(step))
            for s in dropped:
                del self._steps[s]
        return dropped

    def clear(self) -> None:
        with self._lock:
            self._steps.clear()


class CheckpointManager:
    """Stepped checkpoints under one directory, with async save,
    ``max_to_keep`` rotation, CRC quarantine and fallback, and an optional
    peer-replica tier (module docstring)::

        with CheckpointManager(dir, max_to_keep=3) as mgr:
            for step in range(...):
                ...
                mgr.save(step, {"params": params, "opt": opt_state})
        state = CheckpointManager(dir).restore()        # latest step
    """

    _STEP = "step_{:08d}"

    def __init__(self, directory: str | os.PathLike,
                 max_to_keep: int | None = 3, async_save: bool = True,
                 keep_quarantined: int | None = 4,
                 replicas: PeerReplicaStore | None = None):
        if max_to_keep is not None and max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        if keep_quarantined is not None and keep_quarantined < 0:
            raise ValueError(f"keep_quarantined must be >= 0, got "
                             f"{keep_quarantined}")
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.keep_quarantined = keep_quarantined
        self._replicas = replicas
        self._async = bool(async_save)
        self._pool = (ThreadPoolExecutor(max_workers=1,
                                         thread_name_prefix="ckpt")
                      if self._async else None)
        self._pending: dict[int, Any] = {}   # step -> in-flight future
        self._lock = threading.Lock()

    # -- inventory ---------------------------------------------------------

    def steps(self) -> list[int]:
        """Published step numbers, ascending."""
        out = []
        for p in self.directory.iterdir():
            name = p.name
            if p.is_dir() and name.startswith("step_") and \
                    name[5:].isdigit() and (p / _META).exists():
                out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def _step_dir(self, step: int) -> Path:
        return self.directory / self._STEP.format(step)

    # -- save --------------------------------------------------------------

    def save(self, step: int, tree: Any, store: str = "npz") -> None:
        """Checkpoint ``tree`` as ``step``: the host snapshot is taken
        before this returns, the write runs in the background with
        ``async_save``."""
        _check_store(store)
        with self._lock:
            self._reap(wait=False)  # dalint: disable=DAL008 — wait=False reaps only done() futures; result() returns at once
            # the step is reserved inside the same lock section as the
            # check, so a duplicate racing an in-flight save gets this
            # ValueError
            if step in self.steps() or step in self._pending:
                raise ValueError(f"step {step} already exists in "
                                 f"{self.directory}")
            self._pending[step] = None          # reservation
        try:
            arrays: dict[str, np.ndarray] = {}
            meta = _encode(tree, arrays, copy=True)
            if self._pool is None:
                self._publish(step, meta, arrays, store)
                with self._lock:
                    self._pending.pop(step, None)
                return
            with self._lock:
                self._pending[step] = self._pool.submit(
                    self._publish, step, meta, arrays, store)
        except BaseException:
            with self._lock:
                self._pending.pop(step, None)
            raise

    def _publish(self, step: int, meta, arrays, store: str) -> None:
        # the memory replica first, so a crash mid-write still leaves it;
        # a failed replication never loses the disk tier
        if self._replicas is not None:
            try:
                self._replicas.put(step, meta, arrays)
            except Exception as e:  # noqa: BLE001 — disk tier still publishes
                _tm.count("checkpoint.replication_failures")
                if _tm.enabled():
                    # cold path: a failed replication is exceptional
                    _tm.event("checkpoint", "replication_failure",
                              step=step,
                              error=f"{type(e).__name__}: {str(e)[:200]}")
        final = self._step_dir(step)
        tmp = self.directory / f".tmp_{self._STEP.format(step)}"
        if tmp.exists():
            shutil.rmtree(tmp)
        _write_store(tmp, meta, arrays, store)
        os.replace(tmp, final)
        _tm.count("checkpoint.saves")
        if _tm.enabled():
            _tm.event("checkpoint", "publish", step=step, store=store,
                      arrays=len(arrays), bytes=_payload_bytes(arrays))
        self._rotate()
        self._reap_quarantine()

    def _rotate(self) -> None:
        if self.max_to_keep is None:
            return
        done = self.steps()
        for s in done[:max(0, len(done) - self.max_to_keep)]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
            if self._replicas is not None:
                self._replicas.drop(s)
        if self._replicas is not None:
            # replica-only steps (a failed disk write) rotate too
            reps = self._replicas.steps()
            for s in reps[:max(0, len(reps) - self.max_to_keep)]:
                self._replicas.drop(s)

    def _reap_quarantine(self) -> None:
        """Keep the newest ``keep_quarantined`` quarantined steps."""
        if self.keep_quarantined is None:
            return
        quarantined = sorted(
            p for p in self.directory.iterdir()
            if p.is_dir() and p.name.startswith(".quarantine_step_"))
        for p in quarantined[:max(0,
                                  len(quarantined) - self.keep_quarantined)]:
            shutil.rmtree(p, ignore_errors=True)
            _tm.count("checkpoint.quarantine_reaps")
            if _tm.enabled():
                # cold path: reaping is rarer than quarantining
                _tm.event("checkpoint", "quarantine_reap", path=p.name)

    def _reap(self, wait: bool) -> None:
        still, first_exc = {}, None
        for step, fut in self._pending.items():
            if fut is None:          # reserved by a save() mid-encode
                still[step] = fut
            elif fut.done() or wait:
                try:
                    fut.result()
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    # the failed future leaves _pending, or every later
                    # call would re-raise it
                    if first_exc is None:
                        first_exc = e
            else:
                still[step] = fut
        self._pending = still
        if first_exc is not None:
            raise first_exc

    # -- restore / lifecycle ----------------------------------------------

    def _restore_replica(self, step: int):
        """The decoded tree of ``step`` from the replica tier, or None when
        there is none or it cannot serve (the caller goes to disk); a
        replica that fails its CRC is dropped."""
        if self._replicas is None:
            return None
        try:
            meta, arrays, info = self._replicas.fetch(step)
            out = _decode(meta, arrays)
        except KeyError:
            return None                      # never replicated: not a fault
        except Exception as e:  # noqa: BLE001 — disk tier is the fallback
            _tm.count("checkpoint.replica_fallbacks")
            if _tm.enabled():
                # cold path: an unservable replica is exceptional
                _tm.event("checkpoint", "replica_fallback", step=step,
                          error=f"{type(e).__name__}: {str(e)[:200]}")
            if isinstance(e, CheckpointIntegrityError):
                self._replicas.drop(step)
            return None
        _tm.count("checkpoint.restore_source", source="peer")
        _tm.count("checkpoint.restores")
        if _tm.enabled():
            # cold path: one event per restore
            _tm.event("checkpoint", "restore_peer", step=step, **info)
        return out

    def _load_disk(self, step: int):
        out = load(self._step_dir(step))
        _tm.count("checkpoint.restore_source", source="disk")
        if _tm.enabled():
            # cold path: one event per restore
            _tm.event("checkpoint", "restore_disk", step=step)
        return out

    def restore(self, step: int | None = None) -> Any:
        """Load ``step``, or with none the latest restorable step: the
        replica tier first, then disk.  A step whose payload is missing or
        fails its CRC is skipped with a journaled ``restore_fallback`` (and
        quarantined when its bytes are provably bad); an explicit ``step``
        stays strict on the disk tier."""
        self.wait()
        if step is not None:
            out = self._restore_replica(step)
            if out is not None:
                return out
            if not (self._step_dir(step) / _META).exists():
                raise FileNotFoundError(f"no checkpoint for step {step} in "
                                        f"{self.directory}")
            return self._load_disk(step)
        done = self.steps()
        rep_steps = self._replicas.steps() if self._replicas is not None \
            else []
        candidates = sorted(set(done) | set(rep_steps))
        if not candidates:
            raise FileNotFoundError(
                f"no completed checkpoints in {self.directory}")
        last_exc: BaseException | None = None
        for s in reversed(candidates):
            out = self._restore_replica(s)
            if out is not None:
                return out
            if s not in done:
                continue                     # replica-only step
            try:
                return self._load_disk(s)
            except Exception as e:  # noqa: BLE001 — fall back, then re-raise
                last_exc = e
                _tm.count("checkpoint.restore_fallbacks")
                if _tm.enabled():
                    # cold path: a partial or corrupt step is exceptional
                    _tm.event("checkpoint", "restore_fallback",
                              step=s, error=f"{type(e).__name__}: "
                                            f"{str(e)[:200]}")
                if isinstance(e, CheckpointIntegrityError):
                    self._quarantine(s)
        raise FileNotFoundError(
            f"no restorable checkpoint in {self.directory}: every "
            f"completed step failed to load") from last_exc

    def _quarantine(self, step: int) -> None:
        """Rename a corrupt step directory to ``.quarantine_step_*``: no
        longer a completed step, still on disk for forensics."""
        src = self._step_dir(step)
        dst = self.directory / f".quarantine_{src.name}"
        try:
            if dst.exists():
                shutil.rmtree(dst)
            os.replace(src, dst)
        except OSError:
            return
        _tm.count("checkpoint.quarantines")
        if _tm.enabled():
            # cold path: quarantining a corrupt step is exceptional
            _tm.event("checkpoint", "quarantine", step=step,
                      path=str(dst))

    def discard_from(self, step: int) -> list[int]:
        """Delete every published step ``>= step`` (after draining pending
        saves), in both tiers: the rewind of a trainer that restored an
        earlier step.  Returns the discarded steps."""
        self.wait()
        dropped = [s for s in self.steps() if s >= step]
        for s in dropped:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
        if self._replicas is not None:
            dropped = sorted(set(dropped)
                             | set(self._replicas.drop_from(step)))
        if dropped and _tm.enabled():
            # cold path: a timeline rewind is a recovery-path event
            _tm.event("checkpoint", "discard_from", step=step,
                      dropped=len(dropped))
        return dropped

    def wait(self) -> None:
        """Block until every pending save is published; re-raise the first
        background failure."""
        with self._lock:
            self._reap(wait=True)  # dalint: disable=DAL008 — wait() is the quiesce API: holding the lock while the writes drain is its contract (no save may interleave)

    def close(self) -> None:
        self.wait()
        if self._pool is not None:
            self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
