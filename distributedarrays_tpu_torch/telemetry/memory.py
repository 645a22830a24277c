"""Device memory ledger: who holds how many device bytes, and since when.

PyTorch counterpart of ``distributedarrays_tpu/telemetry/memory.py`` (its
whole ``__all__``, with JAX's names and semantics).  Every DArray's rank
tensors are tracked from creation through rebind and mutation to
``close()`` or the finalizer, with

- **live-byte gauges and peak watermarks** by device and by rank.  A
  tracked buffer is a DArray's object grid of rank tensors: its bytes on a
  device are the sum of the ``nbytes`` of its rank tensors there, keyed
  by the rank's ``torch.device`` (all the ranks of one card count
  together), and its bytes on a rank the rank tensor's.  The port stores
  one exact-size tensor a rank, so these are the bytes the caching
  allocator handed out for them; JAX's ``_shard_bytes`` reads its
  buffer's shards, blocked padding included, so an uneven layout costs
  JAX more bytes than the port.  Where a query takes a ``device``, an
  ``int`` names a rank (the JAX package's device ids are its ranks) and a
  ``torch.device`` a device;
- **shared ownership**: a buffer co-owned by several DArrays
  (:func:`share`, or :func:`track` of a buffer an entry already holds) is
  counted once and released when its last owner leaves.  The port's
  DArrays never share tensors (each owns its own, since tensors are
  mutable), so only direct callers of :func:`share` form such groups;
- **allocation sites**: the creating span and a short stack per entry
  (``DA_TPU_TELEMETRY_MEMSTACK=0`` turns the stack off,
  ``DA_TPU_TELEMETRY=0`` the ledger: every hook is then one boolean
  check);
- **staging**: :func:`staging` brackets a transient allocation (the
  reshard chain's intermediate step outputs), with per-tag peaks;
- :func:`leak_census`: the ledger against the live torch tensors on the
  ranks' devices.

A DArray written in place keeps its tensors and its bytes, so the write
does not re-track it: :func:`relabel` only sets the entry's ``site`` to
the writing call's label (one label per call site; JAX's mutation
allocates a new buffer there, which its ledger tracks under its own
label).  The hot path pays one dictionary lookup for it, and no stack,
byte count or journal event.

Like the rest of the telemetry core, this module imports nothing of the
package at import time (``leak_census`` reads the rank table lazily).
"""

from __future__ import annotations

import gc
import itertools
import os
import sys
import time
import weakref

from . import core

__all__ = [
    "track", "relabel", "untrack", "share", "sample",
    "live_bytes", "live_bytes_by_device", "live_bytes_by_rank",
    "peak_bytes", "reset_peak", "tracked_count",
    "staging", "staging_peak", "snapshot", "entries", "leak_census",
]

_STACK_DEPTH = 5


def _stack_enabled() -> bool:
    v = os.environ.get("DA_TPU_TELEMETRY_MEMSTACK")
    return v is None or v.strip().lower() not in core._FALSY


class _Entry:
    """One tracked buffer.  ``owners`` is the set of DArray ids co-owning
    it; its bytes are freed when the last owner leaves."""

    __slots__ = ("eid", "owners", "nbytes", "per_dev", "per_rank", "site",
                 "span", "stack", "buf_ref", "buf_id", "t")

    def to_dict(self) -> dict:
        # frames are rendered only here, when someone inspects the entry
        stack = None
        if self.stack:
            stack = [f"{os.path.basename(co.co_filename)}:{line}:"
                     f"{co.co_name}" for co, line in reversed(self.stack)]
        return {"owners": [list(o) if isinstance(o, tuple) else o
                           for o in sorted(self.owners)],
                "nbytes": self.nbytes,
                "per_device": {str(k): v for k, v in self.per_dev.items()},
                "per_rank": {str(k): v for k, v in self.per_rank.items()},
                "site": self.site, "span": self.span, "stack": stack,
                "age_s": round(time.monotonic() - self.t, 3)}


_ids = itertools.count(1)
_entries: dict[int, _Entry] = {}   # eid -> entry
_by_owner: dict = {}               # owner id -> eid
_by_buf: dict[int, int] = {}       # id(buf) -> eid (weakref-validated)
_live_total = 0
_peak_total = 0
_live_dev: dict = {}               # torch.device -> live bytes
_peak_dev: dict = {}
_live_rank: dict = {}              # rank -> live bytes
_peak_rank: dict = {}
_staging_live = 0
_staging_peak = 0
_staging_peak_tag: dict[str, int] = {}


def _tensors(buf) -> list:
    """The tensors of a buffer: the cells of an object grid of tensors in
    row-major order, or the one tensor."""
    if getattr(getattr(buf, "dtype", None), "kind", None) == "O":
        return list(buf.flat)
    return [buf]


def _shard_bytes(buf, ranks=None) -> tuple[dict, dict, int]:
    """``(per device, per rank, total)`` bytes of ``buf``: each tensor's
    ``nbytes`` on its ``device``, and on the rank at its index in
    ``ranks`` (a grid of rank ids of ``buf``'s shape) when given.
    Anything that is not a tensor counts its ``nbytes_of`` on the
    pseudo-device ``None``.  A placeholder on the ``meta`` device (a cell
    another controller process holds) holds no memory here and counts
    nothing."""
    per: dict = {}
    per_rank: dict = {}
    total = 0
    ts = _tensors(buf)
    rs = [None] * len(ts) if ranks is None else ranks.flat
    for t, r in zip(ts, rs):
        if getattr(t, "is_meta", False):
            continue
        nb = getattr(t, "nbytes", None)
        dev = getattr(t, "device", None)
        if not isinstance(nb, int) or dev is None:
            nb, dev = core.nbytes_of(t), None
        per[dev] = per.get(dev, 0) + nb
        if r is not None:
            r = int(r)
            per_rank[r] = per_rank.get(r, 0) + nb
        total += nb
    return ({d: b for d, b in per.items() if b},
            {r: b for r, b in per_rank.items() if b}, total)


def _capture_site():
    """The current span's name and the caller's innermost frames as
    ``(code, line)`` pairs (rendered only by :meth:`_Entry.to_dict`)."""
    sp = core._CURRENT_SPAN.get()
    span = sp.name if sp is not None else None
    stack = None
    if _stack_enabled():
        stack = []
        f = sys._getframe(2)
        while f is not None and len(stack) < _STACK_DEPTH:
            stack.append((f.f_code, f.f_lineno))
            f = f.f_back
    return span, stack


def _add(live: dict, peak: dict, per: dict) -> None:
    for k, nb in per.items():
        v = live.get(k, 0) + nb
        live[k] = v
        if v > peak.get(k, 0):
            peak[k] = v


def _sub(live: dict, per: dict) -> None:
    for k, nb in per.items():
        v = live.get(k, 0) - nb
        if v <= 0:
            live.pop(k, None)
        else:
            live[k] = v


def _add_locked(e: _Entry) -> None:
    global _live_total, _peak_total
    _live_total += e.nbytes
    if _live_total > _peak_total:
        _peak_total = _live_total
    _add(_live_dev, _peak_dev, e.per_dev)
    _add(_live_rank, _peak_rank, e.per_rank)


def _drop_owner_locked(owner):
    """Remove ``owner`` from its entry; returns the freed entry (bytes
    subtracted) when the owner was the last holder, else None."""
    global _live_total
    eid = _by_owner.pop(owner, None)
    if eid is None:
        return None
    e = _entries.get(eid)
    if e is None:
        return None
    e.owners.discard(owner)
    if e.owners:
        return None
    del _entries[eid]
    if _by_buf.get(e.buf_id) == eid:
        del _by_buf[e.buf_id]
    _live_total -= e.nbytes
    _sub(_live_dev, e.per_dev)
    _sub(_live_rank, e.per_rank)
    return e


# ---------------------------------------------------------------------------
# lifecycle hooks (called from darray.py)
# ---------------------------------------------------------------------------


def track(owner, buf, *, site: str | None = None, ranks=None) -> None:
    """Attribute ``buf``'s bytes (an object grid of rank tensors, with
    ``ranks`` the grid of their rank ids) to DArray ``owner``.  Re-tracking
    an owner (rebind, mutation) replaces its previous entry.  If ``buf``
    is already another owner's tracked buffer (identity through the
    entry's weakref), ``owner`` joins that entry instead of counting the
    bytes twice, so the peak watermark only ever sees real memory."""
    if not core._ENABLED:
        return
    per, per_rank, total = _shard_bytes(buf, ranks)
    span, stack = _capture_site()
    try:
        ref = weakref.ref(buf)
    except TypeError:
        ref = None
    with core._LOCK:
        jeid = _by_buf.get(id(buf))
        je = _entries.get(jeid) if jeid is not None else None
        if je is not None and (je.buf_ref is None
                               or je.buf_ref() is not buf):
            je = None                # stale id: a dead buffer's address
        if je is not None and _by_owner.get(owner) != jeid:
            _drop_owner_locked(owner)
            je.owners.add(owner)
            _by_owner[owner] = jeid
            live = _live_total
        else:
            # a new buffer, or the owner's own buffer mutated in place:
            # a fresh entry under this call's site
            je = None
            e = _Entry()
            e.eid = next(_ids)
            e.owners = {owner}
            e.nbytes = total
            e.per_dev = per
            e.per_rank = per_rank
            e.site = site
            e.span = span
            e.stack = stack
            e.buf_ref = ref
            e.buf_id = id(buf)
            e.t = time.monotonic()
            _drop_owner_locked(owner)
            _entries[e.eid] = e
            _by_owner[owner] = e.eid
            if ref is not None:
                _by_buf[id(buf)] = e.eid
            live = _live_total + total
            _add_locked(e)
    core.event("hbm", "share" if je is not None else "alloc",
               owner=str(owner), bytes=total, live=live, site=site)


def relabel(owner, site: str | None) -> None:
    """``owner`` wrote its tracked tensors in place (``fill_``, a region
    write, ``copyto_``): the bytes stay where they were, and the entry's
    ``site`` becomes the writing call's."""
    if not core._ENABLED:
        return
    with core._LOCK:
        eid = _by_owner.get(owner)
        e = _entries.get(eid) if eid is not None else None
        if e is not None:
            e.site = site


def untrack(owner) -> None:
    """``owner`` released its buffer (close, finalizer).  Frees the
    entry's bytes only when ``owner`` was the last holder.  Runs even with
    telemetry disabled, so the ledger drains after a mid-run
    ``disable()``."""
    if not _by_owner:
        return
    with core._LOCK:
        freed = _drop_owner_locked(owner)
        live = _live_total
    if freed is not None and core._ENABLED:
        core.event("hbm", "free", owner=str(owner), bytes=freed.nbytes,
                   live=live, site=freed.site)


def share(src_owner, dst_owner) -> None:
    """``dst_owner`` now co-owns ``src_owner``'s buffer: ``dst_owner``'s
    own entry is dissolved, and the group's bytes stay counted once."""
    if not core._ENABLED and not _by_owner:
        return
    with core._LOCK:
        seid = _by_owner.get(src_owner)
        if seid is None:
            return
        if _by_owner.get(dst_owner) != seid:
            _drop_owner_locked(dst_owner)
        e = _entries.get(seid)
        if e is not None:
            e.owners.add(dst_owner)
            _by_owner[dst_owner] = seid


def sample(tag: str) -> None:
    """Journal one ``hbm``/``sample`` point (current live bytes) at a
    phase boundary (an elastic shrink or grow)."""
    if not core._ENABLED:
        return
    with core._LOCK:
        live = _live_total
    core.event("hbm", "sample", tag=tag, live=live)


# ---------------------------------------------------------------------------
# staging (transient buffers: reshard chunks)
# ---------------------------------------------------------------------------


class staging:
    """Context manager bracketing a transient allocation of ``nbytes``:
    feeds the staging live gauge and per-tag peaks.  The reshard brackets
    each intermediate step output of a chain with it (the tensors that
    live only until the next step has read them)."""

    __slots__ = ("_tag", "_nbytes", "_on")

    def __init__(self, tag: str, nbytes: int):
        self._tag = tag
        self._nbytes = int(nbytes)
        self._on = False

    def __enter__(self):
        if not core._ENABLED:
            return self
        self._on = True
        global _staging_live, _staging_peak
        with core._LOCK:
            _staging_live += self._nbytes
            if _staging_live > _staging_peak:
                _staging_peak = _staging_live
            if _staging_live > _staging_peak_tag.get(self._tag, 0):
                _staging_peak_tag[self._tag] = _staging_live
            live = _staging_live
        core.event("hbm", "staging", tag=self._tag, bytes=self._nbytes,
                   staging_live=live)
        return self

    def __exit__(self, *exc):
        if self._on:
            global _staging_live
            with core._LOCK:
                _staging_live -= self._nbytes
        return False


def staging_peak(tag: str | None = None) -> int:
    with core._LOCK:
        if tag is None:
            return _staging_peak
        return _staging_peak_tag.get(tag, 0)


# ---------------------------------------------------------------------------
# queries
# ---------------------------------------------------------------------------


def _key(device):
    """``(map of live, map of peaks, key)`` for a query's ``device``: an
    int names a rank, a ``torch.device`` a device."""
    if isinstance(device, int):
        return _live_rank, _peak_rank, device
    return _live_dev, _peak_dev, device


def live_bytes(device=None) -> int:
    """Live tracked bytes: all of them, or on one ``device`` (a
    ``torch.device``) or rank (an ``int``)."""
    with core._LOCK:
        if device is None:
            return _live_total
        live, _, k = _key(device)
        return live.get(k, 0)


def live_bytes_by_device() -> dict:
    """``{torch.device: live bytes}``: the elastic manager's witness that
    a shrunk device drained."""
    with core._LOCK:
        return dict(_live_dev)


def live_bytes_by_rank() -> dict:
    """``{rank: live bytes}``: the JAX ledger's per-device map, since its
    device ids are its ranks."""
    with core._LOCK:
        return dict(_live_rank)


def peak_bytes(device=None) -> int:
    with core._LOCK:
        if device is None:
            return _peak_total
        _, peak, k = _key(device)
        return peak.get(k, 0)


def reset_peak() -> None:
    """Reset every peak watermark (total, per device and rank, staging) to
    the current live level."""
    global _peak_total, _staging_peak
    with core._LOCK:
        _peak_total = _live_total
        for peak, live in ((_peak_dev, _live_dev), (_peak_rank, _live_rank)):
            peak.clear()
            peak.update(live)
        _staging_peak = _staging_live
        _staging_peak_tag.clear()


def tracked_count() -> int:
    with core._LOCK:
        return len(_entries)


def entries(limit: int | None = None) -> list[dict]:
    """The tracked entries, largest first, for bundles and debugging."""
    with core._LOCK:
        es = sorted(_entries.values(), key=lambda e: -e.nbytes)
        if limit is not None:
            es = es[:limit]
        return [e.to_dict() for e in es]


def snapshot() -> dict:
    """The ``memory`` section of :func:`core.report`."""
    with core._LOCK:
        sites: dict[str, dict] = {}
        for e in _entries.values():
            key = e.span or e.site or "?"
            s = sites.setdefault(key, {"bytes": 0, "count": 0})
            s["bytes"] += e.nbytes
            s["count"] += 1

        def by(live, peak):
            return {str(k): {"live_bytes": live.get(k, 0),
                             "peak_bytes": peak.get(k, 0)}
                    for k in sorted(set(live) | set(peak), key=str)}
        return {
            "live_bytes": _live_total,
            "peak_bytes": _peak_total,
            "tracked_arrays": len(_entries),
            "owners": len(_by_owner),
            "by_device": by(_live_dev, _peak_dev),
            "by_rank": by(_live_rank, _peak_rank),
            "staging": {"live_bytes": _staging_live,
                        "peak_bytes": _staging_peak,
                        "peak_by_tag": dict(sorted(
                            _staging_peak_tag.items()))},
            "top_sites": sorted(
                ([k, v["bytes"], v["count"]] for k, v in sites.items()),
                key=lambda kv: -kv[1])[:10],
        }


def _rank_devices():
    """The rank table's devices, or None when it is not built."""
    mod = sys.modules.get(__name__.rsplit(".", 2)[0] + ".layout")
    table = getattr(mod, "_table", None)
    return None if table is None else set(table)


def leak_census() -> dict:
    """Diff the ledger against the live torch tensors on the ranks'
    devices (every device when the rank table is not built), the tensors
    ``gc`` can see, the counterpart of ``jax.live_arrays()``:

    - ``ledger_tracked``: live tensors that are a tracked buffer's;
    - ``untracked_foreign``: live tensors with no ledger entry (temporaries,
      views, model weights, caller tensors);
    - ``deleted_but_registered``: entries whose buffer is gone without the
      owner releasing it.

    The key ``jax_live_arrays`` keeps its name and holds the number of
    live tensors counted here."""
    with core._LOCK:
        es = list(_entries.values())
    tracked = set()
    stale_bytes = stale_count = 0
    for e in es:
        buf = e.buf_ref() if e.buf_ref is not None else None
        if buf is None:
            stale_bytes += e.nbytes
            stale_count += 1
        else:
            tracked.update(id(t) for t in _tensors(buf))
    tracked_b = tracked_n = foreign_b = foreign_n = 0
    seen = None
    try:
        import torch as _torch
        devs = _rank_devices()
        # type(), not isinstance(): isinstance reads __class__, which some
        # module proxies in gc's list answer with a deprecation warning
        seen = [t for t in gc.get_objects()
                if issubclass(type(t), _torch.Tensor) and not t.is_meta
                and (devs is None or t.device in devs)]
    except Exception:
        seen = None
    if seen is not None:
        for t in seen:
            nb = int(t.nbytes)
            if id(t) in tracked:
                tracked_b += nb
                tracked_n += 1
            else:
                foreign_b += nb
                foreign_n += 1
    return {
        "ledger_tracked": {"bytes": tracked_b, "count": tracked_n},
        "untracked_foreign": {"bytes": foreign_b, "count": foreign_n},
        "deleted_but_registered": {"bytes": stale_bytes,
                                   "count": stale_count},
        "jax_live_arrays": None if seen is None else len(seen),
    }


def _reset() -> None:
    global _live_total, _peak_total, _staging_live, _staging_peak
    with core._LOCK:
        _entries.clear()
        _by_owner.clear()
        _by_buf.clear()
        for m in (_live_dev, _peak_dev, _live_rank, _peak_rank,
                  _staging_peak_tag):
            m.clear()
        _live_total = _peak_total = 0
        _staging_live = _staging_peak = 0


core.register_report_section("memory", snapshot)
core.register_reset_hook(_reset)
