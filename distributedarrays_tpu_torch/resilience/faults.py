"""Deterministic fault injection: kill, hang and revive simulated ranks.

PyTorch counterpart of ``distributedarrays_tpu/resilience/faults.py`` (its
whole ``__all__``), the same code: one fault plan and seed give the same
decisions, at the same sites, in the same order, in both packages.

1. **Determinism.**  Every decision is a pure function of ``(plan, seed,
   per-spec invocation count)``; probabilistic specs draw from a
   per-``(spec, invocation)`` seeded RNG (``_mix``: plain arithmetic, no
   salted hashing), so thread interleaving cannot reorder the stream.  On
   sites checked concurrently from rank threads, a spec that does not pin
   ``match.rank`` fires on whichever rank lands on the ``at``-th call.
2. **Zero cost when idle.**  ``check()`` is one ``None`` test with no plan
   armed.
3. **Parent-side counting for forked ranks.**  The process SPMD backend
   decides in the parent (:func:`decide`) and acts in the child
   (:func:`act`); :func:`check` is ``act(decide(...))``.

Instrumented sites of the port (the JAX package's names and labels):

========================  ====================================================
``spmd.rank``             per-rank task start, thread and process backends
                          (labels: ``rank``, ``backend``)
``spmd.collective``       barrier/bcast/scatter/gather_spmd entry
                          (labels: ``op``, ``rank``)
``reshard.chunk``         before the collective lowering of a planned
                          reshard (labels: ``strategy``, ``op``)
``solver.iterate``        each Krylov iteration (labels: ``solver``)
========================  ====================================================

The checkpoint and trainer sites (``checkpoint.write``/``read``,
``train.step``, ``grad.sync``) come with those modules (ROADMAP queue A).

Plan format (``DA_TPU_FAULT_PLAN``: inline JSON, or a path to a JSON
file), a list of spec objects::

    [{"site": "spmd.rank", "match": {"rank": 2}, "action": "device_loss",
      "at": 1, "count": 1, "device": 2, "revive_after": 2}]

``action``: ``raise`` (InjectedFault), ``device_loss`` (InjectedDeviceLoss;
the device joins the simulated-down set until ``revive_after`` elastic
probes have passed), ``hang`` (sleep ``hang_s``; with ``device`` it also
downs that device), ``exit`` (``os._exit`` in forked ranks, a raise in the
controller), ``corrupt`` (no exception; the site flips bytes of its
payload through :func:`corrupt_arrays`), ``partition`` (the ranks beyond
``observer``'s group of ``groups`` go down and :class:`InjectedPartition`
raises), ``slow_link`` (sleep a seeded fraction of ``hang_s`` and go on).
``at`` is the 1-based matching invocation of the first firing, ``count``
how many consecutive matching invocations fire (``-1``: forever), ``p`` a
seeded per-invocation firing probability, ``flips`` the bytes a
``corrupt`` firing inverts.  Seed: ``DA_TPU_FAULT_SEED`` (or
``configure(seed=...)``); it also feeds :func:`jitter`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
import random as _random
from typing import Any

from .. import telemetry as _tm

__all__ = [
    "InjectedFault", "InjectedDeviceLoss", "InjectedPartition", "FaultSpec",
    "configure", "clear", "active", "check", "decide", "act",
    "history", "simulated_down", "probe_tick", "revive", "jitter",
    "corrupt_arrays", "partition_state", "heal_partition",
]

_SEED_ENV = "DA_TPU_FAULT_SEED"
_PLAN_ENV = "DA_TPU_FAULT_PLAN"


class InjectedFault(RuntimeError):
    """A fault fired by the injection harness (not a real failure).

    ``spec`` is the firing :class:`FaultSpec`; ``labels`` the injection
    point's labels at fire time."""

    def __init__(self, spec: "FaultSpec", labels: dict):
        self.spec = spec
        self.labels = dict(labels)
        super().__init__(
            f"injected fault at {spec.site} "
            f"(action={spec.action}, labels={self.labels})")


class InjectedDeviceLoss(InjectedFault):
    """An injected fault simulating a host/device becoming unreachable —
    classified as *transient device loss* by ``recovery`` (shrink the
    live set and retry), unlike the generic :class:`InjectedFault`."""

    def __init__(self, spec: "FaultSpec", labels: dict):
        super().__init__(spec, labels)
        self.device = spec.device if spec.device is not None \
            else labels.get("rank")


class InjectedPartition(InjectedFault):
    """A network partition severing the heartbeat/KV path between host
    groups: every rank on the far side of the observer joins the
    simulated-down set at once, and ``recovery`` classifies the failure
    ``partition`` — the quorum rule (``domains.majority_side``) then
    decides whether this side continues or exits.  ``groups`` are the
    partition's rank components, ``observer`` the rank whose side this
    controller observes from, ``lost`` the far-side ranks."""

    def __init__(self, spec: "FaultSpec", labels: dict):
        self.groups = [list(int(r) for r in g) for g in (spec.groups or [])]
        self.observer = int(spec.observer if spec.observer is not None
                            else 0)
        side = next((g for g in self.groups if self.observer in g),
                    [self.observer])
        self.lost = sorted(r for g in self.groups for r in g
                           if r not in side)
        super().__init__(spec, labels)


@dataclasses.dataclass
class FaultSpec:
    """One entry of a fault plan (see module docstring for semantics)."""

    site: str
    action: str = "raise"
    at: int = 1
    count: int = 1                       # -1 = fire forever once reached
    match: dict = dataclasses.field(default_factory=dict)
    device: int | None = None
    revive_after: int | None = None      # elastic probes until auto-revive
    hang_s: float = 0.2
    p: float | None = None               # seeded firing probability
    flips: int = 8                       # bytes inverted by "corrupt"
    groups: list | None = None           # "partition": the rank components
    observer: int | None = None          # "partition": this side's rank
    index: int = 0                       # position in the plan (set on load)

    @classmethod
    def from_dict(cls, d: dict, index: int) -> "FaultSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        bad = set(d) - known
        if bad:
            raise ValueError(f"unknown fault-spec keys {sorted(bad)} "
                             f"(known: {sorted(known - {'index'})})")
        spec = cls(**{k: v for k, v in d.items() if k != "index"})
        spec.index = index
        if spec.action not in ("raise", "device_loss", "hang", "exit",
                               "corrupt", "partition", "slow_link"):
            raise ValueError(f"unknown fault action {spec.action!r}")
        if spec.action == "partition" and not spec.groups:
            raise ValueError("a 'partition' spec needs 'groups' (the rank "
                             "components the partition splits into)")
        if spec.at < 1:
            raise ValueError(f"fault spec 'at' is 1-based, got {spec.at}")
        return spec


def _mix(seed: int, stream: int, n: int) -> int:
    """Integer seed mixing for per-(stream, invocation) RNG draws.
    Plain arithmetic, NOT tuple/str hashing: ``hash()`` of composite
    seeds is salted per process, which would break cross-process replay
    of a fault plan (and is deprecated as a Random seed anyway)."""
    return (seed * 1_000_003 + stream * 8_191 + n) & 0x7FFFFFFFFFFFFFFF


class _Injector:
    """Armed plan + per-spec counters + the simulated-down device set."""

    def __init__(self, specs: list[FaultSpec], seed: int):
        self.specs = specs
        self.seed = seed
        self.lock = threading.RLock()
        self.counts: dict[int, int] = {}      # spec.index -> invocations
        self.fired: list[dict] = []           # decision history (fired only)
        # device -> remaining elastic probes until auto-revive (None =
        # down until an explicit mark_up)
        self.down: dict[int, int | None] = {}
        # the active simulated partition, or None: {"groups", "observer",
        # "side", "lost", "spec"} — cleared once every lost rank revives
        self.partition: dict | None = None

    def decide(self, site: str, labels: dict) -> FaultSpec | None:
        with self.lock:
            for spec in self.specs:
                if spec.site != site:
                    continue
                if any(labels.get(k) != v for k, v in spec.match.items()):
                    continue
                n = self.counts.get(spec.index, 0) + 1
                self.counts[spec.index] = n
                if n < spec.at:
                    continue
                if spec.count >= 0 and n >= spec.at + spec.count:
                    continue
                if spec.p is not None:
                    # per-(spec, invocation) draw: immune to thread
                    # interleaving between ranks (determinism rule 1)
                    r = _random.Random(
                        _mix(self.seed, spec.index, n)).random()
                    if r >= spec.p:
                        continue
                self.fired.append({"site": site, "spec": spec.index,
                                   "invocation": n, "action": spec.action,
                                   "labels": dict(labels)})
                if spec.action == "device_loss":
                    dev = spec.device if spec.device is not None \
                        else labels.get("rank")
                    if dev is not None:
                        self.down[int(dev)] = spec.revive_after
                elif spec.action == "hang" and spec.device is not None:
                    # a hang spec naming a device models "goes quiet,
                    # then found dead": the site only sleeps, but the
                    # next elastic probe sees the device down — the
                    # straggler-detection scenario
                    self.down[int(spec.device)] = spec.revive_after
                elif spec.action == "partition":
                    # sever the heartbeat/KV path between the host
                    # groups: every rank on the far side of the observer
                    # joins the simulated-down set at once, and the
                    # partition state stays queryable (partition_state —
                    # the quorum rule's input) until they all revive
                    obs = int(spec.observer if spec.observer is not None
                              else 0)
                    groups = [[int(r) for r in g]
                              for g in (spec.groups or [])]
                    side = next((g for g in groups if obs in g), [obs])
                    lost = sorted(r for g in groups for r in g
                                  if r not in side)
                    for r in lost:
                        self.down[r] = spec.revive_after
                    self.partition = {"groups": groups, "observer": obs,
                                      "side": sorted(side), "lost": lost,
                                      "spec": spec.index}
                return spec
        return None

    def partition_gone(self) -> None:
        """Clear the partition record once every far-side rank healed
        (call with ``self.lock`` held)."""
        if self.partition is not None and \
                not any(r in self.down for r in self.partition["lost"]):
            self.partition = None


_injector: _Injector | None = None
_env_checked = False
_lock = threading.Lock()


def _load_plan(plan: Any) -> list[FaultSpec]:
    if isinstance(plan, str):
        s = plan.strip()
        if not s.lstrip().startswith("["):
            s = open(s).read()             # a path to a JSON plan file
        plan = json.loads(s)
    if not isinstance(plan, list):
        raise ValueError("fault plan must be a JSON list of spec objects")
    return [FaultSpec.from_dict(dict(d), i) for i, d in enumerate(plan)]


def configure(plan: Any = None, seed: int | None = None) -> None:
    """Arm a fault plan (a list of dicts/:class:`FaultSpec`, inline JSON,
    or a JSON file path).  ``plan=None`` re-reads ``DA_TPU_FAULT_PLAN``/
    ``DA_TPU_FAULT_SEED`` from the environment."""
    global _injector, _env_checked
    if plan is None:
        plan = os.environ.get(_PLAN_ENV)
    if seed is None:
        try:
            seed = int(os.environ.get(_SEED_ENV, "0"))
        except ValueError:
            seed = 0
    with _lock:
        _env_checked = True
        if plan is None:
            _injector = None
            return
        if isinstance(plan, list) and plan and isinstance(plan[0], FaultSpec):
            specs = list(plan)
            for i, s in enumerate(specs):
                s.index = i
        else:
            specs = _load_plan(plan)
        _injector = _Injector(specs, int(seed))
    if _tm.enabled():
        _tm.event("faults", "configure", specs=len(specs), seed=int(seed))


def clear() -> None:
    """Disarm fault injection entirely."""
    global _injector, _env_checked
    with _lock:
        _injector = None
        _env_checked = True


def _current() -> _Injector | None:
    global _env_checked
    if _injector is None and not _env_checked:
        # first touch: arm from the environment if a plan is exported
        # (DA_TPU_FAULT_PLAN without an explicit configure() call).
        # configure() takes _lock itself, so it must NOT be called with
        # the lock held; a benign race here at worst re-arms the same
        # env plan twice.
        if os.environ.get(_PLAN_ENV):
            configure()
        else:
            _env_checked = True
    return _injector


def active() -> bool:
    return _current() is not None


def decide(site: str, **labels) -> FaultSpec | None:
    """Advance this site's matching counters and return the spec that
    fires now, or None.  Decision only — no exception, no sleep; use
    from a parent process when the action must run elsewhere (forked
    SPMD ranks)."""
    inj = _current()
    if inj is None:
        return None
    spec = inj.decide(site, labels)
    if spec is not None:
        _tm.count("faults.fired", site=site, action=spec.action)
        if _tm.enabled():
            # cold path: a firing fault is an exceptional event by design
            _tm.event("faults", "fire", site=site, action=spec.action,
                      spec=spec.index, **{k: v for k, v in labels.items()
                                          if isinstance(v, (int, str))})
    return spec


def act(spec: FaultSpec | None, labels: dict | None = None) -> None:
    """Execute a fired spec's action (no-op for ``None``)."""
    if spec is None:
        return
    labels = labels or {}
    if spec.action == "hang":
        time.sleep(spec.hang_s)
        return
    if spec.action == "slow_link":
        # a degraded (not dead) link: sleep a seeded fraction of hang_s
        # at the collective/reshard site, then proceed normally — the
        # straggler detector's budget, not an exception, is what notices.
        # The delay is a pure function of (seed, spec, firing number), so
        # a chaos replay stalls the exact same invocations for the exact
        # same time.
        time.sleep(slow_link_delay(spec))
        return
    if spec.action == "device_loss":
        raise InjectedDeviceLoss(spec, labels)
    if spec.action == "partition":
        raise InjectedPartition(spec, labels)
    if spec.action == "corrupt":
        # payload-targeted action: the site applies the byte flips itself
        # via corrupt_arrays(); at a site that never consumes it the
        # firing is a recorded no-op, not an exception
        return
    if spec.action == "exit":
        # only meaningful in a forked SPMD rank: die without reporting.
        # In the controller process this degrades to a raise — killing
        # the controller would take the test harness with it.
        if os.environ.get("DA_TPU_FAULT_CHILD") == "1":
            os._exit(1)
        raise InjectedFault(spec, labels)
    raise InjectedFault(spec, labels)


def check(site: str, **labels) -> None:
    """Injection-point probe: decide and act in one step (thread-backend
    and controller-side sites).  One ``None`` test when disarmed."""
    if _injector is None and _env_checked:
        return
    act(decide(site, **labels), labels)


def _flipped(x, rng, flips: int):
    """A fresh copy of ``x`` (a tensor, on its device, or an array) with
    ``flips`` of its bytes inverted at seeded distinct offsets, and the
    count flipped; None for an empty payload."""
    import numpy as _np
    import torch as _torch
    if isinstance(x, _torch.Tensor):
        t = x.detach().contiguous().reshape(-1)
        if t.numel() == 0:
            return None, 0
        buf = t.view(_torch.uint8).cpu().numpy().copy()
    else:
        arr = _np.asarray(x)
        if arr.nbytes == 0:
            return None, 0
        buf = _np.frombuffer(arr.tobytes(), dtype=_np.uint8).copy()
    # distinct offsets: drawing with replacement could XOR the same
    # byte twice and cancel, making a "fired" corruption a no-op
    nflips = min(max(1, int(flips)), len(buf))
    for off in rng.sample(range(len(buf)), nflips):
        buf[off] ^= 0xFF
    if isinstance(x, _torch.Tensor):
        out = _torch.from_numpy(buf).to(x.device).view(x.dtype)
        return out.reshape(x.shape), nflips
    arr = _np.asarray(x)
    return _np.frombuffer(buf.tobytes(), dtype=arr.dtype).reshape(
        arr.shape), nflips


def corrupt_arrays(spec: FaultSpec, arrays: dict) -> dict:
    """Apply a fired ``corrupt`` spec to a payload dict: pick one entry
    (seeded) and invert ``spec.flips`` of its bytes at seeded offsets.
    Returns a new dict whose corrupted entry is a fresh copy (a tensor
    stays a tensor on its device); the caller's buffers are never
    mutated.  The draw is a pure function of ``(seed, spec.index, firing
    number)``, as in JAX."""
    inj = _current()
    if inj is None or not arrays:
        return arrays
    with inj.lock:
        n = inj.counts.get(spec.index, 0)      # the firing this applies to
    rng = _random.Random(_mix(inj.seed, spec.index + 100_003, n))
    keys = sorted(arrays)
    key = keys[rng.randrange(len(keys))]
    bad, nflips = _flipped(arrays[key], rng, spec.flips)
    if bad is None:
        return arrays
    out = dict(arrays)
    out[key] = bad
    _tm.count("faults.corruptions")
    if _tm.enabled():
        # cold path: a firing corruption is an exceptional event by design
        _tm.event("faults", "corrupt", key=key, flips=nflips,
                  spec=spec.index)
    return out


def slow_link_delay(spec: FaultSpec) -> float:
    """The seeded sleep one ``slow_link`` firing injects: a draw in
    ``[0.5, 1.0) * hang_s`` keyed by ``(seed, spec, firing number)`` —
    deterministic under replay, never zero (a fired slowdown that slept
    0 s would be unobservable by the straggler budget it exists to
    exercise)."""
    inj = _current()
    if inj is None:
        return float(spec.hang_s)
    with inj.lock:
        n = inj.counts.get(spec.index, 0)      # the firing this applies to
    u = _random.Random(_mix(inj.seed, spec.index + 50_021, n)).random()
    return float(spec.hang_s) * (0.5 + 0.5 * u)


def partition_state() -> dict | None:
    """The active simulated partition (``{"groups", "observer", "side",
    "lost", "spec"}``), or None — the quorum rule's deterministic input
    (``elastic.quorum_assess`` consults it).  Clears automatically once every far-side rank
    has revived."""
    inj = _current()
    if inj is None:
        return None
    with inj.lock:
        inj.partition_gone()
        return dict(inj.partition) if inj.partition is not None else None


def heal_partition() -> None:
    """Explicitly heal the simulated partition: revive every far-side
    rank and clear the partition record (the operator escape hatch for
    specs with no ``revive_after`` countdown)."""
    inj = _current()
    if inj is None:
        return
    with inj.lock:
        if inj.partition is None:
            return
        for r in inj.partition["lost"]:
            if inj.down.pop(r, "absent") != "absent":
                _tm.count("faults.revives")
        inj.partition = None
    _tm.count("faults.partition_heals")


def history() -> list[dict]:
    """Fired-decision history (site, spec index, invocation, action,
    labels) — the determinism witness: same plan + seed ⇒ same history."""
    inj = _current()
    if inj is None:
        return []
    with inj.lock:
        return [dict(f) for f in inj.fired]


def simulated_down() -> set[int]:
    """Device ranks the armed plan currently simulates as unreachable."""
    inj = _current()
    if inj is None:
        return set()
    with inj.lock:
        return set(inj.down)


def revive(rank: int) -> None:
    """Explicitly revive a simulated-down device — the escape hatch for
    ``device_loss`` specs with no ``revive_after`` countdown (``None`` =
    down until this call).  ``elastic.mark_up`` calls it, so the
    operator's mark_up works the same for manual and plan-downed
    devices."""
    inj = _current()
    if inj is None:
        return
    with inj.lock:
        if inj.down.pop(int(rank), "absent") != "absent":
            _tm.count("faults.revives")
        inj.partition_gone()


def probe_tick() -> set[int]:
    """One elastic health-probe epoch: decrement every downed device's
    ``revive_after`` countdown, reviving those that reach zero.  Returns
    the ranks still down after the tick."""
    inj = _current()
    if inj is None:
        return set()
    with inj.lock:
        for dev in list(inj.down):
            left = inj.down[dev]
            if left is None:
                continue
            left -= 1
            if left <= 0:
                del inj.down[dev]
                _tm.count("faults.revives")
            else:
                inj.down[dev] = left
        inj.partition_gone()
        return set(inj.down)


def jitter(scale: float = 1.0) -> float:
    """A jitter factor in ``[0, scale)`` — seeded (deterministic) while a
    fault plan is armed, genuinely random otherwise.  Used by recovery
    backoff so chaos runs replay exactly."""
    inj = _current()
    if inj is None:
        return _random.random() * scale
    with inj.lock:
        n = inj.counts.get(-1, 0) + 1
        inj.counts[-1] = n
    # stream -1 is reserved for jitter (spec indices are >= 0)
    return _random.Random(_mix(inj.seed, -1, n)).random() * scale
