"""Doctor-driven self-tuning: perf findings -> guarded autotune writes.

The port's copy of ``distributedarrays_tpu/telemetry/advisor.py``: the
same actions, decision logic, guarded apply, counters
(``autotune.advisor_{actions,writes,skips,rollbacks,applies}``), journal
events and rendering.  JAX's three actions tune knobs that the port's
kernels do not have, so two are mapped onto a knob the port reads and one
onto none:

=========================  ====================  =========================
JAX action (finding)       port registry target  probe (on the card: the
                                                 kernel, then a device
                                                 synchronization)
=========================  ====================  =========================
``rdma_chunks``:           none: skipped (see    none
``unoverlapped_comm`` on   :data:`NO_PORT_KNOB`)
a ``dispatch="rdma"``
``reshard`` span; double
the depth (cap 64)
``dispatch``: one          ``matmul_impl_dist``  ``_ring_ag_probe``: the
``dispatch_key`` measured  (``"ring_ag"``, the   (p,1) x (p,1) GEMM
under both dispatches      K14 ring, for a       through ``matmul`` under
(JAX ``rdma``/``xla``;     faster ``rdma``;      the registry state being
the port's ``rdma``/       ``"torch"`` for a     judged
``torch``); pin the        faster ``torch``)
faster
``resweep``:               ``matmul_impl``       ``_gemm_probe``: the
``low_roofline`` on        (``"pallas"`` = K1,   one-rank GEMM of the
``pallas.matmul``          ``"torch"``) at the   finding's shape on the
(JAX: re-sweep the block)  key K1's span         route the registry (or
                           stamps; the sweep     the candidate being
                           times both routes     swept) names
=========================  ====================  =========================

The reshard's copy kernel (K10/K11) writes every piece at its final offset
in one launch, so the port reads no piece count a tuned ``rdma_chunks``
entry could set, and its ``reshard`` span carries no ``autotune_key``: the
doctor never proposes the action from the port's own journal.  On a
journal that does propose it (JAX's), :func:`advise` still decides as JAX
does, so one report maps alike, and :func:`apply` skips the action with
that reason, writing and probing nothing.  K1 has no block knob
(``ops/cuda_gemm.gemm_route`` picks its route by dtype and alignment, each
route's tiles are fixed), so its re-sweep runs ``autotune.sweep`` over the
two routes.  The doctor is JAX's, unchanged:
its hints still name ``rdma_chunks``, ``rdma_dispatch`` and
``pallas_matmul``; :func:`advise` maps them.

:func:`apply` executes actions under guard: micro-probe before,
provenance-stamped registry write (source=advisor, evidence = finding kind
+ measured before-metrics, bounded undo journal), micro-probe after, the
pair judged by ``regress.compare``; a regressing tune is rolled back via
``autotune.undo`` and fires the ``autotune_regressed`` alert.  Probes are
injectable (``probe=``); ``DA_TPU_ADVISE_PROBE_CMD`` runs a shell command a
sample and uses its wall time (the command sees the action's address and
the port's cache file, ``DAT_TORCH_AUTOTUNE_CACHE``).  ``persist=True``
writes the port's cache file (``autotune.default_cache_path()``) after each
decision.  Surfaced as ``python -m distributedarrays_tpu_torch.telemetry
advise [--apply|--json]``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import time
from typing import Any, Callable

from . import core as _core
from . import regress as _regress

__all__ = ["TuningAction", "advise", "apply", "dispatch_deltas",
           "default_probe", "format_results", "PROBE_METRIC",
           "PROBE_CMD_ENV", "MAX_CHUNKS", "GEMM_ROUTES", "NO_PORT_KNOB"]

PROBE_METRIC = "advise_probe_s"
PROBE_CMD_ENV = "DA_TPU_ADVISE_PROBE_CMD"
MAX_CHUNKS = 64          # JAX resolve_chunks' derived-depth cap
# the JAX actions' registry kernels that no knob of the port reads, and why
NO_PORT_KNOB = {
    "rdma_chunks": "no port knob: the reshard's copy kernel writes every "
                   "piece at its final offset in one launch, so no piece "
                   "count is read",
}
# the one-rank GEMM's registry choices, swept by a resweep action
GEMM_ROUTES = ("pallas", "torch")
# a dispatch class -> the matmul_impl_dist value that selects it
_DIST_IMPL = {"rdma": "ring_ag", "torch": "torch"}
# dispatch preference needs a real measured gap, not scheduler jitter
_DISPATCH_MIN_DELTA = 0.10


@dataclasses.dataclass
class TuningAction:
    """One proposed registry write.

    ``kind``: ``rdma_chunks`` / ``dispatch`` / ``resweep``; ``kernel`` +
    ``key`` address the autotune entry (``rdma_chunks``,
    ``matmul_impl_dist``, ``matmul_impl``); ``proposed`` is the value to
    write (for ``resweep``, the sweep's winner at apply time, over
    ``candidates``).  ``probe`` is the spec the default micro-probe
    rebuilds the workload from (shape / dtype / partition info straight
    off the span labels)."""

    kind: str
    kernel: str
    key: str
    current: Any
    proposed: Any
    finding: str
    evidence: dict
    probe: dict
    candidates: list | None = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# the decision table
# ---------------------------------------------------------------------------


def _as_int(v, default=0) -> int:
    try:
        return int(v)
    except (TypeError, ValueError):
        return default


def _probe_spec(name, labels: dict) -> dict:
    """Micro-probe reconstruction spec off one span's labels."""
    labels = labels or {}
    spec = {"op": name}
    for k in ("shape", "dtype", "src_dim", "dst_dim", "nparts", "ranks",
              "strategy"):
        if labels.get(k) not in (None, ""):
            spec[k] = labels[k]
    return spec


def dispatch_deltas(analysis: dict) -> list[dict]:
    """Ring-vs-torch side-by-side deltas from the doctor's dispatch-labeled
    overlap stats: for every ``dispatch_key`` observed under BOTH
    dispatches (``rdma``: the ring kernel; ``torch``: the default GEMM),
    the mean duration per class and which one measured faster.  Spans in
    one class only yield nothing (no comparison)."""
    by_key: dict[str, dict[str, list]] = {}
    samples: dict[str, dict] = {}
    for ov in analysis.get("overlap") or []:
        labels = ov.get("labels") or {}
        key = labels.get("dispatch_key")
        disp = ov.get("dispatch")
        if not key or disp not in _DIST_IMPL:
            continue
        by_key.setdefault(key, {}).setdefault(disp, []).append(
            float(ov["dur"]))
        samples.setdefault(key, {})[disp] = ov
    out = []
    for key, sides in by_key.items():
        if "rdma" not in sides or "torch" not in sides:
            continue
        rdma_s = statistics.mean(sides["rdma"])
        torch_s = statistics.mean(sides["torch"])
        slower, faster = max(rdma_s, torch_s), min(rdma_s, torch_s)
        out.append({
            "key": key,
            "rdma_s": round(rdma_s, 9), "torch_s": round(torch_s, 9),
            "n_rdma": len(sides["rdma"]), "n_torch": len(sides["torch"]),
            "faster": "rdma" if rdma_s <= torch_s else "torch",
            "delta_frac": round((slower - faster) / slower, 4)
            if slower > 0 else 0.0,
            "span": samples[key].get(
                "rdma" if rdma_s <= torch_s else "torch"),
        })
    out.sort(key=lambda d: -d["delta_frac"])
    return out


def advise(analysis: dict) -> list[TuningAction]:
    """Map one doctor report (``perf.analyze`` output) to tuning actions
    — at most one per ``(kernel, key)``, worst finding wins.  Pure
    decision logic: nothing is measured or written here."""
    from ..utils import autotune
    actions: dict[tuple, TuningAction] = {}
    overlaps = {ov.get("span_id"): ov
                for ov in analysis.get("overlap") or []}
    classified = {occ.get("span_id"): occ
                  for occ in analysis.get("classified") or []}

    for f in analysis.get("findings") or []:
        hint = f.get("action") or {}
        if f.get("kind") == "unoverlapped_comm" and \
                hint.get("kernel") == "rdma_chunks":
            key = hint["key"]
            if ("rdma_chunks", key) in actions:
                continue
            cur = _as_int(hint.get("current"), 0)
            if cur >= MAX_CHUNKS:
                continue           # already at the depth cap
            proposed = min(max(cur * 2, 2), MAX_CHUNKS)
            if proposed == cur:
                continue
            ov = overlaps.get(f.get("span_id")) or {}
            actions[("rdma_chunks", key)] = TuningAction(
                kind="rdma_chunks", kernel="rdma_chunks", key=key,
                current=autotune.get("rdma_chunks", key),
                proposed=[proposed], finding="unoverlapped_comm",
                evidence={"severity_s": f.get("severity_s"),
                          "overlap_frac": ov.get("overlap_frac"),
                          "unoverlapped_s": ov.get("unoverlapped_s"),
                          "dur_s": ov.get("dur"),
                          "chunks": cur},
                probe=_probe_spec(ov.get("name"), ov.get("labels")))
        elif f.get("kind") == "low_roofline" and \
                hint.get("kernel") == "pallas_matmul":
            key = hint["key"]
            if ("matmul_impl", key) in actions:
                continue
            shape = hint.get("shape")
            if not shape or len(shape) != 3 or \
                    min(_as_int(s) for s in shape) < 1:
                continue
            occ = classified.get(f.get("span_id")) or {}
            actions[("matmul_impl", key)] = TuningAction(
                kind="resweep", kernel="matmul_impl", key=key,
                current=autotune.get("matmul_impl", key),
                proposed=None, finding="low_roofline",
                evidence={"severity_s": f.get("severity_s"),
                          "roofline_frac": occ.get("roofline_frac"),
                          "bound": occ.get("bound"),
                          "dur_s": occ.get("dur")},
                probe={"op": "pallas.matmul", "shape": shape,
                       "dtype": hint.get("dtype")},
                candidates=list(GEMM_ROUTES))

    for d in dispatch_deltas(analysis):
        key = d["key"]
        if ("matmul_impl_dist", key) in actions:
            continue
        if d["delta_frac"] < _DISPATCH_MIN_DELTA:
            continue
        want = _DIST_IMPL[d["faster"]]
        cur = autotune.get("matmul_impl_dist", key)
        if cur == want:
            continue               # already pinned to the winner
        span = d.pop("span", None) or {}
        actions[("matmul_impl_dist", key)] = TuningAction(
            kind="dispatch", kernel="matmul_impl_dist", key=key,
            current=cur, proposed=want,
            finding="dispatch_delta", evidence=dict(d),
            probe=_probe_spec(span.get("name"), span.get("labels")))

    out = sorted(actions.values(),
                 key=lambda a: -float(a.evidence.get("severity_s")
                                      or a.evidence.get("delta_frac")
                                      or 0.0))
    for a in out:
        _core.count("autotune.advisor_actions", kind=a.kind)
    return out


# ---------------------------------------------------------------------------
# micro-probes
# ---------------------------------------------------------------------------


def _cmd_probe(action: TuningAction, config=None) -> float:
    """Wall-time a user-supplied shell command (``DA_TPU_ADVISE_PROBE_CMD``)
    — the command sees the action's address in its env and the port's
    autotune cache file via ``DAT_TORCH_AUTOTUNE_CACHE``."""
    from ..utils import autotune
    env = dict(os.environ)
    env["DA_TPU_ADVISE_KERNEL"] = action.kernel
    env["DA_TPU_ADVISE_KEY"] = action.key
    env["DA_TPU_ADVISE_CONFIG"] = json.dumps(config)
    env["DAT_TORCH_AUTOTUNE_CACHE"] = autotune.default_cache_path()
    t0 = time.perf_counter()
    subprocess.run(os.environ[PROBE_CMD_ENV], shell=True, check=True,
                   env=env, capture_output=True)
    return time.perf_counter() - t0


def _torch_dtype(name, default="float32"):
    import torch
    dt = getattr(torch, str(name or default).removeprefix("torch."), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"probe dtype {name!r} is not a torch dtype")
    return dt


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _ring_ag_probe(action: TuningAction, config=None) -> float:
    """The (p,1) x (p,1) GEMM of the journaled shape class through
    ``matmul``, whose ``matmul_impl_dist`` entry picks the ring kernel
    (``"ring_ag"``) or the default (``"torch"``)."""
    import torch

    from .. import layout as L
    from ..darray import distribute
    from ..ops import linalg
    spec = action.probe
    m, k, n = (int(s) for s in spec["shape"])
    p = int(spec.get("ranks") or spec.get("nparts") or 2)
    dtype = _torch_dtype(spec.get("dtype"))
    dev = L.device_of(0)
    procs = list(range(p))
    A = distribute(torch.zeros((m, k), dtype=dtype, device=dev),
                   procs=procs, dist=[p, 1])
    B = distribute(torch.zeros((k, n), dtype=dtype, device=dev),
                   procs=procs, dist=[p, 1])
    C = None
    try:
        _sync(dev)
        t0 = time.perf_counter()
        C = linalg.matmul(A, B)
        _sync(dev)
        return time.perf_counter() - t0
    finally:
        for d in (A, B, C):
            if d is not None:
                d.close()


def _gemm_probe(action: TuningAction, config=None) -> float:
    """The one-rank GEMM of the finding's shape on rank 0's device, on the
    route the registry's ``matmul_impl`` entry names (``config``, a route
    of :data:`GEMM_ROUTES`, overrides it during a re-sweep): ``"pallas"``
    is K1, ``"torch"`` ``torch.matmul``."""
    import torch

    from .. import layout as L
    from ..ops import cuda_gemm, linalg
    spec = action.probe
    m, k, n = (int(s) for s in spec["shape"])
    dts = spec.get("dtype") or ["float32", "float32"]
    if isinstance(dts, str):
        dts = [dts, dts]
    da, db = (_torch_dtype(x) for x in dts)
    route = config or linalg._impl_choice(m, n, k, da, db)
    if route not in GEMM_ROUTES:
        raise ValueError(f"unknown GEMM route {route!r}")
    dev = L.device_of(0)
    a = torch.zeros((m, k), dtype=da, device=dev)
    b = torch.zeros((k, n), dtype=db, device=dev)
    fn = cuda_gemm.cuda_matmul if route == "pallas" else torch.matmul
    _sync(dev)
    t0 = time.perf_counter()
    fn(a, b)
    _sync(dev)
    return time.perf_counter() - t0


def default_probe(action: TuningAction, config=None) -> float:
    """One micro-probe sample (seconds) for ``action`` under the CURRENT
    registry state (``config`` only overrides during re-sweep candidate
    timing).  ``DA_TPU_ADVISE_PROBE_CMD`` takes over when set."""
    if os.environ.get(PROBE_CMD_ENV):
        return _cmd_probe(action, config)
    if action.kind == "resweep" or action.kernel == "matmul_impl":
        return _gemm_probe(action, config)
    if action.kernel == "matmul_impl_dist":
        return _ring_ag_probe(action, config)
    raise ValueError(NO_PORT_KNOB.get(
        action.kernel, f"no probe for {action.kernel!r}"))


# ---------------------------------------------------------------------------
# guarded apply
# ---------------------------------------------------------------------------


def _samples(probe, action, repeats: int) -> list[float]:
    probe(action)                 # warmup: build and first-touch cost
    return [float(probe(action)) for _ in range(repeats)]


def apply(actions, *, probe: Callable | None = None, repeats: int = 3,
          mad_k: float = 3.0, rel_floor: float = 0.15,
          persist: bool = False, manager=None,
          evaluate_alerts: bool = True, now: float | None = None) -> list:
    """Execute tuning actions under the rollback guard.

    Per action: micro-probe ``repeats`` samples before, write the
    proposal with advisor provenance (``autotune.record`` — bounded undo
    journal), probe again after, judge the pair with
    ``regress.compare`` (the before samples ARE the baseline series).  A
    ``regression`` verdict rolls the entry back (``autotune.undo``) and
    drives the ``autotune_regressed`` alert; anything else keeps the
    tune.  A ``resweep`` action first runs ``autotune.sweep`` over its
    candidate routes (``record_best=False``) to pick the proposal.  An
    action on a kernel of :data:`NO_PORT_KNOB` is skipped with its reason,
    unprobed.

    ``probe(action, config=None) -> seconds`` is injectable; default
    :func:`default_probe`.  ``persist=True`` writes the registry to the
    port's default cache after each decision.  Returns one result dict
    per action (``status``: ``applied`` / ``rolled_back`` /
    ``skipped``)."""
    from ..utils import autotune
    from . import alerts
    probe = probe or default_probe
    mgr = manager
    if evaluate_alerts:
        mgr = mgr if mgr is not None else alerts.default_manager()
        alerts.ensure_autotune_rule(mgr)
    results = []
    for action in actions:
        res = action.to_dict()
        if action.kernel in NO_PORT_KNOB:
            res.update(status="skipped", reason=NO_PORT_KNOB[action.kernel])
            _core.count("autotune.advisor_skips", kind=action.kind)
            results.append(res)
            continue
        try:
            before = _samples(probe, action, repeats)
        except Exception as e:
            res.update(status="skipped",
                       reason=f"probe failed: {type(e).__name__}: {e}")
            _core.count("autotune.advisor_skips", kind=action.kind)
            results.append(res)
            continue
        proposed = action.proposed
        if action.kind == "resweep":
            try:
                proposed, sweep_times = autotune.sweep(
                    action.kernel, action.key, action.candidates,
                    timer=lambda cfg: probe(action, cfg),
                    record_best=False)
                res["sweep_candidates"] = len(sweep_times)
            except Exception as e:
                res.update(status="skipped",
                           reason=f"sweep failed: {type(e).__name__}: {e}")
                _core.count("autotune.advisor_skips", kind=action.kind)
                results.append(res)
                continue
        res["proposed"] = proposed
        if proposed == action.current:
            res.update(status="skipped", reason="already at proposal",
                       before_s=before)
            _core.count("autotune.advisor_skips", kind=action.kind)
            results.append(res)
            continue
        autotune.record(action.kernel, action.key, proposed, provenance={
            "source": "advisor",
            "finding": action.finding,
            "evidence": dict(action.evidence,
                             before_s=[round(s, 9) for s in before]),
            "previous": action.current,
            "ts": time.time(),
        })
        _core.count("autotune.advisor_writes", kind=action.kind)
        try:
            after = _samples(probe, action, repeats)
        except Exception as e:
            # cannot verify: the guarded contract is measure-or-revert
            autotune.undo(action.kernel, action.key)
            res.update(status="rolled_back",
                       reason=f"after-probe failed: "
                              f"{type(e).__name__}: {e}",
                       before_s=before)
            _core.count("autotune.advisor_rollbacks", kind=action.kind)
            results.append(res)
            _journal(action, res)
            if evaluate_alerts:
                mgr.evaluate(now)
            continue
        verdicts = _regress.compare(
            {PROBE_METRIC: statistics.median(after)},
            {PROBE_METRIC: before},
            mad_k=mad_k, rel_floor=rel_floor)
        verdict = verdicts[0] if verdicts else {"status": "ok"}
        res.update(before_s=[round(s, 9) for s in before],
                   after_s=[round(s, 9) for s in after],
                   verdict=verdict)
        if verdict.get("status") == "regression":
            autotune.undo(action.kernel, action.key)
            res["status"] = "rolled_back"
            res["reason"] = (
                f"micro-probe regressed: {verdict['value']:.6g}s vs "
                f"median {verdict['median']:.6g}s (allowed "
                f"{verdict['threshold']:.3g})")
            _core.count("autotune.advisor_rollbacks", kind=action.kind)
        else:
            res["status"] = "applied"
            _core.count("autotune.advisor_applies", kind=action.kind)
        if persist:
            autotune.save_default()
        _journal(action, res)
        if evaluate_alerts:
            mgr.evaluate(now)
        results.append(res)
    return results


def _journal(action: TuningAction, res: dict) -> None:
    if not _core._ENABLED:
        return
    _core.event("autotune", "advise",
                kernel=action.kernel, key=action.key,
                kind=action.kind, finding=action.finding,
                old=action.current, new=res.get("proposed"),
                status=res["status"], reason=res.get("reason"),
                before_s=res.get("before_s"), after_s=res.get("after_s"))


def format_results(actions: list, results: list | None, out) -> None:
    """Human rendering for the ``advise`` CLI: one line per action, with
    apply outcomes when present."""
    if not actions:
        out.write("no tuning actions: the journal shows nothing the "
                  "advisor can address\n")
        return
    by_addr = {(r["kernel"], r["key"]): r for r in results or []}
    for a in actions:
        d = a.to_dict() if isinstance(a, TuningAction) else dict(a)
        r = by_addr.get((d["kernel"], d["key"]))
        if r is None and d["kernel"] in NO_PORT_KNOB:
            r = {"status": "skipped", "reason": NO_PORT_KNOB[d["kernel"]]}
        status = (r or {}).get("status", "proposed")
        proposed = (r or {}).get("proposed", d.get("proposed"))
        out.write(f"{status.upper():<12} {d['kernel']}[{d['key']}]: "
                  f"{d.get('current')} -> {proposed} "
                  f"({d['finding']})\n")
        ev = d.get("evidence") or {}
        keys = [k for k in ("severity_s", "overlap_frac", "roofline_frac",
                            "delta_frac", "rdma_s", "torch_s") if
                ev.get(k) is not None]
        if keys:
            out.write("             evidence: " +
                      "  ".join(f"{k}={ev[k]:.6g}" for k in keys) + "\n")
        if r and r.get("reason"):
            out.write(f"             {r['reason']}\n")
        if r and r.get("before_s") and r.get("after_s"):
            out.write(
                f"             probe: before median "
                f"{statistics.median(r['before_s']):.6g}s, after median "
                f"{statistics.median(r['after_s']):.6g}s "
                f"(n={len(r['before_s'])})\n")
