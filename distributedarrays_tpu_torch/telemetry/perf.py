"""Performance observatory: analytic cost stamps, the peak table and the
roofline doctor.

The port's copy of ``distributedarrays_tpu/telemetry/perf.py``, pure
stdlib as there (a journal pulled off a machine analyzes anywhere):

- **cost stamps** (``gemm_cost``, ``reshard_cost``, ``transfer_cost``,
  ``attention_cost``, ``reduce_cost``, ``decode_step_cost``,
  ``spmv_cost``, ``train_step_cost``): flops and bytes computed from
  shapes at a call site, stamped as span labels (``flops``,
  ``bytes_hbm``, ``bytes_ici``; ``bytes_ici`` is the bytes that cross a
  rank boundary, whatever the link).
- **the peak table** (:data:`DEFAULT_PEAKS`, ``DA_TPU_PEAKS`` overrides
  it): JAX's schema, one ``flops``/``hbm``/``ici`` a platform, with an
  ``h100`` entry for the NVIDIA H100 80GB HBM3 at its 700 W limit:
  ``flops`` its dense bf16 tensor-core rate (989 TFLOP/s, so an f32 span
  reads at most 67/989 of it), ``hbm`` 3.35 TB/s and ``ici`` one
  direction of NVLink 4 (450 GB/s).  ``platform_alias`` maps
  ``torch.cuda.get_device_name()`` onto it.  On one card the
  ``bytes_ici`` of ranks that share it cross no link, so a span whose
  only resource is ``ici`` can read above the NVLink rate;
  ``classify_occurrence`` caps every fraction at 1, as in JAX.
- **the doctor** (``span_cost`` ... ``analyze``, ``format_analysis``):
  roofline classification, overlap and the critical path as ranked
  findings, unchanged from JAX, ``action`` hints included.  With neither
  ``peaks`` nor ``platform`` given, ``analyze`` reads the platform from
  the journal: the ``device``/``platform`` event that ``layout.init``
  journals (:func:`journal_platform`); a journal without one reads as
  ``cpu``, JAX's default.

A span around an asynchronous CUDA launch measures the host's dispatch,
not the kernel, as a span around JAX's asynchronous dispatch does; the
fractions that mean something are those of spans that end at a device
synchronization (``train.step``, ``train.sync``).

``python -m distributedarrays_tpu_torch.telemetry doctor RUN.jsonl``
renders the report.
"""

from __future__ import annotations

import json
import os

__all__ = [
    "DEFAULT_PEAKS", "peaks_for", "platform_alias", "journal_platform",
    "gemm_cost", "reshard_cost", "attention_cost", "reduce_cost",
    "transfer_cost", "train_step_cost",
    "decode_step_cost", "spmv_cost",
    "span_cost", "classify_occurrence", "classify", "coverage",
    "overlap_stats", "interval_overlap", "timeline_overlap",
    "train_step_overlap", "critical_path", "analyze",
]

PEAKS_ENV = "DA_TPU_PEAKS"

# Per-platform SINGLE-CHIP peaks: dense flops/s (bf16 for TPUs), HBM
# bytes/s, and aggregate ICI bytes/s over one chip's links.  Datasheet
# numbers for the TPUs; the CPU row is a deliberately round
# single-socket default — every number here is a *denominator for a
# fraction*, overridable via DA_TPU_PEAKS (inline JSON or a path to
# one): either a full ``{platform: {...}}`` table merged over the
# defaults, or a single ``{"flops": ...}`` dict applied to whatever
# platform is selected.
#
# Convention: span cost stamps are AGGREGATE volumes over all
# participating devices (2mnk flops for the whole distributed GEMM, the
# plan's total moved bytes, ...), while these peaks are single-chip —
# so a p-way span's roofline fraction reads as achieved share of ONE
# chip's peak (capped at 1).  The binding-resource classification and
# any comparison between spans of the same world size are exact; the
# absolute fraction of a multi-chip span is a conservative lower bound
# on how far it sits from the hardware roofline.
DEFAULT_PEAKS = {
    "tpu-v5e": {"flops": 197e12, "hbm": 819e9, "ici": 200e9},
    "tpu-v5p": {"flops": 459e12, "hbm": 2765e9, "ici": 600e9},
    # NVIDIA H100 80GB HBM3 (SXM) at its 700 W limit: dense bf16 tensor
    # cores, HBM3, one direction of NVLink 4
    "h100": {"flops": 989e12, "hbm": 3.35e12, "ici": 450e9},
    "cpu": {"flops": 2e11, "hbm": 5e10, "ici": 2e10},
}

_ALIASES = {
    "v5e": "tpu-v5e", "tpu v5e": "tpu-v5e", "tpu v5 lite": "tpu-v5e",
    "tpu-v5litepod": "tpu-v5e", "v5litepod": "tpu-v5e",
    "v5p": "tpu-v5p", "tpu v5p": "tpu-v5p", "tpu v5": "tpu-v5p",
    "nvidia h100 80gb hbm3": "h100", "nvidia h100": "h100",
    "h100 80gb hbm3": "h100", "nvidia h100 sxm": "h100",
    "cpu": "cpu", "host": "cpu", "interpret": "cpu",
}

_RESOURCES = ("flops", "bytes_hbm", "bytes_ici")
_BOUND = {"flops": "compute", "bytes_hbm": "hbm", "bytes_ici": "ici"}
_PEAK_OF = {"flops": "flops", "bytes_hbm": "hbm", "bytes_ici": "ici"}


def platform_alias(name: str | None) -> str:
    """Normalize a platform/device-kind string to a peak-table key
    (unknown names fall back to ``cpu`` — the conservative denominator)."""
    if not name:
        return "cpu"
    key = str(name).strip().lower()
    if key in DEFAULT_PEAKS:
        return key
    return _ALIASES.get(key, "cpu")


def peaks_for(platform: str | None = None) -> dict:
    """The ``{"flops", "hbm", "ici"}`` peak dict for ``platform``,
    after applying the ``DA_TPU_PEAKS`` override (inline JSON or a path
    to a JSON file; a full per-platform table or a single flat dict)."""
    plat = platform_alias(platform)
    table = {k: dict(v) for k, v in DEFAULT_PEAKS.items()}
    raw = os.environ.get(PEAKS_ENV)
    if raw:
        doc = None
        try:
            doc = json.loads(raw)
        except ValueError:
            try:
                with open(raw) as f:
                    doc = json.load(f)
            except (OSError, ValueError):
                doc = None
        if isinstance(doc, dict):
            if any(isinstance(v, dict) for v in doc.values()):
                for k, v in doc.items():
                    if isinstance(v, dict):
                        table.setdefault(platform_alias(k), {}).update(
                            {kk: float(vv) for kk, vv in v.items()})
            else:                       # flat override for this platform
                table.setdefault(plat, {}).update(
                    {kk: float(vv) for kk, vv in doc.items()})
    peaks = dict(DEFAULT_PEAKS["cpu"])
    peaks.update(table.get(plat, {}))
    peaks["platform"] = plat
    return peaks


def journal_platform(events: list) -> str | None:
    """The device kind a port journal was recorded on: the last
    ``device``/``platform`` event's ``platform`` (``layout.init`` journals
    ``torch.cuda.get_device_name()`` or ``cpu``), None when it has none."""
    kind = None
    for e in events:
        if e.get("cat") == "device" and e.get("name") == "platform":
            kind = e.get("platform")
    return kind



# ---------------------------------------------------------------------------
# analytic cost stamps (computed from shapes at the instrumented call site)
# ---------------------------------------------------------------------------


def gemm_cost(m: int, n: int, k: int, itemsize: int = 4, *,
              out_itemsize: int | None = None,
              bytes_ici: int = 0) -> dict:
    """Roofline stamp for an ``(m, k) @ (k, n)`` GEMM: ``2mnk`` flops,
    operands read + result written once through HBM, and whatever cross-rank
    volume the caller's collective plan implies."""
    oi = itemsize if out_itemsize is None else int(out_itemsize)
    return {
        "flops": 2 * int(m) * int(n) * int(k),
        "bytes_hbm": (int(m) * int(k) + int(k) * int(n)) * int(itemsize)
        + int(m) * int(n) * oi,
        "bytes_ici": int(bytes_ici),
    }


def reshard_cost(total_bytes: int, moved_bytes: int) -> dict:
    """Stamp for a reshard: every byte read and rewritten through HBM,
    the plan's *moved* bytes crossing a device boundary, zero flops."""
    return {"flops": 0, "bytes_hbm": 2 * int(total_bytes),
            "bytes_ici": int(moved_bytes)}


def transfer_cost(nbytes: int) -> dict:
    """Stamp for a host<->device transfer (distribute / gather): the
    payload through HBM once; no flops, nothing across ranks."""
    return {"flops": 0, "bytes_hbm": int(nbytes), "bytes_ici": 0}


def attention_cost(s: int, h: int, d: int, itemsize: int = 4, *,
                   p: int = 1, causal: bool = False) -> dict:
    """Stamp for exact attention over a ``(s, h, d)`` q/k/v triple
    sharded over ``p`` ranks: two ``s x s x d`` GEMMs per head (halved
    causal), q/k/v/o through HBM once, and the k/v chunks rotating
    ``p - 1`` ring steps between ranks."""
    fl = 4 * int(s) * int(s) * int(h) * int(d)
    if causal:
        fl //= 2
    kv = 2 * int(s) * int(h) * int(d) * int(itemsize)
    return {
        "flops": fl,
        "bytes_hbm": 4 * int(s) * int(h) * int(d) * int(itemsize),
        "bytes_ici": (int(p) - 1) * kv if p > 1 else 0,
    }


def decode_step_cost(ctx_tokens: int, h: int, d: int,
                     itemsize: int = 4, *, new_tokens: int = 1) -> dict:
    """Stamp for one continuous-batching decode step: ``ctx_tokens``
    resident context rows across the batch attended by ``new_tokens``
    single-row queries: two row-by-context GEMVs a head (``4 ctx h d``
    flops) against the whole K/V working set read once, and the new rows
    written back (about 0.5 flop a byte in f32: bound by memory, where
    prefill's ``attention_cost`` is bound by operations)."""
    e = int(h) * int(d)
    return {
        "flops": 4 * int(ctx_tokens) * e,
        "bytes_hbm": (2 * int(ctx_tokens) + 3 * int(new_tokens)) * e
        * int(itemsize),
        "bytes_ici": 0,
    }


def spmv_cost(nnz: int, rows: int, itemsize: int = 4, *,
              index_itemsize: int = 4, bytes_ici: int = 0) -> dict:
    """Stamp for a sparse (or stencil) matvec: 2 flops per stored
    nonzero against the nonzeros (values + column indices) streamed
    from HBM once, plus the vector read and result written back.
    Arithmetic intensity ~0.25 flop/byte at f32+int32 — far under any
    ridge point, so SpMV is bound by memory, or by the halo exchange
    (``bytes_ici``) once that dominates.  Stencil
    callers pass ``index_itemsize=0`` (the pattern compiles into the
    kernel; only values move)."""
    return {
        "flops": 2 * int(nnz),
        "bytes_hbm": int(nnz) * (int(itemsize) + int(index_itemsize))
        + 2 * int(rows) * int(itemsize),
        "bytes_ici": int(bytes_ici),
    }


def reduce_cost(n_elems: int, itemsize: int = 4, *,
                flops_per_elem: int = 1) -> dict:
    """Stamp for a mapreduce-style sweep: about 1 flop and one read
    through HBM an element (the map's cost is unknown: this is the floor,
    which classifies the sweep as bound by memory exactly when it should
    be)."""
    return {"flops": int(n_elems) * int(flops_per_elem),
            "bytes_hbm": int(n_elems) * int(itemsize), "bytes_ici": 0}


def train_step_cost(n_params: int, p: int, *, flops: float = 0.0,
                    batch_bytes: int = 0, itemsize: int = 4,
                    nslots: int = 2) -> dict:
    """Stamp for one data-parallel ZeRO-1 training step over ``p`` ranks:
    one all-gather of the parameter shards and one reduce-scatter of the
    full gradients (``2 (p - 1) n_params itemsize`` across ranks), and
    ``3 + 2 nslots`` parameter-vector passes through HBM (read parameters,
    gradients and each optimizer moment; write parameters and each moment)
    plus the batch read once.  ``flops`` is the task's forward + backward
    estimate."""
    n = int(n_params) * int(itemsize)
    return {
        "flops": float(flops),
        "bytes_hbm": (3 + 2 * int(nslots)) * n + int(batch_bytes),
        "bytes_ici": 2 * (int(p) - 1) * n if p > 1 else 0,
    }


# roofline classification
# ---------------------------------------------------------------------------


def span_cost(span_ev: dict) -> dict | None:
    """The cost stamp on one journal span event (``labels`` holding any
    of ``flops``/``bytes_hbm``/``bytes_ici``), or None when unstamped."""
    labels = span_ev.get("labels") or {}
    out = {}
    for key in _RESOURCES:
        try:
            out[key] = max(float(labels.get(key, 0) or 0), 0.0)
        except (TypeError, ValueError):
            out[key] = 0.0
    if not any(out.values()):
        return None
    return out


def classify_occurrence(span_ev: dict, peaks: dict) -> dict | None:
    """Classify one stamped span occurrence: the binding resource is the
    one whose analytic service time (stamp / peak) fills the largest
    fraction of the measured duration; that fraction is the roofline
    number (capped at 1 — an over-unity estimate means the stamp or the
    peak is off, not that the hardware overperformed)."""
    cost = span_cost(span_ev)
    dur = span_ev.get("dur")
    if cost is None or not dur or dur <= 0:
        return None
    t_est = {}
    achieved = {}
    for key in _RESOURCES:
        peak = float(peaks.get(_PEAK_OF[key], 0) or 0)
        t_est[key] = (cost[key] / peak) if peak > 0 else 0.0
        achieved[key] = cost[key] / dur
    bound_key = max(_RESOURCES, key=lambda k: t_est[k])
    frac = t_est[bound_key] / dur
    occ = {
        "name": span_ev.get("name"),
        "span_id": span_ev.get("span_id"),
        "dur": float(dur),
        "bound": _BOUND[bound_key],
        "roofline_frac": min(round(frac, 4), 1.0),
        "t_est": {k: round(v, 9) for k, v in t_est.items()},
        "achieved": {k: round(v, 3) for k, v in achieved.items()},
        "labels": dict(span_ev.get("labels") or {}),
    }
    if span_ev.get("trace_id"):
        occ["trace_id"] = span_ev["trace_id"]
    return occ


def classify(events: list, peaks: dict | None = None) -> list:
    """Every stamped span occurrence in the journal, classified."""
    peaks = peaks or peaks_for()
    out = []
    for e in events:
        if e.get("cat") != "span":
            continue
        occ = classify_occurrence(e, peaks)
        if occ is not None:
            out.append(occ)
    return out


def _span_forest(events: list) -> tuple[dict, dict, list]:
    """(spans by id, children ids by parent id, root ids) over the
    journal's finished span events."""
    spans = {}
    for e in events:
        if e.get("cat") == "span" and e.get("dur") is not None \
                and e.get("span_id") is not None:
            spans[e["span_id"]] = e
    children: dict = {}
    roots = []
    for sid, e in spans.items():
        pid = e.get("parent_id")
        if pid is not None and pid in spans:
            children.setdefault(pid, []).append(sid)
        else:
            roots.append(sid)
    return spans, children, roots


def coverage(events: list) -> dict:
    """How much of the journal's span wall time is cost-classified.

    Wall = the summed durations of root spans; a root's attributed time
    is its own duration when it carries a cost stamp, else the sum over
    its children (recursively) — a stamped parent covers its subtree, an
    unstamped parent is covered only as far as stamped descendants
    reach."""
    spans, children, roots = _span_forest(events)

    def attributed(sid: int, depth: int = 0) -> float:
        if depth > 256:                 # malformed parent links
            return 0.0
        e = spans[sid]
        if span_cost(e) is not None:
            return float(e["dur"])
        return min(float(e["dur"]),
                   sum(attributed(c, depth + 1)
                       for c in children.get(sid, [])))

    wall = sum(float(spans[r]["dur"]) for r in roots)
    att = sum(attributed(r) for r in roots)
    return {"wall_s": round(wall, 6), "attributed_s": round(att, 6),
            "fraction": round(att / wall, 4) if wall > 0 else 0.0,
            "roots": len(roots), "spans": len(spans)}


# ---------------------------------------------------------------------------
# overlap attribution
# ---------------------------------------------------------------------------


def overlap_stats(span_ev: dict, peaks: dict) -> dict | None:
    """Model-tier overlap for one stamped span that both communicates
    (``bytes_ici > 0``) and works (flops or HBM bytes): with analytic
    comm time ``t_comm`` and work time ``t_work``, a measured duration of
    ``t_comm + t_work`` is fully serial and ``max(t_comm, t_work)`` fully
    overlapped — the fraction of ``t_comm`` hidden under work is
    ``(t_comm + t_work - dur) / t_comm`` clamped into [0, 1].  Reports
    per-step numbers when the span carries a ring size (``ranks`` or
    ``nparts`` label: ``p - 1`` steps)."""
    cost = span_cost(span_ev)
    dur = span_ev.get("dur")
    if cost is None or not dur or dur <= 0 or cost["bytes_ici"] <= 0:
        return None
    ici = float(peaks.get("ici", 0) or 0)
    if ici <= 0:
        return None
    t_comm = cost["bytes_ici"] / ici
    t_work = max(
        cost["flops"] / peaks["flops"] if peaks.get("flops") else 0.0,
        cost["bytes_hbm"] / peaks["hbm"] if peaks.get("hbm") else 0.0)
    overlapped = min(max(t_comm + t_work - dur, 0.0), min(t_comm, t_work))
    unoverlapped = min(max(t_comm - overlapped, 0.0), float(dur))
    labels = span_ev.get("labels") or {}
    steps = None
    for key in ("ranks", "nparts", "p"):
        try:
            p = int(labels.get(key, 0) or 0)
        except (TypeError, ValueError):
            p = 0
        if p >= 2:
            steps = p - 1
            break
    out = {
        "name": span_ev.get("name"),
        "span_id": span_ev.get("span_id"),
        "dur": float(dur),
        "dispatch": labels.get("dispatch"),
        "labels": dict(labels),
        "t_comm": round(t_comm, 9),
        "t_work": round(t_work, 9),
        "overlap_frac": round(overlapped / t_comm, 4) if t_comm else 0.0,
        "unoverlapped_s": round(unoverlapped, 9),
        "unoverlapped_wall_frac": round(unoverlapped / dur, 4),
    }
    if steps:
        out["steps"] = steps
        out["per_step"] = {
            "dur": round(dur / steps, 9),
            "t_comm": round(t_comm / steps, 9),
            "unoverlapped_s": round(unoverlapped / steps, 9),
            "overlap_frac": out["overlap_frac"],
        }
    return out


def _union(intervals: list) -> list:
    """Merge ``(start, end)`` intervals into a disjoint sorted union."""
    ivs = sorted((float(a), float(b)) for a, b in intervals if b > a)
    out: list = []
    for a, b in ivs:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _measure(intervals: list) -> float:
    return sum(b - a for a, b in intervals)


def interval_overlap(comm: list, compute: list) -> dict:
    """Measured-tier overlap: ``comm`` and ``compute`` are lists of
    ``(start, end)`` intervals (any thread/rank — skewed multi-rank
    timelines union per class before intersecting).  Returns total comm
    seconds, the seconds of comm overlapped by compute, and the
    fraction."""
    cu, wu = _union(comm), _union(compute)
    ov = 0.0
    i = j = 0
    while i < len(cu) and j < len(wu):
        a = max(cu[i][0], wu[j][0])
        b = min(cu[i][1], wu[j][1])
        if b > a:
            ov += b - a
        if cu[i][1] <= wu[j][1]:
            i += 1
        else:
            j += 1
    total = _measure(cu)
    return {"comm_s": round(total, 9), "overlapped_s": round(ov, 9),
            "unoverlapped_s": round(total - ov, 9),
            "overlap_frac": round(ov / total, 4) if total > 0 else 0.0}


def _span_kind(span_ev: dict) -> str | None:
    """comm/compute classification of one span for the timeline tier:
    an explicit ``kind=`` label wins; else a stamped span with ICI bytes
    and no flops is comm, any other stamped span is compute."""
    labels = span_ev.get("labels") or {}
    kind = labels.get("kind")
    if kind in ("comm", "compute"):
        return kind
    cost = span_cost(span_ev)
    if cost is None:
        return None
    if cost["bytes_ici"] > 0 and cost["flops"] <= 0:
        return "comm"
    return "compute"


def timeline_overlap(events: list) -> list:
    """Measured overlap per *step*: group child spans by parent, split
    them comm/compute (see :func:`_span_kind` — rank-skewed children on
    different threads land in the same step), and intersect the unions.
    Returns one entry per parent that has at least one comm child."""
    spans, children, _ = _span_forest(events)
    out = []
    for pid, kids in sorted(children.items()):
        comm, compute = [], []
        for sid in kids:
            e = spans[sid]
            iv = (float(e.get("start", 0.0)),
                  float(e.get("start", 0.0)) + float(e["dur"]))
            kind = _span_kind(e)
            if kind == "comm":
                comm.append(iv)
            elif kind == "compute":
                compute.append(iv)
        if not comm:
            continue
        parent = spans[pid]
        entry = {"step": parent.get("name"), "span_id": pid,
                 "dur": float(parent["dur"])}
        entry.update(interval_overlap(comm, compute))
        out.append(entry)
    return out


def train_step_overlap(events: list) -> list:
    """Measured grad-sync overlap per *training step*: every
    ``train.step`` span's children split comm/compute (the trainer
    labels ``train.sync`` ``kind=comm`` and ``train.grad``
    ``kind=compute``; rank-skewed children on other threads join the
    same step) and the unions intersect.  One entry per step, in step
    order, carrying the step index / rank count / dispatch labels so
    the doctor can print a per-step trajectory — including steps whose
    sync never overlapped anything (overlap_frac 0.0), which is the
    finding."""
    spans, children, _ = _span_forest(events)
    out = []
    for pid, kids in children.items():
        parent = spans[pid]
        if parent.get("name") != "train.step":
            continue
        comm, compute = [], []
        for sid in kids:
            e = spans[sid]
            iv = (float(e.get("start", 0.0)),
                  float(e.get("start", 0.0)) + float(e["dur"]))
            kind = _span_kind(e)
            if kind == "comm":
                comm.append(iv)
            elif kind == "compute":
                compute.append(iv)
        if not comm:
            continue
        labels = parent.get("labels") or {}
        entry = {"step": labels.get("step"), "span_id": pid,
                 "dur": float(parent["dur"]),
                 "ranks": labels.get("ranks"),
                 "dispatch": labels.get("dispatch")}
        entry.update(interval_overlap(comm, compute))
        out.append(entry)
    def _step_key(e):
        try:
            return (0, int(e["step"]))
        except (TypeError, ValueError):
            return (1, e["span_id"])
    out.sort(key=_step_key)
    return out


# ---------------------------------------------------------------------------
# critical path
# ---------------------------------------------------------------------------

_EPS = 1e-9


def critical_path(events: list, root_span_id: int | None = None) -> list:
    """The chain of span segments that gates a root span's wall time.

    Walks backward from the root's end: at each point the latest-ending
    child interval takes the segment (recursing into its own children);
    gaps with no child running attribute to the parent itself.  Returns
    ``[{"name", "span_id", "self_s"}, ...]`` in timeline order, summing
    to the root's duration.  Default root: the longest root span."""
    spans, children, roots = _span_forest(events)
    if not spans:
        return []
    if root_span_id is None:
        if not roots:
            return []
        root_span_id = max(roots, key=lambda r: spans[r]["dur"])
    if root_span_id not in spans:
        return []

    def seg(acc: list, e: dict, seconds: float) -> None:
        if seconds <= _EPS:
            return
        if acc and acc[-1]["span_id"] == e.get("span_id"):
            acc[-1]["self_s"] += seconds
        else:
            acc.append({"name": e.get("name"),
                        "span_id": e.get("span_id"),
                        "self_s": seconds})

    def walk(sid: int, t_end: float, depth: int = 0) -> list:
        e = spans[sid]
        start = float(e.get("start", 0.0))
        t = min(t_end, start + float(e["dur"]))
        if depth > 64:
            return [{"name": e.get("name"), "span_id": sid,
                     "self_s": max(t - start, 0.0)}]
        kids = [spans[c] for c in children.get(sid, [])]
        segs: list = []                  # built backward, reversed at end
        while t > start + _EPS:
            cands = [k for k in kids
                     if float(k.get("start", 0.0)) < t - _EPS]
            if not cands:
                seg(segs, e, t - start)
                break
            c = max(cands, key=lambda k: min(
                float(k.get("start", 0.0)) + float(k["dur"]), t))
            c_start = float(c.get("start", 0.0))
            c_end = min(c_start + float(c["dur"]), t)
            if c_end < t - _EPS:
                seg(segs, e, t - c_end)   # gap: the parent's own work
            segs.extend(walk(c["span_id"], c_end, depth + 1)[::-1])
            t = c_start
            kids = [k for k in kids if k is not c]
        out: list = []
        for s in segs[::-1]:
            seg(out, {"name": s["name"], "span_id": s["span_id"]},
                s["self_s"])
        return out

    path = walk(root_span_id, float("inf"))
    for s in path:
        s["self_s"] = round(s["self_s"], 9)
    return path


# ---------------------------------------------------------------------------
# the doctor: everything above, as ranked findings
# ---------------------------------------------------------------------------


def _rollup(classified: list) -> dict:
    """Per-name rollup of classified occurrences: count, total seconds,
    the dominant bound class, and the time-weighted roofline fraction."""
    by: dict = {}
    for occ in classified:
        r = by.setdefault(occ["name"], {
            "count": 0, "total_s": 0.0, "frac_weighted": 0.0,
            "bounds": {}})
        r["count"] += 1
        r["total_s"] += occ["dur"]
        r["frac_weighted"] += occ["roofline_frac"] * occ["dur"]
        r["bounds"][occ["bound"]] = r["bounds"].get(occ["bound"], 0) + 1
    out = {}
    for name, r in by.items():
        out[name] = {
            "count": r["count"],
            "total_s": round(r["total_s"], 6),
            "bound": max(r["bounds"], key=r["bounds"].get),
            "roofline_frac": round(r["frac_weighted"] / r["total_s"], 4)
            if r["total_s"] > 0 else 0.0,
        }
    return out


def _action_hint(kind: str, name, labels: dict) -> dict | None:
    """Machine-readable tuning hint for one finding: the autotune
    ``kernel`` namespace, the exact registry ``key`` (from the span's
    ``autotune_key`` / ``dispatch_key`` labels), and a suggested
    ``direction`` — so the advisor consumes structure instead of
    re-parsing detail strings.  ``None`` when the span carries no
    addressable registry key."""
    labels = labels or {}
    if kind == "unoverlapped_comm":
        if labels.get("dispatch") == "rdma" and labels.get("autotune_key"):
            return {"kernel": "rdma_chunks",
                    "key": labels["autotune_key"],
                    "param": "chunks",
                    "direction": "increase",
                    "current": labels.get("rdma_chunks"),
                    "dispatch_key": labels.get("dispatch_key")}
        if labels.get("dispatch_key"):
            return {"kernel": "rdma_dispatch",
                    "key": labels["dispatch_key"],
                    "param": "dispatch",
                    "direction": "compare",
                    "current": labels.get("dispatch")}
        return None
    if kind == "low_roofline":
        if name == "pallas.matmul" and labels.get("autotune_key"):
            return {"kernel": "pallas_matmul",
                    "key": labels["autotune_key"],
                    "param": "block",
                    "direction": "resweep",
                    "shape": labels.get("shape"),
                    "dtype": labels.get("dtype")}
        return None
    return None


def analyze(events: list, peaks: dict | None = None,
            platform: str | None = None) -> dict:
    """The doctor's full report over one journal: coverage, per-name
    roofline rollups, per-occurrence overlap, the critical path of the
    longest root, and ranked findings (each carrying a machine-readable
    ``action`` hint when its span names an autotune registry key)."""
    if peaks is None and platform is None:
        platform = journal_platform(events)
    peaks = peaks or peaks_for(platform)
    classified = classify(events, peaks)
    cov = coverage(events)
    overlaps = [s for s in (
        overlap_stats(e, peaks) for e in events if e.get("cat") == "span")
        if s is not None]
    measured = timeline_overlap(events)
    train_steps = train_step_overlap(events)
    cpath = critical_path(events)
    findings = []
    for ov in overlaps:
        if ov["unoverlapped_s"] <= 0:
            continue
        where = ov["name"]
        if ov.get("dispatch"):
            where += f"[{ov['dispatch']}]"
        findings.append({
            "kind": "unoverlapped_comm",
            "severity_s": ov["unoverlapped_s"],
            "span_id": ov["span_id"],
            "action": _action_hint("unoverlapped_comm", ov["name"],
                                   ov.get("labels")),
            "message": (
                f"{where} spent {ov['unoverlapped_wall_frac']:.0%} of wall "
                f"in unoverlapped ICI ({ov['unoverlapped_s']:.6f}s of "
                f"{ov['dur']:.6f}s; overlap fraction "
                f"{ov['overlap_frac']:.2f}"
                + (f", {ov['steps']} ring steps" if ov.get("steps") else "")
                + ")"),
        })
    for occ in classified:
        slack = occ["dur"] * (1.0 - occ["roofline_frac"])
        if occ["roofline_frac"] < 0.5 and slack > 0:
            findings.append({
                "kind": "low_roofline",
                "severity_s": round(slack, 9),
                "span_id": occ["span_id"],
                "action": _action_hint("low_roofline", occ["name"],
                                       occ.get("labels")),
                "message": (
                    f"{occ['name']} ran at {occ['roofline_frac']:.1%} of "
                    f"the {occ['bound']} roofline "
                    f"({occ['dur']:.6f}s; {slack:.6f}s of headroom)"),
            })
    if cov["fraction"] < 0.9 and cov["wall_s"] > 0:
        findings.append({
            "kind": "coverage_gap",
            "severity_s": round(cov["wall_s"] - cov["attributed_s"], 9),
            "action": None,
            "message": (
                f"only {cov['fraction']:.1%} of {cov['wall_s']:.6f}s span "
                "wall is cost-classified — stamp the missing spans"),
        })
    findings.sort(key=lambda f: -f["severity_s"])
    return {
        "platform": peaks.get("platform", "cpu"),
        "peaks": {k: peaks[k] for k in ("flops", "hbm", "ici")
                  if k in peaks},
        "coverage": cov,
        "by_name": _rollup(classified),
        "classified": classified,
        "overlap": overlaps,
        "measured_overlap": measured,
        "train_steps": train_steps,
        "critical_path": cpath,
        "findings": findings,
    }


def format_analysis(a: dict, out) -> None:
    """Human rendering of :func:`analyze` (the ``doctor`` CLI body)."""
    cov = a["coverage"]
    out.write(f"platform: {a['platform']}  peaks: "
              + "  ".join(f"{k}={v:.3g}" for k, v in a["peaks"].items())
              + "\n")
    out.write(f"coverage: {cov['fraction']:.1%} of {cov['wall_s']:.6f}s "
              f"wall cost-classified ({cov['spans']} spans, "
              f"{cov['roots']} roots)\n")
    if a["by_name"]:
        out.write("\nroofline by span name:\n")
        for name, r in sorted(a["by_name"].items(),
                              key=lambda kv: -kv[1]["total_s"]):
            out.write(f"  {name:<28} {r['count']:>5} x "
                      f"{r['total_s']:>12.6f}s  {r['bound']:<8} "
                      f"{r['roofline_frac']:>6.1%} of roofline\n")
    if a["overlap"]:
        out.write("\ncomm/compute overlap (model tier):\n")
        for ov in sorted(a["overlap"], key=lambda o: -o["unoverlapped_s"]):
            tag = f"[{ov['dispatch']}]" if ov.get("dispatch") else ""
            step = (f"  per-step {ov['per_step']['overlap_frac']:.2f} "
                    f"over {ov['steps']} steps" if ov.get("steps") else "")
            out.write(f"  {ov['name']}{tag:<10} overlap "
                      f"{ov['overlap_frac']:.2f}  unoverlapped "
                      f"{ov['unoverlapped_s']:.6f}s "
                      f"({ov['unoverlapped_wall_frac']:.0%} of wall)"
                      f"{step}\n")
    if a["measured_overlap"]:
        out.write("\ncomm/compute overlap (measured tier):\n")
        for ov in a["measured_overlap"]:
            out.write(f"  {ov['step']:<28} overlap {ov['overlap_frac']:.2f}"
                      f"  unoverlapped {ov['unoverlapped_s']:.6f}s\n")
    if a.get("train_steps"):
        out.write("\ngrad-sync overlap per training step:\n")
        for ov in a["train_steps"]:
            tag = f"[{ov['dispatch']}]" if ov.get("dispatch") else ""
            ranks = f" p={ov['ranks']}" if ov.get("ranks") else ""
            out.write(f"  step {str(ov['step']):<6}{tag}{ranks}  "
                      f"sync {ov['comm_s']:.6f}s  overlap "
                      f"{ov['overlap_frac']:.2f}  unoverlapped "
                      f"{ov['unoverlapped_s']:.6f}s\n")
    if a["critical_path"]:
        out.write("\ncritical path (longest root):\n")
        for s in a["critical_path"]:
            out.write(f"  {s['name']:<28} {s['self_s']:>12.6f}s\n")
    out.write(f"\nfindings ({len(a['findings'])}):\n")
    for i, f in enumerate(a["findings"][:20], 1):
        out.write(f"  {i:>2}. [{f['kind']}] {f['message']}\n")
