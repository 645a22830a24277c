"""Noise-aware bench regression sentinel.

The port's copy of ``distributedarrays_tpu/telemetry/regress.py``: the
same comparison, verdicts and report, pure stdlib.

The banked trajectory (``BENCH_r*.json`` headline rows; optionally
``BENCH_DETAILS*.json`` label tables) is evidence, not decoration: a
fresh bench run that is significantly slower than the trajectory should
fail loudly instead of silently extending the table.  This module
compares a fresh run's rows against the banked series with thresholds
derived from the trajectory's own noise:

- per metric, the baseline is the **median** of the banked values and
  the spread is the **median absolute deviation** (MAD — robust to the
  single wild round a flaky tunnel produces);
- a fresh value regresses when it is worse than the median by more than
  ``max(mad_k * 1.4826 * MAD, rel_floor * |median|)`` (the 1.4826 factor
  scales MAD to a normal sigma; the relative floor keeps a zero-noise
  trajectory from flagging measurement jitter);
- with fewer than ``min_points`` banked values the noise is unknown and
  only a conservative 50% degradation flags;
- **replayed rows never count** — neither as baseline points nor as a
  fresh measurement (``replayed: true`` from bench.py, or the legacy
  "replayed from the banked table" note) — a replay is the *old* number
  wearing a new timestamp.

Direction is inferred from the metric name (``*_s``, ``*_s_per_iter``,
latency percentiles → lower is better; ``*_gflops``, ``*_tokens_per_s``,
``*_gbps``, ``*_mfu`` → higher); unknown metrics are skipped, never
guessed.  Pure stdlib, shared by ``python -m distributedarrays_tpu
.telemetry regress`` (a CI leg) and tests.
"""

from __future__ import annotations

import glob
import json
import os
import re

__all__ = [
    "direction", "is_replay", "mad", "load_rows", "load_baseline",
    "compare", "format_results",
]

_LOWER_BETTER = re.compile(
    r"(_s|_s_per_iter|_seconds|_latency_s|_p50_s|_p99_s|_ms|"
    r"_iters|_iterations|_residual)$")
_HIGHER_BETTER = re.compile(
    r"(_gflops|_tflops|_gbps|_mfu|_tokens_per_s|_per_s|_rps|"
    r"gflops|tflops)$")
_SKIP = re.compile(
    r"(_error|_rerun_error|_orphan_running|_comm_bytes_est|_hbm_peak_mb|"
    r"_L|_n|_attempts|_attempts_max|_chunks|_block|_sweep|_winner|_path|"
    r"_source|_note|_dispatch|_strategy)$")
# rate units as a mid-name token (the headline metric is
# "gemm_4096_gflops_mixed_precision_bf16pass" — unit in the middle):
# only consulted after both anchored suffix patterns fail, so a
# hypothetical "..._gflops_probe_s" still judges as seconds
_HIGHER_TOKEN = re.compile(
    r"(^|_)(gflops|tflops|gbps|mfu|tokens_per_s|rps)(_|$)")


def direction(metric: str) -> int:
    """-1 when lower is better, +1 when higher is better, 0 unknown."""
    if _SKIP.search(metric):
        return 0
    # rates first: *_tokens_per_s / *_per_s / *_rps end in "_s" too, and
    # a throughput judged lower-is-better would invert every verdict
    if _HIGHER_BETTER.search(metric):
        return 1
    if _LOWER_BETTER.search(metric):
        return -1
    if _HIGHER_TOKEN.search(metric):
        return 1
    return 0


def is_replay(row: dict) -> bool:
    """True when this row is a replay of an older banked measurement."""
    if row.get("replayed") is True:
        return True
    return "replayed from the banked table" in str(row.get("note", ""))


def mad(values: list) -> float:
    """Median absolute deviation (0.0 for fewer than 2 values)."""
    if len(values) < 2:
        return 0.0
    med = _median(values)
    return _median([abs(v - med) for v in values])


def _median(values: list) -> float:
    s = sorted(values)
    n = len(s)
    mid = n // 2
    return float(s[mid]) if n % 2 else (s[mid - 1] + s[mid]) / 2.0


def _numeric_items(doc: dict) -> dict:
    out = {}
    for k, v in doc.items():
        if k.startswith("_") or direction(k) == 0:
            continue
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        out[k] = float(v)
    return out


def load_rows(path: str) -> dict:
    """Extract ``{metric: value}`` from one file, whatever its shape:

    - a bench stdout row (``{"metric": ..., "value": ...}``),
    - a ``BENCH_r*.json`` wrapper (``{"parsed": {...}}``),
    - a ``BENCH_DETAILS.json`` label table (numeric labels).

    Replayed and errored rows yield nothing (``{}``)."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict):
        return {}
    row = doc.get("parsed") if isinstance(doc.get("parsed"), dict) else doc
    if "metric" in row and "value" in row:
        if is_replay(row) or row.get("error") or not row.get("value"):
            return {}
        return {str(row["metric"]): float(row["value"])}
    if is_replay(row):
        return {}
    return _numeric_items(row)


def load_baseline(paths: list) -> dict:
    """``{metric: [values...]}`` over the banked trajectory.  Each entry
    of ``paths`` is a file (loaded via :func:`load_rows`) or a directory
    (every ``BENCH_r*.json`` inside, sorted)."""
    series: dict = {}
    for p in paths:
        files = (sorted(glob.glob(os.path.join(p, "BENCH_r*.json")))
                 if os.path.isdir(p) else [p])
        for f in files:
            try:
                rows = load_rows(f)
            except (OSError, ValueError):
                continue
            for metric, value in rows.items():
                series.setdefault(metric, []).append(value)
    return series


def compare(fresh: dict, baseline: dict, *, mad_k: float = 3.0,
            rel_floor: float = 0.15, min_points: int = 3) -> list:
    """Judge every fresh metric that has a banked series.  Returns one
    dict per judged metric: ``status`` is ``ok`` / ``regression`` /
    ``improved`` / ``skipped``; ``threshold`` is the allowed degradation
    in the metric's own units."""
    results = []
    for metric in sorted(fresh):
        d = direction(metric)
        value = fresh[metric]
        series = baseline.get(metric) or []
        if d == 0:
            continue
        if not series:
            results.append({"metric": metric, "value": value,
                            "status": "skipped",
                            "reason": "no banked baseline"})
            continue
        med = _median(series)
        spread = mad(series)
        if len(series) >= min_points:
            threshold = max(mad_k * 1.4826 * spread,
                            rel_floor * abs(med))
        else:
            threshold = 0.5 * abs(med)
        delta = value - med
        worse = delta if d < 0 else -delta
        status = "ok"
        if worse > threshold:
            status = "regression"
        elif worse < -threshold:
            status = "improved"
        results.append({
            "metric": metric, "value": value, "median": med,
            "mad": spread, "n": len(series), "threshold": threshold,
            "delta": delta, "worse_by": worse, "status": status,
            "direction": "lower_is_better" if d < 0
            else "higher_is_better",
        })
    return results


def format_results(results: list, out, explain: bool = False) -> None:
    """Render compare() verdicts; ``explain`` adds a per-metric baseline
    line (median / MAD / series size / direction / how the threshold was
    derived) so a multi-metric verdict is auditable from the text alone,
    not just the exit code."""
    for r in sorted(results,
                    key=lambda r: (r["status"] != "regression",
                                   -(r.get("worse_by") or 0))):
        if r["status"] == "skipped":
            out.write(f"SKIP  {r['metric']}: {r['reason']}\n")
            continue
        out.write(
            f"{r['status'].upper():<10} {r['metric']}: {r['value']:.6g} "
            f"vs median {r['median']:.6g} over {r['n']} banked runs "
            f"(MAD {r['mad']:.3g}, allowed degradation "
            f"{r['threshold']:.3g})\n")
        if explain:
            arrow = ("lower is better"
                     if r.get("direction") == "lower_is_better"
                     else "higher is better")
            rule = ("max(mad_k*1.4826*MAD, rel_floor*|median|)"
                    if r["n"] >= 3 else
                    "conservative 50% of |median| (fewer than 3 points)")
            out.write(
                f"          baseline: median {r['median']:.6g}, "
                f"MAD {r['mad']:.3g} over n={r['n']}; {arrow}; "
                f"delta {r['delta']:+.6g} (worse_by {r['worse_by']:.6g}); "
                f"threshold = {rule}\n")
